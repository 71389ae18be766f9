"""The capture loop's device functions: K10, K11 and K12.

The counterparts of three small jitted functions of the JAX package's
engine loop:

=====================  =================================================
``synthetic_frame``    K10 (csrc/synthetic_frame.cu): the synthetic
                       desktop of a tick
                       (selkies_tpu/engine/sources.py ``_synthetic_fn``)
``synthetic_frames``   K10's seat entry: one launch, S seats' desktops
                       (selkies_tpu/parallel/seats.py
                       ``synthetic_seat_frames``)
``pad_frame``          K11 (csrc/pad_frame.cu): a captured frame zero-
                       padded to the encode grid
                       (selkies_tpu/engine/capture.py ``_padder``)
``watermark_blend``    K12 (csrc/watermark_blend.cu): the watermark
                       alpha-blended into its region, in place
                       (selkies_tpu/engine/watermark.py ``_blender``)
=====================  =================================================

Each wrapper launches its kernel for CUDA tensors and runs the plain
PyTorch version beside it (``*_plain``) only for tensors on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from . import _cuda
from .h264_encode import _check, _on_cpu

INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


def _wrap32(v: int) -> int:
    """``v`` as an int32 that wrapped like XLA's (two's complement)."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v > INT32_MAX else v


def _check_tick(tick: int) -> int:
    tick = int(tick)
    if not INT32_MIN <= tick <= INT32_MAX:
        # the reference's jnp.int32(tick) refuses it too
        raise OverflowError(f"tick {tick} is out of bounds for int32")
    return tick


# ---------------------------------------------------------------------------
# K10: the synthetic desktop
# ---------------------------------------------------------------------------

def synthetic_frame_plain(height: int, width: int, tick: int,
                          device="cpu") -> torch.Tensor:
    """(height, width, 3) uint8 test pattern of ``tick``: gradient, a
    moving 32-pixel bar, a bouncing 96-row block, with the reference's
    int32 arithmetic (the tick products wrap; ``%`` is a floor modulo,
    which Python's is)."""
    tick = _check_tick(tick)
    yy = torch.arange(height, dtype=torch.int32, device=device)[:, None]
    xx = torch.arange(width, dtype=torch.int32, device=device)[None, :]
    shape = (height, width)
    r = ((xx * 255) // width).expand(shape)
    g = ((yy * 255) // height).expand(shape)
    # only the low byte of x + y + 3 * tick survives, and a wrap keeps it
    b = (xx + yy + (_wrap32(3 * tick) & 0xFF)) & 0xFF
    bar_x = _wrap32(7 * tick) % width
    in_bar = (xx >= bar_x) & (xx < bar_x + 32)
    per_h = max(height - 96, 1)
    by = abs(_wrap32(5 * tick) % (2 * per_h) - per_h)
    in_block = (yy >= by) & (yy < by + 96) & (xx >= 64) & (xx < 224)

    def paint(plane, block_value):
        return torch.where(in_bar, 255, torch.where(in_block, block_value,
                                                    plane))
    return torch.stack([paint(r, 30), paint(g, 220), paint(b, 60)],
                       dim=-1).to(torch.uint8)


def synthetic_frame(height: int, width: int, tick: int,
                    device=None) -> torch.Tensor:
    """K10 on a CUDA ``device`` (None: the card, which must be there),
    else :func:`synthetic_frame_plain` on the CPU."""
    device = resolve_device(device)
    if height <= 0 or width <= 0:
        raise ValueError(f"frame size {width}x{height}")
    if device.type == "cpu":
        return synthetic_frame_plain(height, width, tick, device)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    out = torch.empty((height, width, 3), dtype=torch.uint8, device=device)
    _cuda.launch("synthetic_frame", out, height, width, _check_tick(tick))
    return out


def seat_ticks(n_seats: int, tick: int) -> list[int]:
    """Each seat's phase, ``arange(n_seats, int32) * 37 + tick`` in
    numpy's int32 arithmetic: a tick outside int32 raises, a sum past it
    wraps."""
    tick = _check_tick(tick)
    return [_wrap32(37 * k + tick) for k in range(n_seats)]


def synthetic_frames_plain(height: int, width: int, n_seats: int, tick: int,
                           device="cpu") -> torch.Tensor:
    """(n_seats, height, width, 3) uint8: seat k's frame is
    :func:`synthetic_frame_plain` at phase ``k * 37 + tick``."""
    return torch.stack([synthetic_frame_plain(height, width, t, device)
                        for t in seat_ticks(n_seats, tick)])


def synthetic_frames(height: int, width: int, n_seats: int, tick: int,
                     device=None) -> torch.Tensor:
    """K10's seat entry on a CUDA ``device`` (None: the card, which must
    be there): every seat's frame in one launch; else
    :func:`synthetic_frames_plain` on the CPU."""
    device = resolve_device(device)
    if height <= 0 or width <= 0 or n_seats < 1:
        raise ValueError(f"{n_seats} frames of {width}x{height}")
    seat_ticks(n_seats, tick)                    # the int32 checks
    if device.type == "cpu":
        return synthetic_frames_plain(height, width, n_seats, tick, device)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    out = torch.empty((n_seats, height, width, 3), dtype=torch.uint8,
                      device=device)
    _cuda.launch("synthetic_frames", out, n_seats, height, width, int(tick))
    return out


# ---------------------------------------------------------------------------
# K11: zero padding to the grid
# ---------------------------------------------------------------------------

def _check_pad(frame, height: int, width: int):
    h, w = int(frame.shape[0]), int(frame.shape[1])
    _check(frame, "frame", torch.uint8, (h, w, 3), frame.device)
    if h > height or w > width:
        raise ValueError(f"frame {w}x{h} does not fit the grid "
                         f"{width}x{height}")
    return h, w


def pad_frame_plain(frame, height: int, width: int) -> torch.Tensor:
    """``frame`` (h, w, 3) uint8 in the top-left corner of a zero
    (height, width, 3) frame."""
    h, w = _check_pad(frame, height, width)
    out = torch.zeros((height, width, 3), dtype=torch.uint8,
                      device=frame.device)
    out[:h, :w] = frame
    return out


def pad_frame(frame, height: int, width: int) -> torch.Tensor:
    """K11 for a CUDA ``frame``, else :func:`pad_frame_plain`."""
    h, w = _check_pad(frame, height, width)
    if _on_cpu(frame):
        return pad_frame_plain(frame, height, width)
    out = torch.empty((height, width, 3), dtype=torch.uint8,
                      device=frame.device)
    _cuda.launch("pad_frame", frame, out, h, w, height, width)
    return out


# ---------------------------------------------------------------------------
# K12: the watermark blend
# ---------------------------------------------------------------------------

def blend_table() -> torch.Tensor:
    """(256, 2) float32 on the CPU: row A is (a, 1 - a) for alpha byte A,
    formed as the reference forms them: a = float32(A) / 255, then
    1 - a in float32, each rounded once."""
    a = np.arange(256, dtype=np.float32) / np.float32(255)
    return torch.as_tensor(np.stack([a, np.float32(1) - a], axis=1))


def _check_blend(frame, rgba, table, y0: int, x0: int):
    H, W = int(frame.shape[0]), int(frame.shape[1])
    wh, ww = int(rgba.shape[0]), int(rgba.shape[1])
    _check(frame, "frame", torch.uint8, (H, W, 3), frame.device)
    _check(rgba, "rgba", torch.uint8, (wh, ww, 4), frame.device)
    _check(table, "table", torch.float32, (256, 2), frame.device)
    if not (0 < wh <= H and 0 < ww <= W):
        raise ValueError(f"watermark {ww}x{wh} does not fit the frame "
                         f"{W}x{H}")
    return _slice_start(int(y0), H, wh), _slice_start(int(x0), W, ww)


def _slice_start(start: int, dim: int, size: int) -> int:
    """lax.dynamic_slice's start: a negative start counts from the end,
    then the start is clamped so the slice lies inside the axis."""
    if start < 0:
        start += dim
    return min(max(start, 0), dim - size)


def watermark_blend_plain(frame, rgba, table, y0: int, x0: int):
    """Blend ``rgba`` (wh, ww, 4) uint8 into ``frame`` at (y0, x0), in
    place, with (a, 1 - a) = ``table[A]`` (:func:`blend_table`):
    ``region * (1 - a) + R * a`` in float32, each product and the sum
    rounded once, rounded half to even, clipped. -> ``frame``."""
    y0, x0 = _check_blend(frame, rgba, table, y0, x0)
    wh, ww = rgba.shape[0], rgba.shape[1]
    region = frame[y0:y0 + wh, x0:x0 + ww]
    t = table[rgba[..., 3].to(torch.int64)]
    a, oma = t[..., 0:1], t[..., 1:2]
    out = region.to(torch.float32) * oma + rgba[..., :3].to(torch.float32) * a
    region.copy_(torch.clamp(torch.round(out), 0, 255).to(torch.uint8))
    return frame


def watermark_blend(frame, rgba, table, y0: int, x0: int):
    """K12 for a CUDA ``frame`` (in place), else
    :func:`watermark_blend_plain`. -> ``frame``."""
    y0, x0 = _check_blend(frame, rgba, table, y0, x0)
    if _on_cpu(frame):
        return watermark_blend_plain(frame, rgba, table, y0, x0)
    if rgba.data_ptr() % 4 or table.data_ptr() % 16:
        raise ValueError("watermark_blend: rgba must start on 4 bytes and "
                         "the table on 16")
    H, W = frame.shape[0], frame.shape[1]
    _cuda.launch("watermark_blend", frame, rgba, table, H, W, y0, x0,
                 rgba.shape[0], rgba.shape[1])
    return frame
