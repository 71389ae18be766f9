"""H.264 stripe-encoder session on PyTorch/CUDA: the stock 4:2:0 path.

The counterpart of selkies_tpu/engine/h264_encoder.py for its stock
configuration (``h264_motion_vrange=0``, ``h264_partial_encode=False``):

- every wire stripe is an INDEPENDENT H.264 stream of ``stripe_h`` rows;
  each MB row inside a stripe is one slice;
- damage gating: unchanged stripes are skipped; paint-over re-sends a
  settled stripe once at ``paint_over_qp`` — the per-stripe selects run on
  the device, so neither rate control nor paint-over syncs the host;
- adaptive I/P: the first frame and every forced refresh are IDR access
  units; all other frames are zero-motion P frames (P_Skip for unchanged
  macroblocks, residual against the decoder-exact reconstruction).

One frame is four kernels (ops/h264_planes.py: K1 ``csc420_damage``, K2
``mb_encode_i``/``mb_encode_p0``, K3 ``cavlc_events``, K4
``pack_stream``) plus (S,)-sized torch ops for age, paint-over, send,
``sent``/``fnum``, per-row qp and ``idr_pic_id``, which stay plain torch
ops on the device. Only the byte buffer prefix, the row lengths and the
flags leave the device.

Where the reference donates its state buffers to the jitted step, the
port updates preallocated state tensors in place: ``prev`` (by K1), the
reference planes (by K2, for sent stripes only), ``age``, ``sent`` and
``fnum``. Nothing inside :meth:`H264EncoderSession.encode` waits for the
device; :meth:`~H264EncoderSession._sync_control` is the one sync point.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Any

import numpy as np
import torch

from .._device import resolve_device
from ..codecs import h264 as hcodec
from ..ops.h264_encode import P_SLOTS_MB, SLOTS_MB
from ..ops.h264_planes import KERNEL_OPS, StepOps
from .readback import HostCopy, fetch_stream_bytes, fetch_stripe_bytes
from .types import CaptureSettings, EncodedChunk

logger = logging.getLogger("selkies_tpu_torch.engine.h264")


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


@dataclasses.dataclass
class _Grid:
    width: int
    height: int
    stripe_h: int
    n_stripes: int
    rows_per_stripe: int
    mb_w: int
    out_w: int
    out_h: int


def h264_buffer_caps(g: _Grid) -> tuple[int, int, int]:
    """(e_cap, w_cap, out_cap) for a 4:2:0 grid: the reference's sizing
    policy. out_cap is the one array that crosses to the host every frame,
    sized for realistic intra frames (~1.5 bits/px); overflow grows it
    (and forces a clean refresh)."""
    e_cap = 9 + g.mb_w * max(SLOTS_MB, P_SLOTS_MB) + 2
    w_cap = max(2048, g.mb_w * 768 // 4)
    out_cap = max(192 * 1024, g.width * g.height // 6)
    return e_cap, w_cap, out_cap


def h264_stripe_payload(intra: bool, rows: list[bytes],
                        sps_pps: bytes) -> bytes:
    """Wire payload for one stripe: IDR access unit (headers + IDR
    slices) or non-IDR reference P slices."""
    if intra:
        return sps_pps + hcodec.assemble_annexb(rows)
    return b"".join(hcodec.nal(1, rb, ref_idc=2) for rb in rows)


def plan_h264_grid(s: CaptureSettings) -> _Grid:
    if s.single_stream:
        stripe_h = _round_up(max(16, s.capture_height), 16)
    else:
        stripe_h = max(16, _round_up(s.stripe_height, 16))
    w = _round_up(s.capture_width, 16)
    h = _round_up(s.capture_height, stripe_h)
    return _Grid(width=w, height=h, stripe_h=stripe_h,
                 n_stripes=h // stripe_h, rows_per_stripe=stripe_h // 16,
                 mb_w=w // 16, out_w=s.capture_width, out_h=s.capture_height)


def _check_slice(s: CaptureSettings) -> None:
    """Raise for settings outside the ported slice, naming its ROADMAP
    item."""
    todo = [(int(s.h264_motion_vrange) > 0,
             "h264_motion_vrange>0 (motion search, ROADMAP A7)"),
            (bool(s.h264_partial_encode),
             "h264_partial_encode=True (band step, ROADMAP A8)"),
            (bool(s.h264_roi_qp), "h264_roi_qp (ROI QP, ROADMAP A8)"),
            (bool(s.fullcolor), "fullcolor (4:4:4, ROADMAP A10)"),
            (int(s.stripe_devices) > 1,
             "stripe_devices>1 (split-frame, ROADMAP A11)"),
            (bool(s.watermark_path), "watermark_path (ROADMAP A5)")]
    for bad, what in todo:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet")


def build_h264_step_fn(mode: str, width: int, stripe_h: int, n_stripes: int,
                       e_cap: int, w_cap: int, out_cap: int,
                       paint_delay: int, damage_gating: bool,
                       paint_over: bool, ops: StepOps = KERNEL_OPS):
    """Per-frame step for ``mode`` in {"i", "p"} (zero-MV P).

    step(frame, prev, age, sent, fnum, ref_y, ref_u, ref_v, qp_motion,
         qp_paint, force, hdr_pay, hdr_nb)
    -> (data u8 (out_cap,), row_lens i32 (R,), send (S,), is_paint (S,),
        overflow ())
    ``prev``, ``age``, ``sent``, ``fnum`` and the reference planes are
    updated in place (the reference returns them as new arrays)."""
    rps = stripe_h // 16
    intra = mode == "i"

    def step(frame, prev, age, sent, fnum, ref_y, ref_u, ref_v,
             qp_motion: int, qp_paint: int, force: bool, hdr_pay, hdr_nb):
        y, u, v, damage = ops.csc420_damage(frame, prev, n_stripes)
        if damage_gating:
            damage = damage != 0
        else:
            damage = torch.ones_like(damage, dtype=torch.bool)
        age.copy_(torch.where(damage, 0, age + 1))
        if paint_over and paint_delay > 0:
            is_paint = age == paint_delay
        else:
            is_paint = torch.zeros_like(damage)
        send = damage | is_paint | bool(force)
        qp_rows = torch.where(is_paint, qp_paint, qp_motion).to(
            torch.int32).repeat_interleave(rps)
        send_i = send.to(torch.int32)
        if intra:
            # consecutive IDRs of one stripe stream must differ in
            # idr_pic_id (§7.4.3): a 4-bit cycle of the sent counter
            row_id = (sent & 0xF).repeat_interleave(rps)
            sent += send_i
            fnum.copy_(torch.where(send, 1, fnum))
            enc = ops.mb_encode_i
        else:
            row_id = fnum.repeat_interleave(rps)
            sent += send_i
            fnum.copy_(torch.where(send, fnum + 1, fnum))
            enc = ops.mb_encode_p0
        # the reference planes advance only for DELIVERED stripes
        lv, cbp, mb_pay, mb_nb = enc(y, u, v, qp_rows, send_i, rps,
                                     ref_y, ref_u, ref_v)
        ev_pay, ev_nb = ops.cavlc_events(lv, cbp, intra)
        st = ops.pack_stream(mb_pay, mb_nb, ev_pay, ev_nb, hdr_pay, hdr_nb,
                             row_id, qp_rows, intra, e_cap, w_cap, out_cap)
        return st.data, st.byte_lens, send, is_paint, st.flags.any()

    step.__name__ = f"h264_{mode}_step"
    return step


class H264EncoderSession:
    """Per-display H.264 encoder session (the reference's lifecycle:
    ``encode`` dispatches, ``finalize``/``finalize_stream`` read back).

    ``device`` None means ``cuda`` (raises when CUDA is absent); pass
    ``"cpu"`` for the plain versions."""

    def __init__(self, settings: CaptureSettings, device=None):
        _check_slice(settings)
        self.device = resolve_device(device)
        self.settings = settings
        self._ops = KERNEL_OPS
        self.grid = plan_h264_grid(settings)
        g = self.grid
        self.n_rows = g.n_stripes * g.rows_per_stripe
        self._e_cap, self._w_cap, self._out_cap = h264_buffer_caps(g)
        self._i_step = self._build_step("i")
        self._p_step = self._build_step("p")
        self.frame_id = 0
        dev = self.device

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)
        self._age = zeros(g.n_stripes)
        self._sent = zeros(g.n_stripes)
        self._fnum = zeros(g.n_stripes)
        self._prev = zeros(g.height, g.width, 3, dtype=torch.uint8)
        self._ref_y = zeros(g.height, g.width, dtype=torch.uint8)
        self._ref_u = zeros(g.height // 2, g.width // 2, dtype=torch.uint8)
        self._ref_v = zeros(g.height // 2, g.width // 2, dtype=torch.uint8)
        self._force_after_drop = False
        # encode() tests-and-clears the flag while finalize sets it on
        # overflow: the lock keeps a concurrent set from being lost
        self._drop_lock = threading.Lock()
        self._cap_gen = 0   # buffer-growth generation
        self._sps_pps = hcodec.write_sps(g.width, g.stripe_h) \
            + hcodec.write_pps()

        def events(fn):
            pay, nb = fn(g.mb_w, g.rows_per_stripe)
            return (torch.as_tensor(np.tile(pay.astype(np.int32),
                                            (g.n_stripes, 1)), device=dev),
                    torch.as_tensor(np.tile(nb, (g.n_stripes, 1)),
                                    device=dev))
        self._hdr_pay, self._hdr_nb = events(hcodec.slice_header_events)
        self._p_hdr_pay, self._p_hdr_nb = events(
            hcodec.p_slice_header_events)
        self.qp = int(np.clip(settings.video_crf, 8, 48))
        self.paint_qp = int(np.clip(settings.video_min_qp, 8, self.qp))

    def _build_step(self, mode: str):
        g, s = self.grid, self.settings
        return build_h264_step_fn(mode, g.width, g.stripe_h, g.n_stripes,
                                  self._e_cap, self._w_cap, self._out_cap,
                                  s.paint_over_delay_frames,
                                  s.use_damage_gating, s.use_paint_over,
                                  ops=self._ops)

    # -- device step --------------------------------------------------------
    def encode(self, frame, force: bool = False) -> dict[str, Any]:
        """One adaptive I/P step on a (height, width, 3) uint8 frame
        (numpy or torch). ``force`` and the very first frame produce IDRs;
        every other frame is a zero-MV P."""
        cap_gen = self._cap_gen
        with self._drop_lock:
            if self._force_after_drop:
                self._force_after_drop = False
                force = True
        if self.frame_id == 0:
            # every stripe stream must OPEN with an IDR
            force = True
        frame = torch.as_tensor(frame).to(self.device).contiguous()
        return self._dispatch_stock(frame, bool(force), cap_gen)

    def _dispatch_stock(self, frame, intra: bool, cap_gen: int
                        ) -> dict[str, Any]:
        step = self._i_step if intra else self._p_step
        hdr_pay = self._hdr_pay if intra else self._p_hdr_pay
        hdr_nb = self._hdr_nb if intra else self._p_hdr_nb
        data, row_lens, send, is_paint, overflow = step(
            frame, self._prev, self._age, self._sent, self._fnum,
            self._ref_y, self._ref_u, self._ref_v, self.qp, self.paint_qp,
            intra, hdr_pay, hdr_nb)
        fid = self.frame_id
        self.frame_id = (self.frame_id + 1) & 0xFFFF
        # start the copies of the SMALL control arrays now; the stream
        # buffer is fetched at finalize once the row lengths are known
        control = HostCopy([row_lens, send, is_paint, overflow])
        return {"data": data, "lens": row_lens, "send": send,
                "is_paint": is_paint, "overflow": overflow,
                "control": control, "frame_id": fid, "intra": intra,
                "cap_gen": cap_gen}

    # -- host tail ----------------------------------------------------------
    def finalize(self, out: dict[str, Any], force_all: bool = False
                 ) -> list[EncodedChunk]:
        """``force_all`` is ignored — forced refreshes are an encode()-time
        decision for this codec."""
        del force_all
        g = self.grid
        overflowed, idle, lens, send, intra = self._sync_control(out)
        if overflowed:
            self._handle_overflow(out)
            return []
        if idle:
            return []
        starts = self._row_starts(lens)
        rps = g.rows_per_stripe
        # fetch through the last DELIVERED stripe's rows only
        last_row = (int(np.nonzero(send)[0][-1]) + 1) * rps - 1
        data = fetch_stream_bytes(out["data"],
                                  int(starts[last_row] + lens[last_row]))
        chunks: list[EncodedChunk] = []
        for i in range(g.n_stripes):
            if not send[i]:
                continue
            rows = [bytes(data[starts[r]:starts[r] + lens[r]])
                    for r in range(i * rps, (i + 1) * rps)]
            chunks.append(self._chunk(out, i, rows, intra))
        return chunks

    def finalize_stream(self, out: dict[str, Any], force_all: bool = False):
        """Stripe-granular finalize: yields each stripe's access unit with
        a per-stripe fetch. Byte-identical to :meth:`finalize`."""
        del force_all
        g = self.grid
        overflowed, idle, lens, send, intra = self._sync_control(out)
        if overflowed:
            self._handle_overflow(out)
            return
        if idle:
            return
        starts = self._row_starts(lens)
        rps = g.rows_per_stripe
        for i in range(g.n_stripes):
            if not send[i]:
                continue
            r0, r1 = i * rps, (i + 1) * rps
            raw = fetch_stripe_bytes(
                out["data"], int(starts[r0]),
                int(starts[r1 - 1] + lens[r1 - 1] - starts[r0]))
            base = int(starts[r0])
            rows = [bytes(raw[starts[r] - base:starts[r] - base + lens[r]])
                    for r in range(r0, r1)]
            yield self._chunk(out, i, rows, intra)

    @staticmethod
    def _row_starts(lens: np.ndarray) -> np.ndarray:
        """Byte offset of each MB row inside ``out['data']``."""
        return np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)

    def _sync_control(self, out: dict[str, Any]):
        """The one device-sync point. -> (overflowed, idle, lens, send,
        intra)."""
        lens, send, _, overflow = out["control"].wait()
        if bool(overflow):
            return True, True, None, None, True
        return False, not send.any(), lens, send, out.get("intra", True)

    def _chunk(self, out: dict[str, Any], i: int, rows: list,
               intra: bool) -> EncodedChunk:
        g = self.grid
        return EncodedChunk(
            payload=h264_stripe_payload(intra, rows, self._sps_pps),
            frame_id=out["frame_id"], stripe_y=i * g.stripe_h,
            width=g.width, height=g.stripe_h, is_idr=intra,
            output_mode="h264", seat_index=self.settings.seat_index,
            display_id=self.settings.display_id)

    def _handle_overflow(self, out: dict[str, Any]) -> None:
        # grow once per episode: frames encoded with the old caps also
        # report overflow but must not re-double
        if out["cap_gen"] == self._cap_gen:
            logger.warning("h264 overflow at frame %d; growing buffers",
                           out["frame_id"])
            self._w_cap *= 2
            self._out_cap *= 2
            self._i_step = self._build_step("i")
            self._p_step = self._build_step("p")
            self._cap_gen += 1
        with self._drop_lock:
            self._force_after_drop = True
