"""Split-frame H.264 on one card: one frame's MB rows as shards.

The counterpart of selkies_tpu/parallel/stripes.py. The reference shards
a frame's MB rows over a 1-D ``Mesh('stripe')`` and runs a collective-
free ``shard_map`` program on each band of rows: every MB row is its own
slice, motion windows are stripe-bounded, and where a window spans
shards the reference planes are gathered into halo bands ahead of the
per-shard program. On one card a shard is a seat
(parallel/h264_seats.py): the frame's rows, back to back, ARE the
stacked shard layout, so each kernel launches once for all shards and
K4's seat entry ``pack_stream_seats`` gives each shard its own byte
buffer and overflow flags.

- :func:`stripe_mesh` / :func:`resolved_stripe_devices`: the shard count
  (the largest that divides the MB rows, capped at the request and the
  devices given), logged and exported as the ``selkies_stripe_devices``
  gauge. A mesh whose entries are all one device runs its shards there;
  distinct devices raise (:data:`ACROSS_CARDS`).
- :func:`h264_encode_sharded` (I) and :func:`h264_encode_p_sharded` (P),
  4:2:0 and 4:4:4, byte-equal to the unsharded frame entries. Rows that
  do not divide the mesh are padded with zero rows and trimmed.
- The halo path of P frames whose motion window spans shards: K20
  :func:`halo_bands` (csrc/halo_bands.cu) cuts the reference planes into
  edge-clamped bands of ``band + 2 * halo`` rows, and K19
  :func:`motion_select_halo` (csrc/motion_select.cu) is K5's search with
  the window clamp taken from global rows and the reference rows read
  from the shard's band; K2-P, K3 and K4 then code the precomputed
  prediction. Each has its plain version (``*_plain``).

The session of the serving path, ``StripeShardedH264Session``, lives in
engine/h264_encoder.py.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..ops import _cuda
from ..ops.h264_encode import (H264FrameOut, _check, _motion_select_plain,
                               _on_cpu, candidate_table)
from ..ops.h264_planes import (SEAT_KERNEL_OPS, SEAT_PLAIN_OPS, StepOps,
                               _as_tensor, _frame_args, p_rows)
from ..ops.h264_planes444 import SEAT_KERNEL_OPS_444, SEAT_PLAIN_OPS_444
from ..server import metrics as _metrics

logger = logging.getLogger("selkies_tpu_torch.parallel.stripes")

#: what a mesh of distinct devices waits for
ACROSS_CARDS = "split-frame and seats across several cards (ROADMAP A11c)"


@dataclasses.dataclass(frozen=True)
class StripeMesh:
    """The devices one frame's MB rows are spread over (the reference's
    1-D ``Mesh('stripe')``); ``devices`` is a 1-D object array, so
    ``devices.size`` reads as the reference's does."""
    devices: np.ndarray
    axis_names: tuple = ("stripe",)


def _same_device(a: torch.device, b: torch.device) -> bool:
    """``cuda`` and ``cuda:0`` are one device."""
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def one_device(devices) -> torch.device:
    """The one device of a mesh's entries. Entries that name more than one
    device raise: no run on one card can check a cross-card copy."""
    devs = [torch.device(d) for d in np.asarray(devices, object).reshape(-1)]
    first = devs[0]
    for d in devs[1:]:
        if not _same_device(d, first):
            raise NotImplementedError(
                f"{ACROSS_CARDS} is not ported: the mesh names "
                f"{sorted({str(x) for x in devs})}")
    return first


def _device_list(devices: Optional[Sequence]) -> list:
    """``devices`` resolved, or every card (None; raises without one)."""
    if devices is None:
        resolve_device(None)
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [resolve_device(d) for d in devices]


def resolved_stripe_devices(n_rows: int, requested: int,
                            n_avail: Optional[int] = None) -> int:
    """The shard count :func:`stripe_mesh` would choose: the largest that
    divides ``n_rows``, at most ``requested`` and ``n_avail`` (None: the
    cards present)."""
    if n_avail is None:
        n_avail = torch.cuda.device_count()
    want = max(1, min(int(requested), n_avail))
    n = max(1, min(want, int(n_rows)))
    while n_rows % n:
        n -= 1
    return n


def stripe_mesh(n_rows: int, devices: Optional[Sequence] = None,
                requested: Optional[int] = None) -> StripeMesh:
    """1-D mesh of the largest device count dividing ``n_rows`` (MB rows),
    capped at ``requested`` when given. ``devices`` None means every card.
    Degrading below the request is logged and gauged, never silent."""
    devs = _device_list(devices)
    avail = len(devs)
    if avail < 1:
        raise ValueError("stripe_mesh needs at least one device")
    want = avail if requested is None else max(1, min(int(requested), avail))
    n = resolved_stripe_devices(n_rows, want, avail)
    if n < want:
        logger.warning(
            "stripe_mesh degraded to %d device(s): %d MB rows not "
            "divisible by %d (available %d)", n, n_rows, want, avail)
    else:
        logger.info("stripe_mesh: %d device(s) over %d MB rows", n, n_rows)
    _metrics.set_gauge("selkies_stripe_devices", float(n))
    arr = np.empty((n,), object)
    arr[:] = devs[:n]
    return StripeMesh(arr)


# ---------------------------------------------------------------------------
# geometry validation + row padding
# ---------------------------------------------------------------------------

def _check_frame(yf, mesh: StripeMesh) -> tuple:
    """-> (R, n_dev, pad_rows); raises ValueError for geometry the shard
    layout cannot represent, rounds the MB-row count up with pad rows
    where it can."""
    H, W = int(yf.shape[0]), int(yf.shape[1])
    if H % 16 or W % 16:
        raise ValueError(f"frame {W}x{H} is not macroblock-aligned")
    n_dev = int(mesh.devices.size)
    if n_dev < 1:
        raise ValueError("empty stripe mesh")
    R = H // 16
    if n_dev > R:
        raise ValueError(
            f"{n_dev} devices over {R} MB rows: more shards than rows")
    return R, n_dev, (-R) % n_dev


def _pad0(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Append ``pad`` zero entries along dim 0."""
    if pad == 0:
        return t
    return torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])


def _mesh_args(yf, uf, vf, qp, header_pay, header_nb, row_id, mesh, device):
    """The frame's inputs on the mesh's device (``device``, when given,
    must be it), with the header rows checked."""
    R, n, pad = _check_frame(yf, mesh)
    dev = one_device(mesh.devices)
    if device is not None and not _same_device(resolve_device(device), dev):
        raise ValueError(f"device {device} is not the mesh's {dev}")
    planes, qp, hp, hn, rid = _frame_args(yf, uf, vf, qp, header_pay,
                                          header_nb, row_id, dev)
    if hp.shape[0] != R:
        raise ValueError(
            f"header events carry {hp.shape[0]} rows, frame has {R}")
    return R, n, pad, planes, qp, hp, hn, rid


def _trim(planes, R: int, cdiv: int) -> tuple:
    """The first R MB rows of Y, U and V planes."""
    return (planes[0][:16 * R], planes[1][:16 * R // cdiv],
            planes[2][:16 * R // cdiv])


def _pad_frame(pad, cdiv, planes, rows):
    """Zero pad rows: 16 pixel rows per MB row (16 / cdiv of chroma) and
    one entry of every per-row input."""
    y, u, v = planes
    return ([_pad0(y, 16 * pad), _pad0(u, 16 * pad // cdiv),
             _pad0(v, 16 * pad // cdiv)], [_pad0(t, pad) for t in rows])


# ---------------------------------------------------------------------------
# K20 halo_bands and K19 motion_select_halo
# ---------------------------------------------------------------------------

def _halo_index(n: int, band: int, halo: int, h: int, device):
    """(n, band + 2 * halo) plane rows of each band, clamped to the
    plane."""
    return torch.clamp(torch.arange(n, device=device)[:, None] * band
                       + torch.arange(-halo, band + halo,
                                      device=device)[None, :], 0, h - 1)


def halo_bands_plain(plane, band: int, halo: int) -> torch.Tensor:
    """(H', W) plane -> (H' / band, band + 2 * halo, W) bands: band s
    holds plane rows ``s * band - halo`` .. ``(s + 1) * band + halo - 1``,
    edge-clamped at the plane's bound (the reference's ``_halo_bands``;
    it gathers int32, the port keeps uint8: the same values)."""
    h = plane.shape[0]
    return plane[_halo_index(h // band, band, halo, h, plane.device)]


def halo_bands(plane, band: int, halo: int) -> torch.Tensor:
    """K20 (csrc/halo_bands.cu) for a CUDA tensor, else
    :func:`halo_bands_plain`; ``plane`` is (H', W) uint8 with ``band``
    dividing H'."""
    h, w = plane.shape
    if band < 1 or h % band or halo < 0:
        raise ValueError(f"bands of {band} rows (halo {halo}) do not tile "
                         f"{h} rows")
    _check(plane, "plane", torch.uint8, (h, w), plane.device)
    if _on_cpu(plane):
        return halo_bands_plain(plane, band, halo)
    n = h // band
    out = torch.empty((n, band + 2 * halo, w), dtype=torch.uint8,
                      device=plane.device)
    _cuda.launch("halo_bands", plane, h, w, n, band, halo, out)
    return out


def motion_select_halo_plain(cur_y, hy, hu, hv, qp_rows, candidates,
                             win: int, out=None):
    """K5's search (SAD + lambda * mvd bits, first index on ties) over a
    frame of ``n = hy.shape[0]`` shards, the reference planes given as
    the halo bands of :func:`halo_bands` (luma ``hy``, 4:2:0 chroma
    ``hu``/``hv``). -> (pred_y, pred_u, pred_v) uint8 and the (R, M, 2)
    quarter-pel MV field, equal to K5 on the whole frame with windows of
    ``win`` rows."""
    return _motion_select_plain(cur_y, hy, hu, hv, qp_rows, candidates, win,
                                out, False)


def motion_select_halo444_plain(cur_y, hy, hu, hv, qp_rows, candidates,
                                win: int, out=None):
    """The 4:4:4 search against halo bands: full-resolution chroma bands
    ride the luma's full-pel shift (``motion_select444``'s rule)."""
    return _motion_select_plain(cur_y, hy, hu, hv, qp_rows, candidates, win,
                                out, True)


def _motion_select_halo(entry, plain, cdiv, cur_y, hy, hu, hv, qp_rows,
                        candidates, win, out):
    H, W = cur_y.shape
    R, M = H // 16, W // 16
    dev = cur_y.device
    n = hy.shape[0]
    if H % 16 or W % 16 or win % 16 or H % win or n < 1 or R % n:
        raise ValueError("planes must tile into MBs, ``win``-row windows "
                         "and shards of whole MB rows")
    band = H // n
    halo_y = (hy.shape[1] - band) // 2
    halo_c = (hu.shape[1] - band // cdiv) // 2
    table = candidate_table(candidates)
    vmax = int(np.abs(table[:, 0].numpy()).max())
    need_c = vmax if cdiv == 1 else vmax // 2 + 1
    if halo_y < vmax or halo_c < need_c:
        raise ValueError(f"halo of {halo_y}/{halo_c} rows is short of the "
                         f"candidates' |dy| {vmax}")
    cw = W // cdiv
    for t, name, shp in ((cur_y, "cur_y", (H, W)),
                         (hy, "hy", (n, band + 2 * halo_y, W)),
                         (hu, "hu", (n, band // cdiv + 2 * halo_c, cw)),
                         (hv, "hv", (n, band // cdiv + 2 * halo_c, cw))):
        _check(t, name, torch.uint8, shp, dev)
    _check(qp_rows, "qp_rows", torch.int32, (R,), dev)
    if _on_cpu(cur_y):
        return plain(cur_y, hy, hu, hv, qp_rows, candidates, win, out)
    cshape = (H // cdiv, cw)
    if out is None:
        out = (torch.empty((H, W), dtype=torch.uint8, device=dev),
               torch.empty(cshape, dtype=torch.uint8, device=dev),
               torch.empty(cshape, dtype=torch.uint8, device=dev),
               torch.empty((R, M, 2), dtype=torch.int32, device=dev))
    for t, name, dt, shp in zip(out, ("pred_y", "pred_u", "pred_v", "mv"),
                                (torch.uint8,) * 3 + (torch.int32,),
                                ((H, W), cshape, cshape, (R, M, 2))):
        _check(t, name, dt, shp, dev)
    _cuda.launch(entry, cur_y, hy, hu, hv, qp_rows, table, len(table), H, W,
                 win, band // 16, halo_y, halo_c, *out)
    return tuple(out)


def motion_select_halo(cur_y, hy, hu, hv, qp_rows, candidates, win: int,
                       out=None):
    """K19 (csrc/motion_select.cu:motion_select_halo) for CUDA tensors,
    else :func:`motion_select_halo_plain`; same contract."""
    return _motion_select_halo("motion_select_halo", motion_select_halo_plain,
                               2, cur_y, hy, hu, hv, qp_rows, candidates,
                               win, out)


def motion_select_halo444(cur_y, hy, hu, hv, qp_rows, candidates, win: int,
                          out=None):
    """K19's 4:4:4 entry (csrc/motion_select.cu:motion_select_halo444) for
    CUDA tensors, else :func:`motion_select_halo444_plain`."""
    return _motion_select_halo("motion_select_halo444",
                               motion_select_halo444_plain, 1, cur_y, hy,
                               hu, hv, qp_rows, candidates, win, out)


# ---------------------------------------------------------------------------
# the sharded frame entries
# ---------------------------------------------------------------------------

class ShardOps(NamedTuple):
    """The kernels of a sharded frame, or their plain versions."""
    step: StepOps               # K4's seat entry as ``pack_stream``
    halo_bands: object          # K20
    motion_select_halo: object  # K19


#: the kernels of a sharded frame, by ``fullcolor``
SHARD_OPS = {False: ShardOps(SEAT_KERNEL_OPS, halo_bands, motion_select_halo),
             True: ShardOps(SEAT_KERNEL_OPS_444, halo_bands,
                            motion_select_halo444)}
#: their plain versions, which runs on the card are held against
SHARD_PLAIN_OPS = {
    False: ShardOps(SEAT_PLAIN_OPS, halo_bands_plain,
                    motion_select_halo_plain),
    True: ShardOps(SEAT_PLAIN_OPS_444, halo_bands_plain,
                   motion_select_halo444_plain)}


def _pack(ops, R, n, mb_pay, mb_nb, ev, hp, hn, row_id, qp, intra, e_cap,
          w_cap):
    """K4's seat entry, one shard a seat with a buffer of its rows' word
    capacity; -> the frame's output over its R unpadded rows (overflow
    over every shard, pad rows included, as the reference's ``jnp.any``
    over the padded shards)."""
    rows = mb_pay.shape[0] // n
    st = ops.step.pack_stream(mb_pay, mb_nb, *ev, hp, hn, row_id, qp, intra,
                              e_cap, w_cap, rows * w_cap * 4, n_seats=n)
    return H264FrameOut(st.words[:R], st.total_bits[:R],
                        st.flags[:, 0].any(), R)


def h264_encode_sharded(yf, uf, vf, qp, header_pay, header_nb, e_cap: int,
                        w_cap: int, mesh: StripeMesh, idr_pic_id=0,
                        fullcolor: bool = False, want_recon: bool = False,
                        device=None):
    """I-encode one frame with its MB rows sharded over ``mesh``; byte-
    equal to the unsharded encoder. One launch each of K2-I (K14 at
    4:4:4), K3 (K16) and K4's seat entry over the padded frame. Rows
    that do not divide the mesh are padded with zero rows (QP,
    idr_pic_id and header events 0) and trimmed from the output.
    ``device`` (None: the mesh's) must be the mesh's one device."""
    R, n, pad, planes, qp, hp, hn, idr = _mesh_args(
        yf, uf, vf, qp, header_pay, header_nb, idr_pic_id, mesh, device)
    cdiv = 1 if fullcolor else 2
    (y, u, v), (qp, idr, hp, hn) = _pad_frame(pad, cdiv, planes,
                                              (qp, idr, hp, hn))
    ops = SHARD_OPS[bool(fullcolor)]
    send = torch.ones((1,), dtype=torch.int32, device=y.device)
    ref = [torch.empty_like(p) for p in (y, u, v)]
    lv, cbp, mb_pay, mb_nb = ops.step.mb_encode_i(y, u, v, qp, send,
                                                  R + pad, *ref)
    ev = ops.step.cavlc_events(lv, cbp, True)
    out = _pack(ops, R, n, mb_pay, mb_nb, ev, hp, hn, idr, qp, True, e_cap,
                w_cap)
    return (out, _trim(ref, R, cdiv)) if want_recon else out


def h264_encode_p_sharded(yf, uf, vf, ref_y, ref_u, ref_v, qp, header_pay,
                          header_nb, frame_num, e_cap: int, w_cap: int,
                          mesh: StripeMesh, candidates: tuple = ((0, 0),),
                          stripe_rows: int | None = None,
                          fullcolor: bool = False, device=None):
    """P-encode one frame with its MB rows sharded over ``mesh``; byte-
    equal to the unsharded ``h264_encode_p_yuv[444]`` with the same
    ``stripe_rows``. When each shard holds whole motion windows: one
    launch each of K5, K2-P (K15), K3 (K16) and K4's seat entry. When a
    window spans shards: K20 cuts the reference planes into halo bands,
    K19 searches against them, and K2-P, K3 and K4 code that prediction.
    -> (H264FrameOut, (recon_y, recon_u, recon_v)); the reference planes
    given are not updated."""
    R, n, pad, planes, qp, hp, hn, fn = _mesh_args(
        yf, uf, vf, qp, header_pay, header_nb, frame_num, mesh, device)
    cdiv = 1 if fullcolor else 2
    win_rows = int(stripe_rows) if stripe_rows else R
    if R % win_rows:
        raise ValueError(f"stripe_rows={win_rows} does not tile {R} rows")
    rows_per_shard = (R + pad) // n
    motion = len(candidates) > 1
    need_halo = motion and rows_per_shard % win_rows != 0
    if need_halo and pad:
        raise ValueError(
            f"{n} devices do not divide {R} MB rows and the motion "
            f"window ({win_rows} rows) spans shards: no pad geometry "
            "exists — choose a dividing device count")
    dev = planes[0].device
    # K2-P writes the recon into these copies
    ref = _pad_frame(pad, cdiv, [_as_tensor(p, dev).to(torch.uint8).clone()
                                 for p in (ref_y, ref_u, ref_v)], ())[0]
    (y, u, v), (qp, fn, hp, hn) = _pad_frame(pad, cdiv, planes,
                                             (qp, fn, hp, hn))
    ops = SHARD_OPS[bool(fullcolor)]
    send = torch.ones((R + pad,), dtype=torch.int32, device=dev)
    win = 16 * win_rows
    pred = None
    if need_halo:
        band = 16 * rows_per_shard
        vmax = max(abs(dy) for dy, _ in candidates)
        halo_y = max(1, vmax)
        halo_c = halo_y if fullcolor else vmax // 2 + 1
        bands = [ops.halo_bands(ref[0], band, halo_y)] + [
            ops.halo_bands(p, band // cdiv, halo_c) for p in ref[1:]]
        pred = ops.motion_select_halo(y, *bands, qp, candidates, win)
    lv, cbp, mb_pay, mb_nb = p_rows(
        ops.step, y, u, v, qp, send, ref,
        candidates if motion and pred is None else None, win, pred=pred)
    ev = ops.step.cavlc_events(lv, cbp, False)
    out = _pack(ops, R, n, mb_pay, mb_nb, ev, hp, hn, fn, qp, False, e_cap,
                w_cap)
    return out, _trim(ref, R, cdiv)
