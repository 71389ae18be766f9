"""Plane-layout H.264 4:4:4 (``fullcolor``) encode in PyTorch, and its
CUDA kernels.

The counterpart of selkies_tpu/ops/h264_planes444.py: High 4:4:4
Predictive with CAVLC, one slice per MB row. With ChromaArrayType 3 each
chroma component is coded exactly like luma (residual_luma per
component, per-component nC contexts, no intra_chroma_pred_mode, one
Intra_16x16 AC flag and one set of inter cbp group bits covering all
three components), so this module is the luma half of
ops/h264_planes.py instantiated over three full-resolution planes; luma
runs at ``qp`` and both chroma components at ``qpc = _QPC[qp]``. The
plain versions reuse that module's transforms, quantisers and CAVLC
event builder; the tests hold each to its JAX original.

The kernels of the 4:4:4 main path, each a wrapper that launches a
hand-written CUDA kernel for a CUDA tensor and runs its plain version
for a CPU tensor:

========================  =================================================
``csc444_damage`` (K13)   RGB -> three full-resolution planes, per-stripe
                          damage flags, ``prev`` updated in place
``mb_encode_i444`` (K14)  per component: transforms, quant, the
                          Intra16x16 DC chain, recon (send-gated, into the
                          reference planes in place); the shared AC flag
                          and the 2-slot MB header
``mb_encode_p444`` (K15)  residual against the prediction in three
                          luma-style components, cbp group bits over all
                          of them, ``coded``, header slots 1-5 (cbp
                          through the 4:4:4 me(v) table), recon in place
``cavlc_events444`` (K16) per-component CAVLC (payload, nbits) slots
``motion_select444``      in ops/h264_encode.py: K5 with full-resolution
                          chroma riding the luma's full-pel shift
``pack_stream`` (K4)      unchanged (ops/h264_planes.py), at this
                          module's slot counts
========================  =================================================

Kernel layouts (R MB rows, M MB columns):

- ``lv`` I (R, M, 51, 16) int16: per component c, block 17c = its DC
  levels in zigzag order (16), blocks 17c+1..17c+16 = its 16 AC blocks
  in 8x8-quadrant coding order (``_SCAN_ORDER``), 15 levels each; P
  (R, M, 48, 16): block 16c+k = component c's block at coding position
  k, all 16 levels. Unused tail positions are zero.
- ``cbp`` (R, M) int32: I: 15 where any component has AC levels, else
  0; P: the four 8x8 group bits.
- ``hdr_pay``/``hdr_nb`` (R, M, 6) int32: I: ue(mb_type), se(0) qp
  delta, then empty slots; P: as K2-P (skip run filled by the packer).
- ``ev_pay``/``ev_nb`` (R, M, SB): per component its blocks' slots in
  bitstream order (I: DC then the AC blocks, 580 slots; P: 16 blocks of
  36 slots, 576), components back to back: SB = 1740 (I) / 1728 (P).
"""

from __future__ import annotations

import numpy as np
import torch

from ..codecs import h264_tables as HT
from . import _cuda
from .colorspace import rgb_to_ycbcr
from .h264_encode import (H264FrameOut, _check, _on_cpu, _se_event,
                          _ue_event, motion_select444, motion_select444_plain)
from .h264_planes import (I64, _SCAN_RASTER, _ZZ_IJ, StepOps, _blocks_rm,
                          _cavlc_events, _clip1, _dequant_ldc_e,
                          _dequant_plane, _encode_p_frame, _expand,
                          _frame_args, _gate_rows, _had4, _hdr_tensor,
                          _mb_encode, _mb_encode_p, _merge_planes,
                          _nc_planes, _pad16, _pad_left_mb, _plane_to_rm,
                          _qpc_of, _quant_dc_e, _quant_plane, _t,
                          _tc_gate_plane, cavlc_events_planes, fwd4_planes,
                          inv4_planes, mb_qp_delta, mb_qp_delta_plain,
                          pack_stream, pack_stream_plain, pack_stream_seats,
                          pack_stream_seats_plain, roi_qp_plane,
                          roi_qp_plane_plain, row_damage_probe,
                          row_damage_probe_plain)
from .h264_transform import _POS_CLS, ZIGZAG4

# per-MB slot budget: hdr [mb_type, qp_delta] + 3 x (DC block 36 +
# 16 AC blocks x 34); P: 6 hdr slots + 3 x 16 full blocks x 36
SLOTS_BLK16 = 1 + 3 + 16 + 1 + 15
SLOTS_BLK15 = 1 + 3 + 15 + 1 + 14
SLOTS_MB_444 = 2 + 3 * (SLOTS_BLK16 + 16 * SLOTS_BLK15)
P_SLOTS_MB_444 = 6 + 3 * 16 * SLOTS_BLK16

#: kernel layout constants (module docstring)
N_BLOCKS_I = 3 * 17
N_BLOCKS_P = 3 * 16
SB_I = SLOTS_MB_444 - 2        # 1740 block slots per MB, I frames
SB_P = P_SLOTS_MB_444 - 6      # 1728 block slots per MB, P frames

_CBP2CODE = HT.CBP444_INTER_CBP2CODE


def rgb_to_yuv444(rgb):
    """(H, W, 3) uint8 -> three full-resolution int32 planes: BT.601 full
    range in the reference's float order (ops/colorspace.py), each
    rounded half to even and clipped to 0..255."""
    ycc = rgb_to_ycbcr(rgb)
    return tuple(torch.clamp(torch.round(ycc[..., i]), 0, 255)
                 .to(torch.int32) for i in range(3))


# ---------------------------------------------------------------------------
# K13: colour conversion + damage + prev update
# ---------------------------------------------------------------------------

def csc444_damage_plain(frame, prev, n_stripes: int):
    """(H, W, 3) uint8 frame and prev -> (y, u, v) full-resolution uint8
    planes and (S,) int32 per-stripe damage flags; ``prev`` is
    overwritten with ``frame``."""
    y, u, v = rgb_to_yuv444(frame)
    damage = (frame != prev).reshape(n_stripes, -1).any(1).to(torch.int32)
    prev.copy_(frame)
    return y.to(torch.uint8), u.to(torch.uint8), v.to(torch.uint8), damage


def csc444_damage(frame, prev, n_stripes: int):
    """K13 (csrc/csc444_damage.cu) for a CUDA tensor, else the plain
    version. Same contract as :func:`csc444_damage_plain`."""
    H, W = frame.shape[0], frame.shape[1]
    _check(frame, "frame", torch.uint8, (H, W, 3), frame.device)
    _check(prev, "prev", torch.uint8, (H, W, 3), frame.device)
    if n_stripes <= 0 or H % n_stripes:
        raise ValueError("frame must split into equal stripes")
    if _on_cpu(frame):
        return csc444_damage_plain(frame, prev, n_stripes)
    dev = frame.device
    y, u, v = (torch.empty((H, W), dtype=torch.uint8, device=dev)
               for _ in range(3))
    damage = torch.empty((n_stripes,), dtype=torch.int32, device=dev)
    _cuda.launch("csc444_damage", frame, prev, y, u, v, damage, H, W,
                 H // n_stripes)
    return y, u, v, damage


# ---------------------------------------------------------------------------
# K14: the I path, per component
# ---------------------------------------------------------------------------

def _dc_scan_comp(R, M, dc, inv_edge, qp):
    """The left-edge DC prediction chain of ONE luma-like component (the
    reference's ``_dc_scan_comp``): a Python loop over the M MB columns.
    dc, inv_edge (R, 4, M, 4), qp (R,) -> (dc_lvls (R, M, 4, 4), preds
    (R, M))."""
    dev = dc.device
    qp3 = _t(qp, dev)[:, None, None]
    edge = torch.zeros((R, 16), dtype=I64, device=dev)
    dls, ps = [], []
    for k in range(M):
        if k == 0:
            pred = torch.full((R,), 128, dtype=I64, device=dev)
        else:
            pred = (edge.sum(-1) + 8) >> 4
        dcm = dc[:, :, k, :] - 16 * pred[:, None, None]
        dlvl = _quant_dc_e(_had4(dcm) >> 1, qp3)
        dcQ = _dequant_ldc_e(_had4(dlvl), qp3)
        edge = _clip1(pred[:, None, None]
                      + ((inv_edge[:, :, k, :] + dcQ[:, :, 3:4] + 32) >> 6)
                      ).reshape(R, 16)
        dls.append(dlvl)
        ps.append(pred)
    return torch.stack(dls, 1), torch.stack(ps, 1)


def _comp_intra(plane, qp_by, qp_rows, R, M):
    """Transforms, quant (fdiv 3), dequant and the DC chain of one
    component. -> (AC scan planes (15), inverse planes, dc_lvls, preds)."""
    w = fwd4_planes(plane)
    acl = [[_quant_plane(w[i][j], qp_by, int(_POS_CLS[i][j]), 3)
            for j in range(4)] for i in range(4)]
    zero = torch.zeros_like(acl[0][0])
    d = [[_dequant_plane(acl[i][j] if (i, j) != (0, 0) else zero, qp_by,
                         int(_POS_CLS[i][j])) for j in range(4)]
         for i in range(4)]
    inv = inv4_planes(d)
    inv_edge = torch.stack(
        [inv[i][3][:, 3::4].reshape(R, 4, M) for i in range(4)], -1)
    dc = w[0][0].reshape(R, 4, M, 4)
    dc_lvls, preds = _dc_scan_comp(R, M, dc, inv_edge, qp_rows)
    scan = [acl[i][j] for (i, j) in _ZZ_IJ[1:]]
    return scan, inv, dc_lvls, preds


def mb_encode_i444_plain(y, u, v, qp, send, rows_per_stripe: int,
                         ref_y, ref_u, ref_v):
    """Intra_16x16 (DC pred) 4:4:4 MB coding of one frame, one slice per
    MB row (the reference's ``h264_encode_yuv444`` body). -> (lv, cbp,
    hdr_pay, hdr_nb) in the kernel layout; the decoder-exact
    reconstruction of all three components is written into ``ref_*``
    for the rows of stripes with ``send`` set."""
    H, W = y.shape
    R, M = H // 16, W // 16
    dev = y.device
    qp = qp.to(I64)
    qpc = _qpc_of(qp)
    comps = []
    for plane, qr in ((y, qp), (u, qpc), (v, qpc)):
        comps.append(_comp_intra(plane, qr.repeat_interleave(4)[:, None],
                                 qr, R, M) + (qr,))
    zz = _t(ZIGZAG4, dev)
    lvs, flag = [], None
    for scan, _, dc_lvls, _, _ in comps:
        lv_ac = _blocks_rm(scan, R, M, 4)[:, :, _SCAN_RASTER]  # (R,M,16,15)
        nz = (lv_ac != 0).any(-1).any(-1)
        flag = nz if flag is None else flag | nz
        lvs += [dc_lvls.reshape(R, M, 16)[..., zz][:, :, None],
                _pad16(lv_ac)]
    lv = torch.cat(lvs, 2).to(torch.int16)
    cbp = torch.where(flag, 15, 0).to(torch.int32)
    # MB header: ue(mb_type), se(0) qp_delta; no intra_chroma_pred_mode
    ones = torch.ones((R, M), dtype=I64, device=dev)
    hdr_pay, hdr_nb = _hdr_tensor([_ue_event(3 + torch.where(flag, 12, 0)),
                                   (ones, ones)], R, M, dev)
    send_rows = send.repeat_interleave(rows_per_stripe)
    for (_, inv, dc_lvls, preds, qr), ref in zip(comps, (ref_y, ref_u,
                                                          ref_v)):
        dcQ = _dequant_ldc_e(_had4(dc_lvls), qr[:, None, None, None])
        dc_pl = _merge_planes(
            [[dcQ[:, :, i, j] for j in range(4)] for i in range(4)], 4, 4)
        pred_pl = _expand(preds, 4, 4)
        rec = [[_clip1(pred_pl + ((inv[i][j] + dc_pl + 32) >> 6))
                for j in range(4)] for i in range(4)]
        _gate_rows(_merge_planes(rec, 4, 4), ref, send_rows, 16)
    return lv, cbp, hdr_pay, hdr_nb


# ---------------------------------------------------------------------------
# K15: the P path
# ---------------------------------------------------------------------------

def mb_encode_p444_plain(y, u, v, qp, send_rows, pred_y, pred_u, pred_v, mv,
                         ref_y, ref_u, ref_v):
    """P_L0_16x16 / P_Skip 4:4:4 MB coding against a prediction (the
    reference's ``h264_encode_p_yuv444`` body): three luma-style residuals
    quantised with fdiv 6, cbp group bit g covering the g-th 8x8 of every
    component, ``coded = (cbp != 0) | mv_nz``, ``mvd = mv - left
    neighbour``. ``mv`` (R, M, 2) quarter-pel (mvx, mvy), or None for
    zero motion, where ``pred_*`` may be the reference planes themselves.
    -> (lv, cbp, hdr_pay, hdr_nb); the recon is written into ``ref_*``
    in place for the MB rows with ``send_rows`` set, after the whole
    prediction has been read."""
    H, W = y.shape
    R, M = H // 16, W // 16
    dev = y.device
    qp = qp.to(I64)
    qpc = _qpc_of(qp)
    qbs = [q.repeat_interleave(4)[:, None] for q in (qp, qpc, qpc)]
    preds = [p.to(I64) for p in (pred_y, pred_u, pred_v)]
    if mv is None:
        mv = torch.zeros((R, M, 2), dtype=I64, device=dev)
    mv = mv.to(I64)

    acls, lvs = [], []
    for cur, pred, qb in zip((y, u, v), preds, qbs):
        w = fwd4_planes(cur.to(I64) - pred)
        acl = [[_quant_plane(w[i][j], qb, int(_POS_CLS[i][j]), 6)
                for j in range(4)] for i in range(4)]
        acls.append(acl)
        lvs.append(_blocks_rm([acl[i][j] for (i, j) in _ZZ_IJ], R, M, 4))
    nz_blk = sum((lv != 0).any(-1).to(I64) for lv in lvs) > 0   # raster
    g8 = nz_blk.reshape(R, M, 2, 2, 2, 2).any(5).any(3)        # by2 i bx2 j
    cbp = (g8[..., 0, 0].to(I64) | (g8[..., 0, 1].to(I64) << 1)
           | (g8[..., 1, 0].to(I64) << 2) | (g8[..., 1, 1].to(I64) << 3))
    coded = (cbp != 0) | (mv != 0).any(-1)
    lv = torch.cat([x[:, :, _SCAN_RASTER] for x in lvs], 2).to(torch.int16)

    mvd = mv - _pad_left_mb(mv)
    one = torch.ones((R, M), dtype=I64, device=dev)
    cbp_pay, cbp_nb = _ue_event(_t(_CBP2CODE, dev)[cbp])
    mx_pay, mx_nb = _se_event(mvd[..., 0])
    my_pay, my_nb = _se_event(mvd[..., 1])
    hdr_pay, hdr_nb = _hdr_tensor([
        (one, torch.zeros_like(one)),       # skip run: the packer's
        (one, coded.to(I64)),               # mb_type P_L0_16x16
        (mx_pay, torch.where(coded, mx_nb, 0)),
        (my_pay, torch.where(coded, my_nb, 0)),
        (cbp_pay, torch.where(coded, cbp_nb, 0)),
        (one, (coded & (cbp != 0)).to(I64))], R, M, dev)

    # ---- recon (decoder-exact), every component gated by the same bits
    colg = torch.arange(4 * M, device=dev)[None, :]
    rowg = torch.arange(4 * R, device=dev)[:, None]
    g8_idx = ((rowg % 4) >> 1) * 2 + ((colg % 4) >> 1)
    blk_on = (((_expand(cbp, 4, 4) >> g8_idx) & 1) == 1) \
        & _expand(coded, 4, 4)
    zero = torch.zeros((), dtype=I64, device=dev)
    recs = []
    for acl, pred, qb in zip(acls, preds, qbs):
        d = [[_dequant_plane(torch.where(blk_on, acl[i][j], zero), qb,
                             int(_POS_CLS[i][j])) for j in range(4)]
             for i in range(4)]
        inv = inv4_planes(d)
        recs.append(_merge_planes(
            [[_clip1(pred[i::4, j::4] + ((inv[i][j] + 32) >> 6))
              for j in range(4)] for i in range(4)], 4, 4))
    for rec, ref in zip(recs, (ref_y, ref_u, ref_v)):
        _gate_rows(rec, ref, send_rows, 16)
    return lv, cbp.to(torch.int32), hdr_pay, hdr_nb


def mb_encode_i444(y, u, v, qp, send, rows_per_stripe: int, ref_y, ref_u,
                   ref_v):
    """K14 (csrc/mb_encode444.cu:mb_encode_i444) for CUDA tensors, else
    :func:`mb_encode_i444_plain`; the planes are full resolution."""
    return _mb_encode("mb_encode_i444", mb_encode_i444_plain, y, u, v, qp,
                      send, rows_per_stripe, ref_y, ref_u, ref_v, 1,
                      N_BLOCKS_I)


def mb_encode_p444(y, u, v, qp, send_rows, pred_y, pred_u, pred_v, mv, ref_y,
                   ref_u, ref_v):
    """K15 (csrc/mb_encode444.cu:mb_encode_p444) for CUDA tensors, else
    :func:`mb_encode_p444_plain`; same contract. ``send_rows`` (R,) int32
    gates the reference advance per MB row."""
    return _mb_encode_p("mb_encode_p444", mb_encode_p444_plain, y, u, v, qp,
                        send_rows, pred_y, pred_u, pred_v, mv, ref_y, ref_u,
                        ref_v, 1, N_BLOCKS_P)


# ---------------------------------------------------------------------------
# K16: CAVLC events, three luma-style components
# ---------------------------------------------------------------------------

def cavlc_events444_plain(lv, cbp, intra: bool):
    """(lv (R, M, 51 | 48, 16) int16, cbp (R, M) int32) -> (ev_pay int32,
    ev_nb uint8) of shape (R, M, SB): each component's gated CAVLC slots
    in bitstream order, nC from that component's own gated total-coeff
    plane (module docstring)."""
    R, M = lv.shape[0], lv.shape[1]
    dev = lv.device
    lv = lv.to(I64)
    cbp = cbp.to(I64)
    raster = torch.tensor(np.argsort(_SCAN_RASTER), device=dev)
    perm = torch.tensor(_SCAN_RASTER, device=dev)
    mc = 15 if intra else 16
    if intra:
        gate = ((cbp & 15) != 0)[..., None].expand(R, M, 16)
    else:
        g8 = ((torch.arange(16, device=dev) // 4) >> 1) * 2 \
            + ((torch.arange(16, device=dev) % 4) >> 1)
        gate = ((cbp[..., None] >> g8) & 1) == 1
    classes = []
    for c in range(3):
        first = 17 * c + 1 if intra else 16 * c
        lvc = lv[:, :, first:first + 16, :mc][:, :, raster]   # raster order
        nc = _nc_planes(_tc_gate_plane(lvc, gate, R, M, 4), 4)
        if intra:
            dpay, dnb, _ = cavlc_events_planes(
                lv[:, :, 17 * c, :16].permute(2, 0, 1), nc[0::4, 0::4])
            classes.append((dpay[..., None], dnb[..., None]))
        pay, nb, _ = cavlc_events_planes(lvc.permute(3, 0, 1, 2),
                                         _plane_to_rm(nc, R, M, 4))
        nb = torch.where(gate[None], nb, 0)
        classes.append((pay[..., perm], nb[..., perm]))
    pay = torch.cat([p.permute(1, 2, 3, 0).reshape(R, M, -1)
                     for p, _ in classes], -1)
    nb = torch.cat([n.permute(1, 2, 3, 0).reshape(R, M, -1)
                    for _, n in classes], -1)
    pay = torch.where(nb > 0, pay, 0)
    return pay.to(torch.int32), nb.to(torch.uint8)


def cavlc_events444(lv, cbp, intra: bool):
    """K16 (csrc/cavlc_events.cu:cavlc_events444) for CUDA tensors, else
    :func:`cavlc_events444_plain`."""
    return _cavlc_events("cavlc_events444", cavlc_events444_plain,
                         N_BLOCKS_I if intra else N_BLOCKS_P,
                         SB_I if intra else SB_P, lv, cbp, intra)


# ---------------------------------------------------------------------------
# the 4:4:4 step ops and frame-level entry points
# ---------------------------------------------------------------------------

#: ROI QP is ignored at 4:4:4 (as in the reference): the sets name K17
#: and K18, which the 4:4:4 steps never call
KERNEL_OPS_444 = StepOps(csc444_damage, mb_encode_i444, mb_encode_p444,
                         cavlc_events444, pack_stream, motion_select444,
                         row_damage_probe, roi_qp_plane, mb_qp_delta)
PLAIN_OPS_444 = StepOps(csc444_damage_plain, mb_encode_i444_plain,
                        mb_encode_p444_plain, cavlc_events444_plain,
                        pack_stream_plain, motion_select444_plain,
                        row_damage_probe_plain, roi_qp_plane_plain,
                        mb_qp_delta_plain)
#: the sets with K4's seat entry (``n_seats`` given): the shards of a
#: split frame (parallel/stripes.py, StripeShardedH264Session)
SEAT_KERNEL_OPS_444 = KERNEL_OPS_444._replace(pack_stream=pack_stream_seats)
SEAT_PLAIN_OPS_444 = PLAIN_OPS_444._replace(
    pack_stream=pack_stream_seats_plain)


def h264_encode_yuv444(yf, uf, vf, qp, header_pay, header_nb, e_cap: int,
                       w_cap: int, idr_pic_id=0, want_recon: bool = False,
                       device=None):
    """Same signature and output as the reference's 4:4:4 I encoder, run
    through the main path's kernels (K14 -> K16 -> K4). ``device``
    (None: the planes' device if they are tensors, else ``cuda``) is
    where it runs; ``"cpu"`` runs the plain versions."""
    (y, u, v), qp, hp, hn, idr = _frame_args(yf, uf, vf, qp, header_pay,
                                             header_nb, idr_pic_id, device)
    R = y.shape[0] // 16
    send = torch.ones((1,), dtype=torch.int32, device=y.device)
    ref = [torch.empty_like(p) for p in (y, u, v)]
    lv, cbp, hdr_pay, hdr_nb = mb_encode_i444(y, u, v, qp, send, R, *ref)
    ev_pay, ev_nb = cavlc_events444(lv, cbp, True)
    st = pack_stream(hdr_pay, hdr_nb, ev_pay, ev_nb, hp, hn, idr, qp, True,
                     e_cap, w_cap, R * w_cap * 4)
    out = H264FrameOut(st.words, st.total_bits, st.flags[0] != 0, R)
    return (out, tuple(ref)) if want_recon else out


def h264_encode_p_yuv444(yf, uf, vf, ref_y, ref_u, ref_v, qp, header_pay,
                         header_nb, frame_num, e_cap: int, w_cap: int,
                         candidates: tuple = ((0, 0),),
                         stripe_rows: int | None = None,
                         precomputed_motion=None, device=None):
    """The reference's 4:4:4 P encoder, through the main path's kernels:
    the K5 4:4:4 entry when ``candidates`` holds more than the zero
    vector (windows of ``16 * (stripe_rows or R)`` rows), then K15 ->
    K16 -> K4. ``precomputed_motion`` = (pred_y, pred_u, pred_v, mv)
    skips the search. The reference planes are copied, not updated.
    -> (H264FrameOut, (recon_y, recon_u, recon_v))."""
    return _encode_p_frame(KERNEL_OPS_444, yf, uf, vf, ref_y, ref_u, ref_v,
                           qp, header_pay, header_nb, frame_num, e_cap,
                           w_cap, candidates, stripe_rows, precomputed_motion,
                           None, device)
