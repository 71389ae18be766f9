"""Slot budgets, CAVLC event helpers and the scroll motion search.

The pieces of selkies_tpu/ops/h264_encode.py that ops/h264_planes.py
imports, in PyTorch: the static per-macroblock slot budgets, the level
clamp, the frame output tuple, the Exp-Golomb / level event builders,
the inter quantiser and the block-layout nC gathers. An event is a
(payload, nbits) pair with the codeword in the LOW ``nbits`` bits of the
payload; payloads are int64 here (uint32 has no shifts on the CPU).

It also holds the motion search of the P path: the scroll candidate set,
the MV lambda, and :func:`motion_select`, the wrapper of kernel K5
(csrc/motion_select.cu) beside its plain version
:func:`motion_select_plain`, with the 4:4:4 entry :func:`motion_select444`
(full-resolution chroma shifted like luma) beside
:func:`motion_select444_plain`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _cuda
from .h264_transform import _MF, _POS_CLS

# static per-MB slot budget: header 3, luma DC 36, 16 luma AC x 34,
# 2 chroma DC x 12, 8 chroma AC x 34 = 879
SLOTS_HDR = 3
SLOTS_BLK16 = 1 + 3 + 16 + 1 + 15          # coeff_token, signs, lvls, tz, runs
SLOTS_BLK15 = 1 + 3 + 15 + 1 + 14
SLOTS_BLK4 = 1 + 3 + 4 + 1 + 3
SLOTS_MB = SLOTS_HDR + SLOTS_BLK16 + 16 * SLOTS_BLK15 + 2 * SLOTS_BLK4 \
    + 8 * SLOTS_BLK15

P_SLOTS_HDR = 6                 # skip_run, mb_type, mvdx, mvdy, cbp, qp_delta
SLOTS_BLK16F = 1 + 3 + 16 + 1 + 15    # full 16-coeff luma block
P_SLOTS_MB = P_SLOTS_HDR + 16 * SLOTS_BLK16F + 2 * SLOTS_BLK4 \
    + 8 * SLOTS_BLK15

LEVEL_CLAMP = 2000   # keeps level_code under the prefix-15 escape and the
#                      dequant result inside the +-2^15 conformance bound


class H264FrameOut(NamedTuple):
    words: torch.Tensor       # (R, w_cap) int32 holding uint32 bit patterns
    total_bits: torch.Tensor  # (R,) int32 (includes the rbsp stop bit)
    overflow: torch.Tensor    # () bool
    mb_rows: int


def _bit_length(v: torch.Tensor) -> torch.Tensor:
    """Bit length of non-negative integers below 2^31."""
    pow2 = torch.tensor([1 << k for k in range(31)], dtype=torch.int64,
                        device=v.device)
    return torch.bucketize(v.to(torch.int64), pow2, right=True)


def _ue_event(v):
    """Exp-Golomb codeword as one event. v must be < 2^15."""
    code_num = torch.as_tensor(v).to(torch.int64) + 1
    return code_num, (2 * _bit_length(code_num) - 1).to(torch.int32)


def _se_event(v):
    """Signed Exp-Golomb codeword as one event."""
    v = torch.as_tensor(v).to(torch.int64)
    return _ue_event(torch.where(v > 0, 2 * v - 1, -2 * v))


def _level_event(level_code, suffix_len):
    """(payload, nbits) for one coeff level (§9.2.2.1 inverse). Produces
    prefix <= 15 forms only — levels are clamped upstream."""
    lc = level_code.to(torch.int64)
    sl = suffix_len.to(torch.int64)
    sl1 = torch.clamp(sl, min=1)
    # suffix_len == 0
    pay0 = torch.where(lc < 14, torch.ones_like(lc),
                       torch.where(lc < 30, (1 << 4) | (lc - 14),
                                   (1 << 12) | (lc - 30)))
    nb0 = torch.where(lc < 14, lc + 1,
                      torch.where(lc < 30, torch.full_like(lc, 19),
                                  torch.full_like(lc, 28)))
    # suffix_len > 0
    prefix = lc >> sl1
    in_range = prefix < 15
    suffix = lc & ((torch.ones_like(sl1) << sl1) - 1)
    pay_s = torch.where(in_range, (torch.ones_like(sl) << sl) | suffix,
                        (1 << 12) | (lc - 15 * (torch.ones_like(sl1) << sl1)))
    nb_s = torch.where(in_range, prefix + 1 + sl, torch.full_like(lc, 28))
    pay = torch.where(sl == 0, pay0, pay_s)
    nb = torch.where(sl == 0, nb0, nb_s)
    return pay, nb.to(torch.int32)


def _quant_ac_inter(w, qp):
    """Inter rounding offset f/6 (JM): ``w`` (..., 4, 4), ``qp`` (...)."""
    qp = torch.as_tensor(qp).to(torch.int64)
    mf4 = torch.as_tensor(_MF[:, _POS_CLS], device=w.device).to(torch.int64)
    qbits = 15 + qp // 6
    mf = mf4[qp % 6]
    f = (torch.ones_like(qbits) << qbits) // 6
    w = w.to(torch.int64)
    mag = (w.abs() * mf + f[..., None, None]) >> qbits[..., None, None]
    return torch.clamp(torch.where(w < 0, -mag, mag), -LEVEL_CLAMP,
                       LEVEL_CLAMP)


def _pad_left(x, dim):
    """Shift ``x`` one step along ``dim`` (towards higher indices), zero in."""
    pad = torch.zeros_like(x.narrow(dim, 0, 1))
    return torch.cat([pad, x.narrow(dim, 0, x.shape[dim] - 1)], dim)


def _nc_combine(na, nb_, a_avail, b_avail):
    both = a_avail & b_avail
    return torch.where(both, (na + nb_ + 1) >> 1,
                       torch.where(a_avail, na,
                                   torch.where(b_avail, nb_,
                                               torch.zeros_like(na))))


def _nc_from_counts(tc_eff):
    """nC context gather for (R, M, by, bx)-shaped per-block counts."""
    shp = tc_eff.shape
    dev = tc_eff.device
    bx = torch.arange(shp[3], device=dev).view(1, 1, 1, -1).expand(shp)
    mb = torch.arange(shp[1], device=dev).view(1, -1, 1, 1).expand(shp)
    by = torch.arange(shp[2], device=dev).view(1, 1, -1, 1).expand(shp)
    left_in = _pad_left(tc_eff, 3)
    left_mb = _pad_left(tc_eff[..., 3], 1)
    na = torch.where(bx == 0, left_mb[..., None], left_in)
    up_in = _pad_left(tc_eff, 2)
    return _nc_combine(na, up_in, (bx > 0) | (mb > 0), by > 0)


def _nc_from_counts_chroma(tc_eff):
    """(R, comp, M, by2, bx2) chroma variant."""
    shp = tc_eff.shape
    dev = tc_eff.device
    bx = torch.arange(shp[4], device=dev).view(1, 1, 1, 1, -1).expand(shp)
    by = torch.arange(shp[3], device=dev).view(1, 1, 1, -1, 1).expand(shp)
    mb = torch.arange(shp[2], device=dev).view(1, 1, -1, 1, 1).expand(shp)
    left_in = _pad_left(tc_eff, 4)
    left_mb = _pad_left(tc_eff[..., 1], 2)
    na = torch.where(bx == 0, left_mb[..., None], left_in)
    up_in = _pad_left(tc_eff, 3)
    return _nc_combine(na, up_in, (bx > 0) | (mb > 0), by > 0)


# ---------------------------------------------------------------------------
# motion search (K5): full-pel scroll candidates, SAD + lambda * mv bits
# ---------------------------------------------------------------------------

# lagrangian for SAD-vs-mvd-bits mode cost, ~2^((qp-12)/6) (x264's SAD
# lambda curve); integer so device and host selection agree exactly
MV_LAMBDA_NP = np.round(2.0 ** ((np.arange(52) - 12) / 6.0)).astype(np.int32)

#: most candidates, and the largest |dy| / |dx|, K5 takes
MAX_CANDIDATES = 128
MAX_SHIFT = 64


def se_bits(v: int) -> int:
    """Host-side exact bit cost of se(v)."""
    cn = 2 * v - 1 if v > 0 else -2 * v
    return 2 * (cn + 1).bit_length() - 1


def scroll_candidates(vrange: int = 24, hrange: int = 8) -> tuple:
    """Static MV candidate set for desktop content: zero MV, every
    vertical scroll offset up to ``vrange``, power-of-two horizontal pans
    up to ``hrange``. (dy, dx) full-pel; (0, 0) first so ties prefer the
    skip-eligible zero vector."""
    c = [(0, 0)]
    for d in range(1, vrange + 1):
        c += [(d, 0), (-d, 0)]
    d = 1
    while d <= hrange:
        c += [(0, d), (0, -d)]
        d *= 2
    return tuple(c)


def _hshift(p, dx: int):
    """Horizontal shift with edge clamp (picture width is shared)."""
    if dx == 0:
        return p
    idx = torch.as_tensor(np.clip(np.arange(p.shape[-1]) + dx, 0,
                                  p.shape[-1] - 1), device=p.device)
    return p[..., idx]


def _sad_mb16(diff):
    """(H, W) absolute differences -> (R, M) per-16x16-MB sums."""
    H, W = diff.shape
    return diff.reshape(H // 16, 16, W // 16, 16).sum((1, 3))


def _motion_select_plain(cur_y, ry, ru, rv, qp_rows, candidates, win: int,
                         out, full_chroma: bool):
    """K5's search with the reference planes given as the (n, band + 2 *
    halo, W) bands of n shards of the frame's rows, band s holding frame
    rows ``s * band - halo`` onwards (K5 itself: one band, no halo, which
    is the planes; split frames: parallel/stripes.py). Candidate (dy, dx)
    of frame row g reads row ``clip(g + dy, wb, wb + win - 1)`` (``wb``
    the first row of g's ``win``-row window: the decoder of a stripe
    stream clamps at its own picture bound), found in g's band;
    horizontal shifts clamp at the picture width. 4:2:0 chroma is the
    eighth-sample bilinear of the half-pel chroma vector (a 2- or 4-tap
    rounding average) on chroma rows and windows of ``win / 2``; ``>>``
    and ``&`` on Python ints floor, so dy = -3 gives by = -2, fy = 1.
    4:4:4 chroma rides the luma's full-pel shift."""
    H, W = cur_y.shape
    dev = cur_y.device
    cdiv = 1 if full_chroma else 2
    n = ry.shape[0]
    band = H // n

    def shifted(p, dy: int, dx: int, c: int):
        """plane p's bands shifted by (dy, dx), rows of 1/c resolution."""
        h, rows = H // c, band // c
        halo = (p.shape[1] - rows) // 2
        g = np.arange(h)
        s, wb = g // rows, g // (win // c) * (win // c)
        idx = np.clip(g + dy, wb, wb + win // c - 1) - s * rows + halo
        if idx.min() < 0 or idx.max() >= p.shape[1]:
            raise AssertionError("a candidate read outside its halo band")
        rows_at = torch.as_tensor(s * p.shape[1] + idx, device=dev)
        return _hshift(p.reshape(-1, p.shape[-1])[rows_at], dx)

    def chroma(p, dy: int, dx: int):
        if full_chroma:
            return shifted(p, dy, dx, 1)
        by, fy, bx, fx = dy >> 1, dy & 1, dx >> 1, dx & 1

        def s_c(a, b):
            return shifted(p, a, b, 2)
        if not fy and not fx:
            return s_c(by, bx)
        if fy and not fx:
            return (s_c(by, bx) + s_c(by + 1, bx) + 1) >> 1
        if fx and not fy:
            return (s_c(by, bx) + s_c(by, bx + 1) + 1) >> 1
        return (s_c(by, bx) + s_c(by + 1, bx) + s_c(by, bx + 1)
                + s_c(by + 1, bx + 1) + 2) >> 2

    ry, ru, rv = (p.to(torch.int32) for p in (ry, ru, rv))
    cur = cur_y.to(torch.int32)
    # argmin (first index on ties) over SAD(luma) + lambda(qp_row) *
    # (se_bits(4dx) + se_bits(4dy))
    lam = torch.as_tensor(MV_LAMBDA_NP, device=dev)[
        torch.clamp(qp_rows.to(torch.int64), 0, 51)]           # (R,)
    sel = torch.argmin(torch.stack(
        [_sad_mb16((cur - shifted(ry, dy, dx, 1)).abs())
         + lam[:, None] * (se_bits(4 * dx) + se_bits(4 * dy))
         for dy, dx in candidates]), 0)                         # (R, M)
    sel_y = sel.repeat_interleave(16, 0).repeat_interleave(16, 1)
    sel_c = sel.repeat_interleave(16 // cdiv, 0).repeat_interleave(
        16 // cdiv, 1)
    cshape = (H // cdiv, W // cdiv)
    pred_y = torch.zeros((H, W), dtype=torch.int32, device=dev)
    pred_u = torch.zeros(cshape, dtype=torch.int32, device=dev)
    pred_v = torch.zeros_like(pred_u)
    for k, (dy, dx) in enumerate(candidates):
        pred_y = torch.where(sel_y == k, shifted(ry, dy, dx, 1), pred_y)
        pred_u = torch.where(sel_c == k, chroma(ru, dy, dx), pred_u)
        pred_v = torch.where(sel_c == k, chroma(rv, dy, dx), pred_v)
    cand_q = torch.as_tensor(np.asarray(candidates, np.int32)[:, ::-1] * 4,
                             device=dev)
    res = (pred_y.to(torch.uint8), pred_u.to(torch.uint8),
           pred_v.to(torch.uint8), cand_q[sel].contiguous())
    if out is None:
        return res
    for o, r in zip(out, res):
        o.copy_(r)
    return tuple(out)


def motion_select_plain(cur_y, ref_y, ref_u, ref_v, qp_rows, candidates,
                        win: int, out=None):
    """Pick one candidate MV per macroblock: argmin (first index on ties)
    over SAD(luma) + lambda(qp_row) * (se_bits(4dx) + se_bits(4dy)).
    Vertical shifts clamp inside ``win``-row windows (the stripe), and
    horizontal ones at the picture width. -> (pred_y, pred_u, pred_v)
    uint8 and the (R, M, 2) int32 quarter-pel (mvx, mvy) field, copied
    into ``out`` when it is given."""
    return _motion_select_plain(cur_y, ref_y[None], ref_u[None],
                                ref_v[None], qp_rows, candidates, win, out,
                                False)


def motion_select444_plain(cur_y, ref_y, ref_u, ref_v, qp_rows, candidates,
                           win: int, out=None):
    """The 4:4:4 search (the reference's ``_motion_select444``): the same
    luma-SAD choice as :func:`motion_select_plain`, but the full-
    resolution chroma planes ride the luma's full-pel shift, with the
    luma's window and width clamps (no eighth-sample interpolation)."""
    return _motion_select_plain(cur_y, ref_y[None], ref_u[None],
                                ref_v[None], qp_rows, candidates, win, out,
                                True)


def candidate_table(candidates) -> torch.Tensor:
    """(K, 2) int32 (dy, dx) host table that K5 reads while it is
    launched (it travels as a kernel argument, not as device memory)."""
    c = np.asarray(candidates, np.int32).reshape(-1, 2)
    if not 1 <= len(c) <= MAX_CANDIDATES or np.abs(c).max() > MAX_SHIFT:
        raise ValueError(f"K5 takes 1..{MAX_CANDIDATES} candidates with "
                         f"|dy|, |dx| <= {MAX_SHIFT}")
    return torch.from_numpy(np.ascontiguousarray(c))


def _motion_select(entry, plain, cdiv, cur_y, ref_y, ref_u, ref_v,
                   qp_rows, candidates, win, out):
    H, W = cur_y.shape
    R, M = H // 16, W // 16
    dev = cur_y.device
    if H % 16 or W % 16 or win % 16 or H % win:
        raise ValueError("planes must tile into MBs and ``win``-row windows")
    cshape = (H // cdiv, W // cdiv)
    for t, n, shp in ((cur_y, "cur_y", (H, W)), (ref_y, "ref_y", (H, W)),
                      (ref_u, "ref_u", cshape), (ref_v, "ref_v", cshape)):
        _check(t, n, torch.uint8, shp, dev)
    _check(qp_rows, "qp_rows", torch.int32, (R,), dev)
    table = candidate_table(candidates)
    if _on_cpu(cur_y):
        return plain(cur_y, ref_y, ref_u, ref_v, qp_rows, candidates, win,
                     out)
    if out is None:
        out = (torch.empty((H, W), dtype=torch.uint8, device=dev),
               torch.empty(cshape, dtype=torch.uint8, device=dev),
               torch.empty(cshape, dtype=torch.uint8, device=dev),
               torch.empty((R, M, 2), dtype=torch.int32, device=dev))
    for t, n, dt, shp in zip(out, ("pred_y", "pred_u", "pred_v", "mv"),
                             (torch.uint8,) * 3 + (torch.int32,),
                             ((H, W), cshape, cshape, (R, M, 2))):
        _check(t, n, dt, shp, dev)
    _cuda.launch(entry, cur_y, ref_y, ref_u, ref_v, qp_rows, table,
                 len(table), H, W, win, *out)
    return tuple(out)


def motion_select(cur_y, ref_y, ref_u, ref_v, qp_rows, candidates,
                  win: int, out=None):
    """K5 (csrc/motion_select.cu) for CUDA tensors, else
    :func:`motion_select_plain`; same contract. ``out`` = (pred_y,
    pred_u, pred_v, mv) preallocated outputs (the session's scratch); the
    prediction never lands in the reference planes, which the P coder
    rewrites afterwards."""
    return _motion_select("motion_select", motion_select_plain, 2, cur_y,
                          ref_y, ref_u, ref_v, qp_rows, candidates, win, out)


def motion_select444(cur_y, ref_y, ref_u, ref_v, qp_rows, candidates,
                     win: int, out=None):
    """K5's 4:4:4 entry (csrc/motion_select.cu:motion_select444) for CUDA
    tensors, else :func:`motion_select444_plain`: chroma planes and their
    predictions are full resolution; otherwise as :func:`motion_select`."""
    return _motion_select("motion_select444", motion_select444_plain, 1,
                          cur_y, ref_y, ref_u, ref_v, qp_rows, candidates,
                          win, out)


def _on_cpu(t) -> bool:
    """True for a CPU tensor (plain version); False for CUDA (kernel)."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return False


def _check(t, name, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
