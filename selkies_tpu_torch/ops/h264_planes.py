"""Plane-layout H.264 4:2:0 encode in PyTorch, and its CUDA kernels.

The counterpart of selkies_tpu/ops/h264_planes.py for the 4:2:0 session
(Intra_16x16 IDR frames and P frames with scroll motion, one slice per
MB row). Two layers live here:

1. The reference's plane functions as plain PyTorch, same names and
   layouts (``fwd4_planes``, ``_quant_plane``, ``_dc_scan``,
   ``cavlc_events_planes``, ``_EventSink`` ...). They are exact integer
   ports; the tests hold each one equal to its JAX original.
2. The kernels of the session's main path, each a wrapper that
   launches a hand-written CUDA kernel for a CUDA tensor and runs its
   plain version (built from layer 1) for a CPU tensor:

   ========================  ===========================================
   ``csc420_damage`` (K1)    RGB -> Y/U/V 4:2:0, per-stripe damage flags,
                             ``prev`` updated in place
   ``mb_encode_i`` /         per-MB transforms, quant, dequant, recon
   ``mb_encode_p`` (K2)      (send-gated, into the reference planes in
                             place), level blocks, MB header events (P:
                             residual against K5's prediction, se(mvd);
                             with a per-MB QP plane, ROI QP)
   ``cavlc_events`` (K3)     per-block CAVLC (payload, nbits) slots
   ``pack_stream`` (K4)      row bit layout, u32 words, bytes, the one
                             ragged byte buffer and both overflow flags
   ``motion_select`` (K5)    in ops/h264_encode.py: scroll motion search
   ``row_damage_probe`` (K6) per-MB-row damage flags of the band path
   ``roi_qp_plane`` (K17)    ROI QP: per-MB damage of a band -> the
                             per-MB QP plane K2-P codes at
   ``mb_qp_delta`` (K18)     ROI QP: the mb_qp_delta carry chain, into
                             header slot 5 of K2-P's coded MBs
   ========================  ===========================================

Kernel layouts (R MB rows, M MB columns):

- ``lv`` (R, M, 27, 16) int16: 27 coefficient blocks per MB in coding
  order, each holding the levels CAVLC codes, in scan order:
  block 0 = luma DC (I frames; zeros in P), 1..16 = the 16 luma blocks in
  8x8-quadrant order (``_SCAN_ORDER``; 15 AC levels in I, 16 in P),
  17/18 = Cb/Cr DC (4 levels), 19..22 / 23..26 = Cb/Cr AC blocks raster
  (15 levels). Unused tail positions are zero.
- ``cbp`` (R, M) int32: coded_block_pattern (luma bits 0..3 | chroma<<4).
- ``hdr_pay``/``hdr_nb`` (R, M, 6) int32: MB header events (I: mb_type,
  pred mode, qp delta; P: skip run — filled by the packer —, mb_type,
  mvd x/y, cbp, qp delta: ue(0), rewritten by K18 under ROI QP).
- ``qp_mb`` (R, M) int32: ROI QP's per-MB QP plane (K17 out, K2-P and
  K18 in).
- ``ev_pay`` int32 / ``ev_nb`` uint8 (R, M, SB): every block's CAVLC
  slots back to back in bitstream order (SB = 876 for I, 872 for P;
  ops/h264_planes444.py has the 4:4:4 layouts, which K4 packs too); a
  block's slots follow ``cavlc_events_planes``: [coeff_token, 3 signs,
  mc levels, total_zeros, mc-1 runs]. Payloads are zero where nbits is.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from ..codecs import h264_tables as HT
from . import _cuda
from .colorspace import rgb_to_ycbcr
from .h264_encode import (H264FrameOut, LEVEL_CLAMP, P_SLOTS_MB, SLOTS_MB,
                          _check, _level_event, _on_cpu, _se_event,
                          _ue_event, motion_select, motion_select_plain)
from .h264_transform import _MF, _POS_CLS, _QPC, _V, ZIGZAG4
from .stripes import concat_stripe_bytes, words_to_bytes_device

I64 = torch.int64

# ---------------------------------------------------------------------------
# tables (packed len<<16 | code so every VLC lookup is ONE index)
# ---------------------------------------------------------------------------


def _pack_tab(len_np, code_np):
    return ((len_np.astype(np.int64) << 16)
            | code_np.astype(np.int64)).reshape(-1)


_CT_PACK = _pack_tab(HT.CT_LEN_NP, HT.CT_CODE_NP)          # 4*4*17
_CDC_PACK = _pack_tab(HT.CT_CDC_LEN_NP, HT.CT_CDC_CODE_NP)
_TZ_PACK = _pack_tab(HT.TZ_LEN_NP, HT.TZ_CODE_NP)          # 15*16
_TZC_PACK = _pack_tab(HT.TZ_CDC_LEN_NP, HT.TZ_CDC_CODE_NP)
_RB_PACK = _pack_tab(HT.RB_LEN_NP, HT.RB_CODE_NP)          # 7*15
_ZZ_IJ = [(int(z) // 4, int(z) % 4) for z in ZIGZAG4]      # scan pos -> (i,j)

_SCAN_ORDER = ((0, 0), (0, 1), (1, 0), (1, 1), (0, 2), (0, 3), (1, 2),
               (1, 3), (2, 0), (2, 1), (3, 0), (3, 1), (2, 2), (2, 3),
               (3, 2), (3, 3))
#: luma block raster index (by*4+bx) of each coding position
_SCAN_RASTER = [by * 4 + bx for by, bx in _SCAN_ORDER]

#: kernel layout constants (module docstring)
N_BLOCKS = 27
HDR_SLOTS = 6
SB_I = SLOTS_MB - 3            # 876 block slots per MB, I frames
SB_P = P_SLOTS_MB - 6          # 872 block slots per MB, P frames


def _t(a, device):
    if isinstance(a, np.ndarray) and not a.flags.writeable:
        a = a.copy()
    return torch.as_tensor(a, device=device).to(I64)


def _lut(packed, idx):
    """packed (T,) len<<16|code; idx any-shape -> (pay int64, nb int32)."""
    v = _t(packed, idx.device)[idx]
    return v & 0xFFFF, (v >> 16).to(torch.int32)


# ---------------------------------------------------------------------------
# plane transforms (stride-4 slices + butterflies; exact integers)
# ---------------------------------------------------------------------------

def fwd4_planes(x):
    """(H, W) int -> 4x4 nested list of (H/4, W/4) coefficient planes:
    out[i][j] = (Cf X Cf^T)[i, j] of every 4x4 block."""
    x = x.to(I64)
    x0, x1, x2, x3 = x[0::4, :], x[1::4, :], x[2::4, :], x[3::4, :]
    s0, s1, d0, d1 = x0 + x3, x1 + x2, x0 - x3, x1 - x2
    rows = (s0 + s1, 2 * d0 + d1, s0 - s1, d0 - 2 * d1)
    out = [[None] * 4 for _ in range(4)]
    for i, r in enumerate(rows):
        c0, c1, c2, c3 = r[:, 0::4], r[:, 1::4], r[:, 2::4], r[:, 3::4]
        s0, s1, d0, d1 = c0 + c3, c1 + c2, c0 - c3, c1 - c2
        out[i] = [s0 + s1, 2 * d0 + d1, s0 - s1, d0 - 2 * d1]
    return out


def inv4_planes(d):
    """Spec 8.5.12.2 inverse (horizontal first, >>1 truncations exact)
    WITHOUT the final (x+32)>>6. d and result are 4x4 plane lists."""
    f = [None] * 4
    for i in range(4):
        e0 = d[i][0] + d[i][2]
        e1 = d[i][0] - d[i][2]
        e2 = (d[i][1] >> 1) - d[i][3]
        e3 = d[i][1] + (d[i][3] >> 1)
        f[i] = [e0 + e3, e1 + e2, e1 - e2, e0 - e3]
    out = [[None] * 4 for _ in range(4)]
    for j in range(4):
        g0 = f[0][j] + f[2][j]
        g1 = f[0][j] - f[2][j]
        g2 = (f[1][j] >> 1) - f[3][j]
        g3 = f[1][j] + (f[3][j] >> 1)
        out[0][j], out[1][j] = g0 + g3, g1 + g2
        out[2][j], out[3][j] = g1 - g2, g0 - g3
    return out


def _clip1(x):
    return torch.clamp(x, 0, 255)


def _merge_planes(planes, bh: int, bw: int):
    """bh x bw nested plane list (h, w) -> interleaved (h*bh, w*bw)."""
    h, w = planes[0][0].shape
    rows = [torch.stack(planes[i], dim=-1).reshape(h, w * bw)
            for i in range(bh)]
    return torch.stack(rows, dim=1).reshape(h * bh, w * bw)


def _had4(x):
    """H4 . X . H4 over the last two dims (H4 is symmetric)."""
    def rows(a, dim):
        a0, a1, a2, a3 = (a.select(dim, k) for k in range(4))
        return torch.stack([a0 + a1 + a2 + a3, a0 + a1 - a2 - a3,
                            a0 - a1 - a2 + a3, a0 - a1 + a2 - a3], dim=dim)
    return rows(rows(x, x.dim() - 2), x.dim() - 1)


def _had2_parts(x00, x01, x10, x11):
    a, b = x00 + x01, x00 - x01
    c, d = x10 + x11, x10 - x11
    return a + c, b + d, a - c, b - d


def _had2(x):
    """H2 X H2 over the last two (2, 2) dims."""
    a, b, c, d = _had2_parts(x[..., 0, 0], x[..., 0, 1],
                             x[..., 1, 0], x[..., 1, 1])
    return torch.stack([torch.stack([a, b], -1), torch.stack([c, d], -1)],
                       -2)


def _expand(p, fy: int, fx: int):
    """(R, M)-ish plane -> block grid by repeating fy x fx."""
    return p.repeat_interleave(fy, dim=0).repeat_interleave(fx, dim=1)


# ---------------------------------------------------------------------------
# quant / dequant on planes (qp broadcastable to the plane shape)
# ---------------------------------------------------------------------------

def _quant_plane(w, qp, cls: int, fdiv: int):
    """level = clamp(sign * ((|w| * MF[qp%6, cls] + (1<<qbits)//fdiv)
    >> qbits)); fdiv=3 intra, 6 inter."""
    qp = _t(qp, w.device)
    qbits = 15 + qp // 6
    mf = _t(_MF, w.device)[qp % 6, cls]
    f = (torch.ones_like(qbits) << qbits) // fdiv
    mag = (w.abs() * mf + f) >> qbits
    return torch.clamp(torch.where(w < 0, -mag, mag), -LEVEL_CLAMP,
                       LEVEL_CLAMP)


def _dequant_plane(c, qp, cls: int):
    """Spec 8.5.12.1 AC rescale, elementwise (left shifts as exact
    multiplies: the levels may be negative)."""
    qp = _t(qp, c.device)
    ls = 16 * _t(_V, c.device)[qp % 6, cls]
    t = qp // 6
    one = torch.ones_like(t)
    hi = c * ls * (one << torch.clamp(t - 4, min=0))
    lo = (c * ls + (one << torch.clamp(3 - t, min=0))) \
        >> torch.clamp(4 - t, min=0)
    return torch.where(t >= 4, hi, lo)


def _quant_dc_e(y, qp):
    qp = _t(qp, y.device)
    qbits = 15 + qp // 6
    mf00 = _t(_MF, y.device)[qp % 6, 0]
    f2 = 2 * ((torch.ones_like(qbits) << qbits) // 3)
    mag = (y.abs() * mf00 + f2) >> (qbits + 1)
    return torch.clamp(torch.where(y < 0, -mag, mag), -LEVEL_CLAMP,
                       LEVEL_CLAMP)


def _dequant_ldc_e(f, qp):
    qp = _t(qp, f.device)
    ls00 = 16 * _t(_V, f.device)[qp % 6, 0]
    t = qp // 6
    one = torch.ones_like(t)
    hi = f * ls00 * (one << torch.clamp(t - 6, min=0))
    lo = (f * ls00 + (one << torch.clamp(5 - t, min=0))) \
        >> torch.clamp(6 - t, min=0)
    return torch.where(t >= 6, hi, lo)


def _dequant_cdc_e(f, qpc):
    qpc = _t(qpc, f.device)
    ls00 = 16 * _t(_V, f.device)[qpc % 6, 0]
    return (f * ls00 * (torch.ones_like(qpc) << (qpc // 6))) >> 5


# ---------------------------------------------------------------------------
# CAVLC over block-grid planes
# ---------------------------------------------------------------------------

def cavlc_events_planes(scan, nc, chroma_dc: bool = False):
    """``scan``: stacked (mc, ...) levels in scan order (a list of planes
    is stacked on entry). ``nc``: context plane (ignored for chroma_dc).
    Returns (pay (S, ...) int64, nb (S, ...) int32, tc plane) with the
    slot layout [coeff_token, 3 signs, mc levels, total_zeros, mc-1 runs].
    The two sequential slot chains (level suffix_len, run_before
    zeros_left) are Python loops over the slot index, as the reference's
    lax.scans are."""
    if isinstance(scan, (list, tuple)):
        scan = torch.stack(scan)
    scan = scan.to(I64)
    dev = scan.device
    mc = scan.shape[0]
    nz = scan != 0
    nzi = nz.to(I64)
    tc = nzi.sum(0)
    zero = torch.zeros((), dtype=I64, device=dev)

    # coding order (nonzeros by descending position) via suffix ranks
    rank = torch.flip(torch.cumsum(torch.flip(nzi, [0]), 0), [0]) - nzi
    kb = torch.arange(mc, dtype=I64, device=dev).reshape(
        (mc,) + (1,) * (scan.dim() - 1))
    oh = (rank[None] == kb[:, None]) & nz[None]      # (i, k, ...)
    lv = torch.where(oh, scan[None], zero).sum(1)
    pv = torch.where(oh, kb[None, :], zero).sum(1)

    # trailing ones: run of initial |1| values, capped at 3
    runmask = torch.cumprod((lv.abs() == 1).to(I64), 0)
    t1 = torch.clamp((runmask * (kb < tc[None])).sum(0), max=3)

    # --- coeff_token
    if chroma_dc:
        ct_pay, ct_nb = _lut(_CDC_PACK, t1 * 5 + tc)
    else:
        nc = _t(nc, dev)
        ctx = torch.where(nc < 2, 0, torch.where(nc < 4, 1,
                          torch.where(nc < 8, 2, 3)))
        ct_pay, ct_nb = _lut(_CT_PACK, (ctx * 4 + t1) * 17 + tc)

    # --- trailing one signs
    sign_pay = (lv[:3] < 0).to(I64)
    sign_nb = torch.where(kb[:3] < t1[None], 1, 0).to(torch.int32)

    # --- levels: loop over coded index j carrying suffix_len
    lv_pad = torch.cat([lv, torch.zeros((3,) + lv.shape[1:], dtype=I64,
                                        device=dev)], 0)
    suffix_len = torch.where((tc > 10) & (t1 < 3), 1, 0).to(I64)
    lvl_pay, lvl_nb = [], []
    for j in range(mc):
        win = lv_pad[j:j + 4]
        level = torch.where(t1 == 0, win[0],
                            torch.where(t1 == 1, win[1],
                                        torch.where(t1 == 2, win[2], win[3])))
        active = (t1 + j) < tc
        level_code = torch.where(level > 0, 2 * level - 2, -2 * level - 1)
        if j == 0:
            level_code = torch.where(t1 < 3, level_code - 2, level_code)
        p, n = _level_event(level_code, suffix_len)
        new_sl = torch.clamp(suffix_len, min=1)
        thresh = 3 * (torch.ones_like(new_sl)
                      << torch.clamp(new_sl - 1, min=0))
        new_sl = torch.where((level.abs() > thresh) & (new_sl < 6),
                             new_sl + 1, new_sl)
        suffix_len = torch.where(active, new_sl, suffix_len)
        lvl_pay.append(torch.where(active, p, zero))
        lvl_nb.append(torch.where(active, n, 0).to(torch.int32))

    # --- total_zeros
    last_pos = pv[0]
    tz = torch.where(tc > 0, last_pos + 1 - tc, zero)
    if chroma_dc:
        tz_pay, tz_nb = _lut(_TZC_PACK, torch.clamp(tc - 1, 0, 2) * 4
                             + torch.clamp(tz, 0, 3))
    else:
        tz_pay, tz_nb = _lut(_TZ_PACK, torch.clamp(tc - 1, 0, 14) * 16
                             + torch.clamp(tz, 0, 15))
    tz_active = (tc > 0) & (tc < mc)
    tz_pay = torch.where(tz_active, tz_pay, zero)
    tz_nb = torch.where(tz_active, tz_nb, 0).to(torch.int32)

    # --- run_before: loop over coded index carrying zeros_left
    pv_pad = torch.cat([pv, torch.zeros((1,) + pv.shape[1:], dtype=I64,
                                        device=dev)], 0)
    zeros_left = tz
    rb_pay, rb_nb = [], []
    for i in range(mc - 1):
        active = (i < tc - 1) & (zeros_left > 0)
        run = torch.clamp(pv_pad[i] - pv_pad[i + 1] - 1, 0, 14)
        zl = torch.clamp(torch.clamp(zeros_left, max=7) - 1, 0, 6)
        p, n = _lut(_RB_PACK, zl * 15 + run)
        rb_pay.append(torch.where(active, p, zero))
        rb_nb.append(torch.where(active, n, 0).to(torch.int32))
        zeros_left = torch.where(i < tc - 1, zeros_left - run, zeros_left)

    pay = torch.stack([ct_pay, *sign_pay, *lvl_pay, tz_pay, *rb_pay])
    nb = torch.stack([ct_nb, *sign_nb, *lvl_nb, tz_nb, *rb_nb])
    return pay, nb, tc


def _nc_planes(tc_eff, mb_bw: int):
    """nC context per block on an (nby, nbx) grid where each MB spans
    ``mb_bw`` block columns/rows. Left neighbour is grid col-1; top is
    grid row-1 but only WITHIN the MB (one slice per MB row: blocks of
    the MB row above are in another slice, hence unavailable)."""
    nby, nbx = tc_eff.shape
    dev = tc_eff.device
    col = torch.arange(nbx, device=dev)[None, :]
    row = torch.arange(nby, device=dev)[:, None]
    zc = torch.zeros_like(tc_eff[:, :1])
    zr = torch.zeros_like(tc_eff[:1, :])
    na = torch.cat([zc, tc_eff[:, :-1]], 1)
    nb_ = torch.cat([zr, tc_eff[:-1, :]], 0)
    a_avail = (col > 0).expand(nby, nbx)
    b_avail = ((row % mb_bw) > 0).expand(nby, nbx)
    both = a_avail & b_avail
    return torch.where(both, (na + nb_ + 1) >> 1,
                       torch.where(a_avail, na,
                                   torch.where(b_avail, nb_,
                                               torch.zeros_like(na))))


# ---------------------------------------------------------------------------
# event sink: every slot class appends (row, [mb,] offset, payload, nbits)
# tensors with PER-MB-RELATIVE bit offsets (prefix events relative to the
# row start, tail events to the MB body end); pack() places them with ONE
# pair of scatter-adds into the (R, w_cap) word array.
# ---------------------------------------------------------------------------

class _EventSink:
    def __init__(self, R: int, M: int, w_cap: int):
        self.R, self.M, self.w_cap = R, M, w_cap
        self.prefix_items = []   # (row, off-in-row, pay, nb)
        self.mb_items = []       # (row, mb, off-in-mb, pay, nb)
        self.tail_items = []     # (row, off-past-body, pay, nb)
        self._prefix_bits = None
        self._mb_bits = None
        self._tail_bits = None

    @staticmethod
    def _flat(*args):
        return [a.reshape(-1) for a in torch.broadcast_tensors(
            *(torch.as_tensor(a).to(I64) for a in args))]

    def add_prefix(self, row, off, pay, nb):
        """Row-prefix events; ``off`` is relative to the ROW start."""
        self.prefix_items.append(tuple(self._flat(row, off, pay, nb)))

    def add_mb(self, row, mb, off, pay, nb):
        """MB-body events; ``off`` is relative to THAT MB's start."""
        self.mb_items.append(tuple(self._flat(row, mb, off, pay, nb)))

    def add_tail(self, row, off, pay, nb):
        """Row-tail events; ``off`` is relative to the MB body END."""
        self.tail_items.append(tuple(self._flat(row, off, pay, nb)))

    def set_layout(self, prefix_bits, mb_bits, tail_bits):
        """Per-row prefix bits (R,), per-MB body bits (R, M), per-row
        tail bits (R,) — the only global knowledge pack() needs."""
        self._prefix_bits = prefix_bits.to(I64)
        self._mb_bits = mb_bits.to(I64)
        self._tail_bits = tail_bits.to(I64)

    def _resolved(self, mb_start, body_end):
        """Every item as (row, absolute-off-in-row, pay, nb)."""
        out = list(self.prefix_items)
        for (r, m, o, p, n) in self.mb_items:
            out.append((r, mb_start[r, m] + o, p, n))
        for (r, o, p, n) in self.tail_items:
            out.append((r, body_end[r] + o, p, n))
        return out

    def _pack_scatter(self, mb_start, body_end):
        """Disjoint bit ranges placed by scatter-ADD (as the reference
        does, so an overflowing row's spill into the next row's words sums
        the same way); int64 words masked to 32 bits at the end."""
        R, w_cap = self.R, self.w_cap
        items = self._resolved(mb_start, body_end)
        row, off, pay, nb = (torch.cat([it[k] for it in items])
                             for k in range(4))
        goff = row * (w_cap * 32) + off
        active = nb > 0
        rel = goff & 31
        sh = 32 - (rel + nb)
        pay = torch.where(active, pay, 0)
        hi = torch.where(sh >= 0, pay << torch.clamp(sh, 0, 31),
                         pay >> torch.clamp(-sh, 0, 31)) & 0xFFFFFFFF
        hi = torch.where(active, hi, 0)
        lo = torch.where((sh < 0) & active,
                         (pay << torch.clamp(32 + sh, 0, 31)) & 0xFFFFFFFF,
                         0)
        n_words = R * w_cap
        w0 = goff >> 5
        w0_t = torch.where(active & (w0 < n_words), w0, n_words)
        w1_t = torch.where(active & (sh < 0) & (w0 + 1 < n_words), w0 + 1,
                           n_words)
        words = torch.zeros(n_words + 1, dtype=I64, device=pay.device)
        words.index_add_(0, w0_t, hi)
        words.index_add_(0, w1_t, lo)
        return _to_u32_bits(words[:n_words] & 0xFFFFFFFF).reshape(R, w_cap)

    def pack(self):
        """-> (words (R, w_cap) int32 u32-bits, n_events (R,) int32,
        total_bits (R,) int32)."""
        if self._mb_bits is None:
            raise RuntimeError("set_layout() before pack()")
        prefix_bits = self._prefix_bits
        mb_bits = self._mb_bits
        mb_start = prefix_bits[:, None] + torch.cumsum(mb_bits, 1) - mb_bits
        body_end = prefix_bits + mb_bits.sum(1)
        total_bits = body_end + self._tail_bits
        words = self._pack_scatter(mb_start, body_end)
        n_ev = torch.zeros(self.R, dtype=I64, device=words.device)
        for items in (self.prefix_items, self.tail_items, self.mb_items):
            for it in items:
                n_ev.index_add_(0, it[0], (it[-1] > 0).to(I64))
        return words, n_ev.to(torch.int32), total_bits.to(torch.int32)


def _to_u32_bits(w):
    """int64 values in [0, 2^32) -> int32 tensor with the same 32 bits."""
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)


# ---------------------------------------------------------------------------
# shared frame-level pieces
# ---------------------------------------------------------------------------

def rgb_to_yuv420(rgb):
    """(H, W, 3) uint8 -> Y (H, W), U, V (H/2, W/2) int32, BT.601 full
    range; chroma is the 2x2 mean summed as (a00+a01) + (a10+a11), the
    order XLA:CPU uses for the reference's ``mean(axis=(1, 3))``."""
    H, W = rgb.shape[0], rgb.shape[1]
    ycc = rgb_to_ycbcr(rgb)
    yf = torch.clamp(torch.round(ycc[..., 0]), 0, 255).to(torch.int32)

    def sub2(p):
        q = p.reshape(H // 2, 2, W // 2, 2)
        s = (q[:, 0, :, 0] + q[:, 0, :, 1]) + (q[:, 1, :, 0] + q[:, 1, :, 1])
        return torch.clamp(torch.round(s * 0.25), 0, 255).to(torch.int32)
    return yf, sub2(ycc[..., 1]), sub2(ycc[..., 2])


def _excl_cumsum0(nb):
    """Exclusive per-slot bit offsets along the stacked slot axis."""
    nb = nb.to(I64)
    return torch.cumsum(nb, 0) - nb


def _dc_scan(R, M, dc_y, dc_c, inv_y_edge, inv_c_edge, qp, qpc):
    """The sequential DC/left-edge pipeline of the I path: a Python loop
    over the M MB columns (the reference's lax.scan), small tensors only.
    dc_y (R, 4, M, 4), dc_c (R, 2, 2, M, 2), inv_y_edge (R, 4, M, 4),
    inv_c_edge (R, 2, 2, M, 4), qp/qpc (R,) ->
    (dc_lvls (R, M, 4, 4), cdc_lvls (R, M, 2, 2, 2), preds_y (R, M),
    preds_c (R, M, 2, 2))."""
    dev = dc_y.device
    qp, qpc = _t(qp, dev), _t(qpc, dev)
    qp3, qpc4 = qp[:, None, None], qpc[:, None, None, None]
    edge_y = torch.zeros((R, 16), dtype=I64, device=dev)
    edge_c = torch.zeros((R, 2, 8), dtype=I64, device=dev)
    dls, cls_, pys, pcs = [], [], [], []
    for k in range(M):
        if k == 0:
            pred_y = torch.full((R,), 128, dtype=I64, device=dev)
            pred_c = torch.full((R, 2, 2), 128, dtype=I64, device=dev)
        else:
            pred_y = (edge_y.sum(-1) + 8) >> 4
            pred_c = torch.stack([(edge_c[..., 0:4].sum(-1) + 2) >> 2,
                                  (edge_c[..., 4:8].sum(-1) + 2) >> 2], -1)
        dcm = dc_y[:, :, k, :] - 16 * pred_y[:, None, None]
        dlvl = _quant_dc_e(_had4(dcm) >> 1, qp3)
        dcY = _dequant_ldc_e(_had4(dlvl), qp3)
        edge_y = _clip1(pred_y[:, None, None]
                        + ((inv_y_edge[:, :, k, :] + dcY[:, :, 3:4] + 32)
                           >> 6)).reshape(R, 16)
        dcmc = dc_c[:, :, :, k, :] - 16 * pred_c[..., None]
        clvl = _quant_dc_e(_had2(dcmc), qpc4)
        dcC = _dequant_cdc_e(_had2(clvl), qpc4)
        edge_c = _clip1(pred_c[..., None]
                        + ((inv_c_edge[:, :, :, k, :] + dcC[..., 1:2] + 32)
                           >> 6)).reshape(R, 2, 8)
        dls.append(dlvl)
        cls_.append(clvl)
        pys.append(pred_y)
        pcs.append(pred_c)
    return (torch.stack(dls, 1), torch.stack(cls_, 1), torch.stack(pys, 1),
            torch.stack(pcs, 1))


def _merge_pixel_chroma(inv_c, dcC, preds_c, comp):
    """Chroma recon (H/2, W/2) from inverse planes + per-block DC +
    per-half preds."""
    dcC_pl = _merge_planes(
        [[dcC[:, :, comp, i, j] for j in range(2)] for i in range(2)], 2, 2)
    pred_pl = _merge_planes(
        [[preds_c[:, :, comp, i] for _ in range(2)] for i in range(2)], 2, 2)
    rec = [[_clip1(pred_pl + ((inv_c[i][j] + dcC_pl + 32) >> 6))
            for j in range(4)] for i in range(4)]
    return _merge_planes(rec, 4, 4)


# ---------------------------------------------------------------------------
# kernel-layout helpers shared by the plain versions
# ---------------------------------------------------------------------------

def _blocks_rm(planes, R, M, n):
    """list of mc (R*n, M*n) block-grid planes -> (R, M, n*n, mc) with the
    MB's blocks raster (by*n + bx)."""
    x = torch.stack(planes, -1)
    mc = x.shape[-1]
    return x.reshape(R, n, M, n, mc).permute(0, 2, 1, 3, 4).reshape(
        R, M, n * n, mc)


def _pad16(x):
    return torch.nn.functional.pad(x, (0, 16 - x.shape[-1]))


def _gate_rows(new, old, send_rows, px_per_row):
    """Send-gated reference update, in place: MB rows whose stripe is
    sent take ``new``; the others keep ``old``."""
    gate = send_rows.repeat_interleave(px_per_row).bool()
    old[gate] = new[gate].to(old.dtype)


def _hdr_tensor(cols, R, M, dev):
    """list of (pay, nb) per header slot -> (R, M, 6) pay / nb int32 with
    payloads zeroed where nbits is."""
    pay = torch.zeros((R, M, HDR_SLOTS), dtype=I64, device=dev)
    nb = torch.zeros((R, M, HDR_SLOTS), dtype=I64, device=dev)
    for k, (p, n) in enumerate(cols):
        nb[..., k] = torch.as_tensor(n).to(I64)
        pay[..., k] = torch.as_tensor(p).to(I64)
    pay = torch.where(nb > 0, pay, 0)
    return pay.to(torch.int32), nb.to(torch.int32)


# ---------------------------------------------------------------------------
# K1: colour conversion + damage + prev update
# ---------------------------------------------------------------------------

def csc420_damage_plain(frame, prev, n_stripes: int):
    """(H, W, 3) uint8 frame and prev -> (y, u, v) uint8 planes and (S,)
    int32 per-stripe damage flags; ``prev`` is overwritten with ``frame``
    (the reference's ``prev_out``, updated in place)."""
    H, W = frame.shape[0], frame.shape[1]
    y, u, v = rgb_to_yuv420(frame)
    damage = (frame != prev).reshape(n_stripes, -1).any(1).to(torch.int32)
    prev.copy_(frame)
    return y.to(torch.uint8), u.to(torch.uint8), v.to(torch.uint8), damage


def csc420_damage(frame, prev, n_stripes: int):
    """K1 (csrc/csc420_damage.cu) for a CUDA tensor, else the plain
    version. Same contract as :func:`csc420_damage_plain`."""
    H, W = frame.shape[0], frame.shape[1]
    _check(frame, "frame", torch.uint8, (H, W, 3), frame.device)
    _check(prev, "prev", torch.uint8, (H, W, 3), frame.device)
    if H % (2 * n_stripes) or W % 2 or (H // n_stripes) % 2:
        raise ValueError("frame must split into even-height stripes")
    if _on_cpu(frame):
        return csc420_damage_plain(frame, prev, n_stripes)
    dev = frame.device
    y = torch.empty((H, W), dtype=torch.uint8, device=dev)
    u = torch.empty((H // 2, W // 2), dtype=torch.uint8, device=dev)
    v = torch.empty((H // 2, W // 2), dtype=torch.uint8, device=dev)
    damage = torch.empty((n_stripes,), dtype=torch.int32, device=dev)
    _cuda.launch("csc420_damage", frame, prev, y, u, v, damage, H, W,
                 H // n_stripes)
    return y, u, v, damage


# ---------------------------------------------------------------------------
# K6: per-MB-row damage probe (the partial path's one pre-dispatch sync)
# ---------------------------------------------------------------------------

def row_damage_probe_plain(frame, prev, n_rows: int | None = None):
    """(H, W, 3) uint8 frame and prev -> (R,) int32, 1 where any byte of
    row band r differs: R = ``n_rows`` equal bands, by default the MB
    rows (the reference's ``_jitted_row_damage_probe``); the JPEG step
    passes its stripes (``jnp.any(stripes != prev_s)``)."""
    R = frame.shape[0] // 16 if n_rows is None else n_rows
    return (frame != prev).reshape(R, -1).any(1).to(torch.int32)


def row_damage_probe(frame, prev, n_rows: int | None = None):
    """K6 (csrc/row_damage_probe.cu) for CUDA tensors, else
    :func:`row_damage_probe_plain`."""
    H, W = frame.shape[0], frame.shape[1]
    R = H // 16 if n_rows is None else n_rows
    _check(frame, "frame", torch.uint8, (H, W, 3), frame.device)
    _check(prev, "prev", torch.uint8, (H, W, 3), frame.device)
    if (n_rows is None and H % 16) or R <= 0 or H % R:
        raise ValueError(f"frame height {H} must split into {R} row bands")
    if _on_cpu(frame):
        return row_damage_probe_plain(frame, prev, R)
    out = torch.empty((R,), dtype=torch.int32, device=frame.device)
    _cuda.launch("row_damage_probe", frame, prev, out, R, 3 * W * (H // R))
    return out


# ---------------------------------------------------------------------------
# K17: ROI QP's per-MB QP plane (the band path, before K1 rewrites prev)
# ---------------------------------------------------------------------------

def roi_qp_plane_plain(frame, prev, qp_rows, bias: int):
    """(H, W, 3) uint8 band of the frame and of ``prev``, (R,) int32 row
    QPs -> (R, M) int32 per-MB QPs: ``qp_rows - bias`` where any byte of
    the MB's 16x16x3 block differs, else ``qp_rows``, clipped to [8, 48]
    (the reference band step's ``mb_dirty`` / ``qp_mb``)."""
    H, W = frame.shape[0], frame.shape[1]
    R, M = H // 16, W // 16
    dirty = (frame != prev).reshape(R, 16, M, 48).any(3).any(1)
    q = qp_rows.to(torch.int32)[:, None]
    return torch.clamp(torch.where(dirty, q - bias, q), 8, 48).to(
        torch.int32)


def roi_qp_plane(frame, prev, qp_rows, bias: int):
    """K17 (csrc/roi_qp_plane.cu) for CUDA tensors, else
    :func:`roi_qp_plane_plain`."""
    H, W = frame.shape[0], frame.shape[1]
    dev = frame.device
    _check(frame, "frame", torch.uint8, (H, W, 3), dev)
    _check(prev, "prev", torch.uint8, (H, W, 3), dev)
    if H % 16 or W % 16:
        raise ValueError("the band must tile into 16x16 MBs")
    R, M = H // 16, W // 16
    _check(qp_rows, "qp_rows", torch.int32, (R,), dev)
    if _on_cpu(frame):
        return roi_qp_plane_plain(frame, prev, qp_rows, bias)
    out = torch.empty((R, M), dtype=torch.int32, device=dev)
    _cuda.launch("roi_qp_plane", frame, prev, qp_rows, out, R, M, int(bias))
    return out


# ---------------------------------------------------------------------------
# K2: per-MB transforms / quant / recon (I and P)
# ---------------------------------------------------------------------------

def _qpc_of(qp):
    return _t(_QPC, qp.device)[torch.clamp(qp.to(I64), 0, 51)]


def mb_encode_i_plain(y, u, v, qp, send, rows_per_stripe: int,
                      ref_y, ref_u, ref_v):
    """Intra_16x16 (DC pred) MB coding of one frame, one slice per MB row.
    -> (lv, cbp, hdr_pay, hdr_nb) in the kernel layout; the decoder-exact
    reconstruction is written into ``ref_*`` for the rows of stripes with
    ``send`` set."""
    H, W = y.shape
    R, M = H // 16, W // 16
    dev = y.device
    qp = qp.to(I64)
    qpc = _qpc_of(qp)
    qp_by = qp.repeat_interleave(4)[:, None]
    qpc_by = qpc.repeat_interleave(2)[:, None]

    wy, wu, wv = fwd4_planes(y), fwd4_planes(u), fwd4_planes(v)

    def quant_all(w, qp_b):
        return [[_quant_plane(w[i][j], qp_b, int(_POS_CLS[i][j]), 3)
                 for j in range(4)] for i in range(4)]
    acl_y, acl_u, acl_v = (quant_all(wy, qp_by), quant_all(wu, qpc_by),
                           quant_all(wv, qpc_by))
    scan_y = [acl_y[i][j] for (i, j) in _ZZ_IJ[1:]]        # AC only
    scan_u = [acl_u[i][j] for (i, j) in _ZZ_IJ[1:]]
    scan_v = [acl_v[i][j] for (i, j) in _ZZ_IJ[1:]]

    def deq_all(acl, qp_b):
        return [[_dequant_plane(acl[i][j] if (i, j) != (0, 0)
                                else torch.zeros_like(acl[0][0]),
                                qp_b, int(_POS_CLS[i][j]))
                 for j in range(4)] for i in range(4)]
    inv_y = inv4_planes(deq_all(acl_y, qp_by))
    inv_u = inv4_planes(deq_all(acl_u, qpc_by))
    inv_v = inv4_planes(deq_all(acl_v, qpc_by))
    inv_y_edge = torch.stack(
        [inv_y[i][3][:, 3::4].reshape(R, 4, M) for i in range(4)], -1)
    inv_c_edge = torch.stack([
        torch.stack([inv_u[i][3][:, 1::2].reshape(R, 2, M)
                     for i in range(4)], -1),
        torch.stack([inv_v[i][3][:, 1::2].reshape(R, 2, M)
                     for i in range(4)], -1)], 1)
    dc_y = wy[0][0].reshape(R, 4, M, 4)
    dc_c = torch.stack([wu[0][0].reshape(R, 2, M, 2),
                        wv[0][0].reshape(R, 2, M, 2)], 1)
    dc_lvls, cdc_lvls, preds_y, preds_c = _dc_scan(
        R, M, dc_y, dc_c, inv_y_edge, inv_c_edge, qp, qpc)

    lv_y = _blocks_rm(scan_y, R, M, 4)[:, :, _SCAN_RASTER]   # (R,M,16,15)
    lv_u = _blocks_rm(scan_u, R, M, 2)
    lv_v = _blocks_rm(scan_v, R, M, 2)
    cbp_luma = (lv_y != 0).any(-1).any(-1)
    has_cac = (lv_u != 0).any(-1).any(-1) | (lv_v != 0).any(-1).any(-1)
    has_cdc = (cdc_lvls != 0).reshape(R, M, 8).any(-1)
    cbp_chroma = torch.where(has_cac, 2, torch.where(has_cdc, 1, 0))
    lv = torch.cat([
        dc_lvls.reshape(R, M, 16)[..., _t(ZIGZAG4, dev)][:, :, None],
        _pad16(lv_y), _pad16(cdc_lvls.reshape(R, M, 2, 4)),
        _pad16(lv_u), _pad16(lv_v)], 2).to(torch.int16)
    cbp = (torch.where(cbp_luma, 15, 0) | (cbp_chroma << 4)).to(torch.int32)

    mb_type = 3 + 4 * cbp_chroma + torch.where(cbp_luma, 12, 0)
    ones = torch.ones((R, M), dtype=I64, device=dev)
    hdr_pay, hdr_nb = _hdr_tensor([_ue_event(mb_type), (ones, ones),
                                   (ones, ones)], R, M, dev)

    # decoder-exact recon (DC terms recomputed in parallel)
    dcY_all = _dequant_ldc_e(_had4(dc_lvls), qp[:, None, None, None])
    dcY_plane = _merge_planes(
        [[dcY_all[:, :, i, j] for j in range(4)] for i in range(4)], 4, 4)
    pred_plane = _expand(preds_y, 4, 4)
    rec_y = [[_clip1(pred_plane + ((inv_y[i][j] + dcY_plane + 32) >> 6))
              for j in range(4)] for i in range(4)]
    dcC = _dequant_cdc_e(_had2(cdc_lvls), qpc[:, None, None, None, None])
    send_rows = send.repeat_interleave(rows_per_stripe)
    _gate_rows(_merge_planes(rec_y, 4, 4), ref_y, send_rows, 16)
    _gate_rows(_merge_pixel_chroma(inv_u, dcC, preds_c, 0), ref_u,
               send_rows, 8)
    _gate_rows(_merge_pixel_chroma(inv_v, dcC, preds_c, 1), ref_v,
               send_rows, 8)
    return lv, cbp, hdr_pay, hdr_nb


_CBP2CODE = HT.CBP_INTER_CBP2CODE


def mb_encode_p_plain(y, u, v, qp, send_rows, pred_y, pred_u, pred_v, mv,
                      ref_y, ref_u, ref_v, qp_mb=None):
    """P_L0_16x16 / P_Skip MB coding against a prediction (the
    reference's ``h264_encode_p_yuv`` body, motion branch included):
    residual against ``pred_*``, ``coded = (cbp != 0) | mv_nz``, and
    ``mvd = mv - left neighbour`` as se() header events. ``mv`` (R, M, 2)
    quarter-pel (mvx, mvy), or None for zero motion, where ``pred_*`` may
    be the reference planes themselves. ``qp_mb`` (R, M) (ROI QP): each
    MB's quant, dequant and recon at its own QP, chroma at
    ``QPC[clip(qp_mb, 0, 51)]``; None: the row ``qp``. The mb_qp_delta
    slot stays ue(0) (K18 writes the deltas). -> (lv, cbp, hdr_pay,
    hdr_nb); the recon is written into ``ref_*`` in place for the MB
    rows with ``send_rows`` set, after the whole prediction has been
    read."""
    H, W = y.shape
    R, M = H // 16, W // 16
    dev = y.device
    if qp_mb is None:
        qpc = _qpc_of(qp)
        qp_by = qp.to(I64).repeat_interleave(4)[:, None]
        qpc_by = qpc.repeat_interleave(2)[:, None]
        qpc_rm = qpc[:, None]
    else:
        qp_by = _expand(qp_mb.to(I64), 4, 4)
        qpc_rm = _qpc_of(qp_mb)
        qpc_by = _expand(qpc_rm, 2, 2)
    pred_y, pred_u, pred_v = pred_y.to(I64), pred_u.to(I64), pred_v.to(I64)
    if mv is None:
        mv = torch.zeros((R, M, 2), dtype=I64, device=dev)
    mv = mv.to(I64)

    wy = fwd4_planes(y.to(I64) - pred_y)
    wu = fwd4_planes(u.to(I64) - pred_u)
    wv = fwd4_planes(v.to(I64) - pred_v)

    def quant_all(w, qp_b):
        return [[_quant_plane(w[i][j], qp_b, int(_POS_CLS[i][j]), 6)
                 for j in range(4)] for i in range(4)]
    acl_y, acl_u, acl_v = (quant_all(wy, qp_by), quant_all(wu, qpc_by),
                           quant_all(wv, qpc_by))
    scan_y = [acl_y[i][j] for (i, j) in _ZZ_IJ]
    scan_u = [acl_u[i][j] for (i, j) in _ZZ_IJ[1:]]
    scan_v = [acl_v[i][j] for (i, j) in _ZZ_IJ[1:]]

    def cdc_chain(w00):
        x = [[w00[i::2, j::2] for j in range(2)] for i in range(2)]
        a, b, c, d = _had2_parts(x[0][0], x[0][1], x[1][0], x[1][1])
        cl = [_quant_dc_e(h, qpc_rm) for h in (a, b, c, d)]
        a, b, c, d = _had2_parts(*cl)
        dc = [_dequant_cdc_e(f, qpc_rm) for f in (a, b, c, d)]
        return cl, [[dc[0], dc[1]], [dc[2], dc[3]]]
    clvl_u, dcC_u = cdc_chain(wu[0][0])
    clvl_v, dcC_v = cdc_chain(wv[0][0])

    lv_y = _blocks_rm(scan_y, R, M, 4)                       # raster
    lv_u = _blocks_rm(scan_u, R, M, 2)
    lv_v = _blocks_rm(scan_v, R, M, 2)
    nz_blk = (lv_y != 0).any(-1).reshape(R, M, 2, 2, 2, 2)   # by2 i bx2 j
    g8 = nz_blk.any(5).any(3)                                # (R, M, 2, 2)
    cbp_luma = (g8[..., 0, 0].to(I64) | (g8[..., 0, 1].to(I64) << 1)
                | (g8[..., 1, 0].to(I64) << 2) | (g8[..., 1, 1].to(I64) << 3))
    has_cac = (lv_u != 0).any(-1).any(-1) | (lv_v != 0).any(-1).any(-1)
    has_cdc = sum(cl.abs() for cl in clvl_u + clvl_v) > 0
    cbp_chroma = torch.where(has_cac, 2, torch.where(has_cdc, 1, 0))
    cbp = cbp_luma | (cbp_chroma << 4)
    coded = (cbp != 0) | (mv != 0).any(-1)
    lv = torch.cat([
        torch.zeros((R, M, 1, 16), dtype=I64, device=dev),
        lv_y[:, :, _SCAN_RASTER],
        _pad16(torch.stack([torch.stack(clvl_u, -1),
                            torch.stack(clvl_v, -1)], 2)),
        _pad16(lv_u), _pad16(lv_v)], 2).to(torch.int16)

    # MV predictor = left neighbour (one slice per MB row, §8.4.1.3)
    mvd = mv - _pad_left_mb(mv)
    one = torch.ones((R, M), dtype=I64, device=dev)
    on = coded.to(I64)
    cbp_pay, cbp_nb = _ue_event(_t(_CBP2CODE, dev)[cbp])
    mx_pay, mx_nb = _se_event(mvd[..., 0])
    my_pay, my_nb = _se_event(mvd[..., 1])
    hdr_pay, hdr_nb = _hdr_tensor([
        (one, torch.zeros_like(one)),       # skip run: the packer's
        (one, on),                          # mb_type P_L0_16x16
        (mx_pay, torch.where(coded, mx_nb, 0)),
        (my_pay, torch.where(coded, my_nb, 0)),
        (cbp_pay, torch.where(coded, cbp_nb, 0)),
        (one, (coded & (cbp != 0)).to(I64))], R, M, dev)

    # ---- recon (decoder-exact)
    colg = torch.arange(4 * M, device=dev)[None, :]
    rowg = torch.arange(4 * R, device=dev)[:, None]
    g8_idx = ((rowg % 4) >> 1) * 2 + ((colg % 4) >> 1)
    grp_bit = ((_expand(cbp_luma, 4, 4) >> g8_idx) & 1) == 1
    blk_on = grp_bit & _expand(coded, 4, 4)
    zero = torch.zeros((), dtype=I64, device=dev)
    d_y = [[_dequant_plane(torch.where(blk_on, acl_y[i][j], zero), qp_by,
                           int(_POS_CLS[i][j])) for j in range(4)]
           for i in range(4)]
    inv_y = inv4_planes(d_y)
    rec_y = [[_clip1(pred_y[i::4, j::4] + ((inv_y[i][j] + 32) >> 6))
              for j in range(4)] for i in range(4)]
    gate_c = _expand(cbp_chroma == 2, 2, 2)
    gate_dc = cbp_chroma >= 1

    def chroma_recon(acl, dcC, pred):
        d = [[_dequant_plane(torch.where(gate_c, acl[i][j], zero), qpc_by,
                             int(_POS_CLS[i][j])) for j in range(4)]
             for i in range(4)]
        d[0][0] = _merge_planes(
            [[torch.where(gate_dc, dcC[i][j], zero) for j in range(2)]
             for i in range(2)], 2, 2)
        inv = inv4_planes(d)
        rec = [[_clip1(pred[i::4, j::4] + ((inv[i][j] + 32) >> 6))
                for j in range(4)] for i in range(4)]
        return _merge_planes(rec, 4, 4)
    rec_u = chroma_recon(acl_u, dcC_u, pred_u)
    rec_v = chroma_recon(acl_v, dcC_v, pred_v)
    _gate_rows(_merge_planes(rec_y, 4, 4), ref_y, send_rows, 16)
    _gate_rows(rec_u, ref_u, send_rows, 8)
    _gate_rows(rec_v, ref_v, send_rows, 8)
    return lv, cbp.to(torch.int32), hdr_pay, hdr_nb


def _pad_left_mb(mv):
    """(R, M, 2) -> each MB's left neighbour's vector, zero at column 0."""
    return torch.cat([torch.zeros_like(mv[:, :1]), mv[:, :-1]], 1)


def _check_planes(y, pairs, cdiv: int = 2):
    """uint8 planes on y's device: luma (names ending in y) H x W, chroma
    H/cdiv x W/cdiv."""
    H, W = y.shape
    if H % 16 or W % 16:
        raise ValueError("planes must tile into 16x16 MBs")
    for t, n in pairs:
        shp = (H, W) if n.endswith("y") else (H // cdiv, W // cdiv)
        _check(t, n, torch.uint8, shp, y.device)


def _mb_encode(name, plain, y, u, v, qp, send, rows_per_stripe,
               ref_y, ref_u, ref_v, cdiv: int = 2, n_blocks: int = N_BLOCKS):
    """An I entry (K2-I, K14): checks, then the kernel or ``plain``;
    chroma planes are H/cdiv x W/cdiv, ``lv`` has ``n_blocks`` blocks."""
    H, W = y.shape
    dev = y.device
    R, M = H // 16, W // 16
    if R % rows_per_stripe:
        raise ValueError("MB rows must tile into stripes")
    S = R // rows_per_stripe
    _check_planes(y, ((y, "y"), (u, "u"), (v, "v"), (ref_y, "ref_y"),
                      (ref_u, "ref_u"), (ref_v, "ref_v")), cdiv)
    _check(qp, "qp", torch.int32, (R,), dev)
    _check(send, "send", torch.int32, (S,), dev)
    if _on_cpu(y):
        return plain(y, u, v, qp, send, rows_per_stripe, ref_y, ref_u, ref_v)
    lv, cbp, hdr_pay, hdr_nb = _mb_outputs(R, M, dev, n_blocks)
    _cuda.launch(name, y, u, v, qp, send, rows_per_stripe, ref_y, ref_u,
                 ref_v, lv, cbp, hdr_pay, hdr_nb, R, M)
    return lv, cbp, hdr_pay, hdr_nb


def _mb_encode_p(name, plain, y, u, v, qp, send_rows, pred_y, pred_u,
                 pred_v, mv, ref_y, ref_u, ref_v, cdiv: int = 2,
                 n_blocks: int = N_BLOCKS, qp_mb=None):
    """A P entry (K2-P, K15), as :func:`_mb_encode`. A ``qp_mb`` plane
    (the 4:2:0 entry only) goes to ``plain`` and to the C entry
    ``<name>_qp``."""
    H, W = y.shape
    dev = y.device
    R, M = H // 16, W // 16
    _check_planes(y, ((y, "y"), (u, "u"), (v, "v"), (pred_y, "pred_y"),
                      (pred_u, "pred_u"), (pred_v, "pred_v"),
                      (ref_y, "ref_y"), (ref_u, "ref_u"), (ref_v, "ref_v")),
                  cdiv)
    _check(qp, "qp", torch.int32, (R,), dev)
    _check(send_rows, "send_rows", torch.int32, (R,), dev)
    if mv is not None:
        _check(mv, "mv", torch.int32, (R, M, 2), dev)
    roi = () if qp_mb is None else (qp_mb,)
    if roi:
        _check(qp_mb, "qp_mb", torch.int32, (R, M), dev)
    if _on_cpu(y):
        return plain(y, u, v, qp, send_rows, pred_y, pred_u, pred_v, mv,
                     ref_y, ref_u, ref_v, *roi)
    lv, cbp, hdr_pay, hdr_nb = _mb_outputs(R, M, dev, n_blocks)
    _cuda.launch(name + "_qp" if roi else name, y, u, v, qp, send_rows,
                 pred_y, pred_u, pred_v, mv, *roi, ref_y, ref_u, ref_v, lv,
                 cbp, hdr_pay, hdr_nb, R, M)
    return lv, cbp, hdr_pay, hdr_nb


def _mb_outputs(R, M, dev, n_blocks: int = N_BLOCKS):
    return (torch.empty((R, M, n_blocks, 16), dtype=torch.int16, device=dev),
            torch.empty((R, M), dtype=torch.int32, device=dev),
            torch.empty((R, M, HDR_SLOTS), dtype=torch.int32, device=dev),
            torch.empty((R, M, HDR_SLOTS), dtype=torch.int32, device=dev))


def mb_encode_i(y, u, v, qp, send, rows_per_stripe: int, ref_y, ref_u,
                ref_v):
    """K2, I entry (csrc/mb_encode.cu:mb_encode_i) for CUDA tensors, else
    :func:`mb_encode_i_plain`."""
    return _mb_encode("mb_encode_i", mb_encode_i_plain, y, u, v, qp, send,
                      rows_per_stripe, ref_y, ref_u, ref_v)


def mb_encode_p(y, u, v, qp, send_rows, pred_y, pred_u, pred_v, mv, ref_y,
                ref_u, ref_v, qp_mb=None):
    """K2, P entry (csrc/mb_encode.cu:mb_encode_p, or mb_encode_p_qp with
    a ``qp_mb`` plane) for CUDA tensors, else :func:`mb_encode_p_plain`;
    same contract. ``send_rows`` (R,) int32 is the per-MB-row gate of the
    reference advance."""
    return _mb_encode_p("mb_encode_p", mb_encode_p_plain, y, u, v, qp,
                        send_rows, pred_y, pred_u, pred_v, mv, ref_y, ref_u,
                        ref_v, qp_mb=qp_mb)


# ---------------------------------------------------------------------------
# K3: CAVLC events for every block
# ---------------------------------------------------------------------------

def _tc_gate_plane(lvb, gate, R, M, n):
    """(R, M, n*n, mc) raster blocks + gate (broadcastable to (R, M, n*n))
    -> the gated total-coeff plane (R*n, M*n)."""
    tc = (lvb != 0).sum(-1) * gate
    return tc.reshape(R, M, n, n).permute(0, 2, 1, 3).reshape(R * n, M * n)


def _plane_to_rm(plane, R, M, n):
    return plane.reshape(R, n, M, n).permute(0, 2, 1, 3).reshape(R, M, n * n)


def cavlc_events_plain(lv, cbp, intra: bool):
    """(lv (R, M, 27, 16) int16, cbp (R, M) int32) -> (ev_pay int32,
    ev_nb uint8) of shape (R, M, SB): the gated CAVLC slots of every block
    in bitstream order (module docstring)."""
    R, M = lv.shape[0], lv.shape[1]
    dev = lv.device
    lv = lv.to(I64)
    cbp = cbp.to(I64)
    cbp_chroma = cbp >> 4
    mc = 15 if intra else 16
    raster = torch.tensor(np.argsort(_SCAN_RASTER), device=dev)
    lv_y = lv[:, :, 1:17, :mc][:, :, raster]                 # raster order
    if intra:
        gate_y = ((cbp & 15) != 0)[..., None].expand(R, M, 16)
    else:
        by = torch.arange(16, device=dev) // 4
        bx = torch.arange(16, device=dev) % 4
        g8 = (by >> 1) * 2 + (bx >> 1)
        gate_y = ((cbp[..., None] >> g8) & 1) == 1
    nc_y = _nc_planes(_tc_gate_plane(lv_y, gate_y, R, M, 4), 4)
    ypay, ynb, _ = cavlc_events_planes(
        lv_y.permute(3, 0, 1, 2), _plane_to_rm(nc_y, R, M, 4))
    ynb = torch.where(gate_y[None], ynb, 0)
    classes = []
    if intra:
        dpay, dnb, _ = cavlc_events_planes(
            lv[:, :, 0, :16].permute(2, 0, 1), nc_y[0::4, 0::4])
        classes.append((dpay[..., None], dnb[..., None]))
    perm = torch.tensor(_SCAN_RASTER, device=dev)
    classes.append((ypay[..., perm], ynb[..., perm]))
    cdc_gate = (cbp_chroma > 0)[None, ..., None]
    cpay, cnb, _ = cavlc_events_planes(lv[:, :, 17:19, :4].permute(3, 0, 1, 2),
                                       None, chroma_dc=True)
    classes.append((cpay, torch.where(cdc_gate, cnb, 0)))
    gate_c = (cbp_chroma == 2)[..., None].expand(R, M, 4)
    for comp in range(2):
        lvc = lv[:, :, 19 + 4 * comp:23 + 4 * comp, :15]
        nc_c = _nc_planes(_tc_gate_plane(lvc, gate_c, R, M, 2), 2)
        p, n, _ = cavlc_events_planes(lvc.permute(3, 0, 1, 2),
                                      _plane_to_rm(nc_c, R, M, 2))
        classes.append((p, torch.where(gate_c[None], n, 0)))
    # (S, R, M, nblk) per class -> (R, M, nblk*S), concatenated in order
    pay = torch.cat([p.permute(1, 2, 3, 0).reshape(R, M, -1)
                     for p, _ in classes], -1)
    nb = torch.cat([n.permute(1, 2, 3, 0).reshape(R, M, -1)
                    for _, n in classes], -1)
    pay = torch.where(nb > 0, pay, 0)
    return pay.to(torch.int32), nb.to(torch.uint8)


def _cavlc_events(name, plain, n_blocks: int, sb: int, lv, cbp,
                  intra: bool):
    """A CAVLC entry (K3, K16): ``lv`` of ``n_blocks`` blocks in, ``sb``
    slots per MB out."""
    R, M = lv.shape[0], lv.shape[1]
    _check(lv, "lv", torch.int16, (R, M, n_blocks, 16), lv.device)
    _check(cbp, "cbp", torch.int32, (R, M), lv.device)
    if _on_cpu(lv):
        return plain(lv, cbp, intra)
    ev_pay = torch.empty((R, M, sb), dtype=torch.int32, device=lv.device)
    ev_nb = torch.empty((R, M, sb), dtype=torch.uint8, device=lv.device)
    _cuda.launch(name, lv, cbp, ev_pay, ev_nb, R, M, int(intra))
    return ev_pay, ev_nb


def cavlc_events(lv, cbp, intra: bool):
    """K3 (csrc/cavlc_events.cu) for CUDA tensors, else
    :func:`cavlc_events_plain`."""
    return _cavlc_events("cavlc_events", cavlc_events_plain, N_BLOCKS,
                         SB_I if intra else SB_P, lv, cbp, intra)


# ---------------------------------------------------------------------------
# K4: row assembly, bit packing, bytes, ragged concat
# ---------------------------------------------------------------------------

def _qp_event(qp):
    dqp = qp.to(I64) - 26
    return _ue_event(torch.where(dqp > 0, 2 * dqp - 1, -2 * dqp))


def _assemble(R, M, w_cap, e_cap, row_pays, row_nbs, mb_pay, mb_nb,
              tail_pays, tail_nbs):
    """Shared row assembly: prefix events (6, R), per-MB events
    (R, M, S) in bitstream order, tail events (T, R) -> H264FrameOut."""
    dev = mb_pay.device
    sink = _EventSink(R, M, w_cap)
    rows_r = torch.arange(R, dtype=I64, device=dev)
    sink.add_prefix(rows_r[None], _excl_cumsum0(row_nbs), row_pays, row_nbs)
    mb_nb = mb_nb.to(I64)
    off = torch.cumsum(mb_nb, -1) - mb_nb
    sink.add_mb(rows_r[:, None, None],
                torch.arange(M, dtype=I64, device=dev)[None, :, None],
                off, mb_pay, mb_nb)
    tail_off = _excl_cumsum0(tail_nbs)
    for k in range(tail_pays.shape[0]):
        sink.add_tail(rows_r, tail_off[k], tail_pays[k], tail_nbs[k])
    sink.set_layout(row_nbs.to(I64).sum(0), mb_nb.sum(-1),
                    tail_nbs.to(I64).sum(0))
    words, n_ev, total_bits = sink.pack()
    overflow = ((n_ev > e_cap) | (total_bits > w_cap * 32)).any()
    return H264FrameOut(words, total_bits, overflow, R)


def _assemble_frame(R, M, w_cap, e_cap, qp, idr_pic_id, header_pay,
                    header_nb, mb_pay, mb_nb):
    """I-slice rows: prefix [hdr(2), idr_pic_id, '00' flags, qp, deblock]
    | per MB events | stop bit."""
    dev = mb_pay.device
    hp, hn = _t(header_pay, dev), _t(header_nb, dev)
    idr_pay, idr_nb = _ue_event(_t(idr_pic_id, dev))
    qp_pay, qp_nb = _qp_event(qp)
    z, full = torch.zeros((R,), dtype=I64, device=dev), torch.full_like
    row_pays = torch.stack([hp[:, 0], hp[:, 1], idr_pay, z, qp_pay,
                            full(z, 2)])
    row_nbs = torch.stack([hn[:, 0], hn[:, 1], idr_nb.to(I64), full(z, 2),
                           qp_nb.to(I64), full(z, 3)])
    one = torch.ones((1, R), dtype=I64, device=dev)
    return _assemble(R, M, w_cap, e_cap, row_pays, row_nbs, mb_pay, mb_nb,
                     one, one)


def _assemble_p_frame(R, M, w_cap, e_cap, qp, fn, header_pay, header_nb,
                      mb_pay, mb_nb):
    """P-slice rows: prefix [hdr(2), frame_num u(4), '000' flags, qp,
    deblock] | per MB [skip_run, header, residual] | trailing skip run |
    stop bit. Slot 0 of every MB (the skip run) is filled here: coded MBs
    are the ones whose mb_type slot carries bits."""
    dev = mb_pay.device
    mb_pay, mb_nb = mb_pay.to(I64).clone(), mb_nb.to(I64).clone()
    coded = mb_nb[..., 1] > 0
    idx = torch.arange(M, dtype=I64, device=dev)[None, :].expand(R, M)
    inclusive = torch.cummax(torch.where(coded, idx, -1), 1).values
    prev_excl = torch.cat([torch.full((R, 1), -1, dtype=I64, device=dev),
                           inclusive[:, :-1]], 1)
    sr_pay, sr_nb = _ue_event(torch.clamp(idx - prev_excl - 1, min=0))
    mb_pay[..., 0] = torch.where(coded, sr_pay, 0)
    mb_nb[..., 0] = torch.where(coded, sr_nb.to(I64), 0)
    trailing = (M - 1) - inclusive[:, -1]
    tr_pay, tr_nb = _ue_event(torch.clamp(trailing, min=0))
    tr_nb = torch.where(trailing > 0, tr_nb.to(I64), 0)

    hp, hn = _t(header_pay, dev), _t(header_nb, dev)
    qp_pay, qp_nb = _qp_event(qp)
    z, full = torch.zeros((R,), dtype=I64, device=dev), torch.full_like
    row_pays = torch.stack([hp[:, 0], hp[:, 1], _t(fn, dev) & 0xF, z, qp_pay,
                            full(z, 2)])
    row_nbs = torch.stack([hn[:, 0], hn[:, 1], full(z, 4), full(z, 3),
                           qp_nb.to(I64), full(z, 3)])
    one = torch.ones((R,), dtype=I64, device=dev)
    return _assemble(R, M, w_cap, e_cap, row_pays, row_nbs, mb_pay, mb_nb,
                     torch.stack([tr_pay, one]), torch.stack([tr_nb, one]))


# ---------------------------------------------------------------------------
# K18: ROI QP's mb_qp_delta carry chain (K2-P's header slot 5, before K4)
# ---------------------------------------------------------------------------

def mb_qp_delta_plain(hdr_pay, hdr_nb, qp_mb, qp_rows):
    """K2-P's header events (R, M, 6), updated in place and returned:
    every MB whose mb_qp_delta slot carries bits (coded with cbp != 0,
    §7.3.5) gets se(qp_mb - qp_prev), ``qp_prev`` being the QP of the
    previous such MB of its row, or the row's slice QP for the first
    (each row is a slice, so the chain restarts per row). The previous
    carrier by the running max the skip runs use (the reference's
    ``_assemble_p_frame`` with ``qp_mb``)."""
    R, M = qp_mb.shape
    dev = qp_mb.device
    gate = hdr_nb[..., 5] > 0
    idx = torch.arange(M, dtype=I64, device=dev)[None, :].expand(R, M)
    inclusive = torch.cummax(torch.where(gate, idx, -1), 1).values
    prev = torch.cat([torch.full((R, 1), -1, dtype=I64, device=dev),
                      inclusive[:, :-1]], 1)
    q = qp_mb.to(I64)
    qp_prev = torch.where(prev >= 0, torch.gather(q, 1, prev.clamp(min=0)),
                          qp_rows.to(I64)[:, None])
    pay, nb = _se_event(q - qp_prev)
    hdr_pay[..., 5] = torch.where(gate, pay, 0).to(torch.int32)
    hdr_nb[..., 5] = torch.where(gate, nb, 0).to(torch.int32)
    return hdr_pay, hdr_nb


def mb_qp_delta(hdr_pay, hdr_nb, qp_mb, qp_rows):
    """K18 (csrc/mb_qp_delta.cu) for CUDA tensors, else
    :func:`mb_qp_delta_plain`; same contract (in place)."""
    R, M = qp_mb.shape
    dev = qp_mb.device
    _check(hdr_pay, "hdr_pay", torch.int32, (R, M, HDR_SLOTS), dev)
    _check(hdr_nb, "hdr_nb", torch.int32, (R, M, HDR_SLOTS), dev)
    _check(qp_mb, "qp_mb", torch.int32, (R, M), dev)
    _check(qp_rows, "qp_rows", torch.int32, (R,), dev)
    if _on_cpu(qp_mb):
        return mb_qp_delta_plain(hdr_pay, hdr_nb, qp_mb, qp_rows)
    _cuda.launch("mb_qp_delta", hdr_pay, hdr_nb, qp_mb, qp_rows, R, M)
    return hdr_pay, hdr_nb


class StreamOut(NamedTuple):
    words: torch.Tensor       # (R, w_cap) int32, uint32 bit patterns
    total_bits: torch.Tensor  # (R,) int32
    data: torch.Tensor        # (out_cap,) uint8, rows back to back
    byte_lens: torch.Tensor   # (R,) int32
    flags: torch.Tensor       # (2,) int32: [w_cap/e_cap overflow,
    #                                         out_cap overflow]
    # (the seat entries: data (n_seats, out_cap), flags (n_seats, 2))


def pack_stream_plain(hdr_pay, hdr_nb, ev_pay, ev_nb, row_hdr_pay,
                      row_hdr_nb, row_id, qp, intra: bool, e_cap: int,
                      w_cap: int, out_cap: int) -> StreamOut:
    """Rows of one frame -> words, bit totals, the ragged byte buffer and
    both overflow flags. ``row_id`` is each row's idr_pic_id (I) or
    frame_num (P)."""
    R, M = hdr_pay.shape[0], hdr_pay.shape[1]
    mb_pay = torch.cat([hdr_pay.to(I64), ev_pay.to(I64)], -1)
    mb_nb = torch.cat([hdr_nb.to(I64), ev_nb.to(I64)], -1)
    asm = _assemble_frame if intra else _assemble_p_frame
    out = asm(R, M, w_cap, e_cap, qp, row_id, row_hdr_pay, row_hdr_nb,
              mb_pay, mb_nb)
    sbytes, lens = words_to_bytes_device(out.words, out.total_bits)
    buf = concat_stripe_bytes(sbytes, lens, out_cap)
    flags = torch.stack([out.overflow, buf.overflow]).to(torch.int32)
    return StreamOut(out.words, out.total_bits, buf.data, buf.byte_lens,
                     flags)


def _check_pack(hdr_pay, hdr_nb, ev_pay, ev_nb, row_hdr_pay, row_hdr_nb,
                row_id, qp, intra: bool) -> int:
    """K4's input checks. -> SB, the block slots per MB, read off
    ``ev_pay``: 876 (I) / 872 (P) at 4:2:0, 1740 / 1728 at 4:4:4."""
    R, M = hdr_pay.shape[0], hdr_pay.shape[1]
    dev = hdr_pay.device
    sb = ev_pay.shape[-1] if ev_pay.dim() == 3 else SB_I if intra else SB_P
    _check(hdr_pay, "hdr_pay", torch.int32, (R, M, HDR_SLOTS), dev)
    _check(hdr_nb, "hdr_nb", torch.int32, (R, M, HDR_SLOTS), dev)
    _check(ev_pay, "ev_pay", torch.int32, (R, M, sb), dev)
    _check(ev_nb, "ev_nb", torch.uint8, (R, M, sb), dev)
    _check(row_hdr_pay, "row_hdr_pay", torch.int32, (R, 2), dev)
    _check(row_hdr_nb, "row_hdr_nb", torch.int32, (R, 2), dev)
    _check(row_id, "row_id", torch.int32, (R,), dev)
    _check(qp, "qp", torch.int32, (R,), dev)
    return sb


def _launch_pack(entry: str, n_seats, hdr_pay, hdr_nb, ev_pay, ev_nb, sb,
                 row_hdr_pay, row_hdr_nb, row_id, qp, intra: bool,
                 e_cap: int, w_cap: int, out_cap: int) -> StreamOut:
    """K4's outputs and launch; ``n_seats`` None is the single-frame
    entry (whose data and flags have no seat axis)."""
    R, M = hdr_pay.shape[0], hdr_pay.shape[1]
    dev = hdr_pay.device
    seats = () if n_seats is None else (n_seats,)
    words = torch.empty((R, w_cap), dtype=torch.int32, device=dev)
    total_bits = torch.empty((R,), dtype=torch.int32, device=dev)
    data = torch.empty(seats + (out_cap,), dtype=torch.uint8, device=dev)
    byte_lens = torch.empty((R,), dtype=torch.int32, device=dev)
    flags = torch.empty(seats + (2,), dtype=torch.int32, device=dev)
    rows = R if n_seats is None else R // n_seats
    _cuda.launch(entry, hdr_pay, hdr_nb, ev_pay, ev_nb, sb, row_hdr_pay,
                 row_hdr_nb, row_id, qp, int(intra), *seats, rows, M, e_cap,
                 w_cap, out_cap, words, total_bits, data, byte_lens, flags)
    return StreamOut(words, total_bits, data, byte_lens, flags)


def pack_stream(hdr_pay, hdr_nb, ev_pay, ev_nb, row_hdr_pay, row_hdr_nb,
                row_id, qp, intra: bool, e_cap: int, w_cap: int,
                out_cap: int) -> StreamOut:
    """K4 (csrc/pack_stream.cu) for CUDA tensors, else
    :func:`pack_stream_plain`."""
    sb = _check_pack(hdr_pay, hdr_nb, ev_pay, ev_nb, row_hdr_pay,
                     row_hdr_nb, row_id, qp, intra)
    if _on_cpu(hdr_pay):
        return pack_stream_plain(hdr_pay, hdr_nb, ev_pay, ev_nb, row_hdr_pay,
                                 row_hdr_nb, row_id, qp, intra, e_cap, w_cap,
                                 out_cap)
    return _launch_pack("pack_stream", None, hdr_pay, hdr_nb, ev_pay, ev_nb,
                        sb, row_hdr_pay, row_hdr_nb, row_id, qp, intra,
                        e_cap, w_cap, out_cap)


def pack_stream_seats_plain(hdr_pay, hdr_nb, ev_pay, ev_nb, row_hdr_pay,
                            row_hdr_nb, row_id, qp, intra: bool, e_cap: int,
                            w_cap: int, out_cap: int, n_seats: int
                            ) -> StreamOut:
    """The rows of ``n_seats`` seats, back to back, each seat packed as
    one frame by :func:`pack_stream_plain` (the reference vmaps its
    packer over seats). -> words, total_bits and byte_lens over all rows,
    data (n_seats, out_cap), flags (n_seats, 2)."""
    R = hdr_pay.shape[0] // n_seats
    outs = [pack_stream_plain(*(t[k * R:(k + 1) * R] for t in (
        hdr_pay, hdr_nb, ev_pay, ev_nb, row_hdr_pay, row_hdr_nb, row_id,
        qp)), intra, e_cap, w_cap, out_cap) for k in range(n_seats)]
    cat = torch.cat
    return StreamOut(cat([o.words for o in outs]),
                     cat([o.total_bits for o in outs]),
                     torch.stack([o.data for o in outs]),
                     cat([o.byte_lens for o in outs]),
                     torch.stack([o.flags for o in outs]))


def pack_stream_seats(hdr_pay, hdr_nb, ev_pay, ev_nb, row_hdr_pay,
                      row_hdr_nb, row_id, qp, intra: bool, e_cap: int,
                      w_cap: int, out_cap: int, n_seats: int) -> StreamOut:
    """K4's seat entry (``pack_stream_seats`` in csrc/pack_stream.cu, one
    launch for every seat) for CUDA tensors, else
    :func:`pack_stream_seats_plain`. The per-row inputs hold the rows of
    ``n_seats`` seats back to back."""
    sb = _check_pack(hdr_pay, hdr_nb, ev_pay, ev_nb, row_hdr_pay,
                     row_hdr_nb, row_id, qp, intra)
    if n_seats < 1 or hdr_pay.shape[0] % n_seats:
        raise ValueError(f"{hdr_pay.shape[0]} rows do not split into "
                         f"{n_seats} seats")
    if _on_cpu(hdr_pay):
        return pack_stream_seats_plain(hdr_pay, hdr_nb, ev_pay, ev_nb,
                                       row_hdr_pay, row_hdr_nb, row_id, qp,
                                       intra, e_cap, w_cap, out_cap, n_seats)
    return _launch_pack("pack_stream_seats", n_seats, hdr_pay, hdr_nb,
                        ev_pay, ev_nb, sb, row_hdr_pay, row_hdr_nb, row_id,
                        qp, intra, e_cap, w_cap, out_cap)


# ---------------------------------------------------------------------------
# frame-level entry points with the reference's signatures
# ---------------------------------------------------------------------------

class StepOps(NamedTuple):
    """The kernels of the main path, or their plain versions (this
    module's for 4:2:0; ops/h264_planes444.py holds the 4:4:4 sets).
    ``roi_qp_plane`` and ``mb_qp_delta`` run on the 4:2:0 band path with
    ROI QP only."""
    csc_damage: object
    mb_encode_i: object
    mb_encode_p: object
    cavlc_events: object
    pack_stream: object
    motion_select: object
    row_damage_probe: object
    roi_qp_plane: object
    mb_qp_delta: object


KERNEL_OPS = StepOps(csc420_damage, mb_encode_i, mb_encode_p, cavlc_events,
                     pack_stream, motion_select, row_damage_probe,
                     roi_qp_plane, mb_qp_delta)
PLAIN_OPS = StepOps(csc420_damage_plain, mb_encode_i_plain,
                    mb_encode_p_plain, cavlc_events_plain, pack_stream_plain,
                    motion_select_plain, row_damage_probe_plain,
                    roi_qp_plane_plain, mb_qp_delta_plain)
#: the multi-seat step's sets (parallel/h264_seats.py): K4's seat entry,
#: which takes ``n_seats``, in place of the single-frame one
SEAT_KERNEL_OPS = KERNEL_OPS._replace(pack_stream=pack_stream_seats)
SEAT_PLAIN_OPS = PLAIN_OPS._replace(pack_stream=pack_stream_seats_plain)


def p_rows(ops: StepOps, y, u, v, qp, send_rows, ref, candidates, win: int,
           scratch=None, qp_mb=None, pred=None):
    """K5 (when ``candidates`` is given) then K2-P over planes of whole MB
    rows; the recon lands in ``ref`` for the rows with ``send_rows`` set.
    The prediction is complete in ``scratch`` (or fresh planes) before K2
    rewrites ``ref``. ``pred`` = (pred_y, pred_u, pred_v, mv), a
    prediction made beforehand (the split-frame halo search,
    parallel/stripes.py), takes K5's place. With a ``qp_mb`` plane (ROI
    QP, 4:2:0) K2-P codes each MB at its QP and K18 writes the
    mb_qp_delta chain into its headers; K5 keeps the row ``qp`` for its
    vector cost, as the reference does. -> K2-P's (lv, cbp, hdr_pay,
    hdr_nb)."""
    if pred is not None:
        *pred, mv = pred
    elif candidates:
        *pred, mv = ops.motion_select(y, *ref, qp, candidates, win,
                                      out=scratch)
    else:
        pred, mv = ref, None
    if qp_mb is None:
        return ops.mb_encode_p(y, u, v, qp, send_rows, *pred, mv, *ref)
    lv, cbp, hdr_pay, hdr_nb = ops.mb_encode_p(
        y, u, v, qp, send_rows, *pred, mv, *ref, qp_mb=qp_mb)
    ops.mb_qp_delta(hdr_pay, hdr_nb, qp_mb, qp)
    return lv, cbp, hdr_pay, hdr_nb


def _as_tensor(x, device):
    """Tensor on ``device`` from a tensor, a numpy array (copied: it may
    be read-only) or a scalar."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.array(x), device=device)


def _frame_args(yf, uf, vf, qp, header_pay, header_nb, row_id, device):
    """Inputs as tensors on ``device``; None means the device of a tensor
    ``yf``, else the card (raises without one, as the session does)."""
    R = yf.shape[0] // 16
    if device is None and isinstance(yf, torch.Tensor):
        dev = yf.device
    else:
        dev = resolve_device(device)
    planes = [_as_tensor(p, dev).to(torch.uint8) for p in (yf, uf, vf)]

    def rows(x):
        return torch.broadcast_to(_as_tensor(x, dev).to(torch.int32),
                                  (R,)).contiguous()
    hp = torch.as_tensor(np.asarray(header_pay).astype(np.int64),
                         device=dev).to(torch.int32)
    hn = torch.as_tensor(np.asarray(header_nb), device=dev).to(torch.int32)
    return planes, rows(qp), hp, hn, rows(row_id)


def h264_encode_yuv(yf, uf, vf, qp, header_pay, header_nb, e_cap: int,
                    w_cap: int, idr_pic_id=0, want_recon: bool = False,
                    device=None):
    """Same signature and output as the reference's plane-layout I
    encoder, run through the main path's kernels (K2 -> K3 -> K4).
    ``device`` (None: the planes' device if they are tensors, else
    ``cuda``) is where it runs; ``"cpu"`` runs the plain versions."""
    (y, u, v), qp, hp, hn, idr = _frame_args(yf, uf, vf, qp, header_pay,
                                             header_nb, idr_pic_id, device)
    R = y.shape[0] // 16
    send = torch.ones((1,), dtype=torch.int32, device=y.device)
    ref = [torch.empty_like(p) for p in (y, u, v)]
    lv, cbp, hdr_pay, hdr_nb = mb_encode_i(y, u, v, qp, send, R, *ref)
    ev_pay, ev_nb = cavlc_events(lv, cbp, True)
    st = pack_stream(hdr_pay, hdr_nb, ev_pay, ev_nb, hp, hn, idr, qp, True,
                     e_cap, w_cap, R * w_cap * 4)
    out = H264FrameOut(st.words, st.total_bits, st.flags[0] != 0, R)
    return (out, tuple(ref)) if want_recon else out


def _encode_p_frame(ops: StepOps, yf, uf, vf, ref_y, ref_u, ref_v, qp,
                    header_pay, header_nb, frame_num, e_cap: int, w_cap: int,
                    candidates: tuple, stripe_rows, precomputed_motion,
                    qp_mb, device):
    """The P frame entries of both chroma formats over ``ops``."""
    (y, u, v), qp, hp, hn, fn = _frame_args(yf, uf, vf, qp, header_pay,
                                            header_nb, frame_num, device)
    R, M = y.shape[0] // 16, y.shape[1] // 16
    dev = y.device
    send = torch.ones((R,), dtype=torch.int32, device=dev)
    ref = [_as_tensor(p, dev).to(torch.uint8).clone()
           for p in (ref_y, ref_u, ref_v)]
    if qp_mb is not None:
        qp_mb = _as_tensor(qp_mb, dev).to(torch.int32).contiguous()
    pred = None
    if precomputed_motion is not None:
        *planes, mv = precomputed_motion
        pred = (*(_as_tensor(p, dev).to(torch.uint8).contiguous()
                  for p in planes),
                _as_tensor(mv, dev).to(torch.int32).reshape(R, M, 2)
                .contiguous())
    lv, cbp, hdr_pay, hdr_nb = p_rows(
        ops, y, u, v, qp, send, ref,
        candidates if len(candidates) > 1 else None, 16 * (stripe_rows or R),
        qp_mb=qp_mb, pred=pred)
    ev_pay, ev_nb = ops.cavlc_events(lv, cbp, False)
    st = ops.pack_stream(hdr_pay, hdr_nb, ev_pay, ev_nb, hp, hn, fn, qp,
                         False, e_cap, w_cap, R * w_cap * 4)
    return H264FrameOut(st.words, st.total_bits, st.flags[0] != 0, R), \
        tuple(ref)


def h264_encode_p_yuv(yf, uf, vf, ref_y, ref_u, ref_v, qp, header_pay,
                      header_nb, frame_num, e_cap: int, w_cap: int,
                      candidates: tuple = ((0, 0),),
                      stripe_rows: int | None = None,
                      precomputed_motion=None, qp_mb=None, device=None):
    """The reference's plane-layout P encoder, through the main path's
    kernels: K5 when ``candidates`` holds more than the zero vector (its
    windows are ``16 * (stripe_rows or R)`` rows), then K2 -> K3 -> K4,
    with K18 after K2 when a ``qp_mb`` (R, M) per-MB QP plane (ROI QP)
    is given. ``precomputed_motion`` = (pred_y, pred_u, pred_v, mv)
    skips the search. The reference planes are copied, not updated.
    ``device`` as for :func:`h264_encode_yuv`."""
    return _encode_p_frame(KERNEL_OPS, yf, uf, vf, ref_y, ref_u, ref_v, qp,
                           header_pay, header_nb, frame_num, e_cap, w_cap,
                           candidates, stripe_rows, precomputed_motion,
                           qp_mb, device)
