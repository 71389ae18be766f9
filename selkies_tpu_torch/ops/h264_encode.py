"""Slot budgets and CAVLC event helpers shared by the plane-layout encoder.

The pieces of selkies_tpu/ops/h264_encode.py that ops/h264_planes.py
imports, in PyTorch: the static per-macroblock slot budgets, the level
clamp, the frame output tuple, the Exp-Golomb / level event builders,
the inter quantiser and the block-layout nC gathers. An event is a
(payload, nbits) pair with the codeword in the LOW ``nbits`` bits of the
payload; payloads are int64 here (uint32 has no shifts on the CPU).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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
