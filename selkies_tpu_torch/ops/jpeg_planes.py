"""Plane-layout JPEG forward transform in PyTorch, and its CUDA kernel.

The counterpart of selkies_tpu/ops/jpeg_planes.py: RGB -> BT.601
full-range YCbCr (4:2:0 or 4:4:4) -> level shift -> separable 8x8 DCT
-> divide by the raster-order quantisation table -> round half away
from zero -> zigzag, giving (N, 64) int16 rows in plane-raster block
order, the contract the entropy stage consumes.

The reference is float32 and its rounding follows XLA:CPU's code
generation, which was read off the compiled reference and checked with
quantisation tables of 1/16 (so that one ulp of a coefficient shows):

- the CSC and the 4:2:0 chroma mean as in ops/colorspace.py;
- every 8-term DCT chain ``d0*x0 + d1*x1 + ... + d7*x7`` is contracted
  into fused multiply-adds, the FIRST product fused and the second
  rounded: ``fma(d7, x7, ... fma(d2, x2, fma(d0, x0, d1*x1)))``, in both
  the column and the row pass;
- the quotient is a true float32 division and the rounding
  ``trunc(q + sign(q) * 0.5)`` in float32 (not ``roundf``: they differ at
  q = 0.49999997).

The plain version reproduces the fused multiply-adds exactly (float64
with round-to-odd, then one rounding to float32); K7 ``jpeg_forward``
(csrc/jpeg_forward.cu) pins the same order with
``__fmul_rn``/``__fadd_rn``/``__fmaf_rn``/``__fdiv_rn``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda
from .colorspace import rgb_to_ycbcr, split_ycbcr_420
from .dct import dct8_matrix, zigzag_order
from .h264_encode import _check, _on_cpu

_D = dct8_matrix()
_ZZ = zigzag_order()


def _fma32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """float32 fused multiply-add, rounded once, for float32 operands:
    the product is exact in float64, the sum is rounded to odd with its
    exact error (TwoSum), and a float64 rounded to odd rounds to float32
    correctly (53 >= 2 * 24 + 2 bits)."""
    p = a.to(torch.float64) * (b.to(torch.float64)
                               if isinstance(b, torch.Tensor) else b)
    cd = c.to(torch.float64)
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _chain(ds, xs):
    """``fma(d7, x7, ... fma(d2, x2, fma(d0, x0, d1*x1)))``; ``ds`` are
    float32 tensors (or values) broadcasting against ``xs``."""
    acc = _fma32(xs[0], ds[0], xs[1] * ds[1])
    for d, x in zip(ds[2:], xs[2:]):
        acc = _fma32(x, d, acc)
    return acc


def _dct_planes(plane: torch.Tensor) -> torch.Tensor:
    """(H, W) centred float32 -> (8, 8, H/8, W/8) coefficient planes:
    coef[i, j, y, x] = DCT(block (y, x))[i, j]. Separable: tmp[i][b] =
    sum_a D[i, a] X[a][b], then coef[i][j] = sum_b D[j, b] tmp[i][b]."""
    h, w = plane.shape
    x = plane.reshape(h // 8, 8, w // 8, 8).permute(1, 3, 0, 2)  # [a,b]
    d = torch.as_tensor(_D, device=plane.device)
    di = [d[:, a].reshape(8, 1, 1, 1) for a in range(8)]        # over i
    tmp = _chain(di, [x[a][None] for a in range(8)])            # [i,b]
    dj = [d[:, b].reshape(1, 8, 1, 1) for b in range(8)]        # over j
    return _chain(dj, [tmp[:, b:b + 1] for b in range(8)])      # [i,j]


def _quant_zigzag_planes(coef: torch.Tensor, qt: torch.Tensor
                         ) -> torch.Tensor:
    """(8, 8, Hb, Wb) coefficient planes -> (Hb*Wb, 64) int16 zigzag rows
    (plane-raster block order). ``qt`` is a raster-order table, (64,),
    or one per block row, (Hb, 64)."""
    hb, wb = coef.shape[2], coef.shape[3]
    zz = torch.as_tensor(_ZZ, dtype=torch.int64, device=coef.device)
    c = coef.reshape(64, hb, wb)[zz]
    qt = qt.to(torch.float32)
    qz = qt[zz][:, None, None] if qt.dim() == 1 else qt[:, zz].T[:, :, None]
    q = c / qz
    r = torch.trunc(q + torch.sign(q) * 0.5).to(torch.int16)
    return r.permute(1, 2, 0).reshape(hb * wb, 64).contiguous()


def _forward_plane(plane: torch.Tensor, qtable: torch.Tensor
                   ) -> torch.Tensor:
    return _quant_zigzag_planes(_dct_planes(plane - 128.0), qtable)


def jpeg_forward_420(rgb: torch.Tensor, qy, qc):
    """(H, W, 3) uint8 RGB -> (Ny,64), (Nc,64), (Nc,64) int16 zigzag
    coefficients; ``qy``/``qc`` raster-order tables, (64,) or one per
    block row of their plane."""
    y, cb, cr = split_ycbcr_420(rgb_to_ycbcr(rgb))
    return tuple(_forward_plane(p, torch.as_tensor(q, device=rgb.device))
                 for p, q in ((y, qy), (cb, qc), (cr, qc)))


def jpeg_forward_444(rgb: torch.Tensor, qy, qc):
    """4:4:4 variant (``fullcolor``): H, W multiples of 8."""
    ycc = rgb_to_ycbcr(rgb)
    return tuple(_forward_plane(ycc[..., ci],
                                torch.as_tensor(q, device=rgb.device))
                 for ci, q in ((0, qy), (1, qc), (2, qc)))


# ---------------------------------------------------------------------------
# K7: the step's forward, per-stripe tables, prev <- frame
# ---------------------------------------------------------------------------

def _out_shapes(H: int, W: int, subsampling: str):
    ny = (H // 8) * (W // 8)
    nc = ny // 4 if subsampling == "420" else ny
    return (ny, 64), (nc, 64)


def jpeg_forward_plain(frame, prev, tab, qtables, subsampling: str):
    """(H, W, 3) uint8 frame -> (y, cb, cr) int16 zigzag rows over the
    whole frame (plane-raster block order; a stripe's blocks are one
    contiguous run). Stripe s quantises with tables
    ``qtables[2 * tab[s]]`` (luma) and ``qtables[2 * tab[s] + 1]``
    (chroma); ``qtables`` is (4, 64) float32, raster order, [luma motion,
    chroma motion, luma paint, chroma paint]. ``prev`` is overwritten
    with ``frame`` (the reference's ``prev_out``)."""
    H = frame.shape[0]
    S = tab.shape[0]
    rows_y = H // 8 // S
    rows_c = rows_y // 2 if subsampling == "420" else rows_y
    t = tab.to(torch.int64)
    qy = qtables[2 * t].repeat_interleave(rows_y, 0)
    qc = qtables[2 * t + 1].repeat_interleave(rows_c, 0)
    fwd = jpeg_forward_420 if subsampling == "420" else jpeg_forward_444
    out = fwd(frame, qy, qc)
    prev.copy_(frame)
    return out


def jpeg_forward(frame, prev, tab, qtables, subsampling: str):
    """K7 (csrc/jpeg_forward.cu) for CUDA tensors, else
    :func:`jpeg_forward_plain`; same contract."""
    H, W = frame.shape[0], frame.shape[1]
    dev = frame.device
    S = tab.shape[0]
    mcu = 16 if subsampling == "420" else 8
    _check(frame, "frame", torch.uint8, (H, W, 3), dev)
    _check(prev, "prev", torch.uint8, (H, W, 3), dev)
    _check(tab, "tab", torch.int32, (S,), dev)
    _check(qtables, "qtables", torch.float32, (4, 64), dev)
    if subsampling not in ("420", "444"):
        raise ValueError(f"subsampling {subsampling!r}")
    if W % mcu or H % S or (H // S) % mcu:
        raise ValueError(f"frame must split into stripes of whole "
                         f"{mcu}x{mcu} MCUs")
    if _on_cpu(frame):
        return jpeg_forward_plain(frame, prev, tab, qtables, subsampling)
    sy, sc = _out_shapes(H, W, subsampling)
    y = torch.empty(sy, dtype=torch.int16, device=dev)
    cb = torch.empty(sc, dtype=torch.int16, device=dev)
    cr = torch.empty(sc, dtype=torch.int16, device=dev)
    _cuda.launch("jpeg_forward", frame, prev, tab, qtables, y, cb, cr, H, W,
                 S, int(subsampling == "444"))
    return y, cb, cr
