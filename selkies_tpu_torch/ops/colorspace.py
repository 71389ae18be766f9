"""RGB -> YCbCr (BT.601 full range) with the reference's float order.

The counterpart of selkies_tpu/ops/colorspace.py:rgb_to_ycbcr. The
reference contracts ``hwc,yc->hwy`` with ``Precision.HIGHEST`` under XLA;
on XLA:CPU that rounds Y and Cb as ``((r*m0 + g*m1) + b*m2) + off`` with
every operation rounded to float32, and Cr as
``fma(b, m2, fma(g, m1, r*m0)) + off`` (found by comparing the two orders
on random frames and on frames built to land on .5 ties; the tests hold
the port to the reference on both). The plain version pins that order
here; the CUDA kernel (csrc/csc420_damage.cu) pins the same order with
``__fmul_rn``/``__fadd_rn``/``__fmaf_rn``.

The JPEG step (ops/jpeg_planes.py) compiles to another XLA fusion and
was checked on its own, with quantisation tables of 1/16 that expose one
ulp of the transform: its CSC rounds in the same order, and its 4:2:0
chroma (:func:`subsample_420`, a float mean that is not rounded) sums
``(a00 + a01) + (a10 + a11)`` before the exact ``* 0.25``. K7
(csrc/jpeg_forward.cu) pins both.
"""

from __future__ import annotations

import numpy as np
import torch

# BT.601 full-range (JFIF), float32. y = Kr*R + Kg*G + Kb*B, Cb/Cr centred
# at +128.
_CSC_601_FULL = np.array(
    [
        [0.299, 0.587, 0.114],
        [-0.168735892, -0.331264108, 0.5],
        [0.5, -0.418687589, -0.081312411],
    ],
    dtype=np.float32,
)
_CSC_601_OFFSET = np.array([0.0, 128.0, 128.0], dtype=np.float32)


def _fma_f32(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """float32 fused multiply-add: one rounding of the exact a*b + c.
    Exact through float64 for these operands (a: 8-bit integers, b and c:
    float32 values below 2^9), so float64 rounding never double-rounds."""
    return (a.to(torch.float64) * float(b)
            + c.to(torch.float64)).to(torch.float32)


def rgb_to_ycbcr(rgb: torch.Tensor, standard: str = "bt601-full"
                 ) -> torch.Tensor:
    """(H, W, 3) uint8 RGB -> (H, W, 3) float32 YCbCr (not level-shifted)."""
    if standard != "bt601-full":
        raise NotImplementedError(
            f"{standard!r}: the port implements BT.601 full range only")
    x = rgb.to(torch.float32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    m, off = _CSC_601_FULL, _CSC_601_OFFSET
    out = []
    for c in range(2):
        out.append(((r * float(m[c, 0]) + g * float(m[c, 1]))
                    + b * float(m[c, 2])) + float(off[c]))
    cr = _fma_f32(b, m[2, 2], _fma_f32(g, m[2, 1], r * float(m[2, 0])))
    out.append(cr + float(off[2]))
    return torch.stack(out, dim=-1)


def subsample_420(plane: torch.Tensor) -> torch.Tensor:
    """(H, W) float32 -> (H/2, W/2) by the 2x2 mean, summed
    ``(a00 + a01) + (a10 + a11)`` in float32 (the reference's order on
    XLA:CPU), then times 0.25 (exact)."""
    a00, a01 = plane[0::2, 0::2], plane[0::2, 1::2]
    a10, a11 = plane[1::2, 0::2], plane[1::2, 1::2]
    return ((a00 + a01) + (a10 + a11)) * 0.25


def split_ycbcr_420(ycbcr: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(H, W, 3) -> Y (H,W), Cb (H/2,W/2), Cr (H/2,W/2)."""
    return (ycbcr[..., 0], subsample_420(ycbcr[..., 1]),
            subsample_420(ycbcr[..., 2]))
