"""The 8x8 DCT-II matrix and the JPEG zigzag order, as numpy constants.

Copied from selkies_tpu/ops/dct.py (``dct8_matrix``, ``zigzag_order``),
which imports jax; the port's JPEG forward (ops/jpeg_planes.py), its JFIF
writer (codecs/jpeg.py) and the CUDA tables header take them from here.
The reference's block-layout transforms in that module are its own
oracles and have no counterpart in the port.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.cache
def dct8_matrix() -> np.ndarray:
    """Orthonormal 8-point DCT-II matrix (float32), D @ D.T = I."""
    k = np.arange(8)
    n = np.arange(8)
    m = np.cos((2 * n[None, :] + 1) * k[:, None] * np.pi / 16.0)
    m[0, :] *= 1.0 / np.sqrt(2.0)
    m *= 0.5
    return m.astype(np.float32)


@functools.cache
def zigzag_order() -> np.ndarray:
    """JPEG zigzag scan: zz[i] = raster index of the i-th zigzag position."""
    # Odd anti-diagonals run top-right -> bottom-left (order by row), even
    # ones bottom-left -> top-right (order by column).
    order = sorted(
        ((r, c) for r in range(8) for c in range(8)),
        key=lambda rc: (rc[0] + rc[1],
                        rc[0] if (rc[0] + rc[1]) % 2 else rc[1]),
    )
    return np.array([r * 8 + c for r, c in order], dtype=np.int32)
