"""Colour conversion of the port against the JAX package, exact.

rgb_to_ycbcr must reproduce XLA:CPU's float32 rounding bit for bit, and
rgb_to_yuv420 its Y/U/V planes; the frames include ones built so the
luma, Cb and Cr values (and the 2x2 chroma means) sit within 1e-4 of a
.5 tie, where any other summation order or a fused multiply-add in
another place would round the other way. Tolerance: 0 (bitwise floats,
exact integers).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from selkies_tpu.ops import colorspace as JC
from selkies_tpu.ops import h264_planes as JP
from selkies_tpu_torch.ops import colorspace as TC
from selkies_tpu_torch.ops import h264_planes as TP

torch.set_num_threads(1)

_j_ycc = jax.jit(JC.rgb_to_ycbcr)
_j_yuv = jax.jit(JP.rgb_to_yuv420)


def _tie_frame(seed: int, h: int = 64, w: int = 128) -> np.ndarray:
    """Pixels whose exact Y, Cb or Cr lies within 1e-4 of k + 0.5, each
    repeated over a 2x2 quad so the chroma mean keeps the tie."""
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (1 << 21, 3)).astype(np.float64)
    m = TC._CSC_601_FULL.astype(np.float64)
    off = TC._CSC_601_OFFSET.astype(np.float64)
    ycc = rgb @ m.T + off
    near = np.abs(ycc - np.floor(ycc) - 0.5) < 1e-4
    picks = [rgb[near[:, c]] for c in range(3)]
    n = (h // 2) * (w // 2)
    sel = np.concatenate([p[: n // 3 + 1] for p in picks])[:n]
    assert len(sel) == n, "not enough near-tie triples"
    quads = sel.reshape(h // 2, w // 2, 3).astype(np.uint8)
    return np.repeat(np.repeat(quads, 2, 0), 2, 1)


def _random_frame(seed, h, w):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


FRAMES = ([("random", s, hw) for s in (0, 1) for hw in
           ((16, 16), (64, 64), (48, 96), (128, 256))]
          + [("ties", s, (64, 128)) for s in (0, 1, 2)])


def _frame(kind, seed, hw):
    return _tie_frame(seed, *hw) if kind == "ties" \
        else _random_frame(seed, *hw)


@pytest.mark.parametrize("kind,seed,hw", FRAMES)
def test_rgb_to_ycbcr_bitwise(kind, seed, hw):
    rgb = _frame(kind, seed, hw)
    ref = np.asarray(_j_ycc(jnp.asarray(rgb)))
    got = TC.rgb_to_ycbcr(torch.from_numpy(rgb)).numpy()
    assert got.dtype == ref.dtype
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("kind,seed,hw", FRAMES)
def test_rgb_to_yuv420_exact(kind, seed, hw):
    rgb = _frame(kind, seed, hw)
    ref = [np.asarray(a) for a in _j_yuv(jnp.asarray(rgb))]
    got = [a.numpy() for a in TP.rgb_to_yuv420(torch.from_numpy(rgb))]
    for r, g in zip(ref, got):
        assert g.dtype == np.int32 and np.array_equal(r, g)


def test_tie_frames_really_sit_on_ties():
    """The built frames exercise the rounding: a good share of their
    float values is within 1e-3 of .5 in every channel."""
    ycc = TC.rgb_to_ycbcr(torch.from_numpy(_tie_frame(0))).numpy()
    frac = np.abs(ycc - np.floor(ycc) - 0.5)
    assert all((frac[..., c] < 1e-3).mean() > 0.2 for c in range(3))


@pytest.mark.parametrize("stripes", [1, 2, 4])
def test_csc420_damage_plain(stripes):
    """K1's plain version: the planes of rgb_to_yuv420 as uint8, one
    damage flag per stripe, and prev overwritten with the frame."""
    H, W = 64, 48
    prev = _random_frame(3, H, W)
    frame = prev.copy()
    frame[H - 3, 5, 1] ^= 1                        # last stripe damaged
    tp, tf = torch.from_numpy(prev.copy()), torch.from_numpy(frame)
    y, u, v, dmg = TP.csc420_damage(tf, tp, stripes)
    ref = [np.asarray(a) for a in _j_yuv(jnp.asarray(frame))]
    for r, g in zip(ref, (y, u, v)):
        assert g.dtype == torch.uint8 and np.array_equal(r, g.numpy())
    assert dmg.tolist() == [0] * (stripes - 1) + [1]
    assert np.array_equal(tp.numpy(), frame)
