"""The port's scroll motion search against the JAX package.

``scroll_candidates``, the MV lambda and ``se_bits`` equal the
reference's; ``motion_select_plain`` (the plain version of kernel K5)
equals ``_motion_select`` in the prediction planes and the MV field on
scrolled and panned textures at 64x128 with 32-row windows: clamping at
the window (stripe) edges and the picture's right edge, odd negative
vertical offsets, per-row qp lambda and a flat region where the zero
vector must win the tie. The frame entry ``h264_encode_p_yuv`` with
``candidates`` and ``stripe_rows`` equals the reference's in words, bit
totals and reconstruction, on a frame with pure-motion macroblocks (no
residual) and neighbouring macroblocks with different non-zero vectors.
A reduced candidate set (vrange 4, hrange 2) keeps the JAX compiles
short; one case runs the 57-candidate default, and a one-MB-wide frame
with 16-row windows runs one candidate and the widest set K5 takes (128
candidates, |dy| and |dx| up to 64) on texture, a flat frame and per-row
qp at and out of its range. Tolerance: 0.
"""

import numpy as np
import pytest
import torch

import jax

from selkies_tpu.codecs import h264 as jcodec
from selkies_tpu.ops import h264_encode as JE
from selkies_tpu.ops import h264_planes as JP
from selkies_tpu_torch.ops import h264_encode as TE
from selkies_tpu_torch.ops import h264_planes as TP

torch.set_num_threads(1)

H, W, WIN = 64, 128, 32
R, M = H // 16, W // 16
SMALL = TE.scroll_candidates(4, 2)
DEFAULT = TE.scroll_candidates()
E_CAP = 9 + M * 879 + 2
W_CAP = 2048
P_HDR = jcodec.p_slice_header_events(M, R)

_j_select = jax.jit(JE._motion_select, static_argnums=(5, 6))
_j_p = jax.jit(lambda y, u, v, ry, ru, rv, qp, fn: JP.h264_encode_p_yuv(
    y, u, v, ry, ru, rv, qp, *P_HDR, fn, E_CAP, W_CAP, candidates=SMALL,
    stripe_rows=WIN // 16))


@pytest.mark.parametrize("vr,hr", [(0, 0), (4, 2), (24, 8), (3, 5),
                                   (1, 16)])
def test_scroll_candidates_equal_reference(vr, hr):
    assert TE.scroll_candidates(vr, hr) == JE.scroll_candidates(vr, hr)


def test_lambda_and_se_bits_equal_reference():
    assert TE.MV_LAMBDA_NP.dtype == JE.MV_LAMBDA_NP.dtype
    assert np.array_equal(TE.MV_LAMBDA_NP, JE.MV_LAMBDA_NP)
    for v in range(-200, 201):
        assert TE.se_bits(v) == JE.se_bits(v)


def _texture(seed, h=H, w=W):
    """Desktop-like luma: a gradient, text glyphs, a flat window."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = (40 + yy + xx // 2).astype(np.int32)
    glyphs = rng.integers(0, 2, (h // 2, w // 2)) * 180 + 30
    y[4:h - 4, 8:w - 24] = np.repeat(np.repeat(glyphs, 2, 0), 2, 1)[
        4:h - 4, 8:w - 24]
    y[20:44, w - 24:w - 4] = 220
    return np.clip(y, 0, 255).astype(np.uint8)


def _chroma(seed, h=H, w=W):
    rng = np.random.default_rng(seed)
    return [rng.integers(60, 200, (h // 2, w // 2)).astype(np.uint8)
            for _ in range(2)]


def _shift(p, dy, dx):
    """Content moves by (dy, dx): out(y, x) = p(y + dy, x + dx), wrapped."""
    return np.roll(np.roll(p, -dy, 0), -dx, 1)


def _case(name):
    """-> (cur_y, ref_y, ref_u, ref_v, qp (R,))."""
    ref = _texture(1)
    ru, rv = _chroma(2)
    qp = np.full(R, 28, np.int32)
    if name == "scroll_down4":
        cur = _shift(ref, 4, 0)
    elif name == "scroll_up3":            # odd negative dy: by -2, fy 1
        cur = _shift(ref, -3, 0)
    elif name == "pan_right2":            # right-edge clamp
        cur = _shift(ref, 0, 2)
    elif name == "pan_left1":
        cur = _shift(ref, 0, -1)
    elif name == "mixed":                 # neighbours: scroll | pan
        cur = _shift(ref, -3, 0)
        cur[:, W // 2:] = _shift(ref, 0, 2)[:, W // 2:]
    elif name == "per_row_qp":
        cur = _shift(ref, 1, 0)
        cur[::7] = 255 - cur[::7]
        qp = np.array([0, 51, 20, 35], np.int32)
    elif name == "flat":                  # every SAD equal: zero wins
        ref = np.full((H, W), 128, np.uint8)
        cur = np.full((H, W), 131, np.uint8)
    elif name == "scroll_down17":         # the default 57 candidates
        cur = _shift(ref, 17, 0)
    else:
        raise KeyError(name)
    return cur, ref, ru, rv, qp


CASES = ["scroll_down4", "scroll_up3", "pan_right2", "pan_left1", "mixed",
         "per_row_qp", "flat"]


def _select_both(name, cands):
    cur, ref, ru, rv, qp = _case(name)
    jo = _j_select(cur.astype(np.int32), ref.astype(np.int32),
                   ru.astype(np.int32), rv.astype(np.int32), qp, cands, WIN)
    to = TE.motion_select_plain(*(torch.from_numpy(a) for a in
                                  (cur, ref, ru, rv, qp)), cands, WIN)
    return jo, to


@pytest.mark.parametrize("name", CASES)
def test_motion_select_equals_reference(name):
    jo, to = _select_both(name, SMALL)
    for j, t in zip(jo, to):
        assert t.shape == j.shape
        assert np.array_equal(t.numpy().astype(np.int64),
                              np.asarray(j).astype(np.int64)), name
    mv = to[3].numpy()
    if name == "flat":
        assert not mv.any()
    elif name == "scroll_up3":
        assert (mv[..., 1] == -12).sum() > R * M // 2
    elif name == "pan_right2":
        assert (mv[..., 0] == 8).sum() > R * M // 2


def test_motion_select_default_candidates():
    """The 57-candidate default (vrange 24, hrange 8) on a 17-row
    scroll: odd offsets, clamping at both window edges."""
    jo, to = _select_both("scroll_down17", DEFAULT)
    for j, t in zip(jo, to):
        assert np.array_equal(t.numpy().astype(np.int64),
                              np.asarray(j).astype(np.int64))
    assert (to[3].numpy()[..., 1] == 68).any()


def test_motion_select_wrapper_on_cpu_writes_out():
    """On CPU tensors the K5 wrapper runs the plain version, into the
    caller's scratch when given."""
    cur, ref, ru, rv, qp = (torch.from_numpy(a) for a in _case("mixed"))
    out = (torch.zeros((H, W), dtype=torch.uint8),
           torch.zeros((H // 2, W // 2), dtype=torch.uint8),
           torch.zeros((H // 2, W // 2), dtype=torch.uint8),
           torch.zeros((R, M, 2), dtype=torch.int32))
    got = TE.motion_select(cur, ref, ru, rv, qp, SMALL, WIN, out=out)
    want = TE.motion_select_plain(cur, ref, ru, rv, qp, SMALL, WIN)
    assert all(g is o for g, o in zip(got, out))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        TE.motion_select(cur, ref, ru, rv, qp, ((0, 0), (65, 0)), WIN)
    with pytest.raises(ValueError):
        TE.motion_select(cur, ref, ru, rv, qp, SMALL, 48)


def _frame(name):
    """(cur planes, ref planes) for the frame entry: the luma of _case
    with a few changed pixels; the chroma is the chroma prediction of the
    luma's vectors, so macroblocks whose luma moved exactly carry no
    residual at all."""
    cur_y, ref_y, ref_u, ref_v, qp = _case(name)
    cur_y = cur_y.copy()
    cur_y[50:54, 100:104] = 0                  # residual in one MB
    _, cu, cv, _ = TE.motion_select_plain(
        *(torch.from_numpy(a) for a in (cur_y, ref_y, ref_u, ref_v, qp)),
        SMALL, WIN)
    return (cur_y, cu.numpy(), cv.numpy()), (ref_y, ref_u, ref_v)


@pytest.mark.parametrize("qp_case", ["qp28", "per_row"])
@pytest.mark.parametrize("name", ["mixed", "scroll_up3"])
def test_p_frame_with_motion_equals_reference(name, qp_case):
    cur, ref = _frame(name)
    qp = np.full(R, 28, np.int32) if qp_case == "qp28" \
        else np.array([12, 40, 28, 51], np.int32)
    fn = np.array([1, 2, 3, 15], np.int32)
    jout, jrec = _j_p(*(a.astype(np.int32) for a in cur), *ref, qp, fn)
    tout, trec = TP.h264_encode_p_yuv(*cur, *ref, qp, *P_HDR, fn, E_CAP,
                                      W_CAP, candidates=SMALL,
                                      stripe_rows=WIN // 16, device="cpu")
    assert np.array_equal(tout.words.numpy().view(np.uint32),
                          np.asarray(jout.words))
    assert np.array_equal(tout.total_bits.numpy(),
                          np.asarray(jout.total_bits))
    assert bool(tout.overflow) == bool(jout.overflow)
    for t, j in zip(trec, jrec):
        assert np.array_equal(t.numpy(), np.asarray(j))


def test_pure_motion_and_neighbouring_vectors():
    """The "mixed" frame has macroblocks coded with a non-zero vector and
    no residual (cbp 0: the recon IS the prediction) and left/right
    neighbours with different non-zero vectors (non-zero mvd); the
    reference planes after it equal the reference's, so no recon write
    reached a neighbour's prediction."""
    cur, ref = _frame("mixed")
    qp = torch.full((R,), 28, dtype=torch.int32)
    t = [torch.from_numpy(a) for a in cur + ref]
    *pred, mv = TE.motion_select_plain(t[0], *t[3:], qp, SMALL, WIN)
    rec = [a.clone() for a in t[3:]]
    _, cbp, hp, hn = TP.mb_encode_p_plain(
        *t[:3], qp, torch.ones(R, dtype=torch.int32), *pred, mv, *rec)
    nz = (mv != 0).any(-1)
    pure = nz & (cbp == 0)
    assert pure.any()
    r, m = [int(i) for i in torch.nonzero(pure)[0]]
    assert torch.equal(rec[0][16 * r:16 * r + 16, 16 * m:16 * m + 16],
                       pred[0][16 * r:16 * r + 16, 16 * m:16 * m + 16])
    diff_nb = nz[:, 1:] & nz[:, :-1] & (mv[:, 1:] != mv[:, :-1]).any(-1)
    assert diff_nb.any()
    # mvd slots carry more than se(0) where the vector changes
    assert (hn[:, 1:, 2:4].sum(-1) > 2)[diff_nb].all()
    _, jrec = _j_p(*(a.astype(np.int32) for a in cur), *ref, qp.numpy(),
                   np.ones(R, np.int32))
    for a, j in zip(rec, jrec):
        assert np.array_equal(a.numpy(), np.asarray(j))


#: the widest candidate set K5 takes: 128 candidates, |dy| and |dx| up to
#: 64, on a one-MB-wide frame with 16-row windows
WIDE_H, WIDE_W, WIDE_WIN = 64, 16, 16


def _wide_candidates(n, seed=13):
    """(0, 0), extremes at 64 and distinct random (dy, dx) with |dy|,
    |dx| <= 64: ``n`` candidates."""
    rng = np.random.default_rng(seed)
    c = [(0, 0), (64, 0), (-64, 0), (0, 64), (0, -64), (-64, 64)][:n]
    while len(c) < n:
        d = tuple(int(v) for v in rng.integers(-64, 65, 2))
        if d not in c:
            c.append(d)
    return tuple(c)


def _wide_case(case, seed=3):
    """-> (cur_y, ref_y, ref_u, ref_v, qp) at WIDE_H x WIDE_W."""
    rng = np.random.default_rng(seed)
    h, w = WIDE_H, WIDE_W
    ref = rng.integers(0, 256, (h, w)).astype(np.uint8)
    ru, rv = (rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
              for _ in range(2))
    cur = _shift(ref, 5, -3)
    qp = np.array([28, 20, 36, 12], np.int32)
    if case == "flat":                  # every SAD equal: the lambda rules
        ref = np.full((h, w), 90, np.uint8)
        cur = np.full((h, w), 97, np.uint8)
    elif case == "qp_range":            # clipped to 0 .. 51
        qp = np.array([0, 51, -9, 400], np.int32)
    return cur, ref, ru, rv, qp


@pytest.mark.parametrize("ncand", [1, 128])
@pytest.mark.parametrize("case", ["texture", "flat", "qp_range"])
def test_motion_select_widest_candidates_at_width_16(case, ncand):
    """One candidate, and 128 with |dy| and |dx| reaching 64 (the most K5
    takes), on a one-MB-wide frame (both width clamps at once) with 16-row
    windows far shorter than the shifts; a flat frame where every SAD
    ties; per-row qp at 0, 51 and out of range."""
    cands = ((-5, 3),) if ncand == 1 else _wide_candidates(ncand)
    cur, ref, ru, rv, qp = _wide_case(case)
    jo = _j_select(cur.astype(np.int32), ref.astype(np.int32),
                   ru.astype(np.int32), rv.astype(np.int32), qp, cands,
                   WIDE_WIN)
    to = TE.motion_select_plain(*(torch.from_numpy(a) for a in
                                  (cur, ref, ru, rv, qp)), cands, WIDE_WIN)
    for j, t in zip(jo, to):
        assert t.shape == j.shape
        assert np.array_equal(t.numpy().astype(np.int64),
                              np.asarray(j).astype(np.int64))
