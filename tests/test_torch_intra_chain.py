"""K2-I's cut DC / left-edge chain against the JAX package's.

The kernel (selkies_tpu_torch/csrc/mb_encode.cu, the I section) walks
each MB row's Intra16x16 chains with only the terms that depend on the
prediction. Its first grid computes, for each MB, (H W H)00 >> 1, the 15
pred-free luma DC levels and their inverse Frest (rows in a lane, columns
by butterflies over four lanes), and for each chroma component A + C,
A - C and levels 1 and 3; its chains then take level00 from
(H W H)00 >> 1 - 128 pred, the right column's DC terms as
dequant(Frest + level00), and chroma levels 0 and 2 from
A + C - 32 (pt + pb) and A - C - 32 (pt - pb); its coding grid redoes
the luma terms by butterflies over an MB's 16 lanes. This numpy model of
those steps, in the kernel's order and lane layout, is held against
selkies_tpu.ops.h264_planes._dc_scan on the same inputs: every DC level
and prediction, tolerance 0 (moderate inputs as the plane tests use,
and extremes: DC terms at 0 and 4080, edges of +-2^20, QPs 0 and 51).
"""

import numpy as np
import pytest

import jax

from selkies_tpu.ops import h264_planes as JP
from selkies_tpu_torch.ops import h264_planes as TP

R, M = 3, 7
SIG = (0, 3, 1, 2)                 # lane p of a butterfly holds H's row SIG[p]
MF = np.asarray(TP._MF).reshape(6, 3)
V = np.asarray(TP._V).reshape(6, 3)


def quant_dc(y, qp):
    qd, qm = qp // 6, qp % 6
    mag = (abs(y) * int(MF[qm, 0]) + 2 * ((1 << (15 + qd)) // 3)) >> (16 + qd)
    return max(-2000, min(2000, -mag if y < 0 else mag))


def dequant_ldc(f, qp):
    ls, t = 16 * int(V[qp % 6, 0]), qp // 6
    return f * ls * (1 << (t - 6)) if t >= 6 else (f * ls + (1 << (5 - t))) >> (6 - t)


def dequant_cdc(f, qpc):
    return (f * 16 * int(V[qpc % 6, 0]) * (1 << (qpc // 6))) >> 5


def had4_vec(d):
    """H4 x with H4's rows ++++, ++--, +--+, +-+-."""
    s0, s1, t0, t1 = d[0] + d[1], d[2] + d[3], d[0] - d[1], d[2] - d[3]
    return [s0 + s1, s0 - s1, t0 - t1, t0 + t1]


def butterflies(vals, masks):
    """The kernel's butterfly steps over lanes (natural Hadamard order):
    the lane with bit m clear gets v + partner, the other partner - v."""
    v = list(vals)
    for m in masks:
        v = [v[l ^ m] - v[l] if l & m else v[l] + v[l ^ m]
             for l in range(len(v))]
    return v


def records(dc_y, dc_c, ey, ec, qp, qpc, m):
    """The first grid's record of MB m of one row."""
    rows = [had4_vec([int(x) for x in dc_y[by, m]]) for by in range(4)]
    h = [[0] * 4 for _ in range(4)]        # lane by: H W H row SIG[by]
    for k in range(4):
        col = butterflies([rows[by][k] for by in range(4)], (1, 2))
        for by in range(4):
            h[by][k] = col[by]
    lv = [[0 if (by == 0 and k == 0) else quant_dc(h[by][k] >> 1, qp)
           for k in range(4)] for by in range(4)]
    s = [had4_vec(lv[by]) for by in range(4)]
    frest = [[0] * 4 for _ in range(4)]    # lane by: Frest row by
    for k in range(4):
        col = butterflies([s[by][k] for by in range(4)], (1, 2))
        for by in range(4):
            frest[by][k] = col[by]
    luma = dict(h00=h[0][0] >> 1, f3=[frest[by][3] for by in range(4)],
                ey=[[int(ey[by, m, i]) + 32 for i in range(4)]
                    for by in range(4)],
                levels={(SIG[by], k): lv[by][k]
                        for by in range(4) for k in range(4)},
                frest=frest)
    chroma = []
    for c in range(2):
        x = dc_c[c, :, m].astype(np.int64)         # [by2][bx2]
        a, b = x[0, 0] + x[0, 1], x[0, 0] - x[0, 1]
        cc, d = x[1, 0] + x[1, 1], x[1, 0] - x[1, 1]
        chroma.append(dict(s0=int(a + cc), s2=int(a - cc),
                           l1=quant_dc(int(b + d), qpc),
                           l3=quant_dc(int(b - d), qpc),
                           ec=[[int(ec[c, h2, m, i]) + 32 for i in range(4)]
                               for h2 in range(2)]))
    return luma, chroma


def clip1(x):
    return max(0, min(255, x))


def cut_chain(dc_y, dc_c, ey, ec, qp, qpc):
    """One row through the kernel's steps -> _dc_scan's outputs."""
    dl_out = np.zeros((M, 4, 4), np.int64)
    cl_out = np.zeros((M, 2, 2, 2), np.int64)
    py_out = np.zeros(M, np.int64)
    pc_out = np.zeros((M, 2, 2), np.int64)
    pred, pt, pb = 128, [128, 128], [128, 128]
    for m in range(M):
        luma, chroma = records(dc_y, dc_c, ey, ec, qp, qpc, m)
        dl = quant_dc(luma["h00"] - 128 * pred, qp)
        s = 0
        for by in range(4):
            dq = dequant_ldc(luma["f3"][by] + dl, qp)
            s += sum(clip1(pred + ((e + dq) >> 6)) for e in luma["ey"][by])
        for (i, j), v in luma["levels"].items():
            dl_out[m, i, j] = dl if (i, j) == (0, 0) else v
        py_out[m] = pred
        pred = (s + 8) >> 4
        for c in range(2):
            r = chroma[c]
            l0 = quant_dc(r["s0"] - 32 * (pt[c] + pb[c]), qpc)
            l2 = quant_dc(r["s2"] - 32 * (pt[c] - pb[c]), qpc)
            a, b = l0 - r["l1"], l2 - r["l3"]
            dq1, dq3 = dequant_cdc(a + b, qpc), dequant_cdc(a - b, qpc)
            st = sum(clip1(pt[c] + ((e + dq1) >> 6)) for e in r["ec"][0])
            sb = sum(clip1(pb[c] + ((e + dq3) >> 6)) for e in r["ec"][1])
            cl_out[m, c] = [[l0, r["l1"]], [l2, r["l3"]]]
            pc_out[m, c] = [pt[c], pb[c]]
            pt[c], pb[c] = (st + 2) >> 2, (sb + 2) >> 2
    return dl_out, cl_out, py_out, pc_out


def coding_terms(dc_y, qp, m):
    """The coding grid's luma DC terms of MB m: butterflies over the MB's
    16 lanes (raster block b), the pred-free levels at lane (p, q) =
    H's (SIG[p], SIG[q]), then Frest back at natural (by, bx)."""
    w = [int(dc_y[b >> 2, m, b & 3]) for b in range(16)]
    v = butterflies(w, (1, 2, 4, 8))
    lv = [0 if b == 0 else quant_dc(v[b] >> 1, qp) for b in range(16)]
    f = butterflies(lv, (1, 2, 4, 8))
    return ({(SIG[b >> 2], SIG[b & 3]): lv[b] for b in range(16)},
            [[f[4 * by + bx] for bx in range(4)] for by in range(4)])


def inputs(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "moderate":
        dc_y = rng.integers(0, 4081, (R, 4, M, 4))
        dc_c = rng.integers(0, 4081, (R, 2, 2, M, 2))
        ey = rng.integers(-400, 400, (R, 4, M, 4))
        ec = rng.integers(-400, 400, (R, 2, 2, M, 4))
    else:
        dc_y = rng.choice([0, 4080], (R, 4, M, 4))
        dc_c = rng.choice([0, 4080], (R, 2, 2, M, 2))
        ey = rng.choice([-(1 << 20), 0, 1 << 20], (R, 4, M, 4))
        ec = rng.choice([-(1 << 20), 0, 1 << 20], (R, 2, 2, M, 4))
    return [a.astype(np.int32) for a in (dc_y, dc_c, ey, ec)]


@pytest.mark.parametrize("kind", ["moderate", "extreme"])
@pytest.mark.parametrize("qps", [(0, 0, 0), (51, 51, 51), (28, 28, 28),
                                 (8, 33, 47)])
def test_cut_chain_equals_dc_scan(kind, qps):
    dc_y, dc_c, ey, ec = inputs(kind, sum(qps) + len(kind))
    qp = np.asarray(qps, np.int32)
    qpc = np.asarray(JP._QPC_J[np.clip(qp, 0, 51)])
    ref = [np.asarray(a) for a in jax.jit(JP._dc_scan, static_argnums=(0, 1))(
        R, M, dc_y, dc_c, ey, ec, qp, qpc)]
    for r in range(R):
        got = cut_chain(dc_y[r], dc_c[r], ey[r], ec[r], int(qp[r]),
                        int(qpc[r]))
        for g, want in zip(got, ref):
            assert np.array_equal(g, want[r].astype(np.int64))


@pytest.mark.parametrize("kind", ["moderate", "extreme"])
@pytest.mark.parametrize("qp", [0, 28, 51])
def test_coding_grid_terms_equal_the_records(kind, qp):
    """The coding grid's 16-lane butterflies give the first grid's
    pred-free levels and Frest (4 lanes, rows in a lane) MB for MB."""
    dc_y, dc_c, ey, ec = inputs(kind, qp + 3)
    for m in range(M):
        luma, _ = records(dc_y[0], dc_c[0], ey[0], ec[0], qp, qp, m)
        levels, frest = coding_terms(dc_y[0], qp, m)
        assert levels == luma["levels"]
        assert frest == luma["frest"]
