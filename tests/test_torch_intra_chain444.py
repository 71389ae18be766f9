"""K14's cut 4:4:4 DC / left-edge chains against the JAX package's.

The kernel (selkies_tpu_torch/csrc/mb_encode444.cu, the I section, with
csrc/intra_dc.cuh) walks each MB row's three Intra16x16 chains (Y at
qp, Cb and Cr at K_QPC[qp], each coded like luma) with only the terms
that depend on the prediction. Its first grid writes each MB's 64-int
record: component c's right edge's inverse + 32 at [16c, 16c + 16) (by
block row), Frest's right column at 48 + 4c and (H W H)00 >> 1 at 60 + c,
from the pred-free Hadamard terms (rows in a lane, columns by
butterflies over four lanes); its chain grid runs component c on 16
lanes of warp c, lane k reading its edge pixel's terms from that record:
level00 from (H W H)00 >> 1 - 128 pred, its block row's right-column DC
term as dequant(Frest + level00), the pixels' sum by one reduction; its
coding grid redoes the DC terms by butterflies over an MB's 16 lanes.
This numpy model of those steps, in the kernel's record and lane layout,
is held against selkies_tpu.ops.h264_planes444._dc_scan_comp on the
same inputs, component by component: every DC level and prediction,
tolerance 0 (moderate inputs and extremes: DC terms at 0 and 4080, edges
of +-2^20; qp 0, 28, 51 and mixed by row). A mutated model is checked to
fail, so the comparison can see a wrong step.
"""

import numpy as np
import pytest

import jax

from selkies_tpu.ops import h264_planes444 as JP4
from selkies_tpu_torch.ops import h264_planes as TP

R, M = 3, 7
REC = 64                           # ints of an MB's record
SIG = (0, 3, 1, 2)                 # lane p of a butterfly holds H's row SIG[p]
MF = np.asarray(TP._MF).reshape(6, 3)
V = np.asarray(TP._V).reshape(6, 3)
QPC = np.asarray(TP._QPC)
SCAN = jax.jit(JP4._dc_scan_comp, static_argnums=(0, 1))


def quant_dc(y, qp):
    qd, qm = qp // 6, qp % 6
    mag = (abs(y) * int(MF[qm, 0]) + 2 * ((1 << (15 + qd)) // 3)) >> (16 + qd)
    return max(-2000, min(2000, -mag if y < 0 else mag))


def dequant_ldc(f, qp):
    ls, t = 16 * int(V[qp % 6, 0]), qp // 6
    return f * ls * (1 << (t - 6)) if t >= 6 else (f * ls + (1 << (5 - t))) >> (6 - t)


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


def columns(rows):
    """Butterflies down the columns of four lanes' rows (masks 1, 2)."""
    out = [[0] * 4 for _ in range(4)]
    for k in range(4):
        col = butterflies([rows[by][k] for by in range(4)], (1, 2))
        for by in range(4):
            out[by][k] = col[by]
    return out


def record_part(dc, ey, qp, m):
    """The first grid's four lanes of one (component, MB): the record's
    ints (offset -> value) and the pred-free levels {(i, j): level}."""
    h = columns([had4_vec([int(x) for x in dc[by, m]]) for by in range(4)])
    lv = [[0 if (by == 0 and k == 0) else quant_dc(h[by][k] >> 1, qp)
           for k in range(4)] for by in range(4)]
    frest = columns([had4_vec(lv[by]) for by in range(4)])
    ints = {}
    for by in range(4):
        for i in range(4):
            ints[4 * by + i] = int(ey[by, m, i]) + 32
        ints[16 + by] = frest[by][3]
    ints[20] = h[0][0] >> 1
    levels = {(SIG[by], k): lv[by][k] for by in range(4) for k in range(4)}
    return ints, levels, frest


def records(dcs, eys, qps, m):
    """MB m's 64-int record of the three components, and their pred-free
    levels and Frest."""
    rec = np.zeros(REC, np.int64)
    extra = []
    for c in range(3):
        ints, levels, frest = record_part(dcs[c], eys[c], qps[c], m)
        for off, val in ints.items():
            at = (16 * c + off if off < 16 else 48 + 4 * c + off - 16
                  if off < 20 else 60 + c)
            rec[at] = val
        extra.append((levels, frest))
    return rec, extra


def clip1(x):
    return max(0, min(255, x))


def cut_chains(dcs, eys, qps, mutate=False):
    """One row through the kernel's steps: component c on 16 lanes, lane
    k reading rec[16c + k], rec[48 + 4c + (k >> 2)], rec[60 + c].
    -> per component (levels (M, 4, 4), preds (M,))."""
    recs = [records(dcs, eys, qps, m) for m in range(M)]
    out = []
    for c in range(3):
        q = qps[c]
        lv_out = np.zeros((M, 4, 4), np.int64)
        p_out = np.zeros(M, np.int64)
        pred = 128
        for m in range(M):
            rec, extra = recs[m]
            h00 = int(rec[60 + c])
            dl = quant_dc(h00 - (127 if mutate else 128) * pred, q)
            px = [clip1(pred + ((int(rec[16 * c + k])
                                 + dequant_ldc(int(rec[48 + 4 * c + (k >> 2)])
                                               + dl, q)) >> 6))
                  for k in range(16)]
            for (i, j), v in extra[c][0].items():
                lv_out[m, i, j] = dl if (i, j) == (0, 0) else v
            p_out[m] = pred
            pred = (sum(px) + 8) >> 4
        out.append((lv_out, p_out))
    return out


def coding_terms(dc, qp, m):
    """The coding grid's DC terms of one (component, MB): butterflies over
    the MB's 16 lanes (raster block b), the pred-free levels at lane
    (p, q) = H's (SIG[p], SIG[q]), then Frest back at natural (by, bx)."""
    w = [int(dc[b >> 2, m, b & 3]) for b in range(16)]
    v = butterflies(w, (1, 2, 4, 8))
    lv = [0 if b == 0 else quant_dc(v[b] >> 1, qp) for b in range(16)]
    f = butterflies(lv, (1, 2, 4, 8))
    return ({(SIG[b >> 2], SIG[b & 3]): lv[b] for b in range(16)},
            [[f[4 * by + bx] for bx in range(4)] for by in range(4)])


def inputs(kind, seed):
    """Per component (Y, Cb, Cr): DC terms and right-edge inverses,
    (R, 4, M, 4) each, as _dc_scan_comp takes them."""
    rng = np.random.default_rng(seed)
    if kind == "moderate":
        dc = rng.integers(0, 4081, (3, R, 4, M, 4))
        ey = rng.integers(-400, 400, (3, R, 4, M, 4))
    else:
        dc = rng.choice([0, 4080], (3, R, 4, M, 4))
        ey = rng.choice([-(1 << 20), 0, 1 << 20], (3, R, 4, M, 4))
    return dc.astype(np.int32), ey.astype(np.int32)


def reference(dc, ey, qp):
    """_dc_scan_comp of each component: Y at qp, Cb and Cr at QPC[qp]."""
    qpc = QPC[np.clip(qp, 0, 51)].astype(np.int32)
    return [[np.asarray(a) for a in SCAN(R, M, dc[c], ey[c],
                                         qp if c == 0 else qpc)]
            for c in range(3)]


QPS = [(0, 0, 0), (51, 51, 51), (28, 28, 28), (8, 33, 47)]


@pytest.mark.parametrize("kind", ["moderate", "extreme"])
@pytest.mark.parametrize("qps", QPS)
def test_cut_chains444_equal_dc_scan_comp(kind, qps):
    dc, ey = inputs(kind, sum(qps) + len(kind))
    qp = np.asarray(qps, np.int32)
    ref = reference(dc, ey, qp)
    for r in range(R):
        q3 = (int(qp[r]), int(QPC[qp[r]]), int(QPC[qp[r]]))
        got = cut_chains(dc[:, r], ey[:, r], q3)
        for c in range(3):
            assert np.array_equal(got[c][0], ref[c][0][r].astype(np.int64))
            assert np.array_equal(got[c][1], ref[c][1][r].astype(np.int64))


def test_a_mutated_model_fails():
    """128 pred -> 127 pred in level00: the comparison above sees it."""
    dc, ey = inputs("moderate", 11)
    qp = np.asarray((20, 30, 40), np.int32)
    ref = reference(dc, ey, qp)
    q3 = (20, int(QPC[20]), int(QPC[20]))
    got = cut_chains(dc[:, 0], ey[:, 0], q3, mutate=True)
    assert not all(np.array_equal(got[c][0], ref[c][0][0])
                   and np.array_equal(got[c][1], ref[c][1][0])
                   for c in range(3))


@pytest.mark.parametrize("kind", ["moderate", "extreme"])
@pytest.mark.parametrize("qp", [0, 28, 51])
def test_coding_grid_terms_equal_the_records444(kind, qp):
    """The coding grid's 16-lane butterflies give the first grid's
    pred-free levels and Frest (4 lanes, rows in a lane), MB for MB and
    component for component."""
    dc, ey = inputs(kind, qp + 3)
    q3 = (qp, int(QPC[qp]), int(QPC[qp]))
    for m in range(M):
        _, extra = records(dc[:, 0], ey[:, 0], q3, m)
        for c in range(3):
            levels, frest = coding_terms(dc[c, 0], q3[c], m)
            assert levels == extra[c][0]
            assert frest == extra[c][1]
