"""The port's plane-layout H.264 building blocks against the JAX package.

Each function of selkies_tpu_torch/ops/h264_planes.py (and the event
helpers of ops/h264_encode.py) gets the same seeded numpy inputs as its
JAX original and must return the same integers. Tolerance: 0 for every
output (transform planes, levels, events slot by slot, nC planes, packed
words, event counts, bit totals).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from selkies_tpu.ops import h264_encode as JE
from selkies_tpu.ops import h264_planes as JP
from selkies_tpu_torch.ops import h264_encode as TE
from selkies_tpu_torch.ops import h264_planes as TP

torch.set_num_threads(1)

QPS = {"qp8": 8, "qp28": 28, "qp48": 48, "per_row": "rows"}


def _qp(case, n, seed=0):
    if case == "rows":
        return np.random.default_rng(seed).integers(0, 52, n).astype(
            np.int32)
    return np.full(n, case, np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _eq(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a.astype(np.int64), b.astype(np.int64))


def _rand_plane(seed, h=32, w=48, lo=-255, hi=256):
    return np.random.default_rng(seed).integers(lo, hi, (h, w)).astype(
        np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fwd4_and_inv4_planes(seed):
    x = _rand_plane(seed)
    jw = jax.jit(JP.fwd4_planes)(x)
    tw = TP.fwd4_planes(torch.from_numpy(x))
    for i in range(4):
        for j in range(4):
            _eq(tw[i][j], jw[i][j])
    d = [[_rand_plane(seed * 16 + 4 * i + j, 8, 12, -3000, 3000)
          for j in range(4)] for i in range(4)]
    ji = jax.jit(JP.inv4_planes)(d)
    ti = TP.inv4_planes([[torch.from_numpy(p).long() for p in r] for r in d])
    for i in range(4):
        for j in range(4):
            _eq(ti[i][j], ji[i][j])


@pytest.mark.parametrize("fdiv", [3, 6])
@pytest.mark.parametrize("case", list(QPS))
def test_quant_dequant_planes(case, fdiv):
    w = _rand_plane(7, 16, 24, -9000, 9000)
    qp = _qp(QPS[case], 16)[:, None]
    for cls in range(3):
        jq = jax.jit(JP._quant_plane, static_argnums=(2, 3))(w, qp, cls, fdiv)
        tq = TP._quant_plane(torch.from_numpy(w).long(), qp, cls, fdiv)
        _eq(tq, jq)
        jd = jax.jit(JP._dequant_plane, static_argnums=2)(np.asarray(jq),
                                                           qp, cls)
        _eq(TP._dequant_plane(tq, qp, cls), jd)


@pytest.mark.parametrize("case", list(QPS))
def test_dc_quant_dequant(case):
    y = _rand_plane(8, 16, 24, -40000, 40000)
    qp = _qp(QPS[case], 16, seed=1)[:, None]
    ty = torch.from_numpy(y).long()
    _eq(TP._quant_dc_e(ty, qp), jax.jit(JP._quant_dc_e)(y, qp))
    f = _rand_plane(9, 16, 24, -32000, 32000)
    tf = torch.from_numpy(f).long()
    _eq(TP._dequant_ldc_e(tf, qp), jax.jit(JP._dequant_ldc_e)(f, qp))
    qpc = np.clip(qp, 0, 39)
    _eq(TP._dequant_cdc_e(tf, qpc), jax.jit(JP._dequant_cdc_e)(f, qpc))


@pytest.mark.parametrize("case", list(QPS))
def test_dc_scan(case):
    """The sequential DC / left-edge chain of the I path."""
    R, M = 3, 5
    rng = np.random.default_rng(11)
    dc_y = rng.integers(0, 4081, (R, 4, M, 4)).astype(np.int32)
    dc_c = rng.integers(0, 4081, (R, 2, 2, M, 2)).astype(np.int32)
    ey = rng.integers(-400, 400, (R, 4, M, 4)).astype(np.int32)
    ec = rng.integers(-400, 400, (R, 2, 2, M, 4)).astype(np.int32)
    qp = _qp(QPS[case], R, seed=2)
    qpc = JP._QPC_J[np.clip(qp, 0, 51)]
    ref = jax.jit(JP._dc_scan, static_argnums=(0, 1))(
        R, M, dc_y, dc_c, ey, ec, qp, np.asarray(qpc))
    got = TP._dc_scan(R, M, *(torch.from_numpy(a).long() for a in
                              (dc_y, dc_c, ey, ec)), qp, np.asarray(qpc))
    for g, r in zip(got, ref):
        _eq(g, r)


def _levels(seed, mc, shape, density):
    rng = np.random.default_rng(seed)
    mag = rng.choice([1, 1, 1, 2, 3, 5, 17, 60, 600, 2000], (mc,) + shape)
    sign = rng.choice([-1, 1], (mc,) + shape)
    on = rng.random((mc,) + shape) < density
    return (mag * sign * on).astype(np.int32)


@pytest.mark.parametrize("density", [0.05, 0.3, 0.9])
@pytest.mark.parametrize("mc,chroma_dc", [(16, False), (15, False),
                                          (4, True)])
def test_cavlc_events_slot_by_slot(mc, chroma_dc, density):
    shape = (6, 10)
    scan = _levels(mc * 7 + int(density * 100), mc, shape, density)
    nc = np.random.default_rng(3).integers(0, 17, shape).astype(np.int32)
    fn = jax.jit(lambda s, n: JP.cavlc_events_planes(
        s, None if chroma_dc else n, chroma_dc=chroma_dc))
    jpay, jnb, jtc = fn(scan, nc)
    tpay, tnb, ttc = TP.cavlc_events_planes(
        torch.from_numpy(scan), None if chroma_dc else torch.from_numpy(nc),
        chroma_dc=chroma_dc)
    assert tpay.shape[0] == 2 * mc + 4
    _eq(tpay, jpay)
    _eq(tnb, jnb)
    _eq(ttc, jtc)


@pytest.mark.parametrize("mb_bw", [2, 4])
def test_nc_planes(mb_bw):
    tc = np.random.default_rng(mb_bw).integers(0, 17, (4 * mb_bw, 6 * mb_bw))
    tc = tc.astype(np.int32)
    _eq(TP._nc_planes(torch.from_numpy(tc), mb_bw),
        jax.jit(JP._nc_planes, static_argnums=1)(tc, mb_bw))


def test_nc_from_counts():
    rng = np.random.default_rng(5)
    y = rng.integers(0, 17, (3, 5, 4, 4)).astype(np.int32)
    c = rng.integers(0, 16, (3, 2, 5, 2, 2)).astype(np.int32)
    _eq(TE._nc_from_counts(torch.from_numpy(y)),
        jax.jit(JE._nc_from_counts)(y))
    _eq(TE._nc_from_counts_chroma(torch.from_numpy(c)),
        jax.jit(JE._nc_from_counts_chroma)(c))


def test_exp_golomb_and_level_events():
    v = np.arange(0, 5000, dtype=np.int32)
    for tf, jf in ((TE._ue_event, JE._ue_event), (TE._se_event,
                                                  JE._se_event)):
        arg = v if tf is TE._ue_event else v - 2500
        for g, r in zip(tf(torch.from_numpy(arg)), jax.jit(jf)(arg)):
            _eq(g, r)
    lc = np.tile(np.arange(0, 4000, dtype=np.int32), 7)
    sl = np.repeat(np.arange(7, dtype=np.int32), 4000)
    jl = jax.jit(JE._level_event)(lc, sl)
    tl = TE._level_event(torch.from_numpy(lc), torch.from_numpy(sl))
    for g, r in zip(tl, jl):
        _eq(g, r)


@pytest.mark.parametrize("case", list(QPS))
def test_quant_ac_inter(case):
    w = np.random.default_rng(6).integers(-9000, 9000, (3, 5, 4, 4))
    w = w.astype(np.int32)
    qp = _qp(QPS[case], 15, seed=3).reshape(3, 5)
    _eq(TE._quant_ac_inter(torch.from_numpy(w), qp),
        jax.jit(JE._quant_ac_inter)(w, qp))


@pytest.mark.parametrize("w_cap", [8, 64])
def test_event_sink_pack(w_cap):
    """Random prefix / MB / tail events through both sinks; w_cap 8 makes
    rows overflow and spill into the next row's words (and off the end)."""
    R, M, S = 3, 4, 20
    rng = np.random.default_rng(w_cap)
    nb = rng.integers(0, 33, (S, R, M)).astype(np.int32)
    nb[rng.random((S, R, M)) < 0.3] = 0
    pay = (rng.integers(0, 1 << 32, (S, R, M), dtype=np.uint64)
           & ((np.uint64(1) << nb.astype(np.uint64)) - np.uint64(1))
           ).astype(np.uint32)
    pre_nb = rng.integers(1, 20, (6, R)).astype(np.int32)
    pre_pay = (rng.integers(0, 1 << 20, (6, R)) & ((1 << pre_nb) - 1)
               ).astype(np.uint32)
    rows = np.arange(R, dtype=np.int32)

    def fill(sink, xp, conv):
        sink.add_prefix(conv(rows[None]), conv(np.cumsum(pre_nb, 0) - pre_nb),
                        conv(pre_pay), conv(pre_nb))
        sink.add_mb(conv(rows[None, :, None]),
                    conv(np.arange(M, dtype=np.int32)[None, None, :]),
                    conv(np.cumsum(nb, 0) - nb), conv(pay), conv(nb))
        sink.add_tail(conv(rows), conv(np.zeros(R, np.int32)),
                      conv(np.ones(R, np.uint32)), conv(np.ones(R, np.int32)))
        sink.set_layout(conv(pre_nb.sum(0)), conv(nb.sum(0)),
                        conv(np.ones(R, np.int32)))
        return sink.pack()

    ref = jax.jit(lambda: fill(JP._EventSink(R, M, w_cap), jnp, jnp.asarray))()
    got = fill(TP._EventSink(R, M, w_cap), torch,
               lambda a: torch.from_numpy(np.asarray(a).astype(np.int64)))
    assert np.array_equal(got[0].numpy().view(np.uint32), np.asarray(ref[0]))
    _eq(got[1], ref[1])
    _eq(got[2], ref[2])
    if w_cap == 8:
        assert (np.asarray(ref[2]) > w_cap * 32).any()
