"""Whole I and P frames of the port against the JAX package.

h264_encode_yuv / h264_encode_p_yuv run the main path's kernels (their
plain versions on the CPU: K5 -> K2 -> K3 -> K4) and must give the
reference's words, bit totals, overflow flag and reconstruction at qp
8/28/48 and with per-row qp, on noisy and desktop-like content, including
the P frame where every macroblock is skipped and a P frame with motion
search over one whole-frame window. A short session at a non-square
geometry with three stripes is held to the reference session chunk for
chunk. Tolerance: 0 for every output.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from selkies_tpu.codecs import h264 as jcodec
from selkies_tpu.engine.h264_encoder import H264EncoderSession as JSession
from selkies_tpu.engine.types import CaptureSettings as JSettings
from selkies_tpu.ops import h264_planes as JP
from selkies_tpu_torch.engine.h264_encoder import H264EncoderSession
from selkies_tpu_torch.engine.types import CaptureSettings
from selkies_tpu_torch.ops import h264_planes as TP
from tests.test_torch_cuda import EDGE_M, EDGE_QP, EDGE_R, _edge_planes

torch.set_num_threads(1)

H, W = 64, 64
R, M = H // 16, W // 16
E_CAP = 9 + M * 879 + 2
W_CAP = 2048
HDR = jcodec.slice_header_events(M, R)
P_HDR = jcodec.p_slice_header_events(M, R)

_j_i = jax.jit(lambda y, u, v, qp, idr: JP.h264_encode_yuv(
    y, u, v, qp, *HDR, E_CAP, W_CAP, idr_pic_id=idr, want_recon=True))
_j_p = jax.jit(lambda y, u, v, ry, ru, rv, qp, fn: JP.h264_encode_p_yuv(
    y, u, v, ry, ru, rv, qp, *P_HDR, fn, E_CAP, W_CAP))

QPS = {"qp8": 8, "qp28": 28, "qp48": 48, "per_row": None}


def _qp(case):
    if QPS[case] is None:
        return np.array([8, 30, 51, 19], np.int32)[:R]
    return np.full(R, QPS[case], np.int32)


def _planes(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        y = rng.integers(0, 256, (H, W))
        u = rng.integers(0, 256, (H // 2, W // 2))
        v = rng.integers(0, 256, (H // 2, W // 2))
    else:                                       # gradient + a text patch
        yy, xx = np.mgrid[0:H, 0:W]
        y = 40 + yy * 2 + xx
        y[8:30, 10:50] = rng.integers(0, 2, (22, 40)) * 200 + 20
        u = 100 + np.mgrid[0:H // 2, 0:W // 2][1]
        v = 160 - np.mgrid[0:H // 2, 0:W // 2][0]
    return [np.clip(a, 0, 255).astype(np.int32) for a in (y, u, v)]


def _check_out(got, ref):
    assert np.array_equal(got.words.numpy().view(np.uint32),
                          np.asarray(ref.words))
    assert np.array_equal(got.total_bits.numpy(), np.asarray(ref.total_bits))
    assert bool(got.overflow) == bool(ref.overflow)


@pytest.mark.parametrize("kind", ["noise", "desktop"])
@pytest.mark.parametrize("case", list(QPS))
def test_i_frame(kind, case):
    y, u, v = _planes(kind, 1)
    qp = _qp(case)
    idr = np.arange(R, dtype=np.int32) % 16
    ref, jrec = _j_i(y, u, v, qp, idr)
    got, trec = TP.h264_encode_yuv(y, u, v, qp, *HDR, E_CAP, W_CAP,
                                   idr_pic_id=idr, want_recon=True,
                                   device="cpu")
    _check_out(got, ref)
    for g, r in zip(trec, jrec):
        assert np.array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("kind", ["noise", "desktop"])
@pytest.mark.parametrize("case", list(QPS))
def test_p_frame(kind, case):
    y0, u0, v0 = _planes(kind, 2)
    qp = _qp(case)
    _, rec = _j_i(y0, u0, v0, qp, np.zeros(R, np.int32))
    rec = [np.asarray(a) for a in rec]
    y1, u1, v1 = (a.copy() for a in (y0, u0, v0))
    y1[16:40, 8:40] = 255 - y1[16:40, 8:40]          # two MB rows change
    u1[8:20, 4:20] //= 2
    fn = np.array([1, 2, 3, 15], np.int32)[:R]
    ref, jrec = _j_p(y1, u1, v1, *rec, qp, fn)
    got, trec = TP.h264_encode_p_yuv(y1, u1, v1, *rec, qp, *P_HDR, fn,
                                     E_CAP, W_CAP, device="cpu")
    _check_out(got, ref)
    for g, r in zip(trec, jrec):
        assert np.array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("case", ["qp28", "per_row"])
def test_all_skip_p_frame(case):
    """The current frame IS the reference: every MB is P_Skip, each row
    is a slice header, one trailing skip run and the stop bit."""
    qp = _qp(case)
    _, rec = _j_i(*_planes("desktop", 3), qp, np.zeros(R, np.int32))
    rec = [np.asarray(a) for a in rec]
    fn = np.ones(R, np.int32)
    ref, jrec = _j_p(*rec, *rec, qp, fn)
    got, trec = TP.h264_encode_p_yuv(*rec, *rec, qp, *P_HDR, fn, E_CAP,
                                     W_CAP, device="cpu")
    _check_out(got, ref)
    for g, r in zip(trec, rec):
        assert np.array_equal(g.numpy(), r)
    assert int(got.total_bits.max()) < 64


_EDGE_E_CAP = 9 + EDGE_M * 879 + 2
_j_edge_p = jax.jit(lambda y, u, v, ry, ru, rv, qp, fn: JP.h264_encode_p_yuv(
    y, u, v, ry, ru, rv, qp, *jcodec.p_slice_header_events(EDGE_M, EDGE_R),
    fn, _EDGE_E_CAP, W_CAP))


def test_k3_k4_edge_rows_equal_reference():
    """The K3 / K4 card tests' edge frame (tests/test_torch_cuda.py: 45
    MBs a row, an all-skip P row, a row coded in its last MB only, a row
    whose bits end on a word boundary) through the plain K2-P,
    ``cavlc_events_plain`` and ``pack_stream_plain`` equals the
    reference's P frame; each row packed alone, as a 1-row band, equals
    its row of the frame."""
    cur, ref = _edge_planes()
    qp = np.full(EDGE_R, EDGE_QP, np.int32)
    fn = np.arange(EDGE_R, dtype=np.int32)
    want, _ = _j_edge_p(*(a.astype(np.int32) for a in cur + ref), qp, fn)
    t = [torch.from_numpy(a) for a in cur + ref]
    lv, cbp, hp, hn = TP.mb_encode_p_plain(
        *t[:3], torch.from_numpy(qp), torch.ones(EDGE_R, dtype=torch.int32),
        *t[3:], None, *(a.clone() for a in t[3:]))
    ev = TP.cavlc_events_plain(lv, cbp, False)
    pay, nb = jcodec.p_slice_header_events(EDGE_M, EDGE_R)
    rows = (torch.from_numpy(pay.astype(np.int32)),
            torch.from_numpy(nb.astype(np.int32)), torch.from_numpy(fn),
            torch.from_numpy(qp))
    got = TP.pack_stream_plain(hp, hn, *ev, *rows, False, _EDGE_E_CAP,
                               W_CAP, 1 << 16)
    assert np.array_equal(got.words.numpy().view(np.uint32),
                          np.asarray(want.words))
    assert np.array_equal(got.total_bits.numpy(),
                          np.asarray(want.total_bits))
    assert not bool(want.overflow) and got.flags.tolist() == [0, 0]
    bits = got.total_bits.tolist()
    assert bits[0] < 64 and bits[2] % 32 == 0
    assert (hn[1, :, 1] > 0).tolist() == [False] * (EDGE_M - 1) + [True]
    for r in range(EDGE_R):
        one = TP.pack_stream_plain(
            hp[r:r + 1], hn[r:r + 1], ev[0][r:r + 1], ev[1][r:r + 1],
            *(x[r:r + 1] for x in rows), False, _EDGE_E_CAP, W_CAP, 1 << 16)
        assert torch.equal(one.words[0], got.words[r])
        assert int(one.total_bits[0]) == bits[r]


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the raise "
                    "on a machine without CUDA")
def test_frame_entry_points_default_to_the_card():
    """Numpy input with no device runs on the card, so without CUDA both
    entry points raise instead of quietly running on the CPU; CPU
    tensors mean the caller chose the CPU."""
    y, u, v = _planes("desktop", 4)
    qp, fn = _qp("qp28"), np.ones(R, np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TP.h264_encode_yuv(y, u, v, qp, *HDR, E_CAP, W_CAP)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TP.h264_encode_p_yuv(y, u, v, y, u, v, qp, *P_HDR, fn, E_CAP, W_CAP)
    t = [torch.from_numpy(a) for a in (y, u, v)]
    got = TP.h264_encode_yuv(*t, qp, *HDR, E_CAP, W_CAP)
    assert got.words.device.type == "cpu"
    _check_out(got, _j_i(y, u, v, qp, np.zeros(R, np.int32))[0])


_j_p_motion = jax.jit(lambda y, u, v, ry, ru, rv, qp, fn: JP.h264_encode_p_yuv(
    y, u, v, ry, ru, rv, qp, *P_HDR, fn, E_CAP, W_CAP,
    candidates=((0, 0), (3, 0), (-3, 0), (0, 2), (0, -1))))


@pytest.mark.parametrize("case", ["qp28", "per_row"])
def test_p_frame_with_motion_whole_frame_window(case):
    """Motion search with ``stripe_rows`` None: one window of the whole
    frame (vertical clamping at the picture's top and bottom only)."""
    y0, u0, v0 = _planes("desktop", 5)
    cands = ((0, 0), (3, 0), (-3, 0), (0, 2), (0, -1))
    cur = [np.roll(y0, -3, 0), np.roll(u0, -1, 0), v0.copy()]
    cur[0][40:48, 0:20] = np.roll(y0, -2, 1)[40:48, 0:20]
    qp, fn = _qp(case), np.full(R, 7, np.int32)
    ref, jrec = _j_p_motion(*cur, y0, u0, v0, qp, fn)
    ref8 = [a.astype(np.uint8) for a in (y0, u0, v0)]
    got, trec = TP.h264_encode_p_yuv(*cur, *ref8, qp, *P_HDR, fn, E_CAP,
                                     W_CAP, candidates=cands, device="cpu")
    _check_out(got, ref)
    for g, r in zip(trec, jrec):
        assert np.array_equal(g.numpy(), np.asarray(r))


# ---------------------------------------------------------------- session
SESSION = dict(capture_width=96, capture_height=48, stripe_height=16,
               output_mode="h264", h264_motion_vrange=0,
               h264_partial_encode=False, paint_over_delay_frames=2)


def _session_frames():
    rng = np.random.default_rng(7)
    f0 = rng.integers(0, 256, (48, 96, 3), dtype=np.uint8)
    f1 = f0.copy()
    f1[16:32, 40:80] = 255 - f1[16:32, 40:80]        # stripe 1 only
    return [(f0, False), (f1, False), (f1, False), (f1, False), (f1, False),
            (f1, True), (f0, False)]


@pytest.fixture(scope="module")
def nonsquare_runs():
    js = JSession(JSettings(**SESSION))
    ts = H264EncoderSession(CaptureSettings(**SESSION), device="cpu")
    out = []
    for frame, force in _session_frames():
        jc = js.finalize(js.encode(frame, force=force))
        tc = ts.finalize(ts.encode(frame, force=force))
        state = [(np.asarray(getattr(js, k)), getattr(ts, k).numpy().copy())
                 for k in ("_ref_y", "_ref_u", "_ref_v", "_age", "_sent",
                           "_fnum", "_prev")]
        out.append((jc, tc, state))
    return out


@pytest.mark.parametrize("i", range(len(_session_frames())))
def test_nonsquare_session_frame(nonsquare_runs, i):
    jc, tc, state = nonsquare_runs[i]
    assert [dataclasses.astuple(c) for c in tc] \
        == [dataclasses.astuple(c) for c in jc]
    for j, t in state:
        assert np.array_equal(j, t)


def test_nonsquare_session_covers_the_cases(nonsquare_runs):
    sent = [len(tc) for _, tc, _ in nonsquare_runs]
    assert sent[0] == 3 and sent[1] == 1             # IDR, damaged stripe
    assert sent[2] == 2 and sent[3] == 1              # paint-overs (age 2)
    assert sent[4] == 0                               # idle
    assert sent[5] == 3 and all(c.is_idr for c in nonsquare_runs[5][1])
    assert sent[6] == 1 and not nonsquare_runs[6][1][0].is_idr
