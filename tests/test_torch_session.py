"""The port's H.264 session against the JAX package's, frame by frame.

A scripted 64x64 sequence with 32-row stripes: an overflow episode on
the very first frame (out_cap shrunk on both sessions), the forced IDR
that follows it, damaged P frames, paint-overs, idle frames, a forced
IDR and a last P. Checked: equal EncodedChunk lists, equal reference
planes / damage reference / age / sent / fnum after every frame, the
JAX package's own reference decoder turning the port's payloads into the
port's reconstruction (and libavcodec, where its shim loads), and the
state carry (JAX state loaded into a port session mid-sequence
continues byte for byte). Tolerance: 0.
"""

import dataclasses

import numpy as np
import pytest
import torch

from selkies_tpu.codecs import h264_ref_decoder as refdec
from selkies_tpu.engine.h264_encoder import H264EncoderSession as JSession
from selkies_tpu.engine.types import CaptureSettings as JSettings
from selkies_tpu_torch.engine import state as port_state
from selkies_tpu_torch.engine.h264_encoder import H264EncoderSession
from selkies_tpu_torch.engine.types import CaptureSettings

torch.set_num_threads(1)

KW = dict(capture_width=64, capture_height=64, stripe_height=32,
          output_mode="h264", h264_motion_vrange=0,
          h264_partial_encode=False, paint_over_delay_frames=3)
STATE = ("_ref_y", "_ref_u", "_ref_v", "_age", "_sent", "_fnum", "_prev")
SCALARS = ("qp", "paint_qp", "frame_id", "_w_cap", "_out_cap", "_cap_gen",
           "_force_after_drop")
#: chunks expected per frame: overflow, IDR after the drop, damaged P,
#: paint-over, idle, paint-over, idle, forced IDR, damaged P
EXPECT = [0, 2, 1, 1, 0, 1, 0, 2, 1]
CARRY_AT = 3


def _frames():
    rng = np.random.default_rng(2024)
    yy, xx = np.mgrid[0:64, 0:64]
    f0 = np.stack([yy * 3, xx * 3 + 20, 200 - yy - xx], -1).astype(np.uint8)
    f0[4:28, 6:58] = rng.integers(0, 256, (24, 52, 3))       # busy panel
    f1 = f0.copy()
    f1[10:20, 10:40] = 255 - f1[10:20, 10:40]                 # stripe 0
    f2 = f1.copy()
    f2[40:56, 8:24] = (30, 90, 200)                           # stripe 1
    return [(f0, False), (f0, False), (f1, False), (f1, False), (f1, False),
            (f1, False), (f1, False), (f1, True), (f2, False)]


def _shrunk_cap() -> int:
    """Two thirds of the first IDR's bytes (measured on a port session):
    the first frame overflows, the doubled buffer holds every frame."""
    probe = H264EncoderSession(CaptureSettings(**KW), device="cpu")
    frame = _frames()[0][0]
    return sum(len(c.payload) for c in
               probe.finalize(probe.encode(frame))) * 2 // 3


def _shrink(sess, cap):
    sess._out_cap = cap
    sess._i_step = sess._build_step("i")
    sess._p_step = sess._build_step("p")


def _astuples(chunks):
    return [dataclasses.astuple(c) for c in chunks]


def _run(sess, frames, jax_side: bool):
    out = []
    for frame, force in frames:
        chunks = sess.finalize(sess.encode(frame, force=force))
        if jax_side:
            st = {k: np.array(getattr(sess, k)) for k in STATE}
        else:
            st = {k: getattr(sess, k).numpy().copy() for k in STATE}
        st.update({k: getattr(sess, k) for k in SCALARS})
        out.append((chunks, st))
    return out


@pytest.fixture(scope="module")
def runs():
    cap = _shrunk_cap()
    js = JSession(JSettings(**KW))
    ts = H264EncoderSession(CaptureSettings(**KW), device="cpu")
    _shrink(js, cap)
    _shrink(ts, cap)
    frames = _frames()
    return {"jax": _run(js, frames, True), "port": _run(ts, frames, False),
            "port_session": ts}


@pytest.mark.parametrize("i", range(len(EXPECT)))
def test_chunks_equal(runs, i):
    jc, tc = runs["jax"][i][0], runs["port"][i][0]
    assert len(tc) == EXPECT[i]
    assert _astuples(tc) == _astuples(jc)


@pytest.mark.parametrize("i", range(len(EXPECT)))
def test_state_equal(runs, i):
    js, ts = runs["jax"][i][1], runs["port"][i][1]
    for k in STATE + SCALARS:
        assert np.array_equal(np.asarray(js[k]), np.asarray(ts[k])), k


def test_overflow_episode_grew_the_buffers(runs):
    first = runs["port"][0][1]
    assert first["_cap_gen"] == 1 and first["_force_after_drop"]
    assert all(c.is_idr for c in runs["port"][1][0])
    assert runs["port"][-1][1]["_w_cap"] == 2 * 2048


@pytest.mark.parametrize("stripe", [0, 1])
def test_reference_decoder_reproduces_port_recon(runs, stripe):
    """Every access unit the port delivered for a stripe, decoded by the
    JAX package's spec decoder, ends on the port's reference planes."""
    aus = [c.payload for chunks, _ in runs["port"] for c in chunks
           if c.stripe_y == 32 * stripe]
    y, u, v = refdec.decode(b"".join(aus))
    final = runs["port"][-1][1]
    assert np.array_equal(y, final["_ref_y"][32 * stripe:32 * stripe + 32])
    assert np.array_equal(u, final["_ref_u"][16 * stripe:16 * stripe + 16])
    assert np.array_equal(v, final["_ref_v"][16 * stripe:16 * stripe + 16])


@pytest.mark.parametrize("stripe", [0, 1])
def test_libavcodec_reproduces_port_recon(runs, stripe):
    """The same check through libavcodec (the JAX package's avshim), an
    independent decoder, access unit by access unit."""
    from selkies_tpu.native import avshim
    if not avshim.available():
        pytest.skip("libavcodec shim not available")
    ses = avshim.H264Session()
    out = None
    for chunks, _ in runs["port"]:
        for c in chunks:
            if c.stripe_y == 32 * stripe:
                out = ses.decode(c.payload) or out
    out = ses.flush() or out
    final = runs["port"][-1][1]
    y, u, v = out
    assert np.array_equal(y, final["_ref_y"][32 * stripe:32 * stripe + 32])
    assert np.array_equal(u, final["_ref_u"][16 * stripe:16 * stripe + 16])
    assert np.array_equal(v, final["_ref_v"][16 * stripe:16 * stripe + 16])


@pytest.fixture(scope="module")
def carried(runs):
    """A fresh port session loaded with the JAX session's state after
    frame CARRY_AT, then run over the rest of the script."""
    ts = H264EncoderSession(CaptureSettings(**KW), device="cpu")
    port_state.session_state_from_numpy(ts, runs["jax"][CARRY_AT][1])
    return _run(ts, _frames()[CARRY_AT + 1:], False)


@pytest.mark.parametrize("i", range(CARRY_AT + 1, len(EXPECT)))
def test_state_carry_continues_identically(runs, carried, i):
    tc, ts = carried[i - CARRY_AT - 1]
    jc, js = runs["jax"][i]
    assert _astuples(tc) == _astuples(jc)
    for k in STATE + SCALARS:
        assert np.array_equal(np.asarray(js[k]), np.asarray(ts[k])), k


def test_state_round_trip(runs):
    src = runs["port_session"]
    d = port_state.session_state_to_numpy(src)
    dst = H264EncoderSession(CaptureSettings(**KW), device="cpu")
    port_state.session_state_from_numpy(dst, d)
    back = port_state.session_state_to_numpy(dst)
    for k in d:
        assert np.array_equal(np.asarray(d[k]), np.asarray(back[k])), k
    assert dst._out_cap == src._out_cap and dst._cap_gen == src._cap_gen


def test_state_load_checks_shapes(runs):
    d = dict(runs["jax"][0][1])
    d["_ref_u"] = np.zeros((8, 8), np.uint8)
    sess = H264EncoderSession(CaptureSettings(**KW), device="cpu")
    with pytest.raises(ValueError, match="_ref_u"):
        port_state.session_state_from_numpy(sess, d)


def test_finalize_stream_matches_finalize(runs):
    ts = H264EncoderSession(CaptureSettings(**KW), device="cpu")
    _shrink(ts, _shrunk_cap())
    for (frame, force), (want, _) in zip(_frames(), runs["port"]):
        got = list(ts.finalize_stream(ts.encode(frame, force=force)))
        assert _astuples(got) == _astuples(want)
