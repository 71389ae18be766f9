"""The port's H.264 session pipelined against the JAX package's.

The default configuration (the band path and motion search, candidates
reduced to vrange 4 / hrange 2 as in the other port tests) with a
watermark, on a scripted 64x64 sequence with 32-row stripes: the first
frame overflows a shrunk byte buffer, and with frames in flight the next
frames are dispatched before its finalize sees the overflow (at depth 2
and 3 a damaged P frame is encoded at the old caps); then the forced IDR
at the grown caps, one-stripe bands, idle frames and paint-overs. Each
depth runs the same interleaving on both sides, ``encode`` N+1 (and N+2)
before ``finalize`` N, as the capture loop's ring runs it, and must give
equal chunks and equal state after every call. Tolerance: 0.
"""

import collections
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from selkies_tpu.engine.h264_encoder import H264EncoderSession as JSession
from selkies_tpu.engine.types import CaptureSettings as JSettings
from selkies_tpu_torch.engine.h264_encoder import H264EncoderSession
from selkies_tpu_torch.engine.types import CaptureSettings

torch.set_num_threads(1)

KW = dict(capture_width=64, capture_height=64, stripe_height=32,
          output_mode="h264", h264_motion_vrange=4, h264_motion_hrange=2,
          paint_over_delay_frames=4, watermark_location=3)
STATE = ("_ref_y", "_ref_u", "_ref_v", "_age", "_sent", "_fnum", "_prev")
SCALARS = ("frame_id", "_w_cap", "_out_cap", "_cap_gen", "_force_after_drop",
           "qp", "paint_qp", "last_band_rows")
DEPTHS = (1, 2, 3)


def _frames():
    rng = np.random.default_rng(2024)
    yy, xx = np.mgrid[0:64, 0:64]
    f0 = np.stack([yy * 3, xx * 3 + 20, 200 - yy - xx], -1).astype(np.uint8)
    f0[4:28, 6:58] = rng.integers(0, 256, (24, 52, 3))       # busy panel
    f1 = f0.copy()
    f1[10:20, 10:40] = 255 - f1[10:20, 10:40]                 # stripe 0
    f2 = f1.copy()
    f2[40:56, 8:24] = (30, 90, 200)                           # stripe 1
    f3 = f2.copy()
    f3[2:6, 30:60] = 0                                        # stripe 0
    return [f0, f1, f1, f1, f1, f1, f1, f2, f2, f2, f2, f2, f3]


def _settings(cls, path):
    return cls(**KW, watermark_path=path)


def _shrink(sess, cap, jax_side):
    sess._out_cap = cap
    if jax_side:
        sess._i_step = sess._build_step("i")
        sess._p_step = sess._build_step("p")
    else:
        sess._rebuild_steps()


def _snap(sess, jax_side):
    conv = (lambda a: np.array(a)) if jax_side \
        else (lambda t: t.numpy().copy())
    st = {k: conv(getattr(sess, k)) for k in STATE}
    st["_host_age"] = np.array(sess._host_age)
    st.update({k: getattr(sess, k) for k in SCALARS})
    return st


def _run(sess, frames, depth, jax_side):
    """encode every frame; finalize the oldest in-flight frame whenever
    ``depth`` are in flight, then drain. -> log of (call, frame_id,
    chunks or None, band, state after the call)."""
    q, log = collections.deque(), []

    def finalize():
        out = q.popleft()
        chunks = [dataclasses.astuple(c) for c in sess.finalize(out)]
        log.append(("finalize", out["frame_id"], chunks, out.get("band"),
                    _snap(sess, jax_side)))
    for f in frames:
        out = sess.encode(jnp.asarray(f) if jax_side else f)
        log.append(("encode", out["frame_id"], None, out.get("band"),
                    _snap(sess, jax_side)))
        q.append(out)
        if len(q) == depth:
            finalize()
    while q:
        finalize()
    return log


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rgba = np.zeros((8, 12, 4), np.uint8)
    rgba[..., :3] = (250, 250, 40)
    rgba[..., 3] = np.linspace(0, 255, 12, dtype=np.uint8)[None, :]
    path = str(tmp_path_factory.mktemp("wm") / "wm.png")
    Image.fromarray(rgba, "RGBA").save(path)
    frames = _frames()
    # two thirds of the first IDR: the first frame overflows, the grown
    # buffer holds every later frame
    probe = H264EncoderSession(_settings(CaptureSettings, path), device="cpu")
    cap = sum(len(c.payload) for c in probe.finalize(probe.encode(
        frames[0]))) * 2 // 3
    res = {}
    for depth in DEPTHS:
        for jax_side in (True, False):
            sess = JSession(_settings(JSettings, path)) if jax_side else \
                H264EncoderSession(_settings(CaptureSettings, path),
                                   device="cpu")
            _shrink(sess, cap, jax_side)
            res[depth, jax_side] = _run(sess, frames, depth, jax_side)
    return res


@pytest.mark.parametrize("depth", DEPTHS)
def test_pipelined_chunks_equal_reference(runs, depth):
    jlog, tlog = runs[depth, True], runs[depth, False]
    assert [e[:4] for e in tlog] == [e[:4] for e in jlog]


@pytest.mark.parametrize("depth", DEPTHS)
def test_pipelined_state_equals_reference(runs, depth):
    jlog, tlog = runs[depth, True], runs[depth, False]
    for j, t in zip(jlog, tlog):
        for k in j[4]:
            assert np.array_equal(np.asarray(j[4][k]), np.asarray(t[4][k])), \
                (j[:2], k)


@pytest.mark.parametrize("depth", DEPTHS)
def test_pipelined_run_covers_the_overflow_episode(runs, depth):
    """The first frame is dropped and grows the buffers once; at depth
    >= 2 the damaged frame dispatched before that finalize is a band at
    the old caps and is delivered; the forced IDR follows; every later
    band is one stripe; the watermark is in the damage reference."""
    log = runs[depth, False]
    fin = {e[1]: e for e in log if e[0] == "finalize"}
    enc = {e[1]: e for e in log if e[0] == "encode"}
    assert fin[0][2] == [] and fin[0][4]["_cap_gen"] == 1
    assert enc[0][4]["_out_cap"] * 2 == log[-1][4]["_out_cap"]
    idr = 1 if depth == 1 else depth
    assert fin[idr][2] and all(c[5] for c in fin[idr][2])
    if depth > 1:
        assert enc[1][3] == (0, 2) and enc[1][4]["_cap_gen"] == 0
        assert len(fin[1][2]) == 1 and not fin[1][2][0][5]
    bands = {e[3] for e in log if e[0] == "encode" and e[3] is not None}
    assert bands == {(0, 2), (2, 2)}
    prev = log[-1][4]["_prev"]
    assert (prev[40:48, 36:48, 0] >= 240).any()      # the stamp's yellow


def test_pipelined_stream_finalize_equals_batch(runs, tmp_path):
    """finalize_stream, the capture loop's default, gives the batch
    finalize's bytes through the same pipelined overflow episode."""
    log = runs[2, False]
    path = str(tmp_path / "wm.png")
    Image.fromarray(np.full((8, 12, 4), 200, np.uint8), "RGBA").save(path)
    frames = _frames()
    for stream in (False, True):
        sess = H264EncoderSession(_settings(CaptureSettings, path),
                                  device="cpu")
        _shrink(sess, log[0][4]["_out_cap"], False)
        q, got = collections.deque(), []
        for f in frames:
            q.append(sess.encode(f))
            if len(q) == 2:
                out = q.popleft()
                fn = sess.finalize_stream if stream else sess.finalize
                got.append([dataclasses.astuple(c) for c in fn(out)])
        while q:
            got.append([dataclasses.astuple(c) for c in sess.finalize(
                q.popleft())])
        if not stream:
            batch = got
    assert got == batch and sum(map(len, got)) > 0
