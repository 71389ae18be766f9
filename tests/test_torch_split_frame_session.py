"""Split-frame H.264 of the port on the CPU, continued: 4:4:4 frames,
padded rows and the sharded session, against the JAX package.

The reference's own tests of these (tests/test_stripes.py, ``slow``) show
its sharded functions and ``StripeShardedH264Session`` equal to its
unsharded functions and ``H264EncoderSession``; the port's sharded paths
are held to those here, which spares compiling the JAX shard programs:

- 4:4:4 I at 4 shards (with recon) and a 4:4:4 P frame whose whole-frame
  window spans the 4 shards (the halo path), 64x32, seed 9;
- 3 MB rows over 2 shards (seed 13): padded to 4 and trimmed, and a
  padded P frame with whole windows per shard;
- the session at 4 shards (64x64, 16-row stripes, motion vrange 2 /
  hrange 1) over an IDR and two damaged P frames, on both finalize
  paths, chunk for chunk and state array for state array; its buffers
  growing after a shard overflows; its state loaded into a plain
  session and back; the mesh degrading to a dividing count (3 stripes,
  4 requested, 3 chosen, as the reference chooses).

Tolerance: 0.
"""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from selkies_tpu.codecs import h264 as jcodec
from selkies_tpu.engine.h264_encoder import H264EncoderSession as JSession
from selkies_tpu.engine.h264_encoder import \
    StripeShardedH264Session as JSharded
from selkies_tpu.engine.types import CaptureSettings as JSettings
from selkies_tpu.ops import h264_planes as JP
from selkies_tpu.ops import h264_planes444 as J4
from selkies_tpu_torch.engine import state as port_state
from selkies_tpu_torch.engine.h264_encoder import (H264EncoderSession,
                                                   StripeShardedH264Session)
from selkies_tpu_torch.engine.types import CaptureSettings
from selkies_tpu_torch.ops import h264_planes as TP
from selkies_tpu_torch.parallel import stripes as ST

torch.set_num_threads(1)

STATE = ("_ref_y", "_ref_u", "_ref_v", "_age", "_sent", "_fnum", "_prev")
KW = dict(capture_width=64, capture_height=64, stripe_height=16,
          output_mode="h264", video_crf=28, use_paint_over=False,
          h264_motion_vrange=2, h264_motion_hrange=1,
          h264_partial_encode=False)


@pytest.fixture(scope="module", autouse=True)
def no_threads_left_behind():
    start = threading.active_count()
    yield
    assert threading.active_count() == start


def _same_out(got, want):
    assert np.array_equal(got.words.numpy().view(np.uint32),
                          np.asarray(want.words))
    assert np.array_equal(got.total_bits.numpy(),
                          np.asarray(want.total_bits))
    assert bool(got.overflow) == bool(want.overflow)


def _same_planes(got, want):
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b).astype(np.uint8))


def _mesh(n, rows):
    return ST.stripe_mesh(rows, devices=["cpu"] * n)


# ------------------------------------------------------------------- 4:4:4
def test_444_sharded_i_and_halo_p_equal_reference():
    rng = np.random.default_rng(9)
    h, w = 64, 32
    R, M = h // 16, w // 16
    y, u, v = (rng.integers(0, 256, (h, w)).astype(np.int32)
               for _ in range(3))
    hdr = jcodec.slice_header_events(M, R)
    p_hdr = jcodec.p_slice_header_events(M, R)
    e_cap = 9 + M * max(J4.SLOTS_MB_444, J4.P_SLOTS_MB_444) + 2
    w_cap = 6144
    cands = ((0, 0), (2, 0), (0, 1))
    ref, rec = jax.jit(lambda a, b, c: J4.h264_encode_yuv444(
        a, b, c, 26, *hdr, e_cap, w_cap, want_recon=True))(y, u, v)
    mesh = _mesh(4, R)
    out, rec_sh = ST.h264_encode_sharded(y, u, v, 26, *hdr, e_cap, w_cap,
                                         mesh, fullcolor=True,
                                         want_recon=True)
    _same_out(out, ref)
    _same_planes(rec_sh, rec)
    cur = [np.roll(p, 2, axis=0) for p in (y, u, v)]
    p_ref, p_rec = jax.jit(lambda a, b, c, ry, ru, rv: J4.h264_encode_p_yuv444(
        a, b, c, ry, ru, rv, 26, *p_hdr, 1, e_cap, w_cap, candidates=cands,
        stripe_rows=4))(*cur, *rec)
    p_sh, p_rec_sh = ST.h264_encode_p_sharded(
        *cur, *(np.asarray(p) for p in rec), 26, *p_hdr, 1, e_cap, w_cap,
        mesh, candidates=cands, stripe_rows=4, fullcolor=True)
    _same_out(p_sh, p_ref)
    _same_planes(p_rec_sh, p_rec)


# ----------------------------------------------------------------- padding
def test_sharded_pads_non_dividing_rows():
    """3 MB rows over 2 shards: padded to 4, trimmed, the reference's
    bytes; a padded P frame (whole windows per shard) equals the
    unsharded P frame."""
    rng = np.random.default_rng(13)
    h, w = 48, 32
    R, M = h // 16, w // 16
    y, u, v = (rng.integers(0, 256, (h, w)).astype(np.int32),
               rng.integers(0, 256, (h // 2, w // 2)).astype(np.int32),
               rng.integers(0, 256, (h // 2, w // 2)).astype(np.int32))
    hdr = jcodec.slice_header_events(M, R)
    e_cap = 9 + M * 879 + 2
    ref, rec = jax.jit(lambda a, b, c: JP.h264_encode_yuv(
        a, b, c, 26, *hdr, e_cap, 4096, want_recon=True))(y, u, v)
    mesh = ST.StripeMesh(np.array([torch.device("cpu")] * 2, object))
    out, rec_sh = ST.h264_encode_sharded(y, u, v, 26, *hdr, e_cap, 4096,
                                         mesh, want_recon=True)
    assert out.words.shape[0] == R and out.mb_rows == R
    _same_out(out, ref)
    _same_planes(rec_sh, rec)
    p_hdr = jcodec.p_slice_header_events(M, R)
    cur = [np.roll(p, 1, axis=0) for p in (y, u, v)]
    rec_np = [np.asarray(p) for p in rec]
    kw = dict(candidates=((0, 0), (1, 0), (-1, 0)), stripe_rows=1)
    want, want_rec = TP.h264_encode_p_yuv(*cur, *rec_np, 30, *p_hdr, 2,
                                          e_cap, 4096, device="cpu", **kw)
    got, got_rec = ST.h264_encode_p_sharded(*cur, *rec_np, 30, *p_hdr, 2,
                                            e_cap, 4096, mesh, **kw)
    assert torch.equal(got.words, want.words)
    assert torch.equal(got.total_bits, want.total_bits)
    for a, b in zip(got_rec, want_rec):
        assert torch.equal(a, b)


# ----------------------------------------------------------------- session
def _session_frames(n, w, h, seed=0):
    rng = np.random.default_rng(seed)
    f0 = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    out = [f0]
    for _ in range(1, n):
        f = np.roll(out[-1], 5, axis=0)
        f[:5] = rng.integers(0, 256, (5, w, 3), dtype=np.uint8)
        out.append(f)
    return out


def _chunks(chunks):
    return [(c.stripe_y, c.is_idr, c.payload) for c in chunks]


def _sharded(**over):
    return StripeShardedH264Session(
        CaptureSettings(**{**KW, "stripe_devices": 4, **over}),
        devices=["cpu"] * 4)


@pytest.fixture(scope="module")
def session_runs():
    """The reference session and two sharded port sessions (one a
    finalize path) over an IDR and two damaged P frames: chunks and
    state after every frame."""
    frames = _session_frames(3, 64, 64)
    js = JSession(JSettings(**KW))
    ports = {"finalize": _sharded(), "finalize_stream": _sharded()}
    runs = {"jax": [], "finalize": [], "finalize_stream": []}
    for f in frames:
        runs["jax"].append((_chunks(js.finalize(js.encode(jnp.asarray(f)))),
                            {k: np.array(getattr(js, k)) for k in STATE}))
        for name, sess in ports.items():
            out = sess.encode(f)
            chunks = sess.finalize(out) if name == "finalize" \
                else list(sess.finalize_stream(out))
            runs[name].append((_chunks(chunks),
                               {k: getattr(sess, k).numpy().copy()
                                for k in STATE}))
    return runs, ports


@pytest.mark.parametrize("path", ["finalize", "finalize_stream"])
@pytest.mark.parametrize("i", range(3))
def test_sharded_session_equals_reference(session_runs, path, i):
    runs, ports = session_runs
    assert ports[path].stripe_devices == 4
    (jc, js), (tc, ts) = runs["jax"][i], runs[path][i]
    assert len(tc) == 4 and all(c[1] == (i == 0) for c in tc)
    assert tc == jc
    for k in STATE:
        assert np.array_equal(ts[k], js[k]), k


def test_sharded_session_state_carries(session_runs):
    """The sharded session keeps full-frame state on its device: its
    state loads into a plain session, which continues with the same
    bytes."""
    _, ports = session_runs
    sh = ports["finalize"]
    plain = H264EncoderSession(CaptureSettings(**KW), device="cpu")
    port_state.session_state_from_numpy(
        plain, port_state.session_state_to_numpy(sh))
    nxt = _session_frames(4, 64, 64, seed=1)[-1]
    assert _chunks(plain.finalize(plain.encode(nxt))) \
        == _chunks(sh.finalize(sh.encode(nxt)))
    a, b = (port_state.session_state_to_numpy(s) for s in (plain, sh))
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def test_shard_overflow_grows_the_local_buffers():
    """A shard whose rows pass its byte buffer drops the frame; the
    buffers double (each shard's with them) and the next frame is an IDR,
    as a plain session's after the same episode (both cut to 2000 bytes,
    which a noise IDR of ~3 KB passes)."""
    frames = _session_frames(3, 64, 64, seed=5)
    sh, plain = _sharded(), H264EncoderSession(CaptureSettings(**KW),
                                               device="cpu")
    logs = []
    for s in (sh, plain):
        s.finalize(s.encode(frames[0]))
        s._out_cap = 2000                    # 500 bytes a shard
        s._rebuild_steps()
        out = s.encode(frames[1], force=True)
        logs.append((out["data"].shape, s.finalize(out), s._cap_gen))
        logs.append(_chunks(s.finalize(s.encode(frames[2]))))
    assert logs[0] == ((2000,), [], 1) and logs[2] == ((2000,), [], 1)
    assert sh._out_cap_local == 1000
    assert all(c[1] for c in logs[1]) and logs[1] == logs[3]


def test_sharded_session_degrades_to_dividing_count():
    # 96 px / 32 px stripes = 3 stripes: requested 4 -> chosen 3
    kw = dict(capture_width=48, capture_height=96, stripe_height=32,
              output_mode="h264", video_crf=28, use_paint_over=False,
              stripe_devices=4)
    port = StripeShardedH264Session(CaptureSettings(**kw),
                                    devices=["cpu"] * 4)
    assert port.stripe_devices == 3 == JSharded(JSettings(**kw)) \
        .stripe_devices
    assert port._out_cap_local == -(-port._out_cap // 3)


def test_sharded_session_keeps_the_plain_step_at_one_shard():
    """A device given alone is a one-device list: the count resolves to
    1 and the session is the plain one, band path included."""
    s = StripeShardedH264Session(
        CaptureSettings(**{**KW, "stripe_devices": 4,
                           "h264_partial_encode": True}), device="cpu")
    assert s.stripe_devices == 1 and s._partial
    assert s._ops is TP.KERNEL_OPS
    with pytest.raises(NotImplementedError, match="A11c"):
        StripeShardedH264Session(CaptureSettings(**KW, stripe_devices=2),
                                 devices=["cpu", "meta"])
