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


# ------------------------------------------------ default configuration
# 64x128, 32-row stripes: motion search (reduced to vrange 4 / hrange 2 to
# keep the reference's compiles short) and the band path, against the
# JAX session; then zero-MV row-granular bands, and motion in the stock
# step. The band script: IDR, a 5-row scroll, typing in one row, idle,
# the paint-over of each stripe, a full-frame 2-px pan, a forced IDR, a
# P frame, and (default configuration only) an overflow episode on a
# band frame: a noise frame over a shrunk out_cap, the IDR after the
# drop, a last P.
BAND_KW = dict(capture_width=128, capture_height=64, stripe_height=32,
               output_mode="h264", paint_over_delay_frames=3,
               h264_motion_hrange=2)
CONFIGS = {
    "default": dict(h264_motion_vrange=4, h264_partial_encode=True),
    "zero_mv_bands": dict(h264_motion_vrange=0, h264_partial_encode=True),
    "motion_stock": dict(h264_motion_vrange=4, h264_partial_encode=False),
}
BAND_STATE = STATE + ("_host_age",)
BAND_ATTRS = ("last_band_rows", "dirty_fraction")
OVERFLOW_AT = 9
#: chunks per frame of the default configuration's script
BAND_EXPECT = [2, 2, 1, 0, 1, 1, 2, 2, 1, 0, 2, 2]
BAND_CARRY_AT = 3


def _desktop(seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:64, 0:128]
    f = np.stack([40 + yy + xx // 2, 90 + yy // 2 + 0 * xx,
                  200 - yy - xx // 4], -1).astype(np.uint8)
    glyphs = rng.integers(0, 2, (32, 64), dtype=np.uint8)
    text = np.repeat(np.repeat(glyphs, 2, 0), 2, 1)[..., None] * 190 + 25
    f[6:58, 10:100] = text[6:58, 10:100]
    f[12:40, 104:124] = (230, 230, 240)                   # flat window
    return f


def _band_script():
    d0 = _desktop(3)
    d1 = np.concatenate([d0[5:], _desktop(4)[:5]])        # scroll by 5
    d2 = d1.copy()
    d2[52:58, 40:52] = 255 - d2[52:58, 40:52]             # typing, row 3
    d3 = np.roll(d2, -2, axis=1)                          # pan: all rows
    d4 = d3.copy()
    d4[2:8, 60:70] = 0                                    # typing, row 0
    noise = np.random.default_rng(5).integers(0, 256, (64, 128, 3),
                                              dtype=np.uint8)
    d5 = d4.copy()
    d5[40:46, 20:30] = 255                                # typing, row 2
    return [(d0, False), (d1, False), (d2, False), (d2, False), (d2, False),
            (d2, False), (d3, False), (d3, True), (d4, False),
            (noise, False), (noise, False), (d5, False)]


def _band_frames(config):
    script = _band_script()
    return script if config == "default" else script[:OVERFLOW_AT]


def _band_cap() -> int:
    """An out_cap between the largest frame before the overflow episode
    (of any configuration, measured on port sessions) and the noise
    frame of the default configuration."""
    sizes = {}
    for name, change in CONFIGS.items():
        sess = H264EncoderSession(CaptureSettings(**BAND_KW, **change),
                                  device="cpu")
        sizes[name] = [sum(len(c.payload) for c in sess.finalize(
            sess.encode(f, force=force))) for f, force in _band_script()]
    before = max(max(v[:OVERFLOW_AT]) for v in sizes.values())
    noise = sizes["default"][OVERFLOW_AT]
    assert before < noise, (before, noise)
    return (before + noise) // 2


def _band_run(sess, frames, jax_side: bool, stream: bool = False):
    out = []
    for frame, force in frames:
        res = sess.encode(frame, force=force)
        chunks = list(sess.finalize_stream(res)) if stream \
            else sess.finalize(res)
        st = {k: np.array(getattr(sess, k)) if jax_side
              else np.array(getattr(sess, k).numpy()) for k in STATE}
        st["_host_age"] = np.array(sess._host_age)
        st.update({k: getattr(sess, k) for k in SCALARS + BAND_ATTRS})
        out.append((chunks, st, res.get("band")))
    return out


@pytest.fixture(scope="module")
def band_cap():
    return _band_cap()


@pytest.fixture(scope="module")
def band_runs(band_cap):
    cache = {}

    def get(config):
        if config not in cache:
            kw = dict(BAND_KW, **CONFIGS[config])
            js = JSession(JSettings(**kw))
            ts = H264EncoderSession(CaptureSettings(**kw), device="cpu")
            _shrink(js, band_cap)
            _shrink(ts, band_cap)
            frames = _band_frames(config)
            cache[config] = {"jax": _band_run(js, frames, True),
                             "port": _band_run(ts, frames, False),
                             "session": ts}
        return cache[config]
    return get


BAND_CASES = [(c, i) for c in CONFIGS for i in range(len(_band_frames(c)))]


@pytest.mark.parametrize("config,i", BAND_CASES)
def test_band_session_frame_equals_reference(band_runs, config, i):
    runs = band_runs(config)
    jc, js, jband = runs["jax"][i]
    tc, ts, tband = runs["port"][i]
    assert _astuples(tc) == _astuples(jc)
    assert tband == jband
    for k in BAND_STATE + SCALARS + BAND_ATTRS:
        assert np.array_equal(np.asarray(js[k]), np.asarray(ts[k])), k


def test_band_session_covers_the_cases(band_runs):
    port = band_runs("default")["port"]
    assert [len(c) for c, _, _ in port] == BAND_EXPECT
    bands = [b for _, _, b in port]
    assert bands[1] == (0, 4) and bands[2] == (2, 2)     # scroll, typing
    assert bands[4] == (0, 2) and bands[5] == (2, 2)     # paint-overs
    assert bands[6] == (0, 4) and bands[7] is None       # pan, forced IDR
    assert port[3][1]["last_band_rows"] == 0             # idle
    assert port[OVERFLOW_AT][1]["_cap_gen"] == 1         # band overflow
    assert all(c.is_idr for c in port[OVERFLOW_AT + 1][0])
    zero = band_runs("zero_mv_bands")["port"]
    assert zero[2][2] == (3, 1)                          # one-row band
    stock = band_runs("motion_stock")["port"]
    assert all(b is None for _, _, b in stock)


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("stripe", [0, 1])
def test_band_session_decodes_to_port_recon(band_runs, config, stripe):
    """The JAX package's reference decoder, fed every access unit the
    port delivered for a stripe, ends on the port's reference planes."""
    port = band_runs(config)["port"]
    aus = [c.payload for chunks, _, _ in port for c in chunks
           if c.stripe_y == 32 * stripe]
    y, u, v = refdec.decode(b"".join(aus))
    final = port[-1][1]
    assert np.array_equal(y, final["_ref_y"][32 * stripe:32 * stripe + 32])
    assert np.array_equal(u, final["_ref_u"][16 * stripe:16 * stripe + 16])
    assert np.array_equal(v, final["_ref_v"][16 * stripe:16 * stripe + 16])


def test_band_finalize_stream_matches_finalize(band_runs, band_cap):
    ts = H264EncoderSession(CaptureSettings(**BAND_KW, **CONFIGS["default"]),
                            device="cpu")
    _shrink(ts, band_cap)
    got = _band_run(ts, _band_frames("default"), False, stream=True)
    for (gc, _, _), (wc, _, _) in zip(got, band_runs("default")["port"]):
        assert _astuples(gc) == _astuples(wc)


@pytest.fixture(scope="module")
def band_carried(band_runs, band_cap):
    """A port session loaded with the JAX band session's state (host age
    mirror included) after frame BAND_CARRY_AT, run over the rest."""
    ts = H264EncoderSession(CaptureSettings(**BAND_KW, **CONFIGS["default"]),
                            device="cpu")
    _shrink(ts, band_cap)
    port_state.session_state_from_numpy(
        ts, band_runs("default")["jax"][BAND_CARRY_AT][1])
    return _band_run(ts, _band_frames("default")[BAND_CARRY_AT + 1:], False)


@pytest.mark.parametrize("i", range(BAND_CARRY_AT + 1, len(BAND_EXPECT)))
def test_band_state_carry_continues_identically(band_runs, band_carried, i):
    tc, ts, _ = band_carried[i - BAND_CARRY_AT - 1]
    jc, js, _ = band_runs("default")["jax"][i]
    assert _astuples(tc) == _astuples(jc)
    for k in BAND_STATE + SCALARS:
        assert np.array_equal(np.asarray(js[k]), np.asarray(ts[k])), k


def test_band_state_round_trip(band_runs):
    src = band_runs("default")["session"]
    d = port_state.session_state_to_numpy(src)
    assert np.array_equal(d["_host_age"], src._host_age)
    dst = H264EncoderSession(CaptureSettings(**BAND_KW, **CONFIGS["default"]),
                             device="cpu")
    port_state.session_state_from_numpy(dst, d)
    back = port_state.session_state_to_numpy(dst)
    for k in d:
        assert np.array_equal(np.asarray(d[k]), np.asarray(back[k])), k
