"""The port's 4:4:4 (``fullcolor``) H.264 session against the JAX
package's, frame by frame.

- Stock configuration (zero-MV P, no band path), 64x128 with 32-row
  stripes: an overflow episode on the first frame (out_cap shrunk on
  both sessions), the IDR after the drop, damaged P frames, paint-overs,
  idle frames, a forced IDR, a P frame with a patch of the triples that
  tell the CSC's float orders apart, and a last P. Checked: equal
  EncodedChunk lists, equal full-resolution reference planes, ``prev``,
  ``age``, ``sent``, ``fnum`` and host scalars after every frame,
  libavcodec turning the port's payloads into the port's planes, and the
  JAX session's state carried into a port session mid-script continuing
  byte for byte.
- Default configuration (motion search reduced to vrange 4 / hrange 2,
  the band path), with ``h264_roi_qp`` on, which the reference ignores
  at 4:4:4: IDR, scrolls both ways, a pan, a typing band, idle frames,
  paint-over bands, a full-dirty band, a forced IDR and a P frame;
  chunks, state, band geometry and the MV field. The full-dirty band
  equals the stock P step with motion, and ROI QP on or off gives the
  same chunks.
- The scenario of
  tests/test_h264_bands.py::test_partial_full_dirty_byte_identical_to_stock[444]
  on the port.
- ``ScreenCapture`` at fullcolor (H.264 default, depth 2): the loop's
  chunks equal the JAX session's tick by tick.

Tolerance: 0.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selkies_tpu.engine import capture as J_cap
from selkies_tpu.engine import sources as J_src
from selkies_tpu.engine.h264_encoder import H264EncoderSession as JSession
from selkies_tpu.engine.types import CaptureSettings as JSettings
from selkies_tpu_torch.engine import ScreenCapture
from selkies_tpu_torch.engine import state as port_state
from selkies_tpu_torch.engine.h264_encoder import (H264EncoderSession,
                                                   h264_buffer_caps)
from selkies_tpu_torch.engine.types import CaptureSettings
from selkies_tpu_torch.ops import h264_planes444 as T4
from selkies_tpu_torch.ops.colorspace import _CSC_601_FULL, _fma_f32

torch.set_num_threads(1)

H, W, SH = 64, 128, 32
BASE = dict(capture_width=W, capture_height=H, stripe_height=SH,
            output_mode="h264", fullcolor=True, paint_over_delay_frames=3)
STOCK = dict(BASE, h264_motion_vrange=0, h264_partial_encode=False)
DEFAULT = dict(BASE, h264_motion_vrange=4, h264_motion_hrange=2,
               h264_partial_encode=True, h264_roi_qp=True)
STATE = ("_ref_y", "_ref_u", "_ref_v", "_age", "_sent", "_fnum", "_prev")
SCALARS = ("qp", "paint_qp", "frame_id", "_w_cap", "_out_cap", "_cap_gen",
           "_force_after_drop")


def _astuples(chunks):
    return [dataclasses.astuple(c) for c in chunks]


def _desktop(seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    f = np.stack([yy * 3, xx * 2 + 20, 200 - yy - xx // 2], -1).astype(
        np.uint8)
    f[4:28, 6:100] = rng.integers(0, 256, (24, 94, 3))       # busy panel
    f[40:60, 70:120] = (30, 90, 200)                          # a window
    return f


@functools.lru_cache(maxsize=1)
def _tie_patch():
    """A 32x64 patch holding every RGB triple on which the all-rounded and
    the fused order of the CSC's 3-term dot round differently (as in
    tests/test_torch_h264_444.py)."""
    v = np.arange(1 << 24, dtype=np.uint32)
    rgb = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(
        np.uint8)
    x = torch.from_numpy(rgb).to(torch.float32)
    r, g, b = x[:, 0], x[:, 1], x[:, 2]
    m = _CSC_601_FULL
    ties = torch.zeros(len(rgb), dtype=torch.bool)
    for c, off in enumerate((0.0, 128.0, 128.0)):
        plain = ((r * float(m[c, 0]) + g * float(m[c, 1]))
                 + b * float(m[c, 2])) + off
        fused = _fma_f32(b, m[c, 2], _fma_f32(g, m[c, 1],
                                              r * float(m[c, 0]))) + off
        ties |= torch.round(plain) != torch.round(fused)
    t = rgb[ties.numpy()]
    assert 1000 < len(t) <= 32 * 64
    return np.resize(t, (32 * 64, 3)).reshape(32, 64, 3)


def _run(sess, script, jax_side: bool):
    out = []
    for frame, force in script:
        o = sess.encode(frame, force=force)
        chunks = sess.finalize(o)
        if jax_side:
            st = {k: np.array(getattr(sess, k)) for k in STATE}
        else:
            st = {k: getattr(sess, k).numpy().copy() for k in STATE}
        st.update({k: getattr(sess, k) for k in SCALARS})
        st["band"] = o.get("band")
        out.append((chunks, st))
    return out


# ------------------------------------------------------ stock configuration
def _stock_script():
    f0 = _desktop(2024)
    f1 = f0.copy()
    f1[10:20, 10:40] = 255 - f1[10:20, 10:40]                 # stripe 0
    f2 = f1.copy()
    f2[40:56, 8:24] = (30, 90, 200)                           # stripe 1
    tie = f2.copy()
    tie[32:64, 0:64] = _tie_patch()                           # stripe 1
    return [(f0, False), (f0, False), (f1, False), (f1, False), (f1, False),
            (f1, False), (f1, False), (f1, True), (f2, False), (tie, False),
            (f2, False)]


#: chunks per frame: overflow, IDR after the drop, damaged P, paint-over,
#: idle, paint-over, idle, forced IDR, damaged P, the tie patch, back
STOCK_EXPECT = [0, 2, 1, 1, 0, 1, 0, 2, 1, 1, 1]


def _shrunk_cap() -> int:
    probe = H264EncoderSession(CaptureSettings(**STOCK), device="cpu")
    frame = _stock_script()[0][0]
    return sum(len(c.payload) for c in
               probe.finalize(probe.encode(frame))) * 2 // 3


def _shrink(sess, cap):
    sess._out_cap = cap
    sess._i_step = sess._build_step("i")
    sess._p_step = sess._build_step("p")


@pytest.fixture(scope="module")
def stock_runs():
    cap = _shrunk_cap()
    js = JSession(JSettings(**STOCK))
    ts = H264EncoderSession(CaptureSettings(**STOCK), device="cpu")
    _shrink(js, cap)
    _shrink(ts, cap)
    script = _stock_script()
    return {"jax": _run(js, script, True), "port": _run(ts, script, False)}


@pytest.mark.parametrize("i", range(len(STOCK_EXPECT)))
def test_stock_chunks_equal(stock_runs, i):
    jc, tc = stock_runs["jax"][i][0], stock_runs["port"][i][0]
    assert len(tc) == STOCK_EXPECT[i]
    assert _astuples(tc) == _astuples(jc)


@pytest.mark.parametrize("i", range(len(STOCK_EXPECT)))
def test_stock_state_equal(stock_runs, i):
    js, ts = stock_runs["jax"][i][1], stock_runs["port"][i][1]
    assert ts["_ref_u"].shape == (H, W)                # full resolution
    for k in STATE + SCALARS:
        assert np.array_equal(np.asarray(js[k]), np.asarray(ts[k])), k


def test_stock_overflow_episode_grew_the_4_4_4_caps(stock_runs):
    first = stock_runs["port"][0][1]
    assert first["_cap_gen"] == 1 and first["_force_after_drop"]
    assert all(c.is_idr for c in stock_runs["port"][1][0])
    g = H264EncoderSession(CaptureSettings(**STOCK), device="cpu").grid
    assert stock_runs["port"][-1][1]["_w_cap"] \
        == 2 * h264_buffer_caps(g, True)[1] == 2 * 3072


@pytest.mark.parametrize("stripe", [0, 1])
def test_libavcodec_reproduces_port_recon(stock_runs, stripe):
    """Every access unit the port delivered for a stripe (Hi444PP SPS,
    IDRs and P frames), decoded in order by libavcodec (the JAX
    package's avshim; its spec decoder has no 4:4:4 slice data), ends on
    the port's full-resolution reference planes."""
    from selkies_tpu.native import avshim
    if not avshim.available():
        pytest.skip("libavcodec shim not available")
    ses = avshim.H264Session()
    out = None
    for chunks, _ in stock_runs["port"]:
        for c in chunks:
            if c.stripe_y == SH * stripe:
                out = ses.decode(c.payload) or out
    out = ses.flush() or out
    ses.close()
    final = stock_runs["port"][-1][1]
    rows = slice(SH * stripe, SH * stripe + SH)
    y, u, v = out
    assert u.shape == (SH, W)
    assert np.array_equal(y, final["_ref_y"][rows])
    assert np.array_equal(u, final["_ref_u"][rows])
    assert np.array_equal(v, final["_ref_v"][rows])


CARRY_AT = 3


@pytest.mark.parametrize("i", range(CARRY_AT + 1, len(STOCK_EXPECT)))
def test_stock_state_carries_into_the_port(stock_runs, i):
    """The JAX session's state after frame CARRY_AT (the first
    paint-over), loaded into a fresh port session, continues byte for
    byte over the rest of the script."""
    ts = H264EncoderSession(CaptureSettings(**STOCK), device="cpu")
    port_state.session_state_from_numpy(ts, stock_runs["jax"][CARRY_AT][1])
    carried = _run(ts, _stock_script()[CARRY_AT + 1:i + 1], False)
    tc, tst = carried[-1]
    jc, jst = stock_runs["jax"][i]
    assert _astuples(tc) == _astuples(jc)
    for k in STATE + SCALARS:
        assert np.array_equal(np.asarray(jst[k]), np.asarray(tst[k])), k


# ---------------------------------------------------- default configuration
def _canvas():
    rng = np.random.default_rng(77)
    ch, cw = H + 40, W + 16
    yy, xx = np.mgrid[0:ch, 0:cw]
    c = np.stack([40 + yy, 60 + xx // 2, 230 - yy // 2], -1).astype(np.uint8)
    for top in range(6, ch - 6, 10):                 # text lines
        n = int(rng.integers(20, cw - 20))
        c[top:top + 4, 8:8 + n] = np.where(
            rng.random((4, n, 1)) < 0.4, 30, c[top:top + 4, 8:8 + n])
    return c


def _default_script():
    c = _canvas()

    def at(oy, ox=8):
        return c[oy:oy + H, ox:ox + W].copy()
    typing = at(17, 10)
    typing[40:46, 20:60] = (20, 20, 20)             # stripe 1 only
    bright = np.minimum(typing.astype(np.int32) + 12, 255).astype(np.uint8)
    after = bright.copy()
    after[4:10, 8:50] = 250
    return [("idr", at(20), False), ("scroll+3", at(23), False),
            ("scroll-6", at(17), False), ("pan2", at(17, 10), False),
            ("typing", typing, False), ("idle", typing, False),
            ("paint_others", typing, False), ("paint_typed", typing, False),
            ("idle", typing, False), ("full_dirty", bright, False),
            ("forced_idr", bright, True), ("p_after_idr", after, False)]


@pytest.fixture(scope="module")
def default_runs():
    js = JSession(JSettings(**DEFAULT))
    ts = H264EncoderSession(CaptureSettings(**DEFAULT), device="cpu")
    script = [(f, force) for _, f, force in _default_script()]
    jrun = _run(js, script, True)
    trun, mvs = [], []
    for frame, force in script:
        trun += _run(ts, [(frame, force)], False)
        mvs.append(ts._scratch[3].numpy().copy())
    return {"jax": jrun, "port": trun, "mv": mvs}


NAMES = [n for n, _, _ in _default_script()]


@pytest.mark.parametrize("i", range(len(NAMES)))
def test_default_chunks_and_state_equal(default_runs, i):
    (jc, js), (tc, ts) = default_runs["jax"][i], default_runs["port"][i]
    assert _astuples(tc) == _astuples(jc)
    for k in STATE + SCALARS + ("band",):
        assert np.array_equal(np.asarray(js[k]), np.asarray(ts[k])), k


def test_default_sequence_covers_the_cases(default_runs):
    """Scrolls and the pan choose vectors over whole-frame bands, typing
    and its paint-over a one-stripe band, the full-dirty frame the full
    band, the idle frames nothing."""
    port = default_runs["port"]
    by = {n: port[i] for i, n in enumerate(NAMES)}
    for n in ("scroll+3", "scroll-6", "pan2"):
        assert by[n][1]["band"] == (0, H // 16)
        assert (default_runs["mv"][NAMES.index(n)] != 0).any(), n
    assert (default_runs["mv"][NAMES.index("scroll+3")][..., 1] == 12).any()
    assert (default_runs["mv"][NAMES.index("pan2")][..., 0] == 8).any()
    assert by["typing"][1]["band"] == (2, 2) and len(by["typing"][0]) == 1
    assert by["paint_typed"][1]["band"] == (2, 2)
    assert [len(port[i][0]) for i, n in enumerate(NAMES) if n == "idle"] \
        == [0, 0]
    assert by["full_dirty"][1]["band"] == (0, 4)
    assert all(c.is_idr for c in by["forced_idr"][0])


def test_full_dirty_band_equals_the_stock_p_step_with_motion():
    """The port's 100%-dirty band frame at 4:4:4 gives the bytes and the
    state of the stock P step with motion loaded with the same state."""
    seq = _default_script()
    k = NAMES.index("full_dirty")
    band = H264EncoderSession(CaptureSettings(**DEFAULT), device="cpu")
    for _, frame, force in seq[:k]:
        band.finalize(band.encode(frame, force=force))
    d = port_state.session_state_to_numpy(band)
    stock = H264EncoderSession(CaptureSettings(
        **dict(DEFAULT, h264_partial_encode=False)), device="cpu")
    d["_age"] = np.minimum(d["_host_age"], 2**31 - 1).astype(np.int32)
    port_state.session_state_from_numpy(stock, d)
    frame = seq[k][1]
    want = stock.finalize(stock.encode(frame))
    got = band.finalize(band.encode(frame))
    assert got and _astuples(got) == _astuples(want)
    for key in ("_ref_y", "_ref_u", "_ref_v", "_prev", "_sent", "_fnum"):
        assert torch.equal(getattr(band, key), getattr(stock, key)), key


def test_roi_qp_is_ignored_at_4_4_4():
    """``h264_roi_qp`` with ``fullcolor`` builds (the reference gates ROI
    on ``not fullcolor``) and changes nothing; at 4:2:0 it is on (ROI QP
    is ported: tests/test_torch_roi.py holds it against the reference)."""
    with_roi = H264EncoderSession(CaptureSettings(**DEFAULT), device="cpu")
    without = H264EncoderSession(CaptureSettings(
        **dict(DEFAULT, h264_roi_qp=False)), device="cpu")
    assert with_roi._roi_qp_bias == 0
    for _, frame, force in _default_script()[:6]:
        assert _astuples(with_roi.finalize(with_roi.encode(frame, force))) \
            == _astuples(without.finalize(without.encode(frame, force)))
    s420 = CaptureSettings(**dict(DEFAULT, fullcolor=False))
    assert H264EncoderSession(s420, device="cpu")._roi_qp_bias \
        == s420.h264_roi_qp_bias > 0


# ----------------------------------------------- the bands scenario, ported
BANDS_BASE = dict(capture_width=64, capture_height=64, stripe_height=32,
                  output_mode="h264", video_crf=28, use_paint_over=False,
                  h264_motion_vrange=0, h264_motion_hrange=0, fullcolor=True)


def test_partial_full_dirty_byte_identical_to_stock_444():
    """tests/test_h264_bands.py::test_partial_full_dirty_byte_identical_to_stock[444]
    on the port: three noise frames rolled by 5 rows each, the band path
    against the stock step."""
    rng = np.random.default_rng(1234)
    f0 = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    frames = [np.roll(f0, 5 * t, axis=0) for t in range(3)]

    def chunks(partial):
        sess = H264EncoderSession(CaptureSettings(
            **BANDS_BASE, h264_partial_encode=partial), device="cpu")
        return [[(c.stripe_y, c.is_idr, c.payload) for c in
                 sess.finalize(sess.encode(f, force=(t == 0)))]
                for t, f in enumerate(frames)]
    a, b = chunks(True), chunks(False)
    assert a == b and all(a)


# ------------------------------------------------------------ capture loop
LOOP = dict(DEFAULT, capture_height=60, target_fps=240.0, use_cbr=False,
            keyframe_interval_s=0, h264_content_adaptive=False,
            pipeline_depth=2)


def test_capture_loop_at_fullcolor_equals_the_jax_session():
    """``ScreenCapture("synthetic")`` at fullcolor: 60 visible rows on a
    64-row grid (the padder runs on every frame); per frame id the
    loop's chunks equal the JAX session fed the reference's synthetic
    frames tick by tick, padded to the grid."""
    import time
    n = 6
    got = []
    cap = ScreenCapture("synthetic", device="cpu")
    cap.start_capture(got.append, CaptureSettings(**LOOP))
    try:
        deadline = time.monotonic() + 30
        while not any(c.frame_id >= n for c in got) \
                and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        cap.stop_capture()
    assert any(c.frame_id >= n for c in got)
    s = JSettings(**LOOP)
    sess = JSession(s)
    g = sess.grid
    gen = J_src._synthetic_fn(s.capture_height, s.capture_width)
    pad = J_cap._padder(s.capture_height, s.capture_width, g.height, g.width)
    for tick in range(n):
        want = sess.finalize(sess.encode(pad(gen(jnp.int32(tick)))))
        assert want, f"frame {tick} sent nothing"
        assert _astuples([c for c in got if c.frame_id == tick]) \
            == _astuples(want), f"frame {tick}"


def test_session_uses_the_4_4_4_kernels():
    sess = H264EncoderSession(CaptureSettings(**DEFAULT), device="cpu")
    assert sess._ops is T4.KERNEL_OPS_444 and sess.fullcolor
    assert sess._scratch[1].shape == (H, W)
    assert sess._sps_pps[4 + 1] == 244                # profile_idc Hi444PP
