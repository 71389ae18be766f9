"""The port's ScreenCapture on the CPU (``device="cpu"``).

- The capture loop's contracts, as the JAX package's tests state them for
  its own loop (tests/test_engine.py, tests/test_pipeline.py): delivery,
  the keyframe cadence, in-order delivery at depth 2 and 3, the pipeline
  clamp and ``effective_pipeline_depth``, a ``readback.fetch`` death
  reaching ``on_death`` and ``restart()`` delivering again, the rate
  controller's lock discipline, CBR, content ticks, screenshots, the
  abandoned-thread count.
- A capture run against the JAX session: with CBR, the keyframe cadence
  and content adaptivity off, the loop's chunks per ``frame_id`` equal
  the JAX session fed the reference's synthetic frames tick by tick,
  padded to the grid, for both codecs (a watermark at location 6).
- Both sessions with ``watermark_path`` (JPEG; H.264 in its default
  configuration, candidates reduced to vrange 4 / hrange 2 as in the
  other port tests) against the JAX sessions, on the scenario of
  tests/test_engine.py::test_watermark_burned_into_stream.

Every wall-clock loop has its own 30 s deadline. Tolerance: 0.
"""

import dataclasses
import io
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from selkies_tpu.engine import capture as J_cap
from selkies_tpu.engine import sources as J_src
from selkies_tpu.engine.encoder import JpegEncoderSession as JJpeg
from selkies_tpu.engine.h264_encoder import H264EncoderSession as JH264
from selkies_tpu.engine.types import CaptureSettings as JSettings
from selkies_tpu_torch.codecs import jpeg as jtab
from selkies_tpu_torch.engine import CaptureSettings, ScreenCapture
from selkies_tpu_torch.engine import capture as T_cap
from selkies_tpu_torch.engine.encoder import JpegEncoderSession
from selkies_tpu_torch.engine.h264_encoder import H264EncoderSession
from selkies_tpu_torch.ops import frames as F
from selkies_tpu_torch.resilience import faults as _faults
from selkies_tpu_torch.trace import tracer

torch.set_num_threads(1)

SMALL = dict(capture_width=64, capture_height=64, stripe_height=32,
             target_fps=240.0, jpeg_quality=75)
#: 60 visible rows on a 64-row grid: every frame goes through the padder
LOOP = dict(SMALL, capture_height=60, use_cbr=False, keyframe_interval_s=0,
            h264_content_adaptive=False)
#: the default H.264 configuration with the candidate set reduced
H264 = dict(output_mode="h264", h264_motion_vrange=4, h264_motion_hrange=2)
DEADLINE_S = 30.0


def _wait(pred, deadline_s=DEADLINE_S):
    deadline = time.monotonic() + deadline_s
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


def _collect(n_want, source="synthetic", **over):
    got = []
    cap = ScreenCapture(source, device="cpu")
    cap.start_capture(got.append, CaptureSettings(**dict(SMALL, **over)))
    try:
        _wait(lambda: len(got) >= n_want)
    finally:
        cap.stop_capture()
    return got, cap


# ------------------------------------------------------------ contracts

def test_screen_capture_thread_delivers_chunks():
    got, cap = _collect(6)
    assert not cap.is_capturing()
    assert len(got) >= 6 and len({c.frame_id for c in got}) >= 2
    for c in got[:4]:
        Image.open(io.BytesIO(c.payload)).load()


def test_keyframe_interval_forces_periodic_refresh():
    got = []
    s = CaptureSettings(**SMALL)
    s.use_paint_over = False
    s.keyframe_interval_s = 0.25
    cap = ScreenCapture("synthetic-static", device="cpu")
    cap.start_capture(got.append, s)
    try:
        assert _wait(lambda: bool(got)), "no first frame"
        n = 2 * (s.capture_height // s.stripe_height)
        _wait(lambda: len(got) >= n + 1)
    finally:
        cap.stop_capture()
    assert len({c.frame_id for c in got}) >= 2


@pytest.mark.parametrize("mode", ["jpeg", "h264"])
@pytest.mark.parametrize("depth", [2, 3])
def test_capture_loop_pipelined_delivery_in_order(depth, mode):
    over = H264 if mode == "h264" else {}
    got, _ = _collect(16, pipeline_depth=depth, **over)
    assert len(got) >= 16
    fids = [c.frame_id for c in got]
    assert fids == sorted(fids)


def test_capture_depth_clamp_and_effective_depth():
    cap = ScreenCapture("synthetic", device="cpu")
    cap._settings = CaptureSettings(**dict(SMALL, pipeline_depth=3))
    assert cap.effective_pipeline_depth() == 3
    cap.set_pipeline_clamp(1)
    assert cap.effective_pipeline_depth() == 1
    cap.set_pipeline_clamp(None)
    assert cap.effective_pipeline_depth() == 3
    cap._settings.pipeline_depth = 1
    cap.set_pipeline_clamp(4)        # a clamp never RAISES the depth
    assert cap.effective_pipeline_depth() == 1


def test_capture_loop_depth_clamp_under_injected_backpressure():
    got, cap = [], ScreenCapture("synthetic", device="cpu")
    cap.start_capture(got.append,
                      CaptureSettings(**dict(SMALL, pipeline_depth=3)))
    try:
        _wait(lambda: len(got) >= 6)
        cap.set_pipeline_clamp(1)
        n_at_clamp = len(got)
        _wait(lambda: len(got) >= n_at_clamp + 6)
    finally:
        cap.stop_capture()
    fids = [c.frame_id for c in got]
    assert fids == sorted(fids)
    assert len(got) >= n_at_clamp + 6


def test_readback_fetch_death_recovers_via_supervised_restart():
    died = threading.Event()
    got = []
    cap = ScreenCapture("synthetic", device="cpu")
    cap.on_death = lambda exc: died.set()
    _faults.registry.disarm()
    _faults.registry.arm("readback.fetch:error:after=6,count=1")
    try:
        cap.start_capture(got.append,
                          CaptureSettings(**dict(SMALL, pipeline_depth=2)))
        assert died.wait(DEADLINE_S), "the readback death must reach on_death"
        cap.restart()
        n0 = len(got)
        assert _wait(lambda: len(got) >= n0 + 4), \
            "the restarted loop must deliver again"
    finally:
        _faults.registry.disarm()
        cap.stop_capture()


@pytest.mark.parametrize("mode", ["jpeg", "h264"])
def test_dispatch_fault_kills_the_loop_through_on_death(mode):
    causes = []
    died = threading.Event()
    cap = ScreenCapture("synthetic", device="cpu")
    cap.on_death = lambda exc: (causes.append(exc), died.set())
    _faults.registry.disarm()
    _faults.registry.arm("encoder.dispatch:device_error:after=2")
    try:
        cap.start_capture(lambda c: None, CaptureSettings(
            **dict(SMALL, **(H264 if mode == "h264" else {}))))
        assert died.wait(DEADLINE_S)
    finally:
        _faults.registry.disarm()
        cap.stop_capture()
    assert isinstance(causes[0], _faults.FaultError)
    assert causes[0].point == "encoder.dispatch"


def test_hung_source_is_abandoned_not_joined_forever(monkeypatch):
    release = threading.Event()

    class Hung:
        width, height = 64, 64

        def get_frame(self, tick):
            release.wait(DEADLINE_S)
            return F.synthetic_frame(64, 64, tick, "cpu")

        def close(self):
            pass
    monkeypatch.setattr(T_cap, "make_source", lambda *a, **k: Hung())
    cap = ScreenCapture("synthetic", device="cpu")
    cap.join_timeout_s = 0.2
    try:
        cap.start_capture(lambda c: None, CaptureSettings(**SMALL))
        cap.stop_capture()
        assert cap.abandoned_threads == 1
    finally:
        release.set()


def test_screenshot_is_the_visible_crop_of_a_captured_frame():
    got = []
    cap = ScreenCapture("synthetic", device="cpu")
    cap.start_capture(got.append, CaptureSettings(**LOOP))
    try:
        _wait(lambda: len(got) >= 4)
        shot = cap.screenshot()
    finally:
        cap.stop_capture()
    assert shot.shape == (60, 64, 3) and shot.dtype == np.uint8
    assert any(np.array_equal(shot,
                              F.synthetic_frame(60, 64, t, "cpu").numpy())
               for t in range(0, 1000))
    assert cap.screenshot() is None           # idle: nothing to show


def test_cbr_raises_qp_over_a_starved_bitrate():
    got, cap = _collect(12, use_cbr=True, video_bitrate_kbps=1,
                        video_crf=25, **H264)
    assert cap._session.qp > 25


def test_content_tick_applies_the_first_class_profile():
    """Content adaptivity (the default) applies the initial class's
    profile from the first frame: the static class sharpens qp by 2."""
    got, cap = _collect(4, video_crf=25, **H264)
    assert cap.content_state()["class"] == "static"
    assert cap._session.qp == 23
    assert 0.0 <= cap.content_state()["dirty_fraction"] <= 1.0


def test_tunables_reach_the_session():
    got = []
    cap = ScreenCapture("synthetic", device="cpu")
    cap.start_capture(got.append, CaptureSettings(**SMALL))
    try:
        _wait(lambda: len(got) >= 2)
        cap.update_tunables(jpeg_quality=20, paint_over_quality=50)
        _wait(lambda: cap._session.settings.jpeg_quality == 20)
    finally:
        cap.stop_capture()
    assert cap._settings.jpeg_quality == 20
    assert cap._session.settings.paint_over_quality == 50
    assert np.array_equal(cap._session._qtabs_np[0], jtab.scale_qtable(
        jtab.STD_LUMA_QUANT, 20))


def test_capture_spans_are_traced_per_slot():
    tracer.clear()
    tracer.enable()
    try:
        _collect(8, pipeline_depth=2)
        tls = tracer.snapshot()
    finally:
        tracer.disable()
        tracer.clear()
    names = {(s[0], s[1].startswith("slot")) for tl in tls
             for s in tl.spans}
    assert {("capture", False), ("convert", False),
            ("encode.dispatch", False), ("encode.readback", True),
            ("packetize", True)} <= names
    assert any(tl.done for tl in tls)


def test_capture_defaults_to_cuda_and_split_frame_raises():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ScreenCapture("synthetic")
    cap = ScreenCapture("synthetic", device="cpu")
    with pytest.raises(NotImplementedError, match="A11"):
        cap.start_capture(lambda c: None, CaptureSettings(
            **dict(SMALL, output_mode="h264", stripe_devices=2)))


class _RecordingLock:
    def __init__(self):
        self.entered = 0
        self.held = False

    def __enter__(self):
        self.entered += 1
        self.held = True
        return self

    def __exit__(self, *exc):
        self.held = False
        return False


class _QpSession:
    def __init__(self):
        self.qp = 30

    def set_qp(self, qp):
        self.qp = qp


def _rc_capture(cls):
    cap = cls("synthetic", device="cpu") if cls is ScreenCapture \
        else cls("synthetic")
    cap._lock = _RecordingLock()
    cap._settings = CaptureSettings(**dict(
        SMALL, output_mode="h264", use_cbr=True, video_bitrate_kbps=1000))
    cap._session = _QpSession()
    cap._rc_fullness = 0.0
    cap._rc_qp0 = 30
    return cap


def test_rate_control_locks_and_steers_like_the_reference():
    caps = [_rc_capture(J_cap.ScreenCapture), _rc_capture(ScreenCapture)]
    trail = []
    for cap in caps:
        qps = []
        for nbytes in [200_000] * 10 + [0] * 300:
            cap._rate_control_frame(nbytes)
            qps.append(cap._session.qp)
        cap._rate_control(5_000_000, 1.0)
        trail.append((qps, cap._rc_qp0, cap._lock.entered, cap._lock.held))
    assert trail[0] == trail[1]
    assert max(trail[1][0]) > 30 and trail[1][0][-1] < 30


# ------------------------------------------- the loop against the JAX session

def _wm_png(tmp_path, color, size=16):
    wm = np.zeros((size, size, 4), np.uint8)
    wm[..., :3] = color
    wm[..., 3] = 255
    wm[size // 2:, :, 3] = 96          # half opaque, half blended
    p = tmp_path / "wm.png"
    Image.fromarray(wm, "RGBA").save(p)
    return str(p)


def _astuples(chunks):
    return [dataclasses.astuple(c) for c in chunks]


@pytest.mark.parametrize("mode", ["jpeg", "h264"])
def test_capture_loop_equals_the_jax_session_tick_by_tick(mode, tmp_path):
    n = 8
    kw = dict(LOOP, pipeline_depth=2, watermark_path=_wm_png(
        tmp_path, (200, 40, 40)), watermark_location=6,
        **(H264 if mode == "h264" else {}))
    got = []
    cap = ScreenCapture("synthetic", device="cpu")
    cap.start_capture(got.append, CaptureSettings(**kw))
    try:
        assert _wait(lambda: any(c.frame_id >= n for c in got))
    finally:
        cap.stop_capture()
    s = JSettings(**kw)
    sess = JH264(s) if mode == "h264" else JJpeg(s)
    g = sess.grid
    gen = J_src._synthetic_fn(s.capture_height, s.capture_width)
    pad = J_cap._padder(s.capture_height, s.capture_width, g.height,
                        g.width)
    for tick in range(n):
        want = sess.finalize(sess.encode(pad(gen(jnp.int32(tick)))))
        assert want, f"frame {tick} sent nothing"
        assert _astuples([c for c in got if c.frame_id == tick]) \
            == _astuples(want), f"frame {tick}"


SESSIONS = {"jpeg": (JJpeg, JpegEncoderSession, {}),
            "h264": (JH264, H264EncoderSession, H264),
            "h264_stock": (JH264, H264EncoderSession, dict(
                H264, h264_motion_vrange=0, h264_partial_encode=False))}


@pytest.mark.parametrize("mode", list(SESSIONS))
def test_session_with_watermark_equals_the_jax_session(mode, tmp_path):
    """The scenario of tests/test_engine.py: a 16x16 red watermark at the
    top-left of a 64x64 synthetic desktop (here half of it blended),
    over a few frames of the moving pattern; H.264 in the default and in
    the stock configuration."""
    jcls, tcls, over = SESSIONS[mode]
    kw = dict(SMALL, watermark_path=_wm_png(tmp_path, (255, 0, 0)),
              watermark_location=0, **over)
    js, ts = jcls(JSettings(**kw)), tcls(CaptureSettings(**kw), device="cpu")
    assert ts.visible_size == js.visible_size == (64, 64)
    gen = J_src._synthetic_fn(64, 64)
    for tick in (0, 1, 2, 2):
        frame = np.array(gen(jnp.int32(tick)))
        want = js.finalize(js.encode(jnp.asarray(frame)))
        got = ts.finalize(ts.encode(frame))
        assert _astuples(got) == _astuples(want), f"tick {tick}"
    assert np.array_equal(ts._prev.numpy(), np.asarray(js._prev))
    # the stamp is in the damage reference: red over the top-left
    corner = ts._prev.numpy()[16:24, 16:32].astype(int)
    assert corner[..., 0].min() == 255 and corner[..., 1].max() == 0
