"""ScreenCapture: the engine front door on PyTorch/CUDA.

The counterpart of selkies_tpu/engine/capture.py, with the reference's
API (``start_capture(callback, CaptureSettings)``, ``stop_capture``,
``restart``, ``request_idr_frame``, ``update_tunables``, the pipeline
clamp, ``screenshot``) and threading model: a capture thread pulls a
frame from the source, pads it to the encode grid on the device (K11
``pad_frame``, ops/frames.py), dispatches the session's ``encode`` and
hands the slot to the depth-N :class:`~.pipeline.PipelineRing`, whose
finalizer thread reads back, packetizes and delivers
:class:`~.types.EncodedChunk`s to the callback in order, with up to
``settings.pipeline_depth`` frames in flight (default
:data:`PIPELINE_DEPTH`). Depth 1 is the frame-serial engine. Delivery is
in order per display, always — pipelining is never observable in the
byte stream.

On the card the capture thread queues every frame's kernels on its
current stream; the sessions read frame N back on their own copy stream
after frame N's done event (engine/readback.py), so the fetch does not
wait for frame N+1's kernels.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from .._device import resolve_device
from ..obs import health as _health
from ..obs.energy import meter as _energy_meter
from ..ops.frames import pad_frame
from ..resilience import faults as _faults
from ..trace import tracer as _tracer
from .encoder import JpegEncoderSession
from .pipeline import PipelineRing, cause_of, retarget
from .sources import FrameSource, make_source
from .types import CaptureSettings, EncodedChunk

logger = logging.getLogger("selkies_tpu_torch.engine.capture")

#: bound on joining the capture thread at stop/restart — a hung source
#: (dead X connection, wedged device transport) must not wedge the
#: executor thread that called restart() forever
JOIN_TIMEOUT_S = 5.0

#: default frames in flight between device dispatch and delivery (the
#: ``pipeline_depth`` setting's default): the host packetize tail of
#: frame N overlaps frame N+1's device step. 1 = frame-serial.
PIPELINE_DEPTH = 2


# Process-wide frame-turn lock: every capture loop takes one frame turn
# at a time, so a thread that always has work to dispatch cannot starve
# another display's capture thread; each releases between frames. Here
# it scopes one frame's launches.
_ENCODE_TURN = threading.Lock()


class ScreenCapture:
    """One capture+encode instance per display (persistent across client
    reconnects).

    ``device`` None means ``cuda`` (raises when CUDA is absent); pass
    ``"cpu"`` to run the sessions and the frame functions' plain
    versions."""

    def __init__(self, source_kind: str = "auto", device=None):
        self._source_kind = source_kind
        self.device = resolve_device(device)
        self._thread: Optional[threading.Thread] = None
        self._running = threading.Event()
        self._settings: Optional[CaptureSettings] = None
        self._session: Optional[JpegEncoderSession] = None
        self._source: Optional[FrameSource] = None
        self._callback: Optional[Callable[[EncodedChunk], None]] = None
        self._cursor_callback = None
        self._force_idr = threading.Event()
        self._lock = threading.Lock()
        # serialises start/stop/restart/region calls: the service runs them
        # on executor threads, so two clients' reconfigures may race
        self._api_lock = threading.RLock()
        self._shot_request = threading.Event()
        self._shot_ready = threading.Event()
        self._shot_result = None
        self._shot_lock = threading.Lock()
        self._tunables_dirty: dict = {}
        # stats for rate control / observability
        self.last_frame_bytes = 0
        self.encoded_fps = 0.0
        #: supervision hook: called with the exception when the capture
        #: loop DIES (not on deliberate stop). Callers on another thread
        #: hop to their loop themselves (``call_soon_threadsafe``).
        self.on_death: Optional[Callable[[BaseException], None]] = None
        #: threads abandoned by a timed-out join (each one is a leaked
        #: OS thread + source — counted, never silent)
        self.abandoned_threads = 0
        self.join_timeout_s = JOIN_TIMEOUT_S
        #: runtime clamp on frames in flight (relay backpressure: a
        #: paused client clamps to 1 so the engine stops racing ahead
        #: of a stalled wire); None = unclamped. Read per tick.
        self._pipeline_clamp: Optional[int] = None
        #: delivered-frame byte counts pending rate-control accounting
        #: (finalizer thread appends, capture thread drains — rate
        #: control always runs on the capture thread)
        self._delivered_pending: list = []
        self._delivered_lock = threading.Lock()
        #: content classifier (engine/content.py): fed the
        #: per-frame dirty fraction by the capture thread; rebuilt per
        #: run. Written by start_capture under _api_lock, read by the
        #: capture thread and the stats/metrics pollers.
        self._content = None
        #: content-profile qp bias currently applied to the session
        #: (so class changes shift qp RELATIVELY and never stomp a
        #: client-chosen quality level), plus the qp value WE last
        #: wrote — an external write (client tunable) in between means
        #: the embedded bias was overwritten and must rebase to 0
        self._content_qp_bias = 0
        self._content_qp_seen = None

    # -- reference API surface ----------------------------------------------
    def start_capture(self, callback: Callable[[EncodedChunk], None],
                      settings: CaptureSettings) -> None:
        """Start (or live-reconfigure) the capture/encode loop."""
        with self._api_lock:
            # unconditional: a DEAD loop (thread exited on an exception)
            # still holds an open source that must be closed before the
            # new one replaces it — the supervised-restart path
            self.stop_capture()
            self._callback = callback
            self._settings = settings
            if settings.output_mode == "h264":
                # stripe_devices > 1 (split-frame over several devices)
                # raises in the session: not ported yet (ROADMAP A11)
                from .h264_encoder import H264EncoderSession
                self._session = H264EncoderSession(settings, self.device)
            else:
                self._session = JpegEncoderSession(settings, self.device)
            # per-frame CBR state: empty bucket, base = the session's
            # crf. Under self._lock: an ABANDONED capture thread (timed
            # -out join) may still be inside _rate_control_frame when
            # the replacement run resets the bucket — unlocked, the
            # stale thread's read-modify-write could resurrect the old
            # fullness and steer the NEW session's qp off a stale bucket
            with self._lock:
                self._rc_fullness = 0.0
                self._rc_qp0 = getattr(self._session, "qp",
                                       settings.video_crf)
            # content classifier: h264 sessions with the partial path
            # carry a live dirty-fraction signal; the classifier maps it
            # to a rate-control profile per class.
            # The bias reset shares the rc-state lock: an abandoned
            # capture thread may still be inside _content_tick when the
            # replacement run resets — unlocked, its stale bias could
            # land on the NEW session's qp accounting.
            self._content = None
            with self._lock:
                self._content_qp_bias = 0
                self._content_qp_seen = None
            # same gate as the session's partial path: without damage
            # gating there is no dirty-fraction signal and the EWMAs
            # would converge on a constant 1.0 ("video") for any content
            if settings.output_mode == "h264" \
                    and settings.use_damage_gating and getattr(
                    settings, "h264_content_adaptive", True) and getattr(
                    settings, "h264_partial_encode", False):
                from .content import ContentClassifier
                self._content = ContentClassifier()
            self._source = make_source(self._source_kind,
                                       settings.capture_width,
                                       settings.capture_height,
                                       settings.x_display
                                       or settings.display_id,
                                       device=self.device)
            # fresh Event per run: an ABANDONED thread (timed-out join)
            # still waits on the old one — re-setting a shared event
            # would resurrect it into a second concurrent capture loop
            self._running = threading.Event()
            self._running.set()
            self._thread = threading.Thread(
                target=self._run, name="tpuflux-capture", daemon=True)
            self._thread.start()

    def stop_capture(self) -> None:
        with self._api_lock:
            self._running.clear()
            wedged = False
            if self._thread is not None:
                self._thread.join(timeout=self.join_timeout_s)
                if self._thread.is_alive():
                    # bounded-join escalation: a hung source must not
                    # wedge the caller (often an executor thread running
                    # restart()) forever. The thread and its source are
                    # ABANDONED — deliberately leaked, because closing a
                    # source a live thread still reads is a crash.
                    wedged = True
                    self.abandoned_threads += 1
                    logger.error(
                        "capture thread for %s did not stop within %.1fs; "
                        "abandoning it (%d abandoned so far)",
                        self._settings.display_id if self._settings
                        else "?", self.join_timeout_s,
                        self.abandoned_threads)
                    _health.engine.recorder.record(
                        "capture_thread_wedged",
                        display=self._settings.display_id
                        if self._settings else None,
                        abandoned=self.abandoned_threads)
                    _metrics_abandoned()
                self._thread = None
            if self._source is not None:
                if not wedged:
                    self._source.close()
                self._source = None

    def is_capturing(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def request_idr_frame(self) -> None:
        """JPEG stripes are always intra; a keyframe request means 'resend
        every stripe' (chain-gating recovery)."""
        self._force_idr.set()

    def update_framerate(self, fps: float) -> None:
        with self._lock:
            self._tunables_dirty["target_fps"] = float(fps)

    def update_video_bitrate(self, kbps: int) -> None:
        with self._lock:
            self._tunables_dirty["video_bitrate_kbps"] = int(kbps)

    def update_tunables(self, **kw) -> None:
        with self._lock:
            self._tunables_dirty.update(kw)

    def set_pipeline_clamp(self, depth: Optional[int]) -> None:
        """Clamp frames in flight (relay backpressure window / ladder):
        the effective depth becomes ``min(settings.pipeline_depth,
        depth)``. ``None`` lifts the clamp. Takes effect within one
        frame turn; no session rebuild. Lock-guarded like the other
        cross-thread tunables: the relay writes it from the loop while
        the capture thread reads it every tick."""
        with self._lock:
            self._pipeline_clamp = None if depth is None \
                else max(1, int(depth))

    def effective_pipeline_depth(self) -> int:
        """The depth the loop is currently allowed to run at."""
        from .pipeline import effective_depth
        with self._lock:
            clamp = self._pipeline_clamp
        return effective_depth(self._settings, clamp, PIPELINE_DEPTH)

    def update_capture_region(self, x: int, y: int, w: int, h: int) -> None:
        # live region retarget; requires a session rebuild when the size
        # changes.
        with self._api_lock:
            assert self._settings is not None
            self._settings.capture_x, self._settings.capture_y = x, y
            if (w, h) != (self._settings.capture_width,
                          self._settings.capture_height):
                self._settings.capture_width = w
                self._settings.capture_height = h
                if self._callback is not None:
                    self.start_capture(self._callback, self._settings)

    def restart(self, settings: Optional[CaptureSettings] = None) -> None:
        """Blocking structural restart keeping the registered callback.

        Joins the capture thread — callers on an asyncio loop must run this
        in an executor."""
        with self._api_lock:
            if self._callback is None:
                raise RuntimeError("restart before start_capture")
            self.start_capture(self._callback, settings or self._settings)

    def set_cursor_callback(self, cb) -> None:
        self._cursor_callback = cb

    def screenshot(self, timeout: float = 5.0):
        """Latest captured frame as an (H, W, 3) uint8 numpy array (the
        visible crop), or None when idle. The device->host copy is made
        BY THE CAPTURE THREAD between steps, on its own stream: the
        session's damage reference is updated in place by the next
        frame's kernels, queued on that same stream."""
        if not self.is_capturing():
            return None
        # serialise concurrent callers: the event pair is single-waiter
        with self._shot_lock:
            self._shot_ready.clear()
            self._shot_request.set()
            if not self._shot_ready.wait(timeout):
                return None
            return self._shot_result

    def _serve_screenshot(self) -> None:
        """Runs on the capture thread when a screenshot was requested."""
        if not self._shot_request.is_set():
            return
        self._shot_request.clear()
        sess = self._session
        shot = None
        if sess is not None and getattr(sess, "_prev", None) is not None:
            w, h = sess.visible_size
            shot = sess._prev[:h, :w].cpu().numpy().copy()
        self._shot_result = shot
        self._shot_ready.set()

    # -- loop ----------------------------------------------------------------
    def _apply_tunables(self) -> None:
        with self._lock:
            dirty, self._tunables_dirty = self._tunables_dirty, {}
        if not dirty or self._settings is None or self._session is None:
            return
        for k, v in dirty.items():
            if hasattr(self._settings, k):
                setattr(self._settings, k, v)
        if "jpeg_quality" in dirty or "paint_over_quality" in dirty:
            self._session.update_quality(self._settings.jpeg_quality,
                                         self._settings.paint_over_quality)

    def _rate_control_frame(self, frame_bytes: float) -> None:
        """Per-frame CBR for H.264: a leaky-bucket virtual buffer steers
        qp around a slowly-adapting base (reference's measured-CBR
        behaviour, settings.py:177-183). qp travels in the slice header,
        so every frame can carry a different value — no restart, no
        recompile, no host round-trip."""
        s, sess = self._settings, self._session
        if s is None or sess is None or not s.use_cbr \
                or s.output_mode != "h264":
            return
        fps = max(s.target_fps, 1.0)
        rate_bps8 = s.video_bitrate_kbps * 125.0      # bytes per second
        # rc state under self._lock: races start_capture's reset when an
        # abandoned thread outlives its run (see start_capture)
        with self._lock:
            self._rc_fullness = max(-rate_bps8, min(
                rate_bps8,
                self._rc_fullness + frame_bytes - rate_bps8 / fps))
            fullness, qp0 = self._rc_fullness, self._rc_qp0
        # bucket at +-1 s of rate maps to +-8 qp around the base
        qp = int(round(qp0 + fullness / rate_bps8 * 8.0))
        qp = max(s.video_min_qp, min(s.video_max_qp, qp))
        if qp != sess.qp:
            sess.set_qp(qp)

    def _rate_control(self, window_bytes: int, window_s: float) -> None:
        """1 s window pass: JPEG nudges quality; H.264 re-centres the
        per-frame controller's BASE qp when the bucket pins at a rail
        (content that can't hit the target inside the +-8 fast range)."""
        s, sess = self._settings, self._session
        if s is None or sess is None or not s.use_cbr or window_s <= 0:
            return
        actual_kbps = window_bytes * 8 / 1000 / window_s
        if s.output_mode == "h264":
            rate_bps8 = s.video_bitrate_kbps * 125.0
            # same lock discipline as _rate_control_frame: the base-qp
            # re-centre must not interleave with a reconfigure's reset
            with self._lock:
                pinned = abs(self._rc_fullness) >= rate_bps8 * 0.95
                if pinned and self._rc_fullness > 0 \
                        and self._rc_qp0 < s.video_max_qp:
                    # adapt faster the further off target the content
                    # sits
                    step = 2 if actual_kbps > s.video_bitrate_kbps * 2 \
                        else 1
                    self._rc_qp0 = min(self._rc_qp0 + step,
                                       s.video_max_qp)
                elif pinned and self._rc_fullness < 0 \
                        and actual_kbps < s.video_bitrate_kbps * 0.7 \
                        and self._rc_qp0 > s.video_min_qp:
                    self._rc_qp0 -= 1
            return
        q = s.jpeg_quality
        if actual_kbps > s.video_bitrate_kbps * 1.15 and q > 10:
            sess.update_quality(max(10, q - 5), s.paint_over_quality)
        elif actual_kbps < s.video_bitrate_kbps * 0.7 and q < 90:
            sess.update_quality(min(90, q + 5), s.paint_over_quality)

    def _run(self) -> None:
        assert self._settings and self._session and self._source
        s, sess, src = self._settings, self._session, self._source
        # THIS run's lifetime flag: self._running is replaced by the
        # next start_capture, and this thread must only ever observe
        # (and clear) its own
        running = self._running
        turn = _ENCODE_TURN
        g = sess.grid
        pad = (src.height, src.width) != (g.height, g.width)
        # depth-N pipeline (engine/pipeline.py): dispatch here, finalize
        # on the ring's thread. Depth 1 (serial) finalizes inline — the
        # pre-pipeline engine, byte-identical by test contract.
        ring: Optional[PipelineRing] = None
        tick = 0
        window_bytes, window_start = 0, time.monotonic()
        fps_frames = 0
        last_full = time.monotonic()
        try:
            while running.is_set():
                t0 = time.monotonic()
                self._apply_tunables()
                # live depth retarget (pipeline_depth tunable, ladder
                # rung-0, backpressure clamp): rebuild/resize the ring
                # between frames, never mid-slot
                ring = retarget(ring, self.effective_pipeline_depth(),
                                self._deliver, f"cap-{s.display_id}")
                # span tracing (trace/): one timeline per frame,
                # begun here, bound to the encoder's frame id after
                # dispatch, ended at delivery up to depth turns later
                tl = _tracer.frame_begin(s.display_id)
                with _tracer.span("capture", tl):
                    # fault point: a raise kills the loop (exercising
                    # the supervised-restart path), a freeze stalls it
                    _faults.registry.perturb("capture.source")
                    frame = src.get_frame(tick)
                with _tracer.span("convert", tl):
                    if pad:
                        # pad COPIES into a new grid-sized frame: its
                        # input is often a source-cached static frame,
                        # the copy is the session's to stamp in place
                        frame = pad_frame(frame, g.height, g.width)
                # periodic full refresh (keyframe_interval_s) on top of
                # client-requested IDRs; <=0 disables the cadence. Decided
                # BEFORE encode: the h264 session's on-device idr parity
                # must count forced sends. The content profile may
                # override the cadence (gaming wants fast recovery).
                force = self._force_idr.is_set()
                kf_s = s.keyframe_interval_s
                ctl = self._content
                if ctl is not None and ctl.profile.idr_cadence_s:
                    kf_s = ctl.profile.idr_cadence_s
                if kf_s > 0 and t0 - last_full >= kf_s:
                    force = True
                if force:
                    last_full = t0
                    self._force_idr.clear()
                # the turn lock scopes one frame's launches: a capture
                # that always has work to dispatch otherwise starves every
                # OTHER capture thread; uncontended cost is nanoseconds.
                # The finalizer thread fetches OUTSIDE the turn — that
                # overlap is the point of the pipeline.
                with turn:
                    out = sess.encode(frame, force=force, owned=pad)
                    out["force"] = force
                    _tracer.bind(tl, out["frame_id"])
                if ring is not None:
                    # blocks while `depth` frames are in flight — the
                    # engine's own backpressure; raises PipelineError
                    # if a previous slot's finalize died
                    ring.submit(out)
                else:
                    out["slot"] = 0
                    self._deliver(out)
                # content classification: the partial
                # dispatch left this frame's dirty fraction on the
                # session; a class change applies the profile here on
                # the capture thread (it owns rate control)
                if ctl is not None:
                    self._content_tick(ctl, sess, s)
                # rate control runs HERE (capture thread) on delivery
                # accounting the finalizer queued — session quant/qp
                # mutations must never race the dispatch path
                for nb in self._drain_delivered():
                    window_bytes += nb
                    self._rate_control_frame(nb)
                # cursor image changes ride the same thread; the callback
                # hops to the loop like frame chunks do
                cb = self._cursor_callback
                if cb is not None and hasattr(src, "poll_cursor"):
                    try:
                        cur = src.poll_cursor()
                        if cur is not None:
                            cb(cur)
                    except Exception:
                        logger.debug("cursor poll failed", exc_info=True)
                self._serve_screenshot()
                tick += 1
                fps_frames += 1
                now = time.monotonic()
                if now - window_start >= 1.0:
                    self._rate_control(window_bytes, now - window_start)
                    self.encoded_fps = fps_frames / (now - window_start)
                    window_bytes, window_start, fps_frames = 0, now, 0
                # pace to target fps
                period = 1.0 / max(s.target_fps, 1.0)
                sleep = period - (time.monotonic() - t0)
                if sleep > 0:
                    time.sleep(sleep)
            if ring is not None:        # clean stop: drain in flight
                ring.close(drain=True)
                ring = None
        except Exception as e:
            # a PipelineError wraps the finalizer's death — report the
            # root cause, not the messenger
            cause = cause_of(e)
            logger.exception("capture loop died")
            _health.engine.recorder.record(
                "capture_death", display=s.display_id,
                error=f"{type(cause).__name__}: {cause}"[:200])
            running.clear()
            # supervision hook AFTER state is consistent: the supervisor
            # may restart us from another thread immediately
            hook = self.on_death
            if hook is not None:
                try:
                    hook(cause)
                except Exception:
                    logger.exception("capture on_death hook failed")
        finally:
            running.clear()
            if ring is not None:
                # death path: discard in-flight slots (the supervisor
                # rebuilds the session and forces an IDR) — the ring
                # must never wedge the restart
                ring.close(drain=False)

    def _content_tick(self, ctl, sess, s: CaptureSettings) -> None:
        """One classifier update from the frame just dispatched; on a
        class change (or the very first frame — the initial class's
        profile must apply too, not only transitions away from it),
        apply the profile (band floor + qp bias) and record the
        transition as a flight-recorder incident."""
        df = float(getattr(sess, "dirty_fraction", 1.0))
        prev_cls = ctl.current
        cur = ctl.update(df)
        if cur == prev_cls and ctl.frames > 1:
            return
        profile = ctl.profile
        if hasattr(sess, "set_content_profile"):
            sess.set_content_profile(profile)
        # qp bias only without CBR — the leaky-bucket controller owns
        # qp there and a static bias would fight it every frame. The
        # bias moves qp RELATIVE to its current value (swapping out the
        # previous class's bias first): the base may be a client-chosen
        # quality level, not video_crf, and must survive class changes.
        # Bookkeeping records the delta ACTUALLY applied after the 8..48
        # clamp, so a truncated step near the bounds unwinds exactly and
        # qp can never drift away from base+bias across transitions.
        if not s.use_cbr and hasattr(sess, "set_qp"):
            qp0 = int(sess.qp)
            with self._lock:
                if self._content is not ctl:
                    # a replacement run reset the accounting while this
                    # (abandoned) thread was mid-tick: its stale bias
                    # must not land on the NEW run's books
                    return
                if self._content_qp_seen not in (None, qp0):
                    # external qp write (client tunable) overwrote the
                    # embedded bias — the new value is the client's
                    # chosen base, carrying no bias
                    self._content_qp_bias = 0
                target = qp0 + profile.qp_bias - self._content_qp_bias
                new_qp = max(8, min(48, target))
                self._content_qp_bias += new_qp - qp0
                self._content_qp_seen = new_qp
            if new_qp != qp0:
                sess.set_qp(new_qp)
        if cur != prev_cls:
            _health.engine.recorder.record(
                "content_class_change", display=s.display_id,
                from_class=prev_cls, to_class=cur,
                dirty_fraction=round(df, 4))

    def content_state(self) -> dict:
        """Classifier + dirty-fraction block for /api/sessions and the
        bounded-cardinality session gauges (obs/qoe)."""
        sess = self._session
        df = getattr(sess, "dirty_fraction", None) if sess is not None \
            else None
        ctl = self._content
        if ctl is None:
            return {"dirty_fraction": df}
        doc = ctl.snapshot()
        doc["dirty_fraction"] = df
        return doc

    def _drain_delivered(self) -> list:
        with self._delivered_lock:
            out, self._delivered_pending = self._delivered_pending, []
        return out

    def _deliver(self, out: dict) -> int:
        """Finalize + hand chunks to the callback. Runs on the ring's
        finalizer thread at depth >= 2, inline at depth 1; either way
        strictly in submission order. With ``stripe_streaming`` each
        stripe ships AS ITS BYTES LAND (per-stripe fetch) instead of
        after the frame barrier."""
        sess = self._session
        assert sess is not None
        s = self._settings
        nbytes = 0
        cb = self._callback
        stream = getattr(sess, "finalize_stream", None) \
            if (s is not None and s.stripe_streaming) else None
        if stream is not None:
            for c in stream(out, force_all=out.get("force", False)):
                nbytes += len(c.payload)
                if cb is not None:
                    cb(c)
        else:
            chunks = sess.finalize(out, force_all=out.get("force", False))
            for c in chunks:
                nbytes += len(c.payload)
                if cb is not None:
                    cb(c)
        self.last_frame_bytes = nbytes
        with self._delivered_lock:
            self._delivered_pending.append(nbytes)
        # energy plane: delivered-frame stamp feeding the live fps
        # estimate (one deque append under a lock)
        _energy_meter.note_frame()
        if s is not None:
            # chunks are now queued toward the loop; ws send/ACK spans
            # attach later by frame id while the timeline sits in the ring
            _tracer.frame_end(s.display_id, out["frame_id"])
        return nbytes


# -- optional metrics bridge (lazy; mirrors obs.health's pattern) ----------

def _metrics_abandoned() -> None:
    try:
        from ..server import metrics
    except Exception:
        return
    metrics.describe("selkies_capture_abandoned_threads_total",
                     "Capture threads abandoned after a timed-out join")
    metrics.inc_counter("selkies_capture_abandoned_threads_total")
