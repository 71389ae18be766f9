"""Multi-seat capture: one device step a tick drives N desktop displays.

The counterpart of selkies_tpu/parallel/capture.py, with the API of
engine.capture.ScreenCapture so a service can treat it as another
capture module; chunks carry ``display_id="seat{N}"``. Each tick makes
every seat's synthetic frame in one launch (K10's seat entry), encodes
all seats in one step (parallel/seats.py, parallel/h264_seats.py) and
hands the slot to the same depth-N :class:`~..engine.pipeline.PipelineRing`
as ScreenCapture, whose finalizer fans the per-seat chunks out in order.

``device`` None means the card (raises without one); pass ``"cpu"`` to
run the plain versions.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from .._device import resolve_device
from ..engine.capture import _ENCODE_TURN, PIPELINE_DEPTH
from ..engine.pipeline import PipelineRing, cause_of, retarget
from ..engine.types import CaptureSettings, EncodedChunk
from ..obs import health as _health
from ..obs.energy import meter as _energy_meter
from ..resilience import faults as _faults
from ..trace import tracer as _tracer
from .h264_seats import MultiSeatH264Encoder
from .seats import MultiSeatEncoder, synthetic_seat_frames

logger = logging.getLogger("selkies_tpu_torch.parallel.capture")


class MultiSeatCapture:
    """ScreenCapture-compatible facade over the multi-seat encoders."""

    def __init__(self, n_seats: int, device=None):
        self.n_seats = n_seats
        self.device = resolve_device(device)
        self._thread: Optional[threading.Thread] = None
        self._running = threading.Event()
        self._callback: Optional[Callable[[EncodedChunk], None]] = None
        self._settings: Optional[CaptureSettings] = None
        self._enc = None
        self._force_idr = threading.Event()
        self._cursor_callback = None
        self._api_lock = threading.RLock()
        self.encoded_fps = 0.0
        self.last_frame_bytes = 0
        #: supervision hook (ScreenCapture.on_death's contract): called
        #: with the exception when the loop DIES, never on stop
        self.on_death: Optional[Callable[[BaseException], None]] = None
        #: runtime frames-in-flight clamp (ScreenCapture's contract),
        #: written from the loop, read per tick by the capture thread
        self._lock = threading.Lock()
        self._pipeline_clamp: Optional[int] = None

    # -- reference API surface ----------------------------------------------
    def start_capture(self, callback, settings: CaptureSettings) -> None:
        with self._api_lock:
            if self.is_capturing():
                self.stop_capture()
            self._callback = callback
            self._settings = settings
            cls = MultiSeatH264Encoder if settings.output_mode == "h264" \
                else MultiSeatEncoder
            self._enc = cls(settings, self.n_seats, devices=[self.device])
            # a fresh Event per run: a thread abandoned by a timed-out
            # join must never observe a later run's flag
            self._running = threading.Event()
            self._running.set()
            self._thread = threading.Thread(
                target=self._run, name="tpuflux-seats", daemon=True)
            self._thread.start()

    def stop_capture(self) -> None:
        with self._api_lock:
            self._running.clear()
            if self._thread is not None:
                self._thread.join(timeout=5.0)
                self._thread = None

    def is_capturing(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def request_idr_frame(self) -> None:
        self._force_idr.set()

    def update_framerate(self, fps: float) -> None:
        if self._settings:
            self._settings.target_fps = float(fps)

    def update_video_bitrate(self, kbps: int) -> None:
        if self._settings:
            self._settings.video_bitrate_kbps = int(kbps)

    def update_tunables(self, **kw) -> None:
        # settings-shaped tunables land on the loop's settings object;
        # qp and quality also reach into the encoder
        if self._settings is not None:
            for k, v in kw.items():
                if hasattr(self._settings, k):
                    setattr(self._settings, k, v)
        enc = self._enc
        if enc is None:
            return
        if isinstance(enc, MultiSeatH264Encoder):
            if "video_crf" in kw:
                enc.qp = int(max(8, min(48, kw["video_crf"])))
                # paint-over must never be WORSE than motion quality
                enc.paint_qp = min(enc.paint_qp, enc.qp)
        elif "jpeg_quality" in kw or "paint_over_quality" in kw:
            enc.update_quality(kw.get("jpeg_quality",
                                      enc.settings.jpeg_quality),
                               kw.get("paint_over_quality"))

    def update_capture_region(self, x: int, y: int, w: int, h: int) -> None:
        assert self._settings is not None
        if (w, h) != (self._settings.capture_width,
                      self._settings.capture_height):
            self._settings.capture_width = w
            self._settings.capture_height = h
            if self._callback is not None:
                self.start_capture(self._callback, self._settings)

    def set_cursor_callback(self, cb) -> None:
        self._cursor_callback = cb

    def set_pipeline_clamp(self, depth: Optional[int]) -> None:
        with self._lock:
            self._pipeline_clamp = None if depth is None \
                else max(1, int(depth))

    def effective_pipeline_depth(self) -> int:
        from ..engine.pipeline import effective_depth
        with self._lock:
            clamp = self._pipeline_clamp
        return effective_depth(self._settings, clamp, PIPELINE_DEPTH)

    def restart(self, settings: Optional[CaptureSettings] = None) -> None:
        with self._api_lock:
            if self._callback is None:
                raise RuntimeError("restart before start_capture")
            self.start_capture(self._callback, settings or self._settings)

    # -- loop ---------------------------------------------------------------
    def _deliver(self, out: dict) -> None:
        """Finalize one multi-seat slot and fan the per-seat chunks out.
        Runs on the ring's finalizer thread at depth >= 2, inline at
        depth 1; in submission order either way (the seats of a tick
        share ONE slot)."""
        enc = self._enc
        assert enc is not None
        per_seat = enc.finalize(out, force_all=out.get("force", False))
        cb = self._callback
        nbytes = 0
        for chunks in per_seat:
            for c in chunks:
                nbytes += len(c.payload)
                if cb is not None:
                    cb(c)
        self.last_frame_bytes = nbytes
        # energy plane: one delivered tick is one frame stamp
        _energy_meter.note_frame()
        if self._settings is not None:
            _tracer.frame_end(self._settings.display_id, out["frame_id"])

    def _run(self) -> None:
        assert self._settings and self._enc
        s, enc = self._settings, self._enc
        running = self._running     # THIS run's flag only
        tick = 0
        window_frames, window_start = 0, time.monotonic()
        # one timeline covers all seats of a tick; alias keys route the
        # per-seat relay spans onto it
        seat_aliases = tuple(f"seat{i}" for i in range(self.n_seats))
        ring: Optional[PipelineRing] = None
        try:
            while running.is_set():
                t0 = time.monotonic()
                ring = retarget(ring, self.effective_pipeline_depth(),
                                self._deliver, "seats")
                tl = _tracer.frame_begin(s.display_id)
                with _tracer.span("capture", tl):
                    _faults.registry.perturb("capture.source")
                    frames = synthetic_seat_frames(enc, tick)
                force = self._force_idr.is_set()
                if force:
                    self._force_idr.clear()
                with _ENCODE_TURN:
                    if isinstance(enc, MultiSeatH264Encoder):
                        out = enc.encode(frames, force=force)
                    else:
                        out = enc.encode(frames)
                        out["force"] = force or tick == 0
                    _tracer.bind(tl, out["frame_id"], aliases=seat_aliases)
                if ring is not None:
                    ring.submit(out)
                else:
                    out["slot"] = 0
                    self._deliver(out)
                tick += 1
                window_frames += 1
                now = time.monotonic()
                if now - window_start >= 1.0:
                    self.encoded_fps = window_frames / (now - window_start)
                    window_frames, window_start = 0, now
                sleep = 1.0 / max(s.target_fps, 1.0) - (time.monotonic() - t0)
                if sleep > 0:
                    time.sleep(sleep)
            if ring is not None:
                ring.close(drain=True)
                ring = None
        except Exception as e:
            cause = cause_of(e)
            logger.exception("multi-seat capture loop died")
            _health.engine.recorder.record(
                "capture_death", display=s.display_id, seats=self.n_seats,
                error=f"{type(cause).__name__}: {cause}"[:200])
            running.clear()
            hook = self.on_death
            if hook is not None:
                try:
                    hook(cause)
                except Exception:
                    logger.exception("multi-seat on_death hook failed")
        finally:
            running.clear()
            if ring is not None:
                ring.close(drain=False)
