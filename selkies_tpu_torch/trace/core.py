"""Span tracer core: frame timelines, spans, the ring buffer.

A copy of selkies_tpu/trace/core.py (the port imports nothing of the
JAX package). Design constraints:

- **Disabled = free.** Every per-frame entry point (``span()``,
  ``frame_begin``, ``bind``, ``frame_end``, ``attach``) starts with one
  flag check and returns a shared singleton / ``None`` — no allocation,
  no lock, no clock read. The capture loop calls these at 60 Hz per
  display; the disabled cost must be unmeasurable.
- **Thread/task-safe.** The capture thread dispatches frame N while the
  asyncio loop is still sending frame N-3, and multi-seat finalize fans
  out from yet another thread. The *current* timeline travels in a
  ``contextvars.ContextVar`` (per-thread AND per-task), and all ring
  mutations take one uncontended lock.
- **Frame-id correlation.** A frame's life spans several loop turns
  (dispatch at tick N, readback at N+PIPELINE_DEPTH, ws send later, ACK
  last). Spans recorded outside the dispatch context attach by
  ``(display_id, frame_id)`` through a bounded index that shares the
  ring's eviction.
- **Monotonic clock.** ``time.perf_counter_ns`` everywhere; wall-clock
  never enters a duration.
"""

from __future__ import annotations

import contextvars
import threading
import time
from collections import OrderedDict
from typing import Callable, Optional

__all__ = ["FrameTimeline", "FrameTracer", "tracer"]

#: completed frame timelines kept for export (per process, across displays)
DEFAULT_CAPACITY = 512

_now_ns = time.perf_counter_ns

#: the timeline the current thread/task is dispatching (set by frame_begin)
_current: contextvars.ContextVar[Optional["FrameTimeline"]] = \
    contextvars.ContextVar("selkies_trace_frame", default=None)


class FrameTimeline:
    """One frame's spans. ``spans`` holds ``(name, lane, t0_ns, dur_ns)``
    tuples; ``lane`` maps to a Perfetto track (thread name, ``seatN``,
    ``clientN``…). Mutated via the tracer only."""

    __slots__ = ("display_id", "frame_id", "t0_ns", "t1_ns", "spans")

    def __init__(self, display_id: str):
        self.display_id = display_id
        self.frame_id: Optional[int] = None
        self.t0_ns = _now_ns()
        self.t1_ns: Optional[int] = None
        self.spans: list[tuple[str, str, int, int]] = []

    @property
    def done(self) -> bool:
        return self.t1_ns is not None

    def wall_ms(self) -> float:
        """frame_begin -> frame_end span in ms (0.0 while open)."""
        if self.t1_ns is None:
            return 0.0
        return (self.t1_ns - self.t0_ns) / 1e6

    def to_dict(self) -> dict:
        return {
            "display_id": self.display_id,
            "frame_id": self.frame_id,
            "t0_ns": self.t0_ns,
            "t1_ns": self.t1_ns,
            "spans": [{"name": n, "lane": la, "t0_ns": t0, "dur_ns": d}
                      for n, la, t0, d in self.spans],
        }


class _NullSpan:
    """Shared do-nothing context manager: the disabled/unattached path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()

#: default for ``span(tl=...)``: distinct from an explicit None
_USE_CURRENT = object()


class _Span:
    """Live span context manager bound to one timeline."""

    __slots__ = ("_tracer", "_tl", "_name", "_lane", "_t0")

    def __init__(self, tracer_: "FrameTracer", tl: FrameTimeline,
                 name: str, lane: Optional[str]):
        self._tracer = tracer_
        self._tl = tl
        self._name = name
        self._lane = lane

    def __enter__(self):
        self._t0 = _now_ns()
        return self

    def __exit__(self, *exc):
        self._tracer._record(self._tl, self._name, self._lane,
                             self._t0, _now_ns() - self._t0)
        return False


class FrameTracer:
    """Process-wide span tracer. One instance (:data:`tracer`) serves every
    capture module, session, and server plane; tests build their own."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self._enabled = False
        self._lock = threading.Lock()
        # insertion-ordered (display_id, frame_id) -> timeline; doubles as
        # the ring (eviction pops the oldest entry) and the attach index
        self._ring: "OrderedDict[tuple[str, int], FrameTimeline]" = \
            OrderedDict()
        self._unbound: list[FrameTimeline] = []   # begun, not yet bind()ed
        #: optional (stage_name, dur_ms) sink — wired to the metrics
        #: registry by :meth:`enable` when the server plane is importable
        self.stage_sink: Optional[Callable[[str, float], None]] = None
        self._dropped = 0

    # -- lifecycle -----------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self, capacity: Optional[int] = None) -> None:
        if capacity is not None:
            self.capacity = int(capacity)
        if self.stage_sink is None:
            self.stage_sink = _metrics_sink()
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._unbound.clear()
            self._dropped = 0

    # -- frame lifecycle -----------------------------------------------------
    def frame_begin(self, display_id: str) -> Optional[FrameTimeline]:
        """Open a timeline and make it the current dispatch context.
        Returns None when disabled (every later call accepts that)."""
        if not self._enabled:
            return None
        tl = FrameTimeline(display_id)
        _current.set(tl)
        with self._lock:
            self._unbound.append(tl)
            if len(self._unbound) > 64:      # leak guard: begun, never bound
                del self._unbound[:32]
        return tl

    def bind(self, tl: Optional[FrameTimeline], frame_id: int,
             aliases: tuple[str, ...] = ()) -> None:
        """Register the timeline under its (display, frame_id) so spans
        recorded on other threads/turns can attach. Called once the
        encoder assigned the id (encode() returns it).

        ``aliases`` registers extra display keys for the SAME timeline —
        the multi-seat capture encodes N seats in one sharded step, so
        one timeline answers for ``seat0..seatN-1`` relay sends. Alias
        entries count against ``capacity`` (they live in the same ring)."""
        if tl is None or not self._enabled:
            return
        tl.frame_id = int(frame_id)
        with self._lock:
            try:
                self._unbound.remove(tl)
            except ValueError:
                pass
            for disp in (tl.display_id, *aliases):
                key = (disp, tl.frame_id)
                self._ring[key] = tl         # wrap collision: last wins
                self._ring.move_to_end(key)
            while len(self._ring) > self.capacity:
                self._ring.popitem(last=False)
                self._dropped += 1

    def frame_end(self, display_id: str, frame_id: int) -> None:
        """Close the timeline (delivery finished). Late spans (ws send,
        ACK) may still attach while it sits in the ring."""
        if not self._enabled:
            return
        with self._lock:
            tl = self._ring.get((display_id, int(frame_id)))
        if tl is not None and tl.t1_ns is None:
            tl.t1_ns = _now_ns()
        if _current.get() is tl:
            _current.set(None)

    # -- spans ---------------------------------------------------------------
    def span(self, name: str, tl=_USE_CURRENT, lane: Optional[str] = None):
        """Context manager timing one stage. Targets ``tl`` when given;
        defaults to the current dispatch context. No-op when disabled,
        when no context exists (engine code runs unchanged under scripts
        that never call frame_begin), or when ``tl`` is explicitly None
        (a finalize whose frame already left the ring must NOT fall back
        to the current context — that is a different, newer frame)."""
        if not self._enabled:
            return _NULL_SPAN
        if tl is _USE_CURRENT:
            tl = _current.get()
        if tl is None:
            return _NULL_SPAN
        return _Span(self, tl, name, lane)

    def attach_span(self, display_id: str, frame_id: int, name: str,
                    t0_ns: int, dur_ns: int,
                    lane: Optional[str] = None,
                    extend_frame: bool = False) -> bool:
        """Record a span measured elsewhere (the relay's send, timed on
        the loop) onto the frame's timeline by id. Returns False when the
        frame already left the ring.

        ``extend_frame`` stretches a CLOSED frame's envelope to cover the
        span: client-side spans (net / decode / present) land
        after ``frame_end`` by construction, and without the extension
        the occupancy analyzer would clip them out — e2e must become
        glass-to-glass, not stay at ws.send."""
        if not self._enabled:
            return False
        with self._lock:
            tl = self._ring.get((display_id, int(frame_id)))
        if tl is None:
            return False
        self._record(tl, name, lane, t0_ns, dur_ns)
        if extend_frame and tl.t1_ns is not None:
            tl.t1_ns = max(tl.t1_ns, t0_ns + max(0, dur_ns))
        return True

    def record_span(self, tl: Optional[FrameTimeline], name: str,
                    t0_ns: int, lane: Optional[str] = None) -> None:
        """Record a span with an EXPLICIT start ending now — the deep
        pipeline's readback span starts at the slot's submit instant
        (frames-in-flight time is readback time, not bubble), which no
        context manager entered on this thread can know."""
        if tl is None or not self._enabled:
            return
        self._record(tl, name, lane, t0_ns, max(0, _now_ns() - t0_ns))

    def instant(self, display_id: str, frame_id: int, name: str,
                lane: Optional[str] = None) -> bool:
        """Zero-duration marker (exported as a trace-event instant)."""
        return self.attach_span(display_id, frame_id, name, _now_ns(), 0,
                                lane=lane)

    def lookup(self, display_id: str, frame_id: int
               ) -> Optional[FrameTimeline]:
        if not self._enabled:
            return None
        with self._lock:
            return self._ring.get((display_id, int(frame_id)))

    def _record(self, tl: FrameTimeline, name: str, lane: Optional[str],
                t0_ns: int, dur_ns: int) -> None:
        if lane is None:
            lane = threading.current_thread().name
        tl.spans.append((name, lane, t0_ns, dur_ns))
        sink = self.stage_sink
        if sink is not None and dur_ns > 0:
            try:
                sink(name, dur_ns / 1e6)
            except Exception:
                pass

    # -- export --------------------------------------------------------------
    def snapshot(self) -> list[FrameTimeline]:
        """Timelines oldest-first (open frames included, marked undone;
        alias keys deduped)."""
        with self._lock:
            seen: set[int] = set()
            out: list[FrameTimeline] = []
            for tl in self._ring.values():
                if id(tl) not in seen:
                    seen.add(id(tl))
                    out.append(tl)
            return out

    def stats(self, frames: Optional[int] = None) -> dict:
        """``frames`` lets callers that already hold a snapshot skip the
        second dedup pass (GET /api/trace does both)."""
        if frames is None:
            frames = len(self.snapshot())
        return {"enabled": self._enabled, "frames": frames,
                "capacity": self.capacity, "dropped": self._dropped}


def _metrics_sink() -> Optional[Callable[[str, float], None]]:
    """Wire stage durations into the Prometheus registry as the
    ``selkies_stage_ms`` histogram. Lazy + guarded: the trace package
    must work in images without the server plane's dependencies."""
    try:
        from ..server import metrics
    except Exception:
        return None
    metrics.describe("selkies_stage_ms",
                     "Per-frame stage latency (trace spans)")
    return lambda name, ms: metrics.observe_hist(
        "selkies_stage_ms", ms, {"stage": name})


#: the process-wide tracer every instrumentation site uses; call sites
#: import this object and use ``tracer.span(...)`` — one entry point
tracer = FrameTracer()
