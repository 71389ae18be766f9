"""Depth-N software pipeline between dispatch and finalize.

A copy of selkies_tpu/engine/pipeline.py (the port imports nothing of
the JAX package).

The frame-serial engine paid the SUM of its stages per frame: capture ->
convert -> dispatch -> readback -> packetize, one frame at a time. This
module is the frames-in-flight half of the deep-pipeline rework: a
bounded ring of in-flight encode slots between the dispatching capture
thread and ONE finalizer thread, so frame N+1's jitted step dispatches
while frame N's readback/packetize is still running (split-frame
parallel-encode discipline, PAPERS.md V-PCC streaming).

Invariants the ring enforces:

- **In-order delivery per seat.** One FIFO queue, one finalizer thread:
  slots finalize in submission order, always. Pipelining must never be
  observable in the byte stream (tests pin byte-identity vs serial).
- **Bounded depth = backpressure.** ``submit()`` blocks while ``depth``
  frames are in flight — the capture thread stalls instead of queueing
  unbounded device buffers. ``set_depth()`` retargets live (the relay
  backpressure clamp and the ladder's rung-0 "pipeline" action drop to
  1 = serial); shrinking takes effect as slots drain.
- **Failures drain, never wedge.** A finalize exception parks the ring
  failed: queued slots are discarded, blocked submitters wake, and the
  NEXT ``submit()``/``drain()`` re-raises on the capture thread so the
  loop dies through its normal supervision path (capture_death ->
  supervisor restart -> IDR resync). A mid-pipeline readback death
  (fault point ``readback.fetch:error``) must not strand in-flight
  slots.
- **Per-slot attribution.** Every submitted slot is stamped with a ring
  slot index (``out["slot"]``); the encoder sessions label their
  readback/packetize spans with a ``slotN`` lane so the occupancy
  analyzer attributes overlap exactly.

Stdlib-only: the ring is plain threading.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Callable, Optional

logger = logging.getLogger("selkies_tpu_torch.engine.pipeline")

__all__ = ["PipelineError", "PipelineRing", "cause_of", "effective_depth",
           "retarget"]


def cause_of(exc: BaseException) -> BaseException:
    """The root cause to report for a capture-loop death: a
    PipelineError is just the messenger for the finalizer's exception."""
    if isinstance(exc, PipelineError) and exc.__cause__ is not None:
        return exc.__cause__
    return exc


def retarget(ring: Optional["PipelineRing"], depth: int,
             finalize_fn: Callable[[dict], None],
             name: str) -> Optional["PipelineRing"]:
    """Per-tick ring lifecycle shared by every capture loop: depth 1
    closes (drains) any ring — inline serial mode; depth > 1 creates or
    resizes one. Returns the ring to use this tick (None = inline)."""
    if depth <= 1:
        if ring is not None:
            ring.close(drain=True)
        return None
    if ring is None:
        return PipelineRing(finalize_fn, depth=depth, name=name)
    if ring.depth != depth:
        ring.set_depth(depth)
    return ring


def effective_depth(settings, clamp: Optional[int],
                    default: int = 2) -> int:
    """The frames-in-flight depth a capture loop may run at right now:
    ``settings.pipeline_depth`` bounded by the runtime ``clamp`` (relay
    backpressure / ladder rung-0), floor 1. Shared by ScreenCapture and
    MultiSeatCapture so the two capture frontends cannot drift."""
    depth = default
    if settings is not None:
        depth = int(getattr(settings, "pipeline_depth", default) or default)
    if clamp is not None:
        depth = min(depth, int(clamp))
    return max(1, depth)

#: bound on joining the finalizer thread at close — a wedged device
#: fetch must not hang the capture thread's stop path forever
CLOSE_TIMEOUT_S = 10.0


class PipelineError(RuntimeError):
    """A finalize slot failed; raised to the SUBMITTING thread so the
    capture loop dies through its supervised path. ``__cause__`` carries
    the original finalize exception."""


class PipelineRing:
    """Bounded in-flight slot ring with a single finalizer thread.

    ``finalize_fn(out)`` runs on the finalizer thread for every
    submitted slot, in order. ``depth`` counts frames in flight between
    ``submit()`` returning and ``finalize_fn`` completing.
    """

    def __init__(self, finalize_fn: Callable[[dict], None], depth: int = 2,
                 name: str = "pipeline"):
        self._finalize = finalize_fn
        self._depth = max(1, int(depth))
        self.name = name
        self._cond = threading.Condition()
        self._q: collections.deque = collections.deque()
        self._in_flight = 0          # submitted, not yet finalized
        self._seq = 0
        self._closed = False
        self._failure: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, name=f"{name}-finalize", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- producers
    @property
    def depth(self) -> int:
        # under the cond like every other _depth access: retarget()'s
        # compare-then-resize on the capture thread must see a value
        # coherent with a concurrent set_depth (backpressure clamp /
        # ladder rung-0 fire from the loop)
        with self._cond:
            return self._depth

    @property
    def in_flight(self) -> int:
        with self._cond:
            return self._in_flight

    @property
    def failed(self) -> bool:
        return self._failure is not None

    def set_depth(self, depth: int) -> None:
        """Live depth retarget (ladder rung-0 / backpressure clamp).
        Growing admits immediately; shrinking takes effect as in-flight
        slots drain past the new bound."""
        with self._cond:
            self._depth = max(1, int(depth))
            self._cond.notify_all()

    def submit(self, out: dict) -> int:
        """Enqueue one dispatched slot; blocks while ``depth`` slots are
        in flight (the capture thread's backpressure). Returns the slot
        index stamped into ``out["slot"]``. Raises :class:`PipelineError`
        if a previous slot's finalize failed."""
        # in-flight epoch BEFORE the admission wait: the frame was
        # already dispatched when submit() was called, so time spent
        # blocked here is genuine in-flight time — the encoder's
        # readback span starts at this instant
        t_submit = time.perf_counter_ns()
        with self._cond:
            while (self._in_flight >= self._depth and self._failure is None
                   and not self._closed):
                self._cond.wait()
            self._raise_if_failed()
            if self._closed:
                raise PipelineError("pipeline ring is closed")
            slot = self._seq % self._depth
            out["slot"] = slot
            out["submitted_ns"] = t_submit
            self._seq += 1
            self._in_flight += 1
            self._q.append(out)
            self._cond.notify_all()
            return slot

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every in-flight slot delivered (the stop path's
        deque flush). Returns False on timeout; raises on failure."""
        with self._cond:
            ok = self._cond.wait_for(
                lambda: self._in_flight == 0 or self._failure is not None,
                timeout)
            self._raise_if_failed()
            return ok

    def close(self, drain: bool = True,
              timeout: float = CLOSE_TIMEOUT_S) -> None:
        """Stop the finalizer. ``drain=True`` delivers queued slots
        first (clean stop); ``drain=False`` discards them (death path —
        the supervisor rebuilds the session and forces an IDR, so
        undelivered frames are unrecoverable by design, never wedged).
        Close never raises: a failure during a drain-close is already
        recorded and the caller is tearing down anyway."""
        with self._cond:
            if not drain:
                self._q.clear()
                self._in_flight = 0
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():     # wedged fetch: abandon, bounded
            logger.error("pipeline ring %s finalizer did not stop in "
                         "%.1fs; abandoning it", self.name, timeout)

    def _raise_if_failed(self) -> None:
        if self._failure is not None:
            raise PipelineError(
                f"pipeline finalize failed: "
                f"{type(self._failure).__name__}: {self._failure}"
            ) from self._failure

    # -------------------------------------------------------------- consumer
    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._q and not self._closed \
                        and self._failure is None:
                    self._cond.wait()
                if self._failure is not None:
                    return
                if not self._q:
                    if self._closed:
                        return
                    continue
                out = self._q.popleft()
            try:
                self._finalize(out)
            except BaseException as e:  # noqa: BLE001 — must not wedge
                with self._cond:
                    self._failure = e
                    self._q.clear()
                    self._in_flight = 0
                    self._cond.notify_all()
                return
            with self._cond:
                self._in_flight = max(0, self._in_flight - 1)
                self._cond.notify_all()
