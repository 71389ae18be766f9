"""Energy observability: the delivered-frame meter.

The part of selkies_tpu/obs/energy.py that the capture loop calls: the
:class:`EnergyMeter` and its process-wide :data:`meter`, which the
engine's finalizer side stamps once per delivered frame
(:meth:`EnergyMeter.note_frame`) to feed the live fps estimate. The
reference's power model, its measured-power sources (RAPL, device
counters) and the attribution and budget policies wait for the port's
device observability (ROADMAP A13), with a ``cuda`` power source.

Stdlib-only.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable

__all__ = ["EnergyMeter", "meter"]

#: delivered-frame stamps kept for the live fps estimate
_FRAME_RING = 1024


class EnergyMeter:
    """Process-wide delivered-frame meter. One instance (:data:`meter`)
    serves the engine; tests build their own with an injected clock."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._frames: collections.deque = collections.deque(
            maxlen=_FRAME_RING)

    def note_frame(self, n: int = 1) -> None:
        """One delivered frame (engine capture loops call this on the
        finalizer side): feeds the live fps estimate. Cheap by design —
        a timestamp append under a lock."""
        now = self._clock()
        with self._lock:
            for _ in range(max(1, int(n))):
                self._frames.append(now)

    def fps_estimate(self, window_s: float = 5.0) -> float:
        now = self._clock()
        with self._lock:
            recent = [t for t in self._frames if now - t <= window_s]
            saturated = (len(recent) == len(self._frames)
                         == self._frames.maxlen)
        if not recent or window_s <= 0:
            return 0.0
        if saturated:
            # the ring evicted stamps still inside the window: rate over
            # the span actually observed, or the estimate silently caps
            # at maxlen/window
            span = now - recent[0]
            if span > 0:
                return len(recent) / span
        return len(recent) / window_s


#: the process-wide meter (inert until something notes frames)
meter = EnergyMeter()
