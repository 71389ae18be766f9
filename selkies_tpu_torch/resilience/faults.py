"""Deterministic, seeded fault injection.

A copy of selkies_tpu/resilience/faults.py (the port imports nothing of
the JAX package). Recovery paths (supervised capture restart, relay
re-offer, service resurrection, degradation ladder) handle failures that
never happen on a developer machine, so this registry makes faults
first-class inputs: armed with a spec, fired at named injection points
in the hot paths, and **deterministic**: ``after``/``count`` schedules
are exact trigger-hit counts, and the only randomness (``prob``) draws
from a seeded ``random.Random`` so a chaos run replays bit-identically
from its seed.

Spec grammar (round-trips through :func:`parse_spec` / ``to_spec()``)::

    spec     := clause (";" clause)*
    clause   := point ":" mode [":" kv ("," kv)*]
    kv       := key "=" value
    keys     := after | count | delay_s | prob

    relay.send:error                      # next send raises
    capture.source:raise:after=40,count=1 # 41st get_frame raises
    encoder.dispatch:slow:delay_s=0.2     # one slow dispatch
    ws.accept:close:count=2               # reject the next two upgrades

Injection points and their modes:

========================  =======================================
``relay.send``            ``stall`` (sleep past the send bound),
                          ``error`` (ConnectionError)
``relay.stripe``          ``reorder`` (swap the two newest queued
                          stripes in a relay)
``capture.source``        ``raise`` (source throws), ``freeze``
                          (source blocks ``delay_s``)
``encoder.dispatch``      ``slow`` (sleep ``delay_s``),
                          ``device_error`` (fake device runtime error)
``encoder.compile``       ``slow`` (sleep ``delay_s`` inside a step
                          build site)
``readback.fetch``        ``slow`` (sleep ``delay_s``), ``error``
                          (mid-pipeline readback death: the ring must
                          drain, never wedge)
``ws.accept``             ``close`` / ``error`` (upgrade rejected)
``fleet.spawn``           ``fail`` (host spawn raises), ``slow``
``fleet.drain``           ``hang`` (drain accepted, never started)
``fleet.heartbeat``       ``drop`` (the next ``count`` pushes are
                          skipped), ``delay`` (push stalls first)
========================  =======================================

Points are also armable through the ``SELKIES_FAULT_INJECT``
environment variable (same grammar); :func:`arm_from_env` is idempotent
per process.

The disarmed fast path is one attribute read (``self._armed``): the
capture/encode loops pay nothing when no fault is armed. Stdlib-only.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import os
import random
import threading
import time
from typing import Optional

logger = logging.getLogger("selkies_tpu_torch.resilience.faults")

__all__ = ["FaultError", "FaultSpec", "FaultRegistry", "parse_spec",
           "arm_from_env", "registry", "POINTS"]

#: injection points -> their valid modes. Parsing validates against this
#: so a typo'd spec fails at arm time, never silently no-ops in a run.
POINTS: dict[str, tuple[str, ...]] = {
    "relay.send": ("stall", "error"),
    "relay.stripe": ("reorder",),
    "capture.source": ("raise", "freeze"),
    "encoder.dispatch": ("slow", "device_error"),
    "encoder.compile": ("slow",),
    "readback.fetch": ("slow", "error"),
    "ws.accept": ("close", "error"),
    "fleet.spawn": ("fail", "slow"),
    "fleet.drain": ("hang",),
    "fleet.heartbeat": ("drop", "delay"),
}

#: modes that raise at the injection site. ``hang`` and ``drop`` are
#: marker modes their sites interpret via ``pull()`` directly (skip the
#: heartbeat POST, skip starting the drain) — ``perturb()`` never sees
#: them; the rest of the non-raising modes sleep/stall.
_RAISING_MODES = frozenset({"error", "raise", "device_error", "close",
                            "fail"})

#: bounded history of fired faults (chaos-run forensics)
_FIRED_CAP = 256


class FaultError(RuntimeError):
    """Raised at an injection site by a raising-mode fault. Carries the
    point/mode so recovery tests can assert the failure they injected is
    the failure that was handled."""

    def __init__(self, point: str, mode: str):
        super().__init__(f"injected fault: {point}:{mode}")
        self.point = point
        self.mode = mode


class FaultSpec:
    """One armed fault clause.

    ``after`` trigger-hits are skipped, then the fault fires on the next
    ``count`` hits (each hit subject to ``prob``). ``delay_s`` is the
    stall duration for sleeping modes.
    """

    __slots__ = ("point", "mode", "after", "count", "delay_s", "prob",
                 "hits", "fired")

    def __init__(self, point: str, mode: str, after: int = 0,
                 count: int = 1, delay_s: float = 2.0, prob: float = 1.0):
        if point not in POINTS:
            raise ValueError(f"unknown fault point {point!r} "
                             f"(want one of {sorted(POINTS)})")
        if mode not in POINTS[point]:
            raise ValueError(f"mode {mode!r} invalid for {point} "
                             f"(want one of {POINTS[point]})")
        if after < 0 or count < 1:
            raise ValueError("after must be >= 0 and count >= 1")
        if not (0.0 < prob <= 1.0):
            raise ValueError("prob must be in (0, 1]")
        self.point = point
        self.mode = mode
        self.after = int(after)
        self.count = int(count)
        self.delay_s = float(delay_s)
        self.prob = float(prob)
        self.hits = 0       # trigger-site visits seen by this clause
        self.fired = 0      # times this clause actually fired

    @property
    def exhausted(self) -> bool:
        return self.fired >= self.count

    def to_spec(self) -> str:
        """The clause in spec grammar (parse/format round-trip)."""
        kv = []
        if self.after:
            kv.append(f"after={self.after}")
        if self.count != 1:
            kv.append(f"count={self.count}")
        if self.delay_s != 2.0:
            kv.append(f"delay_s={self.delay_s:g}")
        if self.prob != 1.0:
            kv.append(f"prob={self.prob:g}")
        base = f"{self.point}:{self.mode}"
        return base + (":" + ",".join(kv) if kv else "")

    def to_dict(self) -> dict:
        return {"point": self.point, "mode": self.mode,
                "after": self.after, "count": self.count,
                "delay_s": self.delay_s, "prob": self.prob,
                "hits": self.hits, "fired": self.fired,
                "exhausted": self.exhausted}


def parse_spec(text: str) -> list[FaultSpec]:
    """Parse the ``--fault_inject`` grammar; raises ``ValueError`` with
    the offending clause on any contract break."""
    specs: list[FaultSpec] = []
    for clause in str(text).split(";"):
        clause = clause.strip()
        if not clause:
            continue
        parts = clause.split(":")
        if len(parts) < 2:
            raise ValueError(f"bad fault clause {clause!r} "
                             "(want point:mode[:k=v,...])")
        point, mode = parts[0].strip(), parts[1].strip()
        kw: dict = {}
        if len(parts) > 2:
            for kv in ":".join(parts[2:]).split(","):
                kv = kv.strip()
                if not kv:
                    continue
                if "=" not in kv:
                    raise ValueError(f"bad fault option {kv!r} in "
                                     f"{clause!r} (want key=value)")
                k, v = kv.split("=", 1)
                k = k.strip()
                if k in ("after", "count"):
                    kw[k] = int(v)
                elif k in ("delay_s", "prob"):
                    kw[k] = float(v)
                else:
                    raise ValueError(f"unknown fault option {k!r} in "
                                     f"{clause!r}")
        specs.append(FaultSpec(point, mode, **kw))
    return specs


class FaultRegistry:
    """Process-wide armed-fault state. Thread-safe: sync injection sites
    live on the capture thread, async ones on the event loop, and the
    control plane arms/disarms from HTTP handlers."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self._specs: list[FaultSpec] = []
        self._armed = False            # lock-free fast-path flag
        self._rng = random.Random(seed)
        self.seed = seed
        self.fired_log: collections.deque = collections.deque(
            maxlen=_FIRED_CAP)
        #: injectable sleeps so stalls are testable without wall-clock
        self.sleep = time.sleep
        self.sleep_async = asyncio.sleep

    # -- control plane -------------------------------------------------------
    def arm(self, spec, seed: Optional[int] = None) -> list[FaultSpec]:
        """Arm a spec string / FaultSpec / list thereof. Re-seeding is
        explicit so a chaos run can pin its RNG."""
        if isinstance(spec, str):
            specs = parse_spec(spec)
        elif isinstance(spec, FaultSpec):
            specs = [spec]
        else:
            specs = list(spec)
        with self._lock:
            if seed is not None:
                self.seed = int(seed)
                self._rng = random.Random(self.seed)
            self._specs.extend(specs)
            self._armed = bool(self._specs)
        if specs:
            logger.warning("fault injection armed: %s",
                           "; ".join(s.to_spec() for s in specs))
        return specs

    def disarm(self, point: Optional[str] = None) -> int:
        """Disarm every clause (or only one point's). -> clauses removed."""
        with self._lock:
            before = len(self._specs)
            self._specs = [] if point is None else \
                [s for s in self._specs if s.point != point]
            self._armed = bool(self._specs)
            return before - len(self._specs)

    def active(self) -> list[dict]:
        with self._lock:
            return [s.to_dict() for s in self._specs]

    def remaining(self) -> int:
        """Armed clauses that have not exhausted their count yet."""
        with self._lock:
            return sum(1 for s in self._specs if not s.exhausted)

    # -- injection sites -----------------------------------------------------
    def pull(self, point: str) -> Optional[FaultSpec]:
        """One trigger-site visit: returns the spec to act on, or None.
        Counts the hit against every armed clause for the point (so
        ``after`` schedules stay exact even with overlapping clauses)."""
        if not self._armed:
            return None
        with self._lock:
            chosen = None
            for s in self._specs:
                if s.point != point:
                    continue
                s.hits += 1
                if chosen is None and not s.exhausted \
                        and s.hits > s.after \
                        and (s.prob >= 1.0 or self._rng.random() < s.prob):
                    s.fired += 1
                    chosen = s
            if chosen is not None:
                entry = {"ts": round(time.time(), 3),
                         "point": chosen.point, "mode": chosen.mode,
                         "hit": chosen.hits, "fired": chosen.fired}
                self.fired_log.append(entry)
                self._record_incident(entry)
                logger.warning("fault fired: %s:%s (hit %d)", chosen.point,
                               chosen.mode, chosen.hits)
            return chosen

    def perturb(self, point: str) -> None:
        """Sync injection site (capture thread, encoder dispatch): raise
        or sleep per the armed spec; no-op otherwise."""
        s = self.pull(point)
        if s is None:
            return
        if s.mode in _RAISING_MODES:
            raise FaultError(s.point, s.mode)
        self.sleep(s.delay_s)

    async def perturb_async(self, point: str) -> None:
        """Async injection site (relay sender, ws accept)."""
        s = self.pull(point)
        if s is None:
            return
        if s.mode in _RAISING_MODES:
            raise FaultError(s.point, s.mode)
        await self.sleep_async(s.delay_s)

    # -- incident bridge (lazy; mirrors health's metrics bridge) -------------
    def _record_incident(self, entry: dict) -> None:
        try:
            from ..obs import health as _health
        except Exception:  # pragma: no cover - obs is stdlib-only
            return
        _health.engine.recorder.record(
            "fault_injected", point=entry["point"], mode=entry["mode"],
            hit=entry["hit"])


#: the process-wide registry every injection site reads (tests and the
#: bench chaos harness build their own instances)
registry = FaultRegistry()

#: latched by :func:`arm_from_env` so the env spec arms exactly once
#: per process no matter how many entrypoints call it (``arm`` extends
#: the clause list — double-arming would double every schedule).
_env_armed = False


def arm_from_env(environ: Optional[dict] = None) -> list[FaultSpec]:
    """Arm the process-wide registry from ``SELKIES_FAULT_INJECT``
    (optional ``SELKIES_FAULT_SEED`` pins the RNG).  Idempotent: only
    the first call in a process arms; later calls return ``[]``.  A
    malformed spec raises ``ValueError`` — an env-armed chaos run must
    fail loudly at boot, never silently run fault-free."""
    global _env_armed
    env = os.environ if environ is None else environ
    text = (env.get("SELKIES_FAULT_INJECT") or "").strip()
    if not text or _env_armed:
        return []
    _env_armed = True
    seed = (env.get("SELKIES_FAULT_SEED") or "").strip()
    return registry.arm(text, seed=int(seed) if seed else None)
