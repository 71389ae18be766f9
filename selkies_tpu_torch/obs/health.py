"""Health-verdict engine + flight recorder.

A copy of selkies_tpu/obs/health.py (the port imports nothing of the JAX
package). A two-field ``{"ok": bool}`` health endpoint cannot say that a
device died and the pipeline quietly fell back to the CPU; the engine
replaces it with NAMED checks, each returning ``ok | degraded | failed``
plus a reason string a human (or a monitor) can act on, split into
liveness (restart me) and readiness (route traffic to me) scopes for
container orchestration. The capture loop records its deaths here.

Design constraints:

- **Dependency-free.** Metrics export is lazy and optional, the same
  pattern :mod:`..trace.core` uses for its stage sink.
- **Checks never raise out.** A crashing check IS a failed verdict.
- **Bounded memory.** The flight recorder is a fixed ring; incident
  floods overwrite the oldest entries and bump a drop counter instead
  of growing.
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
import platform
import socket
import threading
import time
from typing import Callable, Optional

__all__ = ["OK", "DEGRADED", "FAILED", "Verdict", "ok", "degraded",
           "failed", "HealthEngine", "FlightRecorder", "engine"]

OK = "ok"
DEGRADED = "degraded"
FAILED = "failed"

#: severity order for aggregation: the overall status is the worst check
_RANK = {OK: 0, DEGRADED: 1, FAILED: 2}


class Verdict:
    """One check's outcome. ``data`` carries structured evidence (the
    numbers the reason string was derived from) for dashboards."""

    __slots__ = ("status", "reason", "data")

    def __init__(self, status: str, reason: str = "",
                 data: Optional[dict] = None):
        if status not in _RANK:
            raise ValueError(f"bad status {status!r}")
        self.status = status
        self.reason = reason
        self.data = data or {}

    def to_dict(self) -> dict:
        out = {"status": self.status, "reason": self.reason}
        if self.data:
            out["data"] = self.data
        return out

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Verdict({self.status!r}, {self.reason!r})"


def ok(reason: str = "", **data) -> Verdict:
    return Verdict(OK, reason, data)


def degraded(reason: str, **data) -> Verdict:
    return Verdict(DEGRADED, reason, data)


def failed(reason: str, **data) -> Verdict:
    return Verdict(FAILED, reason, data)


def worst(statuses) -> str:
    """Aggregate: the most severe status present (ok when empty)."""
    rank = 0
    for s in statuses:
        rank = max(rank, _RANK.get(s, 2))
    return [OK, DEGRADED, FAILED][rank]


def host_id() -> str:
    """Stable short host identity for joining multi-host records:
    ``SELKIES_HOST_ID`` when set (an orchestrator's name for the host),
    else the machine type and a digest of the host name. (The reference
    derives it from its JAX compile cache's fingerprint, which the port
    does not have.)"""
    env = os.environ.get("SELKIES_HOST_ID", "").strip()
    if env:
        return "".join(c if c.isalnum() or c in "._-" else "_"
                       for c in env)[:64]
    digest = hashlib.sha1(socket.gethostname().encode()).hexdigest()[:8]
    return f"{platform.machine() or 'host'}-{digest}"


def _host_id() -> str:
    """Stable host id stamped onto every incident so multi-host records
    join after the fact. Cached; a failing lookup must never take the
    recorder down with it."""
    global _HOST_ID
    if _HOST_ID is None:
        try:
            _HOST_ID = host_id()
        except Exception:
            _HOST_ID = "unknown"
    return _HOST_ID


_HOST_ID: Optional[str] = None


class FlightRecorder:
    """Bounded ring of structured incidents (relay death, capture
    death, ACK-stall watchdog trips…), dumped on SIGTERM so a postmortem
    can see WHAT went wrong before the container vanished."""

    def __init__(self, capacity: int = 256):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=self.capacity)
        self.dropped = 0
        self.total = 0
        # cumulative count-by-kind, surviving ring rollover — the
        # heartbeat incident digest needs monotone counts so the fleet
        # observer can delta-trigger on increases
        self._counts: dict = {}

    def record(self, kind: str, **fields) -> dict:
        entry = {"ts": round(time.time(), 3), "kind": str(kind),
                 "host": _host_id(), **fields}
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(entry)
            self.total += 1
            self._counts[entry["kind"]] = \
                self._counts.get(entry["kind"], 0) + 1
        _metrics_incident(kind)
        return entry

    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def counts(self) -> dict:
        """Cumulative incidents by kind (monotone across ring
        rollover) — the source of the heartbeat incident digest."""
        with self._lock:
            return dict(self._counts)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0
            self.total = 0
            self._counts.clear()

    def dump_text(self) -> str:
        """One JSON line per incident (journald/stderr friendly)."""
        return "\n".join(json.dumps(e) for e in self.snapshot())

    def dump_file(self, dump_dir: str) -> str:
        """Write the post-mortem incident ring to a STABLE path —
        ``<dump_dir>/incidents-<host_id>.json`` — so a fleet harness
        or operator can collect it from a killed process without
        grepping logs. Atomic (tmp + rename on the same filesystem): a
        SIGKILL landing mid-dump leaves either the previous complete
        file or none, never truncated JSON. Returns the final path."""
        import os
        import tempfile
        host = _host_id()
        os.makedirs(dump_dir, exist_ok=True)
        path = os.path.join(dump_dir, f"incidents-{host}.json")
        with self._lock:
            doc = {"host": host, "ts": round(time.time(), 3),
                   "total": self.total, "dropped": self.dropped,
                   "counts": dict(self._counts),
                   "incidents": list(self._ring)}
        fd, tmp = tempfile.mkstemp(prefix=f".incidents-{host}.",
                                   suffix=".tmp", dir=dump_dir)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return path


class _Check:
    __slots__ = ("name", "fn", "liveness", "gate")

    def __init__(self, name: str, fn: Callable[[], Verdict],
                 liveness: bool, gate: bool = False):
        self.name = name
        self.fn = fn
        self.liveness = liveness
        self.gate = gate


class HealthEngine:
    """Named health checks -> verdict set.

    ``liveness=True`` marks a check whose failure means the PROCESS is
    broken and a restart could help (service supervisor dead, event
    loop wedged). Everything else is readiness-scope: a failed relay or
    cpu-fallback backend makes the pod unfit for traffic but restarts
    won't resurrect a dead device, so the liveness probe must keep
    passing (k8s would otherwise crash-loop the pod against an external
    fault — the exact anti-pattern the probes split exists to avoid).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._checks: dict[str, _Check] = {}
        self.recorder = FlightRecorder()

    # -- registration --------------------------------------------------------
    def register(self, name: str, fn: Callable[[], Verdict],
                 liveness: bool = False, gate: bool = False) -> None:
        """Idempotent: re-registering a name replaces the check (service
        restarts re-register their closures).

        ``gate=True`` marks a *routing gate*: evaluated only by the
        ``?probe=ready`` readiness probe (the load-balancer surface),
        never by the default ``/api/health`` report. The prewarm-complete
        gate is the canonical case — a cold host must answer the LB
        "don't route to me yet" without the operator panel reading the
        whole process as failed while the lattice warms."""
        with self._lock:
            self._checks[name] = _Check(str(name), fn, bool(liveness),
                                        bool(gate))

    def unregister(self, name: str, fn: Optional[Callable] = None) -> None:
        """Remove a check. Pass the registered ``fn`` to make teardown
        owner-safe: register() replaces on name, so a torn-down
        instance's cleanup must not remove a NEWER instance's check."""
        with self._lock:
            c = self._checks.get(name)
            if c is not None and (fn is None or c.fn == fn):
                self._checks.pop(name, None)

    def check_names(self) -> list[str]:
        with self._lock:
            return sorted(self._checks)

    def clear(self) -> None:
        with self._lock:
            self._checks.clear()
        self.recorder.clear()

    # -- evaluation ----------------------------------------------------------
    def run(self, liveness_only: bool = False,
            include_gates: bool = False) -> dict[str, Verdict]:
        """Evaluate every check (or only the liveness-scope ones). A
        check that raises becomes a failed verdict carrying the
        exception — never propagates. Liveness probes must evaluate
        ONLY liveness checks: running readiness closures on the
        liveness path would let a wedged readiness check time the probe
        out and crash-loop the pod over an external fault. Gate-scope
        checks (prewarm-complete) join only when ``include_gates`` —
        the readiness-probe path."""
        with self._lock:
            checks = [c for c in self._checks.values()
                      if (c.liveness or not liveness_only)
                      and (include_gates or not c.gate)]
        out: dict[str, Verdict] = {}
        for c in checks:
            try:
                v = c.fn()
                if not isinstance(v, Verdict):
                    v = failed(f"check returned {type(v).__name__}, "
                               "not a Verdict")
            except Exception as e:
                v = failed(f"check crashed: {type(e).__name__}: {e}")
            out[c.name] = v
            _metrics_status(c.name, v.status)
        return out

    def _liveness_names(self) -> set[str]:
        with self._lock:
            return {n for n, c in self._checks.items() if c.liveness}

    def gate_names(self) -> set[str]:
        """Names of the routing-gate checks — lets a caller evaluate
        everything ONCE (``run(include_gates=True)``) and still derive
        both the process-health status (gates excluded) and the
        readiness answer (gates included) from one verdict map."""
        with self._lock:
            return {n for n, c in self._checks.items() if c.gate}

    def liveness(self) -> dict:
        """The livenessProbe answer: liveness-scope checks only."""
        verdicts = self.run(liveness_only=True)
        live = worst(v.status for v in verdicts.values()) != FAILED
        return {"ok": live, "live": live,
                "failing": sorted(n for n, v in verdicts.items()
                                  if v.status == FAILED)}

    def readiness(self) -> dict:
        """The readinessProbe / load-balancer answer: every readiness
        check PLUS the routing gates. A cold host (prewarm gate failed)
        answers not-ready here while the default report stays honest
        about the rest of the process — route-ability and process
        health are different questions."""
        verdicts = self.run(include_gates=True)
        ready = worst(v.status for v in verdicts.values()) != FAILED
        return {"ok": ready, "ready": ready,
                "status": worst(v.status for v in verdicts.values()),
                "failing": sorted(n for n, v in verdicts.items()
                                  if v.status == FAILED)}

    def report(self, verbose: bool = False) -> dict:
        """The /api/health payload. Always carries ``ok`` (readiness
        bool, backward compatible), ``status`` (worst verdict), ``live``
        and ``ready``; ``verbose`` adds the per-check verdicts and the
        flight-recorder tail."""
        verdicts = self.run()
        live_names = self._liveness_names()
        status = worst(v.status for v in verdicts.values())
        live = worst(verdicts[n].status
                     for n in verdicts if n in live_names) != FAILED
        ready = status != FAILED
        doc: dict = {
            "ok": ready,
            "status": status,
            "live": live,
            "ready": ready,
            "failing": sorted(n for n, v in verdicts.items()
                              if v.status == FAILED),
        }
        if verbose:
            doc["checks"] = {n: v.to_dict()
                             for n, v in sorted(verdicts.items())}
            doc["incidents"] = self.recorder.snapshot()
            doc["incidents_dropped"] = self.recorder.dropped
            doc["incidents_total"] = self.recorder.total
        return doc


# -- optional metrics bridge (lazy; lint image has no server deps) ----------

def _metrics_status(name: str, status: str) -> None:
    try:
        from ..server import metrics
    except Exception:
        return
    metrics.describe("selkies_health_status",
                     "Health check status (0=ok 1=degraded 2=failed)")
    metrics.set_gauge("selkies_health_status", _RANK[status],
                      {"check": name})


def _metrics_incident(kind: str) -> None:
    try:
        from ..server import metrics
    except Exception:
        return
    metrics.describe("selkies_incidents_total",
                     "Flight-recorder incidents by kind")
    metrics.inc_counter("selkies_incidents_total", labels={"kind": kind})


#: the process-wide engine every plane registers against (same singleton
#: pattern as :data:`..trace.core.tracer`); tests build their own.
engine = HealthEngine()
