"""Observability: process-global metrics registry + Prometheus rendering.

A copy of selkies_tpu/server/metrics.py (the port imports nothing of
the JAX package).

Mirrors the reference's metric surface (webrtc_utils.py:877-1259: ``fps``,
``latency``, GPU/system gauges exposed at /api/metrics) with a tiny
dependency-free registry: gauges and counters with optional labels,
rendered in Prometheus text exposition format. A histogram covers the
fps_hist parity case.
"""

from __future__ import annotations

import logging
import threading
from collections import defaultdict
from typing import Iterable

logger = logging.getLogger("selkies_tpu_torch.server.metrics")

_lock = threading.Lock()
_gauges: dict[tuple[str, tuple], float] = {}
_counters: dict[tuple[str, tuple], float] = defaultdict(float)
_helps: dict[str, str] = {}
_hist_buckets = (1, 5, 10, 15, 20, 30, 45, 60, 90, 120, 240)
_hists: dict[tuple[str, tuple], list] = {}
#: per-metric bucket ladders: declared via ``describe(buckets=...)``,
#: pinned per metric at first observation (a ladder change mid-series
#: would corrupt the cumulative rendering contract)
_bucket_overrides: dict[str, tuple] = {}
_hist_ladders: dict[str, tuple] = {}
#: scrape-time collectors: called (outside the lock) by
#: :func:`render_prometheus` so pull-model planes (per-session QoE)
#: export fresh gauges at scrape time without owning a write cadence
_collectors: list = []


def _key(name: str, labels: dict | None) -> tuple[str, tuple]:
    return name, tuple(sorted((labels or {}).items()))


def describe(name: str, help_text: str,
             buckets: Iterable | None = None) -> None:
    """Register help text; ``buckets`` optionally overrides the global
    histogram ladder for this metric (must be declared before the first
    ``observe_hist`` — the ladder pins then and stays pinned)."""
    _helps[name] = help_text
    if buckets is not None:
        _bucket_overrides[name] = tuple(sorted(float(b) for b in buckets))


def register_collector(fn) -> None:
    """Add a zero-arg callable run at every render (idempotent)."""
    if fn not in _collectors:
        _collectors.append(fn)


def unregister_collector(fn) -> None:
    try:
        _collectors.remove(fn)
    except ValueError:
        pass


def set_gauge(name: str, value: float, labels: dict | None = None) -> None:
    with _lock:
        _gauges[_key(name, labels)] = float(value)


def clear_metric(name: str) -> None:
    """Drop every sample of one metric (all label sets). Collectors use
    this to re-export live-membership gauges so departed sessions
    vanish instead of flat-lining at their last value."""
    with _lock:
        for store in (_gauges, _counters, _hists):
            for k in [k for k in store if k[0] == name]:
                del store[k]
        _hist_ladders.pop(name, None)


def inc_counter(name: str, value: float = 1.0, labels: dict | None = None) -> None:
    with _lock:
        _counters[_key(name, labels)] += value


def counter_value(name: str, labels: dict | None = None) -> float:
    """Current value of one counter sample (tests / diagnostics)."""
    with _lock:
        return _counters.get(_key(name, labels), 0.0)


def _ladder(name: str) -> tuple:
    lad = _hist_ladders.get(name)
    if lad is None:
        lad = _hist_ladders[name] = _bucket_overrides.get(name,
                                                         _hist_buckets)
    return lad


def observe_hist(name: str, value: float, labels: dict | None = None) -> None:
    with _lock:
        buckets = _ladder(name)
        k = _key(name, labels)
        h = _hists.setdefault(k, [0] * (len(buckets) + 1) + [0.0, 0])
        for i, b in enumerate(buckets):
            if value <= b:
                h[i] += 1
        h[len(buckets)] += 1                # +Inf
        h[-2] += value                      # sum
        h[-1] += 1                          # count


def clear() -> None:
    with _lock:
        _gauges.clear()
        _counters.clear()
        _hists.clear()
        _hist_ladders.clear()


def _escape_label_value(v) -> str:
    """Prometheus text exposition escaping: backslash, double-quote and
    newline must be escaped inside label values (spec 'Text format
    details'); anything else passes through verbatim."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _fmt_labels(labels: tuple, extra: str = "") -> str:
    parts = [f'{k}="{_escape_label_value(v)}"' for k, v in labels]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def render_prometheus() -> str:
    # collectors first, OUTSIDE the lock (they call set_gauge themselves);
    # a crashing collector must never take the scrape down with it
    for fn in list(_collectors):
        try:
            fn()
        except Exception:
            logger.debug("metrics collector %r failed", fn, exc_info=True)
    out: list[str] = []
    with _lock:
        seen: set[str] = set()

        def emit_help(name: str, mtype: str):
            if name not in seen:
                seen.add(name)
                if name in _helps:
                    out.append(f"# HELP {name} {_helps[name]}")
                out.append(f"# TYPE {name} {mtype}")

        for (name, labels), v in sorted(_gauges.items()):
            emit_help(name, "gauge")
            out.append(f"{name}{_fmt_labels(labels)} {v}")
        for (name, labels), v in sorted(_counters.items()):
            emit_help(name, "counter")
            out.append(f"{name}{_fmt_labels(labels)} {v}")
        for (name, labels), h in sorted(_hists.items()):
            emit_help(name, "histogram")
            buckets = _ladder(name)
            for i, b in enumerate(buckets):
                b_txt = int(b) if float(b).is_integer() else b
                le = f'le="{b_txt}"'
                out.append(f"{name}_bucket{_fmt_labels(labels, le)} {h[i]}")
            inf = 'le="+Inf"'
            out.append(f"{name}_bucket{_fmt_labels(labels, inf)} "
                       f"{h[len(buckets)]}")
            out.append(f"{name}_sum{_fmt_labels(labels)} {h[-2]}")
            out.append(f"{name}_count{_fmt_labels(labels)} {h[-1]}")
    return "\n".join(out) + "\n"


describe("selkies_fps", "Encoded frames per second per display")
describe("selkies_latency_ms", "Client-reported round-trip latency")
describe("selkies_clients", "Connected clients")
describe("selkies_bytes_sent_total", "Media bytes sent")
describe("selkies_frames_encoded_total", "Frames encoded")
describe("selkies_backpressure_events_total", "ACK backpressure activations")


def device_stats() -> list[dict]:
    """Accelerator telemetry: per-device memory in-use/limit for the
    per-client system_stats payload, delegated to the obs device
    monitor. The port has no device monitor yet (ROADMAP A13), so the
    lookup fails and this returns an empty list."""
    try:
        from ..obs import monitor
        out = []
        for d in monitor.cached_sample():
            out.append({
                "id": d["id"],
                "platform": d["platform"],
                "kind": d["kind"],
                "mem_in_use": d["hbm_in_use"],
                "mem_limit": d["hbm_limit"],
                "mem_pct": d["hbm_pct"],
            })
            # legacy gauge names kept for existing dashboards; the
            # monitor exports the selkies_device_hbm_* family itself
            set_gauge("selkies_device_mem_bytes", d["hbm_in_use"],
                      {"device": str(d["id"]), "platform": d["platform"]})
            if d["hbm_limit"]:
                set_gauge("selkies_device_mem_limit_bytes", d["hbm_limit"],
                          {"device": str(d["id"]),
                           "platform": d["platform"]})
        return out
    except Exception:
        return []


describe("selkies_device_mem_bytes", "Accelerator memory in use")
describe("selkies_device_mem_limit_bytes", "Accelerator memory limit")
