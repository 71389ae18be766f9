"""Why the capture loop's depth-2 ring loses to depth 1 on one card.

    python3 capture_depth_probe.py [--frames N] [--out PATH]

Runs the chip_smoke capture loop (``ScreenCapture("synthetic")`` at
1920x1080, the seeded 480x270 watermark at location 6, CBR, the keyframe
cadence and content adaptivity off, unpaced) for JPEG at its defaults
and for the default H.264 configuration, at depth 1 and depth 2, under
each of four interpreter settings:

- how the kernel library is loaded: ``ctypes.CDLL``, which gives the
  interpreter lock up around every launch, or ``ctypes.PyDLL``, which
  keeps it;
- the interpreter's switch interval (``sys.setswitchinterval``): the
  default 5 ms, or 0.5 ms. A thread that wants the lock back waits up to
  one interval while the other thread runs Python.

The settings run in the order A B C D A, so the repeat of the first
shows the drift of the card and the host between runs. For every run it
prints fps, dispatch-to-delivery latency, the median encode dispatch and
the median per frame of the wall time the capture thread spent inside
kernel launches (``_cuda.launch``, the lock's re-acquisition included),
and requires depth-2 chunks equal to depth 1's. One JSON line per run
goes to standard output (and to ``--out`` when given). Needs one card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
import threading
import time
from pathlib import Path

import torch

import chip_smoke as smoke
from selkies_tpu_torch.ops import _cuda

ROOT = str(Path(__file__).resolve().parent) + "/"
SETTINGS = [("CDLL", 0.005), ("PyDLL", 0.005), ("CDLL", 0.0005),
            ("PyDLL", 0.0005), ("CDLL", 0.005)]


def use(loader: str, interval: float) -> None:
    """Reload the kernel library through ``loader``; set the interval."""
    with _cuda._lock:
        _cuda.LOADER = getattr(ctypes, loader)
        _cuda._lib = None
        _cuda._fns.clear()
    sys.setswitchinterval(interval)


class LaunchClock:
    """While installed: the wall time of the kernel launches made inside
    each session ``encode`` on the capture thread, one sum per frame."""

    def __init__(self):
        self.per_frame, self._ns = [], 0
        self._saved = {}

    def __enter__(self):
        launch = _cuda.launch

        def timed(entry, *args):
            t0 = time.perf_counter_ns()
            try:
                return launch(entry, *args)
            finally:
                if "capture" in threading.current_thread().name:
                    self._ns += time.perf_counter_ns() - t0
        self._saved[_cuda] = ("launch", launch)
        _cuda.launch = timed
        for cls in (smoke.JpegEncoderSession, smoke.H264EncoderSession):
            self._saved[cls] = ("encode", cls.encode)
            cls.encode = self._clocked(cls.encode)
        return self

    def _clocked(self, encode):
        def wrapped(sess, *a, **kw):
            self._ns = 0
            try:
                return encode(sess, *a, **kw)
            finally:
                self.per_frame.append(self._ns)
        return wrapped

    def __exit__(self, *exc):
        for owner, (attr, fn) in self._saved.items():
            setattr(owner, attr, fn)


class StackSampler:
    """A poor man's sampling profiler: a thread that wakes every
    ``period_s``, reads every thread's current Python frame and counts,
    for the capture thread while it is inside a session's ``encode`` and
    for the ring's finalizer thread, the innermost line of the port or of
    torch it sits on. A thread waiting to get the lock back after a C
    call is counted at that call, so the counts are where each thread's
    wall time goes, waits included."""

    def __init__(self, period_s: float = 0.0002):
        self.period_s = period_s
        self.counts = {"capture.encode": {}, "finalize": {}}
        self.samples = {"capture.encode": 0, "finalize": 0}
        self._stop = threading.Event()

    def __enter__(self):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="probe-sampler")
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    @staticmethod
    def _where(frame) -> tuple[str | None, str]:
        """(role of the stack, its innermost repo or torch line)."""
        role, line = None, None
        f = frame
        while f is not None:
            code = f.f_code
            path = code.co_filename
            if line is None and ("selkies_tpu_torch" in path
                                 or "/torch/" in path):
                short = path.replace(ROOT, "").split("site-packages/")[-1]
                line = f"{short}:{f.f_lineno} {code.co_name}"
            if code.co_name == "encode" and "engine" in path:
                role = "capture.encode"
            f = f.f_back
        return role, line or "?"

    def _run(self) -> None:
        names = {}
        while not self._stop.wait(self.period_s):
            for t in threading.enumerate():
                names[t.ident] = t.name
            for ident, frame in sys._current_frames().items():
                name = names.get(ident, "")
                role, line = self._where(frame)
                if "finalize" in name:
                    role = "finalize"
                elif "capture" not in name or role is None:
                    continue
                self.samples[role] += 1
                c = self.counts[role]
                c[line] = c.get(line, 0) + 1

    def top(self, role: str, n: int = 12) -> list:
        total = self.samples[role] or 1
        return [[line, k, round(k / total, 4)] for line, k in sorted(
            self.counts[role].items(), key=lambda kv: -kv[1])[:n]]


def sample(frames: int) -> list:
    """Both codecs at depth 1 and 2 (CDLL, the default interval) under
    the sampler. -> one row per run."""
    rows = []
    use("CDLL", 0.005)
    for mode in ("jpeg", "h264"):
        smoke.capture_run(mode, 1, 1000.0)          # warm-up
        for depth in (1, 2):
            with StackSampler() as sampler:
                run = smoke.capture_run(mode, depth, 1000.0)
            st = smoke.capture_stats(run)
            row = {"mode": mode, "depth": depth, "fps": st["fps"],
                   "dispatch_ms_median":
                       st["stage_ms_median"].get("encode.dispatch"),
                   "samples": sampler.samples,
                   "capture_encode_top": sampler.top("capture.encode"),
                   "finalize_top": sampler.top("finalize")}
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--out", help="also write the JSON lines here")
    ap.add_argument("--sample", action="store_true",
                    help="instead of the settings matrix, sample where the "
                    "capture and finalizer threads spend their time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("capture_depth_probe: no CUDA device", file=sys.stderr)
        return 2
    print(smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    smoke.CAPTURE_FRAMES = args.frames
    _cuda.build()
    saved = {m: m.maybe_load for m in (smoke.port_encoder, smoke.port_h264)}
    for m in saved:
        m.maybe_load = smoke.seeded_watermark
    rows, ok = [], True
    try:
        if args.sample:
            rows = sample(args.frames)
            return 0
        for mode in ("jpeg", "h264"):
            smoke.capture_run(mode, 1, 1000.0)          # warm-up
            for k, (loader, interval) in enumerate(SETTINGS):
                use(loader, interval)
                runs = {}
                for depth in (1, 2):
                    with LaunchClock() as clock:
                        runs[depth] = smoke.capture_run(mode, depth, 1000.0)
                    st = smoke.capture_stats(runs[depth])
                    row = {"mode": mode, "order": k, "loader": loader,
                           "switch_interval_s": interval, "depth": depth,
                           "fps": st["fps"],
                           "latency_ms_median": st["latency_ms_median"],
                           "latency_ms_p99": st["latency_ms_p99"],
                           "dispatch_ms_median":
                               st["stage_ms_median"].get("encode.dispatch"),
                           "launch_wall_ms_median":
                               statistics.median(clock.per_frame) / 1e6,
                           "finalize_ms_median": st["finalize_ms_median"],
                           "overlap": st["finalize_overlap"]}
                    rows.append(row)
                    print(json.dumps(row), flush=True)
                same = all(runs[2]["chunks"].get(f) == runs[1]["chunks"]
                           .get(f) for f in range(args.frames))
                ok &= same
                print(f"{mode} {loader} {interval}: depth 2 == depth 1: "
                      f"{same}", flush=True)
    finally:
        for m, fn in saved.items():
            m.maybe_load = fn
        use("CDLL", 0.005)
        if args.out:
            out = Path(args.out)
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
