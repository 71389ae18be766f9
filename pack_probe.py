"""The stream operations of K9 (``csrc/jpeg_pack.cu``) on one NVIDIA card.

    python3 pack_probe.py

Traces K9's two entries with ``torch.profiler`` (CUPTI) on the 1080p
JPEG path's events (K7 and K8 on the first desktop frame of
``chip_smoke.py``, 17 stripes of 64 rows): ``jpeg_pack`` at the stock
and at twice the stock caps, and ``jpeg_pack_seats`` at 1, 2, 4 and 8
seats of that frame. Each call runs after an L2 flush, as the timing
points of ``chip_smoke.py`` do. For every device operation of a call
(kernels and memsets, in stream order) it prints the median duration
and the median gap since the end of the operation before it, and the
median span of the call from its first start to its last end; beside
it, the call's median time between CUDA events. Each output is held
equal to the plain version first. Needs one card; exits non-zero
without one.

Then ``phases``: K9 compiled from copies of ``csrc/jpeg_pack.cu`` and
``csrc/stripe_bytes.cuh`` whose kernels stamp ``%globaltimer`` (and the
row kernel ``%smid``) at their phase boundaries, thread 0 of each block:
the row kernel's entry, its nbits resident, steps summed and payloads
requested, its share of zeros stored, steps scanned, its arrival at the
cluster barrier, codewords placed, the barrier's wait, words stored;
the byte stage's entry, the row grid waited for, the row totals loaded,
the byte starts scanned, its bytes gathered. At 1080p and at 8 seats:
each phase's median over the blocks, the blocks' end times (median,
90th percentile, last) and the slowest block's phases, the span from
the first entry to the last store, the SMs the blocks ran on and the
most one SM held, the byte stage's phases against the row grid's end,
beside the CUDA-event time of the same library (each output equal to
the plain version).
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

REPS = 20
NSTAMP = 16                   # stamps a block; the last slot is its SM

STAMP_DEFS = r"""
__device__ unsigned long long jp_t[1 << 17];
__device__ __forceinline__ void jp_stamp(int k) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    jp_t[blockIdx.x * 16 + k] = t;
    if (k == 0) {
      unsigned sm;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      jp_t[blockIdx.x * 16 + 15] = sm;
    }
  }
}
"""

READ_SRC = r"""
extern "C" int jp_read(unsigned long long* t, int n,
                       unsigned long long* b) {
  cudaMemcpyFromSymbol(b, jb_t, sizeof(unsigned long long) * (1 << 16));
  cudaMemcpyFromSymbol(t, jp_t, sizeof(unsigned long long) * n);
  return static_cast<int>(cudaGetLastError());
}
"""

#: (text in jpeg_rows_kernel, stamp, stamp after the text)
STAMPS = [
    ("  const int nq = 16 * nm;                  // the block's nbits, u32 "
     "words", 0, True),
    ("  if (nm > 0 && a.nb_res) mbar_wait(&h.bar_res, 0);", 1, True),
    ("  cluster_arrive();\n", 2, False),
    ("  if (big) layout();", 3, True),
    ("  if (!big) layout();", 4, False),
    ("  if (!big) layout();", 5, True),
    ("    a.byte_lens[s] = n_ev;\n  }", 6, True),
    ("  asm volatile(\"cp.async.commit_group;\" ::: \"memory\");\n"
     "  // then this rank's share", 7, False),
    ("  nev = warp_sum(nev);", 8, False),
    ("    const int* buf =\n", 9, False),
]
#: the row kernel's phases: (name, first stamp, last stamp). Stamp 9
#: falls after the last chunk's payloads have landed, so "payload_wait"
#: holds the wait for them (and, with two buffers, the earlier chunks'
#: placement), "place" the last chunk's placement
PHASES = [("nbits_in", 0, 1), ("sums_fetch", 1, 7), ("zeros", 7, 8),
          ("scan", 8, 2), ("arrive", 2, 3), ("payload_wait", 3, 9),
          ("place", 9, 4), ("barrier_wait", 4, 5), ("store", 5, 6)]
#: the byte stage's phases (stripe_bytes.cuh's kernel; thread 0 of each
#: block): entry, the row kernel's grid waited for, the row totals loaded,
#: the byte starts scanned, its bytes gathered (before the store)
BYTE_STAMPS = [
    ('  asm volatile("griddepcontrol.wait;" ::: "memory");\n  const int seat',
     0, False),
    ('  asm volatile("griddepcontrol.wait;" ::: "memory");\n  const int seat',
     1, "wait"),
    ("    if constexpr (PAD) tbits[k] = static_cast<int>(starts[k]);\n  }\n"
     "  __syncthreads();\n", 2, True),
    ("  __syncthreads();\n  const long long j0", 3, "sync"),
    ("  uint8_t* dst = data + j0;", 4, False),
]
BYTE_DEFS = r"""
__device__ unsigned long long jb_t[1 << 16];
__device__ __forceinline__ void jb_stamp(int k) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    jb_t[(blockIdx.y * gridDim.x + blockIdx.x) * 8 + k] = t;
  }
}
"""

def device_ops(prof) -> list:
    """(name, start us, end us) of every device operation, in time order."""
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.name, e.time_range.start, e.time_range.end))
    return sorted(out, key=lambda x: x[1])


def split_calls(ops: list, marker: str) -> list:
    """The operations between consecutive flushes (names holding
    ``marker``): one list a call."""
    calls, cur = [], None
    for op in ops:
        if marker in op[0]:
            if cur:
                calls.append(cur)
            cur = []
        elif cur is not None:
            cur.append(op)
    if cur:
        calls.append(cur)
    return calls


def profile(fn, flush, label: str) -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    import chip_smoke as CS
    fn()
    torch.cuda.synchronize()
    ms = CS.time_fn(fn, REPS, flush=flush, hide_launch=True)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            flush()
            fn()
        torch.cuda.synchronize()
    calls = split_calls(device_ops(prof), "Fill")
    if not calls or not calls[-1]:
        raise SystemExit(f"{label}: the trace holds no device operation")
    n = statistics.mode(len(c) for c in calls)
    calls = [c for c in calls if len(c) == n]
    rows = []
    for k in range(n):
        durs = [c[k][2] - c[k][1] for c in calls]
        gaps = [c[k][1] - c[k - 1][2] for c in calls] if k else [0.0]
        rows.append({"op": calls[0][k][0][:60],
                     "us": round(statistics.median(durs), 2),
                     "gap_us": round(statistics.median(gaps), 2)})
    span = statistics.median(c[-1][2] - c[0][1] for c in calls)
    return {"call": label, "event_ms": round(ms, 4),
            "span_us": round(span, 2), "ops": rows}


def stamped_library():
    """K9's entries from a copy of jpeg_pack.cu with phase stamps."""
    from selkies_tpu_torch.ops import _cuda
    out = _cuda.BUILD_ROOT / "probe"
    out.mkdir(parents=True, exist_ok=True)
    src = (_cuda.CSRC / "jpeg_pack.cu").read_text()
    src = src.replace('#include "stripe_bytes.cuh"\n',
                      '#include "stripe_bytes.cuh"\n' + STAMP_DEFS, 1)
    for text, k, after in STAMPS:
        if src.count(text) != 1:
            raise RuntimeError(f"stamp marker not found once: {text!r}")
        at = src.index(text) + (len(text) + 1 if after else 0)
        stamp = f"  jp_stamp({k});\n"
        if k == 6:
            stamp = "  __syncthreads();\n" + stamp
        src = src[:at] + stamp + src[at:]
    hdr = (_cuda.CSRC / "stripe_bytes.cuh").read_text()
    hdr = hdr.replace("namespace {\n", "namespace {\n" + BYTE_DEFS, 1)
    for text, k, where in BYTE_STAMPS:
        if hdr.count(text) != 1:
            raise RuntimeError(f"byte stamp marker not found once: {text!r}")
        at = hdr.index(text)
        if where is True:
            at += len(text)
        elif where == "wait":
            at += len('  asm volatile("griddepcontrol.wait;" ::: "memory");\n')
        elif where == "sync":
            at += len("  __syncthreads();\n")
        hdr = hdr[:at] + f"  jb_stamp({k});\n" + hdr[at:]
    (out / "stripe_bytes.cuh").write_text(hdr)
    (out / "jpeg_stamped.cu").write_text(src + READ_SRC)
    so = out / "libjpeg_stamped.so"
    r = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-I",
                        str(out), "-I", str(_cuda.CSRC), "-o", str(so),
                        str(out / "jpeg_stamped.cu"),
                        str(_cuda.CSRC / "errors.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(r.stdout + r.stderr)
    lib = ctypes.CDLL(str(so))
    fns = {}
    for name in ("jpeg_pack", "jpeg_pack_seats"):
        fn = getattr(lib, name)
        fn.argtypes = _cuda.ENTRIES[name] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    lib.jp_read.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    return lib, fns


def phases(lib, fns, call, check, flush, label: str) -> dict:
    """Stamped calls of K9 (``call()``), checked by ``check(out)``, then
    CUDA-event times of the same library; the stamps of the last call."""
    from selkies_tpu_torch.ops import _cuda
    saved = {k: _cuda._fns.get(k) for k in fns}
    _cuda._fns.update(fns)
    try:
        check(call())
        times = []
        for _ in range(REPS):
            flush()
            torch.cuda._sleep(2_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            call()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
    finally:
        for k, v in saved.items():
            if v is None:
                _cuda._fns.pop(k, None)
            else:
                _cuda._fns[k] = v
    n = 1 << 17
    t = np.zeros(n, np.uint64)
    bt = np.zeros(1 << 16, np.uint64)
    lib.jp_read(t.ctypes.data, n, bt.ctypes.data)
    bt = bt.reshape(-1, 8).astype(np.int64)
    bt = bt[bt[:, 0] > 0]
    t = t.reshape(-1, NSTAMP).astype(np.int64)
    t = t[t[:, 0] > 0]
    sm = t[:, 15]
    st = t[:, :15]
    per_sm = np.bincount(sm)
    rows_end = st[:, 6].max()
    byte = {"release_after_rows_end": int(np.median(bt[:, 1]) - rows_end),
            "totals_in": int(np.median(bt[:, 2] - bt[:, 1])),
            "scan": int(np.median(bt[:, 3] - bt[:, 2])),
            "gather": int(np.median(bt[:, 4] - bt[:, 3])),
            "gather_end_after_rows_end_p50_p90_max": np.percentile(
                bt[:, 4] - rows_end, [50, 90, 100]).astype(int).tolist(),
            "latest_block": int(np.argmax(bt[:, 4])),
            "early_blocks": int((bt[:, 0] < rows_end).sum()),
            "blocks": int(len(bt))}
    life = st[:, 6] - st[:, 0].min()
    slow = int(np.argmax(st[:, 6]))
    return {"call": label, "blocks": int(len(st)),
            "block_end_us_p50_p90_max": (np.percentile(
                life, [50, 90, 100]) / 1e3).round(2).tolist(),
            "slowest_block_phase_ns": {k: int(st[slow, b] - st[slow, a])
                                       for k, a, b in PHASES},
            "slowest_block_sm_blocks": int(per_sm[sm[slow]]),
            "phase_ns": {k: int(np.median(st[:, b] - st[:, a]))
                         for k, a, b in PHASES},
            "span_us": round((st[:, 6].max() - st[:, 0].min()) / 1e3, 2),
            "entry_spread_us": round((st[:, 0].max() - st[:, 0].min()) / 1e3,
                                     2),
            "sms": int((per_sm > 0).sum()), "max_blocks_an_sm":
            int(per_sm.max()),
            "byte_stage_ns": byte,
            "event_us": round(statistics.median(times) * 1e3, 2)}


def main() -> int:
    if not torch.cuda.is_available():
        print("pack_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    import chip_smoke as CS
    from selkies_tpu_torch.engine.encoder import (JpegEncoderSession,
                                                  jpeg_buffer_caps)
    from selkies_tpu_torch.engine.types import CaptureSettings
    from selkies_tpu_torch.ops import _cuda
    from selkies_tpu_torch.ops import jpeg_entropy as JE
    from selkies_tpu_torch.ops import jpeg_pipeline as JPP
    from selkies_tpu_torch.ops import jpeg_planes as JPL
    _cuda.build()
    sess = JpegEncoderSession(CaptureSettings(
        capture_width=CS.WIDTH, capture_height=CS.HEIGHT))
    g, dev = sess.grid, sess.device
    f0 = torch.as_tensor(CS.desktop_frames(g.height, g.width,
                                           CS.HEIGHT)[0]).to(dev)
    l2 = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def flush():
        l2.fill_(0)
    e_cap, w_cap, out_cap = jpeg_buffer_caps(g, False)
    rows = []
    for n in (0, 1, 2, 4, 8):
        frame = f0.repeat(max(n, 1), 1, 1)
        S = max(n, 1) * g.n_stripes
        tab = torch.zeros((S,), dtype=torch.int32, device=dev)
        planes = JPL.jpeg_forward(frame, torch.zeros_like(frame), tab,
                                  sess._qtab, sess.subsampling)
        k8 = JE.jpeg_events(*planes, sess._scan, S)
        if n == 0:
            cases = [("jpeg_pack 1080p stock caps", (e_cap, w_cap, out_cap)),
                     ("jpeg_pack 1080p 2x caps",
                      (e_cap, 2 * w_cap, 2 * out_cap))]
            for label, caps in cases:
                err = CS.max_abs_err(JPP.jpeg_pack(*k8, *caps),
                                     JPP.jpeg_pack_plain(*k8, *caps))
                CS.check(err == 0, f"{label} differs from plain")
                rows.append(profile(lambda: JPP.jpeg_pack(*k8, *caps),
                                    flush, label))
            continue
        caps = (e_cap, w_cap, out_cap)
        err = CS.max_abs_err(JPP.jpeg_pack_seats(*k8, *caps, n_seats=n),
                             JPP.jpeg_pack_seats_plain(*k8, *caps,
                                                       n_seats=n))
        CS.check(err == 0, f"jpeg_pack_seats S={n} differs from plain")
        rows.append(profile(lambda: JPP.jpeg_pack_seats(*k8, *caps,
                                                        n_seats=n),
                            flush, f"jpeg_pack_seats S={n}"))
    for r in rows:
        print("K9 stream operations: " + json.dumps(r))
    lib, fns = stamped_library()
    for n in (1, 8):
        frame = f0.repeat(n, 1, 1)
        S = n * g.n_stripes
        tab = torch.zeros((S,), dtype=torch.int32, device=dev)
        planes = JPL.jpeg_forward(frame, torch.zeros_like(frame), tab,
                                  sess._qtab, sess.subsampling)
        k8 = JE.jpeg_events(*planes, sess._scan, S)
        caps = (e_cap, w_cap, out_cap)

        def call(k8=k8, n=n):
            return JPP.jpeg_pack_seats(*k8, *caps, n_seats=n)

        def same(out, k8=k8, n=n):
            err = CS.max_abs_err(out, JPP.jpeg_pack_seats_plain(
                *k8, *caps, n_seats=n))
            CS.check(err == 0, f"stamped K9 at S={n} differs from plain")
        print("K9 phases: " + json.dumps(
            phases(lib, fns, call, same, flush, f"jpeg_pack_seats S={n}")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
