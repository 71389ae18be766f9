"""Where K5 (``csrc/motion_select.cu``) spends its time, on one NVIDIA card.

    python3 motion_probe.py

Three measurements, printed one line each:

1. ``issue rate``: lanes a clock an SM of ``vabsdiff4`` (the SAD's
   instruction) against ``dp4a``, ``imad`` and ``shf``, each as eight
   independent chains a thread over 1056 blocks of 256 threads.
2. ``sad loop``: K5's one-thread-a-candidate SAD loop (57 scroll
   candidates, a block of 4 x 4 MBs, the tile in shared memory with an
   odd row stride) on a synthetic tile, cycles a block (``clock64``), as
   it is, without the funnel shifts, without the byte |a - b| and without
   the shared-memory loads.
3. ``phases``: K5 itself at 1080p (57 candidates, 64-row windows) and on
   bands of 4 and 16 MB rows, compiled from an instrumented copy of
   ``csrc/motion_select.cu`` that stamps ``clock64`` at the block's
   phase boundaries (staging, SADs, argmin, predictions): the median
   cycles of each phase, the blocks' span on ``%globaltimer`` and the
   CUDA-event time of the same calls (after an L2 flush), each equal to
   the plain version.

Builds with the toolkit's ``nvcc`` into ``selkies_tpu_torch/_build/probe``
(git-ignored). Needs one card; exits non-zero without one.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from selkies_tpu_torch.ops import _cuda
from selkies_tpu_torch.ops import h264_encode as TE

OUT = _cuda.BUILD_ROOT / "probe"

RATE_SRC = r"""
#include <cstdio>
__device__ __forceinline__ unsigned sad4(unsigned a, unsigned b, unsigned c) {
  unsigned r;
  asm volatile("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
               : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
template <int MODE>
__global__ void chains(unsigned* out, unsigned seed, int iters) {
  unsigned a[8], acc[8];
  for (int k = 0; k < 8; k++) { a[k] = seed * (threadIdx.x + k + 1); acc[k] = k; }
  for (int i = 0; i < iters; i++) {
#pragma unroll
    for (int k = 0; k < 8; k++) {
      const unsigned b = acc[(k + 1) & 7];
      if (MODE == 0) acc[k] = sad4(a[k], b, acc[k]);
      else if (MODE == 1) acc[k] = __dp4a(a[k], b, acc[k]);
      else if (MODE == 2) acc[k] = a[k] * b + acc[k];
      else acc[k] = __funnelshift_r(a[k], b, acc[k]);
    }
  }
  unsigned s = 0;
  for (int k = 0; k < 8; k++) s += acc[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
int main() {
  int sms, clk;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaDeviceGetAttribute(&clk, cudaDevAttrClockRate, 0);
  const int iters = 4096, blocks = sms * 8, threads = 256;
  unsigned* out;
  cudaMalloc(&out, sizeof(unsigned) * blocks * threads);
  const char* names[] = {"vabsdiff4", "dp4a", "imad", "shf"};
  for (int mode = 0; mode < 4; mode++) {
    cudaEvent_t a, b;
    cudaEventCreate(&a);
    cudaEventCreate(&b);
    float ms = 0;
    for (int rep = 0; rep < 2; rep++) {
      cudaEventRecord(a);
      if (mode == 0) chains<0><<<blocks, threads>>>(out, 7, iters);
      if (mode == 1) chains<1><<<blocks, threads>>>(out, 7, iters);
      if (mode == 2) chains<2><<<blocks, threads>>>(out, 7, iters);
      if (mode == 3) chains<3><<<blocks, threads>>>(out, 7, iters);
      cudaEventRecord(b);
      cudaEventSynchronize(b);
      cudaEventElapsedTime(&ms, a, b);
    }
    const double ops = 8.0 * blocks * threads * iters;
    printf("%s %.1f\n", names[mode], ops / (ms * 1e-3) / sms / (clk * 1e3));
  }
  return cudaGetLastError() != cudaSuccess;
}
"""

SAD_SRC = r"""
#include <cstdio>
__device__ __forceinline__ unsigned sad4(unsigned a, unsigned b, unsigned c) {
  unsigned r;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
      : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ unsigned long long cyc[1024];
// MODE 0 as K5, 1 no funnel shifts, 2 xor for |a - b|, 3 no shared loads
template <int MODE>
__global__ void __launch_bounds__(256, 4) sad(unsigned* out, const short* dys,
                                              const short* dxs, int n,
                                              int TWW) {
  extern __shared__ uint4 sm[];
  uint4* cur4 = sm;
  unsigned* key = reinterpret_cast<unsigned*>(cur4 + 256);
  unsigned* tile = key + 2048;
  const int tid = threadIdx.x;
  cur4[tid] = make_uint4(tid * 7, tid * 13, tid * 17, tid * 19);
  for (int i = tid; i < 112 * TWW; i += 256) tile[i] = i * 2654435761u;
  __syncthreads();
  const long long t0 = clock64();
  const int nb = 16, nm = 4, V = 24, Hm = 8, e = 8, items = nb * n;
  for (int base = 0; base < items; base += 256) {
    const int it = min(base + tid, items - 1);
    const int b = it / n, k = it - b * n, rb = b / nm, j = b - rb * nm;
    const int col = 16 * j + dxs[k] + Hm + e, sh = 8 * (col & 3);
    const unsigned* tp = tile + (16 * rb + dys[k] + V) * TWW + (col >> 2);
    const uint4* cp = cur4 + 16 * rb * nm + j;
    unsigned acc = 0;
#pragma unroll 4
    for (int i = 0; i < 16; i++) {
      const unsigned* q = tp + i * TWW;
      uint4 a, w;
      if (MODE == 3) {
        a = make_uint4(i, i + 1, i + 2, i + 3);
        w = make_uint4(acc, acc + 1, acc + 2, acc + 3);
      } else {
        a = cp[i * nm];
        w = MODE == 1 ? make_uint4(q[0], q[1], q[2], q[3])
                      : make_uint4(__funnelshift_r(q[0], q[1], sh),
                                   __funnelshift_r(q[1], q[2], sh),
                                   __funnelshift_r(q[2], q[3], sh),
                                   __funnelshift_r(q[3], q[4], sh));
      }
      if (MODE == 2) {
        acc += a.x ^ w.x ^ a.y ^ w.y ^ a.z ^ w.z ^ a.w ^ w.w;
      } else {
        acc = sad4(a.x, w.x, acc);
        acc = sad4(a.y, w.y, acc);
        acc = sad4(a.z, w.z, acc);
        acc = sad4(a.w, w.w, acc);
      }
    }
    if (base + tid < items) key[b * 128 + k] = acc;
  }
  __syncthreads();
  if (tid == 0) cyc[blockIdx.x] = clock64() - t0;
  out[blockIdx.x * 256 + tid] = key[tid];
}
int main() {
  short dy[57], dx[57];
  int n = 0;
  dy[n] = 0; dx[n++] = 0;
  for (int d = 1; d <= 24; d++) {
    dy[n] = d; dx[n++] = 0;
    dy[n] = -d; dx[n++] = 0;
  }
  for (int d = 1; d <= 8; d *= 2) {
    dy[n] = 0; dx[n++] = d;
    dy[n] = 0; dx[n++] = -d;
  }
  short *ddy, *ddx;
  cudaMalloc(&ddy, sizeof dy);
  cudaMalloc(&ddx, sizeof dx);
  cudaMemcpy(ddy, dy, sizeof dy, cudaMemcpyHostToDevice);
  cudaMemcpy(ddx, dx, sizeof dx, cudaMemcpyHostToDevice);
  const int blocks = 510, TWW = 25;
  unsigned* out;
  cudaMalloc(&out, sizeof(unsigned) * blocks * 256);
  const size_t smem = 256 * 16 + 2048 * 4 + 112 * TWW * 4;
  const char* names[] = {"as_K5", "no_shift", "no_absdiff", "no_loads"};
  for (int mode = 0; mode < 4; mode++) {
    for (int rep = 0; rep < 2; rep++) {
      if (mode == 0) sad<0><<<blocks, 256, smem>>>(out, ddy, ddx, n, TWW);
      if (mode == 1) sad<1><<<blocks, 256, smem>>>(out, ddy, ddx, n, TWW);
      if (mode == 2) sad<2><<<blocks, 256, smem>>>(out, ddy, ddx, n, TWW);
      if (mode == 3) sad<3><<<blocks, 256, smem>>>(out, ddy, ddx, n, TWW);
    }
    cudaDeviceSynchronize();
    unsigned long long c[blocks];
    cudaMemcpyFromSymbol(c, cyc, sizeof c);
    unsigned long long s = 0;
    for (int i = 0; i < blocks; i++) s += c[i];
    printf("%s %llu\n", names[mode], s / blocks);
  }
  return cudaGetLastError() != cudaSuccess;
}
"""

# stamps at the phase boundaries of motion_select_kernel: (text, stamp,
# inserted after that text or before it)
STAMPS = (
    ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
     0, True),
    ("  __syncthreads();\n\n  // SADs:", 1, False),
    ("  __syncthreads();\n\n  // argmin:", 2, False),
    ("  __syncthreads();\n\n  // the predictions:", 3, False),
    ("  if (tid < nb) {\n", 4, False),
)
STAMP_DEFS = r"""
__device__ unsigned long long ms_t[1 << 16][5];
__device__ unsigned long long ms_g[1 << 16][2];
__device__ __forceinline__ void ms_stamp(int x) {
  if (threadIdx.x) return;
  const int b = blockIdx.y * gridDim.x + blockIdx.x;
  ms_t[b][x] = clock64();
  if (x == 0 || x == 4) {
    unsigned long long g;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
    ms_g[b][x == 4] = g;
  }
}
"""
READ_SRC = r"""
extern "C" int ms_zero() {
  void* p;
  cudaGetSymbolAddress(&p, ms_g);
  cudaMemset(p, 0, sizeof(ms_g));
  return static_cast<int>(cudaDeviceSynchronize());
}
extern "C" int ms_read(unsigned long long* t, unsigned long long* g, int nb) {
  cudaMemcpyFromSymbol(t, ms_t, sizeof(unsigned long long) * 5 * nb);
  cudaMemcpyFromSymbol(g, ms_g, sizeof(unsigned long long) * 2 * nb);
  return static_cast<int>(cudaGetLastError());
}
"""


def nvcc(*args) -> None:
    r = subprocess.run([_cuda._nvcc(), *_cuda.ARCH, "-std=c++17", "-O3",
                        *args], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(r.stdout + r.stderr)


def run_binary(name: str, src: str) -> list:
    (OUT / f"{name}.cu").write_text(src)
    nvcc("-o", str(OUT / name), str(OUT / f"{name}.cu"))
    r = subprocess.run([str(OUT / name)], capture_output=True, text=True,
                       timeout=300)
    if r.returncode:
        raise RuntimeError(f"{name} failed: {r.stdout}{r.stderr}")
    return [line.split() for line in r.stdout.splitlines()]


def instrumented_library():
    """The K5 entries from a copy of motion_select.cu with phase stamps."""
    src = (_cuda.CSRC / "motion_select.cu").read_text()
    src = src.replace('#include "h264_common.cuh"\n',
                      '#include "h264_common.cuh"\n' + STAMP_DEFS, 1)
    for text, x, after in STAMPS:
        if src.count(text) != 1:
            raise RuntimeError(f"stamp marker not found once: {text!r}")
        at = src.index(text)
        if after:
            at += len(text)
        elif text.startswith("  __syncthreads();"):
            at += len("  __syncthreads();\n")
        src = src[:at] + f"  ms_stamp({x});\n" + src[at:]
    (OUT / "motion_stamped.cu").write_text(src + READ_SRC)
    so = OUT / "libmotion_stamped.so"
    nvcc("-Xcompiler", "-fPIC", "-shared", "-I", str(_cuda.CSRC), "-o",
         str(so), str(OUT / "motion_stamped.cu"),
         str(_cuda.CSRC / "errors.cu"))
    lib = ctypes.CDLL(str(so))
    fn = lib.motion_select
    fn.argtypes = _cuda.ENTRIES["motion_select"] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.ms_read.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int]
    return lib, fn


def phases(lib, fn, args, cands, win, label) -> None:
    """Stamped calls of K5 on ``args`` (its output checked against the
    plain version), then CUDA-event times of the same library."""
    saved = _cuda._fns.get("motion_select")
    _cuda._fns["motion_select"] = fn
    if lib.ms_zero():
        raise RuntimeError("motion_probe: clearing the stamps failed")
    try:
        out = TE.motion_select(*args, cands, win)
        want = TE.motion_select_plain(*args, cands, win)
        if not all(torch.equal(a, b) for a, b in zip(out, want)):
            raise RuntimeError(f"{label}: stamped K5 differs from plain")
        l2 = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        times = []
        for _ in range(20):
            l2.zero_()
            torch.cuda._sleep(2_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            TE.motion_select(*args, cands, win, out=out)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
    finally:
        if saved is None:
            _cuda._fns.pop("motion_select")
        else:
            _cuda._fns["motion_select"] = saved
    nb = 1 << 16
    t = np.zeros((nb, 5), np.uint64)
    g = np.zeros((nb, 2), np.uint64)
    lib.ms_read(t.ctypes.data, g.ctypes.data, nb)
    used = g[:, 0] > 0
    t, g = t[used].astype(np.int64), g[used].astype(np.int64)
    d = np.median(np.diff(t, axis=1), 0)
    span = (g[:, 1].max() - g[:, 0].min()) / 1e3
    print(f"phases {label}: {int(used.sum())} blocks; median cycles stage "
          f"{d[0]:.0f}, SADs {d[1]:.0f}, argmin {d[2]:.0f}, predictions "
          f"{d[3]:.0f}; blocks' span {span:.2f} us; event time "
          f"{np.median(times) * 1e3:.2f} us (median of 20 after an L2 "
          "flush)")


def main() -> int:
    if not torch.cuda.is_available():
        print("motion_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    OUT.mkdir(parents=True, exist_ok=True)
    rates = run_binary("issue_rate", RATE_SRC)
    print("issue rate (lanes a clock an SM): "
          + ", ".join(f"{n} {v}" for n, v in rates))
    loops = run_binary("sad_loop", SAD_SRC)
    print("sad loop (cycles a block of 16 MBs x 57 candidates): "
          + ", ".join(f"{n} {v}" for n, v in loops))
    _cuda._fn("motion_select")           # builds and loads the library
    rng = np.random.default_rng(1)
    H, W = 1088, 1920
    ref = [torch.as_tensor(rng.integers(0, 256, s, dtype=np.uint8),
                           device="cuda")
           for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    cur = torch.roll(ref[0], -5, 0).contiguous()
    qp = torch.full((H // 16,), 28, dtype=torch.int32, device="cuda")
    cands = TE.scroll_candidates()
    lib, fn = instrumented_library()
    for rows in (None, 4, 16):
        if rows is None:
            args, label = (cur, *ref, qp), "1080p"
        else:
            args = (cur[:16 * rows], ref[0][:16 * rows],
                    ref[1][:8 * rows], ref[2][:8 * rows], qp[:rows])
            label = f"band of {rows} MB rows"
        phases(lib, fn, args, cands, 64, label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
