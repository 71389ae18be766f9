"""What bounds K6 (``csrc/row_damage_probe.cu``) under chip_smoke's timing
protocol, on one NVIDIA card.

    python3 damage_probe.py

chip_smoke times a kernel between CUDA events after writing 64 MB of
zeros (so the L2 is full of dirty lines) and a spin kernel that hides the
host's enqueue. This script times, under the same protocol (median of
20), on a 1920x1088 RGB frame and its damage reference at 68 bands (MB
rows) and 17 (JPEG stripes):

- an empty kernel (the protocol's floor);
- K6 itself, through ``ops.h264_planes.row_damage_probe``;
- four ways to compare every byte, each built here from the source
  below: one block of 1024 threads a band; 256-thread blocks, several a
  band, meeting on per-band tickets (K6's design); the same with loads
  under an L2 evict-first policy; a memset of the flags, then blocks
  that OR their bits into them (K6's earlier design).

Builds with the toolkit's ``nvcc`` into ``selkies_tpu_torch/_build/probe``
(git-ignored). Needs one card; exits non-zero without one.
"""

from __future__ import annotations

import statistics
import subprocess
import sys

import numpy as np
import torch

from selkies_tpu_torch.ops import _cuda
from selkies_tpu_torch.ops import h264_planes as HP

OUT = _cuda.BUILD_ROOT / "probe"
H, W = 1088, 1920

SRC = r"""
#include <cstdio>
#include <cstdint>
#include <initializer_list>
#include <cuda_runtime.h>
__global__ void spin(long long n) {
  const long long t = clock64();
  while (clock64() - t < n) {}
}
__global__ void fill(uint8_t* a, size_t n) {
  for (size_t i = blockIdx.x * 256ull + threadIdx.x; i < n; i += 256ull * gridDim.x)
    a[i] = static_cast<uint8_t>((i * 2654435761ull) >> 13);
}
__global__ void empty_kernel(int* out) {
  if (threadIdx.x == 0 && blockIdx.x == 0) out[0] = 1;
}
__device__ __forceinline__ unsigned x4(uint4 a, uint4 b) {
  return (a.x ^ b.x) | (a.y ^ b.y) | (a.z ^ b.z) | (a.w ^ b.w);
}
// one block of 1024 threads a band, eight pairs a thread in flight
__global__ void __launch_bounds__(1024) one_block(const uint4* a, const uint4* b,
                                                  long long nv, int* out) {
  const long long base = blockIdx.x * nv;
  unsigned d = 0;
  for (long long i0 = threadIdx.x; i0 < nv; i0 += 1024 * 8) {
    uint4 x[8], y[8];
    for (int k = 0; k < 8; k++) {
      const long long i = i0 + k * 1024;
      x[k] = i < nv ? a[base + i] : make_uint4(0, 0, 0, 0);
      y[k] = i < nv ? b[base + i] : make_uint4(0, 0, 0, 0);
    }
    for (int k = 0; k < 8; k++) d |= x4(x[k], y[k]);
  }
  const int any = __syncthreads_or(d != 0);
  if (threadIdx.x == 0) out[blockIdx.x] = any;
}
// P blocks of 256 a band on per-band tickets (four pairs a thread);
// EF: loads under an L2 evict-first policy
__device__ unsigned long long ticket[1 << 12];
__device__ __forceinline__ uint4 ld_ef(const uint4* p, unsigned long long pol) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.u32 {%0,%1,%2,%3}, [%4], %5;"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p), "l"(pol));
  return v;
}
template <bool EF>
__global__ void __launch_bounds__(256) tickets(const uint4* a, const uint4* b,
                                               long long nv, int P, int* out) {
  unsigned long long pol = 0;
  if (EF) asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol));
  const int band = blockIdx.x / P, rank = blockIdx.x % P;
  const long long base = band * nv;
  unsigned d = 0;
  for (long long i0 = rank * 1024LL + threadIdx.x; i0 < nv; i0 += P * 1024LL) {
    uint4 x[4], y[4];
    for (int k = 0; k < 4; k++) {
      const long long i = i0 + k * 256;
      const bool on = i < nv;
      x[k] = !on ? make_uint4(0, 0, 0, 0) : EF ? ld_ef(a + base + i, pol) : a[base + i];
      y[k] = !on ? make_uint4(0, 0, 0, 0) : EF ? ld_ef(b + base + i, pol) : b[base + i];
    }
    for (int k = 0; k < 4; k++) d |= x4(x[k], y[k]);
  }
  const int any = __syncthreads_or(d != 0);
  if (threadIdx.x == 0) {
    const unsigned long long old = atomicAdd(&ticket[band], 1ull + (any ? 1ull << 32 : 0ull));
    if (static_cast<int>(old & 0xffffffffu) == P - 1) {
      out[band] = (old >> 32) + any > 0;
      ticket[band] = 0;
    }
  }
}
// the earlier design: flags zeroed by a memset, then atomicOr
__global__ void memset_or(const uint4* a, const uint4* b, long long nv, int* out) {
  const long long base = blockIdx.y * nv;
  unsigned d = 0;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < nv; i += gridDim.x * 256LL)
    d |= x4(a[base + i], b[base + i]);
  if (__syncthreads_or(d != 0) && threadIdx.x == 0) atomicOr(&out[blockIdx.y], 1);
}
int main() {
  const size_t bytes = 1088ull * 1920 * 3;
  uint8_t *f0, *f1, *l2;
  int* out;
  cudaMalloc(&f0, bytes);
  cudaMalloc(&f1, bytes);
  cudaMalloc(&l2, 64 << 20);
  cudaMalloc(&out, 4096 * 4);
  fill<<<1024, 256>>>(f0, bytes);
  cudaMemcpy(f1, f0, bytes, cudaMemcpyDeviceToDevice);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const char* names[] = {"empty kernel", "one block a band", "tickets",
                         "tickets, L2 evict-first loads", "memset + atomicOr"};
  for (int R : {68, 17}) {
    const long long nv = bytes / R / 16;
    const int P = static_cast<int>((nv + 1023) / 1024);
    const uint4* a = reinterpret_cast<const uint4*>(f1);
    const uint4* b = reinterpret_cast<const uint4*>(f0);
    for (int v = 0; v < 5; v++) {
      float t[20];
      for (int rep = 0; rep < 20; rep++) {
        cudaMemsetAsync(l2, 0, 64 << 20);
        spin<<<1, 1>>>(2000000);
        cudaEventRecord(e0);
        if (v == 0) empty_kernel<<<1, 32>>>(out);
        if (v == 1) one_block<<<R, 1024>>>(a, b, nv, out);
        if (v == 2) tickets<false><<<R * P, 256>>>(a, b, nv, P, out);
        if (v == 3) tickets<true><<<R * P, 256>>>(a, b, nv, P, out);
        if (v == 4) {
          cudaMemsetAsync(out, 0, 4 * R);
          memset_or<<<dim3(P, R), 256>>>(a, b, nv, out);
        }
        cudaEventRecord(e1);
        cudaEventSynchronize(e1);
        cudaEventElapsedTime(&t[rep], e0, e1);
      }
      for (int i = 0; i < 20; i++)
        for (int j = i + 1; j < 20; j++)
          if (t[j] < t[i]) { const float x = t[i]; t[i] = t[j]; t[j] = x; }
      printf("%d|%s|%.4f\n", R, names[v], 0.5f * (t[9] + t[10]));
    }
  }
  return cudaGetLastError() != cudaSuccess;
}
"""


def nvcc(*args) -> None:
    r = subprocess.run([_cuda._nvcc(), *_cuda.ARCH, "-std=c++17", "-O3",
                        *args], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(r.stdout + r.stderr)


def k6_ms(frame, prev, R: int) -> float:
    """K6 through its wrapper under chip_smoke's protocol (ms)."""
    l2 = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    times = []
    for _ in range(20):
        l2.zero_()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        HP.row_damage_probe(frame, prev, R)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("damage_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "damage_floor.cu").write_text(SRC)
    nvcc("-o", str(OUT / "damage_floor"), str(OUT / "damage_floor.cu"))
    r = subprocess.run([str(OUT / "damage_floor")], capture_output=True,
                       text=True, timeout=300)
    if r.returncode:
        raise RuntimeError(f"damage_floor failed: {r.stdout}{r.stderr}")
    rows: dict = {}
    for line in r.stdout.splitlines():
        R, name, ms = line.split("|")
        rows.setdefault(int(R), []).append(f"{name} {float(ms):.4f}")
    rng = np.random.default_rng(3)
    prev = torch.as_tensor(rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
                           device="cuda")
    frame = prev.clone()
    for R in (68, 17):
        print(f"{R} bands, ms (median of 20 after a 64 MB zero fill): "
              + ", ".join(rows[R]) + f", K6 {k6_ms(frame, prev, R):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
