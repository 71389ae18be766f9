"""The floors of K8 (``csrc/jpeg_events.cu``), K11
(``csrc/pad_frame.cu``), K12 (``csrc/watermark_blend.cu``) and K17
(``csrc/roi_qp_plane.cu``) under chip_smoke's timing protocol, and K8's
phases in cycles, on one NVIDIA card.

    python3 floor_probe.py [--k8-source PATH]

chip_smoke times a kernel between CUDA events after writing 64 MB of
zeros (so the L2 is full of dirty lines) and a spin kernel that hides the
host's enqueue. This script times, under the same protocol (median of
20):

- an empty kernel (the protocol's floor);
- K8's floor: a kernel that only reads the int16 coefficients and writes
  the int32 payloads and uint8 nbits, every access 16 bytes wide and
  every store instruction over whole 32-byte sectors, 4 pieces a thread
  in flight, at
  1080p 4:2:0 (48,960 scan blocks: 6.3 MB in, 15.7 MB out), 4:4:4
  (97,920) and 4 stacked seats (195,840), with plain and with streaming
  (evict-first) stores;
- K11's floors at 1080p into the 1088-row grid, at 3840x2160 into
  3840x2176 and at 1366x768 into 1376x768 (its bytes as one run): a plain
  16-byte copy kernel of the frame and the zero tail, 4 pieces a thread
  in flight (plain and streaming stores), and ``cudaMemcpyAsync`` (device
  to device) of the frame with a ``cudaMemsetAsync`` of the tail;
- K12's floors with the seeded 480x270 watermark at location 6 of the
  1080p grid and of 1366x768 in its 1376-wide grid: the region's
  16-byte pieces read and written back in place (as if its rows started
  on 16 bytes) and the RGBA image's read, 4 or 1 pieces a thread (plain
  and streaming stores);
- K17's floors: both bands read by 16-byte pieces and ORed, 4 or 1
  pairs a thread, for the whole 1088-row grid and bands of 16 and 4 MB
  rows of 1920 pixels;
- K8's phases: an instrumented copy of ``csrc/jpeg_events.cu`` (and of
  ``--k8-source``, e.g. an earlier revision's) with ``clock64`` marks at
  its phase boundaries, each mark waiting for the values the phase
  produced, run through ``ops.jpeg_entropy.jpeg_events`` at 1080p 4:2:0
  on K7's coefficients of a seeded frame (equal to the plain version,
  tolerance 0): the mean cycles a warp spends in each phase (lane 0),
  summed over the warp's scan blocks, beside the call's median time.
  Two designs are known by their text: a warp a scan block (the earlier
  design: LUT staging, map and coefficient loads, the scan, lane 0's DC
  predecessor, events, stores) and a block a tile of 32 scan blocks (the
  current one: LUT and map loads, coefficient and DC loads, the LUT
  barrier, events, stores).

Builds with the toolkit's ``nvcc`` into ``selkies_tpu_torch/_build/probe``
(git-ignored). Needs one card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from selkies_tpu_torch.ops import _cuda
from selkies_tpu_torch.ops import jpeg_entropy as JE
from selkies_tpu_torch.ops import jpeg_planes as JPL

OUT = _cuda.BUILD_ROOT / "probe"
SEED = 20261018

FLOOR_SRC = r"""
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>
__global__ void spin(long long n) {
  const long long t = clock64();
  while (clock64() - t < n) {}
}
__global__ void fill(uint8_t* a, size_t n) {
  for (size_t i = blockIdx.x * 256ull + threadIdx.x; i < n;
       i += 256ull * gridDim.x)
    a[i] = static_cast<uint8_t>((i * 2654435761ull) >> 13);
}
__global__ void empty_kernel(int* out) {
  if (threadIdx.x == 0 && blockIdx.x == 0) out[0] = 1;
}
// a 16-byte store, plain or streaming (evict-first, st.global.cs)
template <bool CS>
__device__ __forceinline__ void put(uint4* p, uint4 v) {
  if (CS) __stcs(p, v);
  else *p = v;
}
// K8's traffic: a thread reads a 16-byte piece of coefficients (8 of
// them) and writes two 16-byte payload pieces (one in each half of the
// payload array) and, in half the threads, a 16-byte piece of nbits;
// every store instruction covers whole sectors; 4 pieces a thread in
// flight
template <bool CS>
__global__ void __launch_bounds__(256) k8_floor(const uint4* coef, uint4* pay,
                                                uint4* nb, long long n) {
  for (long long q0 = blockIdx.x * 1024LL + threadIdx.x; q0 < n;
       q0 += 1024LL * gridDim.x) {
    uint4 v[4];
    for (int k = 0; k < 4; k++) {
      const long long q = q0 + 256 * k;
      v[k] = q < n ? coef[q] : make_uint4(0, 0, 0, 0);
    }
    for (int k = 0; k < 4; k++) {
      const long long q = q0 + 256 * k;
      if (q >= n) continue;
      const uint4 a = v[k];
      put<CS>(pay + q, a);
      put<CS>(pay + n + q, make_uint4(a.w, a.z ^ a.x, a.y, a.x));
      if (q < n / 2)
        put<CS>(nb + q, make_uint4(a.x & 0x1f1f1f1f, a.y & 0x1f1f1f1f,
                                   a.z & 0x1f1f1f1f, a.w & 0x1f1f1f1f));
    }
  }
}
// K11's traffic: the frame's pieces copied, the tail's zeroed, 4 pieces
// of 16 bytes a thread in flight
template <bool CS>
__global__ void __launch_bounds__(256) copy16(const uint4* src, uint4* dst,
                                              long long n_src, long long n) {
  for (long long q0 = blockIdx.x * 1024LL + threadIdx.x; q0 < n;
       q0 += 1024LL * gridDim.x) {
    uint4 v[4];
    for (int k = 0; k < 4; k++) {
      const long long q = q0 + 256 * k;
      v[k] = q < n_src ? src[q] : make_uint4(0, 0, 0, 0);
    }
    for (int k = 0; k < 4; k++)
      if (q0 + 256 * k < n) put<CS>(dst + q0 + 256 * k, v[k]);
  }
}
// K12's traffic: the region's 16-byte pieces read and written back in
// place (rows of rp pieces at a stride of `stride` bytes), the RGBA
// image's pieces read; U items a thread in flight
template <int U, bool CS>
__global__ void __launch_bounds__(256) k12_floor(uint8_t* region,
                                                 const uint4* rgba,
                                                 long long stride, int rp,
                                                 long long n_reg,
                                                 long long n, int* flag) {
  unsigned acc = 0;
  for (long long q0 = blockIdx.x * 256LL * U + threadIdx.x; q0 < n;
       q0 += 256LL * U * gridDim.x) {
    uint4 v[U];
    uint4* at[U];
#pragma unroll
    for (int k = 0; k < U; k++) {
      const long long q = q0 + 256 * k;
      at[k] = nullptr;
      v[k] = make_uint4(0, 0, 0, 0);
      if (q < n_reg) {
        at[k] = reinterpret_cast<uint4*>(region + (q / rp) * stride) + q % rp;
        v[k] = *at[k];
      } else if (q < n) {
        v[k] = rgba[q - n_reg];
      }
    }
#pragma unroll
    for (int k = 0; k < U; k++) {
      if (at[k]) put<CS>(at[k], v[k]);
      else acc |= v[k].x ^ v[k].y ^ v[k].z ^ v[k].w;
    }
  }
  if (acc == 0x9e3779b9u) *flag = 1;
}
// K17's traffic: both bands' 16-byte pieces read and ORed, U pairs a
// thread in flight
template <int U>
__global__ void __launch_bounds__(256) k17_floor(const uint4* a,
                                                 const uint4* b, long long n,
                                                 int* flag) {
  unsigned acc = 0;
  for (long long q0 = blockIdx.x * 256LL * U + threadIdx.x; q0 < n;
       q0 += 256LL * U * gridDim.x) {
    uint4 x[U], y[U];
#pragma unroll
    for (int k = 0; k < U; k++) {
      const long long q = q0 + 256 * k;
      x[k] = q < n ? a[q] : make_uint4(0, 0, 0, 0);
      y[k] = q < n ? b[q] : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < U; k++)
      acc |= (x[k].x ^ y[k].x) | (x[k].y ^ y[k].y) | (x[k].z ^ y[k].z) |
             (x[k].w ^ y[k].w);
  }
  if (acc == 0x9e3779b9u) *flag = 1;
}
int resident(const void* fn) {
  int per_sm = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, 256, 0);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  return per_sm * sms;
}
float timed(uint8_t* l2, cudaEvent_t e0, cudaEvent_t e1, int v,
            void (*run)(int)) {
  float t[20];
  for (int rep = 0; rep < 20; rep++) {
    cudaMemsetAsync(l2, 0, 64 << 20);
    spin<<<1, 1>>>(2000000);
    cudaEventRecord(e0);
    run(v);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    cudaEventElapsedTime(&t[rep], e0, e1);
  }
  for (int i = 0; i < 20; i++)
    for (int j = i + 1; j < 20; j++)
      if (t[j] < t[i]) { const float x = t[i]; t[i] = t[j]; t[j] = x; }
  return 0.5f * (t[9] + t[10]);
}
uint8_t *g_in, *g_out, *g_nb;
int* g_flag;
long long g_a, g_b;
int g_grid;
void run_empty(int) { empty_kernel<<<1, 32>>>(g_flag); }
void run_k8(int cs) {
  auto fn = cs ? k8_floor<true> : k8_floor<false>;
  fn<<<g_grid, 256>>>(reinterpret_cast<const uint4*>(g_in),
                      reinterpret_cast<uint4*>(g_out),
                      reinterpret_cast<uint4*>(g_nb), g_a);
}
void run_copy(int cs) {
  auto fn = cs ? copy16<true> : copy16<false>;
  fn<<<g_grid, 256>>>(reinterpret_cast<const uint4*>(g_in),
                      reinterpret_cast<uint4*>(g_out), g_a, g_b);
}
long long g_stride;
int g_rp;
template <int U>
void run_k12(int cs) {
  auto fn = cs ? k12_floor<U, true> : k12_floor<U, false>;
  fn<<<g_grid, 256>>>(g_out, reinterpret_cast<const uint4*>(g_in), g_stride,
                      g_rp, g_a, g_b, g_flag);
}
template <int U>
void run_k17(int) {
  k17_floor<U><<<g_grid, 256>>>(reinterpret_cast<const uint4*>(g_in),
                                reinterpret_cast<const uint4*>(g_out), g_a,
                                g_flag);
}
int grid_for(long long items, int per_thread, int res) {
  const long long want = (items + 256LL * per_thread - 1) /
                         (256LL * per_thread);
  return static_cast<int>(want < res ? want : res);
}
void run_memcpy(int) {
  cudaMemcpyAsync(g_out, g_in, 16 * g_a, cudaMemcpyDeviceToDevice);
  cudaMemsetAsync(g_out + 16 * g_a, 0, 16 * (g_b - g_a));
}
int main() {
  uint8_t* l2;
  const size_t big = 128ull << 20;
  cudaMalloc(&l2, 64 << 20);
  cudaMalloc(&g_in, big);
  cudaMalloc(&g_out, 4 * big);
  cudaMalloc(&g_nb, big);
  cudaMalloc(&g_flag, 4);
  fill<<<1024, 256>>>(g_in, big);
  cudaDeviceSynchronize();
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  printf("empty kernel|%.4f\n", timed(l2, e0, e1, 0, run_empty));
  const int r8 = resident(reinterpret_cast<const void*>(k8_floor<false>));
  const char* k8_names[] = {"1080p 4:2:0", "1080p 4:4:4", "4 seats"};
  const long long k8_blocks[] = {48960, 97920, 195840};
  for (int c = 0; c < 3; c++) {
    g_a = k8_blocks[c] * 8;                    // 16-byte coefficient pieces
    const long long want = (g_a + 1023) / 1024;
    g_grid = static_cast<int>(want < r8 ? want : r8);
    printf("K8 floor %s|%.4f\n", k8_names[c], timed(l2, e0, e1, 0, run_k8));
    printf("K8 floor %s, streaming stores|%.4f\n", k8_names[c],
           timed(l2, e0, e1, 1, run_k8));
  }
  const int rc = resident(reinterpret_cast<const void*>(copy16<false>));
  const char* pad_names[] = {"1080p", "2160p", "1366x768"};
  // h, H, w, W: the frame's bytes read and the grid's written as one run
  const long long rows[][4] = {{1080, 1088, 1920, 1920},
                               {2160, 2176, 3840, 3840},
                               {768, 768, 1366, 1376}};
  for (int c = 0; c < 3; c++) {
    g_a = rows[c][0] * rows[c][2] * 3 / 16;
    g_b = rows[c][1] * rows[c][3] * 3 / 16;
    const long long want = (g_b + 1023) / 1024;
    g_grid = static_cast<int>(want < rc ? want : rc);
    printf("K11 floor %s copy kernel|%.4f\n", pad_names[c],
           timed(l2, e0, e1, 0, run_copy));
    printf("K11 floor %s copy kernel, streaming stores|%.4f\n",
           pad_names[c], timed(l2, e0, e1, 1, run_copy));
    printf("K11 floor %s memcpy + memset|%.4f\n", pad_names[c],
           timed(l2, e0, e1, 0, run_memcpy));
  }
  // K12: the seeded 480x270 watermark at location 6 of the 1080p grid
  // and of 1366x768 in its 1376-wide grid (region rows of 90 pieces; the
  // floor takes them 16-byte aligned), its RGBA image read
  const char* k12_names[] = {"1080p", "1366x768"};
  const long long k12_stride[] = {1920 * 3, 1376 * 3};
  for (int c = 0; c < 2; c++) {
    g_stride = k12_stride[c];
    g_rp = 90;
    g_a = 270LL * 90;                          // region pieces
    g_b = g_a + 270LL * 480 * 4 / 16;          // and the RGBA image's
    for (int cs = 0; cs < 2; cs++) {
      g_grid = grid_for(g_b, 4, resident(reinterpret_cast<const void*>(
                                    k12_floor<4, false>)));
      printf("K12 floor %s, 4 pieces a thread%s|%.4f\n", k12_names[c],
             cs ? ", streaming stores" : "", timed(l2, e0, e1, cs,
                                                    run_k12<4>));
      g_grid = grid_for(g_b, 1, resident(reinterpret_cast<const void*>(
                                    k12_floor<1, false>)));
      printf("K12 floor %s, 1 piece a thread%s|%.4f\n", k12_names[c],
             cs ? ", streaming stores" : "", timed(l2, e0, e1, cs,
                                                    run_k12<1>));
    }
  }
  // K17: both bands read, the whole 1088-row grid and bands of 16 and 4
  // MB rows of 1920 pixels
  const char* k17_names[] = {"1080p", "band16", "band4"};
  const long long k17_rows[] = {1088, 256, 64};
  for (int c = 0; c < 3; c++) {
    g_a = k17_rows[c] * 1920 * 3 / 16;
    g_grid = grid_for(g_a, 4, resident(reinterpret_cast<const void*>(
                                  k17_floor<4>)));
    printf("K17 floor %s, 4 pairs a thread|%.4f\n", k17_names[c],
           timed(l2, e0, e1, 0, run_k17<4>));
    g_grid = grid_for(g_a, 1, resident(reinterpret_cast<const void*>(
                                  k17_floor<1>)));
    printf("K17 floor %s, 1 pair a thread|%.4f\n", k17_names[c],
           timed(l2, e0, e1, 0, run_k17<1>));
  }
  return cudaGetLastError() != cudaSuccess;
}
"""

# K8's phase marks: each phase accumulates the cycles since the previous
# mark, after waiting for ``dep`` (so a load's latency falls in the phase
# that issued it)
STAMP_DEFS = r"""
__device__ unsigned long long k8p_sum[8];
__device__ unsigned long long k8p_warps;
#define K8P_BEGIN long long k8p_t = clock64(); \
  long long k8p_acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#define K8P(k, dep) { asm volatile("" :: "r"(static_cast<int>(dep))); \
  const long long k8p_n = clock64(); k8p_acc[k] += k8p_n - k8p_t; \
  k8p_t = k8p_n; }
#define K8P_END if ((threadIdx.x & 31) == 0) { \
  for (int q = 0; q < 8; q++) \
    atomicAdd(&k8p_sum[q], static_cast<unsigned long long>(k8p_acc[q])); \
  atomicAdd(&k8p_warps, 1ull); }
"""
READ_SRC = r"""
extern "C" int k8p_zero() {
  void* p;
  cudaGetSymbolAddress(&p, k8p_sum);
  cudaMemset(p, 0, sizeof(k8p_sum));
  cudaGetSymbolAddress(&p, k8p_warps);
  cudaMemset(p, 0, sizeof(k8p_warps));
  return static_cast<int>(cudaDeviceSynchronize());
}
extern "C" int k8p_read(unsigned long long* sums) {
  cudaMemcpyFromSymbol(sums, k8p_sum, sizeof(k8p_sum));
  cudaMemcpyFromSymbol(sums + 8, k8p_warps, sizeof(k8p_warps));
  return static_cast<int>(cudaGetLastError());
}
"""

# (design, phase names, [(text, mark)]): each mark goes right after its
# text, in order
TILE_DESIGN = ("tile", ("LUT and map loads", "coefficient and DC loads",
                        "LUT barrier", "events", "stores"), (
    ("  const int tid = threadIdx.x, b = tid / K8_LANES, j = tid % K8_LANES;\n",
     "K8P_BEGIN"),
    ("      tile = t;\n    }\n", "K8P(0, ch)"),
    ("          aux_on ? __ldg(aux + static_cast<long long>(s) * aux_step)"
     " : 0;\n",
     "K8P(1, w.x ^ w.w ^ dc_prev)"),
    ("        lut_ready = true;\n      }\n", "K8P(2, 0)"),
    ("      slot_events(w, j, ch, dc_prev, lut, ezrl, eeob, pay, nb);\n",
     "K8P(3, pay[0] ^ nb[0])"),
    ("make_uint2(nb[0], nb[1]);\n      }\n", "K8P(4, 0)"),
    ("    item = t * S + s_end;\n  }\n", "K8P_END"),
))
WARP_DESIGN = ("warp", ("LUT staging", "map and coefficient loads", "scan",
                        "DC predecessor", "events", "stores"), (
    ("  __shared__ int ac_lut[2][256];\n", "K8P_BEGIN"),
    ("    dc_lut[k >> 4][k & 15] = K_JPEG_DC[k];\n  __syncthreads();\n",
     "K8P(0, 0)"),
    ("    const int2 pair = make_int2(row[2 * lane], row[2 * lane + 1]);\n",
     "K8P(1, pair.x ^ pair.y)"),
    ("    const int last_nz = __shfl_sync(0xffffffffu, incl, 31);\n",
     "K8P(2, last_nz)"),
    ("        const int dcdiff = v - (ps >= 0 ? row_of(ps)[0] : 0);\n",
     "K8P(3, dcdiff)"),
    ("    const size_t base = static_cast<size_t>(gb) * 64;\n",
     "K8P(4, out_pay[0] ^ out_pay[1])"),
    ("                   static_cast<uint8_t>(out_nb[1]));\n", "K8P(5, 0)"),
    ("K8P(5, 0);\n  }\n", "K8P_END"),
))


def nvcc(*args) -> None:
    r = subprocess.run([_cuda._nvcc(), *_cuda.ARCH, "-std=c++17", "-O3",
                        "-fmad=false", *args], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(r.stdout + r.stderr)


def stamped(src: str):
    """The source with its marks, the design's name and its phases."""
    for name, phases, marks in (TILE_DESIGN, WARP_DESIGN):
        if all(src.count(text) == 1 for text, _ in marks[:-1]):
            break
    else:
        raise RuntimeError("floor_probe: no known K8 design in the source")
    src = src.replace('#include "jpeg_tables.cuh"\n',
                      '#include "jpeg_tables.cuh"\n' + STAMP_DEFS, 1)
    for text, mark in marks:
        at = src.index(text) + len(text)
        src = src[:at] + mark + ";\n" + src[at:]
    return src, name, phases


def build_k8(source: Path, tag: str):
    src, design, phases = stamped(source.read_text())
    cu = OUT / f"k8_{tag}.cu"
    cu.write_text(src + READ_SRC)
    so = OUT / f"libk8_{tag}.so"
    nvcc("-Xcompiler", "-fPIC", "-shared", "-I", str(_cuda.CSRC), "-o",
         str(so), str(cu), str(_cuda.CSRC / "errors.cu"))
    return so, design, phases


def k8_inputs():
    """K7's coefficients (quality 60) of a seeded 1080p frame: noise over
    the top half, flat and gradient panels below; the 4:2:0 scan map."""
    rng = np.random.default_rng(SEED)
    H, W, sh = 1088, 1920, 64
    f = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    f[H // 2:, : W // 2] = (200, 30, 90)
    f[H // 2:, W // 2:] = np.linspace(0, 255, W - W // 2,
                                      dtype=np.uint8)[None, :, None]
    frame = torch.as_tensor(f, device="cuda")
    from selkies_tpu_torch.codecs import jpeg as jtab
    qt = torch.as_tensor(np.stack([jtab.scale_qtable(b, 60) for b in (
        jtab.STD_LUMA_QUANT, jtab.STD_CHROMA_QUANT)] * 2).astype(np.float32),
        device="cuda")
    S = H // sh
    tab = torch.zeros((S,), dtype=torch.int32, device="cuda")
    planes = JPL.jpeg_forward(frame, torch.zeros_like(frame), tab, qt, "420")
    scan = JE.scan_maps(JE.scan_layout(sh // 8, W // 8, "420"), "cuda")
    return planes, scan, S


def k8_phases(so: Path, design: str, phases) -> None:
    lib = ctypes.CDLL(str(so))
    fn = lib.jpeg_events
    fn.argtypes = _cuda.ENTRIES["jpeg_events"] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.k8p_read.argtypes = [ctypes.c_void_p]
    planes, scan, S = k8_inputs()
    want = JE.jpeg_events_plain(*planes, scan, S)
    saved = _cuda._fns.get("jpeg_events")
    _cuda._fns["jpeg_events"] = fn
    try:
        got = JE.jpeg_events(*planes, scan, S)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise RuntimeError(f"the {design} design's stamped K8 differs "
                               "from plain")
        l2 = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        times = []
        for rep in range(20):
            if rep == 19 and lib.k8p_zero():
                raise RuntimeError("floor_probe: clearing the marks failed")
            l2.zero_()
            torch.cuda._sleep(2_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            JE.jpeg_events(*planes, scan, S)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        sums = np.zeros(9, np.uint64)
        lib.k8p_read(sums.ctypes.data)
    finally:
        if saved is None:
            _cuda._fns.pop("jpeg_events")
        else:
            _cuda._fns["jpeg_events"] = saved
    warps = max(int(sums[8]), 1)
    per = [int(sums[k]) / warps for k in range(len(phases))]
    print(f"K8 phases, {design} design, 1080p 4:2:0 ({S} stripes of "
          f"{scan.shape[1]} scan blocks; mean cycles a warp, lane 0, over "
          f"{warps} warps of the last of 20 calls): "
          + ", ".join(f"{p} {c:.0f}" for p, c in zip(phases, per))
          + f"; total {sum(per):.0f}; event time "
          f"{statistics.median(times) * 1e3:.2f} us (median of 20 after "
          "an L2 flush; the marks slow it)")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k8-source", type=Path, default=None,
                    help="an earlier jpeg_events.cu to stamp as well")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("floor_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "floor.cu").write_text(FLOOR_SRC)
    sources = [(_cuda.CSRC / "jpeg_events.cu", "now")]
    if args.k8_source is not None:
        sources.append((args.k8_source, "earlier"))
    with ThreadPoolExecutor(len(sources) + 2) as pool:
        floor = pool.submit(nvcc, "-o", str(OUT / "floor"),
                            str(OUT / "floor.cu"))
        port = pool.submit(_cuda.build)
        k8s = [pool.submit(build_k8, p, tag) for p, tag in sources]
        floor.result()
        port.result()
        k8s = [f.result() for f in k8s]
    r = subprocess.run([str(OUT / "floor")], capture_output=True, text=True,
                       timeout=300)
    if r.returncode:
        raise RuntimeError(f"floor failed: {r.stdout}{r.stderr}")
    print("floors, ms (median of 20 after a 64 MB zero fill, the enqueue "
          "hidden): " + ", ".join(f"{name} {float(ms):.4f}" for name, ms in
                                  (ln.split("|") for ln in
                                   r.stdout.splitlines())))
    for so, design, phases in k8s:
        k8_phases(so, design, phases)
    return 0


if __name__ == "__main__":
    sys.exit(main())
