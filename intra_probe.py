"""Where the Intra16x16 coders K2-I (``csrc/mb_encode.cu``, the
``mb_encode_i`` entry) and K14 (``csrc/mb_encode444.cu``, the
``mb_encode_i444`` entry) spend their time, on one NVIDIA card.

    python3 intra_probe.py [--fullcolor] [--source PATH]

Compiles an instrumented copy of ``csrc/mb_encode.cu`` (with
``--fullcolor``: ``csrc/mb_encode444.cu``), or of the copy at
``--source`` (e.g. an earlier revision's, with that revision's headers
beside it where they differ from this tree's), that stamps ``clock64`` and
``%globaltimer`` at the kernel's phase boundaries, runs it at 1080p
(grid 1920x1088: 68 MB rows of 120 MBs, qp mixed by row, every other
stripe sent) and on 4 stacked seats (272 MB rows), each equal to the
plain version (tolerance 0), and prints a line a shape: the median
cycles of each phase and the spans on ``%globaltimer`` of the last of
20 calls timed between CUDA events after an L2 flush, beside their
median time.

Two designs of each are known by their text:

- one block a row (the earlier design): phase 1 (AC levels, raw DC terms,
  right-edge inverses, the row's MBs over the block's warps), phase 2
  (the DC / left-edge chains, a warp walking the row), phase 3 (the
  transform again and the recon);
- three grids (the current design): the records, the chains (a block a row:
  the records loaded, then each chain stamped: K2-I's luma and chroma,
  K14's Y, Cb and Cr; cycles an MB = chain / 120) and the coding; each
  grid's span on %globaltimer from the first stamp. The chains also run
  alone (one block on an idle card, their records in place): the chain
  floor, 120 steps times the slowest chain's cycles a step, in ms at the
  card's maximum SM clock.

Builds with the toolkit's ``nvcc`` into ``selkies_tpu_torch/_build/probe``
(git-ignored). Needs one card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from selkies_tpu_torch.ops import _cuda
from selkies_tpu_torch.ops import h264_planes as HP
from selkies_tpu_torch.ops import h264_planes444 as H4

OUT = _cuda.BUILD_ROOT / "probe"
SEED = 20261017

STAMP_DEFS = r"""
__device__ unsigned long long ip_t[3][1 << 16][6];
__device__ unsigned long long ip_g[3][1 << 16][2];
// stamp x of grid k (0 for a one-grid design) by thread ``tid`` of the
// block: clock64, and %globaltimer at the first (x 0) and last stamps
__device__ __forceinline__ void ip_stamp(int k, int x, int tid = 0) {
  if (threadIdx.x != tid) return;
  const int b = blockIdx.y * gridDim.x + blockIdx.x;
  ip_t[k][b][x] = clock64();
  unsigned long long g;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
  if (x == 0) ip_g[k][b][0] = g;
  else ip_g[k][b][1] = g;
}
"""
# the chains of csrc/mb_encode.cu alone: one block on an otherwise idle
# card, records of plausible values already in shared memory, every tile
# ready; cycles of the luma and the chroma chain over a row of M MBs
ALONE_SRC = r"""
#include <cstdio>
#include "mb_encode.cu"
__global__ void chain_alone(int M, long long* cyc, unsigned* sink) {
  extern __shared__ int4 dyn4[];
  int* dyn = reinterpret_cast<int*>(dyn4);
  int* out = dyn + I_REC * M;
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(out + HDR_SLOTS * M);
  if (threadIdx.x == 0)
    for (int g = 0; g < (M + I_GROUP - 1) / I_GROUP; g++) {
      mbar_init(bars + g, 1);
      mbar_arrive(bars + g);
    }
  for (int i = threadIdx.x; i < I_REC * M; i += blockDim.x)
    dyn[i] = static_cast<int>(((i + 1) * 2654435761u) % 16000u);
  for (int i = threadIdx.x; i < HDR_SLOTS * M; i += blockDim.x) out[i] = 0;
  __syncthreads();
  const QuantDC qy = quant_dc_consts(26, true);
  const QuantDC qc = quant_dc_consts(29, false);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long t0 = clock64();
  if (warp == 0 && lane < 16)
    luma_chain(dyn, bars, M, out, lane, qy);
  else if (warp == 1 && lane < 2)
    chroma_chain(dyn, bars, M, out, lane, qc);
  const long long t1 = clock64();
  if (lane == 0 && warp < 2) cyc[warp] = t1 - t0;
  __syncthreads();
  sink[threadIdx.x] = static_cast<unsigned>(out[threadIdx.x]);
}
int main() {
  const int M = 120;
  long long* cyc;
  unsigned* sink;
  cudaMalloc(&cyc, 2 * sizeof(long long));
  cudaMalloc(&sink, 96 * sizeof(unsigned));
  const int smem = 4 * (I_REC + HDR_SLOTS) * M + 8 * M;
  for (int rep = 0; rep < 3; rep++)
    chain_alone<<<1, 96, smem>>>(M, cyc, sink);
  long long c[2];
  cudaMemcpy(c, cyc, sizeof c, cudaMemcpyDeviceToHost);
  printf("%lld %lld\n", c[0], c[1]);
  return cudaGetLastError() != cudaSuccess;
}
"""
# K14's three chains alone, as ALONE_SRC: cycles of the Y, Cb and Cr
# chain over a row of M MBs
ALONE444_SRC = r"""
#include <cstdio>
#include "mb_encode444.cu"
__global__ void chain_alone(int M, long long* cyc, unsigned* sink) {
  extern __shared__ int4 dyn4[];
  int* dyn = reinterpret_cast<int*>(dyn4);
  int* out = dyn + I4_REC * M;
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(out + HDR_SLOTS * M);
  if (threadIdx.x == 0)
    for (int g = 0; g < (M + I_GROUP - 1) / I_GROUP; g++) {
      mbar_init(bars + g, 1);
      mbar_arrive(bars + g);
    }
  for (int i = threadIdx.x; i < I4_REC * M; i += blockDim.x)
    dyn[i] = static_cast<int>(((i + 1) * 2654435761u) % 16000u);
  for (int i = threadIdx.x; i < HDR_SLOTS * M; i += blockDim.x) out[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, c = threadIdx.x >> 5;
  const QuantDC q = quant_dc_consts(c ? 29 : 26, true);
  const long long t0 = clock64();
  if (c < 3 && lane < 16) comp_chain(dyn, bars, M, out, c, lane, q);
  const long long t1 = clock64();
  if (lane == 0 && c < 3) cyc[c] = t1 - t0;
  __syncthreads();
  sink[threadIdx.x] = static_cast<unsigned>(out[threadIdx.x]);
}
int main() {
  const int M = 120;
  long long* cyc;
  unsigned* sink;
  cudaMalloc(&cyc, 3 * sizeof(long long));
  cudaMalloc(&sink, 128 * sizeof(unsigned));
  const int smem = 4 * (I4_REC + HDR_SLOTS) * M + 8 * M;
  for (int rep = 0; rep < 3; rep++)
    chain_alone<<<1, 128, smem>>>(M, cyc, sink);
  long long c[3];
  cudaMemcpy(c, cyc, sizeof c, cudaMemcpyDeviceToHost);
  printf("%lld %lld %lld\n", c[0], c[1], c[2]);
  return cudaGetLastError() != cudaSuccess;
}
"""
READ_SRC = r"""
extern "C" int ip_zero() {
  void* p;
  cudaGetSymbolAddress(&p, ip_g);
  cudaMemset(p, 0, sizeof(ip_g));
  cudaGetSymbolAddress(&p, ip_t);
  cudaMemset(p, 0, sizeof(ip_t));
  return static_cast<int>(cudaDeviceSynchronize());
}
extern "C" int ip_read(unsigned long long* t, unsigned long long* g) {
  cudaMemcpyFromSymbol(t, ip_t, sizeof(ip_t));
  cudaMemcpyFromSymbol(g, ip_g, sizeof(ip_g));
  return static_cast<int>(cudaGetLastError());
}
"""

# (text, stamp, where): the stamp goes after the text, before it, or
# (after_sync) after the text behind a block barrier
ROW_DESIGN = (
    ("  int16_t* lv_row = lv + static_cast<size_t>(r) * M * N_BLOCKS * 16;\n",
     "0, 0", "after"),
    ("  // ---- phase 2: the DC / left-edge chain", "0, 1", "before"),
    ("  // ---- phase 3: recon into the reference planes", "0, 2", "before"),
    ("      for (int k = 3; k < HDR_SLOTS; k++) { hp[k] = 0; hn[k] = 0; }\n"
     "    }\n  }\n", "0, 3", "after_sync"),
)
GRIDS_DESIGN = (
    ("  const int r = blockIdx.y, j = lane & 3;\n", "0, 0", "after"),
    ("      reinterpret_cast<int2*>(base + 8)[by] = make_int2(a, l);\n    }\n"
     "  }\n", "0, 1", "after"),
    ("  const int r = blockIdx.x, t = threadIdx.x;\n", "1, 0", "after"),
    ("  const int lane = t & 31;\n  if (t < 16) {\n", "1, 1",
     "before"),
    ("    luma_chain(rec, bars, M, out, lane, quant_dc_consts(qp, true));\n",
     "1, 2", "after_any"),
    ("    chroma_chain(rec, bars, M, out, lane, quant_dc_consts(qpc, false));"
     "\n",
     "1, 3, 32", "after_any"),
    ("  const int r = blockIdx.y, m0 = blockIdx.x * I_NB;\n", "2, 0",
     "after"),
    ("    hdr_nb[(g0 + hm) * HDR_SLOTS + k] = n;\n  }\n", "2, 1", "after"),
)

# the 4:4:4 designs (csrc/mb_encode444.cu)
ROW444_DESIGN = (
    ("  int16_t* lv_row = lv + static_cast<size_t>(r) * M * NB_I444 * 16;\n",
     "0, 0", "after"),
    ("  // ---- phase 2: one warp per component walks its DC / left-edge "
     "chain", "0, 1", "before"),
    ("  // ---- phase 3: recon into the reference planes, MB outputs", "0, 2",
     "before"),
    ("    for (int k = 2; k < HDR_SLOTS; k++) { hp[k] = 0; hn[k] = 0; }\n"
     "  }\n", "0, 3", "after_sync"),
)
GRIDS444_DESIGN = (
    ("  const int r = blockIdx.y, by = lane & 3, c = warp >> 1;\n", "0, 0",
     "after"),
    ("    if (by == 0) base[60 + c] = h[0] >> 1;\n  }\n", "0, 1", "after"),
    ("  const int r = blockIdx.x, t = threadIdx.x;\n", "1, 0", "after"),
    ("  const int c = t >> 5, lane = t & 31;\n  if (c < 3 && lane < 16)\n",
     "1, 1", "before"),
    ("               quant_dc_consts(c ? K_QPC[clampi(qp, 0, 51)] : qp, "
     "true));\n", "1, 2 + c, 32 * c", "after_any"),
    ("  const int r = blockIdx.y, m0 = blockIdx.x * I4_NB;\n", "2, 0",
     "after"),
    ("    cbp_out[g0 + hm] = ac ? 15 : 0;\n  }\n", "2, 1", "after"),
)
#: per mode: its source, C entry, kernel and plain version, chroma
#: divisor, the chains' names, its designs and its chains-alone program
MODES = {
    "420": dict(source="mb_encode.cu", entry="mb_encode_i",
                kern=HP.mb_encode_i, plain=HP.mb_encode_i_plain, cdiv=2,
                chains=("luma", "chroma"), alone=ALONE_SRC,
                chain_fn="luma_chain(",
                designs=(("row", ROW_DESIGN), ("grids", GRIDS_DESIGN))),
    "444": dict(source="mb_encode444.cu", entry="mb_encode_i444",
                kern=H4.mb_encode_i444, plain=H4.mb_encode_i444_plain,
                cdiv=1, chains=("Y", "Cb", "Cr"), alone=ALONE444_SRC,
                chain_fn="comp_chain(",
                designs=(("row", ROW444_DESIGN), ("grids", GRIDS444_DESIGN))),
}


def nvcc(*args) -> None:
    r = subprocess.run([_cuda._nvcc(), *_cuda.ARCH, "-std=c++17", "-O3",
                        "-fmad=false", *args], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(r.stdout + r.stderr)


def includes(source: Path) -> tuple:
    """Headers from the source's own directory first (an earlier
    revision's copy with its headers beside it), then this tree's."""
    return ("-I", str(source.resolve().parent), "-I", str(_cuda.CSRC))


def stamped(src: str, mode: dict):
    """The source with its stamps, and the design's name."""
    for name, stamps in mode["designs"]:
        if all(src.count(text) == 1 for text, _, _ in stamps):
            break
    else:
        raise RuntimeError("intra_probe: no known design in the source")
    # the stamps' definitions after the last include
    at = src.index("\n", src.rindex("#include ")) + 1
    src = src[:at] + STAMP_DEFS + src[at:]
    for text, args, where in stamps:
        at = src.index(text)
        stamp = f"ip_stamp({args});\n"
        if where == "before":
            src = src[:at] + "  " + stamp + src[at:]
            continue
        at += len(text)
        if where == "after_sync":
            stamp = "  __syncthreads();\n  " + stamp
        elif where == "after_any":
            stamp = "    " + stamp
        else:
            stamp = "  " + stamp
        src = src[:at] + stamp + src[at:]
    return src, name


def max_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60).stdout
    return float(out.split()[0])


def chain_alone(source: Path, mode: dict) -> None:
    """The chains of ``source`` alone (one block, records in place), and
    the chain floor: 120 steps of the slowest chain at the maximum SM
    clock."""
    if mode["chain_fn"] not in source.read_text():
        return
    (OUT / mode["source"]).write_text(source.read_text())
    (OUT / "chain_alone.cu").write_text(mode["alone"])
    nvcc(*includes(source), "-o", str(OUT / "chain_alone"),
         str(OUT / "chain_alone.cu"))
    r = subprocess.run([str(OUT / "chain_alone")], capture_output=True,
                       text=True, timeout=120)
    if r.returncode:
        raise RuntimeError(f"chain_alone failed: {r.stdout}{r.stderr}")
    cyc = [int(v) for v in r.stdout.split()]
    each = ", ".join(f"{n} {c} cycles ({c / 120:.1f} an MB)"
                     for n, c in zip(mode["chains"], cyc))
    mhz = max_clock_mhz()
    print(f"chains alone (one block on an idle card, 120 MBs): {each}; "
          f"chain floor {max(cyc) / 120:.1f} cycles x 120 steps = "
          f"{max(cyc) / (mhz * 1e3):.4f} ms at the maximum SM clock "
          f"{mhz:.0f} MHz")


def library(source: Path, mode: dict):
    src, design = stamped(source.read_text(), mode)
    (OUT / "intra_stamped.cu").write_text(src + READ_SRC)
    so = OUT / f"libintra_{mode['entry']}_{design}.so"
    nvcc("-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v",
         *includes(source), "-o", str(so), str(OUT / "intra_stamped.cu"),
         str(_cuda.CSRC / "errors.cu"))
    lib = ctypes.CDLL(str(so))
    fn = getattr(lib, mode["entry"])
    fn.argtypes = _cuda.ENTRIES[mode["entry"]] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.ip_read.argtypes = [ctypes.c_void_p] * 2
    return lib, fn, design


def inputs(seats: int, cdiv: int):
    """1080p planes (a desktop-like mix of flat areas and noise; chroma
    H/cdiv x W/cdiv) stacked ``seats`` times, qp mixed by row, every other
    stripe sent."""
    rng = np.random.default_rng(SEED)
    H, W, rps = 1088, 1920, 4
    planes = []
    for h, w in ((H, W), (H // cdiv, W // cdiv), (H // cdiv, W // cdiv)):
        p = rng.integers(0, 256, (h, w), dtype=np.uint8)
        p[: h // 2, : w // 2] = 230
        planes.append(np.concatenate([p] * seats))
    y, u, v = (torch.as_tensor(p, device="cuda") for p in planes)
    R = seats * H // 16
    qp = torch.full((R,), 25, dtype=torch.int32, device="cuda")
    qp[::3] = 10
    S = R // rps
    send = (torch.arange(S, device="cuda") % 2 == 0).to(torch.int32)
    return (y, u, v), qp, send, rps


def run(lib, fn, design: str, seats: int, mode: dict) -> None:
    planes, qp, send, rps = inputs(seats, mode["cdiv"])
    R = qp.shape[0]
    entry, kern, plain = mode["entry"], mode["kern"], mode["plain"]
    zero = [torch.zeros_like(p) for p in planes]
    saved = _cuda._fns.get(entry)
    _cuda._fns[entry] = fn
    try:
        # a first call loads the kernels; the second is stamped
        kern(*planes, qp, send, rps, *[t.clone() for t in zero])
        if lib.ip_zero():
            raise RuntimeError("intra_probe: clearing the stamps failed")
        kref = [t.clone() for t in zero]
        out = kern(*planes, qp, send, rps, *kref)
        torch.cuda.synchronize()
        pref = [t_.clone() for t_ in zero]
        want = plain(*planes, qp, send, rps, *pref)
        if not all(torch.equal(a, b) for a, b in
                   zip(list(out) + kref, list(want) + pref)):
            raise RuntimeError(f"{design} at {seats} seat(s): stamped "
                               f"{entry} differs from plain")
        l2 = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        work = [t_.clone() for t_ in zero]
        times = []
        for _ in range(20):
            for w_, z in zip(work, zero):
                w_.copy_(z)
            l2.zero_()
            torch.cuda._sleep(2_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            kern(*planes, qp, send, rps, *work)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        # the stamps of the last timed call
        t = np.zeros((3, 1 << 16, 6), np.uint64)
        g = np.zeros((3, 1 << 16, 2), np.uint64)
        lib.ip_read(t.ctypes.data, g.ctypes.data)
    finally:
        if saved is None:
            _cuda._fns.pop(entry)
        else:
            _cuda._fns[entry] = saved
    head = f"phases {entry} {design} design, {seats} seat(s) ({R} MB rows): "
    tail = (f"; event time {np.median(times) * 1e3:.2f} us (median of 20 "
            "after an L2 flush)")
    t, g = t.astype(np.int64), g.astype(np.int64)
    if design == "row":
        used = g[0, :, 0] > 0
        d = np.median(np.diff(t[0, used, :4], axis=1), 0)
        span = (g[0, used, 1].max() - g[0, used, 0].min()) / 1e3
        print(head + f"{int(used.sum())} blocks; median cycles phase 1 "
              f"{d[0]:.0f}, phase 2 (chains) {d[1]:.0f}, phase 3 "
              f"{d[2]:.0f}; blocks' span {span:.2f} us" + tail)
        return
    spans = []
    for k in range(3):
        used = g[k, :, 0] > 0
        spans.append((g[k, used, 0].min(), g[k, used, 1].max()))
    t0 = spans[0][0]
    grids = ", ".join(f"{n} {(a - t0) / 1e3:.2f}-{(b - t0) / 1e3:.2f}"
                      for n, (a, b) in zip(("records", "chains", "coding"),
                                           spans))
    used = g[1, :, 0] > 0
    load = t[1, used, 1] - t[1, used, 0]
    M = 120
    chains = []
    for i, name in enumerate(mode["chains"]):
        c = t[1, used, 2 + i] - t[1, used, 1]
        chains.append(f"{name} chain {np.median(c):.0f} (max {c.max():.0f}, "
                      f"{np.median(c) / M:.1f} an MB)")
    print(head + f"grids (us from the first stamp): {grids}; the chain "
          f"grid: records in {np.median(load):.0f} cycles, "
          + ", ".join(chains) + tail)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fullcolor", action="store_true",
                    help="K14 (mb_encode_i444) instead of K2-I")
    ap.add_argument("--source", type=Path, default=None)
    args = ap.parse_args()
    mode = MODES["444" if args.fullcolor else "420"]
    source = args.source or _cuda.CSRC / mode["source"]
    if not torch.cuda.is_available():
        print("intra_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    OUT.mkdir(parents=True, exist_ok=True)
    _cuda._fn(mode["entry"])             # builds and loads the library
    chain_alone(source, mode)
    lib, fn, design = library(source, mode)
    for seats in (1, 4):
        run(lib, fn, design, seats, mode)
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                             "--format=csv,noheader"], capture_output=True,
                            text=True, timeout=60).stdout.strip()
    print(f"SM clock after the runs, and its maximum: {clocks}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
