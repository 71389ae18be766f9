// K1 csc420_damage: RGB -> Y/U/V 4:2:0 (BT.601 full range), per-stripe
// damage flags, and the damage reference updated in place.
//
// Replaces selkies_tpu/ops/colorspace.py:rgb_to_ycbcr +
// selkies_tpu/ops/h264_planes.py:rgb_to_yuv420, and the damage compare /
// prev_out copy of selkies_tpu/engine/h264_encoder.py:build_h264_step_fn.
//
// Bound on the H100: bytes. It must read the frame and prev (2 x 6.27 MB
// at 1920x1088) and write Y, U and V (3.13 MB) and the pieces of prev
// that differ; the arithmetic is ~30 instructions a pixel (~2 us of issue
// over the card at 1080p).
// Design: a thread owns 16 pixels of one row of a row pair, its partner
// (the neighbouring lane) the same 16 of the other row. It reads them as
// three 16-byte vectors of the frame and three of prev, stores back only
// the prev vectors that differ (prev ends equal to the frame either way),
// computes its 16 Y (one 16-byte store) and the horizontal pair sums of
// Cb and Cr in registers, and trades one of them with its partner by
// shuffle: the top row's thread stores the 8 U of the pair (8 bytes), the
// bottom row's the 8 V. A stripe takes as many blocks of 128 threads as
// its rows need, so a one-stripe band (the band step's views, up to the
// whole frame) spreads over the card like a full frame. Each block ORs its
// damage with __syncthreads_or and adds it to the stripe's ticket with one
// 64-bit atomic (blocks done in the low word, damaged blocks in the high
// word); the add returns the counts of the blocks before it, so the last
// block knows the flag without any other memory being ordered, stores it
// with a plain store and puts the ticket back to 0: a launch is one device
// operation (no memset). The tickets live in device memory of this
// module, so launches are put in one order across streams: a launch on
// another stream than the one before waits for the event that one
// recorded. Rows that are not 16-byte aligned (W % 16, or a base off 16
// bytes) take a second instantiation the host picks, with byte loads and
// stores. Float order: see csc_rows.cuh; the chroma mean is
// ((a00 + a01) + (a10 + a11)) * 0.25, then rintf (half-even) and clamp.
#include "csc_rows.cuh"
#include "launch_order.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxStripes = 1 << 16;   // stripes a launch at most
constexpr int kMaxBlocks = 1 << 20;    // blocks a stripe at most

// a ticket a stripe, 0 between launches: the blocks that finished (low
// 32 bits) and those of them that found damage (high 32 bits)
__device__ unsigned long long k1_ticket[kMaxStripes];

// a row of 16 pixels (12 words): Y into 4 words, the pair sums
// a[2k] + a[2k+1] of Cb and Cr
__device__ __forceinline__ void row16(const unsigned (&w)[12],
                                      unsigned (&yw)[4], float (&hcb)[8],
                                      float (&hcr)[8]) {
  unsigned yb[16];
#pragma unroll
  for (int k = 0; k < 8; k++) {
    float r0, g0, b0, r1, g1, b1;
    run_rgb(w, 2 * k, r0, g0, b0);
    run_rgb(w, 2 * k + 1, r1, g1, b1);
    yb[2 * k] = u8_bits(csc_y(r0, g0, b0));
    yb[2 * k + 1] = u8_bits(csc_y(r1, g1, b1));
    hcb[k] = __fadd_rn(csc_cb(r0, g0, b0), csc_cb(r1, g1, b1));
    hcr[k] = __fadd_rn(csc_cr(r0, g0, b0), csc_cr(r1, g1, b1));
  }
#pragma unroll
  for (int q = 0; q < 4; q++)
    yw[q] = pack4(yb[4 * q], yb[4 * q + 1], yb[4 * q + 2], yb[4 * q + 3]);
}

// the 16 pixels of row py from px0 (n of them valid, 16 on the vector
// path): prev updated, Y stored, the pair sums -> 1 where prev differed
template <bool VEC>
__device__ __forceinline__ int row_run(const uint8_t* __restrict__ frame,
                                       uint8_t* __restrict__ prev,
                                       uint8_t* __restrict__ y, int W, int py,
                                       int px0, int n, float (&hcb)[8],
                                       float (&hcr)[8]) {
  const size_t o = (static_cast<size_t>(py) * W + px0) * 3;
  unsigned w[12];
  int diff = 0;
  if (VEC) {
    load_run<16>(frame + o, w);
    uint4 p[3];
#pragma unroll
    for (int k = 0; k < 3; k++)
      p[k] = reinterpret_cast<const uint4*>(prev + o)[k];
#pragma unroll
    for (int k = 0; k < 3; k++) {
      const uint4 f = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2],
                                 w[4 * k + 3]);
      if ((f.x ^ p[k].x) | (f.y ^ p[k].y) | (f.z ^ p[k].z) | (f.w ^ p[k].w)) {
        reinterpret_cast<uint4*>(prev + o)[k] = f;
        diff = 1;
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < 12; q++) w[q] = 0u;
#pragma unroll
    for (int b = 0; b < 48; b++) {
      if (b < 3 * n) {
        const uint8_t f = frame[o + b];
        if (f != prev[o + b]) {
          prev[o + b] = f;
          diff = 1;
        }
        w[b >> 2] |= static_cast<unsigned>(f) << (8 * (b & 3));
      }
    }
  }
  unsigned yw[4];
  row16(w, yw, hcb, hcr);
  uint8_t* yr = y + static_cast<size_t>(py) * W + px0;
  if (VEC) {
    *reinterpret_cast<uint4*>(yr) = make_uint4(yw[0], yw[1], yw[2], yw[3]);
  } else {
#pragma unroll
    for (int p = 0; p < 16; p++)
      if (p < n) yr[p] = static_cast<uint8_t>(yw[p >> 2] >> (8 * (p & 3)));
  }
  return diff;
}

// grid: S stripes x P blocks; a stripe's 2 * (stripe_h / 2) * ceil(W / 16)
// runs, a thread each (a block loops where a stripe has more runs than its
// P blocks have threads); run i is row i & 1 of a row pair, so the two
// rows of a pair are neighbouring lanes
template <bool VEC>
__global__ void __launch_bounds__(kThreads, 4)
csc420_damage_kernel(const uint8_t* __restrict__ frame,
                     uint8_t* __restrict__ prev, uint8_t* __restrict__ y,
                     uint8_t* __restrict__ u, uint8_t* __restrict__ v,
                     int* __restrict__ damage, int W, int stripe_h, int P) {
  const int s = blockIdx.x / P, rank = blockIdx.x - s * P;
  const int per_row = (W + 15) / 16;
  const int runs = stripe_h * per_row;
  int diff = 0;
  for (int i0 = rank * kThreads; i0 < runs; i0 += P * kThreads) {
    const int i = i0 + threadIdx.x;
    const bool ok = i < runs;         // even runs: a pair is valid together
    const int pair = i >> 1, bottom = i & 1;
    const int rp = pair / per_row, c = pair - rp * per_row;
    const int py = s * stripe_h + 2 * rp;
    const int px0 = 16 * c, n = VEC ? 16 : min(16, W - px0);
    float hb[8], hr[8];
    if (ok) {
      diff |= row_run<VEC>(frame, prev, y, W, py + bottom, px0, n, hb, hr);
    } else {
#pragma unroll
      for (int k = 0; k < 8; k++) hb[k] = hr[k] = 0.0f;
    }
    // ((a00 + a01) + (a10 + a11)) * 0.25: the top row stores U, the
    // bottom row V, each with the other's pair sums
    unsigned c8[8];
#pragma unroll
    for (int k = 0; k < 8; k++) {
      const float o = __shfl_xor_sync(0xffffffffu, bottom ? hb[k] : hr[k], 1);
      c8[k] = u8_bits(__fmul_rn(bottom ? __fadd_rn(o, hr[k])
                                       : __fadd_rn(hb[k], o), 0.25f));
    }
    if (ok) {
      uint8_t* dst = (bottom ? v : u) + static_cast<size_t>(py / 2) * (W / 2)
                     + px0 / 2;
      if (VEC) {
        *reinterpret_cast<uint2*>(dst) =
            make_uint2(pack4(c8[0], c8[1], c8[2], c8[3]),
                       pack4(c8[4], c8[5], c8[6], c8[7]));
      } else {
#pragma unroll
        for (int k = 0; k < 8; k++)
          if (2 * k < n) dst[k] = static_cast<uint8_t>(c8[k]);
      }
    }
  }
  ticket_flag(&k1_ticket[s], &damage[s], P, diff);
}

LaunchOrder order;                     // K1's launches across streams

}  // namespace

extern "C" int csc420_damage(const uint8_t* frame, uint8_t* prev, uint8_t* y,
                             uint8_t* u, uint8_t* v, int* damage, int H, int W,
                             int stripe_h, void* stream) {
  if (H <= 0 || W <= 0 || W % 2 || stripe_h <= 0 || stripe_h % 2
      || H % stripe_h || H / stripe_h > kMaxStripes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int S = H / stripe_h;
  const bool vec = W % 16 == 0 && aligned_to(frame, 16)
                   && aligned_to(prev, 16) && aligned_to(y, 16)
                   && aligned_to(u, 8) && aligned_to(v, 8);
  // blocks a stripe: a run (16 pixels of a row) a thread (the blocks
  // loop past kMaxBlocks)
  const long long runs = static_cast<long long>(stripe_h) * ((W + 15) / 16);
  long long P = (runs + kThreads - 1) / kThreads;
  if (P > kMaxBlocks) P = kMaxBlocks;
  if (P * S > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  std::lock_guard<std::mutex> hold(order.lock);
  int dev = 0;
  const cudaError_t oe = order_before(order, st, &dev);
  if (oe != cudaSuccess) return static_cast<int>(oe);
  const dim3 grid(static_cast<unsigned>(S * P));
  if (vec)
    csc420_damage_kernel<true><<<grid, kThreads, 0, st>>>(
        frame, prev, y, u, v, damage, W, stripe_h, static_cast<int>(P));
  else
    csc420_damage_kernel<false><<<grid, kThreads, 0, st>>>(
        frame, prev, y, u, v, damage, W, stripe_h, static_cast<int>(P));
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) order_after(order, st, dev);
  return static_cast<int>(e);
}
