// K13 csc444_damage: RGB -> three full-resolution Y/Cb/Cr planes (BT.601
// full range, the 4:4:4 ``fullcolor`` path), per-stripe damage flags, and
// the damage reference updated in place.
//
// Replaces selkies_tpu/ops/h264_planes444.py:rgb_to_yuv444 (with
// selkies_tpu/ops/colorspace.py:rgb_to_ycbcr), and the damage compare /
// prev_out copy of selkies_tpu/engine/h264_encoder.py:build_h264_step_fn
// and build_h264_band_step_fn at fullcolor.
//
// Bound on the H100: bytes. It must read the frame and prev (2 x 6.27 MB
// at 1920x1088) and write Y, U and V (3 x 2.09 MB) and the pieces of
// prev that differ; the arithmetic is ~30 instructions a pixel (~2 us of
// issue over the card at 1080p).
// Design: K1's (csrc/csc420_damage.cu) without the subsampling. A thread
// owns 16 pixels of one row: three 16-byte vectors of the frame and three
// of prev, of which it stores back only those that differ (prev ends
// equal to the frame either way), and its 16 Y, 16 Cb and 16 Cr as three
// 16-byte stores. A stripe takes as many blocks of 128 threads as its
// rows need, so a one-stripe band (the band step's views, up to the whole
// frame) spreads over the card like a full frame. Each stripe's flag
// comes from its ticket in this module's device memory
// (csrc/launch_order.cuh: the last block stores it and puts the ticket
// back to 0), so a launch is one device operation (no memset), and
// launches are put in one order across streams. Rows that are not
// 16-byte aligned (W % 16, or a base off 16 bytes) take a second
// instantiation the host picks, with byte loads and stores. Nothing is
// triggered early for a kernel launched behind it with programmatic
// dependent launch (K14's first grid, K15): the flags and the tickets'
// reset are done when it ends. Float order: csc_rows.cuh (the reference's
// CSC is the same XLA dot at 4:4:4 as at 4:2:0): Y and Cb as
// ((r*m0 + g*m1) + b*m2) + off, Cr as fma(b, m2, fma(g, m1, r*m0)) + off,
// then rintf (half-even) and clamp.
#include "csc_rows.cuh"
#include "launch_order.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxStripes = 1 << 16;   // stripes a launch at most
constexpr int kMaxBlocks = 1 << 20;    // blocks a stripe at most

// a ticket a stripe, 0 between launches (csrc/launch_order.cuh)
__device__ unsigned long long k13_ticket[kMaxStripes];

// grid: S stripes x P blocks; a stripe's stripe_h * ceil(W / 16) runs (16
// pixels of a row), a thread each (a block loops where a stripe has more
// runs than its P blocks have threads). At most 64 registers, so 8
// blocks an SM: the 1020 blocks of a 1080p frame are one wave (75
// registers, 6 blocks an SM, timed slower while this was designed).
template <bool VEC>
__global__ void __launch_bounds__(kThreads, 8)
csc444_damage_kernel(const uint8_t* __restrict__ frame,
                     uint8_t* __restrict__ prev, uint8_t* __restrict__ y,
                     uint8_t* __restrict__ u, uint8_t* __restrict__ v,
                     int* __restrict__ damage, int W, int stripe_h, int P) {
  const int s = blockIdx.x / P, rank = blockIdx.x - s * P;
  const int per_row = (W + 15) / 16;
  const int runs = stripe_h * per_row;
  int diff = 0;
  for (int i = rank * kThreads + threadIdx.x; i < runs;
       i += P * kThreads) {
    const int row = i / per_row, c = i - row * per_row;
    const int px0 = 16 * c, n = VEC ? 16 : min(16, W - px0);
    const size_t p = static_cast<size_t>(s * stripe_h + row) * W + px0;
    const size_t o = 3 * p;
    unsigned w[12];
    if (VEC) {
      load_run<16>(frame + o, w);
      uint4 q[3];
#pragma unroll
      for (int k = 0; k < 3; k++)
        q[k] = reinterpret_cast<const uint4*>(prev + o)[k];
#pragma unroll
      for (int k = 0; k < 3; k++) {
        const uint4 f = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2],
                                   w[4 * k + 3]);
        if ((f.x ^ q[k].x) | (f.y ^ q[k].y) | (f.z ^ q[k].z)
            | (f.w ^ q[k].w)) {
          reinterpret_cast<uint4*>(prev + o)[k] = f;
          diff = 1;
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < 12; k++) w[k] = 0u;
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
    // the 16 pixels' Y, Cb and Cr, four to a word
    unsigned yw[4], uw[4], vw[4];
#pragma unroll
    for (int k = 0; k < 4; k++) {
      unsigned yb[4], ub[4], vb[4];
#pragma unroll
      for (int j = 0; j < 4; j++) {
        float r, g, b;
        run_rgb(w, 4 * k + j, r, g, b);
        yb[j] = u8_bits(csc_y(r, g, b));
        ub[j] = u8_bits(csc_cb(r, g, b));
        vb[j] = u8_bits(csc_cr(r, g, b));
      }
      yw[k] = pack4(yb[0], yb[1], yb[2], yb[3]);
      uw[k] = pack4(ub[0], ub[1], ub[2], ub[3]);
      vw[k] = pack4(vb[0], vb[1], vb[2], vb[3]);
    }
    if (VEC) {
      *reinterpret_cast<uint4*>(y + p) = make_uint4(yw[0], yw[1], yw[2],
                                                    yw[3]);
      *reinterpret_cast<uint4*>(u + p) = make_uint4(uw[0], uw[1], uw[2],
                                                    uw[3]);
      *reinterpret_cast<uint4*>(v + p) = make_uint4(vw[0], vw[1], vw[2],
                                                    vw[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 16; k++) {
        if (k < n) {
          const int sh = 8 * (k & 3);
          y[p + k] = static_cast<uint8_t>(yw[k >> 2] >> sh);
          u[p + k] = static_cast<uint8_t>(uw[k >> 2] >> sh);
          v[p + k] = static_cast<uint8_t>(vw[k >> 2] >> sh);
        }
      }
    }
  }
  ticket_flag(&k13_ticket[s], &damage[s], P, diff);
}

LaunchOrder order;                     // K13's launches across streams

}  // namespace

extern "C" int csc444_damage(const uint8_t* frame, uint8_t* prev, uint8_t* y,
                             uint8_t* u, uint8_t* v, int* damage, int H, int W,
                             int stripe_h, void* stream) {
  if (H <= 0 || W <= 0 || stripe_h <= 0 || H % stripe_h
      || H / stripe_h > kMaxStripes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int S = H / stripe_h;
  const bool vec = W % 16 == 0 && aligned_to(frame, 16)
                   && aligned_to(prev, 16) && aligned_to(y, 16)
                   && aligned_to(u, 16) && aligned_to(v, 16);
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
    csc444_damage_kernel<true><<<grid, kThreads, 0, st>>>(
        frame, prev, y, u, v, damage, W, stripe_h, static_cast<int>(P));
  else
    csc444_damage_kernel<false><<<grid, kThreads, 0, st>>>(
        frame, prev, y, u, v, damage, W, stripe_h, static_cast<int>(P));
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) order_after(order, st, dev);
  return static_cast<int>(e);
}
