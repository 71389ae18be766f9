// K12 watermark_blend: the watermark alpha-blended into its region of the
// frame, in place: out = region * (1 - a) + R * a in float32, rounded
// half to even, clipped to [0, 255], written back as bytes.
//
// Replaces selkies_tpu/engine/watermark.py:_blender (jitted at :43), the
// per-frame burn-in before the encode step. The watermark comes as the
// decoded (wh, ww, 4) uint8 RGBA image; a and 1 - a come from a (256, 2)
// float32 table indexed by the alpha byte, formed on the host as the
// reference forms them (a = float32(A) / 255, then float32(1 - a), each
// rounded once). Float order: out = fl(fl(px * (1 - a)) + fl(R * a))
// (__fmul_rn, __fadd_rn; the library builds with -fmad=false); over all
// 2^24 (region, R, A) bytes this matches the reference whether or not
// its compiler fuses a product. The start (y0, x0) is taken as
// lax.dynamic_slice / dynamic_update_slice take it (a negative start
// counts from the end, then it is clamped), so the region always lies
// inside the frame.
//
// Bound on the H100: bytes (the region read and written, the RGBA image
// read: about 1.3 MB for a 480x270 watermark at 1080p). Design: a 2-D
// grid over region rows and groups of 4 pixels, a block 32 groups of 4
// rows (one wave at 1080p), so a warp is 32 groups of one region row. A
// thread loads its 4 RGBA pixels (one 16-byte load where the image's
// rows are 16-byte aligned) and its 12 frame bytes as the 3 or 4 aligned
// words that hold them (funnel shifts where the row starts off a word),
// the block the table into shared memory, all before the one barrier,
// and stores whole words: off a word, the word a group shares with its
// right neighbour is stored by the group with that neighbour's first
// bytes, taken by a shuffle; only bytes at a warp's or the region's edge
// and the last group of a row whose width is not a multiple of 4 are
// stored one by one. No local memory (every array index is a constant).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WM_X = 32, WM_Y = 4;       // 4-pixel groups x region rows
constexpr int WM_THREADS = WM_X * WM_Y;

__device__ __forceinline__ uint32_t blend(uint32_t px, uint32_t r,
                                          float2 t) {
  // t = (a, 1 - a); the conversion rounds half to even and takes a
  // negative value to 0
  const float out = __fadd_rn(__fmul_rn(static_cast<float>(px), t.y),
                              __fmul_rn(static_cast<float>(r), t.x));
  return min(__float2uint_rn(out), 255u);
}

__device__ __forceinline__ uint32_t byte_at(const uint32_t* w, int j) {
  return (w[j >> 2] >> (8 * (j & 3))) & 255u;
}

template <bool VEC>
__global__ void __launch_bounds__(WM_THREADS)
watermark_blend_kernel(uint8_t* __restrict__ frame,
                       const uint8_t* __restrict__ rgba,
                       const float* __restrict__ table, int W, int y0, int x0,
                       int wh, int ww) {
  __shared__ float4 lut[128];            // (a, 1 - a) of alpha 2i, 2i + 1
  const int tid = threadIdx.y * WM_X + threadIdx.x;
  const int y = blockIdx.y * WM_Y + threadIdx.y;
  const int x = 4 * (blockIdx.x * WM_X + threadIdx.x);
  const int n = y < wh && x < ww ? min(ww - x, 4) : 0;   // pixels
  uint32_t px[4] = {0, 0, 0, 0};          // RGBA, R in the low byte
  uint32_t fw[4] = {0, 0, 0, 0};          // the aligned frame words
  uint8_t* f = frame;
  unsigned s = 0;                         // the group's byte within a word
  if (n) {
    const uint32_t* src = reinterpret_cast<const uint32_t*>(
        rgba + (static_cast<size_t>(y) * ww + x) * 4);
    if (VEC && n == 4) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
      px[0] = v.x, px[1] = v.y, px[2] = v.z, px[3] = v.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; k++)
        if (k < n) px[k] = __ldg(src + k);
    }
    f = frame + (static_cast<size_t>(y0 + y) * W + (x0 + x)) * 3;
    s = static_cast<unsigned>(reinterpret_cast<uintptr_t>(f) & 3);
    if (n == 4) {
      // each aligned word holds a byte of the group, so it lies inside
      // the frame's pages
      const uint32_t* w = reinterpret_cast<const uint32_t*>(f - s);
      fw[0] = w[0], fw[1] = w[1], fw[2] = w[2];
      if (s) fw[3] = w[3];
    } else {
#pragma unroll
      for (int j = 0; j < 12; j++)
        if (j < 3 * n)
          fw[j >> 2] |= static_cast<uint32_t>(f[j]) << (8 * (j & 3));
    }
  }
  lut[tid] = __ldg(reinterpret_cast<const float4*>(table) + tid);
  __syncthreads();
  const float2* t = reinterpret_cast<const float2*>(lut);
  uint32_t d[3];                          // the group's 12 frame bytes
  if (n == 4 && s) {
    const unsigned sh = 8 * s;
    d[0] = __funnelshift_r(fw[0], fw[1], sh);
    d[1] = __funnelshift_r(fw[1], fw[2], sh);
    d[2] = __funnelshift_r(fw[2], fw[3], sh);
  } else {
    d[0] = fw[0], d[1] = fw[1], d[2] = fw[2];
  }
  uint32_t o[3] = {0, 0, 0};
#pragma unroll
  for (int k = 0; k < 4; k++) {
    const float2 a = t[px[k] >> 24];
#pragma unroll
    for (int c = 0; c < 3; c++) {
      const int j = 3 * k + c;
      o[j >> 2] |= blend(byte_at(d, j), (px[k] >> (8 * c)) & 255u, a)
                   << (8 * (j & 3));
    }
  }
  // a warp is 32 groups of one region row: the right neighbour's first
  // bytes, for the word the two groups share where the row starts off a
  // word
  const uint32_t next = __shfl_down_sync(0xffffffffu, o[0], 1);
  if (!n) return;
  uint32_t* w = reinterpret_cast<uint32_t*>(f - s);
  if (n == 4 && !s) {
    w[0] = o[0], w[1] = o[1], w[2] = o[2];
    return;
  }
  // off a word, words 1 and 2 lie inside the group and word 3 is shared
  // with the right neighbour: a group stores it whole where that
  // neighbour is in its warp, and that neighbour leaves its first bytes
  // to it; the other bytes at a warp's or the region's edge, and a short
  // group's, go one by one
  const int lane = threadIdx.x;
  const bool right = n == 4 && lane < 31 && x + 4 < ww;
  const int lo = s && lane > 0 ? 4 - static_cast<int>(s) : 0;
  int head = 3 * n, tail = 12;
  if (n == 4) {
    w[1] = __funnelshift_l(o[0], o[1], 8 * s);
    w[2] = __funnelshift_l(o[1], o[2], 8 * s);
    if (right) w[3] = __funnelshift_l(o[2], next, 8 * s);
    head = 4 - static_cast<int>(s);
    tail = right ? 12 : 12 - static_cast<int>(s);
  }
#pragma unroll
  for (int j = 0; j < 12; j++)
    if ((j >= lo && j < head) || j >= tail)
      f[j] = static_cast<uint8_t>(byte_at(o, j));
}

}  // namespace

extern "C" int watermark_blend(uint8_t* frame, const uint8_t* rgba,
                               const float* table, int H, int W, int y0,
                               int x0, int wh, int ww, void* stream) {
  if (wh <= 0 || ww <= 0 || wh > H || ww > W ||
      wh > 65535 * WM_Y || (reinterpret_cast<uintptr_t>(rgba) & 3) ||
      (reinterpret_cast<uintptr_t>(table) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  // lax.dynamic_slice: a negative start counts from the end, then the
  // start is clamped so the slice fits
  if (y0 < 0) y0 += H;
  if (x0 < 0) x0 += W;
  y0 = y0 < 0 ? 0 : (y0 > H - wh ? H - wh : y0);
  x0 = x0 < 0 ? 0 : (x0 > W - ww ? W - ww : x0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int groups = (ww + 3) / 4;
  const dim3 grid((groups + WM_X - 1) / WM_X, (wh + WM_Y - 1) / WM_Y);
  const dim3 block(WM_X, WM_Y);
  if (ww % 4 == 0 && (reinterpret_cast<uintptr_t>(rgba) & 15) == 0)
    watermark_blend_kernel<true><<<grid, block, 0, st>>>(frame, rgba, table,
                                                          W, y0, x0, wh, ww);
  else
    watermark_blend_kernel<false><<<grid, block, 0, st>>>(frame, rgba, table,
                                                           W, y0, x0, wh, ww);
  return static_cast<int>(cudaGetLastError());
}
