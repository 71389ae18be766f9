// K12 watermark_blend: the watermark alpha-blended into its region of the
// frame, in place: out = region * (1 - a) + rgb * a in float32, rounded
// half to even, clipped to [0, 255], written back as bytes.
//
// Replaces selkies_tpu/engine/watermark.py:_blender (jitted at :43), the
// per-frame burn-in before the encode step. Float order: each product
// and the sum are rounded once (__fmul_rn, __fsub_rn, __fadd_rn; the
// library builds with -fmad=false); over all 2^24 (region, watermark,
// alpha) bytes this matches the reference whether or not its compiler
// fuses a product, with a = float32(A) / 255 formed on the host as the
// reference forms it. The start (y0, x0) is taken as
// lax.dynamic_slice / dynamic_update_slice take it (a negative start
// counts from the end, then it is clamped), so the region always lies
// inside the frame.
//
// Bound on the H100: bytes (the region read and written, the float32
// rgb and alpha read: about 2.9 MB for a 480x270 watermark at 1080p).
// Design: one thread per region byte; neighbouring threads touch
// neighbouring bytes of one region row and neighbouring floats of rgb.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void watermark_blend_kernel(uint8_t* __restrict__ frame,
                                       const float* __restrict__ rgb,
                                       const float* __restrict__ alpha, int W,
                                       int y0, int x0, int wh, int ww) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= 3LL * wh * ww) return;
  const long long p = i / 3;
  const int c = static_cast<int>(i - 3 * p);
  const int y = static_cast<int>(p / ww), x = static_cast<int>(p - 1LL * y * ww);
  uint8_t* px = frame + (1LL * (y0 + y) * W + (x0 + x)) * 3 + c;
  const float a = alpha[p];
  const float out = __fadd_rn(__fmul_rn(static_cast<float>(*px),
                                        __fsub_rn(1.0f, a)),
                              __fmul_rn(rgb[i], a));
  *px = static_cast<uint8_t>(fminf(fmaxf(rintf(out), 0.0f), 255.0f));
}

extern "C" int watermark_blend(uint8_t* frame, const float* rgb,
                               const float* alpha, int H, int W, int y0,
                               int x0, int wh, int ww, void* stream) {
  if (wh <= 0 || ww <= 0 || wh > H || ww > W)
    return static_cast<int>(cudaErrorInvalidValue);
  // lax.dynamic_slice: a negative start counts from the end, then the
  // start is clamped so the slice fits
  if (y0 < 0) y0 += H;
  if (x0 < 0) x0 += W;
  y0 = y0 < 0 ? 0 : (y0 > H - wh ? H - wh : y0);
  x0 = x0 < 0 ? 0 : (x0 > W - ww ? W - ww : x0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = 3LL * wh * ww;
  const int threads = 256;
  const int blocks = static_cast<int>((n + threads - 1) / threads);
  watermark_blend_kernel<<<blocks, threads, 0, s>>>(frame, rgb, alpha, W, y0,
                                                    x0, wh, ww);
  return static_cast<int>(cudaGetLastError());
}
