// K13 csc444_damage: RGB -> three full-resolution Y/Cb/Cr planes (BT.601
// full range, the 4:4:4 ``fullcolor`` path), per-stripe damage flags, and
// the damage reference updated in place.
//
// Replaces selkies_tpu/ops/h264_planes444.py:rgb_to_yuv444 (with
// selkies_tpu/ops/colorspace.py:rgb_to_ycbcr), and the damage compare /
// prev_out copy of selkies_tpu/engine/h264_encoder.py:build_h264_step_fn
// and build_h264_band_step_fn at fullcolor.
//
// Bound on the H100: bytes. It reads the frame and prev (2 x 6.27 MB at
// 1920x1088) and writes prev (6.27 MB) and the three planes (3 x 2.09 MB),
// ~25 MB in all; the arithmetic is ~15 flops a pixel.
// Design: one thread per pixel; a block covers part of one pixel row (one
// stripe), ORs its threads' damage with __syncthreads_or and issues a
// single atomicOr. Float order: the reference's CSC is one XLA dot
// (f32[N,3] x f32[3,3]) in every program that runs it (standalone, the
// stock steps, the band step), the same dot as at 4:2:0, so the order is
// K1's: Y and Cb as ((r*m0 + g*m1) + b*m2) + off, Cr as
// fma(b, m2, fma(g, m1, r*m0)) + off, pinned with __fmul_rn / __fadd_rn /
// __fmaf_rn (and -fmad=false); each plane then rintf (half-even) and clamp.
#include "h264_common.cuh"

__device__ __forceinline__ uint8_t csc_to_u8(float x) {
  const float r = rintf(x);
  return static_cast<uint8_t>(r < 0.f ? 0.f : (r > 255.f ? 255.f : r));
}

__global__ void csc444_damage_kernel(const uint8_t* __restrict__ frame,
                                     uint8_t* __restrict__ prev,
                                     uint8_t* __restrict__ y,
                                     uint8_t* __restrict__ u,
                                     uint8_t* __restrict__ v,
                                     int* __restrict__ damage, int W,
                                     int stripe_h) {
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y;
  int diff = 0;
  if (px < W) {
    const size_t p = static_cast<size_t>(py) * W + px;
    const size_t o = 3 * p;
    const uint8_t R = frame[o], G = frame[o + 1], B = frame[o + 2];
    diff = (R != prev[o]) | (G != prev[o + 1]) | (B != prev[o + 2]);
    prev[o] = R;
    prev[o + 1] = G;
    prev[o + 2] = B;
    const float r = R, g = G, b = B;
    y[p] = csc_to_u8(__fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(r, K_CSC[0]), __fmul_rn(g, K_CSC[1])),
                  __fmul_rn(b, K_CSC[2])),
        0.0f));
    u[p] = csc_to_u8(__fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(r, K_CSC[3]), __fmul_rn(g, K_CSC[4])),
                  __fmul_rn(b, K_CSC[5])),
        128.0f));
    v[p] = csc_to_u8(__fadd_rn(
        __fmaf_rn(b, K_CSC[8], __fmaf_rn(g, K_CSC[7], __fmul_rn(r, K_CSC[6]))),
        128.0f));
  }
  if (__syncthreads_or(diff) && threadIdx.x == 0)
    atomicOr(&damage[py / stripe_h], 1);
}

extern "C" int csc444_damage(const uint8_t* frame, uint8_t* prev, uint8_t* y,
                             uint8_t* u, uint8_t* v, int* damage, int H, int W,
                             int stripe_h, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(damage, 0, sizeof(int) * (H / stripe_h), s);
  const int threads = 256;
  dim3 grid((W + threads - 1) / threads, H);
  csc444_damage_kernel<<<grid, threads, 0, s>>>(frame, prev, y, u, v, damage,
                                                W, stripe_h);
  return static_cast<int>(cudaGetLastError());
}
