// K1 csc420_damage: RGB -> Y/U/V 4:2:0 (BT.601 full range), per-stripe
// damage flags, and the damage reference updated in place.
//
// Replaces selkies_tpu/ops/colorspace.py:rgb_to_ycbcr +
// selkies_tpu/ops/h264_planes.py:rgb_to_yuv420, and the damage compare /
// prev_out copy of selkies_tpu/engine/h264_encoder.py:build_h264_step_fn.
//
// Bound on the H100: bytes. It reads the frame and prev (2 x 6.27 MB at
// 1920x1088) and writes prev, Y, U and V; the arithmetic is ~30 flops per
// pixel. Design: one thread per 2x2 pixel quad, so the 4:2:0 mean needs no
// exchange between threads; a block covers part of one quad row (one
// stripe), ORs its threads' damage with __syncthreads_or and issues a
// single atomicOr, so the flag costs a handful of atomics per stripe.
// Float order is pinned with __fmul_rn / __fadd_rn / __fmaf_rn (no
// contraction; -fmad=false too) to the order XLA:CPU gives the reference:
// Y and Cb as ((r*m0 + g*m1) + b*m2) + off, Cr as
// fma(b, m2, fma(g, m1, r*m0)) + off, chroma mean ((a00+a01)+(a10+a11))*.25,
// then rintf (half-even) and clamp.
#include "h264_common.cuh"

__device__ __forceinline__ uint8_t to_u8(float x) {
  float r = rintf(x);
  return static_cast<uint8_t>(r < 0.f ? 0.f : (r > 255.f ? 255.f : r));
}

__global__ void csc420_damage_kernel(const uint8_t* __restrict__ frame,
                                     uint8_t* __restrict__ prev,
                                     uint8_t* __restrict__ y,
                                     uint8_t* __restrict__ u,
                                     uint8_t* __restrict__ v,
                                     int* __restrict__ damage, int W,
                                     int stripe_h) {
  const int W2 = W / 2;
  const int qx = blockIdx.x * blockDim.x + threadIdx.x;
  const int qy = blockIdx.y;
  int diff = 0;
  if (qx < W2) {
    float cb[4], cr[4];
#pragma unroll
    for (int k = 0; k < 4; k++) {
      const int py = 2 * qy + (k >> 1), px = 2 * qx + (k & 1);
      const size_t o = (static_cast<size_t>(py) * W + px) * 3;
      const uint8_t R = frame[o], G = frame[o + 1], B = frame[o + 2];
      diff |= (R != prev[o]) | (G != prev[o + 1]) | (B != prev[o + 2]);
      prev[o] = R;
      prev[o + 1] = G;
      prev[o + 2] = B;
      const float r = R, g = G, b = B;
      const float yy = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(r, K_CSC[0]), __fmul_rn(g, K_CSC[1])),
                    __fmul_rn(b, K_CSC[2])),
          0.0f);
      y[static_cast<size_t>(py) * W + px] = to_u8(yy);
      cb[k] = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(r, K_CSC[3]), __fmul_rn(g, K_CSC[4])),
                    __fmul_rn(b, K_CSC[5])),
          128.0f);
      cr[k] = __fadd_rn(
          __fmaf_rn(b, K_CSC[8], __fmaf_rn(g, K_CSC[7], __fmul_rn(r, K_CSC[6]))),
          128.0f);
    }
    const size_t oc = static_cast<size_t>(qy) * W2 + qx;
    u[oc] = to_u8(
        __fmul_rn(__fadd_rn(__fadd_rn(cb[0], cb[1]), __fadd_rn(cb[2], cb[3])),
                  0.25f));
    v[oc] = to_u8(
        __fmul_rn(__fadd_rn(__fadd_rn(cr[0], cr[1]), __fadd_rn(cr[2], cr[3])),
                  0.25f));
  }
  if (__syncthreads_or(diff) && threadIdx.x == 0)
    atomicOr(&damage[(2 * qy) / stripe_h], 1);
}

extern "C" int csc420_damage(const uint8_t* frame, uint8_t* prev, uint8_t* y,
                             uint8_t* u, uint8_t* v, int* damage, int H, int W,
                             int stripe_h, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(damage, 0, sizeof(int) * (H / stripe_h), s);
  const int threads = 256;
  dim3 grid((W / 2 + threads - 1) / threads, H / 2);
  csc420_damage_kernel<<<grid, threads, 0, s>>>(frame, prev, y, u, v, damage,
                                                W, stripe_h);
  return static_cast<int>(cudaGetLastError());
}
