// What K1 csc420_damage (csrc/csc420_damage.cu) and K7 jpeg_forward
// (csrc/jpeg_forward.cu) share: RGB runs of a row loaded and stored as
// 16- or 8-byte vectors, a byte of such a run as an exact float, and the
// BT.601 full-range CSC in the float order XLA:CPU gives the reference
// (selkies_tpu/ops/colorspace.py:rgb_to_ycbcr): Y and Cb as
// ((r*m0 + g*m1) + b*m2) + off, Cr as fma(b, m2, fma(g, m1, r*m0)) + off,
// pinned with __fmul_rn / __fadd_rn / __fmaf_rn (and -fmad=false).
//
// Bytes become floats through the exponent trick (0x4B0000xx is 2^23 + xx:
// one byte permute and one add, both full rate, where I2F runs at a
// quarter), and a rounded value goes back the same way: 2^23 added in
// round-to-nearest-even is rintf for 0 <= x <= 255, and since rintf fixes
// the integer bounds, clamping before it equals clamping after it.
#pragma once
#include "h264_common.cuh"

namespace {

// byte b (compile-time after unrolling) of a run of little-endian words,
// as an exact float
__device__ __forceinline__ float run_byte(const unsigned* w, int b) {
  return __fadd_rn(
      __int_as_float(static_cast<int>(
          __byte_perm(w[b >> 2], 0x4B000000u, 0x7540u | (b & 3)))),
      -8388608.0f);
}

// rintf(x) clamped to [0, 255], in the low byte of the result
__device__ __forceinline__ unsigned u8_bits(float x) {
  return __float_as_uint(
      __fadd_rn(fminf(fmaxf(x, 0.0f), 255.0f), 8388608.0f));
}

// four low bytes into one word, a first
__device__ __forceinline__ unsigned pack4(unsigned a, unsigned b, unsigned c,
                                          unsigned d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

__device__ __forceinline__ float csc_y(float r, float g, float b) {
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(r, K_CSC[0]), __fmul_rn(g, K_CSC[1])),
                __fmul_rn(b, K_CSC[2])),
      0.0f);
}

__device__ __forceinline__ float csc_cb(float r, float g, float b) {
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(r, K_CSC[3]), __fmul_rn(g, K_CSC[4])),
                __fmul_rn(b, K_CSC[5])),
      128.0f);
}

__device__ __forceinline__ float csc_cr(float r, float g, float b) {
  return __fadd_rn(
      __fmaf_rn(b, K_CSC[8], __fmaf_rn(g, K_CSC[7], __fmul_rn(r, K_CSC[6]))),
      128.0f);
}

// pixel p of a run: r, g, b
__device__ __forceinline__ void run_rgb(const unsigned* w, int p, float& r,
                                        float& g, float& b) {
  r = run_byte(w, 3 * p);
  g = run_byte(w, 3 * p + 1);
  b = run_byte(w, 3 * p + 2);
}

// N words from p (VEC-byte aligned) as VEC-byte loads; the frame is only
// read
template <int VEC, int N>
__device__ __forceinline__ void load_run(const uint8_t* __restrict__ p,
                                         unsigned (&w)[N]) {
  static_assert(N % (VEC / 4) == 0, "whole vectors");
#pragma unroll
  for (int k = 0; k < N / (VEC / 4); k++) {
    if (VEC == 16) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + k);
      w[4 * k] = q.x, w[4 * k + 1] = q.y, w[4 * k + 2] = q.z,
      w[4 * k + 3] = q.w;
    } else {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(p) + k);
      w[2 * k] = q.x, w[2 * k + 1] = q.y;
    }
  }
}

template <int VEC, int N>
__device__ __forceinline__ void store_run(uint8_t* p, const unsigned (&w)[N]) {
#pragma unroll
  for (int k = 0; k < N / (VEC / 4); k++) {
    if (VEC == 16)
      reinterpret_cast<uint4*>(p)[k] =
          make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
    else
      reinterpret_cast<uint2*>(p)[k] = make_uint2(w[2 * k], w[2 * k + 1]);
  }
}

__host__ __device__ __forceinline__ bool aligned_to(const void* p, int n) {
  return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
}

}  // namespace
