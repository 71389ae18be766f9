// K7 jpeg_forward: RGB -> YCbCr (BT.601 full range), 4:2:0 or 4:4:4,
// level shift, separable 8x8 DCT, quantisation by the stripe's table,
// round half away from zero, zigzag; the damage reference prev <- frame.
//
// Replaces selkies_tpu/ops/colorspace.py:rgb_to_ycbcr, subsample_420 and
// split_ycbcr_420, selkies_tpu/ops/jpeg_planes.py:_dct_planes,
// _quant_zigzag_planes, _forward_plane, jpeg_forward_420/444 (inside
// selkies_tpu/engine/encoder.py:build_step_fn, vmapped over stripes with
// the per-stripe motion / paint-over tables), and the step's prev_out.
//
// Bound on the H100: bytes at 1080p (the frame read, prev and 6.3 MB of
// int16 coefficients written: 18.8 MB; the ~35 float operations per
// coefficient, 3.13 M coefficients, take less). Design: one block per MCU (16x16
// pixels, 256 threads, for 4:2:0; 8x8 pixels, 64 threads, for 4:4:4); a
// thread converts one pixel into shared memory, the chroma mean and both
// DCT passes run one output a thread out of shared memory, and the
// quantised zigzag rows are written 64 int16 a block. Float order is
// pinned with __fmul_rn / __fadd_rn / __fmaf_rn / __fdiv_rn (and
// -fmad=false) to the order XLA:CPU gives the reference: the CSC as in K1
// (Y and Cb plain sums, Cr fused), chroma mean ((a00+a01)+(a10+a11))*0.25,
// each 8-term DCT chain fma(d7,x7, ... fma(d2,x2, fma(d0,x0, d1*x1))),
// q = coef / qt, trunc(q + sign(q)*0.5).
#include "h264_common.cuh"
#include "jpeg_tables.cuh"

// one 8-term DCT chain over x[0], x[step], ... x[7*step] with matrix row d
__device__ __forceinline__ float dct_chain(const float* d, const float* x,
                                           int step) {
  float acc = __fmaf_rn(d[0], x[0], __fmul_rn(d[1], x[step]));
#pragma unroll
  for (int a = 2; a < 8; a++) acc = __fmaf_rn(d[a], x[a * step], acc);
  return acc;
}

template <bool SUB420>
__global__ void jpeg_forward_kernel(const uint8_t* __restrict__ frame,
                                    uint8_t* __restrict__ prev,
                                    const int* __restrict__ tab,
                                    const float* __restrict__ qtables,
                                    short* __restrict__ y,
                                    short* __restrict__ cb,
                                    short* __restrict__ cr, int W,
                                    int stripe_h) {
  constexpr int MCU = SUB420 ? 16 : 8;
  constexpr int NPIX = MCU * MCU;         // threads
  constexpr int NBLK = SUB420 ? 6 : 3;    // 8x8 blocks: Y.. then Cb, Cr
  constexpr int NY = SUB420 ? 4 : 1;
  __shared__ float pix[3][NPIX];          // Y-128, Cb+128, Cr+128
  __shared__ float blk[NBLK][64];         // level-shifted 8x8 blocks
  __shared__ float tmp[NBLK][64];         // column pass [i][b]
  __shared__ float qt[2][64];
  __shared__ float dm[64];                // the DCT matrix
  __shared__ int zz[64];
  const int t = threadIdx.x;
  const int mx = blockIdx.x, my = blockIdx.y;
  const int px = t % MCU, py = t / MCU;
  const int gx = mx * MCU + px, gy = my * MCU + py;
  const size_t o = (static_cast<size_t>(gy) * W + gx) * 3;
  const uint8_t R = frame[o], G = frame[o + 1], B = frame[o + 2];
  prev[o] = R;
  prev[o + 1] = G;
  prev[o + 2] = B;
  const float r = R, g = G, b = B;
  const float yy = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(r, K_CSC[0]), __fmul_rn(g, K_CSC[1])),
                __fmul_rn(b, K_CSC[2])),
      0.0f);
  pix[0][t] = __fadd_rn(yy, -128.0f);
  pix[1][t] = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(r, K_CSC[3]), __fmul_rn(g, K_CSC[4])),
                __fmul_rn(b, K_CSC[5])),
      128.0f);
  pix[2][t] = __fadd_rn(
      __fmaf_rn(b, K_CSC[8], __fmaf_rn(g, K_CSC[7], __fmul_rn(r, K_CSC[6]))),
      128.0f);
  const int s = (my * MCU) / stripe_h;
  for (int k = t; k < 128; k += NPIX)
    qt[k >> 6][k & 63] = qtables[(2 * tab[s] + (k >> 6)) * 64 + (k & 63)];
  if (t < 64) {
    dm[t] = K_DCT8[t];
    zz[t] = K_ZIGZAG8[t];
  }
  __syncthreads();

  // gather the 8x8 blocks (Y quadrants; chroma mean or copy)
  for (int k = t; k < NBLK * 64; k += NPIX) {
    const int n = k >> 6, a = (k >> 3) & 7, c = k & 7;
    float v;
    if (n < NY) {
      v = pix[0][((n >> 1) * 8 + a) * MCU + (n & 1) * 8 + c];
    } else if (SUB420) {
      const float* p = pix[n - NY + 1];
      const int i0 = (2 * a) * MCU + 2 * c;
      const float s4 = __fadd_rn(__fadd_rn(p[i0], p[i0 + 1]),
                                 __fadd_rn(p[i0 + MCU], p[i0 + MCU + 1]));
      v = __fadd_rn(__fmul_rn(s4, 0.25f), -128.0f);
    } else {
      v = __fadd_rn(pix[n - NY + 1][a * MCU + c], -128.0f);
    }
    blk[n][a * 8 + c] = v;
  }
  __syncthreads();
  // column pass: tmp[i][b] = sum_a D[i][a] X[a][b]
  for (int k = t; k < NBLK * 64; k += NPIX) {
    const int n = k >> 6, i = (k >> 3) & 7, c = k & 7;
    tmp[n][i * 8 + c] = dct_chain(&dm[i * 8], &blk[n][c], 8);
  }
  __syncthreads();
  // row pass, quantisation and zigzag: slot z of block n holds raster
  // coefficient (i, j) = ZZ[z]; coef = sum_b D[j][b] tmp[i][b]
  const int bw = W / 8;
  for (int k = t; k < NBLK * 64; k += NPIX) {
    const int n = k >> 6, z = k & 63;
    const int rz = zz[z], i = rz >> 3, j = rz & 7;
    const float coef = dct_chain(&dm[j * 8], &tmp[n][i * 8], 1);
    const float q = __fdiv_rn(coef, qt[n < NY ? 0 : 1][rz]);
    const float h = q > 0.0f ? 0.5f : (q < 0.0f ? -0.5f : 0.0f);
    const short v = static_cast<short>(truncf(__fadd_rn(q, h)));
    if (n < NY) {
      const size_t row = static_cast<size_t>(my) * (MCU / 8) + (n >> 1);
      const size_t col = static_cast<size_t>(mx) * (MCU / 8) + (n & 1);
      y[(row * bw + col) * 64 + z] = v;
    } else {
      const size_t idx = static_cast<size_t>(my) * (W / MCU) + mx;
      (n == NY ? cb : cr)[idx * 64 + z] = v;
    }
  }
}

extern "C" int jpeg_forward(const uint8_t* frame, uint8_t* prev,
                            const int* tab, const float* qtables, short* y,
                            short* cb, short* cr, int H, int W, int S,
                            int sub444, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int stripe_h = H / S;
  if (sub444) {
    dim3 grid(W / 8, H / 8);
    jpeg_forward_kernel<false><<<grid, 64, 0, st>>>(frame, prev, tab, qtables,
                                                    y, cb, cr, W, stripe_h);
  } else {
    dim3 grid(W / 16, H / 16);
    jpeg_forward_kernel<true><<<grid, 256, 0, st>>>(frame, prev, tab, qtables,
                                                    y, cb, cr, W, stripe_h);
  }
  return static_cast<int>(cudaGetLastError());
}
