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
// int16 coefficients written: 18.8 MB); the ~45 float operations a
// coefficient (two 8-term chains, a true division, the rounding) come
// close behind, so the design keeps them off shared memory.
// Design: a block of 128 threads takes 8 MCUs of one MCU row at 4:2:0
// (128 x 16 pixels, 48 blocks of 8x8) or 16 at 4:4:4 (128 x 8 pixels, 48
// blocks), so the per-block tables and barriers are shared by 8 or 16
// MCUs. (A) A thread reads 16 pixels of a row as three 16-byte vectors
// (8 pixels as three 8-byte vectors where rows are off 16 bytes: a second
// instantiation the host picks), converts them in registers and stores
// the level-shifted planes to shared memory; at 4:2:0 the two threads of
// a row pair (neighbouring lanes) trade their horizontal pair sums by
// shuffle and each stores half of the chroma means. The same vectors go
// to prev after the first barrier, so those stores drain while the
// transforms run. (B) A thread runs the 8-point column transforms of four
// neighbouring columns in registers (16-byte shared loads and stores, in
// place; the DCT matrix is read at compile-time indices, as constant-bank
// operands). (C) A thread reads a row of 8 with two 16-byte loads (rows
// padded to 132 floats, so eight rows of a block hit distinct banks),
// runs the 8 row chains, divides by the stripe's table (staged in shared
// memory once a block with the reciprocals quant_div.cuh hoists out of
// the per-coefficient divide), rounds and scatters the int16 results into
// zigzag slots in shared memory. (D) The block's Y blocks of each 8-row
// band, then its Cb and Cr blocks, are contiguous in the output: 16-byte
// stores. Three barriers a block.
// Float order (pinned with __fmul_rn / __fadd_rn / __fmaf_rn / __fdiv_rn,
// -fmad=false) is the order XLA:CPU gives the reference: the CSC of
// csc_rows.cuh; Y - 128 and, at 4:4:4, Cb/Cr - 128 after the +128;
// chroma mean ((a00+a01)+(a10+a11))*0.25 - 128; each 8-term DCT chain
// fma(d7,x7, ... fma(d2,x2, fma(d0,x0, d1*x1))); q = coef / qt;
// trunc(q + sign(q)*0.5).
#include "csc_rows.cuh"
#include "jpeg_tables.cuh"
#include "quant_div.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBlockPx = 128;               // pixels across a block
constexpr int kPitch = kBlockPx + 4;        // floats a shared plane row
constexpr int kCPitch = kBlockPx / 2 + 4;   // 4:2:0 chroma rows
constexpr int kBlocks = 48;                 // 8x8 blocks a block
constexpr int kOPitch = 72;                 // int16 an output slot

// 8-term chain of DCT row I over x: fma(d7,x7, ... fma(d0,x0, d1*x1))
template <int I>
__device__ __forceinline__ float dct_chain(const float (&x)[8]) {
  float acc =
      __fmaf_rn(K_DCT8[I * 8], x[0], __fmul_rn(K_DCT8[I * 8 + 1], x[1]));
#pragma unroll
  for (int a = 2; a < 8; a++) acc = __fmaf_rn(K_DCT8[I * 8 + a], x[a], acc);
  return acc;
}

template <int I = 0>
__device__ __forceinline__ void dct8(const float (&x)[8], float (&out)[8]) {
  out[I] = dct_chain<I>(x);
  if constexpr (I < 7) dct8<I + 1>(x, out);
}

// the chain of DCT row I over four neighbouring columns at once
template <int I>
__device__ __forceinline__ float4 dct_chain4(const float4 (&x)[8]) {
  constexpr int o = I * 8;
  float4 acc = make_float4(
      __fmaf_rn(K_DCT8[o], x[0].x, __fmul_rn(K_DCT8[o + 1], x[1].x)),
      __fmaf_rn(K_DCT8[o], x[0].y, __fmul_rn(K_DCT8[o + 1], x[1].y)),
      __fmaf_rn(K_DCT8[o], x[0].z, __fmul_rn(K_DCT8[o + 1], x[1].z)),
      __fmaf_rn(K_DCT8[o], x[0].w, __fmul_rn(K_DCT8[o + 1], x[1].w)));
#pragma unroll
  for (int a = 2; a < 8; a++) {
    acc.x = __fmaf_rn(K_DCT8[o + a], x[a].x, acc.x);
    acc.y = __fmaf_rn(K_DCT8[o + a], x[a].y, acc.y);
    acc.z = __fmaf_rn(K_DCT8[o + a], x[a].z, acc.z);
    acc.w = __fmaf_rn(K_DCT8[o + a], x[a].w, acc.w);
  }
  return acc;
}

template <int I = 0>
__device__ __forceinline__ void dct8_4(const float4 (&x)[8], float* p,
                                       int stride) {
  *reinterpret_cast<float4*>(p + I * stride) = dct_chain4<I>(x);
  if constexpr (I < 7) dct8_4<I + 1>(x, p, stride);
}

// four neighbouring columns of 8 at p (16-byte aligned, rows stride
// floats apart), transformed in place: 16-byte loads and stores
__device__ __forceinline__ void column_pass4(float* p, int stride) {
  float4 x[8];
#pragma unroll
  for (int a = 0; a < 8; a++)
    x[a] = *reinterpret_cast<const float4*>(p + a * stride);
  dct8_4(x, p, stride);
}

// zigzag slot of raster coefficient (i, j)
__device__ __forceinline__ int zz_slot(int i, int j) {
  const int s = i + j, lo = s > 7 ? s - 7 : 0;
  const int base = s < 8 ? s * (s + 1) / 2 : 64 - (15 - s) * (16 - s) / 2;
  return base + ((s & 1) ? i - lo : j - lo);
}

// row i of a block (8 floats at p, 16-byte aligned): the row chains,
// quantised by qt (row i of the table; ry its div_recip where the tables
// are all moderate, else null), rounded, into zigzag slots zs of o
__device__ __forceinline__ void row_pass(const float* p, const float* qt,
                                         const float* ry, const int (&zs)[8],
                                         short* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  const float x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  float c[8];
  dct8(x, c);
  float q[8];
  if (ry) {
#pragma unroll
    for (int j = 0; j < 8; j++) q[j] = div_by(c[j], qt[j], ry[j]);
  } else {
#pragma unroll
    for (int j = 0; j < 8; j++) q[j] = __fdiv_rn(c[j], qt[j]);
  }
#pragma unroll
  for (int j = 0; j < 8; j++) {
    // trunc(q + sign(q) * 0.5); at q = 0 the sign's 0 and copysign's
    // +-0.5 both truncate to 0
    o[zs[j]] = static_cast<short>(
        __float2int_rz(__fadd_rn(q[j], copysignf(0.5f, q[j]))));
  }
}

template <int N>
__device__ __forceinline__ void store_floats(float* p, const float (&v)[N]) {
  static_assert(N % 2 == 0, "pairs");
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N / 4; k++)
      reinterpret_cast<float4*>(p)[k] =
          make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < N / 2; k++)
      reinterpret_cast<float2*>(p)[k] = make_float2(v[2 * k], v[2 * k + 1]);
  }
}

// grid (tiles of 128 pixels across, MCU rows); VEC: bytes a frame load
// (16 or 8)
template <bool SUB420, int VEC>
__global__ void __launch_bounds__(kThreads, 8)
jpeg_forward_kernel(const uint8_t* __restrict__ frame,
                    uint8_t* __restrict__ prev, const int* __restrict__ tab,
                    const float* __restrict__ qtables, short* __restrict__ y,
                    short* __restrict__ cb, short* __restrict__ cr, int W,
                    int stripe_h) {
  constexpr int MCU = SUB420 ? 16 : 8;
  constexpr int NM = kBlockPx / MCU;        // MCUs a block: 8 or 16
  constexpr int NBR = SUB420 ? 2 : 3;       // 8-row bands of `ys`
  constexpr int UPX = VEC == 16 ? 16 : 8;   // pixels a run (of one row)
  constexpr int SEGS = kBlockPx / UPX;
  constexpr int NU = MCU * SEGS;            // runs a block
  constexpr int IT = (NU + kThreads - 1) / kThreads;   // runs a thread
  constexpr int NW = 3 * UPX / 4;           // words a run
  // 4:2:0: Y's two 8-row bands; 4:4:4: Y, Cb, Cr, 8 rows each
  __shared__ __align__(16) float ys[8 * NBR][kPitch];
  __shared__ __align__(16) float cs[SUB420 ? 16 : 1][kCPitch];
  __shared__ __align__(16) short os[kBlocks][kOPitch];
  // the stripe's two tables and their reciprocals (div_recip), rows
  // padded to 9 so that the eight rows of a row pass hit distinct banks
  __shared__ float qs[2][8][9];
  __shared__ float qr[2][8][9];
  const int t = threadIdx.x;
  const int my = blockIdx.y, mx0 = blockIdx.x * NM;
  const int nm = min(NM, W / MCU - mx0);    // MCUs of this block
  const float qv =
      __ldg(qtables + 2 * 64 * __ldg(tab + (my * MCU) / stripe_h) + t);
  const bool moderate = div_moderate(qv);
  qs[t >> 6][(t >> 3) & 7][t & 7] = qv;
  qr[t >> 6][(t >> 3) & 7][t & 7] = moderate ? div_recip(qv) : 0.0f;

  // (A) the runs in, CSC into the shared planes; at 4:2:0 run u is row
  // u & 1 of a row pair, so the two rows of a pair are neighbouring lanes
  unsigned w[IT][NW];
  size_t off[IT];
  bool ok[IT];
#pragma unroll
  for (int it = 0; it < IT; it++) {
    const int un = t + it * kThreads;
    int row, seg;
    if (SUB420) {
      row = 2 * ((un >> 1) / SEGS) + (un & 1);
      seg = (un >> 1) % SEGS;
    } else {
      row = un / SEGS;
      seg = un % SEGS;
    }
    ok[it] = (NU % kThreads == 0 || un < NU) && seg < nm * MCU / UPX;
    off[it] = (static_cast<size_t>(my * MCU + row) * W
               + static_cast<size_t>(mx0 * MCU + seg * UPX)) * 3;
    if (ok[it]) {
      load_run<VEC>(frame + off[it], w[it]);
    } else {
#pragma unroll
      for (int k = 0; k < NW; k++) w[it][k] = 0u;
    }
    if (NU % kThreads && un >= NU) continue;
    float yv[UPX];
    if (SUB420) {
      float hb[UPX / 2], hr[UPX / 2];
#pragma unroll
      for (int p = 0; p < UPX / 2; p++) {
        float r0, g0, b0, r1, g1, b1;
        run_rgb(w[it], 2 * p, r0, g0, b0);
        run_rgb(w[it], 2 * p + 1, r1, g1, b1);
        yv[2 * p] = __fadd_rn(csc_y(r0, g0, b0), -128.0f);
        yv[2 * p + 1] = __fadd_rn(csc_y(r1, g1, b1), -128.0f);
        hb[p] = __fadd_rn(csc_cb(r0, g0, b0), csc_cb(r1, g1, b1));
        hr[p] = __fadd_rn(csc_cr(r0, g0, b0), csc_cr(r1, g1, b1));
      }
      // the top row (even lane) takes the first half of the means, the
      // bottom row the second; each sends the half the other takes
      constexpr int HALF = UPX / 4;
      const bool top = !(un & 1);
      float mb[HALF], mr[HALF];
#pragma unroll
      for (int p = 0; p < HALF; p++) {
        const float sb = __shfl_xor_sync(0xffffffffu,
                                         top ? hb[HALF + p] : hb[p], 1);
        const float sr = __shfl_xor_sync(0xffffffffu,
                                         top ? hr[HALF + p] : hr[p], 1);
        const float ob = top ? hb[p] : hb[HALF + p];
        const float orr = top ? hr[p] : hr[HALF + p];
        // ((a00 + a01) + (a10 + a11)): the top pair first
        mb[p] = __fadd_rn(__fmul_rn(top ? __fadd_rn(ob, sb)
                                        : __fadd_rn(sb, ob), 0.25f),
                          -128.0f);
        mr[p] = __fadd_rn(__fmul_rn(top ? __fadd_rn(orr, sr)
                                        : __fadd_rn(sr, orr), 0.25f),
                          -128.0f);
      }
      if (ok[it]) {
        const int rp = (un >> 1) / SEGS, seg = (un >> 1) % SEGS;
        store_floats(&ys[2 * rp + (un & 1)][seg * UPX], yv);
        const int cc = seg * (UPX / 2) + (top ? 0 : HALF);
        store_floats(&cs[rp][cc], mb);
        store_floats(&cs[8 + rp][cc], mr);
      }
    } else if (ok[it]) {
      float bv[UPX], rv[UPX];
#pragma unroll
      for (int p = 0; p < UPX; p++) {
        float r, gg, b;
        run_rgb(w[it], p, r, gg, b);
        yv[p] = __fadd_rn(csc_y(r, gg, b), -128.0f);
        bv[p] = __fadd_rn(csc_cb(r, gg, b), -128.0f);
        rv[p] = __fadd_rn(csc_cr(r, gg, b), -128.0f);
      }
      const int row = un / SEGS, seg = un % SEGS;
      store_floats(&ys[row][seg * UPX], yv);
      store_floats(&ys[8 + row][seg * UPX], bv);
      store_floats(&ys[16 + row][seg * UPX], rv);
    }
  }
  // every entry of both tables moderate: the hoisted divide
  const bool fast = __syncthreads_and(moderate);
  // prev <- frame, issued after the barrier so that the stores drain
  // while the transforms run
#pragma unroll
  for (int it = 0; it < IT; it++)
    if (ok[it]) store_run<VEC>(prev + off[it], w[it]);

  // (B) column pass, in place: a thread four neighbouring columns of a
  // band (at 4:2:0 threads 64..95 four of a chroma component)
  if (t < 96) {
    const int k = t & 31;
    if (SUB420 && t >= 64) {
      const int c4 = t & 15;
      if (4 * c4 < nm * 8) column_pass4(&cs[8 * (k >> 4)][4 * c4], kCPitch);
    } else if (4 * k < nm * MCU) {
      column_pass4(&ys[8 * (t >> 5)][4 * k], kPitch);
    }
  }
  __syncthreads();

  // (C) row pass: row i of block g of each band (and at 4:2:0 of chroma
  // block g & 7 of component g >> 3); slots: band br block g at
  // br * 16 + g, 4:2:0 chroma at 32 + component * 8 + block
  const int i = t & 7, g = t >> 3;
  int zs[8];
#pragma unroll
  for (int j = 0; j < 8; j++) zs[j] = zz_slot(i, j);
  if (g < nm * MCU / 8) {
#pragma unroll
    for (int br = 0; br < NBR; br++)
      row_pass(&ys[8 * br + i][8 * g], qs[SUB420 || br == 0 ? 0 : 1][i],
               fast ? qr[SUB420 || br == 0 ? 0 : 1][i] : nullptr, zs,
               os[16 * br + g]);
  }
  if (SUB420 && (g & 7) < nm)
    row_pass(&cs[8 * (g >> 3) + i][8 * (g & 7)], qs[1][i],
             fast ? qr[1][i] : nullptr, zs, os[32 + g]);
  __syncthreads();

  // (D) 16-byte stores: 384 chunks of 8 coefficients, three a thread
  const int bw = W / 8;
#pragma unroll
  for (int c3 = 0; c3 < 3; c3++) {
    const int c = t + kThreads * c3;
    const int slot = c >> 3, part = c & 7;
    short* dst;
    if (SUB420 && c3 == 2) {                // chroma: component, block
      const int bc = slot & 7;
      if (bc >= nm) continue;
      dst = ((slot >> 3) & 1 ? cr : cb)
            + (static_cast<size_t>(my) * (W / 16) + mx0 + bc) * 64;
    } else {                                // band c3, block slot & 15
      const int gb = slot & 15;
      if (gb >= nm * MCU / 8) continue;
      dst = SUB420 ? y + ((static_cast<size_t>(2 * my + c3) * bw + 2 * mx0
                           + gb) * 64)
                   : (c3 == 0 ? y : (c3 == 1 ? cb : cr))
                         + (static_cast<size_t>(my) * bw + mx0 + gb) * 64;
    }
    reinterpret_cast<uint4*>(dst)[part] =
        *reinterpret_cast<const uint4*>(&os[slot][8 * part]);
  }
}

template <bool SUB420>
void launch(dim3 grid, cudaStream_t st, bool vec16, const uint8_t* frame,
            uint8_t* prev, const int* tab, const float* qtables, short* y,
            short* cb, short* cr, int W, int stripe_h) {
  if (vec16)
    jpeg_forward_kernel<SUB420, 16><<<grid, kThreads, 0, st>>>(
        frame, prev, tab, qtables, y, cb, cr, W, stripe_h);
  else
    jpeg_forward_kernel<SUB420, 8><<<grid, kThreads, 0, st>>>(
        frame, prev, tab, qtables, y, cb, cr, W, stripe_h);
}

}  // namespace

extern "C" int jpeg_forward(const uint8_t* frame, uint8_t* prev,
                            const int* tab, const float* qtables, short* y,
                            short* cb, short* cr, int H, int W, int S,
                            int sub444, void* stream) {
  const int mcu = sub444 ? 8 : 16;
  if (H <= 0 || W <= 0 || S <= 0 || H % S || W % mcu || (H / S) % mcu
      || H / mcu > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // frame rows as 16-byte vectors where they allow it, else 8-byte ones
  // (W is a multiple of 8); the coefficient rows as 16-byte stores
  const bool vec16 = W % 16 == 0 && aligned_to(frame, 16)
                     && aligned_to(prev, 16);
  if (!aligned_to(frame, 8) || !aligned_to(prev, 8) || !aligned_to(y, 16)
      || !aligned_to(cb, 16) || !aligned_to(cr, 16))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int stripe_h = H / S;
  const int per_block = kBlockPx / mcu;
  const dim3 grid((W / mcu + per_block - 1) / per_block, H / mcu);
  if (sub444)
    launch<false>(grid, st, vec16, frame, prev, tab, qtables, y, cb, cr, W,
                  stripe_h);
  else
    launch<true>(grid, st, vec16, frame, prev, tab, qtables, y, cb, cr, W,
                 stripe_h);
  return static_cast<int>(cudaGetLastError());
}
