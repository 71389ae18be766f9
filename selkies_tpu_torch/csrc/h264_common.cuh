// Shared device helpers for the port's H.264 kernels: exact int32 4x4
// transforms, quant / dequant (ITU-T H.264 §8.5, JM quant offsets) and the
// Exp-Golomb event. Every function mirrors one of
// selkies_tpu_torch/ops/h264_planes.py (and through it
// selkies_tpu/ops/h264_planes.py) operation for operation. All values stay
// far inside int32 (|W| <= 9180, levels clamped to +-2000).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "h264_tables.cuh"

#define LEVEL_CLAMP 2000
#define N_BLOCKS 27   // 4:2:0 blocks per MB (K2, K3)
#define NB_I444 51    // 4:4:4 blocks per MB (K14-K16): 3 x (DC + 16 AC)
#define NB_P444 48    // 3 x 16
#define HDR_SLOTS 6

// defined once, in errors.cu: the text of a C entry's non-zero return
extern "C" const char* sk_error_string(int e);

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ int clip1(int x) { return clampi(x, 0, 255); }

// Cf X Cf^T of one raster 4x4 block (fwd4_planes).
__device__ __forceinline__ void fwd4(const int* x, int* w) {
  int r[16];
#pragma unroll
  for (int j = 0; j < 4; j++) {
    int x0 = x[j], x1 = x[4 + j], x2 = x[8 + j], x3 = x[12 + j];
    int s0 = x0 + x3, s1 = x1 + x2, d0 = x0 - x3, d1 = x1 - x2;
    r[j] = s0 + s1;
    r[4 + j] = 2 * d0 + d1;
    r[8 + j] = s0 - s1;
    r[12 + j] = d0 - 2 * d1;
  }
#pragma unroll
  for (int i = 0; i < 4; i++) {
    int c0 = r[4 * i], c1 = r[4 * i + 1], c2 = r[4 * i + 2], c3 = r[4 * i + 3];
    int s0 = c0 + c3, s1 = c1 + c2, d0 = c0 - c3, d1 = c1 - c2;
    w[4 * i] = s0 + s1;
    w[4 * i + 1] = 2 * d0 + d1;
    w[4 * i + 2] = s0 - s1;
    w[4 * i + 3] = d0 - 2 * d1;
  }
}

// §8.5.12.2 inverse, horizontal pass first, WITHOUT the final (x+32)>>6
// (inv4_planes). >> is arithmetic on signed int (floor), as in JAX.
__device__ __forceinline__ void inv4(const int* d, int* out) {
  int f[16];
#pragma unroll
  for (int i = 0; i < 4; i++) {
    int e0 = d[4 * i] + d[4 * i + 2];
    int e1 = d[4 * i] - d[4 * i + 2];
    int e2 = (d[4 * i + 1] >> 1) - d[4 * i + 3];
    int e3 = d[4 * i + 1] + (d[4 * i + 3] >> 1);
    f[4 * i] = e0 + e3;
    f[4 * i + 1] = e1 + e2;
    f[4 * i + 2] = e1 - e2;
    f[4 * i + 3] = e0 - e3;
  }
#pragma unroll
  for (int j = 0; j < 4; j++) {
    int g0 = f[j] + f[8 + j];
    int g1 = f[j] - f[8 + j];
    int g2 = (f[4 + j] >> 1) - f[12 + j];
    int g3 = f[4 + j] + (f[12 + j] >> 1);
    out[j] = g0 + g3;
    out[4 + j] = g1 + g2;
    out[8 + j] = g1 - g2;
    out[12 + j] = g0 - g3;
  }
}

// _quant_plane: fdiv 3 intra, 6 inter.
__device__ __forceinline__ int quant_ac(int w, int qp, int cls, int fdiv) {
  int qbits = 15 + qp / 6;
  int mf = K_MF[(qp % 6) * 3 + cls];
  int f = (1 << qbits) / fdiv;
  int mag = ((w < 0 ? -w : w) * mf + f) >> qbits;
  return clampi(w < 0 ? -mag : mag, -LEVEL_CLAMP, LEVEL_CLAMP);
}

// _dequant_plane; left shifts of possibly negative products are written
// as multiplies.
__device__ __forceinline__ int dequant_ac(int c, int qp, int cls) {
  int ls = 16 * K_V[(qp % 6) * 3 + cls];
  int t = qp / 6;
  if (t >= 4) return c * ls * (1 << (t - 4));
  return (c * ls + (1 << (3 - t))) >> (4 - t);
}

// _quant_dc_e
__device__ __forceinline__ int quant_dc(int y, int qp) {
  int qbits = 15 + qp / 6;
  int mf00 = K_MF[(qp % 6) * 3];
  int f2 = 2 * ((1 << qbits) / 3);
  int mag = ((y < 0 ? -y : y) * mf00 + f2) >> (qbits + 1);
  return clampi(y < 0 ? -mag : mag, -LEVEL_CLAMP, LEVEL_CLAMP);
}

// _dequant_ldc_e
__device__ __forceinline__ int dequant_ldc(int f, int qp) {
  int ls00 = 16 * K_V[(qp % 6) * 3];
  int t = qp / 6;
  if (t >= 6) return f * ls00 * (1 << (t - 6));
  return (f * ls00 + (1 << (5 - t))) >> (6 - t);
}

// _dequant_cdc_e
__device__ __forceinline__ int dequant_cdc(int f, int qpc) {
  int ls00 = 16 * K_V[(qpc % 6) * 3];
  return (f * ls00 * (1 << (qpc / 6))) >> 5;
}

// _ue_event: code_num = v + 1 in 2*bitlen(code_num) - 1 bits.
__device__ __forceinline__ void ue_event(int v, int* pay, int* nb) {
  unsigned cn = static_cast<unsigned>(v) + 1u;
  *pay = static_cast<int>(cn);
  *nb = 2 * (32 - __clz(cn)) - 1;
}

// H4 row of the 4x4 Hadamard (H4 is symmetric).
__device__ __forceinline__ int h4(int i, int j) {
  // rows: ++++, ++--, +--+, +-+-
  const int sign = (0x0 | (0xC << 4) | (0x6 << 8) | (0xA << 12));
  return ((sign >> (4 * i + j)) & 1) ? -1 : 1;
}

// se_event: signed Exp-Golomb as ue of the mapped code number.
__device__ __forceinline__ void se_event(int v, int* pay, int* nb) {
  ue_event(v > 0 ? 2 * v - 1 : -2 * v, pay, nb);
}

// ---- 4x4 block helpers of the MB coders (K2, K14, K15)
__device__ __forceinline__ void load4x4(const uint8_t* p, int stride, int r0,
                                        int c0, int* x) {
#pragma unroll
  for (int i = 0; i < 4; i++)
#pragma unroll
    for (int j = 0; j < 4; j++)
      x[4 * i + j] = p[static_cast<size_t>(r0 + i) * stride + c0 + j];
}

__device__ __forceinline__ void store4x4(uint8_t* p, int stride, int r0,
                                         int c0, const int* x) {
#pragma unroll
  for (int i = 0; i < 4; i++)
#pragma unroll
    for (int j = 0; j < 4; j++)
      p[static_cast<size_t>(r0 + i) * stride + c0 + j] =
          static_cast<uint8_t>(x[4 * i + j]);
}

// Levels of one block in scan order into its lv slot (16 positions); the
// first ``skip`` scan positions are left out (DC-less blocks), the tail is
// zero-filled.
__device__ __forceinline__ void store_scan(int16_t* slot, const int* acl,
                                           int skip) {
#pragma unroll
  for (int p = 0; p < 16; p++) {
    int q = p + skip;
    slot[p] = static_cast<int16_t>(q < 16 ? acl[K_ZIGZAG[q]] : 0);
  }
}

// AC-only intra path of one block: fwd, quant (fdiv 3), DC removed,
// dequant, inverse. -> w (with the raw DC in w[0]), acl, inv.
__device__ __forceinline__ void intra_ac(const int* x, int qp, int* w,
                                         int* acl, int* inv) {
  fwd4(x, w);
  int d[16];
  acl[0] = 0;
  d[0] = 0;
#pragma unroll
  for (int k = 1; k < 16; k++) {
    acl[k] = quant_ac(w[k], qp, K_POS_CLS[k], 3);
    d[k] = dequant_ac(acl[k], qp, K_POS_CLS[k]);
  }
  inv4(d, inv);
}

__device__ __forceinline__ bool any_nz(const int* a) {
  bool nz = false;
#pragma unroll
  for (int k = 0; k < 16; k++) nz |= a[k] != 0;
  return nz;
}

// ---- K2-P's block design (mb_encode.cu): compile-time tables, quant
// constants loaded once a thread, 4x4 blocks in a shared stage, levels
// packed into whole slots, and rectangles staged with vector loads. The
// helpers above stay as K2-I, K14 and K15 use them.

// zigzag scan position p -> raster index (K_ZIGZAG, as nibbles)
__host__ __device__ constexpr int zz_raster(int p) {
  return static_cast<int>((0xfeb7adc963258410ULL >> (4 * p)) & 15);
}

// raster position k -> quant class (K_POS_CLS): 0 even/even, 1 odd/odd,
// 2 mixed
__host__ __device__ constexpr int pos_cls(int k) {
  return ((k >> 2) & 1) == (k & 1) ? (k & 1) : 2;
}

// raster 4x4 block b of an MB -> its coding order (K_CODING_OF_RASTER)
__device__ __forceinline__ int coding_of_raster(int b) {
  return ((b >> 3) << 3) | (((b & 3) >> 1) << 2) | (((b >> 2) & 1) << 1) |
         (b & 1);
}

// _quant_plane / _dequant_plane / _quant_dc_e / _dequant_cdc_e of one QP,
// their table entries read once: quant (|w| * mf + f) >> qbits; dequant
// (c * ls + dadd) >> dsh, which is c * 16v * 2^(qp/6 - 4) for qp/6 >= 4
// and (c * 16v + 2^(3 - qp/6)) >> (4 - qp/6) below.
struct QuantP {
  int mf[3], ls[3];
  int f, qbits, dadd, dsh;
};

__device__ __forceinline__ QuantP quant_p_consts(int qp, int fdiv) {
  QuantP q;
  const int qd = qp / 6, qm = qp % 6;
  q.qbits = 15 + qd;
  q.f = (1 << q.qbits) / fdiv;
  const int mul = qd >= 4 ? 1 << (qd - 4) : 1;
#pragma unroll
  for (int c = 0; c < 3; c++) {
    q.mf[c] = K_MF[qm * 3 + c];
    q.ls[c] = 16 * K_V[qm * 3 + c] * mul;
  }
  q.dadd = qd >= 4 ? 0 : 1 << (3 - qd);
  q.dsh = qd >= 4 ? 0 : 4 - qd;
  return q;
}

__device__ __forceinline__ int quant_p(int w, int mf, int f, int qbits) {
  const int mag = ((w < 0 ? -w : w) * mf + f) >> qbits;
  return clampi(w < 0 ? -mag : mag, -LEVEL_CLAMP, LEVEL_CLAMP);
}

__device__ __forceinline__ int dequant_p(int c, int ls, int dadd, int dsh) {
  return (c * ls + dadd) >> dsh;
}

// a 4x4 block of bytes at pitch p in shared memory, one 32-bit word a row
__device__ __forceinline__ void load4x4_shared(const uint8_t* s, int p,
                                               int* x) {
#pragma unroll
  for (int i = 0; i < 4; i++) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(s + i * p);
#pragma unroll
    for (int j = 0; j < 4; j++) x[4 * i + j] = (w >> (8 * j)) & 0xFF;
  }
}

__device__ __forceinline__ void store4x4_shared(uint8_t* s, int p,
                                                const int* x) {
#pragma unroll
  for (int i = 0; i < 4; i++)
    *reinterpret_cast<uint32_t*>(s + i * p) =
        static_cast<uint32_t>(x[4 * i]) | (x[4 * i + 1] << 8) |
        (x[4 * i + 2] << 16) | (static_cast<uint32_t>(x[4 * i + 3]) << 24);
}

__device__ __forceinline__ uint32_t pack_i16(int a, int b) {
  return (static_cast<uint32_t>(a) & 0xFFFFu) | (static_cast<uint32_t>(b) << 16);
}

// A block's levels in scan order as one 32-byte lv slot (two 16-byte
// stores): SKIP leaves out the first scan position (DC-less blocks), the
// tail zero-filled; the scan order is folded at compile time.
template <bool SKIP>
__device__ __forceinline__ void store_slot(uint4* slot, const int* acl) {
  uint32_t w[8];
#pragma unroll
  for (int k = 0; k < 8; k++) {
    const int p0 = 2 * k + SKIP, p1 = 2 * k + 1 + SKIP;
    w[k] = pack_i16(acl[zz_raster(p0)], p1 < 16 ? acl[zz_raster(p1)] : 0);
  }
  slot[0] = make_uint4(w[0], w[1], w[2], w[3]);
  slot[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// Copy a rows x (PER pieces of T) rectangle between global memory (pitch
// gp) and a shared stage (pitch sp, rows 16-byte aligned), by nt threads;
// IN: global -> shared. PER 0: ``per`` pieces, known only at run time.
template <typename T, int PER, bool IN>
__device__ __forceinline__ void copy_rect(uint8_t* s, int sp, uint8_t* g,
                                          int gp, int rows, int per, int tid,
                                          int nt) {
  const int n = PER ? PER : per;
  for (int i = tid; i < rows * n; i += nt) {
    const int y = i / n, k = i - y * n;
    T* a = reinterpret_cast<T*>(s + y * sp) + k;
    T* b = reinterpret_cast<T*>(g + static_cast<size_t>(y) * gp) + k;
    if (IN) *a = *b; else *b = *a;
  }
}

// A rows x bytes rectangle in the widest pieces (16, 8, 4 or 1 bytes) its
// global start, pitch and width allow; FULL is a whole block's width,
// which takes a division-free index (a narrower one, a row's last block,
// takes 4- or 1-byte pieces).
template <bool IN, int FULL>
__device__ __forceinline__ void stage_rect(uint8_t* s, int sp,
                                           const uint8_t* g_, int gp,
                                           int rows, int bytes, int tid,
                                           int nt) {
  uint8_t* g = const_cast<uint8_t*>(g_);
  const unsigned a = static_cast<unsigned>(reinterpret_cast<uintptr_t>(g)) |
                     static_cast<unsigned>(gp) | static_cast<unsigned>(bytes);
  if (bytes == FULL && (a & 15) == 0)
    copy_rect<uint4, FULL / 16, IN>(s, sp, g, gp, rows, 0, tid, nt);
  else if (bytes == FULL && (a & 7) == 0)
    copy_rect<uint2, FULL / 8, IN>(s, sp, g, gp, rows, 0, tid, nt);
  else if ((a & 3) == 0)
    copy_rect<uint32_t, 0, IN>(s, sp, g, gp, rows, bytes / 4, tid, nt);
  else
    copy_rect<uint8_t, 0, IN>(s, sp, g, gp, rows, bytes, tid, nt);
}
