// What the Intra16x16 coders K2-I (mb_encode_i, csrc/mb_encode.cu) and
// K14 (mb_encode_i444, csrc/mb_encode444.cu) share: the DC quantisers of
// one QP, the 4x4 Hadamard by lanes, a right-edge block's AC path, and
// the DC / left-edge chain of one luma-style component cut to the terms
// that depend on the prediction, on 16 lanes, its records brought into
// shared memory by TMA bulk copies.
//
// The cut. Every row of the 4x4 Hadamard but the first sums to 0, so
// with the DC terms W of the 16 blocks, Hd = H (W - 16 pred J) H is H W H
// but for Hd00 = (HWH)00 - 256 pred, and Hd00 >> 1 = ((HWH)00 >> 1) - 128
// pred (256 pred is even): of the 16 DC levels only level 00 depends on
// pred, and H L H = Frest + level00 at every position, Frest the inverse
// of the other 15. A step is pred -> level00 -> the four dequantised DC
// terms of the right column (Frest + level00) -> the 16 right-edge
// pixels -> their sum -> the next pred.
#pragma once
#include "cluster.cuh"
#include "h264_common.cuh"

#define I_GROUP 8                    // MBs a bulk copy group of records

// _quant_dc_e and _dequant_ldc_e / _dequant_cdc_e of one QP, the table
// entries read once: level = clamp(sign (|y| mf + f2) >> sh); dequant
// (f ls + add) >> dsh, luma f 16V 2^(qp/6 - 6) for qp/6 >= 6 and
// (f 16V + 2^(5 - qp/6)) >> (6 - qp/6) below, chroma (f 16V 2^(qp/6)) >> 5.
struct QuantDC {
  int mf, f2, sh, ls, add, dsh;
};

__device__ __forceinline__ QuantDC quant_dc_consts(int qp, bool luma) {
  QuantDC q;
  const int qd = qp / 6, qm = qp % 6;
  q.mf = K_MF[qm * 3];
  q.sh = 16 + qd;
  q.f2 = 2 * ((1 << (15 + qd)) / 3);
  const int ls00 = 16 * K_V[qm * 3];
  if (luma) {
    q.ls = qd >= 6 ? ls00 * (1 << (qd - 6)) : ls00;
    q.add = qd >= 6 ? 0 : 1 << (5 - qd);
    q.dsh = qd >= 6 ? 0 : 6 - qd;
  } else {
    q.ls = ls00 * (1 << qd);
    q.add = 0;
    q.dsh = 5;
  }
  return q;
}

__device__ __forceinline__ int quant_dcq(int y, const QuantDC& q) {
  const int mag = ((y < 0 ? -y : y) * q.mf + q.f2) >> q.sh;
  return clampi(y < 0 ? -mag : mag, -LEVEL_CLAMP, LEVEL_CLAMP);
}

__device__ __forceinline__ int dequant_dcq(int f, const QuantDC& q) {
  return (f * q.ls + q.add) >> q.dsh;
}

// H4 x (rows ++++, ++--, +--+, +-+-) of four values
__device__ __forceinline__ void had4_vec(const int* d, int* r) {
  const int s0 = d[0] + d[1], s1 = d[2] + d[3], t0 = d[0] - d[1],
            t1 = d[2] - d[3];
  r[0] = s0 + s1;
  r[1] = s0 - s1;
  r[2] = t0 - t1;
  r[3] = t0 + t1;
}

// one butterfly step over lanes ``m`` apart (natural Hadamard order):
// the lane with bit m clear gets v + partner, the other partner - v
__device__ __forceinline__ int butterfly(unsigned mask, int v, int m,
                                         bool hi) {
  const int p = __shfl_xor_sync(mask, v, m);
  return hi ? p - v : v + p;
}

// the AC path of an intra block down to its inverse's right column:
// fwd, quant (intra), dequant, the inverse's column 3 rows -> e[i] + 32
__device__ __forceinline__ void intra_edge(const int* x, const QuantP& q,
                                           int* e) {
  int w[16], d[16];
  fwd4(x, w);
  d[0] = 0;
#pragma unroll
  for (int k = 1; k < 16; k++)
    d[k] = dequant_p(quant_p(w[k], q.mf[pos_cls(k)], q.f, q.qbits),
                     q.ls[pos_cls(k)], q.dadd, q.dsh);
  int f[4];
#pragma unroll
  for (int i = 0; i < 4; i++)
    f[i] = (d[4 * i] + d[4 * i + 2]) - (d[4 * i + 1] + (d[4 * i + 3] >> 1));
  const int g0 = f[0] + f[2], g1 = f[0] - f[2], g2 = (f[1] >> 1) - f[3],
            g3 = f[1] + (f[3] >> 1);
  e[0] = g0 + g3 + 32;
  e[1] = g1 + g2 + 32;
  e[2] = g1 - g2 + 32;
  e[3] = g0 - g3 + 32;
}

// zigzag position of raster position k (K_INV_ZIGZAG, as nibbles)
__device__ __forceinline__ int zz_pos(int k) {
  return static_cast<int>((0xfea9db83c7426510ULL >> (4 * k)) & 15);
}

// Hadamard order of natural lane p: H4's row sig(p) comes out at lane p
__device__ __forceinline__ int sig(int p) { return (0x2130 >> (4 * p)) & 15; }

// four bytes of a word
__device__ __forceinline__ void bytes4(unsigned w, int* x) {
#pragma unroll
  for (int j = 0; j < 4; j++) x[j] = (w >> (8 * j)) & 0xFF;
}

// The pred-free DC terms of a (component, MB) on its four lanes of a
// warp, lane ``by`` a row of blocks with their DC sums ``dcs``: H W H by
// rows in the lane and butterflies down the column (lane p then holds
// H's row sig(p)) into ``h``; the pred-free levels (00 left out) and
// their inverse Frest (the same butterflies on rows in H order give
// rows in natural order) into ``s``. Every lane of the warp takes part.
__device__ __forceinline__ void dc_rows(const int* dcs, int by,
                                        const QuantDC& q, int* h, int* s) {
  const unsigned fm = 0xffffffffu;
  int l[4];
  had4_vec(dcs, h);
#pragma unroll
  for (int k = 0; k < 4; k++) {
    h[k] = butterfly(fm, h[k], 1, by & 1);
    h[k] = butterfly(fm, h[k], 2, by & 2);
  }
#pragma unroll
  for (int k = 0; k < 4; k++)
    l[k] = by == 0 && k == 0 ? 0 : quant_dcq(h[k] >> 1, q);
  had4_vec(l, s);
#pragma unroll
  for (int k = 0; k < 4; k++) {
    s[k] = butterfly(fm, s[k], 1, by & 1);
    s[k] = butterfly(fm, s[k], 2, by & 2);
  }
}

// The MB's DC terms on its 16 lanes of a warp, lane b the raster block b
// with its DC term ``w0``: H W H by butterflies (lane (p, q) then holds
// H's (sig(p), sig(q))), the pred-free level there (0 at lane 0) into
// ``lvl``, and Frest back in natural order into ``f``. Every lane of the
// warp takes part.
__device__ __forceinline__ void dc_lanes(int w0, int b, const QuantDC& q,
                                         int& lvl, int& f) {
  int v = w0;
#pragma unroll
  for (int k = 1; k < 16; k <<= 1) v = butterfly(0xffffffffu, v, k, b & k);
  lvl = b == 0 ? 0 : quant_dcq(v >> 1, q);
  f = lvl;
#pragma unroll
  for (int k = 1; k < 16; k <<= 1) f = butterfly(0xffffffffu, f, k, b & k);
}

// The row's chain records (``ints`` ints an MB, M MBs back to back from
// ``src``, 16-byte aligned) into shared ``rec`` by TMA bulk copies,
// I_GROUP MBs a copy, each completing on its mbarrier of ``bars``
// (initialised to one arrival). One thread issues them all.
__device__ __forceinline__ void load_records(int* rec, const int* src,
                                             unsigned long long* bars, int M,
                                             int ints) {
  const int groups = (M + I_GROUP - 1) / I_GROUP;
  for (int g = 0; g < groups; g++) {
    const int n = M - g * I_GROUP < I_GROUP ? M - g * I_GROUP : I_GROUP;
    const unsigned bar = smem_u32(bars + g), bytes = 4 * ints * n;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(smem_u32(rec + ints * I_GROUP * g)),
           "l"(src + ints * I_GROUP * g), "r"(bytes), "r"(bar)
        : "memory");
  }
}

// The chain of one luma-style component along a row on 16 lanes, lane k
// the right-edge pixel k (block row k >> 2): each step pred -> level00
// (in every lane) -> the lane's block row's DC term -> its edge pixel ->
// the sum over the lanes (one warp reduction) -> the next pred, the next
// MB's record loaded ahead. Records are REC ints an MB; ``e``, ``f`` and
// ``h`` point at MB 0's right edge's inverse + 32 (16, by block row),
// Frest's right column (4) and (HWH)00 >> 1. Lane 0 stores each MB's
// word pred | (level00 + 4096) << 16 at out[OS * m].
template <int REC, int OS>
__device__ __forceinline__ void dc_chain(const int* e_rec, const int* f_rec,
                                         const int* h_rec,
                                         unsigned long long* bars, int M,
                                         int* out, int k, const QuantDC& q) {
  int pred = 128;
  mbar_wait(bars, 0);
  int e = e_rec[k], f3 = f_rec[k >> 2], h00 = h_rec[0];
  for (int m0 = 0; m0 < M; m0 += I_GROUP) {
    // the next group's records, which the group's last step loads ahead
    if (m0 + I_GROUP < M) mbar_wait(bars + m0 / I_GROUP + 1, 0);
#pragma unroll
    for (int j = 0; j < I_GROUP; j++) {
      const int m = m0 + j;
      if (m >= M) break;
      const int n = REC * (m + 1 < M ? m + 1 : m);
      const int en = e_rec[n + k], fn = f_rec[n + (k >> 2)], hn = h_rec[n];
      const int dl = quant_dcq(h00 - 128 * pred, q);
      const int px = clip1(pred + ((e + dequant_dcq(f3 + dl, q)) >> 6));
      const int s = __reduce_add_sync(0xFFFFu, px);
      if (k == 0) out[OS * m] = pred | ((dl + 4096) << 16);
      pred = (s + 8) >> 4;
      e = en;
      f3 = fn;
      h00 = hn;
    }
  }
}
