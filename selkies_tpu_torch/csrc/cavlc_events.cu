// K3 cavlc_events: the CAVLC (payload, nbits) slots of every 4x4 block.
//
// Replaces selkies_tpu/ops/h264_planes.py:cavlc_events_planes, _nc_planes
// and _lut (and the block-grid gates of h264_encode_yuv /
// h264_encode_p_yuv), slot for slot: each block writes
// [coeff_token, 3 trailing-one signs, mc levels, total_zeros, mc-1
// run_befores] at its fixed offset in the MB's slot array, payload zeroed
// where nbits is.
//
// Bound on the H100: bytes at 1080p (~7 MB of levels in, 8160 MBs x 876
// slots x 5 bytes = ~36 MB of events out); per block the level suffix_len
// chain and the run_before zeros_left chain are serial and stay so (one
// thread walks them in slot order, as the reference's lax.scans do).
// Design: one warp per macroblock, one lane per block (27 in I frames:
// luma DC, 16 luma AC, 2 chroma DC, 8 chroma AC; 26 in P). nC comes from the
// gated total-coeff counts of the left and upper neighbours, recounted from
// the level array (left neighbours of the first column of blocks sit in
// the previous MB; the MB row above is another slice, so never used).
#include "h264_common.cuh"

__device__ __forceinline__ int count_nz(const int16_t* c, int mc) {
  int n = 0;
  for (int k = 0; k < mc; k++) n += c[k] != 0;
  return n;
}

__device__ __forceinline__ void level_event(int lc, int sl, int* p, int* n) {
  if (sl == 0) {
    if (lc < 14) { *p = 1; *n = lc + 1; }
    else if (lc < 30) { *p = (1 << 4) | (lc - 14); *n = 19; }
    else { *p = (1 << 12) | (lc - 30); *n = 28; }
  } else {
    const int prefix = lc >> sl;
    if (prefix < 15) {
      *p = (1 << sl) | (lc & ((1 << sl) - 1));
      *n = prefix + 1 + sl;
    } else {
      *p = (1 << 12) | (lc - (15 << sl));
      *n = 28;
    }
  }
}

__device__ __forceinline__ void emit(int* pay, uint8_t* nb, int s, int p,
                                     int n) {
  pay[s] = n > 0 ? p : 0;
  nb[s] = static_cast<uint8_t>(n);
}

// One block: coefficients ``c`` (mc of them, scan order), context nc
// (ignored for chroma DC), gate (false: every slot carries 0 bits).
__device__ void cavlc_block(const int16_t* c, int mc, int nc, bool chroma_dc,
                            bool gate, int* pay, uint8_t* nb) {
  const int S = 2 * mc + 4;
  if (!gate) {
    for (int s = 0; s < S; s++) emit(pay, nb, s, 0, 0);
    return;
  }
  int lv[16], pv[16], tc = 0;
  for (int k = mc - 1; k >= 0; k--)
    if (c[k] != 0) { lv[tc] = c[k]; pv[tc] = k; tc++; }
  for (int k = tc; k < 16; k++) { lv[k] = 0; pv[k] = 0; }
  int t1 = 0;
  while (t1 < 3 && t1 < tc && (lv[t1] == 1 || lv[t1] == -1)) t1++;

  // coeff_token
  int v;
  if (chroma_dc) {
    v = K_CDC[t1 * 5 + tc];
  } else {
    const int ctx = nc < 2 ? 0 : (nc < 4 ? 1 : (nc < 8 ? 2 : 3));
    v = K_CT[(ctx * 4 + t1) * 17 + tc];
  }
  emit(pay, nb, 0, v & 0xFFFF, v >> 16);
  // trailing-one signs
  for (int k = 0; k < 3; k++)
    emit(pay, nb, 1 + k, lv[k] < 0 ? 1 : 0, k < t1 ? 1 : 0);
  // levels, suffix_len chain
  int sl = (tc > 10 && t1 < 3) ? 1 : 0;
  for (int j = 0; j < mc; j++) {
    const int idx = t1 + j;
    if (idx < tc) {
      const int level = lv[idx];
      int lc = level > 0 ? 2 * level - 2 : -2 * level - 1;
      if (j == 0 && t1 < 3) lc -= 2;
      int p, n;
      level_event(lc, sl, &p, &n);
      int nsl = sl < 1 ? 1 : sl;
      const int al = level < 0 ? -level : level;
      if (al > (3 << (nsl - 1)) && nsl < 6) nsl++;
      sl = nsl;
      emit(pay, nb, 4 + j, p, n);
    } else {
      emit(pay, nb, 4 + j, 0, 0);
    }
  }
  // total_zeros
  const int tz = tc > 0 ? pv[0] + 1 - tc : 0;
  if (tc > 0 && tc < mc) {
    v = chroma_dc ? K_TZC[clampi(tc - 1, 0, 2) * 4 + clampi(tz, 0, 3)]
                  : K_TZ[clampi(tc - 1, 0, 14) * 16 + clampi(tz, 0, 15)];
    emit(pay, nb, 4 + mc, v & 0xFFFF, v >> 16);
  } else {
    emit(pay, nb, 4 + mc, 0, 0);
  }
  // run_before, zeros_left chain
  int zeros_left = tz;
  for (int i = 0; i < mc - 1; i++) {
    const bool in_run = i < tc - 1;
    const int run = clampi(pv[i] - pv[i + 1] - 1, 0, 14);
    if (in_run && zeros_left > 0) {
      const int zl = clampi((zeros_left < 7 ? zeros_left : 7) - 1, 0, 6);
      v = K_RB[zl * 15 + run];
      emit(pay, nb, 5 + mc + i, v & 0xFFFF, v >> 16);
    } else {
      emit(pay, nb, 5 + mc + i, 0, 0);
    }
    if (in_run) zeros_left -= run;
  }
}

__device__ __forceinline__ const int16_t* blk(const int16_t* lv, int r, int m,
                                              int M, int slot) {
  return lv + ((static_cast<size_t>(r) * M + m) * N_BLOCKS + slot) * 16;
}

// gated total-coeff count of luma block ``b`` (raster) of MB m
__device__ __forceinline__ int luma_tc(const int16_t* lv, const int* cbp,
                                       int r, int m, int M, int b, int mc,
                                       bool intra) {
  const int cb = cbp[r * M + m];
  const int g8 = ((b >> 2) >> 1) * 2 + ((b & 3) >> 1);
  const bool gate = intra ? (cb & 15) != 0 : ((cb >> g8) & 1) != 0;
  return gate ? count_nz(blk(lv, r, m, M, 1 + K_CODING_OF_RASTER[b]), mc) : 0;
}

// gated total-coeff count of chroma AC block q of component c of MB m
__device__ __forceinline__ int chroma_tc(const int16_t* lv, const int* cbp,
                                         int r, int m, int M, int c, int q) {
  return (cbp[r * M + m] >> 4) == 2
             ? count_nz(blk(lv, r, m, M, 19 + c * 4 + q), 15) : 0;
}

__device__ __forceinline__ int nc_combine(bool a, int na, bool b, int nb) {
  if (a && b) return (na + nb + 1) >> 1;
  if (a) return na;
  if (b) return nb;
  return 0;
}

__global__ void cavlc_events_kernel(const int16_t* __restrict__ lv,
                                    const int* __restrict__ cbp,
                                    int* __restrict__ ev_pay,
                                    uint8_t* __restrict__ ev_nb, int R, int M,
                                    int intra) {
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (g >= R * M || lane >= N_BLOCKS) return;
  const int r = g / M, m = g % M;
  const int SB = intra ? 876 : 872;
  int* pay = ev_pay + static_cast<size_t>(g) * SB;
  uint8_t* nb = ev_nb + static_cast<size_t>(g) * SB;
  const int cbp_chroma = cbp[g] >> 4;
  if (lane == 0) {
    // luma DC (I only): nC of luma block (0, 0)
    if (!intra) return;
    const int nc = m > 0 ? luma_tc(lv, cbp, r, m - 1, M, 3, 15, true) : 0;
    cavlc_block(blk(lv, r, m, M, 0), 16, nc, false, true, pay, nb);
  } else if (lane <= 16) {
    const int k = lane - 1, b = K_SCAN_RASTER[k];
    const int by = b >> 2, bx = b & 3;
    const int mc = intra ? 15 : 16;
    const int base = intra ? 36 + 34 * k : 36 * k;
    const int cb = cbp[g];
    const bool gate = intra ? (cb & 15) != 0
                            : ((cb >> ((by >> 1) * 2 + (bx >> 1))) & 1) != 0;
    int na = 0, nbv = 0;
    const bool a = bx > 0 || m > 0, up = by > 0;
    if (bx > 0) na = luma_tc(lv, cbp, r, m, M, b - 1, mc, intra);
    else if (m > 0) na = luma_tc(lv, cbp, r, m - 1, M, by * 4 + 3, mc, intra);
    if (up) nbv = luma_tc(lv, cbp, r, m, M, b - 4, mc, intra);
    cavlc_block(blk(lv, r, m, M, lane), mc, nc_combine(a, na, up, nbv),
                false, gate, pay + base, nb + base);
  } else if (lane <= 18) {
    const int c = lane - 17;
    const int base = (intra ? 580 : 576) + 12 * c;
    cavlc_block(blk(lv, r, m, M, lane), 4, 0, true, cbp_chroma > 0,
                pay + base, nb + base);
  } else {
    const int cl = lane - 19, c = cl >> 2, q = cl & 3;
    const int by2 = q >> 1, bx2 = q & 1;
    const int base = (intra ? 604 : 600) + 34 * cl;
    int na = 0, nbv = 0;
    const bool a = bx2 > 0 || m > 0, up = by2 > 0;
    if (bx2 > 0) na = chroma_tc(lv, cbp, r, m, M, c, q - 1);
    else if (m > 0) na = chroma_tc(lv, cbp, r, m - 1, M, c, by2 * 2 + 1);
    if (up) nbv = chroma_tc(lv, cbp, r, m, M, c, q - 2);
    cavlc_block(blk(lv, r, m, M, lane), 15, nc_combine(a, na, up, nbv),
                false, cbp_chroma == 2, pay + base, nb + base);
  }
}

extern "C" int cavlc_events(const int16_t* lv, const int* cbp, int* ev_pay,
                            uint8_t* ev_nb, int R, int M, int intra,
                            void* stream) {
  const int per_block = 4;                     // one warp per MB
  const int blocks = (R * M + per_block - 1) / per_block;
  cavlc_events_kernel<<<blocks, 32 * per_block, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      lv, cbp, ev_pay, ev_nb, R, M, intra);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ K16
// cavlc_events444: the 4:4:4 layout. Replaces the per-component event
// loops of selkies_tpu/ops/h264_planes444.py:h264_encode_yuv444 and
// h264_encode_p_yuv444 (nC from _nc_planes of the component's own gated
// total-coeff plane, the DC block's nC = nc[0::4, 0::4], no chroma DC
// class). Bound: bytes (~71 MB of events out at 1080p). Design: one warp
// per (MB, component), one lane per block: I 17 (DC, 16 AC blocks of 15
// levels), P 16 (16 levels); gates from cbp's low four bits (I: the
// shared AC flag, P: the 8x8 group bits that cover every component).
__device__ __forceinline__ int tc444(const int16_t* lv, const int* cbp,
                                     int r, int m, int M, int c, int b,
                                     bool intra) {
  const int cb = cbp[r * M + m];
  const int g8 = ((b >> 2) >> 1) * 2 + ((b & 3) >> 1);
  const bool gate = intra ? (cb & 15) != 0 : ((cb >> g8) & 1) != 0;
  if (!gate) return 0;
  const int nblk = intra ? NB_I444 : NB_P444;
  const int slot = intra ? 17 * c + 1 + K_CODING_OF_RASTER[b]
                         : 16 * c + K_CODING_OF_RASTER[b];
  return count_nz(lv + ((static_cast<size_t>(r) * M + m) * nblk + slot) * 16,
                  intra ? 15 : 16);
}

__global__ void cavlc_events444_kernel(const int16_t* __restrict__ lv,
                                       const int* __restrict__ cbp,
                                       int* __restrict__ ev_pay,
                                       uint8_t* __restrict__ ev_nb, int R,
                                       int M, int intra) {
  const int lane = threadIdx.x & 31;
  const int wg = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int g = wg / 3, c = wg % 3;
  if (g >= R * M) return;
  const int r = g / M, m = g % M;
  const int SB = intra ? 1740 : 1728;
  const int nblk = intra ? NB_I444 : NB_P444;
  const size_t mb = static_cast<size_t>(g) * SB + (intra ? 580 : 576) * c;
  int* pay = ev_pay + mb;
  uint8_t* nb = ev_nb + mb;
  const int16_t* lv_mb = lv + static_cast<size_t>(g) * nblk * 16;
  if (intra && lane == 0) {
    // DC block: nC of block (0, 0), i.e. the left MB's block (0, 3)
    const int nc = m > 0 ? tc444(lv, cbp, r, m - 1, M, c, 3, true) : 0;
    cavlc_block(lv_mb + 17 * c * 16, 16, nc, false, true, pay, nb);
    return;
  }
  const int k = intra ? lane - 1 : lane;
  if (k < 0 || k >= 16) return;
  const int b = K_SCAN_RASTER[k];
  const int by = b >> 2, bx = b & 3;
  const int mc = intra ? 15 : 16;
  const int base = intra ? 36 + 34 * k : 36 * k;
  const int cb = cbp[g];
  const bool gate = intra ? (cb & 15) != 0
                          : ((cb >> ((by >> 1) * 2 + (bx >> 1))) & 1) != 0;
  int na = 0, nbv = 0;
  const bool a = bx > 0 || m > 0, up = by > 0;
  if (bx > 0) na = tc444(lv, cbp, r, m, M, c, b - 1, intra);
  else if (m > 0) na = tc444(lv, cbp, r, m - 1, M, c, by * 4 + 3, intra);
  if (up) nbv = tc444(lv, cbp, r, m, M, c, b - 4, intra);
  const int slot = intra ? 17 * c + 1 + k : 16 * c + k;
  cavlc_block(lv_mb + slot * 16, mc, nc_combine(a, na, up, nbv), false, gate,
              pay + base, nb + base);
}

extern "C" int cavlc_events444(const int16_t* lv, const int* cbp, int* ev_pay,
                               uint8_t* ev_nb, int R, int M, int intra,
                               void* stream) {
  const int per_block = 6;                     // two MBs, three warps each
  const int blocks = (3 * R * M + per_block - 1) / per_block;
  cavlc_events444_kernel<<<blocks, 32 * per_block, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      lv, cbp, ev_pay, ev_nb, R, M, intra);
  return static_cast<int>(cudaGetLastError());
}
