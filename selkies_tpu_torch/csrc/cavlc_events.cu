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
// Design: one block of 128 threads per 4 consecutive MBs (g = r * M + m).
// The block stages the 4 MBs' levels (864 B each) and the left neighbour
// of the first (when it is in the same row) in shared memory with 16-byte
// loads, counts the gated total-coeff of every luma and chroma AC block
// once into shared memory (nC's left and upper neighbours read from
// there), and builds the 4 MBs' slots in a zeroed shared stage: the
// blocks whose gate is on (luma DC of I always, luma AC by cbp, chroma DC
// / AC by cbp's chroma bits) are compacted onto the first threads, one
// block a thread, and a gated-off block writes nothing. The stage then
// leaves with 16-byte coalesced stores: with 4 MBs a block both spans
// start 16-byte aligned (SB % 4 == 0). cavlc_block walks the coefficients
// in place, so no level or position array lands in local memory. (The
// code tables stay in the constant bank: a copy in shared memory a block
// measured slower on the H100, 0.036 against 0.029 ms at 1080p I.)
#include "h264_common.cuh"

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

// slot s <- (p, n), payload zeroed where n is; ZEROED: the slots are known
// to be zero already, so a slot that carries no bits is not written
template <bool ZEROED>
__device__ __forceinline__ void emit(int* pay, uint8_t* nb, int s, int p,
                                     int n) {
  if (ZEROED && n <= 0) return;
  pay[s] = n > 0 ? p : 0;
  nb[s] = static_cast<uint8_t>(n);
}

// One block: coefficients ``c`` (mc of them, scan order), context nc
// (ignored for chroma DC), gate (false: every slot carries 0 bits). Two
// walks over c from its last coefficient, with no arrays: the first finds
// TotalCoeff, TrailingOnes and the last nonzero position, the second
// emits the trailing-one signs, the levels (suffix_len chain) and the
// run_befores (zeros_left chain) at their slots.
template <bool ZEROED>
__device__ void cavlc_block(const int16_t* c, int mc, int nc, bool chroma_dc,
                            bool gate, int* pay, uint8_t* nb) {
  const int S = 2 * mc + 4;
  if (!gate) {
    if (!ZEROED)
      for (int s = 0; s < S; s++) emit<false>(pay, nb, s, 0, 0);
    return;
  }
  int tc = 0, t1 = 0, last = 0;
  bool trailing = true;
  for (int k = mc - 1; k >= 0; k--) {
    const int v = c[k];
    if (v == 0) continue;
    if (tc == 0) last = k;
    if (trailing && tc < 3 && (v == 1 || v == -1)) t1++;
    else trailing = false;
    tc++;
  }
  // coeff_token
  int v;
  if (chroma_dc) {
    v = K_CDC[t1 * 5 + tc];
  } else {
    const int ctx = nc < 2 ? 0 : (nc < 4 ? 1 : (nc < 8 ? 2 : 3));
    v = K_CT[(ctx * 4 + t1) * 17 + tc];
  }
  emit<ZEROED>(pay, nb, 0, v & 0xFFFF, v >> 16);
  // total_zeros
  const int tz = tc > 0 ? last + 1 - tc : 0;
  if (tc > 0 && tc < mc) {
    v = chroma_dc ? K_TZC[clampi(tc - 1, 0, 2) * 4 + clampi(tz, 0, 3)]
                  : K_TZ[clampi(tc - 1, 0, 14) * 16 + clampi(tz, 0, 15)];
    emit<ZEROED>(pay, nb, 4 + mc, v & 0xFFFF, v >> 16);
  } else {
    emit<ZEROED>(pay, nb, 4 + mc, 0, 0);
  }
  // signs, levels and run_befores, nonzero by nonzero from the end
  int sl = (tc > 10 && t1 < 3) ? 1 : 0;
  int idx = 0, prev = 0, zeros_left = tz;
  for (int k = mc - 1; k >= 0; k--) {
    const int level = c[k];
    if (level == 0) continue;
    if (idx < t1) {
      emit<ZEROED>(pay, nb, 1 + idx, level < 0 ? 1 : 0, 1);
    } else {
      const int j = idx - t1;
      int lc = level > 0 ? 2 * level - 2 : -2 * level - 1;
      if (j == 0 && t1 < 3) lc -= 2;
      int p, n;
      level_event(lc, sl, &p, &n);
      int nsl = sl < 1 ? 1 : sl;
      const int al = level < 0 ? -level : level;
      if (al > (3 << (nsl - 1)) && nsl < 6) nsl++;
      sl = nsl;
      emit<ZEROED>(pay, nb, 4 + j, p, n);
    }
    if (idx > 0) {
      // run_before of nonzero idx - 1: the zeros between it and this one
      const int run = clampi(prev - k - 1, 0, 14);
      if (zeros_left > 0) {
        const int zl = clampi((zeros_left < 7 ? zeros_left : 7) - 1, 0, 6);
        v = K_RB[zl * 15 + run];
        emit<ZEROED>(pay, nb, 5 + mc + idx - 1, v & 0xFFFF, v >> 16);
      } else {
        emit<ZEROED>(pay, nb, 5 + mc + idx - 1, 0, 0);
      }
      zeros_left -= run;
    }
    prev = k;
    idx++;
  }
  if (!ZEROED) {
    for (int k = t1; k < 3; k++) emit<false>(pay, nb, 1 + k, 0, 0);
    for (int j = tc - t1; j < mc; j++) emit<false>(pay, nb, 4 + j, 0, 0);
    for (int i = tc > 0 ? tc - 1 : 0; i < mc - 1; i++)
      emit<false>(pay, nb, 5 + mc + i, 0, 0);
  }
}

__device__ __forceinline__ int nc_combine(bool a, int na, bool b, int nb) {
  if (a && b) return (na + nb + 1) >> 1;
  if (a) return na;
  if (b) return nb;
  return 0;
}

// the raster index of the 4x4 block at coding (scan) index k, and back:
// bits 1 and 2 of the index trade places
__device__ __forceinline__ int scan_raster(int k) {
  return (k & 9) | ((k & 2) << 1) | ((k & 4) >> 1);
}

constexpr int K3_MBS = 4;         // MBs a block (a multiple of 4)
constexpr int K3_THREADS = 128;   // >= K3_MBS * N_BLOCKS
constexpr int LV_MB = N_BLOCKS * 16;                  // levels an MB
constexpr int SB_MAX = 876;                           // I slots an MB

// K3 and K16's shared steps, T threads a block: the stage zeroed (n
// slots of payload and nb), the threads whose ``on`` is set compacted in
// thread order into work[0 .. count - 1] (two block barriers; -> count),
// and the stage out to ev_pay / ev_nb with 16-byte stores (both spans
// start 16-byte aligned, n % 4 == 0)
template <int T>
__device__ __forceinline__ void zero_stage(int* pay_s, uint8_t* nb_s, int n,
                                           int tid) {
  uint4* zp = reinterpret_cast<uint4*>(pay_s);
  for (int i = tid; i < n / 4; i += T) zp[i] = make_uint4(0u, 0u, 0u, 0u);
  uint4* zn = reinterpret_cast<uint4*>(nb_s);
  for (int i = tid; i < (n + 15) / 16; i += T)
    zn[i] = make_uint4(0u, 0u, 0u, 0u);
}

template <int T>
__device__ __forceinline__ int compact(bool on, short* work, int* warp_n,
                                       int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  const unsigned bal = __ballot_sync(0xffffffffu, on);
  if (lane == 0) warp_n[warp] = __popc(bal);
  __syncthreads();
  int rank = __popc(bal & ((1u << lane) - 1u)), count = 0;
  for (int w = 0; w < T / 32; w++) {
    if (w < warp) rank += warp_n[w];
    count += warp_n[w];
  }
  if (on) work[rank] = static_cast<short>(tid);
  __syncthreads();
  return count;
}

template <int T>
__device__ __forceinline__ void store_stage(int* ev_pay, uint8_t* ev_nb,
                                            const int* pay_s,
                                            const uint8_t* nb_s, int n,
                                            int tid) {
  uint4* dp = reinterpret_cast<uint4*>(ev_pay);
  const uint4* sp = reinterpret_cast<const uint4*>(pay_s);
  for (int i = tid; i < n / 4; i += T) dp[i] = sp[i];
  uint4* dn = reinterpret_cast<uint4*>(ev_nb);
  const uint4* sn = reinterpret_cast<const uint4*>(nb_s);
  for (int i = tid; i < n / 16; i += T) dn[i] = sn[i];
  unsigned* dt = reinterpret_cast<unsigned*>(ev_nb);
  const unsigned* st = reinterpret_cast<const unsigned*>(nb_s);
  for (int i = n / 16 * 4 + tid; i < n / 4; i += T) dt[i] = st[i];
}

// nonzero int16 lanes among the first ``mc`` (15 or 16) of a 32-byte block
__device__ __forceinline__ int nz16(const int16_t* blk16, int mc) {
  const uint4 a = reinterpret_cast<const uint4*>(blk16)[0];
  uint4 b = reinterpret_cast<const uint4*>(blk16)[1];
  if (mc == 15) b.w &= 0xFFFFu;
  const unsigned z = 0u;
  return (__popc(__vcmpne2(a.x, z)) + __popc(__vcmpne2(a.y, z))
          + __popc(__vcmpne2(a.z, z)) + __popc(__vcmpne2(a.w, z))
          + __popc(__vcmpne2(b.x, z)) + __popc(__vcmpne2(b.y, z))
          + __popc(__vcmpne2(b.z, z)) + __popc(__vcmpne2(b.w, z))) >> 4;
}

__global__ void __launch_bounds__(K3_THREADS)
cavlc_events_kernel(const int16_t* __restrict__ lv,
                    const int* __restrict__ cbp, int* __restrict__ ev_pay,
                    uint8_t* __restrict__ ev_nb, int R, int M, int intra) {
  // MB j of the block at index j + 1; index 0 the first MB's left one
  __shared__ __align__(16) int16_t lvs[K3_MBS + 1][LV_MB];
  __shared__ __align__(16) int pay_s[K3_MBS * SB_MAX];
  __shared__ __align__(16) uint8_t nb_s[K3_MBS * SB_MAX];
  __shared__ uint8_t tc_s[K3_MBS + 1][24];   // luma raster 0-15, chroma AC
  __shared__ int cb_s[K3_MBS + 1];
  __shared__ short work[K3_MBS * N_BLOCKS];
  __shared__ int warp_n[K3_THREADS / 32];
  const int tid = threadIdx.x;
  const int SB = intra ? 876 : 872;
  const long long g0 = static_cast<long long>(blockIdx.x) * K3_MBS;
  const int nm = static_cast<int>(min(static_cast<long long>(K3_MBS),
                                      static_cast<long long>(R) * M - g0));
  const int first = g0 % M ? -1 : 0;   // stage the left neighbour too
  {
    const uint4* src = reinterpret_cast<const uint4*>(lv + (g0 + first)
                                                      * LV_MB);
    uint4* dst = reinterpret_cast<uint4*>(&lvs[1 + first][0]);
    const int n16 = (nm - first) * (LV_MB / 8);
    for (int i = tid; i < n16; i += K3_THREADS) dst[i] = src[i];
    zero_stage<K3_THREADS>(pay_s, nb_s, nm * SB, tid);
    if (tid < nm - first) cb_s[1 + first + tid] = cbp[g0 + first + tid];
  }
  __syncthreads();
  // gated total-coeff counts: 16 luma (raster) and 8 chroma AC blocks of
  // every staged MB
  for (int i = tid; i < (nm - first) * 24; i += K3_THREADS) {
    const int jj = 1 + first + i / 24, b = i % 24;
    const int cb = cb_s[jj];
    int n = 0;
    if (b < 16) {
      const int g8 = ((b >> 2) >> 1) * 2 + ((b & 3) >> 1);
      if (intra ? (cb & 15) != 0 : ((cb >> g8) & 1) != 0)
        n = nz16(&lvs[jj][(1 + scan_raster(b)) * 16], intra ? 15 : 16);
    } else if ((cb >> 4) == 2) {
      n = nz16(&lvs[jj][(19 + (b - 16)) * 16], 15);
    }
    tc_s[jj][b] = static_cast<uint8_t>(n);
  }
  // the blocks whose gate is on, compacted onto the first threads
  bool on = false;
  if (tid < nm * N_BLOCKS) {
    const int j = tid / N_BLOCKS, blk = tid % N_BLOCKS;
    const int cb = cb_s[1 + j], cc = cb >> 4;
    if (blk == 0) {
      on = intra;
    } else if (blk <= 16) {
      const int b = scan_raster(blk - 1);
      const int g8 = ((b >> 2) >> 1) * 2 + ((b & 3) >> 1);
      on = intra ? (cb & 15) != 0 : ((cb >> g8) & 1) != 0;
    } else {
      on = blk <= 18 ? cc > 0 : cc == 2;
    }
  }
  const int count = compact<K3_THREADS>(on, work, warp_n, tid);
  for (int t = tid; t < count; t += K3_THREADS) {
    const int item = work[t];
    const int j = item / N_BLOCKS, blk = item % N_BLOCKS;
    const bool left = (g0 + j) % M != 0;      // the left MB (m > 0)
    const uint8_t* tcs = tc_s[1 + j];
    const uint8_t* tcl = tc_s[j];
    // the block's coefficient count, nC and slot offset
    int mc, nc = 0, base;
    if (blk == 0) {
      // luma DC (I only): nC of luma block (0, 0)
      mc = 16;
      nc = left ? tcl[3] : 0;
      base = 0;
    } else if (blk <= 16) {
      const int k = blk - 1, b = scan_raster(k);
      const int by = b >> 2, bx = b & 3;
      const int na = bx > 0 ? tcs[b - 1] : (left ? tcl[by * 4 + 3] : 0);
      mc = intra ? 15 : 16;
      nc = nc_combine(bx > 0 || left, na, by > 0, by > 0 ? tcs[b - 4] : 0);
      base = intra ? 36 + 34 * k : 36 * k;
    } else if (blk <= 18) {
      mc = 4;
      base = (intra ? 580 : 576) + 12 * (blk - 17);
    } else {
      const int cl = blk - 19, c = cl >> 2, q = cl & 3;
      const int by2 = q >> 1, bx2 = q & 1;
      const int na = bx2 > 0 ? tcs[16 + 4 * c + q - 1]
                             : (left ? tcl[16 + 4 * c + by2 * 2 + 1] : 0);
      mc = 15;
      nc = nc_combine(bx2 > 0 || left, na, by2 > 0,
                      by2 > 0 ? tcs[16 + 4 * c + q - 2] : 0);
      base = (intra ? 604 : 600) + 34 * cl;
    }
    cavlc_block<true>(lvs[1 + j] + blk * 16, mc, nc, blk == 17 || blk == 18,
                      true, pay_s + j * SB + base, nb_s + j * SB + base);
  }
  __syncthreads();
  store_stage<K3_THREADS>(ev_pay + g0 * SB, ev_nb + g0 * SB, pay_s, nb_s,
                          nm * SB, tid);
}

extern "C" int cavlc_events(const int16_t* lv, const int* cbp, int* ev_pay,
                            uint8_t* ev_nb, int R, int M, int intra,
                            void* stream) {
  if (R <= 0 || M <= 0) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte staging loads and stores
  if ((reinterpret_cast<uintptr_t>(lv) | reinterpret_cast<uintptr_t>(ev_pay)
       | reinterpret_cast<uintptr_t>(ev_nb)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const long long mbs = static_cast<long long>(R) * M;
  cavlc_events_kernel<<<static_cast<unsigned>((mbs + K3_MBS - 1) / K3_MBS),
                        K3_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      lv, cbp, ev_pay, ev_nb, R, M, intra);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ K16
// cavlc_events444: the 4:4:4 layout. Replaces the per-component event
// loops of selkies_tpu/ops/h264_planes444.py:h264_encode_yuv444 and
// h264_encode_p_yuv444 (nC from _nc_planes of the component's own gated
// total-coeff plane, the DC block's nC = nc[0::4, 0::4], no chroma DC
// class): per MB three components, each (I) a DC block of 16 levels and
// 16 AC blocks of 15, or (P) 16 blocks of 16; gates from cbp's low four
// bits (I: the shared AC flag, P: the 8x8 group bits that cover every
// component).
//
// Bound on the H100: bytes (~13 MB of levels in, 8160 MBs x 1740 / 1728
// slots x 5 bytes = ~71 MB of events out at 1080p).
// What held the first design back: one warp per (MB, component)
// and one lane per block, so 15-16 of every 32 lanes idled; each lane
// wrote its block's slots straight to device memory, lanes 34 slots
// apart (every 4- and 1-byte store of a warp touching ~17 sectors, every
// zero slot written alone); and each lane recounted its left and upper
// neighbours' total-coeff from device memory, byte by byte, so the
// levels were read up to three times.
// Design now: K3's (above) on the 4:4:4 layout. One block of 256 threads
// per 4 consecutive MBs stages their levels (1632 / 1536 B each) and the
// left neighbour of the first (when it is in the same row) with 16-byte
// loads, counts the gated total-coeff of every (MB, component, 4x4
// block) once into shared memory (nC's neighbours read from there),
// compacts the gated-on blocks onto the first threads with a ballot and
// builds the 4 MBs' slots with cavlc_block<true> in a zeroed shared stage
// (34.8 KB), which leaves with 16-byte coalesced stores: 4 x 1740 and
// 4 x 1728 bytes of nb are multiples of 16, so every block's spans start
// 16-byte aligned. ~43 KB of static shared memory a block: 5 blocks an
// SM. Nothing else was tried: this design came within 2x of the bound
// (0.046 ms at 1080p I on the H100) on its first run.
constexpr int K16_MBS = 4;          // MBs a block (nb spans 16-byte aligned)
constexpr int K16_THREADS = 256;    // >= K16_MBS * NB_I444
constexpr int K16_SB_MAX = 1740;    // I slots an MB

__global__ void __launch_bounds__(K16_THREADS)
cavlc_events444_kernel(const int16_t* __restrict__ lv,
                       const int* __restrict__ cbp, int* __restrict__ ev_pay,
                       uint8_t* __restrict__ ev_nb, int R, int M, int intra) {
  // MB j of the block at index j + 1 (LVS levels each); index 0 the first
  // MB's left one
  __shared__ __align__(16) int16_t lvs[(K16_MBS + 1) * NB_I444 * 16];
  __shared__ __align__(16) int pay_s[K16_MBS * K16_SB_MAX];
  __shared__ __align__(16) uint8_t nb_s[K16_MBS * K16_SB_MAX];
  __shared__ uint8_t tc_s[K16_MBS + 1][48];   // component x raster block
  __shared__ int cb_s[K16_MBS + 1];
  __shared__ short work[K16_MBS * NB_I444];
  __shared__ int warp_n[K16_THREADS / 32];
  const int tid = threadIdx.x;
  const int SB = intra ? 1740 : 1728, NB = intra ? NB_I444 : NB_P444;
  const int LVS = NB * 16, mc = intra ? 15 : 16;
  const long long g0 = static_cast<long long>(blockIdx.x) * K16_MBS;
  const int nm = static_cast<int>(min(static_cast<long long>(K16_MBS),
                                      static_cast<long long>(R) * M - g0));
  const int first = g0 % M ? -1 : 0;   // stage the left neighbour too
  {
    const uint4* src = reinterpret_cast<const uint4*>(lv + (g0 + first)
                                                      * LVS);
    uint4* dst = reinterpret_cast<uint4*>(lvs + (1 + first) * LVS);
    const int n16 = (nm - first) * (LVS / 8);
    for (int i = tid; i < n16; i += K16_THREADS) dst[i] = src[i];
    zero_stage<K16_THREADS>(pay_s, nb_s, nm * SB, tid);
    if (tid < nm - first) cb_s[1 + first + tid] = cbp[g0 + first + tid];
  }
  __syncthreads();
  // gated total-coeff counts: 3 x 16 (raster) blocks of every staged MB
  for (int i = tid; i < (nm - first) * 48; i += K16_THREADS) {
    const int jj = 1 + first + i / 48, cb = i % 48;
    const int c = cb >> 4, b = cb & 15, cbv = cb_s[jj];
    const int g8 = ((b >> 2) >> 1) * 2 + ((b & 3) >> 1);
    int n = 0;
    if (intra ? (cbv & 15) != 0 : ((cbv >> g8) & 1) != 0)
      n = nz16(lvs + jj * LVS + ((intra ? 17 * c + 1 : 16 * c)
                                 + scan_raster(b)) * 16, mc);
    tc_s[jj][cb] = static_cast<uint8_t>(n);
  }
  // the blocks whose gate is on, compacted onto the first threads
  bool on = false;
  if (tid < nm * NB) {
    const int j = tid / NB, blk = tid % NB;
    const int cbv = cb_s[1 + j];
    if (intra) {
      on = blk % 17 == 0 || (cbv & 15) != 0;       // DC always
    } else {
      const int b = scan_raster(blk & 15);
      on = ((cbv >> (((b >> 2) >> 1) * 2 + ((b & 3) >> 1))) & 1) != 0;
    }
  }
  const int count = compact<K16_THREADS>(on, work, warp_n, tid);
  for (int t = tid; t < count; t += K16_THREADS) {
    const int item = work[t];
    const int j = item / NB, blk = item % NB;
    const bool left = (g0 + j) % M != 0;      // the left MB (m > 0)
    const int c = intra ? blk / 17 : blk >> 4;
    const int k = intra ? blk % 17 - 1 : blk & 15;   // -1: the DC block
    const uint8_t* tcs = tc_s[1 + j] + 16 * c;
    const uint8_t* tcl = tc_s[j] + 16 * c;
    int nc, base;
    if (k < 0) {
      // DC block: nC of block (0, 0), i.e. the left MB's block (0, 3)
      nc = left ? tcl[3] : 0;
      base = 580 * c;
    } else {
      const int b = scan_raster(k), by = b >> 2, bx = b & 3;
      const int na = bx > 0 ? tcs[b - 1] : (left ? tcl[by * 4 + 3] : 0);
      nc = nc_combine(bx > 0 || left, na, by > 0, by > 0 ? tcs[b - 4] : 0);
      base = intra ? 580 * c + 36 + 34 * k : 576 * c + 36 * k;
    }
    cavlc_block<true>(lvs + (1 + j) * LVS + blk * 16, k < 0 ? 16 : mc, nc,
                      false, true, pay_s + j * SB + base,
                      nb_s + j * SB + base);
  }
  __syncthreads();
  store_stage<K16_THREADS>(ev_pay + g0 * SB, ev_nb + g0 * SB, pay_s, nb_s,
                           nm * SB, tid);
}

extern "C" int cavlc_events444(const int16_t* lv, const int* cbp, int* ev_pay,
                               uint8_t* ev_nb, int R, int M, int intra,
                               void* stream) {
  if (R <= 0 || M <= 0) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte staging loads and stores
  if ((reinterpret_cast<uintptr_t>(lv) | reinterpret_cast<uintptr_t>(ev_pay)
       | reinterpret_cast<uintptr_t>(ev_nb)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const long long mbs = static_cast<long long>(R) * M;
  cavlc_events444_kernel<<<static_cast<unsigned>((mbs + K16_MBS - 1)
                                                 / K16_MBS),
                           K16_THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      lv, cbp, ev_pay, ev_nb, R, M, intra);
  return static_cast<int>(cudaGetLastError());
}
