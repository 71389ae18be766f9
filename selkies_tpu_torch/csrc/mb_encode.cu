// K2 mb_encode: per-macroblock transform / quant / dequant / recon for
// Intra_16x16 IDR frames (mb_encode_i) and P frames (mb_encode_p).
//
// Replaces selkies_tpu/ops/h264_planes.py:fwd4_planes, inv4_planes,
// _quant_plane, _dequant_plane, _quant_dc_e, _dequant_ldc_e, _dequant_cdc_e,
// _had2_parts, _had4_mb, _had2_mb, _merge_pixel_chroma, _dc_scan, the
// h264_encode_yuv / h264_encode_p_yuv bodies (quant_all, cdc_chain, cbp /
// coded gates with the motion vector, mvd against the left neighbour,
// deq_gated, chroma_recon), the MB header events of _assemble_frame /
// _assemble_p_frame, and the send-gated reference advance of
// engine/h264_encoder.py:build_h264_step_fn and build_h264_band_step_fn.
//
// Bound on the H100: I frames by bytes (planes in, levels, headers and
// the sent reference out, ~12 MB at 1080p: 3.7 us) and, below that, by
// the serial DC chain: each MB row's prediction runs left to right over
// its 120 MBs, about 20 dependent integer operations an MB once the chain
// is cut to the terms that depend on it (the I section below); P frames
// by bytes (cur + prediction planes in, reference + levels out, ~15 MB at
// 1080p: 4.6 us).
// I frames: the chains' inputs over the whole card, then the row's luma
// and chroma chains a block a row, then the coding over the whole card
// (the I section below).
// P frames: a block of 4 MBs of one row, 96 threads (a thread a 4x4
// block, luma and chroma in warps of their own, so no lane idles), the
// pixels staged in shared memory with 16-byte loads, the levels, the
// recon and the header slots leaving the block as whole contiguous runs
// rather than as two-byte and byte stores spread over 24 sectors a warp
// instruction. P frames predict from planes of their own (K5's output)
// when motion is on; with zero motion the prediction is the reference
// plane itself, which a block stages whole before it writes any recon,
// and blocks own disjoint MBs.
#include "intra_dc.cuh"

// ---------------------------------------------------------------- I frames
// Three grids a call, one after another.
//
// The chains carry only the terms that depend on the prediction: luma
// as csrc/intra_dc.cuh sets out (shared with K14). Chroma (2x2): only
// A + C and A - C carry the two halves' preds pt and pb, so a step is
// (pt, pb) -> levels 0 and 2 -> the right column's two dequantised DC
// terms -> 8 edge pixels -> pt, pb.
//
// 1. i_records_kernel: 4 lanes an MB (luma warps a lane a row of blocks,
//    chroma warps a lane a component's row), over the whole card: each
//    block's DC sum, the right-edge block's AC path down to its inverse's
//    right column, the pred-free Hadamard terms (within a lane along the
//    row, by shuffles down the column): each MB's chain record, the row's
//    records back to back at the start of the row's lv (which only the
//    third grid writes).
// 2. i_chain_kernel: a block a row. Its records into shared memory, then
//    luma on 16 lanes of one warp (a right-edge pixel a lane, summed by
//    one warp reduction), Cb and Cr on a lane each of another, the next
//    MB's record loaded ahead; each MB's outputs (pred and level00; pt,
//    pb and levels 0 and 2) as words in shared memory, then where its
//    header slots go (hdr_pay slots 0-4, rewritten by the third grid).
// 3. i_code_kernel: a block 4 MBs of a row, 96 threads (a thread a 4x4
//    block, as K2-P), over the whole card: the MBs staged in shared
//    memory with 16-byte loads, the whole transform again (AC levels out
//    as 32-byte slots, the inverse of the AC part), the DC levels and
//    Frest by butterflies across an MB's lanes, the chains' words, the
//    recon into the stage and out as 16-byte row pieces for sent rows,
//    the DC slots, cbp and the headers.
// Measured on the card (intra_probe.py): a chain step is set by its
// dependent integer operations; a chain on one lane was moved by the
// compiler to the uniform datapath (several times the latency), and a
// cluster a row (the records and outputs through distributed shared
// memory, the coding behind the chains) lost to the contention of the
// coding warps and to the row's records converging on one SM.
#define I_NB 4                       // MBs a tile, consecutive in one row
#define I_THREADS 96                 // 24 threads an MB of a tile
#define I_REC_MBS 16                 // MBs a block of the first grid
#define I_LS (16 * I_NB + 16)        // luma stage pitch (bytes)
#define I_CS (8 * I_NB + 16)         // chroma stage pitch
#define I_REC 48                     // ints of an MB's chain record

// an MB's record (ints): luma [0, 16) the right edge's inverse + 32
// (block row by: [4 by, 4 by + 4)), [16, 20) Frest's right column, 20
// (HWH)00 >> 1; chroma c at 24 + 12 c: [0, 8) the edge's inverse + 32
// (by2 4..), 8 A + C, 9 level 1, 10 A - C, 11 level 3. Its outputs
// (words of hdr_pay): 0 luma pred | (level00 + 4096) << 16; 1 + 2c
// chroma c's top pt | (level0 + 4096) << 16, 2 + 2c its bottom
// pb | (level2 + 4096) << 16.
struct IStage {
  uint8_t cur_y[16 * I_LS];          // the tile, then its recon
  uint8_t cur_c[2][8 * I_CS];
  alignas(16) int16_t dcs[I_NB][48];      // DC slots 0, 17, 18 of each MB
  int cbp_luma[I_NB], cac[I_NB], cdc[I_NB][2];
};

// The first grid: 16 MBs of a row a block of 128 threads, 4 lanes an MB:
// warps 0-1 luma (a lane a row of blocks), warps 2-3 chroma (a lane a
// component's row of two blocks), so no warp diverges on the plane; each
// MB's chain record into the row's lv (FAST as i_code_kernel: 16- and
// 8-byte row loads; else byte loads).
template <bool FAST>
__global__ void __launch_bounds__(128)
i_records_kernel(const uint8_t* __restrict__ yp,
                 const uint8_t* __restrict__ up,
                 const uint8_t* __restrict__ vp,
                 const int* __restrict__ qp_rows, int16_t* __restrict__ lv,
                 int M) {
  // the kernel before it (K1) has finished: no read comes before this
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.y, j = lane & 3;
  const int m = I_REC_MBS * blockIdx.x + 8 * (warp & 1) + (lane >> 2);
  const bool luma = warp < 2, on = m < M;
  const int W = 16 * M, W2 = 8 * M;
  const int qp = qp_rows[r];
  const int qpc = K_QPC[clampi(qp, 0, 51)];
  const QuantDC dy = quant_dc_consts(qp, true), dc = quant_dc_consts(qpc, false);
  // four rows of the MB: luma a row of blocks (16 bytes), chroma a
  // component's row of two blocks (8 bytes)
  unsigned q[4][4];
  const int by = luma ? j : j & 1, c = j >> 1;
#pragma unroll
  for (int i = 0; i < 4; i++) {
    q[i][0] = q[i][1] = q[i][2] = q[i][3] = 0u;
    if (!on) continue;
    if (luma) {
      const uint8_t* p = yp + static_cast<size_t>(16 * r + 4 * by + i) * W
                         + 16 * m;
      if (FAST) {
        const uint4 v = *reinterpret_cast<const uint4*>(p);
        q[i][0] = v.x; q[i][1] = v.y; q[i][2] = v.z; q[i][3] = v.w;
      } else {
#pragma unroll
        for (int b = 0; b < 16; b++)
          q[i][b >> 2] |= static_cast<unsigned>(p[b]) << (8 * (b & 3));
      }
    } else {
      const uint8_t* p = (c ? vp : up)
                         + static_cast<size_t>(8 * r + 4 * by + i) * W2
                         + 8 * m;
      if (FAST) {
        const uint2 v = *reinterpret_cast<const uint2*>(p);
        q[i][0] = v.x; q[i][1] = v.y;
      } else {
#pragma unroll
        for (int b = 0; b < 8; b++)
          q[i][b >> 2] |= static_cast<unsigned>(p[b]) << (8 * (b & 3));
      }
    }
  }
  // the blocks' DC sums, the right-edge block's inverse column
  int dcs[4], x[16], e[4];
  const int ew = luma ? 3 : 1;
#pragma unroll
  for (int b = 0; b < 4; b++) {
    unsigned s = 0;
#pragma unroll
    for (int i = 0; i < 4; i++) s = __dp4a(q[i][b], 0x01010101u, s);
    dcs[b] = static_cast<int>(s);
  }
#pragma unroll
  for (int i = 0; i < 4; i++) {
    const unsigned w = ew == 3 ? q[i][3] : q[i][1];
    bytes4(w, x + 4 * i);
  }
  intra_edge(x, quant_p_consts(luma ? qp : qpc, 3), e);
  int* base = reinterpret_cast<int*>(lv + static_cast<size_t>(r) * M
                                     * (16 * N_BLOCKS))
              + I_REC * m + (luma ? 0 : 24 + 12 * c);
  if (luma) {
    // (H W H) rows over the MB's four luma lanes, Frest's rows
    int h[4], s[4];
    dc_rows(dcs, by, dy, h, s);
    if (on) {
      reinterpret_cast<int4*>(base)[by] = make_int4(e[0], e[1], e[2], e[3]);
      base[16 + by] = s[3];
      if (by == 0) base[20] = h[0] >> 1;
    }
  } else {
    // chroma 2x2: A = x00 + x01, B = x00 - x01 from the top lane, C, D
    // from the bottom one
    const unsigned cm = 0xffffffffu;
    const int sum = dcs[0] + dcs[1], dif = dcs[0] - dcs[1];
    const int ps = __shfl_xor_sync(cm, sum, 1), pd = __shfl_xor_sync(cm, dif, 1);
    const int a = by ? ps - sum : sum + ps;
    const int l = quant_dcq(by ? pd - dif : dif + pd, dc);  // B + D, B - D
    if (on) {
      reinterpret_cast<int4*>(base)[by] = make_int4(e[0], e[1], e[2], e[3]);
      reinterpret_cast<int2*>(base + 8)[by] = make_int2(a, l);
    }
  }
}

// The luma chain of a row (csrc/intra_dc.cuh) on 16 lanes, lane k the
// right-edge pixel k; lane 0 stores each MB's word (pred, level00) as its
// header slot 0.
__device__ __forceinline__ void luma_chain(const int* rec,
                                           unsigned long long* bars, int M,
                                           int* out, int k,
                                           const QuantDC& q) {
  dc_chain<I_REC, HDR_SLOTS>(rec, rec + 16, rec + 20, bars, M, out, k, q);
}

// The chain of chroma component c on one lane: each step (pt, pb) ->
// levels 0 and 2 -> the right column's two DC terms -> 8 edge pixels ->
// (pt, pb); the MB's two words (pt and level 0, pb and level 2) as its
// header slots 1 + 2c and 2 + 2c.
__device__ __forceinline__ void chroma_chain(const int* rec,
                                             unsigned long long* bars, int M,
                                             int* out, int c,
                                             const QuantDC& q) {
  int pt = 128, pb = 128;
  const int* rc = rec + 24 + 12 * c;
  const int4* r4 = reinterpret_cast<const int4*>(rc);
  mbar_wait(bars, 0);
  int4 top = r4[0], bot = r4[1], d = r4[2];      // d: A + C, l1, A - C, l3
  for (int m0 = 0; m0 < M; m0 += I_GROUP) {
    if (m0 + I_GROUP < M) mbar_wait(bars + m0 / I_GROUP + 1, 0);
#pragma unroll
    for (int j = 0; j < I_GROUP; j++) {
      const int m = m0 + j;
      if (m >= M) break;
      const int4* n4 = reinterpret_cast<const int4*>(
          rc + I_REC * (m + 1 < M ? m + 1 : m));
      const int4 tn = n4[0], bn = n4[1], dn = n4[2];
      const int l0 = quant_dcq(d.x - 32 * (pt + pb), q);
      const int l2 = quant_dcq(d.z - 32 * (pt - pb), q);
      const int a = l0 - d.y, b = l2 - d.w;
      const int dq1 = dequant_dcq(a + b, q), dq3 = dequant_dcq(a - b, q);
      const int st = (clip1(pt + ((top.x + dq1) >> 6))
                      + clip1(pt + ((top.y + dq1) >> 6)))
                     + (clip1(pt + ((top.z + dq1) >> 6))
                        + clip1(pt + ((top.w + dq1) >> 6)));
      const int sb = (clip1(pb + ((bot.x + dq3) >> 6))
                      + clip1(pb + ((bot.y + dq3) >> 6)))
                     + (clip1(pb + ((bot.z + dq3) >> 6))
                        + clip1(pb + ((bot.w + dq3) >> 6)));
      int* o = out + HDR_SLOTS * m + 1 + 2 * c;
      o[0] = pt | ((l0 + 4096) << 16);
      o[1] = pb | ((l2 + 4096) << 16);
      pt = (st + 2) >> 2;
      pb = (sb + 2) >> 2;
      top = tn;
      bot = bn;
      d = dn;
    }
  }
}

// The second grid: a block a row. Its records come into shared memory by
// TMA bulk copies (warp 2), I_GROUP MBs a copy and an mbarrier, while the
// chains (luma on lanes 0-15 of warp 0, Cb and Cr on lanes 0 and 1 of
// warp 1) start on the first; their words into the row's header slots.
__global__ void __launch_bounds__(96)
i_chain_kernel(const int16_t* __restrict__ lv, const int* __restrict__ qp_rows,
               int* __restrict__ hdr_pay, int M) {
  extern __shared__ int4 rec4[];
  int* rec = reinterpret_cast<int*>(rec4);
  const int r = blockIdx.x, t = threadIdx.x;
  const int groups = (M + I_GROUP - 1) / I_GROUP;
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(rec + I_REC * M);
  if (t == 0) {
    for (int g = 0; g < groups; g++) mbar_init(bars + g, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (t == 64)   // the row's records, contiguous at the start of its lv
    load_records(rec, reinterpret_cast<const int*>(
                          lv + static_cast<size_t>(r) * M * (16 * N_BLOCKS)),
                 bars, M, I_REC);
  const int qp = qp_rows[r];
  const int qpc = K_QPC[clampi(qp, 0, 51)];
  // the words into shared memory, out to the row's header slots at the
  // end in one pass of the block
  int* out = reinterpret_cast<int*>(bars + groups);
  const int lane = t & 31;
  if (t < 16) {
    luma_chain(rec, bars, M, out, lane, quant_dc_consts(qp, true));
  } else if (t >= 32 && lane < 2) {
    chroma_chain(rec, bars, M, out, lane, quant_dc_consts(qpc, false));
  }
  __syncthreads();
  int* dst = hdr_pay + static_cast<size_t>(r) * M * HDR_SLOTS;
  for (int i = t; i < M * HDR_SLOTS; i += 96) dst[i] = out[i];
}

// The third grid. FAST: every block is whole (M a multiple of I_NB) and
// the six planes sit on 16-byte boundaries (the host checks), so the
// stage moves in 16-byte pieces; otherwise in the widest pieces each
// plane allows. Separate kernels, so the common one carries no code for
// the rare shapes (as K2-P).
template <bool FAST>
__global__ void __launch_bounds__(I_THREADS, 8)
i_code_kernel(const uint8_t* __restrict__ yp, const uint8_t* __restrict__ up,
              const uint8_t* __restrict__ vp, const int* __restrict__ qp_rows,
              const int* __restrict__ send, int rows_per_stripe,
              uint8_t* ref_y, uint8_t* ref_u, uint8_t* ref_v,
              int16_t* __restrict__ lv, int* __restrict__ cbp_out,
              int* __restrict__ hdr_pay, int* __restrict__ hdr_nb, int M) {
  __shared__ IStage st;
  // the chain grid has finished: no read comes before this
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int t = threadIdx.x, lane = t & 31;
  const int r = blockIdx.y, m0 = blockIdx.x * I_NB;
  const int nb = M - m0 < I_NB ? M - m0 : I_NB;
  const int mb = t < 64 ? t >> 4 : (t - 64) >> 3;
  const int qp = qp_rows[r];
  const int qpc = K_QPC[clampi(qp, 0, 51)];
  const bool sent = send[r / rows_per_stripe] != 0;
  const int Wp = 16 * M, W2 = 8 * M;
  const size_t oy = static_cast<size_t>(16 * r) * Wp + 16 * m0;
  const size_t oc = static_cast<size_t>(8 * r) * W2 + 8 * m0;
  // the chains' words this thread needs (its MB's header slots: 0 luma,
  // 1 + 2c and 2 + 2c chroma c)
  unsigned w0 = 0, w1 = 0;
  if (mb < nb) {
    const int* h = hdr_pay + (static_cast<size_t>(r) * M + m0 + mb) * HDR_SLOTS;
    const int k = t < 64 ? 0 : 1 + 2 * ((t >> 2) & 1);
    w0 = h[k];
    w1 = h[k + 1];
  }
  if constexpr (FAST) {
    copy_rect<uint4, I_NB, true>(st.cur_y, I_LS, const_cast<uint8_t*>(yp) + oy,
                                 Wp, 16, 0, t, I_THREADS);
    copy_rect<uint4, I_NB / 2, true>(st.cur_c[0], I_CS,
                                     const_cast<uint8_t*>(up) + oc, W2, 8, 0,
                                     t, I_THREADS);
    copy_rect<uint4, I_NB / 2, true>(st.cur_c[1], I_CS,
                                     const_cast<uint8_t*>(vp) + oc, W2, 8, 0,
                                     t, I_THREADS);
  } else {
    stage_rect<true, 16 * I_NB>(st.cur_y, I_LS, yp + oy, Wp, 16, 16 * nb, t,
                                I_THREADS);
    stage_rect<true, 8 * I_NB>(st.cur_c[0], I_CS, up + oc, W2, 8, 8 * nb, t,
                               I_THREADS);
    stage_rect<true, 8 * I_NB>(st.cur_c[1], I_CS, vp + oc, W2, 8, 8 * nb, t,
                               I_THREADS);
  }
  __syncthreads();
  const QuantP qy = quant_p_consts(qp, 3), qc = quant_p_consts(qpc, 3);
  const QuantDC dy = quant_dc_consts(qp, true), dc = quant_dc_consts(qpc, false);
  const size_t g = static_cast<size_t>(r) * M + m0 + mb;
  uint4* slots = reinterpret_cast<uint4*>(lv) + g * (2 * N_BLOCKS);
  int x[16], w[16], acl[16], d[16], inv[16];
  if (t < 64) {
    // ---- luma: thread b of MB mb codes 4x4 block b (raster)
    const int b = t & 15, by = b >> 2, bx = b & 3;
    uint8_t* sc = st.cur_y + 4 * by * I_LS + 16 * mb + 4 * bx;
    load4x4_shared(sc, I_LS, x);
    fwd4(x, w);
    acl[0] = 0;
    d[0] = 0;
#pragma unroll
    for (int k = 1; k < 16; k++) {
      acl[k] = quant_p(w[k], qy.mf[pos_cls(k)], qy.f, qy.qbits);
      d[k] = dequant_p(acl[k], qy.ls[pos_cls(k)], qy.dadd, qy.dsh);
    }
    if (mb < nb) store_slot<true>(slots + 2 * (1 + coding_of_raster(b)), acl);
    const unsigned m16 =
        (__ballot_sync(0xffffffffu, any_nz(acl)) >> (lane & 16)) & 0xFFFFu;
    if (b == 0) st.cbp_luma[mb] = m16 != 0;
    inv4(d, inv);
    // the MB's DC terms over its 16 lanes
    int lvl, f;
    dc_lanes(w[0], b, dy, lvl, f);
    if (mb < nb) {
      const unsigned cw = w0;
      const int pred = static_cast<int>(cw & 0xFFFFu);
      const int dl = static_cast<int>(cw >> 16) - 4096;
      if (b == 0) lvl = dl;
      const int dq = dequant_dcq(f + dl, dy);
#pragma unroll
      for (int k = 0; k < 16; k++) x[k] = clip1(pred + ((inv[k] + dq + 32) >> 6));
      store4x4_shared(sc, I_LS, x);
      st.dcs[mb][zz_pos(4 * sig(by) + sig(bx))] = static_cast<int16_t>(lvl);
    }
  } else {
    // ---- chroma: thread (c, q4) of MB mb codes block q4 of component c
    const int cl = lane & 7, c = cl >> 2, q4 = cl & 3;
    uint8_t* sc = st.cur_c[c] + 4 * (q4 >> 1) * I_CS + 8 * mb + 4 * (q4 & 1);
    load4x4_shared(sc, I_CS, x);
    fwd4(x, w);
    acl[0] = 0;
    d[0] = 0;
#pragma unroll
    for (int k = 1; k < 16; k++) {
      acl[k] = quant_p(w[k], qc.mf[pos_cls(k)], qc.f, qc.qbits);
      d[k] = dequant_p(acl[k], qc.ls[pos_cls(k)], qc.dadd, qc.dsh);
    }
    if (mb < nb) store_slot<true>(slots + 2 * (19 + cl), acl);
    const unsigned cac8 =
        (__ballot_sync(0xffffffffu, any_nz(acl)) >> (lane & 24)) & 0xFFu;
    if (cl == 0) st.cac[mb] = cac8 != 0;
    inv4(d, inv);
    int dcw[4];
#pragma unroll
    for (int k = 0; k < 4; k++)
      dcw[k] = __shfl_sync(0xffffffffu, w[0], (lane & ~3) + k);
    const int B = dcw[0] - dcw[1], D = dcw[2] - dcw[3];
    const int l1 = quant_dcq(B + D, dc), l3 = quant_dcq(B - D, dc);
    if (mb < nb) {
      const unsigned tw = w0, bw = w1;
      const int pt = static_cast<int>(tw & 0xFFFFu);
      const int pb = static_cast<int>(bw & 0xFFFFu);
      const int l0 = static_cast<int>(tw >> 16) - 4096;
      const int l2 = static_cast<int>(bw >> 16) - 4096;
      const int A2 = l0 + l1, B2 = l0 - l1, C2 = l2 + l3, D2 = l2 - l3;
      const int f4 = q4 == 0 ? A2 + C2 : q4 == 1 ? B2 + D2
                     : q4 == 2 ? A2 - C2 : B2 - D2;
      d[0] = dequant_dcq(f4, dc);
      const int p = (q4 >> 1) ? pb : pt;
#pragma unroll
      for (int k = 0; k < 16; k++) x[k] = clip1(p + ((inv[k] + d[0] + 32) >> 6));
      store4x4_shared(sc, I_CS, x);
      reinterpret_cast<uint2*>(&st.dcs[mb][16 + 16 * c])[q4] =
          q4 ? make_uint2(0, 0)
             : make_uint2(pack_i16(l0, l1), pack_i16(l2, l3));
      if (q4 == 0) st.cdc[mb][c] = (l0 | l1 | l2 | l3) != 0;
    }
  }
  __syncthreads();
  // ---- the tile's recon, DC slots, cbp and headers
  if (sent) {
    if constexpr (FAST) {
      copy_rect<uint4, I_NB, false>(st.cur_y, I_LS, ref_y + oy, Wp, 16, 0, t,
                                    I_THREADS);
      copy_rect<uint4, I_NB / 2, false>(st.cur_c[0], I_CS, ref_u + oc, W2, 8,
                                        0, t, I_THREADS);
      copy_rect<uint4, I_NB / 2, false>(st.cur_c[1], I_CS, ref_v + oc, W2, 8,
                                        0, t, I_THREADS);
    } else {
      stage_rect<false, 16 * I_NB>(st.cur_y, I_LS, ref_y + oy, Wp, 16, 16 * nb,
                                   t, I_THREADS);
      stage_rect<false, 8 * I_NB>(st.cur_c[0], I_CS, ref_u + oc, W2, 8, 8 * nb,
                                  t, I_THREADS);
      stage_rect<false, 8 * I_NB>(st.cur_c[1], I_CS, ref_v + oc, W2, 8, 8 * nb,
                                  t, I_THREADS);
    }
  }
  const size_t g0 = static_cast<size_t>(r) * M + m0;
  if (t < 6 * nb) {
    // slot 0 (2 pieces) and slots 17, 18 (4 pieces) of MB t / 6
    const int hm = t / 6, k = t - 6 * hm;
    uint4* dst = reinterpret_cast<uint4*>(lv) + (g0 + hm) * (2 * N_BLOCKS)
                 + (k < 2 ? k : 2 * 17 + k - 2);
    *dst = reinterpret_cast<const uint4*>(st.dcs[hm])[k];
  } else if (t >= 32 && t < 32 + HDR_SLOTS * nb) {
    const int hm = (t - 32) / HDR_SLOTS, k = t - 32 - HDR_SLOTS * hm;
    const int luma = st.cbp_luma[hm];
    const int chroma = st.cac[hm] ? 2 : ((st.cdc[hm][0] | st.cdc[hm][1]) ? 1 : 0);
    int p = 0, n = 0;
    if (k == 0) {
      ue_event(3 + 4 * chroma + (luma ? 12 : 0), &p, &n);
      cbp_out[g0 + hm] = (luma ? 15 : 0) | (chroma << 4);
    } else if (k < 3) {
      p = 1;
      n = 1;
    }
    hdr_pay[(g0 + hm) * HDR_SLOTS + k] = p;
    hdr_nb[(g0 + hm) * HDR_SLOTS + k] = n;
  }
}

// ---------------------------------------------------------------- P frames
// pred_* may alias ref_* (zero motion, mv null); mv (R, M, 2) quarter-pel
// (mvx, mvy); send_rows (R,) gates the recon write per MB row. qp_mb
// (R, M), ROI QP's per-MB QP plane (selkies_tpu/ops/h264_planes.py:
// h264_encode_p_yuv's qp_mb branch), or null for the row QPs: each MB
// reads its luma QP and its chroma QP K_QPC[clip(qp, 0, 51)] once, so the
// row-QP path is unchanged. The mb_qp_delta slot stays ue(0); K18 writes
// the deltas.
//
// A block takes P_NB consecutive MBs of one row with 24 threads an MB:
// two luma warps (16 threads an MB, one a 4x4 block) and one chroma warp
// (8 threads an MB), so no lane idles and no warp diverges on the plane.
// It stages the MBs' cur and prediction pixels in shared memory (16-byte
// loads where the plane allows, 8 where a chroma row is not 16-byte
// aligned: odd M), all of them before any recon is written, so a
// prediction that is the reference itself is read whole first; levels
// go into a shared stage as whole 32-byte slots and leave as the block's
// contiguous run of 16-byte chunks; the recon replaces the cur stage and
// leaves as 16-byte row pieces; the headers and cbp are written by one
// thread a slot, contiguous over the block.
#define P_NB 4                       // MBs a block, consecutive in one row
#define P_LT (16 * P_NB)             // luma threads
#define P_THREADS (24 * P_NB)        // and 8 chroma threads an MB
#define P_LS (16 * P_NB + 16)        // luma stage pitch (bytes)
#define P_CS (8 * P_NB + 16)         // chroma stage pitch
#define P_SLOT_V4 (2 * N_BLOCKS)     // an MB's levels in 16-byte chunks

struct PStage {
  uint4 lv[P_NB * P_SLOT_V4];        // the block's levels, as stored
  uint8_t cur_y[16 * P_LS];          // cur, then the recon
  uint8_t pred_y[16 * P_LS];
  uint8_t cur_c[2][8 * P_CS];
  uint8_t pred_c[2][8 * P_CS];
  int cbp_luma[P_NB], cbp_chroma[P_NB];
};

// A whole block's six planes into the stage in 16-byte pieces, every load
// of a thread issued before its first store.
__device__ __forceinline__ void stage_p(PStage& st, const uint8_t* yp,
                                        const uint8_t* py, const uint8_t* up,
                                        const uint8_t* vp, const uint8_t* pu,
                                        const uint8_t* pv, size_t oy,
                                        size_t oc, int W, int W2, int t) {
  constexpr int NL = 16 * P_NB;                  // luma pieces a plane
  constexpr int CPR = P_NB / 2;                  // chroma pieces a row
  constexpr int NC = 8 * CPR;                    // chroma pieces a plane
  constexpr int KL = (2 * NL + P_THREADS - 1) / P_THREADS;
  constexpr int KC = (4 * NC + P_THREADS - 1) / P_THREADS;
  uint4 l[KL], c[KC];
#pragma unroll
  for (int i = 0; i < KL; i++) {
    const int j = t + i * P_THREADS, p = j / NL, y = (j % NL) / P_NB,
              k = j % P_NB;
    if (j < 2 * NL)
      l[i] = *reinterpret_cast<const uint4*>((p ? py : yp) + oy +
                                             static_cast<size_t>(y) * W +
                                             16 * k);
  }
#pragma unroll
  for (int i = 0; i < KC; i++) {
    const int j = t + i * P_THREADS, p = j / NC, y = (j % NC) / CPR,
              k = j % CPR;
    const uint8_t* base = p == 0 ? up : p == 1 ? vp : p == 2 ? pu : pv;
    if (j < 4 * NC)
      c[i] = *reinterpret_cast<const uint4*>(base + oc +
                                             static_cast<size_t>(y) * W2 +
                                             16 * k);
  }
#pragma unroll
  for (int i = 0; i < KL; i++) {
    const int j = t + i * P_THREADS, p = j / NL, y = (j % NL) / P_NB,
              k = j % P_NB;
    if (j < 2 * NL)
      *reinterpret_cast<uint4*>((p ? st.pred_y : st.cur_y) + y * P_LS +
                                16 * k) = l[i];
  }
#pragma unroll
  for (int i = 0; i < KC; i++) {
    const int j = t + i * P_THREADS, p = j / NC, y = (j % NC) / CPR,
              k = j % CPR;
    uint8_t* base = p < 2 ? st.cur_c[p & 1] : st.pred_c[p & 1];
    if (j < 4 * NC)
      *reinterpret_cast<uint4*>(base + y * P_CS + 16 * k) = c[i];
  }
}

// FAST: every block of the shape is whole (M a multiple of P_NB) and all
// nine planes sit on 16-byte boundaries (the host checks), so the stage
// moves in 16-byte pieces; otherwise each plane goes in the widest pieces
// it allows (8 for chroma rows at odd M, 4 or 1 for a row's last block or
// planes off those boundaries). The two are separate kernels so the
// common one carries no code for the rare shapes: its instructions come
// from device memory when the L2 is cold, and a bigger body cost a
// one-stripe band step more than the kernel saved. 8 blocks an SM caps it
// at 80 registers (left to itself ptxas took 64 and spilled).
template <bool FAST>
__global__ void __launch_bounds__(P_THREADS, 8)
mb_encode_p_kernel(const uint8_t* __restrict__ yp,
                   const uint8_t* __restrict__ up,
                   const uint8_t* __restrict__ vp,
                   const int* __restrict__ qp_rows,
                   const int* __restrict__ send_rows, const uint8_t* pred_y,
                   const uint8_t* pred_u, const uint8_t* pred_v,
                   const int* __restrict__ mv, const int* __restrict__ qp_mb,
                   uint8_t* ref_y, uint8_t* ref_u, uint8_t* ref_v,
                   int16_t* __restrict__ lv, int* __restrict__ cbp_out,
                   int* __restrict__ hdr_pay, int* __restrict__ hdr_nb,
                   int M) {
  __shared__ PStage st;
  // the kernel before it has finished and its writes are visible: no read
  // comes before this
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int t = threadIdx.x, lane = t & 31;
  const int r = blockIdx.y, m0 = blockIdx.x * P_NB;
  const int nb = M - m0 < P_NB ? M - m0 : P_NB;
  const int W = 16 * M, W2 = 8 * M;
  const int g0 = r * M + m0;
  // every global read a thread makes is issued before the first barrier,
  // so one memory latency, not a chain of them, precedes the transform:
  // the MB's QP, the send gate, a header thread's vectors, the stage
  const int mb = t < P_LT ? t >> 4 : (t - P_LT) >> 3;
  const int qp = qp_mb ? qp_mb[g0 + (mb < nb ? mb : 0)] : qp_rows[r];
  const bool sent = send_rows[r] != 0;
  const int hmb = t / HDR_SLOTS;                 // a header thread's MB
  int mvx = 0, mvy = 0, lx = 0, ly = 0;
  if (mv && hmb < nb) {
    const int g = g0 + hmb;
    mvx = mv[2 * g];
    mvy = mv[2 * g + 1];
    if (m0 + hmb > 0) {                        // the left neighbour's
      lx = mv[2 * g - 2];
      ly = mv[2 * g - 1];
    }
  }

  const size_t oy = static_cast<size_t>(16 * r) * W + 16 * m0;
  const size_t oc = static_cast<size_t>(8 * r) * W2 + 8 * m0;
  if constexpr (FAST) {
    stage_p(st, yp, pred_y, up, vp, pred_u, pred_v, oy, oc, W, W2, t);
  } else {
    stage_rect<true, 16 * P_NB>(st.cur_y, P_LS, yp + oy, W, 16, 16 * nb, t,
                                P_THREADS);
    stage_rect<true, 16 * P_NB>(st.pred_y, P_LS, pred_y + oy, W, 16,
                                16 * nb, t, P_THREADS);
    stage_rect<true, 8 * P_NB>(st.cur_c[0], P_CS, up + oc, W2, 8, 8 * nb, t,
                               P_THREADS);
    stage_rect<true, 8 * P_NB>(st.cur_c[1], P_CS, vp + oc, W2, 8, 8 * nb, t,
                               P_THREADS);
    stage_rect<true, 8 * P_NB>(st.pred_c[0], P_CS, pred_u + oc, W2, 8,
                               8 * nb, t, P_THREADS);
    stage_rect<true, 8 * P_NB>(st.pred_c[1], P_CS, pred_v + oc, W2, 8,
                               8 * nb, t, P_THREADS);
  }
  __syncthreads();

  int x[16], pr[16], w[16], acl[16], d[16], inv[16];
  if (t < P_LT) {
    // ---- luma: thread b of MB mb codes 4x4 block b (raster)
    const int b = t & 15, by = b >> 2, bx = b & 3;
    const QuantP q = quant_p_consts(qp, 6);
    uint8_t* sc = st.cur_y + 4 * by * P_LS + 16 * mb + 4 * bx;
    load4x4_shared(sc, P_LS, x);
    load4x4_shared(st.pred_y + (sc - st.cur_y), P_LS, pr);
#pragma unroll
    for (int k = 0; k < 16; k++) x[k] -= pr[k];
    fwd4(x, w);
#pragma unroll
    for (int k = 0; k < 16; k++)
      acl[k] = quant_p(w[k], q.mf[pos_cls(k)], q.f, q.qbits);
    // the MB's 16 blocks are one half-warp: cbp's four 8x8 group bits
    const unsigned m16 =
        (__ballot_sync(0xffffffffu, any_nz(acl)) >> (lane & 16)) & 0xFFFFu;
    const int cbp_luma = ((m16 & 0x0033u) ? 1 : 0) | ((m16 & 0x00CCu) ? 2 : 0) |
                         ((m16 & 0x3300u) ? 4 : 0) | ((m16 & 0xCC00u) ? 8 : 0);
    uint4* slots = st.lv + mb * P_SLOT_V4;
    store_slot<false>(slots + 2 * (1 + coding_of_raster(b)), acl);
    if (b < 2) slots[b] = make_uint4(0, 0, 0, 0);   // the luma-DC slot
    if (b == 0) st.cbp_luma[mb] = cbp_luma;
    if (sent) {
      // a group's blocks are dequantized when its cbp bit is set (which
      // makes the MB coded)
      const bool on = (cbp_luma >> ((by >> 1) * 2 + (bx >> 1))) & 1;
#pragma unroll
      for (int k = 0; k < 16; k++)
        d[k] = dequant_p(on ? acl[k] : 0, q.ls[pos_cls(k)], q.dadd, q.dsh);
      inv4(d, inv);
#pragma unroll
      for (int k = 0; k < 16; k++) x[k] = clip1(pr[k] + ((inv[k] + 32) >> 6));
      store4x4_shared(sc, P_LS, x);
    }
  } else {
    // ---- chroma: thread (c, q4) of MB mb codes block q4 of component c
    const int cl = lane & 7, c = cl >> 2, q4 = cl & 3;
    const int qpc = K_QPC[clampi(qp, 0, 51)];
    const QuantP q = quant_p_consts(qpc, 6);
    uint8_t* sc = st.cur_c[c] + 4 * (q4 >> 1) * P_CS + 8 * mb + 4 * (q4 & 1);
    load4x4_shared(sc, P_CS, x);
    load4x4_shared(st.pred_c[c] + (sc - st.cur_c[c]), P_CS, pr);
#pragma unroll
    for (int k = 0; k < 16; k++) x[k] -= pr[k];
    fwd4(x, w);
    acl[0] = 0;
#pragma unroll
    for (int k = 1; k < 16; k++)
      acl[k] = quant_p(w[k], q.mf[pos_cls(k)], q.f, q.qbits);
    // chroma DC: 2x2 Hadamard of the component's four W00 terms
    int dcw[4];
#pragma unroll
    for (int k = 0; k < 4; k++)
      dcw[k] = __shfl_sync(0xffffffffu, w[0], (lane & ~3) + k);
    const int A = dcw[0] + dcw[1], B = dcw[0] - dcw[1], C = dcw[2] + dcw[3],
              D = dcw[2] - dcw[3];
    const int hd2[4] = {A + C, B + D, A - C, B - D};
    const int f2 = 2 * ((1 << q.qbits) / 3);
    int clv[4];
#pragma unroll
    for (int k = 0; k < 4; k++) {
      const int y = hd2[k];
      const int mag = ((y < 0 ? -y : y) * q.mf[0] + f2) >> (q.qbits + 1);
      clv[k] = clampi(y < 0 ? -mag : mag, -LEVEL_CLAMP, LEVEL_CLAMP);
    }
    const bool cdc_nz = (clv[0] | clv[1] | clv[2] | clv[3]) != 0;
    const unsigned cac8 = __ballot_sync(0xffffffffu, any_nz(acl)) >> (lane & 24);
    const unsigned cdc8 = __ballot_sync(0xffffffffu, cdc_nz) >> (lane & 24);
    const int cbp_chroma = (cac8 & 0xFFu) ? 2 : ((cdc8 & 0xFFu) ? 1 : 0);
    uint4* slots = st.lv + mb * P_SLOT_V4;
    store_slot<true>(slots + 2 * (19 + cl), acl);
    // the component's DC slot: its four levels, then zeros, 8 bytes a
    // thread
    reinterpret_cast<uint2*>(slots + 2 * (17 + c))[q4] =
        q4 ? make_uint2(0, 0)
           : make_uint2(pack_i16(clv[0], clv[1]), pack_i16(clv[2], clv[3]));
    if (cl == 0) st.cbp_chroma[mb] = cbp_chroma;
    if (sent) {
      const int A2 = clv[0] + clv[1], B2 = clv[0] - clv[1],
                C2 = clv[2] + clv[3], D2 = clv[2] - clv[3];
      const int f4[4] = {A2 + C2, B2 + D2, A2 - C2, B2 - D2};
      const int ls00 = 16 * K_V[(qpc % 6) * 3];
      d[0] = cbp_chroma >= 1 ? (f4[q4] * ls00 * (1 << (qpc / 6))) >> 5 : 0;
      const bool gate_ac = cbp_chroma == 2;
#pragma unroll
      for (int k = 1; k < 16; k++)
        d[k] = dequant_p(gate_ac ? acl[k] : 0, q.ls[pos_cls(k)], q.dadd,
                         q.dsh);
      inv4(d, inv);
#pragma unroll
      for (int k = 0; k < 16; k++) x[k] = clip1(pr[k] + ((inv[k] + 32) >> 6));
      store4x4_shared(sc, P_CS, x);
    }
  }
  __syncthreads();

  // ---- the block's MBs are contiguous in lv, cbp and the header slots
  const uint4* src = st.lv;
  uint4* dst = reinterpret_cast<uint4*>(lv) + static_cast<size_t>(g0) * P_SLOT_V4;
  for (int i = t; i < nb * P_SLOT_V4; i += P_THREADS) dst[i] = src[i];
  if (sent) {
    if constexpr (FAST) {
      copy_rect<uint4, P_NB, false>(st.cur_y, P_LS, ref_y + oy, W, 16, 0, t,
                                    P_THREADS);
      copy_rect<uint4, P_NB / 2, false>(st.cur_c[0], P_CS, ref_u + oc, W2, 8,
                                        0, t, P_THREADS);
      copy_rect<uint4, P_NB / 2, false>(st.cur_c[1], P_CS, ref_v + oc, W2, 8,
                                        0, t, P_THREADS);
    } else {
      stage_rect<false, 16 * P_NB>(st.cur_y, P_LS, ref_y + oy, W, 16,
                                   16 * nb, t, P_THREADS);
      stage_rect<false, 8 * P_NB>(st.cur_c[0], P_CS, ref_u + oc, W2, 8,
                                  8 * nb, t, P_THREADS);
      stage_rect<false, 8 * P_NB>(st.cur_c[1], P_CS, ref_v + oc, W2, 8,
                                  8 * nb, t, P_THREADS);
    }
  }
  if (hmb < nb) {
    const int k = t - hmb * HDR_SLOTS, g = g0 + hmb;
    const int cbp = st.cbp_luma[hmb] | (st.cbp_chroma[hmb] << 4);
    int p = 0, n = 0;                          // skip run: the packer's
    if (cbp != 0 || mvx != 0 || mvy != 0) {    // coded
      // MV predictor = left neighbour (one slice per MB row, §8.4.1.3)
      if (k == 1) {
        p = 1; n = 1;                          // mb_type P_L0_16x16
      } else if (k == 2) {
        se_event(mvx - lx, &p, &n);
      } else if (k == 3) {
        se_event(mvy - ly, &p, &n);
      } else if (k == 4) {
        ue_event(K_CBP2CODE[cbp], &p, &n);
      } else if (k == 5 && cbp != 0) {
        p = 1; n = 1;                          // mb_qp_delta ue(0)
      }
    }
    hdr_pay[static_cast<size_t>(g) * HDR_SLOTS + k] = p;
    hdr_nb[static_cast<size_t>(g) * HDR_SLOTS + k] = n;
    if (k == 0) cbp_out[g] = cbp;
  }
}

// every pointer on a 16-byte boundary
template <typename... P>
static bool aligned(P... p) {
  return ((reinterpret_cast<uintptr_t>(p) % 16 == 0) && ...);
}

extern "C" int mb_encode_i(const uint8_t* y, const uint8_t* u,
                           const uint8_t* v, const int* qp, const int* send,
                           int rows_per_stripe, uint8_t* ref_y, uint8_t* ref_u,
                           uint8_t* ref_v, int16_t* lv, int* cbp, int* hdr_pay,
                           int* hdr_nb, int R, int M, void* stream) {
  if (R <= 0 || M <= 0 || rows_per_stripe <= 0 || R > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (M + I_NB - 1) / I_NB;
  const bool fast = M % I_NB == 0 && aligned(y, u, v, ref_y, ref_u, ref_v);
  // the chain grid's records in shared memory: it may have all a block
  // can opt into (per device, set once; the value is the same in every
  // thread that races to set it)
  static int optin[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!optin[dev]) {
    int smem = 0;
    cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    cudaFuncSetAttribute(i_chain_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    optin[dev] = smem;
  }
  const int smem = 4 * (I_REC + HDR_SLOTS) * M
                   + 8 * ((M + I_GROUP - 1) / I_GROUP);
  if (smem > optin[dev]) return static_cast<int>(cudaErrorInvalidValue);
  // the first grid behind the kernel before it (programmatic dependent
  // launch: K1 in the I step) and the coding grid behind the chain grid,
  // each waiting for the one before inside; the chain grid in stream
  // order (launched early behind the first grid, its blocks ran the
  // chains several times slower)
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3((M + I_REC_MBS - 1) / I_REC_MBS, R);
  cfg.blockDim = dim3(128);
  cudaLaunchKernelEx(&cfg,
                     fast ? i_records_kernel<true> : i_records_kernel<false>,
                     y, u, v, qp, lv, M);
  i_chain_kernel<<<R, 96, smem, cfg.stream>>>(lv, qp, hdr_pay, M);
  cfg.gridDim = dim3(tiles, R);
  cfg.blockDim = dim3(I_THREADS);
  cudaLaunchKernelEx(&cfg, fast ? i_code_kernel<true> : i_code_kernel<false>,
                     y, u, v, qp, send, rows_per_stripe, ref_y, ref_u, ref_v,
                     lv, cbp, hdr_pay, hdr_nb, M);
  return static_cast<int>(cudaGetLastError());
}

static int launch_p(const uint8_t* y, const uint8_t* u, const uint8_t* v,
                    const int* qp, const int* send_rows, const uint8_t* pred_y,
                    const uint8_t* pred_u, const uint8_t* pred_v,
                    const int* mv, const int* qp_mb, uint8_t* ref_y,
                    uint8_t* ref_u, uint8_t* ref_v, int16_t* lv, int* cbp,
                    int* hdr_pay, int* hdr_nb, int R, int M, void* stream) {
  if (R <= 0 || M <= 0 || R > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // launched behind the kernel before it (programmatic dependent launch:
  // K5 on the band path, K1 with zero motion), which it waits for inside
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + P_NB - 1) / P_NB, R);
  cfg.blockDim = dim3(P_THREADS);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const bool fast = M % P_NB == 0 && aligned(y, u, v, pred_y, pred_u, pred_v,
                                            ref_y, ref_u, ref_v);
  cudaLaunchKernelEx(&cfg,
                     fast ? mb_encode_p_kernel<true>
                          : mb_encode_p_kernel<false>,
                     y, u, v, qp, send_rows, pred_y, pred_u, pred_v, mv,
                     qp_mb, ref_y, ref_u, ref_v, lv, cbp, hdr_pay, hdr_nb, M);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mb_encode_p(const uint8_t* y, const uint8_t* u,
                           const uint8_t* v, const int* qp,
                           const int* send_rows, const uint8_t* pred_y,
                           const uint8_t* pred_u, const uint8_t* pred_v,
                           const int* mv, uint8_t* ref_y, uint8_t* ref_u,
                           uint8_t* ref_v, int16_t* lv, int* cbp, int* hdr_pay,
                           int* hdr_nb, int R, int M, void* stream) {
  return launch_p(y, u, v, qp, send_rows, pred_y, pred_u, pred_v, mv, nullptr,
                  ref_y, ref_u, ref_v, lv, cbp, hdr_pay, hdr_nb, R, M, stream);
}

// The ROI QP entry: the same kernel with a per-MB QP plane.
extern "C" int mb_encode_p_qp(const uint8_t* y, const uint8_t* u,
                              const uint8_t* v, const int* qp,
                              const int* send_rows, const uint8_t* pred_y,
                              const uint8_t* pred_u, const uint8_t* pred_v,
                              const int* mv, const int* qp_mb, uint8_t* ref_y,
                              uint8_t* ref_u, uint8_t* ref_v, int16_t* lv,
                              int* cbp, int* hdr_pay, int* hdr_nb, int R,
                              int M, void* stream) {
  return launch_p(y, u, v, qp, send_rows, pred_y, pred_u, pred_v, mv, qp_mb,
                  ref_y, ref_u, ref_v, lv, cbp, hdr_pay, hdr_nb, R, M, stream);
}
