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
// Bound on the H100: I frames by the serial DC chain (the left-edge
// dependency runs across the 120 MBs of a row, 68 rows in parallel), P
// frames by bytes (cur + prediction planes in, reference + levels out,
// ~15 MB at 1080p: 4.6 us).
// I frames: one warp per macroblock, lanes 0..15 on the 16 luma 4x4
// blocks, lanes 16..23 on the 8 chroma blocks, the per-MB decisions (cbp,
// chroma DC Hadamard) by warp ballots and shuffles; one block per MB row;
// the AC work (which does not depend on the DC prediction: the prediction
// is constant per MB) runs in parallel over the row's MBs, only the DC /
// edge chain walks the row on one warp (16 lanes luma DC, 8 lanes chroma
// DC per MB step), then the recon runs in parallel again. The recon is
// recomputed from the pixels rather than stored between phases. Recon
// writes go straight into the reference planes for rows whose stripe is
// sent.
// P frames: a block of 4 MBs of one row, 96 threads (a thread a 4x4
// block, luma and chroma in warps of their own, so no lane idles), the
// pixels staged in shared memory with 16-byte loads, the levels, the
// recon and the header slots leaving the block as whole contiguous runs
// rather than as two-byte and byte stores spread over 24 sectors a warp
// instruction. P frames predict from planes of their own (K5's output)
// when motion is on; with zero motion the prediction is the reference
// plane itself, which a block stages whole before it writes any recon,
// and blocks own disjoint MBs.
#include "h264_common.cuh"

// ---------------------------------------------------------------- I frames
// shared layout (ints), M = MBs per row
#define SM_DCY(m) (sm + (m) * 16)                  // raw luma W00 by raster
#define SM_DCC(m) (sm + 16 * M + (m) * 8)          // raw chroma W00 c*4+q
#define SM_EY(m) (sm + 24 * M + (m) * 16)          // luma inv edge by*4+row
#define SM_EC(m) (sm + 40 * M + (m) * 16)          // chroma edge c*8+by2*4+row
#define SM_QY(m) (sm + 56 * M + (m) * 16)          // dequantized luma DC
#define SM_QC(m) (sm + 72 * M + (m) * 8)           // dequantized chroma DC
#define SM_PY(m) (sm + 80 * M + (m))               // luma pred
#define SM_PC(m) (sm + 81 * M + (m) * 4)           // chroma pred c*2+half
#define SM_FL(m) (sm + 85 * M + (m))               // bit0 luma AC, 1 cac, 2 cdc
#define SM_INTS(M) (86 * (M) + 64)

__global__ void mb_encode_i_kernel(const uint8_t* __restrict__ yp,
                                   const uint8_t* __restrict__ up,
                                   const uint8_t* __restrict__ vp,
                                   const int* __restrict__ qp_rows,
                                   const int* __restrict__ send,
                                   int rows_per_stripe, uint8_t* ref_y,
                                   uint8_t* ref_u, uint8_t* ref_v,
                                   int16_t* __restrict__ lv,
                                   int* __restrict__ cbp_out,
                                   int* __restrict__ hdr_pay,
                                   int* __restrict__ hdr_nb, int M) {
  extern __shared__ int sm[];
  int* s_edge_y = sm + 86 * M;      // 16
  int* s_edge_c = s_edge_y + 16;    // 16: c*8 + by2*4 + row
  int* s_a = s_edge_c + 16;         // 16: luma DC levels of the MB step
  int* s_b = s_a + 16;              // 8: chroma DC levels
  const int r = blockIdx.x;
  const int W = M * 16, W2 = M * 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int qp = qp_rows[r];
  const int qpc = K_QPC[clampi(qp, 0, 51)];
  const bool is_luma = lane < 16, is_chroma = lane >= 16 && lane < 24;
  const int cl = lane - 16, c = (lane - 16) >> 2, q = (lane - 16) & 3;
  int16_t* lv_row = lv + static_cast<size_t>(r) * M * N_BLOCKS * 16;

  // ---- phase 1: AC levels, raw DC terms, inverse right edges
  for (int m = warp; m < M; m += nwarps) {
    int x[16], w[16], acl[16], inv[16];
    bool nz = false;
    int16_t* lv_mb = lv_row + static_cast<size_t>(m) * N_BLOCKS * 16;
    if (is_luma) {
      const int by = lane >> 2, bx = lane & 3;
      load4x4(yp, W, 16 * r + 4 * by, 16 * m + 4 * bx, x);
      intra_ac(x, qp, w, acl, inv);
      SM_DCY(m)[lane] = w[0];
      store_scan(lv_mb + (1 + K_CODING_OF_RASTER[lane]) * 16, acl, 1);
      nz = any_nz(acl);
      if (bx == 3)
        for (int i = 0; i < 4; i++) SM_EY(m)[by * 4 + i] = inv[4 * i + 3];
    } else if (is_chroma) {
      const int by2 = q >> 1, bx2 = q & 1;
      load4x4(c ? vp : up, W2, 8 * r + 4 * by2, 8 * m + 4 * bx2, x);
      intra_ac(x, qpc, w, acl, inv);
      SM_DCC(m)[cl] = w[0];
      store_scan(lv_mb + (19 + cl) * 16, acl, 1);
      nz = any_nz(acl);
      if (bx2 == 1)
        for (int i = 0; i < 4; i++)
          SM_EC(m)[c * 8 + by2 * 4 + i] = inv[4 * i + 3];
    }
    const unsigned bal = __ballot_sync(0xffffffffu, nz);
    if (lane == 0)
      SM_FL(m)[0] = ((bal & 0xFFFFu) != 0) | ((((bal >> 16) & 0xFFu) != 0) << 1);
  }
  __syncthreads();

  // ---- phase 2: the DC / left-edge chain, one warp walking the row
  if (warp == 0) {
    for (int m = 0; m < M; m++) {
      int16_t* lv_mb = lv_row + static_cast<size_t>(m) * N_BLOCKS * 16;
      int pred = 128, pt = 128, pb = 128;
      if (is_luma) {
        if (m > 0) {
          int s = 0;
          for (int k = 0; k < 16; k++) s += s_edge_y[k];
          pred = (s + 8) >> 4;
        }
        const int i = lane >> 2, j = lane & 3;
        int hd = 0;
        for (int a = 0; a < 4; a++)
          for (int b = 0; b < 4; b++)
            hd += h4(i, a) * (SM_DCY(m)[a * 4 + b] - 16 * pred) * h4(b, j);
        s_a[lane] = quant_dc(hd >> 1, qp);
      } else if (is_chroma) {
        if (m > 0) {
          int st = 0, sb = 0;
          for (int k = 0; k < 4; k++) {
            st += s_edge_c[c * 8 + k];
            sb += s_edge_c[c * 8 + 4 + k];
          }
          pt = (st + 2) >> 2;
          pb = (sb + 2) >> 2;
        }
        const int* dc = SM_DCC(m) + c * 4;
        const int x00 = dc[0] - 16 * pt, x01 = dc[1] - 16 * pt;
        const int x10 = dc[2] - 16 * pb, x11 = dc[3] - 16 * pb;
        const int A = x00 + x01, B = x00 - x01, C = x10 + x11, D = x10 - x11;
        const int hd2[4] = {A + C, B + D, A - C, B - D};
        s_b[cl] = quant_dc(hd2[q], qpc);
      }
      __syncwarp();
      if (is_luma) {
        const int i = lane >> 2, j = lane & 3;
        int f = 0;
        for (int a = 0; a < 4; a++)
          for (int b = 0; b < 4; b++) f += h4(i, a) * s_a[a * 4 + b] * h4(b, j);
        SM_QY(m)[lane] = dequant_ldc(f, qp);
        lv_mb[K_INV_ZIGZAG[lane]] = static_cast<int16_t>(s_a[lane]);
        if (lane == 0) SM_PY(m)[0] = pred;
      } else if (is_chroma) {
        const int* l = s_b + c * 4;
        const int A = l[0] + l[1], B = l[0] - l[1], C = l[2] + l[3],
                  D = l[2] - l[3];
        const int f2[4] = {A + C, B + D, A - C, B - D};
        SM_QC(m)[cl] = dequant_cdc(f2[q], qpc);
        int16_t* slot = lv_mb + (17 + c) * 16;
        slot[q] = static_cast<int16_t>(s_b[cl]);
        for (int k = 0; k < 3; k++) slot[4 + 3 * q + k] = 0;
        if (q < 2) SM_PC(m)[c * 2 + q] = q ? pb : pt;
      }
      const unsigned cdc = __ballot_sync(0xffffffffu, is_chroma && s_b[cl] != 0);
      if (lane == 0 && cdc) SM_FL(m)[0] |= 4;
      __syncwarp();
      if (is_luma) {
        const int by = lane >> 2, ri = lane & 3;
        s_edge_y[lane] = clip1(
            pred + ((SM_EY(m)[by * 4 + ri] + SM_QY(m)[by * 4 + 3] + 32) >> 6));
      } else if (is_chroma) {
        const int by2 = q >> 1;
        const int p = by2 ? pb : pt;
        for (int k = 0; k < 2; k++) {
          const int ri = (q & 1) * 2 + k;
          s_edge_c[c * 8 + by2 * 4 + ri] = clip1(
              p + ((SM_EC(m)[c * 8 + by2 * 4 + ri] + SM_QC(m)[c * 4 + by2 * 2 + 1]
                    + 32) >> 6));
        }
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // ---- phase 3: recon into the reference planes, MB outputs
  const bool sent = send[r / rows_per_stripe] != 0;
  for (int m = warp; m < M; m += nwarps) {
    int x[16], w[16], acl[16], inv[16], rec[16];
    if (is_luma && sent) {
      const int by = lane >> 2, bx = lane & 3;
      load4x4(yp, W, 16 * r + 4 * by, 16 * m + 4 * bx, x);
      intra_ac(x, qp, w, acl, inv);
      const int p = SM_PY(m)[0], dc = SM_QY(m)[lane];
      for (int k = 0; k < 16; k++) rec[k] = clip1(p + ((inv[k] + dc + 32) >> 6));
      store4x4(ref_y, W, 16 * r + 4 * by, 16 * m + 4 * bx, rec);
    } else if (is_chroma && sent) {
      const int by2 = q >> 1, bx2 = q & 1;
      load4x4(c ? vp : up, W2, 8 * r + 4 * by2, 8 * m + 4 * bx2, x);
      intra_ac(x, qpc, w, acl, inv);
      const int p = SM_PC(m)[c * 2 + by2], dc = SM_QC(m)[cl];
      for (int k = 0; k < 16; k++) rec[k] = clip1(p + ((inv[k] + dc + 32) >> 6));
      store4x4(c ? ref_v : ref_u, W2, 8 * r + 4 * by2, 8 * m + 4 * bx2, rec);
    } else if (lane == 24) {
      const int fl = SM_FL(m)[0];
      const int luma = fl & 1;
      const int chroma = (fl & 2) ? 2 : ((fl & 4) ? 1 : 0);
      const size_t g = static_cast<size_t>(r) * M + m;
      cbp_out[g] = (luma ? 15 : 0) | (chroma << 4);
      int p, n;
      ue_event(3 + 4 * chroma + (luma ? 12 : 0), &p, &n);
      int* hp = hdr_pay + g * HDR_SLOTS;
      int* hn = hdr_nb + g * HDR_SLOTS;
      hp[0] = p; hn[0] = n;
      hp[1] = 1; hn[1] = 1;
      hp[2] = 1; hn[2] = 1;
      for (int k = 3; k < HDR_SLOTS; k++) { hp[k] = 0; hn[k] = 0; }
    }
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

extern "C" int mb_encode_i(const uint8_t* y, const uint8_t* u,
                           const uint8_t* v, const int* qp, const int* send,
                           int rows_per_stripe, uint8_t* ref_y, uint8_t* ref_u,
                           uint8_t* ref_v, int16_t* lv, int* cbp, int* hdr_pay,
                           int* hdr_nb, int R, int M, void* stream) {
  const size_t smem = sizeof(int) * SM_INTS(M);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(mb_encode_i_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  mb_encode_i_kernel<<<R, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      y, u, v, qp, send, rows_per_stripe, ref_y, ref_u, ref_v, lv, cbp,
      hdr_pay, hdr_nb, M);
  return static_cast<int>(cudaGetLastError());
}

// every pointer on a 16-byte boundary
template <typename... P>
static bool aligned(P... p) {
  return ((reinterpret_cast<uintptr_t>(p) % 16 == 0) && ...);
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
