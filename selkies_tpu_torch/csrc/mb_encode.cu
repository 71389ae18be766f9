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
// frames by bytes (cur + ref planes in, ref + levels out, ~15 MB at 1080p).
// Design: one warp per macroblock, lanes 0..15 on the 16 luma 4x4 blocks,
// lanes 16..23 on the 8 chroma blocks, the per-MB decisions (cbp, chroma DC
// Hadamard) by warp ballots and shuffles. I frames: one block per MB row;
// the AC work (which does not depend on the DC prediction: the prediction
// is constant per MB) runs in parallel over the row's MBs, only the DC /
// edge chain walks the row on one warp (16 lanes luma DC, 8 lanes chroma
// DC per MB step), then the recon runs in parallel again. The recon is
// recomputed from the pixels rather than stored between phases. Recon
// writes go straight into the reference planes for rows whose stripe is
// sent. P frames predict from planes of their own (K5's output) when
// motion is on, so a vector reaching into another MB never reads a pixel
// that MB's recon has overwritten; with zero motion the prediction is the
// reference plane itself, and each lane reads its own 4x4 before it
// writes it, which no other lane touches.
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
__global__ void mb_encode_p_kernel(const uint8_t* __restrict__ yp,
                                   const uint8_t* __restrict__ up,
                                   const uint8_t* __restrict__ vp,
                                   const int* __restrict__ qp_rows,
                                   const int* __restrict__ send_rows,
                                   const uint8_t* pred_y,
                                   const uint8_t* pred_u,
                                   const uint8_t* pred_v,
                                   const int* __restrict__ mv,
                                   const int* __restrict__ qp_mb,
                                   uint8_t* ref_y, uint8_t* ref_u,
                                   uint8_t* ref_v, int16_t* __restrict__ lv,
                                   int* __restrict__ cbp_out,
                                   int* __restrict__ hdr_pay,
                                   int* __restrict__ hdr_nb, int R, int M) {
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (g >= R * M) return;                      // whole warp leaves together
  const int r = g / M, m = g % M;
  const int W = M * 16, W2 = M * 8;
  const int qp = qp_mb ? qp_mb[g] : qp_rows[r];
  const int qpc = K_QPC[clampi(qp, 0, 51)];
  const bool sent = send_rows[r] != 0;
  const bool is_luma = lane < 16, is_chroma = lane >= 16 && lane < 24;
  const int cl = lane - 16, c = is_chroma ? (lane - 16) >> 2 : 0,
            q = (lane - 16) & 3;
  int16_t* lv_mb = lv + static_cast<size_t>(g) * N_BLOCKS * 16;
  const int mvx = mv ? mv[2 * g] : 0, mvy = mv ? mv[2 * g + 1] : 0;

  int x[16], pr[16], w[16], acl[16];
  int r0 = 0, c0 = 0, stride = W, g8 = 0;
  const uint8_t* cur = yp;
  const uint8_t* pred = pred_y;
  uint8_t* ref = ref_y;
  if (is_luma) {
    const int by = lane >> 2, bx = lane & 3;
    r0 = 16 * r + 4 * by; c0 = 16 * m + 4 * bx;
    g8 = (by >> 1) * 2 + (bx >> 1);
  } else if (is_chroma) {
    r0 = 8 * r + 4 * (q >> 1); c0 = 8 * m + 4 * (q & 1); stride = W2;
    cur = c ? vp : up;
    pred = c ? pred_v : pred_u;
    ref = c ? ref_v : ref_u;
  }
  int lbits = 0;
  bool nz_ac = false;
  int w00 = 0;
  if (is_luma || is_chroma) {
    load4x4(cur, stride, r0, c0, x);
    load4x4(pred, stride, r0, c0, pr);
    for (int k = 0; k < 16; k++) x[k] -= pr[k];
    fwd4(x, w);
    const int qq = is_luma ? qp : qpc;
    for (int k = 0; k < 16; k++) acl[k] = quant_ac(w[k], qq, K_POS_CLS[k], 6);
    if (is_luma) {
      store_scan(lv_mb + (1 + K_CODING_OF_RASTER[lane]) * 16, acl, 0);
      lbits = any_nz(acl) ? (1 << g8) : 0;
    } else {
      acl[0] = 0;
      store_scan(lv_mb + (19 + cl) * 16, acl, 1);
      nz_ac = any_nz(acl);
      w00 = w[0];
    }
  } else {
    // lanes 24..31 zero the unused luma-DC block (2 positions each)
    lv_mb[2 * (lane - 24)] = 0;
    lv_mb[2 * (lane - 24) + 1] = 0;
  }
  const int cbp_luma = __reduce_or_sync(0xffffffffu, lbits);
  // chroma DC: 2x2 Hadamard of the component's four W00 terms
  int dcw[4];
  for (int k = 0; k < 4; k++)
    dcw[k] = __shfl_sync(0xffffffffu, w00, 16 + c * 4 + k);
  const int A = dcw[0] + dcw[1], B = dcw[0] - dcw[1], C = dcw[2] + dcw[3],
            D = dcw[2] - dcw[3];
  const int hd2[4] = {A + C, B + D, A - C, B - D};
  int clv[4];
  for (int k = 0; k < 4; k++) clv[k] = quant_dc(hd2[k], qpc);
  const bool cdc_nz = is_chroma && (clv[0] | clv[1] | clv[2] | clv[3]) != 0;
  const bool has_cac = __ballot_sync(0xffffffffu, is_chroma && nz_ac) != 0;
  const bool has_cdc = __ballot_sync(0xffffffffu, cdc_nz) != 0;
  const int cbp_chroma = has_cac ? 2 : (has_cdc ? 1 : 0);
  const int cbp = cbp_luma | (cbp_chroma << 4);
  const bool coded = cbp != 0 || mvx != 0 || mvy != 0;

  if (is_chroma) {
    int16_t* slot = lv_mb + (17 + c) * 16;
    slot[q] = static_cast<int16_t>(clv[q]);
    for (int k = 0; k < 3; k++) slot[4 + 3 * q + k] = 0;
  }
  if (sent && (is_luma || is_chroma)) {
    int d[16], inv[16];
    if (is_luma) {
      const bool on = ((cbp_luma >> g8) & 1) && coded;
      for (int k = 0; k < 16; k++)
        d[k] = dequant_ac(on ? acl[k] : 0, qp, K_POS_CLS[k]);
    } else {
      const int A2 = clv[0] + clv[1], B2 = clv[0] - clv[1],
                C2 = clv[2] + clv[3], D2 = clv[2] - clv[3];
      const int f2[4] = {A2 + C2, B2 + D2, A2 - C2, B2 - D2};
      const bool gate_ac = cbp_chroma == 2;
      for (int k = 1; k < 16; k++)
        d[k] = dequant_ac(gate_ac ? acl[k] : 0, qpc, K_POS_CLS[k]);
      d[0] = cbp_chroma >= 1 ? dequant_cdc(f2[q], qpc) : 0;
    }
    inv4(d, inv);
    int rec[16];
    for (int k = 0; k < 16; k++) rec[k] = clip1(pr[k] + ((inv[k] + 32) >> 6));
    store4x4(ref, stride, r0, c0, rec);
  }
  if (lane == 24) {
    cbp_out[g] = cbp;
    int* hp = hdr_pay + static_cast<size_t>(g) * HDR_SLOTS;
    int* hn = hdr_nb + static_cast<size_t>(g) * HDR_SLOTS;
    hp[0] = 0; hn[0] = 0;                      // skip run: the packer's
    for (int k = 1; k < HDR_SLOTS; k++) { hp[k] = 0; hn[k] = 0; }
    if (coded) {
      // MV predictor = left neighbour (one slice per MB row, §8.4.1.3)
      const int lx = (m > 0 && mv) ? mv[2 * g - 2] : 0;
      const int ly = (m > 0 && mv) ? mv[2 * g - 1] : 0;
      hp[1] = 1; hn[1] = 1;                    // mb_type P_L0_16x16
      se_event(mvx - lx, &hp[2], &hn[2]);
      se_event(mvy - ly, &hp[3], &hn[3]);
      ue_event(K_CBP2CODE[cbp], &hp[4], &hn[4]);
      if (cbp != 0) { hp[5] = 1; hn[5] = 1; }  // mb_qp_delta ue(0)
    }
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

static int launch_p(const uint8_t* y, const uint8_t* u, const uint8_t* v,
                    const int* qp, const int* send_rows, const uint8_t* pred_y,
                    const uint8_t* pred_u, const uint8_t* pred_v,
                    const int* mv, const int* qp_mb, uint8_t* ref_y,
                    uint8_t* ref_u, uint8_t* ref_v, int16_t* lv, int* cbp,
                    int* hdr_pay, int* hdr_nb, int R, int M, void* stream) {
  const int per_block = 4;                     // one warp per MB
  const int blocks = (R * M + per_block - 1) / per_block;
  mb_encode_p_kernel<<<blocks, 32 * per_block, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      y, u, v, qp, send_rows, pred_y, pred_u, pred_v, mv, qp_mb, ref_y, ref_u,
      ref_v, lv, cbp, hdr_pay, hdr_nb, R, M);
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
