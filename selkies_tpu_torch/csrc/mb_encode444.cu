// K14 mb_encode_i444 / K15 mb_encode_p444: per-macroblock transform /
// quant / dequant / recon of 4:4:4 (``fullcolor``) IDR and P frames, all
// three components coded luma-style at full resolution.
//
// Replaces selkies_tpu/ops/h264_planes444.py:_comp_intra, _dc_scan_comp,
// the h264_encode_yuv444 body (the shared AC flag, the 2-slot MB header,
// the recon of all three components) and the h264_encode_p_yuv444 body
// (three residuals quantised with fdiv 6, cbp group bits over all
// components, ``coded``, blk_on, the recon), the MB header events of
// _assemble_444 / _assemble_p_444 (the cbp through
// CBP444_INTER_CBP2CODE), and the send-gated reference advance of
// engine/h264_encoder.py:build_h264_step_fn / build_h264_band_step_fn at
// fullcolor.
//
// Bound on the H100: bytes (I: the three planes in, the levels and the
// recon out, ~26 MB at 1080p; P: planes, prediction and reference in,
// reference and levels out, ~31 MB); the I frame's DC chain is serial
// along each MB row, now three chains a row.
//
// Design. I: one block per MB row. Phase 1: half-warps take (component,
// MB) pairs, a lane per 4x4 block: the AC path (independent of the DC
// prediction, which is constant per MB), the raw DC terms and the
// inverse's right-edge columns into shared memory. Phase 2: warps 0, 1
// and 2 each walk one component's DC / left-edge chain along the row
// (16 lanes on the DC coefficients; pred 128 at m = 0, else
// (edge.sum + 8) >> 4 of that component's edge, exactly as
// _dc_scan_comp orders it). Phase 3: the recon, recomputed from the
// pixels, into the reference planes for rows whose stripe is sent, and
// one thread per MB for the shared AC flag and the header. P: one
// half-warp per MB, a lane per block position walking the three
// components; the group bits are a half-warp OR reduction. With zero
// motion the prediction is the reference plane itself: each lane reads
// its own 4x4 of a component before it writes it, and no other lane
// touches it; with motion the prediction is K5's scratch planes.
#include "h264_common.cuh"

// ---------------------------------------------------------------- I frames
// shared layout (ints), index p = c * M + m of a (component, MB) pair
#define SI_DC(p) (sm + (p) * 16)                // raw W00 by raster block
#define SI_E(p) (sm + 48 * M + (p) * 16)        // inv right edge by*4+row
#define SI_Q(p) (sm + 96 * M + (p) * 16)        // dequantized DC by raster
#define SI_P(p) (sm + 144 * M + (p))            // DC prediction
#define SI_FL(p) (sm + 147 * M + (p))           // AC levels present
#define SI_INTS(M) (150 * (M) + 96)

__global__ void mb_encode_i444_kernel(const uint8_t* __restrict__ yp,
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
  const int r = blockIdx.x;
  const int W = M * 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int l = lane & 15, half = lane >> 4;
  const int by = l >> 2, bx = l & 3;
  const int qp = qp_rows[r];
  const int qpc = K_QPC[clampi(qp, 0, 51)];
  const uint8_t* planes[3] = {yp, up, vp};
  uint8_t* refs[3] = {ref_y, ref_u, ref_v};
  int16_t* lv_row = lv + static_cast<size_t>(r) * M * NB_I444 * 16;
  const int n_pairs = 3 * M;

  // ---- phase 1: AC levels, raw DC terms, inverse right edges. Both
  // halves of a warp run the same number of iterations (the ballot).
  for (int base = 2 * warp; base < n_pairs; base += 2 * nwarps) {
    const int p = base + half;
    const bool active = p < n_pairs;
    bool nz = false;
    if (active) {
      const int c = p / M, m = p % M;
      int x[16], w[16], acl[16], inv[16];
      load4x4(planes[c], W, 16 * r + 4 * by, 16 * m + 4 * bx, x);
      intra_ac(x, c ? qpc : qp, w, acl, inv);
      SI_DC(p)[l] = w[0];
      int16_t* lv_mb = lv_row + static_cast<size_t>(m) * NB_I444 * 16;
      store_scan(lv_mb + (17 * c + 1 + K_CODING_OF_RASTER[l]) * 16, acl, 1);
      nz = any_nz(acl);
      if (bx == 3)
        for (int i = 0; i < 4; i++) SI_E(p)[by * 4 + i] = inv[4 * i + 3];
    }
    const unsigned bal = __ballot_sync(0xffffffffu, nz);
    if (active && l == 0) SI_FL(p)[0] = ((bal >> (16 * half)) & 0xFFFFu) != 0;
  }
  __syncthreads();

  // ---- phase 2: one warp per component walks its DC / left-edge chain
  if (warp < 3) {
    const int c = warp;
    const int q = c ? qpc : qp;
    int* s_edge = sm + 150 * M + 32 * c;    // 16
    int* s_a = s_edge + 16;                 // 16: DC levels of the MB step
    const bool on = lane < 16;
    const int i = lane >> 2, j = lane & 3;
    for (int m = 0; m < M; m++) {
      const int p = c * M + m;
      int16_t* lv_mb = lv_row + static_cast<size_t>(m) * NB_I444 * 16;
      int pred = 128;
      if (m > 0) {
        int s = 0;
        for (int k = 0; k < 16; k++) s += s_edge[k];
        pred = (s + 8) >> 4;
      }
      if (on) {
        int hd = 0;
        for (int a = 0; a < 4; a++)
          for (int b = 0; b < 4; b++)
            hd += h4(i, a) * (SI_DC(p)[a * 4 + b] - 16 * pred) * h4(b, j);
        s_a[lane] = quant_dc(hd >> 1, q);
      }
      __syncwarp();
      if (on) {
        int f = 0;
        for (int a = 0; a < 4; a++)
          for (int b = 0; b < 4; b++) f += h4(i, a) * s_a[a * 4 + b] * h4(b, j);
        SI_Q(p)[lane] = dequant_ldc(f, q);
        lv_mb[17 * c * 16 + K_INV_ZIGZAG[lane]] =
            static_cast<int16_t>(s_a[lane]);
        if (lane == 0) SI_P(p)[0] = pred;
      }
      __syncwarp();
      if (on)
        s_edge[lane] = clip1(
            pred + ((SI_E(p)[i * 4 + j] + SI_Q(p)[i * 4 + 3] + 32) >> 6));
      __syncwarp();
    }
  }
  __syncthreads();

  // ---- phase 3: recon into the reference planes, MB outputs
  if (send[r / rows_per_stripe] != 0) {
    for (int base = 2 * warp; base < n_pairs; base += 2 * nwarps) {
      const int p = base + half;
      if (p >= n_pairs) continue;
      const int c = p / M, m = p % M;
      int x[16], w[16], acl[16], inv[16], rec[16];
      load4x4(planes[c], W, 16 * r + 4 * by, 16 * m + 4 * bx, x);
      intra_ac(x, c ? qpc : qp, w, acl, inv);
      const int pr = SI_P(p)[0], dc = SI_Q(p)[l];
      for (int k = 0; k < 16; k++) rec[k] = clip1(pr + ((inv[k] + dc + 32) >> 6));
      store4x4(refs[c], W, 16 * r + 4 * by, 16 * m + 4 * bx, rec);
    }
  }
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const bool ac = SI_FL(m)[0] | SI_FL(M + m)[0] | SI_FL(2 * M + m)[0];
    const size_t g = static_cast<size_t>(r) * M + m;
    cbp_out[g] = ac ? 15 : 0;
    int* hp = hdr_pay + g * HDR_SLOTS;
    int* hn = hdr_nb + g * HDR_SLOTS;
    ue_event(3 + (ac ? 12 : 0), &hp[0], &hn[0]);  // mb_type I_16x16_0_0_x
    hp[1] = 1; hn[1] = 1;                          // mb_qp_delta se(0)
    for (int k = 2; k < HDR_SLOTS; k++) { hp[k] = 0; hn[k] = 0; }
  }
}

// ---------------------------------------------------------------- P frames
// pred_* may alias ref_* (zero motion, mv null); mv (R, M, 2) quarter-pel
// (mvx, mvy); send_rows (R,) gates the recon write per MB row.
__global__ void mb_encode_p444_kernel(const uint8_t* __restrict__ yp,
                                      const uint8_t* __restrict__ up,
                                      const uint8_t* __restrict__ vp,
                                      const int* __restrict__ qp_rows,
                                      const int* __restrict__ send_rows,
                                      const uint8_t* pred_y,
                                      const uint8_t* pred_u,
                                      const uint8_t* pred_v,
                                      const int* __restrict__ mv,
                                      uint8_t* ref_y, uint8_t* ref_u,
                                      uint8_t* ref_v, int16_t* __restrict__ lv,
                                      int* __restrict__ cbp_out,
                                      int* __restrict__ hdr_pay,
                                      int* __restrict__ hdr_nb, int R, int M) {
  const int g = (blockIdx.x * blockDim.x + threadIdx.x) >> 4;
  if (g >= R * M) return;                      // whole half-warp leaves
  const unsigned hmask = 0xFFFFu << (threadIdx.x & 16);
  const int l = threadIdx.x & 15;
  const int r = g / M, m = g % M;
  const int W = M * 16;
  const int by = l >> 2, bx = l & 3;
  const int r0 = 16 * r + 4 * by, c0 = 16 * m + 4 * bx;
  const int g8 = (by >> 1) * 2 + (bx >> 1);
  const int qp = qp_rows[r];
  const int qpc = K_QPC[clampi(qp, 0, 51)];
  const uint8_t* cur[3] = {yp, up, vp};
  const uint8_t* pred[3] = {pred_y, pred_u, pred_v};
  uint8_t* ref[3] = {ref_y, ref_u, ref_v};
  int16_t* lv_mb = lv + static_cast<size_t>(g) * NB_P444 * 16;
  const int mvx = mv ? mv[2 * g] : 0, mvy = mv ? mv[2 * g + 1] : 0;

  int acl[3][16];
  bool nz = false;
#pragma unroll
  for (int c = 0; c < 3; c++) {
    int x[16], pr[16], w[16];
    load4x4(cur[c], W, r0, c0, x);
    load4x4(pred[c], W, r0, c0, pr);
    for (int k = 0; k < 16; k++) x[k] -= pr[k];
    fwd4(x, w);
    const int qq = c ? qpc : qp;
    for (int k = 0; k < 16; k++)
      acl[c][k] = quant_ac(w[k], qq, K_POS_CLS[k], 6);
    store_scan(lv_mb + (16 * c + K_CODING_OF_RASTER[l]) * 16, acl[c], 0);
    nz |= any_nz(acl[c]);
  }
  const int cbp = __reduce_or_sync(hmask, nz ? (1 << g8) : 0);
  const bool coded = cbp != 0 || mvx != 0 || mvy != 0;

  if (send_rows[r] != 0) {
    const bool on = ((cbp >> g8) & 1) && coded;
#pragma unroll
    for (int c = 0; c < 3; c++) {
      const int qq = c ? qpc : qp;
      int pr[16], d[16], inv[16], rec[16];
      load4x4(pred[c], W, r0, c0, pr);
      for (int k = 0; k < 16; k++)
        d[k] = dequant_ac(on ? acl[c][k] : 0, qq, K_POS_CLS[k]);
      inv4(d, inv);
      for (int k = 0; k < 16; k++) rec[k] = clip1(pr[k] + ((inv[k] + 32) >> 6));
      store4x4(ref[c], W, r0, c0, rec);
    }
  }
  if (l == 0) {
    cbp_out[g] = cbp;
    int* hp = hdr_pay + static_cast<size_t>(g) * HDR_SLOTS;
    int* hn = hdr_nb + static_cast<size_t>(g) * HDR_SLOTS;
    for (int k = 0; k < HDR_SLOTS; k++) { hp[k] = 0; hn[k] = 0; }
    if (coded) {                               // slot 0, the skip run: K4's
      // MV predictor = left neighbour (one slice per MB row, §8.4.1.3)
      const int lx = (m > 0 && mv) ? mv[2 * g - 2] : 0;
      const int ly = (m > 0 && mv) ? mv[2 * g - 1] : 0;
      hp[1] = 1; hn[1] = 1;                    // mb_type P_L0_16x16
      se_event(mvx - lx, &hp[2], &hn[2]);
      se_event(mvy - ly, &hp[3], &hn[3]);
      ue_event(K_CBP444[cbp], &hp[4], &hn[4]); // me(v), ChromaArrayType 3
      if (cbp != 0) { hp[5] = 1; hn[5] = 1; }  // mb_qp_delta ue(0)
    }
  }
}

extern "C" int mb_encode_i444(const uint8_t* y, const uint8_t* u,
                              const uint8_t* v, const int* qp, const int* send,
                              int rows_per_stripe, uint8_t* ref_y,
                              uint8_t* ref_u, uint8_t* ref_v, int16_t* lv,
                              int* cbp, int* hdr_pay, int* hdr_nb, int R,
                              int M, void* stream) {
  const size_t smem = sizeof(int) * SI_INTS(M);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(mb_encode_i444_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  mb_encode_i444_kernel<<<R, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      y, u, v, qp, send, rows_per_stripe, ref_y, ref_u, ref_v, lv, cbp,
      hdr_pay, hdr_nb, M);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mb_encode_p444(const uint8_t* y, const uint8_t* u,
                              const uint8_t* v, const int* qp,
                              const int* send_rows, const uint8_t* pred_y,
                              const uint8_t* pred_u, const uint8_t* pred_v,
                              const int* mv, uint8_t* ref_y, uint8_t* ref_u,
                              uint8_t* ref_v, int16_t* lv, int* cbp,
                              int* hdr_pay, int* hdr_nb, int R, int M,
                              void* stream) {
  const int threads = 128;                     // 8 MBs a block
  const int blocks = (16 * R * M + threads - 1) / threads;
  mb_encode_p444_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      y, u, v, qp, send_rows, pred_y, pred_u, pred_v, mv, ref_y, ref_u, ref_v,
      lv, cbp, hdr_pay, hdr_nb, R, M);
  return static_cast<int>(cudaGetLastError());
}
