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
// one thread per MB for the shared AC flag and the header. P: K2-P's
// design (csrc/mb_encode.cu) on the 4:4:4 layout, a block of 4 MBs of a
// row and 192 threads, a thread a (component, 4x4 block), each warp one
// component (one QP, quant constants read once a thread); cur and the
// prediction staged in shared memory with 16-byte loads, the levels
// stored as whole 16-byte chunks, the recon as 16-byte row pieces, the
// cbp group bits ORed over the components through shared memory. With
// zero motion the prediction is the reference plane itself: a block
// stages it whole before its first barrier and writes recon only after
// its second, and blocks own disjoint MBs; with motion the prediction is
// K5's scratch planes. Launched behind the kernel before it
// (programmatic dependent launch). Bound: bytes (~29 MB at 1080p).
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
//
// A block takes P4_NB consecutive MBs of one row with 48 threads an MB, a
// thread a (component, 4x4 block): warps 0-1 code Y, 2-3 U, 4-5 V (a
// half-warp an MB), so each warp has one QP and each thread reads its
// quant constants once. The three planes' cur and prediction pixels are
// staged in shared memory (16-byte loads; a 4:4:4 row is 16 * M bytes,
// so rows are 16-byte aligned wherever the base is), all of them before
// the first barrier, so a prediction that is the reference itself is
// read whole before any recon is written. Each half-warp's 8x8 group
// bits go to shared memory; after the first barrier they are ORed over
// the three components (the MB's cbp) and gate the recon, which replaces
// the cur stage. Levels go into a shared stage as whole 32-byte slots
// and leave, after the second barrier, as the block's contiguous run of
// 16-byte chunks; the recon leaves as 16-byte row pieces for sent rows;
// a thread an MB writes its header slots and cbp as 8-byte pairs.
#define P4_NB 4                      // MBs a block, consecutive in one row
#define P4_THREADS (48 * P4_NB)      // a thread a (component, 4x4 block)
#define P4_PITCH (16 * P4_NB + 16)   // stage pitch (bytes)
#define P4_SLOT_V4 (2 * NB_P444)     // an MB's levels in 16-byte chunks

struct P4Stage {
  uint4 lv[P4_NB * P4_SLOT_V4];      // the block's levels, as stored
  // cur Y, U, V (then the recon), the prediction's Y, U, V
  uint8_t pix[6][16 * P4_PITCH];
  int g8[3][P4_NB];                  // each component's group bits
};

// FAST: every block of the shape is whole (M a multiple of P4_NB) and all
// nine planes sit on 16-byte boundaries (the host checks), so the stage
// moves in 16-byte pieces; otherwise each plane goes in the widest pieces
// it allows (a row's last block of fewer MBs, planes off 16 bytes). Two
// kernels, so the common one carries no code for the rare shapes (with
// the L2 cold a kernel's code comes from device memory).
template <bool FAST>
__global__ void __launch_bounds__(P4_THREADS, 4)
mb_encode_p444_kernel(const uint8_t* __restrict__ yp,
                      const uint8_t* __restrict__ up,
                      const uint8_t* __restrict__ vp,
                      const int* __restrict__ qp_rows,
                      const int* __restrict__ send_rows,
                      const uint8_t* pred_y, const uint8_t* pred_u,
                      const uint8_t* pred_v, const int* __restrict__ mv,
                      uint8_t* ref_y, uint8_t* ref_u, uint8_t* ref_v,
                      int16_t* __restrict__ lv, int* __restrict__ cbp_out,
                      int* __restrict__ hdr_pay, int* __restrict__ hdr_nb,
                      int M) {
  __shared__ P4Stage st;
  // the kernel before it has finished and its writes are visible: no read
  // comes before this
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int t = threadIdx.x, lane = t & 31;
  const int r = blockIdx.y, m0 = blockIdx.x * P4_NB;
  const int nb = M - m0 < P4_NB ? M - m0 : P4_NB;
  const int W = 16 * M;
  const int g0 = r * M + m0;
  // every global read a thread makes is issued before the first barrier:
  // the QP, the send gate, a header thread's vectors, the stage
  const int c = t >> 6;                          // component
  const int mb = (t >> 4) & 3, b = t & 15;       // MB, raster 4x4 block
  const int qp = qp_rows[r];
  const bool sent = send_rows[r] != 0;
  int mvx = 0, mvy = 0, lx = 0, ly = 0;
  if (mv && t < nb) {                            // MB t's header thread
    const int g = g0 + t;
    mvx = mv[2 * g];
    mvy = mv[2 * g + 1];
    if (m0 + t > 0) {                            // the left neighbour's
      lx = mv[2 * g - 2];
      ly = mv[2 * g - 1];
    }
  }
  const size_t o = static_cast<size_t>(16 * r) * W + 16 * m0;
  if constexpr (FAST) {
    // 6 planes x 16 rows x P4_NB pieces, two a thread, loads first
    constexpr int NP = 16 * P4_NB;
    constexpr int K = (6 * NP + P4_THREADS - 1) / P4_THREADS;
    uint4 v[K];
#pragma unroll
    for (int i = 0; i < K; i++) {
      const int j = t + i * P4_THREADS, p = j / NP, y = (j % NP) / P4_NB,
                k = j % P4_NB;
      // (a select chain: an indexed pointer array would live in local
      // memory)
      const uint8_t* src = p == 0 ? yp : p == 1 ? up : p == 2 ? vp
                         : p == 3 ? pred_y : p == 4 ? pred_u : pred_v;
      if (j < 6 * NP)
        v[i] = *reinterpret_cast<const uint4*>(
            src + o + static_cast<size_t>(y) * W + 16 * k);
    }
#pragma unroll
    for (int i = 0; i < K; i++) {
      const int j = t + i * P4_THREADS, p = j / NP, y = (j % NP) / P4_NB,
                k = j % P4_NB;
      if (j < 6 * NP)
        *reinterpret_cast<uint4*>(st.pix[p] + y * P4_PITCH + 16 * k) =
            v[i];
    }
  } else {
    const uint8_t* curp[3] = {yp, up, vp};
    const uint8_t* predp[3] = {pred_y, pred_u, pred_v};
#pragma unroll
    for (int p = 0; p < 3; p++) {
      stage_rect<true, 16 * P4_NB>(st.pix[p], P4_PITCH, curp[p] + o, W, 16,
                                   16 * nb, t, P4_THREADS);
      stage_rect<true, 16 * P4_NB>(st.pix[3 + p], P4_PITCH, predp[p] + o, W,
                                   16, 16 * nb, t, P4_THREADS);
    }
  }
  __syncthreads();

  // ---- thread (c, mb, b) codes 4x4 block b of component c of MB mb
  const int by = b >> 2, bx = b & 3;
  const QuantP q = quant_p_consts(c ? K_QPC[clampi(qp, 0, 51)] : qp, 6);
  const int so = 4 * by * P4_PITCH + 16 * mb + 4 * bx;
  int x[16], pr[16], w[16], acl[16];
  load4x4_shared(st.pix[c] + so, P4_PITCH, x);
  load4x4_shared(st.pix[3 + c] + so, P4_PITCH, pr);
#pragma unroll
  for (int k = 0; k < 16; k++) x[k] -= pr[k];
  fwd4(x, w);
#pragma unroll
  for (int k = 0; k < 16; k++)
    acl[k] = quant_p(w[k], q.mf[pos_cls(k)], q.f, q.qbits);
  // the MB's 16 blocks of this component are one half-warp: its four
  // 8x8 group bits
  const unsigned m16 =
      (__ballot_sync(0xffffffffu, any_nz(acl)) >> (lane & 16)) & 0xFFFFu;
  uint4* slots = st.lv + mb * P4_SLOT_V4;
  store_slot<false>(slots + 2 * (16 * c + coding_of_raster(b)), acl);
  if (b == 0)
    st.g8[c][mb] = ((m16 & 0x0033u) ? 1 : 0) | ((m16 & 0x00CCu) ? 2 : 0) |
                   ((m16 & 0x3300u) ? 4 : 0) | ((m16 & 0xCC00u) ? 8 : 0);
  __syncthreads();
  const int cbp = st.g8[0][mb] | st.g8[1][mb] | st.g8[2][mb];
  if (sent) {
    // a group's blocks of every component are dequantized when the MB's
    // cbp bit is set (which makes the MB coded)
    const bool on = (cbp >> ((by >> 1) * 2 + (bx >> 1))) & 1;
    int d[16], inv[16];
#pragma unroll
    for (int k = 0; k < 16; k++)
      d[k] = dequant_p(on ? acl[k] : 0, q.ls[pos_cls(k)], q.dadd, q.dsh);
    inv4(d, inv);
    load4x4_shared(st.pix[3 + c] + so, P4_PITCH, pr);
#pragma unroll
    for (int k = 0; k < 16; k++) x[k] = clip1(pr[k] + ((inv[k] + 32) >> 6));
    store4x4_shared(st.pix[c] + so, P4_PITCH, x);
  }
  __syncthreads();

  // ---- the block's MBs are contiguous in lv, cbp and the header slots
  const uint4* src = st.lv;
  uint4* dst = reinterpret_cast<uint4*>(lv) +
               static_cast<size_t>(g0) * P4_SLOT_V4;
  for (int i = t; i < nb * P4_SLOT_V4; i += P4_THREADS) dst[i] = src[i];
  if (sent) {
    if constexpr (FAST) {
      // 3 planes x 16 rows x P4_NB pieces: one a thread
      const int p = t / (16 * P4_NB), y = (t % (16 * P4_NB)) / P4_NB,
                k = t % P4_NB;
      uint8_t* dst8 = p == 0 ? ref_y : p == 1 ? ref_u : ref_v;
      *reinterpret_cast<uint4*>(dst8 + o + static_cast<size_t>(y) * W +
                                16 * k) =
          *reinterpret_cast<const uint4*>(st.pix[p] + y * P4_PITCH + 16 * k);
    } else {
      uint8_t* refp[3] = {ref_y, ref_u, ref_v};
#pragma unroll
      for (int p = 0; p < 3; p++)
        stage_rect<false, 16 * P4_NB>(st.pix[p], P4_PITCH, refp[p] + o, W,
                                      16, 16 * nb, t, P4_THREADS);
    }
  }
  if (t < nb) {
    const int g = g0 + t;
    const int mcbp = st.g8[0][t] | st.g8[1][t] | st.g8[2][t];
    int hp[HDR_SLOTS] = {0, 0, 0, 0, 0, 0}, hn[HDR_SLOTS] = {0, 0, 0, 0, 0, 0};
    if (mcbp != 0 || mvx != 0 || mvy != 0) {   // coded; slot 0, the skip
      // run, is the packer's. MV predictor = left neighbour (one slice
      // per MB row, §8.4.1.3)
      hp[1] = 1; hn[1] = 1;                    // mb_type P_L0_16x16
      se_event(mvx - lx, &hp[2], &hn[2]);
      se_event(mvy - ly, &hp[3], &hn[3]);
      ue_event(K_CBP444[mcbp], &hp[4], &hn[4]); // me(v), ChromaArrayType 3
      if (mcbp != 0) { hp[5] = 1; hn[5] = 1; } // mb_qp_delta ue(0)
    }
    int2* gp = reinterpret_cast<int2*>(hdr_pay + static_cast<size_t>(g) *
                                       HDR_SLOTS);
    int2* gn = reinterpret_cast<int2*>(hdr_nb + static_cast<size_t>(g) *
                                       HDR_SLOTS);
#pragma unroll
    for (int k = 0; k < HDR_SLOTS / 2; k++) {
      gp[k] = make_int2(hp[2 * k], hp[2 * k + 1]);
      gn[k] = make_int2(hn[2 * k], hn[2 * k + 1]);
    }
    cbp_out[g] = mcbp;
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

// every pointer on a 16-byte boundary
template <typename... T>
static bool aligned16(T... p) {
  return ((reinterpret_cast<uintptr_t>(p) % 16 == 0) && ...);
}

extern "C" int mb_encode_p444(const uint8_t* y, const uint8_t* u,
                              const uint8_t* v, const int* qp,
                              const int* send_rows, const uint8_t* pred_y,
                              const uint8_t* pred_u, const uint8_t* pred_v,
                              const int* mv, uint8_t* ref_y, uint8_t* ref_u,
                              uint8_t* ref_v, int16_t* lv, int* cbp,
                              int* hdr_pay, int* hdr_nb, int R, int M,
                              void* stream) {
  if (R <= 0 || M <= 0 || R > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // launched behind the kernel before it (programmatic dependent launch:
  // K5's 4:4:4 entry on the band path, K13 with zero motion), which it
  // waits for inside
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + P4_NB - 1) / P4_NB, R);
  cfg.blockDim = dim3(P4_THREADS);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const bool fast = M % P4_NB == 0 && aligned16(y, u, v, pred_y, pred_u,
                                                pred_v, ref_y, ref_u, ref_v);
  cudaLaunchKernelEx(&cfg,
                     fast ? mb_encode_p444_kernel<true>
                          : mb_encode_p444_kernel<false>,
                     y, u, v, qp, send_rows, pred_y, pred_u, pred_v, mv,
                     ref_y, ref_u, ref_v, lv, cbp, hdr_pay, hdr_nb, M);
  return static_cast<int>(cudaGetLastError());
}
