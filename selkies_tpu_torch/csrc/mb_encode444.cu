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
// Bound on the H100: bytes (I: the three planes in, the levels, headers
// and the sent recon out, ~23 MB at 1080p; P: planes, prediction and
// reference in, reference and levels out, ~29 MB) and, for I frames
// below that, the serial DC chains: each MB row's three predictions run
// left to right over its 120 MBs, ~20 dependent integer operations an
// MB once each chain is cut to the terms that depend on it.
//
// I: K2-I's three grids (csrc/mb_encode.cu) with three luma-style chains
// (Y at qp, Cb and Cr at K_QPC[qp]) and no 2x2 chroma chain, each cut as
// csrc/intra_dc.cuh sets out:
// 1. i444_records_kernel: 16 MBs of a row a block of 192 threads, a warp
//    pair a component, 4 lanes a (component, MB) (a lane a row of
//    blocks), over the whole card: each block's DC sum, the right-edge
//    block's AC path down to its inverse's right column, the pred-free
//    Hadamard terms (along the row in a lane, down the column by
//    shuffles): each MB's 64-int chain record, the row's records back to
//    back at the start of the row's lv (1632 bytes an MB, which only the
//    third grid writes).
// 2. i444_chain_kernel: a block a row, in plain stream order. Its records
//    come into shared memory by TMA bulk copies (warp 3) while the chains
//    start on the first; component c's chain on 16 lanes of warp c (a
//    right-edge pixel a lane, one warp reduction a step), so each chain
//    has a scheduler of its own; each MB's words pred | (level00 + 4096)
//    << 16 into hdr_pay slots 0-2 (rewritten by the third grid).
// 3. i444_code_kernel: K15's block shape, 4 MBs of a row a block of 192
//    threads (a thread a (component, 4x4 block), a warp pair a
//    component), over the whole card: the MBs staged in shared memory with
//    16-byte loads, the whole transform again (AC levels out as 32-byte
//    slots, the inverse of the AC part), the DC levels and Frest by
//    butterflies across an MB's 16 lanes, the chains' words, the recon
//    into the stage and out as 16-byte row pieces for sent rows, the DC
//    slots, the shared AC flag (cbp 15 or 0) and the header slots 0-5.
// The first and the third grid are launched with programmatic dependent
// launch, the chain grid in stream order (K2-I's chains ran 2-3x slower
// under PDL).
// P: K2-P's design (csrc/mb_encode.cu) on the 4:4:4 layout, a block of 4
// MBs of a row and 192 threads, a thread a (component, 4x4 block), each
// warp one component (one QP, quant constants read once a thread); cur
// and the prediction staged in shared memory with 16-byte loads, the
// levels stored as whole 16-byte chunks, the recon as 16-byte row
// pieces, the cbp group bits ORed over the components through shared
// memory. With zero motion the prediction is the reference plane itself:
// a block stages it whole before its first barrier and writes recon only
// after its second, and blocks own disjoint MBs; with motion the
// prediction is K5's scratch planes. Launched behind the kernel before
// it (programmatic dependent launch). Bound: bytes (~29 MB at 1080p).
#include "intra_dc.cuh"

// every pointer on a 16-byte boundary
template <typename... T>
static bool aligned16(T... p) {
  return ((reinterpret_cast<uintptr_t>(p) % 16 == 0) && ...);
}

// ---------------------------------------------------------------- I frames
#define I4_NB 4                      // MBs a tile of the coding grid
#define I4_THREADS (48 * I4_NB)      // a thread a (component, 4x4 block)
#define I4_PITCH (16 * I4_NB + 16)   // stage pitch (bytes)
#define I4_REC_MBS 16                // MBs a block of the records grid
#define I4_REC 64                    // ints of an MB's chain record

// an MB's record (ints): [16c, 16c + 16) component c's right edge's
// inverse + 32 (block row by at 16c + 4by), 48 + 4c + by Frest's right
// column, 60 + c (HWH)00 >> 1 (63 unused). Its outputs (words of
// hdr_pay): slot c, component c's pred | (level00 + 4096) << 16.
struct I4Stage {
  uint8_t pix[3][16 * I4_PITCH];     // the tile's Y, U, V, then the recon
  alignas(16) int16_t dcs[I4_NB][3][16];  // each component's DC slot
  int ac[3][I4_NB];                  // each component's AC flag
};

// The first grid (FAST: 16-byte row loads, the planes 16-byte aligned;
// else byte loads): each MB's chain record into the row's lv.
template <bool FAST>
__global__ void __launch_bounds__(192)
i444_records_kernel(const uint8_t* __restrict__ yp,
                    const uint8_t* __restrict__ up,
                    const uint8_t* __restrict__ vp,
                    const int* __restrict__ qp_rows,
                    int16_t* __restrict__ lv, int M) {
  // the kernel before it (K13) has finished: no read comes before this
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.y, by = lane & 3, c = warp >> 1;
  const int m = I4_REC_MBS * blockIdx.x + 8 * (warp & 1) + (lane >> 2);
  const bool on = m < M;
  const int W = 16 * M;
  const int qp = qp_rows[r];
  const int q = c ? K_QPC[clampi(qp, 0, 51)] : qp;
  const QuantDC dq = quant_dc_consts(q, true);
  const uint8_t* plane = c == 0 ? yp : c == 1 ? up : vp;
  // the lane's row of blocks: four 16-byte pixel rows
  unsigned w[4][4];
#pragma unroll
  for (int i = 0; i < 4; i++) {
    w[i][0] = w[i][1] = w[i][2] = w[i][3] = 0u;
    if (!on) continue;
    const uint8_t* p = plane + static_cast<size_t>(16 * r + 4 * by + i) * W
                       + 16 * m;
    if (FAST) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[i][0] = v.x; w[i][1] = v.y; w[i][2] = v.z; w[i][3] = v.w;
    } else {
#pragma unroll
      for (int b = 0; b < 16; b++)
        w[i][b >> 2] |= static_cast<unsigned>(p[b]) << (8 * (b & 3));
    }
  }
  // the blocks' DC sums, the right-edge block's inverse column
  int dcs[4], x[16], e[4];
#pragma unroll
  for (int b = 0; b < 4; b++) {
    unsigned s = 0;
#pragma unroll
    for (int i = 0; i < 4; i++) s = __dp4a(w[i][b], 0x01010101u, s);
    dcs[b] = static_cast<int>(s);
  }
#pragma unroll
  for (int i = 0; i < 4; i++) bytes4(w[i][3], x + 4 * i);
  intra_edge(x, quant_p_consts(q, 3), e);
  // (H W H) rows over the (component, MB)'s four lanes, Frest's rows
  int h[4], s[4];
  dc_rows(dcs, by, dq, h, s);
  if (on) {
    int* base = reinterpret_cast<int*>(lv + static_cast<size_t>(r) * M
                                       * (16 * NB_I444))
                + I4_REC * m;
    reinterpret_cast<int4*>(base + 16 * c)[by] =
        make_int4(e[0], e[1], e[2], e[3]);
    base[48 + 4 * c + by] = s[3];
    if (by == 0) base[60 + c] = h[0] >> 1;
  }
}

// component c's chain of a row (csrc/intra_dc.cuh) on 16 lanes, its words
// at out[HDR_SLOTS * m + c]
__device__ __forceinline__ void comp_chain(const int* rec,
                                           unsigned long long* bars, int M,
                                           int* out, int c, int k,
                                           const QuantDC& q) {
  dc_chain<I4_REC, HDR_SLOTS>(rec + 16 * c, rec + 48 + 4 * c, rec + 60 + c,
                              bars, M, out + c, k, q);
}

// The second grid: a block a row, 128 threads (the three chains on warps
// 0-2, the copies from warp 3).
__global__ void __launch_bounds__(128)
i444_chain_kernel(const int16_t* __restrict__ lv,
                  const int* __restrict__ qp_rows, int* __restrict__ hdr_pay,
                  int M) {
  extern __shared__ int4 rec4[];
  int* rec = reinterpret_cast<int*>(rec4);
  const int r = blockIdx.x, t = threadIdx.x;
  const int groups = (M + I_GROUP - 1) / I_GROUP;
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(rec + I4_REC * M);
  if (t == 0) {
    for (int g = 0; g < groups; g++) mbar_init(bars + g, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (t == 96)   // the row's records, contiguous at the start of its lv
    load_records(rec, reinterpret_cast<const int*>(
                          lv + static_cast<size_t>(r) * M * (16 * NB_I444)),
                 bars, M, I4_REC);
  const int qp = qp_rows[r];
  // the words into shared memory, out to the row's header slots at the
  // end in one pass of the block
  int* out = reinterpret_cast<int*>(bars + groups);
  const int c = t >> 5, lane = t & 31;
  if (c < 3 && lane < 16)
    comp_chain(rec, bars, M, out, c, lane,
               quant_dc_consts(c ? K_QPC[clampi(qp, 0, 51)] : qp, true));
  __syncthreads();
  int* dst = hdr_pay + static_cast<size_t>(r) * M * HDR_SLOTS;
  for (int i = t; i < M * HDR_SLOTS; i += 128) dst[i] = out[i];
}

// The third grid. FAST: every block is whole (M a multiple of I4_NB) and
// the six planes sit on 16-byte boundaries (the host checks), so the
// stage moves in 16-byte pieces; otherwise in the widest pieces each
// plane allows. Separate kernels, so the common one carries no code for
// the rare shapes.
template <bool FAST>
__global__ void __launch_bounds__(I4_THREADS, 4)
i444_code_kernel(const uint8_t* __restrict__ yp,
                 const uint8_t* __restrict__ up,
                 const uint8_t* __restrict__ vp,
                 const int* __restrict__ qp_rows,
                 const int* __restrict__ send, int rows_per_stripe,
                 uint8_t* ref_y, uint8_t* ref_u, uint8_t* ref_v,
                 int16_t* __restrict__ lv, int* __restrict__ cbp_out,
                 int* __restrict__ hdr_pay, int* __restrict__ hdr_nb, int M) {
  __shared__ I4Stage st;
  const int t = threadIdx.x, lane = t & 31;
  const int r = blockIdx.y, m0 = blockIdx.x * I4_NB;
  const int nb = M - m0 < I4_NB ? M - m0 : I4_NB;
  const int c = t >> 6;                          // component
  const int mb = (t >> 4) & 3, b = t & 15;       // MB, raster 4x4 block
  const int W = 16 * M;
  const size_t o = static_cast<size_t>(16 * r) * W + 16 * m0;
  // the planes were final before the first grid started (it waits for
  // the kernel before it), so they are staged before the wait for the
  // chains
  if constexpr (FAST) {
    // 3 planes x 16 rows x I4_NB pieces: one a thread
    const int p = t / (16 * I4_NB), y = (t % (16 * I4_NB)) / I4_NB,
              k = t % I4_NB;
    const uint8_t* src = p == 0 ? yp : p == 1 ? up : vp;
    *reinterpret_cast<uint4*>(st.pix[p] + y * I4_PITCH + 16 * k) =
        *reinterpret_cast<const uint4*>(src + o + static_cast<size_t>(y) * W
                                        + 16 * k);
  } else {
    const uint8_t* curp[3] = {yp, up, vp};
#pragma unroll
    for (int p = 0; p < 3; p++)
      stage_rect<true, 16 * I4_NB>(st.pix[p], I4_PITCH, curp[p] + o, W, 16,
                                   16 * nb, t, I4_THREADS);
  }
  const int qp = qp_rows[r];
  const int q = c ? K_QPC[clampi(qp, 0, 51)] : qp;
  const bool sent = send[r / rows_per_stripe] != 0;
  __syncthreads();
  // the chain grid has finished: its words, and lv free to be written
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const size_t g = static_cast<size_t>(r) * M + m0 + mb;
  const unsigned cw = mb < nb ? static_cast<unsigned>(hdr_pay[g * HDR_SLOTS
                                                              + c])
                              : 0u;
  // ---- thread (c, mb, b) codes 4x4 block b of component c of MB mb
  const int by = b >> 2, bx = b & 3;
  const QuantP qa = quant_p_consts(q, 3);
  const QuantDC dq = quant_dc_consts(q, true);
  uint8_t* sc = st.pix[c] + 4 * by * I4_PITCH + 16 * mb + 4 * bx;
  int x[16], w[16], acl[16], d[16], inv[16];
  load4x4_shared(sc, I4_PITCH, x);
  fwd4(x, w);
  acl[0] = 0;
  d[0] = 0;
#pragma unroll
  for (int k = 1; k < 16; k++) {
    acl[k] = quant_p(w[k], qa.mf[pos_cls(k)], qa.f, qa.qbits);
    d[k] = dequant_p(acl[k], qa.ls[pos_cls(k)], qa.dadd, qa.dsh);
  }
  uint4* slots = reinterpret_cast<uint4*>(lv) + g * (2 * NB_I444);
  if (mb < nb)
    store_slot<true>(slots + 2 * (17 * c + 1 + coding_of_raster(b)), acl);
  // the MB's 16 blocks of this component are one half-warp
  const unsigned m16 =
      (__ballot_sync(0xffffffffu, any_nz(acl)) >> (lane & 16)) & 0xFFFFu;
  if (b == 0) st.ac[c][mb] = m16 != 0;
  inv4(d, inv);
  // the MB's DC terms over its 16 lanes
  int lvl, f;
  dc_lanes(w[0], b, dq, lvl, f);
  if (mb < nb) {
    const int pred = static_cast<int>(cw & 0xFFFFu);
    const int dl = static_cast<int>(cw >> 16) - 4096;
    if (b == 0) lvl = dl;
    const int dqv = dequant_dcq(f + dl, dq);
#pragma unroll
    for (int k = 0; k < 16; k++)
      x[k] = clip1(pred + ((inv[k] + dqv + 32) >> 6));
    store4x4_shared(sc, I4_PITCH, x);
    st.dcs[mb][c][zz_pos(4 * sig(by) + sig(bx))] = static_cast<int16_t>(lvl);
  }
  __syncthreads();
  // ---- the tile's recon, DC slots, cbp and headers
  if (sent) {
    if constexpr (FAST) {
      const int p = t / (16 * I4_NB), y = (t % (16 * I4_NB)) / I4_NB,
                k = t % I4_NB;
      uint8_t* dst = p == 0 ? ref_y : p == 1 ? ref_u : ref_v;
      *reinterpret_cast<uint4*>(dst + o + static_cast<size_t>(y) * W
                                + 16 * k) =
          *reinterpret_cast<const uint4*>(st.pix[p] + y * I4_PITCH + 16 * k);
    } else {
      uint8_t* refp[3] = {ref_y, ref_u, ref_v};
#pragma unroll
      for (int p = 0; p < 3; p++)
        stage_rect<false, 16 * I4_NB>(st.pix[p], I4_PITCH, refp[p] + o, W,
                                      16, 16 * nb, t, I4_THREADS);
    }
  }
  const size_t g0 = static_cast<size_t>(r) * M + m0;
  if (t < 6 * nb) {
    // the DC slots 0, 17, 34 of MB t / 6, two pieces each
    const int hm = t / 6, k = t - 6 * hm, cc = k >> 1;
    reinterpret_cast<uint4*>(lv)[(g0 + hm) * (2 * NB_I444) + 34 * cc
                                 + (k & 1)] =
        reinterpret_cast<const uint4*>(st.dcs[hm][cc])[k & 1];
  } else if (t >= 32 && t < 32 + nb) {
    // MB t - 32's shared AC flag, cbp and header slots
    const int hm = t - 32;
    const bool ac = st.ac[0][hm] | st.ac[1][hm] | st.ac[2][hm];
    int hp[HDR_SLOTS] = {0, 1, 0, 0, 0, 0}, hn[HDR_SLOTS] = {0, 1, 0, 0, 0, 0};
    ue_event(3 + (ac ? 12 : 0), &hp[0], &hn[0]);  // mb_type I_16x16_0_0_x
    // slot 1: mb_qp_delta se(0)
    int2* gp = reinterpret_cast<int2*>(hdr_pay + (g0 + hm) * HDR_SLOTS);
    int2* gn = reinterpret_cast<int2*>(hdr_nb + (g0 + hm) * HDR_SLOTS);
#pragma unroll
    for (int k = 0; k < HDR_SLOTS / 2; k++) {
      gp[k] = make_int2(hp[2 * k], hp[2 * k + 1]);
      gn[k] = make_int2(hn[2 * k], hn[2 * k + 1]);
    }
    cbp_out[g0 + hm] = ac ? 15 : 0;
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
  if (R <= 0 || M <= 0 || rows_per_stripe <= 0 || R > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool fast = M % I4_NB == 0 && aligned16(y, u, v, ref_y, ref_u,
                                                ref_v);
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
    cudaFuncSetAttribute(i444_chain_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    optin[dev] = smem;
  }
  const int smem = 4 * (I4_REC + HDR_SLOTS) * M
                   + 8 * ((M + I_GROUP - 1) / I_GROUP);
  if (smem > optin[dev]) return static_cast<int>(cudaErrorInvalidValue);
  // the first grid behind the kernel before it (programmatic dependent
  // launch: K13 in the I step) and the coding grid behind the chain grid,
  // each waiting for the one before inside; the chain grid in stream order
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3((M + I4_REC_MBS - 1) / I4_REC_MBS, R);
  cfg.blockDim = dim3(192);
  cudaLaunchKernelEx(&cfg,
                     fast ? i444_records_kernel<true>
                          : i444_records_kernel<false>,
                     y, u, v, qp, lv, M);
  i444_chain_kernel<<<R, 128, smem, cfg.stream>>>(lv, qp, hdr_pay, M);
  cfg.gridDim = dim3((M + I4_NB - 1) / I4_NB, R);
  cfg.blockDim = dim3(I4_THREADS);
  cudaLaunchKernelEx(&cfg,
                     fast ? i444_code_kernel<true> : i444_code_kernel<false>,
                     y, u, v, qp, send, rows_per_stripe, ref_y, ref_u, ref_v,
                     lv, cbp, hdr_pay, hdr_nb, M);
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
