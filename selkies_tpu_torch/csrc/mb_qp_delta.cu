// K18 mb_qp_delta: ROI QP's mb_qp_delta carry chain. Every MB whose
// mb_qp_delta slot (header slot 5 of K2-P) carries bits, i.e. a coded MB
// with cbp != 0 (§7.3.5), gets se(qp_mb - qp_prev): qp_prev is the QP of
// the previous such MB of its row, or the row's slice QP for the first.
// Each MB row is one slice, so the chain restarts with every row; a
// motion-only MB (cbp == 0) carries no delta and does not move it.
//
// Replaces selkies_tpu/ops/h264_planes.py:_assemble_p_frame's qp_mb branch
// (the running-max carrier index, take_along_axis, _se_event).
//
// Bound on the H100: the launch (it reads slot 5 of hdr_nb and the QP
// plane and writes slot 5 of both header arrays: 4 x 4 x R x M bytes,
// 0.13 MB at 1080p). Design: one warp per MB row, walking the row in
// chunks of 32 MBs; in a chunk each lane finds the previous carrier below
// it with __ballot_sync and fetches its QP with __shfl_sync, and the
// chunk's last carrier's QP is carried into the next chunk.
#include "h264_common.cuh"

#define QPD_ROWS_PER_BLOCK 4

__global__ void mb_qp_delta_kernel(int* __restrict__ hdr_pay,
                                   int* __restrict__ hdr_nb,
                                   const int* __restrict__ qp_mb,
                                   const int* __restrict__ qp_rows, int R,
                                   int M) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * QPD_ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (r >= R) return;                          // whole warp leaves together
  int carry = qp_rows[r];
  for (int base = 0; base < M; base += 32) {
    const int m = base + lane;
    const size_t g = static_cast<size_t>(r) * M + m;
    const bool in = m < M;
    const bool gated = in && hdr_nb[g * HDR_SLOTS + 5] > 0;
    const int q = in ? qp_mb[g] : 0;
    const unsigned bal = __ballot_sync(0xffffffffu, gated);
    const unsigned below = bal & ((1u << lane) - 1u);
    const int src = below ? 31 - __clz(below) : lane;
    const int q_below = __shfl_sync(0xffffffffu, q, src);
    if (gated) {
      int p, n;
      se_event(q - (below ? q_below : carry), &p, &n);
      hdr_pay[g * HDR_SLOTS + 5] = p;
      hdr_nb[g * HDR_SLOTS + 5] = n;
    }
    const int last = bal ? 31 - __clz(bal) : 0;
    const int q_last = __shfl_sync(0xffffffffu, q, last);
    if (bal) carry = q_last;
  }
}

extern "C" int mb_qp_delta(int* hdr_pay, int* hdr_nb, const int* qp_mb,
                           const int* qp_rows, int R, int M, void* stream) {
  const int blocks = (R + QPD_ROWS_PER_BLOCK - 1) / QPD_ROWS_PER_BLOCK;
  mb_qp_delta_kernel<<<blocks, 32 * QPD_ROWS_PER_BLOCK, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      hdr_pay, hdr_nb, qp_mb, qp_rows, R, M);
  return static_cast<int>(cudaGetLastError());
}
