// K17 roi_qp_plane: ROI QP's per-MB QP plane of a band. An MB is dirty
// where any byte of its 16x16x3 block differs from the damage reference;
// a dirty MB is coded at its row's QP less the bias, a clean one at the
// row's QP, both clipped to [8, 48].
//
// Replaces selkies_tpu/engine/h264_encoder.py:build_h264_band_step_fn's
// ROI branch (mb_dirty = jnp.any((band != prev_band).reshape(band_rows,
// 16, width // 16, 48), axis=(1, 3)); qp_mb = jnp.clip(jnp.where(mb_dirty,
// qp_rows[:, None] - roi_qp, qp_rows[:, None]), 8, 48)).
//
// Bound on the H100: bytes (the band of the frame and of prev read once,
// 2 x 6.27 MB for a whole 1920x1088 frame; an or per byte). Design: one
// block per segment of eight MBs of an MB row, one warp per MB. The MB's
// 16 pixel rows are 48 contiguous bytes each: 48 16-byte vectors, which
// the warp's lanes XOR (lane l takes vectors l and l + 32), then one
// __any_sync and lane 0 writes the MB's QP. It runs before K1 on the same
// stream, so prev is still the previous frame. Pointers that are not
// 16-byte aligned take a byte loop (a row of MBs is 48 * M bytes, always
// a multiple of 16).
#include "h264_common.cuh"

#define ROI_MBS_PER_BLOCK 8

__global__ void roi_qp_plane_kernel(const uint8_t* __restrict__ frame,
                                    const uint8_t* __restrict__ prev,
                                    const int* __restrict__ qp_rows,
                                    int* __restrict__ qp_mb, int M, int bias,
                                    int vec) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * ROI_MBS_PER_BLOCK + (threadIdx.x >> 5);
  const int r = blockIdx.y;
  if (m >= M) return;                          // whole warp leaves together
  const size_t row_bytes = static_cast<size_t>(M) * 48;
  const size_t base = static_cast<size_t>(r) * 16 * row_bytes
                      + static_cast<size_t>(m) * 48;
  unsigned diff = 0;
  if (vec) {
    for (int i = lane; i < 48; i += 32) {
      const size_t off = base + (i / 3) * row_bytes + (i % 3) * 16;
      const uint4 x = *reinterpret_cast<const uint4*>(frame + off);
      const uint4 y = *reinterpret_cast<const uint4*>(prev + off);
      diff |= (x.x ^ y.x) | (x.y ^ y.y) | (x.z ^ y.z) | (x.w ^ y.w);
    }
  } else {
    for (int i = lane; i < 768; i += 32) {
      const size_t off = base + (i / 48) * row_bytes + (i % 48);
      diff |= frame[off] ^ prev[off];
    }
  }
  const bool dirty = __any_sync(0xffffffffu, diff != 0);
  if (lane == 0) {
    const int q = qp_rows[r];
    qp_mb[static_cast<size_t>(r) * M + m] = clampi(dirty ? q - bias : q, 8,
                                                   48);
  }
}

extern "C" int roi_qp_plane(const uint8_t* frame, const uint8_t* prev,
                            const int* qp_rows, int* qp_mb, int R, int M,
                            int bias, void* stream) {
  const int vec = ((reinterpret_cast<uintptr_t>(frame) |
                    reinterpret_cast<uintptr_t>(prev)) & 15) == 0;
  dim3 grid((M + ROI_MBS_PER_BLOCK - 1) / ROI_MBS_PER_BLOCK, R);
  roi_qp_plane_kernel<<<grid, 32 * ROI_MBS_PER_BLOCK, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      frame, prev, qp_rows, qp_mb, M, bias, vec);
  return static_cast<int>(cudaGetLastError());
}
