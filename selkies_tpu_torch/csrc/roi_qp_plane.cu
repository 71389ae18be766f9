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
// 2 x 6.27 MB for a whole 1920x1088 frame; an or per byte). Design: a
// block of 384 threads a segment of S MBs of an MB row (S = 32, 16 or 8:
// the largest that still gives every SM a block, so a whole frame runs
// 32 MBs a block, 272 blocks at 1080p, and a band of a few rows spreads
// over the card): the segment's 16 pixel rows are runs of 48 * S
// contiguous bytes, a thread one 16-byte column of 16 * S / 128 of those
// rows, so a warp's loads cover whole 32-byte sectors of one or two
// pixel rows. A thread issues all its loads of the frame and prev before
// its first XOR; a thread that finds a difference marks its MB in shared
// memory, and after one barrier a thread an MB writes its QP. It runs
// before K1 on the same stream, so prev is still the previous frame.
// Pointers that are not 16-byte aligned take a second instantiation with
// byte loads (a row of MBs is 48 * M bytes, always a multiple of 16).
#include "h264_common.cuh"

namespace {

constexpr int kThreads = 384;

template <int S, bool VEC>
__global__ void __launch_bounds__(kThreads)
roi_qp_plane_kernel(const uint8_t* __restrict__ frame,
                    const uint8_t* __restrict__ prev,
                    const int* __restrict__ qp_rows, int* __restrict__ qp_mb,
                    int M, int bias) {
  constexpr int C = 3 * S;               // 16-byte columns of a segment row
  constexpr int G = kThreads / C;        // row groups
  constexpr int K = 16 / G;              // pixel rows (pairs) a thread
  static_assert(kThreads % C == 0 && 16 % G == 0, "segment shape");
  __shared__ int dirty[S];
  const int r = blockIdx.y, m0 = blockIdx.x * S;
  const int mbs = min(S, M - m0);
  const int t = threadIdx.x, c = t % C, g = t / C;
  const int q = t < mbs ? __ldg(qp_rows + r) : 0;
  const size_t row_bytes = static_cast<size_t>(M) * 48;
  const size_t base = (static_cast<size_t>(r) * 16 + g) * row_bytes
                      + static_cast<size_t>(m0) * 48 + 16 * c;
  unsigned diff = 0;
  if (c < 3 * mbs) {
    if (VEC) {
      uint4 x[K], y[K];
#pragma unroll
      for (int k = 0; k < K; k++) {
        const size_t off = base + static_cast<size_t>(k) * G * row_bytes;
        x[k] = __ldg(reinterpret_cast<const uint4*>(frame + off));
        y[k] = __ldg(reinterpret_cast<const uint4*>(prev + off));
      }
#pragma unroll
      for (int k = 0; k < K; k++)
        diff |= (x[k].x ^ y[k].x) | (x[k].y ^ y[k].y) | (x[k].z ^ y[k].z) |
                (x[k].w ^ y[k].w);
    } else {
      for (int k = 0; k < K; k++) {
        const size_t off = base + static_cast<size_t>(k) * G * row_bytes;
        for (int b = 0; b < 16; b++) diff |= frame[off + b] ^ prev[off + b];
      }
    }
  }
  if (t < S) dirty[t] = 0;
  __syncthreads();
  if (diff) dirty[c / 3] = 1;
  __syncthreads();
  if (t < mbs)
    qp_mb[static_cast<size_t>(r) * M + m0 + t] =
        clampi(dirty[t] ? q - bias : q, 8, 48);
}

template <int S>
void launch(const uint8_t* frame, const uint8_t* prev, const int* qp_rows,
            int* qp_mb, int R, int M, int bias, bool vec, cudaStream_t st) {
  const dim3 grid((M + S - 1) / S, R);
  if (vec)
    roi_qp_plane_kernel<S, true><<<grid, kThreads, 0, st>>>(
        frame, prev, qp_rows, qp_mb, M, bias);
  else
    roi_qp_plane_kernel<S, false><<<grid, kThreads, 0, st>>>(
        frame, prev, qp_rows, qp_mb, M, bias);
}

// SMs of each device
int sm_count[64];

}  // namespace

extern "C" int roi_qp_plane(const uint8_t* frame, const uint8_t* prev,
                            const int* qp_rows, int* qp_mb, int R, int M,
                            int bias, void* stream) {
  if (R <= 0 || M <= 0 || R > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!sm_count[dev])
    cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount,
                           dev);
  const long long sms = sm_count[dev] > 0 ? sm_count[dev] : 1;
  const bool vec = ((reinterpret_cast<uintptr_t>(frame) |
                     reinterpret_cast<uintptr_t>(prev)) & 15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto blocks = [&](int S) { return 1LL * R * ((M + S - 1) / S); };
  if (blocks(32) >= sms)
    launch<32>(frame, prev, qp_rows, qp_mb, R, M, bias, vec, st);
  else if (blocks(16) >= sms)
    launch<16>(frame, prev, qp_rows, qp_mb, R, M, bias, vec, st);
  else
    launch<8>(frame, prev, qp_rows, qp_mb, R, M, bias, vec, st);
  return static_cast<int>(cudaGetLastError());
}
