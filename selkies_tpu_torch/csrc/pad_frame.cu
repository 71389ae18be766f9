// K11 pad_frame: a captured (h, w, 3) uint8 frame copied into the top-left
// corner of the (H, W, 3) encode grid, every other byte zero.
//
// Replaces selkies_tpu/engine/capture.py:_padder (jitted at :66,
// jnp.pad with zeros), which runs on every frame whose capture size is
// not the grid (1920x1080 into 1920x1088).
//
// Bound on the H100: bytes (the frame read once, the grid written once:
// 6.22 + 6.27 MB at 1080p). Design: one thread per 4 bytes of the grid,
// which lie in one grid row when 3 * W is a multiple of 4 (it is for
// any grid width a multiple of 16); each byte is the source byte at the
// same row and column or zero; a 32-bit store where the buffer is 4-byte
// aligned. Neighbouring threads read neighbouring source bytes.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void pad_frame_kernel(const uint8_t* __restrict__ src,
                                 uint8_t* __restrict__ dst, int h, int w,
                                 int H, int W, int vec) {
  const long long n = 3LL * H * W;
  const long long i0 =
      4LL * (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (i0 >= n) return;
  const int src_row = 3 * w, dst_row = 3 * W;
  int r = static_cast<int>(i0 / dst_row);
  int col = static_cast<int>(i0 - 1LL * r * dst_row);
  uint8_t v[4];
#pragma unroll
  for (int k = 0; k < 4; k++) {
    v[k] = (r < h && col < src_row && i0 + k < n)
               ? src[1LL * r * src_row + col]
               : 0;
    if (++col == dst_row) {
      col = 0;
      ++r;
    }
  }
  if (vec && i0 + 4 <= n) {
    *reinterpret_cast<uint32_t*>(dst + i0) =
        v[0] | (v[1] << 8) | (v[2] << 16) | (static_cast<uint32_t>(v[3]) << 24);
  } else {
    for (int k = 0; k < 4 && i0 + k < n; k++) dst[i0 + k] = v[k];
  }
}

extern "C" int pad_frame(const uint8_t* src, uint8_t* dst, int h, int w, int H,
                         int W, void* stream) {
  if (h < 0 || w < 0 || h > H || w > W || H <= 0 || W <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long groups = (3LL * H * W + 3) / 4;
  const int threads = 256;
  const int blocks = static_cast<int>((groups + threads - 1) / threads);
  const int vec = (reinterpret_cast<uintptr_t>(dst) & 3) == 0;
  pad_frame_kernel<<<blocks, threads, 0, s>>>(src, dst, h, w, H, W, vec);
  return static_cast<int>(cudaGetLastError());
}
