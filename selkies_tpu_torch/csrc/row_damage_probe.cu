// K6 row_damage_probe: one flag per band of rows, 1 where any byte of
// the frame differs from the damage reference in that band.
//
// Replaces selkies_tpu/engine/h264_encoder.py:_jitted_row_damage_probe
// (jnp.any((frame != prev).reshape(R, -1), axis=1)), the one
// pre-dispatch read of the damage-proportional P path (a band per MB
// row), and the damage compare of selkies_tpu/engine/encoder.py:
// build_step_fn (jnp.any(stripes != prev_s, axis=(1, 2, 3)), a band per
// stripe).
//
// Bound on the H100: bytes (frame and prev read once, 2 x 6.27 MB at
// 1920x1088; an or per byte). Design: a 2-D grid, a few blocks per MB row
// (one row is 48 * W contiguous bytes); every thread XORs 16-byte vectors
// of the two frames, the block ORs its threads with __syncthreads_or and
// one thread sets the row's flag with atomicOr (the flags are zeroed on
// the same stream first). Pointers that are not 16-byte aligned take a
// byte loop.
#include "h264_common.cuh"

__global__ void row_damage_probe_kernel(const uint8_t* __restrict__ frame,
                                        const uint8_t* __restrict__ prev,
                                        int row_bytes, int vec,
                                        int* __restrict__ out) {
  const int r = blockIdx.y;
  const size_t base = static_cast<size_t>(r) * row_bytes;
  const int stride = gridDim.x * blockDim.x;
  unsigned diff = 0;
  if (vec) {
    const uint4* a = reinterpret_cast<const uint4*>(frame + base);
    const uint4* b = reinterpret_cast<const uint4*>(prev + base);
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < row_bytes / 16;
         i += stride) {
      const uint4 x = a[i], y = b[i];
      diff |= (x.x ^ y.x) | (x.y ^ y.y) | (x.z ^ y.z) | (x.w ^ y.w);
    }
  } else {
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < row_bytes;
         i += stride)
      diff |= frame[base + i] ^ prev[base + i];
  }
  if (__syncthreads_or(diff != 0) && threadIdx.x == 0) atomicOr(&out[r], 1);
}

extern "C" int row_damage_probe(const uint8_t* frame, const uint8_t* prev,
                                int* out, int R, int row_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(out, 0, sizeof(int) * R, s);
  const int vec = ((reinterpret_cast<uintptr_t>(frame) |
                    reinterpret_cast<uintptr_t>(prev)) & 15) == 0 &&
                  row_bytes % 16 == 0;
  const int threads = 256;
  const int per_row = vec ? row_bytes / 16 : row_bytes;
  // about four vectors a thread
  int chunks = (per_row + 4 * threads - 1) / (4 * threads);
  chunks = chunks < 1 ? 1 : chunks;
  dim3 grid(chunks, R);
  row_damage_probe_kernel<<<grid, threads, 0, s>>>(frame, prev, row_bytes, vec,
                                                   out);
  return static_cast<int>(cudaGetLastError());
}
