// K20 halo_bands: an (H, W) uint8 plane -> (n, band + 2 * halo, W) bands,
// band s holding plane rows s * band - halo .. (s + 1) * band + halo - 1,
// each row index clamped to [0, H - 1] (the frame-edge copies). The split
// frame's halo path hands the bands to K19 (csrc/motion_select.cu).
//
// Replaces selkies_tpu/parallel/stripes.py:_halo_bands (a jnp.take over
// clamped row indices, the halo-row "exchange" made ahead of the per-shard
// program; it gathers int32, this kernel keeps uint8, the same values).
//
// Bound on the H100: bytes (each output byte written once, each input row
// read once or, in the halos, twice: ~2.5 MB for a 1080p luma plane in 4
// bands with a 24-row halo). Design: one block per output row, each thread
// copying vectors of V bytes, V the largest of 16, 8, 4 and 1 that divides
// the width (so every row start of both buffers is V-aligned; the wrapper's
// buffers are fresh allocations): a 4:2:0 chroma plane of a width that is a
// multiple of 8 but not of 16 copies in 8-byte vectors.
#include <cstdint>
#include <cuda_runtime.h>

template <typename V>
__global__ void halo_bands_kernel(const uint8_t* __restrict__ plane,
                                  uint8_t* __restrict__ out, int H, int W,
                                  int band, int halo) {
  const int rows = band + 2 * halo;
  const int s = blockIdx.x / rows, t = blockIdx.x % rows;
  int src = s * band + t - halo;
  src = src < 0 ? 0 : (src > H - 1 ? H - 1 : src);
  const V* in = reinterpret_cast<const V*>(plane + static_cast<size_t>(src) * W);
  V* dst = reinterpret_cast<V*>(out + static_cast<size_t>(blockIdx.x) * W);
  const int nv = W / static_cast<int>(sizeof(V));
  for (int i = threadIdx.x; i < nv; i += blockDim.x) dst[i] = in[i];
}

template <typename V>
static void launch_bands(const uint8_t* plane, int H, int W, int n, int band,
                         int halo, uint8_t* out, cudaStream_t stream) {
  halo_bands_kernel<V><<<n * (band + 2 * halo), 128, 0, stream>>>(
      plane, out, H, W, band, halo);
}

extern "C" int halo_bands(const uint8_t* plane, int H, int W, int n, int band,
                          int halo, uint8_t* out, void* stream) {
  if (n < 1 || band < 1 || halo < 0 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(plane) |
                          reinterpret_cast<uintptr_t>(out);
  if (W % 16 == 0 && align % 16 == 0)
    launch_bands<uint4>(plane, H, W, n, band, halo, out, st);
  else if (W % 8 == 0 && align % 8 == 0)
    launch_bands<uint2>(plane, H, W, n, band, halo, out, st);
  else if (W % 4 == 0 && align % 4 == 0)
    launch_bands<unsigned int>(plane, H, W, n, band, halo, out, st);
  else
    launch_bands<uint8_t>(plane, H, W, n, band, halo, out, st);
  return static_cast<int>(cudaGetLastError());
}
