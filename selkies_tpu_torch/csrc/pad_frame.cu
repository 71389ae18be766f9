// K11 pad_frame: a captured (h, w, 3) uint8 frame copied into the top-left
// corner of the (H, W, 3) encode grid, every other byte zero.
//
// Replaces selkies_tpu/engine/capture.py:_padder (jitted at :66,
// jnp.pad with zeros), which runs on every frame whose capture size is
// not the grid (1920x1080 into 1920x1088).
//
// Bound on the H100: bytes (the frame read once, the grid written once:
// 6.22 + 6.27 MB at 1080p). A copy of a few MB is a short kernel, so its
// time is how much each thread keeps in flight and how little it does
// beside the copy. Two kernels, one picked by the host a launch,
// each one device operation (no memset):
//
// - flat (w == W, rows of a multiple of 16 bytes, both bases 16-byte
//   aligned: every full-width capture, 1080p and 2160p among them): the
//   grid is the frame's h * 3W bytes followed by zeros, one contiguous
//   run; a thread takes 4 pieces of 16 bytes, its loads in flight before
//   its first store, zero pieces by stores alone, no division;
// - rows (any other shape, e.g. 1366x768 into its 1376-wide grid, or a
//   source view off 16 bytes): a grid over rows and 16-byte pieces of a
//   grid row, a warp 32 consecutive pieces of one row; a piece inside the
//   frame's row is read by one 16-byte load, four 4-byte loads or five
//   4-byte loads and funnel shifts, as the source address allows; a piece
//   that straddles the frame's right edge byte by byte; stores 16 bytes
//   wide where the grid's rows are 16-byte aligned, else by byte.
//
// The grid of each is sized to the blocks the card holds at once (the
// occupancy the build reports); blocks stride over the rest.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PAD_THREADS = 256;
constexpr int PAD_UNROLL = 4;                  // pieces a thread in flight
constexpr int PAD_CHUNK = PAD_THREADS * PAD_UNROLL;
constexpr int ROW_X = 32, ROW_Y = PAD_THREADS / ROW_X;

__global__ void __launch_bounds__(PAD_THREADS)
pad_flat_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                long long n_src, long long n, long long chunks,
                long long per_block) {
  // n_src, n: pieces of the source and of the grid
  const long long c0 = blockIdx.x * per_block;
  const long long c1 = c0 + per_block < chunks ? c0 + per_block : chunks;
  for (long long c = c0; c < c1; c++) {
    const long long q0 = c * PAD_CHUNK + threadIdx.x;
    uint4 v[PAD_UNROLL];
#pragma unroll
    for (int k = 0; k < PAD_UNROLL; k++) {
      const long long q = q0 + k * PAD_THREADS;
      v[k] = q < n_src ? __ldg(src + q) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < PAD_UNROLL; k++) {
      const long long q = q0 + k * PAD_THREADS;
      if (q < n) dst[q] = v[k];
    }
  }
}

__device__ __forceinline__ uint4 load16(const uint8_t* s) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(s);
  if (a % 16 == 0) return __ldg(reinterpret_cast<const uint4*>(s));
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t{3});
  if (a % 4 == 0)
    return make_uint4(__ldg(w), __ldg(w + 1), __ldg(w + 2), __ldg(w + 3));
  // five aligned words around the 16 bytes (the fifth holds byte 15, so
  // it lies inside the source's pages)
  const unsigned sh = 8 * static_cast<unsigned>(a % 4);
  const uint32_t w0 = __ldg(w), w1 = __ldg(w + 1), w2 = __ldg(w + 2),
                 w3 = __ldg(w + 3), w4 = __ldg(w + 4);
  return make_uint4(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
                    __funnelshift_r(w2, w3, sh), __funnelshift_r(w3, w4, sh));
}

__device__ __forceinline__ uint8_t byte_of(const uint4& v, int k) {
  const uint32_t w = k < 4 ? v.x : (k < 8 ? v.y : (k < 12 ? v.z : v.w));
  return static_cast<uint8_t>(w >> (8 * (k & 3)));
}

__global__ void __launch_bounds__(PAD_THREADS)
pad_rows_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                int h, int H, int srow, int drow, int pieces, int vec) {
  // srow, drow: bytes of a frame row and of a grid row; pieces: 16-byte
  // pieces of a grid row (the last one short where drow % 16 != 0)
  const int p = blockIdx.x * ROW_X + threadIdx.x;
  if (p >= pieces) return;
  const int c0 = 16 * p;
  const int len = drow - c0 < 16 ? drow - c0 : 16;
  for (int r = blockIdx.y * ROW_Y + threadIdx.y; r < H;
       r += gridDim.y * ROW_Y) {
    const uint8_t* s = src + static_cast<size_t>(r) * srow + c0;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < h && c0 < srow) {
      if (c0 + 16 <= srow) {
        v = load16(s);
      } else {
        uint32_t b[4] = {0, 0, 0, 0};
        for (int k = 0; k < srow - c0; k++)
          b[k >> 2] |= static_cast<uint32_t>(s[k]) << (8 * (k & 3));
        v = make_uint4(b[0], b[1], b[2], b[3]);
      }
    }
    uint8_t* d = dst + static_cast<size_t>(r) * drow + c0;
    if (vec && len == 16) {
      *reinterpret_cast<uint4*>(d) = v;
    } else {
      for (int k = 0; k < len; k++) d[k] = byte_of(v, k);
    }
  }
}

// blocks of each kernel resident at once, per device
int pad_resident[64][2];

int resident(int dev, int which) {
  int& r = pad_resident[dev][which];
  if (!r) {
    int per_sm = 0, sms = 0;
    if (which)
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pad_rows_kernel,
                                                    PAD_THREADS, 0);
    else
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pad_flat_kernel,
                                                    PAD_THREADS, 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    r = per_sm > 0 && sms > 0 ? per_sm * sms : 1;
  }
  return r;
}

}  // namespace

extern "C" int pad_frame(const uint8_t* src, uint8_t* dst, int h, int w, int H,
                         int W, void* stream) {
  if (h < 0 || w < 0 || h > H || w > W || H <= 0 || W <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long drow = 3LL * W, srow = 3LL * w;
  auto a16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (w == W && drow % 16 == 0 && a16(src) && a16(dst)) {
    const long long n = drow * H / 16, n_src = drow * h / 16;
    const long long chunks = (n + PAD_CHUNK - 1) / PAD_CHUNK;
    const long long res = resident(dev, 0);
    const long long per = (chunks + res - 1) / res;
    const int grid = static_cast<int>((chunks + per - 1) / per);
    pad_flat_kernel<<<grid, PAD_THREADS, 0, st>>>(
        reinterpret_cast<const uint4*>(src), reinterpret_cast<uint4*>(dst),
        n_src, n, chunks, per);
  } else {
    if (drow > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
    const int pieces = static_cast<int>((drow + 15) / 16);
    const int gx = (pieces + ROW_X - 1) / ROW_X;
    const long long res = resident(dev, 1);
    long long gy = (H + ROW_Y - 1) / ROW_Y;
    const long long cap = res / gx > 0 ? res / gx : 1;
    if (gy > cap) gy = cap;
    if (gy > 65535) gy = 65535;
    const int vec = a16(dst) && drow % 16 == 0;
    pad_rows_kernel<<<dim3(gx, static_cast<unsigned>(gy)),
                      dim3(ROW_X, ROW_Y), 0, st>>>(
        src, dst, h, H, static_cast<int>(srow), static_cast<int>(drow),
        pieces, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
