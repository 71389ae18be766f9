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
// 1920x1088; an or per byte). Design: one launch and no memset. A band
// takes P blocks of 256 threads (P as many as give every thread K 16-byte
// vector pairs); a thread issues all its loads of a round (K vectors of
// the frame and K of prev) before its first XOR; a block ORs its threads
// with __syncthreads_or and adds to its band's ticket with one 64-bit
// atomic (blocks done in the low word, damaged blocks in the high word),
// so the band's last block stores the flag with a plain store and puts
// the ticket back to 0, as K1 does: every flag is written by every
// launch. The tickets live in this module's device memory, so launches
// are ordered across streams (launch_order.cuh). Measured on the card
// (damage_probe.py): the launch and the reads from memory set its time,
// as they set that of any design that reads every byte. Bands whose rows
// are not whole 16-byte vectors, or frames off 16 bytes, take a second
// instantiation the host picks, with byte loads.
#include "h264_common.cuh"
#include "launch_order.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                 // 16-byte pairs a thread in flight
constexpr int kMaxBands = 1 << 16;      // bands a launch at most
constexpr long long kMaxBlocks = 1 << 16;   // blocks a band at most

// a ticket a band, 0 between launches: the blocks that finished (low 32
// bits) and those of them that found damage (high 32 bits)
__device__ unsigned long long k6_ticket[kMaxBands];

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
row_damage_probe_kernel(const uint8_t* __restrict__ frame,
                        const uint8_t* __restrict__ prev, long long row_bytes,
                        int P, int* __restrict__ out) {
  const int band = blockIdx.x / P, rank = blockIdx.x - band * P;
  const size_t base = static_cast<size_t>(band) * row_bytes;
  const long long step = static_cast<long long>(P) * kThreads * kVec;
  unsigned diff = 0;
  if (VEC) {
    const uint4* a = reinterpret_cast<const uint4*>(frame + base);
    const uint4* b = reinterpret_cast<const uint4*>(prev + base);
    const long long n = row_bytes / 16;
    for (long long i0 = static_cast<long long>(rank) * kThreads * kVec
                        + threadIdx.x;
         i0 < n; i0 += step) {
      uint4 x[kVec], y[kVec];
#pragma unroll
      for (int k = 0; k < kVec; k++) {
        const long long i = i0 + k * kThreads;
        x[k] = i < n ? a[i] : make_uint4(0, 0, 0, 0);
        y[k] = i < n ? b[i] : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int k = 0; k < kVec; k++)
        diff |= (x[k].x ^ y[k].x) | (x[k].y ^ y[k].y) | (x[k].z ^ y[k].z)
                | (x[k].w ^ y[k].w);
    }
  } else {
    for (long long i0 = static_cast<long long>(rank) * kThreads * kVec
                        + threadIdx.x;
         i0 < row_bytes; i0 += step) {
      uint8_t x[kVec], y[kVec];
#pragma unroll
      for (int k = 0; k < kVec; k++) {
        const long long i = i0 + k * kThreads;
        x[k] = i < row_bytes ? frame[base + i] : 0;
        y[k] = i < row_bytes ? prev[base + i] : 0;
      }
#pragma unroll
      for (int k = 0; k < kVec; k++) diff |= x[k] ^ y[k];
    }
  }
  ticket_flag(&k6_ticket[band], &out[band], P, diff != 0);
}

LaunchOrder order;                     // K6's launches across streams

}  // namespace

extern "C" int row_damage_probe(const uint8_t* frame, const uint8_t* prev,
                                int* out, int R, int row_bytes, void* stream) {
  if (R <= 0 || R > kMaxBands || row_bytes <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = ((reinterpret_cast<uintptr_t>(frame) |
                     reinterpret_cast<uintptr_t>(prev)) & 15) == 0 &&
                   row_bytes % 16 == 0;
  // blocks a band: K vectors (bytes on the byte path) a thread
  const long long units = vec ? row_bytes / 16 : row_bytes;
  long long P = (units + kThreads * kVec - 1) / (kThreads * kVec);
  P = P > kMaxBlocks ? kMaxBlocks : P;
  if (P * R > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  std::lock_guard<std::mutex> hold(order.lock);
  int dev = 0;
  const cudaError_t oe = order_before(order, st, &dev);
  if (oe != cudaSuccess) return static_cast<int>(oe);
  const dim3 grid(static_cast<unsigned>(P * R));
  if (vec)
    row_damage_probe_kernel<true><<<grid, kThreads, 0, st>>>(
        frame, prev, row_bytes, static_cast<int>(P), out);
  else
    row_damage_probe_kernel<false><<<grid, kThreads, 0, st>>>(
        frame, prev, row_bytes, static_cast<int>(P), out);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) order_after(order, st, dev);
  return static_cast<int>(e);
}
