// The ragged byte buffer of K9 jpeg_pack: JPEG stripes of MSB-first u32
// words -> their bytes back to back in one fixed-capacity buffer, the
// per-stripe byte lengths and the out_cap overflow flag (flags[1]).
//
// Replaces selkies_tpu/ops/stripes.py:words_to_bytes_device (pad_ones=True:
// the last partial byte of a stripe padded with ones) and
// concat_stripe_bytes. One thread per output byte: each block rescans
// the R stripe byte lengths, finds its stripe by binary search
// (searchsorted, right side), clips the offset into the stripe's
// 4 * w_cap bytes as the reference does, and splits the word big-endian;
// bytes past the total are zero. A stripe longer than its words has no
// last byte there to pad. (H.264's zero-padded byte stage is
// stream_bytes_kernel in pack_stream.cu.)
//
// Seats (selkies_tpu/parallel/: the step vmapped over a leading seat
// axis): the stripes of S seats lie back to back, R per seat, and each
// seat has its own (out_cap,) buffer, byte lengths and flags pair;
// blockIdx.y is the seat. One seat is the S = 1 case.
#pragma once
#include "h264_common.cuh"

__global__ void concat_bytes_kernel(const unsigned* __restrict__ words,
                                    const int* __restrict__ total_bits, int R,
                                    int w_cap, int out_cap,
                                    uint8_t* __restrict__ data,
                                    int* __restrict__ byte_lens,
                                    int* __restrict__ flags) {
  extern __shared__ long long starts[];   // R + 1 (last: the total)
  const int seat = blockIdx.y;
  words += static_cast<long long>(seat) * R * w_cap;
  total_bits += static_cast<long long>(seat) * R;
  data += static_cast<long long>(seat) * out_cap;
  byte_lens += static_cast<long long>(seat) * R;
  flags += 2 * seat;
  if (threadIdx.x == 0) {
    long long acc = 0;
    for (int k = 0; k < R; k++) {
      starts[k] = acc;
      acc += (static_cast<long long>(total_bits[k]) + 7) >> 3;
    }
    starts[R] = acc;
  }
  __syncthreads();
  if (blockIdx.x == 0) {
    for (int k = threadIdx.x; k < R; k += blockDim.x)
      byte_lens[k] = (total_bits[k] + 7) >> 3;
    if (threadIdx.x == 0 && starts[R] > out_cap) atomicOr(&flags[1], 1);
  }
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (j >= out_cap) return;
  uint8_t out = 0;
  if (j < starts[R]) {
    int lo = 0, hi = R;                     // first k with starts[k] > j
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (starts[mid] <= j) lo = mid + 1; else hi = mid;
    }
    const int sb = clampi(lo - 1, 0, R - 1);
    const long long B = 4LL * w_cap;
    long long local = j - starts[sb];
    local = local < 0 ? 0 : (local > B - 1 ? B - 1 : local);
    const unsigned w = words[static_cast<long long>(sb) * w_cap + (local >> 2)];
    out = static_cast<uint8_t>((w >> (24 - 8 * (local & 3))) & 0xFFu);
    const int tb = total_bits[sb], rem = tb & 7;
    if (rem && local == ((static_cast<long long>(tb) + 7) >> 3) - 1)
      out |= static_cast<uint8_t>((1 << (8 - rem)) - 1);
  }
  data[j] = out;
}

// launch on stream s after the words are complete; R stripes per seat
inline void launch_concat_bytes(const unsigned* words, const int* total_bits,
                                int S, int R, int w_cap, int out_cap,
                                uint8_t* data, int* byte_lens, int* flags,
                                cudaStream_t s) {
  const int threads = 256;
  const dim3 grid((out_cap + threads - 1) / threads, S);
  concat_bytes_kernel<<<grid, threads, (R + 1) * sizeof(long long), s>>>(
      words, total_bits, R, w_cap, out_cap, data, byte_lens, flags);
}
