// K9 jpeg_pack: every stripe's (payload, nbits) slots -> u32 words, bit
// totals, event counts, the 1-padded stripe bytes concatenated into one
// buffer, and the two overflow flags.
//
// Replaces selkies_tpu/ops/bitpack.py:pack_slot_events_scatter (vmapped
// over stripes by selkies_tpu/engine/encoder.py:build_step_fn),
// selkies_tpu/ops/stripes.py:words_to_bytes_device (pad_ones=True) and
// concat_stripe_bytes.
//
// Bound on the H100: bytes (15.7 MB of slot events read at 1080p; the
// words and the byte buffer written once). Design: four grids on one
// stream. (1) A warp per scan block sums its 64 slot bits and counts its
// events. (2) One block per stripe scans those sums into each scan
// block's first bit (1024 at a time, a warp-shuffle scan per warp and one
// across the warps), writes the stripe's total bits and event count and
// raises flag 0 when n_events > e_cap or total_bits > 32 * w_cap. (3) A
// warp per scan block places its slots: a warp prefix sum of the
// two-slot sums gives each slot's offset, and each codeword is added
// (atomicAdd; the bit ranges are disjoint, so the sum is an OR, as the
// reference's scatter-add) into the <= 2 words it overlaps; words past
// w_cap are dropped, not wrapped. (4) The byte buffer of
// stripe_bytes.cuh, each stripe's last byte padded with ones.
//
// Seats: jpeg_pack_seats replaces the same functions vmapped over the seat
// axis by selkies_tpu/parallel/seats.py:MultiSeatEncoder._build_step
// (:93). The stripes of S seats lie back to back, so grids (1)-(3) run
// over all S * n stripes unchanged (a stripe's words never pass its own
// w_cap); each seat has its own flags pair and (out_cap,) byte buffer,
// and grid (4) takes the seat from blockIdx.y. jpeg_pack is the S = 1
// case.
#include "h264_common.cuh"
#include "stripe_bytes.cuh"

__global__ void jpeg_block_bits_kernel(const uint8_t* __restrict__ nbits,
                                       long long total, int* __restrict__ bits,
                                       int* __restrict__ events) {
  const int lane = threadIdx.x & 31;
  const long long gb = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5)
                       + (threadIdx.x >> 5);
  if (gb >= total) return;
  const uchar2 nb = reinterpret_cast<const uchar2*>(nbits + gb * 64)[lane];
  int b = nb.x + nb.y, e = (nb.x > 0) + (nb.y > 0);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    b += __shfl_down_sync(0xffffffffu, b, o);
    e += __shfl_down_sync(0xffffffffu, e, o);
  }
  if (lane == 0) {
    bits[gb] = b;
    events[gb] = e;
  }
}

// exclusive scan of one stripe's M block sums (1024 threads)
__global__ void jpeg_stripe_scan_kernel(const int* __restrict__ bits,
                                        const int* __restrict__ events, int M,
                                        int per_seat, int e_cap, int w_cap,
                                        int* __restrict__ start,
                                        int* __restrict__ total_bits,
                                        int* __restrict__ n_events,
                                        int* __restrict__ flags) {
  __shared__ int warp_sum[32];
  __shared__ int carry;
  const int s = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const size_t base = static_cast<size_t>(s) * M;
  if (t == 0) carry = 0;
  int ev = 0;
  for (int k = t; k < M; k += blockDim.x) ev += events[base + k];
  for (int c0 = 0; c0 < M; c0 += blockDim.x) {
    __syncthreads();
    const int k = c0 + t;
    const int v = k < M ? bits[base + k] : 0;
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = lane < (blockDim.x >> 5) ? warp_sum[lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += u;
      }
      warp_sum[lane] = w;                    // inclusive over warps
    }
    __syncthreads();
    const int before = carry + (warp ? warp_sum[warp - 1] : 0);
    if (k < M) start[base + k] = before + incl - v;
    __syncthreads();
    if (t == blockDim.x - 1) carry = before + incl;
  }
  // every thread's events to one count
  for (int o = 16; o > 0; o >>= 1) ev += __shfl_down_sync(0xffffffffu, ev, o);
  __syncthreads();
  if (lane == 0) warp_sum[warp] = ev;
  __syncthreads();
  if (t == 0) {
    int n = 0;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); w++)
      n += warp_sum[w];
    total_bits[s] = carry;
    n_events[s] = n;
    if (n > e_cap || static_cast<long long>(carry) > 32LL * w_cap)
      atomicOr(&flags[2 * (s / per_seat)], 1);
  }
}

__global__ void jpeg_place_kernel(const int* __restrict__ payload,
                                  const uint8_t* __restrict__ nbits,
                                  const int* __restrict__ start, int M,
                                  long long total, int w_cap,
                                  unsigned* __restrict__ words) {
  const int lane = threadIdx.x & 31;
  const long long gb = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5)
                       + (threadIdx.x >> 5);
  if (gb >= total) return;
  const int s = static_cast<int>(gb / M);
  const uchar2 nb = reinterpret_cast<const uchar2*>(nbits + gb * 64)[lane];
  const int2 pay = reinterpret_cast<const int2*>(payload + gb * 64)[lane];
  const int two = nb.x + nb.y;
  int incl = two;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  unsigned* w = words + static_cast<size_t>(s) * w_cap;
  long long off = static_cast<long long>(start[gb]) + incl - two;
  const int n[2] = {nb.x, nb.y};
  const unsigned p[2] = {static_cast<unsigned>(pay.x),
                         static_cast<unsigned>(pay.y)};
#pragma unroll
  for (int k = 0; k < 2; k++) {
    if (n[k] > 0) {
      const long long w0 = off >> 5;
      const int sh = 32 - (static_cast<int>(off & 31) + n[k]);
      const unsigned hi = sh >= 0 ? (p[k] << sh) : (p[k] >> (-sh));
      if (w0 < w_cap) atomicAdd(&w[w0], hi);
      if (sh < 0 && w0 + 1 < w_cap) atomicAdd(&w[w0 + 1], p[k] << (32 + sh));
    }
    off += n[k];
  }
}

// n_seats seats of S / n_seats stripes each: words (S, w_cap), total_bits,
// n_events and byte_lens (S,), data (n_seats, out_cap), flags (n_seats, 2)
extern "C" int jpeg_pack_seats(const int* payload, const uint8_t* nbits,
                               int n_seats, int S, int M, int e_cap,
                               int w_cap, int out_cap, int* scratch,
                               int* words, int* total_bits, int* n_events,
                               uint8_t* data, int* byte_lens, int* flags,
                               void* stream) {
  if (n_seats <= 0 || n_seats > 65535 || S % n_seats)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per_seat = S / n_seats;
  const long long total = static_cast<long long>(S) * M;
  int* bits = scratch;
  int* events = scratch + total;
  int* start = scratch + 2 * total;
  cudaMemsetAsync(words, 0, sizeof(int) * static_cast<size_t>(S) * w_cap, st);
  cudaMemsetAsync(flags, 0, 2 * sizeof(int) * static_cast<size_t>(n_seats),
                  st);
  const int threads = 256, warps = threads / 32;
  const int grid = static_cast<int>((total + warps - 1) / warps);
  jpeg_block_bits_kernel<<<grid, threads, 0, st>>>(nbits, total, bits,
                                                   events);
  jpeg_stripe_scan_kernel<<<S, 1024, 0, st>>>(bits, events, M, per_seat,
                                              e_cap, w_cap, start, total_bits,
                                              n_events, flags);
  jpeg_place_kernel<<<grid, threads, 0, st>>>(
      payload, nbits, start, M, total, w_cap,
      reinterpret_cast<unsigned*>(words));
  launch_concat_bytes(reinterpret_cast<const unsigned*>(words), total_bits,
                      n_seats, per_seat, w_cap, out_cap, data, byte_lens,
                      flags, st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int jpeg_pack(const int* payload, const uint8_t* nbits, int S,
                         int M, int e_cap, int w_cap, int out_cap,
                         int* scratch, int* words, int* total_bits,
                         int* n_events, uint8_t* data, int* byte_lens,
                         int* flags, void* stream) {
  return jpeg_pack_seats(payload, nbits, 1, S, M, e_cap, w_cap, out_cap,
                         scratch, words, total_bits, n_events, data,
                         byte_lens, flags, stream);
}
