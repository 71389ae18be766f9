// The stream stage that K4 pack_stream (csrc/pack_stream.cu) and K9
// jpeg_pack (csrc/jpeg_pack.cu) share: the TMA bulk-copy helpers of
// their row kernels (a cluster of P blocks a row or stripe, each block's
// slots brought into shared memory by cp.async.bulk; the cluster and
// mbarrier helpers are in cluster.cuh), the codeword sink their blocks
// place into words with (BitSink), the 16-byte word stores, and the byte
// stage.
//
// The byte stage, stream_bytes_kernel<PAD>, replaces selkies_tpu/ops/
// stripes.py:words_to_bytes_device (PAD false for H.264's zero-padded
// rows, true for JPEG's pad_ones=True) and concat_stripe_bytes: the
// byte buffer of each seat (blockIdx.y), the rows' bytes back to back and
// zeros to out_cap, 16 bytes a thread. Each block scans the seat's R row
// byte lengths with one warp; a thread finds its row by binary search
// and, where its 16 bytes lie inside one row's words, funnel-shifts five
// big-endian words into one 16-byte store; across a row's end or past
// its words (the offset clipped into the row's 4 * w_cap bytes, as the
// reference does) it gathers byte by byte. With PAD a row's last byte
// gets (1 << (8 - rem)) - 1 ORed in, rem = total_bits & 7, where that
// byte lies inside the row's 4 * w_cap bytes (a row longer than its
// words has no last byte there to pad). The first block of each seat
// writes the seat's byte lengths, in place of the event counts the row
// kernel left in byte_lens, and both flags: [0] a row with more events
// than e_cap or more bits than 32 * w_cap, [1] the rows' bytes past
// out_cap. Bound by bytes: the words read once (from L2, written just
// before), the buffer written once; launched behind the row kernel
// (programmatic dependent launch), it waits for it inside.
#pragma once
#include "cluster.cuh"
#include "h264_common.cuh"

namespace {

constexpr int kWords = 2048;        // a block's words in shared memory

__device__ __forceinline__ int misalign(const void* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
}

// the 16-byte-aligned span covering [src, src + bytes)
__device__ __forceinline__ uintptr_t span_lo(const void* src) {
  return reinterpret_cast<uintptr_t>(src) & ~static_cast<uintptr_t>(15);
}

__device__ __forceinline__ unsigned span_len(const void* src,
                                             unsigned bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  return static_cast<unsigned>(
      ((a + bytes + 15) & ~static_cast<uintptr_t>(15)) - span_lo(src));
}

// one thread: copies of spans (src[i], bytes[i]) to dst[i] (16-byte
// aligned), completing on ``bar``
template <int N>
__device__ __forceinline__ void bulk_copies(char* const (&dst)[N],
                                            const void* const (&src)[N],
                                            const unsigned (&bytes)[N],
                                            unsigned long long* bar) {
  unsigned tx = 0;
#pragma unroll
  for (int i = 0; i < N; i++) tx += span_len(src[i], bytes[i]);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(tx) : "memory");
#pragma unroll
  for (int i = 0; i < N; i++)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        :: "r"(smem_u32(dst[i])), "l"(span_lo(src[i])),
           "r"(span_len(src[i], bytes[i])), "r"(smem_u32(bar))
        : "memory");
}

// Codewords into words by addition (the bit ranges are disjoint, so the
// sum is an OR, as the reference's scatter-add), MSB first; ``Words``
// decides where word w of the row goes (its add(w, v)).
template <class Words>
struct BitSink {
  Words words;

  __device__ __forceinline__ void add(int w, unsigned v) const {
    words.add(w, v);
  }

  // event (pay, nb > 0) at bit ``off`` of the row, MSB first
  __device__ __forceinline__ void put(int off, unsigned pay, int nb) const {
    const int w0 = off >> 5;
    const int sh = 32 - ((off & 31) + nb);
    add(w0, sh >= 0 ? pay << sh : pay >> (-sh));
    if (sh < 0) add(w0 + 1, pay << (32 + sh));
  }

  // n (1..64) bits, right-aligned in v, at bit ``off`` of the row
  __device__ __forceinline__ void put_run(int off, unsigned long long v,
                                          int n) const {
    const int w0 = off >> 5, sh = 96 - (off & 31) - n;   // 1..95
    if (sh >= 64) {
      add(w0, static_cast<unsigned>(v << (sh - 64)));
    } else {
      const unsigned long long lo = v << sh;
      add(w0, static_cast<unsigned>(v >> (64 - sh)));
      add(w0 + 1, static_cast<unsigned>(lo >> 32));
      add(w0 + 2, static_cast<unsigned>(lo));
    }
  }

  // a lane's events in bit order, summed into whole words
  // (word ``cw``, sum ``cv``) before they are added: one atomic a word
  // a lane, not one an event
  __device__ __forceinline__ void merge(int& cw, unsigned& cv, int off,
                                        unsigned pay, int nb) const {
    const int w0 = off >> 5;
    const int sh = 32 - ((off & 31) + nb);
    if (w0 != cw) {
      add(cw, cv);
      cw = w0;
      cv = 0u;
    }
    cv += sh >= 0 ? pay << sh : pay >> (-sh);
    if (sh < 0) {
      add(cw, cv);
      cw = w0 + 1;
      cv = pay << (32 + sh);
    }
  }
};

// red.shared.add of v into the word at shared address a
__device__ __forceinline__ void red_shared(unsigned a, unsigned v) {
  asm volatile("red.shared.add.u32 [%0], %1;" :: "r"(a), "r"(v) : "memory");
}

// K4's rows. Rows pass: below w_cap, into the block's shared buffer
// (words ws .. ws + kWords) or past it a global atomic; spill pass (its
// grid 2): only words past w_cap, up to the seat's end.
template <bool SPILL>
struct RowWords {
  unsigned sw;          // shared address of the block's words
  unsigned* gw;         // the row's first global word
  int ws, w_cap;
  long long room;       // words from the row's first to the seat's end

  __device__ __forceinline__ void add(int w, unsigned v) const {
    if (!v) return;
    if constexpr (SPILL) {
      if (w >= w_cap && w < room) atomicAdd(&gw[w], v);
    } else if (w < w_cap) {
      const int i = w - ws;
      if (i < kWords)
        red_shared(sw + 4u * static_cast<unsigned>(i), v);
      else
        atomicAdd(&gw[w], v);
    }
  }
};

template <bool SPILL>
using Sink = BitSink<RowWords<SPILL>>;

__device__ __forceinline__ int warp_incl_sum(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  return __reduce_add_sync(0xffffffffu, v);   // one redux.sync
}

// words [i0, i1) of a row, each val(i), with 16-byte stores where the
// address allows
template <class Val>
__device__ __forceinline__ void store_words(unsigned* g, int i0, int i1,
                                            Val val) {
  if (i1 <= i0) return;
  const int n = i1 - i0;
  const int head = min(n, static_cast<int>(
      ((16 - (reinterpret_cast<uintptr_t>(g + i0) & 15)) & 15) >> 2));
  for (int i = threadIdx.x; i < head; i += blockDim.x) g[i0 + i] = val(i0 + i);
  const int b0 = i0 + head, nq = (n - head) >> 2;
  uint4* gq = reinterpret_cast<uint4*>(g + b0);
  for (int q = threadIdx.x; q < nq; q += blockDim.x) {
    const int i = b0 + 4 * q;
    gq[q] = make_uint4(val(i), val(i + 1), val(i + 2), val(i + 3));
  }
  for (int i = b0 + 4 * nq + threadIdx.x; i < i1; i += blockDim.x)
    g[i] = val(i);
}

// the byte buffer of each seat (blockIdx.y), 16 bytes a thread; PAD: a
// row's last partial byte padded with ones (JPEG)
template <bool PAD>
__global__ void __launch_bounds__(256)
stream_bytes_kernel(const unsigned* __restrict__ words,
                    const int* __restrict__ total_bits,
                    int* __restrict__ byte_lens, int* __restrict__ flags,
                    int R, int e_cap, int w_cap, int out_cap,
                    uint8_t* __restrict__ data) {
  extern __shared__ long long starts[];   // R + 1 (last: the total)
  // PAD: then the rows' bit totals, R ints
  int* tbits = reinterpret_cast<int*>(starts + R + 1);
  // launched behind the row kernel: wait for the words to be complete
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int seat = blockIdx.y;
  words += static_cast<long long>(seat) * R * w_cap;
  total_bits += static_cast<long long>(seat) * R;
  byte_lens += static_cast<long long>(seat) * R;
  data += static_cast<long long>(seat) * out_cap;
  for (int k = threadIdx.x; k < R; k += blockDim.x) {
    starts[k] = total_bits[k];
    if constexpr (PAD) tbits[k] = static_cast<int>(starts[k]);
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    // the rows' byte starts; the first block also the seat's byte
    // lengths (in place of the event counts the row kernel left) and
    // flags
    const int lane = threadIdx.x;
    long long carry = 0;
    int bad = 0;
    for (int k0 = 0; k0 < R; k0 += 32) {
      const int k = k0 + lane;
      const int tb = k < R ? static_cast<int>(starts[k]) : 0;
      const int v = (tb + 7) >> 3;
      const int incl = warp_incl_sum(v, lane);
      if (k < R) {
        starts[k] = carry + incl - v;
        if (blockIdx.x == 0) {
          bad |= byte_lens[k] > e_cap || tb > w_cap * 32;
          byte_lens[k] = v;
        }
      }
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    bad = __any_sync(0xffffffffu, bad);
    if (lane == 0) {
      starts[R] = carry;
      if (blockIdx.x == 0) {
        flags[2 * seat] = bad;
        flags[2 * seat + 1] = carry > out_cap;
      }
    }
  }
  __syncthreads();
  const long long j0 = (static_cast<long long>(blockIdx.x) * blockDim.x
                        + threadIdx.x) * 16;
  if (j0 >= out_cap) return;
  const long long total = starts[R];
  const long long B = 4LL * w_cap;
  auto row_of = [&](long long j) {         // last k with starts[k] <= j
    int lo = 0, hi = R;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (starts[mid] <= j) lo = mid + 1; else hi = mid;
    }
    return clampi(lo - 1, 0, R - 1);
  };
  unsigned out[4] = {0u, 0u, 0u, 0u};      // little-endian byte order
  if (j0 < total) {
    const int k = row_of(j0);
    const long long local0 = j0 - starts[k];
    const unsigned* w = words + static_cast<long long>(k) * w_cap;
    if (j0 + 16 <= starts[k + 1] && local0 >= 0 && local0 + 16 <= B) {
      // one row, inside its words: five big-endian words, shifted
      const long long q = local0 >> 2;
      const int sh = static_cast<int>(local0 & 3) * 8;
      unsigned v[5];
#pragma unroll
      for (int i = 0; i < 4; i++) v[i] = w[q + i];
      v[4] = sh && q + 4 < w_cap ? w[q + 4] : 0u;
#pragma unroll
      for (int i = 0; i < 4; i++)
        out[i] = __byte_perm(__funnelshift_l(v[i + 1], v[i], sh), 0, 0x0123);
      if constexpr (PAD) {
        // the row's last byte is the 16th here (inside its words)
        const int rem = tbits[k] & 7;
        if (j0 + 16 == starts[k + 1] && rem)
          out[3] |= static_cast<unsigned>((1 << (8 - rem)) - 1) << 24;
      }
    } else {
      // across a row's end or past its words: every byte's word first
      // (rows walked forward from k), then the 16 loads at once
      long long at[16];
      int sh[16];
      int kb = k;
#pragma unroll
      for (int b = 0; b < 16; b++) {
        const long long j = j0 + b;
        while (kb + 1 < R && starts[kb + 1] <= j) kb++;
        long long local = j - starts[kb];
        local = local < 0 ? 0 : (local > B - 1 ? B - 1 : local);
        at[b] = j < total && j < out_cap
            ? static_cast<long long>(kb) * w_cap + (local >> 2) : -1;
        sh[b] = 24 - 8 * static_cast<int>(local & 3);
        if constexpr (PAD) {
          // the last byte of a row whose bytes fit its words
          if (at[b] >= 0 && j == starts[kb + 1] - 1
              && starts[kb + 1] - starts[kb] <= B) {
            const int rem = tbits[kb] & 7;
            if (rem)
              out[b >> 2] |= static_cast<unsigned>((1 << (8 - rem)) - 1)
                             << (8 * (b & 3));
          }
        }
      }
      unsigned wd[16];
#pragma unroll
      for (int b = 0; b < 16; b++) wd[b] = at[b] >= 0 ? words[at[b]] : 0u;
#pragma unroll
      for (int b = 0; b < 16; b++)
        out[b >> 2] |= ((wd[b] >> sh[b]) & 0xFFu) << (8 * (b & 3));
    }
  }
  uint8_t* dst = data + j0;
  if (j0 + 16 <= out_cap && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(out[0], out[1], out[2],
                                                out[3]);
  } else {
    for (int b = 0; b < 16 && j0 + b < out_cap; b++)
      dst[b] = static_cast<uint8_t>(out[b >> 2] >> (8 * (b & 3)));
  }
}

// the byte stage on stream s behind the row kernel (programmatic
// dependent launch): S seats of R rows each
template <bool PAD>
inline void launch_stream_bytes(const unsigned* words, const int* total_bits,
                                int* byte_lens, int* flags, int S, int R,
                                int e_cap, int w_cap, int out_cap,
                                uint8_t* data, cudaStream_t s) {
  const int threads = 256;
  const long long chunks = (static_cast<long long>(out_cap) + 15) / 16;
  const int starts_bytes = (R + 1) * static_cast<int>(sizeof(long long))
                           + (PAD ? R * static_cast<int>(sizeof(int)) : 0);
  if (starts_bytes > 48 * 1024)
    cudaFuncSetAttribute(stream_bytes_kernel<PAD>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         starts_bytes);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t bcfg = {};
  bcfg.gridDim = dim3(static_cast<unsigned>(
      chunks > 0 ? (chunks + threads - 1) / threads : 1), S);
  bcfg.blockDim = dim3(threads);
  bcfg.dynamicSmemBytes = starts_bytes;
  bcfg.stream = s;
  bcfg.attrs = attr;
  bcfg.numAttrs = 1;
  cudaLaunchKernelEx(&bcfg, stream_bytes_kernel<PAD>, words, total_bits,
                     byte_lens, flags, R, e_cap, w_cap, out_cap, data);
}

inline int round16(long long x) { return static_cast<int>((x + 15) & ~15LL); }

}  // namespace
