// K9 jpeg_pack: every stripe's (payload, nbits) slots -> u32 words, bit
// totals, event counts, the 1-padded stripe bytes concatenated into one
// buffer, and the two overflow flags.
//
// Replaces selkies_tpu/ops/bitpack.py:pack_slot_events_scatter (vmapped
// over stripes by selkies_tpu/engine/encoder.py:build_step_fn),
// selkies_tpu/ops/stripes.py:words_to_bytes_device (pad_ones=True) and
// concat_stripe_bytes.
//
// Bound on the H100: bytes (at 1080p the 3.1 MB of nbits, only the 3.2 MB
// of 16-byte payload pieces that hold an event, the words, 4.2 MB at the
// stock caps and mostly zeros the output must hold, and the byte buffer
// written once: ~10.7 MB, ~3.2 us). The frame's work is a few
// microseconds, so what a call costs beyond it is launches, grids that
// wait for the one before them to drain, serial phases inside a block
// (slots in, sums, the cluster's exchange, placement, words out) and SMs
// left idle.
//
// Design: two grids a call, the second launched behind the first
// (programmatic dependent launch: its blocks wait inside, so its launch
// overlaps the end of the first). No memset precedes them: every word,
// total, count and flag is written by a plain store.
// (A) jpeg_rows_kernel, a thread block cluster of P blocks a stripe (the
//     stripes of every seat back to back; K4's row kernel,
//     csrc/pack_stream.cu, is the pattern, without its headers, skip runs
//     or spill): rank k packs the stripe's scan blocks
//     [k * Mb, (k + 1) * Mb).
//     - A TMA bulk copy (cp.async.bulk, completion on an mbarrier) brings
//       the block's nbits into shared memory, where they stay.
//     - Each warp sums the bits and events of 256-slot steps (four scan
//       blocks; dp4a and a redux.sync a step) and requests, with
//       cp.async, only the 16-byte payload pieces whose nbits are not
//       all zero (chip_smoke's 1080p desktop frame at quality 60 has an
//       event in a quarter of them): a payload is read at most once, and
//       most are never read. The block then stores its 1/P share of the
//       stripe's w_cap words as zeros, and one warp scans its steps into
//       offsets.
//     - The ranks trade their bit and event sums through distributed
//       shared memory and the cluster barrier, split in its two halves:
//       a block arrives, places its codewords from its own first bit
//       (local word 0) while the others arrive, and only then waits and
//       learns where its bits start in the stripe. Rank 0 writes the
//       stripe's total bits and event count (the count also into
//       byte_lens, where the byte stage reads it for flag 0).
//     - Placement: the lanes (eight slots of a step each) whose slots
//       hold an event are queued, with their offsets from the warp's scan,
//       and placed 32 at a time, so no lane idles on empty slots: a lane
//       concatenates its codewords in a 64-bit register and shared-memory
//       atomics add the (at most three) words it covers to the block's
//       word buffer (the codewords' bit ranges are disjoint, so the sum
//       is an OR, as the reference's scatter-add).
//     - The words leave shifted to the rank's first bit, over the zeros:
//       plain stores, but the first and the last word, which the ranks
//       beside it may share, are added (global atomics, which the barrier
//       orders after the zeros), so no second barrier is needed. Words
//       past w_cap are dropped, not wrapped (the reference's per-stripe
//       scatter, not K4's spill). A rank over its 2048-word buffer (a
//       stripe at quality 100 or on noise) waits first and adds its
//       words past the buffer straight into their final words.
//     P comes from the shapes. Where the stripes' clusters fit one wave:
//     the fewest blocks that let a rank keep its nbits and all its
//     payloads in shared memory at two blocks an SM (10 for a 1080p 4:2:0
//     stripe's 2880 scan blocks), more (up to 16, a non-portable cluster
//     size) while the stripes take under an SM each. Else (seats) the
//     fewest that keep a rank's nbits within 32 KB (6 at 1080p). A rank
//     whose payloads do not fit (those, 4:4:4 at 1080p) streams them
//     through two buffers, the next chunk requested before this one is
//     placed; nbits stay in device memory (read twice) only where a
//     rank's share does not fit half an SM's shared memory (a stripe of
//     over ~23,000 scan blocks at 16 blocks).
// (B) stream_bytes_kernel<true> of stripe_bytes.cuh, the byte stage K4
//     shares: the stripes' bytes back to back, each stripe's last byte
//     padded with ones where it lies inside its 4 * w_cap bytes, zeros to
//     out_cap, 16 bytes a thread; its first block a seat writes the byte
//     lengths and both flags ([0]: n_events > e_cap or total_bits >
//     32 * w_cap for any stripe of the seat; [1]: out_cap overflow).
//
// Seats: jpeg_pack_seats replaces the same functions vmapped over the seat
// axis by selkies_tpu/parallel/seats.py:MultiSeatEncoder._build_step
// (:93). The stripes of S seats lie back to back, so grid (A) runs over
// all S * n stripes unchanged (a stripe's words never pass its own
// w_cap); each seat has its own flags pair and (out_cap,) byte buffer,
// and grid (B) takes the seat from blockIdx.y. jpeg_pack is the S = 1
// case.
#include "stripe_bytes.cuh"

namespace {

constexpr int kRank = 16;             // blocks a stripe (the cluster), most
constexpr int kJThreads = 512;
constexpr int kQueue = 64;            // a warp's queued lane groups

struct JpegArgs {
  const int* payload;
  const uint8_t* nbits;
  int M, P, Mb, C, nsteps;   // scan blocks a stripe, cluster, scan blocks
                             // a rank and a chunk, 256-slot steps a rank
  int nb_res;                // nbits resident in shared memory
  int off_nb, off_buf, off_words, off_list, buf_bytes, w_cap;
  unsigned* words;
  int* total_bits;
  int* n_events;
  int* byte_lens;            // the event counts, for the byte stage
};

// the fixed head of the dynamic shared memory; the steps' bits, then
// their offsets, follow it
struct alignas(16) JHead {
  unsigned long long bar_res;
  // each rank's sums, which it writes into every rank's copy
  int x_bits[kRank], x_nev[kRank];
  int nev, bits;             // this block's events and bits
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// a lane's 8 slots of step t (nbits words q, q + 1): its payloads into
// the chunk buffer ``buf`` (scan blocks from c0), only the 16-byte halves
// that hold an event (the entry refuses a payload off 16 bytes)
__device__ __forceinline__ void fetch_slots(const int* g_pay, char* buf,
                                            int c0, int t, int lane,
                                            unsigned w0, unsigned w1) {
  const int slot = 256 * t + 8 * lane;          // the rank's slot
  int* dst = reinterpret_cast<int*>(buf) + (slot - 64 * c0);
  const int* src = g_pay + slot;
  if (w0) cp_async16(dst, src);
  if (w1) cp_async16(dst + 4, src + 4);
}

__device__ __forceinline__ unsigned nb_word(const unsigned* nbw, int q,
                                            int nq) {
  return q < nq ? nbw[q] : 0u;
}

// the payloads of the steps [t0, t1) (a chunk) into ``buf``, warp-strided
__device__ __forceinline__ void fetch_chunk(const int* g_pay, char* buf,
                                            const unsigned* nbw, int nq,
                                            int c0, int t0, int t1, int warp,
                                            int nw, int lane) {
  for (int t = t0 + warp; t < t1; t += nw) {
    const int q = 64 * t + 2 * lane;
    fetch_slots(g_pay, buf, c0, t, lane, nb_word(nbw, q, nq),
                nb_word(nbw, q + 1, nq));
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// K9's rank words: the block places its codewords from its own first
// bit (local word 0 of its shared buffer); they are shifted to the
// stripe's bit s_bit when stored. A rank over 32 * (kWords - 1) bits
// (quality 100, noise) learns s_bit first and adds its words past the
// buffer straight into their final words (global atomics).
struct RankWords {
  unsigned sw;          // shared address of the block's words
  unsigned* gw;         // the stripe's first global word
  int ws, sh, w_cap;    // local word 0's final word and bit shift

  __device__ __forceinline__ void add(int w, unsigned v) const {
    if (!v) return;
    if (w < kWords) {
      red_shared(sw + 4u * static_cast<unsigned>(w), v);
      return;
    }
    const int f = ws + w;
    if (f < w_cap) atomicAdd(&gw[f], sh ? v >> sh : v);
    if (sh && f + 1 < w_cap) atomicAdd(&gw[f + 1], v << (32 - sh));
  }
};

// a rank under 32 * (kWords - 1) bits: every word in the shared buffer
struct SharedWords {
  unsigned sw;

  __device__ __forceinline__ void add(int w, unsigned v) const {
    if (v) red_shared(sw + 4u * static_cast<unsigned>(w), v);
  }
};

// eight slots of a step (a lane's) that hold an event, queued for
// placement, so that the placement's lanes work on groups with events
// only (a 1080p desktop frame at quality 60 has an event in 39% of them)
struct alignas(8) Group {
  int off;              // its first bit, from the rank's first
  int at;               // its slots, from the chunk's first
};

// the groups q[0, n), one a lane, placed through ``sink``; ``nbw`` the
// chunk's nbits (u32 words), ``buf`` its payloads
template <class Sink>
__device__ __forceinline__ void place_groups(const Group* q, int n,
                                             const unsigned* nbw,
                                             const int* buf,
                                             const Sink& sink, int lane) {
  if (lane >= n) return;
  const Group g = q[lane];
  const unsigned w0 = nbw[g.at >> 2], w1 = nbw[(g.at >> 2) + 1];
  const int s8 = static_cast<int>(__dp4a(w0, 0x01010101u, 0u)
                                  + __dp4a(w1, 0x01010101u, 0u));
  // the halves without an event were not fetched: their values are never
  // used
  const int4* pay = reinterpret_cast<const int4*>(buf + g.at);
  const int4 x = pay[0], y = pay[1];
  const int v[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
  int off = g.off;
  if (s8 <= 64) {
    unsigned long long acc = 0ull;
#pragma unroll
    for (int k8 = 0; k8 < 8; k8++) {
      const int nb = ((k8 < 4 ? w0 : w1) >> (8 * (k8 & 3))) & 0xFF;
      acc = (acc << nb) | (nb ? static_cast<unsigned>(v[k8]) : 0u);
    }
    sink.put_run(off, acc, s8);
  } else {
    int cw = -1;
    unsigned cv = 0u;
#pragma unroll
    for (int k8 = 0; k8 < 8; k8++) {
      const int nb = ((k8 < 4 ? w0 : w1) >> (8 * (k8 & 3))) & 0xFF;
      if (nb) sink.merge(cw, cv, off, static_cast<unsigned>(v[k8]), nb);
      off += nb;
    }
    sink.add(cw, cv);
  }
}

// the steps [t0, t0 + nt) of a chunk (its payloads in ``buf``), a warp a
// step: the lane groups with events are queued (their offsets from the
// warp's scan) and placed 32 at a time
template <class Sink>
__device__ __forceinline__ void place_chunk(const Sink& sink, Group* q,
                                            const unsigned* nbw, int nq,
                                            const int* step_off,
                                            const int* buf, int t0, int nt,
                                            int warp, int nw, int lane) {
  int pend = 0;                  // the warp's queued groups
  for (int i = warp; i < nt; i += nw) {
    const int t = t0 + i;
    // slots 8 * lane .. 8 * lane + 7 of step t
    const int qw = 64 * t + 2 * lane;
    const unsigned w0 = nb_word(nbw, qw, nq), w1 = nb_word(nbw, qw + 1, nq);
    const int s8 = static_cast<int>(__dp4a(w0, 0x01010101u, 0u)
                                    + __dp4a(w1, 0x01010101u, 0u));
    const unsigned bal = __ballot_sync(0xffffffffu, s8 > 0);
    if (!bal) continue;
    const int incl = warp_incl_sum(s8, lane);
    if (s8)
      q[pend + __popc(bal & ((1u << lane) - 1u))] =
          Group{step_off[t] + incl - s8, 256 * i + 8 * lane};
    pend += __popc(bal);
    if (pend >= 32) {
      __syncwarp();
      place_groups(q, 32, nbw + 64 * t0, buf, sink, lane);
      __syncwarp();
      if (lane < pend - 32) q[lane] = q[32 + lane];
      __syncwarp();
      pend -= 32;
    }
  }
  __syncwarp();
  place_groups(q, pend, nbw + 64 * t0, buf, sink, lane);
}

__global__ void __launch_bounds__(kJThreads, 2)
jpeg_rows_kernel(const JpegArgs a) {
  extern __shared__ __align__(16) char smem[];
  JHead& h = *reinterpret_cast<JHead*>(smem);
  int* step_off = reinterpret_cast<int*>(smem + sizeof(JHead));
  unsigned* sw = reinterpret_cast<unsigned*>(smem + a.off_words);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5, P = a.P, rank = cluster_rank();
  const int s = blockIdx.x / P;
  const int m_lo = rank * a.Mb;
  const int nm = max(0, min(a.Mb, a.M - m_lo));
  const size_t g_lo = static_cast<size_t>(s) * a.M + m_lo;
  const uint8_t* g_nb = a.nbits + g_lo * 64;
  const int* g_pay = a.payload + g_lo * 64;
  const unsigned* nbw = reinterpret_cast<const unsigned*>(
      a.nb_res ? reinterpret_cast<const uint8_t*>(smem + a.off_nb
                                                  + misalign(g_nb))
               : g_nb);
  char* bufs = smem + a.off_buf;
  const int nsteps = (nm + 3) >> 2, steps_c = a.C >> 2;
  const int nchunks = (nsteps + steps_c - 1) / steps_c;
  const int nq = 16 * nm;                  // the block's nbits, u32 words
  const int w_cap = a.w_cap;
  unsigned* gw = a.words + static_cast<size_t>(s) * w_cap;
  if (tid == 0) {
    mbar_init(&h.bar_res, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    h.nev = 0;
    if (nm > 0 && a.nb_res) {
      char* const dst[1] = {smem + a.off_nb};
      const void* const src[1] = {g_nb};
      const unsigned bytes[1] = {64u * nm};
      bulk_copies<1>(dst, src, bytes, &h.bar_res);
    }
  }
  for (int i = tid; i < kWords; i += blockDim.x) sw[i] = 0u;
  __syncthreads();
  if (nm > 0 && a.nb_res) mbar_wait(&h.bar_res, 0);
  // each step's bits, the block's events, and the first chunk's payloads
  // (only the 16-byte halves that hold an event)
  int nev = 0;
  const int t0_end = min(nsteps, steps_c);
  for (int t = warp; t < nsteps; t += nw) {
    const int q = 64 * t + 2 * lane;
    const unsigned w0 = nb_word(nbw, q, nq), w1 = nb_word(nbw, q + 1, nq);
    nev += (__popc(__vcmpne4(w0, 0u)) + __popc(__vcmpne4(w1, 0u))) >> 3;
    const int bits = warp_sum(static_cast<int>(
        __dp4a(w0, 0x01010101u, 0u) + __dp4a(w1, 0x01010101u, 0u)));
    if (lane == 0) step_off[t] = bits;
    if (t < t0_end)
      fetch_slots(g_pay, bufs, 0, t, lane, w0, w1);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  // then this rank's share of the stripe's words as zeros: the words
  // that carry bits are stored or added over them after the cluster
  // barrier, which orders them
  {
    const int zs = ((w_cap + P - 1) / P + 3) & ~3;
    store_words(gw, min(w_cap, rank * zs), min(w_cap, (rank + 1) * zs),
                [](int) { return 0u; });
  }
  nev = warp_sum(nev);
  if (lane == 0 && nev) atomicAdd(&h.nev, nev);
  __syncthreads();
  // the block's steps scanned into offsets from its first bit; its sums
  // into every rank's copy
  if (warp == 0) {
    int bits = 0;
    for (int t0 = 0; t0 < nsteps; t0 += 32) {
      const int t = t0 + lane;
      const int v = t < nsteps ? step_off[t] : 0;
      const int incl = warp_incl_sum(v, lane);
      if (t < nsteps) step_off[t] = bits + incl - v;
      bits += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane < P) {
      st_cluster(map_rank(smem_u32(&h.x_bits[rank]), lane), bits);
      st_cluster(map_rank(smem_u32(&h.x_nev[rank]), lane), h.nev);
    }
    if (lane == 0) h.bits = bits;
  }
  __syncthreads();
  // the cluster's barrier in two halves: the codewords are placed from
  // the rank's own first bit while the other ranks arrive, unless the
  // rank's words overrun its buffer (they then need their final place)
  cluster_arrive();
  const int rbits = h.bits;
  const bool big = rbits > 32 * (kWords - 1);
  int s_bit = 0, total = 0, n_ev = 0;
  auto layout = [&]() {
    cluster_wait();
    for (int k = 0; k < P; k++) {
      const int b = h.x_bits[k];
      s_bit += k < rank ? b : 0;
      total += b;
      n_ev += h.x_nev[k];
    }
  };
  if (big) layout();
  // chunk by chunk (one chunk where the rank's payloads fit, else two
  // buffers: the next chunk's fetch is issued before this one's
  // placement)
  Group* queue = reinterpret_cast<Group*>(smem + a.off_list)
                 + warp * kQueue;
  for (int k = 0; k < nchunks; k++) {
    const int t0 = k * steps_c, nt = min(steps_c, nsteps - t0);
    if (k + 1 < nchunks) {
      fetch_chunk(g_pay, bufs + ((k + 1) & 1) * a.buf_bytes, nbw, nq,
                  (k + 1) * a.C, t0 + steps_c,
                  min(nsteps, t0 + 2 * steps_c), warp, nw, lane);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();
    const int* buf =
        reinterpret_cast<const int*>(bufs + (k & 1) * a.buf_bytes);
    if (big)
      place_chunk(BitSink<RankWords>{{smem_u32(sw), gw, s_bit >> 5,
                                      s_bit & 31, w_cap}},
                  queue, nbw, nq, step_off, buf, t0, nt, warp, nw, lane);
    else
      place_chunk(BitSink<SharedWords>{{smem_u32(sw)}}, queue, nbw, nq,
                  step_off, buf, t0, nt, warp, nw, lane);
    __syncthreads();   // before the buffer takes the chunk after next
  }
  if (!big) layout();
  // the byte stage may launch; it waits for this grid's end inside
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  // the words, shifted to s_bit: final word ws + i takes local words i
  // and i - 1. The first and the last may be shared with the ranks
  // beside this one, and the one past the buffer with its atomics: those
  // are added into the zeros, the others stored
  {
    const int sh = s_bit & 31, ws = s_bit >> 5;
    const int nf = rbits ? (sh + rbits + 31) >> 5 : 0;
    const bool tail = ((s_bit + rbits) & 31) != 0;
    for (int i = tid; i < min(nf, kWords + 1); i += blockDim.x) {
      const int f = ws + i;
      if (f >= w_cap) break;
      unsigned v = i < kWords ? (sw[i] >> sh) : 0u;
      if (sh && i > 0) v |= sw[i - 1] << (32 - sh);
      if ((i == 0 && sh) || (i == nf - 1 && tail) || i == kWords) {
        if (v) atomicAdd(&gw[f], v);
      } else {
        gw[f] = v;
      }
    }
  }
  if (tid == 0 && rank == 0) {
    a.total_bits[s] = total;
    a.n_events[s] = n_ev;
    a.byte_lens[s] = n_ev;
  }
}

// the shared-memory layout of a cluster of P blocks a stripe: nbits
// resident where ``budget`` allows, and the payloads of all the rank's
// scan blocks in one buffer, else of C at a time in two; -> the bytes a
// block takes, 0 where it fits no budget
int plan_layout(JpegArgs& a, int P, int budget) {
  a.P = P;
  a.Mb = (a.M + P - 1) / P;
  a.nsteps = (a.Mb + 3) >> 2;
  const int c_all = 4 * a.nsteps;
  for (a.nb_res = 1; a.nb_res >= 0; a.nb_res--) {
    a.off_nb = round16(sizeof(JHead) + 4LL * a.nsteps);
    a.off_buf = a.off_nb + (a.nb_res ? round16(64LL * a.Mb + 32) : 0);
    const long long fixed = a.off_buf + 4LL * kWords
                            + static_cast<long long>(sizeof(Group)) * kQueue
                              * (kJThreads / 32);
    if (fixed + 256LL * c_all <= budget) {
      a.C = c_all;
      a.buf_bytes = 256 * c_all;
      a.off_words = a.off_buf + a.buf_bytes;
      a.off_list = a.off_words + 4 * kWords;
      return static_cast<int>(fixed + a.buf_bytes);
    }
    const long long c = (budget - fixed) / 512 / 4 * 4;
    if (c >= 4) {
      a.C = static_cast<int>(c);
      a.buf_bytes = 256 * a.C;
      a.off_words = a.off_buf + 2 * a.buf_bytes;
      a.off_list = a.off_words + 4 * kWords;
      return static_cast<int>(fixed + 2LL * a.buf_bytes);
    }
  }
  return 0;
}

}  // namespace

// n_seats seats of S / n_seats stripes each: words (S, w_cap), total_bits,
// n_events and byte_lens (S,), data (n_seats, out_cap), flags (n_seats, 2).
extern "C" int jpeg_pack_seats(const int* payload, const uint8_t* nbits,
                               int n_seats, int S, int M, int e_cap,
                               int w_cap, int out_cap, int* words,
                               int* total_bits, int* n_events, uint8_t* data,
                               int* byte_lens, int* flags, void* stream) {
  if (n_seats <= 0 || n_seats > 65535 || S <= 0 || S % n_seats || M <= 0
      || w_cap <= 0 || out_cap < 0 || M > (1 << 24)
      || static_cast<long long>(S) * kRank > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  // nbits is read as u32 words, payloads as 16-byte pieces
  if ((reinterpret_cast<uintptr_t>(nbits) & 3)
      || (reinterpret_cast<uintptr_t>(payload) & 15))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // per device, read once: shared memory a block may opt into, SMs; the
  // kernel is allowed all of it and clusters of up to 16 blocks once (the
  // values are the same in every thread that races to set them)
  static int known[64][2];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!known[dev][0]) {
    int smem = 0, count = 0;
    cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(jpeg_rows_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaFuncSetAttribute(jpeg_rows_kernel,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    known[dev][1] = count;
    known[dev][0] = smem;
  }
  const int smem_max = known[dev][0];
  const int budget2 = smem_max / 2 - 1024;      // two blocks an SM
  JpegArgs a{payload, nbits, M, 1, M, 0, 0, 1, 0, 0, 0, 0, 0, w_cap,
             reinterpret_cast<unsigned*>(words), total_bits, n_events,
             byte_lens};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kJThreads);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // blocks a stripe. Where every stripe's cluster fits one wave (two
  // blocks an SM on the 7/8 of the SMs that clusters occupy): the fewest
  // that let a rank keep its nbits and payloads in shared memory (10 for
  // a 1080p 4:2:0 stripe), more (up to 16) while the stripes take under
  // an SM each. Else (seats: several waves) the fewest that keep a rank's
  // nbits within 32 KB, its payloads passing through two buffers (6 at
  // 1080p: fewer, longer blocks, measured faster there than 5, 7, 8 or
  // 10)
  const int sms = known[dev][1];
  int p_res = kRank;
  for (int P = 1; P <= kRank; P++) {
    if (plan_layout(a, P, budget2) && a.C == 4 * a.nsteps && a.nb_res) {
      p_res = P;
      break;
    }
  }
  int P = p_res;
  if (static_cast<long long>(S) * p_res <= 7LL * sms / 4) {
    const int p_sms = sms / S;
    P = p_sms > p_res ? (p_sms < kRank ? p_sms : kRank) : p_res;
  } else {
    const long long p_nb = (64LL * M + 32767) / 32768;
    P = p_nb < 1 ? 1 : (p_nb > kRank ? kRank : static_cast<int>(p_nb));
  }
  int bytes = plan_layout(a, P, budget2);
  if (!bytes) bytes = plan_layout(a, P, smem_max);
  if (!bytes) return static_cast<int>(cudaErrorInvalidValue);
  attr[0].val.clusterDim.x = P;
  cfg.gridDim = dim3(static_cast<unsigned>(S * P));
  cfg.dynamicSmemBytes = bytes;
  cudaLaunchKernelEx(&cfg, jpeg_rows_kernel, a);
  launch_stream_bytes<true>(reinterpret_cast<const unsigned*>(words),
                            total_bits, byte_lens, flags, n_seats,
                            S / n_seats, e_cap, w_cap, out_cap, data, st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int jpeg_pack(const int* payload, const uint8_t* nbits, int S,
                         int M, int e_cap, int w_cap, int out_cap, int* words,
                         int* total_bits, int* n_events, uint8_t* data,
                         int* byte_lens, int* flags, void* stream) {
  return jpeg_pack_seats(payload, nbits, 1, S, M, e_cap, w_cap, out_cap,
                         words, total_bits, n_events, data, byte_lens, flags,
                         stream);
}
