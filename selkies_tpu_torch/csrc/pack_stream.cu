// K4 pack_stream: slice rows of one frame -> u32 words, bit totals, the
// ragged byte buffer, and both overflow flags.
//
// Replaces selkies_tpu/ops/h264_planes.py:_EventSink (the default scatter
// packer), _excl_cumsum0, _assemble_frame, _assemble_p_frame (row prefix
// events, P skip runs, tail events), and selkies_tpu/ops/stripes.py:
// words_to_bytes_device (pad_ones=False) and concat_stripe_bytes.
//
// Bound on the H100: bytes. The ~36 MB slot arrays of K3 are read once;
// the words (6.3 MB at 1080p) and the byte buffer are written once. A row
// packed by one block is held to what one SM pulls from memory and
// issues (0.083 ms at 1080p on the H100), so a row is split over a
// thread block cluster of P blocks (3 for a 1080p 4:2:0 frame, measured
// faster than 2 or 4; up to 8 for a band of a few rows; as few as the
// resident nb allows when seats fill the card): rank k packs the row's
// MBs [k * Mb, (k + 1) * Mb).
//
// Width: a block keeps its MBs' nb slot bytes resident in shared memory,
// kNbMax of them where two blocks share an SM; where 8 blocks cannot
// hold a row so, up to what one block an SM holds (4:4:4 at 3840 px:
// 52 KB a block); a row wider still (over ~888 MBs at 4:4:4's slot
// counts) reads nb from device memory, once for the sums and again for
// the placement. Rows of up to 8 * kMaxMBs = 1056 MBs (16896 px) are
// packed, past the widest row H.264 allows (level 6.2: sqrt(8 * 139264)
// = 1055 MBs); a wider one is refused (cudaErrorInvalidValue).
//
// Design: three grids on one stream, (2) and (3) each launched behind the
// one before it (programmatic dependent launch: its blocks wait inside,
// so its launch overlaps the end of the grid before).
// (1) pack_rows_kernel<false>, a cluster of P blocks a row (the rows of
//     every seat back to back):
//     - TMA bulk copies (cp.async.bulk, completion on an mbarrier) bring
//       the block's nb slot bytes and header slots into shared memory,
//       where they stay, and its slot payloads through a two-stage ring,
//       C MBs a stage, which the block's last warp refills as soon as the
//       other warps have released a stage (an "empty" mbarrier, no block
//       barrier between stages); each copy is the 16-byte-aligned span
//       that covers its data (nb rows are only 4-byte aligned an MB).
//     - Each warp sums an MB's bits from the resident nb (four slots a
//       lane and instruction, one redux.sync a 256-slot step); one warp
//       scans the block's MBs: an exclusive max-scan of "last coded MB"
//       gives the P skip runs, an exclusive sum-scan the MB offsets.
//     - The ranks trade their sums through distributed shared memory
//       (bits, events, first and last coded MB), so each knows where its
//       bits start in the row, the skip run of its first coded MB (which
//       depends on the ranks before it), the row's total and its
//       trailing skip run. Chosen over a decoupled look-back: a row's
//       blocks are co-scheduled, and no flag or scratch memory is needed.
//     - Warps place (MB, 256-slot step) tasks, eight slots a lane (one
//       warp scan a step): a lane concatenates its events in a 64-bit
//       register and shared-memory atomics add the (at most three) words
//       it covers to the block's word buffer; a step whose nb bytes are
//       all zero (gated-off blocks) is skipped.
//     - A block's first word may belong to an earlier rank (the one whose
//       bits cover the word's first bit): after a cluster barrier it is
//       added into that rank's buffer through distributed shared memory;
//       after a second, each block writes the words it owns with 16-byte
//       stores, and a share of the zeros past the row's bits, so no
//       memset precedes the kernel. Words past a block's 2048-word buffer
//       (over 65536 bits) take global atomics into zeros their owner
//       stored before the first barrier.
// (2) pack_rows_kernel<true>, the same grid: only the clusters of rows
//     whose bits exceed w_cap * 32 stay, redo the layout, and add the
//     events past the row's words into the following rows' words (global
//     atomics after grid (1)'s plain stores: the kernel boundary orders
//     them). Words are combined by addition, as the reference's
//     scatter-add: the bit ranges are disjoint, and where a row spills the
//     sum is what the reference computes; a seat's rows never spill past
//     its R * w_cap words.
// (3) stream_bytes_kernel<false> of stripe_bytes.cuh, the byte stage K9
//     shares (with its pad-with-ones flag off): the byte buffer
//     (zero-padded rows back to back, zeros to out_cap), 16 bytes a
//     thread: each block scans the seat's R row byte lengths with one
//     warp, a thread finds its row by binary search and, where its 16
//     bytes lie inside one row's words, funnel-shifts five big-endian
//     words into one 16-byte store. The first block of each seat writes
//     the seat's byte lengths and flags (grid (1) leaves each row's event
//     count in byte_lens for it). Bound by the words' read from L2 and
//     the buffer's write.
//
// Seats: pack_stream_seats replaces the same functions vmapped over the
// seat axis by selkies_tpu/parallel/h264_seats.py:MultiSeatH264Encoder.
// _build (:98). The rows of S seats lie back to back (S * R row
// clusters, one call a tick); every bound is the seat's own, as under
// vmap: a row's words may spill into the next row's only up to the seat's
// R * w_cap words (seat k's last row never reaches seat k + 1's first),
// and each seat has its own flags pair and (out_cap,) byte buffer.
// pack_stream is the S = 1 case.
#include "stripe_bytes.cuh"

namespace {

constexpr int kSteps = 7;           // 256-slot steps an MB, at most
constexpr int kMaxMBs = 132;        // MBs a block
constexpr int kMaxRank = 8;         // blocks a row (the cluster)
constexpr int kNbMax = 36 * 1024;   // resident nb bytes a block, preferred
constexpr int kThreads = 512;

struct PackArgs {
  const int* hdr_pay;
  const int* hdr_nb;
  const int* ev_pay;
  const uint8_t* ev_nb;
  const int* row_hdr_pay;
  const int* row_hdr_nb;
  const int* row_id;
  const int* qp;
  int SB, intra, R, M, e_cap, w_cap;
  int P, Mb, C, nsteps;              // cluster, MBs a block / a stage
  int nb_res;                        // nb resident in shared memory
  int off_nb, off_hp, off_hn, off_ring, off_words, stage_bytes;
  unsigned* words;
  int* total_bits;
  int* byte_lens;   // grid (1) leaves each row's event count here
};

// the fixed head of the dynamic shared memory
struct alignas(16) Head {
  unsigned long long bar_res, bar[2], empty[2];
  int mb_bits[kMaxMBs], mb_cnt[kMaxMBs], hdr_bits[kMaxMBs];
  int mb_start[kMaxMBs], skip_pay[kMaxMBs], skip_nb[kMaxMBs];
  // each rank's sums, which it writes into every rank's copy: bits and
  // events of its MBs (without its first coded MB's skip run), first and
  // last coded MB (row index, -1 if none)
  int x_bits[kMaxRank], x_nev[kMaxRank], x_first[kMaxRank],
      x_last[kMaxRank];
  int s_bit[kMaxRank + 1];   // each rank's first bit; [P]: the row's total
  int pre_pay[HDR_SLOTS], pre_nb[HDR_SLOTS];
  int base, own_sp, own_sn;  // this block's first MB bit, first skip run
  int tail_off, tail_pay, tail_nb, nev;
};

// one thread: the payloads of the block's MBs [m0, m0 + n) into a stage
__device__ __forceinline__ void issue_stage(const PackArgs& a, char* stage,
                                            unsigned long long* bar,
                                            size_t g_lo, int m0, int n) {
  char* const dst[1] = {stage};
  const void* const src[1] = {a.ev_pay + (g_lo + m0) * a.SB};
  const unsigned bytes[1] = {4u * n * a.SB};
  bulk_copies<1>(dst, src, bytes, bar);
}

__device__ __forceinline__ void qp_event(int qp, int* p, int* n) {
  const int d = qp - 26;
  ue_event(d > 0 ? 2 * d - 1 : -2 * d, p, n);
}

// The block's MBs of its row, where their slots sit in shared memory.
struct Block {
  const uint8_t* nb;    // nb, (nm, SB), 4-byte aligned an MB: resident,
                        // or in device memory (rows too wide for that)
  const int* hp;        // resident header slots, (nm, 6)
  const int* hn;
  int pay_mis;          // where the payloads start inside a stage
  int m_lo, nm;         // the block's first MB of the row, its MBs
  size_t g_lo;          // its first MB over every row
};

// task t of the block's MB j, whose payloads are in ``stage`` from MB m0:
// t < 0 its header slots (lanes 0-5; slot 0 of a P MB is its skip run),
// else its 256-slot step t, eight slots a lane: a lane's events are
// concatenated in a 64-bit register and added as up to three words (a
// lane over 64 bits adds them event by event)
template <bool SPILL>
__device__ __forceinline__ void place_task(const PackArgs& a, const Block& b,
                                           const Head& h,
                                           const Sink<SPILL>& sink,
                                           const int* step_off,
                                           const char* stage, int m0, int j,
                                           int t, int lane) {
  if (t < 0) {
    int p = 0, n = 0;
    if (lane == 0 && !a.intra) {
      p = h.skip_pay[j];
      n = h.skip_nb[j];
    } else if (lane < HDR_SLOTS) {
      p = b.hp[j * HDR_SLOTS + lane];
      n = b.hn[j * HDR_SLOTS + lane];
    }
    const int incl = warp_incl_sum(n, lane);
    if (n > 0)
      sink.put(h.mb_start[j] + incl - n, static_cast<unsigned>(p), n);
    return;
  }
  const int nq = a.SB >> 2, q = 64 * t + 2 * lane;
  const unsigned* nbw = reinterpret_cast<const unsigned*>(b.nb + j * a.SB);
  const unsigned w0 = q < nq ? nbw[q] : 0u;
  const unsigned w1 = q + 1 < nq ? nbw[q + 1] : 0u;
  if (!__any_sync(0xffffffffu, (w0 | w1) != 0)) return;
  const int s8 = static_cast<int>(__dp4a(w0, 0x01010101u, 0u)
                                  + __dp4a(w1, 0x01010101u, 0u));
  const int incl = warp_incl_sum(s8, lane);
  if (!s8) return;
  // a stage holds 16 bytes of slack past its last payload
  const int* pay = reinterpret_cast<const int*>(stage + b.pay_mis)
                   + static_cast<size_t>(j - m0) * a.SB + 4 * q;
  int v[8];
  if (b.pay_mis == 0) {
    const int4 x = reinterpret_cast<const int4*>(pay)[0];
    const int4 y = reinterpret_cast<const int4*>(pay)[1];
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
  } else {
#pragma unroll
    for (int k = 0; k < 8; k++) v[k] = pay[k];
  }
  int off = step_off[j * a.nsteps + t] + incl - s8;
  if (s8 <= 64) {
    unsigned long long acc = 0ull;
#pragma unroll
    for (int k = 0; k < 8; k++) {
      const int nb = ((k < 4 ? w0 : w1) >> (8 * (k & 3))) & 0xFF;
      acc = (acc << nb) | (nb ? static_cast<unsigned>(v[k]) : 0u);
    }
    sink.put_run(off, acc, s8);
  } else {
    int cw = -1;
    unsigned cv = 0u;
#pragma unroll
    for (int k = 0; k < 8; k++) {
      const int nb = ((k < 4 ? w0 : w1) >> (8 * (k & 3))) & 0xFF;
      if (nb) sink.merge(cw, cv, off, static_cast<unsigned>(v[k]), nb);
      off += nb;
    }
    sink.add(cw, cv);
  }
}

// SPILL false: grid (1); true: grid (2). A cluster of P blocks a row,
// rank k packing the row's MBs [k * Mb, (k + 1) * Mb).
template <bool SPILL>
__global__ void __launch_bounds__(kThreads, 1)
pack_rows_kernel(const PackArgs a) {
  extern __shared__ __align__(16) char smem[];
  Head& h = *reinterpret_cast<Head*>(smem);
  int* step_off = reinterpret_cast<int*>(smem + sizeof(Head));
  unsigned* sw = reinterpret_cast<unsigned*>(smem + a.off_words);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5, P = a.P, rank = cluster_rank();
  const int r = blockIdx.x / P;
  if constexpr (SPILL) {
    // launched behind grid (1) (programmatic dependent launch): let grid
    // (3) launch, wait for grid (1)'s words and totals
    asm volatile("griddepcontrol.launch_dependents;\n"
                 "griddepcontrol.wait;" ::: "memory");
    if (a.total_bits[r] <= a.w_cap * 32) return;   // the whole cluster
  }
  Block b;
  b.m_lo = rank * a.Mb;
  b.nm = max(0, min(a.Mb, a.M - b.m_lo));
  b.g_lo = static_cast<size_t>(r) * a.M + b.m_lo;
  const uint8_t* g_nb = a.ev_nb + b.g_lo * a.SB;
  const int* g_hp = a.hdr_pay + b.g_lo * HDR_SLOTS;
  const int* g_hn = a.hdr_nb + b.g_lo * HDR_SLOTS;
  b.nb = a.nb_res ? reinterpret_cast<const uint8_t*>(smem + a.off_nb
                                                      + misalign(g_nb))
                  : g_nb;
  b.hp = reinterpret_cast<const int*>(smem + a.off_hp + misalign(g_hp));
  b.hn = reinterpret_cast<const int*>(smem + a.off_hn + misalign(g_hn));
  b.pay_mis = misalign(a.ev_pay + b.g_lo * a.SB);
  char* ring = smem + a.off_ring;
  const int nchunks = (b.nm + a.C - 1) / a.C;
  if (tid == 0) {
    mbar_init(&h.bar_res, 1);
    mbar_init(&h.bar[0], 1);
    mbar_init(&h.bar[1], 1);
    mbar_init(&h.empty[0], nw - 1);
    mbar_init(&h.empty[1], nw - 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (b.nm > 0) {
      // resident: the header slots and nb; the ring: two stages ahead
      char* const dst[3] = {smem + a.off_hp, smem + a.off_hn,
                            smem + a.off_nb};
      const void* const src[3] = {g_hp, g_hn, g_nb};
      const unsigned bytes[3] = {4u * b.nm * HDR_SLOTS,
                                 4u * b.nm * HDR_SLOTS, 1u * b.nm * a.SB};
      if (a.nb_res) {
        bulk_copies<3>(dst, src, bytes, &h.bar_res);
      } else {
        char* const dst2[2] = {dst[0], dst[1]};
        const void* const src2[2] = {src[0], src[1]};
        const unsigned bytes2[2] = {bytes[0], bytes[1]};
        bulk_copies<2>(dst2, src2, bytes2, &h.bar_res);
      }
      for (int k = 0; k < 2 && k < nchunks; k++)
        issue_stage(a, ring + k * a.stage_bytes, &h.bar[k], b.g_lo,
                    k * a.C, min(a.C, b.nm - k * a.C));
    }
  }
  if constexpr (!SPILL) {
    for (int i = tid; i < kWords; i += blockDim.x) sw[i] = 0u;
  }
  // the row prefix: [hdr(2), idr_pic_id | frame_num, flags, qp, deblock]
  if (tid < HDR_SLOTS) {
    int p = 0, n = 0;
    if (tid < 2) {
      p = a.row_hdr_pay[2 * r + tid];
      n = a.row_hdr_nb[2 * r + tid];
    } else if (tid == 2) {
      if (a.intra) ue_event(a.row_id[r], &p, &n);        // idr_pic_id
      else { p = a.row_id[r] & 0xF; n = 4; }              // frame_num
    } else if (tid == 3) {
      n = a.intra ? 2 : 3;                                // '00' / '000'
    } else if (tid == 4) {
      qp_event(a.qp[r], &p, &n);
    } else {
      p = 2; n = 3;                                       // deblock ue(1)
    }
    h.pre_pay[tid] = p;
    h.pre_nb[tid] = n;
  }
  __syncthreads();
  if (b.nm > 0) mbar_wait(&h.bar_res, 0);
  // MB bits, each 256-slot step's bits, event counts (P: slot 0 is the
  // skip run, added by the scan)
  const int nq = a.SB >> 2;
  for (int j = warp; j < b.nm; j += nw) {
    const unsigned* nbw = reinterpret_cast<const unsigned*>(b.nb + j * a.SB);
    // [0, kSteps): the steps' bits; then the header bits, the events
    int x[kSteps + 2];
    x[kSteps] = x[kSteps + 1] = 0;
    if (lane < HDR_SLOTS && (a.intra || lane > 0)) {
      x[kSteps] = b.hn[j * HDR_SLOTS + lane];
      x[kSteps + 1] = x[kSteps] > 0;
    }
#pragma unroll
    for (int t = 0; t < kSteps; t++) {
      x[t] = 0;
      if (t < a.nsteps) {
        const int q = 64 * t + lane;
        const unsigned w0 = q < nq ? nbw[q] : 0u;
        const unsigned w1 = q + 32 < nq ? nbw[q + 32] : 0u;
        x[kSteps + 1] += (__popc(__vcmpne4(w0, 0u))
                          + __popc(__vcmpne4(w1, 0u))) >> 3;
        x[t] = static_cast<int>(__dp4a(w0, 0x01010101u, 0u)
                                + __dp4a(w1, 0x01010101u, 0u));
      }
    }
#pragma unroll
    for (int t = 0; t < kSteps + 2; t++)
      if (t >= kSteps || t < a.nsteps) x[t] = warp_sum(x[t]);
    if (lane == 0) {
      int bits = x[kSteps];
#pragma unroll
      for (int t = 0; t < kSteps; t++) {
        if (t < a.nsteps) {
          step_off[j * a.nsteps + t] = x[t];
          bits += x[t];
        }
      }
      h.mb_bits[j] = bits;
      h.mb_cnt[j] = x[kSteps + 1];
      h.hdr_bits[j] = x[kSteps];
    }
  }
  __syncthreads();
  // the block's scans, 32 MBs a pass: offsets from the block's first MB,
  // the skip runs of its coded MBs but the first, the sums the ranks trade
  if (warp == 0) {
    int bits = 0, last = -1, nev = 0, first = -1;
    for (int j0 = 0; j0 < b.nm; j0 += 32) {
      const int j = j0 + lane, m = b.m_lo + j;
      const bool valid = j < b.nm;
      const bool coded = valid && !a.intra && b.hn[j * HDR_SLOTS + 1] > 0;
      int incl_last = coded ? m : -1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl_last, o);
        if (lane >= o) incl_last = max(incl_last, t);
      }
      int prev = __shfl_up_sync(0xffffffffu, incl_last, 1);
      prev = max(last, lane > 0 ? prev : -1);
      int sp = 0, sn = 0;
      if (coded && prev >= 0) ue_event(m - prev - 1, &sp, &sn);
      const unsigned firsts = __ballot_sync(0xffffffffu, coded && prev < 0);
      if (firsts) first = b.m_lo + j0 + __ffs(firsts) - 1;
      const int v = valid ? h.mb_bits[j] + sn : 0;
      const int incl = warp_incl_sum(v, lane);
      if (valid) {
        h.mb_start[j] = bits + incl - v;
        h.skip_pay[j] = sp;
        h.skip_nb[j] = sn;
      }
      nev += warp_sum(valid ? h.mb_cnt[j] + (sn > 0) : 0);
      bits += __shfl_sync(0xffffffffu, incl, 31);
      last = max(last, __shfl_sync(0xffffffffu, incl_last, 31));
    }
    // this rank's sums into every rank's copy
    if (lane < P) {
      st_cluster(map_rank(smem_u32(&h.x_bits[rank]), lane), bits);
      st_cluster(map_rank(smem_u32(&h.x_nev[rank]), lane), nev);
      st_cluster(map_rank(smem_u32(&h.x_first[rank]), lane), first);
      st_cluster(map_rank(smem_u32(&h.x_last[rank]), lane), last);
    }
  }
  cluster_sync();
  // the row's layout from every rank's sums: where each rank's bits
  // start, the skip run of each rank's first coded MB, the tail
  if (tid == 0) {
    int off = 0, nev = 0;
    for (int k = 0; k < HDR_SLOTS; k++) {
      off += h.pre_nb[k];
      nev += h.pre_nb[k] > 0;
    }
    int prev = -1;
    h.own_sp = h.own_sn = 0;
    for (int k = 0; k < P; k++) {
      h.s_bit[k] = k == 0 ? 0 : off;
      if (k == rank) h.base = off;
      int bits = h.x_bits[k];
      if (h.x_first[k] >= 0) {
        int sp, sn;
        ue_event(h.x_first[k] - prev - 1, &sp, &sn);
        bits += sn;
        nev += 1;
        if (k == rank) {
          h.own_sp = sp;
          h.own_sn = sn;
        }
      }
      off += bits;
      nev += h.x_nev[k];
      if (h.x_last[k] >= 0) prev = h.x_last[k];
    }
    int tp = 0, tn = 0;
    if (!a.intra && a.M - 1 - prev > 0) ue_event(a.M - 1 - prev, &tp, &tn);
    h.tail_off = off;
    h.tail_pay = tp;
    h.tail_nb = tn;
    h.s_bit[P] = off + tn + 1;
    h.nev = nev + (tn > 0) + 1;
  }
  __syncthreads();
  // the block's MB and step offsets in the row
  {
    const int jf = h.x_first[rank] >= 0 ? h.x_first[rank] - b.m_lo : -1;
    for (int j = tid; j < b.nm; j += blockDim.x) {
      if (j == jf) {
        h.skip_pay[j] = h.own_sp;
        h.skip_nb[j] = h.own_sn;
      }
      const int start = h.base + h.mb_start[j]
                        + (jf >= 0 && j > jf ? h.own_sn : 0);
      h.mb_start[j] = start;
      int o = start + h.skip_nb[j] + h.hdr_bits[j];
      for (int t = 0; t < a.nsteps; t++) {
        const int bits = step_off[j * a.nsteps + t];
        step_off[j * a.nsteps + t] = o;
        o += bits;
      }
    }
  }
  const int s_bit = h.s_bit[rank], e_bit = h.s_bit[rank + 1];
  const int total = h.s_bit[P];
  const int ws = s_bit >> 5;
  unsigned* gw = a.words + static_cast<long long>(r) * a.w_cap;
  // the words this block owns: those whose first bit is its
  const int own_lo = (s_bit + 31) >> 5, own_hi = (e_bit + 31) >> 5;
  if constexpr (!SPILL) {
    // zeros under the words past the shared buffer that take atomics
    store_words(gw, max(own_lo, ws + kWords),
                min((e_bit + 31) >> 5, a.w_cap), [](int) { return 0u; });
  }
  __syncthreads();
  const long long room = static_cast<long long>(a.R - r % a.R) * a.w_cap;
  const Sink<SPILL> sink{smem_u32(sw), gw, ws, a.w_cap, room};
  // the prefix (rank 0) and the tail (the last rank)
  if (warp == 0 && rank == 0) {
    const int n = lane < HDR_SLOTS ? h.pre_nb[lane] : 0;
    const int incl = warp_incl_sum(n, lane);
    if (n > 0) sink.put(incl - n, static_cast<unsigned>(h.pre_pay[lane]), n);
  }
  if (tid == 0 && rank == P - 1) {
    if (h.tail_nb > 0)
      sink.put(h.tail_off, static_cast<unsigned>(h.tail_pay), h.tail_nb);
    sink.put(h.tail_off + h.tail_nb, 1u, 1);
  }
  // the MBs' events, chunk by chunk through the ring: the last warp
  // refills a stage once every other warp has released it (``empty``),
  // the others place the chunk's (MB, step) tasks, no block barrier
  // between chunks
  if (warp == nw - 1) {
    if (lane == 0) {
      for (int k = 2; k < nchunks; k++) {
        const int s = k & 1;
        mbar_wait(&h.empty[s], ((k - 2) >> 1) & 1);
        issue_stage(a, ring + s * a.stage_bytes, &h.bar[s], b.g_lo,
                    k * a.C, min(a.C, b.nm - k * a.C));
      }
    }
  } else {
    for (int k = 0; k < nchunks; k++) {
      const int s = k & 1, m0 = k * a.C, nmc = min(a.C, b.nm - m0);
      const char* stage = ring + s * a.stage_bytes;
      mbar_wait(&h.bar[s], (k >> 1) & 1);
      for (int i = warp; i < nmc * (a.nsteps + 1); i += nw - 1) {
        const int j = m0 + i % nmc;
        if constexpr (SPILL) {
          // an MB wholly inside the row's own words has nothing to spill
          if (h.mb_start[j] + h.mb_bits[j] + h.skip_nb[j] <= a.w_cap * 32)
            continue;
        }
        place_task<SPILL>(a, b, h, sink, step_off, stage, m0, j,
                          i / nmc - 1, lane);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&h.empty[s]);
    }
  }
  if constexpr (!SPILL) {
    cluster_sync();
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
    // a first word whose first bit is another rank's goes to that rank
    if (tid == 0 && (s_bit & 31) && e_bit > s_bit && ws < a.w_cap) {
      int owner = rank - 1;
      while (h.s_bit[owner] > 32 * ws) owner--;
      const unsigned v = sw[0];
      const int i = ws - (h.s_bit[owner] >> 5);
      if (v && i < kWords)
        asm volatile("red.shared::cluster.add.u32 [%0], %1;"
                     :: "r"(map_rank(smem_u32(sw + i), owner)), "r"(v)
                     : "memory");
      else if (v)
        atomicAdd(&gw[ws], v);
    }
    cluster_sync();
    // the owned words in the shared buffer (those past it took atomics)
    store_words(gw, own_lo, min(own_hi, min(ws + kWords, a.w_cap)),
                [=](int i) { return sw[i - ws]; });
    // the words past the row's bits: zeros, a share a rank
    const int z0 = (total + 31) >> 5, zn = (a.w_cap - z0 + P - 1) / P;
    if (zn > 0)
      store_words(gw, z0 + rank * zn, min(a.w_cap, z0 + (rank + 1) * zn),
                  [](int) { return 0u; });
    if (tid == 0 && rank == 0) {
      a.total_bits[r] = total;
      a.byte_lens[r] = h.nev;
    }
  }
}

}  // namespace

// S seats of R rows each: words (S * R, w_cap), total_bits and byte_lens
// (S * R,), data (S, out_cap), flags (S, 2); every per-row input is
// (S * R, ...) with the seats back to back
extern "C" int pack_stream_seats(const int* hdr_pay, const int* hdr_nb,
                                 const int* ev_pay, const uint8_t* ev_nb,
                                 int SB, const int* row_hdr_pay,
                                 const int* row_hdr_nb, const int* row_id,
                                 const int* qp, int intra, int S, int R,
                                 int M, int e_cap, int w_cap, int out_cap,
                                 int* words, int* total_bits, uint8_t* data,
                                 int* byte_lens, int* flags, void* stream) {
  if (S <= 0 || S > 65535 || R <= 0 || M <= 0 || w_cap <= 0 || out_cap < 0
      || SB <= 0 || SB % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(ev_nb) & 3)   // nb is read as u32
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // per device, read once: shared memory a block may opt into, SMs; the
  // row kernels are allowed all of it once (the values are the same in
  // every thread that races to set them)
  static int known[64][2];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!known[dev][0]) {
    int smem = 0, count = 0;
    cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(pack_rows_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaFuncSetAttribute(pack_rows_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    known[dev][1] = count;
    known[dev][0] = smem;
  }
  const int smem_max = known[dev][0], sms = known[dev][1];
  // blocks a row: enough that each block's resident nb fits kNbMax (at
  // most kMaxRank), more while every block still fits one wave at two
  // blocks an SM (3 for a 1080p frame, 8 for a band of a few rows)
  const long long rows = static_cast<long long>(S) * R;
  const long long p_fit = (1LL * M * SB + kNbMax - 1) / kNbMax;
  long long p = 2LL * sms / rows;
  p = p > p_fit ? p : p_fit;
  const int P = p < 1 ? 1 : (p > kMaxRank ? kMaxRank : static_cast<int>(p));
  const int Mb = (M + P - 1) / P;
  if (Mb > kMaxMBs || rows * P > 0x7fffffffLL
      || (SB / 4 + 63) / 64 > kSteps)
    return static_cast<int>(cudaErrorInvalidValue);
  PackArgs a{hdr_pay, hdr_nb, ev_pay, ev_nb, row_hdr_pay, row_hdr_nb,
             row_id, qp, SB, intra, R, M, e_cap, w_cap, P, Mb, 0,
             ((SB / 4) + 63) / 64, 1, 0, 0, 0, 0, 0, 0,
             reinterpret_cast<unsigned*>(words), total_bits, byte_lens};
  // the layout, nb resident if a block can hold it (else nb stays in
  // device memory), and the MBs a ring stage, at most 16: as many as
  // keep two blocks an SM, else as many as fit one
  int bytes = 0;
  for (a.nb_res = 1; a.nb_res >= 0; a.nb_res--) {
    a.off_hp = round16(sizeof(Head) + 4LL * Mb * a.nsteps);
    a.off_hn = a.off_hp + round16(4LL * Mb * HDR_SLOTS + 32);
    a.off_nb = a.off_hn + round16(4LL * Mb * HDR_SLOTS + 32);
    a.off_ring = a.off_nb + (a.nb_res ? round16(1LL * Mb * SB + 32) : 0);
    const int budgets[2] = {smem_max / 2 - 1024, smem_max};
    for (int bi = 0; bi < 2 && a.C == 0; bi++) {
      for (int C = 16; C >= 1; C--) {
        const int stage = round16(4LL * C * SB + 32);
        const int total = a.off_ring + 2 * stage + 4 * kWords;
        if (total <= budgets[bi]) {
          a.C = C;
          a.stage_bytes = stage;
          bytes = total;
          break;
        }
      }
    }
    if (a.C) break;
  }
  if (a.C == 0) return static_cast<int>(cudaErrorInvalidValue);
  a.off_words = a.off_ring + 2 * a.stage_bytes;
  // grids (2) and (3) launch behind the one before them (programmatic
  // dependent launch) and wait for it inside
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows * P));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, pack_rows_kernel<false>, a);
  cfg.numAttrs = 2;
  cudaLaunchKernelEx(&cfg, pack_rows_kernel<true>, a);
  launch_stream_bytes<false>(reinterpret_cast<const unsigned*>(words),
                             total_bits, byte_lens, flags, S, R, e_cap,
                             w_cap, out_cap, data, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pack_stream(const int* hdr_pay, const int* hdr_nb,
                           const int* ev_pay, const uint8_t* ev_nb, int SB,
                           const int* row_hdr_pay, const int* row_hdr_nb,
                           const int* row_id, const int* qp, int intra, int R,
                           int M, int e_cap, int w_cap, int out_cap,
                           int* words, int* total_bits, uint8_t* data,
                           int* byte_lens, int* flags, void* stream) {
  return pack_stream_seats(hdr_pay, hdr_nb, ev_pay, ev_nb, SB, row_hdr_pay,
                           row_hdr_nb, row_id, qp, intra, 1, R, M, e_cap,
                           w_cap, out_cap, words, total_bits, data,
                           byte_lens, flags, stream);
}
