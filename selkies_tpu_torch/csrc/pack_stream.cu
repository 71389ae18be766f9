// K4 pack_stream: slice rows of one frame -> u32 words, bit totals, the
// ragged byte buffer, and both overflow flags.
//
// Replaces selkies_tpu/ops/h264_planes.py:_EventSink (the default scatter
// packer), _excl_cumsum0, _assemble_frame, _assemble_p_frame (row prefix
// events, P skip runs, tail events), and selkies_tpu/ops/stripes.py:
// words_to_bytes_device (pad_ones=False) and concat_stripe_bytes.
//
// Bound on the H100: bytes: the ~36 MB event array of K3 is read once; the
// words (6.3 MB at 1080p) and the byte buffer are written once. Design: two
// grids on one stream. (1) One block per MB row: warps sum each MB's slot
// bits; one thread walks the row for the skip runs and the exclusive MB
// offsets (120 steps); then each warp takes an MB and places its slots 32
// at a time, a warp prefix sum giving each slot's offset, every event
// split into hi/lo words where it straddles. Words are combined with
// atomicAdd, not atomicOr: the bit ranges are disjoint, so the two agree,
// and where an overflowing row spills into the next row's words the sum
// is what the reference's scatter-add computes. (2) The byte buffer of
// stripe_bytes.cuh (zero-padded rows; 68 rows at 1080p).
//
// Seats: pack_stream_seats replaces the same functions vmapped over the
// seat axis by selkies_tpu/parallel/h264_seats.py:MultiSeatH264Encoder.
// _build (:98). The rows of S seats lie back to back (S * R blocks, one
// launch a tick); every bound is the seat's own, as under vmap: a row's
// words may spill into the next row's only up to the seat's R * w_cap
// words (seat k's last row never reaches seat k + 1's first), and each
// seat has its own flags pair and (out_cap,) byte buffer. pack_stream is
// the S = 1 case.
#include "h264_common.cuh"
#include "stripe_bytes.cuh"

struct RowCtx {
  int pre_pay[6], pre_nb[6], pre_off[6];
  int tail_pay[2], tail_nb[2], tail_off[2];
  int n_ev;
};

__device__ __forceinline__ void put_event(unsigned* words, long long n_words,
                                          long long goff, unsigned pay,
                                          int nb) {
  if (nb <= 0) return;
  const long long w0 = goff >> 5;
  const int rel = static_cast<int>(goff & 31);
  const int sh = 32 - (rel + nb);
  const unsigned hi = sh >= 0 ? (pay << sh) : (pay >> (-sh));
  if (w0 < n_words) atomicAdd(&words[w0], hi);
  if (sh < 0 && w0 + 1 < n_words) atomicAdd(&words[w0 + 1], pay << (32 + sh));
}

__device__ __forceinline__ void qp_event(int qp, int* p, int* n) {
  const int d = qp - 26;
  ue_event(d > 0 ? 2 * d - 1 : -2 * d, p, n);
}

__global__ void pack_rows_kernel(const int* __restrict__ hdr_pay,
                                 const int* __restrict__ hdr_nb,
                                 const int* __restrict__ ev_pay,
                                 const uint8_t* __restrict__ ev_nb, int SB,
                                 const int* __restrict__ row_hdr_pay,
                                 const int* __restrict__ row_hdr_nb,
                                 const int* __restrict__ row_id,
                                 const int* __restrict__ qp_rows, int intra,
                                 int R, int M, int e_cap, int w_cap,
                                 unsigned* words, int* __restrict__ total_bits,
                                 int* __restrict__ flags) {
  // blockIdx.x runs over every seat's rows; R rows a seat
  const int seat = blockIdx.x / R;
  words += static_cast<long long>(seat) * R * w_cap;
  flags += 2 * seat;
  extern __shared__ int sm[];
  int* mb_bits = sm;              // M
  int* mb_start = sm + M;         // M
  int* skip_pay = sm + 2 * M;     // M
  int* skip_nb = sm + 3 * M;      // M
  __shared__ RowCtx ctx;
  const int r = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int NS = HDR_SLOTS + SB;
  if (threadIdx.x == 0) ctx.n_ev = 0;
  __syncthreads();

  // ---- per-MB slot bits and event counts
  for (int m = warp; m < M; m += nwarps) {
    const size_t g = static_cast<size_t>(r) * M + m;
    int bits = 0, cnt = 0;
    for (int s = lane; s < NS; s += 32) {
      const int n = s < HDR_SLOTS ? hdr_nb[g * HDR_SLOTS + s]
                                  : ev_nb[g * SB + (s - HDR_SLOTS)];
      bits += n;
      cnt += n > 0;
    }
    for (int o = 16; o > 0; o >>= 1) {
      bits += __shfl_down_sync(0xffffffffu, bits, o);
      cnt += __shfl_down_sync(0xffffffffu, cnt, o);
    }
    if (lane == 0) {
      mb_bits[m] = bits;
      atomicAdd(&ctx.n_ev, cnt);
    }
  }
  __syncthreads();

  // ---- row layout: prefix, skip runs, MB offsets, tail (one thread)
  if (threadIdx.x == 0) {
    int p, n, cnt = 0;
    ctx.pre_pay[0] = row_hdr_pay[2 * r]; ctx.pre_nb[0] = row_hdr_nb[2 * r];
    ctx.pre_pay[1] = row_hdr_pay[2 * r + 1];
    ctx.pre_nb[1] = row_hdr_nb[2 * r + 1];
    if (intra) {
      ue_event(row_id[r], &p, &n);
      ctx.pre_pay[2] = p; ctx.pre_nb[2] = n;        // idr_pic_id
      ctx.pre_pay[3] = 0; ctx.pre_nb[3] = 2;        // '00' flags
    } else {
      ctx.pre_pay[2] = row_id[r] & 0xF; ctx.pre_nb[2] = 4;   // frame_num
      ctx.pre_pay[3] = 0; ctx.pre_nb[3] = 3;        // '000' flags
    }
    qp_event(qp_rows[r], &p, &n);
    ctx.pre_pay[4] = p; ctx.pre_nb[4] = n;
    ctx.pre_pay[5] = 2; ctx.pre_nb[5] = 3;          // deblock ue(1)
    int acc = 0;
    for (int k = 0; k < 6; k++) {
      ctx.pre_off[k] = acc;
      acc += ctx.pre_nb[k];
      cnt += ctx.pre_nb[k] > 0;
    }
    int prev = -1;
    for (int m = 0; m < M; m++) {
      int sp = 0, sn = 0;
      if (!intra && hdr_nb[(static_cast<size_t>(r) * M + m) * HDR_SLOTS + 1] > 0) {
        ue_event(m - prev - 1, &sp, &sn);
        prev = m;
      }
      skip_pay[m] = sp;
      skip_nb[m] = sn;
      cnt += sn > 0;
      mb_start[m] = acc;
      acc += mb_bits[m] + sn;
    }
    int tn0 = 0, tp0 = 0;
    if (!intra && M - 1 - prev > 0) ue_event(M - 1 - prev, &tp0, &tn0);
    ctx.tail_pay[0] = tp0; ctx.tail_nb[0] = tn0; ctx.tail_off[0] = acc;
    ctx.tail_pay[1] = 1; ctx.tail_nb[1] = 1; ctx.tail_off[1] = acc + tn0;
    cnt += (tn0 > 0) + 1;
    const int total = acc + tn0 + 1;
    total_bits[r] = total;
    if (ctx.n_ev + cnt > e_cap || total > w_cap * 32) atomicOr(&flags[0], 1);
  }
  __syncthreads();

  // ---- place the events (offsets inside the seat's words)
  const long long row_base = static_cast<long long>(r - seat * R) * w_cap * 32;
  const long long n_words = static_cast<long long>(R) * w_cap;
  if (threadIdx.x < 6)
    put_event(words, n_words, row_base + ctx.pre_off[threadIdx.x],
              static_cast<unsigned>(ctx.pre_pay[threadIdx.x]),
              ctx.pre_nb[threadIdx.x]);
  else if (threadIdx.x < 8)
    put_event(words, n_words, row_base + ctx.tail_off[threadIdx.x - 6],
              static_cast<unsigned>(ctx.tail_pay[threadIdx.x - 6]),
              ctx.tail_nb[threadIdx.x - 6]);
  for (int m = warp; m < M; m += nwarps) {
    const size_t g = static_cast<size_t>(r) * M + m;
    long long run = row_base + mb_start[m];
    for (int base = 0; base < NS; base += 32) {
      const int s = base + lane;
      int p = 0, n = 0;
      if (s == 0 && !intra) {
        p = skip_pay[m]; n = skip_nb[m];
      } else if (s < HDR_SLOTS) {
        p = hdr_pay[g * HDR_SLOTS + s]; n = hdr_nb[g * HDR_SLOTS + s];
      } else if (s < NS) {
        p = ev_pay[g * SB + (s - HDR_SLOTS)];
        n = ev_nb[g * SB + (s - HDR_SLOTS)];
      }
      int incl = n;
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      put_event(words, n_words, run + incl - n, static_cast<unsigned>(p), n);
      run += __shfl_sync(0xffffffffu, incl, 31);
    }
  }
}

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
  if (S <= 0 || S > 65535 || R <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(words, 0,
                  sizeof(int) * static_cast<size_t>(S) * R * w_cap, s);
  cudaMemsetAsync(flags, 0, 2 * sizeof(int) * static_cast<size_t>(S), s);
  pack_rows_kernel<<<S * R, 256, 4 * M * sizeof(int), s>>>(
      hdr_pay, hdr_nb, ev_pay, ev_nb, SB, row_hdr_pay, row_hdr_nb, row_id, qp,
      intra, R, M, e_cap, w_cap, reinterpret_cast<unsigned*>(words),
      total_bits, flags);
  launch_concat_bytes<false>(reinterpret_cast<const unsigned*>(words),
                             total_bits, S, R, w_cap, out_cap, data,
                             byte_lens, flags, s);
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
