// K5 motion_select: full-pel scroll motion search of the P path. For every
// macroblock and every candidate (dy, dx) of a static set: SAD of the 16x16
// luma MB against the edge-clamped shifted reference plus
// MV_LAMBDA[clip(qp_row, 0, 51)] * (se_bits(4dx) + se_bits(4dy)); the
// argmin (first index on ties); then the luma prediction, the chroma
// prediction (the eighth-sample bilinear of a half-pel chroma vector: a 2-
// or 4-tap rounding average) and the (mvx, mvy) quarter-pel field.
//
// Replaces selkies_tpu/ops/h264_encode.py:_motion_select with _vshift,
// _hshift, _shift_chroma and _sad_mb16 (the 57 shifted planes and the
// where-cascades there), as called from ops/h264_planes.py:h264_encode_p_yuv.
//
// Vertical shifts clamp inside the MB's window of ``win`` rows (the stripe:
// each stripe is its own picture to the decoder), horizontal ones at the
// picture width; the clamps are separable, so a staged tile row t holds
// window row clip(y_local + t - V) and column u holds clip(x + u - Hm), and
// candidate (dy, dx) of MB pixel (i, j) is tile[i + dy + V][j + dx + Hm].
//
// Bound on the H100: operations (57 candidates x 256 x 3 integer ops per
// MB, ~360 M at 1080p, counted as chip_smoke counts them) against bytes
// (the luma and chroma planes in, the prediction planes out, ~9 MB).
// What bounds it in fact is the SAD loop's shared-memory reads
// (motion_probe.py on the H100: the one-thread-a-candidate loop 20.6K
// cycles a block of 16 MBs with its loads, 5.9K without; vabsdiff4, one
// VABSDIFF4.U8.ACC on sm_90a, issues at the integer rate, ~60 lanes a
// clock an SM).
//
// What held the first design back, one block of 256 threads an MB:
// the tile was staged one byte a thread behind a runtime division and
// modulo, and each MB reloaded the bytes its neighbours had loaded; each
// candidate's SAD was one warp taking one byte-wide |a - b| per pixel and
// a 5-step shuffle reduction, 57 rounds an MB, the last round on one of
// eight warps; warp 0 scanned the costs alone; the prediction went out in
// 1-byte stores and 4:2:0 chroma read its taps byte by byte.
//
// Design now (one kernel body, four entries), a block of 256 threads:
// - The block takes up to 5 x 4 MBs: up to 5 MB rows of one segment (a
//   window, and for K19 a shard: gcd of the two in MB rows, cut into
//   row groups that differ by at most a row) and up to 4 MB columns. It
//   stages the current MBs and ONE reference tile for all of them, the
//   rows 16 nr + 2 V (+ 3) with the window clamp built in: 16-byte loads,
//   four a thread in flight at once, scattered into 32-bit words (a chunk
//   past a picture edge is the edge chunk with its edge byte repeated).
//   The tile starts 16-byte aligned; its row stride is an odd number of
//   words and its rows lie in four phases (tile_q), so lanes reading rows
//   one apart, or four apart, hit distinct banks.
// - A thread takes one MB and one run of up to 4 candidates with one dx
//   and consecutive dy (the host cuts them from the candidates sorted by
//   dx, dy): it reads and funnel-shifts each tile row once for the run,
//   the four windows sliding down a row a step (a quarter of the shared
//   reads of one thread a candidate), and sums with vabsdiff4's
//   accumulate form. The runs of two or more come first, MB by MB, so a
//   warp mostly takes one kind. Where one thread a run leaves the card
//   short of threads (a band of a few rows) the runs are single
//   candidates and 2 or 4 threads take one, a part of its rows each,
//   their sums met by shuffles.
// - Each candidate's cost lands in shared memory as one key, cost * 128 +
//   index, so the least key is the least cost and, on a tie, the lowest
//   index; a warp an MB takes the minimum of its keys with
//   __reduce_min_sync.
// - The luma prediction leaves the tile as 16-byte stores; the 4:4:4
//   chroma as 16-byte stores from 32-bit loads (funnel-shifted; the clamp
//   only at the picture's left and right MBs); the 4:2:0 chroma as 8-byte
//   stores, a thread a chroma row, its taps as three 32-bit loads a
//   source row and its 2- and 4-tap rounding averages on four byte
//   lanes at once.
// - Launch policy: 5 x 4 MBs, MB columns then rows halved while the grid
//   has fewer than two blocks an SM (or a block's shared memory passes
//   48 KB); one thread a run, or 2 / 4 threads a candidate while the
//   shape's pairs stay under 512 threads an SM. A 1080p frame of 64-row
//   windows runs 510 blocks of 4 x 4 MBs, its 4 shards of 17 rows (K19)
//   480 blocks of 4-5 x 4, a 4-row band 480 blocks of one MB.
// Tried and measured slower or no faster (chip_smoke and instrumented
// copies, on the H100): asynchronous 4-byte copies (cp.async) for the
// tile, whose issue alone took ~24K cycles a block at 1080p; blocks of 4
// MBs in a row (a tile of 64 rows for 16: four times the loads); one
// thread a candidate at 1080p (0.027 ms against 0.021 for the runs);
// four accumulators a candidate in place of one (no change); 4 x 2 MBs
// a block, or 42 registers a thread (six blocks an SM), at 1080p (within
// 4%).
// The prediction goes to its own planes, never into the reference planes,
// so the P coder (K2), which rewrites the reference in place, reads a
// prediction that no recon write can have touched.
//
// motion_select444 (the FULL template argument) is the 4:4:4 variant of
// selkies_tpu/ops/h264_planes444.py:_motion_select444: the same search,
// but the chroma planes are full resolution and ride the luma's full-pel
// shift with the luma's window and width clamps (256 pixels a component,
// one tap each).
//
// K19 motion_select_halo / motion_select_halo444 (the HALO template
// argument) replace selkies_tpu/parallel/stripes.py:_motion_select_halo,
// the search of a split frame whose motion windows span shards: the
// frame's MB rows are n shards of ``rows`` MB rows, and the reference
// planes come as the shards' halo bands (K20, csrc/halo_bands.cu), band s
// holding frame rows row0 - halo .. row0 + 16 * rows + halo - 1 (row0 =
// 16 * rows * s). The window clamp is the same function of the GLOBAL row
// (gy = 16 * blockIdx.y, wbase = gy - gy % win), so a clamped source row
// ry is read at band row ry - (row0 - halo) of band s, which is row
// ry + (2 s + 1) * halo of the stacked bands: luma at the luma halo, and
// chroma at the chroma halo (4:2:0 on chroma rows, whose windows are
// win / 2 rows). Everything else is K5's code; with HALO false the offsets
// are the constant 0. Bound and design as K5's: the bands are read in
// place of the planes.
#include "h264_common.cuh"

#define MAX_CANDIDATES 128
#define MAX_SHIFT 64      // |dy|, |dx| at most (ops/h264_encode.py)

constexpr int MS_THREADS = 256;   // a block
constexpr int MS_MAX_COLS = 4;    // MB columns a block, at most
constexpr int MS_MAX_ROWS = 5;    // MB rows a block, at most
constexpr int MS_MAX_MBS = MS_MAX_COLS * MS_MAX_ROWS;
constexpr int MS_BATCH = 4;       // 16-byte loads a thread keeps in flight
constexpr size_t MS_SMEM_MAX = 48 * 1024;   // dynamic shared memory a block

constexpr int MS_RUN = 4;         // candidates a run, at most

// candidate k as (dy & 0xff) | (dx & 0xff) << 8 | mv bits << 16, the bits
// se_bits(4 dx) + se_bits(4 dy). The candidates also come as ``nrun``
// runs of 1 to MS_RUN that share dx at consecutive dy: run r as
// (dy0 & 0xff) | (dx & 0xff) << 8 | length << 16, its candidates'
// indices 7 bits each in ridx[r]; the ``nmulti`` runs of two or more
// first
struct Candidates {
  int n, vmax, hmax, nrun, nmulti;
  unsigned packed[MAX_CANDIDATES];
  unsigned run[MAX_CANDIDATES];
  unsigned ridx[MAX_CANDIDATES];
};

// K19's shard geometry: MB rows a shard, luma and chroma halo rows
struct Halo {
  int rows, y, c;
};

// floor(v / 2) and v mod 2 as Python's >> and & give them
__device__ __forceinline__ int floor_half(int v) { return (v - (v & 1)) / 2; }

// acc + the sum of |a - b| over the four byte lanes
__device__ __forceinline__ unsigned sad4(unsigned a, unsigned b,
                                         unsigned acc) {
  unsigned r;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
      : "=r"(r) : "r"(a), "r"(b), "r"(acc));
  return r;
}

// the tile's geometry: it starts ``e`` = (-hmax) & 15 bytes before the
// first MB's column minus hmax, at a 16-byte boundary, and holds
// ``chunks`` 16-byte chunks a row: every byte a candidate reads and the
// word past them; its row stride in words is 4 * chunks + 1 (odd)
__host__ __device__ __forceinline__ int tile_chunks(int nmb, int hmax) {
  return (((-hmax) & 15) + 16 * nmb + 2 * hmax + 4 + 15) >> 4;
}

// rounding averages of four byte lanes: (a + b + 1) >> 1 and
// (a + b + c + d + 2) >> 2, lane by lane
__device__ __forceinline__ unsigned avg2(unsigned a, unsigned b) {
  return (a | b) - ((a ^ b) >> 1 & 0x7f7f7f7fu);
}
__device__ __forceinline__ unsigned avg4(unsigned a, unsigned b, unsigned c,
                                         unsigned d) {
  const unsigned m = 0x00ff00ffu;
  const unsigned lo = (a & m) + (b & m) + (c & m) + (d & m) + 0x00020002u;
  const unsigned hi = (a >> 8 & m) + (b >> 8 & m) + (c >> 8 & m)
                      + (d >> 8 & m) + 0x00020002u;
  return (lo >> 2 & m) | (hi >> 2 & m) << 8;
}

// bytes c .. c + 3 of a picture row ``p`` of W bytes (W % 4 == 0, p 4-byte
// aligned), each column clamped to 0 .. W - 1
__device__ __forceinline__ unsigned row_word(const uint8_t* __restrict__ p,
                                             int c, int W) {
  if (c >= 0 && c + 3 <= W - 1) {
    const unsigned* w = reinterpret_cast<const unsigned*>(p + (c & ~3));
    const unsigned lo = __ldg(w);
    return (c & 3) ? __funnelshift_r(lo, __ldg(w + 1), 8 * (c & 3)) : lo;
  }
  unsigned v = 0;
#pragma unroll
  for (int b = 0; b < 4; b++)
    v |= static_cast<unsigned>(__ldg(p + clampi(c + b, 0, W - 1))) << (8 * b);
  return v;
}

// 16 bytes of a word array from word ``w``, shifted right ``sh`` bits
// (the word past them readable)
__device__ __forceinline__ uint4 words16(const unsigned* __restrict__ w,
                                         int sh) {
  return make_uint4(__funnelshift_r(w[0], w[1], sh),
                    __funnelshift_r(w[1], w[2], sh),
                    __funnelshift_r(w[2], w[3], sh),
                    __funnelshift_r(w[3], w[4], sh));
}

// the tile's rows in shared memory, four phases: row t at slot
// (t & 3) * Q + (t >> 2), Q = ceil(rows / 4) raised to 8 mod 16, so that
// rows one apart (the vertical candidates side by side) and rows four
// apart (the runs side by side) all land on distinct banks; the rows
// are the MB rows' 16 nr, 2 vmax and three more, which a short run's
// windows read and ignore
__host__ __device__ __forceinline__ int tile_q(int nr, int vmax) {
  const int q = (16 * nr + 2 * vmax + MS_RUN - 1 + 3) / 4;
  return q + ((24 - q % 16) % 16);
}

__device__ __forceinline__ int tile_slot(int t, int Q) {
  return (t & 3) * Q + (t >> 2);
}

// dynamic shared memory of a block of nmr x nmb MBs: the current MBs,
// the keys, the candidates and runs, the rows' lambdas and choices, and
// the tile
__host__ __device__ __forceinline__ size_t motion_smem(int nmr, int nmb,
                                                      int vmax, int hmax) {
  return sizeof(uint4) * 16 * nmr * nmb
         + sizeof(unsigned) * (nmr * nmb * MAX_CANDIDATES
                               + 3 * MAX_CANDIDATES + 2 * MS_MAX_MBS)
         + sizeof(unsigned) * 4 * tile_q(nmr, vmax)
               * (4 * tile_chunks(nmb, hmax) + 1);
}

// the SADs of one MB (16 rows from cur row ``cp``, stride ``cs`` 16-byte
// rows) against MS_RUN tile windows one row apart (the run's candidates
// dy0 .. dy0 + 3; ``tq`` the tile at the first one's column word, ``r0``
// its first row, ``sh`` its byte shift in bits): each tile row is loaded
// and shifted once for the run, the windows slide down one row a step
__device__ __forceinline__ void sad_run(const uint4* cp, int cs,
                                        const unsigned* tq, int r0, int Q,
                                        int TWW, int sh,
                                        unsigned (&acc)[MS_RUN]) {
  const unsigned* p[4];          // rows r0 + m + 4 k at p[m] + k * TWW
#pragma unroll
  for (int m = 0; m < 4; m++) p[m] = tq + tile_slot(r0 + m, Q) * TWW;
  uint4 t[MS_RUN];
#pragma unroll
  for (int s = 0; s < 16 + MS_RUN - 1; s++) {
    t[s % MS_RUN] = words16(p[s & 3] + (s >> 2) * TWW, sh);
    if (s < MS_RUN - 1) continue;
    const int i = s - (MS_RUN - 1);
    const uint4 a = cp[i * cs];
#pragma unroll
    for (int k = 0; k < MS_RUN; k++) {
      const uint4 w = t[(i + k) % MS_RUN];
      acc[k] = sad4(a.x, w.x, acc[k]);
      acc[k] = sad4(a.y, w.y, acc[k]);
      acc[k] = sad4(a.z, w.z, acc[k]);
      acc[k] = sad4(a.w, w.w, acc[k]);
    }
  }
}

// the SAD of one candidate over ROWS rows (a run of one)
template <int ROWS>
__device__ __forceinline__ unsigned sad_one(const uint4* cp, int cs,
                                            const unsigned* tq, int r0,
                                            int Q, int TWW, int sh) {
  const unsigned* p[4];
#pragma unroll
  for (int m = 0; m < 4; m++) p[m] = tq + tile_slot(r0 + m, Q) * TWW;
  unsigned acc = 0;
#pragma unroll
  for (int i = 0; i < ROWS; i++) {
    const uint4 a = cp[i * cs];
    const uint4 w = words16(p[i & 3] + (i >> 2) * TWW, sh);
    acc = sad4(a.x, w.x, acc);
    acc = sad4(a.y, w.y, acc);
    acc = sad4(a.z, w.z, acc);
    acc = sad4(a.w, w.w, acc);
  }
  return acc;
}

template <bool FULL, bool HALO>
__global__ void __launch_bounds__(MS_THREADS, 4) motion_select_kernel(
    const uint8_t* __restrict__ cur_y, const uint8_t* __restrict__ ref_y,
    const uint8_t* __restrict__ ref_u, const uint8_t* __restrict__ ref_v,
    const int* __restrict__ qp_rows, const Candidates c, int W, int win,
    const Halo h, int lseg, int nmr, int nmb, int rsl,
    uint8_t* __restrict__ pred_y, uint8_t* __restrict__ pred_u,
    uint8_t* __restrict__ pred_v, int* __restrict__ mv) {
  // the block's MBs: rows r0 .. r0 + nr - 1 of one segment of ``lseg`` MB
  // rows (inside one window and one shard; its gps row groups differ by
  // at most one row, none over nmr), columns m0 .. m0 + nm - 1; MB b =
  // rb * nm + j
  extern __shared__ uint4 sm4[];
  const int gps = (lseg + nmr - 1) / nmr;      // row groups a segment
  const int seg = blockIdx.y / gps, grp = blockIdx.y - seg * gps;
  const int r0 = seg * lseg + grp * lseg / gps;
  const int nr = seg * lseg + (grp + 1) * lseg / gps - r0;
  const int nm = min(nmb, W / 16 - static_cast<int>(blockIdx.x) * nmb);
  const int nb = nr * nm;
  uint4* cur4 = sm4;                              // 16 nmr rows x nm
  unsigned* key = reinterpret_cast<unsigned*>(cur4 + 16 * nmr * nmb);
  unsigned* cand = key + nmr * nmb * MAX_CANDIDATES;      // n
  unsigned* run_s = cand + MAX_CANDIDATES;                // nrun
  unsigned* ridx_s = run_s + MAX_CANDIDATES;              // nrun
  int* sel_s = reinterpret_cast<int*>(ridx_s + MAX_CANDIDATES);
  int* lam_s = sel_s + MS_MAX_MBS;
  unsigned* tile = reinterpret_cast<unsigned*>(lam_s + MS_MAX_MBS);
  const int V = c.vmax, Hm = c.hmax, n = c.n;
  const int TH = 16 * nr + 2 * V + MS_RUN - 1, CPR = tile_chunks(nmb, Hm);
  const int TWW = 4 * CPR + 1, Q = tile_q(nr, V);
  const int M = W / 16, m0 = blockIdx.x * nmb;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int y0 = 16 * r0, yl = y0 % win, wbase = y0 - yl;
  // K19: frame row ry of the reference is row ry + off of the stacked
  // halo bands (0 for K5, which reads the planes)
  int off_y = 0, off_c = 0;
  if constexpr (HALO) {
    const int s2 = 2 * (r0 / h.rows) + 1;
    off_y = s2 * h.y;
    off_c = s2 * h.c;
  }
  const int e = (-Hm) & 15, cx = 16 * m0 - Hm - e;   // tile column 0

  // the current MBs' rows and the tile's chunks: 16-byte loads, MS_BATCH
  // a thread in flight at once, then each tile chunk scattered into its
  // four words (a chunk left of column 0 / right of W - 1 is the row's
  // first / last chunk, its first / last byte repeated: the clamp); the
  // rows' lambdas and the candidates are set while the first loads fly
  const int qp = tid < nr ? __ldg(qp_rows + r0 + tid) : 0;
  const int ncur = 16 * nr * nm, ntot = ncur + TH * CPR;
  for (int b0 = 0; b0 < ntot; b0 += MS_BATCH * MS_THREADS) {
    uint4 v[MS_BATCH];
    int dst[MS_BATCH];
#pragma unroll
    for (int u = 0; u < MS_BATCH; u++) {
      const int i = b0 + u * MS_THREADS + tid;
      dst[u] = -1;
      if (i < ncur) {
        const int row = i / nm, j = i - row * nm;
        v[u] = __ldg(reinterpret_cast<const uint4*>(
            cur_y + static_cast<size_t>(y0 + row) * W + 16 * (m0 + j)));
        dst[u] = 0;
      } else if (i < ntot) {
        const int t = (i - ncur) / CPR, ch = i - ncur - t * CPR;
        const int ry = wbase + clampi(yl + t - V, 0, win - 1) + off_y;
        const int cc = cx + 16 * ch;
        v[u] = __ldg(reinterpret_cast<const uint4*>(
            ref_y + static_cast<size_t>(ry) * W + clampi(cc, 0, W - 16)));
        dst[u] = 1 + (cc < 0 ? 1 : 0) + (cc > W - 16 ? 2 : 0);
      }
    }
    if (b0 == 0) {
      if (tid < nr) lam_s[tid] = K_MV_LAMBDA[clampi(qp, 0, 51)];
      for (int k = tid; k < n; k += MS_THREADS) cand[k] = c.packed[k];
      for (int k = tid; k < c.nrun; k += MS_THREADS) {
        run_s[k] = c.run[k];
        ridx_s[k] = c.ridx[k];
      }
    }
#pragma unroll
    for (int u = 0; u < MS_BATCH; u++) {
      const int i = b0 + u * MS_THREADS + tid;
      if (dst[u] == 0) {
        cur4[i] = v[u];
      } else if (dst[u] > 0) {
        const int t = (i - ncur) / CPR, ch = i - ncur - t * CPR;
        unsigned* d = tile + tile_slot(t, Q) * TWW + 4 * ch;
        if (dst[u] > 1) {
          const unsigned x = dst[u] == 2 ? __byte_perm(v[u].x, 0, 0x0000)
                                         : __byte_perm(v[u].w, 0, 0x3333);
          v[u] = make_uint4(x, x, x, x);
        }
        d[0] = v[u].x;
        d[1] = v[u].y;
        d[2] = v[u].z;
        d[3] = v[u].w;
      }
    }
  }
  __syncthreads();

  // SADs: item = pair * rs + part; the pairs (b, run) of the runs of two
  // or more, b by b, then those of the single candidates, so that a warp
  // mostly takes one kind; part p takes rows p * rows .. (p + 1) * rows
  // - 1, and the parts' sums meet by shuffles (every lane runs every
  // round)
  const int nmulti = c.nmulti, nsingle = c.nrun - nmulti;
  const int rs = 1 << rsl, items = (nb * c.nrun) << rsl, rows = 16 >> rsl;
  for (int base = 0; base < items; base += MS_THREADS) {
    const int it = min(base + tid, items - 1);
    const int p = it & (rs - 1), pair = it >> rsl;
    int b, rn;
    if (pair < nb * nmulti) {
      b = pair / nmulti;
      rn = pair - b * nmulti;
    } else {
      b = (pair - nb * nmulti) / nsingle;
      rn = nmulti + (pair - nb * nmulti - b * nsingle);
    }
    const int rb = b / nm, j = b - rb * nm;
    const unsigned rw = run_s[rn], ri = ridx_s[rn];
    const int dy0 = static_cast<int>(rw << 24) >> 24;
    const int dx = static_cast<int>(rw << 16) >> 24;
    const int len = static_cast<int>(rw >> 16);
    const int col = 16 * j + dx + Hm + e, sh = 8 * (col & 3);
    const int i0 = 16 * rb + p * rows;
    const unsigned* tq = tile + (col >> 2);
    const int t0 = i0 + dy0 + V;
    const uint4* cp = cur4 + i0 * nm + j;
    unsigned acc[MS_RUN] = {0u, 0u, 0u, 0u};
    if (__all_sync(0xffffffffu, len == 1)) {
      acc[0] = rsl == 0 ? sad_one<16>(cp, nm, tq, t0, Q, TWW, sh)
               : rsl == 1 ? sad_one<8>(cp, nm, tq, t0, Q, TWW, sh)
                          : sad_one<4>(cp, nm, tq, t0, Q, TWW, sh);
      if (rs > 1) acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], 1);
      if (rs > 2) acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], 2);
    } else {
      sad_run(cp, nm, tq, t0, Q, TWW, sh, acc);   // runs come at rsl 0
    }
    if (p == 0 && base + tid < items) {
#pragma unroll
      for (int k = 0; k < MS_RUN; k++) {
        if (k >= len) break;
        const unsigned ck = ri >> (7 * k) & 127u;
        key[b * MAX_CANDIDATES + ck] =
            (acc[k] + static_cast<unsigned>(lam_s[rb]) * (cand[ck] >> 16))
                << 7
            | ck;
      }
    }
  }
  __syncthreads();

  // argmin: the least key of each MB (a warp an MB)
  for (int b = warp; b < nb; b += MS_THREADS / 32) {
    unsigned best = 0xffffffffu;
    for (int k = lane; k < n; k += 32)
      best = min(best, key[b * MAX_CANDIDATES + k]);
    best = __reduce_min_sync(0xffffffffu, best);
    if (lane == 0) sel_s[b] = static_cast<int>(best & 127u);
  }
  __syncthreads();

  // the predictions: luma rows (16 an MB), then chroma rows (4:2:0 2 x 8
  // an MB, 4:4:4 2 x 16), a thread a row
  constexpr int CR = FULL ? 32 : 16;
  const int n_luma = nb * 16, n_chroma = nb * CR;
  for (int i = tid; i < n_luma + n_chroma; i += MS_THREADS) {
    const int b = i < n_luma ? i >> 4 : (i - n_luma) / CR;
    const int rb = b / nm, j = b - rb * nm;
    const unsigned cd = cand[sel_s[b]];
    const int dy = static_cast<int>(cd << 24) >> 24;
    const int dx = static_cast<int>(cd << 16) >> 24;
    const int ylb = yl + 16 * rb;              // the MB row in its window
    if (i < n_luma) {
      const int row = i & 15;
      const int col = 16 * j + dx + Hm + e;
      const uint4 v = words16(tile + tile_slot(16 * rb + row + dy + V, Q)
                                         * TWW + (col >> 2), 8 * (col & 3));
      *reinterpret_cast<uint4*>(pred_y + static_cast<size_t>(
          y0 + 16 * rb + row) * W + 16 * (m0 + j)) = v;
      continue;
    }
    const int ci = i - n_luma;
    if constexpr (FULL) {
      const int comp = (ci >> 4) & 1, row = ci & 15;
      const uint8_t* src = comp ? ref_v : ref_u;
      const int ry = wbase + clampi(ylb + row + dy, 0, win - 1) + off_c;
      const uint8_t* srow = src + static_cast<size_t>(ry) * W;
      const int x = 16 * (m0 + j) + dx;
      uint4 v;
      if (x >= 0 && x + 15 <= W - 1) {
        const unsigned* w = reinterpret_cast<const unsigned*>(srow + (x & ~3));
        const int s8 = 8 * (x & 3);
        const unsigned w0 = __ldg(w), w1 = __ldg(w + 1), w2 = __ldg(w + 2),
                       w3 = __ldg(w + 3), w4 = s8 ? __ldg(w + 4) : 0u;
        v = make_uint4(__funnelshift_r(w0, w1, s8),
                       __funnelshift_r(w1, w2, s8),
                       __funnelshift_r(w2, w3, s8),
                       __funnelshift_r(w3, w4, s8));
      } else {
        v = make_uint4(row_word(srow, x, W), row_word(srow, x + 4, W),
                       row_word(srow, x + 8, W), row_word(srow, x + 12, W));
      }
      *reinterpret_cast<uint4*>((comp ? pred_v : pred_u)
                                + static_cast<size_t>(y0 + 16 * rb + row) * W
                                + 16 * (m0 + j)) = v;
    } else {
      // the eight output bytes from the source row(s) r0 (and r1) at
      // columns x .. x + 8 (clamped): a[.][0..1] the bytes x .. x + 7,
      // a[.][2..3] the bytes x + 1 .. x + 8
      const int comp = (ci >> 3) & 1, row = ci & 7;
      const int W2 = W / 2, cwin = win / 2, cyl = ylb / 2, cbase = wbase / 2;
      const int by = floor_half(dy), fy = dy & 1, bx = floor_half(dx),
                fx = dx & 1;
      const uint8_t* src = comp ? ref_v : ref_u;
      const int x = 8 * (m0 + j) + bx;
      unsigned a[2][4];
#pragma unroll
      for (int rr = 0; rr < 2; rr++) {
        if (rr == 1 && !fy) {
          a[1][0] = a[1][1] = a[1][2] = a[1][3] = 0u;
          continue;
        }
        const uint8_t* sr = src + static_cast<size_t>(
            cbase + clampi(cyl + row + by + rr, 0, cwin - 1) + off_c) * W2;
        unsigned* o = a[rr];
        if (x >= 0 && (x & ~3) + 12 <= W2) {
          const unsigned* w = reinterpret_cast<const unsigned*>(sr + (x & ~3));
          const unsigned w0 = __ldg(w), w1 = __ldg(w + 1), w2 = __ldg(w + 2);
          const int s8 = 8 * (x & 3);
          o[0] = __funnelshift_r(w0, w1, s8);
          o[1] = __funnelshift_r(w1, w2, s8);
          o[2] = __funnelshift_rc(w0, w1, s8 + 8);   // a shift of 32: w1
          o[3] = __funnelshift_rc(w1, w2, s8 + 8);
        } else {
          o[0] = row_word(sr, x, W2);
          o[1] = row_word(sr, x + 4, W2);
          o[2] = row_word(sr, x + 1, W2);
          o[3] = row_word(sr, x + 5, W2);
        }
      }
      unsigned lo, hi;
      if (!fy && !fx) {
        lo = a[0][0];
        hi = a[0][1];
      } else if (fy && !fx) {
        lo = avg2(a[0][0], a[1][0]);
        hi = avg2(a[0][1], a[1][1]);
      } else if (fx && !fy) {
        lo = avg2(a[0][0], a[0][2]);
        hi = avg2(a[0][1], a[0][3]);
      } else {
        lo = avg4(a[0][0], a[1][0], a[0][2], a[1][2]);
        hi = avg4(a[0][1], a[1][1], a[0][3], a[1][3]);
      }
      *reinterpret_cast<uint2*>((comp ? pred_v : pred_u)
                                + static_cast<size_t>(y0 / 2 + 8 * rb + row)
                                      * W2
                                + 8 * (m0 + j)) = make_uint2(lo, hi);
    }
  }
  if (tid < nb) {
    const int rb = tid / nm, j = tid - rb * nm;
    const unsigned cd = cand[sel_s[tid]];
    const size_t g = static_cast<size_t>(r0 + rb) * M + m0 + j;
    *reinterpret_cast<int2*>(mv + 2 * g) = make_int2(
        4 * (static_cast<int>(cd << 16) >> 24),
        4 * (static_cast<int>(cd << 24) >> 24));
  }
}

// the bit cost of se(v)
static int se_bits_host(int v) {
  unsigned cn = v > 0 ? 2u * v - 1u : static_cast<unsigned>(-2 * v);
  int len = 0;
  for (cn += 1u; cn; cn >>= 1) len++;
  return 2 * len - 1;
}

// cand: host (n, 2) int32 (dy, dx) table, read here before the launch and
// passed to the kernel by value.
template <bool FULL, bool HALO>
static int launch_motion(const uint8_t* cur_y, const uint8_t* ref_y,
                         const uint8_t* ref_u, const uint8_t* ref_v,
                         const int* qp_rows, const int* cand, int n, int H,
                         int W, int win, Halo h, uint8_t* pred_y,
                         uint8_t* pred_u, uint8_t* pred_v, int* mv,
                         void* stream) {
  if (n < 1 || n > MAX_CANDIDATES || H <= 0 || W <= 0 || H % 16 || W % 16
      || win <= 0 || win % 16 || H % win || h.rows <= 0 || (H / 16) % h.rows)
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte current-MB and luma reference loads and prediction stores,
  // 32-bit chroma reference loads, 8-byte vector stores
  const uintptr_t a16 = reinterpret_cast<uintptr_t>(cur_y)
                        | reinterpret_cast<uintptr_t>(ref_y)
                        | reinterpret_cast<uintptr_t>(pred_y)
                        | reinterpret_cast<uintptr_t>(pred_u)
                        | reinterpret_cast<uintptr_t>(pred_v);
  const uintptr_t a4 = reinterpret_cast<uintptr_t>(ref_u)
                       | reinterpret_cast<uintptr_t>(ref_v);
  if ((a16 & 15) || (a4 & 3) || (reinterpret_cast<uintptr_t>(mv) & 7))
    return static_cast<int>(cudaErrorMisalignedAddress);
  Candidates c;
  c.n = n;
  c.vmax = 0;
  c.hmax = 0;
  for (int k = 0; k < n; k++) {
    const int dy = cand[2 * k], dx = cand[2 * k + 1];
    const int ay = dy < 0 ? -dy : dy, ax = dx < 0 ? -dx : dx;
    if (ay > MAX_SHIFT || ax > MAX_SHIFT)
      return static_cast<int>(cudaErrorInvalidValue);
    c.packed[k] = (static_cast<unsigned>(dy) & 0xffu)
                  | (static_cast<unsigned>(dx) & 0xffu) << 8
                  | static_cast<unsigned>(se_bits_host(4 * dx)
                                          + se_bits_host(4 * dy)) << 16;
    if (ay > c.vmax) c.vmax = ay;
    if (ax > c.hmax) c.hmax = ax;
  }
  for (int k = n; k < MAX_CANDIDATES; k++) c.packed[k] = 0;
  // the runs: the candidates in (dx, dy) order, cut where dx changes, dy
  // skips or a run is full; the runs of two or more first, so that the
  // single candidates share warps
  int order[MAX_CANDIDATES];
  for (int k = 0; k < n; k++) {
    int at = k;
    while (at > 0) {
      const int o = order[at - 1];
      const int odx = cand[2 * o + 1], ody = cand[2 * o];
      const int dx = cand[2 * k + 1], dy = cand[2 * k];
      if (odx < dx || (odx == dx && ody <= dy)) break;
      order[at] = o;
      at--;
    }
    order[at] = k;
  }
  unsigned runs[MAX_CANDIDATES], idx[MAX_CANDIDATES];
  int nrun = 0;
  for (int a = 0; a < n;) {
    int len = 1;
    while (a + len < n && len < MS_RUN
           && cand[2 * order[a + len] + 1] == cand[2 * order[a] + 1]
           && cand[2 * order[a + len]] == cand[2 * order[a]] + len)
      len++;
    unsigned ix = 0;
    for (int q = 0; q < len; q++)
      ix |= static_cast<unsigned>(order[a + q]) << (7 * q);
    runs[nrun] = (static_cast<unsigned>(cand[2 * order[a]]) & 0xffu)
                 | (static_cast<unsigned>(cand[2 * order[a] + 1]) & 0xffu)
                       << 8
                 | static_cast<unsigned>(len) << 16;
    idx[nrun++] = ix;
    a += len;
  }
  c.nrun = 0;
  for (int pass = 0; pass < 2; pass++) {
    for (int q = 0; q < nrun; q++)
      if (((runs[q] >> 16) > 1) == (pass == 0)) {
        c.run[c.nrun] = runs[q];
        c.ridx[c.nrun++] = idx[q];
      }
    if (pass == 0) c.nmulti = c.nrun;
  }
  for (int q = c.nrun; q < MAX_CANDIDATES; q++) c.run[q] = c.ridx[q] = 0;
  // SMs of the device, read once
  static int sms_of[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!sms_of[dev])
    cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount, dev);
  const long long sms = sms_of[dev] > 0 ? sms_of[dev] : 1;
  // MB rows a block: up to MS_MAX_ROWS of one segment of lseg MB rows,
  // a segment inside one window (and, for K19, one shard), cut into row
  // groups that differ by at most a row; MB columns up to 4. Columns,
  // then rows, are halved while the grid has fewer than two blocks an SM
  // or a block's shared memory passes MS_SMEM_MAX
  const int R = H / 16, M = W / 16;
  int lseg = win / 16;
  for (int b = HALO ? h.rows : 0; b;) {   // gcd(win / 16, rows) for K19
    const int t = lseg % b;
    lseg = b;
    b = t;
  }
  int nmr = lseg < MS_MAX_ROWS ? lseg : MS_MAX_ROWS;
  int nmb = MS_MAX_COLS;
  auto blocks = [&]() {
    return 1LL * (R / lseg) * ((lseg + nmr - 1) / nmr)
           * ((M + nmb - 1) / nmb);
  };
  while ((blocks() < 2 * sms
          || motion_smem(nmr, nmb, c.vmax, c.hmax) > MS_SMEM_MAX)
         && (nmb > 1 || nmr > 1)) {
    if (nmb > 1) nmb >>= 1;
    else nmr >>= 1;
  }
  if (motion_smem(nmr, nmb, c.vmax, c.hmax) > MS_SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  // threads a pair: 1, doubled (to 4) while the pairs times that stay
  // under 512 threads an SM; runs only where one thread a pair fills the
  // card (a run's window warm-up would lengthen the short parts)
  int rsl = 0;
  while (rsl < 2 && (1LL * R * M * c.nrun << rsl) < 512 * sms) rsl++;
  if (rsl > 0 && c.nrun < n) {
    c.nrun = n;
    c.nmulti = 0;
    for (int k = 0; k < n; k++) {
      c.run[k] = (c.packed[k] & 0xffffu) | 1u << 16;
      c.ridx[k] = static_cast<unsigned>(k);
    }
    rsl = 0;
    while (rsl < 2 && (1LL * R * M * n << rsl) < 512 * sms) rsl++;
  }
  const size_t smem = motion_smem(nmr, nmb, c.vmax, c.hmax);
  dim3 grid((M + nmb - 1) / nmb, (R / lseg) * ((lseg + nmr - 1) / nmr));
  motion_select_kernel<FULL, HALO>
      <<<grid, MS_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
          cur_y, ref_y, ref_u, ref_v, qp_rows, c, W, win, h, lseg, nmr, nmb,
          rsl, pred_y, pred_u, pred_v, mv);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int motion_select(const uint8_t* cur_y, const uint8_t* ref_y,
                             const uint8_t* ref_u, const uint8_t* ref_v,
                             const int* qp_rows, const int* cand, int n, int H,
                             int W, int win, uint8_t* pred_y, uint8_t* pred_u,
                             uint8_t* pred_v, int* mv, void* stream) {
  return launch_motion<false, false>(cur_y, ref_y, ref_u, ref_v, qp_rows,
                                     cand, n, H, W, win, Halo{1, 0, 0},
                                     pred_y, pred_u, pred_v, mv, stream);
}

// the 4:4:4 entry: ref_u / ref_v and pred_u / pred_v are H x W
extern "C" int motion_select444(const uint8_t* cur_y, const uint8_t* ref_y,
                                const uint8_t* ref_u, const uint8_t* ref_v,
                                const int* qp_rows, const int* cand, int n,
                                int H, int W, int win, uint8_t* pred_y,
                                uint8_t* pred_u, uint8_t* pred_v, int* mv,
                                void* stream) {
  return launch_motion<true, false>(cur_y, ref_y, ref_u, ref_v, qp_rows,
                                    cand, n, H, W, win, Halo{1, 0, 0},
                                    pred_y, pred_u, pred_v, mv, stream);
}

// K19: hy (n, 16 * rows + 2 * halo_y, W) and hu / hv (n, 8 * rows +
// 2 * halo_c, W / 2) are the halo bands of the reference planes; the
// caller checks that the halos cover the candidates' reach.
extern "C" int motion_select_halo(const uint8_t* cur_y, const uint8_t* hy,
                                  const uint8_t* hu, const uint8_t* hv,
                                  const int* qp_rows, const int* cand, int n,
                                  int H, int W, int win, int rows, int halo_y,
                                  int halo_c, uint8_t* pred_y,
                                  uint8_t* pred_u, uint8_t* pred_v, int* mv,
                                  void* stream) {
  return launch_motion<false, true>(cur_y, hy, hu, hv, qp_rows, cand, n, H, W,
                                    win, Halo{rows, halo_y, halo_c}, pred_y,
                                    pred_u, pred_v, mv, stream);
}

// the 4:4:4 entry: hu / hv (n, 16 * rows + 2 * halo_c, W), full resolution
extern "C" int motion_select_halo444(const uint8_t* cur_y, const uint8_t* hy,
                                     const uint8_t* hu, const uint8_t* hv,
                                     const int* qp_rows, const int* cand,
                                     int n, int H, int W, int win, int rows,
                                     int halo_y, int halo_c, uint8_t* pred_y,
                                     uint8_t* pred_u, uint8_t* pred_v,
                                     int* mv, void* stream) {
  return launch_motion<true, true>(cur_y, hy, hu, hv, qp_rows, cand, n, H, W,
                                   win, Halo{rows, halo_y, halo_c}, pred_y,
                                   pred_u, pred_v, mv, stream);
}
