// K5 motion_select: full-pel scroll motion search of the P path, one
// macroblock per block. For every candidate (dy, dx) of a static set:
// SAD of the 16x16 luma MB against the edge-clamped shifted reference plus
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
// Bound on the H100: operations (57 candidates x 256 |a - b| + adds per MB,
// ~120 M integer ops at 1080p) against bytes (the luma and chroma planes in,
// the prediction planes out, ~9 MB). Design: the current MB and the
// (16 + 2V) x (16 + 2Hm) reference tile (64 x 32 bytes at V 24, Hm 8) are
// staged in shared memory once; each warp takes candidates in turn, a lane
// eight pixels, and a shuffle reduction makes the SAD; warp 0 takes the
// argmin; then the whole block writes the prediction. The prediction goes
// to its own planes, never into the reference planes, so the P coder (K2),
// which rewrites the reference in place, reads a prediction that no recon
// write can have touched. Chroma reads its four taps straight from global
// memory (one candidate, 64 pixels a component).
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
// are the constant 0 and K5's entries compile as they did. Bound and
// design as K5's: the bands are read in place of the planes.
#include "h264_common.cuh"

#define MAX_CANDIDATES 128

struct Candidates {
  int n, vmax, hmax;
  short dy[MAX_CANDIDATES];
  short dx[MAX_CANDIDATES];
};

// K19's shard geometry: MB rows a shard, luma and chroma halo rows
struct Halo {
  int rows, y, c;
};

__device__ __forceinline__ int se_bits(int v) {
  const unsigned cn = v > 0 ? 2u * v - 1u : static_cast<unsigned>(-2 * v);
  return 2 * (32 - __clz(cn + 1u)) - 1;
}

// floor(v / 2) and v mod 2 as Python's >> and & give them
__device__ __forceinline__ int floor_half(int v) { return (v - (v & 1)) / 2; }

template <bool FULL, bool HALO>
__global__ void motion_select_kernel(
    const uint8_t* __restrict__ cur_y, const uint8_t* __restrict__ ref_y,
    const uint8_t* __restrict__ ref_u, const uint8_t* __restrict__ ref_v,
    const int* __restrict__ qp_rows, const Candidates c, int W, int win,
    const Halo h, uint8_t* __restrict__ pred_y, uint8_t* __restrict__ pred_u,
    uint8_t* __restrict__ pred_v, int* __restrict__ mv) {
  extern __shared__ int smi[];
  const int TW = 16 + 2 * c.hmax, TH = 16 + 2 * c.vmax;
  int* cost = smi;                                   // n
  int* s_sel = cost + MAX_CANDIDATES;                // 1
  uint8_t* cur = reinterpret_cast<uint8_t*>(s_sel + 4);   // 256
  uint8_t* tile = cur + 256;                         // TH * TW
  const int m = blockIdx.x, r = blockIdx.y;
  const int M = W / 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int y0 = 16 * r, yl = y0 % win, wbase = y0 - yl;
  // K19: frame row ry of the reference is row ry + off of the stacked
  // halo bands (0 for K5, which reads the planes)
  int off_y = 0, off_c = 0;
  if constexpr (HALO) {
    const int s2 = 2 * (r / h.rows) + 1;
    off_y = s2 * h.y;
    off_c = s2 * h.c;
  }

  for (int i = tid; i < TH * TW; i += nthreads) {
    const int t = i / TW, u = i % TW;
    const int ry = wbase + clampi(yl + t - c.vmax, 0, win - 1) + off_y;
    const int rx = clampi(16 * m + u - c.hmax, 0, W - 1);
    tile[i] = ref_y[static_cast<size_t>(ry) * W + rx];
  }
  for (int i = tid; i < 256; i += nthreads)
    cur[i] = cur_y[static_cast<size_t>(y0 + (i >> 4)) * W + 16 * m + (i & 15)];
  __syncthreads();

  const int lam = K_MV_LAMBDA[clampi(qp_rows[r], 0, 51)];
  for (int k = warp; k < c.n; k += nwarps) {
    const int oy = c.dy[k] + c.vmax, ox = c.dx[k] + c.hmax;
    int s = 0;
#pragma unroll
    for (int p = lane; p < 256; p += 32) {
      const int i = p >> 4, j = p & 15;
      s += abs(static_cast<int>(cur[p]) -
               static_cast<int>(tile[(i + oy) * TW + j + ox]));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) cost[k] = s + lam * (se_bits(4 * c.dx[k]) + se_bits(4 * c.dy[k]));
  }
  __syncthreads();

  if (warp == 0) {
    // each lane scans its candidates in order (strict <: lowest index);
    // the reduction keeps the lower index on equal cost
    int best = 0x7fffffff, bi = MAX_CANDIDATES;
    for (int k = lane; k < c.n; k += 32)
      if (cost[k] < best) { best = cost[k]; bi = k; }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const int ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ob < best || (ob == best && oi < bi)) { best = ob; bi = oi; }
    }
    if (lane == 0) s_sel[0] = bi;
  }
  __syncthreads();

  const int sel = s_sel[0];
  const int dy = c.dy[sel], dx = c.dx[sel];
  for (int p = tid; p < 256; p += nthreads) {
    const int i = p >> 4, j = p & 15;
    pred_y[static_cast<size_t>(y0 + i) * W + 16 * m + j] =
        tile[(i + dy + c.vmax) * TW + j + dx + c.hmax];
  }
  if constexpr (FULL) {
    for (int p = tid; p < 512; p += nthreads) {
      const int comp = p >> 8, i = (p >> 4) & 15, j = p & 15;
      const uint8_t* src = comp ? ref_v : ref_u;
      const int ry = wbase + clampi(yl + i + dy, 0, win - 1) + off_c;
      const int rx = clampi(16 * m + j + dx, 0, W - 1);
      (comp ? pred_v : pred_u)[static_cast<size_t>(y0 + i) * W + 16 * m + j] =
          src[static_cast<size_t>(ry) * W + rx];
    }
  } else {
    const int W2 = W / 2, cwin = win / 2, cyl = yl / 2, cbase = wbase / 2;
    const int by = floor_half(dy), fy = dy & 1, bx = floor_half(dx), fx = dx & 1;
    for (int p = tid; p < 128; p += nthreads) {
      const int comp = p >> 6, i = (p >> 3) & 7, j = p & 7;
      const uint8_t* src = comp ? ref_v : ref_u;
      const int r0 = cbase + clampi(cyl + i + by, 0, cwin - 1) + off_c;
      const int r1 = cbase + clampi(cyl + i + by + 1, 0, cwin - 1) + off_c;
      const int c0 = clampi(8 * m + j + bx, 0, W2 - 1);
      const int c1 = clampi(8 * m + j + bx + 1, 0, W2 - 1);
      const int a = src[static_cast<size_t>(r0) * W2 + c0];
      int v;
      if (!fy && !fx) {
        v = a;
      } else if (fy && !fx) {
        v = (a + src[static_cast<size_t>(r1) * W2 + c0] + 1) >> 1;
      } else if (fx && !fy) {
        v = (a + src[static_cast<size_t>(r0) * W2 + c1] + 1) >> 1;
      } else {
        v = (a + src[static_cast<size_t>(r1) * W2 + c0] +
             src[static_cast<size_t>(r0) * W2 + c1] +
             src[static_cast<size_t>(r1) * W2 + c1] + 2) >> 2;
      }
      (comp ? pred_v : pred_u)[static_cast<size_t>(8 * r + i) * W2 + 8 * m + j] =
          static_cast<uint8_t>(v);
    }
  }
  if (tid == 0) {
    const size_t g = static_cast<size_t>(r) * M + m;
    mv[2 * g] = 4 * dx;
    mv[2 * g + 1] = 4 * dy;
  }
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
  if (n < 1 || n > MAX_CANDIDATES) return static_cast<int>(cudaErrorInvalidValue);
  Candidates c;
  c.n = n;
  c.vmax = 0;
  c.hmax = 0;
  for (int k = 0; k < n; k++) {
    const int dy = cand[2 * k], dx = cand[2 * k + 1];
    c.dy[k] = static_cast<short>(dy);
    c.dx[k] = static_cast<short>(dx);
    const int ay = dy < 0 ? -dy : dy, ax = dx < 0 ? -dx : dx;
    if (ay > c.vmax) c.vmax = ay;
    if (ax > c.hmax) c.hmax = ax;
  }
  for (int k = n; k < MAX_CANDIDATES; k++) c.dy[k] = c.dx[k] = 0;
  const size_t smem = sizeof(int) * (MAX_CANDIDATES + 4) + 256 +
                      static_cast<size_t>(16 + 2 * c.vmax) * (16 + 2 * c.hmax);
  dim3 grid(W / 16, H / 16);
  motion_select_kernel<FULL, HALO>
      <<<grid, 256, smem, static_cast<cudaStream_t>(stream)>>>(
          cur_y, ref_y, ref_u, ref_v, qp_rows, c, W, win, h, pred_y, pred_u,
          pred_v, mv);
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
