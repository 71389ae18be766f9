// K10 synthetic_frame: the synthetic desktop of one tick, (H, W, 3) uint8:
// a colour gradient, a 32-pixel white bar moving right by 7 pixels a tick,
// and a 96x160 block bouncing vertically by 5 rows a tick.
//
// Replaces selkies_tpu/engine/sources.py:_synthetic_fn.gen (jitted at
// :67), the capture loop's frame source. Its int32 arithmetic is kept
// exactly: r = (x * 255) / W, g = (y * 255) / H, b = (x + y + 3 * tick)
// & 0xFF; bar_x = (7 * tick) mod W; by = |(5 * tick) mod (2 * per_h) -
// per_h| with per_h = max(H - 96, 1); the bar over the block over the
// gradient. The tick products wrap as int32 (multiplied unsigned) and %
// is jnp's floor modulo, so a product that wraps negative reduces into
// [0, m) as the reference reduces it.
//
// The seat entry, synthetic_frames, replaces
// selkies_tpu/parallel/seats.py:synthetic_seat_frames (:267): the same
// pattern vmapped over seats, seat k at the int32 phase k * 37 + tick
// (numpy's int32 arithmetic, which wraps). One launch writes the
// (S, H, W, 3) batch; the single-frame entry is its S = 1 case.
//
// Bound on the H100: bytes (6.22 MB written a 1920x1080 frame, nothing
// read: 1.9 us). Design: a grid over (row chunk, row, seat), so no thread
// divides to find its row or seat, and every per-row term (g, the block's
// row test, y + 3 * tick, the row's alignment) is computed once a block. A
// thread makes 48 bytes of a row, three 16-byte stores at 16-byte-aligned
// addresses: 16 pixels and a fixed channel phase (0, 1 or 2, a template
// argument) set by where the row starts against a 16-byte boundary, so
// rows of any width (3W not a multiple of 16) and seats that start
// unaligned take the same vector path; only the head before the row's
// first boundary and the tail after its last whole 48 bytes (at most 15
// + 47 bytes) are byte stores. A run that meets neither the bar nor the
// block (most runs) makes the gradient alone, without the per-pixel
// tests. r steps exactly from one pixel to the next (255 / W and 255 % W
// carried), so the index math is 32-bit and has no divide a pixel;
// x * 255 < 2^31 for the widths the entry takes. What is left is the
// store stream: a frame's marginal cost at 8 seats is ~1.5x that of a
// fill_ of the same bytes (chip_smoke's "fill_ yardstick" points), and
// neither a constant pattern, nor stores regrouped through shared memory
// into 512-byte warp stores, nor fewer blocks walking more rows made it
// faster.
#include <cuda_runtime.h>
#include <stdint.h>

#define SYN_THREADS 128
#define SYN_MAX_W 8421504   // x * 255 stays inside int32 below this width

// jnp's % on int32: the floor modulo (sign of the divisor), m > 0
__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

// an int32 product that wraps like XLA's (two's complement)
__device__ __forceinline__ int wrap_mul(int a, unsigned k) {
  return static_cast<int>(static_cast<unsigned>(a) * k);
}

// The per-row terms of one seat's frame.
struct SynRow {
  int W, bar_x, g;
  bool blk_row;                // y inside the block's 96 rows
  unsigned b_row;              // y + 3 * tick (its low byte survives)
  int q255, r255;              // 255 / W, 255 % W
};

// Bytes (r, g, b) of pixel x with r = x * 255 / W given.
__device__ __forceinline__ void syn_pixel(const SynRow& s, int x, int r,
                                          unsigned* v) {
  const bool bar = static_cast<unsigned>(x - s.bar_x) < 32u;
  const bool blk = s.blk_row && x >= 64 && x < 224;
  v[0] = bar ? 255u : blk ? 30u : static_cast<unsigned>(r);
  v[1] = bar ? 255u : blk ? 220u : static_cast<unsigned>(s.g);
  v[2] = bar ? 255u
             : blk ? 60u : (static_cast<unsigned>(x) + s.b_row) & 0xFFu;
}

// One byte at row offset o (head and tail bytes).
__device__ __forceinline__ uint8_t syn_byte(const SynRow& s, int o) {
  const int x = o / 3;
  unsigned v[3];
  syn_pixel(s, x, x * 255 / s.W, v);
  const int c = o - 3 * x;
  return static_cast<uint8_t>(c == 0 ? v[0] : c == 1 ? v[1] : v[2]);
}

// 48 bytes from row offset 3 * x0 + P, P the channel phase: bytes j of the
// run are channel (P + j) % 3 of pixel x0 + (P + j) / 3, 16 or 17 pixels.
// PLAIN: the run meets neither the bar nor the block (most runs), so its
// bytes are the gradient alone.
template <int P, bool PLAIN>
__device__ __forceinline__ void syn_run_of(const SynRow& s, int x0,
                                           uint8_t* dst) {
  constexpr int NPX = (P + 47) / 3 + 1;
  unsigned v[NPX][3];
  int r = x0 * 255 / s.W;
  int rem = x0 * 255 - r * s.W;
#pragma unroll
  for (int p = 0; p < NPX; p++) {
    if (PLAIN) {
      v[p][0] = static_cast<unsigned>(r);
      v[p][1] = static_cast<unsigned>(s.g);
      v[p][2] = (static_cast<unsigned>(x0 + p) + s.b_row) & 0xFFu;
    } else {
      syn_pixel(s, x0 + p, r, v[p]);
    }
    r += s.q255;
    rem += s.r255;
    if (rem >= s.W) {
      rem -= s.W;
      r++;
    }
  }
  uint32_t w[12];
#pragma unroll
  for (int k = 0; k < 12; k++) {
    uint32_t word = 0;
#pragma unroll
    for (int i = 0; i < 4; i++) {
      const int j = P + 4 * k + i;
      word |= v[j / 3][j % 3] << (8 * i);
    }
    w[k] = word;
  }
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(w[0], w[1], w[2], w[3]);
  d[1] = make_uint4(w[4], w[5], w[6], w[7]);
  d[2] = make_uint4(w[8], w[9], w[10], w[11]);
}

template <int P>
__device__ __forceinline__ void syn_run(const SynRow& s, int x0,
                                        uint8_t* dst) {
  const int x1 = x0 + (P + 47) / 3;
  if ((x1 < s.bar_x || x0 >= s.bar_x + 32) &&
      !(s.blk_row && x1 >= 64 && x0 < 224))
    syn_run_of<P, true>(s, x0, dst);
  else
    syn_run_of<P, false>(s, x0, dst);
}

__global__ void __launch_bounds__(SYN_THREADS)
synthetic_frame_kernel(uint8_t* __restrict__ out_all, int S, int H, int W,
                       int tick0) {
  const int row_bytes = 3 * W;
  SynRow s;
  s.W = W;
  s.q255 = 255 / W;
  s.r255 = 255 - s.q255 * W;
  const int per_h = H - 96 > 1 ? H - 96 : 1;
  for (int k = blockIdx.z; k < S; k += gridDim.z) {
    // the seat's phase, seat * 37 + tick wrapped as int32
    const int tick = static_cast<int>(static_cast<unsigned>(k) * 37u +
                                      static_cast<unsigned>(tick0));
    s.bar_x = floor_mod(wrap_mul(tick, 7u), W);
    const int dy = floor_mod(wrap_mul(tick, 5u), 2 * per_h) - per_h;
    const int by = dy < 0 ? -dy : dy;
    const unsigned b_off = static_cast<unsigned>(wrap_mul(tick, 3u));
    uint8_t* frame = out_all + static_cast<size_t>(k) * H * row_bytes;
    for (int y = blockIdx.y; y < H; y += gridDim.y) {
      uint8_t* row = frame + static_cast<size_t>(y) * row_bytes;
      s.g = y * 255 / H;
      s.blk_row = y >= by && y < by + 96;
      s.b_row = static_cast<unsigned>(y) + b_off;
      // bytes before the row's first 16-byte boundary, whole 48-byte
      // runs after it, and the tail
      int head = static_cast<int>((16u - (reinterpret_cast<uintptr_t>(row)
                                           & 15u)) & 15u);
      head = head < row_bytes ? head : row_bytes;
      const int runs = (row_bytes - head) / 48;
      const int tail0 = head + 48 * runs;
      const int x0 = head / 3, phase = head - 3 * x0;
      for (int t = blockIdx.x * SYN_THREADS + threadIdx.x; t < runs;
           t += gridDim.x * SYN_THREADS) {
        uint8_t* dst = row + head + 48 * t;
        if (phase == 0)
          syn_run<0>(s, x0 + 16 * t, dst);
        else if (phase == 1)
          syn_run<1>(s, x0 + 16 * t, dst);
        else
          syn_run<2>(s, x0 + 16 * t, dst);
      }
      const int edge = head + row_bytes - tail0;
      if (blockIdx.x == 0)
        for (int i = threadIdx.x; i < edge; i += SYN_THREADS) {
          const int o = i < head ? i : tail0 + i - head;
          row[o] = syn_byte(s, o);
        }
    }
  }
}

// S frames, seat k's at tick k * 37 + tick, into out (S, H, W, 3)
extern "C" int synthetic_frames(uint8_t* out, int S, int H, int W, int tick,
                                void* stream) {
  if (S <= 0 || S > 65535 || H <= 0 || W <= 0 || W >= SYN_MAX_W)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int runs = (3 * W) / 48 + 1;
  const dim3 grid((runs + SYN_THREADS - 1) / SYN_THREADS,
                  H < 65535 ? H : 65535, S);
  synthetic_frame_kernel<<<grid, SYN_THREADS, 0, st>>>(out, S, H, W, tick);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int synthetic_frame(uint8_t* out, int H, int W, int tick,
                               void* stream) {
  return synthetic_frames(out, 1, H, W, tick, stream);
}
