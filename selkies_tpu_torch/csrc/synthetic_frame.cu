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
// (S, H, W, 3) batch: blockIdx.y is the seat; the single-frame entry is
// its S = 1 case.
//
// Bound on the H100: bytes (6.22 MB written a 1920x1080 frame, nothing
// read). Design: one thread per 4 output bytes, a 32-bit store where the
// seat's frame is 4-byte aligned (byte stores at a ragged tail or an
// unaligned frame).
#include <cuda_runtime.h>
#include <stdint.h>

// jnp's % on int32: the floor modulo (sign of the divisor), m > 0
__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

// an int32 product that wraps like XLA's (two's complement)
__device__ __forceinline__ int wrap_mul(int a, unsigned k) {
  return static_cast<int>(static_cast<unsigned>(a) * k);
}

__global__ void synthetic_frame_kernel(uint8_t* __restrict__ out_all, int H,
                                       int W, int tick0) {
  const long long n = 3LL * H * W;
  uint8_t* out = out_all + n * blockIdx.y;
  // the seat's phase, seat * 37 + tick wrapped as int32
  const int tick = static_cast<int>(blockIdx.y * 37u +
                                    static_cast<unsigned>(tick0));
  const int vec = (reinterpret_cast<uintptr_t>(out) & 3) == 0;
  const long long i0 =
      4LL * (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (i0 >= n) return;
  const int bar_x = floor_mod(wrap_mul(tick, 7u), W);
  const int per_h = H - 96 > 1 ? H - 96 : 1;
  const int dy = floor_mod(wrap_mul(tick, 5u), 2 * per_h) - per_h;
  const int by = dy < 0 ? -dy : dy;
  const unsigned b_off = static_cast<unsigned>(wrap_mul(tick, 3u));
  const long long p = i0 / 3;
  int c = static_cast<int>(i0 - 3 * p);
  int y = static_cast<int>(p / W), x = static_cast<int>(p - 1LL * y * W);
  uint8_t v[4];
#pragma unroll
  for (int k = 0; k < 4; k++) {
    const bool in_bar = x >= bar_x && x < bar_x + 32;
    const bool in_block = y >= by && y < by + 96 && x >= 64 && x < 224;
    unsigned b;
    if (c == 0) {
      b = in_bar ? 255u : in_block ? 30u : static_cast<unsigned>(x * 255 / W);
    } else if (c == 1) {
      b = in_bar ? 255u : in_block ? 220u : static_cast<unsigned>(y * 255 / H);
    } else {
      b = in_bar ? 255u
                 : in_block ? 60u
                            : (static_cast<unsigned>(x) +
                               static_cast<unsigned>(y) + b_off) & 0xFFu;
    }
    v[k] = static_cast<uint8_t>(b);
    if (++c == 3) {
      c = 0;
      if (++x == W) {
        x = 0;
        ++y;
      }
    }
  }
  if (vec && i0 + 4 <= n) {
    *reinterpret_cast<uint32_t*>(out + i0) =
        v[0] | (v[1] << 8) | (v[2] << 16) | (static_cast<uint32_t>(v[3]) << 24);
  } else {
    for (int k = 0; k < 4 && i0 + k < n; k++) out[i0 + k] = v[k];
  }
}

// S frames, seat k's at tick k * 37 + tick, into out (S, H, W, 3)
extern "C" int synthetic_frames(uint8_t* out, int S, int H, int W, int tick,
                                void* stream) {
  if (S <= 0 || S > 65535 || H <= 0 || W <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long groups = (3LL * H * W + 3) / 4;
  const int threads = 256;
  const dim3 grid(static_cast<unsigned>((groups + threads - 1) / threads), S);
  synthetic_frame_kernel<<<grid, threads, 0, s>>>(out, H, W, tick);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int synthetic_frame(uint8_t* out, int H, int W, int tick,
                               void* stream) {
  return synthetic_frames(out, 1, H, W, tick, stream);
}
