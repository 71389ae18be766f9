// K8 jpeg_events: quantised zigzag coefficients -> the Huffman
// (payload, nbits) slot of every (block, zigzag slot) of every stripe's
// interleaved scan.
//
// Replaces selkies_tpu/ops/jpeg_entropy.py:jpeg_entropy_device (up to the
// packer) with selkies_tpu/ops/bitpack.py:bit_category and value_bits:
// the scan-order gather, the DC difference against the previous block of
// the same component, the AC run statistics (an inclusive cummax of
// nonzero positions), the ZRL and EOB slots and the Huffman LUT lookups;
// categories capped at 11 bits (DC) and 10 (AC) as the reference caps
// them.
//
// Bound on the H100: bytes (6.3 MB of int16 coefficients in, 12.5 MB of
// u32 payload and 3.1 MB of u8 nbits out at 1080p; ~20 integer operations
// a slot). Design: one warp per block of the scan, two slots per lane, so
// a block's 64 coefficients are one 128-byte load; the cummax is a
// warp-shuffle scan; the Huffman LUTs (2.2 KB) sit in shared memory, since
// the lanes of a warp look up different symbols; each warp stores its
// block's 64 payloads (256 bytes) and nbits (64 bytes) contiguously.
#include "h264_common.cuh"
#include "jpeg_tables.cuh"

__device__ __forceinline__ int jpeg_cat(int v, int max_cat) {
  const unsigned mag = static_cast<unsigned>(v < 0 ? -v : v);
  const int c = mag ? 32 - __clz(mag) : 0;
  return c < max_cat ? c : max_cat;
}

__device__ __forceinline__ unsigned jpeg_value_bits(int v, int cat) {
  const int raw = v >= 0 ? v : v - 1;
  return static_cast<unsigned>(raw) & ((1u << cat) - 1u);
}

__global__ void jpeg_events_kernel(const short* __restrict__ y,
                                   const short* __restrict__ cb,
                                   const short* __restrict__ cr,
                                   const int* __restrict__ scan,
                                   int* __restrict__ payload,
                                   uint8_t* __restrict__ nbits, int S, int M,
                                   int ny_s, int nc_s) {
  __shared__ int dc_lut[2][16];
  __shared__ int ac_lut[2][256];
  for (int k = threadIdx.x; k < 512; k += blockDim.x)
    ac_lut[k >> 8][k & 255] = K_JPEG_AC[k];
  for (int k = threadIdx.x; k < 32; k += blockDim.x)
    dc_lut[k >> 4][k & 15] = K_JPEG_DC[k];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const long long total = static_cast<long long>(S) * M;
  for (long long gb = static_cast<long long>(blockIdx.x) * warps +
                      (threadIdx.x >> 5);
       gb < total; gb += static_cast<long long>(gridDim.x) * warps) {
    const int s = static_cast<int>(gb / M), m = static_cast<int>(gb % M);
    const int comp = scan[m], ch = comp != 0;
    auto row_of = [&](int mm) {
      const int c = scan[mm];
      const int n = c == 0 ? ny_s : nc_s;
      const int gi = clampi(scan[M + mm], 0, n - 1);
      const short* p = c == 0 ? y : (c == 1 ? cb : cr);
      return p + (static_cast<size_t>(s) * n + gi) * 64;
    };
    const short* row = row_of(m);
    const int2 pair = make_int2(row[2 * lane], row[2 * lane + 1]);
    const int p0 = 2 * lane, p1 = 2 * lane + 1;
    const bool nz0 = pair.x != 0 && p0 > 0, nz1 = pair.y != 0;
    // inclusive cummax of nonzero AC positions, across the warp
    const int m0 = nz0 ? p0 : 0;
    const int m1 = nz1 ? p1 : m0;
    int incl = m1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl = max(incl, u);
    }
    int excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0;
    const int last_nz = __shfl_sync(0xffffffffu, incl, 31);
    int out_pay[2], out_nb[2];
    const int vals[2] = {pair.x, pair.y};
    const int prev_nz[2] = {excl, max(excl, m0)};
#pragma unroll
    for (int k = 0; k < 2; k++) {
      const int pos = p0 + k, v = vals[k];
      unsigned pay = 0;
      int nb = 0;
      if (pos == 0) {
        const int ps = scan[2 * M + m];
        const int dcdiff = v - (ps >= 0 ? row_of(ps)[0] : 0);
        const int cat = jpeg_cat(dcdiff, 11);
        const int e = dc_lut[ch][cat];
        pay = (static_cast<unsigned>(e & 0xFFFF) << cat) |
              jpeg_value_bits(dcdiff, cat);
        nb = (e >> 16) + cat;
      } else if (v != 0) {
        const int cat = jpeg_cat(v, 10);
        const int e = ac_lut[ch][((pos - prev_nz[k] - 1) & 15) * 16 + cat];
        pay = (static_cast<unsigned>(e & 0xFFFF) << cat) |
              jpeg_value_bits(v, cat);
        nb = (e >> 16) + cat;
      } else {
        const int zeros = pos - prev_nz[k];
        if (pos < last_nz && zeros > 0 && (zeros & 15) == 0) {
          const int e = ac_lut[ch][0xF0];                      // ZRL
          pay = e & 0xFFFF;
          nb = e >> 16;
        } else if (pos == 63 && last_nz < 63) {
          const int e = ac_lut[ch][0x00];                      // EOB
          pay = e & 0xFFFF;
          nb = e >> 16;
        }
      }
      out_pay[k] = static_cast<int>(pay);
      out_nb[k] = nb;
    }
    const size_t base = static_cast<size_t>(gb) * 64;
    reinterpret_cast<int2*>(payload + base)[lane] =
        make_int2(out_pay[0], out_pay[1]);
    reinterpret_cast<uchar2*>(nbits + base)[lane] =
        make_uchar2(static_cast<uint8_t>(out_nb[0]),
                    static_cast<uint8_t>(out_nb[1]));
  }
}

extern "C" int jpeg_events(const short* y, const short* cb, const short* cr,
                           const int* scan, int* payload, uint8_t* nbits,
                           int S, int M, int ny_s, int nc_s, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256, warps = threads / 32;
  const long long blocks_needed = (static_cast<long long>(S) * M + warps - 1)
                                  / warps;
  // a few blocks per SM, each walking several scan blocks, so the LUT
  // staging is paid a few hundred times, not once per eight blocks
  const int grid = static_cast<int>(blocks_needed < 1056 ? blocks_needed
                                                         : 1056);
  jpeg_events_kernel<<<grid, threads, 0, st>>>(y, cb, cr, scan, payload,
                                               nbits, S, M, ny_s, nc_s);
  return static_cast<int>(cudaGetLastError());
}
