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
// a slot). The kernel is short (a few loads a thread), so its time is the
// chain of dependent loads before the stores. Design:
//
// - a block of 256 threads takes a tile of 32 consecutive scan blocks
//   (8 lanes a scan block, 8 zigzag slots a lane) and the stripes of a
//   contiguous range of (tile, stripe) items, ordered tile-major; a scan
//   block's 8 lanes load its map entries once for the tile (lane 0 its
//   predecessor's too, one load more from lines just fetched) and
//   compute its row offset from them: a stripe's loads then depend on
//   nothing but the stripe, and no barrier comes between stripes (the
//   one barrier publishes the Huffman LUTs, after the first stripe's
//   loads are issued);
// - a lane's 8 coefficients are one 16-byte load; lane 0 of a scan block
//   loads its predecessor's DC beside them; any scan the wrapper takes
//   works (-1 at a stripe's start, any other index, clamped as the plain
//   version clamps it);
// - the cummax runs inside the lane, then in three shuffle steps across
//   the scan block's 8 lanes; each slot is one LUT lookup (the code
//   pre-shifted over its value bits, its nbits beside it) and selects,
//   without a branch;
// - payloads go out as two 16-byte stores a lane, nbits as one of 8;
// - launched behind the kernel before it (programmatic dependent launch),
//   the LUTs staged before the wait;
// - the grid is as many blocks as are resident at once (the occupancy
//   the build reports), each taking an equal share of the items;
// - FAST: M a multiple of the tile and the three planes 16-byte aligned;
//   the other instantiation masks the ragged tile and loads by element.
#include "h264_common.cuh"
#include "jpeg_tables.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int K8_THREADS = 256;
constexpr int K8_LANES = 8;                        // lanes a scan block
constexpr int K8_TILE = K8_THREADS / K8_LANES;     // scan blocks a tile
constexpr int K8_AC = 512, K8_DC = 32;             // LUT entries

// A LUT entry as the kernel keeps it in shared memory: for the symbol
// of category ``cat`` with Huffman code ``code`` of ``len`` bits (``e`` =
// len << 16 | code, as jpeg_tables.cuh holds it), the code shifted over
// the value bits in bits 0-26 and len + cat, the slot's nbits, in bits
// 27-31 (AC: 16 + 10 bits at most; DC: 11 + 11).
__device__ __forceinline__ unsigned lut_entry(int e, int cat) {
  return static_cast<unsigned>((e >> 16) + cat) << 27 |
         static_cast<unsigned>(e & 0xFFFF) << cat;
}

// The zigzag value of slot k (0..7) of a lane's 8 packed int16s.
__device__ __forceinline__ int coef(const uint4& w, int k) {
  const unsigned u = k < 2 ? w.x : (k < 4 ? w.y : (k < 6 ? w.z : w.w));
  return k & 1 ? static_cast<int>(u) >> 16
               : static_cast<int>(static_cast<short>(u & 0xFFFFu));
}

// The 8 slots of lane ``j`` (zigzag positions 8j..8j+7) of one scan
// block, packed in ``w``: payloads into ``pay`` and nbits packed into
// ``nb`` (slot k in byte k % 4 of word k / 4), without a branch. ``lut``
// is the block's LUT (lut_entry: AC [2][256] then DC [2][16]); ``ezrl``
// and ``eeob`` the lane's component's ZRL and EOB entries; ``dc_prev``
// the predecessor's DC (lane 0 only reads it). Every lane of the warp
// calls it (width-8 shuffles).
__device__ __forceinline__ void slot_events(const uint4& w, int j, int ch,
                                            int dc_prev,
                                            const unsigned* lut,
                                            unsigned ezrl, unsigned eeob,
                                            unsigned (&pay)[8],
                                            unsigned (&nb)[2]) {
  const int p0 = 8 * j;
  // inclusive cummax of nonzero AC positions: the lane's last, then a
  // scan across the scan block's 8 lanes
  int incl = 0;
#pragma unroll
  for (int k = 0; k < 8; k++)
    if (coef(w, k) != 0 && (k > 0 || j > 0)) incl = p0 + k;
#pragma unroll
  for (int o = 1; o < K8_LANES; o <<= 1) {
    const int u = __shfl_up_sync(FULL, incl, o, K8_LANES);
    if (j >= o) incl = max(incl, u);
  }
  int prev = __shfl_up_sync(FULL, incl, 1, K8_LANES);
  if (j == 0) prev = 0;
  const int last_nz = __shfl_sync(FULL, incl, K8_LANES - 1, K8_LANES);
  // 16 x the last nonzero AC position before the slot, and 16 x the
  // slot's position less one: the run's LUT row is their difference
  int prev16 = 16 * prev;
  const unsigned* ac = lut + ch * 256;
  const bool eob = j == K8_LANES - 1 && last_nz < 63;
  nb[0] = nb[1] = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    const int pos = p0 + k, x = coef(w, k);
    const int run16 = (16 * (pos - 1) - prev16) & 0xF0;
    const unsigned* row = ac + run16;
    int val = x, cap = 10;
    bool hit = x != 0;                         // a codeword from the LUT
    if (k == 0 && j == 0) {                    // the DC slot
      val = x - dc_prev;
      row = lut + K8_AC + ch * 16;
      cap = 11;
      hit = true;
    }
    const unsigned mag = static_cast<unsigned>(val < 0 ? -val : val);
    const int cat = min(32 - __clz(mag), cap);
    const unsigned bits =
        static_cast<unsigned>(val + (val >> 31)) & ((1u << cat) - 1u);
    const unsigned e_hit = row[cat];
    // a zero slot: the ZRL that ends a run of 16, 32 or 48 zeros before a
    // later nonzero, the EOB at slot 63 after the last nonzero, else none
    unsigned e_zero = pos < last_nz && run16 == 0xF0 ? ezrl : 0u;
    if (k == 7) e_zero = eob ? eeob : e_zero;
    const unsigned e = hit ? e_hit : e_zero;
    pay[k] = (e & 0x07FFFFFFu) | bits;
    nb[k >> 2] |= (e >> 27) << (8 * (k & 3));
    if (x != 0 && (k > 0 || j > 0)) prev16 = 16 * pos;
  }
}

__device__ __forceinline__ const short* plane_of(const short* y,
                                                const short* cb,
                                                const short* cr, int c) {
  return c == 0 ? y : (c == 1 ? cb : cr);
}

template <bool FAST>
__global__ void __launch_bounds__(K8_THREADS, 4)
jpeg_events_kernel(const short* __restrict__ y, const short* __restrict__ cb,
                   const short* __restrict__ cr, const int* __restrict__ scan,
                   const int* __restrict__ ac_g,
                   const int* __restrict__ dc_g, int* __restrict__ payload,
                   uint8_t* __restrict__ nbits, int S, int M, int ny_s,
                   int nc_s, int per_block) {
  __shared__ unsigned lut[K8_AC + K8_DC];
  const int tid = threadIdx.x, b = tid / K8_LANES, j = tid % K8_LANES;
  const int tiles = (M + K8_TILE - 1) / K8_TILE;
  const int items = tiles * S;
  int item = blockIdx.x * per_block;
  const int item_end = min(item + per_block, items);
  if (item >= item_end) return;
  {
    // the LUTs (constant tables, written by no kernel) before the wait for
    // the kernel this one was launched behind; the barrier that publishes
    // them comes after the first stripe's loads are issued
    static_assert(K8_AC == 2 * K8_THREADS && K8_DC <= K8_THREADS, "LUT");
    const int a0 = ac_g[tid], a1 = ac_g[K8_THREADS + tid];
    const int d0 = tid < K8_DC ? dc_g[tid] : 0;
    lut[tid] = lut_entry(a0, tid & 15);
    lut[K8_THREADS + tid] = lut_entry(a1, tid & 15);
    if (tid < K8_DC) lut[K8_AC + tid] = lut_entry(d0, tid & 15);
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");

  int tile = -1, m = 0;
  bool on = false, aux_on = false, lut_ready = false;
  const short* own = nullptr;      // this lane's 8 coefficients
  const short* aux = nullptr;      // lane 0: the predecessor's DC
  int own_step = 0, aux_step = 0;  // elements a stripe
  int ch = 0;
  unsigned ezrl = 0, eeob = 0;
  while (item < item_end) {
    const int t = item / S;
    int s = item - t * S;
    const int s_end = min(S, s + (item_end - item));
    if (t != tile) {
      // the scan block's map entries, loaded by its 8 lanes at once, and
      // lane 0's predecessor's (one more load, from lines just fetched)
      m = t * K8_TILE + b;
      on = FAST || m < M;
      int c = 0, gi = 0, ps = -1;
      if (on) {
        c = scan[m];
        gi = scan[M + m];
        if (j == 0) ps = scan[2 * M + m];
      }
      const bool y_own = c == 0;
      ch = !y_own;
      own = plane_of(y, cb, cr, c == 0 ? 0 : (c == 1 ? 1 : 2)) +
            clampi(gi, 0, (y_own ? ny_s : nc_s) - 1) * 64LL + K8_LANES * j;
      own_step = (y_own ? ny_s : nc_s) * 64;
      aux_on = ps >= 0;
      if (aux_on) {
        ps = min(ps, M - 1);
        const int pc = scan[ps], pg = scan[M + ps];
        const bool y_p = pc == 0;
        aux = plane_of(y, cb, cr, pc == 0 ? 0 : (pc == 1 ? 1 : 2)) +
              clampi(pg, 0, (y_p ? ny_s : nc_s) - 1) * 64LL;
        aux_step = (y_p ? ny_s : nc_s) * 64;
      }
      tile = t;
    }
    for (; s < s_end; s++) {
      uint4 w = make_uint4(0, 0, 0, 0);
      const short* p = own + static_cast<long long>(s) * own_step;
      if (FAST) {
        if (on) w = __ldg(reinterpret_cast<const uint4*>(p));
      } else if (on) {
        unsigned h[8];
#pragma unroll
        for (int k = 0; k < 8; k++)
          h[k] = static_cast<unsigned short>(__ldg(p + k));
        w = make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16,
                       h[4] | h[5] << 16, h[6] | h[7] << 16);
      }
      const int dc_prev =
          aux_on ? __ldg(aux + static_cast<long long>(s) * aux_step) : 0;
      if (!lut_ready) {
        __syncthreads();
        lut_ready = true;
      }
      ezrl = lut[ch * 256 + 0xF0];
      eeob = lut[ch * 256];
      unsigned pay[8], nb[2];
      slot_events(w, j, ch, dc_prev, lut, ezrl, eeob, pay, nb);
      if (on) {
        const size_t base =
            (static_cast<size_t>(s) * M + m) * 64 + K8_LANES * j;
        uint4* d = reinterpret_cast<uint4*>(payload + base);
        d[0] = make_uint4(pay[0], pay[1], pay[2], pay[3]);
        d[1] = make_uint4(pay[4], pay[5], pay[6], pay[7]);
        *reinterpret_cast<uint2*>(nbits + base) = make_uint2(nb[0], nb[1]);
      }
    }
    item = t * S + s_end;
  }
}

// per device: the LUTs' addresses (the constant tables read as device
// memory, by coalesced loads) and the resident blocks of each instantiation
struct K8Device {
  const int* ac = nullptr;
  const int* dc = nullptr;
  int resident[2] = {0, 0};
};
K8Device k8_devices[64];

template <bool FAST>
int k8_resident(int dev) {
  int per_sm = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, jpeg_events_kernel<FAST>, K8_THREADS, 0);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return per_sm > 0 && sms > 0 ? per_sm * sms : 1;
}

}  // namespace

extern "C" int jpeg_events(const short* y, const short* cb, const short* cr,
                           const int* scan, int* payload, uint8_t* nbits,
                           int S, int M, int ny_s, int nc_s, void* stream) {
  if (S <= 0 || M <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(payload) % 16 ||
      reinterpret_cast<uintptr_t>(nbits) % 8)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const long long tiles = (M + K8_TILE - 1) / K8_TILE;
  const long long n_max = ny_s > nc_s ? ny_s : nc_s;
  if (tiles * S > (1LL << 30) || 64 * n_max > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  K8Device& kd = k8_devices[dev];
  if (!kd.ac) {
    void *ac = nullptr, *dc = nullptr;
    cudaError_t e = cudaGetSymbolAddress(&ac, K_JPEG_AC);
    if (e == cudaSuccess) e = cudaGetSymbolAddress(&dc, K_JPEG_DC);
    if (e != cudaSuccess) return static_cast<int>(e);
    kd.resident[0] = k8_resident<false>(dev);
    kd.resident[1] = k8_resident<true>(dev);
    kd.dc = static_cast<const int*>(dc);
    kd.ac = static_cast<const int*>(ac);
  }
  auto a16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool fast = M % K8_TILE == 0 && a16(y) && a16(cb) && a16(cr);
  // an equal share of the (tile, stripe) items for every resident block
  const long long items = tiles * S;
  const long long resident = kd.resident[fast];
  const int per_block = static_cast<int>((items + resident - 1) / resident);
  const int grid = static_cast<int>((items + per_block - 1) / per_block);
  // launched behind the kernel before it (programmatic dependent launch:
  // K7 in the JPEG step), which it waits for inside
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(K8_THREADS);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg,
                     fast ? jpeg_events_kernel<true>
                          : jpeg_events_kernel<false>,
                     y, cb, cr, scan, kd.ac, kd.dc, payload, nbits, S, M,
                     ny_s, nc_s, per_block);
  return static_cast<int>(cudaGetLastError());
}
