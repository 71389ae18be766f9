// Kernels whose blocks meet through device memory of their own module
// (per-band tickets: K1, K6, K13): each band's flag from its last block,
// and their launches put in one order across streams: a launch on
// another stream than the last one waits for the event that one
// recorded, so two launches never share the tickets at once. One
// LaunchOrder a kernel, per device.
#pragma once
#include <cuda_runtime.h>

#include <mutex>

namespace {

// The band's flag, by every thread of a block with its own finding
// ``found``: the block ORs them and adds itself to the band's ticket with
// one 64-bit atomic (blocks done in the low word, damaged blocks in the
// high word). The add returns the counts of the blocks before it, so the
// band's last block (of ``blocks``) knows the flag without any other
// memory being ordered, stores it with a plain store and puts the ticket
// back to 0 for the next launch.
__device__ __forceinline__ void ticket_flag(unsigned long long* ticket,
                                            int* flag, int blocks,
                                            int found) {
  const int any = __syncthreads_or(found);
  if (threadIdx.x == 0) {
    const unsigned long long old =
        atomicAdd(ticket, 1ull + (any ? 1ull << 32 : 0ull));
    if (static_cast<int>(old & 0xffffffffu) == blocks - 1) {
      *flag = (old >> 32) + any > 0;
      *ticket = 0ull;
    }
  }
}

struct LaunchOrder {
  std::mutex lock;
  cudaEvent_t last[64] = {};
  cudaStream_t stream[64] = {};
};

// With ``o.lock`` held, before the launch on ``st``: the current device
// (0..63) into ``dev``; a launch on another stream than the last waits
// for its event.
inline cudaError_t order_before(LaunchOrder& o, cudaStream_t st, int* dev) {
  cudaGetDevice(dev);
  if (*dev < 0 || *dev >= 64) return cudaErrorInvalidDevice;
  if (!o.last[*dev])
    return cudaEventCreateWithFlags(&o.last[*dev], cudaEventDisableTiming);
  if (st != o.stream[*dev]) return cudaStreamWaitEvent(st, o.last[*dev], 0);
  return cudaSuccess;
}

// After a launch that succeeded: its event, for the next launch
inline void order_after(LaunchOrder& o, cudaStream_t st, int dev) {
  cudaEventRecord(o.last[dev], st);
  o.stream[dev] = st;
}

}  // namespace
