// Launches of a kernel whose blocks meet through device memory of its
// own module (per-band tickets: K1, K6) are put in one order across
// streams: a launch on another stream than the last one waits for the
// event that one recorded, so two launches never share the tickets at
// once. One LaunchOrder a kernel, per device.
#pragma once
#include <cuda_runtime.h>

#include <mutex>

namespace {

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
