// Grid sizing shared by the grid-stride kernels of csrc/ (dropout.cu,
// normal.cu): one wave of resident blocks.
//
// A thread of these kernels does the same work on every pass of its loop,
// so one wave (as many blocks as the card holds at once) keeps every SM
// busy until the last pass, where the threads differ by at most one pass,
// and starts no block twice. The count is asked of the runtime once per
// kernel instance and device (a `WaveCache` per instance), not on every
// launch: the dropout kernel is launched dozens of times a batch.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxDevices = 64;

struct WaveCache {
  std::atomic<int64_t> blocks[kMaxDevices];  // 0: not asked yet
};

// Blocks of `threads` threads of `kernel` for work of `want` blocks: `want`
// when it is under one wave, else one wave of the current device.
template <typename Kernel>
cudaError_t wave_blocks(WaveCache& cache, Kernel kernel, int threads, int64_t want,
                        int* blocks) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  int64_t wave = cache.blocks[device].load(std::memory_order_relaxed);
  if (wave == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    if (err != cudaSuccess) return err;
    wave = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
    cache.blocks[device].store(wave, std::memory_order_relaxed);
  }
  *blocks = (int)(want < wave ? (want > 0 ? want : 1) : wave);
  return cudaSuccess;
}

}  // namespace
