// Counter-based random bits shared by the kernels of csrc/: one definition
// of each, so that the dropout masks (dropout.cu), the sampled focal loss
// (focal.cu) and the normals (normal.cu) are keyed the same way in every
// kernel and in their plain PyTorch versions (ops/kernels/dropout.py,
// ops/kernels/focal.py, ops/kernels/normal.py).
//
//   philox4x32_10(counter, key): Random123's Philox4x32-10, four 32-bit
//     words from a 128-bit counter under a 64-bit key. The kernels key it
//     on the launch's seed and count Philox blocks of four stream indices.
//   u01(bits): a uniform in (0, 1] from the top 24 bits of a word, + 1 so
//     that log never sees 0, exact in float32.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += kPhiloxW0;
      k.y += kPhiloxW1;
    }
    // One wide multiply each (IMAD.WIDE.U32): its high and low words.
    const uint64_t p0 = (uint64_t)kPhiloxM0 * c.x;
    const uint64_t p1 = (uint64_t)kPhiloxM1 * c.z;
    c = make_uint4((uint32_t)(p1 >> 32) ^ c.y ^ k.x, (uint32_t)p1,
                   (uint32_t)(p0 >> 32) ^ c.w ^ k.y, (uint32_t)p0);
  }
  return c;
}

// The four words of Philox block q (counter (q lo, q hi, 0, 0)) under `key`.
__device__ __forceinline__ uint4 philox_block(uint64_t q, uint2 key) {
  return philox4x32_10(make_uint4((uint32_t)q, (uint32_t)(q >> 32), 0u, 0u), key);
}

// The key of a 64-bit seed: its low and high 32-bit words.
__device__ __host__ __forceinline__ uint2 philox_key(uint64_t seed) {
  return make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
}

// uint32 -> uniform in (0, 1]: the top 24 bits, + 1 so that log never sees
// 0, over 2^24 (one FMA, exact).
__device__ __forceinline__ float u01(uint32_t bits) {
  return fmaf((float)(bits >> 8), 1.f / 16777216.f, 1.f / 16777216.f);
}

}  // namespace
