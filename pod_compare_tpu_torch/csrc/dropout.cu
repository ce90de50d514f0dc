// Counter-based dropout for Hopper (sm_90a), with an optional fused ReLU.
//
// Replaces the Pallas TPU kernel pod_compare_tpu/ops/pallas/dropout.py
// (`_dropout_kernel`, launched by `_run_dropout`, public `hardware_dropout`).
// The TPU kernel draws its bits from the chip's PRNG seeded per (1024, C)
// row block. Hopper has no such generator, so the bits here come from
// Philox4x32-10 keyed on (seed, element index): any launch can replay a mask
// from its seed alone. The backward (`pod_dropout_backward`, the port of
// `_hw_dropout_bwd`) does exactly that on the cotangent, so no mask is ever
// stored.
//
//   idx   = offset + (batch_shared ? i % inner : i)
//   bits  = Philox4x32-10(key = seed, counter = idx / 4)[idx % 4]
//   keep  = bits < thresh                  (uint32; thresh = floor(keep·2^32))
//   out   = keep ? x·scale : 0             (scale = 1/keep in x's dtype)
//
// With relu, x is replaced by (x > 0 ? x : 0) first: the head's ReLU and
// its dropout in one read and one write. The backward of that is
//
//   dx    = keep && (!relu || out > 0) ? g·scale : 0
//
// where out, the forward's output, is kept by autograd anyway as the next
// conv's input.
//
// Bound: memory. It reads x once and writes out once; for one
// (run, tower, layer) of the MC bank at batch 2 in bf16 the P3-P7 levels
// hold 19,620 x 256 x 2 elements, about 20 MB each way, ~12 us at
// 3.35 TB/s. The design reads and writes 16 bytes a thread per access and,
// in the batch-shared case, draws each mask word once and applies it to
// every image of the batch, which divides the Philox work by the batch.
// The backward reads g and out and writes dx: three passes where the
// forward makes two, ~27 us for a per-sample P3 level of a training step
// (4 x 256 x 92 x 160 in bf16, 30.1 MB each).
//
// The wrapper (ops/kernels/dropout.py) guarantees: inner % 8 == 0,
// offset % 4 == 0, both pointers 16-byte aligned, x and out not aliased.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_rng.cuh"

namespace {

__device__ __forceinline__ float apply(float v, bool keep, bool relu, float scale) {
  if (relu) v = v > 0.f ? v : 0.f;
  return keep ? v * scale : 0.f;
}

// Eight elements of one chunk: two float4 (f32) or one uint4 (bf16).
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 raw = reinterpret_cast<const uint4*>(p)[0];
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __bfloat162float(h[k].x);
    v[2 * k + 1] = __bfloat162float(h[k].y);
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    h[k].x = __float2bfloat16_rn(v[2 * k]);
    h[k].y = __float2bfloat16_rn(v[2 * k + 1]);
  }
  reinterpret_cast<uint4*>(p)[0] = raw;
}

// Keep decisions of the chunk of 8 consecutive stream indices starting at
// offset + 8c: two Philox blocks of four words.
__device__ __forceinline__ void keep8(uint64_t offset, int64_t c, uint2 key, uint32_t thresh,
                                      bool* keep) {
  const uint64_t q = (offset >> 2) + 2 * (uint64_t)c;
  const uint4 r0 = philox_block(q, key);
  const uint4 r1 = philox_block(q + 1, key);
  const uint32_t bits[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
#pragma unroll
  for (int k = 0; k < 8; ++k) keep[k] = bits[k] < thresh;
}

// One thread per chunk of 8 consecutive elements of the inner range, in a
// grid-stride loop; the chunk's mask applies to all `outer` copies.
template <typename T>
__global__ void dropout_kernel(const T* __restrict__ x, T* __restrict__ out,
                               int64_t inner, int64_t outer, uint64_t offset,
                               uint2 key, uint32_t thresh, float scale, int relu) {
  const int64_t chunks = inner / 8;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; c < chunks; c += stride) {
    bool keep[8];
    keep8(offset, c, key, thresh, keep);
    for (int64_t n = 0; n < outer; ++n) {
      const int64_t base = n * inner + 8 * c;
      float v[8];
      load8(x + base, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = apply(v[k], keep[k], relu != 0, scale);
      store8(out + base, v);
    }
  }
}

// The backward: the same chunks and the same mask, replayed from the seed,
// on the cotangent g. With relu, `gate` is the forward's output, positive
// exactly where the forward kept a positive input; no mask is stored.
template <typename T>
__global__ void dropout_backward_kernel(const T* __restrict__ g, const T* __restrict__ gate,
                                        T* __restrict__ out, int64_t inner, int64_t outer,
                                        uint64_t offset, uint2 key, uint32_t thresh,
                                        float scale, int relu) {
  const int64_t chunks = inner / 8;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; c < chunks; c += stride) {
    bool keep[8];
    keep8(offset, c, key, thresh, keep);
    for (int64_t n = 0; n < outer; ++n) {
      const int64_t base = n * inner + 8 * c;
      float v[8], y[8];
      load8(g + base, v);
      if (relu) load8(gate + base, y);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        v[k] = (keep[k] && (!relu || y[k] > 0.f)) ? v[k] * scale : 0.f;
      }
      store8(out + base, v);
    }
  }
}

int grid_for(int64_t inner, int threads) {
  const int64_t chunks = inner / 8;
  const int64_t max_blocks = 132 * 32;
  const int64_t want = (chunks + threads - 1) / threads;
  return (int)(want < max_blocks ? want : max_blocks);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. outer = batch when the mask is shared
// across the batch, else 1 (and inner = every element). Returns the launch's
// cudaError_t; 0 means it was queued on `stream`.
extern "C" int pod_dropout_forward(const void* x, void* out, int dtype, long long inner,
                                   long long outer, unsigned long long offset,
                                   unsigned long long seed, unsigned int thresh, float scale,
                                   int relu, void* stream) {
  if (inner <= 0 || outer <= 0 || inner % 8 != 0 || offset % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const uint2 key = philox_key(seed);
  const int threads = 256;
  const int blocks = grid_for(inner, threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dropout_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), inner, outer, offset, key,
        thresh, scale, relu);
  } else if (dtype == 1) {
    dropout_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), inner, outer,
        offset, key, thresh, scale, relu);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The backward of pod_dropout_forward under the same (seed, offset, thresh,
// scale, relu): out = keep && (!relu || gate > 0) ? g * scale : 0, where
// gate is the forward's output. Same layout contract as the forward.
extern "C" int pod_dropout_backward(const void* g, const void* gate, void* out, int dtype,
                                    long long inner, long long outer, unsigned long long offset,
                                    unsigned long long seed, unsigned int thresh, float scale,
                                    int relu, void* stream) {
  if (inner <= 0 || outer <= 0 || inner % 8 != 0 || offset % 4 != 0 ||
      (relu && gate == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const uint2 key = philox_key(seed);
  const int threads = 256;
  const int blocks = grid_for(inner, threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dropout_backward_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(gate), static_cast<float*>(out),
        inner, outer, offset, key, thresh, scale, relu);
  } else if (dtype == 1) {
    dropout_backward_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(gate),
        static_cast<__nv_bfloat16*>(out), inner, outer, offset, key, thresh, scale, relu);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
