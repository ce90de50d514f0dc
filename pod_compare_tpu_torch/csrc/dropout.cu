// Counter-based dropout for Hopper (sm_90a), with an optional fused ReLU.
//
// Replaces the Pallas TPU kernel pod_compare_tpu/ops/pallas/dropout.py
// (`_dropout_kernel`, launched by `_run_dropout`, public `hardware_dropout`).
// The TPU kernel draws its bits from the chip's PRNG seeded per (1024, C)
// row block. Hopper has no such generator, so the bits here come from
// Philox4x32-10 keyed on (seed, element index): any launch can replay a mask
// from its seed alone. The backward (`pod_dropout_backward_levels`, the port of
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
// One launch takes a group of up to 8 tensors ("levels": the head runs
// one mask draw per (run, tower, layer) over the five FPN levels P3-P7,
// level l at the stream offset that follows levels < l), each with its
// own pointers, inner, outer and offset, under one seed, threshold, scale
// and relu; a single tensor is the group of one. The levels' chunks of 8
// consecutive inner elements form one flat range; thread t of the grid
// takes chunks t, t + stride, ... of it, walking the levels' chunk
// prefix in order (unrolled over the 8 slots, so every field is read from
// the kernel's parameters at a fixed place), so the threads differ by at
// most one chunk over the whole group however small its levels are.
//
// Bound: memory. It reads x once and writes out once; for one
// (run, tower, layer) of the MC bank at batch 2 in bf16 the P3-P7 levels
// hold 19,620 x 256 x 2 elements, about 20 MB each way, ~12 us at
// 3.35 TB/s: one launch, where one launch per level left P5-P7 (0.56,
// 0.15 and 0.04 us of bytes) to a launch's fixed cost. The design reads
// and writes 16 bytes a thread per access and, in the batch-shared case,
// draws each mask word once and applies it to every image of the batch,
// which divides the Philox work by the batch; a chunk's loads of its
// images (up to four at a time) are all issued before the mask is drawn
// and before any store, so the Philox rounds run while they are in flight. The grid is
// one wave of resident blocks (grid.cuh). The backward reads g and out
// and writes dx: three passes where the forward makes two, ~27 us for a
// per-sample P3 level of a training step (4 x 256 x 92 x 160 in bf16,
// 30.1 MB each).
//
// The wrapper (ops/kernels/dropout.py) guarantees: inner % 8 == 0,
// offset % 4 == 0, every pointer 16-byte aligned, no output aliasing an
// input, at most 8 levels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_rng.cuh"
#include "grid.cuh"

// One level of a grouped launch, as the wrapper passes it. The forward
// reads x; the backward reads g from `x` and, with relu, the forward's
// output from `gate`.
struct PodDropoutLevel {
  const void* x;
  const void* gate;
  void* out;
  long long inner;
  long long outer;
  unsigned long long offset;
};

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 8;

// A group by value, as the kernel's parameters (under 0.5 KB).
template <typename T>
struct Levels {
  const T* x[kMaxLevels];
  const T* gate[kMaxLevels];
  T* out[kMaxLevels];
  int64_t inner[kMaxLevels];
  int64_t outer[kMaxLevels];
  uint64_t offset[kMaxLevels];
  int64_t chunk_end[kMaxLevels];  // chunks of levels 0..l, unused slots the total
  int count;
};

// Eight elements of one chunk, as loaded: two float4 (f32) or one uint4 (bf16).
template <typename T>
struct Raw;
template <>
struct Raw<float> {
  float4 a, b;
};
template <>
struct Raw<__nv_bfloat16> {
  uint4 a;
};

__device__ __forceinline__ Raw<float> load8(const float* p) {
  return {reinterpret_cast<const float4*>(p)[0], reinterpret_cast<const float4*>(p)[1]};
}

__device__ __forceinline__ Raw<__nv_bfloat16> load8(const __nv_bfloat16* p) {
  return {reinterpret_cast<const uint4*>(p)[0]};
}

__device__ __forceinline__ void unpack(const Raw<float>& r, float* v) {
  v[0] = r.a.x; v[1] = r.a.y; v[2] = r.a.z; v[3] = r.a.w;
  v[4] = r.b.x; v[5] = r.b.y; v[6] = r.b.z; v[7] = r.b.w;
}

__device__ __forceinline__ void unpack(const Raw<__nv_bfloat16>& r, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.a);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __bfloat162float(h[k].x);
    v[2 * k + 1] = __bfloat162float(h[k].y);
  }
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
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

// Chunk c of one level: the same 8 inner elements of each of its `outer`
// images, kImages at a time, their loads issued before the mask is drawn
// and before any store. Forward: out = keep ? relu?(x) * scale : 0.
// Backward (x holds g, gate the forward's output): out = keep && (!relu ||
// gate > 0) ? g * scale : 0.
template <typename T, bool kBackward, int kImages>
__device__ __forceinline__ void chunk(const T* __restrict__ x, const T* __restrict__ gate,
                                      T* __restrict__ out, int64_t inner, int64_t outer,
                                      uint64_t offset, int64_t c, uint2 key, uint32_t thresh,
                                      float scale, bool relu) {
  bool keep[8];
  for (int64_t n0 = 0; n0 < outer; n0 += kImages) {
    Raw<T> xs[kImages], gs[kImages];
#pragma unroll
    for (int j = 0; j < kImages; ++j) {
      if (n0 + j < outer) {
        const int64_t base = (n0 + j) * inner + 8 * c;
        xs[j] = load8(x + base);
        if (kBackward && relu) gs[j] = load8(gate + base);
      }
    }
    if (n0 == 0) keep8(offset, c, key, thresh, keep);
#pragma unroll
    for (int j = 0; j < kImages; ++j) {
      if (n0 + j < outer) {
        float v[8], y[8];
        unpack(xs[j], v);
        if (kBackward && relu) unpack(gs[j], y);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (kBackward) {
            v[k] = (keep[k] && (!relu || y[k] > 0.f)) ? v[k] * scale : 0.f;
          } else {
            const float a = relu ? (v[k] > 0.f ? v[k] : 0.f) : v[k];
            v[k] = keep[k] ? a * scale : 0.f;
          }
        }
        store8(out + (n0 + j) * inner + 8 * c, v);
      }
    }
  }
}

// kImages: the registers of that many images' chunks are held at once;
// the launch takes the smallest of 1, 2, 4 that covers the group's largest
// outer (per-sample masks 1, the MC bank's batch 2), so no thread holds
// registers for images it does not have.
template <typename T, bool kBackward, int kImages>
__global__ void __launch_bounds__(kThreads)
    dropout_levels_kernel(const Levels<T> lv, uint2 key, uint32_t thresh, float scale, int relu) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t start = 0;
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l < lv.count) {
      for (; c < lv.chunk_end[l]; c += stride) {
        chunk<T, kBackward, kImages>(lv.x[l], lv.gate[l], lv.out[l], lv.inner[l], lv.outer[l],
                                     lv.offset[l], c - start, key, thresh, scale, relu != 0);
      }
      start = lv.chunk_end[l];
    }
  }
}

template <typename T, bool kBackward, int kImages>
cudaError_t launch_images(const Levels<T>& lv, int64_t chunks, uint2 key, uint32_t thresh,
                          float scale, int relu, cudaStream_t stream) {
  static WaveCache cache;  // one per instance of this function, so per kernel instance
  int blocks = 0;
  const cudaError_t err = wave_blocks(cache, dropout_levels_kernel<T, kBackward, kImages>,
                                      kThreads, (chunks + kThreads - 1) / kThreads, &blocks);
  if (err != cudaSuccess) return err;
  dropout_levels_kernel<T, kBackward, kImages><<<blocks, kThreads, 0, stream>>>(
      lv, key, thresh, scale, relu);
  return cudaGetLastError();
}

template <typename T, bool kBackward>
cudaError_t launch(const PodDropoutLevel* levels, int count, uint2 key, uint32_t thresh,
                   float scale, int relu, cudaStream_t s) {
  Levels<T> lv = {};
  int64_t chunks = 0, outer = 1;
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l < count) {
      const PodDropoutLevel& d = levels[l];
      if (d.inner <= 0 || d.outer <= 0 || d.inner % 8 != 0 || d.offset % 4 != 0 ||
          d.x == nullptr || d.out == nullptr || (kBackward && relu && d.gate == nullptr)) {
        return cudaErrorInvalidValue;
      }
      lv.x[l] = static_cast<const T*>(d.x);
      lv.gate[l] = static_cast<const T*>(d.gate);
      lv.out[l] = static_cast<T*>(d.out);
      lv.inner[l] = d.inner;
      lv.outer[l] = d.outer;
      lv.offset[l] = d.offset;
      chunks += d.inner / 8;
      outer = d.outer > outer ? d.outer : outer;
    }
    lv.chunk_end[l] = chunks;
  }
  lv.count = count;
  if (outer == 1) return launch_images<T, kBackward, 1>(lv, chunks, key, thresh, scale, relu, s);
  if (outer == 2) return launch_images<T, kBackward, 2>(lv, chunks, key, thresh, scale, relu, s);
  return launch_images<T, kBackward, 4>(lv, chunks, key, thresh, scale, relu, s);
}

template <bool kBackward>
int launch_dtype(const PodDropoutLevel* levels, int count, int dtype, unsigned long long seed,
                 unsigned int thresh, float scale, int relu, void* stream) {
  if (levels == nullptr || count <= 0 || count > kMaxLevels) return (int)cudaErrorInvalidValue;
  const uint2 key = philox_key(seed);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float, kBackward>(levels, count, key, thresh, scale, relu, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, kBackward>(levels, count, key, thresh, scale, relu, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for every level. Per level, outer =
// batch when the mask is shared across the batch, else 1 (and inner =
// every element). Returns the launch's cudaError_t; 0 means it was queued
// on `stream`.
extern "C" int pod_dropout_forward_levels(const PodDropoutLevel* levels, int count, int dtype,
                                          unsigned long long seed, unsigned int thresh,
                                          float scale, int relu, void* stream) {
  return launch_dtype<false>(levels, count, dtype, seed, thresh, scale, relu, stream);
}

// The backward of pod_dropout_forward_levels under the same (seed, offsets,
// thresh, scale, relu): per level out = keep && (!relu || gate > 0) ? g *
// scale : 0, with g in each level's `x` and the forward's output in its
// `gate`.
extern "C" int pod_dropout_backward_levels(const PodDropoutLevel* levels, int count, int dtype,
                                           unsigned long long seed, unsigned int thresh,
                                           float scale, int relu, void* stream) {
  return launch_dtype<true>(levels, count, dtype, seed, thresh, scale, relu, stream);
}
