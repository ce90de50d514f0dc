// K3, the FrozenBN epilogue of a backbone convolution, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's FrozenBatchNorm
// (pod_compare_tpu/models/layers.py) is a multiply-add that XLA fuses into
// the convolution's consumers. In PyTorch the same chain, FrozenBN's
// `z * mul + add` broadcast per channel over a channels-last tensor, then
// ReLU and the block's residual add, ran as four to five separate passes,
// the first two in TensorIterator's generic (offset-computed, not
// vectorised) kernel, with a bf16 rounding after each. This kernel makes
// one pass:
//
//   y = relu(z·mul + add [+ r | + (zs·ms + as)])
//
// with z the convolution's raw output, r an identity shortcut, zs the raw
// output of a projection shortcut's convolution with its own FrozenBN
// (ms, as). The per-channel pair is computed here
// from the FrozenBN's float32 buffers exactly as the plain version's
// PyTorch operations do (mul = weight·rsqrt(var + eps), add = bias −
// mean·mul, each in its own float32 rounding, then both rounded to the
// tensor's dtype), and the chain in float32 in that order with no
// contraction (__fmul_rn, __fadd_rn), rounded once to the output dtype;
// ReLU is PyTorch's clamp_min (NaN passes, else fmaxf(v, 0)). So kernel and
// plain version (ops/kernels/frozen_bn.py) agree bit for bit.
//
// The backward reads the cotangent g and the forward's output y:
//
//   gm = y <= 0 ? 0 : g                       (PyTorch's threshold_backward)
//   gz = gm·mul,   gr = gm   or   gzs = gm·ms
//
// each rounded once to the dtype, and writes only the gradients asked for.
//
// Bound: memory. Forward: read z (and r or zs), write y; backward: read g
// and y, write gz (and gr or gzs). For X101-32x8d-FPN training at batch
// 16, 736x1280, bf16, that is about 42 GB forward and 43 GB backward a
// step, 25.4 ms at 3.35 TB/s (portbench/counts/epilogues.py). The design:
// each thread moves chunks of 8 consecutive elements (16 bytes in bf16,
// two 16-byte accesses in float32), read with streaming (evict-first)
// loads since every input is read once; in channels-last memory a
// grid-stride loop whose stride is a multiple of C/8 chunks keeps each
// thread on the same 8 channels, so their pairs are computed once into
// registers; each pass of the loop issues the loads of two chunks before
// any arithmetic; one wave of resident blocks (grid.cuh); no shared
// memory. In NCHW memory the channel changes along the chunks, and a
// thread recomputes the pair where it does.
//
// The FrozenBN buffers are float32 in training and in a float32 model, and
// bfloat16 in a model cast for bfloat16 inference (its convolutions cast
// with their FrozenBNs, its activations bfloat16); in bfloat16 each
// operation of the pair is rounded to bfloat16, as PyTorch's operations on
// those buffers round. So there are three instances of (tensor, buffer)
// dtypes: (f32, f32), (bf16, f32) and (bf16, bf16).
//
// The wrapper (ops/kernels/frozen_bn.py) guarantees: every tensor 4-D,
// dense in the same memory format (channels-last or NCHW), C % 8 == 0,
// every pointer 16-byte aligned, no output aliasing an input, every
// buffer of C elements in one dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid.cuh"

namespace {

constexpr int kThreads = 256;

// One FrozenBN's buffers, C each, in S (float32, or bfloat16 in a model
// cast for inference), and its eps.
template <typename S>
struct Norm {
  const S* weight;
  const S* bias;
  const S* mean;
  const S* var;
  float eps;
};

// Eight consecutive elements, as loaded: two float4 (f32) or one uint4 (bf16).
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
  const float4* q = reinterpret_cast<const float4*>(p);
  return {__ldcs(q), __ldcs(q + 1)};
}

__device__ __forceinline__ Raw<__nv_bfloat16> load8(const __nv_bfloat16* p) {
  return {__ldcs(reinterpret_cast<const uint4*>(p))};
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

// v rounded to T and back: the plain version's cast of the pair.
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// mul = weight·rsqrt(var + eps) as PyTorch's operations on S tensors give
// it: each operation in float32, rounded to S (PyTorch's CUDA rsqrt is
// rsqrtf).
template <typename S>
__device__ __forceinline__ float scale_of(const Norm<S>& n, int c) {
  const float v = round_to<S>(__fadd_rn(load1(n.var + c), n.eps));
  return round_to<S>(__fmul_rn(load1(n.weight + c), round_to<S>(rsqrtf(v))));
}

// Channel c's (mul, add) rounded to T, as the plain version casts them.
template <typename T, typename S>
__device__ __forceinline__ void pair_of(const Norm<S>& n, int c, float& mul, float& add) {
  const float m = scale_of(n, c);
  mul = round_to<T>(m);
  add = round_to<T>(
      round_to<S>(__fsub_rn(load1(n.bias + c), round_to<S>(__fmul_rn(load1(n.mean + c), m)))));
}

__device__ __forceinline__ float relu(float v) { return isnan(v) ? v : fmaxf(v, 0.f); }

// Forward arguments. side_kind: 0 none, 1 identity residual, 2 projection
// shortcut (side holds zs, norm_s its FrozenBN).
template <typename T, typename S>
struct Fwd {
  const T* z;
  const T* side;
  T* y;
  Norm<S> norm, norm_s;
  int64_t chunks;  // numel / 8
  int64_t hw;      // H·W (NCHW only)
  int channels;
  int side_kind;
};

// Backward arguments. gz, gside: null when that gradient is not asked for;
// has_norm_s: gside = gm·ms, else gm.
template <typename T, typename S>
struct Bwd {
  const T* g;
  const T* y;
  T* gz;
  T* gside;
  Norm<S> norm, norm_s;
  int64_t chunks;
  int64_t hw;
  int channels;
  int has_norm_s;
};

// The per-element arithmetic of one chunk given each element's pair.
template <typename T, typename S>
__device__ __forceinline__ void forward_math(const Fwd<T, S>& a, float* v, const float* s,
                                             const float* mul, const float* add,
                                             const float* ms, const float* as) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float t = __fadd_rn(__fmul_rn(v[k], mul[k]), add[k]);
    if (a.side_kind == 1) t = __fadd_rn(t, s[k]);
    if (a.side_kind == 2) t = __fadd_rn(t, __fadd_rn(__fmul_rn(s[k], ms[k]), as[k]));
    v[k] = relu(t);
  }
}

template <typename T, typename S>
__device__ __forceinline__ void backward_math(const Bwd<T, S>& a, const float* g, const float* y,
                                              const float* mul, const float* ms, float* gz,
                                              float* gs) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float gm = y[k] <= 0.f ? 0.f : g[k];
    gz[k] = __fmul_rn(gm, mul[k]);
    gs[k] = a.has_norm_s ? __fmul_rn(gm, ms[k]) : gm;
  }
}

// The pairs of the 8 elements of chunk i in NCHW memory: element e lies in
// channel ((8i + e) / hw) % C; recomputed only where the channel changes.
template <typename T, typename S>
__device__ __forceinline__ void nchw_pairs(const Norm<S>& n, const Norm<S>& ns, bool proj,
                                           int64_t i, int64_t hw, int channels, bool shift,
                                           float* mul, float* add, float* ms, float* as) {
  const int64_t e0 = 8 * i;
  const int64_t q = e0 / hw;
  int64_t rem = e0 - q * hw;
  int c = (int)(q % channels);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (k > 0 && ++rem == hw) {
      rem = 0;
      c = c + 1 == channels ? 0 : c + 1;
    }
    if (k == 0 || rem == 0) {
      if (shift) {
        pair_of<T, S>(n, c, mul[k], add[k]);
        if (proj) pair_of<T, S>(ns, c, ms[k], as[k]);
      } else {
        mul[k] = round_to<T>(scale_of(n, c));
        if (proj) ms[k] = round_to<T>(scale_of(ns, c));
      }
    } else {
      mul[k] = mul[k - 1];
      if (shift) add[k] = add[k - 1];
      if (proj) {
        ms[k] = ms[k - 1];
        if (shift) as[k] = as[k - 1];
      }
    }
  }
}

// Chunk i of the forward with its pairs, loads already issued into zr, sr.
template <typename T, typename S>
__device__ __forceinline__ void forward_store(const Fwd<T, S>& a, int64_t i, const Raw<T>& zr,
                                              const Raw<T>& sr, const float* mul,
                                              const float* add, const float* ms,
                                              const float* as) {
  float v[8], s[8];
  unpack(zr, v);
  if (a.side_kind) unpack(sr, s);
  forward_math(a, v, s, mul, add, ms, as);
  store8(a.y + 8 * i, v);
}

template <typename T, typename S>
__device__ __forceinline__ void backward_store(const Bwd<T, S>& a, int64_t i, const Raw<T>& gr,
                                               const Raw<T>& yr, const float* mul,
                                               const float* ms) {
  float g[8], y[8], gz[8], gs[8];
  unpack(gr, g);
  unpack(yr, y);
  backward_math(a, g, y, mul, ms, gz, gs);
  if (a.gz) store8(a.gz + 8 * i, gz);
  if (a.gside) store8(a.gside + 8 * i, gs);
}

// kChannelsLast: the grid's stride is a multiple of C/8 chunks, so thread
// t's chunks all hold channels 8·(t % (C/8)) .. +7; the launch sets it.
template <typename T, typename S, bool kChannelsLast>
__global__ void __launch_bounds__(kThreads) pod_frozen_bn_forward(const Fwd<T, S> a,
                                                                  int64_t stride) {
  int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= stride) return;
  float mul[8], add[8], ms[8], as[8];
  const bool proj = a.side_kind == 2;
  if (kChannelsLast) {
    const int c0 = (int)(i % (a.channels / 8)) * 8;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      pair_of<T, S>(a.norm, c0 + k, mul[k], add[k]);
      if (proj) pair_of<T, S>(a.norm_s, c0 + k, ms[k], as[k]);
    }
  }
  for (; i < a.chunks; i += 2 * stride) {
    const int64_t j = i + stride;
    const bool two = j < a.chunks;
    Raw<T> z0 = load8(a.z + 8 * i), z1 = {}, s0 = {}, s1 = {};
    if (two) z1 = load8(a.z + 8 * j);
    if (a.side_kind) {
      s0 = load8(a.side + 8 * i);
      if (two) s1 = load8(a.side + 8 * j);
    }
    if (!kChannelsLast)
      nchw_pairs<T>(a.norm, a.norm_s, proj, i, a.hw, a.channels, true, mul, add, ms, as);
    forward_store(a, i, z0, s0, mul, add, ms, as);
    if (two) {
      if (!kChannelsLast)
        nchw_pairs<T>(a.norm, a.norm_s, proj, j, a.hw, a.channels, true, mul, add, ms, as);
      forward_store(a, j, z1, s1, mul, add, ms, as);
    }
  }
}

template <typename T, typename S, bool kChannelsLast>
__global__ void __launch_bounds__(kThreads) pod_frozen_bn_backward(const Bwd<T, S> a,
                                                                   int64_t stride) {
  int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= stride) return;
  float mul[8], ms[8];
  const bool proj = a.has_norm_s != 0;
  if (kChannelsLast) {
    const int c0 = (int)(i % (a.channels / 8)) * 8;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      mul[k] = round_to<T>(scale_of(a.norm, c0 + k));
      if (proj) ms[k] = round_to<T>(scale_of(a.norm_s, c0 + k));
    }
  }
  for (; i < a.chunks; i += 2 * stride) {
    const int64_t j = i + stride;
    const bool two = j < a.chunks;
    Raw<T> g0 = load8(a.g + 8 * i), y0 = load8(a.y + 8 * i), g1 = {}, y1 = {};
    if (two) {
      g1 = load8(a.g + 8 * j);
      y1 = load8(a.y + 8 * j);
    }
    if (!kChannelsLast)
      nchw_pairs<T>(a.norm, a.norm_s, proj, i, a.hw, a.channels, false, mul, nullptr, ms,
                    nullptr);
    backward_store(a, i, g0, y0, mul, ms);
    if (two) {
      if (!kChannelsLast)
        nchw_pairs<T>(a.norm, a.norm_s, proj, j, a.hw, a.channels, false, mul, nullptr, ms,
                      nullptr);
      backward_store(a, j, g1, y1, mul, ms);
    }
  }
}

// The grid's thread count: one wave of resident blocks, but no more
// threads than chunks; in channels-last memory a multiple of C/8.
template <typename Kernel>
cudaError_t grid_of(WaveCache& cache, Kernel kernel, int64_t chunks, int channels,
                    bool channels_last, int64_t* stride, int* blocks) {
  int wave = 0;
  const cudaError_t err = wave_blocks(cache, kernel, kThreads,
                                      (chunks + kThreads - 1) / kThreads, &wave);
  if (err != cudaSuccess) return err;
  int64_t threads = (int64_t)wave * kThreads;
  if (threads > chunks) threads = chunks;
  if (channels_last) {
    const int64_t cols = channels / 8;
    threads = threads / cols * cols;
    if (threads < cols) threads = cols;
  }
  *stride = threads;
  *blocks = (int)((threads + kThreads - 1) / kThreads);
  return cudaSuccess;
}

template <typename T, typename S, bool kChannelsLast>
cudaError_t launch_forward(const Fwd<T, S>& a, cudaStream_t stream) {
  static WaveCache cache;  // one per kernel instance
  int64_t stride = 0;
  int blocks = 0;
  const cudaError_t err = grid_of(cache, pod_frozen_bn_forward<T, S, kChannelsLast>, a.chunks,
                                  a.channels, kChannelsLast, &stride, &blocks);
  if (err != cudaSuccess) return err;
  pod_frozen_bn_forward<T, S, kChannelsLast><<<blocks, kThreads, 0, stream>>>(a, stride);
  return cudaGetLastError();
}

template <typename T, typename S, bool kChannelsLast>
cudaError_t launch_backward(const Bwd<T, S>& a, cudaStream_t stream) {
  static WaveCache cache;
  int64_t stride = 0;
  int blocks = 0;
  const cudaError_t err = grid_of(cache, pod_frozen_bn_backward<T, S, kChannelsLast>, a.chunks,
                                  a.channels, kChannelsLast, &stride, &blocks);
  if (err != cudaSuccess) return err;
  pod_frozen_bn_backward<T, S, kChannelsLast><<<blocks, kThreads, 0, stream>>>(a, stride);
  return cudaGetLastError();
}

bool valid_shape(long long numel, int channels, long long hw) {
  return numel > 0 && channels > 0 && channels % 8 == 0 && hw > 0 && numel % channels == 0;
}

// The buffers of a FrozenBN, as the C interface passes them.
struct Buffers {
  const void* weight;
  const void* bias;
  const void* mean;
  const void* var;
  float eps;

  template <typename S>
  Norm<S> as() const {
    return {static_cast<const S*>(weight), static_cast<const S*>(bias),
            static_cast<const S*>(mean), static_cast<const S*>(var), eps};
  }
};

template <typename T, typename S>
int forward_typed(int channels_last, const void* z, const void* side, int side_kind, void* y,
                  const Buffers& norm, const Buffers& norm_s, long long numel, int channels,
                  long long hw, cudaStream_t s) {
  const Fwd<T, S> a = {static_cast<const T*>(z), static_cast<const T*>(side), static_cast<T*>(y),
                       norm.as<S>(), norm_s.as<S>(), numel / 8, hw, channels, side_kind};
  return (int)(channels_last ? launch_forward<T, S, true>(a, s)
                             : launch_forward<T, S, false>(a, s));
}

template <typename T, typename S>
int backward_typed(int channels_last, const void* g, const void* y, void* gz, void* gside,
                   const Buffers& norm, const Buffers& norm_s, int has_norm_s, long long numel,
                   int channels, long long hw, cudaStream_t s) {
  const Bwd<T, S> a = {static_cast<const T*>(g), static_cast<const T*>(y), static_cast<T*>(gz),
                       static_cast<T*>(gside), norm.as<S>(), norm_s.as<S>(), numel / 8, hw,
                       channels, has_norm_s};
  return (int)(channels_last ? launch_backward<T, S, true>(a, s)
                             : launch_backward<T, S, false>(a, s));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 for z, side and y; stats_dtype the same
// for every FrozenBN buffer, bfloat16 only with dtype bfloat16. channels_last: 1 for NHWC memory, 0 for NCHW.
// side_kind: 0 none, 1 identity residual (side = r), 2 projection shortcut
// (side = zs, with the FrozenBN *_s). numel: z's elements; hw: H·W.
// Returns the launch's cudaError_t; 0 means it was queued on `stream`.
extern "C" int pod_frozen_bn_forward_launch(
    int dtype, int stats_dtype, int channels_last, const void* z, const void* side,
    int side_kind, void* y, const void* weight, const void* bias, const void* mean,
    const void* var, float eps, const void* weight_s, const void* bias_s, const void* mean_s,
    const void* var_s, float eps_s, long long numel, int channels, long long hw, void* stream) {
  if (!valid_shape(numel, channels, hw) || z == nullptr || y == nullptr || side_kind < 0 ||
      side_kind > 2 || (side_kind && side == nullptr) ||
      (side_kind == 2 && (weight_s == nullptr || var_s == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const Buffers norm = {weight, bias, mean, var, eps};
  const Buffers norm_s = {weight_s, bias_s, mean_s, var_s, eps_s};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int code = 2 * dtype + stats_dtype;
  if (code == 0)
    return forward_typed<float, float>(channels_last, z, side, side_kind, y, norm, norm_s, numel,
                                       channels, hw, s);
  if (code == 2)
    return forward_typed<__nv_bfloat16, float>(channels_last, z, side, side_kind, y, norm,
                                               norm_s, numel, channels, hw, s);
  if (code == 3)
    return forward_typed<__nv_bfloat16, __nv_bfloat16>(channels_last, z, side, side_kind, y,
                                                       norm, norm_s, numel, channels, hw, s);
  return (int)cudaErrorInvalidValue;
}

// The backward of pod_frozen_bn_forward_launch for the cotangent g (in y's
// memory format), given its output y: gz = gm·mul where gz is not null,
// gside = gm·ms (weight_s given) or gm where gside is not null. Only weight
// and var of each FrozenBN are read.
extern "C" int pod_frozen_bn_backward_launch(
    int dtype, int stats_dtype, int channels_last, const void* g, const void* y, void* gz,
    void* gside, const void* weight, const void* var, float eps, const void* weight_s,
    const void* var_s, float eps_s, long long numel, int channels, long long hw, void* stream) {
  if (!valid_shape(numel, channels, hw) || g == nullptr || y == nullptr ||
      (gz == nullptr && gside == nullptr) || (weight_s == nullptr) != (var_s == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Buffers norm = {weight, nullptr, nullptr, var, eps};
  const Buffers norm_s = {weight_s, nullptr, nullptr, var_s, eps_s};
  const int has_norm_s = weight_s != nullptr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int code = 2 * dtype + stats_dtype;
  if (code == 0)
    return backward_typed<float, float>(channels_last, g, y, gz, gside, norm, norm_s, has_norm_s,
                                        numel, channels, hw, s);
  if (code == 2)
    return backward_typed<__nv_bfloat16, float>(channels_last, g, y, gz, gside, norm, norm_s,
                                                has_norm_s, numel, channels, hw, s);
  if (code == 3)
    return backward_typed<__nv_bfloat16, __nv_bfloat16>(channels_last, g, y, gz, gside, norm,
                                                        norm_s, has_norm_s, numel, channels, hw,
                                                        s);
  return (int)cudaErrorInvalidValue;
}
