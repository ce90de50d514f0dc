// Class-aware greedy NMS for Hopper (sm_90a): one thread block, one launch
// a call.
//
// Replaces no Pallas kernel: the JAX package's NMS is a lax.scan
// (pod_compare_tpu/ops/nms.py, batched_nms and nms), and the port's plain
// version a Python loop of max_out steps (ops/kernels/nms.py,
// batched_nms_plain), about 24 PyTorch operations a step. This kernel is
// the CUDA kernel of the operator pod_compare_tpu_torch::batched_nms, whose
// CPU kernel is that loop.
//
// What it computes, with the plain version's operations in its order, each
// written as a round-to-nearest intrinsic so that nvcc contracts nothing
// into an FMA, and min/max that let a NaN through as torch.minimum and
// torch.maximum do:
//
//   max_coord = max over valid boxes' coordinates (0 for an invalid row) + 1
//   box_i     = box_i + (float)class_i * max_coord
//   area_i    = max(x2 - x1, 0) * max(y2 - y1, 0)
//   cur_i     = valid_i ? score_i : -1e10
//   step s    idx = argmax cur (ties to the lower index, a NaN wins as in
//             torch.argmax); ok = cur[idx] > -5e9;
//             iou_i = union > 0 ? inter / union : 0, union = (area_idx +
//             area_i) - inter, inter the clamped overlap's product;
//             cur_i = -1e10 where ok && iou_i > threshold; cur[idx] = -1e10;
//             out (idx, ok).
//
// The output therefore equals the plain version's bit for bit: its indices
// and validity follow from comparisons of the same float32 values. Where the
// overlap is 0 the division is skipped (0 / union is 0, and so is the
// comparison's outcome). Once the largest live score is -1e10 itself (no
// NaN, nothing above), every later step of the plain loop picks the same
// index with ok false; the kernel writes those slots and stops.
//
// Bound: the dependency chain. The bytes are trivial (the flagship's 4,540
// candidates are about 130 KB read once, 0.04 us at 3.35 TB/s) and the
// arithmetic small (about 25 operations a candidate a step); each of the
// max_out steps needs the whole block's argmax before its suppression can
// start. So one block holds every candidate on one SM for all steps, and a
// step is: each thread's argmax over its own candidates, fused into the
// previous step's suppression pass; a warp's argmax in two redux.sync
// (__reduce_max_sync of the score's order-preserving key, then
// __reduce_min_sync of the index among the lanes that hold it); one
// __syncthreads, after which every warp reduces the warp winners itself
// (double-buffered, so no second barrier); the winner's box read from
// shared memory by every thread (one broadcast); one suppression pass.
//
// Instances, chosen from n: a thread owns candidates t, t + T, ..., K of
// them, whose live score, offset box and area stay in registers, and the
// offset boxes and areas also sit in dynamic shared memory (20 B a
// candidate) for the winner's lookup: <256, 4> up to 1,024 candidates
// (black_box_merge's M x 100), <1024, 5> up to 5,120 (the pre-NMS paths'
// 4,540). Above that, <1024, 0> keeps the live scores in shared memory and
// reads each box from global memory (L1/L2), recomputing its offset and
// area, up to kMaxGlobal candidates. pod_nms_chain runs the same steps'
// reductions and barrier with no candidates: the latency floor.
//
// The wrapper (ops/kernels/nms.py) guarantees: float32 boxes (n, 4) and
// scores (n,), int64 classes, bool valid, all contiguous on the current
// device; 1 <= n <= kMaxGlobal; max_out >= 1.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float kDead = -1e10f;  // the plain version's _NEG_INF
constexpr float kLive = -5e9f;   // ok: the winner's score above _NEG_INF / 2
constexpr unsigned kAll = 0xffffffffu;
constexpr int kMaxRegisters = 5120;  // the largest register instance, <1024, 5>
constexpr int kMaxGlobal = 49152;    // 192 KB of live scores in shared memory

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// An unsigned key in the order torch.argmax sees the floats: -0 and +0
// equal, every NaN above everything (all NaNs one key, so the lower index
// wins among them). Real keys are above 0, which pads.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = v == 0.f ? 0u : __float_as_uint(v);
  const unsigned k = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return v != v ? kAll : k;
}

__device__ __forceinline__ float4 offset_box(const float* __restrict__ boxes,
                                             const int64_t* __restrict__ classes, int i,
                                             float max_coord) {
  const float off =
      __fmul_rn((float)__ldg(reinterpret_cast<const long long*>(classes) + i), max_coord);
  const float* b = boxes + 4 * (int64_t)i;
  return make_float4(__fadd_rn(__ldg(b), off), __fadd_rn(__ldg(b + 1), off),
                     __fadd_rn(__ldg(b + 2), off), __fadd_rn(__ldg(b + 3), off));
}

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(max_nan(__fsub_rn(b.z, b.x), 0.f), max_nan(__fsub_rn(b.w, b.y), 0.f));
}

// iou(w, b) > threshold, with ops/kernels/nms.py's operations in its order.
__device__ __forceinline__ bool overlaps(float4 w, float wa, float4 b, float ba, float threshold) {
  const float iw = max_nan(__fsub_rn(min_nan(w.z, b.z), max_nan(w.x, b.x)), 0.f);
  const float ih = max_nan(__fsub_rn(min_nan(w.w, b.w), max_nan(w.y, b.y)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(wa, ba), inter);
  float iou = 0.f;
  if (uni > 0.f && inter != 0.f) iou = __fdiv_rn(inter, uni);
  return iou > threshold;
}

// The block's argmax: each warp's in two redux.sync, written to one half of
// the double buffer; one barrier; then every warp reduces the warp winners.
template <int THREADS>
__device__ __forceinline__ void block_argmax(unsigned key, unsigned idx, int step,
                                             unsigned (*red_key)[THREADS / 32],
                                             unsigned (*red_idx)[THREADS / 32],
                                             unsigned& win_key, unsigned& win_idx) {
  constexpr int kWarps = THREADS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, half = step & 1;
  const unsigned wk = __reduce_max_sync(kAll, key);
  const unsigned wi = __reduce_min_sync(kAll, key == wk ? idx : kAll);
  if (lane == 0) {
    red_key[half][warp] = wk;
    red_idx[half][warp] = wi;
  }
  __syncthreads();
  const unsigned k = lane < kWarps ? red_key[half][lane] : 0u;
  const unsigned i = lane < kWarps ? red_idx[half][lane] : kAll;
  win_key = __reduce_max_sync(kAll, k);
  win_idx = __reduce_min_sync(kAll, k == win_key ? i : kAll);
}

// K > 0: K candidates a thread in registers, the offset boxes and areas
// also in dynamic shared memory. K == 0: the live scores in dynamic shared
// memory, the boxes from global memory.
template <int THREADS, int K>
__global__ void __launch_bounds__(THREADS)
nms_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
           const int64_t* __restrict__ classes, const uint8_t* __restrict__ valid, int n,
           int max_out, float threshold, int64_t* __restrict__ out_idx,
           uint8_t* __restrict__ out_ok) {
  constexpr int kWarps = THREADS / 32;
  extern __shared__ float4 dyn[];
  __shared__ unsigned red_key[2][kWarps], red_idx[2][kWarps];
  __shared__ float red_max[kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned dead_key = order_key(kDead), live_key = order_key(kLive);

  // max_coord: torch.where(valid, boxes, 0).max() + 1, exact in any order.
  float m = -__int_as_float(0x7f800000);
  for (int i = t; i < n; i += THREADS) {
    if (valid[i]) {
      const float* b = boxes + 4 * (int64_t)i;
      m = max_nan(m, max_nan(max_nan(__ldg(b), __ldg(b + 1)), max_nan(__ldg(b + 2), __ldg(b + 3))));
    } else {
      m = max_nan(m, 0.f);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) m = max_nan(m, __shfl_xor_sync(kAll, m, d));
  if (lane == 0) red_max[warp] = m;
  __syncthreads();
  m = red_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = max_nan(m, red_max[w]);
  const float max_coord = __fadd_rn(m, 1.f);

  float4* table = dyn;                                  // K > 0: n offset boxes,
  float* areas = reinterpret_cast<float*>(dyn + n);     // then n areas
  float* live = reinterpret_cast<float*>(dyn);          // K == 0: n live scores
  constexpr int kSlots = K > 0 ? K : 1;
  float cur[kSlots], area[kSlots];
  float4 box[kSlots];
  unsigned best_key = 0u, best_idx = kAll;
  if constexpr (K > 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = t + k * THREADS;
      if (i < n) {
        box[k] = offset_box(boxes, classes, i, max_coord);
        area[k] = area_of(box[k]);
        cur[k] = valid[i] ? __ldg(scores + i) : kDead;
        table[i] = box[k];
        areas[i] = area[k];
        const unsigned key = order_key(cur[k]);
        if (key > best_key) best_key = key, best_idx = i;
      }
    }
  } else {
    for (int i = t; i < n; i += THREADS) {
      const float c = valid[i] ? __ldg(scores + i) : kDead;
      live[i] = c;
      const unsigned key = order_key(c);
      if (key > best_key) best_key = key, best_idx = i;
    }
  }
  __syncthreads();

  for (int s = 0; s < max_out; ++s) {
    unsigned key, win;
    block_argmax<THREADS>(best_key, best_idx, s, red_key, red_idx, key, win);
    const bool ok = key != kAll && key > live_key;
    if (t == 0) {
      out_idx[s] = win;
      out_ok[s] = ok;
    }
    if (key == dead_key) {  // nothing left above -1e10: the same index, unkept
      for (int j = s + 1 + t; j < max_out; j += THREADS) {
        out_idx[j] = win;
        out_ok[j] = 0;
      }
      return;
    }
    float4 wb = make_float4(0.f, 0.f, 0.f, 0.f);
    float wa = 0.f;
    if (ok) {
      if constexpr (K > 0) {
        wb = table[win];
        wa = areas[win];
      } else {
        wb = offset_box(boxes, classes, (int)win, max_coord);
        wa = area_of(wb);
      }
    }
    best_key = 0u;
    best_idx = kAll;
    if constexpr (K > 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int i = t + k * THREADS;
        if (i < n) {
          if (i == (int)win || (ok && cur[k] != kDead && overlaps(wb, wa, box[k], area[k], threshold)))
            cur[k] = kDead;
          const unsigned ck = order_key(cur[k]);
          if (ck > best_key) best_key = ck, best_idx = i;
        }
      }
    } else {
      for (int i = t; i < n; i += THREADS) {
        float c = live[i];
        if (i == (int)win) {
          c = kDead;
        } else if (ok && c != kDead) {
          const float4 b = offset_box(boxes, classes, i, max_coord);
          if (overlaps(wb, wa, b, area_of(b), threshold)) c = kDead;
        }
        live[i] = c;
        const unsigned ck = order_key(c);
        if (ck > best_key) best_key = ck, best_idx = i;
      }
    }
  }
}

// The same steps' reductions and barrier with nothing to reduce but a key
// that depends on the last winner: the dependency chain alone.
template <int THREADS>
__global__ void __launch_bounds__(THREADS) chain_kernel(int steps, int64_t* __restrict__ out) {
  constexpr int kWarps = THREADS / 32;
  __shared__ unsigned red_key[2][kWarps], red_idx[2][kWarps];
  const unsigned t = threadIdx.x;
  unsigned key = (t * 2654435761u) | 1u, win = 0u;
  for (int s = 0; s < steps; ++s) {
    unsigned k;
    block_argmax<THREADS>(key, t, s, red_key, red_idx, k, win);
    key = ((t ^ win) * 2654435761u) | 1u;
  }
  if (t == 0) out[0] = win;
}

// Which devices an instance may already take its largest dynamic shared
// memory on: the attribute is set once per instance and device, not on
// every launch (nor inside a CUDA graph's capture).
struct SmemAllowed {
  std::atomic<unsigned long long> devices{0};
};

template <int THREADS, int K>
cudaError_t launch(const float* boxes, const float* scores, const int64_t* classes,
                   const uint8_t* valid, int n, int max_out, float threshold, int64_t* out_idx,
                   uint8_t* out_ok, cudaStream_t stream) {
  constexpr int kMostBytes = K > 0 ? THREADS * K * (int)(sizeof(float4) + sizeof(float))
                                   : kMaxGlobal * (int)sizeof(float);
  const size_t smem = K > 0 ? (size_t)n * (sizeof(float4) + sizeof(float)) : (size_t)n * sizeof(float);
  auto kernel = nms_kernel<THREADS, K>;
  if (kMostBytes > 48 * 1024) {
    static SmemAllowed allowed;
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device >= 64) return cudaErrorInvalidDevice;
    const unsigned long long bit = 1ull << device;
    if (!(allowed.devices.load(std::memory_order_relaxed) & bit)) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMostBytes);
      if (err != cudaSuccess) return err;
      allowed.devices.fetch_or(bit, std::memory_order_relaxed);
    }
  }
  kernel<<<1, THREADS, smem, stream>>>(boxes, scores, classes, valid, n, max_out, threshold,
                                       out_idx, out_ok);
  return cudaGetLastError();
}

}  // namespace

// Class-aware greedy NMS of n candidates into out_idx (max_out int64) and
// out_ok (max_out bool), on `stream`. Returns the launch's cudaError_t; 0
// means it was queued.
extern "C" int pod_batched_nms(const void* boxes, const void* scores, const void* classes,
                               const void* valid, int n, int max_out, float threshold,
                               void* out_idx, void* out_ok, void* stream) {
  if (n < 1 || n > kMaxGlobal || max_out < 1 || boxes == nullptr || scores == nullptr ||
      classes == nullptr || valid == nullptr || out_idx == nullptr || out_ok == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const float* b = static_cast<const float*>(boxes);
  const float* s = static_cast<const float*>(scores);
  const int64_t* c = static_cast<const int64_t*>(classes);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  int64_t* oi = static_cast<int64_t*>(out_idx);
  uint8_t* ok = static_cast<uint8_t*>(out_ok);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 1024) return (int)launch<256, 4>(b, s, c, v, n, max_out, threshold, oi, ok, st);
  if (n <= kMaxRegisters) return (int)launch<1024, 5>(b, s, c, v, n, max_out, threshold, oi, ok, st);
  return (int)launch<1024, 0>(b, s, c, v, n, max_out, threshold, oi, ok, st);
}

// `steps` steps of the block argmax of the instance that n candidates take,
// with no candidates: the kernel's latency floor. Writes one int64 to out.
extern "C" int pod_nms_chain(int steps, int n, void* out, void* stream) {
  if (steps < 1 || n < 1 || n > kMaxGlobal || out == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int64_t* o = static_cast<int64_t*>(out);
  if (n <= 1024) {
    chain_kernel<256><<<1, 256, 0, st>>>(steps, o);
  } else {
    chain_kernel<1024><<<1, 1024, 0, st>>>(steps, o);
  }
  return (int)cudaGetLastError();
}
