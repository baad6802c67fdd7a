// Shared by the fused Satorras edge pass kernels K3 (fused_egnn.cu) and
// K4 (fused_egnn_bwd.cu): sizes, the attention modes, the layer's weight
// pointers, activations, warp reductions and the sorted-id search.
//
// Layout: edge-major ([E, K] rows, K <= 32 features), senders sorted
// ascending with padding edges (sender == num_nodes) at the tail. The edge
// MLP input of an edge is padded to 32 features per node side:
// [h_src 0..31 | h_dst 32..63 | radial, attr0..2 at 64..67] (kIn columns);
// fused_egnn_tc.cuh adds the tensor-core padding and the shared-memory
// pitches, fused_egnn_tile.cuh the edge tiles both kernels walk.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pvs_fused {

constexpr int kWarp = 32;
constexpr int kMaxK = 32;
constexpr int kIn = 2 * kMaxK + 4;   // padded edge-MLP input width (68)
constexpr unsigned kFull = 0xffffffffu;

// Attention modes, in the order of ops/fused_egnn.py ATTENTION_MODES.
enum Attention { kNone = 0, kSigmoid = 1, kTanh = 2, kRelu = 3, kSilu = 4,
                 kSoftmax = 5 };

struct Params {   // device pointers in the torch layouts of ops/fused_egnn.py
  const float *w1, *b1, *w2, *b2, *cw1, *cb1, *cw2, *attw, *attb;
};

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + expf(-x));
}
__device__ __forceinline__ float silu_f(float x) { return x * sigmoid_f(x); }
__device__ __forceinline__ float dsilu_f(float x) {
  const float s = sigmoid_f(x);
  return s * (1.f + x * (1.f - s));
}

// Butterfly reductions: every lane ends with the same bits (each pairwise
// step adds the same two operands on both partners).
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = kWarp / 2; off > 0; off /= 2) {
    v += __shfl_xor_sync(kFull, v, off);
  }
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int off = kWarp / 2; off > 0; off /= 2) {
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  }
  return v;
}

__device__ __forceinline__ float activate(int mode, float logit) {
  switch (mode) {
    case kSigmoid: return sigmoid_f(logit);
    case kTanh: return tanhf(logit);
    case kRelu: return fmaxf(logit, 0.f);
    case kSilu: return silu_f(logit);
    default: return 0.f;
  }
}

// First index in ids[lo, hi) whose value is >= key (ids ascending).
__device__ __forceinline__ int64_t lower_bound(
    const int32_t* __restrict__ ids, int64_t lo, int64_t hi, int32_t key) {
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (ids[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

}  // namespace pvs_fused
