// Shared by the fused Satorras edge pass kernels K3 (fused_egnn.cu) and
// K4 (fused_egnn_bwd.cu): the per-edge recompute of the edge MLP, the
// coordinate MLP and the attention logit.
//
// Layout: edge-major ([E, K] rows, K <= 32 features). One warp handles one
// edge at a time with lane j on feature j; lanes j >= K carry zeros, because
// every weight is copied into shared memory zero-padded to 32 features:
//   w1  [32 rows][69 pitch]: padded input columns [h_src 0..31 | h_dst
//        32..63 | radial, attr0..2 at 64..67];
//   w2, cw1 [32 rows][33 pitch].
// Both pitches are odd, so a lane reading its row (forward, W x) and a lane
// reading its column (backward, W^T g) both hit 32 different banks. The
// products run in f32 FFMA: the reference contracts at HIGHEST precision
// and TF32 alone would miss its 1e-5 gates.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pvs_fused {

constexpr int kWarp = 32;
constexpr int kMaxK = 32;
constexpr int kIn = 2 * kMaxK + 4;   // padded edge-MLP input width (68)
constexpr int kW1Pitch = kIn + 1;    // 69
constexpr int kWPitch = kMaxK + 1;   // 33
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;
constexpr int kNodesPerBlock = 32;   // senders owned by one block
constexpr unsigned kFull = 0xffffffffu;

// Attention modes, in the order of ops/fused_egnn.py ATTENTION_MODES.
enum Attention { kNone = 0, kSigmoid = 1, kTanh = 2, kRelu = 3, kSilu = 4,
                 kSoftmax = 5 };

struct Weights {
  float w1[kMaxK * kW1Pitch];
  float w2[kMaxK * kWPitch];
  float cw1[kMaxK * kWPitch];
  float b1[kMaxK], b2[kMaxK], cb1[kMaxK], cw2[kMaxK], attw[kMaxK];
  float attb;
};

struct Params {   // device pointers in the torch layouts of ops/fused_egnn.py
  const float *w1, *b1, *w2, *b2, *cw1, *cb1, *cw2, *attw, *attb;
};

// Per-lane state of one edge's recomputed forward (lane j = feature j).
struct EdgeState {
  float xa, xb, xc;            // h_src[j], h_dst[j], extras[j] (j < 4)
  float pre1, hid, pre2, m, prec, ch;
  float prephi, logit;         // warp-uniform
  float mask;
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

// The block's senders [n0, n1) and their edges [e0, e1); padding edges
// (sender == num_nodes, at the tail) belong to no block.
struct Range {
  int n0, n1;
  int64_t e0, e1;
};

__device__ __forceinline__ Range block_range(
    const int32_t* __restrict__ senders, int64_t num_edges, int num_nodes) {
  Range r;
  r.n0 = blockIdx.x * kNodesPerBlock;
  r.n1 = min(r.n0 + kNodesPerBlock, num_nodes);
  r.e0 = lower_bound(senders, 0, num_edges, r.n0);
  r.e1 = lower_bound(senders, r.e0, num_edges, r.n1);
  return r;
}

// Write 0 to the `width` values of every padding edge of `out` (none when
// out is null). Every block takes a strided share of the tail, so a long
// tail does not serialise on one block.
__device__ __forceinline__ void zero_padding(
    float* out, const int32_t* __restrict__ senders, int64_t num_edges,
    int num_nodes, int width) {
  if (out == nullptr) return;
  const int64_t first = lower_bound(senders, 0, num_edges, num_nodes);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = first * width + static_cast<int64_t>(blockIdx.x) *
                                       blockDim.x + threadIdx.x;
       i < num_edges * width; i += stride) {
    out[i] = 0.f;
  }
}

// Copy the layer's weights into shared memory, zero-padded; ends with a
// barrier.
__device__ void load_weights(Weights& s, const Params& p, int k) {
  const int in = 2 * k + 4;
  for (int idx = threadIdx.x; idx < kMaxK * kIn; idx += blockDim.x) {
    const int j = idx / kIn, c = idx % kIn;
    int col = -1;
    if (c < kMaxK) {
      if (c < k) col = c;
    } else if (c < 2 * kMaxK) {
      if (c - kMaxK < k) col = k + (c - kMaxK);
    } else {
      col = 2 * k + (c - 2 * kMaxK);
    }
    s.w1[j * kW1Pitch + c] = (j < k && col >= 0) ? p.w1[j * in + col] : 0.f;
  }
  for (int idx = threadIdx.x; idx < kMaxK * kMaxK; idx += blockDim.x) {
    const int j = idx / kMaxK, i = idx % kMaxK;
    const bool inside = j < k && i < k;
    s.w2[j * kWPitch + i] = inside ? p.w2[j * k + i] : 0.f;
    s.cw1[j * kWPitch + i] = inside ? p.cw1[j * k + i] : 0.f;
  }
  for (int j = threadIdx.x; j < kMaxK; j += blockDim.x) {
    const bool inside = j < k;
    s.b1[j] = inside ? p.b1[j] : 0.f;
    s.b2[j] = inside ? p.b2[j] : 0.f;
    s.cb1[j] = inside ? p.cb1[j] : 0.f;
    s.cw2[j] = inside ? p.cw2[j] : 0.f;
    s.attw[j] = inside ? p.attw[j] : 0.f;
  }
  if (threadIdx.x == 0) s.attb = p.attb[0];
  __syncthreads();
}

// Recompute edge e (sender s < num_nodes) as ops/fused_egnn.py
// edge_mlp_forward does. prev may be null (no edge residual); its rows are
// selected by the mask, never multiplied, since padding may hold NaN.
__device__ __forceinline__ void edge_forward(
    const Weights& w, const float* __restrict__ h,
    const float* __restrict__ h_dst, const float* __restrict__ extras,
    const float* __restrict__ mask, const float* __restrict__ prev,
    int64_t e, int s, int k, int lane, EdgeState& st) {
  const bool feat = lane < k;
  st.xa = feat ? h[static_cast<int64_t>(s) * k + lane] : 0.f;
  st.xb = feat ? h_dst[e * k + lane] : 0.f;
  st.xc = lane < 4 ? extras[e * 4 + lane] : 0.f;
  st.mask = mask[e];

  const float* row = w.w1 + lane * kW1Pitch;
  float acc = w.b1[lane];
#pragma unroll
  for (int i = 0; i < kMaxK; ++i) {
    acc = fmaf(row[i], __shfl_sync(kFull, st.xa, i), acc);
  }
#pragma unroll
  for (int i = 0; i < kMaxK; ++i) {
    acc = fmaf(row[kMaxK + i], __shfl_sync(kFull, st.xb, i), acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc = fmaf(row[2 * kMaxK + i], __shfl_sync(kFull, st.xc, i), acc);
  }
  st.pre1 = acc;
  st.hid = silu_f(acc);

  row = w.w2 + lane * kWPitch;
  acc = w.b2[lane];
#pragma unroll
  for (int i = 0; i < kMaxK; ++i) {
    acc = fmaf(row[i], __shfl_sync(kFull, st.hid, i), acc);
  }
  st.pre2 = acc;
  float m = silu_f(acc);
  if (prev != nullptr && feat && st.mask > 0.f) m += prev[e * k + lane];
  st.m = m;

  row = w.cw1 + lane * kWPitch;
  acc = w.cb1[lane];
#pragma unroll
  for (int i = 0; i < kMaxK; ++i) {
    acc = fmaf(row[i], __shfl_sync(kFull, st.m, i), acc);
  }
  st.prec = acc;
  st.ch = silu_f(acc);
  st.prephi = warp_sum(w.cw2[lane] * st.ch);
  st.logit = warp_sum(w.attw[lane] * st.m) + w.attb;
}

}  // namespace pvs_fused
