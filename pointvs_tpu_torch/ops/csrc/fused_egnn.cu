// K3 fused_edge_forward: the whole Satorras EGNN edge pass, for Hopper
// (sm_90a).
//
// Replaces fused_edge_forward (pointvs_tpu/ops/pallas/fused_egnn.py, kernel
// _kernel). Per edge e with sender s (senders sorted ascending; an id equal
// to num_nodes marks a padding edge):
//   x = [h[s], h_dst[e], radial, attr0..2]
//   m = silu(W2 silu(W1 x + b1) + b2)  (+ prev[e] where mask > 0)
//   phi = cw2 . silu(cW1 m + cb1)      (tanh'd when use_tanh)
//   att = none / sigmoid / tanh / relu / silu of (attw . m + attb), or the
//         softmax over s's edges (guard -1e30 for masked edges, row max 0
//         when none is unmasked, denominator max(denom, 1e-16));
//   agg[s] = sum over s's edges of where(mask > 0, att * m, 0)  (m in mode
//            none); phi, att (0 in mode none) and msg = m are written per
//            edge, and padding edges get 0 (every block zeroes a strided
//            share of the padding tail).
//
// Design. One block owns kNodesPerBlock consecutive senders and finds their
// edge range by binary search, so every edge, every softmax denominator and
// every agg row is complete inside one block: no atomics, and the sums are
// taken in a fixed order (deterministic). Pass 1: one warp per edge, lane j
// on feature j, recomputes the two MLPs from the weights in shared memory
// (fused_egnn_common.cuh) and writes msg, phi and the attention (the raw
// logit in softmax mode). Pass 2, after a block barrier: one warp per
// sender normalises the softmax and sums its edges' messages in edge order.
//
// What bounds it on an H100: at K=32 an edge reads ~4(2K+7) bytes (K more
// with the edge residual) and writes 4(K+2), against 2(K(2K+4)+2K^2+2K)
// ~ 8.6k flops: ~20 flops per byte, right at the f32 ridge (67 TFLOP/s over
// 3.35 TB/s); chip_smoke.py computes which bound applies to each run's
// data. The TPU kernel's 128-node windows, two-window one-hot gather,
// 128-aligned slice starts, per-window edge capacity and read-blend-write
// have no counterpart: a warp reads h[s] directly, and each edge has
// exactly one owning block.
#include "fused_egnn_common.cuh"

namespace pvs_fused {
namespace {

__global__ void __launch_bounds__(kThreads) fused_edge_forward_kernel(
    const float* __restrict__ h, const float* __restrict__ h_dst,
    const float* __restrict__ extras, const float* __restrict__ mask,
    const int32_t* __restrict__ senders, const float* __restrict__ prev,
    Params p, float* agg, float* phi, float* att, float* msg,
    int64_t num_edges, int k, int num_nodes, int attention, int use_tanh) {
  __shared__ Weights w;
  load_weights(w, p, k);
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const Range r = block_range(senders, num_edges, num_nodes);

  zero_padding(msg, senders, num_edges, num_nodes, k);
  zero_padding(phi, senders, num_edges, num_nodes, 1);
  zero_padding(att, senders, num_edges, num_nodes, 1);

  // Pass 1: per edge.
  for (int64_t e = r.e0 + warp; e < r.e1; e += kWarpsPerBlock) {
    const int s = senders[e];
    EdgeState st;
    edge_forward(w, h, h_dst, extras, mask, prev, e, s, k, lane, st);
    if (lane < k) msg[e * k + lane] = st.m;
    if (lane == 0) {
      phi[e] = use_tanh ? tanhf(st.prephi) : st.prephi;
      att[e] = attention == kNone      ? 0.f
               : attention == kSoftmax ? st.logit
                                       : activate(attention, st.logit);
    }
  }
  __syncthreads();  // pass 2 reads msg and att written by other warps

  // Pass 2: per sender.
  for (int node = r.n0 + warp; node < r.n1; node += kWarpsPerBlock) {
    const int64_t lo = lower_bound(senders, r.e0, r.e1, node);
    const int64_t hi = lower_bound(senders, lo, r.e1, node + 1);
    float node_max = 0.f, denom = 1.f;
    if (attention == kSoftmax) {
      float cand = -1e30f;
      for (int64_t e = lo + lane; e < hi; e += kWarp) {
        if (mask[e] > 0.f) cand = fmaxf(cand, att[e]);
      }
      cand = warp_max(cand);
      node_max = cand > -1e29f ? cand : 0.f;
      float sum = 0.f;
      for (int64_t e = lo + lane; e < hi; e += kWarp) {
        const float mk = mask[e];
        sum += expf((mk > 0.f ? att[e] : -1e30f) - node_max) * mk;
      }
      denom = fmaxf(warp_sum(sum), 1e-16f);
      if (denom == 0.f) denom = 1.f;
    }
    float acc = 0.f;
    for (int64_t base = lo; base < hi; base += kWarp) {
      const int64_t e = base + lane;
      float a = 0.f;
      int keep = 0;
      if (e < hi) {
        const float mk = mask[e];
        keep = mk > 0.f;
        if (attention == kSoftmax) {
          a = expf((mk > 0.f ? att[e] : -1e30f) - node_max) * mk / denom;
          att[e] = a;
        } else {
          a = attention == kNone ? 1.f : att[e];
        }
      }
      const int64_t left = hi - base;
      const int count = left < kWarp ? static_cast<int>(left) : kWarp;
      for (int j = 0; j < count; ++j) {  // count is warp-uniform
        const float aj = __shfl_sync(kFull, a, j);
        const int kj = __shfl_sync(kFull, keep, j);
        if (kj && lane < k) acc += aj * msg[(base + j) * k + lane];
      }
    }
    if (lane < k) agg[static_cast<int64_t>(node) * k + lane] = acc;
  }
}

}  // namespace
}  // namespace pvs_fused

// Plain C interface for ctypes: launches on the given stream, does not
// synchronise, returns cudaGetLastError() so a refused launch surfaces.
extern "C" int pvs_fused_edge_forward(
    const float* h, const float* h_dst, const float* extras,
    const float* mask, const int32_t* senders, const float* prev,
    const float* w1, const float* b1, const float* w2, const float* b2,
    const float* cw1, const float* cb1, const float* cw2, const float* attw,
    const float* attb, float* agg, float* phi, float* att, float* msg,
    int64_t num_edges, int k, int num_nodes, int attention, int use_tanh,
    void* stream) {
  using namespace pvs_fused;
  if (k < 1 || k > kMaxK || num_nodes < 1) return cudaErrorInvalidValue;
  const Params p{w1, b1, w2, b2, cw1, cb1, cw2, attw, attb};
  const dim3 grid((num_nodes + kNodesPerBlock - 1) / kNodesPerBlock);
  fused_edge_forward_kernel<<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      h, h_dst, extras, mask, senders, prev, p, agg, phi, att, msg,
      num_edges, k, num_nodes, attention, use_tanh);
  return static_cast<int>(cudaGetLastError());
}
