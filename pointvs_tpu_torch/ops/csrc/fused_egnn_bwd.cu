// K4 fused_edge_backward: recompute backward of the fused edge pass K3, for
// Hopper (sm_90a).
//
// Replaces fused_edge_backward (pointvs_tpu/ops/pallas/fused_egnn_bwd.py,
// kernel _bwd_kernel). Nothing is saved by the forward: each edge's x,
// hidden, m, coordinate-MLP activations and attention are recomputed
// (fused_egnn_common.cuh), and the cotangents d_agg[s], d_phi, d_att and
// d_msg are chained through attention, the coordinate MLP, the edge
// residual and the edge MLP as the reference does. valid = mask > 0 for an
// edge with a real sender; d_phi, d_att, d_msg, the logit gradient, the
// coordinate-MLP gradient and the message gradient are selected by it.
// Outputs per edge: d_h_src, d_h_dst, d_radial and d_prev (0 on padding
// edges, which every block zeroes a strided share of); and the parameter
// gradients.
//
// Design. As in K3, one block owns kNodesPerBlock senders and all their
// edges. In softmax mode, phase 1 (warp per edge) recomputes each edge's
// logit and g_att = d_agg[s] . m + d_att, and phase 2 (warp per sender)
// forms the softmax and the per-sender sum of att * g_att, leaving att and
// the logit gradient per edge in scratch; both see every edge of the
// sender. Phase 3 (warp per edge, lane j on feature j) recomputes the
// forward and runs the backward. Lane j keeps row j of every parameter
// gradient in registers (outer products with values broadcast by warp
// shuffles). At the end the block's 8 warps add their rows into shared
// memory one warp after another, the block writes its partial to
// partials[block], and a second kernel sums the partials in block order.
// No float atomics anywhere, so two runs give identical bits.
//
// What bounds it on an H100: the recompute plus the backward are ~3x K3's
// flops (~26k per edge at K=32) against ~4(5K+8) bytes per edge, ~40 flops
// per byte: the f32 units, not memory. The TPU kernel's windows, one-hot
// gathers, owner-window blend writes and its sequential-grid accumulation
// of parameter gradients have no counterpart here.
#include "fused_egnn_common.cuh"

namespace pvs_fused {

// Packed parameter-gradient layout (zero-padded to kMaxK): rows of dW1
// over the padded input columns, db1, dW2, db2, dcW1, dcb1, dcw2, dattw,
// dattb.
constexpr int kOffW1 = 0;
constexpr int kOffB1 = kOffW1 + kMaxK * kIn;
constexpr int kOffW2 = kOffB1 + kMaxK;
constexpr int kOffB2 = kOffW2 + kMaxK * kMaxK;
constexpr int kOffCW1 = kOffB2 + kMaxK;
constexpr int kOffCB1 = kOffCW1 + kMaxK * kMaxK;
constexpr int kOffCW2 = kOffCB1 + kMaxK;
constexpr int kOffAttW = kOffCW2 + kMaxK;
constexpr int kOffAttB = kOffAttW + kMaxK;
constexpr int kParamWidth = kOffAttB + 1;

namespace {

struct Cotangents {
  const float *d_agg, *d_phi, *d_att, *d_msg;
};

struct EdgeGrads {
  float *d_h_src, *d_h_dst, *d_radial, *d_prev;
};

__global__ void __launch_bounds__(kThreads, 1) fused_edge_backward_kernel(
    const float* __restrict__ h, const float* __restrict__ h_dst,
    const float* __restrict__ extras, const float* __restrict__ mask,
    const int32_t* __restrict__ senders, const float* __restrict__ prev,
    Params p, Cotangents cot, EdgeGrads out, float* scratch,
    float* __restrict__ partials, int64_t num_edges, int k, int num_nodes,
    int attention, int use_tanh) {
  __shared__ Weights w;
  __shared__ float red[kParamWidth];
  for (int i = threadIdx.x; i < kParamWidth; i += blockDim.x) red[i] = 0.f;
  load_weights(w, p, k);  // ends with a barrier
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const Range r = block_range(senders, num_edges, num_nodes);

  if (attention == kSoftmax) {
    // Phase 1: per edge, the logit and g_att into scratch[e] = (l, g).
    for (int64_t e = r.e0 + warp; e < r.e1; e += kWarpsPerBlock) {
      const int s = senders[e];
      EdgeState st;
      edge_forward(w, h, h_dst, extras, mask, prev, e, s, k, lane, st);
      const float gmsg =
          lane < k ? cot.d_agg[static_cast<int64_t>(s) * k + lane] * st.mask
                   : 0.f;
      const float g_att = warp_sum(gmsg * st.m) +
                          (st.mask > 0.f ? cot.d_att[e] : 0.f);
      if (lane == 0) {
        scratch[2 * e] = st.logit;
        scratch[2 * e + 1] = g_att;
      }
    }
    __syncthreads();
    // Phase 2: per sender, softmax and sum(att * g_att); scratch[e] becomes
    // (att, att * (g_att - sum)).
    for (int node = r.n0 + warp; node < r.n1; node += kWarpsPerBlock) {
      const int64_t lo = lower_bound(senders, r.e0, r.e1, node);
      const int64_t hi = lower_bound(senders, lo, r.e1, node + 1);
      float cand = -1e30f;
      for (int64_t e = lo + lane; e < hi; e += kWarp) {
        if (mask[e] > 0.f) cand = fmaxf(cand, scratch[2 * e]);
      }
      cand = warp_max(cand);
      const float node_max = cand > -1e29f ? cand : 0.f;
      float sum = 0.f;
      for (int64_t e = lo + lane; e < hi; e += kWarp) {
        const float mk = mask[e];
        sum += expf((mk > 0.f ? scratch[2 * e] : -1e30f) - node_max) * mk;
      }
      float denom = fmaxf(warp_sum(sum), 1e-16f);
      if (denom == 0.f) denom = 1.f;
      float weighted = 0.f;
      for (int64_t e = lo + lane; e < hi; e += kWarp) {
        const float mk = mask[e];
        const float a =
            expf((mk > 0.f ? scratch[2 * e] : -1e30f) - node_max) * mk /
            denom;
        weighted += a * scratch[2 * e + 1];
      }
      weighted = warp_sum(weighted);
      for (int64_t e = lo + lane; e < hi; e += kWarp) {
        const float mk = mask[e];
        const float a =
            expf((mk > 0.f ? scratch[2 * e] : -1e30f) - node_max) * mk /
            denom;
        const float g_att = scratch[2 * e + 1];
        scratch[2 * e] = a;
        scratch[2 * e + 1] = a * (g_att - weighted);
      }
    }
    __syncthreads();
  }

  // Phase 3: per edge, the full backward. Lane j accumulates row j.
  float acc_w1[kIn], acc_w2[kMaxK], acc_cw1[kMaxK];
#pragma unroll
  for (int i = 0; i < kIn; ++i) acc_w1[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxK; ++i) {
    acc_w2[i] = 0.f;
    acc_cw1[i] = 0.f;
  }
  float acc_b1 = 0.f, acc_b2 = 0.f, acc_cb1 = 0.f, acc_cw2 = 0.f;
  float acc_attw = 0.f, acc_attb = 0.f;

  zero_padding(out.d_h_src, senders, num_edges, num_nodes, k);
  zero_padding(out.d_h_dst, senders, num_edges, num_nodes, k);
  zero_padding(out.d_prev, senders, num_edges, num_nodes, k);
  zero_padding(out.d_radial, senders, num_edges, num_nodes, 1);
  for (int64_t e = r.e0 + warp; e < r.e1; e += kWarpsPerBlock) {
    const int s = senders[e];
    EdgeState st;
    edge_forward(w, h, h_dst, extras, mask, prev, e, s, k, lane, st);
    const bool valid = st.mask > 0.f;
    const bool feat = lane < k;
    const float phi = use_tanh ? tanhf(st.prephi) : st.prephi;
    const float g_phi = valid ? cot.d_phi[e] : 0.f;
    const float gmsg =
        feat ? cot.d_agg[static_cast<int64_t>(s) * k + lane] * st.mask : 0.f;

    float g_m = gmsg;
    if (attention != kNone) {
      float a, g_logits;
      if (attention == kSoftmax) {
        a = scratch[2 * e];
        g_logits = scratch[2 * e + 1];
      } else {
        a = activate(attention, st.logit);
        const float g_att =
            warp_sum(gmsg * st.m) + (valid ? cot.d_att[e] : 0.f);
        if (attention == kSigmoid) {
          g_logits = g_att * a * (1.f - a);
        } else if (attention == kTanh) {
          g_logits = g_att * (1.f - a * a);
        } else if (attention == kRelu) {
          g_logits = g_att * (st.logit > 0.f ? 1.f : 0.f);
        } else {
          g_logits = g_att * dsilu_f(st.logit);
        }
      }
      g_logits = valid ? g_logits : 0.f;
      g_m = gmsg * a + g_logits * w.attw[lane];
      acc_attw = fmaf(g_logits, st.m, acc_attw);
      acc_attb += g_logits;
    }
    if (cot.d_msg != nullptr && feat && valid) g_m += cot.d_msg[e * k + lane];

    // Coordinate MLP.
    const float g_prephi = use_tanh ? g_phi * (1.f - phi * phi) : g_phi;
    acc_cw2 = fmaf(g_prephi, st.ch, acc_cw2);
    const float g_prec =
        valid ? (w.cw2[lane] * g_prephi) * dsilu_f(st.prec) : 0.f;
    acc_cb1 += g_prec;
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxK; ++i) {
      acc_cw1[i] = fmaf(g_prec, __shfl_sync(kFull, st.m, i), acc_cw1[i]);
      t = fmaf(w.cw1[i * kWPitch + lane], __shfl_sync(kFull, g_prec, i), t);
    }
    g_m = valid ? g_m + t : 0.f;
    if (out.d_prev != nullptr && feat) out.d_prev[e * k + lane] = g_m;

    // Edge MLP, second layer.
    const float g_pre2 = g_m * dsilu_f(st.pre2);
    acc_b2 += g_pre2;
    float g_hid = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxK; ++i) {
      acc_w2[i] = fmaf(g_pre2, __shfl_sync(kFull, st.hid, i), acc_w2[i]);
      g_hid = fmaf(w.w2[i * kWPitch + lane], __shfl_sync(kFull, g_pre2, i),
                   g_hid);
    }
    // First layer, and the input gradient.
    const float g_pre1 = g_hid * dsilu_f(st.pre1);
    acc_b1 += g_pre1;
    float gxa = 0.f, gxb = 0.f, gxc = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxK; ++i) {
      acc_w1[i] = fmaf(g_pre1, __shfl_sync(kFull, st.xa, i), acc_w1[i]);
      acc_w1[kMaxK + i] =
          fmaf(g_pre1, __shfl_sync(kFull, st.xb, i), acc_w1[kMaxK + i]);
      const float gi = __shfl_sync(kFull, g_pre1, i);
      const float* row = w.w1 + i * kW1Pitch;
      gxa = fmaf(row[lane], gi, gxa);
      gxb = fmaf(row[kMaxK + lane], gi, gxb);
      gxc = fmaf(row[2 * kMaxK], gi, gxc);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc_w1[2 * kMaxK + i] = fmaf(g_pre1, __shfl_sync(kFull, st.xc, i),
                                   acc_w1[2 * kMaxK + i]);
    }
    if (feat) {
      out.d_h_src[e * k + lane] = gxa;
      out.d_h_dst[e * k + lane] = gxb;
    }
    if (lane == 0) out.d_radial[e] = gxc;
  }

  // The block's partial: warps add their rows in warp order.
  for (int turn = 0; turn < kWarpsPerBlock; ++turn) {
    if (warp == turn) {
#pragma unroll
      for (int i = 0; i < kIn; ++i) red[kOffW1 + lane * kIn + i] += acc_w1[i];
#pragma unroll
      for (int i = 0; i < kMaxK; ++i) {
        red[kOffW2 + lane * kMaxK + i] += acc_w2[i];
        red[kOffCW1 + lane * kMaxK + i] += acc_cw1[i];
      }
      red[kOffB1 + lane] += acc_b1;
      red[kOffB2 + lane] += acc_b2;
      red[kOffCB1 + lane] += acc_cb1;
      red[kOffCW2 + lane] += acc_cw2;
      red[kOffAttW + lane] += acc_attw;
      if (lane == 0) red[kOffAttB] += acc_attb;
    }
    __syncthreads();
  }
  float* dst = partials + static_cast<int64_t>(blockIdx.x) * kParamWidth;
  for (int i = threadIdx.x; i < kParamWidth; i += blockDim.x) dst[i] = red[i];
}

// d_params[i] = sum over blocks b, in order, of partials[b][i].
__global__ void reduce_partials_kernel(const float* __restrict__ partials,
                                       float* __restrict__ d_params,
                                       int num_blocks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kParamWidth) return;
  float acc = 0.f;
  for (int b = 0; b < num_blocks; ++b) {
    acc += partials[static_cast<int64_t>(b) * kParamWidth + i];
  }
  d_params[i] = acc;
}

}  // namespace
}  // namespace pvs_fused

// Width of the packed parameter-gradient vector (and of a partials row).
extern "C" int pvs_fused_backward_param_width() {
  return pvs_fused::kParamWidth;
}

// Number of blocks, i.e. rows of the partials buffer, for num_nodes senders.
extern "C" int pvs_fused_backward_num_blocks(int num_nodes) {
  return (num_nodes + pvs_fused::kNodesPerBlock - 1) /
         pvs_fused::kNodesPerBlock;
}

// Plain C interface for ctypes: launches both kernels on the given stream,
// does not synchronise, returns cudaGetLastError() so a refused launch
// surfaces. scratch holds 2 floats per edge (softmax mode only); partials
// pvs_fused_backward_num_blocks(num_nodes) rows of the packed width.
extern "C" int pvs_fused_edge_backward(
    const float* h, const float* h_dst, const float* extras,
    const float* mask, const int32_t* senders, const float* prev,
    const float* w1, const float* b1, const float* w2, const float* b2,
    const float* cw1, const float* cb1, const float* cw2, const float* attw,
    const float* attb, const float* d_agg, const float* d_phi,
    const float* d_att, const float* d_msg, float* d_h_src, float* d_h_dst,
    float* d_radial, float* d_prev, float* scratch, float* partials,
    float* d_params, int64_t num_edges, int k, int num_nodes, int attention,
    int use_tanh, void* stream) {
  using namespace pvs_fused;
  if (k < 1 || k > kMaxK || num_nodes < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Params p{w1, b1, w2, b2, cw1, cb1, cw2, attw, attb};
  const Cotangents cot{d_agg, d_phi, d_att, d_msg};
  const EdgeGrads out{d_h_src, d_h_dst, d_radial, d_prev};
  const int blocks = pvs_fused_backward_num_blocks(num_nodes);
  fused_edge_backward_kernel<<<blocks, kThreads, 0, st>>>(
      h, h_dst, extras, mask, senders, prev, p, cot, out, scratch, partials,
      num_edges, k, num_nodes, attention, use_tanh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials_kernel<<<(kParamWidth + 255) / 256, 256, 0, st>>>(
      partials, d_params, blocks);
  return static_cast<int>(cudaGetLastError());
}
