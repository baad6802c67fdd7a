// K3 fused_edge_forward: the whole Satorras EGNN edge pass, for Hopper
// (sm_90a), with the edge MLP products on tensor cores.
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
// What bounds it on an H100: at K=32 an edge reads ~4(2K+7) bytes (K more
// with the edge residual) and writes 4(K+2), against 2(K(2K+4)+2K^2)
// ~ 8.4k product flops. In f32 FFMA that sits at the f32 ridge (~0.021 ms
// at the bench shape); on tensor cores in 3xTF32 (3x the product flops at
// 495 TFLOP/s, ~0.008 ms) the bytes bound it (~0.017 ms at 3.35 TB/s).
// chip_smoke.py computes both bounds from each run's data.
//
// Design (the tile helpers, shared with K4, are in fused_egnn_tile.cuh and
// fused_egnn_tc.cuh):
// 1. Blocks of equal edge shares. A block is 4 warps and the grid one wave
//    of the card's resident block slots. Block b owns an equal share of the
//    real edges, cut at sender boundaries, and the nodes [first sender of
//    b, first sender of b + 1) (block 0 from node 0, the last block to N):
//    it writes the agg row of each, the sum for a sender and 0 for a node
//    without real edges. No two blocks write one row: no atomics, and the
//    heaviest block holds no more edges than a share plus one sender.
// 2. Tiles on tensor cores. 64-edge tiles of x arrive by cp.async one tile
//    ahead. pre1 = x W1^T + b1, pre2 = silu(pre1) W2^T + b2 and
//    prec = m cW1^T + cb1 run as mma.sync m16n8k8 TF32 with the 3xTF32
//    split (plain TF32 misses the 1e-5 gates); the logit and pre-phi are
//    quad sums of the C fragments. m replaces hidden in shared memory, so
//    a block holds ~68 KB and three fit on an SM.
// 3. Softmax and aggregation inside the tile. Tiles are cut at sender
//    boundaries, so a tile holds every edge of its senders: after one
//    barrier every warp forms the tile's softmax with warp segmented scans
//    (the same bits in each), and agg[s] is summed over s's rows of the
//    tile by one thread per (sender, feature), in edge order, from m in
//    shared memory. A block with a sender of more than 64 edges takes two
//    passes instead: its tile loop writes msg, phi and the raw logit
//    (softmax) or att, then one warp per node normalises and sums in edge
//    order.
// 4. Stores. msg goes straight from the C fragments, phi and att per row.
//    Rows past the tile, columns past K and prev at masked edges are
//    selected to 0 as they arrive (NaN canaries). Every sum is taken in a
//    fixed order, so two runs give identical bits.
// The TPU kernel's 128-node windows, two-window one-hot gather, 128-aligned
// slice starts, per-window edge capacity and read-blend-write have no
// counterpart: tiles gather h[s] rows directly, and each edge and each agg
// row has exactly one owning block.
#include "fused_egnn_tile.cuh"

namespace pvs_fused {
namespace {

struct Outputs {
  float *agg, *phi, *att, *msg;
};

// K3's tile buffers: the input tiles; hidden, then m, of the current tile
// (each warp writes m over its own rows of hidden); and the logit per row.
struct TileBuf {
  InTiles in;
  float hm[kTile * kFPitch];
  float logit[kTile];
};

constexpr size_t kWeightBytes = (sizeof(TcWeights) + 15) / 16 * 16;
constexpr size_t kSmemBytes = kWeightBytes + sizeof(TileBuf);

// The sender of edge p, num_nodes past the real edges: block b's agg rows
// run from node_at(e0) (0 for block 0) to node_at(e1).
__device__ __forceinline__ int node_at(const int32_t* __restrict__ senders,
                                       int64_t real, int num_nodes,
                                       int64_t p) {
  return p < real ? senders[p] : num_nodes;
}

// msg of the warp's rows from the C fragments, and phi per row.
__device__ __forceinline__ void store_rows(const Fwd& f, const Rows& rw,
                                           const Outputs& out, int k, int t,
                                           int use_tanh, bool pair) {
#pragma unroll
  for (int sl = 0; sl < 2; ++sl) {
    if (!rw.inside[sl]) continue;
    float* row = out.msg + rw.e[sl] * k;
#pragma unroll
    for (int nt = 0; nt < kFT; ++nt) {
      store_pair(row, frag_col(nt, 0, t), k, f.m[nt][2 * sl],
                 f.m[nt][2 * sl + 1], pair);
    }
    if (t == 0) {
      out.phi[rw.e[sl]] = use_tanh ? tanhf(f.prephi[sl]) : f.prephi[sl];
    }
  }
}

// The agg rows of the tile's senders, and 0 in the rows of the nodes
// without edges before each: warp w takes the tile's senders w, w + 4, ...,
// lane c feature c, and sums where(mask > 0, wt * m, 0) over the sender's
// rows in edge order. Lane L holds the weights of rows 2L and 2L + 1 in wt
// (att, 1 in mode none). `before` is the sender before the tile's first
// edge; returns the tile's last sender.
__device__ __forceinline__ int tile_agg(const TileBuf& tb, const TileRef& tr,
                                        const float (&wt)[2], float* agg,
                                        int before, int k, int warp,
                                        int lane) {
  const int len = static_cast<int>(tr.ee - tr.eb);
  const int* s = tr.sender;
  // Bit j of `starts`: row j starts a sender.
  const bool first_lo = lane == 0 || s[lane] != s[lane - 1];
  const unsigned lo = __ballot_sync(kFull, lane < len && first_lo);
  const unsigned hi =
      __ballot_sync(kFull, lane + 32 < len && s[lane + 32] != s[lane + 31]);
  unsigned long long starts = (static_cast<unsigned long long>(hi) << 32) | lo;
  const auto lowest = [](unsigned long long v) {
    return __ffsll(static_cast<long long>(v)) - 1;
  };
  for (int j = 0; starts != 0ull; ++j) {
    const int row0 = lowest(starts);
    starts &= starts - 1;
    if (j % kTileWarps != warp) continue;
    const int row1 = starts != 0ull ? lowest(starts) : len;
    const int node = s[row0];
    float acc = 0.f;
    for (int row = row0; row < row1; ++row) {
      const float a = __shfl_sync(kFull, (row & 1) ? wt[1] : wt[0], row >> 1);
      acc += tr.mask[row] > 0.f ? a * tb.hm[row * kFPitch + lane] : 0.f;
    }
    if (lane < k) {
      for (int n = row0 > 0 ? s[row0 - 1] + 1 : before + 1; n < node; ++n) {
        agg[static_cast<int64_t>(n) * k + lane] = 0.f;
      }
      agg[static_cast<int64_t>(node) * k + lane] = acc;
    }
  }
  return s[len - 1];
}

// Two passes for a block with a sender of more than 64 edges. Pass 1: the
// tile loop writes msg, phi and the raw logit (softmax) or att. Pass 2,
// after a block barrier: one warp per node of the block normalises the
// softmax and sums its edges' messages in edge order (0 for a node without
// edges).
__device__ void two_pass(const TcWeights& w, TileBuf& tb, const Inputs& in,
                         const Outputs& out, const Range& r, int n_lo,
                         int n_hi, int k, int attention, int use_tanh,
                         bool pair) {
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int g = lane / 4, t = lane % 4, r0 = warp * 16;
  for (TilePipe tp = pipe_start(tb.in, in, r, false, k); tp.more();) {
    const TileRef tr = tp.next(tb.in, in, k);
    const Rows rw = warp_rows(tr, r0, g);
    Fwd f;
    warp_forward(w, tb.hm, tb.hm, tr.x, in.prev, rw, k, r0, g, t, true, f);
    store_rows(f, rw, out, k, t, use_tanh, pair);
#pragma unroll
    for (int sl = 0; sl < 2; ++sl) {
      if (t == 0 && rw.inside[sl]) {
        out.att[rw.e[sl]] = attention == kSoftmax
                                ? f.logit[sl]
                                : activate(attention, f.logit[sl]);
      }
    }
  }
  __syncthreads();  // pass 2 reads msg and att written by other warps

  for (int node = n_lo + warp; node < n_hi; node += kTileWarps) {
    const int64_t lo = lower_bound(in.senders, r.e0, r.e1, node);
    const int64_t hi = lower_bound(in.senders, lo, r.e1, node + 1);
    float node_max = 0.f, denom = 1.f;
    if (attention == kSoftmax) {
      float cand = -1e30f;
      for (int64_t e = lo + lane; e < hi; e += kWarp) {
        if (in.mask[e] > 0.f) cand = fmaxf(cand, out.att[e]);
      }
      cand = warp_max(cand);
      node_max = cand > -1e29f ? cand : 0.f;
      float sum = 0.f;
      for (int64_t e = lo + lane; e < hi; e += kWarp) {
        const float mk = in.mask[e];
        sum += expf((mk > 0.f ? out.att[e] : -1e30f) - node_max) * mk;
      }
      denom = fmaxf(warp_sum(sum), 1e-16f);
    }
    float acc = 0.f;
    for (int64_t base = lo; base < hi; base += kWarp) {
      const int64_t e = base + lane;
      float a = 0.f;
      int keep = 0;
      if (e < hi) {
        const float mk = in.mask[e];
        keep = mk > 0.f;
        if (attention == kSoftmax) {
          a = expf((mk > 0.f ? out.att[e] : -1e30f) - node_max) * mk / denom;
          out.att[e] = a;
        } else {
          a = attention == kNone ? 1.f : out.att[e];
        }
      }
      const int64_t left = hi - base;
      const int count = left < kWarp ? static_cast<int>(left) : kWarp;
      for (int j = 0; j < count; ++j) {  // count is warp-uniform
        const float aj = __shfl_sync(kFull, a, j);
        const int kj = __shfl_sync(kFull, keep, j);
        if (kj && lane < k) acc += aj * out.msg[(base + j) * k + lane];
      }
    }
    if (lane < k) out.agg[static_cast<int64_t>(node) * k + lane] = acc;
  }
}

// One pass for a block whose senders have at most 64 edges: tiles cut at
// sender boundaries, the softmax and the agg rows formed inside each tile.
__device__ __forceinline__ void one_pass(const TcWeights& w, TileBuf& tb,
                                         const Inputs& in, const Outputs& out,
                                         const Range& r, int n_lo, int n_hi,
                                         int k, int attention, int use_tanh,
                                         bool pair) {
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int g = lane / 4, t = lane % 4, r0 = warp * 16;
  int last = n_lo - 1;   // the sender before the tile's first edge
  for (TilePipe tp = pipe_start(tb.in, in, r, true, k); tp.more();) {
    const TileRef tr = tp.next(tb.in, in, k);
    const Rows rw = warp_rows(tr, r0, g);
    Fwd f;
    warp_forward(w, tb.hm, tb.hm, tr.x, in.prev, rw, k, r0, g, t, true, f);
    store_rows(f, rw, out, k, t, use_tanh, pair);
#pragma unroll
    for (int sl = 0; sl < 2; ++sl) {
      if (t == 0) tb.logit[r0 + g + 8 * sl] = f.logit[sl];
    }
    __syncthreads();   // every warp's m and logit rows are in place
    // Every warp forms att of the whole tile (the same bits in each), lane
    // L for rows 2L and 2L + 1; warp 0 writes it.
    const int len = static_cast<int>(tr.ee - tr.eb);
    float a[2];
    if (attention == kSoftmax) {
      bool first[2], last_row[2];
      seg_softmax(tr, tb.logit, first, last_row, a);
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        a[i] = activate(attention, tb.logit[2 * lane + i]);   // 0 in none
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = 2 * lane + i;
      if (warp == 0 && row < len) out.att[tr.eb + row] = a[i];
      if (attention == kNone) a[i] = 1.f;
    }
    last = tile_agg(tb, tr, a, out.agg, last, k, warp, lane);
  }
  // The nodes after the block's last sender have no edges.
  for (int64_t i = static_cast<int64_t>(last + 1) * k + threadIdx.x;
       i < static_cast<int64_t>(n_hi) * k; i += kTileThreads) {
    out.agg[i] = 0.f;
  }
}

__global__ void __launch_bounds__(kTileThreads, 3) fused_edge_forward_kernel(
    Inputs in, Params p, Outputs out, int64_t num_edges, int k,
    int num_nodes, int attention, int use_tanh, bool pair) {
  extern __shared__ float4 smem_raw[];
  TcWeights& w = *reinterpret_cast<TcWeights*>(smem_raw);
  TileBuf& tb = *reinterpret_cast<TileBuf*>(
      reinterpret_cast<char*>(smem_raw) + kWeightBytes);
  load_weights_tc<kTileThreads>(w, p, k);  // ends with a barrier
  const int64_t real =
      block_lower_bound(in.senders, 0, num_edges, num_nodes);
  const Range r = edge_share(in.senders, real);
  const int n_lo =
      blockIdx.x == 0 ? 0 : node_at(in.senders, real, num_nodes, r.e0);
  const int n_hi = node_at(in.senders, real, num_nodes, r.e1);
  if (has_hub(in.senders, r)) {
    two_pass(w, tb, in, out, r, n_lo, n_hi, k, attention, use_tanh, pair);
  } else {
    one_pass(w, tb, in, out, r, n_lo, n_hi, k, attention, use_tanh, pair);
  }
  // Padding edges: every block zeroes a strided share.
  zero_tail(out.msg, real, num_edges, k);
  zero_tail(out.phi, real, num_edges, 1);
  zero_tail(out.att, real, num_edges, 1);
}

// Blocks: one wave of the resident block slots at K3's resources, at most
// one per sender (fused_egnn_tile.cuh).
int num_blocks(int num_nodes) {
  static int slots[kMaxDevices] = {};
  return wave_blocks(reinterpret_cast<const void*>(fused_edge_forward_kernel),
                     kSmemBytes, num_nodes, slots);
}

}  // namespace
}  // namespace pvs_fused

// The kernel's resources on the current device: info[0] registers per
// thread, [1] local (spill) bytes per thread, [2] static and [3] dynamic
// shared bytes per block, [4] blocks resident per SM. Returns a cudaError.
extern "C" int pvs_fused_forward_info(int* info) {
  using namespace pvs_fused;
  return tile_kernel_info(
      reinterpret_cast<const void*>(fused_edge_forward_kernel), kSmemBytes,
      info);
}

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
  // Vector paths need K % 4 == 0 (loads) or K % 2 == 0 (stores) and
  // aligned rows.
  const auto aligned = [](const void* q, uintptr_t to) {
    return reinterpret_cast<uintptr_t>(q) % to == 0;
  };
  const bool vec4 = k % 4 == 0 && aligned(h, 16) && aligned(h_dst, 16) &&
                    aligned(extras, 16);
  const bool pair = k % 2 == 0 && aligned(msg, 8);
  const Inputs in{h, h_dst, extras, mask, prev, senders, vec4};
  const Params p{w1, b1, w2, b2, cw1, cb1, cw2, attw, attb};
  const Outputs out{agg, phi, att, msg};
  const int blocks = num_blocks(num_nodes);   // opts in to the shared memory
  fused_edge_forward_kernel<<<blocks, kTileThreads, kSmemBytes,
                              static_cast<cudaStream_t>(stream)>>>(
      in, p, out, num_edges, k, num_nodes, attention, use_tanh, pair);
  return static_cast<int>(cudaGetLastError());
}
