// K4 fused_edge_backward: recompute backward of the fused edge pass K3, for
// Hopper (sm_90a), with the edge MLP products on tensor cores.
//
// Replaces fused_edge_backward (pointvs_tpu/ops/pallas/fused_egnn_bwd.py,
// kernel _bwd_kernel). Nothing is saved by the forward: each edge's x,
// hidden, m, coordinate-MLP activations and attention are recomputed, and
// the cotangents d_agg[s], d_phi, d_att and d_msg are chained through
// attention, the coordinate MLP, the edge residual and the edge MLP as the
// reference does. valid = mask > 0 for an edge with a real sender; d_phi,
// d_att, d_msg, the logit gradient, the coordinate-MLP gradient and the
// message gradient are selected by it. Outputs per edge: d_h_src, d_h_dst,
// d_radial and d_prev (0 on padding edges, which every block zeroes a
// strided share of); and the parameter gradients, packed.
//
// What bounds it on an H100: ~26k flops per edge at K=32 (the recompute,
// then a transposed product and an outer product per weight matrix)
// against ~4(5K+8) bytes. In f32 FFMA that is the f32 units (~0.063 ms at
// the bench shape); on tensor cores in 3xTF32 (3x the flops at 495
// TFLOP/s, ~0.025 ms) it is the bytes (~0.026 ms at 3.35 TB/s).
//
// Design (the tile helpers, shared with K3, are in fused_egnn_tile.cuh and
// fused_egnn_tc.cuh), against the four causes that held the first version
// (one warp per edge, lane j on feature j) at ~20x its bound:
// 1. Occupancy. Parameter gradients no longer live as a row per lane (218
//    registers, one 8-warp block per SM). A block is 4 warps; warps 0 and 1
//    hold rows 0-15 and 16-31 of dW1 (32 x 72), warp 2 dW2 and warp 3 dcW1
//    in C fragments (36 registers). Shared memory (~106 KB: weights, two
//    64-edge tiles of x, one of hidden, m and the three pre-activation
//    gradients) allows 2 blocks per SM; registers sit at the 255 that
//    allows.
// 2. Issue slots. Every product runs as mma.sync m16n8k8 TF32 with the
//    3xTF32 split: per warp and 16 edges, m16 x n32 x k72 | k32 | k32 for
//    the recompute (pre1, pre2, prec), k32 x n32 | n32 | n72 for the
//    transposed products (g_prec cW1, g_pre2 W2, g_pre1 W1), then, after
//    each tile, dW += G^T Y with the tile's 64 edges as the reduction. One
//    mma does 1024 multiply-adds where a warp of FFMA with a shuffle and a
//    shared load did 32. The k-loops unroll by 2 only: full unrolling
//    spills and ran slower.
// 3. Waves and balance. The grid is one wave of the card's resident block
//    slots (132 SMs x 2), and each block owns an equal share of the real
//    edges, cut at sender boundaries: a block's tile loop is long, so a
//    second, partial wave, or a block with twice the mean edges (blocks of
//    equal sender counts on real graphs), would cost a whole block's time.
// 4. Softmax. Tiles are cut at sender boundaries (the last one within 64
//    edges, found from the tile's sender rows as they arrive), so each tile
//    holds all of its senders' edges and the softmax and the per-sender sum
//    of att * g_att are formed inside the tile after the recompute: one
//    pass. Only a block with a sender of more than 64 edges takes the two
//    phases before the tile loop: phase 1 runs it only as far as m and the
//    logit for the logit and g_att, phase 2 (warp per sender) forms att and
//    the sum.
// A block owns whole senders (binary search on the sorted senders), so
// softmax sums stay inside the block. Tile rows past the tile's edges,
// feature columns past K and prev at masked edges are selected to 0 (the
// copies zero-fill, prev is selected as it is read): a NaN canary inside
// an mma would poison a whole parameter-gradient tile. Tiles arrive by
// cp.async copies (16 bytes when K % 4 == 0; the h[s] rows are gathers, so
// no TMA), one tile ahead of the math. Each block writes its
// parameter-gradient partial row (every element owned by one thread, in a
// fixed order over tiles) and a second kernel sums the rows in block
// order. No float atomics anywhere, so two runs give identical bits.
#include "fused_egnn_tile.cuh"

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

// K4's tile buffers: the input tiles, then for the current tile the
// activations the parameter gradients need and the pre-activation
// gradients.
struct TileBuf {
  InTiles in;
  float hid[kTile * kFPitch], m[kTile * kFPitch];
  float gp1[kTile * kFPitch], gp2[kTile * kFPitch], gprec[kTile * kFPitch];
  float glogit[kTile];
  float logit[kTile], gatt[kTile];   // per row, for the in-tile softmax
  float dcw2[kTileWarps][kMaxK];     // per-warp dcw2, summed at the end
};

constexpr size_t kWeightBytes = (sizeof(TcWeights) + 15) / 16 * 16;
constexpr size_t kSmemBytes = kWeightBytes + sizeof(TileBuf);

// One warp: the per-sender softmax of the tile's rows and its backward,
// from the logit and g_att in tb.logit / tb.gatt, which are overwritten by
// att and att * (g_att - sum(att * g_att)), as the reference's per-sender
// softmax.
__device__ __forceinline__ void tile_softmax(TileBuf& tb, const TileRef& tr) {
  const int r0 = 2 * (threadIdx.x % kWarp);
  bool first[2], last[2];
  float a[2], v[2];
  seg_softmax(tr, tb.logit, first, last, a);
  const auto sum_op = [](float x, float y) { return x + y; };
#pragma unroll
  for (int i = 0; i < 2; ++i) v[i] = a[i] * tb.gatt[r0 + i];
  seg_total(v, first, last, sum_op, 0.f);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float ga = tb.gatt[r0 + i];
    tb.logit[r0 + i] = a[i];
    tb.gatt[r0 + i] = a[i] * (ga - v[i]);
  }
}

// The message cotangent of the lane's fragment elements: d_agg[s] times the
// mask, 0 past the block's edges and past K.
__device__ __forceinline__ void gather_gmsg(const Cotangents& cot,
                                            const Rows& rw, int k, int t,
                                            float (&gmsg)[kFT][4]) {
#pragma unroll
  for (int nt = 0; nt < kFT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = frag_col(nt, i, t), sl = i >> 1;
      gmsg[nt][i] =
          (rw.inside[sl] && c < k)
              ? cot.d_agg[static_cast<int64_t>(rw.sender[sl]) * k + c] *
                    rw.mask[sl]
              : 0.f;
    }
  }
}

// g_att of the lane's two rows: d_agg[s] . m, from the message cotangent,
// plus d_att where the edge is valid.
__device__ __forceinline__ void row_g_att(const float (&gmsg)[kFT][4],
                                          const float (&m)[kFT][4],
                                          const Rows& rw,
                                          const Cotangents& cot,
                                          float (&g_att)[2]) {
  float ga[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < kFT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ga[i >> 1] = fmaf(gmsg[nt][i], m[nt][i], ga[i >> 1]);
    }
  }
#pragma unroll
  for (int sl = 0; sl < 2; ++sl) {
    g_att[sl] = quad_sum(ga[sl]) + (rw.valid[sl] ? cot.d_att[rw.e[sl]] : 0.f);
  }
}

__global__ void __launch_bounds__(kTileThreads, 2) fused_edge_backward_kernel(
    Inputs in, Params p, Cotangents cot, EdgeGrads out, float* scratch,
    float* __restrict__ partials, int64_t num_edges, int k, int num_nodes,
    int attention, int use_tanh, bool pair) {
  extern __shared__ float4 smem_raw[];
  TcWeights& w = *reinterpret_cast<TcWeights*>(smem_raw);
  TileBuf& tb = *reinterpret_cast<TileBuf*>(
      reinterpret_cast<char*>(smem_raw) + kWeightBytes);
  load_weights_tc<kTileThreads>(w, p, k);  // ends with a barrier
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int g = lane / 4, t = lane % 4, r0 = warp * 16;
  const int64_t real =
      block_lower_bound(in.senders, 0, num_edges, num_nodes);
  const Range r = edge_share(in.senders, real);
  // Softmax mode: tiles cut at sender boundaries, the softmax inside each
  // tile (no phases 1 and 2), unless a sender has more than 64 edges.
  const bool in_tile = attention == kSoftmax && !has_hub(in.senders, r);

  if (attention == kSoftmax && !in_tile) {
    // Phase 1: per edge, the logit and g_att into scratch[e] = (l, g).
    for (TilePipe tp = pipe_start(tb.in, in, r, false, k); tp.more();) {
      const TileRef tr = tp.next(tb.in, in, k);
      const Rows rw = warp_rows(tr, r0, g);
      Fwd f;
      warp_forward(w, tb.hid, tb.m, tr.x, in.prev, rw, k, r0, g, t, false,
                   f);
      float gmsg[kFT][4], g_att[2];
      gather_gmsg(cot, rw, k, t, gmsg);
      row_g_att(gmsg, f.m, rw, cot, g_att);
#pragma unroll
      for (int sl = 0; sl < 2; ++sl) {
        if (t == 0 && rw.inside[sl]) {
          scratch[2 * rw.e[sl]] = f.logit[sl];
          scratch[2 * rw.e[sl] + 1] = g_att[sl];
        }
      }
    }
    __syncthreads();
    // Phase 2: per sender, softmax and sum(att * g_att); scratch[e] becomes
    // (att, att * (g_att - sum)).
    for (int node = r.n0 + warp; node < r.n1; node += kTileWarps) {
      const int64_t lo = lower_bound(in.senders, r.e0, r.e1, node);
      const int64_t hi = lower_bound(in.senders, lo, r.e1, node + 1);
      float cand = -1e30f;
      for (int64_t e = lo + lane; e < hi; e += kWarp) {
        if (in.mask[e] > 0.f) cand = fmaxf(cand, scratch[2 * e]);
      }
      cand = warp_max(cand);
      const float node_max = cand > -1e29f ? cand : 0.f;
      float sum = 0.f;
      for (int64_t e = lo + lane; e < hi; e += kWarp) {
        const float mk = in.mask[e];
        sum += expf((mk > 0.f ? scratch[2 * e] : -1e30f) - node_max) * mk;
      }
      float denom = fmaxf(warp_sum(sum), 1e-16f);
      if (denom == 0.f) denom = 1.f;
      float weighted = 0.f;
      for (int64_t e = lo + lane; e < hi; e += kWarp) {
        const float mk = in.mask[e];
        const float a =
            expf((mk > 0.f ? scratch[2 * e] : -1e30f) - node_max) * mk /
            denom;
        weighted += a * scratch[2 * e + 1];
      }
      weighted = warp_sum(weighted);
      for (int64_t e = lo + lane; e < hi; e += kWarp) {
        const float mk = in.mask[e];
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

  // Phase 3: the full backward, tile by tile. acc holds the warp's share
  // of the weight gradients in C fragments (below), vec its column of the
  // vector gradients.
  float acc[kXT][4] = {};
  float vec = 0.f, attb = 0.f;
  // dcw2 = sum over edges of g_prephi * ch: the lane's fragment columns
  // nt * 8 + 2t + (0, 1), over its rows, summed over the warp at the end.
  float dcw2[kFT][2] = {};

  zero_tail(out.d_h_src, real, num_edges, k);
  zero_tail(out.d_h_dst, real, num_edges, k);
  zero_tail(out.d_prev, real, num_edges, k);
  zero_tail(out.d_radial, real, num_edges, 1);
  for (TilePipe tp = pipe_start(tb.in, in, r, in_tile, k); tp.more();) {
    const TileRef tr = tp.next(tb.in, in, k);
    const Rows rw = warp_rows(tr, r0, g);
    Fwd f;
    warp_forward(w, tb.hid, tb.m, tr.x, in.prev, rw, k, r0, g, t, true,
                 f);

    // The message gradient g_m, elementwise on the fragments.
    float gm[kFT][4];
    gather_gmsg(cot, rw, k, t, gm);
    float glog[2] = {0.f, 0.f};
    if (attention != kNone) {
      float a[2];
      if (attention == kSoftmax && !in_tile) {
#pragma unroll
        for (int sl = 0; sl < 2; ++sl) {
          a[sl] = rw.inside[sl] ? scratch[2 * rw.e[sl]] : 0.f;
          glog[sl] = rw.inside[sl] ? scratch[2 * rw.e[sl] + 1] : 0.f;
        }
      } else {
        float g_att[2];
        row_g_att(gm, f.m, rw, cot, g_att);
        if (attention == kSoftmax) {
#pragma unroll
          for (int sl = 0; sl < 2; ++sl) {
            if (t == 0) {
              tb.logit[r0 + g + 8 * sl] = f.logit[sl];
              tb.gatt[r0 + g + 8 * sl] = g_att[sl];
            }
          }
          __syncthreads();
          if (warp == 0) tile_softmax(tb, tr);
          __syncthreads();
#pragma unroll
          for (int sl = 0; sl < 2; ++sl) {
            const int row = r0 + g + 8 * sl;
            a[sl] = rw.inside[sl] ? tb.logit[row] : 0.f;
            glog[sl] = rw.inside[sl] ? tb.gatt[row] : 0.f;
          }
        }
#pragma unroll
        for (int sl = 0; sl < 2 && attention != kSoftmax; ++sl) {
          const float lg = f.logit[sl];
          a[sl] = activate(attention, lg);
          if (attention == kSigmoid) {
            glog[sl] = g_att[sl] * a[sl] * (1.f - a[sl]);
          } else if (attention == kTanh) {
            glog[sl] = g_att[sl] * (1.f - a[sl] * a[sl]);
          } else if (attention == kRelu) {
            glog[sl] = g_att[sl] * (lg > 0.f ? 1.f : 0.f);
          } else {
            glog[sl] = g_att[sl] * dsilu_f(lg);
          }
        }
      }
#pragma unroll
      for (int sl = 0; sl < 2; ++sl) {
        glog[sl] = rw.valid[sl] ? glog[sl] : 0.f;
      }
#pragma unroll
      for (int nt = 0; nt < kFT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int sl = i >> 1;
          gm[nt][i] = gm[nt][i] * a[sl] +
                      glog[sl] * w.attw[frag_col(nt, i, t)];
        }
      }
    }
    if (cot.d_msg != nullptr) {
#pragma unroll
      for (int nt = 0; nt < kFT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = frag_col(nt, i, t), sl = i >> 1;
          if (rw.valid[sl] && c < k) gm[nt][i] += cot.d_msg[rw.e[sl] * k + c];
        }
      }
    }

    // Coordinate MLP: g_prec, then g_m += g_prec . cW1.
    float gpp[2];
#pragma unroll
    for (int sl = 0; sl < 2; ++sl) {
      const float phi = use_tanh ? tanhf(f.prephi[sl]) : f.prephi[sl];
      const float g_phi = rw.valid[sl] ? cot.d_phi[rw.e[sl]] : 0.f;
      gpp[sl] = use_tanh ? g_phi * (1.f - phi * phi) : g_phi;
      if (t == 0) tb.glogit[r0 + g + 8 * sl] = glog[sl];
    }
    float* gprec = tb.gprec + r0 * kFPitch;
#pragma unroll
    for (int nt = 0; nt < kFT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = frag_col(nt, i, t), sl = i >> 1;
        const float x = f.prec[nt][i], sg = sigmoid_f(x);   // silu, silu'
        gprec[frag_row(i, g) * kFPitch + c] =
            rw.valid[sl] ? (w.cw2[c] * gpp[sl]) * (sg * (1.f + x * (1.f - sg)))
                         : 0.f;
        dcw2[nt][i & 1] = fmaf(gpp[sl], x * sg, dcw2[nt][i & 1]);
      }
    }
    __syncwarp();
    float prod[kFT][4] = {};
    warp_mma<kFT, kFT>(prod, View{gprec, kFPitch, 1},
                       View{w.cw1, kFPitch, 1}, g, t);
    // Edge MLP, second layer: g_pre2 = g_m * silu'(pre2); d_prev = g_m.
    float* gp2 = tb.gp2 + r0 * kFPitch;
#pragma unroll
    for (int nt = 0; nt < kFT; ++nt) {
#pragma unroll
      for (int sl = 0; sl < 2; ++sl) {
        float v[2];
#pragma unroll
        for (int par = 0; par < 2; ++par) {
          const int i = 2 * sl + par;
          v[par] = rw.valid[sl] ? gm[nt][i] + prod[nt][i] : 0.f;
          gp2[frag_row(i, g) * kFPitch + frag_col(nt, i, t)] =
              v[par] * dsilu_f(f.pre2[nt][i]);
          prod[nt][i] = 0.f;
        }
        if (out.d_prev != nullptr && rw.inside[sl]) {
          store_pair(out.d_prev + rw.e[sl] * k, frag_col(nt, 0, t), k, v[0],
                     v[1], pair);
        }
      }
    }
    __syncwarp();
    // First layer: g_pre1 = (g_pre2 . W2) * silu'(pre1).
    warp_mma<kFT, kFT>(prod, View{gp2, kFPitch, 1}, View{w.w2, kFPitch, 1},
                       g, t);
    float* gp1 = tb.gp1 + r0 * kFPitch;
#pragma unroll
    for (int nt = 0; nt < kFT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        gp1[frag_row(i, g) * kFPitch + frag_col(nt, i, t)] =
            prod[nt][i] * dsilu_f(f.pre1[nt][i]);
      }
    }
    __syncwarp();
    // The input gradient g_x = g_pre1 . W1 over the 72 padded columns, in
    // three chunks of 24 (fewer live registers).
#pragma unroll
    for (int chunk = 0; chunk < kXT / 3; ++chunk) {
      float gx[3][4] = {};
      warp_mma<kFT, 3>(gx, View{gp1, kFPitch, 1},
                       View{w.w1 + chunk * 24, kXPitch, 1}, g, t);
#pragma unroll
      for (int nt = 0; nt < 3; ++nt) {
#pragma unroll
        for (int sl = 0; sl < 2; ++sl) {
          if (!rw.inside[sl]) continue;
          const int c = frag_col(chunk * 3 + nt, 0, t);
          const int64_t e = rw.e[sl];
          const float v0 = gx[nt][2 * sl], v1 = gx[nt][2 * sl + 1];
          if (c < kMaxK) {
            store_pair(out.d_h_src + e * k, c, k, v0, v1, pair);
          } else if (c < 2 * kMaxK) {
            store_pair(out.d_h_dst + e * k, c - kMaxK, k, v0, v1, pair);
          } else if (c == 2 * kMaxK) {
            out.d_radial[e] = v0;
          }
        }
      }
    }

    // Parameter gradients over the tile's 64 edges, one weight matrix per
    // warp pair: warps 0 and 1 take rows 0-15 and 16-31 of dW1 += g_pre1^T x
    // (9 n-tiles), warp 2 dW2 += g_pre2^T hid, warp 3 dcW1 += g_prec^T m
    // (2 x 4 tiles each). The reduction runs over the tile's edges.
    __syncthreads();
    if (warp < 2) {
      warp_mma<kTile / 8, kXT>(acc, View{tb.gp1 + warp * 16, 1, kFPitch},
                               View{tr.x, kXPitch, 1}, g, t);
    } else {
      const float* gsrc = warp == 2 ? tb.gp2 : tb.gprec;
      const float* ysrc = warp == 2 ? tb.hid : tb.m;
      warp_mma<kTile / 8, kFT>(acc, View{gsrc, 1, kFPitch},
                               View{ysrc, kFPitch, 1}, g, t);
      warp_mma<kTile / 8, kFT>(acc + kFT, View{gsrc + 16, 1, kFPitch},
                               View{ysrc, kFPitch, 1}, g, t);
    }
    // Vector gradients: warp v sums column `lane` of db1, db2, dcb1 or
    // dattw over the tile's rows in a fixed order; warp 3 also dattb.
    {
      const float* src = warp == 0 ? tb.gp1 : warp == 1 ? tb.gp2
                         : warp == 2 ? tb.gprec : tb.m;
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int row = 0; row < kTile; ++row) {
        const float wt = warp == 3 ? tb.glogit[row] : 1.f;
        part[row % 4] = fmaf(wt, src[row * kFPitch + lane], part[row % 4]);
      }
      vec += (part[0] + part[1]) + (part[2] + part[3]);
      if (warp == 3) attb += warp_sum(tb.glogit[lane] + tb.glogit[lane + 32]);
    }
  }

  cp_async_wait_all();
  // The block's partial row: each element written by the one thread that
  // summed it.
  float* dst = partials + static_cast<int64_t>(blockIdx.x) * kParamWidth;
#pragma unroll
  for (int nt = 0; nt < kXT; ++nt) {
#pragma unroll
    for (int el = 0; el < 4; ++el) {
      if (warp < 2) {
        const int c = frag_col(nt, el, t);
        if (c < kIn) {
          dst[kOffW1 + (warp * 16 + frag_row(el, g)) * kIn + c] = acc[nt][el];
        }
      } else if (nt < 2 * kFT) {
        const int j = (nt / kFT) * 16 + frag_row(el, g);
        dst[(warp == 2 ? kOffW2 : kOffCW1) + j * kMaxK +
            frag_col(nt % kFT, el, t)] = acc[nt][el];
      }
    }
  }
  dst[(warp == 0 ? kOffB1 : warp == 1 ? kOffB2 : warp == 2 ? kOffCB1
                                                            : kOffAttW) +
      lane] = vec;
  if (warp == 3 && lane == 0) dst[kOffAttB] = attb;
  // dcw2: over the 8 row groups of the warp (butterfly, same bits in every
  // lane), then over the warps in order.
#pragma unroll
  for (int nt = 0; nt < kFT; ++nt) {
#pragma unroll
    for (int par = 0; par < 2; ++par) {
      float v = dcw2[nt][par];
      for (int off = 4; off < kWarp; off *= 2) {
        v += __shfl_xor_sync(kFull, v, off);
      }
      if (g == 0) tb.dcw2[warp][nt * 8 + 2 * t + par] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < kMaxK) {
    float v = 0.f;
    for (int wi = 0; wi < kTileWarps; ++wi) v += tb.dcw2[wi][threadIdx.x];
    dst[kOffCW2 + threadIdx.x] = v;
  }
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

// Blocks: one wave of the resident block slots at K4's resources, at most
// one per sender (fused_egnn_tile.cuh).
int num_blocks(int num_nodes) {
  static int slots[kMaxDevices] = {};
  return wave_blocks(reinterpret_cast<const void*>(fused_edge_backward_kernel),
                     kSmemBytes, num_nodes, slots);
}

}  // namespace
}  // namespace pvs_fused

// Width of the packed parameter-gradient vector (and of a partials row).
extern "C" int pvs_fused_backward_param_width() {
  return pvs_fused::kParamWidth;
}

// Number of blocks, i.e. rows of the partials buffer, for num_nodes senders.
extern "C" int pvs_fused_backward_num_blocks(int num_nodes) {
  return pvs_fused::num_blocks(num_nodes);
}

// The main kernel's resources on the current device: info[0] registers per
// thread, [1] local (spill) bytes per thread, [2] static and [3] dynamic
// shared bytes per block, [4] blocks resident per SM. Returns a cudaError.
extern "C" int pvs_fused_backward_info(int* info) {
  using namespace pvs_fused;
  return tile_kernel_info(
      reinterpret_cast<const void*>(fused_edge_backward_kernel), kSmemBytes,
      info);
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
  // Vector paths need K % 4 == 0 (loads) or K % 2 == 0 (stores) and
  // aligned rows.
  const auto aligned = [](const void* q, uintptr_t to) {
    return reinterpret_cast<uintptr_t>(q) % to == 0;
  };
  const bool vec4 = k % 4 == 0 && aligned(h, 16) && aligned(h_dst, 16) &&
                    aligned(extras, 16);
  const bool pair = k % 2 == 0 && aligned(d_h_src, 8) &&
                    aligned(d_h_dst, 8) && aligned(d_prev, 8);
  const Inputs in{h, h_dst, extras, mask, prev, senders, vec4};
  const Params p{w1, b1, w2, b2, cw1, cb1, cw2, attw, attb};
  const Cotangents cot{d_agg, d_phi, d_att, d_msg};
  const EdgeGrads out{d_h_src, d_h_dst, d_radial, d_prev};
  const int blocks = num_blocks(num_nodes);   // opts in to the shared memory
  fused_edge_backward_kernel<<<blocks, kTileThreads, kSmemBytes, st>>>(
      in, p, cot, out, scratch, partials, num_edges, k, num_nodes, attention,
      use_tanh, pair);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials_kernel<<<(kParamWidth + 255) / 256, 256, 0, st>>>(
      partials, d_params, blocks);
  return static_cast<int>(cudaGetLastError());
}
