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
// Design (fused_egnn_tc.cuh has the tile helpers), against the four causes
// that held the first version (one warp per edge, lane j on feature j) at
// ~20x its bound:
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
#include "fused_egnn_tc.cuh"

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

constexpr int kBwdWarps = 4;
constexpr int kBwdThreads = kWarp * kBwdWarps;
constexpr int kTile = 16 * kBwdWarps;     // edges per tile, 16 per warp

namespace {

struct Cotangents {
  const float *d_agg, *d_phi, *d_att, *d_msg;
};

struct EdgeGrads {
  float *d_h_src, *d_h_dst, *d_radial, *d_prev;
};

// Tiles of up to 64 edges, row-major: the edge MLP input (two buffers: the
// next tile's copy runs behind this tile's math), the per-row mask and
// sender (three buffers: they are fetched a tile ahead of x, whose gathers
// need them, and set where the tile after starts), then for the current
// tile the activations the parameter gradients need and the pre-activation
// gradients.
struct TileBuf {
  float x[2][kTile * kXPitch];
  float mask[3][kTile + 1];   // one row more: where the next tile starts
  int sender[3][kTile + 1];
  float hid[kTile * kFPitch], m[kTile * kFPitch];
  float gp1[kTile * kFPitch], gp2[kTile * kFPitch], gprec[kTile * kFPitch];
  float glogit[kTile];
  float logit[kTile], gatt[kTile];   // per row, for the in-tile softmax
  float dcw2[kBwdWarps][kMaxK];      // per-warp dcw2, summed at the end
};

constexpr size_t kWeightBytes = (sizeof(TcWeights) + 15) / 16 * 16;
constexpr size_t kSmemBytes = kWeightBytes + sizeof(TileBuf);

struct Inputs {
  const float *h, *h_dst, *extras, *mask, *prev;
  const int32_t* senders;
  bool vec4;   // K % 4 == 0 and h, h_dst, extras 16-byte aligned
};

// Real edges (sender < num_nodes) form the sorted prefix [0, real). Block b
// owns [cut(b), cut(b + 1)): the prefix split into gridDim.x nearly equal
// parts, each cut moved forward to the next sender boundary so that a
// block owns every edge of its senders. Equal edge counts, not equal
// sender counts: degrees vary several-fold along a batch of graphs.
__device__ __forceinline__ int64_t block_cut(
    const int32_t* __restrict__ senders, int64_t real, int64_t per,
    int64_t b) {
  const int64_t p = min(b * per, real);
  if (p == 0 || p == real || senders[p - 1] != senders[p]) return p;
  return lower_bound(senders, p, real, senders[p] + 1);
}

// The block's edges [e0, e1) and their senders [n0, n1).
__device__ __forceinline__ Range bwd_block_range(
    const int32_t* __restrict__ senders, int64_t real) {
  const int64_t per = (real + gridDim.x - 1) / gridDim.x;
  Range r;
  r.e0 = block_cut(senders, real, per, blockIdx.x);
  r.e1 = block_cut(senders, real, per, blockIdx.x + 1);
  r.n0 = r.e0 < r.e1 ? senders[r.e0] : 0;
  r.n1 = r.e0 < r.e1 ? senders[r.e1 - 1] + 1 : 0;
  return r;
}

// Whether a sender of the block has more than 64 edges.
__device__ __forceinline__ bool has_hub(const int32_t* __restrict__ senders,
                                        const Range& r) {
  bool hub = false;
  for (int64_t e = r.e0 + threadIdx.x; e + kTile < r.e1; e += kBwdThreads) {
    hub = hub || senders[e] == senders[e + kTile];
  }
  return __syncthreads_or(hub);
}

// Write 0 to the `width` values of every padding edge [real, num_edges) of
// `out` (none when out is null); every block takes a strided share.
__device__ __forceinline__ void zero_tail(float* out, int64_t real,
                                          int64_t num_edges, int width) {
  if (out == nullptr) return;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = real * width + static_cast<int64_t>(blockIdx.x) *
                                      blockDim.x + threadIdx.x;
       i < num_edges * width; i += stride) {
    out[i] = 0.f;
  }
}

// The tile pipeline, all copies by cp.async. Tile i starts at b_i; its
// sender and mask rows [b_i, b_i + 65) go to buffer i % 3 two tiles ahead,
// its x rows one tile ahead to buffer i % 2, zero-filled past the tile's
// end and in columns past K.
__device__ __forceinline__ void issue_rows(TileBuf& tb, const Inputs& in,
                                           int64_t b, int64_t e1, int buf) {
  const int row = threadIdx.x;
  if (row > kTile || b >= e1) return;
  const int64_t e = b + row;
  const bool inside = e < e1;
  cp_async4(&tb.mask[buf][row], inside ? in.mask + e : in.mask, inside);
  cp_async4(&tb.sender[buf][row], inside ? in.senders + e : in.senders,
            inside);
}

__device__ __forceinline__ void issue_x(TileBuf& tb, const Inputs& in,
                                        int64_t eb, int64_t ee, int xbuf,
                                        int rowbuf, int k) {
  const int* sender = tb.sender[rowbuf];
  float* x = tb.x[xbuf];
  if (in.vec4) {   // 16-byte copies: 18 per row
    constexpr int kChunks = kXCols / 4;
#pragma unroll 3
    for (int idx = threadIdx.x; idx < kTile * kChunks; idx += kBwdThreads) {
      const int row = idx / kChunks, c = (idx % kChunks) * 4;
      const int64_t e = eb + row;
      const float* src = in.h;
      bool fill = false;
      if (e < ee) {
        if (c < kMaxK) {
          fill = c < k;
          src = in.h + static_cast<int64_t>(sender[row]) * k + c;
        } else if (c < 2 * kMaxK) {
          fill = c - kMaxK < k;
          src = in.h_dst + e * k + (c - kMaxK);
        } else if (c < kIn) {
          fill = true;
          src = in.extras + e * 4;
        }
      }
      cp_async16(x + row * kXPitch + c, fill ? src : in.h, fill);
    }
    return;
  }
#pragma unroll 4
  for (int idx = threadIdx.x; idx < kTile * kXCols; idx += kBwdThreads) {
    const int row = idx / kXCols, c = idx % kXCols;
    const int64_t e = eb + row;
    const float* src = in.h;
    bool fill = false;
    if (e < ee) {
      if (c < kMaxK) {
        fill = c < k;
        src = in.h + static_cast<int64_t>(sender[row]) * k + c;
      } else if (c < 2 * kMaxK) {
        fill = c - kMaxK < k;
        src = in.h_dst + e * k + (c - kMaxK);
      } else if (c < kIn) {
        fill = true;
        src = in.extras + e * 4 + (c - 2 * kMaxK);
      }
    }
    cp_async4(x + row * kXPitch + c, fill ? src : in.h, fill);
  }
}

// End of the tile that starts at b, from its sender rows: b + 64 (or e1),
// or with `whole_senders` the last sender boundary within 64 edges (the
// block has no sender of more than 64 edges). Every warp reads the same
// rows, so the whole block agrees.
__device__ __forceinline__ int64_t tile_end(const TileBuf& tb, int rowbuf,
                                            int64_t b, int64_t e1,
                                            bool whole_senders) {
  if (b + kTile >= e1) return e1;
  if (!whole_senders) return b + kTile;
  const int* s = tb.sender[rowbuf];
  const int lane = threadIdx.x % kWarp;
  // Row j starts a sender when s[j] != s[j - 1]; the largest such j <= 64.
  const unsigned lo = __ballot_sync(kFull, s[lane + 1] != s[lane]);
  const unsigned hi = __ballot_sync(kFull, s[lane + 33] != s[lane + 32]);
  return b + (hi != 0u ? 64 - __clz(hi) : 32 - __clz(lo));
}

struct TileRef {
  int64_t eb, ee;
  const float* x;
  const float* mask;
  const int* sender;
};

// Walks the block's tiles: `next` waits for the current tile's copies
// (every thread is then past the previous tile, so its buffers may be
// refilled), starts the copies of the tiles after it and returns it.
struct TilePipe {
  int64_t b, ee, e1, tile;
  bool whole_senders;

  __device__ __forceinline__ bool more() const { return b < e1; }

  __device__ __forceinline__ TileRef next(TileBuf& tb, const Inputs& in,
                                          int k) {
    cp_async_wait_all();
    __syncthreads();
    const TileRef tr{b, ee, tb.x[tile % 2], tb.mask[tile % 3],
                     tb.sender[tile % 3]};
    const int64_t bn = ee;
    int64_t en = bn;
    if (bn < e1) {
      en = tile_end(tb, (tile + 1) % 3, bn, e1, whole_senders);
      issue_x(tb, in, bn, en, (tile + 1) % 2, (tile + 1) % 3, k);
      issue_rows(tb, in, en, e1, (tile + 2) % 3);
    }
    cp_async_commit();
    b = bn;
    ee = en;
    ++tile;
    return tr;
  }
};

// Rows and end of tile 0 ready, its x and the rows of tile 1 in flight.
__device__ __forceinline__ TilePipe pipe_start(TileBuf& tb, const Inputs& in,
                                               const Range& r,
                                               bool whole_senders, int k) {
  TilePipe tp{r.e0, r.e0, r.e1, 0, whole_senders};
  if (r.e0 >= r.e1) return tp;
  issue_rows(tb, in, r.e0, r.e1, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  tp.ee = tile_end(tb, 0, r.e0, r.e1, whole_senders);
  issue_x(tb, in, r.e0, tp.ee, 0, 0, k);
  issue_rows(tb, in, tp.ee, r.e1, 1);
  cp_async_commit();
  return tp;
}

// The warp's 16 rows of the tile: edge, in-range flag and mask of the two
// C-fragment rows g and g + 8 of this lane.
struct Rows {
  int64_t e[2];
  bool inside[2], valid[2];
  float mask[2];
  int sender[2];
};

__device__ __forceinline__ Rows warp_rows(const TileRef& tr, int r0, int g) {
  Rows rw;
#pragma unroll
  for (int sl = 0; sl < 2; ++sl) {
    const int row = r0 + g + 8 * sl;
    rw.e[sl] = tr.eb + row;
    rw.inside[sl] = rw.e[sl] < tr.ee;
    rw.mask[sl] = rw.inside[sl] ? tr.mask[row] : 0.f;
    rw.valid[sl] = rw.inside[sl] && rw.mask[sl] > 0.f;
    rw.sender[sl] = tr.sender[row];
  }
  return rw;
}

// Segmented inclusive scans over a tile's 64 rows in one warp, lane L
// holding rows 2L and 2L + 1: forward, each row combines its segment's rows
// up to it (first[i]: row starts a segment); backward, from it to the
// segment's end (last[i]: row ends one).
template <typename Op>
__device__ __forceinline__ void seg_scan_fwd(float (&v)[2],
                                             const bool (&first)[2], Op op) {
  const int lane = threadIdx.x % kWarp;
  float val = first[1] ? v[1] : op(v[0], v[1]);
  bool flag = first[0] || first[1];
  for (int d = 1; d < kWarp; d *= 2) {
    const float other = __shfl_up_sync(kFull, val, d);
    const bool other_flag = __shfl_up_sync(kFull, flag, d);
    if (lane >= d) {
      if (!flag) val = op(other, val);
      flag = flag || other_flag;
    }
  }
  const float carry = __shfl_up_sync(kFull, val, 1);
  if (lane > 0 && !first[0]) v[0] = op(carry, v[0]);
  if (!first[1]) v[1] = op(v[0], v[1]);
}

template <typename Op>
__device__ __forceinline__ void seg_scan_bwd(float (&v)[2],
                                             const bool (&last)[2], Op op) {
  const int lane = threadIdx.x % kWarp;
  float val = last[0] ? v[0] : op(v[0], v[1]);
  bool flag = last[0] || last[1];
  for (int d = 1; d < kWarp; d *= 2) {
    const float other = __shfl_down_sync(kFull, val, d);
    const bool other_flag = __shfl_down_sync(kFull, flag, d);
    if (lane + d < kWarp) {
      if (!flag) val = op(val, other);
      flag = flag || other_flag;
    }
  }
  const float carry = __shfl_down_sync(kFull, val, 1);
  if (lane < kWarp - 1 && !last[1]) v[1] = op(v[1], carry);
  if (!last[0]) v[0] = op(v[0], v[1]);
}

// The segment's total in every row: a forward scan, then its last row's
// value spread back over the segment.
template <typename Op>
__device__ __forceinline__ void seg_total(float (&v)[2],
                                          const bool (&first)[2],
                                          const bool (&last)[2], Op op,
                                          float identity) {
  seg_scan_fwd(v, first, op);
  v[0] = last[0] ? v[0] : identity;
  v[1] = last[1] ? v[1] : identity;
  seg_scan_bwd(v, last, op);
}

// One warp: the per-sender softmax of the tile's rows (tiles cut at sender
// boundaries hold every edge of a sender) and its backward, from the logit
// and g_att in tb.logit / tb.gatt, which are overwritten by att and
// att * (g_att - sum(att * g_att)), as the reference's per-sender softmax.
__device__ __forceinline__ void tile_softmax(TileBuf& tb, const TileRef& tr) {
  const int len = static_cast<int>(tr.ee - tr.eb);
  const int r0 = 2 * (threadIdx.x % kWarp);
  const auto key = [&](int r) { return r < len ? tr.sender[r] : -1; };
  bool first[2], last[2];
  float mk[2], lg[2], ga[2], v[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + i;
    first[i] = r == 0 || key(r) != key(r - 1);
    last[i] = r == kTile - 1 || key(r) != key(r + 1);
    mk[i] = r < len ? tr.mask[r] : 0.f;
    lg[i] = mk[i] > 0.f ? tb.logit[r] : -1e30f;
    ga[i] = tb.gatt[r];
    v[i] = lg[i];
  }
  const auto max_op = [](float a, float b) { return fmaxf(a, b); };
  const auto sum_op = [](float a, float b) { return a + b; };
  seg_total(v, first, last, max_op, -1e30f);
  float e[2], a[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    e[i] = expf(lg[i] - (v[i] > -1e29f ? v[i] : 0.f)) * mk[i];
    v[i] = e[i];
  }
  seg_total(v, first, last, sum_op, 0.f);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    a[i] = e[i] / fmaxf(v[i], 1e-16f);
    v[i] = a[i] * ga[i];
  }
  seg_total(v, first, last, sum_op, 0.f);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    tb.logit[r0 + i] = a[i];
    tb.gatt[r0 + i] = a[i] * (ga[i] - v[i]);
  }
}

// Recomputed forward of the warp's 16 rows, in C fragments (n-tile nt of
// 8 features): pre1, pre2, m (with prev), and with `coord` also prec; the
// per-row logit and pre-phi. hid and m go to the tile buffer.
struct Fwd {
  float pre1[kFT][4], pre2[kFT][4], m[kFT][4], prec[kFT][4];
  float logit[2], prephi[2];
};

__device__ __forceinline__ void warp_forward(const TcWeights& w, TileBuf& tb,
                                             const float* x,
                                             const float* __restrict__ prev,
                                             const Rows& rw, int k, int r0,
                                             int g, int t, bool coord,
                                             Fwd& f) {
#pragma unroll
  for (int nt = 0; nt < kFT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = frag_col(nt, i, t);
      f.pre1[nt][i] = w.b1[c];
      f.pre2[nt][i] = w.b2[c];
      f.prec[nt][i] = w.cb1[c];
    }
  }
  warp_mma<kXT, kFT>(f.pre1, View{x + r0 * kXPitch, kXPitch, 1},
                     View{w.w1, 1, kXPitch}, g, t);
  float* hid = tb.hid + r0 * kFPitch;
#pragma unroll
  for (int nt = 0; nt < kFT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hid[frag_row(i, g) * kFPitch + frag_col(nt, i, t)] =
          silu_f(f.pre1[nt][i]);
    }
  }
  __syncwarp();
  warp_mma<kFT, kFT>(f.pre2, View{hid, kFPitch, 1}, View{w.w2, 1, kFPitch},
                     g, t);
  float* m = tb.m + r0 * kFPitch;
  float lg[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < kFT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = frag_col(nt, i, t), sl = i >> 1;
      float v = silu_f(f.pre2[nt][i]);
      // prev at masked edges may hold NaN: select, never multiply.
      if (prev != nullptr && rw.valid[sl] && c < k) {
        v += prev[rw.e[sl] * k + c];
      }
      f.m[nt][i] = v;
      m[frag_row(i, g) * kFPitch + c] = v;
      lg[sl] = fmaf(w.attw[c], v, lg[sl]);
    }
  }
  f.logit[0] = quad_sum(lg[0]) + w.attb;
  f.logit[1] = quad_sum(lg[1]) + w.attb;
  if (!coord) return;
  __syncwarp();
  warp_mma<kFT, kFT>(f.prec, View{m, kFPitch, 1}, View{w.cw1, 1, kFPitch},
                     g, t);
  float ph[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < kFT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = frag_col(nt, i, t);
      ph[i >> 1] = fmaf(w.cw2[c], silu_f(f.prec[nt][i]), ph[i >> 1]);
    }
  }
  f.prephi[0] = quad_sum(ph[0]);
  f.prephi[1] = quad_sum(ph[1]);
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

__global__ void __launch_bounds__(kBwdThreads, 2) fused_edge_backward_kernel(
    Inputs in, Params p, Cotangents cot, EdgeGrads out, float* scratch,
    float* __restrict__ partials, int64_t num_edges, int k, int num_nodes,
    int attention, int use_tanh, bool pair) {
  extern __shared__ float4 smem_raw[];
  TcWeights& w = *reinterpret_cast<TcWeights*>(smem_raw);
  TileBuf& tb = *reinterpret_cast<TileBuf*>(
      reinterpret_cast<char*>(smem_raw) + kWeightBytes);
  load_weights_tc(w, p, k);  // ends with a barrier
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int g = lane / 4, t = lane % 4, r0 = warp * 16;
  const int64_t real = lower_bound(in.senders, 0, num_edges, num_nodes);
  const Range r = bwd_block_range(in.senders, real);
  // Softmax mode: tiles cut at sender boundaries, the softmax inside each
  // tile (no phases 1 and 2), unless a sender has more than 64 edges.
  const bool in_tile = attention == kSoftmax && !has_hub(in.senders, r);

  if (attention == kSoftmax && !in_tile) {
    // Phase 1: per edge, the logit and g_att into scratch[e] = (l, g).
    for (TilePipe tp = pipe_start(tb, in, r, false, k); tp.more();) {
      const TileRef tr = tp.next(tb, in, k);
      const Rows rw = warp_rows(tr, r0, g);
      Fwd f;
      warp_forward(w, tb, tr.x, in.prev, rw, k, r0, g, t, false, f);
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
    for (int node = r.n0 + warp; node < r.n1; node += kBwdWarps) {
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
  for (TilePipe tp = pipe_start(tb, in, r, in_tile, k); tp.more();) {
    const TileRef tr = tp.next(tb, in, k);
    const Rows rw = warp_rows(tr, r0, g);
    Fwd f;
    warp_forward(w, tb, tr.x, in.prev, rw, k, r0, g, t, true, f);

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
    for (int wi = 0; wi < kBwdWarps; ++wi) v += tb.dcw2[wi][threadIdx.x];
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

cudaError_t allow_smem() {
  return cudaFuncSetAttribute(fused_edge_backward_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kSmemBytes));
}

// The device's resident block slots: SMs x blocks per SM at K4's
// resources.
int resident_slots(int dev) {
  int sms = 0, per_sm = 0;
  allow_smem();
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_edge_backward_kernel, kBwdThreads, kSmemBytes);
  return max(1, sms * per_sm);
}

// Blocks: one wave of the resident block slots (the blocks' tile loops are
// long, so a second, partial wave would cost a whole block's time), at most
// one per sender. The queries, and the shared-memory opt-in they make, run
// once per device, not on every launch.
int num_blocks(int num_nodes) {
  constexpr int kDevices = 16;
  static int slots[kDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  int n = dev < kDevices ? slots[dev] : 0;
  if (n == 0) {
    n = resident_slots(dev);
    if (dev < kDevices) slots[dev] = n;
  }
  return min(n, max(num_nodes, 1));
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
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fused_edge_backward_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fused_edge_backward_kernel, kBwdThreads, kSmemBytes);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(attr.sharedSizeBytes);
  info[3] = static_cast<int>(kSmemBytes);
  info[4] = blocks;
  return static_cast<int>(err);
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
  fused_edge_backward_kernel<<<blocks, kBwdThreads, kSmemBytes, st>>>(
      in, p, cot, out, scratch, partials, num_edges, k, num_nodes, attention,
      use_tanh, pair);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials_kernel<<<(kParamWidth + 255) / 256, 256, 0, st>>>(
      partials, d_params, blocks);
  return static_cast<int>(cudaGetLastError());
}
