// Edge tiles shared by the fused edge pass kernels K3 (fused_egnn.cu) and
// K4 (fused_egnn_bwd.cu): blocks of 4 warps, each owning an equal share of
// the real edges cut at sender boundaries; 64-edge tiles of the edge MLP
// input copied by cp.async one tile ahead of the math; the recomputed edge
// MLP forward of a warp's 16 rows on tensor cores (fused_egnn_tc.cuh); and
// the warp segmented scans that close a per-sender softmax inside a tile
// cut at sender boundaries.
//
// Rows past a tile's edges and feature columns past K are zero-filled as
// they arrive, and prev is selected by the mask as it is read: a NaN
// canary (padding and masked positions may hold NaN) inside an mma would
// poison a whole fragment.
#pragma once

#include "fused_egnn_tc.cuh"

namespace pvs_fused {

constexpr int kTileWarps = 4;
constexpr int kTileThreads = kWarp * kTileWarps;
constexpr int kTile = 16 * kTileWarps;   // edges per tile, 16 per warp

struct Inputs {
  const float *h, *h_dst, *extras, *mask, *prev;
  const int32_t* senders;
  bool vec4;   // K % 4 == 0 and h, h_dst, extras 16-byte aligned
};

// The input tiles of up to 64 edges, row-major: the edge MLP input (two
// buffers: the next tile's copy runs behind this tile's math), the per-row
// mask and sender (three buffers: they are fetched a tile ahead of x, whose
// gathers need them, and set where the tile after starts).
struct InTiles {
  float x[2][kTile * kXPitch];
  float mask[3][kTile + 1];   // one row more: where the next tile starts
  int sender[3][kTile + 1];
};

// The block's edges [e0, e1) and their senders [n0, n1).
struct Range {
  int n0, n1;
  int64_t e0, e1;
};

// First index in ids[lo, hi) whose value is >= key (ids ascending), found
// by the whole block, every thread of which must call it and gets the
// answer: each round the threads probe the last element of 128 equal
// chunks and count those below the key, which narrows the range 128-fold,
// so ~3 rounds of one load each replace a search of ~18 dependent loads.
__device__ __forceinline__ int64_t block_lower_bound(
    const int32_t* __restrict__ ids, int64_t lo, int64_t hi, int32_t key) {
  while (lo < hi) {   // the answer lies in [lo, hi]
    const int64_t step = (hi - lo + kTileThreads - 1) / kTileThreads;
    const int64_t start = lo + threadIdx.x * step;
    const bool below = start < hi && ids[min(start + step, hi) - 1] < key;
    const int64_t next = min(lo + __syncthreads_count(below) * step, hi);
    if (step == 1 || next == hi) return next;
    hi = min(next + step, hi) - 1;   // that chunk's last element is >= key
    lo = next;
  }
  return lo;
}

// Real edges (sender < num_nodes) form the sorted prefix [0, real). Block b
// owns [cut(b), cut(b + 1)): the prefix split into gridDim.x nearly equal
// parts, each cut moved forward to the next sender boundary so that a
// block owns every edge of its senders. Equal edge counts, not equal
// sender counts: degrees vary several-fold along a batch of graphs. Every
// thread of the block calls it.
__device__ __forceinline__ int64_t share_cut(
    const int32_t* __restrict__ senders, int64_t real, int64_t b) {
  const int64_t per = (real + gridDim.x - 1) / gridDim.x;
  const int64_t p = min(b * per, real);
  if (p == 0 || p == real || senders[p - 1] != senders[p]) return p;
  // The boundary is most often within 128 edges.
  const int64_t near = min(p + kTileThreads, real);
  const int64_t q = block_lower_bound(senders, p, near, senders[p] + 1);
  return q < near ? q : block_lower_bound(senders, near, real, senders[p] + 1);
}

__device__ __forceinline__ Range edge_share(
    const int32_t* __restrict__ senders, int64_t real) {
  Range r;
  r.e0 = share_cut(senders, real, blockIdx.x);
  r.e1 = share_cut(senders, real, blockIdx.x + 1);
  r.n0 = r.e0 < r.e1 ? senders[r.e0] : 0;
  r.n1 = r.e0 < r.e1 ? senders[r.e1 - 1] + 1 : 0;
  return r;
}

// Whether a sender of the block has more than 64 edges.
__device__ __forceinline__ bool has_hub(const int32_t* __restrict__ senders,
                                        const Range& r) {
  bool hub = false;
#pragma unroll 4
  for (int64_t e = r.e0 + threadIdx.x; e + kTile < r.e1;
       e += kTileThreads) {
    hub |= senders[e] == senders[e + kTile];
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
__device__ __forceinline__ void issue_rows(InTiles& tb, const Inputs& in,
                                           int64_t b, int64_t e1, int buf) {
  const int row = threadIdx.x;
  if (row > kTile || b >= e1) return;
  const int64_t e = b + row;
  const bool inside = e < e1;
  cp_async4(&tb.mask[buf][row], inside ? in.mask + e : in.mask, inside);
  cp_async4(&tb.sender[buf][row], inside ? in.senders + e : in.senders,
            inside);
}

__device__ __forceinline__ void issue_x(InTiles& tb, const Inputs& in,
                                        int64_t eb, int64_t ee, int xbuf,
                                        int rowbuf, int k) {
  const int* sender = tb.sender[rowbuf];
  float* x = tb.x[xbuf];
  if (in.vec4) {   // 16-byte copies: 18 per row
    constexpr int kChunks = kXCols / 4;
#pragma unroll 3
    for (int idx = threadIdx.x; idx < kTile * kChunks; idx += kTileThreads) {
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
  for (int idx = threadIdx.x; idx < kTile * kXCols; idx += kTileThreads) {
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
__device__ __forceinline__ int64_t tile_end(const InTiles& tb, int rowbuf,
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

  __device__ __forceinline__ TileRef next(InTiles& tb, const Inputs& in,
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
__device__ __forceinline__ TilePipe pipe_start(InTiles& tb, const Inputs& in,
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

// One warp: the per-sender softmax of the tile's rows (a tile cut at
// sender boundaries holds every edge of its senders) from their logits,
// as the reference computes it: -1e30 at masked edges, a row max of 0 when
// no edge is unmasked, the denominator max(denom, 1e-16). Lane L gets att
// of rows 2L and 2L + 1 and which of them start or end a sender.
__device__ __forceinline__ void seg_softmax(const TileRef& tr,
                                            const float* logit,
                                            bool (&first)[2], bool (&last)[2],
                                            float (&a)[2]) {
  const int len = static_cast<int>(tr.ee - tr.eb);
  const int r0 = 2 * (threadIdx.x % kWarp);
  const auto key = [&](int r) { return r < len ? tr.sender[r] : -1; };
  float mk[2], lg[2], v[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + i;
    first[i] = r == 0 || key(r) != key(r - 1);
    last[i] = r == kTile - 1 || key(r) != key(r + 1);
    mk[i] = r < len ? tr.mask[r] : 0.f;
    lg[i] = mk[i] > 0.f ? logit[r] : -1e30f;
    v[i] = lg[i];
  }
  const auto max_op = [](float x, float y) { return fmaxf(x, y); };
  const auto sum_op = [](float x, float y) { return x + y; };
  seg_total(v, first, last, max_op, -1e30f);
  float e[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    e[i] = expf(lg[i] - (v[i] > -1e29f ? v[i] : 0.f)) * mk[i];
    v[i] = e[i];
  }
  seg_total(v, first, last, sum_op, 0.f);
#pragma unroll
  for (int i = 0; i < 2; ++i) a[i] = e[i] / fmaxf(v[i], 1e-16f);
}

// Recomputed forward of the warp's 16 rows, in C fragments (n-tile nt of
// 8 features): pre1, pre2, m (with prev), and with `coord` also prec; the
// per-row logit and pre-phi. hidden and m go to the warp's rows of
// hid_tile and m_tile, which may be one buffer (m then replaces hidden).
struct Fwd {
  float pre1[kFT][4], pre2[kFT][4], m[kFT][4], prec[kFT][4];
  float logit[2], prephi[2];
};

__device__ __forceinline__ void warp_forward(const TcWeights& w,
                                             float* hid_tile, float* m_tile,
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
  float* hid = hid_tile + r0 * kFPitch;
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
  __syncwarp();   // every lane has read hidden before m may replace it
  float* m = m_tile + r0 * kFPitch;
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

// Host side. One wave of `kernel`'s resident block slots on the current
// device (SMs x blocks per SM at its resources; a block's tile loop is
// long, so a second, partial wave would cost a whole block's time), at
// most one block per sender. The query, and the shared-memory opt-in it
// makes, run once per device: `slots` keeps them.
constexpr int kMaxDevices = 16;

inline cudaError_t allow_smem(const void* kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

inline int wave_blocks(const void* kernel, size_t smem, int num_nodes,
                       int (&slots)[kMaxDevices]) {
  int dev = 0;
  cudaGetDevice(&dev);
  int n = dev < kMaxDevices ? slots[dev] : 0;
  if (n == 0) {
    int sms = 0, per_sm = 0;
    allow_smem(kernel, smem);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                  kTileThreads, smem);
    n = max(1, sms * per_sm);
    if (dev < kMaxDevices) slots[dev] = n;
  }
  return min(n, max(num_nodes, 1));
}

// `kernel`'s resources on the current device: info[0] registers per
// thread, [1] local (spill) bytes per thread, [2] static and [3] dynamic
// shared bytes per block, [4] blocks resident per SM. Returns a cudaError.
inline int tile_kernel_info(const void* kernel, size_t smem, int* info) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kTileThreads, smem);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(attr.sharedSizeBytes);
  info[3] = static_cast<int>(smem);
  info[4] = blocks;
  return static_cast<int>(err);
}

}  // namespace pvs_fused
