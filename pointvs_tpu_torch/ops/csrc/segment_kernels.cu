// Segment reductions over destination-sorted edge lists, for Hopper (sm_90a).
//
// Both kernels read edges sorted by destination id. Row n's edges are
// [offsets[n], offsets[n + 1]); offsets[num_segments] is the first padding
// edge, so padding edges fall in no row and are never read. The caller
// finds the offsets once per id array (ops/segment_kernels.py,
// segment_offsets) and passes them to every launch over that array, as the
// TPU wrappers find their window starts once with jnp.searchsorted and
// hand them in by scalar prefetch. No atomics: every sum is taken in a
// fixed order, so results are deterministic from run to run.
//
// K1 segment_sum_sorted replaces pallas_windowed_segment_sum
// (pointvs_tpu/ops/pallas/segment_kernels.py, kernel _kernel):
//   out[n, :] = sum over edges e with ids[e] == n of data[e, :].
//
// K2 softmax_aggregate_sorted replaces pallas_fused_softmax_aggregate
// (pointvs_tpu/ops/pallas/segment_kernels.py, kernel _softmax_agg_kernel).
// Per destination row n:
//   softmax mode: m = max of the row's logits over edges with mask > 0
//                 (0 when there is none), w = exp(logit - m) * mask;
//   sigmoid mode: m = 0, w = sigmoid(logit) * mask.
//   out[n] = [sum w*feat (K) | sum mask*trans (3) | 0 | sum w | sum mask],
//   seg_max[n] = m. The caller divides (ops/aggregate.py).
//
// What bounds them on an H100: memory. Both do a few flops per byte read
// (K1 one add per 4-byte load), far below the ~20 flop/byte at which the
// f32 units would become the limit, so the least time is the bytes moved
// over 3.35 TB/s: the edge data read once and the rows written once,
// about 7 us at the bench shape. The TPU kernels built a [window, max_eb]
// one-hot per 128-node window and contracted it on the MXU in three bf16
// passes; none of that is needed here: the CUDA cores add in full f32,
// and the padding and per-window capacity that the one-hot needed
// disappear.
//
// At that size the first design (one warp per row) was bound by latency,
// not bytes: each row began with two dependent binary searches over all E
// ids (~36 dependent loads), K1's lanes walked one edge at a time with
// 4-byte loads, and K2 walked its row once per 32 output columns,
// recomputing the weights each time. Now a row is read by `group` column
// lanes (one per 16-byte column when K % 4 == 0, else per 4-byte column)
// times `slots` edge slots: slot s takes the row's edges s, s + slots, ...
// with several edges' loads in flight, and the slots' partial sums are
// added in slot order at the end. Long rows are split among the slots, and
// each lane keeps loads in flight instead of waiting on one edge at a
// time.
// - K1: 4 slots for K <= 4, else as many as fit in a warp (at most 8);
//   rows narrower than a warp share it (K = 1..4: 8 down to 2 rows per
//   warp). Above 32 4-byte columns each lane takes two, in one walk;
//   above 32 16-byte columns (K > 128, on no path) the lanes walk the
//   row once per 32 of them.
// - K2: a warp per row. Each lane reads one edge's logit and mask, so the
//   masked max and the weights are formed once per edge and shared by
//   shuffles. The trans, weight and mask sums ride the same walk as two
//   more 16-byte columns ([trans (3) | 0] and [w | mask | -]), so the row
//   [K+6] comes out of one slot reduction and is written once. The first
//   feature loads are issued before the max, which they do not need.
// Both take their edge sums with compensation (Sum below): an error of a
// few roundings whatever the row's length, where a plain f32 running sum
// over a hub row of hundreds of edges drifts past the 1e-5 gates.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;
constexpr int kSumUnroll = 8;   // K1: edges' loads in flight per lane
constexpr int kAggUnroll = 4;   // K2: edges' loads in flight per lane
constexpr unsigned kFullMask = 0xffffffffu;

// V consecutive floats of one row, held by one lane (V = 1 or 4; with 4,
// loads and K1's stores are 16-byte and need 16-byte aligned addresses).
template <int V>
struct Frag {
  float v[V];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = 0.f;
  }
  __device__ __forceinline__ void load(const float* __restrict__ p) {
    if constexpr (V == 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else {
      v[0] = __ldg(p);
    }
  }
  __device__ __forceinline__ void add(const Frag& o) {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] += o.v[i];
  }
  __device__ __forceinline__ Frag shfl(int src) const {
    Frag r;
#pragma unroll
    for (int i = 0; i < V; ++i) r.v[i] = __shfl_sync(kFullMask, v[i], src);
    return r;
  }
  __device__ __forceinline__ void store(float* p) const {
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      p[0] = v[0];
    }
  }
};

// Compensated (Kahan) running sums of V columns, in a fixed order: c keeps
// the low-order part each add lost. An infinite sum keeps no compensation,
// so infinities and NaNs come out as a plain sum gives them.
template <int V>
struct Sum {
  Frag<V> s, c;

  __device__ __forceinline__ void zero() {
    s.zero();
    c.zero();
  }
  __device__ __forceinline__ void add(int i, float x) {
    const float y = x - c.v[i];
    const float t = s.v[i] + y;
    c.v[i] = isfinite(t) ? (t - s.v[i]) - y : 0.f;
    s.v[i] = t;
  }
  __device__ __forceinline__ void add(const Frag<V>& x) {
#pragma unroll
    for (int i = 0; i < V; ++i) add(i, x.v[i]);
  }
  __device__ __forceinline__ Frag<V> value() const {
    Frag<V> r;
#pragma unroll
    for (int i = 0; i < V; ++i) r.v[i] = s.v[i] - c.v[i];
    return r;
  }
};

// The slots' partial sums, added in slot order: lane `first + col` (slot
// 0) gets the row's total. Every lane of the warp must call it.
template <int V>
__device__ __forceinline__ Frag<V> sum_slots(const Frag<V>& mine, int first,
                                             int col, int group, int slots) {
  Frag<V> total = mine;
  for (int s = 1; s < slots; ++s) {
    total.add(mine.shfl(first + s * group + col));
  }
  return total;
}

// K1. Lanes of a row: `group` column lanes x `slots` edge slots; lane col
// holds vector columns col, col + group, ... (NC of them) of each block of
// group * NC columns. kWarp / (group * slots) rows per warp.
template <int V, int NC>
__global__ void __launch_bounds__(kThreads) segment_sum_sorted_kernel(
    const float* __restrict__ data, const int32_t* __restrict__ offsets,
    float* __restrict__ out, int k, int num_segments, int group, int slots) {
  const int lane = threadIdx.x % kWarp;
  const int per_row = group * slots;
  const int rows_per_warp = kWarp / per_row;
  const int g = lane / per_row;
  const int rem = lane - g * per_row;
  const int slot = rem / group;
  const int col = rem - slot * group;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  const int64_t row = warp * rows_per_warp + g;
  const bool active = g < rows_per_warp && row < num_segments;
  int lo = 0, hi = 0;  // idle lanes walk no edge but join the shuffles
  if (active) {
    lo = __ldg(offsets + row);
    hi = __ldg(offsets + row + 1);
  }
  const int cols = k / V;
  for (int c0 = 0; c0 < cols; c0 += group * NC) {
    Sum<V> acc[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[j].zero();
    for (int e = lo + slot; e < hi; e += kSumUnroll * slots) {
      Frag<V> x[kSumUnroll][NC];
#pragma unroll
      for (int u = 0; u < kSumUnroll; ++u) {
        const int eu = e + u * slots;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int c = c0 + col + j * group;
          if (eu < hi && c < cols) {
            x[u][j].load(data + static_cast<int64_t>(eu) * k + c * V);
          } else {
            x[u][j].zero();
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kSumUnroll; ++u) {
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[j].add(x[u][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = c0 + col + j * group;
      const Frag<V> total =
          sum_slots(acc[j].value(), g * per_row, col, group, slots);
      if (active && slot == 0 && c < cols) total.store(out + row * k + c * V);
    }
  }
}

// K2. One warp per row. The row's output in vector columns: `cols` of
// features, then `tails` of [trans (3) | 0 | w | mask]; `group` of them
// per block of columns (at most 32), read by kWarp / group edge slots. In
// each 32-edge chunk lane l forms edge base + l's weight.
template <int V>
__global__ void __launch_bounds__(kThreads) softmax_aggregate_sorted_kernel(
    const float* __restrict__ feat, const float* __restrict__ logits,
    const float* __restrict__ trans, const float* __restrict__ mask,
    const int32_t* __restrict__ offsets, float* __restrict__ out,
    float* __restrict__ seg_max, int k, int num_segments, int softmax) {
  constexpr int kTails = (6 + V - 1) / V;
  const int lane = threadIdx.x % kWarp;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= num_segments) return;  // whole warp: row is warp-uniform
  const int lo = __ldg(offsets + row);
  const int hi = __ldg(offsets + row + 1);
  const int cols = k / V;
  const int width = cols + kTails;
  const int group = width < kWarp ? width : kWarp;
  const int slots = kWarp / group;
  const int slot = lane / group;
  const int col = lane - slot * group;
  float* out_row = out + row * (k + 6);

  // Lane's raw values of edge `base + j` for vector column c: features,
  // or for a tail column trans / 0 and the edge's mask in `msk`.
  auto load = [&](int c, int base, int j, int count, Frag<V>& x,
                  float& msk) {
    x.zero();
    msk = 0.f;
    if (slot >= slots || j >= count || c >= width) return;
    const int64_t e = base + j;
    if (c < cols) {
      x.load(feat + e * k + c * V);
      return;
    }
    msk = __ldg(mask + e);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int q = (c - cols) * V + i;  // column k + q of the row
      if (q < 3) x.v[i] = __ldg(trans + e * 3 + q);
    }
  };

  // The first feature loads need no weight: issue them before the max.
  const int count0 = hi - lo < kWarp ? hi - lo : kWarp;
  Frag<V> x[kAggUnroll];
  float xm[kAggUnroll];
#pragma unroll
  for (int u = 0; u < kAggUnroll; ++u) {
    load(col, lo, u * slots + slot, count0, x[u], xm[u]);
  }

  // Lane l's edge of the first chunk; the masked max of the row's logits.
  float l0 = 0.f, msk0 = 0.f;
  if (lo + lane < hi) {
    msk0 = __ldg(mask + lo + lane);
    l0 = __ldg(logits + lo + lane);
  }
  float m = 0.f;
  if (softmax) {
    float cand = (lo + lane < hi && msk0 > 0.f) ? l0 : -1e30f;
    for (int e = lo + lane + kWarp; e < hi; e += kWarp) {
      if (__ldg(mask + e) > 0.f) cand = fmaxf(cand, __ldg(logits + e));
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) {
      cand = fmaxf(cand, __shfl_xor_sync(kFullMask, cand, off));
    }
    m = cand > -1e29f ? cand : 0.f;
  }

  bool prefetched = true;
  for (int c0 = 0; c0 < width; c0 += group) {
    const int c = c0 + col;
    Sum<V> acc;
    acc.zero();
    for (int base = lo; base < hi; base += kWarp) {  // warp-uniform
      const int e = base + lane;
      float l = l0, msk = msk0;
      if (base != lo) {
        l = 0.f;
        msk = 0.f;
        if (e < hi) {
          msk = __ldg(mask + e);
          l = __ldg(logits + e);
        }
      }
      float w = 0.f;
      if (e < hi) {
        w = (softmax ? expf(l - m) : 1.f / (1.f + expf(-l))) * msk;
      }
      const int count = hi - base < kWarp ? hi - base : kWarp;
      for (int j0 = 0; j0 < count; j0 += kAggUnroll * slots) {  // uniform
        if (!prefetched) {
#pragma unroll
          for (int u = 0; u < kAggUnroll; ++u) {
            load(c, base, j0 + u * slots + slot, count, x[u], xm[u]);
          }
        }
        prefetched = false;
#pragma unroll
        for (int u = 0; u < kAggUnroll; ++u) {
          const int j = j0 + u * slots + slot;
          const float wj = __shfl_sync(kFullMask, w, j % kWarp);
          if (slot >= slots || j >= count || c >= width) continue;
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const int q = (c - cols) * V + i;
            float v;
            if (c < cols) {
              v = wj * x[u].v[i];
            } else if (q < 3) {
              v = xm[u] * x[u].v[i];
            } else {
              v = q == 4 ? wj : (q == 5 ? xm[u] : 0.f);
            }
            acc.add(i, v);
          }
        }
      }
    }
    const Frag<V> total = sum_slots(acc.value(), 0, col, group, slots);
    if (slot == 0 && c < width) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (c * V + i < k + 6) out_row[c * V + i] = total.v[i];
      }
    }
    prefetched = false;
  }
  if (lane == 0) seg_max[row] = m;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int V, int NC>
int launch_sum(const float* data, const int32_t* offsets, float* out, int k,
               int num_segments, int group, int slots, cudaStream_t stream) {
  const int rows_per_block = kWarpsPerBlock * (kWarp / (group * slots));
  const int blocks = (num_segments + rows_per_block - 1) / rows_per_block;
  segment_sum_sorted_kernel<V, NC><<<blocks, kThreads, 0, stream>>>(
      data, offsets, out, k, num_segments, group, slots);
  return static_cast<int>(cudaGetLastError());
}

// Every kernel variant, in the order of pvs_segment_kernel_info's index.
const void* const kVariants[] = {
    reinterpret_cast<const void*>(segment_sum_sorted_kernel<1, 1>),
    reinterpret_cast<const void*>(segment_sum_sorted_kernel<4, 1>),
    reinterpret_cast<const void*>(segment_sum_sorted_kernel<1, 2>),
    reinterpret_cast<const void*>(softmax_aggregate_sorted_kernel<1>),
    reinterpret_cast<const void*>(softmax_aggregate_sorted_kernel<4>),
};

}  // namespace

// Plain C interface for ctypes. Each launches on the given stream, does not
// synchronise, and returns cudaGetLastError() so a refused launch surfaces.
// `offsets` is int32 [num_segments + 1] (see the note at the top).
extern "C" int pvs_segment_sum_sorted(const float* data,
                                      const int32_t* offsets, float* out,
                                      int k, int num_segments, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int v = (k % 4 == 0 && aligned16(data)) ? 4 : 1;
  const int cols = k / v;
  if (cols > kWarp) {  // a warp per row; 4-byte columns two a lane
    return v == 4 ? launch_sum<4, 1>(data, offsets, out, k, num_segments,
                                     kWarp, 1, s)
                  : launch_sum<1, 2>(data, offsets, out, k, num_segments,
                                     kWarp, 1, s);
  }
  const int fit = kWarp / cols;
  const int slots = k <= 4 ? 4 : (fit < 8 ? fit : 8);
  return v == 4 ? launch_sum<4, 1>(data, offsets, out, k, num_segments, cols,
                                   slots, s)
                : launch_sum<1, 1>(data, offsets, out, k, num_segments, cols,
                                   slots, s);
}

extern "C" int pvs_softmax_aggregate_sorted(
    const float* feat, const float* logits, const float* trans,
    const float* mask, const int32_t* offsets, float* out, float* seg_max,
    int k, int num_segments, int softmax, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid((num_segments + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (k % 4 == 0 && aligned16(feat)) {
    softmax_aggregate_sorted_kernel<4><<<grid, kThreads, 0, s>>>(
        feat, logits, trans, mask, offsets, out, seg_max, k, num_segments,
        softmax);
  } else {
    softmax_aggregate_sorted_kernel<1><<<grid, kThreads, 0, s>>>(
        feat, logits, trans, mask, offsets, out, seg_max, k, num_segments,
        softmax);
  }
  return static_cast<int>(cudaGetLastError());
}

// int[5] of variant `which` (kVariants): registers, spill bytes, static and
// dynamic shared bytes, blocks resident per SM at kThreads threads.
extern "C" int pvs_segment_kernel_info(int which, int* info) {
  constexpr int n = sizeof(kVariants) / sizeof(kVariants[0]);
  if (which < 0 || which >= n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kVariants[which]);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kVariants[which], kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(attr.sharedSizeBytes);
  info[3] = 0;
  info[4] = blocks;
  return 0;
}
