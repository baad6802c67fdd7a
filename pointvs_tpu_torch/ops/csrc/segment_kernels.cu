// Segment reductions over destination-sorted edge lists, for Hopper (sm_90a).
//
// Both kernels read edges whose ids are sorted ascending; an id equal to
// num_segments marks a padding edge, which falls in no row and is dropped.
// Each output row is owned by one warp, which finds the row's edge range
// [lo, hi) by binary search on the sorted ids and reduces it in edge order.
// No atomics: every sum is taken in a fixed order, so results are
// deterministic from run to run.
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
// over 3.35 TB/s. The design moves each input byte from device memory
// once: a row's edges are contiguous, so the warp's lanes read one edge's
// K features as neighbouring addresses (coalesced) and walk the row's
// edges in order, keeping the sums in registers. The TPU kernels built a
// [window, max_eb] one-hot per 128-node window and contracted it on the
// MXU in three bf16 passes; none of that is needed here: the CUDA cores
// add in full f32, and the padding and per-window capacity that the
// one-hot needed disappear. K2 computes the edge weights once per group
// of 32 edges (one per lane) and broadcasts them with warp shuffles, so
// the exp is not repeated for every feature column. The binary searches
// cost ~2 log2(E) cached loads per row, small beside the row's data.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

// First index in ids[0, n) whose value is >= key (ids ascending).
__device__ __forceinline__ int64_t lower_bound(
    const int32_t* __restrict__ ids, int64_t n, int32_t key) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(ids + mid) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void segment_sum_sorted_kernel(
    const float* __restrict__ data, const int32_t* __restrict__ ids,
    float* __restrict__ out, int64_t num_edges, int k, int num_segments) {
  const int lane = threadIdx.x % kWarp;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= num_segments) return;  // whole warp: row is warp-uniform
  const int64_t lo = lower_bound(ids, num_edges, static_cast<int32_t>(row));
  const int64_t hi =
      lower_bound(ids, num_edges, static_cast<int32_t>(row + 1));
  for (int c = lane; c < k; c += kWarp) {
    float acc = 0.f;
    const float* p = data + lo * k + c;
    for (int64_t e = lo; e < hi; ++e, p += k) acc += __ldg(p);
    out[row * k + c] = acc;
  }
}

__global__ void softmax_aggregate_sorted_kernel(
    const float* __restrict__ feat, const float* __restrict__ logits,
    const float* __restrict__ trans, const float* __restrict__ mask,
    const int32_t* __restrict__ ids, float* __restrict__ out,
    float* __restrict__ seg_max, int64_t num_edges, int k, int num_segments,
    int softmax) {
  const int lane = threadIdx.x % kWarp;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= num_segments) return;  // whole warp: row is warp-uniform
  const int64_t lo = lower_bound(ids, num_edges, static_cast<int32_t>(row));
  const int64_t hi =
      lower_bound(ids, num_edges, static_cast<int32_t>(row + 1));

  // Pass 1 (softmax): masked max of the row's logits.
  float m = 0.f;
  if (softmax) {
    float cand = -1e30f;
    for (int64_t e = lo + lane; e < hi; e += kWarp) {
      if (__ldg(mask + e) > 0.f) cand = fmaxf(cand, __ldg(logits + e));
    }
    for (int off = kWarp / 2; off > 0; off /= 2) {
      cand = fmaxf(cand, __shfl_xor_sync(kFullMask, cand, off));
    }
    m = cand > -1e29f ? cand : 0.f;
  }
  if (lane == 0) seg_max[row] = m;

  // Pass 2: lane l owns output column c0 + l of [feat | trans | 0 | w | mask].
  const int width = k + 6;
  for (int c0 = 0; c0 < width; c0 += kWarp) {
    const int c = c0 + lane;
    float acc = 0.f;
    for (int64_t base = lo; base < hi; base += kWarp) {
      const int64_t e = base + lane;
      float w = 0.f, msk = 0.f;
      if (e < hi) {
        msk = __ldg(mask + e);
        const float l = __ldg(logits + e);
        w = (softmax ? expf(l - m) : 1.f / (1.f + expf(-l))) * msk;
      }
      const int64_t left = hi - base;
      const int count = left < kWarp ? static_cast<int>(left) : kWarp;
      for (int j = 0; j < count; ++j) {  // count is warp-uniform
        const float wj = __shfl_sync(kFullMask, w, j);
        const float mj = __shfl_sync(kFullMask, msk, j);
        const int64_t ej = base + j;
        if (c < k) {
          acc += wj * __ldg(feat + ej * k + c);
        } else if (c < k + 3) {
          acc += mj * __ldg(trans + ej * 3 + (c - k));
        } else if (c == k + 4) {
          acc += wj;
        } else if (c == k + 5) {
          acc += mj;
        }
      }
    }
    if (c < width) out[row * width + c] = acc;  // column k + 3 stays 0
  }
}

}  // namespace

// Plain C interface for ctypes. Each launches on the given stream, does not
// synchronise, and returns cudaGetLastError() so a refused launch surfaces.
extern "C" int pvs_segment_sum_sorted(const float* data, const int32_t* ids,
                                      float* out, int64_t num_edges, int k,
                                      int num_segments, void* stream) {
  const dim3 block(kWarp * kWarpsPerBlock);
  const dim3 grid((num_segments + kWarpsPerBlock - 1) / kWarpsPerBlock);
  segment_sum_sorted_kernel<<<grid, block, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      data, ids, out, num_edges, k, num_segments);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pvs_softmax_aggregate_sorted(
    const float* feat, const float* logits, const float* trans,
    const float* mask, const int32_t* ids, float* out, float* seg_max,
    int64_t num_edges, int k, int num_segments, int softmax,
    void* stream) {
  const dim3 block(kWarp * kWarpsPerBlock);
  const dim3 grid((num_segments + kWarpsPerBlock - 1) / kWarpsPerBlock);
  softmax_aggregate_sorted_kernel<<<grid, block, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      feat, logits, trans, mask, ids, out, seg_max, num_edges, k,
      num_segments, softmax);
  return static_cast<int>(cudaGetLastError());
}
