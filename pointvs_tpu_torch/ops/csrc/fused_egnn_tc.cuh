// Tensor-core tile helpers for the fused edge pass kernels K3 and K4:
// f32-accurate warp products on mma.sync m16n8k8 TF32 by a 3xTF32 split,
// C-fragment bookkeeping, and the layer's weights in shared memory at the
// pitches the fragment loads want.
//
// 3xTF32. Each f32 operand x is split into hi = tf32(x) and
// lo = tf32(x - hi) (cvt.rna, round to nearest, ties away; the low 13 bits
// are cleared so the f32 view of hi is exactly the TF32 value). A product
// a*b is then lo_a*hi_b + hi_a*lo_b + hi_a*hi_b with f32 accumulation,
// small terms first; the dropped lo_a*lo_b is ~2^-22 relative. This is the
// Hopper analogue of the reference's three-pass bf16 split (_split3 in
// pointvs_tpu/ops/pallas/segment_kernels.py): plain TF32 keeps ~3 digits
// and misses the 1e-5 gates, the split meets them.
//
// Fragments (PTX ISA, mma.m16n8k8 .tf32, g = lane / 4, t = lane % 4):
//   A 16x8: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4);
//   B 8x8:  b0 (k=t, n=g), b1 (k=t+4, n=g);
//   C 16x8: c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1).
// Operands are read from shared memory through a View (base, row stride,
// column stride), so one routine serves W, W^T, G and G^T alike.
//
// Pitches. A row-major tile read as A (rows g, columns t) is free of bank
// conflicts when pitch / 4 is odd: 36 for 32 features, 76 for the 72 edge
// MLP input columns. Read transposed (B of a parameter gradient, or W as
// the B of a backward product) the same pitch costs a 2-way conflict.
#pragma once

#include "fused_egnn_common.cuh"

namespace pvs_fused {

constexpr int kXCols = kIn + 4;      // edge MLP input padded to 9 k-steps (72)
constexpr int kXPitch = kXCols + 4;  // 76
constexpr int kFPitch = kMaxK + 4;   // 36
constexpr int kFT = kMaxK / 8;       // n-tiles (or k-steps) over 32 features
constexpr int kXT = kXCols / 8;      // n-tiles (or k-steps) over 72 columns

struct TcWeights {
  float w1[kMaxK * kXPitch];   // [32 rows][76]: h_src 0..31 | h_dst 32..63
                               // | radial, attr0..2 64..67 | 0 68..75
  float w2[kMaxK * kFPitch];
  float cw1[kMaxK * kFPitch];
  float b1[kMaxK], b2[kMaxK], cb1[kMaxK], cw2[kMaxK], attw[kMaxK];
  float attb;
};

// Element idx of the padded w1 ([32 rows][76]) and of a padded square
// matrix ([32 rows][36]) in the torch layouts of ops/fused_egnn.py.
__device__ __forceinline__ float padded_w1(const float* __restrict__ w1,
                                           int idx, int k) {
  const int j = idx / kXPitch, c = idx % kXPitch;
  int col = -1;
  if (c < kMaxK) {
    if (c < k) col = c;
  } else if (c < 2 * kMaxK) {
    if (c - kMaxK < k) col = k + (c - kMaxK);
  } else if (c < kIn) {
    col = 2 * k + (c - 2 * kMaxK);
  }
  return (j < k && col >= 0) ? w1[j * (2 * k + 4) + col] : 0.f;
}
__device__ __forceinline__ float padded_square(const float* __restrict__ w,
                                               int idx, int k) {
  const int j = idx / kFPitch, c = idx % kFPitch;
  return (j < k && c < k) ? w[j * k + c] : 0.f;
}

// Copy the layer's weights into shared memory, zero-padded to 32 features
// and 72 input columns, by kThreads threads (the block); ends with a
// barrier. Each thread issues all of its loads before its first store, so
// the copy takes about one memory latency rather than one per element.
template <int kThreads>
__device__ void load_weights_tc(TcWeights& s, const Params& p, int k) {
  constexpr int kW1 = kMaxK * kXPitch, kW = kMaxK * kFPitch;
  constexpr int kPer1 = (kW1 + kThreads - 1) / kThreads;
  constexpr int kPer = (kW + kThreads - 1) / kThreads;
  float w1[kPer1], w2[kPer], cw1[kPer], vec[5];
#pragma unroll
  for (int i = 0; i < kPer1; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    w1[i] = idx < kW1 ? padded_w1(p.w1, idx, k) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    w2[i] = idx < kW ? padded_square(p.w2, idx, k) : 0.f;
    cw1[i] = idx < kW ? padded_square(p.cw1, idx, k) : 0.f;
  }
  const int j = threadIdx.x;   // kThreads >= kMaxK: one row of the vectors
  if (j < kMaxK) {
    const bool inside = j < k;
    vec[0] = inside ? p.b1[j] : 0.f;
    vec[1] = inside ? p.b2[j] : 0.f;
    vec[2] = inside ? p.cb1[j] : 0.f;
    vec[3] = inside ? p.cw2[j] : 0.f;
    vec[4] = inside ? p.attw[j] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kPer1; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (idx < kW1) s.w1[idx] = w1[i];
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (idx < kW) {
      s.w2[idx] = w2[i];
      s.cw1[idx] = cw1[i];
    }
  }
  if (j < kMaxK) {
    s.b1[j] = vec[0];
    s.b2[j] = vec[1];
    s.cb1[j] = vec[2];
    s.cw2[j] = vec[3];
    s.attw[j] = vec[4];
  }
  if (threadIdx.x == 0) s.attb = p.attb[0];
  __syncthreads();
}

// Element (r, c) of a matrix held in shared memory at p[r * rs + c * cs].
struct View {
  const float* p;
  int rs, cs;
  __device__ __forceinline__ float at(int r, int c) const {
    return p[r * rs + c * cs];
  }
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b in 3xTF32, small terms first.
__device__ __forceinline__ void mma_3xtf32(
    float (&d)[4], const uint32_t (&a_hi)[4], const uint32_t (&a_lo)[4],
    const uint32_t (&b_hi)[2], const uint32_t (&b_lo)[2]) {
  mma_tf32(d, a_lo, b_hi);
  mma_tf32(d, a_hi, b_lo);
  mma_tf32(d, a_hi, b_hi);
}

// One warp: C[16 x 8NT] += A[16 x 8KT] . B[8KT x 8NT], every operand read
// from shared memory and split as it is loaded. c points at NT C fragments
// (register arrays once inlined).
template <int KT, int NT>
__device__ __forceinline__ void warp_mma(float (*c)[4], View a, View b,
                                         int g, int t) {
#pragma unroll 2   // full unrolling spills and runs slower
  for (int kt = 0; kt < KT; ++kt) {
    const int k0 = kt * 8;
    uint32_t ah[4], al[4];
    split_tf32(a.at(g, k0 + t), ah[0], al[0]);
    split_tf32(a.at(g + 8, k0 + t), ah[1], al[1]);
    split_tf32(a.at(g, k0 + t + 4), ah[2], al[2]);
    split_tf32(a.at(g + 8, k0 + t + 4), ah[3], al[3]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t bh[2], bl[2];
      split_tf32(b.at(k0 + t, nt * 8 + g), bh[0], bl[0]);
      split_tf32(b.at(k0 + t + 4, nt * 8 + g), bh[1], bl[1]);
      mma_3xtf32(c[nt], ah, al, bh, bl);
    }
  }
}

// Asynchronous 4-byte copy into shared memory; with fill false nothing is
// read (src must still be a valid address) and the word is zero-filled.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool fill) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(fill ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool fill) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(fill ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Row (0..15) and column of element i (0..3) of n-tile nt of a C fragment.
__device__ __forceinline__ int frag_row(int i, int g) {
  return g + 8 * (i >> 1);
}
__device__ __forceinline__ int frag_col(int nt, int i, int t) {
  return nt * 8 + 2 * t + (i & 1);
}

// Elements c and c + 1 (a C-fragment pair) of a row of k floats, those
// below k; one 8-byte store when `pair` (k even, rows 8-byte aligned).
__device__ __forceinline__ void store_pair(float* row, int c, int k, float v0,
                                           float v1, bool pair) {
  if (pair) {
    if (c < k) *reinterpret_cast<float2*>(row + c) = make_float2(v0, v1);
    return;
  }
  if (c < k) row[c] = v0;
  if (c + 1 < k) row[c + 1] = v1;
}

// Sum over the 4 lanes of a quad (the lanes holding one C-fragment row);
// every lane ends with the same bits.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  v += __shfl_xor_sync(kFull, v, 2);
  return v;
}

}  // namespace pvs_fused
