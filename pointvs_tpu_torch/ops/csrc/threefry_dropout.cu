// flax's nn.Dropout mask drawn from a JAX threefry key, in one pass.
//
// Not a port of a TPU kernel: the reference draws lucid's dropout masks
// with jax.random.bernoulli inside its XLA program. This kernel gives the
// same bits on the card, so the port's lucid drops the entries the
// reference drops (pointvs_tpu_torch/ops/dropout.py holds the wrapper and
// the plain PyTorch version).
//
// Entry i of the flattened input, under the raw key (k0, k1):
//   (b0, b1) = threefry2x32((k0, k1), (i >> 32, i & 0xffffffff))
//   u        = float(((b0 ^ b1) >> 9) | 0x3f800000) - 1     (uniform [0,1))
//   out[i]   = u < keep ? x[i] / keep : 0
// which is jax.random.bernoulli(key, keep, x.shape) under partitionable
// threefry (jax 0.9.0's default) and flax's select(mask, x / keep, 0).
// The backward of the op is the same op on the gradient.
//
// Bound on this card: 8 bytes an entry (one f32 read, one written)
// against ~83 integer operations an entry for the hash. A thread takes
// consecutive entries, four at a time where the row is 16-byte aligned,
// so loads and stores stay coalesced; the hash runs on the integer pipe
// with funnel-shift rotations.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int block = 0; block < 5; ++block) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[block % 2][j]);
      x1 ^= x0;
    }
    x0 += ks[(block + 1) % 3];
    x1 += ks[(block + 2) % 3] + static_cast<uint32_t>(block + 1);
  }
}

__device__ __forceinline__ float drop_one(float x, uint64_t i, uint32_t k0,
                                          uint32_t k1, float keep) {
  uint32_t b0 = static_cast<uint32_t>(i >> 32);
  uint32_t b1 = static_cast<uint32_t>(i);
  threefry2x32(k0, k1, b0, b1);
  const float u =
      __uint_as_float(((b0 ^ b1) >> 9) | 0x3F800000u) - 1.0f;
  return u < keep ? __fdiv_rn(x, keep) : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
    threefry_dropout_kernel(const float* __restrict__ x,
                            float* __restrict__ out, int64_t n,
                            uint32_t k0, uint32_t k1, float keep) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads +
                   threadIdx.x;
       i < n; i += stride) {
    out[i] = drop_one(x[i], static_cast<uint64_t>(i), k0, k1, keep);
  }
}

// Four consecutive entries a thread: n4 = n / 4 float4s, the tail by the
// scalar path.
__global__ void __launch_bounds__(kThreads)
    threefry_dropout_vec4_kernel(const float4* __restrict__ x,
                                 float4* __restrict__ out, int64_t n4,
                                 uint32_t k0, uint32_t k1, float keep) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads +
                   threadIdx.x;
       q < n4; q += stride) {
    const float4 v = x[q];
    const uint64_t i = static_cast<uint64_t>(q) * 4;
    float4 r;
    r.x = drop_one(v.x, i, k0, k1, keep);
    r.y = drop_one(v.y, i + 1, k0, k1, keep);
    r.z = drop_one(v.z, i + 2, k0, k1, keep);
    r.w = drop_one(v.w, i + 3, k0, k1, keep);
    out[q] = r;
  }
}

int grid_for(int64_t items) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t want = (items + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms > 0 ? sms : 132) * 16;
  return static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
}

}  // namespace

extern "C" int pvs_threefry_dropout(const float* x, float* out, int64_t n,
                                    uint32_t k0, uint32_t k1, float keep,
                                    void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  const bool aligned =
      (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
      (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (aligned && n % 4 == 0) {
    const int64_t n4 = n / 4;
    threefry_dropout_vec4_kernel<<<grid_for(n4), kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out),
        n4, k0, k1, keep);
  } else {
    threefry_dropout_kernel<<<grid_for(n), kThreads, 0, s>>>(x, out, n, k0,
                                                             k1, keep);
  }
  return static_cast<int>(cudaGetLastError());
}

// int[5] of the scalar (which 0) or float4 (which 1) kernel: registers,
// spill bytes, static and dynamic shared bytes, blocks resident per SM.
extern "C" int pvs_threefry_dropout_info(int which, int* info) {
  const void* fn =
      which == 0 ? reinterpret_cast<const void*>(threefry_dropout_kernel)
                 : reinterpret_cast<const void*>(threefry_dropout_vec4_kernel);
  if (which < 0 || which > 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                      0);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(attr.sharedSizeBytes);
  info[3] = 0;
  info[4] = blocks;
  return 0;
}
