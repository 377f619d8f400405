// Shared tile machinery of the decode kernels: the LeakyReLU / squash
// epilogues, the tail weights, and the CUDA-core FMA path of the f32
// instances (ray_decode.cu = K1/K2, ief_decode.cu = K4, pair_decode.cu = K6):
// small matrix products of a block's activation tile (rows in shared memory)
// with a weight matrix read through L2, and the 256 -> 128 -> 64 -> 1 MLP
// tail and IEF loop on them. The bf16 instances run on decode_tile.cuh's
// staged tensor-core products instead; ray_decode_bwd.cu (K3) runs its own
// wmma products (hence <mma.h> here).
//
// Numerics follow implicit_depth_tpu/ops/pallas_ray_decode.py::_decode_rows:
// every product takes operands in the compute type T (float or bf16) and
// accumulates in f32; each hidden activation is rounded to T before its
// product. A bf16 x bf16 product is exact in f32, so the f32 FMA path and the
// bf16 tensor-core path compute the same sums up to their order.
//
// fma_tile (any T): CUDA-core FMA, each thread a 4x4 output micro-tile. Used
// for every f32 product (exact f32, as the plain version computes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace idt {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kLeaky = 0.02f;
// f32(pi / 2): cos x = sin(x + pi/2), with the phase rounded to f32 exactly
// as the JAX package's _posenc_consts does.
constexpr float kHalfPi = 1.57079637050628662109375f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Read-only global load (through the non-coherent cache) of one element.
__device__ __forceinline__ float ldg_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f32(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}
// One element of T copied from global memory without conversion.
__device__ __forceinline__ float ldg_raw(const float* p) { return __ldg(p); }
__device__ __forceinline__ __nv_bfloat16 ldg_raw(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p)));
}

// Column t of a pair's trig block (the sin/cos columns of K1's split layer
// 1) from its f32 positions pos6 = [enter xyz | leave xyz]: position
// t / (6m), frequency j, sin | cos, axis d, in embedder order (per
// position, per frequency [sin xyz | cos xyz]); cos x = sin(x + pi/2).
__device__ __forceinline__ float trig_column(const float* pos6, int t,
                                             int multires) {
  const int per_pos = 6 * multires;
  const int which = t / per_pos, u = t % per_pos;
  const int j = u / 6, ph = (u % 6) / 3, d = u % 3;
  const float x = __ldg(pos6 + which * 3 + d);
  return sinf(x * (float)(1 << j) + (ph ? kHalfPi : 0.f));
}

__device__ __forceinline__ float leaky(float v) {
  return v > 0.f ? v : kLeaky * v;
}

__device__ __forceinline__ float squash(float x, bool use_sigmoid) {
  if (use_sigmoid) return 1.f / (1.f + expf(-x));
  // max(min(x, 0.01x + 0.99), 0.01x)
  return fmaxf(fminf(x, 0.01f * x + 0.99f), 0.01f * x);
}

// C[M x N] (f32, shared, ldc) = A[M x K] (T, shared, lda) @ B[K x N] (T,
// global row-major, ldb). K, N multiples of 4; M multiple of 4.
template <typename T, int M>
__device__ void fma_tile(const T* A, int lda, const T* __restrict__ B, int ldb,
                         int K, int N, float* C, int ldc) {
  const int col_groups = N / 4;
  const int items = (M / 4) * col_groups;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int cg = it % col_groups, rg = it / col_groups;
    const T* a0 = A + rg * 4 * lda;
    const T* b0 = B + cg * 4;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = to_f32(a0[i * lda + k]);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ldg_f32(b0 + (size_t)k * ldb + j);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        C[(rg * 4 + i) * ldc + cg * 4 + j] = acc[i][j];
  }
}

// The block's M x N product of the f32 instances, on the CUDA cores.
template <typename T, int M, int N>
__device__ __forceinline__ void tile_product(const T* A, int lda,
                                             const T* __restrict__ B, int ldb,
                                             int K, float* C, int ldc) {
  static_assert(sizeof(T) == 4, "bf16 products run on decode_tile.cuh");
  fma_tile<T, M>(A, lda, B, ldb, K, N, C, ldc);
}

// Weights of layers 2-4 of one decoder (widths 256 -> 128 -> 64 -> 1).
template <typename T>
struct TailWeights {
  const T* w2;      // (256, 128)
  const float* b2;  // (128,) f32 holding T-rounded values
  const T* w3;      // (128, 64)
  const float* b3;  // (64,)
  const T* w4;      // (64,)
  const float* b4;  // (1,)
};

constexpr int kG1 = 256, kG2 = 128, kG3 = 64;

// Layers 2-4 from the T-rounded layer-1 activation H (M x 256, shared).
// Uses C (f32, M x 128) as product scratch and H2 (M x 128), H3 (M x 64) of
// type T. Returns the pre-squash output of layer 4 (without b4) of each row
// into out[row] (f32, shared), added to what out holds when accumulate.
template <typename T, int M>
__device__ void mlp_tail(const T* H, float* C, T* H2, T* H3,
                         const TailWeights<T>& w, float* out,
                         bool accumulate) {
  tile_product<T, M, kG2>(H, kG1, w.w2, kG2, kG1, C, kG2);
  __syncthreads();
  for (int i = threadIdx.x; i < M * kG2; i += blockDim.x)
    H2[i] = from_f32<T>(leaky(C[i] + __ldg(w.b2 + i % kG2)));
  __syncthreads();
  tile_product<T, M, kG3>(H2, kG2, w.w3, kG3, kG2, C, kG3);
  __syncthreads();
  for (int i = threadIdx.x; i < M * kG3; i += blockDim.x)
    H3[i] = from_f32<T>(leaky(C[i] + __ldg(w.b3 + i % kG3)));
  __syncthreads();
  // layer 4: each row's 64-term dot, split over kThreads / M lanes
  constexpr int kLanes = kThreads / M;
  static_assert(kLanes >= 1 && 32 % kLanes == 0, "lanes per row");
  const int row = threadIdx.x / kLanes, part = threadIdx.x % kLanes;
  float s = 0.f;
  if (row < M) {
    for (int k = part; k < kG3; k += kLanes)
      s = fmaf(to_f32(H3[row * kG3 + k]), ldg_f32(w.w4 + k), s);
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (row < M && part == 0) out[row] = accumulate ? out[row] + s : s;
  __syncthreads();
}

// The IEF offset loop from the layer-1 pre-activation E1 (M x 256 f32, the
// per-row part, iteration-invariant): per iteration
//   h1 = act(e1 + offset * a_vec + c_vec)  (rounded to T)
//   offset = offset + tail(h1) + b4
// offset (M,) f32 in shared memory, initialised by the caller.
template <typename T, int M>
__device__ void ief_loop(const float* E1, T* H, float* C, T* H2, T* H3,
                         const float* __restrict__ a_vec,
                         const float* __restrict__ c_vec,
                         const TailWeights<T>& w, float* offset, int n_iter) {
  const float b4 = __ldg(w.b4);
  for (int it = 0; it < n_iter; ++it) {
    for (int i = threadIdx.x; i < M * kG1; i += blockDim.x) {
      const int c = i % kG1;
      H[i] = from_f32<T>(
          leaky(E1[i] + offset[i / kG1] * __ldg(a_vec + c) + __ldg(c_vec + c)));
    }
    __syncthreads();
    mlp_tail<T, M>(H, C, H2, H3, w, offset, /*accumulate=*/true);
    if (threadIdx.x < M) offset[threadIdx.x] += b4;
    __syncthreads();
  }
}

inline size_t align_up(size_t x, size_t a) { return (x + a - 1) / a * a; }

}  // namespace idt
