// K5: segmented max of non-negative rows into a zero-initialised table.
//
// Replaces implicit_depth_tpu/ops/pallas_segment.py::pallas_segment_max0
// (the TPU kernel keeps the whole (segments, C) table in VMEM and merges the
// point rows into it one by one across a sequential grid).
//
// What bounds it on the H100: at the main path's shapes (40,000-76,800 rows
// of 64-128 channels, a few MB) neither bytes (2-12 us at 3.35 TB/s) nor
// operations. The kernel takes ~10 us at the training shapes and ~50 us at
// the serving one, bound by the atomics on the few cells the rows of one
// image fall into; the first version's wrapper added three PyTorch launches
// and its host work, ~60 us a call at the training shapes
// (scripts/attribute_k3_k5.py), more than the kernel itself. What is left
// of that is the host work of one ctypes call.
//
// Design:
//   * One C call does the whole job on the stream: it zeroes an f32 table
//     (cudaMemsetAsync), launches the kernel that merges into it and, for
//     bf16 data, a second small kernel that writes the table in bf16 (exact:
//     every value in it is a bf16 value); f32 data merges straight into the
//     output. `valid` is read as the bool tensor's bytes. The wrapper only
//     allocates the output (and, for bf16, the f32 table).
//   * A group of lanes owns a run of kRun consecutive rows, which it walks
//     kBatch rows at a time with every load of a batch in flight together;
//     each lane holds 4 channels and loads them with one vector load per
//     row (16 bytes of f32, 8 of bf16: as many lanes for either type). Consecutive rows that share a segment
//     (the PointNet's points come in pixel order, so neighbours fall into
//     the same voxel) are max-reduced in registers, and the lane merges into
//     the table only when the segment changes and only the channels that are
//     above 0: an empty segment stays exactly 0 (torch_scatter's zero init),
//     invalid rows and out-of-range ids are skipped, and zeros, which
//     post-ReLU data is full of, never reach memory.
//   * The merge is atomicMax on the f32 table's int32 bit patterns, exact in
//     any order: non-negative IEEE floats order like their bit patterns.
//   * A row whose channels are not a multiple of 4, or a misaligned
//     pointer, takes the scalar instance (one channel a lane).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 32;   // rows a lane group walks
constexpr int kBatch = 8;  // rows whose loads are in flight together

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// merge v[0..kVec) into the f32 table at dst: the channels above 0 only
template <int kVec>
__device__ __forceinline__ void merge(float* dst, const float (&v)[kVec]) {
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    if (v[j] > 0.f)
      atomicMax(reinterpret_cast<int*>(dst) + j, __float_as_int(v[j]));
}

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
    segment_max_kernel(const T* __restrict__ data,
                       const int32_t* __restrict__ ids,
                       const uint8_t* __restrict__ valid,
                       float* __restrict__ table, long long n, int c,
                       int num_segments) {
  const int lanes = c / kVec;  // lanes per row
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long group = t / lanes;
  const int col = (int)(t % lanes) * kVec;
  const long long r0 = group * kRun;
  if (r0 >= n) return;
  const int rows = (int)(n - r0 < kRun ? n - r0 : kRun);
  int cur = -1;
  float acc[kVec];
  for (int b = 0; b < rows; b += kBatch) {
    int seg[kBatch];
    float v[kBatch][kVec];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      seg[i] = -1;
      if (b + i < rows) {
        const long long r = r0 + b + i;
        const int s = __ldg(ids + r);
        const bool ok = (valid == nullptr || __ldg(valid + r) != 0) &&
                        s >= 0 && s < num_segments;
        seg[i] = ok ? s : -1;
        const T* src = data + r * c + col;
        if constexpr (kVec == 4 && sizeof(T) == 4) {
          const float4 f = __ldg(reinterpret_cast<const float4*>(src));
          v[i][0] = f.x; v[i][1] = f.y; v[i][2] = f.z; v[i][3] = f.w;
        } else if constexpr (kVec == 4) {
          const uint2 raw = __ldg(reinterpret_cast<const uint2*>(src));
          const float2 a = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
          const float2 b = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
          v[i][0] = a.x; v[i][1] = a.y; v[i][2] = b.x; v[i][3] = b.y;
        } else {
#pragma unroll
          for (int j = 0; j < kVec; ++j) v[i][j] = to_f32(src[j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (seg[i] < 0) continue;
      if (seg[i] != cur) {
        if (cur >= 0) merge<kVec>(table + (long long)cur * c + col, acc);
        cur = seg[i];
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc[j] = v[i][j];
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc[j] = fmaxf(acc[j], v[i][j]);
      }
    }
  }
  if (cur >= 0) merge<kVec>(table + (long long)cur * c + col, acc);
}

// out[i] = bf16(table[i]): exact, the table holds bf16 values
__global__ void __launch_bounds__(kThreads)
    to_bf16(const float* __restrict__ table, __nv_bfloat16* __restrict__ out,
            long long count) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < count; i += (long long)gridDim.x * blockDim.x)
    out[i] = __float2bfloat16_rn(table[i]);
}

template <typename T, int kVec>
int launch(const void* data, const void* ids, const void* valid,
           float* table, long long n, long long c, long long num_segments,
           cudaStream_t stream) {
  const long long threads = (n + kRun - 1) / kRun * (c / kVec);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  segment_max_kernel<T, kVec><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const T*)data, (const int32_t*)ids, (const uint8_t*)valid, table, n,
      (int)c, (int)num_segments);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* data, const void* ids, const void* valid, float* table,
        long long n, long long c, long long num_segments,
        cudaStream_t stream) {
  constexpr int kVec = 4;
  const bool vec = c % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(data) % (kVec * sizeof(T)) == 0;
  return vec ? launch<T, kVec>(data, ids, valid, table, n, c, num_segments,
                               stream)
             : launch<T, 1>(data, ids, valid, table, n, c, num_segments,
                            stream);
}

}  // namespace

// data (n, c) f32 or bf16 (is_bf16), non-negative; ids (n,) int32; valid
// (n,) bytes (a bool tensor's) or null; out (num_segments, c) of data's type;
// table (num_segments, c) f32 scratch for bf16 data (null for f32, which
// merges into out). Zeroes the table itself. Returns a cudaError_t.
extern "C" int idt_segment_max(const void* data, const void* ids,
                               const void* valid, void* out, void* table,
                               long long n, long long c,
                               long long num_segments, long long is_bf16,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n < 0 || c < 1 || num_segments < 0 || (is_bf16 && table == nullptr))
    return (int)cudaErrorInvalidValue;
  float* tab = is_bf16 ? (float*)table : (float*)out;
  const long long count = num_segments * c;
  cudaError_t err = cudaMemsetAsync(tab, 0, (size_t)count * 4, s);
  if (err != cudaSuccess || count == 0) return (int)err;
  if (n > 0) {
    const int e = is_bf16 ? run<__nv_bfloat16>(data, ids, valid, tab, n, c,
                                               num_segments, s)
                          : run<float>(data, ids, valid, tab, n, c,
                                       num_segments, s);
    if (e != 0) return e;
  }
  if (is_bf16) {
    const long long blocks = (count + kThreads - 1) / kThreads;
    to_bf16<<<(unsigned)(blocks < 1024 ? blocks : 1024), kThreads, 0, s>>>(
        tab, (__nv_bfloat16*)out, count);
  }
  return (int)cudaGetLastError();
}
