// K5: segmented max of non-negative rows into a zero-initialised table.
//
// Replaces implicit_depth_tpu/ops/pallas_segment.py::pallas_segment_max0
// (the TPU kernel keeps the whole (segments, C) table in VMEM and merges the
// point rows into it one by one across a sequential grid).
//
// What bounds it on the H100: bytes. Each input element is read once (plus
// its row's id and valid flag) and the table is small (B*729 x C floats, a
// few hundred KB), so it lives in L2; the floor is the input read over HBM
// bandwidth. In practice the atomics bound it: many rows of one image fall
// into the same few voxels, so the L2 atomic units serialise on those cells.
//
// Design: one thread per (row, channel) element, grid-stride. A positive
// value is merged with atomicMax on the int32 bit pattern of the float
// table: non-negative IEEE floats order like their bit patterns, so this is
// an exact max, and the zero-initialised table gives empty segments exactly
// 0 (torch_scatter's zero-init semantics). Zeros, which post-ReLU data is
// full of, are skipped: they cannot raise a cell above its initial 0.
// Invalid rows are skipped instead of routed to a trash row. bf16 input is
// accumulated in an f32 table (exact: bf16 values are f32 values); the
// wrapper casts the table back. A warp- or block-level pre-reduction over
// rows that share a cell would cut the atomic traffic: later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void segment_max_kernel(const T* __restrict__ data,
                                   const int32_t* __restrict__ ids,
                                   const uint8_t* __restrict__ valid,
                                   int* __restrict__ table, long long n,
                                   int c, int num_segments) {
  const long long total = n * c;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long row = i / c;
    if (valid != nullptr && valid[row] == 0) continue;
    const float v = to_f32(data[i]);
    if (!(v > 0.f)) continue;
    const int seg = ids[row];
    if (seg < 0 || seg >= num_segments) continue;
    atomicMax(table + (long long)seg * c + (i - row * c), __float_as_int(v));
  }
}

template <typename T>
int launch(const void* data, const void* ids, const void* valid, void* table,
           long long n, long long c, long long num_segments, void* stream) {
  const int threads = 256;
  long long blocks = (n * c + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  segment_max_kernel<T><<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
      (const T*)data, (const int32_t*)ids, (const uint8_t*)valid,
      (int*)table, n, (int)c, (int)num_segments);
  return (int)cudaGetLastError();
}

}  // namespace

// data (n, c) f32 or bf16 (is_bf16), ids (n,) int32, valid (n,) uint8 or
// null, table (num_segments, c) f32 zero-filled by the caller.
extern "C" int idt_segment_max(const void* data, const void* ids,
                               const void* valid, void* table, long long n,
                               long long c, long long num_segments,
                               long long is_bf16, void* stream) {
  if (n == 0) return 0;
  return is_bf16 ? launch<__nv_bfloat16>(data, ids, valid, table, n, c,
                                         num_segments, stream)
                 : launch<float>(data, ids, valid, table, n, c, num_segments,
                                 stream);
}
