// K4: stage-2 (refine) per-ray IEF offset decode.
//
// Replaces implicit_depth_tpu/ops/pallas_ray_decode.py::fused_ief_rows
// (_ief_fwd_impl and its Pallas kernel): each ray's embedding, given as its
// parts [end voxel feature | rc = (roi, dir_e) | pos_e], goes through a
// 2-iteration IEF decoder (256 -> 128 -> 64 -> 1, LeakyReLU 0.02, soft clamp)
// to one offset.
//
// What bounds it on the H100: operations (~2.6e10 FLOP per launch at 76,800
// rays against ~80 MB of operands: ~0.03 ms at the bf16 tensor-core peak).
// The design is K1's (ray_decode.cu) without the slot dimension: the parts
// are concatenated only in shared memory (the (N, 334) embedding never
// exists in device memory), layer 1 is computed once and hoisted out of the
// iterations with the offset encoder folded into a rank-1 update, and every
// activation stays in shared memory while weights are read through L2.
// 64 rows per block in bf16 (tensor cores, wmma), 32 in f32 (CUDA cores).
#include "decode_common.cuh"

namespace {

using namespace idt;

template <typename T>
struct Smem {
  size_t x, e1, c, h, off, total;
  __host__ __device__ static size_t al(size_t b) { return (b + 127) / 128 * 128; }
  __host__ __device__ Smem(int m, int kp) {
    size_t o = 0;
    x = o;      // layer-1 input [end | rc | pos | 0]; later H2 | H3
    o = al(o + (size_t)m * (kp > kG2 + kG3 ? kp : kG2 + kG3) * sizeof(T));
    e1 = o;     // layer-1 pre-activation (iteration-invariant part)
    o = al(o + (size_t)m * kG1 * 4);
    c = o;      // product scratch (layers 2 and 3)
    o = al(o + (size_t)m * kG2 * 4);
    h = o;      // rounded layer-1 activation
    o = al(o + (size_t)m * kG1 * sizeof(T));
    off = o;
    o = al(o + (size_t)m * 4);
    total = o;
  }
};

template <typename T>
struct Params {
  const T* end;        // (n, c_end)
  const T* rc;         // (n, c_rc)
  const T* pos;        // (n, c_pos)
  const T* w1;         // (kp, 256) rows [end | rc | pos | 0]
  const float* b1;     // (256,)
  const float* a_vec;  // (256,)
  const float* c_vec;  // (256,)
  TailWeights<T> tail;
  float* out;          // (n,)
  long long n;
  int c_end, c_rc, c_pos, kp, n_iter, use_sigmoid;
  float init_offset;
};

template <typename T, int M>
__global__ void __launch_bounds__(kThreads, 1)
    ief_decode_kernel(const Params<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<T> lay(M, p.kp);
  T* X = reinterpret_cast<T*>(smem + lay.x);
  float* E1 = reinterpret_cast<float*>(smem + lay.e1);
  float* C = reinterpret_cast<float*>(smem + lay.c);
  T* H = reinterpret_cast<T*>(smem + lay.h);
  float* OFF = reinterpret_cast<float*>(smem + lay.off);
  T* H2 = X;
  T* H3 = X + M * kG2;

  const long long row0 = (long long)blockIdx.x * M;
  const int kp = p.kp;
  const int o_rc = p.c_end, o_pos = p.c_end + p.c_rc,
            o_pad = p.c_end + p.c_rc + p.c_pos;
  for (int i = threadIdx.x; i < M * kp; i += blockDim.x) {
    const int r = i / kp, col = i % kp;
    const long long row = row0 + r;
    T v = from_f32<T>(0.f);
    if (row < p.n) {
      if (col < o_rc)
        v = ldg_raw(p.end + row * p.c_end + col);
      else if (col < o_pos)
        v = ldg_raw(p.rc + row * p.c_rc + (col - o_rc));
      else if (col < o_pad)
        v = ldg_raw(p.pos + row * p.c_pos + (col - o_pos));
    }
    X[i] = v;
  }
  __syncthreads();

  tile_product<T, M, kG1>(X, kp, p.w1, kG1, kp, E1, kG1);
  __syncthreads();
  for (int i = threadIdx.x; i < M * kG1; i += blockDim.x)
    E1[i] += __ldg(p.b1 + i % kG1);
  if (threadIdx.x < M) OFF[threadIdx.x] = p.init_offset;
  __syncthreads();

  ief_loop<T, M>(E1, H, C, H2, H3, p.a_vec, p.c_vec, p.tail, OFF, p.n_iter);

  if (threadIdx.x < M && row0 + threadIdx.x < p.n)
    p.out[row0 + threadIdx.x] = squash(OFF[threadIdx.x], p.use_sigmoid);
}

template <typename T, int M>
int launch(const Params<T>& p, void* stream) {
  const Smem<T> lay(M, p.kp);
  auto kernel = ief_decode_kernel<T, M>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (p.n + M - 1) / M;
  kernel<<<(unsigned)blocks, kThreads, lay.total, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int run(void* const* ptrs, long long n, long long c_end, long long c_rc,
        long long c_pos, long long kp, long long n_iter, long long use_sigmoid,
        float init_offset, void* stream) {
  Params<T> p;
  p.end = (const T*)ptrs[0];
  p.rc = (const T*)ptrs[1];
  p.pos = (const T*)ptrs[2];
  p.w1 = (const T*)ptrs[3];
  p.b1 = (const float*)ptrs[4];
  p.a_vec = (const float*)ptrs[5];
  p.c_vec = (const float*)ptrs[6];
  p.tail.w2 = (const T*)ptrs[7];
  p.tail.b2 = (const float*)ptrs[8];
  p.tail.w3 = (const T*)ptrs[9];
  p.tail.b3 = (const float*)ptrs[10];
  p.tail.w4 = (const T*)ptrs[11];
  p.tail.b4 = (const float*)ptrs[12];
  p.out = (float*)ptrs[13];
  p.n = n;
  p.c_end = (int)c_end;
  p.c_rc = (int)c_rc;
  p.c_pos = (int)c_pos;
  p.kp = (int)kp;
  p.n_iter = (int)n_iter;
  p.use_sigmoid = (int)use_sigmoid;
  p.init_offset = init_offset;
  if (kp % 16 || kp < c_end + c_rc + c_pos) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if constexpr (sizeof(T) == 2) {
    return launch<T, 64>(p, stream);
  } else {
    return launch<T, 32>(p, stream);
  }
}

}  // namespace

// ptrs: end, rc, pos, w1, b1, a_vec, c_vec, w2, b2, w3, b3, w4, b4, out
// (14 device pointers). Returns a cudaError_t.
extern "C" int idt_ief_decode(void* const* ptrs, long long n, long long c_end,
                              long long c_rc, long long c_pos, long long kp,
                              long long n_iter, long long is_bf16,
                              long long use_sigmoid, float init_offset,
                              void* stream) {
  return is_bf16 ? run<__nv_bfloat16>(ptrs, n, c_end, c_rc, c_pos, kp, n_iter,
                                      use_sigmoid, init_offset, stream)
                 : run<float>(ptrs, n, c_end, c_rc, c_pos, kp, n_iter,
                              use_sigmoid, init_offset, stream);
}
