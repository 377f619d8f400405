// K1: stage-1 ray-major pair decode (IEF offset + IMNet termination logit).
// K2: the same kernel instantiated with kSave, the training forward.
//
// Replaces implicit_depth_tpu/ops/pallas_ray_decode.py::fused_ray_decode
// (_fused_fwd_impl and its Pallas kernel): for every ray, its kb = 8 nearest
// pair slots are decoded by two 4-layer MLPs (256 -> 128 -> 64 -> 1, LeakyReLU
// 0.02, soft clamp), the offset decoder as a 2-iteration IEF. With kSave it
// replaces fused_ray_decode_table's training forward (_table_fwd,
// save_mode='l1'): it also writes, rounded to T as the JAX kernel rounds
// them, e1 (the IEF layer-1 pre-activation before the offset term), z1p (the
// probability decoder's layer-1 pre-activation) and trig (the sin block),
// which the backward K3 (ray_decode_bwd.cu) starts from. The outputs of K1
// and K2 are the same bits: the saves are stores of values K1 computes.
//
// What bounds it on the H100: operations. At serving shapes (76,800 rays x 8
// slots) it is ~3e11 FLOP against ~0.2 GB of operand bytes, ~0.3 ms at the
// bf16 tensor-core peak. Its design keeps every intermediate on chip:
//   * the voxel row of each pair is read by its cell id from the (B*729, Cv)
//     voxel table (an indexed load, cheap on a GPU): the (N*kb, Cv) gathered
//     rows are never written to memory;
//   * the positional encoding of enter/leave is computed in the kernel from the
//     raw f32 positions (sinf of pos * 2^j + phase), and layer 1 is split into a
//     per-pair part over [vox | pos6 | trig] and a per-ray part over
//     [roi | dir_e], computed once per ray and reused by its 8 slots;
//   * layer 1 of the offset decoder is hoisted out of the IEF iterations and
//     its 1 -> 16 offset encoder is folded into a rank-1 update
//     (offset * a_vec + c_vec);
//   * activations stay in shared memory; weights (~0.56 MB in bf16, more than
//     a block's 227 KB) are read through L2.
// A block decodes 8 rays (64 rows) in bf16 on the tensor cores (wmma), or
// 4 rays (32 rows) in f32 on the CUDA cores. This first version runs one
// block per SM and reads weight fragments from L2 without staging; a
// TMA/wgmma pipeline is later work.
#include "decode_common.cuh"

namespace {

using namespace idt;

constexpr int kKb = 8;  // pair slots decoded per ray

template <typename T>
struct Smem {
  // byte offsets of each region in dynamic shared memory
  size_t x, e1, c, h, ray, off, logit, total;
  __host__ __device__ static size_t al(size_t b) { return (b + 127) / 128 * 128; }
  __host__ __device__ Smem(int m, int mr, int kp, int crp) {
    size_t o = 0;
    x = o;      // pair layer-1 input; later H2 | H3
    o = al(o + (size_t)m * (kp > kG2 + kG3 ? kp : kG2 + kG3) * sizeof(T));
    e1 = o;     // offset layer-1 pre-activation
    o = al(o + (size_t)m * kG1 * 4);
    c = o;      // product scratch; first the per-ray inputs
    o = al(o + (size_t)m * kG1 * 4);
    h = o;      // rounded layer-1 activation
    o = al(o + (size_t)m * kG1 * sizeof(T));
    ray = o;    // per-ray layer-1 part
    o = al(o + (size_t)mr * 2 * kG1 * 4);
    off = o;
    o = al(o + (size_t)m * 4);
    logit = o;
    o = al(o + (size_t)m * 4);
    total = o;
  }
};

template <typename T>
struct Params {
  const T* vox_table;     // (S, c_vox)
  const int32_t* cells;   // (n, kb) row ids into vox_table
  const float* pos;       // (n, kb, 6) f32 [enter xyz | leave xyz]
  const T* ray_feat;      // (n, c_ray)
  const T* pair_w1;       // (kp, 512) rows [vox | pos6 | trig | 0], cols [off | prob]
  const T* ray_w1;        // (crp, 512) rows [roi | dir | 0]
  const float* b1;        // (512,)
  const float* a_vec;     // (256,)
  const float* c_vec;     // (256,)
  TailWeights<T> off, prob;
  float* out_off;         // (n, kb)
  float* out_logit;       // (n, kb)
  T* save_e1;             // kSave: (n*kb, 256)
  T* save_z1p;            // kSave: (n*kb, 256)
  T* save_trig;           // kSave: (n*kb, 12*multires)
  long long n;
  int c_vox, c_ray, multires, kp, crp, n_iter, use_sigmoid;
  float init_offset;
};

template <typename T, int M, bool kSave>
__global__ void __launch_bounds__(kThreads, 1)
    ray_decode_kernel(const Params<T> p) {
  constexpr int MR = M / kKb;  // rays per block
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<T> lay(M, MR, p.kp, p.crp);
  T* X = reinterpret_cast<T*>(smem + lay.x);
  float* E1 = reinterpret_cast<float*>(smem + lay.e1);
  float* C = reinterpret_cast<float*>(smem + lay.c);
  T* H = reinterpret_cast<T*>(smem + lay.h);
  float* RAY = reinterpret_cast<float*>(smem + lay.ray);
  float* OFF = reinterpret_cast<float*>(smem + lay.off);
  float* LOGIT = reinterpret_cast<float*>(smem + lay.logit);
  T* RF = reinterpret_cast<T*>(smem + lay.c);  // per-ray inputs, before C
  T* H2 = X;                                   // X is dead after layer 1
  T* H3 = X + M * kG2;

  const long long ray0 = (long long)blockIdx.x * MR;
  const int kp = p.kp, crp = p.crp;
  const int n_trig = 12 * p.multires;

  // -- stage the per-ray inputs and the per-pair layer-1 input ----------------
  for (int i = threadIdx.x; i < MR * crp; i += blockDim.x) {
    const int r = i / crp, col = i % crp;
    const long long ray = ray0 + r;
    RF[i] = (ray < p.n && col < p.c_ray)
                ? ldg_raw(p.ray_feat + ray * p.c_ray + col)
                : from_f32<T>(0.f);
  }
  for (int i = threadIdx.x; i < M * kp; i += blockDim.x) {
    const int row = i / kp, col = i % kp;
    const long long ray = ray0 + row / kKb;
    const long long prow = ray * kKb + row % kKb;  // global pair row
    T v = from_f32<T>(0.f);
    if (ray < p.n) {
      if (col < p.c_vox) {
        const long long cell = __ldg(p.cells + prow);
        v = ldg_raw(p.vox_table + cell * p.c_vox + col);
      } else if (col < p.c_vox + 6) {
        v = from_f32<T>(__ldg(p.pos + prow * 6 + (col - p.c_vox)));
      } else if (col < p.c_vox + 6 + n_trig) {
        v = from_f32<T>(
            trig_column(p.pos + prow * 6, col - p.c_vox - 6, p.multires));
      }
    }
    X[i] = v;
    if constexpr (kSave) {
      const int t = col - p.c_vox - 6;
      if (ray < p.n && t >= 0 && t < n_trig)
        p.save_trig[(ray * kKb + row % kKb) * n_trig + t] = v;
    }
  }
  __syncthreads();

  // -- per-ray layer-1 part, once per ray: RAY = RF @ ray_w1 ------------------
  fma_tile<T, MR>(RF, crp, p.ray_w1, 2 * kG1, crp, 2 * kG1, RAY, 2 * kG1);
  __syncthreads();

  // -- offset decoder layer 1: E1 = X @ W_off + ray part + b1 -----------------
  tile_product<T, M, kG1>(X, kp, p.pair_w1, 2 * kG1, kp, E1, kG1);
  __syncthreads();
  for (int i = threadIdx.x; i < M * kG1; i += blockDim.x) {
    const int row = i / kG1, c = i % kG1;
    E1[i] = E1[i] + RAY[(row / kKb) * 2 * kG1 + c] + __ldg(p.b1 + c);
    if constexpr (kSave) {
      const long long ray = ray0 + row / kKb;
      if (ray < p.n)
        p.save_e1[(ray * kKb + row % kKb) * kG1 + c] = from_f32<T>(E1[i]);
    }
  }
  // -- probability decoder layer 1: H = act(X @ W_prob + ray part + b1) -------
  tile_product<T, M, kG1>(X, kp, p.pair_w1 + kG1, 2 * kG1, kp, C, kG1);
  __syncthreads();
  for (int i = threadIdx.x; i < M * kG1; i += blockDim.x) {
    const int row = i / kG1, c = i % kG1;
    const float z = C[i] + RAY[(row / kKb) * 2 * kG1 + kG1 + c] +
                    __ldg(p.b1 + kG1 + c);
    H[i] = from_f32<T>(leaky(z));
    if constexpr (kSave) {
      const long long ray = ray0 + row / kKb;
      if (ray < p.n)
        p.save_z1p[(ray * kKb + row % kKb) * kG1 + c] = from_f32<T>(z);
    }
  }
  __syncthreads();

  // -- probability decoder layers 2-4 -----------------------------------------
  mlp_tail<T, M>(H, C, H2, H3, p.prob, LOGIT, /*accumulate=*/false);
  if (threadIdx.x < M) {
    LOGIT[threadIdx.x] += __ldg(p.prob.b4);
    OFF[threadIdx.x] = p.init_offset;
  }
  __syncthreads();

  // -- offset decoder: IEF iterations over the hoisted layer 1 ----------------
  ief_loop<T, M>(E1, H, C, H2, H3, p.a_vec, p.c_vec, p.off, OFF, p.n_iter);

  if (threadIdx.x < M) {
    const long long ray = ray0 + threadIdx.x / kKb;
    if (ray < p.n) {
      const long long prow = ray * kKb + threadIdx.x % kKb;
      p.out_off[prow] = squash(OFF[threadIdx.x], p.use_sigmoid);
      p.out_logit[prow] = squash(LOGIT[threadIdx.x], p.use_sigmoid);
    }
  }
}

template <typename T, int M, bool kSave>
int launch(const Params<T>& p, void* stream) {
  constexpr int MR = M / kKb;
  const Smem<T> lay(M, MR, p.kp, p.crp);
  auto kernel = ray_decode_kernel<T, M, kSave>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (p.n + MR - 1) / MR;
  kernel<<<(unsigned)blocks, kThreads, lay.total, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, bool kSave>
int run(void* const* ptrs, long long n, long long c_vox, long long c_ray,
        long long multires, long long kp, long long crp, long long n_iter,
        long long use_sigmoid, float init_offset, void* stream) {
  Params<T> p;
  p.vox_table = (const T*)ptrs[0];
  p.cells = (const int32_t*)ptrs[1];
  p.pos = (const float*)ptrs[2];
  p.ray_feat = (const T*)ptrs[3];
  p.pair_w1 = (const T*)ptrs[4];
  p.ray_w1 = (const T*)ptrs[5];
  p.b1 = (const float*)ptrs[6];
  p.a_vec = (const float*)ptrs[7];
  p.c_vec = (const float*)ptrs[8];
  TailWeights<T>* tails[2] = {&p.off, &p.prob};
  for (int d = 0; d < 2; ++d) {
    void* const* q = ptrs + 9 + 6 * d;
    tails[d]->w2 = (const T*)q[0];
    tails[d]->b2 = (const float*)q[1];
    tails[d]->w3 = (const T*)q[2];
    tails[d]->b3 = (const float*)q[3];
    tails[d]->w4 = (const T*)q[4];
    tails[d]->b4 = (const float*)q[5];
  }
  p.out_off = (float*)ptrs[21];
  p.out_logit = (float*)ptrs[22];
  p.save_e1 = kSave ? (T*)ptrs[23] : nullptr;
  p.save_z1p = kSave ? (T*)ptrs[24] : nullptr;
  p.save_trig = kSave ? (T*)ptrs[25] : nullptr;
  p.n = n;
  p.c_vox = (int)c_vox;
  p.c_ray = (int)c_ray;
  p.multires = (int)multires;
  p.kp = (int)kp;
  p.crp = (int)crp;
  p.n_iter = (int)n_iter;
  p.use_sigmoid = (int)use_sigmoid;
  p.init_offset = init_offset;
  if (kp % 16 || crp % 16 || kp < c_vox + 6 + 12 * multires || crp < c_ray)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if constexpr (sizeof(T) == 2) {
    return launch<T, 64, kSave>(p, stream);
  } else {
    return launch<T, 32, kSave>(p, stream);
  }
}

}  // namespace

// ptrs: vox_table, cells, pos, ray_feat, pair_w1, ray_w1, b1, a_vec, c_vec,
// off_{w2,b2,w3,b3,w4,b4}, prob_{w2,b2,w3,b3,w4,b4}, out_off, out_logit
// (23 device pointers). Returns a cudaError_t.
extern "C" int idt_ray_decode(void* const* ptrs, long long n, long long c_vox,
                              long long c_ray, long long multires,
                              long long kp, long long crp, long long n_iter,
                              long long is_bf16, long long use_sigmoid,
                              float init_offset, void* stream) {
  return is_bf16 ? run<__nv_bfloat16, false>(ptrs, n, c_vox, c_ray, multires,
                                             kp, crp, n_iter, use_sigmoid,
                                             init_offset, stream)
                 : run<float, false>(ptrs, n, c_vox, c_ray, multires, kp, crp,
                                     n_iter, use_sigmoid, init_offset, stream);
}

// K2: the pointers of idt_ray_decode, then save_e1, save_z1p, save_trig
// (26 device pointers). Returns a cudaError_t.
extern "C" int idt_ray_decode_save(void* const* ptrs, long long n,
                                   long long c_vox, long long c_ray,
                                   long long multires, long long kp,
                                   long long crp, long long n_iter,
                                   long long is_bf16, long long use_sigmoid,
                                   float init_offset, void* stream) {
  return is_bf16 ? run<__nv_bfloat16, true>(ptrs, n, c_vox, c_ray, multires,
                                            kp, crp, n_iter, use_sigmoid,
                                            init_offset, stream)
                 : run<float, true>(ptrs, n, c_vox, c_ray, multires, kp, crp,
                                    n_iter, use_sigmoid, init_offset, stream);
}
