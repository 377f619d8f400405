// K6: per-pair decode of the stage-1 `global` and dense modes (IEF offset +
// IMNet termination logit of each compacted ray/voxel pair row).
//
// Replaces implicit_depth_tpu/ops/pallas_decode.py::fused_pair_decode (its
// Pallas kernel over _decode_tile). Each row's 385-d embedding
// [voxel row | roi | pe(enter) | pe(leave) | dir_e] is decoded by two
// 4-layer MLPs (256 -> 128 -> 64 -> 1, LeakyReLU 0.02, soft clamp), the
// offset decoder as a 2-iteration IEF.
//
// What bounds it on the H100: operations. One row costs ~0.64 MFLOP (layer 1
// of both decoders over the 385-d embedding, two IEF tails and the
// probability tail); at the served frame's 614,400 (`global`, budget 8) or
// 1,536,000 (dense, K = 20) rows that is ~0.4 or ~1.0 ms at the bf16
// tensor-core peak, against ~0.02 ms for the bytes it must read. Its design
// keeps every intermediate on chip:
//   * a row names its voxel row by cell in the (B*729, Cv) voxel table and its
//     ray by index in the per-ray [roi | dir_e] rows (in the dense layout the
//     row index gives the ray), and the kernel reads both by index: the
//     gathered (P, 385) embedding and the per-ray broadcast are never written
//     to memory;
//   * the embedding is built in shared memory, its positional encoding
//     computed from the raw f32 positions (sinf, cosf of x * 2^j);
//   * layer 1 of the offset decoder is computed once and its 1 -> 16 offset
//     encoder folded into a rank-1 update (offset * a_vec + c_vec);
//   * activations stay in shared memory; weights are read through L2.
// A block decodes 64 rows in bf16 on the tensor cores (wmma) or 32 rows in
// f32 on the CUDA cores, one block per SM. wgmma, TMA staging of the weights
// and a per-ray split of layer 1 are later work.
//
// Numerics follow _decode_tile: every product takes compute-type operands
// with f32 accumulation; the embedding (raw positions included) is rounded
// to the compute type; the probability decoder's biases 1-3 add in f32
// unrounded (the caller passes them so), the IEF's biases 2 and 3 rounded.
#include "decode_common.cuh"

namespace {

using namespace idt;

template <typename T>
struct Smem {
  size_t x, e1, c, h, off, logit, total;
  __host__ __device__ static size_t al(size_t b) { return (b + 127) / 128 * 128; }
  __host__ __device__ Smem(int m, int kp) {
    size_t o = 0;
    x = o;      // the embedding; later H2 | H3
    o = al(o + (size_t)m * (kp > kG2 + kG3 ? kp : kG2 + kG3) * sizeof(T));
    e1 = o;     // offset layer-1 pre-activation
    o = al(o + (size_t)m * kG1 * 4);
    c = o;      // product scratch
    o = al(o + (size_t)m * kG1 * 4);
    h = o;      // rounded layer-1 activation
    o = al(o + (size_t)m * kG1 * sizeof(T));
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
  const int32_t* cells;   // (p,) row ids into vox_table
  const int32_t* rays;    // (p,) row ids into ray_feat; null: row / slots
  const float* pos;       // (p, 6) f32 [enter xyz | leave xyz]
  const T* ray_feat;      // (n, c_roi + c_dir) [roi | dir_e]
  const T* w1;            // (kp, 512) rows [embed | 0], cols [off | prob]
  const float* b1;        // (512,) [off_b1 | prob_b1]
  const float* a_vec;     // (256,)
  const float* c_vec;     // (256,)
  TailWeights<T> off, prob;
  float* out_off;         // (p,)
  float* out_logit;       // (p,)
  long long p;
  int c_vox, c_roi, c_dir, multires, kp, slots, n_iter, use_sigmoid;
  float init_offset;
};

template <typename T, int M>
__global__ void __launch_bounds__(kThreads, 1)
    pair_decode_kernel(const Params<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<T> lay(M, p.kp);
  T* X = reinterpret_cast<T*>(smem + lay.x);
  float* E1 = reinterpret_cast<float*>(smem + lay.e1);
  float* C = reinterpret_cast<float*>(smem + lay.c);
  T* H = reinterpret_cast<T*>(smem + lay.h);
  float* OFF = reinterpret_cast<float*>(smem + lay.off);
  float* LOGIT = reinterpret_cast<float*>(smem + lay.logit);
  T* H2 = X;  // X is dead after layer 1
  T* H3 = X + M * kG2;

  const long long row0 = (long long)blockIdx.x * M;
  const int kp = p.kp, c_ray = p.c_roi + p.c_dir;
  const int c_pe = 3 * (1 + 2 * p.multires);
  const int o_pe = p.c_vox + p.c_roi;           // pe(enter) | pe(leave)
  const int o_dir = o_pe + 2 * c_pe;            // dir_e
  const int c_embed = o_dir + p.c_dir;

  // -- the embedding, one row per pair --------------------------------------
  for (int i = threadIdx.x; i < M * kp; i += blockDim.x) {
    const int row = i / kp, col = i % kp;
    const long long prow = row0 + row;
    T v = from_f32<T>(0.f);
    if (prow < p.p && col < c_embed) {
      if (col < p.c_vox) {
        const long long cell = __ldg(p.cells + prow);
        v = ldg_raw(p.vox_table + cell * p.c_vox + col);
      } else {
        const long long ray = p.rays ? (long long)__ldg(p.rays + prow)
                                     : prow / p.slots;
        if (col < o_pe) {
          v = ldg_raw(p.ray_feat + ray * c_ray + (col - p.c_vox));
        } else if (col >= o_dir) {
          v = ldg_raw(p.ray_feat + ray * c_ray + p.c_roi + (col - o_dir));
        } else {
          // [x (3) | per frequency j: sin(x 2^j) (3) | cos(x 2^j) (3)]
          const int t = col - o_pe;
          const int which = t / c_pe, u = t % c_pe;
          if (u < 3) {
            v = from_f32<T>(__ldg(p.pos + prow * 6 + which * 3 + u));
          } else {
            const int j = (u - 3) / 6, is_cos = ((u - 3) % 6) / 3;
            const int d = (u - 3) % 3;
            const float arg =
                __ldg(p.pos + prow * 6 + which * 3 + d) * (float)(1 << j);
            v = from_f32<T>(is_cos ? cosf(arg) : sinf(arg));
          }
        }
      }
    }
    X[i] = v;
  }
  __syncthreads();

  // -- offset decoder layer 1, once: E1 = X @ W1_off + off_b1 ----------------
  tile_product<T, M, kG1>(X, kp, p.w1, 2 * kG1, kp, E1, kG1);
  __syncthreads();
  for (int i = threadIdx.x; i < M * kG1; i += blockDim.x)
    E1[i] += __ldg(p.b1 + i % kG1);
  // -- probability decoder layer 1: H = act(X @ W1_prob + prob_b1) -----------
  tile_product<T, M, kG1>(X, kp, p.w1 + kG1, 2 * kG1, kp, C, kG1);
  __syncthreads();
  for (int i = threadIdx.x; i < M * kG1; i += blockDim.x)
    H[i] = from_f32<T>(leaky(C[i] + __ldg(p.b1 + kG1 + i % kG1)));
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
    const long long prow = row0 + threadIdx.x;
    if (prow < p.p) {
      p.out_off[prow] = squash(OFF[threadIdx.x], p.use_sigmoid);
      p.out_logit[prow] = squash(LOGIT[threadIdx.x], p.use_sigmoid);
    }
  }
}

template <typename T, int M>
int launch(const Params<T>& p, void* stream) {
  const Smem<T> lay(M, p.kp);
  auto kernel = pair_decode_kernel<T, M>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (p.p + M - 1) / M;
  kernel<<<(unsigned)blocks, kThreads, lay.total, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int run(void* const* ptrs, long long n, long long c_vox, long long c_roi,
        long long c_dir, long long multires, long long kp, long long slots,
        long long n_iter, long long use_sigmoid, float init_offset,
        void* stream) {
  Params<T> p;
  p.vox_table = (const T*)ptrs[0];
  p.cells = (const int32_t*)ptrs[1];
  p.rays = (const int32_t*)ptrs[2];
  p.pos = (const float*)ptrs[3];
  p.ray_feat = (const T*)ptrs[4];
  p.w1 = (const T*)ptrs[5];
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
  p.p = n;
  p.c_vox = (int)c_vox;
  p.c_roi = (int)c_roi;
  p.c_dir = (int)c_dir;
  p.multires = (int)multires;
  p.kp = (int)kp;
  p.slots = (int)slots;
  p.n_iter = (int)n_iter;
  p.use_sigmoid = (int)use_sigmoid;
  p.init_offset = init_offset;
  const long long c_embed = c_vox + c_roi + 6 * (1 + 2 * multires) + c_dir;
  if (kp % 16 || kp < c_embed || (p.rays == nullptr && slots < 1))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if constexpr (sizeof(T) == 2) {
    return launch<T, 64>(p, stream);
  } else {
    return launch<T, 32>(p, stream);
  }
}

}  // namespace

// ptrs: vox_table, cells, rays (or null), pos, ray_feat, w1, b1, a_vec, c_vec,
// off_{w2,b2,w3,b3,w4,b4}, prob_{w2,b2,w3,b3,w4,b4}, out_off, out_logit (23
// device pointers). slots: the rows per ray of the dense layout, read when
// rays is null. Returns a cudaError_t.
extern "C" int idt_pair_decode(void* const* ptrs, long long n, long long c_vox,
                               long long c_roi, long long c_dir,
                               long long multires, long long kp,
                               long long slots, long long n_iter,
                               long long is_bf16, long long use_sigmoid,
                               float init_offset, void* stream) {
  return is_bf16 ? run<__nv_bfloat16>(ptrs, n, c_vox, c_roi, c_dir, multires,
                                      kp, slots, n_iter, use_sigmoid,
                                      init_offset, stream)
                 : run<float>(ptrs, n, c_vox, c_roi, c_dir, multires, kp,
                              slots, n_iter, use_sigmoid, init_offset, stream);
}
