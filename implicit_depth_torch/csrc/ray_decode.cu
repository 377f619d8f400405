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
// bf16 tensor-core peak. Both instances keep every intermediate on chip:
//   * the voxel row of each pair is read by its cell id from the (B*729, Cv)
//     voxel table: the (N*kb, Cv) gathered rows are never written to memory;
//   * the positional encoding of enter/leave is computed in the kernel from the
//     raw f32 positions (sinf of pos * 2^j + phase), and layer 1 is split into a
//     per-pair part over [vox | pos6 | trig] and a per-ray part over
//     [roi | dir_e], computed once per ray and reused by its 8 slots;
//   * layer 1 of the offset decoder is hoisted out of the IEF iterations and
//     its 1 -> 16 offset encoder is folded into a rank-1 update
//     (offset * a_vec + c_vec).
// bf16 (the served and trained type): ray_decode_tc, a persistent block per
// SM over tiles of 8 rays (64 rows) on decode_tile.cuh's staged mma.sync
// products. Its first version (decode_common.cuh's mma_tile, K6's design)
// spent ~60% of its time in products whose weight fragments came from L2 in
// every warp, ~74% in those products' f32 round trips through shared memory
// and their elementwise passes, 9% in the per-ray part on CUDA cores and 16%
// in 2-byte input loads (scripts/attribute_k1_k4.py, PERF.md). Now the
// weights are staged once per tile, E1 stays in registers, the per-ray part
// (8 rays padded to 16 rows) runs on the tensor cores too, and the voxel rows
// of the next tile are copied (cp.async, 16 bytes) while the current one
// runs; ray features load 16 bytes at a time.
// f32 (the card-vs-CPU cross-checks only): ray_decode_kernel, 4 rays (32
// rows) a block, CUDA-core FMA products with the weights read from L2.
#include "decode_tile.cuh"

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

// -- bf16: the staged tensor-core kernel -------------------------------------

constexpr int kRays = tile::kM / kKb;  // rays per tile
// columns past c_vox a lane stages (kp - c_vox <= 256)
constexpr int kColsPerLane = 8;

// The per-tile product schedule: the per-ray part, the probability
// decoder's layer 1 and tail, the offset decoder's layer 1, then its tail
// once per IEF iteration. Returns the number of segments.
__device__ int k1_schedule(const Params<__nv_bfloat16>& p, tile::Seg* s) {
  int n = 0;
  s[n++] = {p.ray_w1, 2 * kG1, p.crp, 2 * kG1};
  s[n++] = {p.pair_w1 + kG1, 2 * kG1, p.kp, kG1};
  s[n++] = {p.prob.w2, kG2, kG1, kG2};
  s[n++] = {p.prob.w3, kG3, kG2, kG3};
  s[n++] = {p.pair_w1, 2 * kG1, p.kp, kG1};
  for (int i = 0; i < p.n_iter; ++i) {
    s[n++] = {p.off.w2, kG2, kG1, kG2};
    s[n++] = {p.off.w3, kG3, kG2, kG3};
  }
  return n;
}

template <bool kSave>
__global__ void __launch_bounds__(kThreads, 1)
    ray_decode_tc(const Params<__nv_bfloat16> p) {
  using namespace tile;
  extern __shared__ __align__(128) unsigned char smem[];
  const tile::Smem lay(p.kp, p.crp);
  // X of the even and of the odd tiles (by the block's tile count)
  auto x_of = [&](int parity) {
    return reinterpret_cast<bf16*>(smem + (parity ? lay.x1 : lay.x0));
  };
  bf16* RF = reinterpret_cast<bf16*>(smem + lay.rf);
  float* RAY = reinterpret_cast<float*>(smem + lay.ray);
  bf16* H = reinterpret_cast<bf16*>(smem + lay.h);
  bf16* H2 = reinterpret_cast<bf16*>(smem + lay.h2);
  float* OFF = reinterpret_cast<float*>(smem + lay.off);
  float* LOGIT = reinterpret_cast<float*>(smem + lay.logit);
  float* L4 = reinterpret_cast<float*>(smem + lay.l4);
  Seg* segs = reinterpret_cast<Seg*>(smem + lay.segs);

  const int kp = p.kp, c_vox = p.c_vox, n_trig = 12 * p.multires;
  const int ldx = ld_of(kp), ldr = ld_of(p.crp);
  const long long n_tiles = (p.n + kRays - 1) / kRays;
  if (threadIdx.x == 0) k1_schedule(p, segs);
  // the per-ray rows past the 8 rays, and the columns past c_ray, stay 0
  for (int i = threadIdx.x; i < 16 * ldr; i += blockDim.x)
    RF[i] = __float2bfloat16_rn(0.f);
  __syncthreads();
  Pipe pipe;
  pipe.init(reinterpret_cast<bf16*>(smem + lay.ring), segs,
            5 + 2 * p.n_iter);
  // the voxel row of each pair of a tile into X, by its cell id
  auto vox_rows = [&](long long t, bf16* X) {
    const long long ray0 = t * kRays;
    rows_async(
        [&](int r) -> const bf16* {
          const long long ray = ray0 + r / kKb;
          if (ray >= p.n) return nullptr;
          return p.vox_table + (long long)__ldg(p.cells + ray * kKb + r % kKb) * c_vox;
        },
        kM, c_vox, X, ldx, p.vox_table);
  };
  if (blockIdx.x < n_tiles) vox_rows(blockIdx.x, x_of(0));
  pipe.start();
  // the columns c_vox + lane + 32 j of [pos6 | trig | 0] each lane stages in
  // every row: the element of pos6 it reads (-1: padding) and, for trig,
  // its frequency and phase (trig_column's, so that the bits are the same)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int col_src[kColsPerLane];
  float col_scale[kColsPerLane], col_phase[kColsPerLane];
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) {
    const int u = lane + 32 * j, tt = u - 6;  // column c_vox + u: trig tt
    col_src[j] = -1;
    col_scale[j] = 1.f;
    col_phase[j] = 0.f;
    if (u < 6) {
      col_src[j] = u;
    } else if (tt < n_trig) {
      const int per_pos = 6 * p.multires, f = tt % per_pos;
      col_src[j] = tt / per_pos * 3 + f % 3;
      col_scale[j] = (float)(1 << (f / 6));
      col_phase[j] = (f % 6) / 3 ? kHalfPi : 0.f;
    }
  }

  int parity = 0;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x, parity ^= 1) {
    bf16* X = x_of(parity);
    const long long ray0 = t * kRays;
    const int valid = (int)min((long long)kRays, p.n - ray0);

    // -- stage [pos6 | trig | 0] of the pairs and the rays' features --------
    // a warp a row, its lanes over the columns (what each holds: col_src)
    for (int row = warp; row < kM; row += kWarps) {
      const long long prow = ray0 * kKb + row;
      const bool ok = row / kKb < valid;
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int u = lane + 32 * j;  // column c_vox + u
        if (u >= kp - c_vox) break;
        float v = 0.f;
        if (ok && col_src[j] >= 0) {
          const float x = __ldg(p.pos + prow * 6 + col_src[j]);
          v = u < 6 ? x : sinf(x * col_scale[j] + col_phase[j]);
          if constexpr (kSave) {
            if (u >= 6)
              p.save_trig[prow * n_trig + u - 6] = __float2bfloat16_rn(v);
          }
        }
        X[row * ldx + c_vox + u] = __float2bfloat16_rn(v);
      }
    }
    stage_rows(p.ray_feat + ray0 * p.c_ray, valid, kRays, p.c_ray, RF, ldr, 0);
    if (threadIdx.x < kM) OFF[threadIdx.x] = p.init_offset;
    // the next tile's voxel rows land while this one runs
    if (t + gridDim.x < n_tiles) vox_rows(t + gridDim.x, x_of(parity ^ 1));

    // -- per-ray layer-1 part: RAY = RF @ ray_w1 (16 rows, 8 of them rays) --
    {
      float acc[1][8][4];
      product<1, 8, kWarps>(pipe, RF, ldr, p.crp, acc);
      for_pairs<1, 8, kWarps>(acc, [&](int r, int c, float v0, float v1) {
        if (r < kRays)
          *reinterpret_cast<float2*>(RAY + r * 2 * kG1 + c) = make_float2(v0, v1);
      });
    }
    // -- probability decoder: H = act(X @ W_prob + ray part + b1), tail ----
    {
      float acc[2][8][4];
      product<2, 8, kWN>(pipe, X, ldx, kp, acc);
      for_pairs<2, 8, kWN>(acc, [&](int r, int c, float v0, float v1) {
        const float2 ray = *reinterpret_cast<const float2*>(
            RAY + (r / kKb) * 2 * kG1 + kG1 + c);
        const float2 b = ldg2(p.b1 + kG1 + c);
        const float z0 = v0 + ray.x + b.x, z1 = v1 + ray.y + b.y;
        st_bf16x2(H + r * ld_of(kG1) + c, leaky(z0), leaky(z1));
        if constexpr (kSave) {
          if (r / kKb < valid)
            st_bf16x2(p.save_z1p + (ray0 * kKb + r) * kG1 + c, z0, z1);
        }
      });
    }
    tail(pipe, H, H2, L4, p.prob, LOGIT, /*accumulate=*/false);
    // -- offset decoder: E1 = X @ W_off + ray part + b1, kept in registers --
    float e1[2][8][4];
    product<2, 8, kWN>(pipe, X, ldx, kp, e1);
    for_pairs<2, 8, kWN>(e1, [&](int r, int c, float& v0, float& v1) {
      const float2 ray =
          *reinterpret_cast<const float2*>(RAY + (r / kKb) * 2 * kG1 + c);
      const float2 b = ldg2(p.b1 + c);
      v0 = v0 + ray.x + b.x;
      v1 = v1 + ray.y + b.y;
      if constexpr (kSave) {
        if (r / kKb < valid)
          st_bf16x2(p.save_e1 + (ray0 * kKb + r) * kG1 + c, v0, v1);
      }
    });
    ief(pipe, e1, H, H2, L4, p.a_vec, p.c_vec, p.off, OFF, p.n_iter);

    if (threadIdx.x < kM && threadIdx.x / kKb < valid) {
      const long long prow = ray0 * kKb + threadIdx.x;
      p.out_off[prow] = squash(OFF[threadIdx.x], p.use_sigmoid);
      p.out_logit[prow] = squash(LOGIT[threadIdx.x], p.use_sigmoid);
    }
  }
  pipe.drain();
}

template <bool kSave>
int launch_tc(const Params<__nv_bfloat16>& p, void* stream) {
  const tile::Smem lay(p.kp, p.crp);
  auto kernel = ray_decode_tc<kSave>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (p.n + kRays - 1) / kRays;
  const long long blocks = tiles < sms ? tiles : sms;  // one per SM
  kernel<<<(unsigned)blocks, kThreads, lay.total, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
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
    if (c_vox % 8 || kp - c_vox > 32 * kColsPerLane ||
        n_iter > (tile::kMaxSegs - 5) / 2 ||
        tile::Smem((int)kp, (int)crp).total > tile::kMaxSmem)
      return (int)cudaErrorInvalidValue;
    return launch_tc<kSave>(p, stream);
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

// Dynamic shared memory (bytes) of one block of K1/K2 at these widths
// (ops/ray_decode.py::decode_plan mirrors it).
extern "C" long long idt_ray_decode_smem(long long kp, long long crp,
                                         long long is_bf16) {
  return is_bf16 ? (long long)idt::tile::Smem((int)kp, (int)crp).total
                 : (long long)Smem<float>(32, 32 / kKb, (int)kp, (int)crp).total;
}
