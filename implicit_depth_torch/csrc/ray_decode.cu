// K1: stage-1 ray-major pair decode (IEF offset + IMNet termination logit).
// K2: the same kernel instantiated with kSave, the training forward; K2 'all'
// with kSaveAll, the training forward of decode_bwd = 'kernel_save_all'.
//
// Replaces implicit_depth_tpu/ops/pallas_ray_decode.py::fused_ray_decode
// (_fused_fwd_impl and its Pallas kernel): for every ray, its kb nearest pair
// slots (1 <= kb <= kMaxKb, as the Pallas kernel's tiles of t * kb rows take
// any kb) are decoded by two 4-layer MLPs (4g -> 2g -> g -> 1 for imnet_gf
// g in {8, 16, 32, 64, 128}: 256 -> 128 -> 64 -> 1 by default; LeakyReLU
// 0.02,
// soft clamp), the offset decoder as a 2-iteration IEF. With kSave it
// replaces fused_ray_decode_table's training forward (_table_fwd,
// save_mode='l1'): it also writes, rounded to T as the JAX kernel rounds
// them, e1 (the IEF layer-1 pre-activation before the offset term), z1p (the
// probability decoder's layer-1 pre-activation) and trig (the sin block),
// which the backward K3 (ray_decode_bwd.cu) starts from. With kSaveAll it
// replaces _table_fwd's save_mode='all' (_save_layout, _decode_rows): it also
// writes, per IEF iteration, the offset entering it (f32), h2 and h3, then
// the final offset, the probability decoder's h2 and h3, and the logit before
// the squash (f32), so that K3 recomputes no product. The outputs of K1, K2
// and K2 'all' are the same bits: the saves are stores of values K1
// computes. K2 'all' writes 1,168 bytes a pair row more than K2 in bf16; h2
// goes from its shared tile in 16-byte pieces, h3 (never in shared memory)
// from the layer-3 epilogue's registers, 4 bytes a store.
//
// What bounds it on the H100: operations. At serving shapes (76,800 rays x 8
// slots) it is ~3e11 FLOP against ~0.2 GB of operand bytes, ~0.3 ms at the
// bf16 tensor-core peak. Both instances keep every intermediate on chip:
//   * the voxel row of each pair is read by its cell id from the (B*729, Cv)
//     voxel table: the (N*kb, Cv) gathered rows are never written to memory;
//   * the positional encoding of enter/leave is computed in the kernel from the
//     raw f32 positions (sinf of pos * 2^j + phase), and layer 1 is split into a
//     per-pair part over [vox | pos6 | trig] and a per-ray part over
//     [roi | dir_e], computed once per ray and reused by its kb slots;
//   * layer 1 of the offset decoder is hoisted out of the IEF iterations and
//     its 1 -> 16 offset encoder is folded into a rank-1 update
//     (offset * a_vec + c_vec).
// bf16 (the served and trained type): ray_decode_tc, a persistent block per
// SM over tiles of 64 rows on decode_tile.cuh's staged mma.sync products. A
// tile holds the whole rays of rays_per_tile(kb) = min(64 / kb, 16): 8 at
// kb 8, all 64 rows wherever kb divides 64 from kb 4 up, fewer (the
// trailing rows masked) where it does not, and 16 rays of 1-3 rows at
// kb < 4 (the per-ray product's 16 rows cap them; the other rows idle). The
// pair rows of a tile are consecutive, ray0 * kb + row, so kb enters only
// the count of valid rows and the row -> ray map of the per-ray part. Its
// first version (decode_common.cuh's mma_tile, K6's design) spent ~60% of
// its time in products whose weight fragments came from L2 in every warp,
// ~74% in those products' f32 round trips through shared memory and their
// elementwise passes, 9% in the per-ray part on CUDA cores and 16% in
// 2-byte input loads (scripts/attribute_k1_k4.py, PERF.md). Now the
// weights are staged once per tile, E1 stays in registers, the per-ray part
// (the tile's rays padded to 16 rows) runs on the tensor cores too, each
// decoder's half of it just before that decoder's layer 1 (so that one
// 16 x 4g f32 region holds it), and the voxel rows
// of the next tile are copied (cp.async, 16 bytes) while the current one
// runs; ray features load 16 bytes at a time. Where that layout does not
// fit (imnet_gf 128, the widest layer-1 inputs: tile::Smem), the single
// layout's instance (kSingle) copies the next tile's voxel rows once the
// offset decoder's layer 1 has read X, behind a barrier; where that does
// not fit either (imnet_gf 128 at kp > 528, or kp > 432 with crp 544: the
// reference's pnet_out 512 or roi_out_bbox 4 with imnet_gf 128), the
// chunked one (kChunked) stages X in chunks of whole slabs for each
// decoder's layer 1, the accumulators carried across them in registers
// (chunked_product), the trig columns computed with the chunk they fall in.
// f32 (the card-vs-CPU cross-checks only): ray_decode_kernel, 32 rows a
// block where that block fits (imnet_gf <= 64), else 16; min(rows / kb, 4)
// whole rays or, at kb > rows, rows slots of one ray (its per-ray part
// computed by each of its blocks), CUDA-core FMA products with the weights
// read from L2.
#include "decode_tile.cuh"

namespace {

using namespace idt;

// rays of a bf16 tile (the per-ray product's rows) and of an f32 block, at
// most
constexpr int kTcRays = 16, kF32Rays = 4;

template <typename T>
struct Smem {
  // byte offsets of each region in dynamic shared memory
  size_t x, e1, c, h, ray, off, logit, total;
  __host__ __device__ static size_t al(size_t b) { return (b + 127) / 128 * 128; }
  __host__ __device__ Smem(int m, int mr, int kp, int crp, int g) {
    const int g1 = 4 * g, g23 = 3 * g;  // layer 1; layers 2 and 3
    size_t o = 0;
    x = o;      // pair layer-1 input; later H2 | H3
    o = al(o + (size_t)m * (kp > g23 ? kp : g23) * sizeof(T));
    e1 = o;     // offset layer-1 pre-activation
    o = al(o + (size_t)m * g1 * 4);
    c = o;      // product scratch; first the per-ray inputs
    o = al(o + (m * g1 > mr * crp ? (size_t)m * g1 : (size_t)mr * crp) *
                   sizeof(float));
    h = o;      // rounded layer-1 activation
    o = al(o + (size_t)m * g1 * sizeof(T));
    ray = o;    // per-ray layer-1 part
    o = al(o + (size_t)mr * 2 * g1 * 4);
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
  const T* pair_w1;       // (kp, 2 * 4g) rows [vox | pos6 | trig | 0], cols [off | prob]
  const T* ray_w1;        // (crp, 2 * 4g) rows [roi | dir | 0]
  const float* b1;        // (2 * 4g,)
  const float* a_vec;     // (4g,)
  const float* c_vec;     // (4g,)
  TailWeights<T> off, prob;
  float* out_off;         // (n, kb)
  float* out_logit;       // (n, kb)
  T* save_e1;             // kSave: (n*kb, 4g)
  T* save_z1p;            // kSave: (n*kb, 4g)
  T* save_trig;           // kSave: (n*kb, 12*multires)
  long long n;
  int kb;                 // pair slots a ray
  int rays;               // rays of a tile (bf16) or block (f32): rays_per_tile
  int c_vox, c_ray, multires, kp, crp, n_iter, use_sigmoid;
  float init_offset;
  // kSaveAll: instance i < n_iter of a save is IEF iteration i's, instance
  // n_iter the final offset's and the probability decoder's; instance i of
  // pair row r at (i * n * kb + r) * width
  float* save_off;        // (n_iter + 1, n*kb) the offset entering each iteration
  T* save_h2;             // (n_iter + 1, n*kb, 2g)
  T* save_h3;             // (n_iter + 1, n*kb, g)
  float* save_logit;      // (n*kb,) before the squash
};

// which saves an instance writes: none (K1), e1 | z1p | trig (K2), and all
// (K2 'all')
enum SaveMode { kNoSave, kSaveL1, kSaveAll };

template <typename T, int M, int kMode, int G>
__global__ void __launch_bounds__(kThreads, 1)
    ray_decode_kernel(const Params<T> p) {
  constexpr bool kSave = kMode != kNoSave;
  constexpr int MR = kF32Rays;  // rays of a block, at most
  constexpr int kG1 = Widths<G>::g1, kG2 = Widths<G>::g2, kG3 = Widths<G>::g3;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<T> lay(M, MR, p.kp, p.crp, G);
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

  // the block's rows: p.rays whole rays, or (kb > M) the M slots from slot0
  // of one ray, of which tpr blocks take its kb; row r is the pair row
  // row0 + r of ray r / spt, for r < rows_ok
  const int kb = p.kb, spt = kb < M ? kb : M, tpr = (kb + M - 1) / M;
  const long long ray0 = (long long)(blockIdx.x / tpr) * p.rays;
  const int slot0 = (int)(blockIdx.x % tpr) * spt;
  const int rays_ok = (int)min((long long)p.rays, p.n - ray0);
  const int rows_ok = (rays_ok - 1) * spt + min(spt, kb - slot0);
  const long long row0 = ray0 * kb + slot0;
  auto ray_of = [&](int row) { return min(row / spt, MR - 1); };
  const int kp = p.kp, crp = p.crp;
  const int n_trig = 12 * p.multires;

  // -- stage the per-ray inputs and the per-pair layer-1 input ----------------
  for (int i = threadIdx.x; i < MR * crp; i += blockDim.x) {
    const int r = i / crp, col = i % crp;
    RF[i] = (r < rays_ok && col < p.c_ray)
                ? ldg_raw(p.ray_feat + (ray0 + r) * p.c_ray + col)
                : from_f32<T>(0.f);
  }
  for (int i = threadIdx.x; i < M * kp; i += blockDim.x) {
    const int row = i / kp, col = i % kp;
    const long long prow = row0 + row;  // global pair row
    T v = from_f32<T>(0.f);
    if (row < rows_ok) {
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
      if (row < rows_ok && t >= 0 && t < n_trig)
        p.save_trig[prow * n_trig + t] = v;
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
    E1[i] = E1[i] + RAY[ray_of(row) * 2 * kG1 + c] + __ldg(p.b1 + c);
    if constexpr (kSave) {
      if (row < rows_ok)
        p.save_e1[(row0 + row) * kG1 + c] = from_f32<T>(E1[i]);
    }
  }
  // -- probability decoder layer 1: H = act(X @ W_prob + ray part + b1) -------
  tile_product<T, M, kG1>(X, kp, p.pair_w1 + kG1, 2 * kG1, kp, C, kG1);
  __syncthreads();
  for (int i = threadIdx.x; i < M * kG1; i += blockDim.x) {
    const int row = i / kG1, c = i % kG1;
    const float z = C[i] + RAY[ray_of(row) * 2 * kG1 + kG1 + c] +
                    __ldg(p.b1 + kG1 + c);
    H[i] = from_f32<T>(leaky(z));
    if constexpr (kSave) {
      if (row < rows_ok)
        p.save_z1p[(row0 + row) * kG1 + c] = from_f32<T>(z);
    }
  }
  __syncthreads();

  // kSaveAll: H2, H3 of the tail that just ran (instance inst), the block's
  // valid rows
  const long long rows_all = p.n * kb;
  auto save_tail = [&](int inst) {
    for (int i = threadIdx.x; i < M * kG2; i += blockDim.x) {
      const int row = i / kG2;
      if (row < rows_ok)
        p.save_h2[(inst * rows_all + row0 + row) * kG2 + i % kG2] = H2[i];
    }
    for (int i = threadIdx.x; i < M * kG3; i += blockDim.x) {
      const int row = i / kG3;
      if (row < rows_ok)
        p.save_h3[(inst * rows_all + row0 + row) * kG3 + i % kG3] = H3[i];
    }
  };

  // -- probability decoder layers 2-4 -----------------------------------------
  mlp_tail<T, M, G>(H, C, H2, H3, p.prob, LOGIT, /*accumulate=*/false);
  if constexpr (kMode == kSaveAll) save_tail(p.n_iter);
  if (threadIdx.x < M) {
    LOGIT[threadIdx.x] += __ldg(p.prob.b4);
    OFF[threadIdx.x] = p.init_offset;
  }
  __syncthreads();

  // -- offset decoder: IEF iterations over the hoisted layer 1 ----------------
  if constexpr (kMode == kSaveAll) {
    // decode_common.cuh::ief_loop, with each iteration's saves
    const float b4 = __ldg(p.off.b4);
    for (int it = 0; it < p.n_iter; ++it) {
      if ((int)threadIdx.x < rows_ok)
        p.save_off[it * rows_all + row0 + threadIdx.x] = OFF[threadIdx.x];
      for (int i = threadIdx.x; i < M * kG1; i += blockDim.x) {
        const int c = i % kG1;
        H[i] = from_f32<T>(leaky(E1[i] + OFF[i / kG1] * __ldg(p.a_vec + c) +
                                 __ldg(p.c_vec + c)));
      }
      __syncthreads();
      mlp_tail<T, M, G>(H, C, H2, H3, p.off, OFF, /*accumulate=*/true);
      save_tail(it);
      if (threadIdx.x < M) OFF[threadIdx.x] += b4;
      __syncthreads();
    }
  } else {
    ief_loop<T, M, G>(E1, H, C, H2, H3, p.a_vec, p.c_vec, p.off, OFF,
                      p.n_iter);
  }

  if ((int)threadIdx.x < rows_ok) {
    const long long prow = row0 + threadIdx.x;
    p.out_off[prow] = squash(OFF[threadIdx.x], p.use_sigmoid);
    p.out_logit[prow] = squash(LOGIT[threadIdx.x], p.use_sigmoid);
    if constexpr (kMode == kSaveAll) {
      p.save_off[p.n_iter * rows_all + prow] = OFF[threadIdx.x];
      p.save_logit[prow] = LOGIT[threadIdx.x];
    }
  }
}

// -- bf16: the staged tensor-core kernel -------------------------------------

// columns past c_vox a lane stages (kp - c_vox <= 256)
constexpr int kColsPerLane = 8;

// The per-tile product schedule: the probability decoder's per-ray part,
// layer 1 and tail, the offset decoder's per-ray part and layer 1, then its
// tail once per IEF iteration. Returns the number of segments.
template <int G>
__device__ int k1_schedule(const Params<__nv_bfloat16>& p, tile::Seg* s) {
  constexpr int kG1 = Widths<G>::g1, kG2 = Widths<G>::g2, kG3 = Widths<G>::g3;
  int n = 0;
  s[n++] = {p.ray_w1 + kG1, 2 * kG1, p.crp, kG1};
  s[n++] = {p.pair_w1 + kG1, 2 * kG1, p.kp, kG1};
  s[n++] = {p.prob.w2, kG2, kG1, kG2};
  s[n++] = {p.prob.w3, kG3, kG2, kG3};
  s[n++] = {p.ray_w1, 2 * kG1, p.crp, kG1};
  s[n++] = {p.pair_w1, 2 * kG1, p.kp, kG1};
  for (int i = 0; i < p.n_iter; ++i) {
    s[n++] = {p.off.w2, kG2, kG1, kG2};
    s[n++] = {p.off.w3, kG3, kG2, kG3};
  }
  return n;
}

template <int kMode, int G, int kLay>
__global__ void __launch_bounds__(kThreads, 1)
    ray_decode_tc(const Params<__nv_bfloat16> p) {
  using namespace tile;
  constexpr bool kSave = kMode != kNoSave;
  constexpr bool kSingle = kLay == tile::kSingle, kChunk = kLay == kChunked;
  constexpr int kG1 = Widths<G>::g1, kG2 = Widths<G>::g2, kG3 = Widths<G>::g3;
  extern __shared__ __align__(128) unsigned char smem[];
  const tile::Smem lay(p.kp, p.crp, G, kLay);
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
  const int kb = p.kb, rays = p.rays;
  // the tile's ray of row r < 64: (r * kb_inv) >> 12 is r / kb exactly
  // while r * (kb_inv * kb - 4096) < 4096, true for r < 64, kb <= 64; rows
  // past the tile's rays (kb < 4) read the last row of RAY and are never
  // stored
  const unsigned kb_inv = (4096u + kb - 1) / kb;
  auto ray_of = [&](int r) {
    return min((int)(((unsigned)r * kb_inv) >> 12), kTcRays - 1);
  };
  const long long n_tiles = (p.n + rays - 1) / rays;
  if (threadIdx.x == 0) k1_schedule<G>(p, segs);
  // the per-ray rows past the tile's rays, and the columns past c_ray, stay
  // 0
  for (int i = threadIdx.x; i < kTcRays * ldr; i += blockDim.x)
    RF[i] = __float2bfloat16_rn(0.f);
  __syncthreads();
  Pipe pipe;
  pipe.init(reinterpret_cast<bf16*>(smem + lay.ring), segs,
            6 + 2 * p.n_iter);
  // the voxel row of each pair of a tile into X, by its cell id
  auto vox_rows = [&](long long t, bf16* X) {
    const long long row0 = t * rays * kb;  // the tile's first pair row
    const long long rows = min((long long)rays, p.n - t * rays) * kb;
    rows_async(
        [&](int r) -> const bf16* {
          if (r >= rows) return nullptr;
          return p.vox_table + (long long)__ldg(p.cells + row0 + r) * c_vox;
        },
        kM, c_vox, X, ldx, p.vox_table);
  };
  if (!kChunk && blockIdx.x < n_tiles) vox_rows(blockIdx.x, x_of(0));
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
    const long long ray0 = t * rays, row0 = ray0 * kb;
    const int valid = (int)min((long long)rays, p.n - ray0);
    const int valid_rows = valid * kb;  // rows past them are masked

    // -- stage [pos6 | trig | 0] of the pairs and the rays' features --------
    // a warp a row, its lanes over the columns (what each holds: col_src);
    // the chunked layout stages them with each chunk (chunk_of below)
    if (!kChunk)
    for (int row = warp; row < kM; row += kWarps) {
      const long long prow = row0 + row;
      const bool ok = row < valid_rows;
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
    stage_rows(p.ray_feat + ray0 * p.c_ray, valid, rays, p.c_ray, RF, ldr, 0);
    if (threadIdx.x < kM) OFF[threadIdx.x] = p.init_offset;
    // the next tile's voxel rows land while this one runs
    if (kLay == kDouble && t + gridDim.x < n_tiles)
      vox_rows(t + gridDim.x, x_of(parity ^ 1));

    // -- the chunked layout: columns [k0, k0 + kn) of X into its chunk
    // buffer, the voxel rows by cp.async, [pos6 | trig | 0] a warp a row as
    // above (K2's trig saves with the probability decoder's chunks)
    [[maybe_unused]] auto chunk_of = [&](int k0, int kn, bool save) {
      const int k1 = k0 + kn, ldc = ld_of(lay.chunk);
      if (k0 < c_vox)
        rows_async(
            [&](int r) -> const bf16* {
              if (r >= valid_rows) return nullptr;
              return p.vox_table +
                     (long long)__ldg(p.cells + row0 + r) * c_vox + k0;
            },
            kM, min(k1, c_vox) - k0, X, ldc, p.vox_table);
      if (k1 <= c_vox) return;
      for (int r = warp; r < kM; r += kWarps) {
        const long long prow = row0 + r;
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) {
          const int u = lane + 32 * j, col = c_vox + u;
          if (u >= kp - c_vox || col >= k1) break;
          if (col < k0) continue;
          float v = 0.f;
          if (r < valid_rows && col_src[j] >= 0) {
            const float x = __ldg(p.pos + prow * 6 + col_src[j]);
            v = u < 6 ? x : sinf(x * col_scale[j] + col_phase[j]);
            if constexpr (kSave) {
              if (save && u >= 6)
                p.save_trig[prow * n_trig + u - 6] = __float2bfloat16_rn(v);
            }
          }
          X[r * ldc + col - k0] = __float2bfloat16_rn(v);
        }
      }
    };
    // -- a decoder's per-ray layer-1 part: RAY = RF @ ray_w1[:, its half] --
    // (16 rows, the tile's rays among them)
    auto ray_part = [&]() {
      float acc[Grid<16, kG1>::MT][Grid<16, kG1>::NT][4];
      product<16, kG1>(pipe, RF, ldr, p.crp, acc);
      for_pairs<16, kG1>(acc, [&](int r, int c, float v0, float v1) {
        *reinterpret_cast<float2*>(RAY + r * kG1 + c) = make_float2(v0, v1);
      });
    };
    // -- probability decoder: H = act(X @ W_prob + ray part + b1), tail ----
    ray_part();
    {
      E1Acc<G> acc;
      if constexpr (kChunk)
        chunked_product<kG1>(pipe, X, lay.chunk, kp, acc,
                             [&](int k0, int kn) { chunk_of(k0, kn, true); });
      else
        product<kM, kG1>(pipe, X, ldx, kp, acc);
      for_pairs<kM, kG1>(acc, [&](int r, int c, float v0, float v1) {
        const float2 ray =
            *reinterpret_cast<const float2*>(RAY + ray_of(r) * kG1 + c);
        const float2 b = ldg2(p.b1 + kG1 + c);
        const float z0 = v0 + ray.x + b.x, z1 = v1 + ray.y + b.y;
        st_bf16x2(H + r * ld_of(kG1) + c, leaky(z0), leaky(z1));
        if constexpr (kSave) {
          if (r < valid_rows)
            st_bf16x2(p.save_z1p + (row0 + r) * kG1 + c, z0, z1);
        }
      });
    }
    // K2 'all': instance n_iter of each save is the probability decoder's
    [[maybe_unused]] const long long rows_all = p.n * kb;
    if constexpr (kMode == kSaveAll)
      tail<G, true>(pipe, H, H2, L4, p.prob, LOGIT, /*accumulate=*/false,
                 p.save_h2 + (p.n_iter * rows_all + row0) * kG2,
                 p.save_h3 + (p.n_iter * rows_all + row0) * kG3, valid_rows);
    else
      tail<G>(pipe, H, H2, L4, p.prob, LOGIT, /*accumulate=*/false);
    // -- offset decoder: E1 = X @ W_off + ray part + b1, kept in registers --
    // (every warp is past the probability epilogue's reads of RAY: the
    // tail's products acquired their slabs since)
    ray_part();
    E1Acc<G> e1;
    if constexpr (kChunk)
      chunked_product<kG1>(pipe, X, lay.chunk, kp, e1,
                           [&](int k0, int kn) { chunk_of(k0, kn, false); });
    else
      product<kM, kG1>(pipe, X, ldx, kp, e1);
    if constexpr (kSingle) {  // X is read: the next tile's voxel rows
      __syncthreads();
      if (t + gridDim.x < n_tiles) vox_rows(t + gridDim.x, X);
    }
    for_pairs<kM, kG1>(e1, [&](int r, int c, float& v0, float& v1) {
      const float2 ray =
          *reinterpret_cast<const float2*>(RAY + ray_of(r) * kG1 + c);
      const float2 b = ldg2(p.b1 + c);
      v0 = v0 + ray.x + b.x;
      v1 = v1 + ray.y + b.y;
      if constexpr (kSave) {
        if (r < valid_rows)
          st_bf16x2(p.save_e1 + (row0 + r) * kG1 + c, v0, v1);
      }
    });
    if constexpr (kMode == kSaveAll)
      ief<G, true>(pipe, e1, H, H2, L4, p.a_vec, p.c_vec, p.off, OFF, p.n_iter,
                p.save_off + row0, p.save_h2 + row0 * kG2,
                p.save_h3 + row0 * kG3, rows_all, valid_rows);
    else
      ief<G>(pipe, e1, H, H2, L4, p.a_vec, p.c_vec, p.off, OFF, p.n_iter);

    if ((int)threadIdx.x < valid_rows) {
      const long long prow = row0 + threadIdx.x;
      p.out_off[prow] = squash(OFF[threadIdx.x], p.use_sigmoid);
      p.out_logit[prow] = squash(LOGIT[threadIdx.x], p.use_sigmoid);
      if constexpr (kMode == kSaveAll) {  // both written by this thread
        p.save_off[p.n_iter * rows_all + prow] = OFF[threadIdx.x];
        p.save_logit[prow] = LOGIT[threadIdx.x];
      }
    }
  }
  pipe.drain();
}

template <int kMode, int G, int kLay>
int launch_tc(const Params<__nv_bfloat16>& p, void* stream) {
  const tile::Smem lay(p.kp, p.crp, G, kLay);
  auto kernel = ray_decode_tc<kMode, G, kLay>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (p.n + p.rays - 1) / p.rays;
  const long long blocks = tiles < sms ? tiles : sms;  // one per SM
  kernel<<<(unsigned)blocks, kThreads, lay.total, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// rows of an f32 block: 32 where that block fits, else 16
int f32_rows(int kp, int crp, int g) {
  return Smem<float>(32, kF32Rays, kp, crp, g).total <= tile::kMaxSmem ? 32
                                                                      : 16;
}

template <typename T, int M, int kMode, int G>
int launch(const Params<T>& p, void* stream) {
  const Smem<T> lay(M, kF32Rays, p.kp, p.crp, G);
  auto kernel = ray_decode_kernel<T, M, kMode, G>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  // a block's rays, or the blocks of one ray's slots (kb > M)
  const long long blocks = (p.n + p.rays - 1) / p.rays * ((p.kb + M - 1) / M);
  kernel<<<(unsigned)blocks, kThreads, lay.total, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int kMode>
int run(void* const* ptrs, long long n, long long kb, long long c_vox,
        long long c_ray, long long multires, long long kp, long long crp,
        long long n_iter, long long g, long long use_sigmoid,
        float init_offset, void* stream) {
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
  constexpr bool kSave = kMode != kNoSave, kAll = kMode == kSaveAll;
  p.save_e1 = kSave ? (T*)ptrs[23] : nullptr;
  p.save_z1p = kSave ? (T*)ptrs[24] : nullptr;
  p.save_trig = kSave ? (T*)ptrs[25] : nullptr;
  p.save_off = kAll ? (float*)ptrs[26] : nullptr;
  p.save_h2 = kAll ? (T*)ptrs[27] : nullptr;
  p.save_h3 = kAll ? (T*)ptrs[28] : nullptr;
  p.save_logit = kAll ? (float*)ptrs[29] : nullptr;
  p.n = n;
  p.kb = (int)kb;
  p.c_vox = (int)c_vox;
  p.c_ray = (int)c_ray;
  p.multires = (int)multires;
  p.kp = (int)kp;
  p.crp = (int)crp;
  p.n_iter = (int)n_iter;
  p.use_sigmoid = (int)use_sigmoid;
  p.init_offset = init_offset;
  if (kp % 16 || crp % 16 || kp < c_vox + 6 + 12 * multires || crp < c_ray ||
      kb < 1 || kb > kMaxKb)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  return with_width(g, [&](auto w) {
    constexpr int G = decltype(w)::value;
    if constexpr (sizeof(T) == 2) {
      p.rays = rays_per_tile((int)kb, tile::kM, kTcRays);
      const tile::Smem lay((int)kp, (int)crp, G);
      if (c_vox % 8 || kp - c_vox > 32 * kColsPerLane ||
          n_iter > (tile::kMaxSegs - 6) / 2 || lay.total > tile::kMaxSmem)
        return (int)cudaErrorInvalidValue;
      if (lay.layout() == tile::kDouble)
        return launch_tc<kMode, G, tile::kDouble>(p, stream);
      if (lay.layout() == tile::kSingle)
        return launch_tc<kMode, G, tile::kSingle>(p, stream);
      // at imnet_gf <= 64 the single layout holds every width the
      // wrappers take (kp 640, crp 1056)
      if constexpr (G == 128)
        return launch_tc<kMode, G, tile::kChunked>(p, stream);
      return (int)cudaErrorInvalidValue;
    } else {
      const int m = f32_rows((int)kp, (int)crp, G);
      p.rays = rays_per_tile((int)kb, m, kF32Rays);
      if (m == 32) return launch<T, 32, kMode, G>(p, stream);
      // 16 rows: imnet_gf 128 (32 do not fit at any width; at <= 64 they
      // fit every width the wrappers take)
      if constexpr (G == 128) {
        if (Smem<T>(16, kF32Rays, (int)kp, (int)crp, G).total <=
            tile::kMaxSmem)
          return launch<T, 16, kMode, G>(p, stream);
      }
      return (int)cudaErrorInvalidValue;
    }
  });
}

// run<T, kMode> for T bf16 or f32
template <int kMode>
int run_any(void* const* ptrs, long long n, long long kb, long long c_vox,
            long long c_ray, long long multires, long long kp, long long crp,
            long long n_iter, long long g, long long is_bf16,
            long long use_sigmoid, float init_offset, void* stream) {
  return is_bf16 ? run<__nv_bfloat16, kMode>(ptrs, n, kb, c_vox, c_ray,
                                             multires, kp, crp, n_iter, g,
                                             use_sigmoid, init_offset, stream)
                 : run<float, kMode>(ptrs, n, kb, c_vox, c_ray, multires, kp,
                                     crp, n_iter, g, use_sigmoid, init_offset,
                                     stream);
}

}  // namespace

// ptrs: vox_table, cells, pos, ray_feat, pair_w1, ray_w1, b1, a_vec, c_vec,
// off_{w2,b2,w3,b3,w4,b4}, prob_{w2,b2,w3,b3,w4,b4}, out_off, out_logit
// (23 device pointers); n rays of kb pair slots, 1 <= kb <= kMaxKb. g:
// imnet_gf, in {8, 16, 32, 64, 128}. Returns a cudaError_t.
extern "C" int idt_ray_decode(void* const* ptrs, long long n, long long kb,
                              long long c_vox, long long c_ray,
                              long long multires, long long kp, long long crp,
                              long long n_iter, long long g, long long is_bf16,
                              long long use_sigmoid, float init_offset,
                              void* stream) {
  return run_any<kNoSave>(ptrs, n, kb, c_vox, c_ray, multires, kp, crp,
                          n_iter, g, is_bf16, use_sigmoid, init_offset,
                          stream);
}

// K2: the pointers of idt_ray_decode, then save_e1, save_z1p, save_trig
// (26 device pointers). Returns a cudaError_t.
extern "C" int idt_ray_decode_save(void* const* ptrs, long long n,
                                   long long kb, long long c_vox,
                                   long long c_ray, long long multires,
                                   long long kp, long long crp,
                                   long long n_iter, long long g,
                                   long long is_bf16, long long use_sigmoid,
                                   float init_offset, void* stream) {
  return run_any<kSaveL1>(ptrs, n, kb, c_vox, c_ray, multires, kp, crp,
                          n_iter, g, is_bf16, use_sigmoid, init_offset,
                          stream);
}

// K2 'all': the pointers of idt_ray_decode_save, then save_off (n_iter + 1,
// n*kb) f32, save_h2 (n_iter + 1, n*kb, 2g), save_h3 (n_iter + 1, n*kb, g),
// save_logit (n*kb,) f32 (30 device pointers). Returns a cudaError_t.
extern "C" int idt_ray_decode_save_all(void* const* ptrs, long long n,
                                       long long kb, long long c_vox,
                                       long long c_ray, long long multires,
                                       long long kp, long long crp,
                                       long long n_iter, long long g,
                                       long long is_bf16,
                                       long long use_sigmoid,
                                       float init_offset, void* stream) {
  return run_any<kSaveAll>(ptrs, n, kb, c_vox, c_ray, multires, kp, crp,
                           n_iter, g, is_bf16, use_sigmoid, init_offset,
                           stream);
}

// Dynamic shared memory (bytes) of one block of K1/K2 at these widths
// (ops/ray_decode.py::decode_plan mirrors it).
extern "C" long long idt_ray_decode_smem(long long kp, long long crp,
                                         long long g, long long is_bf16) {
  return is_bf16 ? (long long)idt::tile::Smem((int)kp, (int)crp, (int)g).total
                 : (long long)Smem<float>(f32_rows((int)kp, (int)crp, (int)g),
                                          kF32Rays, (int)kp, (int)crp, (int)g)
                       .total;
}

// ... of K2 'all' (its saves take no shared memory of their own: K1's
// layout; decode_plan "K2all").
extern "C" long long idt_ray_decode_save_all_smem(long long kp, long long crp,
                                                  long long g,
                                                  long long is_bf16) {
  return idt_ray_decode_smem(kp, crp, g, is_bf16);
}
