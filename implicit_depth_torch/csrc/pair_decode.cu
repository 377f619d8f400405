// K6: per-pair decode of the stage-1 `global` and dense modes (IEF offset +
// IMNet termination logit of each compacted ray/voxel pair row).
//
// Replaces implicit_depth_tpu/ops/pallas_decode.py::fused_pair_decode (its
// Pallas kernel over _decode_tile). Each row's 385-d embedding
// [voxel row | roi | pe(enter) | pe(leave) | dir_e] is decoded by two
// 4-layer MLPs (4g -> 2g -> g -> 1 for imnet_gf g in {8, 16, 32, 64, 128};
// 256 -> 128 -> 64 -> 1 by default; LeakyReLU 0.02, soft clamp), the offset
// decoder as a 2-iteration IEF.
//
// What bounds it on the H100: operations. One row costs ~0.64 MFLOP (layer 1
// of both decoders over the embedding, two IEF tails and the probability
// tail); at the served frame's 614,400 (`global`, budget 8) or 1,536,000
// (dense, K = 20) rows that is ~0.4 or ~1.0 ms at the bf16 tensor-core peak,
// against ~0.02 ms for the bytes it must read. Its design keeps every
// intermediate on chip:
//   * a row names its voxel row by cell in the (B*729, Cv) voxel table and its
//     ray by index in the per-ray [roi | dir_e | 0] rows (in the dense layout
//     the row index gives the ray), and the kernel reads both by index: the
//     gathered embedding and the per-ray broadcast are never written to
//     memory;
//   * the positional encoding is computed in the kernel from the raw f32
//     positions (sin, cos of x * 2^j);
//   * layer 1 of the offset decoder is computed once and its 1 -> 16 offset
//     encoder folded into a rank-1 update (offset * a_vec + c_vec);
//   * only the rows below the count n_rows (a device scalar: the `global`
//     mode's valid prefix) are decoded; the rest are written as 0, with no
//     host sync to size the launch.
// The layer-1 input X of a row is laid out [vox (c_vox) | ray row (c_rp:
// roi | dir_e | 0) | pe(enter) | pe(leave) | 0 to kp], every part at a
// 16-byte boundary, and w1's rows are reordered to match on the host
// (ops/pair_decode.py::pair_layout): a reordering of layer 1's f32 sum.
//
// bf16 (the served type): pair_decode_tc, a persistent block per SM over
// tiles of 64 rows on decode_tile.cuh's staged mma.sync products, as K1 and
// K4. Its first version (a wmma routine since removed from decode_common.cuh)
// read every weight fragment from L2 in each warp that needed it, stored every
// product's f32 accumulators to shared memory for an elementwise pass, kept
// E1 in shared memory, ran one non-persistent block per 64 rows, built the
// embedding one element a thread with 2-byte loads, and decoded the pad rows
// of the `global` mode: ~37x its bound. Now the voxel and ray rows of the
// next tile land by cp.async while the current one computes (kSingle, the
// layout of the wide inputs and imnet_gf 128, tile::Smem: once the offset
// decoder's layer 1 has read X, behind a barrier; kChunked, the layout of
// the widest, rows of the reference's pnet_out 512 or roi_out_bbox 4: X
// staged in chunks of whole slabs for each decoder's layer 1,
// chunked_product), the weights
// stream through the slab ring once per tile, the epilogues run on the
// registers, E1 stays in registers for both IEF iterations, and the
// positional encoding is staged a warp a row, each lane over fixed columns.
// f32 (the card-vs-CPU cross-checks only): pair_decode_f32, 32 rows a block
// where that block fits, else 16 (imnet_gf 128, or rows wider than ~1,000 at
// any width), CUDA-core FMA products with the weights read from L2.
//
// Numerics follow _decode_tile: every product takes compute-type operands
// with f32 accumulation; the embedding (raw positions included) is rounded
// to the compute type; the probability decoder's biases 1-3 add in f32
// unrounded (the caller passes them so), the IEF's biases 2 and 3 rounded;
// cos is computed directly (not as sin(x + pi/2), which K1 uses).
#include "decode_tile.cuh"

namespace {

using namespace idt;

template <typename T>
struct Params {
  const T* vox_table;      // (S, c_vox)
  const int32_t* cells;    // (p,) row ids into vox_table
  const int32_t* rays;     // (p,) row ids into ray_feat; null: row / slots
  const float* pos;        // (p, 6) f32 [enter xyz | leave xyz]
  const T* ray_feat;       // (n, c_rp) [roi | dir_e | 0]
  const T* w1;             // (kp, 2 * 4g) rows in X's layout, cols [off | prob]
  const float* b1;         // (2 * 4g,) [off_b1 | prob_b1]
  const float* a_vec;      // (4g,)
  const float* c_vec;      // (4g,)
  TailWeights<T> off, prob;
  const int32_t* n_rows;   // 0-d: rows at or past it are 0; null: none
  float* out_off;          // (p,)
  float* out_logit;        // (p,)
  long long p;
  int c_vox, c_rp, multires, kp, slots, n_iter, use_sigmoid;
  float init_offset;
};

// The rows to decode: min(p, max(n_rows, 0)), or p without a count.
template <typename T>
__device__ __forceinline__ long long rows_to_decode(const Params<T>& p) {
  if (!p.n_rows) return p.p;
  const long long n = __ldg(p.n_rows);
  return n < 0 ? 0 : (n < p.p ? n : p.p);
}

// Exact zeros in both outputs for rows [n, p), over the whole grid.
template <typename T>
__device__ __forceinline__ void zero_rows(const Params<T>& p, long long n) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = n + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < p.p; i += step) {
    p.out_off[i] = 0.f;
    p.out_logit[i] = 0.f;
  }
}

// Column u of a pair's [pe(enter) | pe(leave)] block, from its positions
// pos6: per position [x (3) | per frequency j: sin(x 2^j) (3) | cos (3)].
// src: the element of pos6 it reads (-1 past the block); kind: 0 x, 1 sin,
// 2 cos; scale: 2^j.
struct PeCol {
  int src, kind;
  float scale;
};
__device__ __forceinline__ PeCol pe_col(int u, int multires) {
  const int c_pe = 3 * (1 + 2 * multires);
  PeCol c{-1, 0, 1.f};
  if (u >= 2 * c_pe) return c;
  const int which = u / c_pe, t = u % c_pe;
  if (t < 3) {
    c.src = which * 3 + t;
  } else {
    const int v = t - 3;
    c.src = which * 3 + v % 3;
    c.kind = 1 + (v % 6) / 3;
    c.scale = (float)(1 << (v / 6));
  }
  return c;
}
__device__ __forceinline__ float pe_value(const float* pos6, int src,
                                          int kind, float scale) {
  const float x = __ldg(pos6 + src);
  if (kind == 0) return x;
  float s, c;
  sincosf(x * scale, &s, &c);
  return kind == 2 ? c : s;
}

// -- f32: the FMA kernel (cross-checks) --------------------------------------

struct SmemF32 {
  size_t x, e1, c, h, off, logit, total;
  __host__ __device__ static size_t al(size_t b) { return (b + 127) / 128 * 128; }
  __host__ __device__ SmemF32(int m, int kp, int g) {
    const int g1 = 4 * g, g23 = 3 * g;
    size_t o = 0;
    x = o;      // the embedding; later H2 | H3
    o = al(o + (size_t)m * (kp > g23 ? kp : g23) * 4);
    e1 = o;     // offset layer-1 pre-activation
    o = al(o + (size_t)m * g1 * 4);
    c = o;      // product scratch
    o = al(o + (size_t)m * g1 * 4);
    h = o;      // layer-1 activation
    o = al(o + (size_t)m * g1 * 4);
    off = o;
    o = al(o + (size_t)m * 4);
    logit = o;
    o = al(o + (size_t)m * 4);
    total = o;
  }
};

// rows of an f32 block: 32 where that block fits, else 16
int f32_rows(int kp, int g) {
  return SmemF32(32, kp, g).total <= tile::kMaxSmem ? 32 : 16;
}

template <int M, int G>
__global__ void __launch_bounds__(kThreads, 1)
    pair_decode_f32(const Params<float> p) {
  constexpr int kG1 = Widths<G>::g1, kG2 = Widths<G>::g2;
  const long long n = rows_to_decode(p);
  zero_rows(p, n);
  const long long row0 = (long long)blockIdx.x * M;
  if (row0 >= n) return;
  extern __shared__ __align__(128) unsigned char smem[];
  const SmemF32 lay(M, p.kp, G);
  float* X = reinterpret_cast<float*>(smem + lay.x);
  float* E1 = reinterpret_cast<float*>(smem + lay.e1);
  float* C = reinterpret_cast<float*>(smem + lay.c);
  float* H = reinterpret_cast<float*>(smem + lay.h);
  float* OFF = reinterpret_cast<float*>(smem + lay.off);
  float* LOGIT = reinterpret_cast<float*>(smem + lay.logit);
  float* H2 = X;  // X is dead after layer 1
  float* H3 = X + M * kG2;

  const int kp = p.kp, o_pe = p.c_vox + p.c_rp;
  // -- the embedding, one row per pair (X's layout) ---------------------------
  for (int i = threadIdx.x; i < M * kp; i += blockDim.x) {
    const int row = i / kp, col = i % kp;
    const long long prow = row0 + row;
    float v = 0.f;
    if (prow < n) {
      if (col < p.c_vox) {
        v = __ldg(p.vox_table + (long long)__ldg(p.cells + prow) * p.c_vox + col);
      } else if (col < o_pe) {
        const long long ray = p.rays ? (long long)__ldg(p.rays + prow)
                                     : prow / p.slots;
        v = __ldg(p.ray_feat + ray * p.c_rp + col - p.c_vox);
      } else {
        const PeCol c = pe_col(col - o_pe, p.multires);
        if (c.src >= 0) v = pe_value(p.pos + prow * 6, c.src, c.kind, c.scale);
      }
    }
    X[i] = v;
  }
  __syncthreads();

  // -- offset decoder layer 1, once: E1 = X @ W1_off + off_b1 ----------------
  tile_product<float, M, kG1>(X, kp, p.w1, 2 * kG1, kp, E1, kG1);
  __syncthreads();
  for (int i = threadIdx.x; i < M * kG1; i += blockDim.x)
    E1[i] += __ldg(p.b1 + i % kG1);
  // -- probability decoder layer 1: H = act(X @ W1_prob + prob_b1) -----------
  tile_product<float, M, kG1>(X, kp, p.w1 + kG1, 2 * kG1, kp, C, kG1);
  __syncthreads();
  for (int i = threadIdx.x; i < M * kG1; i += blockDim.x)
    H[i] = leaky(C[i] + __ldg(p.b1 + kG1 + i % kG1));
  __syncthreads();

  // -- probability decoder layers 2-4 -----------------------------------------
  mlp_tail<float, M, G>(H, C, H2, H3, p.prob, LOGIT, /*accumulate=*/false);
  if (threadIdx.x < M) {
    LOGIT[threadIdx.x] += __ldg(p.prob.b4);
    OFF[threadIdx.x] = p.init_offset;
  }
  __syncthreads();

  // -- offset decoder: IEF iterations over the hoisted layer 1 ----------------
  ief_loop<float, M, G>(E1, H, C, H2, H3, p.a_vec, p.c_vec, p.off, OFF,
                        p.n_iter);

  if (threadIdx.x < M) {
    const long long prow = row0 + threadIdx.x;
    if (prow < n) {
      p.out_off[prow] = squash(OFF[threadIdx.x], p.use_sigmoid);
      p.out_logit[prow] = squash(LOGIT[threadIdx.x], p.use_sigmoid);
    }
  }
}

// -- bf16: the staged tensor-core kernel -------------------------------------

// columns past o_pe (the positional encoding and the padding) each lane
// stages in every row: kp - o_pe <= 32 * kPeCols
constexpr int kPeCols = 5;

// The per-tile product schedule: the probability decoder's layer 1 and
// tail, the offset decoder's layer 1, then its tail once per IEF iteration.
// Returns the number of segments.
template <int G>
__device__ int k6_schedule(const Params<__nv_bfloat16>& p, tile::Seg* s) {
  constexpr int kG1 = Widths<G>::g1, kG2 = Widths<G>::g2, kG3 = Widths<G>::g3;
  int n = 0;
  s[n++] = {p.w1 + kG1, 2 * kG1, p.kp, kG1};
  s[n++] = {p.prob.w2, kG2, kG1, kG2};
  s[n++] = {p.prob.w3, kG3, kG2, kG3};
  s[n++] = {p.w1, 2 * kG1, p.kp, kG1};
  for (int i = 0; i < p.n_iter; ++i) {
    s[n++] = {p.off.w2, kG2, kG1, kG2};
    s[n++] = {p.off.w3, kG3, kG2, kG3};
  }
  return n;
}

template <int G, int kLay>
__global__ void __launch_bounds__(kThreads, 1)
    pair_decode_tc(const Params<__nv_bfloat16> p) {
  using namespace tile;
  constexpr bool kSingle = kLay == tile::kSingle, kChunk = kLay == kChunked;
  constexpr int kG1 = Widths<G>::g1;
  const long long n = rows_to_decode(p);
  zero_rows(p, n);
  const long long n_tiles = (n + kM - 1) / kM;
  if (blockIdx.x >= n_tiles) return;
  extern __shared__ __align__(128) unsigned char smem[];
  const tile::Smem lay(p.kp, 0, G, kLay);
  // X of the even and of the odd tiles (by the block's tile count)
  auto x_of = [&](int parity) {
    return reinterpret_cast<bf16*>(smem + (parity ? lay.x1 : lay.x0));
  };
  bf16* H = reinterpret_cast<bf16*>(smem + lay.h);
  bf16* H2 = reinterpret_cast<bf16*>(smem + lay.h2);
  float* OFF = reinterpret_cast<float*>(smem + lay.off);
  float* LOGIT = reinterpret_cast<float*>(smem + lay.logit);
  float* L4 = reinterpret_cast<float*>(smem + lay.l4);
  Seg* segs = reinterpret_cast<Seg*>(smem + lay.segs);

  const int kp = p.kp, ldx = ld_of(kp), o_pe = p.c_vox + p.c_rp;
  if (threadIdx.x == 0) k6_schedule<G>(p, segs);
  __syncthreads();
  Pipe pipe;
  pipe.init(reinterpret_cast<bf16*>(smem + lay.ring), segs, 4 + 2 * p.n_iter);
  // the voxel row and the ray row of each pair of a tile into X, by index
  auto gather = [&](long long t, bf16* X) {
    const long long row0 = t * kM;
    rows_async(
        [&](int r) -> const bf16* {
          const long long row = row0 + r;
          if (row >= n) return nullptr;
          return p.vox_table + (long long)__ldg(p.cells + row) * p.c_vox;
        },
        kM, p.c_vox, X, ldx, p.vox_table);
    rows_async(
        [&](int r) -> const bf16* {
          const long long row = row0 + r;
          if (row >= n) return nullptr;
          const long long ray =
              p.rays ? (long long)__ldg(p.rays + row) : row / p.slots;
          return p.ray_feat + ray * p.c_rp;
        },
        kM, p.c_rp, X + p.c_vox, ldx, p.ray_feat);
  };
  if (!kChunk) gather(blockIdx.x, x_of(0));
  pipe.start();
  // the columns o_pe + lane + 32 j of [pe(enter) | pe(leave) | 0] each lane
  // stages in every row: the element of pos6 it reads (-1: padding) plus 8
  // times its kind, and its frequency
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int col_src[kPeCols];
  float col_scale[kPeCols];
#pragma unroll
  for (int j = 0; j < kPeCols; ++j) {
    const PeCol c = pe_col(lane + 32 * j, p.multires);
    col_src[j] = c.src < 0 ? -1 : c.src + 8 * c.kind;
    col_scale[j] = c.scale;
  }

  int parity = 0;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x, parity ^= 1) {
    bf16* X = x_of(parity);
    const long long row0 = t * kM;
    const int valid = (int)min((long long)kM, n - row0);

    // -- the positional encoding of the pairs: a warp a row, its lanes over
    // the columns (what each holds: col_src); the chunked layout stages it
    // with each chunk (chunk_of below)
    if (!kChunk)
    for (int row = warp; row < kM; row += kWarps) {
      const float* pos6 = p.pos + (row0 + row) * 6;
#pragma unroll
      for (int j = 0; j < kPeCols; ++j) {
        const int u = lane + 32 * j;  // column o_pe + u
        if (u >= kp - o_pe) break;
        float v = 0.f;
        if (row < valid && col_src[j] >= 0)
          v = pe_value(pos6, col_src[j] & 7, col_src[j] >> 3, col_scale[j]);
        X[row * ldx + o_pe + u] = __float2bfloat16_rn(v);
      }
    }
    if (threadIdx.x < kM) OFF[threadIdx.x] = p.init_offset;
    // the next tile's voxel and ray rows land while this one runs
    if (kLay == kDouble && t + gridDim.x < n_tiles)
      gather(t + gridDim.x, x_of(parity ^ 1));
    // -- the chunked layout: columns [k0, k0 + kn) of X into its chunk
    // buffer, the voxel and ray rows by cp.async (every part starts at a
    // 16-byte boundary), the positional encoding a warp a row as above
    [[maybe_unused]] auto chunk_of = [&](int k0, int kn) {
      const int k1 = k0 + kn, ldc = ld_of(lay.chunk);
      if (k0 < p.c_vox)
        rows_async(
            [&](int r) -> const bf16* {
              if (r >= valid) return nullptr;
              return p.vox_table +
                     (long long)__ldg(p.cells + row0 + r) * p.c_vox + k0;
            },
            kM, min(k1, p.c_vox) - k0, X, ldc, p.vox_table);
      const int a = max(k0, p.c_vox), b = min(k1, o_pe);
      if (a < b)
        rows_async(
            [&](int r) -> const bf16* {
              if (r >= valid) return nullptr;
              const long long row = row0 + r;
              const long long ray =
                  p.rays ? (long long)__ldg(p.rays + row) : row / p.slots;
              return p.ray_feat + ray * p.c_rp + (a - p.c_vox);
            },
            kM, b - a, X + (a - k0), ldc, p.ray_feat);
      if (k1 <= o_pe) return;
      for (int r = warp; r < kM; r += kWarps) {
        const float* pos6 = p.pos + (row0 + r) * 6;
#pragma unroll
        for (int j = 0; j < kPeCols; ++j) {
          const int u = lane + 32 * j, col = o_pe + u;
          if (u >= kp - o_pe || col >= k1) break;
          if (col < k0) continue;
          float v = 0.f;
          if (r < valid && col_src[j] >= 0)
            v = pe_value(pos6, col_src[j] & 7, col_src[j] >> 3, col_scale[j]);
          X[r * ldc + col - k0] = __float2bfloat16_rn(v);
        }
      }
    };

    // -- probability decoder: H = act(X @ W_prob + b1), tail -----------------
    {
      E1Acc<G> acc;
      if constexpr (kChunk)
        chunked_product<kG1>(pipe, X, lay.chunk, kp, acc, chunk_of);
      else
        product<kM, kG1>(pipe, X, ldx, kp, acc);
      for_pairs<kM, kG1>(acc, [&](int r, int c, float v0, float v1) {
        const float2 b = ldg2(p.b1 + kG1 + c);
        st_bf16x2(H + r * ld_of(kG1) + c, leaky(v0 + b.x), leaky(v1 + b.y));
      });
    }
    tail<G>(pipe, H, H2, L4, p.prob, LOGIT, /*accumulate=*/false);
    // -- offset decoder: E1 = X @ W_off + b1, kept in registers --------------
    E1Acc<G> e1;
    if constexpr (kChunk)
      chunked_product<kG1>(pipe, X, lay.chunk, kp, e1, chunk_of);
    else
      product<kM, kG1>(pipe, X, ldx, kp, e1);
    if constexpr (kSingle) {  // X is read: the next tile's rows
      __syncthreads();
      if (t + gridDim.x < n_tiles) gather(t + gridDim.x, X);
    }
    for_pairs<kM, kG1>(e1, [&](int, int c, float& v0, float& v1) {
      const float2 b = ldg2(p.b1 + c);
      v0 += b.x;
      v1 += b.y;
    });
    ief<G>(pipe, e1, H, H2, L4, p.a_vec, p.c_vec, p.off, OFF, p.n_iter);

    if ((int)threadIdx.x < valid) {
      p.out_off[row0 + threadIdx.x] = squash(OFF[threadIdx.x], p.use_sigmoid);
      p.out_logit[row0 + threadIdx.x] =
          squash(LOGIT[threadIdx.x], p.use_sigmoid);
    }
  }
  pipe.drain();
}

template <int G, int kLay>
int launch_tc(const Params<__nv_bfloat16>& p, void* stream) {
  const tile::Smem lay(p.kp, 0, G, kLay);
  auto kernel = pair_decode_tc<G, kLay>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // sized by p: the count lives on the device
  const long long tiles = (p.p + tile::kM - 1) / tile::kM;
  const long long blocks = tiles < sms ? tiles : sms;  // one per SM
  kernel<<<(unsigned)blocks, kThreads, lay.total, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <int M, int G>
int launch_f32(const Params<float>& p, void* stream) {
  const SmemF32 lay(M, p.kp, G);
  if (lay.total > tile::kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      pair_decode_f32<M, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (p.p + M - 1) / M;
  pair_decode_f32<M, G><<<(unsigned)blocks, kThreads, lay.total,
                          (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int run(void* const* ptrs, long long n, long long c_vox, long long c_rp,
        long long multires, long long kp, long long slots, long long n_iter,
        long long g, long long use_sigmoid, float init_offset, void* stream) {
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
  p.n_rows = (const int32_t*)ptrs[21];
  p.out_off = (float*)ptrs[22];
  p.out_logit = (float*)ptrs[23];
  p.p = n;
  p.c_vox = (int)c_vox;
  p.c_rp = (int)c_rp;
  p.multires = (int)multires;
  p.kp = (int)kp;
  p.slots = (int)slots;
  p.n_iter = (int)n_iter;
  p.use_sigmoid = (int)use_sigmoid;
  p.init_offset = init_offset;
  const long long o_pe = c_vox + c_rp;
  if (kp % 16 || kp < o_pe + 6 * (1 + 2 * multires) ||
      (p.rays == nullptr && slots < 1))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  return with_width(g, [&](auto w) {
    constexpr int G = decltype(w)::value;
    if constexpr (sizeof(T) == 2) {
      const tile::Smem lay((int)kp, 0, G);
      if (c_vox % 8 || c_rp % 8 || kp - o_pe > 32 * kPeCols ||
          n_iter > (tile::kMaxSegs - 4) / 2 || lay.total > tile::kMaxSmem)
        return (int)cudaErrorInvalidValue;
      if (lay.layout() == tile::kDouble)
        return launch_tc<G, tile::kDouble>(p, stream);
      if (lay.layout() == tile::kSingle)
        return launch_tc<G, tile::kSingle>(p, stream);
      return launch_tc<G, tile::kChunked>(p, stream);
    } else {
      return f32_rows((int)kp, G) == 32 ? launch_f32<32, G>(p, stream)
                                        : launch_f32<16, G>(p, stream);
    }
  });
}

}  // namespace

// ptrs: vox_table, cells, rays (or null), pos, ray_feat, w1, b1, a_vec,
// c_vec, off_{w2,b2,w3,b3,w4,b4}, prob_{w2,b2,w3,b3,w4,b4}, n_rows (a 0-d
// int32, or null), out_off, out_logit (24 device pointers). slots: the rows
// per ray of the dense layout, read when rays is null. g: imnet_gf, in
// {8, 16, 32, 64, 128}. Returns a cudaError_t.
extern "C" int idt_pair_decode(void* const* ptrs, long long n, long long c_vox,
                               long long c_rp, long long multires,
                               long long kp, long long slots, long long n_iter,
                               long long g, long long is_bf16,
                               long long use_sigmoid, float init_offset,
                               void* stream) {
  return is_bf16 ? run<__nv_bfloat16>(ptrs, n, c_vox, c_rp, multires, kp,
                                      slots, n_iter, g, use_sigmoid,
                                      init_offset, stream)
                 : run<float>(ptrs, n, c_vox, c_rp, multires, kp, slots,
                              n_iter, g, use_sigmoid, init_offset, stream);
}

// Dynamic shared memory (bytes) of one block of K6 at these widths
// (ops/ray_decode.py::decode_plan "K6" mirrors it).
extern "C" long long idt_pair_decode_smem(long long kp, long long g,
                                          long long is_bf16) {
  return is_bf16 ? (long long)idt::tile::Smem((int)kp, 0, (int)g).total
                 : (long long)SmemF32(f32_rows((int)kp, (int)g), (int)kp,
                                      (int)g)
                       .total;
}
