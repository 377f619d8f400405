// K3: fused backward of the stage-1 ray-major decode (both decoders).
//
// Replaces implicit_depth_tpu/ops/pallas_ray_decode.py::_fused_bwd_impl (its
// Pallas kernel, in table mode), in three instances (SaveMode):
//   * kFromL1 (save_mode='l1', the decode_bwd = 'kernel_save' default):
//     from the saves of K2 (ray_decode.cu: e1, z1p, trig);
//   * kFromAll (save_mode='all', decode_bwd = 'kernel_save_all'): from the
//     full saves of K2 'all', which add every h2, h3, the offset entering
//     each IEF iteration and the pre-squash outputs. It runs no forward
//     product: h1 = act(e1 + off_i * a_vec + c_vec) is elementwise, h2 and h3
//     are read back (16-byte loads) into the tiles the backward uses, and
//     the leaky-ReLU slopes come from their signs, as the JAX kernel's
//     save_mode == "all" branch does;
//   * recompute (decode_bwd = 'kernel', after K1's save-free forward): per
//     tile it computes trig from the positions, the per-ray part of layer 1
//     and both layer-1 pre-activations from the table rows, pos6, trig and
//     [roi | dir_e], unrounded in f32 as the JAX kernel keeps them. z1p goes
//     straight into the probability decoder's activation; e1, read once per
//     IEF iteration, goes to the block's own f32 slice
//     of a scratch buffer in global memory (L2-resident: 64 KB a block),
//     since shared memory has no room for it beside the backward's buffers.
// Derivatives follow the JAX kernel: the leaky-ReLU slope from the sign of
// the activation h; the soft clamp's derivative 1 on (0, 1) and 0.01
// elsewhere; the sigmoid's s(1 - s). Every product takes T operands (the
// cotangents rounded to T, as the JAX kernel's dots round them) with f32
// accumulation; bias gradients and the IEF offset chain are summed in f32.
//
// Every instance is compiled for the decoder widths 4g -> 2g -> g -> 1 of
// imnet_gf g in {8, 16, 32, 64, 128} (the template parameter G; the C entry
// dispatches on g; one library a width, -DIDT_GF), and for three tile
// heights M (the plan's rows_per_tile, chosen by ops/ray_decode.py::bwd_rows,
// the first whose block fits): 64 rows in bf16 (imnet_gf <= 64, kp <= 400,
// c_vox <= 256, and the per-ray regions of crp); 32 rows, which hold
// layer-1 inputs up to kp 640 and c_vox 512 (bf16, and f32 at imnet_gf <=
// 64); and 16 rows (f32, and bf16 at imnet_gf 128), which hold every width
// the wrappers take: f32 at imnet_gf 128 (its 32-row block needs ~269 KB
// at the default widths), f32 at imnet_gf 64 with crp 1056, bf16 at
// imnet_gf 128 with crp 1056 (the reference's rgb_out 64 with roi_out_bbox
// 4: the per-ray regions and the 3,080 small sums take the 32-row block
// ~9 KB past the limit; 16 rows rather than per-ray regions staged in
// chunks keep the kernel one path, at its register cap). A ray of kb > M
// slots spans ceil(kb / M) tiles; the per-ray regions hold 4 rays at 16
// and 32 rows, 8 at 64.
//
// The TPU kernel keeps its weight-gradient accumulators in VMEM across a
// sequential grid. A GPU block has no room for them (1.15 MB at the default
// widths) and no order between blocks, so the work is split in passes that
// one C call runs on the stream, over chunks of at most K3_CHUNK_RAYS rays
// (ops/ray_decode.py::bwd_plan, which sizes everything below):
//   * Pass A, a persistent grid (one 512-thread block per SM) walking
//     tiles of 64 (bf16: two tiles in flight a block, on wgmma,
//     ray_decode_bwd_wg.cuh), 32 or 16 pair rows (one a block, ~214 KB of
//     shared memory, below): the row-local recompute and backward. A tile
//     holds the whole rays of
//     rays_per_tile(kb) = min(rows / kb, rows / 8) (8 rays of 8 slots in
//     bf16: the per-ray regions' rows cap it, and rows idle at kb < 8), or,
//     in f32 at kb > 32, 32 slots of one ray: its tiles then follow each
//     other in one block, which carries the ray's d_ray_feat across them
//     and writes a per-ray stream row for each. It writes d_ray_feat per
//     ray; sums, in row order, the tile's rows that share a cell (rows of
//     neighbouring rays cross the same voxels) and adds each cell's sum
//     into the block's
//     own f32 copy of d_vox_table (a tile's cells are distinct, the block's
//     tiles follow each other in a fixed order, across the chunks); sums the
//     small gradients
//     (biases, a_vec, c_vec, layer 4) per block in shared memory in f32;
//     and, instead of forming the large weight gradients, writes their T
//     operands to streams in device memory: X = [vox | pos6 | trig],
//     T(d_e1) and T(d_z1p) per pair row; [roi | dir_e] and the per-ray
//     layer-1 cotangents T(d_re) per ray; h1, T(d_t2), h2, T(d_t3) of each
//     tail instance (the probability decoder and each IEF iteration): ~5 KB
//     a pair row, 1.2 GB of scratch for a 32,768-ray chunk in bf16. The
//     forward of every IEF iteration but the last leaves its activations in
//     those streams, and its backward reads them back instead of running
//     the forward again.
//   * Pass B: each weight gradient as split-K products over the chunk's
//     rows: a block owns a 64 x 128 output tile and a fixed run of rows of
//     one instance, stages both operands through shared memory (a cp.async
//     ring of three stages) into the tensor cores (wmma bf16, f32
//     accumulators) or, for f32, into 4 x 8 FMA micro-tiles, and adds its
//     tile into its own f32 partial; chunks follow each other on the stream.
//   * A reduction sums each gradient's partials, and the per-block small
//     sums, in a fixed order into the output, and one more sums the blocks'
//     copies of d_vox_table in block order: every gradient is bit-identical
//     run to run, as the JAX kernel's fixed-order sums are (the table's
//     copies, 1.5 MB a block at the training shapes, replace atomics whose
//     order varied).
//
// What bounds it on the H100: at the training shapes (640,000 pair rows)
// ~0.73 TFLOP, 0.74 ms at the bf16 tensor-core peak; the streams add ~3 GB
// written and read once (~2 ms at 3.35 TB/s) in place of the ~23 GB of
// per-tile workspace traffic of the first version. The 32- and 16-row
// instances (f32; imnet_gf 128; the widest per-ray and layer-1 inputs)
// keep the design below, which at 64 rows measured: bf16 products staging
// their weights through shared memory in slabs (cp.async, each weight
// element out of L2 once a block, padded rows kLd1..3 that do not conflict
// on banks), wmma 16x16x16 with the f32 accumulators through the C and D
// tiles, each between two __syncthreads of the SM's one tile, 60-67% of
// Pass A (scripts/attribute_k3_passes.py), at the 128-register cap of 512
// threads, the f32 tiles leaving no room for a second tile. The 64-row bf16
// instance (ray_decode_bwd_wg.cuh) is wgmma with the accumulators and the
// epilogues in registers: without those tiles one block holds two tiles,
// which share the weight slabs and the barriers.
// Its Pass A takes 75 ms at batch 32 on the H100 against the 98 of the
// design above (PERF.md): it is no longer bound by its products but by the
// length of a tile's chain of ~130 barrier phases, each waiting for a slab
// or a global load; skipping each cost in turn, the weight slabs are ~27%
// of it, the products' own issue and barriers ~18%, the stream writes ~16%.
#include <type_traits>

#include "decode_common.cuh"
#include "wgmma.cuh"

namespace {

using namespace idt;

// Pass A's block: 16 warps, to hide the latency of its many short phases
// (its products and tail loops use these; Pass B and the reduction keep
// decode_common.cuh's 256 threads)
constexpr int kThreadsA = 512, kWarpsA = kThreadsA / 32;
// weight fragments a warp of a per-ray product loads from L2 together
// before it uses them
constexpr int kPre = 8;
// The widths of imnet_gf G's decoder, and the row strides of its T tiles in
// shared memory that feed the tensor cores: 8 elements (16 bytes) past their
// widths, so that the 8 rows of each fragment load fall in different banks
template <int G>
struct Dims : Widths<G> {
  static constexpr int ld1 = Widths<G>::g1 + 8, ld2 = Widths<G>::g2 + 8,
                       ld3 = Widths<G>::g3 + 8;
};
#define IDT_DIMS(G)                                                      \
  [[maybe_unused]] constexpr int kG1 = Dims<G>::g1, kG2 = Dims<G>::g2,     \
                                 kG3 = Dims<G>::g3, kLd1 = Dims<G>::ld1,   \
                                 kLd2 = Dims<G>::ld2, kLd3 = Dims<G>::ld3
// elements of the bf16 weight staging buffer: two slabs of the largest
// staged product's weights (128 columns of B^T, 64 k each, padded to 72)
constexpr int kStageElems = 2 * 128 * (64 + 8);
// the widest X = [vox | pos6 | trig | 0] row (kp) Pass A stages at M rows
// a tile (X spans the H1 and H2 regions, which lie one after the other),
// and the widest voxel row (c_vox, the d_rows tile's columns)
// dynamic shared memory one block may use (H100)
constexpr size_t kMaxSmemA = 232448;
template <int M>
constexpr int max_kp() { return M == 64 ? 400 : 640; }
template <int M>
constexpr int max_cvox() { return M == 64 ? 256 : 512; }
// the instances a library holds: 64 rows in bf16 at imnet_gf <= 64, 32 rows
// but in f32 at imnet_gf 128 (that block never fits), 16 rows in f32 and
// in bf16 at imnet_gf 128 (at <= 64 the 32-row bf16 block holds every
// width the wrappers take)
template <typename T, int M, int G>
constexpr bool held() {
  return M == 64   ? sizeof(T) == 2 && G <= 64
         : M == 32 ? sizeof(T) == 2 || G <= 64
                   : sizeof(T) == 4 || G == 128;
}

// -- the plan's fields (ops/ray_decode.py::pack_bwd_plan) ---------------------

enum PlanField {
  kChunkRays, kNChunks, kBlocksA, kRowsPerTile, kNInst, kSplitRows, kNJobs,
  kNReds, kStreamOff = 8, kSmallOff = 18, kSmallSize = 29, kSmallBase = 30,
  kScratchElems = 31, kPartialFloats = 32, kBlocksB = 33, kTableOff = 34,
  kTableStride = 35, kTableElems = 36, kSlots = 37, kRaysPerTile = 38,
  kTilesPerRay = 39, kHeader = 40
};
// what Pass A starts from: a recompute of layer 1 (decode_bwd = 'kernel'),
// K2's saves ('kernel_save') or K2 'all''s ('kernel_save_all')
enum SaveMode { kRecompute, kFromL1, kFromAll };
constexpr int kJobFields = 12, kRedFields = 9, kMaxJobs = 8, kMaxReds = 24;
enum Stream { kX, kDeOff, kDeProb, kRf, kDreOff, kDreProb, kH1, kDt2, kH2,
              kDt3, kStreams };
enum Small { kSB1, kSAVec, kSCVec, kSOffB2, kSOffB3, kSOffW4, kSOffB4,
             kSProbB2, kSProbB3, kSProbW4, kSProbB4, kSmall };

// 8 elements of T from global memory (16-byte aligned) into f32 registers
__device__ __forceinline__ void load8(const __nv_bfloat16* src,
                                     float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(src));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* src, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(src));
  const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// 8 elements of T from global memory (or zeros for null) to shared memory,
// both 16-byte aligned, without conversion
template <typename T>
__device__ __forceinline__ void copy8(T* dst, const T* src) {
  constexpr int kN = 8 * sizeof(T) / 16;  // 16-byte pieces
#pragma unroll
  for (int k = 0; k < kN; ++k)
    reinterpret_cast<uint4*>(dst)[k] =
        src ? __ldg(reinterpret_cast<const uint4*>(src) + k)
            : make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ float dleaky(float h, float d) {
  return h > 0.f ? d : kLeaky * d;
}

// 4 consecutive T in shared memory (8- or 16-byte aligned) as f32, and back
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(p);
  h[0] = __floats2bfloat162_rn(v.x, v.y);
  h[1] = __floats2bfloat162_rn(v.z, v.w);
}
__device__ __forceinline__ float4 leaky4(float4 v) {
  return make_float4(leaky(v.x), leaky(v.y), leaky(v.z), leaky(v.w));
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float4 dleaky4(float4 h, float4 d) {
  return make_float4(dleaky(h.x, d.x), dleaky(h.y, d.y), dleaky(h.z, d.z),
                     dleaky(h.w, d.w));
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// 16 bytes from global to shared memory (zeros where !pred), asynchronously
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// -- products ----------------------------------------------------------------

// C[M x N] (f32, shared, ldc) (+)= A[M x K] (T, lda; shared memory, or
// global memory written by this block) @ op(B), with op(B) = B[K x N]
// (global, row-major, ldb) or, kTransB, B^T for B[N x K] (global, row-major,
// ldb). Tensor cores when T is bf16, M (<= 64), N, K are multiples of 16
// and `stage` (kStageElems of shared memory) is given: the weights then pass
// through shared memory. Also tensor cores for M = 8 and N a multiple of 32
// (the per-ray products), with weight fragments read from L2. CUDA-core FMA
// otherwise (M, N multiples of 4).
template <typename T, bool kTransB>
__device__ void product(const T* A, int lda, const T* __restrict__ B, int ldb,
                        int M, int K, int N, float* C, int ldc, bool acc,
                        T* stage = nullptr) {
  if constexpr (sizeof(T) == 2) {
    using namespace nvcuda;
    using BLayout = typename std::conditional<kTransB, wmma::col_major,
                                              wmma::row_major>::type;
    const int warp = threadIdx.x / 32;
    // a slab of the weights: kslab of their K rows, row-major with stride
    // N + 8, or (kTransB) the columns k0.. of B's N rows with stride
    // kslab + 8; the 8 elements of padding keep the 8 rows of a fragment
    // load on different banks
    const int kslab = N <= 128 ? 64 : 32;
    const int lds = kTransB ? kslab + 8 : N + 8;
    const int slab = kTransB ? N * lds : kslab * lds;
    if (stage != nullptr && M % 16 == 0 && M <= 64 && N % 16 == 0 &&
        K % 16 == 0 && N / 16 <= kWarpsA && 2 * slab <= kStageElems) {
      // every thread copies slabs (cp.async, the next one in flight while
      // the warps use the current one), and each warp keeps one column
      // tile's accumulators for its row tiles across the slabs: each
      // weight element comes from L2 once a block
      const int rts = M / 16, cts = N / 16;
      const int wpc = kWarpsA / cts;
      const int rpw = (rts + wpc - 1) / wpc;
      const int ct = warp / wpc, r0 = (warp % wpc) * rpw;
      const int nr = warp < cts * wpc ? min(rpw, rts - r0) : 0;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i < nr) {
          float* cp = C + (r0 + i) * 16 * ldc + ct * 16;
          if (acc)
            wmma::load_matrix_sync(c[i], cp, ldc, wmma::mem_row_major);
          else
            wmma::fill_fragment(c[i], 0.f);
        }
      }
      auto load = [&](int buf, int k0) {
        T* dst = stage + buf * slab;
        const int per = kTransB ? kslab / 8 : N / 8;  // 16-byte pieces a row
        const int rows = kTransB ? N : kslab;
        for (int i = threadIdx.x; i < rows * per; i += blockDim.x) {
          const int r = i / per, q = i % per;
          const int k = kTransB ? k0 + q * 8 : k0 + r;
          const bool ok = k < K;
          const T* src = kTransB ? B + (size_t)r * ldb + k
                                 : B + (size_t)k * ldb + q * 8;
          cp_async16(dst + r * lds + q * 8, ok ? src : B, ok);
        }
      };
      const int slabs = (K + kslab - 1) / kslab;
      load(0, 0);
      cp_commit();
      for (int sl = 0; sl < slabs; ++sl) {
        if (sl + 1 < slabs) {
          load((sl + 1) & 1, (sl + 1) * kslab);
          cp_commit();
          cp_wait<1>();
        } else {
          cp_wait<0>();
        }
        __syncthreads();
        const T* sb = stage + (sl & 1) * slab;
        const int k0 = sl * kslab;
        if (nr > 0) {
          for (int kk = 0; kk < kslab && k0 + kk < K; kk += 16) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout>
                b;
            wmma::load_matrix_sync(
                b, kTransB ? sb + ct * 16 * lds + kk : sb + kk * lds + ct * 16,
                lds);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if (i < nr) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                               wmma::row_major> a;
                wmma::load_matrix_sync(a, A + (r0 + i) * 16 * lda + k0 + kk,
                                       lda);
                wmma::mma_sync(c[i], a, b, c[i]);
              }
            }
          }
        }
        __syncthreads();  // the slab is read before it is refilled
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i < nr)
          wmma::store_matrix_sync(C + (r0 + i) * 16 * ldc + ct * 16, c[i],
                                  ldc, wmma::mem_row_major);
      }
      return;
    }
    if (M == 8 && N % 32 == 0 && K % 16 == 0) {
      for (int ct = warp; ct < N / 32; ct += kWarpsA) {
        wmma::fragment<wmma::accumulator, 8, 32, 16, float> c;
        float* cp = C + ct * 32;
        if (acc)
          wmma::load_matrix_sync(c, cp, ldc, wmma::mem_row_major);
        else
          wmma::fill_fragment(c, 0.f);
        for (int s0 = 0; s0 < K / 16; s0 += kPre) {
          wmma::fragment<wmma::matrix_b, 8, 32, 16, __nv_bfloat16, BLayout>
              b[kPre];
#pragma unroll
          for (int j = 0; j < kPre; ++j) {
            const int k = (s0 + j) * 16;
            if (k < K)
              wmma::load_matrix_sync(b[j],
                                     kTransB ? B + (size_t)ct * 32 * ldb + k
                                             : B + (size_t)k * ldb + ct * 32,
                                     ldb);
          }
#pragma unroll
          for (int j = 0; j < kPre; ++j) {
            const int k = (s0 + j) * 16;
            if (k >= K) continue;
            wmma::fragment<wmma::matrix_a, 8, 32, 16, __nv_bfloat16,
                           wmma::row_major> a;
            wmma::load_matrix_sync(a, A + k, lda);
            wmma::mma_sync(c, a, b[j], c);
          }
        }
        wmma::store_matrix_sync(cp, c, ldc, wmma::mem_row_major);
      }
      return;
    }
  }
  const int col_groups = N / 4, items = (M / 4) * col_groups;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int cg = it % col_groups, rg = it / col_groups;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[i][j] = acc ? C[(rg * 4 + i) * ldc + cg * 4 + j] : 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = to_f32(A[(rg * 4 + i) * lda + k]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = kTransB ? ldg_f32(B + (size_t)(cg * 4 + j) * ldb + k)
                       : ldg_f32(B + (size_t)k * ldb + cg * 4 + j);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) C[(rg * 4 + i) * ldc + cg * 4 + j] = s[i][j];
  }
}

// Layers 2-4 of one decoder from the T-rounded layer-1 activation H (M x
// 4G, shared, row stride kLd1), as decode_common.cuh::mlp_tail computes
// them, with this file's products: C (f32, M x 2G) is product scratch, H2
// (M x 2G, stride kLd2), H3 (M x G, stride kLd3) of type T, S the weight
// staging buffer (or null). out[row] = the pre-squash output of layer 4
// without b4 (f32, shared).
template <typename T, int M, int G>
__device__ void tail_forward(const T* H, float* C, T* H2, T* H3, T* S,
                             const TailWeights<T>& w, float* out) {
  IDT_DIMS(G);
  product<T, false>(H, kLd1, w.w2, kG2, M, kG1, kG2, C, kG2, false, S);
  __syncthreads();
  // the elementwise passes take 4 consecutive elements a thread
  for (int i = 4 * threadIdx.x; i < M * kG2; i += 4 * blockDim.x)
    st4(H2 + i / kG2 * kLd2 + i % kG2,
        leaky4(add4(ld4(C + i), ld4(w.b2 + i % kG2))));
  __syncthreads();
  product<T, false>(H2, kLd2, w.w3, kG3, M, kG2, kG3, C, kG3, false, S);
  __syncthreads();
  for (int i = 4 * threadIdx.x; i < M * kG3; i += 4 * blockDim.x)
    st4(H3 + i / kG3 * kLd3 + i % kG3,
        leaky4(add4(ld4(C + i), ld4(w.b3 + i % kG3))));
  __syncthreads();
  // layer 4: each row's G-term dot, a warp a row, the lanes over columns
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < M; r += kWarpsA) {
    float s = 0.f;
    for (int k = lane; k < kG3; k += 32)
      s = fmaf(to_f32(H3[r * kLd3 + k]), ldg_f32(w.w4 + k), s);
    s = warp_sum(s);
    if (lane == 0) out[r] = s;
  }
  __syncthreads();
}

// g[c] += sum over the M rows of X[r * ldx + c] (f32, shared), c < N
__device__ void colsum_add(const float* X, int ldx, int M, int N, float* g) {
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    float s = 0.f;
#pragma unroll 8
    for (int r = 0; r < M; ++r) s += X[r * ldx + c];
    g[c] += s;
  }
}

// rows x width elements from shared memory (row stride lds) to dense rows
// in global memory, 16 bytes a thread (width * sizeof(T) and lds *
// sizeof(T) multiples of 16)
template <typename T>
__device__ __forceinline__ void put(const T* src, int lds, T* dst, int width,
                                    int rows) {
  const int per_row = width * (int)sizeof(T) / 16;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row, q = i % per_row;
    reinterpret_cast<uint4*>(dst + (size_t)r * width)[q] =
        reinterpret_cast<const uint4*>(src + r * lds)[q];
  }
}

// the converse of put: rows dense rows from global memory (the streams,
// written by this block: plain loads, not __ldg; or K2 'all''s saves) into
// shared memory (row stride lds), and zeros in the tile's rows past them, m
// rows in all
template <typename T>
__device__ __forceinline__ void fetch(const T* src, int width, T* dst,
                                      int lds, int rows, int m) {
  const int pieces = width * (int)sizeof(T) / 16;  // 16-byte pieces a row
  for (int i = threadIdx.x; i < m * pieces; i += blockDim.x) {
    const int r = i / pieces, q = i % pieces;
    reinterpret_cast<uint4*>(dst + r * lds)[q] =
        r < rows ? reinterpret_cast<const uint4*>(src + (size_t)r * width)[q]
                 : make_uint4(0u, 0u, 0u, 0u);
  }
}

// d * squash'(x) at the pre-squash x
__device__ __forceinline__ float dsquash(float x, float d, bool use_sigmoid) {
  if (use_sigmoid) {
    const float s = 1.f / (1.f + expf(-x));
    return d * s * (1.f - s);
  }
  return (x > 0.f && x < 1.f) ? d : 0.01f * d;
}

// -- Pass A --------------------------------------------------------------------

template <typename T>
struct BwdParams {
  const T* vox_table;   // (S, c_vox)
  const int32_t* cells; // (n, kb)
  const float* pos;     // (n, kb, 6)
  const T* ray_feat;    // (n, c_ray)
  const T* pair_w1;     // (kp, 512)
  const T* ray_w1;      // (crp, 512)
  const float* b1;      // (512,)
  const float* a_vec;   // (256,)
  const float* c_vec;   // (256,)
  TailWeights<T> off, prob;
  const T* e1;          // (n*kb, 256) saves of K2 (kFromSaves)
  const T* z1p;         // (n*kb, 256)
  const T* trig;        // (n*kb, 12*multires)
  // kFromAll: K2 'all''s saves, instance i < n_iter of IEF iteration i,
  // n_iter of the final offset and the probability decoder; instance i of
  // pair row r at (i * n * kb + r) * width
  const float* s_off;   // (n_iter + 1, n*kb)
  const T* s_h2;        // (n_iter + 1, n*kb, 128)
  const T* s_h3;        // (n_iter + 1, n*kb, 64)
  const float* s_logit; // (n*kb,)
  long long s_inst;     // n*kb
  // recompute: (gridDim.x, M, 4g) f32; at 64 rows, every mode:
  // (gridDim.x, wg_scratch_floats) f32
  float* e1_scratch;
  const float* g;       // (n, kb, 2) cotangents [offset | logit]
  float* table_part;    // (gridDim.x, table_stride) f32 copies of d_vox_table, zeroed
  long long table_stride;
  float* d_ray;         // (n, c_ray)
  T* stream[kStreams];  // the chunk's operand streams
  long long inst_stride[kStreams];  // elements between tail instances
  float* small_part;    // (gridDim.x, small_size) f32, zeroed
  int small_off[kSmall];
  int small_size;
  long long ray_base, n_chunk;  // the chunk's first ray and its rays
  int n_vblocks;  // Pass A blocks of the plan (at 64 rows: tile slots)
  long long row_base;           // the chunk's first pair row, ray_base * kb
  // pair slots a ray; whole rays of a tile; slots of a tile's ray (kb, or
  // M at kb > M); tiles of a ray (1, or f32 at kb > M: 2)
  int kb, rays, spt, tpr;
  int c_vox, c_ray, multires, kp, crp, n_iter, use_sigmoid;
  float init_offset;
};

// Pass A's shared memory: the regions of fixed size first, at offsets known
// at compile time (their addresses then take no registers in a kernel that
// runs at its register limit), then the three whose size the call sets: the
// IEF offsets (n_iter), the ray features (crp) and the small sums
__host__ __device__ constexpr size_t align128(size_t b) {
  return (b + 127) / 128 * 128;
}

template <typename T, int M, int G>
struct BwdSmem {
  // rays of a tile, at most (4 at 16 rows: the per-ray products' FMA path
  // takes rows in fours)
  static constexpr int kMR = M / 8 > 4 ? M / 8 : 4;
  static constexpr int kG1 = Dims<G>::g1, kG2 = Dims<G>::g2,
                       kLd1 = Dims<G>::ld1, kLd2 = Dims<G>::ld2,
                       kLd3 = Dims<G>::ld3;
  // the row width of the H1 region: X (stride kp <= max_kp) spans it and H2's
  static constexpr int kMaxKp = max_kp<M>();
  static constexpr int kLdH1 = kLd1 > kMaxKp - kLd2 ? kLd1 : kMaxKp - kLd2;
  // d_z1 (M x 4G) and the d_rows (M x c_vox, c_vox <= max_cvox) of the table
  static constexpr int kDCols = kG1 > max_cvox<M>() ? kG1 : max_cvox<M>();
  static constexpr size_t kCF = (size_t)M * kG2 * 4;
  static constexpr size_t kCT = (size_t)M * kLd1 * sizeof(T);
  // H1 | X, H2 | dT2 (| X), H3 | dT3
  static constexpr size_t h1 = 0;
  static constexpr size_t h2 = align128(h1 + (size_t)M * kLdH1 * sizeof(T));
  static constexpr size_t h3 = align128(h2 + (size_t)M * kLd2 * sizeof(T));
  // f32 product scratch | T(d_z1p), T(d_e1); d_z1 (f32) | d_rows
  static constexpr size_t c = align128(h3 + (size_t)M * kLd3 * sizeof(T));
  static constexpr size_t d = align128(c + (kCF > kCT ? kCF : kCT));
  // the bf16 products' weight slabs (the f32 products read B from L2)
  static constexpr size_t stg = align128(d + (size_t)M * kDCols * 4);
  static constexpr size_t doff =
      align128(stg + (sizeof(T) == 2 ? (size_t)kStageElems * sizeof(T) : 0));
  static constexpr size_t tmp = align128(doff + (size_t)M * 4);
  static constexpr size_t go = align128(tmp + (size_t)M * 4);
  static constexpr size_t gl = align128(go + (size_t)M * 4);
  static constexpr size_t cell = align128(gl + (size_t)M * 4);
  static constexpr size_t lead = align128(cell + (size_t)M * 4);
  static constexpr size_t next = align128(lead + (size_t)M * 4);
  static constexpr size_t av = align128(next + (size_t)M * 4);
  static constexpr size_t cv = align128(av + (size_t)kG1 * 4);
  static constexpr size_t ret = align128(cv + (size_t)kG1 * 4);
  static constexpr size_t fixed =
      align128(ret + (size_t)kMR * kLd1 * sizeof(T));
  size_t off, rf, drf, small, total;
  __host__ __device__ BwdSmem(int crp, int n_iter, int small_size) {
    off = fixed;
    rf = align128(off + (size_t)(n_iter + 1) * M * 4);
    drf = align128(rf + (size_t)kMR * crp * sizeof(T));
    small = align128(drf + (size_t)kMR * crp * 4);
    total = align128(small + (size_t)small_size * 4);
  }
};

// where one tail instance's operands go: h1, T(d_t2), h2, T(d_t3) of the
// tile's rows (h1, h2 null where the forward has written them already)
template <typename T>
struct TailOut {
  T* h1;
  T* dt2;
  T* h2;
  T* dt3;
  int rows;
};

// Backward through one decoder tail (layers 2-4) of M rows, given H1, H2, H3
// (the forward's T activations) and DOFF (the cotangent of the tail's
// output). Adds the tail's bias and layer-4 gradients into the block's
// shared sums s (b2, b3, w4, b4), writes the operands of its w2 and w3
// gradients to `out`, overwrites H2, H3 with the rounded cotangents, and
// writes d_z1 (f32 cotangent of layer 1's pre-activation) into D, or adds it
// when accumulate. For the IEF (off_i != nullptr) also adds d_a_vec, d_c_vec
// into s_a, s_c and adds sum_c d_z1 * a_vec to DOFF (the cotangent of the
// iteration's input offset).
template <typename T, int M, int G>
__device__ void tail_backward(const T* H1, T* H2, T* H3, float* DOFF,
                              float* C, float* D, T* S, bool accumulate,
                              const float* off_i, const float* AV,
                              const TailWeights<T>& w, float* s_b2,
                              float* s_b3, float* s_w4, float* s_b4,
                              float* s_a, float* s_c, const TailOut<T>& out) {
  IDT_DIMS(G);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // layer 4: dW4 = H3^T T(d), db4 = sum d
  for (int c = threadIdx.x; c <= kG3; c += blockDim.x) {
    float s = 0.f;
    if (c < kG3) {
#pragma unroll 8
      for (int r = 0; r < M; ++r)
        s = fmaf(to_f32(H3[r * kLd3 + c]), to_f32(from_f32<T>(DOFF[r])), s);
      s_w4[c] += s;
    } else {
      for (int r = 0; r < M; ++r) s += DOFF[r];
      s_b4[0] += s;
    }
  }
  __syncthreads();
  // d_t3 = dleaky(h3, T(d) * w4), in C (f32) and, rounded, over H3
  for (int i = 4 * threadIdx.x; i < M * kG3; i += 4 * blockDim.x) {
    const float g = to_f32(from_f32<T>(DOFF[i / kG3]));
    const float4 w4 = make_float4(ldg_f32(w.w4 + i % kG3),
                                  ldg_f32(w.w4 + i % kG3 + 1),
                                  ldg_f32(w.w4 + i % kG3 + 2),
                                  ldg_f32(w.w4 + i % kG3 + 3));
    T* h3 = H3 + i / kG3 * kLd3 + i % kG3;
    const float4 d = dleaky4(ld4(h3), make_float4(g * w4.x, g * w4.y,
                                                  g * w4.z, g * w4.w));
    st4(C + i, d);
    st4(h3, d);
  }
  __syncthreads();
  colsum_add(C, kG3, M, kG3, s_b3);
  if (out.h2 != nullptr) put(H2, kLd2, out.h2, kG2, out.rows);
  put(H3, kLd3, out.dt3, kG3, out.rows);
  __syncthreads();
  // d_t2 = dleaky(h2, d_t3 @ W3^T)
  product<T, true>(H3, kLd3, w.w3, kG3, M, kG3, kG2, C, kG2, false, S);
  __syncthreads();
  for (int i = 4 * threadIdx.x; i < M * kG2; i += 4 * blockDim.x) {
    T* h2 = H2 + i / kG2 * kLd2 + i % kG2;
    const float4 d = dleaky4(ld4(h2), ld4(C + i));
    st4(C + i, d);
    st4(h2, d);
  }
  __syncthreads();
  colsum_add(C, kG2, M, kG2, s_b2);
  if (out.h1 != nullptr) put(H1, kLd1, out.h1, kG1, out.rows);
  put(H2, kLd2, out.dt2, kG2, out.rows);
  __syncthreads();
  // d_z1 = dleaky(h1, d_t2 @ W2^T), in two 2G-column halves through C
  for (int n0 = 0; n0 < kG1; n0 += kG2) {
    product<T, true>(H2, kLd2, w.w2 + (size_t)n0 * kG2, kG2, M, kG2, kG2, C,
                     kG2, false, S);
    __syncthreads();
    for (int i = 4 * threadIdx.x; i < M * kG2; i += 4 * blockDim.x) {
      const int at = (i / kG2) * kG1 + n0 + i % kG2;
      const float4 d = dleaky4(ld4(H1 + (i / kG2) * kLd1 + n0 + i % kG2),
                               ld4(C + i));
      st4(C + i, d);
      st4(D + at, accumulate ? add4(ld4(D + at), d) : d);
    }
    __syncthreads();
    if (off_i != nullptr) {
      for (int c = threadIdx.x; c < kG2; c += blockDim.x) {
        float sa = 0.f, sc = 0.f;
#pragma unroll 8
        for (int r = 0; r < M; ++r) {
          sa = fmaf(C[r * kG2 + c], off_i[r], sa);
          sc += C[r * kG2 + c];
        }
        s_a[n0 + c] += sa;
        s_c[n0 + c] += sc;
      }
      // each row's dot with a_vec: a warp a row, the lanes over columns
      for (int r = warp; r < M; r += kWarpsA) {
        float s = 0.f;
        for (int c = lane; c < kG2; c += 32)
          s = fmaf(C[r * kG2 + c], AV[n0 + c], s);
        s = warp_sum(s);
        if (lane == 0) DOFF[r] += s;
      }
      __syncthreads();
    }
  }
}

#include "ray_decode_bwd_wg.cuh"

// Pass A: the 64-row bf16 instance on wgmma (ray_decode_bwd_wg.cuh), two
// tiles a block; the 32- and 16-row instances below, one tile a block
template <typename T, int M, int kMode, int G>
__global__ void __launch_bounds__(M == 64 ? kThreadsW : kThreadsA, 1)
    pass_a_kernel(const __grid_constant__ BwdParams<T> p) {
  if constexpr (M == 64) {
    pass_a_wg<kMode, G>(p);
    return;
  }
  IDT_DIMS(G);
  using Lay = BwdSmem<T, M, G>;
  constexpr bool kFromSaves = kMode != kRecompute;
  constexpr int MR = Lay::kMR;  // rays of a tile, at most
  // 8-element vectors of an M x 4G tile a thread handles (the last round
  // partial where they do not divide)
  constexpr int kVecs = M * kG1 / 8;
  constexpr int kTileVecs = (kVecs + kThreadsA - 1) / kThreadsA;
  constexpr bool kRagged = kVecs % kThreadsA != 0;
  extern __shared__ __align__(128) unsigned char smem[];
  const Lay lay(p.crp, p.n_iter, p.small_size);
  T* H1 = reinterpret_cast<T*>(smem + Lay::h1);
  T* X = H1;
  T* H2 = reinterpret_cast<T*>(smem + Lay::h2);
  T* H3 = reinterpret_cast<T*>(smem + Lay::h3);
  float* C = reinterpret_cast<float*>(smem + Lay::c);
  // T(d_z1p) in layer1(1), T(d_e1) after the IEF
  T* DT = reinterpret_cast<T*>(smem + Lay::c);
  float* D = reinterpret_cast<float*>(smem + Lay::d);
  T* S = sizeof(T) == 2 ? reinterpret_cast<T*>(smem + Lay::stg) : nullptr;
  float* OFF = reinterpret_cast<float*>(smem + lay.off);
  float* DOFF = reinterpret_cast<float*>(smem + Lay::doff);
  float* TMP = reinterpret_cast<float*>(smem + Lay::tmp);
  float* GO = reinterpret_cast<float*>(smem + Lay::go);
  float* GL = reinterpret_cast<float*>(smem + Lay::gl);
  T* RET = reinterpret_cast<T*>(smem + Lay::ret);
  T* RF = reinterpret_cast<T*>(smem + lay.rf);
  float* DRF = reinterpret_cast<float*>(smem + lay.drf);
  float* AV = reinterpret_cast<float*>(smem + Lay::av);
  float* CV = reinterpret_cast<float*>(smem + Lay::cv);
  float* SM = reinterpret_cast<float*>(smem + lay.small);
  int* CELL = reinterpret_cast<int*>(smem + Lay::cell);
  int* LEAD = reinterpret_cast<int*>(smem + Lay::lead);
  int* NEXT = reinterpret_cast<int*>(smem + Lay::next);

  float* E1G = kFromSaves ? nullptr
                          : p.e1_scratch + (size_t)blockIdx.x * M * kG1;
  const int kp = p.kp, crp = p.crp, c_vox = p.c_vox;
  const int n_trig = 12 * p.multires;
  // the slots of a tile's ray and a ray's tiles: kb and 1 at 64 rows (kb <=
  // 64 = M); at 32 rows and kb > M: M and 2
  constexpr bool kSegs = M < kMaxKb;
  const int kb = p.kb, rays = p.rays;
  const int spt = kSegs ? p.spt : kb, tpr = kSegs ? p.tpr : 1;
  const int n_units = (int)((p.n_chunk + rays - 1) / rays);
  for (int c = threadIdx.x; c < kG1; c += blockDim.x) {
    AV[c] = __ldg(p.a_vec + c);
    CV[c] = __ldg(p.c_vec + c);
  }
  for (int i = threadIdx.x; i < p.small_size; i += blockDim.x) SM[i] = 0.f;

  // a unit of `rays` whole rays is one tile, or (tpr > 1) one ray's tiles in
  // order: the block carries DRF from the first to the last
  for (int unit = blockIdx.x; unit < n_units; unit += gridDim.x)
  for (int seg = 0; seg < tpr; ++seg) {
    const int lray0 = unit * rays;  // within the chunk
    const int rays_ok =
        (int)(p.n_chunk - lray0 < rays ? p.n_chunk - lray0 : rays);
    const int slot0 = seg * spt;
    // the slots of each of the tile's rays
    const int slots = kSegs && kb - slot0 < spt ? kb - slot0 : spt;
    const int rows_ok = (rays_ok - 1) * spt + slots;
    // rows are the pair rows from lrow0 (within the chunk), consecutive
    const int lrow0 = lray0 * kb + slot0;
    auto row_ok = [&](int r) { return r < rows_ok; };
    auto grow = [&](int r) { return p.row_base + lrow0 + r; };
    // the tile's place in a stream (instance 0): its first pair row, or for
    // the per-ray streams its first ray's row (a row a ray and tile)
    auto at = [&](int s) {
      const bool per_ray = s == kRf || s == kDreOff || s == kDreProb;
      return p.stream[s] + (size_t)(per_ray ? lray0 * tpr + seg : lrow0) *
                               (s == kX ? kp : s == kRf ? crp
                                : s == kDt2 || s == kH2 ? kG2
                                : s == kDt3 ? kG3 : kG1);
    };
    auto inst_at = [&](int s, int inst) {
      return at(s) + inst * p.inst_stride[s];
    };
    auto tail_out = [&](int inst, bool fresh) {
      return TailOut<T>{fresh ? inst_at(kH1, inst) : nullptr,
                        inst_at(kDt2, inst),
                        fresh ? inst_at(kH2, inst) : nullptr,
                        inst_at(kDt3, inst), rows_ok};
    };

    __syncthreads();  // the previous tile is done with every buffer
    for (int r = threadIdx.x; r < M; r += blockDim.x) {
      const bool ok = row_ok(r);
      GO[r] = ok ? __ldg(p.g + grow(r) * 2) : 0.f;
      GL[r] = ok ? __ldg(p.g + grow(r) * 2 + 1) : 0.f;
      CELL[r] = ok ? __ldg(p.cells + grow(r)) : -1;
    }
    for (int i = threadIdx.x; seg == 0 && i < MR * crp; i += blockDim.x) {
      const int r = i / crp, col = i % crp;
      RF[i] = (r < rays_ok && col < p.c_ray)
                  ? ldg_raw(p.ray_feat +
                            (p.ray_base + lray0 + r) * p.c_ray + col)
                  : from_f32<T>(0.f);
      DRF[i] = 0.f;
    }
    __syncthreads();  // CELL, RF

    // stage X = [vox | pos6 | trig | 0] (M x kp, T) into the H1 region: the
    // voxel rows (and the saved trig) in 16-byte loads
    auto stage_x = [&]() {
      const int vv = c_vox / 8;
      for (int i = threadIdx.x; i < M * vv; i += blockDim.x) {
        const int r = i / vv, q = i % vv;
        copy8(X + r * kp + q * 8,
              row_ok(r) ? p.vox_table + (long long)CELL[r] * c_vox + q * 8
                        : nullptr);
      }
      T* XT = X + c_vox + 6;  // the trig columns
      if (kFromSaves && n_trig % 8 == 0) {
        const int tv = n_trig / 8;
        for (int i = threadIdx.x; i < M * tv; i += blockDim.x) {
          const int r = i / tv, q = i % tv;
          float v[8] = {};
          if (row_ok(r)) load8(p.trig + grow(r) * n_trig + q * 8, v);
#pragma unroll
          for (int j = 0; j < 8; ++j) XT[r * kp + q * 8 + j] = from_f32<T>(v[j]);
        }
      } else {
        for (int i = threadIdx.x; i < M * n_trig; i += blockDim.x) {
          const int r = i / n_trig, t = i % n_trig;
          float v = 0.f;
          if (row_ok(r)) {
            if constexpr (kFromSaves)
              v = ldg_f32(p.trig + grow(r) * n_trig + t);
            else
              v = trig_column(p.pos + grow(r) * 6, t, p.multires);
          }
          XT[r * kp + t] = from_f32<T>(v);
        }
      }
      // pos6, then the zero padding past the trig columns
      const int rest = kp - c_vox - n_trig;
      for (int i = threadIdx.x; i < M * rest; i += blockDim.x) {
        const int r = i / rest, j = i % rest;
        const int col = j < 6 ? c_vox + j : c_vox + n_trig + j;
        X[r * kp + col] = from_f32<T>(
            j < 6 && row_ok(r) ? __ldg(p.pos + grow(r) * 6 + j) : 0.f);
      }
    };

    // layer 1 of one decoder (half 0: IEF offset, 1: probability) from its
    // d_z1 in D (f32): the b1 sums, the operands of the pair_w1 and ray_w1
    // gradients to their streams, and d_ray_feat; leaves T(d_z1) in DT (and
    // in its stream) for the d_rows products. The probability half runs
    // first: it writes the half-independent operands (X, ray features) and
    // sets DRF.
    auto layer1 = [&](int half) {
      colsum_add(D, kG1, M, kG1, SM + p.small_off[kSB1] + half * kG1);
      // each ray's sum over its slots, in slot order
      for (int i = threadIdx.x; i < MR * kG1; i += blockDim.x) {
        const int r = i / kG1, c = i % kG1;
        float s = 0.f;
        if (r < rays) {
#pragma unroll 8
          for (int k = 0; k < slots; ++k) s += D[(r * spt + k) * kG1 + c];
        }
        RET[r * kLd1 + c] = from_f32<T>(s);
      }
      for (int i = 4 * threadIdx.x; i < M * kG1; i += 4 * blockDim.x)
        st4(DT + i / kG1 * kLd1 + i % kG1, ld4(D + i));
      stage_x();
      __syncthreads();
      put(DT, kLd1, at(half ? kDeProb : kDeOff), kG1, rows_ok);
      put(RET, kLd1, at(half ? kDreProb : kDreOff), kG1, rays_ok);
      if (half == 1) {
        put(X, kp, at(kX), kp, rows_ok);
        put(RF, crp, at(kRf), crp, rays_ok);
      }
      // d_ray_feat += T(d_re) @ ray_w1[:, half]^T
      product<T, true>(RET, kLd1, p.ray_w1 + half * kG1, 2 * kG1, MR, kG1,
                       crp, DRF, crp, /*acc=*/true);
      __syncthreads();
    };

    // -- probability decoder: forward recompute from z1p, then backward ----
    if constexpr (kFromSaves) {
#pragma unroll
      for (int u = 0; u < kTileVecs; ++u) {
        if (kRagged && (int)threadIdx.x + u * kThreadsA >= kVecs) break;
        const int i = (threadIdx.x + u * kThreadsA) * 8, r = i / kG1;
        float z[8] = {};
        if (row_ok(r)) load8(p.z1p + grow(r) * kG1 + i % kG1, z);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          H1[r * kLd1 + i % kG1 + j] = from_f32<T>(leaky(z[j]));
      }
    } else {
      // layer 1 as K1 computes it: the per-ray part RAY = RF @ ray_w1 (in
      // C), then e1 = X @ W_off + RAY + b1 (into the scratch slice) and
      // z1p = X @ W_prob + RAY + b1 (into H1 = act(z1p), over X)
      float* RAY = C;
      // the tile's ray of row r < M (r < 64, spt <= 64): (r * spt_inv) >>
      // 12 is r / spt exactly, as in ray_decode.cu
      const unsigned spt_inv = (4096u + spt - 1) / spt;
      auto ray_of = [&](int r) {
        return min((int)(((unsigned)r * spt_inv) >> 12), MR - 1);
      };
      stage_x();
      __syncthreads();
      product<T, false>(RF, crp, p.ray_w1, 2 * kG1, MR, crp, 2 * kG1, RAY,
                        2 * kG1, false);
      product<T, false>(X, kp, p.pair_w1, 2 * kG1, M, kp, kG1, D, kG1, false,
                        S);
      __syncthreads();
      for (int i = 4 * threadIdx.x; i < M * kG1; i += 4 * blockDim.x) {
        const int r = i / kG1, c = i % kG1;
        st4(E1G + i,
            add4(add4(ld4(D + i), ld4(RAY + ray_of(r) * 2 * kG1 + c)),
                 ld4(p.b1 + c)));
      }
      __syncthreads();
      product<T, false>(X, kp, p.pair_w1 + kG1, 2 * kG1, M, kp, kG1, D, kG1,
                        false, S);
      __syncthreads();
      for (int i = 4 * threadIdx.x; i < M * kG1; i += 4 * blockDim.x) {
        const int r = i / kG1, c = i % kG1;
        st4(H1 + r * kLd1 + c,
            leaky4(add4(add4(ld4(D + i),
                             ld4(RAY + ray_of(r) * 2 * kG1 + kG1 + c)),
                        ld4(p.b1 + kG1 + c))));
      }
    }
    __syncthreads();
    // instance i of a K2 'all' save, at the tile's first row
    auto saved_at = [&](const auto* base, int inst, int width) {
      return base + (inst * p.s_inst + grow(0)) * width;
    };
    if constexpr (kMode == kFromAll) {
      fetch(saved_at(p.s_h2, p.n_iter, kG2), kG2, H2, kLd2, rows_ok, M);
      fetch(saved_at(p.s_h3, p.n_iter, kG3), kG3, H3, kLd3, rows_ok, M);
      for (int r = threadIdx.x; r < M; r += blockDim.x)
        DOFF[r] = dsquash(row_ok(r) ? __ldg(p.s_logit + grow(r)) : 0.f, GL[r],
                          p.use_sigmoid);
    } else {
      tail_forward<T, M, G>(H1, C, H2, H3, S, p.prob, TMP);
      for (int r = threadIdx.x; r < M; r += blockDim.x)
        DOFF[r] = dsquash(TMP[r] + __ldg(p.prob.b4), GL[r], p.use_sigmoid);
    }
    __syncthreads();
    tail_backward<T, M, G>(H1, H2, H3, DOFF, C, D, S, false, nullptr, AV,
                           p.prob,
                        SM + p.small_off[kSProbB2], SM + p.small_off[kSProbB3],
                        SM + p.small_off[kSProbW4], SM + p.small_off[kSProbB4],
                        nullptr, nullptr, tail_out(0, true));
    layer1(1);

    // -- IEF offset decoder: the offsets of every iteration, then backward --
    if constexpr (kMode == kFromAll) {  // the offsets saved, final included
      for (int i = threadIdx.x; i < (p.n_iter + 1) * M; i += blockDim.x) {
        const int it = i / M, r = i % M;
        OFF[i] = row_ok(r) ? __ldg(saved_at(p.s_off, it, 1) + r) : 0.f;
      }
      __syncthreads();
    } else {
      for (int r = threadIdx.x; r < M; r += blockDim.x) OFF[r] = p.init_offset;
    }
    auto ief_h1 = [&](int it) {  // H1 of iteration it
#pragma unroll
      for (int u = 0; u < kTileVecs; ++u) {
        if (kRagged && (int)threadIdx.x + u * kThreadsA >= kVecs) break;
        const int i = (threadIdx.x + u * kThreadsA) * 8, r = i / kG1,
                  c = i % kG1;
        float e[8] = {};
        if (row_ok(r)) {
          if constexpr (kFromSaves) {
            load8(p.e1 + grow(r) * kG1 + c, e);
          } else {  // written by this block: plain loads, not __ldg
            const float4 a = reinterpret_cast<const float4*>(E1G + i)[0];
            const float4 b = reinterpret_cast<const float4*>(E1G + i)[1];
            e[0] = a.x; e[1] = a.y; e[2] = a.z; e[3] = a.w;
            e[4] = b.x; e[5] = b.y; e[6] = b.z; e[7] = b.w;
          }
        }
        const float o = OFF[it * M + r];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          H1[r * kLd1 + c + j] =
              from_f32<T>(leaky(e[j] + o * AV[c + j] + CV[c + j]));
      }
    };
    const float b4 = __ldg(p.off.b4);
    for (int it = 0; kMode != kFromAll && it < p.n_iter; ++it) {
      ief_h1(it);  // then H2, H3 and the tail's output into TMP
      __syncthreads();
      tail_forward<T, M, G>(H1, C, H2, H3, S, p.off, TMP);
      for (int r = threadIdx.x; r < M; r += blockDim.x)
        OFF[(it + 1) * M + r] = (OFF[it * M + r] + TMP[r]) + b4;
      if (it != p.n_iter - 1) {
        // the iteration's activations for its backward, in its streams (h3
        // where T(d_t3) goes later), instead of a second forward
        put(H1, kLd1, inst_at(kH1, 1 + it), kG1, rows_ok);
        put(H2, kLd2, inst_at(kH2, 1 + it), kG2, rows_ok);
        put(H3, kLd3, inst_at(kDt3, 1 + it), kG3, rows_ok);
      }
      __syncthreads();
    }
    for (int r = threadIdx.x; r < M; r += blockDim.x)
      DOFF[r] = dsquash(OFF[p.n_iter * M + r], GO[r], p.use_sigmoid);
    __syncthreads();
    for (int it = p.n_iter - 1; it >= 0; --it) {
      // the last iteration's H1..H3 are still in place from the loop above;
      // the others come back from their streams (kFromAll: h1 from e1 and
      // the saved offset, h2 and h3 from K2 'all''s saves, every iteration)
      const bool last = it == p.n_iter - 1;
      if constexpr (kMode == kFromAll) {
        ief_h1(it);
        fetch(saved_at(p.s_h2, it, kG2), kG2, H2, kLd2, rows_ok, M);
        fetch(saved_at(p.s_h3, it, kG3), kG3, H3, kLd3, rows_ok, M);
        __syncthreads();
      } else if (!last) {
        fetch(inst_at(kH1, 1 + it), kG1, H1, kLd1, rows_ok, M);
        fetch(inst_at(kH2, 1 + it), kG2, H2, kLd2, rows_ok, M);
        fetch(inst_at(kDt3, 1 + it), kG3, H3, kLd3, rows_ok, M);
        __syncthreads();
      }
      tail_backward<T, M, G>(H1, H2, H3, DOFF, C, D, S, !last,
                          OFF + it * M, AV, p.off, SM + p.small_off[kSOffB2],
                          SM + p.small_off[kSOffB3], SM + p.small_off[kSOffW4],
                          SM + p.small_off[kSOffB4], SM + p.small_off[kSAVec],
                          SM + p.small_off[kSCVec],
                          tail_out(1 + it, last || kMode == kFromAll));
    }
    layer1(0);

    // -- d_rows = T(d_e1) @ W1v_off^T + T(d_z1p) @ W1v_prob^T, into D; T(d_z1p)
    // read back from its stream (L2-resident), which leaves shared memory
    // the room for the weight slabs. Rows past rows_ok read whatever the
    // stream holds there and only make rows that are never added.
    product<T, true>(DT, kLd1, p.pair_w1, 2 * kG1, M, kG1, c_vox, D, c_vox,
                     false, S);
    __syncthreads();
    product<T, true>(at(kDeProb), kG1, p.pair_w1 + kG1, 2 * kG1, M, kG1,
                     c_vox, D, c_vox, true, S);
    __syncthreads();
    // the rows of the tile that share a cell: the first is its leader, each
    // links to the next
    for (int r = threadIdx.x; r < M; r += blockDim.x) {
      int lead = 1, next = -1;
      for (int q = 0; q < M && CELL[r] >= 0; ++q) {
        if (q == r || CELL[q] != CELL[r]) continue;
        if (q < r) {
          lead = 0;
        } else if (next < 0) {
          next = q;
        }
      }
      LEAD[r] = CELL[r] >= 0 && lead;
      NEXT[r] = next;
    }
    __syncthreads();
    // each cell's sum into the block's copy of the table: a tile's leaders
    // hold distinct cells, and the block's earlier tiles wrote before the
    // __syncthreads at the top of this one (plain loads, not __ldg)
    float* table = p.table_part + (size_t)blockIdx.x * p.table_stride;
    for (int i = threadIdx.x; i < M * c_vox; i += blockDim.x) {
      const int r = i / c_vox, col = i % c_vox;
      if (!LEAD[r]) continue;
      float s = 0.f;
      for (int q = r; q >= 0; q = NEXT[q]) s += D[q * c_vox + col];
      table[(long long)CELL[r] * c_vox + col] += s;
    }
    for (int i = threadIdx.x; seg == tpr - 1 && i < MR * p.c_ray;
         i += blockDim.x) {
      const int r = i / p.c_ray, col = i % p.c_ray;
      if (r < rays_ok)
        p.d_ray[(p.ray_base + lray0 + r) * p.c_ray + col] =
            DRF[r * crp + col];
    }
  }
  __syncthreads();
  float* part = p.small_part + (size_t)blockIdx.x * p.small_size;
  for (int i = threadIdx.x; i < p.small_size; i += blockDim.x) part[i] += SM[i];
}

// -- Pass B ------------------------------------------------------------------

constexpr int kTileK = 64, kTileN = 128;  // a block's output tile

template <typename T>
struct GemmJob {
  const T* a;          // instance 0 of the A stream (rows x a_w)
  const T* b;          // instance 0 of the B stream (rows x b_w)
  long long a_stride, b_stride;  // elements between instances
  float* p;            // its f32 partials (splits x tiles_k*64 x ld_p)
  long long p_stride;  // floats between splits
  int a_w, b_w, rows, tiles_k, tiles_n, spi, block0, ld_p;
};

template <typename T>
struct GemmParams {
  GemmJob<T> job[kMaxJobs];
  int n_jobs, split_rows;
};

// One block: P[tile] += A[rows]^T B[rows] over its run of rows of one
// instance, both operands staged through shared memory by cp.async in a
// ring of kStages stages of kRowsStage rows, two stages in flight ahead of
// the one in use. bf16: wmma 16x16x16, 8 warps of 32 x 32; f32: 4 x 8 FMA
// micro-tiles a thread. Two blocks an SM.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    pass_b_kernel(const GemmParams<T> gp) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kRowsStage = kBf16 ? 32 : 16, kStages = 3;
  constexpr int kVec = 16 / sizeof(T);  // elements of a 16-byte copy
  constexpr int kLdA = kTileK + kVec, kLdB = kTileN + kVec;
  __shared__ __align__(128) T As[kStages][kRowsStage][kLdA];
  __shared__ __align__(128) T Bs[kStages][kRowsStage][kLdB];

  int j = 0;
  while (j + 1 < gp.n_jobs && (int)blockIdx.x >= gp.job[j + 1].block0) ++j;
  const GemmJob<T>& jb = gp.job[j];
  const int tiles = jb.tiles_k * jb.tiles_n;
  const int local = (int)blockIdx.x - jb.block0;
  const int tile = local % tiles, split = local / tiles;
  const int inst = split / jb.spi;
  const int r0 = (split % jb.spi) * gp.split_rows;
  const int r1 = min(r0 + gp.split_rows, jb.rows);
  if (r0 >= r1) return;
  const int tk = tile % jb.tiles_k, tn = tile / jb.tiles_k;
  const T* A = jb.a + inst * jb.a_stride;
  const T* B = jb.b + inst * jb.b_stride;
  float* P = jb.p + split * jb.p_stride + (size_t)tk * kTileK * jb.ld_p +
             tn * kTileN;
  const int col_a = tk * kTileK, col_b = tn * kTileN;

  // one stage: kRowsStage rows of the A tile (256 16-byte pieces) and of the
  // B tile (512), zero past the rows or the widths
  auto load = [&](int buf, int row0) {
    {
      const int i = threadIdx.x;
      const int rr = i / (kTileK / kVec), cc = (i % (kTileK / kVec)) * kVec;
      const int row = row0 + rr;
      const bool ok = row < r1 && col_a + cc < jb.a_w;
      cp_async16(&As[buf][rr][cc],
                 ok ? A + (size_t)row * jb.a_w + col_a + cc : A, ok);
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int rr = i / (kTileN / kVec), cc = (i % (kTileN / kVec)) * kVec;
      const int row = row0 + rr;
      const bool ok = row < r1 && col_b + cc < jb.b_w;
      cp_async16(&Bs[buf][rr][cc],
                 ok ? B + (size_t)row * jb.b_w + col_b + cc : B, ok);
    }
  };
  const int stages = (r1 - r0 + kRowsStage - 1) / kRowsStage;
  // stage s in buffer s % kStages; every iteration commits one group (empty
  // past the end), so that waiting for all but the newest one leaves stage
  // s complete
  auto run_stages = [&](auto&& compute) {
    load(0, r0);
    cp_commit();
    if (stages > 1) load(1, r0 + kRowsStage);
    cp_commit();
    for (int s = 0; s < stages; ++s) {
      cp_wait<1>();
      __syncthreads();  // stage s is in; every warp is done with stage s - 1
      if (s + 2 < stages)
        load((s + 2) % kStages, r0 + (s + 2) * kRowsStage);
      cp_commit();
      compute(s % kStages);
    }
  };

  if constexpr (kBf16) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32;
    const int wm = warp % 2, wn = warp / 2;  // 2 x 4 warps of 32 x 32
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int k = 0; k < 2; ++k)
        wmma::load_matrix_sync(acc[i][k],
                               P + (wm * 32 + i * 16) * jb.ld_p + wn * 32 +
                                   k * 16,
                               jb.ld_p, wmma::mem_row_major);
    run_stages([&](int buf) {
#pragma unroll
      for (int kk = 0; kk < kRowsStage; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], &As[buf][kk][wm * 32 + i * 16], kLdA);
#pragma unroll
        for (int k = 0; k < 2; ++k)
          wmma::load_matrix_sync(b[k], &Bs[buf][kk][wn * 32 + k * 16], kLdB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int k = 0; k < 2; ++k) wmma::mma_sync(acc[i][k], a[i], b[k],
                                                      acc[i][k]);
      }
    });
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int k = 0; k < 2; ++k)
        wmma::store_matrix_sync(P + (wm * 32 + i * 16) * jb.ld_p + wn * 32 +
                                    k * 16,
                                acc[i][k], jb.ld_p, wmma::mem_row_major);
  } else {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;  // 4 x 8 each
    float acc[4][8] = {};
    run_stages([&](int buf) {
#pragma unroll 4
      for (int kk = 0; kk < kRowsStage; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
        const float4 b0 =
            *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 8]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 8 + 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[i][k] = fmaf(av[i], bv[k], acc[i][k]);
      }
    });
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 8; ++k) P[(ty * 4 + i) * jb.ld_p + tx * 8 + k] +=
                                      acc[i][k];
  }
}

// -- the reduction -------------------------------------------------------------

struct Red {
  long long src, stride, dst;  // float offsets; floats between partials
  int splits, k, n, ld_src, ld_dst;
};
struct RedParams {
  Red r[kMaxReds];
};

// out[dst + i * ld_dst + j] = sum over t < splits, in order, of
// P[src + t * stride + i * ld_src + j], for each reduction blockIdx.y
__global__ void reduce_kernel(const float* __restrict__ P,
                              float* __restrict__ out, const RedParams rp) {
  const Red& r = rp.r[blockIdx.y];
  const long long total = (long long)r.k * r.n;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long i = e / r.n, j = e % r.n;
    const float* src = P + r.src + i * r.ld_src + j;
    float s = 0.f;
    for (int t = 0; t < r.splits; ++t) s += src[(long long)t * r.stride];
    out[r.dst + i * r.ld_dst + j] = s;
  }
}

// -- the host side -------------------------------------------------------------

// Pass A's dynamic shared memory (bytes) at these widths
template <typename T, int M, int G>
size_t pass_a_smem(int crp, int n_iter, int small_size) {
  if constexpr (M == 64)
    return WgSmem<G>(crp, n_iter, small_size).total;
  else
    return BwdSmem<T, M, G>(crp, n_iter, small_size).total;
}

int stream_width(int s, int kp, int crp, int g) {
  switch (s) {
    case kX: return kp;
    case kRf: return crp;
    case kDt2: case kH2: return 2 * g;
    case kDt3: return g;
    default: return 4 * g;
  }
}
bool is_per_ray(int s) { return s == kRf || s == kDreOff || s == kDreProb; }

template <typename T, int M, int kMode, int G>
int run_passes(BwdParams<T> p, const long long* plan, long long n,
               T* scratch, float* partials, float* d_w, float* d_table,
               cudaEvent_t const* events, cudaStream_t stream) {
  const long long chunk = plan[kChunkRays];
  const int n_chunks = (int)plan[kNChunks], blocks_a = (int)plan[kBlocksA];
  const int n_jobs = (int)plan[kNJobs], n_reds = (int)plan[kNReds];
  const long long table_elems = plan[kTableElems];
  p.rays = rays_per_tile(p.kb, M, BwdSmem<T, M, G>::kMR);
  p.spt = p.kb < M ? p.kb : M;
  p.tpr = (p.kb + M - 1) / M;
  if (plan[kRowsPerTile] != M || plan[kNInst] != p.n_iter + 1 ||
      plan[kRaysPerTile] != p.rays || plan[kTilesPerRay] != p.tpr ||
      (M == kMaxKb && p.tpr != 1) || p.kp > max_kp<M>() ||
      p.c_vox > max_cvox<M>() ||
      n_jobs > kMaxJobs || n_reds > kMaxReds || chunk % p.rays ||
      chunk * n_chunks < n || blocks_a < 1 ||
      plan[kTableStride] < table_elems || table_elems % p.c_vox ||
      table_elems > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  p.n_vblocks = blocks_a;
  p.table_part = partials + plan[kTableOff];
  p.table_stride = plan[kTableStride];
  for (int s = 0; s < kStreams; ++s) {
    p.stream[s] = scratch + plan[kStreamOff + s];
    p.inst_stride[s] = (is_per_ray(s) ? chunk * p.tpr : chunk * p.kb) *
                       stream_width(s, p.kp, p.crp, G);
  }
  for (int s = 0; s < kSmall; ++s) p.small_off[s] = (int)plan[kSmallOff + s];
  p.small_size = (int)plan[kSmallSize];
  p.small_part = partials + plan[kSmallBase];

  GemmParams<T> gp;
  gp.n_jobs = n_jobs;
  gp.split_rows = (int)plan[kSplitRows];
  const long long* jobs = plan + kHeader;
  for (int j = 0; j < n_jobs; ++j) {
    const long long* f = jobs + j * kJobFields;
    const int sa = (int)f[0], sb = (int)f[1];
    GemmJob<T>& g = gp.job[j];
    g.a_w = stream_width(sa, p.kp, p.crp, G);
    g.b_w = stream_width(sb, p.kp, p.crp, G);
    g.a_stride = p.inst_stride[sa];
    g.b_stride = p.inst_stride[sb];
    g.a = p.stream[sa] + f[2] * g.a_stride;
    g.b = p.stream[sb] + f[2] * g.b_stride;
    g.tiles_k = (int)f[4];
    g.tiles_n = (int)f[5];
    g.spi = (int)f[6];
    g.ld_p = g.tiles_n * kTileN;
    g.p_stride = (long long)g.tiles_k * kTileK * g.ld_p;
    g.p = partials + f[7];
    g.block0 = (int)f[8];
  }
  RedParams rp;
  const long long* reds = jobs + n_jobs * kJobFields;
  for (int r = 0; r < n_reds; ++r) {
    const long long* f = reds + r * kRedFields;
    rp.r[r] = Red{f[0], f[1], f[2], (int)f[3], (int)f[4], (int)f[5],
                  (int)f[6], (int)f[7]};
  }

  // the 64-row instance keeps the IEF's d_z1 in a global scratch
  if (M == 64 && p.e1_scratch == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(
      partials, 0, (size_t)plan[kPartialFloats] * sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = pass_a_smem<T, M, G>(p.crp, p.n_iter, p.small_size);
  if (smem > kMaxSmemA) return (int)cudaErrorInvalidValue;
  auto ka = pass_a_kernel<T, M, kMode, G>;
  err = cudaFuncSetAttribute(ka, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  // measurement: events[0] before the first pass, then after each pass
  auto mark = [&](int i) {
    if (events != nullptr) cudaEventRecord(events[i], stream);
  };
  mark(0);
  for (int c = 0; c < n_chunks; ++c) {
    p.ray_base = c * chunk;
    p.row_base = p.ray_base * p.kb;
    p.n_chunk = n - p.ray_base < chunk ? n - p.ray_base : chunk;
    ka<<<M == 64 ? (blocks_a + kSlotsW - 1) / kSlotsW : blocks_a,
         M == 64 ? kThreadsW : kThreadsA, smem, stream>>>(p);
    mark(1 + 2 * c);
    for (int j = 0; j < n_jobs; ++j)
      gp.job[j].rows = (int)(is_per_ray((int)jobs[j * kJobFields])
                                 ? p.n_chunk * p.tpr
                                 : p.n_chunk * p.kb);
    pass_b_kernel<T><<<(unsigned)plan[kBlocksB], kThreads, 0, stream>>>(gp);
    mark(2 + 2 * c);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  reduce_kernel<<<dim3(64, n_reds), kThreads, 0, stream>>>(partials, d_w, rp);
  // the blocks' copies of d_vox_table, in block order
  RedParams rt;
  rt.r[0] = Red{plan[kTableOff], plan[kTableStride], 0, blocks_a, 1,
                (int)table_elems, (int)table_elems, (int)table_elems};
  const long long grid = (table_elems + kThreads - 1) / kThreads;
  reduce_kernel<<<dim3((unsigned)(grid < 1024 ? grid : 1024), 1), kThreads, 0,
                  stream>>>(partials, d_table, rt);
  mark(1 + 2 * n_chunks);
  return (int)cudaGetLastError();
}

template <typename T>
int run(void* const* ptrs, const long long* plan, long long n_plan,
        long long n, long long c_vox, long long c_ray, long long multires,
        long long kp, long long crp, long long n_iter, long long g,
        long long use_sigmoid, float init_offset, cudaEvent_t const* events,
        cudaStream_t stream) {
  BwdParams<T> p;
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
  p.e1 = (const T*)ptrs[21];
  p.z1p = (const T*)ptrs[22];
  p.trig = (const T*)ptrs[23];
  p.g = (const float*)ptrs[24];
  float* d_table = (float*)ptrs[25];
  p.d_ray = (float*)ptrs[26];
  float* d_w = (float*)ptrs[27];
  T* scratch = (T*)ptrs[28];
  float* partials = (float*)ptrs[29];
  p.e1_scratch = (float*)ptrs[30];
  p.s_off = (const float*)ptrs[31];
  p.s_h2 = (const T*)ptrs[32];
  p.s_h3 = (const T*)ptrs[33];
  p.s_logit = (const float*)ptrs[34];
  if (n_plan < kHeader) return (int)cudaErrorInvalidValue;
  p.kb = (int)plan[kSlots];
  p.s_inst = n * p.kb;
  p.c_vox = (int)c_vox;
  p.c_ray = (int)c_ray;
  p.multires = (int)multires;
  p.kp = (int)kp;
  p.crp = (int)crp;
  p.n_iter = (int)n_iter;
  p.use_sigmoid = (int)use_sigmoid;
  p.init_offset = init_offset;
  if (kp % 16 || crp % 16 || kp < c_vox + 6 + 12 * multires || crp < c_ray ||
      c_vox % 8 || n_iter < 1 || n < 1 || p.kb < 1 || p.kb > kMaxKb)
    return (int)cudaErrorInvalidValue;
  if (n_plan != kHeader + plan[kNJobs] * kJobFields + plan[kNReds] * kRedFields)
    return (int)cudaErrorInvalidValue;
  const bool from_saves = p.e1 != nullptr;
  const bool from_all = p.s_off != nullptr;
  if (from_saves ? (p.z1p == nullptr || p.trig == nullptr)
                 : (p.e1_scratch == nullptr || from_all))
    return (int)cudaErrorInvalidValue;
  if (from_all && (p.s_h2 == nullptr || p.s_h3 == nullptr ||
                   p.s_logit == nullptr))
    return (int)cudaErrorInvalidValue;
  // the tile's rows: the plan's (64, 32 or 16: held)
  auto at_rows = [&](auto m) {
    constexpr int M = decltype(m)::value;
    return with_width(g, [&](auto w) {
      constexpr int G = decltype(w)::value;
      if constexpr (!held<T, M, G>()) {
        return (int)cudaErrorInvalidValue;
      } else {
        if (from_all)
          return run_passes<T, M, kFromAll, G>(p, plan, n, scratch, partials,
                                               d_w, d_table, events, stream);
        return from_saves
                   ? run_passes<T, M, kFromL1, G>(p, plan, n, scratch,
                                                  partials, d_w, d_table,
                                                  events, stream)
                   : run_passes<T, M, kRecompute, G>(p, plan, n, scratch,
                                                     partials, d_w, d_table,
                                                     events, stream);
      }
    });
  };
  if (plan[kRowsPerTile] == 32)
    return at_rows(std::integral_constant<int, 32>{});
  if (plan[kRowsPerTile] == 16)
    return at_rows(std::integral_constant<int, 16>{});
  if constexpr (sizeof(T) == 2) {
    if (plan[kRowsPerTile] == 64)
      return at_rows(std::integral_constant<int, 64>{});
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// ptrs: vox_table, cells, pos, ray_feat, pair_w1, ray_w1, b1, a_vec, c_vec,
// off_{w2,b2,w3,b3,w4,b4}, prob_{w2,b2,w3,b3,w4,b4} (as for idt_ray_decode),
// e1, z1p, trig (K2's saves; all null for the recompute instance), g (n, kb,
// 2) f32 cotangents, d_table (S, c_vox) f32, d_ray (n, c_ray) f32, d_w (the
// weight gradients, f32, in ops/ray_decode.py::bwd_grad_layout), scratch
// (the streams, T), partials (f32), e1_scratch (f32: at 64 rows
// (blocks, wg_scratch_floats); at 32 and 16 (blocks, rows per tile, 4g) for
// the recompute instance, else null), then K2 'all''s off (n_iter + 1, n*kb)
// f32, h2 (n_iter + 1, n*kb, 2g), h3 (n_iter + 1, n*kb, g) and
// logit (n*kb,) f32 for the instance from full saves (else null): 35 device
// pointers; n rays of kb pair slots, kb (1 <= kb <= kMaxKb) in the plan.
// plan: ops/ray_decode.py::pack_bwd_plan (n_plan int64). events:
// null, or 2 * n_chunks + 2 CUDA events recorded before the first pass and
// after each pass, for measurement. g: imnet_gf, in {8, 16, 32, 64, 128}
// (the library's width). Returns a cudaError_t.
extern "C" int idt_ray_decode_bwd(void* const* ptrs, const long long* plan,
                                  long long n_plan, long long n,
                                  long long c_vox, long long c_ray,
                                  long long multires, long long kp,
                                  long long crp, long long n_iter, long long g,
                                  long long is_bf16, long long use_sigmoid,
                                  float init_offset, void* const* events,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaEvent_t const* ev = (cudaEvent_t const*)events;
  return is_bf16 ? run<__nv_bfloat16>(ptrs, plan, n_plan, n, c_vox, c_ray,
                                      multires, kp, crp, n_iter, g,
                                      use_sigmoid, init_offset, ev, s)
                 : run<float>(ptrs, plan, n_plan, n, c_vox, c_ray, multires,
                              kp, crp, n_iter, g, use_sigmoid, init_offset,
                              ev, s);
}

// Dynamic shared memory (bytes) of one Pass A block of M (64, 32 or 16)
// rows at these widths, or -1 for an instance this library does not hold
// (ops/ray_decode.py::bwd_smem mirrors it).
extern "C" long long idt_ray_decode_bwd_smem(long long m, long long crp,
                                             long long n_iter,
                                             long long small_size,
                                             long long g, long long is_bf16) {
  auto size = [&](auto t, auto rows) -> long long {
    using T = decltype(t);
    constexpr int M = decltype(rows)::value;
    return with_width(g, [&](auto w) -> int {
      constexpr int G = decltype(w)::value;
      if constexpr (!held<T, M, G>()) {
        return -1;
      } else {
        return (int)pass_a_smem<T, M, G>((int)crp, (int)n_iter,
                                         (int)small_size);
      }
    });
  };
  long long r = -1;
  if (m == 32)
    r = is_bf16 ? size(__nv_bfloat16(), std::integral_constant<int, 32>{})
                : size(0.f, std::integral_constant<int, 32>{});
  else if (m == 16)
    r = is_bf16 ? size(__nv_bfloat16(), std::integral_constant<int, 16>{})
                : size(0.f, std::integral_constant<int, 16>{});
  else if (m == 64 && is_bf16)
    r = size(__nv_bfloat16(), std::integral_constant<int, 64>{});
  // with_width's error code for another width: no block is that small
  return r < 128 ? -1 : r;
}

// Pass A blocks of M rows (64, 32 or 16) that one SM holds at once at these
// widths (the instance from K2's saves; every instance has the same
// registers and shared memory), or -1 for an instance this library does
// not hold or a CUDA error
extern "C" long long idt_ray_decode_bwd_blocks_per_sm(long long m,
                                                      long long crp,
                                                      long long n_iter,
                                                      long long small_size,
                                                      long long g,
                                                      long long is_bf16) {
#ifdef IDT_GF
  if (g != IDT_GF) return -1;  // another library's width
#endif
  auto blocks = [&](auto t, auto rows) -> long long {
    using T = decltype(t);
    constexpr int M = decltype(rows)::value;
    return with_width(g, [&](auto w) -> int {
      constexpr int G = decltype(w)::value;
      if constexpr (!held<T, M, G>()) {
        return -1;
      } else {
        const int smem = (int)pass_a_smem<T, M, G>((int)crp, (int)n_iter,
                                                   (int)small_size);
        auto ka = pass_a_kernel<T, M, kFromL1, G>;
        int n = 0;
        if (cudaFuncSetAttribute(
                ka, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) ||
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, ka, M == 64 ? kThreadsW : kThreadsA, smem))
          return -1;
        return n;
      }
    });
  };
  long long r = -1;
  if (m == 32)
    r = is_bf16 ? blocks(__nv_bfloat16(), std::integral_constant<int, 32>{})
                : blocks(0.f, std::integral_constant<int, 32>{});
  else if (m == 16)
    r = is_bf16 ? blocks(__nv_bfloat16(), std::integral_constant<int, 16>{})
                : blocks(0.f, std::integral_constant<int, 16>{});
  else if (m == 64 && is_bf16)
    r = blocks(__nv_bfloat16(), std::integral_constant<int, 64>{});
  return r;
}
