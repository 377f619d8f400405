// Staged tensor-core tiles of the bf16 decode kernels on Hopper
// (ray_decode.cu = K1/K2, ief_decode.cu = K4, pair_decode.cu = K6).
//
// What this replaced, and why (scripts/attribute_k1_k4.py on the first
// versions, PERF.md): the first kernels' wmma products (a routine since
// removed from decode_common.cuh) read every 16x16 weight fragment straight
// from L2, one k-step at a time, in each of the four row-tile warps that
// need it, and stored every product's f32 accumulators to a 64 KB shared
// scratch that an elementwise pass read back; together with the f32 E1 that
// left one 256-thread block per SM. Here:
//   * one block per SM walks row tiles (a persistent grid); every product's
//     weights pass through shared memory in slabs of 16-128 k-rows (kRing
//     of them, cp.async), taken from a cyclic schedule of segments (Seg):
//     each product consumes its segment's slabs in order, and every
//     acquire() refills the slot freed by the slab before, so the next
//     product's first slabs, and the next tile's, are in flight while the
//     current one computes. Each weight element leaves L2 once per tile, in
//     16-byte pieces, and is used by every warp that needs it;
//   * products run on mma.sync.m16n8k16 (bf16 in, f32 accumulators), with
//     both operands loaded from shared memory by ldmatrix (B transposed on
//     the fly from the slabs' row-major [k][n] layout), an 8-warp grid of
//     2 x 4 warps over a 64-row tile. mma.sync rather than wgmma: its
//     accumulator layout is documented per thread, so every epilogue (bias,
//     per-ray part, LeakyReLU, bf16 rounding, K2's saves, layer 4) runs on
//     the registers and writes only the bf16 activation; at the kernel's
//     ~10x distance from its bound the simpler instruction suffices;
//   * E1, the IEF's iteration-invariant layer-1 pre-activation, stays in
//     the registers of the warps that computed it (64 a thread) for both
//     iterations: the 1-block-per-SM launch gives each thread up to 255;
//   * layer 4 (64 -> 1) is folded into the epilogue of the 128 -> 64
//     product: h3 never goes to shared memory.
// Every row of a tile in shared memory has kPad elements past its width,
// so the eight 16-byte rows of one ldmatrix fall on distinct banks.
#pragma once

#include "decode_common.cuh"

namespace idt {
namespace tile {

using bf16 = __nv_bfloat16;

constexpr int kM = 64;           // rows of a tile
constexpr int kWN = 4;           // warps along N in the 64-row products
constexpr int kRing = 3;         // weight slabs in shared memory
constexpr int kSlabElems = 9216; // elements of one slab (18,432 bytes)
constexpr int kMaxSegs = 24;     // segments of a schedule
constexpr int kPad = 8;          // elements past the width of each row
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory of one block

__host__ __device__ constexpr int ld_of(int width) { return width + kPad; }
// k-rows of one slab of a product N wide: 16 (N 512), 32 (256), 64 (128),
// 128 (64)
__host__ __device__ constexpr int slab_rows(int n) {
  return kSlabElems / (n + kPad) / 16 * 16;
}

// One product's weights: k x n of row stride ldw (elements, bf16, 16-byte
// aligned rows).
struct Seg {
  const bf16* w;
  long long ldw;
  int k, n;
};

// -- PTX ----------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared, asynchronously; zeros where !pred (src must
// still be a global address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// four 8x8 b16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&b0)[2], uint32_t (&b1)[2],
                                          const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b0[0]), "=r"(b0[1]), "=r"(b1[0]), "=r"(b1[1])
      : "r"(smem_u32(p)));
}
// d (16x8 f32) += a (16x16 bf16, row) @ b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two consecutive f32 of a read-only array (8-byte aligned)
__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void st_bf16x2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// -- the weight pipeline --------------------------------------------------------

// A ring of kRing slabs fed from a cyclic schedule of segments (the products
// of one tile, in order). Every thread of the block holds the same state
// and calls every method: start() once, then acquire() once per slab.
struct Pipe {
  bf16* ring;
  const Seg* segs;
  int nsegs, iseg, ik0, ibuf, cbuf;

  __device__ void init(bf16* r, const Seg* s, int n) {
    ring = r;
    segs = s;
    nsegs = n;
    iseg = ik0 = ibuf = cbuf = 0;
  }
  // the next slab of the schedule into the next slot, as one cp.async
  // group (with whatever the caller issued since the last one)
  __device__ void issue() {
    const Seg s = segs[iseg];
    // thread i copies the 16-byte pieces q = i % (n / 8) of rows i / (n / 8),
    // + step, ... (n / 8 a power of two, at most blockDim.x)
    const int lg = __ffs(s.n >> 3) - 1, lds = ld_of(s.n);
    const int q = threadIdx.x & ((1 << lg) - 1), r0 = threadIdx.x >> lg;
    const int step = blockDim.x >> lg, rows = min(slab_rows(s.n), s.k - ik0);
    bf16* dst = ring + ibuf * kSlabElems + r0 * lds + q * 8;
    const bf16* src = s.w + (long long)(ik0 + r0) * s.ldw + q * 8;
    for (int r = r0; r < rows; r += step) {
      cp_async16(dst, src, true);
      dst += step * lds;
      src += step * s.ldw;
    }
    cp_commit();
    ik0 += slab_rows(s.n);
    if (ik0 >= s.k) {
      ik0 = 0;
      if (++iseg == nsegs) iseg = 0;
    }
    if (++ibuf == kRing) ibuf = 0;
  }
  __device__ void start() {
    for (int i = 0; i < kRing - 1; ++i) issue();
  }
  // the oldest slab, landed and visible to the block; also makes every
  // shared-memory write before it visible, and refills the slot that all
  // warps have finished with
  __device__ const bf16* acquire() {
    cp_wait<kRing - 2>();
    __syncthreads();
    issue();
    const bf16* s = ring + cbuf * kSlabElems;
    if (++cbuf == kRing) cbuf = 0;
    return s;
  }
  __device__ void drain() { cp_wait<0>(); }
};

// -- products -------------------------------------------------------------------

// acc = A[(8 / WN) * MT * 16 rows x k] (bf16, shared, lda) @ the next k rows
// of the pipe's weights (N = WN * NT * 8 wide). Warp w owns rows
// (w / WN) * MT * 16.. and columns (w % WN) * NT * 8..; its accumulators
// follow the m16n8 layout (see for_pairs).
template <int MT, int NT, int WN>
__device__ __forceinline__ void product(Pipe& pipe, const bf16* A, int lda,
                                        int k, float (&acc)[MT][NT][4]) {
  static_assert(NT % 2 == 0 && kWarps % WN == 0, "warp grid");
  constexpr int kN = WN * NT * 8, ks = slab_rows(kN), lds = ld_of(kN);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / WN, wn = warp % WN;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][n][j] = 0.f;
  const bf16* a0 = A + (wm * MT * 16 + (lane & 15)) * lda + (lane >> 4) * 8;
  const int boff = (lane & 15) * lds + wn * NT * 8 + (lane >> 4) * 8;
  for (int k0 = 0; k0 < k; k0 += ks) {
    const bf16* sb = pipe.acquire() + boff;
    const bf16* ap = a0 + k0;
    const int kn = min(ks, k - k0);
#pragma unroll 2
    for (int kk = 0; kk < kn; kk += 16) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int m = 0; m < MT; ++m) ldsm_x4(a[m], ap + m * 16 * lda + kk);
#pragma unroll
      for (int n = 0; n < NT; n += 2) ldsm_x4_t(b[n], b[n + 1], sb + kk * lds + n * 8);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n) mma16816(acc[m][n], a[m], b[n]);
    }
  }
}

// f(row, col, v0, v1) for each pair of this thread's accumulators of a
// product<MT, NT, WN>: elements (row, col) and (row, col + 1) of its output
template <int MT, int NT, int WN, class F>
__device__ __forceinline__ void for_pairs(float (&acc)[MT][NT][4], F&& f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = (warp / WN) * MT * 16 + (lane >> 2);
  const int c0 = (warp % WN) * NT * 8 + 2 * (lane & 3);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(r0 + m * 16 + 8 * h, c0 + n * 8, acc[m][n][2 * h],
          acc[m][n][2 * h + 1]);
}

// -- the MLP tail ----------------------------------------------------------------

// Layers 2-4 of one decoder (256 -> 128 -> 64 -> 1) from the bf16 layer-1
// activation H (kM x 256, ld_of(256)); H2 (kM x 128) scratch; L4 (kWN x kM
// f32) the layer-4 partial sums. out[row] = (accumulate ? out[row] : 0) +
// layer 4, then + b4, as decode_common.cuh::mlp_tail and its callers.
// kSaveAll (K2 'all'): also the tile's first s_rows rows of h2 and h3 to
// s_h2 (kG2 a row) and s_h3 (kG3 a row) in device memory: h2 from its
// shared tile after the next product's barrier, 16 bytes a thread; h3,
// which never reaches shared memory, from the layer-3 epilogue's registers.
template <bool kSaveAll = false>
__device__ __forceinline__ void tail(Pipe& pipe, const bf16* H, bf16* H2,
                                     float* L4, const TailWeights<bf16>& w,
                                     float* out, bool accumulate,
                                     bf16* s_h2 = nullptr,
                                     bf16* s_h3 = nullptr, int s_rows = 0) {
  {
    float acc[2][4][4];
    product<2, 4, kWN>(pipe, H, ld_of(kG1), kG1, acc);
    for_pairs<2, 4, kWN>(acc, [&](int r, int c, float v0, float v1) {
      const float2 b = ldg2(w.b2 + c);
      st_bf16x2(H2 + r * ld_of(kG2) + c, leaky(v0 + b.x), leaky(v1 + b.y));
    });
  }
  {
    // layer 3's accumulators -> h3 (rounded) -> its dot with w4 over this
    // thread's 4 columns of each row, then over the quad's 16
    float acc[2][2][4];
    product<2, 2, kWN>(pipe, H2, ld_of(kG2), kG2, acc);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r0 = (warp / kWN) * 32 + (lane >> 2);
    const int c0 = (warp % kWN) * 16 + 2 * (lane & 3);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float s = 0.f;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          float hv[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = c0 + n * 8 + j;
            const float h3 = bf16_round(leaky(acc[m][n][2 * h + j] + __ldg(w.b3 + c)));
            hv[j] = h3;
            s = fmaf(h3, ldg_f32(w.w4 + c), s);
          }
          if constexpr (kSaveAll) {
            const int r = r0 + m * 16 + 8 * h;
            if (r < s_rows) st_bf16x2(s_h3 + r * kG3 + c0 + n * 8, hv[0], hv[1]);
          }
        }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if ((lane & 3) == 0) L4[(warp % kWN) * kM + r0 + m * 16 + 8 * h] = s;
      }
  }
  if constexpr (kSaveAll) {
    // every warp has passed the product's acquire() since the layer-2
    // epilogue wrote H2, and nothing writes it again before the barrier
    // below
    for (int i = threadIdx.x; i < s_rows * (kG2 / 8); i += blockDim.x) {
      const int r = i / (kG2 / 8), q = i % (kG2 / 8);
      *reinterpret_cast<uint4*>(s_h2 + r * kG2 + q * 8) =
          *reinterpret_cast<const uint4*>(H2 + r * ld_of(kG2) + q * 8);
    }
  }
  __syncthreads();
  if (threadIdx.x < kM) {
    float s = L4[threadIdx.x];
#pragma unroll
    for (int g = 1; g < kWN; ++g) s += L4[g * kM + threadIdx.x];
    const float o = accumulate ? out[threadIdx.x] + s : s;
    out[threadIdx.x] = o + __ldg(w.b4);
  }
  __syncthreads();
}

// The IEF offset loop from E1, this thread's accumulators of the 64 x 256
// layer-1 pre-activation (iteration-invariant): per iteration
//   h1 = bf16(act(e1 + offset * a_vec + c_vec)) -> H, then the tail into
//   offset (OFF, f32 in shared memory, initialised by the caller).
// kSaveAll (K2 'all'): iteration it also stores the offset entering it and
// its h2, h3 (tail<true>) for the tile's first s_rows rows, at s_off, s_h2,
// s_h3 (the tile's first row) plus it * s_inst rows.
template <bool kSaveAll = false>
__device__ __forceinline__ void ief(Pipe& pipe, float (&e1)[2][8][4], bf16* H,
                                    bf16* H2, float* L4,
                                    const float* __restrict__ a_vec,
                                    const float* __restrict__ c_vec,
                                    const TailWeights<bf16>& w, float* OFF,
                                    int n_iter, float* s_off = nullptr,
                                    bf16* s_h2 = nullptr, bf16* s_h3 = nullptr,
                                    long long s_inst = 0, int s_rows = 0) {
  for (int it = 0; it < n_iter; ++it) {
    if constexpr (kSaveAll) {  // OFF[t] was last written by thread t
      if ((int)threadIdx.x < s_rows)
        s_off[it * s_inst + threadIdx.x] = OFF[threadIdx.x];
    }
    for_pairs<2, 8, kWN>(e1, [&](int r, int c, float v0, float v1) {
      const float o = OFF[r];
      const float2 a = ldg2(a_vec + c), cv = ldg2(c_vec + c);
      st_bf16x2(H + r * ld_of(kG1) + c, leaky(v0 + o * a.x + cv.x),
                leaky(v1 + o * a.y + cv.y));
    });
    if constexpr (kSaveAll)
      tail<true>(pipe, H, H2, L4, w, OFF, /*accumulate=*/true,
                 s_h2 + it * s_inst * kG2, s_h3 + it * s_inst * kG3, s_rows);
    else
      tail(pipe, H, H2, L4, w, OFF, /*accumulate=*/true);
  }
}

// -- input staging -----------------------------------------------------------------

// Rows [0, valid) of a dense bf16 block (row width c, starting at src,
// 16-byte aligned: rows follow each other without padding) into columns
// col0.. of the shared rows dst (stride ld), with 16-byte loads; rows
// [valid, rows) get zeros.
__device__ __forceinline__ void stage_rows(const bf16* src, int valid,
                                           int rows, int c, bf16* dst, int ld,
                                           int col0) {
  const int total = valid * c, chunks = total / 8;
  constexpr int kU = 4;  // loads in flight a thread
  for (int base = threadIdx.x; base < chunks; base += kU * blockDim.x) {
    uint4 u[kU];
#pragma unroll
    for (int q = 0; q < kU; ++q) {
      const int i = base + q * blockDim.x;
      if (i < chunks) u[q] = __ldg(reinterpret_cast<const uint4*>(src) + i);
    }
#pragma unroll
    for (int q = 0; q < kU; ++q) {
      const int i = base + q * blockDim.x;
      if (i >= chunks) break;
      const bf16* e = reinterpret_cast<const bf16*>(&u[q]);
      int r = i * 8 / c, col = i * 8 - r * c;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        dst[r * ld + col0 + col] = e[j];
        if (++col == c) {
          col = 0;
          ++r;
        }
      }
    }
  }
  for (int i = chunks * 8 + threadIdx.x; i < total; i += blockDim.x) {
    const int r = i / c;
    dst[r * ld + col0 + i - r * c] = ldg_raw(src + i);
  }
  for (int i = threadIdx.x; i < (rows - valid) * c; i += blockDim.x) {
    const int r = valid + i / c;
    dst[r * ld + col0 + i % c] = __float2bfloat16_rn(0.f);
  }
}

// c elements (c % 8 == 0) of row r from row_ptr(r) (a global pointer, 16-byte
// aligned, or null for a row of zeros) into columns [0, c) of the shared rows
// dst (stride ld), for r < rows, by cp.async: the copies complete with the
// pipe's next slab group. any: a valid global address (read by no copy).
template <class RowPtr>
__device__ __forceinline__ void rows_async(RowPtr row_ptr, int rows, int c,
                                           bf16* dst, int ld, const bf16* any) {
  const int per = c / 8;
  for (int i = threadIdx.x; i < rows * per; i += blockDim.x) {
    const int r = i / per, q = i - r * per;
    const bf16* s = row_ptr(r);
    cp_async16(dst + r * ld + q * 8, s ? s + q * 8 : any, s != nullptr);
  }
}

// -- shared memory -----------------------------------------------------------------

// Byte offsets of the regions of a bf16 decode block (mirrored by
// ops/ray_decode.py::decode_plan). kp: the layer-1 input width (X); crp:
// K1's per-ray input width (0 for K4 and K6, which have no per-ray part).
struct Smem {
  size_t x0, x1, rf, ray, h, h2, ring, off, logit, l4, segs, total;
  __host__ __device__ static size_t al(size_t b) {
    return (b + 127) / 128 * 128;
  }
  __host__ __device__ Smem(int kp, int crp) {
    size_t o = 0;
    const size_t xb = (size_t)kM * ld_of(kp) * 2;
    x0 = o;    // layer-1 input of the even tiles
    o = al(o + xb);
    x1 = o;    // of the odd tiles (loaded while the even ones run)
    o = al(o + xb);
    rf = o;    // per-ray inputs, 8 rays padded to 16 rows
    o = al(o + (crp ? (size_t)16 * ld_of(crp) * 2 : 0));
    ray = o;   // per-ray layer-1 part, f32 (8 rays x 512)
    o = al(o + (crp ? (size_t)8 * 2 * kG1 * 4 : 0));
    h = o;     // bf16 layer-1 activation
    o = al(o + (size_t)kM * ld_of(kG1) * 2);
    h2 = o;    // bf16 layer-2 activation
    o = al(o + (size_t)kM * ld_of(kG2) * 2);
    ring = o;  // weight slabs
    o = al(o + (size_t)kRing * kSlabElems * 2);
    off = o;
    o = al(o + kM * 4);
    logit = o;
    o = al(o + kM * 4);
    l4 = o;    // layer-4 partial sums
    o = al(o + kWN * kM * 4);
    segs = o;
    o = al(o + kMaxSegs * sizeof(Seg));
    total = o;
  }
};

}  // namespace tile
}  // namespace idt
