// K3's Pass A at 64 rows a tile in bf16 (imnet_gf <= 64, kp <= 400, c_vox
// <= 256): the instance the plan takes wherever its block fits
// (ops/ray_decode.py::bwd_rows), for every save mode and every kb. It
// computes what the 32- and 16-row instances of ray_decode_bwd.cu compute,
// with the same roundings to T, and writes the same streams, but:
//   * a block (512 threads, one an SM) holds two tiles in flight, each run
//     by its own two warpgroups on its own regions of shared memory (a tile
//     slot: a Pass A block of the plan, with its own partial sums, copy of
//     d_vox_table and global scratch); the two share the weight slabs and
//     every __syncthreads, so each phase does two tiles' work, and each
//     weight element leaves L2 once a block for both;
//   * its products run on wgmma (wgmma.cuh): a tile's 64 rows by its two
//     warpgroups, each on half of the product's columns, A from the tile's
//     bf16 tiles by ldmatrix, the weights streaming through a ring of three
//     8 KB slabs (two in flight, the next product's first two issued while
//     the current one ends; a fourth measured no faster), the f32
//     accumulators in registers. Each epilogue (bias, leaky-ReLU slope,
//     rounding to T) runs on the registers and writes the next product's
//     bf16 operand tile; the outputs whose
//     column or row sums, or whose rows that share a cell, need every row
//     go through the f32 tile F (64 x 64) in 64-column pieces (d_z1, d_rows)
//     or as column sums of each warp's rows (T(d_t2));
//   * the IEF's d_z1, summed over the iterations in f32, and the rays'
//     d_ray_feat lie in the slot's slice of a global scratch (L2-resident);
//     in the last iteration d_z1 stays in registers;
//   * each cell's d_rows, both decoder halves (the probability half right
//     after its layer-1 cotangent), are added into the slot's copy of the
//     table at the memory (red), once an element a phase.
// Every gradient stays a fixed-order sum, bit-identical run to run.
// Included by ray_decode_bwd.cu (which includes wgmma.cuh) inside its
// anonymous namespace, after the helpers it shares.
#pragma once

// a tile's threads (two warpgroups), the tiles of a block, its threads
constexpr int kTileThreads = 256, kTileWarps = kTileThreads / 32;
constexpr int kSlotsW = 2, kThreadsW = kSlotsW * kTileThreads;
constexpr int kLdF = 68;  // F's row stride (floats)

// this thread's index among its tile's threads, and its tile's slot
__device__ __forceinline__ int tile_tid() {
  return threadIdx.x % kTileThreads;
}
__device__ __forceinline__ int tile_slot() {
  return threadIdx.x / kTileThreads;
}

// Pass A's shared memory at 64 rows: each tile slot's regions (the fixed
// ones first, then those whose size the call sets, as in BwdSmem), the
// slots one after the other, then the weight slabs they share
template <int G>
struct WgSmem {
  static constexpr int kMR = 8;  // rays of a tile, at most
  static constexpr int kG1 = Dims<G>::g1, kLd1 = Dims<G>::ld1,
                       kLd2 = Dims<G>::ld2, kLd3 = Dims<G>::ld3;
  // X (stride kp <= 400) spans the H1 region and H2's
  static constexpr int kLdH1 = kLd1 > 400 - kLd2 ? kLd1 : 400 - kLd2;
  // H1 | X | T(d_z1); H2 | T(d_t2); H3 | T(d_t3) | the per-ray sums of
  // layer 1's cotangent
  static constexpr size_t h1 = 0;
  static constexpr size_t h2 = align128(h1 + (size_t)64 * kLdH1 * 2);
  static constexpr size_t h3 = align128(h2 + (size_t)64 * kLd2 * 2);
  static constexpr size_t f = align128(h3 + (size_t)64 * kLd3 * 2);
  static constexpr size_t doff = align128(f + (size_t)64 * kLdF * 4);
  // the layer-4 outputs of a forward (tmp) share doff: no cotangent is
  // live while a forward runs
  static constexpr size_t tmp = doff, go = doff + 256, gl = go + 256,
                          cell = gl + 256, lead = cell + 256,
                          next = lead + 256, fixed = next + 256;
  size_t off, rf, small, slot, ring, total;
  __host__ __device__ WgSmem(int crp, int n_iter, int small_size) {
    off = fixed;
    rf = align128(off + (size_t)(n_iter + 1) * 64 * 4);
    small = align128(rf + (size_t)kMR * crp * 2);
    slot = align128(small + (size_t)small_size * 4);
    ring = kSlotsW * slot;
    total = ring + (size_t)wg::kSlabs * wg::kSlabElems * 2;
  }
};

// the floats of a tile slot's slice of the global scratch: the IEF's d_z1 (64
// rows of 4G; the recompute's z1p first), for the recompute e1 (64 rows)
// and the per-ray part of layer 1 (8 rays of 8G), then the rays' d_ray_feat
// (8 x crp)
template <int kMode, int G>
__host__ __device__ constexpr long long wg_scratch_floats(int crp) {
  return (kMode == kRecompute ? 144 : 64) * 4LL * G + 8LL * crp;
}

// put, colsum_add, fetch of a tile's threads: rows dense rows of width
// elements from the tile src (row stride lds) to dst in global memory
__device__ __forceinline__ void put_rows(const __nv_bfloat16* src, int lds,
                                         __nv_bfloat16* dst, int width,
                                         int rows) {
  const int per_row = width / 8;
  for (int i = tile_tid(); i < rows * per_row; i += kTileThreads) {
    const int r = i / per_row, q = i % per_row;
    reinterpret_cast<uint4*>(dst + (size_t)r * width)[q] =
        reinterpret_cast<const uint4*>(src + r * lds)[q];
  }
}
// g[c] += the sum over the 64 rows of X[r * ldx + c] (f32, shared), c < N
__device__ __forceinline__ void colsum_rows(const float* X, int ldx, int N,
                                            float* g) {
  for (int c = tile_tid(); c < N; c += kTileThreads) {
    float s = 0.f;
#pragma unroll 8
    for (int r = 0; r < 64; ++r) s += X[r * ldx + c];
    g[c] += s;
  }
}

// v added into 4 consecutive floats of global memory (16-byte aligned) where
// they lie, with nothing read back. Each element of a slot's table copy
// gets at most one such add a phase, and __syncthreads orders the phases:
// the adds keep a fixed order. (Like every f32 add done at the memory, it
// flushes subnormal values to zero.)
__device__ __forceinline__ void red_add4(float* at, float4 v) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(at),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// where one decoder's small sums go
struct TailSums {
  float *b2, *b3, *w4, *b4, *a, *c, *b1;
};

// fetch's work in rounds of kU 16-byte loads a thread, all in flight
// before the first store: rows dense rows of src (global, written by this
// block or read-only) into the tile dst (row stride lds), zeros past them,
// 64 rows in all
template <int kU = 4>
__device__ __forceinline__ void fetch_rows(const __nv_bfloat16* src, int width,
                                           __nv_bfloat16* dst, int lds,
                                           int rows) {
  const int pieces = width / 8, total = 64 * pieces;
  for (int i0 = tile_tid(); i0 < total; i0 += kU * kTileThreads) {
    uint4 v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kTileThreads, r = i / pieces, q = i % pieces;
      v[u] = i < total && r < rows
                 ? reinterpret_cast<const uint4*>(src + (size_t)r * width)[q]
                 : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kTileThreads, r = i / pieces, q = i % pieces;
      if (i < total) reinterpret_cast<uint4*>(dst + r * lds)[q] = v[u];
    }
  }
}

// C[8 x N] (f32, ldc) (+)= A[8 x K] (bf16, shared, lda) @ op(B), op(B) as
// in product (ray_decode_bwd.cu), by a tile's threads: its M = 8 products,
// the per-ray ones, on the tensor cores with the weight fragments read from
// L2 where N % 32 and K % 16 are 0, else CUDA-core FMA
template <bool kTransB>
__device__ void ray_product(const __nv_bfloat16* A, int lda,
                            const __nv_bfloat16* __restrict__ B, int ldb,
                            int K, int N, float* C, int ldc, bool acc) {
  if (N % 32 == 0 && K % 16 == 0) {
    using namespace nvcuda;
    using BLayout = typename std::conditional<kTransB, wmma::col_major,
                                              wmma::row_major>::type;
    for (int ct = tile_tid() / 32; ct < N / 32; ct += kTileWarps) {
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
  const int col_groups = N / 4;
  for (int it = tile_tid(); it < 2 * col_groups; it += kTileThreads) {
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

// the weights of a decoder tail's products: the forward's layer 2 and 3,
// the backward's layer 3 and the 64-column pieces of its layer 2
template <int G>
struct TailSlabs {
  static constexpr int kG1 = Dims<G>::g1, kG2 = Dims<G>::g2,
                       kG3 = Dims<G>::g3;
  static constexpr int kNW2 = kG2 / 2, kNW3 = kG3 / 2 < 8 ? 8 : kG3 / 2,
                       kNWb3 = kG2 / 2, kP = kG1 < 64 ? kG1 : 64;
  static __device__ wg::Slabs f2(const TailWeights<__nv_bfloat16>& w) {
    return wg::slabs<kNW2, false>(w.w2, kG2, kG1, kG2);
  }
  static __device__ wg::Slabs f3(const TailWeights<__nv_bfloat16>& w) {
    return wg::slabs<kNW3, false>(w.w3, kG3, kG2, kG3);
  }
  static __device__ wg::Slabs b3(const TailWeights<__nv_bfloat16>& w) {
    return wg::slabs<kNWb3, true>(w.w3, kG3, kG3, kG2);
  }
  static __device__ wg::Slabs b2(const TailWeights<__nv_bfloat16>& w,
                                 int c0) {
    return wg::slabs<kP / 2, true>(w.w2 + (size_t)c0 * kG2, kG2, kG2, kP);
  }
};

// Layers 2-4 of one decoder from H1 (64 x 4G, T): H2, H3 (T) and each row's
// layer-4 output without b4 into out. primed / next: the slab stream
// (wg::product)
template <int G>
__device__ void tail_forward_wg(const __nv_bfloat16* H1, __nv_bfloat16* H2,
                                __nv_bfloat16* H3, __nv_bfloat16* ring,
                                int& at,
                                const TailWeights<__nv_bfloat16>& w,
                                float* out, bool primed,
                                const wg::Slabs* next) {
  IDT_DIMS(G);
  using S = TailSlabs<G>;
  constexpr int kNW2 = S::kNW2, kNW3 = S::kNW3;
  const int tid = tile_tid(), wgi = tid / 128;
  const wg::Slabs f3 = S::f3(w);
  {
    float a[kNW2 / 2];
    wg::product<kNW2, false>(H1, kLd1, S::f2(w), ring, at, a, primed, &f3);
#pragma unroll
    for (int i = 0; i < kNW2 / 2; i += 2) {
      const int r = wg::acc_row(i), c = wgi * kNW2 + wg::acc_col(i);
      *reinterpret_cast<__nv_bfloat162*>(H2 + r * kLd2 + c) =
          __floats2bfloat162_rn(leaky(a[i] + ldg_f32(w.b2 + c)),
                                leaky(a[i + 1] + ldg_f32(w.b2 + c + 1)));
    }
  }
  {
    float a[kNW3 / 2];
    wg::product<kNW3, false>(H2, kLd2, f3, ring, at, a, true, next);
#pragma unroll
    for (int i = 0; i < kNW3 / 2; i += 2) {
      const int r = wg::acc_row(i), c = wgi * kNW3 + wg::acc_col(i);
      if (c < kG3)
        *reinterpret_cast<__nv_bfloat162*>(H3 + r * kLd3 + c) =
            __floats2bfloat162_rn(leaky(a[i] + ldg_f32(w.b3 + c)),
                                  leaky(a[i + 1] + ldg_f32(w.b3 + c + 1)));
    }
  }
  __syncthreads();
  // layer 4: each row's G-term dot, 4 threads a row
  {
    const int r = tid / 4, k0 = (tid % 4) * (kG3 / 4);
    float s = 0.f;
#pragma unroll
    for (int k = k0; k < k0 + kG3 / 4; ++k)
      s = fmaf(to_f32(H3[r * kLd3 + k]), ldg_f32(w.w4 + k), s);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (tid % 4 == 0) out[r] = s;
  }
  __syncthreads();
}

// Backward through one decoder tail, as tail_backward does, from H1, H2, H3
// and DOFF. d_z1 = dleaky(h1, T(d_t2) @ W2^T) goes in 64-column pieces
// through F: the IEF (off_i) adds each piece's column sums (weighted by the
// offsets) into s.a, s.c and its row dots with a_vec into DOFF, and adds it
// into DG (f32, the sum over the iterations) unless `final`. When final
// (the probability decoder; the IEF's first iteration) the summed d_z1 goes
// through F into the layer-1 sums: its column sums into s.b1, each ray's
// sum over its kb slots, rounded, into RET (row stride 4G + 8), and T(d_z1)
// over H1.
template <int G>
__device__ void tail_backward_wg(__nv_bfloat16* H1, __nv_bfloat16* H2,
                                 __nv_bfloat16* H3, float* DOFF, float* F,
                                 float* DG, __nv_bfloat16* ring, int& at,
                                 bool accumulate, bool final,
                                 const float* off_i, const float* a_vec,
                                 const TailWeights<__nv_bfloat16>& w,
                                 const TailSums& s, __nv_bfloat16* RET,
                                 int rays, int kb,
                                 const TailOut<__nv_bfloat16>& out,
                                 bool primed, const wg::Slabs* next) {
  using T = __nv_bfloat16;
  IDT_DIMS(G);
  using S = TailSlabs<G>;
  constexpr int M = 64, MR = 8;
  constexpr int kNWb3 = S::kNWb3, kP = S::kP;
  const int tid = tile_tid(), warp = tid / 32, lane = tid % 32,
            wgi = tid / 128, wq = warp % 4;
  // layer 4: dW4 = H3^T T(d), db4 = sum d
  for (int c = tid; c <= kG3; c += kTileThreads) {
    float v = 0.f;
    if (c < kG3) {
#pragma unroll 8
      for (int r = 0; r < M; ++r)
        v = fmaf(to_f32(H3[r * kLd3 + c]), to_f32(from_f32<T>(DOFF[r])), v);
      s.w4[c] += v;
    } else {
      for (int r = 0; r < M; ++r) v += DOFF[r];
      s.b4[0] += v;
    }
  }
  __syncthreads();
  // d_t3 = dleaky(h3, T(d) * w4), in F (f32) and, rounded, over H3
  for (int i = 4 * tid; i < M * kG3; i += 4 * kTileThreads) {
    const int r = i / kG3, c = i % kG3;
    const float g = to_f32(from_f32<T>(DOFF[r]));
    const float4 w4 = make_float4(ldg_f32(w.w4 + c), ldg_f32(w.w4 + c + 1),
                                  ldg_f32(w.w4 + c + 2),
                                  ldg_f32(w.w4 + c + 3));
    T* h3 = H3 + r * kLd3 + c;
    const float4 d = dleaky4(ld4(h3), make_float4(g * w4.x, g * w4.y,
                                                  g * w4.z, g * w4.w));
    st4(F + r * kLdF + c, d);
    st4(h3, d);
  }
  __syncthreads();
  colsum_rows(F, kLdF, kG3, s.b3);
  if (out.h2 != nullptr) put_rows(H2, kLd2, out.h2, kG2, out.rows);
  put_rows(H3, kLd3, out.dt3, kG3, out.rows);
  // d_t2 = dleaky(h2, T(d_t3) @ W3^T), rounded over H2; its column sums:
  // each warp's 16 rows by shuffles, then the 4 warps of a warpgroup in
  // order through F
  {
    float a[kNWb3 / 2];
    const wg::Slabs b2 = S::b2(w, 0);
    wg::product<kNWb3, true>(H3, kLd3, S::b3(w), ring, at, a, primed, &b2);
#pragma unroll
    for (int i = 0; i < kNWb3 / 2; i += 2) {
      const int r = wg::acc_row(i), c = wgi * kNWb3 + wg::acc_col(i);
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(H2 + r * kLd2 + c);
      const float2 hv = __bfloat1622float2(*h);
      a[i] = dleaky(hv.x, a[i]);
      a[i + 1] = dleaky(hv.y, a[i + 1]);
      *h = __floats2bfloat162_rn(a[i], a[i + 1]);
    }
#pragma unroll
    for (int i = 0; i < kNWb3 / 2; ++i) {
      if ((i >> 1) & 1) continue;  // the row 8 below comes with i + 2
      float v = a[i] + a[i + 2];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 4) F[wq * kG2 + wgi * kNWb3 + wg::acc_col(i)] = v;
    }
  }
  __syncthreads();
  for (int c = tid; c < kG2; c += kTileThreads)
    s.b2[c] += ((F[c] + F[kG2 + c]) + F[2 * kG2 + c]) + F[3 * kG2 + c];
  if (out.h1 != nullptr) put_rows(H1, kLd1, out.h1, kG1, out.rows);
  put_rows(H2, kLd2, out.dt2, kG2, out.rows);
  __syncthreads();  // F's sums are read
  for (int c0 = 0; c0 < kG1; c0 += kP) {
    float z[kP / 4];
    const bool more = c0 + kP < kG1;
    const wg::Slabs piece = S::b2(w, more ? c0 + kP : 0);
    wg::product<kP / 2, true>(H2, kLd2, S::b2(w, c0), ring, at, z, true,
                              more ? &piece : next);
#pragma unroll
    for (int i = 0; i < kP / 4; i += 2) {
      const int r = wg::acc_row(i), c = wgi * (kP / 2) + wg::acc_col(i);
      __nv_bfloat162* h =
          reinterpret_cast<__nv_bfloat162*>(H1 + r * kLd1 + c0 + c);
      const float2 hv = __bfloat1622float2(*h);
      const float2 d = make_float2(dleaky(hv.x, z[i]), dleaky(hv.y, z[i + 1]));
      *reinterpret_cast<float2*>(F + r * kLdF + c) = d;
      float2 t = d;
      if (accumulate) {
        const float2 o =
            *reinterpret_cast<const float2*>(DG + r * kG1 + c0 + c);
        t = make_float2(o.x + d.x, o.y + d.y);
      }
      if (final) {
        z[i] = t.x;
        z[i + 1] = t.y;
        *h = __floats2bfloat162_rn(t.x, t.y);
      } else {
        *reinterpret_cast<float2*>(DG + r * kG1 + c0 + c) = t;
      }
    }
    __syncthreads();
    if (off_i != nullptr) {
      for (int c = tid; c < kP; c += kTileThreads) {
        float sa = 0.f, sc = 0.f;
#pragma unroll 8
        for (int r = 0; r < M; ++r) {
          sa = fmaf(F[r * kLdF + c], off_i[r], sa);
          sc += F[r * kLdF + c];
        }
        s.a[c0 + c] += sa;
        s.c[c0 + c] += sc;
      }
      // each row's dot with a_vec: 4 threads a row
      {
        const int r = tid / 4, k0 = (tid % 4) * (kP / 4);
        float v = 0.f;
#pragma unroll
        for (int c = k0; c < k0 + kP / 4; ++c)
          v = fmaf(F[r * kLdF + c], ldg_f32(a_vec + c0 + c), v);
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (tid % 4 == 0) DOFF[r] += v;
      }
      if (final) {  // F: this iteration's d_z1, then the sum
        __syncthreads();
#pragma unroll
        for (int i = 0; i < kP / 4; i += 2) {
          const int r = wg::acc_row(i), c = wgi * (kP / 2) + wg::acc_col(i);
          *reinterpret_cast<float2*>(F + r * kLdF + c) =
              make_float2(z[i], z[i + 1]);
        }
        __syncthreads();
      }
    }
    if (final) {
      for (int c = tid; c < kP; c += kTileThreads) {
        float v = 0.f;
#pragma unroll 8
        for (int r = 0; r < M; ++r) v += F[r * kLdF + c];
        s.b1[c0 + c] += v;
      }
      for (int i = tid; i < MR * kP; i += kTileThreads) {
        const int ray = i / kP, c = i % kP;
        float v = 0.f;
        if (ray < rays) {
#pragma unroll 8
          for (int k = 0; k < kb; ++k) v += F[(ray * kb + k) * kLdF + c];
        }
        RET[ray * kLd1 + c0 + c] = from_f32<T>(v);
      }
    }
    __syncthreads();
  }
}

template <int kMode, int G>
__device__ __forceinline__ void pass_a_wg(const BwdParams<__nv_bfloat16>& p) {
  using T = __nv_bfloat16;
  IDT_DIMS(G);
  using Lay = WgSmem<G>;
  constexpr int M = 64, MR = Lay::kMR;
  constexpr bool kFromSaves = kMode != kRecompute;
  // the recompute's layer-1 products: column pieces of 128
  constexpr int kPL = kG1 < 128 ? kG1 : 128;
  // 8-element vectors of a 64 x 4G tile a thread handles
  constexpr int kVecs = M * kG1 / 8;
  constexpr int kTileVecs = (kVecs + kTileThreads - 1) / kTileThreads;
  constexpr bool kRagged = kVecs % kTileThreads != 0;
  extern __shared__ __align__(128) unsigned char smem_all[];
  const Lay lay(p.crp, p.n_iter, p.small_size);
  // this tile slot's regions; the slabs all slots share
  unsigned char* smem = smem_all + tile_slot() * lay.slot;
  T* RING = reinterpret_cast<T*>(smem_all + lay.ring);
  T* H1 = reinterpret_cast<T*>(smem + Lay::h1);
  T* X = H1;
  T* H2 = reinterpret_cast<T*>(smem + Lay::h2);
  T* H3 = reinterpret_cast<T*>(smem + Lay::h3);
  T* RET = H3;
  float* F = reinterpret_cast<float*>(smem + Lay::f);
  float* DOFF = reinterpret_cast<float*>(smem + Lay::doff);
  float* TMP = reinterpret_cast<float*>(smem + Lay::tmp);
  float* GO = reinterpret_cast<float*>(smem + Lay::go);
  float* GL = reinterpret_cast<float*>(smem + Lay::gl);
  int* CELL = reinterpret_cast<int*>(smem + Lay::cell);
  int* LEAD = reinterpret_cast<int*>(smem + Lay::lead);
  int* NEXT = reinterpret_cast<int*>(smem + Lay::next);
  float* OFF = reinterpret_cast<float*>(smem + lay.off);
  T* RF = reinterpret_cast<T*>(smem + lay.rf);
  float* SM = reinterpret_cast<float*>(smem + lay.small);

  const int tid = tile_tid(), wgi = tid / 128;
  // the slot's place among the grid's (a Pass A block of the plan: its
  // tiles, its partial sums, its copy of the table, its scratch)
  const int vb = blockIdx.x * kSlotsW + tile_slot(), n_vb = p.n_vblocks;
  float* DG = p.e1_scratch +
              (size_t)vb * wg_scratch_floats<kMode, G>(p.crp);
  float* E1G = DG + M * kG1;        // recompute: e1
  float* RAY = DG + 2 * M * kG1;    // recompute: RF @ ray_w1 (MR x 8G)
  // the tile's d_ray_feat (MR x crp), summed over both halves
  float* DRF = DG + (kFromSaves ? M : 2 * M + 2 * MR) * kG1;
  float* table = p.table_part + (size_t)vb * p.table_stride;
  int at_slab = 0;
  const int kp = p.kp, crp = p.crp, c_vox = p.c_vox;
  const int n_trig = 12 * p.multires;
  // at 64 rows a tile holds whole rays (kb <= 64)
  const int kb = p.kb, rays = p.rays;
  const int n_units = (int)((p.n_chunk + rays - 1) / rays);
  const TailSums prob_sums{SM + p.small_off[kSProbB2],
                           SM + p.small_off[kSProbB3],
                           SM + p.small_off[kSProbW4],
                           SM + p.small_off[kSProbB4], nullptr, nullptr,
                           SM + p.small_off[kSB1] + kG1};
  const TailSums off_sums{SM + p.small_off[kSOffB2], SM + p.small_off[kSOffB3],
                          SM + p.small_off[kSOffW4], SM + p.small_off[kSOffB4],
                          SM + p.small_off[kSAVec], SM + p.small_off[kSCVec],
                          SM + p.small_off[kSB1]};
  for (int i = tid; i < p.small_size; i += kTileThreads) SM[i] = 0.f;

  // the slots of a block walk their tiles in step (they share every
  // __syncthreads): as long as the first slot has one, the second an empty
  // one (no rows) past the chunk's end
  for (int unit0 = blockIdx.x * kSlotsW; unit0 < n_units; unit0 += n_vb) {
    const int unit = unit0 + tile_slot();
    const int lray0 = unit * rays;  // within the chunk
    const long long left = vb < n_vb ? p.n_chunk - lray0 : 0;
    const int rays_ok = (int)(left <= 0 ? 0 : left < rays ? left : rays);
    const int rows_ok = rays_ok * kb;
    const int lrow0 = lray0 * kb;
    auto row_ok = [&](int r) { return r < rows_ok; };
    auto grow = [&](int r) { return p.row_base + lrow0 + r; };
    auto at = [&](int s) {
      const bool per_ray = s == kRf || s == kDreOff || s == kDreProb;
      return p.stream[s] + (size_t)(per_ray ? lray0 : lrow0) *
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
    for (int r = tid; r < M; r += kTileThreads) {
      const bool ok = row_ok(r);
      GO[r] = ok ? __ldg(p.g + grow(r) * 2) : 0.f;
      GL[r] = ok ? __ldg(p.g + grow(r) * 2 + 1) : 0.f;
      CELL[r] = ok ? __ldg(p.cells + grow(r)) : -1;
    }
#pragma unroll 4
    for (int i = tid; i < MR * crp; i += kTileThreads) {
      const int r = i / crp, col = i % crp;
      RF[i] = (r < rays_ok && col < p.c_ray)
                  ? ldg_raw(p.ray_feat +
                            (p.ray_base + lray0 + r) * p.c_ray + col)
                  : from_f32<T>(0.f);
    }
    for (int i = tid; i < MR * crp; i += kTileThreads) DRF[i] = 0.f;
    __syncthreads();  // CELL, RF
    // the rows of the tile that share a cell: the first is its leader, each
    // links to the next
    for (int r = tid; r < M; r += kTileThreads) {
      int first = 1, link = -1;
      for (int q = 0; q < M && CELL[r] >= 0; ++q) {
        if (q == r || CELL[q] != CELL[r]) continue;
        if (q < r) {
          first = 0;
        } else if (link < 0) {
          link = q;
        }
      }
      LEAD[r] = CELL[r] >= 0 && first;
      NEXT[r] = link;
    }

    // X = [vox | pos6 | trig | 0] (M x kp, T) into the H1 region
    auto stage_tile_x = [&]() {
      const int vv = c_vox / 8;
#pragma unroll 4
      for (int i = tid; i < M * vv; i += kTileThreads) {
        const int r = i / vv, q = i % vv;
        copy8(X + r * kp + q * 8,
              row_ok(r) ? p.vox_table + (long long)CELL[r] * c_vox + q * 8
                        : nullptr);
      }
      T* XT = X + c_vox + 6;  // the trig columns
      if (kFromSaves && n_trig % 8 == 0) {
        const int tv = n_trig / 8;
#pragma unroll 4
        for (int i = tid; i < M * tv; i += kTileThreads) {
          const int r = i / tv, q = i % tv;
          float v[8] = {};
          if (row_ok(r)) load8(p.trig + grow(r) * n_trig + q * 8, v);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            XT[r * kp + q * 8 + j] = from_f32<T>(v[j]);
        }
      } else {
        for (int i = tid; i < M * n_trig; i += kTileThreads) {
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
      const int rest = kp - c_vox - n_trig;
#pragma unroll 4
      for (int i = tid; i < M * rest; i += kTileThreads) {
        const int r = i / rest, j = i % rest;
        const int col = j < 6 ? c_vox + j : c_vox + n_trig + j;
        X[r * kp + col] = from_f32<T>(
            j < 6 && row_ok(r) ? __ldg(p.pos + grow(r) * 6 + j) : 0.f);
      }
    };

    // d_rows of one decoder half: the products' weights, 64 columns a piece
    auto rows_slabs = [&](int half, int n0) {
      return wg::slabs<32, true>(p.pair_w1 + (size_t)n0 * 2 * kG1 + half * kG1,
                                 2 * kG1, kG1,
                                 c_vox - n0 < 64 ? c_vox - n0 : 64);
    };
    // layer 1 of one decoder (half 0: IEF offset, 1: probability), after its
    // tail left T(d_z1) over H1, the rays' sums in RET and the b1 sums: the
    // operands of the pair_w1 and ray_w1 gradients to their streams,
    // d_ray_feat, and d_rows into the slot's copy of the table. The
    // probability half runs first and also writes X and the ray features.
    auto layer1 = [&](int half, const wg::Slabs* next) {
      put_rows(H1, kLd1, at(half ? kDeProb : kDeOff), kG1, rows_ok);
      put_rows(RET, kLd1, at(half ? kDreProb : kDreOff), kG1, rays_ok);
      // d_ray_feat += T(d_re) @ ray_w1[:, half]^T
      ray_product<true>(RET, kLd1, p.ray_w1 + half * kG1, 2 * kG1, kG1, crp,
                        DRF, crp, /*acc=*/true);
      // d_rows = T(d_z1) @ W1v[:, half]^T, 64 columns at a time through F;
      // each cell's sum added into the table (red: no load, one add an
      // element a phase, the phases ordered by __syncthreads, so the sums
      // keep their order): a tile's leaders hold distinct cells
      for (int n0 = 0; n0 < c_vox; n0 += 64) {
        const int nc = c_vox - n0 < 64 ? c_vox - n0 : 64;
        const bool more = n0 + 64 < c_vox;
        const wg::Slabs piece = rows_slabs(half, more ? n0 + 64 : 0);
        float a[16];
        wg::product<32, true>(H1, kLd1, rows_slabs(half, n0), RING, at_slab,
                              a, true, more ? &piece : next);
#pragma unroll
        for (int i = 0; i < 16; i += 2) {
          const int r = wg::acc_row(i), c = wgi * 32 + wg::acc_col(i);
          *reinterpret_cast<float2*>(F + r * kLdF + c) =
              make_float2(a[i], a[i + 1]);
        }
        __syncthreads();
        const int nq = nc / 4;  // 4 columns an item
        for (int i = tid; i < M * nq; i += kTileThreads) {
          const int r = i / nq, col = 4 * (i % nq);
          if (!LEAD[r]) continue;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          for (int q = r; q >= 0; q = NEXT[q])
            v = add4(v, ld4(F + q * kLdF + col));
          red_add4(table + (long long)CELL[r] * c_vox + n0 + col, v);
        }
        __syncthreads();
      }
      if (half == 1) {
        stage_tile_x();
        __syncthreads();
        put_rows(X, kp, at(kX), kp, rows_ok);
        put_rows(RF, crp, at(kRf), crp, rays_ok);
        __syncthreads();
      }
    };

    // the first product of each stage, for the slab stream (wg::product)
    using TS = TailSlabs<G>;
    const wg::Slabs prob_f2 = TS::f2(p.prob), prob_b3 = TS::b3(p.prob),
                    off_f2 = TS::f2(p.off), off_b3 = TS::b3(p.off),
                    rows1 = rows_slabs(1, 0), rows0 = rows_slabs(0, 0);

    // -- probability decoder: forward from z1p (or layer 1), then backward
    if constexpr (kFromSaves) {
#pragma unroll
      for (int u = 0; u < kTileVecs; ++u) {
        if (kRagged && tid + u * kTileThreads >= kVecs) break;
        const int i = (tid + u * kTileThreads) * 8, r = i / kG1;
        float z[8] = {};
        if (row_ok(r)) load8(p.z1p + grow(r) * kG1 + i % kG1, z);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          H1[r * kLd1 + i % kG1 + j] = from_f32<T>(leaky(z[j]));
      }
    } else {
      // layer 1 as K1 computes it: RAY = RF @ ray_w1, then e1 = X @ W_off +
      // RAY + b1 into E1G and z1p = X @ W_prob + RAY + b1 into DG (global
      // f32: X spans H1), then H1 = act(z1p)
      const unsigned spt_inv = (4096u + kb - 1) / kb;
      auto ray_of = [&](int r) {
        return min((int)(((unsigned)r * spt_inv) >> 12), MR - 1);
      };
      stage_tile_x();
      __syncthreads();
      ray_product<false>(RF, crp, p.ray_w1, 2 * kG1, crp, 2 * kG1, RAY,
                         2 * kG1, false);
      // the products' weights: column pieces of [W_off | W_prob], in order
      auto l1_slabs = [&](int j) {
        return wg::slabs<kPL / 2, false>(p.pair_w1 + j * kPL, 2 * kG1, kp,
                                         kPL);
      };
      constexpr int kPieces = 2 * kG1 / kPL;
      for (int j = 0; j < kPieces; ++j) {
        const int half = j * kPL / kG1, n0 = j * kPL % kG1;
        float* dst = half ? DG : E1G;
        {
          float a[kPL / 4];
          const wg::Slabs piece = l1_slabs(j + 1 < kPieces ? j + 1 : 0);
          wg::product<kPL / 2, false>(X, kp, l1_slabs(j), RING, at_slab, a,
                                      j > 0,
                                      j + 1 < kPieces ? &piece : &prob_f2);
#pragma unroll
          for (int i = 0; i < kPL / 4; i += 2) {
            const int r = wg::acc_row(i);
            const int c = half * kG1 + n0 + wgi * (kPL / 2) + wg::acc_col(i);
            const float* ray = RAY + ray_of(r) * 2 * kG1 + c;
            *reinterpret_cast<float2*>(dst + r * kG1 + c - half * kG1) =
                make_float2((a[i] + ray[0]) + __ldg(p.b1 + c),
                            (a[i + 1] + ray[1]) + __ldg(p.b1 + c + 1));
          }
        }
      }
      __syncthreads();
      for (int i = 4 * tid; i < M * kG1; i += 4 * kTileThreads)
        st4(H1 + i / kG1 * kLd1 + i % kG1, leaky4(ld4(DG + i)));
    }
    __syncthreads();
    // instance i of a K2 'all' save, at the tile's first row
    auto saved_at = [&](const auto* base, int inst, int width) {
      return base + (inst * p.s_inst + grow(0)) * width;
    };
    if constexpr (kMode == kFromAll) {
      fetch_rows(saved_at(p.s_h2, p.n_iter, kG2), kG2, H2, kLd2, rows_ok);
      fetch_rows(saved_at(p.s_h3, p.n_iter, kG3), kG3, H3, kLd3, rows_ok);
      for (int r = tid; r < M; r += kTileThreads)
        DOFF[r] = dsquash(row_ok(r) ? __ldg(p.s_logit + grow(r)) : 0.f, GL[r],
                          p.use_sigmoid);
    } else {
      tail_forward_wg<G>(H1, H2, H3, RING, at_slab, p.prob, TMP,
                         kMode == kRecompute, &prob_b3);
      for (int r = tid; r < M; r += kTileThreads)
        DOFF[r] = dsquash(TMP[r] + __ldg(p.prob.b4), GL[r], p.use_sigmoid);
    }
    __syncthreads();
    tail_backward_wg<G>(H1, H2, H3, DOFF, F, DG, RING, at_slab, false, true,
                        nullptr, p.a_vec, p.prob, prob_sums, RET, rays, kb,
                        tail_out(0, true), kMode != kFromAll, &rows1);
    layer1(1, kMode == kFromAll ? &off_b3 : &off_f2);

    // -- IEF offset decoder: the offsets of every iteration, then backward --
    if constexpr (kMode == kFromAll) {  // the offsets saved, final included
      for (int i = tid; i < (p.n_iter + 1) * M; i += kTileThreads) {
        const int it = i / M, r = i % M;
        OFF[i] = row_ok(r) ? __ldg(saved_at(p.s_off, it, 1) + r) : 0.f;
      }
      __syncthreads();
    } else {
      for (int r = tid; r < M; r += kTileThreads) OFF[r] = p.init_offset;
      __syncthreads();
    }
    auto ief_h1 = [&](int it) {  // H1 of iteration it
#pragma unroll
      for (int u = 0; u < kTileVecs; ++u) {
        if (kRagged && tid + u * kTileThreads >= kVecs) break;
        const int i = (tid + u * kTileThreads) * 8, r = i / kG1, c = i % kG1;
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
          H1[r * kLd1 + c + j] = from_f32<T>(leaky(
              e[j] + o * __ldg(p.a_vec + c + j) + __ldg(p.c_vec + c + j)));
      }
    };
    const float b4 = __ldg(p.off.b4);
    for (int it = 0; kMode != kFromAll && it < p.n_iter; ++it) {
      ief_h1(it);  // then H2, H3 and the tail's output into TMP
      tail_forward_wg<G>(H1, H2, H3, RING, at_slab, p.off, TMP, true,
                         it + 1 < p.n_iter ? &off_f2 : &off_b3);
      for (int r = tid; r < M; r += kTileThreads)
        OFF[(it + 1) * M + r] = (OFF[it * M + r] + TMP[r]) + b4;
      if (it != p.n_iter - 1) {
        // the iteration's activations for its backward, in its streams (h3
        // where T(d_t3) goes later), instead of a second forward
        put_rows(H1, kLd1, inst_at(kH1, 1 + it), kG1, rows_ok);
        put_rows(H2, kLd2, inst_at(kH2, 1 + it), kG2, rows_ok);
        put_rows(H3, kLd3, inst_at(kDt3, 1 + it), kG3, rows_ok);
      }
      __syncthreads();
    }
    for (int r = tid; r < M; r += kTileThreads)
      DOFF[r] = dsquash(OFF[p.n_iter * M + r], GO[r], p.use_sigmoid);
    __syncthreads();
    for (int it = p.n_iter - 1; it >= 0; --it) {
      // the last iteration's H1..H3 are still in place from the loop above;
      // the others come back from their streams (kFromAll: h1 from e1 and
      // the saved offset, h2 and h3 from K2 'all''s saves, every iteration)
      const bool last = it == p.n_iter - 1;
      if constexpr (kMode == kFromAll) {
        ief_h1(it);
        fetch_rows(saved_at(p.s_h2, it, kG2), kG2, H2, kLd2, rows_ok);
        fetch_rows(saved_at(p.s_h3, it, kG3), kG3, H3, kLd3, rows_ok);
        __syncthreads();
      } else if (!last) {
        fetch_rows<8>(inst_at(kH1, 1 + it), kG1, H1, kLd1, rows_ok);
        fetch_rows(inst_at(kH2, 1 + it), kG2, H2, kLd2, rows_ok);
        fetch_rows(inst_at(kDt3, 1 + it), kG3, H3, kLd3, rows_ok);
        __syncthreads();
      }
      tail_backward_wg<G>(H1, H2, H3, DOFF, F, DG, RING, at_slab, !last,
                          it == 0, OFF + it * M, p.a_vec, p.off, off_sums,
                          RET, rays, kb,
                          tail_out(1 + it, last || kMode == kFromAll), true,
                          it > 0 ? &off_b3 : &rows0);
    }
    layer1(0, nullptr);
    for (int i = tid; i < MR * p.c_ray; i += kTileThreads) {
      const int r = i / p.c_ray, col = i % p.c_ray;
      if (r < rays_ok)
        p.d_ray[(p.ray_base + lray0 + r) * p.c_ray + col] = DRF[r * crp + col];
    }
  }
  __syncthreads();
  float* part = p.small_part + (size_t)vb * p.small_size;
  for (int i = tid; vb < n_vb && i < p.small_size; i += kTileThreads)
    part[i] += SM[i];
}
