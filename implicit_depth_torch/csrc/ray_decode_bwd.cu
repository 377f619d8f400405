// K3: fused backward of the stage-1 ray-major decode (both decoders).
//
// Replaces implicit_depth_tpu/ops/pallas_ray_decode.py::_fused_bwd_impl (its
// Pallas kernel, in table mode), in two instances:
//   * kFromSaves (save_mode='l1', the decode_bwd = 'kernel_save' default):
//     from the saves of K2 (ray_decode.cu: e1, z1p, trig);
//   * recompute (decode_bwd = 'kernel', after K1's save-free forward): per
//     tile it computes trig from the positions, the per-ray part of layer 1
//     and both layer-1 pre-activations from the table rows, pos6, trig and
//     [roi | dir_e], unrounded in f32 as the JAX kernel keeps them. z1p goes
//     straight into the probability decoder's activation; e1, read once per
//     IEF iteration forward and backward, goes to the block's own f32 slice
//     of a scratch buffer in global memory (L2-resident: 64 KB a block),
//     since shared memory has no room for it beside the backward's buffers.
// From there both instances recompute, per tile of rows, the layer-1
// activations and the tails of both IEF iterations and of the probability
// decoder, then backpropagate through them:
//   * d_vox_table (S, Cv) f32: each row's d(voxel row) added with atomicAdd
//     at its cell (the TPU kernel folds a one-hot product instead);
//   * d_ray_feat (N, Cr) f32: the layer-1 cotangent summed over each ray's
//     kb = 8 rows inside the block, times the per-ray layer-1 weights;
//   * every weight operand's gradient, f32, in the operand layout of K1/K2
//     (pair_w1, ray_w1, b1, a_vec, c_vec, off_{w2..b4}, prob_{w2..b4}).
// Derivatives follow the JAX kernel: the leaky-ReLU slope from the sign of
// the activation h; the soft clamp's derivative 1 on (0, 1) and 0.01
// elsewhere; the sigmoid's s(1 - s). Every product takes T operands (the
// cotangents rounded to T, as the JAX kernel's dots round them) with f32
// accumulation; bias gradients and the IEF offset chain are summed in f32.
//
// A GPU has no order between blocks, where the TPU grid accumulated the
// weight gradients in VMEM across its sequential steps. Here the grid is
// persistent (one block per SM, each walking tiles blockIdx.x, +gridDim.x,
// ...); each block adds its tiles' weight gradients into its own f32 slice
// of a workspace, and a second kernel sums the slices in block order, so the
// weight gradients are deterministic. The products X^T dE that form them run
// on the tensor cores (wmma, bf16) or the CUDA cores (f32), with the
// accumulator tiles read from and written back to the block's slice.
//
// What bounds it on the H100: at the training shapes (640k rows) ~1.1e12
// FLOP, ~1.1 ms at the bf16 tensor-core peak; the bytes it must move are
// ~1 GB (saves, cotangents, table), ~0.3 ms. This first version is bound by
// neither: each 64-row tile reads and writes its block's 1.15 MB slice of
// weight-gradient partials (~23 GB over the 10,000 tiles), and its products
// read weight fragments from L2 without staging. Larger tiles, a
// register-resident split of the weight gradients across blocks, wgmma and
// TMA are later work.
#include <type_traits>

#include "decode_common.cuh"

namespace {

using namespace idt;

constexpr int kKb = 8;

// -- products ----------------------------------------------------------------

// C[M x N] (f32, shared, ldc) (+)= A[M x K] (T, shared, lda) @ op(B), with
// op(B) = B[K x N] (global, row-major, ldb) or, kTransB, B^T for B[N x K]
// (global, row-major, ldb). Tensor cores when T is bf16 and M, N, K are
// multiples of 16; CUDA-core FMA otherwise (M, N multiples of 4).
template <typename T, bool kTransB>
__device__ void product(const T* A, int lda, const T* __restrict__ B, int ldb,
                        int M, int K, int N, float* C, int ldc, bool acc) {
  if constexpr (sizeof(T) == 2) {
    if (M % 16 == 0 && N % 16 == 0 && K % 16 == 0) {
      using namespace nvcuda;
      using BLayout = typename std::conditional<kTransB, wmma::col_major,
                                                wmma::row_major>::type;
      const int warp = threadIdx.x / 32;
      const int rts = M / 16, tiles = rts * (N / 16);
      for (int t = warp; t < tiles; t += kWarps) {
        const int rt = t % rts, ct = t / rts;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
        float* cp = C + rt * 16 * ldc + ct * 16;
        if (acc)
          wmma::load_matrix_sync(c, cp, ldc, wmma::mem_row_major);
        else
          wmma::fill_fragment(c, 0.f);
        for (int k = 0; k < K; k += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> b;
          wmma::load_matrix_sync(a, A + rt * 16 * lda + k, lda);
          const T* bp = kTransB ? B + (size_t)ct * 16 * ldb + k
                                : B + (size_t)k * ldb + ct * 16;
          wmma::load_matrix_sync(b, bp, ldb);
          wmma::mma_sync(c, a, b, c);
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

// G[K x N] (f32, global, ldg) += A^T B for A[M x K], B[M x N] (T, shared):
// a weight gradient summed over the block's M rows. Tensor cores when T is
// bf16 and M, K, N are multiples of 16 (the accumulator tiles are loaded
// from and stored back to G); CUDA-core FMA otherwise (K, N multiples of 4).
template <typename T>
__device__ void wgrad(const T* A, int lda, const T* B, int ldb, int M, int K,
                      int N, float* G, int ldg) {
  if constexpr (sizeof(T) == 2) {
    if (M % 16 == 0 && N % 16 == 0 && K % 16 == 0) {
      using namespace nvcuda;
      const int warp = threadIdx.x / 32;
      const int kts = K / 16, tiles = kts * (N / 16);
      for (int t = warp; t < tiles; t += kWarps) {
        const int kt = t % kts, nt = t / kts;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
        float* gp = G + (size_t)kt * 16 * ldg + nt * 16;
        wmma::load_matrix_sync(c, gp, ldg, wmma::mem_row_major);
        for (int m = 0; m < M; m += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> b;
          wmma::load_matrix_sync(a, A + m * lda + kt * 16, lda);
          wmma::load_matrix_sync(b, B + m * ldb + nt * 16, ldb);
          wmma::mma_sync(c, a, b, c);
        }
        wmma::store_matrix_sync(gp, c, ldg, wmma::mem_row_major);
      }
      return;
    }
  }
  const int col_groups = N / 4, items = (K / 4) * col_groups;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int cg = it % col_groups, kg = it / col_groups;
    float s[4][4] = {};
    for (int m = 0; m < M; ++m) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = to_f32(A[m * lda + kg * 4 + i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = to_f32(B[m * ldb + cg * 4 + j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        G[(size_t)(kg * 4 + i) * ldg + cg * 4 + j] += s[i][j];
  }
}

// g[c] += sum over the M rows of X[r * ldx + c] (f32, shared), c < N.
__device__ void colsum_add(const float* X, int ldx, int M, int N, float* g) {
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < M; ++r) s += X[r * ldx + c];
    g[c] += s;
  }
}

__device__ __forceinline__ float dleaky(float h, float d) {
  return h > 0.f ? d : kLeaky * d;
}

// d * squash'(x) at the pre-squash x
__device__ __forceinline__ float dsquash(float x, float d, bool use_sigmoid) {
  if (use_sigmoid) {
    const float s = 1.f / (1.f + expf(-x));
    return d * s * (1.f - s);
  }
  return (x > 0.f && x < 1.f) ? d : 0.01f * d;
}

// -- workspace layout ----------------------------------------------------------

constexpr int kParts = 17;  // the K1 weight operands, in their order

// float offsets of each weight gradient in a block's slice (64-float
// aligned, for the tensor-core accumulator loads), then the slice size
struct Layout {
  long long off[kParts + 1];
  __host__ __device__ Layout(int kp, int crp) {
    const long long sizes[kParts] = {
        (long long)kp * 2 * kG1, (long long)crp * 2 * kG1, 2 * kG1, kG1, kG1,
        kG1 * kG2, kG2, kG2 * kG3, kG3, kG3, 1,
        kG1 * kG2, kG2, kG2 * kG3, kG3, kG3, 1};
    long long o = 0;
    for (int i = 0; i < kParts; ++i) {
      off[i] = o;
      o += (sizes[i] + 63) / 64 * 64;
    }
    off[kParts] = o;
  }
};

enum Part { kPairW1, kRayW1, kB1, kAVec, kCVec, kOffTail, kProbTail = 11 };
// within a tail: w2, b2, w3, b3, w4, b4

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
  float* e1_scratch;    // recompute: (gridDim.x, M, 256) f32
  const float* g;       // (n, kb, 2) cotangents [offset | logit]
  float* d_table;       // (S, c_vox), zeroed by the caller
  float* d_ray;         // (n, c_ray)
  float* work;          // (gridDim.x, slice) partials, zeroed by the caller
  long long n, slice;
  int c_vox, c_ray, multires, kp, crp, n_iter, use_sigmoid;
  float init_offset;
};

template <typename T>
struct BwdSmem {
  size_t h1, h2, h3, c, d, dtp, off, doff, tmp, go, gl, re, ret, rf, drf, av,
      cv, total;
  __host__ __device__ static size_t al(size_t b) {
    return (b + 127) / 128 * 128;
  }
  size_t o = 0;
  __host__ __device__ size_t take(size_t bytes) {
    const size_t at = o;
    o = al(o + bytes);
    return at;
  }
  __host__ __device__ BwdSmem(int m, int mr, int kp, int crp, int n_iter) {
    h1 = take((size_t)m * (kp > kG1 ? kp : kG1) * sizeof(T));  // H1 | X
    h2 = take((size_t)m * kG2 * sizeof(T));                      // H2 | dT2
    h3 = take((size_t)m * kG3 * sizeof(T));                      // H3 | dT3
    const size_t cf = (size_t)m * kG2 * 4, ct = (size_t)m * kG1 * sizeof(T);
    c = take(cf > ct ? cf : ct);            // f32 product scratch | T(d_e1)
    d = take((size_t)m * kG1 * 4);          // d_z1 (f32) | d_rows
    dtp = take((size_t)m * kG1 * sizeof(T));  // T(d_z1p)
    off = take((size_t)(n_iter + 1) * m * 4);
    doff = take((size_t)m * 4);
    tmp = take((size_t)m * 4);
    go = take((size_t)m * 4);
    gl = take((size_t)m * 4);
    re = take((size_t)mr * kG1 * 4);
    ret = take((size_t)mr * kG1 * sizeof(T));
    rf = take((size_t)mr * crp * sizeof(T));
    drf = take((size_t)mr * crp * 4);
    av = take(kG1 * 4);
    cv = take(kG1 * 4);
    total = o;
  }
};

// Backward through one decoder tail (layers 2-4) of M rows, given H1, H2, H3
// (the forward's T activations) and DOFF (the cotangent of the tail's
// output). Adds the tail's weight gradients into ws (w2, b2, w3, b3, w4,
// b4), overwrites H2, H3 with the rounded cotangents, and writes d_z1 (f32
// cotangent of layer 1's pre-activation) into D, or adds it when accumulate.
// For the IEF (off_i != nullptr) also adds d_a_vec, d_c_vec into ws_a, ws_c
// and adds sum_c d_z1 * a_vec to DOFF (the cotangent of the iteration's
// input offset).
template <typename T, int M>
__device__ void tail_backward(const T* H1, T* H2, T* H3, float* DOFF,
                              float* C, float* D, bool accumulate,
                              const float* off_i, const float* AV,
                              const TailWeights<T>& w, float* ws, float* ws_a,
                              float* ws_c) {
  float* g_w2 = ws;
  float* g_b2 = g_w2 + (kG1 * kG2 + 63) / 64 * 64;
  float* g_w3 = g_b2 + (kG2 + 63) / 64 * 64;
  float* g_b3 = g_w3 + (kG2 * kG3 + 63) / 64 * 64;
  float* g_w4 = g_b3 + (kG3 + 63) / 64 * 64;
  float* g_b4 = g_w4 + (kG3 + 63) / 64 * 64;
  // layer 4: dW4 = H3^T T(d), db4 = sum d
  for (int c = threadIdx.x; c <= kG3; c += blockDim.x) {
    float s = 0.f;
    if (c < kG3) {
      for (int r = 0; r < M; ++r)
        s = fmaf(to_f32(H3[r * kG3 + c]), to_f32(from_f32<T>(DOFF[r])), s);
      g_w4[c] += s;
    } else {
      for (int r = 0; r < M; ++r) s += DOFF[r];
      g_b4[0] += s;
    }
  }
  __syncthreads();
  // d_t3 = dleaky(h3, T(d) * w4), in C (f32) and, rounded, over H3
  for (int i = threadIdx.x; i < M * kG3; i += blockDim.x) {
    const int r = i / kG3, c = i % kG3;
    const float d = dleaky(to_f32(H3[i]), to_f32(from_f32<T>(DOFF[r])) *
                                              ldg_f32(w.w4 + c));
    C[i] = d;
    H3[i] = from_f32<T>(d);
  }
  __syncthreads();
  colsum_add(C, kG3, M, kG3, g_b3);
  wgrad<T>(H2, kG2, H3, kG3, M, kG2, kG3, g_w3, kG3);
  __syncthreads();
  // d_t2 = dleaky(h2, d_t3 @ W3^T)
  product<T, true>(H3, kG3, w.w3, kG3, M, kG3, kG2, C, kG2, false);
  __syncthreads();
  for (int i = threadIdx.x; i < M * kG2; i += blockDim.x) {
    const float d = dleaky(to_f32(H2[i]), C[i]);
    C[i] = d;
    H2[i] = from_f32<T>(d);
  }
  __syncthreads();
  colsum_add(C, kG2, M, kG2, g_b2);
  wgrad<T>(H1, kG1, H2, kG2, M, kG1, kG2, g_w2, kG2);
  __syncthreads();
  // d_z1 = dleaky(h1, d_t2 @ W2^T), in two 128-column halves through C
  for (int n0 = 0; n0 < kG1; n0 += kG2) {
    product<T, true>(H2, kG2, w.w2 + (size_t)n0 * kG2, kG2, M, kG2, kG2, C,
                     kG2, false);
    __syncthreads();
    for (int i = threadIdx.x; i < M * kG2; i += blockDim.x) {
      const int r = i / kG2, c = i % kG2;
      const float d = dleaky(to_f32(H1[r * kG1 + n0 + c]), C[i]);
      C[i] = d;
      D[r * kG1 + n0 + c] = accumulate ? D[r * kG1 + n0 + c] + d : d;
    }
    __syncthreads();
    if (off_i != nullptr) {
      for (int c = threadIdx.x; c < kG2; c += blockDim.x) {
        float sa = 0.f, sc = 0.f;
        for (int r = 0; r < M; ++r) {
          sa = fmaf(C[r * kG2 + c], off_i[r], sa);
          sc += C[r * kG2 + c];
        }
        ws_a[n0 + c] += sa;
        ws_c[n0 + c] += sc;
      }
      __syncthreads();
      if (threadIdx.x < M) {
        const int r = threadIdx.x;
        float s = 0.f;
        for (int c = 0; c < kG2; ++c) s = fmaf(C[r * kG2 + c], AV[n0 + c], s);
        DOFF[r] += s;
      }
      __syncthreads();
    }
  }
}

template <typename T, int M, bool kFromSaves>
__global__ void __launch_bounds__(kThreads, 1)
    ray_decode_bwd_kernel(const BwdParams<T> p) {
  constexpr int MR = M / kKb;
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdSmem<T> lay(M, MR, p.kp, p.crp, p.n_iter);
  T* H1 = reinterpret_cast<T*>(smem + lay.h1);
  T* X = H1;
  T* H2 = reinterpret_cast<T*>(smem + lay.h2);
  T* H3 = reinterpret_cast<T*>(smem + lay.h3);
  float* C = reinterpret_cast<float*>(smem + lay.c);
  T* DTO = reinterpret_cast<T*>(smem + lay.c);  // T(d_e1) after the IEF
  float* D = reinterpret_cast<float*>(smem + lay.d);
  T* DTP = reinterpret_cast<T*>(smem + lay.dtp);
  float* OFF = reinterpret_cast<float*>(smem + lay.off);
  float* DOFF = reinterpret_cast<float*>(smem + lay.doff);
  float* TMP = reinterpret_cast<float*>(smem + lay.tmp);
  float* GO = reinterpret_cast<float*>(smem + lay.go);
  float* GL = reinterpret_cast<float*>(smem + lay.gl);
  float* RE = reinterpret_cast<float*>(smem + lay.re);
  T* RET = reinterpret_cast<T*>(smem + lay.ret);
  T* RF = reinterpret_cast<T*>(smem + lay.rf);
  float* DRF = reinterpret_cast<float*>(smem + lay.drf);
  float* AV = reinterpret_cast<float*>(smem + lay.av);
  float* CV = reinterpret_cast<float*>(smem + lay.cv);

  const Layout L(p.kp, p.crp);
  float* ws = p.work + (size_t)blockIdx.x * p.slice;
  float* E1G = kFromSaves ? nullptr
                          : p.e1_scratch + (size_t)blockIdx.x * M * kG1;
  const int kp = p.kp, crp = p.crp, c_vox = p.c_vox;
  const int n_trig = 12 * p.multires;
  const long long n_tiles = (p.n + MR - 1) / MR;
  for (int c = threadIdx.x; c < kG1; c += blockDim.x) {
    AV[c] = __ldg(p.a_vec + c);
    CV[c] = __ldg(p.c_vec + c);
  }

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long ray0 = tile * MR;
    auto row_ok = [&](int r) { return ray0 + r / kKb < p.n; };
    auto grow = [&](int r) { return (ray0 + r / kKb) * kKb + r % kKb; };

    __syncthreads();  // the previous tile is done with every buffer
    for (int r = threadIdx.x; r < M; r += blockDim.x) {
      const bool ok = row_ok(r);
      GO[r] = ok ? __ldg(p.g + grow(r) * 2) : 0.f;
      GL[r] = ok ? __ldg(p.g + grow(r) * 2 + 1) : 0.f;
    }
    for (int i = threadIdx.x; i < MR * crp; i += blockDim.x) {
      const int r = i / crp, col = i % crp;
      const long long ray = ray0 + r;
      RF[i] = (ray < p.n && col < p.c_ray)
                  ? ldg_raw(p.ray_feat + ray * p.c_ray + col)
                  : from_f32<T>(0.f);
      DRF[i] = 0.f;
    }

    // stage X = [vox | pos6 | trig | 0] (M x kp, T) into the H1 region
    auto stage_x = [&]() {
      for (int i = threadIdx.x; i < M * kp; i += blockDim.x) {
        const int r = i / kp, col = i % kp;
        T v = from_f32<T>(0.f);
        if (row_ok(r)) {
          const long long prow = grow(r);
          if (col < c_vox) {
            v = ldg_raw(p.vox_table + (long long)__ldg(p.cells + prow) * c_vox +
                        col);
          } else if (col < c_vox + 6) {
            v = from_f32<T>(__ldg(p.pos + prow * 6 + (col - c_vox)));
          } else if (col < c_vox + 6 + n_trig) {
            if constexpr (kFromSaves)
              v = ldg_raw(p.trig + prow * n_trig + (col - c_vox - 6));
            else
              v = from_f32<T>(
                  trig_column(p.pos + prow * 6, col - c_vox - 6, p.multires));
          }
        }
        X[i] = v;
      }
    };

    // layer 1 of one decoder (half 0: IEF offset, 1: probability) from its
    // d_z1 in D (f32): b1, ray_w1 and pair_w1 gradients and d_ray_feat;
    // leaves T(d_z1) in DT for the d_rows product
    auto layer1 = [&](int half, T* DT) {
      colsum_add(D, kG1, M, kG1, ws + L.off[kB1] + half * kG1);
      for (int i = threadIdx.x; i < MR * kG1; i += blockDim.x) {
        const int r = i / kG1, c = i % kG1;
        float s = 0.f;
        for (int k = 0; k < kKb; ++k) s += D[(r * kKb + k) * kG1 + c];
        RE[i] = s;
        RET[i] = from_f32<T>(s);
      }
      for (int i = threadIdx.x; i < M * kG1; i += blockDim.x)
        DT[i] = from_f32<T>(D[i]);
      stage_x();
      __syncthreads();
      wgrad<T>(X, kp, DT, kG1, M, kp, kG1, ws + L.off[kPairW1] + half * kG1,
               2 * kG1);
      wgrad<T>(RF, crp, RET, kG1, MR, crp, kG1,
               ws + L.off[kRayW1] + half * kG1, 2 * kG1);
      // d_ray_feat += T(d_re) @ ray_w1[:, half]^T; the probability half
      // runs first and sets DRF
      product<T, true>(RET, kG1, p.ray_w1 + half * kG1, 2 * kG1, MR, kG1, crp,
                       DRF, crp, /*acc=*/true);
      __syncthreads();
    };

    // -- probability decoder: forward recompute from z1p, then backward ----
    if constexpr (kFromSaves) {
      for (int i = threadIdx.x; i < M * kG1; i += blockDim.x) {
        const int r = i / kG1, c = i % kG1;
        const float z = row_ok(r) ? ldg_f32(p.z1p + grow(r) * kG1 + c) : 0.f;
        H1[i] = from_f32<T>(leaky(z));
      }
    } else {
      // layer 1 as K1 computes it: the per-ray part RAY = RF @ ray_w1 (in
      // C), then e1 = X @ W_off + RAY + b1 (into the scratch slice) and
      // z1p = X @ W_prob + RAY + b1 (into H1 = act(z1p), over X)
      float* RAY = C;
      stage_x();
      __syncthreads();
      fma_tile<T, MR>(RF, crp, p.ray_w1, 2 * kG1, crp, 2 * kG1, RAY, 2 * kG1);
      tile_product<T, M, kG1>(X, kp, p.pair_w1, 2 * kG1, kp, D, kG1);
      __syncthreads();
      for (int i = threadIdx.x; i < M * kG1; i += blockDim.x) {
        const int r = i / kG1, c = i % kG1;
        E1G[i] = D[i] + RAY[(r / kKb) * 2 * kG1 + c] + __ldg(p.b1 + c);
      }
      __syncthreads();
      tile_product<T, M, kG1>(X, kp, p.pair_w1 + kG1, 2 * kG1, kp, D, kG1);
      __syncthreads();
      for (int i = threadIdx.x; i < M * kG1; i += blockDim.x) {
        const int r = i / kG1, c = i % kG1;
        H1[i] = from_f32<T>(leaky(D[i] + RAY[(r / kKb) * 2 * kG1 + kG1 + c] +
                                  __ldg(p.b1 + kG1 + c)));
      }
    }
    __syncthreads();
    mlp_tail<T, M>(H1, C, H2, H3, p.prob, TMP, /*accumulate=*/false);
    for (int r = threadIdx.x; r < M; r += blockDim.x)
      DOFF[r] = dsquash(TMP[r] + __ldg(p.prob.b4), GL[r], p.use_sigmoid);
    __syncthreads();
    tail_backward<T, M>(H1, H2, H3, DOFF, C, D, false, nullptr, AV, p.prob,
                        ws + L.off[kProbTail], nullptr, nullptr);
    layer1(1, DTP);

    // -- IEF offset decoder: the offsets of every iteration, then backward --
    for (int r = threadIdx.x; r < M; r += blockDim.x) OFF[r] = p.init_offset;
    auto ief_forward = [&](int it) {  // H1..H3 of iteration it, into TMP
      for (int i = threadIdx.x; i < M * kG1; i += blockDim.x) {
        const int r = i / kG1, c = i % kG1;
        float e = 0.f;
        if (row_ok(r)) {
          if constexpr (kFromSaves)
            e = ldg_f32(p.e1 + grow(r) * kG1 + c);
          else
            e = E1G[i];
        }
        H1[i] = from_f32<T>(leaky(e + OFF[it * M + r] * AV[c] + CV[c]));
      }
      __syncthreads();
      mlp_tail<T, M>(H1, C, H2, H3, p.off, TMP, /*accumulate=*/false);
    };
    const float b4 = __ldg(p.off.b4);
    for (int it = 0; it < p.n_iter; ++it) {
      ief_forward(it);
      for (int r = threadIdx.x; r < M; r += blockDim.x)
        OFF[(it + 1) * M + r] = (OFF[it * M + r] + TMP[r]) + b4;
      __syncthreads();
    }
    for (int r = threadIdx.x; r < M; r += blockDim.x)
      DOFF[r] = dsquash(OFF[p.n_iter * M + r], GO[r], p.use_sigmoid);
    for (int it = p.n_iter - 1; it >= 0; --it) {
      ief_forward(it);  // its __syncthreads orders the DOFF writes above
      tail_backward<T, M>(H1, H2, H3, DOFF, C, D, it != p.n_iter - 1,
                          OFF + it * M, AV, p.off, ws + L.off[kOffTail],
                          ws + L.off[kAVec], ws + L.off[kCVec]);
    }
    layer1(0, DTO);

    // -- d_rows = T(d_e1) @ W1v_off^T + T(d_z1p) @ W1v_prob^T, into D ------
    product<T, true>(DTO, kG1, p.pair_w1, 2 * kG1, M, kG1, c_vox, D, c_vox,
                     false);
    __syncthreads();
    product<T, true>(DTP, kG1, p.pair_w1 + kG1, 2 * kG1, M, kG1, c_vox, D,
                     c_vox, true);
    __syncthreads();
    for (int i = threadIdx.x; i < M * c_vox; i += blockDim.x) {
      const int r = i / c_vox, col = i % c_vox;
      if (row_ok(r)) {
        const long long cell = __ldg(p.cells + grow(r));
        atomicAdd(p.d_table + cell * c_vox + col, D[i]);
      }
    }
    for (int i = threadIdx.x; i < MR * p.c_ray; i += blockDim.x) {
      const int r = i / p.c_ray, col = i % p.c_ray;
      if (ray0 + r < p.n) p.d_ray[(ray0 + r) * p.c_ray + col] = DRF[r * crp + col];
    }
  }
}

// out[e] = sum over the blocks b, in order, of work[b * slice + e]
__global__ void reduce_slices(const float* __restrict__ work, long long slice,
                              int blocks, float* __restrict__ out) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < slice; e += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < blocks; ++b) s += work[(size_t)b * slice + e];
    out[e] = s;
  }
}

template <typename T, int M, bool kFromSaves>
int launch(const BwdParams<T>& p, int blocks, float* out, void* stream) {
  constexpr int MR = M / kKb;
  const BwdSmem<T> lay(M, MR, p.kp, p.crp, p.n_iter);
  auto kernel = ray_decode_bwd_kernel<T, M, kFromSaves>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kThreads, lay.total, (cudaStream_t)stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long grid = (p.slice + kThreads - 1) / kThreads;
  reduce_slices<<<(unsigned)(grid < 1024 ? grid : 1024), kThreads, 0,
                  (cudaStream_t)stream>>>(p.work, p.slice, blocks, out);
  return (int)cudaGetLastError();
}

template <typename T>
int run(void* const* ptrs, long long n, long long c_vox, long long c_ray,
        long long multires, long long kp, long long crp, long long n_iter,
        long long use_sigmoid, long long blocks, float init_offset,
        void* stream) {
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
  p.d_table = (float*)ptrs[25];
  p.d_ray = (float*)ptrs[26];
  p.work = (float*)ptrs[27];
  float* out = (float*)ptrs[28];
  p.e1_scratch = (float*)ptrs[29];
  p.n = n;
  p.slice = Layout((int)kp, (int)crp).off[kParts];
  p.c_vox = (int)c_vox;
  p.c_ray = (int)c_ray;
  p.multires = (int)multires;
  p.kp = (int)kp;
  p.crp = (int)crp;
  p.n_iter = (int)n_iter;
  p.use_sigmoid = (int)use_sigmoid;
  p.init_offset = init_offset;
  if (kp % 16 || crp % 16 || kp < c_vox + 6 + 12 * multires || crp < c_ray ||
      kp > kG1 || c_vox % 32 || c_vox > kG1 || n_iter < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const bool from_saves = p.e1 != nullptr;
  if (from_saves ? (p.z1p == nullptr || p.trig == nullptr)
                 : p.e1_scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  constexpr int M = sizeof(T) == 2 ? 64 : 32;
  return from_saves ? launch<T, M, true>(p, (int)blocks, out, stream)
                    : launch<T, M, false>(p, (int)blocks, out, stream);
}

}  // namespace

// The float offset of each weight gradient (in the K1 operand order) in the
// output of idt_ray_decode_bwd, then its size: out[0..17].
extern "C" int idt_ray_decode_bwd_layout(long long kp, long long crp,
                                         long long* out, void* /*stream*/) {
  const Layout L((int)kp, (int)crp);
  for (int i = 0; i <= kParts; ++i) out[i] = L.off[i];
  return 0;
}

// ptrs: vox_table, cells, pos, ray_feat, pair_w1, ray_w1, b1, a_vec, c_vec,
// off_{w2,b2,w3,b3,w4,b4}, prob_{w2,b2,w3,b3,w4,b4} (as for idt_ray_decode),
// e1, z1p, trig (K2's saves; all null for the recompute instance), g (n, kb,
// 2) f32 cotangents, d_table (S, c_vox) f32 zeroed, d_ray (n, c_ray) f32,
// work (blocks, slice) f32 zeroed, out (slice,) f32 weight gradients,
// e1_scratch (blocks, rows per block, 256) f32 for the recompute instance
// (else null) (30 device pointers). Returns a cudaError_t.
extern "C" int idt_ray_decode_bwd(void* const* ptrs, long long n,
                                  long long c_vox, long long c_ray,
                                  long long multires, long long kp,
                                  long long crp, long long n_iter,
                                  long long is_bf16, long long use_sigmoid,
                                  long long blocks, float init_offset,
                                  void* stream) {
  return is_bf16 ? run<__nv_bfloat16>(ptrs, n, c_vox, c_ray, multires, kp,
                                      crp, n_iter, use_sigmoid, blocks,
                                      init_offset, stream)
                 : run<float>(ptrs, n, c_vox, c_ray, multires, kp, crp,
                              n_iter, use_sigmoid, blocks, init_offset,
                              stream);
}
