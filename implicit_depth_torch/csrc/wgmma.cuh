// Hopper's warpgroup products (wgmma) for the 64-row tiles of K3's Pass A
// (ray_decode_bwd_wg.cuh): bf16 operands, f32 accumulators in registers.
//
// A product here is D[64 x N] = A[64 x K] @ op(B) of a tile, computed by
// the tile's two warpgroups, each on its own NW = N / 2 columns (a block
// may run several tiles, each its own A, on the same B): A (the tile's
// activations, row-major in shared memory with 16-byte aligned rows) goes
// to registers by ldmatrix, one k-step of 16 at a time; B (the weights, in
// global memory) passes through shared memory in slabs of KS k-rows,
// copied by every thread of the block with cp.async into the canonical
// no-swizzle layout of wgmma: 8 x 8 core matrices of 128 contiguous bytes,
// core matrix (n / 8, k / 8) at element ((n / 8) * (KS / 8) + k / 8) * 64
// (the descriptor's lbo 128 bytes along k, sbo KS * 16 bytes along n).
// Rows of a core matrix are 8 n of one k (kTransB false: op(B) = B[K x N]
// row-major, wgmma's transposed B) or 8 k of one n (kTransB: op(B) = B^T
// of B[N x K] row-major, wgmma's K-major B). A ring
// of kSlabs buffers turns across the products of a block, kAhead slabs in
// flight ahead of the one in use (product's `at`, `primed`, `next`), and
// one __syncthreads a slab makes the slab visible and frees the buffer of
// the slab before it.
//
// Accumulator element i of a thread (warp q of its warpgroup, lane l) is
// row 16 q + l / 4 + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 (l % 4) + (i &
// 1) of its warpgroup's NW columns (acc_row, acc_col).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace idt {
namespace wg {

// bf16 elements of one slab buffer (8 KB), and the buffers of the ring
constexpr int kSlabElems = 4096, kSlabs = 3, kAhead = kSlabs - 1;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// matrix descriptor of a no-swizzle operand: start, the byte offsets
// between core matrices along k (lbo) and along n (sbo)
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}
__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// this thread's shared-memory writes (cp.async's included, once waited
// for) made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of d across the wgmma
// fences and waits
template <int R>
__device__ __forceinline__ void hold(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// four 8 x 8 bf16 matrices: lane l gives the address of row l % 16,
// columns 8 (l / 16)..; r = wgmma's A fragment of a 16 x 16 block
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void cp16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// wgmma m64nNWk16, A from registers, B by descriptor (kT: B transposed,
// i.e. its core matrices' rows run along n), D += A B
template <int NW>
struct Mma;
template <>
struct Mma<8> {
  template <int kT>
  static __device__ __forceinline__ void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, %10;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
          "n"(kT));
  }
};
template <>
struct Mma<16> {
  template <int kT>
  static __device__ __forceinline__ void run(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
          "n"(kT));
  }
};
template <>
struct Mma<32> {
  template <int kT>
  static __device__ __forceinline__ void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
          "n"(kT));
  }
};
template <>
struct Mma<64> {
  template <int kT>
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
          "n"(kT));
  }
};

// accumulator element i's row in the tile and column in the warpgroup's NW
__device__ __forceinline__ int acc_row(int i) {
  return 16 * ((threadIdx.x / 32) % 4) + (threadIdx.x % 32) / 4 +
         8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x % 4) + (i & 1);
}

// The weights of one product: op(B) over columns [0, n_lim) (zero past
// them) and K rows, as above (ldb: B's row stride; trans: B is N x K), in
// slabs of ks k-rows of the kn = 2 NW columns of a tile's two warpgroups.
// K and n_lim are multiples of 8, B's pieces 16-byte aligned; a slab row
// holds 2^lg 16-byte pieces.
struct Slabs {
  const __nv_bfloat16* B;
  int ldb, K, n_lim, kn, ks, lg;
  bool trans;
  __device__ int count() const { return (K + ks - 1) / ks; }
  // slab j into buf: cp.async by every thread of the block (nothing past
  // the last slab)
  __device__ __forceinline__ void load(__nv_bfloat16* buf, int j) const {
    const int k0 = j * ks, per = 1 << lg;
    if (k0 >= K) return;
    if (trans) {  // pieces of 8 k of one n
      for (int i = threadIdx.x; i < kn << lg; i += blockDim.x) {
        const int n = i >> lg, q = i & (per - 1), k = k0 + 8 * q;
        const bool ok = n < n_lim && k < K;
        cp16(buf + ((n / 8) * per + q) * 64 + (n % 8) * 8,
             ok ? B + (size_t)n * ldb + k : B, ok);
      }
    } else {  // pieces of 8 n of one k
      for (int i = threadIdx.x; i < ks << lg; i += blockDim.x) {
        const int kr = i >> lg, q = i & (per - 1), k = k0 + kr;
        const bool ok = 8 * q < n_lim && k < K;
        cp16(buf + (q * (ks / 8) + kr / 8) * 64 + (kr % 8) * 8,
             ok ? B + (size_t)k * ldb + 8 * q : B, ok);
      }
    }
  }
};

// k-rows of a slab of a product NW columns a warpgroup wide
template <int NW>
__host__ __device__ constexpr int slab_rows() {
  return kSlabElems / (2 * NW) < 128 ? kSlabElems / (2 * NW) : 128;
}
__host__ __device__ constexpr int log2i(int v) {
  return v <= 1 ? 0 : 1 + log2i(v / 2);
}
template <int NW, bool kTransB>
__device__ __forceinline__ Slabs slabs(const __nv_bfloat16* B, int ldb,
                                       int K, int n_lim) {
  constexpr int KS = slab_rows<NW>();
  return Slabs{B,      ldb, K, n_lim, 2 * NW, KS,
               log2i(kTransB ? KS / 8 : 2 * NW / 8), kTransB};
}

// acc (this warpgroup's columns [wg * NW, (wg + 1) * NW) of the product,
// wg its warpgroup of its tile's two: threads 256 t .. 256 t + 255 run tile
// t) = A[64 x K] (the tile's: bf16, shared, row stride lda, 16-byte aligned
// rows; columns past K may hold anything) @ op(B), w = slabs<NW,
// kTransB>(B, ...): every tile of the block on the same slabs. The
// slabs stream through the ring in order, product after product: `at`
// counts the slabs the tile has used (slab j of a product in buffer (at +
// j) % kSlabs), and a product given `next` (the weights of the product the
// block runs next) issues next's first kAhead slabs in its last
// iterations, so that next starts with them in flight (`primed`: this
// product's first kAhead were issued so). The caller has made A's elements
// visible (a
// __syncthreads since they were written: the first slab's does it). Every
// thread of the block calls it.
template <int NW, bool kTransB>
__device__ __forceinline__ void product(const __nv_bfloat16* A, int lda,
                                        const Slabs& w, __nv_bfloat16* ring,
                                        int& at, float (&acc)[NW / 2],
                                        bool primed = false,
                                        const Slabs* next = nullptr) {
  constexpr int KS = slab_rows<NW>(), kSteps = KS / 16;
  const int tid = threadIdx.x, lane = tid % 32;
  const int wgi = (tid / 128) % 2, wq = (tid / 32) % 4;
  const int K = w.K, slabs = w.count();
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
  auto buffer = [&](int j) { return ring + ((at + j) % kSlabs) * kSlabElems; };
  // slab j of the stream: this product's, then next's first kAhead
  auto issue = [&](int j) {
    if (j < slabs)
      w.load(buffer(j), j);
    else if (next != nullptr)
      next->load(buffer(j), j - slabs);
  };
  // one commit group a slab (empty past the stream), so that waiting for
  // all but the newest kAhead - 1 groups leaves slab s complete. Primed,
  // the previous product issued this one's first kAhead slabs, empty past
  // its last: next's first ones follow them
  for (int j = primed ? slabs : 0; j < kAhead; ++j) {
    issue(j);
    cp_commit();
  }
  const __nv_bfloat16* arow = A + (16 * wq + lane % 16) * lda + (lane / 16) * 8;
  for (int s = 0; s < slabs; ++s) {
    cp_wait<kAhead - 1>();
    fence_async_smem();
    __syncthreads();  // slab s is in; slab s - 1's buffer is free
    issue(s + kAhead);
    cp_commit();
    const __nv_bfloat16* buf = buffer(s);
    const int k0 = s * KS;
    uint32_t a[kSteps][4];
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const int k = k0 + 16 * kk;
      if (k < K) {
        ldsm4(a[kk], arow + k);
        if (k + 8 >= K) a[kk][2] = a[kk][3] = 0u;  // K = 8 mod 16
      }
    }
    hold(acc);
    fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      if (k0 + 16 * kk < K)
        Mma<NW>::template run<kTransB ? 0 : 1>(
            acc, a[kk],
            desc(buf + ((wgi * NW / 8) * (KS / 8) + 2 * kk) * 64, 128,
                 (KS / 8) * 128));
    }
    commit();
    wait_all();
    hold(acc);
  }
  at += slabs;
}

}  // namespace wg
}  // namespace idt
