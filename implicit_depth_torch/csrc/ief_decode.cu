// K4: stage-2 (refine) per-ray IEF offset decode.
//
// Replaces implicit_depth_tpu/ops/pallas_ray_decode.py::fused_ief_rows
// (_ief_fwd_impl and its Pallas kernel): each ray's embedding, given as its
// parts [end voxel feature | rc = (roi, dir_e) | pos_e], goes through a
// 2-iteration IEF decoder (4g -> 2g -> g -> 1 for the refine imnet_gf g in
// {8, 16, 32, 64, 128}; 256 -> 128 -> 64 -> 1 by default; LeakyReLU 0.02,
// soft clamp) to one offset.
//
// What bounds it on the H100: operations (~2.6e10 FLOP per launch at 76,800
// rays against ~80 MB of operands: ~0.03 ms at the bf16 tensor-core peak).
// The design is K1's (ray_decode.cu) without the slot dimension: the parts
// are concatenated only in shared memory (the (N, 334) embedding never
// exists in device memory), and layer 1 is computed once and hoisted out of
// the iterations with the offset encoder folded into a rank-1 update.
// bf16: ief_decode_tc, a persistent block per SM over tiles of 64 rows on
// decode_tile.cuh's staged mma.sync products, E1 in registers; each tile's
// rc and pos_e rows load as one contiguous block in 16-byte pieces, its end
// rows by cp.async during the tile before (kSingle, the layout of wide
// inputs and imnet_gf 128, tile::Smem: once layer 1 has read X, behind a
// barrier; kChunked, the layout of the widest, the rows of the reference's
// roi_out_bbox 4 or pnet_out 512 at imnet_gf 128: X staged in chunks of
// whole slabs, chunked_product, the rc and pos columns 2 bytes a load).
// The first version (wmma
// fragments from L2, f32 products through shared memory, 2-byte loads)
// spent ~53% of its time in products, ~66% in their f32 round trips and
// elementwise passes and ~30% in input loads (scripts/attribute_k1_k4.py).
// f32 (cross-checks only): ief_decode_kernel, 32 rows a block where that
// block fits, else 16, CUDA-core FMA products with the weights read from L2.
#include "decode_tile.cuh"

namespace {

using namespace idt;

template <typename T>
struct Smem {
  size_t x, e1, c, h, off, total;
  __host__ __device__ static size_t al(size_t b) { return (b + 127) / 128 * 128; }
  __host__ __device__ Smem(int m, int kp, int g) {
    const int g1 = 4 * g, g2 = 2 * g, g23 = 3 * g;
    size_t o = 0;
    x = o;      // layer-1 input [end | rc | pos | 0]; later H2 | H3
    o = al(o + (size_t)m * (kp > g23 ? kp : g23) * sizeof(T));
    e1 = o;     // layer-1 pre-activation (iteration-invariant part)
    o = al(o + (size_t)m * g1 * 4);
    c = o;      // product scratch (layers 2 and 3)
    o = al(o + (size_t)m * g2 * 4);
    h = o;      // rounded layer-1 activation
    o = al(o + (size_t)m * g1 * sizeof(T));
    off = o;
    o = al(o + (size_t)m * 4);
    total = o;
  }
};

// rows of an f32 block: 32 where that block fits, else 16
int f32_rows(int kp, int g) {
  return Smem<float>(32, kp, g).total <= tile::kMaxSmem ? 32 : 16;
}

template <typename T>
struct Params {
  const T* end;        // (n, c_end)
  const T* rc;         // (n, c_rc)
  const T* pos;        // (n, c_pos)
  const T* w1;         // (kp, 4g) rows [end | rc | pos | 0]
  const float* b1;     // (4g,)
  const float* a_vec;  // (4g,)
  const float* c_vec;  // (4g,)
  TailWeights<T> tail;
  float* out;          // (n,)
  long long n;
  int c_end, c_rc, c_pos, kp, n_iter, use_sigmoid;
  float init_offset;
};

template <typename T, int M, int G>
__global__ void __launch_bounds__(kThreads, 1)
    ief_decode_kernel(const Params<T> p) {
  constexpr int kG1 = Widths<G>::g1, kG2 = Widths<G>::g2;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<T> lay(M, p.kp, G);
  T* X = reinterpret_cast<T*>(smem + lay.x);
  float* E1 = reinterpret_cast<float*>(smem + lay.e1);
  float* C = reinterpret_cast<float*>(smem + lay.c);
  T* H = reinterpret_cast<T*>(smem + lay.h);
  float* OFF = reinterpret_cast<float*>(smem + lay.off);
  T* H2 = X;
  T* H3 = X + M * kG2;

  const long long row0 = (long long)blockIdx.x * M;
  const int kp = p.kp;
  const int o_rc = p.c_end, o_pos = p.c_end + p.c_rc,
            o_pad = p.c_end + p.c_rc + p.c_pos;
  for (int i = threadIdx.x; i < M * kp; i += blockDim.x) {
    const int r = i / kp, col = i % kp;
    const long long row = row0 + r;
    T v = from_f32<T>(0.f);
    if (row < p.n) {
      if (col < o_rc)
        v = ldg_raw(p.end + row * p.c_end + col);
      else if (col < o_pos)
        v = ldg_raw(p.rc + row * p.c_rc + (col - o_rc));
      else if (col < o_pad)
        v = ldg_raw(p.pos + row * p.c_pos + (col - o_pos));
    }
    X[i] = v;
  }
  __syncthreads();

  tile_product<T, M, kG1>(X, kp, p.w1, kG1, kp, E1, kG1);
  __syncthreads();
  for (int i = threadIdx.x; i < M * kG1; i += blockDim.x)
    E1[i] += __ldg(p.b1 + i % kG1);
  if (threadIdx.x < M) OFF[threadIdx.x] = p.init_offset;
  __syncthreads();

  ief_loop<T, M, G>(E1, H, C, H2, H3, p.a_vec, p.c_vec, p.tail, OFF,
                    p.n_iter);

  if (threadIdx.x < M && row0 + threadIdx.x < p.n)
    p.out[row0 + threadIdx.x] = squash(OFF[threadIdx.x], p.use_sigmoid);
}

// -- bf16: the staged tensor-core kernel -------------------------------------

template <int G, int kLay>
__global__ void __launch_bounds__(kThreads, 1)
    ief_decode_tc(const Params<__nv_bfloat16> p) {
  using namespace tile;
  constexpr bool kSingle = kLay == tile::kSingle, kChunk = kLay == kChunked;
  constexpr int kG1 = Widths<G>::g1, kG2 = Widths<G>::g2, kG3 = Widths<G>::g3;
  extern __shared__ __align__(128) unsigned char smem[];
  const tile::Smem lay(p.kp, 0, G, kLay);
  // X of the even and of the odd tiles (by the block's tile count)
  auto x_of = [&](int parity) {
    return reinterpret_cast<bf16*>(smem + (parity ? lay.x1 : lay.x0));
  };
  bf16* H = reinterpret_cast<bf16*>(smem + lay.h);
  bf16* H2 = reinterpret_cast<bf16*>(smem + lay.h2);
  float* OFF = reinterpret_cast<float*>(smem + lay.off);
  float* L4 = reinterpret_cast<float*>(smem + lay.l4);
  Seg* segs = reinterpret_cast<Seg*>(smem + lay.segs);

  const int kp = p.kp, ldx = ld_of(kp);
  const int o_rc = p.c_end, o_pos = p.c_end + p.c_rc,
            o_pad = p.c_end + p.c_rc + p.c_pos;
  const long long n_tiles = (p.n + kM - 1) / kM;
  // the schedule: layer 1, then the tail once per IEF iteration
  if (threadIdx.x == 0) {
    segs[0] = {p.w1, kG1, kp, kG1};
    for (int i = 0; i < p.n_iter; ++i) {
      segs[1 + 2 * i] = {p.tail.w2, kG2, kG1, kG2};
      segs[2 + 2 * i] = {p.tail.w3, kG3, kG2, kG3};
    }
  }
  // the padding columns stay 0 (the chunked layout writes them with each
  // chunk)
  for (int i = threadIdx.x; !kChunk && i < 2 * kM * (kp - o_pad);
       i += blockDim.x) {
    const int r = i / (kp - o_pad);
    x_of(r / kM)[(r % kM) * ldx + o_pad + i % (kp - o_pad)] =
        __float2bfloat16_rn(0.f);
  }
  __syncthreads();
  Pipe pipe;
  pipe.init(reinterpret_cast<bf16*>(smem + lay.ring), segs, 1 + 2 * p.n_iter);
  // the end rows of a tile into X (16-byte rows: c_end % 8 == 0)
  auto end_rows = [&](long long t, bf16* X) {
    const long long row0 = t * kM;
    rows_async(
        [&](int r) -> const bf16* {
          return row0 + r < p.n ? p.end + (row0 + r) * p.c_end : nullptr;
        },
        kM, p.c_end, X, ldx, p.end);
  };
  if (!kChunk && blockIdx.x < n_tiles) end_rows(blockIdx.x, x_of(0));
  pipe.start();

  int parity = 0;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x, parity ^= 1) {
    bf16* X = x_of(parity);
    const long long row0 = t * kM;
    const int valid = (int)min((long long)kM, p.n - row0);
    if (!kChunk) {
      stage_rows(p.rc + row0 * p.c_rc, valid, kM, p.c_rc, X, ldx, o_rc);
      stage_rows(p.pos + row0 * p.c_pos, valid, kM, p.c_pos, X, ldx, o_pos);
    }
    if (threadIdx.x < kM) OFF[threadIdx.x] = p.init_offset;
    // the next tile's end rows land while this one runs
    if (kLay == kDouble && t + gridDim.x < n_tiles)
      end_rows(t + gridDim.x, x_of(parity ^ 1));

    E1Acc<G> e1;
    if constexpr (kChunk) {
      // columns [k0, k0 + kn) of X into its chunk buffer: the end rows by
      // cp.async, the rc and pos rows (which start anywhere) and the
      // padding an element a thread
      chunked_product<kG1>(pipe, X, lay.chunk, kp, e1, [&](int k0, int kn) {
        const int ldc = ld_of(lay.chunk);
        if (k0 < o_rc)
          rows_async(
              [&](int r) -> const bf16* {
                return r < valid ? p.end + (row0 + r) * p.c_end + k0
                                 : nullptr;
              },
              kM, min(k0 + kn, o_rc) - k0, X, ldc, p.end);
        const int c0 = max(k0, o_rc) - k0;
        for (int i = threadIdx.x; i < kM * (kn - c0); i += blockDim.x) {
          const int r = i / (kn - c0), col = k0 + c0 + i % (kn - c0);
          const long long row = row0 + r;
          bf16 v = __float2bfloat16_rn(0.f);
          if (r < valid) {
            if (col < o_pos)
              v = ldg_raw(p.rc + row * p.c_rc + (col - o_rc));
            else if (col < o_pad)
              v = ldg_raw(p.pos + row * p.c_pos + (col - o_pos));
          }
          X[r * ldc + col - k0] = v;
        }
      });
    } else {
      product<kM, kG1>(pipe, X, ldx, kp, e1);
    }
    if constexpr (kSingle) {  // X is read: the next tile's end rows
      __syncthreads();
      if (t + gridDim.x < n_tiles) end_rows(t + gridDim.x, X);
    }
    for_pairs<kM, kG1>(e1, [&](int, int c, float& v0, float& v1) {
      const float2 b = ldg2(p.b1 + c);
      v0 += b.x;
      v1 += b.y;
    });
    ief<G>(pipe, e1, H, H2, L4, p.a_vec, p.c_vec, p.tail, OFF, p.n_iter);

    if (threadIdx.x < valid)
      p.out[row0 + threadIdx.x] = squash(OFF[threadIdx.x], p.use_sigmoid);
  }
  pipe.drain();
}

template <int G, int kLay>
int launch_tc(const Params<__nv_bfloat16>& p, void* stream) {
  const tile::Smem lay(p.kp, 0, G, kLay);
  auto kernel = ief_decode_tc<G, kLay>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (p.n + tile::kM - 1) / tile::kM;
  const long long blocks = tiles < sms ? tiles : sms;  // one per SM
  kernel<<<(unsigned)blocks, kThreads, lay.total, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int M, int G>
int launch(const Params<T>& p, void* stream) {
  const Smem<T> lay(M, p.kp, G);
  auto kernel = ief_decode_kernel<T, M, G>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (p.n + M - 1) / M;
  kernel<<<(unsigned)blocks, kThreads, lay.total, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int run(void* const* ptrs, long long n, long long c_end, long long c_rc,
        long long c_pos, long long kp, long long n_iter, long long g,
        long long use_sigmoid, float init_offset, void* stream) {
  Params<T> p;
  p.end = (const T*)ptrs[0];
  p.rc = (const T*)ptrs[1];
  p.pos = (const T*)ptrs[2];
  p.w1 = (const T*)ptrs[3];
  p.b1 = (const float*)ptrs[4];
  p.a_vec = (const float*)ptrs[5];
  p.c_vec = (const float*)ptrs[6];
  p.tail.w2 = (const T*)ptrs[7];
  p.tail.b2 = (const float*)ptrs[8];
  p.tail.w3 = (const T*)ptrs[9];
  p.tail.b3 = (const float*)ptrs[10];
  p.tail.w4 = (const T*)ptrs[11];
  p.tail.b4 = (const float*)ptrs[12];
  p.out = (float*)ptrs[13];
  p.n = n;
  p.c_end = (int)c_end;
  p.c_rc = (int)c_rc;
  p.c_pos = (int)c_pos;
  p.kp = (int)kp;
  p.n_iter = (int)n_iter;
  p.use_sigmoid = (int)use_sigmoid;
  p.init_offset = init_offset;
  if (kp % 16 || kp < c_end + c_rc + c_pos) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  return with_width(g, [&](auto w) {
    constexpr int G = decltype(w)::value;
    if constexpr (sizeof(T) == 2) {
      const tile::Smem lay((int)kp, 0, G);
      if (c_end % 8 || n_iter > (tile::kMaxSegs - 1) / 2 ||
          lay.total > tile::kMaxSmem)
        return (int)cudaErrorInvalidValue;
      if (lay.layout() == tile::kDouble)
        return launch_tc<G, tile::kDouble>(p, stream);
      if (lay.layout() == tile::kSingle)
        return launch_tc<G, tile::kSingle>(p, stream);
      return launch_tc<G, tile::kChunked>(p, stream);
    } else {
      const int m = f32_rows((int)kp, G);
      if (Smem<T>(m, (int)kp, G).total > tile::kMaxSmem)
        return (int)cudaErrorInvalidValue;
      return m == 32 ? launch<T, 32, G>(p, stream)
                     : launch<T, 16, G>(p, stream);
    }
  });
}

}  // namespace

// ptrs: end, rc, pos, w1, b1, a_vec, c_vec, w2, b2, w3, b3, w4, b4, out
// (14 device pointers). g: imnet_gf, in {8, 16, 32, 64, 128}. Returns a
// cudaError_t.
extern "C" int idt_ief_decode(void* const* ptrs, long long n, long long c_end,
                              long long c_rc, long long c_pos, long long kp,
                              long long n_iter, long long g, long long is_bf16,
                              long long use_sigmoid, float init_offset,
                              void* stream) {
  return is_bf16 ? run<__nv_bfloat16>(ptrs, n, c_end, c_rc, c_pos, kp, n_iter,
                                      g, use_sigmoid, init_offset, stream)
                 : run<float>(ptrs, n, c_end, c_rc, c_pos, kp, n_iter, g,
                              use_sigmoid, init_offset, stream);
}

// Dynamic shared memory (bytes) of one block of K4 at these widths
// (ops/ray_decode.py::decode_plan mirrors it).
extern "C" long long idt_ief_decode_smem(long long kp, long long g,
                                         long long is_bf16) {
  return is_bf16 ? (long long)idt::tile::Smem((int)kp, 0, (int)g).total
                 : (long long)Smem<float>(f32_rows((int)kp, (int)g), (int)kp,
                                          (int)g)
                       .total;
}
