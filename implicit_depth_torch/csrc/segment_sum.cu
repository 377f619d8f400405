// Segment sum in a fixed order: rows added by key into an f32 table.
//
// Replaces no TPU kernel. The JAX package trains the `global` and dense
// decodes through autograd of xla_pair_decode, where XLA sums the gathered
// rows' gradients itself; the port's recompute backward
// (ops/pair_decode.py::pair_decode_bwd_chunked) gathers a chunk's voxel and
// ray rows and has to lay their gradients back onto the voxel table and the
// per-ray rows. PyTorch's sorted index_put_(accumulate=True) gives each
// distinct index one warp, which walks all of that index's rows in series:
// many rays cross one voxel, so a chunk's time was set by its longest chain
// of duplicates (thousands of rows), not by its bytes.
//
// What bounds it on the H100: bytes. A chunk of 2^17 rows of 128 f32 and
// 155 bf16 columns is ~110 MB read once, ~35 us at 3.35 TB/s; the table's
// rows are read and written once a segment. At 760,000 rows in 6 chunks
// (chip_smoke.py phase 44; H100 80GB HBM3, 700 W) the kernels took 2.03
// device ms against a bound of 0.47 ms by bytes, 1.32 of it the ray rows'
// pass 1, where nearly every row is a segment of its own and the warp waits
// for each table row it adds to.
//
// Design:
//   * The caller sorts the rows by key (a stable sort, so a segment's rows
//     keep their order) and passes the sorted keys (table rows) and the
//     order (row positions).
//   * Pass 1 (`segment_sum_tile`) splits the sorted positions into fixed
//     tiles of kTileRows, one warp a tile, so that a long segment is spread
//     over many warps. The warp walks its tile's rows in order, kBatch rows'
//     loads in flight, each lane holding up to kMaxCols columns a slab
//     (a wider row takes more slabs, blockIdx.y). Each run of one key in the
//     tile is summed in f32 from 0 in row order. A run that is its segment
//     whole is added to its table row; a run whose segment goes on into the
//     tile before or after is written to the tile's partials: slot 0 for
//     the tile's first run, slot 1 for its last.
//   * Pass 2 (`segment_sum_span`): the tile where a crossing segment starts
//     owns it, finds the segment's last tile by a binary search over the
//     tiles' first keys, and adds the pieces (its own slot, then slot 0 of
//     each later tile) to the table row: piece i into the sum of group
//     i % kGroups, in order from 0; then the groups' sums in group order
//     from 0.
//   * Every table row is written by one thread a column, and every sum runs
//     in an order fixed by the sorted positions alone: no atomics, the same
//     bits on every run. ops/segment.py::segment_sum_plain_ repeats this
//     order in PyTorch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 64;   // sorted positions a warp walks (pass 1)
constexpr int kTileWarps = 8;   // tiles a block of pass 1
constexpr int kBatch = 8;       // rows whose loads are in flight together
constexpr int kMaxCols = 8;     // columns a lane holds: 256 a slab
constexpr int kGroups = 16;     // piece groups of pass 2, 32 columns each
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int kCols>
__global__ void __launch_bounds__(kTileWarps * 32)
    segment_sum_tile(const T* __restrict__ rows,
                     const int64_t* __restrict__ keys,
                     const int64_t* __restrict__ order,
                     float* __restrict__ table, float* __restrict__ part,
                     long long n, int c) {
  const int lane = threadIdx.x & 31;
  const long long tile =
      (long long)blockIdx.x * kTileWarps + (threadIdx.x >> 5);
  const long long p0 = tile * kTileRows;
  if (p0 >= n) return;
  const int len = (int)(n - p0 < kTileRows ? n - p0 : kTileRows);
  const int col0 = blockIdx.y * 32 * kCols + lane;
  // the tile's keys and rows, two positions a lane
  long long key[2], row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = h * 32 + lane;
    key[h] = -1;
    row[h] = -1;
    if (i < len) {
      key[h] = keys[p0 + i];
      row[h] = order[p0 + i];
    }
  }
  const long long first_key = __shfl_sync(kAll, key[0], 0);
  const long long last_key =
      __shfl_sync(kAll, (len - 1) >> 5 ? key[1] : key[0], (len - 1) & 31);
  const bool open_start = p0 > 0 && keys[p0 - 1] == first_key;
  const bool open_end = p0 + len < n && keys[p0 + len] == last_key;

  float acc[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) acc[k] = 0.f;
  long long cur = first_key;
  bool first_run = true;
  auto flush = [&](bool last_run) {
    if ((first_run && open_start) || (last_run && open_end)) {
      float* dst = part + (tile * 2 + (first_run ? 0 : 1)) * (long long)c;
#pragma unroll
      for (int k = 0; k < kCols; ++k)
        if (col0 + 32 * k < c) dst[col0 + 32 * k] = acc[k];
      return;
    }
    float* dst = table + cur * c;
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      if (col0 + 32 * k < c) dst[col0 + 32 * k] += acc[k];
  };

#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int b = 0; b < 32; b += kBatch) {
      if (h * 32 + b >= len) break;  // uniform across the warp
      long long kb[kBatch];
      float v[kBatch][kCols];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        kb[i] = __shfl_sync(kAll, key[h], b + i);
        const long long r = __shfl_sync(kAll, row[h], b + i);
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          const int col = col0 + 32 * k;
          v[i][k] = r >= 0 && col < c ? to_f32(rows[r * c + col]) : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (h * 32 + b + i >= len) break;
        if (kb[i] != cur) {
          flush(false);
          cur = kb[i];
          first_run = false;
#pragma unroll
          for (int k = 0; k < kCols; ++k) acc[k] = 0.f;
        }
#pragma unroll
        for (int k = 0; k < kCols; ++k) acc[k] += v[i][k];
      }
    }
  }
  flush(true);
}

// block (32, kGroups), one a tile; only the owner of a crossing segment works
__global__ void __launch_bounds__(32 * kGroups)
    segment_sum_span(const int64_t* __restrict__ keys,
                     float* __restrict__ table,
                     const float* __restrict__ part, long long n, int c) {
  __shared__ float sums[kGroups][33];
  const long long tiles = (n + kTileRows - 1) / kTileRows;
  const long long tile = blockIdx.x;
  const long long p0 = tile * kTileRows;
  const long long last = (p0 + kTileRows < n ? p0 + kTileRows : n) - 1;
  if (last + 1 >= n) return;
  const long long s = keys[last];
  if (keys[last + 1] != s) return;   // the tile's last run ends in it
  const bool single = keys[p0] == s;  // the tile is one run
  if (single && p0 > 0 && keys[p0 - 1] == s) return;  // owned earlier
  // the segment's last tile: the last whose first key is s
  long long lo = tile + 1, hi = tiles - 1;
  while (lo < hi) {
    const long long mid = (lo + hi + 1) / 2;
    if (keys[mid * kTileRows] == s)
      lo = mid;
    else
      hi = mid - 1;
  }
  const long long pieces = lo - tile + 1;
  const int lane = threadIdx.x, grp = threadIdx.y;
  for (int col0 = 0; col0 < c; col0 += 32) {
    const int col = col0 + lane;
    float acc = 0.f;
    if (col < c) {
#pragma unroll 4
      for (long long i = grp; i < pieces; i += kGroups) {
        const long long slot =
            i == 0 ? tile * 2 + (single ? 0 : 1) : (tile + i) * 2;
        acc += part[slot * c + col];
      }
    }
    sums[grp][lane] = acc;
    __syncthreads();
    if (grp == 0 && col < c) {
      float total = 0.f;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) total += sums[g][lane];
      table[s * c + col] += total;
    }
    __syncthreads();
  }
}

template <typename T, int kCols>
void launch_tiles(const void* rows, const int64_t* keys,
                  const int64_t* order, float* table, float* part,
                  long long n, long long c, cudaStream_t stream) {
  const long long tiles = (n + kTileRows - 1) / kTileRows;
  const dim3 grid((unsigned)((tiles + kTileWarps - 1) / kTileWarps),
                  (unsigned)((c + 32 * kCols - 1) / (32 * kCols)));
  segment_sum_tile<T, kCols><<<grid, kTileWarps * 32, 0, stream>>>(
      (const T*)rows, keys, order, table, part, n, (int)c);
}

template <typename T>
void tiles_for(const void* rows, const int64_t* keys, const int64_t* order,
               float* table, float* part, long long n, long long c,
               cudaStream_t stream) {
  const long long per_lane = (c + 31) / 32;
#define IDT_TILES(K) \
  launch_tiles<T, K>(rows, keys, order, table, part, n, c, stream)
  switch (per_lane < kMaxCols ? per_lane : kMaxCols) {
    case 1: IDT_TILES(1); break;
    case 2: IDT_TILES(2); break;
    case 3: IDT_TILES(3); break;
    case 4: IDT_TILES(4); break;
    case 5: IDT_TILES(5); break;
    case 6: IDT_TILES(6); break;
    case 7: IDT_TILES(7); break;
    default: IDT_TILES(8); break;
  }
#undef IDT_TILES
}

}  // namespace

// rows (n, c) f32 or bf16 (is_bf16); keys (n,) int64, sorted ascending,
// each a row of table (S, c) f32, to which each key's sum is added; order
// (n,) int64: the i-th sorted row is rows[order[i]]; part (ceil(n / 64), 2,
// c) f32 scratch. Two launches when n > 0, none when n == 0. Returns a
// cudaError_t.
extern "C" int idt_segment_sum(const void* rows, const void* keys,
                               const void* order, void* table, void* part,
                               long long n, long long c, long long is_bf16,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n < 0 || c < 1 || c > (1LL << 30)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int64_t* k = (const int64_t*)keys;
  float* tab = (float*)table;
  float* prt = (float*)part;
  if (is_bf16)
    tiles_for<__nv_bfloat16>(rows, k, (const int64_t*)order, tab, prt, n, c,
                             s);
  else
    tiles_for<float>(rows, k, (const int64_t*)order, tab, prt, n, c, s);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n + kTileRows - 1) / kTileRows;
  segment_sum_span<<<(unsigned)tiles, dim3(32, kGroups), 0, s>>>(
      k, tab, prt, n, (int)c);
  return (int)cudaGetLastError();
}
