// row_merge: the tiled route of the row kernels (popularity, run_sums) for
// rows wider than one CTA sorts in shared memory (kMaxRow entries,
// row_sort.cuh). It takes rows of any width.
//
//  1. Tile sort (the kernels' own tile kernels): each CTA takes one tile of
//     at most kTile consecutive entries of a row, drops its padding, sorts
//     the kept (key, value) pairs stably with row_sort, and writes them to
//     a device scratch row at the tile's own offset (t * kTile), with the
//     tile's count of kept pairs.
//  2. Bases (tile_bases_kernel): each row's tile counts become exclusive
//     bases; base[tiles] is the row's count of kept pairs.
//  3. Merge rounds (merge_round_kernel): a round merges runs of
//     `run_tiles` tiles pairwise into runs of twice as many, from one
//     scratch buffer into the other; a run lives at its first tile's offset
//     and holds the kept pairs of its tiles. One thread a position: a pair
//     of the left run moves to its index plus the count of keys of the
//     right run below its key, a pair of the right run to its index plus
//     the count of keys of the left run at or below its own (a binary
//     search in global memory), so equal keys keep tile order, which is
//     access order. ceil(log2(tiles)) rounds; a run without a partner is
//     copied.
//  4. The kernels' own run pass over the merged row (kept pairs at 0 ..
//     base[tiles]): run heads, and each run added left to right by one
//     thread (run_end and run_sum of row_sort.cuh on global memory); a run
//     may span what were tiles.
//
// The launches are few and each is simple; the grid is one-dimensional
// (rows x tiles or rows x position chunks), so no width or tile count is
// refused. Scratch: two [rows, n] pair buffers and the counts, allocated by
// the wrapper.
#pragma once

#include <cuda_runtime.h>

#include "row_sort.cuh"

namespace etica {

constexpr int kTile = kMaxRow;   // entries a tile: one CTA's row sort

__host__ __device__ constexpr int row_tiles(int n) {
  return (n + kTile - 1) / kTile;
}
__host__ __device__ constexpr int row_chunks(int n) {
  return (n + kRowThreads - 1) / kRowThreads;
}

// count[row * tiles + t] -> base[row * (tiles + 1) + t], exclusive, and
// base[row * (tiles + 1) + tiles] the row's total; one thread a row.
static __global__ void tile_bases_kernel(const int* __restrict__ count,
                                         int* __restrict__ base, int rows,
                                         int tiles) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const int* c = count + (long long)row * tiles;
  int* b = base + (long long)row * (tiles + 1);
  int run = 0;
  for (int t = 0; t < tiles; ++t) {
    b[t] = run;
    run += c[t];
  }
  b[tiles] = run;
}

// keys of run[0, len) below `key` (or_equal: at or below it)
__device__ __forceinline__ int count_below(const unsigned long long* run,
                                           int len, unsigned key,
                                           bool or_equal) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const unsigned k = pair_key(run[mid]);
    if (or_equal ? k <= key : k < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// One merge round over [rows, n] scratch rows: runs of run_tiles tiles
// (the run r from tile r * run_tiles, its kept pairs from the bases)
// merged pairwise from src into dst. Grid: rows * row_chunks(n) CTAs of
// kRowThreads, one position a thread.
static __global__ void __launch_bounds__(kRowThreads)
    merge_round_kernel(const unsigned long long* __restrict__ src,
                       unsigned long long* __restrict__ dst,
                       const int* __restrict__ base, int n, int tiles,
                       int run_tiles) {
  const int chunks = row_chunks(n);
  const long long row = blockIdx.x / chunks;
  const long long p = (long long)(blockIdx.x % chunks) * kRowThreads +
                      threadIdx.x;
  if (p >= n) return;
  const long long span = (long long)run_tiles * kTile;
  const int run = (int)(p / span);
  const int e = (int)(p - run * span);
  const int* b = base + row * (tiles + 1);
  const int t0 = run * run_tiles;
  const int len = b[min(t0 + run_tiles, tiles)] - b[t0];
  if (e >= len) return;
  const bool left = (run & 1) == 0;
  const int o0 = (run ^ 1) * run_tiles;   // the partner run's first tile
  const int other_len =
      o0 < tiles ? b[min(o0 + run_tiles, tiles)] - b[o0] : 0;
  const unsigned long long* r = src + row * n;
  const unsigned long long x = r[p];
  const int cnt = count_below(r + o0 * (long long)kTile, other_len,
                              pair_key(x), !left);
  const long long out = (long long)(run & ~1) * span + e + cnt;
  dst[row * n + out] = x;
}

// Runs the merge rounds from buffer a (the tile sort's output); returns the
// buffer that holds the merged rows.
static inline unsigned long long* merge_rows(
    unsigned long long* a, unsigned long long* b, const int* base, int rows,
    int n, int tiles, cudaStream_t stream, cudaError_t& err) {
  err = cudaSuccess;
  const long long blocks = (long long)rows * row_chunks(n);
  for (int run_tiles = 1; run_tiles < tiles; run_tiles <<= 1) {
    merge_round_kernel<<<(unsigned)blocks, kRowThreads, 0, stream>>>(
        a, b, base, n, tiles, run_tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return a;
    unsigned long long* t = a;
    a = b;
    b = t;
  }
  return a;
}

// The bases of the tile counts; the launch's error.
static inline cudaError_t launch_tile_bases(const int* count, int* base,
                                            int rows, int tiles,
                                            cudaStream_t stream) {
  tile_bases_kernel<<<(rows + 255) / 256, 256, 0, stream>>>(count, base,
                                                            rows, tiles);
  return cudaGetLastError();
}

}  // namespace etica
