// run_sums: one maintenance window compacted into (distinct address,
// in-order float32 sum) per row.
//
// Not a port of a TPU kernel: the popularity table's window step of the
// reference's `_row_update`, a stable argsort of the window and then
// `_compact_runs` (src/repro/core/popularity.py:204-219, 236-240). For each
// row v of [V, N] (addresses wa int32, contributions wc float32, the first
// n_valid[v] entries valid): every distinct address of the valid entries
// once, ascending, from slot 0, with its contributions added left to right
// in access order (__fadd_rn; as XLA:CPU does, a subnormal contribution
// adds as zero and each partial sum's subnormals are flushed); the tail
// TABLE_EMPTY with 0, and a run of TABLE_EMPTY itself scores 0. The table
// is compared bit for bit; CUDA's index_add_ and scatter_add_ use atomics
// in no fixed order.
//
// What bounds it on the H100: bytes, 8 read and 8 written per column,
// about 0.06 us for a [12, 1024] window. The kernel sits above it: a
// block's sum is one chain of dependent adds, so the row's most-accessed
// address (L_max accesses) sets the floor, L_max dependent __fadd_rn plus
// the flush.
//
// Design, route "row" (rows of up to kMaxRow entries): one CTA per row
// does the whole compaction in shared memory (row_sort.cuh): it loads the valid prefix (padding never leaves device
// memory), sorts the (address, contribution) pairs stably by address,
// flags the first pair of each run, ranks the flags with a block scan
// (the run's output slot), and gives each run to the thread that holds
// its first pair, which finds the run's end by a galloping search and adds
// its values with the loads a chunk ahead of the adds. It writes both
// outputs in full, so the caller needs no fill: one launch where the
// window sort, the gathers and the run chain were about ten.
//
// Route "tiled" (wider rows, row_merge.cuh): each CTA sorts one tile of
// the valid prefix and writes its pairs out, merge rounds put a row's
// tiles back together in access order, then two passes over the merged
// row: one counts each position chunk's run heads, the next gives each
// head its slot (the counts of the chunks before it, then a block scan)
// and its run's in-order sum, and fills the tail. Every output slot is
// written, so the caller needs no fill. The wrapper picks the route from
// the padded width.
#include <cuda_runtime.h>

#include "row_merge.cuh"
#include "row_sort.cuh"

namespace {

using namespace etica;

constexpr int kTableEmpty = 0x7fffffff;

// With kTiled the CTA takes tile blockIdx.x % row_tiles(n) of row
// blockIdx.x / row_tiles(n) (its part of the valid prefix, at most kTile
// entries) and writes its sorted pairs to `sorted` at the tile's offset
// and their count to count[blockIdx.x]; otherwise it compacts row
// blockIdx.x whole.
template <bool kTiled>
__global__ void __launch_bounds__(kRowThreads)
    run_sums_kernel(const int* __restrict__ wa, const float* __restrict__ wc,
                    const int* __restrict__ n_valid, int* __restrict__ uaddr,
                    float* __restrict__ uval,
                    unsigned long long* __restrict__ sorted,
                    int* __restrict__ count, int n) {
  extern __shared__ unsigned long long pairs[];
  __shared__ RowScan<kMaxTiles> scan;
  const int row_parts = kTiled ? row_tiles(n) : 1;
  const long long v = blockIdx.x / row_parts;
  const int col = kTiled ? (int)(blockIdx.x % row_parts) * kTile : 0;
  const long long row = v * n + col;   // the CTA's first entry
  const int valid = min(max(n_valid[v], 0), n);
  const int m = kTiled ? min(max(valid - col, 0), kTile) : valid;
#pragma unroll 4
  for (int i = threadIdx.x; i < m; i += kRowThreads) {
    // a subnormal contribution adds as zero (XLA:CPU)
    pairs[i] = make_pair(signed_key(wa[row + i]), ftz(wc[row + i]));
  }
  row_sort(pairs, m);
  if (kTiled) {
    for (int i = threadIdx.x; i < m; i += kRowThreads)
      sorted[row + i] = pairs[i];
    if (threadIdx.x == 0) count[blockIdx.x] = m;
    return;
  }
  const int tiles = (m + kRowThreads - 1) / kRowThreads;
  for (int t = 0; t < tiles; ++t) {
    const int i = t * kRowThreads + threadIdx.x;
    scan.count(t, i < m && (i == 0 || sorted_key(pairs, i) !=
                                          sorted_key(pairs, i - 1)));
  }
  const int runs = scan.bases(tiles);
  for (int t = 0; t < tiles; ++t) {
    const int i = t * kRowThreads + threadIdx.x;
    const unsigned key = i < m ? sorted_key(pairs, i) : 0u;
    const bool head = i < m && (i == 0 || key != sorted_key(pairs, i - 1));
    const int r = scan.rank(t, head);
    if (head) {
      const int addr = unsigned_key(key);
      const float sum = run_sum<true>(pairs, i, run_end(pairs, i, m, key));
      uaddr[row + r] = addr;
      uval[row + r] = addr == kTableEmpty ? 0.0f : sum;
    }
  }
  for (int i = runs + threadIdx.x; i < n; i += kRowThreads) {
    uaddr[row + i] = kTableEmpty;
    uval[row + i] = 0.0f;
  }
}

// Is position i of a merged row of m kept pairs the head of a run?
__device__ __forceinline__ bool run_head(const unsigned long long* pr,
                                         int i, int m) {
  return i < m && (i == 0 || sorted_key(pr, i) != sorted_key(pr, i - 1));
}

// The tiled route's first run pass: heads[r * chunks + c] counts the run
// heads among positions c * kRowThreads .. of merged row r.
__global__ void __launch_bounds__(kRowThreads)
    run_heads_kernel(const unsigned long long* __restrict__ sorted,
                     const int* __restrict__ base, int* __restrict__ heads,
                     int n, int tiles) {
  const int chunks = row_chunks(n);
  const long long v = blockIdx.x / chunks;
  const int i = (int)(blockIdx.x % chunks) * kRowThreads + threadIdx.x;
  const int m = base[v * (tiles + 1) + tiles];
  const int k = __syncthreads_count(run_head(sorted + v * n, i, m));
  if (threadIdx.x == 0) heads[blockIdx.x] = k;
}

// The tiled route's second run pass: each head's slot (the heads of the
// chunks before its own, then its rank in the chunk) and its run's sum;
// slots past the row's runs get the tail.
__global__ void __launch_bounds__(kRowThreads)
    run_write_kernel(const unsigned long long* __restrict__ sorted,
                     const int* __restrict__ base,
                     const int* __restrict__ heads, int* __restrict__ uaddr,
                     float* __restrict__ uval, int n, int tiles) {
  __shared__ RowScan<1> scan;
  __shared__ int warp_before[kRowWarps], warp_all[kRowWarps];
  const int chunks = row_chunks(n);
  const long long v = blockIdx.x / chunks;
  const int c = (int)(blockIdx.x % chunks);
  const int i = c * kRowThreads + threadIdx.x;
  const int m = base[v * (tiles + 1) + tiles];
  const int* h = heads + v * chunks;
  int before = 0, all = 0;
  for (int k = threadIdx.x; k < chunks; k += kRowThreads) {
    const int x = h[k];
    all += x;
    if (k < c) before += x;
  }
  before = __reduce_add_sync(0xffffffffu, before);
  all = __reduce_add_sync(0xffffffffu, all);
  if ((threadIdx.x & 31) == 0) {
    warp_before[threadIdx.x >> 5] = before;
    warp_all[threadIdx.x >> 5] = all;
  }
  const unsigned long long* pr = sorted + v * n;
  const bool head = run_head(pr, i, m);
  scan.count(0, head);
  scan.bases(1);   // synchronises: the warp sums are in
  before = all = 0;
#pragma unroll
  for (int w = 0; w < kRowWarps; ++w) {
    before += warp_before[w];
    all += warp_all[w];
  }
  const long long row = v * n;
  const int r = before + scan.rank(0, head);   // every lane ballots
  if (head) {
    const unsigned key = sorted_key(pr, i);
    const int addr = unsigned_key(key);
    const float sum = run_sum<true>(pr, i, run_end(pr, i, m, key));
    uaddr[row + r] = addr;
    uval[row + r] = addr == kTableEmpty ? 0.0f : sum;
  }
  if (i >= all && i < n) {
    uaddr[row + i] = kTableEmpty;
    uval[row + i] = 0.0f;
  }
}

bool configured = false, configured_tiled = false;

}  // namespace

extern "C" int etica_run_sums(const int* wa, const float* wc,
                              const int* n_valid, int* uaddr, float* uval,
                              int num_rows, int n, void* stream) {
  if (num_rows <= 0 || n <= 0) return 0;
  if (n > kMaxRow) return (int)cudaErrorInvalidValue;
  const cudaError_t err = row_kernel_setup(run_sums_kernel<false>,
                                           configured);
  if (err != cudaSuccess) return (int)err;
  run_sums_kernel<false><<<num_rows, kRowThreads, row_smem_bytes(n),
                           (cudaStream_t)stream>>>(
      wa, wc, n_valid, uaddr, uval, nullptr, nullptr, n);
  return (int)cudaGetLastError();
}

// The tiled route (row_merge.cuh), rows of any width. Scratch: sorted_a and
// sorted_b [num_rows, n] pairs, count [num_rows, row_tiles(n)], base
// [num_rows, row_tiles(n) + 1], heads [num_rows, row_chunks(n)].
extern "C" int etica_run_sums_tiled(const int* wa, const float* wc,
                                    const int* n_valid, int* uaddr,
                                    float* uval, unsigned long long* sorted_a,
                                    unsigned long long* sorted_b, int* count,
                                    int* base, int* heads, int num_rows,
                                    int n, void* stream) {
  if (num_rows <= 0 || n <= 0) return 0;
  cudaError_t err = row_kernel_setup(run_sums_kernel<true>,
                                     configured_tiled);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  const int tiles = row_tiles(n);
  const size_t smem = row_smem_bytes(n < kTile ? n : kTile);
  run_sums_kernel<true><<<(unsigned)((long long)num_rows * tiles),
                          kRowThreads, smem, st>>>(
      wa, wc, n_valid, uaddr, uval, sorted_a, count, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = launch_tile_bases(count, base, num_rows, tiles, st)) !=
      cudaSuccess)
    return (int)err;
  const unsigned long long* sorted =
      merge_rows(sorted_a, sorted_b, base, num_rows, n, tiles, st, err);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((long long)num_rows * row_chunks(n));
  run_heads_kernel<<<blocks, kRowThreads, 0, st>>>(sorted, base, heads, n,
                                                   tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  run_write_kernel<<<blocks, kRowThreads, 0, st>>>(sorted, base, heads,
                                                   uaddr, uval, n, tiles);
  return (int)cudaGetLastError();
}
