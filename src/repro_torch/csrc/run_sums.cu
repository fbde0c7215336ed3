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
// Route "tiled" (wider rows, row_radix.cuh): a stable LSD radix sort of
// the valid prefix across the whole card (tiles of 512 positions, 8-bit
// digits, four passes of which those whose digit is constant over a
// row's keys do nothing), then one run pass: each head's slot from a
// decoupled look-back over the heads of the tiles before it, and its
// run's in-order sum, by the head's own thread (runs of up to 32) or by a
// warp that stages the run in shared memory for one lane's adds. The
// prep kernel fills both outputs with the tail first, so every slot is
// written. The wrapper picks the route from the padded width.
#include <cuda_runtime.h>

#include "row_radix.cuh"
#include "row_sort.cuh"

namespace {

using namespace etica;

constexpr int kTableEmpty = 0x7fffffff;

// One CTA compacts row blockIdx.x whole.
__global__ void __launch_bounds__(kRowThreads)
    run_sums_kernel(const int* __restrict__ wa, const float* __restrict__ wc,
                    const int* __restrict__ n_valid, int* __restrict__ uaddr,
                    float* __restrict__ uval, int n) {
  extern __shared__ unsigned long long pairs[];
  __shared__ RowScan<kMaxTiles> scan;
  const long long v = blockIdx.x;
  const long long row = v * n;         // the CTA's first entry
  const int m = min(max(n_valid[v], 0), n);
#pragma unroll 4
  for (int i = threadIdx.x; i < m; i += kRowThreads) {
    // a subnormal contribution adds as zero (XLA:CPU)
    pairs[i] = make_pair(signed_key(wa[row + i]), ftz(wc[row + i]));
  }
  row_sort(pairs, m);
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

// The tiled route's prep: the tile's valid pairs (key: the signed
// address as unsigned, value: the contribution, a subnormal as zero) to
// buffer 0 at their positions, their digits counted into the row's
// histograms, both outputs filled with the tail over the whole tile, and
// the row's length. Grid: rows * radix_tiles(n) CTAs of kRadixThreads.
__global__ void __launch_bounds__(kRadixThreads)
    run_sums_prep_kernel(const int* __restrict__ wa,
                         const float* __restrict__ wc,
                         const int* __restrict__ n_valid,
                         int* __restrict__ uaddr, float* __restrict__ uval,
                         unsigned long long* __restrict__ buf0, int* words,
                         int rows, int n) {
  __shared__ int count[kMaxPasses][kRadix];
  const RadixWords w = radix_layout(words, rows, n, kMaxPasses);
  const int tiles = radix_tiles(n);
  const int row = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int m = min(max(n_valid[row], 0), n);
  if (tile == 0 && threadIdx.x == 0) w.len[row] = w.kept[row] = m;
#pragma unroll
  for (int q = 0; q < kMaxPasses; ++q) count[q][threadIdx.x] = 0;
  __syncthreads();
  const long long r0 = (long long)row * n;
#pragma unroll
  for (int k = 0; k < kRadixItems; ++k) {
    const int i = tile * kTile + k * kRadixThreads + threadIdx.x;
    if (i < n) {
      uaddr[r0 + i] = kTableEmpty;
      uval[r0 + i] = 0.0f;
    }
    const bool in = i < m;
    unsigned key = 0;
    if (in) {
      key = signed_key(wa[r0 + i]);
      buf0[r0 + i] = make_pair(key, ftz(wc[r0 + i]));
    }
#pragma unroll
    for (int q = 0; q < kMaxPasses; ++q)
      count_digit(count[q], digit_of(key, q), in);
  }
  __syncthreads();
  int* hist = w.hist + (long long)row * kMaxPasses * kRadix;
#pragma unroll
  for (int q = 0; q < kMaxPasses; ++q)
    if (count[q][threadIdx.x])
      atomicAdd(&hist[q * kRadix + threadIdx.x], count[q][threadIdx.x]);
}

// The tiled route's run pass over the sorted valid prefix: heads, their
// slots (the heads before the tile by look-back, then the rank in the
// tile) and their runs' in-order sums. Grid: rows * radix_tiles(n) CTAs
// of kRadixThreads, in ticket order.
__global__ void __launch_bounds__(kRadixThreads)
    run_sums_runs_kernel(const unsigned long long* __restrict__ buf0,
                         const unsigned long long* __restrict__ buf1,
                         int* words, int* __restrict__ uaddr,
                         float* __restrict__ uval, int rows, int n) {
  __shared__ RunQueue queue;
  __shared__ unsigned warp_sums[kRadixWarps];
  const RadixWords w = radix_layout(words, rows, n, kMaxPasses);
  const int tiles = radix_tiles(n);
  int row, tile;
  take_ticket(w.ticket + kMaxPasses, tiles, row, tile);
  const int m = w.len[row];
  const unsigned long long* pr = sorted_row(buf0, buf1, w, row, n,
                                            kMaxPasses);
  if (tile * kTile >= m) return;
  if (threadIdx.x == 0) queue.count = 0;
  bool head[kRadixItems];
  unsigned key[kRadixItems];
#pragma unroll
  for (int k = 0; k < kRadixItems; ++k) {
    const int i = tile * kTile + k * kRadixThreads + threadIdx.x;
    key[k] = i < m ? pair_key(pr[i]) : 0u;
    head[k] = i < m && (i == 0 || pair_key(pr[i - 1]) != key[k]);
  }
  int rank[kRadixItems], heads;
  rank_flags(head, rank, warp_sums, heads);
  const int before = run_look_back(
      w.run_status + (long long)row * tiles, tile, heads);
  const long long r0 = (long long)row * n;
#pragma unroll
  for (int k = 0; k < kRadixItems; ++k) {
    if (!head[k]) continue;
    const int i = tile * kTile + k * kRadixThreads + threadIdx.x;
    const int slot = before + rank[k];
    if (i + kLongRun < m && pair_key(pr[i + kLongRun]) == key[k]) {
      const int q = atomicAdd(&queue.count, 1);
      queue.head[q] = i;
      queue.slot[q] = slot;
      continue;
    }
    const int addr = unsigned_key(key[k]);
    const float sum =
        short_run_sum<true>(pr, i, min(i + kLongRun, m), key[k]);
    uaddr[r0 + slot] = addr;
    uval[r0 + slot] = addr == kTableEmpty ? 0.0f : sum;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  for (int q = warp; q < queue.count; q += kRadixWarps) {
    const int i = queue.head[q];
    const unsigned k = pair_key(pr[i]);
    const float sum = warp_run_sum<true>(pr, i, m, k, queue.ring[warp]);
    if ((threadIdx.x & 31) == 0) {
      const int addr = unsigned_key(k);
      uaddr[r0 + queue.slot[q]] = addr;
      uval[r0 + queue.slot[q]] = addr == kTableEmpty ? 0.0f : sum;
    }
  }
}

bool configured = false;

}  // namespace

extern "C" int etica_run_sums(const int* wa, const float* wc,
                              const int* n_valid, int* uaddr, float* uval,
                              int num_rows, int n, void* stream) {
  if (num_rows <= 0 || n <= 0) return 0;
  if (n > kMaxRow) return (int)cudaErrorInvalidValue;
  const cudaError_t err = row_kernel_setup(run_sums_kernel, configured);
  if (err != cudaSuccess) return (int)err;
  run_sums_kernel<<<num_rows, kRowThreads, row_smem_bytes(n),
                    (cudaStream_t)stream>>>(wa, wc, n_valid, uaddr, uval, n);
  return (int)cudaGetLastError();
}

// The tiled route (row_radix.cuh), rows of any width: a memset, the prep,
// kMaxPasses passes, the run pass. Scratch: buf0 and buf1 [num_rows, n]
// pairs, `words` radix_words(num_rows, n, kMaxPasses) int32.
extern "C" int etica_run_sums_tiled(const int* wa, const float* wc,
                                    const int* n_valid, int* uaddr,
                                    float* uval, unsigned long long* buf0,
                                    unsigned long long* buf1, int* words,
                                    int num_rows, int n, void* stream) {
  if (num_rows <= 0 || n <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned grid = (unsigned)((long long)num_rows * radix_tiles(n));
  cudaError_t err = radix_sort_rows(
      buf0, buf1, words, num_rows, n, kMaxPasses, st, [&] {
        run_sums_prep_kernel<<<grid, kRadixThreads, 0, st>>>(
            wa, wc, n_valid, uaddr, uval, buf0, words, num_rows, n);
        return cudaGetLastError();
      });
  if (err != cudaSuccess) return (int)err;
  run_sums_runs_kernel<<<grid, kRadixThreads, 0, st>>>(buf0, buf1, words,
                                                       uaddr, uval,
                                                       num_rows, n);
  return (int)cudaGetLastError();
}
