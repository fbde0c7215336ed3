// popularity: per-block Eq. 1 scores, the contribution fused into an
// in-order segment sum.
//
// Replaces the Pallas kernel `_kernel` / `popularity` of
// src/repro/kernels/popularity/kernel.py:26. For accesses i of [V, N] rows
// (dist int32, served bool) grouped into segments (one per (VM, block)):
//   out[b] = sum over the accesses of segment b, in access order, of
//            exp(-dist[i] / max(cs[v], 1)) * [served[i] and dist[i] >= 0]
// with v = i / N the access's row. That is block_scores(addr,
// contributions(dist, served, cs)) of repro_torch.core.popularity, bit for
// bit: the exp is XLA:CPU's (xla_exp.cuh) and each segment adds its
// contributions left to right with __fadd_rn, as np.add.at does. The
// Pallas kernel's one-hot reduction sums in another order, so it agrees
// only within allclose.
//
// What bounds it on the H100: bytes, about 9 read per access (dist,
// served, the segment id) and 4 written per block; the exp is some 30
// scalar operations an access. At the staged path's shape (12 VMs x 1,024
// accesses) that is a fraction of a microsecond. The kernel sits above
// it: the sum of a block is one chain of dependent adds in access order,
// so the block with the most accesses in a row (L_max) sets the floor,
// L_max dependent __fadd_rn.
//
// Design, route "row" (rows of up to kMaxRow entries): a segment lies in
// one row, and such a row fits in shared memory, so one CTA takes one row
// and nothing leaves the chip between the load and the scores
// (row_sort.cuh). The CTA drops the row's padding (segment ids
// at or past num_blocks), computes each kept access's contribution in
// registers, sorts the (segment, contribution) pairs stably by segment in
// shared memory, and gives each segment to the thread that holds its
// first pair: it finds the segment's end by a galloping search and adds
// the contributions with the loads a chunk ahead of the adds. No global
// sort: one launch beside the zero fill of the scores (segments absent
// from every row).
//
// Route "tiled" (wider rows, row_radix.cuh): a prep kernel forms each
// access's (segment, contribution) pair, padding as the key num_blocks
// (after every segment), and counts the row's digits; a stable LSD radix
// sort of each row across the whole card (tiles of 512 positions, 8-bit
// digits, as many passes as num_blocks needs, those whose digit is
// constant over a row's keys doing nothing); then each segment's score is
// added by the thread of its first pair (segments of up to 32) or by a
// warp that stages the segment in shared memory for one lane's adds. The
// wrapper picks the route from the padded width.
#include <cuda_runtime.h>

#include "row_radix.cuh"
#include "row_sort.cuh"

namespace {

using namespace etica;

constexpr int kUnroll = 4;   // tiles whose loads are in flight together

// segment ids, distances and served flags of tiles t0 .. t0 + kUnroll
__device__ __forceinline__ void load_tiles(
    const int* __restrict__ dist, const unsigned char* __restrict__ served,
    const int* __restrict__ seg, long long row, int n, unsigned nb, int t0,
    unsigned (&s)[kUnroll], int (&d)[kUnroll], bool (&sv)[kUnroll]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = (t0 + u) * kRowThreads + threadIdx.x;
    const bool in = i < n;
    s[u] = in ? (unsigned)seg[row + i] : nb;
    d[u] = in ? dist[row + i] : -1;
    sv[u] = in && served[row + i] != 0;
  }
}

// One CTA takes row blockIdx.x whole and writes its segments' scores.
__global__ void __launch_bounds__(kRowThreads)
    popularity_kernel(const int* __restrict__ dist,
                      const unsigned char* __restrict__ served,
                      const int* __restrict__ seg,
                      const float* __restrict__ cs, float* __restrict__ out,
                      int num_blocks, int n) {
  extern __shared__ unsigned long long pairs[];
  __shared__ RowScan<kMaxTiles> scan;
  const long long v = blockIdx.x;
  const int len = n;
  const long long row = v * n;         // the CTA's first entry
  const unsigned nb = (unsigned)num_blocks;
  const int tiles = (len + kRowThreads - 1) / kRowThreads;
  unsigned s[kUnroll];
  int d[kUnroll];
  bool sv[kUnroll];
  for (int t0 = 0; t0 < tiles; t0 += kUnroll) {
    load_tiles(dist, served, seg, row, len, nb, t0, s, d, sv);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (t0 + u < tiles) scan.count(t0 + u, s[u] < nb);
  }
  const int m = scan.bases(tiles);
  if (m == 0) return;
  const float c = cs[v];
  for (int t0 = 0; t0 < tiles; t0 += kUnroll) {
    // a row of up to kUnroll tiles is still in registers
    if (tiles > kUnroll)
      load_tiles(dist, served, seg, row, len, nb, t0, s, d, sv);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u >= tiles) break;
      const int r = scan.rank(t0 + u, s[u] < nb);
      if (s[u] < nb)
        pairs[r] = make_pair(s[u], eq1_contribution(d[u], sv[u], c));
    }
  }
  row_sort(pairs, m);
  for (int i = threadIdx.x; i < m; i += kRowThreads) {
    const unsigned s = sorted_key(pairs, i);
    if (i > 0 && sorted_key(pairs, i - 1) == s) continue;
    out[s] = run_sum<false>(pairs, i, run_end(pairs, i, m, s));
  }
}

// The tiled route's prep: each access's pair (key: its segment id, or
// num_blocks for padding; value: its Eq. 1 contribution) to buffer 0 at
// its position, the digits of `passes` passes counted into the row's
// histograms, the row's length (n) and kept count (its non-padding
// accesses). Grid: rows * radix_tiles(n) CTAs of kRadixThreads.
__global__ void __launch_bounds__(kRadixThreads)
    popularity_prep_kernel(const int* __restrict__ dist,
                           const unsigned char* __restrict__ served,
                           const int* __restrict__ seg,
                           const float* __restrict__ cs,
                           unsigned long long* __restrict__ buf0, int* words,
                           int num_blocks, int rows, int n, int passes) {
  __shared__ int count[kMaxPasses][kRadix];
  const RadixWords w = radix_layout(words, rows, n, passes);
  const int tiles = radix_tiles(n);
  const int row = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  if (tile == 0 && threadIdx.x == 0) w.len[row] = n;
#pragma unroll
  for (int q = 0; q < kMaxPasses; ++q) count[q][threadIdx.x] = 0;
  __syncthreads();
  const long long r0 = (long long)row * n;
  const unsigned nb = (unsigned)num_blocks;
  const float c = cs[row];
  const int lane = threadIdx.x & 31;
  int kept = 0;
#pragma unroll
  for (int k = 0; k < kRadixItems; ++k) {
    const int i = tile * kTile + k * kRadixThreads + threadIdx.x;
    const bool in = i < n;
    unsigned key = nb;
    if (in) {
      const unsigned s = (unsigned)seg[r0 + i];
      const bool keep = s < nb;
      key = keep ? s : nb;
      kept += keep;
      buf0[r0 + i] = make_pair(
          key, keep ? eq1_contribution(dist[r0 + i], served[r0 + i] != 0, c)
                    : 0.0f);
    }
    for (int q = 0; q < passes; ++q)
      count_digit(count[q], digit_of(key, q), in);
  }
  kept = __reduce_add_sync(0xffffffffu, kept);
  if (lane == 0 && kept) atomicAdd(&w.kept[row], kept);
  __syncthreads();
  int* hist = w.hist + (long long)row * kMaxPasses * kRadix;
  for (int q = 0; q < passes; ++q)
    if (count[q][threadIdx.x])
      atomicAdd(&hist[q * kRadix + threadIdx.x], count[q][threadIdx.x]);
}

// The tiled route's run pass over each sorted row's kept pairs (the
// padding sorts after them): each segment's score, added by the thread of
// its first pair or by a warp. Grid: rows * radix_tiles(n) CTAs of
// kRadixThreads.
__global__ void __launch_bounds__(kRadixThreads)
    popularity_runs_kernel(const unsigned long long* __restrict__ buf0,
                           const unsigned long long* __restrict__ buf1,
                           int* words, float* __restrict__ out, int rows,
                           int n, int passes) {
  __shared__ RunQueue queue;
  const RadixWords w = radix_layout(words, rows, n, passes);
  const int tiles = radix_tiles(n);
  const int row = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int m = w.kept[row];
  const unsigned long long* pr = sorted_row(buf0, buf1, w, row, n, passes);
  if (tile * kTile >= m) return;
  if (threadIdx.x == 0) queue.count = 0;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kRadixItems; ++k) {
    const int i = tile * kTile + k * kRadixThreads + threadIdx.x;
    if (i >= m) continue;
    const unsigned s = pair_key(pr[i]);
    if (i > 0 && pair_key(pr[i - 1]) == s) continue;
    if (i + kLongRun < m && pair_key(pr[i + kLongRun]) == s) {
      queue.head[atomicAdd(&queue.count, 1)] = i;
      continue;
    }
    out[s] = short_run_sum<false>(pr, i, min(i + kLongRun, m), s);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  for (int q = warp; q < queue.count; q += kRadixWarps) {
    const int i = queue.head[q];
    const unsigned s = pair_key(pr[i]);
    const float sum = warp_run_sum<false>(pr, i, m, s, queue.ring[warp]);
    if ((threadIdx.x & 31) == 0) out[s] = sum;
  }
}

bool configured = false;

}  // namespace

extern "C" int etica_popularity(const int* dist, const unsigned char* served,
                                const int* seg, const float* cs, float* out,
                                int num_blocks, int num_rows, int n,
                                void* stream) {
  if (num_blocks <= 0 || num_rows <= 0 || n <= 0) return 0;
  if (n > kMaxRow) return (int)cudaErrorInvalidValue;
  const cudaError_t err = row_kernel_setup(popularity_kernel, configured);
  if (err != cudaSuccess) return (int)err;
  popularity_kernel<<<num_rows, kRowThreads, row_smem_bytes(n),
                      (cudaStream_t)stream>>>(dist, served, seg, cs, out,
                                              num_blocks, n);
  return (int)cudaGetLastError();
}

// The passes of segment ids below num_blocks with num_blocks itself as
// padding: digits of the bits num_blocks needs.
static int popularity_passes(int num_blocks) {
  int bits = 0;
  while (bits < 31 && (num_blocks >> bits) != 0) ++bits;
  return radix_passes(bits);
}

// The tiled route (row_radix.cuh), rows of any width: a memset, the prep,
// popularity_passes(num_blocks) passes, the run pass. Scratch: buf0 and
// buf1 [num_rows, n] pairs, `words` radix_words(num_rows, n, passes)
// int32; out zeroed by the caller.
extern "C" int etica_popularity_tiled(
    const int* dist, const unsigned char* served, const int* seg,
    const float* cs, float* out, unsigned long long* buf0,
    unsigned long long* buf1, int* words, int num_blocks, int num_rows,
    int n, void* stream) {
  if (num_blocks <= 0 || num_rows <= 0 || n <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int passes = popularity_passes(num_blocks);
  const unsigned grid = (unsigned)((long long)num_rows * radix_tiles(n));
  cudaError_t err = radix_sort_rows(
      buf0, buf1, words, num_rows, n, passes, st, [&] {
        popularity_prep_kernel<<<grid, kRadixThreads, 0, st>>>(
            dist, served, seg, cs, buf0, words, num_blocks, num_rows, n,
            passes);
        return cudaGetLastError();
      });
  if (err != cudaSuccess) return (int)err;
  popularity_runs_kernel<<<grid, kRadixThreads, 0, st>>>(buf0, buf1, words,
                                                         out, num_rows, n,
                                                         passes);
  return (int)cudaGetLastError();
}
