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
// Route "tiled" (wider rows, row_merge.cuh): the same CTA body sorts each
// tile of kTile entries and writes its pairs out; merge rounds put a row's
// tiles back together in access order, and one thread a segment adds the
// merged row's run from global memory. The wrapper picks the route from
// the padded width.
#include <cuda_runtime.h>

#include "row_merge.cuh"
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

// With kTiled (the tiled route, row_merge.cuh) the CTA takes tile
// blockIdx.x % row_tiles(n) of row blockIdx.x / row_tiles(n), at most kTile
// entries, and writes its sorted pairs to `sorted` at the tile's offset and
// their count to count[blockIdx.x]; otherwise it takes row blockIdx.x whole
// and writes its segments' scores.
template <bool kTiled>
__global__ void __launch_bounds__(kRowThreads)
    popularity_kernel(const int* __restrict__ dist,
                      const unsigned char* __restrict__ served,
                      const int* __restrict__ seg,
                      const float* __restrict__ cs, float* __restrict__ out,
                      unsigned long long* __restrict__ sorted,
                      int* __restrict__ count, int num_blocks, int n) {
  extern __shared__ unsigned long long pairs[];
  __shared__ RowScan<kMaxTiles> scan;
  const int row_parts = kTiled ? row_tiles(n) : 1;
  const long long v = blockIdx.x / row_parts;
  const int col = kTiled ? (int)(blockIdx.x % row_parts) * kTile : 0;
  const int len = kTiled ? min(kTile, n - col) : n;
  const long long row = v * n + col;   // the CTA's first entry
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
  if (kTiled && threadIdx.x == 0) count[blockIdx.x] = m;
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
  if (kTiled) {
    for (int i = threadIdx.x; i < m; i += kRowThreads)
      sorted[row + i] = pairs[i];
    return;
  }
  for (int i = threadIdx.x; i < m; i += kRowThreads) {
    const unsigned s = sorted_key(pairs, i);
    if (i > 0 && sorted_key(pairs, i - 1) == s) continue;
    out[s] = run_sum<false>(pairs, i, run_end(pairs, i, m, s));
  }
}

// The tiled route's run pass: the merged row's kept pairs (base[tiles] of
// them), each segment's score added by the thread of its first pair.
__global__ void __launch_bounds__(kRowThreads)
    popularity_runs_kernel(const unsigned long long* __restrict__ sorted,
                           const int* __restrict__ base,
                           float* __restrict__ out, int n, int tiles) {
  const int chunks = row_chunks(n);
  const long long r = blockIdx.x / chunks;
  const int i = (int)(blockIdx.x % chunks) * kRowThreads + threadIdx.x;
  const int m = base[r * (tiles + 1) + tiles];
  if (i >= m) return;
  const unsigned long long* pr = sorted + r * n;
  const unsigned s = sorted_key(pr, i);
  if (i > 0 && sorted_key(pr, i - 1) == s) return;
  out[s] = run_sum<false>(pr, i, run_end(pr, i, m, s));
}

bool configured = false, configured_tiled = false;

}  // namespace

extern "C" int etica_popularity(const int* dist, const unsigned char* served,
                                const int* seg, const float* cs, float* out,
                                int num_blocks, int num_rows, int n,
                                void* stream) {
  if (num_blocks <= 0 || num_rows <= 0 || n <= 0) return 0;
  if (n > kMaxRow) return (int)cudaErrorInvalidValue;
  const cudaError_t err = row_kernel_setup(popularity_kernel<false>,
                                           configured);
  if (err != cudaSuccess) return (int)err;
  popularity_kernel<false><<<num_rows, kRowThreads, row_smem_bytes(n),
                             (cudaStream_t)stream>>>(
      dist, served, seg, cs, out, nullptr, nullptr, num_blocks, n);
  return (int)cudaGetLastError();
}

// The tiled route (row_merge.cuh), rows of any width. Scratch: sorted_a and
// sorted_b [num_rows, n] pairs, count [num_rows, row_tiles(n)], base
// [num_rows, row_tiles(n) + 1]; out zeroed by the caller.
extern "C" int etica_popularity_tiled(
    const int* dist, const unsigned char* served, const int* seg,
    const float* cs, float* out, unsigned long long* sorted_a,
    unsigned long long* sorted_b, int* count, int* base, int num_blocks,
    int num_rows, int n, void* stream) {
  if (num_blocks <= 0 || num_rows <= 0 || n <= 0) return 0;
  cudaError_t err = row_kernel_setup(popularity_kernel<true>,
                                     configured_tiled);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  const int tiles = row_tiles(n);
  const size_t smem = row_smem_bytes(n < kTile ? n : kTile);
  popularity_kernel<true><<<(unsigned)((long long)num_rows * tiles),
                            kRowThreads, smem, st>>>(
      dist, served, seg, cs, out, sorted_a, count, num_blocks, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = launch_tile_bases(count, base, num_rows, tiles, st)) !=
      cudaSuccess)
    return (int)err;
  const unsigned long long* sorted =
      merge_rows(sorted_a, sorted_b, base, num_rows, n, tiles, st, err);
  if (err != cudaSuccess) return (int)err;
  popularity_runs_kernel<<<(unsigned)((long long)num_rows * row_chunks(n)),
                           kRowThreads, 0, st>>>(sorted, base, out, n,
                                                 tiles);
  return (int)cudaGetLastError();
}
