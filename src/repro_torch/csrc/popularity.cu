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
// Design: a segment lies in one row, and a row fits in shared memory, so
// one CTA takes one row and nothing leaves the chip between the load and
// the scores (row_sort.cuh). The CTA drops the row's padding (segment ids
// at or past num_blocks), computes each kept access's contribution in
// registers, sorts the (segment, contribution) pairs stably by segment in
// shared memory, and gives each segment to the thread that holds its
// first pair: it finds the segment's end by a galloping search and adds
// the contributions with the loads a chunk ahead of the adds. No global
// sort: one launch beside the zero fill of the scores (segments absent
// from every row).
#include <cuda_runtime.h>

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

__global__ void __launch_bounds__(kRowThreads)
    popularity_kernel(const int* __restrict__ dist,
                      const unsigned char* __restrict__ served,
                      const int* __restrict__ seg,
                      const float* __restrict__ cs, float* __restrict__ out,
                      int num_blocks, int n) {
  extern __shared__ unsigned long long pairs[];
  __shared__ RowScan<kMaxTiles> scan;
  const long long row = (long long)blockIdx.x * n;
  const unsigned nb = (unsigned)num_blocks;
  const int tiles = (n + kRowThreads - 1) / kRowThreads;
  unsigned s[kUnroll];
  int d[kUnroll];
  bool sv[kUnroll];
  for (int t0 = 0; t0 < tiles; t0 += kUnroll) {
    load_tiles(dist, served, seg, row, n, nb, t0, s, d, sv);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (t0 + u < tiles) scan.count(t0 + u, s[u] < nb);
  }
  const int m = scan.bases(tiles);
  if (m == 0) return;
  const float c = cs[blockIdx.x];
  for (int t0 = 0; t0 < tiles; t0 += kUnroll) {
    // a row of up to kUnroll tiles is still in registers
    if (tiles > kUnroll)
      load_tiles(dist, served, seg, row, n, nb, t0, s, d, sv);
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
