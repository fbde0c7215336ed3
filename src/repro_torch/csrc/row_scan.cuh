// row_scan: the flag scan with which a CTA of kRowThreads threads drops a
// row's padding and packs the kept positions in order. Shared by the row
// sort (row_sort.cuh: popularity, run_sums) and the datapaths' set walk
// (set_walk.cuh: two_level, single_level).
#pragma once

#include <cuda_runtime.h>

namespace etica {

constexpr int kRowThreads = 512;
constexpr int kRowWarps = kRowThreads / 32;

// An exclusive scan of one flag per position over a row cut into tiles of
// kRowThreads positions (position t * kRowThreads + threadIdx.x of tile
// t), in two passes: count() for every tile, bases(), then rank() for
// every tile in the same order. Every thread of the CTA calls each. A
// warp reads and writes only its own slots outside bases(), so the next
// count() may start while other warps still rank.
template <int kTiles>
struct RowScan {
  int base[kTiles * kRowWarps + 1];

  __device__ __forceinline__ void count(int tile, bool flag) {
    const unsigned b = __ballot_sync(0xffffffffu, flag);
    if ((threadIdx.x & 31) == 0)
      base[tile * kRowWarps + (threadIdx.x >> 5)] = __popc(b);
  }

  // turns the counts of `tiles` tiles into exclusive bases; the total
  __device__ int bases(int tiles) {
    __syncthreads();
    const int n = tiles * kRowWarps;
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const int per = (n + 31) / 32;
      const int lo = min(lane * per, n), hi = min(lo + per, n);
      int sum = 0;
      for (int k = lo; k < hi; ++k) sum += base[k];
      int incl = sum;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += y;
      }
      int run = incl - sum;
      for (int k = lo; k < hi; ++k) {
        const int x = base[k];
        base[k] = run;
        run += x;
      }
      if (lane == 31) base[n] = incl;
    }
    __syncthreads();
    return base[n];
  }

  // flagged positions before this thread's position of `tile`
  __device__ __forceinline__ int rank(int tile, bool flag) const {
    const unsigned b = __ballot_sync(0xffffffffu, flag);
    const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
    return base[tile * kRowWarps + (threadIdx.x >> 5)] + __popc(b & below);
  }
};

}  // namespace etica
