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
// Design: one CTA per row does the whole compaction in shared memory
// (row_sort.cuh): it loads the valid prefix (padding never leaves device
// memory), sorts the (address, contribution) pairs stably by address,
// flags the first pair of each run, ranks the flags with a block scan
// (the run's output slot), and gives each run to the thread that holds
// its first pair, which finds the run's end by a galloping search and adds
// its values with the loads a chunk ahead of the adds. It writes both
// outputs in full, so the caller needs no fill: one launch where the
// window sort, the gathers and the run chain were about ten.
#include <cuda_runtime.h>

#include "row_sort.cuh"

namespace {

using namespace etica;

constexpr int kTableEmpty = 0x7fffffff;

__global__ void __launch_bounds__(kRowThreads)
    run_sums_kernel(const int* __restrict__ wa, const float* __restrict__ wc,
                    const int* __restrict__ n_valid, int* __restrict__ uaddr,
                    float* __restrict__ uval, int n) {
  extern __shared__ unsigned long long pairs[];
  __shared__ RowScan<kMaxTiles> scan;
  const long long row = (long long)blockIdx.x * n;
  const int m = min(max(n_valid[blockIdx.x], 0), n);
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
