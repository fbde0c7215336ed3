// count_between: the distinct-block count under every reuse distance.
//
// Replaces the Pallas kernel `_kernel` / `count_between` of
// src/repro/kernels/reuse_distance/kernel.py (vmapped over VMs in
// reuse_distance/ops.py), and the jnp twin `_count_between` of
// src/repro/core/reuse.py that the JAX controller runs:
//
//   count[v, i] = #{ j : prev[v, i] < j < i, touch[v, j], nt[v, j] >= i }
//
// What bounds it on the H100: the pair loop. The work is one test per
// (i, j) pair inside each reuse window, sum_i (i - prev[i] - 1), which for
// the POD sizing rows ([V, 1024] at the paper's 12-VM deployment) is far
// more than the 13 bytes per element the kernel must move. So it is bound
// by integer issue rate, not by memory; in practice, at the sequential
// modes' one-VM rows ([1, 1024]), by the longest chain of dependent steps
// and by how many SMs have work. The Pallas original evaluates whole
// 256 x 512 masked tiles on the TPU's vector unit.
//
// Design: each CTA takes `rows` consecutive rows i of one VM, and each row
// a group of `lanes` lanes (8, 16 or 32; see step 3); a group
// takes the CTA's rows g, g + groups, ... The wrapper plans lanes, rows
// and threads from V, N and the SM count alone (ops.count_plan), so that
// a lone VM's row still spreads over every SM and many VMs' rows do not
// oversubscribe it.
//  1. Window. A thread a row reads prev; row i's window is
//     [max(prev + 1, 0), i), its start kept in shared memory with the
//     row's count. The CTA's columns are the union of its rows' windows,
//     [lo, i_last), with lo a shared-memory minimum.
//  2. Stage. The CTA streams those columns through a kTile-key tile in
//     shared memory (every load of a step in flight, the tile's first
//     column a multiple of kVec), making one key a column:
//     key[j] = touch[j] ? nt[j] : -1. The pair test `touch[j] &&
//     nt[j] >= i` is then `key[j] >= i` (i >= 0, so -1 never counts).
//  3. Count. The group's lanes stride over the tile's kVec-column blocks
//     that meet the row's window, lane l taking blocks l, l + lanes, ...:
//     one 16-byte shared-memory load, then kVec compares, each masked to
//     the window. A lone row of 1,024 columns takes at most 8 rounds of a
//     warp, not 1,023 dependent steps of one thread. The lanes' counts
//     add up by shuffles within the group, and the group's first lane
//     adds the tile's count to the row's; windows of any length stream
//     through the tile, so no row length is refused. Nothing a row keeps
//     lives in registers across rows, so a thread needs few and an SM
//     holds eight CTAs of 256 threads. That sum is each row's fixed cost,
//     so where the rows alone fill the card the plan gives a row fewer
//     lanes (8 at the 12-VM and 1024-VM POD rows).
//  4. Write. A thread a row writes count[v, i]. Counts are int32 sums of
//     0/1, exact in any order.
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;   // threads a CTA, at most
constexpr int kMaxRows = 256;   // rows a CTA, at most
constexpr int kVec = 4;         // columns a lane reads at once (one int4)
constexpr int kTile = 4096;     // keys a shared-memory tile (16 KB)
constexpr int kStageUnroll = 4; // columns a thread loads at once

__global__ void __launch_bounds__(kThreads) count_between_kernel(
    const int* __restrict__ prev, const unsigned char* __restrict__ touch,
    const int* __restrict__ nt, int* __restrict__ out, int n, int lanes,
    int rows, int ctas_per_vm) {
  __shared__ int4 key4[kTile / kVec];
  __shared__ int row_start[kMaxRows], row_count[kMaxRows];
  __shared__ int lo_min;
  int* key = reinterpret_cast<int*>(key4);
  const int nthreads = blockDim.x;
  const long long row = (long long)(blockIdx.x / ctas_per_vm) * n;
  const int i0 = (blockIdx.x % ctas_per_vm) * rows;
  const int i_end = min(i0 + rows, n);  // the CTA's rows: [i0, i_end)
  const int groups = nthreads / lanes;
  const int rpg = rows / groups;        // rows a group
  const int group = threadIdx.x / lanes, lane = threadIdx.x % lanes;

  // 1. each row's window start (start == i: an empty window)
  if (threadIdx.x == 0) lo_min = INT_MAX;
  int lo = INT_MAX;
  if (threadIdx.x < rows) {  // rows <= threads
    const int i = i0 + threadIdx.x;
    int s = i;
    if (i < i_end) {
      const int p = __ldg(prev + row + i);
      s = p < 0 ? 0 : (p < i ? p + 1 : i);
      if (s < i) lo = s;
    }
    row_start[threadIdx.x] = s;
    row_count[threadIdx.x] = 0;
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  __syncthreads();  // lo_min's initial value is visible
  if ((threadIdx.x & 31) == 0 && lo != INT_MAX) atomicMin(&lo_min, lo);
  __syncthreads();
  lo = lo_min;
  const int hi = i_end - 1;  // the last row's window ends before it

  for (int t_lo = lo / kVec * kVec; t_lo < hi; t_lo += kTile) {
    // 2. stage the tile's keys
    const int len = min(kTile, hi - t_lo);
    const long long base = row + t_lo;
    for (int k0 = 0; k0 < len; k0 += kStageUnroll * nthreads) {
      unsigned char tc[kStageUnroll];
      int nv[kStageUnroll];
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int k = k0 + u * nthreads + threadIdx.x;
        if (k < len) {
          tc[u] = __ldg(touch + base + k);
          nv[u] = __ldg(nt + base + k);
        }
      }
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int k = k0 + u * nthreads + threadIdx.x;
        if (k < len) key[k] = tc[u] ? nv[u] : -1;
      }
    }
    __syncthreads();

    // 3. each group's rows: the lanes' blocks of the window in the tile
    const int t_hi = t_lo + len;
#pragma unroll 1
    for (int rr = 0; rr < rpg; ++rr) {  // the same count in every group
      const int r = group + rr * groups;
      const int i = i0 + r;
      const int j0 = max(row_start[r], t_lo) - t_lo;
      const int j1 = min(i, t_hi) - t_lo;  // columns [j0, j1) of the tile
      int x = 0;
      for (int b = j0 / kVec + lane; b * kVec < j1; b += lanes) {
        const int4 k = key4[b];
        const int j = b * kVec;
        x += (j >= j0 && j < j1 && k.x >= i) +
             (j + 1 >= j0 && j + 1 < j1 && k.y >= i) +
             (j + 2 >= j0 && j + 2 < j1 && k.z >= i) +
             (j + 3 >= j0 && j + 3 < j1 && k.w >= i);
      }
      for (int o = lanes >> 1; o > 0; o >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, o);
      if (lane == 0) row_count[r] += x;
    }
    __syncthreads();  // the tile is restaged; the counts are complete
  }

  // 4. the rows' counts
  if (threadIdx.x < rows && i0 + (int)threadIdx.x < i_end)
    out[row + i0 + threadIdx.x] = row_count[threadIdx.x];
}

}  // namespace

// lanes (8, 16 or 32) a row, `rows` rows a CTA of `threads` threads: the
// plan of ops.count_plan. threads is a multiple of 32 and of lanes, at most
// kThreads; rows a multiple of threads / lanes, at most threads and
// kMaxRows.
extern "C" int etica_count_between(const int* prev, const unsigned char* touch,
                                   const int* nt, int* out, int num_vms, int n,
                                   int lanes, int rows, int threads,
                                   void* stream) {
  if (num_vms <= 0 || n <= 0) return 0;
  if ((lanes != 8 && lanes != 16 && lanes != 32) || threads < 32 ||
      threads > kThreads || threads % 32 || rows < 1 || rows > kMaxRows ||
      rows > threads || rows % (threads / lanes))
    return (int)cudaErrorInvalidValue;
  const int ctas_per_vm = (n + rows - 1) / rows;
  const long long ctas = (long long)num_vms * ctas_per_vm;
  if (ctas > INT_MAX) return (int)cudaErrorInvalidValue;
  count_between_kernel<<<(unsigned)ctas, threads, 0, (cudaStream_t)stream>>>(
      prev, touch, nt, out, n, lanes, rows, ctas_per_vm);
  return (int)cudaGetLastError();
}
