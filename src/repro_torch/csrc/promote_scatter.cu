// promote_scatter: drain each VM's promotion queue into free SSD ways.
//
// Replaces the Pallas kernel `_promote_kernel` / `promote_scatter` of
// src/repro/kernels/maintenance/kernel.py, with its `dedupe` flag. Per VM
// v and set s, with the INPUT tags:
//   free ways   = active ways (w < ways[v]) with tag < 0, in way order;
//   eligible    = queue entries a >= 0 with a % S == s, not present in an
//                 active way of the set, and ways[v] > 0, in queue order;
//                 with dedupe, also not the address of an earlier entry
//                 of the VM's queue (the first occurrence wins);
//   the k-th eligible entry goes to the k-th free way (tag a, lru t[v],
//   clean) while k < #free; promoted[v] += min(#eligible, #free).
// The fused maintenance interval passes unique queues with dedupe off;
// the staged and per-state promotions (promote_blocks*), whose queues may
// repeat an address, turn it on.
//
// What bounds it on the H100: the queue scan. Each set must find its own
// entries among the VM's Q queue entries, S x Q tests per VM; the bytes
// (the state read and written once, the queue read once) are a fraction
// of a megabyte at the paper's shapes.
//
// Design: one warp per (VM, set), four warps per block. The warp stages
// the set's W tags and its free-way list in shared memory, then walks the
// queue 32 entries at a time: each lane tests one entry, __ballot_sync
// gives the eligible lanes, and __popc of the lanes below gives each
// entry's rank in queue order. The walk stops once the free ways are used
// up. Every write goes to a distinct way of the warp's own set, so warps
// never conflict; one integer atomicAdd per set adds the VM's count.
// Dedupe needs no pass of its own: two entries with one address fall in
// one set and are both resident or both not, so only the set's accepted
// entries can repeat. The warp keeps the addresses it placed (fewer than
// the set's free ways while the walk goes on) in shared memory and drops
// an entry that repeats one of them, or a lower lane of its own 32
// (__match_any_sync).
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;

__global__ void promote_kernel(int* __restrict__ tags, int* __restrict__ lru,
                               unsigned char* __restrict__ dirty,
                               const int* __restrict__ queue,
                               const int* __restrict__ ways_v,
                               const int* __restrict__ t_v,
                               int* __restrict__ promoted, int num_vms,
                               int num_sets, int num_ways, int q,
                               bool dedupe) {
  extern __shared__ int smem[];  // per warp: W tags, W free ways, W placed
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long gid = (long long)blockIdx.x * kWarps + warp;
  if (gid >= (long long)num_vms * num_sets) return;
  const int v = (int)(gid / num_sets);
  const int s = (int)(gid % num_sets);
  int* set_tags = smem + warp * 3 * num_ways;
  int* free_way = set_tags + num_ways;
  int* placed = free_way + num_ways;  // dedupe: address of each rank so far
  const int ways = min(max(ways_v[v], 0), num_ways);
  const long long row = ((long long)v * num_sets + s) * num_ways;

  // free-way list in way order
  int n_free = 0;
  for (int base = 0; base < num_ways; base += 32) {
    const int w = base + lane;
    const int tag = w < num_ways ? tags[row + w] : -1;
    if (w < num_ways) set_tags[w] = tag;
    const bool is_free = w < ways && tag < 0;
    const unsigned m = __ballot_sync(0xffffffffu, is_free);
    if (is_free) free_way[n_free + __popc(m & ((1u << lane) - 1u))] = w;
    n_free += __popc(m);
  }
  __syncwarp();
  if (n_free == 0) return;

  const int t = t_v[v];
  int taken = 0;
  for (int base = 0; base < q && taken < n_free; base += 32) {
    const int k = base + lane;
    const int a = k < q ? queue[(long long)v * q + k] : -1;
    bool elig = a >= 0 && (a % num_sets) == s;
    if (elig) {
      for (int w = 0; w < ways; ++w) elig &= (set_tags[w] != a);
    }
    if (dedupe) {
      if (elig) {
        for (int r = 0; r < taken; ++r) elig &= (placed[r] != a);
      }
      // lanes holding one address; a lane that is not eligible gets a key
      // of its own (addresses are >= 0)
      const unsigned same =
          __match_any_sync(0xffffffffu, elig ? a : -2 - lane);
      elig &= (same & ((1u << lane) - 1u)) == 0u;
    }
    const unsigned m = __ballot_sync(0xffffffffu, elig);
    if (elig) {
      const int rank = taken + __popc(m & ((1u << lane) - 1u));
      if (rank < n_free) {
        const long long slot = row + free_way[rank];
        tags[slot] = a;
        lru[slot] = t;
        dirty[slot] = 0;
        if (dedupe) placed[rank] = a;
      }
    }
    __syncwarp();
    taken += __popc(m);
  }
  if (lane == 0) atomicAdd(&promoted[v], min(taken, n_free));
}

}  // namespace

extern "C" int etica_promote_scatter(int* tags, int* lru, unsigned char* dirty,
                                     const int* queue, const int* ways,
                                     const int* t, int* promoted,
                                     int num_vms, int num_sets, int num_ways,
                                     int q, int dedupe, void* stream) {
  if (num_vms <= 0 || num_sets <= 0 || num_ways <= 0 || q <= 0) return 0;
  const long long warps = (long long)num_vms * num_sets;
  const int blocks = (int)((warps + kWarps - 1) / kWarps);
  const size_t smem = (size_t)kWarps * 3 * num_ways * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        promote_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  promote_kernel<<<blocks, kWarps * 32, smem, (cudaStream_t)stream>>>(
      tags, lru, dirty, queue, ways, t, promoted, num_vms, num_sets, num_ways,
      q, dedupe != 0);
  return (int)cudaGetLastError();
}
