// evict_scatter: clear every cache slot whose block is in the VM's queue.
//
// Replaces the Pallas kernel `_evict_kernel` / `evict_scatter` of
// src/repro/kernels/maintenance/kernel.py. Per VM v and slot (s, w):
// if tags[v, s, w] >= 0 and it occurs in queue[v, :] (-1 = padding), the
// slot is cleared (tag -1, lru -1, clean); flushed[v] counts the cleared
// slots that were dirty. A tag is looked up wherever it lies: nothing
// assumes that a block sits in set `tag % S`. The Pallas original is a
// dense [TS, W, QC] compare in strips, the TPU's VMEM shaping.
//
// What bounds it on the H100: the state's bytes (read once, written once)
// and the queue's, about 0.6 MB at 12 VMs x 64 x 64 with a 4,096-entry
// queue, a bound of well under a microsecond; in practice the latency of
// a few dependent steps. The fused maintenance interval truncates the
// eviction queue to next_pow2(S*W) entries of which only the bottom 5% of
// residents are live, so a direct compare of every slot with every entry
// would mostly test padding.
//
// Design: one thread-block cluster a VM, `parts` CTAs (the wrapper picks
// parts and threads from shapes, ops.evict_plan: several CTAs a VM while
// the VMs leave SMs idle, smaller CTAs when the VMs alone fill the card),
// each CTA a contiguous range of the VM's slots, in chunks of kSlots
// slots a thread:
//  1. Load. The chunk's tag, lru and dirty go to registers; in the same
//     step the CTA loads a tile of the VM's queue (up to kTile entries,
//     kLoadUnroll a thread at once, all in flight).
//  2. Compact. Each warp ballots its entries >= 0 and appends them to a
//     shared-memory list (one shared atomic a warp and round gives the
//     base): -1 padding, and any other negative entry, is dropped. A
//     set's order does not matter, so the list keeps none.
//  3. Hash. The list goes into an open-addressing set in shared memory,
//     a power-of-two capacity at least twice the tile's live entries
//     (multiplicative hash, linear probing, atomicCAS inserts; a repeated
//     entry finds itself and stops).
//  4. Probe. Each slot whose tag is >= 0 probes for its tag, and carries
//     its match bit in a register across tiles. A queue longer than one
//     tile goes through the set tile by tile; a queue of one tile is
//     hashed once per CTA whatever the number of chunks.
//  5. Write and count. The CTA writes its slots of the output state, with
//     the matches cleared, so the wrapper clones nothing; the warps' dirty
//     matches add up in shared memory, and the cluster's first CTA adds
//     its CTAs' counts through distributed shared memory and writes
//     flushed[v]. No atomics in global memory, nothing to zero first: one
//     launch, one device event.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;     // threads a CTA, at most
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 4;         // slots a thread holds at once
constexpr int kTile = 4096;       // queue entries a tile
constexpr int kLoadUnroll = 8;    // queue entries a thread loads at once
constexpr int kMaxParts = 8;      // CTAs a VM: a portable cluster
constexpr int kMinCap = 32;       // hash-set slots, at least
constexpr int kEmpty = -1;        // an empty hash-set slot (entries >= 0)

// the hash set's capacity for `live` entries: a power of two, at least
// twice `live` and at least kMinCap
__host__ __device__ constexpr int set_capacity(int live) {
  int cap = kMinCap;
  while (cap < 2 * live) cap <<= 1;
  return cap;
}

__device__ __forceinline__ unsigned set_slot(int a, int bits) {
  return ((unsigned)a * 2654435761u) >> (32 - bits);
}

// Shared memory, sized at launch for a queue tile of `tile` entries: the
// tile's live entries and the hash set at its largest.
struct Smem {
  int *live, *set;

  static size_t ints(int tile) { return (size_t)tile + set_capacity(tile); }
  __device__ Smem(int* p, int tile) : live(p), set(p + tile) {}
};

__global__ void __launch_bounds__(kThreads) evict_kernel(
    const int* __restrict__ tags_in, const int* __restrict__ lru_in,
    const unsigned char* __restrict__ dirty_in, int* __restrict__ tags,
    int* __restrict__ lru, unsigned char* __restrict__ dirty,
    const int* __restrict__ queue, int* __restrict__ flushed, int sw, int q,
    int parts, int tile) {
  extern __shared__ __align__(16) int smem_raw[];
  const Smem sm(smem_raw, tile);
  __shared__ int n_live, warp_sum[kWarps], cta_flushed;
  cg::cluster_group cluster = cg::this_cluster();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int part = (int)cluster.block_rank();
  const long long v = blockIdx.x / parts;
  const int s_lo = (int)((long long)sw * part / parts);
  const int s_hi = (int)((long long)sw * (part + 1) / parts);
  const int tiles = (q + tile - 1) / tile;  // 0: nothing to evict
  const int* qrow = queue + v * q;
  const long long row = v * sw;
  int cap = kMinCap, bits = 5;  // the hash set of the current tile
  int n_flushed = 0;

  for (int c_lo = s_lo; c_lo < s_hi; c_lo += kSlots * nthreads) {
    // 1. the chunk's slots
    int tg[kSlots], lr[kSlots];
    unsigned char dt[kSlots];
    bool hit[kSlots];
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      const int i = c_lo + u * nthreads + threadIdx.x;
      hit[u] = false;
      tg[u] = lr[u] = -1;
      dt[u] = 0;
      if (i < s_hi) {
        tg[u] = __ldg(tags_in + row + i);
        lr[u] = __ldg(lru_in + row + i);
        dt[u] = __ldg(dirty_in + row + i);
      }
    }
    for (int ti = 0; ti < tiles; ++ti) {
      if (tiles > 1 || c_lo == s_lo) {  // the same in every thread
        // 1, 2. the tile's entries, compacted to the live ones
        const int len = min(tile, q - ti * tile);
        const int* qt = qrow + (long long)ti * tile;
        if (threadIdx.x == 0) n_live = 0;
        __syncthreads();  // and the previous tile's probes are done
        for (int k0 = 0; k0 < len; k0 += kLoadUnroll * nthreads) {
          int e[kLoadUnroll];
#pragma unroll
          for (int u = 0; u < kLoadUnroll; ++u) {
            const int k = k0 + u * nthreads + threadIdx.x;
            e[u] = k < len ? __ldg(qt + k) : -1;
          }
#pragma unroll
          for (int u = 0; u < kLoadUnroll; ++u) {
            const unsigned m = __ballot_sync(0xffffffffu, e[u] >= 0);
            if (!m) continue;  // the same in every lane
            int base = 0;
            if (lane == 0) base = atomicAdd(&n_live, __popc(m));
            base = __shfl_sync(0xffffffffu, base, 0);
            if (e[u] >= 0) sm.live[base + __popc(m & below)] = e[u];
          }
        }
        __syncthreads();
        // 3. the set of the live entries
        const int nl = n_live;
        cap = set_capacity(nl);
        bits = 31 - __clz(cap);
        for (int k = threadIdx.x; k < cap; k += nthreads) sm.set[k] = kEmpty;
        __syncthreads();
        for (int k = threadIdx.x; k < nl; k += nthreads) {
          const int a = sm.live[k];
          unsigned h = set_slot(a, bits);
          for (;;) {
            const int old = atomicCAS(&sm.set[h], kEmpty, a);
            if (old == kEmpty || old == a) break;
            h = (h + 1) & (cap - 1);
          }
        }
        __syncthreads();
      }
      // 4. each slot's tag looked up
#pragma unroll
      for (int u = 0; u < kSlots; ++u) {
        if (tg[u] < 0 || hit[u]) continue;
        unsigned h = set_slot(tg[u], bits);
        for (;;) {
          const int x = sm.set[h];
          if (x == tg[u]) hit[u] = true;
          if (x == tg[u] || x == kEmpty) break;
          h = (h + 1) & (cap - 1);
        }
      }
    }
    // 5. the chunk's output slots
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      const int i = c_lo + u * nthreads + threadIdx.x;
      if (i < s_hi) {
        tags[row + i] = hit[u] ? -1 : tg[u];
        lru[row + i] = hit[u] ? -1 : lr[u];
        dirty[row + i] = hit[u] ? 0 : dt[u];
        n_flushed += hit[u] && dt[u];
      }
    }
  }

  // 5. the VM's count: this CTA's warps, then the cluster's CTAs, each
  //    added by one warp's lanes at once
  n_flushed = __reduce_add_sync(0xffffffffu, n_flushed);
  if (lane == 0) warp_sum[warp] = n_flushed;
  __syncthreads();
  if (warp == 0) {
    int x = lane < nwarps ? warp_sum[lane] : 0;
    x = __reduce_add_sync(0xffffffffu, x);
    if (lane == 0) cta_flushed = x;
  }
  cluster.sync();
  if (part == 0 && warp == 0) {
    int x = lane < parts ? *cluster.map_shared_rank(&cta_flushed, lane) : 0;
    x = __reduce_add_sync(0xffffffffu, x);
    if (lane == 0) flushed[v] = x;
  }
  cluster.sync();  // every CTA's count outlives the reads
}

}  // namespace

// The input state (*_in) is read and the output state written in full,
// with flushed [V]: nothing needs zeroing first. Q may be 0 (the state is
// copied, the counts are 0). parts CTAs a VM (1 to kMaxParts, one cluster)
// of `threads` threads (a multiple of 32, at most kThreads).
extern "C" int etica_evict_scatter(
    const int* tags_in, const int* lru_in, const unsigned char* dirty_in,
    int* tags, int* lru, unsigned char* dirty, const int* queue,
    int* flushed, int num_vms, int sw, int q, int parts, int threads,
    void* stream) {
  if (num_vms <= 0 || sw <= 0) return 0;
  if (q < 0 || parts < 1 || parts > kMaxParts || threads < 32 ||
      threads > kThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  static bool configured = false;  // once, before any graph capture
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        evict_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(sizeof(int) * Smem::ints(kTile)));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int tile = std::min(kTile, std::max(32, (q + 31) / 32 * 32));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((long long)num_vms * parts));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = sizeof(int) * Smem::ints(tile);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = parts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = parts > 1 ? 1 : 0;  // one CTA a VM: a plain launch
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, evict_kernel, tags_in, lru_in, dirty_in, tags, lru, dirty, queue,
      flushed, sw, q, parts, tile);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
