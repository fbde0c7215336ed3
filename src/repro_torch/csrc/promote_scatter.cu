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
// repeat an address, turn it on. The Pallas original tests every queue
// entry against every set of a strip, a dense [QC, TS, W] compare made
// for the TPU's vector unit.
//
// What bounds it on the H100: the state's bytes (read once, written once)
// and the queue's, a fraction of a megabyte at the paper's shapes; in
// practice the latency of a few dependent steps, so the design keeps the
// whole function in one launch with every load of a step in flight.
//
// Design: one thread-block cluster a VM, `parts` CTAs of up to 16 warps
// (the wrapper picks both from shapes: more CTAs a VM while the VMs leave
// SMs idle, fewer warps a CTA when the VMs alone fill the card, so that
// several CTAs share an SM's registers),
// each CTA a contiguous range of the VM's sets, in chunks of at most
// kChunkSets sets whose tags fit kStageInts of shared memory:
//  1. Stage. The CTA copies its chunk's tag, lru and dirty rows from the
//     input state to the output state (so the wrapper clones nothing) and
//     keeps the tags in shared memory. In the same step it loads a tile of
//     the VM's queue (up to kTile entries, each warp a run of consecutive
//     ones, all loads in flight).
//  2. Bucket. The tile's entries of the chunk's sets are grouped by set,
//     stably (queue order kept): each warp counts its run of entries per
//     set (shared-memory atomics), one scan turns the counts into each
//     warp's offsets, and each warp places its entries at their offsets
//     in order, a round's lanes of one set ranked by __match_any_sync.
//  3. Walk. Warp w takes the chunk's sets w, w + 16, ...: the set's tags
//     in registers (one way a lane and register, W <= 128), its free ways
//     listed by ballot, then its bucket 32 entries at a time. An entry is
//     resident when a ballot finds its address among the tags; ranks come
//     from __popc of the eligible lanes below; the k-th eligible entry
//     writes its free way of the output. Dedupe: two entries with one
//     address fall in one set and are both resident or both not, so only
//     entries already placed in the set can repeat. The walk writes each
//     placement into the staged row and tests against it, which is
//     "resident in the input, or placed already"; __match_any_sync drops
//     a repeat among the lanes of one round (the lowest lane is the
//     earliest entry). Without dedupe the staged row stays the input and
//     repeats are placed again, as the plain version places them.
//  Queues longer than one tile go through it tile by tile, each set's
//  placements carried in the staged row (dedupe) or a count (taken).
//  4. Count. The warps' placements add up in shared memory; the
//     cluster's first CTA adds its CTAs' counts through distributed
//     shared memory and writes promoted[v]. No atomics in global memory,
//     nothing to zero first: one launch, one device event.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 16;               // warps a CTA, at most
constexpr int kThreads = kWarps * 32;
constexpr int kMaxWays = 128;
constexpr int kRegWays = kMaxWays / 32;  // ways a lane holds
constexpr int kChunkSets = 256;          // sets a chunk, at most
constexpr int kStageInts = 16384;        // staged tags, at most
constexpr int kTile = 4096;              // queue entries a tile
constexpr int kRounds = 8;               // rounds of 32 entries a warp
constexpr int kMaxParts = 8;             // CTAs a VM: a portable cluster
constexpr int kCopyUnroll = 4;

// Shared memory, sized at launch for `chunk` sets of `ways` ways and a
// queue tile of `tile` entries (so that small shapes leave room for more
// CTAs on an SM): the chunk's rows (dedupe: as placed), each warp's count
// then offset a set, the tile's entries grouped by set, each set's first
// bucket slot, its placements so far (no dedupe), a warp's walked set's
// free ways, the warps' placements and the CTA's.
struct Smem {
  int *tags, *cnt, *bucket, *start, *taken, *free_way, *warp_sum, *promoted;

  static size_t ints(int chunk, int ways, int tile) {
    return (size_t)chunk * ways + (size_t)kWarps * chunk + tile + chunk + 1 +
           chunk + (size_t)kWarps * ways + kWarps + 1;  // kWarps at most
  }
  __device__ Smem(int* p, int chunk, int ways, int tile)
      : tags(p),
        cnt(tags + chunk * ways),
        bucket(cnt + kWarps * chunk),
        start(bucket + tile),
        taken(start + chunk + 1),
        free_way(taken + chunk),
        warp_sum(free_way + kWarps * ways),
        promoted(warp_sum + kWarps) {}
};
constexpr size_t kMaxSmemInts =  // chunk * ways <= kStageInts
    kStageInts + kWarps * kChunkSets + kTile + 2 * kChunkSets + 1 +
    kWarps * kMaxWays + kWarps + 1;

__global__ void __launch_bounds__(kThreads) promote_kernel(
    const int* __restrict__ tags_in, const int* __restrict__ lru_in,
    const unsigned char* __restrict__ dirty_in, int* __restrict__ tags,
    int* __restrict__ lru, unsigned char* __restrict__ dirty,
    const int* __restrict__ queue, const int* __restrict__ ways_v,
    const int* __restrict__ t_v, int* __restrict__ promoted, int num_sets,
    int num_ways, int q, int parts, int chunk, int tile, bool dedupe) {
  extern __shared__ __align__(16) int smem_raw[];
  const Smem sm(smem_raw, chunk, num_ways, tile);
  cg::cluster_group cluster = cg::this_cluster();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int part = (int)cluster.block_rank();
  const long long v = blockIdx.x / parts;
  const int s_lo = (int)((long long)num_sets * part / parts);
  const int s_hi = (int)((long long)num_sets * (part + 1) / parts);
  const int ways = min(max(ways_v[v], 0), num_ways);
  const int t = t_v[v];
  const int tiles = max(1, (q + tile - 1) / tile);
  const int nwarps = blockDim.x >> 5, nthreads = blockDim.x;
  const int* qrow = queue + v * q;
  int placed = 0;  // this warp's placements, the same in every lane

  for (int c_lo = s_lo; c_lo < s_hi; c_lo += chunk) {
    const int nc = min(chunk, s_hi - c_lo);
    const long long base = (v * num_sets + c_lo) * num_ways;
    for (int ti = 0; ti < tiles; ++ti) {
      // 1. the tile's entries (a warp's run of consecutive ones) and, on
      //    the chunk's first tile, its rows: every load in flight
      const int tile_len = min(tile, q - ti * tile);
      const int seg = ((tile_len + nwarps - 1) / nwarps + 31) & ~31;
      const int rounds = seg / 32;  // <= kRounds
      int e[kRounds], key[kRounds];
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        const int k = warp * seg + r * 32 + lane;
        e[r] = r < rounds && k < tile_len ? __ldg(qrow + ti * tile + k)
                                          : -1;
      }
      if (ti == 0) {
        const int n = nc * num_ways;
        for (int i0 = 0; i0 < n; i0 += kCopyUnroll * nthreads) {
          int tg[kCopyUnroll], lr[kCopyUnroll];
          unsigned char dt[kCopyUnroll];
#pragma unroll
          for (int u = 0; u < kCopyUnroll; ++u) {
            const int i = i0 + u * nthreads + threadIdx.x;
            if (i < n) {
              tg[u] = __ldg(tags_in + base + i);
              lr[u] = __ldg(lru_in + base + i);
              dt[u] = __ldg(dirty_in + base + i);
            }
          }
#pragma unroll
          for (int u = 0; u < kCopyUnroll; ++u) {
            const int i = i0 + u * nthreads + threadIdx.x;
            if (i < n) {
              sm.tags[i] = tg[u];
              tags[base + i] = tg[u];
              lru[base + i] = lr[u];
              dirty[base + i] = dt[u];
            }
          }
        }
        for (int i = threadIdx.x; i < nc; i += nthreads) sm.taken[i] = 0;
      }
      for (int i = threadIdx.x; i < nwarps * nc; i += nthreads) sm.cnt[i] = 0;
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        const int c = e[r] >= 0 ? e[r] % num_sets - c_lo : -1;
        key[r] = c >= 0 && c < nc ? c : -1;
      }
      __syncthreads();

      // 2. bucket by set, stably: counts, offsets, places
#pragma unroll
      for (int r = 0; r < kRounds; ++r)
        if (key[r] >= 0) atomicAdd(&sm.cnt[warp * nc + key[r]], 1);
      __syncthreads();
      {
        const int c = threadIdx.x;
        int total = 0;
        if (c < nc)
          for (int w = 0; w < nwarps; ++w) total += sm.cnt[w * nc + c];
        int x = total;  // inclusive scan over the sets
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, x, o);
          if (lane >= o) x += y;
        }
        if (lane == 31) sm.warp_sum[warp] = x;
        __syncthreads();
        int before = 0;
        for (int w = 0; w < warp; ++w) before += sm.warp_sum[w];
        if (c < nc) {
          int run = before + x - total;
          sm.start[c] = run;
          if (c == nc - 1) sm.start[nc] = run + total;
          for (int w = 0; w < nwarps; ++w) {
            const int n = sm.cnt[w * nc + c];
            sm.cnt[w * nc + c] = run;
            run += n;
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        const bool in = key[r] >= 0;
        if (r >= rounds || !__any_sync(0xffffffffu, in)) continue;
        const unsigned peers = __match_any_sync(0xffffffffu, key[r]);
        if (in)
          sm.bucket[sm.cnt[warp * nc + key[r]] + __popc(peers & below)] =
              e[r];
        __syncwarp();
        if (in && lane == __ffs(peers) - 1)
          sm.cnt[warp * nc + key[r]] += __popc(peers);
        __syncwarp();
      }
      __syncthreads();

      // 3. each warp walks its sets' entries
      for (int c = warp; c < nc; c += nwarps) {
        const int b0 = sm.start[c], b1 = sm.start[c + 1];
        if (b0 == b1) continue;
        int* row = sm.tags + c * num_ways;
        int tg[kRegWays];
        int n_free = 0;
#pragma unroll
        for (int j = 0; j < kRegWays; ++j) {
          const int w = j * 32 + lane;
          const int tag = w < ways ? row[w] : -1;
          tg[j] = tag;  // inactive ways read -1: never an address
          if (j * 32 >= ways) continue;  // the same in every lane
          const bool f = w < ways && tag < 0;
          const unsigned m = __ballot_sync(0xffffffffu, f);
          if (f)
            sm.free_way[warp * num_ways + n_free + __popc(m & below)] = w;
          n_free += __popc(m);
        }
        const int done0 = dedupe ? 0 : sm.taken[c];
        int done = done0;
        __syncwarp();
        for (int b = b0; b < b1 && done < n_free; b += 32) {
          const int nb = min(32, b1 - b);
          const int a = lane < nb ? sm.bucket[b + lane] : -1;
          unsigned resident = 0u;
          for (int k = 0; k < nb; ++k) {
            const int ak = __shfl_sync(0xffffffffu, a, k);
            bool hit = false;
#pragma unroll
            for (int j = 0; j < kRegWays; ++j) hit |= tg[j] == ak;
            resident |= (unsigned)__any_sync(0xffffffffu, hit) << k;
          }
          bool elig = lane < nb && !((resident >> lane) & 1u);
          if (dedupe) {
            const unsigned same =  // the ineligible share one key: -1
                __match_any_sync(0xffffffffu, elig ? a : -1);
            elig = elig && (same & below) == 0u;
          }
          const unsigned m = __ballot_sync(0xffffffffu, elig);
          if (elig) {
            const int rank = done + __popc(m & below);
            if (rank < n_free) {
              const int w = sm.free_way[warp * num_ways + rank];
              const long long slot = base + (long long)c * num_ways + w;
              tags[slot] = a;
              lru[slot] = t;
              dirty[slot] = 0;
              if (dedupe) row[w] = a;
            }
          }
          const int add = min(__popc(m), n_free - done);
          done += add;
          if (dedupe && add) {
            __syncwarp();
#pragma unroll
            for (int j = 0; j < kRegWays; ++j) {
              const int w = j * 32 + lane;
              tg[j] = w < ways ? row[w] : -1;
            }
          }
        }
        if (!dedupe && lane == 0) sm.taken[c] = done;
        placed += done - done0;
        __syncwarp();  // the free-way list is rewritten by the next set
      }
      __syncthreads();  // the tile's buffers (and the chunk's rows) reused
    }
  }

  // 4. the VM's count: this CTA's warps, then the cluster's CTAs, each
  //    added by one warp's lanes at once
  if (lane == 0) sm.warp_sum[warp] = placed;
  __syncthreads();
  if (warp == 0) {
    int x = lane < nwarps ? sm.warp_sum[lane] : 0;
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0) *sm.promoted = x;
  }
  cluster.sync();
  if (part == 0 && warp == 0) {
    int x = lane < parts ? *cluster.map_shared_rank(sm.promoted, lane) : 0;
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0) promoted[v] = x;
  }
  cluster.sync();  // every CTA's count outlives the reads
}

}  // namespace

// The input state (*_in) is read and the output state written in full,
// with promoted [V]: nothing needs zeroing first. parts CTAs a VM (1 to
// kMaxParts, one cluster) of `warps` warps (1 to kWarps), W <= kMaxWays.
extern "C" int etica_promote_scatter(
    const int* tags_in, const int* lru_in, const unsigned char* dirty_in,
    int* tags, int* lru, unsigned char* dirty, const int* queue,
    const int* ways, const int* t, int* promoted, int num_vms, int num_sets,
    int num_ways, int q, int parts, int warps, int dedupe, void* stream) {
  if (num_vms <= 0 || num_sets <= 0 || num_ways <= 0) return 0;
  if (num_ways > kMaxWays || q < 0 || parts < 1 || parts > kMaxParts ||
      warps < 1 || warps > kWarps)
    return (int)cudaErrorInvalidValue;
  static bool configured = false;  // once, before any graph capture
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        promote_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(sizeof(int) * kMaxSmemInts));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  // a chunk's sets within one pass of the scan (a thread a set), a tile
  // within kRounds rounds of every warp
  const int part_sets = (num_sets + parts - 1) / parts;
  const int chunk = std::min(
      {kChunkSets, kStageInts / num_ways, part_sets, warps * 32});
  const int tile = std::min({kTile, warps * 32 * kRounds,
                             std::max(32, (q + 31) / 32 * 32)});
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((long long)num_vms * parts));
  cfg.blockDim = dim3(warps * 32);
  cfg.dynamicSmemBytes = sizeof(int) * Smem::ints(chunk, num_ways, tile);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = parts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = parts > 1 ? 1 : 0;  // one CTA a VM: a plain launch
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, promote_kernel, tags_in, lru_in, dirty_in, tags, lru, dirty,
      queue, ways, t, promoted, num_sets, num_ways, q, parts, chunk, tile,
      dedupe != 0);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
