// single_level: the one-level baselines' datapath over a [V, N] block,
// each VM under its own write policy.
//
// Replaces the `lax.scan` step of `_simulate_single_level`
// (src/repro/core/simulator.py:264-321), vmapped over VMs by
// `simulate_single_level_batch` (:353-358). There is no Pallas kernel for
// it on the TPU.
//
// Per VM v the policy comes in as four flags ([V] bytes, from
// repro_torch.core.policies): allocates_reads (ar), write_invalidates
// (inv), holds_dirty (hd), write_through (wt). Per valid request (addr >=
// 0; addr = -1 is an exact no-op and does not advance the clock), with
// s = addr % S, lookup and victim as in set_lookup.cuh:
//   read  : hit -> touch (lru = t), read_hits_l2, latency t_cache; miss ->
//           disk_reads, latency t_hdd, and under ar with ways > 0 an
//           insert (clean) that counts a cache write and, for a dirty
//           victim, a disk write;
//   write : under inv the hit way is invalidated, 1 disk write, latency
//           t_hdd_write; else a hit is touched (dirty |= hd) and a miss
//           inserted (dirty = hd) when ways > 0; committed = hit | insert
//           counts a cache write, disk writes are wt + (a miss's dirty
//           victim) + (not committed), latency t_hdd_write when wt or not
//           committed, else t_cache.
// Counts are int32 in Stats order (reads, writes, read_hits_l1 = 0,
// read_hits_l2, write_hits_l2, cache_writes_l2, disk_reads, disk_writes);
// latency_sum adds each request's float32 latency in request order with
// __fadd_rn, bit-identical to the scan. The latencies come in as
// arguments from repro_torch.core.policies.
//
// What bounds it on the H100: the dependency chain, as for two_level
// (datapath.cu). Request k+1 of a VM may read the set row request k
// wrote, so a VM's requests run one after another; the bytes (the block
// plus each touched row) are small.
//
// Design: the same as two_level: one warp per VM, lanes over the ways of
// the set row, first_match and victim as warp reductions, state in global
// memory (L1-resident rows), lane 0 does the stores and the counts that
// read a stored byte; __syncwarp orders request k's stores before request
// k+1's loads. The wrapper passes a copy of the state, which the kernel
// updates in place.
#include <cuda_runtime.h>

#include "set_lookup.cuh"

namespace {

using etica::first_match;
using etica::kNone;
using etica::victim;

__global__ void single_level_kernel(
    const int* __restrict__ addr, const unsigned char* __restrict__ is_write,
    int* tags, int* lru, unsigned char* dirty, const int* __restrict__ ways_v,
    const unsigned char* __restrict__ ar_v,
    const unsigned char* __restrict__ inv_v,
    const unsigned char* __restrict__ hd_v,
    const unsigned char* __restrict__ wt_v, const int* __restrict__ t0,
    int* __restrict__ counts, float* __restrict__ latency,
    int* __restrict__ t_end, int n, int sets, int ways_max, float t_cache,
    float t_hdd, float t_hdd_write) {
  const int v = blockIdx.x;
  const int lane = threadIdx.x;
  const int ways = max(ways_v[v], 0);
  const bool ar = ar_v[v] != 0;
  const bool inv = inv_v[v] != 0;
  const unsigned char hd = hd_v[v] != 0 ? 1 : 0;
  const bool wt = wt_v[v] != 0;
  int t = t0[v];
  int reads = 0, writes = 0, read_hits = 0, write_hits = 0;
  int cache_writes = 0, disk_reads = 0, disk_writes = 0;
  float lat_sum = 0.0f;
  const long long req0 = (long long)v * n;
  for (int k = 0; k < n; ++k) {
    const int a = addr[req0 + k];
    if (a < 0) continue;
    const bool wr = is_write[req0 + k] != 0;
    const long long row = ((long long)v * sets + a % sets) * ways_max;
    int* tg = tags + row;
    int* lr = lru + row;
    unsigned char* dt = dirty + row;
    const unsigned way = first_match(tg, ways_max, ways, a, lane);
    const bool hit = way != kNone;
    float lat;
    if (!wr) {
      ++reads;
      if (hit) {
        ++read_hits;
        lat = t_cache;
        if (lane == 0) lr[way] = t;
      } else {
        ++disk_reads;
        lat = t_hdd;
        if (ar && ways > 0) {
          const int w = victim(tg, lr, ways_max, ways, lane);
          ++cache_writes;
          if (lane == 0) {
            disk_writes += (tg[w] >= 0 && dt[w] != 0) ? 1 : 0;
            tg[w] = a;
            lr[w] = t;
            dt[w] = 0;
          }
        }
      }
    } else {
      ++writes;
      if (inv) {
        ++disk_writes;
        lat = t_hdd_write;
        if (hit && lane == 0) {
          tg[way] = -1;
          lr[way] = -1;
          dt[way] = 0;
        }
      } else if (hit || ways > 0) {
        ++cache_writes;
        disk_writes += wt ? 1 : 0;
        lat = wt ? t_hdd_write : t_cache;
        if (hit) {
          ++write_hits;
          if (lane == 0) {
            lr[way] = t;
            dt[way] |= hd;
          }
        } else {
          const int w = victim(tg, lr, ways_max, ways, lane);
          if (lane == 0) {
            disk_writes += (tg[w] >= 0 && dt[w] != 0) ? 1 : 0;
            tg[w] = a;
            lr[w] = t;
            dt[w] = hd;
          }
        }
      } else {
        disk_writes += wt ? 2 : 1;  // nothing committed to the cache
        lat = t_hdd_write;
      }
    }
    lat_sum = __fadd_rn(lat_sum, lat);
    ++t;
    __syncwarp();
  }
  if (lane == 0) {
    int* c = counts + (long long)v * 8;
    c[0] = reads;
    c[1] = writes;
    c[2] = 0;
    c[3] = read_hits;
    c[4] = write_hits;
    c[5] = cache_writes;
    c[6] = disk_reads;
    c[7] = disk_writes;
    latency[v] = lat_sum;
    t_end[v] = t;
  }
}

}  // namespace

extern "C" int etica_single_level(
    const int* addr, const unsigned char* is_write, int* tags, int* lru,
    unsigned char* dirty, const int* ways, const unsigned char* ar,
    const unsigned char* inv, const unsigned char* hd,
    const unsigned char* wt, const int* t0, int* counts, float* latency,
    int* t_end, int num_vms, int n, int sets, int ways_max, float t_cache,
    float t_hdd, float t_hdd_write, void* stream) {
  if (num_vms <= 0) return 0;
  single_level_kernel<<<num_vms, 32, 0, (cudaStream_t)stream>>>(
      addr, is_write, tags, lru, dirty, ways, ar, inv, hd, wt, t0, counts,
      latency, t_end, n, sets, ways_max, t_cache, t_hdd, t_hdd_write);
  return (int)cudaGetLastError();
}
