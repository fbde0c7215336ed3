// two_level: ETICA's DRAM(RO) + SSD(WBWO) datapath over a [V, N] block.
//
// Replaces the `lax.scan` of `_simulate_two_level`
// (src/repro/core/simulator.py:374-439), vmapped over VMs by
// `simulate_two_level_batch` (:456-475). There is no Pallas kernel for it
// on the TPU; PyTorch has no scan, and a plain loop would pay one Python
// step per request.
//
// Per valid request (addr >= 0; addr = -1 is an exact no-op and does not
// advance the clock), with sd = addr % S_dram and s2 = addr % S_ssd:
//   lookup : first active way (w < ways) whose tag equals addr;
//   victim : first minimum of score(w) = -1 for an empty active way,
//            lru for a full active way, INT32_MAX for an inactive way;
//   read   : DRAM hit -> touch; else SSD hit -> touch SSD; a DRAM miss
//            inserts into DRAM (clean) when ways_dram > 0;
//   write  : invalidate a DRAM copy; SSD hit -> touch + dirty; an SSD
//            miss goes to disk ("full") or is inserted dirty ("npe"),
//            counting a dirty victim as a disk write.
// Counts are int32; latency_sum adds each request's float32 latency in
// request order with __fadd_rn, so it is bit-identical to the scan. The
// four latencies come in as arguments from repro_torch.core.policies.
//
// What bounds it on the H100: the dependency chain. Request k+1 of a VM
// may read the set row request k wrote, so a VM's requests run one after
// another: two lookups, at most one victim search and a handful of
// stores, each a few warp-synchronous steps and global-memory round trips
// (mostly L1/L2 hits). The bytes (the block plus each touched set row)
// are small; time is about N x (per-request latency).
//
// Design: one warp per VM, so VMs run in parallel and requests in order.
// In this version the state stays in global memory (the touched rows stay
// in L1); lanes cover the ways of a set row, and lookups and the victim
// search are warp reductions (set_lookup.cuh: __reduce_min_sync on the
// way index, a shuffle butterfly on the (score, way) key). Lane 0 does the
// stores and keeps the counts; __syncwarp orders one request's stores
// before the next request's loads. The wrapper passes copies of the states, which
// the kernel updates in place.
#include <cuda_runtime.h>

#include "set_lookup.cuh"

namespace {

using etica::first_match;
using etica::kNone;
using etica::victim;

__global__ void two_level_kernel(
    const int* __restrict__ addr, const unsigned char* __restrict__ is_write,
    int* tags_d, int* lru_d, unsigned char* dirty_d, int* tags_s, int* lru_s,
    unsigned char* dirty_s, const int* __restrict__ ways_d_v,
    const int* __restrict__ ways_s_v, const int* __restrict__ t0,
    int* __restrict__ counts, float* __restrict__ latency,
    int* __restrict__ t_end, int n, int sets_d, int ways_max_d, int sets_s,
    int ways_max_s, int npe, float t_dram, float t_ssd, float t_hdd,
    float t_hdd_write) {
  const int v = blockIdx.x;
  const int lane = threadIdx.x;
  const int ways_d = max(ways_d_v[v], 0);
  const int ways_s = max(ways_s_v[v], 0);
  int t = t0[v];
  int reads = 0, writes = 0, hits_l1 = 0, read_hits_l2 = 0, write_hits_l2 = 0;
  int cache_writes_l2 = 0, disk_reads = 0, disk_writes = 0;
  float lat_sum = 0.0f;
  const long long req0 = (long long)v * n;
  for (int k = 0; k < n; ++k) {
    const int a = addr[req0 + k];
    if (a < 0) continue;
    const bool wr = is_write[req0 + k] != 0;
    const long long rd_ = ((long long)v * sets_d + a % sets_d) * ways_max_d;
    const long long rs_ = ((long long)v * sets_s + a % sets_s) * ways_max_s;
    int* td = tags_d + rd_;
    int* ld = lru_d + rd_;
    unsigned char* dd = dirty_d + rd_;
    int* ts = tags_s + rs_;
    int* ls = lru_s + rs_;
    unsigned char* ds = dirty_s + rs_;
    const unsigned d_way = first_match(td, ways_max_d, ways_d, a, lane);
    const unsigned s_way = first_match(ts, ways_max_s, ways_s, a, lane);
    const bool d_hit = d_way != kNone;
    const bool s_hit = s_way != kNone;
    float lat;
    if (!wr) {
      ++reads;
      if (d_hit) {
        ++hits_l1;
        lat = t_dram;
        if (lane == 0) ld[d_way] = t;
      } else {
        if (s_hit) {
          ++read_hits_l2;
          lat = t_ssd;
          if (lane == 0) ls[s_way] = t;
        } else {
          ++disk_reads;
          lat = t_hdd;
        }
        if (ways_d > 0) {
          const int w = victim(td, ld, ways_max_d, ways_d, lane);
          if (lane == 0) {
            td[w] = a;
            ld[w] = t;
            dd[w] = 0;
          }
        }
      }
    } else {
      ++writes;
      if (d_hit && lane == 0) {
        td[d_way] = -1;
        ld[d_way] = -1;
        dd[d_way] = 0;
      }
      if (s_hit) {
        ++write_hits_l2;
        ++cache_writes_l2;
        lat = t_ssd;
        if (lane == 0) {
          ls[s_way] = t;
          ds[s_way] = 1;
        }
      } else if (npe && ways_s > 0) {
        const int w = victim(ts, ls, ways_max_s, ways_s, lane);
        ++cache_writes_l2;
        lat = t_ssd;
        if (lane == 0) {
          disk_writes += (ts[w] >= 0 && ds[w] != 0) ? 1 : 0;
          ts[w] = a;
          ls[w] = t;
          ds[w] = 1;
        }
      } else {
        ++disk_writes;
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
    c[2] = hits_l1;
    c[3] = read_hits_l2;
    c[4] = write_hits_l2;
    c[5] = cache_writes_l2;
    c[6] = disk_reads;
    c[7] = disk_writes;
    latency[v] = lat_sum;
    t_end[v] = t;
  }
}

}  // namespace

extern "C" int etica_two_level(
    const int* addr, const unsigned char* is_write, int* tags_d, int* lru_d,
    unsigned char* dirty_d, int* tags_s, int* lru_s, unsigned char* dirty_s,
    const int* ways_d, const int* ways_s, const int* t0, int* counts,
    float* latency, int* t_end, int num_vms, int n, int sets_d, int ways_max_d,
    int sets_s, int ways_max_s, int npe, float t_dram, float t_ssd,
    float t_hdd, float t_hdd_write, void* stream) {
  if (num_vms <= 0) return 0;
  two_level_kernel<<<num_vms, 32, 0, (cudaStream_t)stream>>>(
      addr, is_write, tags_d, lru_d, dirty_d, tags_s, lru_s, dirty_s, ways_d,
      ways_s, t0, counts, latency, t_end, n, sets_d, ways_max_d, sets_s,
      ways_max_s, npe, t_dram, t_ssd, t_hdd, t_hdd_write);
  return (int)cudaGetLastError();
}
