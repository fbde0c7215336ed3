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
// s = addr % S, lookup and victim as in datapath.cu:
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
// Design: the set walk of set_walk.cuh, one CTA of 16 warps per VM (its
// sets split across several CTAs while the VMs leave SMs idle). With one
// level, every set is independent outright: one walk per tile, the row in
// registers up to 64 ways (RegRow), wider in the output arrays (MemRow).
//
// single_level_classified (etica_single_level_classified) replaces the
// `lax.scan` of `_simulate_single_level_classified` (src/repro/core/
// simulator.py:377-472), vmapped by
// `simulate_single_level_classified_batch` (:494-511): the same walk with
// each request's IO class (cls [V, N], clipped to [0, C)) choosing its
// policy flags (ar, inv, hd, wt as [V, C] bytes) and its insertion range
// [min(lo, hi'), hi') with hi' = min(hi, ways); lookups stay over all
// active ways. A class that bypasses sends a read to disk touching
// nothing and a write to disk dropping the cached copy unflushed; both
// count `bypassed` and advance the clock. Each non-bypassed request adds
// one to its class's served hits (a hit, unless a write under inv) or
// misses (cls_hits / cls_miss [V, C]). Counts are [V, 9] (bypassed last).
// Its walk is the one above with the class resolved in the stream step
// (the key carries the class, its bypass bit and its policy flags,
// set_walk.cuh ClassSide) and the class counts taken behind the walk
// (ClassCounts::add_tile).
//
// What bounds it on the H100: as for two_level (datapath.cu), the longest
// same-set chain (one lookup and at most one victim search a request),
// the scan of the tile and the ordered sum; at 1,024 VMs, reading the
// padded block.
#include <cuda_runtime.h>

#include "set_walk.cuh"

namespace {

using namespace etica;

struct Policy {
  bool ar, inv, hd, wt;
};

// One request under policy p. Returns the latency code: 0 t_cache,
// 1 t_hdd, 2 t_hdd_write.
template <class Row>
__device__ __forceinline__ int step(Row& row, int ways, const Policy& p,
                                    int a, bool wr, int t, int lane,
                                    int (&c)[8]) {
  const int way = row.find(a, ways, lane);
  const bool hit = way >= 0;
  if (!wr) {
    ++c[0];
    if (hit) {
      ++c[3];
      row.touch(way, lane, t, false);
      return 0;
    }
    ++c[6];
    if (p.ar && ways > 0) {
      const int w = row.victim(ways, lane);
      ++c[5];
      c[7] += row.dirty_valid(w) ? 1 : 0;
      row.put(w, lane, a, t, false);
    }
    return 1;
  }
  ++c[1];
  if (p.inv) {
    ++c[7];
    if (hit) row.put(way, lane, -1, -1, false);
    return 2;
  }
  if (hit || ways > 0) {
    ++c[5];
    c[7] += p.wt ? 1 : 0;
    if (hit) {
      ++c[4];
      row.touch(way, lane, t, p.hd);
    } else {
      const int w = row.victim(ways, lane);
      c[7] += row.dirty_valid(w) ? 1 : 0;
      row.put(w, lane, a, t, p.hd);
    }
    return p.wt ? 2 : 0;
  }
  c[7] += p.wt ? 2 : 1;  // nothing committed to the cache
  return 2;
}

// The classified walk's keys: set << sh | class << kClsFlagBits | flags
// (set_walk.cuh, ClassSide): kWrite, then the class's bypass bit and its
// policy flags.
constexpr int kByp = 2, kAr = 4, kInv = 8, kHd = 16, kWt = 32;
constexpr int kClsFlagBits = 6;

// The class of a classified key with the set above bit sh.
__device__ __forceinline__ int class_of(int key, int sh) {
  return (key >> kClsFlagBits) & ((1 << (sh - kClsFlagBits)) - 1);
}

// step for a classified request that does not bypass, under the policy
// flags of its key: as step, with insertions into [lo, hi) when that
// range is not empty. `served`: a hit, unless a write under inv.
template <class Row>
__device__ __forceinline__ int step_in(Row& row, int ways, int lo, int hi,
                                       int key, int a, bool wr, int t,
                                       int lane, int (&c)[8], bool& served) {
  const int way = row.find(a, ways, lane);
  const bool hit = way >= 0;
  served = hit && !(wr && (key & kInv));
  if (!wr) {
    ++c[0];
    if (hit) {
      ++c[3];
      row.touch(way, lane, t, false);
      return 0;
    }
    ++c[6];
    if ((key & kAr) && hi > lo) {
      const int w = row.victim_in(lo, hi, lane);
      ++c[5];
      c[7] += row.dirty_valid(w) ? 1 : 0;
      row.put(w, lane, a, t, false);
    }
    return 1;
  }
  ++c[1];
  if (key & kInv) {
    ++c[7];
    if (hit) row.put(way, lane, -1, -1, false);
    return 2;
  }
  const bool wt = (key & kWt) != 0;
  if (hit || hi > lo) {
    ++c[5];
    c[7] += wt ? 1 : 0;
    if (hit) {
      ++c[4];
      row.touch(way, lane, t, (key & kHd) != 0);
    } else {
      const int w = row.victim_in(lo, hi, lane);
      c[7] += row.dirty_valid(w) ? 1 : 0;
      row.put(w, lane, a, t, (key & kHd) != 0);
    }
    return wt ? 2 : 0;
  }
  c[7] += wt ? 2 : 1;  // nothing committed to the cache
  return 2;
}

template <class Row>
__global__ void __launch_bounds__(kWalkThreads, 2) single_level_kernel(
    const int* __restrict__ addr, const unsigned char* __restrict__ is_write,
    const int* tags_in, const int* lru_in, const unsigned char* dirty_in,
    int* tags, int* lru, unsigned char* dirty,
    const int* __restrict__ ways_v, const unsigned char* __restrict__ ar_v,
    const unsigned char* __restrict__ inv_v,
    const unsigned char* __restrict__ hd_v,
    const unsigned char* __restrict__ wt_v, const int* __restrict__ t0,
    int* __restrict__ counts, float* __restrict__ latency,
    int* __restrict__ t_end, float* lat_g, int* part_counts, int* tickets,
    int n, int sets, int ways_max, int parts, float4 lat) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tile& tile = *reinterpret_cast<Tile*>(smem);
  __shared__ RowScan<kLoadTiles> scan;
  __shared__ int total[8];
  const Split sp(parts, lat_g, part_counts, tickets, n);
  const int v = sp.v;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Level L(tags_in, lru_in, dirty_in, tags, lru, dirty,
                (long long)v * sets * ways_max, ways_max, ways_v[v]);
  const Policy p{ar_v[v] != 0, inv_v[v] != 0, hd_v[v] != 0, wt_v[v] != 0};
  const int tv = t0[v];
  if (threadIdx.x < 8) total[threadIdx.x] = 0;
  int c[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  float lat_sum = 0.0f;
  const long long row0 = (long long)v * n;
  const int valid = stream_row(
      addr + row0, is_write + row0, n, sets, tile, scan,
      [&](int fill, int base, bool first) {
        __syncthreads();
        const int tb = tv + base;
        float* lat_out = sp.lat_out(tile, base);
        for (int s = sp.first_set(warp); s < sets;
             s += sp.set_step()) {
          Row r;
          r.load(L, s, first, lane);
          for_each_request(tile, fill, s, lane, [&](int i, int a, int f) {
            const int code = step(r, L.ways, p, a, (f & kWrite) != 0, tb + i,
                                  lane, c);
            if (lane == 0) lat_out[i] = latency_of(code, lat);
          });
          r.store(L, s, lane);
        }
        __syncthreads();
        if (parts == 1 && warp == 0)
          lat_sum = ordered_sum(tile.lat, fill, lat_sum);
      });
  finish(c, total, sp, tile, counts, latency, t_end, lat_sum, valid,
         tv + valid);
}

// The classified walk: after the Tile, a per-VM table of each class's
// insertion range (clamped to the active ways), the classes' key bits
// (class << kClsFlagBits | its bypass bit and policy flags) and the
// ClassCounts. The walk leaves each request's outcome in its address
// slot for ClassCounts::add_tile (for_each_classified).
template <class Row>
__global__ void __launch_bounds__(kWalkThreads, 2)
    single_level_classified_kernel(
        const int* __restrict__ addr,
        const unsigned char* __restrict__ is_write,
        const int* __restrict__ cls, const int* tags_in, const int* lru_in,
        const unsigned char* dirty_in, int* tags, int* lru,
        unsigned char* dirty, const int* __restrict__ ways_v,
        const unsigned char* __restrict__ ar_vc,
        const unsigned char* __restrict__ inv_vc,
        const unsigned char* __restrict__ hd_vc,
        const unsigned char* __restrict__ wt_vc,
        const unsigned char* __restrict__ bypass,
        const int* __restrict__ lo_vc, const int* __restrict__ hi_vc,
        const int* __restrict__ t0, int* __restrict__ counts,
        float* __restrict__ latency, int* __restrict__ t_end,
        int* __restrict__ cls_hits, int* __restrict__ cls_miss,
        float* lat_g, int* part_counts, int* tickets, int n, int sets,
        int ways_max, int classes, int parts, float4 lat) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tile& tile = *reinterpret_cast<Tile*>(smem);
  int2* rng = reinterpret_cast<int2*>(smem + sizeof(Tile));
  int* bits = reinterpret_cast<int*>(rng + classes);
  int* xc = bits + classes;
  __shared__ RowScan<kLoadTiles> scan;
  __shared__ int total[8];
  const Split sp(parts, lat_g, part_counts, tickets, n);
  const int v = sp.v;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Level L(tags_in, lru_in, dirty_in, tags, lru, dirty,
                (long long)v * sets * ways_max, ways_max, ways_v[v]);
  const int tv = t0[v];
  const int sh = class_shift(classes, kClsFlagBits);
  if (threadIdx.x < 8) total[threadIdx.x] = 0;
  for (int j = threadIdx.x; j < classes; j += kWalkThreads) {
    const long long o = (long long)v * classes + j;
    const int hi = max(min(hi_vc[o], L.ways), 0);
    rng[j] = make_int2(max(min(lo_vc[o], hi), 0), hi);
    bits[j] = j << kClsFlagBits | (ar_vc[o] ? kAr : 0) |
              (inv_vc[o] ? kInv : 0) | (hd_vc[o] ? kHd : 0) |
              (wt_vc[o] ? kWt : 0) | (bypass[j] ? kByp : 0);
  }
  for (int j = threadIdx.x; j < 1 + 2 * classes; j += kWalkThreads)
    xc[j] = 0;
  const ClassCounts xcnt{xc, classes, counts, cls_hits, cls_miss, sh,
                         kClsFlagBits, kByp};
  int c[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  float lat_sum = 0.0f;
  const long long row0 = (long long)v * n;
  const int valid = stream_row(
      addr + row0, is_write + row0, n, sets, tile, scan,
      [&](int fill, int base, bool first) {
        __syncthreads();
        const int tb = tv + base;
        float* lat_out = sp.lat_out(tile, base);
        for (int s = sp.first_set(warp); s < sets; s += sp.set_step()) {
          Row r;
          r.load(L, s, first, lane);
          for_each_classified<true>(tile, fill, s, sh, lane,
                                    [&](int i, int a, int k) {
            const bool wr = (k & kWrite) != 0;
            int code;
            bool hit = false;
            if (k & kByp) {
              if (wr) {
                const int way = r.find(a, L.ways, lane);
                if (way >= 0) r.put(way, lane, -1, -1, false);
                ++c[1];
                ++c[7];
                code = 2;
              } else {
                ++c[0];
                ++c[6];
                code = 1;
              }
            } else {
              const int2 e = rng[class_of(k, sh)];   // under the lookup
              code = step_in(r, L.ways, e.x, e.y, k, a, wr, tb + i, lane, c,
                             hit);
            }
            if (lane == 0) lat_out[i] = latency_of(code, lat);
            return hit;
          });
          r.store(L, s, lane);
        }
        __syncthreads();
        xcnt.add_tile(tile, fill);
        __syncthreads();   // before the next tile's addresses and keys
        if (parts == 1 && warp == 0)
          lat_sum = ordered_sum(tile.lat, fill, lat_sum);
      },
      ClassSide{cls + row0, bits, classes - 1, sh});
  finish(c, total, sp, tile, counts, latency, t_end, lat_sum, valid,
         tv + valid, xcnt);
}

template <class Row>
int launch(const int* addr, const unsigned char* is_write, const int* tg_in,
           const int* lr_in, const unsigned char* dt_in, int* tg, int* lr,
           unsigned char* dt, const int* ways, const unsigned char* ar,
           const unsigned char* inv, const unsigned char* hd,
           const unsigned char* wt, const int* t0, int* counts,
           float* latency, int* t_end, float* lat_g, int* part_counts,
           int* tickets, int num_vms, int n, int sets, int ways_max,
           int parts, float4 lat, cudaStream_t stream) {
  static bool configured = false;
  const cudaError_t err =
      walk_kernel_setup(single_level_kernel<Row>, configured);
  if (err != cudaSuccess) return (int)err;
  single_level_kernel<Row><<<num_vms * parts, kWalkThreads, sizeof(Tile),
                             stream>>>(
      addr, is_write, tg_in, lr_in, dt_in, tg, lr, dt, ways, ar, inv, hd, wt,
      t0, counts, latency, t_end, lat_g, part_counts, tickets, n, sets,
      ways_max, parts, lat);
  return (int)cudaGetLastError();
}

}  // namespace

// The input state (*_in) is read, the output state written in full. With
// parts > 1 each VM's sets are split across parts CTAs, with lat_g ([V, n]
// floats), part_counts ([V, parts, 8]) and tickets ([V], zeroed) as
// scratch; with parts == 1 these may be null.
extern "C" int etica_single_level(
    const int* addr, const unsigned char* is_write, const int* tags_in,
    const int* lru_in, const unsigned char* dirty_in, int* tags, int* lru,
    unsigned char* dirty, const int* ways, const unsigned char* ar,
    const unsigned char* inv, const unsigned char* hd,
    const unsigned char* wt, const int* t0, int* counts, float* latency,
    int* t_end, float* lat_g, int* part_counts, int* tickets, int num_vms,
    int n, int sets, int ways_max, int parts, float t_cache, float t_hdd,
    float t_hdd_write, void* stream) {
  if (num_vms <= 0) return 0;
  if (parts < 1) return (int)cudaErrorInvalidValue;
  const float4 lat = make_float4(t_cache, t_hdd, t_hdd_write, 0.0f);
  auto go = [&](auto row) {
    return launch<decltype(row)>(
        addr, is_write, tags_in, lru_in, dirty_in, tags, lru, dirty, ways, ar,
        inv, hd, wt, t0, counts, latency, t_end, lat_g, part_counts, tickets,
        num_vms, n, sets, ways_max, parts, lat, (cudaStream_t)stream);
  };
  if (ways_max <= 32) return go(RegRow<1>{});
  if (ways_max <= 64) return go(RegRow<2>{});
  return go(MemRow{});
}

namespace {

template <class Row>
int launch_classified(const int* addr, const unsigned char* is_write,
                      const int* cls, const int* tg_in, const int* lr_in,
                      const unsigned char* dt_in, int* tg, int* lr,
                      unsigned char* dt, const int* ways,
                      const unsigned char* const* flags,
                      const unsigned char* bypass, const int* lo,
                      const int* hi, const int* t0, int* counts,
                      float* latency, int* t_end, int* cls_hits,
                      int* cls_miss, float* lat_g, int* part_counts,
                      int* tickets, int num_vms, int n, int sets,
                      int ways_max, int classes, int parts, float4 lat,
                      cudaStream_t stream) {
  static bool configured = false;
  const cudaError_t err =
      walk_kernel_setup(single_level_classified_kernel<Row>, configured,
                        cls_smem_bytes(kMaxClasses, sizeof(int2)));
  if (err != cudaSuccess) return (int)err;
  single_level_classified_kernel<Row>
      <<<num_vms * parts, kWalkThreads,
         cls_smem_bytes(classes, sizeof(int2)), stream>>>(addr, is_write, cls, tg_in, lr_in, dt_in, tg, lr, dt,
                   ways, flags[0], flags[1], flags[2], flags[3], bypass, lo,
                   hi, t0, counts, latency, t_end, cls_hits, cls_miss,
                   lat_g, part_counts, tickets, n, sets, ways_max, classes,
                   parts, lat);
  return (int)cudaGetLastError();
}

}  // namespace

// etica_single_level with IO classes: cls [V, n] int32 (clipped to
// [0, C)), the four policy flags as [V, C] bytes, bypass [C] bytes,
// insertion bounds lo / hi [V, C] int32 (>= 0); counts [V, 9] (bypassed
// last), cls_hits / cls_miss [V, C]. With parts > 1, part_counts holds
// [V, parts, 9 + 2C] ints. The set count must fit the keys:
// class_keys_fit(sets, class_shift(C, 6)).
extern "C" int etica_single_level_classified(
    const int* addr, const unsigned char* is_write, const int* cls,
    const int* tags_in, const int* lru_in, const unsigned char* dirty_in,
    int* tags, int* lru, unsigned char* dirty, const int* ways,
    const unsigned char* ar, const unsigned char* inv,
    const unsigned char* hd, const unsigned char* wt,
    const unsigned char* bypass, const int* lo, const int* hi,
    const int* t0, int* counts, float* latency, int* t_end, int* cls_hits,
    int* cls_miss, float* lat_g, int* part_counts, int* tickets,
    int num_vms, int n, int sets, int ways_max, int classes, int parts,
    float t_cache, float t_hdd, float t_hdd_write, void* stream) {
  if (num_vms <= 0) return 0;
  if (parts < 1 || classes < 1 || classes > kMaxClasses ||
      !class_keys_fit(sets, class_shift(classes, kClsFlagBits)))
    return (int)cudaErrorInvalidValue;
  const float4 lat = make_float4(t_cache, t_hdd, t_hdd_write, 0.0f);
  const unsigned char* flags[4] = {ar, inv, hd, wt};
  auto go = [&](auto row) {
    return launch_classified<decltype(row)>(
        addr, is_write, cls, tags_in, lru_in, dirty_in, tags, lru, dirty,
        ways, flags, bypass, lo, hi, t0, counts, latency, t_end, cls_hits,
        cls_miss, lat_g, part_counts, tickets, num_vms, n, sets, ways_max,
        classes, parts, lat, (cudaStream_t)stream);
  };
  if (ways_max <= 32) return go(RegRow<1>{});
  if (ways_max <= 64) return go(RegRow<2>{});
  return go(MemRow{});
}
