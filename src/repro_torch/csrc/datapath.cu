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
//            lru for a full active way, over the active ways;
//   read   : DRAM hit -> touch; else SSD hit -> touch SSD; a DRAM miss
//            inserts into DRAM (clean) when ways_dram > 0;
//   write  : invalidate a DRAM copy; SSD hit -> touch + dirty; an SSD
//            miss goes to disk ("full") or is inserted dirty ("npe"),
//            counting a dirty victim as a disk write.
// Counts are int32; latency_sum adds each request's float32 latency in
// request order with __fadd_rn, so it is bit-identical to the scan. The
// four latencies come in as arguments from repro_torch.core.policies.
//
// Design: the set walk of set_walk.cuh, one CTA of 16 warps per VM. The
// DRAM level's update depends only on its own set and the clock; the
// SSD's on its own set and the request's DRAM hit (a read touches the SSD
// only on a DRAM miss). When S_dram == S_ssd one walk carries both rows
// of a set, with both lookups issued before either is used; otherwise
// the same launch walks the DRAM sets first, keeping each request's DRAM
// hit, and after a barrier the SSD sets. Rows of up to 64 ways are held
// in registers (RegRow), wider ones in the output arrays (MemRow). With
// equal set counts and fewer VMs than SMs, a VM's sets are split across
// several CTAs (set_walk.cuh, Split).
//
// two_level_classified (etica_two_level_classified) replaces the
// `lax.scan` of `_simulate_two_level_classified` (src/repro/core/
// simulator.py:514-621), vmapped by `simulate_two_level_classified_batch`
// (:642-662): the same walk with each request's IO class (cls [V, N],
// clipped to [0, C)). A class that bypasses sends a read to disk touching
// nothing, and a write to disk dropping both levels' copies unflushed;
// both count `bypassed` and advance the clock. Any other request runs as
// above, with its insertion victims taken from its class's way range,
// [min(lo, hi'), hi') with hi' = min(hi, ways) at each level; lookups
// stay over all active ways. Each non-bypassed request adds one to its
// class's served hits (a read's DRAM or SSD hit, a write's SSD hit) or
// misses (cls_hits / cls_miss [V, C]). Counts are [V, 9] (bypassed last).
// Its walk is the one above with the class resolved in the stream step
// (the key carries the class and its bypass bit, set_walk.cuh ClassSide)
// and the class counts taken behind the walk (ClassCounts::add_tile).
//
// What bounds it on the H100: the longest same-set chain (about 420 of
// the paper's 1,000-request blocks at 64 sets), each request a few
// hundred cycles of one warp's dependent steps (lookups and at most one
// victim search, each a warp reduction in registers, then selects); the
// scan of the tile, one pass a set; the ordered sum, one dependent add a
// request. At 1,024 VMs, reading the padded [V, N] block (5 bytes a
// column).
#include <cuda_runtime.h>

#include "set_walk.cuh"

namespace {

using namespace etica;

// The DRAM level (RO) given the request's lookup `way` (-1 for a miss):
// a read hit touches, a read miss inserts clean (when ways > 0), a write
// invalidates a hit. Counts reads, writes, read_hits_l1; returns the hit.
template <class Row>
__device__ __forceinline__ bool dram_step(Row& row, int ways, int a, bool wr,
                                          int t, int lane, int (&c)[8],
                                          int way) {
  const bool hit = way >= 0;
  if (!wr) {
    ++c[0];
    if (hit) {
      ++c[2];
      row.touch(way, lane, t, false);
    } else if (ways > 0) {
      row.put(row.victim(ways, lane), lane, a, t, false);
    }
  } else {
    ++c[1];
    if (hit) row.put(way, lane, -1, -1, false);
  }
  return hit;
}

// The SSD level (WBWO) given the DRAM hit and the request's lookup `way`:
// a read that missed DRAM touches a hit; a write touches a hit and marks
// it dirty, and a miss goes to disk ("full") or is inserted dirty ("npe",
// a dirty victim counting a disk write). The rest of the counts; returns
// the latency code: 0 DRAM, 1 SSD, 2 disk read, 3 disk write.
template <class Row>
__device__ __forceinline__ int ssd_step(Row& row, int ways, int a, bool wr,
                                        int t, bool d_hit, bool npe, int lane,
                                        int (&c)[8], int way) {
  if (!wr) {
    if (d_hit) return 0;
    if (way >= 0) {
      ++c[3];
      row.touch(way, lane, t, false);
      return 1;
    }
    ++c[6];
    return 2;
  }
  if (way >= 0) {
    ++c[4];
    ++c[5];
    row.touch(way, lane, t, true);
    return 1;
  }
  if (npe && ways > 0) {
    const int w = row.victim(ways, lane);
    ++c[5];
    c[7] += row.dirty_valid(w) ? 1 : 0;
    row.put(w, lane, a, t, true);
    return 1;
  }
  ++c[7];
  return 3;
}

// The classified walk's keys: set << sh | class << kClsFlagBits | flags
// (set_walk.cuh, ClassSide), the flags kWrite, kDHit and kByp.
constexpr int kByp = 4;
constexpr int kClsFlagBits = 3;

// The class of a classified key with the set above bit sh.
__device__ __forceinline__ int class_of(int key, int sh) {
  return (key >> kClsFlagBits) & ((1 << (sh - kClsFlagBits)) - 1);
}

// dram_step for a classified request that does not bypass: a read miss
// inserts into [lo, hi) when that range is not empty.
template <class Row>
__device__ __forceinline__ bool dram_step_in(Row& row, int lo, int hi, int a,
                                             bool wr, int t, int lane,
                                             int (&c)[8], int way) {
  const bool hit = way >= 0;
  if (!wr) {
    ++c[0];
    if (hit) {
      ++c[2];
      row.touch(way, lane, t, false);
    } else if (hi > lo) {
      row.put(row.victim_in(lo, hi, lane), lane, a, t, false);
    }
  } else {
    ++c[1];
    if (hit) row.put(way, lane, -1, -1, false);
  }
  return hit;
}

// ssd_step for a classified request that does not bypass: an "npe" write
// miss inserts into [lo, hi) when that range is not empty.
template <class Row>
__device__ __forceinline__ int ssd_step_in(Row& row, int lo, int hi, int a,
                                           bool wr, int t, bool d_hit,
                                           bool npe, int lane, int (&c)[8],
                                           int way) {
  if (!wr) {
    if (d_hit) return 0;
    if (way >= 0) {
      ++c[3];
      row.touch(way, lane, t, false);
      return 1;
    }
    ++c[6];
    return 2;
  }
  if (way >= 0) {
    ++c[4];
    ++c[5];
    row.touch(way, lane, t, true);
    return 1;
  }
  if (npe && hi > lo) {
    const int w = row.victim_in(lo, hi, lane);
    ++c[5];
    c[7] += row.dirty_valid(w) ? 1 : 0;
    row.put(w, lane, a, t, true);
    return 1;
  }
  ++c[7];
  return 3;
}

// Drops a bypassed write's cached copy (way >= 0) without flushing it.
template <class Row>
__device__ __forceinline__ void drop(Row& row, int way, int lane) {
  if (way >= 0) row.put(way, lane, -1, -1, false);
}

// The counts of a bypassed request (its disk access; `bypassed` is counted
// behind the walk, ClassCounts::add_tile); returns its latency code: 2
// disk read, 3 disk write.
__device__ __forceinline__ int bypass_counts(bool wr, int (&c)[8]) {
  if (wr) {
    ++c[1];
    ++c[7];
    return 3;
  }
  ++c[0];
  ++c[6];
  return 2;
}

template <class Row>
__global__ void __launch_bounds__(kWalkThreads, 2) two_level_kernel(
    const int* __restrict__ addr, const unsigned char* __restrict__ is_write,
    const int* tags_d_in, const int* lru_d_in,
    const unsigned char* dirty_d_in, const int* tags_s_in,
    const int* lru_s_in, const unsigned char* dirty_s_in, int* tags_d,
    int* lru_d, unsigned char* dirty_d, int* tags_s, int* lru_s,
    unsigned char* dirty_s, const int* __restrict__ ways_d_v,
    const int* __restrict__ ways_s_v, const int* __restrict__ t0,
    int* __restrict__ counts, float* __restrict__ latency,
    int* __restrict__ t_end, float* lat_g, int* part_counts, int* tickets,
    int n, int sets_d, int ways_max_d, int sets_s, int ways_max_s, int npe,
    int parts, float4 lat) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tile& tile = *reinterpret_cast<Tile*>(smem);
  __shared__ RowScan<kLoadTiles> scan;
  __shared__ int total[8];
  const Split sp(parts, lat_g, part_counts, tickets, n);
  const int v = sp.v;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Level D(tags_d_in, lru_d_in, dirty_d_in, tags_d, lru_d, dirty_d,
                (long long)v * sets_d * ways_max_d, ways_max_d, ways_d_v[v]);
  const Level S(tags_s_in, lru_s_in, dirty_s_in, tags_s, lru_s, dirty_s,
                (long long)v * sets_s * ways_max_s, ways_max_s, ways_s_v[v]);
  const int tv = t0[v];
  if (threadIdx.x < 8) total[threadIdx.x] = 0;
  int c[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  float lat_sum = 0.0f;
  const long long row0 = (long long)v * n;
  const int valid = stream_row(
      addr + row0, is_write + row0, n, sets_d, tile, scan,
      [&](int fill, int base, bool first) {
        __syncthreads();
        const int tb = tv + base;
        float* lat_out = sp.lat_out(tile, base);
        if (sets_d == sets_s) {
          for (int s = sp.first_set(warp); s < sets_d;
               s += sp.set_step()) {
            Row rd, rs;
            rd.load(D, s, first, lane);
            rs.load(S, s, first, lane);
            for_each_request(tile, fill, s, lane, [&](int i, int a, int f) {
              const bool wr = (f & kWrite) != 0;
              // both lookups first, so their reductions overlap
              const int dw = rd.find(a, D.ways, lane);
              const int sw = rs.find(a, S.ways, lane);
              const bool dh = dram_step(rd, D.ways, a, wr, tb + i, lane, c, dw);
              const int code = ssd_step(rs, S.ways, a, wr, tb + i, dh,
                                        npe != 0, lane, c, sw);
              if (lane == 0) lat_out[i] = latency_of(code, lat);
            });
            rd.store(D, s, lane);
            rs.store(S, s, lane);
          }
        } else {
          for (int s = sp.first_set(warp); s < sets_d;
               s += sp.set_step()) {
            Row rd;
            rd.load(D, s, first, lane);
            for_each_request(tile, fill, s, lane, [&](int i, int a, int f) {
              const bool dh = dram_step(rd, D.ways, a, (f & kWrite) != 0,
                                        tb + i, lane, c,
                                        rd.find(a, D.ways, lane));
              if (lane == 0) tile.lat[i] = dh ? 1.0f : 0.0f;
            });
            rd.store(D, s, lane);
          }
          __syncthreads();
          rekey(tile, fill, sets_s);
          __syncthreads();
          for (int s = sp.first_set(warp); s < sets_s;
               s += sp.set_step()) {
            Row rs;
            rs.load(S, s, first, lane);
            for_each_request(tile, fill, s, lane, [&](int i, int a, int f) {
              const int code = ssd_step(rs, S.ways, a, (f & kWrite) != 0,
                                        tb + i, (f & kDHit) != 0, npe != 0,
                                        lane, c, rs.find(a, S.ways, lane));
              if (lane == 0) lat_out[i] = latency_of(code, lat);
            });
            rs.store(S, s, lane);
          }
        }
        __syncthreads();
        if (parts == 1 && warp == 0)
          lat_sum = ordered_sum(tile.lat, fill, lat_sum);
      });
  finish(c, total, sp, tile, counts, latency, t_end, lat_sum, valid,
         tv + valid);
}

// The classified walk: after the Tile, a per-VM table of each class's
// DRAM and SSD insertion ranges (clamped to the active ways), the
// classes' key bits (class << kClsFlagBits | kByp for a class that
// bypasses) and the ClassCounts. The tile's last walk (the SSD walk when
// the set counts differ) leaves each request's outcome in its address
// slot for ClassCounts::add_tile (for_each_classified).
template <class Row>
__global__ void __launch_bounds__(kWalkThreads, 2)
    two_level_classified_kernel(
        const int* __restrict__ addr,
        const unsigned char* __restrict__ is_write,
        const int* __restrict__ cls, const int* tags_d_in,
        const int* lru_d_in, const unsigned char* dirty_d_in,
        const int* tags_s_in, const int* lru_s_in,
        const unsigned char* dirty_s_in, int* tags_d, int* lru_d,
        unsigned char* dirty_d, int* tags_s, int* lru_s,
        unsigned char* dirty_s, const int* __restrict__ ways_d_v,
        const int* __restrict__ ways_s_v, const int* __restrict__ t0,
        const unsigned char* __restrict__ bypass,
        const int* __restrict__ lo_d, const int* __restrict__ hi_d,
        const int* __restrict__ lo_s, const int* __restrict__ hi_s,
        int* __restrict__ counts, float* __restrict__ latency,
        int* __restrict__ t_end, int* __restrict__ cls_hits,
        int* __restrict__ cls_miss, float* lat_g, int* part_counts,
        int* tickets, int n, int sets_d, int ways_max_d, int sets_s,
        int ways_max_s, int classes, int npe, int parts, float4 lat) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tile& tile = *reinterpret_cast<Tile*>(smem);
  int4* rng = reinterpret_cast<int4*>(smem + sizeof(Tile));
  int* bits = reinterpret_cast<int*>(rng + classes);
  int* xc = bits + classes;
  __shared__ RowScan<kLoadTiles> scan;
  __shared__ int total[8];
  const Split sp(parts, lat_g, part_counts, tickets, n);
  const int v = sp.v;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Level D(tags_d_in, lru_d_in, dirty_d_in, tags_d, lru_d, dirty_d,
                (long long)v * sets_d * ways_max_d, ways_max_d, ways_d_v[v]);
  const Level S(tags_s_in, lru_s_in, dirty_s_in, tags_s, lru_s, dirty_s,
                (long long)v * sets_s * ways_max_s, ways_max_s, ways_s_v[v]);
  const int tv = t0[v];
  const int sh = class_shift(classes, kClsFlagBits);
  if (threadIdx.x < 8) total[threadIdx.x] = 0;
  for (int j = threadIdx.x; j < classes; j += kWalkThreads) {
    const long long o = (long long)v * classes + j;
    const int hd = max(min(hi_d[o], D.ways), 0);
    const int hs = max(min(hi_s[o], S.ways), 0);
    rng[j] = make_int4(max(min(lo_d[o], hd), 0), hd,
                       max(min(lo_s[o], hs), 0), hs);
    bits[j] = j << kClsFlagBits | (bypass[j] ? kByp : 0);
  }
  for (int j = threadIdx.x; j < 1 + 2 * classes; j += kWalkThreads)
    xc[j] = 0;
  const ClassCounts xcnt{xc, classes, counts, cls_hits, cls_miss, sh,
                         kClsFlagBits, kByp};
  int c[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  float lat_sum = 0.0f;
  const long long row0 = (long long)v * n;
  const int valid = stream_row(
      addr + row0, is_write + row0, n, sets_d, tile, scan,
      [&](int fill, int base, bool first) {
        __syncthreads();
        const int tb = tv + base;
        float* lat_out = sp.lat_out(tile, base);
        if (sets_d == sets_s) {
          for (int s = sp.first_set(warp); s < sets_d;
               s += sp.set_step()) {
            Row rd, rs;
            rd.load(D, s, first, lane);
            rs.load(S, s, first, lane);
            for_each_classified<true>(tile, fill, s, sh, lane,
                                      [&](int i, int a, int k) {
              const bool wr = (k & kWrite) != 0;
              int code;
              bool hit = false;
              if (k & kByp) {
                if (wr) {
                  drop(rd, rd.find(a, D.ways, lane), lane);
                  drop(rs, rs.find(a, S.ways, lane), lane);
                }
                code = bypass_counts(wr, c);
              } else {
                const int4 r = rng[class_of(k, sh)];   // under the lookups
                const int dw = rd.find(a, D.ways, lane);
                const int sw = rs.find(a, S.ways, lane);
                const bool dh = dram_step_in(rd, r.x, r.y, a, wr, tb + i,
                                             lane, c, dw);
                code = ssd_step_in(rs, r.z, r.w, a, wr, tb + i, dh, npe != 0,
                                   lane, c, sw);
                hit = sw >= 0 || (dh && !wr);
              }
              if (lane == 0) lat_out[i] = latency_of(code, lat);
              return hit;
            });
            rd.store(D, s, lane);
            rs.store(S, s, lane);
          }
        } else {
          for (int s = sp.first_set(warp); s < sets_d;
               s += sp.set_step()) {
            Row rd;
            rd.load(D, s, first, lane);
            for_each_classified<false>(tile, fill, s, sh, lane,
                                       [&](int i, int a, int k) {
              const bool wr = (k & kWrite) != 0;
              bool dh = false;
              if (!(k & kByp)) {
                const int4 r = rng[class_of(k, sh)];
                dh = dram_step_in(rd, r.x, r.y, a, wr, tb + i, lane, c,
                                  rd.find(a, D.ways, lane));
              } else if (wr) {
                drop(rd, rd.find(a, D.ways, lane), lane);
              }
              if (lane == 0) tile.lat[i] = dh ? 1.0f : 0.0f;
              return false;
            });
            rd.store(D, s, lane);
          }
          __syncthreads();
          rekey_classified(tile, fill, sets_s, sh);
          __syncthreads();
          for (int s = sp.first_set(warp); s < sets_s;
               s += sp.set_step()) {
            Row rs;
            rs.load(S, s, first, lane);
            for_each_classified<true>(tile, fill, s, sh, lane,
                                      [&](int i, int a, int k) {
              const bool wr = (k & kWrite) != 0;
              int code;
              bool hit = false;
              if (k & kByp) {
                if (wr) drop(rs, rs.find(a, S.ways, lane), lane);
                code = bypass_counts(wr, c);
              } else {
                const int4 r = rng[class_of(k, sh)];
                const bool dh = (k & kDHit) != 0;
                const int sw = rs.find(a, S.ways, lane);
                code = ssd_step_in(rs, r.z, r.w, a, wr, tb + i, dh, npe != 0,
                                   lane, c, sw);
                hit = sw >= 0 || (dh && !wr);
              }
              if (lane == 0) lat_out[i] = latency_of(code, lat);
              return hit;
            });
            rs.store(S, s, lane);
          }
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
int launch(const int* addr, const unsigned char* is_write, const int* td_in,
           const int* ld_in, const unsigned char* dd_in, const int* ts_in,
           const int* ls_in, const unsigned char* ds_in, int* td, int* ld,
           unsigned char* dd, int* ts, int* ls, unsigned char* ds,
           const int* ways_d, const int* ways_s, const int* t0, int* counts,
           float* latency, int* t_end, float* lat_g, int* part_counts,
           int* tickets, int num_vms, int n, int sets_d, int ways_max_d,
           int sets_s, int ways_max_s, int npe, int parts, float4 lat,
           cudaStream_t stream) {
  static bool configured = false;
  const cudaError_t err =
      walk_kernel_setup(two_level_kernel<Row>, configured);
  if (err != cudaSuccess) return (int)err;
  two_level_kernel<Row><<<num_vms * parts, kWalkThreads, sizeof(Tile),
                          stream>>>(
      addr, is_write, td_in, ld_in, dd_in, ts_in, ls_in, ds_in, td, ld, dd,
      ts, ls, ds, ways_d, ways_s, t0, counts, latency, t_end, lat_g,
      part_counts, tickets, n, sets_d, ways_max_d, sets_s, ways_max_s, npe,
      parts, lat);
  return (int)cudaGetLastError();
}

}  // namespace

// The input state (*_in) is read, the output state written in full. With
// parts > 1 (equal set counts only) each VM's sets are split across parts
// CTAs, with lat_g ([V, n] floats), part_counts ([V, parts, 8]) and
// tickets ([V], zeroed) as scratch; with parts == 1 these may be null.
extern "C" int etica_two_level(
    const int* addr, const unsigned char* is_write, const int* tags_d_in,
    const int* lru_d_in, const unsigned char* dirty_d_in,
    const int* tags_s_in, const int* lru_s_in,
    const unsigned char* dirty_s_in, int* tags_d, int* lru_d,
    unsigned char* dirty_d, int* tags_s, int* lru_s, unsigned char* dirty_s,
    const int* ways_d, const int* ways_s, const int* t0, int* counts,
    float* latency, int* t_end, float* lat_g, int* part_counts, int* tickets,
    int num_vms, int n, int sets_d, int ways_max_d, int sets_s,
    int ways_max_s, int npe, int parts, float t_dram, float t_ssd,
    float t_hdd, float t_hdd_write, void* stream) {
  if (num_vms <= 0) return 0;
  if (parts < 1 || (parts > 1 && sets_d != sets_s))
    return (int)cudaErrorInvalidValue;
  const int w = max(ways_max_d, ways_max_s);
  const float4 lat = make_float4(t_dram, t_ssd, t_hdd, t_hdd_write);
  auto go = [&](auto row) {
    return launch<decltype(row)>(
        addr, is_write, tags_d_in, lru_d_in, dirty_d_in, tags_s_in, lru_s_in,
        dirty_s_in, tags_d, lru_d, dirty_d, tags_s, lru_s, dirty_s, ways_d,
        ways_s, t0, counts, latency, t_end, lat_g, part_counts, tickets,
        num_vms, n, sets_d, ways_max_d, sets_s, ways_max_s, npe, parts, lat,
        (cudaStream_t)stream);
  };
  if (w <= 32) return go(RegRow<1>{});
  if (w <= 64) return go(RegRow<2>{});
  return go(MemRow{});
}

namespace {

template <class Row>
int launch_classified(const int* addr, const unsigned char* is_write,
                      const int* cls, const int* const* in, int* const* out,
                      const unsigned char* const* din, unsigned char* const* dout,
                      const int* ways_d, const int* ways_s, const int* t0,
                      const unsigned char* bypass, const int* lo_d,
                      const int* hi_d, const int* lo_s, const int* hi_s,
                      int* counts, float* latency, int* t_end, int* cls_hits,
                      int* cls_miss, float* lat_g, int* part_counts,
                      int* tickets, int num_vms, int n, int sets_d,
                      int ways_max_d, int sets_s, int ways_max_s, int classes,
                      int npe, int parts, float4 lat, cudaStream_t stream) {
  static bool configured = false;
  const cudaError_t err =
      walk_kernel_setup(two_level_classified_kernel<Row>, configured,
                        cls_smem_bytes(kMaxClasses, sizeof(int4)));
  if (err != cudaSuccess) return (int)err;
  two_level_classified_kernel<Row>
      <<<num_vms * parts, kWalkThreads,
         cls_smem_bytes(classes, sizeof(int4)), stream>>>(
          addr, is_write, cls, in[0], in[1], din[0], in[2], in[3], din[1],
          out[0], out[1], dout[0], out[2], out[3], dout[1], ways_d, ways_s,
          t0, bypass, lo_d, hi_d, lo_s, hi_s, counts, latency, t_end,
          cls_hits, cls_miss, lat_g, part_counts, tickets, n, sets_d,
          ways_max_d, sets_s, ways_max_s, classes, npe, parts, lat);
  return (int)cudaGetLastError();
}

}  // namespace

// etica_two_level with IO classes: cls [V, n] int32 (clipped to [0, C)),
// bypass [C] bytes, insertion bounds lo_*/hi_* [V, C] int32 (>= 0);
// counts [V, 9] (bypassed last), cls_hits / cls_miss [V, C]. With
// parts > 1, part_counts holds [V, parts, 9 + 2C] ints. Each level's set
// count must fit the keys: class_keys_fit(sets, class_shift(C, 3)).
extern "C" int etica_two_level_classified(
    const int* addr, const unsigned char* is_write, const int* cls,
    const int* tags_d_in, const int* lru_d_in,
    const unsigned char* dirty_d_in, const int* tags_s_in,
    const int* lru_s_in, const unsigned char* dirty_s_in, int* tags_d,
    int* lru_d, unsigned char* dirty_d, int* tags_s, int* lru_s,
    unsigned char* dirty_s, const int* ways_d, const int* ways_s,
    const int* t0, const unsigned char* bypass, const int* lo_d,
    const int* hi_d, const int* lo_s, const int* hi_s, int* counts,
    float* latency, int* t_end, int* cls_hits, int* cls_miss, float* lat_g,
    int* part_counts, int* tickets, int num_vms, int n, int sets_d,
    int ways_max_d, int sets_s, int ways_max_s, int classes, int npe,
    int parts, float t_dram, float t_ssd, float t_hdd, float t_hdd_write,
    void* stream) {
  if (num_vms <= 0) return 0;
  if (parts < 1 || (parts > 1 && sets_d != sets_s) || classes < 1 ||
      classes > kMaxClasses ||
      !class_keys_fit(max(sets_d, sets_s),
                      class_shift(classes, kClsFlagBits)))
    return (int)cudaErrorInvalidValue;
  const int w = max(ways_max_d, ways_max_s);
  const float4 lat = make_float4(t_dram, t_ssd, t_hdd, t_hdd_write);
  const int* in[4] = {tags_d_in, lru_d_in, tags_s_in, lru_s_in};
  int* out[4] = {tags_d, lru_d, tags_s, lru_s};
  const unsigned char* din[2] = {dirty_d_in, dirty_s_in};
  unsigned char* dout[2] = {dirty_d, dirty_s};
  auto go = [&](auto row) {
    return launch_classified<decltype(row)>(
        addr, is_write, cls, in, out, din, dout, ways_d, ways_s, t0, bypass,
        lo_d, hi_d, lo_s, hi_s, counts, latency, t_end, cls_hits, cls_miss,
        lat_g, part_counts, tickets, num_vms, n, sets_d, ways_max_d, sets_s,
        ways_max_s, classes, npe, parts, lat, (cudaStream_t)stream);
  };
  if (w <= 32) return go(RegRow<1>{});
  if (w <= 64) return go(RegRow<2>{});
  return go(MemRow{});
}
