// set_walk: the datapath kernels' schedule (datapath.cu, single_level.cu):
// one CTA per VM walks each cache set's requests in order, with the sets
// in parallel across its warps.
//
// Why it is exact: request k of a VM reads and writes only the rows of its
// own set at each level (a % S), and its clock is t0 + (valid requests
// before k). So requests to different sets commute, and only those to one
// set must run in order. The integer counts are sums; latency_sum is the
// one output whose order matters, so the walk records each request's
// latency at its rank and one warp adds them in request order afterwards.
//
// The schedule, per VM (row of the [V, N] block):
//   1. stream: the CTA loads kLoadCols columns a step (coalesced, the
//      next step's loads in flight while this one is ranked), drops addr
//      < 0 with a flag scan (RowScan) and stores each kept request at its
//      rank in shared memory: its address, and key = set << 2 | flags.
//      The rank i gives the clock, t = t0 + base + i.
//   2. walk: when the next step would overflow the tile (kTileCap
//      requests, 12 bytes each), and once at the end, warp w takes sets
//      w, w + warps, ...: it loads the set row (RegRow: ceil(W / 32) ways a
//      lane in registers; MemRow: rows wider than 64 ways, in the output
//      arrays), scans the tile 32 keys at a time, picks the set's
//      requests by __ballot_sync and applies them in order through __ffs
//      of the ballot (the next one's address and key fetched before this
//      one is applied), then stores the row. Lookups and the victim are
//      warp reductions (__reduce_min_sync on the way, or on the score and
//      then the way among the lanes holding the minimum), so "first
//      empty active way, else first LRU minimum" keeps the reference's
//      order. The kernel reads the input state and writes every row of
//      the output once per tile, each row by exactly one warp.
//   3. sum: each request's float32 latency is stored at its rank; one
//      warp adds the tile's in request order with __fadd_rn, carrying the
//      sum across tiles.
//
// While the VMs leave SMs idle (V below the SM count), a VM's sets are
// split across `parts` CTAs (Split): CTA p walks sets p, p + parts, ...,
// so each warp holds about one set. Every CTA streams the whole row; each
// writes its requests' latencies (at their ranks) and its counts to
// global scratch, and the VM's last CTA to finish (an atomic ticket)
// adds the counts and, in request order, the latencies.
//
// What bounds it: the longest same-set chain (its requests one after
// another, a few warp reductions each), the scan of the tile (one pass a
// set) and the ordered sum (one dependent add a request); at many VMs,
// reading the padded block.
//
// The classified walks (datapath.cu, single_level.cu, the IO classifier's
// routes) resolve each request's class in the stream step, not on the
// chain: ClassSide folds the class id and what the walk branches on (its
// bypass bit and, at one level, its policy flags) into the key's low bits,
// key = set << sh | class << F | flags, from a per-VM table in shared
// memory. Their chain (for_each_classified) takes the key by a reduction,
// so it lands in a uniform register and every branch on it is uniform; a
// request that does not bypass loads its class's way range from the table
// under its lookups. The per-class counts stay off the chain: in a tile's
// last walk the lane holding a request's key keeps its outcome in a
// register, the warp stores its set's outcomes in their address slots
// once per 32 keys, and behind the walk's barrier ClassCounts::add_tile
// counts the tile's outcomes by class, one shared add per distinct
// (class, outcome) a warp (__match_any_sync).
//
// Tried on the H100 and dropped, each slower at the paper's [12, 1000]
// block: lookups by __ballot_sync (a reduction's result lands in a
// uniform register and the branches on it stay uniform; a ballot's does
// not), every request's victims computed without branches, a packed
// (score, way) victim in one reduction, and a 128-key scan step with a
// queue of matches. Latency codes of one byte, decoded in the sum, put
// the decode's latency in front of every add. For the classified walks:
// a shared atomic a request for the class counts, the class id as a byte
// by rank fetched with a shuffle, the class's table entry loaded a
// request ahead (its load waits on the key's reduction at once), and
// lane 0 storing each outcome on the chain.
#pragma once

#include <climits>
#include <cuda_runtime.h>

#include "row_scan.cuh"

namespace etica {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWalkThreads = kRowThreads;             // 16 warps
constexpr int kWalkWarps = kWalkThreads / 32;
constexpr int kLoadTiles = 4;                         // RowScan tiles a step
constexpr int kLoadCols = kLoadTiles * kWalkThreads;  // columns a step
constexpr int kTileCap = 8192;                        // requests a walk
constexpr int kSumStep = 16;                          // adds a sum load

// The compacted requests of one tile, in dynamic shared memory.
struct Tile {
  int addr[kTileCap];
  int key[kTileCap];                // set << 2 | flags
  float lat[kTileCap + kSumStep];   // latency by rank; +0.0f past the fill
};
constexpr int kMaxClasses = 256;   // class ids of a classified walk

// the flags of a key: the request writes; its DRAM lookup hit (set by
// rekey for the two-level walk's second level)
constexpr int kWrite = 1;
constexpr int kDHit = 2;

// One level of a VM's cache state: its input rows, its output rows, and
// the ways in use.
struct Level {
  const int* tag_in;
  const int* lru_in;
  const unsigned char* dirty_in;
  int* tag;
  int* lru;
  unsigned char* dirty;
  int num_ways;   // W, the row's width
  int ways;       // active ways, clamped to [0, W]

  __device__ Level(const int* ti, const int* li, const unsigned char* di,
                   int* to, int* lo, unsigned char* dout, long long vm_off,
                   int w, int active)
      : tag_in(ti + vm_off), lru_in(li + vm_off), dirty_in(di + vm_off),
        tag(to + vm_off), lru(lo + vm_off), dirty(dout + vm_off),
        num_ways(w), ways(min(max(active, 0), w)) {}
};

template <int K>
__device__ __forceinline__ int pick(const int (&x)[K], int k) {
  int out = x[0];
#pragma unroll
  for (int j = 1; j < K; ++j)
    if (j == k) out = x[j];
  return out;
}

// A set row held by one warp in registers: way w = lane + 32 k sits in
// lane w % 32, slot k, for rows of up to 32 K ways.
template <int K>
struct RegRow {
  int tag[K], lru[K], dirty[K];

  // the row of set s: the input state in a VM's first tile, else what the
  // previous tile stored
  __device__ __forceinline__ void load(const Level& L, int s, bool first,
                                       int lane) {
    const long long off = (long long)s * L.num_ways;
    const int* t = (first ? L.tag_in : L.tag) + off;
    const int* l = (first ? L.lru_in : L.lru) + off;
    const unsigned char* d = (first ? L.dirty_in : L.dirty) + off;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int w = lane + 32 * k;
      const bool in = w < L.num_ways;
      tag[k] = in ? t[w] : -1;
      lru[k] = in ? l[w] : 0;
      dirty[k] = in && d[w] != 0;
    }
  }

  __device__ __forceinline__ void store(const Level& L, int s,
                                        int lane) const {
    const long long off = (long long)s * L.num_ways;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int w = lane + 32 * k;
      if (w < L.num_ways) {
        L.tag[off + w] = tag[k];
        L.lru[off + w] = lru[k];
        L.dirty[off + w] = (unsigned char)dirty[k];
      }
    }
  }

  // first active way (w < ways) holding a; -1 when none
  __device__ __forceinline__ int find(int a, int ways, int lane) const {
    int best = INT_MAX;
#pragma unroll
    for (int k = K - 1; k >= 0; --k)
      if (lane + 32 * k < ways && tag[k] == a) best = lane + 32 * k;
    best = __reduce_min_sync(kFull, best);
    return best == INT_MAX ? -1 : best;
  }

  // the insert way (ways > 0): first minimum over the active ways of
  // score = -1 for an empty way, else lru
  __device__ __forceinline__ int victim(int ways, int lane) const {
    int bs = INT_MAX, bw = INT_MAX;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int w = lane + 32 * k;
      const int sc = tag[k] < 0 ? -1 : lru[k];
      if (w < ways && (bw == INT_MAX || sc < bs)) {
        bs = sc;
        bw = w;
      }
    }
    const int m = __reduce_min_sync(kFull, bs);
    return __reduce_min_sync(kFull, bs == m ? bw : INT_MAX);
  }

  // victim over the ways [lo, hi) (a class's insertion range, lo < hi):
  // w is in it when w - lo, unsigned, is below hi - lo
  __device__ __forceinline__ int victim_in(int lo, int hi, int lane) const {
    int bs = INT_MAX, bw = INT_MAX;
    const unsigned off = (unsigned)(lane - lo), span = (unsigned)(hi - lo);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int w = lane + 32 * k;
      const int sc = tag[k] < 0 ? -1 : lru[k];
      if (off + 32u * k < span && (bw == INT_MAX || sc < bs)) {
        bs = sc;
        bw = w;
      }
    }
    const int m = __reduce_min_sync(kFull, bs);
    return __reduce_min_sync(kFull, bs == m ? bw : INT_MAX);
  }

  // (tag >= 0 and dirty) of way w
  __device__ __forceinline__ bool dirty_valid(int w) const {
    const int k = w >> 5;
    const int x = pick(tag, k) >= 0 && pick(dirty, k) != 0;
    return __shfl_sync(kFull, x, w & 31) != 0;
  }

  __device__ __forceinline__ void put(int w, int lane, int t, int l, bool d) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (lane + 32 * k == w) {
        tag[k] = t;
        lru[k] = l;
        dirty[k] = d;
      }
  }

  __device__ __forceinline__ void touch(int w, int lane, int t,
                                        bool set_dirty) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (lane + 32 * k == w) {
        lru[k] = t;
        dirty[k] |= set_dirty;
      }
  }
};

// A set row of any width, held in the output arrays (global memory, the
// touched rows stay in L1): lanes stride the ways, lane 0 writes, and
// __syncwarp orders a write after the warp's reads and before its next.
struct MemRow {
  int* tag;
  int* lru;
  unsigned char* dirty;

  __device__ __forceinline__ void load(const Level& L, int s, bool first,
                                       int lane) {
    const long long off = (long long)s * L.num_ways;
    tag = L.tag + off;
    lru = L.lru + off;
    dirty = L.dirty + off;
    if (first) {
      for (int w = lane; w < L.num_ways; w += 32) {
        tag[w] = L.tag_in[off + w];
        lru[w] = L.lru_in[off + w];
        dirty[w] = L.dirty_in[off + w];
      }
    }
    __syncwarp();
  }

  __device__ __forceinline__ void store(const Level&, int, int) const {
    __syncwarp();
  }

  __device__ __forceinline__ int find(int a, int ways, int lane) const {
    int best = INT_MAX;
    for (int w = lane; w < ways; w += 32)
      if (tag[w] == a) {
        best = w;
        break;
      }
    best = __reduce_min_sync(kFull, best);
    return best == INT_MAX ? -1 : best;
  }

  __device__ __forceinline__ int victim(int ways, int lane) const {
    int bs = INT_MAX, bw = INT_MAX;
    for (int w = lane; w < ways; w += 32) {
      const int sc = tag[w] < 0 ? -1 : lru[w];
      if (bw == INT_MAX || sc < bs) {
        bs = sc;
        bw = w;
      }
    }
    const int m = __reduce_min_sync(kFull, bs);
    return __reduce_min_sync(kFull, bs == m ? bw : INT_MAX);
  }

  __device__ __forceinline__ int victim_in(int lo, int hi, int lane) const {
    int bs = INT_MAX, bw = INT_MAX;
    for (int w = lo + lane; w < hi; w += 32) {
      const int sc = tag[w] < 0 ? -1 : lru[w];
      if (bw == INT_MAX || sc < bs) {
        bs = sc;
        bw = w;
      }
    }
    const int m = __reduce_min_sync(kFull, bs);
    return __reduce_min_sync(kFull, bs == m ? bw : INT_MAX);
  }

  __device__ __forceinline__ bool dirty_valid(int w) const {
    return tag[w] >= 0 && dirty[w] != 0;
  }

  __device__ __forceinline__ void put(int w, int lane, int t, int l, bool d) {
    __syncwarp();
    if (lane == 0) {
      tag[w] = t;
      lru[w] = l;
      dirty[w] = d;
    }
    __syncwarp();
  }

  __device__ __forceinline__ void touch(int w, int lane, int t,
                                        bool set_dirty) {
    __syncwarp();
    if (lane == 0) {
      lru[w] = t;
      if (set_dirty) dirty[w] = 1;
    }
    __syncwarp();
  }
};

// Applies f(i, addr, flags) to the tile's requests of set s, in order:
// the warp tests 32 keys at a time and takes the matches by __ffs, with
// the next match's address and key fetched before f runs.
template <class F>
__device__ __forceinline__ void for_each_request(const Tile& tile, int fill,
                                                 int s, int lane, F&& f) {
  for (int b = 0; b < fill; b += 32) {
    const int i = b + lane;
    const int key = i < fill ? tile.key[i] : -1;
    unsigned m = __ballot_sync(kFull, key >= 0 && (key >> 2) == s);
    if (!m) continue;
    int j = __ffs(m) - 1;
    int a = tile.addr[b + j], k = __shfl_sync(kFull, key, j);
    for (;;) {
      m &= m - 1;
      const int jn = m ? __ffs(m) - 1 : j;
      const int an = tile.addr[b + jn], kn = __shfl_sync(kFull, key, jn);
      f(b + j, a, k & 3);
      if (!m) break;
      j = jn;
      a = an;
      k = kn;
    }
  }
}

// for_each_request for a classified walk, whose keys carry the class and
// its flags below bit sh (ClassSide): f(i, addr, key) returns whether the
// request was a served hit. The key comes to the warp by a reduction
// (__reduce_or_sync) rather than a shuffle: its result lands in a uniform
// register, so the walk's branches on the key's flags and its class's
// table loads stay uniform. With kRecord (a tile's last walk) the lane
// that holds a request's key keeps its outcome in a register, and after
// the 32 keys' requests the warp stores the outcomes of its set's
// requests in one store, in their address slots: -1 - hit, negative
// where every address is not (read by ClassCounts::add_tile). No store
// on the chain.
template <bool kRecord, class F>
__device__ __forceinline__ void for_each_classified(Tile& tile, int fill,
                                                    int s, int sh, int lane,
                                                    F&& f) {
  for (int b = 0; b < fill; b += 32) {
    const int i = b + lane;
    const int key = i < fill ? tile.key[i] : -1;
    unsigned m = __ballot_sync(kFull, key >= 0 && (key >> sh) == s);
    if (!m) continue;
    const unsigned mine = m;
    int j = __ffs(m) - 1;
    int a = tile.addr[b + j];
    int k = (int)__reduce_or_sync(kFull, lane == j ? (unsigned)key : 0u);
    int out = 0;
    for (;;) {
      m &= m - 1;
      const int jn = m ? __ffs(m) - 1 : j;
      const int an = tile.addr[b + jn];
      const int kn =
          (int)__reduce_or_sync(kFull, lane == jn ? (unsigned)key : 0u);
      const bool hit = f(b + j, a, k);
      if (kRecord && lane == j) out = hit;
      if (!m) break;
      j = jn;
      a = an;
      k = kn;
    }
    if (kRecord && (mine >> lane & 1u)) tile.addr[i] = -1 - out;
  }
}

// The bits below the set of a classified key with C classes and F flag
// bits: F, then enough for the class ids [0, C). A launch's set counts
// must fit above them (set << sh stays a non-negative int).
__host__ __device__ constexpr int class_shift(int classes, int flag_bits) {
  int b = 0;
  while ((1 << b) < classes) ++b;
  return flag_bits + b;
}
__host__ __device__ constexpr bool class_keys_fit(int sets, int sh) {
  return sets >= 0 && sets <= (1 << (31 - sh));
}

// Re-keys the tile's requests by another set count, with the DRAM hit
// that the first walk left in each latency slot (the two-level walk's
// second level when the levels' set counts differ).
__device__ __forceinline__ void rekey(Tile& tile, int fill, int sets) {
  for (int i = threadIdx.x; i < fill; i += kWalkThreads)
    tile.key[i] = (tile.addr[i] % sets) << 2 |
                  (tile.lat[i] != 0.0f ? kDHit : 0) | (tile.key[i] & kWrite);
}

// rekey for a classified walk: the class and its flags kept below bit sh.
__device__ __forceinline__ void rekey_classified(Tile& tile, int fill,
                                                 int sets, int sh) {
  const int low = (1 << sh) - 1;
  for (int i = threadIdx.x; i < fill; i += kWalkThreads)
    tile.key[i] = (tile.addr[i] % sets) << sh |
                  (tile.lat[i] != 0.0f ? kDHit : 0) | (tile.key[i] & low);
}

__device__ __forceinline__ float latency_of(int code, float4 lat) {
  return code == 0 ? lat.x : code == 1 ? lat.y : code == 2 ? lat.z : lat.w;
}

// acc plus lat[0, m) added in order with __fadd_rn. lat[m, the next
// multiple of kSumStep) are +0.0f, which adds exactly (acc >= +0.0f), so
// each step adds kSumStep values without a branch, loaded a step ahead of
// their adds. A whole warp runs it, every lane the same adds.
__device__ __forceinline__ float ordered_sum(const float* lat, int m,
                                             float acc) {
  const float4* q = reinterpret_cast<const float4*>(lat);
  const int steps = (m + kSumStep - 1) / kSumStep;
  float4 nxt[kSumStep / 4];
#pragma unroll
  for (int u = 0; u < kSumStep / 4; ++u)
    nxt[u] = steps > 0 ? q[u] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = 0; i < steps; ++i) {
    float4 cur[kSumStep / 4];
#pragma unroll
    for (int u = 0; u < kSumStep / 4; ++u) {
      cur[u] = nxt[u];
      if (i + 1 < steps) nxt[u] = q[(i + 1) * (kSumStep / 4) + u];
    }
#pragma unroll
    for (int u = 0; u < kSumStep / 4; ++u) {
      acc = __fadd_rn(acc, cur[u].x);
      acc = __fadd_rn(acc, cur[u].y);
      acc = __fadd_rn(acc, cur[u].z);
      acc = __fadd_rn(acc, cur[u].w);
    }
  }
  return acc;
}

// How a VM's sets are split across CTAs: blockIdx.x = v * parts + part;
// CTA `part` walks sets part, part + parts, ... With parts > 1 its
// latencies go to the VM's row of global scratch (by rank) and its counts
// to part_counts; tickets[v] is zero before the launch.
struct Split {
  int v, part, parts;
  float* lat_row;
  int* part_counts;
  int* tickets;

  __device__ Split(int parts_, float* lat_g, int* part_counts_,
                   int* tickets_, int n)
      : v(blockIdx.x / parts_), part(blockIdx.x % parts_), parts(parts_),
        lat_row(parts_ > 1 ? lat_g + (long long)(blockIdx.x / parts_) * n
                           : nullptr),
        part_counts(part_counts_), tickets(tickets_) {}

  __device__ int first_set(int warp) const { return part + parts * warp; }
  __device__ int set_step() const { return parts * kWalkWarps; }
  // where a tile's latencies go: the tile itself, or the VM's scratch row
  __device__ float* lat_out(Tile& tile, int base) const {
    return parts > 1 ? lat_row + base : tile.lat;
  }
};

// Each kept request's key: set << 2 | write (NoSide), or a classified
// walk's (ClassSide): set << sh | class << F | flags | write, the class id
// clipped to [0, C) and its bits (class << F | its flags) taken from the
// VM's table in shared memory, which must be complete before the first
// key (stream_row's first bases() is a barrier).
struct NoSide {
  __device__ __forceinline__ int key(int set, bool w, int) const {
    return set << 2 | (w ? kWrite : 0);
  }
};

struct ClassSide {
  const int* cls;        // the VM's row of class ids
  const int* bits;       // shared: class c's key bits
  int top;               // C - 1
  int sh;                // class_shift

  __device__ __forceinline__ int key(int set, bool w, int col) const {
    return set << sh | bits[min(max(__ldg(cls + col), 0), top)] |
           (w ? kWrite : 0);
  }
};

// The VM's row of requests streamed through the tile (step 1 above).
// walk(fill, base, first) runs with the tile's fill requests (latency
// slots +0.0f from fill to the next kSumStep), base valid requests before
// them, and first set for the VM's first tile; it runs whenever the next
// step would overflow the tile and once at the end, and must begin with
// __syncthreads() and end with one after its last read of the tile's
// addresses and keys. Returns the valid requests.
template <class Walk, class Side = NoSide>
__device__ __forceinline__ int stream_row(const int* __restrict__ addr,
                                          const unsigned char* __restrict__ wr,
                                          int n, int sets, Tile& tile,
                                          RowScan<kLoadTiles>& scan,
                                          Walk&& walk, Side side = Side{}) {
  int a_nxt[kLoadTiles];
  bool w_nxt[kLoadTiles];
  auto load = [&](int c0) {
#pragma unroll
    for (int r = 0; r < kLoadTiles; ++r) {
      const int col = c0 + r * kWalkThreads + threadIdx.x;
      a_nxt[r] = col < n ? __ldg(addr + col) : -1;
      w_nxt[r] = col < n && __ldg(wr + col) != 0;
    }
  };
  load(0);
  int fill = 0, base = 0;
  bool first = true;
  for (int c0 = 0;; c0 += kLoadCols) {
    const bool more = c0 < n;
    int a[kLoadTiles];
    bool w[kLoadTiles];
#pragma unroll
    for (int r = 0; r < kLoadTiles; ++r) {
      a[r] = a_nxt[r];
      w[r] = w_nxt[r];
    }
    int cnt = 0;
    if (more) {
      if (c0 + kLoadCols < n) load(c0 + kLoadCols);
#pragma unroll
      for (int r = 0; r < kLoadTiles; ++r) scan.count(r, a[r] >= 0);
      cnt = scan.bases(kLoadTiles);
    }
    if (!more || fill + cnt > kTileCap) {
      if (threadIdx.x < kSumStep) tile.lat[fill + threadIdx.x] = 0.0f;
      walk(fill, base, first);
      base += fill;
      fill = 0;
      first = false;
    }
    if (!more) break;
#pragma unroll
    for (int r = 0; r < kLoadTiles; ++r) {
      const int i = fill + scan.rank(r, a[r] >= 0);
      if (a[r] >= 0) {
        tile.addr[i] = a[r];
        tile.key[i] = side.key(a[r] % sets, w[r],
                               c0 + r * kWalkThreads + threadIdx.x);
      }
    }
    fill += cnt;
  }
  return base;
}

// The counts a walk keeps beyond the eight: none (NoCounts), or the
// classified walks' bypassed requests and per-class served hits and
// misses (ClassCounts), n() ints in shared memory. Their code in finish is
// compiled only for the classified walks (if constexpr), so the
// unclassified walks' code is as it was.
struct NoCounts {
  static constexpr int kCounts = 8;   // ints a VM's row of `counts`
  static constexpr bool kClassified = false;
};

struct ClassCounts {
  static constexpr int kCounts = 9;   // the eight, then bypassed
  // also: the last CTA puts its VM's ticket back to 0, so the tickets
  // are zeroed once (datapath ops, _tickets), not before every launch
  static constexpr bool kClassified = true;
  int* x;            // shared: [0] bypassed, [1, 1 + C) hits, then misses
  int classes;
  int* counts;       // [V, 9]
  int* hits;         // [V, C]
  int* miss;         // [V, C]
  int sh, flag_bits, bypass_bit;   // the keys' layout (ClassSide)

  __device__ __forceinline__ int n() const { return 1 + 2 * classes; }
  __device__ __forceinline__ int value(int j) const { return x[j]; }
  __device__ __forceinline__ void out(long long v, int j, int val) const {
    if (j == 0)
      counts[v * kCounts + 8] = val;
    else if (j <= classes)
      hits[v * classes + j - 1] = val;
    else
      miss[v * classes + j - 1 - classes] = val;
  }

  // The outcomes of a tile's last walk, which left -1 - hit in the
  // address slot of each request it walked (for_each_classified): each of
  // those (the requests of this CTA's sets) adds one to bypassed, or to
  // its class's hits or misses. Runs on the whole CTA between two
  // barriers; a warp adds each distinct counter it holds once.
  __device__ __forceinline__ void add_tile(const Tile& tile, int fill) const {
    const int lane = threadIdx.x & 31;
    const int cmask = (1 << (sh - flag_bits)) - 1;
    for (int b = threadIdx.x - lane; b < fill; b += kWalkThreads) {
      const int i = b + lane;
      const int o = i < fill ? tile.addr[i] : 0;
      int j = -1;
      if (o < 0) {
        const int key = tile.key[i];
        const int c = (key >> flag_bits) & cmask;
        j = (key & bypass_bit) ? 0 : o == -2 ? 1 + c : 1 + classes + c;
      }
      const unsigned peers = __match_any_sync(kFull, j);
      if (j >= 0 && lane == __ffs(peers) - 1) atomicAdd(&x[j], __popc(peers));
    }
  }
};

// The VM's results: its counts (each warp's, equal in every lane, added
// into `total`, and the extra counts `xc`), latency sum and clock. With
// parts > 1 each CTA leaves its counts in part_counts (8 + xc.n() ints a
// part), and the VM's last CTA adds all of them and the latencies of its
// scratch row, in request order, through the tile.
template <class X = NoCounts>
__device__ __forceinline__ void finish(const int (&c)[8], int* total,
                                       const Split& sp, Tile& tile,
                                       int* counts, float* latency,
                                       int* t_end, float lat_sum, int valid,
                                       int t_last, const X& xc = X{}) {
  __shared__ bool last;
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int k = 0; k < 8; ++k) atomicAdd(&total[k], c[k]);
  __syncthreads();
  const long long v = sp.v;
  if (sp.parts == 1) {
    if (threadIdx.x < 8)
      counts[v * X::kCounts + threadIdx.x] = total[threadIdx.x];
    if constexpr (X::kClassified)
      for (int j = threadIdx.x; j < xc.n(); j += kWalkThreads)
        xc.out(v, j, xc.value(j));
    if (threadIdx.x == 0) {
      latency[v] = lat_sum;
      t_end[v] = t_last;
    }
    return;
  }
  int stride = 8;
  if constexpr (X::kClassified) stride += xc.n();
  if (threadIdx.x < 8)
    sp.part_counts[(v * sp.parts + sp.part) * stride + threadIdx.x] =
        total[threadIdx.x];
  if constexpr (X::kClassified)
    for (int j = threadIdx.x; j < xc.n(); j += kWalkThreads)
      sp.part_counts[(v * sp.parts + sp.part) * stride + 8 + j] =
          xc.value(j);
  __threadfence();   // this CTA's latencies and counts before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&sp.tickets[v], 1) == sp.parts - 1;
  __syncthreads();
  if (!last) return;
  if constexpr (X::kClassified)
    if (threadIdx.x == 0) sp.tickets[v] = 0;
  __threadfence();
  if (threadIdx.x < 8) {
    int sum = 0;
    for (int p = 0; p < sp.parts; ++p)
      sum += __ldcg(&sp.part_counts[(v * sp.parts + p) * stride +
                                    threadIdx.x]);
    counts[v * X::kCounts + threadIdx.x] = sum;
  }
  if constexpr (X::kClassified)
    for (int j = threadIdx.x; j < xc.n(); j += kWalkThreads) {
      int sum = 0;
      for (int p = 0; p < sp.parts; ++p)
        sum += __ldcg(&sp.part_counts[(v * sp.parts + p) * stride + 8 + j]);
      xc.out(v, j, sum);
    }
  float acc = 0.0f;
  for (int c0 = 0; c0 < valid; c0 += kTileCap) {
    const int m = min(kTileCap, valid - c0);
    for (int i = threadIdx.x; i < m + kSumStep; i += kWalkThreads)
      tile.lat[i] = i < m ? __ldcg(sp.lat_row + c0 + i) : 0.0f;
    __syncthreads();
    if ((threadIdx.x >> 5) == 0) acc = ordered_sum(tile.lat, m, acc);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    latency[v] = acc;
    t_end[v] = t_last;
  }
}

// Dynamic shared memory of a classified walk with C classes: the Tile,
// then its way-range table (range_bytes a class), the classes' key bits
// (an int a class) and the ClassCounts.
__host__ __device__ constexpr int cls_smem_bytes(int classes,
                                                 int range_bytes) {
  return (int)sizeof(Tile) + (range_bytes + 4) * classes +
         (1 + 2 * classes) * 4;
}

// Opts `kernel` into a tile of dynamic shared memory, once (before any
// graph capture: the first launch of each instantiation does it).
template <typename Kernel>
inline cudaError_t walk_kernel_setup(Kernel kernel, bool& configured,
                                     int bytes = (int)sizeof(Tile)) {
  if (configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) configured = true;
  return err;
}

}  // namespace etica
