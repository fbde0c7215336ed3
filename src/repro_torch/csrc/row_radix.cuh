// row_radix: the tiled route of the row kernels (popularity, run_sums) for
// rows wider than one CTA sorts in shared memory (kMaxRow entries,
// row_sort.cuh). It takes rows of any width, spreads every row over the
// whole card, and keeps the reference's order: a stable LSD radix sort of
// the (key, value) pairs across the grid, then each run of equal keys
// added left to right.
//
//  0. One memset of the scratch words (histograms, lengths, tickets,
//     look-back status) on the stream.
//  1. Prep (the kernels' own prep kernels): one CTA a tile of kTile
//     positions. It writes the tile's pairs (key << 32 | value) to buffer
//     0 at their own positions, counts the digits of every pass in shared
//     memory (count_digit: one atomic a warp where the warp's digits are
//     all one, as a constant digit is, else one a lane) and adds the
//     counts to the row's histograms; it writes the row's sorted length
//     and kept count.
//  2. Passes (radix_pass_kernel), one launch each, kDigitBits a pass from
//     the least significant digit, the count fixed on the host from the
//     key width. A CTA takes the next tile from an atomic ticket (so every
//     tile it waits for has started). A pass whose digit is the same for
//     every key of a row (a bin of the row's histogram holds all its
//     keys) is a no-op for that row: its CTAs leave at once, and the
//     row's pairs stay in the buffer they are in; which buffer holds a
//     row's result follows on the device from the histograms (the parity
//     of the row's active passes), never on the host. An active pass
//     loads the tile, ranks each pair among the tile's pairs of its digit
//     in access order (a warp ranks its items one 32-position slice at a
//     time with __match_any_sync; the warps' counts are then scanned
//     digit by digit), publishes the tile's 256 digit counts and finds
//     the counts of the row's earlier tiles by a decoupled look-back (a
//     thread a digit, reading kLookBack earlier tiles' status words at
//     once), and scatters each pair to: the row's pairs of smaller digits
//     (the exclusive scan of the histogram) + the earlier tiles' pairs of
//     its digit + its rank. Equal keys keep access order, pass after pass.
//  3. Runs (the kernels' own run kernels): one CTA a tile of the sorted
//     row; a pair that starts a run (its key differs from the one before)
//     is a head. A head whose run ends within kLongRun pairs adds it
//     itself, its loads issued together; a longer run is queued to the
//     CTA's warps: the warp loads kStage pairs at a time, coalesced, finds
//     where the run ends by ballots, stages the values in shared memory,
//     and lane 0 adds them left to right while the next chunk's loads are
//     in flight, so the chain is the adds alone. No run is split.
//
// No global memory is searched per element, every tile of a pass runs at
// once (a row of 16,385 entries is 33 tiles), and the launch count is
// fixed by the shapes: one memset, one prep, the passes, one run kernel.
// Scratch: two [rows, n] pair buffers and the words of radix_words().
#pragma once

#include <cuda_runtime.h>

#include "row_sort.cuh"

namespace etica {

constexpr int kRadixThreads = 256;
constexpr int kRadixWarps = kRadixThreads / 32;
constexpr int kRadixItems = 2;                  // positions a thread a tile
constexpr int kTile = kRadixThreads * kRadixItems;   // 512
constexpr int kDigitBits = 8;
constexpr int kRadix = 1 << kDigitBits;
constexpr int kMaxPasses = 32 / kDigitBits;
constexpr int kLookBack = 16;      // earlier tiles read at once a step
constexpr int kLongRun = 32;       // a longer run is added by a warp
constexpr int kStagePer = 16;      // pairs a lane stages a chunk
constexpr int kStage = 32 * kStagePer;          // 512 values a chunk

// look-back status: flag in the top two bits, a count below
constexpr unsigned kFlagAggregate = 1u << 30;
constexpr unsigned kFlagInclusive = 2u << 30;
constexpr unsigned kCountMask = kFlagAggregate - 1u;
static_assert(kRadixThreads == kRadix, "a thread a digit");

__host__ __device__ constexpr int radix_tiles(int n) {
  return (n + kTile - 1) / kTile;
}


// The int32 scratch words of [rows, n] rows sorted in `passes` passes, in
// this order: hist [rows][kMaxPasses][kRadix], len [rows], kept [rows],
// tickets [kMaxPasses + 1], pass status [passes][rows * tiles][kRadix],
// run status [rows * tiles]. All zeroed on the stream before a call.
struct RadixWords {
  int* hist;
  int* len;
  int* kept;
  int* ticket;
  unsigned* status;
  unsigned* run_status;
};

__host__ __device__ constexpr long long radix_words(int rows, int n,
                                                    int passes) {
  const long long tiles = (long long)rows * radix_tiles(n);
  return (long long)rows * (kMaxPasses * kRadix + 2) + kMaxPasses + 1 +
         tiles * (passes * kRadix + 1);
}

__host__ __device__ inline RadixWords radix_layout(int* w, int rows, int n,
                                                  int passes) {
  const long long tiles = (long long)rows * radix_tiles(n);
  RadixWords r;
  r.hist = w;
  r.len = r.hist + (long long)rows * kMaxPasses * kRadix;
  r.kept = r.len + rows;
  r.ticket = r.kept + rows;
  r.status = (unsigned*)(r.ticket + kMaxPasses + 1);
  r.run_status = r.status + tiles * passes * kRadix;
  return r;
}

// passes of keys below 2^bits
__host__ __device__ constexpr int radix_passes(int bits) {
  return bits <= kDigitBits ? 1 : (bits + kDigitBits - 1) / kDigitBits;
}

__device__ __forceinline__ unsigned digit_of(unsigned key, int pass) {
  return (key >> (pass * kDigitBits)) & (kRadix - 1);
}

// Counts `d` (valid where `in`) into the shared histogram `count`: one
// atomic for the warp where all 32 lanes hold the same digit, else one a
// lane. Every lane of the warp calls it.
__device__ __forceinline__ void count_digit(int* count, unsigned d,
                                            bool in) {
  const unsigned d0 = __shfl_sync(0xffffffffu, d, 0);
  if (__all_sync(0xffffffffu, in && d == d0)) {
    if ((threadIdx.x & 31) == 0) atomicAdd(&count[d0], 32);
  } else if (in) {
    atomicAdd(&count[d], 1);
  }
}

__device__ __forceinline__ unsigned lanemask_lt() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// Exclusive scan of one value a thread over the CTA's kRadixThreads
// threads, in thread order; `total` gets the sum. Synchronises.
__device__ __forceinline__ unsigned block_exclusive_scan(unsigned x,
                                                         unsigned* warp_sums,
                                                         unsigned& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  __syncthreads();
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  unsigned before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kRadixWarps; ++w) {
    const unsigned s = warp_sums[w];
    if (w < warp) before += s;
    total += s;
  }
  return before + incl - x;
}

// The CTA's next tile in ticket order: (row, tile) of `tiles` a row.
__device__ __forceinline__ void take_ticket(int* ticket, int tiles,
                                            int& row, int& tile) {
  __shared__ int t;
  if (threadIdx.x == 0) t = atomicAdd(ticket, 1);
  __syncthreads();
  row = t / tiles;
  tile = t - row * tiles;
}

// The row's passes up to `upto` (excluded) that move its pairs, as a bit
// mask: pass q is a no-op when one bin of its histogram holds all `len`
// keys. Every thread of the CTA calls it (one bin a thread).
__device__ __forceinline__ unsigned active_passes(const int* hist_row,
                                                  int len, int upto) {
  int h[kMaxPasses];
#pragma unroll
  for (int q = 0; q < kMaxPasses; ++q)     // the loads in flight together
    h[q] = q < upto ? hist_row[q * kRadix + threadIdx.x] : 0;
  unsigned mask = 0;
#pragma unroll
  for (int q = 0; q < kMaxPasses; ++q)
    if (q < upto && !__syncthreads_or(h[q] == len)) mask |= 1u << q;
  return mask;
}

__device__ __forceinline__ unsigned load_status(const unsigned* p) {
  return *(const volatile unsigned*)p;
}
__device__ __forceinline__ void store_status(unsigned* p, unsigned v) {
  *(volatile unsigned*)p = v;
}

// The sum of `own`'s column over the tiles before `tile` of its row:
// status[(tile - k) * stride] for k >= 1, each an aggregate or an
// inclusive prefix, read kLookBack at a time, added from the nearest on
// until an inclusive one; a word not yet published ends the step, and the
// next step reads again from it.
__device__ __forceinline__ unsigned look_back(const unsigned* own, int tile,
                                              long long stride) {
  unsigned excl = 0;
  int j = tile - 1;        // the nearest tile not yet added
  for (;;) {
    unsigned s[kLookBack];
#pragma unroll
    for (int k = 0; k < kLookBack; ++k)
      s[k] = j - k >= 0 ? load_status(own - (tile - (j - k)) * stride)
                        : kFlagInclusive;     // before the row: nothing
    bool stop = false, done = false;
    int used = 0;
#pragma unroll
    for (int k = 0; k < kLookBack; ++k) {
      stop = stop || done || s[k] == 0;
      if (stop) continue;
      excl += s[k] & kCountMask;
      used = k + 1;
      done = (s[k] & kFlagInclusive) != 0;
    }
    if (done) return excl;
    j -= used;
  }
}

// One LSD pass over [rows, n] pair rows: src/dst are the two buffers,
// chosen per row from the row's active passes (pass 0 of an active row
// reads buffer 0). Grid: rows * radix_tiles(n) CTAs of kRadixThreads.
static __global__ void __launch_bounds__(kRadixThreads)
    radix_pass_kernel(unsigned long long* __restrict__ buf0,
                      unsigned long long* __restrict__ buf1, int* words,
                      int rows, int n, int passes, int pass) {
  __shared__ unsigned wcount[kRadixWarps][kRadix];
  __shared__ unsigned warp_sums[kRadixWarps];
  __shared__ unsigned offset[kRadix];
  const RadixWords w = radix_layout(words, rows, n, passes);
  const int tiles = radix_tiles(n);
  int row, tile;
  take_ticket(w.ticket + pass, tiles, row, tile);
  // the length and the histograms read together, before any exit
  const int len = w.len[row];
  const int* hist_row = w.hist + (long long)row * kMaxPasses * kRadix;
  const unsigned before = active_passes(hist_row, len, pass + 1);
  if (tile * kTile >= len || !(before >> pass & 1u)) return;  // constant
  const bool odd = __popc(before & ((1u << pass) - 1u)) & 1;
  const unsigned long long* src = (odd ? buf1 : buf0) + (long long)row * n;
  unsigned long long* dst = (odd ? buf0 : buf1) + (long long)row * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = threadIdx.x;                   // this thread's digit
  // the row's pairs of smaller digits
  unsigned all;
  const unsigned base = block_exclusive_scan(
      (unsigned)hist_row[pass * kRadix + d], warp_sums, all);
#pragma unroll
  for (int k = 0; k < kRadix / 32; ++k) wcount[warp][k * 32 + lane] = 0;
  __syncwarp();
  // a warp's positions: kRadixItems slices of 32, in access order
  unsigned long long x[kRadixItems];
  unsigned dig[kRadixItems], rank[kRadixItems];
  const int p0 = tile * kTile + warp * 32 * kRadixItems + lane;
#pragma unroll
  for (int k = 0; k < kRadixItems; ++k) {
    const int i = p0 + k * 32;
    x[k] = i < len ? src[i] : 0ull;
    // a position past the row matches no digit
    dig[k] = i < len ? digit_of(pair_key(x[k]), pass) : kRadix + lane;
  }
#pragma unroll
  for (int k = 0; k < kRadixItems; ++k) {
    const unsigned peers = __match_any_sync(0xffffffffu, dig[k]);
    const bool in = dig[k] < kRadix;
    const unsigned had = in ? wcount[warp][dig[k]] : 0u;
    rank[k] = had + __popc(peers & lanemask_lt());
    __syncwarp();
    if (in && lane == __ffs(peers) - 1)
      wcount[warp][dig[k]] = had + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // the warps' counts of digit d become exclusive bases; the tile's count
  unsigned cnt = 0;
#pragma unroll
  for (int v = 0; v < kRadixWarps; ++v) {
    const unsigned c = wcount[v][d];
    wcount[v][d] = cnt;
    cnt += c;
  }
  const long long stride = kRadix;
  unsigned* own = w.status +
                  ((long long)pass * rows * tiles + (long long)row * tiles +
                   tile) * kRadix + d;
  unsigned excl = 0;
  if (tile == 0) {
    store_status(own, kFlagInclusive | cnt);
  } else {
    store_status(own, kFlagAggregate | cnt);
    excl = look_back(own, tile, stride);
    store_status(own, kFlagInclusive | (excl + cnt));
  }
  offset[d] = base + excl;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kRadixItems; ++k) {
    if (dig[k] < kRadix)
      dst[offset[dig[k]] + wcount[warp][dig[k]] + rank[k]] = x[k];
  }
}

// Launches the memset and the passes; the prep kernel runs between them
// (`prep`, called with the stream after the memset).
template <typename Prep>
inline cudaError_t radix_sort_rows(unsigned long long* buf0,
                                   unsigned long long* buf1, int* words,
                                   int rows, int n, int passes,
                                   cudaStream_t stream, Prep prep) {
  cudaError_t err = cudaMemsetAsync(
      words, 0, (size_t)radix_words(rows, n, passes) * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  if ((err = prep()) != cudaSuccess) return err;
  const unsigned grid = (unsigned)((long long)rows * radix_tiles(n));
  for (int p = 0; p < passes; ++p) {
    radix_pass_kernel<<<grid, kRadixThreads, 0, stream>>>(buf0, buf1, words,
                                                          rows, n, passes, p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The buffer that holds a row's sorted pairs after `passes` passes (every
// thread of the CTA calls it).
__device__ __forceinline__ const unsigned long long* sorted_row(
    const unsigned long long* buf0, const unsigned long long* buf1,
    const RadixWords& w, int row, int n, int passes) {
  const unsigned act = active_passes(
      w.hist + (long long)row * kMaxPasses * kRadix, w.len[row], passes);
  return ((__popc(act) & 1) ? buf1 : buf0) + (long long)row * n;
}

// Adds a short run: the pairs from `i` whose key is `key`, the run ending
// before `lim` (at most kLongRun pairs on); all loads issued first, the
// run's length found from them, then kLongRun adds, each past the run
// taking -0.0f, which leaves every float as it is: the operands are
// chosen off the chain, which holds the adds alone.
template <bool kFlush>
__device__ __forceinline__ float short_run_sum(
    const unsigned long long* pr, int i, int lim, unsigned key) {
  unsigned long long x[kLongRun];
#pragma unroll
  for (int u = 0; u < kLongRun; ++u)
    x[u] = i + u < lim ? pr[i + u] : kPadPair;
  unsigned out = 0;                    // positions past the run
#pragma unroll
  for (int u = 0; u < kLongRun; ++u)
    if (pair_key(x[u]) != key || i + u >= lim) out |= 1u << u;
  const int len = out ? __ffs(out) - 1 : kLongRun;
  float v[kLongRun];
#pragma unroll
  for (int u = 0; u < kLongRun; ++u) v[u] = u < len ? pair_value(x[u]) : -0.0f;
  float acc = 0.0f;
#pragma unroll
  for (int u = 0; u < kLongRun; ++u) acc = add_in_order<kFlush>(acc, v[u]);
  return acc;
}

// Adds a long run from `lo` (key `key`, the row's pairs end at `m`) with
// the whole warp: kStage pairs a chunk, loaded coalesced a chunk ahead,
// the values staged in `ring` (kStage floats, the warp's own); lane 0
// adds them in order. Every lane calls it; the sum is lane 0's.
template <bool kFlush>
__device__ float warp_run_sum(const unsigned long long* pr, int lo, int m,
                              unsigned key, float* ring) {
  const int lane = threadIdx.x & 31;
  unsigned long long x[kStagePer];
#pragma unroll
  for (int c = 0; c < kStagePer; ++c) {
    const int i = lo + c * 32 + lane;
    x[c] = i < m ? pr[i] : kPadPair;
  }
  float acc = 0.0f;
  for (int j = lo;; j += kStage) {
    // the run holds a prefix of the chunk: count it by ballots
    int cnt = 0;
#pragma unroll
    for (int c = 0; c < kStagePer; ++c) {
      const int i = j + c * 32 + lane;
      cnt += __popc(__ballot_sync(0xffffffffu,
                                  i < m && pair_key(x[c]) == key));
      ring[c * 32 + lane] = pair_value(x[c]);
    }
    __syncwarp();
    const bool last = cnt < kStage;
    if (!last) {
#pragma unroll
      for (int c = 0; c < kStagePer; ++c) {
        const int i = j + kStage + c * 32 + lane;
        x[c] = i < m ? pr[i] : kPadPair;
      }
    }
    if (lane == 0) {
      // whole groups of 16 unguarded, the next group's shared loads
      // issued before the adds, so the chain holds the adds alone; then
      // the tail one by one
      const float4* r4 = reinterpret_cast<const float4*>(ring);
      const int full = cnt & ~15;
      float4 cur[4], nxt[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) cur[q] = r4[q];
      for (int u = 0; u < full; u += 16) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          nxt[q] = u + 16 < kStage ? r4[(u + 16) / 4 + q] : cur[q];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc = add_in_order<kFlush>(acc, cur[q].x);
          acc = add_in_order<kFlush>(acc, cur[q].y);
          acc = add_in_order<kFlush>(acc, cur[q].z);
          acc = add_in_order<kFlush>(acc, cur[q].w);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) cur[q] = nxt[q];
      }
      for (int u = full; u < cnt; ++u)
        acc = add_in_order<kFlush>(acc, ring[u]);
    }
    __syncwarp();
    if (last) break;
  }
  return acc;
}

// The run pass's per-CTA state: the long runs of the tile (head position
// and output slot), queued for the warps, and each warp's staging ring.
struct RunQueue {
  int count;
  int head[kTile / (kLongRun + 1) + 1];
  int slot[kTile / (kLongRun + 1) + 1];
  __align__(16) float ring[kRadixWarps][kStage];
};

// Exclusive rank of this thread's `flags` (kRadixItems, positions
// tile * kTile + k * kRadixThreads + threadIdx.x) among the CTA's, and
// the CTA's total. Synchronises.
__device__ __forceinline__ void rank_flags(const bool (&flag)[kRadixItems],
                                           int (&rank)[kRadixItems],
                                           unsigned* warp_sums, int& total) {
  unsigned base = 0;
#pragma unroll
  for (int k = 0; k < kRadixItems; ++k) {
    unsigned all;
    const unsigned r = block_exclusive_scan(flag[k] ? 1u : 0u, warp_sums,
                                            all);
    rank[k] = (int)(base + r);
    base += all;
  }
  total = (int)base;
}

// The heads of the row's tiles before `tile` (run_sums' slots): warp 0
// publishes the tile's count and looks back 32 tiles a step. Returns the
// count before the tile to every thread. Synchronises.
__device__ __forceinline__ int run_look_back(unsigned* row_status, int tile,
                                             int count) {
  __shared__ int excl_s;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    unsigned excl = 0;
    if (tile == 0) {
      if (lane == 0) store_status(row_status, kFlagInclusive | count);
    } else {
      if (lane == 0) store_status(row_status + tile, kFlagAggregate | count);
      int j = tile - 1;
      while (j >= 0) {
        const int t = j - lane;
        const unsigned s = t >= 0 ? load_status(row_status + t)
                                  : kFlagInclusive;
        const unsigned ready = __ballot_sync(0xffffffffu, s != 0);
        const unsigned incl = __ballot_sync(0xffffffffu,
                                            (s & kFlagInclusive) != 0);
        // the words up to the first inclusive one (or all 32), all ready
        const int stop = incl ? __ffs(incl) - 1 : 31;
        const unsigned need = stop == 31 ? 0xffffffffu : (2u << stop) - 1u;
        if ((ready & need) != need) continue;        // read again
        unsigned c = lane <= stop && t >= 0 ? (s & kCountMask) : 0u;
        c = __reduce_add_sync(0xffffffffu, c);
        excl += c;
        if (incl) break;
        j -= 32;
      }
      if (lane == 0)
        store_status(row_status + tile, kFlagInclusive | (excl + count));
    }
    if (lane == 0) excl_s = (int)excl;
  }
  __syncthreads();
  return excl_s;
}

}  // namespace etica
