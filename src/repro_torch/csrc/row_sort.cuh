// row_sort: one CTA groups one row's entries by a key in shared memory,
// keeping access order inside each group, and adds each group left to
// right. Shared by `popularity` (key: the segment id) and `run_sums` (key:
// the block address), the two kernels whose results must reproduce the
// reference's in-order float32 sums bit for bit.
//
// The row's entries are loaded coalesced, padding is dropped with a flag
// scan (RowScan, row_scan.cuh), and each kept entry becomes a 64-bit pair (key << 32 |
// value), in access order.
//
// row_sort is a stable merge sort on the keys. Each thread first sorts
// kChunk consecutive pairs in registers (odd-even transposition). Each
// round then doubles the sorted runs by ranking: a pair of the left run
// moves to its index plus the number of keys of the right run below its
// key, a pair of the right run to its index plus the number of keys of the
// left run at or below its own, so equal keys keep their order. Every pair
// finds its count by a branchless binary search, all of a thread's pairs
// step by step together, so their loads are in flight at once; after a
// barrier the CTA writes the pairs to their places. A round costs log2(run)
// + 1 dependent loads a pair and two barriers. On one SM, a bitonic network
// that steps through shared memory pays that memory's bandwidth and a
// barrier at each of its log2(p) (log2(p) + 1) / 2 steps, and merge-path
// merges serialise their loads; both sorted a 1,024-entry row more slowly.
//
// One CTA sorts up to kMaxRow entries: 8 bytes of dynamic shared memory
// a pair (row_smem_bytes) and kMaxPerThread pairs in each thread's
// registers during a round. A wider row takes the tiled route
// (row_radix.cuh): a radix sort of the row across the whole card.
#pragma once

#include <cuda_runtime.h>

#include "row_scan.cuh"
#include "xla_exp.cuh"

namespace etica {

constexpr int kMaxRow = 16384;
constexpr int kMaxTiles = kMaxRow / kRowThreads;
constexpr int kMaxPerThread = kMaxRow / kRowThreads;
constexpr int kChunk = 8;   // pairs a thread sorts in registers first
// the padding pairs: above every key, so they stay after the row's pairs
constexpr unsigned long long kPadPair = 0xffffffffull << 32;

// pairs a row of n entries may need: the power of two at or above n, at
// least kChunk
__host__ __device__ constexpr int row_capacity(int n) {
  int p = kChunk;
  while (p < n) p <<= 1;
  return p;
}

// dynamic shared memory of a row of n entries: its pairs
__host__ __device__ constexpr size_t row_smem_bytes(int n) {
  return (size_t)row_capacity(n) * sizeof(unsigned long long);
}

__device__ __forceinline__ unsigned long long make_pair(unsigned key,
                                                        float value) {
  return ((unsigned long long)key << 32) | __float_as_uint(value);
}
__device__ __forceinline__ unsigned pair_key(unsigned long long p) {
  return (unsigned)(p >> 32);
}
__device__ __forceinline__ float pair_value(unsigned long long p) {
  return __uint_as_float((unsigned)p);
}
// int32 keys in signed order as unsigned pair keys, and back
__device__ __forceinline__ unsigned signed_key(int k) {
  return (unsigned)k ^ 0x80000000u;
}
__device__ __forceinline__ int unsigned_key(unsigned k) {
  return (int)(k ^ 0x80000000u);
}

// Sorts each thread's kChunk consecutive pairs by key, stably: odd-even
// transposition, which swaps only a strictly greater key past a smaller.
__device__ __forceinline__ void sort_chunk(unsigned long long* pairs, int c) {
  unsigned long long x[kChunk];
#pragma unroll
  for (int r = 0; r < kChunk; ++r) x[r] = pairs[c * kChunk + r];
#pragma unroll
  for (int phase = 0; phase < kChunk; ++phase) {
#pragma unroll
    for (int r = phase & 1; r + 1 < kChunk; r += 2) {
      const unsigned long long a = x[r], b = x[r + 1];
      const bool swap = pair_key(b) < pair_key(a);
      x[r] = swap ? b : a;
      x[r + 1] = swap ? a : b;
    }
  }
#pragma unroll
  for (int r = 0; r < kChunk; ++r) pairs[c * kChunk + r] = x[r];
}

// Merge rounds from runs of len0 up to p, with kPer pairs a thread
// (threadIdx.x + k * kRowThreads, all below p unless kPer is 1).
template <int kPer>
__device__ void merge_rounds(unsigned long long* pairs, int p, int len0) {
  for (int len = len0; len < p; len <<= 1) {
    unsigned long long x[kPer];
    int cnt[kPer];
    __syncthreads();
    const bool on = kPer > 1 || threadIdx.x < p;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      x[k] = on ? pairs[threadIdx.x + k * kRowThreads] : 0;
      cnt[k] = 0;
    }
    // cnt[k]: keys of the other run below (left run) or at or below
    // (right run) the key of x[k], one halving step at a time
    for (int step = len >> 1; step >= 1 && on; step >>= 1) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int e = threadIdx.x + k * kRowThreads;
        const bool left = (e & len) == 0;
        const int other = (e & ~(2 * len - 1)) + (left ? len : 0);
        const unsigned o = pair_key(pairs[other + cnt[k] + step - 1]);
        const unsigned key = pair_key(x[k]);
        if (left ? o < key : o <= key) cnt[k] += step;
      }
    }
    if (on) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int e = threadIdx.x + k * kRowThreads;
        const bool left = (e & len) == 0;
        const int other = (e & ~(2 * len - 1)) + (left ? len : 0);
        const unsigned o = pair_key(pairs[other + cnt[k]]);
        const unsigned key = pair_key(x[k]);
        if (left ? o < key : o <= key) cnt[k] += 1;
      }
    }
    __syncthreads();
    if (on) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        // the merged run's start, the pair's index in its run, the count
        const int e = threadIdx.x + k * kRowThreads;
        pairs[(e & ~(2 * len - 1)) + (e & (len - 1)) + cnt[k]] = x[k];
      }
    }
  }
}

// Sorts pairs[0, m) by key, stably, with kPadPair after them up to
// row_capacity(m); every thread of the CTA calls it with the same m.
// Synchronises before and after.
inline __device__ void row_sort(unsigned long long* pairs, int m) {
  const int p = row_capacity(m);
  for (int e = m + threadIdx.x; e < p; e += kRowThreads) pairs[e] = kPadPair;
  __syncthreads();
  for (int c = threadIdx.x; c < p / kChunk; c += kRowThreads)
    sort_chunk(pairs, c);
  switch (p / kRowThreads) {
    case 0:
    case 1: merge_rounds<1>(pairs, p, kChunk); break;
    case 2: merge_rounds<2>(pairs, p, kChunk); break;
    case 4: merge_rounds<4>(pairs, p, kChunk); break;
    case 8: merge_rounds<8>(pairs, p, kChunk); break;
    case 16: merge_rounds<16>(pairs, p, kChunk); break;
    default: merge_rounds<kMaxPerThread>(pairs, p, kChunk); break;
  }
  __syncthreads();
}

__device__ __forceinline__ unsigned sorted_key(const unsigned long long* pairs,
                                               int i) {
  return pair_key(pairs[i]);
}

// End of the run of `key` that starts at `lo` in the sorted pairs[0, m):
// a galloping search, so a short run costs a load or two.
__device__ __forceinline__ int run_end(const unsigned long long* pairs,
                                       int lo, int m, unsigned key) {
  int step = 1;
  while (lo + step < m && sorted_key(pairs, lo + step) == key) step <<= 1;
  int a = lo + (step >> 1) + 1, b = min(lo + step, m);
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (sorted_key(pairs, mid) == key) {
      a = mid + 1;
    } else {
      b = mid;
    }
  }
  return a;
}

// acc + v rounded to nearest; with kFlush, a subnormal sum is flushed to
// zero of its sign. An exactly subnormal sum of two floats needs no
// rounding, so the one add.rn.ftz instruction equals ftz(__fadd_rn(acc,
// v)) whenever acc and v are not subnormal themselves.
template <bool kFlush>
__device__ __forceinline__ float add_in_order(float acc, float v) {
  if (!kFlush) return __fadd_rn(acc, v);
  float out;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(out) : "f"(acc), "f"(v));
  return out;
}

// The packed values of pairs[lo, hi) added left to right from 0.0f (with
// kFlush, values and partial sums not subnormal, as XLA:CPU keeps them).
// Whole chunks of kAhead are loaded a chunk ahead of their adds, so only
// the chain of adds is serial.
template <bool kFlush>
__device__ __forceinline__ float run_sum(const unsigned long long* pairs,
                                         int lo, int hi) {
  constexpr int kAhead = 16;
  float acc = 0.0f;
  int j = lo;
  if (hi - j >= kAhead) {
    float cur[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) cur[u] = pair_value(pairs[j + u]);
    for (j += kAhead; hi - j >= kAhead; j += kAhead) {
      float nxt[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) nxt[u] = pair_value(pairs[j + u]);
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        acc = add_in_order<kFlush>(acc, cur[u]);
        cur[u] = nxt[u];
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) acc = add_in_order<kFlush>(acc, cur[u]);
  }
  float tail[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u)
    tail[u] = j + u < hi ? pair_value(pairs[j + u]) : 0.0f;
#pragma unroll
  for (int u = 0; u < kAhead; ++u)
    if (j + u < hi) acc = add_in_order<kFlush>(acc, tail[u]);
  return acc;
}

// Opts `kernel` into the shared memory of a kMaxRow row, once (before any
// graph capture).
template <typename Kernel>
inline cudaError_t row_kernel_setup(Kernel kernel, bool& configured) {
  if (configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)row_smem_bytes(kMaxRow));
  if (err == cudaSuccess) configured = true;
  return err;
}

}  // namespace etica
