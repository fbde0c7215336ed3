// clean_scatter: the background cleaner over a [V, S, W] state, with each
// VM's cutoff found in the same launch.
//
// Replaces the Pallas kernel `_clean_kernel` / `clean_scatter` of
// src/repro/kernels/maintenance/kernel.py:137 (pallas_call at :152) and
// the cutoffs its wrapper computes first (`_clean_cutoffs`,
// src/repro/kernels/maintenance/ops.py:78: two stable argsorts, gathers).
// Per VM v, with flat = s * W + w over the full W (max ways):
//   candidates: the dirty slots with w < ways[v], each with the unique key
//     (lru, flat);
//   take = min(quota[v], n_cand); the cutoff (lru_cut, idx_cut) is the key
//     of the take-th smallest candidate, (INT32_MIN, -1) when take <= 0;
//   a candidate flushes (its dirty bit clears; tag and lru stay, so the
//     block stays resident and clean) when its key is at or below the
//     cutoff: lru < lru_cut, or lru == lru_cut and flat <= idx_cut.
// flushed[v] counts the flushed slots (take: the keys are unique) and
// dirty_left[v] = n_cand - take. With a null quota the cutoffs are inputs
// and the selection is skipped: the TPU kernel's own contract.
//
// What bounds it on the H100: bytes. Each slot is read once (1 byte of
// dirty, 4 of lru) and its dirty byte written once, about 0.1 MB at
// 12 VMs x 64 x 64 (0.09 us); the selection is a few integer operations a
// slot and pass. In practice: a chain of cluster barriers, one a pass.
//
// Design: one thread-block cluster a VM, `parts` CTAs (the wrapper picks
// parts and threads from shapes, ops.clean_plan: several CTAs a VM while
// the VMs leave SMs idle, smaller CTAs when the VMs alone fill the card),
// each a contiguous range of the VM's slots, one slot a thread at a time:
//  1. Count. A candidate's key as one integer, k = (lru ^ 0x80000000) << b
//     | flat with b the bits of S*W - 1, orders as (lru, flat). Each CTA
//     counts its candidates and finds their least and greatest key; every
//     CTA reads all the cluster's counts through distributed shared memory
//     and adds them in rank order, so each holds n_cand, min and max.
//  2. Select (quota given, take > 0). A radix select of the take-th
//     smallest key: the bits above the highest bit in which min and max
//     differ are common to every candidate; each pass takes the next 8
//     bits: each CTA builds a 256-bin histogram of the candidates that
//     share the prefix found so far (shared-memory atomics), every CTA adds
//     the cluster's bins through distributed shared memory, and one warp
//     finds the digit whose bin holds the rank. At most 8 passes (keys are
//     under 2^63), fewer when the keys span fewer bits; the histograms
//     alternate between two buffers, so a pass costs one cluster barrier.
//  3. Flush and write. Each CTA writes its slots of a fresh dirty, the
//     flushed ones cleared, and counts them; the cluster's first CTA adds
//     the CTAs' counts in rank order and writes flushed, the cutoffs, take,
//     n_cand and dirty_left. No atomics in global memory, nothing to zero
//     or copy first: one launch, one device event.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 256;   // threads a CTA, at most
constexpr int kWarps = kThreads / 32;
constexpr int kMaxParts = 8;    // CTAs a VM: a portable cluster
constexpr int kDigit = 8;       // bits a pass
constexpr int kBins = 1 << kDigit;
constexpr int kBinsLane = kBins / 32;
constexpr int kIntMin = (int)0x80000000u;

__device__ __forceinline__ u64 slot_key(int lru, int flat, int b) {
  return ((u64)((unsigned)lru ^ 0x80000000u) << b) | (unsigned)flat;
}

__device__ __forceinline__ u64 warp_min(u64 x) {
#pragma unroll
  for (int d = 16; d; d >>= 1) {
    const u64 y = __shfl_xor_sync(0xffffffffu, x, d);
    x = y < x ? y : x;
  }
  return x;
}

__device__ __forceinline__ u64 warp_max(u64 x) {
#pragma unroll
  for (int d = 16; d; d >>= 1) {
    const u64 y = __shfl_xor_sync(0xffffffffu, x, d);
    x = y > x ? y : x;
  }
  return x;
}

__global__ void __launch_bounds__(kThreads) clean_kernel(
    const unsigned char* __restrict__ dirty_in, const int* __restrict__ lru,
    const int* __restrict__ ways, const int* __restrict__ quota,
    int* __restrict__ lru_cut, int* __restrict__ idx_cut,
    int* __restrict__ take_out, int* __restrict__ n_cand_out,
    int* __restrict__ left_out, unsigned char* __restrict__ dirty,
    int* __restrict__ flushed, int sw, int num_ways, int parts) {
  __shared__ int hist[2][kBins], bins[kBins];
  __shared__ int warp_n[kWarps];
  __shared__ u64 warp_lo[kWarps], warp_hi[kWarps];
  __shared__ int cta_n, cta_flushed, all_n, sel_digit, sel_rank;
  __shared__ u64 cta_lo, cta_hi, all_lo, all_hi;
  cg::cluster_group cluster = cg::this_cluster();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int part = (int)cluster.block_rank();
  const long long v = blockIdx.x / parts;
  const int s_lo = (int)((long long)sw * part / parts);
  const int s_hi = (int)((long long)sw * (part + 1) / parts);
  const long long row = v * sw;
  const int wv = ways[v];
  const int b = sw > 1 ? 32 - __clz(sw - 1) : 0;   // bits of a flat index
  auto is_cand = [&](int i) {
    return dirty_in[row + i] != 0 && i % num_ways < wv;
  };

  int lc = kIntMin, ic = -1, take = 0, n_cand = 0;
  if (quota == nullptr) {
    lc = lru_cut[v];
    ic = idx_cut[v];
  } else {
    // 1. the VM's candidates: count, least and greatest key
    int n = 0;
    u64 lo = ~0ull, hi = 0;
    for (int i = s_lo + threadIdx.x; i < s_hi; i += nthreads) {
      if (is_cand(i)) {
        const u64 k = slot_key(lru[row + i], i, b);
        ++n;
        lo = k < lo ? k : lo;
        hi = k > hi ? k : hi;
      }
    }
    n = __reduce_add_sync(0xffffffffu, n);
    lo = warp_min(lo);
    hi = warp_max(hi);
    if (lane == 0) {
      warp_n[warp] = n;
      warp_lo[warp] = lo;
      warp_hi[warp] = hi;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < nwarps; ++w) {
        n += warp_n[w];
        lo = warp_lo[w] < lo ? warp_lo[w] : lo;
        hi = warp_hi[w] > hi ? warp_hi[w] : hi;
      }
      cta_n = n;
      cta_lo = lo;
      cta_hi = hi;
    }
    cluster.sync();
    if (threadIdx.x == 0) {
      n = 0;
      lo = ~0ull;
      hi = 0;
      for (int r = 0; r < parts; ++r) {
        n += *cluster.map_shared_rank(&cta_n, r);
        const u64 l = *cluster.map_shared_rank(&cta_lo, r);
        const u64 h = *cluster.map_shared_rank(&cta_hi, r);
        lo = l < lo ? l : lo;
        hi = h > hi ? h : hi;
      }
      all_n = n;
      all_lo = lo;
      all_hi = hi;
    }
    __syncthreads();
    n_cand = all_n;
    take = min(quota[v], n_cand);

    // 2. the take-th smallest key, 8 bits a pass below the common prefix
    if (take > 0) {
      const u64 diff = all_lo ^ all_hi;
      const int top = diff ? 64 - __clzll((long long)diff) : 0;
      u64 prefix = top ? all_lo >> top << top : all_lo;
      int rank = take;   // among the candidates that share the prefix
      int buf = 0;
      for (int hi_bit = top; hi_bit > 0; hi_bit -= kDigit, buf ^= 1) {
        const int lo_bit = hi_bit > kDigit ? hi_bit - kDigit : 0;
        const int nb = 1 << (hi_bit - lo_bit);
        int* h = hist[buf];
        for (int k = threadIdx.x; k < kBins; k += nthreads) h[k] = 0;
        __syncthreads();
        const u64 want = prefix >> hi_bit;
        for (int i = s_lo + threadIdx.x; i < s_hi; i += nthreads) {
          if (is_cand(i)) {
            const u64 k = slot_key(lru[row + i], i, b);
            if (k >> hi_bit == want)
              atomicAdd(&h[(int)(k >> lo_bit) & (nb - 1)], 1);
          }
        }
        cluster.sync();   // every CTA's bins are in
        for (int k = threadIdx.x; k < nb; k += nthreads) {
          int t = 0;
          for (int r = 0; r < parts; ++r)
            t += *cluster.map_shared_rank(&h[k], r);
          bins[k] = t;
        }
        __syncthreads();
        if (warp == 0) {
          int c[kBinsLane], sum = 0;
#pragma unroll
          for (int j = 0; j < kBinsLane; ++j) {
            const int k = lane * kBinsLane + j;
            c[j] = k < nb ? bins[k] : 0;
            sum += c[j];
          }
          int incl = sum;
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, incl, d);
            if (lane >= d) incl += y;
          }
          const unsigned found = __ballot_sync(0xffffffffu, incl >= rank);
          if (lane == __ffs(found) - 1) {
            int r = rank - (incl - sum), j = 0;
            while (c[j] < r) r -= c[j++];
            sel_digit = lane * kBinsLane + j;
            sel_rank = r;
          }
        }
        __syncthreads();
        prefix |= (u64)sel_digit << lo_bit;
        rank = sel_rank;
      }
      lc = (int)((unsigned)(prefix >> b) ^ 0x80000000u);
      ic = (int)(prefix & ((1ull << b) - 1));
    }
  }

  // 3. the fresh dirty bits and the VM's count of flushes
  int nf = 0;
  for (int i = s_lo + threadIdx.x; i < s_hi; i += nthreads) {
    const unsigned char d = dirty_in[row + i];
    bool f = false;
    if (d != 0 && i % num_ways < wv) {
      const int l = lru[row + i];
      f = l < lc || (l == lc && i <= ic);
    }
    dirty[row + i] = f ? 0 : d;
    nf += f;
  }
  nf = __reduce_add_sync(0xffffffffu, nf);
  if (lane == 0) warp_n[warp] = nf;
  __syncthreads();
  if (warp == 0) {
    int x = lane < nwarps ? warp_n[lane] : 0;
    x = __reduce_add_sync(0xffffffffu, x);
    if (lane == 0) cta_flushed = x;
  }
  cluster.sync();
  if (part == 0 && warp == 0) {
    int x = lane < parts ? *cluster.map_shared_rank(&cta_flushed, lane) : 0;
    x = __reduce_add_sync(0xffffffffu, x);
    if (lane == 0) {
      flushed[v] = x;
      if (quota != nullptr) {
        lru_cut[v] = lc;
        idx_cut[v] = ic;
        take_out[v] = take;
        n_cand_out[v] = n_cand;
        left_out[v] = n_cand - take;
      }
    }
  }
  cluster.sync();  // every CTA's shared memory outlives the reads
}

}  // namespace

// dirty_in and lru [V, S*W] are read; dirty [V, S*W] and flushed [V] are
// written in full, with, when quota [V] is given, lru_cut, idx_cut, take,
// n_cand and dirty_left [V]; with quota null, lru_cut and idx_cut are the
// inputs (take, n_cand and dirty_left unused). parts CTAs a VM (1 to
// kMaxParts, one cluster) of `threads` threads (a multiple of 32, at most
// kThreads).
extern "C" int etica_clean_scatter(
    const unsigned char* dirty_in, const int* lru, const int* ways,
    const int* quota, int* lru_cut, int* idx_cut, int* take, int* n_cand,
    int* dirty_left, unsigned char* dirty, int* flushed, int num_vms,
    int sets, int num_ways, int parts, int threads, void* stream) {
  const int sw = sets * num_ways;
  if (num_vms <= 0 || sw <= 0) return 0;
  if (parts < 1 || parts > kMaxParts || threads < 32 || threads > kThreads ||
      threads % 32)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((long long)num_vms * parts));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = parts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = parts > 1 ? 1 : 0;  // one CTA a VM: a plain launch
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, clean_kernel, dirty_in, lru, ways, quota, lru_cut, idx_cut, take,
      n_cand, dirty_left, dirty, flushed, sw, num_ways, parts);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
