// Warp-wide lookups in one set row of a [V, S, W] cache state, shared by
// the datapath kernels (datapath.cu, single_level.cu). A warp of 32 lanes
// covers the W ways of the row; every lane returns the same answer.
#pragma once

#include <climits>

namespace etica {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0x7fffffffu;

// First active way (w < ways) whose tag equals `a`; kNone when absent.
__device__ __forceinline__ unsigned first_match(const int* tags, int num_ways,
                                                int ways, int a, int lane) {
  unsigned best = kNone;
  const int lim = min(ways, num_ways);
  for (int w = lane; w < lim; w += 32) {
    if (tags[w] == a) {
      best = (unsigned)w;
      break;
    }
  }
  return __reduce_min_sync(kFull, best);
}

// Insert way: first minimum of score(w) = -1 for an empty active way, lru
// for a full active way, INT_MAX for an inactive way (a shuffle butterfly
// on the (score, way) key).
__device__ __forceinline__ int victim(const int* tags, const int* lru,
                                      int num_ways, int ways, int lane) {
  long long best = LLONG_MAX;
  for (int w = lane; w < num_ways; w += 32) {
    const int score = w < ways ? (tags[w] < 0 ? -1 : lru[w]) : INT_MAX;
    const long long key = (long long)score * 4294967296LL + w;
    best = key < best ? key : best;
  }
  for (int off = 16; off > 0; off >>= 1) {
    const long long o = __shfl_xor_sync(kFull, best, off);
    best = o < best ? o : best;
  }
  return (int)(best - (best >> 32) * 4294967296LL);
}

}  // namespace etica
