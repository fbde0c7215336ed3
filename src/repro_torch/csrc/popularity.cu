// popularity: per-block Eq. 1 scores, the contribution fused into an
// in-order segment sum.
//
// Replaces the Pallas kernel `_kernel` / `popularity` of
// src/repro/kernels/popularity/kernel.py:26. For accesses i of [V, N] rows
// (dist int32, served bool) grouped into segments (one per (VM, block)):
//   out[b] = sum over the accesses of segment b, in access order, of
//            exp(-dist[i] / max(cs[v], 1)) * [served[i] and dist[i] >= 0]
// with v = i / N the access's row. That is block_scores(addr,
// contributions(dist, served, cs)) of repro_torch.core.popularity, bit for
// bit: the exp is XLA:CPU's (xla_exp.cuh) and each segment adds its
// contributions left to right with __fadd_rn, as np.add.at does. The
// Pallas kernel's one-hot reduction sums in another order, so it agrees
// only within allclose.
//
// What bounds it on the H100: bytes, about 9 read per access (dist,
// served, its position in the segment order) and 4 written per block; the
// exp is some 30 scalar operations an access. At the staged path's shape
// (12 VMs x 1,024 accesses) that is a fraction of a microsecond. The
// kernel is far above it: the sum of a block is one chain of dependent
// adds in access order, so the block with the most accesses in the
// window (about a thousand at the paper's 12-VM shape) sets the time.
//
// Design: the wrapper sorts the segment ids stably (each segment's
// positions in access order) and finds each segment's start. One warp
// per segment: the lanes load 32 positions at once and compute their
// contributions in registers, so the [V, N] contribution vector never
// goes to memory (what the Pallas kernel keeps out of HBM), and the loads
// and exps of a batch overlap; then every lane adds the batch's 32
// contributions in order from __shfl_sync, so only the adds are serial.
// Positions past every segment (padding) are never visited.
#include <cuda_runtime.h>

#include "xla_exp.cuh"

namespace {

constexpr int kWarps = 8;

__global__ void popularity_kernel(const int* __restrict__ dist,
                                  const unsigned char* __restrict__ served,
                                  const int* __restrict__ perm,
                                  const int* __restrict__ offsets,
                                  const float* __restrict__ cs,
                                  float* __restrict__ out, int num_blocks,
                                  int n) {
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x * kWarps + threadIdx.x / 32;
  if (b >= num_blocks) return;
  const int end = offsets[b + 1];
  float acc = 0.0f;
  for (int base = offsets[b]; base < end; base += 32) {
    const int k = base + lane;
    float c = 0.0f;
    if (k < end) {
      const int i = perm[k];
      c = etica::eq1_contribution(dist[i], served[i] != 0, cs[i / n]);
    }
    const int len = min(32, end - base);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float x = __shfl_sync(0xffffffffu, c, j);
      if (j < len) acc = __fadd_rn(acc, x);
    }
  }
  if (lane == 0) out[b] = acc;
}

}  // namespace

extern "C" int etica_popularity(const int* dist, const unsigned char* served,
                                const int* perm, const int* offsets,
                                const float* cs, float* out, int num_blocks,
                                int n, void* stream) {
  if (num_blocks <= 0 || n <= 0) return 0;
  const int blocks = (num_blocks + kWarps - 1) / kWarps;
  popularity_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      dist, served, perm, offsets, cs, out, num_blocks, n);
  return (int)cudaGetLastError();
}
