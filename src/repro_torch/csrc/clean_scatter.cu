// clean_scatter: the background cleaner's flush over a [V, S, W] state.
//
// Replaces the Pallas kernel `_clean_kernel` / `clean_scatter` of
// src/repro/kernels/maintenance/kernel.py. Per VM v and slot (s, w), with
// flat = s * W + w over the full W (max ways): the slot flushes (its dirty
// bit clears; tag and lru stay, so the block stays resident and clean)
// when it is dirty, w < ways[v], and its age key (lru, flat) is at or
// below the VM's cutoff (lru_cut[v], idx_cut[v]):
//   lru < lru_cut, or lru == lru_cut and flat <= idx_cut.
// The keys are unique, so this flushes exactly the `take` oldest
// candidates that the cutoffs (maintenance/ops.py `_clean_cutoffs`, plain
// PyTorch) were computed for; the sentinel (INT32_MIN, -1) flushes
// nothing. flushed[v] counts the flushed slots.
//
// What bounds it on the H100: bytes. Each slot is read once (1 byte of
// dirty, 4 of lru) and its dirty byte written once, about 0.1 MB at
// 12 VMs x 64 x 64; there is no reuse and almost no arithmetic.
//
// Design: grid (V, ceil(S*W / 256)), one thread per slot, neighbouring
// threads on neighbouring slots, so loads coalesce. There is no set-strip
// padding (that was the TPU's VMEM shaping). The per-VM count is a block
// count (__syncthreads_count) plus one integer atomicAdd per block, exact
// in any order. The wrapper hands in a copy of dirty, which the kernel
// updates in place.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void clean_kernel(unsigned char* __restrict__ dirty,
                             const int* __restrict__ lru,
                             const int* __restrict__ ways,
                             const int* __restrict__ lru_cut,
                             const int* __restrict__ idx_cut,
                             int* __restrict__ flushed, int sw,
                             int num_ways) {
  const int v = blockIdx.x;
  const int slot = blockIdx.y * kThreads + threadIdx.x;
  bool flush = false;
  if (slot < sw) {
    const long long idx = (long long)v * sw + slot;
    if (dirty[idx] != 0 && slot % num_ways < ways[v]) {
      const int l = lru[idx];
      const int lc = lru_cut[v];
      flush = l < lc || (l == lc && slot <= idx_cut[v]);
      if (flush) dirty[idx] = 0;
    }
  }
  const int n = __syncthreads_count(flush);
  if (threadIdx.x == 0 && n > 0) atomicAdd(&flushed[v], n);
}

}  // namespace

extern "C" int etica_clean_scatter(unsigned char* dirty, const int* lru,
                                   const int* ways, const int* lru_cut,
                                   const int* idx_cut, int* flushed,
                                   int num_vms, int sets, int num_ways,
                                   void* stream) {
  const int sw = sets * num_ways;
  if (num_vms <= 0 || sw <= 0) return 0;
  dim3 grid(num_vms, (sw + kThreads - 1) / kThreads);
  clean_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      dirty, lru, ways, lru_cut, idx_cut, flushed, sw, num_ways);
  return (int)cudaGetLastError();
}
