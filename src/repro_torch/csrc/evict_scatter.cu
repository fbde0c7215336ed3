// evict_scatter: clear every cache slot whose block is in the VM's queue.
//
// Replaces the Pallas kernel `_evict_kernel` / `evict_scatter` of
// src/repro/kernels/maintenance/kernel.py. Per VM v and slot (s, w):
// if tags[v, s, w] >= 0 and it occurs in queue[v, :] (-1 = padding), the
// slot is cleared (tag -1, lru -1, clean); flushed[v] counts the cleared
// slots that were dirty.
//
// What bounds it on the H100: the membership test. Read once, the data is
// 9 bytes per slot plus 4 per queue entry (about 0.3 MB at 12 VMs x
// 64 x 64), a bound of well under a microsecond; the direct test compares
// every slot with every queue entry, S*W x Q per VM.
//
// Design: grid (V, ceil(S*W / 256)), one thread per slot. The queue row
// is staged through shared memory in 2048-entry tiles (8 KB), so every
// comparison reads shared memory as a broadcast; the TPU kernel's set
// strips and queue chunks (its VMEM shaping) are gone. The flush count is
// a block count (__syncthreads_count) plus one integer atomicAdd per
// block; integer sums are exact in any order. The wrapper hands in
// copies of the state, which the kernel updates in place.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;

__global__ void evict_kernel(int* __restrict__ tags, int* __restrict__ lru,
                             unsigned char* __restrict__ dirty,
                             const int* __restrict__ queue,
                             int* __restrict__ flushed, int sw, int q) {
  __shared__ int tile[kTile];
  const int v = blockIdx.x;
  const int slot = blockIdx.y * kThreads + threadIdx.x;
  const bool in_range = slot < sw;
  const long long idx = (long long)v * sw + slot;
  const int tag = in_range ? tags[idx] : -1;
  bool match = false;
  for (int base = 0; base < q; base += kTile) {
    const int len = min(kTile, q - base);
    for (int k = threadIdx.x; k < len; k += kThreads)
      tile[k] = queue[(long long)v * q + base + k];
    __syncthreads();
    if (tag >= 0 && !match) {
      for (int k = 0; k < len; ++k) match |= (tile[k] == tag);
    }
    __syncthreads();
  }
  const bool was_dirty = match && dirty[idx] != 0;
  if (match) {
    tags[idx] = -1;
    lru[idx] = -1;
    dirty[idx] = 0;
  }
  const int n = __syncthreads_count(was_dirty);
  if (threadIdx.x == 0 && n > 0) atomicAdd(&flushed[v], n);
}

}  // namespace

extern "C" int etica_evict_scatter(int* tags, int* lru, unsigned char* dirty,
                                   const int* queue, int* flushed,
                                   int num_vms, int sw, int q, void* stream) {
  if (num_vms <= 0 || sw <= 0 || q <= 0) return 0;
  dim3 grid(num_vms, (sw + kThreads - 1) / kThreads);
  evict_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      tags, lru, dirty, queue, flushed, sw, q);
  return (int)cudaGetLastError();
}
