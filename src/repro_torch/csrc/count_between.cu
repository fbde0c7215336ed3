// count_between: the distinct-block count under every reuse distance.
//
// Replaces the Pallas kernel `_kernel` / `count_between` of
// src/repro/kernels/reuse_distance/kernel.py (vmapped over VMs in
// reuse_distance/ops.py), and the jnp twin `_count_between` of
// src/repro/core/reuse.py that the JAX controller runs:
//
//   count[v, i] = #{ j : prev[v, i] < j < i, touch[v, j], nt[v, j] >= i }
//
// What bounds it on the H100: the pair loop. The work is one test per
// (i, j) pair inside each reuse window, sum_i (i - prev[i] - 1), which for
// the POD sizing rows ([V, 1024] at the paper's 12-VM deployment) is far
// more than the 13 bytes per element the kernel must move. So it is bound
// by integer issue rate, not by memory.
//
// Design: grid (ceil(N / 128), V), one thread per row i. Each thread loops
// j over (prev[i], i) only, so no thread touches a pair outside its
// window: the TPU version evaluated whole TI x TJ tiles and masked them,
// here the skipped tiles cost nothing. Neighbouring threads read
// neighbouring j at the same time, so touch/nt reads coalesce and hit L1.
// Counts are int32 sums of 0/1 and exact in any order.
#include <cuda_runtime.h>

namespace {

__global__ void count_between_kernel(const int* __restrict__ prev,
                                     const unsigned char* __restrict__ touch,
                                     const int* __restrict__ nt,
                                     int* __restrict__ out, int n) {
  const int v = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long row = (long long)v * n;
  const int p = prev[row + i];
  int c = 0;
  for (int j = p + 1 > 0 ? p + 1 : 0; j < i; ++j) {
    c += (touch[row + j] != 0) & (nt[row + j] >= i);
  }
  out[row + i] = c;
}

}  // namespace

extern "C" int etica_count_between(const int* prev, const unsigned char* touch,
                                   const int* nt, int* out, int num_vms, int n,
                                   void* stream) {
  if (num_vms <= 0 || n <= 0) return 0;
  const int threads = 128;
  dim3 grid((n + threads - 1) / threads, num_vms);
  count_between_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      prev, touch, nt, out, n);
  return (int)cudaGetLastError();
}
