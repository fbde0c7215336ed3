// run_sums: in-order float32 sums of runs of equal sorted keys.
//
// Not a port of a TPU kernel: a helper for the popularity table
// (`_compact_runs`, src/repro/core/popularity.py:204-219). The reference
// adds each block's contributions left to right, and the table is
// compared bit for bit; CUDA's index_add_/scatter_add_ use atomics in no
// fixed order. Rows are sorted, so each run is contiguous: one thread per
// run head walks its run in order with __fadd_rn and flushes subnormal
// results to zero, as XLA:CPU does. out[v, seg[v, i]] receives the sum of
// the run that starts at i; the wrapper zero-fills the rest.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float ftz(float x) {
  return fabsf(x) < 1.17549435e-38f ? copysignf(0.0f, x) : x;
}

__global__ void run_sums_kernel(const int* __restrict__ keys,
                                const float* __restrict__ vals,
                                const unsigned char* __restrict__ head,
                                const long long* __restrict__ seg,
                                float* __restrict__ out, int n) {
  const int v = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = (long long)v * n;
  if (i >= n || !head[row + i]) return;
  const int key = keys[row + i];
  float acc = 0.0f;
  for (int j = i; j < n && keys[row + j] == key; ++j)
    acc = ftz(__fadd_rn(acc, vals[row + j]));
  out[row + seg[row + i]] = acc;
}

}  // namespace

extern "C" int etica_run_sums(const int* keys, const float* vals,
                              const unsigned char* head, const long long* seg,
                              float* out, int num_vms, int n, void* stream) {
  if (num_vms <= 0 || n <= 0) return 0;
  const int threads = 256;
  dim3 grid((n + threads - 1) / threads, num_vms);
  run_sums_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      keys, vals, head, seg, out, n);
  return (int)cudaGetLastError();
}
