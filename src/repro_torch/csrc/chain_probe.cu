// chain_probe: the time of one dependent load from on-chip memory, and of
// one dependent float32 add.
//
// Not a port of any kernel and not on the controller's path. chip_smoke.py
// uses them to price dependency chains. The two_level datapath's: request
// k+1 to a cache set cannot look up the set before request k has updated
// it, so each request on the longest same-set chain costs at least one
// dependent load of state that is already on chip (L1 or shared memory).
// popularity's and run_sums': a block's in-order sum is one chain of
// __fadd_rn, one add for each of its accesses.
//
// Design: one thread follows `steps` links of a cyclic permutation held in
// a buffer small enough to stay in L1, so every load waits for the one
// before it; or adds `inc` to a running sum `steps` times. Timing two step
// counts and taking the difference removes the launch overhead.
#include <cuda_runtime.h>

namespace {

__global__ void chain_probe_kernel(const int* next, int steps, int* out) {
  int i = 0;
  for (int k = 0; k < steps; ++k) i = next[i];
  *out = i;
}

__global__ void fadd_probe_kernel(float inc, int steps, float* out) {
  float x = 0.0f;
  for (int k = 0; k < steps; ++k) x = __fadd_rn(x, inc);
  *out = x;
}

}  // namespace

extern "C" int etica_chain_probe(const int* next, int steps, int* out,
                                 void* stream) {
  chain_probe_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(next, steps, out);
  return (int)cudaGetLastError();
}

extern "C" int etica_fadd_probe(float inc, int steps, float* out,
                                void* stream) {
  fadd_probe_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(inc, steps, out);
  return (int)cudaGetLastError();
}
