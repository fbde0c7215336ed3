// paged_decode_attention: one-token flash decode over a paged KV pool.
//
// Replaces the Pallas kernel `_kernel` / `paged_decode_attention` of
// src/repro/kernels/decode_attention/kernel.py. For each sequence b and
// query head h·G + g (G = H / Hkv query heads share KV head h):
//
//   out[b, hG+g] = softmax_t(q·scale · k_t) @ v_t,
//   scale = D^-0.5 (float32), tokens t >= lengths[b] masked to -1e30,
//
// where token t of sequence b lives in pool page page_table[b, t / PS],
// row t % PS. Accumulation is float32 in the Pallas body's order: q is
// scaled first, then each step (one page, or 32 tokens of a longer page)
// takes the scores, the running max m, alpha = exp(m_prev - m_new),
// l = l·alpha + sum(p), acc = acc·alpha + p @ V; the output is
// acc / max(l, 1e-30) in q's dtype.
//
// What bounds it on the H100: bytes. Each sequence's K and V rows up to
// its length are read once (2·len·Hkv·D elements), against 4·len·H·D
// operations; at bf16 that is one operation per byte, far under the
// card's ratio of operations to bandwidth.
//
// Design: grid (Hkv, B), one block of 128 threads per (sequence, KV
// head), so the G query heads of a KV head share every K/V load. The
// block reads each page by index from the page table itself (no gather
// into a contiguous copy, the point of the Pallas design) and stages one
// step's K and V rows in shared memory as float32; scores are one thread
// per (head, token), the softmax step one warp per head, and each thread
// keeps the accumulators of up to two head_dim columns for every head in
// registers (D <= 256, G <= 16; the wrapper raises outside that). Pages
// wholly past the length add exactly 0 (exp(-1e30 - m) underflows), so
// the block stops after ceil(length / PS) pages and never reads a table
// entry past the length. A length <= 0 masks every token; every score is
// then -1e30 and the reference returns the mean of V over all n_pages·PS
// slots, so such a row visits every page. Page ids are read as the plain
// version and JAX's gather read them: -1 is the last page, and an id is
// clamped into the pool, so no id can address memory outside it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;       // tokens per online-softmax step, at most
constexpr int kMaxGroups = 16;
constexpr int kMaxCols = 2;     // head_dim columns per thread: D <= 256
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

size_t smem_bytes(int d, int groups) {
  return sizeof(float) * ((size_t)groups * d + (size_t)kTile * (d + 1) +
                          (size_t)kTile * d + (size_t)groups * kTile +
                          3 * (size_t)groups);
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k_pages,
    const KT* __restrict__ v_pages, const int* __restrict__ page_table,
    const int* __restrict__ lengths, QT* __restrict__ out, int pool_pages,
    int page_size, int hkv, int d, int groups, int n_pages, float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int dp = d + 1;                       // padded K rows: no bank clash
  float* q_s = smem;                          // [G][D]
  float* k_s = q_s + groups * d;              // [kTile][D + 1]
  float* v_s = k_s + kTile * dp;              // [kTile][D]
  float* p_s = v_s + kTile * d;               // [G][kTile] scores, then p
  float* m_s = p_s + groups * kTile;          // [G] running max
  float* l_s = m_s + groups;                  // [G] running sum
  float* a_s = l_s + groups;                  // [G] alpha of this step

  const long long head0 = (long long)b * hkv * groups + (long long)h * groups;
  for (int i = tid; i < groups * d; i += kThreads)
    q_s[i] = to_f32(q[head0 * d + i]) * scale;
  if (tid < groups) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.0f;
  }
  float acc[kMaxGroups][kMaxCols];
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g)
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) acc[g][c] = 0.0f;

  const int len = lengths[b];
  int n_visit = n_pages;
  if (len > 0) {
    const long long need = ((long long)len + page_size - 1) / page_size;
    if (need < n_visit) n_visit = (int)need;
  }
  const int* pt_row = page_table + (long long)b * n_pages;

  for (int p = 0; p < n_visit; ++p) {
    int pg = pt_row[p];
    if (pg < 0) pg += pool_pages;
    pg = min(max(pg, 0), pool_pages - 1);
    const long long page_row = (long long)pg * page_size;
    for (int t0 = 0; t0 < page_size; t0 += kTile) {
      const int n = min(kTile, page_size - t0);
      __syncthreads();  // the previous step is done with k_s, v_s, p_s
      for (int i = tid; i < n * d; i += kThreads) {
        const int t = i / d, c = i - t * d;
        const long long src = ((page_row + t0 + t) * hkv + h) * d + c;
        k_s[t * dp + c] = to_f32(k_pages[src]);
        v_s[t * d + c] = to_f32(v_pages[src]);
      }
      __syncthreads();
      for (int i = tid; i < groups * n; i += kThreads) {
        const int g = i / n, t = i - g * n;
        const float* qr = q_s + g * d;
        const float* kr = k_s + t * dp;
        float s = 0.0f;
        for (int c = 0; c < d; ++c) s += qr[c] * kr[c];
        const long long tok = (long long)p * page_size + t0 + t;
        p_s[g * kTile + t] = tok < len ? s : kNegInf;
      }
      __syncthreads();
      for (int g = warp; g < groups; g += kWarps) {
        const float s = lane < n ? p_s[g * kTile + lane] : kNegInf;
        const float m_prev = m_s[g];
        const float m_new = fmaxf(m_prev, warp_max(s));
        const float pe = lane < n ? expf(s - m_new) : 0.0f;
        const float sum = warp_sum(pe);
        if (lane < n) p_s[g * kTile + lane] = pe;
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          l_s[g] = l_s[g] * alpha + sum;
          m_s[g] = m_new;
          a_s[g] = alpha;
        }
      }
      __syncthreads();
#pragma unroll
      for (int g = 0; g < kMaxGroups; ++g) {
        if (g >= groups) break;
        const float alpha = a_s[g];
        const float* pr = p_s + g * kTile;
#pragma unroll
        for (int c = 0; c < kMaxCols; ++c) {
          const int col = tid + c * kThreads;
          if (col < d) {
            float pv = 0.0f;
            for (int t = 0; t < n; ++t) pv += pr[t] * v_s[t * d + col];
            acc[g][c] = acc[g][c] * alpha + pv;
          }
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g) {
    if (g >= groups) break;
    const float l = fmaxf(l_s[g], 1e-30f);
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = tid + c * kThreads;
      if (col < d) store(out + (head0 + g) * d + col, acc[g][c] / l);
    }
  }
}

template <typename QT, typename KT>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* page_table, const int* lengths, void* out, int batch,
           int pool_pages, int page_size, int hkv, int d, int groups,
           int n_pages, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(d, groups);
  auto kernel = paged_decode_kernel<QT, KT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(hkv, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const QT*)q, (const KT*)k_pages, (const KT*)v_pages, page_table,
      lengths, (QT*)out, pool_pages, page_size, hkv, d, groups, n_pages,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: [B, H, D] (float32 or bfloat16, q_bf16); k_pages/v_pages: [NP, PS,
// Hkv, D] (float32 or bfloat16, kv_bf16); page_table: [B, n_pages] int32;
// lengths: [B] int32; out: [B, H, D] in q's dtype. H = Hkv * groups.
extern "C" int etica_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const int* page_table, const int* lengths, void* out, int batch,
    int pool_pages, int page_size, int hkv, int d, int groups, int n_pages,
    float scale, int q_bf16, int kv_bf16, void* stream) {
  if (batch <= 0 || hkv <= 0 || groups <= 0 || d <= 0) return 0;
  if (d > kThreads * kMaxCols || groups > kMaxGroups || pool_pages <= 0 ||
      page_size <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (q_bf16 && kv_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pages, v_pages, page_table, lengths, out, batch, pool_pages,
        page_size, hkv, d, groups, n_pages, scale, s);
  if (q_bf16)
    return launch<__nv_bfloat16, float>(
        q, k_pages, v_pages, page_table, lengths, out, batch, pool_pages,
        page_size, hkv, d, groups, n_pages, scale, s);
  if (kv_bf16)
    return launch<float, __nv_bfloat16>(
        q, k_pages, v_pages, page_table, lengths, out, batch, pool_pages,
        page_size, hkv, d, groups, n_pages, scale, s);
  return launch<float, float>(q, k_pages, v_pages, page_table, lengths, out,
                              batch, pool_pages, page_size, hkv, d, groups,
                              n_pages, scale, s);
}
