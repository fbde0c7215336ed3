// flash_attention: blocked causal / sliding-window attention forward.
//
// Replaces the Pallas kernel `_kernel` / `flash_attention` of
// src/repro/kernels/flash_attention/kernel.py. For batch b, query head h
// (KV head h / G, G = H / Hkv) and query row i:
//
//   out[b, h, i] = softmax_j(q_i·scale · k_j) @ v_j,   scale = D^-0.5,
//
// with q scaled in float32 before the product, float32 scores, and a
// score set to -1e30 (not -inf) where the mask drops it: causal keeps
// q_pos >= k_pos, window > 0 keeps k_pos > q_pos - window, at absolute
// positions q_pos = q_offset + i, k_pos = j. The running (m, l, acc) is
// float32, one KV tile at a time as in the Pallas body: m_new = max(m,
// rowmax s), p = exp(s - m_new), alpha = exp(m - m_new), l = l·alpha +
// sum p, acc = acc·alpha + p @ V; the output is acc / max(l, 1e-30) in
// q's dtype.
//
// Skipping masked tiles is exact. A KV tile wholly masked for every row
// of the query tile (past the causal diagonal, or before the window)
// contributes, in the Pallas body, either p = exp(-1e30 - m) = 0 after a
// real score (alpha = 1: nothing changes), or, before any real score (m
// = -1e30), p = 1 on every entry; the first tile with a real score then
// has alpha = exp(-1e30 - m_real) = 0, which wipes that l and acc out
// exactly. So the block visits only the tiles from the window's first
// to the diagonal's last, as long as every row of its q tile keeps at
// least one key: the causal mask keeps key 0, and a window keeps k =
// q_pos while q_pos < Skv. A row whose window starts past the last key
// keeps none, and the reference averages V over all keys; a block with
// such a row visits every tile.
//
// What bounds it on the H100: operations. At the prefill shape (B 4, H
// 32, S 4096, D 128, causal) the two products are 2·B·H·S²·D = 0.55
// TFLOP against 0.27 GB of q, k, v and output: about 2,000 operations a
// byte, far above the card's ratio. This first version runs them as
// float32 FMAs on the CUDA cores (67 TFLOP/s peak), not on the tensor
// cores (989 TFLOP/s in bf16): wgmma, TMA and a producer/consumer
// pipeline are later work.
//
// Design: grid (Sq / 64 q tiles, H, B), one block of 256 threads per
// (b, h, 64-row q tile); tiles in reverse order, so the causal tiles
// with the most KV tiles start first. The q tile is staged in shared
// memory as float32, already scaled; each KV tile (64 keys) is staged as
// float32 through one buffer, K first, then V. Thread (ty, tx) of a
// 16 x 16 grid owns rows ty + 16i (i < 4) of the tile: scores of keys
// tx + 16j (j < 4), and output columns 64c + 4tx + e (e < 4, c < D/64).
// A row's max and sum reduce over the 16 lanes that share ty (one half
// warp). Rows are zero-padded to 64 or 128 columns (D <= 128), which
// adds exact zeros to each dot product; rows past Sq load as zeros and
// are not stored; keys past Skv score -inf, so their p is exactly 0.
// Only the last dimension of q, k, v and out must be contiguous: the
// kernel takes the other three strides, so the model's [B, S, H, D]
// tensors need no transposed copy. Shared memory 85 KB for D 128: two
// blocks an SM, so one block's tile loads overlap the other's products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_tiles.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;        // query rows a block
constexpr int kBN = 64;        // keys a KV tile
constexpr int kMaxHeadDim = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// the 16 lanes of a half warp share one ty: reduce across them
__device__ __forceinline__ float half_max(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int DMAX>
__host__ __device__ constexpr int row_pitch() {
  return DMAX + 4;             // float4-aligned rows, no bank conflict
}

template <int DMAX>
size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBM * row_pitch<DMAX>() +
                          (size_t)kBN * row_pitch<DMAX>() +
                          (size_t)kBM * (kBN + 4));
}

// rows [0, 64) of a [rows, d] tile at src (row stride `stride`) into
// dst[64][row_pitch] as float32 times mul; zero past `rows` and past d
template <typename T, int DMAX>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride, int rows, int d,
                                          float mul) {
  constexpr int kPer = kBN * DMAX / kThreads;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = threadIdx.x + u * kThreads;
    const int r = i / DMAX, c = i % DMAX;
    float x = 0.0f;
    if (r < rows && c < d) x = to_f32(src[r * stride + c]) * mul;
    dst[r * row_pitch<DMAX>() + c] = x;
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads, 2) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int groups, int sq,
    int skv, int d, long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss, long long vsb,
    long long vsh, long long vss, long long osb, long long osh,
    long long oss, int causal, int window, int q_offset, float scale) {
  constexpr int QP = row_pitch<DMAX>();
  constexpr int PP = kBN + 4;
  constexpr int NC = DMAX / 64;          // float4 column groups a thread
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // [kBM][QP]
  float* kv_s = q_s + kBM * QP;                    // [kBN][QP], K then V
  float* p_s = kv_s + kBN * QP;                    // [kBM][PP]

  const int n_qt = (sq + kBM - 1) / kBM;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kBM;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / groups;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q_rows = min(kBM, sq - q0);

  const T* qb = q + b * qsb + h * qsh + (long long)q0 * qss;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  int kt_lo, kt_hi;   // the KV tiles to visit (the others add nothing)
  flash_kv_tiles(q0, q_rows, skv, kBN, causal, window, q_offset, &kt_lo,
                 &kt_hi);

  load_tile<T, DMAX>(q_s, qb, qss, q_rows, d, scale);

  float m[4], l[4], alpha[4], acc[4][NC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.0f;
  }

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kBN;
    const int k_rows = min(kBN, skv - k0);
    __syncthreads();           // the last tile's p @ V is done with kv_s
    load_tile<T, DMAX>(kv_s, kb + (long long)k0 * kss, kss, k_rows, d, 1.0f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < DMAX; c += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_s + (ty + 16 * i) * QP + c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(kv_s + (tx + 16 * j) * QP + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += qv[i].x * kv[j].x;
          s[i][j] += qv[i].y * kv[j].y;
          s[i][j] += qv[i].z * kv[j].z;
          s[i][j] += qv[i].w * kv[j].w;
        }
    }

    // mask, then one online-softmax step per row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q_offset + q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = tx + 16 * j;
        const int k_pos = k0 + kj;
        float x = s[i][j];
        if (kj >= k_rows) {
          x = -INFINITY;       // no such key: p is exactly 0
        } else if ((causal && q_pos < k_pos) ||
                   (window > 0 && k_pos <= q_pos - window)) {
          x = kNegInf;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], half_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[(ty + 16 * i) * PP + tx + 16 * j] = p;
        sum += p;
      }
      alpha[i] = expf(m[i] - m_new);
      l[i] = l[i] * alpha[i] + half_sum(sum);
      m[i] = m_new;
    }
    __syncthreads();           // every score read K; p_s is complete
    load_tile<T, DMAX>(kv_s, vb + (long long)k0 * vss, vss, k_rows, d, 1.0f);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha[i];
#pragma unroll 2
    for (int n = 0; n < kBN; n += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(p_s + (ty + 16 * i) * PP + n);
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(
              kv_s + (n + nn) * QP + 64 * c + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = nn == 0   ? pv[i].x
                            : nn == 1 ? pv[i].y
                            : nn == 2 ? pv[i].z
                                      : pv[i].w;
            acc[i][c][0] += p * vv.x;
            acc[i][c][1] += p * vv.y;
            acc[i][c][2] += p * vv.z;
            acc[i][c][3] += p * vv.w;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= q_rows) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = out + b * osb + h * osh + (long long)(q0 + r) * oss;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 64 * c + 4 * tx + e;
        if (col < d) store(orow + col, acc[i][c][e] / den);
      }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* out,
           int batch, int heads, int groups, int sq, int skv, int d,
           const long long* st, int causal, int window, int q_offset,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<DMAX>();
  auto kernel = flash_kernel<T, DMAX>;
  static bool configured = false;   // once, before any graph capture
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((sq + kBM - 1) / kBM, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, groups, sq, skv, d,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             int batch, int heads, int groups, int sq, int skv, int d,
             const long long* st, int causal, int window, int q_offset,
             float scale, cudaStream_t stream) {
  if (d <= 64)
    return launch<T, 64>(q, k, v, out, batch, heads, groups, sq, skv, d, st,
                         causal, window, q_offset, scale, stream);
  return launch<T, 128>(q, k, v, out, batch, heads, groups, sq, skv, d, st,
                        causal, window, q_offset, scale, stream);
}

}  // namespace

// q: [B, H, Sq, D], k/v: [B, Hkv, Skv, D], out: [B, H, Sq, D], all of
// one dtype (float32, or bfloat16 when bf16), addressed by element
// strides (batch, head, row) with a contiguous last dimension.
extern "C" int etica_flash_attention(
    const void* q, const void* k, const void* v, void* out, int batch,
    int heads, int hkv, int sq, int skv, int d, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss, long long vsb,
    long long vsh, long long vss, long long osb, long long osh, long long oss,
    int causal, int window, int q_offset, float scale, int bf16,
    void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0 || d <= 0) return 0;
  if (hkv <= 0 || heads % hkv || skv <= 0 || d > kMaxHeadDim ||
      q_offset < 0 || heads > 65535 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const long long st[12] = {qsb, qsh, qss, ksb, ksh, kss,
                            vsb, vsh, vss, osb, osh, oss};
  cudaStream_t s = (cudaStream_t)stream;
  const int groups = heads / hkv;
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, out, batch, heads, groups, sq,
                                   skv, d, st, causal, window, q_offset,
                                   scale, s);
  return dispatch<float>(q, k, v, out, batch, heads, groups, sq, skv, d, st,
                         causal, window, q_offset, scale, s);
}
