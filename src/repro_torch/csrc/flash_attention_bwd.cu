// flash_attention_bwd: the backward of blocked causal / sliding-window
// flash attention.
//
// Replaces no Pallas kernel: the JAX package's gradient differentiates
// the jnp scan `blocked_attention` (src/repro/models/attention.py:75)
// under jax.checkpoint. The port's forward on the card is the hand
// flash_attention kernel (flash_attention.cu, flash_attention_sm90.cu),
// whose output carries no autograd graph, so training needs this kernel
// behind the torch.autograd.Function of kernels/flash_attention/ops.py.
//
// For batch b, query head h (KV head h / G, G = H / Hkv), with q scaled
// in float32 (qs = q·D^-½), s = qs·kᵀ masked to -1e30 as the forward
// masks it (causal keeps q_pos >= k_pos, window > 0 keeps k_pos > q_pos
// - window, q_pos = q_offset + i), P = exp(s - m) / max(l, 1e-30) with
// m the row max and l the row sum of exp(s - m):
//
//   dV = Pᵀ·dO,  dP = dO·Vᵀ,  dS = P∘(dP - delta) where unmasked, else 0,
//   delta = rowsum(dO∘O),  dQ = dS·K·D^-½,  dK = dSᵀ·qs,
//
// summed over the G query heads of each KV head for dK and dV. A masked
// score is a constant, so its dS is 0; its P is not (a row whose window
// keeps no key averages V over every key, as the forward does), so dV
// takes it. Row statistics are kept as m and l, not as one log-sum-exp:
// -1e30 + log(l) rounds back to -1e30 in float32, which would give such a
// row P = 1 in place of 1 / Skv.
//
// Three kernels in one launch sequence, no atomics, so the result is the
// same bits every run:
//   1. row_stats (grid: q tiles x H x B) recomputes each row's m and l
//      with the forward's online softmax over the KV tiles the forward
//      visits, and delta from dO and O;
//   2. kv_pass (grid: KV tiles x Hkv x B) owns 64 keys: for each of the
//      G query heads and each q tile whose visited range holds this KV
//      tile, it recomputes S and dP, forms P and dS in shared memory and
//      accumulates dV += Pᵀ·dO and dK += dSᵀ·qs in registers; it writes
//      dk and dv once;
//   3. q_pass (grid: q tiles x H x B) owns 64 query rows: over its
//      visited KV tiles it recomputes S, dP and dS and accumulates dQ +=
//      dS·K in registers; it writes dq once, times D^-½.
// The tiles visited are the forward's (flash_tiles.cuh): skipping a KV
// tile wholly masked for every row of a q tile is exact here too, since
// such a tile's P is exactly 0 and its dS is 0 (a block holding a row
// with no key visits every tile, as the forward).
//
// What bounds it on the H100: operations. At the training shape (B 2, H
// 32, S 2048, D 128, causal) the three passes run 8 products of S x S x
// D a head where the forward runs 2 (the row pass 1, kv_pass 4, q_pass
// 3): about 0.28 TFLOP against 0.13 GB of inputs and outputs. This
// first version runs them as float32 FMAs on the CUDA cores (67
// TFLOP/s peak), one block of 256 threads an SM (170 KB of shared
// memory at D 128). It is the `cuda_cores` route, for float32 and the
// head dims the `wgmma` route does not take; bf16 with D a multiple of
// 16 goes to flash_attention_bwd_sm90.cu, which runs on the forward's
// saved row statistics and the tensor cores.
//
// Layout: thread (ty, tx) of a 16 x 16 grid owns tile rows ty + 16i (i <
// 4) and, for a [64 x 64] score tile, keys tx + 16j (j < 4); for a [64 x
// D] accumulator, columns 64c + 4tx + e (e < 4, c < D/64). Rows are
// zero-padded to 64 or 128 columns (D <= 128); rows past Sq or Skv load
// as zeros, their P and dS are 0, and they are not stored. Only the last
// dimension of each operand must be contiguous: the kernels take the
// other three strides of q, k, v, out, dout, dq, dk and dv.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_tiles.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kB = 64;          // query rows of a q tile, keys of a KV tile
constexpr int kPP = kB + 4;     // pitch of a [64 x 64] P or dS tile
constexpr int kMaxHeadDim = 128;
constexpr float kNegInf = -1e30f;

// element strides (batch, head, row) of each operand
enum { kQ, kK, kV, kO, kDO, kDQ, kDK, kDV, kOperands };
struct Strides {
  long long s[kOperands][3];
};

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
  return DMAX + 4;              // float4-aligned rows
}

template <typename T>
__device__ __forceinline__ const T* at(const T* base, const Strides& st,
                                       int op, int b, int h, long long r) {
  return base + b * st.s[op][0] + h * st.s[op][1] + r * st.s[op][2];
}

template <typename T>
__device__ __forceinline__ T* at(T* base, const Strides& st, int op, int b,
                                 int h, long long r) {
  return base + b * st.s[op][0] + h * st.s[op][1] + r * st.s[op][2];
}

// rows [0, 64) of a [rows, d] tile at src (row stride `stride`) into
// dst[64][row_pitch] as float32 times mul; zero past `rows` and past d
template <typename T, int DMAX>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride, int rows, int d,
                                          float mul) {
  constexpr int kPer = kB * DMAX / kThreads;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = threadIdx.x + u * kThreads;
    const int r = i / DMAX, c = i % DMAX;
    float x = 0.0f;
    if (r < rows && c < d) x = to_f32(src[r * stride + c]) * mul;
    dst[r * row_pitch<DMAX>() + c] = x;
  }
}

// acc[i][j] = a[ty + 16i] · b[tx + 16j] over DMAX columns: a [64 x 64]
// product tile of two staged [64][row_pitch] tiles
template <int DMAX>
__device__ __forceinline__ void tile_dots(const float* a, const float* b,
                                          int tx, int ty, float acc[4][4]) {
  constexpr int P = row_pitch<DMAX>();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int c = 0; c < DMAX; c += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * P + c);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * P + c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] += av[i].x * bv[j].x;
        acc[i][j] += av[i].y * bv[j].y;
        acc[i][j] += av[i].z * bv[j].z;
        acc[i][j] += av[i].w * bv[j].w;
      }
  }
}

__device__ __forceinline__ bool masked(int q_pos, int k_pos, int causal,
                                       int window) {
  return (causal && q_pos < k_pos) || (window > 0 && k_pos <= q_pos - window);
}

// P and dS of one [64 x 64] tile from its scores s and dP, the rows'
// statistics (m, 1 / max(l, 1e-30), delta) and the masks; rows past
// q_rows and keys past k_rows get P = dS = 0
__device__ __forceinline__ void p_and_ds(float s[4][4], float dp[4][4],
                                         const float m[4], const float il[4],
                                         const float dl[4], int q_pos0,
                                         int k0, int q_rows, int k_rows,
                                         int tx, int ty, int causal,
                                         int window) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kj = tx + 16 * j;
      float p = 0.0f, ds = 0.0f;
      if (r < q_rows && kj < k_rows) {
        const bool drop = masked(q_pos0 + r, k0 + kj, causal, window);
        p = expf((drop ? kNegInf : s[i][j]) - m[i]) * il[i];
        ds = drop ? 0.0f : p * (dp[i][j] - dl[i]);
      }
      s[i][j] = p;
      dp[i][j] = ds;
    }
  }
}

template <int DMAX>
size_t row_smem() {
  return sizeof(float) * 2 * kB * row_pitch<DMAX>();
}

template <int DMAX>
size_t kv_smem() {
  return sizeof(float) * (4 * kB * row_pitch<DMAX>() + 2 * kB * kPP);
}

template <int DMAX>
size_t q_smem() {
  return sizeof(float) * (4 * kB * row_pitch<DMAX>() + kB * kPP);
}

// 1. each query row's m and l (the forward's online softmax) and delta
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) row_stats(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ out, const T* __restrict__ dout,
    float* __restrict__ m_out, float* __restrict__ l_out,
    float* __restrict__ delta_out, int groups, int sq, int skv, int d,
    Strides st, int causal, int window, int q_offset, float scale) {
  constexpr int P = row_pitch<DMAX>();
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // [kB][P]
  float* k_s = q_s + kB * P;                       // [kB][P]
  const int q0 = blockIdx.x * kB;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / groups;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q_rows = min(kB, sq - q0);
  const long long stat0 = ((long long)b * gridDim.y + h) * sq + q0;

  // delta = rowsum(dO∘O), 16 lanes a row
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    float acc = 0.0f;
    if (r < q_rows) {
      const T* o_row = at(out, st, kO, b, h, q0 + r);
      const T* do_row = at(dout, st, kDO, b, h, q0 + r);
      for (int c = tx; c < d; c += 16)
        acc += to_f32(do_row[c]) * to_f32(o_row[c]);
    }
    acc = half_sum(acc);
    if (tx == 0 && r < q_rows) delta_out[stat0 + r] = acc;
  }

  int kt_lo, kt_hi;
  flash_kv_tiles(q0, q_rows, skv, kB, causal, window, q_offset, &kt_lo,
                 &kt_hi);
  load_tile<T, DMAX>(q_s, at(q, st, kQ, b, h, q0), st.s[kQ][2], q_rows, d,
                     scale);
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
  }
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kB;
    const int k_rows = min(kB, skv - k0);
    __syncthreads();            // the last tile's scores are done with k_s
    load_tile<T, DMAX>(k_s, at(k, st, kK, b, hk, k0), st.s[kK][2], k_rows,
                       d, 1.0f);
    __syncthreads();
    float s[4][4];
    tile_dots<DMAX>(q_s, k_s, tx, ty, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q_offset + q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = tx + 16 * j;
        float x = s[i][j];
        if (kj >= k_rows)
          x = -INFINITY;        // no such key: exp gives exactly 0
        else if (masked(q_pos, k0 + kj, causal, window))
          x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], half_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + half_sum(sum);
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (tx == 0 && r < q_rows) {
      m_out[stat0 + r] = m[i];
      l_out[stat0 + r] = l[i];
    }
  }
}

// 2. dK and dV of one KV tile, over the G query heads and the q tiles
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads, 1) kv_pass(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ m_in, const float* __restrict__ l_in,
    const float* __restrict__ delta_in, T* __restrict__ dk,
    T* __restrict__ dv, int groups, int heads, int sq, int skv, int d,
    Strides st, int causal, int window, int q_offset, float scale) {
  constexpr int P = row_pitch<DMAX>();
  constexpr int NC = DMAX / 64;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);   // [kB][P]
  float* v_s = k_s + kB * P;                       // [kB][P]
  float* q_s = v_s + kB * P;                       // [kB][P], scaled
  float* do_s = q_s + kB * P;                      // [kB][P]
  float* p_s = do_s + kB * P;                      // [kB][kPP]
  float* ds_s = p_s + kB * kPP;                    // [kB][kPP]
  const int kt = blockIdx.x, k0 = kt * kB;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k_rows = min(kB, skv - k0);

  load_tile<T, DMAX>(k_s, at(k, st, kK, b, hk, k0), st.s[kK][2], k_rows, d,
                     1.0f);
  load_tile<T, DMAX>(v_s, at(v, st, kV, b, hk, k0), st.s[kV][2], k_rows, d,
                     1.0f);
  float acc_k[4][NC][4], acc_v[4][NC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_k[i][c][e] = acc_v[i][c][e] = 0.0f;

  const int n_qt = (sq + kB - 1) / kB;
  for (int g = 0; g < groups; ++g) {
    const int h = hk * groups + g;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * kB;
      const int q_rows = min(kB, sq - q0);
      int lo, hi;
      flash_kv_tiles(q0, q_rows, skv, kB, causal, window, q_offset, &lo,
                     &hi);
      if (kt < lo || kt > hi) continue;   // the same for the whole block
      __syncthreads();          // the last q tile's sums are done
      load_tile<T, DMAX>(q_s, at(q, st, kQ, b, h, q0), st.s[kQ][2], q_rows,
                         d, scale);
      load_tile<T, DMAX>(do_s, at(dout, st, kDO, b, h, q0), st.s[kDO][2],
                         q_rows, d, 1.0f);
      __syncthreads();
      float s[4][4], dp[4][4], m[4], il[4], dl[4];
      const long long stat0 = ((long long)b * heads + h) * sq + q0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const bool ok = r < q_rows;
        m[i] = ok ? m_in[stat0 + r] : 0.0f;
        il[i] = ok ? 1.0f / fmaxf(l_in[stat0 + r], 1e-30f) : 0.0f;
        dl[i] = ok ? delta_in[stat0 + r] : 0.0f;
      }
      tile_dots<DMAX>(q_s, k_s, tx, ty, s);
      tile_dots<DMAX>(do_s, v_s, tx, ty, dp);
      p_and_ds(s, dp, m, il, dl, q_offset + q0, k0, q_rows, k_rows, tx, ty,
               causal, window);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p_s[(ty + 16 * i) * kPP + tx + 16 * j] = s[i][j];
          ds_s[(ty + 16 * i) * kPP + tx + 16 * j] = dp[i][j];
        }
      __syncthreads();
      // this thread's keys ty + 16i: dV += P[n, key]·dO[n], dK += dS[n, key]·qs[n]
#pragma unroll 2
      for (int n = 0; n < kB; ++n) {
        float pv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = p_s[n * kPP + ty + 16 * i];
          dsv[i] = ds_s[n * kPP + ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 dov = *reinterpret_cast<const float4*>(
              do_s + n * P + 64 * c + 4 * tx);
          const float4 qv = *reinterpret_cast<const float4*>(
              q_s + n * P + 64 * c + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_v[i][c][0] += pv[i] * dov.x;
            acc_v[i][c][1] += pv[i] * dov.y;
            acc_v[i][c][2] += pv[i] * dov.z;
            acc_v[i][c][3] += pv[i] * dov.w;
            acc_k[i][c][0] += dsv[i] * qv.x;
            acc_k[i][c][1] += dsv[i] * qv.y;
            acc_k[i][c][2] += dsv[i] * qv.z;
            acc_k[i][c][3] += dsv[i] * qv.w;
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= k_rows) continue;
    T* dk_row = at(dk, st, kDK, b, hk, k0 + r);
    T* dv_row = at(dv, st, kDV, b, hk, k0 + r);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 64 * c + 4 * tx + e;
        if (col < d) {
          store(dk_row + col, acc_k[i][c][e]);
          store(dv_row + col, acc_v[i][c][e]);
        }
      }
  }
}

// 3. dQ of one q tile over its visited KV tiles
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads, 1) q_pass(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ m_in, const float* __restrict__ l_in,
    const float* __restrict__ delta_in, T* __restrict__ dq, int groups,
    int sq, int skv, int d, Strides st, int causal, int window,
    int q_offset, float scale) {
  constexpr int P = row_pitch<DMAX>();
  constexpr int NC = DMAX / 64;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // [kB][P], scaled
  float* do_s = q_s + kB * P;                      // [kB][P]
  float* k_s = do_s + kB * P;                      // [kB][P]
  float* v_s = k_s + kB * P;                       // [kB][P]
  float* ds_s = v_s + kB * P;                      // [kB][kPP]
  const int q0 = blockIdx.x * kB;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / groups;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q_rows = min(kB, sq - q0);
  const long long stat0 = ((long long)b * gridDim.y + h) * sq + q0;

  int kt_lo, kt_hi;
  flash_kv_tiles(q0, q_rows, skv, kB, causal, window, q_offset, &kt_lo,
                 &kt_hi);
  load_tile<T, DMAX>(q_s, at(q, st, kQ, b, h, q0), st.s[kQ][2], q_rows, d,
                     scale);
  load_tile<T, DMAX>(do_s, at(dout, st, kDO, b, h, q0), st.s[kDO][2], q_rows,
                     d, 1.0f);
  float m[4], il[4], dl[4], acc[4][NC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const bool ok = r < q_rows;
    m[i] = ok ? m_in[stat0 + r] : 0.0f;
    il[i] = ok ? 1.0f / fmaxf(l_in[stat0 + r], 1e-30f) : 0.0f;
    dl[i] = ok ? delta_in[stat0 + r] : 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.0f;
  }
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kB;
    const int k_rows = min(kB, skv - k0);
    __syncthreads();            // the last tile's dS·K is done
    load_tile<T, DMAX>(k_s, at(k, st, kK, b, hk, k0), st.s[kK][2], k_rows,
                       d, 1.0f);
    load_tile<T, DMAX>(v_s, at(v, st, kV, b, hk, k0), st.s[kV][2], k_rows,
                       d, 1.0f);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dots<DMAX>(q_s, k_s, tx, ty, s);
    tile_dots<DMAX>(do_s, v_s, tx, ty, dp);
    p_and_ds(s, dp, m, il, dl, q_offset + q0, k0, q_rows, k_rows, tx, ty,
             causal, window);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ds_s[(ty + 16 * i) * kPP + tx + 16 * j] = dp[i][j];
    __syncthreads();
    // this thread's rows ty + 16i: dQ += dS[row, n]·K[n]
#pragma unroll 2
    for (int n = 0; n < kB; n += 4) {
      float4 dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dsv[i] = *reinterpret_cast<const float4*>(ds_s + (ty + 16 * i) * kPP +
                                                  n);
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 kv = *reinterpret_cast<const float4*>(
              k_s + (n + nn) * P + 64 * c + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float x = nn == 0   ? dsv[i].x
                            : nn == 1 ? dsv[i].y
                            : nn == 2 ? dsv[i].z
                                      : dsv[i].w;
            acc[i][c][0] += x * kv.x;
            acc[i][c][1] += x * kv.y;
            acc[i][c][2] += x * kv.z;
            acc[i][c][3] += x * kv.w;
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= q_rows) continue;
    T* dq_row = at(dq, st, kDQ, b, h, q0 + r);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 64 * c + 4 * tx + e;
        if (col < d) store(dq_row + col, acc[i][c][e] * scale);
      }
  }
}

template <typename K>
int allow_smem(K kernel, size_t bytes, bool* configured) {
  if (*configured) return 0;     // once, before any graph capture
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  *configured = true;
  return 0;
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, void* dq, void* dk, void* dv, float* m,
           float* l, float* delta, int batch, int heads, int hkv, int sq,
           int skv, int d, const Strides& st, int causal, int window,
           int q_offset, float scale, cudaStream_t stream) {
  static bool configured[3] = {false, false, false};
  int err = allow_smem(row_stats<T, DMAX>, row_smem<DMAX>(), &configured[0]);
  if (!err) err = allow_smem(kv_pass<T, DMAX>, kv_smem<DMAX>(), &configured[1]);
  if (!err) err = allow_smem(q_pass<T, DMAX>, q_smem<DMAX>(), &configured[2]);
  if (err) return err;
  const int groups = heads / hkv;
  const dim3 q_grid((sq + kB - 1) / kB, heads, batch);
  const dim3 kv_grid((skv + kB - 1) / kB, hkv, batch);
  row_stats<T, DMAX><<<q_grid, kThreads, row_smem<DMAX>(), stream>>>(
      (const T*)q, (const T*)k, (const T*)out, (const T*)dout, m, l, delta,
      groups, sq, skv, d, st, causal, window, q_offset, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  kv_pass<T, DMAX><<<kv_grid, kThreads, kv_smem<DMAX>(), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, m, l, delta,
      (T*)dk, (T*)dv, groups, heads, sq, skv, d, st, causal, window,
      q_offset, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  q_pass<T, DMAX><<<q_grid, kThreads, q_smem<DMAX>(), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, m, l, delta,
      (T*)dq, groups, sq, skv, d, st, causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* out,
             const void* dout, void* dq, void* dk, void* dv, float* m,
             float* l, float* delta, int batch, int heads, int hkv, int sq,
             int skv, int d, const Strides& st, int causal, int window,
             int q_offset, float scale, cudaStream_t stream) {
  if (d <= 64)
    return launch<T, 64>(q, k, v, out, dout, dq, dk, dv, m, l, delta, batch,
                         heads, hkv, sq, skv, d, st, causal, window,
                         q_offset, scale, stream);
  return launch<T, 128>(q, k, v, out, dout, dq, dk, dv, m, l, delta, batch,
                        heads, hkv, sq, skv, d, st, causal, window, q_offset,
                        scale, stream);
}

}  // namespace

// q, out, dout, dq: [B, H, Sq, D]; k, v, dk, dv: [B, Hkv, Skv, D], all
// of one dtype (float32, or bfloat16 when bf16), addressed by element
// strides (batch, head, row) with a contiguous last dimension: `strides`
// holds 24 of them, three each for q, k, v, out, dout, dq, dk and dv.
// m, l and delta are float32 scratch [B, H, Sq], contiguous. Writes every
// element of dq, dk and dv.
extern "C" int etica_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, void* dq, void* dk, void* dv, float* m, float* l,
    float* delta, int batch, int heads, int hkv, int sq, int skv, int d,
    const long long* strides, int causal, int window, int q_offset,
    float scale, int bf16, void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0 || skv <= 0 || d <= 0) return 0;
  if (hkv <= 0 || heads % hkv || d > kMaxHeadDim || q_offset < 0 ||
      heads > 65535 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  Strides st;
  for (int o = 0; o < kOperands; ++o)
    for (int j = 0; j < 3; ++j) st.s[o][j] = strides[3 * o + j];
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, out, dout, dq, dk, dv, m, l,
                                   delta, batch, heads, hkv, sq, skv, d, st,
                                   causal, window, q_offset, scale, s);
  return dispatch<float>(q, k, v, out, dout, dq, dk, dv, m, l, delta, batch,
                         heads, hkv, sq, skv, d, st, causal, window, q_offset,
                         scale, s);
}
