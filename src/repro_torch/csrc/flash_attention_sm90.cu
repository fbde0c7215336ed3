// flash_attention_sm90: the bf16 route of flash_attention, on Hopper's
// tensor cores.
//
// Replaces, for bf16 operands with head_dim D a multiple of 16 up to 128,
// the Pallas kernel `_kernel` / `flash_attention` of
// src/repro/kernels/flash_attention/kernel.py, and computes what the
// first version (flash_attention.cu, which keeps float32 and the other
// head dims) computes: for batch b, query head h (KV head h / G) and
// query row i at absolute position q_pos = q_offset + i,
//
//   out[b, h, i] = softmax_j(q_i·scale · k_j) @ v_j,   scale = D^-0.5,
//
// with a score of -1e30 where the mask drops a key (causal keeps q_pos
// >= k_pos, window > 0 keeps k_pos > q_pos - window), the running (m, l,
// acc) in float32, and acc / max(l, 1e-30) rounded to bf16 at the end.
// The tile skipping is the first version's, and exact for the same
// reason (flash_attention.cu's header): a block visits the KV tiles from
// the window's first to the diagonal's last, or every tile when one of
// its rows keeps no key.
//
// What bounds it on the H100: operations. At the prefill shape (B 4, H
// 32, S 4096, D 128, causal) the two products are 0.55 TFLOP against
// 0.27 GB, about 2,000 operations a byte. So both products run as
// wgmma.mma_async with bf16 operands and float32 accumulators, the only
// way to the 989 TFLOP/s bf16 tensor-core rate.
//
// Numerics (each step within the one-bf16-ulp bar of the plain version,
// which scales q in float32 and keeps p in float32):
//   * scores: q·k of the unscaled bf16 operands (exact products, float32
//     sums), then one float32 multiply by scale·log2(e); the softmax runs
//     in base 2 (ex2), with the -1e30 mask value and the initial m set in
//     that domain, so a masked entry still gives exactly 0 after a real
//     score and the same constant before one;
//   * p·V: p is split into p_hi = bf16(p) and p_lo = bf16(p - p_hi), and
//     both halves go through the tensor cores against the same V tile
//     (p_hi + p_lo carries p to about 2^-17; one bf16 p would leave 2^-9
//     of every term, which breaks the 2e-5 floor on outputs that cancel);
//   * accumulation: acc is rescaled by alpha in registers and the tensor
//     cores add p·V into it (the wgmma accumulator). Their float32 sums
//     are coarser than FMAs (more outputs land one bf16 ulp off the
//     plain version: PERF.md, Findings) but stay within the bar; a separate
//     register tile per KV tile would cost 64 registers, which spill at
//     ptxas's 168 a thread.
//
// Design: grid (Sq / 128 q tiles in reverse order, H, B); 384 threads:
// warpgroups 0 and 1 are consumers, each owning 64 query rows (registers
// raised to 240 with setmaxnreg); warpgroup 2 is the producer (lowered to
// 24), one thread of which issues every TMA load. Q (128 rows), and K
// and V (128-key tiles, a ring of two stages), reach shared memory by
// TMA as 64-column halves in the 128-byte swizzle that wgmma reads;
// mbarriers carry "K full", "V full" (transaction bytes) and "stage
// empty" (one arrival per consumer warpgroup). Tensor maps are 4-d (D,
// S, heads, batch) over the caller's strides, so the model's [B, S, H,
// D] views go in as they are; rows past S and columns past D read as
// zeros (a key past Skv is also scored -inf, so its p is exactly 0).
// Head dims up to 64 are padded to 64, the others to 128, with those
// zeros. S = Q·K^T is 8 (or 4) m64n128k16 wgmmas from shared memory; p·V
// is 16 m64n128k16 (or m64n64k16) wgmmas with A (p_hi, p_lo) from
// registers in the accumulator's own fragment layout and B = V read
// transposed (MN-major). The output is stored from registers, rows past
// Sq and columns past D skipped; on request each row's final m and l
// (base 2) are stored beside it for the backward
// (flash_attention_bwd_sm90.cu), the output the same bits either way. A
// wait that exceeds 4 s traps instead of hanging the card. The mbarrier,
// TMA and wgmma helpers are in sm90.cuh, shared with the backward.
#include "flash_tiles.cuh"
#include "sm90.cuh"

namespace {

constexpr int kBM = 128;              // query rows a block
constexpr int kBN = 128;              // keys a KV tile
constexpr int kStages = 2;            // K/V ring
constexpr int kThreads = 384;         // 2 consumer + 1 producer warpgroups
constexpr int kMaxHeadDim = 128;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr uint32_t kHalfQ = kBM * 128;    // bytes of a 64-column Q half
constexpr uint32_t kHalfKV = kBN * 128;   // bytes of a 64-column K/V half

// ---- the kernel -------------------------------------------------------

template <int DP>   // head dim padded to 64 or 128
__global__ void __launch_bounds__(kThreads, 1) flash_sm90_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ stats, int groups, int sq, int skv, int d,
    long long osb, long long osh, long long oss, int causal, int window,
    int q_offset, float scale_log2) {
  constexpr int NH = DP / 64;                  // 64-column halves
  constexpr uint32_t kQBytes = NH * kHalfQ;
  constexpr uint32_t kKVBytes = NH * kHalfKV;  // one K (or V) stage
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq_ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq_ + kQBytes;
  const uint32_t sv = sk + kStages * kKVBytes;
  const uint32_t bars = sv + kStages * kKVBytes;
  const uint32_t bar_q = bars;
  auto bar_k = [&](int st) { return bars + 8u * (1 + st); };
  auto bar_v = [&](int st) { return bars + 8u * (1 + kStages + st); };
  auto bar_e = [&](int st) { return bars + 8u * (1 + 2 * kStages + st); };

  const int n_qt = (sq + kBM - 1) / kBM;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kBM;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / groups;
  const int q_rows = min(kBM, sq - q0);

  int kt_lo, kt_hi;
  flash_kv_tiles(q0, q_rows, skv, kBN, causal, window, q_offset, &kt_lo,
                 &kt_hi);
  const int n_kt = kt_hi - kt_lo + 1;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_k(st), 1);
      mbar_init(bar_v(st), 1);
      mbar_init(bar_e(st), 2);        // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every load --------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 256) {
      mbar_expect_tx(bar_q, kQBytes);
#pragma unroll
      for (int c = 0; c < NH; ++c)
        tma_load(sq_ + c * kHalfQ, &tm_q, bar_q, 64 * c, q0, h, b);
      for (int i = 0; i < n_kt; ++i) {
        const int st = i % kStages;
        const int k0 = (kt_lo + i) * kBN;
        mbar_wait(bar_e(st), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_k(st), kKVBytes);
#pragma unroll
        for (int c = 0; c < NH; ++c)
          tma_load(sk + st * kKVBytes + c * kHalfKV, &tm_k, bar_k(st),
                   64 * c, k0, hk, b);
        mbar_expect_tx(bar_v(st), kKVBytes);
#pragma unroll
        for (int c = 0; c < NH; ++c)
          tma_load(sv + st * kKVBytes + c * kHalfKV, &tm_v, bar_v(st),
                   64 * c, k0, hk, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each -------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = tid % 128, warp = t / 32, lane = t % 32;
    const int r0 = 16 * warp + lane / 4;   // this thread's rows r0, r0 + 8
    const int cq = 2 * (lane % 4);         // its columns in each 8
    const int qp0 = q_offset + q0 + 64 * wg;   // position of row 0
    const uint32_t q_wg = sq_ + wg * 64 * 128;

    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
    mbar_wait(bar_q, 0);

    for (int i = 0; i < n_kt; ++i) {
      const int st = i % kStages;
      const uint32_t ph = (i / kStages) & 1;
      const int k0 = (kt_lo + i) * kBN;

      // S = Q K^T (unscaled), 64 x 128 float32
      float s[kBN / 2];
      mbar_wait(bar_k(st), ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32u;   // 16 columns in
        wgmma_ss_n128(
            s, desc_sw128(q_wg + (kk / 4) * kHalfQ + off, 16, 1024),
            desc_sw128(sk + st * kKVBytes + (kk / 4) * kHalfKV + off, 16,
                       1024),
            kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // scale (base 2) and mask, then one online-softmax step per row
      float mx[2] = {m[0], m[1]};
      const bool whole = k0 + kBN <= skv &&
                         (!causal || k0 + kBN - 1 <= qp0) &&
                         (window <= 0 || k0 > qp0 + 63 - window);
      if (whole) {
#pragma unroll
        for (int e = 0; e < kBN / 2; ++e) {
          s[e] *= scale_log2;
          mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < kBN / 2; ++e) {
          const int r = (e >> 1) & 1;
          const int k_pos = k0 + 8 * (e / 4) + cq + (e & 1);
          const int q_pos = qp0 + r0 + 8 * r;
          float x = s[e] * scale_log2;
          if (k_pos >= skv) {
            x = -INFINITY;             // no such key: p is exactly 0
          } else if ((causal && q_pos < k_pos) ||
                     (window > 0 && k_pos <= q_pos - window)) {
            x = kNegInf;
          }
          s[e] = x;
          mx[r] = fmaxf(mx[r], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = ex2(m[r] - mx[r]);
        m[r] = mx[r];
      }
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int e = 0; e < kBN / 2; ++e) {
        s[e] = ex2(s[e] - m[(e >> 1) & 1]);
        sum[(e >> 1) & 1] += s[e];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = l[r] * alpha[r] + sum[r];
      }

      // p = p_hi + p_lo as bf16 pairs, in the A fragment layout: for keys
      // 16kk..16kk+15 the registers are the pairs 4kk .. 4kk + 3
      uint32_t p_hi[kBN / 4], p_lo[kBN / 4];
#pragma unroll
      for (int j = 0; j < kBN / 4; ++j) {
        const __nv_bfloat162 hi = __floats2bfloat162_rn(s[2 * j], s[2 * j + 1]);
        const float2 hf = __bfloat1622float2(hi);
        p_hi[j] = bf16x2_bits(hi);
        p_lo[j] = bf16x2_bits(
            __floats2bfloat162_rn(s[2 * j] - hf.x, s[2 * j + 1] - hf.y));
      }

      // acc = acc·alpha, then acc += p_hi·V + p_lo·V on the tensor cores,
      // V read MN-major
#pragma unroll
      for (int e = 0; e < DP / 2; ++e) acc[e] *= alpha[(e >> 1) & 1];
      mbar_wait(bar_v(st), ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        const uint64_t dv =
            desc_sw128(sv + st * kKVBytes + kk * 2048, kHalfKV, 1024);
        const uint32_t a_hi[4] = {p_hi[4 * kk], p_hi[4 * kk + 1],
                                  p_hi[4 * kk + 2], p_hi[4 * kk + 3]};
        const uint32_t a_lo[4] = {p_lo[4 * kk], p_lo[4 * kk + 1],
                                  p_lo[4 * kk + 2], p_lo[4 * kk + 3]};
        if constexpr (DP == 128) {
          wgmma_rs_n128(acc, a_hi, dv, 1);
          wgmma_rs_n128(acc, a_lo, dv, 1);
        } else {
          wgmma_rs_n64(acc, a_hi, dv, 1);
          wgmma_rs_n64(acc, a_lo, dv, 1);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      if (t == 0) mbar_arrive(bar_e(st));   // K and V of this stage read
    }

    // out = acc / max(l, 1e-30) in bf16; rows past Sq, columns past D skipped
    const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
    __nv_bfloat16* ob = out + b * osb + h * osh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + 64 * wg + r0 + 8 * r;
      if (row >= sq) continue;
      __nv_bfloat16* orow = ob + (long long)row * oss;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + cq;
        if (col < d)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(__fdiv_rn(acc[4 * j + 2 * r], den[r]),
                                    __fdiv_rn(acc[4 * j + 2 * r + 1], den[r]));
      }
    }

    // the rows' m and l (base 2), when asked for: [2, B, H, Sq] float32;
    // the four threads of a row's quad hold the same values
    if (stats != nullptr && cq == 0) {
      const long long plane = (long long)gridDim.z * gridDim.y * sq;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + 64 * wg + r0 + 8 * r;
        if (row >= sq) continue;
        const long long at = ((long long)b * gridDim.y + h) * sq + row;
        stats[at] = m[r];
        stats[plane + at] = l[r];
      }
    }
  }
}

// ---- host side ----------------------------------------------------------

// dynamic shared memory: 1024-byte alignment slack, Q, the K and V
// stages, the mbarriers
template <int DP>
constexpr size_t smem_bytes() {
  return 1024 + (DP / 64) * (kHalfQ + 2 * kStages * kHalfKV) +
         8 * (1 + 3 * kStages);
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* out,
           float* stats, int batch, int heads, int hkv, int sq, int skv, int d,
           const long long* st, int causal, int window, int q_offset,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP>();
  auto kernel = flash_sm90_kernel<DP>;
  static bool configured = false;   // once, before any graph capture
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, d, sq, heads, batch, st[0], st[1], st[2], kBM) ||
      !make_map(&mk, k, d, skv, hkv, batch, st[3], st[4], st[5], kBN) ||
      !make_map(&mv, v, d, skv, hkv, batch, st[6], st[7], st[8], kBN))
    return (int)cudaErrorInvalidValue;
  dim3 grid((sq + kBM - 1) / kBM, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)out, stats, heads / hkv, sq, skv, d, st[9],
      st[10], st[11], causal, window, q_offset, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// q: [B, H, Sq, D], k/v: [B, Hkv, Skv, D], out: [B, H, Sq, D], bfloat16,
// addressed by element strides (batch, head, row) with a contiguous last
// dimension; D a multiple of 16 up to 128, every pointer 16-byte aligned
// and every stride a multiple of 8 elements (TMA's 16 bytes). `stats`,
// when not null, receives each row's m and l, float32 [2, B, H, Sq]
// contiguous, in the base-2 domain of the kernel's softmax: m the row's
// largest score times scale·log2(e) (-1e30 where the mask keeps no key),
// l the sum of 2^(score·scale·log2(e) - m) over the visited keys; the
// output is the same bits either way.
extern "C" int etica_flash_attention_sm90(
    const void* q, const void* k, const void* v, void* out, void* stats,
    int batch,
    int heads, int hkv, int sq, int skv, int d, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss, long long vsb,
    long long vsh, long long vss, long long osb, long long osh, long long oss,
    int causal, int window, int q_offset, float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0 || d <= 0) return 0;
  const long long st[12] = {qsb, qsh, qss, ksb, ksh, kss,
                            vsb, vsh, vss, osb, osh, oss};
  const int extent[9] = {batch, heads, sq, batch, hkv, skv, batch, hkv, skv};
  bool aligned = true;
  for (int i = 0; i < 9; ++i)
    aligned = aligned && (extent[i] == 1 || st[i] % 8 == 0);
  const void* ptrs[3] = {q, k, v};
  for (const void* p : ptrs)
    aligned = aligned && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  if (hkv <= 0 || heads % hkv || skv <= 0 || d % 16 || d > kMaxHeadDim ||
      q_offset < 0 || heads > 65535 || batch > 65535 || !aligned)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= 64)
    return launch<64>(q, k, v, out, (float*)stats, batch, heads, hkv, sq, skv,
                      d, st, causal, window, q_offset, scale, s);
  return launch<128>(q, k, v, out, (float*)stats, batch, heads, hkv, sq, skv,
                     d, st, causal, window, q_offset, scale, s);
}

// bytes of dynamic shared memory a launch at head dim d takes
extern "C" int etica_flash_attention_sm90_smem(int d) {
  return (int)(d <= 64 ? smem_bytes<64>() : smem_bytes<128>());
}
