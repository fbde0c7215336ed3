// flash_attention_bwd_sm90: the bf16 route of flash_attention_bwd, on
// Hopper's tensor cores.
//
// Replaces no Pallas kernel (the JAX package differentiates the jnp scan
// `blocked_attention`, src/repro/models/attention.py:75). It is the
// `wgmma` route of the backward, for bf16 q, k and v with head dim D a
// multiple of 16 up to 128, and pairs with the forward's `wgmma` route
// (flash_attention_sm90.cu) by the same test; flash_attention_bwd.cu
// keeps float32 and the other head dims. It computes what that file's
// header defines: for batch b, query head h (KV head h / G),
//
//   dV = Pᵀ·dO,  dP = dO·Vᵀ,  dS = P∘(dP - delta) where unmasked, else 0,
//   delta = rowsum(dO∘O),  dQ = dS·K·D^-½,  dK = dSᵀ·q·D^-½,
//
// summed over the G query heads of each KV head for dK and dV, with P the
// forward's softmax (masked scores -1e30, a row whose window keeps no key
// averaging V over every key).
//
// The forward saves each row's m and l (its `stats` output, base 2: m the
// row's largest score times scale·log2(e), l the sum of 2^(x - m)), so P
// is recomputed exactly as the forward formed it, P = 2^(x - m) / max(l,
// 1e-30) with x = (q·k)·scale·log2(e), and no pass recomputes m and l:
//   1. bwd_prep (one row a half warp) writes, for every 64-row q tile of
//      every head, a record of 3 x 64 floats: m, 1 / max(l, 1e-30) and
//      delta (rows past Sq: zeros, so their P and dS are exactly 0). It
//      reads O and dO once: bytes-bound;
//   2. kv_pass (grid: B·Hkv x 128-key tiles, heaviest first) owns 128
//      keys of one KV head, 64 a consumer warpgroup, K and V resident in
//      shared memory; over the G query heads and the 64-row q tiles whose
//      visited range holds its keys, it computes Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ
//      from shared memory, forms Pᵀ and dSᵀ in the accumulators' registers
//      and accumulates dV += Pᵀ·dO and dK += dSᵀ·Q with A from registers
//      (bf16) and B read MN-major; it writes dk (times D^-½) and dv once;
//   3. q_pass (grid: B·H x 128-row q tiles, heaviest first) owns 128 query
//      rows, 64 a consumer warpgroup, Q and dO resident; over its visited
//      64-key tiles it computes S = Q·Kᵀ and dP = dO·Vᵀ, forms dS, and
//      accumulates dQ += dS·K (K read MN-major); it writes dq (times
//      D^-½) once.
// Seven S x S x D products a head (kv_pass 4, q_pass 3), every one a
// bf16 wgmma with float32 accumulators; no atomics, so the result is the
// same bits every run. The tiles visited are the forward's rule
// (flash_tiles.cuh), exact for the same reason: a skipped tile's P is
// exactly 0 and its dS 0, and a tile holding a row that keeps no key
// visits every key.
//
// What bounds it on the H100: operations. At the training shape (B 2, H
// 32, Hkv 8, S 2048, D 128, causal) the 7 products are 0.24 TFLOP (the 5
// the function needs, 0.17) against 0.13 GB of inputs and outputs.
//
// Numerics: scores are the products of the unscaled bf16 operands in
// float32, times scale·log2(e) in one float32 multiply, as the forward;
// dP - delta is formed in float32 and multiplied by P; P and dS are each
// rounded once to bf16 as the A operands of the dV, dK and dQ products
// (2^-9 of each term, FlashAttention-3's choice; the bar is 2e-2 of each
// gradient's scale against the plain version). D^-½ multiplies the
// float32 dK and dQ accumulators before their one rounding to bf16.
//
// Design, both passes: 256 threads, two warpgroups of 64 rows (keys in
// kv_pass, queries in q_pass), 255 registers a thread for kv_pass's two
// [64 x D] accumulators beside the [64 x 64] score tiles (a third,
// producer warpgroup would cap every thread at 168 and spill them);
// thread 0 issues every load: the resident tiles and the first stages
// up front, then each stage again once both warpgroups release it. Tiles
// reach shared memory by TMA as 64-column halves in the 128-byte swizzle
// that wgmma reads (4-d tensor maps over the caller's strides; rows past
// S and columns past D read as zeros; D up to 64 is padded to 64, the
// others to 128); the streamed tiles pass through a two-stage ring with
// "full" (transaction bytes) and "empty" (one arrival a warpgroup)
// mbarriers, and kv_pass's row records come with their q tile by a 1-d
// bulk copy. A wait that exceeds 4 s traps instead of hanging the card.
#include "flash_tiles.cuh"
#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;       // 2 warpgroups, 64 rows each
constexpr int kStages = 2;          // the streamed tiles' ring
constexpr int kKvKeys = 128;        // kv_pass: keys a block
constexpr int kKvRows = 64;         // kv_pass: query rows a streamed tile
constexpr int kQRows = 128;         // q_pass: query rows a block
constexpr int kQKeys = 64;          // q_pass: keys a streamed tile
constexpr int kRec = 3 * 64;        // floats of a 64-row record
constexpr int kMaxHeadDim = 128;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr uint32_t kHalf64 = 64 * 128;     // bytes of a 64-row, 64-column half
constexpr uint32_t kHalf128 = 128 * 128;   // bytes of a 128-row half

// element strides (batch, head, row) of each operand
enum { kQ, kK, kV, kO, kDO, kDQ, kDK, kDV, kOperands };
struct Strides {
  long long s[kOperands][3];
};

__device__ __forceinline__ bool masked(int q_pos, int k_pos, int causal,
                                       int window) {
  return (causal && q_pos < k_pos) || (window > 0 && k_pos <= q_pos - window);
}

// a 64 x 64 tile's 32 accumulator values of one thread as bf16 pairs in
// the A fragment layout: for columns 16kk..16kk+15 the pairs 4kk..4kk+3
__device__ __forceinline__ void to_a_frags(const float (&x)[32],
                                           uint32_t (&a)[16]) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
    a[j] = bf16x2_bits(__floats2bfloat162_rn(x[2 * j], x[2 * j + 1]));
}

// acc (+)= A[64 x 64] (registers) · B[64 x DP], B MN-major at `b` (a tile
// of 64 rows: halves kHalf64 apart)
// The descriptors of one call are its base's plus constant offsets (the
// address field counts 16 bytes and cannot carry: shared memory is under
// 256 KB); the empty asm keeps the compiler from hoisting a loop's
// invariant descriptors into registers held across its iterations.
template <int DP>
__device__ __forceinline__ void mma_rs_64(float (&acc)[DP / 2],
                                          const uint32_t (&a)[16],
                                          uint32_t b) {
  asm volatile("" : "+r"(b));
  const uint64_t db = desc_sw128(b, kHalf64, 1024);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t ak[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                            a[4 * kk + 3]};
    if constexpr (DP == 128)
      wgmma_rs_n128(acc, ak, db + kk * (2048 >> 4), 1);
    else
      wgmma_rs_n64(acc, ak, db + kk * (2048 >> 4), 1);
  }
}

// out[64 x 64] = A[64 x DP] · B[64 x DP]ᵀ, both K-major in shared memory
// (A's halves `a_half` apart, B a 64-row tile)
template <int DP>
__device__ __forceinline__ void mma_ss_64(float (&out)[32], uint32_t a,
                                          uint32_t a_half, uint32_t b) {
  asm volatile("" : "+r"(a), "+r"(b));
  const uint64_t da = desc_sw128(a, 16, 1024), db = desc_sw128(b, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32u;   // 16 columns in
    wgmma_ss_n64(out, da + (((kk / 4) * a_half + off) >> 4),
                 db + (((kk / 4) * kHalf64 + off) >> 4), kk > 0);
  }
}

// rows [r0, r0 + 8) x columns 8j + cq of a [64 x DP] accumulator times
// `mul`, as bf16 into rows row0 + r0 (+ 8) of `dst` (row stride `ss`);
// rows from `rows` on and columns from d on are skipped
template <int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long long ss,
                                           const float (&acc)[DP / 2],
                                           float mul, int row0, int rows,
                                           int d, int r0, int cq) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r0 + 8 * r;
    if (row >= rows) continue;
    __nv_bfloat16* p = dst + (long long)row * ss;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + cq;
      if (col < d)
        *reinterpret_cast<__nv_bfloat162*>(p + col) = __floats2bfloat162_rn(
            acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
    }
  }
}

// 1. the row records: m, 1 / max(l, 1e-30), delta = rowsum(dO∘O) of every
// row of n_rt 64-row tiles a head, zeros past Sq; 16 threads a row, 8
// columns a thread (16-byte loads)
__global__ void __launch_bounds__(256) bwd_prep(
    const __nv_bfloat16* __restrict__ out,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ stats,
    float* __restrict__ rec, int heads, int sq, int d, int n_rt, Strides st,
    long long plane) {
  const long long row = (long long)blockIdx.x * 16 + threadIdx.x / 16;
  const int c = 8 * (threadIdx.x % 16);
  const long long bh = row / (n_rt * 64);
  const int i = (int)(row % (n_rt * 64));
  const int b = (int)(bh / heads), h = (int)(bh % heads);
  float acc = 0.0f;
  if (i < sq && c < d) {
    const uint4 ov = *reinterpret_cast<const uint4*>(
        out + b * st.s[kO][0] + h * st.s[kO][1] + i * st.s[kO][2] + c);
    const uint4 gv = *reinterpret_cast<const uint4*>(
        dout + b * st.s[kDO][0] + h * st.s[kDO][1] + i * st.s[kDO][2] + c);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 of = __bfloat1622float2(o2[j]);
      const float2 gf = __bfloat1622float2(g2[j]);
      acc += gf.x * of.x;
      acc += gf.y * of.y;
    }
  }
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (threadIdx.x % 16 == 0) {
    float* r = rec + (bh * n_rt + i / 64) * kRec + i % 64;
    const bool ok = i < sq;
    const long long at = bh * sq + i;
    r[0] = ok ? stats[at] : 0.0f;
    r[64] = ok ? 1.0f / fmaxf(stats[plane + at], 1e-30f) : 0.0f;
    r[128] = ok ? acc : 0.0f;
  }
}

// does the 64-row q tile qt visit the 128-key tile kt (the forward's rule)
__device__ __forceinline__ bool kv_visits(int qt, int kt, int sq, int skv,
                                          int causal, int window,
                                          int q_offset) {
  const int q0 = qt * kKvRows;
  int lo, hi;
  flash_kv_tiles(q0, min(kKvRows, sq - q0), skv, kKvKeys, causal, window,
                 q_offset, &lo, &hi);
  return lo <= kt && kt <= hi;
}

// 2. dK and dV of 128 keys, over the G query heads and the q tiles
template <int DP>
__global__ void __launch_bounds__(kThreads, 1) kv_pass(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ rec,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    Strides st, int heads, int hkv, int sq, int skv, int d, int n_rt,
    int causal, int window, int q_offset, float scale_log2, float scale) {
  constexpr int NH = DP / 64;                      // 64-column halves
  constexpr uint32_t kKV = NH * kHalf128;          // K (or V) of 128 keys
  constexpr uint32_t kTile = NH * kHalf64;         // a 64-row Q or dO tile
  // a stage: Q, dO, then the record (768 bytes) and its q tile's index
  constexpr uint32_t kStage = 2 * kTile + 1024;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sk = (base + 1023u) & ~1023u;
  const uint32_t sv = sk + kKV;
  const uint32_t ring = sv + kKV;
  const uint32_t bars = ring + kStages * kStage;
  const uint32_t bar_kv = bars;
  auto bar_f = [&](int s) { return bars + 8u * (1 + s); };
  auto bar_e = [&](int s) { return bars + 8u * (1 + kStages + s); };
  auto at = [&](uint32_t a) { return smem_raw + (a - base); };
  int* n_visits = reinterpret_cast<int*>(at(bars + 8u * (1 + 2 * kStages)));

  const int hk = blockIdx.x % hkv, b = blockIdx.x / hkv;
  const int kt = blockIdx.y, k0 = kt * kKvKeys;   // tile 0 sees the most
  const int groups = heads / hkv;
  const int n_qt = (sq + kKvRows - 1) / kKvRows;
  const int tid = threadIdx.x;

  // the loader (thread 0): the next visited (query head, q tile) to load
  int lg = 0, lqt = 0;
  auto load_next = [&](int s) {
    while (lg < groups &&
           !kv_visits(lqt, kt, sq, skv, causal, window, q_offset))
      if (++lqt == n_qt) lqt = 0, ++lg;
    if (lg == groups) return;
    const int h = hk * groups + lg;
    const uint32_t stage = ring + s * kStage;
    *reinterpret_cast<int*>(at(stage + 2 * kTile + kRec * 4)) = lqt;
    mbar_expect_tx(bar_f(s), 2 * kTile + kRec * 4);
#pragma unroll
    for (int c = 0; c < NH; ++c) {
      tma_load(stage + c * kHalf64, &tm_q, bar_f(s), 64 * c, lqt * kKvRows,
               h, b);
      tma_load(stage + kTile + c * kHalf64, &tm_do, bar_f(s), 64 * c,
               lqt * kKvRows, h, b);
    }
    bulk_load(stage + 2 * kTile,
              rec + (((long long)b * heads + h) * n_rt + lqt) * kRec,
              kRec * 4, bar_f(s));
    if (++lqt == n_qt) lqt = 0, ++lg;
  };
  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_f(s), 1);
      mbar_init(bar_e(s), 2);         // one arrival per warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_kv, 2 * kKV);
#pragma unroll
    for (int c = 0; c < NH; ++c) {
      tma_load(sk + c * kHalf128, &tm_k, bar_kv, 64 * c, k0, hk, b);
      tma_load(sv + c * kHalf128, &tm_v, bar_kv, 64 * c, k0, hk, b);
    }
    int n = 0;
    for (int qt = 0; qt < n_qt; ++qt)
      n += kv_visits(qt, kt, sq, skv, causal, window, q_offset);
    *n_visits = n * groups;
    for (int s = 0; s < kStages; ++s) load_next(s);
  }
  __syncthreads();

  const int wg = tid / 128, t = tid % 128, warp = t / 32, lane = t % 32;
  const int r0 = 16 * warp + lane / 4;   // this thread's keys r0, r0 + 8
  const int cq = 2 * (lane % 4);         // its query columns in each 8
  const int kb = k0 + 64 * wg;           // the warpgroup's first key
  const uint32_t k_wg = sk + wg * kHalf64, v_wg = sv + wg * kHalf64;

  float acc_v[DP / 2], acc_k[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc_v[i] = acc_k[i] = 0.0f;
  mbar_wait(bar_kv, 0);

  const int n_it = *n_visits;
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kStages;
    const uint32_t ph = (it / kStages) & 1;
    const uint32_t stage = ring + s * kStage;
    const float* recs = reinterpret_cast<const float*>(at(stage + 2 * kTile));
    mbar_wait(bar_f(s), ph);
    const int qt = *reinterpret_cast<const int*>(recs + kRec);

    // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ (unscaled), 64 keys x 64 queries each
    float sc[32], dp[32];
    wgmma_fence();
    mma_ss_64<DP>(sc, k_wg, kHalf128, stage);
    mma_ss_64<DP>(dp, v_wg, kHalf128, stage + kTile);
    wgmma_commit();

    const int qp0 = q_offset + qt * kKvRows;    // query column 0's position
    const bool whole = kb + 64 <= skv && (!causal || qp0 >= kb + 63) &&
                       (window <= 0 || kb > qp0 + 63 - window);
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);
    // Pᵀ = 2^(x - m) / l and dSᵀ = Pᵀ (dPᵀ - delta); a dropped score
    // keeps its P (scored -1e30, as the forward) and gets dS = 0, a key
    // past Skv gets P = dS = 0 (its row is not stored). Each pair goes
    // to bf16 as it is formed (the A fragments: for queries
    // 16kk..16kk+15 the pairs 4kk..4kk+3), so its float32 values die
    uint32_t pa[16], da[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 m2 = *reinterpret_cast<const float2*>(recs + 8 * j + cq);
      const float2 il2 =
          *reinterpret_cast<const float2*>(recs + 64 + 8 * j + cq);
      const float2 dl2 =
          *reinterpret_cast<const float2*>(recs + 128 + 8 * j + cq);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {      // keys r0 and r0 + 8
        float p[2], ds[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {       // query columns cq, cq + 1
          const int e = 4 * j + 2 * rr + c;
          float x = sc[e] * scale_log2;
          bool drop = false;
          if (!whole) {
            const int k_pos = kb + r0 + 8 * rr;
            const int q_pos = qp0 + 8 * j + cq + c;
            if (k_pos >= skv) {
              x = -INFINITY;
              drop = true;
            } else if (masked(q_pos, k_pos, causal, window)) {
              x = kNegInf;
              drop = true;
            }
          }
          p[c] = ex2(x - (c ? m2.y : m2.x)) * (c ? il2.y : il2.x);
          ds[c] = drop ? 0.0f : p[c] * (dp[e] - (c ? dl2.y : dl2.x));
        }
        pa[2 * j + rr] = bf16x2_bits(__floats2bfloat162_rn(p[0], p[1]));
        da[2 * j + rr] = bf16x2_bits(__floats2bfloat162_rn(ds[0], ds[1]));
      }
    }

    // dV += Pᵀ dO, dK += dSᵀ Q; dO and Q read MN-major
    wgmma_fence();
    mma_rs_64<DP>(acc_v, pa, stage + kTile);
    mma_rs_64<DP>(acc_k, da, stage);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_v);
    fence_regs(acc_k);
    if (t == 0) mbar_arrive(bar_e(s));    // Q, dO and the record read
    if (tid == 0) {                       // refill the stage
      mbar_wait(bar_e(s), ph);
      load_next(s);
    }
    __syncwarp();     // warp 0 whole again before the next wgmma
  }
  store_rows<DP>(dk + b * st.s[kDK][0] + hk * st.s[kDK][1], st.s[kDK][2],
                 acc_k, scale, kb, skv, d, r0, cq);
  store_rows<DP>(dv + b * st.s[kDV][0] + hk * st.s[kDV][1], st.s[kDV][2],
                 acc_v, 1.0f, kb, skv, d, r0, cq);
}

// 3. dQ of 128 query rows over their visited 64-key tiles
template <int DP>
__global__ void __launch_bounds__(kThreads, 1) q_pass(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ rec,
    __nv_bfloat16* __restrict__ dq, Strides st, int heads, int hkv, int sq,
    int skv, int d, int n_rt, int causal, int window, int q_offset,
    float scale_log2, float scale) {
  constexpr int NH = DP / 64;
  constexpr uint32_t kQD = NH * kHalf128;          // Q (or dO) of 128 rows
  constexpr uint32_t kTile = NH * kHalf64;         // a 64-key K or V tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq_ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sdo = sq_ + kQD;
  const uint32_t sk = sdo + kQD;
  const uint32_t sv = sk + kStages * kTile;
  const uint32_t bars = sv + kStages * kTile;
  const uint32_t bar_q = bars;
  auto bar_f = [&](int s) { return bars + 8u * (1 + s); };
  auto bar_e = [&](int s) { return bars + 8u * (1 + kStages + s); };

  const int h = blockIdx.x % heads, b = blockIdx.x / heads;
  const int hk = h / (heads / hkv);
  const int n_qt = (sq + kQRows - 1) / kQRows;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * kQRows;   // heaviest first
  int kt_lo, kt_hi;
  flash_kv_tiles(q0, min(kQRows, sq - q0), skv, kQKeys, causal, window,
                 q_offset, &kt_lo, &kt_hi);
  const int n_kt = kt_hi - kt_lo + 1;
  const int tid = threadIdx.x;

  // the loader (thread 0): K and V of KV tile i into stage i % kStages
  auto load = [&](int i) {
    const int s = i % kStages, kv0 = (kt_lo + i) * kQKeys;
    mbar_expect_tx(bar_f(s), 2 * kTile);
#pragma unroll
    for (int c = 0; c < NH; ++c) {
      tma_load(sk + s * kTile + c * kHalf64, &tm_k, bar_f(s), 64 * c, kv0,
               hk, b);
      tma_load(sv + s * kTile + c * kHalf64, &tm_v, bar_f(s), 64 * c, kv0,
               hk, b);
    }
  };
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_f(s), 1);
      mbar_init(bar_e(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_q, 2 * kQD);
#pragma unroll
    for (int c = 0; c < NH; ++c) {
      tma_load(sq_ + c * kHalf128, &tm_q, bar_q, 64 * c, q0, h, b);
      tma_load(sdo + c * kHalf128, &tm_do, bar_q, 64 * c, q0, h, b);
    }
    for (int i = 0; i < kStages && i < n_kt; ++i) load(i);
  }
  __syncthreads();

  const int wg = tid / 128, t = tid % 128, warp = t / 32, lane = t % 32;
  const int r0 = 16 * warp + lane / 4;   // this thread's rows r0, r0 + 8
  const int cq = 2 * (lane % 4);         // its key columns in each 8
  const int qb = q0 + 64 * wg;           // the warpgroup's first row
  const int qp0 = q_offset + qb;
  const uint32_t q_wg = sq_ + wg * kHalf64, do_wg = sdo + wg * kHalf64;
  // the rows' records (n_rt is even: a 128-row block's two tiles exist)
  const float* r =
      rec + (((long long)b * heads + h) * n_rt + qb / 64) * kRec + r0;
  const float m[2] = {r[0], r[8]};
  const float il[2] = {r[64], r[72]};
  const float dl[2] = {r[128], r[136]};

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
  mbar_wait(bar_q, 0);

  for (int i = 0; i < n_kt; ++i) {
    const int s = i % kStages;
    const uint32_t ph = (i / kStages) & 1;
    const int kv0 = (kt_lo + i) * kQKeys;

    // S = Q Kᵀ and dP = dO Vᵀ (unscaled), 64 rows x 64 keys each
    float sc[32], dp[32];
    mbar_wait(bar_f(s), ph);
    wgmma_fence();
    mma_ss_64<DP>(sc, q_wg, kHalf128, sk + s * kTile);
    mma_ss_64<DP>(dp, do_wg, kHalf128, sv + s * kTile);
    wgmma_commit();

    const bool whole = kv0 + kQKeys <= skv &&
                       (!causal || kv0 + kQKeys - 1 <= qp0) &&
                       (window <= 0 || kv0 > qp0 + 63 - window);
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);
    // dS = P (dP - delta), P = 2^(x - m) / l; 0 where the score was
    // dropped or the key is past Skv (K's zero rows must meet dS = 0)
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int rr = (e >> 1) & 1;
      float x = sc[e] * scale_log2;
      bool drop = false;
      if (!whole) {
        const int k_pos = kv0 + 8 * (e / 4) + cq + (e & 1);
        const int q_pos = qp0 + r0 + 8 * rr;
        if (k_pos >= skv) {
          x = -INFINITY;
          drop = true;
        } else if (masked(q_pos, k_pos, causal, window)) {
          x = kNegInf;
          drop = true;
        }
      }
      const float p = ex2(x - m[rr]) * il[rr];
      dp[e] = drop ? 0.0f : p * (dp[e] - dl[rr]);
    }
    uint32_t da[16];
    to_a_frags(dp, da);

    // dQ += dS K, K read MN-major
    wgmma_fence();
    mma_rs_64<DP>(acc, da, sk + s * kTile);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    if (t == 0) mbar_arrive(bar_e(s));      // K and V of this stage read
    if (tid == 0 && i + kStages < n_kt) {   // refill the stage
      mbar_wait(bar_e(s), ph);
      load(i + kStages);
    }
    __syncwarp();       // warp 0 whole again before the next wgmma
  }
  store_rows<DP>(dq + b * st.s[kDQ][0] + h * st.s[kDQ][1], st.s[kDQ][2], acc,
                 scale, qb, sq, d, r0, cq);
}

// ---- host side ----------------------------------------------------------

// dynamic shared memory: 1024-byte alignment slack, the resident tiles,
// the ring, the mbarriers
template <int DP>
constexpr size_t kv_smem() {
  return 1024 + 2 * (DP / 64) * kHalf128 +
         kStages * (2 * (DP / 64) * kHalf64 + 1024) + 8 * (1 + 2 * kStages) +
         16;
}

template <int DP>
constexpr size_t q_smem() {
  return 1024 + 2 * (DP / 64) * kHalf128 + 2 * kStages * (DP / 64) * kHalf64 +
         8 * (1 + 2 * kStages);
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

template <int DP>
int launch(const void* const* p, const float* stats, float* rec, int batch,
           int heads, int hkv, int sq, int skv, int d, const Strides& st,
           int causal, int window, int q_offset, float scale,
           cudaStream_t stream) {
  static bool configured[2] = {false, false};
  int err = allow_smem(kv_pass<DP>, kv_smem<DP>(), &configured[0]);
  if (!err) err = allow_smem(q_pass<DP>, q_smem<DP>(), &configured[1]);
  if (err) return err;
  // maps for kv_pass (64-row q tiles, 128-key tiles) and q_pass (128-row
  // q tiles, 64-key tiles)
  CUtensorMap q64, do64, k128, v128, q128, do128, k64, v64;
  const long long* s = &st.s[0][0];
  if (!make_map(&q64, p[kQ], d, sq, heads, batch, s[0], s[1], s[2], 64) ||
      !make_map(&q128, p[kQ], d, sq, heads, batch, s[0], s[1], s[2], 128) ||
      !make_map(&k128, p[kK], d, skv, hkv, batch, s[3], s[4], s[5], 128) ||
      !make_map(&k64, p[kK], d, skv, hkv, batch, s[3], s[4], s[5], 64) ||
      !make_map(&v128, p[kV], d, skv, hkv, batch, s[6], s[7], s[8], 128) ||
      !make_map(&v64, p[kV], d, skv, hkv, batch, s[6], s[7], s[8], 64) ||
      !make_map(&do64, p[kDO], d, sq, heads, batch, s[12], s[13], s[14], 64) ||
      !make_map(&do128, p[kDO], d, sq, heads, batch, s[12], s[13], s[14], 128))
    return (int)cudaErrorInvalidValue;
  const int n_rt = 2 * ((sq + kQRows - 1) / kQRows);   // 64-row records a head
  const long long rows = (long long)batch * heads * n_rt * 64;
  bwd_prep<<<(unsigned)(rows / 16), 256, 0, stream>>>(
      (const __nv_bfloat16*)p[kO], (const __nv_bfloat16*)p[kDO], stats, rec,
      heads, sq, d, n_rt, st, (long long)batch * heads * sq);
  err = (int)cudaGetLastError();
  if (err) return err;
  const float scale_log2 = scale * kLog2e;
  kv_pass<DP><<<dim3(batch * hkv, (skv + kKvKeys - 1) / kKvKeys), kThreads,
                kv_smem<DP>(), stream>>>(
      q64, k128, v128, do64, rec, (__nv_bfloat16*)p[kDK],
      (__nv_bfloat16*)p[kDV], st, heads, hkv, sq, skv, d, n_rt, causal,
      window, q_offset, scale_log2, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  q_pass<DP><<<dim3(batch * heads, (sq + kQRows - 1) / kQRows), kThreads,
               q_smem<DP>(), stream>>>(
      q128, k64, v64, do128, rec, (__nv_bfloat16*)p[kDQ], st, heads, hkv, sq,
      skv, d, n_rt, causal, window, q_offset, scale_log2, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out, dout, dq: [B, H, Sq, D]; k, v, dk, dv: [B, Hkv, Skv, D], all
// bfloat16, addressed by element strides (batch, head, row) with a
// contiguous last dimension: `strides` holds 24 of them, three each for
// q, k, v, out, dout, dq, dk and dv. D a multiple of 16 up to 128; q, k,
// v, out and dout 16-byte aligned with strides that are multiples of 8
// elements (TMA's 16 bytes; out's rows are read 16 bytes at a time).
// `stats` is the forward's [2, B, H, Sq] float32 (etica_flash_attention_
// sm90's), `rec` float32 scratch of B·H·n_rt·192 floats, n_rt = 2·ceil(Sq
// / 128). Writes every element of dq, dk and dv.
extern "C" int etica_flash_attention_bwd_sm90(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, void* dq, void* dk, void* dv, const float* stats,
    float* rec, int batch, int heads, int hkv, int sq, int skv, int d,
    const long long* strides, int causal, int window, int q_offset,
    float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0 || skv <= 0 || d <= 0) return 0;
  Strides st;
  for (int o = 0; o < kOperands; ++o)
    for (int j = 0; j < 3; ++j) st.s[o][j] = strides[3 * o + j];
  const void* p[kOperands] = {q, k, v, out, dout, dq, dk, dv};
  const int extent[kOperands][3] = {
      {batch, heads, sq}, {batch, hkv, skv}, {batch, hkv, skv},
      {batch, heads, sq}, {batch, heads, sq}, {batch, heads, sq},
      {batch, hkv, skv}, {batch, hkv, skv}};
  bool aligned = true;
  for (int o = 0; o <= kDO; ++o) {
    aligned = aligned && reinterpret_cast<uintptr_t>(p[o]) % 16 == 0;
    for (int j = 0; j < 3; ++j)
      aligned = aligned && (extent[o][j] == 1 || st.s[o][j] % 8 == 0);
  }
  if (hkv <= 0 || heads % hkv || d % 16 || d > kMaxHeadDim || q_offset < 0 ||
      (long long)batch * heads > 0x7fffffff || !aligned)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= 64)
    return launch<64>(p, stats, rec, batch, heads, hkv, sq, skv, d, st, causal,
                      window, q_offset, scale, s);
  return launch<128>(p, stats, rec, batch, heads, hkv, sq, skv, d, st, causal,
                     window, q_offset, scale, s);
}
