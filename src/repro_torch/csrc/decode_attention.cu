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
// row t % PS. Arithmetic is float32 in the Pallas body's form: q is scaled
// first; each step takes the scores, the running max m, alpha = exp(m_prev
// - m_new), l = l·alpha + sum(p), acc = acc·alpha + p @ V; partial states
// (m, l, acc) merge by rescaling to their common max; the output is
// acc / max(l, 1e-30) in q's dtype.
//
// What bounds it on the H100: bytes. Each sequence's K and V rows up to
// its length are read once (2·len·Hkv·D elements), against 4·len·H·D
// operations; at bf16 that is one operation per byte, far under the
// card's ratio of operations to bandwidth. The Pallas grid (B, Hkv,
// n_pages) walks each row's pages in order on one core; copied as it was,
// one CTA a (sequence, KV head) leaves most SMs idle and the longest row
// sets the time.
//
// Design (flash-decoding):
//  * Splits. The wrapper plans, from shapes alone, `splits` CTAs a
//    (sequence, KV head), launched as one thread-block cluster. Each CTA
//    reads lengths[b] and takes its share of the ceil(len / PS) pages the
//    row needs (all n_pages when len <= 0: every score is then -1e30 and
//    the reference returns the mean of V over every slot), so it never
//    reads a table entry or a page past the length; a split whose range
//    is empty keeps the neutral partial (m = -1e30, l = 0, acc = 0).
//  * Loads. A step's K and V rows go to shared memory in their stored
//    type, 16 bytes a thread, through cp.async into a two-stage ring: the
//    next step is in flight while one is consumed. Two stages, not
//    three, keep a CTA within a third of an SM's shared memory, so that
//    three CTAs share an SM and their loads overlap. The CTA tables each
//    step's row offsets ahead of its copies (the page ids' loads overlap
//    the step before), so that the copies wait on no table load or
//    division (a thread keeps one 16-byte column of every row). Page ids
//    are read as the plain version and JAX's gather read them: negative
//    from the end, clamped.
//  * Dot products across lanes. `lanes` threads hold one query head's
//    row, 8 head_dim values each (16 lanes at D 128), scaled q in
//    registers; a score is their 8-term partial sums reduced by shuffles.
//    The G heads of a KV head read the same K and V rows from shared
//    memory, so each row is loaded from HBM once for all of them; `tg`
//    groups of G·lanes threads take the step's tokens in turn, each group
//    with its own softmax state (acc: the lane's 8 columns).
//  * Merge. The groups' states merge in order in shared memory;
//    the splits' in split order, by the cluster's first CTA reading the
//    others' shared memory (no float atomics, no scratch, one launch), so
//    the output is the same from run to run. One split is a plain launch
//    that writes the output from its own merge.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kVec = 8;             // head_dim values a lane holds
constexpr int kMaxLanes = 32;       // D <= kVec * kMaxLanes = 256
constexpr int kMaxGroups = 16;
constexpr int kMaxThreads = 512;
constexpr int kMaxTok = 16;         // tokens a thread scores in one step
constexpr int kStages = 2;
constexpr int kStageBytes = 32768;  // one step's K and V rows
constexpr int kMaxSplits = 8;       // a portable cluster
constexpr int kMaxStep = 256;       // tokens a stage, at most
constexpr int kRowsAThread = 2;     // kMaxStep over the fewest threads
constexpr float kNegInf = -1e30f;
constexpr int kRingBytes = kStages * kStageBytes;
// Shared memory: the ring, a table of row offsets a stage, then the merge
// area (acc [G][lanes·kVec], m [G], l [G]), at the same offsets in every
// CTA of a launch; the drained ring holds the partial states. The merge
// area's offset from the ring's end, for steps of `step` tokens:
__host__ __device__ constexpr size_t merge_offset(int step) {
  return sizeof(long long) * kStages * step;
}
constexpr size_t kMergeMax =
    merge_offset(kMaxStep) +
    sizeof(float) * ((size_t)kMaxGroups * kMaxLanes * kVec + 2 * kMaxGroups);

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// kVec consecutive values from shared memory (16-byte aligned) as float32
__device__ __forceinline__ void load_vec(const float* p, float (&x)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&x)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

struct Shape {
  int pool_pages, ps, hkv, d, groups, n_pages;
  int lanes, tg, step, splits;
  bool async;
};

// A page id read as JAX's gather reads it: negative from the end, clamped.
__device__ __forceinline__ int pool_page(int pg, int pool_pages) {
  if (pg < 0) pg += pool_pages;
  return min(max(pg, 0), pool_pages - 1);
}

// A step's table of row offsets, filled in two halves so that the page
// ids' loads overlap the consumption of a step: load() reads the ids of
// the step's tokens (at most kRowsAThread a thread), store() writes each
// token's element offset of its row of KV head h. Tokens count from the
// CTA's first page p0; no table entry past the CTA's range is read.
struct Table {
  int pg[kRowsAThread];
  __device__ __forceinline__ void load(const int* pt_row, int p0, int lt0,
                                       int n, const Shape& sh) {
#pragma unroll
    for (int k = 0; k < kRowsAThread; ++k) {
      const int t = threadIdx.x + k * blockDim.x;
      pg[k] = t < n ? __ldg(pt_row + p0 + (lt0 + t) / sh.ps) : 0;
    }
  }
  __device__ __forceinline__ void store(long long* rows, int lt0, int n, int h,
                                        const Shape& sh) const {
#pragma unroll
    for (int k = 0; k < kRowsAThread; ++k) {
      const int t = threadIdx.x + k * blockDim.x;
      if (t < n) {
        const int lt = lt0 + t, page = lt / sh.ps;
        rows[t] = (((long long)pool_page(pg[k], sh.pool_pages) * sh.ps +
                    (lt - page * sh.ps)) * sh.hkv + h) * sh.d;
      }
    }
  }
};

// Issues one step's copies: the K rows, then the V rows, of n tokens at
// element offsets rows[], each into a `row`-element line of buf (the
// padding past D, to lanes·kVec, is never written).
template <typename KT>
__device__ __forceinline__ void stage_step(KT* buf, const KT* __restrict__ kp,
                                           const KT* __restrict__ vp,
                                           const long long* rows, int n,
                                           int row, const Shape& sh) {
  const int nthreads = blockDim.x;
  if (sh.async) {
    constexpr int kPer = 16 / sizeof(KT);
    const int cpr = sh.d / kPer;  // 16-byte chunks a row
    if (nthreads % cpr == 0) {    // a thread keeps one chunk of every row
      const int ch = threadIdx.x % cpr, dr = nthreads / cpr;
      for (int r = threadIdx.x / cpr; r < 2 * n; r += dr) {
        const int kv = r >= n, t = r - kv * n;
        cp_async16(buf + (kv * sh.step + t) * row + ch * kPer,
                   (kv ? vp : kp) + rows[t] + ch * kPer);
      }
    } else {
      for (int c = threadIdx.x; c < 2 * n * cpr; c += nthreads) {
        const int r = c / cpr, ch = c - r * cpr;
        const int kv = r >= n, t = r - kv * n;
        cp_async16(buf + (kv * sh.step + t) * row + ch * kPer,
                   (kv ? vp : kp) + rows[t] + ch * kPer);
      }
    }
  } else {
    for (int c = threadIdx.x; c < 2 * n * sh.d; c += nthreads) {
      const int r = c / sh.d, col = c - r * sh.d;
      const int kv = r >= n, t = r - kv * n;
      buf[(kv * sh.step + t) * row + col] = (kv ? vp : kp)[rows[t] + col];
    }
  }
}

// The part of the row that split `split` of a (sequence, KV head) reads.
struct Range {
  int len;           // lengths[b]
  int p0;            // first page
  int n_pages;       // pages of the range
  long long tok_lo;  // first token
};

__device__ __forceinline__ Range split_range(int len, int split,
                                             const Shape& sh) {
  int n_visit = sh.n_pages;  // every page when len <= 0 (all masked)
  if (len > 0) {
    const long long need = ((long long)len + sh.ps - 1) / sh.ps;
    if (need < n_visit) n_visit = (int)need;
  }
  const int per = (n_visit + sh.splits - 1) / sh.splits;
  const int p0 = min(split * per, n_visit), p1 = min(p0 + per, n_visit);
  return Range{len, p0, p1 - p0, (long long)p0 * sh.ps};
}

// Runs the ring over the CTA's range: the K and V rows of `step` tokens a
// stage (`row` elements apart), consume(i, k rows, v rows, tokens) on each
// step in order. Each step's row offsets are tabled (`tables`, one a
// stage) before its copies are issued, so that the copies wait on no
// table load or division.
template <typename KT, typename Consume>
__device__ __forceinline__ void run_ring(KT* ring, long long* tables, int row,
                                         const KT* __restrict__ kp,
                                         const KT* __restrict__ vp,
                                         const int* pt_row, const Range& rg,
                                         int h, const Shape& sh,
                                         Consume&& consume) {
  const int n_tok = rg.n_pages * sh.ps;
  const int n_steps = (n_tok + sh.step - 1) / sh.step;
  const int stage_elems = 2 * sh.step * row;
  auto tokens = [&](int i) { return min(sh.step, n_tok - i * sh.step); };
  auto rows = [&](int i) { return tables + (i % kStages) * sh.step; };
  auto stage = [&](int i) {
    stage_step(ring + (i % kStages) * stage_elems, kp, vp, rows(i),
               tokens(i), row, sh);
  };
  Table next[kStages];
#pragma unroll
  for (int i = 0; i < kStages; ++i)
    if (i < n_steps) next[i].load(pt_row, rg.p0, i * sh.step, tokens(i), sh);
#pragma unroll
  for (int i = 0; i < kStages; ++i)
    if (i < n_steps) next[i].store(rows(i), i * sh.step, tokens(i), h, sh);
  __syncthreads();  // the first tables (and any zeroed padding)
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_steps) stage(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step i landed; step i - 1's buffer and table free
    if (i + kStages - 1 < n_steps) stage(i + kStages - 1);
    cp_async_commit();
    const int j = i + kStages;  // its table goes where step i's was
    if (j < n_steps) next[0].load(pt_row, rg.p0, j * sh.step, tokens(j), sh);
    KT* kb = ring + (i % kStages) * stage_elems;
    consume(i, kb, kb + sh.step * row, tokens(i));
    if (j < n_steps) next[0].store(rows(j), j * sh.step, tokens(j), h, sh);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the partial states go there
}

// The merge. At the start of shared memory the CTA's `parts` partial
// states (m [parts][G], l [parts][G], acc [parts][G][dp]) are merged in
// order by rescaling to their common max; with one split that is the
// output. With more, each CTA leaves its merged state in the merge area
// and the cluster's first CTA merges the splits' states in split order
// through distributed shared memory, then writes the output.
template <typename QT>
__device__ __forceinline__ void merge_store(unsigned char* smem,
                                            float* merge_area, int parts,
                                            int dp, long long head0,
                                            QT* __restrict__ out,
                                            const Shape& sh, int split) {
  const int groups = sh.groups;
  const float* part_m = reinterpret_cast<const float*>(smem);
  const float* part_l = part_m + parts * groups;
  const float* part_acc = part_l + parts * groups;
  float* cta_acc = merge_area;           // [G][dp]
  float* cta_m = cta_acc + groups * dp;  // [G]
  float* cta_l = cta_m + groups;         // [G]
  for (int idx = threadIdx.x; idx < groups * dp; idx += blockDim.x) {
    const int gg = idx / dp, col = idx - gg * dp;
    float mx = kNegInf;
    for (int r = 0; r < parts; ++r) mx = fmaxf(mx, part_m[r * groups + gg]);
    float ls = 0.0f, a = 0.0f;
    for (int r = 0; r < parts; ++r) {
      const float w = expf(part_m[r * groups + gg] - mx);
      ls += part_l[r * groups + gg] * w;
      a += part_acc[(r * groups + gg) * dp + col] * w;
    }
    if (sh.splits == 1) {
      if (col < sh.d)
        store(out + (head0 + gg) * sh.d + col, a / fmaxf(ls, 1e-30f));
      continue;
    }
    cta_acc[idx] = a;
    if (col == 0) {
      cta_m[gg] = mx;
      cta_l[gg] = ls;
    }
  }
  if (sh.splits == 1) return;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (split == 0) {
    for (int idx = threadIdx.x; idx < groups * dp; idx += blockDim.x) {
      const int gg = idx / dp, col = idx - gg * dp;
      if (col >= sh.d) continue;
      float mx = kNegInf;
      for (int r = 0; r < sh.splits; ++r)
        mx = fmaxf(mx, *cluster.map_shared_rank(cta_m + gg, r));
      float ls = 0.0f, a = 0.0f;
      for (int r = 0; r < sh.splits; ++r) {
        const float w = expf(*cluster.map_shared_rank(cta_m + gg, r) - mx);
        ls += *cluster.map_shared_rank(cta_l + gg, r) * w;
        a += *cluster.map_shared_rank(cta_acc + idx, r) * w;
      }
      store(out + (head0 + gg) * sh.d + col, a / fmaxf(ls, 1e-30f));
    }
  }
  cluster.sync();  // every CTA's shared memory outlives the reads
}

// Any D <= 256, q and pages float32 or bf16.
template <typename QT, typename KT>
__global__ void __launch_bounds__(kMaxThreads) paged_decode_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k_pages,
    const KT* __restrict__ v_pages, const int* __restrict__ page_table,
    const int* __restrict__ lengths, QT* __restrict__ out, Shape sh,
    float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int split = blockIdx.x % sh.splits;
  const int pair = blockIdx.x / sh.splits;
  const int h = pair % sh.hkv;
  const long long b = pair / sh.hkv;
  const int lanes = sh.lanes, groups = sh.groups, tgs = sh.tg;
  const int dp = lanes * kVec;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const bool active = tid < lanes * groups * tgs;
  const int l = tid % lanes;
  const int g = (tid / lanes) % groups;
  const int tg = tid / (lanes * groups);

  KT* ring = reinterpret_cast<KT*>(smem);
  if (dp > sh.d) {  // zero the padding columns once: never staged
    const int pad = dp - sh.d;
    for (int i = tid; i < kStages * 2 * sh.step * pad; i += nthreads)
      store(ring + (i / pad) * dp + sh.d + i % pad, 0.0f);
  }

  // this thread's query head, scaled first
  const long long head0 = (b * sh.hkv + h) * groups;
  float qv[kVec], acc[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const int col = l * kVec + e;
    qv[e] = active && col < sh.d
                ? to_f32(q[(head0 + g) * sh.d + col]) * scale
                : 0.0f;
    acc[e] = 0.0f;
  }
  float m = kNegInf, lsum = 0.0f;

  const Range rg = split_range(lengths[b], split, sh);
  const int ntok = (sh.step + tgs - 1) / tgs;  // tokens a thread, a step
  run_ring(ring, reinterpret_cast<long long*>(smem + kRingBytes), dp,
           k_pages, v_pages, page_table + b * sh.n_pages, rg, h, sh,
           [&](int i, const KT* kb, const KT* vb, int n) {
    const long long tok0 = rg.tok_lo + (long long)i * sh.step;
    float s[kMaxTok];
    float m_new = m;
#pragma unroll
    for (int j = 0; j < kMaxTok; ++j) {
      if (j < ntok) {  // the same for every thread: shuffles stay whole
        const int t = tg + j * tgs;
        const bool in = active && t < n;
        float part = 0.0f;
        if (in) {
          float k[kVec];
          load_vec(kb + t * dp + l * kVec, k);
#pragma unroll
          for (int e = 0; e < kVec; ++e) part = fmaf(qv[e], k[e], part);
        }
        for (int o = lanes >> 1; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        s[j] = tok0 + t < rg.len ? part : kNegInf;
        if (in) m_new = fmaxf(m_new, s[j]);
      }
    }
    const float alpha = expf(m - m_new);
    float psum = 0.0f, pv[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) pv[e] = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxTok; ++j) {
      const int t = tg + j * tgs;
      if (j < ntok && active && t < n) {
        const float p = expf(s[j] - m_new);
        psum += p;
        float v[kVec];
        load_vec(vb + t * dp + l * kVec, v);
#pragma unroll
        for (int e = 0; e < kVec; ++e) pv[e] = fmaf(p, v[e], pv[e]);
      }
    }
    lsum = lsum * alpha + psum;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] = acc[e] * alpha + pv[e];
    m = m_new;
  });

  // the token groups' states, merged in group order
  float* part_m = reinterpret_cast<float*>(smem);  // [tg][G]
  float* part_l = part_m + tgs * groups;
  float* part_acc = part_l + tgs * groups;         // [tg][G][dp]
  if (active) {
    const int pid = tg * groups + g;
    if (l == 0) {
      part_m[pid] = m;
      part_l[pid] = lsum;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) part_acc[pid * dp + l * kVec + e] = acc[e];
  }
  __syncthreads();
  merge_store(smem,
              reinterpret_cast<float*>(smem + kRingBytes + merge_offset(sh.step)),
              tgs, dp, head0, out, sh, split);
}

// Launches one instantiation; `configured` is its own flag: the shared
// memory opt-in runs once, at the first call, before any graph capture.
template <typename QT, typename KT>
int launch(void (*kernel)(const QT*, const KT*, const KT*, const int*,
                          const int*, QT*, Shape, float),
           bool& configured, const void* q,
           const void* k_pages, const void* v_pages, const int* page_table,
           const int* lengths, void* out, int batch, const Shape& sh,
           int threads, float scale, cudaStream_t stream) {
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(kRingBytes + kMergeMax));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((long long)batch * sh.hkv * sh.splits));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes =
      (size_t)kRingBytes + merge_offset(sh.step) +
      sizeof(float) * ((size_t)sh.groups * sh.lanes * kVec + 2 * sh.groups);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = sh.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = sh.splits > 1 ? 1 : 0;  // one CTA: a plain launch
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, (const QT*)q, (const KT*)k_pages,
                         (const KT*)v_pages, page_table, lengths, (QT*)out,
                         sh, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// q: [B, H, D] (float32 or bfloat16, q_bf16); k_pages/v_pages: [NP, PS,
// Hkv, D] (float32 or bfloat16, kv_bf16); page_table: [B, n_pages] int32;
// lengths: [B] int32; out: [B, H, D] in q's dtype. H = Hkv * groups. The
// plan (kernels/decode_attention/ops.py `decode_plan`): `lanes` threads a
// head row, a power of two with lanes * 8 >= D; `tg` token groups;
// `threads` a multiple of 32 >= lanes * groups * tg; `step` tokens a
// stage, at most kMaxTok a thread; `splits` CTAs a (sequence, KV head);
// `async_ok` when every K and V row starts on 16 bytes (cp.async), else
// the stage is copied element by element.
extern "C" int etica_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const int* page_table, const int* lengths, void* out, int batch,
    int pool_pages, int page_size, int hkv, int d, int groups, int n_pages,
    float scale, int q_bf16, int kv_bf16, int lanes, int tg, int threads,
    int step, int splits, int async_ok, void* stream) {
  if (batch <= 0 || hkv <= 0 || groups <= 0 || d <= 0) return 0;
  const int item = kv_bf16 ? 2 : 4;
  const bool plan_ok =
      splits >= 1 && splits <= kMaxSplits && groups <= kMaxGroups &&
      lanes >= 1 && lanes <= kMaxLanes && (lanes & (lanes - 1)) == 0 &&
      lanes * kVec >= d && tg >= 1 && threads % 32 == 0 &&
      threads <= kMaxThreads && threads >= lanes * groups * tg &&
      step >= 1 && step <= kMaxStep &&
      2 * step * lanes * kVec * item <= kStageBytes &&
      (step + tg - 1) / tg <= kMaxTok &&
      (!async_ok || (d * item) % 16 == 0);
  if (pool_pages <= 0 || page_size <= 0 || n_pages < 0 || !plan_ok)
    return (int)cudaErrorInvalidValue;
  const Shape sh{pool_pages, page_size, hkv,  d,      groups,
                 n_pages,    lanes,     tg,   step,   splits, async_ok != 0};
  cudaStream_t s = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  static bool bb = false, bf = false, fb = false, ff = false;
  if (q_bf16 && kv_bf16)
    return launch(paged_decode_kernel<bf16, bf16>, bb, q, k_pages,
                  v_pages, page_table, lengths, out, batch, sh, threads,
                  scale, s);
  if (q_bf16)
    return launch(paged_decode_kernel<bf16, float>, bf, q, k_pages,
                  v_pages, page_table, lengths, out, batch, sh, threads,
                  scale, s);
  if (kv_bf16)
    return launch(paged_decode_kernel<float, bf16>, fb, q, k_pages,
                  v_pages, page_table, lengths, out, batch, sh, threads,
                  scale, s);
  return launch(paged_decode_kernel<float, float>, ff, q, k_pages,
                v_pages, page_table, lengths, out, batch, sh, threads, scale,
                s);
}
