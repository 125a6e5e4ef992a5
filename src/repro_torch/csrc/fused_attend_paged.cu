// Fused decompress + GQA decode attention over the paged compressed KV pool.
//
// Replaces: src/repro/kernels/fused_attend/kernel.py::attend_paged
//           (_attend_paged_kernel), the TPU kernel every layer of every
//           decode step runs.
//
// For each (slot b, kv head h): walk b's block table over the pages below
// its flushed watermark (pos[b] / 8 * 8); per page dequantize the 16 K and
// 16 V int8 k x k corners (one per 8-feature block) and inverse-transform
// them, X = C8[:k]^T (q * scale) C8[:k], into two (8, hd) f32 tiles in
// shared memory; score the n_rep query heads of h against the page and fold
// the result into an online softmax (m, l, acc); then merge the raw 8-token
// tail ring (positions flushed + i <= pos[b]) with the same algebra and
// normalize with l floored at 1e-30.  Scores are scaled by 1/sqrt(hd).
//
// Bound on this card: HBM bytes — the mapped pages' 2*Hkv*(hd/8)*(k*k+4)
// bytes per page, plus tails, q and out.  The IDCT and the 8-position dot
// products add ~2*8*hd*(k+8) + 4*8*n_rep*hd flops per page and head, below
// the CUDA cores' rate for those bytes.
//
// Design: one 256-thread block per (b, h); the block loads its own pos[b]
// and table row and loops over its pages in order, carrying (m, l, acc) in
// registers and shared memory, which is what the TPU kernel's sequential
// grid axis did.  Stopping at the watermark is the TPU kernel's pl.when
// skip: table entries past it (unmapped = page 0) are never read.  Page
// ids are clamped into the pool, as the JAX reference gather clamps.  Only
// int8 corners and scales stream from HBM; decompressed K/V exist only in
// shared memory.  At serving batch sizes the (B * Hkv) grid fills few of
// the 132 SMs: splitting each slot's pages across blocks is the first
// redesign target.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

__constant__ float fa_dct[64];  // C8, row-major: fa_dct[u * 8 + a] = C[u][a]

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAccPerThread = 8;  // n_rep * hd <= kThreads * kAccPerThread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Smem {
  float* q;       // (n_rep, hd), pre-scaled by 1/sqrt(hd)
  float* kt;      // (8, hd) decompressed K page / raw K tail
  float* vt;      // (8, hd)
  float* p;       // (n_rep, 8) scores, then probabilities
  float* m;       // (n_rep) running max
  float* l;       // (n_rep) running sum
  float* alpha;   // (n_rep) rescale of the running state
  float* sk;      // (nh) K scales of the page
  float* sv;      // (nh)
  int8_t* pk;     // (nh, k, k) K corners of the page
  int8_t* pv;
};

// scores p[r][a] = q[r] . kt[a]; one warp per (r, a) pair, lanes over hd
__device__ void score(const Smem& s, int n_rep, int hd, int warp, int lane) {
  for (int pair = warp; pair < n_rep * 8; pair += kWarps) {
    const int r = pair >> 3, a = pair & 7;
    float acc = 0.f;
    for (int c = lane; c < hd; c += 32) acc = fmaf(s.q[r * hd + c], s.kt[a * hd + c], acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) s.p[r * 8 + a] = acc;
  }
}

// online-softmax step over 8 positions (valid[i] masks the tail)
__device__ void softmax_step(const Smem& s, int n_rep, int nvalid) {
  const int r = threadIdx.x;
  if (r >= n_rep) return;
  float* p = s.p + r * 8;
  const float m_prev = s.m[r];
  float mx = -INFINITY;
  for (int i = 0; i < nvalid; ++i) mx = fmaxf(mx, p[i]);
  const float m_new = fmaxf(m_prev, mx);
  const float m_safe = isfinite(m_new) ? m_new : 0.f;
  float sum = 0.f;
  for (int i = 0; i < 8; ++i) {
    const float e = i < nvalid ? expf(p[i] - m_safe) : 0.f;
    p[i] = e;
    sum += e;
  }
  const float alpha = isfinite(m_prev) ? expf(m_prev - m_safe) : 0.f;
  s.alpha[r] = alpha;
  s.l[r] = s.l[r] * alpha + sum;
  s.m[r] = m_new;
}

template <typename TQ, typename TT, int K>
__global__ void __launch_bounds__(kThreads)
attend_paged_kernel(const int8_t* __restrict__ pk_pool, const float* __restrict__ sk_pool,
                    const int8_t* __restrict__ pv_pool, const float* __restrict__ sv_pool,
                    const TQ* __restrict__ q, const int* __restrict__ pos,
                    const int* __restrict__ table, int table_stride, int nblocks,
                    const TT* __restrict__ tail_k, const TT* __restrict__ tail_v,
                    float* __restrict__ out, int n_pages, int hkv, int n_rep,
                    int hd, float qscale) {
  extern __shared__ float smem_raw[];
  const int nh = hd / 8;
  Smem s;
  s.q = smem_raw;
  s.kt = s.q + n_rep * hd;
  s.vt = s.kt + 8 * hd;
  s.p = s.vt + 8 * hd;
  s.m = s.p + n_rep * 8;
  s.l = s.m + n_rep;
  s.alpha = s.l + n_rep;
  s.sk = s.alpha + n_rep;
  s.sv = s.sk + nh;
  s.pk = reinterpret_cast<int8_t*>(s.sv + nh);
  s.pv = s.pk + nh * K * K;

  const int bh = blockIdx.x;
  const int b = bh / hkv, h = bh - b * hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pos_b = pos[b];
  const int flushed = (pos_b / 8) * 8;
  int npages = flushed / 8;
  if (npages > nblocks) npages = nblocks;

  for (int e = tid; e < n_rep * hd; e += kThreads) {
    s.q[e] = to_f32(q[(size_t)bh * n_rep * hd + e]) * qscale;
  }
  if (tid < n_rep) {
    s.m[tid] = -INFINITY;
    s.l[tid] = 0.f;
  }
  float acc[kAccPerThread];
#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) acc[i] = 0.f;
  __syncthreads();

  const int page_corners = nh * K * K;
  for (int j = 0; j < npages; ++j) {
    int page = table[(size_t)b * table_stride + j];
    page = page < 0 ? 0 : (page >= n_pages ? n_pages - 1 : page);
    const size_t base = (size_t)page * hkv + h;  // (page, head) plane index
    for (int e = tid; e < page_corners; e += kThreads) {
      s.pk[e] = pk_pool[base * page_corners + e];
      s.pv[e] = pv_pool[base * page_corners + e];
    }
    for (int e = tid; e < nh; e += kThreads) {
      s.sk[e] = sk_pool[base * nh + e];
      s.sv[e] = sv_pool[base * nh + e];
    }
    __syncthreads();
    // decompress: thread per (K|V, feature column c); X[a][c] for a in 0..7
    for (int task = tid; task < 2 * hd; task += kThreads) {
      const bool is_v = task >= hd;
      const int c = is_v ? task - hd : task;
      const int jb = c >> 3, bc = c & 7;
      const int8_t* z = (is_v ? s.pv : s.pk) + jb * K * K;
      const float sc = (is_v ? s.sv : s.sk)[jb];
      float w[K];  // W[u] = sum_v (z[u][v] * scale) C[v][bc]
#pragma unroll
      for (int u = 0; u < K; ++u) {
        float t = 0.f;
#pragma unroll
        for (int v = 0; v < K; ++v) t = fmaf((float)z[u * K + v] * sc, fa_dct[v * 8 + bc], t);
        w[u] = t;
      }
      float* dst = is_v ? s.vt : s.kt;
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        float t = 0.f;
#pragma unroll
        for (int u = 0; u < K; ++u) t = fmaf(fa_dct[u * 8 + a], w[u], t);
        dst[a * hd + c] = t;
      }
    }
    __syncthreads();
    score(s, n_rep, hd, warp, lane);
    __syncthreads();
    softmax_step(s, n_rep, 8);  // whole pages lie below the watermark
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kAccPerThread; ++i) {
      const int e = tid + i * kThreads;
      if (e < n_rep * hd) {
        const int r = e / hd, c = e - r * hd;
        float t = acc[i] * s.alpha[r];
#pragma unroll
        for (int a = 0; a < 8; ++a) t = fmaf(s.p[r * 8 + a], s.vt[a * hd + c], t);
        acc[i] = t;
      }
    }
    // the next page's loads touch only pk/pv/sk/sv; kt/vt/p are rewritten
    // after the next barrier, when every thread has finished this update
  }
  __syncthreads();  // the tail overwrites kt/vt, which the last update read

  // raw tail: positions flushed + i, valid while <= pos[b]
  for (int e = tid; e < 8 * hd; e += kThreads) {
    const int i = e / hd, c = e - i * hd;
    const size_t src = (((size_t)b * 8 + i) * hkv + h) * hd + c;
    s.kt[e] = to_f32(tail_k[src]);
    s.vt[e] = to_f32(tail_v[src]);
  }
  __syncthreads();
  score(s, n_rep, hd, warp, lane);
  __syncthreads();
  int nvalid = pos_b - flushed + 1;
  nvalid = nvalid > 8 ? 8 : nvalid;
  softmax_step(s, n_rep, nvalid);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) {
    const int e = tid + i * kThreads;
    if (e < n_rep * hd) {
      const int r = e / hd, c = e - r * hd;
      float t = acc[i] * s.alpha[r];
#pragma unroll
      for (int a = 0; a < 8; ++a) t = fmaf(s.p[r * 8 + a], s.vt[a * hd + c], t);
      out[(size_t)bh * n_rep * hd + e] = t / fmaxf(s.l[r], 1e-30f);
    }
  }
}

size_t smem_bytes(int n_rep, int hd, int keep) {
  const int nh = hd / 8;
  return sizeof(float) * ((size_t)n_rep * hd + 16 * hd + 8 * n_rep + 3 * n_rep + 2 * nh)
         + 2 * (size_t)nh * keep * keep;
}

template <typename TQ, typename TT>
int launch(const void* pk, const void* sk, const void* pv, const void* sv,
           const void* q, const int* pos, const int* table, int table_stride,
           int nblocks, const void* tk, const void* tv, float* out, int B,
           int n_pages, int hkv, int n_rep, int hd, int keep, float qscale,
           cudaStream_t stream) {
  const dim3 grid(B * hkv), block(kThreads);
  const size_t smem = smem_bytes(n_rep, hd, keep);
  const int8_t* pkp = static_cast<const int8_t*>(pk);
  const int8_t* pvp = static_cast<const int8_t*>(pv);
  const float* skp = static_cast<const float*>(sk);
  const float* svp = static_cast<const float*>(sv);
  const TQ* qp = static_cast<const TQ*>(q);
  const TT* tkp = static_cast<const TT*>(tk);
  const TT* tvp = static_cast<const TT*>(tv);
  switch (keep) {
#define FA_CASE(K) \
    case K: attend_paged_kernel<TQ, TT, K><<<grid, block, smem, stream>>>( \
        pkp, skp, pvp, svp, qp, pos, table, table_stride, nblocks, tkp, tvp, out, \
        n_pages, hkv, n_rep, hd, qscale); break;
    FA_CASE(1) FA_CASE(2) FA_CASE(3) FA_CASE(4)
    FA_CASE(5) FA_CASE(6) FA_CASE(7) FA_CASE(8)
#undef FA_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fa_set_dct(const void* host_c8) {
  const cudaError_t err = cudaMemcpyToSymbol(fa_dct, host_c8, 64 * sizeof(float));
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// Pool planes of one layer: packed_k/v (P, Hkv, hd/8, k, k) int8, scale_k/v
// (P, Hkv, hd/8) f32; q (B, Hkv, n_rep, hd); pos (B,) int32; table rows of
// `table_stride` int32 entries, the first `nblocks` used; tails (B, 8, Hkv,
// hd); out (B, Hkv, n_rep, hd) f32.  q_bf16 / tail_bf16 select bf16 (1) or
// f32 (0) for q and for the tails.
extern "C" int fa_attend_paged(const void* pk, const void* sk, const void* pv,
                               const void* sv, const void* q, int q_bf16,
                               const void* pos, const void* table,
                               int table_stride, int nblocks, const void* tk,
                               const void* tv, int tail_bf16, void* out, int B,
                               int n_pages, int hkv, int n_rep, int hd,
                               int keep, float qscale, void* stream) {
  if (hd % 8 || n_rep * hd > kThreads * kAccPerThread || n_rep < 1 ||
      smem_bytes(n_rep, hd, keep) > 48 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  const int* posp = static_cast<const int*>(pos);
  const int* tp = static_cast<const int*>(table);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16 && tail_bf16) {
    return launch<__nv_bfloat16, __nv_bfloat16>(pk, sk, pv, sv, q, posp, tp, table_stride, nblocks,
                                                tk, tv, op, B, n_pages, hkv, n_rep, hd, keep, qscale, s);
  }
  if (q_bf16) {
    return launch<__nv_bfloat16, float>(pk, sk, pv, sv, q, posp, tp, table_stride, nblocks,
                                        tk, tv, op, B, n_pages, hkv, n_rep, hd, keep, qscale, s);
  }
  if (tail_bf16) {
    return launch<float, __nv_bfloat16>(pk, sk, pv, sv, q, posp, tp, table_stride, nblocks,
                                        tk, tv, op, B, n_pages, hkv, n_rep, hd, keep, qscale, s);
  }
  return launch<float, float>(pk, sk, pv, sv, q, posp, tp, table_stride, nblocks,
                              tk, tv, op, B, n_pages, hkv, n_rep, hd, keep, qscale, s);
}
