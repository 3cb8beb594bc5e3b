// Paged decode attention for Hopper (sm_90a): one query token per
// sequence over the pages of its block table, with a token mask, GQA and
// an online softmax.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/
// paged_attention.py (`paged_attention`, pallas_call at :101; wrapper
// ops.py `decode_attention`).  Computes, as kernels/paged_attention/
// ref.py does, for q [B, Hq, D], page pools [P, T, Hkv, D], block tables
// [B, K] (slot -1 = absent) and a token mask [B, K, T]: the softmax over
// every present, unmasked token of the K pages of q . k * scale, applied
// to v.  A sequence that sees nothing gives 0 (the plain version's
// isfinite guards give 0 too).
//
// Design.  One block of 128 threads per (sequence b, KV head h); it
// reads its own block-table row (the Pallas kernel had it prefetched
// into SMEM) and walks the K pages in order, skipping absent slots; pages
// are read in place from the pools, never gathered into a copy.  Per
// page, warp w scores tokens w, w + 4, ... for all G query heads of the
// KV head at once (lanes stride the head dim; warp-shuffle sums) into
// shared memory, then every thread updates the G online-softmax states
// (m, l, identical in every thread) and its own output columns, reading
// each V row once for all G heads.  q is pre-scaled in shared memory;
// all arithmetic is float32 (bf16 pools and queries are widened on
// load), the output rounded once to q's dtype.  G <= 8, D <= 256.
//
// Bound on an H100: memory bytes.  The work reads each selected page's
// K and V rows of one head once, 2 * T * D * elem bytes per (b, h, page),
// about 4 ops per byte: at the serve phase's shapes (B 16, Hkv 8, K 16
// pages of T 16 tokens, D 128, bf16) that is 16.8 MB, 5 us at 3.35 TB/s.
// This kernel walks the pages of a (b, h) in sequence with a barrier per
// page, so at that size its time is latency, not bandwidth.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;
constexpr int kCols = 2;  // output columns per thread: D <= 256

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename TQ, typename TP>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const TQ* __restrict__ q, const TP* __restrict__ kp,
                       const TP* __restrict__ vp,
                       const int32_t* __restrict__ bt,
                       const uint8_t* __restrict__ mask, TQ* __restrict__ o,
                       int hq, int hkv, int d, int n_slots, int t,
                       int kpages, int64_t page_stride, float scale) {
  extern __shared__ float smem[];
  const int g = hq / hkv;
  float* qs = smem;          // [g][d], pre-scaled
  float* sc = qs + g * d;    // [g][t] scores of the current page
  const int b = blockIdx.x / hkv, h = blockIdx.x % hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const TQ* qb = q + (static_cast<int64_t>(b) * hq + h * g) * d;
  for (int i = tid; i < g * d; i += kThreads) qs[i] = ld(qb + i) * scale;

  float m[kMaxG], l[kMaxG], acc[kMaxG][kCols];
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) {
    m[gi] = -INFINITY;
    l[gi] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[gi][c] = 0.f;
  }
  __syncthreads();

  const int64_t row_stride = static_cast<int64_t>(hkv) * d;  // one token
  for (int j = 0; j < kpages; ++j) {
    const int slot = bt[static_cast<int64_t>(b) * kpages + j];
    if (slot < 0 || slot >= n_slots) continue;  // uniform over the block
    const uint8_t* mk = mask + (static_cast<int64_t>(b) * kpages + j) * t;
    const int64_t page = static_cast<int64_t>(slot) * page_stride
                         + static_cast<int64_t>(h) * d;
    for (int tt = warp; tt < t; tt += kWarps) {
      const bool ok = mk[tt] != 0;
      float part[kMaxG];
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi) part[gi] = 0.f;
      if (ok) {
        const TP* kr = kp + page + tt * row_stride;
        for (int c = lane; c < d; c += 32) {
          const float kv = ld(kr + c);
#pragma unroll
          for (int gi = 0; gi < kMaxG; ++gi)
            if (gi < g) part[gi] = fmaf(qs[gi * d + c], kv, part[gi]);
        }
      }
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi) {
        if (gi < g) {
          const float s = warp_sum(part[gi]);
          if (lane == 0) sc[gi * t + tt] = ok ? s : -INFINITY;
        }
      }
    }
    __syncthreads();

    float m_new[kMaxG];
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) {
      m_new[gi] = m[gi];
      if (gi < g) {
        for (int tt = 0; tt < t; ++tt)
          m_new[gi] = fmaxf(m_new[gi], sc[gi * t + tt]);
        const float alpha =
            m_new[gi] == -INFINITY ? 1.f : expf(m[gi] - m_new[gi]);
        l[gi] *= alpha;
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[gi][c] *= alpha;
      }
    }
    for (int tt = 0; tt < t; ++tt) {
      if (!mk[tt]) continue;
      float p[kMaxG];
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi) {
        p[gi] = 0.f;
        if (gi < g) {
          p[gi] = expf(sc[gi * t + tt] - m_new[gi]);
          l[gi] += p[gi];
        }
      }
      const TP* vr = vp + page + tt * row_stride;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = tid + c * kThreads;
        if (col < d) {
          const float vv = ld(vr + col);
#pragma unroll
          for (int gi = 0; gi < kMaxG; ++gi)
            acc[gi][c] = fmaf(p[gi], vv, acc[gi][c]);
        }
      }
    }
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) m[gi] = m_new[gi];
    __syncthreads();  // sc is rewritten by the next page
  }

  TQ* ob = o + (static_cast<int64_t>(b) * hq + h * g) * d;
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) {
    if (gi >= g) break;
    const float den = fmaxf(l[gi], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tid + c * kThreads;
      if (col < d) st(ob + gi * d + col, acc[gi][c] / den);
    }
  }
}

template <typename TQ, typename TP>
int launch(const void* q, const void* kp, const void* vp, const int32_t* bt,
           const uint8_t* mask, void* o, int b, int hq, int hkv, int d,
           int n_slots, int t, int kpages, int64_t page_stride, float scale,
           cudaStream_t s) {
  const int bytes = (hq / hkv) * (d + t) * 4;
  if (bytes > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  paged_attention_kernel<TQ, TP><<<b * hkv, kThreads, bytes, s>>>(
      static_cast<const TQ*>(q), static_cast<const TP*>(kp),
      static_cast<const TP*>(vp), bt, mask, static_cast<TQ*>(o), hq, hkv, d,
      n_slots, t, kpages, page_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q_dtype / pool_dtype: 0 = float32, 1 = bfloat16.  q [B, Hq, D]
// contiguous; the pools [n_slots, T, Hkv, D] with each page contiguous
// and pages page_stride elements apart (a layer's slice of a slot-major
// [L, P, T, Hkv, D] pool); block tables int32 [B, K]; mask uint8
// [B, K, T]; output [B, Hq, D] in q's dtype.  Returns the cudaError_t of
// the launch.
extern "C" int paged_attention_launch(const void* q, const void* kp,
                                      const void* vp, const void* bt,
                                      const void* mask, void* o,
                                      int q_dtype, int pool_dtype, int b,
                                      int hq, int hkv, int d, int n_slots,
                                      int t, int kpages,
                                      int64_t page_stride, float scale,
                                      void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > kMaxG || d <= 0
      || d > kCols * kThreads || t <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* bti = static_cast<const int32_t*>(bt);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  if (q_dtype == 0 && pool_dtype == 0)
    return launch<float, float>(q, kp, vp, bti, mk, o, b, hq, hkv, d,
                                n_slots, t, kpages, page_stride, scale,
                                s);
  if (q_dtype == 0 && pool_dtype == 1)
    return launch<float, __nv_bfloat16>(q, kp, vp, bti, mk, o, b, hq, hkv,
                                        d, n_slots, t, kpages, page_stride,
                                        scale, s);
  if (q_dtype == 1 && pool_dtype == 0)
    return launch<__nv_bfloat16, float>(q, kp, vp, bti, mk, o, b, hq, hkv,
                                        d, n_slots, t, kpages, page_stride,
                                        scale, s);
  if (q_dtype == 1 && pool_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, kp, vp, bti, mk, o, b,
                                                hq, hkv, d, n_slots, t,
                                                kpages, page_stride, scale,
                                                s);
  return static_cast<int>(cudaErrorInvalidValue);
}
