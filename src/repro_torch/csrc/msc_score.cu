// approx-MSC candidate scoring (PrismDB Eq. 1) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/msc_score/msc_score.py
// (`msc_scores`, pallas_call at :58; wrapper ops.py `score_candidates`).
// For each of K candidate ranges [lo, hi) it builds the coverage weight
// w[b] = clip((min(edge_b + bw, hi) - max(edge_b, lo)) / bw, 0, 1) of
// every bucket b, the five weighted sums of
//   [h.inv + untracked, n_fast, h.probs, n_slow, overlap]
// and the score benefit / (f (2 - o) / (1 - p) + 1), as
// kernels/msc_score/ref.py does.
//
// Design.  One block; warp k scores candidate k, its lanes stride over
// the buckets (one 16-byte load of a bucket's clock histogram) and the
// five sums are reduced with warp shuffles.  Then warp 0 picks the best
// candidate as jnp.argmax does (src/repro/core/msc.py:248): the first
// index among equal maxima, NaN above every number.  So one launch
// scores a compaction's candidates and chooses among them.  All
// arithmetic is float32 FMA/adds in the kernel body: the Pallas kernel
// used two small MXU products, which here would be cuBLAS calls or
// tensor-core TF32; neither is taken.  The order of the sums differs
// from the plain version, so the scores agree to rtol 1e-5, not bit for
// bit, and the pick may differ from the plain argmax at a near-tie.
//
// Bound on an H100: memory bytes, and tiny: the inputs are ~8 KB at
// K = 8, B = 256 (the per-bucket vectors and the [B, 4] histogram are
// read once per warp from L2), ~2.5 ns at 3.35 TB/s; the ~2e4 float32
// operations take ~0.3 ns at 67 TFLOP/s.  The kernel's time is launch
// latency.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// a ranks above b: jnp.argmax's order (NaN highest, then value, then the
// lower index)
__device__ __forceinline__ bool ranks_above(float a, int ia, float b,
                                            int ib) {
  const bool na = a != a, nb = b != b;           // NaN
  if (na != nb) return na;
  if (!na && a != b) return a > b;
  return ia < ib;
}

__global__ void msc_score_kernel(const int32_t* __restrict__ lo,
                                 const int32_t* __restrict__ hi,
                                 const int32_t* __restrict__ tf,
                                 const int32_t* __restrict__ nf,
                                 const int32_t* __restrict__ ns,
                                 const int32_t* __restrict__ ov,
                                 const int4* __restrict__ hist,
                                 const float* __restrict__ probs, int k,
                                 int nb, int bw, float* __restrict__ out,
                                 int64_t* __restrict__ best) {
  __shared__ float score[32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int32_t l = lo[warp], h = hi[warp];
  const float inv1 = 1.0f, inv2 = 1.0f / 2.0f, inv3 = 1.0f / 3.0f,
              inv4 = 1.0f / 4.0f;
  const float p0 = probs[0], p1 = probs[1], p2 = probs[2], p3 = probs[3];
  const float fbw = static_cast<float>(bw);
  float s_ben = 0.f, s_tn = 0.f, s_pin = 0.f, s_ns = 0.f, s_ov = 0.f;
  for (int b = lane; b < nb; b += 32) {
    const int32_t e = b * bw;
    const int32_t inter = min(e + bw, h) - max(e, l);
    const float w = fminf(fmaxf(static_cast<float>(inter) / fbw, 0.f), 1.f);
    const int4 hb = hist[b];
    const float h0 = static_cast<float>(hb.x);
    const float h1 = static_cast<float>(hb.y);
    const float h2 = static_cast<float>(hb.z);
    const float h3 = static_cast<float>(hb.w);
    const float fn = static_cast<float>(nf[b]);
    const float untracked = fmaxf(fn - (h0 + h1 + h2 + h3), 0.f);
    const float hinv = h0 * inv1 + h1 * inv2 + h2 * inv3 + h3 * inv4;
    const float hp = h0 * p0 + h1 * p1 + h2 * p2 + h3 * p3;
    s_ben += w * (hinv + untracked);
    s_tn += w * fn;
    s_pin += w * hp;
    s_ns += w * static_cast<float>(ns[b]);
    s_ov += w * static_cast<float>(ov[b]);
  }
  s_ben = warp_sum(s_ben);
  s_tn = warp_sum(s_tn);
  s_pin = warp_sum(s_pin);
  s_ns = warp_sum(s_ns);
  s_ov = warp_sum(s_ov);
  if (lane == 0) {
    const float p = fminf(fmaxf(s_pin / fmaxf(s_tn, 1.f), 0.f), 0.999f);
    const float tf_est = fmaxf(s_ns, static_cast<float>(tf[warp]));
    const float o = fminf(fmaxf(s_ov / fmaxf(tf_est, 1.f), 0.f), 1.f);
    const float f = tf_est / fmaxf(s_tn, 1.f);
    const float cost = f * (2.f - o) / (1.f - p) + 1.f;
    const float sc = s_tn > 0.f ? s_ben / cost : 0.f;
    out[warp] = sc;
    score[warp] = sc;
  }
  __syncthreads();
  if (warp == 0) {
    // lanes past K hold -inf at an index past K: below every candidate
    float x = lane < k ? score[lane] : -INFINITY;
    int ix = lane;
    for (int off = 16; off > 0; off >>= 1) {
      const float ox = __shfl_xor_sync(0xffffffffu, x, off);
      const int oi = __shfl_xor_sync(0xffffffffu, ix, off);
      if (ranks_above(ox, oi, x, ix)) {
        x = ox;
        ix = oi;
      }
    }
    if (lane == 0) *best = ix;
  }
}

}  // namespace

// lo, hi, tf: int32[K]; nf, ns, ov: int32[B]; hist: int32[B, 4], 16-byte
// aligned; probs: float32[4]; out: float32[K]; best: int64, the index of
// the best candidate.  1 <= K <= 32.  Returns the cudaError_t of the
// launch.
extern "C" int msc_score_launch(const int32_t* lo, const int32_t* hi,
                                const int32_t* tf, const int32_t* nf,
                                const int32_t* ns, const int32_t* ov,
                                const int32_t* hist, const float* probs,
                                int k, int nb, int bw, float* out,
                                int64_t* best, void* stream) {
  if (k <= 0 || k > 32 || reinterpret_cast<uintptr_t>(hist) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  msc_score_kernel<<<1, 32 * k, 0, static_cast<cudaStream_t>(stream)>>>(
      lo, hi, tf, nf, ns, ov, reinterpret_cast<const int4*>(hist), probs, k,
      nb, bw, out, best);
  return static_cast<int>(cudaGetLastError());
}
