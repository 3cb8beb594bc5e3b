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
// Design (flash-decoding inside a block).  One block of kWarps warps per
// (sequence b, KV head h); it reads its own block-table row (the Pallas
// kernel had it prefetched into SMEM), and warp w walks pages w, w +
// kWarps, ... of it with its own online-softmax state in registers: m
// and l for each of the G query heads of the KV head, and its part of
// the output columns.  A lane reads the slots of the warp's next 32
// pages at once, ahead of the walk.  Pages are read in place from the
// pools, never gathered into a copy, and an absent page is skipped by
// the warp alone: no barrier inside the page walk.  A token row of D
// columns is read by lpt lanes (the fewest, a power of two, that cover D
// at 8 columns a lane), a warp reads 32 / lpt rows at once, and a lane
// issues its 16-byte loads of kR rows of K and of V, and their mask
// bytes, before any math (at the serve shape, bf16 D = 128: 16 lanes a
// row, a page of 16 tokens in 8 loads of K and 8 of V).  A lane dots its
// 8 columns with the same columns of the G pre-scaled queries in
// registers; shuffles over the row's lanes give the score, over the warp
// the page's max (five shuffles each, whatever lpt, so that nothing
// branches on it); each lane then adds p v of its own rows into its
// columns, a masked token with p = 0 and its V row, which may hold
// anything, replaced by 0.  G is rounded up to kG = 1, 2, 4 or 8; the
// extra heads have q = 0 and are never written.  At the end the warp's
// row groups are summed by shuffles, and the kWarps states (m, l, part
// of o) merge once through shared memory, each rescaled by exp(m_w - m);
// a warp that saw nothing has m = -inf and weight 0, and a block that saw
// nothing writes 0.  All arithmetic is float32 (bf16 pools and queries
// are widened on load), the output rounded once to q's dtype.  Pools
// whose pages, rows or base addresses are not 16-byte aligned take the
// same kernel with scalar loads.  G <= 8, D <= 256.
//
// Bound on an H100: memory bytes.  The work reads each selected page's
// K and V rows of one head once, 2 * T * D * elem bytes per (b, h, page),
// about 4 ops per byte: at the serve phase's shapes (B 16, Hkv 8, K 16
// pages of T 16 tokens, D 128, bf16) a full table is 16.8 MB, 5 us at
// 3.35 TB/s.  128 blocks of 8 warps, one a SM, keep 8 warps x 8 KB of
// K and V in flight an SM, ~8 MB in all, above the ~3.3 MB that 3.35
// TB/s needs at ~1 us of latency.  What sets the time is one warp's walk
// of a page, ~1,500 dependent-chained instructions at a few warps an SM
// (PERF.md has the card's times).
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 8;
constexpr int kCols = 8;          // columns of a row a lane: D <= 256
constexpr int kMaxD = 32 * kCols;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// A lane's part of one token row: kCols columns, as kLoads loads of kE
// elements (one 16-byte word, or one element on the scalar path).
template <typename TP, bool kVec>
struct Row {
  static constexpr int kE = kVec ? 16 / static_cast<int>(sizeof(TP)) : 1;
  static constexpr int kLoads = kCols / kE;
  using Word = typename std::conditional<kVec, uint4, TP>::type;
  Word w[kLoads];

  // p: the row's first column; lc: this lane's place among lpt lanes
  __device__ __forceinline__ void load(const TP* p, int lc, int lpt, int d,
                                       bool ok) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int col = (lc + i * lpt) * kE;
      if (ok && col < d)
        w[i] = *reinterpret_cast<const Word*>(p + col);
      else
        w[i] = Word{};
    }
  }

  __device__ __forceinline__ void floats(float (&f)[kCols]) const {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      if constexpr (!kVec) {
        f[i] = to_f(w[i]);
      } else if constexpr (sizeof(TP) == 4) {
        f[4 * i] = __uint_as_float(w[i].x);
        f[4 * i + 1] = __uint_as_float(w[i].y);
        f[4 * i + 2] = __uint_as_float(w[i].z);
        f[4 * i + 3] = __uint_as_float(w[i].w);
      } else {
        const uint32_t u[4] = {w[i].x, w[i].y, w[i].z, w[i].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          f[8 * i + 2 * j] = __uint_as_float(u[j] << 16);
          f[8 * i + 2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
        }
      }
    }
  }
};

// v summed over the lanes of one row (xor 1 .. lpt / 2), or, with
// kAcross, over the row groups of a warp (xor lpt .. 16): five shuffles
// whatever lpt, so that no branch depends on it
template <bool kAcross, bool kMax>
__device__ __forceinline__ float reduce(float v, int lpt) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    if ((o < lpt) != kAcross) v = kMax ? fmaxf(v, w) : v + w;
  }
  return v;
}

template <typename TP, bool kVec, int kG>
__global__ void __launch_bounds__(kThreads, 1)
paged_attention_kernel(const void* __restrict__ qv, const TP* __restrict__ kp,
                       const TP* __restrict__ vp,
                       const int32_t* __restrict__ bt,
                       const uint8_t* __restrict__ mask,
                       void* __restrict__ ov, bool q_bf16, int hq, int hkv,
                       int d, int n_slots, int t, int kpages,
                       int64_t page_stride, float scale, int lpt) {
  using R = Row<TP, kVec>;
  constexpr int kE = R::kE, kLoads = R::kLoads;
  // row loads a lane keeps in flight: ~64 registers of K and V
  constexpr int kRegsPerRow = 2 * kLoads * (kVec ? 4 : 1);
  constexpr int kR = (kG == kMaxG ? 32 : 64) / kRegsPerRow;
  extern __shared__ float smem[];
  const int g = hq / hkv;
  const int b = blockIdx.x / hkv, h = blockIdx.x % hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tpw = 32 / lpt;          // rows a warp reads at once
  const int ts = lane / lpt, lc = lane % lpt;

  // this lane's columns of the G queries, pre-scaled; heads past G (kG
  // rounds G up) are zero and never written
  float qr[kG][kCols];
  const int64_t q0 = (static_cast<int64_t>(b) * hq + h * g) * d;
#pragma unroll
  for (int gi = 0; gi < kG; ++gi) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const int col = (lc + i * lpt) * kE + e;
        float v = 0.f;
        if (gi < g && col < d) {
          const int64_t at = q0 + gi * d + col;
          v = q_bf16 ? __bfloat162float(
                           static_cast<const __nv_bfloat16*>(qv)[at])
                     : static_cast<const float*>(qv)[at];
        }
        qr[gi][i * kE + e] = v * scale;
      }
    }
  }

  float m[kG], l[kG], acc[kG][kCols];
#pragma unroll
  for (int gi = 0; gi < kG; ++gi) {
    m[gi] = -INFINITY;
    l[gi] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[gi][c] = 0.f;
  }

  const int64_t row_stride = static_cast<int64_t>(hkv) * d;  // one token
  const int rows = (t + tpw - 1) / tpw;       // row loads a lane a page
  const int32_t* btb = bt + static_cast<int64_t>(b) * kpages;
  // the warp's pages are w, w + kWarps, ...: lane i holds the slot of its
  // i-th (of each 32), read ahead of the walk
  int my_slot = -1;
  for (int it = 0, j = warp; j < kpages; ++it, j += kWarps) {
    if ((it & 31) == 0) {
      const int jj = j + kWarps * lane;
      my_slot = jj < kpages ? btb[jj] : -1;
    }
    const int slot = __shfl_sync(0xffffffffu, my_slot, it & 31);
    if (slot < 0 || slot >= n_slots) continue;    // uniform over the warp
    const uint8_t* mk = mask + (static_cast<int64_t>(b) * kpages + j) * t;
    const int64_t page = static_cast<int64_t>(slot) * page_stride
                         + static_cast<int64_t>(h) * d;
    for (int r0 = 0; r0 < rows; r0 += kR) {
      // K, V and the mask of kR rows, all loads issued before any math
      R kr[kR], vr[kR];
      bool ok[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int tok = (r0 + r) * tpw + ts;
        const bool in = tok < t;
        ok[r] = in && mk[tok] != 0;
        kr[r].load(kp + page + tok * row_stride, lc, lpt, d, in);
        vr[r].load(vp + page + tok * row_stride, lc, lpt, d, in);
      }
      // scores of this lane's rows, summed over the row's lanes
      float s[kR][kG];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        float kf[kCols];
        kr[r].floats(kf);
#pragma unroll
        for (int gi = 0; gi < kG; ++gi) {
          float part = 0.f;
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            part = fmaf(qr[gi][c], kf[c], part);
          part = reduce<false, false>(part, lpt);
          s[r][gi] = ok[r] ? part : -INFINITY;
        }
      }
      // online softmax: m stays the same over the warp; a masked token
      // has p = 0 (and its V row, which may hold anything, is not read)
#pragma unroll
      for (int gi = 0; gi < kG; ++gi) {
        float mx = s[0][gi];
#pragma unroll
        for (int r = 1; r < kR; ++r) mx = fmaxf(mx, s[r][gi]);
        const float m_new = fmaxf(m[gi], reduce<true, true>(mx, lpt));
        const float alpha =
            m_new == -INFINITY ? 1.f : expf(m[gi] - m_new);
        m[gi] = m_new;
        l[gi] *= alpha;
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[gi][c] *= alpha;
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float p = ok[r] ? expf(s[r][gi] - m_new) : 0.f;
          l[gi] += p;
          s[r][gi] = p;
        }
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        float vf[kCols];
        vr[r].floats(vf);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float v = ok[r] ? vf[c] : 0.f;
#pragma unroll
          for (int gi = 0; gi < kG; ++gi)
            acc[gi][c] = fmaf(s[r][gi], v, acc[gi][c]);
        }
      }
    }
  }

  // sum the warp's row groups, then merge the warps' states
#pragma unroll
  for (int gi = 0; gi < kG; ++gi) {
    l[gi] = reduce<true, false>(l[gi], lpt);
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      acc[gi][c] = reduce<true, false>(acc[gi][c], lpt);
  }
  float* part = smem;                             // [kWarps][g][d]
  float* ml = smem + kWarps * g * d;              // [kWarps][g][2]
  if (ts == 0) {
#pragma unroll
    for (int gi = 0; gi < kG; ++gi) {
      if (gi >= g) break;
#pragma unroll
      for (int i = 0; i < kLoads; ++i)
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const int col = (lc + i * lpt) * kE + e;
          if (col < d) part[(warp * g + gi) * d + col] = acc[gi][i * kE + e];
        }
      if (lc == 0) {
        ml[(warp * g + gi) * 2] = m[gi];
        ml[(warp * g + gi) * 2 + 1] = l[gi];
      }
    }
  }
  __syncthreads();
  const int64_t o0 = (static_cast<int64_t>(b) * hq + h * g) * d;
  for (int i = threadIdx.x; i < g * d; i += kThreads) {
    const int gi = i / d;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, ml[(w * g + gi) * 2]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = ml[(w * g + gi) * 2];
      // a warp that saw nothing (m = -inf) weighs 0
      const float f = mw == -INFINITY ? 0.f : expf(mw - mm);
      den = fmaf(ml[(w * g + gi) * 2 + 1], f, den);
      num = fmaf(part[(w * g + gi) * d + i % d], f, num);
    }
    const float out = num / fmaxf(den, 1e-30f);
    if (q_bf16)
      static_cast<__nv_bfloat16*>(ov)[o0 + i] = __float2bfloat16(out);
    else
      static_cast<float*>(ov)[o0 + i] = out;
  }
}

template <typename TP, bool kVec, int kG>
int launch(const void* q, const void* kp, const void* vp, const int32_t* bt,
           const uint8_t* mask, void* o, bool q_bf16, int b, int hq,
           int hkv, int d, int n_slots, int t, int kpages,
           int64_t page_stride, float scale, cudaStream_t s) {
  int lpt = 1;                          // lanes a row: 8 columns a lane
  while (lpt * kCols < d) lpt *= 2;
  const int bytes = kWarps * (hq / hkv) * (d + 2) * 4;
  auto kern = paged_attention_kernel<TP, kVec, kG>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<b * hkv, kThreads, bytes, s>>>(
      q, static_cast<const TP*>(kp), static_cast<const TP*>(vp), bt, mask, o,
      q_bf16, hq, hkv, d, n_slots, t, kpages, page_stride, scale, lpt);
  return static_cast<int>(cudaGetLastError());
}

template <typename TP, bool kVec>
int launch_g(const void* q, const void* kp, const void* vp,
             const int32_t* bt, const uint8_t* mask, void* o, bool q_bf16,
             int b, int hq, int hkv, int d, int n_slots, int t, int kpages,
             int64_t page_stride, float scale, cudaStream_t s) {
  const int g = hq / hkv;
  auto go = [&](auto kg) {
    return launch<TP, kVec, decltype(kg)::value>(
        q, kp, vp, bt, mask, o, q_bf16, b, hq, hkv, d, n_slots, t, kpages,
        page_stride, scale, s);
  };
  if (g == 1) return go(std::integral_constant<int, 1>{});
  if (g == 2) return go(std::integral_constant<int, 2>{});
  if (g <= 4) return go(std::integral_constant<int, 4>{});
  return go(std::integral_constant<int, 8>{});
}

template <typename TP>
int launch_tp(const void* q, const void* kp, const void* vp,
              const int32_t* bt, const uint8_t* mask, void* o, bool q_bf16,
              int b, int hq, int hkv, int d, int n_slots, int t, int kpages,
              int64_t page_stride, float scale, cudaStream_t s) {
  constexpr int kE = 16 / static_cast<int>(sizeof(TP));
  const bool vec = d % kE == 0 && page_stride % kE == 0
                   && reinterpret_cast<uintptr_t>(kp) % 16 == 0
                   && reinterpret_cast<uintptr_t>(vp) % 16 == 0;
  if (vec)
    return launch_g<TP, true>(q, kp, vp, bt, mask, o, q_bf16, b, hq, hkv, d,
                              n_slots, t, kpages, page_stride, scale, s);
  return launch_g<TP, false>(q, kp, vp, bt, mask, o, q_bf16, b, hq, hkv, d,
                             n_slots, t, kpages, page_stride, scale, s);
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
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > kMaxG || d <= 0 || d > kMaxD
      || t <= 0 || q_dtype < 0 || q_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* bti = static_cast<const int32_t*>(bt);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  const bool q_bf16 = q_dtype == 1;
  if (pool_dtype == 0)
    return launch_tp<float>(q, kp, vp, bti, mk, o, q_bf16, b, hq, hkv, d,
                            n_slots, t, kpages, page_stride, scale, s);
  if (pool_dtype == 1)
    return launch_tp<__nv_bfloat16>(q, kp, vp, bti, mk, o, q_bf16, b, hq,
                                    hkv, d, n_slots, t, kpages, page_stride,
                                    scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
