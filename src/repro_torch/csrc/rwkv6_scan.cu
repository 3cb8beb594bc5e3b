// RWKV-6 WKV recurrence for Hopper (sm_90a): the time sweep of the
// data-dependent-decay linear attention of RWKV-6 "Finch".
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan/rwkv6_scan.py
// (`rwkv6_scan`, pallas_call at :49, `_kernel` at :20; wrapper ops.py
// `wkv`).  Computes, as kernels/rwkv6_scan/ref.py does, per (batch b,
// head h) with state S [D, D] starting at 0:
//   o_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] = w_t[i] * S[i][j] + k_t[i] * v_t[j]
// for r, k, v, w [B, H, T, D] float32 (any strides, last dimension
// contiguous), u [H, D], D <= 64, any T >= 1; o [B, H, T, D] contiguous.
//
// Design.  The bonus term leaves the state loop:
//   sum_i r_t[i] u[i] k_t[i] v_t[j] = v_t[j] * beta_t,
//   beta_t = sum_i r_t[i] u[i] k_t[i],
// so o_t[j] = sum_i r_t[i] S[i][j] (S before its update) + v_t[j] beta_t,
// and a state element costs three FP32 instructions a step: k v, the
// FMA into o's partial, the FMA of the update (kernels/rwkv6_scan/ref.py
// `rwkv6_split_ref` is this summation in plain PyTorch).  One block of
// 128 threads owns one (b, h) and runs the whole time loop.  Thread (row
// group rg, column group cg) keeps a 4 x 8 tile of S in registers: rows
// 4 rg .. 4 rg + 3, columns 8 cg .. 8 cg + 7.
//
// What bounds a step is the bytes that shared memory delivers to the
// threads (128 B a clock an SM, whatever the broadcast: a warp's 16-byte
// load takes four clocks even when its lanes share four addresses): each
// thread reads the r, k, w of its rows and the v of its columns and
// writes one partial of o per column.  A 4 x 8 tile needs 4 (3 * 4 + 8 +
// 8) = 112 bytes for 32 elements, 3.5 an element; a 4 x 2 tile on 512
// blocks of 128 threads (16 warps an SM) needs 8 and a 16 x 1 column
// 12.5, and their times on the card followed those bytes (PERF.md).  A
// larger tile has too few warps to use the four schedulers of an SM,
// a smaller one moves more bytes.
//
// Steps go in chunks of kChunk behind one barrier each: every thread
// loads one 4-row group of r, k and w and a 4-column group of v of the
// next chunk into registers while the current chunk runs; at the
// chunk's start it forms its part of beta, which the 16 threads of a
// step sum with shuffles, and stages the values into shared memory.  A
// step's 16 row-group partials of o are summed, with v beta, during the
// next chunk by the thread that staged that step's v and holds its
// beta, two partials after each step.  Rows and columns past D are
// staged as zeros, which leave S and o unchanged.  All arithmetic is
// float32.
//
// Bound on an H100 at rwkv6-7b's prefill shape (B*H = 128, T = 2048,
// D = 64): the four inputs and the output, 335 MB, take 0.100 ms at
// 3.35 TB/s; the work is 5 FLOPs per state element and step (2 for
// S^T r, 3 for diag(w) S + k v^T), 5.4 GFLOP, 0.080 ms at 67 TFLOP/s
// float32; so it is bytes-bound.  This kernel is held by the SM instead:
// a step moves ~20 KB through shared memory on each of 128 SMs (~160
// clocks) and issues ~100 FP32 instructions on each scheduler, and with
// one warp a scheduler the two overlap little, ~2.5x the bound (PERF.md
// has the card's times).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxD = 64;
constexpr int kRows = 4;                          // rows of S a thread
constexpr int kRowGroups = kMaxD / kRows;         // 16
constexpr int kCols = 8;                          // columns of S a thread
constexpr int kColGroups = kMaxD / kCols;         // 8
constexpr int kThreads = kRowGroups * kColGroups; // 128
constexpr int kChunk = 8;                         // steps per barrier
constexpr int kQuads = kMaxD / 4;                 // 4-wide groups of D
// a row group's partials of a chunk, [kChunk][kMaxD], padded by 4 words
// so that 16-byte stores of two row groups fall on other banks
constexpr int kPartRow = kChunk * kMaxD + 4;
// staging: one 4-row group of r/k/w and one 4-column group of v a thread
static_assert(kChunk * kQuads == kThreads, "one 4-wide group a thread");
static_assert(kThreads == 128 && kColGroups == 8, "the lane layout below");
constexpr int kPartsPerStep = kRowGroups / kChunk;   // summed a step
static_assert(kPartsPerStep * kChunk == kRowGroups, "the partials' sum");
constexpr int kSmemFloats = 4 * 2 * kChunk * kMaxD
    + 2 * kRowGroups * kPartRow;
constexpr int kSmemBytes = kSmemFloats * 4;

struct Strides {
  int64_t b, h, t;                                // in elements
};

// the first n (0..4) of four floats at p, zeros after; kVec: p is 16-byte
// aligned and n is 0 or 4
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* p, int n) {
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (kVec) {
    if (n > 0) x = *reinterpret_cast<const float4*>(p);
  } else {
    if (n > 0) x.x = p[0];
    if (n > 1) x.y = p[1];
    if (n > 2) x.z = p[2];
    if (n > 3) x.w = p[3];
  }
  return x;
}

template <bool kVec>
__device__ __forceinline__ void store4(float* p, float4 x, int n) {
  if (kVec) {
    if (n > 0) *reinterpret_cast<float4*>(p) = x;
  } else {
    if (n > 0) p[0] = x.x;
    if (n > 1) p[1] = x.y;
    if (n > 2) p[2] = x.z;
    if (n > 3) p[3] = x.w;
  }
}

// acc += the n float4 rows p[0], p[kPartRow], ...
template <int n>
__device__ __forceinline__ void add_rows(float4& acc, const float* p) {
#pragma unroll
  for (int g = 0; g < n; ++g) {
    const float4 x = *reinterpret_cast<const float4*>(p + g * kPartRow);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
rwkv6_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, float* __restrict__ o,
                  int n_heads, int t_len, int d, Strides sr, Strides sk,
                  Strides sv, Strides sw) {
  // staged r, k, w, v of a chunk ([2][kChunk][kMaxD] each) and the row
  // groups' partials of o ([2][kRowGroups][kPartRow]); both
  // double-buffered by chunk parity
  extern __shared__ __align__(16) float smem[];
  float* const xr = smem;
  float* const xk = xr + 2 * kChunk * kMaxD;
  float* const xw = xk + 2 * kChunk * kMaxD;
  float* const xv = xw + 2 * kChunk * kMaxD;
  float* const part = xv + 2 * kChunk * kMaxD;
  const int b = blockIdx.x / n_heads, h = blockIdx.x % n_heads;
  const int tid = threadIdx.x;

  // staging role: step sc of a chunk, rows 4 sq .. 4 sq + 3 of r, k, w
  // and columns 4 sq .. 4 sq + 3 of v; the same thread sums those four
  // outputs of step sc
  const int sc = tid / kQuads, sq = tid % kQuads;
  const int nq = min(max(d - 4 * sq, 0), 4);     // rows/columns below D
  const float* pr = r + b * sr.b + h * sr.h + 4 * sq;
  const float* pk = k + b * sk.b + h * sk.h + 4 * sq;
  const float* pw = w + b * sw.b + h * sw.h + 4 * sq;
  const float* pv = v + b * sv.b + h * sv.h + 4 * sq;
  const float4 uq = load4<false>(u + static_cast<int64_t>(h) * d + 4 * sq,
                                 nq);
  float4 br, bk, bw, bv;

  // compute role: row group rg, column group cg; in a quarter-warp the
  // two row groups and four column groups put the 16-byte partial stores
  // on eight different bank groups (kPartRow = 4 mod 32 words)
  const int lane = tid & 31;
  const int cg = (lane & 3) | (((lane >> 3) & 1) << 2);
  const int rg = (tid >> 5) * 4 + (((lane >> 2) & 1) | ((lane >> 4) << 1));
  const int i0 = kRows * rg, j0 = kCols * cg;
  float s[kRows][kCols];
#pragma unroll
  for (int e = 0; e < kRows; ++e)
#pragma unroll
    for (int q = 0; q < kCols; ++q) s[e][q] = 0.f;

  float* ob = o + (static_cast<int64_t>(b) * n_heads + h) * t_len * d
      + 4 * sq;
  float4 prev_v = make_float4(0.f, 0.f, 0.f, 0.f);
  float prev_beta = 0.f;
  const int n_chunks = (t_len + kChunk - 1) / kChunk;

#define RWKV6_FETCH(step)                                                \
  do {                                                                   \
    const int tt_ = (step);                                              \
    const int n_ = tt_ < t_len ? nq : 0;                                 \
    br = load4<kVec>(pr + tt_ * sr.t, n_);                               \
    bk = load4<kVec>(pk + tt_ * sk.t, n_);                               \
    bw = load4<kVec>(pw + tt_ * sw.t, n_);                               \
    bv = load4<kVec>(pv + tt_ * sv.t, n_);                               \
  } while (0)

  RWKV6_FETCH(sc);
  for (int n = 0; n <= n_chunks; ++n) {
    const int p = n & 1;
    const int t0 = n * kChunk;
    float beta = 0.f;
    float4 cur_v = bv;
    if (n < n_chunks) {
      // beta of step t0 + sc over the 16 stagers of that step (one
      // half-warp)
      beta = br.x * uq.x * bk.x;
      beta = fmaf(br.y * uq.y, bk.y, beta);
      beta = fmaf(br.z * uq.z, bk.z, beta);
      beta = fmaf(br.w * uq.w, bk.w, beta);
#pragma unroll
      for (int off = kQuads / 2; off > 0; off >>= 1)
        beta += __shfl_xor_sync(0xffffffffu, beta, off);
      const int at = (p * kChunk + sc) * kMaxD + 4 * sq;
      *reinterpret_cast<float4*>(xr + at) = br;
      *reinterpret_cast<float4*>(xk + at) = bk;
      *reinterpret_cast<float4*>(xw + at) = bw;
      *reinterpret_cast<float4*>(xv + at) = bv;
    }
    __syncthreads();
    if (n + 1 < n_chunks) RWKV6_FETCH(t0 + kChunk + sc);
    // the previous chunk's outputs of step te, columns 4 sq .. 4 sq + 3:
    // v beta plus the 16 row groups' partials, two of which are added
    // after each step of this chunk, so that their shared-memory reads
    // fall among the FMAs
    float4 eo = make_float4(prev_v.x * prev_beta, prev_v.y * prev_beta,
                            prev_v.z * prev_beta, prev_v.w * prev_beta);
    const float* pp = part + (p ^ 1) * kRowGroups * kPartRow + sc * kMaxD
        + 4 * sq;
    const int te = t0 - kChunk + sc;
    if (n == n_chunks) {
      add_rows<kRowGroups>(eo, pp);
      if (te < t_len)
        store4<kVec>(ob + static_cast<int64_t>(te) * d, eo, nq);
      break;
    }
    prev_v = cur_v;
    prev_beta = beta;
    float* const pw_part = part + p * kRowGroups * kPartRow + rg * kPartRow
        + j0;
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int at = (p * kChunk + c) * kMaxD;
      const float4 r4 = *reinterpret_cast<const float4*>(xr + at + i0);
      const float4 k4 = *reinterpret_cast<const float4*>(xk + at + i0);
      const float4 w4 = *reinterpret_cast<const float4*>(xw + at + i0);
      const float4 va = *reinterpret_cast<const float4*>(xv + at + j0);
      const float4 vb = *reinterpret_cast<const float4*>(xv + at + j0 + 4);
      const float ra[kRows] = {r4.x, r4.y, r4.z, r4.w};
      const float ka[kRows] = {k4.x, k4.y, k4.z, k4.w};
      const float wa[kRows] = {w4.x, w4.y, w4.z, w4.w};
      const float vv[kCols] = {va.x, va.y, va.z, va.w,
                               vb.x, vb.y, vb.z, vb.w};
      float acc[kCols];
#pragma unroll
      for (int q = 0; q < kCols; ++q) acc[q] = 0.f;
#pragma unroll
      for (int e = 0; e < kRows; ++e)
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          acc[q] = fmaf(ra[e], s[e][q], acc[q]);
          s[e][q] = fmaf(wa[e], s[e][q], ka[e] * vv[q]);
        }
      *reinterpret_cast<float4*>(pw_part + c * kMaxD) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
      *reinterpret_cast<float4*>(pw_part + c * kMaxD + 4) =
          make_float4(acc[4], acc[5], acc[6], acc[7]);
      if (n > 0)
        add_rows<kPartsPerStep>(eo, pp + c * kPartsPerStep * kPartRow);
    }
    if (n > 0 && te < t_len)
      store4<kVec>(ob + static_cast<int64_t>(te) * d, eo, nq);
  }
#undef RWKV6_FETCH
}

// float4 loads of r, k, v, w and stores of o: every base 16-byte
// aligned, every stride and D a multiple of 4
bool vec_ok(const void* r, const void* k, const void* v, const void* w,
            int d, const int64_t* st) {
  if ((reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(k)
       | reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(w))
      % 16 != 0)
    return false;
  for (int i = 0; i < 12; ++i)
    if (st[i] % 4 != 0) return false;
  return d % 4 == 0;
}

// the instance for vec, with its dynamic shared memory allowed (once)
using Kernel = void (*)(const float*, const float*, const float*,
                        const float*, const float*, float*, int, int, int,
                        Strides, Strides, Strides, Strides);

cudaError_t instance(bool vec, Kernel* out) {
  static bool ready[2] = {false, false};
  const Kernel kern = vec ? rwkv6_scan_kernel<true>
                          : rwkv6_scan_kernel<false>;
  if (!ready[vec]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return e;
    ready[vec] = true;
  }
  *out = kern;
  return cudaSuccess;
}

}  // namespace

// r, k, v, w: float32 [B, H, T, D] with element strides (b, h, t) given
// per tensor and a contiguous last dimension; u: float32 [H, D]
// contiguous; o: float32 [B, H, T, D] contiguous, 16-byte aligned.
// Returns the cudaError_t of the launch.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, void* o,
                                 int b, int h, int t, int d,
                                 int64_t rb, int64_t rh, int64_t rt,
                                 int64_t kb, int64_t kh, int64_t kt,
                                 int64_t vb, int64_t vh, int64_t vt,
                                 int64_t wb, int64_t wh, int64_t wt,
                                 void* stream) {
  if (b < 0 || h <= 0 || t <= 0 || d <= 0 || d > kMaxD
      || static_cast<int64_t>(b) * h > 0x7fffffff
      || reinterpret_cast<uintptr_t>(o) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  const int64_t st[12] = {rb, rh, rt, kb, kh, kt, vb, vh, vt, wb, wh, wt};
  Kernel kern;
  const cudaError_t e = instance(vec_ok(r, k, v, w, d, st), &kern);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<b * h, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<float*>(o), h, t, d,
      Strides{rb, rh, rt}, Strides{kb, kh, kt}, Strides{vb, vh, vt},
      Strides{wb, wh, wt});
  return static_cast<int>(cudaGetLastError());
}

// The launch shape of the instance with 16-byte loads (one block a
// (b, h)): info[0] threads a block, [1] registers a thread, [2] local
// memory bytes a thread (spills), [3] shared memory bytes a block, [4]
// resident blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
// Returns the first cudaError_t.
extern "C" int rwkv6_scan_info(int* info) {
  Kernel kern;
  cudaError_t e = instance(true, &kern);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kern);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, kThreads,
                                                    kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  info[0] = kThreads;
  info[1] = attr.numRegs;
  info[2] = static_cast<int>(attr.localSizeBytes);
  info[3] = static_cast<int>(attr.sharedSizeBytes) + kSmemBytes;
  info[4] = blocks;
  return 0;
}
