// Forward attention with GQA, causal and sliding-window masks, online
// softmax, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/
// flash_attention.py (`flash_attention_folded`, pallas_call at :91;
// wrapper ops.py `mha`).  Computes, as kernels/flash_attention/ref.py
// does, o = softmax(q k^T * scale + mask) v for q [B, Hq, Sq, D] and k/v
// [B, Hkv, Sk, D], with query rows right-aligned to the keys
// (qpos = i + Sk - Sq), causal keeping kpos <= qpos and window > 0
// keeping kpos > qpos - window.  A row that sees no key gives 0, as the
// Pallas kernel does (acc / max(l, 1e-30)); the plain version gives NaN
// there.  No model path reaches such a row.
//
// Design.  One block of 128 threads per (b * Hkv + h, tile of R folded
// query rows); a row is (token, head in group), token-major, so the G
// query heads of a KV head share every K/V tile, as the Pallas kernel's
// GQA folding does.  The block walks the K/V tiles of kBK = 32 keys that
// its rows can see (causal and window bounds skip the rest), staged in
// shared memory as float32; the online-softmax state (m, l) and the
// output accumulator stay in registers: thread (rg, cg) of 16 x 8 owns
// R/16 rows, scores 4 interleaved keys of each tile (row maxima and sums
// reduced over the 8 threads of a row with shuffles) and D/8 interleaved
// output columns.  Shared-memory rows are padded by one word so the
// column-parallel reads fall on distinct banks.  Every product and sum
// is float32 FMA on the CUDA cores (no TF32, no tensor cores; bf16 inputs
// are widened on load and the result rounded once on store).  The head
// dim is a template parameter (16, 32, 64, 128, 256) and a smaller one is
// zero-padded in shared memory only: the kernel masks its own ragged
// edges (rows, keys, columns) and needs no padded copy of its inputs.
//
// Bound on an H100.  The work is 4 * B * Hq * D FLOPs per visible
// (query, key) pair.  At phi4-mini's prefill shape (B 2, Hq 24, Hkv 8,
// S 2048, D 128, causal) that is 51.6 GFLOP against 134 MB (f32) moved:
// bound by operations, 0.770 ms at the 67 TFLOP/s float32 peak and
// 0.052 ms at the 989 TFLOP/s bf16 tensor-core peak.  This kernel runs on
// the CUDA cores from shared memory, so it is far from either bound in
// bf16; the tensor-core version (mma/wgmma, TMA staging, warp
// specialisation) is later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;  // 16 row groups x 8 column groups
constexpr int kBK = 32;        // keys per tile

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float row_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}

__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

template <int D, int R>
constexpr int smem_floats() {
  return R * (D + 1) + 2 * kBK * (D + 1) + R * (kBK + 1);
}

template <typename T, int D, int R>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int hq,
                       int hkv, int sq, int sk, int d, int causal,
                       int window, float scale, int64_t qsb, int64_t qsh,
                       int64_t qss, int64_t ksb, int64_t ksh, int64_t kss,
                       int64_t vsb, int64_t vsh, int64_t vss) {
  constexpr int RT = R / 16;  // rows per thread
  constexpr int CT = kBK / 8;  // keys per thread per tile
  constexpr int DC = D / 8;    // output columns per thread
  constexpr int DP = D + 1;    // padded shared-memory row
  constexpr int PP = kBK + 1;
  extern __shared__ float smem[];
  float* qs = smem;            // [R][DP], pre-scaled
  float* ks = qs + R * DP;     // [kBK][DP]
  float* vs = ks + kBK * DP;   // [kBK][DP]
  float* ps = vs + kBK * DP;   // [R][PP]

  const int g = hq / hkv;
  const int b = blockIdx.y / hkv, h = blockIdx.y % hkv;
  const int rows = sq * g;
  const int row0 = blockIdx.x * R;
  const int tid = threadIdx.x;
  const int rg = tid >> 3, cg = tid & 7;
  const int off = sk - sq;
  const T* kb = k + b * ksb + h * ksh;
  const T* vb = v + b * vsb + h * vsh;

  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, c = i % D, row = row0 + r;
    float x = 0.f;
    if (row < rows && c < d)
      x = ld(q + b * qsb + static_cast<int64_t>(h * g + row % g) * qsh
             + static_cast<int64_t>(row / g) * qss + c) * scale;
    qs[r * DP + c] = x;
  }

  // the keys this tile's rows can see
  const int last = min(row0 + R, rows) - 1;
  const int qpos_first = row0 / g + off, qpos_last = last / g + off;
  int kend = causal ? min(sk, qpos_last + 1) : sk;
  kend = max(kend, 0);
  int kbeg = window > 0 ? max(0, qpos_first - window + 1) : 0;
  kbeg = (kbeg / kBK) * kBK;

  float m[RT], l[RT], acc[RT][DC];
  int qpos[RT];
  bool live[RT];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt) {
    const int row = row0 + rg * RT + rt;
    live[rt] = row < rows;
    qpos[rt] = row / g + off;
    m[rt] = -INFINITY;
    l[rt] = 0.f;
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) acc[rt][dc] = 0.f;
  }

  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    __syncthreads();  // the previous tile's reads are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D, kp = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (kp < sk && c < d) {
        kx = ld(kb + static_cast<int64_t>(kp) * kss + c);
        vx = ld(vb + static_cast<int64_t>(kp) * vss + c);
      }
      ks[r * DP + c] = kx;
      vs[r * DP + c] = vx;
    }
    __syncthreads();

    float s[RT][CT];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int j = 0; j < CT; ++j) s[rt][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float kk[CT];
#pragma unroll
      for (int j = 0; j < CT; ++j) kk[j] = ks[(j * 8 + cg) * DP + c];
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) {
        const float qq = qs[(rg * RT + rt) * DP + c];
#pragma unroll
        for (int j = 0; j < CT; ++j) s[rt][j] = fmaf(qq, kk[j], s[rt][j]);
      }
    }

#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int kp = k0 + j * 8 + cg;
        const bool ok = live[rt] && kp < sk && (!causal || kp <= qpos[rt])
                        && (window <= 0 || kp > qpos[rt] - window);
        if (!ok) s[rt][j] = -INFINITY;
        mx = fmaxf(mx, s[rt][j]);
      }
      const float m_new = fmaxf(m[rt], row_max(mx));
      float alpha = 1.f, sum = 0.f;
      if (m_new != -INFINITY) {
        alpha = expf(m[rt] - m_new);
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          s[rt][j] = s[rt][j] == -INFINITY ? 0.f : expf(s[rt][j] - m_new);
          sum += s[rt][j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < CT; ++j) s[rt][j] = 0.f;
      }
      l[rt] = l[rt] * alpha + row_sum(sum);
      m[rt] = m_new;
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) acc[rt][dc] *= alpha;
#pragma unroll
      for (int j = 0; j < CT; ++j)
        ps[(rg * RT + rt) * PP + j * 8 + cg] = s[rt][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float p[RT];
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) p[rt] = ps[(rg * RT + rt) * PP + j];
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) {
        const float vv = vs[j * DP + dc * 8 + cg];
#pragma unroll
        for (int rt = 0; rt < RT; ++rt)
          acc[rt][dc] = fmaf(p[rt], vv, acc[rt][dc]);
      }
    }
  }

#pragma unroll
  for (int rt = 0; rt < RT; ++rt) {
    if (!live[rt]) continue;
    const int row = row0 + rg * RT + rt;
    const float den = fmaxf(l[rt], 1e-30f);
    T* dst = o + (static_cast<int64_t>(b) * hq + h * g + row % g)
                     * static_cast<int64_t>(sq) * d
             + static_cast<int64_t>(row / g) * d;
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) {
      const int c = dc * 8 + cg;
      if (c < d) st(dst + c, acc[rt][dc] / den);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int sq, int sk, int d, int causal, int window,
           float scale, const int64_t* st3, cudaStream_t stream) {
  constexpr int R = D <= 128 ? 64 : 32;
  constexpr int bytes = smem_floats<D, R>() * 4;
  auto kern = flash_attention_kernel<T, D, R>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int64_t tiles = (static_cast<int64_t>(sq) * (hq / hkv) + R - 1) / R;
  if (tiles > 0x7fffffff || static_cast<int64_t>(b) * hkv > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  dim3 grid(static_cast<unsigned>(tiles), b * hkv);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, sq, sk, d,
      causal, window, scale, st3[0], st3[1], st3[2], st3[3], st3[4], st3[5],
      st3[6], st3[7], st3[8]);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int b,
             int hq, int hkv, int sq, int sk, int d, int causal, int window,
             float scale, const int64_t* st3, cudaStream_t s) {
  if (d <= 16)
    return launch<T, 16>(q, k, v, o, b, hq, hkv, sq, sk, d, causal, window,
                         scale, st3, s);
  if (d <= 32)
    return launch<T, 32>(q, k, v, o, b, hq, hkv, sq, sk, d, causal, window,
                         scale, st3, s);
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, b, hq, hkv, sq, sk, d, causal, window,
                         scale, st3, s);
  if (d <= 128)
    return launch<T, 128>(q, k, v, o, b, hq, hkv, sq, sk, d, causal,
                          window, scale, st3, s);
  if (d <= 256)
    return launch<T, 256>(q, k, v, o, b, hq, hkv, sq, sk, d, causal,
                          window, scale, st3, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16.  Strides in elements for the batch,
// head and sequence dims of q, k and v (the head dim is contiguous); the
// output is contiguous [B, Hq, Sq, D].  Returns the cudaError_t of the
// launch.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int b,
    int hq, int hkv, int sq, int sk, int d, int causal, int window,
    float scale, int64_t qsb, int64_t qsh, int64_t qss, int64_t ksb,
    int64_t ksh, int64_t kss, int64_t vsb, int64_t vsh, int64_t vss,
    void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st3[9] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, b, hq, hkv, sq, sk, d, causal,
                           window, scale, st3, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, b, hq, hkv, sq, sk, d,
                                   causal, window, scale, st3, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
