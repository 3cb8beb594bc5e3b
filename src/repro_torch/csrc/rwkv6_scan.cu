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
// Design.  The Pallas kernel keeps S in VMEM across a sequential grid
// over time chunks.  Here one block of 256 threads owns one (b, h) and
// runs the whole time loop; S stays in registers for the sweep: thread
// (j = tid % 64, g = tid / 64) holds rows 16g .. 16g + 15 of column j.
// Column j of S and o_t[j] depend on column j alone, so the only
// exchange between threads is the staging of r_t, k_t, v_t, w_t and the
// sum of the four row groups' partials of o_t.  Steps go in chunks of
// kChunk: each thread loads its element of the next chunk into registers
// (kChunk loads in flight) while the current chunk runs, the chunk is
// staged into shared memory behind one barrier, and the partials of a
// chunk are summed and written during the next one -- one barrier per
// kChunk steps.  Rows and columns past D are staged as zeros, which
// leave S and o unchanged.  All arithmetic is float32.
//
// Bound on an H100 at rwkv6-7b's prefill shape (B*H = 128, T = 2048,
// D = 64): the four inputs and the output, 335 MB, take 0.100 ms at
// 3.35 TB/s; the work is 5 FLOPs per state element and step (2 for
// S^T r, 3 for diag(w) S + k v^T; the bonus term is O(D) a step), 5.4
// GFLOP, 0.080 ms at 67 TFLOP/s float32; so it is bytes-bound.  This
// kernel is bound by neither: 128 blocks (about one wave on 132 SMs, 8
// warps an SM) walk T dependent steps, so its time is the latency of a
// step times T (0.42 ms measured on the H100, PERF.md).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxD = 64;
constexpr int kGroups = 4;                  // row groups of S
constexpr int kRows = kMaxD / kGroups;      // rows of S per thread
constexpr int kThreads = kGroups * kMaxD;   // 256
constexpr int kChunk = 8;                   // steps per barrier

struct Strides {
  int64_t b, h, t;                          // in elements
};

__global__ void __launch_bounds__(kThreads)
rwkv6_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, float* __restrict__ o,
                  int n_heads, int t_len, int d, Strides sr, Strides sk,
                  Strides sv, Strides sw) {
  // staged r, k, v, w of a chunk, and the row groups' partials of o;
  // both double-buffered by chunk parity
  __shared__ __align__(16) float xs[2][kChunk][kGroups][kMaxD];
  __shared__ float part[2][kChunk][kGroups][kMaxD];
  const int b = blockIdx.x / n_heads, h = blockIdx.x % n_heads;
  const int tid = threadIdx.x;
  const int j = tid % kMaxD, g = tid / kMaxD;

  // this thread stages element j of vector g (0 r, 1 k, 2 v, 3 w)
  const float* src;
  int64_t st;
  {
    const Strides& s4 = g == 0 ? sr : g == 1 ? sk : g == 2 ? sv : sw;
    const float* p4 = g == 0 ? r : g == 1 ? k : g == 2 ? v : w;
    src = p4 + b * s4.b + h * s4.h + j;
    st = s4.t;
  }
  const bool stager = j < d;

  float s[kRows], ui[kRows];
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii) {
    const int i = g * kRows + ii;
    s[ii] = 0.f;
    ui[ii] = i < d ? u[static_cast<int64_t>(h) * d + i] : 0.f;
  }
  float buf[kChunk];
#pragma unroll
  for (int c = 0; c < kChunk; ++c)
    buf[c] = stager && c < t_len ? src[c * st] : 0.f;

  float* ob = o + (static_cast<int64_t>(b) * n_heads + h) * t_len * d;
  const int n_chunks = (t_len + kChunk - 1) / kChunk;
  for (int n = 0; n < n_chunks; ++n) {
    const int p = n & 1;
    const int t0 = n * kChunk;
#pragma unroll
    for (int c = 0; c < kChunk; ++c) xs[p][c][g][j] = buf[c];
    __syncthreads();
    // loads of the next chunk stay in flight while this one runs
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int tt = t0 + kChunk + c;
      buf[c] = stager && tt < t_len ? src[tt * st] : 0.f;
    }
    // the previous chunk's output
    if (n > 0) {
      for (int q = tid; q < kChunk * kMaxD; q += kThreads) {
        const int c = q / kMaxD, jj = q % kMaxD;
        const float(*pp)[kMaxD] = part[p ^ 1][c];
        if (jj < d)
          ob[static_cast<int64_t>(t0 - kChunk + c) * d + jj] =
              (pp[0][jj] + pp[1][jj]) + (pp[2][jj] + pp[3][jj]);
      }
    }
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const float* rr = &xs[p][c][0][g * kRows];
      const float* kk = &xs[p][c][1][g * kRows];
      const float* ww = &xs[p][c][3][g * kRows];
      const float vj = xs[p][c][2][j];
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
      for (int q = 0; q < kRows; q += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(rr + q);
        const float4 k4 = *reinterpret_cast<const float4*>(kk + q);
        const float4 w4 = *reinterpret_cast<const float4*>(ww + q);
        const float ra[4] = {r4.x, r4.y, r4.z, r4.w};
        const float ka[4] = {k4.x, k4.y, k4.z, k4.w};
        const float wa[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ii = q + e;
          const float kv = ka[e] * vj;
          const float a = fmaf(ui[ii], kv, s[ii]);
          if (e & 1)
            acc1 = fmaf(ra[e], a, acc1);
          else
            acc0 = fmaf(ra[e], a, acc0);
          s[ii] = fmaf(wa[e], s[ii], kv);
        }
      }
      part[p][c][g][j] = acc0 + acc1;
    }
  }
  __syncthreads();
  const int p = (n_chunks - 1) & 1;
  const int t0 = (n_chunks - 1) * kChunk;
  for (int q = tid; q < kChunk * kMaxD; q += kThreads) {
    const int c = q / kMaxD, jj = q % kMaxD;
    const float(*pp)[kMaxD] = part[p][c];
    if (jj < d && t0 + c < t_len)
      ob[static_cast<int64_t>(t0 + c) * d + jj] =
          (pp[0][jj] + pp[1][jj]) + (pp[2][jj] + pp[3][jj]);
  }
}

}  // namespace

// r, k, v, w: float32 [B, H, T, D] with element strides (b, h, t) given
// per tensor and a contiguous last dimension; u: float32 [H, D]
// contiguous; o: float32 [B, H, T, D] contiguous.  Returns the
// cudaError_t of the launch.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, void* o,
                                 int b, int h, int t, int d,
                                 int64_t rb, int64_t rh, int64_t rt,
                                 int64_t kb, int64_t kh, int64_t kt,
                                 int64_t vb, int64_t vh, int64_t vt,
                                 int64_t wb, int64_t wh, int64_t wt,
                                 void* stream) {
  if (b < 0 || h <= 0 || t <= 0 || d <= 0 || d > kMaxD
      || static_cast<int64_t>(b) * h > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  rwkv6_scan_kernel<<<b * h, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<float*>(o), h, t, d,
      Strides{rb, rh, rt}, Strides{kb, kh, kt}, Strides{vb, vh, vt},
      Strides{wb, wh, wt});
  return static_cast<int>(cudaGetLastError());
}
