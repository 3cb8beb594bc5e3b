// Mamba selective scan (S6) for Hopper (sm_90a): the time sweep of the
// selective state-space layer of Mamba, as Jamba's mamba layers run it.
//
// Replaces the TPU kernel src/repro/kernels/mamba_scan/mamba_scan.py
// (`mamba_scan`, pallas_call at :52, `_kernel` at :20; wrapper ops.py
// `selective_scan`).  Computes, as kernels/mamba_scan/ref.py does, per
// (batch b, channel c) with state h [N] starting at 0:
//   h[k] = exp(dt_t[c] * A[c][k]) * h[k] + (dt_t[c] * x_t[c]) * B_t[k]
//   y_t[c] = sum_k h[k] * C_t[k] + D[c] * x_t[c]
// for x, dt [Bb, T, Di] and B, C [Bb, T, N] float32 (any batch and time
// strides, last dimension contiguous), A [Di, N], D [Di], N <= 16, any
// T >= 1 and any Di; y [Bb, T, Di] contiguous.
//
// Design.  The Pallas kernel keeps h [block_d, N] in VMEM across a
// sequential grid of time chunks.  Here channels are independent, so one
// thread owns one (b, c): its h[N] and A[c][:] stay in registers for the
// whole sweep, and a block of 128 threads covers 128 neighbouring
// channels of one batch row, so the loads of x_t and dt_t and the store
// of y_t are coalesced along the channels.  B_t and C_t are shared by
// every channel of a row: a chunk of kChunk steps of both is staged in
// shared memory (double-buffered by chunk parity) behind one barrier per
// chunk.  Each thread loads its part of the next chunk (x, dt, and 4
// floats of B/C) into registers while the current chunk runs, so
// 2 * kChunk + 4 loads are in flight.  Steps past T are read as zeros:
// dt = 0 gives exp(0) = 1 and B = 0 adds nothing, so h is unchanged and
// their y is not stored.  All arithmetic is float32 with the accurate
// expf (no fast math).
//
// Bound on an H100 at jamba's prefill shape (Bb = 2, T = 2048, Di =
// 8192, N = 16): x, dt and y, 402.7 MB, take 0.120 ms at 3.35 TB/s; the
// 5.4e8 exponentials take 0.128 ms on the special function units (16 a
// clock an SM, 132 SMs, 1.98 GHz); the rest, 6 FLOPs per state element
// and step, 0.048 ms at 67 TFLOP/s.  The 16 states of a channel are 16
// independent chains, so a step is not latency-bound on h; 128 blocks
// fill 128 of the 132 SMs with 4 warps each, so the issue rate of one
// warp per scheduler (expf is about 8 instructions) bounds it in
// practice (PERF.md has the measured time).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 16;
constexpr int kThreads = 128;                     // channels per block
constexpr int kChunk = 16;                        // steps per barrier
constexpr int kStage = kChunk * 2 * kMaxN;        // B and C of a chunk
constexpr int kPer = kStage / kThreads;           // staged per thread: 4

struct Strides {
  int64_t b, t;                                   // in elements
};

template <int kN>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const float* __restrict__ Bm,
                  const float* __restrict__ Cm, const float* __restrict__ D,
                  float* __restrict__ y, int t_len, int di, int n,
                  Strides sx, Strides sd, Strides sb, Strides sc) {
  // [parity][step][0 B, 1 C][k]
  __shared__ float bc[2][kChunk][2][kMaxN];
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int c = blockIdx.x * kThreads + tid;
  const bool live = c < di;
  const int cl = live ? c : 0;                    // clamped for loads

  float a[kN], h[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    a[k] = live && k < n ? A[static_cast<int64_t>(cl) * n + k] : 0.f;
    h[k] = 0.f;
  }
  const float dd = live ? D[cl] : 0.f;
  const float* xp = x + b * sx.b + cl;
  const float* dp = dt + b * sd.b + cl;
  float* yp = y + static_cast<int64_t>(b) * t_len * di + c;

  // this thread stages element q = tid + j * kThreads of a chunk's
  // [kChunk][2][kMaxN] block: step tid / 32 + 4 j, matrix (tid / 16) % 2,
  // state tid % 16
  const int which = (tid / kMaxN) % 2, ks = tid % kMaxN;
  const int s0 = tid / (2 * kMaxN);
  constexpr int kStepStride = kThreads / (2 * kMaxN);   // 4
  const float* bcp = (which ? Cm + b * sc.b : Bm + b * sb.b) + ks;
  const int64_t bct = which ? sc.t : sb.t;
  const bool stager = ks < n;

  float xb[kChunk], db[kChunk], sb4[kPer];
#pragma unroll
  for (int s = 0; s < kChunk; ++s) {
    const bool ok = live && s < t_len;
    xb[s] = ok ? xp[s * sx.t] : 0.f;
    db[s] = ok ? dp[s * sd.t] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int tt = s0 + j * kStepStride;
    sb4[j] = stager && tt < t_len ? bcp[tt * bct] : 0.f;
  }

  const int n_chunks = (t_len + kChunk - 1) / kChunk;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int p = ch & 1;
    const int t0 = ch * kChunk;
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      bc[p][s0 + j * kStepStride][which][ks] = sb4[j];
    float xc[kChunk], dc[kChunk];
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      xc[s] = xb[s];
      dc[s] = db[s];
    }
    __syncthreads();
    // loads of the next chunk stay in flight while this one runs
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      const int64_t tt = t0 + kChunk + s;
      const bool ok = live && tt < t_len;
      xb[s] = ok ? xp[tt * sx.t] : 0.f;
      db[s] = ok ? dp[tt * sd.t] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int64_t tt = t0 + kChunk + s0 + j * kStepStride;
      sb4[j] = stager && tt < t_len ? bcp[tt * bct] : 0.f;
    }
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      const float dv = dc[s], xv = xc[s];
      const float dx = dv * xv;
      const float* bt = bc[p][s][0];
      const float* ct = bc[p][s][1];
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
      for (int k = 0; k < kN; ++k) {
        const float da = expf(dv * a[k]);
        h[k] = fmaf(da, h[k], dx * bt[k]);
        if (k & 1)
          acc1 = fmaf(h[k], ct[k], acc1);
        else
          acc0 = fmaf(h[k], ct[k], acc0);
      }
      if (live && t0 + s < t_len)
        yp[static_cast<int64_t>(t0 + s) * di] = fmaf(dd, xv, acc0 + acc1);
    }
  }
}

template <int kN>
void launch(const float* x, const float* dt, const float* A, const float* B,
            const float* C, const float* D, float* y, int bb, int t, int di,
            int n, Strides sx, Strides sd, Strides sb, Strides sc,
            cudaStream_t stream) {
  const dim3 grid((di + kThreads - 1) / kThreads, bb);
  mamba_scan_kernel<kN><<<grid, kThreads, 0, stream>>>(
      x, dt, A, B, C, D, y, t, di, n, sx, sd, sb, sc);
}

}  // namespace

// x, dt: float32 [Bb, T, Di] and B, C: float32 [Bb, T, N], each with
// element strides (b, t) given and a contiguous last dimension; A: float32
// [Di, N] and D: float32 [Di] contiguous; y: float32 [Bb, T, Di]
// contiguous.  Returns the cudaError_t of the launch.
extern "C" int mamba_scan_launch(const void* x, const void* dt, const void* A,
                                 const void* B, const void* C, const void* D,
                                 void* y, int bb, int t, int di, int n,
                                 int64_t xb, int64_t xt, int64_t db,
                                 int64_t dtt, int64_t bb_, int64_t bt,
                                 int64_t cb, int64_t ct, void* stream) {
  if (bb < 0 || bb > 65535 || t <= 0 || di <= 0 || n <= 0 || n > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bb == 0) return 0;
  const auto* xf = static_cast<const float*>(x);
  const auto* df = static_cast<const float*>(dt);
  const auto* af = static_cast<const float*>(A);
  const auto* bf = static_cast<const float*>(B);
  const auto* cf = static_cast<const float*>(C);
  const auto* Df = static_cast<const float*>(D);
  auto* yf = static_cast<float*>(y);
  const Strides sx{xb, xt}, sd{db, dtt}, sb{bb_, bt}, sc{cb, ct};
  auto s = static_cast<cudaStream_t>(stream);
  if (n <= 4)
    launch<4>(xf, df, af, bf, cf, Df, yf, bb, t, di, n, sx, sd, sb, sc, s);
  else if (n <= 8)
    launch<8>(xf, df, af, bf, cf, Df, yf, bb, t, di, n, sx, sd, sb, sc, s);
  else
    launch<16>(xf, df, af, bf, cf, Df, yf, bb, t, di, n, sx, sd, sb, sc, s);
  return static_cast<int>(cudaGetLastError());
}
