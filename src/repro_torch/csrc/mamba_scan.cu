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
// sequential grid of time chunks.  Here channels are independent, and
// the N states of a channel are split over kLanes = 2 neighbouring lanes
// of one warp (faster on the card than 4 or 8, PERF.md), kS = N / 2
// states each, kept in registers with their A[c][k] for the whole
// sweep.  Each state keeps its float32 step-by-step recurrence; a step's
// y is each lane's sum over its states, plus the other lane's by one
// shuffle, plus D[c] x_t[c], stored by the channel's first lane.  A block of 128 threads covers 64
// neighbouring channels of one batch row: at jamba's shape 256 blocks,
// ~8 warps on each SM where one thread a channel left one warp a
// scheduler.  B_t and C_t are shared by every channel of a row: a chunk
// of kChunk steps of both is staged in shared memory (double-buffered by
// chunk parity) behind one barrier per chunk, and a lane reads its kS
// values of each as 16-byte words.  Each lane loads x_t and dt_t itself
// (the lanes of a channel share one sector), a chunk ahead in a ring of
// registers, and its part of the next chunk's B and C while the current
// chunk runs; a chunk whose loads and stores all lie before T runs
// without their predicates.  States past N hold A = 0 and B = 0, and
// steps past T are read as zeros (dt = 0 gives a decay of 1 and B = 0
// adds nothing), so h is unchanged by both and their y is not stored.
//
// The decay is expf(dt A), as the reference computes it: at a decay
// close to 1 a state remembers thousands of steps, and a one-ulp
// difference from the reference's exponential compounds over them (an
// ex2.approx of dt A log2(e) erred 5.5e-4 at the tests' inputs, expf
// 8e-5, against a 1e-4 gate; PERF.md).
//
// Bound on an H100 at jamba's prefill shape (Bb = 2, T = 2048, Di =
// 8192, N = 16): x, dt and y, 402.7 MB, take 0.120 ms at 3.35 TB/s; the
// 5.37e8 exponentials take 0.128 ms on the special function units (16 a
// clock an SM, 132 SMs, 1.98 GHz); the rest, 6 FLOPs per state element
// and step, 0.048 ms at 67 TFLOP/s.  So the MUFU bounds it, at 0.128 ms.
// What holds the kernel is the issue of ~12 instructions a state and
// step (expf is 8 of them) beside the MUFU's time, which overlap little:
// PERF.md has the clock account.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 16;
constexpr int kLanes = 2;                         // lanes a channel
constexpr int kThreads = 128;
constexpr int kChannels = kThreads / kLanes;      // channels a block
constexpr int kChunk = 8;                         // steps per barrier
constexpr int kStage = kChunk * 2 * kMaxN;        // B and C of a chunk
constexpr int kPer = kStage / kThreads;           // staged per thread
static_assert(kPer * kThreads == kStage, "whole staging rounds");

// blocks an SM that must fit: 8 warps an SM at jamba's shape, so at
// most 168 registers a thread
constexpr int kMinBlocks = 3;

struct Strides {
  int64_t b, t;                                   // in elements
};

// kS consecutive floats of shared memory at a multiple of kS
template <int kS>
__device__ __forceinline__ void load_states(const float* p, float (&v)[kS]) {
  if constexpr (kS % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kS / 4; ++i) {
      const float4 f = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = f.x;
      v[4 * i + 1] = f.y;
      v[4 * i + 2] = f.z;
      v[4 * i + 3] = f.w;
    }
  } else if constexpr (kS == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x;
    v[1] = f.y;
  } else {
    v[0] = *p;
  }
}

// One chunk of kChunk steps for one lane: its kS states of one channel.
// x_t and dt_t of step t0 + s wait in xr[s], dr[s], and are replaced by
// those of step t0 + kChunk + s from xn, dn; bcs is the chunk's staged
// [kChunk][2][kMaxN] B and C at this lane's states.  kTail: some of the
// steps this chunk loads or stores lie past T (predicated); otherwise
// none does.
template <int kS, bool kTail>
__device__ __forceinline__ void run_chunk(
    float (&h)[kS], const float (&a)[kS], float (&xr)[kChunk],
    float (&dr)[kChunk], const float*& xn, const float*& dn, int64_t sxt,
    int64_t sdt, float*& yo, int64_t di, float dd, bool store, bool live,
    const float* bcs, int t0, int t_len) {
#pragma unroll
  for (int s = 0; s < kChunk; ++s) {
    const float dv = dr[s], xv = xr[s];
    if (kTail) {
      const bool ok = live && t0 + kChunk + s < t_len;
      xr[s] = ok ? *xn : 0.f;
      dr[s] = ok ? *dn : 0.f;
    } else {
      xr[s] = *xn;
      dr[s] = *dn;
    }
    xn += sxt;
    dn += sdt;
    float bv[kS], cv[kS];
    load_states<kS>(bcs + s * 2 * kMaxN, bv);
    load_states<kS>(bcs + s * 2 * kMaxN + kMaxN, cv);
    const float dx = dv * xv;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kS; ++k) {
      h[k] = fmaf(expf(dv * a[k]), h[k], dx * bv[k]);
      acc = fmaf(h[k], cv[k], acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);   // the other lane's
    if (store && (!kTail || t0 + s < t_len)) *yo = fmaf(dd, xv, acc);
    yo += di;
  }
}

template <int kS>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
mamba_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const float* __restrict__ Bm,
                  const float* __restrict__ Cm, const float* __restrict__ D,
                  float* __restrict__ y, int t_len, int di, int n,
                  Strides sx, Strides sd, Strides sb, Strides sc) {
  // [parity][step][0 B, 1 C][k]
  __shared__ __align__(16) float bc[2][kChunk][2][kMaxN];
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int q = tid % kLanes;                     // lane of the channel
  const int c = blockIdx.x * kChannels + tid / kLanes;
  const bool live = c < di;
  const int cl = live ? c : 0;                    // clamped for loads
  const int k0 = q * kS;                          // this lane's states

  float a[kS], h[kS];
#pragma unroll
  for (int k = 0; k < kS; ++k) {
    a[k] = live && k0 + k < n ? A[static_cast<int64_t>(cl) * n + k0 + k]
                              : 0.f;
    h[k] = 0.f;
  }
  const float dd = live ? D[cl] : 0.f;
  const bool store = live && q == 0;
  const float* xn = x + b * sx.b + cl;
  const float* dn = dt + b * sd.b + cl;
  float* yo = y + static_cast<int64_t>(b) * t_len * di + cl;

  // this thread stages element tid + j * kThreads of a chunk's
  // [kChunk][2][kMaxN] block: step tid / 32 + 4 j, matrix (tid / 16) % 2,
  // state tid % 16
  const int which = (tid / kMaxN) % 2, ks = tid % kMaxN;
  const int s0 = tid / (2 * kMaxN);
  constexpr int kStepStride = kThreads / (2 * kMaxN);   // 4
  const float* bcp = (which ? Cm + b * sc.b : Bm + b * sb.b) + ks;
  const int64_t bct = which ? sc.t : sb.t;
  const bool stager = ks < n;

  float xr[kChunk], dr[kChunk], sb4[kPer];
#pragma unroll
  for (int s = 0; s < kChunk; ++s) {
    const bool ok = live && s < t_len;
    xr[s] = ok ? *xn : 0.f;
    dr[s] = ok ? *dn : 0.f;
    xn += sx.t;
    dn += sd.t;
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
    __syncthreads();
    // the next chunk's B and C stay in flight while this one runs
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int64_t tt = t0 + kChunk + s0 + j * kStepStride;
      sb4[j] = stager && tt < t_len ? bcp[tt * bct] : 0.f;
    }
    const float* bcs = &bc[p][0][0][k0];
    if (t0 + 2 * kChunk <= t_len)
      run_chunk<kS, false>(h, a, xr, dr, xn, dn, sx.t, sd.t, yo, di, dd,
                           store, live, bcs, t0, t_len);
    else
      run_chunk<kS, true>(h, a, xr, dr, xn, dn, sx.t, sd.t, yo, di, dd,
                          store, live, bcs, t0, t_len);
  }
}

template <int kS>
void launch(const float* x, const float* dt, const float* A, const float* B,
            const float* C, const float* D, float* y, int bb, int t, int di,
            int n, Strides sx, Strides sd, Strides sb, Strides sc,
            cudaStream_t stream) {
  const dim3 grid((di + kChannels - 1) / kChannels, bb);
  mamba_scan_kernel<kS><<<grid, kThreads, 0, stream>>>(
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
  // the fewest states a lane that cover N over the channel's two lanes
  if (n <= 2)
    launch<1>(xf, df, af, bf, cf, Df, yf, bb, t, di, n, sx, sd, sb, sc, s);
  else if (n <= 4)
    launch<2>(xf, df, af, bf, cf, Df, yf, bb, t, di, n, sx, sd, sb, sc, s);
  else if (n <= 8)
    launch<4>(xf, df, af, bf, cf, Df, yf, bb, t, di, n, sx, sd, sb, sc, s);
  else
    launch<8>(xf, df, af, bf, cf, Df, yf, bb, t, di, n, sx, sd, sb, sc, s);
  return static_cast<int>(cudaGetLastError());
}
