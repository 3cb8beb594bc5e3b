// Tier-compaction row movers for Hopper (sm_90a): gather_rows (B5),
// select_gather_rows (B3) and scatter_rows (B4).
//
// Replaces the TPU kernels of src/repro/kernels/tier_compact/tier_compact.py:
//   gather_rows         (:38, pallas_call at :48)   out[i] = pool[idx[i]]
//   select_gather_rows  (:74, pallas_call at :93)   out[i] = (slow if
//                        src_slow[i] else fast)[idx[i]]
//   scatter_rows        (:106, pallas_call at :125) pool[idx[i]] = rows[i]
//                        where valid[i], in place
// (wrappers kernels/tier_compact/ops.py).  They are copies of bits, so the
// result is bit-exact for any element type: rows are moved as raw bytes.
//
// Design.  The Pallas kernels start one row DMA per grid step, the grid
// walking the rows in order.  Here every row is independent: a group of
// `tpr` threads copies one row, `tpr` the power of two that covers the
// row's copy units, at most the 256 threads of a block.  So a narrow row
// (16 B: the key-value store's 4 f32) is one thread's single 16-byte
// load and store, 256 rows a block; a wide one (4,608 B: an embedding
// row of 1,152 f32) is a block striding over 288 16-byte units.  The
// copy unit is the widest of 16, 8, 4, 2 and 1 bytes that divides the
// row's byte width and every base address; a [P, 2] float32 pool (8-byte
// rows) moves in 8-byte units.  The same kernel template serves each unit.
//   * select_gather_rows reads each row once, from the pool its flag
//     selects (the Pallas kernel's point: the older form gathered from
//     both pools and selected afterwards, twice the read traffic).
//   * scatter_rows skips invalid rows in the kernel and writes nothing
//     for them: CUDA needs no trash row, unlike the TPU's grid step,
//     which always writes its block back.  Valid destinations are unique
//     (compaction allocates distinct slots), so no two threads write the
//     same row: no atomics.
//   * Gather indices are clamped into [0, P - 1] (the JAX gather's
//     semantics); scatter indices outside [0, P) write nothing (its
//     "drop" mode).
//
// Bound on an H100: memory bytes.  Each moved row is read once and
// written once, plus 4 bytes of index (and a flag byte) per row: at the
// embedding mirror's 16,384 merged rows of 4,608 B, about 151 MB, 45 us
// at 3.35 TB/s.  The key-value drain's 64 rows of 16 B are ~2.5 KB: its
// time is launch latency.  Rows are read at random (one row a group), so
// a narrow row wastes most of each 32-byte sector the card fetches;
// TMA bulk copies are later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct alignas(16) U16 { uint32_t w[4]; };
struct alignas(8) U8 { uint32_t w[2]; };

__device__ __forceinline__ int64_t clamp_row(int64_t i, int64_t n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// One row per group of `tpr` threads; `upr` copy units of type U a row.
template <typename U>
__global__ void gather_kernel(const U* __restrict__ pool, int64_t p,
                              const int32_t* __restrict__ idx, int m,
                              int upr, int tpr, U* __restrict__ out) {
  const int r = blockIdx.x * (kThreads / tpr) + threadIdx.x / tpr;
  if (r >= m) return;
  const U* src = pool + clamp_row(idx[r], p) * upr;
  U* dst = out + static_cast<int64_t>(r) * upr;
  for (int c = threadIdx.x % tpr; c < upr; c += tpr) dst[c] = src[c];
}

template <typename U>
__global__ void select_gather_kernel(const U* __restrict__ fast, int64_t pf,
                                     const U* __restrict__ slow, int64_t ps,
                                     const bool* __restrict__ src_slow,
                                     const int32_t* __restrict__ idx, int m,
                                     int upr, int tpr, U* __restrict__ out) {
  const int r = blockIdx.x * (kThreads / tpr) + threadIdx.x / tpr;
  if (r >= m) return;
  const U* src = src_slow[r] ? slow + clamp_row(idx[r], ps) * upr
                             : fast + clamp_row(idx[r], pf) * upr;
  U* dst = out + static_cast<int64_t>(r) * upr;
  for (int c = threadIdx.x % tpr; c < upr; c += tpr) dst[c] = src[c];
}

template <typename U>
__global__ void scatter_kernel(U* __restrict__ pool, int64_t p,
                               const int32_t* __restrict__ idx,
                               const U* __restrict__ rows,
                               const bool* __restrict__ valid, int m,
                               int upr, int tpr) {
  const int r = blockIdx.x * (kThreads / tpr) + threadIdx.x / tpr;
  if (r >= m || !valid[r]) return;
  const int64_t d = idx[r];
  if (d < 0 || d >= p) return;
  const U* src = rows + static_cast<int64_t>(r) * upr;
  U* dst = pool + d * upr;
  for (int c = threadIdx.x % tpr; c < upr; c += tpr) dst[c] = src[c];
}

// The widest copy unit dividing the row width and every base address.
int unit_bytes(int64_t row_bytes, const void* a, const void* b,
               const void* c) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(c);
  for (int u = 16; u > 1; u >>= 1)
    if (row_bytes % u == 0 && addr % u == 0) return u;
  return 1;
}

struct Grid {
  int upr, tpr, blocks;
};

Grid grid_for(int m, int64_t row_bytes, int unit) {
  Grid g;
  g.upr = static_cast<int>(row_bytes / unit);
  g.tpr = 1;
  while (g.tpr < g.upr && g.tpr < kThreads) g.tpr <<= 1;
  const int rows_per_block = kThreads / g.tpr;
  g.blocks = (m + rows_per_block - 1) / rows_per_block;
  return g;
}

template <typename U>
void launch_gather(const void* pool, int64_t p, const int32_t* idx, int m,
                   const Grid& g, void* out, cudaStream_t s) {
  gather_kernel<U><<<g.blocks, kThreads, 0, s>>>(
      static_cast<const U*>(pool), p, idx, m, g.upr, g.tpr,
      static_cast<U*>(out));
}

template <typename U>
void launch_select(const void* fast, int64_t pf, const void* slow,
                   int64_t ps, const bool* src_slow, const int32_t* idx,
                   int m, const Grid& g, void* out, cudaStream_t s) {
  select_gather_kernel<U><<<g.blocks, kThreads, 0, s>>>(
      static_cast<const U*>(fast), pf, static_cast<const U*>(slow), ps,
      src_slow, idx, m, g.upr, g.tpr, static_cast<U*>(out));
}

template <typename U>
void launch_scatter(void* pool, int64_t p, const int32_t* idx,
                    const void* rows, const bool* valid, int m,
                    const Grid& g, cudaStream_t s) {
  scatter_kernel<U><<<g.blocks, kThreads, 0, s>>>(
      static_cast<U*>(pool), p, idx, static_cast<const U*>(rows), valid, m,
      g.upr, g.tpr);
}

bool bad_args(int m, int64_t row_bytes) {
  return m < 0 || row_bytes <= 0 || row_bytes > (int64_t{1} << 30);
}

}  // namespace

#define DISPATCH_UNIT(unit, FN, ...)                          \
  switch (unit) {                                             \
    case 16: FN<U16>(__VA_ARGS__); break;                     \
    case 8: FN<U8>(__VA_ARGS__); break;                       \
    case 4: FN<uint32_t>(__VA_ARGS__); break;                 \
    case 2: FN<uint16_t>(__VA_ARGS__); break;                 \
    default: FN<uint8_t>(__VA_ARGS__); break;                 \
  }

extern "C" int gather_rows_launch(const void* pool, int64_t p,
                                  const int32_t* idx, int m,
                                  int64_t row_bytes, void* out,
                                  void* stream) {
  if (bad_args(m, row_bytes) || p <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  const int unit = unit_bytes(row_bytes, pool, out, nullptr);
  const Grid g = grid_for(m, row_bytes, unit);
  DISPATCH_UNIT(unit, launch_gather, pool, p, idx, m, g, out,
                static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int select_gather_rows_launch(const void* fast, int64_t pf,
                                         const void* slow, int64_t ps,
                                         const bool* src_slow,
                                         const int32_t* idx, int m,
                                         int64_t row_bytes, void* out,
                                         void* stream) {
  if (bad_args(m, row_bytes) || pf <= 0 || ps <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  const int unit = unit_bytes(row_bytes, fast, slow, out);
  const Grid g = grid_for(m, row_bytes, unit);
  DISPATCH_UNIT(unit, launch_select, fast, pf, slow, ps, src_slow, idx, m,
                g, out, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int scatter_rows_launch(void* pool, int64_t p, const int32_t* idx,
                                   const void* rows, const bool* valid,
                                   int m, int64_t row_bytes, void* stream) {
  if (bad_args(m, row_bytes) || p <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  const int unit = unit_bytes(row_bytes, pool, rows, nullptr);
  const Grid g = grid_for(m, row_bytes, unit);
  DISPATCH_UNIT(unit, launch_scatter, pool, p, idx, rows, valid, m, g,
                static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
