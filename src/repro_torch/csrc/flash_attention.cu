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
// Shared design.  One block per (b * Hkv + h, tile of 64 folded query
// rows); a row is (token, head in group), token-major, so the G query
// heads of a KV head share every K/V tile, as the Pallas kernel's GQA
// folding does.  The block walks the tiles of 64 keys that its rows can
// see (causal and window bounds skip the rest; only the tiles on a mask
// edge evaluate the mask).  Q, one K tile and one V tile sit in shared
// memory, staged with 16-byte cp.async copies: V(t) is in flight while
// the scores of tile t are computed, K(t+1) while P(t) V(t) is, so two
// barriers a tile and no copy waits on its own math.  Under a causal
// mask the row tiles run in reverse, heaviest first, so the short ones
// fill the tail.  The online-softmax state and the output accumulator
// stay in registers in float32; the output is rounded once on store.
// The kernel masks its own ragged edges (rows, keys, head-dim columns,
// zero-filled by the copies) and reads q/k/v in place with any strides
// whose head dim is contiguous; where a pointer, a stride or the head
// dim breaks 16-byte alignment, the copies fall back to element loads.
// The head dim is a template parameter (64, 128, 256); a smaller one is
// zero-padded in shared memory only.
//
// bfloat16: tensor cores, wgmma.  The block is one warpgroup (4 warps,
// 16 rows each).  S = Q K^T is wgmma m64n64k16 with Q and K read from
// shared memory through matrix descriptors (both K-major), O += P V is
// wgmma m64nDk16 with V read transposed (MN-major) from shared memory;
// the tiles sit in the 128-byte-swizzle layout those descriptors name,
// written so by the copies.  The softmax runs on the accumulator
// fragments (row max and sum over the 4 lanes of a quad).  P stays in
// registers as the A operand of the second product and never goes
// through shared memory.  The Pallas kernel keeps P in float32, so P is
// split into a bf16 part and its bf16 residual and P V is two wgmmas a
// k-step (P exact to about 2^-17; P rounded to bf16 alone breaks the
// 2e-2 bound at outputs of 4 to 8).  Each wgmma group is waited for
// before its registers are touched (no overlap of the softmax with the
// tensor cores yet: that, TMA staging and warp specialisation are the
// next step, PERF.md).  Where a launch has few row tiles and long key
// ranges (gemma3's global layers: one KV head, 256 row tiles, up to 64
// key tiles each), the heaviest block's serial walk is the whole time,
// so the wrapper asks for two blocks per row tile, each over half of its
// key tiles; they merge their partial results through a scratch buffer
// (split_epilogue).
//
// float32: IEEE float32 FMAs on the CUDA cores (no TF32: parity with the
// plain version).  256 threads as 16 x 16; thread (ty, tx) owns rows
// ty + 16 i and keys tx + 16 j (i, j < 4), a register micro-tile of 16
// scores: each step of 4 head-dim columns reads 4 float4 of Q and 4 of K
// for 64 FMAs, 8 FMAs a shared read.  Q and K are swizzled so the reads
// of a warp fall on distinct banks.  P goes through shared memory
// (swizzled), and the P V product gives each thread 4 rows x D/16
// columns: per key one float4 of P and D/64 float4 of V for D/4 FMAs.
// Shared memory 112 KB at D = 128, so two blocks of 256 threads share
// an SM.
//
// Bound on an H100.  The work is 4 * D FLOPs per visible (query, key)
// pair and query head.  At phi4-mini's prefill shape (B 2, Hq 24,
// Hkv 8, S 2048, D 128, causal) that is 51.6 GFLOP against 134 MB (f32)
// moved: bound by operations, 0.770 ms at the 67 TFLOP/s float32 peak
// and 0.052 ms at the 989 TFLOP/s bf16 tensor-core peak.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int kBR = 64;   // folded query rows per block
constexpr int kBC = 64;   // keys per tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int hq, hkv, sq, sk, d, causal, window;
  float scale;
  int64_t qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss;
  int nbh;     // b * hkv
  int ntiles;  // row tiles per (b, h)
  int vec;     // 16-byte copies are aligned
  int nsplit;  // blocks per row tile, each over a part of its keys (1, 2)
  float* ws;   // nsplit 2: [nbh * ntiles][2] partial results
  int* cnt;    // nsplit 2: [nbh * ntiles] finished halves, 0 between calls
};

struct Block {
  int b, h, g, rows, row0, off, kbeg, kend, qmin, qmax, split, slot;
};

__device__ __forceinline__ Block block_of(const Params& p) {
  Block k;
  const int bh = blockIdx.x % p.nbh;
  const int rest = blockIdx.x / p.nbh;
  k.split = rest % p.nsplit;
  int tile = rest / p.nsplit;
  if (p.causal) tile = p.ntiles - 1 - tile;  // heaviest first
  k.slot = bh * p.ntiles + tile;
  k.b = bh / p.hkv;
  k.h = bh % p.hkv;
  k.g = p.hq / p.hkv;
  k.rows = p.sq * k.g;
  k.row0 = tile * kBR;
  k.off = p.sk - p.sq;
  const int last = min(k.row0 + kBR, k.rows) - 1;
  k.qmin = k.row0 / k.g + k.off;
  k.qmax = last / k.g + k.off;
  k.kend = p.causal ? min(p.sk, k.qmax + 1) : p.sk;
  k.kend = max(k.kend, 0);
  const int kb = p.window > 0 ? max(0, k.qmin - p.window + 1) : 0;
  k.kbeg = (kb / kBC) * kBC;
  if (p.nsplit > 1) {  // split 0 takes the first half of the key tiles
    const int n = (k.kend - k.kbeg + kBC - 1) / kBC;
    const int mid = k.kbeg + max(0, (n + 1) / 2) * kBC;
    if (k.split == 0)
      k.kend = min(k.kend, mid);
    else
      k.kbeg = mid;
  }
  return k;
}

// A tile whose every (row, key) pair is kept needs no mask.
__device__ __forceinline__ bool needs_mask(const Params& p, const Block& bk,
                                           int k0) {
  return k0 + kBC > p.sk || (p.causal && k0 + kBC - 1 > bk.qmin) ||
         (p.window > 0 && k0 <= bk.qmax - p.window);
}

__device__ __forceinline__ bool kept(const Params& p, int kp, int qpos) {
  return kp < p.sk && (!p.causal || kp <= qpos) &&
         (p.window <= 0 || kp > qpos - p.window);
}

__device__ __forceinline__ unsigned saddr(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One 16-byte chunk of E elements of T: n of them from src (n <= E), the
// rest zero.  src must be a valid pointer even when n == 0.
template <typename T>
__device__ __forceinline__ void load_chunk(T* dst, const T* src, int n,
                                           bool vec) {
  constexpr int E = 16 / sizeof(T);
  if (vec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     saddr(dst)),
                 "l"(src), "r"(n * static_cast<int>(sizeof(T))));
    return;
  }
  using Raw = typename std::conditional<sizeof(T) == 2, uint16_t,
                                        uint32_t>::type;
  union {
    uint4 u;
    Raw r[E];
  } buf;
  const Raw* s = reinterpret_cast<const Raw*>(src);
#pragma unroll
  for (int e = 0; e < E; ++e) buf.r[e] = e < n ? s[e] : Raw(0);
  *reinterpret_cast<uint4*>(dst) = buf.u;
}

// Shared layouts of a tile of 64 rows x D, in 16-byte chunks c of E
// elements: kRows row-major; kRowsSwz row-major with chunk c of row r at
// c ^ (r & 7), so eight rows' reads of one column chunk hit eight banks;
// kGmma the 128-byte-swizzle layout that wgmma reads (bf16): 64-element
// column blocks [D / 64][64 rows][64], each row 128 bytes with chunk c at
// c ^ (r & 7), the tile 1024-byte aligned.
enum Layout { kRows, kRowsSwz, kGmma };

__device__ __forceinline__ int swz(int r, int c) { return c ^ (r & 7); }

template <typename T, int D, int L>
__device__ __forceinline__ int chunk_at(int r, int c) {
  constexpr int E = 16 / sizeof(T);
  if (L == kGmma) return ((c >> 3) * kBR + r) * 64 + (swz(r, c & 7) << 3);
  return r * D + (L == kRowsSwz ? swz(r, c) : c) * E;
}

// A thread copies one chunk column c = tid % CH of rows tid / CH + i NR:
// a fixed column, a row stride of NR, so the address arithmetic of a row
// is one pointer step.
template <typename T, int D, int NT>
struct Chunks {
  static constexpr int E = 16 / sizeof(T), CH = D / E, NR = NT / CH;
  static_assert(NT % CH == 0 && kBR % NR == 0, "chunk grid");
};

// The block's query rows: row r of the tile is token (row0 + r) / g of
// head h * g + (row0 + r) % g.
template <typename T, int D, int NT, int L>
__device__ __forceinline__ void load_q(T* s, const Params& p,
                                       const Block& bk) {
  using C = Chunks<T, D, NT>;
  const T* q = static_cast<const T*>(p.q);
  const int c = threadIdx.x % C::CH, n = max(0, min(C::E, p.d - c * C::E));
#pragma unroll 4
  for (int r = threadIdx.x / C::CH; r < kBR; r += C::NR) {
    const int row = bk.row0 + r;
    const int nr = row < bk.rows ? n : 0;
    const T* src = nr > 0 ? q + bk.b * p.qsb +
                                static_cast<int64_t>(bk.h * bk.g + row % bk.g) *
                                    p.qsh +
                                static_cast<int64_t>(row / bk.g) * p.qss +
                                c * C::E
                          : q;
    load_chunk(s + chunk_at<T, D, L>(r, c), src, nr, p.vec);
  }
}

// Keys k0 .. k0 + kBC - 1 of one K or V head.
template <typename T, int D, int NT, int L>
__device__ __forceinline__ void load_kv(T* s, const T* base, int64_t ss,
                                        int k0, const Params& p) {
  using C = Chunks<T, D, NT>;
  const int c = threadIdx.x % C::CH, r0 = threadIdx.x / C::CH;
  const int n = max(0, min(C::E, p.d - c * C::E));
  const T* src = base + static_cast<int64_t>(k0 + r0) * ss + c * C::E;
  const int64_t step = C::NR * ss;
#pragma unroll
  for (int r = r0; r < kBC; r += C::NR, src += step) {
    const int nr = k0 + r < p.sk ? n : 0;
    load_chunk(s + chunk_at<T, D, L>(r, c), nr > 0 ? src : base, nr, p.vec);
  }
}

template <typename T>
__device__ __forceinline__ T* out_row(const Params& p, const Block& bk,
                                      int row) {
  return static_cast<T*>(p.o) +
         (static_cast<int64_t>(bk.b) * p.hq + bk.h * bk.g + row % bk.g) *
             static_cast<int64_t>(p.sq) * p.d +
         static_cast<int64_t>(row / bk.g) * p.d;
}

// A block whose rows see no key writes zeros.
template <typename T, int NT>
__device__ void zero_rows(const Params& p, const Block& bk) {
  for (int i = threadIdx.x; i < kBR * p.d; i += NT) {
    const int row = bk.row0 + i / p.d;
    if (row < bk.rows) out_row<T>(p, bk, row)[i % p.d] = T(0.f);
  }
}

// ------------------------------------------------------------- bfloat16

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Registers an in-flight wgmma writes or reads: no access moves across.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, the
// leading (lbo) and stride (sbo) byte offsets, given in bytes and stored
// in 16-byte units.
__device__ __forceinline__ uint64_t gmma_desc(const void* ptr, int lbo,
                                              int sbo) {
  return static_cast<uint64_t>((saddr(ptr) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

// D += A B for 64 rows, bf16 in, float32 accumulators, scale-d 1.
// wgmma_ss: A and B from shared memory, both K-major (S = Q K^T, N 64).
// wgmma_rs: A from registers, B from shared memory MN-major (P V, N = D).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127 "
      "}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// (x0, x1) as a bf16 pair hi and the pair of residuals lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// A row tile split over two blocks: each stores its partial result in
// ws (o not yet divided by l, as the accumulator layout holds it, then
// each row's m and l) and counts itself in cnt.  The block that counts
// second combines the two partials into the output and resets the
// count; the first just returns.
template <int D>
__device__ void split_epilogue(const Params& p, const Block& bk,
                               const float (&o)[D / 2], const float (&m)[2],
                               const float (&l)[2], int ra, int lane) {
  using T = __nv_bfloat16;
  constexpr int W = kBR * (D + 2);  // floats per partial
  __shared__ int ticket;
  __shared__ float fac[kBR][2];
  float* w0 = p.ws + static_cast<int64_t>(bk.slot) * 2 * W;
  float* mine = w0 + bk.split * W;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int r = ra + 8 * x;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(mine + r * D + j * 8 + (lane & 3) * 2) =
          make_float2(o[4 * j + 2 * x], o[4 * j + 2 * x + 1]);
    if ((lane & 3) == 0)
      *reinterpret_cast<float2*>(mine + kBR * D + 2 * r) =
          make_float2(m[x], l[x]);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) ticket = atomicAdd(p.cnt + bk.slot, 1);
  __syncthreads();
  if (ticket == 0) return;
  __threadfence();
  if (threadIdx.x < kBR) {  // per row: the halves' weights over l
    const int r = threadIdx.x;
    const float2* ml = reinterpret_cast<const float2*>(w0 + kBR * D);
    const float2 a = __ldcg(ml + r), b = __ldcg(ml + W / 2 + r);
    const float mx = fmaxf(a.x, b.x);
    const float fa = mx == -INFINITY ? 0.f : exp2f(a.x - mx);
    const float fb = mx == -INFINITY ? 0.f : exp2f(b.x - mx);
    const float inv = 1.f / fmaxf(a.y * fa + b.y * fb, 1e-30f);
    fac[r][0] = fa * inv;
    fac[r][1] = fb * inv;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBR * D; i += blockDim.x) {
    const int r = i / D, c = i % D, row = bk.row0 + r;
    if (row >= bk.rows || c >= p.d) continue;
    out_row<T>(p, bk, row)[c] = __float2bfloat16(
        __ldcg(w0 + i) * fac[r][0] + __ldcg(w0 + W + i) * fac[r][1]);
  }
  if (threadIdx.x == 0) p.cnt[bk.slot] = 0;
}

// One warpgroup (4 warps) per block: S = Q K^T is wgmma m64n64k16 with
// both operands K-major in shared memory; O += P V is m64nDk16 with P in
// registers and V MN-major (transposed) in shared memory.  Accumulator
// element i of a thread: row 16 warp + lane / 4 + 8 ((i / 2) % 2),
// column 8 (i / 4) + 2 (lane % 4) + i % 2.
template <int D>
__global__ void __launch_bounds__(128, D <= 128 ? 3 : 2)
    flash_bf16(Params p) {
  using T = __nv_bfloat16;
  constexpr int NT = 128, NS = kBC / 2, NO = D / 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + kBR * D;
  T* sV = sK + kBC * D;
  const Block bk = block_of(p);
  if (bk.kbeg >= bk.kend && p.nsplit == 1) {
    zero_rows<T, NT>(p, bk);
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* kb = static_cast<const T*>(p.k) + bk.b * p.ksb + bk.h * p.ksh;
  const T* vb = static_cast<const T*>(p.v) + bk.b * p.vsb + bk.h * p.vsh;
  if (bk.kbeg < bk.kend) {  // else an empty half of a split row tile
    load_q<T, D, NT, kGmma>(sQ, p, bk);
    load_kv<T, D, NT, kGmma>(sK, kb, p.kss, bk.kbeg, p);
    cp_commit();
  }

  // this lane's two rows (accumulator elements i with (i / 2) % 2 = x)
  const int ra = warp * 16 + (lane >> 2);
  int qpos[2];
#pragma unroll
  for (int x = 0; x < 2; ++x)
    qpos[x] = (bk.row0 + ra + 8 * x) / bk.g + bk.off;
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float sl2 = p.scale * 1.4426950408889634f;  // exp(x) = 2^(x log2 e)

  for (int k0 = bk.kbeg; k0 < bk.kend; k0 += kBC) {
    cp_wait_all();
    fence_async_shared();
    __syncthreads();  // K(t) landed; every warp is done with V(t-1)

    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int off = (ks >> 2) * kBR * 64 + (ks & 3) * 16;
      wgmma_ss(s, gmma_desc(sQ + off, 16, 1024),
               gmma_desc(sK + off, 16, 1024));
    }
    wgmma_commit();
    // V(t)'s copies are issued while the tensor cores compute S
    load_kv<T, D, NT, kGmma>(sV, vb, p.vss, k0, p);
    cp_commit();
    wgmma_wait_all();
    fence_regs(s);

    const bool mask = needs_mask(p, bk, k0);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      s[i] *= sl2;
      if (mask && !kept(p, k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1),
                        qpos[(i >> 1) & 1]))
        s[i] = -INFINITY;
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < NS; ++i)
        if (((i >> 1) & 1) == x) mx = fmaxf(mx, s[i]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mnew = fmaxf(m[x], mx);
      const float mu = mnew == -INFINITY ? 0.f : mnew;
      const float alpha = exp2f(m[x] - mu);
      m[x] = mnew;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < NS; ++i)
        if (((i >> 1) & 1) == x) {
          s[i] = exp2f(s[i] - mu);
          sum += s[i];
        }
      l[x] = l[x] * alpha + sum;  // this lane's share; quad-reduced at end
#pragma unroll
      for (int i = 0; i < NO; ++i)
        if (((i >> 1) & 1) == x) o[i] *= alpha;
    }
    // P as the A operand of P V, 16 keys a k-step, split into a bf16
    // part and its bf16 residual (P = hi + lo to about 2^-17, as the
    // float32 P of the Pallas kernel)
    uint32_t pa[kBC / 16][4], pr[kBC / 16][4];
#pragma unroll
    for (int t = 0; t < kBC / 16; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_bf16(s[8 * t + 2 * r], s[8 * t + 2 * r + 1], pa[t][r],
                   pr[t][r]);

    cp_wait_all();
    fence_async_shared();
    __syncthreads();  // V(t) landed; every warp is done with K(t)
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < kBC / 16; ++t) {
      const uint64_t dv = gmma_desc(sV + t * 16 * 64, kBC * 128, 1024);
      wgmma_rs(o, pa[t], dv);
      wgmma_rs(o, pr[t], dv);
    }
    wgmma_commit();
    // K(t+1)'s copies are issued while the tensor cores compute P V
    if (k0 + kBC < bk.kend) {
      load_kv<T, D, NT, kGmma>(sK, kb, p.kss, k0 + kBC, p);
      cp_commit();
    }
    wgmma_wait_all();
    fence_regs(o);
  }

#pragma unroll
  for (int x = 0; x < 2; ++x) {
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 1);
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 2);
  }
  if (p.nsplit > 1) {
    split_epilogue<D>(p, bk, o, m, l, ra, lane);
    return;
  }
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const float inv = 1.f / fmaxf(l[x], 1e-30f);
    const int row = bk.row0 + ra + 8 * x;
    if (row >= bk.rows) continue;
    T* dst = out_row<T>(p, bk, row);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = j * 8 + (lane & 3) * 2;
      const float y0 = o[4 * j + 2 * x] * inv, y1 = o[4 * j + 2 * x + 1] * inv;
      if (c + 1 < p.d && !(p.d & 1)) {
        *reinterpret_cast<__nv_bfloat162*>(dst + c) =
            __floats2bfloat162_rn(y0, y1);
      } else {
        if (c < p.d) dst[c] = __float2bfloat16(y0);
        if (c + 1 < p.d) dst[c + 1] = __float2bfloat16(y1);
      }
    }
  }
}

// -------------------------------------------------------------- float32

template <int D>
__global__ void __launch_bounds__(256, D <= 128 ? 2 : 1) flash_f32(Params p) {
  constexpr int NT = 256, NC = D / 64, CL = D / 32;  // CL: 8-chunk groups
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + kBR * D;
  float* sV = sK + kBC * D;
  float* sP = sV + kBC * D;  // [key][row chunk], swizzled
  const Block bk = block_of(p);
  if (bk.kbeg >= bk.kend) {
    zero_rows<float, NT>(p, bk);
    return;
  }
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* kb = static_cast<const float*>(p.k) + bk.b * p.ksb +
                    bk.h * p.ksh;
  const float* vb = static_cast<const float*>(p.v) + bk.b * p.vsb +
                    bk.h * p.vsh;
  load_q<float, D, NT, kRowsSwz>(sQ, p, bk);
  load_kv<float, D, NT, kRowsSwz>(sK, kb, p.kss, bk.kbeg, p);
  cp_commit();

  float acc[4][NC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }

  for (int k0 = bk.kbeg; k0 < bk.kend; k0 += kBC) {
    cp_wait_all();
    __syncthreads();  // K(t) landed; everyone is done with V(t-1), P(t-1)
    load_kv<float, D, NT, kRows>(sV, vb, p.vss, k0, p);
    cp_commit();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    // rows ty + 16 i and keys tx + 16 j keep the swizzle of ty and tx
#pragma unroll 1
    for (int cl = 0; cl < 8; ++cl) {
      const float* qp = sQ + ty * D + ((cl ^ (ty & 7)) << 2);
      const float* kp = sK + tx * D + ((cl ^ (tx & 7)) << 2);
#pragma unroll
      for (int ch = 0; ch < CL; ++ch) {
        float4 kv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kv[j] = *reinterpret_cast<const float4*>(kp + j * 16 * D + ch * 32);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 qv =
              *reinterpret_cast<const float4*>(qp + i * 16 * D + ch * 32);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
            s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
            s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
          }
        }
      }
    }

    const bool mask = needs_mask(p, bk, k0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] *= p.scale;
        if (mask && !kept(p, k0 + j * 16 + tx,
                          (bk.row0 + i * 16 + ty) / bk.g + bk.off))
          s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float mnew = fmaxf(m[i], mx);
      const float mu = mnew == -INFINITY ? 0.f : mnew;
      const float alpha = expf(m[i] - mu);
      m[i] = mnew;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mu);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + sum;  // this thread's share; reduced at end
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)  // key tx + 16 j: chunk ty ^ tx of its row
      *reinterpret_cast<float4*>(sP + (j * 16 + tx) * kBR + ((ty ^ tx) << 2)) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);

    cp_wait_all();
    __syncthreads();  // V(t) and P(t) visible; everyone is done with K(t)
    if (k0 + kBC < bk.kend) {
      load_kv<float, D, NT, kRowsSwz>(sK, kb, p.kss, k0 + kBC, p);
      cp_commit();
    }
#pragma unroll 8
    for (int j = 0; j < kBC; ++j) {
      const float4 pv = *reinterpret_cast<const float4*>(
          sP + j * kBR + ((ty ^ (j & 15)) << 2));
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(
            sV + j * D + c * 64 + tx * 4);
        const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][c][0] = fmaf(pr[i], vv.x, acc[i][c][0]);
          acc[i][c][1] = fmaf(pr[i], vv.y, acc[i][c][1]);
          acc[i][c][2] = fmaf(pr[i], vv.z, acc[i][c][2]);
          acc[i][c][3] = fmaf(pr[i], vv.w, acc[i][c][3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int w = 1; w < 16; w <<= 1)
      li += __shfl_xor_sync(0xffffffffu, li, w);
    const float den = fmaxf(li, 1e-30f);
    const int row = bk.row0 + i * 16 + ty;
    if (row >= bk.rows) continue;
    float* dst = out_row<float>(p, bk, row);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = c * 64 + tx * 4;
      const float y[4] = {acc[i][c][0] / den, acc[i][c][1] / den,
                          acc[i][c][2] / den, acc[i][c][3] / den};
      if (col + 3 < p.d && !(p.d & 3)) {
        *reinterpret_cast<float4*>(dst + col) =
            make_float4(y[0], y[1], y[2], y[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < p.d) dst[col + e] = y[e];
      }
    }
  }
}

// ---------------------------------------------------------------- launch

template <typename K>
int launch_kernel(K kern, int smem, int threads, const Params& p,
                  cudaStream_t stream, bool& attr_set) {
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int64_t blocks = static_cast<int64_t>(p.nbh) * p.ntiles * p.nsplit;
  if (blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  kern<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(int dtype, const Params& p, cudaStream_t s) {
  if (dtype == 1) {
    static bool set = false;
    return launch_kernel(flash_bf16<D>, 3 * kBC * D * 2, 128, p, s, set);
  }
  static bool set = false;
  return launch_kernel(flash_f32<D>, 3 * kBC * D * 4 + kBC * kBR * 4, 256,
                       p, s, set);
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
    int nsplit, float* ws, int* cnt, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || d <= 0 || d > 256 || b <= 0 || sq <= 0 ||
      (dtype != 0 && dtype != 1) || (nsplit != 1 && nsplit != 2) ||
      (nsplit == 2 && (dtype != 1 || !ws || !cnt)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t es = dtype == 0 ? 4 : 2;
  // 16-byte copies need 16-byte aligned rows: pointers, head dim, and the
  // stride of every dim longer than 1
  bool vec = (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
              reinterpret_cast<uintptr_t>(v)) % 16 == 0 &&
             (d * es) % 16 == 0;
  const int64_t strides[9] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss};
  const int sizes[9] = {b, hq, sq, b, hkv, sk, b, hkv, sk};
  for (int i = 0; i < 9; ++i)
    if (sizes[i] > 1 && (strides[i] * es) % 16 != 0) vec = false;
  Params p{q,   k,   v,   o,   hq,  hkv, sq,  sk,  d,   causal, window, scale,
           qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, b * hkv, 0,     vec,
           nsplit, ws, cnt};
  p.ntiles = static_cast<int>(
      (static_cast<int64_t>(sq) * (hq / hkv) + kBR - 1) / kBR);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return launch_d<64>(dtype, p, s);
  if (d <= 128) return launch_d<128>(dtype, p, s);
  return launch_d<256>(dtype, p, s);
}
