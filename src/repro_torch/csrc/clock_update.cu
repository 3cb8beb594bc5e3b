// Batched CLOCK tracker update for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/clock_update/clock_update.py
// (`clock_update`, pallas_call at :99; wrapper ops.py `tracker_access`).
// Semantics are those of tracker.access_batched, bit for bit: per slot,
// any access matching the resident key sets clock 3 and the loc of the
// last matching access; otherwise the LAST valid access that hashes to
// the slot is the candidate: an empty or clock-0 slot takes it (clock 3
// if its key occurs >= 2 times in the batch, else 0, and its loc), an
// occupied slot with clock > 0 decays by one.
//
// Design.  The TPU has no atomics, so the Pallas kernel walks the whole
// table tile by tile against the whole batch: O(T * B) compares (about
// 4e10 per batch at the paper's T = 10.1 M and B = 4096).  Hopper has
// atomics, so this kernel does O(B) work in three passes:
//   claim: each valid access j hashes to its slot s and atomicMax-es j
//     into last_cand[s], and into last_hit[s] if its key equals the
//     resident key.  A max does not depend on the order of the atomics,
//     so the result is deterministic.
//   mark: the slot's winner w = last_cand[s] is its last valid access.
//     Every occurrence of a key hashes to the key's slot, so w's key
//     occurs >= 2 times in the batch iff another valid access j of the
//     same slot carries it: such a j stores 1 into dup[w] (a plain
//     store of one value, so the order does not matter).  This replaces
//     the per-access occurrence count (a sort and segment sums) that the
//     plain version computes.
//   apply: the winner alone reads and writes the slot's key/clock/loc
//     (clock 3 on an insert iff dup[w]), then resets last_cand[s],
//     last_hit[s] and dup[w].
// The scratch (int32[T] x 2, set to -1; uint8[B], set to 0) is allocated
// by the wrapper, held across calls, and clean again after every call.
//
// Launches.  The three passes are three launches of B / 256 blocks
// (one C call).  A single-block kernel that runs them between
// __syncthreads was measured on an H100 and is not faster at the
// engine's batch of 4,096, nor at 2,048 (PERF.md).
//
// Bound on an H100: memory bytes.  The batch is read once (keys, locs,
// valid: 6 bytes an access) and each touched slot is read and written
// once (key, clock, loc: 12 bytes), about 70 KB at B = 4096: tens of
// nanoseconds at 3.35 TB/s, so at this batch size the kernel's time is
// launch latency and the atomics' round trips to L2.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t slot_of(int32_t key, uint32_t t) {
  // utils.hash_u32(key, salt=1) % t, in native uint32 arithmetic
  uint32_t x = static_cast<uint32_t>(key);
  x ^= 0x9E3779B9u;
  x *= 2246822519u;
  x ^= x >> 15;
  x *= 2246822519u;
  x ^= x >> 13;
  return x % t;
}

struct Args {
  const int32_t* keys;
  const int8_t* locs;
  const uint8_t* valid;
  int b;
  int32_t* tk;
  int8_t* tc;
  int8_t* tl;
  uint32_t t;
  int32_t* last_cand;
  int32_t* last_hit;
  uint8_t* dup;
};

__global__ void clock_claim(Args a) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= a.b || !a.valid[j]) return;
  const int32_t k = a.keys[j];
  const uint32_t s = slot_of(k, a.t);
  atomicMax(&a.last_cand[s], j);
  if (a.tk[s] == k) atomicMax(&a.last_hit[s], j);
}

__global__ void clock_mark(Args a) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= a.b || !a.valid[j]) return;
  const int32_t k = a.keys[j];
  const int32_t w = a.last_cand[slot_of(k, a.t)];
  if (w != j && a.keys[w] == k) a.dup[w] = 1;
}

__global__ void clock_apply(Args a) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= a.b || !a.valid[j]) return;
  const int32_t k = a.keys[j];
  const uint32_t s = slot_of(k, a.t);
  if (a.last_cand[s] != j) return;  // not the slot's last access
  const int32_t h = a.last_hit[s];
  if (h >= 0) {
    a.tc[s] = 3;
    a.tl[s] = a.locs[h];
  } else {
    const int32_t rk = a.tk[s];
    const int8_t c = a.tc[s];
    if (rk < 0 || c == 0) {
      a.tk[s] = k;
      a.tc[s] = a.dup[j] ? 3 : 0;
      a.tl[s] = a.locs[j];
    } else {
      a.tc[s] = c - 1;
    }
  }
  a.last_cand[s] = -1;
  a.last_hit[s] = -1;
  a.dup[j] = 0;
}

}  // namespace

// keys int32[b], locs int8[b], valid bool[b]; the tracker tables
// tk int32[t], tc int8[t], tl int8[t] updated in place; scratch
// last_cand / last_hit int32[t] all -1 and dup uint8[>= b] all 0 on
// entry, and again on exit.  Returns the cudaError_t of the launches.
extern "C" int clock_update_launch(const int32_t* keys, const int8_t* locs,
                                   const uint8_t* valid, int b, int32_t* tk,
                                   int8_t* tc, int8_t* tl, int t,
                                   int32_t* last_cand, int32_t* last_hit,
                                   uint8_t* dup, void* stream) {
  if (b <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{keys, locs, valid, b, tk, tc, tl, static_cast<uint32_t>(t),
               last_cand, last_hit, dup};
  const int blocks = (b + kThreads - 1) / kThreads;
  clock_claim<<<blocks, kThreads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  clock_mark<<<blocks, kThreads, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  clock_apply<<<blocks, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
