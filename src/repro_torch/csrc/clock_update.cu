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
// atomics, so this kernel does O(B) work in two launches:
//   pass 1 (claim): each valid access j hashes to its slot s and
//     atomicMax-es j into last_cand[s], and into last_hit[s] if its key
//     equals the resident key.  A max does not depend on the order of
//     the atomics, so the result is deterministic.
//   pass 2 (apply): the access with j == last_cand[s] is the slot's
//     winner; it alone reads and writes the slot's key/clock/loc, then
//     resets last_cand[s] and last_hit[s] to -1.
// The scratch (int32[T] x 2) is allocated once by the wrapper, set to -1,
// and stays all -1 between calls.
//
// Bound on an H100: memory bytes.  The batch is read once (keys, occ,
// locs, valid: 10 bytes an access) and each touched slot is read and
// written once (key, clock, loc: 12 bytes), about 90 KB at B = 4096:
// tens of nanoseconds at 3.35 TB/s, so at this batch size the kernel's
// time is launch latency and the atomics' round trips to L2.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

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

__global__ void clock_claim(const int32_t* __restrict__ keys,
                            const uint8_t* __restrict__ valid, int b,
                            const int32_t* __restrict__ tk, uint32_t t,
                            int32_t* last_cand, int32_t* last_hit) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= b || !valid[j]) return;
  int32_t k = keys[j];
  uint32_t s = slot_of(k, t);
  atomicMax(&last_cand[s], j);
  if (tk[s] == k) atomicMax(&last_hit[s], j);
}

__global__ void clock_apply(const int32_t* __restrict__ keys,
                            const int32_t* __restrict__ occ,
                            const int8_t* __restrict__ locs,
                            const uint8_t* __restrict__ valid, int b,
                            int32_t* tk, int8_t* tc, int8_t* tl, uint32_t t,
                            int32_t* last_cand, int32_t* last_hit) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= b || !valid[j]) return;
  uint32_t s = slot_of(keys[j], t);
  if (last_cand[s] != j) return;  // not the slot's last access
  int32_t h = last_hit[s];
  if (h >= 0) {
    tc[s] = 3;
    tl[s] = locs[h];
  } else {
    int32_t rk = tk[s];
    int8_t c = tc[s];
    if (rk < 0 || c == 0) {
      tk[s] = keys[j];
      tc[s] = occ[j] >= 2 ? 3 : 0;
      tl[s] = locs[j];
    } else {
      tc[s] = c - 1;
    }
  }
  last_cand[s] = -1;
  last_hit[s] = -1;
}

}  // namespace

extern "C" int clock_update_launch(const int32_t* keys, const int32_t* occ,
                                   const int8_t* locs, const uint8_t* valid,
                                   int b, int32_t* tk, int8_t* tc,
                                   int8_t* tl, int t, int32_t* last_cand,
                                   int32_t* last_hit, void* stream) {
  if (b <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const int blocks = (b + threads - 1) / threads;
  clock_claim<<<blocks, threads, 0, st>>>(keys, valid, b, tk,
                                          static_cast<uint32_t>(t),
                                          last_cand, last_hit);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  clock_apply<<<blocks, threads, 0, st>>>(keys, occ, locs, valid, b, tk, tc,
                                          tl, static_cast<uint32_t>(t),
                                          last_cand, last_hit);
  return static_cast<int>(cudaGetLastError());
}
