// queue_select: masked lexicographic argmin over the job table, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/queue_select/kernel.py::_select_kernel
// (launched by queue_select_tiled).  It computes what
// repro_torch/kernels/queue_select/ref.py computes: the first index attaining
// the minimum score among feasible entries, and that score, or (-1, BIG) when
// no entry is feasible.  It is not a port of the TPU's sequential tile loop,
// which carried its best pair in SMEM from one grid step to the next: blocks
// on this card run in no order, so every block reduces its share to one
// 64-bit key and folds it into one word with atomicMin.
//
// Key: ((uint32)score ^ 0x80000000) << 32 | index.  Flipping the sign bit
// makes the unsigned order of the key the signed order of the score (LJF
// keys on -estimate, priorities come from the user), and the index in the
// low word breaks ties to the lowest index.  An infeasible entry maps to
// UINT64_MAX, which no feasible entry can reach (its index would have to be
// 2^32 - 1), so a feasible entry scoring BIG is still found.
//
// Bound: the kernel reads N * (4 + mask bytes) bytes once (mask bytes = 1
// for a bool mask, the engine's case, 4 for int32) and writes 8.  At the
// engine's N <= 73,496 that is at most 368 KB, about 0.11 us at 3.35 TB/s,
// so a call is bound by launch latency, not bandwidth.  The design does one
// pass over the data and one atomic per block, with a grid capped at two
// blocks per SM, and the wrapper's C entry point enqueues the scratch reset,
// the reduction and the decode in one call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 264;  // two blocks on each of the H100's 132 SMs
constexpr int32_t kBig = (1 << 30) - 1;
constexpr unsigned long long kNone = ~0ull;

__device__ __forceinline__ unsigned long long umin(unsigned long long a,
                                                   unsigned long long b) {
  return b < a ? b : a;
}

template <typename Mask>
__global__ void __launch_bounds__(kThreads)
select_reduce(const int32_t* __restrict__ scores,
              const Mask* __restrict__ feasible, long long n,
              unsigned long long* __restrict__ best) {
  unsigned long long key = kNone;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    if (feasible[i] != 0) {
      const uint32_t s = (uint32_t)scores[i] ^ 0x80000000u;
      key = umin(key, ((unsigned long long)s << 32) | (uint32_t)i);
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    key = umin(key, __shfl_down_sync(0xffffffffu, key, off));

  __shared__ unsigned long long warp_best[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_best[warp] = key;
  __syncthreads();
  if (warp == 0) {
    key = lane < kThreads / 32 ? warp_best[lane] : kNone;
    for (int off = 16; off > 0; off >>= 1)
      key = umin(key, __shfl_down_sync(0xffffffffu, key, off));
    if (lane == 0 && key != kNone) atomicMin(best, key);
  }
}

__global__ void select_decode(const unsigned long long* __restrict__ best,
                              int32_t* __restrict__ out) {
  const unsigned long long key = *best;
  if (key == kNone) {
    out[0] = -1;
    out[1] = kBig;
  } else {
    out[0] = (int32_t)(uint32_t)(key & 0xffffffffull);
    out[1] = (int32_t)((uint32_t)(key >> 32) ^ 0x80000000u);
  }
}

}  // namespace

// scores: int32[n]; feasible: n entries of mask_bytes (1 = bool, 4 = int32);
// scratch: one 8-byte-aligned uint64 word; out: int32[2].  All on the device
// of `stream`.  Allocates nothing, does not synchronise, and returns the
// CUDA error code of the enqueue (0 = success).
extern "C" int queue_select_launch(const void* scores, const void* feasible,
                                   int mask_bytes, long long n, void* scratch,
                                   void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || (mask_bytes != 1 && mask_bytes != 4))
    return (int)cudaErrorInvalidValue;
  unsigned long long* best = static_cast<unsigned long long*>(scratch);
  cudaError_t err = cudaMemsetAsync(best, 0xff, sizeof(*best), s);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const int32_t* sc = static_cast<const int32_t*>(scores);
  if (mask_bytes == 1)
    select_reduce<uint8_t><<<(int)blocks, kThreads, 0, s>>>(
        sc, static_cast<const uint8_t*>(feasible), n, best);
  else
    select_reduce<int32_t><<<(int)blocks, kThreads, 0, s>>>(
        sc, static_cast<const int32_t*>(feasible), n, best);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  select_decode<<<1, 1, 0, s>>>(best, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
