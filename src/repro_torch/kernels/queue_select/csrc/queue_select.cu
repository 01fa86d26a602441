// queue_select: masked lexicographic argmin over the job table, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/queue_select/kernel.py::_select_kernel
// (launched by queue_select_tiled).  It computes what
// repro_torch/kernels/queue_select/ref.py computes: the first index attaining
// the minimum score among feasible entries, and that score, or (-1, BIG) when
// no entry is feasible.  Three entry points share one reduction:
//
//   queue_select_launch   the TPU kernel's function: scores and mask given,
//                         (index, score) written to device memory;
//   queue_select_fused    the engine's selections: the key and the mask are
//                         built in registers from the job table's columns
//                         (one mode per argmin of the selectors), and
//                         (index, score) lands in mapped host memory;
//   queue_select_walk     the EASY shadow walk: the running jobs' releases
//                         (max(rsv_finish, clock + 1), row) taken in order
//                         until they cover the head, all in one launch;
//   queue_select_fused_batch, queue_select_walk_batch
//                         the same two for n_req requests at once, one per
//                         member of an ensemble's stacked [B, J] table: one
//                         launch of n_req clusters, cluster r serving
//                         request r with its own columns (pointers offset
//                         to its member's row), mode and scalars, and
//                         writing its answer to words 4r.. of the host
//                         buffer;
//   queue_select_batch    the TPU kernel's function for n_req rows of a
//                         stacked [B, n] score matrix and mask (the batched
//                         pool engine's selections): the requested members
//                         uploaded once, one launch of n_req clusters,
//                         cluster r folding row members[r] and writing
//                         (index, score) to words 2r, 2r + 1 of the host
//                         buffer.
//
// Key: ((uint32)score ^ 0x80000000) << 32 | row.  Flipping the sign bit
// makes the unsigned order of the key the signed order of the score (LJF
// keys on -estimate, priorities come from the user), and the row in the low
// word breaks ties to the lowest row.  An infeasible row maps to UINT64_MAX,
// which no feasible row can reach (its row would have to be 2^32 - 1), so a
// feasible row scoring BIG is still found.
//
// Design: one launch per call.  The TPU carried its best pair in SMEM from
// one sequential grid step to the next; here one thread-block cluster of 8
// CTAs x 1,024 threads (8 is the portable cluster size) reads the rows in a
// grid-stride loop, each CTA folds its threads' keys (warp shuffles, then
// shared memory), and the CTAs exchange their keys through distributed
// shared memory under one cluster barrier.  No scratch word survives a call,
// so there is no memset and no decode kernel.  The cluster's first barrier
// phase (arrive at entry, wait before the first remote store) proves that
// every CTA of the cluster has started before its shared memory is written.
//
// The walk keeps, in each thread, the least key of its own running rows
// above the last release taken.  One step is one cluster-wide fold of those
// keys; after it only the thread that owned the winner rescans its rows (at
// N = 73,496, nine of them), so a step costs one fold and not a pass over
// the table, and the walk is right for any number of running rows.
//
// Bound: the bytes of the columns a mode reads, each once: 4 (jstate) plus
// 4 per key or predicate column: HEAD_*, BESTFIT, ANY_FIT and PREEMPT_TIER
// 8 B a row, PREEMPT_HEAD 12, BACKFILL_CAND 16, the walk 12 (jstate,
// rsv_finish, nodes).
// At the engine's N <= 73,496 that is at most 1.2 MB, ~0.35 us at 3.35 TB/s,
// and the table stays in the 50 MB L2 between calls: a call is bound by its
// launch and the host's wait, which is why there is one launch and one wait.
// A batched call reads the same bytes for each of its requests, B x J x the
// mode's bytes a row, and keeps one launch and one wait for all of them.
// The generic batched call reads 5 B a row (score and bool mask) of each
// requested row: B x n x 5 B, 0.3 us at B = 32 and n = 2,625.
//
// The batched entries' requests: B SelectArgs outgrow the 4 KB of kernel
// parameters at a few dozen members, so the host writes the request array
// into pinned memory and uploads it with one cudaMemcpyAsync into a device
// buffer on the launch's stream; each CTA then reads its own request once,
// into shared memory.  The first design had the kernel read the requests
// from mapped pinned memory instead, one copy fewer on the stream, but
// those reads over PCIe cost the kernel 8 to 16 us, growing with the
// number of requests, where the upload and the kernel together take 6.0 to
// 6.2 us of device time at 1 to 8 requests of 10,000 rows on an H100
// (scripts/queue_select_batch_split.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;
constexpr int kStride = kThreads * kCluster;
constexpr int32_t kBig = (1 << 30) - 1;
constexpr int32_t kWaiting = 1;
constexpr int32_t kRunning = 2;
constexpr int32_t kSentinel = INT32_MIN;  // "not written" in the host buffer
constexpr unsigned long long kNone = ~0ull;
constexpr int kMaxRequests = 1 << 16;    // requests a batched call takes

// Key modes; the same numbers as ref.py.
enum Mode : int {
  HEAD_SUBMIT = 0,
  HEAD_ESTIMATE = 1,
  HEAD_NEG_ESTIMATE = 2,
  BESTFIT = 3,
  ANY_FIT = 4,
  BACKFILL_CAND = 5,
  PREEMPT_TIER = 6,
  PREEMPT_HEAD = 7,
};

}  // namespace

// The fused entry points' argument block, passed by value to the kernel.
// Column pointers are int32[n] on the device; sums wrap in int32 as JAX's.
struct SelectArgs {
  const int32_t* submit;
  const int32_t* estimate;
  const int32_t* nodes;
  const int32_t* priority;
  const int32_t* jstate;
  const int32_t* rsv_finish;
  long long n;
  int32_t mode;
  int32_t clock;
  int32_t free;
  int32_t cap;
  int32_t shadow;
  int32_t extra;
  int32_t exclude;
  int32_t tier;
  int32_t head_need;
};
static_assert(sizeof(SelectArgs) == 96, "ops._SelectArgs mirrors this layout");

namespace {

__device__ __forceinline__ unsigned long long umin(unsigned long long a,
                                                   unsigned long long b) {
  return b < a ? b : a;
}

__device__ __forceinline__ unsigned long long pack(int32_t score, long long i) {
  return ((unsigned long long)((uint32_t)score ^ 0x80000000u) << 32) |
         (uint32_t)i;
}

__device__ __forceinline__ int32_t key_row(unsigned long long key) {
  return (int32_t)(uint32_t)(key & 0xffffffffull);
}

__device__ __forceinline__ int32_t key_score(unsigned long long key) {
  return (int32_t)((uint32_t)(key >> 32) ^ 0x80000000u);
}

__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int32_t sub32(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long k) {
  for (int off = 16; off > 0; off >>= 1)
    k = umin(k, __shfl_xor_sync(0xffffffffu, k, off));
  return k;
}

// Cluster barrier halves (PTX barrier.cluster); every thread takes part.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The CTA's least key, valid in every lane of warp 0.  `warp_best` is
// reused by the next call only after a barrier that warp 0 has passed.
__device__ __forceinline__ unsigned long long cta_min(
    unsigned long long key, unsigned long long* warp_best) {
  key = warp_min(key);
  if ((threadIdx.x & 31) == 0) warp_best[threadIdx.x >> 5] = key;
  __syncthreads();
  if (threadIdx.x < 32) key = warp_min(warp_best[threadIdx.x]);
  return key;
}

// One fold of every thread's key across the cluster; CTA 0's thread 0
// returns true with the least key in `*out_key`.  Called once per launch,
// after cluster_arrive_relaxed() at the kernel's entry.
__device__ __forceinline__ bool cluster_fold_once(unsigned long long key,
                                                  unsigned long long* out_key) {
  __shared__ unsigned long long warp_best[kWarps];
  __shared__ unsigned long long slots[kCluster];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  key = cta_min(key, warp_best);
  cluster_wait();  // every CTA has started: its shared memory exists
  if (threadIdx.x == 0) *cluster.map_shared_rank(&slots[rank], 0) = key;
  cluster_arrive();
  cluster_wait();
  if (rank != 0 || threadIdx.x >= 32) return false;
  key = warp_min(threadIdx.x < kCluster ? slots[threadIdx.x] : kNone);
  *out_key = key;
  return threadIdx.x == 0;
}

__device__ __forceinline__ void write_pair(unsigned long long key,
                                           volatile int32_t* out) {
  if (key == kNone) {
    out[0] = -1;
    out[1] = kBig;
  } else {
    out[0] = key_row(key);
    out[1] = key_score(key);
  }
}

// Every scan below reads its rows kUnroll at a time, all loads of a batch
// issued before any is used: a thread's rows are independent, so a batch
// costs one memory latency and not one per row and column.  Ten rows a
// thread cover 81,920 rows, the archive run's table, in one batch.
constexpr int kUnroll = 10;

// This thread's least key of the feasible scores over its rows of one row
// of n entries; `rank` is its CTA's rank in the cluster.
template <typename Mask>
__device__ __forceinline__ unsigned long long generic_scan(
    const int32_t* __restrict__ scores, const Mask* __restrict__ feasible,
    long long n, unsigned rank) {
  unsigned long long key = kNone;
  for (long long base = (long long)rank * kThreads + threadIdx.x;
       base < n; base += (long long)kStride * kUnroll) {
    Mask f[kUnroll];
    int32_t sc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + (long long)u * kStride;
      f[u] = i < n ? feasible[i] : Mask(0);
      sc[u] = i < n ? scores[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (f[u] != 0) key = umin(key, pack(sc[u], base + (long long)u * kStride));
  }
  return key;
}

template <typename Mask>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
select_generic(const int32_t* __restrict__ scores,
               const Mask* __restrict__ feasible, long long n,
               int32_t* __restrict__ out) {
  cluster_arrive_relaxed();
  unsigned long long key = generic_scan(scores, feasible, n, blockIdx.x);
  if (cluster_fold_once(key, &key)) write_pair(key, out);
}

// One generic selection a cluster: cluster r = blockIdx.x / kCluster folds
// row members[r] of the stacked [batch, n] scores and mask (the members
// read from device memory, uploaded by the call) and writes its answer to
// out[2 r], out[2 r + 1].
template <typename Mask>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
select_generic_batch(const int32_t* __restrict__ scores,
                     const Mask* __restrict__ feasible, long long n,
                     const int32_t* __restrict__ members, int32_t* out) {
  cluster_arrive_relaxed();
  const int r = blockIdx.x / kCluster;
  const unsigned rank = cg::this_cluster().block_rank();
  const long long row = (long long)members[r] * n;
  unsigned long long key =
      generic_scan(scores + row, feasible + row, n, rank);
  if (cluster_fold_once(key, &key)) write_pair(key, out + 2 * r);
}

// The columns mode M reads, besides jstate.
template <int M> struct Reads {
  static constexpr bool submit = M == HEAD_SUBMIT || M == BACKFILL_CAND ||
                                 M == PREEMPT_HEAD;
  static constexpr bool estimate = M == HEAD_ESTIMATE ||
                                   M == HEAD_NEG_ESTIMATE || M == BACKFILL_CAND;
  static constexpr bool nodes = M == BESTFIT || M == ANY_FIT ||
                                M == BACKFILL_CAND;
  static constexpr bool priority = M == PREEMPT_TIER || M == PREEMPT_HEAD;
};

struct Row {
  int32_t jstate, submit, estimate, nodes, priority;
};

template <int M>
__device__ __forceinline__ Row load_row(const SelectArgs& a, long long i) {
  Row r{0, 0, 0, 0, 0};
  r.jstate = a.jstate[i];
  if (Reads<M>::submit) r.submit = a.submit[i];
  if (Reads<M>::estimate) r.estimate = a.estimate[i];
  if (Reads<M>::nodes) r.nodes = a.nodes[i];
  if (Reads<M>::priority) r.priority = a.priority[i];
  return r;
}

// The key of row i under mode M, or kNone when the row is infeasible.
template <int M>
__device__ __forceinline__ unsigned long long row_key(const SelectArgs& a,
                                                      const Row& r,
                                                      long long i) {
  const bool waiting = r.jstate == kWaiting;
  switch (M) {
    case HEAD_SUBMIT:
      return waiting ? pack(r.submit, i) : kNone;
    case HEAD_ESTIMATE:
      return waiting ? pack(r.estimate, i) : kNone;
    case HEAD_NEG_ESTIMATE:
      return waiting ? pack(sub32(0, r.estimate), i) : kNone;
    case BESTFIT:
      return waiting && r.nodes <= a.cap ? pack(sub32(a.free, r.nodes), i)
                                         : kNone;
    case ANY_FIT:
      return waiting && r.nodes <= a.cap && i != a.exclude ? pack(0, i)
                                                           : kNone;
    case BACKFILL_CAND: {
      const bool ends_by = add32(r.estimate, a.clock) <= a.shadow;
      const bool within = r.nodes <= min(a.free, a.extra);
      return waiting && r.nodes <= a.cap && i != a.exclude &&
                     (ends_by || within)
                 ? pack(r.submit, i)
                 : kNone;
    }
    case PREEMPT_TIER:
      return pack(waiting ? r.priority : kBig, i);
    default:  // PREEMPT_HEAD
      return waiting && r.priority == a.tier ? pack(r.submit, i) : kNone;
  }
}

// This thread's least key of mode M over its rows; `rank` is its CTA's rank
// in the cluster.
template <int M>
__device__ __forceinline__ unsigned long long fused_scan(const SelectArgs& a,
                                                         unsigned rank) {
  unsigned long long key = kNone;
  for (long long base = (long long)rank * kThreads + threadIdx.x;
       base < a.n; base += (long long)kStride * kUnroll) {
    Row r[kUnroll] = {};
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + (long long)u * kStride;
      if (i < a.n) r[u] = load_row<M>(a, i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + (long long)u * kStride;
      if (i < a.n) key = umin(key, row_key<M>(a, r[u], i));
    }
  }
  return key;
}

template <int M>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
select_fused(const SelectArgs a, int32_t* out) {
  cluster_arrive_relaxed();
  unsigned long long key = fused_scan<M>(a, blockIdx.x);
  if (cluster_fold_once(key, &key)) write_pair(key, out);
}

// The request of this CTA's cluster, read once from device memory (one word
// a thread) into shared memory, then into registers.
__device__ __forceinline__ SelectArgs load_request(const SelectArgs* reqs,
                                                   int r) {
  constexpr int kWords = sizeof(SelectArgs) / sizeof(int32_t);
  __shared__ SelectArgs req;
  if (threadIdx.x < kWords)
    reinterpret_cast<int32_t*>(&req)[threadIdx.x] =
        reinterpret_cast<const int32_t*>(reqs + r)[threadIdx.x];
  __syncthreads();
  return req;
}

// One fused selection a cluster: clusters tile the grid in order, so
// cluster r = blockIdx.x / kCluster serves request r.  The mode is read at
// run time, once, and is the same for the whole cluster, so no warp
// diverges on it.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
select_fused_batch(const SelectArgs* reqs, int32_t* out) {
  cluster_arrive_relaxed();
  const int r = blockIdx.x / kCluster;
  const unsigned rank = cg::this_cluster().block_rank();
  const SelectArgs a = load_request(reqs, r);
  unsigned long long key = kNone;
  switch (a.mode) {
    case HEAD_SUBMIT: key = fused_scan<HEAD_SUBMIT>(a, rank); break;
    case HEAD_ESTIMATE: key = fused_scan<HEAD_ESTIMATE>(a, rank); break;
    case HEAD_NEG_ESTIMATE:
      key = fused_scan<HEAD_NEG_ESTIMATE>(a, rank);
      break;
    case BESTFIT: key = fused_scan<BESTFIT>(a, rank); break;
    case ANY_FIT: key = fused_scan<ANY_FIT>(a, rank); break;
    case BACKFILL_CAND: key = fused_scan<BACKFILL_CAND>(a, rank); break;
    case PREEMPT_TIER: key = fused_scan<PREEMPT_TIER>(a, rank); break;
    default: key = fused_scan<PREEMPT_HEAD>(a, rank); break;  // checked
  }
  if (cluster_fold_once(key, &key)) write_pair(key, out + 4 * r);
}

// A release: its key (max(rsv_finish, clock + 1), row) and its nodes.
struct Release {
  unsigned long long key;
  int32_t nodes;
};

__device__ __forceinline__ Release rmin(Release a, Release b) {
  return b.key < a.key ? b : a;
}

// The least release of this thread's running rows whose key is above
// `after` (all of them for kNone).
__device__ __forceinline__ Release next_release(const SelectArgs& a,
                                                long long first,
                                                unsigned long long after) {
  Release best{kNone, 0};
  const int32_t t_min = add32(a.clock, 1);
  for (long long base = first; base < a.n;
       base += (long long)kStride * kUnroll) {
    int32_t js[kUnroll], rsv[kUnroll], nodes[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + (long long)u * kStride;
      js[u] = i < a.n ? a.jstate[i] : 0;
      rsv[u] = i < a.n ? a.rsv_finish[i] : 0;
      nodes[u] = i < a.n ? a.nodes[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + (long long)u * kStride;
      const unsigned long long k = pack(max(rsv[u], t_min), i);
      if (js[u] == kRunning && (after == kNone || k > after))
        best = rmin(best, Release{k, nodes[u]});
    }
  }
  return best;
}

__device__ __forceinline__ Release warp_rmin(Release r) {
  const unsigned long long k = warp_min(r.key);
  // keys are unique, so one lane holds k (or every lane holds kNone)
  const int src = __ffs(__ballot_sync(0xffffffffu, r.key == k)) - 1;
  return Release{k, __shfl_sync(0xffffffffu, r.nodes, src)};
}

// The walk of one cluster, entered after cluster_arrive_relaxed(); CTA 0's
// thread 0 writes (shadow, extra, k_row, steps) to out[0..3].
__device__ __forceinline__ void walk_cluster(const SelectArgs& a,
                                             int32_t* out) {
  __shared__ Release warp_best[kWarps];
  __shared__ Release slots[2][kCluster];   // by step parity
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const long long first = (long long)rank * kThreads + threadIdx.x;
  Release mine = next_release(a, first, kNone);
  cluster_wait();  // every CTA has started: its shared memory exists

  // Every thread computes the same winner each step, so the loop's exits
  // are uniform across the cluster.
  int32_t cum = a.free, shadow = kBig, k_row = -1, taken = 0;
  for (int step = 0;; ++step) {
    // the CTA's least release, then into slot `rank` of every CTA
    Release r = warp_rmin(mine);
    if ((threadIdx.x & 31) == 0) warp_best[threadIdx.x >> 5] = r;
    __syncthreads();
    if (threadIdx.x < 32) {
      r = warp_rmin(warp_best[threadIdx.x]);
      if (threadIdx.x < kCluster)
        *cluster.map_shared_rank(&slots[step & 1][rank], threadIdx.x) = r;
    }
    cluster_arrive();
    cluster_wait();
    Release w = slots[step & 1][0];
    for (int c = 1; c < kCluster; ++c) w = rmin(w, slots[step & 1][c]);
    if (w.key == kNone) break;  // every release counted, head not covered
    const int32_t row = key_row(w.key);
    ++taken;
    cum = add32(cum, w.nodes);
    shadow = key_score(w.key);
    k_row = row;
    if (cum >= a.head_need) break;
    if (row % kStride == first) mine = next_release(a, first, w.key);
  }
  // No CTA reads another's shared memory after the last barrier, so the
  // CTAs may leave without another one.
  if (rank == 0 && threadIdx.x == 0) {
    volatile int32_t* o = out;
    const bool covered = k_row >= 0 && cum >= a.head_need;
    o[0] = covered ? shadow : kBig;
    o[1] = covered ? sub32(cum, a.head_need) : a.free;
    o[2] = covered ? k_row : -1;
    o[3] = taken;  // releases counted: the walk's steps
  }
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
shadow_walk(const SelectArgs a, int32_t* out) {
  cluster_arrive_relaxed();
  walk_cluster(a, out);
}

// One walk a cluster, cluster r serving request r (as select_fused_batch).
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
shadow_walk_batch(const SelectArgs* reqs, int32_t* out) {
  cluster_arrive_relaxed();
  const int r = blockIdx.x / kCluster;
  const SelectArgs a = load_request(reqs, r);
  walk_cluster(a, out + 4 * r);
}

// Mapped, pinned host memory: the words the kernels write their answers
// into, and the batched entries' requests before their upload.  One buffer
// of each per host thread, reused call after call and grown when a call
// needs more.  A kernel's writes are visible to the host once the kernel
// has completed, which the call waits for (cudaStreamSynchronize) before it
// reads them and returns, so the next call can neither overwrite words not
// yet read nor free a buffer a copy or a kernel still reads.
struct Mapped {
  char* host = nullptr;
  char* dev = nullptr;
  size_t bytes = 0;
};

// `m` with room for `bytes` (its earlier contents dropped), or false.
bool ensure(Mapped& m, size_t bytes) {
  if (m.bytes >= bytes) return true;
  size_t want = 4096;
  while (want < bytes) want *= 2;
  if (m.host != nullptr) cudaFreeHost(m.host);
  m = Mapped{};
  void* p = nullptr;
  if (cudaHostAlloc(&p, want, cudaHostAllocMapped | cudaHostAllocPortable) !=
      cudaSuccess)
    return false;
  void* d = nullptr;
  if (cudaHostGetDevicePointer(&d, p, 0) != cudaSuccess) {
    cudaFreeHost(p);
    return false;
  }
  m = Mapped{static_cast<char*>(p), static_cast<char*>(d), want};
  return true;
}

Mapped& answer_words() {
  static thread_local Mapped m;
  return m;
}

Mapped& request_words() {
  static thread_local Mapped m;
  return m;
}

// The device buffer the requests are uploaded into: one per host thread,
// on the device current when it was made, grown when a call needs more.
struct DeviceBuffer {
  void* ptr = nullptr;
  size_t bytes = 0;
  int device = -1;
};

// `b` with room for `bytes` on the current device, or a CUDA error code.
int ensure_device(DeviceBuffer& b, size_t bytes) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (b.bytes >= bytes && b.device == device) return 0;
  size_t want = 4096;
  while (want < bytes) want *= 2;
  if (b.ptr != nullptr) {
    int current = device;
    cudaSetDevice(b.device);
    cudaFree(b.ptr);
    cudaSetDevice(current);
  }
  b = DeviceBuffer{};
  err = cudaMalloc(&b.ptr, want);
  if (err != cudaSuccess) return (int)err;
  b.bytes = want;
  b.device = device;
  return 0;
}

DeviceBuffer& request_buffer() {
  static thread_local DeviceBuffer b;
  return b;
}

template <int M>
void launch_fused(const SelectArgs& a, int32_t* out, cudaStream_t s) {
  select_fused<M><<<kCluster, kThreads, 0, s>>>(a, out);
}

// Enqueue `launch` writing `words` answers into the host buffer, wait for
// the stream, copy the answers into `result`.  Every answer is `stride`
// words; one whose first word the kernel left unwritten is an error, never
// an answer.  Returns a CUDA error code.
template <typename Launch>
int run_sync(Launch launch, int words, int stride, cudaStream_t s,
             int32_t* result) {
  Mapped& m = answer_words();
  if (!ensure(m, (size_t)words * sizeof(int32_t)))
    return (int)cudaErrorMemoryAllocation;
  volatile int32_t* host = reinterpret_cast<int32_t*>(m.host);
  for (int w = 0; w < words; ++w) host[w] = kSentinel;
  launch(reinterpret_cast<int32_t*>(m.dev));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamSynchronize(s);
  if (err != cudaSuccess) return (int)err;
  for (int w = 0; w < words; ++w) {
    result[w] = host[w];
    if (result[w] == kSentinel && w % stride == 0)
      return (int)cudaErrorUnknown;
  }
  return 0;
}

// Copy `bytes` of requests into pinned memory, enqueue their upload into
// the device buffer on `s`, and leave its address in `*dev`.  Returns a
// CUDA error code.
int upload(const void* src, size_t bytes, cudaStream_t s, const void** dev) {
  Mapped& m = request_words();
  if (!ensure(m, bytes)) return (int)cudaErrorMemoryAllocation;
  DeviceBuffer& d = request_buffer();
  const int bad = ensure_device(d, bytes);
  if (bad != 0) return bad;
  memcpy(m.host, src, bytes);
  const cudaError_t err =
      cudaMemcpyAsync(d.ptr, m.host, bytes, cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return (int)err;
  *dev = d.ptr;
  return 0;
}

// Upload `n_req` SelectArgs requests (see upload) and leave their device
// address in `*reqs`.  Every request must name a table (1 <= n <=
// INT32_MAX) and, with `modes`, a known mode.  Returns a CUDA error code.
int upload_requests(const SelectArgs* args, int n_req, bool modes,
                    cudaStream_t s, const SelectArgs** reqs) {
  if (n_req < 1 || n_req > kMaxRequests) return (int)cudaErrorInvalidValue;
  for (int r = 0; r < n_req; ++r) {
    if (args[r].n < 1 || args[r].n > INT32_MAX)
      return (int)cudaErrorInvalidValue;
    if (modes && (args[r].mode < HEAD_SUBMIT || args[r].mode > PREEMPT_HEAD))
      return (int)cudaErrorInvalidValue;
  }
  const void* dev = nullptr;
  const int bad = upload(args, (size_t)n_req * sizeof(SelectArgs), s, &dev);
  if (bad != 0) return bad;
  *reqs = static_cast<const SelectArgs*>(dev);
  return 0;
}

}  // namespace

// The TPU kernel's function.  scores: int32[n]; feasible: n entries of
// mask_bytes (1 = bool, 4 = int32); out: int32[2] on the device.  All on the
// device of `stream`.  Allocates nothing, does not synchronise, and returns
// the CUDA error code of the enqueue (0 = success).
extern "C" int queue_select_launch(const void* scores, const void* feasible,
                                   int mask_bytes, long long n, void* out,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > INT32_MAX || (mask_bytes != 1 && mask_bytes != 4))
    return (int)cudaErrorInvalidValue;
  const int32_t* sc = static_cast<const int32_t*>(scores);
  int32_t* o = static_cast<int32_t*>(out);
  if (mask_bytes == 1)
    select_generic<uint8_t><<<kCluster, kThreads, 0, s>>>(
        sc, static_cast<const uint8_t*>(feasible), n, o);
  else
    select_generic<int32_t><<<kCluster, kThreads, 0, s>>>(
        sc, static_cast<const int32_t*>(feasible), n, o);
  return (int)cudaGetLastError();
}

// One fused selection: launch, wait for `stream`, and leave (index, score)
// in result[0..1] on the host.  Returns a CUDA error code (0 = success).
extern "C" int queue_select_fused(const SelectArgs* args, void* stream,
                                  int32_t* result) {
  const SelectArgs a = *args;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.n < 1 || a.n > INT32_MAX) return (int)cudaErrorInvalidValue;
  auto launch = [&](int32_t* out) {
    switch (a.mode) {
      case HEAD_SUBMIT: launch_fused<HEAD_SUBMIT>(a, out, s); break;
      case HEAD_ESTIMATE: launch_fused<HEAD_ESTIMATE>(a, out, s); break;
      case HEAD_NEG_ESTIMATE: launch_fused<HEAD_NEG_ESTIMATE>(a, out, s); break;
      case BESTFIT: launch_fused<BESTFIT>(a, out, s); break;
      case ANY_FIT: launch_fused<ANY_FIT>(a, out, s); break;
      case BACKFILL_CAND: launch_fused<BACKFILL_CAND>(a, out, s); break;
      case PREEMPT_TIER: launch_fused<PREEMPT_TIER>(a, out, s); break;
      case PREEMPT_HEAD: launch_fused<PREEMPT_HEAD>(a, out, s); break;
    }
  };
  if (a.mode < HEAD_SUBMIT || a.mode > PREEMPT_HEAD)
    return (int)cudaErrorInvalidValue;
  return run_sync(launch, 2, 2, s, result);
}

// The EASY shadow walk for a head needing args->head_need nodes: launch,
// wait for `stream`, and leave (shadow, extra, k_row, releases counted) in
// result[0..3].
extern "C" int queue_select_walk(const SelectArgs* args, void* stream,
                                 int32_t* result) {
  const SelectArgs a = *args;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.n < 1 || a.n > INT32_MAX) return (int)cudaErrorInvalidValue;
  auto launch = [&](int32_t* out) {
    shadow_walk<<<kCluster, kThreads, 0, s>>>(a, out);
  };
  return run_sync(launch, 4, 4, s, result);
}

// n_req fused selections in one launch: args[r] is request r (columns and
// state offset to its member's row, its mode and scalars).  Waits for
// `stream` and leaves (index, score) in result[4 r], result[4 r + 1].
// Returns a CUDA error code; cudaErrorInvalidValue for a bad request.
extern "C" int queue_select_fused_batch(const SelectArgs* args, int n_req,
                                        void* stream, int32_t* result) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const SelectArgs* reqs = nullptr;
  const int bad = upload_requests(args, n_req, true, s, &reqs);
  if (bad != 0) return bad;
  auto launch = [&](int32_t* out) {
    select_fused_batch<<<n_req * kCluster, kThreads, 0, s>>>(reqs, out);
  };
  return run_sync(launch, 4 * n_req, 4, s, result);
}

// n_req shadow walks in one launch, as queue_select_fused_batch; leaves
// (shadow, extra, k_row, releases counted) in result[4 r .. 4 r + 3].
extern "C" int queue_select_walk_batch(const SelectArgs* args, int n_req,
                                       void* stream, int32_t* result) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const SelectArgs* reqs = nullptr;
  const int bad = upload_requests(args, n_req, false, s, &reqs);
  if (bad != 0) return bad;
  auto launch = [&](int32_t* out) {
    shadow_walk_batch<<<n_req * kCluster, kThreads, 0, s>>>(reqs, out);
  };
  return run_sync(launch, 4 * n_req, 4, s, result);
}

// The TPU kernel's function for n_req rows of a stacked [batch, n] score
// matrix and mask (mask_bytes 1 = bool, 4 = int32), all on the device of
// `stream`: members[r] (host memory) names request r's row.  The members are
// uploaded once, one launch of n_req clusters folds one row each; the call
// waits for `stream` and leaves (index, score) in result[2 r],
// result[2 r + 1] on the host, the index local to the row.  Returns a CUDA
// error code; cudaErrorInvalidValue for a bad size or member.
extern "C" int queue_select_batch(const void* scores, const void* feasible,
                                  int mask_bytes, long long n,
                                  long long batch, const int32_t* members,
                                  int n_req, void* stream, int32_t* result) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > INT32_MAX || batch < 1 || (mask_bytes != 1 &&
      mask_bytes != 4) || n_req < 1 || n_req > kMaxRequests)
    return (int)cudaErrorInvalidValue;
  for (int r = 0; r < n_req; ++r)
    if (members[r] < 0 || members[r] >= batch)
      return (int)cudaErrorInvalidValue;
  const void* dev = nullptr;
  const int bad = upload(members, (size_t)n_req * sizeof(int32_t), s, &dev);
  if (bad != 0) return bad;
  const int32_t* m = static_cast<const int32_t*>(dev);
  const int32_t* sc = static_cast<const int32_t*>(scores);
  auto launch = [&](int32_t* out) {
    if (mask_bytes == 1)
      select_generic_batch<uint8_t><<<n_req * kCluster, kThreads, 0, s>>>(
          sc, static_cast<const uint8_t*>(feasible), n, m, out);
    else
      select_generic_batch<int32_t><<<n_req * kCluster, kThreads, 0, s>>>(
          sc, static_cast<const int32_t*>(feasible), n, m, out);
  };
  return run_sync(launch, 2 * n_req, 2, s, result);
}
