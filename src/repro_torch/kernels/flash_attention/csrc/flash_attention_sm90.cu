// flash_attention_sm90: bf16 GQA attention forward on Hopper's tensor cores.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::_flash_kernel
// (kernel.py:27, launched by flash_attention_grouped) for bf16 inputs; f32
// inputs stay on the CUDA-core kernel of flash_attention.cu.  It computes what
// repro_torch/kernels/flash_attention/ref.py computes for q [B, Sq, H, hd] and
// k, v [B, Sk, KV, hd] in bf16: softmax(q k^T * hd^-0.5 + mask) v with causal,
// sliding-window (q_pos - k_pos < window) and q_offset masks, for head dims
// 32, 64, 80 and 128 and any G = H / KV.  The numerics are the TPU kernel's:
// masked scores are the finite -1e30, the running (m, l, acc) are f32, the
// softmax runs on exp2 of scores in log2 units, and the result is
// acc / max(l, 1e-30), stored as bf16.  The factor hd^-0.5 * log2 e
// multiplies the f32 scores of q k^T (on interior tiles inside the FFMA that
// feeds exp2) rather than bf16 q, which it would round a second time.  exp2
// is ex2.approx.ftz, the instruction exp2f becomes under fast math; the two
// differ only on results below 2^-126, which no row sum can feel.  One
// numerical change: P is rounded to bf16 before the P V product, which runs
// on the tensor cores (l sums the f32 P).  A row whose first keys are all
// masked accumulates p = 1 for them, and the first live key's
// alpha = exp2(-1e30 - m) = 0 wipes that out, as on the TPU.
//
// Bound.  At the serve shape (B 4, Sq = Sk = 2,048, H 24, KV 8, hd 128, bf16,
// causal) a launch does 4 hd flops for each of the 4 * 24 * 2048 * 2049 / 2
// visible (query, key) pairs: 1.031e11 flop, 0.104 ms at the card's 989
// TFLOP/s for bf16 on the tensor cores; it moves 134,217,728 B (q, k, v read
// once, out written once), 0.040 ms at 3.35 TB/s.  So it is bound by
// operations, and only the tensor cores can approach it: the f32 kernel's
// CUDA-core FMAs alone would take 1.54 ms at 67 TFLOP/s.
//
// Design (after FlashAttention-3, written for this card rather than carried
// over from the Pallas grid).  One CTA per (query tile of 128 rows, query
// head, batch), started heaviest causal tile first, with the G query heads of
// one KV head next to each other in launch order.  Three warpgroups:
//  - a producer, whose one elected thread issues every TMA load and which
//    gives its registers up (setmaxnreg.dec);
//  - two consumers of 64 query rows each (setmaxnreg.inc).
// Q is loaded once by TMA; K and V tiles of 128 keys go through a ring of
// kStages = 2 stages, each with a full and an empty mbarrier for K and for
// V, and K is loaded one tile ahead of V, in the order the consumers free
// them.  The tiles land 128B-swizzled in boxes of 64 columns (128 bytes);
// head dims 80 and 32 are padded to 128 and 64 in shared memory by the
// TMA's zero fill, as are keys >= Sk and queries >= Sq: the wrapper pads and
// copies nothing.  At hd 128: Q 32 KB + 2 x (32 + 32) KB = 160 KB of
// shared memory, one CTA an SM.
//  - S = Q K^T is wgmma m64n128k16 with A and B from shared-memory
//    descriptors (K-major, 128B swizzle), f32 in registers.
//  - The online softmax runs on the accumulator fragment: row max by quad
//    shuffles, acc rescaled by exp2(m_old - m_new), and l kept per thread
//    and summed across the quad once at the end.  The -1e30 mask is applied
//    only on KV tiles that cross the causal diagonal, the window's edge or
//    Sk; interior tiles take the unmasked path.
//  - O += P V is wgmma with P converted to bf16 in registers as the A
//    operand (the f32 accumulator layout of S is the A-fragment layout of a
//    k16 step: registers 8t..8t+7 of S are keys 16t..16t+15) and V from
//    shared memory with the transpose bit (V is [key][hd], contiguous along
//    N).
//  - The two consumers take turns issuing their products (ping-pong on two
//    named barriers), and each issues S of tile i together with P V of tile
//    i - 1, so the softmax of one warpgroup runs while the tensor cores
//    work for the other and for its own previous tile.
// GQA: the G query heads of one KV head read the same K/V tiles through L2
// (all of K and V at the serve shape is 33.5 MB, under the 50 MB L2).  This
// replaces the TPU kernel's GQA-in-the-grid schedule, which existed to save
// HBM -> VMEM traffic.  Tile skip: KV tiles that no live row of the CTA sees
// are never loaded; the first and last tile come from causal, window and
// q_offset, and the mask test per tile is the one of
// repro_torch/kernels/flash_attention/ops.py::_kv_tile_plan, which the CPU
// tests hold to a brute-force mask.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 128;     // query rows per CTA, 64 per consumer
constexpr int kBlockK = 128;     // keys per K/V tile
constexpr int kStages = 2;       // K/V ring depth
constexpr int kThreads = 384;    // producer + two consumer warpgroups
constexpr int kBox = 64;         // TMA box columns: the 128B swizzle's width
constexpr int kBoxBytes = kBlockK * kBox * 2;   // one box of a tile, 16 KB
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;  // 40 + 2 x 232 = 3 x 168, what a CTA gets
constexpr float kNegInf = -1e30f;

static_assert(kBlockQ == kBlockK, "Q, K and V tiles share one box layout");

template <int HD>
struct Tile {
  static constexpr int kPad = HD <= 64 ? 64 : 128;   // hd in shared memory
  static constexpr int kBoxes = kPad / kBox;
  static constexpr int kBytes = kBoxes * kBoxBytes;  // one Q, K or V tile
  // Q, then kStages K tiles, then kStages V tiles, then the barriers
  static constexpr int kBarriers = kBytes * (1 + 2 * kStages);
  static constexpr int kSmem = kBarriers + 8 * (1 + 4 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// one box (64 columns x 1 head x 128 rows x 1 batch) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor, 128B swizzle; offsets in bytes
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32)
         | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups of wgmma are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// keep the compiler from moving reads or writes of wgmma's registers across
// the asynchronous product
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// S = Q K^T for one warpgroup: A and B from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
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
      : "l"(a), "l"(b), "r"(scale_d));
}

// O += P V for one warpgroup: A (P, bf16) from registers, B (V) from shared
// memory with the transpose bit, since V is [key][hd], contiguous along N
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O += P V for one warpgroup: A (P, bf16) from registers, B (V) from shared
// memory with the transpose bit, since V is [key][hd], contiguous along N
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a,
                                             uint64_t b) {
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
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t* a,
                                         uint64_t b) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, b);
  else wgmma_rs_n128(d, a, b);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit: the instruction exp2f compiles to under
// fast math, which differs from exp2f only on results below 2^-126
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One tile's online softmax on the S fragment, in place: scores in log2
// units (s * scale), masked to -1e30 where the tile needs it, the running
// maxima updated, and exp2(s * scale - m) left in s.  s[4j + e] is row
// (e & 2 ? 1 : 0) of the thread's two rows, key k0 + 8j + 2 quad + (e & 1).
// Returns the rescale factors of the old maxima and the thread's partial
// row sums.  An interior tile takes the max of the raw scores (scale > 0)
// and folds the scale into one FFMA per score.
__device__ __forceinline__ void softmax_tile(
    float (&s)[64], float& m0, float& m1, float& a0, float& a1, float& ps0,
    float& ps1, bool interior, long long k0, int quad, long long pos0,
    long long pos1, int Sk, int causal, int window, float scale) {
  float f = scale;   // what multiplies s in the exponent
  if (!interior) {
#pragma unroll
    for (int e = 0; e < 64; ++e) {
      const long long key = k0 + 8 * (e / 4) + 2 * quad + (e & 1);
      const long long pos = (e & 2) ? pos1 : pos0;
      const bool ok = key < Sk && (!causal || key <= pos)
                      && (window <= 0 || pos - key < window);
      s[e] = ok ? s[e] * scale : kNegInf;
    }
    f = 1.f;
  }
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    if (e & 2) mx1 = fmaxf(mx1, s[e]);
    else mx0 = fmaxf(mx0, s[e]);
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  mx0 = fmaxf(m0, mx0 * f);
  mx1 = fmaxf(m1, mx1 * f);
  a0 = exp2_fast(m0 - mx0);
  a1 = exp2_fast(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  ps0 = 0.f;
  ps1 = 0.f;
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    if (e & 2) {
      s[e] = exp2_fast(fmaf(s[e], f, -mx1));
      ps1 += s[e];
    } else {
      s[e] = exp2_fast(fmaf(s[e], f, -mx0));
      ps0 += s[e];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               __nv_bfloat16* __restrict__ out, int B, int Sq, int Sk, int H,
               int KV, int causal, int window, long long q_offset,
               float scale) {
  using T = Tile<HD>;
  constexpr int kPad = T::kPad;
  extern __shared__ uint8_t smem_raw[];
  // the 128B swizzle repeats every 1,024 bytes: tiles start on that grain
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t bars = base + T::kBarriers;
  const uint32_t q_full = bars;
  auto k_tile = [&](int s) { return base + (1 + s) * T::kBytes; };
  auto v_tile = [&](int s) { return base + (1 + kStages + s) * T::kBytes; };
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto k_empty = [&](int s) { return bars + 8 * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bars + 8 * (1 + 3 * kStages + s); };

  // this CTA's tile: query tiles in reverse (the causal tiles with the most
  // keys first), then batch, then head fastest, so the G heads of one KV
  // head run side by side and share its K/V through L2
  const int n_qt = (Sq + kBlockQ - 1) / kBlockQ;
  const int bh = B * H;
  const int qt = n_qt - 1 - (int)(blockIdx.x / bh);
  const int b = (int)(blockIdx.x % bh) / H;
  const int h = (int)(blockIdx.x % bh) % H;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBlockQ;

  // the KV tiles some live row of the CTA sees, and which of them need the
  // mask: ops.py::_kv_tile_plan computes the same
  const long long first_pos = q_offset + q0;
  const long long last_pos = q_offset + min(q0 + kBlockQ, Sq) - 1;
  const long long k_end = causal ? min((long long)Sk, last_pos + 1)
                                 : (long long)Sk;
  const long long k_begin = window > 0 ? max(0LL, first_pos - window + 1)
                                       : 0LL;
  const int t_lo = (int)(k_begin / kBlockK);
  const int t_hi = k_end > k_begin ? (int)((k_end + kBlockK - 1) / kBlockK)
                                   : t_lo;
  const int n = t_hi - t_lo;
  if (n == 0) {
    // no live row sees a key (the wrapper refuses such inputs): zeros
    for (int r = threadIdx.x; r < kBlockQ * HD; r += kThreads) {
      const int row = q0 + r / HD;
      if (row < Sq)
        out[((size_t)b * Sq + row) * H * HD + (size_t)h * HD + r % HD] =
            __float2bfloat16(0.f);
    }
    return;
  }

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 2 * 128);   // every consumer thread arrives
      mbar_init(v_empty(s), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, T::kBytes);
#pragma unroll
      for (int c = 0; c < T::kBoxes; ++c)
        tma_load(q_s + c * kBoxBytes, &qmap, q_full, c * kBox, h, q0, b);
      // K runs one tile ahead of V: turn i of a consumer needs K of tile i
      // and V of tile i - 1, and frees them in that order
      auto load = [&](uint32_t tile, uint32_t full, uint32_t empty_bar,
                      uint32_t free_par, const CUtensorMap* map, int i) {
        mbar_wait(empty_bar, free_par);
        mbar_expect_tx(full, T::kBytes);
#pragma unroll
        for (int c = 0; c < T::kBoxes; ++c)
          tma_load(tile + c * kBoxBytes, map, full, c * kBox, kvh,
                   (t_lo + i) * kBlockK, b);
      };
      for (int i = 0; i <= n; ++i) {
        // each stage's previous round must be released (first round: free)
        if (i < n) {
          const int s = i % kStages;
          load(k_tile(s), k_full(s), k_empty(s), ((i / kStages) & 1) ^ 1,
               &kmap, i);
        }
        if (i > 0) {
          const int s = (i - 1) % kStages;
          load(v_tile(s), v_full(s), v_empty(s),
               (((i - 1) / kStages) & 1) ^ 1, &vmap, i - 1);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kConsumerRegs));
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int quad = lane % 4;
    // this thread's two rows of the accumulator fragments: row0, row0 + 8
    const int row0 = q0 + 64 * cw + 16 * warp + lane / 4;
    const long long pos0 = q_offset + row0, pos1 = pos0 + 8;
    const uint32_t q_rows = q_s + cw * 64 * 128;   // this warpgroup's 64 rows

    float s[64];          // scores, 64 rows x 128 keys
    float o[kPad / 2];    // output accumulator, 64 rows x kPad
    uint32_t p[32];       // P in bf16: the A fragments of 8 k16 steps
#pragma unroll
    for (int e = 0; e < 64; ++e) s[e] = 0.f;
#pragma unroll
    for (int e = 0; e < kPad / 2; ++e) o[e] = 0.f;
#pragma unroll
    for (int e = 0; e < 32; ++e) p[e] = 0u;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

    // The two consumers take turns on the tensor cores (named barriers 1
    // and 2, after FlashAttention-3's ping-pong): one issues its products
    // while the other runs its softmax.  Turn i issues S of tile i and
    // O += P V of tile i - 1, so that within a warpgroup the softmax of
    // tile i also overlaps the P V product of tile i - 1.  Each warpgroup
    // takes n + 1 turns: the first (S only), n - 1 full ones, the last (P V
    // only).  Consumer 0 goes first, and consumer 1 hands over after every
    // turn but its last, so both barriers end balanced.  No wgmma sits
    // under a branch: ptxas serializes those.
    auto turn = [&]() {
      named_bar_sync(1 + cw, 256);
      fence_regs(s);
      fence_regs(o);
      wgmma_fence();
    };
    auto issue_s = [&](int st) {
      // S = Q K^T: kPad / 16 steps of k16, four per 64-column box
      const uint32_t ks = k_tile(st);
#pragma unroll
      for (int kk = 0; kk < kPad / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        wgmma_ss_n128(s, smem_desc(q_rows + off, 16, 1024),
                      smem_desc(ks + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    auto issue_pv = [&](int st) {
      // O += P V: 8 steps of 16 keys; V's rows 16 kk.. start 2,048 B
      // apart, its 64-column boxes kBoxBytes apart (the descriptor's LBO)
      const uint32_t vs = v_tile(st);
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk)
        wgmma_rs<kPad>(o, p + 4 * kk,
                       smem_desc(vs + kk * 16 * 128, kBoxBytes, 1024));
      wgmma_commit();
    };
    // after S of tile i is done: free K, softmax, and return the factors
    auto softmax = [&](int i, int st, float& a0, float& a1, float& ps0,
                       float& ps1) {
      fence_regs(s);
      mbar_arrive(k_empty(st));
      const long long k0 = (long long)(t_lo + i) * kBlockK;
      const bool interior = k0 + kBlockK <= Sk
          && (!causal || k0 + kBlockK - 1 <= first_pos)
          && (window <= 0 || last_pos - k0 < window);
      softmax_tile(s, m0, m1, a0, a1, ps0, ps1, interior, k0, quad, pos0,
                   pos1, Sk, causal, window, scale);
    };
    // after P V of the previous tile is done: rescale O, make the next P
    auto rescale = [&](float a0, float a1, float ps0, float ps1) {
      l0 = l0 * a0 + ps0;
      l1 = l1 * a1 + ps1;
#pragma unroll
      for (int e = 0; e < kPad / 2; ++e) o[e] *= (e & 2) ? a1 : a0;
#pragma unroll
      for (int e = 0; e < 32; ++e) p[e] = pack_bf16(s[2 * e], s[2 * e + 1]);
    };
    float a0, a1, ps0, ps1;

    if (cw == 1) named_bar_arrive(1, 256);
    mbar_wait(q_full, 0);
    mbar_wait(k_full(0), 0);
    turn();                                   // turn 0: S of tile 0
    issue_s(0);
    named_bar_arrive(2 - cw, 256);
    wgmma_wait<0>();
    softmax(0, 0, a0, a1, ps0, ps1);
    rescale(a0, a1, ps0, ps1);
    for (int i = 1; i < n; ++i) {             // turns 1 .. n - 1
      const int st = i % kStages, pst = (i - 1) % kStages;
      mbar_wait(k_full(st), (i / kStages) & 1);
      mbar_wait(v_full(pst), ((i - 1) / kStages) & 1);
      turn();
      issue_s(st);
      issue_pv(pst);
      named_bar_arrive(2 - cw, 256);
      wgmma_wait<1>();                        // S is done, P V may run on
      softmax(i, st, a0, a1, ps0, ps1);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      mbar_arrive(v_empty(pst));
      rescale(a0, a1, ps0, ps1);
    }
    const int lst = (n - 1) % kStages;        // turn n: P V of tile n - 1
    mbar_wait(v_full(lst), ((n - 1) / kStages) & 1);
    turn();
    issue_pv(lst);
    if (cw == 0) named_bar_arrive(2, 256);
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(v_empty(lst));

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    const size_t row_stride = (size_t)H * HD;
    __nv_bfloat16* o0 = out + ((size_t)b * Sq + row0) * row_stride
                        + (size_t)h * HD + 2 * quad;
    __nv_bfloat16* o1 = o0 + 8 * row_stride;
#pragma unroll
    for (int j = 0; j < kPad / 8; ++j) {
      if (8 * j < HD) {
        if (row0 < Sq)
          *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j) =
              __floats2bfloat162_rn(o[4 * j] / d0, o[4 * j + 1] / d0);
        if (row0 + 8 < Sq)
          *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * j) =
              __floats2bfloat162_rn(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
      }
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

constexpr int kErrNoEncoder = 900;    // returned when the driver lacks TMA
constexpr int kErrEncode = 1000;      // + the CUresult of a refused map

// a 4-D map (hd, heads, S, B) of bf16 with element strides (1, head, seq,
// batch): boxes of 64 columns x 1 head x 128 rows x 1 batch, 128B swizzle,
// out-of-range elements read as zeros
int make_map(CUtensorMap* map, const void* ptr, int hd, int heads, int S,
             int B, long long s_head, long long s_seq, long long s_batch) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s_head * 2,
                                 (cuuint64_t)s_seq * 2,
                                 (cuuint64_t)s_batch * 2};
  const cuuint32_t box[4] = {kBox, 1, kBlockK, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + (int)r;
}

template <int HD>
int launch(const CUtensorMap& qm, const CUtensorMap& km,
           const CUtensorMap& vm, void* out, int B, int Sq, int Sk, int H,
           int KV, int causal, int window, long long q_offset, float scale,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tile<HD>::kSmem);
  if (err != cudaSuccess) return (int)err;
  const long long ctas = (long long)((Sq + kBlockQ - 1) / kBlockQ) * B * H;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_fwd_sm90<HD><<<(unsigned)ctas, kThreads, Tile<HD>::kSmem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), B, Sq, Sk, H, KV, causal,
      window, q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dynamic shared memory of one CTA at head dim hd (0 for another hd)
extern "C" int flash_attention_sm90_smem_bytes(int hd) {
  switch (hd) {
    case 32: return Tile<32>::kSmem;
    case 64: return Tile<64>::kSmem;
    case 80: return Tile<80>::kSmem;
    case 128: return Tile<128>::kSmem;
    default: return 0;
  }
}

// q [B, Sq, H, hd], k and v [B, Sk, KV, hd], bf16, each with a contiguous
// last dim and element strides (batch, seq, head) = qs[0..2], ks, vs; the
// TMA needs 16-byte aligned bases and strides of a multiple of 16 bytes.
// out: [B, Sq, H, hd] contiguous bf16.  window <= 0 means none; scale is
// hd^-0.5 * log2(e).  Allocates nothing, does not synchronise, and returns 0,
// the CUDA error code of the enqueue, kErrNoEncoder or kErrEncode + the
// driver's CUresult.
extern "C" int flash_attention_sm90_launch(
    const void* q, const void* k, const void* v, void* out, int B, int Sq,
    int Sk, int H, int KV, int hd, const long long* qs, const long long* ks,
    const long long* vs, int causal, int window, long long q_offset,
    float scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  int err = make_map(&qm, q, hd, H, Sq, B, qs[2], qs[1], qs[0]);
  if (err == 0) err = make_map(&km, k, hd, KV, Sk, B, ks[2], ks[1], ks[0]);
  if (err == 0) err = make_map(&vm, v, hd, KV, Sk, B, vs[2], vs[1], vs[0]);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch<32>(qm, km, vm, out, B, Sq, Sk, H, KV, causal, window,
                        q_offset, scale, s);
    case 64:
      return launch<64>(qm, km, vm, out, B, Sq, Sk, H, KV, causal, window,
                        q_offset, scale, s);
    case 80:
      return launch<80>(qm, km, vm, out, B, Sq, Sk, H, KV, causal, window,
                        q_offset, scale, s);
    case 128:
      return launch<128>(qm, km, vm, out, B, Sq, Sk, H, KV, causal, window,
                         q_offset, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
