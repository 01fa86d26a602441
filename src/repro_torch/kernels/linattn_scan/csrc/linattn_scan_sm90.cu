// linattn_scan_sm90: bf16 RWKV6 "WKV" linear attention on Hopper's tensor cores.
//
// Replaces the TPU kernel repro/kernels/linattn_scan/kernel.py::_linattn_kernel
// (kernel.py:23, launched by linattn_grouped) for bf16 r, k, v with K = 64 or
// 128; f32 inputs and K 16/32 stay on the CUDA-core kernel of linattn_scan.cu.
// For r, k, v [B, H, S, K] in bf16, logw [B, H, S, K] in f32 or bf16 (< 0)
// and u [H, K] in f32 it computes what repro_torch/kernels/linattn_scan/ref.py
// computes token by token,
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T          w_t = exp(logw_t)
//     y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T),
// y in bf16 and the final state [B, H, K, K] in f32, key axis first.
// ref.py::linattn_sm90_reference states the same arithmetic in PyTorch,
// rounded where this kernel rounds; the CPU tests hold it to the JAX package.
//
// Design.  One CTA per (batch, head), one warpgroup per 64 value columns (1
// at K = 64, 2 at K = 128), walking the time axis in chunks of 64 steps with
// the f32 state in wgmma accumulator registers from the first chunk to the
// last (each warpgroup holds the K x 64 slab of its value columns).  Chunks
// arrive by TMA into a ring of 2 stages: r, k, v as 128B-swizzled boxes of
// 64 x 64 bf16 and logw as a dense [64][K] box.  TMA's zero fill past S gives
// r = k = v = 0 and logw = 0 there, which leaves the state unchanged; no y is
// written past S.  Within a chunk, in log2 units (log2 e folded in once):
//   P[0] = 0, P[t + 1] = E[t] = sum_{j<=t} logw_j, so Eex[t] = P[t];
//   the chunk is 4 sub-chunks of 16 steps, e_j = 16 j + 15 the last step of
//   sub-chunk j.  Pairs (t, s) in sub-chunks i > j factor through e_j:
//     exp2(Eex[t] - E[s]) = exp2(Eex[t] - E[e_j]) * exp2(E[e_j] - E[s]),
//   both exponents <= 0, so R_j[t] = r[t] exp2(Eex[t] - E[e_j]) and
//   K_j[s] = k[s] exp2(E[e_j] - E[s]) are bounded by |r| and |k|, and
//   A[i-block, j-block] = R_j K_j^T is one wgmma m64n16 per j (rows of
//   sub-chunks <= j are zero).  Factoring through the source sub-chunk's last
//   step, not the target's first, makes R_j one operand for every target
//   sub-chunk, so each j is one product.
//   Pairs s < t inside a sub-chunk are exact in log space on the CUDA cores,
//   one exp2 per (t, s, channel), plus the bonus r u k at s = t.  Neither
//   exp(+E) nor exp(-E) is formed alone: every exponent is <= 0, for any
//   decay, and a factor that underflows to 0 is the true value's rounding.
//   Then, on the tensor cores, with A operands built in registers:
//     y  = (r exp2(Eex)) S_prev     S_prev copied to shared memory in bf16
//     y += A V                      A in bf16 (the accumulator layout of the
//                                   m64n16 products is the A-fragment layout)
//     S  = exp2(E[63]) S + hi^T V + lo^T V,   kw = k exp2(E[63] - E) in f32,
//          hi = bf16(kw), lo = bf16(kw - hi): two products into one f32
//          accumulator, so the state keeps ~2^-17 of kw, not bf16's 2^-9
//          (v is exact in bf16: it is a bf16 input).
//
// Bound.  At the serve shape (B 4, H 64, S 2,048, K 64, bf16 r/k/v/y, f32
// logw) a launch moves 406,863,872 B (inputs read once, y and the state
// written once), 0.121 ms at 3.35 TB/s; the recurrence's least arithmetic, 4
// K^2 flops a step and head, is 8.59e9 flop, under 0.01 ms at the 989
// TFLOP/s bf16 tensor-core rate that runs this kernel's products, so bytes
// bound it (0.128 ms at the f32 rate outside the tensor cores, which bounds
// the CUDA-core kernel of linattn_scan.cu).  What stays on the CUDA cores is
// the exact diagonal sub-blocks (120 pairs x K keys per 16 steps, one exp2
// and three FP32 instructions each), the factors' exp2 and the prefix sums;
// the diagonal blocks are the largest phase, paced by their shared-memory
// reads, so each thread keeps the r and Eex rows of its two rows in
// registers and reads only k and E per pair.  256 CTAs (B H) at two an SM
// fill one wave; the per-(batch, head) chain's latency is hidden only by the
// other CTA on the SM, so the shared memory stays under half an SM's
// (108,304 B at K = 64).
//
// Phases of a chunk, separated by CTA barriers: the prefix sums; the K_j
// tiles and the diagonal blocks (every thread); the products, one group of
// y = (r exp2(Eex)) S_prev and the three cross products (A fragments built
// in registers first), with the state update's kw fragments built while it
// runs; then one group of y += A V and the state update.  No wgmma sits
// under a runtime branch (ptxas would serialize it).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;              // steps per chunk: the m64 of the products
constexpr int kSub = 16;                // steps per sub-chunk
constexpr int kNSub = kChunk / kSub;    // 4
constexpr int kStages = 2;              // TMA ring depth
constexpr int kBoxBytes = 64 * 128;     // one 64-row x 64-column bf16 box
constexpr float kLog2e = 1.4426950408889634f;

// shared memory layout at K, offsets in bytes from a 1,024-aligned base
template <int K>
struct Lay {
  static constexpr int kWG = K / 64;                 // warpgroups
  static constexpr int kThreads = 128 * kWG;         // = 2 K
  static constexpr int kTile = kChunk * K * 2;       // bf16 [64][K]: K/64 boxes
  static constexpr int kPitch = K + 4;               // floats a row of P
  static constexpr int kPBytes = ((kChunk + 1) * kPitch * 4 + 1023) / 1024 * 1024;
  // a stage: r, k, v tiles, then logw (raw, dense) overwritten by P
  static constexpr int kR = 0, kK = kTile, kV = 2 * kTile, kP = 3 * kTile;
  static constexpr int kStage = 3 * kTile + kPBytes;
  static constexpr int kK2 = kStages * kStage;       // K_j tiles, bf16 [64][K]
  static constexpr int kS = kK2 + kTile;             // S in bf16, [K][K]
  static constexpr int kSBox = K * 128;              // K rows x 64 columns
  static constexpr int kDiag = kS + K * K * 2;       // f32 [4][16][16]
  static constexpr int kTot = kDiag + kNSub * kSub * kSub * 4;   // f32 [2][K]
  static constexpr int kU = kTot + 2 * K * 4;        // f32 [K]
  static constexpr int kBar = kU + K * 4;            // kStages mbarriers
  static constexpr int kSmem = kBar + 8 * kStages + 1024;
  static_assert(kThreads == 2 * K, "the diagonal and scan phases take 2 K threads");
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

// one box of (columns, 64 steps, 1 head, 1 batch) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int t, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(col), "r"(t), "r"(h), "r"(b)
      : "memory");
}

// generic-proxy writes of shared memory become visible to wgmma and TMA
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e]) :: "memory");
}

// d (+)= A B: A (bf16) from registers, B a [16 k][64 n] bf16 tile contiguous
// along N (the transpose bit), 64 x 64 f32 accumulator
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t b, int scale_d) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (+)= A B^T: A (bf16) from registers, B a [16 n][16 k] bf16 tile contiguous
// along K (no transpose), 64 x 16 f32 accumulator
__device__ __forceinline__ void wgmma_n16(float (&d)[8], const uint32_t (&a)[4],
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit (x <= 0 everywhere here; results below
// 2^-126 flush to 0, the rounding of a factor that small)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// byte offset of element (row, col) of a bf16 tile stored as boxes of 64
// columns (box_bytes apart), 128 bytes a row, 128B-swizzled as TMA lays it
__device__ __forceinline__ uint32_t swz(int row, int col, int box_bytes) {
  return (uint32_t)((col >> 6) * box_bytes + row * 128
                    + ((((col & 63) >> 3) ^ (row & 7)) << 4) + ((col & 7) << 1));
}

__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// elements (row, col) and (row, col + 1) of a swizzled tile of 64-row boxes
__device__ __forceinline__ float2 ld2(const uint8_t* tile, int row, int col) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(tile + swz(row, col, kBoxBytes));
  return make_float2(bf_lo(w), bf_hi(w));
}

// elements (row, 16 q .. 16 q + 15) of a swizzled tile of 64-row boxes, as
// f32: two 16-byte loads, the second chunk's index the first's with bit 0
// flipped
__device__ __forceinline__ void ld16(const uint8_t* tile, int row, int q,
                                     float (&o)[16]) {
  const uint32_t a = swz(row, 16 * q, kBoxBytes);
  const uint4 w0 = *reinterpret_cast<const uint4*>(tile + a);
  const uint4 w1 = *reinterpret_cast<const uint4*>(tile + (a ^ 16u));
  const uint32_t w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    o[2 * i] = bf_lo(w[i]);
    o[2 * i + 1] = bf_hi(w[i]);
  }
}

__device__ __forceinline__ float ldlw(const float* p) { return *p; }
__device__ __forceinline__ float ldlw(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <int K, typename LW>
__global__ void __launch_bounds__(Lay<K>::kThreads, 1)
linattn_fwd_sm90(const __grid_constant__ CUtensorMap rmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap wmap,
                 const float* __restrict__ u, __nv_bfloat16* __restrict__ y,
                 float* __restrict__ state_out, int H, int S,
                 long long ys_b, long long ys_h, long long ys_t) {
  using L = Lay<K>;
  constexpr int NT = L::kThreads;
  constexpr int kPitch = L::kPitch;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base_u = smem_u32(base);
  uint8_t* k2 = base + L::kK2;
  uint8_t* sb = base + L::kS;
  float* diag = reinterpret_cast<float*>(base + L::kDiag);
  float* tot = reinterpret_cast<float*>(base + L::kTot);
  float* us = reinterpret_cast<float*>(base + L::kU);
  const uint32_t bars = base_u + L::kBar;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int nc = (S + kChunk - 1) / kChunk;
  constexpr uint32_t kTx = 3 * L::kTile + kChunk * K * (uint32_t)sizeof(LW);

  auto issue = [&](int c) {   // TMA of chunk c into stage c % 2
    const int s = c % kStages;
    const uint32_t st = base_u + s * L::kStage;
    const uint32_t bar = bars + 8 * s;
    mbar_expect_tx(bar, kTx);
#pragma unroll
    for (int x = 0; x < K / 64; ++x) {
      tma_load(st + L::kR + x * kBoxBytes, &rmap, bar, 64 * x, c * kChunk, h, b);
      tma_load(st + L::kK + x * kBoxBytes, &kmap, bar, 64 * x, c * kChunk, h, b);
      tma_load(st + L::kV + x * kBoxBytes, &vmap, bar, 64 * x, c * kChunk, h, b);
    }
    tma_load(st + L::kP, &wmap, bar, 0, c * kChunk, h, b);
  };

  for (int i = tid; i < K * K / 2; i += NT)
    reinterpret_cast<uint32_t*>(sb)[i] = 0u;           // S_prev = 0
  for (int i = tid; i < kNSub * kSub * kSub; i += NT) diag[i] = 0.f;
  for (int i = tid; i < K; i += NT) us[i] = u[h * K + i];
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    issue(0);
    if (nc > 1) issue(1);
  }

  // this thread's place in its warpgroup's fragments
  const int wg = tid / 128;              // value columns 64 wg .. 64 wg + 63
  const int warp = (tid % 128) / 32;     // rows 16 warp .. : sub-chunk `warp`
  const int lane = tid % 32;
  const int quad = lane % 4, lr = lane / 4;
  const int ra = 16 * warp + lr, rb = ra + 8;   // the thread's two rows

  float sacc[K / 64][32];                // S: keys 64 m + ., value cols of wg
#pragma unroll
  for (int m = 0; m < K / 64; ++m)
#pragma unroll
    for (int e = 0; e < 32; ++e) sacc[m][e] = 0.f;
  fence_async_smem();
  __syncthreads();   // the barrier init and the zero fills are visible

  for (int c = 0; c < nc; ++c) {
    const int s = c % kStages;
    uint8_t* st = base + s * L::kStage;
    const uint8_t* rt = st + L::kR;
    const uint8_t* kt = st + L::kK;
    const uint32_t vt = base_u + s * L::kStage + L::kV;
    float* P = reinterpret_cast<float*>(st + L::kP);
    mbar_wait(bars + 8 * s, (c / kStages) & 1);

    // 1. P = prefix sums of logw in log2 units: thread (channel, half) sums
    // 32 steps; the second half adds the first half's total
    {
      const int ch = tid % K, half = tid / K;
      const LW* raw = reinterpret_cast<const LW*>(P);
      float e[kChunk / 2];
      float run = 0.f;
#pragma unroll
      for (int j = 0; j < kChunk / 2; ++j) {
        run += ldlw(raw + (half * (kChunk / 2) + j) * K + ch);
        e[j] = run;
      }
      tot[half * K + ch] = run;
      __syncthreads();   // every raw logw is read: P may overwrite them
      const float off = half ? tot[ch] : 0.f;
#pragma unroll
      for (int j = 0; j < kChunk / 2; ++j)
        P[(half * (kChunk / 2) + j + 1) * kPitch + ch] = (off + e[j]) * kLog2e;
      if (half == 0) P[ch] = 0.f;
    }
    __syncthreads();

    // 2a. K_j[s] = k[s] exp2(E[e_j] - E[s]) for s in sub-chunk j < 3
    for (int i = tid; i < (kNSub - 1) * kSub * K / 2; i += NT) {
      const int row = i / (K / 2), col = 2 * (i % (K / 2));
      const float2 pe = *reinterpret_cast<const float2*>(
          P + (row / kSub * kSub + kSub) * kPitch + col);
      const float2 ps = *reinterpret_cast<const float2*>(P + (row + 1) * kPitch + col);
      const float2 kk = ld2(kt, row, col);
      *reinterpret_cast<uint32_t*>(k2 + swz(row, col, kBoxBytes)) =
          pack_bf16(kk.x * exp2_fast(pe.x - ps.x), kk.y * exp2_fast(pe.y - ps.y));
    }

    // 2b. the diagonal sub-blocks, exact: thread (block, row pair p, key
    // slice q) takes the 15 pairs of rows p and 15 - p over 16 keys, with r
    // and Eex of both rows in registers and k and E of each pair's second
    // row read from shared memory
    {
      constexpr int NQ = K / 16;
      const int q = tid % NQ, p = (tid / NQ) % 8, blk = tid / (NQ * 8);
      const int ta = kSub * blk + p, tb = kSub * blk + 15 - p;
      const float* uq = us + 16 * q;
      float r_a[16], r_b[16], x_a[16], x_b[16], acc[15];
      ld16(rt, ta, q, r_a);
      ld16(rt, tb, q, r_b);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float4 xa = *reinterpret_cast<const float4*>(P + ta * kPitch + 16 * q + 4 * g);
        const float4 xb = *reinterpret_cast<const float4*>(P + tb * kPitch + 16 * q + 4 * g);
        x_a[4 * g] = xa.x; x_a[4 * g + 1] = xa.y; x_a[4 * g + 2] = xa.z; x_a[4 * g + 3] = xa.w;
        x_b[4 * g] = xb.x; x_b[4 * g + 1] = xb.y; x_b[4 * g + 2] = xb.z; x_b[4 * g + 3] = xb.w;
      }
      // the bonus r u k of rows ta and tb
      float bon_a = 0.f, bon_b = 0.f;
      {
        float k_a[16], k_b[16];
        ld16(kt, ta, q, k_a);
        ld16(kt, tb, q, k_b);
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          bon_a = fmaf(r_a[e] * uq[e], k_a[e], bon_a);
          bon_b = fmaf(r_b[e] * uq[e], k_b[e], bon_b);
        }
      }
#pragma unroll
      for (int m = 0; m < 15; ++m) {
        const bool on_a = m < p;
        const int sr = kSub * blk + (on_a ? m : m - p);
        float kk[16];
        ld16(kt, sr, q, kk);
        const float4* es = reinterpret_cast<const float4*>(P + (sr + 1) * kPitch + 16 * q);
        float a[4] = {0.f, 0.f, 0.f, 0.f};   // four short chains
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float4 e4 = es[g];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int e = 4 * g + i;
            const float ee = i == 0 ? e4.x : i == 1 ? e4.y : i == 2 ? e4.z : e4.w;
            const float rr = on_a ? r_a[e] : r_b[e];
            const float xx = on_a ? x_a[e] : x_b[e];
            a[i] = fmaf(rr * kk[e], exp2_fast(xx - ee), a[i]);
          }
        }
        acc[m] = (a[0] + a[1]) + (a[2] + a[3]);
      }
#pragma unroll
      for (int off = 1; off < NQ; off *= 2) {
#pragma unroll
        for (int m = 0; m < 15; ++m)
          acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], off);
        bon_a += __shfl_xor_sync(0xffffffffu, bon_a, off);
        bon_b += __shfl_xor_sync(0xffffffffu, bon_b, off);
      }
      if (q == 0) {
        float* d = diag + blk * kSub * kSub;
#pragma unroll
        for (int m = 0; m < 15; ++m) {
          if (m < p) d[p * kSub + m] = acc[m];
          else d[(15 - p) * kSub + (m - p)] = acc[m];
        }
        d[p * kSub + p] = bon_a;
        d[(15 - p) * kSub + (15 - p)] = bon_b;
      }
    }
    fence_async_smem();
    __syncthreads();

    // 3a. y = (r exp2(Eex)) S_prev and the pairs across sub-chunks,
    // inter[j] = R_j K_j^T with R_j[t] = r[t] exp2(Eex[t] - E[e_j]) on rows of
    // sub-chunks after j (0 on the others): one group of products, whose
    // A fragments (rows ra, rb; keys 16 kk + ..) are built first
    // while those run: the state update's kw^T fragments (rows = keys
    // 64 m + ra / rb, k = steps 16 kk + ..) and the decay of S
    float yacc[32], inter[kNSub - 1][8];
    uint32_t hi[K / 64][4][4], lo[K / 64][4][4];
#pragma unroll
    for (int e = 0; e < 32; ++e) yacc[e] = 0.f;
#pragma unroll
    for (int j = 0; j < kNSub - 1; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e) inter[j][e] = 0.f;
    {
      uint32_t af[kNSub][K / 16][4];   // [0]: r exp2(Eex); [1 + j]: R_j
#pragma unroll
      for (int kk = 0; kk < K / 16; ++kk) {
#pragma unroll
        for (int hc = 0; hc < 2; ++hc) {
          const int col = 16 * kk + 2 * quad + 8 * hc;
          const float2 xa = *reinterpret_cast<const float2*>(P + ra * kPitch + col);
          const float2 xb = *reinterpret_cast<const float2*>(P + rb * kPitch + col);
          const float2 r_a = ld2(rt, ra, col), r_b = ld2(rt, rb, col);
          af[0][kk][2 * hc] = pack_bf16(r_a.x * exp2_fast(xa.x), r_a.y * exp2_fast(xa.y));
          af[0][kk][2 * hc + 1] = pack_bf16(r_b.x * exp2_fast(xb.x),
                                            r_b.y * exp2_fast(xb.y));
#pragma unroll
          for (int j = 0; j < kNSub - 1; ++j) {
            if (warp > j) {
              const float2 ee = *reinterpret_cast<const float2*>(
                  P + (kSub * j + kSub) * kPitch + col);
              af[1 + j][kk][2 * hc] = pack_bf16(r_a.x * exp2_fast(xa.x - ee.x),
                                                r_a.y * exp2_fast(xa.y - ee.y));
              af[1 + j][kk][2 * hc + 1] = pack_bf16(r_b.x * exp2_fast(xb.x - ee.x),
                                                    r_b.y * exp2_fast(xb.y - ee.y));
            } else {
              af[1 + j][kk][2 * hc] = 0u;
              af[1 + j][kk][2 * hc + 1] = 0u;
            }
          }
        }
      }
      fence_regs(yacc);
#pragma unroll
      for (int j = 0; j < kNSub - 1; ++j) fence_regs(inter[j]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < K / 16; ++kk)
        wgmma_n64(yacc, af[0][kk],
                  smem_desc(base_u + L::kS + wg * L::kSBox + kk * 16 * 128,
                            L::kSBox, 1024), 1);
#pragma unroll
      for (int j = 0; j < kNSub - 1; ++j)
#pragma unroll
        for (int kk = 0; kk < K / 16; ++kk)
          wgmma_n16(inter[j], af[1 + j][kk],
                    smem_desc(base_u + L::kK2 + (kk / 4) * kBoxBytes
                              + j * kSub * 128 + (kk % 4) * 32, 16, 1024), 1);
      wgmma_commit();
      // kw^T fragments: rows = keys 64 m + ra / rb, k = steps 16 kk + ..
      const float* pl = P + kChunk * kPitch;        // E[63]
#pragma unroll
      for (int m = 0; m < K / 64; ++m) {
        const int ka = 64 * m + ra, kb = 64 * m + rb;
        const float la = pl[ka], lb = pl[kb];
        const float da = exp2_fast(la), db = exp2_fast(lb);
#pragma unroll
        for (int e = 0; e < 32; ++e) sacc[m][e] *= (e & 2) ? db : da;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            // register x: key a | b by x & 1, steps t, t + 1 | + 8 by x & 2
            const int key = (x & 1) ? kb : ka;
            const float lk = (x & 1) ? lb : la;
            const int t = 16 * kk + 2 * quad + ((x & 2) ? 8 : 0);
            const uint16_t k0 = *reinterpret_cast<const uint16_t*>(kt + swz(t, key, kBoxBytes));
            const uint16_t k1 = *reinterpret_cast<const uint16_t*>(kt + swz(t + 1, key, kBoxBytes));
            const float w0 = __uint_as_float((uint32_t)k0 << 16)
                             * exp2_fast(lk - P[(t + 1) * kPitch + key]);
            const float w1 = __uint_as_float((uint32_t)k1 << 16)
                             * exp2_fast(lk - P[(t + 2) * kPitch + key]);
            const uint32_t h2 = pack_bf16(w0, w1);
            hi[m][kk][x] = h2;
            lo[m][kk][x] = pack_bf16(w0 - bf_lo(h2), w1 - bf_hi(h2));
          }
        }
      }
      wgmma_wait0();
      fence_regs(yacc);
#pragma unroll
      for (int j = 0; j < kNSub - 1; ++j) fence_regs(inter[j]);
#pragma unroll
      for (int j = 0; j < kNSub; ++j) fence_regs(af[j]);
    }

    // 3b. y += A V and S = exp2(E[63]) S + hi^T V + lo^T V
    {
      // A fragments, k-step j = keys of sub-chunk j: across sub-chunks from
      // inter[j], the diagonal block from shared memory, 0 above it
      uint32_t pa[kNSub][4];
      const float* d = diag + warp * kSub * kSub;
      const float2 d0 = *reinterpret_cast<const float2*>(d + lr * kSub + 2 * quad);
      const float2 d1 = *reinterpret_cast<const float2*>(d + (lr + 8) * kSub + 2 * quad);
      const float2 d2 = *reinterpret_cast<const float2*>(d + lr * kSub + 2 * quad + 8);
      const float2 d3 = *reinterpret_cast<const float2*>(d + (lr + 8) * kSub + 2 * quad + 8);
      const uint32_t g[4] = {pack_bf16(d0.x, d0.y), pack_bf16(d1.x, d1.y),
                             pack_bf16(d2.x, d2.y), pack_bf16(d3.x, d3.y)};
#pragma unroll
      for (int j = 0; j < kNSub; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t f = j < kNSub - 1
              ? pack_bf16(inter[j < kNSub - 1 ? j : 0][2 * e],
                          inter[j < kNSub - 1 ? j : 0][2 * e + 1]) : 0u;
          pa[j][e] = warp > j ? f : warp == j ? g[e] : 0u;
        }
      }
#pragma unroll
      for (int m = 0; m < K / 64; ++m) fence_regs(sacc[m]);
      fence_regs(yacc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kNSub; ++j)
        wgmma_n64(yacc, pa[j],
                  smem_desc(vt + wg * kBoxBytes + j * kSub * 128, kBoxBytes, 1024), 1);
#pragma unroll
      for (int m = 0; m < K / 64; ++m) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t bv = smem_desc(vt + wg * kBoxBytes + kk * kSub * 128,
                                        kBoxBytes, 1024);
          wgmma_n64(sacc[m], hi[m][kk], bv, 1);
          wgmma_n64(sacc[m], lo[m][kk], bv, 1);
        }
      }
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int m = 0; m < K / 64; ++m) {
        fence_regs(sacc[m]);
        fence_regs(hi[m]);
        fence_regs(lo[m]);
      }
      fence_regs(yacc);
      fence_regs(pa);
    }

    // 4. y of the live rows, and S in bf16 for the next chunk's r_dec S
    {
      const int t0 = c * kChunk;
      __nv_bfloat16* yb = y + b * ys_b + h * ys_h + 64 * wg + 2 * quad;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        if (t0 + ra < S)
          *reinterpret_cast<__nv_bfloat162*>(yb + (long long)(t0 + ra) * ys_t + 8 * nb) =
              __floats2bfloat162_rn(yacc[4 * nb], yacc[4 * nb + 1]);
        if (t0 + rb < S)
          *reinterpret_cast<__nv_bfloat162*>(yb + (long long)(t0 + rb) * ys_t + 8 * nb) =
              __floats2bfloat162_rn(yacc[4 * nb + 2], yacc[4 * nb + 3]);
      }
#pragma unroll
      for (int m = 0; m < K / 64; ++m) {
        const int ka = 64 * m + ra, kb = 64 * m + rb;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const int col = 8 * nb + 2 * quad;
          *reinterpret_cast<uint32_t*>(sb + wg * L::kSBox + swz(ka, col, L::kSBox)) =
              pack_bf16(sacc[m][4 * nb], sacc[m][4 * nb + 1]);
          *reinterpret_cast<uint32_t*>(sb + wg * L::kSBox + swz(kb, col, L::kSBox)) =
              pack_bf16(sacc[m][4 * nb + 2], sacc[m][4 * nb + 3]);
        }
      }
    }
    fence_async_smem();
    __syncthreads();   // stage s is free: chunk c + 2 may land in it
    if (tid == 0 && c + kStages < nc) issue(c + kStages);
  }

  // the final state, f32, [key][value]
  float* so = state_out + (long long)blockIdx.x * K * K;
#pragma unroll
  for (int m = 0; m < K / 64; ++m) {
    const int ka = 64 * m + ra, kb = 64 * m + rb;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const int col = 64 * wg + 8 * nb + 2 * quad;
      *reinterpret_cast<float2*>(so + ka * K + col) =
          make_float2(sacc[m][4 * nb], sacc[m][4 * nb + 1]);
      *reinterpret_cast<float2*>(so + kb * K + col) =
          make_float2(sacc[m][4 * nb + 2], sacc[m][4 * nb + 3]);
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

// a 4-D map (K, S, H, B) with element strides (1, time, head, batch): boxes
// of `box_cols` columns x 64 steps x 1 head x 1 batch; out-of-range
// elements read as zeros
int make_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType dtype,
             int esize, int K, int S, int H, int B, const long long* st,
             int box_cols, CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[4] = {(cuuint64_t)K, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * esize,
                                 (cuuint64_t)st[1] * esize,
                                 (cuuint64_t)st[0] * esize};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, kChunk, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, dtype, 4, const_cast<void*>(ptr), dims, strides,
                        box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + (int)r;
}

template <int K, typename LW>
int launch(const CUtensorMap& rm, const CUtensorMap& km, const CUtensorMap& vm,
           const CUtensorMap& wm, const float* u, void* y, float* state, int B,
           int H, int S, const long long* ys, cudaStream_t stream) {
  constexpr int smem = Lay<K>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      linattn_fwd_sm90<K, LW>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  linattn_fwd_sm90<K, LW><<<B * H, Lay<K>::kThreads, smem, stream>>>(
      rm, km, vm, wm, u, static_cast<__nv_bfloat16*>(y), state, H, S, ys[0],
      ys[1], ys[2]);
  return (int)cudaGetLastError();
}

}  // namespace

// dynamic shared memory of one CTA at key dim K (0 for another K)
extern "C" int linattn_scan_sm90_smem_bytes(int K) {
  return K == 64 ? Lay<64>::kSmem : K == 128 ? Lay<128>::kSmem : 0;
}

// r, k, v, y: [B, H, S, K] bf16; logw: [B, H, S, K] of lw_dtype (0 = f32,
// 1 = bf16); u: [H, K] f32, contiguous; state: [B, H, K, K] f32, contiguous;
// K is 64 or 128.  strides holds 15 element strides, (batch, head, time) of
// r, k, v, logw and y in turn; the key axis of each is contiguous, and the
// TMA needs 16-byte aligned bases and strides of a multiple of 16 bytes for
// r, k, v and logw.  Allocates nothing, does not synchronise, and returns 0,
// the CUDA error code of the enqueue, kErrNoEncoder or kErrEncode + the
// driver's CUresult.
extern "C" int linattn_scan_sm90_launch(const void* r, const void* k,
                                        const void* v, const void* logw,
                                        const void* u, void* y, void* state,
                                        int lw_dtype, int B, int H, int S,
                                        int K, const long long* strides,
                                        void* stream) {
  if (B < 1 || H < 1 || S < 1 || (long long)B * H > 0x7fffffffLL
      || (K != 64 && K != 128) || (lw_dtype != 0 && lw_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap rm, km, vm, wm;
  int err = make_map(&rm, r, bf, 2, K, S, H, B, strides, 64,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = make_map(&km, k, bf, 2, K, S, H, B, strides + 3, 64,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = make_map(&vm, v, bf, 2, K, S, H, B, strides + 6, 64,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = make_map(&wm, logw,
                   lw_dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : bf,
                   lw_dtype == 0 ? 4 : 2, K, S, H, B, strides + 9, K,
                   CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  float* sf = static_cast<float*>(state);
  const long long* ys = strides + 12;
  if (K == 64)
    return lw_dtype == 0
        ? launch<64, float>(rm, km, vm, wm, uf, y, sf, B, H, S, ys, s)
        : launch<64, __nv_bfloat16>(rm, km, vm, wm, uf, y, sf, B, H, S, ys, s);
  return lw_dtype == 0
      ? launch<128, float>(rm, km, vm, wm, uf, y, sf, B, H, S, ys, s)
      : launch<128, __nv_bfloat16>(rm, km, vm, wm, uf, y, sf, B, H, S, ys, s);
}
