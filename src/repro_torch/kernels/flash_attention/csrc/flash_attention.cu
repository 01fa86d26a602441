// flash_attention: GQA attention forward (online softmax) for sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::_flash_kernel
// (kernel.py:27, launched by flash_attention_grouped).  It computes what
// repro_torch/kernels/flash_attention/ref.py computes for q [B, Sq, H, hd] and
// k, v [B, Sk, KV, hd] in f32 or bf16: softmax(q k^T * hd^-0.5 + mask) v with
// causal, sliding-window (q_pos - k_pos < window) and q_offset masks, f32
// accumulation, and the output in q's dtype.  The numerics are the TPU
// kernel's: masked scores are -1e30 (finite), the running (m, l, acc) are
// f32 and the result is acc / max(l, 1e-30).  A row whose first keys are all
// masked accumulates p = 1 for them, and the first live key's
// alpha = exp(-1e30 - m) = 0 wipes that out, as on the TPU.
//
// Layout, not the TPU's grid.  The TPU walked the KV tiles as the innermost,
// sequential grid axis and kept (m, l, acc) in VMEM between grid steps.
// Blocks on this card run in no order, so a block owns its rows from start to
// end and walks the KV tiles in a loop.  One block per (batch, KV head,
// 64-row tile), where the rows of a KV head are its G query heads at each
// query position, in the order (position, group head): consecutive rows are
// consecutive heads of q in memory, and every row of the block reads the same
// K/V tile from shared memory, so the G heads of a group share each staged
// tile (the GQA schedule of the TPU kernel's docstring).  Four threads own a
// row, each a quarter of its head_dim in registers: q (pre-scaled by
// hd^-0.5 * log2 e, so the softmax runs on exp2), acc, and the scores of 32
// keys at a time; a two-step xor shuffle sums a score across the four.  The
// loop's first and last KV tile come from causal, window and q_offset: tiles
// no row of the block can see are never loaded (the TPU kernel's whole-block
// skip).  Keys >= Sk are masked in the kernel and staged as zeros, so the
// wrapper pads nothing.  Blocks start in reverse order, so the causal tiles
// with the most keys go first.
//
// Bound: at the serve shape (B=4, Sq=Sk=2048, H=24, KV=8, hd=128, bf16,
// causal) a launch does 4 * hd flops for each of the 4*24*2048*2049/2
// visible (query, key) pairs, 1.03e11 flops, 0.104 ms at the card's 989
// TFLOP/s for bf16; it moves 134 MB (q, k, v read once, out written once),
// 0.040 ms at 3.35 TB/s.  So it is bound by operations.  This first kernel
// does its products with f32 FMAs on the CUDA cores out of shared memory, not
// on the tensor cores, so it cannot approach that bound; mma/wgmma, TMA and a
// pipelined K/V ring are later work.  What it does for the operations it
// does: every K/V element staged is used by all 64 rows of the block, q and
// acc never leave registers, and the score loop reads shared memory as float4
// broadcasts (the four threads of a row read 64 consecutive bytes, which all
// rows of the warp share).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;       // (query position, group head) rows per block
constexpr int kLanes = 4;       // threads per row
constexpr int kThreads = kRows * kLanes;
constexpr int kTileK = 64;      // keys staged in shared memory at a time
constexpr int kChunk = 32;      // keys scored into registers at a time
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  // bf16 -> f32 is exact: the bf16 bits become the top half of the f32
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(p);
  p2[0] = __floats2bfloat162_rn(x.x, x.y);
  p2[1] = __floats2bfloat162_rn(x.z, x.w);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk, int H,
          int KV, int causal, int window, long long q_offset, float scale) {
  static_assert(HD % 16 == 0, "each of the four lanes owns float4 chunks");
  constexpr int kVec = HD / 16;   // float4 chunks of a row per lane
  extern __shared__ float4 smem[];
  float* ks = reinterpret_cast<float*>(smem);   // [kTileK][HD], f32
  float* vs = ks + kTileK * HD;

  const int G = H / KV;
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const long long n_rows = (long long)Sq * G;
  const long long r0 = (long long)(gridDim.x - 1 - blockIdx.x) * kRows;
  const long long r_last = min(r0 + kRows, n_rows) - 1;
  const int lane = threadIdx.x & (kLanes - 1);
  const long long row = r0 + (threadIdx.x / kLanes);
  const bool live = row < n_rows;
  // a thread past the last row shadows it, so every lane takes part in the
  // shuffles; it stores nothing
  const long long qi = (live ? row : r_last) / G;
  const int g = (int)((live ? row : r_last) % G);
  const long long pos = q_offset + qi;
  const size_t q_at =
      (((size_t)b * Sq + qi) * H + (size_t)kvh * G + g) * HD + lane * 4;

  float4 qr[kVec], acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const float4 x = load4(q + q_at + i * 16);
    qr[i] = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNegInf, l = 0.f;

  // the keys some row of this block can see: whole tiles outside are skipped
  const long long first_pos = q_offset + r0 / G;
  const long long last_pos = q_offset + r_last / G;
  const long long k_end =
      causal ? min((long long)Sk, last_pos + 1) : (long long)Sk;
  const long long k_begin =
      window > 0 ? max(0LL, first_pos - window + 1) : 0LL;
  const int t_lo = (int)(k_begin / kTileK);
  const int t_hi =
      k_end > k_begin ? (int)((k_end + kTileK - 1) / kTileK) : t_lo;

  const size_t key_stride = (size_t)KV * HD;
  const size_t kv_at = ((size_t)b * Sk * KV + kvh) * HD;
  const T* kb = k + kv_at;
  const T* vb = v + kv_at;

  for (int t = t_lo; t < t_hi; ++t) {
    const int key0 = t * kTileK;
    __syncthreads();   // every row is done with the previous tile
    for (int i = threadIdx.x; i < kTileK * HD / 4; i += kThreads) {
      const int j = i / (HD / 4);
      const int c = (i % (HD / 4)) * 4;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kk;
      if (key0 + j < Sk) {
        kk = load4(kb + (size_t)(key0 + j) * key_stride + c);
        vv = load4(vb + (size_t)(key0 + j) * key_stride + c);
      }
      store4(ks + j * HD + c, kk);
      store4(vs + j * HD + c, vv);
    }
    __syncthreads();

#pragma unroll 1
    for (int c0 = 0; c0 < kTileK; c0 += kChunk) {
      float s[kChunk];
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float* kr = ks + (c0 + j) * HD + lane * 4;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float4 kk = *reinterpret_cast<const float4*>(kr + i * 16);
          part = fmaf(qr[i].x, kk.x, part);
          part = fmaf(qr[i].y, kk.y, part);
          part = fmaf(qr[i].z, kk.z, part);
          part = fmaf(qr[i].w, kk.w, part);
        }
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        const long long key = key0 + c0 + j;
        const bool ok = key < Sk && (!causal || key <= pos) &&
                        (window <= 0 || pos - key < window);
        s[j] = ok ? part : kNegInf;
        mt = fmaxf(mt, s[j]);
      }
      const float m_new = fmaxf(m, mt);
      const float alpha = exp2f(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        s[j] = exp2f(s[j] - m_new);
        psum += s[j];
      }
      l = l * alpha + psum;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        acc[i].x *= alpha;
        acc[i].y *= alpha;
        acc[i].z *= alpha;
        acc[i].w *= alpha;
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float* vr = vs + (c0 + j) * HD + lane * 4;
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + i * 16);
          acc[i].x = fmaf(s[j], vv.x, acc[i].x);
          acc[i].y = fmaf(s[j], vv.y, acc[i].y);
          acc[i].z = fmaf(s[j], vv.z, acc[i].z);
          acc[i].w = fmaf(s[j], vv.w, acc[i].w);
        }
      }
      m = m_new;
    }
  }

  if (live) {
    const float d = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      store4(o + q_at + i * 16, make_float4(acc[i].x / d, acc[i].y / d,
                                            acc[i].z / d, acc[i].w / d));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KV, int causal, int window,
           long long q_offset, float scale, cudaStream_t stream) {
  const int smem = 2 * kTileK * HD * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = ((long long)Sq * (H / KV) + kRows - 1) / kRows;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)KV, (unsigned)B);
  flash_fwd<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KV, causal,
      window, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o,
              int B, int Sq, int Sk, int H, int KV, int causal, int window,
              long long q_offset, float scale, cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, Sq, Sk, H, KV, causal, window,
                           q_offset, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, KV, causal, window,
                           q_offset, scale, s);
    case 80:
      return launch<T, 80>(q, k, v, o, B, Sq, Sk, H, KV, causal, window,
                           q_offset, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, KV, causal, window,
                            q_offset, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out: [B, Sq, H, hd]; k, v: [B, Sk, KV, hd]; all contiguous, 16-byte
// aligned, of one dtype (0 = f32, 1 = bf16), on the device of `stream`.
// window <= 0 means none; scale is hd^-0.5 * log2(e).  Allocates nothing,
// does not synchronise, and returns the CUDA error code of the enqueue
// (0 = success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int dtype,
                                      int B, int Sq, int Sk, int H, int KV,
                                      int hd, int causal, int window,
                                      long long q_offset, float scale,
                                      void* stream) {
  if (B < 1 || B > 65535 || Sq < 1 || Sk < 1 || KV < 1 || KV > 65535 ||
      H % KV != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, out, B, Sq, Sk, H, KV, causal,
                            window, q_offset, scale, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, out, B, Sq, Sk, H, KV,
                                    causal, window, q_offset, scale, s);
  return (int)cudaErrorInvalidValue;
}
