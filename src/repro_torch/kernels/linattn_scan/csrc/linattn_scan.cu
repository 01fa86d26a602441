// linattn_scan: chunked RWKV6 "WKV" linear attention for sm_90a.
//
// Replaces the TPU kernel repro/kernels/linattn_scan/kernel.py::_linattn_kernel
// (kernel.py:23, launched by linattn_grouped).  For r, k, v, logw [B, H, S, K]
// and u [H, K] it computes what repro_torch/kernels/linattn_scan/ref.py
// computes token by token,
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T          w_t = exp(logw_t)
//     y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T),
// with f32 math, y in r's dtype, and it also writes the final state
// [B, H, K, K] in f32, key axis first: the TPU kernel kept that state in VMEM
// scratch, while the rwkv prefill that this kernel serves needs it as the
// decode cache.
//
// Layout, not the TPU's grid.  The TPU walked the chunks as the innermost,
// sequential grid axis and carried the state in scratch between grid steps.
// Blocks on this card run in no order, so one block owns one (batch, head)
// and walks the time axis in tiles of kTile steps, with the [K, K] f32 state
// in shared memory from the first tile to the last.  The chunk length is a
// tiling choice, not part of the function: any tile gives the same y and
// state up to rounding.  Within a tile, in log space as on the TPU:
//   E[t]   = sum_{j<=t} logw_j (inclusive), Eex[t] = E[t] - logw_t;
//   att[t,s] = sum_k r[t,k] k[s,k] exp(Eex[t,k] - E[s,k])   for s < t,
//   att[t,t] = sum_k r[t,k] u[k] k[t,k]                      (the bonus);
//   y[t] = sum_{s<=t} att[t,s] v[s] + sum_k r[t,k] exp(Eex[t,k]) S[k,:];
//   S <- exp(E[last]) * S + sum_s (k[s] * exp(E[last] - E[s])) v[s]^T.
// Every exponent is <= 0: exp(+E) or exp(-E) alone, the factored form that
// overflows for steep decays over long tiles, is never formed, and the
// masked pairs s > t are never exponentiated.  E and Eex are kept pre-scaled
// by log2(e), so each exponential is one exp2f.  The ragged last tile is
// masked here: steps past S load r = k = v = 0 and logw = 0, which leaves the
// state unchanged, and write no y (the TPU wrapper padded S instead).
//
// The kernel reads each tensor through its own (batch, head, time) strides
// with the key axis contiguous, so the model's [B, S, H, K] activations are
// read in place through a [B, H, S, K] view, and y is written through the
// strides of the tensor the wrapper allocates in r's layout.
//
// Bound: at the serve shape (B=4, H=64, S=2048, K=64, r/k/v/y bf16, logw
// f32) a launch must move 406.8 MB (r, k, v, logw, u read once, y and the
// state written once), 0.121 ms at 3.35 TB/s; the recurrence needs at least
// 4 K^2 f32 flops a step and head (r.S and the rank-1 state update), 8.6
// GFLOP, 0.128 ms at the 67 TFLOP/s f32 rate outside the tensor cores.  So
// the two bounds are close, and operations set it.  This first kernel does
// more than that least work: the intra-tile pairs cost kTile K / 2
// exponentials and as many FMAs a step, and its products are f32 FMAs on the
// CUDA cores out of shared memory.  What it does about it: tiles of 32 steps
// (the pairwise work grows with the tile, the state work does not), the
// pairs of each tile spread over register blocks of 4 x 4 with the key axis
// split four ways and summed by shuffles, every tile's operands staged once
// in shared memory with the time axis contiguous for float4 reads, and the
// shared memory kept under 113 KB for K <= 64 so that two blocks share an SM.
// Only B * H blocks run (256 at the serve shape, under two per SM); splitting
// the time axis across blocks, tensor cores and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;             // time steps per tile
constexpr int kPitch = kTile + 4;     // row pitch of the [K][time] buffers
constexpr int kSplit = 4;             // key-axis split of the pair blocks
constexpr int kBlocks = kTile / 4;    // 4 x 4 pair blocks along each side
constexpr int kTri = kBlocks * (kBlocks + 1) / 2;   // blocks with s <= t
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long r[3], k[3], v[3], w[3], y[3];   // (batch, head, time), elements
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float at(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

template <int K>
constexpr int smem_floats() {
  // rT, kT, ET, XT, rdT: [K][kPitch]; v, kw: [kTile][K]; attT: [kTile][kTile];
  // state: [K][K]; u, dec: [K]
  return 5 * K * kPitch + 2 * kTile * K + kTile * kTile + K * K + 2 * K;
}

template <typename T, typename LW, int K>
__global__ void __launch_bounds__(kThreads)
linattn_fwd(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const LW* __restrict__ logw,
            const float* __restrict__ u, T* __restrict__ y,
            float* __restrict__ state_out, int H, int S, Strides st_) {
  static_assert(K % 16 == 0 && K <= 128, "K in {16, 32, 64, 128}");
  constexpr int kGroup = kThreads / K;        // threads per channel in the scan
  constexpr int kSeg = kTile / kGroup;        // steps per thread in the scan
  static_assert(kSeg >= 1 && kTile % kGroup == 0, "scan split");
  extern __shared__ float4 smem4[];
  float* rT = reinterpret_cast<float*>(smem4);   // [K][kPitch], time inner
  float* kT = rT + K * kPitch;
  float* ET = kT + K * kPitch;                   // E * log2 e
  float* XT = ET + K * kPitch;                   // Eex * log2 e
  float* rdT = XT + K * kPitch;                  // r * exp(Eex)
  float* vs = rdT + K * kPitch;                  // [kTile][K]
  float* kw = vs + kTile * K;                    // [kTile][K]
  float* attT = kw + kTile * K;                  // [s][t]
  float* Sm = attT + kTile * kTile;              // [K][K], key first
  float* us = Sm + K * K;
  float* dec = us + K;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const T* rb = r + b * st_.r[0] + h * st_.r[1];
  const T* kb = k + b * st_.k[0] + h * st_.k[1];
  const T* vb = v + b * st_.v[0] + h * st_.v[1];
  const LW* wb = logw + b * st_.w[0] + h * st_.w[1];
  T* yb = y + b * st_.y[0] + h * st_.y[1];

  for (int i = tid; i < K * K; i += kThreads) Sm[i] = 0.f;
  for (int i = tid; i < K; i += kThreads) us[i] = u[h * K + i];

  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int n = min(kTile, S - t0);
    __syncthreads();   // the previous tile's state update is done
    // 1. stage the tile, f32; steps past S are zeros (logw = 0: no decay)
    for (int i = tid; i < kTile * K; i += kThreads) {
      const int t = i / K, c = i % K;
      float rr = 0.f, kk = 0.f, vv = 0.f, ww = 0.f;
      if (t < n) {
        const long long ts = t0 + t;
        rr = ld(rb + ts * st_.r[2] + c);
        kk = ld(kb + ts * st_.k[2] + c);
        vv = ld(vb + ts * st_.v[2] + c);
        ww = ld(wb + ts * st_.w[2] + c);
      }
      rT[c * kPitch + t] = rr;
      kT[c * kPitch + t] = kk;
      ET[c * kPitch + t] = ww;
      vs[t * K + c] = vv;
    }
    __syncthreads();

    // 2. inclusive and exclusive cumulative log-decay per channel: kGroup
    // neighbouring lanes own one channel, kSeg steps each, joined by a
    // shuffle scan over the group
    {
      const int c = tid / kGroup, p = tid % kGroup;
      float lw[kSeg], run = 0.f;
#pragma unroll
      for (int j = 0; j < kSeg; ++j) {
        lw[j] = ET[c * kPitch + p * kSeg + j];
        run += lw[j];
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < kGroup; off *= 2) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off, kGroup);
        if (p >= off) incl += o;
      }
      float e = incl - run;
#pragma unroll
      for (int j = 0; j < kSeg; ++j) {
        e += lw[j];
        ET[c * kPitch + p * kSeg + j] = e * kLog2e;
        XT[c * kPitch + p * kSeg + j] = (e - lw[j]) * kLog2e;
      }
    }
    __syncthreads();

    // 3a. r * exp(Eex), k * exp(E_last - E) and exp(E_last): exponents <= 0
    for (int i = tid; i < K * kTile; i += kThreads) {
      const int c = i / kTile, t = i % kTile;
      rdT[c * kPitch + t] = rT[c * kPitch + t] * exp2f(XT[c * kPitch + t]);
    }
    for (int i = tid; i < kTile * K; i += kThreads) {
      const int t = i / K, c = i % K;
      kw[t * K + c] = kT[c * kPitch + t] *
                      exp2f(ET[c * kPitch + kTile - 1] - ET[c * kPitch + t]);
    }
    for (int c = tid; c < K; c += kThreads)
      dec[c] = exp2f(ET[c * kPitch + kTile - 1]);

    // 3b. the pair weights att[t, s], s <= t, in 4 x 4 blocks; kSplit
    // neighbouring lanes take a quarter of the key axis each
    if (tid < (kTri * kSplit + 31) / 32 * 32) {
      const bool live = tid < kTri * kSplit;
      const int tri = live ? tid / kSplit : 0;
      const int part = tid % kSplit;
      int ti = 0;
      while ((ti + 1) * (ti + 2) / 2 <= tri) ++ti;
      const int si = tri - ti * (ti + 1) / 2;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      constexpr int kPart = K / kSplit;
      const int c0 = part * kPart, c1 = live ? c0 + kPart : c0;
      if (ti != si) {
        for (int c = c0; c < c1; ++c) {
          const float4 rr = ld4(rT + c * kPitch + 4 * ti);
          const float4 xx = ld4(XT + c * kPitch + 4 * ti);
          const float4 kk = ld4(kT + c * kPitch + 4 * si);
          const float4 ee = ld4(ET + c * kPitch + 4 * si);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(at(rr, i) * at(kk, j),
                               exp2f(at(xx, i) - at(ee, j)), acc[i][j]);
        }
      } else {
        for (int c = c0; c < c1; ++c) {
          const float4 rr = ld4(rT + c * kPitch + 4 * ti);
          const float4 xx = ld4(XT + c * kPitch + 4 * ti);
          const float4 kk = ld4(kT + c * kPitch + 4 * si);
          const float4 ee = ld4(ET + c * kPitch + 4 * si);
          const float uu = us[c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < i; ++j)
              acc[i][j] = fmaf(at(rr, i) * at(kk, j),
                               exp2f(at(xx, i) - at(ee, j)), acc[i][j]);
            acc[i][i] = fmaf(at(rr, i) * at(kk, i), uu, acc[i][i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int m = 1; m < kSplit; m *= 2)
            acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], m);
        }
      if (live && part == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float4*>(attT + (4 * si + j) * kTile + 4 * ti) =
              make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
      }
    }
    __syncthreads();

    // 4. y for 2 steps x 4 value channels a thread: the pairs of the tile,
    // then the state carried in from the earlier tiles
    for (int o = tid; o < (kTile / 2) * (K / 4); o += kThreads) {
      const int ti = o / (K / 4), ji = o % (K / 4);
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int s = 0; s <= 2 * ti + 1; ++s) {
        const float2 a = ld2(attT + s * kTile + 2 * ti);
        const float4 vv = ld4(vs + s * K + 4 * ji);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[0][j] = fmaf(a.x, at(vv, j), acc[0][j]);
          acc[1][j] = fmaf(a.y, at(vv, j), acc[1][j]);
        }
      }
#pragma unroll 4
      for (int c = 0; c < K; ++c) {
        const float2 rd = ld2(rdT + c * kPitch + 2 * ti);
        const float4 ss = ld4(Sm + c * K + 4 * ji);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[0][j] = fmaf(rd.x, at(ss, j), acc[0][j]);
          acc[1][j] = fmaf(rd.y, at(ss, j), acc[1][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = 2 * ti + i;
        if (t < n) {
          T* yp = yb + (long long)(t0 + t) * st_.y[2] + 4 * ji;
#pragma unroll
          for (int j = 0; j < 4; ++j) st(yp + j, acc[i][j]);
        }
      }
    }
    __syncthreads();

    // 5. the state update, 4 keys x 4 values a thread
    for (int o = tid; o < (K / 4) * (K / 4); o += kThreads) {
      const int ki = o / (K / 4), ji = o % (K / 4);
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = dec[4 * ki + i];
        const float4 ss = ld4(Sm + (4 * ki + i) * K + 4 * ji);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = d * at(ss, j);
      }
      for (int s = 0; s < kTile; ++s) {
        const float4 kk = ld4(kw + s * K + 4 * ki);
        const float4 vv = ld4(vs + s * K + 4 * ji);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(at(kk, i), at(vv, j), acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(Sm + (4 * ki + i) * K + 4 * ji) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
  __syncthreads();
  float* so = state_out + (long long)blockIdx.x * K * K;
  for (int i = tid; i < K * K; i += kThreads) so[i] = Sm[i];
}

template <typename T, typename LW, int K>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const float* u, void* y, float* state, int B, int H, int S,
           const Strides& st, cudaStream_t stream) {
  const int smem = smem_floats<K>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      linattn_fwd<T, LW, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  linattn_fwd<T, LW, K><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const LW*>(logw), u,
      static_cast<T*>(y), state, H, S, st);
  return (int)cudaGetLastError();
}

template <typename T, typename LW>
int launch_k(int K, const void* r, const void* k, const void* v,
             const void* logw, const float* u, void* y, float* state, int B,
             int H, int S, const Strides& st, cudaStream_t s) {
  switch (K) {
    case 16:
      return launch<T, LW, 16>(r, k, v, logw, u, y, state, B, H, S, st, s);
    case 32:
      return launch<T, LW, 32>(r, k, v, logw, u, y, state, B, H, S, st, s);
    case 64:
      return launch<T, LW, 64>(r, k, v, logw, u, y, state, B, H, S, st, s);
    case 128:
      return launch<T, LW, 128>(r, k, v, logw, u, y, state, B, H, S, st, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_lw(int lw_dtype, int K, const void* r, const void* k,
              const void* v, const void* logw, const float* u, void* y,
              float* state, int B, int H, int S, const Strides& st,
              cudaStream_t s) {
  if (lw_dtype == 0)
    return launch_k<T, float>(K, r, k, v, logw, u, y, state, B, H, S, st, s);
  if (lw_dtype == 1)
    return launch_k<T, __nv_bfloat16>(K, r, k, v, logw, u, y, state, B, H, S,
                                      st, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// r, k, v, y: [B, H, S, K] of one dtype (0 = f32, 1 = bf16); logw: [B, H, S, K]
// of lw_dtype (0 = f32, 1 = bf16); u: [H, K] f32, contiguous; state:
// [B, H, K, K] f32, contiguous.  strides holds 15 element strides, (batch,
// head, time) of r, k, v, logw and y in turn; the key axis of each is
// contiguous.  Allocates nothing, does not synchronise, and returns the CUDA
// error code of the enqueue (0 = success).
extern "C" int linattn_scan_launch(const void* r, const void* k,
                                   const void* v, const void* logw,
                                   const void* u, void* y, void* state,
                                   int dtype, int lw_dtype, int B, int H,
                                   int S, int K, const long long* strides,
                                   void* stream) {
  if (B < 1 || H < 1 || S < 1 || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.r[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.w[i] = strides[9 + i];
    st.y[i] = strides[12 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  float* sf = static_cast<float*>(state);
  if (dtype == 0)
    return launch_lw<float>(lw_dtype, K, r, k, v, logw, uf, y, sf, B, H, S,
                            st, s);
  if (dtype == 1)
    return launch_lw<__nv_bfloat16>(lw_dtype, K, r, k, v, logw, uf, y, sf, B,
                                    H, S, st, s);
  return (int)cudaErrorInvalidValue;
}
