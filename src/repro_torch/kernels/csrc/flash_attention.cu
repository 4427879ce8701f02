// Flash attention forward for Hopper (sm_90a): online softmax over key
// tiles in shared memory, fp32 running max / denominator / accumulator in
// registers.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_attention_bhsd
//   (body _flash_kernel).
// It computes the same function, on the model's (B, S, heads, D) layout:
//   s    = (q . k) / sqrt(D)                     fp32 dot over D
//   s    = cap * tanh(s / cap)                   when softcap > 0, before
//                                                the mask and the max
//   mask = k_pos < Sk  [& k_pos <= q_pos if causal]
//                      [& k_pos > q_pos - window if window > 0]
//   out  = sum_k exp(s - m) v / max(sum_k exp(s - m), 1e-30)
// with positions starting at 0 for both q and k (no q offset), query head h
// reading KV head h / (H / KV) (GQA), fp32 or bf16 inputs read into fp32,
// and the output in the input's type.  A masked score adds nothing (p = 0),
// so a row with no valid key comes out 0, as ref.attention_ref gives, and a
// key tile that no row of the query tile can see is skipped: tiles above
// the causal diagonal and tiles wholly outside the window.
//
// Bound on this card: operations.  At gemma2-2b's prefill (S = 4608, H = 8,
// D = 256, causal) the kernel does 4 * D * H fp32 operations for each of
// 10.6 M visible (q, k) pairs, 87 GFLOP, about 1.3 ms at 67 TFLOP/s; the
// bytes (q, k, v read once, out written once: 57 MB) take 0.02 ms.  TF32
// tensor cores would lift the operations bound 7x, but their 10-bit
// mantissa breaks the 1e-5 tolerance the reference holds the kernel to;
// this version stays in fp32 on the CUDA cores.
//
// Design (correct and simple first; wgmma/TMA are later work):
// * one CTA of 8 warps per (batch, head, 64-row query tile); the grid is
//   1-D, heaviest query tiles (the last, under the causal mask) first.
// * the CTA keeps its Q tile in shared memory and loops over 64-key tiles
//   of K and V, loaded by all threads (coalesced along D) into shared
//   memory.  At D = 256 that is 64 + 65 + 64 + 16 KB (Q, K, V, P): above
//   the 48 KB default, so the launch opts in to up to 227 KB of dynamic
//   shared memory.  Head dims are padded with zeros to 32, 64, 128 or 256
//   (the zero lanes add nothing to a dot product).
// * each warp owns 8 query rows.  Scores: lane j computes keys j and j+32
//   for the 8 rows, float4 reads of Q (broadcast) and K (rows padded by 4
//   floats, so the 8 lanes of each float4 phase hit distinct banks).  The
//   row max and row sum are warp shuffles; the probabilities go through a
//   warp-private slice of shared memory to the P.V product, where lane j
//   accumulates columns j, j+32, ... of its 8 rows.
// Build without --use_fast_math: expf and tanhf stay the accurate ones.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // keys per tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kBQ / kWarps;   // query rows per warp
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(kBQ * DP + kBK * (DP + 4) + kBK * DP + kBQ * kBK);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int B, int Sq,
                 int Sk, int H, int KV, int D, int causal, int window,
                 float softcap, float sqrt_d) {
  constexpr int KP = DP + 4;       // K row stride in shared memory
  constexpr int NPL = DP / 32;     // output columns per lane
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // kBQ x DP
  float* Ks = Qs + kBQ * DP;                     // kBK x KP
  float* Vs = Ks + kBK * KP;                     // kBK x DP
  float* Ps = Vs + kBK * DP;                     // kBQ x kBK

  const int nq = (Sq + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % (B * H);
  const int qt = nq - 1 - (int)(blockIdx.x / (B * H));
  const int b = bh / H, h = bh % H;
  const int g = h / (H / KV);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = warp * kRows;

  for (int i = tid; i < kBQ * DP; i += kThreads) {
    const int r = i / DP, d = i % DP, qp = q0 + r;
    float x = 0.f;
    if (qp < Sq && d < D)
      x = to_float(q[(((long long)b * Sq + qp) * H + h) * D + d]);
    Qs[i] = x;
  }

  // the key range any row of this tile can see
  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(Sk, q0 + kBQ);
  if (window > 0) k_begin = max(0, q0 - window + 1);
  const int t_begin = k_begin / kBK;
  const int t_end = (k_end + kBK - 1) / kBK;

  float m[kRows], l[kRows], acc[kRows][NPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < NPL; ++j) acc[r][j] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();   // Q is in; the last tile's K, V and P reads are done
#pragma unroll 4
    for (int i = tid; i < kBK * DP; i += kThreads) {
      const int c = i / DP, d = i % DP, kp = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (kp < Sk && d < D) {
        const long long off = (((long long)b * Sk + kp) * KV + g) * D + d;
        kx = to_float(k[off]);
        vx = to_float(v[off]);
      }
      Ks[c * KP + d] = kx;
      Vs[c * DP + d] = vx;
    }
    __syncthreads();

    // scores of rows r0..r0+7 against keys lane and lane + 32
    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DP; d += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(&Ks[lane * KP + d]);
      const float4 kb =
          *reinterpret_cast<const float4*>(&Ks[(lane + 32) * KP + d]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(&Qs[(r0 + r) * DP + d]);
        s[r][0] = fmaf(qv.x, ka.x, s[r][0]);
        s[r][0] = fmaf(qv.y, ka.y, s[r][0]);
        s[r][0] = fmaf(qv.z, ka.z, s[r][0]);
        s[r][0] = fmaf(qv.w, ka.w, s[r][0]);
        s[r][1] = fmaf(qv.x, kb.x, s[r][1]);
        s[r][1] = fmaf(qv.y, kb.y, s[r][1]);
        s[r][1] = fmaf(qv.z, kb.z, s[r][1]);
        s[r][1] = fmaf(qv.w, kb.w, s[r][1]);
      }
    }

    // online softmax, row by row
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qp = q0 + r0 + r;
      bool ok[2];
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = k0 + lane + 32 * j;
        float x = s[r][j] / sqrt_d;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool valid = kp < Sk;
        if (causal) valid = valid && kp <= qp;
        if (window > 0) valid = valid && kp > qp - window;
        ok[j] = valid;
        s[r][j] = valid ? x : kNegInf;
        rmax = fmaxf(rmax, s[r][j]);
      }
      const float m_new = fmaxf(m[r], warp_max(rmax));
      const float corr = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = ok[j] ? expf(s[r][j] - m_new) : 0.f;
        psum += p;
        Ps[(r0 + r) * kBK + lane + 32 * j] = p;
      }
      l[r] = l[r] * corr + warp_sum(psum);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < NPL; ++j) acc[r][j] *= corr;
    }
    __syncwarp();

    // acc += P . V over this tile's keys
#pragma unroll 1
    for (int c = 0; c < kBK; c += 4) {
      float4 p4[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        p4[r] = *reinterpret_cast<const float4*>(&Ps[(r0 + r) * kBK + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int j = 0; j < NPL; ++j) {
          const float vx = Vs[(c + cc) * DP + lane + 32 * j];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float p = cc == 0 ? p4[r].x
                          : cc == 1 ? p4[r].y
                          : cc == 2 ? p4[r].z : p4[r].w;
            acc[r][j] = fmaf(p, vx, acc[r][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + r0 + r;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = out + (((long long)b * Sq + qp) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const int d = lane + 32 * j;
      if (d < D) store(orow + d, acc[r][j] / denom);
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int KV, int D, int causal, int window,
           float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP>();
  static bool attribute_set = false;   // once per instantiation, before any
  if (!attribute_set) {                // graph capture (warm-up calls)
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  const long long nq = (Sq + kBQ - 1) / kBQ;
  const long long grid = nq * B * H;
  flash_fwd_kernel<T, DP><<<(unsigned)grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, B, Sq, Sk, H, KV, D,
      causal, window, softcap, sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int Sq, int Sk, int H, int KV, int D, int causal, int window,
             float softcap, cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 32>(q, k, v, out, B, Sq, Sk, H, KV, D, causal, window,
                         softcap, stream);
  if (D <= 64)
    return launch<T, 64>(q, k, v, out, B, Sq, Sk, H, KV, D, causal, window,
                         softcap, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, out, B, Sq, Sk, H, KV, D, causal, window,
                          softcap, stream);
  return launch<T, 256>(q, k, v, out, B, Sq, Sk, H, KV, D, causal, window,
                        softcap, stream);
}

}  // namespace

// q (B, Sq, H, D), k and v (B, Sk, KV, D), out (B, Sq, H, D), all
// contiguous; dtype 0 = float32, 1 = bfloat16.  The caller checks
// 1 <= D <= 256, H % KV == 0 and B, Sq, Sk >= 1.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int Sq,
                                     int Sk, int H, int KV, int D, int causal,
                                     int window, float softcap, int dtype,
                                     void* stream) {
  if (D < 1 || D > 256 || KV < 1 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, B, Sq, Sk, H, KV, D, causal, window,
                           softcap, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, KV, D, causal,
                                   window, softcap, s);
  return (int)cudaErrorInvalidValue;
}
