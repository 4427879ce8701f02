// Chunked SSD scan (Mamba-2 forward) for Hopper (sm_90a): one CTA per
// (batch, head, 32-column slice of the head dim), looping over the chunks
// in order with its slice of the recurrent state in shared memory.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_scan/ssd_scan.py::ssd_scan_pallas
//   (body _ssd_kernel),
// and computes what the model's own src/repro/models/ssm.py::ssd_chunked
// computes: y and the final state.  For each chunk of Q rows (the last one
// ragged), with cum the in-chunk prefix sum of dt * A:
//   y_i  = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j     (intra)
//        + exp(cum_i) C_i . S                                       (inter)
//   S   <- exp(cum_last) S + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
// where S (P x N per head) enters as init_state (or 0) and leaves as the
// final state.  Only j <= i is evaluated: above the diagonal cum_i - cum_j
// is positive and exp overflows (at mamba2-780m's widths cum reaches about
// -600 within a chunk), which the reference masks with a `where`.  Rows
// past S in the last chunk are loaded as zeros (dt = 0: identity decay, no
// state contribution, as the reference's padding) and no y is written for
// them.  Everything is fp32; the prefix sum runs in order, unfused
// (__fmul_rn / __fadd_rn), as the cumsum of the rounded dt * A.
//
// Bound on this card: operations.  At B=1, S=4096, H=48, P=64, N=128,
// Q=128 the function needs about 8.1 GFLOP (C.B^T once per chunk, the
// causal halves of the two Q x Q products, 2QNP each for the inter-chunk
// term and the state update), 0.12 ms at 67 TFLOP/s fp32; its bytes (x and
// y 50 MB each, B, C, dt and the state 7 MB) take 0.03 ms at 3.35 TB/s.
// This kernel recomputes C.B^T in every CTA (one per head and P slice,
// 96 times over at B=1): simple first; sharing it across heads and a
// chunk-parallel two-pass form are later work.
//
// Design:
// * grid B * H * ceil(P / 32), 256 threads.  The CTA keeps the chunk's B
//   and C (Q x N, rows padded by 4 floats so that each 8-lane phase of a
//   float4 load hits distinct banks), its x slice (Q x 32), a 32 x Q tile
//   of the decay-weighted scores, and its 32 x N state slice (n-major,
//   rows of 33 floats) in dynamic shared memory: 183 KB at Q = N = 128,
//   above the 48 KB default, so the launch opts in once.
// * per chunk: load; one thread takes the prefix sum; then for each
//   32-row tile, warp w scores rows 4w..4w+3 against keys lane + 32k for
//   the key tiles k at or below the diagonal (4 x 4 dot products over N a
//   thread), writes exp-weighted scores (0 above the diagonal) to shared
//   memory, and computes y for the same 4 rows at column p = lane: the
//   intra term from the score tile, the inter term from C and the state;
//   last, warp w updates state rows 16w..16w+15 at column lane.
// Build without --use_fast_math: expf stays the accurate one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPT = 32;                 // head-dim columns per CTA
constexpr int kRT = 32;                 // score rows per tile
constexpr int kRows = kRT / kWarps;     // score rows per warp
constexpr int kSP = kPT + 1;            // state row stride (n-major)
constexpr int kMaxQ = 128;
constexpr int kMaxN = 128;

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// floats of dynamic shared memory for a chunk of Qr rows (a multiple of 32)
// and N4 state columns (a multiple of 4)
__host__ __device__ constexpr size_t smem_floats(int Qr, int N4) {
  return (size_t)2 * Qr * (N4 + 4)   // B, C
         + (size_t)Qr * kPT          // x slice
         + (size_t)kRT * Qr          // score tile
         + (size_t)N4 * kSP          // state slice
         + (size_t)4 * Qr;           // cum, dt, state weights, exp(cum)
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ init,
                float* __restrict__ y, float* __restrict__ fstate, int S,
                int H, int P, int N, int Q) {
  const int nps = (P + kPT - 1) / kPT;
  const int ps = blockIdx.x % nps;
  const int bh = blockIdx.x / nps;
  const int h = bh % H, b = bh / H;
  const int p0 = ps * kPT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int Qr = round_up(Q, kRT);
  const int N4 = round_up(N, 4);
  const int NS = N4 + 4;                // B / C row stride

  extern __shared__ float4 smem4[];
  float* Bs = reinterpret_cast<float*>(smem4);   // Qr x NS
  float* Cs = Bs + Qr * NS;                      // Qr x NS
  float* Xs = Cs + Qr * NS;                      // Qr x kPT
  float* Gs = Xs + Qr * kPT;                     // kRT x Qr
  float* St = Gs + kRT * Qr;                     // N4 x kSP
  float* cum = St + N4 * kSP;                    // Qr
  float* dts = cum + Qr;                         // Qr
  float* wts = dts + Qr;                         // Qr
  float* ecum = wts + Qr;                        // Qr

  const float a = A[h];
  const long long state_base = ((long long)b * H + h) * P * N;
  for (int i = tid; i < N4 * kPT; i += kThreads) {
    const int p = i / N4, n = i % N4;   // n fastest: coalesced reads
    float v = 0.f;
    if (init != nullptr && n < N && p0 + p < P)
      v = init[state_base + (long long)(p0 + p) * N + n];
    St[n * kSP + p] = v;
  }

  const int nc = (S + Q - 1) / Q;
  for (int c = 0; c < nc; ++c) {
    const int s0 = c * Q;
    const int qv = min(Q, S - s0);      // rows of this chunk inside S
    __syncthreads();   // the last chunk's reads and state writes are done
    for (int i = tid; i < Qr * N4; i += kThreads) {
      const int r = i / N4, n = i % N4;
      float bv = 0.f, cv = 0.f;
      if (r < qv && n < N) {
        const long long off = ((long long)b * S + s0 + r) * N + n;
        bv = Bm[off];
        cv = Cm[off];
      }
      Bs[r * NS + n] = bv;
      Cs[r * NS + n] = cv;
    }
    for (int i = tid; i < Qr * kPT; i += kThreads) {
      const int r = i / kPT, p = i % kPT;
      float xv = 0.f;
      if (r < qv && p0 + p < P)
        xv = x[(((long long)b * S + s0 + r) * H + h) * P + p0 + p];
      Xs[i] = xv;
    }
    for (int r = tid; r < Qr; r += kThreads)
      dts[r] = r < qv ? dt[((long long)b * S + s0 + r) * H + h] : 0.f;
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int r = 0; r < Qr; ++r) {
        run = __fadd_rn(run, __fmul_rn(dts[r], a));
        cum[r] = run;
      }
    }
    __syncthreads();
    const float cum_last = cum[qv - 1];
    for (int r = tid; r < Qr; r += kThreads) {
      wts[r] = r < qv ? expf(cum_last - cum[r]) * dts[r] : 0.f;
      ecum[r] = expf(cum[r]);
    }
    __syncthreads();

    const int ntiles = (qv + kRT - 1) / kRT;
    for (int t = 0; t < ntiles; ++t) {
      const int rw = t * kRT + warp * kRows;   // this warp's first row
      // scores C_i . B_j, i in rw..rw+3, j = lane + 32k for k <= t
      float acc[kRows][4];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[r][k] = 0.f;
      for (int n = 0; n < N4; n += 4) {
        float4 cv[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          cv[r] = *reinterpret_cast<const float4*>(&Cs[(rw + r) * NS + n]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (k > t) break;
          const float4 bv =
              *reinterpret_cast<const float4*>(&Bs[(lane + 32 * k) * NS + n]);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            acc[r][k] = fmaf(cv[r].x, bv.x, acc[r][k]);
            acc[r][k] = fmaf(cv[r].y, bv.y, acc[r][k]);
            acc[r][k] = fmaf(cv[r].z, bv.z, acc[r][k]);
            acc[r][k] = fmaf(cv[r].w, bv.w, acc[r][k]);
          }
        }
      }
      // decay-weighted scores; 0 above the diagonal and past the last row
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = rw + r;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (k > t) break;
          const int j = lane + 32 * k;
          float g = 0.f;
          if (i < qv && j <= i)
            g = acc[r][k] * expf(cum[i] - cum[j]) * dts[j];
          Gs[(warp * kRows + r) * Qr + j] = g;
        }
      }
      __syncthreads();

      // y for rows rw..rw+3 at column p0 + lane
      float yi[kRows], ye[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) yi[r] = ye[r] = 0.f;
      const int jend = kRT * (t + 1);
      for (int j = 0; j < jend; j += 4) {
        float4 g[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          g[r] = *reinterpret_cast<const float4*>(
              &Gs[(warp * kRows + r) * Qr + j]);
        const float x0 = Xs[(j + 0) * kPT + lane];
        const float x1 = Xs[(j + 1) * kPT + lane];
        const float x2 = Xs[(j + 2) * kPT + lane];
        const float x3 = Xs[(j + 3) * kPT + lane];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          yi[r] = fmaf(g[r].x, x0, yi[r]);
          yi[r] = fmaf(g[r].y, x1, yi[r]);
          yi[r] = fmaf(g[r].z, x2, yi[r]);
          yi[r] = fmaf(g[r].w, x3, yi[r]);
        }
      }
      for (int n = 0; n < N4; n += 4) {
        float4 cv[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          cv[r] = *reinterpret_cast<const float4*>(&Cs[(rw + r) * NS + n]);
        const float s0v = St[(n + 0) * kSP + lane];
        const float s1v = St[(n + 1) * kSP + lane];
        const float s2v = St[(n + 2) * kSP + lane];
        const float s3v = St[(n + 3) * kSP + lane];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          ye[r] = fmaf(cv[r].x, s0v, ye[r]);
          ye[r] = fmaf(cv[r].y, s1v, ye[r]);
          ye[r] = fmaf(cv[r].z, s2v, ye[r]);
          ye[r] = fmaf(cv[r].w, s3v, ye[r]);
        }
      }
      if (p0 + lane < P) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int i = rw + r;
          if (i < qv)
            y[(((long long)b * S + s0 + i) * H + h) * P + p0 + lane] =
                yi[r] + ecum[i] * ye[r];
        }
      }
      __syncthreads();   // the next tile rewrites the score tile
    }

    // S <- exp(cum_last) S + sum_j wts_j x_j B_j^T, rows 16w..16w+15
    const float decay = expf(cum_last);
    const int nb = warp * 16;
    if (nb < N4) {
      float sa[16];
#pragma unroll
      for (int m = 0; m < 16; ++m) sa[m] = 0.f;
      for (int j = 0; j < qv; ++j) {
        const float xw = Xs[j * kPT + lane] * wts[j];
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4) {
          if (nb + 4 * q4 >= N4) break;
          const float4 bv =
              *reinterpret_cast<const float4*>(&Bs[j * NS + nb + 4 * q4]);
          sa[4 * q4 + 0] = fmaf(bv.x, xw, sa[4 * q4 + 0]);
          sa[4 * q4 + 1] = fmaf(bv.y, xw, sa[4 * q4 + 1]);
          sa[4 * q4 + 2] = fmaf(bv.z, xw, sa[4 * q4 + 2]);
          sa[4 * q4 + 3] = fmaf(bv.w, xw, sa[4 * q4 + 3]);
        }
      }
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        const int n = nb + m;
        if (n < N4) St[n * kSP + lane] = decay * St[n * kSP + lane] + sa[m];
      }
    }
  }

  __syncthreads();
  for (int i = tid; i < N4 * kPT; i += kThreads) {
    const int p = i / N4, n = i % N4;
    if (n < N && p0 + p < P)
      fstate[state_base + (long long)(p0 + p) * N + n] = St[n * kSP + p];
  }
}

}  // namespace

// x (B, S, H, P), dt (B, S, H), A (H,), Bm and Cm (B, S, N), init (B, H, P,
// N) or null for a zero state; y (B, S, H, P) and fstate (B, H, P, N).  All
// float32 and contiguous.  Q is the chunk length, min(chunk, S); the caller
// checks 1 <= Q <= 128 and 1 <= N <= 128.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm,
                              const void* init, void* y, void* fstate, int B,
                              int S, int H, int P, int N, int Q,
                              void* stream) {
  if (Q < 1 || Q > kMaxQ || N < 1 || N > kMaxN)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0) return 0;
  static bool attribute_set = false;   // once, before any graph capture
  if (!attribute_set) {                // (warm-up calls)
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(sizeof(float) * smem_floats(kMaxQ, kMaxN)));
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  const size_t smem =
      sizeof(float) * smem_floats(round_up(Q, kRT), round_up(N, 4));
  const long long grid = (long long)B * H * ((P + kPT - 1) / kPT);
  ssd_scan_kernel<<<(unsigned)grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)dt, (const float*)A, (const float*)Bm,
      (const float*)Cm, (const float*)init, (float*)y, (float*)fstate, S, H,
      P, N, Q);
  return (int)cudaGetLastError();
}
