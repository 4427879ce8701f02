// Flash attention forward for Hopper (sm_90a): online softmax over key
// tiles, with both products on the tensor cores in the 3xTF32 split.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_attention_bhsd
//   (body _flash_kernel).
// It computes the same function, on the model's (B, S, heads, D) layout:
//   s    = (q . k) * scale                       dot over D, scale =
//                                                fp32(1 / sqrt(D)) as the
//                                                Pallas kernel scales
//   s    = cap * tanh(s / cap)                   when softcap > 0, before
//                                                the mask and the max
//   mask = k_pos < Sk  [& k_pos <= q_pos if causal]
//                      [& k_pos > q_pos - window if window > 0]
//   out  = sum_k exp(s - m) v / max(sum_k exp(s - m), 1e-30)
// with positions starting at 0 for both q and k (no q offset), query head h
// reading KV head h / (H / KV) (GQA), fp32 or bf16 inputs read into fp32,
// fp32 running max / denominator / accumulator, and the output in the
// input's type.  A masked score adds nothing (p = 0), so a row with no
// valid key comes out 0, as ref.attention_ref gives, and a key tile that no
// row of the query tile can see is skipped: tiles above the causal diagonal
// and tiles wholly outside the window.  expf and tanhf are the accurate
// ones (built without --use_fast_math).
//
// Arithmetic: 3xTF32.  One TF32 product (10-bit mantissa) puts the output
// ~1e-3 off, 100x outside the 1e-5 tolerance the reference holds the
// kernel to.  Every operand x is split as hi = tf32(x), lo = tf32(x - hi),
// with tf32() the rounding of cvt.rna.tf32.f32 (to nearest, ties away from
// zero), and a.b is taken as lo_a.hi_b + hi_a.lo_b + hi_a.hi_b by mma.sync
// m16n8k8 with fp32 accumulation, never as one TF32 product.  Both
// S = Q.K^T and O += P.V go this way; P is split like the inputs.  The
// tensor cores' fp32 accumulation truncates, so no accumulator is left to
// grow over a whole row: S is summed afresh for each key tile, its small
// products apart from the large ones; each tile's P.V is summed in fresh
// registers, small terms first, and added to O by an fp32 fma.  Summed
// straight into O over the 144 tiles of a 4608-key row, P.V was 5.2e-5
// off on a real gemma2-2b layer; this way it is a few 1e-6 (PERF.md).
//
// Bound on this card: operations.  At gemma2-2b's prefill (S = 4608, H = 8,
// D = 256, causal) the function is 4 * D * H operations for each of
// 10.6 M visible (q, k) pairs, 87 GFLOP.  In 3xTF32 that is 3 x 87 GFLOP
// on the tensor cores, 0.53 ms at 495 TFLOP/s (the row's bound_ms); in
// fp32 on the CUDA cores 1.30 ms at 67 TFLOP/s (bound_fp32_ms).  The bytes
// (q, k, v read once, out written once: 57 MB) take 0.02 ms.  mma.sync
// does not reach the 495 TFLOP/s of wgmma, and every operand costs five
// integer and fp32 instructions to split, so the kernel sits well above
// the bound (PERF.md).
//
// Design:
// * one CTA of 8 warps per (batch, head, 64-row query tile); the grid is
//   1-D, heaviest query tiles (the last, under the causal mask) first.
//   The Q tile stays in shared memory, split on the fly at each use.
// * K and V come in 32-key tiles, double-buffered with cp.async (16 B a
//   thread; 4 B when D is not a multiple of 4 or a pointer is not 16-byte
//   aligned; rows past Sk and columns past D are zero-filled by the copy),
//   so a tile's loads overlap the previous tile's products.  At D = 256:
//   Q 68 KB + K 2 x 34 KB + V 2 x 33 KB + P 9 KB = 212 KB, above the 48 KB
//   default, so the launch opts in once per instantiation (before any
//   graph capture).  Head dims are padded with zeros to 32, 64, 128 or 256.
// * S: warps 2s and 2s+1 own the 16-row stripe s; each takes all 32 keys
//   of the tile over one half of D (so each Q element is split by one warp
//   per tile, not two), and the two trade partial sums through shared
//   memory so that each holds the full scores of 16 keys.  The row max is
//   exchanged the same way (64-thread named barriers per pair); each warp
//   writes its probabilities and the rows' rescale factors to shared
//   memory and keeps its share of the denominators until the end.
// * P.V: after a CTA barrier each warp takes every row of the tile and
//   DP/8 of the output columns (at D = 256: 4 m-tiles x 4 n-tiles, 64 fp32
//   accumulators a lane, plus 32 for the tile's sum of two m-tiles at a
//   time), so each V element is split by one warp (once per pass of two
//   m-tiles) instead of by the four warps that would share a column range
//   if each took 16 rows, and 8 independent accumulators hide the mma
//   latency.
// * the masks are evaluated only in key tiles that some row of the stripe
//   cannot see whole (the causal diagonal, the window's edge, the end).
// * bank conflicts: D is a reduction index, so the k-slots of an m16n8k8
//   step are mapped onto d so that a lane reads 4 consecutive d with one
//   LDS.128 (Q and K rows padded to DP + 16 floats); likewise the output
//   columns of up to 4 n-tiles are mapped so that a lane reads its V values
//   with one load (V rows padded to DP + 8), and the epilogue undoes the
//   mapping.  P rows are padded to 36 floats.
// * with a non-null lse the forward also writes each row's log-sum-exp,
//   m + log(l), for the backward (+inf on a row that sees no key).
//
// Backward (for training; the reference has no Pallas backward: JAX
// differentiates its jnp attention, layers.multi_head_attention).  From q,
// k, v, o, the forward's lse and dO, with the forward's semantics:
//   P  = exp(s - lse)                 s scaled and softcapped, 0 if masked
//   dV = P^T dO        dP = dO V^T    delta = rowsum(dO * O)
//   dS = P * (dP - delta) * (1 - tanh^2(s_raw * scale / cap))  [softcap]
//   dQ = scale * dS K  dK = scale * dS^T Q
// GQA sums the group's query heads into their KV head.  A row that sees no
// key has lse = +inf, so P = 0 and its gradients are 0.  fp32 in and out.
// Arithmetic: fp32 on the CUDA cores (fmaf), no TF32 product.  It is a
// first, simple kernel: the 5 products (S, dP, dV, dK, dQ) over the
// visible pairs are 10 * D * H operations a pair, 171.8 GFLOP at
// qwen3-0.6b's layer (S = 4096, H = 16, D = 128, causal), 2.56 ms at the
// 67 TFLOP/s fp32 rate; shared-memory reads of the tiles bound the inner
// loops well above that (PERF.md has the times).  Two kernels, no atomics,
// so a result does not depend on the schedule:
// * dq: one CTA of 8 warps per (batch, head, query tile of BT rows); it
//   computes delta for its rows (one warp a row) and writes it out, then
//   walks the key tiles its rows can see, recomputing S and dP.
// * dk/dv: one CTA per (batch, KV head, key tile); it keeps the tile's K
//   and V and its dK, dV accumulators (BT x D each, in registers) and walks
//   the group's query heads and the query tiles that can see the tile.
// BT = 64 (32 at D = 256); both kernels hold Q, dO, K, V tiles and the
// tile's P and dS in shared memory (165 KB at D = 128, 139 KB at 256),
// opted in once per instantiation as the forward is.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 32;        // keys per tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPP = kBK + 4;   // P row stride
constexpr float kNegInf = -1e30f;
#define kPosInf __int_as_float(0x7f800000)

template <int DP>
struct Layout {
  static constexpr int QP = DP + 16;   // Q and K row stride (words)
  static constexpr int VP = DP + 8;    // V row stride
  static constexpr int kQ = kBQ * QP;
  static constexpr int kK = kBK * QP;
  static constexpr int kV = kBK * VP;
  static constexpr size_t bytes =
      sizeof(float) * (size_t)(kQ + 2 * kK + 2 * kV + kBQ * kPP + 3 * kBQ);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void pair_barrier(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

// rows x DP floats of a (.., D) row-major source at `rs` elements a row
// into shared memory at `stride` floats a row; rows >= nvalid and columns
// >= D become 0.  fp32 through cp.async; bf16 converted through registers.
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const float* src, long long rs,
                                          int rows, int nvalid, int D,
                                          bool vec, int tid) {
  if (vec) {
    constexpr int C4 = DP / 4;
    for (int i = tid; i < rows * C4; i += kThreads) {
      const int r = i / C4, c = (i % C4) * 4;
      const bool in = r < nvalid && c < D;
      cp_async16(dst + r * stride + c, in ? src + r * rs + c : src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < rows * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      const bool in = r < nvalid && c < D;
      cp_async4(dst + r * stride + c, in ? src + r * rs + c : src,
                in ? 4 : 0);
    }
  }
}
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const __nv_bfloat16* src,
                                          long long rs, int rows, int nvalid,
                                          int D, bool, int tid) {
  for (int i = tid; i < rows * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    dst[r * stride + c] =
        r < nvalid && c < D ? __bfloat162float(src[r * rs + c]) : 0.f;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// cvt.rna.tf32.f32: round to 10 mantissa bits, to nearest with ties away
// from zero.  For finite x (+-inf stays itself) that is adding half an ulp
// of TF32 to the sign-magnitude bits and clearing the 13 low bits: two
// integer operations, where the cvt instruction compiles to a longer
// sequence on sm_90 (flash_ablation.py times the two).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a . b, one m16n8k8 TF32 product with fp32 accumulation
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// an operand fragment split for the 3xTF32 product
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2,
                                      float a3) {
    split(a0, hi[0], lo[0]);
    split(a1, hi[1], lo[1]);
    split(a2, hi[2], lo[2]);
    split(a3, hi[3], lo[3]);
  }
};
struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split(b0, hi[0], lo[0]);
    split(b1, hi[1], lo[1]);
  }
};

// W consecutive floats from shared memory (W = 1, 2 or 4)
template <int W>
__device__ __forceinline__ void lds(float (&x)[W], const float* p) {
  if constexpr (W == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
  } else if constexpr (W == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    x[0] = f.x; x[1] = f.y;
  } else {
    x[0] = *p;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ out,
                float* __restrict__ lse, int B, int Sq, int Sk, int H,
                int KV, int D, int causal, int window, float softcap,
                float scale, bool vec) {
  using L = Layout<DP>;
  constexpr int QP = L::QP, VP = L::VP;
  // S: warps 2s and 2s+1 own the 16-row stripe s and split D in halves
  constexpr int DH = DP / 2;
  // P.V: CG column groups x RG row groups of warps; a warp owns MT m-tiles
  // (R rows) x NW n-tiles (C columns); W n-tiles share one V load
  constexpr int CG = DP / 8 < kWarps ? DP / 8 : kWarps;
  constexpr int RG = kWarps / CG;
  constexpr int R = kBQ / RG, C = DP / CG;
  constexpr int MT = R / 16, NW = C / 8;
  constexpr int W = NW < 4 ? NW : 4;
  constexpr int MP = MT * NW <= 8 ? MT : 2;   // m-tiles per P.V pass
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + L::kQ;                    // 2 buffers
  float* Vs = Ks + 2 * L::kK;                // 2 buffers
  float* Ps = Vs + 2 * L::kV;                // kBQ x kPP: partial S, then P
  float* red = Ps + kBQ * kPP;               // kBQ x 2: one value per warp
  float* rowv = red + 2 * kBQ;               // kBQ: corr, then the sums

  const int nq = (Sq + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % (B * H);
  const int qt = nq - 1 - (int)(blockIdx.x / (B * H));
  const int b = bh / H, h = bh % H;
  const int g = h / (H / KV);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;   // mma groupID, thread in group
  // softmax role: rows r_lo and r_lo + 8 of the tile, keys half*16 .. +16
  const int stripe = warp >> 1, half = warp & 1;
  const int r_lo = stripe * 16 + gq;
  // P.V role: rows rg*R .., columns cg*C ..
  const int cg = warp % CG, rg = warp / CG;

  const long long kv_rs = (long long)KV * D;
  const T* kg = k + ((long long)b * Sk * KV + g) * D;
  const T* vg = v + ((long long)b * Sk * KV + g) * D;
  load_tile<DP>(Qs, QP, q + (((long long)b * Sq + q0) * H + h) * D,
                (long long)H * D, kBQ, min(kBQ, Sq - q0), D, vec, tid);
  cp_async_commit();

  // the key range any row of this tile can see
  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(Sk, q0 + kBQ);
  if (window > 0) k_begin = max(0, q0 - window + 1);
  const int t_begin = k_begin / kBK;
  const int t_end = (k_end + kBK - 1) / kBK;
  if (t_begin < t_end) {
    const int k0 = t_begin * kBK;
    load_tile<DP>(Ks, QP, kg + k0 * kv_rs, kv_rs, kBK, min(kBK, Sk - k0), D,
                  vec, tid);
    load_tile<DP>(Vs, VP, vg + k0 * kv_rs, kv_rs, kBK, min(kBK, Sk - k0), D,
                  vec, tid);
    cp_async_commit();
  }

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};   // this thread's share of the denominators
  float acc[MT][NW][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NW; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    cp_async_wait_all();
    __syncthreads();   // tile t is in; every warp is done with tile t - 1
    if (t + 1 < t_end) {
      const int k1 = (t + 1) * kBK;
      load_tile<DP>(Ks + (buf ^ 1) * L::kK, QP, kg + k1 * kv_rs, kv_rs, kBK,
                    min(kBK, Sk - k1), D, vec, tid);
      load_tile<DP>(Vs + (buf ^ 1) * L::kV, VP, vg + k1 * kv_rs, kv_rs, kBK,
                    min(kBK, Sk - k1), D, vec, tid);
      cp_async_commit();
    }
    const float* Kb = Ks + buf * L::kK;
    const float* Vb = Vs + buf * L::kV;

    // Partial S = Q . K^T of rows r_lo, r_lo + 8 against the tile's 32
    // keys (n-tiles jj = 0..3) over d in [half*DH, half*DH + DH).  The
    // k-slots (tq, tq + 4) of the first m16n8k8 step (p = 0) are
    // d0 + 4tq + (0, 1), of the second (p = 1) d0 + 4tq + (2, 3).  The
    // small products (lo.hi, hi.lo) and the large ones (hi.hi) go to
    // separate accumulators; the small sums are added first.
    float sl[4][4], sh[4][4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) sl[jj][e] = sh[jj][e] = 0.f;
#pragma unroll 4
    for (int d0 = half * DH; d0 < half * DH + DH; d0 += 16) {
      const float4 qa =
          *reinterpret_cast<const float4*>(&Qs[r_lo * QP + d0 + 4 * tq]);
      const float4 qb = *reinterpret_cast<const float4*>(
          &Qs[(r_lo + 8) * QP + d0 + 4 * tq]);
      FragA a[2];
      a[0].set(qa.x, qb.x, qa.y, qb.y);
      a[1].set(qa.z, qb.z, qa.w, qb.w);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float4 kk = *reinterpret_cast<const float4*>(
            &Kb[(jj * 8 + gq) * QP + d0 + 4 * tq]);
        FragB b0, b1;
        b0.set(kk.x, kk.y);
        b1.set(kk.z, kk.w);
        mma_tf32(sl[jj], a[0].lo, b0.hi);
        mma_tf32(sl[jj], a[1].lo, b1.hi);
        mma_tf32(sl[jj], a[0].hi, b0.lo);
        mma_tf32(sl[jj], a[1].hi, b1.lo);
        mma_tf32(sh[jj], a[0].hi, b0.hi);
        mma_tf32(sh[jj], a[1].hi, b1.hi);
      }
    }
    // trade halves with the pair's other warp: it gets this warp's sums
    // for its 16 keys, this warp gets its sums for this warp's 16 keys.
    // sl/sh[jj][e] is row r_lo + 8 * (e >> 1), key 8jj + 2tq + (e & 1);
    // the registers are picked by select, not by a runtime index (which
    // would put the arrays in local memory).
    float s[2][4];   // row r_lo + 8 * (e >> 1), key half*16 + 8j + 2tq + (e & 1)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float theirs[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float first = sl[j][e] + sh[j][e];
        const float second = sl[2 + j][e] + sh[2 + j][e];
        s[j][e] = half ? second : first;
        theirs[e] = half ? first : second;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(
            &Ps[(r_lo + 8 * r) * kPP + (half ^ 1) * 16 + j * 8 + 2 * tq]) =
            make_float2(theirs[2 * r], theirs[2 * r + 1]);
    }
    pair_barrier(1 + stripe);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 o = *reinterpret_cast<const float2*>(
            &Ps[(r_lo + 8 * r) * kPP + half * 16 + j * 8 + 2 * tq]);
        s[j][2 * r] += o.x;
        s[j][2 * r + 1] += o.y;
      }
    }

    // scale, softcap, mask, the row max over both warps of the pair
    const int k0 = t * kBK;
    // every key of the tile visible to every row of the stripe: no masks
    const int row0 = q0 + stripe * 16;
    const bool whole = k0 + kBK <= Sk && (!causal || k0 + kBK - 1 <= row0) &&
                       (window <= 0 || k0 > row0 + 15 - window);
    bool ok[2][4];
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = q0 + r_lo + 8 * (e >> 1);
        const int kp = k0 + half * 16 + j * 8 + 2 * tq + (e & 1);
        float x = s[j][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool valid = true;
        if (!whole) {
          valid = kp < Sk;
          if (causal) valid = valid && kp <= qp;
          if (window > 0) valid = valid && kp > qp - window;
        }
        ok[j][e] = valid;
        s[j][e] = valid ? x : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      if (tq == 0) red[(r_lo + 8 * r) * 2 + half] = mx[r];
    }
    pair_barrier(1 + stripe);   // maxima in; the partial sums are read
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r_lo + 8 * r;
      const float m_new =
          fmaxf(m[r], fmaxf(red[row * 2], red[row * 2 + 1]));
      const float corr = expf(m[r] - m_new);
      if (half == 0 && tq == 0) rowv[row] = corr;
      m[r] = m_new;
      l[r] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float p0 = ok[j][2 * r] ? expf(s[j][2 * r] - m[r]) : 0.f;
        const float p1 =
            ok[j][2 * r + 1] ? expf(s[j][2 * r + 1] - m[r]) : 0.f;
        l[r] += p0 + p1;
        *reinterpret_cast<float2*>(
            &Ps[(r_lo + 8 * r) * kPP + half * 16 + j * 8 + 2 * tq]) =
            make_float2(p0, p1);
      }
    }
    __syncthreads();   // P and the row corrections are whole

    // O = O * corr + P . V for rows rg*R + 16i (+ gq, + gq + 8) and this
    // warp's C columns.  The tile's P . V is summed in fresh registers and
    // added to O with one fp32 fma per element: the tensor cores'
    // accumulation truncates, and summed into O across every tile of a
    // long row its bias grows with the number of tiles (5e-5 at 4608
    // keys), while within a tile it stays at a few ulp.  MP m-tiles per
    // pass bound the extra registers.  n-tile c + w (w < W) reads, at
    // n = gq, column cg*C + (c / W) * 8W + gq * W + w: a lane's W values
    // are adjacent.
#pragma unroll
    for (int i0 = 0; i0 < MT; i0 += MP) {
      float tacc[MP][NW][4];
#pragma unroll
      for (int i = 0; i < MP; ++i)
#pragma unroll
        for (int j = 0; j < NW; ++j)
          tacc[i][j][0] = tacc[i][j][1] = tacc[i][j][2] = tacc[i][j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 8) {
        FragA a[MP];
#pragma unroll
        for (int i = 0; i < MP; ++i) {
          const float* p0 =
              &Ps[(rg * R + 16 * (i0 + i) + gq) * kPP + kk + tq];
          const float* p1 = p0 + 8 * kPP;
          a[i].set(p0[0], p1[0], p0[4], p1[4]);
        }
#pragma unroll
        for (int c = 0; c < NW; c += W) {
          const int col = cg * C + (c / W) * 8 * W + gq * W;
          float v0[W], v1[W];
          lds<W>(v0, &Vb[(kk + tq) * VP + col]);
          lds<W>(v1, &Vb[(kk + tq + 4) * VP + col]);
          FragB bf[W];
#pragma unroll
          for (int w = 0; w < W; ++w) bf[w].set(v0[w], v1[w]);
          // each product's small terms first, issued across the MP x W
          // independent accumulators
#pragma unroll
          for (int i = 0; i < MP; ++i)
#pragma unroll
            for (int w = 0; w < W; ++w)
              mma_tf32(tacc[i][c + w], a[i].lo, bf[w].hi);
#pragma unroll
          for (int i = 0; i < MP; ++i)
#pragma unroll
            for (int w = 0; w < W; ++w)
              mma_tf32(tacc[i][c + w], a[i].hi, bf[w].lo);
#pragma unroll
          for (int i = 0; i < MP; ++i)
#pragma unroll
            for (int w = 0; w < W; ++w)
              mma_tf32(tacc[i][c + w], a[i].hi, bf[w].hi);
        }
      }
#pragma unroll
      for (int i = 0; i < MP; ++i) {
        const int row = rg * R + 16 * (i0 + i) + gq;
        const float c0 = rowv[row], c1 = rowv[row + 8];
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          acc[i0 + i][j][0] = fmaf(acc[i0 + i][j][0], c0, tacc[i][j][0]);
          acc[i0 + i][j][1] = fmaf(acc[i0 + i][j][1], c0, tacc[i][j][1]);
          acc[i0 + i][j][2] = fmaf(acc[i0 + i][j][2], c1, tacc[i][j][2]);
          acc[i0 + i][j][3] = fmaf(acc[i0 + i][j][3], c1, tacc[i][j][3]);
        }
      }
    }
  }
  cp_async_wait_all();

  // denominators: the 4 threads of a row, then the two warps of the pair
  // (red was last read before the last tile's __syncthreads)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (tq == 0) red[(r_lo + 8 * r) * 2 + half] = l[r];
  }
  __syncthreads();   // also: every warp is done reading rowv
  if (tid < kBQ) rowv[tid] = fmaxf(red[tid * 2] + red[tid * 2 + 1], 1e-30f);
  __syncthreads();
  // the row log-sum-exp m + log(l) for the backward, in the scaled and
  // softcapped units of s; +inf where the row sees no key (l = 0), so that
  // every exp(s - lse) of that row is 0
  if (lse != nullptr && half == 0 && tq == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r_lo + 8 * r;
      const float lsum = red[row * 2] + red[row * 2 + 1];
      if (q0 + row < Sq)
        lse[((long long)b * H + h) * Sq + q0 + row] =
            lsum > 0.f ? m[r] + logf(lsum) : kPosInf;
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rg * R + 16 * i + gq + 8 * r;
      const int qp = q0 + row;
      if (qp >= Sq) continue;
      const float denom = rowv[row];
      T* orow = out + (((long long)b * Sq + qp) * H + h) * D;
      // acc[i][c + w][2r + e] is column cg*C + (c/W)*8W + (2tq + e)*W + w
#pragma unroll
      for (int c = 0; c < NW; c += W) {
        const int col = cg * C + (c / W) * 8 * W + 2 * tq * W;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int w = 0; w < W; ++w) {
            const int d = col + e * W + w;
            if (d < D) store(orow + d, acc[i][c + w][2 * r + e] / denom);
          }
        }
      }
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int Sq, int Sk, int H, int KV, int D,
           int causal, int window, float softcap, cudaStream_t stream) {
  constexpr size_t smem = Layout<DP>::bytes;
  static bool attribute_set = false;   // once per instantiation, before any
  if (!attribute_set) {                // graph capture (warm-up calls)
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  // 16-byte cp.async needs every row start 16-byte aligned
  const bool vec = D % 4 == 0 && (((uintptr_t)q | (uintptr_t)k |
                                   (uintptr_t)v) % 16 == 0);
  const long long nq = (Sq + kBQ - 1) / kBQ;
  const long long grid = nq * B * H;
  flash_fwd_kernel<T, DP><<<(unsigned)grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, B, Sq, Sk, H, KV,
      D, causal, window, softcap, (float)(1.0 / sqrt((double)D)), vec);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             float* lse, int B, int Sq, int Sk, int H, int KV, int D,
             int causal, int window, float softcap, cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 32>(q, k, v, out, lse, B, Sq, Sk, H, KV, D, causal,
                         window, softcap, stream);
  if (D <= 64)
    return launch<T, 64>(q, k, v, out, lse, B, Sq, Sk, H, KV, D, causal,
                         window, softcap, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, out, lse, B, Sq, Sk, H, KV, D, causal,
                          window, softcap, stream);
  return launch<T, 256>(q, k, v, out, lse, B, Sq, Sk, H, KV, D, causal,
                        window, softcap, stream);
}

// ---------------------------------------------------------------------------
// Backward: dq, dk, dv of the forward's function, from q, k, v, o, the
// forward's row log-sum-exp and dO.  fp32 on the CUDA cores (see the file's
// head).  A tile is BT query rows or BT keys; Q, dO, K, V tiles sit in
// shared memory at row stride DP + 4 (a float4 read by 8 lanes of
// consecutive rows hits 8 distinct 16-byte bank groups), P and dS tiles at
// BT + 1.
// ---------------------------------------------------------------------------
template <int DP>
struct Bwd {
  static constexpr int BT = DP == 256 ? 32 : 64;
  static constexpr int RS = DP + 4;
  static constexpr int PS = BT + 1;
  static constexpr int SA = BT / 16;               // S micro-tile: SA x SA
  static constexpr int TX = DP / 4 < 16 ? DP / 4 : 16;  // float4 columns
  static constexpr int TY = kThreads / TX;
  static constexpr int RA = BT / TY;               // accumulator rows
  static constexpr int CA = DP / (4 * TX);         // accumulator float4s
  static_assert(RA * TY == BT && CA * 4 * TX == DP, "backward tiling");
  static constexpr size_t bytes =
      sizeof(float) * (size_t)(4 * BT * RS + 2 * BT * PS + 2 * BT);
};

// BT rows of D floats at `rs` floats a row into shared memory at row
// stride RS; rows >= nvalid and columns >= D become 0
template <int DP>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long rs, int nvalid, int D,
                                          bool vec, int tid) {
  constexpr int BT = Bwd<DP>::BT, RS = Bwd<DP>::RS;
  if (vec) {
    constexpr int C4 = DP / 4;
    for (int i = tid; i < BT * C4; i += kThreads) {
      const int r = i / C4, c = (i % C4) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < nvalid && c < D)
        x = *reinterpret_cast<const float4*>(src + r * rs + c);
      *reinterpret_cast<float4*>(dst + r * RS + c) = x;
    }
  } else {
    for (int i = tid; i < BT * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      dst[r * RS + c] = r < nvalid && c < D ? src[r * rs + c] : 0.f;
    }
  }
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& x) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}
__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// S = Q.K^T and dP = dO.V^T of one (query tile, key tile) pair, then
//   P  = exp(cap(S * scale) - lse)                 0 where masked
//   dS = P * (dP - delta) * (1 - tanh^2)           the softcap's factor
// into Ps and dSs.  Thread (ty, tx) of a 16 x 16 grid owns rows ty + 16a
// and keys tx + 16c.
template <int DP>
__device__ __forceinline__ void bwd_scores(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const float* lse_s, const float* delta_s, float* Ps, float* dSs, int q0,
    int k0, int Sq, int Sk, int causal, int window, float softcap,
    float scale, int tid) {
  constexpr int RS = Bwd<DP>::RS, PS = Bwd<DP>::PS, SA = Bwd<DP>::SA;
  const int ty = tid / 16, tx = tid % 16;
  float s[SA][SA], dp[SA][SA];
#pragma unroll
  for (int a = 0; a < SA; ++a)
#pragma unroll
    for (int c = 0; c < SA; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 2
  for (int d = 0; d < DP; d += 4) {
    float4 qa[SA], oa[SA];
#pragma unroll
    for (int a = 0; a < SA; ++a) {
      qa[a] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * a) * RS + d]);
      oa[a] = *reinterpret_cast<const float4*>(&dOs[(ty + 16 * a) * RS + d]);
    }
#pragma unroll
    for (int c = 0; c < SA; ++c) {
      const float4 kb =
          *reinterpret_cast<const float4*>(&Ks[(tx + 16 * c) * RS + d]);
      const float4 vb =
          *reinterpret_cast<const float4*>(&Vs[(tx + 16 * c) * RS + d]);
#pragma unroll
      for (int a = 0; a < SA; ++a) {
        s[a][c] = dot4(qa[a], kb, s[a][c]);
        dp[a][c] = dot4(oa[a], vb, dp[a][c]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < SA; ++a) {
#pragma unroll
    for (int c = 0; c < SA; ++c) {
      const int i = ty + 16 * a, j = tx + 16 * c;
      const int qp = q0 + i, kp = k0 + j;
      bool valid = qp < Sq && kp < Sk;
      if (causal) valid = valid && kp <= qp;
      if (window > 0) valid = valid && kp > qp - window;
      float p = 0.f, g = 0.f;
      if (valid) {
        float x = s[a][c] * scale;
        float dcap = 1.f;
        if (softcap > 0.f) {
          const float t = tanhf(x / softcap);
          x = softcap * t;
          dcap = 1.f - t * t;
        }
        p = expf(x - lse_s[i]);
        g = p * (dp[a][c] - delta_s[i]) * dcap;
      }
      Ps[i * PS + j] = p;
      dSs[i * PS + j] = g;
    }
  }
}

// one CTA per (batch, head, query tile), heaviest tiles first: delta =
// rowsum(dO * O) (also written out for the dk/dv kernel), then
// dq = scale * sum over the visible key tiles of dS . K
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ o,
                    const float* __restrict__ lse,
                    const float* __restrict__ dout, float* __restrict__ dq,
                    float* __restrict__ delta, int B, int Sq, int Sk, int H,
                    int KV, int D, int causal, int window, float softcap,
                    float scale, bool vec) {
  using C = Bwd<DP>;
  constexpr int BT = C::BT, RS = C::RS, PS = C::PS, TX = C::TX, TY = C::TY,
                RA = C::RA, CA = C::CA;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + BT * RS;
  float* Ks = dOs + BT * RS;
  float* Vs = Ks + BT * RS;
  float* Ps = Vs + BT * RS;
  float* dSs = Ps + BT * PS;
  float* lse_s = dSs + BT * PS;
  float* delta_s = lse_s + BT;

  const int nq = (Sq + BT - 1) / BT;
  const int bh = blockIdx.x % (B * H);
  const int qt = nq - 1 - (int)(blockIdx.x / (B * H));
  const int b = bh / H, h = bh % H, g = h / (H / KV);
  const int q0 = qt * BT, nrows = min(BT, Sq - q0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long q_rs = (long long)H * D, kv_rs = (long long)KV * D;
  const long long qoff = (((long long)b * Sq + q0) * H + h) * D;
  const long long roff = ((long long)b * H + h) * Sq + q0;
  load_rows<DP>(Qs, q + qoff, q_rs, nrows, D, vec, tid);
  load_rows<DP>(dOs, dout + qoff, q_rs, nrows, D, vec, tid);
  for (int i = tid; i < BT; i += kThreads)
    lse_s[i] = i < nrows ? lse[roff + i] : 0.f;
  __syncthreads();
  for (int i = warp; i < BT; i += kWarps) {
    float acc = 0.f;
    if (i < nrows)
      for (int d = lane; d < D; d += 32)
        acc = fmaf(dOs[i * RS + d], o[qoff + i * q_rs + d], acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      delta_s[i] = acc;
      if (i < nrows) delta[roff + i] = acc;
    }
  }

  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(Sk, q0 + BT);
  if (window > 0) k_begin = max(0, q0 - window + 1);
  const int ay = tid / TX, ax = tid % TX;
  float4 acc[RA][CA];
#pragma unroll
  for (int r = 0; r < RA; ++r)
#pragma unroll
    for (int c = 0; c < CA; ++c) acc[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = (k_begin / BT) * BT; k0 < k_end; k0 += BT) {
    __syncthreads();   // every warp is done with the last tile (and delta)
    const long long koff = (((long long)b * Sk + k0) * KV + g) * D;
    load_rows<DP>(Ks, k + koff, kv_rs, min(BT, Sk - k0), D, vec, tid);
    load_rows<DP>(Vs, v + koff, kv_rs, min(BT, Sk - k0), D, vec, tid);
    __syncthreads();
    bwd_scores<DP>(Qs, dOs, Ks, Vs, lse_s, delta_s, Ps, dSs, q0, k0, Sq, Sk,
                   causal, window, softcap, scale, tid);
    __syncthreads();
    for (int j = 0; j < BT; ++j) {
      float gr[RA];
#pragma unroll
      for (int r = 0; r < RA; ++r) gr[r] = dSs[(ay + TY * r) * PS + j];
#pragma unroll
      for (int c = 0; c < CA; ++c) {
        const float4 kv =
            *reinterpret_cast<const float4*>(&Ks[j * RS + 4 * (ax + TX * c)]);
#pragma unroll
        for (int r = 0; r < RA; ++r) fma4(acc[r][c], gr[r], kv);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RA; ++r) {
    const int row = ay + TY * r;
    if (row >= nrows) continue;
    float* dst = dq + qoff + row * q_rs;
#pragma unroll
    for (int c = 0; c < CA; ++c) {
      const int col = 4 * (ax + TX * c);
      const float e[4] = {acc[r][c].x, acc[r][c].y, acc[r][c].z,
                          acc[r][c].w};
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (col + t < D) dst[col + t] = e[t] * scale;
    }
  }
}

// one CTA per (batch, KV head, key tile), the first (heaviest under the
// causal mask) tiles first: over the group's query heads and the query
// tiles that can see the tile, dv = sum P^T . dO and dk = scale * sum
// dS^T . Q; the group's heads are summed inside the CTA, in order (no
// atomics: the result does not depend on the schedule)
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const float* __restrict__ dout, float* __restrict__ dk,
                      float* __restrict__ dv, int B, int Sq, int Sk, int H,
                      int KV, int D, int causal, int window, float softcap,
                      float scale, bool vec) {
  using C = Bwd<DP>;
  constexpr int BT = C::BT, RS = C::RS, PS = C::PS, TX = C::TX, TY = C::TY,
                RA = C::RA, CA = C::CA;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + BT * RS;
  float* Ks = dOs + BT * RS;
  float* Vs = Ks + BT * RS;
  float* Ps = Vs + BT * RS;
  float* dSs = Ps + BT * PS;
  float* lse_s = dSs + BT * PS;
  float* delta_s = lse_s + BT;

  const int bg = blockIdx.x % (B * KV);
  const int kt = (int)(blockIdx.x / (B * KV));
  const int b = bg / KV, g = bg % KV, G = H / KV;
  const int k0 = kt * BT, nkeys = min(BT, Sk - k0);
  const int tid = threadIdx.x;
  const long long q_rs = (long long)H * D, kv_rs = (long long)KV * D;
  const long long koff = (((long long)b * Sk + k0) * KV + g) * D;
  load_rows<DP>(Ks, k + koff, kv_rs, nkeys, D, vec, tid);
  load_rows<DP>(Vs, v + koff, kv_rs, nkeys, D, vec, tid);

  // the query rows that see some key of this tile
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(Sq, k0 + nkeys - 1 + window) : Sq;
  const int ay = tid / TX, ax = tid % TX;
  float4 dka[RA][CA], dva[RA][CA];
#pragma unroll
  for (int r = 0; r < RA; ++r)
#pragma unroll
    for (int c = 0; c < CA; ++c)
      dka[r][c] = dva[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int hh = 0; hh < G; ++hh) {
    const int h = g * G + hh;
    for (int q0 = (q_begin / BT) * BT; q0 < q_end; q0 += BT) {
      const int nrows = min(BT, Sq - q0);
      const long long qoff = (((long long)b * Sq + q0) * H + h) * D;
      const long long roff = ((long long)b * H + h) * Sq + q0;
      __syncthreads();   // every warp is done with the last query tile
      load_rows<DP>(Qs, q + qoff, q_rs, nrows, D, vec, tid);
      load_rows<DP>(dOs, dout + qoff, q_rs, nrows, D, vec, tid);
      for (int i = tid; i < BT; i += kThreads) {
        lse_s[i] = i < nrows ? lse[roff + i] : 0.f;
        delta_s[i] = i < nrows ? delta[roff + i] : 0.f;
      }
      __syncthreads();
      bwd_scores<DP>(Qs, dOs, Ks, Vs, lse_s, delta_s, Ps, dSs, q0, k0, Sq,
                     Sk, causal, window, softcap, scale, tid);
      __syncthreads();
      for (int i = 0; i < BT; ++i) {
        float p[RA], gr[RA];
#pragma unroll
        for (int r = 0; r < RA; ++r) {
          p[r] = Ps[i * PS + ay + TY * r];
          gr[r] = dSs[i * PS + ay + TY * r];
        }
#pragma unroll
        for (int c = 0; c < CA; ++c) {
          const int col = 4 * (ax + TX * c);
          const float4 ov = *reinterpret_cast<const float4*>(&dOs[i * RS + col]);
          const float4 qv = *reinterpret_cast<const float4*>(&Qs[i * RS + col]);
#pragma unroll
          for (int r = 0; r < RA; ++r) {
            fma4(dva[r][c], p[r], ov);
            fma4(dka[r][c], gr[r], qv);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RA; ++r) {
    const int row = ay + TY * r;
    if (row >= nkeys) continue;
    float* dkr = dk + koff + row * kv_rs;
    float* dvr = dv + koff + row * kv_rs;
#pragma unroll
    for (int c = 0; c < CA; ++c) {
      const int col = 4 * (ax + TX * c);
      const float ek[4] = {dka[r][c].x, dka[r][c].y, dka[r][c].z,
                           dka[r][c].w};
      const float ev[4] = {dva[r][c].x, dva[r][c].y, dva[r][c].z,
                           dva[r][c].w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (col + t < D) {
          dkr[col + t] = ek[t] * scale;
          dvr[col + t] = ev[t];
        }
      }
    }
  }
}

struct BwdArgs {
  const float *q, *k, *v, *o, *lse, *dout;
  float *dq, *dk, *dv, *delta;
  int B, Sq, Sk, H, KV, D, causal, window;
  float softcap;
};

// 16-byte loads need every row start 16-byte aligned
inline bool bwd_vec(const BwdArgs& a) {
  const uintptr_t p = (uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v |
                      (uintptr_t)a.o | (uintptr_t)a.dout;
  return a.D % 4 == 0 && p % 16 == 0;
}

template <int DP>
int launch_bwd_dq(const BwdArgs& a, cudaStream_t stream) {
  constexpr size_t smem = Bwd<DP>::bytes;
  static bool attribute_set = false;   // once per instantiation, before any
  if (!attribute_set) {                // graph capture (warm-up calls)
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  const long long nq = (a.Sq + Bwd<DP>::BT - 1) / Bwd<DP>::BT;
  flash_bwd_dq_kernel<DP><<<(unsigned)(nq * a.B * a.H), kThreads, smem,
                            stream>>>(
      a.q, a.k, a.v, a.o, a.lse, a.dout, a.dq, a.delta, a.B, a.Sq, a.Sk, a.H,
      a.KV, a.D, a.causal, a.window, a.softcap,
      (float)(1.0 / sqrt((double)a.D)), bwd_vec(a));
  return (int)cudaGetLastError();
}

template <int DP>
int launch_bwd_dkdv(const BwdArgs& a, cudaStream_t stream) {
  constexpr size_t smem = Bwd<DP>::bytes;
  static bool attribute_set = false;
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  const long long nk = (a.Sk + Bwd<DP>::BT - 1) / Bwd<DP>::BT;
  flash_bwd_dkdv_kernel<DP><<<(unsigned)(nk * a.B * a.KV), kThreads, smem,
                              stream>>>(
      a.q, a.k, a.v, a.lse, a.delta, a.dout, a.dk, a.dv, a.B, a.Sq, a.Sk,
      a.H, a.KV, a.D, a.causal, a.window, a.softcap,
      (float)(1.0 / sqrt((double)a.D)), bwd_vec(a));
  return (int)cudaGetLastError();
}

template <int (*F32)(const BwdArgs&, cudaStream_t),
          int (*F64)(const BwdArgs&, cudaStream_t),
          int (*F128)(const BwdArgs&, cudaStream_t),
          int (*F256)(const BwdArgs&, cudaStream_t)>
int dispatch_bwd(const BwdArgs& a, void* stream) {
  if (a.D < 1 || a.D > 256 || a.KV < 1 || a.H % a.KV != 0)
    return (int)cudaErrorInvalidValue;
  if (a.B <= 0 || a.Sq <= 0 || a.Sk <= 0 || a.H <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (a.D <= 32) return F32(a, s);
  if (a.D <= 64) return F64(a, s);
  if (a.D <= 128) return F128(a, s);
  return F256(a, s);
}

}  // namespace

// q (B, Sq, H, D), k and v (B, Sk, KV, D), out (B, Sq, H, D), all
// contiguous; dtype 0 = float32, 1 = bfloat16.  lse, when not null, is
// (B, H, Sq) float32: each row's log-sum-exp for the backward (null when
// serving).  The caller checks 1 <= D <= 256, H % KV == 0 and
// B, Sq, Sk >= 1.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, void* lse,
                                     int B, int Sq, int Sk, int H, int KV,
                                     int D, int causal, int window,
                                     float softcap, int dtype,
                                     void* stream) {
  if (D < 1 || D > 256 || KV < 1 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  float* l = (float*)lse;
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, l, B, Sq, Sk, H, KV, D, causal,
                           window, softcap, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, l, B, Sq, Sk, H, KV, D,
                                   causal, window, softcap, s);
  return (int)cudaErrorInvalidValue;
}

// The backward, in two launches on one stream: first the dq kernel, which
// also writes delta (B, H, Sq), then the dk/dv kernel, which reads it.  All
// float32 and contiguous: q, o, dout, dq (B, Sq, H, D); k, v, dk, dv
// (B, Sk, KV, D); lse (the forward's) and delta (B, H, Sq).
extern "C" int repro_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* delta, int B, int Sq,
    int Sk, int H, int KV, int D, int causal, int window, float softcap,
    void* stream) {
  const BwdArgs a{(const float*)q, (const float*)k, (const float*)v,
                  (const float*)o, (const float*)lse, (const float*)dout,
                  (float*)dq, nullptr, nullptr, (float*)delta, B, Sq, Sk, H,
                  KV, D, causal, window, softcap};
  return dispatch_bwd<launch_bwd_dq<32>, launch_bwd_dq<64>,
                      launch_bwd_dq<128>, launch_bwd_dq<256>>(a, stream);
}

extern "C" int repro_flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* lse,
    const void* delta, const void* dout, void* dk, void* dv, int B, int Sq,
    int Sk, int H, int KV, int D, int causal, int window, float softcap,
    void* stream) {
  const BwdArgs a{(const float*)q, (const float*)k, (const float*)v, nullptr,
                  (const float*)lse, (const float*)dout, nullptr, (float*)dk,
                  (float*)dv, (float*)delta, B, Sq, Sk, H, KV, D, causal,
                  window, softcap};
  return dispatch_bwd<launch_bwd_dkdv<32>, launch_bwd_dkdv<64>,
                      launch_bwd_dkdv<128>, launch_bwd_dkdv<256>>(a, stream);
}
