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
// Two kernels, no atomics, so a result does not depend on the schedule
// (two calls give the same bits); each recomputes S and dP, so the pair
// computes seven products where the function has five:
// * dq: one CTA per (batch, head, query tile of BR rows), heaviest tiles
//   first; it writes delta for its rows and walks the key tiles its rows
//   can see: S = Q K^T, dP = dO V^T, dS, dQ += dS K.
// * dk/dv: one CTA per (batch, KV head, key tile of BR keys), the first
//   (heaviest under the causal mask) tiles first; it walks the group's
//   query heads in order and, for each, the query tiles that see the key
//   tile: S^T = K Q^T, dP^T = V dO^T, P^T and dS^T, dV += P^T dO,
//   dK += dS^T Q.
// Arithmetic: every product in 3xTF32 on the tensor cores (mma.sync
// m16n8k8, the forward's split and helpers).  The accumulation follows the
// forward's rule: S and dP sum their small and large products apart, and
// each gradient tile's product (BC streamed rows) is summed in fresh
// registers, small terms first, then added to the running fp32 dQ, dK or
// dV by an fp32 add (at qwen3-0.6b's shape dQ adds up to 128 such tile
// sums, a key tile's dK and dV 256).
// What the design does about this card (PERF.md has the measurements):
// * operands split once.  The resident operands (Q and dO in dq, K and V
//   in dk/dv) are split into hi/lo when the CTA starts and kept in shared
//   memory in mma fragment order (load_split): one LDS.128 is one A
//   operand, with no register moves (an interleaved (hi, lo) row layout
//   cost ~90 moves per 48 mma) and no bank conflicts.  The score tile
//   that feeds a gradient product as A (dS in dq, P^T in dk/dv) is split
//   by the lane that computed it, also in fragment order: the k-slots of
//   the gradient products are mapped so that a lane's accumulators are its
//   own A operand (bwd_put_split).  dS^T in dk/dv stays raw fp32 (split
//   where read): split too, dk/dv would need 233,984 B of shared memory at
//   D = 128, over the 232,448 a CTA may have.  The streamed tiles are split
//   where they are read.
// * the streamed tiles (K and V in dq; Q, dO, lse and delta in dk/dv) come
//   BC rows at a time, double-buffered with cp.async as the forward's K and
//   V (16 B copies, 4 B for D % 4 != 0 or a misaligned pointer; rows past
//   the end and columns past D zero-filled), so a tile's loads overlap the
//   previous tile's products.  Half the warps issue the copies
//   (kCopyThreads).
// * phases of one (resident, streamed) tile pair, 8 warps, one CTA an SM:
//   scores in warp tiles of 16 resident x 16 streamed rows (SNT = 2) over
//   D (at D = 256, 16 x 8, and two warps split D and trade partial sums
//   through raw score tiles); the masks only in warp tiles that some
//   (query, key) pair cannot see (the forward's rule); a barrier; the
//   gradients in warp tiles of 32 resident rows x 8 GNT columns of D, the
//   streamed tile as B with the forward's V mapping.  P's exponential is
//   taken for every element and the masked ones selected away after, so
//   that a tile's exponentials overlap (bwd_p_ds).
// Tiles per head dim (BR resident rows, BC streamed rows; shared memory
// dq / dk/dv): D <= 128: BR = 64, BC = 32 (D = 128: 217,600 / 227,840 B;
// 64: 119,296 / 129,536; 32: 70,144 / 80,384); D = 256: BR = 32, BC = 16
// (209,152 B each): a resident 64-row hi/lo pair alone would be 256 KB.
// Streamed rows at DP + 8 words and raw score rows at BC + 8, so that the
// fragment reads are free of bank conflicts (the gradient products' reads
// of the streamed tile, two rows apart, are 2-way).  The launch opts in to
// the shared memory once per instantiation, before any graph capture.
// Bound on this card: operations.  At qwen3-0.6b's layer (S = 4096, H =
// 16, KV = 8, D = 128, causal) the function is 10 * D * H operations for
// each visible pair, 171.8 GFLOP: 1.04 ms in 3xTF32 at 495 TFLOP/s (2.56
// in fp32 at 67); the seven products the pair computes are 14 * D * H a
// pair, 240.6 GFLOP: 1.46 ms in 3xTF32 (3.59 in fp32).  mma.sync does not
// reach wgmma's rate and every streamed operand costs five instructions to
// split where it is read: the kernels sit near 4x the bound of what they
// compute (PERF.md).

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
// into shared memory at `stride` floats a row, by NT threads (tid < NT);
// rows >= nvalid and columns >= D become 0.  fp32 through cp.async; bf16
// converted through registers.
template <int DP, int NT = kThreads>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const float* src, long long rs,
                                          int rows, int nvalid, int D,
                                          bool vec, int tid) {
  if (vec) {
    constexpr int C4 = DP / 4;
    for (int i = tid; i < rows * C4; i += NT) {
      const int r = i / C4, c = (i % C4) * 4;
      const bool in = r < nvalid && c < D;
      cp_async16(dst + r * stride + c, in ? src + r * rs + c : src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < rows * DP; i += NT) {
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
// forward's row log-sum-exp and dO, in 3xTF32 on the tensor cores (see the
// file's head).  Shared memory of a CTA (BwdSmem): the two resident
// operands split into hi/lo in fragment order, BR rows each; two buffers
// of the two streamed tiles, BC raw rows each; the score tiles; lse and
// delta.
// ---------------------------------------------------------------------------
// The threads that issue a streamed tile's cp.async copies: half the CTA.
// Issuing them costs the pair 0.7-0.8 ms at qwen3-0.6b's layer though
// their latency is hidden; by every thread, right after the barrier that
// opens a tile, they hold all warps back from their products, and the
// pair takes 5.42 ms against 5.33-5.41 (PERF.md).
constexpr int kCopyThreads = kThreads / 2;

template <int DP>
struct Bwd {
  static constexpr int BR = DP == 256 ? 32 : 64;   // resident rows
  static constexpr int BC = DP == 256 ? 16 : 32;   // streamed rows a tile
  static constexpr int KS = DP / 8;                // k-steps over D
  static constexpr int KC = BC / 8;                // k-steps over BC
  static constexpr int RS = DP + 8;                // streamed row
  static constexpr int TS = BC + 8;                // raw score tile row
  // scores: warp tiles of SMT m-tiles x SNT n-tiles over DK of D, SWK
  // warps splitting D
  static constexpr int SMT = 1, SNT = DP == 256 ? 1 : 2;
  static constexpr int SWR = BR / (16 * SMT), SWC = BC / (8 * SNT);
  static constexpr int SWK = kWarps / (SWR * SWC);
  static constexpr int DK = DP / SWK;
  // gradients: warp tiles of 2 m-tiles x GNT n-tiles; W n-tiles share a
  // load of the streamed tile
  static constexpr int GWR = BR / 32, GWC = kWarps / GWR;
  static constexpr int GNT = DP / (8 * GWC);
  static constexpr int W = GNT < 4 ? GNT : 4;
  static_assert(SWR * SWC * SWK == kWarps && (SWK == 1 || SWK == 2),
                "backward score tiling");
  static_assert(GWR * GWC == kWarps && GNT * 8 * GWC == DP && GNT % W == 0,
                "backward gradient tiling");
  static constexpr int kRes = 2 * BR * DP;   // hi and lo, fragment order
  static constexpr int kStr = BC * RS;
  static constexpr int kF = 2 * BR * BC;     // a split score tile
  static constexpr int kT = BR * TS;         // a raw score tile
};

// Word offsets of a kernel's shared memory.  Both kernels hold the two
// resident planes, four streamed buffers and one split score tile (dS in
// dq, P^T in dk/dv).  Raw score tiles: dk/dv keeps dS^T raw (splitting it
// too would take 233,984 B at D = 128, over the 232,448 a CTA may have);
// at D = 256, where two warps split D, both kernels need two raw tiles
// for the partial scores (in dk/dv one of them then takes dS^T).  lse and
// delta: BR each in dq, two buffers of BC each in dk/dv.
template <int DP, bool DKDV>
struct BwdSmem {
  using C = Bwd<DP>;
  static constexpr int kRaw = C::SWK == 2 ? 2 : (DKDV ? 1 : 0);
  static constexpr int res = 0, str = 2 * C::kRes, split = str + 4 * C::kStr;
  static constexpr int raw = split + C::kF;
  static constexpr int rows = raw + kRaw * C::kT;
  static constexpr int words = rows + (DKDV ? 4 * C::BC : 2 * C::BR);
  static constexpr size_t bytes = sizeof(float) * (size_t)words;
};

// BR rows x DP of a (.., D) row-major fp32 source at `rs` elements a row,
// each value split once into TF32 hi and lo and stored in the order the
// score products read them as mma A operands: for 16-row m-tile mt and
// k-step ks, the 32 lanes' hi quads (128 words), then their lo quads.
// Lane gq * 4 + tq holds (row gq, row gq + 8) x (k-slot tq, k-slot tq + 4)
// as (a0, a1, a2, a3), and the k-slots (tq, tq + 4) of step ks are
// d = 8 ks + 2 tq + (0, 1), the pair a streamed row gives with one LDS.64.
// So one LDS.128 is one operand (no register moves), the lanes read
// consecutive 16 bytes (no bank conflicts) and the planes need no padding.
// Rows >= nvalid and columns >= D become 0.
template <int DP>
__device__ __forceinline__ void load_split(uint32_t* dst, const float* src,
                                           long long rs, int nvalid, int D,
                                           bool vec, int tid) {
  constexpr int BR = Bwd<DP>::BR, KS = Bwd<DP>::KS;
  auto put = [&](int r, int d, float x) {
    uint32_t hi, lo;
    split(x, hi, lo);
    const int lane = (r & 7) * 4 + ((d & 7) >> 1);
    const int reg = ((r >> 3) & 1) + 2 * (d & 1);
    uint32_t* at = dst + (((r >> 4) * KS + (d >> 3)) * 2) * 128 + lane * 4 +
                   reg;
    at[0] = hi;
    at[128] = lo;
  };
  if (vec) {
    constexpr int C4 = DP / 4;
#pragma unroll 4
    for (int i = tid; i < BR * C4; i += kThreads) {
      const int r = i / C4, c = (i % C4) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < nvalid && c < D)
        x = *reinterpret_cast<const float4*>(src + r * rs + c);
      put(r, c, x.x);
      put(r, c + 1, x.y);
      put(r, c + 2, x.z);
      put(r, c + 3, x.w);
    }
  } else {
    for (int i = tid; i < BR * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      put(r, c, r < nvalid && c < D ? src[r * rs + c] : 0.f);
    }
  }
}

// The score products of one tile pair: s = A1 . X1^T and dp = A2 . X2^T
// over d in [dk0, dk0 + DK), A1 and A2 the resident hi/lo planes
// (load_split's order), X1 and X2 the streamed raw tiles.  The warp's rows
// are sr0 + 16 i + (gq, gq + 8) (i < SMT), its streamed rows
// sc0 + 8 j + gq (j < SNT); s[i][j][e] is row sr0 + 16 i + gq + 8 (e >> 1),
// streamed row sc0 + 8 j + 2 tq + (e & 1).  The k-slots (tq, tq + 4) of a
// step are d0 + 2 tq + (0, 1): one LDS.64 of a streamed row gives both.
// Small products and large ones sum apart.
template <int DP>
__device__ __forceinline__ void bwd_scores(
    const uint32_t* A1, const uint32_t* A2, const float* X1, const float* X2,
    int sr0, int sc0, int dk0, int lane,
    float (&s)[Bwd<DP>::SMT][Bwd<DP>::SNT][4],
    float (&dp)[Bwd<DP>::SMT][Bwd<DP>::SNT][4]) {
  using C = Bwd<DP>;
  constexpr int SMT = C::SMT, SNT = C::SNT, RS = C::RS, KS = C::KS;
  const int gq = lane >> 2, tq = lane & 3;
  float sl[SMT][SNT][4], sh[SMT][SNT][4], pl[SMT][SNT][4], ph[SMT][SNT][4];
#pragma unroll
  for (int i = 0; i < SMT; ++i)
#pragma unroll
    for (int j = 0; j < SNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sl[i][j][e] = sh[i][j][e] = pl[i][j][e] = ph[i][j][e] = 0.f;
  const float* x1 = X1 + (sc0 + gq) * RS + 2 * tq;
  const float* x2 = X2 + (sc0 + gq) * RS + 2 * tq;
#pragma unroll 4
  for (int d0 = dk0; d0 < dk0 + C::DK; d0 += 8) {
    FragB b1[SNT], b2[SNT];
#pragma unroll
    for (int j = 0; j < SNT; ++j) {
      const float2 u1 = *reinterpret_cast<const float2*>(x1 + 8 * j * RS + d0);
      const float2 u2 = *reinterpret_cast<const float2*>(x2 + 8 * j * RS + d0);
      b1[j].set(u1.x, u1.y);
      b2[j].set(u2.x, u2.y);
    }
#pragma unroll
    for (int i = 0; i < SMT; ++i) {
      const int off = (((sr0 >> 4) + i) * KS + (d0 >> 3)) * 256 + lane * 4;
      const uint4 u1 = *reinterpret_cast<const uint4*>(A1 + off);
      const uint4 v1 = *reinterpret_cast<const uint4*>(A1 + off + 128);
      const uint4 u2 = *reinterpret_cast<const uint4*>(A2 + off);
      const uint4 v2 = *reinterpret_cast<const uint4*>(A2 + off + 128);
      const uint32_t h1[4] = {u1.x, u1.y, u1.z, u1.w};
      const uint32_t l1[4] = {v1.x, v1.y, v1.z, v1.w};
      const uint32_t h2[4] = {u2.x, u2.y, u2.z, u2.w};
      const uint32_t l2[4] = {v2.x, v2.y, v2.z, v2.w};
#pragma unroll
      for (int j = 0; j < SNT; ++j) {
        mma_tf32(sl[i][j], l1, b1[j].hi);
        mma_tf32(pl[i][j], l2, b2[j].hi);
        mma_tf32(sl[i][j], h1, b1[j].lo);
        mma_tf32(pl[i][j], h2, b2[j].lo);
        mma_tf32(sh[i][j], h1, b1[j].hi);
        mma_tf32(ph[i][j], h2, b2[j].hi);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < SMT; ++i)
#pragma unroll
    for (int j = 0; j < SNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[i][j][e] = sl[i][j][e] + sh[i][j][e];
        dp[i][j][e] = pl[i][j][e] + ph[i][j][e];
      }
}

// At D = 256 the warps with wk = 1 summed the second half of D: they hand
// their partial scores to the wk = 0 warp of the same tile through the
// score tiles (the same positions that warp then overwrites with P, dS).
// Every thread of the CTA calls this.
template <int DP>
__device__ __forceinline__ void bwd_trade_halves(
    float* T0, float* T1, int wk, int sr0, int sc0, int gq, int tq,
    float (&s)[Bwd<DP>::SMT][Bwd<DP>::SNT][4],
    float (&dp)[Bwd<DP>::SMT][Bwd<DP>::SNT][4]) {
  using C = Bwd<DP>;
  if constexpr (C::SWK == 2) {
    if (wk == 1) {
#pragma unroll
      for (int i = 0; i < C::SMT; ++i)
#pragma unroll
        for (int j = 0; j < C::SNT; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int at = (sr0 + 16 * i + gq + 8 * r) * C::TS + sc0 + 8 * j +
                           2 * tq;
            *reinterpret_cast<float2*>(T0 + at) =
                make_float2(s[i][j][2 * r], s[i][j][2 * r + 1]);
            *reinterpret_cast<float2*>(T1 + at) =
                make_float2(dp[i][j][2 * r], dp[i][j][2 * r + 1]);
          }
    }
    __syncthreads();
    if (wk == 0) {
#pragma unroll
      for (int i = 0; i < C::SMT; ++i)
#pragma unroll
        for (int j = 0; j < C::SNT; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int at = (sr0 + 16 * i + gq + 8 * r) * C::TS + sc0 + 8 * j +
                           2 * tq;
            const float2 o = *reinterpret_cast<const float2*>(T0 + at);
            const float2 p = *reinterpret_cast<const float2*>(T1 + at);
            s[i][j][2 * r] += o.x;
            s[i][j][2 * r + 1] += o.y;
            dp[i][j][2 * r] += p.x;
            dp[i][j][2 * r + 1] += p.y;
          }
    }
  }
}

// P and dS of one score element: s the raw product, l its row's lse, dl
// its row's delta.  The exponential is taken whether or not the element is
// visible and selected after: written as valid ? expf(..) : 0 it compiled
// to a branch around each element's expf, which kept a tile's eight
// exponentials from overlapping (the pair took 5.62 ms at qwen3-0.6b's
// layer that way, 5.39-5.45 this way; PERF.md).  A masked element's exp
// may overflow; it is not used.
__device__ __forceinline__ void bwd_p_ds(float s, float dp, float l, float dl,
                                         bool valid, float softcap,
                                         float scale, float& p, float& ds) {
  float x = s * scale;
  float dcap = 1.f;
  if (softcap > 0.f) {
    const float t = tanhf(x / softcap);
    x = softcap * t;
    dcap = 1.f - t * t;
  }
  const float e = expf(x - l);
  p = valid ? e : 0.f;
  ds = p * (dp - dl) * dcap;
}

// acc += T . X over the BC streamed rows, X the streamed raw tile (BC x DP
// at stride RS) and T a score tile, split (SPLIT: hi/lo quads in fragment
// order, bwd_put_split's) or raw (BR x BC fp32 at stride TS, split where
// read).  The k-slots (tq, tq + 4) of step kk are streamed rows
// kk + 2 tq + (0, 1), so that a score-tile lane's accumulators are its own
// A operand.  The warp's rows are gr0 + 16 i + (gq, gq + 8) (i < 2);
// n-tile c + w (w < W) is column gc0 + (c / W) * 8 W + gq * W + w at
// n = gq, so that a lane reads its W values of a row with one load.  The
// tile's product is summed in fresh registers, small terms first, and
// added to acc.
template <int DP, bool SPLIT>
__device__ __forceinline__ void bwd_grad(const float* T, const float* X,
                                         int gr0, int gc0, int lane,
                                         float (&acc)[2][Bwd<DP>::GNT][4]) {
  using C = Bwd<DP>;
  constexpr int GNT = C::GNT, W = C::W, TS = C::TS, RS = C::RS;
  const int gq = lane >> 2, tq = lane & 3;
  float tacc[2][GNT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < GNT; ++j)
      tacc[i][j][0] = tacc[i][j][1] = tacc[i][j][2] = tacc[i][j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < C::BC; kk += 8) {
    FragA a[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if constexpr (SPLIT) {
        const uint32_t* f = reinterpret_cast<const uint32_t*>(T) +
                            (((gr0 >> 4) + i) * C::KC + kk / 8) * 256 +
                            lane * 4;
        const uint4 h = *reinterpret_cast<const uint4*>(f);
        const uint4 l = *reinterpret_cast<const uint4*>(f + 128);
        a[i].hi[0] = h.x; a[i].hi[1] = h.y; a[i].hi[2] = h.z; a[i].hi[3] = h.w;
        a[i].lo[0] = l.x; a[i].lo[1] = l.y; a[i].lo[2] = l.z; a[i].lo[3] = l.w;
      } else {
        const float* p0 = T + (gr0 + 16 * i + gq) * TS + kk + 2 * tq;
        const float2 x0 = *reinterpret_cast<const float2*>(p0);
        const float2 x1 = *reinterpret_cast<const float2*>(p0 + 8 * TS);
        a[i].set(x0.x, x1.x, x0.y, x1.y);
      }
    }
#pragma unroll
    for (int c = 0; c < GNT; c += W) {
      const int col = gc0 + (c / W) * 8 * W + gq * W;
      float x0[W], x1[W];
      lds<W>(x0, X + (kk + 2 * tq) * RS + col);
      lds<W>(x1, X + (kk + 2 * tq + 1) * RS + col);
      FragB b[W];
#pragma unroll
      for (int w = 0; w < W; ++w) b[w].set(x0[w], x1[w]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int w = 0; w < W; ++w) mma_tf32(tacc[i][c + w], a[i].lo, b[w].hi);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int w = 0; w < W; ++w) mma_tf32(tacc[i][c + w], a[i].hi, b[w].lo);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int w = 0; w < W; ++w) mma_tf32(tacc[i][c + w], a[i].hi, b[w].hi);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < GNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += tacc[i][j][e];
}

// one score n-tile's four values of this lane (accumulator layout: rows
// (gq, gq + 8) x streamed columns (2 tq, 2 tq + 1) of m-tile mt, k-step ks)
// split once and stored as the A operand bwd_grad<DP, true> reads: the
// lane's own quad (x0, x2, x1, x3), hi then lo
template <int DP>
__device__ __forceinline__ void bwd_put_split(float* F, int mt, int ks,
                                              int lane, float x0, float x1,
                                              float x2, float x3) {
  FragA a;
  a.set(x0, x2, x1, x3);
  uint32_t* f = reinterpret_cast<uint32_t*>(F) +
                (mt * Bwd<DP>::KC + ks) * 256 + lane * 4;
  *reinterpret_cast<uint4*>(f) = make_uint4(a.hi[0], a.hi[1], a.hi[2], a.hi[3]);
  *reinterpret_cast<uint4*>(f + 128) =
      make_uint4(a.lo[0], a.lo[1], a.lo[2], a.lo[3]);
}

// the warp's part of a BR x D gradient: rows below nvalid, columns below D,
// each value times mul (acc[i][c + w][2 r + e] is row gr0 + 16 i + gq + 8 r,
// column gc0 + (c / W) * 8 W + (2 tq + e) * W + w)
template <int DP>
__device__ __forceinline__ void bwd_store(float* dst, long long rs,
                                          const float (&acc)[2][Bwd<DP>::GNT][4],
                                          int gr0, int gc0, int nvalid, int D,
                                          float mul, int gq, int tq) {
  constexpr int GNT = Bwd<DP>::GNT, W = Bwd<DP>::W;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = gr0 + 16 * i + gq + 8 * r;
      if (row >= nvalid) continue;
      float* d = dst + row * rs;
#pragma unroll
      for (int c = 0; c < GNT; c += W) {
        const int col = gc0 + (c / W) * 8 * W + 2 * tq * W;
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int w = 0; w < W; ++w)
            if (col + e * W + w < D)
              d[col + e * W + w] = acc[i][c + w][2 * r + e] * mul;
      }
    }
  }
}

// one CTA per (batch, head, query tile of BR rows), heaviest tiles first:
// delta = rowsum(dO * O) (also written out for the dk/dv kernel), then
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
  using M = BwdSmem<DP, false>;
  constexpr int BR = C::BR, BC = C::BC, RS = C::RS;
  constexpr int SMT = C::SMT, SNT = C::SNT, SWC = C::SWC, SWR = C::SWR;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  uint32_t* Qp = reinterpret_cast<uint32_t*>(sm + M::res);   // hi/lo
  uint32_t* dOp = Qp + C::kRes;
  float* Ks = sm + M::str;            // 2 buffers
  float* Vs = Ks + 2 * C::kStr;       // 2 buffers
  float* dSf = sm + M::split;         // dS, split
  float* T0 = sm + M::raw;            // D = 256: the partial scores
  float* T1 = T0 + C::kT;
  float* lse_s = sm + M::rows;
  float* delta_s = lse_s + BR;

  const int nq = (Sq + BR - 1) / BR;
  const int bh = blockIdx.x % (B * H);
  const int qt = nq - 1 - (int)(blockIdx.x / (B * H));
  const int b = bh / H, h = bh % H, g = h / (H / KV);
  const int q0 = qt * BR, nrows = min(BR, Sq - q0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const long long q_rs = (long long)H * D, kv_rs = (long long)KV * D;
  const long long qoff = (((long long)b * Sq + q0) * H + h) * D;
  const long long roff = ((long long)b * H + h) * Sq + q0;
  const float* kg = k + ((long long)b * Sk * KV + g) * D;
  const float* vg = v + ((long long)b * Sk * KV + g) * D;

  // the key tiles any row of this tile can see; the first one's copies go
  // out before the planes are split
  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(Sk, q0 + BR);
  if (window > 0) k_begin = max(0, q0 - window + 1);
  const int t_begin = k_begin / BC;
  const int t_end = (k_end + BC - 1) / BC;
  // the copies of a streamed tile are issued by warps 4-7 (kCopyThreads)
  auto load = [&](int t, int buf) {
    const int k1 = t * BC;
    if (tid >= kThreads - kCopyThreads) {
      const int ct = tid - (kThreads - kCopyThreads);
      load_tile<DP, kCopyThreads>(Ks + buf * C::kStr, RS, kg + k1 * kv_rs,
                                  kv_rs, BC, min(BC, Sk - k1), D, vec, ct);
      load_tile<DP, kCopyThreads>(Vs + buf * C::kStr, RS, vg + k1 * kv_rs,
                                  kv_rs, BC, min(BC, Sk - k1), D, vec, ct);
    }
    cp_async_commit();
  };
  if (t_begin < t_end) load(t_begin, 0);
  load_split<DP>(Qp, q + qoff, q_rs, nrows, D, vec, tid);
  load_split<DP>(dOp, dout + qoff, q_rs, nrows, D, vec, tid);
  for (int i = tid; i < BR; i += kThreads)
    lse_s[i] = i < nrows ? lse[roff + i] : 0.f;
  for (int i = warp; i < BR; i += kWarps) {
    float acc = 0.f;
    if (i < nrows)
      for (int d = lane; d < D; d += 32)
        acc = fmaf(dout[qoff + i * q_rs + d], o[qoff + i * q_rs + d], acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      delta_s[i] = acc;
      if (i < nrows) delta[roff + i] = acc;
    }
  }

  const int wk = warp / (SWR * SWC), wrc = warp % (SWR * SWC);
  const int sr0 = (wrc / SWC) * 16 * SMT, sc0 = (wrc % SWC) * 8 * SNT;
  const int gr0 = (warp / C::GWC) * 32, gc0 = (warp % C::GWC) * 8 * C::GNT;
  float acc[2][C::GNT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < C::GNT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    cp_async_wait_all();
    __syncthreads();   // tile t is in; every warp is done with tile t - 1
    if (t + 1 < t_end) load(t + 1, buf ^ 1);
    const float* Kb = Ks + buf * C::kStr;
    const float* Vb = Vs + buf * C::kStr;
    float s[SMT][SNT][4], dp[SMT][SNT][4];
    bwd_scores<DP>(Qp, dOp, Kb, Vb, sr0, sc0, wk * C::DK, lane, s, dp);
    bwd_trade_halves<DP>(T0, T1, wk, sr0, sc0, gq, tq, s, dp);
    if (wk == 0) {
      // rows are queries, streamed rows keys; masks only where some pair
      // of the warp tile cannot see
      const int k0 = t * BC + sc0, kb = k0 + 8 * SNT - 1;
      const int qa = q0 + sr0, qb = qa + 16 * SMT - 1;
      const bool whole = kb < Sk && qb < Sq && (!causal || kb <= qa) &&
                         (window <= 0 || k0 > qb - window);
#pragma unroll
      for (int i = 0; i < SMT; ++i)
#pragma unroll
        for (int j = 0; j < SNT; ++j) {
          float p[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = sr0 + 16 * i + gq + 8 * (e >> 1), qp = q0 + row;
            const int kp = k0 + 8 * j + 2 * tq + (e & 1);
            bool valid = true;
            if (!whole) {
              valid = kp < Sk && qp < Sq;
              if (causal) valid = valid && kp <= qp;
              if (window > 0) valid = valid && kp > qp - window;
            }
            bwd_p_ds(s[i][j][e], dp[i][j][e], lse_s[row], delta_s[row],
                     valid, softcap, scale, p[e], ds[e]);
          }
          bwd_put_split<DP>(dSf, (sr0 >> 4) + i, (sc0 >> 3) + j, lane, ds[0],
                            ds[1], ds[2], ds[3]);
        }
    }
    __syncthreads();   // dS is whole
    bwd_grad<DP, true>(dSf, Kb, gr0, gc0, lane, acc);
  }
  cp_async_wait_all();
  bwd_store<DP>(dq + qoff, q_rs, acc, gr0, gc0, nrows, D, scale, gq, tq);
}

// one CTA per (batch, KV head, key tile of BR keys), the first (heaviest
// under the causal mask) tiles first: over the group's query heads and the
// query tiles that can see the tile, dv = sum P^T . dO and dk = scale * sum
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
  using M = BwdSmem<DP, true>;
  constexpr int BR = C::BR, BC = C::BC, RS = C::RS, TS = C::TS;
  constexpr int SMT = C::SMT, SNT = C::SNT, SWC = C::SWC, SWR = C::SWR;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  uint32_t* Kp = reinterpret_cast<uint32_t*>(sm + M::res);   // hi/lo
  uint32_t* Vp = Kp + C::kRes;
  float* Qs = sm + M::str;            // 2 buffers
  float* dOs = Qs + 2 * C::kStr;      // 2 buffers
  float* Pf = sm + M::split;          // P^T, split
  float* T1 = sm + M::raw;            // dS^T, raw
  float* T0 = T1 + C::kT;             // D = 256: the partial scores
  float* lse_s = sm + M::rows;        // 2 buffers of BC
  float* delta_s = lse_s + 2 * BC;

  const int bg = blockIdx.x % (B * KV);
  const int kt = (int)(blockIdx.x / (B * KV));
  const int b = bg / KV, g = bg % KV, G = H / KV;
  const int k0 = kt * BR, nkeys = min(BR, Sk - k0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const long long q_rs = (long long)H * D, kv_rs = (long long)KV * D;
  const long long koff = (((long long)b * Sk + k0) * KV + g) * D;

  // the query rows that see some key of this tile, in tiles of BC; the
  // walk is the group's heads in order, each over those tiles
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(Sq, k0 + nkeys - 1 + window) : Sq;
  const int qt0 = q_begin / BC;
  const int nt = q_end > qt0 * BC ? (q_end - qt0 * BC + BC - 1) / BC : 0;
  const int items = G * nt;
  auto load_item = [&](int it, int buf) {
    const int h = g * G + it / nt, q0 = (qt0 + it % nt) * BC;
    const int nrows = min(BC, Sq - q0);
    const long long qoff = (((long long)b * Sq + q0) * H + h) * D;
    const long long roff = ((long long)b * H + h) * Sq + q0;
    if (tid >= kThreads - kCopyThreads) {   // warps 4-7, as in dq
      const int ct = tid - (kThreads - kCopyThreads);
      load_tile<DP, kCopyThreads>(Qs + buf * C::kStr, RS, q + qoff, q_rs, BC,
                                  nrows, D, vec, ct);
      load_tile<DP, kCopyThreads>(dOs + buf * C::kStr, RS, dout + qoff, q_rs,
                                  BC, nrows, D, vec, ct);
    }
    for (int i = tid; i < BC; i += kThreads) {
      const bool in = i < nrows;
      cp_async4(lse_s + buf * BC + i, in ? lse + roff + i : lse, in ? 4 : 0);
      cp_async4(delta_s + buf * BC + i, in ? delta + roff + i : delta,
                in ? 4 : 0);
    }
    cp_async_commit();
  };
  if (items > 0) load_item(0, 0);
  load_split<DP>(Kp, k + koff, kv_rs, nkeys, D, vec, tid);
  load_split<DP>(Vp, v + koff, kv_rs, nkeys, D, vec, tid);

  const int wk = warp / (SWR * SWC), wrc = warp % (SWR * SWC);
  const int sr0 = (wrc / SWC) * 16 * SMT, sc0 = (wrc % SWC) * 8 * SNT;
  const int gr0 = (warp / C::GWC) * 32, gc0 = (warp % C::GWC) * 8 * C::GNT;
  float dka[2][C::GNT][4], dva[2][C::GNT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < C::GNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[i][j][e] = dva[i][j][e] = 0.f;
  for (int it = 0; it < items; ++it) {
    const int buf = it & 1;
    cp_async_wait_all();
    __syncthreads();   // item it is in; every warp is done with item it - 1
    if (it + 1 < items) load_item(it + 1, buf ^ 1);
    const float* Qb = Qs + buf * C::kStr;
    const float* dOb = dOs + buf * C::kStr;
    const float* lb = lse_s + buf * BC;
    const float* db = delta_s + buf * BC;
    float s[SMT][SNT][4], dp[SMT][SNT][4];
    bwd_scores<DP>(Kp, Vp, Qb, dOb, sr0, sc0, wk * C::DK, lane, s, dp);
    bwd_trade_halves<DP>(T0, T1, wk, sr0, sc0, gq, tq, s, dp);
    if (wk == 0) {
      // rows are keys, streamed rows queries
      const int q0 = (qt0 + it % nt) * BC + sc0, qb = q0 + 8 * SNT - 1;
      const int ka = k0 + sr0, kb = ka + 16 * SMT - 1;
      const bool whole = kb < Sk && qb < Sq && (!causal || kb <= q0) &&
                         (window <= 0 || ka > qb - window);
#pragma unroll
      for (int i = 0; i < SMT; ++i)
#pragma unroll
        for (int j = 0; j < SNT; ++j) {
          float p[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = sr0 + 16 * i + gq + 8 * (e >> 1), kp = k0 + row;
            const int col = sc0 + 8 * j + 2 * tq + (e & 1);
            const int qp = q0 + col - sc0;
            bool valid = true;
            if (!whole) {
              valid = kp < Sk && qp < Sq;
              if (causal) valid = valid && kp <= qp;
              if (window > 0) valid = valid && kp > qp - window;
            }
            bwd_p_ds(s[i][j][e], dp[i][j][e], lb[col], db[col], valid,
                     softcap, scale, p[e], ds[e]);
          }
          bwd_put_split<DP>(Pf, (sr0 >> 4) + i, (sc0 >> 3) + j, lane, p[0],
                            p[1], p[2], p[3]);
#pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<float2*>(
                T1 + (sr0 + 16 * i + gq + 8 * r) * TS + sc0 + 8 * j + 2 * tq) =
                make_float2(ds[2 * r], ds[2 * r + 1]);
        }
    }
    __syncthreads();   // P^T and dS^T are whole
    bwd_grad<DP, true>(Pf, dOb, gr0, gc0, lane, dva);
    bwd_grad<DP, false>(T1, Qb, gr0, gc0, lane, dka);
  }
  cp_async_wait_all();
  bwd_store<DP>(dk + koff, kv_rs, dka, gr0, gc0, nkeys, D, scale, gq, tq);
  bwd_store<DP>(dv + koff, kv_rs, dva, gr0, gc0, nkeys, D, 1.f, gq, tq);
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
  constexpr size_t smem = BwdSmem<DP, false>::bytes;
  static bool attribute_set = false;   // once per instantiation, before any
  if (!attribute_set) {                // graph capture (warm-up calls)
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  const long long nq = (a.Sq + Bwd<DP>::BR - 1) / Bwd<DP>::BR;
  flash_bwd_dq_kernel<DP><<<(unsigned)(nq * a.B * a.H), kThreads, smem,
                            stream>>>(
      a.q, a.k, a.v, a.o, a.lse, a.dout, a.dq, a.delta, a.B, a.Sq, a.Sk, a.H,
      a.KV, a.D, a.causal, a.window, a.softcap,
      (float)(1.0 / sqrt((double)a.D)), bwd_vec(a));
  return (int)cudaGetLastError();
}

template <int DP>
int launch_bwd_dkdv(const BwdArgs& a, cudaStream_t stream) {
  constexpr size_t smem = BwdSmem<DP, true>::bytes;
  static bool attribute_set = false;
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  const long long nk = (a.Sk + Bwd<DP>::BR - 1) / Bwd<DP>::BR;
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
