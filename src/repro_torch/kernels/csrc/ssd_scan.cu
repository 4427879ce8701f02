// Chunked SSD scan (Mamba-2) for Hopper (sm_90a): the forward, a
// chunk-parallel scan in four passes, its products on the tensor cores in
// 3xTF32; and its gradient (repro_ssd_scan_bwd, below the forward's
// passes), which replaces no Pallas kernel: the reference has no backward
// kernel and JAX differentiates its jnp ssd_chunked.
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
// them.  The prefix sum runs in order, unfused (__fmul_rn / __fadd_rn), as
// the cumsum of the rounded dt * A; it, the decay weights and the state
// recurrence are fp32 with the accurate expf (no --use_fast_math).
//
// Bound on this card: operations.  At B=1, S=4096, H=48, P=64, N=128,
// Q=128 the function needs 8.17 GFLOP, nearly all in four products: C.B^T
// once per chunk (causal half), (L o G).x and C.S^T per head, and the
// chunk states (w o x)^T.B per head.  In 3xTF32 that is 3 x 8.1 GFLOP on
// the tensor cores, 0.049 ms at 495 TFLOP/s; in fp32 on the CUDA cores
// 0.12 ms at 67 TFLOP/s.  Its bytes (x and y 50 MB each, B, C, dt and the
// state 7 MB) take 0.032 ms at 3.35 TB/s; the passes' scratch adds about
// 200 MB more (the chunk states written and read, the entering states
// written and read: 50 MB each at these widths).
//
// Design (the Mamba-2 paper's block decomposition, arXiv:2405.21060 s6):
// the chunks are independent but for the P x N state handed from one to
// the next, and that hand-over is elementwise.  So the chunk loop of the
// TPU kernel (an "arbitrary" grid axis) becomes four launches, three of
// them parallel over chunks, and the scores C.B^T, shared by the heads,
// are computed once per (batch, chunk) instead of once per head:
//   1. ssd_scan_chunk_scores, four CTAs per (batch, chunk), one per pair
//      of 16-row m-tiles (a, 7 - a): CB = C.B^T, the 16 x 32 tiles at or
//      below the diagonal, into scratch (B, nc, Qp, Qp).
//   2. ssd_scan_chunk_states, a CTA per (batch, chunk, head, 64-column
//      slice of P): cum in order (into scratch (B, H, nc, Qp)), the weights
//      w_j = exp(cum_last - cum_j) dt_j, and the chunk's own state
//      (w o x)^T.B (P x N) into scratch (B, nc, H, P, N).
//   3. ssd_scan_state_pass, a thread per 4 (batch, head, p, n) elements:
//      walks the chunks in order, S_enter[c] = S; S <- exp(cum_last[c]) S
//      + states[c], the entering states into scratch of their own; starts
//      from init_state or 0 and writes the final state.  The only
//      sequential part: 0.4 M independent chains at mamba2-780m's widths,
//      their loads issued 8 chunks at a time.
//   4. ssd_scan_chunk_scan, a CTA per (batch, chunk, head, P slice): y =
//      (e o C).S_enter^T + (CB o exp(cum_i - cum_j) [j <= i] dt_j).x, with
//      e_i = exp(cum_i), in two phases over one shared-memory buffer: C and
//      the entering state first, then the decay-weighted scores G and x.
// At B=1, S=4096, H=48 passes 2 and 4 launch 1,536 CTAs each (the PR 13
// kernel: 96), and each takes 108 / 106 KB of shared memory, so two CTAs
// of 8 warps fit on an SM; pass 1 takes 84 KB (128 CTAs).
// Tiles come in through cp.async (16 B a thread where the rows allow it,
// else 4 B), rows past the chunk and columns past the width zero-filled.
//
// Arithmetic: 3xTF32.  One TF32 product (10-bit mantissa) is ~1e-3 off.
// Every operand x is split as hi = tf32(x), lo = tf32(x - hi), with tf32()
// the rounding of cvt.rna.tf32.f32 done by two integer operations, and a.b
// is taken as lo_a.hi_b + hi_a.lo_b + hi_a.hi_b by mma.sync m16n8k8 with
// fp32 accumulation.  The tensor cores' accumulation truncates, so the
// small products and the large ones go to separate accumulators, fresh for
// every output tile (at most N + Q = 256 terms: y's inter and intra terms
// share them), and are added last.  A warp takes two m-tiles in one k-loop
// so that each B fragment is split once for both.
//
// The backward (repro_ssd_scan_bwd; its passes are described where they
// start, "The backward") runs the forward's passes 1-3 again, so the
// autograd Function saves only the inputs, then six kernels.  Bound on
// this card: operations.  At mamba2-780m's layer (B=1, S=4096, H=48, P=64,
// N=128, Q=128) the products its passes compute come to 22.78 GFLOP: per
// head the chunk states again, D = (e o dy)^T.C, B.G^T and C.S^T (2 Q P N
// each), dM = dy.x^T and M^T.dy (causal halves), and per chunk dC and dB
// (the heads' state parts, 2 Q H P N each, and the scores' causal halves).
// At the fp32 CUDA-core rate that is 0.34 ms, in 3xTF32 0.14 ms; its bytes
// (x, dy, dx 50 MB each) take 0.048 ms, but its scratch moves more: the
// heads' dCB (100 MB at these widths) written and summed, the states and
// their gradients read again.  Every product runs 3xTF32 on the tensor
// cores as the forward's do.
//
// Shared-memory strides: an operand read at (row gq, column k0 + tq) of
// an m16n8k8 fragment has its rows 4 mod 32 floats apart, one read at
// (row k0 + tq, column n0 + gq) 8 mod 32 apart: each warp's 32 loads then
// hit 32 banks.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPS = 64;          // head-dim columns per CTA (passes 2, 4)
constexpr int kMaxQ = 128;
constexpr int kMaxN = 128;

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}
// row strides (floats) for the two fragment access patterns
__host__ __device__ constexpr int stride4(int w) {
  return round_up(w, 32) + 4;
}
__host__ __device__ constexpr int stride8(int w) {
  return round_up(w, 32) + 8;
}

struct Dims {
  int B, S, H, P, N, Q;
  long long xb, xs;   // x's batch and row strides (its (H, P) packed)
  long long nb, ns;   // B's and C's batch and row strides
  int nc;   // chunks
  int Qp;   // Q rounded up to 16 (m16 tiles)
  int Np;   // N rounded up to 8 (k8 steps, n8 tiles)
  bool st2;   // the chunk states' rows take 8-byte stores (N even)
  bool y2;    // y's rows take 8-byte stores (P even)
};

// floats of dynamic shared memory per pass
__host__ __device__ constexpr size_t scores_floats(int Qp, int Np) {
  return (size_t)(32 + Qp) * stride4(Np);
}
__host__ __device__ constexpr size_t states_floats(int Qp, int Np) {
  return (size_t)Qp * stride8(kPS) + (size_t)Qp * stride8(Np) + 3 * Qp;
}
__host__ __device__ constexpr size_t scan_buffer(int Qp, int Np) {
  return (size_t)Qp * stride4(Np) + (size_t)kPS * stride4(Np) >
                 (size_t)Qp * stride4(Qp) + (size_t)Qp * stride8(kPS)
             ? (size_t)Qp * stride4(Np) + (size_t)kPS * stride4(Np)
             : (size_t)Qp * stride4(Qp) + (size_t)Qp * stride8(kPS);
}
__host__ __device__ constexpr size_t scan_floats(int Qp, int Np) {
  return scan_buffer(Qp, Np) + 2 * Qp;
}

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

// rows x width floats of a row-major source at `rs` floats a row into
// shared memory at `stride` floats a row; rows >= nvalid and columns >=
// ncols become 0.  `vec`: 16-byte copies (width, ncols and rs multiples of
// 4, src 16-byte aligned).
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const float* src, long long rs,
                                          int rows, int nvalid, int width,
                                          int ncols, bool vec) {
  if (vec) {
    const int w4 = width / 4;
    for (int i = threadIdx.x; i < rows * w4; i += kThreads) {
      const int r = i / w4, c = (i % w4) * 4;
      const bool in = r < nvalid && c < ncols;
      cp_async16(dst + r * stride + c, in ? src + r * rs + c : src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * width; i += kThreads) {
      const int r = i / width, c = i % width;
      const bool in = r < nvalid && c < ncols;
      cp_async4(dst + r * stride + c, in ? src + r * rs + c : src,
                in ? 4 : 0);
    }
  }
}

// cvt.rna.tf32.f32: round to 10 mantissa bits, to nearest with ties away
// from zero, as two integer operations (the same values; flash_attention.cu
// and scripts/flash_ablation.py)
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

// An m16n8k8 A fragment: a0 (gq, tq), a1 (gq + 8, tq), a2 (gq, tq + 4),
// a3 (gq + 8, tq + 4); a B fragment: b0 (k tq, n gq), b1 (k tq + 4, n gq);
// the accumulator: c0, c1 (gq, 2tq + 0/1), c2, c3 (gq + 8, 2tq + 0/1).
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

// the 3xTF32 product into separate small (sl) and large (sh) accumulators
__device__ __forceinline__ void mma3(float (&sl)[4], float (&sh)[4],
                                     const FragA& a, const FragB& b) {
  mma_tf32(sl, a.lo, b.hi);
  mma_tf32(sl, a.hi, b.lo);
  mma_tf32(sh, a.hi, b.hi);
}

__device__ __forceinline__ void zero(float (&t)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) t[i][0] = t[i][1] = t[i][2] = t[i][3] = 0.f;
}

// v0, v1 to p[0], p[1] of a row of `width` floats at column col (even):
// one 8-byte store when `vec2` says that every row of the destination
// starts 8-byte aligned and has an even number of floats (a slice of an
// odd-width row may be even wide and start at an odd float)
__device__ __forceinline__ void store2(float* p, int col, int width,
                                       bool vec2, float v0, float v1) {
  if (vec2) {
    if (col < width) *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    if (col < width) p[0] = v0;
    if (col + 1 < width) p[1] = v1;
  }
}

// Pass 1: CB = C . B^T for one (batch, chunk, pair of m-tiles): four CTAs
// per chunk, the one of pair a taking the 16-row m-tiles a and 7 - a
// (equal causal work) and only the 16 x 32 tiles at or below the diagonal
// (entries above it in a diagonal tile are computed and never read; tiles
// wholly above it are never written).  A warp a tile.
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_chunk_scores(const float* __restrict__ Bm,
                      const float* __restrict__ Cm, float* __restrict__ cb,
                      Dims d, bool vecn) {
  const int a = blockIdx.x % 4, bc = blockIdx.x / 4;
  const int b = bc / d.nc, c = bc % d.nc;
  const int s0 = c * d.Q, qv = min(d.Q, d.S - s0);
  const int Mt = d.Qp / 16;
  if (a >= Mt) return;
  const int mt[2] = {a, 7 - a};
  const bool two = mt[1] < Mt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int CP = stride4(d.Np);
  extern __shared__ float4 smem4[];
  float* Cs = reinterpret_cast<float*>(smem4);   // 32 x CP: both m-tiles
  float* Bs = Cs + 32 * CP;                      // up to Qp x CP
  const long long off = b * d.nb + s0 * d.ns;
  // the B rows the lower m-tile's tiles reach
  const int rows_b = min(d.Qp, 16 * mt[two ? 1 : 0] + 16);
  for (int t = 0; t < (two ? 2 : 1); ++t)
    load_tile(Cs + 16 * t * CP, CP, Cm + off + 16 * mt[t] * d.ns, d.ns, 16,
              qv - 16 * mt[t], d.Np, d.N, vecn);
  load_tile(Bs, CP, Bm + off, d.ns, rows_b, qv, d.Np, d.N, vecn);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // tiles of 32 columns: those of m-tile a first, then those of 7 - a
  const int g0 = (min(d.Qp, 16 * mt[0] + 16) + 31) / 32;
  const int g1 = two ? (min(d.Qp, 16 * mt[1] + 16) + 31) / 32 : 0;
  if (warp >= g0 + g1) return;
  const int t = warp < g0 ? 0 : 1;
  const int i0 = 16 * mt[t], j0 = 32 * (warp < g0 ? warp : warp - g0);
  // n-tiles inside the chunk and at or below the diagonal
  const int nt_end = (min(d.Qp, i0 + 16) - j0 + 7) / 8;
  float sl[4][4], sh[4][4];
  zero(sl);
  zero(sh);
  for (int k0 = 0; k0 < d.Np; k0 += 8) {
    const float* ca = Cs + (16 * t + gq) * CP + k0 + tq;
    FragA fa;
    fa.set(ca[0], ca[8 * CP], ca[4], ca[8 * CP + 4]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (nt < nt_end) {
        const float* bb = Bs + (j0 + 8 * nt + gq) * CP + k0 + tq;
        FragB bf;
        bf.set(bb[0], bb[4]);
        mma3(sl[nt], sh[nt], fa, bf);
      }
    }
  }
  float* out = cb + ((long long)b * d.nc + c) * d.Qp * d.Qp;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    if (nt < nt_end) {
      const int j = j0 + 8 * nt + 2 * tq;
      float* o = out + (long long)(i0 + gq) * d.Qp + j;
      *reinterpret_cast<float2*>(o) =
          make_float2(sl[nt][0] + sh[nt][0], sl[nt][1] + sh[nt][1]);
      *reinterpret_cast<float2*>(o + 8 * d.Qp) =
          make_float2(sl[nt][2] + sh[nt][2], sl[nt][3] + sh[nt][3]);
    }
  }
}

// the (batch, chunk, head, P slice) of a CTA of passes 2 and 4: slices and
// heads vary fastest, so neighbouring CTAs share the chunk's B and C
struct Cell {
  int b, c, h, p0, s0, qv, pv;
  __device__ __forceinline__ Cell(const Dims& d) {
    const int nps = (d.P + kPS - 1) / kPS;
    int idx = blockIdx.x;
    p0 = (idx % nps) * kPS;
    idx /= nps;
    h = idx % d.H;
    idx /= d.H;
    c = idx % d.nc;
    b = idx / d.nc;
    s0 = c * d.Q;
    qv = min(d.Q, d.S - s0);
    pv = min(kPS, d.P - p0);
  }
};

// Pass 2: cum (in order) and the chunk's own state contribution
// sum_j exp(cum_last - cum_j) dt_j x_j B_j^T for one P slice.  kGrad: the
// backward's first pass on the same tiling, D_c = sum_i exp(cum_i) dy_i
// C_i^T, with dy in x's place and C in B's (cum computed as here, bit for
// bit, and not written).
template <bool kGrad>
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_chunk_states(const float* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const float* __restrict__ Bm,
                      float* __restrict__ cum_out,
                      float* __restrict__ states, Dims d, bool vecx,
                      bool vecn) {
  const Cell e(d);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int XP = stride8(kPS), BP = stride8(d.Np);
  const int NW = round_up(d.Np, 32);          // B columns loaded (4 n-tiles)
  extern __shared__ float4 smem4[];
  float* Xs = reinterpret_cast<float*>(smem4);  // Qp x XP: x, then w o x
  float* Bs = Xs + d.Qp * XP;                   // Qp x BP
  float* dts = Bs + d.Qp * BP;                  // Qp
  float* cum = dts + d.Qp;                      // Qp
  float* wts = cum + d.Qp;                      // Qp

  load_tile(Xs, XP, x + e.b * d.xb + e.s0 * d.xs + e.h * d.P + e.p0, d.xs,
            d.Qp, e.qv, kPS, e.pv, vecx);
  load_tile(Bs, BP, Bm + e.b * d.nb + e.s0 * d.ns, d.ns, d.Qp,
            e.qv, NW, d.N, vecn);
  cp_async_commit();
  for (int r = tid; r < d.Qp; r += kThreads)
    dts[r] = r < e.qv ? dt[((long long)e.b * d.S + e.s0 + r) * d.H + e.h]
                      : 0.f;
  __syncthreads();
  if (tid == 0) {
    const float a = A[e.h];
    float run = 0.f;
#pragma unroll 8
    for (int r = 0; r < d.Qp; ++r) {
      run = __fadd_rn(run, __fmul_rn(dts[r], a));
      cum[r] = run;
    }
  }
  __syncthreads();
  const float cum_last = cum[d.Qp - 1];
  float* cg = cum_out + (((long long)e.b * d.H + e.h) * d.nc + e.c) * d.Qp;
  for (int r = tid; r < d.Qp; r += kThreads) {
    wts[r] = kGrad ? expf(cum[r]) : expf(cum_last - cum[r]) * dts[r];
    if (!kGrad && e.p0 == 0) cg[r] = cum[r];
  }
  cp_async_wait_all();
  __syncthreads();
  for (int i = tid; i < d.Qp * kPS; i += kThreads) {
    const int r = i / kPS, p = i % kPS;
    Xs[r * XP + p] *= wts[r];
  }
  __syncthreads();

  // (w o x)^T . B.  Warp w owns the 32 columns n0 = 32 (w % 4) of the
  // state and its rows of p in the m-tiles w / 4 and w / 4 + 2: one k-loop
  // for both, so each B fragment is split once for two m-tiles.
  const int n0 = 32 * (warp & 3);
  const int Pm = (e.pv + 15) / 16;
  const int mt[2] = {warp >> 2, (warp >> 2) + 2};
  const bool on[2] = {mt[0] < Pm, mt[1] < Pm};
  if (n0 < NW && on[0]) {
    const int kend = round_up(e.qv, 8);
    float sl[2][4][4], sh[2][4][4];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      zero(sl[s]);
      zero(sh[s]);
    }
    for (int k0 = 0; k0 < kend; k0 += 8) {
      FragA a[2];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (on[s]) {
          const float* xa = Xs + (k0 + tq) * XP + 16 * mt[s] + gq;
          a[s].set(xa[0], xa[8], xa[4 * XP], xa[4 * XP + 8]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* bb = Bs + (k0 + tq) * BP + n0 + 8 * nt + gq;
        FragB bf;
        bf.set(bb[0], bb[4 * BP]);
#pragma unroll
        for (int s = 0; s < 2; ++s)
          if (on[s]) mma3(sl[s][nt], sh[s][nt], a[s], bf);
      }
    }
    float* st =
        states + (((long long)e.b * d.nc + e.c) * d.H + e.h) * d.P * d.N;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (!on[s]) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + 8 * nt + 2 * tq;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int p = e.p0 + 16 * mt[s] + gq + 8 * hf;
          if (p < d.P)
            store2(st + (long long)p * d.N + n, n, d.N, d.st2,
                   sl[s][nt][2 * hf] + sh[s][nt][2 * hf],
                   sl[s][nt][2 * hf + 1] + sh[s][nt][2 * hf + 1]);
        }
      }
    }
  }
}

// Pass 3: the state handed from chunk to chunk, V consecutive (batch,
// head, p, n) elements a thread (V = 4: 16-byte accesses).  The chunk
// states are read kG chunks at a time, all loads in flight before the
// group's first use, and the states entering each chunk go to a buffer of
// their own (stores never wait behind a load of the same address).
template <int V>
__global__ void __launch_bounds__(kThreads)
ssd_scan_state_pass(const float* __restrict__ cum,
                    const float* __restrict__ init,
                    const float* __restrict__ states,
                    float* __restrict__ entering,
                    float* __restrict__ fstate, Dims d) {
  constexpr int kG = 8;
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  const long long hpn = (long long)d.H * d.P * d.N;
  const long long t = ((long long)blockIdx.x * kThreads + threadIdx.x) * V;
  if (t >= d.B * hpn) return;
  const int b = (int)(t / hpn);
  const long long e = t % hpn;                 // (h * P + p) * N + n
  const int h = (int)(e / ((long long)d.P * d.N));
  const float* last =
      cum + ((long long)b * d.H + h) * d.nc * d.Qp + d.Qp - 1;
  const long long base = (long long)b * d.nc * hpn + e;
  float s[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s[k] = init != nullptr ? init[t + k] : 0.f;
  for (int c0 = 0; c0 < d.nc; c0 += kG) {
    float v[kG][V], g[kG];
#pragma unroll
    for (int k = 0; k < kG; ++k) {
      if (c0 + k < d.nc) {
        const Vec w =
            *reinterpret_cast<const Vec*>(states + base + (c0 + k) * hpn);
        memcpy(v[k], &w, sizeof(w));
        g[k] = expf(last[(long long)(c0 + k) * d.Qp]);
      }
    }
#pragma unroll
    for (int k = 0; k < kG; ++k) {
      if (c0 + k < d.nc) {
        Vec w;
        memcpy(&w, s, sizeof(w));
        *reinterpret_cast<Vec*>(entering + base + (c0 + k) * hpn) = w;
#pragma unroll
        for (int i = 0; i < V; ++i) s[i] = g[k] * s[i] + v[k][i];
      }
    }
  }
  Vec w;
  memcpy(&w, s, sizeof(w));
  *reinterpret_cast<Vec*>(fstate + t) = w;
}

// Pass 4: y for one (batch, chunk, head, P slice), in two phases over one
// shared-memory buffer, both summed into the same accumulators:
//   A. (e o C) . S_enter^T, C's rows scaled by e_i = exp(cum_i) in place;
//   B. G . x, G = CB o exp(cum_i - cum_j) [j <= i] dt_j, made in place.
// Warp w owns the m-tiles w % 4 and 7 - w % 4 (equal causal work) and the
// 32 columns 32 (w / 4) of the slice, in one k-loop, so each B fragment is
// split once for both m-tiles.
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_chunk_scan(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ Cm,
                    const float* __restrict__ cb,
                    const float* __restrict__ cum_in,
                    const float* __restrict__ entering,
                    float* __restrict__ y, Dims d, bool vecx, bool vecn) {
  const Cell e(d);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int CP = stride4(d.Np), GP = stride4(d.Qp), XP = stride8(kPS);
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);
  float* cum = buf + scan_buffer(d.Qp, d.Np);   // Qp
  float* dts = cum + d.Qp;                      // Qp

  // phase A: C (Qp x CP) and the entering state's slice (kPS x CP)
  float* Cs = buf;
  float* Ss = buf + d.Qp * CP;
  load_tile(Cs, CP, Cm + e.b * d.nb + e.s0 * d.ns, d.ns, d.Qp,
            e.qv, d.Np, d.N, vecn);
  load_tile(Ss, CP,
            entering + ((((long long)e.b * d.nc + e.c) * d.H + e.h) * d.P +
                        e.p0) * d.N,
            d.N, kPS, e.pv, d.Np, d.N, vecn);
  cp_async_commit();
  const float* cg = cum_in + (((long long)e.b * d.H + e.h) * d.nc + e.c) *
                                 d.Qp;
  for (int r = tid; r < d.Qp; r += kThreads) {
    cum[r] = cg[r];
    dts[r] = r < e.qv ? dt[((long long)e.b * d.S + e.s0 + r) * d.H + e.h]
                      : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();
  for (int r = warp; r < e.qv; r += kWarps) {
    const float er = expf(cum[r]);
    for (int n = lane; n < d.Np; n += 32) Cs[r * CP + n] *= er;
  }
  __syncthreads();

  const int Mt = d.Qp / 16;
  const int n0 = 32 * (warp >> 2);
  const int mt[2] = {warp & 3, 7 - (warp & 3)};
  const bool on[2] = {mt[0] < Mt && n0 < e.pv, mt[1] < Mt && n0 < e.pv};
  float sl[2][4][4], sh[2][4][4];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    zero(sl[s]);
    zero(sh[s]);
  }
  if (on[0]) {
    for (int k0 = 0; k0 < d.Np; k0 += 8) {
      FragA a[2];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (on[s]) {
          const float* ca = Cs + (16 * mt[s] + gq) * CP + k0 + tq;
          a[s].set(ca[0], ca[8 * CP], ca[4], ca[8 * CP + 4]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* sb = Ss + (n0 + 8 * nt + gq) * CP + k0 + tq;
        FragB bf;
        bf.set(sb[0], sb[4]);
#pragma unroll
        for (int s = 0; s < 2; ++s)
          if (on[s]) mma3(sl[s][nt], sh[s][nt], a[s], bf);
      }
    }
  }
  __syncthreads();   // every warp is done with C and S

  // phase B: CB (read only at or below the diagonal: the 16-byte groups
  // that reach it) and x
  float* Gs = buf;
  float* Xs = buf + d.Qp * GP;
  const float* cbc = cb + ((long long)e.b * d.nc + e.c) * d.Qp * d.Qp;
  const int q4 = d.Qp / 4;
  for (int i = tid; i < d.Qp * q4; i += kThreads) {
    const int r = i / q4, c4 = (i % q4) * 4;
    if (c4 <= r && r < e.qv)
      cp_async16(Gs + r * GP + c4, cbc + r * d.Qp + c4, 16);
  }
  load_tile(Xs, XP, x + e.b * d.xb + e.s0 * d.xs + e.h * d.P + e.p0, d.xs,
            d.Qp, e.qv, kPS, e.pv, vecx);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  for (int r = warp; r < d.Qp; r += kWarps) {
    const float cr = cum[r];
    for (int j = lane; j < d.Qp; j += 32) {
      float g = 0.f;
      if (j <= r && r < e.qv)
        g = Gs[r * GP + j] * expf(cr - cum[j]) * dts[j];
      Gs[r * GP + j] = g;
    }
  }
  __syncthreads();

  if (on[0]) {
    const int qe = round_up(e.qv, 8);
    const int ext[2] = {min(16 * mt[0] + 16, qe), min(16 * mt[1] + 16, qe)};
    const int kend = max(ext[0], on[1] ? ext[1] : 0);
    for (int k0 = 0; k0 < kend; k0 += 8) {
      bool go[2];
      FragA a[2];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        go[s] = on[s] && k0 < ext[s];
        if (go[s]) {
          const float* ga = Gs + (16 * mt[s] + gq) * GP + k0 + tq;
          a[s].set(ga[0], ga[8 * GP], ga[4], ga[8 * GP + 4]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* xb = Xs + (k0 + tq) * XP + n0 + 8 * nt + gq;
        FragB bf;
        bf.set(xb[0], xb[4 * XP]);
#pragma unroll
        for (int s = 0; s < 2; ++s)
          if (go[s]) mma3(sl[s][nt], sh[s][nt], a[s], bf);
      }
    }
    float* yb =
        y + (((long long)e.b * d.S + e.s0) * d.H + e.h) * d.P + e.p0;
    const long long ys = (long long)d.H * d.P;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (!on[s]) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int p = n0 + 8 * nt + 2 * tq;   // column within the slice
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = 16 * mt[s] + gq + 8 * hf;
          if (i < e.qv)
            store2(yb + i * ys + p, p, e.pv, d.y2,
                   sl[s][nt][2 * hf] + sh[s][nt][2 * hf],
                   sl[s][nt][2 * hf + 1] + sh[s][nt][2 * hf + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The backward.  The forward's passes 1-3 run again first (chunk scores,
// cum, the entering states), then:
//   B1. ssd_scan_chunk_states<true>: D_c = (e o dy)^T . C per (batch, chunk,
//       head, P slice), into the chunk states' scratch;
//   B2. ssd_scan_bwd_state_pass: walks the chunks from the last, G_c = the
//       gradient of the state leaving chunk c (dfinal or 0 for the last),
//       G_{c-1} = exp(cum_last[c]) G_c + D_c, dinit at the end;
//   B3. ssd_scan_bwd_chunk, a CTA per (batch, chunk, head): dM = dy.x^T,
//       M = CB o L o dt built once in shared memory, dx = M^T.dy + w o
//       (B.G^T), the head's dCB = L o dt o dM (into scratch), e and w (into
//       scratch), d cum, its reversed prefix sum, ddt and the chunk's dA
//       term;
//   B4. ssd_scan_bwd_head_sum: dCB summed over the heads in order (0 above
//       the diagonal, which B3 leaves unwritten);
//   B5. ssd_scan_bwd_bc, a CTA per (batch, chunk, group, dC or dB, 64
//       columns of N): group 0 the scores' part, dC = dCB.B or dB =
//       dCB^T.C; group g >= 1 the heads' state parts, sum_h (e o dy_h).S_h
//       or (w o x_h).G_h, over its kGroupChunks k-chunks of at most 64
//       terms of one head each (4 heads at P = 64); a partial per group,
//       into scratch;
//   B6. ssd_scan_bwd_sum: dC and dB, the groups' partials summed in order;
//       its last CTA dA, the chunks' terms summed in order.
// Every product of B3 and B5 runs 3xTF32 mma.sync m16n8k8 as the forward's
// passes do (FragA / FragB / mma3: each operand split once a fragment and
// reused across n-tiles, small and large products in separate
// accumulators), each output tile summed in fresh accumulators over at
// most 256 terms (the tensor cores' fp32 accumulation truncates): B5 cuts
// the heads' k-range of H P terms into groups for that, which also
// launches more CTAs than the card has SMs.  Operands come in through
// cp.async, the streamed ones double-buffered, rows past the chunk and
// columns past the width zero-filled (the source of a masked copy is the
// tile's first, valid address); the row scales e_i and w_j are applied as a
// fragment is split.  No atomics: every sum has a fixed order, so two calls
// give the same bits.  Every decay is exp of a difference <= 0:
// exp(cum_i - cum_j) only for j <= i (the exponent is selected before expf
// above the diagonal), exp(cum_last - cum_j), exp(cum_i).
constexpr int kPB = 64;           // P columns of a B3 chunk; k terms of a B5 one
constexpr int kNC = 32;           // k terms (columns of N) of B3's streamed chunks
constexpr int kGroupChunks = 4;   // B5: k-chunks a CTA sums fresh (<= 256 terms)

// wait until every committed group but the last has landed: the tile about
// to be used is in while the next one's copies stay in flight
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// sums over the 4 lanes of an mma row (the tq of one gq) and over the 8
// lanes of an mma column (the gq of one tq), in a fixed order
template <class T>
__device__ __forceinline__ T sum_tq(T v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}
template <class T>
__device__ __forceinline__ T sum_gq(T v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}
__device__ __forceinline__ double sum_warp(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// what the backward's kernels may copy 16 bytes at a time (x, dy, B and C,
// the entering states and their gradients) and whether dx's rows take
// 8-byte stores
struct BwdFlags {
  bool vecx, vecy, vecn, vecs, dx2;
};

// B2: the state gradients handed back from chunk to chunk, V consecutive
// (batch, head, p, n) elements a thread, kG chunks' loads in flight.
template <int V>
__global__ void __launch_bounds__(kThreads)
ssd_scan_bwd_state_pass(const float* __restrict__ cum,
                        const float* __restrict__ dfinal,
                        const float* __restrict__ dst,
                        float* __restrict__ gst, float* __restrict__ dinit,
                        Dims d) {
  constexpr int kG = 8;
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  const long long hpn = (long long)d.H * d.P * d.N;
  const long long t = ((long long)blockIdx.x * kThreads + threadIdx.x) * V;
  if (t >= d.B * hpn) return;
  const int b = (int)(t / hpn);
  const long long e = t % hpn;
  const int h = (int)(e / ((long long)d.P * d.N));
  const float* last =
      cum + ((long long)b * d.H + h) * d.nc * d.Qp + d.Qp - 1;
  const long long base = (long long)b * d.nc * hpn + e;
  float g[V];
#pragma unroll
  for (int k = 0; k < V; ++k) g[k] = dfinal != nullptr ? dfinal[t + k] : 0.f;
  for (int c1 = d.nc; c1 > 0; c1 -= kG) {
    float v[kG][V], gm[kG];
#pragma unroll
    for (int k = 0; k < kG; ++k) {
      const int c = c1 - 1 - k;
      if (c >= 0) {
        const Vec w = *reinterpret_cast<const Vec*>(dst + base + c * hpn);
        memcpy(v[k], &w, sizeof(w));
        gm[k] = expf(last[(long long)c * d.Qp]);
      }
    }
#pragma unroll
    for (int k = 0; k < kG; ++k) {
      const int c = c1 - 1 - k;
      if (c >= 0) {
        Vec w;
        memcpy(&w, g, sizeof(w));
        *reinterpret_cast<Vec*>(gst + base + c * hpn) = w;
#pragma unroll
        for (int i = 0; i < V; ++i) g[i] = gm[k] * g[i] + v[k][i];
      }
    }
  }
  if (dinit != nullptr) {
    Vec w;
    memcpy(&w, g, sizeof(w));
    *reinterpret_cast<Vec*>(dinit + t) = w;
  }
}

// B3's shared memory (floats): dy and x (Qp x 64 each), M (Qp x Qp), two
// stages of the streamed chunks (B or C, Qp x 32, and G or S, 64 x 32),
// the row and column sums of R (doubles, 4 and 8 x Qp), d cum (doubles,
// Qp), eleven row vectors and a reduction buffer: 209.5 KB at Qp = 128,
// one CTA an SM
__host__ __device__ constexpr size_t bwd_chunk_floats(int Qp) {
  return (size_t)2 * Qp * stride4(kPB) + (size_t)Qp * stride8(Qp) +
         (size_t)2 * (Qp + kPB) * stride4(kNC) + (size_t)2 * 13 * Qp +
         (size_t)11 * Qp + kThreads;
}

// B3: one (batch, chunk, head).  With M_ij = CB_ij L_ij dt_j (j <= i),
// dM_ij = dy_i . x_j, U_j = G B_j, V_i = S_enter C_i, R_ij = CB_ij L_ij
// dM_ij (so M_ij dM_ij = R_ij dt_j):
//   dx_j  = sum_i M_ij dy_i + w_j U_j
//   dCB_ij (this head's part) = L_ij dt_j dM_ij
//   dcum_i = sum_j R_ij dt_j - dt_i sum_k R_ki - w_i (x_i . U_i)
//            + e_i (dy_i . V_i), and on the last row also
//            sum_j w_j (x_j . U_j) + gamma <G, S_enter>
//   d(dt A)_k = sum_{i >= k} dcum_i
//   ddt_j = sum_i R_ij + exp(cum_last - cum_j) (x_j . U_j) + A d(dt A)_j;
//   the chunk's dA term sum_k d(dt A)_k dt_k.
// The row and column sums of R cancel in d cum, so they, d cum, its prefix
// sum and the dA term are summed in double.  In order:
//   1. dM by jobs of a 16-row m-tile and 32 columns at or below the
//      diagonal (20 at Qp = 128; a warp the jobs warp, warp + 8, warp + 16),
//      each P chunk of 64 terms summed fresh into a running sum;
//   2. from the jobs' registers: M into shared memory, dCB into scratch,
//      the row and column sums of R by lanes with shuffles, a part a job;
//   3. per P slice of 64 columns: M^T.dy (warps own the m-tiles a and 7 - a,
//      equal causal work), then B.G^T and C.S^T over N in chunks of 32
//      streamed through two stages, their epilogues taking dx, x_j . U_j
//      and dy_i . V_i;
//   4. <G, S_enter>, d cum, its reversed prefix sum (a warp scan), the dA
//      term and ddt.
// One CTA of 8 warps an SM, each thread holding its jobs' dM and its dx
// tile in registers (228 of them): two CTAs an SM (M over dy and x, dy
// streamed) or 16 warps a CTA meet the 128-register cap, spill and run
// slower.  Heads vary fastest over the grid, so neighbouring CTAs share
// the chunk's B, C and CB in L2.
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_bwd_chunk(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const float* __restrict__ Bm,
                   const float* __restrict__ Cm, const float* __restrict__ dy,
                   const float* __restrict__ cb,
                   const float* __restrict__ cum_in,
                   const float* __restrict__ entering,
                   const float* __restrict__ gst, float* __restrict__ dx,
                   float* __restrict__ ddt, float* __restrict__ dcbh,
                   float* __restrict__ ew, float* __restrict__ dap, Dims d,
                   BwdFlags f) {
  const int h = blockIdx.x % d.H, bc = blockIdx.x / d.H;
  const int b = bc / d.nc, c = bc % d.nc;
  const int s0 = c * d.Q, qv = min(d.Q, d.S - s0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int Qp = d.Qp, P = d.P, N = d.N, Mt = Qp / 16;
  const int YS = stride4(kPB), MS = stride8(Qp), RS = stride4(kNC);
  extern __shared__ float4 smem4[];
  float* Ys = reinterpret_cast<float*>(smem4);   // Qp x YS: dy
  float* Xs = Ys + Qp * YS;                      // Qp x YS: x
  float* Ms = Xs + Qp * YS;                      // Qp x MS: M
  float* ring = Ms + Qp * MS;                    // 2 x (Qp + kPB) x RS
  double* rowp = reinterpret_cast<double*>(ring + 2 * (Qp + kPB) * RS);
  double* colp = rowp + 4 * Qp;   // rowp[q][i]: sum over column block q
  double* dcum = colp + 8 * Qp;   // colp[t][j]: sum over m-tile t
  float* cum = reinterpret_cast<float*>(dcum + Qp);
  float* dts = cum + Qp;
  float* ev = dts + Qp;           // exp(cum_i)
  float* wv = ev + Qp;            // exp(cum_last - cum_j) dt_j
  float* colR = wv + Qp;          // sum_i R_ij
  float* dw = colR + Qp;          // x_j . U_j
  float* de = dw + Qp;            // dy_i . V_i
  float* dwp = de + Qp;           // 2 x Qp: dw's parts by column half
  float* dep = dwp + 2 * Qp;      // 2 x Qp
  float* red = dep + 2 * Qp;      // kThreads

  const long long ys = (long long)d.H * P;   // dy's and dx's row stride
  const long long pn = (long long)P * N;
  const float* xg = x + b * d.xb + s0 * d.xs + h * P;
  const float* dyg = dy + ((long long)b * d.S + s0) * ys + h * P;
  const float* bg = Bm + b * d.nb + s0 * d.ns;
  const float* cgm = Cm + b * d.nb + s0 * d.ns;
  const float* Sg = entering + (((long long)b * d.nc + c) * d.H + h) * pn;
  const float* Gg = gst + (((long long)b * d.nc + c) * d.H + h) * pn;
  const float* cbg = cb + ((long long)b * d.nc + c) * Qp * Qp;
  float* dcbg = dcbh + (((long long)b * d.nc + c) * d.H + h) * Qp * Qp;
  float* ewg = ew + (((long long)b * d.H + h) * d.nc + c) * 2 * Qp;
  float* dxg = dx + ((long long)b * d.S + s0) * ys + h * P;

  // the streamed products' k-chunks of 32 columns of N, for the P slice at
  // p0 (pv rows of G and S): steps 0 .. nr - 1 stage B and G, steps nr ..
  // 2 nr - 1 C and S, into stage step % 2
  const int nr = (d.Np + kNC - 1) / kNC;
  auto stream = [&](int step, int p0, int pv) {
    float* st = ring + (step & 1) * (Qp + kPB) * RS;
    const bool u = step < nr;
    const int n0 = (u ? step : step - nr) * kNC, nw = min(kNC, N - n0);
    load_tile(st, RS, (u ? bg : cgm) + n0, d.ns, Qp, qv, kNC, nw, f.vecn);
    load_tile(st + Qp * RS, RS, (u ? Gg : Sg) + (long long)p0 * N + n0, N,
              kPB, pv, kNC, nw, f.vecs);
    cp_async_commit();
  };
  const int np = (P + kPB - 1) / kPB;   // P chunks (dM's k), P slices (dx's)
  stream(0, 0, min(kPB, P));            // in flight through steps 1-2

  const float* cg = cum_in + (((long long)b * d.H + h) * d.nc + c) * Qp;
  for (int r = tid; r < Qp; r += kThreads) {
    cum[r] = cg[r];
    dts[r] = r < qv ? dt[((long long)b * d.S + s0 + r) * d.H + h] : 0.f;
    dw[r] = de[r] = 0.f;
  }
  __syncthreads();
  const float cum_last = cum[Qp - 1];
  for (int r = tid; r < Qp; r += kThreads) {
    ev[r] = expf(cum[r]);
    wv[r] = expf(cum_last - cum[r]) * dts[r];
    ewg[r] = ev[r];
    ewg[Qp + r] = wv[r];
  }

  // 1. dM = dy . x^T: this warp's jobs (m-tile jt, 32-column block jq)
  int jt[3] = {-1, -1, -1}, jq[3] = {0, 0, 0};
  for (int t = 0, idx = 0; t < Mt; ++t)
    for (int q = 0; q <= t / 2; ++q, ++idx)
#pragma unroll
      for (int s = 0; s < 3; ++s)
        if (idx == warp + kWarps * s) jt[s] = t, jq[s] = q;
  // the jobs' chunk scores (step 2's), in flight with dy's and x's copies
  float2 cbv[3][4][2];
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = 16 * jt[s] + gq + 8 * hf, j = 32 * jq[s] + 8 * nt + 2 * tq;
        cbv[s][nt][hf] =
            jt[s] >= 0 && j < Qp
                ? *reinterpret_cast<const float2*>(cbg + (long long)i * Qp + j)
                : make_float2(0.f, 0.f);
      }
  float run[3][4][4];
#pragma unroll
  for (int s = 0; s < 3; ++s) zero(run[s]);
  for (int pc = 0; pc < np; ++pc) {
    const int p0 = pc * kPB, pw = min(kPB, P - p0);
    if (pc > 0) __syncthreads();   // every warp is done with the last chunk
    load_tile(Ys, YS, dyg + p0, ys, Qp, qv, kPB, pw, f.vecy);
    load_tile(Xs, YS, xg + p0, d.xs, Qp, qv, kPB, pw, f.vecx);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    const int kend = round_up(pw, 8);
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      if (jt[s] < 0) continue;
      const int i0 = 16 * jt[s], j0 = 32 * jq[s];
      float sl[4][4], sh[4][4];
      zero(sl);
      zero(sh);
      for (int k0 = 0; k0 < kend; k0 += 8) {
        const float* ya = Ys + (i0 + gq) * YS + k0 + tq;
        FragA fa;
        fa.set(ya[0], ya[8 * YS], ya[4], ya[8 * YS + 4]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (j0 + 8 * nt < Qp) {
            const float* xb = Xs + (j0 + 8 * nt + gq) * YS + k0 + tq;
            FragB bf;
            bf.set(xb[0], xb[4]);
            mma3(sl[nt], sh[nt], fa, bf);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) run[s][nt][e] += sl[nt][e] + sh[nt][e];
    }
  }

  // 2. M, this head's dCB (its jobs' tiles; 0 above the diagonal) and the
  // sums of R, one expf a pair: R dt by rows (rowp[jq][i]), R by columns
  // (colp[jt][j])
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    if (jt[s] < 0) continue;
    const int i0 = 16 * jt[s], j0 = 32 * jq[s];
    double racc[2] = {0.0, 0.0}, cacc[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      cacc[nt][0] = cacc[nt][1] = 0.0;
      if (j0 + 8 * nt >= Qp) continue;
      const int j = j0 + 8 * nt + 2 * tq;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = i0 + gq + 8 * hf;
        const float gv[2] = {cbv[s][nt][hf].x, cbv[s][nt][hf].y};
        float m[2], dc[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool in = j + e <= i && i < qv;
          const float L = expf(in ? cum[i] - cum[j + e] : 0.f);
          const float a = in ? L * dts[j + e] : 0.f;
          const float g = in ? gv[e] : 0.f;
          const float v = run[s][nt][2 * hf + e];
          m[e] = g * a;
          dc[e] = a * v;
          const float r = g * L * v;
          racc[hf] += (double)r * (double)dts[j + e];
          cacc[nt][e] += (double)r;
        }
        *reinterpret_cast<float2*>(Ms + i * MS + j) = make_float2(m[0], m[1]);
        *reinterpret_cast<float2*>(dcbg + (long long)i * Qp + j) =
            make_float2(dc[0], dc[1]);
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const double r = sum_tq(racc[hf]);
      if (tq == 0) rowp[jq[s] * Qp + i0 + gq + 8 * hf] = r;
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const double v = sum_gq(cacc[nt][e]);
        if (gq == 0 && j0 + 8 * nt < Qp)
          colp[jt[s] * Qp + j0 + 8 * nt + 2 * tq + e] = v;
      }
  }
  __syncthreads();

  // 3. per P slice: warp w owns the m-tiles a = w % 4 and 7 - a of the
  // Qp rows and the 32 columns 32 (w / 4) of the slice
  const int n0 = 32 * (warp >> 2);
  const int mt[2] = {warp & 3, 7 - (warp & 3)};
  for (int ps = 0; ps < np; ++ps) {
    const int p0 = ps * kPB, pv = min(kPB, P - p0);
    if (np > 1) {   // dy and x hold dM's last k-chunk: this slice's instead
      load_tile(Ys, YS, dyg + p0, ys, Qp, qv, kPB, pv, f.vecy);
      load_tile(Xs, YS, xg + p0, d.xs, Qp, qv, kPB, pv, f.vecx);
      cp_async_commit();
    }
    if (ps > 0) stream(0, p0, pv);
    cp_async_wait_all();
    __syncthreads();
    const bool on = mt[0] < Mt && n0 < pv;
    float ox[2][4][4], sl[2][4][4], sh[2][4][4];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      zero(sl[s]);
      zero(sh[s]);
    }
    if (on) {   // M^T . dy: m-tile s's k-range starts at its first row
      const int kend = round_up(qv, 8);
      for (int k0 = 16 * mt[0]; k0 < kend; k0 += 8) {
        bool go[2];
        FragA fa[2];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          go[s] = mt[s] < Mt && k0 >= 16 * mt[s];
          if (go[s]) {
            const float* ma = Ms + (k0 + tq) * MS + 16 * mt[s] + gq;
            fa[s].set(ma[0], ma[8], ma[4 * MS], ma[4 * MS + 8]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (n0 + 8 * nt >= pv) continue;
          const float* yb = Ys + (k0 + tq) * YS + n0 + 8 * nt + gq;
          FragB bf;
          bf.set(yb[0], yb[4 * YS]);
#pragma unroll
          for (int s = 0; s < 2; ++s)
            if (go[s]) mma3(sl[s][nt], sh[s][nt], fa[s], bf);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ox[s][nt][e] = sl[s][nt][e] + sh[s][nt][e];
          sl[s][nt][e] = sh[s][nt][e] = 0.f;
        }

    // U = B . G^T (steps 0 .. nr - 1), then V = C . S^T
    for (int step = 0; step < 2 * nr; ++step) {
      if (step + 1 < 2 * nr) {
        stream(step + 1, p0, pv);
        cp_async_wait_prev();
      } else {
        cp_async_wait_all();
      }
      __syncthreads();
      const float* As = ring + (step & 1) * (Qp + kPB) * RS;
      const float* Bs = As + Qp * RS;
      const int kw = min(kNC, d.Np - (step < nr ? step : step - nr) * kNC);
      if (on) {
        for (int k0 = 0; k0 < kw; k0 += 8) {
          FragA fa[2];
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            if (mt[s] < Mt) {
              const float* aa = As + (16 * mt[s] + gq) * RS + k0 + tq;
              fa[s].set(aa[0], aa[8 * RS], aa[4], aa[8 * RS + 4]);
            }
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            if (n0 + 8 * nt >= pv) continue;
            const float* bb = Bs + (n0 + 8 * nt + gq) * RS + k0 + tq;
            FragB bf;
            bf.set(bb[0], bb[4]);
#pragma unroll
            for (int s = 0; s < 2; ++s)
              if (mt[s] < Mt) mma3(sl[s][nt], sh[s][nt], fa[s], bf);
          }
        }
      }
      const bool u_done = step == nr - 1, v_done = step == 2 * nr - 1;
      if (on && (u_done || v_done)) {
        // U: dx = M^T.dy + w o U and the row sums of x o U; V: of dy o V
        const float* rows = u_done ? Xs : Ys;
        float* parts = (u_done ? dwp : dep) + (warp >> 2) * Qp;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          if (mt[s] >= Mt) continue;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int j = 16 * mt[s] + gq + 8 * hf;
            float part = 0.f;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const int p = n0 + 8 * nt + 2 * tq;
              const float u0 = sl[s][nt][2 * hf] + sh[s][nt][2 * hf];
              const float u1 = sl[s][nt][2 * hf + 1] + sh[s][nt][2 * hf + 1];
              part += rows[j * YS + p] * u0 + rows[j * YS + p + 1] * u1;
              if (u_done && j < qv)
                store2(dxg + (long long)j * ys + p0 + p, p, pv, f.dx2,
                       ox[s][nt][2 * hf] + wv[j] * u0,
                       ox[s][nt][2 * hf + 1] + wv[j] * u1);
            }
            part = sum_tq(part);
            if (tq == 0) parts[j] = part;
          }
        }
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          zero(sl[s]);
          zero(sh[s]);
        }
      }
      __syncthreads();   // the stage is free for the copies of step + 2
    }
    for (int r = tid; r < Qp; r += kThreads) {
      dw[r] += dwp[r] + (pv > 32 ? dwp[Qp + r] : 0.f);
      de[r] += dep[r] + (pv > 32 ? dep[Qp + r] : 0.f);
    }
    __syncthreads();
  }

  // 4. <G, S_enter>, a thread's loads in flight together
  float part = 0.f;
  if (f.vecs) {
    const float4* g4 = reinterpret_cast<const float4*>(Gg);
    const float4* s4 = reinterpret_cast<const float4*>(Sg);
    for (long long e0 = tid; e0 < pn / 4; e0 += 8 * kThreads) {
      float4 gv[8], sv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const long long e = e0 + u * kThreads;
        gv[u] = e < pn / 4 ? g4[e] : make_float4(0.f, 0.f, 0.f, 0.f);
        sv[u] = e < pn / 4 ? s4[e] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        part += gv[u].x * sv[u].x + gv[u].y * sv[u].y + gv[u].z * sv[u].z +
                gv[u].w * sv[u].w;
    }
  } else {
    for (long long e = tid; e < pn; e += kThreads) part += Gg[e] * Sg[e];
  }
  red[tid] = part;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  const float dgamma = red[0];

  // d cum (every row's parts exist: row i's column blocks q <= i / 32,
  // column j's m-tiles t >= j / 16 are jobs), then warp 0: its reversed
  // prefix sum d(dt A) (4 rows a lane, then a suffix scan over the lanes),
  // the dA term
  for (int r = tid; r < Qp; r += kThreads) {
    double rt = 0.0, cs = 0.0;
    for (int q = 0; q <= r / 32; ++q) rt += rowp[q * Qp + r];
    for (int t = r / 16; t < Mt; ++t) cs += colp[t * Qp + r];
    colR[r] = (float)cs;
    dcum[r] = rt - (double)dts[r] * cs - (double)(wv[r] * dw[r]) +
              (double)(ev[r] * de[r]);
  }
  __syncthreads();
  if (warp == 0) {
    constexpr int kE = kMaxQ / 32;
    const int E = (Qp + 31) / 32;
    double v[kE], ww = 0.0;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int k = lane * E + e;
      const bool in = e < E && k < Qp;
      v[e] = in ? dcum[k] : 0.0;
      ww += in ? (double)(wv[k] * dw[k]) : 0.0;
    }
    ww = sum_warp(ww);
    const double last = ww + (double)(expf(cum_last) * dgamma);
#pragma unroll
    for (int e = 0; e < kE; ++e)
      if (e < E && lane * E + e == Qp - 1) v[e] += last;
    double tot = 0.0;
#pragma unroll
    for (int e = kE - 1; e >= 0; --e) {
      tot += v[e];
      v[e] = tot;
    }
    double inc = tot;   // the sum over this lane and those above it
    for (int o = 1; o < 32; o <<= 1) {
      const double up = __shfl_down_sync(0xffffffffu, inc, o);
      if (lane + o < 32) inc += up;
    }
    double above = __shfl_down_sync(0xffffffffu, inc, 1);
    if (lane == 31) above = 0.0;
    double a = 0.0;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int k = lane * E + e;
      if (e < E && k < Qp) {
        const double dk = v[e] + above;
        dcum[k] = dk;
        a += dk * (double)dts[k];
      }
    }
    a = sum_warp(a);
    if (lane == 0) dap[((long long)b * d.nc + c) * d.H + h] = (float)a;
  }
  __syncthreads();
  const float Ah = A[h];
  for (int r = tid; r < qv; r += kThreads)
    ddt[((long long)b * d.S + s0 + r) * d.H + h] =
        colR[r] + expf(cum_last - cum[r]) * dw[r] + Ah * (float)dcum[r];
}

// B4: dCB summed over the heads, in order; 0 above the diagonal
__global__ void __launch_bounds__(kThreads)
ssd_scan_bwd_head_sum(const float* __restrict__ dcbh, float* __restrict__ dcb,
                      Dims d) {
  const long long qq = (long long)d.Qp * d.Qp;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)d.B * d.nc * qq) return;
  const int ij = (int)(t % qq);
  float s = 0.f;
  if (ij % d.Qp <= ij / d.Qp) {
    const float* src = dcbh + (t / qq) * d.H * qq + ij;
    for (int h = 0; h < d.H; ++h) s += src[h * qq];
  }
  dcb[t] = s;
}

// B5's shared memory (floats): two stages of an A tile (Qp x 64, or 64 x
// Qp for dCB^T) and a B tile (64 x 64): 104 KB at Qp = 128, two CTAs an SM
__host__ __device__ constexpr size_t bc_a_floats(int Qp) {
  return (size_t)Qp * stride4(kPB) > (size_t)kPB * stride8(Qp)
             ? (size_t)Qp * stride4(kPB)
             : (size_t)kPB * stride8(Qp);
}
__host__ __device__ constexpr size_t bwd_bc_floats(int Qp) {
  return 2 * (bc_a_floats(Qp) + (size_t)kPB * stride8(kPB));
}
// B5's head groups: the heads' k-range in chunks of at most 64 terms of one
// head, kGroupChunks chunks a group (the last one ragged)
__host__ __device__ constexpr int bc_groups(int H, int P) {
  return (H * ((P + kPB - 1) / kPB) + kGroupChunks - 1) / kGroupChunks;
}

// one k-chunk of B5 into the accumulators: A from As at stride AS (kKM:
// its rows are k, as dCB^T's; else they are m, each scaled by sc as its
// fragment is split), B from Bs (rows k, 64 columns)
template <bool kKM>
__device__ __forceinline__ void bc_chunk(float (&sl)[2][4][4],
                                         float (&sh)[2][4][4],
                                         const float* As, int AS,
                                         const float* Bs, int kw,
                                         const int (&mt)[2],
                                         const bool (&on)[2], int n0, int nw,
                                         const float (&sc)[2][2]) {
  const int lane = threadIdx.x % 32, gq = lane >> 2, tq = lane & 3;
  const int BS = stride8(kPB);
  for (int k0 = 0; k0 < kw; k0 += 8) {
    FragA fa[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (!on[s]) continue;
      if (kKM) {
        const float* a = As + (k0 + tq) * AS + 16 * mt[s] + gq;
        fa[s].set(a[0], a[8], a[4 * AS], a[4 * AS + 8]);
      } else {
        const float* a = As + (16 * mt[s] + gq) * AS + k0 + tq;
        fa[s].set(a[0] * sc[s][0], a[8 * AS] * sc[s][1], a[4] * sc[s][0],
                  a[8 * AS + 4] * sc[s][1]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (n0 + 8 * nt >= nw) continue;
      const float* bb = Bs + (k0 + tq) * BS + n0 + 8 * nt + gq;
      FragB bf;
      bf.set(bb[0], bb[4 * BS]);
#pragma unroll
      for (int s = 0; s < 2; ++s)
        if (on[s]) mma3(sl[s][nt], sh[s][nt], fa[s], bf);
    }
  }
}

// B5: one (batch, chunk, group, dC (which 0) or dB (which 1), 64 columns of
// N), its Qp rows: group 0 dCB.B or dCB^T.C (dCB is 0 above the diagonal),
// group g >= 1 the state parts of its k-chunks, (e o dy_h).S_h or
// (w o x_h).G_h, each chunk staged through two stages while the last one is
// summed; a partial into part[g][which] (B, S, N).  Warp w owns the m-tiles
// w % 4 and w % 4 + 4 and the 32 columns 32 (w / 4) of the tile.  Columns
// of N vary fastest over the grid, then dC / dB: the CTAs that share an A
// tile run together.
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_bwd_bc(const float* __restrict__ x, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ dy,
                const float* __restrict__ dcb, const float* __restrict__ ew,
                const float* __restrict__ entering,
                const float* __restrict__ gst, float* __restrict__ part,
                Dims d, BwdFlags f) {
  const int nh = (d.Np + kPB - 1) / kPB, G = 1 + bc_groups(d.H, d.P);
  int idx = blockIdx.x;
  const int nb0 = (idx % nh) * kPB;
  idx /= nh;
  const int which = idx % 2;
  idx /= 2;
  const int g = idx % G;
  idx /= G;
  const int c = idx % d.nc, b = idx / d.nc;
  const int s0 = c * d.Q, qv = min(d.Q, d.S - s0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int Qp = d.Qp, P = d.P, N = d.N, HP = d.H * d.P, Mt = Qp / 16;
  const int YS = stride4(kPB), MS = stride8(Qp), BS = stride8(kPB);
  const int nw = min(kPB, d.Np - nb0), nv = min(kPB, N - nb0);
  const int cph = (P + kPB - 1) / kPB, u0 = (g - 1) * kGroupChunks;
  const int nk = g == 0 ? (Qp + kPB - 1) / kPB
                        : min(kGroupChunks, d.H * cph - u0);
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);
  const size_t stage = bc_a_floats(Qp) + (size_t)kPB * BS;
  const float* dcbc = dcb + ((long long)b * d.nc + c) * Qp * Qp;
  const float* bcm = (which ? Cm : Bm) + b * d.nb + s0 * d.ns + nb0;
  const float* rows = which ? x + b * d.xb + s0 * d.xs
                            : dy + ((long long)b * d.S + s0) * HP;
  const long long rs = which ? d.xs : HP;
  const float* st =
      (which ? gst : entering) + ((long long)b * d.nc + c) * HP * N + nb0;
  // e (which 0) or w (which 1) of head h, row r: ewc[h * ewh + r]
  const float* ewc =
      ew + ((long long)b * d.H * d.nc + c) * 2 * Qp + (which ? Qp : 0);
  const long long ewh = (long long)d.nc * 2 * Qp;

  auto load = [&](int k, float* sb) {
    float* As = sb;
    float* Bs = sb + bc_a_floats(Qp);
    if (g == 0) {
      const int k0 = k * kPB, kw = min(kPB, Qp - k0);
      if (which == 0)   // dCB's rows i, its columns j in [k0, k0 + kw)
        load_tile(As, YS, dcbc + k0, Qp, Qp, Qp, kPB, kw, true);
      else              // dCB's rows i in [k0, k0 + kw), every column
        load_tile(As, MS, dcbc + (long long)k0 * Qp, Qp, kPB, kw, Qp, Qp,
                  true);
      load_tile(Bs, BS, k0 < qv ? bcm + (long long)k0 * d.ns : bcm, d.ns,
                kPB, qv - k0, kPB, nv, f.vecn);
    } else {
      const int u = u0 + k, hh = u / cph, p0 = (u % cph) * kPB;
      const int kw = min(kPB, P - p0);
      load_tile(As, YS, rows + hh * P + p0, rs, Qp, qv, kPB, kw,
                which ? f.vecx : f.vecy);
      load_tile(Bs, BS, st + ((long long)hh * P + p0) * N, N, kPB, kw, kPB,
                nv, f.vecs);
    }
    cp_async_commit();
  };

  const int mt[2] = {warp & 3, (warp & 3) + 4};
  const int n0 = 32 * (warp >> 2);
  const bool on[2] = {mt[0] < Mt && n0 < nw, mt[1] < Mt && n0 < nw};
  float sl[2][4][4], sh[2][4][4];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    zero(sl[s]);
    zero(sh[s]);
  }
  load(0, buf);
  for (int k = 0; k < nk; ++k) {
    if (k + 1 < nk) {
      load(k + 1, buf + ((k + 1) & 1) * stage);
      cp_async_wait_prev();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const float* As = buf + (k & 1) * stage;
    const float* Bs = As + bc_a_floats(Qp);
    float sc[2][2] = {{1.f, 1.f}, {1.f, 1.f}};
    int kw = min(kPB, Qp - k * kPB);
    if (g > 0) {
      const int u = u0 + k, hh = u / cph;
      kw = round_up(min(kPB, P - (u % cph) * kPB), 8);
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          sc[s][hf] = on[s] ? ewc[hh * ewh + 16 * mt[s] + gq + 8 * hf] : 0.f;
    }
    if (on[0]) {
      if (g == 0 && which == 1)
        bc_chunk<true>(sl, sh, As, MS, Bs, kw, mt, on, n0, nw, sc);
      else
        bc_chunk<false>(sl, sh, As, YS, Bs, kw, mt, on, n0, nw, sc);
    }
    __syncthreads();   // the stage is free for the copies of chunk k + 2
  }
  if (!on[0]) return;
  float* out = part + (((long long)g * 2 + which) * d.B * d.S +
                       (long long)b * d.S + s0) * N + nb0;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (!on[s]) continue;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n0 + 8 * nt + 2 * tq;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = 16 * mt[s] + gq + 8 * hf;
        if (i < qv)
          store2(out + (long long)i * N + n, n, nv, N % 2 == 0,
                 sl[s][nt][2 * hf] + sh[s][nt][2 * hf],
                 sl[s][nt][2 * hf + 1] + sh[s][nt][2 * hf + 1]);
      }
    }
  }
}

// B6: dC and dB, the partials of the groups summed in order (group 0, the
// scores' part, first); the last CTA dA, the (batch, chunk) terms of each
// head summed in order
__global__ void __launch_bounds__(kThreads)
ssd_scan_bwd_sum(const float* __restrict__ part, const float* __restrict__ dap,
                 float* __restrict__ dBm, float* __restrict__ dCm,
                 float* __restrict__ dA, Dims d) {
  if (blockIdx.x == gridDim.x - 1) {
    for (int h = threadIdx.x; h < d.H; h += kThreads) {
      double s = 0.0;
      for (int bc = 0; bc < d.B * d.nc; ++bc)
        s += dap[(long long)bc * d.H + h];
      dA[h] = (float)s;
    }
    return;
  }
  const long long E = (long long)d.B * d.S * d.N;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= 2 * E) return;
  const int G = 1 + bc_groups(d.H, d.P);
  float s = 0.f;
  for (int g = 0; g < G; ++g) s += part[(long long)g * 2 * E + t];
  (t < E ? dCm : dBm)[t % E] = s;
}

bool aligned(const void* p, int bytes) {
  return ((uintptr_t)p & (bytes - 1)) == 0;
}

// The passes' scratch: one buffer, carved in this order into parts that
// start a multiple of 256 bytes from its start: the chunk scores cb (B, nc,
// Qp, Qp), the in-chunk cumsums cum (B, H, nc, Qp), the chunks' own states
// and the states entering them (B, nc, H, P, N) each.  The backward's
// buffer continues with the final state it does not return (B, H, P, N),
// the state gradients G (B, nc, H, P, N), each head's dCB (B, nc, H, Qp,
// Qp) and their sum (B, nc, Qp, Qp), e and w (B, H, nc, 2, Qp), the
// chunks' dA terms (B, nc, H) and B5's partials of dC and dB (groups, 2, B,
// S, N); its first pass writes D_c over the chunk states.  Returns the
// floats; a null base only counts them.
struct Scratch {
  float *cb, *cum, *states, *entering;
  float *fin, *gst, *dcbh, *dcb, *ew, *dap, *part;
};
size_t carve(const Dims& d, float* base, Scratch* out, bool backward) {
  const size_t st = (size_t)d.B * d.nc * d.H * d.P * d.N;
  const size_t bcq = (size_t)d.B * d.nc * d.Qp * d.Qp;
  const size_t parts[11] = {bcq, (size_t)d.B * d.H * d.nc * d.Qp, st, st,
                            (size_t)d.B * d.H * d.P * d.N, st, bcq * d.H, bcq,
                            (size_t)d.B * d.H * d.nc * 2 * d.Qp,
                            (size_t)d.B * d.nc * d.H,
                            (size_t)(1 + bc_groups(d.H, d.P)) * 2 * d.B *
                                d.S * d.N};
  float** to[11] = {&out->cb,  &out->cum,  &out->states, &out->entering,
                    &out->fin, &out->gst,  &out->dcbh,   &out->dcb,
                    &out->ew,  &out->dap,  &out->part};
  size_t at = 0;
  for (int i = 0; i < (backward ? 11 : 4); ++i) {
    if (base != nullptr) *to[i] = base + at;
    at += (parts[i] + 63) / 64 * 64;
  }
  return at;
}

Dims dims(int B, int S, int H, int P, int N, int Q) {
  Dims d;
  d.B = B, d.S = S, d.H = H, d.P = P, d.N = N, d.Q = Q;
  d.xb = d.xs = d.nb = d.ns = 0;
  d.nc = (S + Q - 1) / Q;
  d.Qp = round_up(Q, 16);
  d.Np = round_up(N, 8);
  d.st2 = d.y2 = false;
  return d;
}

// Opt in to the large shared memory every pass takes, once, before any
// graph capture (warm-up calls)
int set_attributes() {
  static bool done = false;
  if (done) return 0;
  const struct {
    const void* fn;
    size_t floats;
  } big[] = {
      {(const void*)ssd_scan_chunk_scores, scores_floats(kMaxQ, kMaxN)},
      {(const void*)ssd_scan_chunk_states<false>, states_floats(kMaxQ, kMaxN)},
      {(const void*)ssd_scan_chunk_states<true>, states_floats(kMaxQ, kMaxN)},
      {(const void*)ssd_scan_chunk_scan, scan_floats(kMaxQ, kMaxN)},
      {(const void*)ssd_scan_bwd_chunk, bwd_chunk_floats(kMaxQ)},
      {(const void*)ssd_scan_bwd_bc, bwd_bc_floats(kMaxQ)}};
  for (const auto& k : big) {
    const cudaError_t err = cudaFuncSetAttribute(
        k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(sizeof(float) * k.floats));
    if (err != cudaSuccess) return (int)err;
  }
  done = true;
  return 0;
}

// The launches both entry points share: what the kernels read of the
// layout, then passes 1-3 (chunk scores, cum and the chunk states, the
// entering states and the final one).
struct Plan {
  Dims d;
  Scratch sc;
  bool vecx, vecn, vec_pass;
  long long cells;
};
Plan plan(const void* x, const void* Bm, const void* Cm, const void* init,
          const void* fstate, void* scratch, bool backward, int B, int S,
          int H, int P, int N, int Q, long long xb, long long xs,
          long long nb, long long ns) {
  Plan p;
  p.d = dims(B, S, H, P, N, Q);
  p.d.xb = xb, p.d.xs = xs, p.d.nb = nb, p.d.ns = ns;
  carve(p.d, (float*)scratch, &p.sc, backward);
  if (!backward) p.sc.fin = (float*)fstate;
  p.d.st2 = N % 2 == 0 && aligned(p.sc.states, 8);
  // 16-byte copies need every row start 16-byte aligned
  p.vecx = P % 4 == 0 && xb % 4 == 0 && xs % 4 == 0 && aligned(x, 16);
  p.vecn = N % 4 == 0 && nb % 4 == 0 && ns % 4 == 0 && aligned(Bm, 16) &&
           aligned(Cm, 16) && aligned(p.sc.entering, 16);
  p.vec_pass = N % 4 == 0 && aligned(p.sc.states, 16) &&
               aligned(p.sc.entering, 16) && aligned(p.sc.fin, 16) &&
               (init == nullptr || aligned(init, 16));
  p.cells = (long long)B * p.d.nc * H * ((P + kPS - 1) / kPS);
  return p;
}

void forward_passes(const Plan& p, const float* x, const float* dt,
                    const float* A, const float* Bm, const float* Cm,
                    const float* init, cudaStream_t s) {
  const Dims& d = p.d;
  ssd_scan_chunk_scores<<<(unsigned)(4 * d.B * d.nc), kThreads,
                          sizeof(float) * scores_floats(d.Qp, d.Np), s>>>(
      Bm, Cm, p.sc.cb, d, p.vecn);
  ssd_scan_chunk_states<false><<<(unsigned)p.cells, kThreads,
                                 sizeof(float) * states_floats(d.Qp, d.Np),
                                 s>>>(x, dt, A, Bm, p.sc.cum, p.sc.states, d,
                                      p.vecx, p.vecn);
  const long long elems = (long long)d.B * d.H * d.P * d.N;
  if (p.vec_pass)
    ssd_scan_state_pass<4>
        <<<(unsigned)((elems / 4 + kThreads - 1) / kThreads), kThreads, 0,
           s>>>(p.sc.cum, init, p.sc.states, p.sc.entering, p.sc.fin, d);
  else
    ssd_scan_state_pass<1>
        <<<(unsigned)((elems + kThreads - 1) / kThreads), kThreads, 0, s>>>(
            p.sc.cum, init, p.sc.states, p.sc.entering, p.sc.fin, d);
}

}  // namespace

// The floats of scratch one call of repro_ssd_scan needs at these sizes,
// into *floats.  Q is the chunk length, min(chunk, S); 1 <= Q <= 128 and
// 1 <= N <= 128.
extern "C" int repro_ssd_scan_scratch(int B, int S, int H, int P, int N,
                                      int Q, long long* floats) {
  if (Q < 1 || Q > kMaxQ || N < 1 || N > kMaxN || B < 0 || S < 0 || H < 0 ||
      P < 0)
    return (int)cudaErrorInvalidValue;
  Scratch unused;
  *floats = (long long)carve(dims(B, S, H, P, N, Q), nullptr, &unused, false);
  return 0;
}

// The same for one call of repro_ssd_scan_bwd.
extern "C" int repro_ssd_scan_bwd_scratch(int B, int S, int H, int P, int N,
                                          int Q, long long* floats) {
  if (Q < 1 || Q > kMaxQ || N < 1 || N > kMaxN || B < 0 || S < 0 || H < 0 ||
      P < 0)
    return (int)cudaErrorInvalidValue;
  Scratch unused;
  *floats = (long long)carve(dims(B, S, H, P, N, Q), nullptr, &unused, true);
  return 0;
}

// x (B, S, H, P) with batch and row strides xb, xs (its (H, P) packed), dt
// (B, S, H), A (H,), Bm and Cm (B, S, N) with batch and row strides nb, ns
// (N packed), init (B, H, P, N) or null for a zero state; y (B, S, H, P)
// and fstate (B, H, P, N); scratch of the floats repro_ssd_scan_scratch
// gives.  All float32, contiguous but for the strides named.  Q is the
// chunk length, min(chunk, S); 1 <= Q <= 128 and 1 <= N <= 128.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm,
                              const void* init, void* y, void* fstate,
                              void* scratch, int B, int S, int H, int P,
                              int N, int Q, long long xb, long long xs,
                              long long nb, long long ns, void* stream) {
  if (Q < 1 || Q > kMaxQ || N < 1 || N > kMaxN)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0) return 0;
  const int err = set_attributes();
  if (err != 0) return err;
  Plan p = plan(x, Bm, Cm, init, fstate, scratch, false, B, S, H, P, N, Q,
                xb, xs, nb, ns);
  p.d.y2 = P % 2 == 0 && aligned(y, 8);
  cudaStream_t s = (cudaStream_t)stream;
  forward_passes(p, (const float*)x, (const float*)dt, (const float*)A,
                 (const float*)Bm, (const float*)Cm, (const float*)init, s);
  ssd_scan_chunk_scan<<<(unsigned)p.cells, kThreads,
                        sizeof(float) * scan_floats(p.d.Qp, p.d.Np), s>>>(
      (const float*)x, (const float*)dt, (const float*)Cm, p.sc.cb, p.sc.cum,
      p.sc.entering, (float*)y, p.d, p.vecx, p.vecn);
  return (int)cudaGetLastError();
}

// The gradient of repro_ssd_scan: inputs as there, dy (B, S, H, P) and
// dfinal (B, H, P, N, or null: no gradient on the final state) contiguous;
// outputs dx (B, S, H, P), ddt (B, S, H), dA (H,), dBm, dCm (B, S, N) and
// dinit (B, H, P, N; null to skip it), contiguous; scratch of the floats
// repro_ssd_scan_bwd_scratch gives.
extern "C" int repro_ssd_scan_bwd(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* init, const void* dy, const void* dfinal,
    void* dx, void* ddt, void* dA, void* dBm, void* dCm, void* dinit,
    void* scratch, int B, int S, int H, int P, int N, int Q, long long xb,
    long long xs, long long nb, long long ns, void* stream) {
  if (Q < 1 || Q > kMaxQ || N < 1 || N > kMaxN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0)
    return H > 0 ? (int)cudaMemsetAsync(dA, 0, sizeof(float) * H, s) : 0;
  const int err = set_attributes();
  if (err != 0) return err;
  Plan p = plan(x, Bm, Cm, init, nullptr, scratch, true, B, S, H, P, N, Q,
                xb, xs, nb, ns);
  const Dims& d = p.d;
  const float *fx = (const float*)x, *fdt = (const float*)dt,
              *fA = (const float*)A, *fB = (const float*)Bm,
              *fC = (const float*)Cm, *fdy = (const float*)dy;
  forward_passes(p, fx, fdt, fA, fB, fC, (const float*)init, s);
  // B1: dy in x's place (its own strides), C in B's
  Dims dd = d;
  dd.xb = (long long)S * H * P, dd.xs = (long long)H * P;
  ssd_scan_chunk_states<true><<<(unsigned)p.cells, kThreads,
                                sizeof(float) * states_floats(d.Qp, d.Np),
                                s>>>(fdy, fdt, fA, fC, p.sc.cum, p.sc.states,
                                     dd, P % 4 == 0 && aligned(dy, 16),
                                     p.vecn);
  // B2
  const long long elems = (long long)B * H * P * N;
  const bool vec = N % 4 == 0 && aligned(p.sc.states, 16) &&
                   aligned(p.sc.gst, 16) &&
                   (dfinal == nullptr || aligned(dfinal, 16)) &&
                   (dinit == nullptr || aligned(dinit, 16));
  if (vec)
    ssd_scan_bwd_state_pass<4>
        <<<(unsigned)((elems / 4 + kThreads - 1) / kThreads), kThreads, 0,
           s>>>(p.sc.cum, (const float*)dfinal, p.sc.states, p.sc.gst,
                (float*)dinit, d);
  else
    ssd_scan_bwd_state_pass<1>
        <<<(unsigned)((elems + kThreads - 1) / kThreads), kThreads, 0, s>>>(
            p.sc.cum, (const float*)dfinal, p.sc.states, p.sc.gst,
            (float*)dinit, d);
  // B3
  BwdFlags f;
  f.vecx = p.vecx;
  f.vecy = P % 4 == 0 && aligned(dy, 16);
  f.vecn = p.vecn;
  f.vecs = N % 4 == 0 && aligned(p.sc.entering, 16) && aligned(p.sc.gst, 16);
  f.dx2 = P % 2 == 0 && aligned(dx, 8);
  ssd_scan_bwd_chunk<<<(unsigned)(B * d.nc * H), kThreads,
                       sizeof(float) * bwd_chunk_floats(d.Qp), s>>>(
      fx, fdt, fA, fB, fC, fdy, p.sc.cb, p.sc.cum, p.sc.entering, p.sc.gst,
      (float*)dx, (float*)ddt, p.sc.dcbh, p.sc.ew, p.sc.dap, d, f);
  // B4
  const long long qq = (long long)B * d.nc * d.Qp * d.Qp;
  ssd_scan_bwd_head_sum<<<(unsigned)((qq + kThreads - 1) / kThreads),
                          kThreads, 0, s>>>(p.sc.dcbh, p.sc.dcb, d);
  // B5: (batch, chunk, group, dC / dB, 64 columns of N)
  const long long ctas = (long long)B * d.nc * (1 + bc_groups(H, P)) * 2 *
                         ((d.Np + kPB - 1) / kPB);
  ssd_scan_bwd_bc<<<(unsigned)ctas, kThreads,
                    sizeof(float) * bwd_bc_floats(d.Qp), s>>>(
      fx, fB, fC, fdy, p.sc.dcb, p.sc.ew, p.sc.entering, p.sc.gst,
      p.sc.part, d, f);
  // B6: dC and dB from the partials, then (the last CTA) dA
  const long long e2 = 2LL * B * S * N;
  ssd_scan_bwd_sum<<<(unsigned)((e2 + kThreads - 1) / kThreads + 1),
                     kThreads, 0, s>>>(p.sc.part, p.sc.dap, (float*)dBm,
                                       (float*)dCm, (float*)dA, d);
  return (int)cudaGetLastError();
}
