// Chunked SSD scan (Mamba-2 forward) for Hopper (sm_90a): a chunk-parallel
// scan in four passes, its products on the tensor cores in 3xTF32.
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
// sum_j exp(cum_last - cum_j) dt_j x_j B_j^T for one P slice.
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
    wts[r] = expf(cum_last - cum[r]) * dts[r];
    if (e.p0 == 0) cg[r] = cum[r];
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

bool aligned(const void* p, int bytes) {
  return ((uintptr_t)p & (bytes - 1)) == 0;
}

// The passes' scratch: one buffer, carved in this order into parts that
// start a multiple of 256 bytes from its start: the chunk scores cb (B, nc,
// Qp, Qp), the in-chunk cumsums cum (B, H, nc, Qp), the chunks' own states
// and the states entering them (B, nc, H, P, N) each.  Returns its floats;
// a null base only counts them.
struct Scratch {
  float *cb, *cum, *states, *entering;
};
size_t carve(const Dims& d, float* base, Scratch* out) {
  const size_t parts[4] = {
      (size_t)d.B * d.nc * d.Qp * d.Qp, (size_t)d.B * d.H * d.nc * d.Qp,
      (size_t)d.B * d.nc * d.H * d.P * d.N,
      (size_t)d.B * d.nc * d.H * d.P * d.N};
  float** to[4] = {&out->cb, &out->cum, &out->states, &out->entering};
  size_t at = 0;
  for (int i = 0; i < 4; ++i) {
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
  *floats = (long long)carve(dims(B, S, H, P, N, Q), nullptr, &unused);
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
  static bool attribute_set = false;   // once, before any graph capture
  if (!attribute_set) {                // (warm-up calls)
    const struct {
      const void* fn;
      size_t floats;
    } big[] = {
        {(const void*)ssd_scan_chunk_scores, scores_floats(kMaxQ, kMaxN)},
        {(const void*)ssd_scan_chunk_states, states_floats(kMaxQ, kMaxN)},
        {(const void*)ssd_scan_chunk_scan, scan_floats(kMaxQ, kMaxN)}};
    for (const auto& k : big) {
      const cudaError_t err = cudaFuncSetAttribute(
          k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)(sizeof(float) * k.floats));
      if (err != cudaSuccess) return (int)err;
    }
    attribute_set = true;
  }
  Dims d = dims(B, S, H, P, N, Q);
  d.xb = xb, d.xs = xs, d.nb = nb, d.ns = ns;
  Scratch sc;
  carve(d, (float*)scratch, &sc);
  d.st2 = N % 2 == 0 && aligned(sc.states, 8);
  d.y2 = P % 2 == 0 && aligned(y, 8);
  // 16-byte copies need every row start 16-byte aligned
  const bool vecx =
      P % 4 == 0 && xb % 4 == 0 && xs % 4 == 0 && aligned(x, 16);
  const bool vecn = N % 4 == 0 && nb % 4 == 0 && ns % 4 == 0 &&
                    aligned(Bm, 16) && aligned(Cm, 16) &&
                    aligned(sc.entering, 16);
  const bool vec_pass = N % 4 == 0 && aligned(sc.states, 16) &&
                        aligned(sc.entering, 16) && aligned(fstate, 16) &&
                        (init == nullptr || aligned(init, 16));
  cudaStream_t s = (cudaStream_t)stream;
  const long long cells =
      (long long)B * d.nc * H * ((P + kPS - 1) / kPS);

  ssd_scan_chunk_scores<<<(unsigned)(4 * B * d.nc), kThreads,
                          sizeof(float) * scores_floats(d.Qp, d.Np), s>>>(
      (const float*)Bm, (const float*)Cm, sc.cb, d, vecn);
  ssd_scan_chunk_states<<<(unsigned)cells, kThreads,
                          sizeof(float) * states_floats(d.Qp, d.Np), s>>>(
      (const float*)x, (const float*)dt, (const float*)A, (const float*)Bm,
      sc.cum, sc.states, d, vecx, vecn);
  const long long elems = (long long)B * H * P * N;
  if (vec_pass)
    ssd_scan_state_pass<4>
        <<<(unsigned)((elems / 4 + kThreads - 1) / kThreads), kThreads, 0,
           s>>>(sc.cum, (const float*)init, sc.states, sc.entering,
                (float*)fstate, d);
  else
    ssd_scan_state_pass<1>
        <<<(unsigned)((elems + kThreads - 1) / kThreads), kThreads, 0, s>>>(
            sc.cum, (const float*)init, sc.states, sc.entering,
            (float*)fstate, d);
  ssd_scan_chunk_scan<<<(unsigned)cells, kThreads,
                        sizeof(float) * scan_floats(d.Qp, d.Np), s>>>(
      (const float*)x, (const float*)dt, (const float*)Cm, sc.cb, sc.cum,
      sc.entering, (float*)y, d, vecx, vecn);
  return (int)cudaGetLastError();
}
