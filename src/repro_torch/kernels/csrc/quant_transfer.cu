// Rowwise int8 quantization and dequantization for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/quant_transfer/quant_transfer.py::quantize_pallas
//   (body _quant_kernel) and ::dequantize_pallas (body _dequant_kernel).
// Per row of an (R, C) fp32 matrix:
//   scale = max(absmax(row), 1e-12) * fp32(1 / 127)
//   q     = clip(round_half_even(x / scale), -127, 127)      (int8)
//   out   = float(q) * scale                                 (dequantize)
// The reference writes `/ 127.0`, but its compiled program multiplies by the
// rounded reciprocal constant (XLA folds a division by a constant), so the
// scale here does the same and matches it bit for bit.  The division of x by
// the per-row scale is a true IEEE division in both (`x / scale`, never
// `x * (1 / scale)`), and the rounding is rintf (half to even, like
// jnp.round; roundf rounds half away from zero): either slip would flip
// codes at exact .5 ties.  Build without --use_fast_math, which would turn
// the division into an approximation.
//
// Bound on this card: both are one memory-bound pass.  quantize reads 4 B and
// writes 1 B per element (+4 B per row); dequantize the reverse.  At the main
// path's shapes (the VGG-5 cut at B=100: (25600, 32) and (6400, 64); the
// delta wire: (580, 1024)) that is 3-4 MB, 0.9-1.25 us at 3.35 TB/s, about
// the fixed cost of one launch.  What a kernel this small can do about it is
// keep enough bytes in flight from its first instruction and issue few,
// wide, coalesced accesses.
//
// Design: a row belongs to a group of G threads (a power of two): G of 32 or
// less is part of a warp, and a warp holds 32 / G rows; G above 32 is the
// whole CTA (one row per CTA).  Each thread holds, per pass over its row, V
// vectors of W elements, vector k of the pass at (pass * V + k) * G + t for
// thread t of the group: neighbouring threads take neighbouring vectors, so
// every access of a warp is contiguous.  W = 4 (a 16-byte float4 of x, a
// 4-byte char4 of codes) when C is a multiple of 4 and the input's rows
// start aligned (x 16-byte, q 4-byte), else W = 1.  The plan (G, W, V,
// threads per CTA) is chosen in Python (`quant_transfer._row_plan`: about 4
// elements a thread, up to 256 threads a row, then up to 8 vectors a
// thread, then passes; the CPU tests check its cover and limits) and
// checked again here.  Many threads with one vector each beat fewer
// threads with many: at (580, 1024) a CTA of 256 a row took 0.0031 ms, a
// warp a row with 8 float4 a lane 0.0039 (scripts/quant_ablation.py
// --sweep, H100 80GB HBM3, 700 W).
// - quantize: when G * V * W >= C the row is read once and stays in
//   registers (at most 32 floats a thread) through the absmax reduction
//   (shuffles over the group's width only, then, for a CTA group, one
//   shared-memory step) and the code pass.  A longer row is read twice, in
//   passes of G * V vectors: absmax, then the codes.  At (25600, 32): 8
//   threads a row, 4 rows a warp, one float4 each, one 128-byte store of
//   codes per warp.
// - dequantize: a thread loads its V code vectors before it stores any
//   (4 codes -> one float4).  The row comes from the thread's index by
//   shifts, not by a division, and its scale is read once.  (16 codes a
//   load, four float4 stores 64 bytes apart across the lanes, was 1.5-1.7x
//   slower at every main-path shape in this design's first sweep.)
// Offsets are 64-bit; a launch needs rows * cols to fit in a long long only.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 256;   // threads per CTA (the plan keeps to it)

__device__ __forceinline__ float quant_code(float x, float scale) {
  return fminf(fmaxf(rintf(x / scale), -127.0f), 127.0f);
}

// The largest |x| over the row's group: xor shuffles over the group's width
// (all 32 lanes of the warp take part, so the mask is full), then, when the
// group is the whole CTA, one step through shared memory.
__device__ __forceinline__ float group_absmax(float v, int group_log2) {
  const int width = group_log2 < 5 ? 1 << group_log2 : kWarp;
  for (int off = width >> 1; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (group_log2 > 5) {
    __shared__ float part[kMaxThreads / kWarp];
    if (threadIdx.x % kWarp == 0) part[threadIdx.x / kWarp] = v;
    __syncthreads();
    v = part[0];
    for (int w = 1; w < (int)(blockDim.x / kWarp); ++w) v = fmaxf(v, part[w]);
  }
  return v;
}

template <int W>
__device__ __forceinline__ void load_x(const float* __restrict__ xr, int i,
                                       bool in, float (&v)[W]) {
  if constexpr (W == 4) {
    const float4 f = in ? *reinterpret_cast<const float4*>(xr + 4LL * i)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
    v[0] = in ? xr[i] : 0.0f;
  }
}

template <int W>
__device__ __forceinline__ void store_codes(int8_t* __restrict__ qr, int i,
                                            const float (&v)[W], float scale) {
  if constexpr (W == 4) {
    *reinterpret_cast<char4*>(qr + 4LL * i) = make_char4(
        (signed char)quant_code(v[0], scale),
        (signed char)quant_code(v[1], scale),
        (signed char)quant_code(v[2], scale),
        (signed char)quant_code(v[3], scale));
  } else {
    qr[i] = (int8_t)quant_code(v[0], scale);
  }
}

template <int W, int V>
__global__ void __launch_bounds__(kMaxThreads)
quantize_rows_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scales, long long rows, int cols,
                     int group_log2) {
  const int group = 1 << group_log2;
  const int t = threadIdx.x & (group - 1);
  const long long row = (long long)blockIdx.x * (blockDim.x >> group_log2) +
                        (threadIdx.x >> group_log2);
  // a group past the last row loads nothing but still joins the shuffles
  const bool live = row < rows;
  const float* xr = x + (live ? row : 0) * cols;
  const int n = cols / W;           // vectors in the row (W divides cols)
  const int span = group * V;       // vectors per pass
  float v[V][W];
  float absmax = 0.0f;
  for (int base = 0; base < n; base += span) {   // one pass when resident
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = base + k * group + t;
      load_x<W>(xr, i, live && i < n, v[k]);
    }
#pragma unroll
    for (int k = 0; k < V; ++k)
#pragma unroll
      for (int w = 0; w < W; ++w) absmax = fmaxf(absmax, fabsf(v[k][w]));
  }
  absmax = group_absmax(absmax, group_log2);
  if (!live) return;
  const float scale = fmaxf(absmax, 1e-12f) * (1.0f / 127.0f);
  int8_t* qr = q + row * cols;
  if (t == 0) scales[row] = scale;
  if (n <= span) {                  // the row is in registers
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = k * group + t;
      if (i < n) store_codes<W>(qr, i, v[k], scale);
    }
    return;
  }
  for (int base = 0; base < n; base += span) {   // read the row again
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = base + k * group + t;
      load_x<W>(xr, i, i < n, v[k]);
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = base + k * group + t;
      if (i < n) store_codes<W>(qr, i, v[k], scale);
    }
  }
}

// Codes held by one thread for one vector: 4 in an int, or 1.
template <int W> struct Codes;
template <> struct Codes<4> { using T = int; };
template <> struct Codes<1> { using T = int8_t; };

__device__ __forceinline__ float4 decode4(int word, float s) {
  return make_float4((float)(signed char)(word) * s,
                     (float)(signed char)(word >> 8) * s,
                     (float)(signed char)(word >> 16) * s,
                     (float)(signed char)(word >> 24) * s);
}

template <int W, int V>
__global__ void __launch_bounds__(kMaxThreads)
dequantize_rows_kernel(const int8_t* __restrict__ q,
                       const float* __restrict__ scales,
                       float* __restrict__ out, long long rows, int cols,
                       int group_log2) {
  using T = typename Codes<W>::T;
  const int group = 1 << group_log2;
  const int t = threadIdx.x & (group - 1);
  const long long row = (long long)blockIdx.x * (blockDim.x >> group_log2) +
                        (threadIdx.x >> group_log2);
  if (row >= rows) return;          // no reduction here
  const float s = scales[row];
  const T* qr = reinterpret_cast<const T*>(q + row * cols);
  float* orow = out + row * cols;
  const int n = cols / W;
  const int span = group * V;
  for (int base = 0; base < n; base += span) {
    T c[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = base + k * group + t;
      if (i < n) c[k] = qr[i];
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = base + k * group + t;
      if (i >= n) continue;
      if constexpr (W == 4) {
        *reinterpret_cast<float4*>(orow + 4LL * i) = decode4(c[k], s);
      } else {
        orow[i] = (float)c[k] * s;
      }
    }
  }
}

// The plan as the Python wrapper gives it; anything else is refused
// (cudaErrorInvalidValue) rather than launched.
bool plan_ok(int cols, int group_log2, int width, int vecs, int threads,
             uintptr_t in, int in_align) {
  if (group_log2 < 0 || group_log2 > 8 || threads < kWarp ||
      threads > kMaxThreads || threads % kWarp != 0)
    return false;
  const int group = 1 << group_log2;
  if (group > kWarp ? group != threads : threads % group != 0) return false;
  if (vecs != 1 && vecs != 2 && vecs != 4 && vecs != 8) return false;
  return cols % width == 0 && in % in_align == 0;
}

template <int W>
int launch_quantize(int vecs, dim3 grid, int threads, cudaStream_t stream,
                    const float* x, int8_t* q, float* s, long long rows,
                    int cols, int group_log2) {
  switch (vecs) {
    case 1: quantize_rows_kernel<W, 1><<<grid, threads, 0, stream>>>(
                x, q, s, rows, cols, group_log2); break;
    case 2: quantize_rows_kernel<W, 2><<<grid, threads, 0, stream>>>(
                x, q, s, rows, cols, group_log2); break;
    case 4: quantize_rows_kernel<W, 4><<<grid, threads, 0, stream>>>(
                x, q, s, rows, cols, group_log2); break;
    default: quantize_rows_kernel<W, 8><<<grid, threads, 0, stream>>>(
                 x, q, s, rows, cols, group_log2); break;
  }
  return (int)cudaGetLastError();
}

template <int W>
int launch_dequantize(int vecs, dim3 grid, int threads, cudaStream_t stream,
                      const int8_t* q, const float* s, float* out,
                      long long rows, int cols, int group_log2) {
  switch (vecs) {
    case 1: dequantize_rows_kernel<W, 1><<<grid, threads, 0, stream>>>(
                q, s, out, rows, cols, group_log2); break;
    case 2: dequantize_rows_kernel<W, 2><<<grid, threads, 0, stream>>>(
                q, s, out, rows, cols, group_log2); break;
    case 4: dequantize_rows_kernel<W, 4><<<grid, threads, 0, stream>>>(
                q, s, out, rows, cols, group_log2); break;
    default: dequantize_rows_kernel<W, 8><<<grid, threads, 0, stream>>>(
                 q, s, out, rows, cols, group_log2); break;
  }
  return (int)cudaGetLastError();
}

dim3 grid_of(long long rows, int group_log2, int threads) {
  const long long per_cta = threads >> group_log2;   // rows a CTA
  return dim3((unsigned)((rows + per_cta - 1) / per_cta));
}

}  // namespace

// x (rows, cols) fp32 -> q (rows, cols) int8, scales (rows,) fp32, under the
// plan: 1 << group_log2 threads a row, `width` elements a vector (4 or 1),
// `vecs` vectors a thread per pass, `threads` threads a CTA.
extern "C" int repro_quantize_rows(const void* x, void* q, void* scales,
                                   long long rows, int cols, int group_log2,
                                   int width, int vecs, int threads,
                                   void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  if ((width != 4 && width != 1) ||
      !plan_ok(cols, group_log2, width, vecs, threads, (uintptr_t)x,
               width * 4))
    return (int)cudaErrorInvalidValue;
  const dim3 grid = grid_of(rows, group_log2, threads);
  const auto st = (cudaStream_t)stream;
  return width == 4
             ? launch_quantize<4>(vecs, grid, threads, st, (const float*)x,
                                  (int8_t*)q, (float*)scales, rows, cols,
                                  group_log2)
             : launch_quantize<1>(vecs, grid, threads, st, (const float*)x,
                                  (int8_t*)q, (float*)scales, rows, cols,
                                  group_log2);
}

// q (rows, cols) int8, scales (rows,) fp32 -> out (rows, cols) fp32 (out
// 16-byte aligned), under the plan: `width` codes a vector (4 or 1).
extern "C" int repro_dequantize_rows(const void* q, const void* scales,
                                     void* out, long long rows, int cols,
                                     int group_log2, int width, int vecs,
                                     int threads, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  if ((width != 4 && width != 1) ||
      !plan_ok(cols, group_log2, width, vecs, threads, (uintptr_t)q, width) ||
      (uintptr_t)out % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid = grid_of(rows, group_log2, threads);
  const auto st = (cudaStream_t)stream;
  const auto* qq = (const int8_t*)q;
  const auto* ss = (const float*)scales;
  auto* oo = (float*)out;
  return width == 4 ? launch_dequantize<4>(vecs, grid, threads, st, qq, ss,
                                           oo, rows, cols, group_log2)
                    : launch_dequantize<1>(vecs, grid, threads, st, qq, ss,
                                           oo, rows, cols, group_log2);
}
