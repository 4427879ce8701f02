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
// delta wire: (580, 1024)) that is 0.6-4 MB, about 0.2-1.2 us at 3.35 TB/s.
// At these sizes the launch latency (a few us) dominates; fusing quantize
// with dequantize, or with the rest of the server step, is later work.
//
// Design: quantize gives one warp to a row.  The warp's lanes stride over
// the row (coalesced 128 B loads), reduce the absmax with shuffles, then
// stride again to write codes; the second read hits L1/L2.  No shared
// memory, no block-level constraint on R (the Pallas wrapper padded R to
// 256-row blocks; here any R works).  dequantize is a grid-stride
// elementwise pass.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / kWarp;

__global__ void quantize_rows_kernel(const float* __restrict__ x,
                                     int8_t* __restrict__ q,
                                     float* __restrict__ scales,
                                     long long rows, int cols) {
  const int lane = threadIdx.x % kWarp;
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;  // whole warps leave together: shuffles stay safe
  const float* xr = x + row * cols;
  float absmax = 0.0f;
  for (int j = lane; j < cols; j += kWarp)
    absmax = fmaxf(absmax, fabsf(xr[j]));
  for (int off = kWarp / 2; off > 0; off >>= 1)
    absmax = fmaxf(absmax, __shfl_xor_sync(0xffffffffu, absmax, off));
  const float scale = fmaxf(absmax, 1e-12f) * (1.0f / 127.0f);
  int8_t* qr = q + row * cols;
  for (int j = lane; j < cols; j += kWarp) {
    const float v = fminf(fmaxf(rintf(xr[j] / scale), -127.0f), 127.0f);
    qr[j] = (int8_t)v;
  }
  if (lane == 0) scales[row] = scale;
}

__global__ void dequantize_rows_kernel(const int8_t* __restrict__ q,
                                       const float* __restrict__ scales,
                                       float* __restrict__ out, long long n,
                                       int cols) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = (float)q[i] * scales[i / cols];
}

}  // namespace

extern "C" int repro_quantize_rows(const void* x, void* q, void* scales,
                                   long long rows, int cols, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  const long long grid = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  quantize_rows_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (int8_t*)q, (float*)scales, rows, cols);
  return (int)cudaGetLastError();
}

extern "C" int repro_dequantize_rows(const void* q, const void* scales,
                                     void* out, long long rows, int cols,
                                     void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  const long long n = rows * cols;
  long long grid = (n + kThreads - 1) / kThreads;
  if (grid > 132LL * 32) grid = 132LL * 32;  // grid-stride beyond ~32 per SM
  dequantize_rows_kernel<<<(unsigned)grid, kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const int8_t*)q, (const float*)scales, (float*)out, n, cols);
  return (int)cudaGetLastError();
}
