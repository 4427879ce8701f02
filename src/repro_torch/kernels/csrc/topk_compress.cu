// Block-local top-k sparsification for Hopper (sm_90a): a radix select.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/topk_compress/topk_compress.py::topk_compress_pallas
//   (body _topk_kernel), whose off-TPU twin is
//   src/repro/kernels/topk_compress/ops.py::_topk_blocks_ref.
// A flat fp32 buffer is cut into blocks of `block` lanes (1024 on the main
// path); block b carries a (valid, k) pair from meta[b % blocks_per_row]
// (every client row of the server step shares one layout).  Lanes >= valid
// are padding.  The output keeps x where the lane is selected and writes 0
// elsewhere.
//
// Selection rule (the reference's).  With m_j = |x_j|, kth = the k-th
// largest valid magnitude counting entries (1 <= k <= valid), a lane i is
// kept iff i < valid and
//   m_i > kth, or m_i == kth and e_i <= quota = k - #{valid m > kth},
// where e_i >= 1 is lane i's 1-based index, in lane order, among the valid
// lanes with m == kth (the reference's eq_rank: the earlier lane wins).
// This is the same as rank_i < k with rank_i the lane's position in the
// stable descending order of the valid magnitudes (topk_blocks_plain):
//   * m_i > kth: such a lane precedes position k-1, so rank_i < k;
//   * m_i < kth: the k lanes at positions 0..k-1 all have m >= kth > m_i,
//     so rank_i >= k;
//   * m_i == kth: rank_i = #{m > kth} + e_i - 1 < k  <=>  e_i <= quota.
// NaN is outside this contract.  k >= valid keeps every valid lane (the
// reference's budget never exceeds valid); a block with valid = 0 or
// k <= 0 keeps nothing (the reference would return its lane 0, a zero
// padding lane wherever such blocks occur).
//
// Bound on this card: one memory-bound pass, 4 B read + 4 B written per
// lane plus 8 B of meta per block: 4.8 MB for one VGG-5 client row
// (580 blocks), about 1.4 us at 3.35 TB/s.  At this size launch latency
// and the CTAs' chains of barrier-separated steps set the time, not the
// bytes.
//
// Design: one CTA of ceil(block / 4) threads (rounded up to whole warps;
// 256 for a 1024-lane block) per block.  Each thread holds 4 consecutive
// lanes in registers (one float4 load and store when the block and the
// pointers are 16-byte aligned), so lane order is thread order.  The key
// of a lane is the bit pattern of its magnitude, __float_as_uint(x) &
// 0x7fffffff: non-negative floats, +inf included, order as unsigned
// integers.  kth is found MSB first in 4 passes of 8 bits: a 256-bin
// histogram in shared memory (shared atomics) of the digit over the valid
// lanes whose higher digits equal the prefix found so far; one warp finds
// the bin where the count from the top reaches the remaining k (each lane
// owns 8 bins; a suffix scan by shuffles over the lanes' sums), extends the
// prefix with it and subtracts the count above it.  After the last pass the
// prefix is kth and the remainder is the quota.  The tie rank is an
// exclusive prefix count, in lane order, of the lanes whose key equals kth:
// per thread over its 4 lanes, a warp scan by shuffles, and the warp totals
// scanned in shared memory.  O(block) work where the first version counted
// every lane's rank against every other lane, O(block^2).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 4;          // lanes per thread
constexpr int kMaxThreads = 256;   // 1024 / kLanes
constexpr int kBins = 256;         // 8-bit digits, 4 passes

__device__ __forceinline__ unsigned key_of(float x) {
  return __float_as_uint(x) & 0x7fffffffu;
}

template <bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
topk_radix_kernel(const float* __restrict__ x, const int* __restrict__ meta,
                  float* __restrict__ out, int block, int blocks_per_row) {
  __shared__ int hist2[2][kBins];   // alternate passes: no race with the scan
  __shared__ int warp_tot[kMaxThreads / 32];
  __shared__ unsigned s_prefix;
  __shared__ int s_rem;

  const long long base = (long long)blockIdx.x * block;
  const int* m = meta + 2 * (blockIdx.x % blocks_per_row);
  const int valid = min(m[0], block);
  const int k = m[1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int l0 = tid * kLanes;   // this thread's first lane

  float v[kLanes] = {0.f, 0.f, 0.f, 0.f};
  if (kVec) {
    if (l0 < block) {
      const float4 f = *reinterpret_cast<const float4*>(x + base + l0);
      v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kLanes; ++j)
      v[j] = l0 + j < block ? x[base + l0 + j] : 0.f;
  }

  bool keep[kLanes];
  if (valid <= 0 || k <= 0) {
#pragma unroll
    for (int j = 0; j < kLanes; ++j) keep[j] = false;
  } else if (k >= valid) {
#pragma unroll
    for (int j = 0; j < kLanes; ++j) keep[j] = l0 + j < valid;
  } else {
    unsigned key[kLanes];
    bool ok[kLanes];
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      key[j] = key_of(v[j]);
      ok[j] = l0 + j < valid;
    }
    if (tid == 0) {
      s_prefix = 0u;
      s_rem = k;
    }
    // kth, MSB first: digits at bits 24, 16, 8, 0
#pragma unroll 1
    for (int shift = 24; shift >= 0; shift -= 8) {
      // this pass's bins were last read by the scan two passes ago, which
      // ended before the last pass's first barrier
      int* hist = hist2[(shift >> 3) & 1];
      for (int i = tid; i < kBins; i += nthreads) hist[i] = 0;
      __syncthreads();   // bins cleared; s_prefix / s_rem of the last pass
      const unsigned prefix = s_prefix;
#pragma unroll
      for (int j = 0; j < kLanes; ++j) {
        // the digits above `shift` must equal the prefix (none at 24)
        const bool match =
            ok[j] && (shift == 24 || (key[j] >> (shift + 8)) == prefix);
        if (match) atomicAdd(&hist[(key[j] >> shift) & 0xffu], 1);
      }
      __syncthreads();
      if (warp == 0) {
        const int rem = s_rem;
        int c[8], sum = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          c[j] = hist[lane * 8 + j];
          sum += c[j];
        }
        // above = the count in the bins of the lanes above this one
        int incl = sum;   // inclusive suffix sum over lanes >= this one
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int o = __shfl_down_sync(0xffffffffu, incl, off);
          if (lane + off < 32) incl += o;
        }
        int above = incl - sum;
        if (above < rem && rem <= incl) {   // exactly one lane
#pragma unroll
          for (int j = 7; j >= 0; --j) {
            if (above + c[j] >= rem) {
              s_prefix = (prefix << 8) | (unsigned)(lane * 8 + j);
              s_rem = rem - above;
              break;
            }
            above += c[j];
          }
        }
      }
    }
    __syncthreads();
    const unsigned kth = s_prefix;
    const int quota = s_rem;
    // exclusive lane-order count of the lanes with key == kth
    bool eq[kLanes];
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      eq[j] = ok[j] && key[j] == kth;
      cnt += eq[j];
    }
    int incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    int rank = incl - cnt;
    for (int w = 0; w < warp; ++w) rank += warp_tot[w];
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      keep[j] = ok[j] && (key[j] > kth || (eq[j] && rank < quota));
      rank += eq[j];
    }
  }

  if (kVec) {
    if (l0 < block)
      *reinterpret_cast<float4*>(out + base + l0) =
          make_float4(keep[0] ? v[0] : 0.f, keep[1] ? v[1] : 0.f,
                      keep[2] ? v[2] : 0.f, keep[3] ? v[3] : 0.f);
  } else {
#pragma unroll
    for (int j = 0; j < kLanes; ++j)
      if (l0 + j < block) out[base + l0 + j] = keep[j] ? v[j] : 0.f;
  }
}

}  // namespace

extern "C" int repro_topk_blocks(const void* x, const void* meta, void* out,
                                 long long total_blocks, int blocks_per_row,
                                 int block, void* stream) {
  if (total_blocks <= 0) return 0;
  if (block <= 0 || block > 1024 || blocks_per_row <= 0)
    return (int)cudaErrorInvalidValue;
  const int threads = ((block + kLanes - 1) / kLanes + 31) / 32 * 32;
  const bool vec = block % kLanes == 0 &&
                   ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    topk_radix_kernel<true><<<(unsigned)total_blocks, threads, 0, s>>>(
        (const float*)x, (const int*)meta, (float*)out, block,
        blocks_per_row);
  else
    topk_radix_kernel<false><<<(unsigned)total_blocks, threads, 0, s>>>(
        (const float*)x, (const int*)meta, (float*)out, block,
        blocks_per_row);
  return (int)cudaGetLastError();
}
