// Block-local top-k sparsification for Hopper (sm_90a).
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
// Selection rule.  With m_j = |x_j|, lane i of a block is kept iff
//   i < valid  and  rank_i < k,   where
//   rank_i = #{j < valid : m_j > m_i} + #{j < min(i, valid) : m_j == m_i}.
// rank_i is lane i's position in the stable descending order of the valid
// magnitudes (ties: the earlier index first).  This is the reference's rule.
// Proof: the reference takes kth = the k-th largest valid magnitude,
// counting entries (1 <= k <= valid, so kth is a valid lane's magnitude and
// finite whenever x is), keeps every m > kth, and keeps lanes with m == kth
// by ascending index up to quota = k - #{m > kth}.
//   * m_i > kth: every such lane precedes position k-1 of the descending
//     order, so rank_i < k: kept by both.
//   * m_i < kth: the k lanes at positions 0..k-1 all have m >= kth > m_i,
//     so rank_i >= k: dropped by both.
//   * m_i == kth: rank_i = #{m > kth} + (e_i - 1), where e_i >= 1 is lane i's
//     1-based index among the valid lanes with m == kth (the reference's
//     eq_rank; masked lanes carry -inf there and never equal kth).  So
//     rank_i < k  <=>  e_i <= k - #{m > kth} = quota: the reference's test.
// NaN compares false both ways and is outside this contract.  A block with
// valid = 0 keeps nothing here; the reference would return its lane 0,
// which is a zero padding lane wherever such blocks occur.
//
// Bound on this card: one memory-bound pass, 4 B read + 4 B written per
// lane plus 8 B of meta per block: 4.8 MB for one VGG-5 client row
// (580 blocks), about 1.4 us at 3.35 TB/s.  At these sizes launch latency
// dominates the bound; the O(block^2) comparisons below do not reach it
// either.  A radix select over the magnitude bits, and fusing the whole
// per-client row of the server step (EF carry-in, top-k, int8, residual,
// weighted accumulate) into this kernel, are later work.
//
// Design: one CTA per block and one thread per lane.  The block's
// magnitudes are staged in shared memory; each thread counts its rank with
// a loop over the block in which every thread reads the same word
// (a broadcast, no bank conflicts).  No thread needs another's result, so
// there is one __syncthreads and no reduction.

#include <cuda_runtime.h>

namespace {

__global__ void topk_blocks_kernel(const float* __restrict__ x,
                                   const int* __restrict__ meta,
                                   float* __restrict__ out,
                                   int blocks_per_row) {
  extern __shared__ float mag[];
  const long long base = (long long)blockIdx.x * blockDim.x;
  const int* m = meta + 2 * (blockIdx.x % blocks_per_row);
  const int valid = m[0];
  const int k = m[1];
  const int i = threadIdx.x;
  const float xi = x[base + i];
  const float mi = fabsf(xi);
  mag[i] = mi;
  __syncthreads();
  bool keep = false;
  if (i < valid) {
    int rank = 0;
    for (int j = 0; j < valid; ++j) {
      const float mj = mag[j];
      rank += (mj > mi) | ((j < i) & (mj == mi));
    }
    keep = rank < k;
  }
  out[base + i] = keep ? xi : 0.0f;
}

}  // namespace

extern "C" int repro_topk_blocks(const void* x, const void* meta, void* out,
                                 long long total_blocks, int blocks_per_row,
                                 int block, void* stream) {
  if (total_blocks <= 0) return 0;
  if (block <= 0 || block > 1024 || blocks_per_row <= 0)
    return (int)cudaErrorInvalidValue;
  topk_blocks_kernel<<<(unsigned)total_blocks, block, block * sizeof(float),
                       (cudaStream_t)stream>>>(
      (const float*)x, (const int*)meta, (float*)out, blocks_per_row);
  return (int)cudaGetLastError();
}
