// Shared device helpers for the port's kernels.
#pragma once

#include <cuda_runtime.h>

namespace smf {

// Block-wide exclusive scan of keep flags by warp ballot + popc.
// Every thread of the block must call it (blockDim.x a multiple of 32,
// at most 1024).  ``warp_cnt`` is a __shared__ int[32].  Returns the
// number of keeping threads before this one; ``total`` gets the block
// count.  Ends with a barrier, so ``warp_cnt`` may be reused at once.
__device__ __forceinline__ int block_ballot_scan(bool keep, int* warp_cnt,
                                                 int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned m = __ballot_sync(0xffffffffu, keep);
  const int in_warp = __popc(m & ((1u << lane) - 1u));
  if (lane == 0) warp_cnt[warp] = __popc(m);
  __syncthreads();
  int before = 0;
  int all = 0;
  for (int w = 0; w < nwarps; ++w) {
    const int c = warp_cnt[w];
    before += (w < warp) ? c : 0;
    all += c;
  }
  __syncthreads();
  total = all;
  return before + in_warp;
}

// Block-wide exclusive scan of one unsigned value per thread (wrapping
// arithmetic).  Same calling rules as block_ballot_scan; ``warp_tot`` is
// a __shared__ unsigned[32].
__device__ __forceinline__ unsigned block_exclusive_scan(unsigned x,
                                                         unsigned* warp_tot,
                                                         unsigned& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  unsigned incl = x;
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  unsigned before = 0;
  unsigned all = 0;
  for (int w = 0; w < nwarps; ++w) {
    const unsigned c = warp_tot[w];
    before += (w < warp) ? c : 0u;
    all += c;
  }
  __syncthreads();
  total = all;
  return before + incl - x;
}

}  // namespace smf
