// K4: inclusive int32 prefix sum of a long 1-D array.
//
// Replaces the Pallas kernel sparse_matrix_with_flops_tpu/ops/pallas_scan.py
// `cumsum_i32` (body `_scan_kernel`).  Sums wrap around as int32 sums do
// (the arithmetic is unsigned, where wrapping is defined).
//
// What bounds it on the H100: device-memory bandwidth.  The TPU kernel
// carried the running total from one sequential grid step to the next;
// CUDA blocks run in no order, so this is a three-launch reduce-then-scan:
// (1) each block sums its tile, (2) one block scans the tile sums into
// tile offsets, (3) each block scans its tile in shared memory and adds
// its offset.  It reads the input twice and writes it once; a single-pass
// decoupled look-back scan would read it once.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;

__global__ void tile_sums_kernel(const unsigned* __restrict__ x,
                                 unsigned* __restrict__ sums, long long n) {
  __shared__ unsigned warp_tot[32];
  const long long base = blockIdx.x * static_cast<long long>(kTile);
  unsigned s = 0;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const long long k = base + i;
    if (k < n) s += x[k];
  }
  unsigned total;
  smf::block_exclusive_scan(s, warp_tot, total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// in place: sums[b] <- sum of sums[0..b)
__global__ void scan_sums_kernel(unsigned* sums, int nblocks) {
  __shared__ unsigned warp_tot[32];
  unsigned carry = 0;
  for (int start = 0; start < nblocks; start += kThreads) {
    const int i = start + threadIdx.x;
    const unsigned v = i < nblocks ? sums[i] : 0u;
    unsigned total;
    const unsigned ex = smf::block_exclusive_scan(v, warp_tot, total);
    if (i < nblocks) sums[i] = carry + ex;
    carry += total;
  }
}

__global__ void scan_tiles_kernel(const unsigned* __restrict__ x,
                                  unsigned* __restrict__ out,
                                  const unsigned* __restrict__ offs,
                                  long long n) {
  __shared__ unsigned tile[kTile];
  __shared__ unsigned warp_tot[32];
  const long long base = blockIdx.x * static_cast<long long>(kTile);
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const long long k = base + i;
    tile[i] = k < n ? x[k] : 0u;
  }
  __syncthreads();
  unsigned local[kItems];
  unsigned run = 0;
  for (int j = 0; j < kItems; ++j) {
    run += tile[threadIdx.x * kItems + j];
    local[j] = run;
  }
  unsigned total;
  const unsigned before =
      offs[blockIdx.x] + smf::block_exclusive_scan(run, warp_tot, total);
  for (int j = 0; j < kItems; ++j) tile[threadIdx.x * kItems + j] = before + local[j];
  __syncthreads();
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const long long k = base + i;
    if (k < n) out[k] = tile[i];
  }
}

}  // namespace

// scratch: room for ceil(n / 8192) unsigned tile sums.  n >= 1.
extern "C" int smf_cumsum_i32(const int* x, int* out, int* scratch,
                              long long n, cudaStream_t stream) {
  const long long nblocks = (n + kTile - 1) / kTile;
  const unsigned* ux = reinterpret_cast<const unsigned*>(x);
  unsigned* sums = reinterpret_cast<unsigned*>(scratch);
  tile_sums_kernel<<<static_cast<unsigned>(nblocks), kThreads, 0, stream>>>(
      ux, sums, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_sums_kernel<<<1, kThreads, 0, stream>>>(sums,
                                               static_cast<int>(nblocks));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_tiles_kernel<<<static_cast<unsigned>(nblocks), kThreads, 0, stream>>>(
      ux, reinterpret_cast<unsigned*>(out), sums, n);
  return static_cast<int>(cudaGetLastError());
}
