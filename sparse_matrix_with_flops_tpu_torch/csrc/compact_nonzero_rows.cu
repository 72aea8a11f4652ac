// K2: dense rows -> (cols, vals) with the nonzero lanes compacted left.
//
// Replaces the Pallas kernel sparse_matrix_with_flops_tpu/ops/pallas_sort.py
// `compact_nonzero_rows` (body `_compact_rows_kernel`).  Per row of an
// [R, N] f32 array: lanes with a value != 0 and a lane index < ncols go to
// the front in lane (column) order; the rest is padding (ncols, 0.0).
// Exact zeros are dropped: this is the hub path, which cannot tell a
// cancelled product from an absent one.
//
// What bounds it on the H100: device-memory bandwidth (one read of the
// row, one write of two rows), with one block barrier per 1024 lanes.
// Design: one CTA per row walks the row in blockDim-wide pieces; a warp
// ballot with a popc prefix places each lane inside its warp, the warp
// counts give the warp's offset, and a running offset carries across
// pieces, so survivors are written straight to their final slot.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

__global__ void compact_rows_kernel(const float* __restrict__ vals,
                                    int* __restrict__ kout,
                                    float* __restrict__ vout, int N,
                                    int ncols) {
  __shared__ int warp_cnt[32];
  const long long row = blockIdx.x;
  const float* v = vals + row * N;
  int* ko = kout + row * N;
  float* vo = vout + row * N;
  int base = 0;
  for (int start = 0; start < N; start += blockDim.x) {
    const int i = start + threadIdx.x;
    float x = 0.0f;
    bool keep = false;
    if (i < N) {
      x = v[i];
      keep = x != 0.0f && i < ncols;
    }
    int total;
    const int pos = smf::block_ballot_scan(keep, warp_cnt, total);
    if (keep) {
      ko[base + pos] = i;
      vo[base + pos] = x;
    }
    base += total;
  }
  for (int i = base + threadIdx.x; i < N; i += blockDim.x) {
    ko[i] = ncols;
    vo[i] = 0.0f;
  }
}

}  // namespace

extern "C" int smf_compact_nonzero_rows(const float* vals, int* kout,
                                        float* vout, int R, int N, int ncols,
                                        cudaStream_t stream) {
  int threads = 1024;
  while (threads > 32 && threads / 2 >= N) threads /= 2;
  compact_rows_kernel<<<R, threads, 0, stream>>>(vals, kout, vout, N, ncols);
  return static_cast<int>(cudaGetLastError());
}
