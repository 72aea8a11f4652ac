// K1: per-row sort, duplicate sum and left compaction of ELL-ESC tiles.
//
// Replaces the Pallas kernel sparse_matrix_with_flops_tpu/ops/pallas_sort.py
// `sort_dedup_compact` (body `_sdc_kernel`).  Per row of an [R, W] tile:
// sort the lanes by column, sum each run of equal columns, drop columns
// >= ncols and move the survivors to the left, in column order.  Padding
// is (ncols, 0.0).  Whether a lane survives depends on its column only,
// never on its value, so exact-zero sums are kept (as the reference).
//
// What bounds it on the H100: the bitonic network makes log2(W)^2/2
// passes over the row, each a shared-memory read and write of every
// (col, val) pair, so shared-memory bandwidth and the barrier between
// passes bound it; device memory is read and written once per lane.
// Design: one CTA per row holds the whole row in dynamic shared memory
// (8 bytes a lane: W = 8192 needs 64 KB, W = 16384 needs 128 KB, above
// the 48 KB default, hence the attribute).  The caller's `presorted`
// promise (aligned runs of that many lanes sorted, alternating
// ascending/descending) lets the network start at k = 2 * presorted.
// The run sum is a walk back over the run by the thread that owns the
// run's last lane; the compaction is a block ballot scan.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

__global__ void sdc_kernel(const int* __restrict__ tc,
                           const float* __restrict__ tv,
                           int* __restrict__ kout, float* __restrict__ vout,
                           int W, int ncols, int kstart) {
  extern __shared__ int smem[];
  __shared__ int warp_cnt[32];
  int* key = smem;
  float* val = reinterpret_cast<float*>(smem + W);
  const long long row = blockIdx.x;
  const int* rc = tc + row * W;
  const float* rv = tv + row * W;
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    key[i] = rc[i];
    val[i] = rv[i];
  }
  __syncthreads();

  // bitonic network, ascending overall; block of k lanes ascends when
  // (i & k) == 0, which is also the invariant the presorted runs keep
  for (int k = kstart; k <= W; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < (W >> 1); t += blockDim.x) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int l = i + j;
        const bool asc = (i & k) == 0;
        const int ki = key[i];
        const int kl = key[l];
        if (asc ? (ki > kl) : (ki < kl)) {
          key[i] = kl;
          key[l] = ki;
          const float vi = val[i];
          val[i] = val[l];
          val[l] = vi;
        }
      }
      __syncthreads();
    }
  }

  int* ko = kout + row * W;
  float* vo = vout + row * W;
  int base = 0;
  for (int start = 0; start < W; start += blockDim.x) {
    const int i = start + threadIdx.x;
    bool keep = false;
    int c = 0;
    if (i < W) {
      c = key[i];
      keep = c < ncols && (i == W - 1 || key[i + 1] != c);
    }
    int total;
    const int pos = smf::block_ballot_scan(keep, warp_cnt, total);
    if (keep) {
      float s = val[i];
      for (int j = i - 1; j >= 0 && key[j] == c; --j) s += val[j];
      ko[base + pos] = c;
      vo[base + pos] = s;
    }
    base += total;
  }
  for (int i = base + threadIdx.x; i < W; i += blockDim.x) {
    ko[i] = ncols;
    vo[i] = 0.0f;
  }
}

}  // namespace

// W: a power of two, 8 * W bytes of shared memory at most the card's
// per-block limit (the Python wrapper checks both).  Returns the
// cudaError_t of the launch.
extern "C" int smf_sort_dedup_compact(const int* tc, const float* tv,
                                      int* kout, float* vout, int R, int W,
                                      int ncols, int presorted,
                                      cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(W) * 8;
  cudaError_t err = cudaFuncSetAttribute(
      sdc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = W / 2;
  if (threads < 32) threads = 32;
  if (threads > 1024) threads = 1024;
  const int kstart = presorted > 1 ? 2 * presorted : 2;
  sdc_kernel<<<R, threads, smem, stream>>>(tc, tv, kout, vout, W, ncols,
                                           kstart);
  return static_cast<int>(cudaGetLastError());
}
