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
//
// W = 32768 (256 KB a row) does not fit one CTA's 227 KB, so that width
// runs on a cluster of two CTAs (sdc_pair_kernel), each holding one
// 16384-lane half in its shared memory.  Every bitonic stage but one
// has its partner lane in the same half; the one stage whose partner
// distance is 16384 exchanges through distributed shared memory, with
// a cluster barrier before and after it.  The run walk-back and the
// survivor count of the first half are read across the pair the same
// way.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kOneCtaMaxW = 16384;  // 128 KB of (col, val) pairs

__device__ __forceinline__ void swap_pair(int* ka, float* va, int* kb,
                                          float* vb) {
  const int k = *ka;
  *ka = *kb;
  *kb = k;
  const float v = *va;
  *va = *vb;
  *vb = v;
}

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

// One row of W lanes over a cluster of two CTAs; CTA r holds global
// lanes [r * H, (r + 1) * H), H = W / 2, and writes the output slots of
// the same range.
__global__ void __cluster_dims__(2, 1, 1)
    sdc_pair_kernel(const int* __restrict__ tc, const float* __restrict__ tv,
                    int* __restrict__ kout, float* __restrict__ vout, int W,
                    int ncols, int kstart) {
  extern __shared__ int smem[];
  __shared__ int warp_cnt[32];
  __shared__ int half_cnt;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int H = W >> 1;
  const int g0 = rank * H;  // first global lane of this half
  int* key = smem;
  float* val = reinterpret_cast<float*>(smem + H);
  int* pkey = cluster.map_shared_rank(key, rank ^ 1);
  float* pval = cluster.map_shared_rank(val, rank ^ 1);
  const long long row = blockIdx.x >> 1;
  const int* rc = tc + row * W + g0;
  const float* rv = tv + row * W + g0;
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    key[i] = rc[i];
    val[i] = rv[i];
  }
  __syncthreads();

  for (int k = kstart; k <= W; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j == H) {
        // k == W: every pair (l, H + l) ascends; the low lane is in
        // CTA 0.  Each CTA takes half of the H pairs.
        cluster.sync();
        int* klo = rank == 0 ? key : pkey;
        int* khi = rank == 0 ? pkey : key;
        float* vlo = rank == 0 ? val : pval;
        float* vhi = rank == 0 ? pval : val;
        for (int t = threadIdx.x; t < (H >> 1); t += blockDim.x) {
          const int l = rank * (H >> 1) + t;
          if (klo[l] > khi[l]) swap_pair(klo + l, vlo + l, khi + l, vhi + l);
        }
        cluster.sync();
        continue;
      }
      for (int t = threadIdx.x; t < (H >> 1); t += blockDim.x) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int l = i + j;
        const bool asc = ((g0 + i) & k) == 0;
        const int ki = key[i];
        const int kl = key[l];
        if (asc ? (ki > kl) : (ki < kl)) {
          swap_pair(key + i, val + i, key + l, val + l);
        }
      }
      __syncthreads();
    }
  }
  cluster.sync();  // both sorted halves visible to both CTAs

  // a lane survives if it is the last of its run and a real column; the
  // lane after this half's last is the other half's first
  auto keeps = [&](int i, int& c) {
    c = key[i];
    if (c >= ncols) return false;
    if (g0 + i == W - 1) return true;
    return (i + 1 < H ? key[i + 1] : pkey[0]) != c;
  };
  int cnt = 0;
  for (int start = 0; start < H; start += blockDim.x) {
    const int i = start + threadIdx.x;
    int c;
    cnt += __syncthreads_count(i < H && keeps(i, c));
  }
  if (threadIdx.x == 0) half_cnt = cnt;
  cluster.sync();
  const int other = *cluster.map_shared_rank(&half_cnt, rank ^ 1);
  const int total = cnt + other;
  int base = rank == 0 ? 0 : other;

  int* ko = kout + row * W;
  float* vo = vout + row * W;
  for (int start = 0; start < H; start += blockDim.x) {
    const int i = start + threadIdx.x;
    int c = 0;
    const bool keep = i < H && keeps(i, c);
    int blk_total;
    const int pos = smf::block_ballot_scan(keep, warp_cnt, blk_total);
    if (keep) {
      // walk back over the run; lanes below g0 lie in CTA 0
      float s = val[i];
      for (int g = g0 + i - 1; g >= 0; --g) {
        const bool mine = g >= g0;
        if ((mine ? key[g - g0] : pkey[g]) != c) break;
        s += mine ? val[g - g0] : pval[g];
      }
      ko[base + pos] = c;
      vo[base + pos] = s;
    }
    base += blk_total;
  }
  const int pad0 = total > g0 ? total : g0;
  for (int g = pad0 + threadIdx.x; g < g0 + H; g += blockDim.x) {
    ko[g] = ncols;
    vo[g] = 0.0f;
  }
  cluster.sync();  // keep this CTA's shared memory alive for the peer
}

}  // namespace

// W: a power of two up to 32768 (the Python wrapper checks).  Rows up to
// 16384 lanes run one CTA each; 32768-lane rows run a 2-CTA cluster.
// Returns the cudaError_t of the launch.
extern "C" int smf_sort_dedup_compact(const int* tc, const float* tv,
                                      int* kout, float* vout, int R, int W,
                                      int ncols, int presorted,
                                      cudaStream_t stream) {
  const int kstart = presorted > 1 ? 2 * presorted : 2;
  if (W > 2 * kOneCtaMaxW) return static_cast<int>(cudaErrorInvalidValue);
  if (W > kOneCtaMaxW) {
    const size_t smem = static_cast<size_t>(W / 2) * 8;
    cudaError_t err = cudaFuncSetAttribute(
        sdc_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    sdc_pair_kernel<<<2 * R, 1024, smem, stream>>>(tc, tv, kout, vout, W,
                                                   ncols, kstart);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = static_cast<size_t>(W) * 8;
  cudaError_t err = cudaFuncSetAttribute(
      sdc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = W / 2;
  if (threads < 32) threads = 32;
  if (threads > 1024) threads = 1024;
  sdc_kernel<<<R, threads, smem, stream>>>(tc, tv, kout, vout, W, ncols,
                                           kstart);
  return static_cast<int>(cudaGetLastError());
}
