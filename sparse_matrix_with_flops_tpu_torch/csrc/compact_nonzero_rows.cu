// K2: dense rows -> (cols, vals) with the nonzero lanes compacted left.
//
// Replaces the Pallas kernel sparse_matrix_with_flops_tpu/ops/pallas_sort.py
// `compact_nonzero_rows` (body `_compact_rows_kernel`).  Per row of an
// [R, N] f32 array: lanes with a value != 0 and a lane index < ncols go to
// the front in lane (column) order; the rest is padding (ncols, 0.0).
// Exact zeros (-0.0 too) are dropped and NaN is kept, as `!= 0` does:
// this is the hub path, which cannot tell a cancelled product from an
// absent one.
//
// What bounds it on the H100: device-memory bandwidth, 12 bytes a lane
// (the row read once, two rows written once).  The TPU kernel compacted
// whole rows in VMEM with log-N shifts; here the work is cut so that the
// card fills and every byte moves in wide, coalesced accesses:
// 1. A row is split over a cluster of G <= 8 CTAs (G = N / 2048 rounded
//    up), each owning S lanes of the input and the same S positions of
//    the output, so R = 563 rows of 16384 lanes are 4504 CTAs of 2048
//    lanes instead of 563 CTAs of a whole row (2.13 waves).
// 2. A CTA reads its lanes with 16-byte loads, each warp instruction
//    covering 512 contiguous bytes, and counts its survivors.  Each CTA
//    writes its count into every CTA of the cluster (distributed shared
//    memory) before one cluster barrier; then each knows the survivors
//    before it in the row, and the row's total.
// 3. One block scan a 2048-lane piece: a thread's two vectors' counts
//    are packed into the halves of one word, scanned by warp shuffles,
//    and each warp scans the 8 warp totals itself (one barrier).
// 4. The piece's (col, val) pairs are staged in shared memory at their
//    compacted slot, shifted by the output's alignment, and written with
//    16-byte stores of both outputs; the output positions this CTA owns
//    past the row's total take the padding, so each output byte is
//    written once.
// Rows wider than 8 * 2048 lanes give a CTA several pieces: it counts
// them all first and reads them again to write.  When N is not a
// multiple of 4, or a pointer is off the 16-byte grid, the same steps run
// with 4-byte loads and stores.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 2;                         // 4-lane vectors a thread
constexpr int kPiece = kThreads * 4 * kVecs;     // 2048 lanes
constexpr int kMaxCluster = 8;
constexpr unsigned kFull = 0xffffffffu;

struct Shared {
  int4 col[kPiece / 4 + 1];  // a piece's survivors, 16-byte aligned,
  float4 val[kPiece / 4 + 1];  // plus up to 3 slots of alignment shift
  int warp_tot[kWarps];
  int cta_cnt[kMaxCluster];  // survivors of each CTA of the cluster
};

// The 4 lanes at ``e`` (lane index in the row; lanes >= hi read as 0).
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* v, int e, int hi) {
  if (VEC && e + 4 <= hi) return *reinterpret_cast<const float4*>(v + e);
  float4 x;
  x.x = e < hi ? v[e] : 0.0f;
  x.y = e + 1 < hi ? v[e + 1] : 0.0f;
  x.z = e + 2 < hi ? v[e + 2] : 0.0f;
  x.w = e + 3 < hi ? v[e + 3] : 0.0f;
  return x;
}

// Keep flags of the 4 lanes at ``e``, one bit a lane.
__device__ __forceinline__ unsigned keep4(float4 x, int e, int lim) {
  return (x.x != 0.0f && e < lim ? 1u : 0u) | (x.y != 0.0f && e + 1 < lim ? 2u : 0u) |
         (x.z != 0.0f && e + 2 < lim ? 4u : 0u) | (x.w != 0.0f && e + 3 < lim ? 8u : 0u);
}

__device__ __forceinline__ unsigned warp_incl(unsigned x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// Block-wide exclusive scan of ``x`` (every thread calls it); ``total``
// gets the block's sum.  One barrier; the caller separates two calls by
// another.
__device__ __forceinline__ unsigned block_excl(unsigned x, int* warp_tot,
                                               unsigned& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned incl = warp_incl(x, lane);
  if (lane == 31) warp_tot[warp] = static_cast<int>(incl);
  __syncthreads();
  const unsigned t = lane < kWarps ? static_cast<unsigned>(warp_tot[lane]) : 0u;
  const unsigned tincl = warp_incl(t, lane);
  total = __shfl_sync(kFull, tincl, kWarps - 1);
  const unsigned before = __shfl_sync(kFull, tincl - t, warp);
  return before + incl - x;
}

// Output positions [a, b) of a row: ``cols`` / ``vals`` at the start of
// the row, items from shared memory (slot s = position - a + sh) or the
// padding.  VEC: full aligned vectors as 16-byte stores, partial ones by
// lane.
template <bool VEC, bool PAD>
__device__ __forceinline__ void write_out(int* cols, float* vals, int a, int b,
                                          const Shared& sm, int sh, int ncols) {
  if (a >= b) return;
  if (!VEC) {
    for (int p = a + threadIdx.x; p < b; p += kThreads) {
      cols[p] = PAD ? ncols : reinterpret_cast<const int*>(sm.col)[p - a + sh];
      vals[p] = PAD ? 0.0f : reinterpret_cast<const float*>(sm.val)[p - a + sh];
    }
    return;
  }
  // vector i covers positions [v0 + 4i, v0 + 4i + 4), v0 = a rounded down
  const int v0 = a & ~3;
  const int nvec = (b - v0 + 3) >> 2;
  const int4 pc = make_int4(ncols, ncols, ncols, ncols);
  const float4 pv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const int p = v0 + 4 * i;
    // the staged slot of position p is p - a + sh = p - v0 when
    // sh = a & 3, so staged vector i lines up with output vector i
    const int4 c = PAD ? pc : sm.col[i];
    const float4 v = PAD ? pv : sm.val[i];
    if (p >= a && p + 4 <= b) {
      *reinterpret_cast<int4*>(cols + p) = c;
      *reinterpret_cast<float4*>(vals + p) = v;
    } else {
      const int cc[4] = {c.x, c.y, c.z, c.w};
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (p + k >= a && p + k < b) {
          cols[p + k] = cc[k];
          vals[p + k] = vv[k];
        }
      }
    }
  }
}

// One CTA: lanes [lo, hi) of row blockIdx.x / G, G = the cluster's size.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    compact_kernel(const float* __restrict__ vals, int* __restrict__ kout,
                   float* __restrict__ vout, int N, int S, int ncols) {
  __shared__ Shared sm;
  cg::cluster_group cluster = cg::this_cluster();
  const int G = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long long row = blockIdx.x / G;
  const float* v = vals + row * N;
  int* ko = kout + row * N;
  float* vo = vout + row * N;
  const int lo = rank * S < N ? rank * S : N;
  const int hi = lo + S < N ? lo + S : N;
  const int lim = hi < ncols ? hi : ncols;  // lanes >= lim are not kept
  const int pieces = (hi - lo + kPiece - 1) / kPiece;
  // thread t holds vectors t and t + 256 of a piece: lanes e(j) below
  auto lane_of = [&](int piece, int j) {
    return lo + piece * kPiece + (j * kThreads + static_cast<int>(threadIdx.x)) * 4;
  };

  // 1. count this CTA's survivors (the registers keep a single piece)
  float4 x[kVecs];
  unsigned mine = 0;
  for (int pc = 0; pc < pieces; ++pc) {
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int e = lane_of(pc, j);
      x[j] = load4<VEC>(v, e, hi);
      mine += __popc(keep4(x[j], e, lim));
    }
  }
  unsigned cta_total;
  block_excl(mine, sm.warp_tot, cta_total);
  // 2. every CTA of the cluster gets this count; one cluster barrier
  if (threadIdx.x < G) {
    int* dst = cluster.map_shared_rank(sm.cta_cnt, static_cast<int>(threadIdx.x));
    dst[rank] = static_cast<int>(cta_total);
  }
  cluster.sync();
  int base = 0, total = 0;
  for (int k = 0; k < G; ++k) {
    const int c = sm.cta_cnt[k];
    base += k < rank ? c : 0;
    total += c;
  }
  // 3-4. each piece: scan, stage, write
  for (int pc = 0; pc < pieces; ++pc) {
    unsigned f[kVecs];
    unsigned packed = 0;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int e = lane_of(pc, j);
      if (pieces > 1) x[j] = load4<VEC>(v, e, hi);
      f[j] = keep4(x[j], e, lim);
      packed |= static_cast<unsigned>(__popc(f[j])) << (16 * j);
    }
    unsigned ptotal;
    const unsigned excl = block_excl(packed, sm.warp_tot, ptotal);
    const int sh = VEC ? (base & 3) : 0;
    int slot[kVecs] = {static_cast<int>(excl & 0xffffu),
                       static_cast<int>((ptotal & 0xffffu) + (excl >> 16))};
    int* scol = reinterpret_cast<int*>(sm.col);
    float* sval = reinterpret_cast<float*>(sm.val);
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int e = lane_of(pc, j);
      const float xs[4] = {x[j].x, x[j].y, x[j].z, x[j].w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (f[j] >> k & 1u) {
          scol[sh + slot[j]] = e + k;
          sval[sh + slot[j]] = xs[k];
          ++slot[j];
        }
      }
    }
    __syncthreads();
    const int n = static_cast<int>((ptotal & 0xffffu) + (ptotal >> 16));
    write_out<VEC, false>(ko, vo, base, base + n, sm, sh, ncols);
    base += n;
    __syncthreads();  // the staging area and warp totals are reused
  }
  // the padding at the output positions this CTA owns
  write_out<VEC, true>(ko, vo, lo > total ? lo : total, hi, sm, 0, ncols);
}

}  // namespace

// vals, kout, vout: [R, N] row-major.  Returns the cudaError_t of the
// launch.
extern "C" int smf_compact_nonzero_rows(const float* vals, int* kout,
                                        float* vout, int R, int N, int ncols,
                                        cudaStream_t stream) {
  if (R < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  int G = (N + kPiece - 1) / kPiece;
  G = G < kMaxCluster ? G : kMaxCluster;
  const long long grid = static_cast<long long>(R) * G;
  if (grid >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int S = ((N + G - 1) / G + 3) & ~3;
  const bool vec =
      N % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(vals) | reinterpret_cast<uintptr_t>(kout) |
        reinterpret_cast<uintptr_t>(vout)) & 15) == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      vec ? cudaLaunchKernelEx(&cfg, compact_kernel<true>, vals, kout, vout, N, S, ncols)
          : cudaLaunchKernelEx(&cfg, compact_kernel<false>, vals, kout, vout, N, S, ncols);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
