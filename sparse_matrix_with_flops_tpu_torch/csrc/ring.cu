// K6-K8: the ring exchanges of the sharded R-MCL loop, with the D ranks
// of the ring stacked on one card.
//
// Replace the Pallas kernels of sparse_matrix_with_flops_tpu/parallel/
// pallas_ring.py:
//   K6 smf_ring_all_gather   <- `ring_all_gather`   (body `_ring_ag_kernel`)
//   K7 smf_ring_matmul       <- `ring_matmul`       (body `_ring_mm_kernel`)
//   K8 smf_ring_matmul_tiled <- `ring_matmul_tiled` (body
//                               `_ring_mm_tiled_kernel`)
//
// There each chip ran one program and forwarded blocks to its neighbour
// with remote DMAs, one semaphore pair per region.  Here one cooperative
// launch runs all D ranks: blockIdx.y is the rank, gridDim.x CTAs work on
// one rank's region, and every rank's buffers are reached only through
// its own base pointer (a device array of D pointers per operand), as a
// peer pointer on another card would be.  The protocol is the reference's
// write-once, one-flag-per-region ring: at hop k each CTA copies its
// slice of block k into the neighbour's block k + 1, then one thread
// fences and adds 1 to the neighbour's flag for that block; the
// neighbour's CTAs read the block after the flag reaches gridDim.x.
// Fences and atomics are system-scope and blocks written in this launch
// are read with __ldcg (L2, not the incoherent L1), so the same code is
// right when the pointers are peer pointers on other cards.  Ranks spin
// on each other's flags, so every CTA of the grid must be resident at
// once: the launch is cooperative, and a grid larger than what fits is
// refused by cudaLaunchCooperativeKernel (the wrapper raises) instead of
// deadlocking.  The caller zeroes the flags before every launch.
//
// K7 and K8 contract the resident block in their own bodies, C[me] +=
// A_rot[me][:, block k] . block k, with true f32 FFMA (no TF32, no
// library product): each CTA owns 64 x 128 output tiles, 4 x 8 register
// accumulators a thread, 16-deep k steps staged in shared memory.  The
// output tile lives in C between hops (each tile has one owner CTA, so no
// atomics, and the sum order is fixed: block 0, 1, ..., d - 1).  K7's
// blocks flow right (block k is owner (me - k) mod d), K8's left (owner
// (me + k) mod d), so K8's sums follow the unfused ring chain's owner
// order.  K8 runs over N tiles of nt columns and reuses its rotating
// buffer across tiles, so a rank that enters tile t first signals both
// neighbours and waits for both: a neighbour that has entered tile t has
// finished reading tile t - 1, so overwriting its buffer is safe (the
// reference's entry barrier, pallas_ring.py:196-223).  Block 0 is read
// from the rank's own B in place and never copied, so a rank never
// writes its own rotating buffer.
//
// What bounds them on the H100.  K6 moves d - 1 blocks a rank in d - 1
// serial hops (at D = 4 on R-MAT s14, [4096, 128] 4-byte blocks: 64 MB
// in all): each hop is a copy of a few MB plus a flag round trip, so it
// is latency-bound by the serial chain.  K8 at D = 4 on s14 contracts
// [297, 4 x 4096] x [4096, 16384] a rank, 638 GFLOP an iteration over
// the four ranks, most of it the planner's zero padding: FFMA-bound.
// This first version does each hop's copy and then the contraction, one
// after the other; overlapping them (a producer warp with cp.async/TMA)
// and wgmma on 3xTF32 splits are later work.
#include <cuda/atomic>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;   // output rows per tile
constexpr int kBN = 128;  // output columns per tile
constexpr int kBK = 16;   // contraction depth per shared-memory stage

using Flag = cuda::atomic_ref<int, cuda::thread_scope_system>;

// Every thread of the CTA calls it after its stores into a region; one
// thread publishes them and adds 1 to ``flag``.
__device__ __forceinline__ void signal(int* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    Flag(*flag).fetch_add(1, cuda::std::memory_order_release);
  }
}

// Every thread of the CTA calls it; returns once ``flag`` >= target.
__device__ __forceinline__ void wait_for(int* flag, int target) {
  if (threadIdx.x == 0) {
    Flag f(*flag);
    while (f.load(cuda::std::memory_order_acquire) < target) __nanosleep(64);
    __threadfence_system();
  }
  __syncthreads();
}

template <typename V>
__device__ __forceinline__ V load(const V* p, bool fresh) {
  return fresh ? __ldcg(p) : *p;
}

// This CTA's share of a rows x cols copy (row strides lds / ldd, in V
// units) in a grid-stride loop over the rank's gridDim.x CTAs.  ``fresh``:
// the source was written in this launch, read it from L2.
template <typename V>
__device__ void copy_2d(const V* src, long long lds, V* dst, long long ldd,
                        long long rows, long long cols, bool fresh) {
  const long long total = rows * cols;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < total; e += step) {
    const long long r = e / cols;
    const long long c = e - r * cols;
    dst[r * ldd + c] = load(src + r * lds + c, fresh);
  }
}

// copy_2d on 4-byte words, as uint4 when every row start is 16-byte
// aligned; the choice is uniform across the grid.
__device__ void copy_words(const float* src, long long lds, float* dst,
                           long long ldd, long long rows, long long cols,
                           bool fresh) {
  const bool vec = ((reinterpret_cast<uintptr_t>(src) |
                     reinterpret_cast<uintptr_t>(dst)) & 15) == 0 &&
                   (lds & 3) == 0 && (ldd & 3) == 0 && (cols & 3) == 0;
  if (vec) {
    copy_2d(reinterpret_cast<const uint4*>(src), lds / 4,
            reinterpret_cast<uint4*>(dst), ldd / 4, rows, cols / 4, fresh);
  } else {
    copy_2d(reinterpret_cast<const unsigned*>(src), lds,
            reinterpret_cast<unsigned*>(dst), ldd, rows, cols, fresh);
  }
}

// ---- K6 ---------------------------------------------------------------
// in[r]: rank r's block of ``words`` 4-byte words; out[r]: d blocks, block
// k = rank (r - k) mod d's.  flags: [d, d], flags[r][k] counts the CTAs
// that have delivered their slice of rank r's block k.
__global__ void __launch_bounds__(kThreads)
    ring_all_gather_kernel(const float* const* in, float* const* out,
                           int* flags, int d, long long words) {
  const int me = blockIdx.y;
  const int dst = (me + 1) % d;
  float* mine = out[me];
  copy_words(in[me], words, mine, words, 1, words, false);  // block 0
  for (int k = 0; k + 1 < d; ++k) {
    // hop 0 forwards from the input itself, so it waits for nothing
    if (k > 0) wait_for(&flags[me * d + k], gridDim.x);
    const float* src = k == 0 ? in[me] : mine + k * words;
    copy_words(src, words, out[dst] + (k + 1) * words, words, 1, words,
               k > 0);
    signal(&flags[dst * d + k + 1]);
  }
}

// ---- K7 / K8 ----------------------------------------------------------
struct RingMatmul {
  const float* const* a;  // [d] -> A_rot [M, d * lr], block k at cols k*lr
  const float* const* b;  // [d] -> B [lr, N]
  float* const* buf;      // [d] -> rotating buffer [d - 1, lr, nt]
  float* const* c;        // [d] -> C [M, N]
  int* flags;             // [d, T, d] arrivals, then [d, T] entry barrier
  int d, m, lr, n, nt;
  int dir;  // +1: blocks flow to rank me + 1 (K7); -1: to me - 1 (K8)
};

// C[0:m, 0:ncols] (+)= A[0:m, 0:kdim] . B[0:kdim, 0:ncols] for the tiles
// this CTA owns (tile i belongs to CTA i mod gridDim.x, for every hop).
__device__ void contract(const float* a, long long lda, const float* b,
                         long long ldb, bool fresh, float* c, long long ldc,
                         int m, int kdim, int ncols, bool first) {
  __shared__ __align__(16) float as[kBK][kBM];
  __shared__ __align__(16) float bs[kBK][kBN];
  const int tiles_n = (ncols + kBN - 1) / kBN;
  const int tiles = ((m + kBM - 1) / kBM) * tiles_n;
  const int tx = threadIdx.x % 16;  // 8 output columns each
  const int ty = threadIdx.x / 16;  // 4 output rows each
  const int ar = threadIdx.x / 4, ak = (threadIdx.x % 4) * 4;
  const int br = threadIdx.x / 16, bcol = (threadIdx.x % 16) * 8;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / tiles_n) * kBM;
    const int n0 = (tile % tiles_n) * kBN;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + tx * 8 + j;
        acc[i][j] = (!first && row < m && col < ncols)
                        ? c[static_cast<long long>(row) * ldc + col]
                        : 0.0f;
      }
    }
    for (int k0 = 0; k0 < kdim; k0 += kBK) {
      {
        const int row = m0 + ar;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int kk = k0 + ak + q;
          as[ak + q][ar] = (row < m && kk < kdim)
                               ? a[static_cast<long long>(row) * lda + kk]
                               : 0.0f;
        }
      }
      {
        const int kk = k0 + br;
        const float* brow = b + static_cast<long long>(kk) * ldb;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int col = n0 + bcol + q;
          bs[br][bcol + q] =
              (kk < kdim && col < ncols) ? load(brow + col, fresh) : 0.0f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 av = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * 8]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&bs[kk][tx * 8 + 4]);
        const float ra[4] = {av.x, av.y, av.z, av.w};
        const float rb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + tx * 8 + j;
        if (row < m && col < ncols)
          c[static_cast<long long>(row) * ldc + col] = acc[i][j];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) ring_matmul_kernel(RingMatmul p) {
  const int d = p.d;
  const int me = blockIdx.y;
  const int dst = ((me + p.dir) % d + d) % d;
  const int tiles = p.n / p.nt;
  int* arrive = p.flags;
  int* entry = p.flags + static_cast<long long>(d) * tiles * d;
  const long long lda = static_cast<long long>(d) * p.lr;
  const long long blk = static_cast<long long>(p.lr) * p.nt;
  for (int t = 0; t < tiles; ++t) {
    if (t > 0 && d > 1) {
      __syncthreads();
      if (threadIdx.x == 0) {
        __threadfence_system();
        Flag(entry[((me + 1) % d) * tiles + t])
            .fetch_add(1, cuda::std::memory_order_release);
        Flag(entry[((me + d - 1) % d) * tiles + t])
            .fetch_add(1, cuda::std::memory_order_release);
      }
      wait_for(&entry[me * tiles + t], 2 * gridDim.x);
    }
    const long long col0 = static_cast<long long>(t) * p.nt;
    for (int k = 0; k < d; ++k) {
      const float* src;
      long long lds;
      if (k == 0) {
        src = p.b[me] + col0;
        lds = p.n;
      } else {
        wait_for(&arrive[(me * tiles + t) * d + k], gridDim.x);
        src = p.buf[me] + (k - 1) * blk;
        lds = p.nt;
      }
      if (k + 1 < d) {
        copy_words(src, lds, p.buf[dst] + k * blk, p.nt, p.lr, p.nt, k > 0);
        signal(&arrive[(dst * tiles + t) * d + k + 1]);
      }
      contract(p.a[me] + static_cast<long long>(k) * p.lr, lda, src, lds,
               k > 0, p.c[me] + col0, p.n, p.m, p.lr, p.nt, k == 0);
    }
  }
}

// CTAs per rank: as many as are resident at once over the d ranks, at
// most ``useful``; cudaErrorCooperativeLaunchTooLarge when not even one
// CTA a rank fits.
int grid_x(const void* kernel, int d, long long useful, int& gx) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long fit = static_cast<long long>(per_sm) * sms / d;
  if (fit > useful) fit = useful;
  if (fit < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  gx = static_cast<int>(fit);
  return 0;
}

int launch_matmul(RingMatmul p, cudaStream_t stream) {
  const void* kernel = reinterpret_cast<const void*>(ring_matmul_kernel);
  const long long tiles = static_cast<long long>((p.m + kBM - 1) / kBM) *
                          ((p.nt + kBN - 1) / kBN);
  const long long copy = (static_cast<long long>(p.lr) * p.nt + kThreads - 1) /
                         kThreads;
  int gx = 0;
  const int err = grid_x(kernel, p.d, tiles > copy ? tiles : copy, gx);
  if (err != 0) return err;
  void* args[] = {&p};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      kernel, dim3(gx, p.d), dim3(kThreads), args, 0, stream));
}

}  // namespace

// in, out: device arrays of d pointers to each rank's input block (words
// 4-byte words) and its [d, words] output; flags: zeroed int32[d * d].
// d >= 1, words >= 1.  Returns the cudaError_t of the launch.
extern "C" int smf_ring_all_gather(const float* const* in, float* const* out,
                                   int* flags, int d, long long words,
                                   cudaStream_t stream) {
  const void* kernel = reinterpret_cast<const void*>(ring_all_gather_kernel);
  int gx = 0;
  const int err = grid_x(kernel, d, (words + kThreads - 1) / kThreads, gx);
  if (err != 0) return err;
  void* args[] = {&in, &out, &flags, &d, &words};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      kernel, dim3(gx, d), dim3(kThreads), args, 0, stream));
}

// a, b, buf, c: device arrays of d pointers (A_rot [m, d * lr] with block
// k = owner (me - k) mod d, B [lr, n], a [(d - 1) * lr * n] scratch
// buffer, C [m, n]); flags: zeroed int32[d * d + d].  K7: one N tile,
// blocks flow right.
extern "C" int smf_ring_matmul(const float* const* a, const float* const* b,
                               float* const* buf, float* const* c,
                               int* flags, int d, int m, int lr, int n,
                               cudaStream_t stream) {
  return launch_matmul(RingMatmul{a, b, buf, c, flags, d, m, lr, n, n, 1},
                       stream);
}

// As smf_ring_matmul over n / nt column tiles (n % nt == 0), blocks
// flowing left (A_rot block k = owner (me + k) mod d); buf: [(d - 1) *
// lr * nt] a rank; flags: zeroed int32[d * (n / nt) * (d + 1)].  K8.
extern "C" int smf_ring_matmul_tiled(const float* const* a,
                                     const float* const* b, float* const* buf,
                                     float* const* c, int* flags, int d, int m,
                                     int lr, int n, int nt,
                                     cudaStream_t stream) {
  if (nt <= 0 || n % nt != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_matmul(RingMatmul{a, b, buf, c, flags, d, m, lr, n, nt, -1},
                       stream);
}
