// K5: blocked SpMM C = A · B, A in BCSR (dense br x bc blocks), B dense.
//
// Replaces the Pallas kernel sparse_matrix_with_flops_tpu/ops/spmm.py
// `_bcsr_spmm_pallas` (body `_bcsr_kernel`).  There the grid ran
// (block row, N tile, k-th block of the row) in order on one core, every
// row padded to the longest row's block count, and the output tile was
// carried in VMEM across the k axis.  Here CTAs run in no order, so one
// CTA owns one (block row, 128-column tile) of C and loops over its own
// block row's blocks only, brp[i] .. brp[i + 1]: a row with no block
// costs nothing but the zero store, and a hub row of 123 blocks runs
// 123 steps.
//
// Per CTA: each of the 128 threads owns one output column and RB
// accumulators (the block's rows, RB rows a pass).  A block's rows are
// staged in shared memory up to 128 columns at a time; for each column
// kk a thread reads B[bcol * bc + kk, j], a coalesced row read across
// the CTA, and does RB FFMAs against the broadcast A column.  True f32
// FFMA: no TF32 tensor-core path (the reference's `jnp.dot` rounds to
// bf16 on a TPU, full f32 on the CPU it is held against).
//
// What bounds it on the H100: the B reads.  Each stored block reads a
// bc x 128 tile of B (64 KB at bc = 128) for br * bc * 128 FFMAs, br / 2
// FLOP a byte before L2 reuse (4 at br = 8); neighbouring block rows of
// a band share their B rows through the 50 MB L2.  The hub rows' serial block loop
// bounds the power-law case.  Making it fast (wgmma on 3xTF32 splits,
// TMA-fed B tiles, a split of the hub rows) is later work.
//
// Padding is done by bounds checks, not copies: B rows >= cols are
// skipped (the reference pads them with zeros), columns >= N are not
// computed, rows >= rows are not written.  Offsets are int64.
#include <cuda_runtime.h>

namespace {

constexpr int kTN = 128;  // output columns per CTA, one per thread
constexpr int kKC = 128;  // block columns staged per pass

template <int RB>
__global__ void bcsr_spmm_kernel(const int* __restrict__ brp,
                                 const int* __restrict__ bcol,
                                 const float* __restrict__ blocks,
                                 const float* __restrict__ b,
                                 float* __restrict__ c, int rows, int cols,
                                 int n, int br, int bc) {
  __shared__ float As[RB * kKC];
  const long long i = blockIdx.x;  // block row
  const int j = blockIdx.y * kTN + threadIdx.x;
  const bool jok = j < n;
  const int p0 = brp[i];
  const int p1 = brp[i + 1];
  for (int r0 = 0; r0 < br; r0 += RB) {
    const int nr = min(RB, br - r0);
    float acc[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = 0.0f;
    for (int p = p0; p < p1; ++p) {
      const long long kbase = static_cast<long long>(bcol[p]) * bc;
      const float* blk = blocks + static_cast<long long>(p) * br * bc;
      for (int k0 = 0; k0 < bc; k0 += kKC) {
        const int nk = min(kKC, bc - k0);
        __syncthreads();  // the previous tile's readers are done
        for (int t = threadIdx.x; t < RB * kKC; t += blockDim.x) {
          const int r = t / kKC;
          const int kk = t - r * kKC;
          As[t] = (r < nr && kk < nk)
                      ? blk[static_cast<long long>(r0 + r) * bc + k0 + kk]
                      : 0.0f;
        }
        __syncthreads();
        if (!jok) continue;
        const long long krow = kbase + k0;  // B row of As column 0
        const long long left = static_cast<long long>(cols) - krow;
        const int kmax = left < nk ? static_cast<int>(left > 0 ? left : 0) : nk;
        const float* bp = b + krow * n + j;
#pragma unroll 4
        for (int kk = 0; kk < kmax; ++kk) {
          const float bv = bp[static_cast<long long>(kk) * n];
#pragma unroll
          for (int r = 0; r < RB; ++r) acc[r] = fmaf(As[r * kKC + kk], bv, acc[r]);
        }
      }
    }
    if (jok) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const long long row = i * br + r0 + r;
        if (r < nr && row < rows) c[row * n + j] = acc[r];
      }
    }
  }
}

template <int RB>
int launch(const int* brp, const int* bcol, const float* blocks,
           const float* b, float* c, int nbrows, int rows, int cols, int n,
           int br, int bc, cudaStream_t stream) {
  const dim3 grid(nbrows, (n + kTN - 1) / kTN);
  bcsr_spmm_kernel<RB><<<grid, kTN, 0, stream>>>(brp, bcol, blocks, b, c,
                                                 rows, cols, n, br, bc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// brp: int32[nbrows + 1]; bcol: int32[>= brp[nbrows]]; blocks: f32
// [>= brp[nbrows], br, bc]; b: f32[cols, n]; c: f32[rows, n], every
// element written.  nbrows >= 1, n >= 1 (the Python wrapper launches
// nothing otherwise).  Returns the cudaError_t of the launch.
extern "C" int smf_bcsr_spmm(const int* brp, const int* bcol,
                             const float* blocks, const float* b, float* c,
                             int nbrows, int rows, int cols, int n, int br,
                             int bc, cudaStream_t stream) {
  if (br <= 1) return launch<1>(brp, bcol, blocks, b, c, nbrows, rows, cols, n, br, bc, stream);
  if (br <= 2) return launch<2>(brp, bcol, blocks, b, c, nbrows, rows, cols, n, br, bc, stream);
  if (br <= 4) return launch<4>(brp, bcol, blocks, b, c, nbrows, rows, cols, n, br, bc, stream);
  return launch<8>(brp, bcol, blocks, b, c, nbrows, rows, cols, n, br, bc, stream);
}
