// K5: blocked SpMM C = A · B, A in BCSR (dense br x bc blocks), B dense.
//
// Replaces the Pallas kernel sparse_matrix_with_flops_tpu/ops/spmm.py
// `_bcsr_spmm_pallas` (body `_bcsr_kernel`).  There the grid ran
// (block row, N tile, k-th block of the row) in order on one core, every
// row padded to the longest row's block count, and the output tile was
// carried in VMEM across the k axis.  Here CTAs run in no order.
//
// What bounds it on the H100.  Counting each operand once, the cant band
// (BCSR(8, 128), 11,703 blocks, N = 512) moves 0.30 GB against 12.27
// GFLOP: 0.091 ms of bytes, 0.074 ms of operations as three TF32
// tensor-core passes.  But each stored block needs its own bc x N slab of
// B, 4 FLOP a byte at br = 8, and a block row of a power-law matrix holds
// up to 123 blocks.  The first design (one CTA a block row, f32 FFMA, B
// read row by row from global memory) ran 13 TFLOP/s on the band and
// spent its time on s14 in the one CTA of the longest block row.  This
// design, item by item:
// 1. Tensor cores on 3xTF32 splits, through mma.sync m16n8k8.  The
//    product is taken transposed, a tile of C^T = B^T . block^T: 8 rows
//    of the block are the MMA's N = 8 (rows past br are zeros), and the
//    block, stored [br, bc] row-major, is K-major as it lies, so both
//    operands load straight from the staged tiles into registers and are
//    split there.  x = hi + lo, hi = cvt.rna.tf32(x); each k8 step chains
//    lo.hi, hi.lo and hi.hi into a fresh accumulator whose sum is added
//    into f32 registers with round-to-nearest: the tensor cores add into
//    their accumulator by truncation (PERF.md, PR 4).  (wgmma m64n8k8 on
//    the same splits was slower here: N = 8 is too small a wgmma, and the
//    block's split has to be written back to shared memory, one more
//    barrier a stage; PERF.md, PR 6.)
// 2. Staging.  A CTA owns 64 output columns (four warps of 16) of an
//    item (3.).  A stage is up to four blocks that share one B slab (the
//    same block column and depth chunk): a [8, 64] tile of each (8 of its
//    rows, 64 of its columns) and, when the stage before used another
//    one, B's [64, 64] slab, copied by cp.async into a two-deep ring with
//    one barrier a stage (a deeper ring costs more in occupancy than it
//    hides: PERF.md, PR 6).  A warp splits its B^T fragment once for the
//    stage's blocks, whose MMA chains are independent.  The host lists
//    an item's stages (BCSR.from_csr): its blocks grouped by block
//    column, then by depth chunk and row pass of 8 rows (br > 8), so that
//    the block rows of a band that share a block column load each B slab
//    once, four blocks a stage.  Where blocks rarely share a column (a
//    power-law matrix) the host takes one block a stage and the kernel
//    instance of one tile a stage, which keeps more CTAs resident.
// 3. Split long block rows.  The host cuts the block rows into items
//    (BCSR.from_csr, once a matrix): up to 8 / passes consecutive block
//    rows with at most 32 blocks in all, or one piece of 32 blocks of a
//    longer row.
//    An item of whole rows sums each row's products in shared memory and
//    writes its rows, the empty ones as zeros; a piece writes its partial
//    sums to a scratch slot, and a second small kernel adds a split row's
//    pieces in order.  No atomics: repeat calls are equal bit for bit.
//    The schedule lives on the card with the matrix, so a call reads
//    nothing back (a CUDA graph can capture it).
// Padding is done by zero-filled copies: B rows >= cols and block columns
// >= bc read as zeros, columns >= N are not written, nor are rows >= rows.
// Offsets are int64.
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using smf::cp_async16;
using smf::cp_async4;
using smf::cp_async_commit;
using smf::cp_async_wait;
using smf::split_tf32;

constexpr int kTN = 64;               // output columns a CTA
constexpr int kKC = 64;               // block columns a stage (SPMM_DEPTH)
constexpr int kGroup = 4;             // blocks a stage at most (SPMM_GROUP)
constexpr int kRows = 8;              // 8-row passes an item covers at most
constexpr int kStages = 2;            // the cp.async ring
constexpr int kThreads = 128;         // four warps, 16 columns each
constexpr int kAStride = kKC + 4;     // floats a row of a block tile
constexpr int kBStride = kTN + 8;     // floats a row of the B slab
constexpr int kAccStride = kTN + 4;   // floats a row of the accumulators
constexpr int kAccFloats = kRows * 8 * kAccStride;
constexpr int kATile = 8 * kAStride;
constexpr int kBTile = kKC * kBStride;
// shared memory of the instance that takes up to G blocks a stage
template <int G>
constexpr int smem_bytes() {
  return (kAccFloats + kStages * (G * kATile + kBTile)) * 4;
}

// One item of the schedule: block rows [row0, row0 + nrows), stages
// [s0, s1), and the scratch slot of a piece of a split row (or -1).
struct Item {
  int row0, nrows, s0, s1, slot;
};

// One stage: the B row of its depth chunk's first column, the chunk's
// first block column, (row pass << 1) | (a new B slab), its nb blocks and
// their accumulator rows (of 8).
struct Stage {
  int krow, k0, flags, nb;
  int block[kGroup];
  int arow[kGroup];
};

struct Args {
  const Item* items;
  const Stage* stages;
  const float* blocks;
  const float* b;
  float* c;
  float* partial;  // [slots, br, n]
  int rows, cols, n, br, bc, passes;  // passes: 8-row passes a block
  bool vec_b, vec_a;  // 16-byte copies of B rows / block rows
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy stage st's block tiles (rows 8 rh .. 8 rh + 7 of each block,
// depth k0 .. k0 + kKC) and, when it starts a new B slab, B's slab.
template <int G>
__device__ __forceinline__ void issue(const Args& p, const Stage& st, int n0,
                                      float* at, float* bt) {
  const int rh = st.flags >> 1;
  const int kw = min(kKC, p.bc - st.k0);  // valid depth of the stage
  const int nr = min(8, p.br - 8 * rh);   // valid rows of the pass
#pragma unroll
  for (int j = 0; j < G; ++j) {  // constant indices: the record stays in registers
    if (j >= st.nb) break;
    const float* blk = p.blocks +
                       (static_cast<long long>(st.block[j]) * p.br + 8 * rh) * p.bc + st.k0;
    float* dst = at + j * kATile;
    if (p.vec_a) {
      for (int q = threadIdx.x; q < 8 * (kKC / 4); q += kThreads) {
        const int r = q / (kKC / 4), c4 = (q % (kKC / 4)) * 4;
        const bool ok = r < nr && c4 < kw;
        cp_async16(dst + r * kAStride + c4,
                   ok ? blk + static_cast<long long>(r) * p.bc + c4 : p.blocks, ok);
      }
    } else {
      for (int q = threadIdx.x; q < 8 * kKC; q += kThreads) {
        const int r = q / kKC, c = q % kKC;
        const bool ok = r < nr && c < kw;
        cp_async4(dst + r * kAStride + c,
                  ok ? blk + static_cast<long long>(r) * p.bc + c : p.blocks, ok);
      }
    }
  }
  if ((st.flags & 1) == 0) return;
  const long long krow = st.krow;
  if (p.vec_b) {
    for (int q = threadIdx.x; q < kKC * (kTN / 4); q += kThreads) {
      const int r = q / (kTN / 4), c4 = (q % (kTN / 4)) * 4;
      const bool ok = r < kw && krow + r < p.cols && n0 + c4 < p.n;
      cp_async16(bt + r * kBStride + c4,
                 ok ? p.b + (krow + r) * p.n + n0 + c4 : p.b, ok);
    }
  } else {
    for (int q = threadIdx.x; q < kKC * kTN; q += kThreads) {
      const int r = q / kTN, c = q % kTN;
      const bool ok = r < kw && krow + r < p.cols && n0 + c < p.n;
      cp_async4(bt + r * kBStride + c, ok ? p.b + (krow + r) * p.n + n0 + c : p.b,
                ok);
    }
  }
}

// The warp's [16 columns, 8 block rows] products of one stage's blocks,
// each added into its accumulator row.  Depths past the block's are
// zeros in both operands.
template <int G>
__device__ __forceinline__ void compute(const Stage& st, const float* at,
                                        const float* bt, float* acc) {
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const float* bw = bt + warp * 16 + g;
  float sum[G][4] = {};
#pragma unroll 4
  for (int ks = 0; ks < kKC / 8; ++ks) {
    const int kk = ks * 8;
    // the MMA's A: B^T (m = output column, k = depth), split once for
    // the stage's blocks; its B: each block^T
    const float av[4] = {bw[(kk + t) * kBStride], bw[(kk + t) * kBStride + 8],
                         bw[(kk + t + 4) * kBStride],
                         bw[(kk + t + 4) * kBStride + 8]};
    unsigned ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(av[i], ah[i], al[i]);
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (j < st.nb) {
        const float* ar = at + j * kATile + g * kAStride + kk + t;
        unsigned bh0, bl0, bh1, bl1;
        split_tf32(ar[0], bh0, bl0);
        split_tf32(ar[4], bh1, bl1);
        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_tf32(d, al, bh0, bh1);
        mma_tf32(d, ah, bl0, bl1);
        mma_tf32(d, ah, bh0, bh1);
#pragma unroll
        for (int i = 0; i < 4; ++i) sum[j][i] += d[i];
      }
    }
  }
  // d[0]: (column g, block row 2t), d[1]: (g, 2t + 1), d[2]: (g + 8, 2t),
  // d[3]: (g + 8, 2t + 1)
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (j < st.nb) {
      float* a0 = acc + (st.arow[j] * 8 + 2 * t) * kAccStride + warp * 16 + g;
      a0[0] += sum[j][0];
      a0[kAccStride] += sum[j][1];
      a0[8] += sum[j][2];
      a0[kAccStride + 8] += sum[j][3];
    }
  }
}

// Issue stage s from its prefetched record ``next`` (then prefetch the
// record of s + 1); the record waits in ``rec`` for the stage's compute.
// A stage flagged new takes the next slot of the B ring (kStages slabs:
// the one in use and kStages - 1 ahead).
template <int G>
__device__ __forceinline__ void issue_stage(const Args& p, Stage& next, Stage* rec,
                                            int s, int nst, int s0, int n0,
                                            float* atile, float* btile, int& issued_b) {
  const Stage st = next;
  if (s + 1 < nst) next = p.stages[s0 + s + 1];
  if (threadIdx.x == 0) rec[s % kStages] = st;
  issue<G>(p, st, n0, atile + (s % kStages) * G * kATile,
           btile + (issued_b % kStages) * kBTile);  // read only when flagged new
  issued_b += st.flags & 1;
}

template <int G>
__global__ void __launch_bounds__(kThreads) bcsr_spmm_kernel(const Args p) {
  extern __shared__ __align__(16) float smem[];
  float* acc = smem;
  float* atile = acc + kAccFloats;
  float* btile = atile + kStages * G * kATile;
  __shared__ Stage rec[kStages];
  const Item it = p.items[blockIdx.x];
  const int n0 = blockIdx.y * kTN;
  const int arows = it.nrows * p.passes;  // accumulator rows of 8
  for (int i = threadIdx.x; i < arows * 8 * kAccStride; i += kThreads)
    acc[i] = 0.0f;
  const int nst = it.s1 - it.s0;
  // B slabs issued and consumed; the record of the next stage to issue
  // is loaded a stage early
  int issued_b = 0, used_b = 0;
  Stage next = p.stages[it.s0 < it.s1 ? it.s0 : 0];
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nst) issue_stage<G>(p, next, rec, s, nst, it.s0, n0, atile, btile, issued_b);
    cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s landed; stage s - 1's slots are free
    const Stage st = rec[s % kStages];
    if (s + kStages - 1 < nst)
      issue_stage<G>(p, next, rec, s + kStages - 1, nst, it.s0, n0, atile, btile, issued_b);
    cp_async_commit();
    used_b += st.flags & 1;
    compute<G>(st, atile + (s % kStages) * G * kATile,
               btile + ((used_b - 1) % kStages) * kBTile, acc);
  }
  __syncthreads();  // the zeroed accumulators of an empty item, too
  for (int i = threadIdx.x; i < arows * 8 * kTN; i += kThreads) {
    const int rr = i / kTN, col = i % kTN;
    const int lrow = rr / (8 * p.passes), r = rr % (8 * p.passes);  // row of the block
    if (r >= p.br || n0 + col >= p.n) continue;
    const float v = acc[rr * kAccStride + col];
    if (it.slot >= 0) {
      p.partial[(static_cast<long long>(it.slot) * p.br + r) * p.n + n0 + col] = v;
    } else {
      const long long row = static_cast<long long>(it.row0 + lrow) * p.br + r;
      if (row < p.rows) p.c[row * p.n + n0 + col] = v;
    }
  }
}

// C rows of a split block row: the sum of its pieces' partials in piece
// order.  splits[i] = (block row, first slot, pieces).
__global__ void __launch_bounds__(kThreads) bcsr_spmm_reduce(
    const int3* __restrict__ splits, const float* __restrict__ partial,
    float* __restrict__ c, int rows, int n, int br) {
  const int3 sp = splits[blockIdx.x];
  const int n0 = blockIdx.y * kTN;
  for (int i = threadIdx.x; i < br * kTN; i += kThreads) {
    const int r = i / kTN, col = n0 + i % kTN;
    const long long row = static_cast<long long>(sp.x) * br + r;
    if (col >= n || row >= rows) continue;
    float s = 0.0f;
    for (int q = 0; q < sp.z; ++q)
      s += partial[(static_cast<long long>(sp.y + q) * br + r) * n + col];
    c[row * n + col] = s;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

}  // namespace

// items: int32 [n_items, 5] (row0, nrows, first stage, end stage, slot);
// stages: int32 [n_stages, 12] (B row, first block column, (row pass
// << 1) | new B slab, nb, nb blocks, their accumulator rows), a new slab
// at each item's first stage, nb <= group (1 or 4; formats/bcsr.
// spmm_schedule); splits: int32
// [n_splits, 3] (block row, first slot, pieces); partial: f32 [slots, br,
// n] (unused without splits); blocks: f32
// [>= nblocks, br, bc]; b: f32 [cols, n]; c: f32 [rows, n], every element
// written.  n_items >= 1, n >= 1, br <= 64: an item covers at most
// 8 / ceil(br / 8) block rows (the Python schedule).  Returns the
// cudaError_t of the launches.
extern "C" int smf_bcsr_spmm(const int* items, int n_items, const int* stages,
                             int group, const int* splits, int n_splits, float* partial,
                             const float* blocks,
                             const float* b, float* c, int rows, int cols,
                             int n, int br, int bc, cudaStream_t stream) {
  if (br < 1 || br > 8 * kRows || bc < 1 || group < 1 || group > kGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  Args p;
  p.items = reinterpret_cast<const Item*>(items);
  p.stages = reinterpret_cast<const Stage*>(stages);
  p.blocks = blocks;
  p.b = b;
  p.c = c;
  p.partial = partial;
  p.rows = rows;
  p.cols = cols;
  p.n = n;
  p.br = br;
  p.bc = bc;
  p.passes = (br + 7) / 8;
  p.vec_b = n % 4 == 0 && aligned16(b);
  p.vec_a = bc % 4 == 0 && aligned16(blocks);
  const dim3 grid(n_items, (n + kTN - 1) / kTN);
  auto run = [&](auto kernel, int smem) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, kThreads, smem, stream>>>(p);
    return cudaGetLastError();
  };
  cudaError_t err = group == 1 ? run(bcsr_spmm_kernel<1>, smem_bytes<1>())
                               : run(bcsr_spmm_kernel<kGroup>, smem_bytes<kGroup>());
  if (err != cudaSuccess || n_splits == 0) return static_cast<int>(err);
  bcsr_spmm_reduce<<<dim3(n_splits, grid.y), kThreads, 0, stream>>>(
      reinterpret_cast<const int3*>(splits), partial, c, rows, n, br);
  return static_cast<int>(cudaGetLastError());
}
