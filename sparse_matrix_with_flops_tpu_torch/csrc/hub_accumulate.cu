// K10: the ELL-ESC SpGEMM's hub rows as a sparse accumulator.  One work
// item is one (hub row, column slab) of a plan's hub group: the item sums
// the row's products whose columns fall in the slab in a slab-wide f32
// accumulator in shared memory, then compacts it in column order into the
// item's region of the flat tile stream:
//   out[out0 + k] = (col0 + c_k, acc[c_k]) for the nonzero columns c_0 < c_1 < ...,
//   out[out0 + k] = (ncols, 0.0f) for count <= k < cap, counts[vrow] = count.
//
// Replaces no TPU kernel: the JAX package's dense hub densifies A and each
// B slab and multiplies them with XLA's f32 matmul
// (sparse_matrix_with_flops_tpu/ops/ell_esc.py, `_hub_products`), then
// compacts each dense row (B2, pallas_sort.py:300; K2 on the card).  For a
// power-law graph that is ~30,000 times the real work (Graph500 s16: 71.1
// TFLOP of dense products a call for 1.165 G products); this kernel does
// the products alone (Gustavson's row-wise SpGEMM with a dense
// accumulator), for the groups the wrapper's caller routes to it.
//
// Order of the sums: every output is added strictly in the row's A-entry
// order, each product rounded before its add (__fmul_rn, __fadd_rn: no FMA
// contraction), starting from 0.0f, as a sequential Gustavson sums it.  No
// float atomics: a replay gives the eager run's bits, and the plain twin
// (`hub_accumulate_plain`: expand, stable sort by (item, column),
// `run_sums_plain`) gives them on the CPU.  Exact zeros are dropped, as the
// dense hub drops them.
//
// What bounds it on the H100: the writes of the regions (8 bytes a lane;
// Graph500 s16: 696 M lanes, ~1.7 ms at 3.35 TB/s) and, above that, the
// latency of the B gathers (a slab's B segments are a few MB: L2 hits) and
// of the accumulator's ordered read-modify-writes, with few warps an SM
// since each holds its accumulator in shared memory.  Design:
// * a block an item, a warp a tile of its slab: `tile` columns (2,048:
//   8 KB, ~28 warps an SM) from the tile's own table of B segments; the
//   tiles' counts meet in shared memory, so each warp writes its tile's
//   entries at their place in the item's region;
// * a warp takes the row's A entries 32 at a time, a lane looking up its
//   entry's B segment (one pair of `boff`); the nonempty entries follow in
//   order, kUnroll at a time: the loads of their first 32 products are
//   issued together, then each entry adds its products (a segment longer
//   than 32 adds the rest at once: one entry's columns are distinct);
// * the warp meets (__syncwarp) between one entry's adds and the next's,
//   which keeps every column's sum in A-entry order with no atomics;
// * the compaction reads 128 columns a step (a float4 a lane), lays the
//   lanes' nonzero counts end to end by a warp scan and writes straight
//   into the region: no dense intermediate leaves the SM.
// Graph500 s16 on an H100 (700 W): 7.9 ms a call, 21% of its byte bound,
// against 1.40 s of dense matmuls; the first design (a warp a 4,096-column
// item, products spread over lanes across entries and ordered by
// __match_any_sync) took 24 ms.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxWarps = 16;  // tiles of one slab, a warp each: a block an item
constexpr int kUnroll = 4;     // entries whose first B loads are in flight together
constexpr unsigned kFull = 0xffffffffu;

// an item's int64 fields (hub_kernels.META)
enum Field { kA0, kA1, kSlab0, kKh, kTile, kOut0, kCap, kCol0, kWidth, kVrow, kMeta };

// acc[0:tile) = the products of A entries [a0, a1) that fall in the tile
// whose segment table starts at sk, each column summed in A-entry order
// from 0.0f.  One warp.
__device__ __forceinline__ void accumulate(float* acc, int tile, long long a0, long long a1,
                                           long long sk, const int* __restrict__ krow,
                                           const float* __restrict__ aval,
                                           const long long* __restrict__ boff,
                                           const short* __restrict__ bcol,
                                           const float* __restrict__ bval, int lane) {
  for (int c = 4 * lane; c < tile; c += 128) {
    *reinterpret_cast<float4*>(acc + c) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  for (long long base = a0; base < a1; base += 32) {
    // lane l: entry base + l's segment and value
    const long long e = base + lane;
    long long s0 = 0;
    int len = 0;
    float av = 0.0f;
    if (e < a1) {
      const long long k = krow[e] + sk;
      s0 = boff[k];
      len = static_cast<int>(boff[k + 1] - s0);
      av = aval[e];
    }
    // the batch's nonempty entries in order, kUnroll at a time: their
    // first 32 products' loads are issued together, then each entry adds
    // its products (the first 32, then the rest of a longer segment) and
    // the warp meets before the next entry's adds
    for (unsigned left = __ballot_sync(kFull, len > 0); left;) {
      int lj[kUnroll], col[kUnroll];
      long long qj[kUnroll];
      float aj[kUnroll], prod[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = left ? __ffs(left) - 1 : 0;  // the same for the whole warp
        const int lv = __shfl_sync(kFull, len, j);
        lj[u] = left ? lv : 0;
        left &= left - 1;
        qj[u] = __shfl_sync(kFull, s0, j);
        aj[u] = __shfl_sync(kFull, av, j);
        col[u] = -1;
        prod[u] = 0.0f;
        if (lane < lj[u]) {
          col[u] = bcol[qj[u] + lane];
          prod[u] = __fmul_rn(aj[u], __ldg(bval + qj[u] + lane));
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (lj[u] == 0) break;  // the same for the whole warp
        __syncwarp();
        if (col[u] >= 0) acc[col[u]] = __fadd_rn(acc[col[u]], prod[u]);
        for (int c = lane + 32; c < lj[u]; c += 32) {  // one entry: distinct columns
          const int cc = bcol[qj[u] + c];
          acc[cc] = __fadd_rn(acc[cc], __fmul_rn(aj[u], __ldg(bval + qj[u] + c)));
        }
      }
    }
  }
  __syncwarp();
}

// Block b: item b, warp w its tile w (warps past the item's width idle).
__global__ void __launch_bounds__(kMaxWarps * 32)
    hub_accumulate_kernel(const long long* __restrict__ meta, const int* __restrict__ krow,
                          const float* __restrict__ aval, const long long* __restrict__ boff,
                          const short* __restrict__ bcol, const float* __restrict__ bval,
                          int* __restrict__ out_c, float* __restrict__ out_v,
                          int* __restrict__ counts, int ncols, int tile_max) {
  extern __shared__ float4 smem4[];
  __shared__ int tile_nnz[kMaxWarps];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const long long item = blockIdx.x;
  const long long f = lane < kMeta ? meta[item * kMeta + lane] : 0;
  const long long a0 = __shfl_sync(kFull, f, kA0), a1 = __shfl_sync(kFull, f, kA1);
  const long long slab0 = __shfl_sync(kFull, f, kSlab0), kh = __shfl_sync(kFull, f, kKh);
  const long long out0 = __shfl_sync(kFull, f, kOut0);
  const int tile = static_cast<int>(__shfl_sync(kFull, f, kTile));
  const int cap = static_cast<int>(__shfl_sync(kFull, f, kCap));
  const int col0 = static_cast<int>(__shfl_sync(kFull, f, kCol0));
  const int width = static_cast<int>(__shfl_sync(kFull, f, kWidth));
  const long long vrow = __shfl_sync(kFull, f, kVrow);
  float* acc = reinterpret_cast<float*>(smem4) + static_cast<long long>(w) * tile_max;
  const int t0 = w * tile;
  const int tw = t0 < width ? min(tile, width - t0) : 0;  // columns read back: 0 when idle
  if (tw > 0) accumulate(acc, tile, a0, a1, slab0 + w * kh, krow, aval, boff, bcol, bval, lane);
  // each tile's nonzeros, then the tiles laid end to end in column order
  // (columns past the tile's width were never added to: they read 0)
  int n = 0;
  for (int c = 4 * lane; c < tw; c += 128) {
    const float4 v = *reinterpret_cast<const float4*>(acc + c);
    n += (v.x != 0.0f) + (v.y != 0.0f) + (v.z != 0.0f) + (v.w != 0.0f);
  }
  n = __reduce_add_sync(kFull, n);
  if (lane == 0) tile_nnz[w] = n;
  __syncthreads();
  int written = 0, total = 0;
  for (int i = 0; i < warps; ++i) {
    written += i < w ? tile_nnz[i] : 0;
    total += tile_nnz[i];
  }
  int* oc = out_c + out0;
  float* ov = out_v + out0;
  // 128 columns a step: a lane's four in order, the lanes' counts laid end
  // to end by a warp scan
  for (int c0 = 0; c0 < tw && written < cap; c0 += 128) {
    const int c = c0 + 4 * lane;
    const float4 v = *reinterpret_cast<const float4*>(acc + c);
    const int m = (v.x != 0.0f) + (v.y != 0.0f) + (v.z != 0.0f) + (v.w != 0.0f);
    int pos = m;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, pos, d);
      if (lane >= d) pos += y;
    }
    const int step = __shfl_sync(kFull, pos, 31);
    pos += written - m;
    const int cc = col0 + t0 + c;
    if (v.x != 0.0f) {
      if (pos < cap) { oc[pos] = cc; ov[pos] = v.x; }
      ++pos;
    }
    if (v.y != 0.0f) {
      if (pos < cap) { oc[pos] = cc + 1; ov[pos] = v.y; }
      ++pos;
    }
    if (v.z != 0.0f) {
      if (pos < cap) { oc[pos] = cc + 2; ov[pos] = v.z; }
      ++pos;
    }
    if (v.w != 0.0f && pos < cap) {
      oc[pos] = cc + 3;
      ov[pos] = v.w;
    }
    written += step;
  }
  for (int pos = total + threadIdx.x; pos < cap; pos += blockDim.x) {
    oc[pos] = ncols;
    ov[pos] = 0.0f;
  }
  if (threadIdx.x == 0) counts[vrow] = total;
}

}  // namespace

// meta: [n_items, 10] int64 items (hub_kernels.META); krow / aval: the hub
// entries' first table index and A value; boff: int64 segment offsets into
// bcol (int16 tile-local columns) and bval; out_c / out_v: the regions;
// counts: int32 by virtual row.  tile_max: the widest tile (floats of
// shared memory a warp); warps: the most tiles of any item's slab (at most
// kMaxWarps).  n_items >= 1.
extern "C" int smf_hub_accumulate(const long long* meta, long long n_items, const int* krow,
                                  const float* aval, const long long* boff, const short* bcol,
                                  const float* bval, int* out_c, float* out_v, int* counts,
                                  int ncols, int tile_max, int warps, cudaStream_t stream) {
  if (n_items < 1 || n_items >= (1LL << 31) || tile_max < 128 || tile_max % 128 || warps < 1 ||
      warps > kMaxWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = warps * tile_max * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(hub_accumulate_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  hub_accumulate_kernel<<<static_cast<unsigned>(n_items), warps * 32, smem, stream>>>(
      meta, krow, aval, boff, bcol, bval, out_c, out_v, counts, ncols, tile_max);
  return static_cast<int>(cudaGetLastError());
}
