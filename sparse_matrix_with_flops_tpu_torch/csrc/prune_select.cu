// K11: the static R-MCL step's prune, top-S selection and renormalisation
// of one compacted ELL product tile, a block a row.  For tile row r (K1's
// output: the valid lanes, column < n, first and in column order, then
// sentinel lanes (n, 0.0)), with w = v * v over the valid lanes:
//   t = computeThreshold(sum(w) / max(count, 1), max(w))      (util.cc:4-9)
//   keep = valid & w >= t
//   the S kept lanes of largest w (a tie at the S cut keeps the lower
//   column), in column order, each w divided by their sum (at least 1e-30),
// written as row rows[r] of out_c / out_v ([*, S], padded with (n, 0.0));
// counts[0] += the row's survivors, counts[1] += 1 where more than S lanes
// were kept.
//
// Replaces no TPU kernel: the JAX package selects with XLA's lax.sort
// (sparse_matrix_with_flops_tpu/models/rmcl_ell.py:182-205, a full-width
// sort by -w and a second sort of the S survivors by column), which the
// port ran as two stable torch.sorts a tile (`_prune_select_lanes`, kept
// for the hub rows, whose tiles are n lanes wide).  Neither sort is needed:
// K1 leaves the lanes in column order, so lanes taken in lane order come
// out column-sorted, and the S-th largest w is one radix select away.
//
// What bounds it on the H100: one read of the row's valid prefix (8 bytes
// a lane) and the S-lane output row; the sentinel tail is never read.  At
// the LFR cell's widths (2,048-8,192 lanes, a few hundred valid) a row is
// short, so the block's barriers and the load latency count as much as the
// bytes.  Design:
// * the block loads 16 bytes of columns and 16 of values a thread (4 lanes),
//   1,024 lanes a round, squares the valid values into shared memory (an
//   invalid lane stored as -1.0f, below any threshold) and stops after the
//   first round that met a sentinel;
// * the row sum is taken in one fixed order, which the plain version
//   (`select_kernels.prune_select_plain`) repeats: each thread its lanes
//   in lane order from 0.0f, then a shuffle butterfly over the warp, then
//   the warps in index order; the threshold is computeThreshold's
//   operations one by one in round-to-nearest intrinsics (no contraction);
// * a row that keeps more than S lanes finds the S-th largest w by an
//   MSB-first radix select on its bits (w >= +0: the bits order as the
//   values), 8 bits a pass over a 256-bin histogram in shared memory
//   (lanes of one bin added once a warp, by __match_any_sync), stopping
//   early once the cut bin is taken whole;
// * the survivors are placed by a scan over (1,024-lane round, warp) counts
//   of the lanes above the cut and of those equal to it: a lane above goes
//   to (above before it) + min(equal before it, equal taken), an equal lane
//   is taken while (equal before it) < (equal taken), so ties go to the
//   lower columns with no sort;
// * the S survivors are summed by one warp in a fixed order (a lane its
//   positions 32 apart, then the butterfly), divided and written.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // select_kernels.SELECT_THREADS
constexpr int kWarps = kThreads / 32;
constexpr int kRound = 4 * kThreads;  // lanes the block loads at once
constexpr int kMaxW = 32768;          // select_kernels.MAX_SELECT_W
constexpr int kMaxRounds = kMaxW / kRound;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;
// computeThreshold's constants (config.MLMCL_PRUNE_A / _B, PRUNE_FLOOR)
constexpr float kPruneA = 0.90f;
constexpr float kPruneB = 2.0f;
constexpr float kFloor = 1.0e-7f;
constexpr float kTiny = 1.0e-30f;

struct Shared {
  float sum[kWarps];
  float max[kWarps];
  int count[kWarps];
  // a (round, warp) entry: lanes above the cut << 16 | lanes equal to it;
  // after a scan, the entries before it (kept lanes <= 32768 fit 16 bits)
  unsigned table[kMaxRounds * kWarps];
  unsigned hist[2][256];
  unsigned total;  // the table's sum
  unsigned prefix, mask, need;  // the radix select's state
  int done;
};

__device__ __forceinline__ unsigned warp_inclusive(unsigned x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// One warp: each entry of table[0:entries) replaced by the sum of those
// before it; returns the sum of all.
__device__ __forceinline__ unsigned scan_table(unsigned* table, int entries, int lane) {
  const int per = (entries + 31) / 32;
  const int lo = min(lane * per, entries), hi = min(lo + per, entries);
  unsigned local = 0;
  for (int e = lo; e < hi; ++e) local += table[e];
  const unsigned incl = warp_inclusive(local, lane);
  unsigned run = incl - local;
  for (int e = lo; e < hi; ++e) {
    const unsigned x = table[e];
    table[e] = run;
    run += x;
  }
  return __shfl_sync(kFull, incl, 31);
}

// The 4 lanes of one thread in a round: each kept lane's class, 2 above
// the cut, 1 equal to it, 0 neither.
__device__ __forceinline__ void classify(const float4 x, float t, unsigned prefix, unsigned mask,
                                         bool radix, int cls[4]) {
  const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned u = __float_as_uint(xs[j]) & mask;
    cls[j] = xs[j] >= t ? (!radix || u > prefix ? 2 : (u == prefix ? 1 : 0)) : 0;
  }
}

// Counts of each (round, warp) into the table: lanes above << 16 | equal.
__device__ __forceinline__ void count_table(const float* w_s, int rounds, int end, float t,
                                            unsigned prefix, unsigned mask, bool radix,
                                            unsigned* table, int tid, int lane, int warp) {
  for (int rd = 0; rd < rounds; ++rd) {
    const int i = rd * kRound + 4 * tid;
    unsigned m = 0;
    if (i < end) {
      int cls[4];
      classify(*reinterpret_cast<const float4*>(w_s + i), t, prefix, mask, radix, cls);
#pragma unroll
      for (int j = 0; j < 4; ++j) m += cls[j] == 2 ? 0x10000u : (cls[j] == 1 ? 1u : 0u);
    }
    m = __reduce_add_sync(kFull, m);
    if (lane == 0) table[rd * kWarps + warp] = m;
  }
}

// Block r: tile row r.  Dynamic shared memory: w of the row's padded width
// W4 = W rounded up to 4 lanes, then S columns and S values of survivors.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    prune_select_kernel(const int* __restrict__ key, const float* __restrict__ uval,
                        const long long* __restrict__ rows, int* __restrict__ out_c,
                        float* __restrict__ out_v, unsigned long long* __restrict__ counts,
                        int W, int n, int S) {
  extern __shared__ float4 smem4[];
  __shared__ Shared sh;
  const int W4 = (W + 3) & ~3;
  float* w_s = reinterpret_cast<float*>(smem4);
  int* sel_c = reinterpret_cast<int*>(w_s + W4);
  float* sel_w = reinterpret_cast<float*>(sel_c + S);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long r = blockIdx.x;
  const int* kr = key + r * W;
  const float* vr = uval + r * W;

  // 1. the valid prefix into shared memory as w (-1.0f where invalid), each
  // thread's sum, max and count of its lanes in lane order
  float s = 0.0f, mx = 0.0f;
  int cnt = 0, end = W4;
  for (int base = 0; base < W4; base += kRound) {
    const int i = base + 4 * tid;
    int c[4] = {n, n, n, n};
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (kVec) {
      if (i < W4) {
        const int4 c4 = *reinterpret_cast<const int4*>(kr + i);
        const float4 v4 = *reinterpret_cast<const float4*>(vr + i);
        c[0] = c4.x, c[1] = c4.y, c[2] = c4.z, c[3] = c4.w;
        v[0] = v4.x, v[1] = v4.y, v[2] = v4.z, v[3] = v4.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (i + j < W) {
          c[j] = kr[i + j];
          v[j] = vr[i + j];
        }
      }
    }
    float x[4];
    bool tail = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = c[j] < n;
      const float wj = ok ? __fmul_rn(v[j], v[j]) : 0.0f;
      s = __fadd_rn(s, wj);
      mx = fmaxf(mx, wj);
      cnt += ok;
      tail |= !ok;
      x[j] = ok ? wj : -1.0f;
    }
    if (i < W4) *reinterpret_cast<float4*>(w_s + i) = make_float4(x[0], x[1], x[2], x[3]);
    if (__syncthreads_or(tail)) {  // the valid lanes end in this round
      end = min(base + kRound, W4);
      break;
    }
  }
  const int rounds = (end + kRound - 1) / kRound;

  // 2. the row's sum (fixed order), max, count and threshold
#pragma unroll
  for (int d = 16; d; d >>= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(kFull, s, d));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, d));
    cnt += __shfl_xor_sync(kFull, cnt, d);
  }
  if (lane == 0) {
    sh.sum[warp] = s;
    sh.max[warp] = mx;
    sh.count[warp] = cnt;
  }
  __syncthreads();
  float rsum = sh.sum[0], rmax = sh.max[0];
  int rcount = sh.count[0];
#pragma unroll
  for (int k = 1; k < kWarps; ++k) {
    rsum = __fadd_rn(rsum, sh.sum[k]);
    rmax = fmaxf(rmax, sh.max[k]);
    rcount += sh.count[k];
  }
  const float avg = __fdiv_rn(rsum, fmaxf(static_cast<float>(rcount), 1.0f));
  float t = __fmul_rn(__fmul_rn(kPruneA, avg),
                      __fsub_rn(1.0f, __fmul_rn(kPruneB, __fsub_rn(rmax, avg))));
  t = fminf(fmaxf(t, kFloor), rmax);

  // 3. the kept lanes by (round, warp), and their total
  count_table(w_s, rounds, end, t, 0u, 0u, false, sh.table, tid, lane, warp);
  for (int b = tid; b < 256; b += kThreads) sh.hist[0][b] = 0;
  __syncthreads();
  if (warp == 0) {
    const unsigned tot = scan_table(sh.table, rounds * kWarps, lane);
    if (lane == 0) sh.total = tot;
  }
  __syncthreads();
  const unsigned kept = sh.total >> 16;
  const bool truncated = kept > static_cast<unsigned>(S);

  // 4. more than S kept: the S-th largest w by its bits, 8 a pass
  unsigned prefix = 0, mask = 0, need = 0;
  if (truncated) {
    need = S;
    for (int pass = 0, shift = 24; shift >= 0; ++pass, shift -= 8) {
      unsigned* h = sh.hist[pass & 1];
      for (int b = tid; b < 256; b += kThreads) sh.hist[(pass + 1) & 1][b] = 0;
      for (int rd = 0; rd < rounds; ++rd) {
        const int i = rd * kRound + 4 * tid;
        float4 x4 = make_float4(-1.0f, -1.0f, -1.0f, -1.0f);
        if (i < end) x4 = *reinterpret_cast<const float4*>(w_s + i);
        const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned u = __float_as_uint(xs[j]);
          const int bin = xs[j] >= t && (u & mask) == prefix ? static_cast<int>((u >> shift) & 255u)
                                                              : -1;
          const unsigned peers = __match_any_sync(kFull, bin);
          if (bin >= 0 && lane == __ffs(peers) - 1) atomicAdd(&h[bin], __popc(peers));
        }
      }
      __syncthreads();
      if (warp == 0) {
        // lane l holds bins 255 - 8 l down to 248 - 8 l; lanes in order of
        // falling bins, so the inclusive scan counts the lanes at or above
        unsigned c8 = 0;
#pragma unroll
        for (int q = 0; q < 8; ++q) c8 += h[255 - 8 * lane - q];
        const unsigned incl = warp_inclusive(c8, lane);
        const unsigned excl = incl - c8;
        const unsigned who = __ballot_sync(kFull, excl < need && need <= incl);
        if (lane == __ffs(who) - 1) {
          unsigned above = excl;
          int b = 255 - 8 * lane;
          while (above + h[b] < need) above += h[b--];
          sh.prefix = prefix | (static_cast<unsigned>(b) << shift);
          sh.mask = mask | (255u << shift);
          sh.need = need - above;
          sh.done = h[b] == need - above;  // the cut bin is taken whole
        }
      }
      __syncthreads();
      prefix = sh.prefix;
      mask = sh.mask;
      need = sh.need;
      if (sh.done) break;
    }
    // the table again: lanes above the cut, lanes equal to it
    count_table(w_s, rounds, end, t, prefix, mask, true, sh.table, tid, lane, warp);
    __syncthreads();
    if (warp == 0) scan_table(sh.table, rounds * kWarps, lane);
    __syncthreads();
  }

  // 5. the survivors at their places, in lane (column) order
  for (int rd = 0; rd < rounds; ++rd) {
    const int i = rd * kRound + 4 * tid;
    int cls[4] = {0, 0, 0, 0};
    if (i < end) classify(*reinterpret_cast<const float4*>(w_s + i), t, prefix, mask, truncated, cls);
    unsigned m = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) m += cls[j] == 2 ? 0x10000u : (cls[j] == 1 ? 1u : 0u);
    unsigned before = warp_inclusive(m, lane) - m + sh.table[rd * kWarps + warp];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (cls[j]) {
        const unsigned above = before >> 16, equal = before & 0xffffu;
        const bool take = cls[j] == 2 || equal < need;
        if (take) {
          const int pos = static_cast<int>(above + min(equal, need));
          sel_c[pos] = kr[i + j];
          sel_w[pos] = w_s[i + j];
        }
        before += cls[j] == 2 ? 0x10000u : 1u;
      }
    }
  }
  __syncthreads();

  // 6. renormalise and write the row (one warp)
  if (warp == 0) {
    const unsigned tot = truncated ? S : kept;
    const int nsel = static_cast<int>(tot);
    float ksum = 0.0f;
    for (int p = lane; p < S; p += 32) ksum = __fadd_rn(ksum, p < nsel ? sel_w[p] : 0.0f);
#pragma unroll
    for (int d = 16; d; d >>= 1) ksum = __fadd_rn(ksum, __shfl_xor_sync(kFull, ksum, d));
    const float div = fmaxf(ksum, kTiny);
    const long long o = rows[r] * S;
    for (int p = lane; p < S; p += 32) {
      out_c[o + p] = p < nsel ? sel_c[p] : n;
      out_v[o + p] = p < nsel ? __fdiv_rn(sel_w[p], div) : 0.0f;
    }
    if (lane == 0) {
      if (nsel) atomicAdd(counts, static_cast<unsigned long long>(nsel));
      if (truncated) atomicAdd(counts + 1, 1ull);
    }
  }
}

template <bool kVec>
int launch(const int* key, const float* uval, const long long* rows, int* out_c, float* out_v,
           long long* counts, int R, int W, int n, int S, cudaStream_t stream) {
  static bool ready[kMaxDevices];
  const int smem = ((W + 3) & ~3) * 4 + S * 8;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {  // the most any call takes: W = kMaxW, S = 4096
    err = cudaFuncSetAttribute(prune_select_kernel<kVec>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxW * 4 + 4096 * 8);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  prune_select_kernel<kVec><<<R, kThreads, smem, stream>>>(
      key, uval, rows, out_c, out_v, reinterpret_cast<unsigned long long*>(counts), W, n, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// key / uval: [R, W] int32 / f32 (K1's compacted tile); rows: int64 [R],
// each a row of out_c / out_v ([*, S] int32 / f32); counts: int64 [2],
// added to.  1 <= R < 2^31, 1 <= W <= 32768, 1 <= S <= 4096 (the Python
// wrapper checks).  vec: key and uval on the 16-byte grid and W % 4 == 0.
extern "C" int smf_prune_select(const int* key, const float* uval, const long long* rows,
                                int* out_c, float* out_v, long long* counts, int R, int W,
                                int n, int S, int vec, cudaStream_t stream) {
  if (R < 1 || W < 1 || W > kMaxW || S < 1 || S > 4096) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return vec ? launch<true>(key, uval, rows, out_c, out_v, counts, R, W, n, S, stream)
             : launch<false>(key, uval, rows, out_c, out_v, counts, R, W, n, S, stream);
}
