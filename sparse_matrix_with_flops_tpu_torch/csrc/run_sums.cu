// K9: the sums of contiguous runs of an f32 stream,
// out[i] = v[off[i]] + v[off[i] + 1] + ... + v[off[i + 1] - 1], each added
// strictly left to right in run-local order, starting from 0.0f.
//
// Replaces no TPU kernel: the JAX package sums its runs with XLA's
// `jax.ops.segment_sum` (sparse_matrix_with_flops_tpu/ops/segments.py:106),
// which on the CPU gives the bits of a sequential sum, as
// `torch.segment_reduce` does there.  On the card `torch.segment_reduce`
// (CUB's segmented reduce) adds a run in an order that depends on where the
// run starts in the stream; this kernel's order depends on the run alone,
// so the card gives the CPU's bits, and a run moved to another offset (a
// shard's stream against the single card's) gives the same bits.
//
// What bounds it on the H100: device-memory traffic (each value and offset
// read once, each sum written once) and, for a long run, the chain of
// dependent adds (one add latency a value: the order is fixed, so a run's
// adds cannot be spread over lanes).  Two modes, one order:
// * "lanes" (the wrapper's choice when the stream holds fewer than 32
//   slots a run): a warp takes 32 consecutive runs, and a lane adds its own
//   run alone if it holds at most kShort values; the warp then adds each
//   longer run of its 32 together, one after another.
// * "warps" (32 or more slots a run, as for a matrix's row sums): a warp a
//   run, together.
// Together, a warp walks the run in chunks of 128 values laid on the
// stream's 16-byte grid: each lane loads one float4 (masked scalar loads
// at the run's two ends), stores it to shared memory, and every lane then
// folds the chunk's values in order from shared memory (broadcast reads)
// into its own copy of the sum; the next chunk's loads are issued before
// the fold, so they overlap it.  A slot outside the run counts as +0.0f,
// which leaves the sum unchanged: a sum started at +0.0f is never -0.0f
// under round-to-nearest, and x + 0.0f == x for every other x.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kShort = 32;  // a lane adds a run of at most this many values alone
constexpr unsigned kFull = 0xffffffffu;

// v[s:e) added in order from 0.0f by one lane.
__device__ __forceinline__ float lane_sum(const float* __restrict__ v, long long s,
                                          long long e) {
  float acc = 0.0f;
#pragma unroll 4
  for (long long i = s; i < e; ++i) acc += v[i];
  return acc;
}

// Elements q .. q + 3 (q on the 16-byte grid), 0.0f outside [s, e).
__device__ __forceinline__ float4 load_vec(const float* __restrict__ v, long long q,
                                           long long s, long long e) {
  if (q >= s && q + 4 <= e) return __ldg(reinterpret_cast<const float4*>(v + q));
  float4 r;
  r.x = (q >= s && q < e) ? v[q] : 0.0f;
  r.y = (q + 1 >= s && q + 1 < e) ? v[q + 1] : 0.0f;
  r.z = (q + 2 >= s && q + 2 < e) ? v[q + 2] : 0.0f;
  r.w = (q + 3 >= s && q + 3 < e) ? v[q + 3] : 0.0f;
  return r;
}

// v[s:e) added in order from 0.0f by the whole warp (every lane returns
// the sum).  Element i lies at grid slot i + head; ``stage`` is the warp's
// 32 float4 of shared memory.
__device__ float warp_sum(const float* __restrict__ v, long long s, long long e,
                          int head, float4* stage, int lane) {
  float acc = 0.0f;
  if (s >= e) return acc;
  long long g = (s + head) >> 2;             // the run's first grid vector
  const long long gend = (e + head + 3) >> 2;  // one past its last
  float4 cur = load_vec(v, 4 * (g + lane) - head, s, e);
  for (; g < gend; g += 32) {
    float4 nxt = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    __syncwarp();  // every lane has folded the last chunk
    stage[lane] = cur;
    __syncwarp();
    if (g + 32 < gend) nxt = load_vec(v, 4 * (g + 32 + lane) - head, s, e);
    const int nv = static_cast<int>(gend - g < 32 ? gend - g : 32);
#pragma unroll 8
    for (int j = 0; j < nv; ++j) {
      const float4 x = stage[j];
      acc += x.x;
      acc += x.y;
      acc += x.z;
      acc += x.w;
    }
    cur = nxt;
  }
  return acc;
}

template <typename Off, bool kWarpPerRun>
__global__ void __launch_bounds__(kThreads)
    run_sums_kernel(const float* __restrict__ v, const Off* __restrict__ off,
                    float* __restrict__ out, long long runs, int head) {
  __shared__ float4 stage[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long gw = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (kWarpPerRun) {
    if (gw >= runs) return;  // the whole warp
    const float acc = warp_sum(v, off[gw], off[gw + 1], head, stage[warp], lane);
    if (lane == 0) out[gw] = acc;
    return;
  }
  const long long r = gw * 32 + lane;
  long long s = 0, e = 0;  // lanes past the last run hold an empty one
  if (r < runs) {
    s = off[r];
    e = off[r + 1];
  }
  const bool alone = e - s <= kShort;
  if (r < runs && alone) out[r] = lane_sum(v, s, e);
  for (unsigned rest = __ballot_sync(kFull, !alone); rest; rest &= rest - 1) {
    const int l = __ffs(rest) - 1;
    const long long ls = __shfl_sync(kFull, s, l), le = __shfl_sync(kFull, e, l);
    const float acc = warp_sum(v, ls, le, head, stage[warp], lane);
    if (lane == l) out[r] = acc;
  }
}

template <typename Off>
cudaError_t launch(const float* v, const Off* off, float* out, long long runs,
                   int warp_per_run, cudaStream_t stream) {
  const int head = static_cast<int>((reinterpret_cast<uintptr_t>(v) >> 2) & 3);
  const long long warps = warp_per_run ? runs : (runs + 31) / 32;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (warp_per_run) {
    run_sums_kernel<Off, true><<<grid, kThreads, 0, stream>>>(v, off, out, runs, head);
  } else {
    run_sums_kernel<Off, false><<<grid, kThreads, 0, stream>>>(v, off, out, runs, head);
  }
  return cudaGetLastError();
}

}  // namespace

// off: runs + 1 non-decreasing int32 (off64 == 0) or int64 offsets into v,
// each within the stream; warp_per_run picks the mode (the bits are the
// same in both).  runs >= 1.
extern "C" int smf_run_sums(const float* v, const void* off, int off64, float* out,
                            long long runs, int warp_per_run, cudaStream_t stream) {
  if (runs < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      off64 ? launch(v, static_cast<const long long*>(off), out, runs, warp_per_run, stream)
            : launch(v, static_cast<const int*>(off), out, runs, warp_per_run, stream);
  return static_cast<int>(err);
}
