// K4: inclusive int32 prefix sum of a long 1-D array.
//
// Replaces the Pallas kernel sparse_matrix_with_flops_tpu/ops/pallas_scan.py
// `cumsum_i32` (body `_scan_kernel`).  Sums wrap around as int32 sums do
// (the arithmetic is unsigned, where wrapping is defined).
//
// What bounds it on the H100: device-memory bandwidth, 8 bytes a word
// (each input word read once, each output word written once).  The TPU
// kernel carried the running total from one sequential grid step to the
// next in SMEM; CUDA blocks run in no order, so this is a single-pass
// decoupled look-back scan (Merrill & Garland, 2016):
// 1. A CTA takes its tile id from an atomic counter, so a tile never waits
//    on one that has not started.
// 2. It loads its 8192-word tile with 16-byte loads (warp-striped: each
//    load instruction of a warp covers 512 contiguous bytes) and scans it
//    in registers and with warp shuffles.  Tiles are laid on the 16-byte
//    grid of the input, so a tile that lies wholly inside the array takes
//    the vector path; the first and last tiles, and every tile when the
//    output's alignment differs from the input's, take a scalar path.
// 3. It publishes its aggregate, then its inclusive prefix, each as one
//    64-bit status word (kind in the high half, the value in the low half:
//    no fence is needed to pair them).  One warp looks back over the 32
//    predecessors at a time, adding aggregates until it meets a prefix.
// 4. It adds its exclusive prefix and writes the tile with 16-byte
//    streaming stores (evict-first: the output does not push the input
//    still to be read out of L2).
// The counter and the status words are zeroed by one memset of the
// scratch before each launch, a node of its own when the launch is
// captured into a CUDA graph, so a replay starts from zeros as an eager
// launch does (tagging the words with a host-chosen epoch timed the same,
// but a replay would reuse the captured epoch and read the last replay's
// prefixes).  Beyond the traffic, what holds it back is the look-back's
// wait (`ring_probe.py variants`; PERF.md).
#include <cuda/atomic>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 8;                         // uint4 loads a lane
constexpr int kWarpWords = 32 * 4 * kVecs;       // 1024
constexpr int kTile = kThreads / 32 * kWarpWords;  // 8192 words
constexpr unsigned kAggregate = 1, kPrefix = 2;  // status kinds
constexpr unsigned kFull = 0xffffffffu;

using Status = cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>;

__device__ __forceinline__ void publish(unsigned long long* s, unsigned kind,
                                        unsigned value) {
  const unsigned long long w = (static_cast<unsigned long long>(kind) << 32) | value;
  Status(*s).store(w, cuda::std::memory_order_relaxed);
}

// Inclusive warp scan.
__device__ __forceinline__ unsigned warp_scan(unsigned v, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += y;
  }
  return v;
}

// The sum of the tiles before ``tile``, by warp 0 of the CTA.
__device__ unsigned look_back(unsigned long long* status, long long tile,
                              int lane) {
  unsigned excl = 0;
  for (long long end = tile - 1;; end -= 32) {
    const long long i = end - lane;
    unsigned kind, val;
    do {  // every lane's predecessor has published at least its aggregate
      kind = kPrefix, val = 0;  // before tile 0: an empty prefix
      if (i >= 0) {
        const unsigned long long w =
            Status(status[i]).load(cuda::std::memory_order_relaxed);
        kind = static_cast<unsigned>(w >> 32);
        val = static_cast<unsigned>(w);
      }
    } while (__any_sync(kFull, kind == 0));
    const unsigned prefixes = __ballot_sync(kFull, kind == kPrefix);
    // the nearest predecessor with a prefix ends the walk
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    unsigned part = lane <= stop ? val : 0u;
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(kFull, part, o);
    excl += part;
    if (prefixes) return excl;
  }
}

// status[0]: the tile counter (low 32 bits); status[1 + t]: tile t's word;
// all zero at the launch.
__global__ void __launch_bounds__(kThreads)
    scan_kernel(const unsigned* __restrict__ x, unsigned* __restrict__ out,
                long long n, int head, bool vec,
                unsigned long long* __restrict__ status) {
  __shared__ unsigned warp_tot[kThreads / 32];
  __shared__ unsigned s_tile, s_prefix;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s_tile = atomicAdd(reinterpret_cast<unsigned*>(status), 1u);
  }
  __syncthreads();
  const long long tile = s_tile;
  unsigned long long* tiles = status + 1;
  // word e of the array is word e + head of the 16-byte grid
  const long long start = tile * kTile - head;
  const bool full = vec && start >= 0 && start + kTile <= n;
  const long long wbase = start + warp * kWarpWords + lane * 4;
  uint4 v[kVecs];
  if (full) {
#pragma unroll
    for (int j = 0; j < kVecs; ++j)
      v[j] = __ldcs(reinterpret_cast<const uint4*>(x + wbase + j * 128));
  } else {
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const long long e = wbase + j * 128;
      v[j].x = (e >= 0 && e < n) ? x[e] : 0u;
      v[j].y = (e + 1 >= 0 && e + 1 < n) ? x[e + 1] : 0u;
      v[j].z = (e + 2 >= 0 && e + 2 < n) ? x[e + 2] : 0u;
      v[j].w = (e + 3 >= 0 && e + 3 < n) ? x[e + 3] : 0u;
    }
  }
  // each lane's four words inclusive, then each vector row across the warp
  unsigned off[kVecs];
  unsigned carry = 0;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    v[j].y += v[j].x;
    v[j].z += v[j].y;
    v[j].w += v[j].z;
    const unsigned incl = warp_scan(v[j].w, lane);
    off[j] = carry + incl - v[j].w;
    carry += __shfl_sync(kFull, incl, 31);
  }
  if (lane == 0) warp_tot[warp] = carry;
  __syncthreads();
  unsigned before = 0, aggregate = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    const unsigned c = warp_tot[w];
    before += w < warp ? c : 0u;
    aggregate += c;
  }
  if (warp == 0) {
    unsigned excl = 0;
    if (tile == 0) {
      if (lane == 0) publish(&tiles[0], kPrefix, aggregate);
    } else {
      if (lane == 0) publish(&tiles[tile], kAggregate, aggregate);
      excl = look_back(tiles, tile, lane);
      if (lane == 0) publish(&tiles[tile], kPrefix, excl + aggregate);
    }
    if (lane == 0) s_prefix = excl;
  }
  __syncthreads();
  before += s_prefix;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const unsigned o = before + off[j];
    v[j].x += o, v[j].y += o, v[j].z += o, v[j].w += o;
  }
  if (full) {
#pragma unroll
    for (int j = 0; j < kVecs; ++j)
      __stcs(reinterpret_cast<uint4*>(out + wbase + j * 128), v[j]);
  } else {
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const long long e = wbase + j * 128;
      if (e >= 0 && e < n) out[e] = v[j].x;
      if (e + 1 >= 0 && e + 1 < n) out[e + 1] = v[j].y;
      if (e + 2 >= 0 && e + 2 < n) out[e + 2] = v[j].z;
      if (e + 3 >= 0 && e + 3 < n) out[e + 3] = v[j].w;
    }
  }
}

}  // namespace

// scratch: at least 1 + ceil((n + 3) / 8192) 8-byte words, no other
// launch's while this one runs; zeroed here before the launch.  n >= 1.
extern "C" int smf_cumsum_i32(const int* x, int* out, long long n,
                              unsigned long long* scratch, cudaStream_t stream) {
  const uintptr_t ax = reinterpret_cast<uintptr_t>(x);
  const bool vec = ((ax ^ reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int head = vec ? static_cast<int>((ax >> 2) & 3) : 0;
  const long long ntiles = (n + head + kTile - 1) / kTile;
  if (n < 1 || ntiles >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      cudaMemsetAsync(scratch, 0, (1 + ntiles) * sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_kernel<<<static_cast<unsigned>(ntiles), kThreads, 0, stream>>>(
      reinterpret_cast<const unsigned*>(x), reinterpret_cast<unsigned*>(out), n,
      head, vec, scratch);
  return static_cast<int>(cudaGetLastError());
}
