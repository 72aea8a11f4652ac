// K3: W-lane windows of the flat (col, value-bits) stream at any offset.
//
// Replaces the Pallas kernel sparse_matrix_with_flops_tpu/ops/pallas_sort.py
// `align_windows` (body `_align_kernel`) together with the two row takes
// around it in ops/ell_esc.py `_assemble_body.win_gather`.  For each
// query q: wr = clip(floor(p0[q] / W), 0, nr - 2), off = clip(p0[q] -
// wr * W, 0, W - 1), out[q, l] = src[wr * W + off + l] for l < W — the
// same clipping as the reference, so out-of-range starts give the same
// windows.
//
// What bounds it on the H100: device-memory bandwidth, 8 bytes an output
// lane written and about as many read (the windows of one assembly tile
// the source, overlapping where rows shift).  The TPU gathered two
// aligned windows and rolled them into place in VMEM; here a warp owns a
// window, so nothing is computed a lane:
// 1. Each warp walks the windows grid-stride, one at a time, and
//    computes a window's clipped start once (W = 128 is a template
//    parameter: the division is a shift).  Two or four windows a warp in
//    flight were no faster (ring_probe.py variants).
// 2. W = 128 (the main path), sources on the 16-byte grid: lane i reads
//    the aligned 16-byte vectors a + i of each stream, a = start / 4, and
//    lane 31 also vector a + 32 when the start is off the grid; each lane
//    takes its right neighbour's vector by a warp shuffle and selects its
//    4 lanes at the window's offset start % 4 (the same for the whole
//    warp: no divergence).  Every lane stores 16 bytes of each output
//    row, a warp 512 aligned bytes a stream.
// 3. Any other W, or a source off the 16-byte grid: the same walk with
//    4-byte loads and stores, lane l moving lanes l, l + 32, ... of the
//    window (each warp access 128 contiguous bytes).
// 4. One launch takes two lists of positions into the same source (the
//    assembly's output windows and its row heads) and writes the windows
//    of both into one [2, Q0 + Q1, W] output: the walk runs over both, a
//    window's index picking its list.  The heads alone take a few us on
//    the device against ~30 us of host enqueue (ring_probe.py launch), so
//    the second list saves a launch, not bytes.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

// The reference's clipped start wr * W + off of a window at p.
__device__ __forceinline__ long long clipped_start(int p, long long nr, int W) {
  const int fq = p / W - (p % W < 0 ? 1 : 0);  // floor(p / W)
  long long wr = fq < 0 ? 0 : fq;
  wr = wr > nr - 2 ? nr - 2 : wr;
  long long off = p - wr * W;
  off = off < 0 ? 0 : (off > W - 1 ? W - 1 : off);
  return wr * W + off;
}

__device__ __forceinline__ int4 shfl_down4(int4 v) {
  v.x = __shfl_down_sync(kFull, v.x, 1);
  v.y = __shfl_down_sync(kFull, v.y, 1);
  v.z = __shfl_down_sync(kFull, v.z, 1);
  v.w = __shfl_down_sync(kFull, v.w, 1);
  return v;
}

// The 4 words at word r of the 8 words (a, b).
__device__ __forceinline__ int4 realign(int4 a, int4 b, int r) {
  switch (r) {
    case 0: return a;
    case 1: return make_int4(a.y, a.z, a.w, b.x);
    case 2: return make_int4(a.z, a.w, b.x, b.y);
    default: return make_int4(a.w, b.x, b.y, b.z);
  }
}

// The position of window q of the two lists: p0[q] for q < Q0, else
// p1[q - Q0].  The outputs hold the windows of both lists in this order.
__device__ __forceinline__ int position(const int* p0, long long Q0, const int* p1,
                                        long long q) {
  return q < Q0 ? p0[q] : p1[q - Q0];
}

// W = 32 * 4 lanes: one 16-byte vector a lane and stream.
template <int W>
__global__ void __launch_bounds__(kThreads)
    window_vec_kernel(const int4* __restrict__ src_c, const int4* __restrict__ src_v,
                      const int* __restrict__ p0, long long Q0, const int* __restrict__ p1,
                      long long Q, int4* __restrict__ out_c, int4* __restrict__ out_v,
                      long long nr) {
  static_assert(W == 128, "one 16-byte vector a lane");
  const int lane = threadIdx.x & 31;
  const long long warp = (blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x) >> 5;
  const long long step = static_cast<long long>(gridDim.x) * kWarps;
  for (long long q = warp; q < Q; q += step) {
    const long long s = clipped_start(position(p0, Q0, p1, q), nr, W);
    const int r = static_cast<int>(s & 3);
    const long long a = (s >> 2) + lane;
    const int4 c = src_c[a], v = src_v[a];
    int4 cn = c, vn = v;
    // the clip keeps start + W <= nr * W - 1, so vector a + 32 lies
    // inside the source whenever the start is off the grid
    if (lane == 31 && r) cn = src_c[a + 1], vn = src_v[a + 1];
    int4 nc = shfl_down4(c), nv = shfl_down4(v);
    if (lane == 31) nc = cn, nv = vn;
    const long long o = q * (W / 4) + lane;
    out_c[o] = realign(c, nc, r);
    out_v[o] = realign(v, nv, r);
  }
}

// Any W >= 1, any alignment.
__global__ void __launch_bounds__(kThreads)
    window_any_kernel(const int* __restrict__ src_c, const int* __restrict__ src_v,
                      const int* __restrict__ p0, long long Q0, const int* __restrict__ p1,
                      long long Q, int* __restrict__ out_c, int* __restrict__ out_v,
                      long long nr, int W) {
  const int lane = threadIdx.x & 31;
  const long long warp = (blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x) >> 5;
  const long long step = static_cast<long long>(gridDim.x) * kWarps;
  for (long long q = warp; q < Q; q += step) {
    const long long s = clipped_start(position(p0, Q0, p1, q), nr, W);
    const int* sc = src_c + s;
    const int* sv = src_v + s;
    int* oc = out_c + q * W;
    int* ov = out_v + q * W;
#pragma unroll 4
    for (int l = lane; l < W; l += 32) {
      oc[l] = sc[l];
      ov[l] = sv[l];
    }
  }
}

// CTAs of ``kernel`` resident on the current device at once (cached).
template <typename K>
cudaError_t resident_ctas(K kernel, int slot, int& out) {
  static int cache[2][kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[slot][dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cache[slot][dev] = per_sm * sms;
  }
  out = cache[slot][dev];
  return cudaSuccess;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// src_c / src_v hold nr * W int32 each (nr >= 2).  Two lists of window
// positions in one launch, p0 (Q0 int32) then p1 (Q1; Q1 = 0: one list,
// p1 not read); ``out`` is [2, Q0 + Q1, W] int32: the cols, then the
// value bits, of every window of p0 and then of p1.  Returns the
// cudaError_t of the launch.
extern "C" int smf_window_gather(const int* src_c, const int* src_v, const int* p0,
                                 long long Q0, const int* p1, long long Q1, int* out,
                                 long long nr, int W, cudaStream_t stream) {
  const long long Q = Q0 + Q1;
  if (Q0 < 0 || Q1 < 0 || Q < 1 || nr < 2 || W < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int* out_v = out + Q * W;
  const bool vec = W == 128 && aligned16(src_c) && aligned16(src_v) && aligned16(out);
  int resident = 0;
  const cudaError_t err = vec ? resident_ctas(window_vec_kernel<128>, 0, resident)
                              : resident_ctas(window_any_kernel, 1, resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (Q + kWarps - 1) / kWarps;
  const unsigned grid = static_cast<unsigned>(want < resident ? want : resident);
  if (vec) {
    window_vec_kernel<128><<<grid, kThreads, 0, stream>>>(
        reinterpret_cast<const int4*>(src_c), reinterpret_cast<const int4*>(src_v), p0, Q0,
        p1, Q, reinterpret_cast<int4*>(out), reinterpret_cast<int4*>(out_v), nr);
  } else {
    window_any_kernel<<<grid, kThreads, 0, stream>>>(src_c, src_v, p0, Q0, p1, Q, out, out_v,
                                                      nr, W);
  }
  return static_cast<int>(cudaGetLastError());
}
