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
// What bounds it on the H100: device-memory bandwidth; each output lane
// is one load of each stream and one store.  Design: the TPU had to
// gather two aligned windows and roll them into place in VMEM; on the
// GPU an unaligned load costs nothing extra, so one thread per output
// lane reads its source lane directly (neighbouring threads read
// neighbouring addresses) and the [Q, 4W] intermediate is never built.
#include <cuda_runtime.h>

namespace {

__global__ void window_gather_kernel(const int* __restrict__ src_c,
                                     const int* __restrict__ src_v,
                                     const int* __restrict__ p0,
                                     int* __restrict__ out_c,
                                     int* __restrict__ out_v, long long Q,
                                     long long nr, int W) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= Q * W) return;
  const long long q = i / W;
  const long long l = i - q * W;
  const long long p = p0[q];
  long long wr = p >= 0 ? p / W : -((-p + W - 1) / W);
  wr = wr < 0 ? 0 : (wr > nr - 2 ? nr - 2 : wr);
  long long off = p - wr * W;
  off = off < 0 ? 0 : (off > W - 1 ? W - 1 : off);
  const long long s = wr * W + off + l;
  out_c[i] = src_c[s];
  out_v[i] = src_v[s];
}

}  // namespace

// src_c / src_v hold nr * W int32 each (nr >= 2); p0 holds Q int32.
extern "C" int smf_window_gather(const int* src_c, const int* src_v,
                                 const int* p0, int* out_c, int* out_v,
                                 long long Q, long long nr, int W,
                                 cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (Q * W + threads - 1) / threads;
  window_gather_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         stream>>>(src_c, src_v, p0, out_c, out_v, Q, nr,
                                   W);
  return static_cast<int>(cudaGetLastError());
}
