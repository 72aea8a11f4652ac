// CUDA IPC for the peer buffers of the ring kernels launched one rank a
// process (parallel/peer.py).  A rank allocates its landing buffers and
// flags with cudaMalloc (a handle of a caching allocator's block would
// name the allocator's whole segment), zeroes them once, exports one
// handle, and maps each other rank's allocation from that rank's handle.
// A process cannot open a handle it exported: it uses its own pointer.
#include <cuda_runtime.h>

#include <cstring>

// The bytes of a cudaIpcMemHandle_t.
extern "C" int smf_peer_handle_bytes(int* bytes) {
  *bytes = static_cast<int>(sizeof(cudaIpcMemHandle_t));
  return 0;
}

// ``bytes`` of zeroed device memory on the current device at *ptr, and its
// IPC handle written to ``handle``.
extern "C" int smf_peer_alloc(long long bytes, void** ptr, void* handle) {
  cudaError_t err = cudaMalloc(ptr, static_cast<size_t>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemset(*ptr, 0, static_cast<size_t>(bytes));
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  cudaIpcMemHandle_t h;
  if (err == cudaSuccess) err = cudaIpcGetMemHandle(&h, *ptr);
  if (err != cudaSuccess) {
    cudaFree(*ptr);
    *ptr = nullptr;
    return static_cast<int>(err);
  }
  std::memcpy(handle, &h, sizeof(h));
  return 0;
}

// Map another process's allocation from its handle.
extern "C" int smf_peer_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof(h));
  return static_cast<int>(
      cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

extern "C" int smf_peer_close(void* ptr) {
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}

extern "C" int smf_peer_free(void* ptr) { return static_cast<int>(cudaFree(ptr)); }
