// Runtime helpers shared by the port's CUDA entry points.

#include <cuda_runtime.h>

namespace {

__global__ void noop_kernel() {}

}  // namespace

// The message for an error code that an entry point returned.
extern "C" const char* mxtpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// An empty kernel of one warp, launched on `stream` the way every entry
// point launches its kernel: what a launch alone costs on this card, the
// floor under a kernel whose work is a few microseconds or less.
extern "C" int mxtpu_noop(int device, void* stream_ptr) {
  int current = -1;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream_ptr)>>>();
  return (int)cudaGetLastError();
}
