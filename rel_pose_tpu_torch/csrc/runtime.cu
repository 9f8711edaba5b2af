// Runtime helpers for the ctypes wrappers: pick the device the next launch
// runs on, and turn an error code into its message.

#include <cuda_runtime.h>

extern "C" int rp_set_device(int device) { return cudaSetDevice(device); }

extern "C" const char* rp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
