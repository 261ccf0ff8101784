// Device guard for the kernels' C entry points.
//
// Each entry point is given the index of the device its tensors lie on and
// launches there.  The guard asks the runtime for the current device and
// switches only when it differs, restoring it on the way out, so the usual
// case (one card, or the caller already on the right one) costs one
// cudaGetDevice and the Python wrapper needs no context manager.

#pragma once

#include <cuda_runtime.h>

namespace {

struct DeviceGuard {
  int prev = -1;
  bool switched = false;
  cudaError_t err;

  explicit DeviceGuard(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) {
      err = cudaSetDevice(device);
      switched = (err == cudaSuccess);
    }
  }
  ~DeviceGuard() {
    if (switched) cudaSetDevice(prev);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
};

}  // namespace
