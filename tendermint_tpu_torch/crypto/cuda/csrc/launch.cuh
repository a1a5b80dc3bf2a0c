// What every C launcher in csrc/ shares.
#pragma once

#include <cuda_runtime.h>

// Make `device` current for the calling host thread, calling
// cudaSetDevice only when another device is current (a launch on the
// current device, the common case, pays one cudaGetDevice).
static inline cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  return current == device ? cudaSuccess : cudaSetDevice(device);
}
