// What the sources in csrc/ share: the device rule of every C launcher,
// and the asynchronous 16-byte copies from device to shared memory.
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

// Start copying 16 bytes from `gmem` to `smem` (both 16-byte aligned),
// bypassing L1; `valid` false writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n)
               : "memory");
}

// Start copying the first `bytes` (0 to 16) of the 16 bytes at `gmem` to
// `smem` (both 16-byte aligned), bypassing L1; the rest of the 16 bytes at
// `smem` are written zero, and nothing past `bytes` is read.
__device__ __forceinline__ void cp_async16_part(void* smem, const void* gmem, int bytes) {
  unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(bytes)
               : "memory");
}

// Close the calling thread's copies started since the last commit into
// one group (an empty group when there were none).
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `Pending` of the calling thread's groups are still
// in flight. The copies are then visible to this thread; other threads
// see them after a barrier.
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}
