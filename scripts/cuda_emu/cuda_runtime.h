// Stand-in for the CUDA runtime header, so that g++ compiles the kernels of
// tendermint_tpu_torch/crypto/cuda/csrc/ for the CPU (see run.py): a block's
// threads are std::threads, std::barriers stand in for __syncwarp and
// __syncthreads, and shared memory is function-static, blocks running one
// after another.
#pragma once
#include <atomic>
#include <barrier>
#include <chrono>
#include <cmath>
#include <cstring>
#include <cstdint>
#include <functional>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __constant__
#define __launch_bounds__(...)
#define __restrict__ __restrict
#define __align__(n) __attribute__((aligned(n)))
#define __shared__ static
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0;
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaSetDevice(int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
struct dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3 threadIdx, blockIdx;
inline thread_local std::barrier<>* emu_warp_bar;
inline thread_local std::barrier<>* emu_block_bar;
inline void __syncwarp() { emu_warp_bar->arrive_and_wait(); }
inline void __syncthreads() { emu_block_bar->arrive_and_wait(); }
inline thread_local std::atomic<int>* emu_block_or;
// a launch's dynamic shared memory (`extern __shared__`, rewritten by run.py)
inline thread_local void* emu_dynamic_smem;
// three barrier phases, so that the flag is cleared before any thread can
// reach the next call's first store
inline int __syncthreads_or(int pred) {
  __syncthreads();
  if (pred) emu_block_or->store(1);
  __syncthreads();
  const int any = emu_block_or->load();
  __syncthreads();
  if (threadIdx.x == 0) emu_block_or->store(0);
  return any;
}
inline int __ffs(int x) { return __builtin_ffs(x); }
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) int4 { int x, y, z, w; };
struct alignas(8) int2 { int x, y; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
using std::min;
// the funnel shift right of the 64-bit hi:lo by n mod 32, low word kept
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, int n) {
  const unsigned s = (unsigned)n & 31u;
  return s ? (lo >> s) | (hi << (32 - s)) : lo;
}
// PRMT: byte i of the result is the byte of y:x (x the low four) that
// nibble i of s selects, its sign bit replicated when the nibble's bit 3 is set
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const uint64_t v = ((uint64_t)y << 32) | x;
  unsigned r = 0;
  for (int i = 0; i < 4; ++i) {
    const unsigned nib = (s >> (4 * i)) & 15u;
    unsigned b = (unsigned)(v >> (8 * (nib & 7u))) & 0xFFu;
    if (nib & 8u) b = (b & 0x80u) ? 0xFFu : 0u;
    r |= b << (8 * i);
  }
  return r;
}
// the SM's cycle counter: the host's steady clock in nanoseconds
inline long long clock64() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch()).count();
}
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
inline float __int_as_float(int v) { float f; std::memcpy(&f, &v, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned v; std::memcpy(&v, &f, 4); return v; }
inline int __float_as_int(float f) { int v; std::memcpy(&v, &f, 4); return v; }

inline void emu_launch(unsigned blocks, unsigned threads, int smem, void*, std::function<void()> body) {
  for (unsigned b = 0; b < blocks; ++b) {
    std::vector<uint4> dynamic((smem + 15) / 16);
    std::barrier<> block_bar(threads);
    std::atomic<int> block_or{0};
    std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
    for (unsigned w = 0; w < (threads + 31) / 32; ++w)
      warp_bars.emplace_back(new std::barrier<>(std::min(32u, threads - 32 * w)));
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < threads; ++t) {
      ts.emplace_back([&, t, b] {
        threadIdx.x = t;
        blockIdx.x = b;
        emu_warp_bar = warp_bars[t / 32].get();
        emu_block_bar = &block_bar;
        emu_block_or = &block_or;
        emu_dynamic_smem = dynamic.data();
        body();
      });
    }
    for (auto& t : ts) t.join();
  }
}
