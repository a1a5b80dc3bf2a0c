// Latency of the BLS12-381 header's primitives (csrc/bls12_381.cuh), each
// in a loop of dependent calls in one block, timed with clock64 on the card.
// Built and run by run.py.
#include "bls12_381.cuh"
using namespace bls;

__global__ void lat_fpmul(uint32_t* io, long long* cyc, int n) {
  uint32_t x[kN], y[kN];
  for (int i = 0; i < kN; ++i) {
    x[i] = io[i] & kMask;
    y[i] = io[kN + i] & kMask;
  }
  const long long t0 = clock64();
  for (int k = 0; k < n; ++k) fp_mul(x, x, y);
  const long long t1 = clock64();
  for (int i = 0; i < kN; ++i) io[i] = x[i];
  cyc[0] = t1 - t0;
}

// a Wide sum of `terms` + 1 terms and its reduction
__global__ void lat_wide(uint32_t* io, long long* cyc, int n, int terms) {
  uint32_t x[kN];
  for (int i = 0; i < kN; ++i) x[i] = io[i] & 0xffffff;
  const long long t0 = clock64();
  for (int k = 0; k < n; ++k) {
    Wide w;
    wide_init(w, 24);
    for (int j = 0; j < terms; ++j) wide_madd(w, x, (j % 5) - 2);
    wide_madd(w, x, 3);
    wide_reduce(x, w);
  }
  const long long t1 = clock64();
  for (int i = 0; i < kN; ++i) io[i] = x[i];
  cyc[0] = t1 - t0;
}

__global__ void lat_inv(uint32_t* io, long long* cyc, int n) {
  uint32_t x[kN];
  for (int i = 0; i < kN; ++i) x[i] = io[i] & 0xffffff;
  const long long t0 = clock64();
  for (int k = 0; k < n; ++k) fp_inv(x, x);
  const long long t1 = clock64();
  for (int i = 0; i < kN; ++i) io[i] = x[i];
  cyc[0] = t1 - t0;
}

__global__ void lat_sync(long long* cyc, int n) {
  __shared__ int s[512];
  int v = threadIdx.x;
  const long long t0 = clock64();
  for (int k = 0; k < n; ++k) {
    s[threadIdx.x] = v;
    __syncthreads();
    v += s[(threadIdx.x + 1) % blockDim.x];
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) {
    cyc[0] = t1 - t0;
    cyc[1] = v;
  }
}

struct OpSmem {
  Fp f[kF12], g[kF12];
  F12Scratch s;
};

__device__ void load_f12(Fp* f, const uint32_t* io) {
  if (threadIdx.x < kF12)
    for (int i = 0; i < kN; ++i) f[threadIdx.x][i] = io[threadIdx.x * kN + i] & 0xffffff;
  __syncthreads();
}

// op: 0 f12_mul, 1 f12_cyclotomic_sqr, 2 f12_sqr, 3 f12_mul_line, 4 f12_frob,
// 5 f12_frob2, 6 f12_conj
__global__ void lat_op(uint32_t* io, long long* cyc, int n, int op) {
  __shared__ OpSmem sh;
  load_f12(sh.f, io);
  load_f12(sh.g, io + kF12 * kN);
  const int lt = threadIdx.x;
  const long long t0 = clock64();
  for (int k = 0; k < n; ++k) {
    switch (op) {
      case 0: f12_mul(sh.f, sh.f, sh.g, sh.s, lt); break;
      case 1: f12_cyclotomic_sqr(sh.f, sh.f, sh.s, lt); break;
      case 2: f12_sqr(sh.f, sh.f, sh.s, lt); break;
      case 3: f12_mul_line(sh.f, sh.f, sh.g[0], sh.g + 2, sh.s, lt); break;
      case 4: f12_frob(sh.f, sh.f, sh.s, lt); break;
      case 5: f12_frob2(sh.f, sh.f, lt); break;
      default: f12_conj(sh.f, sh.f, lt); break;
    }
  }
  const long long t1 = clock64();
  if (threadIdx.x < kF12)
    for (int i = 0; i < kN; ++i) io[threadIdx.x * kN + i] = sh.f[threadIdx.x][i];
  if (threadIdx.x == 0) cyc[0] = t1 - t0;
}

extern "C" int run(int which, void* io, void* cyc, int n, int arg, int threads) {
  switch (which) {
    case 0: lat_fpmul<<<1, 1>>>((uint32_t*)io, (long long*)cyc, n); break;
    case 1: lat_wide<<<1, 1>>>((uint32_t*)io, (long long*)cyc, n, arg); break;
    case 2: lat_inv<<<1, 1>>>((uint32_t*)io, (long long*)cyc, n); break;
    case 3: lat_sync<<<1, threads>>>((long long*)cyc, n); break;
    default: lat_op<<<1, threads>>>((uint32_t*)io, (long long*)cyc, n, arg); break;
  }
  cudaDeviceSynchronize();
  return (int)cudaGetLastError();
}
