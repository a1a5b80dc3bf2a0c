// B2: z^(2^252 - 3) over (M, 32) int32 limbs, the whole addition chain
// (251 squarings and 11 multiplies) in one launch. Replaces
// tendermint_tpu/crypto/tpu/pallas_field.py _pow22523_limbs_first
// (_pow22523_kernel).
//
// Bound on an H100 by operations, not bytes: 262 multiplies per 256 bytes
// moved. The chain runs on fe25519_group.cuh's shuffle-free multiply,
// four lanes per element (33,788 threads for the main path's 8,447
// elements, two warps on each of the card's 528 schedulers); device
// memory is touched twice per element (load z, store the result), and
// z, t0, t1, t2 stay in registers.
#include "fe25519_group.cuh"
#include "launch.cuh"

namespace {

constexpr int kElems = 32;  // elements per block
constexpr int kThreads = kElems * feg::kLanes;

__device__ __forceinline__ feg::Fe sqn(const feg::Group& g, feg::Fe x, int k) {
#pragma unroll 1
  for (int i = 0; i < k; ++i) x = feg::sqr(g, x);
  return x;
}

__global__ void __launch_bounds__(kThreads)
fe_pow22523_kernel(const int* __restrict__ zin, int* __restrict__ out, long long m) {
  __shared__ __align__(16) int sh[kElems * feg::kGroupWords];
  const int el = threadIdx.x / feg::kLanes, q = threadIdx.x % feg::kLanes;
  const long long e = (long long)blockIdx.x * kElems + el;
  const feg::Group g = feg::make_group(sh + el * feg::kGroupWords, q);
  // past the end: compute on element 0 alongside the group, store nothing
  const feg::Fe z = feg::load(zin + (e < m ? e : 0) * feg::kLimbs, q);
  using feg::mul;
  feg::Fe t0 = sqn(g, z, 1);    // 2
  feg::Fe t1 = sqn(g, t0, 2);   // 8
  t1 = mul(g, z, t1);           // 9
  t0 = mul(g, t0, t1);          // 11
  t0 = sqn(g, t0, 1);           // 22
  t0 = mul(g, t1, t0);          // 31 = 2^5 - 1
  t1 = sqn(g, t0, 5);
  t0 = mul(g, t1, t0);          // 2^10 - 1
  t1 = sqn(g, t0, 10);
  t1 = mul(g, t1, t0);          // 2^20 - 1
  feg::Fe t2 = sqn(g, t1, 20);
  t1 = mul(g, t2, t1);          // 2^40 - 1
  t1 = sqn(g, t1, 10);
  t0 = mul(g, t1, t0);          // 2^50 - 1
  t1 = sqn(g, t0, 50);
  t1 = mul(g, t1, t0);          // 2^100 - 1
  t2 = sqn(g, t1, 100);
  t1 = mul(g, t2, t1);          // 2^200 - 1
  t1 = sqn(g, t1, 50);
  t0 = mul(g, t1, t0);          // 2^250 - 1
  t0 = sqn(g, t0, 2);           // 2^252 - 4
  t0 = mul(g, t0, z);           // 2^252 - 3
  if (e < m) feg::store(out + e * feg::kLimbs, t0, q);
}

}  // namespace

extern "C" int fe_pow22523_launch(const void* z, void* out, long long m, int device,
                                  void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  unsigned blocks = (unsigned)((m + kElems - 1) / kElems);
  fe_pow22523_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>((const int*)z, (int*)out,
                                                                    m);
  return (int)cudaGetLastError();
}
