// B1: batched GF(2^255 - 19) multiply, (M, 32) x (M, 32) -> (M, 32) int32.
// Replaces tendermint_tpu/crypto/tpu/pallas_field.py _mul_limbs_first
// (_mul_kernel -> _conv_mod).
//
// Bound on an H100 by bytes: 384 bytes per element (two operands in, one
// result out) for one multiply. So the kernel moves them at full width: a
// block stages its tile of 32 elements of each operand into shared memory
// with 16-byte cp.async, neighbouring threads on neighbouring addresses,
// into rows padded to 36 words so that the lanes reading their own rows
// do not collide on banks. The multiply itself is fe25519_group.cuh's,
// with no shuffles. The result goes back through the same rows and out
// with 16-byte coalesced stores.
//
// An operand with row step 0 is one element broadcast against every row
// (a field constant), read in place instead of copied M times.
#include "fe25519_group.cuh"
#include "launch.cuh"

namespace {

constexpr int kElems = 32;                 // elements per block
constexpr int kThreads = kElems * feg::kLanes;
constexpr int kChunks = feg::kLimbs / 4;   // 16-byte chunks per element

__global__ void __launch_bounds__(kThreads)
fe_mul_kernel(const int* __restrict__ a, int a_step, const int* __restrict__ b, int b_step,
              int* __restrict__ out, long long m) {
  __shared__ __align__(16) int ta[kElems * feg::kRow];
  __shared__ __align__(16) int tb[kElems * feg::kRow];
  __shared__ __align__(16) int sh[kElems * feg::kGroupWords];
  const long long e0 = (long long)blockIdx.x * kElems;

  for (int c = threadIdx.x; c < kElems * kChunks; c += kThreads) {
    const int el = c / kChunks, part = c % kChunks;
    const bool valid = e0 + el < m;
    const long long row = valid ? e0 + el : 0;
    cp_async16(&ta[el * feg::kRow + 4 * part], a + row * a_step + 4 * part, valid);
    cp_async16(&tb[el * feg::kRow + 4 * part], b + row * b_step + 4 * part, valid);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int el = threadIdx.x / feg::kLanes, q = threadIdx.x % feg::kLanes;
  const feg::Group g = feg::make_group(sh + el * feg::kGroupWords, q);
  const feg::Fe r =
      feg::mul(g, feg::load(&ta[el * feg::kRow], q), feg::load(&tb[el * feg::kRow], q));
  // each lane read, and now overwrites, only its own limbs of the row
  feg::store(&ta[el * feg::kRow], r, q);
  __syncthreads();

  for (int c = threadIdx.x; c < kElems * kChunks; c += kThreads) {
    const int el = c / kChunks, part = c % kChunks;
    if (e0 + el < m) {
      *reinterpret_cast<int4*>(out + (e0 + el) * feg::kLimbs + 4 * part) =
          *reinterpret_cast<const int4*>(&ta[el * feg::kRow + 4 * part]);
    }
  }
}

}  // namespace

// a_step, b_step: ints from one element to the next (32, or 0 for one
// element broadcast to every row).
extern "C" int fe_mul_launch(const void* a, int a_step, const void* b, int b_step, void* out,
                             long long m, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  unsigned blocks = (unsigned)((m + kElems - 1) / kElems);
  fe_mul_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)a, a_step, (const int*)b, b_step, (int*)out, m);
  return (int)cudaGetLastError();
}
