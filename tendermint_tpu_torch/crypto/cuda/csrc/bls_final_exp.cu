// K7b: the pair-axis product and the final exponentiation of every item of
// a pairing batch, in one launch. Replaces tendermint_tpu/crypto/tpu/
// bls_pairing.py _build_kernel's product tree, final exponentiation and
// output (:148-164): per item, f = prod over pairs of the lanes' Miller
// values (K7a's output, canonical (m, npairs, 6, 2, 49) limbs), then
//   easy part  f1 = conj(f) * f^-1, f2 = frob2(f1) * f1,
//   hard part  f2^((p^4 - p^2 + 1) / r) by square-and-multiply over the
//              exponent's bits after the leading one (`hard_bits`),
// and writes ok[item] = (result == 1) and the result as canonical
// (m, 6, 2, 49) limbs.
//
// The inverse goes through the norm (bls_math.f12_inv's shape): the five
// Frobenius^2 conjugates' product g, n = f g in Fq2, and one Fp inverse of
// n0^2 + n1^2 by Fermat in one thread.
//
// Design: one block of 144 threads per item, each Fq12 product as 144 Fp
// products in parallel (bls12_381.cuh). What bounds it is latency, not the
// card's rate: an item is one serial chain of npairs - 1 + 12 + 1,900 Fq12
// products and 608 Fp products of the inverse, and the aggregate path runs
// 2 items (2 of the card's 132 SMs).
#include "bls12_381.cuh"
#include "launch.cuh"

namespace {

constexpr int kChunk = 12;  // lanes converted per round: 12 x 12 Fp = one per thread

struct FinalSmem {
  bls::Fp lanes[kChunk][bls::kF12];
  bls::Fp f[bls::kF12], conj[bls::kF12], g[bls::kF12], inv[bls::kF12], f1[bls::kF12];
  bls::Fp f2[bls::kF12], acc[bls::kF12];
  bls::F12Scratch scratch;
  int one[bls::kF12];
};

// r = a^(p^2), 12 threads; callers synchronize
__device__ __forceinline__ void frob2_part(bls::Fp* r, const bls::Fp* a) {
  const int t = threadIdx.x;
  if (t < bls::kF12) bls::fp_mul(r[t], a[t], bls::kFrob2[t >> 1]);
}

__global__ void __launch_bounds__(bls::kThreads)
bls_final_exp_kernel(const int* __restrict__ f_in, const int* __restrict__ hard_bits,
                     unsigned char* __restrict__ ok, int* __restrict__ out, long long npairs,
                     int n_hard) {
  __shared__ FinalSmem sh;
  const long long item = blockIdx.x;
  const int t = threadIdx.x;
  const int* src = f_in + item * npairs * bls::kF12 * bls::kLimbs;

  // f = product of the item's lanes, converted kChunk lanes at a time
  for (long long base = 0; base < npairs; base += kChunk) {
    const long long lane = base + t / bls::kF12;
    if (t < kChunk * bls::kF12 && lane < npairs)
      bls::fp_from_limbs(sh.lanes[t / bls::kF12][t % bls::kF12],
                         src + (lane * bls::kF12 + t % bls::kF12) * bls::kLimbs);
    __syncthreads();
    for (int l = 0; l < kChunk && base + l < npairs; ++l) {
      if (base + l == 0) {
        bls::f12_copy_part(sh.f, sh.lanes[0]);
        __syncthreads();
      } else {
        bls::f12_mul(sh.f, sh.f, sh.lanes[l], sh.scratch);
      }
    }
  }

  // easy part: f^-1 through the norm
  if (t < bls::kF12) {
    if ((t >> 1) & 1)
      bls::fp_neg(sh.conj[t], sh.f[t]);
    else
      bls::fp_copy(sh.conj[t], sh.f[t]);
  }
  frob2_part(sh.g, sh.f);
  __syncthreads();
  bls::f12_copy_part(sh.inv, sh.g);  // inv holds the running product of conjugates
  __syncthreads();
  for (int k = 0; k < 4; ++k) {
    frob2_part(sh.g, sh.g);
    __syncthreads();
    bls::f12_mul(sh.inv, sh.inv, sh.g, sh.scratch);
  }
  bls::f12_mul(sh.g, sh.f, sh.inv, sh.scratch);  // the norm n = g[0] + g[1] u
  if (t == 0) {
    uint32_t n0[bls::kW], n1[bls::kW], d[bls::kW];
    bls::fp_mul(n0, sh.g[0], sh.g[0]);
    bls::fp_mul(n1, sh.g[1], sh.g[1]);
    bls::fp_add(d, n0, n1);
    bls::fp_inv(d, d);
    bls::fp_mul(n0, sh.g[0], d);
    bls::fp_mul(n1, sh.g[1], d);
    bls::fp_neg(n1, n1);
    bls::fp_copy(sh.g[0], n0);  // g = n^-1 = (n0 - n1 u) / (n0^2 + n1^2), as an Fq12
    bls::fp_copy(sh.g[1], n1);
  } else if (t >= 2 && t < bls::kF12) {  // g[1] is thread 0's until it is written
    bls::fp_zero(sh.g[t]);
  }
  __syncthreads();
  bls::f12_mul(sh.inv, sh.inv, sh.g, sh.scratch);   // f^-1
  bls::f12_mul(sh.f1, sh.conj, sh.inv, sh.scratch);  // f^(p^6 - 1)
  frob2_part(sh.g, sh.f1);
  __syncthreads();
  bls::f12_mul(sh.f2, sh.g, sh.f1, sh.scratch);  // f^((p^6 - 1)(p^2 + 1))

  // hard part
  bls::f12_copy_part(sh.acc, sh.f2);
  __syncthreads();
  for (int i = 0; i < n_hard; ++i) {
    bls::f12_mul(sh.acc, sh.acc, sh.acc, sh.scratch);
    if (hard_bits[i]) bls::f12_mul(sh.acc, sh.acc, sh.f2, sh.scratch);
  }

  bls::f12_store_part(out + item * bls::kF12 * bls::kLimbs, sh.acc, /*conj=*/false);
  if (t < bls::kF12) {
    uint32_t want[bls::kW];
    if (t == 0)
      bls::fp_copy(want, bls::kOne);
    else
      bls::fp_zero(want);
    sh.one[t] = bls::fp_equal(sh.acc[t], want);
  }
  __syncthreads();
  if (t == 0) {
    int all = 1;
    for (int i = 0; i < bls::kF12; ++i) all &= sh.one[i];
    ok[item] = (unsigned char)all;
  }
}

}  // namespace

extern "C" int bls_final_exp_launch(const void* f_in, const void* hard_bits, void* ok, void* out,
                                    long long m, long long npairs, int n_hard, int device,
                                    void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  bls_final_exp_kernel<<<(unsigned)m, bls::kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)f_in, (const int*)hard_bits, (unsigned char*)ok, (int*)out, npairs, n_hard);
  return (int)cudaGetLastError();
}
