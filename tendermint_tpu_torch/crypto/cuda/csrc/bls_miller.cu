// K7a: the BLS12-381 Miller loop of every (item, pair) lane of a pairing
// batch, all 63 steps in one launch. Replaces the Miller scan of
// tendermint_tpu/crypto/tpu/bls_pairing.py _build_kernel (:139-147) and its
// final conjugation: per lane, f <- f^2 * l_dbl(P), times l_add(P) on the 5
// steps whose bit of |x| is set, then f^(p^6); written as canonical
// (m, npairs, 6, 2, 49) limbs so that it can be held against
// crypto/bls_math.py miller_loop and the plain version.
//
// Inputs are the host's prepared lines (bls_pairing.prepare_pairing_batch):
// px, py (lanes, 49), and dbl_a5, dbl_c3, add_a5, add_c3 (63, lanes, 2, 49),
// canonical limbs; the line through step s evaluates at P to
// py w^0 + c3 w^3 + (a5 px) w^5. A pad lane (py = 1, zero lines) stays at 1.
//
// Design: one block of 144 threads per lane. The block converts the lane's
// 68 lines to Montgomery form and scales a5 by px up front (shared memory),
// then runs the 131 Fq12 products of the loop one after another, each as
// 144 Fp products in parallel (bls12_381.cuh f12_mul). Bound on an H100 by
// operations (131 x 144 Montgomery products per lane, 4.4 MB of lines read
// for 512 lanes); at the aggregate path's 512 lanes the card holds every
// block at once, so the launch takes one lane's serial chain of 131
// products.
#include "bls12_381.cuh"
#include "launch.cuh"

namespace {

constexpr int kSteps = 63;

struct MillerSmem {
  // per step and kind (0 doubling, 1 addition): c3 (re, im), a5 * px (re, im)
  bls::Fp lines[kSteps][2][4];
  bls::Fp px, py;
  bls::Fp f[bls::kF12];
  bls::Fp line[bls::kF12];
  bls::F12Scratch scratch;
};

__global__ void __launch_bounds__(bls::kThreads)
bls_miller_kernel(const int* __restrict__ px, const int* __restrict__ py,
                  const int* __restrict__ dbl_a5, const int* __restrict__ dbl_c3,
                  const int* __restrict__ add_a5, const int* __restrict__ add_c3,
                  const int* __restrict__ x_bits, int* __restrict__ out, long long lanes) {
  __shared__ MillerSmem sh;
  const long long lane = blockIdx.x;
  const int t = threadIdx.x;
  const long long step_stride = lanes * 2 * bls::kLimbs;
  const long long lane_off = lane * 2 * bls::kLimbs;

  // the evaluation point and the lines' c3 and a5, to Montgomery form
  if (t == 0) bls::fp_from_limbs(sh.px, px + lane * bls::kLimbs);
  if (t == 1) bls::fp_from_limbs(sh.py, py + lane * bls::kLimbs);
  for (int w = t; w < kSteps * 2 * 4; w += bls::kThreads) {
    const int s = w >> 3, kind = (w >> 2) & 1, part = w & 3, comp = part & 1;
    if (kind && !x_bits[s]) continue;
    const int* src = part < 2 ? (kind ? add_c3 : dbl_c3) : (kind ? add_a5 : dbl_a5);
    bls::fp_from_limbs(sh.lines[s][kind][part], src + s * step_stride + lane_off + comp * bls::kLimbs);
  }
  bls::f12_one_part(sh.f);
  __syncthreads();
  for (int w = t; w < kSteps * 2 * 2; w += bls::kThreads) {
    const int s = w >> 2, kind = (w >> 1) & 1, comp = w & 1;
    if (kind && !x_bits[s]) continue;
    bls::fp_mul(sh.lines[s][kind][2 + comp], sh.lines[s][kind][2 + comp], sh.px);
  }
  __syncthreads();

  for (int s = 0; s < kSteps; ++s) {
    bls::f12_mul(sh.f, sh.f, sh.f, sh.scratch);
    for (int kind = 0; kind < 2; ++kind) {
      if (kind && !x_bits[s]) break;
      if (t < bls::kF12) {  // the sparse line as a whole Fq12
        if (t == 0)
          bls::fp_copy(sh.line[0], sh.py);
        else if (t == 6 || t == 7)
          bls::fp_copy(sh.line[t], sh.lines[s][kind][t - 6]);
        else if (t == 10 || t == 11)
          bls::fp_copy(sh.line[t], sh.lines[s][kind][t - 8]);
        else
          bls::fp_zero(sh.line[t]);
      }
      __syncthreads();
      bls::f12_mul(sh.f, sh.f, sh.line, sh.scratch);
    }
  }
  bls::f12_store_part(out + lane * bls::kF12 * bls::kLimbs, sh.f, /*conj=*/true);
}

}  // namespace

extern "C" int bls_miller_launch(const void* px, const void* py, const void* dbl_a5,
                                 const void* dbl_c3, const void* add_a5, const void* add_c3,
                                 const void* x_bits, void* out, long long lanes, int device,
                                 void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  bls_miller_kernel<<<(unsigned)lanes, bls::kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)px, (const int*)py, (const int*)dbl_a5, (const int*)dbl_c3,
      (const int*)add_a5, (const int*)add_c3, (const int*)x_bits, (int*)out, lanes);
  return (int)cudaGetLastError();
}
