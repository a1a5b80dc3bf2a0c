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
// py w^0 + c3 w^3 + (a5 px) w^5.
//
// Design: one block of 64 threads per lane. A pad lane (py = 1 and every
// line zero, so every line is exactly 1; checked on the data) is written
// as one and leaves. Otherwise the block converts the lane's 68 lines to
// Montgomery form with a5 scaled by px (a5 times px R^2, one product each)
// into shared memory, starts f at the first doubling line (1^2 times it),
// and runs the steps: a general squaring (63 Fp products, bls12_381.cuh
// f12_sqr) and one or two sparse line products (48 each) in place of
// f12_mul's 144. Each operation is one product's latency plus a
// combination stage; a lane is one serial chain of 62 squarings and 67
// line products, and at the aggregate path's 512 lanes (151 of them real)
// the card holds every block at once, so latency is what bounds it.
#include "bls12_381.cuh"
#include "launch.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kSteps = 63;
constexpr int kAddSteps = 5;  // the set bits of |x| after its leading one

// step s's bit of |x| (after the leading one)
__device__ __forceinline__ bool step_bit(int s) { return (bls::kXAbs >> (62 - s)) & 1; }

struct MillerSmem {
  // per step: c3 (re, im), a5 px (re, im); the addition lines in step order
  bls::Fp dbl[kSteps][4];
  bls::Fp add[kAddSteps][4];
  bls::Fp py, px_r2;  // py, and px R^2 (a5 times it in Montgomery form is a5 px)
  bls::Fp f[bls::kF12];
  bls::F12Scratch scratch;
  int add_step[kAddSteps];
};

__global__ void __launch_bounds__(kThreads)
bls_miller_kernel(const int* __restrict__ px, const int* __restrict__ py,
                  const int* __restrict__ dbl_a5, const int* __restrict__ dbl_c3,
                  const int* __restrict__ add_a5, const int* __restrict__ add_c3,
                  int* __restrict__ out, long long lanes) {
  __shared__ MillerSmem sh;
  const long long lane = blockIdx.x;
  const int t = threadIdx.x;
  const long long step_stride = lanes * 2 * bls::kLimbs;
  const long long lane_off = lane * 2 * bls::kLimbs;
  int* dst = out + lane * bls::kF12 * bls::kLimbs;

  if (t == 0) {
    for (int s = 0, n = 0; s < kSteps; ++s)
      if (step_bit(s)) sh.add_step[n++] = s;
  }
  __syncthreads();

  // a pad lane: py = 1 and every line that the loop reads zero
  constexpr int kRow = 2 * bls::kLimbs;  // one step's a5 or c3 of a lane
  int nonzero = 0;
  for (int w = t; w < (kSteps + kAddSteps) * 2 * kRow; w += kThreads) {
    const int line = w / (2 * kRow), part = (w / kRow) & 1, off = w % kRow;
    const bool is_add = line >= kSteps;
    const int s = is_add ? sh.add_step[line - kSteps] : line;
    const int* src = part ? (is_add ? add_c3 : dbl_c3) : (is_add ? add_a5 : dbl_a5);
    nonzero |= src[s * step_stride + lane_off + off];
  }
  for (int w = t; w < bls::kLimbs; w += kThreads) nonzero |= py[lane * bls::kLimbs + w] != (w == 0);
  if (!__syncthreads_or(nonzero)) {
    for (int w = t; w < bls::kF12 * bls::kLimbs; w += kThreads) dst[w] = w == 0;
    return;
  }

  // py R and px R^2 (px R^3 R^-1), then the lines: c3 R, and a5 px R^2 R^-1
  if (t < 2) bls::fp_from_bytes(t ? sh.px_r2 : sh.py, (t ? px : py) + lane * bls::kLimbs, t ? bls::kR3 : bls::kR2);
  __syncthreads();
  for (int w = t; w < (kSteps + kAddSteps) * 4; w += kThreads) {
    const int line = w >> 2, part = w & 3, comp = part & 1;
    const bool is_add = line >= kSteps;
    const int s = is_add ? sh.add_step[line - kSteps] : line;
    const int* src = part < 2 ? (is_add ? add_c3 : dbl_c3) : (is_add ? add_a5 : dbl_a5);
    uint32_t* slot = is_add ? sh.add[line - kSteps][part] : sh.dbl[line][part];
    bls::fp_from_bytes(slot, src + s * step_stride + lane_off + comp * bls::kLimbs,
                       part < 2 ? bls::kR2 : sh.px_r2);
  }
  __syncthreads();

  // step 0: f = 1^2 times the doubling line, the line as an Fq12
  if (t < bls::kF12) {
    const int k = t >> 1;
    if (t == 0)
      bls::fp_copy(sh.f[0], sh.py);
    else if (k == 3 || k == 5)
      bls::fp_copy(sh.f[t], sh.dbl[0][(k == 5 ? 2 : 0) + (t & 1)]);
    else
      bls::fp_zero(sh.f[t]);
  }
  __syncthreads();
  for (int s = 0, n = 0; s < kSteps; ++s) {
    if (s) {
      bls::f12_sqr(sh.f, sh.f, sh.scratch, t);
      bls::f12_mul_line(sh.f, sh.f, sh.py, sh.dbl[s], sh.scratch, t);
    }
    if (step_bit(s)) bls::f12_mul_line(sh.f, sh.f, sh.py, sh.add[n++], sh.scratch, t);
  }
  bls::f12_conj(sh.f, sh.f, t);
  bls::f12_store_part(dst, sh.f, t);
}

}  // namespace

extern "C" int bls_miller_launch(const void* px, const void* py, const void* dbl_a5,
                                 const void* dbl_c3, const void* add_a5, const void* add_c3,
                                 void* out, long long lanes, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  bls_miller_kernel<<<(unsigned)lanes, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)px, (const int*)py, (const int*)dbl_a5, (const int*)dbl_c3,
      (const int*)add_a5, (const int*)add_c3, (int*)out, lanes);
  return (int)cudaGetLastError();
}
