// K7b: the pair-axis product and the final exponentiation of every item of
// a pairing batch, in one launch. Replaces tendermint_tpu/crypto/tpu/
// bls_pairing.py _build_kernel's product tree, final exponentiation and
// output (:148-164): per item, f = prod over pairs of the lanes' Miller
// values (K7a's output, canonical (m, npairs, 6, 2, 49) limbs), then
//   easy part  f1 = conj(f) * f^-1, g = frob2(f1) * f1,
//   hard part  g^d, d = (p^4 - p^2 + 1) / r, on the x-chain
//              d = ((x - 1)^2 / 3)(x + p)(x^2 + p^2 - 1) + 1:
//                a = conj(g^k), k = -(x - 1) / 3
//                b = conj(a^|x|) conj(a)
//                c = conj(b^|x|) b^p
//                e = (c^|x|)^|x| frob2(c) conj(c)
//                g^d = e g
//              (x < 0, and conj is the inverse on the cyclotomic subgroup,
//              where g lies unless it is zero; zero stays zero),
// and writes ok[item] = (result == 1) and the result as canonical
// (m, 6, 2, 49) limbs. The reference scans d's 1,267 bits: 1,267
// squarings and 632 multiplies. The chain is 314 cyclotomic squarings (27
// Fp products each, bls12_381.cuh), 52 multiplies and two Frobenius maps,
// and gives the same element, so the same limbs.
//
// The inverse goes through the norm (bls_math.f12_inv's shape): the five
// Frobenius^2 conjugates' product h, n = f h in Fq2, and one Fp inverse of
// n0^2 + n1^2 by the binary extended Euclidean algorithm in one thread
// (variable time: the data is public).
//
// Design: one block of 512 threads per item. What bounds it is latency,
// not the card's rate: the aggregate path runs 2 items (2 of the card's
// 132 SMs), each one serial chain. So the pair product runs in four
// groups of 128 threads, each multiplying its own share of the lanes into
// its own accumulator, lanes of value exactly one skipped (checked on the
// data, so the result is exact for any input: the aggregate path's pad
// pairs are such lanes); the four partial products then meet in two
// rounds. The easy and the hard part run on group 0: 12 Fq12 products,
// the inverse, and the chain's ~370 operations, each one product's
// latency plus a combination stage.
#include "bls12_381.cuh"
#include "launch.cuh"

namespace {

constexpr int kGroups = 4;
constexpr int kGroupThreads = 128;
constexpr int kThreads = kGroups * kGroupThreads;
constexpr int kChunk = 24;  // lanes converted per round: 288 Fp, one per thread

struct PairSmem {
  bls::Fp lanes[kChunk][bls::kF12];
  int not_one[kChunk][bls::kF12];
  int list[kChunk];  // the chunk's lanes that are not one
  int n;
};

struct ChainSmem {
  bls::Fp g[bls::kF12], a[bls::kF12], b[bls::kF12], c[bls::kF12];
  bls::Fp t[bls::kF12], u[bls::kF12], conj[bls::kF12];
  int one[bls::kF12];
};

struct FinalSmem {
  union {
    PairSmem pair;
    ChainSmem chain;
  };
  bls::Fp acc[kGroups][bls::kF12];
  bls::F12Scratch scratch[kGroups];
};

__global__ void __launch_bounds__(kThreads)
bls_final_exp_kernel(const int* __restrict__ f_in, unsigned char* __restrict__ ok,
                     int* __restrict__ out, long long npairs) {
  __shared__ FinalSmem sh;
  const long long item = blockIdx.x;
  const int t = threadIdx.x, grp = t / kGroupThreads, gt = t % kGroupThreads;
  const int* src = f_in + item * npairs * bls::kF12 * bls::kLimbs;

  // f = product of the item's lanes that are not one, kChunk lanes at a time
  bls::f12_set_one(sh.acc[grp], gt);
  for (long long base = 0; base < npairs; base += kChunk) {
    if (t < kChunk * bls::kF12) {  // each Fp converted, and checked against one's limbs
      const int l = t / bls::kF12, k = t % bls::kF12;
      int not_one = 0;
      if (base + l < npairs) {
        const int* x = src + ((base + l) * bls::kF12 + k) * bls::kLimbs;
        for (int i = 0; i < bls::kLimbs; ++i) not_one |= x[i] != (k == 0 && i == 0);
        bls::fp_from_bytes(sh.pair.lanes[l][k], x, bls::kR2);
      }
      sh.pair.not_one[l][k] = not_one;
    }
    __syncthreads();
    if (t == 0) {
      int n = 0;
      for (int l = 0; l < kChunk; ++l) {
        int any = 0;
        for (int k = 0; k < bls::kF12; ++k) any |= sh.pair.not_one[l][k];
        if (any) sh.pair.list[n++] = l;
      }
      sh.pair.n = n;
    }
    __syncthreads();
    const int n = sh.pair.n;
    for (int r = 0; r < n; r += kGroups) {
      const bool active = r + grp < n;
      bls::f12_mul(sh.acc[grp], sh.acc[grp], sh.pair.lanes[active ? sh.pair.list[r + grp] : 0],
                   sh.scratch[grp], active ? gt : bls::kIdle);
    }
  }
  {  // acc0 acc1 and acc2 acc3 (groups 0 and 1), then their product (group 0)
    const int h = 2 * grp;
    bls::f12_mul(sh.acc[h & 3], sh.acc[h & 3], sh.acc[(h + 1) & 3], sh.scratch[grp],
                 grp < 2 ? gt : bls::kIdle);
  }
  const int lt = grp == 0 ? gt : bls::kIdle;  // the rest runs on group 0
  bls::F12Scratch& s = sh.scratch[0];
  bls::Fp* f = sh.acc[0];
  bls::f12_mul(f, f, sh.acc[2], s, lt);

  // easy part: f^-1 through the norm
  ChainSmem& c = sh.chain;
  bls::f12_conj(c.conj, f, lt);
  bls::f12_frob2(c.g, f, lt);
  bls::f12_copy(c.a, c.g, lt);  // a holds the running product of conjugates
  for (int k = 0; k < 4; ++k) {
    bls::f12_frob2(c.g, c.g, lt);
    bls::f12_mul(c.a, c.a, c.g, s, lt);
  }
  bls::f12_mul(c.g, f, c.a, s, lt);  // the norm n = g[0] + g[1] u
  if (t == 0) {
    uint32_t n0[bls::kN], n1[bls::kN], d[bls::kN];
    bls::fp_mul(n0, c.g[0], c.g[0]);
    bls::fp_mul(n1, c.g[1], c.g[1]);
    bls::fp_add(d, n0, n1);
    bls::fp_inv(d, d);
    bls::fp_mul(n0, c.g[0], d);
    bls::fp_mul(n1, c.g[1], d);
    bls::fp_neg(n1, n1);
    bls::fp_copy(c.g[0], n0);  // g = n^-1 = (n0 - n1 u) / (n0^2 + n1^2), as an Fq12
    bls::fp_copy(c.g[1], n1);
  } else if (t >= 2 && t < bls::kF12) {  // g[1] is thread 0's until it is written
    bls::fp_zero(c.g[t]);
  }
  __syncthreads();
  bls::f12_mul(c.a, c.a, c.g, s, lt);     // f^-1
  bls::f12_mul(c.a, c.conj, c.a, s, lt);  // f1 = f^(p^6 - 1)
  bls::f12_frob2(c.b, c.a, lt);
  bls::f12_mul(c.g, c.b, c.a, s, lt);  // g = f^((p^6 - 1)(p^2 + 1))

  // hard part: the x-chain
  bls::f12_cyclotomic_pow(c.a, c.g, bls::kChainK, s, lt);
  bls::f12_conj(c.a, c.a, lt);  // a = g^((x - 1) / 3)
  bls::f12_cyclotomic_pow(c.t, c.a, bls::kXAbs, s, lt);
  bls::f12_conj(c.t, c.t, lt);
  bls::f12_conj(c.u, c.a, lt);
  bls::f12_mul(c.b, c.t, c.u, s, lt);  // b = a^(x - 1)
  bls::f12_cyclotomic_pow(c.t, c.b, bls::kXAbs, s, lt);
  bls::f12_conj(c.t, c.t, lt);
  bls::f12_frob(c.u, c.b, s, lt);
  bls::f12_mul(c.c, c.t, c.u, s, lt);  // c = b^(x + p)
  bls::f12_cyclotomic_pow(c.t, c.c, bls::kXAbs, s, lt);
  bls::f12_cyclotomic_pow(c.u, c.t, bls::kXAbs, s, lt);
  bls::f12_frob2(c.t, c.c, lt);
  bls::f12_mul(c.u, c.u, c.t, s, lt);
  bls::f12_conj(c.t, c.c, lt);
  bls::f12_mul(c.u, c.u, c.t, s, lt);  // e = c^(x^2 + p^2 - 1)
  bls::f12_mul(c.t, c.u, c.g, s, lt);  // g^d

  bls::f12_store_part(out + item * bls::kF12 * bls::kLimbs, c.t, lt);
  if (lt < bls::kF12) {
    uint32_t w[bls::kW];
    bls::fp_canonical(w, c.t[lt]);
    c.one[lt] = bls::w_is(w, lt == 0);
  }
  __syncthreads();
  if (t == 0) {
    int all = 1;
    for (int i = 0; i < bls::kF12; ++i) all &= c.one[i];
    ok[item] = (unsigned char)all;
  }
}

}  // namespace

extern "C" int bls_final_exp_launch(const void* f_in, void* ok, void* out, long long m,
                                    long long npairs, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  bls_final_exp_kernel<<<(unsigned)m, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)f_in, (unsigned char*)ok, (int*)out, npairs);
  return (int)cudaGetLastError();
}
