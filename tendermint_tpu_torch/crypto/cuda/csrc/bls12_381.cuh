// BLS12-381 arithmetic on the card, shared by bls_miller.cu (K7a) and
// bls_final_exp.cu (K7b): Fp in Montgomery form (R = 2^392) as 14 limbs of
// 28 bits; the flat Fq12 of crypto/bls_math.py, Fq2[w]/(w^6 - (1+u)) over
// Fq2 = Fq[u]/(u^2+1), as 12 Fp in shared memory, coefficient c's
// component x at index 2c + x; and the Fq12 operations of a pairing, each
// computed by threads of a block together.
//
// The tensors the kernels exchange with PyTorch keep the JAX reference's
// layout: canonical radix-2^8 limbs, 49 int32 per Fp (limb 48 zero).
//
// Latency is what bounds both kernels, and a product's latency is the
// unit of everything, so the representation is chosen for it:
// - A product (fp_mul) is 196 + 196 independent 32 x 32 -> 64-bit
//   multiply-adds into 64-bit columns (28-bit limbs leave room for every
//   column's sum) and a 14-step Montgomery reduction, with no carry chain;
//   three parallel carry rounds end it.
// - Values are reduced lazily: a stored Fp has limbs of at most 2^28 + 1
//   and a value below 4 p, never more. A product of such values (or of
//   sums of up to four of them) is below p + 2^378 (Montgomery's bound
//   a b / R + p), so nothing is reduced mod p until a value leaves the
//   card (fp_to_limbs) or is inverted.
// - An Fq12 operation is two stages between barriers: its Fp products, one
//   per thread, then each output Fp as a signed sum of products with small
//   coefficients in 64-bit columns (Wide), brought back below 4 p by one
//   subtraction of a multiple of p whose quotient a double estimates, and
//   two parallel carry rounds.
// The operations and their products: f12_mul 108 (Karatsuba in Fq2),
// f12_sqr 63, f12_mul_line 48 (f times a sparse Miller line),
// f12_cyclotomic_sqr 27 (Granger-Scott, valid on the cyclotomic subgroup
// only), f12_frob 18, f12_frob2 12. Every one takes the caller's thread
// index `lt` within the threads that compute it (a thread passes kIdle to
// sit out) and ends with a barrier that every thread of the block reaches.
// Every stage calls fp_mul once, outside any branch: two call sites on
// two branches of one warp would run one after the other.
//
// The same source compiles with g++ for the CPU rehearsal
// (scripts/cuda_emu/run.py). tests/test_torch_bls_field.py checks every
// constant below against crypto/bls_math.py.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace bls {

constexpr int kW = 12;          // 32-bit words of a canonical Fp
constexpr int kN = 14;          // 28-bit limbs of an Fp in Montgomery form
constexpr int kLimbs = 49;      // radix-2^8 limbs per Fp at the boundary
constexpr int kF12 = 12;        // Fp per Fq12
constexpr int kIdle = 1 << 20;  // a thread index that takes part in no stage
constexpr uint32_t kMask = 0xfffffffu;

// |x| of the BLS parameter x = -0xd201000000010000, and k = -(x - 1) / 3
constexpr uint64_t kXAbs = 0xd201000000010000ull;
constexpr uint64_t kChainK = 0x460055555555aaabull;

// 2^336 / p: a Wide sum's quotient by p from its top three columns
constexpr double kQInv = 3.497494308234529e-14;
// a representation of zero, added to a Wide sum's columns so that every
// column below the top stays non-negative: 2^40 in column i and -2^12 in
// column i + 1 cancel
constexpr int64_t kZeroLo = 1ll << 40;
constexpr int64_t kZeroHi = 1ll << 12;

// p as 12 32-bit words (the inverse's form) and as 14 28-bit limbs
__constant__ uint32_t kP[kW] = {0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
                                0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
__constant__ uint32_t kPL[kN] = {0xfffaaabu, 0xfefffffu, 0x3ffffb9u, 0xfffeb15u, 0x6241eabu, 0xa0f6b0fu, 0xf6730d2u,
                                 0xf38512bu, 0x4774b84u, 0x4bacd76u, 0xba7b643u, 0xe69a4b1u, 0x1ea397fu, 0x001a011u};
constexpr uint32_t kPInv = 0xffcfffdu;  // -p^-1 mod 2^28
// R mod p (Montgomery one), R^2 mod p, R^3 mod p, R = 2^392
__constant__ uint32_t kOne[kN] = {0x347fcb8u, 0xd800000u, 0x002b119u, 0x0cde6d2u, 0xc7212e0u, 0x83a2090u, 0x037669fu,
                                  0xda0f73eu, 0x9b09b42u, 0x1297bb0u, 0x515d98fu, 0x012ca7cu, 0x659fcfau, 0x000577au};
__constant__ uint32_t kR2[kN] = {0x10370edu, 0x6d1c345u, 0xe243d62u, 0xec45c53u, 0x3b1d65au, 0x093317du, 0xb4f36a0u,
                                 0x5d74088u, 0xc10ea72u, 0x865d118u, 0x7320a75u, 0xfd5cd50u, 0xcc8a759u, 0x000c8d4u};
__constant__ uint32_t kR3[kN] = {0x1f7b890u, 0x294cc4du, 0x9f3af22u, 0xb5ba56cu, 0xcb5c0ccu, 0xc0d975cu, 0xc89a8c5u,
                                 0x6c968b4u, 0x22672eau, 0x91de8c9u, 0x35652a6u, 0x84977c8u, 0x424bbb9u, 0x00141abu};
// zeta^i (i = 0..5), Montgomery form: f^(p^2) multiplies coefficient i by zeta^i
__constant__ uint32_t kFrob2[6][kN] = {
    {0x347fcb8u, 0xd800000u, 0x002b119u, 0x0cde6d2u, 0xc7212e0u, 0x83a2090u, 0x037669fu,
     0xda0f73eu, 0x9b09b42u, 0x1297bb0u, 0x515d98fu, 0x012ca7cu, 0x659fcfau, 0x000577au},
    {0xdbd8f52u, 0x401b798u, 0x22cefb7u, 0xb89e991u, 0x157ce25u, 0xd988f0fu, 0x4b8a7b6u,
     0x4714659u, 0x493d3c0u, 0x67446bdu, 0x5baa0dau, 0x5740331u, 0x1bedd60u, 0x000ce6du},
    {0xa75929au, 0x681b798u, 0x22a3e9du, 0xabc02bfu, 0x4e5bb45u, 0x55e6e7eu, 0x4814117u,
     0x6d04f1bu, 0xae3387du, 0x54acb0cu, 0x0a4c74bu, 0x56138b5u, 0xb64e066u, 0x00076f2u},
    {0xcb7adf3u, 0x26fffffu, 0x3fd4ea0u, 0xf320443u, 0x9b20bcbu, 0x1d54a7eu, 0xf2fca33u,
     0x19759edu, 0xac6b042u, 0x39151c5u, 0x691dcb4u, 0xe56da35u, 0xb903c85u, 0x0014896u},
    {0x2421b59u, 0xbee4867u, 0x1d31002u, 0x4760184u, 0x4cc5086u, 0xc76dc00u, 0xaae891bu,
     0xac70ad2u, 0xfe377c4u, 0xe4686b8u, 0x5ed1568u, 0x8f5a180u, 0x02b5c1fu, 0x000d1a4u},
    {0x58a1811u, 0x96e4867u, 0x1d5c11cu, 0x543e856u, 0x13e6366u, 0x4b0fc91u, 0xae5efbbu,
     0x8680210u, 0x9941307u, 0xf700269u, 0xb02eef7u, 0x9086bfcu, 0x6855919u, 0x001291eu}};
// conj(gamma_i) (re, im), gamma_i = xi^(i (p - 1) / 6), Montgomery form: f^p is
// the conjugate of sum_i a_i conj(gamma_i) w^i
__constant__ uint32_t kFrob1[6][2][kN] = {
    {{0x347fcb8u, 0xd800000u, 0x002b119u, 0x0cde6d2u, 0xc7212e0u, 0x83a2090u, 0x037669fu,
      0xda0f73eu, 0x9b09b42u, 0x1297bb0u, 0x515d98fu, 0x012ca7cu, 0x659fcfau, 0x000577au},
     {0x0000000u, 0x0000000u, 0x0000000u, 0x0000000u, 0x0000000u, 0x0000000u, 0x0000000u,
      0x0000000u, 0x0000000u, 0x0000000u, 0x0000000u, 0x0000000u, 0x0000000u, 0x0000000u}},
    {{0x9f1ba38u, 0xed52b31u, 0x3131f18u, 0x932815au, 0x35bde3fu, 0x7c4a4dfu, 0xc6f7465u,
      0x266b7ccu, 0x2acd4ffu, 0xcae398du, 0x243b688u, 0xa613121u, 0x72d376fu, 0x0001c3eu},
     {0x9f1ba38u, 0xed52b31u, 0x3131f18u, 0x932815au, 0x35bde3fu, 0x7c4a4dfu, 0xc6f7465u,
      0x266b7ccu, 0x2acd4ffu, 0xcae398du, 0x243b688u, 0xa613121u, 0x72d376fu, 0x0001c3eu}},
    {{0x0000000u, 0x0000000u, 0x0000000u, 0x0000000u, 0x0000000u, 0x0000000u, 0x0000000u,
      0x0000000u, 0x0000000u, 0x0000000u, 0x0000000u, 0x0000000u, 0x0000000u, 0x0000000u},
     {0xdbd8f52u, 0x401b798u, 0x22cefb7u, 0xb89e991u, 0x157ce25u, 0xd988f0fu, 0x4b8a7b6u,
      0x4714659u, 0x493d3c0u, 0x67446bdu, 0x5baa0dau, 0x5740331u, 0x1bedd60u, 0x000ce6du}},
    {{0x33e2f27u, 0x32a25aau, 0x27ca1d2u, 0xc1e049eu, 0xc3f707au, 0x055ca94u, 0x2010b7bu,
      0x3b93794u, 0xd5a86aau, 0xa544de3u, 0x556a044u, 0x9c66da5u, 0x38ec515u, 0x000cea3u},
     {0xcc17b84u, 0xcc5da55u, 0x1835de7u, 0x3e1e677u, 0x9e4ae31u, 0x9b9a07au, 0xd662557u,
      0xb7f1997u, 0x71cc4dau, 0xa667f92u, 0x65115feu, 0x4a3370cu, 0xe5b746au, 0x000d16du}},
    {{0x58a1811u, 0x96e4867u, 0x1d5c11cu, 0x543e856u, 0x13e6366u, 0x4b0fc91u, 0xae5efbbu,
      0x8680210u, 0x9941307u, 0xf700269u, 0xb02eef7u, 0x9086bfcu, 0x6855919u, 0x001291eu},
     {0x0000000u, 0x0000000u, 0x0000000u, 0x0000000u, 0x0000000u, 0x0000000u, 0x0000000u,
      0x0000000u, 0x0000000u, 0x0000000u, 0x0000000u, 0x0000000u, 0x0000000u, 0x0000000u}},
    {{0xd2fe95fu, 0x1ff50dbu, 0x58fc0ebu, 0x55085f8u, 0xf9b4ebau, 0x81a6f73u, 0xe707fe0u,
      0x61fef60u, 0x0075ba9u, 0x7028771u, 0x79a56cdu, 0x4279ec6u, 0xabbfc85u, 0x000eae1u},
     {0xd2fe95fu, 0x1ff50dbu, 0x58fc0ebu, 0x55085f8u, 0xf9b4ebau, 0x81a6f73u, 0xe707fe0u,
      0x61fef60u, 0x0075ba9u, 0x7028771u, 0x79a56cdu, 0x4279ec6u, 0xabbfc85u, 0x000eae1u}}};

typedef uint32_t Fp[kN];

// acc += a b as one signed 32 x 32 + 64-bit multiply-add: nvcc turns the
// C++ expression into a 64-bit product and a separate add (slower for a
// Wide sum on an H100; scripts/bls_bench times the sums)
__device__ __forceinline__ void mad_wide_s32(int64_t& acc, int32_t a, int32_t b) {
#ifdef __CUDA_ARCH__
  asm("mad.wide.s32 %0, %1, %2, %0;" : "+l"(acc) : "r"(a), "r"(b));
#else
  acc += (int64_t)a * b;
#endif
}

// ---- words: canonical values and the inverse ----------------------------

__device__ __forceinline__ void w_copy(uint32_t* r, const uint32_t* a) {
#pragma unroll
  for (int i = 0; i < kW; ++i) r[i] = a[i];
}

__device__ __forceinline__ bool w_is(const uint32_t* a, uint32_t v) {
  uint32_t diff = a[0] ^ v;
#pragma unroll
  for (int i = 1; i < kW; ++i) diff |= a[i];
  return diff == 0;
}

// r = a - p when a >= p, else a (a < 2^384)
__device__ __forceinline__ void w_reduce_once(uint32_t* r, const uint32_t* a) {
  uint32_t d[kW];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < kW; ++i) {
    const uint64_t t = (uint64_t)a[i] - kP[i] - borrow;
    d[i] = (uint32_t)t;
    borrow = t >> 63;
  }
#pragma unroll
  for (int i = 0; i < kW; ++i) r[i] = borrow ? a[i] : d[i];
}

// r = a + b over 12 words (no carry out)
__device__ __forceinline__ void w_add(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < kW; ++i) {
    c += (uint64_t)a[i] + b[i];
    r[i] = (uint32_t)c;
    c >>= 32;
  }
}

// r = a - b over 12 words, a >= b
__device__ __forceinline__ void w_sub(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < kW; ++i) {
    const uint64_t t = (uint64_t)a[i] - b[i] - borrow;
    r[i] = (uint32_t)t;
    borrow = t >> 63;
  }
}

// a >>= s (0 < s < 32) and b <<= s over 12 words (no bit leaves b)
__device__ __forceinline__ void shr_shl(uint32_t* a, uint32_t* b, int s) {
#pragma unroll
  for (int i = 0; i < kW - 1; ++i) a[i] = (a[i] >> s) | (a[i + 1] << (32 - s));
  a[kW - 1] >>= s;
#pragma unroll
  for (int i = kW - 1; i > 0; --i) b[i] = (b[i] << s) | (b[i - 1] >> (32 - s));
  b[0] <<= s;
}

// Kaliski's almost Montgomery inverse of a canonical a != 0, one thread:
// returns k and leaves a^-1 2^k mod p in a, with u = p, v = a, r = 0, s = 1
// and p = u s + v r throughout, so r and s stay below p without any
// reduction; every run of low zero bits goes in one shift (2^k picks them
// up). Variable time: every input of the pairing kernels is public
// verification data. Some 260 rounds of a shift, a subtraction and an
// addition for a random input, where a Fermat inverse is 608 dependent
// products.
__device__ __noinline__ int w_almost_inv(uint32_t* a) {
  uint32_t u[kW], v[kW], r[kW], s[kW];
  w_copy(u, kP);
  w_copy(v, a);
#pragma unroll
  for (int i = 0; i < kW; ++i) r[i] = s[i] = 0;
  s[0] = 1;
  int k = 0;
  while (!w_is(v, 0)) {
    if (!(u[0] & 1)) {
      const int z = u[0] ? __ffs((int)u[0]) - 1 : 31;
      shr_shl(u, s, z);
      k += z;
    } else if (!(v[0] & 1)) {
      const int z = v[0] ? __ffs((int)v[0]) - 1 : 31;
      shr_shl(v, r, z);
      k += z;
    } else {
      uint32_t d[kW];
      uint64_t borrow = 0;
#pragma unroll
      for (int i = 0; i < kW; ++i) {
        const uint64_t t = (uint64_t)u[i] - v[i] - borrow;
        d[i] = (uint32_t)t;
        borrow = t >> 63;
      }
      if (!borrow && !w_is(d, 0)) {  // u > v: u -= v, r += s
        w_copy(u, d);
        w_add(r, r, s);
      } else {  // u <= v (equal only at u = v = 1, the last round): v -= u, s += r
        w_sub(v, v, u);
        w_add(s, s, r);
      }
    }
  }
  w_reduce_once(r, r);  // r < 2p
  w_sub(a, kP, r);      // p - r, in (0, p] for a != 0
  w_reduce_once(a, a);
  return k;
}
// ---- limbs ----------------------------------------------------------------

__device__ __forceinline__ void fp_copy(uint32_t* r, const uint32_t* a) {
#pragma unroll
  for (int i = 0; i < kN; ++i) r[i] = a[i];
}

__device__ __forceinline__ void fp_zero(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < kN; ++i) r[i] = 0;
}

// r = a + b limb by limb, no carry (a product's operand)
__device__ __forceinline__ void fp_add(uint32_t* r, const uint32_t* a, const uint32_t* b) {
#pragma unroll
  for (int i = 0; i < kN; ++i) r[i] = a[i] + b[i];
}

// r = a b R^-1 (r may alias a or b): operands' limbs below 2^30 + 8 and
// values below 16 p; r's limbs at most 2^28, its value below p + 2^378.
// Column j of the running sum takes at most 14 products below (2^30 + 8)^2
// and 14 below 2^56: less than 2^64.
__device__ __forceinline__ void fp_mul(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t av[kN], bv[kN];
  fp_copy(av, a);
  fp_copy(bv, b);
  uint64_t t[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < kN; ++i) {  // t holds columns i .. i + 13
#pragma unroll
    for (int j = 0; j < kN; ++j) t[j] += (uint64_t)av[j] * bv[i];
    const uint32_t m = ((uint32_t)t[0] * kPInv) & kMask;
#pragma unroll
    for (int j = 0; j < kN; ++j) t[j] += (uint64_t)m * kPL[j];
    const uint64_t carry = t[0] >> 28;  // t[0]'s low 28 bits are zero
#pragma unroll
    for (int j = 0; j < kN - 1; ++j) t[j] = t[j + 1];
    t[kN - 1] = 0;
    t[0] += carry;
  }
  // three carry rounds, each limb from its column and its neighbour's
  uint64_t u[kN];
  uint32_t v[kN];
  u[0] = t[0] & kMask;
#pragma unroll
  for (int j = 1; j < kN - 1; ++j) u[j] = (t[j] & kMask) + (t[j - 1] >> 28);
  u[kN - 1] = t[kN - 1] + (t[kN - 2] >> 28);
  v[0] = (uint32_t)u[0];
#pragma unroll
  for (int j = 1; j < kN - 1; ++j) v[j] = ((uint32_t)u[j] & kMask) + (uint32_t)(u[j - 1] >> 28);
  v[kN - 1] = (uint32_t)u[kN - 1] + (uint32_t)(u[kN - 2] >> 28);
  r[0] = v[0];
#pragma unroll
  for (int j = 1; j < kN - 1; ++j) r[j] = (v[j] & kMask) + (v[j - 1] >> 28);
  r[kN - 1] = v[kN - 1] + (v[kN - 2] >> 28);
}

// A signed sum of Fp values with small integer coefficients, in 64-bit
// columns (value = sum c[i] 2^(28 i)).
struct Wide {
  int64_t c[kN];
};

// w = k p (k p above every sum the caller subtracts), plus the zero that
// keeps the columns below the top non-negative
__device__ __forceinline__ void wide_init(Wide& w, int k) {
#pragma unroll
  for (int i = 0; i < kN; ++i)
    w.c[i] = (int64_t)k * kPL[i] + (i == 0 ? kZeroLo : i < kN - 1 ? kZeroLo - kZeroHi : -kZeroHi);
}

// w += k a
__device__ __forceinline__ void wide_madd(Wide& w, const uint32_t* a, int k) {
#pragma unroll
  for (int i = 0; i < kN; ++i) mad_wide_s32(w.c[i], k, (int32_t)a[i]);
}

// w += ar re(z) + ai im(z) for the Fq2 product z whose Karatsuba products
// are m[0] = x0 y0, m[1] = x1 y1, m[2] = (x0 + x1)(y0 + y1): re(z) = m0 - m1,
// im(z) = m2 - m0 - m1
__device__ __forceinline__ void wide_fq2(Wide& w, const Fp* m, int ar, int ai) {
  wide_madd(w, m[0], ar - ai);
  wide_madd(w, m[1], -ar - ai);
  wide_madd(w, m[2], ai);
}

// r = w - q p with q the quotient floor(w / p) less 2 (at least 0), so
// that r's value is in [p, 4 p) when w's is at least p; limbs at most
// 2^28 + 1 after two carry rounds
__device__ __forceinline__ void wide_reduce(uint32_t* r, const Wide& w) {
  const double top = (double)w.c[kN - 1] * 268435456.0 + (double)w.c[kN - 2] +
                     (double)w.c[kN - 3] * (1.0 / 268435456.0);
  int q = (int)floor(top * kQInv) - 2;
  q = q < 0 ? 0 : q;
  int64_t c[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) c[i] = w.c[i] - (int64_t)((uint64_t)(uint32_t)q * kPL[i]);
  uint32_t u[kN];
  u[0] = (uint32_t)c[0] & kMask;
#pragma unroll
  for (int i = 1; i < kN - 1; ++i) u[i] = ((uint32_t)c[i] & kMask) + (uint32_t)(c[i - 1] >> 28);
  u[kN - 1] = (uint32_t)(c[kN - 1] + (c[kN - 2] >> 28));
  r[0] = u[0] & kMask;
#pragma unroll
  for (int i = 1; i < kN - 1; ++i) r[i] = (u[i] & kMask) + (u[i - 1] >> 28);
  r[kN - 1] = u[kN - 1] + (u[kN - 2] >> 28);
}

// r = -a, as 5 p - a reduced, for a below 4 p
__device__ __forceinline__ void fp_neg(uint32_t* r, const uint32_t* a) {
  Wide w;
  wide_init(w, 5);
  wide_madd(w, a, -1);
  wide_reduce(r, w);
}

// ---- conversions ------------------------------------------------------------

// canonical 49 radix-2^8 limbs (value < 2^384) -> the value's 12 words
__device__ __forceinline__ void w_from_bytes(uint32_t* r, const int* limbs) {
#pragma unroll
  for (int i = 0; i < kW; ++i)
    r[i] = (uint32_t)limbs[4 * i] | ((uint32_t)limbs[4 * i + 1] << 8) |
           ((uint32_t)limbs[4 * i + 2] << 16) | ((uint32_t)limbs[4 * i + 3] << 24);
}

// 12 words (value < 2^384) -> 14 exact 28-bit limbs
__device__ __forceinline__ void limbs_from_words(uint32_t* r, const uint32_t* w) {
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const int i = 28 * k / 32, s = 28 * k % 32;
    uint32_t v = w[i] >> s;
    if (s > 4 && i + 1 < kW) v |= w[i + 1 < kW ? i + 1 : i] << (32 - s);
    r[k] = v & kMask;
  }
}

// 14 exact 28-bit limbs (value < 2^384) -> 12 words
__device__ __forceinline__ void words_from_limbs(uint32_t* r, const uint32_t* l) {
#pragma unroll
  for (int i = 0; i < kW; ++i) {
    const int k = 32 * i / 28, s = 32 * i % 28;  // s <= 24: two limbs cover the word
    r[i] = (l[k] >> s) | (l[k + 1] << (28 - s));
  }
}

// canonical radix-2^8 limbs -> Montgomery form times m (m = R^2 mod p gives
// the value's own Montgomery form)
__device__ __forceinline__ void fp_from_bytes(uint32_t* r, const int* limbs, const uint32_t* m) {
  uint32_t w[kW], x[kN];
  w_from_bytes(w, limbs);
  limbs_from_words(x, w);
  fp_mul(r, x, m);
}

// the canonical words of a's value (a in Montgomery form, below 16 p):
// a R^-1 is at most p, then p goes to 0
__device__ __forceinline__ void fp_canonical(uint32_t* r, const uint32_t* a) {
  uint32_t one[kN], x[kN];
  fp_zero(one);
  one[0] = 1;
  fp_mul(x, a, one);
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < kN; ++i) {  // exact limbs
    c += x[i];
    x[i] = c & kMask;
    c >>= 28;
  }
  words_from_limbs(r, x);
  w_reduce_once(r, r);
}

// Montgomery form -> canonical 49 radix-2^8 limbs
__device__ __forceinline__ void fp_to_bytes(int* limbs, const uint32_t* a) {
  uint32_t w[kW];
  fp_canonical(w, a);
#pragma unroll
  for (int i = 0; i < kW; ++i) {
    limbs[4 * i] = (int)(w[i] & 0xff);
    limbs[4 * i + 1] = (int)((w[i] >> 8) & 0xff);
    limbs[4 * i + 2] = (int)((w[i] >> 16) & 0xff);
    limbs[4 * i + 3] = (int)(w[i] >> 24);
  }
  limbs[kLimbs - 1] = 0;
}

// limbs of 2^j (0 <= j < 392)
__device__ __forceinline__ void fp_pow2(uint32_t* r, int j) {
#pragma unroll
  for (int i = 0; i < kN; ++i) r[i] = i == j / 28 ? 1u << (j % 28) : 0u;
}

// r = a^-1 (0 for 0), one thread: x = a^-1 2^k from the almost inverse of
// a's canonical words; x R (x R^2 R^-1) times 2^j1 R^-1 and 2^j2 R^-1 with
// j1 + j2 = 2 * 392 - k is a^-1 R (k is between 381 and 762 for a != 0)
__device__ __noinline__ void fp_inv(uint32_t* r, const uint32_t* a) {
  uint32_t w[kW], x[kN], t[kN];
  fp_canonical(w, a);
  if (w_is(w, 0)) {
    fp_zero(r);
    return;
  }
  const int e = 2 * 28 * kN - w_almost_inv(w);
  const int j1 = e < 380 ? e : 380;
  limbs_from_words(x, w);
  fp_mul(x, x, kR2);
  fp_pow2(t, j1);
  fp_mul(x, x, t);
  fp_pow2(t, e - j1);
  fp_mul(r, x, t);
}

// ---- Fq12 by threads of a block -----------------------------------------

// The products of one Fq12 operation.
struct F12Scratch {
  Fp m[36][3];
};

// the operands (x, y) of the Karatsuba product `which` of Fq2 elements
// a = a0 + a1 u and b: 0: a0 b0, 1: a1 b1, 2: (a0 + a1)(b0 + b1)
__device__ __forceinline__ void kara_operands(uint32_t* x, uint32_t* y, const uint32_t* a0,
                                              const uint32_t* a1, const uint32_t* b0,
                                              const uint32_t* b1, int which) {
  fp_copy(x, which == 1 ? a1 : a0);
  fp_copy(y, which == 1 ? b1 : b0);
  if (which == 2) {
    fp_add(x, x, a1);
    fp_add(y, y, b1);
  }
}

// the weights (re, im) of output component `comp` in an Fq2 product z, or
// in xi z when `hi`: xi z = (re z - im z) + (re z + im z) u
__device__ __forceinline__ int weight_re(int comp, bool hi) { return comp ? (hi ? 1 : 0) : 1; }
__device__ __forceinline__ int weight_im(int comp, bool hi) { return comp ? 1 : (hi ? -1 : 0); }

// r = a b (r may alias a or b): the 36 Fq2 products a_i b_j by Karatsuba,
// 108 products; then c_k = sum_{i+j=k} a_i b_j + xi sum_{i+j=k+6} a_i b_j
__device__ __noinline__ void f12_mul(Fp* r, const Fp* a, const Fp* b, F12Scratch& s, int lt) {
  if (lt < 108) {
    const int ij = lt / 3, which = lt - 3 * ij, i = ij / 6, j = ij - 6 * i;
    uint32_t x[kN], y[kN];
    kara_operands(x, y, a[2 * i], a[2 * i + 1], b[2 * j], b[2 * j + 1], which);
    fp_mul(s.m[ij][which], x, y);
  }
  __syncthreads();
  if (lt < kF12) {
    const int k = lt >> 1, comp = lt & 1;
    Wide w;
    wide_init(w, 24);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const bool hi = i > k;
      wide_fq2(w, s.m[6 * i + (hi ? k + 6 - i : k - i)], weight_re(comp, hi), weight_im(comp, hi));
    }
    wide_reduce(r[lt], w);
  }
  __syncthreads();
}

// r = a^2 (r may alias a), any a: the 15 products a_i a_j (i < j) and the 6
// squares a_i^2, each by Karatsuba, 63 products; a cross product counts
// twice (as a_i a_j and a_j a_i)
__device__ __noinline__ void f12_sqr(Fp* r, const Fp* a, F12Scratch& s, int lt) {
  if (lt < 63) {
    const int pr = lt / 3, which = lt - 3 * pr;
    int i, j;
    if (pr < 15) {
      i = pr < 5 ? 0 : pr < 9 ? 1 : pr < 12 ? 2 : pr < 14 ? 3 : 4;
      j = i + 1 + pr - i * (11 - i) / 2;
    } else {
      i = j = pr - 15;
    }
    uint32_t x[kN], y[kN];
    kara_operands(x, y, a[2 * i], a[2 * i + 1], a[2 * j], a[2 * j + 1], which);
    fp_mul(s.m[6 * i + j][which], x, y);
  }
  __syncthreads();
  if (lt < kF12) {
    const int k = lt >> 1, comp = lt & 1;
    Wide w;
    wide_init(w, 24);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const bool hi = i > k;
      const int j = hi ? k + 6 - i : k - i;
      wide_fq2(w, s.m[i < j ? 6 * i + j : 6 * j + i], weight_re(comp, hi), weight_im(comp, hi));
    }
    wide_reduce(r[lt], w);
  }
  __syncthreads();
}

// r = a l (r may alias a) for the sparse Miller line l = py w^0 + c3 w^3 +
// l5 w^5, line = {c3 re, c3 im, l5 re, l5 im}: 12 products a_i py and 12
// Fq2 products by Karatsuba, 48 products
__device__ __noinline__ void f12_mul_line(Fp* r, const Fp* a, const uint32_t* py, const Fp* line,
                                          F12Scratch& s, int lt) {
  if (lt < 48) {
    uint32_t x[kN], y[kN];
    uint32_t* dst;
    if (lt < kF12) {
      fp_copy(x, a[lt]);
      fp_copy(y, py);
      dst = s.m[lt >> 1][lt & 1];
    } else {
      const int u = (lt - 12) / 18, rest = lt - 12 - 18 * u, i = rest / 3, which = rest - 3 * i;
      kara_operands(x, y, a[2 * i], a[2 * i + 1], line[2 * u], line[2 * u + 1], which);
      dst = s.m[6 + 6 * u + i][which];
    }
    fp_mul(dst, x, y);
  }
  __syncthreads();
  if (lt < kF12) {  // c_k = a_k py + a_(k-3) c3 (xi a_(k+3) c3) + a_(k-5) l5 (xi a_(k+1) l5)
    const int k = lt >> 1, comp = lt & 1;
    Wide w;
    wide_init(w, 24);
    wide_madd(w, s.m[k][comp], 1);
    wide_fq2(w, s.m[6 + (k + 3) % 6], weight_re(comp, k < 3), weight_im(comp, k < 3));
    wide_fq2(w, s.m[12 + (k + 1) % 6], weight_re(comp, k < 5), weight_im(comp, k < 5));
    wide_reduce(r[lt], w);
  }
  __syncthreads();
}

// r = a^2 (r may alias a) for a in the cyclotomic subgroup, or zero
// (Granger-Scott): Fq12 as Fq4[w]/(w^3 - s), s = w^3, a = z0 + z1 w + z2 w^2
// with z0 = (a0, a3), z1 = (a1, a4), z2 = (a2, a5); each Fq4 square
// (x + y s)^2 = (X + xi Y) + (S - X - Y) s from the Fq2 squares X = x^2,
// Y = y^2, S = (x + y)^2, 9 Karatsuba squares, 27 products. Then a0, a2, a4
// <- 3 (X + xi Y) - 2 a_c and a3, a5 <- 3 (S - X - Y) + 2 a_c from the pairs
// (a0, a3), (a1, a4), (a2, a5) in turn, and a1 <- 3 xi (S - X - Y) + 2 a1
// from (a2, a5).
__device__ __noinline__ void f12_cyclotomic_sqr(Fp* r, const Fp* a, F12Scratch& s, int lt) {
  if (lt < 27) {
    const int q = lt / 9, which = lt / 3 - 3 * q, n = lt % 3;
    // the Fq2 value v = x (which 0), y (1) or x + y (2); its Karatsuba
    // square's product n: v0^2, v1^2, (v0 + v1)^2
    uint32_t v0[kN], v1[kN], x[kN];
    const int c = which == 1 ? q + 3 : q;
    fp_copy(v0, a[2 * c]);
    fp_copy(v1, a[2 * c + 1]);
    if (which == 2) {
      fp_add(v0, v0, a[2 * q + 6]);
      fp_add(v1, v1, a[2 * q + 7]);
    }
    fp_copy(x, n == 1 ? v1 : v0);
    if (n == 2) fp_add(x, x, v1);
    fp_mul(s.m[3 * q + which][n], x, x);
  }
  __syncthreads();
  if (lt < kF12) {
    const int c = lt >> 1, comp = lt & 1, q = c % 3 == 0 ? 0 : (c % 3 == 2 ? 1 : 2);
    const bool second = c & 1, xi = c == 1;
    // the output is 3 (wr re(v) + wi im(v)) +- 2 a_c for v = X + xi Y
    // (first) or S - X - Y (second)
    const int wr = (comp == 0 || xi) ? 1 : 0, wi = xi ? (comp ? 1 : -1) : comp;
    Wide w;
    wide_init(w, 24);
    wide_fq2(w, s.m[3 * q], second ? -3 * wr : 3 * wr, second ? -3 * wi : 3 * wi);  // X
    wide_fq2(w, s.m[3 * q + 1], second ? -3 * wr : 3 * (wr + wi),
             second ? -3 * wi : 3 * (wi - wr));  // Y: re(xi Y) = re Y - im Y
    wide_fq2(w, s.m[3 * q + 2], second ? 3 * wr : 0, second ? 3 * wi : 0);  // S
    wide_madd(w, a[lt], second ? 2 : -2);
    wide_reduce(r[lt], w);
  }
  __syncthreads();
}

// r = a^p (r may alias a): conj(a_i) gamma_i = conj(a_i conj(gamma_i)), the
// 6 Fq2 products a_i conj(gamma_i) by Karatsuba, 18 products
__device__ __noinline__ void f12_frob(Fp* r, const Fp* a, F12Scratch& s, int lt) {
  if (lt < 18) {
    const int i = lt / 3, which = lt - 3 * i;
    uint32_t g0[kN], g1[kN], x[kN], y[kN];
    fp_copy(g0, kFrob1[i][0]);
    fp_copy(g1, kFrob1[i][1]);
    kara_operands(x, y, a[2 * i], a[2 * i + 1], g0, g1, which);
    fp_mul(s.m[i][which], x, y);
  }
  __syncthreads();
  if (lt < kF12) {
    const int i = lt >> 1, comp = lt & 1;
    Wide w;
    wide_init(w, 24);
    wide_fq2(w, s.m[i], comp ? 0 : 1, comp ? -1 : 0);
    wide_reduce(r[lt], w);
  }
  __syncthreads();
}

// r = a^(p^2) (r may alias a): coefficient i times zeta^i, 12 products
__device__ __noinline__ void f12_frob2(Fp* r, const Fp* a, int lt) {
  if (lt < kF12) fp_mul(r[lt], a[lt], kFrob2[lt >> 1]);
  __syncthreads();
}

// r = a^(p^6): the odd coefficients negated (the inverse on the cyclotomic subgroup)
__device__ __noinline__ void f12_conj(Fp* r, const Fp* a, int lt) {
  if (lt < kF12) {
    if ((lt >> 1) & 1)
      fp_neg(r[lt], a[lt]);
    else
      fp_copy(r[lt], a[lt]);
  }
  __syncthreads();
}

__device__ __noinline__ void f12_copy(Fp* r, const Fp* a, int lt) {
  if (lt < kF12) fp_copy(r[lt], a[lt]);
  __syncthreads();
}

// r = 1
__device__ __noinline__ void f12_set_one(Fp* r, int lt) {
  if (lt < kF12) {
    if (lt == 0)
      fp_copy(r[0], kOne);
    else
      fp_zero(r[lt]);
  }
  __syncthreads();
}

// r = a^e (r must not alias a) for a in the cyclotomic subgroup, or zero:
// square and multiply over e's bits after the leading one
__device__ __forceinline__ void f12_cyclotomic_pow(Fp* r, const Fp* a, uint64_t e, F12Scratch& s,
                                                   int lt) {
  int i = 63;
  while (!((e >> i) & 1)) --i;
  f12_copy(r, a, lt);
  for (--i; i >= 0; --i) {
    f12_cyclotomic_sqr(r, r, s, lt);
    if ((e >> i) & 1) f12_mul(r, r, a, s, lt);
  }
}

// Fq12 (12 Fp, Montgomery) -> 12 x 49 canonical limbs, threads lt < 12;
// callers synchronize
__device__ __forceinline__ void f12_store_part(int* out, const Fp* a, int lt) {
  if (lt < kF12) fp_to_bytes(out + lt * kLimbs, a[lt]);
}

}  // namespace bls
