// BLS12-381 arithmetic on the card, shared by bls_miller.cu (K7a) and
// bls_final_exp.cu (K7b): Fp in Montgomery form as 12 little-endian 32-bit
// words (R = 2^384), always fully reduced to [0, p); the flat Fq12 of
// crypto/bls_math.py, Fq2[w]/(w^6 - (1+u)) over Fq2 = Fq[u]/(u^2+1), as 12
// Fp in shared memory, coefficient c's component x at index 2c + x; and one
// Fq12 product computed by the 144 threads of a block together.
//
// The tensors the kernels exchange with PyTorch keep the JAX reference's
// layout: canonical radix-2^8 limbs, 49 int32 per Fp (limb 48 zero).
//
// Products are 32x32 -> 64-bit multiply-adds in plain C++ (CIOS Montgomery
// multiplication): exact, and the same source compiles with g++ for the CPU
// rehearsal (scripts/cuda_emu/run.py). tests/test_torch_bls_field.py checks
// every constant below against crypto/bls_math.py.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace bls {

constexpr int kW = 12;          // 32-bit words per Fp
constexpr int kLimbs = 49;      // radix-2^8 limbs per Fp at the boundary
constexpr int kF12 = 12;        // Fp per Fq12
constexpr int kThreads = 144;   // threads of a block: one per Fp product of an Fq12 product

// p, -p^-1 mod 2^32, R mod p (Montgomery one), R^2 mod p
__constant__ uint32_t kP[kW] = {0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu,
                                0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u,
                                0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
constexpr uint32_t kPInv = 0xfffcfffdu;
__constant__ uint32_t kOne[kW] = {0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu,
                                  0x53c758bau, 0x5f489857u, 0x70525745u, 0x77ce5853u,
                                  0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};
__constant__ uint32_t kR2[kW] = {0x1c341746u, 0xf4df1f34u, 0x09d104f1u, 0x0a76e6a6u,
                                 0x4c95b6d5u, 0x8de5476cu, 0x939d83c0u, 0x67eb88a9u,
                                 0xb519952du, 0x9a793e85u, 0x92cae3aau, 0x11988fe5u};
// zeta^i (i = 0..5) in Montgomery form: f^(p^2) multiplies coefficient i by zeta^i
__constant__ uint32_t kFrob2[6][kW] = {
    {0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
     0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u},
    {0x798dba3au, 0xecfb361bu, 0x91865a2cu, 0xc100ddb8u, 0x232bda8eu, 0x0ec08ff1u,
     0xf1ca4721u, 0xd5c13cc6u, 0xbf7b5c04u, 0x47222a47u, 0xe51c5f59u, 0x0110f184u},
    {0x798a64e8u, 0x30f1361bu, 0x7ece5a2au, 0xf3b8ddabu, 0xc61577f7u, 0x16a8ca3au,
     0x74fd029bu, 0xc26a2ff8u, 0x60701c6eu, 0x3636b766u, 0x241b6160u, 0x051ba4abu},
    {0xfffcaaaeu, 0x43f5ffffu, 0xed47fffdu, 0x32b7fff2u, 0xa2e99d69u, 0x07e83a49u,
     0x8332bb7au, 0xeca8f331u, 0xa0f4c069u, 0xef148d1eu, 0x3eff0206u, 0x040ab326u},
    {0x8671f071u, 0xcd03c9e4u, 0x1fcda5d2u, 0x5dab2246u, 0xd3851b95u, 0x587042afu,
     0x01bacb9eu, 0x8eb60ebeu, 0x83d050d2u, 0x03f97d6eu, 0x54638741u, 0x18f02065u},
    {0x867545c3u, 0x890dc9e4u, 0x3285a5d5u, 0x2af32253u, 0x309b7e2cu, 0x50880866u,
     0x7e881024u, 0xa20d1b8cu, 0xe2db9068u, 0x14e4f04fu, 0x1564853au, 0x14e56d3fu}};

// ---- Fp ----------------------------------------------------------------

__device__ __forceinline__ void fp_copy(uint32_t* r, const uint32_t* a) {
#pragma unroll
  for (int i = 0; i < kW; ++i) r[i] = a[i];
}

__device__ __forceinline__ void fp_zero(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < kW; ++i) r[i] = 0;
}

// r = a - p when a >= p, else a (a < 2^384)
__device__ __forceinline__ void fp_reduce_once(uint32_t* r, const uint32_t* a) {
  uint32_t d[kW];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < kW; ++i) {
    uint64_t t = (uint64_t)a[i] - kP[i] - borrow;
    d[i] = (uint32_t)t;
    borrow = t >> 63;
  }
#pragma unroll
  for (int i = 0; i < kW; ++i) r[i] = borrow ? a[i] : d[i];
}

__device__ __forceinline__ void fp_add(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t s[kW];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < kW; ++i) {
    c += (uint64_t)a[i] + b[i];
    s[i] = (uint32_t)c;
    c >>= 32;
  }
  fp_reduce_once(r, s);  // a + b < 2p < 2^382: no carry out of word 11
}

__device__ __forceinline__ void fp_sub(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t d[kW];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < kW; ++i) {
    uint64_t t = (uint64_t)a[i] - b[i] - borrow;
    d[i] = (uint32_t)t;
    borrow = t >> 63;
  }
  const uint32_t mask = borrow ? 0xffffffffu : 0u;  // a < b: add p back
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < kW; ++i) {
    c += (uint64_t)d[i] + (kP[i] & mask);
    r[i] = (uint32_t)c;
    c >>= 32;
  }
}

__device__ __forceinline__ void fp_neg(uint32_t* r, const uint32_t* a) {
  uint32_t z[kW];
  fp_zero(z);
  fp_sub(r, z, a);
}

// r = a * b * R^-1 mod p (CIOS), a and b in [0, p); r may alias a or b
__device__ __forceinline__ void fp_mul(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t t[kW + 2];
#pragma unroll
  for (int j = 0; j < kW + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < kW; ++i) {
    const uint32_t bi = b[i];
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      c += (uint64_t)a[j] * bi + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[kW];
    t[kW] = (uint32_t)c;
    t[kW + 1] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * kPInv;
    c = ((uint64_t)m * kP[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < kW; ++j) {
      c += (uint64_t)m * kP[j] + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[kW];
    t[kW - 1] = (uint32_t)c;
    t[kW] = t[kW + 1] + (uint32_t)(c >> 32);
  }
  fp_reduce_once(r, t);  // t < 2p
}

// canonical 49 radix-2^8 limbs (value < p) -> Montgomery form
__device__ __forceinline__ void fp_from_limbs(uint32_t* r, const int* limbs) {
  uint32_t x[kW];
#pragma unroll
  for (int i = 0; i < kW; ++i)
    x[i] = (uint32_t)limbs[4 * i] | ((uint32_t)limbs[4 * i + 1] << 8) |
           ((uint32_t)limbs[4 * i + 2] << 16) | ((uint32_t)limbs[4 * i + 3] << 24);
  fp_mul(r, x, kR2);
}

// Montgomery form -> canonical 49 radix-2^8 limbs
__device__ __forceinline__ void fp_to_limbs(int* limbs, const uint32_t* a) {
  uint32_t one[kW], x[kW];
  fp_zero(one);
  one[0] = 1;
  fp_mul(x, a, one);
#pragma unroll
  for (int i = 0; i < kW; ++i) {
    limbs[4 * i] = (int)(x[i] & 0xff);
    limbs[4 * i + 1] = (int)((x[i] >> 8) & 0xff);
    limbs[4 * i + 2] = (int)((x[i] >> 16) & 0xff);
    limbs[4 * i + 3] = (int)(x[i] >> 24);
  }
  limbs[kLimbs - 1] = 0;
}

__device__ __forceinline__ bool fp_equal(const uint32_t* a, const uint32_t* b) {
  uint32_t diff = 0;
#pragma unroll
  for (int i = 0; i < kW; ++i) diff |= a[i] ^ b[i];
  return diff == 0;
}

// a^(p-2) = a^-1 (Fermat), one thread: 380 squarings and 228 multiplies
__device__ __noinline__ void fp_inv(uint32_t* r, const uint32_t* a) {
  uint32_t acc[kW];
  fp_copy(acc, a);  // the leading bit of p - 2
  for (int bit = 379; bit >= 0; --bit) {
    fp_mul(acc, acc, acc);
    const uint32_t word = bit / 32 == 0 ? kP[0] - 2 : kP[bit / 32];
    if ((word >> (bit % 32)) & 1) fp_mul(acc, acc, a);
  }
  fp_copy(r, acc);
}

// ---- Fq12 by a block ---------------------------------------------------

typedef uint32_t Fp[kW];

// Shared scratch of one block's Fq12 products.
struct F12Scratch {
  Fp prod[144];   // (i, j, x, y) at ((6 i + j) * 4 + 2 x + y): a_{i,x} b_{j,y}
  Fp q2[36][2];   // the Fq2 products a_i b_j
  Fp sums[6][4];  // per output coefficient k: w^k part (re, im), w^(k+6) part (re, im)
};

// r = a * b in Fq12 (12 Fp each, shared memory). Every thread of the block
// calls it; r may alias a or b (it is written after the last read of both).
__device__ __forceinline__ void f12_mul(Fp* r, const Fp* a, const Fp* b, F12Scratch& s) {
  const int t = threadIdx.x;
  if (t < 144) {
    const int ij = t >> 2, i = ij / 6, j = ij % 6, x = (t >> 1) & 1, y = t & 1;
    uint32_t av[kW], bv[kW];
    fp_copy(av, a[2 * i + x]);
    fp_copy(bv, b[2 * j + y]);
    fp_mul(av, av, bv);
    fp_copy(s.prod[t], av);
  }
  __syncthreads();
  if (t < 72) {  // (a0 + a1 u)(b0 + b1 u) = (a0 b0 - a1 b1) + (a0 b1 + a1 b0) u
    const int ij = t >> 1;
    uint32_t v[kW];
    if (t & 1)
      fp_add(v, s.prod[4 * ij + 1], s.prod[4 * ij + 2]);
    else
      fp_sub(v, s.prod[4 * ij], s.prod[4 * ij + 3]);
    fp_copy(s.q2[ij][t & 1], v);
  }
  __syncthreads();
  if (t < 24) {  // the polynomial product's coefficients k (< 6) and k + 6
    const int k = t >> 2, part = t & 3, comp = part & 1;
    uint32_t acc[kW];
    fp_zero(acc);
    if (part < 2) {
      for (int i = 0; i <= k; ++i) fp_add(acc, acc, s.q2[6 * i + (k - i)][comp]);
    } else {
      for (int i = k + 1; i < 6; ++i) fp_add(acc, acc, s.q2[6 * i + (k + 6 - i)][comp]);
    }
    fp_copy(s.sums[k][part], acc);
  }
  __syncthreads();
  if (t < 12) {  // c_k = lo_k + xi hi_k, xi (x + y u) = (x - y) + (x + y) u
    const int k = t >> 1, comp = t & 1;
    uint32_t v[kW];
    if (comp)
      fp_add(v, s.sums[k][2], s.sums[k][3]);
    else
      fp_sub(v, s.sums[k][2], s.sums[k][3]);
    fp_add(v, v, s.sums[k][comp]);
    fp_copy(r[t], v);
  }
  __syncthreads();
}

// r = a, for 12 threads; callers synchronize
__device__ __forceinline__ void f12_copy_part(Fp* r, const Fp* a) {
  const int t = threadIdx.x;
  if (t < kF12) fp_copy(r[t], a[t]);
}

// r = 1, for 12 threads; callers synchronize
__device__ __forceinline__ void f12_one_part(Fp* r) {
  const int t = threadIdx.x;
  if (t < kF12) {
    if (t == 0)
      fp_copy(r[0], kOne);
    else
      fp_zero(r[t]);
  }
}

// Fq12 (12 Fp, Montgomery) -> 12 x 49 canonical limbs, 12 threads; the odd
// w coefficients negated first when `conj` (f^(p^6))
__device__ __forceinline__ void f12_store_part(int* out, const Fp* a, bool conj) {
  const int t = threadIdx.x;
  if (t < kF12) {
    uint32_t v[kW];
    if (conj && ((t >> 1) & 1))
      fp_neg(v, a[t]);
    else
      fp_copy(v, a[t]);
    fp_to_limbs(out + t * kLimbs, v);
  }
}

}  // namespace bls
