// GF(2^255 - 19) multiply and squaring for Hopper without warp shuffles.
//
// Used by fe_mul.cu (B1, replacing tendermint_tpu/crypto/tpu/pallas_field.py
// _mul_limbs_first -> _mul_kernel -> _conv_mod) and fe_pow22523.cu (B2,
// replacing pallas_field.py _pow22523_limbs_first). B3 (scan_blocks.cu)
// still runs the warp-per-element multiply of fe25519.cuh.
//
// Mapping: a group of four lanes owns one field element, lane q of the
// group holding limbs [8q, 8q + 8) in registers; a warp holds eight
// elements. The lanes exchange through shared memory, never through
// shuffles: each lane writes its 8 limbs (as floats) into the element's
// operand row, __syncwarp(), and every lane reads the whole row back with
// 16-byte loads. The carry of each of the four carry passes crosses one
// lane boundary the same way, one word per pass. The warp-per-element
// multiply it replaces issued 68 shuffles per multiply, and an SM
// delivers one warp-wide shuffle per clock against 64 int32 multiply-adds:
// the shuffles, not the arithmetic, set its pace. (One thread per element
// was built and timed too, with a squaring that uses the convolution's
// symmetry, 528 products in place of 1,024: B2 took 0.233 ms against
// 0.158-0.180 ms here on an H100, since 8,447 threads fill only half of
// the card's 528 schedulers, one warp each. See PERF.md.)
//
// Arithmetic: the 32 x 32 schoolbook convolution runs in FP32 FFMA, as
// the TPU kernel does (_conv_mod). Limbs are signed: the reference's sub
// and neg can leave limbs a little below zero (field.py EIGHT_P), and the
// plain versions compute in int32 with arithmetic shifts. With |limb| <=
// 511 a product is below 2^18 in magnitude; each accumulator here sums at
// most 8 products (see conv), below 2^22, and starts at 1.5 * 2^23: every
// partial sum then lies in (2^23, 2^24), where float32 holds every
// integer, so the sum is exact, and the integer is the representation
// minus 0x4B400000 (no float-to-int conversion instruction). Limbs go to
// float the same way in reverse. The fold 2^256 = 38 (mod p) and the four
// carry passes run in int32 and are the reference's, pass for pass
// (field.py _carry_pass): the limbs come out identical to the plain
// PyTorch version's, not merely equal mod p.
//
// Tensor cores do not fit: the convolution shares no operand across
// elements, so the only GEMM form is the TPU's 0/1 anti-diagonal routing
// matrix (field.py _mul_gemm), 63x inflated, whose (B, 1024) outer
// product operand is already the whole work.
//
// What bounds it on an H100: a lone multiply (B1) moves 384 bytes for
// ~2,500 operations, under the card's ~20 operations per byte, so B1 is
// bound by bytes; the pow22523 chain (B2) does 262 multiplies per 256
// bytes and is bound by operations (FFMA issue and the integer carries).
#pragma once

#include <cuda_runtime.h>

namespace feg {

constexpr int kLimbs = 32;
constexpr int kLanes = 4;               // lanes per field element
constexpr int kOwn = kLimbs / kLanes;   // limbs per lane
// Shared row stride in words: 16-byte aligned for float4 access, and
// 36 = 4 (mod 32) puts neighbouring rows on different banks.
constexpr int kRow = 36;
// Shared words per element: two operand rows and one carry word per lane
// per pass.
constexpr int kGroupWords = 2 * kRow + 4 * kLanes;
constexpr int kBias = 0x4B400000;       // bit pattern of 1.5 * 2^23 as a float
constexpr float kBiasF = 12582912.0f;   // 1.5 * 2^23

__device__ __forceinline__ float to_float(int v) {  // |v| < 2^22
  return __int_as_float(v + kBias) - kBiasF;
}

// The integer in an accumulator that started at kBiasF, as an unsigned
// word: the weighted sums of these wrap mod 2^32 and are exact in int32.
__device__ __forceinline__ unsigned from_acc(float acc) {
  return __float_as_uint(acc);
}

struct Fe {  // this lane's 8 limbs of one field element
  int v[kOwn];
};

struct Group {
  float* ra;        // shared operand row a (kRow words)
  float* rb;        // shared operand row b
  int* carry;       // shared: 4 passes x kLanes carry words
  int q;            // this lane owns limbs [8q, 8q + 8)
  unsigned w[kLanes];  // w[u], u >= 1: weight of rotated block u (see conv)
  unsigned bias;    // the accumulators' biases, weighted, to remove
  int wcarry;       // 38 on lane 0 (its carry-in wraps from limb 31)
};

// `base`: kGroupWords shared words, 16-byte aligned.
__device__ __forceinline__ Group make_group(int* base, int q) {
  Group g;
  g.ra = reinterpret_cast<float*>(base);
  g.rb = g.ra + kRow;
  g.carry = base + 2 * kRow;
  g.q = q;
  unsigned total = 1u + 38u;  // the two block-0 accumulators (conv)
  g.w[0] = 38u;
#pragma unroll
  for (int u = 1; u < kLanes; ++u) {
    g.w[u] = (q + u < kLanes) ? 38u : 1u;
    total += g.w[u];
  }
  g.bias = total * (unsigned)kBias;  // mod 2^32, like the sums it corrects
  g.wcarry = q == 0 ? 38 : 1;
  return g;
}

__device__ __forceinline__ void publish(float* row, const Fe& a, int q) {
#pragma unroll
  for (int m = 0; m < kOwn / 4; ++m) {
    *reinterpret_cast<float4*>(row + q * kOwn + 4 * m) =
        make_float4(to_float(a.v[4 * m]), to_float(a.v[4 * m + 1]),
                    to_float(a.v[4 * m + 2]), to_float(a.v[4 * m + 3]));
  }
}

// This lane's 8 coefficients c_j = lo_k + 38 hi_k, k = 8q + j, from the
// published rows. x is row a rotated by 8q (x[t] = a[(8q + t) mod 32]),
// y is row b as stored, so the term of x[t] is y[(j - t) mod 32] and
// every register index is a compile-time constant. The term's product
// lands on coefficient k + 32 (weight 38) exactly when its a-index
// 8q + t does not wrap past limb 31 and exceeds k: within rotated block 0
// that is t > j, and a later block u (t in [8u, 8u + 8)) lands whole on
// weight 38 while q + u < 4 and on weight 1 after. Each (j, block) has
// its own accumulator of at most 8 products; the weights w[u] are
// per-lane constants.
__device__ __forceinline__ void conv(const Group& g, const float* row_a, const float* row_b,
                                     int (&c)[kOwn]) {
  float x[kLimbs], y[kLimbs];
#pragma unroll
  for (int m = 0; m < kLimbs / 4; ++m) {
    float4 va = *reinterpret_cast<const float4*>(row_a + ((g.q * kOwn + 4 * m) & (kLimbs - 1)));
    float4 vb = *reinterpret_cast<const float4*>(row_b + 4 * m);
    x[4 * m] = va.x, x[4 * m + 1] = va.y, x[4 * m + 2] = va.z, x[4 * m + 3] = va.w;
    y[4 * m] = vb.x, y[4 * m + 1] = vb.y, y[4 * m + 2] = vb.z, y[4 * m + 3] = vb.w;
  }
#pragma unroll
  for (int j = 0; j < kOwn; ++j) {
    float lo = kBiasF, hi = kBiasF;
#pragma unroll
    for (int t = 0; t <= j; ++t) lo = fmaf(x[t], y[j - t], lo);
#pragma unroll
    for (int t = j + 1; t < kOwn; ++t) hi = fmaf(x[t], y[(j - t) & (kLimbs - 1)], hi);
    unsigned s = from_acc(lo) + 38u * from_acc(hi);
#pragma unroll
    for (int u = 1; u < kLanes; ++u) {
      float acc = kBiasF;
#pragma unroll
      for (int t = u * kOwn; t < u * kOwn + kOwn; ++t) {
        acc = fmaf(x[t], y[(j - t) & (kLimbs - 1)], acc);
      }
      s += g.w[u] * from_acc(acc);
    }
    c[j] = (int)(s - g.bias);
  }
}

// The four carry passes (arithmetic shifts, as in the plain version); the
// carry into limb 8q comes from the lane before (lane 3 for lane 0, times
// 38) through the carry words.
__device__ __forceinline__ void carry(const Group& g, int (&c)[kOwn]) {
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    g.carry[p * kLanes + g.q] = c[kOwn - 1] >> 8;
    __syncwarp();
    int cin = g.carry[p * kLanes + ((g.q + kLanes - 1) & (kLanes - 1))] * g.wcarry;
#pragma unroll
    for (int j = kOwn - 1; j > 0; --j) c[j] = (c[j] & 0xFF) + (c[j - 1] >> 8);
    c[0] = (c[0] & 0xFF) + cin;
  }
}

// ---- the two operations ---------------------------------------------------
//
// Every lane of the warp must call them together (they hold __syncwarp):
// a lane past the end of the data computes on a stand-in element and
// skips its store instead of leaving.

// Field multiply: |limbs| <= 511 in, limbs <= 293 out (as _mul_plain).
__device__ __forceinline__ Fe mul(const Group& g, const Fe& a, const Fe& b) {
  Fe r;
  publish(g.ra, a, g.q);
  publish(g.rb, b, g.q);
  __syncwarp();
  conv(g, g.ra, g.rb, r.v);
  carry(g, r.v);
  return r;
}

// Field squaring, mul(g, a, a) with one operand row published.
__device__ __forceinline__ Fe sqr(const Group& g, const Fe& a) {
  Fe r;
  publish(g.ra, a, g.q);
  __syncwarp();
  conv(g, g.ra, g.ra, r.v);
  carry(g, r.v);
  return r;
}

// This lane's limbs of element row `src` (32 ints, 16-byte aligned).
__device__ __forceinline__ Fe load(const int* src, int q) {
  Fe a;
#pragma unroll
  for (int m = 0; m < kOwn / 4; ++m) {
    int4 v = *reinterpret_cast<const int4*>(src + q * kOwn + 4 * m);
    a.v[4 * m] = v.x, a.v[4 * m + 1] = v.y, a.v[4 * m + 2] = v.z, a.v[4 * m + 3] = v.w;
  }
  return a;
}

__device__ __forceinline__ void store(int* dst, const Fe& a, int q) {
#pragma unroll
  for (int m = 0; m < kOwn / 4; ++m) {
    *reinterpret_cast<int4*>(dst + q * kOwn + 4 * m) =
        make_int4(a.v[4 * m], a.v[4 * m + 1], a.v[4 * m + 2], a.v[4 * m + 3]);
  }
}

}  // namespace feg
