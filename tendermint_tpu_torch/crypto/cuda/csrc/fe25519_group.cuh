// GF(2^255 - 19) multiply and squaring for Hopper without warp shuffles.
//
// Used by fe_mul.cu (B1, replacing tendermint_tpu/crypto/tpu/pallas_field.py
// _mul_limbs_first -> _mul_kernel -> _conv_mod), fe_pow22523.cu (B2,
// replacing pallas_field.py _pow22523_limbs_first) and scan_blocks.cu (B3,
// replacing pallas_field.py _scan_blocks_limbs_first), which spreads the
// four multiplies of each round of a point addition over four groups.
//
// Mapping: a group of four lanes owns one field element, lane q of the
// group holding limbs [8q, 8q + 8) in registers; a warp holds eight
// elements. The lanes exchange through shared memory, never through
// shuffles: each lane writes its 8 limbs (as floats) into the element's
// operand row, __syncwarp(), and every lane reads the whole row back with
// 16-byte loads. The carry of each carry pass crosses one lane boundary
// the same way, one word per pass. The warp-per-element multiply it
// replaced issued 68 shuffles per multiply, and an SM
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
// per pass (kCarryWords).
constexpr int kCarryWords = 4 * kLanes;
constexpr int kGroupWords = 2 * kRow + kCarryWords;
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

// What a lane's arithmetic needs to know of its place in the group.
struct Lane {
  int q;            // this lane owns limbs [8q, 8q + 8)
  unsigned w[kLanes];  // w[u]: weight of rotated block u (of block 0's terms t > j for u = 0)
  unsigned bias;    // the accumulators' biases, weighted, to remove
  int wcarry;       // 38 on lane 0 (its carry-in wraps from limb 31)
};

__device__ __forceinline__ Lane make_lane(int q) {
  Lane l;
  l.q = q;
  unsigned total = 1u + 38u;  // the two block-0 accumulators (conv)
  l.w[0] = 38u;
#pragma unroll
  for (int u = 1; u < kLanes; ++u) {
    l.w[u] = (q + u < kLanes) ? 38u : 1u;
    total += l.w[u];
  }
  l.bias = total * (unsigned)kBias;  // mod 2^32, like the sums it corrects
  l.wcarry = q == 0 ? 38 : 1;
  return l;
}

// A lane with the shared scratch of one element's mul and sqr.
struct Group : Lane {
  float* ra;        // shared operand row a (kRow words)
  float* rb;        // shared operand row b
  int* carry;       // shared: the carry words, 4 passes x kLanes
};

// `base`: kGroupWords shared words, 16-byte aligned.
__device__ __forceinline__ Group make_group(int* base, int q) {
  float* rows = reinterpret_cast<float*>(base);
  return Group{make_lane(q), rows, rows + kRow, base + 2 * kRow};
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
// per-lane constants. The loop runs over t outside and j inside, so
// that consecutive FFMAs feed eight different accumulators.
__device__ __forceinline__ void conv(const Lane& g, const float* row_a, const float* row_b,
                                     int (&c)[kOwn]) {
  float x[kLimbs], y[kLimbs];
#pragma unroll
  for (int m = 0; m < kLimbs / 4; ++m) {
    float4 va = *reinterpret_cast<const float4*>(row_a + ((g.q * kOwn + 4 * m) & (kLimbs - 1)));
    float4 vb = *reinterpret_cast<const float4*>(row_b + 4 * m);
    x[4 * m] = va.x, x[4 * m + 1] = va.y, x[4 * m + 2] = va.z, x[4 * m + 3] = va.w;
    y[4 * m] = vb.x, y[4 * m + 1] = vb.y, y[4 * m + 2] = vb.z, y[4 * m + 3] = vb.w;
  }
  // lo[j]: block 0 with t <= j (weight 1); acc[0][j]: block 0 with t > j
  // (weight 38 = w[0]); acc[u][j]: block u (weight w[u])
  float lo[kOwn], acc[kLanes][kOwn];
#pragma unroll
  for (int j = 0; j < kOwn; ++j) {
    lo[j] = kBiasF;
#pragma unroll
    for (int u = 0; u < kLanes; ++u) acc[u][j] = kBiasF;
  }
#pragma unroll
  for (int t = 0; t < kLimbs; ++t) {
#pragma unroll
    for (int j = 0; j < kOwn; ++j) {
      const float yv = y[(j - t) & (kLimbs - 1)];
      if (t <= j) {
        lo[j] = fmaf(x[t], yv, lo[j]);
      } else {
        acc[t / kOwn][j] = fmaf(x[t], yv, acc[t / kOwn][j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kOwn; ++j) {
    unsigned s = from_acc(lo[j]);
#pragma unroll
    for (int u = 0; u < kLanes; ++u) s += g.w[u] * from_acc(acc[u][j]);
    c[j] = (int)(s - g.bias);
  }
}

// One carry pass inside this lane's 8 limbs (arithmetic shifts, as in
// the plain version): keep each limb's low byte and push the rest one
// limb up. `cin`, already weighted, is the carry into limb 8q.
__device__ __forceinline__ void carry_local(int (&c)[kOwn], int cin) {
#pragma unroll
  for (int j = kOwn - 1; j > 0; --j) c[j] = (c[j] & 0xFF) + (c[j - 1] >> 8);
  c[0] = (c[0] & 0xFF) + cin;
}

// Carry pass p of an operation: the carry into limb 8q comes from the
// lane before (lane 3 for lane 0, times 38) through slot p of the group's
// carry words (kLanes words a slot). Pass p of every operation uses slot
// p, and every operation runs at least two passes, so a lane writes a
// slot again only after a __syncwarp() that each lane reaches after
// reading it.
__device__ __forceinline__ void carry_pass(const Lane& l, int* words, int p, int (&c)[kOwn]) {
  words[p * kLanes + l.q] = c[kOwn - 1] >> 8;
  __syncwarp();
  carry_local(c, words[p * kLanes + ((l.q + kLanes - 1) & (kLanes - 1))] * l.wcarry);
}

// ---- operations -------------------------------------------------------------
//
// Every lane of the warp must call them together (they hold __syncwarp):
// a lane past the end of the data computes on a stand-in element and
// skips its store instead of leaving.

// The product of two operand rows already published (as publish() writes
// them) and made visible by a __syncwarp(): the convolution and its four
// carry passes. |limbs| <= 511 in, limbs in [-38, 293] out (as _mul_plain).
__device__ __forceinline__ Fe mul_rows(const Lane& l, int* words, const float* row_a,
                                       const float* row_b) {
  Fe r;
  conv(l, row_a, row_b, r.v);
#pragma unroll
  for (int p = 0; p < 4; ++p) carry_pass(l, words, p, r.v);
  return r;
}

// Field multiply.
__device__ __forceinline__ Fe mul(const Group& g, const Fe& a, const Fe& b) {
  publish(g.ra, a, g.q);
  publish(g.rb, b, g.q);
  __syncwarp();
  return mul_rows(g, g.carry, g.ra, g.rb);
}

// Field squaring, mul(g, a, a) with one operand row published.
__device__ __forceinline__ Fe sqr(const Group& g, const Fe& a) {
  publish(g.ra, a, g.q);
  __syncwarp();
  return mul_rows(g, g.carry, g.ra, g.ra);
}

// a where `c` holds, else b, limb by limb (a select of whole structs on
// a run-time condition would go through local memory).
__device__ __forceinline__ Fe select(bool c, const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int k = 0; k < kOwn; ++k) r.v[k] = c ? a.v[k] : b.v[k];
  return r;
}

// a + b with one carry pass (field.add) where `sub` is false, a - b with
// two (field.sub, whose 8p is the reference's zero) where it is true.
// `sub` may differ from group to group of the warp: every lane runs both
// passes' exchanges, and an add keeps its value after the first.
__device__ __forceinline__ Fe add_or_sub(const Lane& l, int* words, const Fe& a, const Fe& b,
                                         bool sub) {
  Fe r;
#pragma unroll
  for (int k = 0; k < kOwn; ++k) r.v[k] = sub ? a.v[k] - b.v[k] : a.v[k] + b.v[k];
  carry_pass(l, words, 0, r.v);
  Fe r2 = r;
  carry_pass(l, words, 1, r2.v);
  return select(sub, r2, r);
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

// This lane's 8 limbs of `row` (32 ints in shared memory) rewritten in
// place as the floats conv reads.
__device__ __forceinline__ void to_float_row(int* row, int q) {
  publish(reinterpret_cast<float*>(row), load(row, q), q);
}

}  // namespace feg
