// B8: batched SHA-256 compression with a per-message block count,
// (B, T, 16) uint32 big-endian words + (B,) counts -> (B, 8) state words.
// Replaces tendermint_tpu/crypto/tpu/sha256.py _make_kernel (an XLA graph
// that unrolls 64 rounds per block over the whole batch and masks each
// block with where(nblk > t, new, state)).
//
// Bound on an H100 by 32-bit integer operations: a block is 64 rounds of
// 14 instructions and 48 schedule words of 10 (logic of three inputs is
// one LOP3, a sum of three one IADD3, a rotation one SHF), against 64
// bytes read.
// Each round depends on the one before, so one message is one serial
// chain: one thread per message, the eight state words and a rolling
// 16-word schedule in registers (the rounds are unrolled, so every
// schedule index is known to the compiler), rotations as funnel shifts,
// the round constants in constant memory. A thread absorbs its blocks
// t < nblk[i] and stops: a masked block leaves the state unchanged, so
// this equals the reference's where(). Words arrive as int32 tensors that
// hold the uint32 bit patterns and are read 16 bytes at a time.
//
// A simple kernel: with 128 threads a block, B = 4,096 fills 32 of the
// 132 SMs, one warp per scheduler. More messages in flight per SM, or a
// message spread over a warp, are later work.
#include "launch.cuh"

namespace {

constexpr int kThreads = 128;

__constant__ unsigned kRound[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u,
    0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u,
    0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u, 0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u,
    0x0FC19DC6u, 0x240CA1CCu, 0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu,
    0x983E5152u, 0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu, 0x53380D13u,
    0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u, 0xA2BFE8A1u, 0xA81A664Bu,
    0xC24B8B70u, 0xC76C51A3u, 0xD192E819u, 0xD6990624u, 0xF40E3585u, 0x106AA070u,
    0x19A4C116u, 0x1E376C08u, 0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au,
    0x5B9CCA4Fu, 0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u,
};

__device__ __forceinline__ unsigned rotr(unsigned x, int n) { return __funnelshift_r(x, x, n); }

__global__ void __launch_bounds__(kThreads)
sha256_batch_kernel(const uint4* __restrict__ words, const int* __restrict__ nblk,
                    uint4* __restrict__ out, long long b, int t) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= b) return;
  unsigned h[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
                   0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u};
  const int n = min(nblk[i], t);
  const uint4* src = words + i * t * 4;
  for (int blk = 0; blk < n; ++blk) {
    unsigned w[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = src[blk * 4 + q];
      w[4 * q] = v.x;
      w[4 * q + 1] = v.y;
      w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
    unsigned a = h[0], bb = h[1], c = h[2], d = h[3], e = h[4], f = h[5], g = h[6], hh = h[7];
#pragma unroll
    for (int r = 0; r < 64; ++r) {
      if (r >= 16) {
        const unsigned w15 = w[(r - 15) & 15], w2 = w[(r - 2) & 15];
        const unsigned s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
        const unsigned s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
        w[r & 15] += s0 + w[(r - 7) & 15] + s1;
      }
      const unsigned s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      const unsigned ch = (e & f) ^ (~e & g);
      const unsigned t1 = hh + s1 + ch + kRound[r] + w[r & 15];
      const unsigned s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      const unsigned maj = (a & bb) ^ (a & c) ^ (bb & c);
      hh = g;
      g = f;
      f = e;
      e = d + t1;
      d = c;
      c = bb;
      bb = a;
      a = t1 + s0 + maj;
    }
    h[0] += a;
    h[1] += bb;
    h[2] += c;
    h[3] += d;
    h[4] += e;
    h[5] += f;
    h[6] += g;
    h[7] += hh;
  }
  out[2 * i] = make_uint4(h[0], h[1], h[2], h[3]);
  out[2 * i + 1] = make_uint4(h[4], h[5], h[6], h[7]);
}

}  // namespace

// words: (b, t, 16) 32-bit words, 16-byte aligned; nblk: (b,) int32;
// out: (b, 8) 32-bit words.
extern "C" int sha256_batch_launch(const void* words, const void* nblk, void* out, long long b,
                                   int t, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  unsigned blocks = (unsigned)((b + kThreads - 1) / kThreads);
  sha256_batch_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)words, (const int*)nblk, (uint4*)out, b, t);
  return (int)cudaGetLastError();
}
