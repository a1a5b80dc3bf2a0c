// B8: batched SHA-256 of messages packed end to end in one byte buffer,
// (total,) bytes + (n + 1,) int64 offsets -> (n, 32) digest bytes.
// Replaces tendermint_tpu/crypto/tpu/sha256.py:107 _make_kernel (jitted at
// :156), an XLA graph over host-padded (bucket, T, 16) word arrays that
// unrolls 64 rounds per block over the whole bucket and masks each block
// with where(nblk > t, new, state). The TPU needed static shapes, so the
// reference pads every message on the host to a power-of-two block count
// and the batch to a bucket of at most 4,096, and launches once a bucket.
// This kernel pads and packs on the card instead: one launch hashes the
// whole batch, and the host only joins the messages and writes the offsets.
//
// What bounds it on an H100: 32-bit integer issue and one message's
// dependent chain. A block is 64 rounds of 14 instructions and 48 schedule
// words of 10 (logic of three inputs is one LOP3, a sum of three one IADD3,
// a rotation one SHF) against 64 bytes read: at the card's INT32 rate (132
// SMs x 64 lanes) that is the throughput bound. The rounds of a message are
// one dependent chain, e's recurrence e' = (d + h + K + W) + Sigma1(e) +
// Ch(e, f, g), where the bracket does not wait on e: three dependent
// instructions a round (Sigma1's rotations, their XOR, the sum), 64 rounds
// and the add into the state a block. So a message takes at least its
// blocks' chains, however many SMs are busy. One thread hashes one message,
// and the SM partition that runs a warp issues an INT32 warp instruction
// every two cycles, so a lone warp on its partition runs at about its
// instruction count, not its chain: the card reaches its INT32 rate only
// with a warp on every partition of every SM. A thread block is one warp of
// 32 messages, so 4,224 messages put a warp on each of the 132 SMs and
// 16,896 one on each of their 528 partitions; narrower batches leave
// partitions idle.
//
// The design:
//  - Staging. A thread block copies its 32 messages' contiguous bytes, the
//    span rounded out to 16-byte alignment at both ends, into shared memory
//    with cp.async 16-byte copies, all in flight at once and coalesced (a
//    warp reads 512 consecutive bytes a step); the last partial 16 bytes of
//    the buffer are copied in part and zero-filled. Offsets are arbitrary,
//    so a message's first byte sits at any alignment.
//  - Padding on the card. Each thread reads its message's words from shared
//    memory, two aligned words and one PRMT (__byte_perm) per big-endian
//    word whatever the alignment; the block holding the end of the message
//    gets the 0x80 byte at `len`, zeros, and, in the last of its
//    (len + 8) / 64 + 1 blocks, the 64-bit big-endian bit length.
//  - Rounds as in the reference's graph: the state and a rolling 16-word
//    schedule in registers, the rounds unrolled (every schedule index known
//    to the compiler), rotations as funnel shifts, the round constants in
//    constant memory; each message stops at its own block count.
//  - The digest words are byte-swapped on the card and stored as 32 bytes
//    a message, so the host copies the digests out as they are.
// The next block's words are not read ahead: they come from shared memory
// (tens of cycles, against thousands for a block's rounds).
#include "launch.cuh"

namespace {

// messages a thread block hashes, one a thread: one warp
constexpr int kMsgs = 32;
// the longest message: 8 padded blocks less the 0x80 byte and the length
constexpr int kMaxBytes = 8 * 64 - 9;

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

// The digest state of the message of `len` bytes (at most kMaxBytes) whose
// first byte is byte `start` of the staged bytes `stage` (shared memory,
// read as 32-bit words; at least 4 bytes past the message's last word are
// readable).
__device__ __forceinline__ void hash_message(const unsigned* stage, int start, int len,
                                             unsigned h[8]) {
  h[0] = 0x6A09E667u;
  h[1] = 0xBB67AE85u;
  h[2] = 0x3C6EF372u;
  h[3] = 0xA54FF53Au;
  h[4] = 0x510E527Fu;
  h[5] = 0x9B05688Cu;
  h[6] = 0x1F83D9ABu;
  h[7] = 0x5BE0CD19u;
  const unsigned* src = stage + (start >> 2);
  // PRMT selector: the four bytes from byte (start & 3) of two aligned
  // words, the first in the top byte (a big-endian word)
  const unsigned skew = (unsigned)start & 3u;
  const unsigned sel = (skew << 12) | ((skew + 1) << 8) | ((skew + 2) << 4) | (skew + 3);
  const int nb = (len + 8) / 64 + 1;
  for (int blk = 0; blk < nb; ++blk) {
    const unsigned* p = src + 16 * blk;
    const int left = len - 64 * blk;  // message bytes from this block's first byte on
    unsigned w[16];
    if (left >= 64) {
#pragma unroll
      for (int j = 0; j < 16; ++j) w[j] = __byte_perm(p[j], p[j + 1], sel);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int rem = left - 4 * j;  // message bytes from this word's first byte on
        unsigned v = rem > 0 ? __byte_perm(p[j], p[j + 1], sel) : 0u;
        if (rem < 4) {
          // keep the message's bytes, then 0x80, then zeros
          const unsigned keep = rem > 0 ? 0xFFFFFFFFu << (32 - 8 * rem) : 0u;
          v = (v & keep) | (rem >= 0 ? 0x80000000u >> (8 * rem) : 0u);
        }
        w[j] = v;
      }
      if (blk == nb - 1) {
        w[14] = 0u;  // len < 2^29: the bit length's high word
        w[15] = (unsigned)len << 3;
      }
    }
    unsigned a = h[0], bb = h[1], c = h[2], d = h[3];
    unsigned e = h[4], f = h[5], g = h[6], hh = h[7];
#pragma unroll
    for (int r = 0; r < 64; ++r) {
      if (r >= 16) {
        const unsigned w15 = w[(r - 15) & 15], w2 = w[(r - 2) & 15];
        const unsigned s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
        const unsigned s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
        w[r & 15] += s0 + w[(r - 7) & 15] + s1;
      }
      const unsigned e1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      const unsigned ch = (e & f) ^ (~e & g);
      const unsigned t1 = hh + e1 + ch + kRound[r] + w[r & 15];
      const unsigned e0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      const unsigned maj = (a & bb) ^ (a & c) ^ (bb & c);
      hh = g;
      g = f;
      f = e;
      e = d + t1;
      d = c;
      c = bb;
      bb = a;
      a = t1 + e0 + maj;
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
}

__device__ __forceinline__ unsigned bswap(unsigned x) { return __byte_perm(x, 0u, 0x0123); }

__device__ __forceinline__ void store_digest(uint4* out, const unsigned h[8]) {
  out[0] = make_uint4(bswap(h[0]), bswap(h[1]), bswap(h[2]), bswap(h[3]));
  out[1] = make_uint4(bswap(h[4]), bswap(h[5]), bswap(h[6]), bswap(h[7]));
}

__global__ void __launch_bounds__(kMsgs)
sha256_bytes_kernel(const unsigned char* __restrict__ buf, long long total,
                    const long long* __restrict__ offsets, uint4* __restrict__ out, long long n) {
  extern __shared__ __align__(16) uint4 stage[];
  const long long first = (long long)blockIdx.x * kMsgs;
  const long long i = first + threadIdx.x;
  const long long lo = offsets[first] & ~15LL;
  const long long hi = offsets[min(n, first + kMsgs)];
  const int chunks = (int)((hi - lo + 15) >> 4);
  for (int c = threadIdx.x; c < chunks; c += kMsgs) {
    const long long at = lo + 16LL * c;
    cp_async16_part(stage + c, buf + at, (int)min(16LL, total - at));
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (i >= n) return;
  const long long start = offsets[i];
  unsigned h[8];
  hash_message(reinterpret_cast<const unsigned*>(stage), (int)(start - lo),
               (int)(offsets[i + 1] - start), h);
  store_digest(out + 2 * i, h);
}

// One message hashed by one thread alone on the card, its block loop timed
// by the SM's cycle counter (cycles[0]: what one warp issues for it); then
// the rounds' dependent chain alone, timed the same way (cycles[1]): e's
// recurrence e' = (d + h + K[r] + W[r]) + Sigma1(e) + Ch(e, f, g), with the
// bracket, which does not wait on e, held in one register, 64 rounds and
// the add into the state a block, eight blocks. cycles[2] keeps the chain's
// end.
__global__ void sha256_cycles_kernel(const unsigned char* __restrict__ msg, int len,
                                     uint4* __restrict__ out, long long* __restrict__ cycles) {
  __shared__ __align__(16) unsigned char stage[kMaxBytes + 25];
  for (int k = 0; k < len; ++k) stage[k] = msg[k];
  __syncthreads();
  unsigned h[8];
  const long long t0 = clock64();
  hash_message(reinterpret_cast<const unsigned*>(stage), 0, len, h);
  const long long t1 = clock64();
  store_digest(out, h);
  cycles[0] = t1 - t0;
  const long long t2 = clock64();
  // the chain starts from the counter, so it cannot start before it
  unsigned e = h[4] ^ ((unsigned)t2 & 1u), f = h[5], g = h[6];
  const unsigned rest = h[7];
#pragma unroll 1
  for (int blk = 0; blk < 8; ++blk) {
    const unsigned e_in = e;
#pragma unroll
    for (int r = 0; r < 64; ++r) {
      const unsigned e1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      const unsigned ch = (e & f) ^ (~e & g);
      g = f;
      f = e;
      e = (rest + kRound[r]) + e1 + ch;
    }
    e += e_in;
  }
  // the store waits for the chain's end, the counter for the store
  cycles[2] = e;
  cycles[1] = clock64() - t2;
}

}  // namespace

// buf: `total` bytes, 16-byte aligned; offsets: (n + 1,) int64, message k
// is bytes [offsets[k], offsets[k + 1]) of buf, each at most 503 bytes (the
// caller checks); out: (n, 32) bytes, 16-byte aligned; smem: the shared
// bytes a thread block stages, at least its 32 messages' span rounded out
// to 16 bytes at both ends, plus 16.
extern "C" int sha256_bytes_launch(const void* buf, long long total, const void* offsets,
                                   void* out, long long n, int smem, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  unsigned blocks = (unsigned)((n + kMsgs - 1) / kMsgs);
  sha256_bytes_kernel<<<blocks, kMsgs, smem, (cudaStream_t)stream>>>(
      (const unsigned char*)buf, total, (const long long*)offsets, (uint4*)out, n);
  return (int)cudaGetLastError();
}

// msg: `len` bytes (at most 503); out: 32 bytes, 16-byte aligned; cycles:
// three int64, the block loop's cycles, the eight blocks' chain's cycles
// and the chain's end.
extern "C" int sha256_cycles_launch(const void* msg, int len, void* out, void* cycles,
                                    int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  sha256_cycles_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const unsigned char*)msg, len, (uint4*)out, (long long*)cycles);
  return (int)cudaGetLastError();
}
