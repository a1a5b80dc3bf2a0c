// B3: inclusive prefix sums along chains of cached point additions, the
// within-block stage of the MSM's bucket scan. Replaces
// tendermint_tpu/crypto/tpu/pallas_field.py _scan_blocks_limbs_first
// (_scan_block_kernel).
//
// first:  4 x (C, 32)            first point of each chain
// cached: 4 x (S, C, 32)         cached operands for steps 1..S
// out:    4 x (C, S + 1, 32)     prefixes; prefix 0 is the first point
//
// Arithmetic: the plain version's (msm._add_cached_plain), which is the
// reference's lax.scan of curve.add_cached. Its `sub` adds the
// reference's EIGHT_P, which is zero (int_to_limbs reduces p to 0), and
// runs two carry passes; `add` runs one. The Pallas kernel adds the true
// 8p ([1896, 2040 x 30, 1016]): equal mod p, other limbs. So limbs go
// below zero, and fe25519_group.cuh's multiply takes them. Bounds, by
// interval arithmetic over the plain version's passes (arithmetic
// shifts), for limbs in [-511, 511]: a + b after its pass lies in
// [-152, 369], a - b after its two in [-38, 293], and a product after its
// four in [-38, 293]. So with the first points and the cached operands
// within |limb| <= 511, every operand of every multiply of a chain is
// too: the range in which the FP32 convolution is exact.
//
// Mapping. A step (curve.add_cached) is two rounds of four independent
// multiplies: a = (y - x) ymx, b = (y + x) ypx, c = t t2d, d = z z2, then
// x' = e f, y' = g h, z' = f g, t' = e h with e = b - a, f = d - c,
// g = d + c, h = b + a. Sixteen lanes own one chain, as four groups of
// fe25519_group.cuh's four lanes, and each group runs one multiply of
// each round: group n keeps coordinate n of the running point in
// registers (eight limbs per lane) and computes, in order, a or b or d or
// c, then e or h or f or g, each one add or sub, then its new coordinate.
// The groups meet through rows in shared memory: the coordinates x and
// y, the four products, e to h. A warp walks two chains, and a block is
// that one warp. Against four lanes per chain running all four
// multiplies of a round, this issues about as many instructions per
// chain but from four times as many warps, each a quarter as long: the
// A-side call's 512 chains fill 256 of the card's 528 schedulers instead
// of 64, and the R side's 8,192 give each scheduler several warps to
// hide one another's latencies. A step costs 16 __syncwarp()s.
//
// What bounds it on an H100: bytes, barely (a chain moves 16 KB for
// ~316k operations; see chip_smoke.py). So the copies overlap the
// arithmetic: while a step computes, 16-byte cp.async copies bring the
// next step's cached rows of the warp's two chains (4 x 256 bytes,
// contiguous per coordinate) into the other half of a double buffer in
// shared memory, where the group that uses a row turns its own limbs of
// it into floats in place. Each group stores its coordinate of every
// prefix with 16-byte stores straight from registers.
//
// C need not be a multiple of anything: the lanes of a chain past the
// end compute on a stand-in (chain 0's first point, zero-filled cached
// rows) and store nothing, since every lane must reach every
// __syncwarp().
#include "fe25519_group.cuh"
#include "launch.cuh"

namespace {

constexpr int kChains = 2;   // chains per warp = per block
constexpr int kGroups = 4;   // lane groups per chain, one multiply each per round
constexpr int kCoords = 4;
constexpr int kThreads = kChains * kGroups * feg::kLanes;  // one warp
constexpr int kChunks = feg::kLimbs / 4;                   // 16-byte chunks per row

// One chain's rows in shared memory, kRow words apart.
struct ChainRows {
  int pq[kGroups][feg::kRow];                // the coordinates, then the products
  float ops[kGroups][feg::kRow];             // each group's published multiply operand
  int cached[2][kCoords][feg::kRow];         // double buffer: one step's cached rows
};

struct Smem {
  ChainRows chain[kChains];
  int carry[kChains][kGroups][feg::kCarryWords];  // each group's carry words
};

// One of four values by a run-time index, without an indexed local array
// (which nvcc would put in local memory).
template <class T>
__device__ __forceinline__ T pick(int i, T v0, T v1, T v2, T v3) {
  return i == 0 ? v0 : (i == 1 ? v1 : (i == 2 ? v2 : v3));
}

// Start copying step j's cached rows of chains [e0, e0 + 2) into buffer
// b: per coordinate the two chains' rows, 256 contiguous bytes, 16
// chunks of 16 bytes; lanes 0-15 take coordinate 2c, lanes 16-31
// coordinate 2c + 1, for c = 0, 1.
__device__ __forceinline__ void prefetch(Smem& s, int b, const int* const (&cached)[kCoords],
                                         long long chains, long long e0, int j, int lane) {
  const int h = (lane / kChunks) % kChains, part = lane % kChunks, half = lane / (kThreads / 2);
  const bool valid = e0 + h < chains;
  const long long row = ((long long)j * chains + (valid ? e0 + h : 0)) * feg::kLimbs + 4 * part;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int k = 2 * c + half;
    const int* src = half ? cached[2 * c + 1] : cached[2 * c];
    cp_async16(&s.chain[h].cached[b][k][4 * part], src + row, valid);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kThreads)
scan_blocks_kernel(const int* __restrict__ fx, const int* __restrict__ fy,
                   const int* __restrict__ fz, const int* __restrict__ ft,
                   const int* __restrict__ ymx, const int* __restrict__ ypx,
                   const int* __restrict__ t2d, const int* __restrict__ z2,
                   int* __restrict__ ox, int* __restrict__ oy, int* __restrict__ oz,
                   int* __restrict__ ot, long long chains, int steps) {
  __shared__ __align__(16) Smem s;
  const int lane = threadIdx.x, q = lane % feg::kLanes;
  const int g = (lane / feg::kLanes) % kGroups, h = lane / (feg::kLanes * kGroups);
  const long long e0 = (long long)blockIdx.x * kChains, e = e0 + h;
  const bool live = e < chains;
  const int* const cached[kCoords] = {ymx, ypx, t2d, z2};
  int* const out = pick(g, ox, oy, oz, ot);
  const feg::Lane l = feg::make_lane(q);
  int* const words = s.carry[h][g];
  ChainRows& r = s.chain[h];

  // Round 1: group 0 multiplies y - x by ymx, 1 y + x by ypx, 2 its z by
  // z2, 3 its t by t2d (the cached row k1). Round 2: group n publishes e,
  // h, f, g (n = 0..3): the add or sub of products `lead` and `other`
  // (rows of pq: 0 a, 1 b, 2 d, 3 c); then x = e f, y = g h, z = f g,
  // t = e h from operand rows o2a and o2b.
  const int k1 = g == 2 ? 3 : (g == 3 ? 2 : g);
  const bool sub_a = g == 0, sub_b = (g & 1) == 0;
  const int lead = g < 2 ? 1 : 2, other = g < 2 ? 0 : 3;
  const int o2a = g == 1 ? 3 : (g == 2 ? 2 : 0), o2b = g == 0 ? 2 : (g == 2 ? 3 : 1);

  if (steps > 0) prefetch(s, 0, cached, chains, e0, 0, lane);

  // this group's coordinate of the running point
  feg::Fe p = feg::load(pick(g, fx, fy, fz, ft) + (live ? e : 0) * feg::kLimbs, q);
  long long o = (live ? e : 0) * (steps + 1) * (long long)feg::kLimbs;
  if (live) feg::store(out + o, p, q);

#pragma unroll 1
  for (int j = 0; j < steps; ++j) {
    const int b = j & 1;
    if (j + 1 < steps) {
      prefetch(s, b ^ 1, cached, chains, e0, j + 1, lane);
    } else {
      cp_async_commit();  // an empty group, so that the wait below waits for step j
    }
    cp_async_wait<1>();  // this lane's copies of step j have landed
    feg::store(r.pq[g], p, q);
    // makes the coordinates, and every lane's copies of step j, visible
    __syncwarp();

    feg::to_float_row(r.cached[b][k1], q);
    const feg::Fe yx =
        feg::add_or_sub(l, words, feg::load(r.pq[1], q), feg::load(r.pq[0], q), sub_a);
    feg::publish(r.ops[g], feg::select(g < 2, yx, p), q);
    __syncwarp();
    const feg::Fe prod =
        feg::mul_rows(l, words, r.ops[g], reinterpret_cast<const float*>(r.cached[b][k1]));

    feg::store(r.pq[g], prod, q);
    __syncwarp();
    const feg::Fe efgh =
        feg::add_or_sub(l, words, feg::load(r.pq[lead], q), feg::load(r.pq[other], q), sub_b);
    feg::publish(r.ops[g], efgh, q);
    __syncwarp();
    p = feg::mul_rows(l, words, r.ops[o2a], r.ops[o2b]);

    o += feg::kLimbs;
    if (live) feg::store(out + o, p, q);
  }
}

}  // namespace

extern "C" int scan_blocks_launch(const void* fx, const void* fy, const void* fz,
                                  const void* ft, const void* ymx, const void* ypx,
                                  const void* t2d, const void* z2, void* ox, void* oy, void* oz,
                                  void* ot, long long chains, int steps, int device,
                                  void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  unsigned blocks = (unsigned)((chains + kChains - 1) / kChains);
  scan_blocks_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)fx, (const int*)fy, (const int*)fz, (const int*)ft, (const int*)ymx,
      (const int*)ypx, (const int*)t2d, (const int*)z2, (int*)ox, (int*)oy, (int*)oz, (int*)ot,
      chains, steps);
  return (int)cudaGetLastError();
}
