// B3: inclusive prefix sums along chains of cached point additions, the
// within-block stage of the MSM's bucket scan. Replaces
// tendermint_tpu/crypto/tpu/pallas_field.py _scan_blocks_limbs_first
// (_scan_block_kernel). One warp walks one chain: it holds the running
// point in four registers per lane, reads each step's cached operand
// (coalesced, 4 x 128 bytes) and writes each prefix once.
//
// first:  4 x (C, 32)            first point of each chain
// cached: 4 x (S, C, 32)         cached operands for steps 1..S
// out:    4 x (C, S + 1, 32)     prefixes; prefix 0 is the first point
//
// C need not be a multiple of anything: a warp past the end returns.
#include "fe25519.cuh"
#include "launch.cuh"

__global__ void __launch_bounds__(128)
scan_blocks_kernel(const int* __restrict__ fx, const int* __restrict__ fy,
                   const int* __restrict__ fz, const int* __restrict__ ft,
                   const int* __restrict__ ymx, const int* __restrict__ ypx,
                   const int* __restrict__ t2d, const int* __restrict__ z2,
                   int* __restrict__ ox, int* __restrict__ oy,
                   int* __restrict__ oz, int* __restrict__ ot,
                   long long chains, int steps) {
  long long e = warp_element();
  if (e >= chains) return;
  int lane = threadIdx.x & 31;
  long long in = e * 32 + lane;
  int x = fx[in], y = fy[in], z = fz[in], t = ft[in];
  long long o = e * (steps + 1) * 32 + lane;
  ox[o] = x;
  oy[o] = y;
  oz[o] = z;
  ot[o] = t;
  for (int j = 0; j < steps; ++j) {
    long long c = ((long long)j * chains + e) * 32 + lane;
    fe::add_cached(x, y, z, t, ymx[c], ypx[c], t2d[c], z2[c], lane);
    o += 32;
    ox[o] = x;
    oy[o] = y;
    oz[o] = z;
    ot[o] = t;
  }
}

extern "C" int scan_blocks_launch(const void* fx, const void* fy,
                                  const void* fz, const void* ft,
                                  const void* ymx, const void* ypx,
                                  const void* t2d, const void* z2, void* ox,
                                  void* oy, void* oz, void* ot,
                                  long long chains, int steps, int device,
                                  void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  scan_blocks_kernel<<<blocks_for(chains), 32 * kWarpsPerBlock, 0,
                       (cudaStream_t)stream>>>(
      (const int*)fx, (const int*)fy, (const int*)fz, (const int*)ft,
      (const int*)ymx, (const int*)ypx, (const int*)t2d, (const int*)z2,
      (int*)ox, (int*)oy, (int*)oz, (int*)ot, chains, steps);
  return (int)cudaGetLastError();
}
