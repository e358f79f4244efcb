// The RANSAC draw of one temporal step on the card (sm_90a): the integer
// keys that order the Gumbel top-4 of every hypothesis.
//
// Replaces the draw that eagle_tpu/ops/homography.py::_sample_minimal_sets
// (:128) makes inside the JAX package's scan program:
// jax.random.gumbel(fold_in(key(seed), t), (iters, n)) and lax.top_k.  It is
// not a Pallas kernel: XLA makes the draw inside the device program from the
// step's t, and eager torch would upload a host draw a step (a host round
// trip the captured step cannot hold).
//
// JAX's gumbel is -log(-log(u)) of u = (bits >> 9) * 2^-23 (0 -> tiny): a
// strictly increasing map of the 23-bit integer bits >> 9.  The top 4 of a
// row are therefore fixed by those integers alone, ties included (equal
// keys give equal gumbels, and both orders take the lower index first), so
// this kernel writes the integers and no transcendental function runs.  It
// computes what eagle_tpu_torch/ops/prng.py::ransac_keys_plain computes,
// bit for bit:
//
//   - the step's key is threefry2x32 of the counter pair (0, t) under the
//     seed's key (0, seed) (jax.random.fold_in of jax.random.key(seed));
//   - element i of the (iters, n) draw, flat, is y0 ^ y1 of threefry2x32 of
//     the pair (i >> 32, i & 0xffffffff) under the step's key (JAX's
//     partitionable random-bits layout), shifted right by 9.
//
// t is read from a device scalar, so one launch a step fits inside a
// captured CUDA graph whose replays step t on the card.
//
// What bounds it on this card: nothing the main path can see.  29,184
// elements (512 x 57), two 20-round hashes each (~200 integer
// instructions), 117 KB written: ~0.2 us of instructions at the card's
// peak, less in bytes; a launch costs more.  So the design is the plainest:
// a thread an element, each hashing the step's key itself.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) { return (x << d) | (x >> (32 - d)); }

// Threefry-2x32, 20 rounds, of the pair (x0, x1) under the key (k0, k1).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

__global__ void ransac_keys(uint32_t seed, const long long* __restrict__ t, int total, int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  uint32_t f0 = 0, f1 = (uint32_t)(unsigned long long)(*t);
  threefry2x32(0u, seed, f0, f1);  // fold_in(key(seed), t)
  uint32_t x0 = 0, x1 = (uint32_t)i;
  threefry2x32(f0, f1, x0, x1);
  out[i] = (int)((x0 ^ x1) >> 9);
}

constexpr int kThreads = 256;

}  // namespace

// C interface for ctypes.  t: one int64 on the current device (the frame
// index; its low 32 bits are folded in); out: `total` int32 on the same
// device.  Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int ransac_keys_launch(unsigned int seed, const long long* t, int total, int* out, void* stream) {
  if (total < 0) return (int)cudaErrorInvalidValue;
  if (total == 0) return 0;
  ransac_keys<<<(total + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(seed, t, total, out);
  return (int)cudaGetLastError();
}
