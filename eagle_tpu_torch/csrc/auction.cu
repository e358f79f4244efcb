// The tracker's synchronous (Jacobi) auction for Hopper (sm_90a): every
// round of one assignment inside one block, the whole solve in one launch.
//
// Replaces eagle_tpu/ops/assignment.py::auction_assignment (:104-213), the
// rounds' lax.while_loop at :207, under masked_auction (:216).  It is not a
// Pallas kernel: XLA runs the loop as one device program with no host
// round trip, which eager torch cannot keep (its exit test is a host sync
// a round).  It computes what
// eagle_tpu_torch/ops/assignment.py::auction_rounds_plain computes, with the
// same float32 arithmetic and the same tie order, so the matches and the
// round counts are bit-equal:
//
//   - value = benefit - price, one rounded subtraction (__fsub_rn; the
//     file is also built with -fmad=false);
//   - a row's best column is its first maximum (the lowest index among
//     equal values, as lax.top_k and torch.argmax take it), and its second
//     value is the largest over every other column, so a tie gives gap 0;
//     a -inf second value gives gap 1; a row whose best value is -inf, or
//     whose row_ok is false, or which owns a column, does not bid;
//   - bid = (price[best] + gap) + eps, two rounded additions;
//   - a column goes to its highest bid, the lowest row among equal bids:
//     an atomicMax on a 64-bit key in shared memory, the bid's
//     order-preserving bits above the inverted row;
//   - the loop runs while some row bids and fewer than `iterations`
//     rounds have run (the JAX while_loop's cond), and counts its rounds.
//
// In: benefit (B, R, C + R) float32 contiguous (the C real columns, then a
// dummy column per row), row_ok (B, R) bool.  Out: match (B, R) int64, the
// real column of each row or -1; rounds (B,) int32, the bidding rounds
// run; and each block adds its rounds to a device-side int64 tally.  The
// values must not be NaN (the tracker's never are: an infeasible pair is
// -inf).
//
// What bounds it on this card: the rounds' serial chain, a few to a few
// hundred dependent rounds of one small matrix, not bytes (the 64 x 192
// float32 benefit, 48 KB, read once) nor operations (about 3 float32
// instructions a column for each bidding row a round).  So the design
// keeps a round short and its data on chip:
//
//   - one block (512 threads, 16 warps) a matrix, the grid is B;
//   - the benefit is staged once into shared memory when it fits with the
//     vectors (R * (C + R) * 4 B + 16 B a column + 8 B a row; 64 x 192 is
//     50,688 B, dynamic shared memory above 48 KB), else each round reads
//     it from global memory (L2-resident after the first round);
//   - a warp takes one bidding row at a time: its lanes scan the columns
//     (6 a lane at C + R = 192) keeping their first maximum and second
//     value, then five xor-shuffle steps merge them;
//   - three block barriers a round: after the bids, each thread settles
//     its columns (new owner, its price, the displaced row unassigned) and
//     clears the key; a barrier; the next round's any-row-bidding test is
//     a __syncthreads_or.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// float -> unsigned whose unsigned order is the float order
__device__ __forceinline__ unsigned ordered_bits(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered_bits(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// a row's best value v1 at column j1 (the lowest column on ties) and the
// best value v2 over every other column
struct Top2 {
  float v1;
  int j1;
  float v2;
};

__device__ __forceinline__ void merge(Top2& a, float bv1, int bj1, float bv2) {
  if (bv1 > a.v1 || (bv1 == a.v1 && bj1 < a.j1)) {
    a.v2 = fmaxf(a.v1, bv2);
    a.v1 = bv1;
    a.j1 = bj1;
  } else {
    a.v2 = fmaxf(a.v2, bv1);
  }
}

// dynamic shared memory: keys (ctot u64), price (ctot f32), owner (ctot
// i32), row_col (r i32), row_ok (r i32), then the benefit (r * ctot f32)
// on the shared path
__host__ __device__ inline size_t vector_bytes(int r, int ctot) {
  return (size_t)ctot * (8 + 4 + 4) + (size_t)r * (4 + 4);
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads) auction(const float* __restrict__ benefit,
                                                    const uint8_t* __restrict__ row_ok_in, int r, int ctot,
                                                    int c, int iterations, float eps,
                                                    long long* __restrict__ match, int* __restrict__ rounds_out,
                                                    unsigned long long* __restrict__ tally) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  float* price = reinterpret_cast<float*>(keys + ctot);
  int* owner = reinterpret_cast<int*>(price + ctot);
  int* row_col = owner + ctot;
  int* row_ok = row_col + r;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t mat = (size_t)r * ctot;
  const float* g_ben = benefit + (size_t)b * mat;
  const float* ben = g_ben;
  if (kShared) {
    float* s_ben = reinterpret_cast<float*>(row_ok + r);
    for (size_t e = tid; e < mat; e += kThreads) s_ben[e] = __ldg(g_ben + e);
    ben = s_ben;
  }
  for (int j = tid; j < ctot; j += kThreads) {
    keys[j] = 0ull;
    price[j] = 0.0f;
    owner[j] = -1;
  }
  for (int i = tid; i < r; i += kThreads) {
    row_col[i] = -1;
    row_ok[i] = row_ok_in[(size_t)b * r + i] != 0;
  }
  __syncthreads();

  int round = 0;
  for (;;) {
    int bidding = 0;
    for (int i = tid; i < r; i += kThreads) bidding |= row_ok[i] && row_col[i] < 0;
    // the while_loop's cond: (i < iterations) & any(row_ok & ~assigned)
    if (!__syncthreads_or(bidding) || round >= iterations) break;

    for (int i = warp; i < r; i += kWarps) {
      if (!row_ok[i] || row_col[i] >= 0) continue;  // warp-uniform
      Top2 t{-INFINITY, 0x7fffffff, -INFINITY};
      const float* row = ben + (size_t)i * ctot;
      for (int j = lane; j < ctot; j += 32) {
        const float v = __fsub_rn(row[j], price[j]);
        if (v > t.v1) {
          t.v2 = t.v1;
          t.v1 = v;
          t.j1 = j;
        } else {
          t.v2 = fmaxf(t.v2, v);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float bv1 = __shfl_xor_sync(kFull, t.v1, off);
        const int bj1 = __shfl_xor_sync(kFull, t.j1, off);
        const float bv2 = __shfl_xor_sync(kFull, t.v2, off);
        merge(t, bv1, bj1, bv2);
      }
      if (lane == 0 && t.v1 > -INFINITY && t.v1 < INFINITY) {
        const float gap = (t.v2 > -INFINITY && t.v2 < INFINITY) ? __fsub_rn(t.v1, t.v2) : 1.0f;
        const float bid = __fadd_rn(__fadd_rn(price[t.j1], gap), eps);
        const unsigned long long key =
            ((unsigned long long)ordered_bits(bid) << 32) | (unsigned long long)(0xffffffffu - (unsigned)i);
        atomicMax(keys + t.j1, key);
      }
    }
    __syncthreads();

    // each column takes its best bid; its previous owner (which did not
    // bid: it owned a column) is unassigned.  Winners are distinct rows
    // (a row bids on one column), so no two threads write one row_col.
    for (int j = tid; j < ctot; j += kThreads) {
      const unsigned long long key = keys[j];
      if (key) {
        const int winner = (int)(0xffffffffu - (unsigned)(key & 0xffffffffull));
        const int was = owner[j];
        if (was >= 0) row_col[was] = -1;
        owner[j] = winner;
        row_col[winner] = j;
        price[j] = from_ordered_bits((unsigned)(key >> 32));
        keys[j] = 0ull;
      }
    }
    ++round;
    __syncthreads();
  }

  for (int i = tid; i < r; i += kThreads) {
    const int j = row_col[i];
    match[(size_t)b * r + i] = (j >= 0 && j < c) ? (long long)j : -1ll;
  }
  if (tid == 0) {
    rounds_out[b] = round;
    atomicAdd(tally, (unsigned long long)round);
  }
}

// 1: the benefit staged in shared memory, 2: read from global memory, or
// -cudaError_t (the vectors alone do not fit in a block's shared memory)
int choose(int r, int ctot, size_t* bytes) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return -(int)e;
  const size_t vec = vector_bytes(r, ctot);
  const size_t full = vec + (size_t)r * ctot * 4;
  if (full <= (size_t)optin) {
    *bytes = full;
    return 1;
  }
  if (vec <= (size_t)optin) {
    *bytes = vec;
    return 2;
  }
  return -(int)cudaErrorInvalidValue;
}

}  // namespace

// The path a launch at (r, ctot) takes: 1 (benefit in shared memory), 2
// (read from global memory), or -cudaError_t.
extern "C" int auction_path(int r, int ctot) {
  size_t bytes = 0;
  return choose(r, ctot, &bytes);
}

// C interface for ctypes.  benefit: (b, r, ctot) float32 contiguous, row_ok:
// (b, r) bool, on the current device; match: (b, r) int64; rounds: (b,)
// int32; tally: one uint64.  Launches b blocks on `stream` on the path
// auction_path names, sets *taken to it, and returns cudaGetLastError() (0
// on success).
extern "C" int auction_launch(const float* benefit, const uint8_t* row_ok, int b, int r, int ctot, int c,
                              int iterations, float eps, long long* match, int* rounds,
                              unsigned long long* tally, void* stream, int* taken) {
  *taken = 0;
  if (b < 0 || r < 0 || c < 0 || ctot != c + r || iterations < 0) return (int)cudaErrorInvalidValue;
  if (b == 0 || r == 0) return 0;
  size_t dyn = 0;
  const int path = choose(r, ctot, &dyn);
  if (path < 0) return -path;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  void (*fn)(const float*, const uint8_t*, int, int, int, int, float, long long*, int*, unsigned long long*) =
      path == 1 ? auction<true> : auction<false>;
  // the opt-in above 48 KB, raised once a device and path to the largest asked
  static size_t attr_set[2][64] = {{0}};
  size_t& set = attr_set[path - 1][dev < 64 ? dev : 0];
  if (dyn > 48 * 1024 && (dev >= 64 || set < dyn)) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) set = dyn;
  }
  fn<<<b, kThreads, dyn, (cudaStream_t)stream>>>(benefit, row_ok, r, ctot, c, iterations, eps, match, rounds,
                                                 tally);
  e = cudaGetLastError();
  if (e == cudaSuccess) *taken = path;
  return (int)e;
}
