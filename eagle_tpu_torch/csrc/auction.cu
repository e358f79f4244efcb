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
//   - the loop runs while some row with row_ok owns no column and fewer
//     than `iterations` rounds have run (the JAX while_loop's cond), and
//     counts its rounds.
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
// keeps the chain short:
//
//   - one block a matrix, the grid is B; the block reads row_ok first and
//     returns at once when no row can bid (or no round may run): such a
//     launch (the tracker's third stage, mostly) never reads the benefit;
//   - on chip (R <= 128, C + R <= 256): warp w owns rows w + nw s, s < RW,
//     and keeps them in registers, lane l holding columns l + 32 m, m < K
//     (RW, K templates; 64 x 192 is 32 warps x 2 rows x 6 columns), loaded
//     while the vectors are set up.  A warp with a bidding row scans all
//     its rows at once from registers (the K prices read once from shared
//     memory), merges each row's lanes in five xor-shuffle steps, and its
//     lane 0 places the bids;
//   - two block barriers a round: after the bids; then each thread settles
//     its column (blockDim >= C + R: new owner, its price, the displaced
//     row unassigned, the key cleared) and the next round's test is a
//     __syncthreads_count of the columns taken by a row that owned none,
//     which is how many rows stopped bidding;
//   - larger matrices: 512 threads, the benefit read from global memory
//     (L2-resident after the first round), a warp a bidding row, three
//     barriers a round.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGlobalThreads = 512;
constexpr unsigned kFull = 0xffffffffu;
// the on-chip path's largest matrix
constexpr int kMaxRows = 128;
constexpr int kMaxCols = 256;

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

// the next column j in ascending order, value v: selects, not branches (a
// branch a column, taken by some lanes, serialised the warp at each)
__device__ __forceinline__ void scan(Top2& t, float v, int j) {
  const bool gt = v > t.v1;
  t.v2 = gt ? t.v1 : fmaxf(t.v2, v);
  t.j1 = gt ? j : t.j1;
  t.v1 = gt ? v : t.v1;
}

__device__ __forceinline__ void merge(Top2& a, float bv1, int bj1, float bv2) {
  const bool b = bv1 > a.v1 || (bv1 == a.v1 && bj1 < a.j1);
  a.v2 = b ? fmaxf(a.v1, bv2) : fmaxf(a.v2, bv1);
  a.j1 = b ? bj1 : a.j1;
  a.v1 = b ? bv1 : a.v1;
}

__device__ __forceinline__ void merge_lanes(Top2& t) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float bv1 = __shfl_xor_sync(kFull, t.v1, off);
    const int bj1 = __shfl_xor_sync(kFull, t.j1, off);
    const float bv2 = __shfl_xor_sync(kFull, t.v2, off);
    merge(t, bv1, bj1, bv2);
  }
}

// row i's bid on its best column (lane 0 of the scanning warp)
__device__ __forceinline__ void place_bid(const Top2& t, int i, const float* price, float eps,
                                          unsigned long long* keys) {
  if (t.v1 > -INFINITY && t.v1 < INFINITY) {
    const float gap = (t.v2 > -INFINITY && t.v2 < INFINITY) ? __fsub_rn(t.v1, t.v2) : 1.0f;
    const float bid = __fadd_rn(__fadd_rn(price[t.j1], gap), eps);
    const unsigned long long key =
        ((unsigned long long)ordered_bits(bid) << 32) | (unsigned long long)(0xffffffffu - (unsigned)i);
    atomicMax(keys + t.j1, key);
  }
}

// column j takes its best bid, if any; its previous owner (which did not
// bid: it owned a column) is unassigned.  Winners are distinct rows (a row
// bids on one column), so no two threads write one row_col.  Returns
// whether a row that owned no column took it.
__device__ __forceinline__ bool settle(int j, unsigned long long* keys, float* price, int* owner, int* row_col) {
  const unsigned long long key = keys[j];
  if (!key) return false;
  const int winner = (int)(0xffffffffu - (unsigned)(key & 0xffffffffull));
  const int was = owner[j];
  if (was >= 0) row_col[was] = -1;
  owner[j] = winner;
  row_col[winner] = j;
  price[j] = from_ordered_bits((unsigned)(key >> 32));
  keys[j] = 0ull;
  return was < 0;
}

// dynamic shared memory: keys (ctot u64), price (ctot f32), owner (ctot
// i32), row_col (r i32), row_ok (r i32)
__host__ __device__ inline size_t vector_bytes(int r, int ctot) {
  return (size_t)ctot * (8 + 4 + 4) + (size_t)r * (4 + 4);
}

struct Vectors {
  unsigned long long* keys;
  float* price;
  int* owner;
  int* row_col;
  int* row_ok;
};

__device__ __forceinline__ Vectors carve(unsigned char* smem, int r, int ctot) {
  Vectors v;
  v.keys = reinterpret_cast<unsigned long long*>(smem);
  v.price = reinterpret_cast<float*>(v.keys + ctot);
  v.owner = reinterpret_cast<int*>(v.price + ctot);
  v.row_col = v.owner + ctot;
  v.row_ok = v.row_col + r;
  return v;
}

// Reads this matrix's row_ok into shared memory; returns the threads that
// hold a row that can bid (the rows that can bid, where a thread holds at
// most one row).  When none can (or no round may run) writes the result of
// no round and returns 0, block-uniformly, before the benefit is touched.
__device__ __forceinline__ int start(const uint8_t* __restrict__ row_ok_in, int r, int iterations, Vectors v,
                                     long long* __restrict__ match, int* __restrict__ rounds_out) {
  const int b = blockIdx.x, tid = threadIdx.x;
  int mine = 0;
  for (int i = tid; i < r; i += blockDim.x) {
    const int ok = row_ok_in[(size_t)b * r + i] != 0;
    v.row_ok[i] = ok;
    mine += ok;
  }
  const int n = __syncthreads_count(mine);
  if (n && iterations > 0) return n;
  for (int i = tid; i < r; i += blockDim.x) match[(size_t)b * r + i] = -1ll;
  if (tid == 0) rounds_out[b] = 0;
  return 0;
}

__device__ __forceinline__ void finish(int r, int c, int round, const int* row_col, long long* __restrict__ match,
                                       int* __restrict__ rounds_out, unsigned long long* __restrict__ tally) {
  const int b = blockIdx.x;
  for (int i = threadIdx.x; i < r; i += blockDim.x) {
    const int j = row_col[i];
    match[(size_t)b * r + i] = (j >= 0 && j < c) ? (long long)j : -1ll;
  }
  if (threadIdx.x == 0) {
    rounds_out[b] = round;
    if (round) atomicAdd(tally, (unsigned long long)round);
  }
}

// the on-chip path: RW rows a warp and K columns a lane in registers;
// blockDim.x = 32 nw >= max(R, C + R), nw * RW >= R
template <int K, int RW>
__global__ void __launch_bounds__(1024) auction_onchip(const float* __restrict__ benefit,
                                                       const uint8_t* __restrict__ row_ok_in, int r, int ctot,
                                                       int c, int iterations, float eps,
                                                       long long* __restrict__ match, int* __restrict__ rounds_out,
                                                       unsigned long long* __restrict__ tally) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Vectors v = carve(smem, r, ctot);
  int n_free = start(row_ok_in, r, iterations, v, match, rounds_out);  // rows with row_ok that own no column
  if (!n_free) return;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;

  // the rows in flight while the vectors are set up
  float ben[RW][K];
#pragma unroll
  for (int s = 0; s < RW; ++s) {
    const int i = warp + nw * s;
#pragma unroll
    for (int m = 0; m < K; ++m) {
      const int j = lane + 32 * m;
      ben[s][m] = (i < r && j < ctot) ? __ldg(benefit + ((size_t)b * r + i) * ctot + j) : -INFINITY;
    }
  }
  bool ok[RW];
#pragma unroll
  for (int s = 0; s < RW; ++s) ok[s] = warp + nw * s < r && v.row_ok[warp + nw * s];
  if (tid < ctot) {
    v.keys[tid] = 0ull;
    v.price[tid] = 0.0f;
    v.owner[tid] = -1;
  }
  if (tid < r) v.row_col[tid] = -1;
  __syncthreads();

  int round = 0;
  while (n_free > 0 && round < iterations) {
    bool bid[RW];
    bool any = false;
#pragma unroll
    for (int s = 0; s < RW; ++s) {
      bid[s] = ok[s] && v.row_col[warp + nw * s] < 0;  // warp-uniform
      any |= bid[s];
    }
    if (any) {
      // a column past C + R holds -inf at price 0: never a row's best, and
      // no change to its second value
      float p[K];
#pragma unroll
      for (int m = 0; m < K; ++m) p[m] = lane + 32 * m < ctot ? v.price[lane + 32 * m] : 0.0f;
      Top2 t[RW];
#pragma unroll
      for (int s = 0; s < RW; ++s) {
        t[s] = Top2{-INFINITY, 0x7fffffff, -INFINITY};
#pragma unroll
        for (int m = 0; m < K; ++m) scan(t[s], __fsub_rn(ben[s][m], p[m]), lane + 32 * m);
      }
#pragma unroll
      for (int s = 0; s < RW; ++s)
        if (bid[s]) merge_lanes(t[s]);
      if (lane == 0) {
#pragma unroll
        for (int s = 0; s < RW; ++s)
          if (bid[s]) place_bid(t[s], warp + nw * s, v.price, eps, v.keys);
      }
    }
    __syncthreads();
    const bool fresh = tid < ctot && settle(tid, v.keys, v.price, v.owner, v.row_col);
    n_free -= __syncthreads_count(fresh);
    ++round;
  }
  finish(r, c, round, v.row_col, match, rounds_out, tally);
}

// the global path: the benefit read from global memory, a warp a bidding row
__global__ void __launch_bounds__(kGlobalThreads) auction_global(const float* __restrict__ benefit,
                                                                 const uint8_t* __restrict__ row_ok_in, int r,
                                                                 int ctot, int c, int iterations, float eps,
                                                                 long long* __restrict__ match,
                                                                 int* __restrict__ rounds_out,
                                                                 unsigned long long* __restrict__ tally) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Vectors v = carve(smem, r, ctot);
  if (!start(row_ok_in, r, iterations, v, match, rounds_out)) return;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = kGlobalThreads / 32;
  const float* ben = benefit + (size_t)b * r * ctot;
  for (int j = tid; j < ctot; j += kGlobalThreads) {
    v.keys[j] = 0ull;
    v.price[j] = 0.0f;
    v.owner[j] = -1;
  }
  for (int i = tid; i < r; i += kGlobalThreads) v.row_col[i] = -1;
  __syncthreads();

  int round = 0;
  for (;;) {
    int bidding = 0;
    for (int i = tid; i < r; i += kGlobalThreads) bidding |= v.row_ok[i] && v.row_col[i] < 0;
    if (!__syncthreads_or(bidding) || round >= iterations) break;
    for (int i = warp; i < r; i += nw) {
      if (!v.row_ok[i] || v.row_col[i] >= 0) continue;  // warp-uniform
      Top2 t{-INFINITY, 0x7fffffff, -INFINITY};
      const float* row = ben + (size_t)i * ctot;
      for (int j = lane; j < ctot; j += 32) scan(t, __fsub_rn(__ldg(row + j), v.price[j]), j);
      merge_lanes(t);
      if (lane == 0) place_bid(t, i, v.price, eps, v.keys);
    }
    __syncthreads();
    for (int j = tid; j < ctot; j += kGlobalThreads) settle(j, v.keys, v.price, v.owner, v.row_col);
    ++round;
    __syncthreads();
  }
  finish(r, c, round, v.row_col, match, rounds_out, tally);
}

typedef void (*AuctionFn)(const float*, const uint8_t*, int, int, int, int, float, long long*, int*,
                          unsigned long long*);

// the on-chip instantiations: K columns a lane (1, 2, 4, 6, 8), RW rows a
// warp (1, 2, 4); R <= C + R <= 32 K, so RW <= K: 12 of them
constexpr int kCols[] = {1, 2, 4, 6, 8};
constexpr int kRows[] = {1, 2, 4};

template <int K>
AuctionFn onchip_fn(int rw) {
  return rw == 1 ? auction_onchip<K, 1> : rw == 2 ? auction_onchip<K, 2> : auction_onchip<K, 4>;
}

AuctionFn onchip(int k, int rw) {
  switch (k) {
    case 1: return auction_onchip<1, 1>;
    case 2: return rw == 1 ? auction_onchip<2, 1> : auction_onchip<2, 2>;
    case 4: return onchip_fn<4>(rw);
    case 6: return onchip_fn<6>(rw);
    default: return onchip_fn<8>(rw);
  }
}

// the smallest instantiation that holds (r, ctot): (K, RW), or (0, 0)
void onchip_shape(int r, int ctot, int* k, int* rw) {
  *k = *rw = 0;
  if (r > kMaxRows || ctot > kMaxCols) return;
  for (int kk : kCols)
    if (32 * kk >= ctot) {
      *k = kk;
      break;
    }
  for (int rr : kRows)
    if (32 * rr >= r) {
      *rw = rr;
      break;
    }
}

// 1: on chip (the rows in registers), 2: read from global memory, or
// -cudaError_t (the vectors alone do not fit in a block's shared memory)
int choose(int r, int ctot, size_t* bytes) {
  int k = 0, rw = 0;
  onchip_shape(r, ctot, &k, &rw);
  *bytes = vector_bytes(r, ctot);
  if (k) return 1;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return -(int)e;
  return *bytes <= (size_t)optin ? 2 : -(int)cudaErrorInvalidValue;
}

}  // namespace

// The path a launch at (r, ctot) takes: 1 (the rows in registers, on
// chip), 2 (read from global memory), or -cudaError_t.
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
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (path == 1) {
    int k = 0, rw = 0;
    onchip_shape(r, ctot, &k, &rw);
    const int rows_nw = (r + rw - 1) / rw, cols_nw = (ctot + 31) / 32;
    const int nw = rows_nw > cols_nw ? rows_nw : cols_nw;
    onchip(k, rw)<<<b, 32 * nw, dyn, s>>>(benefit, row_ok, r, ctot, c, iterations, eps, match, rounds, tally);
    e = cudaGetLastError();
  } else {
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    // the opt-in above 48 KB, raised once a device to the largest asked
    static size_t attr_set[64] = {0};
    if (dyn > 48 * 1024 && (dev >= 64 || attr_set[dev] < dyn)) {
      e = cudaFuncSetAttribute(auction_global, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
      if (e != cudaSuccess) return (int)e;
      if (dev < 64) attr_set[dev] = dyn;
    }
    auction_global<<<b, kGlobalThreads, dyn, s>>>(benefit, row_ok, r, ctot, c, iterations, eps, match, rounds,
                                                   tally);
    e = cudaGetLastError();
  }
  if (e == cudaSuccess) *taken = path;
  return (int)e;
}
