// Exact linear assignment for Hopper (sm_90a): the Jonker-Volgenant
// shortest-augmenting-path solver, one block a matrix, the whole solve in
// one launch.
//
// Replaces eagle_tpu/ops/assignment.py::solve_lap (:30-100), which is not a
// Pallas kernel but an XLA-compiled lax.fori_loop / lax.while_loop: the JAX
// package runs the whole solve as one device program with no host round
// trip, and this kernel is its counterpart on the card.  It computes what
// eagle_tpu_torch/ops/assignment.py::solve_lap_plain computes, with the same
// float32 arithmetic and the same tie order, so the indices are bit-equal:
//
//   - the classic 1-indexed layout with a sentinel column 0 (p[0] = the row
//     being inserted, minv[0] = -inf, column 0 used from the first step);
//   - cur = (a[i0][j] - u[i0]) - v[j], two separately rounded subtractions
//     (__fsub_rn; the file is also built with -fmad=false);
//   - a column improves only on a strict cur < minv[j];
//   - j1 is the FIRST minimum of minv over the unused columns (a block-wide
//     argmin over (value, index) that keeps the lower index on ties);
//   - the dual updates u[p[j]] += delta, v[j] -= delta for used columns,
//     minv[j] -= delta for the others; then the backtrack along way[].
//
// In: cost (B, n, n) float32, contiguous.  Out: row_to_col (B, n) int32,
// the column of each row.  The costs must be finite (as for the JAX
// solver); a matrix on which a step finds no finite unused column (an inf
// or NaN cost) is given -1 for every row instead of looping forever.
//
// Layout: one block of min(1024, ceil32(n + 1)) threads a matrix (the grid
// is B); thread t owns columns t, t + blockDim, ... of the n + 1 columns and
// keeps their u, v, minv, p, way and used flags in shared memory.  The
// cost matrix is staged into dynamic shared memory once when n^2 * 4 B plus
// the vectors fit in the block's opt-in limit (n = 192, the tracker's 64
// track slots + 128 detection slots, takes 147,456 B); otherwise each step
// reads row i0 from global memory (coalesced: neighbouring threads own
// neighbouring columns).  Both paths are one template.
//
// One augmenting step: each thread updates its columns' minv and way and
// takes its local first minimum; a warp-shuffle argmin, then warp 0 over
// the warps' results; thread 0 publishes j1 and delta; each thread applies
// the dual updates to its own columns (the u[p[j]] targets of the used
// columns are distinct rows, so there is no race, and the sentinel row 0 is
// never a target: the used columns are column 0, whose p is the row being
// inserted, and matched columns).  Three barriers a step.
//
// What bounds it on this card: the serial chain of augmenting steps, each
// one block-wide reduction (a few hundred cycles of shuffles and barriers),
// not bytes (n^2 * 4 read once) nor operations (~5 float32 instructions a
// column a step).  A matrix runs on one SM; B matrices run side by side.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// (value, index) argmin step: the lower value, the lower index on a tie
__device__ __forceinline__ void take_min(float& best, int& best_j, float v, int j) {
  if (v < best || (v == best && j < best_j)) {
    best = v;
    best_j = j;
  }
}

__device__ __forceinline__ void warp_argmin(float& best, int& best_j) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v = __shfl_down_sync(kFull, best, o);
    const int j = __shfl_down_sync(kFull, best_j, o);
    take_min(best, best_j, v, j);
  }
}

// bytes of the per-column vectors (u, v, minv, p, way, used) for n + 1 columns
__host__ __device__ inline size_t vector_bytes(int n) {
  const size_t m = (size_t)n + 1;
  return 5 * 4 * m + ((m + 15) / 16) * 16;
}

template <bool kSharedCost>
__global__ void __launch_bounds__(kMaxThreads) lap_jv(const float* __restrict__ cost, int n,
                                                      int* __restrict__ row_to_col) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red_val[32];
  __shared__ int red_idx[32];
  __shared__ float s_delta;
  __shared__ int s_j1;

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = nt >> 5;
  const int m = n + 1;
  const size_t nn = (size_t)n * n;
  const float* g_cost = cost + (size_t)blockIdx.x * nn;
  int* out = row_to_col + (size_t)blockIdx.x * n;

  size_t off = kSharedCost ? nn * 4 : 0;
  float* u = reinterpret_cast<float*>(smem + off);
  float* v = u + m;
  float* minv = v + m;
  int* p = reinterpret_cast<int*>(minv + m);
  int* way = p + m;
  unsigned char* used = reinterpret_cast<unsigned char*>(way + m);

  const float* a = g_cost;
  if (kSharedCost) {
    float* s_cost = reinterpret_cast<float*>(smem);
    for (size_t k = tid; k < nn; k += nt) s_cost[k] = g_cost[k];
    a = s_cost;
  }
  for (int j = tid; j < m; j += nt) {
    u[j] = 0.0f;
    v[j] = 0.0f;
    p[j] = 0;
    way[j] = 0;
  }
  __syncthreads();

  bool failed = false;
  for (int i = 1; i <= n && !failed; ++i) {
    for (int j = tid; j < m; j += nt) {
      minv[j] = j == 0 ? -INFINITY : INFINITY;
      used[j] = 0;
    }
    if (tid == 0) p[0] = i;
    __syncthreads();

    int j0 = 0;
    while (true) {
      // only the owner of a column reads or writes its used flag
      if (j0 % nt == tid) used[j0] = 1;
      const int i0 = p[j0];
      const float ui0 = u[i0];
      const float* row = a + (size_t)(i0 - 1) * n;  // row[j - 1] = a[i0][j]
      float best = INFINITY;
      int best_j = m;  // no column: a step with no finite unused column
      for (int j = tid; j < m; j += nt) {
        if (used[j]) continue;  // column 0 is used from the first step
        const float cur = __fsub_rn(__fsub_rn(row[j - 1], ui0), v[j]);
        if (cur < minv[j]) {
          minv[j] = cur;
          way[j] = j0;
        }
        if (minv[j] < best) {  // ascending j: strict keeps the first minimum
          best = minv[j];
          best_j = j;
        }
      }
      warp_argmin(best, best_j);
      if (lane == 0) {
        red_val[warp] = best;
        red_idx[warp] = best_j;
      }
      __syncthreads();
      if (warp == 0) {
        best = lane < nw ? red_val[lane] : INFINITY;
        best_j = lane < nw ? red_idx[lane] : m;
        warp_argmin(best, best_j);
        if (lane == 0) {
          s_j1 = best_j;
          s_delta = best;
        }
      }
      __syncthreads();
      const int j1 = s_j1;
      const float delta = s_delta;
      if (j1 >= m) {  // the same in every thread
        failed = true;
        break;
      }
      for (int j = tid; j < m; j += nt) {
        if (used[j]) {
          const int r = p[j];
          u[r] = __fadd_rn(u[r], delta);
          v[j] = __fsub_rn(v[j], delta);
        } else {
          minv[j] = __fsub_rn(minv[j], delta);
        }
      }
      __syncthreads();
      j0 = j1;
      if (p[j0] == 0) break;
    }
    if (failed) break;

    // the augmenting path, back from the free column j0
    if (tid == 0) {
      while (j0 != 0) {
        const int j1 = way[j0];
        p[j0] = p[j1];
        j0 = j1;
      }
    }
    __syncthreads();
  }

  if (failed) {
    for (int r = tid; r < n; r += nt) out[r] = -1;
  } else {
    for (int j = tid; j < m; j += nt) {
      if (j >= 1) out[p[j] - 1] = j - 1;
    }
  }
}

// one thread a column up to kMaxThreads, whole warps
int threads_for(int n) {
  const int t = (n + 1 + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

// 1 when the cost matrix is staged in shared memory, 2 when it is read from
// global memory, < 0 on a CUDA error
int choose_path(int n, size_t* dyn_bytes) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, lap_jv<true>);
  if (e != cudaSuccess) return -(int)e;
  const size_t shared_need = (size_t)n * n * 4 + vector_bytes(n);
  if (shared_need + attr.sharedSizeBytes <= (size_t)optin) {
    *dyn_bytes = shared_need;
    return 1;
  }
  *dyn_bytes = vector_bytes(n);
  return 2;
}

}  // namespace

// The path a launch at size n takes: 1 (cost staged in shared memory), 2
// (cost read from global memory), or -cudaError_t.
extern "C" int lap_jv_path(int n) {
  size_t bytes = 0;
  return choose_path(n, &bytes);
}

// C interface for ctypes.  cost: (b, n, n) float32 contiguous on the current
// device; row_to_col: (b, n) int32.  Launches b blocks on `stream` on the
// path lap_jv_path(n) picks, sets *taken to it, and returns
// cudaGetLastError() (0 on success).
extern "C" int lap_jv_launch(const float* cost, int b, int n, int* row_to_col, void* stream, int* taken) {
  *taken = 0;
  if (b < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (b == 0 || n == 0) return 0;
  size_t dyn = 0;
  const int path = choose_path(n, &dyn);
  if (path < 0) return -path;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  // the opt-in above 48 KB, raised once a device and path to the largest asked
  static size_t attr_set[2][64] = {{0}};
  if (dyn > 48 * 1024 && (dev >= 64 || attr_set[path - 1][dev] < dyn)) {
    e = path == 1 ? cudaFuncSetAttribute(lap_jv<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn)
                  : cudaFuncSetAttribute(lap_jv<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) attr_set[path - 1][dev] = dyn;
  }
  const int threads = threads_for(n);
  if (path == 1) {
    lap_jv<true><<<b, threads, dyn, (cudaStream_t)stream>>>(cost, n, row_to_col);
  } else {
    lap_jv<false><<<b, threads, dyn, (cudaStream_t)stream>>>(cost, n, row_to_col);
  }
  e = cudaGetLastError();
  if (e == cudaSuccess) *taken = path;
  return (int)e;
}
