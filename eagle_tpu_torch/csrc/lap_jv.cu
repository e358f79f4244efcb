// Exact linear assignment for Hopper (sm_90a): the Jonker-Volgenant
// shortest-augmenting-path solver, one warp a matrix, the whole solve in
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
//   - j1 is the FIRST minimum of minv over the unused columns: a lane keeps
//     its first minimum in ascending j with a strict <, the warp takes the
//     least order-preserving key of the value, then the least j among the
//     lanes holding it;
//   - the dual updates u[p[j]] += delta, v[j] -= delta for used columns,
//     minv[j] -= delta for the others (each used column adds delta to its
//     own row once: the same float32 additions, no deferred "lazy" duals);
//     then the backtrack along way[].
//
// In: cost (B, n, n) float32, contiguous.  Out: row_to_col (B, n) int32,
// the column of each row.  The costs must be finite (as for the JAX
// solver); a matrix on which a step finds no finite unused column (an inf
// or NaN cost) is given -1 for every row instead of looping forever.
//
// What bounds it on this card: the serial chain of augmenting steps (about
// 10,000 a solve on the tracker's tie-heavy extended matrices at n = 192),
// not bytes (n^2 * 4 read once) nor operations (~5 float32 instructions a
// column a step).  With one warp on an SM nothing hides a step's latency,
// so the design shortens the step's dependent chain and its instructions:
//
//   - one warp (32 threads, the grid is B) solves one matrix: nothing in
//     the augmenting loop waits at a block barrier, and the loop has no
//     branch but its exit;
//   - lane l owns columns j = 1 + l + 32k, k < K = ceil(n / 32) (6 at
//     n = 192); the sentinel column 0 is kept apart (always used, never a
//     candidate: only the u of its row is tracked).  K is a template
//     parameter, the smallest instantiation covering n is launched, and
//     every loop over k is unrolled, so each column's v, minv, (j << 16) |
//     p[j], the u of its row while it is used, and the next row's cost
//     live in registers;
//   - a used column's minv is NaN: the strict < never improves it, the
//     argmin (which reads fminf(minv, inf)) never takes it, minv - delta
//     leaves it NaN, and a NaN test picks the columns whose v and u move;
//   - the lane's first minimum is a tree over k (the lower k wins a tie),
//     the warp's two __reduce_min_sync (redux): the least order-preserving
//     key of the value, then the least (j << 16) | p[j] among the lanes
//     holding it, which gives j1 and the next row p[j1] at once;
//   - the next row's u and costs are loaded before this step's dual
//     updates.  No shared word is written and read in one phase but way[]
//     (read by the backtrack after a __syncwarp): the u of a used column's
//     row is read by no step of the phase that updates it, so it is summed
//     in a register, by the same float32 additions in the same order as
//     the in-place update, and stored when the phase ends;
//   - u, p and way live in shared memory (read at a runtime index), and
//     the cost matrix too when it fits (n up to 239 on an H100: 228,484 +
//     2,880 B and the padding columns' slack), staged once by coalesced
//     loads, 32 in flight a lane.  Otherwise ("global" path) each step
//     reads row i0 from global memory (L2-resident).
//   - Above 32 columns a lane (n > 1024) the vectors would not fit in
//     registers: a second kernel keeps v and minv in shared memory (about
//     20 B a column: n up to ~11,600), still one warp a matrix with no
//     block barrier, and makes a step one pass over the columns, 8 at a
//     time in registers, that applies the previous step's dual update
//     before it takes this step's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// the order key of +inf: a lane with no finite unused column holds it
constexpr unsigned kKeyInf = 0xff800000u;

// an order-preserving uint32 key of a float that is not NaN; -0.0 is first
// made +0.0 (x + 0.0f under round-to-nearest), so the two tie as they do
// under <, and the lower column wins
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned b = __float_as_uint(__fadd_rn(x, 0.0f));
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// the float of a key (a -0.0 minimum comes back as +0.0; the sign of a zero
// delta changes only the signs of zero duals, never a comparison)
__device__ __forceinline__ float key_value(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// Copies nn floats from global g to shared s with the whole warp, 32 loads
// in flight a lane (coalesced: neighbouring lanes read neighbouring floats).
__device__ void stage(float* s, const float* __restrict__ g, size_t nn) {
  constexpr int kInFlight = 32;
  size_t k = threadIdx.x;
  for (; k + 32 * (kInFlight - 1) < nn; k += 32 * kInFlight) {
    float r[kInFlight];
#pragma unroll
    for (int t = 0; t < kInFlight; ++t) r[t] = __ldg(g + k + 32 * t);
#pragma unroll
    for (int t = 0; t < kInFlight; ++t) s[k + 32 * t] = r[t];
  }
  for (; k < nn; k += 32) s[k] = __ldg(g + k);
}

// ---- the parts both kernels share ------------------------------------------

// the augmenting path, back from the free column j0 (one lane)
__device__ __forceinline__ void backtrack(int* p, const int* way, int j0) {
  while (j0 != 0) {
    const int j1 = way[j0];
    p[j0] = p[j1];
    j0 = j1;
  }
}

__device__ __forceinline__ void write_out(const int* p, int n, bool failed, int* out) {
  const int lane = threadIdx.x;
  if (failed) {
    for (int r = lane; r < n; r += 32) out[r] = -1;
  } else {
    for (int j = lane + 1; j <= n; j += 32) out[p[j] - 1] = j - 1;
  }
}

// ---- the kernel: K columns a lane in registers ------------------------------

template <int K, bool kSharedCost>
__global__ void __launch_bounds__(32) lap_jv(const float* __restrict__ cost, int n, int* __restrict__ row_to_col) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int m = n + 1;
  const size_t nn = (size_t)n * n;
  const float* g_cost = cost + (size_t)blockIdx.x * nn;

  if constexpr (kSharedCost) stage(reinterpret_cast<float*>(smem), g_cost, nn);
  // row r's costs start at a + (r - 1) * n; a lane reads a[r][j] at offset
  // lane + 32k.  On the shared path the padding columns read up to 32K - n
  // floats past the last row, into the vectors and the slack behind them.
  const float* a = kSharedCost ? reinterpret_cast<const float*>(smem) : g_cost;
  float* u = reinterpret_cast<float*>(smem + (kSharedCost ? nn * 4 : 0));
  int* p = reinterpret_cast<int*>(u + m);
  int* way = p + m;
  for (int j = lane; j < m; j += 32) {
    u[j] = 0.0f;
    p[j] = 0;
    way[j] = 0;
  }

  // this lane's columns j = 1 + lane + 32k (the sentinel column 0 is apart:
  // always used, never a candidate, its v never read): their v; minv, NaN
  // for a used column (and a padding one, j > n), so that neither the
  // strict < nor the argmin takes it and minv - delta leaves it alone; for
  // a used column the u of its row, the same float32 additions as the
  // in-place update (no row's u is read in the phase that updates it: the
  // step reads u[i0] for an unused column's row); (j << 16) | p[j]; the
  // next row's costs
  float v[K], minv[K], uacc[K], x[K];
  unsigned jp[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = 0.0f;
    uacc[k] = 0.0f;
    x[k] = 0.0f;
    jp[k] = (unsigned)(1 + lane + 32 * k) << 16;
  }
  const int cols_left = n - lane;  // column k exists when 32k < cols_left
  __syncwarp();

  auto load_row = [&](int r) {
    const float* row = a + (size_t)(r - 1) * n + lane;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if constexpr (kSharedCost) {
        x[k] = row[32 * k];
      } else {
        if (32 * k < cols_left) x[k] = __ldg(row + 32 * k);
      }
    }
  };

  bool failed = false;
  for (int i = 1; i <= n; ++i) {
    if (lane == 0) p[0] = i;
#pragma unroll
    for (int k = 0; k < K; ++k) minv[k] = 32 * k < cols_left ? INFINITY : NAN;
    int j0 = 0;
    float ui0 = u[i];
    float u_col0 = ui0;  // u[p[0]] = u[i], column 0 used from the first step
    load_row(i);

    int i1;
    while (true) {
      // the reduced costs from row p[j0]; a column improves on a strict <
      float cand[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float cur = __fsub_rn(__fsub_rn(x[k], ui0), v[k]);
        const bool better = cur < minv[k];
        minv[k] = better ? cur : minv[k];
        if (better) way[1 + lane + 32 * k] = j0;
        cand[k] = fminf(minv[k], INFINITY);  // a used column: NaN -> inf
      }
      // the lane's first minimum: a tree over k in which the lower k wins a tie
      unsigned cj[K];
#pragma unroll
      for (int k = 0; k < K; ++k) cj[k] = jp[k];
#pragma unroll
      for (int s = 1; s < K; s *= 2) {
#pragma unroll
        for (int k = 0; k + s < K; k += 2 * s) {
          const bool lt = cand[k + s] < cand[k];
          cand[k] = lt ? cand[k + s] : cand[k];
          cj[k] = lt ? cj[k + s] : cj[k];
        }
      }
      // the warp's: the least key, then the least j among the lanes holding
      // it, which carries p[j1] in its low 16 bits
      const unsigned key = order_key(cand[0]);
      const unsigned kmin = __reduce_min_sync(kFull, key);
      if (kmin >= kKeyInf) {  // the same in every lane
        failed = true;
        break;
      }
      const unsigned win = __reduce_min_sync(kFull, key == kmin ? cj[0] : kFull);
      const int j1 = (int)(win >> 16);
      i1 = (int)(win & 0xffffu);
      const float delta = key_value(kmin);

      // the next step's row, before this step's dual updates (they touch
      // neither u[i1] nor the costs)
      const int r1 = i1 > 0 ? i1 : 1;
      const float ui1 = u[r1];
      load_row(r1);

      // the dual updates; then column j1, which the next step uses, is marked
      u_col0 = __fadd_rn(u_col0, delta);
      const int hit = j1 - 1 - lane;  // column j1 is this lane's k when hit == 32k
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (minv[k] != minv[k]) {  // used (a padding column too: harmless)
          uacc[k] = __fadd_rn(uacc[k], delta);
          v[k] = __fsub_rn(v[k], delta);
        }
        minv[k] = __fsub_rn(minv[k], delta);
        if (hit == 32 * k) {
          minv[k] = NAN;
          uacc[k] = ui1;
        }
      }
      j0 = j1;
      ui0 = ui1;
      if (i1 == 0) break;
    }
    if (failed) break;

    // the phase's u of the used rows, then the augmenting path
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int r = (int)(jp[k] & 0xffffu);
      if (minv[k] != minv[k] && r != 0) u[r] = uacc[k];
    }
    if (lane == 0) u[i] = u_col0;
    __syncwarp();  // way and u, visible to every lane
    if (lane == 0) backtrack(p, way, j0);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (32 * k < cols_left) jp[k] = (jp[k] & 0xffff0000u) | (unsigned)p[1 + lane + 32 * k];
    }
  }
  write_out(p, n, failed, row_to_col + (size_t)blockIdx.x * n);
}

// ---- the wide kernel: the column vectors in shared memory -------------------

// columns a lane the wide kernel holds in registers at once
constexpr int kChunk = 8;

// the columns k0 .. k0 + kChunk - 1 of a lane in the wide kernel: costs, v,
// minv, p and the u of the used ones' rows
struct Chunk {
  float x[kChunk], v[kChunk], mv[kChunk], u[kChunk];
  int p[kChunk];
};

// The same steps as lap_jv<K, false> for more than 32 columns a lane, in
// less shared memory than registers would need: a lane's v and minv at
// [32k + lane] of shared arrays, which no other lane touches, padded to
// whole chunks so that every load is in bounds.  A step is one pass over
// the lane's chunks with no branch inside a chunk: the next chunk is loaded
// before this one is computed and stored (their words differ), and the pass
// first applies the previous step's dual update (the same float32
// operations on each column as a pass of its own would, in the same order;
// u[p[j]] in place: no step reads the u of a used column's row), then takes
// this step's.  The phase's last update is applied after it.
__global__ void __launch_bounds__(32) lap_jv_wide(const float* __restrict__ cost, int n, int* __restrict__ row_to_col) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int m = n + 1;
  const int kp = ((n + 31) / 32 + kChunk - 1) / kChunk * kChunk;  // columns a lane, whole chunks
  const float* a = cost + (size_t)blockIdx.x * n * n;
  float* u = reinterpret_cast<float*>(smem);
  int* p = reinterpret_cast<int*>(u + m);  // 32 kp + 1 entries, like way
  int* way = p + 32 * kp + 1;
  float* v = reinterpret_cast<float*>(way + 32 * kp + 1);
  float* minv = v + 32 * kp;
  for (int j = lane; j < m; j += 32) u[j] = 0.0f;
  for (int j = lane; j <= 32 * kp; j += 32) {
    p[j] = 0;
    way[j] = 0;
  }
  for (int c = lane; c < 32 * kp; c += 32) {
    v[c] = 0.0f;
    minv[c] = NAN;  // a padding column stays NaN: never improved, never taken
  }
  const int cols_left = n - lane;  // column k exists when 32k < cols_left
  __syncwarp();

  auto load = [&](Chunk& c, const float* row, int k0) {
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      const int k = k0 + t, col = 32 * k + lane;
      c.x[t] = 32 * k < cols_left ? __ldg(row + 32 * k) : 0.0f;
      c.v[t] = v[col];
      c.mv[t] = minv[col];
      c.p[t] = p[1 + col];
    }
#pragma unroll
    for (int t = 0; t < kChunk; ++t) c.u[t] = u[c.mv[t] != c.mv[t] ? c.p[t] : 0];
  };

  bool failed = false;
  for (int i = 1; i <= n; ++i) {
    if (lane == 0) p[0] = i;
    for (int k = 0; 32 * k < cols_left; ++k) minv[32 * k + lane] = INFINITY;
    int j0 = 0;
    float ui0 = u[i];
    float u_col0 = ui0;  // u[p[0]] = u[i], column 0 used from the first step
    const float* row = a + (size_t)(i - 1) * n + lane;
    Chunk cur, nxt;
    load(nxt, row, 0);
    float delta = 0.0f;  // the previous step's (0: none yet, no column is used)
    int hit = -1;        // the previous step's j1 is this lane's column k when hit == 32k

    while (true) {
      float best = INFINITY;
      unsigned best_jp = kFull;
      for (int k0 = 0; k0 < kp; k0 += kChunk) {
        cur = nxt;
        if (k0 + kChunk < kp) load(nxt, row, k0 + kChunk);
        float cand[kChunk];
        unsigned cj[kChunk];
        bool upd[kChunk];
#pragma unroll
        for (int t = 0; t < kChunk; ++t) {
          const int k = k0 + t, col = 32 * k + lane;
          upd[t] = cur.mv[t] != cur.mv[t] && 32 * k < cols_left;  // used in the previous step
          cur.u[t] = upd[t] ? __fadd_rn(cur.u[t], delta) : cur.u[t];
          cur.v[t] = upd[t] ? __fsub_rn(cur.v[t], delta) : cur.v[t];
          cur.mv[t] = hit == 32 * k ? NAN : __fsub_rn(cur.mv[t], delta);
          const float c = __fsub_rn(__fsub_rn(cur.x[t], ui0), cur.v[t]);
          const bool better = c < cur.mv[t];
          cur.mv[t] = better ? c : cur.mv[t];
          if (better) way[1 + col] = j0;
          cand[t] = fminf(cur.mv[t], INFINITY);
          cj[t] = ((unsigned)(1 + col) << 16) | (unsigned)cur.p[t];
        }
        // the chunk's first minimum (the lower k wins a tie), then the pass's
        // (an earlier chunk wins a tie)
#pragma unroll
        for (int s = 1; s < kChunk; s *= 2) {
#pragma unroll
          for (int t = 0; t + s < kChunk; t += 2 * s) {
            const bool lt = cand[t + s] < cand[t];
            cand[t] = lt ? cand[t + s] : cand[t];
            cj[t] = lt ? cj[t + s] : cj[t];
          }
        }
        const bool lt = cand[0] < best;
        best = lt ? cand[0] : best;
        best_jp = lt ? cj[0] : best_jp;
#pragma unroll
        for (int t = 0; t < kChunk; ++t) {
          const int col = 32 * (k0 + t) + lane;
          minv[col] = cur.mv[t];
          v[col] = cur.v[t];
          if (upd[t]) u[cur.p[t]] = cur.u[t];
        }
      }
      const unsigned key = order_key(best);
      const unsigned kmin = __reduce_min_sync(kFull, key);
      if (kmin >= kKeyInf) {
        failed = true;
        break;
      }
      const unsigned win = __reduce_min_sync(kFull, key == kmin ? best_jp : kFull);
      const int j1 = (int)(win >> 16);
      const int i1 = (int)(win & 0xffffu);
      delta = key_value(kmin);
      u_col0 = __fadd_rn(u_col0, delta);
      hit = j1 - 1 - lane;
      j0 = j1;
      if (i1 == 0) break;
      // the next step's row: neither its u nor its costs change in this step
      ui0 = u[i1];
      row = a + (size_t)(i1 - 1) * n + lane;
      load(nxt, row, 0);
    }
    if (failed) break;

    // the last step's dual update of the used columns (column j1 is free)
    for (int k = 0; 32 * k < cols_left; ++k) {
      const int col = 32 * k + lane;
      if (minv[col] != minv[col]) {
        const int r = p[1 + col];
        u[r] = __fadd_rn(u[r], delta);
        v[col] = __fsub_rn(v[col], delta);
      }
    }
    if (lane == 0) u[i] = u_col0;
    __syncwarp();  // way and u, visible to every lane
    if (lane == 0) backtrack(p, way, j0);
    __syncwarp();
  }
  write_out(p, n, failed, row_to_col + (size_t)blockIdx.x * n);
}

// ---- choosing an instantiation ----------------------------------------------

using Kernel = void (*)(const float*, int, int*);

struct Variant {
  int k;  // columns a lane in registers; 0: the vectors in shared memory
  bool shared_cost;
  Kernel fn;
};

// in the order tried: the first whose K covers n + 1 columns and whose
// shared memory fits the block's opt-in limit is launched
const Variant kVariants[] = {
    {1, true, lap_jv<1, true>},     {2, true, lap_jv<2, true>},     {4, true, lap_jv<4, true>},
    {6, true, lap_jv<6, true>},     {8, true, lap_jv<8, true>},     {10, false, lap_jv<10, false>},
    {16, false, lap_jv<16, false>}, {32, false, lap_jv<32, false>}, {0, false, lap_jv_wide},
};
constexpr int kNumVariants = sizeof(kVariants) / sizeof(kVariants[0]);

size_t dynamic_bytes(const Variant& v, int n) {
  const size_t m = (size_t)n + 1;
  if (!v.k) {  // u; p, way, v, minv over whole chunks of columns a lane
    const size_t kp = (size_t)((n + 31) / 32 + kChunk - 1) / kChunk * kChunk;
    return 4 * m + 2 * 4 * (32 * kp + 1) + 2 * 4 * 32 * kp;
  }
  // u, p, way; on the shared path the cost and the padding columns' slack
  const size_t slack = 32 * v.k > n ? (size_t)(32 * v.k - n) * 4 : 0;
  return 3 * 4 * m + (v.shared_cost ? (size_t)n * n * 4 + slack : 0);
}

// the variant a launch at size n takes (its index) and its dynamic shared
// memory; 0, or a CUDA error
cudaError_t choose(int n, int* index, size_t* dyn) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const int cols = (n + 31) / 32;  // columns a lane: ceil(n / 32)
  for (int i = 0; i < kNumVariants; ++i) {
    const Variant& v = kVariants[i];
    if (v.k != 0 && v.k < cols) continue;
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, v.fn);
    if (e != cudaSuccess) return e;
    const size_t bytes = dynamic_bytes(v, n);
    if (bytes + attr.sharedSizeBytes <= (size_t)optin) {
      *index = i;
      *dyn = bytes;
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidValue;  // even the vectors exceed the block's shared memory
}

}  // namespace

// The path a launch at size n takes: 1 (cost staged in shared memory), 2
// (cost read from global memory), or -cudaError_t.
extern "C" int lap_jv_path(int n) {
  int index = 0;
  size_t bytes = 0;
  const cudaError_t e = choose(n, &index, &bytes);
  if (e != cudaSuccess) return -(int)e;
  return kVariants[index].shared_cost ? 1 : 2;
}

// The columns a lane holds in registers in the instantiation a launch at
// size n takes (0: the column vectors in shared memory), or -cudaError_t.
extern "C" int lap_jv_columns(int n) {
  int index = 0;
  size_t bytes = 0;
  const cudaError_t e = choose(n, &index, &bytes);
  if (e != cudaSuccess) return -(int)e;
  return kVariants[index].k;
}

// C interface for ctypes.  cost: (b, n, n) float32 contiguous on the current
// device; row_to_col: (b, n) int32.  Launches b warps (one block each) on
// `stream` in the instantiation lap_jv_columns(n) names, on the path
// lap_jv_path(n) names, sets *taken to that path, and returns
// cudaGetLastError() (0 on success).
extern "C" int lap_jv_launch(const float* cost, int b, int n, int* row_to_col, void* stream, int* taken) {
  *taken = 0;
  if (b < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (b == 0 || n == 0) return 0;
  int index = 0;
  size_t dyn = 0;
  cudaError_t e = choose(n, &index, &dyn);
  if (e != cudaSuccess) return (int)e;
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const Variant& v = kVariants[index];
  // the opt-in above 48 KB, raised once a device and variant to the largest asked
  static size_t attr_set[kNumVariants][64] = {{0}};
  if (dyn > 48 * 1024 && (dev >= 64 || attr_set[index][dev] < dyn)) {
    e = cudaFuncSetAttribute(v.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) attr_set[index][dev] = dyn;
  }
  v.fn<<<b, 32, dyn, (cudaStream_t)stream>>>(cost, n, row_to_col);
  e = cudaGetLastError();
  if (e == cudaSuccess) *taken = v.shared_cost ? 1 : 2;
  return (int)e;
}
