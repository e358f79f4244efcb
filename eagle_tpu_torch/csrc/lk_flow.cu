// Pyramidal Lucas-Kanade optical flow engine for Hopper (sm_90a).
//
// Replaces the TPU kernel eagle_tpu/ops/pallas_flow2.py::lk_flow_pallas2
// (its per-level Pallas kernel _make_level_kernel, launched once per
// pyramid level through pl.pallas_call), and computes what the JAX plain
// path eagle_tpu/ops/optical_flow.py::lk_flow computes: cv2
// calcOpticalFlowPyrLK with a 15x15 window, maxLevel 2, 10 iterations,
// eps 0.03.  For each point and level, coarse to fine: bilinear-sample the
// 17x17 previous patch, take its Scharr gradients and the 2x2 structure
// tensor (the point is ok only if det > 1e-6), then up to 10 Newton steps
// that sample the current patch, each point freezing once step^2 <= eps^2.
// Sampling positions are clamped to the point's level ROI (lk_flow's
// clamp), not to the TPU kernel's VMEM window.
//
// What bounds it on this card: latency.  At K = 57 points a frame needs
// ~5.5 M operations and under 1 MB of pyramid taps (per point and level the
// 18x18 taps under the previous patch and the union of the current patches
// its Newton steps sample): a fraction of a microsecond at full HBM or FP32
// rate, while each point walks three levels of up to 10 dependent Newton
// steps, each a block-wide reduction.
// The design keeps that chain short and on chip:
//  - one launch per frame covers all levels (the TPU's launch per level
//    becomes a loop inside the block);
//  - one block per point, 256 threads, one thread per patch tap;
//  - the 17x17 previous patch and its Scharr gradients live in shared
//    memory; current-level taps are 4-tap bilinear reads of the level ROI,
//    which stays in L1/L2 across the iterations;
//  - warp-shuffle reductions, one scalar thread for the 2x2 solve, and an
//    early exit once the point has frozen (the remaining steps are zero).
// The ROI pyramids are built by plain tensor ops outside (as the JAX
// package builds them outside its Pallas kernel), straight into one buffer:
// level-major, level l a (2, K, s_l, s_l) block of the K previous ROIs and
// then the K current ones, each s_l x s_l row-major.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// (no contraction of a*b+c: every product and sum rounds like the plain
// version's separate operations).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTaps = 1024;  // (window + 2)^2
constexpr int kMaxLevels = 4;

// Block-wide sum of N values per thread; thread 0 leaves the totals in
// out[0..N).  Every thread must call it.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* red, float* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[n] += __shfl_down_sync(0xffffffffu, v[n], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) red[warp * N + n] = v[n];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += red[w * N + n];
      out[n] = s;
    }
  }
  __syncthreads();
}

// Bilinear sample of an s x s ROI at (py, px), both clamped to [0, s-1]:
// the hat-function weights 1 - |p - g| of the two neighbouring grid
// lines, rows first, then columns.
__device__ __forceinline__ float sample(const float* roi, int s, float py, float px) {
  const float hi = (float)(s - 1);
  py = fminf(fmaxf(py, 0.f), hi);
  px = fminf(fmaxf(px, 0.f), hi);
  const float fy = floorf(py);
  const float fx = floorf(px);
  const int y0 = (int)fy;
  const int x0 = (int)fx;
  const int y1 = min(y0 + 1, s - 1);
  const int x1 = min(x0 + 1, s - 1);
  const float wy0 = 1.f - fabsf(py - fy);
  const float wy1 = fmaxf(0.f, 1.f - fabsf(py - (fy + 1.f)));
  const float wx0 = 1.f - fabsf(px - fx);
  const float wx1 = fmaxf(0.f, 1.f - fabsf(px - (fx + 1.f)));
  const float c0 = wy0 * roi[y0 * s + x0] + wy1 * roi[y1 * s + x0];
  const float c1 = wy0 * roi[y0 * s + x1] + wy1 * roi[y1 * s + x1];
  return c0 * wx0 + c1 * wx1;
}

__global__ void __launch_bounds__(kThreads)
lk_flow_kernel(const float* __restrict__ pyr, const float* __restrict__ pts,
               const float* __restrict__ origin, float* __restrict__ out_g,
               int* __restrict__ out_ok, int side, int levels, int window, int iterations,
               float epsilon) {
  __shared__ float s_pext[kMaxTaps];
  __shared__ float s_pi[kMaxTaps];
  __shared__ float s_gx[kMaxTaps];
  __shared__ float s_gy[kMaxTaps];
  __shared__ float s_red[kWarps * 3];
  __shared__ float s_sum[3];
  // g11, g12, g22, safe_det, g.x, g.y
  __shared__ float s_state[6];
  __shared__ int s_flags[2];  // invertible, done

  const int k = blockIdx.x;
  const long n_pts = gridDim.x;
  const int tid = threadIdx.x;
  const int ext = window + 2;
  const int n_ext = ext * ext;
  const int n_win = window * window;
  const float half = (float)(window - 1) * 0.5f;
  const float eps_sq = epsilon * epsilon;

  // level l is the (2, K, s_l, s_l) block [prev ROIs; curr ROIs] after the
  // blocks of the finer levels
  int sizes[kMaxLevels];
  long offs[kMaxLevels];
  {
    int s = side;
    long off = 0;
    for (int l = 0; l <= levels; ++l) {
      sizes[l] = s;
      offs[l] = off;
      off += 2 * n_pts * s * s;
      s = (s + 1) / 2;
    }
  }
  const float ptx = pts[2 * k];
  const float pty = pts[2 * k + 1];
  const float orx = origin[2 * k];
  const float ory = origin[2 * k + 1];

  const float sm[3] = {0.1875f, 0.625f, 0.1875f};  // Scharr smoothing / 16
  const float dv[3] = {-0.5f, 0.f, 0.5f};          // central difference / 2

  int ok = 1;
  if (tid == 0) {
    const float scale = (float)(1 << levels);
    s_state[4] = ptx / scale;
    s_state[5] = pty / scale;
  }

  for (int lvl = levels; lvl >= 0; --lvl) {
    const int s = sizes[lvl];
    const long roi = (long)s * s;
    const float* proi = pyr + offs[lvl] + k * roi;
    const float* croi = pyr + offs[lvl] + (n_pts + k) * roi;
    const float scale = (float)(1 << lvl);
    const float ox = orx / scale;
    const float oy = ory / scale;
    const float px = ptx / scale;
    const float py = pty / scale;
    if (tid == 0 && lvl < levels) {
      s_state[4] = s_state[4] * 2.f;
      s_state[5] = s_state[5] * 2.f;
    }

    // previous patch (ext x ext) around the point, then Scharr gradients
    const float sy = (py - oy) - (half + 1.f);
    const float sx = (px - ox) - (half + 1.f);
    for (int t = tid; t < n_ext; t += kThreads) {
      const int i = t / ext;
      const int j = t - i * ext;
      s_pext[t] = sample(proi, s, sy + (float)i, sx + (float)j);
    }
    __syncthreads();

    float acc[3] = {0.f, 0.f, 0.f};
    for (int t = tid; t < n_win; t += kThreads) {
      const int i = t / window;
      const int j = t - i * window;
      float gx = 0.f, gy = 0.f;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float rx = 0.f, ry = 0.f;
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          const float p = s_pext[(i + a) * ext + (j + b)];
          rx = rx + dv[b] * p;
          ry = ry + sm[b] * p;
        }
        gx = gx + sm[a] * rx;
        gy = gy + dv[a] * ry;
      }
      s_pi[t] = s_pext[(i + 1) * ext + (j + 1)];
      s_gx[t] = gx;
      s_gy[t] = gy;
      acc[0] += gx * gx;
      acc[1] += gx * gy;
      acc[2] += gy * gy;
    }
    block_sum<3>(acc, s_red, s_sum);
    if (tid == 0) {
      const float g11 = s_sum[0], g12 = s_sum[1], g22 = s_sum[2];
      const float det = g11 * g22 - g12 * g12;
      const int inv = det > 1e-6f;
      s_state[0] = g11;
      s_state[1] = g12;
      s_state[2] = g22;
      s_state[3] = inv ? det : 1.f;
      s_flags[0] = inv;
      s_flags[1] = 0;
    }
    __syncthreads();
    ok &= s_flags[0];

    // Newton iterations on the current level; a frozen (or singular)
    // point takes zero steps, so the loop may stop there
    for (int it = 0; it < iterations; ++it) {
      if (!s_flags[0] || s_flags[1]) break;
      const float cy = (s_state[5] - oy) - half;
      const float cx = (s_state[4] - ox) - half;
      float bb[2] = {0.f, 0.f};
      for (int t = tid; t < n_win; t += kThreads) {
        const int i = t / window;
        const int j = t - i * window;
        const float diff = sample(croi, s, cy + (float)i, cx + (float)j) - s_pi[t];
        bb[0] += diff * s_gx[t];
        bb[1] += diff * s_gy[t];
      }
      block_sum<2>(bb, s_red, s_sum);
      if (tid == 0) {
        const float b1 = s_sum[0], b2 = s_sum[1];
        const float g11 = s_state[0], g12 = s_state[1], g22 = s_state[2], d = s_state[3];
        const float dx = -(g22 * b1 - g12 * b2) / d;
        const float dy = -(-g12 * b1 + g11 * b2) / d;
        s_state[4] = s_state[4] + dx;
        s_state[5] = s_state[5] + dy;
        if (dx * dx + dy * dy <= eps_sq) s_flags[1] = 1;
      }
      __syncthreads();
    }
    __syncthreads();
  }

  if (tid == 0) {
    out_g[2 * k] = s_state[4];
    out_g[2 * k + 1] = s_state[5];
    out_ok[k] = ok;
  }
}

}  // namespace

// C interface for ctypes.  All pointers are device pointers; pyr is the
// packed float32 pyramid (level-major, see the kernel), pts/origin (K, 2)
// float32 (x, y), out_g (K, 2) float32, out_ok (K,) int32.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int lk_flow_levels(const float* pyr, const float* pts, const float* origin,
                              float* out_g, int* out_ok, int k, int side, int levels, int window,
                              int iterations, float epsilon, void* stream) {
  if (k <= 0) return 0;
  if (levels < 0 || levels >= kMaxLevels || (window + 2) * (window + 2) > kMaxTaps) {
    return (int)cudaErrorInvalidValue;
  }
  lk_flow_kernel<<<k, kThreads, 0, (cudaStream_t)stream>>>(
      pyr, pts, origin, out_g, out_ok, side, levels, window, iterations, epsilon);
  return (int)cudaGetLastError();
}
