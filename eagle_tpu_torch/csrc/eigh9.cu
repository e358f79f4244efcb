// The DLT's eigen solve on the card (sm_90a): the eigenvector of the
// smallest eigenvalue of each symmetric 9x9 matrix of a batch.
//
// Replaces jnp.linalg.eigh in eagle_tpu/ops/homography.py::dlt_homography
// (:79), which XLA runs inside the JAX package's scan program.  It is not a
// Pallas kernel: torch.linalg.eigh on the card reads cuSOLVER's status back
// to the host after every call (a blocking copy, refused inside a captured
// CUDA graph), so the captured temporal step needs a solve of its own.  Its
// plain version is eagle_tpu_torch/ops/eigh.py::smallest_eigenvector_plain
// (torch.linalg.eigh, the lower triangle, the eigenvector of the first of
// the ascending eigenvalues); the two agree to rounding, up to the
// eigenvector's sign (a DLT divides the sign out).
//
// The method: cyclic Jacobi in float64 on the float32 input's lower
// triangle (mirrored), rotations in row order (p, q), p < q, skipped where
// the off-diagonal entry is negligible beside both diagonal entries, sweeps
// until a sweep rotates nothing (at most kMaxSweeps).  The float64
// arithmetic makes the result the eigenvector of the float32 matrix to
// float32 rounding, whatever its conditioning on the main path (the
// normalised DLT's normal equations).  The eigenvector of the smallest
// diagonal entry (the lowest index among equal ones) is written as
// float32.
//
// What bounds it on this card: the rotations' serial chain, ~36 dependent
// rotations a sweep over ~6-10 sweeps, not bytes (324 B in, 36 B out a
// matrix) nor operations (~9 x 12 float64 operations a rotation).  So the
// design: one warp a matrix, A and V in the warp's shared memory, lane k < 9
// updating row and column k of A and row k of V for each rotation (every
// lane computes the rotation itself from three shared values), two warp
// barriers a rotation; 4 warps a block.

#include <cuda_runtime.h>

namespace {

constexpr int kN = 9;
constexpr int kWarps = 4;
constexpr int kMaxSweeps = 30;

__global__ void __launch_bounds__(32 * kWarps) eigh9_smallest(const float* __restrict__ in, int batch,
                                                               float* __restrict__ out) {
  __shared__ double sa[kWarps][kN][kN];
  __shared__ double sv[kWarps][kN][kN];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= batch) return;  // a whole warp leaves together
  double(*A)[kN] = sa[warp];
  double(*V)[kN] = sv[warp];
  const float* m = in + (size_t)b * kN * kN;
  for (int idx = lane; idx < kN * kN; idx += 32) {
    const int i = idx / kN, j = idx % kN;
    A[i][j] = (double)(i >= j ? m[i * kN + j] : m[j * kN + i]);
    V[i][j] = i == j ? 1.0 : 0.0;
  }
  __syncwarp();

  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    bool rotated = false;
    for (int p = 0; p < kN - 1; ++p) {
      for (int q = p + 1; q < kN; ++q) {
        const double apq = A[p][q], app = A[p][p], aqq = A[q][q];
        const double g = 100.0 * fabs(apq);
        // negligible beside both diagonal entries (or zero): no rotation
        if (apq == 0.0 || (fabs(app) + g == fabs(app) && fabs(aqq) + g == fabs(aqq))) continue;
        rotated = true;
        const double theta = (aqq - app) / (2.0 * apq);
        double t = 1.0 / (fabs(theta) + sqrt(theta * theta + 1.0));
        if (theta < 0.0) t = -t;
        const double c = 1.0 / sqrt(t * t + 1.0), s = t * c;
        double akp = 0.0, akq = 0.0, vkp = 0.0, vkq = 0.0;
        if (lane < kN) {
          akp = A[lane][p];
          akq = A[lane][q];
          vkp = V[lane][p];
          vkq = V[lane][q];
        }
        __syncwarp();
        if (lane < kN) {
          if (lane != p && lane != q) {
            const double np = c * akp - s * akq, nq = s * akp + c * akq;
            A[lane][p] = np;
            A[p][lane] = np;
            A[lane][q] = nq;
            A[q][lane] = nq;
          }
          V[lane][p] = c * vkp - s * vkq;
          V[lane][q] = s * vkp + c * vkq;
          if (lane == 0) {
            A[p][p] = app - t * apq;
            A[q][q] = aqq + t * apq;
            A[p][q] = 0.0;
            A[q][p] = 0.0;
          }
        }
        __syncwarp();
      }
    }
    if (!rotated) break;  // the same decision in every lane
  }

  int best = 0;
  for (int i = 1; i < kN; ++i)
    if (A[i][i] < A[best][best]) best = i;
  if (lane < kN) out[(size_t)b * kN + lane] = (float)V[lane][best];
}

}  // namespace

// C interface for ctypes.  in: (batch, 9, 9) float32 contiguous on the
// current device (only the lower triangle is read); out: (batch, 9) float32.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int eigh9_launch(const float* in, int batch, float* out, void* stream) {
  if (batch < 0) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  eigh9_smallest<<<(batch + kWarps - 1) / kWarps, 32 * kWarps, 0, (cudaStream_t)stream>>>(in, batch, out);
  return (int)cudaGetLastError();
}
