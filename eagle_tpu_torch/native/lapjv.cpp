// Jonker-Volgenant linear assignment solver (dense, square), float64, on the
// host.
//
// The port's own copy of the JAX package's eagle_tpu/native/lapjv.cpp (the
// reference's lapx LAPJV role): the float64 optimum oracle that
// eagle_tpu_torch/csrc/lap_jv.cu (the float32 solver on the card) is held
// against, beside scipy's linear_sum_assignment, and a solver for offline
// batches.  Shortest-augmenting-path formulation with dual-variable updates.
//
// C ABI for ctypes: lapjv_solve(n, cost[n*n], row_to_col[n]) -> total cost;
// lapjv_solve_batch(m, n, costs[m*n*n], row_to_cols[m*n], totals[m]).

#include <cfloat>
#include <cstdint>
#include <vector>

extern "C" {

double lapjv_solve(int32_t n, const double* cost, int32_t* row_to_col) {
  // p[j] = row matched to column j (0 = free); 1-indexed with sentinel 0
  std::vector<double> u(n + 1, 0.0), v(n + 1, 0.0), minv(n + 1);
  std::vector<int32_t> p(n + 1, 0), way(n + 1, 0);
  std::vector<bool> used(n + 1);

  auto a = [&](int32_t i, int32_t j) -> double {
    return cost[(int64_t)(i - 1) * n + (j - 1)];
  };

  for (int32_t i = 1; i <= n; ++i) {
    p[0] = i;
    int32_t j0 = 0;
    std::fill(minv.begin(), minv.end(), DBL_MAX);
    std::fill(used.begin(), used.end(), false);
    do {
      used[j0] = true;
      int32_t i0 = p[j0], j1 = 0;
      double delta = DBL_MAX;
      for (int32_t j = 1; j <= n; ++j) {
        if (used[j]) continue;
        double cur = a(i0, j) - u[i0] - v[j];
        if (cur < minv[j]) {
          minv[j] = cur;
          way[j] = j0;
        }
        if (minv[j] < delta) {
          delta = minv[j];
          j1 = j;
        }
      }
      for (int32_t j = 0; j <= n; ++j) {
        if (used[j]) {
          u[p[j]] += delta;
          v[j] -= delta;
        } else {
          minv[j] -= delta;
        }
      }
      j0 = j1;
    } while (p[j0] != 0);
    do {
      int32_t j1 = way[j0];
      p[j0] = p[j1];
      j0 = j1;
    } while (j0);
  }

  double total = 0.0;
  for (int32_t j = 1; j <= n; ++j) {
    if (p[j] > 0) {
      row_to_col[p[j] - 1] = j - 1;
      total += a(p[j], j);
    }
  }
  return total;
}

// Batched variant: m independent n x n problems.
void lapjv_solve_batch(int32_t m, int32_t n, const double* costs,
                       int32_t* row_to_cols, double* totals) {
  for (int32_t k = 0; k < m; ++k) {
    totals[k] =
        lapjv_solve(n, costs + (int64_t)k * n * n, row_to_cols + (int64_t)k * n);
  }
}

}  // extern "C"
