// Sparse linear assignment by successive shortest augmenting paths.
//
// Native engine for the MC64-equivalent orderings (jobs 4/5): the same
// algorithmic family as HSL MC64's HSLmc64WD (shortest augmenting paths with
// dual variables and a binary heap, reference/src/hslmc64.c:1917),
// implemented from the algorithm literature (Jonker & Volgenant 1987;
// Burkard, Dell'Amico & Martello, "Assignment Problems").  Mirrors the
// Python reference implementation in ordering/matching.py; the Python side
// cross-checks both against SciPy's LAPJVsp.
//
// C ABI for ctypes:
//   spike_assignment(n, col_ptr[n+1], row_ind[nnz], cost[nnz],
//                    match_out[n], u_out[n], v_out[n]) -> feasible (1/0)
//
// CSC orientation: column j has rows row_ind[col_ptr[j]:col_ptr[j+1]] with
// nonnegative finite costs.  On return reduced costs c - u_i - v_j >= 0
// everywhere and == 0 on matched entries (dual tightness yields the job-5
// scaling vectors).

#include <cstdint>
#include <limits>
#include <queue>
#include <utility>
#include <vector>

extern "C" {

int spike_assignment(int64_t n, const int64_t* col_ptr,
                     const int64_t* row_ind, const double* cost,
                     int64_t* match_out, double* u_out, double* v_out) {
  const double INF = std::numeric_limits<double>::infinity();
  std::vector<double> u(n, 0.0), v(n, 0.0);
  std::vector<int64_t> row_match(n, -1), col_match(n, -1);

  // column-minimum dual init + greedy tight matching
  for (int64_t j = 0; j < n; ++j) {
    double m = INF;
    for (int64_t t = col_ptr[j]; t < col_ptr[j + 1]; ++t)
      if (cost[t] < m) m = cost[t];
    if (m < INF) v[j] = m;
  }
  for (int64_t j = 0; j < n; ++j) {
    for (int64_t t = col_ptr[j]; t < col_ptr[j + 1]; ++t) {
      int64_t i = row_ind[t];
      if (col_match[j] < 0 && row_match[i] < 0 &&
          cost[t] - u[i] - v[j] <= 0.0) {
        row_match[i] = j;
        col_match[j] = i;
        break;
      }
    }
  }

  // 1-step augmentation over tight edges (the cheap-assignment phase of the
  // SAP family, cf. HSLmc64WD's pre-scan): for an unmatched column j with a
  // tight edge to a matched row i, try to re-route i's current column jm to
  // another tight unmatched row.  One O(nnz)-bounded pass that removes the
  // bulk of the remaining Dijkstra rounds on near-diagonal-dominant inputs.
  for (int64_t j = 0; j < n; ++j) {
    if (col_match[j] >= 0) continue;
    for (int64_t t = col_ptr[j]; t < col_ptr[j + 1] && col_match[j] < 0;
         ++t) {
      int64_t i = row_ind[t];
      if (cost[t] - u[i] - v[j] > 0.0) continue;
      int64_t jm = row_match[i];
      for (int64_t t2 = col_ptr[jm]; t2 < col_ptr[jm + 1]; ++t2) {
        int64_t i2 = row_ind[t2];
        if (row_match[i2] < 0 && cost[t2] - u[i2] - v[jm] <= 0.0) {
          row_match[i2] = jm;
          col_match[jm] = i2;
          row_match[i] = j;
          col_match[j] = i;
          break;
        }
      }
    }
  }

  std::vector<double> dist(n, INF);
  std::vector<int64_t> tree_col_of_row(n);
  std::vector<char> done(n, 0);
  std::vector<int64_t> finalized;
  finalized.reserve(n);
  // rows whose dist was set this round — resetting ONLY these keeps each
  // round O(reached) instead of O(n) (the full-vector std::fill made the
  // whole solve O(n * unmatched-after-greedy): 12 s at n=2e5, measured)
  std::vector<int64_t> touched;
  touched.reserve(1024);
  using QE = std::pair<double, int64_t>;
  std::priority_queue<QE, std::vector<QE>, std::greater<QE>> heap;
  bool feasible = true;

  for (int64_t j0 = 0; j0 < n; ++j0) {
    if (col_match[j0] >= 0) continue;
    for (int64_t i : touched) {
      dist[i] = INF;
      done[i] = 0;
    }
    touched.clear();
    finalized.clear();
    if (!heap.empty()) heap = decltype(heap)();

    for (int64_t t = col_ptr[j0]; t < col_ptr[j0 + 1]; ++t) {
      int64_t i = row_ind[t];
      double rc = cost[t] - u[i] - v[j0];
      if (rc < dist[i]) {
        if (dist[i] == INF) touched.push_back(i);
        dist[i] = rc;
        tree_col_of_row[i] = j0;
        heap.emplace(rc, i);
      }
    }

    int64_t end_row = -1;
    double D = INF;
    while (!heap.empty()) {
      auto [d, i] = heap.top();
      heap.pop();
      if (done[i] || d > dist[i]) continue;
      done[i] = 1;
      finalized.push_back(i);
      if (row_match[i] < 0) {
        end_row = i;
        D = d;
        break;
      }
      int64_t jm = row_match[i];
      for (int64_t t = col_ptr[jm]; t < col_ptr[jm + 1]; ++t) {
        int64_t i2 = row_ind[t];
        if (done[i2]) continue;
        double nd = d + cost[t] - u[i2] - v[jm];
        if (nd < dist[i2]) {
          if (dist[i2] == INF) touched.push_back(i2);
          dist[i2] = nd;
          tree_col_of_row[i2] = jm;
          heap.emplace(nd, i2);
        }
      }
    }
    if (end_row < 0) {
      feasible = false;
      continue;
    }
    // dual updates: reduced costs stay >= 0, matched edges stay tight
    v[j0] += D;
    for (int64_t i : finalized) {
      if (i == end_row) break;
      u[i] += dist[i] - D;
      v[row_match[i]] += D - dist[i];
    }
    // augment
    int64_t i = end_row;
    for (;;) {
      int64_t j = tree_col_of_row[i];
      int64_t prev = col_match[j];
      col_match[j] = i;
      row_match[i] = j;
      if (j == j0) break;
      i = prev;
    }
  }

  for (int64_t j = 0; j < n; ++j) {
    match_out[j] = col_match[j];
    u_out[j] = u[j];
    v_out[j] = v[j];
  }
  return feasible ? 1 : 0;
}

}  // extern "C"
