// Bottleneck bipartite matching via the MC64 job-3 strategy: per-column
// weight sort, threshold bisection over the distinct weights, and
// REPEATED MAX-MATCHING REUSE — each probe warm-starts from the best
// feasible matching found at a lower threshold, keeps the matched edges
// that survive the new threshold, and re-augments only the broken columns
// with a Kuhn augmenting DFS over the admissible per-column prefixes.
//
// Native engine for ordering/matching.py:bottleneck_match_sorted (the
// Python implementation is the reference/fallback).  Mirrors the phase
// structure of the reference's sort (mc64RD reference/src/
// hslmc64.c:4294) + bisection (HSLmc64SD :1432) + repeated-max-matching
// (HSLmc64UD :1698) family; implemented from the algorithm literature
// (Duff & Koster 2001), not translated from the f2c source.
//
// C ABI:
//   spike_bottleneck_sorted(n, col_ptr[n+1], row_ind[nnz], weights[nnz],
//                           match_out[n], best_t_out) -> feasible (1/0)
// match_out[j] = row matched to column j, or -1.  On a structurally
// singular matrix, returns 0 with the best-effort matching at the
// smallest threshold and *best_t_out = 0.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {
constexpr int64_t NIL = -1;
}

extern "C" {

int spike_bottleneck_sorted(int64_t n, const int64_t* col_ptr,
                            const int64_t* row_ind, const double* weights,
                            int64_t* match_out, double* best_t_out) {
  const int64_t nnz = col_ptr[n];

  // Per-column adjacency sorted by weight descending: the admissible edges
  // at threshold t are then a prefix of each column's list (mc64RD's sort).
  std::vector<int64_t> rows_s(nnz);
  std::vector<double> w_s(nnz);
  {
    std::vector<int64_t> order;
    for (int64_t j = 0; j < n; ++j) {
      const int64_t s = col_ptr[j], e = col_ptr[j + 1];
      order.resize(e - s);
      for (int64_t k = 0; k < e - s; ++k) order[k] = s + k;
      std::stable_sort(order.begin(), order.end(),
                       [&](int64_t a, int64_t b) {
                         return weights[a] > weights[b];
                       });
      for (int64_t k = 0; k < e - s; ++k) {
        rows_s[s + k] = row_ind[order[k]];
        w_s[s + k] = weights[order[k]];
      }
    }
  }

  // Distinct weights, ascending (the bisection domain).
  std::vector<double> vals(weights, weights + nnz);
  std::sort(vals.begin(), vals.end());
  vals.erase(std::unique(vals.begin(), vals.end()), vals.end());
  if (vals.empty()) {
    for (int64_t j = 0; j < n; ++j) match_out[j] = NIL;
    *best_t_out = 0.0;
    return n == 0 ? 1 : 0;
  }

  std::vector<int64_t> col_match(n, NIL);   // column -> row
  std::vector<int64_t> row_match(n, NIL);   // row -> column
  std::vector<double> matched_w(n, 0.0);    // weight of column j's edge
  std::vector<int64_t> ends(n);             // admissible prefix end per col
  std::vector<int64_t> dist(n), queue(n), it(n);
  std::vector<int64_t> st_col(n + 1);
  std::vector<double> taken_w(n + 1);
  constexpr int64_t INF = std::numeric_limits<int64_t>::max();

  auto active_ends = [&](double t) {
    for (int64_t j = 0; j < n; ++j) {
      const double* s = w_s.data() + col_ptr[j];
      const double* e = w_s.data() + col_ptr[j + 1];
      // w_s descending; admissible prefix = entries >= t
      ends[j] = col_ptr[j] +
                (std::partition_point(s, e, [&](double w) { return w >= t; }) -
                 s);
    }
  };

  // One Hopcroft-Karp DFS from free column j0 along the current BFS
  // layering, over the admissible prefixes; flips the path and records
  // the matched edge weights on success.
  auto dfs = [&](int64_t j0) -> bool {
    int64_t top = 0;
    st_col[0] = j0;
    it[j0] = col_ptr[j0];
    while (top >= 0) {
      const int64_t j = st_col[top];
      bool advanced = false;
      while (it[j] < ends[j]) {
        const int64_t t = it[j]++;
        const int64_t i = rows_s[t];
        const int64_t j2 = row_match[i];
        if (j2 == NIL) {
          // free row: unwind, flipping the alternating path
          taken_w[top] = w_s[t];
          int64_t cur = i;
          for (int64_t d = top; d >= 0; --d) {
            const int64_t jd = st_col[d];
            const int64_t prev = col_match[jd];
            col_match[jd] = cur;
            row_match[cur] = jd;
            matched_w[jd] = taken_w[d];
            cur = prev;   // row freed by jd (NIL for the path start)
          }
          return true;
        }
        if (dist[j2] == dist[j] + 1) {
          taken_w[top] = w_s[t];
          st_col[++top] = j2;
          it[j2] = col_ptr[j2];
          advanced = true;
          break;
        }
      }
      if (!advanced) {
        dist[j] = INF;   // dead end: prune from this phase
        --top;
      }
    }
    return false;
  };

  // Feasibility of threshold t, warm-started from the current matching
  // (HSLmc64UD's repeated-max-matching reuse): matched edges surviving the
  // threshold are kept; the broken columns are re-augmented with
  // Hopcroft-Karp phases.  One failed BFS proves global infeasibility, and
  // since a failed probe's state is discarded (restore_best below), the
  // probe exits at the first phase that strands a free column.
  auto probe = [&](double t) -> bool {
    active_ends(t);
    for (int64_t j = 0; j < n; ++j) {
      if (col_match[j] != NIL && matched_w[j] < t) {
        row_match[col_match[j]] = NIL;
        col_match[j] = NIL;
      }
    }
    while (true) {
      // BFS layering from the free columns
      int64_t qh = 0, qt = 0;
      for (int64_t j = 0; j < n; ++j) {
        if (col_match[j] == NIL) {
          dist[j] = 0;
          queue[qt++] = j;
        } else {
          dist[j] = INF;
        }
      }
      if (qt == 0) return true;
      bool found = false;
      while (qh < qt) {
        const int64_t j = queue[qh++];
        for (int64_t t2 = col_ptr[j]; t2 < ends[j]; ++t2) {
          const int64_t j2 = row_match[rows_s[t2]];
          if (j2 == NIL) {
            found = true;
          } else if (dist[j2] == INF) {
            dist[j2] = dist[j] + 1;
            queue[qt++] = j2;
          }
        }
      }
      if (!found) return false;
      for (int64_t j = 0; j < n; ++j) {
        if (col_match[j] == NIL) dfs(j);
      }
    }
  };

  std::vector<int64_t> best_match(n), best_row(n);
  std::vector<double> best_w(n);
  double best_t = 0.0;
  auto save_best = [&](double t) {
    best_match = col_match;
    best_row = row_match;
    best_w = matched_w;
    best_t = t;
  };
  auto restore_best = [&]() {
    col_match = best_match;
    row_match = best_row;
    matched_w = best_w;
  };

  if (!probe(vals[0])) {
    // structurally singular: best effort at the smallest threshold
    std::memcpy(match_out, col_match.data(), n * sizeof(int64_t));
    *best_t_out = 0.0;
    return 0;
  }
  save_best(vals[0]);

  int64_t lo = 1, hi = static_cast<int64_t>(vals.size()) - 1;
  while (lo <= hi) {
    const int64_t mid = (lo + hi) / 2;
    if (probe(vals[mid])) {
      save_best(vals[mid]);
      lo = mid + 1;
    } else {
      restore_best();
      hi = mid - 1;
    }
  }

  std::memcpy(match_out, best_match.data(), n * sizeof(int64_t));
  *best_t_out = best_t;
  return 1;
}

}  // extern "C"
