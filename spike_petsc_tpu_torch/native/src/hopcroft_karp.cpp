// Hopcroft-Karp maximum-cardinality bipartite matching, with an optional
// weight threshold (edges with weight < threshold are ignored).
//
// Native engine for the MC64-equivalent jobs 1-3 (max cardinality and the
// bottleneck matchings' feasibility oracle): the reference reaches these
// through HSL MC64's DFS matching (HSLmc64ZD) and threshold strategies
// (reference/src/hslmc64.c:2402, :1002, :1432).  Implemented from the
// Hopcroft-Karp algorithm (SIAM J. Comput. 2(4), 1973), O(E sqrt V).
//
// C ABI:
//   spike_hopcroft_karp(n, col_ptr[n+1], row_ind[nnz], weights[nnz] or NULL,
//                       threshold, match_out[n]) -> cardinality
// match_out[j] = row matched to column j, or -1.

#include <cstdint>
#include <limits>
#include <vector>

namespace {
constexpr int64_t NIL = -1;
constexpr int64_t INF = std::numeric_limits<int64_t>::max();
}

extern "C" {

int64_t spike_hopcroft_karp(int64_t n, const int64_t* col_ptr,
                            const int64_t* row_ind, const double* weights,
                            double threshold, int64_t* match_out) {
  std::vector<int64_t> match_col(n, NIL);   // column -> row
  std::vector<int64_t> match_row(n, NIL);   // row -> column
  std::vector<int64_t> dist(n);
  std::vector<int64_t> queue(n);
  std::vector<int64_t> it(n);               // DFS edge cursors

  auto edge_ok = [&](int64_t t) {
    return weights == nullptr || weights[t] >= threshold;
  };

  // greedy initialization
  for (int64_t j = 0; j < n; ++j) {
    for (int64_t t = col_ptr[j]; t < col_ptr[j + 1]; ++t) {
      if (!edge_ok(t)) continue;
      int64_t i = row_ind[t];
      if (match_row[i] == NIL) {
        match_row[i] = j;
        match_col[j] = i;
        break;
      }
    }
  }

  auto bfs = [&]() -> bool {
    int64_t qh = 0, qt = 0;
    for (int64_t j = 0; j < n; ++j) {
      if (match_col[j] == NIL) {
        dist[j] = 0;
        queue[qt++] = j;
      } else {
        dist[j] = INF;
      }
    }
    bool found = false;
    while (qh < qt) {
      int64_t j = queue[qh++];
      for (int64_t t = col_ptr[j]; t < col_ptr[j + 1]; ++t) {
        if (!edge_ok(t)) continue;
        int64_t i = row_ind[t];
        int64_t j2 = match_row[i];
        if (j2 == NIL) {
          found = true;
        } else if (dist[j2] == INF) {
          dist[j2] = dist[j] + 1;
          queue[qt++] = j2;
        }
      }
    }
    return found;
  };

  // iterative DFS along the BFS layering
  std::vector<int64_t> stack(n + 1);
  auto dfs = [&](int64_t j0) -> bool {
    int64_t top = 0;
    stack[top] = j0;
    it[j0] = col_ptr[j0];
    while (top >= 0) {
      int64_t j = stack[top];
      bool advanced = false;
      while (it[j] < col_ptr[j + 1]) {
        int64_t t = it[j]++;
        if (!edge_ok(t)) continue;
        int64_t i = row_ind[t];
        int64_t j2 = match_row[i];
        if (j2 == NIL) {
          // augment along the stack
          for (int64_t s = top; s >= 0; --s) {
            int64_t js = stack[s];
            int64_t prev = match_col[js];
            match_col[js] = i;
            match_row[i] = js;
            i = prev;   // row freed by js (NIL for the path start)
          }
          return true;
        }
        if (dist[j2] == dist[j] + 1) {
          stack[++top] = j2;
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

  while (bfs()) {
    for (int64_t j = 0; j < n; ++j) {
      if (match_col[j] == NIL) dfs(j);
    }
  }

  int64_t card = 0;
  for (int64_t j = 0; j < n; ++j) {
    match_out[j] = match_col[j];
    if (match_col[j] != NIL) ++card;
  }
  return card;
}

}  // extern "C"
