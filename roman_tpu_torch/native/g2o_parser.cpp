// Fast g2o text parser + writer (C++ runtime component).
//
// The reference's g2o plumbing lives partly in native code (gtsam for
// symbol keys, Kimera-RPGO's C++ reader). Here the text <-> array
// conversion is the host-side hot path for large pose graphs, so it is
// implemented natively and exposed through ctypes
// (roman_tpu_torch/native/__init__.py, which builds it); the pure-python
// parser in roman_tpu_torch/rpgo/g2o_io.py is the behavioral reference.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Vertex {
  int64_t key;
  double xyzq[7];
};

struct Edge {
  int64_t v1, v2;
  double xyzq[7];
  double info[21];
  int64_t lc_count;  // -1 if no preceding "# LC: n" comment
};

struct Graph {
  std::vector<Vertex> vertices;
  std::vector<Edge> edges;
};

}  // namespace

extern "C" {

// Parse a g2o file. Returns an opaque handle (or nullptr on failure).
void* g2o_parse(const char* path) {
  FILE* f = std::fopen(path, "r");
  if (!f) return nullptr;
  auto* g = new Graph();
  char line[8192];
  int64_t pending_lc = -1;
  while (std::fgets(line, sizeof(line), f)) {
    if (line[0] == '#') {
      int64_t n;
      if (std::sscanf(line, "# LC: %lld", (long long*)&n) == 1) pending_lc = n;
      continue;
    }
    if (std::strncmp(line, "VERTEX_SE3:QUAT", 15) == 0) {
      Vertex v;
      char tok[64];
      int off = 0;
      char* p = line + 15;
      // vertex tokens may carry letter prefixes ('a0'), same as edge
      // tokens: keep digits only (parity with g2o_io._strip_to_int)
      if (std::sscanf(p, "%63s%n", tok, &off) != 1) { delete g; std::fclose(f); return nullptr; }
      p += off;
      long long key = 0;
      for (const char* s = tok; *s; ++s)
        if (*s >= '0' && *s <= '9') key = key * 10 + (*s - '0');
      int got = std::sscanf(p, "%lf %lf %lf %lf %lf %lf %lf",
                            &v.xyzq[0], &v.xyzq[1], &v.xyzq[2],
                            &v.xyzq[3], &v.xyzq[4], &v.xyzq[5], &v.xyzq[6]);
      if (got != 7) { delete g; std::fclose(f); return nullptr; }
      v.key = key;
      g->vertices.push_back(v);
    } else if (std::strncmp(line, "EDGE_SE3:QUAT", 13) == 0) {
      Edge e;
      long long v1, v2;
      char tok1[64], tok2[64];
      char* p = line + 13;
      int off = 0;
      // malformed edge lines are a hard error (the python reference
      // asserts, g2o_io.py): skipping would let a pending '# LC: n'
      // count silently re-attach to the NEXT edge
      if (std::sscanf(p, "%63s %63s%n", tok1, tok2, &off) != 2) {
        delete g; std::fclose(f); return nullptr;
      }
      p += off;
      // vertex tokens may carry letter prefixes ('a0 b5'): keep digits only
      auto strip = [](const char* s) -> long long {
        long long v = 0;
        for (; *s; ++s)
          if (*s >= '0' && *s <= '9') v = v * 10 + (*s - '0');
        return v;
      };
      v1 = strip(tok1);
      v2 = strip(tok2);
      bool ok = true;
      for (int k = 0; k < 7 && ok; ++k) {
        if (std::sscanf(p, "%lf%n", &e.xyzq[k], &off) != 1) ok = false;
        p += off;
      }
      for (int k = 0; k < 21 && ok; ++k) {
        if (std::sscanf(p, "%lf%n", &e.info[k], &off) != 1) ok = false;
        p += off;
      }
      if (!ok) { delete g; std::fclose(f); return nullptr; }
      e.v1 = v1;
      e.v2 = v2;
      e.lc_count = pending_lc;
      pending_lc = -1;
      g->edges.push_back(e);
    }
  }
  std::fclose(f);
  return g;
}

int64_t g2o_num_vertices(void* h) { return ((Graph*)h)->vertices.size(); }
int64_t g2o_num_edges(void* h) { return ((Graph*)h)->edges.size(); }

void g2o_get_vertices(void* h, int64_t* keys, double* xyzq) {
  auto* g = (Graph*)h;
  for (size_t i = 0; i < g->vertices.size(); ++i) {
    keys[i] = g->vertices[i].key;
    std::memcpy(xyzq + 7 * i, g->vertices[i].xyzq, 7 * sizeof(double));
  }
}

void g2o_get_edges(void* h, int64_t* v1, int64_t* v2, double* xyzq,
                   double* info, int64_t* lc) {
  auto* g = (Graph*)h;
  for (size_t i = 0; i < g->edges.size(); ++i) {
    v1[i] = g->edges[i].v1;
    v2[i] = g->edges[i].v2;
    lc[i] = g->edges[i].lc_count;
    std::memcpy(xyzq + 7 * i, g->edges[i].xyzq, 7 * sizeof(double));
    std::memcpy(info + 21 * i, g->edges[i].info, 21 * sizeof(double));
  }
}

void g2o_free(void* h) { delete (Graph*)h; }

// ---------------------------------------------------------------------
// Jonker-Volgenant style O(n^3) linear assignment (minimization).
// rows <= cols required; cost is row-major (n x m). Returns assignment
// col index per row in `match`.
// ---------------------------------------------------------------------
void hungarian_solve(const double* cost, int n, int m, int* match) {
  const double INF = 1e30;
  std::vector<double> u(n + 1, 0.0), v(m + 1, 0.0);
  std::vector<int> p(m + 1, 0), way(m + 1, 0);
  for (int i = 1; i <= n; ++i) {
    p[0] = i;
    int j0 = 0;
    std::vector<double> minv(m + 1, INF);
    std::vector<char> used(m + 1, 0);
    do {
      used[j0] = 1;
      int i0 = p[j0], j1 = 0;
      double delta = INF;
      for (int j = 1; j <= m; ++j) {
        if (used[j]) continue;
        double cur = cost[(i0 - 1) * m + (j - 1)] - u[i0] - v[j];
        if (cur < minv[j]) {
          minv[j] = cur;
          way[j] = j0;
        }
        if (minv[j] < delta) {
          delta = minv[j];
          j1 = j;
        }
      }
      for (int j = 0; j <= m; ++j) {
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
      int j1 = way[j0];
      p[j0] = p[j1];
      j0 = j1;
    } while (j0);
  }
  for (int i = 0; i < n; ++i) match[i] = -1;
  for (int j = 1; j <= m; ++j)
    if (p[j] > 0) match[p[j] - 1] = j - 1;
}

}  // extern "C"
