// Serial per-pair CLIPPER reference solve (C++), the benchmark baseline.
//
// Stands in for the reference's per-pair C++ CLIPPER hot loop (reference
// roman/align/object_registration.py:22-29 calling the Eigen-based
// clipperpy solver, one submap pair at a time): ROMAN invariant affinity
// (distance consistency with gravity-slack vertical split x shape-ratio
// x clamped cosine, geometric-mean fusion, single-association diagonal),
// projected power-iteration with penalty homotopy on the one-to-one
// constraint, omega rounding. Identical math to the batched TPU engine
// and to the numpy fallback in bench.py. The iteration budget here is
// the FIXED reference budget (warmup 10, outer 12, inner 10) by design:
// the baseline is the quality referee and must not move when the
// engine's tuned budget (ClipperSolveParams) changes.
//
// The one-to-one constraint matvec uses the rank structure
// (rowsum + colsum - 2u) rather than a dense C matrix — this makes the
// BASELINE faster, i.e. the reported speedup conservative.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <numeric>
#include <vector>

namespace {

void pairwise_geometry(const double* c, int n, std::vector<double>& D,
                       std::vector<double>& dz, std::vector<double>& dxy) {
  D.assign((size_t)n * n, 0.0);
  dz.assign((size_t)n * n, 0.0);
  dxy.assign((size_t)n * n, 0.0);
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) {
      const double ddx = c[3 * i] - c[3 * j];
      const double ddy = c[3 * i + 1] - c[3 * j + 1];
      const double ddz = c[3 * i + 2] - c[3 * j + 2];
      const double xy = std::sqrt(ddx * ddx + ddy * ddy);
      D[(size_t)i * n + j] = std::sqrt(xy * xy + ddz * ddz);
      dz[(size_t)i * n + j] = std::fabs(ddz);
      dxy[(size_t)i * n + j] = xy;
    }
  }
}

}  // namespace

extern "C" {

// Returns the number of selected associations (written as (a, b) int32
// pairs into sel_out, capacity >= min(n1, n2) * 2 entries).
int clipper_ref_solve(const double* c1, const double* r1, const double* d1,
                      int n1, const double* c2, const double* r2,
                      const double* d2, int n2, int rdim, int ddim,
                      double sigma, double eps, double mindist, double cmin,
                      double cmax, int* sel_out) {
  const int N = n1 * n2;
  if (N <= 0) return 0;

  std::vector<double> D1, dz1, dxy1, D2, dz2, dxy2;
  pairwise_geometry(c1, n1, D1, dz1, dxy1);
  pairwise_geometry(c2, n2, D2, dz2, dxy2);

  // per-association ratio + clamped-cosine similarity
  std::vector<double> sr(N), sc(N);
  for (int a = 0; a < n1; ++a) {
    for (int b = 0; b < n2; ++b) {
      const int idx = a * n2 + b;
      double log_sum = 0.0;
      bool all_pos = true;
      for (int k = 0; k < rdim; ++k) {
        const double x = std::fabs(r1[(size_t)a * rdim + k]);
        const double y = std::fabs(r2[(size_t)b * rdim + k]);
        const double rho = std::min(x, y) / std::max(std::max(x, y), 1e-9);
        all_pos = all_pos && (rho > 0.0);
        log_sum += std::log(std::max(rho, 1e-20));
      }
      sr[idx] = (rdim == 0) ? 1.0 : (all_pos ? std::exp(log_sum / rdim) : 0.0);
      double cos = 0.0;
      for (int k = 0; k < ddim; ++k)
        cos += d1[(size_t)a * ddim + k] * d2[(size_t)b * ddim + k];
      sc[idx] = std::min(std::max((cos - cmin) / (cmax - cmin), 0.0), 1.0);
    }
  }

  // dense N x N affinity (the reference C++ CLIPPER materializes M too)
  const double slack_k = std::sin(0.0872665);
  std::vector<double> M((size_t)N * N, 0.0);
  for (int i = 0; i < N; ++i) {
    const int a1 = i / n2, b1 = i % n2;
    M[(size_t)i * N + i] = std::sqrt(sr[i] * sc[i]);  // gravity diagonal
    for (int j = i + 1; j < N; ++j) {
      const int a2 = j / n2, b2 = j % n2;
      if (a1 == a2 || b1 == b2) continue;  // one-to-one conflict -> 0
      const double da = D1[(size_t)a1 * n1 + a2];
      const double db = D2[(size_t)b1 * n2 + b2];
      if (!(da > mindist && db > mindist)) continue;
      const double slack = slack_k * std::max(da, db);
      const double cz = std::max(
          std::fabs(dz1[(size_t)a1 * n1 + a2] - dz2[(size_t)b1 * n2 + b2]) -
              slack,
          0.0);
      const double cxy =
          std::fabs(dxy1[(size_t)a1 * n1 + a2] - dxy2[(size_t)b1 * n2 + b2]);
      const double c = std::sqrt(cz * cz + cxy * cxy);
      if (!(c < eps)) continue;
      const double sd = std::exp(-0.5 * (c / sigma) * (c / sigma));
      const double v =
          std::cbrt(sd * std::sqrt(sr[i] * sr[j]) * std::sqrt(sc[i] * sc[j]));
      M[(size_t)i * N + j] = v;
      M[(size_t)j * N + i] = v;
    }
  }

  auto matvec = [&](const std::vector<double>& u, std::vector<double>& out) {
    for (int i = 0; i < N; ++i) {
      const double* row = &M[(size_t)i * N];
      double acc = 0.0;
      for (int j = 0; j < N; ++j) acc += row[j] * u[j];
      out[i] = acc;
    }
  };
  // one-to-one constraint matvec via rank structure: for association
  // (a, b), (Cb u)_i = S_a(a) + S_b(b) - 2 u_i
  auto conflict_matvec = [&](const std::vector<double>& u,
                             std::vector<double>& out) {
    std::vector<double> Sa(n1, 0.0), Sb(n2, 0.0);
    for (int i = 0; i < N; ++i) {
      Sa[i / n2] += u[i];
      Sb[i % n2] += u[i];
    }
    for (int i = 0; i < N; ++i)
      out[i] = Sa[i / n2] + Sb[i % n2] - 2.0 * u[i];
  };
  auto normalize = [&](std::vector<double>& u) {
    double nn = 0.0;
    for (double v : u) nn += v * v;
    nn = std::sqrt(nn);
    if (nn > 1e-12) {
      for (double& v : u) v /= nn;
    } else {
      const double f = 1.0 / std::sqrt((double)N);
      std::fill(u.begin(), u.end(), f);
    }
  };

  std::vector<double> u(N, 1.0 / std::sqrt((double)N)), Mu(N), Cbu(N);
  // warmup power iterations (same budget as bench.py / the TPU engine)
  for (int it = 0; it < 10; ++it) {
    matvec(u, Mu);
    for (int i = 0; i < N; ++i) u[i] = std::max(Mu[i] + u[i], 0.0);
    double nn = 0.0;
    for (double v : u) nn += v * v;
    nn = std::max(std::sqrt(nn), 1e-12);
    for (double& v : u) v /= nn;
  }
  // penalty homotopy
  double d = 0.0;
  for (int outer = 0; outer < 12; ++outer) {
    for (int inner = 0; inner < 10; ++inner) {
      matvec(u, Mu);
      conflict_matvec(u, Cbu);
      for (int i = 0; i < N; ++i) u[i] = std::max(Mu[i] - d * Cbu[i], 0.0);
      normalize(u);
    }
    matvec(u, Mu);
    conflict_matvec(u, Cbu);
    double num = 0.0, den = 0.0;
    bool any = false;
    for (int i = 0; i < N; ++i) {
      if (u[i] > 1e-6 && Cbu[i] > 1e-6) {
        any = true;
        num += Mu[i];
        den += Cbu[i];
      }
    }
    if (any) d += num / std::max(den, 1e-9) + 1e-3;
  }

  // omega rounding: u' M u, greedy unique-(a,b) pass over the top entries
  matvec(u, Mu);
  double uMu = 0.0;
  for (int i = 0; i < N; ++i) uMu += u[i] * Mu[i];
  const int omega = std::max((int)std::llround(uMu), 0);
  std::vector<int> order(N);
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(),
            [&](int a, int b) { return u[a] > u[b]; });
  std::vector<char> used_a(n1, 0), used_b(n2, 0);
  int count = 0;
  for (int k = 0; k < omega && k < N; ++k) {
    const int idx = order[k];
    const int a = idx / n2, b = idx % n2;
    if (u[idx] <= 0.0 || used_a[a] || used_b[b]) continue;
    used_a[a] = used_b[b] = 1;
    sel_out[2 * count] = a;
    sel_out[2 * count + 1] = b;
    ++count;
  }
  return count;
}

}  // extern "C"
