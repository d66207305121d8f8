// The fused ROMAN registration path, split by what the card holds:
// assoc_terms -> build_affinity -> clipper_solve (clipper_solve.cu) ->
// round_refine. Together they replace roman_tpu/align/fused_register.py:111
// `_kernel` (K1), which built the (N, N) affinity, solved, rounded and
// refined in one VMEM-resident TPU program. One pair's bf16 affinity is
// 5.12 MB at N = 1600, far above an SM's 227 KB of shared memory, so here it
// is built once into HBM and read from there by the solve and the refine.
// Semantics and the plain twins: roman_tpu_torch/align/fused_register.py.
//
// Numerics mirror the TPU kernel's log-space formulation: each endpoint's
// per-association score enters as a half-log added in row then column
// order, distances use sqrt(x + 1e-20), and M is rounded to bf16
// (round-to-nearest-even). The library is built with -fmad=false and no
// fast math, so each operation rounds as the PyTorch twin's does and only
// expf/logf/sqrtf may differ from it in the last f32 bit.
#include "common.cuh"

namespace {

struct AssocParams {
  int n, m, F, D;
  int use_ratio, use_cosine;
  float eps_shape, cos_min, cos_den;  // cos_den = max(cos_max - cos_min, 1e-9)
};

struct BuildParams {
  int n, m, n_terms, gravity;
  float sigma, epsilon, mindist, sin_unc;
};

struct RoundParams {
  int n, m, max_steps, refine_iters;
  float rel_thresh, min_support, rel_support, edge_eps;
};

// ---------------------------------------------------------------------------
// assoc_terms: one block per pair.
//
// Per association i = a*m + b: the ratio geometric mean over F shape
// features and the clipped descriptor cosine (an f32 loop over D, in
// feature order, as the TPU kernel computed it in its own body rather than
// as a library product), written as flat N-vectors: half-log score and
// nonzero flag per term, the fused single score, and the valid flag.
// Bounded by the D-long dot products (n*m*D multiply-adds per pair, about
// 1.2 M at capacity 40); the features are read through L1, the outputs
// are a few N-vectors.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
assoc_terms_kernel(const float* __restrict__ r1, const float* __restrict__ d1,
                   const float* __restrict__ r2, const float* __restrict__ d2,
                   const float* __restrict__ valid, float* __restrict__ hl,
                   float* __restrict__ nz, float* __restrict__ single,
                   float* __restrict__ vflat, AssocParams q) {
  extern __shared__ float norms[];  // n + m descriptor norms
  const int p = blockIdx.x;
  const int n = q.n, m = q.m, N = n * m, F = q.F, D = q.D;
  const float* R1 = r1 + (size_t)p * n * F;
  const float* R2 = r2 + (size_t)p * m * F;
  const float* D1 = d1 + (size_t)p * n * D;
  const float* D2 = d2 + (size_t)p * m * D;
  if (q.use_cosine) {
    for (int k = threadIdx.x; k < n + m; k += blockDim.x) {
      const float* x = k < n ? D1 + (size_t)k * D : D2 + (size_t)(k - n) * D;
      float s = 0.f;
      for (int c = 0; c < D; ++c) s = s + x[c] * x[c];
      norms[k] = sqrtf(s);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const int a = i / m, b = i % m;
    float scores[2];
    int t = 0;
    if (q.use_ratio) {
      float logsum = 0.f;
      bool all_nz = true;
      for (int f = 0; f < F; ++f) {
        const float x = fabsf(R1[a * F + f]);
        const float y = fabsf(R2[b * F + f]);
        float rho = fminf(x, y) / fmaxf(fmaxf(x, y), 1e-9f);
        rho = rho >= q.eps_shape ? rho : 0.f;
        logsum = logsum + logf(fmaxf(rho, 1e-20f));
        all_nz = all_nz && rho > 0.f;
      }
      scores[t++] = expf(logsum / (float)F) * (all_nz ? 1.f : 0.f);
    }
    if (q.use_cosine) {
      const float* x = D1 + (size_t)a * D;
      const float* y = D2 + (size_t)b * D;
      float dot = 0.f;
      for (int c = 0; c < D; ++c) dot = dot + x[c] * y[c];
      const float na = norms[a], nb = norms[n + b];
      const float den = na * nb;
      const float cs = den > 1e-9f ? dot / fmaxf(den, 1e-9f) : 1.f;
      const bool missing = na < 1e-9f || nb < 1e-9f;
      const float s = fminf(fmaxf((cs - q.cos_min) / q.cos_den, 0.f), 1.f);
      scores[t++] = missing ? 1.f : s;
    }
    float log_single = 0.f;
    bool single_nz = true;
    for (int k = 0; k < t; ++k) {
      const float lg = logf(fmaxf(scores[k], 1e-20f));
      hl[((size_t)p * 2 + k) * N + i] = 0.5f * lg;
      nz[((size_t)p * 2 + k) * N + i] = scores[k] > 1e-20f ? 1.f : 0.f;
      log_single = log_single + lg;
      single_nz = single_nz && scores[k] > 0.f;
    }
    float s = t > 0 ? expf(log_single / (float)t) * (single_nz ? 1.f : 0.f) : 1.f;
    const bool vi = valid[(size_t)p * N + i] > 0.5f;
    single[(size_t)p * N + i] = vi ? s : 0.f;
    vflat[(size_t)p * N + i] = vi ? 1.f : 0.f;
  }
}

// ---------------------------------------------------------------------------
// build_affinity: grid (pair, tile of kRows rows), thread per column.
//
// Writes M[i, j] (bf16) for association i = (a_i, b_i) (row) and
// j = (a_j, b_j) (column), from the endpoint coordinates (exact gathers by
// index: a = i / m, b = i % m) and the flat vectors of assoc_terms:
// gravity-gated distance consistency, log-space geometric mean with the
// per-association half-logs, conflict / diagonal / invalid masks and the
// single scores on the diagonal (roman_tpu/align/fused_register.py:267-300).
// Bounded by its arithmetic (about 30 f32 operations and 5 transcendental
// calls per entry, 2.56 M entries per pair at N = 1600) and by writing
// 5.12 MB per pair; neighbouring threads write neighbouring entries.
// ---------------------------------------------------------------------------
constexpr int kBuildRows = 8;

__global__ void __launch_bounds__(256)
build_affinity_kernel(const float* __restrict__ c1, const float* __restrict__ c2,
                      const float* __restrict__ hl, const float* __restrict__ nz,
                      const float* __restrict__ single,
                      const float* __restrict__ vflat,
                      __nv_bfloat16* __restrict__ M_all, BuildParams q) {
  const int p = blockIdx.x;
  const int n = q.n, m = q.m, N = n * m, T = q.n_terms;
  const float* C1 = c1 + (size_t)p * n * 3;
  const float* C2 = c2 + (size_t)p * m * 3;
  const float* HL = hl + (size_t)p * 2 * N;
  const float* NZ = nz + (size_t)p * 2 * N;
  const float* SG = single + (size_t)p * N;
  const float* VF = vflat + (size_t)p * N;
  const float num_comp = (float)(1 + T);
  __nv_bfloat16* M = M_all + (size_t)p * N * N;
  for (int rr = 0; rr < kBuildRows; ++rr) {
    const int i = blockIdx.y * kBuildRows + rr;
    if (i >= N) break;
    const int ai = i / m, bi = i % m;
    const float x1 = C1[ai * 3], y1 = C1[ai * 3 + 1], z1 = C1[ai * 3 + 2];
    const float x2 = C2[bi * 3], y2 = C2[bi * 3 + 1], z2 = C2[bi * 3 + 2];
    const bool vi = VF[i] > 0.5f;
    for (int j = threadIdx.x; j < N; j += blockDim.x) {
      const int aj = j / m, bj = j % m;
      // intra-map geometry of both endpoints
      const float dX1 = x1 - C1[aj * 3], dY1 = y1 - C1[aj * 3 + 1],
                  dZ1 = z1 - C1[aj * 3 + 2];
      const float dxy2_1 = dX1 * dX1 + dY1 * dY1;
      const float D1 = sqrtf(dxy2_1 + dZ1 * dZ1 + 1e-20f);
      const float dX2 = x2 - C2[bj * 3], dY2 = y2 - C2[bj * 3 + 1],
                  dZ2 = z2 - C2[bj * 3 + 2];
      const float dxy2_2 = dX2 * dX2 + dY2 * dY2;
      const float D2 = sqrtf(dxy2_2 + dZ2 * dZ2 + 1e-20f);
      const bool gate = D1 > q.mindist && D2 > q.mindist;
      float cdist;
      if (q.gravity) {
        const float slack = q.sin_unc * fmaxf(D1, D2);
        const float cz = fmaxf(fabsf(fabsf(dZ1) - fabsf(dZ2)) - slack, 0.f);
        const float cxy = fabsf(sqrtf(dxy2_1 + 1e-20f) - sqrtf(dxy2_2 + 1e-20f));
        cdist = sqrtf(cz * cz + cxy * cxy + 1e-20f);
      } else {
        cdist = fabsf(D1 - D2);
      }
      const float tq = cdist / q.sigma;
      float sd = expf(-0.5f * (tq * tq));
      sd = (cdist < q.epsilon && gate) ? sd : 0.f;
      float logM = logf(fmaxf(sd, 1e-20f));
      bool nonzero = sd > 0.f;
      for (int t = 0; t < T; ++t) {
        logM = logM + HL[t * N + i];
        logM = logM + HL[t * N + j];
        nonzero = nonzero && NZ[t * N + i] > 0.5f && NZ[t * N + j] > 0.5f;
      }
      float val = expf(logM / num_comp) * (nonzero ? 1.f : 0.f);
      const bool same_a = ai == aj, same_b = bi == bj;
      const bool diag = same_a && same_b;
      const bool valid4 = vi && VF[j] > 0.5f;
      if ((same_a != same_b) || diag || !valid4) val = 0.f;
      val = val + ((diag && valid4) ? SG[j] + 0.f * val : 0.f);
      M[(size_t)i * N + j] = __float2bfloat16_rn(val);
    }
  }
}

// ---------------------------------------------------------------------------
// round_refine: one block per pair.
//
// Greedy one-to-one rounding (min(max_clique, n, m) block arg-max steps,
// lowest index wins a tie; cut 0.35 * max u; target round(2F) clipped to
// [1, max_steps]) and the support refinement (roman_tpu/align/
// fused_register.py:481-638). A refine iteration only changes selected
// entries, and at most max_steps entries are selected, so it reads only the
// selected rows and columns of M (at most 40 x 40 entries) and needs no
// (N, N) zero-edge mask. Bounded by the rounding's arg-max steps over u
// (N floats each, from shared memory) and their block barriers.
// ---------------------------------------------------------------------------
constexpr int kMaxSteps = 256;

__global__ void __launch_bounds__(256)
round_refine_kernel(const __nv_bfloat16* __restrict__ M_all,
                    const float* __restrict__ u_all, const float* __restrict__ F_all,
                    const float* __restrict__ omega_all,
                    unsigned char* __restrict__ sel_out, int* __restrict__ count_out,
                    RoundParams q) {
  extern __shared__ float uu[];  // N
  __shared__ float redv[33];
  __shared__ int redi[33];
  __shared__ int row_free[kMaxSteps], col_free[kMaxSteps];
  __shared__ int list[kMaxSteps];   // selected indices, in pick order
  __shared__ int alive[kMaxSteps];
  __shared__ float supp[kMaxSteps], zc[kMaxSteps];
  __shared__ int n_sel;

  const int p = blockIdx.x;
  const int n = q.n, m = q.m, N = n * m;
  const __nv_bfloat16* M = M_all + (size_t)p * N * N;
  float mx = -INFINITY;
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    uu[j] = u_all[(size_t)p * N + j];
    mx = fmaxf(mx, uu[j]);
  }
  for (int k = threadIdx.x; k < n; k += blockDim.x) row_free[k] = 1;
  for (int k = threadIdx.x; k < m; k += blockDim.x) col_free[k] = 1;
  if (threadIdx.x == 0) n_sel = 0;
  const float cut = q.rel_thresh * roman::block_max(mx, redv);
  const float Fv = F_all[p];
  const float target = Fv > 0.f
      ? fminf(fmaxf(rintf(Fv * 2.f), 1.f), (float)q.max_steps)
      : (float)q.max_steps;

  // ---- greedy rounding ----
  for (int step = 0; step < q.max_steps; ++step) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int j = threadIdx.x; j < N; j += blockDim.x) {
      const float cand = (row_free[j / m] && col_free[j % m]) ? uu[j] : -1.f;
      roman::argmax_merge(bv, bi, cand, j);
    }
    float val;
    const int first = roman::block_argmax(bv, bi, redv, redi, &val);
    if (threadIdx.x == 0 && val > cut && val > 0.f && (float)n_sel < target) {
      row_free[first / m] = 0;
      col_free[first % m] = 0;
      list[n_sel] = first;
      alive[n_sel] = 1;
      n_sel = n_sel + 1;
    }
    __syncthreads();
  }

  // ---- support refinement on the selected set ----
  if (threadIdx.x == 0) {  // index order, as a full matvec would sum
    for (int a = 1; a < n_sel; ++a)
      for (int b = a; b > 0 && list[b - 1] > list[b]; --b) {
        const int t = list[b]; list[b] = list[b - 1]; list[b - 1] = t;
      }
  }
  __syncthreads();
  const int K = n_sel;
  const float tgt = fmaxf(rintf(omega_all[p]), 0.f);
  for (int it = 0; it < q.refine_iters; ++it) {
    float kk = 0.f;
    for (int k = 0; k < K; ++k) kk += alive[k] ? 1.f : 0.f;
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      const int j = list[k];
      float mv = 0.f, z = 0.f;
      for (int l = 0; l < K; ++l) {
        if (!alive[l]) continue;
        const float e = __bfloat162float(M[(size_t)list[l] * N + j]);
        mv = mv + e;
        if (l != k && e <= q.edge_eps) z = z + 1.f;
      }
      supp[k] = mv / fmaxf(kk - 1.f, 1.f);
      zc[k] = z;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int k = 0; k < K; ++k) s = s + (alive[k] ? supp[k] : 0.f);
      const float thresh = fmaxf(q.rel_support * (s / fmaxf(kk, 1.f)), q.min_support);
      int worst = -1;
      float wv = roman::kBigScore;
      for (int k = 0; k < K; ++k)
        if (alive[k] && zc[k] > 0.5f && (worst < 0 || supp[k] < wv)) {
          worst = k;
          wv = supp[k];
        }
      const bool drop = worst >= 0 && kk > tgt;
      for (int k = 0; k < K; ++k)
        alive[k] = alive[k] && supp[k] >= thresh && !(drop && k == worst);
    }
    __syncthreads();
  }

  for (int j = threadIdx.x; j < N; j += blockDim.x) sel_out[(size_t)p * N + j] = 0;
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    if (alive[k]) sel_out[(size_t)p * N + list[k]] = 1;
  if (threadIdx.x == 0) {
    int c = 0;
    for (int k = 0; k < K; ++k) c += alive[k];
    count_out[p] = c;
  }
}

}  // namespace

extern "C" int assoc_terms_launch(const void* r1, const void* d1, const void* r2,
                                  const void* d2, const void* valid, void* hl,
                                  void* nz, void* single, void* vflat, int P,
                                  int n, int m, int F, int D, int use_ratio,
                                  int use_cosine, float eps_shape, float cos_min,
                                  float cos_den, void* stream) {
  AssocParams q{n, m, F, D, use_ratio, use_cosine, eps_shape, cos_min, cos_den};
  assoc_terms_kernel<<<P, 256, sizeof(float) * (n + m), (cudaStream_t)stream>>>(
      (const float*)r1, (const float*)d1, (const float*)r2, (const float*)d2,
      (const float*)valid, (float*)hl, (float*)nz, (float*)single, (float*)vflat, q);
  return (int)cudaGetLastError();
}

extern "C" int build_affinity_launch(const void* c1, const void* c2, const void* hl,
                                     const void* nz, const void* single,
                                     const void* vflat, void* M, int P, int n,
                                     int m, int n_terms, int gravity, float sigma,
                                     float epsilon, float mindist, float sin_unc,
                                     void* stream) {
  BuildParams q{n, m, n_terms, gravity, sigma, epsilon, mindist, sin_unc};
  const int N = n * m;
  dim3 grid(P, (N + kBuildRows - 1) / kBuildRows);
  build_affinity_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const float*)c1, (const float*)c2, (const float*)hl, (const float*)nz,
      (const float*)single, (const float*)vflat, (__nv_bfloat16*)M, q);
  return (int)cudaGetLastError();
}

extern "C" int round_refine_launch(const void* M, const void* u, const void* F,
                                   const void* omega, void* sel, void* count,
                                   int P, int n, int m, int max_steps,
                                   int refine_iters, float rel_thresh,
                                   float min_support, float rel_support,
                                   float edge_eps, void* stream) {
  if (n > kMaxSteps || m > kMaxSteps || max_steps > kMaxSteps)
    return (int)cudaErrorInvalidValue;
  RoundParams q{n, m, max_steps, refine_iters, rel_thresh, min_support,
                rel_support, edge_eps};
  const size_t smem = sizeof(float) * (size_t)n * m;
  auto kernel = round_refine_kernel;
  if (smem > 32 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<P, 256, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)M, (const float*)u, (const float*)F,
      (const float*)omega, (unsigned char*)sel, (int*)count, q);
  return (int)cudaGetLastError();
}
