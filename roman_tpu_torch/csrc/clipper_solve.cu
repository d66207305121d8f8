// CLIPPER solve on a prepared bf16 affinity, one thread block per pair.
//
// Replaces roman_tpu/align/clipper_pallas.py:50 `_solve_kernel` (K2) and
// the solve phase of roman_tpu/align/fused_register.py:111 `_kernel` (K1):
// warmup power iterations, optional restart expansion, penalty homotopy
// with the rank-structured one-to-one constraint product
// (Cb u)[a,b] = rowsum[a] + colsum[b] - 2 u[a,b], and the choice of the
// best feasible restart. Semantics: roman_tpu_torch/align/clipper_solve.py
// (`clipper_solve_plain` is the twin this kernel is tested against).
//
// What bounds it on an H100: memory. Every matvec u @ M streams the pair's
// (N, N) bf16 matrix once (5.12 MB at N = 1600), and one solve does
// warmup + outer * (inner + 1) + 1 = 51 of them at the default budget.
// The TPU kernel kept M in 128 MB of VMEM; an SM has 227 KB of shared
// memory, so here M stays in HBM/L2 and is read coalesced: a thread owns
// four neighbouring columns (one 8-byte load per row), a warp reads 256
// bytes of a row, and each thread keeps four rows of loads in flight.
// All R restart rows ride one pass over M (R accumulators per column), as
// the TPU kernels let them ride one MXU pass. u, its bf16 rounding, the
// matvec result, the valid mask and the row/column sums live in shared
// memory. Keeping M resident or tiling it with TMA/wgmma is later work.
//
// Numerics: u is rounded to bf16 before every matvec (as the TPU kernels
// do), products are exact bf16 x bf16 and sums run in f32 in row order.
// Norms divide by max(||u||, 1e-9); all-invalid pairs give u = 0 without
// NaN.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;

constexpr int kUnroll = 4;  // rows of M each thread has in flight

// VEC neighbouring bf16 entries of one row of M, as floats. VEC = 4 is one
// 8-byte load and needs an 8-byte aligned address; a bf16 is the high half
// of the float it widens to, so the conversion is a shift or a mask.
template <int VEC>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* m) {
  if constexpr (VEC == 4) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    m[0] = __uint_as_float(raw.x << 16);
    m[1] = __uint_as_float(raw.x & 0xFFFF0000u);
    m[2] = __uint_as_float(raw.y << 16);
    m[3] = __uint_as_float(raw.y & 0xFFFF0000u);
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) m[v] = __bfloat162float(p[v]);
  }
}

// out[r*N + j] = sum_i ub[r*N + i] * M[i*N + j] for ROWS rows. A thread owns
// VEC neighbouring columns and sums each in row order i = 0..N-1, so the
// result does not depend on VEC; kUnroll rows of loads are issued before
// their products are added.
template <int ROWS, int VEC>
__device__ void matvec(const __nv_bfloat16* __restrict__ M,
                       const float* __restrict__ ub, float* __restrict__ out,
                       int N) {
  for (int j = threadIdx.x * VEC; j < N; j += blockDim.x * VEC) {
    float acc[ROWS][VEC];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[r][v] = 0.f;
    const __nv_bfloat16* col = M + j;
    int i = 0;
    for (; i + kUnroll <= N; i += kUnroll) {
      float mv[kUnroll][VEC];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) load_row<VEC>(col + (size_t)(i + q) * N, mv[q]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float* u = ub + r * N + i;
#pragma unroll
        for (int q = 0; q < kUnroll; ++q)
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[r][v] = acc[r][v] + u[q] * mv[q][v];
      }
    }
    for (; i < N; ++i) {
      float mv[VEC];
      load_row<VEC>(col + (size_t)i * N, mv);
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[r][v] = acc[r][v] + ub[r * N + i] * mv[v];
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int v = 0; v < VEC; ++v) out[r * N + j + v] = acc[r][v];
  }
  __syncthreads();  // callers read out with another thread-to-column map
}

__device__ void round_bf16(const float* __restrict__ u, float* __restrict__ ub,
                           int count) {
  for (int k = threadIdx.x; k < count; k += blockDim.x)
    ub[k] = __bfloat162float(__float2bfloat16_rn(u[k]));
}

// rs[r*n + a] = sum_b u[r][a*m + b], cs[r*m + b] = sum_a u[r][a*m + b]
__device__ void row_col_sums(const float* __restrict__ u, float* rs, float* cs,
                             int rows, int n, int m) {
  const int N = n * m;
  for (int k = threadIdx.x; k < rows * n; k += blockDim.x) {
    const int r = k / n, a = k % n;
    const float* x = u + r * N + a * m;
    float s = 0.f;
    for (int b = 0; b < m; ++b) s = s + x[b];
    rs[k] = s;
  }
  for (int k = threadIdx.x; k < rows * m; k += blockDim.x) {
    const int r = k / m, b = k % m;
    const float* x = u + r * N + b;
    float s = 0.f;
    for (int a = 0; a < n; ++a) s = s + x[a * m];
    cs[k] = s;
  }
}

// u[row] <- w[row] / max(||w[row]||, eps); with keep_if_zero, rows whose
// norm is <= eps keep their old u (the homotopy's projection rule).
__device__ void normalize_rows(const float* __restrict__ w, float* __restrict__ u,
                               int rows, int N, bool keep_if_zero, float* red) {
  for (int r = 0; r < rows; ++r) {
    float s = 0.f;
    for (int j = threadIdx.x; j < N; j += blockDim.x) s += w[r * N + j] * w[r * N + j];
    const float nrm = sqrtf(roman::block_sum(s, red));
    if (keep_if_zero && !(nrm > roman::kEps)) continue;
    const float den = fmaxf(nrm, roman::kEps);
    for (int j = threadIdx.x; j < N; j += blockDim.x) u[r * N + j] = w[r * N + j] / den;
  }
  __syncthreads();
}

template <int R, int VEC>
__global__ void __launch_bounds__(kThreads)
clipper_solve_kernel(const __nv_bfloat16* __restrict__ M_all,
                     const float* __restrict__ valid,
                     const float* __restrict__ noise,
                     float* __restrict__ u_out, float* __restrict__ d_out,
                     float* __restrict__ F_out, float* __restrict__ om_out,
                     int N, int n, int m, int warmup, int outer, int inner,
                     float active_eps) {
  extern __shared__ float smem[];
  float* u = smem;            // R*N  current iterate, one row per restart
  float* ub = u + R * N;      // R*N  bf16-rounded u (matvec operand)
  float* w = ub + R * N;      // R*N  matvec result / projection scratch
  float* v = w + R * N;       // N    valid mask
  float* rs = v + N;          // R*n  row sums of u
  float* cs = rs + R * n;     // R*m  column sums of u
  __shared__ float red[33];
  __shared__ float d[R], score[R], Fr[R], omr[R];

  const int p = blockIdx.x;
  const __nv_bfloat16* M = M_all + (size_t)p * N * N;
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    v[j] = valid[(size_t)p * N + j];
    w[j] = v[j] + 1e-3f;
  }
  __syncthreads();
  normalize_rows(w, u, 1, N, false, red);

  // ---- warmup: u <- normalize((Mu + u) * valid), restart row 0 only ----
  for (int it = 0; it < warmup; ++it) {
    round_bf16(u, ub, N);
    __syncthreads();
    matvec<1, VEC>(M, ub, w, N);
    for (int j = threadIdx.x; j < N; j += blockDim.x) w[j] = (w[j] + u[j]) * v[j];
    __syncthreads();
    normalize_rows(w, u, 1, N, false, red);
  }

  // ---- restart expansion: row r blends toward restart_noise row r ----
  if (R > 1) {
    float mx = -INFINITY;
    for (int j = threadIdx.x; j < N; j += blockDim.x) mx = fmaxf(mx, u[j]);
    const float umax = roman::block_max(mx, red);
    for (int r = 1; r < R; ++r) {
      const float a = (float)r / (float)R;
      for (int j = threadIdx.x; j < N; j += blockDim.x)
        w[r * N + j] = (u[j] * (1.f - a) + umax * a * noise[r * N + j]) * v[j];
    }
    __syncthreads();
    normalize_rows(w + N, u + N, R - 1, N, false, red);
  }
  if (threadIdx.x < R) d[threadIdx.x] = 0.f;
  __syncthreads();

  // ---- penalty homotopy ----
  for (int o = 0; o < outer; ++o) {
    for (int it = 0; it < inner; ++it) {
      round_bf16(u, ub, R * N);
      __syncthreads();
      matvec<R, VEC>(M, ub, w, N);
      row_col_sums(u, rs, cs, R, n, m);
      __syncthreads();
      for (int r = 0; r < R; ++r)
        for (int j = threadIdx.x; j < N; j += blockDim.x) {
          const int k = r * N + j;
          const float cbu = (rs[r * n + j / m] + cs[r * m + j % m]) - 2.f * u[k];
          w[k] = fmaxf(w[k] - d[r] * cbu, 0.f) * v[j];
        }
      __syncthreads();
      normalize_rows(w, u, R, N, true, red);
    }
    round_bf16(u, ub, R * N);
    __syncthreads();
    matvec<R, VEC>(M, ub, w, N);
    row_col_sums(u, rs, cs, R, n, m);
    __syncthreads();
    for (int r = 0; r < R; ++r) {
      float num = 0.f, den = 0.f, nv = 0.f;
      for (int j = threadIdx.x; j < N; j += blockDim.x) {
        const int k = r * N + j;
        const float cbu = (rs[r * n + j / m] + cs[r * m + j % m]) - 2.f * u[k];
        if (u[k] > active_eps && cbu > active_eps) {
          num += w[k];
          den += cbu;
          nv += 1.f;
        }
      }
      num = roman::block_sum(num, red);
      den = roman::block_sum(den, red);
      nv = roman::block_sum(nv, red);
      if (threadIdx.x == 0) {
        const float delta = den > roman::kEps ? num / fmaxf(den, roman::kEps) : 0.f;
        d[r] = d[r] + delta + (nv > 0.f ? 1e-3f : 0.f);
      }
    }
    __syncthreads();
  }

  // ---- objective, omega and the restart choice ----
  round_bf16(u, ub, R * N);
  __syncthreads();
  matvec<R, VEC>(M, ub, w, N);
  row_col_sums(u, rs, cs, R, n, m);
  __syncthreads();
  for (int r = 0; r < R; ++r) {
    float f = 0.f, om = 0.f, nv = 0.f;
    for (int j = threadIdx.x; j < N; j += blockDim.x) {
      const int k = r * N + j;
      const float cbu = (rs[r * n + j / m] + cs[r * m + j % m]) - 2.f * u[k];
      f += u[k] * (w[k] - d[r] * cbu);
      om += u[k] * w[k];
      if (u[k] > active_eps && cbu > active_eps) nv += 1.f;
    }
    f = roman::block_sum(f, red);
    om = roman::block_sum(om, red);
    nv = roman::block_sum(nv, red);
    if (threadIdx.x == 0) {
      Fr[r] = f;
      omr[r] = om;
      score[r] = om - (nv > 0.f ? roman::kBigScore : 0.f);
    }
  }
  __syncthreads();
  int best = 0;
  for (int r = 1; r < R; ++r)
    if (score[r] > score[best]) best = r;  // first maximum: restart 0 wins ties
  for (int j = threadIdx.x; j < N; j += blockDim.x)
    u_out[(size_t)p * N + j] = u[best * N + j];
  if (threadIdx.x == 0) {
    d_out[p] = d[best];
    F_out[p] = Fr[best];
    om_out[p] = omr[best];
  }
}

template <int R, int VEC>
cudaError_t launch_vec(const void* M, const void* valid, const void* noise,
                       void* u, void* d, void* F, void* omega, int P, int N,
                       int n, int m, int warmup, int outer, int inner,
                       float active_eps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)3 * R * N + N + (size_t)R * (n + m));
  auto kernel = clipper_solve_kernel<R, VEC>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<P, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)M, (const float*)valid, (const float*)noise,
      (float*)u, (float*)d, (float*)F, (float*)omega, N, n, m, warmup, outer,
      inner, active_eps);
  return cudaGetLastError();
}

// Four columns a thread (8-byte loads) where every row of M starts 8-byte
// aligned, one column a thread otherwise.
template <int R>
cudaError_t launch(const void* M, const void* valid, const void* noise, void* u,
                   void* d, void* F, void* omega, int P, int N, int n, int m,
                   int warmup, int outer, int inner, float active_eps,
                   cudaStream_t stream) {
  if (N % 4 == 0 && reinterpret_cast<uintptr_t>(M) % 8 == 0)
    return launch_vec<R, 4>(M, valid, noise, u, d, F, omega, P, N, n, m,
                            warmup, outer, inner, active_eps, stream);
  return launch_vec<R, 1>(M, valid, noise, u, d, F, omega, P, N, n, m, warmup,
                          outer, inner, active_eps, stream);
}

}  // namespace

extern "C" int clipper_solve_launch(const void* M, const void* valid,
                                    const void* noise, void* u, void* d,
                                    void* F, void* omega, int P, int N, int n,
                                    int m, int R, int warmup, int outer,
                                    int inner, float active_eps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (R) {
#define ROMAN_CASE(K)                                                          \
  case K:                                                                      \
    return (int)launch<K>(M, valid, noise, u, d, F, omega, P, N, n, m, warmup, \
                          outer, inner, active_eps, s);
    ROMAN_CASE(1) ROMAN_CASE(2) ROMAN_CASE(3) ROMAN_CASE(4)
    ROMAN_CASE(5) ROMAN_CASE(6) ROMAN_CASE(7) ROMAN_CASE(8)
#undef ROMAN_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
