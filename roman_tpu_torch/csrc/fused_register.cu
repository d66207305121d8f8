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
#include <cstdint>

#include "common.cuh"

namespace {

struct AssocParams {
  int n, m, F, D;
  int use_ratio, use_cosine;
  int vec;  // 16-byte descriptor copies: D % 4 == 0 and both bases 16-byte aligned
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
// assoc_terms: grid (tile of kAssocRows rows a, pair); a thread per column b.
//
// Per association i = a*m + b: the ratio geometric mean over F shape
// features and the clipped descriptor cosine (an f32 loop over D, in
// feature order, as the TPU kernel computed it in its own body rather than
// as a library product), written as flat N-vectors: half-log score and
// nonzero flag per term, the fused single score, and the valid flag.
// Replaces the terms block of K1 (roman_tpu/align/fused_register.py:185-260).
//
// Bound on this card: the D-long dot products (n*m*D multiply-adds a pair,
// 1.2 M at capacity 40) and reading the descriptors (7.9 MB for 32 pairs),
// both a few microseconds; what costs is latency. So a pair is spread over
// n / kAssocRows blocks, and each block stages slices of kAssocSlice
// features of its rows of d1 and of all m rows of d2 in shared memory with
// asynchronous coalesced copies (16 bytes where D % 4 == 0, else 4), a
// ring of kAssocStages slices, so later slices are copied while one is
// summed. Each thread reads its column four features at a time, keeps the
// kAssocRows dots of its column b in registers and sums each one, and its
// norms, in feature order with no FMA: bitwise the sums of a plain loop.
// ---------------------------------------------------------------------------
constexpr int kAssocRows = 2;       // rows a a block
constexpr int kAssocThreads = 64;   // columns b a pass
constexpr int kAssocSlice = 64;     // features a staged slice
constexpr int kAssocStages = 2;     // slices in flight or being summed
// Row stride of a staged slice: 16-byte aligned rows, and a float4 read of
// the same features by 8 neighbouring threads (8 rows) hits 8 distinct
// 16-byte bank groups.
constexpr int kAssocStride = kAssocSlice + 4;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending));
}

// Start copying features [k0, k0 + ks) of d1's rows a0.. (na_rows) and of
// d2's rows b0.. (nb_rows) into one buffer of s1 and s2: 16 bytes a copy
// where vec, else 4; neighbouring threads take neighbouring addresses.
__device__ __forceinline__ void stage_slice(const float* D1, const float* D2,
                                            int D, bool vec, int a0, int na_rows,
                                            int b0, int nb_rows, int k0, int ks,
                                            float (*s1)[kAssocStride],
                                            float (*s2)[kAssocStride]) {
  const int W = vec ? 4 : 1;  // floats a copy
  const int per_row = kAssocSlice / W;
  const int items = (na_rows + nb_rows) * per_row;
  for (int e = threadIdx.x; e < items; e += kAssocThreads) {
    const int r = e / per_row, c = W * (e - r * per_row);
    if (c >= ks) continue;
    const float* src = (r < na_rows ? D1 + (size_t)(a0 + r) * D
                                    : D2 + (size_t)(b0 + r - na_rows) * D) + k0 + c;
    float* dst = (r < na_rows ? s1[r] : s2[r - na_rows]) + c;
    if (vec) cp_async16(dst, src);
    else cp_async4(dst, src);
  }
}

__global__ void __launch_bounds__(kAssocThreads)
assoc_terms_kernel(const float* __restrict__ r1, const float* __restrict__ d1,
                   const float* __restrict__ r2, const float* __restrict__ d2,
                   const float* __restrict__ valid, float* __restrict__ hl,
                   float* __restrict__ nz, float* __restrict__ single,
                   float* __restrict__ vflat, AssocParams q) {
  // a ring of slices: this block's rows of d1, the pass's rows of d2
  __shared__ __align__(16) float s1[kAssocStages][kAssocRows][kAssocStride];
  __shared__ __align__(16) float s2[kAssocStages][kAssocThreads][kAssocStride];
  __shared__ float norm1[kAssocRows];
  const int p = blockIdx.y, a0 = blockIdx.x * kAssocRows;
  const int n = q.n, m = q.m, N = n * m, F = q.F, D = q.D;
  const int na_rows = min(kAssocRows, n - a0);
  const float* R1 = r1 + (size_t)p * n * F;
  const float* R2 = r2 + (size_t)p * m * F;
  const float* D1 = d1 + (size_t)p * n * D;
  const float* D2 = d2 + (size_t)p * m * D;
  const int tid = threadIdx.x;
  const int S = q.use_cosine ? (D + kAssocSlice - 1) / kAssocSlice : 0;

  for (int b0 = 0; b0 < m; b0 += kAssocThreads) {
    const int nb_rows = min(kAssocThreads, m - b0);
    const int b = b0 + tid;
    const bool col = tid < nb_rows, row = b0 == 0 && tid < na_rows;
    float dot[kAssocRows];
#pragma unroll
    for (int t = 0; t < kAssocRows; ++t) dot[t] = 0.f;
    float sb = 0.f, sa = 0.f;
    // slices s + 1 .. s + kAssocStages - 1 are copied while slice s is
    // summed; one commit group a slice (empty past the last)
    auto stage = [&](int s) {
      if (s < S) {
        const int k0 = s * kAssocSlice;
        stage_slice(D1, D2, D, q.vec, a0, na_rows, b0, nb_rows, k0,
                    min(kAssocSlice, D - k0), s1[s % kAssocStages],
                    s2[s % kAssocStages]);
      }
      cp_async_commit();
    };
    for (int s = 0; s < kAssocStages - 1; ++s) stage(s);
    for (int s = 0; s < S; ++s) {
      const int ks = min(kAssocSlice, D - s * kAssocSlice);
      cp_async_wait<kAssocStages - 2>();  // slice s has landed
      __syncthreads();  // for every thread; and slice s - 1 is summed
      stage(s + kAssocStages - 1);  // into slice s - 1's buffer
      const float (*x)[kAssocStride] = s1[s % kAssocStages];
      const float* y = s2[s % kAssocStages][tid];
      const int k4 = ks & ~3;
      // threads of columns sum their dots and their column's norm; threads
      // tid < na_rows also row tid's norm, from the same reads (a thread
      // that is not a column's reads a stale row of s2 and discards it)
      if (col || row) {
#pragma unroll 4
        for (int c = 0; c < k4; c += 4) {
          const float4 y4 = *reinterpret_cast<const float4*>(y + c);
          sb = sb + y4.x * y4.x;
          sb = sb + y4.y * y4.y;
          sb = sb + y4.z * y4.z;
          sb = sb + y4.w * y4.w;
#pragma unroll
          for (int t = 0; t < kAssocRows; ++t) {
            const float4 x4 = *reinterpret_cast<const float4*>(x[t] + c);
            dot[t] = dot[t] + x4.x * y4.x;
            dot[t] = dot[t] + x4.y * y4.y;
            dot[t] = dot[t] + x4.z * y4.z;
            dot[t] = dot[t] + x4.w * y4.w;
            if (row && t == tid) {
              sa = sa + x4.x * x4.x;
              sa = sa + x4.y * x4.y;
              sa = sa + x4.z * x4.z;
              sa = sa + x4.w * x4.w;
            }
          }
        }
        for (int c = k4; c < ks; ++c) {
          sb = sb + y[c] * y[c];
#pragma unroll
          for (int t = 0; t < kAssocRows; ++t) {
            dot[t] = dot[t] + x[t][c] * y[c];
            if (row && t == tid) sa = sa + x[t][c] * x[t][c];
          }
        }
      }
    }
    __syncthreads();  // the ring is refilled by the next pass
    if (row) norm1[tid] = sqrtf(sa);
    __syncthreads();
    if (!col) continue;
    const float nb = sqrtf(sb);
#pragma unroll
    for (int ta = 0; ta < kAssocRows; ++ta) {
      if (ta >= na_rows) break;
      const int a = a0 + ta, i = a * m + b;
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
        const float na = norm1[ta];
        const float den = na * nb;
        const float cs = den > 1e-9f ? dot[ta] / fmaxf(den, 1e-9f) : 1.f;
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
}

// ---------------------------------------------------------------------------
// build_affinity: grid (group of rows b_i, a_i, pair); 8 columns a thread.
//
// Writes M[i, j] (bf16) for association i = (a_i, b_i) (row) and
// j = (a_j, b_j) (column) from the flat vectors of assoc_terms:
// gravity-gated distance consistency, log-space geometric mean with the
// per-association half-logs, conflict / diagonal / invalid masks and the
// single scores on the diagonal. Replaces roman_tpu/align/
// fused_register.py:262-300 (the affinity block of K1).
//
// Bound on this card: the 5.12 MB a pair it writes (0.05 ms for 32 pairs
// at 3.35 TB/s), once the entries that are zero skip their arithmetic; a
// live entry costs one IEEE sqrtf, two IEEE divisions and the expf, logf,
// expf chain, and if every entry paid that the kernel would be bound by
// instruction issue. The design cuts everything else:
// - The intra-map geometry depends only on (a_i, a_j) and on (b_i, b_j).
//   Each block tabulates it in shared memory once (map 1: its own a_i
//   against every a_j; map 2: its rows' b_i against every b_j), so an
//   entry does no coordinate gather and 1 sqrtf instead of 5. Each value
//   is the same f32 expression of the same operands as the twin's.
// - The columns' half-logs and flags are staged in shared memory, the
//   rows' too; a column's flags are folded into one byte.
// - A thread walks 8 consecutive columns, carrying (a_j, b_j) forward from
//   a per-block table of chunk starts: no integer division per entry. The
//   8 bf16 go out as one 16-byte store where rows are 16-byte aligned
//   (N % 8 == 0), else one by one.
// - Entries that are +0 whatever the transcendentals give (a dead row or
//   column, a conflict, a failed gate or cdist >= epsilon) skip them: the
//   twin multiplies exp(...) by 0 there, so no bit changes.
// - Rows are split into groups of at most 16 b_i, so a
//   chunk of 3 pairs still gives hundreds of blocks; a block's (row,
//   chunk) items are dealt to its threads in turn, so only the last warp
//   of a block can be partly idle.
// With kCount (tracing on: the launch is given a counts buffer), each warp
// also adds the nonzero entries off the diagonal that its threads wrote to
// the pair's count; without it the kernel is the one that runs untraced.
// ---------------------------------------------------------------------------
constexpr int kBuildThreads = 256;
constexpr int kBuildMaxRows = 16;  // b_i rows a block, at most
constexpr int kBuildCols = 8;      // consecutive columns a thread: 16 bytes of bf16

// Dynamic shared memory of a block of R rows, as the kernel carves it:
// floats (t1: D, |dZ|, dxy of (a_i, a_j), 3 x n; t2: the same of (b_i, b_j),
// 3 x R x m; hlc: T x N column half-logs; hlr: T x R row half-logs; sgr: R
// single scores), then shorts (chunk starts a_j, b_j: 2 x C), then bytes
// (column live N, row live R, row valid R), so every part stays aligned.
inline size_t build_smem_bytes(int n, int m, int R, int T) {
  const int N = n * m, C = (N + kBuildCols - 1) / kBuildCols;
  return sizeof(float) * (3 * n + 3 * R * m + T * N + T * R + R) +
         sizeof(short) * 2 * C + N + 2 * R;
}

// intra-map geometry of two points, as the twin computes it:
// sqrt(dxy2 + dZ^2 + 1e-20), |dZ|, sqrt(dxy2 + 1e-20) of (row - column)
__device__ __forceinline__ void pair_geometry(const float* a, const float* b,
                                              float* D, float* Z, float* XY) {
  const float dX = a[0] - b[0], dY = a[1] - b[1], dZ = a[2] - b[2];
  const float dxy2 = dX * dX + dY * dY;
  *D = sqrtf(dxy2 + dZ * dZ + 1e-20f);
  *Z = fabsf(dZ);
  *XY = sqrtf(dxy2 + 1e-20f);
}

template <bool kCount>
__global__ void __launch_bounds__(kBuildThreads)
build_affinity_kernel(const float* __restrict__ c1, const float* __restrict__ c2,
                      const float* __restrict__ hl, const float* __restrict__ nz,
                      const float* __restrict__ single,
                      const float* __restrict__ vflat,
                      __nv_bfloat16* __restrict__ M_all, int* __restrict__ counts,
                      BuildParams q) {
  const int n = q.n, m = q.m, N = n * m, T = q.n_terms;
  const int G = gridDim.x, g = blockIdx.x, ai = blockIdx.y, p = blockIdx.z;
  // rows b0 .. b0 + R - 1 of a_i: the first m % G groups take one row more
  const int base = m / G, extra = m % G;
  const int R = base + (g < extra ? 1 : 0);
  const int b0 = g * base + min(g, extra);
  const int C = (N + kBuildCols - 1) / kBuildCols;  // chunks of 8 columns a row

  extern __shared__ __align__(16) unsigned char smem[];
  float* t1D = reinterpret_cast<float*>(smem);
  float* t1Z = t1D + n;
  float* t1XY = t1Z + n;
  float* t2D = t1XY + n;
  float* t2Z = t2D + R * m;
  float* t2XY = t2Z + R * m;
  float* hlc = t2XY + R * m;
  float* hlr = hlc + T * N;
  float* sgr = hlr + T * R;
  short* ja = reinterpret_cast<short*>(sgr + R);
  short* jb = ja + C;
  unsigned char* live_c = reinterpret_cast<unsigned char*>(jb + C);
  unsigned char* live_r = live_c + N;
  unsigned char* valid_r = live_r + R;

  const float* C1 = c1 + (size_t)p * n * 3;
  const float* C2 = c2 + (size_t)p * m * 3;
  const float* HL = hl + (size_t)p * 2 * N;
  const float* NZ = nz + (size_t)p * 2 * N;
  const float* SG = single + (size_t)p * N;
  const float* VF = vflat + (size_t)p * N;

  // ---- per-block tables ----
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    pair_geometry(C1 + ai * 3, C1 + k * 3, &t1D[k], &t1Z[k], &t1XY[k]);
  for (int k = threadIdx.x; k < R * m; k += blockDim.x) {
    const int r = k / m, bj = k - r * m;
    pair_geometry(C2 + (b0 + r) * 3, C2 + bj * 3, &t2D[k], &t2Z[k], &t2XY[k]);
  }
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    bool live = VF[j] > 0.5f;
    for (int t = 0; t < T; ++t) {
      hlc[t * N + j] = HL[t * N + j];
      live = live && NZ[t * N + j] > 0.5f;
    }
    live_c[j] = live;
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const int i = ai * m + b0 + r;
    const bool vi = VF[i] > 0.5f;
    bool live = vi;
    for (int t = 0; t < T; ++t) {
      hlr[t * R + r] = HL[t * N + i];
      live = live && NZ[t * N + i] > 0.5f;
    }
    sgr[r] = SG[i];
    valid_r[r] = vi;
    live_r[r] = live;
  }
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int a = c * kBuildCols / m;
    ja[c] = (short)a;
    jb[c] = (short)(c * kBuildCols - a * m);
  }
  __syncthreads();

  // ---- items (row r, chunk c of 8 columns), dealt to the threads in turn ----
  const float num_comp = (float)(1 + T);
  const bool vec_store = (N % kBuildCols) == 0;
  int nonzeros = 0;  // off the diagonal, this thread's entries (kCount)
  int r = threadIdx.x / C, c = threadIdx.x - (threadIdx.x / C) * C;
  for (int it = threadIdx.x; it < R * C; it += blockDim.x) {
    const int bi = b0 + r;
    const size_t row = (size_t)p * N * N + (size_t)(ai * m + bi) * N;
    const int j0 = c * kBuildCols;
    const int kn = min(kBuildCols, N - j0);
    const bool rlive = live_r[r];
    const float* t2Dr = t2D + r * m;
    const float* t2Zr = t2Z + r * m;
    const float* t2XYr = t2XY + r * m;
    int aj = ja[c], bj = jb[c];
    float v[kBuildCols];
#pragma unroll
    for (int k = 0; k < kBuildCols; ++k) {
      const bool same_a = aj == ai, same_b = bj == bi;
      const bool live = k < kn && rlive && !same_a && !same_b && live_c[j0 + k];
      float val = 0.f;
      if (live) {
        const float D1 = t1D[aj], D2 = t2Dr[bj];
        const bool gate = D1 > q.mindist && D2 > q.mindist;
        float cdist;
        if (q.gravity) {
          const float slack = q.sin_unc * fmaxf(D1, D2);
          const float cz = fmaxf(fabsf(t1Z[aj] - t2Zr[bj]) - slack, 0.f);
          const float cxy = fabsf(t1XY[aj] - t2XYr[bj]);
          cdist = sqrtf(cz * cz + cxy * cxy + 1e-20f);
        } else {
          cdist = fabsf(D1 - D2);
        }
        const bool close = cdist < q.epsilon && gate;
        if (close) {
          const float tq = cdist / q.sigma;
          const float sd = expf(-0.5f * (tq * tq));
          float logM = logf(fmaxf(sd, 1e-20f));
          for (int t = 0; t < T; ++t) {
            logM = logM + hlr[t * R + r];
            logM = logM + hlc[t * N + j0 + k];
          }
          val = expf(logM / num_comp) * (sd > 0.f ? 1.f : 0.f);
        }
      }
      // the diagonal: the masked 0 plus the single score (twin: M + (s + 0 M))
      if (same_a && same_b) val = valid_r[r] ? 0.f + (sgr[r] + 0.f) : 0.f;
      else if (kCount) nonzeros += val != 0.f;
      v[k] = val;
      if (++bj == m) { bj = 0; ++aj; }
    }
    if (vec_store) {
      uint4 pk;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&pk);
#pragma unroll
      for (int k = 0; k < kBuildCols / 2; ++k)
        h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      *reinterpret_cast<uint4*>(M_all + row + j0) = pk;
    } else {
#pragma unroll
      for (int k = 0; k < kBuildCols; ++k)
        if (k < kn) M_all[row + j0 + k] = __float2bfloat16_rn(v[k]);
    }
    c += blockDim.x;
    while (c >= C) { c -= C; ++r; }
  }
  if constexpr (kCount) {
    nonzeros = __reduce_add_sync(0xffffffffu, nonzeros);
    if ((threadIdx.x & 31) == 0 && nonzeros) atomicAdd(counts + p, nonzeros);
  }
}

// ---------------------------------------------------------------------------
// round_refine: one block of kRoundThreads per pair.
//
// Greedy one-to-one rounding (cut 0.35 * max u; target round(2F) clipped
// to [1, max_steps], max_steps when F <= 0) and the support refinement
// (roman_tpu/align/fused_register.py:481-638; twins clipper.round_greedy
// and clipper.refine_selection_2d). Bound on this card by latency, not
// work: a pair has tens of selected entries and a few microseconds of
// arithmetic, so the design removes serial chains of barriers and of
// dependent global loads.
//
// Rounding as one sorted scan. The greedy takes, max_steps times, the
// largest u among entries whose row and column are both free (the first
// index on a tie), if it is above the cut, above 0 and fewer than target
// are taken. Give each entry above the cut and above 0 the 64-bit key
// (~bits(u), index): positive floats order as their bits, so ascending
// keys are u descending, index ascending, a strict total order. Walk the
// keys in that order and accept an entry when its row and column are free,
// until target are taken. This is exactly the greedy: at each step its pick
// is the first free entry in key order (an entry with a larger key than a
// free entry above the cut is itself above the cut, so it is in the list);
// an entry the walk passes over already had its row or column taken, and
// that stays taken; both stop at the cut and at the target; and since a
// step that takes nothing ends the greedy, its max_steps steps never bind
// before target <= max_steps does. So the block finds max u (one
// reduction), compacts the keys above the cut into shared memory (warp
// ballots, one shared counter), sorts them (bitonic; in one warp's
// registers for up to 32 keys), and one warp walks them 32 at a time with
// row and column occupancy as bitmasks: no barrier and no integer division
// a step. Where more keys lie above the cut than a band holds
// (kRoundBandKeys), they are taken in bands of consecutive keys, each
// band's end found by a binary search on the key; never at N <= 4096.
//
// Refinement on a K x K tile. The K selected indices are put in index
// order by a parallel rank, and T[l][k] = M[list[l], list[k]] is gathered
// into shared memory once, all K^2 loads in flight together. One warp then
// runs the iterations from the tile: support and zero-edge counts a lane
// per column (sums over l ascending; the columns a lane takes, 1 to 8, are
// a template argument: with a branch for each of 8 column slots the kernel
// took 3.3x as long on an H100 at the bench shapes), k by ballots, the mean
// support by a sum over k ascending, the worst entry by a warp arg-min
// (first minimum). Every sum whose bits decide a drop is taken in one fixed
// order, l then k ascending.
// ---------------------------------------------------------------------------
constexpr int kRoundThreads = 256;
constexpr int kRoundMaxSide = 256;                  // n, m, max_steps at most
constexpr int kRoundWords = kRoundMaxSide / 32;     // occupancy bitmask words
constexpr int kRoundBandKeys = 4096;                // sorted keys a band, at most
constexpr unsigned long long kNoKey = ~0ull;        // above every key

// Keys a band holds: the next power of two of N, at most kRoundBandKeys.
inline int round_band(int N) {
  int b = 1;
  while (b < N && b < kRoundBandKeys) b <<= 1;
  return b;
}

// (~bits(u), j): ascending keys are u descending, index ascending. Only
// for u > 0, so no key reaches kNoKey.
__device__ __forceinline__ unsigned long long round_key(float v, int j) {
  return ((unsigned long long)(~__float_as_uint(v)) << 32) | (unsigned)j;
}

// Append the keys in (lo, hi] of the entries above the cut to keys[], at
// most `band` of them; every thread adds to *n_keys the number it found.
__device__ __forceinline__ void round_compact(const float* U, int N, float cut,
                                              unsigned long long lo,
                                              unsigned long long hi,
                                              unsigned long long* keys, int band,
                                              int* n_keys) {
  const int lane = threadIdx.x & 31;
  for (int j0 = 0; j0 < N; j0 += blockDim.x) {
    const int j = j0 + threadIdx.x;
    bool cand = false;
    unsigned long long key = 0;
    if (j < N) {
      const float v = U[j];
      if (v > cut && v > 0.f) {
        key = round_key(v, j);
        cand = key > lo && key <= hi;
      }
    }
    const unsigned b = __ballot_sync(0xffffffffu, cand);
    int base = 0;
    if (lane == 0 && b) base = atomicAdd(n_keys, __popc(b));
    base = __shfl_sync(0xffffffffu, base, 0);
    const int pos = base + __popc(b & ((1u << lane) - 1u));
    if (cand && pos < band) keys[pos] = key;
  }
}

// The smallest key h with at least `band` keys of entries above the cut in
// (lo, h]; there are more than `band` keys above lo. Every thread calls it.
__device__ unsigned long long round_band_end(const float* U, int N, float cut,
                                             unsigned long long lo, int band,
                                             float* red) {
  unsigned long long a = lo + 1, b = kNoKey - 1;
  while (a < b) {
    const unsigned long long mid = a + (b - a) / 2;
    float c = 0.f;
    for (int j = threadIdx.x; j < N; j += blockDim.x) {
      const float v = U[j];
      if (v > cut && v > 0.f) {
        const unsigned long long key = round_key(v, j);
        c += (key > lo && key <= mid) ? 1.f : 0.f;
      }
    }
    if (roman::block_sum(c, red) >= (float)band) b = mid;
    else a = mid + 1;
    __syncthreads();  // red is reused by the next sum
  }
  return a;
}

// Ascending bitonic sort of keys[0, P2), P2 a power of two: by the block
// in shared memory, or by warp 0 in registers (a key a lane) for P2 <= 32.
// Every thread calls it.
__device__ __forceinline__ void round_sort(unsigned long long* keys, int P2) {
  if (P2 <= 32) {
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    unsigned long long x = lane < P2 ? keys[lane] : kNoKey;
    for (int k = 2; k <= 32; k <<= 1)
      for (int j = k >> 1; j > 0; j >>= 1) {
        const unsigned long long y = __shfl_xor_sync(0xffffffffu, x, j);
        // the lower lane of a pair keeps the smaller key in an ascending run
        const bool keep_min = ((lane & j) == 0) == ((lane & k) == 0);
        x = (x < y) == keep_min ? x : y;
      }
    if (lane < P2) keys[lane] = x;
    __syncwarp();
    return;
  }
  for (int k = 2; k <= P2; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < P2 / 2; i += blockDim.x) {
        const int x = 2 * i - (i & (j - 1));  // i's pair: x and x + j
        const unsigned long long a = keys[x], b = keys[x + j];
        if ((a > b) == ((x & k) == 0)) { keys[x] = b; keys[x + j] = a; }
      }
      __syncthreads();
    }
}

// The refinement iterations on the K x K tile, by one warp; lane + 32 c is
// column k, C columns a lane (K <= 32 C). Writes alive[] and the count.
template <int C>
__device__ __forceinline__ void round_refine_warp(const __nv_bfloat16* tile, int K,
                                                  const RoundParams& q, float tgt,
                                                  unsigned char* alive, float* supp,
                                                  int* count) {
  const int lane = threadIdx.x & 31;
  bool al[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int k = lane + 32 * c;
    al[c] = k < K;
    if (k < K) alive[k] = 1;
  }
  __syncwarp();
  for (int it = 0; it < q.refine_iters; ++it) {
    int kc = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) kc += __popc(__ballot_sync(0xffffffffu, al[c]));
    const float kk = (float)kc;
    float mv[C], z[C];
#pragma unroll
    for (int c = 0; c < C; ++c) { mv[c] = 0.f; z[c] = 0.f; }
    // over l ascending, a fixed order; a lane past K reads column
    // K - 1 and discards it
#pragma unroll 4
    for (int l = 0; l < K; ++l) {
      const bool a = alive[l];
      const __nv_bfloat16* row = tile + l * K;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int k = lane + 32 * c;
        const float e = __bfloat162float(row[min(k, K - 1)]);
        mv[c] = mv[c] + (a ? e : 0.f);
        z[c] = z[c] + ((a && l != k && e <= q.edge_eps) ? 1.f : 0.f);
      }
    }
    float sp[C];
    float wv = INFINITY;
    int wi = 0x7fffffff;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int k = lane + 32 * c;
      sp[c] = mv[c] / fmaxf(kk - 1.f, 1.f);
      if (k < K) supp[k] = sp[c];
      if (al[c] && z[c] > 0.5f) roman::argmin_merge(wv, wi, sp[c], k);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      roman::argmin_merge(wv, wi, __shfl_xor_sync(0xffffffffu, wv, o),
                          __shfl_xor_sync(0xffffffffu, wi, o));
    __syncwarp();
    float s = 0.f;  // over k ascending, a fixed order
#pragma unroll 4
    for (int k = 0; k < K; ++k) s = s + (alive[k] ? supp[k] : 0.f);
    const float thresh = fmaxf(q.rel_support * (s / fmaxf(kk, 1.f)), q.min_support);
    const bool drop = wi != 0x7fffffff && kk > tgt;
    __syncwarp();
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int k = lane + 32 * c;
      al[c] = al[c] && sp[c] >= thresh && !(drop && k == wi);
      if (k < K) alive[k] = al[c];
    }
    __syncwarp();
  }
  int kc = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) kc += __popc(__ballot_sync(0xffffffffu, al[c]));
  if (lane == 0) *count = kc;
}

__global__ void __launch_bounds__(kRoundThreads)
round_refine_kernel(const __nv_bfloat16* __restrict__ M_all,
                    const float* __restrict__ u_all, const float* __restrict__ F_all,
                    const float* __restrict__ omega_all,
                    unsigned char* __restrict__ sel_out, int* __restrict__ count_out,
                    RoundParams q, int band) {
  // band sorted keys, then the max_steps x max_steps tile of bf16
  extern __shared__ __align__(16) unsigned char round_smem[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(round_smem);
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(keys + band);
  __shared__ float red[33];
  __shared__ unsigned row_used[kRoundWords], col_used[kRoundWords];
  __shared__ int list[kRoundMaxSide];   // selected indices, in pick order
  __shared__ int order[kRoundMaxSide];  // the same, in index order
  __shared__ float supp[kRoundMaxSide];
  __shared__ unsigned char alive[kRoundMaxSide];
  __shared__ int n_keys, n_sel;

  const int p = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int n = q.n, m = q.m, N = n * m;
  const float* U = u_all + (size_t)p * N;
  const __nv_bfloat16* M = M_all + (size_t)p * N * N;

  if (tid == 0) { n_keys = 0; n_sel = 0; }
  if (tid < kRoundWords) { row_used[tid] = 0u; col_used[tid] = 0u; }
  float mx = -INFINITY;
  for (int j = tid; j < N; j += blockDim.x) mx = fmaxf(mx, U[j]);
  const float cut = q.rel_thresh * roman::block_max(mx, red);
  const float Fv = F_all[p];
  const float target = Fv > 0.f
      ? fminf(fmaxf(rintf(Fv * 2.f), 1.f), (float)q.max_steps)
      : (float)q.max_steps;

  // ---- rounding: sorted bands of keys, walked by warp 0 ----
  unsigned long long lo = 0;  // keys <= lo are walked
  for (;;) {
    round_compact(U, N, cut, lo, kNoKey, keys, band, &n_keys);
    __syncthreads();
    int c = n_keys;
    unsigned long long hi = kNoKey;
    if (c > band) {  // more keys than a band: take the first `band` of them
      hi = round_band_end(U, N, cut, lo, band, red);
      if (tid == 0) n_keys = 0;
      __syncthreads();
      round_compact(U, N, cut, lo, hi, keys, band, &n_keys);
      __syncthreads();
      c = band;
    }
    if (c == 0) break;
    int P2 = 1;
    while (P2 < c) P2 <<= 1;
    for (int i = c + tid; i < P2; i += blockDim.x) keys[i] = kNoKey;
    __syncthreads();
    round_sort(keys, P2);
    if (tid < 32) {
      int taken = n_sel;
      for (int b0 = 0; b0 < c && (float)taken < target; b0 += 32) {
        const int t = b0 + lane;
        const int j = t < c ? (int)(keys[t] & 0xffffffffu) : 0;
        const int r = j / m, col = j - r * m;
        const bool free = t < c && !((row_used[r >> 5] >> (r & 31)) & 1u) &&
                          !((col_used[col >> 5] >> (col & 31)) & 1u);
        unsigned cand = __ballot_sync(0xffffffffu, free);
        unsigned acc = 0u;  // accepted lanes: each is the first free one left
        const int start = taken;
        while (cand && (float)taken < target) {
          const int w = __ffs(cand) - 1;
          const int rw = __shfl_sync(0xffffffffu, r, w);
          const int cw = __shfl_sync(0xffffffffu, col, w);
          acc |= 1u << w;
          ++taken;
          cand &= ~__ballot_sync(0xffffffffu, r == rw || col == cw);
        }
        if ((acc >> lane) & 1u) {
          list[start + __popc(acc & ((1u << lane) - 1u))] = j;
          atomicOr(&row_used[r >> 5], 1u << (r & 31));
          atomicOr(&col_used[col >> 5], 1u << (col & 31));
        }
        __syncwarp();
      }
      if (lane == 0) n_sel = taken;
    }
    __syncthreads();
    if (hi == kNoKey || (float)n_sel >= target) break;
    lo = hi;
    if (tid == 0) n_keys = 0;
    __syncthreads();
  }

  // ---- index order by rank, then the K x K tile of M ----
  const int K = n_sel;
  if (tid < K) {
    const int me = list[tid];
    int r = 0;
    for (int l = 0; l < K; ++l) r += list[l] < me ? 1 : 0;
    order[r] = me;
  }
  __syncthreads();
  const int KK = K * K;
  for (int e0 = 0; e0 < KK; e0 += 8 * blockDim.x) {
    __nv_bfloat16 v[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int e = e0 + t * blockDim.x + tid;
      if (e < KK) {
        const int l = e / K;
        v[t] = M[(size_t)order[l] * N + order[e - l * K]];
      }
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int e = e0 + t * blockDim.x + tid;
      if (e < KK) tile[e] = v[t];
    }
  }
  __syncthreads();

  // ---- support refinement, one warp ----
  if (tid < 32) {
    const float tgt = fmaxf(rintf(omega_all[p]), 0.f);
    int* count = count_out + p;
    if (K <= 32) round_refine_warp<1>(tile, K, q, tgt, alive, supp, count);
    else if (K <= 64) round_refine_warp<2>(tile, K, q, tgt, alive, supp, count);
    else if (K <= 128) round_refine_warp<4>(tile, K, q, tgt, alive, supp, count);
    else round_refine_warp<8>(tile, K, q, tgt, alive, supp, count);
  }

  for (int j = tid; j < N; j += blockDim.x) sel_out[(size_t)p * N + j] = 0;
  __syncthreads();
  if (tid < K && alive[tid]) sel_out[(size_t)p * N + order[tid]] = 1;
}

}  // namespace

extern "C" int assoc_terms_launch(const void* r1, const void* d1, const void* r2,
                                  const void* d2, const void* valid, void* hl,
                                  void* nz, void* single, void* vflat, int P,
                                  int n, int m, int F, int D, int use_ratio,
                                  int use_cosine, float eps_shape, float cos_min,
                                  float cos_den, void* stream) {
  if (n == 0 || m == 0) return 0;  // no association: nothing to write
  if (P > 65535) return (int)cudaErrorInvalidValue;  // grid's y
  const int vec = D % 4 == 0 && (uintptr_t)d1 % 16 == 0 && (uintptr_t)d2 % 16 == 0;
  AssocParams q{n, m, F, D, use_ratio, use_cosine, vec, eps_shape, cos_min, cos_den};
  dim3 grid((n + kAssocRows - 1) / kAssocRows, P);
  assoc_terms_kernel<<<grid, kAssocThreads, 0, (cudaStream_t)stream>>>(
      (const float*)r1, (const float*)d1, (const float*)r2, (const float*)d2,
      (const float*)valid, (float*)hl, (float*)nz, (float*)single, (float*)vflat, q);
  return (int)cudaGetLastError();
}

// counts: null, or (P,) int32 that the launch sets to each pair's nonzero
// entries of M off its diagonal
extern "C" int build_affinity_launch(const void* c1, const void* c2, const void* hl,
                                     const void* nz, const void* single,
                                     const void* vflat, void* M, void* counts, int P,
                                     int n, int m, int n_terms, int gravity,
                                     float sigma, float epsilon, float mindist,
                                     float sin_unc, void* stream) {
  BuildParams q{n, m, n_terms, gravity, sigma, epsilon, mindist, sin_unc};
  // row groups of one a_i: at most kBuildMaxRows b_i each, as even as possible
  const int G = (m + kBuildMaxRows - 1) / kBuildMaxRows;
  if (counts) {
    cudaError_t e = cudaMemsetAsync(counts, 0, sizeof(int) * P, (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
  }
  if (n == 0 || m == 0) return 0;  // no association: nothing to write
  if (n > 32767 || m > 32767 || P > 65535)  // short chunk table; grid's z
    return (int)cudaErrorInvalidValue;
  const size_t smem = build_smem_bytes(n, m, (m + G - 1) / G, n_terms);
  auto kernel = counts ? build_affinity_kernel<true> : build_affinity_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(G, n, P);
  kernel<<<grid, kBuildThreads, smem, (cudaStream_t)stream>>>(
      (const float*)c1, (const float*)c2, (const float*)hl, (const float*)nz,
      (const float*)single, (const float*)vflat, (__nv_bfloat16*)M, (int*)counts, q);
  return (int)cudaGetLastError();
}

extern "C" int round_refine_launch(const void* M, const void* u, const void* F,
                                   const void* omega, void* sel, void* count,
                                   int P, int n, int m, int max_steps,
                                   int refine_iters, float rel_thresh,
                                   float min_support, float rel_support,
                                   float edge_eps, void* stream) {
  static_assert(kRoundThreads >= kRoundMaxSide, "a thread per selected entry");
  if (n > kRoundMaxSide || m > kRoundMaxSide || max_steps > kRoundMaxSide)
    return (int)cudaErrorInvalidValue;
  RoundParams q{n, m, max_steps, refine_iters, rel_thresh, min_support,
                rel_support, edge_eps};
  const int band = round_band(n * m);
  const size_t smem = sizeof(unsigned long long) * band +
                      sizeof(__nv_bfloat16) * (size_t)max_steps * max_steps;
  auto kernel = round_refine_kernel;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<P, kRoundThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)M, (const float*)u, (const float*)F,
      (const float*)omega, (unsigned char*)sel, (int*)count, q, band);
  return (int)cudaGetLastError();
}
