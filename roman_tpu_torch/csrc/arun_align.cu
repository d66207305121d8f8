// Arun's T_align of each pair's selected center correspondences, in one
// launch: replaces the registration finish's torch ops around a library
// SVD (roman_tpu_torch/ops/arun.py::arun over the (n * m) expanded
// centers, weights the selection), which waited for the card twice to read
// the solver's info flags. Semantics and the plain twin:
// roman_tpu_torch/ops/arun.py::arun_align_plain.
//
// One block of kArunThreads per pair. Per pair, over the associations k =
// a * m + b with sel[k] != 0:
// - first pass: the count and the sums of c1[a] and c2[b], so the means
//   m1, m2 (the count clamped at 1e-9, as the twin clamps its weight sum);
// - second pass: H = sum (c1[a] - m1)(c2[b] - m2)^T. Two passes, not
//   sum c1 c2^T - w m1 m2^T: the centers sit up to about 240 m from the
//   origin, where the f32 cancellation of the one-pass form would move T
//   by millimetres;
// - the 3x3 SVD in f32, H scaled by its largest entry: a one-sided
//   (Hestenes) Jacobi of kJacobiSweeps fixed sweeps over the column pairs
//   (0,1), (0,2), (1,2) gives H V = B with orthogonal columns, V a proper
//   rotation. The columns are sorted by norm, descending (the lower index
//   first on a tie), and V's third column is negated where the sort's
//   permutation was odd, so V stays proper. U = [u1, u2, u1 x u2], with u1
//   and u2 the first two columns of B orthonormalized (u2 from the axis
//   least along u1 where B's second column is no more than rounding), is
//   proper too, and H = U diag(s1, s2, +-s3) V^T. The twin's reflection fix
//   R = U' diag(1, 1, sign det(U' V'^T)) V'^T over the SVD with s3 >= 0 is
//   then exactly R = U V^T: no determinant is taken;
// - t = m1 - R m2; T = [R t; 0 0 0 1] is written straight to the output.
// With no selection (or one association: H = 0) R is the identity, as the
// twin's SVD of a zero matrix gives; with none, m1 = m2 = 0 and T = I.
//
// Each thread sums its associations k = tid, tid + kArunThreads, ... in
// order; the threads' partial sums are added by a fixed tree. So a pair's
// T depends only on its own inputs: the same at any batch size and
// position, and from run to run.
//
// Bound on this card: reading sel (n * m bytes a pair, twice; 1.6 KB at
// capacity 40) and the selected centers; what costs is the latency of the
// serial 3x3 solve on one thread of each block, a few microseconds a launch.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kArunThreads = 128;
constexpr int kArunWarps = kArunThreads / 32;
constexpr int kJacobiSweeps = 6;
constexpr float kJacobiTol = 1e-7f;  // columns orthogonal to f32 precision
constexpr float kRankTol = 1e-6f;    // B's second column below this is rounding

// The K values v summed over the block: each warp by a shuffle tree, then
// the warps' sums in warp order. Every thread gets the sums.
template <int K>
__device__ __forceinline__ void block_sums(float (&v)[K], float (*s)[K]) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = roman::warp_sum(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) s[wid][k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float t = s[0][k];
#pragma unroll
    for (int w = 1; w < kArunWarps; ++w) t += s[w][k];
    v[k] = t;
  }
  __syncthreads();
}

__device__ __forceinline__ float dot3(const float* x, const float* y) {
  return x[0] * y[0] + x[1] * y[1] + x[2] * y[2];
}

// R (row-major 3x3) of the proper rotation maximizing tr(R^T H), for H
// (row-major 3x3, any scale): see the file's head.
__device__ void rotation_of(const float (&Hin)[9], float (&R)[9]) {
  float hmax = 0.f;
#pragma unroll
  for (int i = 0; i < 9; ++i) hmax = fmaxf(hmax, fabsf(Hin[i]));
#pragma unroll
  for (int i = 0; i < 9; ++i) R[i] = (i % 4 == 0) ? 1.f : 0.f;
  if (!(hmax > 0.f)) return;  // no spread (or not finite): the identity
  // column j of B is b[j][0..2]; column j of V is v[j][0..2]
  float b[3][3], v[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      b[j][i] = Hin[i * 3 + j] / hmax;
      v[j][i] = i == j ? 1.f : 0.f;
    }
  for (int sweep = 0; sweep < kJacobiSweeps; ++sweep) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int p = r == 2 ? 1 : 0, q = r == 0 ? 1 : 2;
      const float al = dot3(b[p], b[p]), be = dot3(b[q], b[q]), ga = dot3(b[p], b[q]);
      if (!(fabsf(ga) > kJacobiTol * sqrtf(al * be))) continue;
      const float zeta = (be - al) / (2.f * ga);
      const float t = (zeta >= 0.f ? 1.f : -1.f) / (fabsf(zeta) + sqrtf(1.f + zeta * zeta));
      const float c = 1.f / sqrtf(1.f + t * t), s = c * t;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float bp = b[p][i], bq = b[q][i];
        b[p][i] = c * bp - s * bq;
        b[q][i] = s * bp + c * bq;
        const float vp = v[p][i], vq = v[q][i];
        v[p][i] = c * vp - s * vq;
        v[q][i] = s * vp + c * vq;
      }
    }
  }
  float nrm[3] = {dot3(b[0], b[0]), dot3(b[1], b[1]), dot3(b[2], b[2])};
  int order[3] = {0, 1, 2};
  bool odd = false;
  auto sort2 = [&](int x, int y) {  // larger norm first; a tie keeps the order
    if (nrm[order[y]] > nrm[order[x]]) {
      const int o = order[x];
      order[x] = order[y];
      order[y] = o;
      odd = !odd;
    }
  };
  sort2(0, 1);
  sort2(1, 2);
  sort2(0, 1);
  const float* b1 = b[order[0]];
  const float* b2 = b[order[1]];
  const float sign3 = odd ? -1.f : 1.f;
  const float* V[3] = {v[order[0]], v[order[1]], v[order[2]]};
  const float n1 = sqrtf(nrm[order[0]]);
  if (!(n1 > 0.f)) return;
  float u[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) u[0][i] = b1[i] / n1;
  const float proj = dot3(u[0], b2);
  float w[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) w[i] = b2[i] - proj * u[0][i];
  float nw = sqrtf(dot3(w, w));
  if (!(nw > kRankTol * n1)) {  // rank 1: any unit vector orthogonal to u1
    int k = 0;
    if (fabsf(u[0][1]) < fabsf(u[0][k])) k = 1;
    if (fabsf(u[0][2]) < fabsf(u[0][k])) k = 2;
#pragma unroll
    for (int i = 0; i < 3; ++i) w[i] = (i == k ? 1.f : 0.f) - u[0][k] * u[0][i];
    nw = sqrtf(dot3(w, w));
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) u[1][i] = w[i] / nw;
  u[2][0] = u[0][1] * u[1][2] - u[0][2] * u[1][1];
  u[2][1] = u[0][2] * u[1][0] - u[0][0] * u[1][2];
  u[2][2] = u[0][0] * u[1][1] - u[0][1] * u[1][0];
  // R = U V^T = sum_k u_k v_k^T, v_3 negated after an odd sort
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      R[i * 3 + j] = u[0][i] * V[0][j] + u[1][i] * V[1][j] + u[2][i] * (sign3 * V[2][j]);
}

__global__ void __launch_bounds__(kArunThreads)
arun_align_kernel(const unsigned char* __restrict__ sel, const float* __restrict__ c1,
                  const float* __restrict__ c2, float* __restrict__ T, int n, int m) {
  __shared__ float s7[kArunWarps][7];
  __shared__ float s9[kArunWarps][9];
  const int p = blockIdx.x, tid = threadIdx.x;
  const int N = n * m;
  const unsigned char* sp = sel + (size_t)p * N;
  const float* p1 = c1 + (size_t)p * n * 3;
  const float* p2 = c2 + (size_t)p * m * 3;

  // first pass: count, sum of c1[a], sum of c2[b]
  float acc[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int k = tid; k < N; k += kArunThreads) {
    if (!sp[k]) continue;
    const int a = k / m, b = k - a * m;
    acc[0] += 1.f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      acc[1 + i] += p1[a * 3 + i];
      acc[4 + i] += p2[b * 3 + i];
    }
  }
  block_sums<7>(acc, s7);
  const float wsum = fmaxf(acc[0], 1e-9f);
  float m1[3], m2[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    m1[i] = acc[1 + i] / wsum;
    m2[i] = acc[4 + i] / wsum;
  }

  // second pass: the centred H
  float h[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int k = tid; k < N; k += kArunThreads) {
    if (!sp[k]) continue;
    const int a = k / m, b = k - a * m;
    float q1[3], q2[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      q1[i] = p1[a * 3 + i] - m1[i];
      q2[i] = p2[b * 3 + i] - m2[i];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) h[i * 3 + j] += q1[i] * q2[j];
  }
  block_sums<9>(h, s9);

  if (tid != 0) return;
  float R[9];
  rotation_of(h, R);
  float* out = T + (size_t)p * 16;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    out[i * 4 + 0] = R[i * 3 + 0];
    out[i * 4 + 1] = R[i * 3 + 1];
    out[i * 4 + 2] = R[i * 3 + 2];
    out[i * 4 + 3] = m1[i] - (R[i * 3 + 0] * m2[0] + R[i * 3 + 1] * m2[1] +
                              R[i * 3 + 2] * m2[2]);
  }
  out[12] = 0.f;
  out[13] = 0.f;
  out[14] = 0.f;
  out[15] = 1.f;
}

}  // namespace

// sel (P, n, m) bytes (0 or not), c1 (P, n, 3), c2 (P, m, 3) f32 -> T
// (P, 4, 4) f32, on `stream`; allocates nothing
extern "C" int arun_align_launch(const void* sel, const void* c1, const void* c2,
                                 void* T, int P, int n, int m, void* stream) {
  if (P == 0) return 0;
  if (n < 0 || m < 0) return (int)cudaErrorInvalidValue;
  arun_align_kernel<<<P, kArunThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned char*)sel, (const float*)c1, (const float*)c2, (float*)T, n, m);
  return (int)cudaGetLastError();
}
