// CLIPPER solve on a prepared bf16 affinity, one pair per thread block
// cluster.
//
// Replaces roman_tpu/align/clipper_pallas.py:50 `_solve_kernel` (K2) and
// the solve phase of roman_tpu/align/fused_register.py:111 `_kernel` (K1):
// warmup power iterations, optional restart expansion, penalty homotopy
// with the rank-structured one-to-one constraint product
// (Cb u)[a,b] = rowsum[a] + colsum[b] - 2 u[a,b], and the choice of the
// best feasible restart. Semantics: roman_tpu_torch/align/clipper_solve.py
// (`clipper_solve_plain` is the twin this kernel is tested against).
//
// The layout. A pair is solved by a cluster of C blocks (C from the
// wrapper: the largest power of two <= 8 with P * C <= SMs), and block
// `rank` owns a slice of columns of u @ M, a multiple of 8 columns wide
// (the last slice is ragged). All R restart rows ride one pass over the
// slice (R accumulators a column). Inside a block a thread owns
// neighbouring columns and one of S row segments (rows i = s mod S); each
// segment sums its columns in row order and the segments are added in
// segment order, so u is bitwise the same from run to run and depends on
// the other pairs of the launch only through C.
//
// What bounds a streamed solve: bytes. One solve does warmup + outer *
// (inner + 1) + 1 = 51 matvecs at the default budget, and a matvec that
// streams the pair's (N, N) bf16 M reads 5.12 MB at N = 1600: 261 MB a
// pair, which no cache on the card holds. But the fused affinity is almost
// all zeros: a row of M is +0 wherever its association fails the gates (on
// the demo's grid 0.56% of the rows hold a nonzero, at most 3%), and a
// zero row adds nothing to a column's sum (bf16(u_i) x 0 is a zero, and a
// zero added to a sum that starts at +0 leaves it bitwise as it was). So:
//
// - the first matvec streams the block's slice (below) and marks every row
//   that holds a nonzero in it; a row dead in this slice adds nothing to
//   this block's columns, so no marks cross the cluster;
// - the block then lists its marked rows in row order and copies its slice
//   of them into shared memory (the ring's stages, free from then on), and
//   every later matvec reads only those rows: thread (s, g) sums the listed
//   rows of its segment, in row order, and the segments are added in
//   segment order as before. Each matvec, and so the solve, is bitwise the
//   streamed one;
// - a block whose marked rows do not fit (a dense M, as the other fusions
//   build; large slices) streams its slice for every matvec, as before.
//   What it observes in M decides; nothing else does.
//
// With the rows on chip a matvec is a few microseconds of arithmetic, and
// the solve is bound by what every iteration does besides: the cluster
// exchanges of its sums (distributed shared memory and `cluster.sync()`),
// the row and column sums of Cb u, and the first pass's one read of M.
//
// Streaming: where every row of M starts 16-byte aligned and two stages fit
// beside the vectors, one thread keeps a ring of shared-memory stages of up
// to 128 rows of the slice filled with asynchronous bulk tensor copies (TMA
// boxes of at most 256 columns), their arrival reported to an mbarrier a
// stage; a thread owns 8 neighbouring columns. Otherwise threads load M
// into registers, one column a thread, and keep their rows in the shared
// memory left after the vectors; that path takes every shape the kernel
// takes at all, so it needs nothing more than the vectors (a block with no
// room left streams). The resident rows keep each path's thread layout, so
// its segments, and its sum order.
//
// The homotopy step is elementwise on the slice. What it needs of the
// whole pair travels through distributed shared memory: each block sends
// its partial sums (the norm, the d-update's num/den/violations, F and
// omega) into every block of its cluster, and every block adds the C
// partials in rank order, so all blocks hold the same value. Each block
// then writes its slice of the new u into every block, and after
// `cluster.sync()` every block holds the full u for the next matvec and for
// the row and column sums of Cb u, which it computes itself.
//
// Numerics: u is rounded to bf16 before every matvec (as the TPU kernels
// do); a bf16 x bf16 product is exact in f32, so the matvec's fused
// multiply-add rounds as a product and a sum would. Norms divide by
// max(||u||, 1e-9); all-invalid pairs give u = 0 without NaN.
#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;       // rows of M a thread has in flight (register loads)
constexpr int kMaxCluster = 8;   // the largest portable cluster
constexpr int kMaxRestarts = 8;
constexpr int kMaxSums = 3 * kMaxRestarts;  // values one exchange carries

// Per-block scratch besides the vectors in dynamic shared memory.
struct Scratch {
  float red[kMaxSums][kWarps];               // per-warp partials
  float xch[2][kMaxCluster][kMaxSums];       // every rank's partials, by parity
  float tot[kMaxSums];                       // the cluster-wide sums
  float d[kMaxRestarts];
  int live[kWarps];                          // marked rows each warp counted
  int resident;                              // this block keeps its rows
};

// Width of a block's column slice: N / C rounded up to 8 columns.
__host__ __device__ inline int slice_width(int N, int C) {
  return ((N + C - 1) / C + 7) / 8 * 8;
}

// Row segments of the register-load mapping (one column a thread) and of
// the ring's (8 columns a thread) for a slice `width` columns wide.
__device__ __forceinline__ int column_segments(int width) {
  return (width == 0 || width >= kThreads) ? 1 : kThreads / width;
}
__device__ __forceinline__ int ring_segments(int width) {
  return width / 8 >= kThreads ? 1 : kThreads / (width / 8);
}

// Eight bf16 as floats: a bf16 is the high half of the float it widens
// to, so the conversion is a shift or a mask.
__device__ __forceinline__ void widen8(const uint4 raw, float* m) {
  const uint32_t x[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    m[2 * k] = __uint_as_float(x[k] << 16);
    m[2 * k + 1] = __uint_as_float(x[k] & 0xFFFF0000u);
  }
}

// ---- the first pass's marks ----
//
// The valid mask v holds 0 or 1 as floats, whose low 16 bits are zero, and
// no matvec reads it. The first matvec marks row i live in the lowest byte
// of v[i] (any thread that reads a nonzero of the row stores the same
// byte); once the pass is over the marks are read and v is loaded again.
__device__ __forceinline__ void mark(float* v, int i) {
  reinterpret_cast<unsigned char*>(v + i)[0] = 1;
}

__device__ __forceinline__ bool marked(const float* v, int i) {
  return (__float_as_uint(v[i]) & 0xFFu) != 0;
}

// Adds each thread's sums of its V columns jj0.. into w in segment order:
// segment q's threads store (q = 0) or add their sums, then the block
// waits, for q = 0 .. S-1.
template <int R, int V>
__device__ void add_segments(const float (&acc)[R][V], float* __restrict__ w,
                             int s, int S, bool mine, int jj0, int Wp) {
  for (int q = 0; q < S; ++q) {
    if (mine && s == q)
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int jj = jj0 + v;
          w[r * Wp + jj] = q == 0 ? acc[r][v] : w[r * Wp + jj] + acc[r][v];
        }
    __syncthreads();
  }
}

// The register-load matvec, for rows of M that are not 16-byte aligned
// or slices too wide for the ring: w[r*Wp + jj] = sum_i ub[r*N + i] *
// M[i*N + c0 + jj] for the block's columns jj < width, one column a
// thread. With fewer columns than threads the block splits the rows into
// S = kThreads / width segments (rows i = s mod S), each summed in row
// order, and adds the segments into w in segment order. MARK: the first
// pass, which also marks the rows it finds a nonzero in.
template <int R, bool MARK>
__device__ void matvec(const __nv_bfloat16* __restrict__ M,
                       const float* __restrict__ ub, float* __restrict__ marks,
                       float* __restrict__ w, int N, int c0, int width, int Wp) {
  const int S = column_segments(width);
  const int s = S == 1 ? 0 : threadIdx.x / width;
  const int j0 = S == 1 ? threadIdx.x : threadIdx.x % width;
  float acc[R][1];
  for (int jj = j0; jj < width && s < S; jj += (S == 1 ? kThreads : width)) {
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r][0] = 0.f;
    const __nv_bfloat16* col = M + c0 + jj;
    int i = s;
    for (; i + (kUnroll - 1) * S < N; i += kUnroll * S) {
      __nv_bfloat16 mb[kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) mb[q] = col[(size_t)(i + q * S) * N];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        if (MARK && (__bfloat16_as_ushort(mb[q]) & 0x7FFF)) mark(marks, i + q * S);
        const float mv = __bfloat162float(mb[q]);
#pragma unroll
        for (int r = 0; r < R; ++r)
          acc[r][0] = __fmaf_rn(ub[r * N + i + q * S], mv, acc[r][0]);
      }
    }
    for (; i < N; i += S) {
      const __nv_bfloat16 mb = col[(size_t)i * N];
      if (MARK && (__bfloat16_as_ushort(mb) & 0x7FFF)) mark(marks, i);
      const float mv = __bfloat162float(mb);
#pragma unroll
      for (int r = 0; r < R; ++r)
        acc[r][0] = __fmaf_rn(ub[r * N + i], mv, acc[r][0]);
    }
    if (S == 1)
#pragma unroll
      for (int r = 0; r < R; ++r) w[r * Wp + jj] = acc[r][0];
  }
  if (S > 1)
    add_segments<R, 1>(acc, w, s, S, s < S, j0, Wp);
  else
    __syncthreads();
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

// dst[row] <- src[row] / max(||src[row]||, eps) over all N entries. Every
// block of the cluster runs it on the same data with the same reduction
// tree, so all blocks get the same result without an exchange.
__device__ void normalize_full(const float* __restrict__ src, float* __restrict__ dst,
                               int rows, int N, float* red) {
  for (int r = 0; r < rows; ++r) {
    float s = 0.f;
    for (int j = threadIdx.x; j < N; j += blockDim.x) s += src[r * N + j] * src[r * N + j];
    const float den = fmaxf(sqrtf(roman::block_sum(s, red)), roman::kEps);
    for (int j = threadIdx.x; j < N; j += blockDim.x) dst[r * N + j] = src[r * N + j] / den;
  }
  __syncthreads();
}

// Sums K per-thread values v[k] over the cluster: over the block (warp
// shuffles, then the warps in order), then each rank's partial is written
// into slot [par][rank] of every rank, and after the cluster barrier every
// rank adds the C partials in rank order into sc.tot[k]. The two parities
// let a rank write the next exchange while another still reads this one.
template <int K>
__device__ void cluster_sums(cg::cluster_group& cluster, const float (&v)[K],
                             Scratch& sc, int par) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float t = roman::warp_sum(v[k]);
    if (lane == 0) sc.red[k][wid] = t;
  }
  __syncthreads();
  const int C = cluster.num_blocks(), rank = cluster.block_rank();
  if (threadIdx.x < K) {
    float t = 0.f;
    for (int q = 0; q < kWarps; ++q) t += sc.red[threadIdx.x][q];
    for (int q = 0; q < C; ++q)
      *cluster.map_shared_rank(&sc.xch[par][rank][threadIdx.x], q) = t;
  }
  cluster.sync();
  if (threadIdx.x < K) {
    float t = 0.f;
    for (int q = 0; q < C; ++q) t += sc.xch[par][q][threadIdx.x];
    sc.tot[threadIdx.x] = t;
  }
  __syncthreads();
}

// u[r][c0 + jj] <- w[r][jj] / max(sqrt(sq[r]), eps) in every block of the
// cluster; with keep_if_zero, rows whose norm is <= eps keep their old u
// (the homotopy's projection rule). Ends with the cluster barrier, after
// which every block holds the full new u.
template <int R>
__device__ void scatter_u(cg::cluster_group& cluster, const float* __restrict__ w,
                          float* u, const float* sq, int N, int c0, int width,
                          int Wp, bool keep_if_zero) {
  const int C = cluster.num_blocks();
  for (int q = 0; q < C; ++q) {
    float* uq = cluster.map_shared_rank(u, q);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float nrm = sqrtf(sq[r]);
      if (keep_if_zero && !(nrm > roman::kEps)) continue;
      const float den = fmaxf(nrm, roman::kEps);
      for (int jj = threadIdx.x; jj < width; jj += kThreads)
        uq[r * N + c0 + jj] = w[r * Wp + jj] / den;
    }
  }
  cluster.sync();
}

// ---- the bulk-copy ring: M's slice streamed through shared memory ----
//
// The ring holds NS stages of T rows of the block's slice. A stage is nb
// boxes of T rows x bc columns (bc <= 256, the largest box a tensor copy
// takes), each filled by one cp.async.bulk.tensor from a tensor map of M
// and reported to the stage's `full` mbarrier; boxes past M's last row or
// column are filled with zeros and never read. Thread 0 fills; every warp
// reports a consumed stage to its `empty` mbarrier, and thread 0 waits for
// that before it refills the stage. Tiles are numbered over the whole
// solve (tiles per matvec x matvecs). The ring first runs for the first
// pass alone; a block that goes on streaming restarts it for the other
// matvecs, and from then on it runs on into the next matvec's first rows
// while the block exchanges and steps: M does not change during the solve.
constexpr int kMaxStages = 4;
constexpr int kMaxBox = 256;

struct Ring {
  __nv_bfloat16* buf;      // NS stages of nb x T x bc bf16
  uint64_t* full;          // NS mbarriers: the stage's bytes have landed
  uint64_t* empty;         // NS mbarriers: every warp has read the stage
  const CUtensorMap* map;  // M as (P, N, N), boxes of 1 x T x bc
  int T, NS;               // rows a stage, stages
  int bc, nb;              // columns a box, boxes a stage
  int tiles;               // tiles a matvec: ceil(N / T)
  int matvecs;             // matvecs of the solve
  int total;               // tiles the ring runs to
  int next;                // the next tile to consume
  int p;                   // the pair
};

// Columns a box for a slice Wp wide: as few boxes as the 256 limit allows,
// a multiple of 8 columns (16 bytes) each.
__host__ __device__ inline int box_width(int Wp) {
  const int nb = (Wp + kMaxBox - 1) / kMaxBox;
  return ((Wp + nb - 1) / nb + 7) / 8 * 8;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// Fill tile k's stage: rows (k mod tiles) * T onward of the slice at c0.
__device__ void ring_fill(const Ring& rg, int k, int c0) {
  const int s = k % rg.NS;
  const int row0 = (k % rg.tiles) * rg.T;
  const uint32_t box_bytes = (uint32_t)rg.T * rg.bc * 2;
  const uint32_t bar = smem_addr(&rg.full[s]);
  const uint32_t dst = smem_addr(rg.buf + (size_t)s * rg.nb * rg.T * rg.bc);
  // a box counts all its bytes, the zeros past the matrix's edge too
  mbar_expect_tx(&rg.full[s], box_bytes * rg.nb);
  for (int b = 0; b < rg.nb; ++b)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst + b * box_bytes),
        "l"(reinterpret_cast<uint64_t>(rg.map)), "r"(c0 + b * rg.bc), "r"(row0),
        "r"(rg.p), "r"(bar)
        : "memory");
}

// Thread 0 runs the ring on from tile rg.next to the end of the solve:
// refills the next NS stages, each once every warp has read its last tile.
__device__ void ring_restart(Ring& rg, int c0) {
  rg.total = rg.tiles * rg.matvecs;
  if (threadIdx.x != 0) return;
  for (int k = rg.next; k < min(rg.next + rg.NS, rg.total); ++k) {
    if (k >= rg.NS) mbar_wait(&rg.empty[k % rg.NS], (k / rg.NS - 1) & 1);
    ring_fill(rg, k, c0);
  }
}

// The matvec on rows read from the ring. A thread owns 8 neighbouring
// columns (one 16-byte shared load a row) and one of S = kThreads / G row
// segments of the G groups of 8 columns (rows i = s mod S), each summed in
// row order; the segments are added into w in segment order. MARK: the
// first pass, which also marks the rows it finds a nonzero in.
template <int R, bool MARK>
__device__ void matvec_ring(Ring& rg, const float* __restrict__ ub,
                            float* __restrict__ marks, float* __restrict__ w,
                            int N, int c0, int width, int Wp) {
  const int G = width / 8;  // <= kThreads, checked by the launcher
  const int S = ring_segments(width);
  const int s = threadIdx.x / G, g = threadIdx.x % G;
  const bool mine = s < S;
  // this thread's 8 columns in a stage: box jj / bc, column jj % bc
  const int jj0 = g * 8;
  const size_t col_off = (size_t)(jj0 / rg.bc) * rg.T * rg.bc + jj0 % rg.bc;
  float acc[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[r][v] = 0.f;
  for (int t = 0; t < rg.tiles; ++t, ++rg.next) {
    const int k = rg.next, st = k % rg.NS;
    const uint32_t parity = (k / rg.NS) & 1;
    const int row0 = t * rg.T, rows = min(rg.T, N - row0);
    mbar_wait(&rg.full[st], parity);
    if (mine) {
      const __nv_bfloat16* tile = rg.buf + (size_t)st * rg.nb * rg.T * rg.bc + col_off;
      // this segment's rows of the tile: i = s mod S, in row order
      for (int i = row0 + (s - row0 % S + S) % S; i < row0 + rows; i += S) {
        const uint4 raw = *reinterpret_cast<const uint4*>(tile + (i - row0) * rg.bc);
        if (MARK && ((raw.x | raw.y | raw.z | raw.w) & 0x7FFF7FFFu)) mark(marks, i);
        float mv[8];
        widen8(raw, mv);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float x = ub[r * N + i];
#pragma unroll
          for (int v = 0; v < 8; ++v) acc[r][v] = __fmaf_rn(x, mv[v], acc[r][v]);
        }
      }
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&rg.empty[st]);
    if (threadIdx.x == 0 && k + rg.NS < rg.total) {
      mbar_wait(&rg.empty[st], parity);
      ring_fill(rg, k + rg.NS, c0);
    }
  }
  add_segments<R, 8>(acc, w, s, S, mine, jj0, Wp);
}

// ---- resident rows: the slice's live rows of M in shared memory ----
//
// The area after the vectors (the ring's stages, or what the register-load
// path has left) holds, once the first pass is over, up to cap live rows:
// a key per row (row | segment << 16, in row order; N < 2^16, as the
// vectors in shared memory cap it) and the row's slice, Wp bf16.
enum { kMark, kStream, kResident };

struct Rows {
  int* key;             // cap keys
  __nv_bfloat16* val;   // cap rows of the slice
  int cap;              // rows the area holds
  int count;            // live rows of the slice
  int state;            // kMark (before the first pass), kStream, kResident
  int* stats;           // per pair (live rows, every block resident), or null
};

// The ring's matvec on the resident rows: thread (s, g) sums, in row order,
// the rows of its segment that the first pass found live in the slice.
template <int R>
__device__ void matvec_rows8(const Rows& rw, const float* ub, float* __restrict__ w,
                             int N, int width, int Wp) {
  const int G = width / 8;
  const int S = ring_segments(width);
  const int s = threadIdx.x / G, g = threadIdx.x % G;
  const bool mine = s < S;
  float acc[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[r][v] = 0.f;
  if (mine)
    for (int k = 0; k < rw.count; ++k) {
      const int key = rw.key[k];
      if ((key >> 16) != s) continue;
      const int i = key & 0xFFFF;
      float mv[8];
      widen8(*reinterpret_cast<const uint4*>(rw.val + (size_t)k * Wp + g * 8), mv);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float x = ub[r * N + i];
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[r][v] = __fmaf_rn(x, mv[v], acc[r][v]);
      }
    }
  add_segments<R, 8>(acc, w, s, S, mine, g * 8, Wp);
}

// The register-load matvec on the resident rows, column by column.
template <int R>
__device__ void matvec_rows1(const Rows& rw, const float* ub, float* __restrict__ w,
                             int N, int width, int Wp) {
  const int S = column_segments(width);
  const int s = S == 1 ? 0 : threadIdx.x / width;
  const int j0 = S == 1 ? threadIdx.x : threadIdx.x % width;
  float acc[R][1];
  for (int jj = j0; jj < width && s < S; jj += (S == 1 ? kThreads : width)) {
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r][0] = 0.f;
    for (int k = 0; k < rw.count; ++k) {
      const int key = rw.key[k];
      if ((key >> 16) != s) continue;
      const int i = key & 0xFFFF;
      const float mv = __bfloat162float(rw.val[(size_t)k * Wp + jj]);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r][0] = __fmaf_rn(ub[r * N + i], mv, acc[r][0]);
    }
    if (S == 1)
#pragma unroll
      for (int r = 0; r < R; ++r) w[r * Wp + jj] = acc[r][0];
  }
  if (S > 1)
    add_segments<R, 1>(acc, w, s, S, s < S, j0, Wp);
  else
    __syncthreads();
}

// After the first pass: count the slice's marked rows; if they fit the
// area, list them in row order with their segments and copy their slice of
// M there, else stream (restarting the ring) for the rest of the solve.
// With stats, rank 0 then writes the pair's live rows (marked in any
// block) and whether every block keeps its rows.
template <bool BULK>
__device__ void settle(cg::cluster_group& cluster, Ring& rg, Rows& rw, Scratch& sc,
                       float* v, const float* valid, const __nv_bfloat16* M,
                       int N, int c0, int width, int Wp) {
  // each warp counts a run of rows, a multiple of 32, 32 rows a ballot
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int run = ((N + kWarps - 1) / kWarps + 31) / 32 * 32;
  const int lo = wid * run, hi = min(N, lo + run);
  int n = 0;
  for (int i0 = lo; i0 < hi; i0 += 32)
    n += __popc(__ballot_sync(~0u, i0 + lane < hi && marked(v, i0 + lane)));
  if (lane == 0) sc.live[wid] = n;
  __syncthreads();
  int before = 0;
  rw.count = 0;
  for (int q = 0; q < kWarps; ++q) {
    before += q < wid ? sc.live[q] : 0;
    rw.count += sc.live[q];
  }
  const bool keep = rw.count <= rw.cap;
  if (keep && rw.count > 0) {
    const int S = BULK ? ring_segments(width) : column_segments(width);
    for (int i0 = lo; i0 < hi; i0 += 32) {
      const int i = i0 + lane;
      const bool on = i < hi && marked(v, i);
      const unsigned b = __ballot_sync(~0u, on);
      if (on) rw.key[before + __popc(b & ((1u << lane) - 1))] = i | (i % S) << 16;
      before += __popc(b);
    }
    __syncthreads();
    for (int k = 0; k < rw.count; ++k) {
      const __nv_bfloat16* src = M + (size_t)(rw.key[k] & 0xFFFF) * N + c0;
      for (int jj = threadIdx.x; jj < width; jj += kThreads)
        rw.val[(size_t)k * Wp + jj] = src[jj];
    }
  }
  rw.state = keep ? kResident : kStream;
  if constexpr (BULK) {
    if (!keep) ring_restart(rg, c0);
  }
  if (rw.stats) {
    const int C = cluster.num_blocks();
    if (threadIdx.x == 0) sc.resident = keep;
    cluster.sync();  // every block's marks and choice are in place
    if (cluster.block_rank() == 0) {
      float live = 0.f;
      for (int i = threadIdx.x; i < N; i += kThreads) {
        bool any = false;
        for (int q = 0; q < C; ++q) any = any || marked(cluster.map_shared_rank(v, q), i);
        live += any ? 1.f : 0.f;
      }
      live = roman::block_sum(live, &sc.red[0][0]);  // exact: counts below 2^24
      if (threadIdx.x == 0) {
        int all = 1;
        for (int q = 0; q < C; ++q) all &= *cluster.map_shared_rank(&sc.resident, q);
        const int p = blockIdx.x / C;
        rw.stats[2 * p] = (int)live;
        rw.stats[2 * p + 1] = all;
      }
    }
    cluster.sync();  // no block clears its marks before rank 0 has read them
  }
  for (int j = threadIdx.x; j < N; j += kThreads) v[j] = valid[j];
  __syncthreads();
}

template <int R, bool BULK>
__device__ __forceinline__ void matvec_any(cg::cluster_group& cluster, Ring& rg,
                                           Rows& rw, Scratch& sc,
                                           const __nv_bfloat16* M, const float* ub,
                                           float* v, const float* valid, float* w,
                                           int N, int c0, int width, int Wp) {
  const bool first = rw.state == kMark;
  if (width == 0) {
    __syncthreads();
  } else if (rw.state == kResident) {
    if constexpr (BULK)
      matvec_rows8<R>(rw, ub, w, N, width, Wp);
    else
      matvec_rows1<R>(rw, ub, w, N, width, Wp);
  } else if (first) {
    if constexpr (BULK)
      matvec_ring<R, true>(rg, ub, v, w, N, c0, width, Wp);
    else
      matvec<R, true>(M, ub, v, w, N, c0, width, Wp);
  } else {
    if constexpr (BULK)
      matvec_ring<R, false>(rg, ub, nullptr, w, N, c0, width, Wp);
    else
      matvec<R, false>(M, ub, nullptr, w, N, c0, width, Wp);
  }
  if (first) settle<BULK>(cluster, rg, rw, sc, v, valid, M, N, c0, width, Wp);
}

template <int R, bool BULK>
__global__ void __launch_bounds__(kThreads, 1)
clipper_solve_kernel(const __nv_bfloat16* __restrict__ M_all,
                     const float* __restrict__ valid,
                     const float* __restrict__ noise,
                     float* __restrict__ u_out, float* __restrict__ d_out,
                     float* __restrict__ F_out, float* __restrict__ om_out,
                     int* __restrict__ stats, int N, int n, int m, int warmup,
                     int outer, int inner, float active_eps, int T, int NS,
                     int area_bytes, const __grid_constant__ CUtensorMap map) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = cluster.num_blocks(), rank = cluster.block_rank();
  const int p = blockIdx.x / C;
  const int Wp = slice_width(N, C);
  const int c0 = min(N, rank * Wp);
  const int width = min(N, c0 + Wp) - c0;

  extern __shared__ __align__(16) float smem[];
  float* u = smem;            // R*N  current iterate, one row per restart
  float* ub = u + R * N;      // R*N  bf16-rounded u (matvec operand), scratch
  float* v = ub + R * N;      // N    valid mask
  float* w = v + N;           // R*Wp matvec result on the slice
  float* rs = w + R * Wp;     // R*n  row sums of u
  float* cs = rs + R * n;     // R*m  column sums of u
  __shared__ Scratch sc;
  __shared__ uint64_t bars[2 * kMaxStages];
  float* red = &sc.red[0][0];  // 33 floats for roman::block_sum / block_max
  int par = 0;                 // parity of the next exchange

  // the area starts at the first 128-byte aligned shared address after cs
  // (a box's alignment; dynamic shared memory follows the static)
  char* after = reinterpret_cast<char*>(cs + R * m);
  char* area = after + (128 - smem_addr(after) % 128) % 128;
  Rows rw{};
  rw.cap = area_bytes > 16 ? (area_bytes - 16) / (4 + 2 * Wp) : 0;
  rw.key = reinterpret_cast<int*>(area);
  rw.val = reinterpret_cast<__nv_bfloat16*>(area + ((size_t)rw.cap * 4 + 15) / 16 * 16);
  rw.state = kMark;
  rw.stats = stats;

  const __nv_bfloat16* M = M_all + (size_t)p * N * N;
  const float* valid_p = valid + (size_t)p * N;
  Ring rg{};
  if constexpr (BULK) {
    rg.buf = reinterpret_cast<__nv_bfloat16*>(area);
    rg.full = bars;
    rg.empty = bars + kMaxStages;
    rg.T = T;
    rg.NS = NS;
    rg.map = &map;
    rg.bc = box_width(Wp);
    rg.nb = (Wp + rg.bc - 1) / rg.bc;
    rg.p = p;
    rg.tiles = (N + T - 1) / T;
    rg.matvecs = warmup + outer * (inner + 1) + 1;
    rg.total = rg.tiles;  // the first pass; settle decides on the rest
    if (width > 0 && threadIdx.x == 0) {
      for (int k = 0; k < NS; ++k) {
        mbar_init(&rg.full[k], 1);
        mbar_init(&rg.empty[k], kWarps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (width > 0 && threadIdx.x == 0)
      for (int k = 0; k < min(NS, rg.total); ++k) ring_fill(rg, k, c0);
  }
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    v[j] = valid_p[j];
    ub[j] = v[j] + 1e-3f;
  }
  __syncthreads();
  normalize_full(ub, u, 1, N, red);

  // ---- warmup: u <- normalize((Mu + u) * valid), restart row 0 only ----
  for (int it = 0; it < warmup; ++it) {
    round_bf16(u, ub, N);
    __syncthreads();
    matvec_any<1, BULK>(cluster, rg, rw, sc, M, ub, v, valid_p, w, N, c0, width, Wp);
    float sq[1] = {0.f};
    for (int jj = threadIdx.x; jj < width; jj += kThreads) {
      const int j = c0 + jj;
      const float x = (w[jj] + u[j]) * v[j];
      w[jj] = x;
      sq[0] += x * x;
    }
    cluster_sums<1>(cluster, sq, sc, par);
    par ^= 1;
    scatter_u<1>(cluster, w, u, sc.tot, N, c0, width, Wp, false);
  }

  // ---- restart expansion: row r blends toward restart_noise row r; every
  // block computes all N entries, so no exchange is needed ----
  if (R > 1) {
    float mx = -INFINITY;
    for (int j = threadIdx.x; j < N; j += blockDim.x) mx = fmaxf(mx, u[j]);
    const float umax = roman::block_max(mx, red);
    for (int r = 1; r < R; ++r) {
      const float a = (float)r / (float)R;
      for (int j = threadIdx.x; j < N; j += blockDim.x)
        ub[r * N + j] = (u[j] * (1.f - a) + umax * a * noise[r * N + j]) * v[j];
    }
    __syncthreads();
    normalize_full(ub + N, u + N, R - 1, N, red);
  }
  if (threadIdx.x < R) sc.d[threadIdx.x] = 0.f;
  __syncthreads();

  // ---- penalty homotopy ----
  for (int o = 0; o <= outer; ++o) {
    // o < outer: inner projected steps, then the d-update; o == outer: the
    // final matvec for F, omega and the restart choice
    const int steps = o < outer ? inner : 0;
    for (int it = 0; it <= steps; ++it) {
      round_bf16(u, ub, R * N);
      __syncthreads();
      matvec_any<R, BULK>(cluster, rg, rw, sc, M, ub, v, valid_p, w, N, c0, width, Wp);
      row_col_sums(u, rs, cs, R, n, m);
      __syncthreads();
      if (it < steps) {
        float sq[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          sq[r] = 0.f;
          for (int jj = threadIdx.x; jj < width; jj += kThreads) {
            const int j = c0 + jj, k = r * N + j;
            const float cbu = (rs[r * n + j / m] + cs[r * m + j % m]) - 2.f * u[k];
            const float x = fmaxf(w[r * Wp + jj] - sc.d[r] * cbu, 0.f) * v[j];
            w[r * Wp + jj] = x;
            sq[r] += x * x;
          }
        }
        cluster_sums<R>(cluster, sq, sc, par);
        par ^= 1;
        scatter_u<R>(cluster, w, u, sc.tot, N, c0, width, Wp, true);
        continue;
      }
      // the d-update (o < outer) or F, omega and violations (o == outer)
      float acc[3 * R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float a0 = 0.f, a1 = 0.f, nv = 0.f;
        for (int jj = threadIdx.x; jj < width; jj += kThreads) {
          const int j = c0 + jj, k = r * N + j;
          const float cbu = (rs[r * n + j / m] + cs[r * m + j % m]) - 2.f * u[k];
          const float mu = w[r * Wp + jj];
          const bool viol = u[k] > active_eps && cbu > active_eps;
          if (o < outer) {
            if (viol) {
              a0 += mu;
              a1 += cbu;
              nv += 1.f;
            }
          } else {
            a0 += u[k] * (mu - sc.d[r] * cbu);
            a1 += u[k] * mu;
            if (viol) nv += 1.f;
          }
        }
        acc[r] = a0;
        acc[R + r] = a1;
        acc[2 * R + r] = nv;
      }
      cluster_sums<3 * R>(cluster, acc, sc, par);
      par ^= 1;
      if (o < outer) {
        if (threadIdx.x == 0)
          for (int r = 0; r < R; ++r) {
            const float num = sc.tot[r], den = sc.tot[R + r];
            const float delta = den > roman::kEps ? num / fmaxf(den, roman::kEps) : 0.f;
            sc.d[r] = sc.d[r] + delta + (sc.tot[2 * R + r] > 0.f ? 1e-3f : 0.f);
          }
        __syncthreads();
      }
    }
  }

  // ---- the restart choice: the same in every block ----
  int best = 0;
  float best_score = sc.tot[R] - (sc.tot[2 * R] > 0.f ? roman::kBigScore : 0.f);
  for (int r = 1; r < R; ++r) {
    const float score = sc.tot[R + r] - (sc.tot[2 * R + r] > 0.f ? roman::kBigScore : 0.f);
    if (score > best_score) {  // first maximum: restart 0 wins ties
      best = r;
      best_score = score;
    }
  }
  for (int jj = threadIdx.x; jj < width; jj += kThreads)
    u_out[(size_t)p * N + c0 + jj] = u[best * N + c0 + jj];
  if (rank == 0 && threadIdx.x == 0) {
    d_out[p] = sc.d[best];
    F_out[p] = sc.tot[best];
    om_out[p] = sc.tot[R + best];
  }
}

template <int R, bool BULK>
cudaError_t launch_bulk(const void* M, const void* valid, const void* noise,
                       void* u, void* d, void* F, void* omega, void* stats, int P,
                       int N, int n, int m, int warmup, int outer, int inner,
                       float active_eps, int C, int T, int NS, int area,
                       size_t smem, const CUtensorMap& map, cudaStream_t stream) {
  auto kernel = clipper_solve_kernel<R, BULK>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // refuse clusters that cannot be resident at this shared memory
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (e != cudaSuccess) return e;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  return cudaLaunchKernelEx(&cfg, kernel, (const __nv_bfloat16*)M,
                            (const float*)valid, (const float*)noise, (float*)u,
                            (float*)d, (float*)F, (float*)omega, (int*)stats, N,
                            n, m, warmup, outer, inner, active_eps, T, NS, area,
                            map);
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query so the library needs no link to libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// M (P, N, N) bf16 as a tensor map with boxes of 1 x T rows x bc columns.
cudaError_t encode_map(CUtensorMap* map, const void* M, int P, int N, int bc,
                       int T) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                            cudaEnableDefault, &q);
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || !fn) return cudaErrorNotSupported;
    encode = (EncodeTiled)fn;
  }
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)N, (cuuint64_t)P};
  const cuuint64_t strides[2] = {(cuuint64_t)N * 2, (cuuint64_t)N * N * 2};
  const cuuint32_t box[3] = {(cuuint32_t)bc, (cuuint32_t)T, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(M), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Dynamic shared memory of a block's vectors (u and its bf16 copy, the
// valid mask, the slice's matvec result, row and column sums): all that
// the register-load path needs, and what the area is placed after.
template <int R>
size_t vector_bytes(int N, int n, int m, int C) {
  return sizeof(float) * ((size_t)2 * R * N + N + (size_t)R * slice_width(N, C) +
                          (size_t)R * (n + m));
}

// The bulk-copy ring where every row of M starts 16-byte aligned and two
// stages fit beside the vectors; register loads, one column a thread,
// otherwise, with whatever shared memory the card has left as the area.
template <int R>
cudaError_t launch(const void* M, const void* valid, const void* noise, void* u,
                   void* d, void* F, void* omega, void* stats, int P, int N,
                   int n, int m, int warmup, int outer, int inner,
                   float active_eps, int C, cudaStream_t stream) {
  const int Wp = slice_width(N, C);
  const size_t base = vector_bytes<R>(N, n, m, C);
  const size_t area0 = base + 128;  // room to align the area to 128 bytes
  const bool aligned = N % 8 == 0 && reinterpret_cast<uintptr_t>(M) % 16 == 0;
  const CUtensorMap none{};
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes fa;
  if (aligned && Wp / 8 <= kThreads) {
    e = cudaFuncGetAttributes(&fa, clipper_solve_kernel<R, true>);
    if (e != cudaSuccess) return e;
    const long left = (long)optin - (long)fa.sharedSizeBytes - (long)area0;
    const int bc = box_width(Wp), nb = (Wp + bc - 1) / bc;
    // the largest stages (up to 128 rows) of which two fit, as many of
    // them as fit up to kMaxStages: few large boxes move M fastest
    int T = 128, NS = 0;
    for (; T >= 8; T /= 2) {
      NS = (int)std::min<long>(kMaxStages, std::max<long>(0, left) / ((long)nb * T * bc * 2));
      if (NS >= 2) break;
    }
    if (NS >= 2) {
      CUtensorMap map;
      e = encode_map(&map, M, P, N, bc, T);
      if (e != cudaSuccess) return e;
      const int ring = NS * nb * T * bc * 2;
      return launch_bulk<R, true>(M, valid, noise, u, d, F, omega, stats, P, N, n,
                                  m, warmup, outer, inner, active_eps, C, T, NS,
                                  ring, area0 + ring, map, stream);
    }
  }
  e = cudaFuncGetAttributes(&fa, clipper_solve_kernel<R, false>);
  if (e != cudaSuccess) return e;
  const long left = (long)optin - (long)fa.sharedSizeBytes - (long)area0;
  const int area = left > 0 ? (int)left : 0;
  return launch_bulk<R, false>(M, valid, noise, u, d, F, omega, stats, P, N, n, m,
                               warmup, outer, inner, active_eps, C, 0, 0, area,
                               area > 0 ? area0 + area : base, none, stream);
}

// What a launch of the register-load path needs: the shared memory of a
// block (static and dynamic), what the card lets a block have, and how
// many clusters of C such blocks can be resident. Every shape that the
// bulk-copy ring does not take falls back to this path, so it decides
// which shapes the kernel takes at all.
template <int R>
cudaError_t fits(int N, int n, int m, int C, long long* need, long long* avail,
                 int* clusters) {
  auto kernel = clipper_solve_kernel<R, false>;
  const size_t base = vector_bytes<R>(N, n, m, C);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return e;
  *need = (long long)(base + fa.sharedSizeBytes);
  *avail = optin;
  *clusters = 0;
  if (*need > *avail) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)base);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = base;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

}  // namespace

// The kernel takes a shape when need <= avail and clusters >= 1 (see
// fits); the wrapper refuses the others before any launch.
extern "C" int clipper_solve_fits(int N, int n, int m, int R, int C,
                                  long long* need, long long* avail,
                                  int* clusters) {
  if (C < 1 || C > kMaxCluster) return (int)cudaErrorInvalidValue;
  switch (R) {
#define ROMAN_CASE(K) \
  case K:             \
    return (int)fits<K>(N, n, m, C, need, avail, clusters);
    ROMAN_CASE(1) ROMAN_CASE(2) ROMAN_CASE(3) ROMAN_CASE(4)
    ROMAN_CASE(5) ROMAN_CASE(6) ROMAN_CASE(7) ROMAN_CASE(8)
#undef ROMAN_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// C: blocks per pair (the cluster size), 1..8. stats: null, or (P, 2) int32
// that the launch fills with each pair's live rows of M (rows holding a
// nonzero) and 1 where every block of the pair kept its rows on chip.
extern "C" int clipper_solve_launch(const void* M, const void* valid,
                                    const void* noise, void* u, void* d,
                                    void* F, void* omega, void* stats, int P,
                                    int N, int n, int m, int R, int warmup,
                                    int outer, int inner, int C,
                                    float active_eps, void* stream) {
  if (C < 1 || C > kMaxCluster) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (R) {
#define ROMAN_CASE(K)                                                           \
  case K:                                                                       \
    return (int)launch<K>(M, valid, noise, u, d, F, omega, stats, P, N, n, m,   \
                          warmup, outer, inner, active_eps, C, s);
    ROMAN_CASE(1) ROMAN_CASE(2) ROMAN_CASE(3) ROMAN_CASE(4)
    ROMAN_CASE(5) ROMAN_CASE(6) ROMAN_CASE(7) ROMAN_CASE(8)
#undef ROMAN_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
