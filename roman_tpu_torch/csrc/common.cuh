// Block-wide reductions shared by the port's kernels.
//
// Every reduction is a fixed tree (warp shuffles, then one warp over the
// per-warp partials), so a result does not change from run to run. The
// (value, index) reductions keep the LOWEST index on a tie: the TPU
// kernels' first-maximum / first-minimum rule for the greedy pick, the
// restart choice and the refine drop.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace roman {

constexpr float kEps = 1e-9f;
constexpr float kBigScore = 1e30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// larger value wins; on equal values the lower index wins
__device__ __forceinline__ void argmax_merge(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
}

// smaller value wins; on equal values the lower index wins
__device__ __forceinline__ void argmin_merge(float& v, int& i, float ov, int oi) {
  if (ov < v || (ov == v && oi < i)) { v = ov; i = oi; }
}

// Scratch: 33 floats (and 33 ints for the arg reductions) in shared memory.
// Callers must not have threads diverge around a call: every thread of the
// block calls it.
__device__ __forceinline__ float block_sum(float v, float* s) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  if (lane == 0) s[wid] = v;
  __syncthreads();
  if (wid == 0) {
    float t = lane < nw ? s[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) s[32] = t;
  }
  __syncthreads();
  return s[32];
}

__device__ __forceinline__ float block_max(float v, float* s) {
  v = warp_max(v);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  if (lane == 0) s[wid] = v;
  __syncthreads();
  if (wid == 0) {
    float t = lane < nw ? s[lane] : -INFINITY;
    t = warp_max(t);
    if (lane == 0) s[32] = t;
  }
  __syncthreads();
  return s[32];
}

// First maximum of (v, i) over the block; returns the winning index and
// writes its value to *out_v.
__device__ __forceinline__ int block_argmax(float v, int i, float* sv, int* si,
                                            float* out_v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    argmax_merge(v, i, __shfl_xor_sync(0xffffffffu, v, o),
                 __shfl_xor_sync(0xffffffffu, i, o));
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  if (lane == 0) { sv[wid] = v; si[wid] = i; }
  __syncthreads();
  if (wid == 0) {
    float tv = lane < nw ? sv[lane] : -INFINITY;
    int ti = lane < nw ? si[lane] : 0x7fffffff;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      argmax_merge(tv, ti, __shfl_xor_sync(0xffffffffu, tv, o),
                   __shfl_xor_sync(0xffffffffu, ti, o));
    if (lane == 0) { sv[32] = tv; si[32] = ti; }
  }
  __syncthreads();
  *out_v = sv[32];
  return si[32];
}

}  // namespace roman
