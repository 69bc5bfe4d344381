// One nearest-neighbour argmin pass by diff-form squared distance, shared by
// nn_bidir_argmin.cu (two passes, x and y swapped) and nn_one_direction.cu
// (one pass, optional validity mask). Because both kernels run this same
// code, they select the same index on the same clouds.
//
// Selection precision is gradient quality
// (imgadapointr_tpu/ops/pallas/nn_distance.py:17-24): the distance is
// (dx*dx + dy*dy) + dz*dz in float32, never in matmul form, with TF32 or on
// tensor cores, and __fsub_rn/__fmul_rn/__fadd_rn keep FMA contraction from
// changing the rounding against the plain PyTorch version. A strict < keeps
// the first index on ties.
//
// Design: one thread per query row keeps its running (min, argmin) in
// registers; the other cloud streams through shared memory as float4 tiles,
// one broadcast load per pair. With a mask, the fourth component of the
// tile carries the candidate's validity and an invalid candidate never
// wins; a row with no valid candidate keeps index 0.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace nn_argmin {

constexpr int kThreads = 256;
constexpr int kTile = 2048;

// q (nq, 3) queries, r (nr, 3) candidates, valid (nr) or null (kMasked
// false), out (nq). Every thread of the block must call it: the tile loads
// are cooperative. `tile` is kTile float4 of shared memory.
template <bool kMasked>
__device__ __forceinline__ void pass(const float* __restrict__ q, int nq,
                                     const float* __restrict__ r, int nr,
                                     const float* __restrict__ valid,
                                     int64_t* __restrict__ out, float4* tile) {
  if ((int64_t)blockIdx.x * kThreads >= nq) return;  // uniform over the block
  const int64_t s = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool active = s < nq;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = q[3 * s];
    qy = q[3 * s + 1];
    qz = q[3 * s + 2];
  }
  float best = INFINITY;
  int best_i = 0;
  for (int base = 0; base < nr; base += kTile) {
    const int n = min(kTile, nr - base);
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += kThreads) {
      const float* p = r + (int64_t)(base + t) * 3;
      const float w = kMasked ? valid[base + t] : 1.f;
      tile[t] = make_float4(p[0], p[1], p[2], w);
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const float4 p = tile[j];
      const float dx = __fsub_rn(qx, p.x);
      const float dy = __fsub_rn(qy, p.y);
      const float dz = __fsub_rn(qz, p.z);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      if (kMasked ? (p.w > 0.f && d < best) : (d < best)) {
        best = d;
        best_i = base + j;
      }
    }
  }
  if (active) out[s] = best_i;
}

}  // namespace nn_argmin
