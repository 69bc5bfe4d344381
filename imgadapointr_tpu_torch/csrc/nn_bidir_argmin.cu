// Bidirectional nearest-neighbour argmin by diff-form squared distance:
//     i1[b, n] = argmin_m |x[b, n] - y[b, m]|^2   (nearest y for every x)
//     i2[b, m] = argmin_n |y[b, m] - x[b, n]|^2   (nearest x for every y)
// with the first index winning ties in both directions.
//
// Replaces: imgadapointr_tpu/ops/pallas/nn_distance.py:nn_argmin_bidir_exact
// (`_nn_bidir_exact_kernel`). On the TPU one pass over the distance tiles
// served both directions because the sequential grid could carry the column
// minimum from one step to the next. Hopper's blocks run in no order, so the
// column direction here is a second pass with x and y swapped, in the same
// launch (blockIdx.z picks the direction). Both passes compute
// (q - r)^2 summed as (dx*dx + dy*dy) + dz*dz, so d(x_n, y_m) is the same
// bit pattern in both directions.
//
// Selection precision is gradient quality (nn_distance.py:17-24): the
// distance is never taken in matmul form, with TF32 or on tensor cores, and
// __fsub_rn/__fmul_rn/__fadd_rn keep FMA contraction from changing the
// rounding against the plain PyTorch version.
//
// Bound on the H100: operations. B*N*M pairs, each about 10 operations
// (3 subtracts, 3 multiplies, 2 adds, one compare per direction); the clouds
// are a few MB and stay in L2. Design: the pass of nn_argmin.cuh (one thread
// per query row, the other cloud through shared memory), shared with
// nn_one_direction.cu so both select the same index. The swapped pass
// doubles the subtract/multiply work against a fused single pass; that is
// the price of needing no cross-block reduction, and a later kernel can
// remove it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nn_argmin.cuh"

namespace {

using nn_argmin::kThreads;

__global__ void __launch_bounds__(kThreads)
    nn_bidir_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    int64_t* __restrict__ i1, int64_t* __restrict__ i2, int N,
                    int M) {
  __shared__ float4 tile[nn_argmin::kTile];
  const bool swapped = blockIdx.z == 1;
  const int b = blockIdx.y;
  const int nq = swapped ? M : N;
  const int nr = swapped ? N : M;
  const float* q = (swapped ? y : x) + (int64_t)b * nq * 3;
  const float* r = (swapped ? x : y) + (int64_t)b * nr * 3;
  int64_t* out = (swapped ? i2 : i1) + (int64_t)b * nq;
  nn_argmin::pass<false>(q, nq, r, nr, nullptr, out, tile);
}

}  // namespace

// x (B, N, 3), y (B, M, 3) float32 -> i1 (B, N), i2 (B, M) int64.
extern "C" int nn_bidir_argmin_f32(const float* x, const float* y, int64_t* i1,
                                   int64_t* i2, int64_t B, int64_t N,
                                   int64_t M, void* stream) {
  if (B == 0 || N == 0 || M == 0) return 0;
  const int64_t rows = N > M ? N : M;
  const dim3 grid((unsigned)((rows + kThreads - 1) / kThreads), (unsigned)B, 2);
  nn_bidir_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, i1, i2, (int)N, (int)M);
  return (int)cudaGetLastError();
}
