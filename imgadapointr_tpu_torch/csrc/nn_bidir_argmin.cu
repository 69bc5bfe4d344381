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
// are a few MB and stay in L2. Design: one thread per query row keeps its
// running (min, argmin) in registers with a strict < (so the first index
// wins); the other cloud streams through shared memory as float4 tiles, one
// broadcast load per pair. The swapped pass doubles the subtract/multiply
// work against a fused single pass; that is the price of needing no
// cross-block reduction, and a later kernel can remove it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;

__global__ void __launch_bounds__(kThreads)
    nn_bidir_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    int64_t* __restrict__ i1, int64_t* __restrict__ i2, int N,
                    int M) {
  __shared__ float4 tile[kTile];
  const bool swapped = blockIdx.z == 1;
  const int b = blockIdx.y;
  const int nq = swapped ? M : N;
  const int nr = swapped ? N : M;
  if ((int)(blockIdx.x * kThreads) >= nq) return;  // uniform over the block
  const float* q = (swapped ? y : x) + (int64_t)b * nq * 3;
  const float* r = (swapped ? x : y) + (int64_t)b * nr * 3;
  int64_t* out = (swapped ? i2 : i1) + (int64_t)b * nq;

  const int s = blockIdx.x * kThreads + threadIdx.x;
  const bool active = s < nq;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = q[3 * (int64_t)s];
    qy = q[3 * (int64_t)s + 1];
    qz = q[3 * (int64_t)s + 2];
  }
  float best = INFINITY;
  int best_i = 0;
  for (int base = 0; base < nr; base += kTile) {
    const int n = min(kTile, nr - base);
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += kThreads) {
      const float* p = r + (int64_t)(base + t) * 3;
      tile[t] = make_float4(p[0], p[1], p[2], 0.f);
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
      if (d < best) {
        best = d;
        best_i = base + j;
      }
    }
  }
  if (active) out[s] = best_i;
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
