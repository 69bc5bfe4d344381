// One-direction nearest-neighbour argmin by diff-form squared distance:
//     idx[b, n] = argmin over valid m of |x[b, n] - y[b, m]|^2
// with the first index winning ties and an optional (B, M) validity mask
// on y (valid where > 0): an invalid y never wins.
//
// Replaces: imgadapointr_tpu/ops/pallas/nn_distance.py:nn_one_direction_pallas
// (`_nn_kernel`) and, for masked clouds, the scan it falls back to
// (imgadapointr_tpu/ops/chamfer.py:147-182, `jnp.where(wt > 0, d, inf)`).
// The chamfer distance takes this path whenever the bidirectional kernel
// does not apply: a validity mask (the PCN test protocol drops zero-padded
// rows at batch size 1) or a cloud above 2^18 points. Callers recompute the
// distance from the index, so only the index is returned.
//
// Bound on the H100: operations. B*N*M pairs, each 9 operations (3
// subtracts, 3 multiplies, 2 adds, one compare); the clouds are a few MB.
// Design: the pass of nn_argmin.cuh, whose distance bits and tie rule are
// nn_bidir_argmin.cu's, so both kernels select the same index on the same
// clouds. Cloud sizes are ints: no cap below 2^31 points.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nn_argmin.cuh"

namespace {

using nn_argmin::kThreads;

template <bool kMasked>
__global__ void __launch_bounds__(kThreads)
    nn_one_direction_kernel(const float* __restrict__ x,
                            const float* __restrict__ y,
                            const float* __restrict__ wy,
                            int64_t* __restrict__ idx, int N, int M) {
  __shared__ float4 tile[nn_argmin::kTile];
  const int64_t b = blockIdx.y;
  nn_argmin::pass<kMasked>(x + b * N * 3, N, y + b * M * 3, M,
                           kMasked ? wy + b * M : nullptr, idx + b * N, tile);
}

}  // namespace

// x (B, N, 3), y (B, M, 3) float32, wy (B, M) float32 or null -> idx (B, N)
// int64.
extern "C" int nn_one_direction_f32(const float* x, const float* y,
                                    const float* wy, int64_t* idx, int64_t B,
                                    int64_t N, int64_t M, void* stream) {
  if (B == 0 || N == 0 || M == 0) return 0;
  if (B > 65535 || N > INT32_MAX || M > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((N + kThreads - 1) / kThreads), (unsigned)B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wy != nullptr) {
    nn_one_direction_kernel<true><<<grid, kThreads, 0, s>>>(x, y, wy, idx,
                                                            (int)N, (int)M);
  } else {
    nn_one_direction_kernel<false><<<grid, kThreads, 0, s>>>(x, y, nullptr, idx,
                                                             (int)N, (int)M);
  }
  return (int)cudaGetLastError();
}
