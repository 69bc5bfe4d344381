// Bidirectional nearest-neighbour argmin by the matmul-form distance of the
// opt-in eval chamfer (EVAL METRICS ONLY):
//     d~(n, m) = (|x_n|^2 - 2 * cross(x_n, y_m)) + |y_m|^2
//     cross    = (sum_c xh*yh + sum_c xh*yl) + sum_c xl*yh
// where xh = bf16_rn(x), xl = bf16_rn(x - xh) per coordinate (the same for
// y), each sum over the 3 coordinates is ((c0 + c1) + c2) in float32 and
// |x|^2 = (x0*x0 + x1*x1) + x2*x2; i1[b, n] is the first m with the least
// d~(n, m), i2[b, m] the first n with the least d~(n, m).
//
// Replaces: imgadapointr_tpu/ops/pallas/nn_distance.py:nn_argmin_bidir_mxu
// (`_nn_bidir_mxu_kernel`, pallas_call at :318). The TPU kernel takes the
// cross term as three bf16 matrix products on the MXU with float32
// accumulation and carries the column minimum across its sequential grid;
// its 1e9 padding rows are a Mosaic tiling device, replaced here by bounds.
// The caller (ops/chamfer.py: nn_distance_eval) recomputes the distances
// exactly from the indices, so only the selection carries the form's
// cancellation band (about 2e-5 relative). Never for a training loss.
//
// Bound on the H100: operations (about 20 float32 operations per pair on
// CUDA cores: 9 products, 8 adds, a multiply, 2 adds and a compare per
// direction). This first kernel keeps off the tensor cores on purpose:
// their accumulation order is not specified, so the kernel could not be
// bit-for-bit the plain version. bf16 * bf16 products are exact in
// float32, so only the order of the sums matters, and it is fixed here and
// in the plain version (ops/chamfer.py: nn_argmin_bidir_mxu_plain).
// Design: as nn_bidir_argmin.cu, one thread per query row, the other cloud
// streamed through shared memory (its hi, lo and squared norm computed once
// per tile by the loading threads, 32 bytes a point), the column direction
// a second pass in the same launch (blockIdx.z). Both passes evaluate
// d~(n, m) with x in the x role, so the two directions rank the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;

struct Split {
  float h0, h1, h2, l0, l1, l2, sq;
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ Split split(float a, float b, float c) {
  Split s;
  s.h0 = bf16_round(a);
  s.h1 = bf16_round(b);
  s.h2 = bf16_round(c);
  s.l0 = bf16_round(__fsub_rn(a, s.h0));
  s.l1 = bf16_round(__fsub_rn(b, s.h1));
  s.l2 = bf16_round(__fsub_rn(c, s.h2));
  s.sq = __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)), __fmul_rn(c, c));
  return s;
}

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                   __fmul_rn(a2, b2));
}

// d~ with x in the x role and y in the y role, whatever the direction
__device__ __forceinline__ float dist(const Split& x, const Split& y) {
  const float hh = dot3(x.h0, x.h1, x.h2, y.h0, y.h1, y.h2);
  const float hl = dot3(x.h0, x.h1, x.h2, y.l0, y.l1, y.l2);
  const float lh = dot3(x.l0, x.l1, x.l2, y.h0, y.h1, y.h2);
  const float cross = __fadd_rn(__fadd_rn(hh, hl), lh);
  return __fadd_rn(__fsub_rn(x.sq, __fmul_rn(2.f, cross)), y.sq);
}

template <bool kSwapped>
__device__ __forceinline__ void pass(const float* __restrict__ q, int nq,
                                     const float* __restrict__ r, int nr,
                                     int64_t* __restrict__ out, float4* tile) {
  if ((int64_t)blockIdx.x * kThreads >= nq) return;  // uniform over the block
  const int64_t s = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool active = s < nq;
  Split me = split(0.f, 0.f, 0.f);
  if (active) me = split(q[3 * s], q[3 * s + 1], q[3 * s + 2]);
  float best = INFINITY;
  int best_i = 0;
  for (int base = 0; base < nr; base += kTile) {
    const int n = min(kTile, nr - base);
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += kThreads) {
      const float* p = r + (int64_t)(base + t) * 3;
      const Split c = split(p[0], p[1], p[2]);
      tile[2 * t] = make_float4(c.h0, c.h1, c.h2, c.sq);
      tile[2 * t + 1] = make_float4(c.l0, c.l1, c.l2, 0.f);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float4 h = tile[2 * j];
      const float4 l = tile[2 * j + 1];
      const Split c = {h.x, h.y, h.z, l.x, l.y, l.z, h.w};
      const float d = kSwapped ? dist(c, me) : dist(me, c);
      if (d < best) {
        best = d;
        best_i = base + j;
      }
    }
  }
  if (active) out[s] = best_i;
}

__global__ void __launch_bounds__(kThreads)
    nn_bidir_mxu_kernel(const float* __restrict__ x, const float* __restrict__ y,
                        int64_t* __restrict__ i1, int64_t* __restrict__ i2,
                        int N, int M) {
  __shared__ float4 tile[2 * kTile];
  const int b = blockIdx.y;
  if (blockIdx.z == 0) {
    pass<false>(x + (int64_t)b * N * 3, N, y + (int64_t)b * M * 3, M,
                i1 + (int64_t)b * N, tile);
  } else {
    pass<true>(y + (int64_t)b * M * 3, M, x + (int64_t)b * N * 3, N,
               i2 + (int64_t)b * M, tile);
  }
}

}  // namespace

// x (B, N, 3), y (B, M, 3) float32 -> i1 (B, N), i2 (B, M) int64.
extern "C" int nn_bidir_mxu_f32(const float* x, const float* y, int64_t* i1,
                                int64_t* i2, int64_t B, int64_t N, int64_t M,
                                void* stream) {
  if (B == 0 || N == 0 || M == 0) return 0;
  const int64_t rows = N > M ? N : M;
  const dim3 grid((unsigned)((rows + kThreads - 1) / kThreads), (unsigned)B, 2);
  nn_bidir_mxu_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, i1, i2, (int)N, (int)M);
  return (int)cudaGetLastError();
}
