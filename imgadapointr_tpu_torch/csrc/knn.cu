// k nearest neighbours by diff-form squared distance:
//     for each query q[b, s]: the k points of ref[b] with the smallest
//     (dx*dx + dy*dy) + dz*dz, ascending, ties broken by the lower index.
//
// Replaces: imgadapointr_tpu/ops/pallas/nn_distance.py:knn_pallas
// (`_knn_kernel`), which peels k minima out of a (TS, M) distance tile held
// in VMEM. Peeling re-reads the whole tile k times; here each thread keeps a
// sorted list of its k best candidates and touches every candidate once.
//
// Bound on the H100: operations. Every (query, ref) pair costs 3 subtracts,
// 3 multiplies, 2 adds and a compare; the inputs are a few hundred KB and
// stay in L2. Design: one thread per query; the reference cloud streams
// through shared memory in tiles (one 16-byte broadcast load per pair). The
// k-list lives in registers (fully unrolled compare-and-swap insertion,
// templated on the list capacity), and a candidate enters only if it beats
// the current k-th best, which after the first tiles rejects almost all of
// them. Candidates arrive in index order and the list is ordered by
// (distance, index), so ties come out in first-index order, as in the
// plain version's stable sort.
//
// Distances are computed with __fsub_rn/__fmul_rn/__fadd_rn so that no FMA
// contraction changes the rounding against the plain PyTorch version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;

__device__ __forceinline__ float sqdist(float ax, float ay, float az, float bx,
                                        float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ bool before(float d0, int i0, float d1, int i1) {
  return d0 < d1 || (d0 == d1 && i0 < i1);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    knn_kernel(const float* __restrict__ ref, const float* __restrict__ query,
               float* __restrict__ out_d, int64_t* __restrict__ out_i, int M,
               int S, int k) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  const int s = blockIdx.x * kThreads + threadIdx.x;
  const bool active = s < S;
  const float* r = ref + (int64_t)b * M * 3;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* q = query + ((int64_t)b * S + s) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
  }
  float bd[K];
  int bi[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    bd[j] = INFINITY;
    bi[j] = 0x7fffffff;
  }

  for (int base = 0; base < M; base += kTile) {
    const int n = min(kTile, M - base);
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += kThreads) {
      const float* p = r + (int64_t)(base + t) * 3;
      tile[t] = make_float4(p[0], p[1], p[2], 0.f);
    }
    __syncthreads();
    if (!active) continue;
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float4 p = tile[j];
      float cd = sqdist(qx, qy, qz, p.x, p.y, p.z);
      int ci = base + j;
      if (!before(cd, ci, bd[K - 1], bi[K - 1])) continue;
#pragma unroll
      for (int t = 0; t < K; ++t) {
        if (before(cd, ci, bd[t], bi[t])) {
          const float td = bd[t];
          const int ti = bi[t];
          bd[t] = cd;
          bi[t] = ci;
          cd = td;
          ci = ti;
        }
      }
    }
  }

  if (!active) return;
  float* od = out_d + ((int64_t)b * S + s) * k;
  int64_t* oi = out_i + ((int64_t)b * S + s) * k;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    if (t < k) {
      od[t] = bd[t];
      oi[t] = bi[t];
    }
  }
}

template <int K>
void launch(const float* ref, const float* query, float* out_d,
            int64_t* out_i, int64_t B, int64_t M, int64_t S, int64_t k,
            cudaStream_t stream) {
  const dim3 grid((unsigned)((S + kThreads - 1) / kThreads), (unsigned)B);
  knn_kernel<K><<<grid, kThreads, 0, stream>>>(ref, query, out_d, out_i,
                                               (int)M, (int)S, (int)k);
}

}  // namespace

// ref (B, M, 3), query (B, S, 3) float32; out_d (B, S, k) float32 and
// out_i (B, S, k) int64. Requires 1 <= k <= min(64, M); the caller checks.
extern "C" int knn_f32(const float* ref, const float* query, float* out_d,
                       int64_t* out_i, int64_t B, int64_t M, int64_t S,
                       int64_t k, void* stream) {
  if (B == 0 || S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 8) {
    launch<8>(ref, query, out_d, out_i, B, M, S, k, s);
  } else if (k <= 16) {
    launch<16>(ref, query, out_d, out_i, B, M, S, k, s);
  } else if (k <= 32) {
    launch<32>(ref, query, out_d, out_i, B, M, S, k, s);
  } else {
    launch<64>(ref, query, out_d, out_i, B, M, S, k, s);
  }
  return (int)cudaGetLastError();
}
