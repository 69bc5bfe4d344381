// Fused inverse-distance 3-NN interpolation:
//     for each query u[b, n]: the 3 points of known[b] with the smallest
//     (dx*dx + dy*dy) + dz*dz (ascending, ties to the lower index),
//     r_j = 1 / (sqrt(d_j) + eps), w_j = r_j / ((r_0 + r_1) + r_2), and
//     out[b, n, :] = ((w_0 f[i_0] + w_1 f[i_1]) + w_2 f[i_2])
// with unknown (B, N, 3), known (B, M, 3), feats (B, M, C) float32; idx
// (B, N, 3) int64 and w (B, N, 3) float32 are written for the backward.
//
// Replaces: imgadapointr_tpu/ops/pallas/nn_distance.py:
// three_nn_interpolate_pallas (`_three_interp_kernel`, pallas_call at
// :451). The TPU kernel holds a (TS, M) distance tile in VMEM, peels the 3
// minima with three full passes and emits the sum as one matrix product of
// the (TS, M) sparse weight rows with the whole feature table, because the
// TPU has no gather. A Hopper thread can read any row, so nothing of that
// survives: no weight matrix, no product, just three row reads per query.
//
// Bound on the H100: bytes. The (B, N, C) output is almost all of them
// (B*N*C*4: 56 MB for one decoder call at batch 8); the feature table
// (at most a few MB, read three times a query) stays in L2. The search is
// about 10 operations per (query, known) pair, a few MFLOP a call.
// Design: a block of 128 queries, one thread per query, scans the known
// cloud through shared memory as float4 tiles (one broadcast load per pair)
// and keeps its 3 best candidates in registers (compare-and-swap insertion,
// candidates in index order, so ties come out first-index-first as in the
// plain version's stable sort). The block then writes its 128 output rows
// together: consecutive threads take consecutive 16-byte chunks of a row
// (float4 loads of the three neighbour rows, one float4 store), so the
// stores are coalesced. Where C % 4 != 0 or a pointer is not 16-byte
// aligned the rows are written one float per thread.
//
// Every rounding step is an explicit _rn intrinsic (no FMA contraction, a
// correctly rounded sqrt and divide), in the plain PyTorch version's order
// (ops/pointops.py: three_nn_interpolate_plain), so idx is equal and w and
// out are bit-equal to it on the same inputs.

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

__device__ __forceinline__ float mix(float w0, float a, float w1, float b,
                                     float w2, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b)),
                   __fmul_rn(w2, c));
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
    three_nn_interp_kernel(const float* __restrict__ unknown,
                           const float* __restrict__ known,
                           const float* __restrict__ feats,
                           float* __restrict__ out, int64_t* __restrict__ out_i,
                           float* __restrict__ out_w, int N, int M, int C,
                           float eps) {
  __shared__ float4 tile[kTile];
  __shared__ int s_idx[kThreads][3];
  __shared__ float s_w[kThreads][3];
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * kThreads;
  const int n = n0 + threadIdx.x;
  const bool active = n < N;
  const float* kp = known + (int64_t)b * M * 3;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* q = unknown + ((int64_t)b * N + n) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
  }
  float bd[3] = {INFINITY, INFINITY, INFINITY};
  int bi[3] = {0x7fffffff, 0x7fffffff, 0x7fffffff};

  for (int base = 0; base < M; base += kTile) {
    const int cnt = min(kTile, M - base);
    __syncthreads();
    for (int t = threadIdx.x; t < cnt; t += kThreads) {
      const float* p = kp + (int64_t)(base + t) * 3;
      tile[t] = make_float4(p[0], p[1], p[2], 0.f);
    }
    __syncthreads();
    if (!active) continue;
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      const float4 p = tile[j];
      float cd = sqdist(qx, qy, qz, p.x, p.y, p.z);
      int ci = base + j;
      if (!before(cd, ci, bd[2], bi[2])) continue;
#pragma unroll
      for (int t = 0; t < 3; ++t) {
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

  if (active) {
    float r[3];
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      r[t] = __fdiv_rn(1.f, __fadd_rn(__fsqrt_rn(fmaxf(bd[t], 0.f)), eps));
      bi[t] = min(bi[t], M - 1);  // only a NaN query leaves a slot unfilled
    }
    const float norm = __fadd_rn(__fadd_rn(r[0], r[1]), r[2]);
    int64_t* oi = out_i + ((int64_t)b * N + n) * 3;
    float* ow = out_w + ((int64_t)b * N + n) * 3;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const float w = __fdiv_rn(r[t], norm);
      oi[t] = bi[t];
      ow[t] = w;
      s_idx[threadIdx.x][t] = bi[t];
      s_w[threadIdx.x][t] = w;
    }
  }
  __syncthreads();

  // the block's rows, written together: element e of the flat (row, chunk)
  // range goes to thread e % kThreads
  const int rows = min(kThreads, N - n0);
  const float* f = feats + (int64_t)b * M * C;
  float* o = out + ((int64_t)b * N + n0) * C;
  if (kVec4) {
    const int c4 = C / 4;
    const int total = rows * c4;
    for (int e = threadIdx.x; e < total; e += kThreads) {
      const int row = e / c4;
      const int c = e - row * c4;
      const float4 a = reinterpret_cast<const float4*>(f + (int64_t)s_idx[row][0] * C)[c];
      const float4 bb = reinterpret_cast<const float4*>(f + (int64_t)s_idx[row][1] * C)[c];
      const float4 d = reinterpret_cast<const float4*>(f + (int64_t)s_idx[row][2] * C)[c];
      const float w0 = s_w[row][0], w1 = s_w[row][1], w2 = s_w[row][2];
      float4 res;
      res.x = mix(w0, a.x, w1, bb.x, w2, d.x);
      res.y = mix(w0, a.y, w1, bb.y, w2, d.y);
      res.z = mix(w0, a.z, w1, bb.z, w2, d.z);
      res.w = mix(w0, a.w, w1, bb.w, w2, d.w);
      reinterpret_cast<float4*>(o + (int64_t)row * C)[c] = res;
    }
  } else {
    const int total = rows * C;
    for (int e = threadIdx.x; e < total; e += kThreads) {
      const int row = e / C;
      const int c = e - row * C;
      o[(int64_t)row * C + c] =
          mix(s_w[row][0], f[(int64_t)s_idx[row][0] * C + c], s_w[row][1],
              f[(int64_t)s_idx[row][1] * C + c], s_w[row][2],
              f[(int64_t)s_idx[row][2] * C + c]);
    }
  }
}

}  // namespace

// unknown (B, N, 3), known (B, M, 3), feats (B, M, C) float32 -> out
// (B, N, C) float32, idx (B, N, 3) int64, w (B, N, 3) float32. Requires
// M >= 3 and N < 2**31, M * C < 2**31; the caller checks M.
extern "C" int three_nn_interpolate_f32(const float* unknown, const float* known,
                                        const float* feats, float* out,
                                        int64_t* idx, float* w, int64_t B,
                                        int64_t N, int64_t M, int64_t C,
                                        float eps, void* stream) {
  if (B == 0 || N == 0) return 0;
  const dim3 grid((unsigned)((N + kThreads - 1) / kThreads), (unsigned)B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = C % 4 == 0 && reinterpret_cast<uintptr_t>(feats) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec4) {
    three_nn_interp_kernel<true><<<grid, kThreads, 0, s>>>(
        unknown, known, feats, out, idx, w, (int)N, (int)M, (int)C, eps);
  } else {
    three_nn_interp_kernel<false><<<grid, kThreads, 0, s>>>(
        unknown, known, feats, out, idx, w, (int)N, (int)M, (int)C, eps);
  }
  return (int)cudaGetLastError();
}
