// Backward of the batched weighted gather-sum
//     out[b, s, :] = sum_{m < K} w[b, s, m] * feats[b, idx[b, s, m], :]
// given the cotangent g (B, S, C) of out:
//     dfeats[b, j, :] = sum_{s, m : idx[b, s, m] == j} w[b, s, m] * g[b, s, :]
//     dw[b, s, m]     = g[b, s, :] . feats[b, idx[b, s, m], :]
// with w (B, S, K) float32, idx (B, S, K) int64, feats (B, M, C) float32.
// An index outside [0, M) contributes nothing to dfeats and gets dw = 0,
// as in the forward (csrc/weighted_gather_sum.cu).
//
// Replaces: imgadapointr_tpu/ops/pallas/gather_sum.py:_bwd_impl, the two
// kernels `_dfeats_kernel` (pallas_call at :135) and `_dweights_kernel`
// (:149). The TPU has neither gather nor scatter, so both build the dense
// (S, M) weight matrix W in VMEM with K compare-select passes and take
// dfeats = W^T g and dw = (g feats^T) at idx on the matrix unit; the dfeats
// block is carried across the sequential grid. A Hopper thread adds to and
// reads from any row, so neither kernel builds W:
//
// - dfeats: one thread per (b, s, m, 4 channels) reads w, idx and
//   g[b, s, c:c+4] and adds w * g into dfeats[b, idx] with one 16-byte
//   vector atomic (red.global.add.v4.f32, sm_90) where C % 4 == 0 and both
//   pointers allow it, else one thread and one float32 atomic per channel.
//   The output is zeroed on the same stream first. Bound on the H100:
//   bytes (w, idx and g read, dfeats written; 2 flops per term). Sum order:
//   the atomics add in whatever order the blocks run, so a row that
//   receives several terms can differ in its last bits from run to run,
//   as the scatter-add does (csrc/scatter_add_rows.cu); the contract is
//   agreement to float32 rounding.
// - dweights: a group of L lanes (L = the channel width in float4 or
//   float slots, rounded up to a power of two, at most 32) per (b, s, m);
//   a warp holds 32 / L groups, which take the m of one row in turn. Each
//   lane reads its channels of the neighbour row and of g (16-byte loads
//   where C % 4 == 0), multiplies and adds in ascending channel order, and
//   the group reduces with a fixed butterfly of shuffles, so the result is
//   the same in every run. Bound on the H100: bytes (idx, g and the table
//   read once, dw written once). Offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <int V>
__global__ void dfeats_kernel(const float* __restrict__ w,
                              const int64_t* __restrict__ idx,
                              const float* __restrict__ g,
                              float* __restrict__ dfeats, int64_t S, int64_t K,
                              int64_t M, int64_t width, int64_t total) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const int64_t term = t / width;  // flat (b, s, m)
    const int64_t c = t - term * width;
    const int64_t j = idx[term];
    if (j < 0 || j >= M) continue;
    const int64_t row = term / K;  // flat (b, s)
    const int64_t b = row / S;
    const float wv = w[term];
    if (V == 4) {
      const float4 gv = reinterpret_cast<const float4*>(g)[row * width + c];
      atomicAdd(reinterpret_cast<float4*>(dfeats) + (b * M + j) * width + c,
                make_float4(wv * gv.x, wv * gv.y, wv * gv.z, wv * gv.w));
    } else {
      atomicAdd(dfeats + (b * M + j) * width + c, wv * g[row * width + c]);
    }
  }
}

__device__ __forceinline__ float dot(const float4& a, const float4& b,
                                     float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ float dot(const float& a, const float& b,
                                     float acc) {
  return fmaf(a, b, acc);
}

// V is float4 (width = C / 4) or float (width = C); L lanes per group.
template <typename V>
__global__ void dweights_kernel(const int64_t* __restrict__ idx,
                                const V* __restrict__ g,
                                const V* __restrict__ feats,
                                float* __restrict__ dw, int64_t S, int64_t K,
                                int64_t M, int64_t width, int64_t rows, int L) {
  const int lane = threadIdx.x & 31;
  const int sub = lane % L;        // lane within its group
  const int group = lane / L;      // group within the warp
  const int groups = 32 / L;
  const int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (row >= rows) return;  // uniform over the warp
  const V* grow = g + row * width;
  const V* table = feats + (row / S) * M * width;
  // the same trip count in every lane: the shuffles need the whole warp
  for (int64_t m0 = 0; m0 < K; m0 += groups) {
    const int64_t m = m0 + group;
    float acc = 0.0f;
    if (m < K) {
      const int64_t j = idx[row * K + m];
      if (j >= 0 && j < M) {  // uniform over the group
        const V* frow = table + j * width;
        for (int64_t c = sub; c < width; c += L) acc = dot(grow[c], frow[c], acc);
      }
    }
    for (int off = L >> 1; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off, L);
    if (sub == 0 && m < K) dw[row * K + m] = acc;
  }
}

bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) %
          16) == 0;
}

}  // namespace

// w (B, S, K), idx (B, S, K), g (B, S, C) -> dfeats (B, M, C), zeroed here.
extern "C" int weighted_gather_sum_dfeats_f32(const float* w,
                                              const int64_t* idx,
                                              const float* g, float* dfeats,
                                              int64_t B, int64_t S, int64_t K,
                                              int64_t M, int64_t C,
                                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t out_elems = B * M * C;
  if (out_elems == 0) return 0;
  cudaError_t rc = cudaMemsetAsync(dfeats, 0, out_elems * sizeof(float), s);
  if (rc != cudaSuccess) return (int)rc;
  const bool vec4 = (C % 4 == 0) && aligned16(g, dfeats);
  const int64_t width = vec4 ? C / 4 : C;
  const int64_t total = B * S * K * width;
  if (total == 0) return 0;
  int64_t blocks = (total + THREADS - 1) / THREADS;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride covers the rest
  if (vec4) {
    dfeats_kernel<4><<<(unsigned)blocks, THREADS, 0, s>>>(w, idx, g, dfeats, S,
                                                         K, M, width, total);
  } else {
    dfeats_kernel<1><<<(unsigned)blocks, THREADS, 0, s>>>(w, idx, g, dfeats, S,
                                                         K, M, width, total);
  }
  return (int)cudaGetLastError();
}

// idx (B, S, K), g (B, S, C), feats (B, M, C) -> dw (B, S, K).
extern "C" int weighted_gather_sum_dweights_f32(const int64_t* idx,
                                                const float* g,
                                                const float* feats, float* dw,
                                                int64_t B, int64_t S, int64_t K,
                                                int64_t M, int64_t C,
                                                void* stream) {
  const int64_t rows = B * S;
  if (rows == 0 || K == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 0) return (int)cudaMemsetAsync(dw, 0, rows * K * sizeof(float), s);
  const bool vec4 = (C % 4 == 0) && aligned16(g, feats);
  const int64_t width = vec4 ? C / 4 : C;
  int L = 1;
  while (L < width && L < 32) L <<= 1;
  const int64_t blocks = (rows * 32 + THREADS - 1) / THREADS;  // a warp per row
  if (vec4) {
    dweights_kernel<float4><<<(unsigned)blocks, THREADS, 0, s>>>(
        idx, reinterpret_cast<const float4*>(g),
        reinterpret_cast<const float4*>(feats), dw, S, K, M, width, rows, L);
  } else {
    dweights_kernel<float><<<(unsigned)blocks, THREADS, 0, s>>>(
        idx, g, feats, dw, S, K, M, width, rows, L);
  }
  return (int)cudaGetLastError();
}
