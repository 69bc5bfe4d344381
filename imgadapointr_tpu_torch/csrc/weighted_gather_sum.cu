// Batched weighted gather-sum:
//     out[b, s, :] = sum_{m < K} w[b, s, m] * feats[b, idx[b, s, m], :]
// with w (B, S, K) float32, idx (B, S, K) int64, feats (B, M, C) float32 and
// out (B, S, C) float32. An index outside [0, M) contributes nothing.
//
// Replaces: imgadapointr_tpu/ops/pallas/gather_sum.py:weighted_gather_sum_pallas
// (forward, `_fwd_kernel`). The TPU has no gather, so that kernel builds a
// dense (S, M) weight matrix in VMEM with K compare-select passes and
// multiplies it with the feature table on the matrix unit; its VMEM budget
// is why the JAX package takes it only for N <= 2048 and C <= 256. Its
// compare-select gives an out-of-range index no column, hence no weight;
// this kernel skips such an index the same way. A Hopper thread reads any
// row, so here the sum is a direct gather: no dense matrix and no size
// limit.
//
// Bound on the H100: bytes. At GDANet's shapes (B 8, S = M = 512, K 63,
// C 64) the kernel reads w, idx and the table and writes out (about 5 MB)
// and does 2*B*S*K*C = 33 MFLOP, far under the fp32 rate. Design: one block
// per tile of rows (b, s); the tile's weights and indices are staged in
// shared memory, a chunk of KCHUNK at a time, with the range check done
// there once; the threads of a row span its C channels, 16 bytes each where
// C % 4 == 0 and both pointers allow it, so a row of the table is one
// coalesced read; the table (128 KB per batch element at GDANet's shapes)
// is read through L2. Each thread sums in ascending m with fused
// multiply-adds. Offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KCHUNK = 32;    // (weight, index) pairs staged per row at a time
constexpr int MAX_ROWS = 64;  // rows of a tile (blockDim.y)
constexpr int THREADS = 256;

__device__ __forceinline__ void zero(float& a) { a = 0.0f; }
__device__ __forceinline__ void zero(float4& a) { a = make_float4(0.0f, 0.0f, 0.0f, 0.0f); }

__device__ __forceinline__ void fma_into(float w, const float& f, float& acc) {
  acc = fmaf(w, f, acc);
}
__device__ __forceinline__ void fma_into(float w, const float4& f, float4& acc) {
  acc.x = fmaf(w, f.x, acc.x);
  acc.y = fmaf(w, f.y, acc.y);
  acc.z = fmaf(w, f.z, acc.z);
  acc.w = fmaf(w, f.w, acc.w);
}

// V is float (one channel per thread) or float4 (four); `width` is C / 4
// for float4, else C. blockDim = (threads across the width, rows of the tile).
template <typename V>
__global__ void weighted_gather_sum_kernel(const float* __restrict__ w,
                                           const int64_t* __restrict__ idx,
                                           const V* __restrict__ feats,
                                           V* __restrict__ out, int64_t S,
                                           int64_t K, int64_t M, int64_t width,
                                           int64_t rows) {
  __shared__ float sw[MAX_ROWS][KCHUNK];
  __shared__ int si[MAX_ROWS][KCHUNK];  // -1: out of range or past K
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = ty * blockDim.x + tx;
  const int64_t row0 = (int64_t)blockIdx.x * blockDim.y;
  const int64_t row = row0 + ty;  // flat (b, s)
  const bool live = row < rows;
  const V* table = feats + (live ? row / S : 0) * M * width;

  // Loops with a barrier inside run the same trip count in every thread.
  for (int64_t c0 = 0; c0 < width; c0 += blockDim.x) {
    const int64_t c = c0 + tx;
    V acc;
    zero(acc);
    for (int64_t k0 = 0; k0 < K; k0 += KCHUNK) {
      __syncthreads();  // the previous chunk is consumed
      for (int e = tid; e < (int)blockDim.y * KCHUNK; e += nthreads) {
        const int r = e / KCHUNK, j = e - r * KCHUNK;
        const int64_t rr = row0 + r, m = k0 + j;
        float wv = 0.0f;
        int iv = -1;
        if (rr < rows && m < K) {
          const int64_t i = idx[rr * K + m];
          if (i >= 0 && i < M) {
            wv = w[rr * K + m];
            iv = (int)i;
          }
        }
        sw[r][j] = wv;
        si[r][j] = iv;
      }
      __syncthreads();
      if (live && c < width) {
        const int n = (int)(K - k0 < KCHUNK ? K - k0 : KCHUNK);
        for (int j = 0; j < n; ++j) {
          const int i = si[ty][j];
          if (i >= 0) fma_into(sw[ty][j], table[(int64_t)i * width + c], acc);
        }
      }
    }
    if (live && c < width) out[row * width + c] = acc;
  }
}

}  // namespace

extern "C" int weighted_gather_sum_f32(const float* w, const int64_t* idx,
                                       const float* feats, float* out,
                                       int64_t B, int64_t S, int64_t K,
                                       int64_t M, int64_t C, void* stream) {
  const int64_t rows = B * S;
  if (rows == 0 || C == 0) return 0;
  const bool vec4 =
      (C % 4 == 0) &&
      ((reinterpret_cast<uintptr_t>(feats) | reinterpret_cast<uintptr_t>(out)) %
           16 ==
       0);
  const int64_t width = vec4 ? C / 4 : C;
  int tx = 1;
  while (tx < width && tx < THREADS) tx <<= 1;
  int ty = THREADS / tx;
  if (ty > MAX_ROWS) ty = MAX_ROWS;
  const dim3 block(tx, ty);
  const int64_t blocks = (rows + ty - 1) / ty;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    weighted_gather_sum_kernel<float4><<<(unsigned)blocks, block, 0, s>>>(
        w, idx, reinterpret_cast<const float4*>(feats),
        reinterpret_cast<float4*>(out), S, K, M, width, rows);
  } else {
    weighted_gather_sum_kernel<float><<<(unsigned)blocks, block, 0, s>>>(
        w, idx, feats, out, S, K, M, width, rows);
  }
  return (int)cudaGetLastError();
}
