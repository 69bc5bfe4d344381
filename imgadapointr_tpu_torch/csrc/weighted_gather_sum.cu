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
// Bound on the H100: bytes, but at GDANet's shapes (B 8 or 16, S = M =
// 512, K 63, C 64) a call moves about 5 MB (1.6 us at the byte rate), while
// its table reads come to 66 MB at batch 8 (each output row reads 63 rows of
// 256 bytes): what a call costs is where those reads are served from and
// how long each chain of K multiply-adds waits for them. Design: no shared
// memory and no barrier. A block takes rows of one batch element only, 16
// warps, about one block an SM, so an SM's reads go to one 128 KB table and
// mostly hit L1 (blocks of rows in plain order put several batch elements'
// tables on an SM and read them from L2, and were slower on the H100). A group
// of L lanes (the row's 16-byte chunks rounded up to a power of two, 8 to
// 32) takes a row; the lanes read L of its indices and weights in one
// coalesced read and hand them round by __shfl_sync; kTerms table rows are
// read before their multiply-adds, so kTerms loads are in flight a lane. An
// out-of-range index reads row 0 and its term is skipped by a select, never
// multiplied by 0, so an inf or NaN row cannot leak. Each lane sums its
// channels in ascending m with fused multiply-adds from +0: the same order
// in every run. Offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;  // a block
constexpr int kTerms = 8;   // table rows a lane reads before their adds
constexpr unsigned kFull = 0xffffffffu;

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

// V is float (width = C) or float4 (width = C / 4); L lanes a row, a power
// of two from 8 to 32. Block (x, b) takes rows [x per_block, (x + 1)
// per_block) of batch element b.
template <typename V>
__global__ void __launch_bounds__(32 * kWarps)
    weighted_gather_sum_kernel(const float* __restrict__ w, const int64_t* __restrict__ idx,
                               const V* __restrict__ feats, V* __restrict__ out, int64_t S, int K,
                               int64_t M, int64_t width, int64_t per_block, int L) {
  const int lane = threadIdx.x & 31, sub = lane & (L - 1), rows_warp = 32 / L;
  const int64_t b = blockIdx.y;
  const int64_t lo = b * S + blockIdx.x * per_block;
  const int64_t hi = min(b * S + S, lo + per_block);
  const V* table = feats + b * M * width;
  // the loops' trip counts are the same in every lane: the shuffles need the whole warp
  for (int64_t r0 = lo + (int64_t)(threadIdx.x >> 5) * rows_warp; r0 < hi; r0 += (int64_t)kWarps * rows_warp) {
    const int64_t row = r0 + lane / L;
    const bool live = row < hi;
    const int64_t rc = live ? row : hi - 1;  // a dead group still shuffles with its warp
    const int64_t* ir = idx + rc * K;
    const float* wr = w + rc * K;
    for (int64_t c0 = 0; c0 < width; c0 += L) {
      const int64_t c = c0 + sub, cc = c < width ? c : width - 1;
      V acc;
      zero(acc);
      for (int m0 = 0; m0 < K; m0 += L) {
        // this lane's term m0 + sub: index -1 past K or outside [0, M)
        int j = -1;
        float wv = 0.0f;
        if (m0 + sub < K) {
          const int64_t t = ir[m0 + sub];
          wv = wr[m0 + sub];
          if (t >= 0 && t < M) j = (int)t;
        }
        const int n = min(L, K - m0);
        for (int u0 = 0; u0 < n; u0 += kTerms) {
          int jt[kTerms];
          float wt[kTerms];
          V f[kTerms];
#pragma unroll
          for (int t = 0; t < kTerms; ++t) {
            jt[t] = __shfl_sync(kFull, j, (u0 + t) & (L - 1), L);
            wt[t] = __shfl_sync(kFull, wv, (u0 + t) & (L - 1), L);
            f[t] = __ldg(table + (int64_t)(jt[t] < 0 ? 0 : jt[t]) * width + cc);
          }
#pragma unroll
          for (int t = 0; t < kTerms; ++t)
            if (u0 + t < n && jt[t] >= 0) fma_into(wt[t], f[t], acc);
        }
      }
      if (live && c < width) out[row * width + c] = acc;
    }
  }
}

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  int& c = count[dev & 63];
  if (c == 0 && cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) c = 1;
  return c;
}

template <typename V>
void launch(const float* w, const int64_t* idx, const float* feats, float* out, int64_t B, int64_t S,
            int64_t K, int64_t M, int64_t width, cudaStream_t s) {
  int L = 8;
  while (L < width && L < 32) L <<= 1;
  // about one block an SM, each of one batch element
  int64_t nbx = sm_count() / B;
  if (nbx < 1) nbx = 1;
  const int64_t per_block = (S + nbx - 1) / nbx;
  nbx = (S + per_block - 1) / per_block;
  weighted_gather_sum_kernel<V><<<dim3((unsigned)nbx, (unsigned)B), 32 * kWarps, 0, s>>>(
      w, idx, reinterpret_cast<const V*>(feats), reinterpret_cast<V*>(out), S, (int)K, M, width,
      per_block, L);
}

}  // namespace

extern "C" int weighted_gather_sum_f32(const float* w, const int64_t* idx,
                                       const float* feats, float* out,
                                       int64_t B, int64_t S, int64_t K,
                                       int64_t M, int64_t C, void* stream) {
  const int64_t rows = B * S;
  if (rows == 0 || C == 0) return 0;
  if (K >= ((int64_t)1 << 30) || B > 65535) return (int)cudaErrorInvalidValue;
  const bool vec4 =
      (C % 4 == 0) &&
      ((reinterpret_cast<uintptr_t>(feats) | reinterpret_cast<uintptr_t>(out)) % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4)
    launch<float4>(w, idx, feats, out, B, S, K, M, C / 4, s);
  else
    launch<float>(w, idx, feats, out, B, S, K, M, C, s);
  return (int)cudaGetLastError();
}
