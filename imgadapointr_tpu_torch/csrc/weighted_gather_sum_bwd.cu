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
// - dweights: bound on the H100: bytes (idx, g and the table read once,
//   dw written once). A warp per row s splits the channels over a group
//   of L lanes (L = half the row's width in float4 or float slots, rounded
//   up to a power of two, at most 32), so a warp takes 32 / L neighbours
//   at once, two such steps in flight; each lane keeps its g slots in
//   registers where the row has at most 2 L slots. The warp loads its
//   row's indices 32 at a time in one coalesced read and hands each group
//   its index by a shuffle. The dot product has no branch (row_dot): a
//   range check around the loads made each a divergent branch, and the
//   loop waited on them one after another. Each lane multiplies and adds
//   its slots in ascending channel order, and the group reduces with a
//   fixed butterfly of shuffles, so the result is the same in every run.
//   A block takes one b and DW_ROWS rows s and reads the neighbour rows
//   from device memory or L2, the two steps' rows in flight together. A
//   route that first copied one batch's table into shared memory (the
//   superset's GDANet shape: 128 KB a block) was slower on the H100 in
//   every mode timed: the rows hit L2, and the copy itself cost more than
//   it saved. Offsets are 64-bit.

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

constexpr int DW_THREADS = 512;  // 16 warps, a row each at a time
constexpr int DW_ROWS = 64;      // rows s per block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float dot(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ float dot(const float& a, const float& b, float acc) {
  return fmaf(a, b, acc);
}
__device__ __forceinline__ void zero(float4& v) { v = make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
__device__ __forceinline__ void zero(float& v) { v = 0.0f; }

// group's dot of g's row (in registers g0, g1 when FEW, else grow) with
// table row j; 0 for an index the caller marked invalid (j < 0). Without a
// branch where FEW: the row and the slots are clamped to ones that exist,
// loaded unconditionally and their terms selected, so the loads of both
// steps issue together instead of each behind a divergent branch.
template <typename V, bool FEW>
__device__ __forceinline__ float row_dot(const V* table, int j, const V* grow, V g0, V g1,
                                         int sub, int L, int64_t width) {
  const V* t = table + (int64_t)(j < 0 ? 0 : j) * width;
  float acc = 0.0f;
  if (FEW) {
    const V a0 = t[sub < width ? sub : 0];
    const V a1 = t[sub + L < width ? sub + L : 0];
    acc = sub < width ? dot(g0, a0, acc) : acc;
    acc = sub + L < width ? dot(g1, a1, acc) : acc;
  } else {
    for (int64_t c = sub; c < width; c += L) acc = dot(grow[c], t[c], acc);
  }
  return j < 0 ? 0.0f : acc;
}

// the dot products of one row with its neighbours m0 + [0, n), n <= 32:
// lane l holds the index of neighbour m0 + l (-1 if outside [0, M)); each
// step gives the warp's 32 / L groups one neighbour each, two steps in flight
template <typename V, bool FEW>
__device__ __forceinline__ void row_block(const V* table, const V* grow, V g0, V g1, int mine,
                                          int n, float* out, int sub, int group, int G, int L,
                                          int64_t width) {
  // the same trip count in every lane: the shuffles need the whole warp
  for (int i = 0; i < n; i += 2 * G) {
    const int ma = i + group, mb = i + G + group;
    const int ja = __shfl_sync(FULL, mine, ma & 31);
    const int jb = __shfl_sync(FULL, mine, mb & 31);
    float acc_a = row_dot<V, FEW>(table, ma < n ? ja : -1, grow, g0, g1, sub, L, width);
    float acc_b = row_dot<V, FEW>(table, mb < n ? jb : -1, grow, g0, g1, sub, L, width);
    for (int off = L >> 1; off > 0; off >>= 1) {
      acc_a += __shfl_xor_sync(FULL, acc_a, off, L);
      acc_b += __shfl_xor_sync(FULL, acc_b, off, L);
    }
    if (sub == 0 && ma < n) out[ma] = acc_a;
    if (sub == 0 && mb < n) out[mb] = acc_b;
  }
}

// lane's index of neighbour m of a row (-1 past K or outside [0, M))
__device__ __forceinline__ int load_index(const int64_t* idx_row, int64_t m, int64_t K, int64_t M) {
  if (m >= K) return -1;
  const int64_t j = idx_row[m];
  return (j >= 0 && j < M) ? (int)j : -1;
}

// V is float4 (width = C / 4) or float (width = C); L lanes per group;
// FEW: width <= 2 L.
template <typename V, bool FEW>
__global__ void __launch_bounds__(DW_THREADS)
dweights_kernel(const int64_t* __restrict__ idx, const V* __restrict__ g,
                const V* __restrict__ feats, float* __restrict__ dw, int64_t S, int64_t K,
                int64_t M, int64_t width, int L) {
  const int64_t b = blockIdx.y;
  const int64_t s0 = (int64_t)blockIdx.x * DW_ROWS;
  const V* table = feats + b * M * width;
  const int lane = threadIdx.x & 31;
  const int sub = lane % L, group = lane / L, G = 32 / L;
  const int64_t s1 = s0 + DW_ROWS < S ? s0 + DW_ROWS : S;
  for (int64_t s = s0 + (threadIdx.x >> 5); s < s1; s += DW_THREADS / 32) {
    const int64_t row = b * S + s;
    const V* grow = g + row * width;
    V g0, g1;
    zero(g0);
    zero(g1);
    if (FEW) {
      if (sub < width) g0 = grow[sub];
      if (sub + L < width) g1 = grow[sub + L];
    }
    for (int64_t m0 = 0; m0 < K; m0 += 32) {
      const int n = (int)(K - m0 < 32 ? K - m0 : 32);
      // the row's next 32 indices in one read
      const int mine = load_index(idx + row * K, m0 + lane, K, M);
      row_block<V, FEW>(table, grow, g0, g1, mine, n, dw + row * K + m0, sub, group, G, L, width);
    }
  }
}

template <typename V>
int launch_dweights(const int64_t* idx, const V* g, const V* feats, float* dw, int64_t B,
                    int64_t S, int64_t K, int64_t M, int64_t width, cudaStream_t s) {
  int L = 1;
  while (L < (width + 1) / 2 && L < 32) L <<= 1;
  const dim3 grid((unsigned)((S + DW_ROWS - 1) / DW_ROWS), (unsigned)B);
  auto kernel = width <= 2 * L ? dweights_kernel<V, true> : dweights_kernel<V, false>;
  kernel<<<grid, DW_THREADS, 0, s>>>(idx, g, feats, dw, S, K, M, width, L);
  return (int)cudaGetLastError();
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
extern "C" int weighted_gather_sum_dweights_f32(const int64_t* idx, const float* g,
                                                const float* feats, float* dw, int64_t B,
                                                int64_t S, int64_t K, int64_t M, int64_t C,
                                                void* stream) {
  const int64_t rows = B * S;
  if (rows == 0 || K == 0) return 0;
  if (B > 65535 || M >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 0) return (int)cudaMemsetAsync(dw, 0, rows * K * sizeof(float), s);
  if ((C % 4 == 0) && aligned16(g, feats))
    return launch_dweights(idx, reinterpret_cast<const float4*>(g),
                           reinterpret_cast<const float4*>(feats), dw, B, S, K, M, C / 4, s);
  return launch_dweights(idx, g, feats, dw, B, S, K, M, C, s);
}
