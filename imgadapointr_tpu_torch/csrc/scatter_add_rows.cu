// Batched row scatter-add with index clamp:
//     out[b, clamp(idx[b, s], 0, rows - 1), :] += vals[b, s, :]
// into a (B, rows, C) float32 output that starts at zero.
//
// Replaces: imgadapointr_tpu/ops/pallas/scatter_rows.py:scatter_add_rows_pallas
// (`_scatter_kernel`). The TPU has no scatter, so that kernel multiplies
// one-hot masks on the matrix unit and splits the index in hi and lo parts,
// within VMEM limits of C <= 8 and rows <= 16384; it is deterministic. This
// kernel serves the two cross terms of the chamfer backward (C = 3) and the
// backward of the row gather (C up to the model width), and has neither
// limit. The index is clamped as the gather clamps it, so the cotangent of
// an out-of-range index lands on the clamped row
// (imgadapointr_tpu/ops/pallas/gather_rows.py:214-216).
//
// Sum order: every output element is the float32 sum of its contributions
// in increasing source order, ((0 + v_s1) + v_s2) + ..., as the plain
// version (PyTorch's CPU scatter_add_) takes it. So the kernel is bit-equal
// to the plain version on the CPU, and two runs give the same bits. There
// are no atomics on the values and no zeroing pass: each output element is
// written once, a row with no source as zero.
//
// Bound on the H100: bytes. Each value is read once and each output
// element written once (plus the indices); there is one add per value.
// Design: destination-major, one kernel. Block (b, k) owns the destination
// span [k span, (k + 1) span) of batch element b, span = 32 << shift, so
// that the spans of a batch fill the card; it needs nothing from other
// blocks.
// - (F, R) It lists the sources that land in its span and sorts them
//   stably by destination (span_sort.cuh; the destination of source s is
//   its clamped index).
// - (S) The sums. The block stages windows of the list's values in shared
//   memory, every thread loading (16-byte chunks where C % 4 == 0 and the
//   pointers allow it, as gather_rows.cu), then one thread a (row, chunk)
//   adds its row's values in order from there and writes the row once. A
//   row of thousands of sources (the chamfer cross terms at a random init
//   send 2600-3000 sources to one row) then costs a chain of adds, not a
//   chain of loads; a row that runs past a window carries its sums on.
// On the train steps' calls (S <= 16384, spans <= 16384 destinations) the
// counts, both lists and the staging live in shared memory, a block taking
// all that it may have; larger calls keep the counts and lists in int32
// scratch the wrapper allocates (scatter_add_rows_scratch entries) and sum
// each row by a group of lanes sized to it, two loads in flight.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "span_sort.cuh"

namespace {

using span_sort::kBins;
using span_sort::kSharedSources;
using span_sort::kSharedSpan;
using span_sort::kThreads;
using span_sort::kWarps;
constexpr int64_t kSpanBlocks = 128;  // blocks to aim for over the batch
// chunks of a row a lane takes: 16-byte (V = 4) or 4-byte (V = 1) ones
template <int V>
constexpr int kChunks = V == 4 ? 2 : 4;

__device__ __forceinline__ int clamp_row(int64_t m, int rows) {
  return (int)(m < 0 ? 0 : (m >= rows ? rows - 1 : m));
}

__device__ __forceinline__ void store(float4* p, const float (&a)[4]) {
  *p = make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ void store(float* p, const float (&a)[1]) { *p = a[0]; }

// kShared: the counts and the span's sources in dynamic shared memory
// (span_sort.cuh), then the sums' staging in the rest of it; else the counts
// and lists in this block's share of the int32 scratch. V = 4: 16-byte
// chunks of a row (width = C / 4 of them), V = 1: single floats (width = C).
template <bool kShared, int V>
__global__ void __launch_bounds__(kThreads)
    scatter_add_rows_kernel(const float* __restrict__ vals, const int64_t* __restrict__ idx,
                            float* __restrict__ out, int* __restrict__ scratch, int S,
                            int rows, int shift, int width, int group, int smem_words) {
  typedef typename std::conditional<V == 4, float4, float>::type T;
  extern __shared__ int4 dyn4[];  // 16-byte aligned
  int* dyn = reinterpret_cast<int*>(dyn4);
  const int64_t b = blockIdx.x;
  const int span = kBins << shift;
  const int lo = blockIdx.y * span, nrow = min(span, rows - lo);
  idx += b * S;
  const T* src = reinterpret_cast<const T*>(vals) + b * S * (int64_t)width;
  T* dst = reinterpret_cast<T*>(out) + (b * rows + lo) * (int64_t)width;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int *count, *list;
  const int n = span_sort::sort_span<kShared>(
      [&](int s) { return clamp_row(idx[s], rows); }, S, rows, lo, nrow, shift, dyn,
      kShared ? nullptr : scratch + b * ((int64_t)rows + 2 * S), count, list);
  auto source = [](int e) { return span_sort::source<kShared>(e); };

  // (S) each row's sources in order: entries [end of the row before, end)
  // On the shared route the block stages windows of the list's values in
  // shared memory, all threads loading, then one thread a (row, chunk)
  // adds its row's values in order from there: a long row costs its chain
  // of adds, not a chain of loads. A row that runs past a window carries its
  // sums to the next (two buffers, by window parity).
  const int stage0 = (span + S + 3) & ~3;  // 16-byte aligned, after the list
  const int window = kShared ? (smem_words - stage0 - 2 * V * width) / (V * width) : 0;
  if (window >= 32) {
    T* stage = reinterpret_cast<T*>(dyn + stage0);
    T* carry = stage + (int64_t)window * width;  // [2][width]
    for (int r = tid; r < nrow; r += kThreads)  // rows with no source
      if ((r == 0 ? 0 : count[r - 1]) == count[r])
        for (int k = 0; k < width; ++k) dst[(int64_t)r * width + k] = T{};
    auto row_of = [&](int e) {  // the row of entry e: the first whose end is past e
      int a = 0, z = nrow - 1;
      while (a < z) {
        const int m = (a + z) >> 1;
        if (count[m] > e) z = m;
        else a = m + 1;
      }
      return a;
    };
    for (int e0 = 0, parity = 0; e0 < n; e0 += window, parity ^= 1) {
      const int e1 = min(n, e0 + window);
#pragma unroll 8
      for (int q = tid; q < (e1 - e0) * width; q += kThreads) {
        const int e = e0 + q / width;
        stage[q] = src[(int64_t)source(list[e]) * width + (q - (e - e0) * width)];
      }
      __syncthreads();
      const int r0 = row_of(e0), r1 = row_of(e1 - 1) + 1;
      for (int q = tid; q < (r1 - r0) * width; q += kThreads) {
        const int r = r0 + q / width, k = q - (r - r0) * width;
        const int rb = r == 0 ? 0 : count[r - 1], re = count[r];
        float acc[V] = {};
        if (rb < e0) {  // the row began in the window before
          const T c = carry[parity * width + k];
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = reinterpret_cast<const float*>(&c)[v];
        }
        const T* from = stage + (int64_t)(max(rb, e0) - e0) * width + k;
        int e = max(rb, e0);
        const int z = min(re, e1);
        for (; e + 4 <= z; e += 4, from += 4 * width) {  // four loads ahead of the adds
          const T x[4] = {from[0], from[width], from[2 * width], from[3 * width]};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[v] = __fadd_rn(acc[v], reinterpret_cast<const float*>(&x[u])[v]);
        }
        for (; e < z; ++e, from += width) {
          const T x = *from;
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = __fadd_rn(acc[v], reinterpret_cast<const float*>(&x)[v]);
        }
        if (re <= e1) store(dst + (int64_t)r * width + k, acc);
        else store(carry + (parity ^ 1) * width + k, acc);
      }
      __syncthreads();
    }
    return;
  }
  // otherwise a group of lanes sized to the row, each lane up to kChunks of
  // its chunks, two sources' loads in flight
  const int rows_step = 32 / group;
  const int gl = lane % group;
  for (int r = warp * rows_step + lane / group; r < nrow; r += kWarps * rows_step) {
    const int beg = r == 0 ? 0 : count[r - 1], stop = count[r];
    for (int c0 = gl; c0 < width; c0 += kChunks<V> * group) {
      float acc[kChunks<V>][V] = {};
      int nc = 0;  // this lane's chunks: c0 + k * group, k < nc
      while (nc < kChunks<V> && c0 + nc * group < width) ++nc;
      int i = beg;
      for (; i + 2 <= stop; i += 2) {  // two sources' loads in flight, added in order
        const T* r0 = src + (int64_t)source(list[i]) * width + c0;
        const T* r1 = src + (int64_t)source(list[i + 1]) * width + c0;
        T v0[kChunks<V>], v1[kChunks<V>];
#pragma unroll
        for (int k = 0; k < kChunks<V>; ++k)
          if (k < nc) {
            v0[k] = r0[k * group];
            v1[k] = r1[k * group];
          }
#pragma unroll
        for (int k = 0; k < kChunks<V>; ++k)
          if (k < nc)
#pragma unroll
            for (int e = 0; e < V; ++e) {
              acc[k][e] = __fadd_rn(acc[k][e], reinterpret_cast<const float*>(&v0[k])[e]);
              acc[k][e] = __fadd_rn(acc[k][e], reinterpret_cast<const float*>(&v1[k])[e]);
            }
      }
      if (i < stop) {
        const T* r0 = src + (int64_t)source(list[i]) * width + c0;
#pragma unroll
        for (int k = 0; k < kChunks<V>; ++k)
          if (k < nc) {
            const T v = r0[k * group];
#pragma unroll
            for (int e = 0; e < V; ++e)
              acc[k][e] = __fadd_rn(acc[k][e], reinterpret_cast<const float*>(&v)[e]);
          }
      }
      T* row = dst + (int64_t)r * width + c0;
#pragma unroll
      for (int k = 0; k < kChunks<V>; ++k)
        if (k < nc) store(row + k * group, acc[k]);
    }
  }
}

// spans of 32 << shift destinations: the least shift that leaves at most
// kSpanBlocks / B spans (and at most 65535) for each batch element
int span_shift(int64_t B, int64_t rows) {
  int64_t want = B >= kSpanBlocks ? 1 : kSpanBlocks / B;
  if (want > 65535) want = 65535;
  int shift = 0;
  while ((rows + ((int64_t)kBins << shift) - 1) / ((int64_t)kBins << shift) > want) ++shift;
  return shift;
}

bool shared_route(int64_t S, int64_t span) { return span <= kSharedSpan && S <= kSharedSources; }

template <bool kShared>
cudaError_t launch(const float* vals, const int64_t* idx, float* out, int* scratch,
                   int64_t B, int64_t S, int64_t rows, int64_t C, int shift,
                   size_t smem, cudaStream_t st) {
  const bool vec4 =
      (C % 4 == 0) &&
      ((reinterpret_cast<uintptr_t>(vals) | reinterpret_cast<uintptr_t>(out)) % 16 == 0);
  const int64_t width = vec4 ? C / 4 : C;
  const int chunks = vec4 ? kChunks<4> : kChunks<1>;
  int group = 1;  // lanes a row: each takes at most `chunks` chunks
  while (group < 32 && (int64_t)group * chunks < width) group <<= 1;
  const int64_t span = (int64_t)kBins << shift;
  const dim3 grid((unsigned)B, (unsigned)((rows + span - 1) / span));
  const int words = (int)(smem / sizeof(int));
  if (vec4) {
    scatter_add_rows_kernel<kShared, 4><<<grid, kThreads, smem, st>>>(
        vals, idx, out, scratch, (int)S, (int)rows, shift, (int)width, group, words);
  } else {
    scatter_add_rows_kernel<kShared, 1><<<grid, kThreads, smem, st>>>(
        vals, idx, out, scratch, (int)S, (int)rows, shift, (int)width, group, words);
  }
  return cudaGetLastError();
}

}  // namespace

// The int32 scratch entries a call needs: none on the shared route,
// B * (rows + 2 S) otherwise.
extern "C" int64_t scatter_add_rows_scratch(int64_t B, int64_t S, int64_t rows) {
  const int64_t span = (int64_t)kBins << span_shift(B, rows);
  return shared_route(S, span) ? 0 : B * (rows + 2 * S);
}

// vals (B, S, C) float32, idx (B, S) int64 -> out (B, rows, C) float32;
// scratch: scatter_add_rows_scratch(B, S, rows) int32 entries.
extern "C" int scatter_add_rows_f32(const float* vals, const int64_t* idx,
                                    float* out, int* scratch, int64_t B,
                                    int64_t S, int64_t rows, int64_t C,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B * rows * C == 0) return 0;
  if (S >= (1ll << 30) || rows >= (1ll << 30) || C >= (1ll << 30)) return (int)cudaErrorInvalidValue;
  const int shift = span_shift(B, rows);
  if (!shared_route(S, (int64_t)kBins << shift))
    return (int)launch<false>(vals, idx, out, scratch, B, S, rows, C, shift, 0, st);
  // the shared route takes all the shared memory a block may have: what the
  // sort leaves is the sum's staging (set once per device)
  static int smem[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  int& bytes = smem[dev & 63];
  if (bytes == 0) {
    int optin = 0;
    cudaFuncAttributes attr;
    cudaError_t e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, scatter_add_rows_kernel<true, 4>);
    const int most = optin - (int)attr.sharedSizeBytes;
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(scatter_add_rows_kernel<true, 4>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(scatter_add_rows_kernel<true, 1>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return (int)e;
    bytes = most;
  }
  return (int)launch<true>(vals, idx, out, scratch, B, S, rows, C, shift, (size_t)bytes, st);
}
