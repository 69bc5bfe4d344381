// Batched row gather with index clamp:
//     out[b, s, :] = table[b, clamp(idx[b, s], 0, M - 1), :]
//
// Replaces: imgadapointr_tpu/ops/pallas/gather_rows.py:gather_rows_pallas
// (both regimes, `_gather_kernel` and `_gather_hilo_kernel`). The TPU kernel
// needed lane-gather probes and a hi/lo index split because its vector unit
// gathers only inside 128-lane registers; a Hopper thread loads any address,
// so one row gather serves every `index_points` of the port, wide rows
// (C = 384, graph attention) included.
//
// Bound on the H100: bytes. Each output element is one load and one store;
// there is no arithmetic to speak of. Design: a row belongs to a group of L
// lanes (L a power of two sized to the row: one thread for rows of fewer
// than four words, such as C = 3, up to a warp for C = 384). Lane 0 loads
// and clamps the row's index once and hands it to the group by a shuffle;
// the batch is blockIdx.y, so a row's offsets are two multiplies and the
// copy loop has no division or modulo. Words are 16 bytes (float4) whenever
// the row width is a multiple of 4 and both base pointers are 16-byte
// aligned, so a warp's lanes touch neighbouring 16-byte words of a row;
// otherwise words are single floats. Indices are clamped exactly as XLA's
// gather clamps them, so sentinel-index callers behave the same as on the
// TPU.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// T the word (float or float4), W words a row, L lanes a row.
template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(const T* __restrict__ table,
                       const int64_t* __restrict__ idx, T* __restrict__ out,
                       int S, int M, int W) {
  constexpr int kRows = kThreads / L;  // rows a block
  const int lane = threadIdx.x & (L - 1);
  const int s = blockIdx.x * kRows + threadIdx.x / L;
  const int64_t row = (int64_t)blockIdx.y * S + s;
  int m = 0;
  if (lane == 0 && s < S) {
    const int64_t v = __ldg(idx + row);
    m = v < 0 ? 0 : (v >= M ? M - 1 : (int)v);
  }
  if (L > 1) m = __shfl_sync(0xffffffffu, m, 0, L);  // groups never straddle a warp
  if (s >= S) return;
  const T* __restrict__ src = table + ((int64_t)blockIdx.y * M + m) * W;
  T* __restrict__ dst = out + row * W;
  for (int c = lane; c < W; c += L) dst[c] = __ldg(src + c);
}

// Lanes a row: one thread for rows of fewer than 4 words, else the largest
// power of two up to 32 that does not exceed the row.
int lanes_for(int64_t words) {
  if (words < 4) return 1;
  int l = 4;
  while (l < 32 && 2 * l <= words) l *= 2;
  return l;
}

template <typename T>
cudaError_t launch_gather(const T* table, const int64_t* idx, T* out,
                          int64_t B, int64_t M, int64_t S, int64_t W,
                          cudaStream_t stream) {
  const int L = lanes_for(W);
  const int rows = kThreads / L;
  const dim3 grid((unsigned)((S + rows - 1) / rows), (unsigned)B);
  switch (L) {
    case 1:
      gather_rows_kernel<T, 1><<<grid, kThreads, 0, stream>>>(table, idx, out, (int)S, (int)M, (int)W);
      break;
    case 4:
      gather_rows_kernel<T, 4><<<grid, kThreads, 0, stream>>>(table, idx, out, (int)S, (int)M, (int)W);
      break;
    case 8:
      gather_rows_kernel<T, 8><<<grid, kThreads, 0, stream>>>(table, idx, out, (int)S, (int)M, (int)W);
      break;
    case 16:
      gather_rows_kernel<T, 16><<<grid, kThreads, 0, stream>>>(table, idx, out, (int)S, (int)M, (int)W);
      break;
    default:
      gather_rows_kernel<T, 32><<<grid, kThreads, 0, stream>>>(table, idx, out, (int)S, (int)M, (int)W);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int gather_rows_f32(const float* table, const int64_t* idx,
                               float* out, int64_t B, int64_t M, int64_t S,
                               int64_t C, void* stream) {
  if (B == 0 || S == 0 || C == 0) return 0;
  if (B > 65535 || S > INT32_MAX || M > INT32_MAX || C > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec4 =
      (C % 4 == 0) &&
      ((reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out)) %
           16 ==
       0);
  if (vec4)
    return (int)launch_gather(reinterpret_cast<const float4*>(table), idx,
                              reinterpret_cast<float4*>(out), B, M, S, C / 4, st);
  return (int)launch_gather(table, idx, out, B, M, S, C, st);
}

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
