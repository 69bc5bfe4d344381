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
// there is no arithmetic to speak of. The design moves 16 bytes per thread
// (float4) whenever the row width and both base pointers allow it, so
// neighbouring threads touch neighbouring 16-byte words of one row, and
// falls back to one float per thread otherwise (C = 3). Indices are clamped
// exactly as XLA's gather clamps them, so sentinel-index callers behave the
// same as on the TPU.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void gather_rows_kernel(const T* __restrict__ table,
                                   const int64_t* __restrict__ idx,
                                   T* __restrict__ out, int64_t S, int64_t M,
                                   int64_t width, int64_t total) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const int64_t row = t / width;  // flat (b, s)
    const int64_t c = t - row * width;
    const int64_t b = row / S;
    int64_t m = idx[row];
    m = m < 0 ? 0 : (m >= M ? M - 1 : m);
    out[t] = table[(b * M + m) * width + c];
  }
}

}  // namespace

extern "C" int gather_rows_f32(const float* table, const int64_t* idx,
                               float* out, int64_t B, int64_t M, int64_t S,
                               int64_t C, void* stream) {
  const int64_t rows = B * S;
  if (rows == 0 || C == 0) return 0;
  const bool vec4 =
      (C % 4 == 0) &&
      ((reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out)) %
           16 ==
       0);
  const int64_t width = vec4 ? C / 4 : C;
  const int64_t total = rows * width;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride covers the rest
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    gather_rows_kernel<float4><<<(unsigned)blocks, threads, 0, s>>>(
        reinterpret_cast<const float4*>(table), idx,
        reinterpret_cast<float4*>(out), S, M, width, total);
  } else {
    gather_rows_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(
        table, idx, out, S, M, width, total);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
