// Batched row scatter-add with index clamp:
//     out[b, clamp(idx[b, s], 0, rows - 1), :] += vals[b, s, :]
// into a zeroed (B, rows, C) float32 output.
//
// Replaces: imgadapointr_tpu/ops/pallas/scatter_rows.py:scatter_add_rows_pallas
// (`_scatter_kernel`). The TPU has no scatter, so that kernel multiplies
// one-hot masks on the matrix unit and splits the index in hi and lo parts,
// within VMEM limits of C <= 8 and rows <= 16384. A Hopper thread adds to
// any address, so this kernel is one atomicAdd per element and has neither
// limit. It serves the two cross terms of the chamfer backward (C = 3) and
// the backward of the row gather (C up to the model width). The index is
// clamped as the gather clamps it, so the cotangent of an out-of-range
// index lands on the clamped row
// (imgadapointr_tpu/ops/pallas/gather_rows.py:214-216).
//
// Sum order: float32 atomics add in whatever order the blocks run, so a
// row that receives several contributions can differ in its last bits from
// run to run, and so can a gradient that goes through it. The TPU kernel
// already sums in another order than XLA's scatter; the contract is
// agreement to float32 rounding, and bit-equality where every row receives
// at most one contribution. A deterministic design (sort by index, then a
// segmented sum) is left to a later redesign.
//
// Bound on the H100: bytes. Each value is read once and each output
// element written once (plus the indices); there is one add per value.
// Design: one thread per (source row, 4 channels) with a 16-byte load and
// one 16-byte vector atomic (Hopper's float4 atomicAdd) where C % 4 == 0
// and both pointers allow it, else one thread per element; the
// output is zeroed on the same stream before the launch; offsets are 64-bit
// (16 * 16384 * 8 rows of 384 floats do not fit 32).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int V>
__global__ void scatter_add_rows_kernel(const float* __restrict__ vals,
                                        const int64_t* __restrict__ idx,
                                        float* __restrict__ out, int64_t S,
                                        int64_t rows, int64_t width,
                                        int64_t total) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const int64_t row = t / width;  // flat (b, s)
    const int64_t c = t - row * width;
    const int64_t b = row / S;
    int64_t m = idx[row];
    m = m < 0 ? 0 : (m >= rows ? rows - 1 : m);
    float* dst = out + ((b * rows + m) * width + c) * V;
    if (V == 4) {
      // one 16-byte reduction (red.global.add.v4.f32, sm_90 and later)
      atomicAdd(reinterpret_cast<float4*>(dst),
                reinterpret_cast<const float4*>(vals)[t]);
    } else {
      atomicAdd(dst, vals[t]);
    }
  }
}

}  // namespace

// vals (B, S, C) float32, idx (B, S) int64 -> out (B, rows, C) float32,
// zeroed here.
extern "C" int scatter_add_rows_f32(const float* vals, const int64_t* idx,
                                    float* out, int64_t B, int64_t S,
                                    int64_t rows, int64_t C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t out_elems = B * rows * C;
  if (out_elems == 0) return 0;
  cudaError_t rc = cudaMemsetAsync(out, 0, out_elems * sizeof(float), s);
  if (rc != cudaSuccess) return (int)rc;
  if (S == 0) return 0;
  const bool vec4 =
      (C % 4 == 0) &&
      ((reinterpret_cast<uintptr_t>(vals) | reinterpret_cast<uintptr_t>(out)) %
           16 ==
       0);
  const int64_t width = vec4 ? C / 4 : C;
  const int64_t total = B * S * width;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride covers the rest
  if (vec4) {
    scatter_add_rows_kernel<4><<<(unsigned)blocks, threads, 0, s>>>(
        vals, idx, out, S, rows, width, total);
  } else {
    scatter_add_rows_kernel<1><<<(unsigned)blocks, threads, 0, s>>>(
        vals, idx, out, S, rows, width, total);
  }
  return (int)cudaGetLastError();
}
