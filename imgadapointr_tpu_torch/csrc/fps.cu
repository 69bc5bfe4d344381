// Farthest point sampling (the pointnet2 contract):
//     out[b, 0] = 0; then npoint - 1 times: fold the diff-form squared
//     distance to the last pick into a running minimum (initialised to
//     1e10) and pick the first index of its maximum.
//
// Replaces: imgadapointr_tpu/ops/pallas/fps.py:furthest_point_sample_pallas
// (`_fps_kernel`), which keeps coordinates and the min-distance cache in
// VMEM and batches several clouds per grid step because the TPU has one
// core to serialise on.
//
// Bound on the H100: latency. The npoint steps depend on each other (each
// needs the previous argmax), and one step is only N distance updates plus
// a block-wide argmax, so the card's rates are far away; what counts is the
// time of one step. Design: one block per cloud, so the batch fills SMs in
// parallel; the coordinates and the cache live in shared memory for the
// whole loop (16 bytes a point: N <= 14336 fits in one SM's 227 KB); each
// step is one pass over the thread's points, a warp-shuffle argmax and one
// more across warps, two barriers in all. Ties go to the lowest index at
// every level of the reduction, as torch.argmax and jnp.argmax do.
//
// Distances use __fsub_rn/__fmul_rn/__fadd_rn: no FMA contraction changes
// the rounding against the plain PyTorch version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    take_better(v, i, ov, oi);
  }
}

__global__ void __launch_bounds__(kThreads)
    fps_kernel(const float* __restrict__ xyz, int64_t* __restrict__ out, int N,
               int npoint) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + N;
  float* sz = sy + N;
  float* md = sz + N;
  __shared__ float red_v[kThreads / 32];
  __shared__ int red_i[kThreads / 32];
  __shared__ int s_last;

  const int b = blockIdx.x;
  const float* p = xyz + (int64_t)b * N * 3;
  int64_t* o = out + (int64_t)b * npoint;
  for (int i = threadIdx.x; i < N; i += kThreads) {
    sx[i] = p[3 * i];
    sy[i] = p[3 * i + 1];
    sz[i] = p[3 * i + 2];
    md[i] = 1e10f;
  }
  if (threadIdx.x == 0) o[0] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int last = 0;
  for (int it = 1; it < npoint; ++it) {
    const float px = sx[last], py = sy[last], pz = sz[last];
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int i = threadIdx.x; i < N; i += kThreads) {
      const float dx = __fsub_rn(sx[i], px);
      const float dy = __fsub_rn(sy[i], py);
      const float dz = __fsub_rn(sz[i], pz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      const float m = fminf(md[i], d);
      md[i] = m;
      if (m > bv) {  // i rises within a thread: keeps the first index on ties
        bv = m;
        bi = i;
      }
    }
    warp_argmax(bv, bi);
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = red_v[lane];  // kThreads / 32 == 32 partials, one per lane
      bi = red_i[lane];
      warp_argmax(bv, bi);
      if (lane == 0) {
        s_last = bi;
        o[it] = bi;
      }
    }
    __syncthreads();
    last = s_last;
  }
}

}  // namespace

// Largest cloud whose coordinates and cache fit in one block's shared memory.
extern "C" int64_t fps_max_points() {
  return (227 * 1024 - 2 * kThreads / 32 * 4 - 16) / 16;
}

// xyz (B, N, 3) float32 -> out (B, npoint) int64. Requires 1 <= N <=
// fps_max_points() and npoint >= 1; the caller checks.
extern "C" int fps_f32(const float* xyz, int64_t* out, int64_t B, int64_t N,
                       int64_t npoint, void* stream) {
  if (B == 0 || npoint == 0) return 0;
  const size_t smem = (size_t)N * 4 * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fps_kernel<<<(unsigned)B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xyz, out, (int)N, (int)npoint);
  return (int)cudaGetLastError();
}
