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
// needs the previous pick), and one step is only N distance updates plus a
// block-wide argmax, so the card's rates are far away; what counts is the
// time of one step. Its floor is one pass over a thread's points (about 15
// issue slots a point, N / 128 lanes of the SM's four schedulers), a warp
// argmax, a shared-memory write, one barrier and a shared-memory read.
//
// Design: one block per cloud, sized to N: T threads (a multiple of 32)
// each own P contiguous points (x, y, z and the running minimum) in
// registers: 2048 points are 256 threads x 8 (two warps a scheduler, so
// that one warp's dependent distance chain hides behind the other's), 512
// are 128 x 4; few warps keep the per-warp work outside the pass and the
// barrier's width small. Thread t owns points [t P, (t + 1) P), so a lower
// lane or warp always holds lower indices and "first index on ties"
// becomes "lowest lane". A step:
// - the thread folds the last pick's distance into its P minima and takes
//   their first maximum and its coordinates by a tree of strict compares
//   (the left half keeps a tie), log2 P deep;
// - the warp takes the largest key (the minimum's bits: non-negative floats
//   order as unsigned integers) by __reduce_max_sync, and the lowest lane
//   holding it by __ballot_sync and __ffs; that lane writes its key and
//   (x, y, z, index) into its warp's slot, double-buffered by the step's
//   parity so that a warp that runs ahead never overwrites a slot still
//   being read;
// - one __syncthreads; then every thread reads the slots' keys (broadcast
//   16-byte loads: two at 8 warps) and keeps the first largest by a tree of
//   strict compares, and reads that slot's (x, y, z, index): no second warp
//   reduction, no second barrier, no lookup of the cloud.
// A padded point (past N) has coordinates 0 and minimum 0 for good, and an
// unused slot keeps key 0: each can only tie a valid point's key, and the
// valid point comes first. 8192 points (the ShapeNet-55 train crop's FPS,
// 64 clouds a step, up to 6144 of a cloud's points copies of one point)
// take 512 threads x 16. Past 8192 points (the KITTI test's 16384-point
// inputs; no card run drives them) the block has up to 1024 threads of 16
// points, 64 registers each, and the compiler spills some of them to local
// memory: there a step is slower than with the cloud in shared memory.
//
// Distances use __fsub_rn/__fmul_rn/__fadd_rn: no FMA contraction changes
// the rounding against the plain PyTorch version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_POINTS = 1024 * 16;
constexpr int MAX_WARPS = 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float sqdist(float ax, float ay, float az, float bx, float by,
                                        float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

template <int P, int MAX_T>
__global__ void __launch_bounds__(MAX_T)
    fps_kernel(const float* __restrict__ xyz, int64_t* __restrict__ out, int N, int npoint) {
  __shared__ __align__(16) unsigned s_key[2][MAX_WARPS];
  __shared__ float4 s_pick[2][MAX_WARPS];  // x, y, z, index bits

  const float* c = xyz + (int64_t)blockIdx.x * N * 3;
  int64_t* o = out + (int64_t)blockIdx.x * npoint;
  const int lane = threadIdx.x & 31;
  const int first = threadIdx.x * P;
  unsigned* const my_key = &s_key[0][threadIdx.x >> 5];  // this warp's slots
  float4* const my_pick = &s_pick[0][threadIdx.x >> 5];

  for (int i = threadIdx.x; i < 2 * MAX_WARPS; i += blockDim.x)
    s_key[i / MAX_WARPS][i % MAX_WARPS] = 0u;
  float x[P], y[P], z[P], md[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    x[j] = y[j] = z[j] = md[j] = 0.0f;
    if (first + j < N) {
      x[j] = c[3 * (first + j)];
      y[j] = c[3 * (first + j) + 1];
      z[j] = c[3 * (first + j) + 2];
      md[j] = 1e10f;
    }
  }
  float px = c[0], py = c[1], pz = c[2];
  if (threadIdx.x == 0) o[0] = 0;
  __syncthreads();  // unused slots hold key 0 and lose every tie

  for (int it = 1; it < npoint; ++it) {
    float v[P], bx[P], by[P], bz[P];
    int bj[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      md[j] = fminf(md[j], sqdist(x[j], y[j], z[j], px, py, pz));
      v[j] = md[j];
      bj[j] = j;
      bx[j] = x[j];
      by[j] = y[j];
      bz[j] = z[j];
    }
#pragma unroll
    for (int h = 1; h < P; h *= 2) {
#pragma unroll
      for (int j = 0; j + h < P; j += 2 * h) {
        const bool right = v[j + h] > v[j];  // strict: the lower index keeps a tie
        v[j] = right ? v[j + h] : v[j];
        bj[j] = right ? bj[j + h] : bj[j];
        bx[j] = right ? bx[j + h] : bx[j];
        by[j] = right ? by[j + h] : by[j];
        bz[j] = right ? bz[j + h] : bz[j];
      }
    }
    const unsigned key = __float_as_uint(v[0]);
    const int par = (it & 1) * MAX_WARPS;
    const unsigned top = __reduce_max_sync(FULL, key);
    if (lane == __ffs(__ballot_sync(FULL, key == top)) - 1) {
      my_key[par] = key;
      my_pick[par] = make_float4(bx[0], by[0], bz[0], __int_as_float(first + bj[0]));
    }
    __syncthreads();
    // the first largest of the block's slots (MAX_T / 32, the unused at 0)
    constexpr int SLOTS = MAX_T / 32;
    unsigned k[SLOTS];
    int w[SLOTS];
#pragma unroll
    for (int g = 0; g < SLOTS / 4; ++g) {
      const uint4 k4 = reinterpret_cast<const uint4*>(&s_key[0][0] + par)[g];
      k[4 * g] = k4.x;
      k[4 * g + 1] = k4.y;
      k[4 * g + 2] = k4.z;
      k[4 * g + 3] = k4.w;
    }
#pragma unroll
    for (int i = 0; i < SLOTS; ++i) w[i] = i;
#pragma unroll
    for (int h = 1; h < SLOTS; h *= 2) {
#pragma unroll
      for (int i = 0; i + h < SLOTS; i += 2 * h) {
        const bool right = k[i + h] > k[i];  // strict: the lower warp keeps a tie
        k[i] = right ? k[i + h] : k[i];
        w[i] = right ? w[i + h] : w[i];
      }
    }
    const float4 pick = (&s_pick[0][0])[par + w[0]];
    px = pick.x;
    py = pick.y;
    pz = pick.z;
    if (threadIdx.x == 0) o[it] = __float_as_int(pick.w);
  }
}

template <int P, int MAX_T>
cudaError_t launch(const float* xyz, int64_t* out, int64_t B, int64_t N, int64_t npoint,
                   cudaStream_t stream) {
  const int64_t threads = ((N + P - 1) / P + 31) / 32 * 32;
  fps_kernel<P, MAX_T><<<(unsigned)B, (unsigned)threads, 0, stream>>>(xyz, out, (int)N,
                                                                      (int)npoint);
  return cudaGetLastError();
}

}  // namespace

// Largest cloud a block holds: 1024 threads x 16 points.
extern "C" int64_t fps_max_points() { return MAX_POINTS; }

// xyz (B, N, 3) float32 -> out (B, npoint) int64. Requires 1 <= N <=
// fps_max_points() and npoint >= 1; the caller checks.
extern "C" int fps_f32(const float* xyz, int64_t* out, int64_t B, int64_t N, int64_t npoint,
                       void* stream) {
  if (B == 0 || npoint == 0) return 0;
  if (N < 1 || N > MAX_POINTS || npoint >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 512) return (int)launch<4, 128>(xyz, out, B, N, npoint, s);
  if (N <= 1024) return (int)launch<8, 128>(xyz, out, B, N, npoint, s);
  if (N <= 2048) return (int)launch<8, 256>(xyz, out, B, N, npoint, s);
  if (N <= 8192) return (int)launch<16, 512>(xyz, out, B, N, npoint, s);
  return (int)launch<16, 1024>(xyz, out, B, N, npoint, s);
}
