// One-direction nearest-neighbour argmin by diff-form squared distance:
//     idx[b, n] = argmin over valid m of |x[b, n] - y[b, m]|^2
// with the first index winning ties and an optional (B, M) validity mask
// on y (valid where > 0): an invalid y never wins, and a row with no valid
// y (or whose every distance is +inf or NaN) gets index 0.
//
// Replaces: imgadapointr_tpu/ops/pallas/nn_distance.py:nn_one_direction_pallas
// (`_nn_kernel`) and, for masked clouds, the scan it falls back to
// (imgadapointr_tpu/ops/chamfer.py:147-182, `jnp.where(wt > 0, d, inf)`).
// The chamfer distance takes this path whenever the bidirectional kernel
// does not apply: a validity mask (the PCN test protocol's two calls a
// cloud at batch size 1, 16384 x 16384) or a cloud above 2^18 points.
// Callers recompute the distance from the index, so only the index is
// returned.
//
// Selection precision is gradient quality
// (imgadapointr_tpu/ops/pallas/nn_distance.py:17-24): the distance is
// (dx*dx + dy*dy) + dz*dz in float32, never in matmul form, with TF32 or on
// tensor cores, and __fsub_rn/__fmul_rn/__fadd_rn keep FMA contraction from
// changing the rounding against the plain PyTorch version. These are
// nn_bidir_argmin.cu's distance bits and tie rule, so unmasked both kernels
// select the same index.
//
// Bound on the H100: operations. B*N*M pairs, each 9 operations (3
// subtracts, 3 multiplies, 2 adds, one compare); the clouds are a few MB.
// Design: the row half of nn_bidir_argmin.cu.
// - Each thread holds kTQ query rows in registers with their running
//   (min, argmin); the candidates stream through shared memory in tiles of
//   float4 (x, y, z, index as bits), one broadcast 16-byte load feeding kTQ
//   pairs. The mask costs nothing a pair: an invalid candidate's
//   coordinates are NaN in the tile, so its distance is NaN and never wins.
// - The running minimum is the distance's bits as an unsigned int (a
//   distance is +0 or positive, so its bits order like the float; +inf and
//   every NaN lie at or above the starting +inf and never win), kept by one
//   min-with-predicate (__vibmin_u32, a DPX instruction of sm_90) and one
//   select of the index: 10 issue slots a pair with the 8 float operations.
//   The first candidate wins a tie: the old minimum is kept when equal.
// - A block covers kRows rows and one chunk of the candidates; the grid
//   splits the candidates into enough chunks that B x row blocks x chunks
//   fills the card (at B = 1, N = M = 16384: 8 row blocks x 64 chunks of
//   256). The chunks merge by a 64-bit atomicMin on
//   (distance bits) << 32 | index, which keeps the least distance and then
//   the first index in any order of arrival: the result is deterministic.
//   The keys live in the int64 output, which a first kernel sets to all
//   ones and a last one unpacks in place (a key still all ones had no
//   winner: index 0). Where the rows alone fill the card (large B, the
//   chamfer above 2^18 points) there is one chunk, and the block writes
//   its indices directly.
// Point indices are ints and element offsets int64: clouds of up to 2^30
// points.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTQ = 8;                  // rows a thread
constexpr int kRows = kThreads * kTQ;   // rows a block
constexpr int kTile = 512;              // candidates staged in shared memory
constexpr int kMinChunk = 256;          // least candidates a block
constexpr int kUnroll = 8;              // candidates a step of the inner loop
constexpr unsigned kInfBits = 0x7f800000u;
constexpr int64_t kMaxPoints = int64_t(1) << 30;

typedef unsigned long long u64;

// x (N, 3) rows and y (M, 3) candidates of one batch element, wy (M) or
// null; kDirect: out is the (N) int64 index, else the packed keys, merged
// by atomicMin.
template <bool kMasked, bool kDirect>
__global__ void __launch_bounds__(kThreads)
    nn_one_direction_kernel(const float* __restrict__ x, const float* __restrict__ y,
                            const float* __restrict__ wy, u64* __restrict__ out, int N, int M,
                            int chunk) {
  __shared__ float4 tile[kTile];
  const int64_t b = blockIdx.z;
  x += b * N * 3;
  y += b * M * 3;
  if (kMasked) wy += b * M;
  out += b * N;
  // this thread's rows row0 + kThreads t; a row past the end repeats the
  // last row and reports nothing
  const int row0 = blockIdx.x * kRows + threadIdx.x;
  float qx[kTQ], qy[kTQ], qz[kTQ];
  unsigned best[kTQ];
  int bi[kTQ];
#pragma unroll
  for (int t = 0; t < kTQ; ++t) {
    const int r = min(row0 + kThreads * t, N - 1);
    qx[t] = x[3 * (int64_t)r];
    qy[t] = x[3 * (int64_t)r + 1];
    qz[t] = x[3 * (int64_t)r + 2];
    best[t] = kInfBits;
    bi[t] = 0;
  }
  const int cbeg = blockIdx.y * chunk;
  const int cend = min(M, cbeg + chunk);
  for (int base = cbeg; base < cend; base += kTile) {
    const int n = min(kTile, cend - base);
    const int steps = (n + kUnroll - 1) / kUnroll;
    __syncthreads();
    // an invalid candidate, and the slots past the end up to the step, are NaN
    for (int s = threadIdx.x; s < steps * kUnroll; s += kThreads) {
      const int c = base + s;
      float4 v = make_float4(NAN, NAN, NAN, __int_as_float(c));
      if (s < n && (!kMasked || wy[c] > 0.f)) {
        v.x = y[3 * (int64_t)c];
        v.y = y[3 * (int64_t)c + 1];
        v.z = y[3 * (int64_t)c + 2];
      }
      tile[s] = v;
    }
    __syncthreads();
    for (int j0 = 0; j0 < steps * kUnroll; j0 += kUnroll) {
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const float4 c = tile[j0 + j];
#pragma unroll
        for (int t = 0; t < kTQ; ++t) {
          const float dx = __fsub_rn(qx[t], c.x);
          const float dy = __fsub_rn(qy[t], c.y);
          const float dz = __fsub_rn(qz[t], c.z);
          const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                    __fmul_rn(dz, dz));
          bool keep;  // the old minimum is kept when it is not above d
          best[t] = __vibmin_u32(best[t], __float_as_uint(d), &keep);
          bi[t] = keep ? bi[t] : __float_as_int(c.w);
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kTQ; ++t) {
    const int r = row0 + kThreads * t;
    if (r >= N) continue;
    if (kDirect) {
      out[r] = (u64)bi[t];  // 0 where nothing won
    } else if (best[t] < kInfBits) {
      atomicMin(out + r, ((u64)best[t] << 32) | (unsigned)bi[t]);
    }
  }
}

// every key all ones: no distance yet
__global__ void nn_one_direction_init(u64* __restrict__ keys, int64_t n) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) keys[t] = ~0ull;
}

// the packed keys' indices, in place: a key still all ones had no winner
__global__ void nn_one_direction_unpack(u64* __restrict__ keys, int64_t n) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) {
    const u64 k = keys[t];
    keys[t] = k == ~0ull ? 0 : k & 0xffffffffull;
  }
}

// candidates a block: enough chunks that the grid fills the card for about
// two waves, at least kMinChunk candidates each, a multiple of kUnroll
// (the resident blocks of the card are read once per device)
int candidate_chunk(int64_t row_blocks, int64_t M) {
  static int resident[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  int& slots = resident[dev & 63];
  if (slots == 0) {
    int sms = 0, occ = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, nn_one_direction_kernel<true, false>,
                                                  kThreads, 0);
    slots = (sms > 0 ? sms : 1) * (occ > 0 ? occ : 1);
  }
  const int64_t want = 2 * (int64_t)slots;
  int64_t chunks = (want + row_blocks - 1) / row_blocks;
  const int64_t most = (M + kMinChunk - 1) / kMinChunk;
  if (chunks > most) chunks = most;
  if (chunks < 1) chunks = 1;
  const int64_t c = (M + chunks - 1) / chunks;
  return (int)((c + kUnroll - 1) / kUnroll * kUnroll);
}

template <bool kMasked>
cudaError_t launch(const float* x, const float* y, const float* wy, u64* out, int64_t B,
                   int64_t N, int64_t M, cudaStream_t s) {
  const int64_t row_blocks = (N + kRows - 1) / kRows;
  const int chunk = candidate_chunk(row_blocks * B, M);
  const int64_t chunks = (M + chunk - 1) / chunk;
  const dim3 grid((unsigned)row_blocks, (unsigned)chunks, (unsigned)B);
  if (chunks == 1) {
    nn_one_direction_kernel<kMasked, true><<<grid, kThreads, 0, s>>>(x, y, wy, out, (int)N,
                                                                     (int)M, chunk);
    return cudaGetLastError();
  }
  const int64_t total = B * N;
  const unsigned flat = (unsigned)((total + 255) / 256);
  nn_one_direction_init<<<flat, 256, 0, s>>>(out, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  nn_one_direction_kernel<kMasked, false><<<grid, kThreads, 0, s>>>(x, y, wy, out, (int)N, (int)M,
                                                                    chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  nn_one_direction_unpack<<<flat, 256, 0, s>>>(out, total);
  return cudaGetLastError();
}

}  // namespace

// x (B, N, 3), y (B, M, 3) float32, wy (B, M) float32 or null -> idx (B, N)
// int64 (which holds the packed keys until the unpack).
extern "C" int nn_one_direction_f32(const float* x, const float* y,
                                    const float* wy, int64_t* idx, int64_t B,
                                    int64_t N, int64_t M, void* stream) {
  if (B == 0 || N == 0 || M == 0) return 0;
  if (B > 65535 || N > kMaxPoints || M > kMaxPoints)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  u64* out = reinterpret_cast<u64*>(idx);
  return (int)(wy != nullptr ? launch<true>(x, y, wy, out, B, N, M, s)
                             : launch<false>(x, y, nullptr, out, B, N, M, s));
}
