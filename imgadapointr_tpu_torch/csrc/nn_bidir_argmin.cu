// Bidirectional nearest-neighbour argmin by diff-form squared distance:
//     i1[b, n] = argmin_m |x[b, n] - y[b, m]|^2   (nearest y for every x)
//     i2[b, m] = argmin_n |y[b, m] - x[b, n]|^2   (nearest x for every y)
// with the first index winning ties in both directions.
//
// Replaces: imgadapointr_tpu/ops/pallas/nn_distance.py:nn_argmin_bidir_exact
// (`_nn_bidir_exact_kernel`). On the TPU one pass over the distance tiles
// served both directions because the sequential grid could carry the column
// minimum from one step to the next. Hopper's blocks run in no order, so
// here the column minima are merged across blocks by atomics instead.
//
// Selection precision is gradient quality (nn_distance.py:17-24): the
// distance is (dx*dx + dy*dy) + dz*dz, never in matmul form, with TF32 or
// on tensor cores, and __fsub_rn/__fmul_rn/__fadd_rn keep FMA contraction
// from changing the rounding against the plain PyTorch version. (q - r)^2
// and (r - q)^2 have the same bits, so one computed distance serves both
// directions.
//
// Bound on the H100: operations. B*N*M pairs, each about 10 operations
// (3 subtracts, 3 multiplies, 2 adds, one compare per direction); the
// clouds are a few MB and stay in L2. Design: one pass over the distances,
// tiled like a matrix product over the (min, argmin) semiring.
// - The larger cloud is the row side. Each thread holds kTQ rows in
//   registers with their running (min, argmin); the other cloud streams
//   through shared memory in tiles, one broadcast 16-byte load feeding kTQ
//   pairs. A block covers kRows rows and one chunk of the columns; the
//   grid splits the columns into enough chunks to fill the card.
// - Column minima: each thread reduces its kTQ rows for a column in
//   registers; a warp then reduces 32 columns at once with a
//   reduce-scatter over shuffles (lane l ends with column l), the block's
//   warps are merged in shared memory once per tile, and the block merges
//   its tile into global memory with one atomicMin per column.
// - Cross-block merge, both directions: a 64-bit atomicMin on
//   (float bits of d) << 32 | index. Non-negative floats order like their
//   bits, so this keeps the least distance and then the first index, in
//   any order of arrival: the result is deterministic. Every reduction
//   compares such (distance, index) pairs, or visits indices in increasing
//   order with a strict <, so ties go to the first index both ways.
// - The keys live in the int64 output itself (B*(N+M) words, allocated by
//   the caller): cudaMemsetAsync sets them to all ones, and a second kernel
//   of the same entry point unpacks each into its index in place.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTQ = 8;                      // rows a thread
constexpr int kRows = kThreads * kTQ;       // rows a block
constexpr int kTile = 512;                  // columns staged in shared memory
constexpr int kMinChunk = 256;              // least columns a block
constexpr unsigned kFull = 0xffffffffu;

typedef unsigned long long u64;

__device__ __forceinline__ u64 pack(float d, int i) {
  return ((u64)__float_as_uint(d) << 32) | (unsigned)i;
}

__device__ __forceinline__ u64 min64(u64 a, u64 b) { return b < a ? b : a; }

// One step of the warp's reduce-scatter of 32 packed column minima: each
// lane keeps the half of its H columns that its lane bit H selects and
// takes the other lane's minima for that half.
template <int H>
__device__ __forceinline__ void reduce_scatter_step(u64 (&v)[32], int lane) {
  const bool upper = lane & H;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const u64 send = upper ? v[k] : v[k + H];
    const u64 keep = upper ? v[k + H] : v[k];
    v[k] = min64(keep, __shfl_xor_sync(kFull, send, H));
  }
}

// rows p (nP, 3), columns q (nQ, 3) of one batch element; rkeys (nP) and
// ckeys (nQ) are the packed running minima, merged by atomicMin.
__global__ void __launch_bounds__(kThreads)
    nn_bidir_kernel(const float* __restrict__ p, const float* __restrict__ q,
                    u64* __restrict__ rkeys, u64* __restrict__ ckeys, int nP,
                    int nQ, int chunk) {
  __shared__ float4 tile[kTile];           // x, y, z, column index (as bits)
  __shared__ u64 part[kWarps][kTile];      // each warp's column minima
  const int64_t b = blockIdx.z;
  p += b * nP * 3;
  q += b * nQ * 3;
  rkeys += b * nP;
  ckeys += b * nQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // this thread's rows: row0 + 32 * t for t < kTQ, increasing with t; a
  // row past the end repeats the last row (same index, so it changes no
  // column minimum) and reports nothing
  const int row0 = blockIdx.x * kRows + warp * 32 * kTQ + lane;
  float px[kTQ], py[kTQ], pz[kTQ], rbest[kTQ];
  int ridx[kTQ];
#pragma unroll
  for (int t = 0; t < kTQ; ++t) {
    const int r = min(row0 + 32 * t, nP - 1);
    px[t] = p[3 * r];
    py[t] = p[3 * r + 1];
    pz[t] = p[3 * r + 2];
    rbest[t] = INFINITY;
    ridx[t] = 0;
  }
  const int cbeg = blockIdx.y * chunk;
  const int cend = min(nQ, cbeg + chunk);
  for (int base = cbeg; base < cend; base += kTile) {
    const int n = min(kTile, cend - base);
    __syncthreads();
    // slots past the end repeat the last column with its own index
    for (int s = threadIdx.x; s < kTile; s += kThreads) {
      const int c = base + min(s, n - 1);
      tile[s] = make_float4(q[3 * c], q[3 * c + 1], q[3 * c + 2], __int_as_float(c));
    }
    __syncthreads();
    for (int j0 = 0; j0 < n; j0 += 32) {
      u64 v[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float4 c = tile[j0 + j];
        float cbest = 0.f;
        int ct = 0;
#pragma unroll
        for (int t = 0; t < kTQ; ++t) {
          const float dx = __fsub_rn(px[t], c.x);
          const float dy = __fsub_rn(py[t], c.y);
          const float dz = __fsub_rn(pz[t], c.z);
          const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                    __fmul_rn(dz, dz));
          if (d < rbest[t]) {  // columns arrive in increasing index
            rbest[t] = d;
            ridx[t] = __float_as_int(c.w);
          }
          if (t == 0 || d < cbest) {  // rows in increasing index
            cbest = d;
            ct = t;
          }
        }
        v[j] = pack(cbest, min(row0 + 32 * ct, nP - 1));
      }
      reduce_scatter_step<16>(v, lane);
      reduce_scatter_step<8>(v, lane);
      reduce_scatter_step<4>(v, lane);
      reduce_scatter_step<2>(v, lane);
      reduce_scatter_step<1>(v, lane);
      part[warp][j0 + lane] = v[0];  // column j0 + lane
    }
    __syncthreads();
    for (int s = threadIdx.x; s < n; s += kThreads) {
      u64 k = part[0][s];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) k = min64(k, part[w][s]);
      atomicMin(ckeys + base + s, k);
    }
  }
#pragma unroll
  for (int t = 0; t < kTQ; ++t) {
    const int r = row0 + 32 * t;
    if (r < nP) atomicMin(rkeys + r, pack(rbest[t], ridx[t]));
  }
}

// the packed keys' indices, in place: each word keeps its low 32 bits
__global__ void nn_bidir_kernel_unpack(u64* __restrict__ keys, int64_t n) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) keys[t] &= 0xffffffffull;
}

// columns a block, so that the grid fills the card for about eight waves
// (the resident blocks of the card are read once per device)
int column_chunk(int64_t row_blocks, int64_t nQ) {
  static int resident[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  int& slots = resident[dev & 63];
  if (slots == 0) {
    int sms = 0, occ = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, nn_bidir_kernel, kThreads, 0);
    slots = (sms > 0 ? sms : 1) * (occ > 0 ? occ : 1);
  }
  const int64_t want = 8 * (int64_t)slots;
  int64_t chunks = (want + row_blocks - 1) / row_blocks;
  const int64_t most = (nQ + kMinChunk - 1) / kMinChunk;
  if (chunks > most) chunks = most;
  if (chunks < 1) chunks = 1;
  const int64_t c = (nQ + chunks - 1) / chunks;
  return (int)((c + 31) / 32 * 32);
}

}  // namespace

// x (B, N, 3), y (B, M, 3) float32 -> out (B * (N + M)) int64: i1 (B, N)
// then i2 (B, M). out holds the packed keys until the unpack.
extern "C" int nn_bidir_argmin_f32(const float* x, const float* y, int64_t* out,
                                   int64_t B, int64_t N, int64_t M,
                                   void* stream) {
  if (B == 0 || N == 0 || M == 0) return 0;
  if (B > 65535 || N > INT32_MAX || M > INT32_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  u64* kx = reinterpret_cast<u64*>(out);  // keys of x's rows (i1)
  u64* ky = kx + B * N;                   // keys of y's rows (i2)
  const int64_t total = B * (N + M);
  cudaError_t err = cudaMemsetAsync(kx, 0xff, (size_t)total * sizeof(u64), s);
  if (err != cudaSuccess) return (int)err;
  // the larger cloud is the row side
  const bool x_rows = N >= M;
  const int64_t nP = x_rows ? N : M, nQ = x_rows ? M : N;
  const int64_t row_blocks = (nP + kRows - 1) / kRows;
  const int chunk = column_chunk(row_blocks * B, nQ);
  const dim3 grid((unsigned)row_blocks, (unsigned)((nQ + chunk - 1) / chunk), (unsigned)B);
  nn_bidir_kernel<<<grid, kThreads, 0, s>>>(
      x_rows ? x : y, x_rows ? y : x, x_rows ? kx : ky, x_rows ? ky : kx,
      (int)nP, (int)nQ, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nn_bidir_kernel_unpack<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(kx, total);
  return (int)cudaGetLastError();
}
