// Bidirectional nearest-neighbour argmin by the matmul-form distance of the
// opt-in eval chamfer (EVAL METRICS ONLY):
//     d~(n, m) = |x_n|^2 + |y_m|^2 - 2 * cross(x_n, y_m)
//     cross    = xh.yh + xh.yl + xl.yh
// where xh = bf16_rn(x), xl = bf16_rn(x - xh) per coordinate (the same for
// y) and |x|^2 = (x0*x0 + x1*x1) + x2*x2; i1[b, n] is the first m with the
// least d~(n, m), i2[b, m] the first n with the least d~(n, m).
//
// Replaces: imgadapointr_tpu/ops/pallas/nn_distance.py:nn_argmin_bidir_mxu
// (`_nn_bidir_mxu_kernel`, pallas_call at :318). The TPU kernel takes the
// cross term as three bf16 matrix products on the MXU with float32
// accumulation and carries the column minimum across its sequential grid;
// its 1e9 padding rows are a Mosaic tiling device, replaced here by +inf
// norms. The caller (ops/chamfer.py: nn_distance_eval) recomputes the
// distances exactly from the indices, so only the selection carries the
// form's cancellation band (about 2e-5 relative). Never for a training loss.
//
// All of d~ runs on the tensor cores. Each point is split once into one
// K = 16 bf16 operand: a row point as [xh, xh, xl, |x|^2 in three bf16
// parts, 1, 1, 1, 0], a column point as [-2yh, -2yl, -2yh, 1, 1, 1, |y|^2
// in three parts, 0]. Every part is exact (-2 scales a bf16 exactly, and
// three bf16 parts hold a float32), so one mma.sync.m16n8k16 with float32
// accumulation sums d~'s fifteen exact products for 16 x 8 pairs, in an
// order of its own: the kernel is held to its plain version (ops/chamfer.py:
// nn_argmin_bidir_mxu_plain) by the JAX package's band, not by its bits.
// Where every product and sum is exact in float32 (coordinates k/64 with
// |k| <= 64: then 4096 d~ is an integer below 2^16) the order cannot matter
// and the indices are the plain version's, ties included.
//
// Bound on the H100: operations. The products are cheap on the tensor
// cores; the pace is set by the selection on the CUDA cores, two issue
// slots a pair and direction. Design: one launch, both directions as two
// passes of one kernel (blockIdx.z parity), each ranking columns for its
// rows only: a second pass of tensor-core products costs less than
// reducing columns across lanes and warps in one pass.
// - A warp holds kR 16-row tiles as A fragments in registers; 4 warps make
//   a block. The other cloud streams through shared memory in tiles of
//   kTile columns, staged once per block as B fragments in lane order (one
//   8-byte load a lane per 8 columns). The grid splits the columns into
//   chunks to fill the card.
// - Selection: a lane sees 64 columns of a tile, two of every 8, in
//   increasing order. It keeps, for each of its rows, the least int of
//   (d~'s key with the low 6 bits replaced by the column's slot 0..63): the
//   least d~ truncated by 6 of its 24 bits (2^-18 relative, far inside the
//   band; lattice d~ keep their low 8 bits zero, so for them it is exact),
//   then the first column. The key is d~'s bits as an int that orders like
//   d~: a negative value (the form's cancellation near 0) by its magnitude,
//   -0 equal to +0. A pass over a tile first takes d~'s bits as they are,
//   one LOP3 and one IMNMX a pair, which order every d~ >= 0; where that
//   pass's least key of a row is negative, the warp scans that 16-row tile
//   again with the ordered key (a compare, a subtract and a select more a
//   pair).
//   The products are the same both times, so the result is that of the
//   ordered key throughout. A tile's winner joins the row's running best with a
//   strict <, so an equal key keeps the earlier tile.
// - Merge: the four lanes of a row by packed 64-bit keys (key bits, then
//   column) over shuffles, blocks by one 64-bit atomicMin a row. The keys
//   live in the int64 outputs: a launch sets them to all ones first, and
//   one after unpacks the indices in place.
// - Ragged edges: rows and columns past the end get an infinite norm, so
//   their d~ is +inf and never wins.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kR = 8;                      // 16-row tiles a warp
constexpr int kWarpRows = 16 * kR;
constexpr int kRows = kWarps * kWarpRows;  // rows a block
constexpr int kTile = 256;                 // columns staged in shared memory
constexpr int kSlotMask = 63;              // a lane's 64 columns of a tile
constexpr int kMinChunk = 512;             // least columns a block
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kOne = 0x3f80u;         // bf16 1.0

typedef unsigned long long u64;

__device__ __forceinline__ u64 min64(u64 a, u64 b) { return b < a ? b : a; }

__device__ __forceinline__ unsigned bf16_bits(float v) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// a point's hi and lo parts and its squared norm's three parts, as bf16 bits
struct Split {
  unsigned h0, h1, h2, l0, l1, l2, s0, s1, s2;
};

__device__ __forceinline__ Split split(float a, float b, float c) {
  Split s;
  s.h0 = bf16_bits(a);
  s.h1 = bf16_bits(b);
  s.h2 = bf16_bits(c);
  s.l0 = bf16_bits(__fsub_rn(a, __uint_as_float(s.h0 << 16)));
  s.l1 = bf16_bits(__fsub_rn(b, __uint_as_float(s.h1 << 16)));
  s.l2 = bf16_bits(__fsub_rn(c, __uint_as_float(s.h2 << 16)));
  const float sq = __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)), __fmul_rn(c, c));
  s.s0 = bf16_bits(sq);
  const float r = __fsub_rn(sq, __uint_as_float(s.s0 << 16));
  s.s1 = bf16_bits(r);
  s.s2 = bf16_bits(__fsub_rn(r, __uint_as_float(s.s1 << 16)));
  return s;
}

// a point past the end: zero coordinates and an infinite norm
__device__ __forceinline__ Split padding() { return {0, 0, 0, 0, 0, 0, 0x7f80u, 0, 0}; }

__device__ __forceinline__ unsigned neg2(unsigned h) {  // -2 h, exact
  return bf16_bits(-2.f * __uint_as_float(h << 16));
}

// the operand's k pair (2w, 2w + 1) as one register, the lower k in the
// low half: a row point [xh0 xh1 xh2 xh0 xh1 xh2 xl0 xl1 xl2 s0 s1 s2 1 1 1 0],
// a column point [-2(yh0 yh1 yh2 yl0 yl1 yl2 yh0 yh1 yh2) 1 1 1 s0 s1 s2 0]
__device__ __forceinline__ unsigned row_word(const Split& s, int w) {
  return w == 0 ? s.h0 | s.h1 << 16 : w == 1 ? s.h2 | s.h0 << 16
       : w == 2 ? s.h1 | s.h2 << 16 : w == 3 ? s.l0 | s.l1 << 16
       : w == 4 ? s.l2 | s.s0 << 16 : w == 5 ? s.s1 | s.s2 << 16
       : w == 6 ? kOne | kOne << 16 : kOne;
}
__device__ __forceinline__ unsigned col_word(const Split& s, int w) {
  return w == 0 ? neg2(s.h0) | neg2(s.h1) << 16 : w == 1 ? neg2(s.h2) | neg2(s.l0) << 16
       : w == 2 ? neg2(s.l1) | neg2(s.l2) << 16 : w == 3 ? neg2(s.h0) | neg2(s.h1) << 16
       : w == 4 ? neg2(s.h2) | kOne << 16 : w == 5 ? kOne | kOne << 16
       : w == 6 ? s.s0 | s.s1 << 16 : s.s2;
}

__device__ __forceinline__ void mma(const unsigned (&a)[4], uint2 b, float (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y), "f"(0.f));
}

// d~'s float bits as an int in d~'s order: a negative value by its
// magnitude, -0 equal to +0
__device__ __forceinline__ int ordered(int k) { return k < 0 ? INT_MIN - k : k; }

// Each of this lane's rows' least (key | slot) over its columns of one
// staged tile of n columns, for the 16-row tiles r set in `tiles` (the
// others keep tk). kOrdered false takes d~'s bits as the key, which orders
// d~ >= 0 only; true takes ordered(bits).
template <bool kOrdered>
__device__ __forceinline__ void scan_tile(const unsigned (&a)[kR][4], const uint2 (*frag)[32], int n,
                                          int lane, unsigned tiles, int (&tk)[kR][2]) {
#pragma unroll
  for (int r = 0; r < kR; ++r)
    if (tiles >> r & 1) tk[r][0] = tk[r][1] = INT_MAX;
  for (int j = 0; 8 * j < n; ++j) {
    const uint2 bf = frag[j][lane];
    float acc[kR][4];  // (row g, col 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
#pragma unroll
    for (int r = 0; r < kR; ++r)
      if (tiles >> r & 1) mma(a[r], bf, acc[r]);
#pragma unroll
    for (int r = 0; r < kR; ++r)
      if (tiles >> r & 1)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = kOrdered ? ordered(__float_as_int(acc[r][e])) : __float_as_int(acc[r][e]);
          tk[r][e >> 1] = min(tk[r][e >> 1], (k & ~kSlotMask) | (2 * j + (e & 1)));
        }
  }
}

// One direction per blockIdx.z parity: 0 ranks y for each x (rows x, keys
// k1, x in the row role), 1 ranks x for each y (rows y, keys k2, x in the
// column role). Each point keeps its role's layout, so both directions sum
// the same fifteen products of every pair.
__global__ void __launch_bounds__(kThreads, 4)
    nn_bidir_mxu_kernel(const float* __restrict__ x, const float* __restrict__ y,
                        u64* __restrict__ k1, u64* __restrict__ k2, int N,
                        int M, int chunk1, int chunk2) {
  __shared__ uint2 frag[kTile / 8][32];  // B fragments: 8-column tile, lane
  const int64_t b = blockIdx.z >> 1;
  const bool swap = blockIdx.z & 1;
  const int nP = swap ? M : N, nQ = swap ? N : M;
  const int chunk = swap ? chunk2 : chunk1;
  const float* p = swap ? y + b * M * 3 : x + b * N * 3;
  const float* q = swap ? x + b * N * 3 : y + b * M * 3;
  u64* keys = swap ? k2 + b * M : k1 + b * N;
  if ((int64_t)blockIdx.x * kRows >= nP || (int64_t)blockIdx.y * chunk >= nQ) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kRows + warp * kWarpRows;
  // this lane's rows: row0 + 16 r + 8 h + g, h = 0, 1
  unsigned a[kR][4];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 16 * r + 8 * h + g;
      const Split s = row < nP ? split(p[3 * row], p[3 * row + 1], p[3 * row + 2]) : padding();
      a[r][h] = swap ? col_word(s, t) : row_word(s, t);              // k = 2t, 2t + 1
      a[r][2 + h] = swap ? col_word(s, t + 4) : row_word(s, t + 4);  // k = 2t + 8, 2t + 9
    }
  }
  int rk[kR][2], rc[kR][2];  // each row's best so far: truncated key, column
#pragma unroll
  for (int r = 0; r < kR; ++r) rk[r][0] = rk[r][1] = INT_MAX, rc[r][0] = rc[r][1] = 0;
  const int cbeg = blockIdx.y * chunk;
  const int cend = min(nQ, cbeg + chunk);
  for (int base = cbeg; base < cend; base += kTile) {
    const int n = min(kTile, cend - base);
    __syncthreads();
    for (int c = threadIdx.x; c < kTile; c += kThreads) {
      const float* pc = q + (int64_t)(base + c) * 3;
      const Split s = c < n ? split(pc[0], pc[1], pc[2]) : padding();
      // column c is n-index c % 8 of its 8-column tile: lanes 4 (c % 8) + t hold it
      uint2* f = &frag[c >> 3][(c & 7) * 4];
#pragma unroll
      for (int w = 0; w < 4; ++w)
        f[w] = swap ? make_uint2(row_word(s, w), row_word(s, w + 4))
                    : make_uint2(col_word(s, w), col_word(s, w + 4));
    }
    __syncthreads();
    int tk[kR][2];  // this tile's least (key | slot) of each row
    scan_tile<false>(a, frag, n, lane, (1u << kR) - 1, tk);
    unsigned redo = 0;  // the 16-row tiles where some lane met a negative d~
#pragma unroll
    for (int r = 0; r < kR; ++r) redo |= (unsigned)__any_sync(kFull, tk[r][0] < 0 || tk[r][1] < 0) << r;
    if (redo) scan_tile<true>(a, frag, n, lane, redo, tk);
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = tk[r][h] & ~kSlotMask, slot = tk[r][h] & kSlotMask;
        const bool u = key < rk[r][h];
        rk[r][h] = u ? key : rk[r][h];
        rc[r][h] = u ? base + 8 * (slot >> 1) + 2 * t + (slot & 1) : rc[r][h];
      }
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // signed order as unsigned (sign bit flipped), then the column
      u64 k = ((u64)((unsigned)rk[r][h] ^ 0x80000000u) << 32) | (unsigned)rc[r][h];
      k = min64(k, __shfl_xor_sync(kFull, k, 1));
      k = min64(k, __shfl_xor_sync(kFull, k, 2));
      const int row = row0 + 16 * r + 8 * h + g;
      if (t == 0 && row < nP) atomicMin(keys + row, k);
    }
  }
}

// every key to all ones: no pick yet
__global__ void nn_bidir_mxu_init(u64* __restrict__ k1, int64_t n1, u64* __restrict__ k2, int64_t n2) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n1) k1[t] = ~0ull;
  else if (t < n1 + n2) k2[t - n1] = ~0ull;
}

// the packed keys' indices, in place: each word keeps its low 32 bits
__global__ void nn_bidir_mxu_unpack(u64* __restrict__ k1, int64_t n1,
                                    u64* __restrict__ k2, int64_t n2) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n1) k1[t] &= 0xffffffffull;
  else if (t < n1 + n2) k2[t - n1] &= 0xffffffffull;
}

// columns a block, so that the grid fills the card for about four waves
// (the resident blocks of the card are read once per device)
int column_chunk(int64_t row_blocks, int64_t cols) {
  static int resident[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  int& slots = resident[dev & 63];
  if (slots == 0) {
    int sms = 0, occ = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, nn_bidir_mxu_kernel, kThreads, 0);
    slots = (sms > 0 ? sms : 1) * (occ > 0 ? occ : 1);
  }
  const int64_t want = 4 * (int64_t)slots;
  int64_t chunks = (want + row_blocks - 1) / row_blocks;
  const int64_t most = (cols + kMinChunk - 1) / kMinChunk;
  if (chunks > most) chunks = most;
  if (chunks < 1) chunks = 1;
  const int64_t c = (cols + chunks - 1) / chunks;
  return (int)((c + 7) / 8 * 8);
}

}  // namespace

// x (B, N, 3), y (B, M, 3) float32 -> i1 (B, N), i2 (B, M) int64, which
// hold the packed keys until the unpack.
extern "C" int nn_bidir_mxu_f32(const float* x, const float* y, int64_t* i1,
                                int64_t* i2, int64_t B, int64_t N, int64_t M,
                                void* stream) {
  if (B == 0 || N == 0 || M == 0) return 0;
  if (B > 32767 || N > INT32_MAX || M > INT32_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  u64* k1 = reinterpret_cast<u64*>(i1);
  u64* k2 = reinterpret_cast<u64*>(i2);
  const int64_t total = B * (N + M);
  const unsigned blocks = (unsigned)((total + 255) / 256);
  nn_bidir_mxu_init<<<blocks, 256, 0, s>>>(k1, B * N, k2, B * M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t rb1 = (N + kRows - 1) / kRows, rb2 = (M + kRows - 1) / kRows;
  const int chunk1 = column_chunk(2 * rb1 * B, M), chunk2 = column_chunk(2 * rb2 * B, N);
  const int64_t cb1 = (M + chunk1 - 1) / chunk1, cb2 = (N + chunk2 - 1) / chunk2;
  const dim3 grid((unsigned)(rb1 > rb2 ? rb1 : rb2), (unsigned)(cb1 > cb2 ? cb1 : cb2),
                  (unsigned)(2 * B));
  nn_bidir_mxu_kernel<<<grid, kThreads, 0, s>>>(x, y, k1, k2, (int)N, (int)M, chunk1, chunk2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nn_bidir_mxu_unpack<<<blocks, 256, 0, s>>>(k1, B * N, k2, B * M);
  return (int)cudaGetLastError();
}
