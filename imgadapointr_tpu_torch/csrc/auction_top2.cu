// Auction top-2: for every live bidder row r of x (B, N, 3), over the items
// j < M of y (B, M, 3) with prices price (B, M),
//     v_j    = -(dx*dx + dy*dy + dz*dz) - price[b, j]
//     best   = max_j v_j
//     best_i = min { j : v_j == best }
//     second = max_{j != best_i} v_j   (the initial -3e38 when M == 1)
// Rows at or past cnt[b] (cnt (B,) int64; null: every row is live) are
// neither read nor written: the caller masks them.
//
// Replaces: imgadapointr_tpu/ops/pallas/auction.py:auction_top2_pallas
// (`_top2_kernel`, pallas_call at :161), the inner step of the EMD auction
// (imgadapointr_tpu/ops/emd.py:_auction_batch). The TPU kernel keeps a
// (128-row, 512-item) value tile in VMEM, reduces it with three lane
// reductions per chunk and merges the chunks in order; sub-blocks of 128
// rows at or past the active count skip the sweep. The value is formed
// with __fsub_rn / __fmul_rn / __fadd_rn in exactly the order above, so no
// multiply-add contraction changes its rounding.
//
// Bound on the H100: operations (per pair: 3 subtracts, 3 multiplies, 2
// adds, the price's subtract and a compare; the bytes are O(N + M)).
//
// Design. The caller compacts the live bidders to the front, so N is the
// iteration's live width, and the grid is (row tiles of N, item chunks, B):
// - a block takes ROWS = 512 bidder rows and one chunk of the items; a
//   thread keeps R = 4 consecutive bidders' (best, second, best_i) in
//   registers and reads each staged (x, y, z, price) float4 from shared
//   memory once for all four. The update has no branch:
//       best_i = v > best ? j : best_i
//       second = max(second, min(best, v))
//       best   = max(best, v)
//   which is the sequential `if (v > best) {second = best; best = v;
//   best_i = j} else if (v > second) second = v` (best >= second always
//   holds; at v == best the second becomes v, a tie). A pair costs the 9
//   pinned operations, 3 min/max, a compare and a select: about 15 issue
//   slots. A branch taken only when v > second would save 4, but the warp
//   takes it whenever any of its 128 bidders updates, which at item k of a
//   chunk happens with odds of about 256 / k: on most of a chunk of a few
//   hundred items, so the branch lost to this form on the card. Warps whose
//   rows are all past cnt[b] skip the sweep; blocks wholly past it return
//   at once.
// - auction_top2_chunks picks the number of chunks from the width, which
//   the wrapper reads before each launch, so that the grid holds about
//   BLOCKS_PER_SM blocks on each SM at every live count (16384 bidders: 32
//   row tiles x 33 chunks of 497 items; 1060: 3 x 349 chunks of 47);
// - with more than one chunk, each (row, chunk) writes its partial
//   (best, second, best_i) as one float4 into a scratch the wrapper
//   allocates, and a merge pass folds a row's chunks in chunk order with
//   the TPU kernel's rule (auction.py:98-102: upd = c1 > best; second =
//   upd ? max(best, c2) : max(second, c1); best_i = upd ? c1i : best_i).
//   The rule is the top-2 of the union with the first index among equal
//   maxima, so it is associative: a warp per row folds contiguous runs of
//   chunks per lane and then the lanes with a butterfly of ascending
//   offsets, which keeps every partial a contiguous run, the lower run
//   always on the left. Exact and deterministic; no atomics. Both
//   kernels count as one launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int R = 4;                 // bidders per thread
constexpr int ROWS = THREADS * R;    // bidder rows per block
constexpr int TILE = 1024;           // items staged per pass: 16 KB of shared memory
constexpr int MERGE_THREADS = 256;   // a warp per row
constexpr int64_t BLOCKS_PER_SM = 8; // the grid's aim
constexpr int64_t MIN_CHUNK = 32;    // fewest items per chunk
constexpr int64_t MAX_CHUNKS = 65535;
constexpr float NEG_BIG = -3.0e38f;  // the TPU kernel's initial value

__device__ __forceinline__ float bid_value(float px, float py, float pz, const float4& t) {
  const float dx = __fsub_rn(px, t.x);
  const float dy = __fsub_rn(py, t.y);
  const float dz = __fsub_rn(pz, t.z);
  const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  return __fsub_rn(-d, t.w);
}

// (b, s, i) holds the earlier items, (b2, s2, i2) the later ones.
__device__ __forceinline__ void merge(float& b, float& s, int& i, float b2, float s2, int i2) {
  if (b2 > b) {  // strict: the earlier items keep a tie
    s = fmaxf(b, s2);
    b = b2;
    i = i2;
  } else {
    s = fmaxf(s, b2);
  }
}

__global__ void __launch_bounds__(THREADS)
auction_top2_chunk_kernel(const float* __restrict__ x, const float* __restrict__ y,
                          const float* __restrict__ price, const int64_t* __restrict__ cnt,
                          float* __restrict__ best, float* __restrict__ second,
                          int64_t* __restrict__ best_i, float4* __restrict__ partial,
                          int64_t N, int64_t M, int64_t chunk, int64_t chunks) {
  __shared__ float4 tile[TILE];
  const int64_t b = blockIdx.z;
  int64_t live = cnt ? cnt[b] : N;
  if (live > N) live = N;
  const int64_t row0 = (int64_t)blockIdx.x * ROWS;
  if (row0 >= live) return;  // uniform over the block
  const int64_t r0 = row0 + (int64_t)threadIdx.x * R;  // this thread's R rows
  const bool warp_live = row0 + (int64_t)(threadIdx.x >> 5) * 32 * R < live;
  float px[R], py[R], pz[R], bv[R], sv[R];
  int bi[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    px[k] = py[k] = pz[k] = 0.0f;
    if (r0 + k < live) {
      const float* p = x + (b * N + r0 + k) * 3;
      px[k] = p[0];
      py[k] = p[1];
      pz[k] = p[2];
    }
    bv[k] = sv[k] = NEG_BIG;
    bi[k] = 0;
  }
  const float* yb = y + b * M * 3;
  const float* pb = price + b * M;
  const int64_t c0 = (int64_t)blockIdx.y * chunk;
  const int64_t c1 = c0 + chunk < M ? c0 + chunk : M;
  for (int64_t base = c0; base < c1; base += TILE) {
    const int n = (int)(c1 - base < TILE ? c1 - base : TILE);
    __syncthreads();  // the previous tile is consumed
    for (int j = threadIdx.x; j < n; j += THREADS) {
      const float* q = yb + (base + j) * 3;
      tile[j] = make_float4(q[0], q[1], q[2], pb[base + j]);
    }
    __syncthreads();
    if (!warp_live) continue;  // uniform over the warp
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float4 t = tile[j];
      const int jj = (int)(base + j);
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const float v = bid_value(px[k], py[k], pz[k], t);
        bi[k] = v > bv[k] ? jj : bi[k];  // strict: the first index keeps a tie
        sv[k] = fmaxf(sv[k], fminf(bv[k], v));
        bv[k] = fmaxf(bv[k], v);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int64_t r = r0 + k;
    if (r >= live) break;
    const int64_t o = b * N + r;
    if (partial) {
      partial[o * chunks + blockIdx.y] = make_float4(bv[k], sv[k], __int_as_float(bi[k]), 0.0f);
    } else {
      best[o] = bv[k];
      second[o] = sv[k];
      best_i[o] = bi[k];
    }
  }
}

__global__ void __launch_bounds__(MERGE_THREADS)
auction_top2_merge_kernel(const float4* __restrict__ partial, const int64_t* __restrict__ cnt,
                          float* __restrict__ best, float* __restrict__ second,
                          int64_t* __restrict__ best_i, int64_t N, int64_t chunks) {
  const int64_t b = blockIdx.y;
  int64_t live = cnt ? cnt[b] : N;
  if (live > N) live = N;
  const int64_t r = (int64_t)blockIdx.x * (MERGE_THREADS / 32) + (threadIdx.x >> 5);
  if (r >= live) return;  // uniform over the warp
  const int lane = threadIdx.x & 31;
  const int64_t per = (chunks + 31) / 32;
  const int64_t first = lane * per;
  const int64_t last = first + per < chunks ? first + per : chunks;
  // -inf is the identity of merge: every value is finite
  float bv = -INFINITY, sv = -INFINITY;
  int bi = 0;
  const float4* p = partial + (b * N + r) * chunks;
  for (int64_t c = first; c < last; ++c) {
    const float4 q = p[c];
    merge(bv, sv, bi, q.x, q.y, __float_as_int(q.z));
  }
  // ascending offsets: after the step of `off`, each aligned run of 2 off
  // lanes holds the merge of its contiguous chunks
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float b2 = __shfl_xor_sync(0xffffffffu, bv, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, sv, off);
    const int i2 = __shfl_xor_sync(0xffffffffu, bi, off);
    if (lane & off) {  // the partner holds the earlier chunks
      float lb = b2, ls = s2;
      int li = i2;
      merge(lb, ls, li, bv, sv, bi);
      bv = lb;
      sv = ls;
      bi = li;
    } else {
      merge(bv, sv, bi, b2, s2, i2);
    }
  }
  if (lane == 0) {
    const int64_t o = b * N + r;
    best[o] = bv;
    second[o] = sv;
    best_i[o] = bi;
  }
}

}  // namespace

// Item chunks for a live width of N rows on a card of `sms` SMs: enough
// that the grid (row tiles x chunks x B) holds about BLOCKS_PER_SM blocks
// on each SM, each chunk at least MIN_CHUNK items and none empty; 1 when
// there is nothing to do.
extern "C" int64_t auction_top2_chunks(int64_t B, int64_t N, int64_t M, int64_t sms) {
  const int64_t tiles = B * ((N + ROWS - 1) / ROWS);
  if (tiles == 0 || M == 0) return 1;
  int64_t chunks = (BLOCKS_PER_SM * sms + tiles - 1) / tiles;
  const int64_t most = (M + MIN_CHUNK - 1) / MIN_CHUNK;
  if (chunks > most) chunks = most;
  if (chunks > MAX_CHUNKS) chunks = MAX_CHUNKS;
  if (chunks < 1) chunks = 1;
  const int64_t size = (M + chunks - 1) / chunks;
  return (M + size - 1) / size;
}

// x (B, N, 3), y (B, M, 3), price (B, M), cnt (B,) or null ->
// best, second (B, N) float32 and best_i (B, N) int64, live rows only.
// chunks >= 1 item chunks of ceil(M / chunks) items, each non-empty (as
// auction_top2_chunks gives them); partial (B, N, chunks) float4 scratch
// when chunks > 1.
extern "C" int auction_top2_f32(const float* x, const float* y, const float* price,
                                const int64_t* cnt, float* best, float* second,
                                int64_t* best_i, void* partial, int64_t B, int64_t N,
                                int64_t M, int64_t chunks, void* stream) {
  if (B == 0 || N == 0 || M == 0) return 0;
  if (chunks < 1 || chunks > MAX_CHUNKS || M >= ((int64_t)1 << 31) || (chunks > 1 && !partial))
    return (int)cudaErrorInvalidValue;
  const int64_t chunk = (M + chunks - 1) / chunks;
  if ((chunks - 1) * chunk >= M) return (int)cudaErrorInvalidValue;  // an empty chunk
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float4* part = chunks > 1 ? static_cast<float4*>(partial) : nullptr;
  const dim3 grid((unsigned)((N + ROWS - 1) / ROWS), (unsigned)chunks, (unsigned)B);
  auction_top2_chunk_kernel<<<grid, THREADS, 0, s>>>(x, y, price, cnt, best, second, best_i,
                                                     part, N, M, chunk, chunks);
  if (chunks == 1) return (int)cudaGetLastError();
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  const int rows_per_block = MERGE_THREADS / 32;
  const dim3 mgrid((unsigned)((N + rows_per_block - 1) / rows_per_block), (unsigned)B);
  auction_top2_merge_kernel<<<mgrid, MERGE_THREADS, 0, s>>>(part, cnt, best, second, best_i, N,
                                                             chunks);
  return (int)cudaGetLastError();
}
