// Auction top-2: for every live bidder row r of x (B, N, 3), over the items
// j < M of y (B, M, 3) with prices price (B, M),
//     v_j    = -(dx*dx + dy*dy + dz*dz) - price[b, j]
//     best   = max_j v_j
//     best_i = min { j : v_j == best }
//     second = max_{j != best_i} v_j
// Rows at or past cnt[b] (cnt (B,) int64; null: every row is live) are
// neither read nor written: the caller masks them.
//
// Replaces: imgadapointr_tpu/ops/pallas/auction.py:auction_top2_pallas
// (`_top2_kernel`, pallas_call at :161), the inner step of the EMD auction
// (imgadapointr_tpu/ops/emd.py:_auction_batch). The TPU kernel keeps a
// (128-row, 512-item) value tile in VMEM, reduces it with three lane
// reductions per chunk and merges the chunks; sub-blocks of 128 rows at or
// past the active count skip the sweep. The function above is well defined
// whatever the order of the reduction (max is exact, and the first index
// among equal maxima is one index), so a sequential scan with a strict >
// gives the same bits as the TPU's chunked merge and as the plain version.
// The value is formed with __fsub_rn / __fmul_rn / __fadd_rn in exactly the
// order above, so no multiply-add contraction changes its rounding.
//
// Bound on the H100: operations (per pair: 3 subtracts, 3 multiplies, 2
// adds, the negation-subtract of the price and two compares; the bytes are
// O(N + M)). Design: one thread per live bidder row keeps its running
// (best, best_i, second) in registers; the items stream through shared
// memory as float4 (x, y, z, price) tiles, one broadcast load per pair.
// Blocks of 128 rows: the 16384 bidders of the test protocol's first
// iteration make 128 blocks, about one per SM. Blocks wholly at or past
// cnt[b] return at once, so an iteration's cost follows its active count.
// This underfills the card once few bidders are active (a few blocks on
// 132 SMs); a warp per bidder, which splits the items across lanes and
// merges the lanes' top-2 with shuffles, is the next design.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int TILE = 1024;  // items staged per pass: 16 KB of shared memory
constexpr float NEG_BIG = -3.0e38f;  // the TPU kernel's initial value

__global__ void auction_top2_kernel(const float* __restrict__ x,
                                    const float* __restrict__ y,
                                    const float* __restrict__ price,
                                    const int64_t* __restrict__ cnt,
                                    float* __restrict__ best,
                                    float* __restrict__ second,
                                    int64_t* __restrict__ best_i, int64_t N,
                                    int64_t M) {
  __shared__ float4 tile[TILE];
  const int64_t b = blockIdx.y;
  int64_t live_rows = cnt ? cnt[b] : N;
  if (live_rows > N) live_rows = N;
  const int64_t row0 = (int64_t)blockIdx.x * THREADS;
  if (row0 >= live_rows) return;  // uniform over the block
  const int64_t r = row0 + threadIdx.x;
  const bool live = r < live_rows;
  float px = 0.0f, py = 0.0f, pz = 0.0f;
  if (live) {
    const float* p = x + (b * N + r) * 3;
    px = p[0];
    py = p[1];
    pz = p[2];
  }
  const float* yb = y + b * M * 3;
  const float* pb = price + b * M;
  float bv = NEG_BIG, sv = NEG_BIG;
  int64_t bi = 0;
  for (int64_t base = 0; base < M; base += TILE) {
    const int n = (int)(M - base < TILE ? M - base : TILE);
    __syncthreads();  // the previous tile is consumed
    for (int j = threadIdx.x; j < n; j += THREADS) {
      const float* q = yb + (base + j) * 3;
      tile[j] = make_float4(q[0], q[1], q[2], pb[base + j]);
    }
    __syncthreads();
    if (live) {
      for (int j = 0; j < n; ++j) {
        const float4 t = tile[j];
        const float dx = __fsub_rn(px, t.x);
        const float dy = __fsub_rn(py, t.y);
        const float dz = __fsub_rn(pz, t.z);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        const float v = __fsub_rn(-d, t.w);
        if (v > bv) {  // strict: the first index keeps a tie
          sv = bv;
          bv = v;
          bi = base + j;
        } else if (v > sv) {
          sv = v;
        }
      }
    }
  }
  if (live) {
    const int64_t o = b * N + r;
    best[o] = bv;
    second[o] = sv;
    best_i[o] = bi;
  }
}

}  // namespace

// x (B, N, 3), y (B, M, 3), price (B, M), cnt (B,) or null ->
// best, second (B, N) float32 and best_i (B, N) int64, live rows only.
extern "C" int auction_top2_f32(const float* x, const float* y,
                                const float* price, const int64_t* cnt,
                                float* best, float* second, int64_t* best_i,
                                int64_t B, int64_t N, int64_t M, void* stream) {
  if (B == 0 || N == 0 || M == 0) return 0;
  const dim3 grid((unsigned)((N + THREADS - 1) / THREADS), (unsigned)B);
  auction_top2_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, price, cnt, best, second, best_i, N, M);
  return (int)cudaGetLastError();
}
