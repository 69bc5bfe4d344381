// k nearest neighbours by diff-form squared distance:
//     for each query q[b, s]: the k points of ref[b] with the smallest
//     (dx*dx + dy*dy) + dz*dz, ascending, ties broken by the lower index.
//
// Replaces: imgadapointr_tpu/ops/pallas/nn_distance.py:knn_pallas
// (`_knn_kernel`), which peels k minima out of a (TS, M) distance tile held
// in VMEM. Peeling re-reads the whole tile k times; here a warp keeps the k
// best candidates of one query and touches every candidate once.
//
// Bound on the H100: operations, and in practice issue slots. A pair costs
// the 8 pinned float operations and the test against the k-th best: with
// the tile load, the ballot and the loop about 10-13 issue slots a pair, on
// 132 SMs x 4 schedulers x 32 lanes. The inputs are a few hundred KB and
// stay in L2. An insertion into the k-list costs about 20 warp
// instructions, and a query takes about k (1 + ln(M / k)) of them (94 at
// k = 16, M = 2048), so at M = 2048 the insertions cost about as much as the
// distances.
//
// Design:
// - a warp per query; a block's 8 warps take 8 queries of one batch
//   element and share the reference tile in shared memory (1024 points as
//   float4). The lanes take the tile's candidates 32 at a time, in index
//   order, two such chunks a step behind one ballot;
// - the k-list is spread across the lanes, sorted by (distance, index): one
//   slot a lane for k <= 32, two for k <= 64 (entry e in slot e / 32 of
//   lane e % 32). A distance is kept as its bits: non-negative floats order
//   as unsigned integers, and the empty slot 0xffffffff comes after every
//   distance (NaN too, which the plain sort puts last). The list holds only
//   lower indices than the candidate at hand, so "before" is key <= key;
// - the threshold is entry k - 1, read from its lane by a shuffle. A chunk
//   of 32 candidates is one ballot of key < threshold, and a chunk in which
//   no lane beats it costs nothing more. The candidates that beat it go in
//   one by one, in lane (index) order, each rechecked against the threshold
//   the previous one left: the position is the __popc of a ballot of the
//   entries before it, and a __shfl_up_sync shifts the tail. No lane runs a
//   compare-and-swap chain. The first chunk, where nearly every candidate
//   would go in, starts the list by a bitonic sort across the lanes
//   (15 compare-exchange steps) instead;
// - where B * S warps leave the card under-filled (the denoise targets: 16
//   x 64 queries against 16384 points), knn_chunks splits M into chunks
//   across blocks, chosen here from B, S, M and the SM count. Each (query,
//   chunk) writes its k-list as (key, index) pairs, and knn_merge_kernel
//   folds a query's lists in chunk order through the same insertion: an
//   entry of a later chunk, or later in its chunk's list, ties with no
//   entry it follows, so the fold is the exact (distance, index) merge and
//   no order of the blocks changes the result. Both kernels count as one
//   launch.
//
// Distances are computed with __fsub_rn/__fmul_rn/__fadd_rn so that no FMA
// contraction changes the rounding against the plain PyTorch version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // queries per block
constexpr int THREADS = WARPS * 32;
constexpr int TILE = 1024;  // reference points staged per pass: 16 KB (a multiple of 64)
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned EMPTY = 0xffffffffu;  // the key of an empty slot
constexpr int64_t TARGET_WARPS_PER_SM = 32;
constexpr int64_t MIN_CHUNK = 2048;  // fewest reference points a chunk
constexpr int64_t MAX_CHUNKS = 65535;

__device__ __forceinline__ float sqdist(float ax, float ay, float az, float bx, float by,
                                        float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// A query's k-list, spread across the warp: entry e = s * 32 + lane in
// key[s], idx[s]; sorted over all 32 * SLOTS entries.
template <int SLOTS>
struct KList {
  unsigned key[SLOTS];
  int idx[SLOTS];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      key[s] = EMPTY;
      idx[s] = 0;
    }
  }

  // Entry e's key, in every lane.
  __device__ __forceinline__ unsigned key_at(int e) const {
    unsigned k = key[0];
#pragma unroll
    for (int s = 1; s < SLOTS; ++s) k = e >= 32 * s ? key[s] : k;
    return __shfl_sync(FULL, k, e & 31);
  }

  // Insert (ck, ci), which every lane holds and which no entry with the
  // same key follows: after the entries with key <= ck, the tail shifted
  // one place up.
  __device__ __forceinline__ void insert(unsigned ck, int ci, int lane) {
    int p = 0;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) p += __popc(__ballot_sync(FULL, key[s] <= ck));
    unsigned uk[SLOTS];
    int ui[SLOTS];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      uk[s] = __shfl_up_sync(FULL, key[s], 1);
      ui[s] = __shfl_up_sync(FULL, idx[s], 1);
      if (s > 0) {  // lane 0 takes the previous slot's last entry
        const unsigned tk = __shfl_sync(FULL, key[s > 0 ? s - 1 : 0], 31);
        const int ti = __shfl_sync(FULL, idx[s > 0 ? s - 1 : 0], 31);
        uk[s] = lane == 0 ? tk : uk[s];
        ui[s] = lane == 0 ? ti : ui[s];
      }
    }
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int e = s * 32 + lane;
      key[s] = e > p ? uk[s] : (e == p ? ck : key[s]);
      idx[s] = e > p ? ui[s] : (e == p ? ci : idx[s]);
    }
  }

  // Start the list from one chunk of 32 candidates, (key, index) a lane:
  // a bitonic sort across the lanes puts them in (key, index) order in
  // slot 0, the rest of the list empty.
  __device__ __forceinline__ void sort32(unsigned key_l, int idx_l, int lane) {
#pragma unroll
    for (int size = 2; size <= 32; size *= 2) {
#pragma unroll
      for (int stride = size / 2; stride > 0; stride /= 2) {
        const unsigned ok = __shfl_xor_sync(FULL, key_l, stride);
        const int oi = __shfl_xor_sync(FULL, idx_l, stride);
        const bool other_first = ok < key_l || (ok == key_l && oi < idx_l);
        // the lower lane of a pair keeps the first in an ascending run
        const bool lower_keeps_first = ((lane & stride) == 0) == ((lane & size) == 0);
        const bool take = lower_keeps_first ? other_first : !other_first;
        key_l = take ? ok : key_l;
        idx_l = take ? oi : idx_l;
      }
    }
    clear();
    key[0] = key_l;
    idx[0] = idx_l;
  }

  // Offer each lane's (key, index) in lane order: the lanes whose key
  // beats the threshold go in one at a time, each rechecked against the
  // threshold the previous insertion left. Returns the new threshold.
  __device__ __forceinline__ unsigned offer(unsigned key_l, int idx_l, unsigned thr, int k,
                                            int lane) {
    unsigned mask = __ballot_sync(FULL, key_l < thr);
    while (mask) {
      const int src = __ffs(mask) - 1;
      insert(__shfl_sync(FULL, key_l, src), __shfl_sync(FULL, idx_l, src), lane);
      thr = key_at(k - 1);
      mask = __ballot_sync(FULL, key_l < thr) & (0xfffffffeu << src);
    }
    return thr;
  }

  __device__ __forceinline__ void write(float* od, int64_t* oi, int k, int lane) const {
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int e = s * 32 + lane;
      if (e < k) {
        od[e] = __uint_as_float(key[s]);
        oi[e] = idx[s];
      }
    }
  }

  __device__ __forceinline__ void write(uint2* part, int k, int lane) const {
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int e = s * 32 + lane;
      if (e < k) part[e] = make_uint2(key[s], (unsigned)idx[s]);
    }
  }
};

// grid (ceil(S / WARPS), chunks, B): the block's warps take queries
// blockIdx.x * WARPS + warp against reference chunk blockIdx.y; with more
// than one chunk each writes its k-list into part (B, S, chunks, k).
template <int SLOTS>
__global__ void __launch_bounds__(THREADS)
    knn_kernel(const float* __restrict__ ref, const float* __restrict__ query,
               float* __restrict__ out_d, int64_t* __restrict__ out_i, uint2* __restrict__ part,
               int M, int S, int k, int chunk) {
  __shared__ float4 tile[TILE];
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const bool active = s < S;  // uniform over the warp
  const float* r = ref + (int64_t)b * M * 3;

  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (active) {
    const float* q = query + ((int64_t)b * S + s) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
  }
  KList<SLOTS> list;
  list.clear();
  unsigned thr = EMPTY;

  const int c0 = blockIdx.y * chunk;
  const int c1 = min(M, c0 + chunk);
  for (int base = c0; base < c1; base += TILE) {
    const int n = min(TILE, c1 - base);
    __syncthreads();  // the previous tile is consumed
    for (int t = threadIdx.x; t < n; t += THREADS) {
      const float* p = r + (int64_t)(base + t) * 3;
      tile[t] = make_float4(p[0], p[1], p[2], 0.0f);
    }
    __syncthreads();
    if (!active) continue;
    // two chunks of 32 a step; a slot at or past n (< TILE) is stale and
    // gets the empty key without a branch
    for (int j0 = 0; j0 < n; j0 += 64) {
      const int ja = j0 + lane, jb = ja + 32;
      const float4 pa = tile[ja], pb = tile[jb];
      const unsigned ka =
          __float_as_uint(sqdist(qx, qy, qz, pa.x, pa.y, pa.z)) | (ja < n ? 0u : EMPTY);
      const unsigned kb =
          __float_as_uint(sqdist(qx, qy, qz, pb.x, pb.y, pb.z)) | (jb < n ? 0u : EMPTY);
      if (base == c0 && j0 == 0) {  // the pass's first chunk: sorted, not inserted
        list.sort32(ka, base + ja, lane);
        thr = list.offer(kb, base + jb, list.key_at(k - 1), k, lane);
        continue;
      }
      if (!__any_sync(FULL, min(ka, kb) < thr)) continue;
      thr = list.offer(ka, base + ja, thr, k, lane);
      thr = list.offer(kb, base + jb, thr, k, lane);
    }
  }
  if (!active) return;
  const int64_t row = (int64_t)b * S + s;
  if (part) {
    list.write(part + (row * gridDim.y + blockIdx.y) * k, k, lane);
  } else {
    list.write(out_d + row * k, out_i + row * k, k, lane);
  }
}

// grid (ceil(S / WARPS), B): a warp per query folds its chunks' k-lists,
// in chunk order, into the final list.
template <int SLOTS>
__global__ void __launch_bounds__(THREADS)
    knn_merge_kernel(const uint2* __restrict__ part, float* __restrict__ out_d,
                     int64_t* __restrict__ out_i, int S, int k, int chunks) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (s >= S) return;  // uniform over the warp
  const int64_t row = (int64_t)blockIdx.y * S + s;
  const uint2* p = part + row * chunks * k;
  const int n = chunks * k;
  KList<SLOTS> list;
  list.clear();
  unsigned thr = EMPTY;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    const uint2 e = j < n ? p[j] : make_uint2(EMPTY, 0u);
    thr = list.offer(e.x, (int)e.y, thr, k, lane);
  }
  list.write(out_d + row * k, out_i + row * k, k, lane);
}

template <int SLOTS>
cudaError_t launch(const float* ref, const float* query, float* out_d, int64_t* out_i,
                   uint2* part, int64_t B, int64_t M, int64_t S, int64_t k, int64_t chunks,
                   cudaStream_t stream) {
  const int64_t chunk = (M + chunks - 1) / chunks;
  const unsigned rows = (unsigned)((S + WARPS - 1) / WARPS);
  knn_kernel<SLOTS><<<dim3(rows, (unsigned)chunks, (unsigned)B), THREADS, 0, stream>>>(
      ref, query, out_d, out_i, chunks > 1 ? part : nullptr, (int)M, (int)S, (int)k,
      (int)chunk);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess || chunks == 1) return rc;
  knn_merge_kernel<SLOTS><<<dim3(rows, (unsigned)B), THREADS, 0, stream>>>(
      part, out_d, out_i, (int)S, (int)k, (int)chunks);
  return cudaGetLastError();
}

}  // namespace

// Reference chunks for B x S queries against M points on a card of `sms`
// SMs: enough that the grid holds about TARGET_WARPS_PER_SM warps on each
// SM, each chunk at least MIN_CHUNK points; 1 when the queries fill the
// card or M is short.
extern "C" int64_t knn_chunks(int64_t B, int64_t S, int64_t M, int64_t sms) {
  const int64_t warps = B * S;
  if (warps == 0 || M == 0) return 1;
  int64_t chunks = (TARGET_WARPS_PER_SM * sms + warps - 1) / warps;
  const int64_t most = M / MIN_CHUNK;
  if (chunks > most) chunks = most;
  if (chunks > MAX_CHUNKS) chunks = MAX_CHUNKS;
  if (chunks < 1) chunks = 1;
  const int64_t size = (M + chunks - 1) / chunks;
  return (M + size - 1) / size;
}

// ref (B, M, 3), query (B, S, 3) float32; out_d (B, S, k) float32 and
// out_i (B, S, k) int64. Requires 1 <= k <= min(64, M); chunks >= 1
// reference chunks of ceil(M / chunks) points, each non-empty (as
// knn_chunks gives them); part (B, S, chunks, k) (key, index) pairs of
// scratch when chunks > 1.
extern "C" int knn_f32(const float* ref, const float* query, float* out_d, int64_t* out_i,
                       void* part, int64_t B, int64_t M, int64_t S, int64_t k, int64_t chunks,
                       void* stream) {
  if (B == 0 || S == 0) return 0;
  if (k < 1 || k > 64 || k > M || M >= ((int64_t)1 << 31) || B > 65535 || chunks < 1 ||
      chunks > MAX_CHUNKS || (chunks > 1 && !part))
    return (int)cudaErrorInvalidValue;
  const int64_t chunk = (M + chunks - 1) / chunks;
  if ((chunks - 1) * chunk >= M) return (int)cudaErrorInvalidValue;  // an empty chunk
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint2* p = static_cast<uint2*>(part);
  if (k <= 32) return (int)launch<1>(ref, query, out_d, out_i, p, B, M, S, k, chunks, s);
  return (int)launch<2>(ref, query, out_d, out_i, p, B, M, S, k, chunks, s);
}
