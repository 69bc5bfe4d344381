// Fused inverse-distance 3-NN interpolation, grouped:
//     for each batch element b, channel group j < G and query s, the query
//     u = pos[b, s] + offset[b, j, s] (one correctly rounded add; u =
//     pos[b, s] where there is no offset), the 3 points of known[b] with the
//     smallest (dx*dx + dy*dy) + dz*dz (ascending, ties to the lower index),
//     r_t = 1 / (sqrt(d_t) + eps), w_t = r_t / ((r_0 + r_1) + r_2), and
//     out[b, s, j cg : (j + 1) cg] =
//         ((w_0 v[b, i_0, slice] + w_1 v[b, i_1, slice]) + w_2 v[b, i_2, slice])
// with pos (B, S, 3), offset (B, G, S, 3) or none, known (B, M, 3), v
// (B, M, C) float32 and cg = C / G; idx (B, G, S, 3) int64 and w (B, G, S,
// 3) float32 are written for the backward. G = 1 without an offset is the
// plain fused op (unknown = pos, feats = v).
//
// Replaces: imgadapointr_tpu/ops/pallas/nn_distance.py:
// three_nn_interpolate_pallas (`_three_interp_kernel`, pallas_call at
// :451), and in the deformable gather the layout copies around it
// (imgadapointr_tpu/nn/local_attention.py:80-88: the shifted positions,
// one copy of the value positions a group, the values in group-major order
// and the result permuted back). The TPU kernel holds a (TS, M) distance
// tile in VMEM, peels the 3 minima with three full passes and emits the sum
// as one matrix product of the (TS, M) sparse weight rows with the whole
// feature table, because the TPU has no gather. A Hopper thread can read
// any row, so nothing of that survives: no weight matrix, no product, just
// three row reads a query and channel slice, read and written in the
// model's own (B, S, C) layout.
//
// Bound on the H100: bytes. The (B, S, C) output is almost all of them (50
// MB for one decoder call at batch 8); the value table (a few hundred KB a
// batch element, read three times a query) is read from L1 and L2, and the
// output is stored with the streaming hint so that it does not evict the
// table from L2. Design:
// - A block takes one (b, j) and a range of queries; it copies known[b]
//   into shared memory once, as float4 (8 KB at M = 512; past kSharedPoints
//   points the scan reads it from global memory instead), and that is its
//   only barrier. Two blocks of 8 warps an SM.
// - Each warp then takes units of 16 queries in turn, with no barrier, so
//   warps run at their own phases: the 2 lanes of a query scan every other
//   known point in index order, keeping their 3 best (distance, index) in
//   registers (a strict compare, the list's moves by selects); one shuffle
//   step merges the two lists (top 3 of a union by distance, then index);
//   the weights follow; and the warp writes the unit's 16 output rows of
//   group j: each lane takes (row, chunk) elements of the rows' slices, 16
//   bytes each, takes its row's indices and weights from the row's lanes by
//   shuffle, and has kUnroll elements' three row reads in flight before
//   their stores. A slice of a row is one run of 16-byte stores.
// What holds it (timed on the H100 against throwaway variants): the
// search. Its issue slots a pair (the 8 pinned float operations, the select
// insertion, the shared-memory read and the loop: several times the float
// operations) over the 130 M pairs of a deformable request's 8 calls take
// about as long as the writes alone, and the kernel stayed about as slow
// with its table reads taken out, so interleaving one unit's search with
// another's writes cannot hide it. One lane a query left each warp's
// insertion chain latency-bound (too few warps at these query counts); 4 or
// 8 lanes a query made some lane insert in almost every step, so the warp
// took the insertion path on every candidate; a block an SM with the slice
// in L1, a write that walks the table in channel slabs, a separate search
// kernel, and distances taken four at a time before their insertions were
// no faster than this layout.
// Where cg % 4 != 0 or a pointer is not 16-byte aligned the elements are
// single floats.
//
// Every rounding step is an explicit _rn intrinsic (no FMA contraction, a
// correctly rounded sqrt and divide), in the plain PyTorch version's order
// (ops/pointops.py: three_nn_interpolate_plain and
// three_nn_interpolate_grouped_plain), so idx is equal and w and out are
// bit-equal to it on the same inputs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kLanesQuery = 2;                   // lanes that split one query's scan
constexpr int kQueries = 32 / kLanesQuery;       // queries a unit (a warp step)
constexpr int kUnroll = 4;                       // output elements a lane has in flight
constexpr int kSharedPoints = 3072;              // 48 KB of float4
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sqdist(float ax, float ay, float az, float bx,
                                        float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ bool before(float d0, int i0, float d1, int i1) {
  return d0 < d1 || (d0 == d1 && i0 < i1);
}

// (cd, ci) into the sorted 3-list (bd, bi) where it belongs, for a scan in
// increasing index order (a later candidate never wins a tie, so a strict
// compare decides); the list's moves are selects, not branches. A NaN
// distance never enters.
__device__ __forceinline__ void insert_in_order(float (&bd)[3], int (&bi)[3], float cd, int ci) {
  if (cd < bd[2]) {
    const bool c1 = cd < bd[1], c0 = cd < bd[0];
    bd[2] = c1 ? bd[1] : cd;
    bi[2] = c1 ? bi[1] : ci;
    bd[1] = c0 ? bd[0] : (c1 ? cd : bd[1]);
    bi[1] = c0 ? bi[0] : (c1 ? ci : bi[1]);
    bd[0] = c0 ? cd : bd[0];
    bi[0] = c0 ? ci : bi[0];
  }
}

// (cd, ci) into the sorted 3-list (bd, bi) where it belongs, by distance
// and then index (the merge of two lanes' lists); an empty slot is (inf,
// INT_MAX), and a NaN distance never enters
__device__ __forceinline__ void insert(float (&bd)[3], int (&bi)[3], float cd, int ci) {
  if (!before(cd, ci, bd[2], bi[2])) return;
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    if (before(cd, ci, bd[t], bi[t])) {
      const float td = bd[t];
      const int ti = bi[t];
      bd[t] = cd;
      bi[t] = ci;
      cd = td;
      ci = ti;
    }
  }
}

__device__ __forceinline__ float mix(float w0, float a, float w1, float b,
                                     float w2, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b)),
                   __fmul_rn(w2, c));
}
__device__ __forceinline__ float4 mix(float w0, const float4& a, float w1, const float4& b,
                                      float w2, const float4& c) {
  return make_float4(mix(w0, a.x, w1, b.x, w2, c.x), mix(w0, a.y, w1, b.y, w2, c.y),
                     mix(w0, a.z, w1, b.z, w2, c.z), mix(w0, a.w, w1, b.w, w2, c.w));
}

template <typename T>
__device__ __forceinline__ T pick3(int t, T a, T b, T c) {
  return t == 0 ? a : (t == 1 ? b : c);
}

// kShared: known[b] in dynamic shared memory (M <= kSharedPoints), else
// read from global memory. V = 4: 16-byte elements (cg % 4 == 0 and aligned
// pointers), V = 1: floats. per_block: queries a block, a multiple of
// kQueries * kWarps.
template <bool kShared, int V>
__global__ void __launch_bounds__(kThreads, 2)
    three_nn_interp_kernel(const float* __restrict__ pos, const float* __restrict__ offset,
                           const float* __restrict__ known, const float* __restrict__ feats,
                           float* __restrict__ out, int64_t* __restrict__ out_i,
                           float* __restrict__ out_w, int S, int M, int C, int G,
                           int per_block, float eps) {
  typedef typename std::conditional<V == 4, float4, float>::type T;
  extern __shared__ float4 tile[];
  const int bg = blockIdx.y, b = bg / G, j = bg - b * G;
  const int cg = C / G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* kp = known + (int64_t)b * M * 3;
  if (kShared) {
    for (int t = threadIdx.x; t < M; t += kThreads)
      tile[t] = make_float4(kp[3 * t], kp[3 * t + 1], kp[3 * t + 2], 0.f);
    __syncthreads();  // the block's only barrier
  }
  const int s_lo = blockIdx.x * per_block, s_hi = min(S, s_lo + per_block);
  const int q = lane / kLanesQuery, part = lane % kLanesQuery;
  const int nc = cg / V, ne = kQueries * nc;  // elements of a row's slice, of a unit
  // e / nc as a high product: exact while e nc < 2^32 (e < kQueries nc, nc < 2^14)
  const unsigned ncm = nc > 1 ? 0xffffffffu / nc + 1 : 0;
  const int ld = C / V;                       // a row of v and of out, in elements
  const T* vb = reinterpret_cast<const T*>(feats + (int64_t)b * M * C + (int64_t)j * cg);
  T* ob = reinterpret_cast<T*>(out + (int64_t)j * cg);

  for (int s0 = s_lo + warp * kQueries; s0 < s_hi; s0 += kWarps * kQueries) {
    // ---- search: this lane's share of query s's candidates
    const int s = s0 + q;
    const bool active = s < s_hi;
    float bd[3] = {INFINITY, INFINITY, INFINITY};
    int bi[3] = {0x7fffffff, 0x7fffffff, 0x7fffffff};
    if (active) {
      const int64_t pi = ((int64_t)b * S + s) * 3;
      float qx = pos[pi], qy = pos[pi + 1], qz = pos[pi + 2];
      if (offset != nullptr) {
        const int64_t oi = ((int64_t)bg * S + s) * 3;
        qx = __fadd_rn(qx, offset[oi]);
        qy = __fadd_rn(qy, offset[oi + 1]);
        qz = __fadd_rn(qz, offset[oi + 2]);
      }
#pragma unroll 4
      for (int m = part; m < M; m += kLanesQuery) {
        const float4 p = kShared ? tile[m] : make_float4(kp[3 * m], kp[3 * m + 1], kp[3 * m + 2], 0.f);
        insert_in_order(bd, bi, sqdist(qx, qy, qz, p.x, p.y, p.z), m);
      }
    }
    // ---- merge the query's lists: every lane of the query ends with the top 3
#pragma unroll
    for (int off = 1; off < kLanesQuery; off <<= 1) {
      float od[3];
      int oi[3];
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        od[t] = __shfl_xor_sync(kFull, bd[t], off);
        oi[t] = __shfl_xor_sync(kFull, bi[t], off);
      }
#pragma unroll
      for (int t = 0; t < 3; ++t) insert(bd, bi, od[t], oi[t]);
    }
    float w[3];
    {
      float r[3];
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        r[t] = __fdiv_rn(1.f, __fadd_rn(__fsqrt_rn(fmaxf(bd[t], 0.f)), eps));
        bi[t] = min(bi[t], M - 1);  // only a NaN query leaves a slot unfilled
      }
      const float norm = __fadd_rn(__fadd_rn(r[0], r[1]), r[2]);
#pragma unroll
      for (int t = 0; t < 3; ++t) w[t] = __fdiv_rn(r[t], norm);
    }
    if (active) {  // the query's lanes share its 3 slots
      const int64_t o = ((int64_t)bg * S + s) * 3;
#pragma unroll
      for (int t = part; t < 3; t += kLanesQuery) {
        out_i[o + t] = pick3(t, bi[0], bi[1], bi[2]);
        out_w[o + t] = pick3(t, w[0], w[1], w[2]);
      }
    }

    // ---- the unit's rows of group j: element e is (row e / nc, chunk e % nc)
    const int64_t row0 = (int64_t)b * S + s0;
    for (int base = 0; base < ne; base += 32 * kUnroll) {
      T a[kUnroll], c1[kUnroll], c2[kUnroll];
      float w0[kUnroll], w1[kUnroll], w2[kUnroll];
      int rr[kUnroll], ch[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = min(base + u * 32 + lane, ne - 1);  // past the end: a valid read, no store
        const int r = nc > 1 ? (int)__umulhi((unsigned)e, ncm) : e;
        const int src = r * kLanesQuery;
        rr[u] = r;
        ch[u] = e - r * nc;
        const int i0 = __shfl_sync(kFull, bi[0], src);
        const int i1 = __shfl_sync(kFull, bi[1], src);
        const int i2 = __shfl_sync(kFull, bi[2], src);
        w0[u] = __shfl_sync(kFull, w[0], src);
        w1[u] = __shfl_sync(kFull, w[1], src);
        w2[u] = __shfl_sync(kFull, w[2], src);
        a[u] = __ldg(vb + (int64_t)i0 * ld + ch[u]);
        c1[u] = __ldg(vb + (int64_t)i1 * ld + ch[u]);
        c2[u] = __ldg(vb + (int64_t)i2 * ld + ch[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (base + u * 32 + lane < ne && s0 + rr[u] < s_hi)
          __stcs(ob + (row0 + rr[u]) * ld + ch[u], mix(w0[u], a[u], w1[u], c1[u], w2[u], c2[u]));
      }
    }
  }
}

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  int& c = count[dev & 63];
  if (c == 0 && cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) c = 1;
  return c;
}

template <bool kShared, int V>
void launch(dim3 grid, size_t smem, cudaStream_t s, const float* pos, const float* offset,
            const float* known, const float* feats, float* out, int64_t* idx, float* w, int64_t S,
            int64_t M, int64_t C, int64_t G, int64_t per_block, float eps) {
  three_nn_interp_kernel<kShared, V><<<grid, kThreads, smem, s>>>(
      pos, offset, known, feats, out, idx, w, (int)S, (int)M, (int)C, (int)G, (int)per_block, eps);
}

}  // namespace

// pos (B, S, 3), offset (B, G, S, 3) or null (then G must be 1), known
// (B, M, 3), feats (B, M, C) float32 -> out (B, S, C) float32, idx (B, G, S,
// 3) int64, w (B, G, S, 3) float32. Requires M >= 3 (the caller checks it),
// C % G == 0, B G < 2**16, C / G < 2**14, S, M, C < 2**31.
extern "C" int three_nn_interpolate_f32(const float* pos, const float* offset, const float* known,
                                        const float* feats, float* out, int64_t* idx, float* w,
                                        int64_t B, int64_t S, int64_t M, int64_t C, int64_t G,
                                        float eps, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (G < 1 || C % G != 0 || C / G >= (1 << 14) || (offset == nullptr && G != 1) || B * G > 65535 ||
      S >= ((int64_t)1 << 31) || M >= ((int64_t)1 << 31) || C >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  // about two blocks an SM, each a whole number of units for every warp
  const int64_t step = kQueries * kWarps;
  int64_t nbx = 2 * sm_count() / (B * G);
  if (nbx < 1) nbx = 1;
  int64_t per_block = (S + nbx - 1) / nbx;
  per_block = (per_block + step - 1) / step * step;
  nbx = (S + per_block - 1) / per_block;
  const dim3 grid((unsigned)nbx, (unsigned)(B * G));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = (C / G) % 4 == 0 &&
                    ((reinterpret_cast<uintptr_t>(feats) | reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  const bool shared = M <= kSharedPoints;
  const size_t smem = shared ? (size_t)M * sizeof(float4) : 0;
  if (shared && vec4)
    launch<true, 4>(grid, smem, s, pos, offset, known, feats, out, idx, w, S, M, C, G, per_block, eps);
  else if (shared)
    launch<true, 1>(grid, smem, s, pos, offset, known, feats, out, idx, w, S, M, C, G, per_block, eps);
  else if (vec4)
    launch<false, 4>(grid, smem, s, pos, offset, known, feats, out, idx, w, S, M, C, G, per_block, eps);
  else
    launch<false, 1>(grid, smem, s, pos, offset, known, feats, out, idx, w, S, M, C, G, per_block, eps);
  return (int)cudaGetLastError();
}
