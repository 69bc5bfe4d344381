// Backward of the batched weighted gather-sum
//     out[b, s, :] = sum_{m < K} w[b, s, m] * feats[b, idx[b, s, m], :]
// given the cotangent g (B, S, C) of out:
//     dfeats[b, j, :] = sum_{s, m : idx[b, s, m] == j} w[b, s, m] * g[b, s, :]
//     dw[b, s, m]     = g[b, s, :] . feats[b, idx[b, s, m], :]
// with w (B, S, K) float32, idx (B, S, K) int64, feats (B, M, C) float32.
// An index outside [0, M) contributes nothing to dfeats and gets dw = 0,
// as in the forward (csrc/weighted_gather_sum.cu).
//
// Replaces: imgadapointr_tpu/ops/pallas/gather_sum.py:_bwd_impl, the two
// kernels `_dfeats_kernel` (pallas_call at :135) and `_dweights_kernel`
// (:149). The TPU has neither gather nor scatter, so both build the dense
// (S, M) weight matrix W in VMEM with K compare-select passes and take
// dfeats = W^T g and dw = (g feats^T) at idx on the matrix unit; the dfeats
// block is carried across the sequential grid. A Hopper thread adds to and
// reads from any row, so neither kernel builds W:
//
// - dfeats: destination-major and deterministic, one kernel. Each output
//   element is the float32 sum of its terms w * g (each product rounded
//   once) in increasing flat (s, m) order, starting from +0: the order and
//   rounding of the plain version on the CPU (index_add_ of the products),
//   so the kernel is bit-equal to it and two runs give the same bits, as
//   the TPU kernel's sequential grid was deterministic. No atomics on the
//   values and no zeroing pass: each element is written once, a row with
//   no term as zero. Bound on the H100: bytes (w, idx and g read once,
//   dfeats written once; a multiply and an add per term and channel).
//   Block (b, k, z) owns the destination span [k span, (k + 1) span) of
//   batch element b and the channel slab z of nch chunks (16 bytes where
//   C % 4 == 0 and the pointers allow it, else 4).
//   - (F, R) It lists the S K terms that land in its span and sorts them
//     stably by destination (span_sort.cuh, by its counting pass where the
//     table fits; an out-of-range index lands nowhere), so each row's
//     terms are a run in increasing (s, m) order, the run's last entry
//     marked by its sign bit.
//   - (S) The sums walk the sources in windows, in order: the block copies
//     a window's g rows (its slab) and weights into shared memory with
//     cp.async (over the sort's spent second list), the next window's copy
//     in flight while the current one is summed. Each thread carries up to
//     kPairs (row, chunk) sums in registers, each with its row's next
//     entry and that entry's term, and adds the terms whose source lies in
//     the window, two a step (their loads together, the adds in order); a
//     pair whose row has none there costs one compare (a row gets about 2
//     terms a window on random indices, hundreds where many queries share
//     a known point). So g is read once, coalesced, whatever the indices:
//     a sum that staged each row's terms in destination order would read
//     every g row K times at random.
//   Grouped (groups > 1, the 3-NN VJP of a deformable gather): batch
//   element b = b0 groups + j is channel group j of b0; it reads its
//   cotangent rows at channel offset j C with row stride groups C from the
//   (B0, S, groups C) gradient and writes its dfeats rows into the (B0, M,
//   groups C) table gradient the same way. Only the addresses change: the
//   sort, the windows and the sums are those of element b, so the bits are
//   those of the same call on the group's contiguous copy.
//   Slabs fill the card at the deformable step's shapes (32 elements x 192
//   channels or 16 x 384, 256-576 rows: one span, 4 or 8 slabs of 48
//   channels, 128 blocks), each slab block sorting its element's terms
//   again. On calls with up to 16384 terms an element (every 3-NN VJP) the
//   sort lives in shared memory; larger calls keep it in int32 scratch
//   that the wrapper allocates (weighted_gather_sum_dfeats_scratch
//   entries), one block a span walking its slabs in turn. The windows
//   take most of a block's time, the sort the rest; within the windows the
//   g loads meet bank conflicts where two rows of 12 chunks share an 8-lane
//   phase, and a row with thousands of terms (the step's real 3-NN
//   indices) is a chain of dependent steps in one warp: at 64 registers a
//   thread the compiler serialises the terms of an unrolled step, so
//   neither four terms a step, reading the list a step ahead nor a counted
//   loop shortened it. A third window buffer (smaller windows) and
//   interleaving a thread's pairs were slower too.
// - dweights: bound on the H100: bytes (idx, g and the table read once,
//   dw written once). A warp per row s splits the channels over a group
//   of L lanes (L = half the row's width in float4 or float slots, rounded
//   up to a power of two, at most 32), so a warp takes 32 / L neighbours
//   at once, two such steps in flight; each lane keeps its g slots in
//   registers where the row has at most 2 L slots. The warp loads its
//   row's indices 32 at a time in one coalesced read and hands each group
//   its index by a shuffle. The dot product has no branch (row_dot): a
//   range check around the loads made each a divergent branch, and the
//   loop waited on them one after another. Each lane multiplies and adds
//   its slots in ascending channel order, and the group reduces with a
//   fixed butterfly of shuffles, so the result is the same in every run.
//   A block takes one b and DW_ROWS rows s and reads the neighbour rows
//   from device memory or L2, the two steps' rows in flight together. A
//   route that first copied one batch's table into shared memory (the
//   superset's GDANet shape: 128 KB a block) was slower on the H100 in
//   every mode timed: the rows hit L2, and the copy itself cost more than
//   it saved. Offsets are 64-bit.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "span_sort.cuh"

namespace {

using span_sort::kBins;
using span_sort::kThreads;
constexpr int kPairs = 7;                          // (row, chunk) sums a thread carries
constexpr int kPairsBlock = kThreads * kPairs;     // and a block
constexpr int kMaxWindow = 512;                    // sources a window

__device__ __forceinline__ const float* lanes(const float4& v) { return &v.x; }
__device__ __forceinline__ const float* lanes(const float& v) { return &v; }
__device__ __forceinline__ void store(float4* p, const float (&a)[4]) {
  *p = make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ void store(float* p, const float (&a)[1]) { *p = a[0]; }

// kShared: the sort in dynamic shared memory (span_sort.cuh), else in the
// element's scratch, the block then walking the slabs z, z + gridDim.z, ...
// V = 4: 16-byte chunks (width = C / 4 of them), V = 1: floats (width = C).
// magic: floor((2^32 - 1) / K) + 1 where every term index t has t K < 2^32
// (then s = t / K is (t magic) >> 32), else 0. counting: the sort takes its
// counting pass (room for it after the sort's lists). groups: element b is
// group b % groups of b / groups, its rows groups width chunks apart.
template <bool kShared, int V>
__global__ void __launch_bounds__(kThreads, 1)
    dfeats_kernel(const float* __restrict__ w, const int64_t* __restrict__ idx,
                  const float* __restrict__ g, float* __restrict__ out, int* __restrict__ scratch,
                  int S, int K, int M, int shift, int width, int nch, int window,
                  unsigned long long magic, int counting, int groups) {
  typedef typename std::conditional<V == 4, float4, float>::type T;
  extern __shared__ int4 dyn4[];  // 16-byte aligned
  int* dyn = reinterpret_cast<int*>(dyn4);
  const int64_t b = blockIdx.x;
  const int64_t b0 = b / groups, jg = b - b0 * groups;
  const int64_t ld = (int64_t)width * groups;  // a row of g and of out, in chunks
  const int nt = S * K;  // terms of the element
  const int span = kBins << shift;
  const int lo = blockIdx.y * span, nrow = min(span, M - lo);
  const int tid = threadIdx.x;
  idx += b * nt;
  w += b * nt;
  int *count, *list;
  span_sort::sort_span<kShared>(
      [&](int t) {
        const int64_t j = idx[t];
        return j >= 0 && j < M ? (int)j : M;
      },
      nt, M, lo, nrow, shift, dyn, kShared ? nullptr : scratch + b * ((int64_t)M + 2 * nt), count,
      list, kShared && counting);
  // after the sort: the row ends (the global route's copy), then the two
  // windows of g's slab rows and of the weights, over the sort's second
  // list on the shared route (dead once the list is sorted)
  int* ends = kShared ? count : dyn;
  const int fixed = kShared ? span + nt : nrow;
  T* sg = reinterpret_cast<T*>(dyn + ((fixed + 3) & ~3));
  float* sw = reinterpret_cast<float*>(sg + 2 * window * nch);
  if (!kShared) {
    for (int r = tid; r < nrow; r += kThreads) ends[r] = count[r];
    __syncthreads();
  }
  // each row's last entry gets its sign bit (sources fit in 30 bits)
  for (int r = tid; r < nrow; r += kThreads)
    if (ends[r] > (r == 0 ? 0 : ends[r - 1])) list[ends[r] - 1] |= INT_MIN;
  __syncthreads();
  const int nwin = (S + window - 1) / window;
  auto div_k = [&](int t) { return magic ? (int)(((unsigned long long)t * magic) >> 32) : t / K; };

  for (int c0 = blockIdx.z * nch; c0 < width; c0 += gridDim.z * nch) {
    const int nc = min(nch, width - c0);
    const int npairs = nrow * nc;
    // pair p = (row p / nc, chunk p % nc) by one multiply (p nc < 2^32)
    const unsigned ncm = nc > 1 ? 0xffffffffu / nc + 1 : 0;
    auto row_of = [&](int p) { return nc > 1 ? (int)__umulhi((unsigned)p, ncm) : p; };
    const T* gb = reinterpret_cast<const T*>(g) + b0 * S * ld + jg * width + c0;
    // this thread's pairs tid + i kThreads: the sums, the list position of
    // each row's next entry (its sign bit set where that entry is the row's
    // last) and that entry's term (INT_MAX past the row's run)
    float acc[kPairs][V];
    int at[kPairs], next[kPairs];
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
#pragma unroll
      for (int v = 0; v < V; ++v) acc[i][v] = 0.0f;
      const int p = tid + i * kThreads, r = row_of(p);
      at[i] = p < npairs && r > 0 ? ends[r - 1] : 0;
      next[i] = INT_MAX;
      if (p < npairs && at[i] < ends[r]) {
        const int e = list[at[i]];
        next[i] = span_sort::source<kShared>(e);
        at[i] |= e & INT_MIN;
      }
    }
    __syncthreads();  // the previous slab's last window is read
    auto issue = [&](int wi) {  // window wi's copies, into buffer wi & 1
      const int s0 = wi * window, ns = min(window, S - s0);
      T* sgb = sg + (wi & 1) * window * nch;
      for (int q = tid; q < ns * nc; q += kThreads) {
        const int sr = q / nc;
        __pipeline_memcpy_async(sgb + q, gb + (int64_t)(s0 + sr) * ld + (q - sr * nc), sizeof(T));
      }
      float* swb = sw + (wi & 1) * window * K;
      for (int q = tid; q < ns * K; q += kThreads)
        __pipeline_memcpy_async(swb + q, w + (int64_t)s0 * K + q, sizeof(float));
      __pipeline_commit();
    };
    if (nwin > 0) issue(0);
    for (int wi = 0; wi < nwin; ++wi) {
      if (wi + 1 < nwin) {
        issue(wi + 1);
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();  // the window is in place
      const int s0 = wi * window, t0 = s0 * K, t1 = min(S, s0 + window) * K;
      const T* sgb = sg + (wi & 1) * window * nch;
      const float* swb = sw + (wi & 1) * window * K;
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        if (next[i] >= t1) continue;  // no term of this pair's row in the window
        const int p = tid + i * kThreads, ch = p - row_of(p) * nc;
        do {  // the row's next two terms where both lie in the window, added in order
          const int t = next[i], pos = at[i] & INT_MAX;
          const int e1 = list[pos + 1], e2 = list[pos + 2];  // within the list's room
          const int u1 = span_sort::source<kShared>(e1);
          const bool two = at[i] >= 0 && u1 < t1;  // the second term: in the run and the window
          const float wv = swb[t - t0];
          const T gv = sgb[(div_k(t) - s0) * nc + ch];
          float w1 = 0.0f;
          T g1{};
          if (two) {
            w1 = swb[u1 - t0];
            g1 = sgb[(div_k(u1) - s0) * nc + ch];
          }
          // the entry after the last one taken: its term, INT_MAX past the run
          const int e = two ? e2 : e1, last = two ? e1 : at[i];
          next[i] = last < 0 ? INT_MAX : span_sort::source<kShared>(e);
          at[i] = (pos + (two ? 2 : 1)) | (e & INT_MIN);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            acc[i][v] = __fadd_rn(acc[i][v], __fmul_rn(wv, lanes(gv)[v]));
            if (two) acc[i][v] = __fadd_rn(acc[i][v], __fmul_rn(w1, lanes(g1)[v]));
          }
        } while (next[i] < t1);
      }
      __syncthreads();  // the buffer is free for window wi + 2
    }
    T* dst = reinterpret_cast<T*>(out) + (b0 * M + lo) * ld + jg * width + c0;
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int p = tid + i * kThreads, r = row_of(p);
      if (p < npairs) store(dst + (int64_t)r * ld + (p - r * nc), acc[i]);
    }
  }
}

// A call's layout: spans of kBins << shift rows (nspan of them), slabs of
// nch chunks (nslab blocks of them), sources a window, the route and the
// dynamic shared memory.
struct DfeatsPlan {
  int shift, nspan, nch, nslab, window;
  bool shared, counting;
  size_t smem;
};

// the dynamic shared memory a block may take (read once per device)
int dfeats_smem_budget() {
  static int bytes[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  int& b = bytes[dev & 63];
  if (b == 0) {
    int optin = 0;
    cudaFuncAttributes attr;
    if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess ||
        cudaFuncGetAttributes(&attr, dfeats_kernel<true, 4>) != cudaSuccess)
      return 0;
    b = optin - (int)attr.sharedSizeBytes;
  }
  return b;
}

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  int& c = count[dev & 63];
  if (c == 0 && cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) c = 1;
  return c;
}

// false where no layout fits (a window of one source exceeds shared memory)
bool dfeats_plan(int64_t B, int64_t S, int64_t K, int64_t M, int64_t width, int V, DfeatsPlan& p) {
  const int64_t nt = S * K, budget = dfeats_smem_budget() / 4;
  // rows a block: the least power of two that holds M, at most kPairsBlock
  p.shift = 0;
  while (((int64_t)kBins << p.shift) < M && ((int64_t)kBins << (p.shift + 1)) <= kPairsBlock) ++p.shift;
  const int64_t span = (int64_t)kBins << p.shift, nrow = span < M ? span : M;
  p.nspan = (int)((M + span - 1) / span);
  const int64_t most = kPairsBlock / nrow;  // chunks a block at most
  const int64_t least_slabs = (width + most - 1) / most;
  for (int route = 0; route < 2; ++route) {
    p.shared = route == 0;
    if (p.shared && (span > span_sort::kSharedSpan || nt > span_sort::kSharedSources)) continue;
    int64_t slabs = least_slabs;
    if (p.shared) {  // fill the card: one block an SM
      const int64_t fill = sm_count() / (B * p.nspan);
      if (fill > slabs) slabs = fill < width ? fill : width;
    }
    const int64_t nch = (width + slabs - 1) / slabs;
    p.nch = (int)nch;
    p.nslab = p.shared ? (int)((width + nch - 1) / nch) : 1;
    // the sort (span + 2 nt words, and the counting pass's table where it
    // fits), or the row ends and the staging over the sort's second list
    const int64_t fixed = ((p.shared ? span + nt : nrow) + 3) & ~3;
    const int64_t per_source = 2 * (nch * V + K);
    if (p.shared && span + 2 * nt > budget) continue;
    const int64_t sort = span + 2 * nt + span_sort::kWarps * nrow;
    p.counting = p.shared && sort <= budget;
    int64_t window = (budget - fixed) / per_source;
    if (window > kMaxWindow) window = kMaxWindow;
    if (window > S) window = S;
    if (window < 1 && S > 0) continue;
    p.window = (int)(window < 1 ? 1 : window);
    const int64_t stage = p.window * per_source;
    int64_t words = fixed + (p.shared && nt > stage ? nt : stage);
    if (p.counting && sort > words) words = sort;
    p.smem = (size_t)words * 4;
    return true;
  }
  return false;
}

bool dfeats_vec4(int64_t C, const void* g, const void* out) {
  return C % 4 == 0 && ((reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(out)) % 16) == 0;
}

template <bool kShared, int V>
cudaError_t launch_dfeats(const float* w, const int64_t* idx, const float* g, float* out, int* scratch,
                          int64_t B, int64_t S, int64_t K, int64_t M, int64_t width, int64_t groups,
                          const DfeatsPlan& p, cudaStream_t st) {
  static bool attr_set[64] = {false};
  int dev = 0;
  cudaGetDevice(&dev);
  if (!attr_set[dev & 63]) {
    const cudaError_t e = cudaFuncSetAttribute(dfeats_kernel<kShared, V>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               dfeats_smem_budget());
    if (e != cudaSuccess) return e;
    attr_set[dev & 63] = true;
  }
  const int64_t nt = S * K;
  const unsigned long long magic =
      K >= 1 && nt * K < ((int64_t)1 << 32) ? 0xffffffffull / (unsigned long long)K + 1 : 0;
  const dim3 grid((unsigned)B, (unsigned)p.nspan, (unsigned)p.nslab);
  dfeats_kernel<kShared, V><<<grid, kThreads, p.smem, st>>>(
      w, idx, g, out, scratch, (int)S, (int)K, (int)M, p.shift, (int)width, p.nch, p.window, magic,
      p.counting ? 1 : 0, (int)groups);
  return cudaGetLastError();
}

constexpr int DW_THREADS = 512;  // 16 warps, a row each at a time
constexpr int DW_ROWS = 64;      // rows s per block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float dot(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ float dot(const float& a, const float& b, float acc) {
  return fmaf(a, b, acc);
}
__device__ __forceinline__ void zero(float4& v) { v = make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
__device__ __forceinline__ void zero(float& v) { v = 0.0f; }

// group's dot of g's row (in registers g0, g1 when FEW, else grow) with
// table row j; 0 for an index the caller marked invalid (j < 0). Without a
// branch where FEW: the row and the slots are clamped to ones that exist,
// loaded unconditionally and their terms selected, so the loads of both
// steps issue together instead of each behind a divergent branch.
template <typename V, bool FEW>
__device__ __forceinline__ float row_dot(const V* table, int j, const V* grow, V g0, V g1,
                                         int sub, int L, int64_t width) {
  const V* t = table + (int64_t)(j < 0 ? 0 : j) * width;
  float acc = 0.0f;
  if (FEW) {
    const V a0 = t[sub < width ? sub : 0];
    const V a1 = t[sub + L < width ? sub + L : 0];
    acc = sub < width ? dot(g0, a0, acc) : acc;
    acc = sub + L < width ? dot(g1, a1, acc) : acc;
  } else {
    for (int64_t c = sub; c < width; c += L) acc = dot(grow[c], t[c], acc);
  }
  return j < 0 ? 0.0f : acc;
}

// the dot products of one row with its neighbours m0 + [0, n), n <= 32:
// lane l holds the index of neighbour m0 + l (-1 if outside [0, M)); each
// step gives the warp's 32 / L groups one neighbour each, two steps in flight
template <typename V, bool FEW>
__device__ __forceinline__ void row_block(const V* table, const V* grow, V g0, V g1, int mine,
                                          int n, float* out, int sub, int group, int G, int L,
                                          int64_t width) {
  // the same trip count in every lane: the shuffles need the whole warp
  for (int i = 0; i < n; i += 2 * G) {
    const int ma = i + group, mb = i + G + group;
    const int ja = __shfl_sync(FULL, mine, ma & 31);
    const int jb = __shfl_sync(FULL, mine, mb & 31);
    float acc_a = row_dot<V, FEW>(table, ma < n ? ja : -1, grow, g0, g1, sub, L, width);
    float acc_b = row_dot<V, FEW>(table, mb < n ? jb : -1, grow, g0, g1, sub, L, width);
    for (int off = L >> 1; off > 0; off >>= 1) {
      acc_a += __shfl_xor_sync(FULL, acc_a, off, L);
      acc_b += __shfl_xor_sync(FULL, acc_b, off, L);
    }
    if (sub == 0 && ma < n) out[ma] = acc_a;
    if (sub == 0 && mb < n) out[mb] = acc_b;
  }
}

// lane's index of neighbour m of a row (-1 past K or outside [0, M))
__device__ __forceinline__ int load_index(const int64_t* idx_row, int64_t m, int64_t K, int64_t M) {
  if (m >= K) return -1;
  const int64_t j = idx_row[m];
  return (j >= 0 && j < M) ? (int)j : -1;
}

// V is float4 (width = C / 4) or float (width = C); L lanes per group;
// FEW: width <= 2 L.
template <typename V, bool FEW>
__global__ void __launch_bounds__(DW_THREADS)
dweights_kernel(const int64_t* __restrict__ idx, const V* __restrict__ g,
                const V* __restrict__ feats, float* __restrict__ dw, int64_t S, int64_t K,
                int64_t M, int64_t width, int L) {
  const int64_t b = blockIdx.y;
  const int64_t s0 = (int64_t)blockIdx.x * DW_ROWS;
  const V* table = feats + b * M * width;
  const int lane = threadIdx.x & 31;
  const int sub = lane % L, group = lane / L, G = 32 / L;
  const int64_t s1 = s0 + DW_ROWS < S ? s0 + DW_ROWS : S;
  for (int64_t s = s0 + (threadIdx.x >> 5); s < s1; s += DW_THREADS / 32) {
    const int64_t row = b * S + s;
    const V* grow = g + row * width;
    V g0, g1;
    zero(g0);
    zero(g1);
    if (FEW) {
      if (sub < width) g0 = grow[sub];
      if (sub + L < width) g1 = grow[sub + L];
    }
    for (int64_t m0 = 0; m0 < K; m0 += 32) {
      const int n = (int)(K - m0 < 32 ? K - m0 : 32);
      // the row's next 32 indices in one read
      const int mine = load_index(idx + row * K, m0 + lane, K, M);
      row_block<V, FEW>(table, grow, g0, g1, mine, n, dw + row * K + m0, sub, group, G, L, width);
    }
  }
}

template <typename V>
int launch_dweights(const int64_t* idx, const V* g, const V* feats, float* dw, int64_t B,
                    int64_t S, int64_t K, int64_t M, int64_t width, cudaStream_t s) {
  int L = 1;
  while (L < (width + 1) / 2 && L < 32) L <<= 1;
  const dim3 grid((unsigned)((S + DW_ROWS - 1) / DW_ROWS), (unsigned)B);
  auto kernel = width <= 2 * L ? dweights_kernel<V, true> : dweights_kernel<V, false>;
  kernel<<<grid, DW_THREADS, 0, s>>>(idx, g, feats, dw, S, K, M, width, L);
  return (int)cudaGetLastError();
}

bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) %
          16) == 0;
}

}  // namespace

// The int32 scratch entries a dfeats call needs: none on the shared route,
// B (M + 2 S K) otherwise (for either chunk width, since the route may
// depend on the pointers' alignment).
extern "C" int64_t weighted_gather_sum_dfeats_scratch(int64_t B, int64_t S, int64_t K, int64_t M,
                                                      int64_t C) {
  DfeatsPlan p;
  const bool global = !dfeats_plan(B, S, K, M, C, 1, p) || !p.shared ||
                      (C % 4 == 0 && (!dfeats_plan(B, S, K, M, C / 4, 4, p) || !p.shared));
  return global ? B * (M + 2 * S * K) : 0;
}

// w (B, S, K), idx (B, S, K), g (B / groups, S, groups C) -> dfeats (B /
// groups, M, groups C), every element written: element b is channel group
// b % groups of b / groups (groups = 1: g (B, S, C), dfeats (B, M, C));
// scratch: weighted_gather_sum_dfeats_scratch(B, S, K, M, C) int32 entries.
extern "C" int weighted_gather_sum_dfeats_f32(const float* w, const int64_t* idx, const float* g,
                                              float* dfeats, int* scratch, int64_t B, int64_t S,
                                              int64_t K, int64_t M, int64_t C, int64_t groups,
                                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B * M * C == 0) return 0;
  if (B >= ((int64_t)1 << 31) || S * K >= ((int64_t)1 << 30) || M >= ((int64_t)1 << 30) ||
      C * groups >= ((int64_t)1 << 30) || groups < 1 || B % groups != 0)
    return (int)cudaErrorInvalidValue;
  const bool vec4 = dfeats_vec4(C, g, dfeats);
  const int64_t width = vec4 ? C / 4 : C;
  DfeatsPlan p;
  if (!dfeats_plan(B, S, K, M, width, vec4 ? 4 : 1, p) || p.nspan > 65535 || p.nslab > 65535)
    return (int)cudaErrorInvalidValue;
  if (p.shared)
    return (int)(vec4 ? launch_dfeats<true, 4>(w, idx, g, dfeats, scratch, B, S, K, M, width, groups, p, st)
                      : launch_dfeats<true, 1>(w, idx, g, dfeats, scratch, B, S, K, M, width, groups, p, st));
  return (int)(vec4 ? launch_dfeats<false, 4>(w, idx, g, dfeats, scratch, B, S, K, M, width, groups, p, st)
                    : launch_dfeats<false, 1>(w, idx, g, dfeats, scratch, B, S, K, M, width, groups, p, st));
}

// idx (B, S, K), g (B, S, C), feats (B, M, C) -> dw (B, S, K).
extern "C" int weighted_gather_sum_dweights_f32(const int64_t* idx, const float* g,
                                                const float* feats, float* dw, int64_t B,
                                                int64_t S, int64_t K, int64_t M, int64_t C,
                                                void* stream) {
  const int64_t rows = B * S;
  if (rows == 0 || K == 0) return 0;
  if (B > 65535 || M >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 0) return (int)cudaMemsetAsync(dw, 0, rows * K * sizeof(float), s);
  if ((C % 4 == 0) && aligned16(g, feats))
    return launch_dweights(idx, reinterpret_cast<const float4*>(g),
                           reinterpret_cast<const float4*>(feats), dw, B, S, K, M, C / 4, s);
  return launch_dweights(idx, g, feats, dw, B, S, K, M, C, s);
}
