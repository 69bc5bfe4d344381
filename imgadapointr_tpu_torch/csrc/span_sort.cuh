// The destination-major sort shared by the deterministic sums
// (scatter_add_rows.cu, and dfeats in weighted_gather_sum_bwd.cu): a block
// of kThreads threads that owns the destination span [lo, lo + nrow) of one
// batch element lists, in order, the sources that land in its span and
// sorts that list stably by destination. Afterwards each destination's
// sources are a contiguous run of the list in increasing source order, so a
// sum that walks each run adds in source order: the order of the plain
// versions on the CPU, in every run.
//
// - (F) The block reads the destination of every source: warp w takes a
//   contiguous 32nd of the sources and keeps, in order, those that land in
//   the span (a ballot compaction), counting each destination (shared
//   atomics: a count does not depend on the order of its adds); a scan of
//   the counts gives each destination's end in the sorted list.
// - (R) A stable radix sort of that list by destination, 5 bits a pass
//   from the lowest: in each pass warp w takes a contiguous 32nd of the
//   list in order, ranks its lanes by ballots of the digit's bits, and the
//   block scans the (digit, warp) counts in warp order. The list is then
//   the span's sources by destination, then by source, and a skew of the
//   destinations (many sources to one row) spreads evenly over the warps.
// - Or, on the shared route where the caller gives room for a (warp,
//   destination) table of counts (kWarps x nrow ints), one counting pass
//   in place of (R) and the compaction: (F) also counts each warp's sources per destination, a
//   scan over (destination, warp) gives each warp its first slot in each
//   destination's run, and each warp then writes its sources there in
//   order, ranking its lanes by ballots of the destination's bits.
//
// Shared route (kShared: spans and sources up to 16384): the counts (span
// ints) and the two lists that the radix passes alternate between (S ints
// each) live in dynamic shared memory, each entry packed as
// source | (destination - lo) << 14. Otherwise they live in the block's
// share of an int32 scratch (rows + 2 S entries for the batch element),
// each entry the bare source, its destination read again.
//
// A caller gives its destination rule, dest(s): the destination row of
// source s in [0, rows), or rows for a source that adds nothing anywhere;
// and whether it has room for the counting pass.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace span_sort {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = kWarps;  // destination ranges, one per warp, for the counts' scan
constexpr int kDigitBits = 5, kDigits = 1 << kDigitBits;  // the radix sort's digits
// the shared route: spans and sources up to 16384 (14 bits each when packed)
constexpr int64_t kSharedSpan = 16384, kSharedSources = 16384;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kWarps == 32 && kDigits == 32, "the scans take one warp's lanes");

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// The live lanes whose digit equals this lane's, by one ballot per digit
// bit (bits of them): deterministic, and cheaper than __match_any_sync where
// most digits in a warp differ.
__device__ __forceinline__ unsigned peers_of(unsigned digit, unsigned live, int bits = kDigitBits) {
  unsigned peers = live;
#pragma unroll 5
  for (int i = 0; i < bits; ++i) {
    const unsigned bit = (digit >> i) & 1u;
    const unsigned set = __ballot_sync(kFull, bit);
    peers &= bit ? set : ~set;
  }
  return peers;
}

// A shared-route list entry: source s, destination dl past the span's start.
__device__ __forceinline__ int packed(int s, int dl) { return s | dl << 14; }

// the source of a list entry (a caller may use the sign bit as a mark)
template <bool kShared>
__device__ __forceinline__ int source(int e) {
  return kShared ? e & 0x3fff : e & 0x7fffffff;
}

// count[r] (r < nrow) becomes the end of destination r's run: warp w scans
// the counts of destinations [w 2^shift, (w + 1) 2^shift) after the warps
// before it. Ends with a barrier.
__device__ __forceinline__ void scan_ends(int* count, int nrow, int shift) {
  __shared__ int bin_total[kBins], bin_first[kBins];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rlo = min(warp << shift, nrow), rhi = min(rlo + (1 << shift), nrow);
  int total = 0;
  for (int r = rlo + lane; r < rhi; r += 32) total += count[r];
  total = __reduce_add_sync(kFull, total);
  if (lane == 0) bin_total[warp] = total;
  __syncthreads();
  if (warp == 0) {
    const int c = bin_total[lane];
    bin_first[lane] = warp_inclusive_scan(c, lane) - c;
  }
  __syncthreads();
  int running = bin_first[warp];
  for (int r0 = rlo; r0 < rhi; r0 += 32) {
    const int r = r0 + lane;
    const int c = r < rhi ? count[r] : 0;
    const int incl = warp_inclusive_scan(c, lane);
    if (r < rhi) count[r] = running + incl;
    running += __shfl_sync(kFull, incl, 31);
  }
  __syncthreads();
}

// The counting pass (shared route): the (warp, destination) counts of (F)
// in table, each source's destination in dcache; warp w's sources are
// [s0, s1). Writes each destination's run, in source order, to list and
// its end to count.
__device__ __forceinline__ void counting_pass(const int* dcache, int s0, int s1, int lo, int nrow,
                                              int shift, int* count, int* list, int* table) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const unsigned lt = (1u << lane) - 1;
  for (int r = tid; r < nrow; r += kThreads) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += table[w * nrow + r];
    count[r] = total;
  }
  __syncthreads();
  scan_ends(count, nrow, shift);
  for (int r = tid; r < nrow; r += kThreads) {  // each warp's first slot in r's run
    int running = r == 0 ? 0 : count[r - 1];
    for (int w = 0; w < kWarps; ++w) {
      const int c = table[w * nrow + r];
      table[w * nrow + r] = running;
      running += c;
    }
  }
  __syncthreads();
  const int dbits = nrow <= 1 ? 0 : 32 - __clz(nrow - 1);
  int* mine = table + warp * nrow;
  for (int base = s0; base < s1; base += 32) {
    const int s = base + lane;
    const int dl = (s < s1 ? dcache[s] : lo + nrow) - lo;
    const bool in = dl >= 0 && dl < nrow;
    const unsigned peers = peers_of((unsigned)(in ? dl : 0), __ballot_sync(kFull, in), dbits);
    const int pos = in ? mine[dl] + __popc(peers & lt) : 0;
    __syncwarp();
    if (in && (peers & lt) == 0) mine[dl] += __popc(peers);
    __syncwarp();
    if (in) list[pos] = packed(s, dl);
  }
  __syncthreads();
}

// Phases F and R for span [lo, lo + nrow) of one batch element with S
// sources (span = kBins << shift). dyn: the block's dynamic shared memory,
// at least span + 2 S ints on the shared route, and kWarps nrow more after
// them for the counting pass (counting: shared route only); mine: the
// element's scratch (rows + 2 S ints) otherwise. On return (after a
// barrier) count[r] is the end of destination lo + r's run in list, and the
// result is the list's length. Every thread of the block must call it.
template <bool kShared, typename Dest>
__device__ int sort_span(const Dest& dest, int S, int rows, int lo, int nrow, int shift,
                         int* dyn, int* mine, int*& count, int*& list, bool counting = false) {
  __shared__ int bin_count[kBins], bin_start[kBins], warp_first[kWarps], warp_below[kWarps];
  __shared__ int wcnt[kDigits][kWarps + 1];  // [digit][warp]
  __shared__ int span_n, span_below;
  const int span = kBins << shift;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const unsigned lt = (1u << lane) - 1;
  auto pack = [&](int s, int dl) { return kShared ? packed(s, dl) : s; };
  auto dl_of = [&](int e) { return kShared ? e >> 14 : dest(e) - lo; };
  // per destination - lo: its count, then its first entry, then its end
  count = kShared ? dyn : mine + lo;
  for (int r = tid; r < nrow; r += kThreads) count[r] = 0;
  int* table = dyn + span + 2 * S;  // counting: [warp][destination - lo]
  if (counting) {
    for (int i = tid; i < kWarps * nrow; i += kThreads) table[i] = 0;
    __syncthreads();
  }

  // (F) the span's sources in order: warp w takes the contiguous sources
  // [w per, (w + 1) per), counts those in the span (and below it), and
  // after the scan of the warps' counts writes them to the list (in the
  // scratch, at the span's place: after the sources below it)
  const int per = (S + kWarps - 1) / kWarps;
  const int s0 = min(warp * per, S), s1 = min(s0 + per, S);
  int* dcache = dyn + span + S;  // shared route: each source's destination, until (R)
  int n_in = 0, n_below = 0;
  for (int base = s0; base < s1; base += 4 * 32) {  // four loads in flight
    int d[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int s = base + 32 * u + lane;
      d[u] = s < s1 ? dest(s) : rows;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int s = base + 32 * u + lane;
      if (kShared && s < s1) dcache[s] = d[u];
      if (counting && d[u] >= lo && d[u] < lo + nrow) atomicAdd(&table[warp * nrow + d[u] - lo], 1);
      n_in += __popc(__ballot_sync(kFull, d[u] >= lo && d[u] < lo + nrow));
      n_below += __popc(__ballot_sync(kFull, d[u] < lo));
    }
  }
  if (lane == 0) warp_first[warp] = n_in, warp_below[warp] = n_below;
  __syncthreads();
  if (warp == 0) {
    const int c = warp_first[lane];
    const int incl = warp_inclusive_scan(c, lane);
    warp_first[lane] = incl - c;
    const int below = __reduce_add_sync(kFull, warp_below[lane]);
    if (lane == 31) span_n = incl, span_below = below;
  }
  __syncthreads();
  const int n = span_n;
  list = kShared ? dyn + span : mine + rows + span_below;
  int* part = kShared ? dyn + span + S : mine + rows + S + span_below;
  if (counting) {
    counting_pass(dcache, s0, s1, lo, nrow, shift, count, list, table);
    return n;
  }
  int at = warp_first[warp];
  for (int base = s0; base < s1; base += 32) {
    const int s = base + lane;
    const int d = s < s1 ? (kShared ? dcache[s] : dest(s)) : rows;
    const bool in = d >= lo && d < lo + nrow;
    const unsigned ins = __ballot_sync(kFull, in);
    if (in) {
      list[at + __popc(ins & lt)] = pack(s, d - lo);
      atomicAdd(&count[d - lo], 1);
    }
    at += __popc(ins);
  }
  __syncthreads();

  // each destination's end in the sorted list
  scan_ends(count, nrow, shift);

  // (R) a stable radix sort of the list by destination - lo, 5 bits a pass
  // from the lowest: in each pass warp w takes a contiguous 32nd of the
  // list in order, ranks its lanes by ballots of the digit's bits, and the
  // block scans the (digit, warp) counts digit-major, warp-minor, so every
  // pass keeps the order of equal digits (and any skew of the destinations
  // spreads evenly over the warps)
  const int dbits = nrow <= 1 ? 0 : 32 - __clz(nrow - 1);
  const int lper = (n + kWarps - 1) / kWarps;
  const int i0 = min(warp * lper, n), i1 = min(i0 + lper, n);
  int* from = list;
  int* to = part;
  for (int sh = 0; sh < dbits; sh += kDigitBits) {
    wcnt[lane][warp] = 0;
    __syncwarp();
    for (int base = i0; base < i1; base += 32) {  // the warp's count per digit
      const int i = base + lane;
      const bool live = i < i1;
      const int digit = live ? (dl_of(from[i]) >> sh) & (kDigits - 1) : 0;
      const unsigned peers = peers_of((unsigned)digit, __ballot_sync(kFull, live));
      if (live && (peers & lt) == 0) wcnt[digit][warp] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    {  // thread (digit = warp, warp' = lane): the warps' first entries in the digit
      const int c = wcnt[warp][lane];
      const int incl = warp_inclusive_scan(c, lane);
      wcnt[warp][lane] = incl - c;
      if (lane == 31) bin_count[warp] = incl;
    }
    __syncthreads();
    if (warp == 0) {
      const int c = bin_count[lane];
      bin_start[lane] = warp_inclusive_scan(c, lane) - c;
    }
    __syncthreads();
    for (int base = i0; base < i1; base += 32) {
      const int i = base + lane;
      const bool live = i < i1;
      const int e = live ? from[i] : 0;
      const int digit = live ? (dl_of(e) >> sh) & (kDigits - 1) : 0;
      const unsigned peers = peers_of((unsigned)digit, __ballot_sync(kFull, live));
      const int rank = __popc(peers & lt);
      const int pos = live ? bin_start[digit] + wcnt[digit][warp] + rank : 0;
      __syncwarp();
      if (live && rank == 0) wcnt[digit][warp] += __popc(peers);
      __syncwarp();
      if (live) to[pos] = e;
    }
    __syncthreads();
    int* t = from;
    from = to;
    to = t;
  }
  if (from != list) {  // an odd number of passes: the sorted list back in place
    for (int i = tid; i < n; i += kThreads) list[i] = from[i];
  }
  __syncthreads();
  return n;
}

}  // namespace span_sort
