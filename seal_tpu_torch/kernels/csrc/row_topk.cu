// Kernel 3: exact row top-k with lax.top_k's order (value descending,
// index ascending on ties), by a split-row radix select.
//
// Replaces seal_tpu/decoding/constrained.py: _exact_topk and every
// lax.top_k of the decode path (_top_idx, the proposal loop, step 0); the
// proposal loop's rounds (:604-608, :734-736) read their pruned log-probs
// through a value loader (PrunedLoad, below) in the same launch.
// torch.topk does not specify its tie order, and the decoder's token and
// parent equality depends on it.  The order is f32's total order (+0.0
// above -0.0), as lax.top_k's is: each element maps to a 32-bit key whose
// unsigned order is that order, so the selected values are the row's bit
// for bit and the kernel equals the plain version
// (kernels/row_topk.py:row_topk_plain) exactly.
//
// Bound on the card: one read of the rows from device memory (0.0288 ms at
// [480, 50265] f32 at 3.35 TB/s).  The work does not grow with k, apart
// from the sort of the k survivors.
//
// Design.  A row is split into `splits` contiguous slices, one CTA each,
// and the CTAs of a row form a thread-block cluster (up to 16).  The
// wrapper's plan() keeps a row in one CTA where it fits in shared memory
// and the rows fill the card, and splits it where it does not fit or where
// 32 rows would leave the SMs idle.  Each CTA stages its slice's keys in
// shared memory with 16-byte loads (a scalar head and tail: a 50265-wide
// row is only 4-byte aligned), so the row is read from device memory once;
// a slice past the shared memory keeps its tail in device memory (below).
// Three radix passes find the k-th largest key T, 11, 11 and 10 bits, most
// significant first: each CTA histograms the digit of the keys that match
// the digits found so far in shared memory (one atomic a lane, or one a
// warp whose keys share a digit: an all -inf, NEG_INF or plateau row), a
// warp with no such key skips the histogram, and the CTAs of a cluster add
// their nonzero bins into the leader CTA's bins of that pass through
// distributed shared memory.  After one cluster barrier every CTA scans the
// leader's bins (a block-wide scan, 2048 bins) for the bin where the count
// from the top reaches the rank: one barrier a pass, each pass with its
// own bins so that none is cleared while another CTA reads it.
// After the passes each CTA knows T, the number `rank` of keys equal to T
// that the top k takes, and from the other CTAs' last histograms the count
// of keys equal to T in the slices before its own: slices are index ranges
// in rank order, so that prefix gives each CTA its share of the equal keys,
// lowest index first.  Each CTA appends its keys above T, and its share of
// those equal to T (a block-wide ballot scan in index order, only in a CTA
// whose share is partial), as (key << 32 | ~index) words into the leader's
// buffer.  The leader places each word by the number of words above it
// (k <= 512), or bitonic-sorts them (strides inside a thread in registers,
// inside a warp by shuffles, wider ones in shared memory), and writes them
// out.
//
// Past k = 16384 (seal_row_topk_max_k) the leader's buffer no longer fits in
// shared memory: the CTAs append their words to a global scratch row of
// n2 = pow2(k) words instead, and a bitonic sort in global memory orders
// it (sort_tiles sorts 8192-word tiles in shared memory; then, for each
// larger size, merge_global runs the strides of a tile and wider, one
// launch each, and merge_tile the narrower ones inside a tile, and the
// last of these writes the output).  The words are unique, so the order
// is total and the output equals the plain version bit for bit.  This
// route moves each survivor through device memory 2 + 2 * (global passes)
// times: it serves the rare knobs that ask for such k (an
// exact_loop_chunk past 16384), not the decode path's k.
//
// A slice longer than the shared memory (rows wider than 16 slices hold,
// e.g. a beam-32 dense row) reads its tail twice: pass 1 histograms it,
// pass 2 histograms it again and compacts its keys at or above the first
// threshold digit into a shared candidate list (at most `cap` words; the
// CTA knows the count from its pass-1 histogram), from which pass 3 and
// the output read.  Where the list would overflow (a row whose threshold
// bucket holds most of the slice: all -inf, all NEG_INF, a plateau), those
// steps re-read the tail instead: bounded and exact.

#include <cuda_runtime.h>

#include "global_sort.cuh"
#include "radix_topk.cuh"

namespace {

// ---- the global sort of the large-k route (global_sort.cuh) -------------
// its last pass writes each row's first k words as values and indices
struct TopkOut {
  float* vals;
  long long* idx;
  int k;
  __device__ void operator()(long long row, int j, u64 w) const {
    vals[row * k + j] = key_value(w);
    idx[row * k + j] = (long long)key_slot(w);
  }
};

// The straggler round's pruned log-probs (seal_pruned_topk), computed as
// the select stages lp and never written: for element f (token f) of row
// r, NEG_INF where f's bucket (f + SHIFT) / bucket_size has no row in the
// beam's interval (bit clear in the row's 8 support words, kernels 6 and
// 14's support modes), NEG_INF where the round's consumed-prefix threshold
// has examined it (v > th_lp[r], or v == th_lp[r] and f <= th_ix[r]), else
// lp.  The f32 comparisons are the eager ones' (-0.0 == 0.0, -inf below
// every threshold), so the keys are those of the parent's `work` row bit
// for bit.  A CTA reads its row's words and threshold once (slice()); a
// staged float4's four bits come from those registers (fetch(), no load):
// its first and last elements' buckets (a shift where bucket_size is a
// power of two, the wavelet layouts; else a multiply, FastDiv: the Psi
// layout's ceil(sigma / 256)) and each one's word by a tree of selects.
struct PrunedSlice {
  uint4 lo, hi;  // the row's 8 support words
  float th;
  int ix;
};

struct PrunedLoad {
  using Aux = unsigned;  // the four support bits of a staged float4
  const unsigned* bits;  // [rows, 8]
  const float* th_lp;    // [rows]
  const int* th_ix;      // [rows]
  FastDiv by_size;
  int size;   // bucket_size
  int shift;  // log2(bucket_size) where it is a power of two, else -1
  float neg_inf;

  __device__ __forceinline__ int bucket(int f) const {
    const unsigned s = (unsigned)f + 1u;  // the shifted symbol (SHIFT 1)
    return (int)(shift >= 0 ? s >> shift : by_size(s));
  }
  // word j of the slice's 8: a tree of selects on j's bits, in registers
  __device__ __forceinline__ static unsigned word(const PrunedSlice& sl, int j) {
    const unsigned p0 = j & 1 ? sl.lo.y : sl.lo.x, p1 = j & 1 ? sl.lo.w : sl.lo.z;
    const unsigned p2 = j & 1 ? sl.hi.y : sl.hi.x, p3 = j & 1 ? sl.hi.w : sl.hi.z;
    const unsigned q0 = j & 2 ? p1 : p0, q1 = j & 2 ? p3 : p2;
    return j & 4 ? q1 : q0;
  }
  __device__ __forceinline__ static unsigned bit(const PrunedSlice& sl, int b) {
    return (word(sl, b >> 5) >> (b & 31)) & 1u;
  }
  __device__ __forceinline__ float value(float v, unsigned on, float th, int ix, int f) const {
    const bool consumed = v > th || (v == th && f <= ix);
    return on && !consumed ? v : neg_inf;
  }

  __device__ __forceinline__ PrunedSlice slice(long long row, int, int) const {
    const uint4* p = reinterpret_cast<const uint4*>(bits + row * 8);
    return {__ldg(p), __ldg(p + 1), __ldg(th_lp + row), __ldg(th_ix + row)};
  }
  // a scalar head or tail element: its word and threshold from memory
  __device__ __forceinline__ float operator()(float v, long long row, int f) const {
    const int b = bucket(f);
    const unsigned on = (__ldg(bits + row * 8 + (b >> 5)) >> (b & 31)) & 1u;
    return value(v, on, __ldg(th_lp + row), __ldg(th_ix + row), f);
  }
  // elements f..f+3: with buckets of 4 symbols or more they lie in at most
  // two, b0 and b3, and element t is in b3 iff its symbol reaches b3's first
  __device__ __forceinline__ unsigned fetch(long long, int f, const PrunedSlice& sl) const {
    if (size < 4) {
      unsigned on = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) on |= bit(sl, bucket(f + t)) << t;
      return on;
    }
    const int b0 = bucket(f), b3 = bucket(f + 3);
    const unsigned on0 = bit(sl, b0);
    if (b0 == b3) return on0 * 0xfu;
    const unsigned on3 = bit(sl, b3);
    const int first = b3 * size - 1;  // b3's first token
    unsigned on = 0;
#pragma unroll
    for (int t = 0; t < 4; ++t) on |= (f + t >= first ? on3 : on0) << t;
    return on;
  }
  __device__ __forceinline__ float4 apply4(float4 v, unsigned on, long long, int f,
                                           const PrunedSlice& sl) const {
    return make_float4(value(v.x, on & 1u, sl.th, sl.ix, f),
                       value(v.y, (on >> 1) & 1u, sl.th, sl.ix, f + 1),
                       value(v.z, (on >> 2) & 1u, sl.th, sl.ix, f + 2),
                       value(v.w, on >> 3, sl.th, sl.ix, f + 3));
  }
};

template <class Load>
int launch(const float* x, long long n_rows, int width, int k, int threads, int splits, int slice,
           int staged, int cap, int n2, int region, int smem, u64* gbuf, float* vals,
           long long* idx, Load load, cudaStream_t stream) {
  const int err = radix_topk(x, n_rows, width, k, threads, splits, slice, staged, cap, n2, region,
                             smem, gbuf, vals, idx, load, stream);
  if (err || gbuf == nullptr) return err;
  return global_sort(gbuf, n_rows, n2, k, TopkOut{vals, idx, k}, stream);
}

// the leader's sort buffer of 16384 words (128 KB); past it the global sort
constexpr int MAX_K = 16384;

bool bad_layout(int k, int threads, int splits, int n2, const u64* scratch) {
  return splits < 1 || splits > 16 || (threads != 512 && threads != 1024) ||
         (scratch == nullptr) != (k <= MAX_K) ||
         (scratch != nullptr && (n2 < k || n2 % GTILE != 0));
}

}  // namespace

extern "C" {

// Largest k sorted in shared memory: the leader's sort buffer of 16384
// words (128 KB).  Past it the large-k route sorts in global memory.
long long seal_row_topk_max_k() { return MAX_K; }

// Bytes of bins before the staged keys (kernels/row_topk.py:plan's region):
// the leader's output buffer reuses them where n2 <= 2048.
long long seal_row_topk_bins_bytes() { return BINS_BYTES; }

// One call: n_rows clusters of `splits` CTAs of `threads` (512 or 1024)
// threads (kernels/row_topk.py:plan gives the layout), one launch; with
// `scratch` ([n_rows, n2] words, k > 16384) the select kernel fills it and
// the global sort's launches follow.
int seal_row_topk(const float* x, long long n_rows, int width, int k, int threads, int splits,
                  int slice, int staged, int cap, int n2, int region, int smem, u64* scratch,
                  float* vals, long long* idx, void* stream) {
  if (n_rows <= 0) return (int)cudaGetLastError();
  if (bad_layout(k, threads, splits, n2, scratch)) return (int)cudaErrorInvalidValue;
  return launch(x, n_rows, width, k, threads, splits, slice, staged, cap, n2, region, smem, scratch,
                vals, idx, RawValue{}, (cudaStream_t)stream);
}

// The straggler round's select (PrunedLoad): lp [n_rows, width] f32, bits
// [n_rows, 8] (16-byte aligned), th_lp [n_rows] f32, th_ix [n_rows] int32,
// every token's bucket (token + 1) / bucket_size below 256; the layout
// and the large-k route as seal_row_topk's.
int seal_pruned_topk(const float* x, const unsigned* bits, const float* th_lp, const int* th_ix,
                     long long n_rows, int width, int k, int bucket_size, float neg_inf,
                     int threads, int splits, int slice, int staged, int cap, int n2, int region,
                     int smem, u64* scratch, float* vals, long long* idx, void* stream) {
  if (n_rows <= 0) return (int)cudaGetLastError();
  if (bad_layout(k, threads, splits, n2, scratch) || bucket_size < 1 ||
      width / bucket_size >= 256 || ((unsigned long long)bits & 15))
    return (int)cudaErrorInvalidValue;
  int shift = -1;
  if ((bucket_size & (bucket_size - 1)) == 0)
    for (shift = 0; (1 << shift) < bucket_size; ++shift) {
    }
  const PrunedLoad load{bits, th_lp, th_ix, FastDiv((unsigned)bucket_size), bucket_size, shift,
                        neg_inf};
  return launch(x, n_rows, width, k, threads, splits, slice, staged, cap, n2, region, smem, scratch,
                vals, idx, load, (cudaStream_t)stream);
}

}  // extern "C"
