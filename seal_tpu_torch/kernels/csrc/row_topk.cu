// Kernel 3: exact row top-k with lax.top_k's order (value descending,
// index ascending on ties), by a split-row radix select.
//
// Replaces seal_tpu/decoding/constrained.py: _exact_topk and every
// lax.top_k of the decode path (_top_idx, the proposal loop, step 0).
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

int launch(const float* x, long long n_rows, int width, int k, int threads, int splits, int slice,
           int staged, int cap, int n2, int region, int smem, u64* gbuf, float* vals,
           long long* idx, cudaStream_t stream) {
  const int err = radix_topk(x, n_rows, width, k, threads, splits, slice, staged, cap, n2, region,
                             smem, gbuf, vals, idx, RawValue{}, stream);
  if (err || gbuf == nullptr) return err;
  return global_sort(gbuf, n_rows, n2, k, TopkOut{vals, idx, k}, stream);
}

}  // namespace

extern "C" {

// Largest k sorted in shared memory: the leader's sort buffer of 16384
// words (128 KB).  Past it the large-k route sorts in global memory.
long long seal_row_topk_max_k() { return 16384; }

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
  if (splits < 1 || splits > 16 || (threads != 512 && threads != 1024) ||
      (scratch == nullptr) != (k <= seal_row_topk_max_k()) ||
      (scratch != nullptr && (n2 < k || n2 % GTILE != 0)))
    return (int)cudaErrorInvalidValue;
  return launch(x, n_rows, width, k, threads, splits, slice, staged, cap, n2, region, smem, scratch,
                vals, idx, (cudaStream_t)stream);
}

}  // extern "C"
