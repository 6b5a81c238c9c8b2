// Kernel 19: the k-th largest value of each row, as the k-th-value mode of
// kernel 3's split-row radix select (radix_topk.cuh); and the top-k warper
// with kernel 4's masked log-softmax, as the select's warper mode (below).
//
// Replaces, in seal_tpu/decoding/constrained.py, lax.top_k(logits,
// topk)[0][..., -1:] of the top-k warper (_apply_topk_warper :289-294).
//
// The order is lax.top_k's: value descending in f32's total order (+0.0
// above -0.0).  Each element maps to a 32-bit key whose unsigned order is
// that order, so the value written is the row's own, bit for bit, and the
// kernel equals the plain version (kernels/row_select.py:row_kth_plain)
// exactly.
//
// Bound on the card: one read of the row from device memory (0.0288 ms at
// [480, 50265] f32 at 3.35 TB/s).
//
// Design: kernel 3's select (row_topk.cu's header sets it out) with its
// output cut off.  A row is a cluster of `splits` CTAs (kernels/row_select.py
// picks the layout from kernels/row_topk.py:plan), each staging its slice
// once with 16-byte loads; three digit passes of 11, 11 and 10 bits, most
// significant first, sum their histograms over the cluster through
// distributed shared memory, and after the last one every CTA knows the
// row's k-th key.  The cluster's first CTA writes its value.  No survivor
// is gathered, placed or sorted, and no index is written.
//
// The warper (seal_topk_log_softmax) replaces, in the same file,
// _apply_topk_warper (:289-294), _log_softmax (:276) and _apply_min_length
// (:297) together: x < T becomes fill (NEG_INF, f32 min / 2, not -inf; a
// key equal to T survives), then the f32 log-softmax, then the banned
// column (EOS under min_length) becomes fill, so its exp still counts in
// the sum.  It replaces kernel 19 followed by kernel 4's threshold mode,
// which read each row four times: the same launch finds T as kernel 19
// does and goes on over the row it holds on chip (radix_topk.cuh's
// OUT_WARP): the max is the largest key, the sum of exps runs over the
// survivors only (a masked column adds exp(fill - max), 0 in practice),
// and every masked column gets the one value (fill - max) - log s.  Bound:
// one read of the row and one write (0.0576 ms at [480, 50265] f32 at
// 3.35 TB/s).  The values agree with the plain version
// (kernels/row_select.py:topk_log_softmax_plain) to the f32 rounding of
// the sum, taken in another order; the masked set is exact.

#include <cuda_runtime.h>

#include "radix_topk.cuh"

extern "C" {

// One call: n_rows clusters of `splits` CTAs of `threads` (512 or 1024)
// threads, laid out by kernels/row_topk.py:plan(..., kth=True); kth [n_rows].
int seal_row_kth(const float* x, long long n_rows, int width, int k, int threads, int splits,
                 int slice, int staged, int cap, int n2, int region, int smem, float* kth,
                 void* stream) {
  if (n_rows <= 0) return (int)cudaGetLastError();
  if (splits < 1 || splits > 16 || (threads != 512 && threads != 1024) || k < 1 || k > width)
    return (int)cudaErrorInvalidValue;
  return radix_topk<OUT_KTH>(x, n_rows, width, k, threads, splits, slice, staged, cap, n2,
                             region, smem, nullptr, kth, nullptr, RawValue{},
                             (cudaStream_t)stream);
}

// The warper: logits x [n_rows, width] f32 contiguous, out the same shape;
// the layout of row_select.py:plan (kernel 19's); ban: the column set to
// fill after the normalization (-1: none).
int seal_topk_log_softmax(const float* x, long long n_rows, int width, int k, int threads,
                          int splits, int slice, int staged, int cap, int n2, int region, int smem,
                          int ban, float fill, float* out, void* stream) {
  if (n_rows <= 0) return (int)cudaGetLastError();
  if (splits < 1 || splits > MAX_CLUSTER || (threads != 512 && threads != 1024) || k < 1 ||
      k > width)
    return (int)cudaErrorInvalidValue;
  return radix_topk<OUT_WARP>(x, n_rows, width, k, threads, splits, slice, staged, cap, n2,
                              region, smem, nullptr, out, nullptr, WarperLoad{ban, fill},
                              (cudaStream_t)stream);
}

}  // extern "C"
