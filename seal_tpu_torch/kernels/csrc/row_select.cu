// Kernel 19: the k-th largest value of each row, as the k-th-value mode of
// kernel 3's split-row radix select (radix_topk.cuh).
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
  return radix_topk<true>(x, n_rows, width, k, threads, splits, slice, staged, cap, n2, region,
                          smem, nullptr, kth, nullptr, RawValue{}, (cudaStream_t)stream);
}

}  // extern "C"
