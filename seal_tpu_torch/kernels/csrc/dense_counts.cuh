// The dense continuation-count vector of kernels 15 (Psi layout,
// fm_search.cu) and 16 (compact and hybrid wavelet layouts, wt_search.cu):
// for each range [lo, hi) and every token t < vocab, the number of BWT rows
// of the range that hold shifted symbol t + 1.
//
// One block per (range, slice of up to SLICE tokens), in one of two routes
// chosen per range (the choice is uniform over the block):
//
// * histogram, when the range has at most hist_max rows: the block reads
//   the range's rows once (a layout's `symbol(row)`) and counts those that
//   fall in its slice in shared memory.  O(hi - lo) reads per slice in place
//   of O(slice * log N) dependent ones, and most decode ranges after step 1
//   are narrow.  The sentinel (token -1) and corpus symbols past the model
//   vocab fall outside every slice and are never counted.
// * rank, otherwise: one thread per token of the slice takes both bounds'
//   rank with the layout's own search (`rank(c, pos)`, which may carry a
//   per-symbol offset: only the difference is used).  A token whose symbol
//   is not below the layout's sigma counts 0, as the plain backward step.
//
// Both routes give Occ(c, hi) - Occ(c, lo) (0 for an empty or inverted
// range), so the result equals the plain token sweep exactly.  Bound on the
// card: the [ranges, vocab] int32 output (96 MB a decode step at the
// generation point) and, on the rank route, chains of dependent index reads.
// The histogram route wants resident blocks: a layout names the blocks of
// 512 an SM must hold (``MIN_BLOCKS``), which caps the registers a thread.

#pragma once

#include <cuda_runtime.h>

namespace seal_dense {

constexpr int SHIFT = 1;  // real token ids are stored +1; 0 is the sentinel
constexpr int THREADS = 512;
constexpr int SLICE = 8192;  // tokens a block counts: a 32 KB shared histogram

// The histogram route for tokens [t0, t1) of rows [r0, r1) (clamped to the
// index): a shared histogram of SLICE ints, written to row_out[t0, t1).
// Both routes run in blocks of THREADS.
template <typename Layout>
__device__ void hist_slice(const Layout& ix, int r0, int r1, int t0, int t1, int* row_out,
                           int* hist) {
  for (int i = threadIdx.x; i < t1 - t0; i += THREADS) hist[i] = 0;
  __syncthreads();
  for (int row = r0 + threadIdx.x; row < r1; row += THREADS) {
    const int tok = ix.symbol(row) - SHIFT;
    if (tok >= t0 && tok < t1) atomicAdd(hist + (tok - t0), 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < t1 - t0; i += THREADS) row_out[t0 + i] = hist[i];
}

// The rank route for tokens [t0, t1) of the range [l, h): both bounds'
// ranks a token.
template <typename Layout>
__device__ void rank_slice(const Layout& ix, int l, int h, int t0, int t1, int* row_out) {
  for (int t = t0 + threadIdx.x; t < t1; t += THREADS) {
    const int c = t + SHIFT;
    row_out[t] = ix.valid(c) ? max(ix.rank(c, h) - ix.rank(c, l), 0) : 0;
  }
}

template <typename Layout>
__global__ void __launch_bounds__(THREADS, Layout::MIN_BLOCKS)
dense_counts_kernel(Layout ix, const int* __restrict__ lo, const int* __restrict__ hi,
                    int* __restrict__ out, int vocab, int hist_max) {
  __shared__ int hist[SLICE];
  const long long r = blockIdx.x;
  const int t0 = blockIdx.y * SLICE;
  const int t1 = min(t0 + SLICE, vocab);
  const int l = lo[r], h = hi[r];
  int* row_out = out + r * vocab;
  const int r0 = min(max(l, 0), ix.n_rows), r1 = min(max(h, 0), ix.n_rows);
  if (r1 - r0 <= hist_max) {
    hist_slice(ix, r0, r1, t0, t1, row_out, hist);
  } else {
    rank_slice(ix, l, h, t0, t1, row_out);
  }
}

template <typename Layout>
int launch_dense_counts(const Layout& ix, const int* lo, const int* hi, int* out, long long n,
                        int vocab, int hist_max, cudaStream_t stream) {
  if (n > 0 && vocab > 0) {
    const dim3 grid((unsigned)n, (unsigned)((vocab + SLICE - 1) / SLICE));
    dense_counts_kernel<Layout><<<grid, THREADS, 0, stream>>>(ix, lo, hi, out, vocab, hist_max);
  }
  return (int)cudaGetLastError();
}

}  // namespace seal_dense
