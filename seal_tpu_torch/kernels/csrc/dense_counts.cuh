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
//
// The mask modes (kernels/count_mask.py) write a bit a token in place of a
// count: words W = 4 * ceil(vocab / 128) a range, bit t set iff the count
// of token t is > 0, the padding bits 0.  The helpers below set a token's
// bit in a shared bitset (reading the word first: hot tokens repeat, and a
// set bit needs no atomic), and read a range's int32 rows 16 bytes at a
// time into one (fm_search.cu's mask kernel); kernel 16's histogram route
// keeps its slice a block and sets the bits of a slice's 256 words.

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

// set token tok's bit in the shared bitset `bits`
__device__ __forceinline__ void set_bit(unsigned* bits, int tok) {
  const unsigned bit = 1u << (tok & 31);
  unsigned* w = bits + (tok >> 5);
  if (!(*w & bit)) atomicOr(w, bit);
}

// the bit of a shifted BWT symbol, if its token is in [t0, t1) (the
// sentinel and symbols past the vocab never are), at tok - t0
__device__ __forceinline__ void set_symbol(unsigned* bits, int sym, int t0, int t1) {
  const int tok = sym - SHIFT;
  if (tok >= t0 && tok < t1) set_bit(bits, tok - t0);
}

// The mask words of tokens [t0, t1) from a t0 that is a multiple of 128:
// whole 4-word groups (a row's last group holds its padding bits)
__host__ __device__ __forceinline__ int mask_words(int t0, int t1) {
  return (((t1 - t0 + 31) >> 5) + 3) & ~3;
}

// The histogram route's mask: the bits of tokens [t0, t1) (t0 a multiple
// of SLICE) over rows [r0, r1), in a shared bitset of the slice's words,
// written to row_out's words from t0 / 32 (16-byte aligned: a slice owns
// whole 4-word groups), so no two slices write one word.
template <typename Layout>
__device__ void hist_mask_slice(const Layout& ix, int r0, int r1, int t0, int t1,
                                unsigned* row_out, unsigned* bits) {
  const int nw = mask_words(t0, t1);
  for (int i = threadIdx.x; i < nw; i += THREADS) bits[i] = 0;
  __syncthreads();
  for (int row = r0 + threadIdx.x; row < r1; row += THREADS)
    set_symbol(bits, ix.symbol(row), t0, t1);
  __syncthreads();
  uint4* dst = reinterpret_cast<uint4*>(row_out + (t0 >> 5));
  const uint4* src = reinterpret_cast<const uint4*>(bits);
  for (int i = threadIdx.x; i < nw / 4; i += THREADS) dst[i] = src[i];
}

// Rows [a, b) of an int32 BWT into the bitset of tokens [0, vocab): a
// scalar head to 16-byte alignment, then U 16-byte loads a thread a round
// (`nthreads` threads from `tid`), then the scalar tail.
template <int U>
__device__ __forceinline__ void add_rows(const int* __restrict__ sym, int a, int b, int vocab,
                                         unsigned* bits, int tid, int nthreads) {
  if (b <= a) return;
  const int* p = sym + a;
  const int n = b - a;
  const int head = min(n, (int)(((16 - ((unsigned long long)p & 15)) & 15) >> 2));
  if (tid < head) set_symbol(bits, __ldg(p + tid), 0, vocab);
  const int4* v = reinterpret_cast<const int4*>(p + head);
  const int nv = (n - head) >> 2;
  for (int base = 0; base < nv; base += nthreads * U) {
    int4 x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = base + u * nthreads + tid;
      x[u] = q < nv ? __ldg(v + q) : make_int4(0, 0, 0, 0);  // symbol 0: no token
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      set_symbol(bits, x[u].x, 0, vocab);
      set_symbol(bits, x[u].y, 0, vocab);
      set_symbol(bits, x[u].z, 0, vocab);
      set_symbol(bits, x[u].w, 0, vocab);
    }
  }
  const int tail = head + 4 * nv;
  if (tid < n - tail) set_symbol(bits, __ldg(p + tail + tid), 0, vocab);
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
