// Kernel 1: FM-index rank search over the Psi layout; kernel 5, the same
// search chained over padded sequences (sequences_kernel below); and kernel
// 15, the dense count vector of every token over a range (PsiDense below,
// with dense_counts.cuh).
//
// Replaces seal_tpu/ops/fm_ops.py: _symbol_bounds + _searchsorted_impl +
// backward_step (mode "backward_step") and contains_tokens (mode
// "contains").  Occ(c, pos) is the number of psi entries < pos inside
// symbol c's strictly increasing psi block [C[c], C[c+1]); the search is a
// binary search over that block, first narrowed by the packed symbol row
// sym_dir[c] = (C[c], C[c+1], head_id, 0) and, for frequent ("head")
// symbols, by head_pair, which pins the search to one position block.
//
// Bound on the card: latency.  Every iteration is a dependent 4-byte load
// from psi (4.8 MB at the 1.2M-token operating point, so it lives in the
// 50 MB L2 after the first queries), and a query is ~8-20 of them in a
// chain.  The design keeps many independent chains in flight: one thread
// per (query, bound) and no shared memory, so occupancy is the limit; the
// two bounds of a backward step run in neighbouring threads and meet with
// one warp shuffle.  The TPU's 128-row vector finish (psi_blk) is not
// carried over: a GPU thread reads psi directly.

#include <cuda_runtime.h>

#include "dense_counts.cuh"

namespace {

constexpr int SHIFT = 1;  // real token ids are stored +1; 0 is the sentinel
constexpr int THREADS = 256;

struct Bounds {
  int blo, bhi, dlo, dhi;
};

__device__ __forceinline__ Bounds symbol_bounds(const int* __restrict__ sym_dir,
                                                const int* __restrict__ head_pair,
                                                int n_rows, int dir_shift, int c,
                                                int pos) {
  const int4 d = __ldg(reinterpret_cast<const int4*>(sym_dir) + c);
  Bounds b{d.x, d.y, d.x, d.y};
  if (head_pair != nullptr && d.z >= 0) {
    const int p = min(max(pos, 0), n_rows);
    const long long nb1 = (long long)(n_rows >> dir_shift) + 1;
    const int2 pr =
        __ldg(reinterpret_cast<const int2*>(head_pair) + (long long)d.z * nb1 + (p >> dir_shift));
    b.dlo = d.x + pr.x;
    b.dhi = d.x + pr.y;
  }
  return b;
}

// smallest i in [lo, hi] with psi[i] >= pos (psi[lo:hi) increasing)
__device__ __forceinline__ int search(const int* __restrict__ psi, int lo, int hi, int pos) {
  while (lo < hi) {
    const int mid = (int)(((unsigned)lo + (unsigned)hi) >> 1);
    if (__ldg(psi + mid) < pos) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
backward_step_kernel(const int* __restrict__ psi, const int* __restrict__ sym_dir,
                     const int* __restrict__ head_pair, int n_rows, int sigma, int dir_shift,
                     const int* __restrict__ token, const int* __restrict__ lo,
                     const int* __restrict__ hi, int* __restrict__ out_lo,
                     int* __restrict__ out_hi, long long n) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long q = t >> 1;
  const int bound = (int)(t & 1);
  const bool active = q < n;
  int row = 0;
  if (active) {
    const int c = token[q] + SHIFT;
    if (c >= 1 && c < sigma) {
      const int pos = bound ? hi[q] : lo[q];
      const Bounds b = symbol_bounds(sym_dir, head_pair, n_rows, dir_shift, c, pos);
      row = search(psi, b.dlo, b.dhi, pos);
    }
  }
  // the pair (q, 0), (q, 1) sits in neighbouring lanes of one warp
  const int other = __shfl_xor_sync(0xffffffffu, row, 1);
  if (active) {
    if (bound == 0) {
      out_lo[q] = row;
    } else {
      out_hi[q] = max(other, row);  // new_hi = max(new_lo, new_hi)
    }
  }
}

__global__ void __launch_bounds__(THREADS)
contains_kernel(const int* __restrict__ psi, const int* __restrict__ sym_dir,
                const int* __restrict__ head_pair, int n_rows, int sigma, int dir_shift,
                const int* __restrict__ tokens, const int* __restrict__ lo,
                const int* __restrict__ hi, unsigned char* __restrict__ out, long long n, int m) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= n * m) return;
  const long long r = t / m;
  const int c = tokens[t] + SHIFT;
  bool ok = false;
  if (c >= 1 && c < sigma) {
    const int l = lo[r];
    const Bounds b = symbol_bounds(sym_dir, head_pair, n_rows, dir_shift, c, l);
    const int row = search(psi, b.dlo, b.dhi, l);
    // row < bhi: psi[row] is the symbol's first occurrence at or after lo
    ok = row < b.bhi && __ldg(psi + row) < hi[r];
  }
  out[t] = ok ? 1 : 0;
}

// Kernel 5: row ranges of padded token sequences (replaces
// seal_tpu/ops/_generic.py:range_for_sequences, the lax.scan of backward
// steps behind fm_ops.range_for_sequences and count_sequences).  The same
// lane pair as backward_step_kernel, looping over the sequence in
// registers: one launch for the whole chain instead of one per position.
// The trip count is L for every lane, so each lane reaches the shuffle;
// positions at or past a sequence's length leave its range as it is, and
// an empty range stays at (x, x) unless an out-of-range token resets it
// to (0, 0), as the scan does.
__global__ void __launch_bounds__(THREADS)
sequences_kernel(const int* __restrict__ psi, const int* __restrict__ sym_dir,
                 const int* __restrict__ head_pair, int n_rows, int sigma, int dir_shift,
                 const int* __restrict__ tokens, const int* __restrict__ lengths,
                 int* __restrict__ out_lo, int* __restrict__ out_hi, long long n, int L) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long q = t >> 1;
  const int bound = (int)(t & 1);
  const bool active = q < n;
  const int len = active ? lengths[q] : 0;
  int lo = 0, hi = n_rows;
  for (int j = 0; j < L; ++j) {
    const bool keep = j < len;
    int row = 0;  // an out-of-range token gives (0, 0)
    if (keep) {
      const int c = tokens[q * L + j] + SHIFT;
      if (c >= 1 && c < sigma) {
        const int pos = bound ? hi : lo;
        const Bounds b = symbol_bounds(sym_dir, head_pair, n_rows, dir_shift, c, pos);
        row = search(psi, b.dlo, b.dhi, pos);
      }
    }
    const int other = __shfl_xor_sync(0xffffffffu, row, 1);
    if (keep) {
      lo = bound ? other : row;
      hi = max(lo, bound ? row : other);
    }
  }
  if (active) {
    if (bound == 0) {
      out_lo[q] = lo;
    } else {
      out_hi[q] = hi;
    }
  }
}

// Kernel 15: replaces seal_tpu/ops/fm_ops.py:dense_counts (:339) through
// seal_tpu/ops/_generic.py:dense_counts (:75) and validate_tokens (:66): the
// plain version sweeps the vocab a chunk at a time through backward steps.
// The histogram route reads the Psi index's int32 BWT; the rank route is
// kernel 1's search at both bounds.
struct PsiDense {
  const int* psi;
  const int* sym_dir;
  const int* head_pair;
  const int* bwt;
  int n_rows, sigma, dir_shift;

  __device__ bool valid(int c) const { return c >= 1 && c < sigma; }
  __device__ int rank(int c, int pos) const {
    const Bounds b = symbol_bounds(sym_dir, head_pair, n_rows, dir_shift, c, pos);
    return search(psi, b.dlo, b.dhi, pos);
  }
  __device__ int symbol(int row) const { return __ldg(bwt + row); }
};

}  // namespace

extern "C" int seal_fm_dense_counts(const int* psi, const int* sym_dir, const int* head_pair,
                                    int n_rows, int sigma, int dir_shift, const int* bwt,
                                    const int* lo, const int* hi, int* out, long long n, int vocab,
                                    int hist_max, void* stream) {
  const PsiDense ix{psi, sym_dir, head_pair, bwt, n_rows, sigma, dir_shift};
  return seal_dense::launch_dense_counts(ix, lo, hi, out, n, vocab, hist_max,
                                         (cudaStream_t)stream);
}

extern "C" int seal_fm_sequences(const int* psi, const int* sym_dir, const int* head_pair,
                                 int n_rows, int sigma, int dir_shift, const int* tokens,
                                 const int* lengths, int* out_lo, int* out_hi, long long n, int L,
                                 void* stream) {
  if (n > 0) {
    const long long threads = 2 * n;
    const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
    sequences_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        psi, sym_dir, head_pair, n_rows, sigma, dir_shift, tokens, lengths, out_lo, out_hi, n, L);
  }
  return (int)cudaGetLastError();
}

extern "C" int seal_fm_backward_step(const int* psi, const int* sym_dir, const int* head_pair,
                                     int n_rows, int sigma, int dir_shift, const int* token,
                                     const int* lo, const int* hi, int* out_lo, int* out_hi,
                                     long long n, void* stream) {
  if (n > 0) {
    const long long threads = 2 * n;
    const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
    backward_step_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        psi, sym_dir, head_pair, n_rows, sigma, dir_shift, token, lo, hi, out_lo, out_hi, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int seal_fm_contains(const int* psi, const int* sym_dir, const int* head_pair,
                                int n_rows, int sigma, int dir_shift, const int* tokens,
                                const int* lo, const int* hi, unsigned char* out, long long n,
                                int m, void* stream) {
  if (n > 0 && m > 0) {
    const long long threads = n * m;
    const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
    contains_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        psi, sym_dir, head_pair, n_rows, sigma, dir_shift, tokens, lo, hi, out, n, m);
  }
  return (int)cudaGetLastError();
}
