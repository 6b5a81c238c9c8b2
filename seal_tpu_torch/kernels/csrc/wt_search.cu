// Kernel 12: FM-index rank search over the 16-ary wavelet layouts (compact
// and hybrid), in three modes; and kernel 16, their dense count vector
// (WtDense below, with dense_counts.cuh).
//
// Replaces seal_tpu/ops/wt_ops.py: rank (:96) with _load_block,
// _match_nibbles, _rank_from_block and _rank_digit, behind backward_step
// (:136, mode "backward_step"), contains_tokens (:184, == validate > 0,
// mode "contains") and the scan of backward steps behind
// range_for_sequences (:167) and count_sequences (mode "sequences", one
// launch for the whole chain); and, in seal_tpu/decoding/constrained.py,
// the range update after a selection (:1416-1430; step 0 :1344-1349) as
// one launch (mode "advance").  The new range of token t over [lo, hi) is
// (C[c] + Occ(c, lo), C[c] + Occ(c, hi)) with c = t + 1; a token outside
// [0, sigma - 1) gives the empty range (0, 0).
//
// Bound on the card: latency.  Occ(c, pos) descends `digits` levels (4 for
// a 16-bit alphabet); each level reads its node's start and start rank,
// then one 192-byte block (its directory word and up to eight 16-byte code
// loads), so the bytes are few and the chain is all.  The node words depend
// on the symbol alone: wt_common.cuh's rank loads every level's first, so
// the chain is one round of table loads and `digits` block rounds; each
// kernel is built for every digit count and the host launches the index's
// (seal_wt::with_digits).  One
// thread per (query, bound), no shared memory: occupancy keeps many chains
// in flight.  The two bounds of a query run in neighbouring lanes and meet
// with one warp shuffle, as in fm_search.cu.

#include "dense_counts.cuh"
#include "wt_common.cuh"

namespace {

using seal_wt::Index;
using seal_wt::SHIFT;

constexpr int THREADS = 256;

// C[c] + Occ(c, pos) for an unshifted token, or 0 when it is out of range
template <int L>
__device__ __forceinline__ int step_bound(const Index& ix, int token, int pos) {
  const int c = token + SHIFT;
  if (c < 1 || c >= ix.sigma) return 0;
  return __ldg(ix.C + c) + seal_wt::rank<L>(ix, c, pos);
}

template <int L>
__global__ void __launch_bounds__(THREADS)
backward_step_kernel(Index ix, const int* __restrict__ token, const int* __restrict__ lo,
                     const int* __restrict__ hi, int* __restrict__ out_lo,
                     int* __restrict__ out_hi, long long n) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long q = t >> 1;
  const int bound = (int)(t & 1);
  const bool active = q < n;
  const int row = active ? step_bound<L>(ix, token[q], bound ? hi[q] : lo[q]) : 0;
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

// membership of token j of range r: Occ(c, hi) > Occ(c, lo), one lane each
template <int L>
__global__ void __launch_bounds__(THREADS)
contains_kernel(Index ix, const int* __restrict__ tokens, const int* __restrict__ lo,
                const int* __restrict__ hi, unsigned char* __restrict__ out, long long n,
                int m) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long q = t >> 1;  // flat (range, token) index
  const int bound = (int)(t & 1);
  const bool active = q < n * m;
  int row = 0;
  bool valid = false;
  if (active) {
    const long long r = q / m;
    const int c = tokens[q] + SHIFT;
    valid = c >= 1 && c < ix.sigma;
    if (valid) row = seal_wt::rank<L>(ix, c, bound ? hi[r] : lo[r]);
  }
  const int other = __shfl_xor_sync(0xffffffffu, row, 1);
  if (active && bound == 0) out[q] = (valid && other > row) ? 1 : 0;
}

// The range update after a selection: selection q of query b extends
// parent sel_par[q] of b's P ranges by sel_tok[q] (a lane pair, one bound
// each), and writes the parent's range size; with `finished` (steps >= 1)
// an EOS or PAD token or a finished parent gives (0, 0) with no search.
template <int L>
__global__ void __launch_bounds__(THREADS)
advance_kernel(Index ix, const int* __restrict__ lo, const int* __restrict__ hi, int P,
               const int* __restrict__ sel_par, const int* __restrict__ sel_tok,
               const unsigned char* __restrict__ finished, int eos, int pad,
               int* __restrict__ out_lo, int* __restrict__ out_hi, int* __restrict__ out_count,
               long long n, int n_sel) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long q = t >> 1;
  const int bound = (int)(t & 1);
  const bool active = q < n;
  int row = 0;
  if (active) {
    const long long parent = q / n_sel * P + sel_par[q];
    const int plo = lo[parent], phi = hi[parent], tok = sel_tok[q];
    const bool stop = finished != nullptr && (tok == eos || tok == pad || finished[parent] != 0);
    if (!stop) row = step_bound<L>(ix, tok, bound ? phi : plo);
    if (bound == 0) out_count[q] = phi - plo;
  }
  const int other = __shfl_xor_sync(0xffffffffu, row, 1);
  if (active) {
    if (bound == 0) {
      out_lo[q] = row;
    } else {
      out_hi[q] = max(other, row);
    }
  }
}

// Row ranges of padded token sequences: the lane pair of
// backward_step_kernel loops over the sequence in registers.  The trip
// count is len_max for every lane, so each lane reaches the shuffle;
// positions at or past a sequence's length leave its range as it is.
template <int L>
__global__ void __launch_bounds__(THREADS)
sequences_kernel(Index ix, const int* __restrict__ tokens, const int* __restrict__ lengths,
                 int* __restrict__ out_lo, int* __restrict__ out_hi, long long n, int len_max) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long q = t >> 1;
  const int bound = (int)(t & 1);
  const bool active = q < n;
  const int len = active ? lengths[q] : 0;
  int lo = 0, hi = ix.n_rows;
  for (int j = 0; j < len_max; ++j) {
    const bool keep = j < len;
    const int row = keep ? step_bound<L>(ix, tokens[q * len_max + j], bound ? hi : lo) : 0;
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

// Kernel 16: replaces seal_tpu/ops/wt_ops.py:dense_counts (:237) through
// seal_tpu/ops/_generic.py:dense_counts (:75) and wt_ops.validate_tokens
// (:180).  The histogram route reads each row's symbol (one read of the
// hybrid layout's raw BWT, or the compact layout's descent); the rank route
// descends both bounds.  The validity gate is the true alphabet `sigma`,
// not the wider `sigma_bound` the digits are sized for.
template <int BWT_BYTES, int L>
struct WtDense {
  // the hybrid layout (a raw BWT) histograms all but the widest ranges and
  // wants 3 blocks an SM (at most 40 registers a thread): uncapped, its
  // unrolled descents take 62 registers at 4 digits, 2 blocks fit, and its
  // histogram route runs a quarter slower on an H100; the compact layout's
  // descent-bound routes run faster uncapped (python -m
  // seal_tpu_torch.bench_select, "k16 dense counts")
  static constexpr int MIN_BLOCKS = BWT_BYTES ? 3 : 1;
  Index ix;
  const void* bwt;
  int n_rows;

  __device__ bool valid(int c) const { return c >= 1 && c < ix.sigma; }
  __device__ int rank(int c, int pos) const { return seal_wt::rank<L>(ix, c, pos); }
  __device__ int symbol(int row) const { return seal_wt::symbol_at<BWT_BYTES>(ix, bwt, row); }
};

unsigned blocks_for(long long threads) {
  return (unsigned)((threads + THREADS - 1) / THREADS);
}

}  // namespace

// Each entry point launches its kernel's instance for the index's digit
// count (seal_wt::with_digits: cudaErrorInvalidValue past 5 digits).

extern "C" int seal_wt_backward_step(const uint32_t* blocks, const int* node_start,
                                     const int* node_cnt, const int* C, long long n_blocks,
                                     int n_rows, int digits, int sigma, const int* token,
                                     const int* lo, const int* hi, int* out_lo, int* out_hi,
                                     long long n, void* stream) {
  const Index ix{blocks, node_start, node_cnt, C, n_blocks, n_rows, digits, sigma};
  return seal_wt::with_digits(digits, [&](auto D) {
    constexpr int L = decltype(D)::value;
    if (n > 0)
      backward_step_kernel<L><<<blocks_for(2 * n), THREADS, 0, (cudaStream_t)stream>>>(
          ix, token, lo, hi, out_lo, out_hi, n);
    return (int)cudaGetLastError();
  });
}

extern "C" int seal_wt_contains(const uint32_t* blocks, const int* node_start,
                                const int* node_cnt, const int* C, long long n_blocks,
                                int n_rows, int digits, int sigma, const int* tokens,
                                const int* lo, const int* hi, unsigned char* out, long long n,
                                int m, void* stream) {
  const Index ix{blocks, node_start, node_cnt, C, n_blocks, n_rows, digits, sigma};
  return seal_wt::with_digits(digits, [&](auto D) {
    constexpr int L = decltype(D)::value;
    if (n > 0 && m > 0)
      contains_kernel<L><<<blocks_for(2 * n * m), THREADS, 0, (cudaStream_t)stream>>>(
          ix, tokens, lo, hi, out, n, m);
    return (int)cudaGetLastError();
  });
}

// lo, hi [n / n_sel, P]; sel_par, sel_tok, out_* [n / n_sel, n_sel];
// finished [n / n_sel, P] or null (step 0: no stop rule)
extern "C" int seal_wt_advance(const uint32_t* blocks, const int* node_start, const int* node_cnt,
                               const int* C, long long n_blocks, int n_rows, int digits,
                               int sigma, const int* lo, const int* hi, int P, const int* sel_par,
                               const int* sel_tok, const unsigned char* finished, int eos, int pad,
                               int* out_lo, int* out_hi, int* out_count, long long n, int n_sel,
                               void* stream) {
  const Index ix{blocks, node_start, node_cnt, C, n_blocks, n_rows, digits, sigma};
  return seal_wt::with_digits(digits, [&](auto D) {
    constexpr int L = decltype(D)::value;
    if (n > 0)
      advance_kernel<L><<<blocks_for(2 * n), THREADS, 0, (cudaStream_t)stream>>>(
          ix, lo, hi, P, sel_par, sel_tok, finished, eos, pad, out_lo, out_hi, out_count, n,
          n_sel);
    return (int)cudaGetLastError();
  });
}

extern "C" int seal_wt_sequences(const uint32_t* blocks, const int* node_start,
                                 const int* node_cnt, const int* C, long long n_blocks,
                                 int n_rows, int digits, int sigma, const int* tokens,
                                 const int* lengths, int* out_lo, int* out_hi, long long n,
                                 int len_max, void* stream) {
  const Index ix{blocks, node_start, node_cnt, C, n_blocks, n_rows, digits, sigma};
  return seal_wt::with_digits(digits, [&](auto D) {
    constexpr int L = decltype(D)::value;
    if (n > 0)
      sequences_kernel<L><<<blocks_for(2 * n), THREADS, 0, (cudaStream_t)stream>>>(
          ix, tokens, lengths, out_lo, out_hi, n, len_max);
    return (int)cudaGetLastError();
  });
}

extern "C" int seal_wt_dense_counts(const uint32_t* blocks, const int* node_start,
                                    const int* node_cnt, const int* C, long long n_blocks,
                                    int n_rows, int digits, int sigma, const void* bwt,
                                    int bwt_bytes, const int* lo, const int* hi, int* out,
                                    long long n, int vocab, int hist_max, void* stream) {
  const Index ix{blocks, node_start, node_cnt, C, n_blocks, n_rows, digits, sigma};
  cudaStream_t s = (cudaStream_t)stream;
  return seal_wt::with_digits(digits, [&](auto D) {
    constexpr int L = decltype(D)::value;
    if (bwt == nullptr)
      return seal_dense::launch_dense_counts(WtDense<0, L>{ix, bwt, n_rows}, lo, hi, out, n,
                                             vocab, hist_max, s);
    if (bwt_bytes == 2)
      return seal_dense::launch_dense_counts(WtDense<2, L>{ix, bwt, n_rows}, lo, hi, out, n,
                                             vocab, hist_max, s);
    if (bwt_bytes == 4)
      return seal_dense::launch_dense_counts(WtDense<4, L>{ix, bwt, n_rows}, lo, hi, out, n,
                                             vocab, hist_max, s);
    return (int)cudaErrorInvalidValue;
  });
}
