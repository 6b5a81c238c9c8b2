// Kernel 1: FM-index rank search over the Psi layout; kernel 5, the same
// search chained over padded sequences (sequences_kernel below); and kernel
// 15, the dense count vector of every token over a range (PsiDense below,
// with dense_counts.cuh).
//
// Replaces seal_tpu/ops/fm_ops.py: _symbol_bounds + _searchsorted_impl +
// backward_step (mode "backward_step") and contains_tokens (mode
// "contains"); and, in seal_tpu/decoding/constrained.py, the range update
// after a selection (:1416-1430; step 0 :1344-1349) as one launch (mode
// "advance").  Occ(c, pos) is the number of psi entries < pos inside
// symbol c's strictly increasing psi block [C[c], C[c+1]); the search runs
// over that block, first narrowed by the packed symbol row
// sym_dir[c] = (C[c], C[c+1], head_id, 0) and, for frequent ("head")
// symbols, by head_pair, which pins the search to one position block.
//
// Bound on the card: latency.  Every probe is a dependent 4-byte load from
// psi (4.8 MB at the 1.2M-token operating point, so it lives in the 50 MB
// L2 after the first queries).  A binary search is ~8-20 of them in a
// chain.  The cooperative search (group_search) shortens the chain: a group
// of H lanes loads H pivots of the interval at once, one ballot picks the
// sub-interval between two of them, and the last <= H candidates are one
// contiguous load, so the chain is ~log_{H+1}(n) loads instead of log2(n).
// A (range, token) of "contains" takes a group of G = 2, 4, 8, 16 or 32
// lanes; a backward step or an advance takes G lanes, half for each bound,
// which meet with one shuffle (G = 2: one lane a bound, a binary search).  The group reads the symbol's directory row once
// (one broadcast load).  Kernel 5 and the shard modes keep one thread per
// (query, bound) and the binary search (search below).  The TPU's 128-row
// vector finish (psi_blk) is not carried over: a GPU lane reads psi
// directly.

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

// The smallest i in [lo, hi] with psi[i] >= pos (psi[lo:hi) increasing),
// found by the H lanes of a group: lane g (of the lanes in `gmask`, from
// lane `gbase` of the warp) loads pivot lo + (g + 1) * step, step = n / (H
// + 1) for an interval of n > H rows; the first pivot at or past pos bounds
// the answer from above, the one before it from below, so the interval
// shrinks to at most step + H rows a level (32-bit arithmetic: the pivots
// stay below hi < 2^31).  Every lane of the group gets the answer.
template <int H>
__device__ __forceinline__ int group_search(const int* __restrict__ psi, int lo, int hi, int pos,
                                            int g, unsigned gmask, int gbase) {
  constexpr unsigned LANES = H == 32 ? 0xffffffffu : (1u << H) - 1u;
  if (lo >= hi) return lo;
  while (hi - lo > H) {
    const int step = (int)((unsigned)(hi - lo) / (H + 1));  // >= 1
    const bool ge = __ldg(psi + lo + (g + 1) * step) >= pos;
    const unsigned ball = (__ballot_sync(gmask, ge) >> gbase) & LANES;
    if (ball == 0u) {
      lo += H * step + 1;  // past the last pivot
    } else {
      const int f = __ffs(ball) - 1;  // the first pivot at or past pos
      hi = lo + (f + 1) * step;
      lo += f * step + (f > 0 ? 1 : 0);
    }
  }
  // at most H candidates left: one load each
  const bool ge = g < hi - lo && __ldg(psi + lo + g) >= pos;
  const unsigned ball = (__ballot_sync(gmask, ge) >> gbase) & LANES;
  return ball ? lo + __ffs(ball) - 1 : hi;
}

// Lanes of a warp split into groups of G: this lane's place in its group,
// the group's first lane and its mask.
template <int G>
struct Group {
  int g, base;
  unsigned mask;
  __device__ Group() {
    const int lane = threadIdx.x & 31;
    g = lane % G;
    base = lane - g;
    mask = (G == 32 ? 0xffffffffu : (1u << G) - 1u) << base;
  }
};

// One backward step of range (lo, hi) by shifted symbol c over a group of G
// lanes: lanes [0, G/2) search the lo bound, [G/2, G) the hi bound; every
// lane gets (new_lo, new_hi), (0, 0) for an out-of-range symbol.
template <int G>
__device__ __forceinline__ int2 group_step(const int* __restrict__ psi,
                                           const int* __restrict__ sym_dir,
                                           const int* __restrict__ head_pair, int n_rows,
                                           int sigma, int dir_shift, int c, int lo, int hi,
                                           const Group<G>& gr) {
  constexpr int H = G / 2;
  if (c < 1 || c >= sigma) return make_int2(0, 0);  // uniform over the group
  const bool upper = gr.g >= H;
  const int pos = upper ? hi : lo;
  const Bounds b = symbol_bounds(sym_dir, head_pair, n_rows, dir_shift, c, pos);
  const int half = gr.base + (upper ? H : 0);
  const unsigned hmask = (H == 32 ? 0xffffffffu : (1u << H) - 1u) << half;
  const int row = group_search<H>(psi, b.dlo, b.dhi, pos, gr.g - (upper ? H : 0), hmask, half);
  const int new_lo = __shfl_sync(gr.mask, row, gr.base);
  const int new_hi = __shfl_sync(gr.mask, row, gr.base + H);
  return make_int2(new_lo, max(new_lo, new_hi));  // new_hi = max(new_lo, new_hi)
}

template <int G>
__global__ void __launch_bounds__(THREADS)
backward_step_kernel(const int* __restrict__ psi, const int* __restrict__ sym_dir,
                     const int* __restrict__ head_pair, int n_rows, int sigma, int dir_shift,
                     const int* __restrict__ token, const int* __restrict__ lo,
                     const int* __restrict__ hi, int* __restrict__ out_lo,
                     int* __restrict__ out_hi, long long n) {
  const long long q = ((long long)blockIdx.x * THREADS + threadIdx.x) / G;
  if (q >= n) return;  // uniform over the group
  const Group<G> gr;
  const int2 r = group_step<G>(psi, sym_dir, head_pair, n_rows, sigma, dir_shift,
                               token[q] + SHIFT, lo[q], hi[q], gr);
  if (gr.g == 0) {
    out_lo[q] = r.x;
    out_hi[q] = r.y;
  }
}

// Membership: a group of G lanes per (range, token).  The first row of
// the symbol's block at or after lo, if the block has one, is the token's
// first occurrence in the range when its psi is below hi.
template <int G>
__global__ void __launch_bounds__(THREADS)
contains_kernel(const int* __restrict__ psi, const int* __restrict__ sym_dir,
                const int* __restrict__ head_pair, int n_rows, int sigma, int dir_shift,
                const int* __restrict__ tokens, const int* __restrict__ lo,
                const int* __restrict__ hi, unsigned char* __restrict__ out, long long n, int m) {
  const long long t = ((long long)blockIdx.x * THREADS + threadIdx.x) / G;
  if (t >= n * m) return;  // uniform over the group
  const Group<G> gr;
  const long long r = t / m;
  const int c = tokens[t] + SHIFT;
  bool ok = false;
  if (c >= 1 && c < sigma) {
    const int l = lo[r];
    const Bounds b = symbol_bounds(sym_dir, head_pair, n_rows, dir_shift, c, l);
    const int row = group_search<G>(psi, b.dlo, b.dhi, l, gr.g, gr.mask, gr.base);
    // row < bhi: psi[row] is the symbol's first occurrence at or after lo
    ok = row < b.bhi && __ldg(psi + row) < hi[r];
  }
  if (gr.g == 0) out[t] = ok ? 1 : 0;
}

// The step mode: the range update after a selection, one group of G lanes
// per (query, beam) of [n / n_sel, n_sel] selections over parents [.., P]:
// the parent p = sel_par's range (lo, hi) and its size (prev_count), then
// the backward step by sel_tok; with `finished` (steps >= 1), (0, 0) where
// the token is EOS or PAD or the parent had finished.
template <int G>
__global__ void __launch_bounds__(THREADS)
advance_kernel(const int* __restrict__ psi, const int* __restrict__ sym_dir,
               const int* __restrict__ head_pair, int n_rows, int sigma, int dir_shift,
               const int* __restrict__ lo, const int* __restrict__ hi, int P,
               const int* __restrict__ sel_par, const int* __restrict__ sel_tok,
               const unsigned char* __restrict__ finished, int eos, int pad,
               int* __restrict__ out_lo, int* __restrict__ out_hi, int* __restrict__ out_count,
               long long n, int n_sel) {
  const long long q = ((long long)blockIdx.x * THREADS + threadIdx.x) / G;
  if (q >= n) return;  // uniform over the group
  const Group<G> gr;
  const long long parent = q / n_sel * P + sel_par[q];
  const int plo = lo[parent], phi = hi[parent], tok = sel_tok[q];
  const bool stop = finished != nullptr && (tok == eos || tok == pad || finished[parent] != 0);
  int2 r = make_int2(0, 0);
  if (!stop)
    r = group_step<G>(psi, sym_dir, head_pair, n_rows, sigma, dir_shift, tok + SHIFT, plo, phi,
                      gr);
  if (gr.g == 0) {
    out_lo[q] = r.x;
    out_hi[q] = r.y;
    out_count[q] = phi - plo;
  }
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
  static constexpr int MIN_BLOCKS = 1;  // no cap
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

// ---------------------------------------------------------------- shard modes
//
// Replace seal_tpu/parallel/sharded_decode.py:ShardedIndexOps (:48-148) and
// seal_tpu/parallel/sharded_index.py (:401-483): the same searches over a
// corpus-sharded index whose shards are stacked shard-major on one card
// (psi [S, n_max], sym_dir [S, sigma, 4], ranges [S, n]; no head
// directory).  The JAX package runs one shard per device and merges with a
// psum; here one launch covers every shard and the merge is a loop over the
// shard axis in registers, so a decode step's launches do not grow with S.
// Shard s's rows never reach its padding: its own C ends at its true row
// count, and a symbol it lacks has an empty block.

struct Shards {
  const int* psi;
  const int* sym_dir;
  long long n_max;  // row stride of psi (and bwt)
  int sigma;        // sym_dir rows per shard
  int n_shards;

  __device__ const int* psi_of(int s) const { return psi + s * n_max; }
  __device__ const int* dir_of(int s) const { return sym_dir + (long long)s * sigma * 4; }
  // smallest row of symbol c's block in shard s with psi >= pos
  __device__ int rank(int s, int c, int pos) const {
    const Bounds b = symbol_bounds(dir_of(s), nullptr, 0, 0, c, pos);
    return search(psi_of(s), b.dlo, b.dhi, pos);
  }
};

// Kernel 1, backward step: one thread per (shard, range, bound); shard s's
// range q reads the token of range q (the same for every shard).
__global__ void __launch_bounds__(THREADS)
backward_step_sharded_kernel(Shards sh, const int* __restrict__ token,
                             const int* __restrict__ lo, const int* __restrict__ hi,
                             int* __restrict__ out_lo, int* __restrict__ out_hi, long long n) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long q = t >> 1;  // shard-major: q = s * n + i
  const int bound = (int)(t & 1);
  const bool active = q < n * sh.n_shards;
  int row = 0;
  if (active) {
    const int s = (int)(q / n);
    const int c = token[q - s * n] + SHIFT;
    if (c >= 1 && c < sh.sigma) row = sh.rank(s, c, bound ? hi[q] : lo[q]);
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

// Kernel 1, membership (ORed over the shards) or counts (summed): one
// thread per (range, token) walks the shards; their chains are independent.
__global__ void __launch_bounds__(THREADS)
contains_sharded_kernel(Shards sh, const int* __restrict__ tokens, const int* __restrict__ lo,
                        const int* __restrict__ hi, void* __restrict__ out, long long n, int m,
                        int count) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= n * m) return;
  const long long r = t / m;
  const int c = tokens[t] + SHIFT;
  int acc = 0;
  if (c >= 1 && c < sh.sigma) {
    for (int s = 0; s < sh.n_shards; ++s) {
      const int l = lo[s * n + r], h = hi[s * n + r];
      if (count) {
        acc += max(sh.rank(s, c, h) - sh.rank(s, c, l), 0);
      } else {
        const Bounds b = symbol_bounds(sh.dir_of(s), nullptr, 0, 0, c, l);
        const int row = search(sh.psi_of(s), b.dlo, b.dhi, l);
        acc |= row < b.bhi && __ldg(sh.psi_of(s) + row) < h;
      }
    }
  }
  if (count) {
    static_cast<int*>(out)[t] = acc;
  } else {
    static_cast<unsigned char*>(out)[t] = acc ? 1 : 0;
  }
}

// Kernel 5: the lane pair of sequences_kernel per (shard, sequence), from
// shard s's full range [0, n_rows[s]); in the count mode one lane pair per
// sequence walks the shards and sums hi - lo.
__global__ void __launch_bounds__(THREADS)
sequences_sharded_kernel(Shards sh, const int* __restrict__ n_rows,
                         const int* __restrict__ tokens, const int* __restrict__ lengths,
                         int* __restrict__ out_lo, int* __restrict__ out_hi,
                         int* __restrict__ out_count, long long n, int L) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long q = t >> 1;  // range mode: s * n + i; count mode: i
  const int bound = (int)(t & 1);
  const bool counting = out_count != nullptr;
  const long long n_pairs = counting ? n : n * sh.n_shards;
  const bool active = q < n_pairs;
  const int s0 = counting ? 0 : (active ? (int)(q / n) : 0);
  const long long i = counting ? q : q - (long long)s0 * n;
  const int s1 = counting ? sh.n_shards : s0 + 1;
  const int len = active ? lengths[i] : 0;
  int total = 0, lo = 0, hi = 0;
  for (int s = s0; s < s1; ++s) {
    lo = 0;
    hi = active ? n_rows[s] : 0;
    for (int j = 0; j < L; ++j) {
      const bool keep = j < len;
      int row = 0;  // an out-of-range token gives (0, 0)
      if (keep) {
        const int c = tokens[i * L + j] + SHIFT;
        if (c >= 1 && c < sh.sigma) row = sh.rank(s, c, bound ? hi : lo);
      }
      const int other = __shfl_xor_sync(0xffffffffu, row, 1);
      if (keep) {
        lo = bound ? other : row;
        hi = max(lo, bound ? row : other);
      }
    }
    total += hi - lo;
  }
  if (!active || bound != 0) return;
  if (counting) {
    out_count[i] = total;
  } else {
    out_lo[q] = lo;
    out_hi[q] = hi;
  }
}

// Kernel 15: one block per (range, slice) adds every shard's count vector
// into one shared histogram, each shard by its own route (its rows below
// hist_max, else both bounds' ranks), and writes the sum once.
__global__ void __launch_bounds__(seal_dense::THREADS)
dense_counts_sharded_kernel(Shards sh, const int* __restrict__ bwt, const int* __restrict__ lo,
                            const int* __restrict__ hi, int* __restrict__ out, long long n,
                            int vocab, int hist_max) {
  constexpr int T = seal_dense::THREADS;
  __shared__ int hist[seal_dense::SLICE];
  const long long r = blockIdx.x;
  const int t0 = blockIdx.y * seal_dense::SLICE;
  const int t1 = min(t0 + seal_dense::SLICE, vocab);
  for (int i = threadIdx.x; i < t1 - t0; i += T) hist[i] = 0;
  __syncthreads();
  for (int s = 0; s < sh.n_shards; ++s) {
    const int l = lo[s * n + r], h = hi[s * n + r];
    const int r0 = (int)min(max((long long)l, 0LL), sh.n_max);
    const int r1 = (int)min(max((long long)h, 0LL), sh.n_max);
    if (r1 - r0 <= hist_max) {
      const int* b = bwt + s * sh.n_max;
      for (int row = r0 + threadIdx.x; row < r1; row += T) {
        const int tok = __ldg(b + row) - SHIFT;
        if (tok >= t0 && tok < t1) atomicAdd(hist + (tok - t0), 1);
      }
    } else {
      for (int tok = t0 + threadIdx.x; tok < t1; tok += T) {
        const int c = tok + SHIFT;
        if (c < sh.sigma) atomicAdd(hist + (tok - t0), max(sh.rank(s, c, h) - sh.rank(s, c, l), 0));
      }
    }
  }
  __syncthreads();
  int* row_out = out + r * vocab;
  for (int i = threadIdx.x; i < t1 - t0; i += T) row_out[t0 + i] = hist[i];
}

}  // namespace

extern "C" int seal_fm_backward_step_sharded(const int* psi, const int* sym_dir, long long n_max,
                                             int sigma, int n_shards, const int* token,
                                             const int* lo, const int* hi, int* out_lo,
                                             int* out_hi, long long n, void* stream) {
  if (n > 0 && n_shards > 0) {
    const Shards sh{psi, sym_dir, n_max, sigma, n_shards};
    const long long threads = 2 * n * n_shards;
    const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
    backward_step_sharded_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        sh, token, lo, hi, out_lo, out_hi, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int seal_fm_contains_sharded(const int* psi, const int* sym_dir, long long n_max,
                                        int sigma, int n_shards, const int* tokens, const int* lo,
                                        const int* hi, void* out, long long n, int m, int count,
                                        void* stream) {
  if (n > 0 && m > 0) {
    const Shards sh{psi, sym_dir, n_max, sigma, n_shards};
    const long long threads = n * m;
    const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
    contains_sharded_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(sh, tokens, lo, hi, out,
                                                                          n, m, count);
  }
  return (int)cudaGetLastError();
}

extern "C" int seal_fm_sequences_sharded(const int* psi, const int* sym_dir, long long n_max,
                                         int sigma, int n_shards, const int* n_rows,
                                         const int* tokens, const int* lengths, int* out_lo,
                                         int* out_hi, int* out_count, long long n, int L,
                                         void* stream) {
  if (n > 0) {
    const Shards sh{psi, sym_dir, n_max, sigma, n_shards};
    const long long threads = 2 * n * (out_count != nullptr ? 1 : n_shards);
    const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
    sequences_sharded_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        sh, n_rows, tokens, lengths, out_lo, out_hi, out_count, n, L);
  }
  return (int)cudaGetLastError();
}

extern "C" int seal_fm_dense_counts_sharded(const int* psi, const int* sym_dir, long long n_max,
                                            int sigma, int n_shards, const int* bwt,
                                            const int* lo, const int* hi, int* out, long long n,
                                            int vocab, int hist_max, void* stream) {
  if (n > 0 && vocab > 0) {
    const Shards sh{psi, sym_dir, n_max, sigma, n_shards};
    const dim3 grid((unsigned)n, (unsigned)((vocab + seal_dense::SLICE - 1) / seal_dense::SLICE));
    dense_counts_sharded_kernel<<<grid, seal_dense::THREADS, 0, (cudaStream_t)stream>>>(
        sh, bwt, lo, hi, out, n, vocab, hist_max);
  }
  return (int)cudaGetLastError();
}

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

// The group kernels' launch: `group` lanes (2, 4, 8, 16 or 32) an item.
template <template <int> class Launch, typename... Args>
int launch_group(int group, long long items, cudaStream_t stream, Args... args) {
  if (items <= 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((items * group + THREADS - 1) / THREADS);
  switch (group) {
    case 2: Launch<2>::run(blocks, stream, args...); break;
    case 4: Launch<4>::run(blocks, stream, args...); break;
    case 8: Launch<8>::run(blocks, stream, args...); break;
    case 16: Launch<16>::run(blocks, stream, args...); break;
    case 32: Launch<32>::run(blocks, stream, args...); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int G>
struct StepLaunch {
  template <typename... Args>
  static void run(unsigned blocks, cudaStream_t stream, Args... args) {
    backward_step_kernel<G><<<blocks, THREADS, 0, stream>>>(args...);
  }
};
template <int G>
struct ContainsLaunch {
  template <typename... Args>
  static void run(unsigned blocks, cudaStream_t stream, Args... args) {
    contains_kernel<G><<<blocks, THREADS, 0, stream>>>(args...);
  }
};
template <int G>
struct AdvanceLaunch {
  template <typename... Args>
  static void run(unsigned blocks, cudaStream_t stream, Args... args) {
    advance_kernel<G><<<blocks, THREADS, 0, stream>>>(args...);
  }
};

extern "C" int seal_fm_backward_step(const int* psi, const int* sym_dir, const int* head_pair,
                                     int n_rows, int sigma, int dir_shift, const int* token,
                                     const int* lo, const int* hi, int* out_lo, int* out_hi,
                                     long long n, int group, void* stream) {
  return launch_group<StepLaunch>(group, n, (cudaStream_t)stream, psi, sym_dir, head_pair, n_rows,
                                  sigma, dir_shift, token, lo, hi, out_lo, out_hi, n);
}

extern "C" int seal_fm_contains(const int* psi, const int* sym_dir, const int* head_pair,
                                int n_rows, int sigma, int dir_shift, const int* tokens,
                                const int* lo, const int* hi, unsigned char* out, long long n,
                                int m, int group, void* stream) {
  if (m <= 0) return (int)cudaGetLastError();
  return launch_group<ContainsLaunch>(group, n * m, (cudaStream_t)stream, psi, sym_dir, head_pair,
                                      n_rows, sigma, dir_shift, tokens, lo, hi, out, n, m);
}

// lo, hi [n / n_sel, P]; sel_par, sel_tok, out_* [n / n_sel, n_sel];
// finished [n / n_sel, P] or null (step 0: no stop rule)
extern "C" int seal_fm_advance(const int* psi, const int* sym_dir, const int* head_pair,
                               int n_rows, int sigma, int dir_shift, const int* lo, const int* hi,
                               int P, const int* sel_par, const int* sel_tok,
                               const unsigned char* finished, int eos, int pad, int* out_lo,
                               int* out_hi, int* out_count, long long n, int n_sel, int group,
                               void* stream) {
  return launch_group<AdvanceLaunch>(group, n, (cudaStream_t)stream, psi, sym_dir, head_pair,
                                     n_rows, sigma, dir_shift, lo, hi, P, sel_par, sel_tok,
                                     finished, eos, pad, out_lo, out_hi, out_count, n, n_sel);
}
