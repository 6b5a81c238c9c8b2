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
// (:180): the count of every token over each range [lo, hi).  One launch,
// one block per (range, slice of dense_counts.cuh's SLICE tokens), on one
// of two routes:
//
// * histogram, a range of at most hist_max rows: the block reads the
//   range's rows (one read of the hybrid layout's raw BWT, or the compact
//   layout's descent) into a shared histogram of its slice
//   (dense_counts.cuh).
// * walk, a wider one: the range's distinct symbols, listed top-down with
//   their counts (sdsl's interval_symbols, behind the reference SEAL's
//   FMIndex::distinct_count), by the row's first block alone where the
//   whole walk fits the frontier's room (most decode ranges hold few
//   symbols), else by each block over the symbols of its slice.  The block
//   zeroes its tokens with 16-byte stores, then walks the 16-ary tree level
//   by level from the root, each level's frontier of (prefix, lo, hi) nodes
//   in shared memory, two nodes a warp, lane d of a node's 16 on digit d.
//   The digit's count in the node is the codes between the node's two
//   bounds where both fall in one 256-row block (most deep nodes: a word
//   or two), else the difference of the two bounds' ranks, each counted
//   from its block's nearer end (the directory word of the block or of the
//   next); a child with a nonzero count whose symbols meet the slice joins
//   the next level with its local range (the lower rank less node_cnt, as
//   rank<L> descends).  The last level writes each count at token c - 1,
//   for c in the slice and below sigma (the true alphabet, not
//   sigma_bound; tokens start at 0, past the sentinel c = 0, and end at the
//   vocab).  A slice of 8,192 symbols meets at most 556 nodes at up to 5
//   digits (slice_nodes: within the room, asserted for every instance),
//   where a rank of every token would take 2 x 8,192 L-level ranks.
//
// Both routes give Occ(c, hi) - Occ(c, lo) for each token (0 for an empty
// or inverted range; positions clamped to [0, n_rows] as block_of clamps
// them), so each equals the plain sweep exactly, whatever order the walk
// writes in: every symbol is written once, by the block of its slice.
// Bound on the card: the [ranges, vocab] int32 output.
//
// The mask mode (seal_wt_dense_mask, the one the exact_mask decode reads)
// runs the same routes and changes their stores: a bit a token
// (kernels/count_mask.py).  A slice of 8,192 tokens owns 256 whole words,
// so no two blocks write one word: the histogram sets the slice's bits in
// a shared bitset and writes its words; the walk zeroes its words, then
// its last level ORs each symbol's bit into them (a block's own words:
// every symbol once).  The output is 3.0 MB a dense step in place of 96.5.
template <int BWT_BYTES, int L>
struct WtDense {
  // 3 blocks of 512 an SM (at most 40 registers a thread): the hybrid
  // layout's histogram route ran a quarter slower at 2, and the walk, bound
  // by its dependent block reads, runs fastest at 3 of the 1 to 4 tried on
  // an H100 (python -m seal_tpu_torch.bench_select, "k16 walk")
  static constexpr int MIN_BLOCKS = 3;
  static constexpr int BYTES = BWT_BYTES;
  Index ix;
  const void* bwt;
  int n_rows;

  __device__ int symbol(int row) const { return seal_wt::symbol_at<BWT_BYTES>(ix, bwt, row); }
};

constexpr int WALK_CAP = 1024;  // frontier nodes a block holds: 12 KB of shared memory
constexpr int DENSE_SMEM = 4 * seal_dense::SLICE;  // the histogram, or the frontier
static_assert(12 * WALK_CAP <= DENSE_SMEM, "the frontier shares the histogram's room");

// The most nodes the walk of one slice can visit at L digits, whatever the
// range: a level-l prefix drops 4(L - l) bits, and SLICE consecutive
// symbols hold at most (SLICE >> bits) + 2 distinct such prefixes.
__host__ __device__ constexpr int slice_nodes(int L) {
  int total = 0;
  for (int l = 0; l < L; ++l) total += (seal_dense::SLICE >> (seal_wt::DIGIT_BITS * (L - l))) + 2;
  return total;
}

// Nodes the walk of a range of `rows` rows can visit in the slice of
// symbols [c_lo, c_hi): a level-l node is a distinct l-digit prefix of a
// symbol in the range, and the walk keeps only prefixes that meet the slice.
template <int L>
__device__ int walk_nodes(int rows, int c_lo, int c_hi) {
  int total = 0;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int below = seal_wt::DIGIT_BITS * (L - l);  // bits a level-l prefix drops
    total += min(((c_hi - 1) >> below) - (c_lo >> below) + 1, rows);
  }
  return total;
}

// Zero n ints at row (4-byte aligned): a scalar head to 16 bytes, then
// 16-byte stores.
__device__ __forceinline__ void zero_ints(int* row, int n) {
  const int head = min(n, (int)(((16 - ((unsigned long long)row & 15)) & 15) >> 2));
  for (int i = threadIdx.x; i < head; i += blockDim.x) row[i] = 0;
  int4* v = reinterpret_cast<int4*>(row + head);
  const int nv = (n - head) >> 2;
  for (int i = threadIdx.x; i < nv; i += blockDim.x) v[i] = make_int4(0, 0, 0, 0);
  for (int i = head + 4 * nv + threadIdx.x; i < n; i += blockDim.x) row[i] = 0;
}

using seal_wt::count_between;
using seal_wt::rank_near;

// The walk of rows [r0, r1) (clamped, non-empty) over the symbols
// [c_lo, c_hi) into row_out (indexed by token; the caller zeroed those
// tokens before a barrier).  s_pre / s_lo / s_hi hold the frontier, every
// level appended after the last (at most WALK_CAP nodes: walk_nodes, and
// slice_nodes for a slice).  Two nodes a warp, lane d of a node's 16 on
// digit d: the digit's count in the node is the codes between the two
// bounds where both fall in one block (most nodes of the deep levels: a
// word or two), else the difference of the two ranks, each from its
// block's nearer end; a child's local range also needs the lower rank, the
// last level only the count.
template <int L, bool MASK>
__device__ void walk_slice(const Index& ix, int r0, int r1, int c_lo, int c_hi, int* row_out,
                           int* s_pre, int* s_lo, int* s_hi) {
  __shared__ int s_fill;
  const unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31, d = lane & 15;
  const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  if (threadIdx.x == 0) {
    s_pre[0] = 0;
    s_lo[0] = r0;
    s_hi[0] = r1;
    s_fill = 1;
  }
  __syncthreads();
  int beg = 0, end = 1;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int base = seal_wt::heap_base(l);
    const int below = seal_wt::DIGIT_BITS * (L - 1 - l);  // bits a child's prefix drops
    for (int i0 = beg + 2 * warp; i0 < end; i0 += 2 * n_warps) {  // two nodes a warp
      const int i = i0 + (lane >> 4);
      int c = 0, clo = 0, cnt = 0;
      if (i < end) {
        const int pre = s_pre[i];
        const int node = base + pre;
        const int start = __ldg(ix.node_start + node);
        const int xl = min(max(start + s_lo[i], 0), ix.n_rows);
        const int xh = min(max(start + s_hi[i], 0), ix.n_rows);
        const bool one_block = (xl >> 8) == (xh >> 8);
        const int rl = (l < L - 1 || !one_block) ? rank_near(ix, l, xl, d) : 0;
        if (one_block) {
          const uint32_t* blk = ix.blocks + ((long long)l * ix.n_blocks + (xl >> 8)) *
                                                seal_wt::WORDS_PER_BLOCK;
          cnt = count_between(blk, xl & 255, xh & 255, d);
        } else {
          cnt = rank_near(ix, l, xh, d) - rl;
        }
        if (l < L - 1) clo = rl - __ldg(ix.node_cnt + (long long)node * seal_wt::RADIX + d);
        c = (pre << seal_wt::DIGIT_BITS) | d;  // the child's prefix (last level: symbol)
      }
      const bool take = i < end && cnt > 0 && (c << below) < c_hi && ((c + 1) << below) > c_lo;
      if (l == L - 1) {
        const int tok = c - seal_wt::SHIFT;
        if (take) {
          if constexpr (MASK) {  // one symbol a lane, each once: the words' bits
            atomicOr(reinterpret_cast<unsigned*>(row_out) + (tok >> 5), 1u << (tok & 31));
          } else {
            row_out[tok] = cnt;
          }
        }
      } else {
        const unsigned ball = __ballot_sync(FULL, take);
        if (ball) {
          int at = 0;
          if (lane == 0) at = atomicAdd(&s_fill, __popc(ball));
          at = __shfl_sync(FULL, at, 0) + __popc(ball & ((1u << lane) - 1u));
          // the node bound keeps a valid index's walk inside the room; the
          // check keeps a corrupt index's inside shared memory
          if (take && at < WALK_CAP) {
            s_pre[at] = c;
            s_lo[at] = clo;
            s_hi[at] = clo + cnt;
          }
        }
      }
    }
    __syncthreads();
    beg = end;
    end = min(s_fill, WALK_CAP);
    __syncthreads();  // every thread has read s_fill before the next level adds to it
  }
}

// MASK: the count mask (a bit a token, W = 4 * ceil(vocab / 128) words a
// row) in place of the counts; the same routes, only the stores differ
template <int BWT_BYTES, int L, bool MASK>
__global__ void __launch_bounds__(seal_dense::THREADS, WtDense<BWT_BYTES, L>::MIN_BLOCKS)
wt_dense_kernel(WtDense<BWT_BYTES, L> ix, const int* __restrict__ lo, const int* __restrict__ hi,
                int* __restrict__ out, int vocab, int hist_max) {
  static_assert(slice_nodes(L) <= WALK_CAP, "a slice's walk fits the frontier's room");
  extern __shared__ int s_dense[];  // the histogram or bitset, or the frontier (3 x WALK_CAP ints)
  const long long r = blockIdx.x;
  const int t0 = blockIdx.y * seal_dense::SLICE;
  const int t1 = min(t0 + seal_dense::SLICE, vocab);
  const int l = lo[r], h = hi[r];
  int* row_out = out + r * (MASK ? seal_dense::mask_words(0, vocab) : vocab);
  const int r0 = min(max(l, 0), ix.n_rows), r1 = min(max(h, 0), ix.n_rows);
  if (r1 - r0 <= hist_max) {
    if constexpr (MASK) {
      seal_dense::hist_mask_slice(ix, r0, r1, t0, t1, reinterpret_cast<unsigned*>(row_out),
                                  reinterpret_cast<unsigned*>(s_dense));
    } else {
      seal_dense::hist_slice(ix, r0, r1, t0, t1, row_out, s_dense);
    }
    return;
  }
  // a range whose whole walk fits the room is walked by the row's first
  // block alone (most decode ranges hold few symbols: one walk, not one a
  // slice); a wider one a slice a block.  Tokens [a, b) are symbols t + 1
  const int c_all = min(vocab + seal_wt::SHIFT, ix.ix.sigma);
  const bool whole =
      c_all > seal_wt::SHIFT && walk_nodes<L>(r1 - r0, seal_wt::SHIFT, c_all) <= WALK_CAP;
  if (whole && blockIdx.y != 0) return;
  const int a = whole ? 0 : t0, b = whole ? vocab : t1;
  const int c_lo = a + seal_wt::SHIFT, c_hi = min(b + seal_wt::SHIFT, ix.ix.sigma);
  if constexpr (MASK) {
    zero_ints(row_out + (a >> 5), seal_dense::mask_words(a, b));
  } else {
    zero_ints(row_out + a, b - a);
  }
  if (c_hi <= c_lo) return;
  __syncthreads();
  walk_slice<L, MASK>(ix.ix, r0, r1, c_lo, c_hi, row_out, s_dense, s_dense + WALK_CAP,
                      s_dense + 2 * WALK_CAP);
}

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

namespace {

// kernel 16 for the index's digit count and bwt width, counts or mask
template <bool MASK>
int launch_wt_dense(const Index& ix, const void* bwt, int bwt_bytes, const int* lo,
                    const int* hi, int* out, long long n, int vocab, int hist_max,
                    cudaStream_t s) {
  if (bwt != nullptr && bwt_bytes != 2 && bwt_bytes != 4) return (int)cudaErrorInvalidValue;
  return seal_wt::with_digits(ix.digits, [&](auto D) {
    constexpr int L = decltype(D)::value;
    if (n <= 0 || vocab <= 0) return (int)cudaGetLastError();
    const dim3 grid((unsigned)n, (unsigned)((vocab + seal_dense::SLICE - 1) / seal_dense::SLICE));
    const auto launch = [&](auto layout) {
      wt_dense_kernel<decltype(layout)::BYTES, L, MASK>
          <<<grid, seal_dense::THREADS, DENSE_SMEM, s>>>(layout, lo, hi, out, vocab, hist_max);
      return (int)cudaGetLastError();
    };
    if (bwt == nullptr) return launch(WtDense<0, L>{ix, bwt, ix.n_rows});
    if (bwt_bytes == 2) return launch(WtDense<2, L>{ix, bwt, ix.n_rows});
    return launch(WtDense<4, L>{ix, bwt, ix.n_rows});
  });
}

}  // namespace

extern "C" int seal_wt_dense_counts(const uint32_t* blocks, const int* node_start,
                                    const int* node_cnt, const int* C, long long n_blocks,
                                    int n_rows, int digits, int sigma, const void* bwt,
                                    int bwt_bytes, const int* lo, const int* hi, int* out,
                                    long long n, int vocab, int hist_max, void* stream) {
  const Index ix{blocks, node_start, node_cnt, C, n_blocks, n_rows, digits, sigma};
  return launch_wt_dense<false>(ix, bwt, bwt_bytes, lo, hi, out, n, vocab, hist_max,
                                (cudaStream_t)stream);
}

// the count mask: out [n, 4 * ceil(vocab / 128)] words, 16-byte aligned
extern "C" int seal_wt_dense_mask(const uint32_t* blocks, const int* node_start,
                                  const int* node_cnt, const int* C, long long n_blocks,
                                  int n_rows, int digits, int sigma, const void* bwt,
                                  int bwt_bytes, const int* lo, const int* hi, unsigned* out,
                                  long long n, int vocab, int hist_max, void* stream) {
  if ((unsigned long long)out & 15) return (int)cudaErrorInvalidValue;
  const Index ix{blocks, node_start, node_cnt, C, n_blocks, n_rows, digits, sigma};
  return launch_wt_dense<true>(ix, bwt, bwt_bytes, lo, hi, reinterpret_cast<int*>(out), n,
                               vocab, hist_max, (cudaStream_t)stream);
}
