// Kernel 1: FM-index rank search over the Psi layout; kernel 5, the same
// search chained over padded sequences (sequences_kernel below); and kernel
// 15, the dense count vector of every token over a range (PsiDense below,
// with dense_counts.cuh), and its count mask (dense_mask_kernel, at the
// end: the mode the exact_mask decode reads).
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
// which meet with one shuffle (G = 2: one lane a bound, a binary search).
// The group reads the symbol's directory row once (one broadcast load).
// Kernel 5 chains that step over a sequence, a group a sequence (a (shard,
// sequence) in its shard mode); kernel 1's shard modes (contains, counts,
// the backward step and the step mode over the shards) take a team of
// groups an item, a group a shard, the shards side by side.
// The TPU's 128-row vector finish (psi_blk) is not carried over: a GPU lane
// reads psi directly.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "dense_counts.cuh"

namespace cg = cooperative_groups;

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

// group_search for groups of a warp that run in step: every lane of the
// warp calls it together, and the loop runs until the warp's last group is
// done (a done or idle group's lanes run its steps without loads), so the
// warp never splits and every ballot takes the whole warp.  Kernel 5's
// groups, a sequence's positions and shards apart, run different numbers
// of levels; left to split, a warp of 2-lane groups ran ~5x the lane pairs'
// binary search (bench_select's forced group widths, NVIDIA H100).  The
// result is group_search's: the same pivots and the same answer.
template <int H>
__device__ __forceinline__ int warp_group_search(const int* __restrict__ psi, int lo, int hi,
                                                 int pos, int g, int gbase) {
  constexpr unsigned LANES = H == 32 ? 0xffffffffu : (1u << H) - 1u;
  const bool empty = lo >= hi;
  bool live = hi - lo > H;
  while (__any_sync(0xffffffffu, live)) {
    const int step = live ? (int)((unsigned)(hi - lo) / (H + 1)) : 0;  // >= 1 where live
    const bool ge = live && __ldg(psi + lo + (g + 1) * step) >= pos;
    const unsigned ball = (__ballot_sync(0xffffffffu, ge) >> gbase) & LANES;
    if (live) {
      if (ball == 0u) {
        lo += H * step + 1;  // past the last pivot
      } else {
        const int f = __ffs(ball) - 1;  // the first pivot at or past pos
        hi = lo + (f + 1) * step;
        lo += f * step + (f > 0 ? 1 : 0);
      }
    }
    live = hi - lo > H;
  }
  // at most H candidates left: one load each
  const bool ge = g < hi - lo && __ldg(psi + lo + g) >= pos;
  const unsigned ball = (__ballot_sync(0xffffffffu, ge) >> gbase) & LANES;
  return empty ? lo : (ball ? lo + __ffs(ball) - 1 : hi);
}

// group_step over warp_group_search, every lane of the warp calling it
// together: a group with `on` false (idle, or past its sequence's length)
// or an out-of-range symbol loads nothing and gets (0, 0)
template <int G>
__device__ __forceinline__ int2 warp_step(const int* __restrict__ psi,
                                          const int* __restrict__ sym_dir,
                                          const int* __restrict__ head_pair, int n_rows,
                                          int sigma, int dir_shift, int c, int lo, int hi,
                                          bool on, const Group<G>& gr) {
  constexpr int H = G / 2;
  const bool valid = on && c >= 1 && c < sigma;
  const bool upper = gr.g >= H;
  const int pos = upper ? hi : lo;
  int dlo = 0, dhi = 0;
  if (valid) {
    const Bounds b = symbol_bounds(sym_dir, head_pair, n_rows, dir_shift, c, pos);
    dlo = b.dlo;
    dhi = b.dhi;
  }
  const int row = warp_group_search<H>(psi, dlo, dhi, pos, gr.g - (upper ? H : 0),
                                       gr.base + (upper ? H : 0));
  const int new_lo = __shfl_sync(0xffffffffu, row, gr.base);
  const int new_hi = __shfl_sync(0xffffffffu, row, gr.base + H);
  return valid ? make_int2(new_lo, max(new_lo, new_hi)) : make_int2(0, 0);
}

// Kernel 5: row ranges of padded token sequences (replaces
// seal_tpu/ops/_generic.py:range_for_sequences, the lax.scan of backward
// steps behind fm_ops.range_for_sequences and count_sequences).  A group of
// G lanes a sequence runs the backward step of kernel 1's cooperative
// search (G / 2 lanes a bound), warp_step above, over the sequence in
// registers: one launch for the whole chain instead of one per position,
// and a chain of ~log_{G/2+1} probes a position where the lane pair took
// log2.  G comes from the host (kernels/fm_search.py:sequences_plan): wide
// groups where the grid would leave the card's lanes idle (a searcher's
// count filter holds 60-185 keys), narrow ones where it fills them.  A warp
// steps through its longest sequence's positions; the scan's semantics
// hold: positions at or past a sequence's length leave its range as it is,
// an out-of-range token resets the range to (0, 0), and an empty range
// (x, x) steps as any other.
template <int G>
__global__ void __launch_bounds__(THREADS)
sequences_kernel(const int* __restrict__ psi, const int* __restrict__ sym_dir,
                 const int* __restrict__ head_pair, int n_rows, int sigma, int dir_shift,
                 const int* __restrict__ tokens, const int* __restrict__ lengths,
                 int* __restrict__ out_lo, int* __restrict__ out_hi, long long n, int L) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if ((t & ~31LL) / G >= n) return;  // the whole warp past the last sequence
  const long long q = t / G;
  const bool in = q < n;  // a group past the last sequence idles along
  const Group<G> gr;
  const int len = in ? min(lengths[q], L) : 0;
  const int steps = __reduce_max_sync(0xffffffffu, len);
  int lo = 0, hi = n_rows;
  for (int j = 0; j < steps; ++j) {
    const bool keep = j < len;
    const int c = keep ? tokens[q * L + j] + SHIFT : 0;
    const int2 r = warp_step<G>(psi, sym_dir, head_pair, n_rows, sigma, dir_shift, c, lo, hi,
                                keep, gr);
    if (keep) {
      lo = r.x;
      hi = r.y;
    }
  }
  if (in && gr.g == 0) {
    out_lo[q] = lo;
    out_hi[q] = hi;
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

// Kernel 1's shard modes: a team of P groups of G lanes an item (P a power
// of two, P * G <= 32: one warp or an aligned part of one), member p
// searching shards p, p + P, ... (a loop only past the P shards a team
// holds), each group by kernel 1's cooperative search with the warp's
// groups in step (warp_group_search: a shard's symbol block is its whole psi
// block, no head directory narrows it, so the search is long and the
// levels of the warp's groups differ little), or, at one lane a search (G
// = 1 for membership, G = 2 for a step's two bounds), a plain binary
// search: where the grid binds the loads, the levels' ballots only cost
// (bench_select's forced widths on an H100).  The team merges with one
// ballot (membership ORed) or a shuffle butterfly (counts, range sizes
// summed), so an item's chain is one shard's search, not S of them.  Every
// lane of a warp reaches every *_sync: a whole warp past the last team
// returns, a group past it (or of a shard past S) idles along.  G and P come
// from the host (kernels/fm_search.py:shard_plan).

// This lane's team: the item it serves, its member index, and whether the
// item exists
template <int G>
struct Team {
  long long item;
  int p;
  bool in;
  __device__ Team(long long items, int P) {
    const long long grp = ((long long)blockIdx.x * THREADS + threadIdx.x) / G;
    in = grp < items * P;
    item = in ? grp / P : 0;
    p = in ? (int)(grp - item * P) : 0;
  }
};

// a whole warp past the last team (uniform over the warp)
template <int G>
__device__ __forceinline__ bool warp_idle(long long items, int P) {
  return (((long long)blockIdx.x * THREADS + threadIdx.x) & ~31LL) / G >= items * P;
}

// A shard's backward step for the shard modes: warp_step, but at G = 2
// one lane a bound runs a plain binary search (no ballot a level) and the
// pair's rows meet by one shuffle, which every lane of the warp reaches.
template <int G>
__device__ __forceinline__ int2 shard_step(const Shards& sh, int s, int c, int lo, int hi,
                                           bool on, const Group<G>& gr) {
  if constexpr (G == 2) {
    const bool valid = on && c >= 1 && c < sh.sigma;
    const int pos = gr.g ? hi : lo;
    int row = 0;
    if (valid) {
      const Bounds b = symbol_bounds(sh.dir_of(s), nullptr, 0, 0, c, pos);
      row = search(sh.psi_of(s), b.dlo, b.dhi, pos);
    }
    const int other = __shfl_xor_sync(0xffffffffu, row, 1);
    const int new_lo = gr.g ? other : row, new_hi = gr.g ? row : other;
    return valid ? make_int2(new_lo, max(new_lo, new_hi)) : make_int2(0, 0);
  } else {
    return warp_step<G>(sh.psi_of(s), sh.dir_of(s), nullptr, 0, sh.sigma, 0, c, lo, hi, on, gr);
  }
}

// Membership (ORed over the shards) or counts (summed): a team a (range,
// token).  Membership: the group's G lanes search the symbol's block at lo
// (the first row at or after lo is the token's first occurrence in the
// range when its psi is below hi; G = 1, a lane's binary search, where the
// grid is large enough to bind the loads, not their chain); counts: G / 2
// lanes a bound, as the backward step (shard_step).
template <int G, bool COUNT>
__global__ void __launch_bounds__(THREADS)
contains_sharded_kernel(Shards sh, const int* __restrict__ tokens, const int* __restrict__ lo,
                        const int* __restrict__ hi, void* __restrict__ out, long long n, int m,
                        int P) {
  const long long items = n * m;
  if (warp_idle<G>(items, P)) return;
  const Team<G> tm(items, P);
  const Group<G> gr;
  const long long r = tm.item / m;
  const int c = tm.in ? tokens[tm.item] + SHIFT : 0;  // one address a team
  const bool valid = tm.in && c >= 1 && c < sh.sigma;
  int acc = 0;
  for (int base = 0; base < sh.n_shards; base += P) {  // the same trips for the warp
    const int s = base + tm.p;
    const bool on = valid && s < sh.n_shards;
    const int sv = on ? s : 0;
    const long long q = (long long)sv * n + r;
    if constexpr (COUNT) {
      const int2 rr = shard_step<G>(sh, sv, c, on ? lo[q] : 0, on ? hi[q] : 0, on, gr);
      acc += rr.y - rr.x;  // (0, 0) where off; rr.y >= rr.x
    } else {
      const int pos = on ? lo[q] : 0;
      int dlo = 0, dhi = 0, bhi = 0;
      if (on) {
        const Bounds b = symbol_bounds(sh.dir_of(sv), nullptr, 0, 0, c, pos);
        dlo = b.dlo;
        dhi = b.dhi;
        bhi = b.bhi;
      }
      // one lane a shard (G = 1): a binary search, no lane waits on another
      int row;
      if constexpr (G == 1) {
        row = search(sh.psi_of(sv), dlo, dhi, pos);
      } else {
        row = warp_group_search<G>(sh.psi_of(sv), dlo, dhi, pos, gr.g, gr.base);
      }
      // row < bhi: psi[row] is the symbol's first occurrence at or after lo
      acc |= on && row < bhi && __ldg(sh.psi_of(sv) + row) < hi[q];
    }
  }
  const int T = G * P, lane = threadIdx.x & 31;  // the team's lanes, aligned in the warp
  if constexpr (COUNT) {
    for (int off = G; off < T; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  } else {
    const unsigned team = T == 32 ? 0xffffffffu : ((1u << T) - 1u) << (lane - lane % T);
    acc = (__ballot_sync(0xffffffffu, acc != 0) & team) != 0u;
  }
  if (!tm.in || lane % T != 0) return;
  if constexpr (COUNT) {
    static_cast<int*>(out)[tm.item] = acc;
  } else {
    static_cast<unsigned char*>(out)[tm.item] = acc ? 1 : 0;
  }
}

// The backward step and the step mode over the shards: a team a range q of
// [n / n_sel, n_sel]; G / 2 lanes a bound, which meet by a shuffle
// (warp_step).  Backward step (sel_par null): shard s's range q, extended by
// token[q] (the same for every shard).  Step mode: the parent p = sel_par[q]
// of q's query among its P_par parents, shard s's parent range extended by
// sel_tok[q]; with `finished` (steps >= 1), (0, 0) where the token is EOS or
// PAD or the parent had finished; out_count[q] the parent's range size
// summed over the shards (the team's butterfly).
template <int G>
__global__ void __launch_bounds__(THREADS)
step_sharded_kernel(Shards sh, const int* __restrict__ token, const int* __restrict__ lo,
                    const int* __restrict__ hi, int P_par, const int* __restrict__ sel_par,
                    const unsigned char* __restrict__ finished, int eos, int pad,
                    int* __restrict__ out_lo, int* __restrict__ out_hi,
                    int* __restrict__ out_count, long long n, int n_sel, int P) {
  if (warp_idle<G>(n, P)) return;
  const Team<G> tm(n, P);
  const Group<G> gr;
  const long long q = tm.item;
  // the range each shard's step reads: its parent's in the step mode
  const long long parent = !tm.in ? 0 : sel_par == nullptr ? q : q / n_sel * P_par + sel_par[q];
  const long long n_par = sel_par == nullptr ? n : n / n_sel * P_par;  // ranges a shard
  const int tok = tm.in ? token[q] : 0;
  const bool stop =
      finished != nullptr && tm.in && (tok == eos || tok == pad || finished[parent] != 0);
  int total = 0;
  for (int base = 0; base < sh.n_shards; base += P) {  // the same trips for the warp
    const int s = base + tm.p;
    const bool on = tm.in && s < sh.n_shards;
    const int sv = on ? s : 0;
    const long long src = (long long)sv * n_par + parent;
    const int plo = on ? lo[src] : 0, phi = on ? hi[src] : 0;
    const int2 r = shard_step<G>(sh, sv, tok + SHIFT, plo, phi, on && !stop, gr);
    if (on && gr.g == 0) {
      out_lo[(long long)s * n + q] = r.x;
      out_hi[(long long)s * n + q] = r.y;
    }
    total += phi - plo;  // 0 where off
  }
  if (out_count == nullptr) return;  // uniform over the launch
  const int T = G * P, lane = threadIdx.x & 31;
  for (int off = G; off < T; off <<= 1) total += __shfl_xor_sync(0xffffffffu, total, off);
  if (tm.in && lane % T == 0) out_count[q] = total;
}

// Kernel 5's shard mode: sequences_kernel's group of G lanes a (shard,
// sequence), from shard s's full range [0, n_rows[s]), the shards side by
// side: a sequence takes a team of P groups (P a power of two, P * G <= 32
// lanes: one warp or a part of one, all reading the sequence's tokens at
// one address), member p shards p, p + P, ... (a loop only past the P
// shards a team holds: 16 at G = 2).  The ranges mode writes each shard's
// range; the count mode adds the team's hi - lo with shuffles.  So a
// sequence's chain is ~L searches, not S x L.
template <int G>
__global__ void __launch_bounds__(THREADS)
sequences_sharded_kernel(Shards sh, const int* __restrict__ n_rows,
                         const int* __restrict__ tokens, const int* __restrict__ lengths,
                         int* __restrict__ out_lo, int* __restrict__ out_hi,
                         int* __restrict__ out_count, long long n, int L, int P) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if ((t & ~31LL) / G >= n * P) return;  // the whole warp past the last team
  const long long grp = t / G;
  const bool in = grp < n * P;  // a group past the last team idles along
  const Group<G> gr;
  const long long i = in ? grp / P : 0;
  const int p = in ? (int)(grp - i * P) : 0;
  const int len = in ? min(lengths[i], L) : 0;
  const int steps = __reduce_max_sync(0xffffffffu, len);
  int total = 0;
  for (int base = 0; base < sh.n_shards; base += P) {  // the same trips for the warp
    const int s = base + p;
    const bool on = in && s < sh.n_shards;
    const int sv = on ? s : 0;
    int lo = 0, hi = on ? n_rows[s] : 0;
    for (int j = 0; j < steps; ++j) {
      const bool keep = on && j < len;
      const int c = keep ? tokens[i * L + j] + SHIFT : 0;
      const int2 r = warp_step<G>(sh.psi_of(sv), sh.dir_of(sv), nullptr, 0, sh.sigma, 0, c, lo,
                                  hi, keep, gr);
      if (keep) {
        lo = r.x;
        hi = r.y;
      }
    }
    if (on && out_count == nullptr && gr.g == 0) {
      out_lo[s * n + i] = lo;
      out_hi[s * n + i] = hi;
    }
    total += on ? hi - lo : 0;
  }
  if (out_count == nullptr) return;
  const int T = G * P, lane = threadIdx.x & 31;  // the team's lanes, aligned in the warp
  for (int off = G; off < T; off <<= 1) total += __shfl_xor_sync(0xffffffffu, total, off);
  if (in && lane % T == 0) out_count[i] = total;
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

// ---------------------------------------------------------------- mask mode
//
// Kernel 15's mask mode: the count mask (kernels/count_mask.py) of each
// range, a bit a token, ORed over the shards in the shard mode.  It
// replaces the counts that the exact_mask decode read only as count > 0
// (seal_tpu/decoding/constrained.py:321-327, fm_valid = counts > 0).
//
// The counts mode is bound by its [ranges, vocab] int32 output (96.5 MB a
// dense step at [32, 15] x 50265) and reads a range's rows once for each
// of its slices of 8,192 tokens.  A bit a token makes the whole vocab one
// shared bitset (W = 4 * ceil(vocab / 128) words: 6.3 KB at 50,265) and
// the output 3.0 MB, so a range's rows are read once.  What is left is the
// spread of range widths: a decode step's ranges run from empty to a
// frequent token's ~3 x 10^5 rows.  So the grid is groups of CLUSTER
// consecutive ranges, one thread-block cluster of CLUSTER CTAs a group (a
// group of ranges g, g + G, ... ran 1.4x slower: python -m
// seal_tpu_torch.bench_dense_mask).  CTA c reads range c of its group
// alone when every shard's range there has at most SPLIT_ROWS rows (most
// decode ranges hold a few thousand) and writes its W words.  A wider
// range is read by the whole cluster: each CTA takes its share of the rows
// into its own bitset, and after a cluster barrier each CTA ORs its share
// of the words over the cluster's bitsets through distributed shared
// memory and writes them: no global atomics, no zeroing launch, no work
// list.  Read so, a range's rows cost less than its ranks up to ~10^6 rows
// (kernels/fm_search.py:MASK_HIST_MAX_ROWS, the mask modes' default
// hist_max, from bench_dense_mask's sweep).  A shard's range past hist_max
// rows takes the rank route, split over the cluster's CTAs by words: a
// warp four words (128 consecutive tokens) a round, each lane a token of
// each, one __ballot_sync a word.  A bit needs one search, not both
// bounds' ranks: the first row of the token's psi block at or past lo is
// inside the block and its psi is below hi (as kernel 1's contains mode
// asks); the lane's four searches step in lockstep, so four chains of
// dependent psi loads are in flight at once.  Both routes give Occ(c, hi)
// > Occ(c, lo), so the mask equals the plain sweep's counts > 0 exactly.
// Bound: bytes, the histogram route's rows read once and the mask written.

constexpr int MASK_THREADS = 512;
constexpr int CLUSTER = 8;        // CTAs a group of ranges (kernels/fm_search.py:CLUSTER)
constexpr int SPLIT_ROWS = 65536;  // rows a CTA reads alone (kernels/fm_search.py:SPLIT_ROWS)
constexpr int MASK_MAX_WORDS = 1 << 15;  // the bitset's words (128 KB of shared memory)
constexpr int MASK_U = 2;          // 16-byte row loads in flight a thread
// (SPLIT_ROWS and MASK_U: the fastest of 4,096-65,536 rows and of 1-8
// loads, bench_dense_mask at the generation point's dense ranges)

// Four binary searches in lockstep: for each t, the smallest i in
// [lo[t], hi[t]] with psi[i] >= pos (psi increasing there); a round issues
// the four probes before it compares any.
__device__ __forceinline__ void search4(const int* __restrict__ psi, int (&lo)[4], int (&hi)[4],
                                        int pos) {
  bool live = true;
  while (live) {
    int mid[4], v[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      mid[t] = (int)(((unsigned)lo[t] + (unsigned)hi[t]) >> 1);
      v[t] = lo[t] < hi[t] ? __ldg(psi + mid[t]) : 0;
    }
    live = false;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (lo[t] < hi[t]) {
        if (v[t] < pos) {
          lo[t] = mid[t] + 1;
        } else {
          hi[t] = mid[t];
        }
      }
      live |= lo[t] < hi[t];
    }
  }
}

// Whether shifted symbols c[0..3] (0: none) continue [l, h) in a psi
// layout: the first row of c's block at or past l is in the block and its
// psi is below h.  dir is the layout's sym_dir, head_pair its head
// directory (nullptr: none).
__device__ __forceinline__ void psi_has4(const int* __restrict__ psi, const int* __restrict__ dir,
                                         const int* __restrict__ head_pair, int n_rows,
                                         int dir_shift, int sigma, const int (&c)[4], int l, int h,
                                         bool (&ok)[4]) {
  int lo[4], hi[4], end[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    lo[t] = hi[t] = end[t] = 0;
    if (c[t] >= 1 && c[t] < sigma) {
      const Bounds b = symbol_bounds(dir, head_pair, n_rows, dir_shift, c[t], l);
      lo[t] = b.dlo;
      hi[t] = b.dhi;
      end[t] = b.bhi;
    }
  }
  search4(psi, lo, hi, l);
#pragma unroll
  for (int t = 0; t < 4; ++t) ok[t] = lo[t] < end[t] && __ldg(psi + lo[t]) < h;
}

// The Psi index and the stacked shards as the mask kernel reads them:
// shard s's int32 BWT, the row bound its ranges are clamped to, and which
// of four tokens' symbols continue [l, h) there
struct PsiMask {
  PsiDense ix;
  __device__ int n_shards() const { return 1; }
  __device__ int rows(int) const { return ix.n_rows; }
  __device__ const int* bwt(int) const { return ix.bwt; }
  __device__ void has4(int, const int (&c)[4], int l, int h, bool (&ok)[4]) const {
    psi_has4(ix.psi, ix.sym_dir, ix.head_pair, ix.n_rows, ix.dir_shift, ix.sigma, c, l, h, ok);
  }
};

struct ShardMask {
  Shards sh;
  const int* bwt_all;  // [S, n_max]
  __device__ int n_shards() const { return sh.n_shards; }
  __device__ int rows(int) const { return (int)sh.n_max; }
  __device__ const int* bwt(int s) const { return bwt_all + s * sh.n_max; }
  __device__ void has4(int s, const int (&c)[4], int l, int h, bool (&ok)[4]) const {
    psi_has4(sh.psi_of(s), sh.dir_of(s), nullptr, 0, 0, sh.sigma, c, l, h, ok);
  }
};

// four CTAs an SM (at most 32 registers a thread): even on the Psi index
// and faster over 4 shards than without the bound (bench_dense_mask)
template <class Ix>
__global__ void __launch_bounds__(MASK_THREADS, 4)
dense_mask_kernel(Ix ix, const int* __restrict__ lo, const int* __restrict__ hi,
                  unsigned* __restrict__ out, long long n, int vocab, int W, int hist_max) {
  extern __shared__ __align__(16) unsigned bits[];  // W words
  __shared__ unsigned s_wide;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), c = (int)cluster.block_rank();
  const int S = ix.n_shards(), tid = threadIdx.x;
  const long long g0 = (long long)(blockIdx.x / C) * C;  // the group's first range
  // slot j's range: g0 + j; the slots below m hold one
  const auto range_of = [&](int j) { return g0 + j; };
  const int m = (int)min((long long)C, n - g0);
  const int W4 = W >> 2;
  uint4* b4 = reinterpret_cast<uint4*>(bits);
  // the group's ranges that the whole cluster reads: a shard's range past
  // SPLIT_ROWS rows, or past hist_max (ranked); every CTA finds the same
  if (tid == 0) s_wide = 0;
  __syncthreads();
  for (int t = tid; t < m * S; t += MASK_THREADS) {
    const int j = t / S, s = t - j * S;
    const long long q = s * n + range_of(j);
    const int r = ix.rows(s);
    const int w = min(max(hi[q], 0), r) - min(max(lo[q], 0), r);
    if (w > SPLIT_ROWS || w > hist_max) atomicOr(&s_wide, 1u << j);
  }
  __syncthreads();
  const unsigned wide = s_wide;
  if (c < m && !((wide >> c) & 1u)) {  // this CTA's own range
    for (int q = tid; q < W4; q += MASK_THREADS) b4[q] = make_uint4(0, 0, 0, 0);
    __syncthreads();
    for (int s = 0; s < S; ++s) {
      const long long q = s * n + range_of(c);
      const int r = ix.rows(s);
      seal_dense::add_rows<MASK_U>(ix.bwt(s), min(max(lo[q], 0), r), min(max(hi[q], 0), r),
                                   vocab, bits, tid, MASK_THREADS);
    }
    __syncthreads();
    uint4* dst = reinterpret_cast<uint4*>(out + range_of(c) * W);
    for (int q = tid; q < W4; q += MASK_THREADS) dst[q] = b4[q];
  }
  // the cluster's ranges, one at a time; CTA c owns the 4-word groups
  // [q0, q1) of each (its rank words, and the words it ORs and writes)
  const int q0 = (int)((long long)W4 * c / C), q1 = (int)((long long)W4 * (c + 1) / C);
  const int lane = tid & 31, warp = tid >> 5;
  for (unsigned rest = wide; rest != 0; rest &= rest - 1) {
    const int j = __ffs(rest) - 1;
    __syncthreads();  // the bitset's last reader is done
    for (int q = tid; q < W4; q += MASK_THREADS) b4[q] = make_uint4(0, 0, 0, 0);
    __syncthreads();
    for (int s = 0; s < S; ++s) {
      const long long q = s * n + range_of(j);
      const int l = lo[q], h = hi[q], r = ix.rows(s);
      const int r0 = min(max(l, 0), r), r1 = min(max(h, 0), r);
      if (r1 - r0 <= hist_max) {  // this CTA's share of the rows
        const long long len = max(r1 - r0, 0);
        seal_dense::add_rows<MASK_U>(ix.bwt(s), r0 + (int)(len * c / C),
                                     r0 + (int)(len * (c + 1) / C), vocab, bits, tid,
                                     MASK_THREADS);
      } else {  // this CTA's words by rank: a warp four words a round
        for (int q = q0 + warp; q < q1; q += MASK_THREADS / 32) {
          int sym[4];
          bool in[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int tok = 32 * (4 * q + k) + lane;
            sym[k] = tok < vocab ? tok + SHIFT : 0;
          }
          ix.has4(s, sym, l, h, in);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const unsigned word = __ballot_sync(0xffffffffu, in[k]);
            if (lane == 0 && word != 0) atomicOr(bits + 4 * q + k, word);
          }
        }
      }
    }
    cluster.sync();  // every CTA's bitset is whole
    uint4* dst = reinterpret_cast<uint4*>(out + range_of(j) * W);
    for (int q = q0 + tid; q < q1; q += MASK_THREADS) {
      uint4 acc = make_uint4(0, 0, 0, 0);
      for (int k = 0; k < C; ++k) {
        const uint4 v = reinterpret_cast<const uint4*>(cluster.map_shared_rank(bits, k))[q];
        acc.x |= v.x;
        acc.y |= v.y;
        acc.z |= v.z;
        acc.w |= v.w;
      }
      dst[q] = acc;
    }
    cluster.sync();  // no CTA clears or leaves its bitset while another reads it
  }
}

// One launch: ceil(n / CLUSTER) clusters of CLUSTER CTAs, the bitset in
// dynamic shared memory (opted into past 48 KB once a device)
template <class Ix>
int launch_dense_mask(const Ix& ix, const int* lo, const int* hi, unsigned* out, long long n,
                      int vocab, int hist_max, cudaStream_t stream) {
  if (n <= 0 || vocab <= 0) return (int)cudaGetLastError();
  const int W = 4 * ((vocab + 127) / 128);
  if (W > MASK_MAX_WORDS || ((unsigned long long)out & 15)) return (int)cudaErrorInvalidValue;
  const auto kernel = dense_mask_kernel<Ix>;
  const int smem = 4 * W;
  constexpr int MAX_DEVICES = 64;
  static int smem_set[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((n + CLUSTER - 1) / CLUSTER * CLUSTER));
  cfg.blockDim = dim3(MASK_THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, ix, lo, hi, out, n, vocab, W, hist_max);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}

}  // namespace

extern "C" int seal_fm_dense_mask(const int* psi, const int* sym_dir, const int* head_pair,
                                  int n_rows, int sigma, int dir_shift, const int* bwt,
                                  const int* lo, const int* hi, unsigned* out, long long n,
                                  int vocab, int hist_max, void* stream) {
  const PsiMask ix{{psi, sym_dir, head_pair, bwt, n_rows, sigma, dir_shift}};
  return launch_dense_mask(ix, lo, hi, out, n, vocab, hist_max, (cudaStream_t)stream);
}

// lo, hi [n_shards, n]; out [n, W]: each range's mask ORed over the shards
extern "C" int seal_fm_dense_mask_sharded(const int* psi, const int* sym_dir, long long n_max,
                                          int sigma, int n_shards, const int* bwt,
                                          const int* lo, const int* hi, unsigned* out,
                                          long long n, int vocab, int hist_max, void* stream) {
  const ShardMask ix{{psi, sym_dir, n_max, sigma, n_shards}, bwt};
  return launch_dense_mask(ix, lo, hi, out, n, vocab, hist_max, (cudaStream_t)stream);
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
template <int G>
struct SequencesLaunch {
  template <typename... Args>
  static void run(unsigned blocks, cudaStream_t stream, Args... args) {
    sequences_kernel<G><<<blocks, THREADS, 0, stream>>>(args...);
  }
};
template <int G>
struct SequencesShardedLaunch {
  template <typename... Args>
  static void run(unsigned blocks, cudaStream_t stream, Args... args) {
    sequences_sharded_kernel<G><<<blocks, THREADS, 0, stream>>>(args...);
  }
};
template <int G>
struct ContainsShardedLaunch {
  template <typename... Args>
  static void run(unsigned blocks, cudaStream_t stream, Args... args) {
    contains_sharded_kernel<G, false><<<blocks, THREADS, 0, stream>>>(args...);
  }
};
template <int G>
struct ValidateShardedLaunch {
  template <typename... Args>
  static void run(unsigned blocks, cudaStream_t stream, Args... args) {
    contains_sharded_kernel<G, true><<<blocks, THREADS, 0, stream>>>(args...);
  }
};
template <int G>
struct StepShardedLaunch {
  template <typename... Args>
  static void run(unsigned blocks, cudaStream_t stream, Args... args) {
    step_sharded_kernel<G><<<blocks, THREADS, 0, stream>>>(args...);
  }
};

// a team of `team` groups of `group` lanes an item: a power of two, team *
// group <= 32 (the team's lanes aligned in one warp)
static bool bad_team(int n_shards, int group, int team) {
  return n_shards <= 0 || team <= 0 || (team & (team - 1)) != 0 || team * group > 32;
}

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

// kernel 5: `group` lanes a sequence
extern "C" int seal_fm_sequences(const int* psi, const int* sym_dir, const int* head_pair,
                                 int n_rows, int sigma, int dir_shift, const int* tokens,
                                 const int* lengths, int* out_lo, int* out_hi, long long n, int L,
                                 int group, void* stream) {
  return launch_group<SequencesLaunch>(group, n, (cudaStream_t)stream, psi, sym_dir, head_pair,
                                       n_rows, sigma, dir_shift, tokens, lengths, out_lo, out_hi,
                                       n, L);
}

// kernel 5's shard mode: `group` lanes a (shard, sequence), a team of
// `team` groups a sequence (a power of two, team * group <= 32); out_count
// null: the ranges mode
extern "C" int seal_fm_sequences_sharded(const int* psi, const int* sym_dir, long long n_max,
                                         int sigma, int n_shards, const int* n_rows,
                                         const int* tokens, const int* lengths, int* out_lo,
                                         int* out_hi, int* out_count, long long n, int L,
                                         int group, int team, void* stream) {
  if (bad_team(n_shards, group, team)) return (int)cudaErrorInvalidValue;
  const Shards sh{psi, sym_dir, n_max, sigma, n_shards};
  return launch_group<SequencesShardedLaunch>(group, n * team, (cudaStream_t)stream, sh, n_rows,
                                              tokens, lengths, out_lo, out_hi, out_count, n, L,
                                              team);
}

// kernel 1's shard modes: `group` lanes a (shard, item), a team of `team`
// groups an item.  lo, hi [n_shards, n]; tokens [n, m]; out [n, m]: int32
// counts summed (count 1) or membership bytes ORed (count 0)
extern "C" int seal_fm_contains_sharded(const int* psi, const int* sym_dir, long long n_max,
                                        int sigma, int n_shards, const int* tokens, const int* lo,
                                        const int* hi, void* out, long long n, int m, int count,
                                        int group, int team, void* stream) {
  if (bad_team(n_shards, group, team)) return (int)cudaErrorInvalidValue;
  if (m <= 0) return (int)cudaGetLastError();
  const Shards sh{psi, sym_dir, n_max, sigma, n_shards};
  if (count)
    return launch_group<ValidateShardedLaunch>(group, n * m * team, (cudaStream_t)stream, sh,
                                               tokens, lo, hi, out, n, m, team);
  if (group == 1) {  // membership only: a lane a (shard, item)
    const long long lanes = n * m * team;
    if (lanes > 0)
      contains_sharded_kernel<1, false>
          <<<(unsigned)((lanes + THREADS - 1) / THREADS), THREADS, 0, (cudaStream_t)stream>>>(
              sh, tokens, lo, hi, out, n, m, team);
    return (int)cudaGetLastError();
  }
  return launch_group<ContainsShardedLaunch>(group, n * m * team, (cudaStream_t)stream, sh, tokens,
                                             lo, hi, out, n, m, team);
}

// token [n]; lo, hi, out_lo, out_hi [n_shards, n]
extern "C" int seal_fm_backward_step_sharded(const int* psi, const int* sym_dir, long long n_max,
                                             int sigma, int n_shards, const int* token,
                                             const int* lo, const int* hi, int* out_lo,
                                             int* out_hi, long long n, int group, int team,
                                             void* stream) {
  if (bad_team(n_shards, group, team)) return (int)cudaErrorInvalidValue;
  const Shards sh{psi, sym_dir, n_max, sigma, n_shards};
  return launch_group<StepShardedLaunch>(
      group, n * team, (cudaStream_t)stream, sh, token, lo, hi, 0, (const int*)nullptr,
      (const unsigned char*)nullptr, 0, 0, out_lo, out_hi, (int*)nullptr, n, 1, team);
}

// the step mode over the shards: lo, hi [n_shards, n / n_sel, P]; sel_par,
// sel_tok, out_count [n / n_sel, n_sel]; out_lo, out_hi [n_shards, n / n_sel,
// n_sel]; finished [n / n_sel, P] or null (step 0: no stop rule)
extern "C" int seal_fm_advance_sharded(const int* psi, const int* sym_dir, long long n_max,
                                       int sigma, int n_shards, const int* lo, const int* hi,
                                       int P, const int* sel_par, const int* sel_tok,
                                       const unsigned char* finished, int eos, int pad,
                                       int* out_lo, int* out_hi, int* out_count, long long n,
                                       int n_sel, int group, int team, void* stream) {
  if (bad_team(n_shards, group, team) || n_sel <= 0) return (int)cudaErrorInvalidValue;
  const Shards sh{psi, sym_dir, n_max, sigma, n_shards};
  return launch_group<StepShardedLaunch>(group, n * team, (cudaStream_t)stream, sh, sel_tok, lo,
                                         hi, P, sel_par, finished, eos, pad, out_lo, out_hi,
                                         out_count, n, n_sel, team);
}
