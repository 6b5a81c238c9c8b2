// Kernel 14: the per-bucket symbol counts of BWT[lo:hi) by wavelet
// interval bisection, and the bucket-support bits the decoder reads.
//
// Replaces seal_tpu/ops/wt_ops.py:bucket_counts (:203), the
// support-pruning input of the exact proposal loop's later rounds in the
// wavelet layouts.  The range is tracked through the prefix nodes of the
// top depth = min(2, digits) levels: level 0 ranks each of the 16 digits
// at lo and at hi in the root's sequence, which gives the range inside each
// of the 16 child nodes; level 1 does the same in each child.  Bucket
// (n, v) = 16 n + v holds the symbols whose top two digits are n, v: 256
// buckets of 16^(digits - 2) symbols (16 buckets when digits is 1).
//
// Support mode (seal_wt_bucket_support, what the straggler rounds read):
// 8 words a range, bit b of the 256 set iff bucket b's count is > 0, as in
// JAX's `bucket_counts(...) > 0` (seal_tpu/decoding/constrained.py:604).
// A CTA of four warps a range.  Level 0 (each warp alike): lane d of the
// first half-warp takes digit d's rank at hi (in one block with lo: the
// count of d between them), lane d of the second its rank at lo, with the
// level's node row (node_start of the 16 children, the root's start ranks)
// loaded in the same round; a shuffle gives each child its range.  Level 1
// descends only into the children whose range is non-empty, two a round a
// warp (a half-warp a node, a lane a digit; the warps take turns, so 16
// children are two rounds): the digit's count between the bounds
// where both fall in one block (a narrow range: a word or two), else the
// difference of two ranks, each from its block's nearer half
// (wt_common.cuh:rank_near).  A ballot of count > 0 gives the node's 16
// bits; lanes 0-7 keep the 8 words, and one barrier ORs the warps' words
// (32 bytes a range out).  A narrow range reads a few blocks, where the
// counts mode ranks 32 + 512 (bound, node, digit) positions in a
// 512-thread CTA with a barrier between the levels.
//
// Counts mode (seal_wt_bucket_counts, an entry point of ops.bucket_counts
// no decode path launches): one CTA of 512 threads a range, level 0 on the
// first 32 threads (bound, digit), the children's bounds through shared
// memory, level 1 on all 512 (bound, node, digit); the count is
// max(hi' - lo', 0) of the last level's bounds.
//
// Bound on the card: latency and launch, not bytes: a range reads a few
// 192-byte blocks, mostly hitting in L1/L2.  Integer counts and exact
// bits: both modes equal their plain versions.

#include "wt_common.cuh"

namespace {

using seal_wt::Index;
using seal_wt::RADIX;

constexpr int THREADS = 2 * RADIX * RADIX;  // (bound, node, digit) at level 1
constexpr int SUP_WARPS = 4;                // warps a range (a CTA) in the support mode
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
wt_bucket_counts_kernel(Index ix, const int* __restrict__ lo, const int* __restrict__ hi,
                        int* __restrict__ out, int depth) {
  __shared__ int child[2][RADIX];             // level 0: (bound, digit)
  __shared__ int grand[2][RADIX * RADIX];     // level 1: (bound, node * 16 + digit)
  const long long r = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < 2 * RADIX) {
    const int bound = tid / RADIX;
    const int v = tid % RADIX;
    int x = __ldg(ix.node_start) + (bound ? hi[r] : lo[r]);
    const uint32_t* blk = seal_wt::block_of(ix, 0, x);
    child[bound][v] = seal_wt::rank_in_block(blk, x, v) - __ldg(ix.node_cnt + v);
  }
  __syncthreads();
  if (depth == 1) {
    if (tid < RADIX) out[r * RADIX + tid] = max(child[1][tid] - child[0][tid], 0);
    return;
  }
  {
    const int bound = tid / (RADIX * RADIX);
    const int b = tid % (RADIX * RADIX);
    const int node = 1 + b / RADIX;  // heap_base(1) + n
    const int v = b % RADIX;
    int x = __ldg(ix.node_start + node) + child[bound][b / RADIX];
    const uint32_t* blk = seal_wt::block_of(ix, 1, x);
    grand[bound][b] = seal_wt::rank_in_block(blk, x, v) - __ldg(ix.node_cnt + node * RADIX + v);
  }
  __syncthreads();
  if (tid < RADIX * RADIX) {
    out[r * RADIX * RADIX + tid] = max(grand[1][tid] - grand[0][tid], 0);
  }
}

// Lanes j < 8 of warp `warp` get word j of its share of range [lo, hi)'s
// support bits: level 0 (every warp: the loads hit L1) and the non-empty
// children taken two a round, pairs warp, warp + SUP_WARPS, ...
__device__ unsigned wt_support(const Index& ix, int lo, int hi, int depth, int lane, int warp) {
  const int d = lane & 15, half = lane >> 4;
  const int l = min(max(lo, 0), ix.n_rows), h = min(max(hi, 0), ix.n_rows);
  if (h <= l) return 0u;
  // level 0: half 0 the upper rank (or the count between), half 1 the lower
  const int start = __ldg(ix.node_start);
  int xl = start + l;
  const int xh = start + h;
  const bool one = (xl >> 8) == (xh >> 8);
  int v;
  if (half == 0 && one) {
    const uint32_t* blk = seal_wt::block_of(ix, 0, xl);
    v = seal_wt::count_between(blk, xl & 255, xh & 255, d);
  } else {
    v = seal_wt::rank_near(ix, 0, half ? xl : xh, d);
  }
  // the level's node row in the same round: the children's starts, the
  // root's start ranks
  const int c0 = __ldg(ix.node_cnt + d);
  const int ns1 = depth > 1 ? __ldg(ix.node_start + 1 + d) : 0;
  const int rl = __shfl_down_sync(FULL, v, 16);  // lanes < 16: digit d's lower rank
  const int cnt = one ? v : v - rl;
  const unsigned kids = __ballot_sync(FULL, half == 0 && cnt > 0) & 0xffffu;
  if (depth == 1) return warp == 0 && lane == 0 ? kids : 0u;
  const int clo = rl - c0;
  unsigned mine = 0, m = kids;
  for (int i = 0; i < 2 * warp && m; ++i) m &= m - 1;  // the pairs before this warp's
  while (m) {  // two non-empty children a round, a half-warp each
    const int n0 = __ffs(m) - 1;
    m &= m - 1;
    const int n1 = m ? __ffs(m) - 1 : -1;
    if (m) m &= m - 1;
    const int node = half ? n1 : n0;
    const int src = node < 0 ? 0 : node;
    const int s = __shfl_sync(FULL, ns1, src);
    const int a = __shfl_sync(FULL, clo, src);
    const int c = __shfl_sync(FULL, cnt, src);
    int got = 0;
    if (node >= 0) {
      int xa = s + a;
      const int xb = xa + c;
      if ((xa >> 8) == (xb >> 8)) {
        const uint32_t* blk = seal_wt::block_of(ix, 1, xa);
        got = seal_wt::count_between(blk, xa & 255, xb & 255, d);
      } else {
        got = seal_wt::rank_near(ix, 1, xb, d) - seal_wt::rank_near(ix, 1, xa, d);
      }
    }
    // bucket 16 * node + d: word node / 2, bit 16 * (node & 1) + d
    const unsigned ball = __ballot_sync(FULL, got > 0);
    if (lane == (n0 >> 1)) mine |= (ball & 0xffffu) << (16 * (n0 & 1));
    if (n1 >= 0 && lane == (n1 >> 1)) mine |= (ball >> 16) << (16 * (n1 & 1));
    for (int i = 0; i < 2 * (SUP_WARPS - 1) && m; ++i) m &= m - 1;  // the other warps' pairs
  }
  return mine;
}

// one CTA a range: each warp's words ORed through shared memory
__global__ void __launch_bounds__(32 * SUP_WARPS)
wt_bucket_support_kernel(Index ix, const int* __restrict__ lo, const int* __restrict__ hi,
                         unsigned* __restrict__ out, int depth) {
  __shared__ unsigned s_words[SUP_WARPS][8];
  const long long r = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned w = wt_support(ix, __ldg(lo + r), __ldg(hi + r), depth, lane, warp);
  if (lane < 8) s_words[warp][lane] = w;
  __syncthreads();
  if (threadIdx.x < 8) {
    unsigned all = 0;
#pragma unroll
    for (int k = 0; k < SUP_WARPS; ++k) all |= s_words[k][threadIdx.x];
    out[r * 8 + threadIdx.x] = all;
  }
}

}  // namespace

extern "C" int seal_wt_bucket_counts(const uint32_t* blocks, const int* node_start,
                                     const int* node_cnt, const int* C, long long n_blocks,
                                     int n_rows, int digits, int sigma, const int* lo,
                                     const int* hi, int* out, long long n, int depth,
                                     void* stream) {
  if (depth < 1 || depth > 2 || depth > digits) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const Index ix{blocks, node_start, node_cnt, C, n_blocks, n_rows, digits, sigma};
    wt_bucket_counts_kernel<<<(unsigned)n, THREADS, 0, (cudaStream_t)stream>>>(ix, lo, hi, out,
                                                                               depth);
  }
  return (int)cudaGetLastError();
}

// out [n, 8] words, bit b of a range's 256 set iff bucket b's count > 0
extern "C" int seal_wt_bucket_support(const uint32_t* blocks, const int* node_start,
                                      const int* node_cnt, const int* C, long long n_blocks,
                                      int n_rows, int digits, int sigma, const int* lo,
                                      const int* hi, unsigned* out, long long n, int depth,
                                      void* stream) {
  if (depth < 1 || depth > 2 || depth > digits) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const Index ix{blocks, node_start, node_cnt, C, n_blocks, n_rows, digits, sigma};
    wt_bucket_support_kernel<<<(unsigned)n, 32 * SUP_WARPS, 0, (cudaStream_t)stream>>>(
        ix, lo, hi, out, depth);
  }
  return (int)cudaGetLastError();
}
