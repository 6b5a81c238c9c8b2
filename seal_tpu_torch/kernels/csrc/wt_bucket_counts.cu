// Kernel 14: exact per-bucket symbol counts of BWT[lo:hi) by wavelet
// interval bisection.
//
// Replaces seal_tpu/ops/wt_ops.py:bucket_counts (:203), the
// support-pruning input of the exact proposal loop's later rounds in the
// wavelet layouts.  The range is tracked through every prefix node of the
// top depth = min(2, digits) levels: level 0 ranks each of the 16 digits
// at lo and at hi in the root's sequence, which gives the range inside each
// of the 16 child nodes; level 1 does the same in each child.  Bucket
// (n, v) = 16 n + v counts the symbols whose top two digits are n, v: 256
// buckets of 16^(digits - 2) symbols (16 buckets when digits is 1).  The
// count is max(hi' - lo', 0) of the last level's bounds.
//
// Bound on the card: latency and launch, not bytes.  A range reads 32
// blocks at level 0 (one per digit and bound, all the same two blocks) and
// 512 at level 1, 192 bytes each, a few KB that mostly hit in L1/L2.  One
// CTA of 512 threads per range: level 0 on the first 32 threads (bound,
// digit), the children's bounds through shared memory, level 1 on all 512
// (bound, node, digit).  Integer counts: equal to the plain version.

#include "wt_common.cuh"

namespace {

using seal_wt::Index;
using seal_wt::RADIX;

constexpr int THREADS = 2 * RADIX * RADIX;  // (bound, node, digit) at level 1

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
