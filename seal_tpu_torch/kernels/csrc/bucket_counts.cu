// Kernel 6: the per-bucket symbol counts of BWT[lo:hi), and the
// bucket-support bits the decoder reads.
//
// Replaces seal_tpu/ops/fm_ops.py:bucket_counts (:238), the support-pruning
// input of the exact proposal loop's later rounds.  The count is
// bucket_occ[blk(hi)] - bucket_occ[blk(lo)] (the blocked rank table at both
// bounds) plus a recount of each bound's partial block: the rows
// [blk * R, pos) of BWT, at most R - 1 = 1023 per bound.  Out-of-vocab
// symbols go to a dropped column; the shifted sentinel (0) counts in
// bucket 0, as in the JAX op.
//
// Support mode (seal_bucket_support, what the straggler rounds read): 8
// words a range, bit b of the 256 set iff bucket b's count is > 0 (JAX's
// `bucket_counts(...) > 0`, seal_tpu/decoding/constrained.py:604).  A warp
// a range, four ranges a CTA of 128 threads, each range by the route that
// reads fewer rows:
//   narrow (hi - lo at most the rows the wide route would recount: the
//     common case after the first steps): the range's own rows, each lane
//     ORing its rows'
//     bucket bits into 8 words held in registers, then one
//     __reduce_or_sync a word.  No table, no signed recount.
//   wide: the warp's 256-bucket histogram in shared memory starts at the
//     two table rows' difference (1 KB each, coalesced), each bound's
//     partial rows add or subtract one with shared atomics, and a
//     __ballot_sync of count > 0 over 32 buckets gives each word.  A
//     bound's rows are those between it and its block's nearer end
//     (below it under its block's table row, or above it under the next
//     one's): at most R / 2 = 512 a bound.
// Each lane keeps 8 rows in flight (ROW_UNROLL), so a range of up to 256
// rows is one round of loads.
// Shard mode (seal_bucket_support_sharded): the same warp walks the
// shards, ORing each shard's bits: the counts are non-negative, so their
// sum is > 0 iff some shard's count is.
//
// Counts modes (seal_bucket_counts, seal_bucket_counts_sharded: entry
// points of ops.bucket_counts that no decode path launches): one CTA of
// 256 threads a range with a shared-memory histogram of n_buckets + 1 ints,
// the threads striding over both bounds' partial rows with shared atomics.
//
// Bound on the card: latency and launch, not bytes: a range reads at most
// 2 x 1023 4-byte rows and two 1 KB table rows.  Integer counts and exact
// bits, so every mode equals its plain version.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int SUP_WARPS = 4;      // ranges a CTA of the support modes
constexpr int MAX_BUCKETS = 256;  // 8 words of support bits a range
constexpr int ROW_UNROLL = 8;     // BWT rows a lane has in flight (the support modes)
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
bucket_counts_kernel(const int* __restrict__ bwt, const int* __restrict__ bucket_occ,
                     const int* __restrict__ lo, const int* __restrict__ hi,
                     int* __restrict__ out, int n_rows, int bucket_rows, int bucket_size,
                     int n_buckets) {
  extern __shared__ int hist[];  // n_buckets + 1
  const long long r = blockIdx.x;
  for (int b = threadIdx.x; b <= n_buckets; b += THREADS) hist[b] = 0;
  __syncthreads();
  const int l = min(max(lo[r], 0), n_rows);
  const int h = min(max(hi[r], 0), n_rows);
  const int blk_l = l / bucket_rows;
  const int blk_h = h / bucket_rows;
  const int n_h = h - blk_h * bucket_rows;  // partial rows below hi
  const int n_l = l - blk_l * bucket_rows;  // partial rows below lo
  for (int i = threadIdx.x; i < n_h + n_l; i += THREADS) {
    const bool up = i < n_h;
    const int row = up ? blk_h * bucket_rows + i : blk_l * bucket_rows + (i - n_h);
    const int b = min(__ldg(bwt + row) / bucket_size, n_buckets);
    atomicAdd(&hist[b], up ? 1 : -1);
  }
  __syncthreads();
  const int* occ_h = bucket_occ + (long long)blk_h * n_buckets;
  const int* occ_l = bucket_occ + (long long)blk_l * n_buckets;
  for (int b = threadIdx.x; b < n_buckets; b += THREADS) {
    out[r * n_buckets + b] = hist[b] + __ldg(occ_h + b) - __ldg(occ_l + b);
  }
}

// Shard mode (seal_tpu/parallel/sharded_decode.py:ShardedIndexOps.
// bucket_counts, :138): shards stacked shard-major (bwt [S, n_max],
// bucket_occ [S, occ_rows, n_buckets] on one bucket partition, ranges
// [S, n]).  One CTA per range walks the shards: every shard's partial rows
// go into the one histogram, and its table rows are added per bucket, so
// the output holds the sum over the shards, written once.
__global__ void __launch_bounds__(THREADS)
bucket_counts_sharded_kernel(const int* __restrict__ bwt, const int* __restrict__ bucket_occ,
                             long long n_max, int occ_rows, int n_shards,
                             const int* __restrict__ lo, const int* __restrict__ hi,
                             int* __restrict__ out, long long n, int bucket_rows,
                             int bucket_size, int n_buckets) {
  extern __shared__ int hist[];  // n_buckets + 1
  const long long r = blockIdx.x;
  for (int b = threadIdx.x; b <= n_buckets; b += THREADS) hist[b] = 0;
  __syncthreads();
  for (int s = 0; s < n_shards; ++s) {
    const int l = (int)min(max((long long)lo[s * n + r], 0LL), n_max);
    const int h = (int)min(max((long long)hi[s * n + r], 0LL), n_max);
    const int blk_l = l / bucket_rows, blk_h = h / bucket_rows;
    const int n_h = h - blk_h * bucket_rows, n_l = l - blk_l * bucket_rows;
    const int* b_s = bwt + s * n_max;
    for (int i = threadIdx.x; i < n_h + n_l; i += THREADS) {
      const bool up = i < n_h;
      const int row = up ? blk_h * bucket_rows + i : blk_l * bucket_rows + (i - n_h);
      atomicAdd(&hist[min(__ldg(b_s + row) / bucket_size, n_buckets)], up ? 1 : -1);
    }
    const int* occ = bucket_occ + (long long)s * occ_rows * n_buckets;
    const int* occ_h = occ + (long long)blk_h * n_buckets;
    const int* occ_l = occ + (long long)blk_l * n_buckets;
    // each bucket's table difference is added by one thread: atomics, since
    // other threads may still be recounting this shard's partial rows
    for (int b = threadIdx.x; b < n_buckets; b += THREADS)
      atomicAdd(&hist[b], __ldg(occ_h + b) - __ldg(occ_l + b));
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n_buckets; b += THREADS) out[r * n_buckets + b] = hist[b];
}

// Lane j < 8 of the warp gets word j of the support bits of rows [l, h) of
// one BWT (clamped to [0, n_rows]) and its table occ.  A bound's rank
// comes from its block's nearer end: occ[blk] plus the rows [blk * R, p),
// or, past the block's middle where the next block is whole (below
// `whole`: the index's rows, a shard's own rows), occ[blk + 1] less the
// rows [p, (blk + 1) * R).  hist: the warp's MAX_BUCKETS ints of shared
// memory (the wide route).
__device__ unsigned support_range(const int* __restrict__ bwt, const int* __restrict__ occ,
                                  int l, int h, int n_rows, int whole, int R, int bucket_size,
                                  int n_buckets, int* hist, int lane) {
  l = min(max(l, 0), n_rows);
  h = min(max(h, 0), n_rows);
  if (h <= l) return 0u;
  const int blk_l = l / R, blk_h = h / R;
  const int n_l = l - blk_l * R, n_h = h - blk_h * R;  // rows below lo, hi in their blocks
  const bool up_l = 2 * n_l > R && (blk_l + 1) * R <= whole;
  const bool up_h = 2 * n_h > R && (blk_h + 1) * R <= whole;
  // each bound's rows: [a, a + n) with its sign
  const int a_h = up_h ? h : blk_h * R, c_h = up_h ? R - n_h : n_h;
  const int a_l = up_l ? l : blk_l * R, c_l = up_l ? R - n_l : n_l;
  unsigned mine = 0;
  if (h - l <= c_h + c_l) {  // narrow: the range's own rows, ORed
    unsigned acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int base = l; base < h; base += 32 * ROW_UNROLL) {
      int sym[ROW_UNROLL];
#pragma unroll
      for (int u = 0; u < ROW_UNROLL; ++u) {
        const int row = base + 32 * u + lane;
        sym[u] = row < h ? __ldg(bwt + row) : -1;
      }
#pragma unroll
      for (int u = 0; u < ROW_UNROLL; ++u) {
        const int b = sym[u] / bucket_size;
        if (sym[u] >= 0 && b < n_buckets) {
          const unsigned bit = 1u << (b & 31);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[j] |= (b >> 5) == j ? bit : 0u;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const unsigned w = __reduce_or_sync(FULL, acc[j]);
      if (lane == j) mine = w;
    }
    return mine;
  }
  // wide: the two table rows' difference, then each bound's rows added or
  // subtracted (+ for hi's rows below it or lo's above it)
  const int* occ_h = occ + (long long)(blk_h + up_h) * n_buckets;
  const int* occ_l = occ + (long long)(blk_l + up_l) * n_buckets;
  for (int b = lane; b < n_buckets; b += 32) hist[b] = __ldg(occ_h + b) - __ldg(occ_l + b);
  __syncwarp();
  const int sign_h = up_h ? -1 : 1, sign_l = up_l ? 1 : -1;
  for (int base = 0; base < c_h + c_l; base += 32 * ROW_UNROLL) {
    int sym[ROW_UNROLL];
#pragma unroll
    for (int u = 0; u < ROW_UNROLL; ++u) {
      const int i = base + 32 * u + lane;
      sym[u] = i < c_h + c_l ? __ldg(bwt + (i < c_h ? a_h + i : a_l + (i - c_h))) : -1;
    }
#pragma unroll
    for (int u = 0; u < ROW_UNROLL; ++u) {
      const int i = base + 32 * u + lane;
      const int b = sym[u] / bucket_size;
      if (sym[u] >= 0 && b < n_buckets) atomicAdd(&hist[b], i < c_h ? sign_h : sign_l);
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int b = 32 * j + lane;
    const unsigned w = __ballot_sync(FULL, b < n_buckets && hist[b] > 0);
    if (lane == j) mine = w;
  }
  __syncwarp();  // the histogram is read before a next range reuses it
  return mine;
}

__global__ void __launch_bounds__(32 * SUP_WARPS)
bucket_support_kernel(const int* __restrict__ bwt, const int* __restrict__ bucket_occ,
                      const int* __restrict__ lo, const int* __restrict__ hi,
                      unsigned* __restrict__ out, long long n, int n_rows, int bucket_rows,
                      int bucket_size, int n_buckets) {
  __shared__ int hist[SUP_WARPS][MAX_BUCKETS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * SUP_WARPS + warp;
  if (r >= n) return;
  const unsigned w = support_range(bwt, bucket_occ, __ldg(lo + r), __ldg(hi + r), n_rows,
                                   n_rows, bucket_rows, bucket_size, n_buckets, hist[warp],
                                   lane);
  if (lane < 8) out[r * 8 + lane] = w;
}

// shards stacked shard-major as in the counts' shard mode; ranges [S, n];
// shard_rows [S]: each shard's own rows (its padding holds the sentinel,
// which the table does not count, so a bound reads its block's upper end
// only where that block is all the shard's own)
__global__ void __launch_bounds__(32 * SUP_WARPS)
bucket_support_sharded_kernel(const int* __restrict__ bwt, const int* __restrict__ bucket_occ,
                              long long n_max, int occ_rows, int n_shards,
                              const int* __restrict__ shard_rows,
                              const int* __restrict__ lo, const int* __restrict__ hi,
                              unsigned* __restrict__ out, long long n, int bucket_rows,
                              int bucket_size, int n_buckets) {
  __shared__ int hist[SUP_WARPS][MAX_BUCKETS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * SUP_WARPS + warp;
  if (r >= n) return;
  unsigned w = 0;
  for (int s = 0; s < n_shards; ++s)
    w |= support_range(bwt + s * n_max, bucket_occ + (long long)s * occ_rows * n_buckets,
                       __ldg(lo + s * n + r), __ldg(hi + s * n + r), (int)n_max,
                       __ldg(shard_rows + s), bucket_rows, bucket_size, n_buckets, hist[warp],
                       lane);
  if (lane < 8) out[r * 8 + lane] = w;
}

}  // namespace

extern "C" int seal_bucket_counts_sharded(const int* bwt, const int* bucket_occ, long long n_max,
                                          int occ_rows, int n_shards, const int* lo, const int* hi,
                                          int* out, long long n, int bucket_rows, int bucket_size,
                                          int n_buckets, void* stream) {
  if (n > 0) {
    const size_t smem = (size_t)(n_buckets + 1) * sizeof(int);
    bucket_counts_sharded_kernel<<<(unsigned)n, THREADS, smem, (cudaStream_t)stream>>>(
        bwt, bucket_occ, n_max, occ_rows, n_shards, lo, hi, out, n, bucket_rows, bucket_size,
        n_buckets);
  }
  return (int)cudaGetLastError();
}

extern "C" int seal_bucket_counts(const int* bwt, const int* bucket_occ, const int* lo,
                                  const int* hi, int* out, long long n, int n_rows,
                                  int bucket_rows, int bucket_size, int n_buckets, void* stream) {
  if (n > 0) {
    const size_t smem = (size_t)(n_buckets + 1) * sizeof(int);
    bucket_counts_kernel<<<(unsigned)n, THREADS, smem, (cudaStream_t)stream>>>(
        bwt, bucket_occ, lo, hi, out, n_rows, bucket_rows, bucket_size, n_buckets);
  }
  return (int)cudaGetLastError();
}

// out [n, 8] words, bit b of a range's 256 set iff bucket b's count > 0
extern "C" int seal_bucket_support(const int* bwt, const int* bucket_occ, const int* lo,
                                   const int* hi, unsigned* out, long long n, int n_rows,
                                   int bucket_rows, int bucket_size, int n_buckets, void* stream) {
  if (n_buckets < 1 || n_buckets > MAX_BUCKETS) return (int)cudaErrorInvalidValue;
  if (n > 0)
    bucket_support_kernel<<<(unsigned)((n + SUP_WARPS - 1) / SUP_WARPS), 32 * SUP_WARPS, 0,
                            (cudaStream_t)stream>>>(bwt, bucket_occ, lo, hi, out, n, n_rows,
                                                    bucket_rows, bucket_size, n_buckets);
  return (int)cudaGetLastError();
}

// the shard mode: out [n, 8], each shard's bits ORed
extern "C" int seal_bucket_support_sharded(const int* bwt, const int* bucket_occ, long long n_max,
                                           int occ_rows, int n_shards, const int* shard_rows,
                                           const int* lo, const int* hi, unsigned* out, long long n,
                                           int bucket_rows, int bucket_size, int n_buckets,
                                           void* stream) {
  if (n_buckets < 1 || n_buckets > MAX_BUCKETS) return (int)cudaErrorInvalidValue;
  if (n > 0)
    bucket_support_sharded_kernel<<<(unsigned)((n + SUP_WARPS - 1) / SUP_WARPS),
                                    32 * SUP_WARPS, 0, (cudaStream_t)stream>>>(
        bwt, bucket_occ, n_max, occ_rows, n_shards, shard_rows, lo, hi, out, n, bucket_rows,
        bucket_size, n_buckets);
  return (int)cudaGetLastError();
}
