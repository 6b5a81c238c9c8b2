// Kernel 6: exact per-bucket symbol counts of BWT[lo:hi).
//
// Replaces seal_tpu/ops/fm_ops.py:bucket_counts (:238), the support-pruning
// input of the exact proposal loop's later rounds.  The count is
// bucket_occ[blk(hi)] - bucket_occ[blk(lo)] (the blocked rank table at both
// bounds) plus a recount of each bound's partial block: the rows
// [blk * R, pos) of BWT, at most R - 1 = 1023 per bound.
//
// Bound on the card: latency and launch, not bytes.  A range reads at most
// 2 x 1023 4-byte BWT rows (8 KB) and two 1 KB table rows; at the decode's
// [16, 15] ranges that is a few hundred KB in all.  One CTA per range keeps
// a shared-memory histogram of n_buckets + 1 ints (the last one catches
// out-of-vocab symbols, which the caller drops); its threads stride over
// the partial rows of both bounds, adding for hi and subtracting for lo,
// with shared-memory atomics.  Integer counts, so the order of the atomics
// does not matter: the result equals the plain version exactly.  The
// shifted sentinel (0) counts in bucket 0, as in the JAX op.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

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
