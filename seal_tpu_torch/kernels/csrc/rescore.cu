// Kernel 7: the per-key teacher-forced LM score of key rescoring.
//
// Replaces the reduction of seal_tpu/scoring/keys.py:_jitted_rescore
// (:102): per key, the sum over decoder positions t >= n_prefix of
// logits[t, tgt[t]] - logsumexp(logits[t, :]), with the terms of targets
// below 2 (bos, pad) set to zero.
//
// Bound on the card: bytes.  The logits are f32 [N, T, V]; at a rescoring
// sub-batch [256, 15, 50265] that is 772 MB, read twice per row (a max
// pass and a sum-exp pass; the second mostly hits L2, a row is 201 KB).
// One CTA of 1024 threads per key walks its positions in order: a block
// max, a block sum of exp(x - max), then thread 0 adds x[tgt] - max -
// log(sum) to the key's total.  Positions with tgt < 2 are skipped, which
// is the zero term.  The reductions have a fixed tree (warp xor
// butterflies, then one warp over the 32 partials) and the total is summed
// in t order, so the result is the same from run to run: the searcher's
// score ties depend on that.  The total is kept in f64 (at most 16 adds of
// terms near -10 each; an f32 total would add up to ~1e-4 of rounding at
// -200), so the kernel differs from the plain version (torch's logsumexp
// and f32 sum) by that version's own rounding and the order of the row
// sums only.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 1024;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// every thread returns the block's reduction
template <bool MAX>
__device__ float block_reduce(float v, float* red) {
  v = MAX ? warp_max(v) : warp_sum(v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read by the previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[lane];  // THREADS / 32 == 32 partials
  return MAX ? warp_max(v) : warp_sum(v);
}

__global__ void __launch_bounds__(THREADS)
rescore_kernel(const float* __restrict__ logits, const int* __restrict__ targets,
               float* __restrict__ out, int T, int V, int n_prefix) {
  __shared__ float red[32];
  const long long key = blockIdx.x;
  double total = 0.0;  // kept by thread 0
  for (int t = n_prefix; t < T; ++t) {
    const int tgt = targets[key * T + t];
    if (tgt < 2) continue;  // the same branch for the whole block
    const float* row = logits + (key * T + t) * (long long)V;
    float m = -INFINITY;
    for (int i = threadIdx.x; i < V; i += THREADS) m = fmaxf(m, __ldg(row + i));
    m = block_reduce<true>(m, red);
    float s = 0.0f;
    for (int i = threadIdx.x; i < V; i += THREADS) s += expf(__ldg(row + i) - m);
    s = block_reduce<false>(s, red);
    if (threadIdx.x == 0) total += (__ldg(row + tgt) - m) - logf(s);
  }
  if (threadIdx.x == 0) out[key] = (float)total;
}

}  // namespace

extern "C" int seal_rescore_logprob(const float* logits, const int* targets, float* out,
                                    long long n, int T, int V, int n_prefix, void* stream) {
  if (n > 0) {
    rescore_kernel<<<(unsigned)n, THREADS, 0, (cudaStream_t)stream>>>(logits, targets, out, T,
                                                                        V, n_prefix);
  }
  return (int)cudaGetLastError();
}
