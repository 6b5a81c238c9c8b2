// Kernel 2: fused BWT window gather + log-prob gather.
//
// Replaces seal_tpu/ops/fm_ops.py: bwt_at, seal_tpu/ops/_generic.py:
// window_continuations, and the take_along_axis of the log-probs that
// follows them in seal_tpu/decoding/constrained.py (_exact_slots and the
// merge_round slab).  For each range [lo, hi) and slot j < w it reads BWT
// row lo + j * max((hi - lo) / w, 1) (exhaustive when the range has at most
// w rows, a strided sample otherwise), unshifts the symbol, drops the
// sentinel and out-of-vocabulary symbols, and reads lp[range, token].
//
// Bound on the card: two dependent scattered 4-byte loads per slot (the
// BWT row, then the log-prob), ~15k slots a decode step; it is latency and
// launch bound, not bandwidth bound.  One thread per slot keeps all loads
// independent across threads, and fusing the lp read saves the separate
// gather launch and the round trip of the token ids through memory.

#include <cuda_runtime.h>

namespace {

constexpr int SHIFT = 1;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
window_gather_kernel(const int* __restrict__ bwt, const float* __restrict__ lp,
                     long long lp_stride, const int* __restrict__ lo,
                     const int* __restrict__ hi, long long n, int w, int vocab, int fill,
                     int* __restrict__ tok, unsigned char* __restrict__ valid,
                     float* __restrict__ lp_out) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= n * w) return;
  const long long r = t / w;
  const int j = (int)(t - r * w);
  const int l = lo[r];
  const int h = hi[r];
  const int size = max(h - l, 0);
  const int stride = max(size / w, 1);
  const long long row = (long long)l + (long long)j * stride;
  bool ok = row < h;
  int sym = -1;
  if (ok) {
    sym = __ldg(bwt + row) - SHIFT;
    ok = sym >= 0 && sym < vocab;
  }
  const int tk = ok ? sym : fill;
  tok[t] = tk;
  valid[t] = ok ? 1 : 0;
  lp_out[t] = __ldg(lp + r * lp_stride + tk);
}

// Shard mode (seal_tpu/parallel/sharded_decode.py:ShardedIndexOps.window,
// :100-118): shards stacked shard-major (bwt [S, n_max], ranges [S, n]);
// one thread per (shard, range, slot) writes union slot s * w + j of its
// range, so the shards' slices are disjoint and nothing is merged.
__global__ void __launch_bounds__(THREADS)
window_gather_sharded_kernel(const int* __restrict__ bwt, long long n_max, int n_shards,
                             const float* __restrict__ lp, long long lp_stride,
                             const int* __restrict__ lo, const int* __restrict__ hi, long long n,
                             int w, int vocab, int fill, int* __restrict__ tok,
                             unsigned char* __restrict__ valid, float* __restrict__ lp_out) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= n_shards * n * w) return;
  const long long q = t / w;  // shard-major range index s * n + r
  const int j = (int)(t - q * w);
  const int s = (int)(q / n);
  const long long r = q - s * n;
  const int l = lo[q];
  const int h = hi[q];
  const int stride = max(max(h - l, 0) / w, 1);
  const long long row = (long long)l + (long long)j * stride;
  bool ok = row < h;
  int sym = -1;
  if (ok) {
    sym = __ldg(bwt + s * n_max + row) - SHIFT;
    ok = sym >= 0 && sym < vocab;
  }
  const int tk = ok ? sym : fill;
  const long long at = r * ((long long)n_shards * w) + (long long)s * w + j;
  tok[at] = tk;
  valid[at] = ok ? 1 : 0;
  lp_out[at] = __ldg(lp + r * lp_stride + tk);
}

}  // namespace

extern "C" int seal_window_gather_sharded(const int* bwt, long long n_max, int n_shards,
                                          const float* lp, long long lp_stride, const int* lo,
                                          const int* hi, long long n, int w, int vocab, int fill,
                                          int* tok, unsigned char* valid, float* lp_out,
                                          void* stream) {
  if (n > 0 && w > 0 && n_shards > 0) {
    const long long threads = n_shards * n * w;
    const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
    window_gather_sharded_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        bwt, n_max, n_shards, lp, lp_stride, lo, hi, n, w, vocab, fill, tok, valid, lp_out);
  }
  return (int)cudaGetLastError();
}

extern "C" int seal_window_gather(const int* bwt, const float* lp, long long lp_stride,
                                  const int* lo, const int* hi, long long n, int w, int vocab,
                                  int fill, int* tok, unsigned char* valid, float* lp_out,
                                  void* stream) {
  if (n > 0 && w > 0) {
    const long long threads = n * w;
    const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
    window_gather_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        bwt, lp, lp_stride, lo, hi, n, w, vocab, fill, tok, valid, lp_out);
  }
  return (int)cudaGetLastError();
}
