// Kernel 13: window rows of the wavelet layouts fused with the log-prob
// gather.
//
// Replaces seal_tpu/ops/wt_ops.py: access (:115) with _digit_at, bwt_at
// (:154) and window_continuations (:176, through seal_tpu/ops/_generic.py:
// window_continuations), and the take_along_axis of the log-probs that
// follows them in seal_tpu/decoding/constrained.py.  The rows and the
// output are kernel 2's (window_gather.cu): for range [lo, hi) and slot
// j < w, row lo + j * max((hi - lo) / w, 1); the symbol is unshifted, the
// sentinel and out-of-vocabulary symbols are dropped, invalid slots carry
// `fill`, and lp[range, token] is read.  Two modes:
//
// * descent (compact layout, BWT_BYTES 0): per slot, `digits` levels, each
//   reading the digit at x and then its rank in the same block;
// * direct (hybrid layout, BWT_BYTES 2 or 4): one read of the raw BWT at
//   the JAX width (uint16 when the alphabet fits 16 bits, else 32 bits).
//
// Bound on the card: latency.  ~15k slots a decode step, each a dependent
// chain (`digits` block reads, or one 2-4 byte read) and then one
// scattered log-prob read; the bytes are a few hundred KB.  One thread per
// slot keeps all chains independent across threads; fusing the lp read
// saves a launch and the token ids' round trip through memory.

#include "wt_common.cuh"

namespace {

using seal_wt::Index;
using seal_wt::SHIFT;

constexpr int THREADS = 256;

template <int BWT_BYTES>
__global__ void __launch_bounds__(THREADS)
wt_window_kernel(Index ix, const void* __restrict__ bwt, const float* __restrict__ lp,
                 long long lp_stride, const int* __restrict__ lo, const int* __restrict__ hi,
                 long long n, int w, int vocab, int fill, int* __restrict__ tok,
                 unsigned char* __restrict__ valid, float* __restrict__ lp_out) {
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
    sym = seal_wt::symbol_at<BWT_BYTES>(ix, bwt, row) - SHIFT;
    ok = sym >= 0 && sym < vocab;
  }
  const int tk = ok ? sym : fill;
  tok[t] = tk;
  valid[t] = ok ? 1 : 0;
  lp_out[t] = __ldg(lp + r * lp_stride + tk);
}

}  // namespace

extern "C" int seal_wt_window_gather(const uint32_t* blocks, const int* node_start,
                                     const int* node_cnt, const int* C, long long n_blocks,
                                     int n_rows, int digits, int sigma, const void* bwt,
                                     int bwt_bytes, const float* lp, long long lp_stride,
                                     const int* lo, const int* hi, long long n, int w, int vocab,
                                     int fill, int* tok, unsigned char* valid, float* lp_out,
                                     void* stream) {
  if (n > 0 && w > 0) {
    const Index ix{blocks, node_start, node_cnt, C, n_blocks, n_rows, digits, sigma};
    const unsigned grid = (unsigned)((n * w + THREADS - 1) / THREADS);
    cudaStream_t s = (cudaStream_t)stream;
    if (bwt == nullptr) {
      wt_window_kernel<0><<<grid, THREADS, 0, s>>>(ix, bwt, lp, lp_stride, lo, hi, n, w, vocab,
                                                   fill, tok, valid, lp_out);
    } else if (bwt_bytes == 2) {
      wt_window_kernel<2><<<grid, THREADS, 0, s>>>(ix, bwt, lp, lp_stride, lo, hi, n, w, vocab,
                                                   fill, tok, valid, lp_out);
    } else if (bwt_bytes == 4) {
      wt_window_kernel<4><<<grid, THREADS, 0, s>>>(ix, bwt, lp, lp_stride, lo, hi, n, w, vocab,
                                                   fill, tok, valid, lp_out);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
