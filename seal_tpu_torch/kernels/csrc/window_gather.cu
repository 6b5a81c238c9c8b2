// Kernel 2: fused BWT window gather + log-prob gather, in three modes and
// a shard mode, all through one kernel (window_slab_kernel).
//
// Replaces seal_tpu/ops/fm_ops.py: bwt_at, seal_tpu/ops/_generic.py:
// window_continuations, and the take_along_axis of the log-probs that
// follows them in seal_tpu/decoding/constrained.py (_exact_slots :385-387
// and the merge_round slab :622-635).  For each range [lo, hi):
//
// * the window: slot j < w reads BWT row lo + j * max((hi - lo) / w, 1)
//   (exhaustive when the range has at most w rows, a strided sample
//   otherwise), invalid slots carry fill_win;
// * the slab: slot j < width reads row s_lo + j of [s_lo, s_hi), s_lo =
//   min(lo + rows_prev, hi), s_hi = min(s_lo + width, hi) (merge_round's
//   bounds, computed here), invalid slots carry token 0 (merge_round's).
//
// Each slot unshifts the symbol, drops the sentinel and out-of-vocabulary
// symbols, and reads lp[range, token].  The window + slab mode is a decode
// step's window and its proposal round 0's slab (rows_prev 0) in one
// launch; the slab mode alone is a straggler round's; the window mode alone
// is the speculative step's.  The shard mode (seal_tpu/parallel/
// sharded_decode.py:ShardedIndexOps.window, :100-118) stacks the shards
// shard-major (bwt [S, n_max], ranges [S, n]) and writes union slot s * w +
// j (s * width + j for the slab) of its range: the shards' slices are
// disjoint and nothing is merged.
//
// Bound on the card: latency and launch.  ~15k window and ~31k slab slots
// a decode step at the bench point, each a scattered 4-byte BWT read and
// then a scattered lp read: a few hundred KB.  A warp takes one range (and
// one segment of both outputs): its lanes read lo and hi at one address (a
// broadcast load, where reading them in two lanes and a shuffle would add
// a dependent step), each lane issues its slab and window reads back to
// back, then its lp reads.  Where the window is stride
// 1 (hi - lo < 2w) and no wider than round 0's slab, window slot j is slab
// slot j, the same row: the lane reuses the slab's symbol and lp and reads
// nothing more.  The launch shape follows the mode: with a slab, a lane
// takes two slots of each output (a 64-slot segment a warp) in CTAs of two
// warps, so the bench's 480 ranges spread over every SM; the window alone
// (w 32 in most steps) takes one slot a lane in CTAs of four warps, where
// two slots a lane would leave half the lanes' second slot empty, in an
// instance built without the slab's code.

#include <cuda_runtime.h>

namespace {

constexpr int SHIFT = 1;

struct Out {
  int* tok;
  unsigned char* valid;
  float* lp;
};

__device__ __forceinline__ bool in_vocab(int sym, int vocab) { return sym >= 0 && sym < vocab; }

// PER: slots of each output a lane takes in a segment of 32 * PER; WARPS:
// warps (ranges) a CTA; SLAB: whether the launch has a slab (width > 0)
template <int PER, int WARPS, bool SLAB>
__global__ void __launch_bounds__(32 * WARPS)
window_slab_kernel(const int* __restrict__ bwt, long long n_max, int n_shards,
                   const float* __restrict__ lp, long long lp_stride,
                   const int* __restrict__ lo, const int* __restrict__ hi, long long n, int w,
                   int width, int rows_prev, int vocab, int fill_win, Out win, Out slab) {
  const long long q = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);  // s * n + r
  if (q >= (long long)n_shards * n) return;  // whole warps
  const int lane = threadIdx.x & 31;
  // no 64-bit division on one index: it would delay every BWT address
  const int s = n_shards == 1 ? 0 : (int)(q / n);
  const long long r = q - (long long)s * n;
  const int l = __ldg(lo + q);  // one address a warp: a broadcast load
  const int h = __ldg(hi + q);
  const int stride = w > 0 ? max(max(h - l, 0) / w, 1) : 1;
  const long long s_lo = min((long long)l + rows_prev, (long long)h);
  const long long s_hi = min(s_lo + width, (long long)h);
  // round 0 (rows_prev 0) with a stride-1 window no wider than the slab:
  // window row l + j is slab row s_lo + j, valid under the same test
  const bool share = SLAB && rows_prev == 0 && stride == 1 && w <= width;
  const int* __restrict__ rows = bwt + (long long)s * n_max;
  const float* __restrict__ lrow = lp + r * lp_stride;

  int ssym[PER], wsym[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {  // the BWT reads, all independent
    const int j = blockIdx.y * 32 * PER + i * 32 + lane;
    ssym[i] = -1;
    wsym[i] = -1;
    if (SLAB && j < width && s_lo + j < s_hi) ssym[i] = __ldg(rows + s_lo + j) - SHIFT;
    if (j < w && !share) {
      const long long row = (long long)l + (long long)j * stride;
      if (row < h) wsym[i] = __ldg(rows + row) - SHIFT;
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {  // the lp reads, then the stores
    const int j = blockIdx.y * 32 * PER + i * 32 + lane;
    const bool sok = in_vocab(ssym[i], vocab);
    float slp = 0.0f;
    if (SLAB && j < width) {
      const int tk = sok ? ssym[i] : 0;
      slp = __ldg(lrow + tk);
      const long long at = r * ((long long)n_shards * width) + (long long)s * width + j;
      slab.tok[at] = tk;
      slab.valid[at] = sok ? 1 : 0;
      slab.lp[at] = slp;
    }
    if (j < w) {
      const int sym = share ? ssym[i] : wsym[i];
      const bool ok = in_vocab(sym, vocab);
      const int tk = ok ? sym : fill_win;
      const long long at = r * ((long long)n_shards * w) + (long long)s * w + j;
      win.tok[at] = tk;
      win.valid[at] = ok ? 1 : 0;
      win.lp[at] = share && ok ? slp : __ldg(lrow + tk);
    }
  }
}

}  // namespace

// bwt [n_shards, n_max] (n_max unused for one index), lp [n, V] with row
// stride lp_stride, lo/hi [n_shards, n]; w = 0 skips the window, width = 0
// the slab (their outputs may then be null).  Window outputs [n, n_shards *
// w], slab outputs [n, n_shards * width].
extern "C" int seal_window_slab(const int* bwt, long long n_max, int n_shards, const float* lp,
                                long long lp_stride, const int* lo, const int* hi, long long n,
                                int w, int width, int rows_prev, int vocab, int fill_win,
                                int* win_tok, unsigned char* win_valid, float* win_lp,
                                int* slab_tok, unsigned char* slab_valid, float* slab_lp,
                                void* stream) {
  if (w < 0 || width < 0 || rows_prev < 0) return (int)cudaErrorInvalidValue;
  const long long tasks = (long long)n_shards * n;
  const int widest = w > width ? w : width;
  if (tasks == 0 || widest == 0) return (int)cudaGetLastError();
  const Out win{win_tok, win_valid, win_lp}, slab{slab_tok, slab_valid, slab_lp};
  auto launch = [&](auto kernel, int per, int warps) {
    const dim3 grid((unsigned)((tasks + warps - 1) / warps),
                    (unsigned)((widest + 32 * per - 1) / (32 * per)));
    if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
    kernel<<<grid, 32 * warps, 0, (cudaStream_t)stream>>>(
        bwt, n_max, n_shards, lp, lp_stride, lo, hi, n, w, width, rows_prev, vocab, fill_win,
        win, slab);
    return (int)cudaGetLastError();
  };
  if (width == 0) return launch(window_slab_kernel<1, 4, false>, 1, 4);
  return launch(window_slab_kernel<2, 2, true>, 2, 2);
}
