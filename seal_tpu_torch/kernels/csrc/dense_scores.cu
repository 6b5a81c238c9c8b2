// Kernel 17: the dense candidate pass of the exact_mask decode mode.
//
// Replaces, in seal_tpu/decoding/constrained.py: the dense branch of
// _candidates_general (:321-327) with _apply_branches (:897-912), the mask
// cons = where(allowed, cand_lp, NEG_INF) (:1394) and the parent's beam
// score added before _select (dispatch_select, :1287-1294).  For beam row
// r = (b, k) and token v < V:
//
//   allowed = stop-forced beam:  v == eos
//             finished beam:     v == pad
//             otherwise:         counts[r, v] > 0
//             (or v == eos when always_allow_eos)
//   out[b, k * V + v] = (allowed ? lp[r, v] : neg_inf) + beam_scores[r]
//
// with one round-to-nearest f32 add (__fadd_rn), the bits of the plain
// version and of kernel 8's cons + bs.  The [B, K * V] rows are what kernel
// 3 ranks for the step's top 2K.
//
// Bound on the card: bytes.  Each element reads a count and a log-prob and
// writes a score (12 bytes; 290 MB a step at batch 32, beam 15 and BART's
// 50265 tokens); the per-row branch state is read once per block.  One
// block per (row, column chunk), neighbouring threads on neighbouring
// columns.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int COLS_PER_BLOCK = 4096;

__global__ void __launch_bounds__(THREADS)
dense_scores_kernel(const int* __restrict__ counts, const float* __restrict__ lp,
                    long long lp_stride, const int* __restrict__ prev_count,
                    const unsigned char* __restrict__ finished,
                    const float* __restrict__ beam_scores, int V, int eos, int pad,
                    int stop_at_count, int always_allow_eos, float neg_inf,
                    float* __restrict__ out) {
  const long long r = blockIdx.x;
  const bool fin = finished[r] != 0;
  const int count_eff = fin ? 0 : prev_count[r];
  const bool stop_trig = stop_at_count > 0 && count_eff <= stop_at_count;
  const float bs = beam_scores[r];
  const int* cr = counts + r * V;
  const float* lr = lp + r * lp_stride;
  float* orow = out + r * V;
  const int v1 = min(V, (int)(blockIdx.y + 1) * COLS_PER_BLOCK);
  for (int v = blockIdx.y * COLS_PER_BLOCK + threadIdx.x; v < v1; v += THREADS) {
    bool allowed = stop_trig ? v == eos : (fin ? v == pad : __ldg(cr + v) > 0);
    if (always_allow_eos) allowed = allowed || v == eos;
    orow[v] = __fadd_rn(allowed ? __ldg(lr + v) : neg_inf, bs);
  }
}

}  // namespace

extern "C" int seal_dense_scores(const int* counts, const float* lp, long long lp_stride,
                                 const int* prev_count, const unsigned char* finished,
                                 const float* beam_scores, long long rows, int V, int eos, int pad,
                                 int stop_at_count, int always_allow_eos, float neg_inf,
                                 float* out, void* stream) {
  if (rows > 0 && V > 0) {
    const dim3 grid((unsigned)rows, (unsigned)((V + COLS_PER_BLOCK - 1) / COLS_PER_BLOCK));
    dense_scores_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        counts, lp, lp_stride, prev_count, finished, beam_scores, V, eos, pad, stop_at_count,
        always_allow_eos, neg_inf, out);
  }
  return (int)cudaGetLastError();
}
