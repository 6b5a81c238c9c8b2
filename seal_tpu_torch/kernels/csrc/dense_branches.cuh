// The dense candidate branches of the exact_mask decode mode, shared by
// kernel 17 (dense_scores.cu) and kernel 20's count-reading mode
// (sample_select.cu): seal_tpu/decoding/constrained.py:_apply_branches
// (:897-912) and the mask cons = where(allowed, cand_lp, NEG_INF) (:1394);
// and their reads of the count mask that stands for the counts > 0.
#pragma once

#include <cuda_runtime.h>

namespace {

// A beam's branch state: the token it allows alone (stop-forced: EOS;
// finished: PAD), or the count mask decides; and its score.
struct BeamState {
  float bs;
  int only;
  bool by_counts;
};

struct Branches {
  const int* prev_count;  // [rows]
  const unsigned char* finished;
  const float* beam_scores;
  int eos, pad, stop_at_count, always_allow_eos;
  float neg_inf;

  __device__ __forceinline__ BeamState state(long long r) const {
    const bool fin = __ldg(finished + r) != 0;
    const int count_eff = fin ? 0 : __ldg(prev_count + r);
    const bool stop = stop_at_count > 0 && count_eff <= stop_at_count;
    return {__ldg(beam_scores + r), stop ? eos : pad, !stop && !fin};
  }
  // c: the token's count, or its bit in the count mask
  __device__ __forceinline__ bool allowed(int c, int tok, BeamState s) const {
    const bool a = s.by_counts ? c > 0 : tok == s.only;
    return a || (always_allow_eos && tok == eos);
  }
  __device__ __forceinline__ float score(float v, bool ok, BeamState s) const {
    return __fadd_rn(ok ? v : neg_inf, s.bs);
  }
};

// The count mask (kernels/count_mask.py: W = 4 * ceil(V / 128) words a
// beam row, bit t of word w for token 32 w + t) of tokens tok..tok+3 of
// beam row r, bit t for token tok + t; those past V are the first tokens
// of row r + 1, which the caller's flat index guarantees exists.  One
// word, a second where the four straddle a word, a third where they
// straddle the row's end (the padding bits past V are 0).
__device__ __forceinline__ unsigned mask_bits4(const unsigned* __restrict__ mask, long long r,
                                               int tok, int V, int W) {
  const unsigned* m = mask + r * W;
  const int w = tok >> 5, sh = tok & 31;
  unsigned x = __ldg(m + w) >> sh;
  if (sh > 28 && w + 1 < W) x |= __ldg(m + w + 1) << (32 - sh);
  if (tok + 3 >= V) {
    const int in = V - tok;  // 1 to 3 tokens of row r
    x = (x & ((1u << in) - 1u)) | (__ldg(m + W) << in);
  }
  return x & 15u;
}

// token tok's bit in beam row r's count mask
__device__ __forceinline__ int mask_bit(const unsigned* __restrict__ mask, long long r, int tok,
                                        int W) {
  return (int)((__ldg(mask + r * W + (tok >> 5)) >> (tok & 31)) & 1u);
}

}  // namespace
