// The dense candidate branches of the exact_mask decode mode, shared by
// kernel 17 (dense_scores.cu) and kernel 20's count-reading mode
// (sample_select.cu): seal_tpu/decoding/constrained.py:_apply_branches
// (:897-912) and the mask cons = where(allowed, cand_lp, NEG_INF) (:1394).
#pragma once

#include <cuda_runtime.h>

namespace {

// A beam's branch state: the token it allows alone (stop-forced: EOS;
// finished: PAD), or the counts decide; and its score.
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
  __device__ __forceinline__ bool allowed(int c, int tok, BeamState s) const {
    const bool a = s.by_counts ? c > 0 : tok == s.only;
    return a || (always_allow_eos && tok == eos);
  }
  __device__ __forceinline__ float score(float v, bool ok, BeamState s) const {
    return __fadd_rn(ok ? v : neg_inf, s.bs);
  }
};

}  // namespace
