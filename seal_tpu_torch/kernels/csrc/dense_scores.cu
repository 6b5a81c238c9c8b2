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
//             otherwise:         bit v of row r's count mask (its count > 0)
//             (or v == eos when always_allow_eos)
//   score[b, k * V + v] = (allowed ? lp[r, v] : neg_inf) + beam_scores[r]
//
// with one round-to-nearest f32 add (__fadd_rn), the bits of the plain
// version and of kernel 8's cons + bs.  Two forms:
//
// (a) The dense step (seal_dense_select): the scores exist only to be
// ranked for the step's top 2K, so they are computed inside kernel 3's
// select (radix_topk.cuh) as its value loader, DenseScoreLoad, and never
// written.  The select's rows are the B queries, of width K * V; its stored
// values are lp seen as [B, K * V]; element f of query b is beam k = f / V
// and token v = f mod V.  Each staged float4 of log-probs comes with the 4
// bits of the count mask at its tokens (kernels/count_mask.py: a bit a
// token, W = 4 * ceil(V / 128) words a beam, written by kernel 15's or 16's
// mask mode): one word read, a second where the four straddle a word or a
// beam.  A CTA works out its slice's beam states once (a slice spans at
// most two beams where it is shorter than V), so the four scores take no
// further state read.  One launch replaces kernel 17's pass and kernel 3's
// select.  Kernel 3's order (value descending, index ascending) is the
// exact_ties order here, since the flat index rises with (beam, token).
// Bound: bytes, the log-probs read once (4 bytes an element; 0.0288 ms at
// [32, 15, 50265] at 3.35 TB/s) and the mask (1/8 of a byte an element).
// The kernel reads every log-prob: reading a float4 only where one of its
// tokens is allowed made each round wait on the counts first, and ran 6-7%
// slower at 2% allowed.  With int32 counts it staged 8 bytes a key, twice
// kernel 3's; with the mask about 4.1.
//
// (b) The streaming pass (seal_dense_scores), where the [B, K * V] scores
// must exist (diverse groups, kernel 21, read them): flat over the B * K *
// V elements, each thread VECS vectors of 4 scores at one flat index, the
// beam a division by the constant V, then the vector's 4 mask bits.  A
// vector may straddle two beams, and an odd V (BART's 50265) leaves rows
// only 4-byte aligned: the flat index does not care.  A vector's log-probs
// are read only where one of its tokens is allowed, all the mask words
// first; an lp whose row stride is not V is read a token at a time.  Flat
// indices are 64-bit (a beam's row by a 64-bit division by the constant
// V), so B * K * V may pass 2^31.  Bound: bytes, the scores written (4
// bytes an element), the mask and the allowed tokens' log-probs.

#include <cuda_runtime.h>

#include "dense_branches.cuh"
#include "radix_topk.cuh"

namespace {

constexpr int STREAM_THREADS = 256;
constexpr int VECS = 4;  // 16-byte vectors a thread

// A CTA's slice [f0, f0 + n) of a query's row, where it spans at most two
// beams (a slice is shorter than V at the dense step): the first beam, its
// state, the next one's, and the flat index where the next one starts.
struct SliceBeams {
  BeamState s0, s1;
  int beam, f1;
  bool two;  // the slice lies in two beams at most
};

// (a) the select's loader: row b of the select is query b, [K * V] wide
struct DenseScoreLoad {
  using Aux = unsigned;  // the count mask's 4 bits beside a staged float4 of log-probs
  const unsigned* mask;  // [B * K, W]
  Branches br;
  FastDiv by_v;
  int V, K, W;

  __device__ __forceinline__ SliceBeams slice(long long row, int f0, int n) const {
    const int beam = n > 0 ? (int)by_v((unsigned)f0) : 0;
    const int f1 = (beam + 1) * V;
    const BeamState s0 = br.state(row * K + beam);
    const BeamState s1 = beam + 1 < K ? br.state(row * K + beam + 1) : s0;
    return {s0, s1, beam, f1, f0 + n <= f1 + V};
  }

  __device__ __forceinline__ float operator()(float v, long long row, int f) const {
    const int beam = (int)by_v((unsigned)f);
    const int tok = f - beam * V;
    const BeamState s = br.state(row * K + beam);
    const int c = s.by_counts ? mask_bit(mask, row * K + beam, tok, W) : 0;
    return br.score(v, br.allowed(c, tok, s), s);
  }
  // the mask bits of elements f..f+3 (inside the row): in a slice of two
  // beams the vector's beam is the slice's first or the next, no division
  __device__ __forceinline__ unsigned fetch(long long row, int f, const SliceBeams& sl) const {
    const int beam = sl.two ? sl.beam + (f >= sl.f1) : (int)by_v((unsigned)f);
    return mask_bits4(mask, row * K + beam, f - beam * V, V, W);
  }

  // elements f..f+3 (inside the row): beam f / V, or the next one past V;
  // in a slice of two beams, the slice's states
  __device__ __forceinline__ float4 apply4(float4 v, unsigned bits, long long row, int f,
                                           const SliceBeams& sl) const {
    const float x[4] = {v.x, v.y, v.z, v.w};
    const int n[4] = {(int)(bits & 1u), (int)((bits >> 1) & 1u), (int)((bits >> 2) & 1u),
                      (int)(bits >> 3)};
    float o[4];
    if (sl.two) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const bool next = f + t >= sl.f1;
        const BeamState s = next ? sl.s1 : sl.s0;
        const int tok = f + t - (next ? sl.f1 : sl.f1 - V);
        o[t] = br.score(x[t], br.allowed(n[t], tok, s), s);
      }
      return make_float4(o[0], o[1], o[2], o[3]);
    }
    const int beam = (int)by_v((unsigned)f);
    const int tok = f - beam * V;
    const BeamState s0 = br.state(row * K + beam);
    const BeamState s1 = tok + 3 < V ? s0 : br.state(row * K + beam + 1);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const bool next = tok + t >= V;
      const BeamState s = next ? s1 : s0;
      o[t] = br.score(x[t], br.allowed(n[t], next ? tok + t - V : tok + t, s), s);
    }
    return make_float4(o[0], o[1], o[2], o[3]);
  }
};

// (b) the streaming pass over n = rows * V elements.  FLAT: lp is [rows, V]
// contiguous and 16-byte aligned, read a vector at a time.
template <bool FLAT>
__global__ void __launch_bounds__(STREAM_THREADS)
dense_stream_kernel(const unsigned* __restrict__ mask, const float* __restrict__ lp,
                    long long lp_stride, Branches br, long long n, FastDiv64 by_v, int V, int W,
                    float* __restrict__ out) {
  const long long nv = n >> 2;
  const long long q0 = (long long)blockIdx.x * STREAM_THREADS * VECS + threadIdx.x;
  // each vector's beam row, token and mask bits
  long long r[VECS];
  int tok[VECS];
  unsigned bits[VECS];
#pragma unroll
  for (int u = 0; u < VECS; ++u) {
    const long long q = q0 + (long long)u * STREAM_THREADS;
    r[u] = 0;
    tok[u] = 0;
    bits[u] = 0;
    if (q >= nv) continue;
    const long long e = 4 * q;
    r[u] = (long long)by_v((unsigned long long)e);
    tok[u] = (int)(e - r[u] * V);
    bits[u] = mask_bits4(mask, r[u], tok[u], V, W);
  }
  // each vector's beams and allowed tokens, then the log-probs it needs
  BeamState s0[VECS], s1[VECS];
  unsigned ok[VECS];  // bit t: token t allowed
  float4 x[VECS];
#pragma unroll
  for (int u = 0; u < VECS; ++u) {
    const long long q = q0 + (long long)u * STREAM_THREADS;
    ok[u] = 0;
    x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q >= nv) continue;
    s0[u] = br.state(r[u]);
    s1[u] = tok[u] + 3 < V ? s0[u] : br.state(r[u] + 1);
    float xs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const bool next = tok[u] + t >= V;
      const int tt = next ? tok[u] + t - V : tok[u] + t;
      const BeamState st = next ? s1[u] : s0[u];
      if (br.allowed((int)((bits[u] >> t) & 1u), tt, st)) {
        ok[u] |= 1u << t;
        if (!FLAT) xs[t] = __ldg(lp + (r[u] + next) * lp_stride + tt);
      }
    }
    if (FLAT) {
      if (ok[u]) x[u] = __ldg((const float4*)lp + q);
    } else {
      x[u] = make_float4(xs[0], xs[1], xs[2], xs[3]);
    }
  }
#pragma unroll
  for (int u = 0; u < VECS; ++u) {
    const long long q = q0 + (long long)u * STREAM_THREADS;
    if (q >= nv) continue;
    const float xs[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
    float o[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const BeamState st = tok[u] + t >= V ? s1[u] : s0[u];
      o[t] = br.score(xs[t], (ok[u] >> t) & 1u, st);
    }
    ((float4*)out)[q] = make_float4(o[0], o[1], o[2], o[3]);
  }
  // the n mod 4 elements past the last vector
  if (blockIdx.x == 0 && (int)threadIdx.x < (int)(n & 3)) {
    const long long e = 4 * nv + threadIdx.x;
    const long long r = (long long)by_v((unsigned long long)e);
    const int tt = (int)(e - r * V);
    const BeamState s = br.state(r);
    const bool a = br.allowed(mask_bit(mask, r, tt, W), tt, s);
    out[e] = br.score(a ? __ldg(lp + r * lp_stride + tt) : 0.f, a, s);
  }
}

}  // namespace

extern "C" {

// (b) mask [rows, 4 * ceil(V / 128)] (the count mask) and out [rows, V]
// f32 (16-byte aligned), both contiguous; lp [rows, V] with row stride
// lp_stride (read by vectors where lp_stride == V and lp is 16-byte
// aligned); rows * V any size.
int seal_dense_scores(const unsigned* mask, const float* lp, long long lp_stride,
                      const int* prev_count, const unsigned char* finished,
                      const float* beam_scores, long long rows, int V, int eos, int pad,
                      int stop_at_count, int always_allow_eos, float neg_inf, float* out,
                      void* stream) {
  if (rows <= 0 || V <= 0) return (int)cudaGetLastError();
  const long long n = rows * V;
  const int W = 4 * ((V + 127) / 128);
  if ((unsigned long long)out & 15) return (int)cudaErrorInvalidValue;
  const Branches br{prev_count, finished, beam_scores, eos, pad, stop_at_count, always_allow_eos,
                    neg_inf};
  const long long per = (long long)STREAM_THREADS * VECS;
  const long long vec_blocks = ((n >> 2) + per - 1) / per;
  const unsigned blocks = (unsigned)(vec_blocks > 0 ? vec_blocks : 1);  // the tail's block
  const cudaStream_t s = (cudaStream_t)stream;
  const FastDiv64 by_v((unsigned long long)V);
  if (lp_stride == V && ((unsigned long long)lp & 15) == 0)
    dense_stream_kernel<true><<<blocks, STREAM_THREADS, 0, s>>>(mask, lp, lp_stride, br, n,
                                                                by_v, V, W, out);
  else
    dense_stream_kernel<false><<<blocks, STREAM_THREADS, 0, s>>>(mask, lp, lp_stride, br, n,
                                                                 by_v, V, W, out);
  return (int)cudaGetLastError();
}

// (a) one launch of kernel 3's select over the B queries' [K * V] scores:
// mask [B * K, 4 * ceil(V / 128)] (the count mask) contiguous, lp [B * K,
// V] f32 contiguous and 16-byte aligned; the top k as values and int64
// indices (vals, idx [B, k]), laid
// out by kernels/row_topk.py:plan(B, K * V, k) (k within the shared sort);
// a row K * V below 2^31 (the select's int width; a query's offset
// b * K * V is 64-bit).
int seal_dense_select(const unsigned* mask, const float* lp, const int* prev_count,
                      const unsigned char* finished, const float* beam_scores,
                      long long n_queries, int K, int V, int eos, int pad, int stop_at_count,
                      int always_allow_eos, float neg_inf, int k, int threads, int splits,
                      int slice, int staged, int cap, int n2, int region, int smem, float* vals,
                      long long* idx, void* stream) {
  if (n_queries <= 0) return (int)cudaGetLastError();
  const long long width = (long long)K * V;
  if (splits < 1 || splits > 16 || (threads != 512 && threads != 1024) || k < 1 ||
      k > width || width >= (1ll << 31) || n2 < k || n2 > 16384 ||
      ((unsigned long long)lp & 15))
    return (int)cudaErrorInvalidValue;
  const DenseScoreLoad load{mask,
                            {prev_count, finished, beam_scores, eos, pad, stop_at_count,
                             always_allow_eos, neg_inf},
                            FastDiv((unsigned)V), V, K, 4 * ((V + 127) / 128)};
  return radix_topk(lp, n_queries, (int)width, k, threads, splits, slice, staged, cap, n2, region,
                    smem, nullptr, vals, idx, load, (cudaStream_t)stream);
}

}  // extern "C"
