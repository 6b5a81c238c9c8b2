// Kernel 20: constrained sampling's draw, one Gumbel-max per sampler chain.
//
// Replaces seal_tpu/decoding/constrained.py:_select_sample (:1092-1122) with
// its jax.random.gumbel noise, and dispatch_select's EOS slot (:1270-1282).
// Per chain (one CTA a row of [B*K, N] candidates): finite = cons >
// NEG_INF/4; the slot of the largest cons + g over the finite slots, ties to
// the lower slot (jnp.argmax); a chain with no finite slot takes EOS at the
// log-prob of the first slot holding EOS (slot 0 if none).  The drawn score
// is that log-prob plus the chain's score, one f32 add; the history is 2K
// slots, the K draws and K PAD slots at NEG_INF.
//
// Noise: counter-based, with no state between calls.  Philox4x32-10
// (Random123's round and key schedule) with key (seed mod 2^32, step) and
// counter (column / 4, row, 0, 0) gives the 32-bit word w of each column
// (word column % 4); u = ((w >> 9) + 0.5) * 2^-23 lies strictly inside
// (0, 1) and is exact in f32, and g = -logf(-logf(u)).  (Twenty-four bits,
// (w >> 8) + 0.5, would need 25 and round to 1.0 at the top.)  The plain
// version computes the same words in int64 torch arithmetic, bit for bit.
//
// Columns may be V wide (step 0, exact_mask: token = column, an optional
// corpus mask applied to cons on the fly, so the masked copy is never
// written) or a candidate list with its token table (8c's candidates, free
// generation's top-top_m).
//
// Bound on the card: bytes.  At step 0, [480, 50265] f32 log-probs are read
// once (96.5 MB); the Philox rounds and two logf a column are far below the
// card's arithmetic rate.

#include <climits>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, unsigned k0, unsigned k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const unsigned lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ float gumbel_of(unsigned w) {
  const float u = __fmul_rn(__fadd_rn((float)(w >> 9), 0.5f), 1.1920928955078125e-07f);
  return -logf(-logf(u));
}

__device__ __forceinline__ unsigned word_of(uint4 v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

struct SampleOut {
  int* c_tok;  // [B, 2K]
  int* c_par;
  float* c_sco;
  unsigned char* c_fin;
  int* sel_tok;  // [B, K]
  int* sel_par;
  float* sel_sco;
  unsigned char* sel_fin;
};

// One CTA per chain row (b * K + k).  Each thread draws four columns per
// Philox call, keeps its best (score, slot) over finite slots and the first
// EOS slot; a warp-shuffle and shared-memory reduction combines them.
__global__ void sample_kernel(const float* cons, const float* cand_lp, const int* tokens,
                              const unsigned char* mask, const float* beam_scores, int K, int N,
                              unsigned seed, unsigned step, int eos, int pad, float neg_inf,
                              SampleOut o) {
  __shared__ float s_best[32];
  __shared__ int s_j[32], s_eos[32];
  const long long row = blockIdx.x;
  const float fin_cut = neg_inf / 4.0f;
  const float* c_row = cons + row * N;
  const int* t_row = tokens != nullptr ? tokens + row * N : nullptr;
  float best = __int_as_float(0xff800000);  // -inf
  int best_j = INT_MAX, eos_j = INT_MAX;
  for (int q = threadIdx.x; 4 * q < N; q += blockDim.x) {
    const uint4 w = philox4x32_10(make_uint4((unsigned)q, (unsigned)row, 0u, 0u), seed, step);
    for (int i = 0; i < 4; ++i) {
      const int j = 4 * q + i;
      if (j >= N) break;
      if (t_row != nullptr && t_row[j] == eos && j < eos_j) eos_j = j;
      const float c = (mask != nullptr && mask[j] == 0) ? neg_inf : c_row[j];
      if (c > fin_cut) {
        const float v = __fadd_rn(c, gumbel_of(word_of(w, i)));
        if (v > best || (v == best && j < best_j)) {
          best = v;
          best_j = j;
        }
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off);
    const int oj = __shfl_down_sync(0xffffffffu, best_j, off);
    const int oe = __shfl_down_sync(0xffffffffu, eos_j, off);
    if (ov > best || (ov == best && oj < best_j)) {
      best = ov;
      best_j = oj;
    }
    eos_j = min(eos_j, oe);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_best[warp] = best;
    s_j[warp] = best_j;
    s_eos[warp] = eos_j;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int i = 1; i < (int)(blockDim.x + 31) / 32; ++i) {
    if (s_best[i] > best || (s_best[i] == best && s_j[i] < best_j)) {
      best = s_best[i];
      best_j = s_j[i];
    }
    eos_j = min(eos_j, s_eos[i]);
  }
  // the EOS slot of dispatch_select: argmax(tokens == eos), slot 0 if none
  if (t_row == nullptr) eos_j = (eos >= 0 && eos < N) ? eos : INT_MAX;
  if (eos_j == INT_MAX) eos_j = 0;
  const bool dead = best_j == INT_MAX;
  const int j = dead ? eos_j : best_j;
  const int tok = dead ? eos : (t_row != nullptr ? t_row[j] : j);
  const float sco = __fadd_rn(cand_lp[row * N + j], beam_scores[row]);
  const long long b = row / K;
  const int k = (int)(row - b * K);
  o.sel_tok[row] = tok;
  o.sel_par[row] = k;
  o.sel_sco[row] = sco;
  o.sel_fin[row] = 1;
  const long long h = b * 2 * K;
  o.c_tok[h + k] = tok;
  o.c_tok[h + K + k] = pad;
  o.c_par[h + k] = k;
  o.c_par[h + K + k] = k;
  o.c_sco[h + k] = sco;
  o.c_sco[h + K + k] = neg_inf;
  o.c_fin[h + k] = 1;
  o.c_fin[h + K + k] = 0;
}

// The noise alone, [rows, n] words and Gumbel values, for checking the
// generator against its plain version.
__global__ void noise_kernel(int n, unsigned seed, unsigned step, unsigned* words, float* g) {
  const long long row = blockIdx.x;
  for (int q = threadIdx.x; 4 * q < n; q += blockDim.x) {
    const uint4 w = philox4x32_10(make_uint4((unsigned)q, (unsigned)row, 0u, 0u), seed, step);
    for (int i = 0; i < 4 && 4 * q + i < n; ++i) {
      words[row * n + 4 * q + i] = word_of(w, i);
      g[row * n + 4 * q + i] = gumbel_of(word_of(w, i));
    }
  }
}

}  // namespace

extern "C" {

int seal_sample_select(const float* cons, const float* cand_lp, const int* tokens,
                       const unsigned char* mask, const float* beam_scores, long long rows, int K,
                       int N, long long seed, long long step, int eos, int pad, float neg_inf,
                       int* c_tok, int* c_par, float* c_sco, unsigned char* c_fin, int* sel_tok,
                       int* sel_par, float* sel_sco, unsigned char* sel_fin, void* stream) {
  if (rows <= 0) return (int)cudaGetLastError();
  const SampleOut o{c_tok, c_par, c_sco, c_fin, sel_tok, sel_par, sel_sco, sel_fin};
  sample_kernel<<<(unsigned)rows, 256, 0, (cudaStream_t)stream>>>(
      cons, cand_lp, tokens, mask, beam_scores, K, N, (unsigned)seed, (unsigned)step, eos, pad,
      neg_inf, o);
  return (int)cudaGetLastError();
}

int seal_gumbel_noise(long long rows, int n, long long seed, long long step, unsigned* words,
                      float* g, void* stream) {
  if (rows <= 0) return (int)cudaGetLastError();
  noise_kernel<<<(unsigned)rows, 256, 0, (cudaStream_t)stream>>>(n, (unsigned)seed,
                                                                  (unsigned)step, words, g);
  return (int)cudaGetLastError();
}

}  // extern "C"
