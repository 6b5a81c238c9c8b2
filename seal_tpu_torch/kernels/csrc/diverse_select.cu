// Kernel 21: diverse beam groups' selection (group beam search with the
// Hamming diversity penalty).
//
// Replaces seal_tpu/decoding/constrained.py:_select_diverse (:1125-1171) and
// dispatch_select's cons + beam_scores (:1283-1286).  For g = 0..G-1 in
// order, over the group's gs beams and each beam's N candidates:
//   sc = cons + beam score, then, for g > 0 and a penalty > 0,
//   sc = sc - penalty * (float)freq, freq counting the earlier groups'
//   selected tokens of this step equal to the candidate's token (JAX's one
//   f32 product and one subtract; written with __fmul_rn / __fsub_rn so the
//   compiler cannot fuse them into one rounding);
// then the top 2*gs of the flat [gs * N] row in lax.top_k's order or, under
// exact_ties, by (score, (beam in group << tie_bits) + token) (_top_idx
// :979, _beam_tok_tie :958); the first gs that are not EOS continue (then
// EOS ones in order); parents are slot / N + g * gs.  The penalized score is
// both what selects and what is recorded: there is no dual scoring.
//
// Each group runs as two launches: a partial pass, one CTA per (chunk of at
// most 2048 slots, query), that builds each slot's key (select_common.cuh)
// and keeps the chunk's top 2*gs by a bitonic sort in shared memory; and a
// finish, one CTA per query, that sorts the chunks' survivors, writes the
// group's history and selection, and leaves the selected tokens in sel_tok
// for the next group's penalty.  V-wide rows (step 0, exact_mask: token =
// column, with an optional corpus mask applied on the fly) spread over
// ~600 chunks a query; a candidate list (8c's candidates, free
// generation's top-top_m) fits one.  Every output is a selection or the f32
// arithmetic above in JAX's order, so the kernel equals the plain version
// bit for bit.
//
// Bound on the card: bytes for V-wide rows (each cons read once); latency
// (2G launches, each a few barrier-separated sort stages) for narrow ones.

#include <climits>

#include "select_common.cuh"

namespace {

constexpr int CHUNK = 2048;  // slots a partial CTA sorts

struct DivIn {
  const float* cons;           // [B, K, N]
  const int* tokens;           // [B, K, N], or null: token = column
  const unsigned char* mask;   // [N] or null (token = column only)
  const float* beam_scores;    // [B, K]
  const int* chosen;           // sel_tok [B, K]: the earlier groups' picks
  int K, N, gs, eos, tie_bits;  // tie_bits 0: lax.top_k's order
  int penalize;                // penalty > 0
  float pen, neg_inf;
};

struct DivOut {
  int* c_tok;  // [B, 2K]: group g's top 2*gs at [g * 2gs, (g + 1) * 2gs)
  int* c_par;
  float* c_sco;
  unsigned char* c_fin;
  int* sel_tok;  // [B, K]: group g's gs picks at [g * gs, (g + 1) * gs)
  int* sel_par;
  float* sel_sco;
  unsigned char* sel_fin;
};

__device__ __forceinline__ int slot_token(const DivIn& in, long long b, int g, int f) {
  const int kk = g * in.gs + f / in.N, j = f % in.N;
  return in.tokens != nullptr ? in.tokens[(b * in.K + kk) * in.N + j] : j;
}

// The key of flat slot f of group g of query b.
__device__ __forceinline__ u64 slot_key(const DivIn& in, long long b, int g, int f,
                                        const int* s_prev, int n_prev) {
  const int kk = g * in.gs + f / in.N, j = f % in.N;
  const int tok = slot_token(in, b, g, f);
  const float c = (in.mask != nullptr && in.mask[j] == 0)
                      ? in.neg_inf : in.cons[(b * in.K + kk) * in.N + j];
  float sc = __fadd_rn(c, in.beam_scores[b * in.K + kk]);
  if (in.penalize && n_prev > 0) {
    int freq = 0;
    for (int p = 0; p < n_prev; ++p) freq += s_prev[p] == tok;
    sc = __fsub_rn(sc, __fmul_rn(in.pen, (float)freq));
  }
  const int id = in.tie_bits
                     ? ((f / in.N) << in.tie_bits) + min(max(tok, 0), (1 << in.tie_bits) - 1)
                     : f;
  return pack(sc, id);
}

// Group g, chunk blockIdx.x of query blockIdx.y: the chunk's top `top`
// (key, slot) pairs into part_key / part_slot [B, n_chunks, top].
__global__ void partial_kernel(DivIn in, int g, int top, u64* part_key, int* part_slot) {
  extern __shared__ unsigned long long smem[];
  u64* keys = smem;
  int* slots = (int*)(keys + CHUNK);
  int* s_prev = slots + CHUNK;
  const long long b = blockIdx.y;
  const int n = in.gs * in.N, n_prev = g * in.gs;
  const int base = blockIdx.x * CHUNK;
  const int n2 = pow2_at_least(min(CHUNK, n));
  for (int p = threadIdx.x; p < n_prev; p += blockDim.x) s_prev[p] = in.chosen[b * in.K + p];
  __syncthreads();
  for (int i = threadIdx.x; i < n2; i += blockDim.x) {
    const int f = base + i;
    const bool real = f < n;
    keys[i] = real ? slot_key(in, b, g, f, s_prev, n_prev) : 0ull;
    slots[i] = real ? f : INT_MAX;
  }
  sort_desc<true>(keys, slots, n2);
  for (int t = threadIdx.x; t < top; t += blockDim.x) {
    const long long at = (b * gridDim.x + blockIdx.x) * top + t;
    part_key[at] = keys[t];
    part_slot[at] = slots[t];
  }
}

// Group g of query blockIdx.x: the top `top` of the chunks' survivors, the
// group's history, its first gs non-EOS picks and their parents.
__global__ void finish_kernel(DivIn in, int g, int n_chunks, int top, int n2, const u64* part_key,
                              const int* part_slot, DivOut o) {
  extern __shared__ unsigned long long smem[];
  u64* keys = smem;
  int* slots = (int*)(keys + n2);
  int* e_tok = slots + n2;
  int* s_cont = e_tok + top;
  const long long b = blockIdx.x;
  const int m = n_chunks * top, two_k = 2 * in.K;
  const float fin_cut = in.neg_inf / 4.0f;
  for (int i = threadIdx.x; i < n2; i += blockDim.x) {
    keys[i] = i < m ? part_key[b * m + i] : 0ull;
    slots[i] = i < m ? part_slot[b * m + i] : INT_MAX;
  }
  sort_desc<true>(keys, slots, n2);
  for (int t = threadIdx.x; t < top; t += blockDim.x) {
    const int f = slots[t];
    const float sc = key_value(keys[t]);
    const long long at = b * two_k + g * top + t;
    e_tok[t] = slot_token(in, b, g, f);
    o.c_tok[at] = e_tok[t];
    o.c_par[at] = f / in.N + g * in.gs;
    o.c_sco[at] = sc;
    o.c_fin[at] = sc > fin_cut ? 1 : 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int t = 0; t < top && n < in.gs; ++t)
      if (e_tok[t] != in.eos) s_cont[n++] = t;
    for (int t = 0; t < top && n < in.gs; ++t)
      if (e_tok[t] == in.eos) s_cont[n++] = t;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < in.gs; c += blockDim.x) {
    const int t = s_cont[c];
    const float sc = key_value(keys[t]);
    const long long at = b * in.K + g * in.gs + c;
    o.sel_tok[at] = e_tok[t];
    o.sel_par[at] = slots[t] / in.N + g * in.gs;
    o.sel_sco[at] = sc;
    o.sel_fin[at] = sc > fin_cut ? 1 : 0;
  }
}

int n_chunks_of(int n) { return (n + CHUNK - 1) / CHUNK; }

size_t partial_smem(int K) { return 12 * (size_t)CHUNK + 4 * (size_t)K; }

size_t finish_smem(int n, int top) {
  return 12 * (size_t)pow2_at_least(n_chunks_of(n) * top) + 8 * (size_t)top;
}

}  // namespace

extern "C" {

// Chunks of a group's [n] slots: the wrapper allocates n_chunks * 2gs
// (key, slot) scratch pairs per query.
long long seal_diverse_chunks(int n) { return n_chunks_of(n); }

// Shared memory of the larger of the two launches (bytes).
long long seal_diverse_smem(int n, int gs, int K) {
  const size_t p = partial_smem(K), f = finish_smem(n, 2 * gs);
  return (long long)(p > f ? p : f);
}

int seal_diverse_select(const float* cons, const int* tokens, const unsigned char* mask,
                        const float* beam_scores, long long n_queries, int K, int N, int G,
                        int eos, int tie_bits, int penalize, float pen, float neg_inf,
                        unsigned long long* part_key, int* part_slot, int* c_tok, int* c_par,
                        float* c_sco, unsigned char* c_fin, int* sel_tok, int* sel_par,
                        float* sel_sco, unsigned char* sel_fin, void* stream) {
  if (n_queries <= 0) return (int)cudaGetLastError();
  const int gs = K / G, top = 2 * gs, n = gs * N;
  const DivIn in{cons, tokens, mask, beam_scores, sel_tok, K, N, gs, eos, tie_bits, penalize,
                 pen, neg_inf};
  const DivOut o{c_tok, c_par, c_sco, c_fin, sel_tok, sel_par, sel_sco, sel_fin};
  const int n_chunks = n_chunks_of(n);
  const int n2 = pow2_at_least(n_chunks * top);
  const size_t smem_p = partial_smem(K), smem_f = finish_smem(n, top);
  int rc = set_smem(partial_kernel, smem_p);
  if (!rc) rc = set_smem(finish_kernel, smem_f);
  if (rc) return rc;
  for (int g = 0; g < G; ++g) {
    partial_kernel<<<dim3((unsigned)n_chunks, (unsigned)n_queries), 256, smem_p,
                     (cudaStream_t)stream>>>(in, g, top, part_key, part_slot);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
    finish_kernel<<<(unsigned)n_queries, 256, smem_f, (cudaStream_t)stream>>>(
        in, g, n_chunks, top, n2, part_key, part_slot, o);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  return 0;
}

}  // extern "C"
