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
// both what selects and what is recorded: there is no dual scoring.  Every
// output is a selection or the f32 arithmetic above in JAX's order, so each
// route equals the plain version bit for bit.
//
// Three routes (kernels/diverse_select.py picks one a call):
//
// * wide (V-wide rows: token = column; step 0 under the corpus mask and
//   exact_mask): 2 launches a call, whatever G.  Launch 1 takes every
//   (query, group) row's unpenalized top M = 2gs + (G - 1) gs^2 (2gs
//   without a penalty) in one pass over [B * G, gs * N] with kernel 3's
//   split-row radix select (radix_topk.cuh), whose loader adds the beam
//   score and applies the mask as the slice is staged; launch 2, one CTA a
//   query, takes the groups in order: it penalizes the M survivors against
//   the picks so far, sorts them and finishes the group.  It serves
//   M <= 512 (kernel 3 places a top of up to 512 by rank).
// * list (a token table [B, K, N]: kernel 8's candidate mode, free
//   generation's top-top_m): 1 launch, one CTA a query holding each
//   group's gs * N slots in shared memory and running the groups in order
//   with a full sort.  A list may repeat a token within a beam (its PAD
//   fill), so no lemma bounds its survivors.  It sorts up to LIST_MAX
//   slots a group; the wrapper takes it only up to 2,048
//   (diverse_select.py's LIST_MAX): past them one CTA a query sorting G
//   groups in series loses to the chunked route's chunks x queries CTAs
//   (chip_smoke.py's "diverse_select by slots a group" line, H100: at
//   [32, 15] in 3 groups ahead at 1,280 slots, 2.9x behind at 4,100).
// * chunked (either kind past those limits): 2 launches a group.  A
//   partial pass, one CTA per (chunk of at most 2048 slots, query), keeps
//   the chunk's top 2*gs by a bitonic sort in shared memory; a finish, one
//   CTA per query, sorts the chunks' survivors and finishes the group,
//   leaving the picks in sel_tok for the next group's penalty.
//
// The lemma the wide route rests on:
// 1. Every selection runs in one total order: key = pack(score, id),
//    highest first (select_common.cuh).
// 2. A penalty only lowers a slot's score: __fsub_rn(sc, __fmul_rn(pen,
//    freq)) <= sc for pen >= 0 and freq >= 0 (rounding is monotone), and
//    the slot's id does not change, so neither can its key rise.
// 3. In a V-wide row a token is one column, so group g's penalized slots
//    number at most (g gs distinct earlier picks) x (gs beams):
//    P_g <= (G - 1) gs^2.
// 4. So group g's penalized top 2gs lies inside its unpenalized top M,
//    M = 2gs + (G - 1) gs^2: a slot outside the top M has at least
//    M - P_g >= 2gs unpenalized slots above it, whose keys do not move,
//    while its own key does not rise.
// 5. Under exact_ties the V-wide tie id is ((f / N) << bits) + j, with
//    j = f mod N < 2^bits (the wrapper checks N <= 2^bits): it rises with
//    the flat slot f, so the tie order is the index order that launch 1
//    ranks by.
// Launch 2 counts into g_proof_failures (a device variable of the library,
// one a card, zero when the library loads, so no call allocates it and a
// CUDA graph may capture the first) each group with fewer than 2gs
// unpenalized survivors (where M is short of the row): by the lemma none,
// and seal_diverse_proof_failures must read 0.
//
// Bound on the card: bytes for V-wide rows (each cons read once); latency
// (a few launches, each a few barrier-separated sort stages) for lists.

#include <climits>

#include "radix_topk.cuh"

namespace {

constexpr int CHUNK = 2048;       // slots a partial CTA sorts
constexpr int WIDE_THREADS = 256;  // launch 2 of the wide route
constexpr int LIST_MAX = 16384;    // slots (a power of two) the list route sorts a group

__device__ int g_proof_failures;  // groups the lemma failed on (launch 2 of the wide route)

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

// The id of flat slot f with token tok: the slot, or the (beam, token) tie id
__device__ __forceinline__ int slot_id(const DivIn& in, int f, int tok) {
  return in.tie_bits
             ? ((f / in.N) << in.tie_bits) + min(max(tok, 0), (1 << in.tie_bits) - 1)
             : f;
}

// sc less the penalty of token tok against the n_prev picks in s_prev
__device__ __forceinline__ float penalized(const DivIn& in, float sc, int tok, const int* s_prev,
                                           int n_prev, int* freq_out = nullptr) {
  int freq = 0;
  if (in.penalize && n_prev > 0) {
    for (int p = 0; p < n_prev; ++p) freq += s_prev[p] == tok;
    sc = __fsub_rn(sc, __fmul_rn(in.pen, (float)freq));
  }
  if (freq_out != nullptr) *freq_out = freq;
  return sc;
}

// The key of flat slot f of group g of query b.
__device__ __forceinline__ u64 slot_key(const DivIn& in, long long b, int g, int f,
                                        const int* s_prev, int n_prev) {
  const int kk = g * in.gs + f / in.N, j = f % in.N;
  const int tok = slot_token(in, b, g, f);
  const float c = (in.mask != nullptr && in.mask[j] == 0)
                      ? in.neg_inf : in.cons[(b * in.K + kk) * in.N + j];
  const float sc = __fadd_rn(c, in.beam_scores[b * in.K + kk]);
  return pack(penalized(in, sc, tok, s_prev, n_prev), slot_id(in, f, tok));
}

// Group g of query b from its candidates sorted in keys / slots: the top
// `top` are the group's history, the first gs that are not EOS (then EOS
// ones, in order) its picks, with parents slot / N + g * gs.  With s_pick
// the picks' tokens also go to s_pick[g * gs, (g + 1) * gs) for the next
// group's penalty.  Every thread of the CTA calls it; it ends on a barrier.
__device__ void finish_group(const DivIn& in, long long b, int g, int top, const u64* keys,
                             const int* slots, int* e_tok, int* s_cont, int* s_pick,
                             const DivOut& o) {
  const int two_k = 2 * in.K;
  const float fin_cut = in.neg_inf / 4.0f;
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
    if (s_pick != nullptr) s_pick[g * in.gs + c] = e_tok[t];
  }
  __syncthreads();
}

// ---- the chunked route ----------------------------------------------------

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

// Group g of query blockIdx.x: the top `top` of the chunks' survivors,
// finished (the picks go to sel_tok, which the next group's partial reads).
__global__ void finish_kernel(DivIn in, int g, int n_chunks, int top, int n2, const u64* part_key,
                              const int* part_slot, DivOut o) {
  extern __shared__ unsigned long long smem[];
  u64* keys = smem;
  int* slots = (int*)(keys + n2);
  int* e_tok = slots + n2;
  int* s_cont = e_tok + top;
  const long long b = blockIdx.x;
  const int m = n_chunks * top;
  for (int i = threadIdx.x; i < n2; i += blockDim.x) {
    keys[i] = i < m ? part_key[b * m + i] : 0ull;
    slots[i] = i < m ? part_slot[b * m + i] : INT_MAX;
  }
  sort_desc<true>(keys, slots, n2);
  finish_group(in, b, g, top, keys, slots, e_tok, s_cont, nullptr, o);
}

int n_chunks_of(int n) { return (n + CHUNK - 1) / CHUNK; }

size_t partial_smem(int K) { return 12 * (size_t)CHUNK + 4 * (size_t)K; }

size_t finish_smem(int n, int top) {
  return 12 * (size_t)pow2_at_least(n_chunks_of(n) * top) + 8 * (size_t)top;
}

// ---- the list route -------------------------------------------------------

// Query blockIdx.x: the G groups in order, each over its gs * N slots (n2 a
// power of two at least that), the picks kept in shared memory.
__global__ void __launch_bounds__(1024) list_kernel(DivIn in, int G, int n2, DivOut o) {
  extern __shared__ unsigned long long smem[];
  u64* keys = smem;
  int* slots = (int*)(keys + n2);
  int* s_pick = slots + n2;
  int* e_tok = s_pick + in.K;
  int* s_cont = e_tok + 2 * in.gs;
  const long long b = blockIdx.x;
  const int n = in.gs * in.N;
  for (int g = 0; g < G; ++g) {
    for (int i = threadIdx.x; i < n2; i += blockDim.x) {
      const bool real = i < n;
      keys[i] = real ? slot_key(in, b, g, i, s_pick, g * in.gs) : 0ull;
      slots[i] = real ? i : INT_MAX;
    }
    sort_desc<true>(keys, slots, n2);
    finish_group(in, b, g, 2 * in.gs, keys, slots, e_tok, s_cont, s_pick, o);
  }
}

// n2 pairs, the picks, a group's tokens and its continuing slots
size_t select_smem(int n2, int gs, int K) {
  return 12 * (size_t)n2 + 4 * (size_t)K + 12 * (size_t)gs;
}

size_t list_smem(int n, int gs, int K) { return select_smem(pow2_at_least(n), gs, K); }

// ---- the wide route -------------------------------------------------------

// Launch 1's loader: element f of row (query, group) = b * G + g is
// beam f / N of the group, column j = f mod N; its value is the
// constrained score (NEG_INF where the mask bars the column) plus the
// beam's score, as slot_key computes it.
struct WideLoad {
  const float* beam_scores;  // [B, K] = [B * G, gs]
  const unsigned char* mask;  // [N] or null
  FastDiv by_n;
  int N, gs;
  float neg_inf;
  __device__ __forceinline__ float operator()(float v, long long row, int f) const {
    const int beam = (int)by_n((unsigned)f);
    const int j = f - beam * N;
    const float c = (mask != nullptr && __ldg(mask + j) == 0) ? neg_inf : v;
    return __fadd_rn(c, __ldg(beam_scores + row * gs + beam));
  }
};

// Launch 2: query blockIdx.x, the G groups in order.  Group g's survivors
// are its row's unpenalized top M (top_val / top_idx [B * G, M] from launch
// 1); each is penalized against the picks so far, and the M sorted (m2 a
// power of two at least M).  g_proof_failures counts the groups with fewer
// than 2gs unpenalized survivors where M is short of the row (the lemma:
// none).
__global__ void __launch_bounds__(WIDE_THREADS)
wide_finish_kernel(DivIn in, int G, int M, int m2, const float* __restrict__ top_val,
                   const long long* __restrict__ top_idx, DivOut o) {
  extern __shared__ unsigned long long smem[];
  __shared__ int s_unpen;
  const int top = 2 * in.gs;
  u64* keys = smem;
  int* slots = (int*)(keys + m2);
  int* s_pick = slots + m2;
  int* e_tok = s_pick + in.K;
  int* s_cont = e_tok + top;
  const long long b = blockIdx.x;
  for (int g = 0; g < G; ++g) {
    if (threadIdx.x == 0) s_unpen = 0;
    __syncthreads();
    const long long row = (b * G + g) * M;
    int unpen = 0;
    for (int i = threadIdx.x; i < m2; i += blockDim.x) {
      u64 key = 0ull;
      int f = INT_MAX;
      if (i < M) {
        f = (int)top_idx[row + i];
        const int tok = f % in.N;  // token = column
        int freq = 0;
        const float sc = penalized(in, top_val[row + i], tok, s_pick, g * in.gs, &freq);
        unpen += freq == 0;
        key = pack(sc, slot_id(in, f, tok));
      }
      keys[i] = key;
      slots[i] = f;
    }
    if (unpen) atomicAdd(&s_unpen, unpen);
    sort_desc<true>(keys, slots, m2);
    if (threadIdx.x == 0 && s_unpen < top && M < in.gs * in.N) atomicAdd(&g_proof_failures, 1);
    finish_group(in, b, g, top, keys, slots, e_tok, s_cont, s_pick, o);
  }
}

size_t wide_smem(int M, int gs, int K) { return select_smem(pow2_at_least(M), gs, K); }

}  // namespace

extern "C" {

// Chunks of a group's [n] slots: the wrapper allocates n_chunks * 2gs
// (key, slot) scratch pairs per query.
long long seal_diverse_chunks(int n) { return n_chunks_of(n); }

// Shared memory of the larger of the chunked route's two launches (bytes).
long long seal_diverse_smem(int n, int gs, int K) {
  const size_t p = partial_smem(K), f = finish_smem(n, 2 * gs);
  return (long long)(p > f ? p : f);
}

// Shared memory of the list route's launch (bytes), or -1 past the slots
// it sorts in shared memory.
long long seal_diverse_list_smem(int n, int gs, int K) {
  if (n > LIST_MAX) return -1;
  return (long long)list_smem(n, gs, K);
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

// The list route: one launch (tokens may be null: token = column).
int seal_diverse_list(const float* cons, const int* tokens, const float* beam_scores,
                      long long n_queries, int K, int N, int G, int eos, int tie_bits,
                      int penalize, float pen, float neg_inf, int* c_tok, int* c_par,
                      float* c_sco, unsigned char* c_fin, int* sel_tok, int* sel_par,
                      float* sel_sco, unsigned char* sel_fin, void* stream) {
  if (n_queries <= 0) return (int)cudaGetLastError();
  const int gs = K / G, n = gs * N;
  if (n > LIST_MAX) return (int)cudaErrorInvalidValue;
  const DivIn in{cons, tokens, nullptr, beam_scores, sel_tok, K, N, gs, eos, tie_bits, penalize,
                 pen, neg_inf};
  const DivOut o{c_tok, c_par, c_sco, c_fin, sel_tok, sel_par, sel_sco, sel_fin};
  const int n2 = pow2_at_least(n);
  const size_t smem = list_smem(n, gs, K);
  const int rc = set_smem(list_kernel, smem);
  if (rc) return rc;
  list_kernel<<<(unsigned)n_queries, n2 >= 4096 ? 1024 : 256, smem, (cudaStream_t)stream>>>(
      in, G, n2, o);
  return (int)cudaGetLastError();
}

// The wide route: launch 1 (kernel 3's select over the [n_queries * G,
// gs * N] rows through WideLoad, laid out by kernels/row_topk.py:plan into
// top_val / top_idx [n_queries * G, M]) and launch 2.
int seal_diverse_wide(const float* cons, const unsigned char* mask, const float* beam_scores,
                      long long n_queries, int K, int N, int G, int eos, int tie_bits,
                      int penalize, float pen, float neg_inf, int M, int threads, int splits,
                      int slice, int staged, int cap, int n2, int region, int smem,
                      float* top_val, long long* top_idx, int* c_tok, int* c_par,
                      float* c_sco, unsigned char* c_fin, int* sel_tok, int* sel_par,
                      float* sel_sco, unsigned char* sel_fin, void* stream) {
  if (n_queries <= 0) return (int)cudaGetLastError();
  const int gs = K / G, n = gs * N;
  if (M < 2 * gs || M > n || M > RANK_MAX) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const WideLoad load{beam_scores, mask, FastDiv((unsigned)N), N, gs, neg_inf};
  int rc = radix_topk(cons, n_queries * G, n, M, threads, splits, slice, staged, cap, n2, region,
                      smem, nullptr, top_val, top_idx, load, s);
  if (rc) return rc;
  const DivIn in{cons, nullptr, mask, beam_scores, sel_tok, K, N, gs, eos, tie_bits, penalize,
                 pen, neg_inf};
  const DivOut o{c_tok, c_par, c_sco, c_fin, sel_tok, sel_par, sel_sco, sel_fin};
  const size_t smem_f = wide_smem(M, gs, K);
  rc = set_smem(wide_finish_kernel, smem_f);
  if (rc) return rc;
  wide_finish_kernel<<<(unsigned)n_queries, WIDE_THREADS, smem_f, s>>>(
      in, G, M, pow2_at_least(M), top_val, top_idx, o);
  return (int)cudaGetLastError();
}

// The wide route's proof counter on the current device, read into *out
// after the work queued before it.
int seal_diverse_proof_failures(int* out) {
  return (int)cudaMemcpyFromSymbol(out, g_proof_failures, sizeof(int));
}

}  // extern "C"
