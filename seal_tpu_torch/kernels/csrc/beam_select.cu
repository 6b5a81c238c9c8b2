// Kernel 8: the decode step's candidate merge and beam selection, two modes
// over one device routine (an ordered top-n of a CTA's candidates).
//
// Replaces, in seal_tpu/decoding/constrained.py:
//   merge  -- _exact_proposals.merge_round (:612-663): buffer + LM top +
//             interval slab, dedup (_dedup_mask :1014), top-n_buf;
//   select -- _fast_exact_select.build_and_select (:850-871) with
//             _exact_slots' EOS/PAD slots (:370-392), _apply_branches (:897),
//             _dedup_mask (:1014), _select (:1046) and the soundness test
//             (:889-894); and step 0's selection epilogue after kernel 3.
//
// Order: lax.top_k's.  Each candidate maps to a 64-bit key, (monotone f32
// bits << 32) | ~slot, so the largest key is the best score and, among equal
// scores, the lowest slot; +0.0 ranks above -0.0 (f32 total order, as
// lax.top_k).  A CTA sorts its keys descending with a bitonic network in
// shared memory and reads the first n.  The float outputs are selected
// values and one f32 add (score + beam score, in the order of the plain
// code), so every output equals the plain version bit for bit.
//
// The ties mode (exact_ties) replaces _top_idx's lax.top_k with
// _top_by_score_then_id (:934): equal scores order by a tie id, ascending,
// whichever slot holds the candidate.  The key's low word is then ~tie_id:
// in merge the dedup id (`uniq`: the token if valid, else vocab + slot), in
// select the (parent beam, token) id of _beam_tok_tie (:958), (parent <<
// tie_bits) + token.  Each key carries its slot beside it, and equal keys
// order by slot, as the plain version's stable sort does.
//
// Bound on the card: latency.  A CTA handles a few hundred to a few thousand
// candidates; the O(n^2 / 2) first-instance dedup within a beam and the
// log2(n)^2 / 2 barrier-separated sort stages are its cost, and the inputs
// are read once.
//
// Two modes for the decode modes of _candidates_general (:305): select with
// keep_invalid (speculative, :343-367) takes a buffer slot that failed
// membership as it is, token and log-prob, with fm_valid false, where the
// fast path makes it a PAD candidate at PAD's log-prob (:798-799); and the
// step-0 epilogue with a token table (free generation, :329-336) reads the
// token of flat slot f from table[parent, f % ncand] instead of f % V.

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

__device__ __forceinline__ u64 pack(float v, int slot) {
  const unsigned u = __float_as_uint(v);
  const unsigned mono = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((u64)mono << 32) | (u64)(~(unsigned)slot);
}

__device__ __forceinline__ float key_value(u64 key) {
  const unsigned mono = (unsigned)(key >> 32);
  const unsigned u = (mono & 0x80000000u) ? (mono & 0x7fffffffu) : ~mono;
  return __uint_as_float(u);
}

__device__ __forceinline__ int key_slot(u64 key) {
  return (int)(~(unsigned)(key & 0xffffffffull));
}

// Descending bitonic sort of n2 (a power of two) keys in shared memory; the
// caller pads with key 0, which sorts last (real keys are >= 2^32).  With
// TIES, slots[i] travels with keys[i] and breaks equal keys, lower slot
// first (the caller pads slots with INT_MAX); without, keys are unique.
template <bool TIES>
__device__ void sort_desc(u64* keys, int* slots, int n2) {
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int t = threadIdx.x; t < n2 / 2; t += blockDim.x) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool desc = (lo & size) == 0;
        const u64 a = keys[lo], b = keys[hi];
        bool b_first = a < b, a_first = a > b;  // b (a) ranks strictly before a (b)
        if (TIES && a == b) {
          b_first = slots[hi] < slots[lo];
          a_first = !b_first;
        }
        if (desc ? b_first : a_first) {
          keys[lo] = b;
          keys[hi] = a;
          if (TIES) {
            const int sa = slots[lo];
            slots[lo] = slots[hi];
            slots[hi] = sa;
          }
        }
      }
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------- merge

// One CTA per beam row.  Candidates in order: buffer [n_buf] (absent on
// round 0: token 0, NEG_INF, invalid), LM top [n_top], slab [n_slab].  An
// invalid slot never shadows a valid copy (its dedup id is unique); a valid
// LM or slab slot needs lp > NEG_INF/2.  Keeps n_buf by (lp if valid and
// first instance, else NEG_INF), ties to the lower slot, or with TIES to
// the lower dedup id (token if valid, else vocab + slot).
template <bool TIES>
__global__ void merge_kernel(const int* buf_tok, const float* buf_lp, const unsigned char* buf_valid,
                             const int* top_tok, const float* top_lp, const unsigned char* top_ok,
                             long long top_stride, long long top_ok_stride, const int* slab_tok,
                             const float* slab_lp, const unsigned char* slab_ok, int n_buf,
                             int n_top, int n_slab, int n2, int vocab, float neg_inf, int* out_tok,
                             float* out_lp, unsigned char* out_valid) {
  extern __shared__ unsigned long long smem[];
  const int n = n_buf + n_top + n_slab;
  u64* keys = smem;
  int* s_slot = (int*)(keys + n2);  // TIES only
  int* s_tok = s_slot + (TIES ? n2 : 0);
  int* s_uid = s_tok + n;
  float* s_lp = (float*)(s_uid + n);
  unsigned char* s_vf = (unsigned char*)(s_lp + n);
  const long long r = blockIdx.x;
  const float live = neg_inf / 2.0f;

  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    int tok;
    float lp;
    bool ok;
    if (j < n_buf) {
      if (buf_tok != nullptr) {
        tok = buf_tok[r * n_buf + j];
        lp = buf_lp[r * n_buf + j];
        ok = buf_valid[r * n_buf + j] != 0;
      } else {
        tok = 0;
        lp = neg_inf;
        ok = false;
      }
    } else if (j < n_buf + n_top) {
      const int i = j - n_buf;
      tok = top_tok[r * top_stride + i];
      lp = top_lp[r * top_stride + i];
      ok = top_ok[r * top_ok_stride + i] != 0 && lp > live;
    } else {
      const int i = j - n_buf - n_top;
      tok = slab_tok[r * n_slab + i];
      lp = slab_lp[r * n_slab + i];
      ok = slab_ok[r * n_slab + i] != 0 && lp > live;
    }
    s_tok[j] = tok;
    s_lp[j] = lp;
    s_uid[j] = ok ? tok : -1 - j;  // valid tokens are >= 0
    if (TIES) s_slot[j] = j;
  }
  for (int j = n + threadIdx.x; j < n2; j += blockDim.x) {
    keys[j] = 0ull;
    if (TIES) s_slot[j] = 0x7fffffff;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int u = s_uid[j];
    bool fresh = true;
    if (u >= 0) {
      for (int i = 0; i < j; ++i) {
        if (s_uid[i] == u) {
          fresh = false;
          break;
        }
      }
    }
    const bool vf = u >= 0 && fresh;
    s_vf[j] = vf ? 1 : 0;
    keys[j] = pack(vf ? s_lp[j] : neg_inf, TIES ? (u >= 0 ? u : vocab + j) : j);
  }
  sort_desc<TIES>(keys, s_slot, n2);
  for (int t = threadIdx.x; t < n_buf; t += blockDim.x) {
    const int j = TIES ? s_slot[t] : key_slot(keys[t]);
    out_tok[r * n_buf + t] = s_tok[j];
    out_lp[r * n_buf + t] = s_lp[j];
    out_valid[r * n_buf + t] = s_vf[j];
  }
}

// ---------------------------------------------------------------- select

struct SelectOut {
  int* top_tok;
  int* top_parent;
  float* top_uncons;
  unsigned char* finite;
  int* sel_tok;
  int* sel_parent;
  float* sel_uncons;
  unsigned char* sel_finite;
  float* top_cons;
};

// The selection epilogue shared by both select forms: the 2K picks of query
// b in order (constrained score, flat slot, token, unconstrained log-prob
// before the beam score) -> the nine outputs, with the first K non-EOS picks
// continuing (then EOS picks in order when fewer than K are non-EOS: a
// stable sort of is_eos).  Called by every thread of the CTA.
__device__ void select_epilogue(long long b, int two_k, int k_out, int ncand, int eos,
                                float neg_inf, const float* e_cons, const int* e_slot,
                                const int* e_tok, const float* e_lp, const float* bs_row,
                                const SelectOut& o, int* s_cont) {
  const float fin_cut = neg_inf / 4.0f;
  for (int t = threadIdx.x; t < two_k; t += blockDim.x) {
    const int parent = e_slot[t] / ncand;
    const long long at = b * two_k + t;
    o.top_tok[at] = e_tok[t];
    o.top_parent[at] = parent;
    o.top_uncons[at] = __fadd_rn(e_lp[t], bs_row[parent]);
    o.finite[at] = e_cons[t] > fin_cut ? 1 : 0;
    o.top_cons[at] = e_cons[t];
  }
  if (threadIdx.x == 0) {
    int n = 0;
    for (int t = 0; t < two_k && n < k_out; ++t)
      if (e_tok[t] != eos) s_cont[n++] = t;
    for (int t = 0; t < two_k && n < k_out; ++t)
      if (e_tok[t] == eos) s_cont[n++] = t;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < k_out; c += blockDim.x) {
    const int t = s_cont[c];
    const int parent = e_slot[t] / ncand;
    const long long at = b * k_out + c;
    o.sel_tok[at] = e_tok[t];
    o.sel_parent[at] = parent;
    o.sel_uncons[at] = __fadd_rn(e_lp[t], bs_row[parent]);
    o.sel_finite[at] = e_cons[t] > fin_cut ? 1 : 0;
  }
}

struct SelectIn {
  const int* buf_tok;  // [B*n_par, n_buf], or null: every buffer slot unfilled
  const float* buf_lp;
  const unsigned char* buf_valid;
  const int* win_tok;  // [B*n_par, w]
  const unsigned char* win_valid;
  const float* win_lp;
  const unsigned char* eos_ok;  // [B*n_par] at stride eos_ok_stride
  long long eos_ok_stride;
  const float* lp;  // [B*n_par, V] at row stride lp_stride
  long long lp_stride;
  const int* prev_count;  // [B, n_par]
  const unsigned char* finished;
  const float* beam_scores;  // [B, n_par]
  const unsigned char* need;  // [B, n_par], or null: no soundness test
  const float* th_lp;
  int keep_invalid;  // a buffer slot that is not valid keeps its token and lp
};

// One CTA per query: the n_par * ncand candidates (ncand = n_buf + w + 2:
// buffer, window, EOS, PAD) of its beams.  With TIES, equal scores order by
// (parent beam, token): tie id (k << tie_bits) + token, the token clipped
// to [0, 2^tie_bits) as _beam_tok_tie clips it.
template <bool TIES>
__global__ void select_kernel(SelectIn in, SelectOut o, unsigned char* unsound, int n_par,
                              int n_buf, int w, int two_k, int k_out, int n2, int eos, int pad,
                              int stop_at_count, int always_allow_eos, int tie_bits,
                              float neg_inf) {
  extern __shared__ unsigned long long smem[];
  const int ncand = n_buf + w + 2;
  const int n = n_par * ncand;
  u64* keys = smem;
  int* s_slot = (int*)(keys + n2);  // TIES only
  int* s_tok = s_slot + (TIES ? n2 : 0);
  float* s_lp = (float*)(s_tok + n);
  float* e_cons = s_lp + n;
  float* e_lp = e_cons + two_k;
  int* e_slot = (int*)(e_lp + two_k);
  int* e_tok = e_slot + two_k;
  int* s_cont = e_tok + two_k;
  const long long b = blockIdx.x;
  const float* bs_row = in.beam_scores + b * n_par;

  for (int f = threadIdx.x; f < n; f += blockDim.x) {
    const int k = f / ncand, j = f - k * ncand;
    const long long row = b * n_par + k;
    int tok;
    float lp;
    if (j < n_buf) {
      const bool v = in.buf_tok != nullptr &&
                     (in.keep_invalid || in.buf_valid[row * n_buf + j] != 0);
      // unfilled slots are PAD candidates at PAD's log-prob
      tok = v ? in.buf_tok[row * n_buf + j] : pad;
      lp = v ? in.buf_lp[row * n_buf + j] : in.lp[row * in.lp_stride + pad];
    } else if (j < n_buf + w) {
      tok = in.win_tok[row * w + (j - n_buf)];
      lp = in.win_lp[row * w + (j - n_buf)];
    } else if (j == n_buf + w) {
      tok = eos;
      lp = in.lp[row * in.lp_stride + eos];
    } else {
      tok = pad;
      lp = in.lp[row * in.lp_stride + pad];
    }
    s_tok[f] = tok;
    s_lp[f] = lp;
    if (TIES) s_slot[f] = f;
  }
  for (int f = n + threadIdx.x; f < n2; f += blockDim.x) {
    keys[f] = 0ull;
    if (TIES) s_slot[f] = 0x7fffffff;
  }
  __syncthreads();
  for (int f = threadIdx.x; f < n; f += blockDim.x) {
    const int k = f / ncand, j = f - k * ncand;
    const long long row = b * n_par + k;
    const int tok = s_tok[f];
    bool keep = true;  // first instance of the token within the beam
    for (int i = k * ncand; i < f; ++i) {
      if (s_tok[i] == tok) {
        keep = false;
        break;
      }
    }
    bool fm_valid;
    if (j < n_buf)
      fm_valid = in.buf_tok != nullptr && in.buf_valid[row * n_buf + j] != 0;
    else if (j < n_buf + w)
      fm_valid = in.win_valid[row * w + (j - n_buf)] != 0;
    else if (j == n_buf + w)
      fm_valid = in.eos_ok[row * in.eos_ok_stride] != 0;
    else
      fm_valid = false;
    const bool fin = in.finished[row] != 0;
    const int count_eff = fin ? 0 : in.prev_count[row];
    const bool stop_trig = stop_at_count > 0 && count_eff <= stop_at_count;
    bool allowed = stop_trig ? tok == eos : (fin ? tok == pad : fm_valid);
    if (always_allow_eos) allowed = allowed || tok == eos;
    const float cons = (allowed && keep) ? s_lp[f] : neg_inf;
    const int tie = TIES ? (k << tie_bits) + min(max(tok, 0), (1 << tie_bits) - 1) : f;
    keys[f] = pack(__fadd_rn(cons, bs_row[k]), tie);
  }
  sort_desc<TIES>(keys, s_slot, n2);
  for (int t = threadIdx.x; t < two_k; t += blockDim.x) {
    const u64 key = keys[t];
    const int f = TIES ? s_slot[t] : key_slot(key);
    e_cons[t] = key_value(key);
    e_slot[t] = f;
    e_tok[t] = s_tok[f];
    e_lp[t] = s_lp[f];
  }
  __syncthreads();
  select_epilogue(b, two_k, k_out, ncand, eos, neg_inf, e_cons, e_slot, e_tok, e_lp, bs_row, o,
                  s_cont);
  if (unsound != nullptr && threadIdx.x == 0) {
    // a beam whose round missed tokens scoring <= beam score + th_lp is
    // unsound when that bound reaches the 2K-th selected score (">=": a tie
    // would make the tie order depend on the sweep schedule)
    const float s_star = e_cons[two_k - 1];
    unsigned char bad = 0;
    for (int k = 0; k < n_par; ++k) {
      const long long row = b * n_par + k;
      if (in.need[row] != 0 && __fadd_rn(bs_row[k], in.th_lp[row]) >= s_star) bad = 1;
    }
    unsound[b] = bad;
  }
}

// Step 0: kernel 3 already ranked the V-wide rows (flat [B, n_par * V],
// token = slot % V); only the epilogue runs here.  With a token table
// (free generation) the flat axis is [B, n_par * ncand] and slot f of parent
// k is token table[(b * n_par + k) * ncand + f % ncand].
__global__ void select_top_kernel(const float* top_cons, const long long* top_idx, const float* lp,
                                  long long lp_stride, const float* beam_scores,
                                  long long bs_stride, const int* table, SelectOut o, int n_par,
                                  int ncand, int two_k, int k_out, int eos, float neg_inf) {
  extern __shared__ unsigned long long smem[];
  float* e_cons = (float*)smem;
  float* e_lp = e_cons + two_k;
  int* e_slot = (int*)(e_lp + two_k);
  int* e_tok = e_slot + two_k;
  int* s_cont = e_tok + two_k;
  const long long b = blockIdx.x;
  for (int t = threadIdx.x; t < two_k; t += blockDim.x) {
    const int f = (int)top_idx[b * two_k + t];
    const int parent = f / ncand, slot = f - parent * ncand;
    const int tok = table != nullptr ? table[(b * n_par + parent) * ncand + slot] : slot;
    e_cons[t] = top_cons[b * two_k + t];
    e_slot[t] = f;
    e_tok[t] = tok;
    e_lp[t] = lp[(b * n_par + parent) * lp_stride + tok];
  }
  __syncthreads();
  select_epilogue(b, two_k, k_out, ncand, eos, neg_inf, e_cons, e_slot, e_tok, e_lp,
                  beam_scores + b * bs_stride, o, s_cont);
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

// Shared memory each mode needs (bytes); the wrapper refuses shapes past
// the card's 227 KB.  The ties mode adds each key's slot.
long long seal_beam_merge_smem(int n, int ties) {
  return (ties ? 12LL : 8LL) * pow2_at_least(n) + 13LL * n;
}

long long seal_beam_select_smem(int n, int two_k, int k_out, int ties) {
  return (ties ? 12LL : 8LL) * pow2_at_least(n) + 8LL * n + 16LL * two_k + 4LL * k_out;
}

int seal_beam_merge(const int* buf_tok, const float* buf_lp, const unsigned char* buf_valid,
                    const int* top_tok, const float* top_lp, const unsigned char* top_ok,
                    long long top_stride, long long top_ok_stride, const int* slab_tok,
                    const float* slab_lp, const unsigned char* slab_ok, long long rows, int n_buf,
                    int n_top, int n_slab, int vocab, int ties, float neg_inf, int* out_tok,
                    float* out_lp, unsigned char* out_valid, void* stream) {
  if (rows <= 0) return (int)cudaGetLastError();
  const int n = n_buf + n_top + n_slab;
  const int n2 = pow2_at_least(n);
  const size_t smem = (size_t)seal_beam_merge_smem(n, ties);
  const auto kernel = ties ? merge_kernel<true> : merge_kernel<false>;
  const int rc = set_smem(kernel, smem);
  if (rc) return rc;
  const int threads = n2 >= 1024 ? 512 : 256;
  kernel<<<(unsigned)rows, threads, smem, (cudaStream_t)stream>>>(
      buf_tok, buf_lp, buf_valid, top_tok, top_lp, top_ok, top_stride, top_ok_stride, slab_tok,
      slab_lp, slab_ok, n_buf, n_top, n_slab, n2, vocab, neg_inf, out_tok, out_lp, out_valid);
  return (int)cudaGetLastError();
}

int seal_beam_select(const int* buf_tok, const float* buf_lp, const unsigned char* buf_valid,
                     const int* win_tok, const unsigned char* win_valid, const float* win_lp,
                     const unsigned char* eos_ok, long long eos_ok_stride, const float* lp,
                     long long lp_stride, const int* prev_count, const unsigned char* finished,
                     const float* beam_scores, const unsigned char* need, const float* th_lp,
                     long long n_queries, int n_par, int n_buf, int w, int k_out, int eos,
                     int pad, int stop_at_count, int always_allow_eos, int tie_bits,
                     int keep_invalid, float neg_inf,
                     int* top_tok, int* top_parent, float* top_uncons, unsigned char* finite,
                     int* sel_tok, int* sel_parent, float* sel_uncons, unsigned char* sel_finite,
                     float* top_cons, unsigned char* unsound, void* stream) {
  if (n_queries <= 0) return (int)cudaGetLastError();
  const SelectIn in{buf_tok, buf_lp,     buf_valid,  win_tok,  win_valid, win_lp,
                    eos_ok,  eos_ok_stride, lp,      lp_stride, prev_count, finished,
                    beam_scores, need,  th_lp,  keep_invalid};
  const SelectOut o{top_tok, top_parent, top_uncons, finite, sel_tok,
                    sel_parent, sel_uncons, sel_finite, top_cons};
  const int two_k = 2 * k_out;
  const int n = n_par * (n_buf + w + 2);
  const int n2 = pow2_at_least(n);
  const size_t smem = (size_t)seal_beam_select_smem(n, two_k, k_out, tie_bits > 0);
  const auto kernel = tie_bits > 0 ? select_kernel<true> : select_kernel<false>;
  const int rc = set_smem(kernel, smem);
  if (rc) return rc;
  const int threads = n2 >= 2048 ? 1024 : 256;
  kernel<<<(unsigned)n_queries, threads, smem, (cudaStream_t)stream>>>(
      in, o, unsound, n_par, n_buf, w, two_k, k_out, n2, eos, pad, stop_at_count,
      always_allow_eos, tie_bits, neg_inf);
  return (int)cudaGetLastError();
}

int seal_beam_select_top(const float* top_cons_in, const long long* top_idx, const float* lp,
                         long long lp_stride, const float* beam_scores, long long bs_stride,
                         const int* table, long long n_queries, int n_par, int ncand, int k_out,
                         int eos,
                         float neg_inf, int* top_tok, int* top_parent, float* top_uncons,
                         unsigned char* finite, int* sel_tok, int* sel_parent, float* sel_uncons,
                         unsigned char* sel_finite, float* top_cons, void* stream) {
  if (n_queries <= 0) return (int)cudaGetLastError();
  const SelectOut o{top_tok, top_parent, top_uncons, finite, sel_tok,
                    sel_parent, sel_uncons, sel_finite, top_cons};
  const int two_k = 2 * k_out;
  const size_t smem = 16 * (size_t)two_k + 4 * (size_t)k_out;
  select_top_kernel<<<(unsigned)n_queries, 64, smem, (cudaStream_t)stream>>>(
      top_cons_in, top_idx, lp, lp_stride, beam_scores, bs_stride, table, o, n_par, ncand, two_k,
      k_out, eos, neg_inf);
  return (int)cudaGetLastError();
}

}  // extern "C"
