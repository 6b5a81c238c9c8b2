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
// Order: lax.top_k's, as 64-bit keys (select_common.cuh).  A CTA sorts its
// keys descending with a bitonic network in shared memory and reads the
// first n.  The float outputs are selected
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
// candidates; the log2(n)^2 / 2 barrier-separated stages of its sorts are
// the block routes' cost (the merge's first-instance dedup is a sort too,
// first_instances; the block and large-n selections' is a serial scan per
// beam), and the inputs are read once.  The warp and wide routes and the
// candidate mode take neither sorts of the query nor serial scans.
//
// Two modes for the decode modes of _candidates_general (:305): select with
// keep_invalid (speculative, :343-367) takes a buffer slot that failed
// membership as it is, token and log-prob, with fm_valid false, where the
// fast path makes it a PAD candidate at PAD's log-prob (:798-799); and the
// step-0 epilogue with a token table (free generation, :329-336) reads the
// token of flat slot f from table[parent, f % ncand] instead of f % V.
// The candidate mode (sampling and diverse groups, _candidates_general
// :359-367) writes select's candidates, branches and dedup applied, and
// selects nothing.

// Routes past shared memory (F1, F2 in ROADMAP C): where a row's candidates
// do not fit a CTA, the first-instance dedup runs through a [rows, vocab]
// table in device memory, each token's lowest slot (memset to 0xff, one
// atomicMin a slot; a slot is its token's first instance where the table
// holds it).  The merge then sorts each row's keys in device memory
// (global_sort.cuh) and takes the first n_buf; the selection sorts each
// beam's candidates in chunks of shared memory, keeps each chunk's top 2K,
// the beam's top 2K of those, and finishes as the large-n route does.  Both
// need every token of a row in [0, vocab) (the decode's tokens are lp
// columns) and, for the merge, a valid slot's lp above NEG_INF/2 (as
// merge_round makes them).
//
// The selection's warp route (ncand <= 128, 2K <= 64, n_par <= 32: the
// bench's beam 15 and beam 32 at a 32-row window): one CTA a query, a warp a
// beam.  The warp holds its beam's slots in registers (4 a lane at most),
// finds first instances with __match_any_sync within a register row and a
// broadcast scan of the earlier rows, keys them as select_kernel does and
// sorts them with a bitonic network of shuffles: no shared memory and no
// barrier.  Each warp's first 2K keys go to shared memory as a sorted
// list; a survivor's rank in the query is its place in its own list plus,
// for each other list, the number of keys before it there (a binary
// search).  The 2K survivors ranked below 2K write their place directly:
// one barrier, no sort of the query's keys.  The soundness test is a
// block-wide OR.
//
// The wide route (ncand <= SERIAL_MAX, 2K <= 64, n_par <= 32, while the
// regions fit: the speculative default's [15, 386] and beam 32 over 4
// shards' [32, 578], where the one-block route sorted 8,192 keys in 91
// barrier-separated stages and the large-n route sorted each beam, then the
// query, in two launches): a cluster of CTAs a query, a warp a beam in its
// own region of shared memory, no barrier before the query's stage.  No
// serial dedup: the first instances come from a hash table of the beam's
// tokens; no sort of the beam in shared memory: a running first 64 in
// registers, each chunk of 64 keys sorted by the warp route's shuffle
// network and merged in; then the beams' lists merged in a tree.  The
// candidate mode finds its first instances the same way, a warp a row.

#include <climits>
#include <cooperative_groups.h>

#include "global_sort.cuh"
#include "select_common.cuh"

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------- merge

// First instances by a sort, not by comparing every pair (O(n log^2 n),
// where the pairs cost O(n^2): 8M comparisons a CTA at 4,096 candidates).
// A valid candidate's key is (uid + 1) << 32 | its index, an invalid one's
// (whose uid is its own) 0xffffffff << 32 | index, padding 0: sorted
// descending, each uid's run lies together with its smallest index last,
// and that index is the first instance.  vf[i] gets (valid and first
// instance); keys[n, n2) are 0 again on return.
__device__ __forceinline__ u64 dedup_key(int uid, int i) {
  return ((u64)(uid >= 0 ? (unsigned)uid + 1u : 0xffffffffu) << 32) | (unsigned)i;
}

__device__ void first_instances(u64* keys, int n2, unsigned char* vf) {
  sort_desc<false>(keys, nullptr, n2);
  for (int p = threadIdx.x; p < n2; p += blockDim.x) {
    const u64 k = keys[p];
    if (k == 0ull) continue;
    const unsigned uf = (unsigned)(k >> 32);
    const unsigned nxt = p + 1 < n2 ? (unsigned)(keys[p + 1] >> 32) : 0u;
    vf[(unsigned)k] = uf != 0xffffffffu && uf != nxt ? 1 : 0;
  }
  __syncthreads();
}

// The merge's first-pass inputs: a beam row's buffer [n_buf] (null on
// round 0: token 0, NEG_INF, invalid), LM top [n_top] (row-strided) and
// slab [n_slab].
struct MergeIn {
  const int* buf_tok;
  const float* buf_lp;
  const unsigned char* buf_valid;
  const int* top_tok;
  const float* top_lp;
  const unsigned char* top_ok;
  long long top_stride, top_ok_stride;
  const int* slab_tok;
  const float* slab_lp;
  const unsigned char* slab_ok;
  int n_buf, n_top, n_slab;
};

// Slot j of row r: its token, log-prob and validity (an LM or slab slot
// needs its flag and lp > NEG_INF/2).
__device__ __forceinline__ void load_merge_slot(const MergeIn& in, long long r, int j,
                                                float neg_inf, int* tok, float* lp, bool* ok) {
  if (j < in.n_buf) {
    if (in.buf_tok != nullptr) {
      *tok = in.buf_tok[r * in.n_buf + j];
      *lp = in.buf_lp[r * in.n_buf + j];
      *ok = in.buf_valid[r * in.n_buf + j] != 0;
    } else {
      *tok = 0;
      *lp = neg_inf;
      *ok = false;
    }
  } else if (j < in.n_buf + in.n_top) {
    const int t = j - in.n_buf;
    *tok = in.top_tok[r * in.top_stride + t];
    *lp = in.top_lp[r * in.top_stride + t];
    *ok = in.top_ok[r * in.top_ok_stride + t] != 0 && *lp > neg_inf / 2.0f;
  } else {
    const int t = j - in.n_buf - in.n_top;
    *tok = in.slab_tok[r * in.n_slab + t];
    *lp = in.slab_lp[r * in.n_slab + t];
    *ok = in.slab_ok[r * in.n_slab + t] != 0 && *lp > neg_inf / 2.0f;
  }
}

// The merge.  Candidates of a beam row in slot order: buffer [n_buf]
// (absent on round 0: token 0, NEG_INF, invalid), LM top [n_top], slab
// [n_slab].  An invalid slot never shadows a valid copy (its dedup id is
// unique); a valid LM or slab slot needs lp > NEG_INF/2.  Keeps n_buf by
// (lp if valid and first instance, else NEG_INF), ties to the lower slot,
// or with TIES to the lower dedup id (token if valid, else vocab + slot).
//
// One pass: CTA (r, c) takes `chunk` consecutive candidates of row r,
// dedups them (first instance within the chunk), keeps its n_buf best in
// the merge's order and, where the row has more chunks, writes them out in
// slot order with their global slot; passes repeat over the survivors
// until one chunk holds a row, whose pass writes the merge's outputs.  A
// row that fits one CTA's shared memory (n <= 8,192; 4,096 under TIES) is
// one pass of one chunk.  The large-n case (sample=True with top_m >= 482,
// exact_loop_chunk >= 4082 at beam 15, num_beams >= 241) takes chunks of
// 4,096 (8,192 past n_buf 2,048), at least 2 n_buf, so a pass at least
// halves a row.  A wider buffer (past 4,096, or past 2,048 under TIES,
// whose 8,192-wide chunk would need 245,760 B) takes the device-memory
// route below (merge_table_kernel, merge_keys_kernel, global_sort).
//
// Exact because valid copies of one token in a row carry one log-prob:
// the buffer, the LM top and the slab all take a token's log-prob from the
// beam's lp row (constrained.py's merge_round; a valid slot needs lp >
// NEG_INF/2, and the loop's consumed tokens, NEG_INF in `work`, are never
// valid).  So a token's first instance ranks ahead of its copies, in (lp
// desc, slot asc) and, under TIES, in (lp desc, dedup id asc) order, and
// every chunk-fresh token above a candidate maps to a distinct globally
// fresh token above it: a candidate among the row's n_buf best (or among
// the unfilled slots that follow them, in their order) is among its
// chunk's n_buf best, and a survivor that is fresh in a later pass only
// because its first instance was dropped ranks below n_buf fresh ones.
// Each pass's input is in slot order, so a chunk's local order is its slot
// order.  kernels/beam_select.py:beam_merge_large_plain is the
// specification.
template <bool TIES>
__global__ void merge_kernel(MergeIn src, const int* in_tok, const float* in_lp,
                             const unsigned char* in_ok, const int* in_slot, int width, int chunk,
                             int n_chunks, int n2, int n_buf, int vocab, float neg_inf,
                             int* out_tok, float* out_lp, unsigned char* out_ok, int* out_slot) {
  extern __shared__ unsigned long long smem[];
  u64* keys = smem;                             // [n2]
  int* s_idx = (int*)(keys + n2);               // [n2] TIES only: local index beside its key
  int* s_tok = s_idx + (TIES ? n2 : 0);         // [chunk]
  int* s_uid = s_tok + chunk;                   // [chunk]; then the kept local indices
  int* s_slot = s_uid + chunk;                  // [chunk]
  float* s_lp = (float*)(s_slot + chunk);       // [chunk]
  unsigned char* s_ok = (unsigned char*)(s_lp + chunk);  // [chunk]
  unsigned char* s_vf = s_ok + chunk;           // [chunk]
  const long long r = blockIdx.x / n_chunks;
  const int c = (int)(blockIdx.x % n_chunks);
  const int j0 = c * chunk;
  const int n = min(chunk, width - j0);
  const int keep = min(n_buf, n);
  const bool last = n_chunks == 1;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int j = j0 + i;
    int tok, slot = j;
    float lp;
    bool ok;
    if (in_tok != nullptr) {  // a later pass: the survivors, in slot order
      const long long at = r * width + j;
      tok = in_tok[at];
      lp = in_lp[at];
      ok = in_ok[at] != 0;
      slot = in_slot[at];
    } else {  // the first pass: the round's own candidates
      load_merge_slot(src, r, j, neg_inf, &tok, &lp, &ok);
    }
    s_tok[i] = tok;
    s_lp[i] = lp;
    s_ok[i] = ok ? 1 : 0;
    s_slot[i] = slot;
    s_uid[i] = ok ? tok : -1 - i;  // valid tokens are >= 0
    keys[i] = dedup_key(s_uid[i], i);
    if (TIES) s_idx[i] = i;
  }
  for (int i = n + threadIdx.x; i < n2; i += blockDim.x) {
    keys[i] = 0ull;
    if (TIES) s_idx[i] = 0x7fffffff;
  }
  first_instances(keys, n2, s_vf);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int u = s_uid[i];
    // ties among equal scores: the local index (the slot order), or under
    // TIES the dedup id, then the local index
    keys[i] = pack(s_vf[i] ? s_lp[i] : neg_inf, TIES ? (u >= 0 ? u : vocab + s_slot[i]) : i);
  }
  sort_desc<TIES>(keys, s_idx, n2);
  if (last) {
    for (int t = threadIdx.x; t < n_buf; t += blockDim.x) {
      const int i = TIES ? s_idx[t] : key_slot(keys[t]);
      out_tok[r * n_buf + t] = s_tok[i];
      out_lp[r * n_buf + t] = s_lp[i];
      out_ok[r * n_buf + t] = s_vf[i];
    }
    return;
  }
  // the kept candidates in slot order: each one's place is the number of
  // kept ones before it
  int* kept = s_uid;  // the dedup ids are no longer read
  for (int t = threadIdx.x; t < keep; t += blockDim.x) kept[t] = TIES ? s_idx[t] : key_slot(keys[t]);
  __syncthreads();
  const int out_width = (n_chunks - 1) * n_buf + min(n_buf, width - (n_chunks - 1) * chunk);
  for (int t = threadIdx.x; t < keep; t += blockDim.x) {
    const int i = kept[t];
    int at = 0;
    for (int u = 0; u < keep; ++u) at += kept[u] < i;
    const long long o = r * out_width + (long long)c * n_buf + at;
    out_tok[o] = s_tok[i];
    out_lp[o] = s_lp[i];
    out_ok[o] = s_ok[i];
    out_slot[o] = s_slot[i];
  }
}

// The merge past shared memory, in three launches after the table's memset
// (kernels/beam_select.py:merge_table_plain is the specification):
// merge_table_kernel records each valid token's lowest slot; merge_keys_kernel
// writes one unique 64-bit key a slot whose descending order is the merge's
// order, padded with 0 to n2; global_sort sorts each row and MergeOut reads
// the first n_buf back.  The key: pack(rank, slot) with rank = lp for a valid
// first instance, else NEG_INF; under TIES a first instance's is pack(lp,
// token) (its dedup id; the row's first instances have distinct tokens), and
// every other slot's, all at rank NEG_INF, (0x7fffff - dedup id) << 32 |
// ~slot: below every first instance (whose lp > NEG_INF/2 puts its key's
// high word at 0x01000000 or more), in (dedup id, slot) order, as the plain
// version's stable sort leaves them.
__global__ void merge_table_kernel(MergeIn in, long long rows, int n, int vocab, float neg_inf,
                                   unsigned* table) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * n) return;
  const long long r = t / n;
  const int j = (int)(t - r * n);
  int tok;
  float lp;
  bool ok;
  load_merge_slot(in, r, j, neg_inf, &tok, &lp, &ok);
  if (ok && tok >= 0 && tok < vocab) atomicMin(table + r * vocab + tok, (unsigned)j);
}

__device__ __forceinline__ bool merge_fresh(const unsigned* table, long long r, int vocab, int tok,
                                            int j, bool ok) {
  return ok && (tok < 0 || tok >= vocab || table[r * vocab + tok] == (unsigned)j);
}

template <bool TIES>
__global__ void merge_keys_kernel(MergeIn in, long long rows, int n, int n2, int vocab,
                                  float neg_inf, const unsigned* table, u64* keys) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * n2) return;
  const long long r = t / n2;
  const int j = (int)(t - r * n2);
  if (j >= n) {
    keys[t] = 0ull;
    return;
  }
  int tok;
  float lp;
  bool ok;
  load_merge_slot(in, r, j, neg_inf, &tok, &lp, &ok);
  const bool fresh = merge_fresh(table, r, vocab, tok, j, ok);
  if (!TIES) {
    keys[t] = pack(fresh ? lp : neg_inf, j);
  } else if (fresh) {
    keys[t] = pack(lp, tok);
  } else {
    const unsigned uid = ok ? (unsigned)tok : (unsigned)(vocab + j);
    keys[t] = ((u64)(0x7fffffu - uid) << 32) | (u64)(~(unsigned)j);
  }
}

// global_sort's last pass: the t-th key of row r names its slot (its token,
// for a TIES first instance: the table gives the slot), whose token,
// log-prob and freshness are the merge's t-th output.
struct MergeOut {
  MergeIn in;
  const unsigned* table;
  int vocab, n_buf, ties;
  float neg_inf;
  int* out_tok;
  float* out_lp;
  unsigned char* out_ok;
  __device__ void operator()(long long r, int t, u64 w) const {
    const unsigned low = ~(unsigned)(w & 0xffffffffull);
    const bool by_token = ties && (unsigned)(w >> 32) >= 0x800000u;
    const int j = by_token ? (int)table[r * vocab + low] : (int)low;
    int tok;
    float lp;
    bool ok;
    load_merge_slot(in, r, j, neg_inf, &tok, &lp, &ok);
    out_tok[r * n_buf + t] = tok;
    out_lp[r * n_buf + t] = lp;
    out_ok[r * n_buf + t] = merge_fresh(table, r, vocab, tok, j, ok) ? 1 : 0;
  }
};

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
// stable sort of is_eos, placed by the first warp's ballots).  Called by
// every thread of a CTA of at least 32.
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
  if (threadIdx.x < 32) {
    const unsigned below = (1u << threadIdx.x) - 1u;
    int n = 0;  // the picks placed so far: the non-EOS ones, then the EOS ones
    for (int want_eos = 0; want_eos < 2; ++want_eos) {
      for (int t0 = 0; t0 < two_k; t0 += 32) {
        const int t = t0 + (int)threadIdx.x;
        const bool mine = t < two_k && (e_tok[t] == eos) == (want_eos != 0);
        const unsigned ms = __ballot_sync(0xffffffffu, mine);
        const int at = n + __popc(ms & below);
        if (mine && at < k_out) s_cont[at] = t;
        n += __popc(ms);
      }
    }
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

// Candidate slot j of beam row `row` (buffer [n_buf], window [w], EOS, PAD):
// its token and log-prob.  An unfilled buffer slot (or every buffer slot,
// when there is no buffer) is a PAD candidate at PAD's log-prob, unless
// keep_invalid keeps a buffer slot's own token and log-prob.
__device__ __forceinline__ void load_slot(const SelectIn& in, long long row, int j, int n_buf,
                                          int w, int eos, int pad, int* tok, float* lp) {
  if (j < n_buf) {
    const bool v = in.buf_tok != nullptr &&
                   (in.keep_invalid || in.buf_valid[row * n_buf + j] != 0);
    *tok = v ? in.buf_tok[row * n_buf + j] : pad;
    *lp = v ? in.buf_lp[row * n_buf + j] : in.lp[row * in.lp_stride + pad];
  } else if (j < n_buf + w) {
    *tok = in.win_tok[row * w + (j - n_buf)];
    *lp = in.win_lp[row * w + (j - n_buf)];
  } else if (j == n_buf + w) {
    *tok = eos;
    *lp = in.lp[row * in.lp_stride + eos];
  } else {
    *tok = pad;
    *lp = in.lp[row * in.lp_stride + pad];
  }
}

// The reference branches (_apply_branches): a stop-forced beam allows only
// EOS, a finished beam only PAD, any other the slot's FM membership;
// always_allow_eos adds EOS.
struct RowBranch {
  bool fin, stop;  // finished; stop-forced
};

__device__ __forceinline__ RowBranch row_branch(const SelectIn& in, long long row,
                                                int stop_at_count) {
  const bool fin = in.finished[row] != 0;
  const int count_eff = fin ? 0 : in.prev_count[row];
  return RowBranch{fin, stop_at_count > 0 && count_eff <= stop_at_count};
}

// Slot j's FM membership: its buffer or window flag, EOS's, none for PAD.
__device__ __forceinline__ bool slot_fm_valid(const SelectIn& in, long long row, int j, int n_buf,
                                              int w) {
  if (j < n_buf) return in.buf_tok != nullptr && in.buf_valid[row * n_buf + j] != 0;
  if (j < n_buf + w) return in.win_valid[row * w + (j - n_buf)] != 0;
  if (j == n_buf + w) return in.eos_ok[row * in.eos_ok_stride] != 0;
  return false;
}

__device__ __forceinline__ bool branch_allowed(RowBranch rb, bool fm_valid, int tok, int eos,
                                               int pad, int always_allow_eos) {
  const bool allowed = rb.stop ? tok == eos : (rb.fin ? tok == pad : fm_valid);
  return allowed || (always_allow_eos && tok == eos);
}

__device__ __forceinline__ bool slot_allowed(const SelectIn& in, long long row, int j, int tok,
                                             int n_buf, int w, int eos, int pad,
                                             int stop_at_count, int always_allow_eos) {
  return branch_allowed(row_branch(in, row, stop_at_count), slot_fm_valid(in, row, j, n_buf, w),
                        tok, eos, pad, always_allow_eos);
}

// A warp's pass over its beam row's slots, SLOT_ROWS register rows at a time
// so that their loads are in flight together: fn(r, j, tok, lp, allowed) for
// slot j = 32 r + lane (every lane calls it for every row r < ceil(ncand /
// 32); j >= ncand marks a padding lane, tok 0).  `allowed` is the branch
// rule without the first-instance test.
constexpr int SLOT_ROWS = 8;

template <typename Fn>
__device__ __forceinline__ void warp_slots(const SelectIn& in, long long row, int n_buf, int w,
                                           int eos, int pad, int stop_at_count,
                                           int always_allow_eos, int lane, Fn fn) {
  const int ncand = n_buf + w + 2;
  const int rows = (ncand + 31) >> 5;
  const RowBranch rb = row_branch(in, row, stop_at_count);
  for (int r0 = 0; r0 < rows; r0 += SLOT_ROWS) {
    int tok[SLOT_ROWS];
    float lp[SLOT_ROWS];
    bool fm[SLOT_ROWS];
#pragma unroll
    for (int u = 0; u < SLOT_ROWS; ++u) {
      const int j = ((r0 + u) << 5) + lane;
      tok[u] = 0;
      lp[u] = 0.0f;
      fm[u] = false;
      if (j < ncand) {
        load_slot(in, row, j, n_buf, w, eos, pad, &tok[u], &lp[u]);
        fm[u] = slot_fm_valid(in, row, j, n_buf, w);
      }
    }
#pragma unroll
    for (int u = 0; u < SLOT_ROWS; ++u) {
      const int j = ((r0 + u) << 5) + lane;
      if (r0 + u < rows)
        fn(r0 + u, j, tok[u], lp[u],
           j < ncand && branch_allowed(rb, fm[u], tok[u], eos, pad, always_allow_eos));
    }
  }
}

// True where s_tok[f] is the first instance of its token in s_tok[first..f].
__device__ __forceinline__ bool first_instance(const int* s_tok, int first, int f) {
  for (int i = first; i < f; ++i)
    if (s_tok[i] == s_tok[f]) return false;
  return true;
}

// The table routes' dedup: each token's lowest slot in its beam row (the
// table is memset to 0xff first).  A token outside [0, vocab) is never
// recorded and counts as a first instance (the decode's tokens are lp
// columns, so none is).
__global__ void select_table_kernel(SelectIn in, long long rows, int n_buf, int w, int eos,
                                    int pad, int vocab, unsigned* table) {
  const int ncand = n_buf + w + 2;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * ncand) return;
  const long long row = t / ncand;
  const int j = (int)(t - row * ncand);
  int tok;
  float lp;
  load_slot(in, row, j, n_buf, w, eos, pad, &tok, &lp);
  if (tok >= 0 && tok < vocab) atomicMin(table + row * vocab + tok, (unsigned)j);
}

__device__ __forceinline__ bool table_first(const unsigned* table, long long row, int vocab,
                                            int tok, int j) {
  return tok < 0 || tok >= vocab || table[row * vocab + tok] == (unsigned)j;
}

// ---- the warp route --------------------------------------------------------

constexpr unsigned FULL = 0xffffffffu;

// (key, slot) pairs in the selection's order: key descending, then slot
// ascending (only under TIES can two keys be equal).
template <bool TIES>
__device__ __forceinline__ bool ranks_before(u64 ka, int sa, u64 kb, int sb) {
  return ka > kb || (TIES && ka == kb && sa < sb);
}

// Descending bitonic sort of a warp's 32 R elements, element e = r * 32 +
// lane in register r of its lane: strides of 32 and more swap registers
// inside a lane, shorter ones trade with lane ^ stride by shuffles.  Under
// TIES the slot travels with its key.
template <bool TIES, int R>
__device__ __forceinline__ void warp_sort_desc(u64 (&key)[R], int (&slot)[R], int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * R; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int r2 = r ^ (stride >> 5);
          if (r2 > r) {
            const bool desc = (((r << 5) | lane) & size) == 0;
            if (ranks_before<TIES>(key[r2], slot[r2], key[r], slot[r]) == desc) {
              const u64 kt = key[r];
              key[r] = key[r2];
              key[r2] = kt;
              if (TIES) {
                const int st = slot[r];
                slot[r] = slot[r2];
                slot[r2] = st;
              }
            }
          }
        }
      } else {
        const bool upper = (lane & stride) != 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const u64 ok = __shfl_xor_sync(FULL, key[r], stride);
          const int os = TIES ? __shfl_xor_sync(FULL, slot[r], stride) : 0;
          const bool desc = (((r << 5) | lane) & size) == 0;
          // the pair's lower element keeps the first of the two when
          // descending, the other the second
          if (ranks_before<TIES>(ok, os, key[r], slot[r]) == (upper != desc)) {
            key[r] = ok;
            if (TIES) slot[r] = os;
          }
        }
      }
    }
  }
}

// After a barrier that follows the picks: the epilogue and the soundness
// test (thread k tests beam k; a block-wide OR).
__device__ __forceinline__ void finish_query(long long b, const SelectIn& in, const SelectOut& o,
                                             unsigned char* unsound, int n_par, int ncand,
                                             int two_k, int k_out, int eos, float neg_inf,
                                             const float* e_cons, const int* e_slot,
                                             const int* e_tok, const float* e_lp, int* s_cont) {
  select_epilogue(b, two_k, k_out, ncand, eos, neg_inf, e_cons, e_slot, e_tok, e_lp,
                  in.beam_scores + b * n_par, o, s_cont);
  if (unsound != nullptr) {
    const long long row = b * n_par + threadIdx.x;
    const bool bad = (int)threadIdx.x < n_par && in.need[row] != 0 &&
                     __fadd_rn(in.beam_scores[row], in.th_lp[row]) >= e_cons[two_k - 1];
    const int any = __syncthreads_or(bad);
    if (threadIdx.x == 0) unsound[b] = any ? 1 : 0;
  }
}

// One CTA a query, warp k its beam k; R = 1, 2 or 4 slots a lane (ncand <=
// 32 R, 2K <= 64).  The keys equal select_kernel's, so the result does.
// The first 64 of two sorted lists of a warp, element e = 32 r + lane in
// register r of its lane: `key` / `slot` (descending) and the chunk `ck` /
// `cs` (descending).  The better of key[e] and the chunk's (63 - e)-th
// element, over every e, is the union's first 64 as a bitonic sequence;
// half-cleaners at strides 32 (registers) to 1 (shuffles) sort it.
template <bool TIES>
__device__ __forceinline__ void warp_merge_top(u64 (&key)[2], int (&slot)[2], const u64 (&ck)[2],
                                               const int (&cs)[2], int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const u64 rk = __shfl_sync(FULL, ck[1 - r], 31 - lane);
    const int rs = TIES ? __shfl_sync(FULL, cs[1 - r], 31 - lane) : 0;
    if (ranks_before<TIES>(rk, rs, key[r], slot[r])) {
      key[r] = rk;
      if (TIES) slot[r] = rs;
    }
  }
  if (ranks_before<TIES>(key[1], slot[1], key[0], slot[0])) {
    const u64 kt = key[0];
    key[0] = key[1];
    key[1] = kt;
    const int st = slot[0];
    slot[0] = slot[1];
    slot[1] = st;
  }
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const bool upper = (lane & stride) != 0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const u64 ok = __shfl_xor_sync(FULL, key[r], stride);
      const int os = TIES ? __shfl_xor_sync(FULL, slot[r], stride) : 0;
      // the lower place keeps the better of the pair, the upper the other
      if (ranks_before<TIES>(ok, os, key[r], slot[r]) != upper) {
        key[r] = ok;
        if (TIES) slot[r] = os;
      }
    }
  }
}

template <bool TIES, int R>
__global__ void __launch_bounds__(1024)
select_warp_kernel(SelectIn in, SelectOut o, unsigned char* unsound, int n_par, int n_buf, int w,
                   int two_k, int k_out, int eos, int pad, int stop_at_count,
                   int always_allow_eos, int tie_bits, float neg_inf) {
  extern __shared__ unsigned long long smem[];
  const int ncand = n_buf + w + 2;
  const int nc4 = (ncand + 3) & ~3;  // a beam's stride in s_tok / s_lp (16-byte rows)
  const int L = min(two_k, ncand);  // each beam's list
  int* s_tok = (int*)smem;                        // [n_par][nc4]
  float* s_lp = (float*)(s_tok + n_par * nc4);     // [n_par][nc4]
  u64* s_key = (u64*)(s_lp + n_par * nc4);         // [n_par][L]
  int* s_lslot = (int*)(s_key + n_par * L);        // [n_par][L], TIES only
  float* e_cons = (float*)(s_lslot + (TIES ? n_par * L : 0));
  float* e_lp = e_cons + two_k;
  int* e_slot = (int*)(e_lp + two_k);
  int* e_tok = e_slot + two_k;
  int* s_cont = e_tok + two_k;
  const long long b = blockIdx.x;
  const int k = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = b * n_par + k;
  const float bs = in.beam_scores[row];
  int* w_tok = s_tok + k * nc4;
  float* w_lp = s_lp + k * nc4;

  int tok[R];
  float lpv[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = r * 32 + lane;
    tok[r] = INT_MIN;  // padding: later than every slot, so it shadows none
    lpv[r] = 0.0f;
    if (j < ncand) {
      load_slot(in, row, j, n_buf, w, eos, pad, &tok[r], &lpv[r]);
      w_tok[j] = tok[r];
      w_lp[j] = lpv[r];
    }
  }
  __syncwarp();
  const unsigned below = (1u << lane) - 1u;
  u64 key[R];
  int slot[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = r * 32 + lane;
    // the first instance: no lower lane of this register row, and no slot
    // of an earlier row, holds the token
    bool first = (__match_any_sync(FULL, tok[r]) & below) == 0;
    for (int i = 0; i < 32 * r && first; i += 4) {
      const int4 q = *reinterpret_cast<const int4*>(w_tok + i);
      first = q.x != tok[r] && q.y != tok[r] && q.z != tok[r] && q.w != tok[r];
    }
    key[r] = 0ull;  // padding sorts last
    slot[r] = INT_MAX;
    if (j < ncand) {
      const bool allowed = first && slot_allowed(in, row, j, tok[r], n_buf, w, eos, pad,
                                                 stop_at_count, always_allow_eos);
      const int f = k * ncand + j;
      const int tie = TIES ? (k << tie_bits) + min(max(tok[r], 0), (1 << tie_bits) - 1) : f;
      key[r] = pack(__fadd_rn(allowed ? lpv[r] : neg_inf, bs), tie);
      slot[r] = f;
    }
  }
  warp_sort_desc<TIES, R>(key, slot, lane);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int p = r * 32 + lane;
    if (p < L) {
      s_key[k * L + p] = key[r];
      if (TIES) s_lslot[k * L + p] = slot[r];
    }
  }
  __syncthreads();
  // a survivor's rank in the query: its place in its own list plus the keys
  // before it in every other list
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int p = r * 32 + lane;
    if (p < L) {
      const u64 kk = key[r];
      const int sl = TIES ? slot[r] : key_slot(kk);
      int rank = p;
      for (int k2 = 0; k2 < n_par && rank < two_k; ++k2) {
        if (k2 == k) continue;
        const u64* lk = s_key + k2 * L;
        const int* ls = s_lslot + k2 * L;
        int lo = 0, hi = L;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (ranks_before<TIES>(lk[mid], TIES ? ls[mid] : 0, kk, sl)) {
            lo = mid + 1;
          } else {
            hi = mid;
          }
        }
        rank += lo;
      }
      if (rank < two_k) {
        const int j = sl - k * ncand;
        e_cons[rank] = key_value(kk);
        e_slot[rank] = sl;
        e_tok[rank] = w_tok[j];
        e_lp[rank] = w_lp[j];
      }
    }
  }
  __syncthreads();
  finish_query(b, in, o, unsound, n_par, ncand, two_k, k_out, eos, neg_inf, e_cons, e_slot, e_tok,
               e_lp, s_cont);
}

// ---- the wide route and the candidate mode's dedup ----------------------

// A warp's first instances of its beam row's ncand tokens -- each token's
// lowest slot, as _dedup_mask keeps it -- with no scan of earlier slots: one
// bit a slot, bits[j >> 5] bit (j & 31), then __syncwarp; every slot counts
// in the dedup, but only the slots `want` marks (the branches allow them)
// need their bit, the others may read 0.
//
// area[0, ncand) hold the row's tokens and area[ncand, ncand + table) an
// open-addressing table of slots (Fibonacci hash, linear probing).  Each
// slot claims an empty entry by atomicCAS or, finding its token's entry at
// a higher slot, lowers it by atomicMin (at a lower slot it leaves it: a
// token's many copies, PAD's in the window, do not queue on one entry).  An
// entry only ever holds slots of one token, so it ends at that token's
// lowest slot whatever order the lanes run in, and a slot is first where
// its token's entry holds it.  About two probes a slot at the table's load
// of 1/2.  (Electing a register row's lowest lane of a token with
// __match_any_sync to insert alone cost twice the time; a warp-wide bitonic
// sort of (token, slot) pairs cost 1.6-2.3 times as long past 64 slots:
// bench_select_variants.py.)
constexpr unsigned EMPTY_SLOT = 0xffffffffu;

__device__ __forceinline__ unsigned hash_at(int tok, int table) {
  return __umulhi((unsigned)tok * 0x9e3779b1u, (unsigned)table);
}

__device__ void warp_first_instances(unsigned* area, int table, int ncand, unsigned* bits,
                                     const unsigned* want, int lane) {
  const int rows = (ncand + 31) >> 5;
  const int* tok = (const int*)area;
  volatile unsigned* tab = area + ncand;
  for (int i = lane; i < table; i += 32) tab[i] = EMPTY_SLOT;
  __syncwarp();
  for (int j = lane; j < ncand; j += 32) {
    const int t = tok[j];
    unsigned p = hash_at(t, table);
    while (true) {
      unsigned s = tab[p];
      if (s == EMPTY_SLOT) {
        s = atomicCAS((unsigned*)tab + p, EMPTY_SLOT, (unsigned)j);
        if (s == EMPTY_SLOT) break;
      }
      if (tok[s] == t) {
        if (s > (unsigned)j) atomicMin((unsigned*)tab + p, (unsigned)j);
        break;
      }
      if (++p == (unsigned)table) p = 0;
    }
  }
  __syncwarp();
  for (int r = 0; r < rows; ++r) {
    const int j = (r << 5) + lane;
    bool first = false;
    if (j < ncand && ((want[r] >> lane) & 1u)) {  // a slot the branches drop needs no answer
      const int t = tok[j];
      unsigned p = hash_at(t, table), s;
      // every token holds an entry on its probe path, ahead of any empty one
      while (tok[s = tab[p]] != t)
        if (++p == (unsigned)table) p = 0;
      first = s == (unsigned)j;
    }
    const unsigned word = __ballot_sync(FULL, first);
    if (lane == 0) bits[r] = word;
  }
  __syncwarp();
}

// A warp's region of the wide route, in 32-bit words: the keys [2 ncand];
// the dedup's area, the tokens [ncand] and the hash table [table]; and
// WIDE_AUX words at the end for the first-instance and branch bits [64 +
// 64].
constexpr int WIDE_AUX = 128;
constexpr int WIDE_CTA_WARPS = 16;  // the most beams a CTA of the wide route holds

__host__ __device__ inline int wide_region_words(int ncand, int table) {
  const int r = 3 * ncand + table + WIDE_AUX;
  return r + (r & 1);
}

// The wide route's block: the epilogue's picks, every beam's 64 (keys and slots), then a region a warp.
__host__ __device__ inline long long wide_head_bytes(int two_k, int k_out) {
  return (16LL * two_k + 4LL * k_out + 15) & ~15LL;
}

__host__ __device__ inline long long wide_lists_bytes(int n_par) {
  return (12LL * n_par * 64 + 15) & ~15LL;  // 64 keys and slots a beam
}

// the cluster barrier in two halves (a CTA may touch another's shared
// memory once every CTA of the cluster has arrived)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The wide route (kernels/beam_select.py:select_plan; the speculative [15,
// 386] and beam 32 over 4 shards [32, 578]): a cluster of C CTAs a query,
// warp w of CTA c its beam k = c * (blockDim / 32) + w, no barrier before
// the query's stage.  The warp
//   1. reads its beam's slots once (warp_slots), eight register rows of
//      loads in flight: each slot's key as if it were allowed and a first
//      instance, keyed exactly as select_kernel keys it (flat slot f = k *
//      ncand + j; under TIES the (parent, token) tie id, equal keys in slot
//      order), its branch bit, and its token for the dedup;
//   2. finds its first instances (warp_first_instances) and gives every
//      other slot NEG_INF, keeping its tie;
//   3. keeps a running first 64 of its keys in registers, two a lane: each
//      chunk of 64 keys sorted by the warp route's shuffle network
//      (warp_sort_desc) and merged in (warp_merge_top), the same steps
//      whatever the keys, so the beam's list -- the first L = min(2K,
//      ncand) of a full sort in (key desc, slot asc) order -- takes every
//      warp the same time.  (A radix select, 8 bits a pass through a
//      histogram of shared-memory atomics or a bit a pass by ballots, took
//      2-10x longer at [15, 386] and [32, 578], its passes varying from beam
//      to beam, and the cluster waits for its slowest warp.);
//   4. writes its 64 into the first CTA of the cluster (distributed shared
//      memory).
// After one cluster barrier the first CTA merges the lists in pairs, a
// level of a tree at a time (warp_merge_top again: 5 levels at 32 beams),
// and list 0's first 2K are the query's picks in order, for the epilogue
// and the soundness test.  (The warp route's rank stage -- each survivor's
// binary search in every other list -- took half the kernel at [32, 578].)
// Every step reads and writes the warp's own region or registers, and
// every merge keeps the first 64 of (key desc, slot asc), so the result
// equals select_kernel's bit for bit.  C > 1 spreads a query's beams over
// C SMs (one CTA of 32 warps a query kept 32 SMs of 132 busy at beam 32).
template <bool TIES>
__global__ void __launch_bounds__(32 * WIDE_CTA_WARPS)
select_wide_kernel(SelectIn in, SelectOut o, unsigned char* unsound, int n_par, int n_buf, int w,
                   int two_k, int k_out, int eos, int pad, int stop_at_count,
                   int always_allow_eos, int tie_bits, float neg_inf, int table, int region) {
  extern __shared__ unsigned long long smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int c = (int)cluster.block_rank();
  if (C > 1) cluster_arrive_relaxed();  // waited on before the first remote write
  const int ncand = n_buf + w + 2;
  float* e_cons = (float*)smem;
  float* e_lp = e_cons + two_k;
  int* e_slot = (int*)(e_lp + two_k);
  int* e_tok = e_slot + two_k;
  int* s_cont = e_tok + two_k;
  u64* s_key = (u64*)((char*)smem + wide_head_bytes(two_k, k_out));  // [n_par][64]
  int* s_lslot = (int*)(s_key + n_par * 64);                          // [n_par][64]
  unsigned* regions = (unsigned*)((char*)s_key + wide_lists_bytes(n_par));
  const long long b = blockIdx.x / C;
  const int lane = threadIdx.x & 31;
  const int k = c * (int)(blockDim.x >> 5) + (int)(threadIdx.x >> 5);
  const long long row = b * n_par + k;
  unsigned* reg = regions + (size_t)(threadIdx.x >> 5) * region;
  unsigned* aux = reg + region - WIDE_AUX;
  u64* keys = (u64*)reg;
  unsigned* area = reg + 2 * ncand;
  unsigned* abits = aux + 64;  // the branch rule's bits; aux[0, 64): the first instances'
  u64 key[2] = {0ull, 0ull};
  int slot[2] = {INT_MAX, INT_MAX};

  if (k < n_par) {  // the last CTA's spare warps hold no beam
    const float bs = in.beam_scores[row];
    // 1. each slot's key as if it were allowed and a first instance, its
    // branch bit, and the dedup's tokens: the slots read once
    warp_slots(in, row, n_buf, w, eos, pad, stop_at_count, always_allow_eos, lane,
               [&](int r, int j, int tok, float lp, bool ok) {
                 if (j < ncand) {
                   const int f = k * ncand + j;
                   const int tie =
                       TIES ? (k << tie_bits) + min(max(tok, 0), (1 << tie_bits) - 1) : f;
                   keys[j] = pack(__fadd_rn(lp, bs), tie);
                   ((int*)area)[j] = tok;
                 }
                 const unsigned word = __ballot_sync(FULL, ok);
                 if (lane == 0) abits[r] = word;
               });
    __syncwarp();
    warp_first_instances(area, table, ncand, aux, abits, lane);
    // 2. a slot that is not allowed or not first keeps its tie, at NEG_INF
    const u64 dead = pack(__fadd_rn(neg_inf, bs), 0) & 0xffffffff00000000ull;
    for (int j = lane; j < ncand; j += 32) {
      if (((aux[j >> 5] & abits[j >> 5]) >> (j & 31) & 1u) == 0)
        keys[j] = dead | (keys[j] & 0xffffffffull);
    }
    __syncwarp();
    // 3. the beam's list: the first 64 keys sorted, then each next 64
    // sorted and merged in, the first 64 of the two kept; a chunk with no
    // key before the list's L-th is skipped (the list's first L stand)
    const int L = min(two_k, ncand);
    for (int c0 = 0; c0 < ncand; c0 += 64) {
      u64 ck[2];
      int cs[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = c0 + r * 32 + lane;
        ck[r] = j < ncand ? keys[j] : 0ull;  // padding sorts last
        cs[r] = j < ncand ? k * ncand + j : INT_MAX;
      }
      if (c0 > 0) {
        const int r_l = (L - 1) >> 5;
        const u64 lk = __shfl_sync(FULL, r_l ? key[1] : key[0], (L - 1) & 31);
        const int ls = __shfl_sync(FULL, r_l ? slot[1] : slot[0], (L - 1) & 31);
        if (!__any_sync(FULL, ranks_before<TIES>(ck[0], cs[0], lk, ls) ||
                                  ranks_before<TIES>(ck[1], cs[1], lk, ls)))
          continue;
      }
      warp_sort_desc<TIES, 2>(ck, cs, lane);
      if (c0 == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          key[r] = ck[r];
          slot[r] = cs[r];
        }
      } else {
        warp_merge_top<TIES>(key, slot, ck, cs, lane);
      }
    }
  }
  // 4. the lists into the first CTA of the cluster
  if (C > 1) cluster_wait();
  if (k < n_par) {
    u64* dk = C > 1 ? cluster.map_shared_rank(s_key, 0) : s_key;
    int* ds = C > 1 ? cluster.map_shared_rank(s_lslot, 0) : s_lslot;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dk[k * 64 + r * 32 + lane] = key[r];
      ds[k * 64 + r * 32 + lane] = slot[r];
    }
  }
  if (C > 1) {
    cluster.sync();
    if (c != 0) return;
  } else {
    __syncthreads();
  }
  // 5. the query's first 2K: the lists merged in pairs (warp_merge_top), a
  // level of the tree at a time, list j taking list j + stride
  const int warps = (int)(blockDim.x >> 5), wid = (int)(threadIdx.x >> 5);
  for (int stride = 1; stride < n_par; stride <<= 1) {
    for (int j = 2 * stride * wid; j + stride < n_par; j += 2 * stride * warps) {
      u64 bk[2];
      int bsl[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        key[r] = s_key[j * 64 + r * 32 + lane];
        slot[r] = s_lslot[j * 64 + r * 32 + lane];
        bk[r] = s_key[(j + stride) * 64 + r * 32 + lane];
        bsl[r] = s_lslot[(j + stride) * 64 + r * 32 + lane];
      }
      warp_merge_top<TIES>(key, slot, bk, bsl, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        s_key[j * 64 + r * 32 + lane] = key[r];
        s_lslot[j * 64 + r * 32 + lane] = slot[r];
      }
    }
    __syncthreads();
  }
  for (int t = threadIdx.x; t < two_k; t += blockDim.x) {
    const u64 kk = s_key[t];
    const int sl = TIES ? s_lslot[t] : key_slot(kk);
    const int kq = sl / ncand;
    e_cons[t] = key_value(kk);
    e_slot[t] = sl;
    load_slot(in, b * n_par + kq, sl - kq * ncand, n_buf, w, eos, pad, e_tok + t, e_lp + t);
  }
  __syncthreads();
  finish_query(b, in, o, unsound, n_par, ncand, two_k, k_out, eos, neg_inf, e_cons, e_slot, e_tok,
               e_lp, s_cont);
}

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
    const int k = f / ncand;
    load_slot(in, b * n_par + k, f - k * ncand, n_buf, w, eos, pad, &s_tok[f], &s_lp[f]);
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
    const bool allowed = first_instance(s_tok, k * ncand, f) &&
                         slot_allowed(in, row, j, tok, n_buf, w, eos, pad, stop_at_count,
                                      always_allow_eos);
    const float cons = allowed ? s_lp[f] : neg_inf;
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

// The large-n route of select, for queries whose n_par * ncand candidates
// do not fit one CTA's shared memory (beam 32 over a 4-shard union window:
// 18,496 candidates, a 411 KB sort).  Two launches, the same order:
//
// 1. select_beams_kernel, one CTA per beam row: the row's ncand candidates
//    (branches, first-instance dedup), keyed exactly as select_kernel keys
//    them (flat slot f = k * ncand + j), sorted, and its first two_k keys
//    (with their slots under TIES) written out.
// 2. select_finish_kernel, one CTA per query: the n_par * two_k survivors
//    sorted again, the first two_k reloaded by slot, select's epilogue and
//    soundness test.
//
// A query's two_k best candidates hold at most two_k of any one beam, and
// the key order is total (slot breaks every tie), so the survivors contain
// them and the result equals the one-CTA sort bit for bit.
//
// The table route (F2: a speculative round of top_m up to V, where a beam's
// ncand candidates outgrow a CTA) runs step 1 over chunks of `chunk`
// candidates, CTA (row, c) keeping chunk c's top two_k with first
// instances from the table; select_reduce_kernel keeps each beam's top
// two_k of its chunks' (the same argument, a level down); then step 2.
template <bool TIES>
__global__ void select_beams_kernel(SelectIn in, int n_par, int n_buf, int w, int two_k, int n2,
                                    int eos, int pad, int stop_at_count, int always_allow_eos,
                                    int tie_bits, float neg_inf, int chunk, int n_chunks,
                                    const unsigned* table, int vocab, u64* out_keys,
                                    int* out_slots) {
  extern __shared__ unsigned long long smem[];
  const int ncand = n_buf + w + 2;
  u64* keys = smem;
  int* s_slot = (int*)(keys + n2);  // TIES only
  int* s_tok = s_slot + (TIES ? n2 : 0);
  float* s_lp = (float*)(s_tok + chunk);
  const long long row = blockIdx.x / n_chunks;
  const int c = (int)(blockIdx.x % n_chunks);
  const int j0 = c * chunk;
  const int n = min(chunk, ncand - j0);
  const int k = (int)(row % n_par);
  const float bs = in.beam_scores[row];

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    load_slot(in, row, j0 + i, n_buf, w, eos, pad, &s_tok[i], &s_lp[i]);
    if (TIES) s_slot[i] = k * ncand + j0 + i;
  }
  for (int i = n + threadIdx.x; i < n2; i += blockDim.x) {
    keys[i] = 0ull;
    if (TIES) s_slot[i] = 0x7fffffff;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int j = j0 + i, tok = s_tok[i];
    const bool first = table != nullptr ? table_first(table, row, vocab, tok, j)
                                        : first_instance(s_tok, 0, i);
    const bool allowed = first && slot_allowed(in, row, j, tok, n_buf, w, eos, pad,
                                               stop_at_count, always_allow_eos);
    const float cons = allowed ? s_lp[i] : neg_inf;
    const int tie = TIES ? (k << tie_bits) + min(max(tok, 0), (1 << tie_bits) - 1)
                         : k * ncand + j;
    keys[i] = pack(__fadd_rn(cons, bs), tie);
  }
  sort_desc<TIES>(keys, s_slot, n2);
  const long long at = (long long)blockIdx.x * two_k;
  for (int t = threadIdx.x; t < two_k; t += blockDim.x) {
    out_keys[at + t] = t < n2 ? keys[t] : 0ull;
    if (TIES) out_slots[at + t] = t < n2 ? s_slot[t] : 0x7fffffff;
  }
}

// The table route's per-beam reduction: a beam's n_chunks * two_k chunk
// survivors sorted, its first two_k kept.
template <bool TIES>
__global__ void select_reduce_kernel(const u64* in_keys, const int* in_slots, int m, int two_k,
                                     int n2, u64* out_keys, int* out_slots) {
  extern __shared__ unsigned long long smem[];
  u64* keys = smem;
  int* s_slot = (int*)(keys + n2);  // TIES only
  const long long row = blockIdx.x;
  for (int i = threadIdx.x; i < n2; i += blockDim.x) {
    keys[i] = i < m ? in_keys[row * m + i] : 0ull;
    if (TIES) s_slot[i] = i < m ? in_slots[row * m + i] : 0x7fffffff;
  }
  sort_desc<TIES>(keys, s_slot, n2);
  for (int t = threadIdx.x; t < two_k; t += blockDim.x) {
    out_keys[row * two_k + t] = keys[t];
    if (TIES) out_slots[row * two_k + t] = s_slot[t];
  }
}

template <bool TIES>
__global__ void select_finish_kernel(SelectIn in, SelectOut o, unsigned char* unsound,
                                     int n_par, int n_buf, int w, int two_k, int k_out, int n2,
                                     int eos, int pad, float neg_inf, const u64* in_keys,
                                     const int* in_slots) {
  extern __shared__ unsigned long long smem[];
  const int ncand = n_buf + w + 2;
  const int m = n_par * two_k;
  u64* keys = smem;
  int* s_slot = (int*)(keys + n2);  // TIES only
  float* e_cons = (float*)(s_slot + (TIES ? n2 : 0));
  float* e_lp = e_cons + two_k;
  int* e_slot = (int*)(e_lp + two_k);
  int* e_tok = e_slot + two_k;
  int* s_cont = e_tok + two_k;
  const long long b = blockIdx.x;
  const float* bs_row = in.beam_scores + b * n_par;

  for (int i = threadIdx.x; i < n2; i += blockDim.x) {
    keys[i] = i < m ? in_keys[b * m + i] : 0ull;
    if (TIES) s_slot[i] = i < m ? in_slots[b * m + i] : 0x7fffffff;
  }
  sort_desc<TIES>(keys, s_slot, n2);
  for (int t = threadIdx.x; t < two_k; t += blockDim.x) {
    const u64 key = keys[t];
    const int f = TIES ? s_slot[t] : key_slot(key);
    const int k = f / ncand;
    e_cons[t] = key_value(key);
    e_slot[t] = f;
    load_slot(in, b * n_par + k, f - k * ncand, n_buf, w, eos, pad, &e_tok[t], &e_lp[t]);
  }
  __syncthreads();
  select_epilogue(b, two_k, k_out, ncand, eos, neg_inf, e_cons, e_slot, e_tok, e_lp, bs_row, o,
                  s_cont);
  if (unsound != nullptr && threadIdx.x == 0) {
    const float s_star = e_cons[two_k - 1];
    unsigned char bad = 0;
    for (int k = 0; k < n_par; ++k) {
      const long long row = b * n_par + k;
      if (in.need[row] != 0 && __fadd_rn(bs_row[k], in.th_lp[row]) >= s_star) bad = 1;
    }
    unsound[b] = bad;
  }
}

// The candidate mode (_candidates_general :359-367 with _apply_branches and
// _dedup_mask, :1394-1399): each beam row's ncand candidates in slot order
// -- token, constrained log-prob (NEG_INF where the branches or the
// first-instance dedup drop the slot) and log-prob --, selecting nothing.
// Sampling and diverse groups select from them (kernels 20, 21).  A warp a
// row, CAND_WARPS rows a CTA, the slots read once (warp_slots): its region
// holds the log-probs [ncand], the dedup's area (the tokens and a table of
// 2 ncand entries) and the first-instance and branch bits
// (cand_region_words).  A row past SERIAL_MAX candidates takes its
// first instances from the [rows, vocab] table (F2,
// candidates_table_kernel).
constexpr int CAND_WARPS = 4;

// The dedup's area and the bits in a warp's region, and the region's words.
__host__ __device__ inline int cand_area_at(int ncand) { return ncand + (ncand & 1); }

__host__ __device__ inline int cand_bits_at(int ncand, int table) {
  return cand_area_at(ncand) + ncand + table;
}

__host__ __device__ inline int cand_region_words(int ncand, int table) {
  const int r = cand_bits_at(ncand, table) + 2 * ((ncand + 31) / 32);
  return r + (r & 1);
}

__global__ void candidates_kernel(SelectIn in, long long rows, int n_buf, int w, int eos, int pad,
                                  int stop_at_count, int always_allow_eos, float neg_inf,
                                  int table, int region, int* out_tok, float* out_cons,
                                  float* out_lp) {
  extern __shared__ unsigned long long smem[];
  const int ncand = n_buf + w + 2;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * CAND_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;  // a whole warp: the CTA has no barrier
  unsigned* reg = (unsigned*)smem + (size_t)(threadIdx.x >> 5) * region;
  float* s_lp = (float*)reg;
  unsigned* area = reg + cand_area_at(ncand);
  unsigned* bits = reg + cand_bits_at(ncand, table);
  unsigned* abits = bits + ((ncand + 31) >> 5);
  const long long at = row * ncand;
  warp_slots(in, row, n_buf, w, eos, pad, stop_at_count, always_allow_eos, lane,
             [&](int r, int j, int tok, float lp, bool ok) {
               if (j < ncand) {
                 ((int*)area)[j] = tok;
                 s_lp[j] = lp;
                 out_tok[at + j] = tok;
                 out_lp[at + j] = lp;
               }
               const unsigned word = __ballot_sync(FULL, ok);
               if (lane == 0) abits[r] = word;
             });
  __syncwarp();
  warp_first_instances(area, table, ncand, bits, abits, lane);
  for (int j = lane; j < ncand; j += 32)
    out_cons[at + j] = ((bits[j >> 5] & abits[j >> 5]) >> (j & 31) & 1u) ? s_lp[j] : neg_inf;
}

__global__ void candidates_table_kernel(SelectIn in, int n_buf, int w, int eos, int pad,
                                        int stop_at_count, int always_allow_eos, float neg_inf,
                                        const unsigned* table, int vocab, int* out_tok,
                                        float* out_cons, float* out_lp) {
  const int ncand = n_buf + w + 2;
  const long long row = blockIdx.x;
  for (int j = threadIdx.x; j < ncand; j += blockDim.x) {
    int tok;
    float lp;
    load_slot(in, row, j, n_buf, w, eos, pad, &tok, &lp);
    const bool ok = table_first(table, row, vocab, tok, j) &&
                    slot_allowed(in, row, j, tok, n_buf, w, eos, pad, stop_at_count,
                                 always_allow_eos);
    out_tok[row * ncand + j] = tok;
    out_lp[row * ncand + j] = lp;
    out_cons[row * ncand + j] = ok ? lp : neg_inf;
  }
}

// Step 0: kernel 3 already ranked the V-wide rows (flat [B, n_par * V],
// token = slot % V); only the epilogue runs here.  With a token table
// (free generation) the flat axis is [B, n_par * ncand] and slot f of parent
// k is token table[(b * n_par + k) * ncand + f % ncand].
__global__ void select_top_kernel(const float* top_cons, const long long* top_idx, const float* lp,
                                  long long lp_stride, const float* beam_scores,
                                  long long bs_stride, const int* table, SelectOut o, int n_par,
                                  int ncand, int two_k, int k_out, int eos, float neg_inf,
                                  unsigned long long* scratch) {
  extern __shared__ unsigned long long smem[];
  // the picks in shared memory, or (past 48 KB: thousands of beams) in the
  // query's device-memory scratch, which the block's barriers order alike
  const size_t words = (16 * (size_t)two_k + 4 * (size_t)k_out + 7) / 8;
  float* e_cons = (float*)(scratch != nullptr ? scratch + blockIdx.x * words : smem);
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

}  // namespace

namespace {

enum SelectRoute { ROUTE_BLOCK = 0, ROUTE_LARGE = 1, ROUTE_WARP = 2, ROUTE_TABLE = 3, ROUTE_WIDE = 4 };
// the select_top kernel's shared memory without opting in (48 KB: 1,365 beams)
constexpr size_t SELECT_TOP_SMEM = 48 * 1024;

long long warp_smem(int n_par, int ncand, int two_k, int k_out, int ties) {
  const long long L = two_k < ncand ? two_k : ncand;
  const long long nc4 = (ncand + 3) & ~3;
  return 8LL * n_par * nc4 + (ties ? 12LL : 8LL) * n_par * L + 16LL * two_k + 4LL * k_out;
}

// The shapes the wide route launches: at most 32 beams, 2K <= 64, the
// first-instance bits' 2,048 slots, a hash table of at least ncand entries,
// 1-8 CTAs a query of at most WIDE_CTA_WARPS beams each.
bool wide_ok(int n_par, int ncand, int two_k, int table, int splits) {
  return n_par <= 32 && two_k <= 64 && ncand <= 32 * WIDE_AUX / 2 && table >= ncand &&
         splits >= 1 && splits <= 8 && splits <= n_par &&
         (n_par + splits - 1) / splits <= WIDE_CTA_WARPS;
}

// The wide route's block at `splits` CTAs a query.
long long wide_smem(int n_par, int ncand, int two_k, int k_out, int table, int splits) {
  const int per = (n_par + splits - 1) / splits;
  return wide_head_bytes(two_k, k_out) + wide_lists_bytes(n_par) +
         4LL * per * wide_region_words(ncand, table);
}

long long beams_smem(int chunk, int ties) {
  return (ties ? 12LL : 8LL) * pow2_at_least(chunk) + 8LL * chunk;
}

long long finish_smem(int m, int two_k, int k_out, int ties) {
  return (ties ? 12LL : 8LL) * pow2_at_least(m) + 16LL * two_k + 4LL * k_out;
}

// Memset a [rows, vocab] table to 0xff (no token seen).
int clear_table(unsigned* table, long long rows, int vocab, cudaStream_t stream) {
  return (int)cudaMemsetAsync(table, 0xff, (size_t)rows * vocab * sizeof(unsigned), stream);
}

unsigned blocks_of(long long n, int threads) { return (unsigned)((n + threads - 1) / threads); }

}  // namespace

extern "C" {

// Shared memory each mode needs (bytes); the wrapper refuses shapes past
// the card's 227 KB.  The ties mode adds each key's slot.  The merge: a
// chunk of `chunk` candidates a CTA.
long long seal_beam_merge_smem(int chunk, int ties) {
  return (ties ? 12LL : 8LL) * pow2_at_least(chunk) + 18LL * chunk;
}

long long seal_beam_select_smem(int n, int two_k, int k_out, int ties) {
  return (ties ? 12LL : 8LL) * pow2_at_least(n) + 8LL * n + 16LL * two_k + 4LL * k_out;
}

// The large-n route: the larger of its two launches' needs (a beam row's
// ncand candidates; a query's n_par * two_k survivors).
long long seal_beam_select_large_smem(int n_par, int ncand, int two_k, int k_out, int ties) {
  const long long beams = beams_smem(ncand, ties);
  const long long finish = finish_smem(n_par * two_k, two_k, k_out, ties);
  return beams > finish ? beams : finish;
}

// The warp route's block (its tokens and log-probs, the beams' lists, the
// epilogue's 2K picks).
long long seal_beam_select_warp_smem(int n_par, int ncand, int two_k, int k_out, int ties) {
  return warp_smem(n_par, ncand, two_k, k_out, ties);
}

// The wide route at a hash table of `table` entries a beam and `splits`
// CTAs a query; LLONG_MAX where it cannot launch that shape at all.
long long seal_beam_select_wide_smem(int n_par, int ncand, int two_k, int k_out, int table,
                                     int splits) {
  if (!wide_ok(n_par, ncand, two_k, table, splits)) return LLONG_MAX;
  return wide_smem(n_par, ncand, two_k, k_out, table, splits);
}

// The table route: the largest of its chunk, reduce and finish launches.
long long seal_beam_select_table_smem(int n_par, int chunk, int n_chunks, int two_k, int k_out,
                                      int ties) {
  long long most = beams_smem(chunk, ties);
  const long long reduce = (ties ? 12LL : 8LL) * pow2_at_least(n_chunks * two_k);
  const long long finish = finish_smem(n_par * two_k, two_k, k_out, ties);
  if (reduce > most) most = reduce;
  return finish > most ? finish : most;
}

// One pass of the merge over [rows, width] candidates: the first pass
// reads the round's buffer, LM top and slab (in_tok null; width = n_buf +
// n_top + n_slab), a later one the previous pass's survivors.  The last
// pass (one chunk a row) writes out_tok / out_lp / out_ok; the others
// write survivors with their slots.
int seal_beam_merge(const int* buf_tok, const float* buf_lp,
                          const unsigned char* buf_valid, const int* top_tok,
                          const float* top_lp, const unsigned char* top_ok, long long top_stride,
                          long long top_ok_stride, const int* slab_tok, const float* slab_lp,
                          const unsigned char* slab_ok, int n_top, int n_slab, const int* in_tok,
                          const float* in_lp, const unsigned char* in_ok, const int* in_slot,
                          long long rows, int width, int chunk, int n_buf, int vocab, int ties,
                          float neg_inf, int* out_tok, float* out_lp, unsigned char* out_ok,
                          int* out_slot, void* stream) {
  if (rows <= 0) return (int)cudaGetLastError();
  if (chunk < n_buf || width < n_buf) return (int)cudaErrorInvalidValue;
  const MergeIn src{buf_tok, buf_lp, buf_valid, top_tok, top_lp, top_ok, top_stride,
                    top_ok_stride, slab_tok, slab_lp, slab_ok, n_buf, n_top, n_slab};
  const int n_chunks = (width + chunk - 1) / chunk;
  const int n2 = pow2_at_least(chunk);
  const size_t smem = (size_t)seal_beam_merge_smem(chunk, ties);
  const auto kernel = ties ? merge_kernel<true> : merge_kernel<false>;
  const int rc = set_smem(kernel, smem);
  if (rc) return rc;
  const int threads = n2 >= 1024 ? 512 : 256;
  kernel<<<(unsigned)(rows * n_chunks), threads, smem, (cudaStream_t)stream>>>(
      src, in_tok, in_lp, in_ok, in_slot, width, chunk, n_chunks, n2, n_buf, vocab, neg_inf,
      out_tok, out_lp, out_ok, out_slot);
  return (int)cudaGetLastError();
}

// The merge past shared memory (buffers past 4,096, or 2,048 under ties):
// `table` [rows, vocab] and `keys` [rows, n2] (n2 = pow2(n) >= 8192) are
// the caller's scratch.
int seal_beam_merge_table(const int* buf_tok, const float* buf_lp, const unsigned char* buf_valid,
                          const int* top_tok, const float* top_lp, const unsigned char* top_ok,
                          long long top_stride, long long top_ok_stride, const int* slab_tok,
                          const float* slab_lp, const unsigned char* slab_ok, int n_top,
                          int n_slab, long long rows, int n_buf, int vocab, int ties,
                          float neg_inf, unsigned* table, u64* keys, int n2, int* out_tok,
                          float* out_lp, unsigned char* out_ok, void* stream) {
  if (rows <= 0) return (int)cudaGetLastError();
  const int n = n_buf + n_top + n_slab;
  if (n2 < n || n2 < GTILE || (long long)vocab + n > 0x7fffff) return (int)cudaErrorInvalidValue;
  const MergeIn src{buf_tok, buf_lp, buf_valid, top_tok, top_lp, top_ok, top_stride,
                    top_ok_stride, slab_tok, slab_lp, slab_ok, n_buf, n_top, n_slab};
  const cudaStream_t st = (cudaStream_t)stream;
  int rc = clear_table(table, rows, vocab, st);
  if (rc) return rc;
  merge_table_kernel<<<blocks_of(rows * n, 256), 256, 0, st>>>(src, rows, n, vocab, neg_inf,
                                                               table);
  const auto keys_kernel = ties ? merge_keys_kernel<true> : merge_keys_kernel<false>;
  keys_kernel<<<blocks_of(rows * n2, 256), 256, 0, st>>>(src, rows, n, n2, vocab, neg_inf, table,
                                                         keys);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  return global_sort(keys, rows, n2, n_buf,
                     MergeOut{src, table, vocab, n_buf, ties, neg_inf, out_tok, out_lp, out_ok},
                     st);
}

// The selection on one of five routes (kernels/beam_select.py:select_plan):
// ROUTE_WARP (select_warp_kernel), ROUTE_WIDE (select_wide_kernel; `chunk`
// is its hash table's entries a beam, `splits` its CTAs a query, a
// cluster), ROUTE_BLOCK
// (select_kernel), ROUTE_LARGE
// (select_beams_kernel + select_finish_kernel; scratch holds [n_queries *
// n_par, two_k] keys, and slots under the ties mode) and ROUTE_TABLE (the
// table [n_queries * n_par, vocab] memset and filled, select_beams_kernel
// over chunks of `chunk` candidates into scratch [rows * n_chunks, two_k],
// select_reduce_kernel into the [rows, two_k] after it where n_chunks > 1,
// select_finish_kernel).
int seal_beam_select(const int* buf_tok, const float* buf_lp, const unsigned char* buf_valid,
                     const int* win_tok, const unsigned char* win_valid, const float* win_lp,
                     const unsigned char* eos_ok, long long eos_ok_stride, const float* lp,
                     long long lp_stride, const int* prev_count, const unsigned char* finished,
                     const float* beam_scores, const unsigned char* need, const float* th_lp,
                     long long n_queries, int n_par, int n_buf, int w, int k_out, int eos,
                     int pad, int stop_at_count, int always_allow_eos, int tie_bits,
                     int keep_invalid, float neg_inf, int route, int vocab, int chunk,
                     int splits, int* top_tok, int* top_parent, float* top_uncons, unsigned char* finite,
                     int* sel_tok, int* sel_parent, float* sel_uncons, unsigned char* sel_finite,
                     float* top_cons, unsigned char* unsound, u64* scratch_keys,
                     int* scratch_slots, unsigned* table, void* stream) {
  if (n_queries <= 0) return (int)cudaGetLastError();
  const SelectIn in{buf_tok, buf_lp,     buf_valid,  win_tok,  win_valid, win_lp,
                    eos_ok,  eos_ok_stride, lp,      lp_stride, prev_count, finished,
                    beam_scores, need,  th_lp,  keep_invalid};
  const SelectOut o{top_tok, top_parent, top_uncons, finite, sel_tok,
                    sel_parent, sel_uncons, sel_finite, top_cons};
  const cudaStream_t st = (cudaStream_t)stream;
  const int two_k = 2 * k_out;
  const int ncand = n_buf + w + 2;
  const int ties = tie_bits > 0;
  const long long rows = n_queries * n_par;
  int rc = 0;
  if (route == ROUTE_WARP) {
    if (n_par > 32 || ncand > 128 || two_k > 64) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)warp_smem(n_par, ncand, two_k, k_out, ties);
    const int regs = ncand <= 32 ? 1 : (ncand <= 64 ? 2 : 4);
    const auto kernel =
        ties ? (regs == 1 ? select_warp_kernel<true, 1>
                          : (regs == 2 ? select_warp_kernel<true, 2> : select_warp_kernel<true, 4>))
             : (regs == 1 ? select_warp_kernel<false, 1>
                          : (regs == 2 ? select_warp_kernel<false, 2>
                                       : select_warp_kernel<false, 4>));
    rc = set_smem(kernel, smem);
    if (rc) return rc;
    kernel<<<(unsigned)n_queries, 32 * n_par, smem, st>>>(
        in, o, unsound, n_par, n_buf, w, two_k, k_out, eos, pad, stop_at_count,
        always_allow_eos, tie_bits, neg_inf);
    return (int)cudaGetLastError();
  }
  if (route == ROUTE_WIDE) {
    const int table = chunk;
    if (!wide_ok(n_par, ncand, two_k, table, splits)) return (int)cudaErrorInvalidValue;
    const int per = (n_par + splits - 1) / splits;
    const int region = wide_region_words(ncand, table);
    const size_t smem = (size_t)wide_smem(n_par, ncand, two_k, k_out, table, splits);
    const auto kernel = ties ? select_wide_kernel<true> : select_wide_kernel<false>;
    rc = set_smem(kernel, smem);
    if (rc) return rc;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(n_queries * splits));
    cfg.blockDim = dim3(32 * per);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)splits;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, in, o, unsound, n_par, n_buf, w, two_k,
                                         k_out, eos, pad, stop_at_count, always_allow_eos,
                                         tie_bits, neg_inf, table, region);
    if (err == cudaSuccess) err = cudaGetLastError();
    return (int)err;
  }
  if (route == ROUTE_BLOCK) {
    const int n = n_par * ncand;
    const int n2 = pow2_at_least(n);
    const size_t smem = (size_t)seal_beam_select_smem(n, two_k, k_out, ties);
    const auto kernel = ties ? select_kernel<true> : select_kernel<false>;
    rc = set_smem(kernel, smem);
    if (rc) return rc;
    kernel<<<(unsigned)n_queries, n2 >= 2048 ? 1024 : 256, smem, st>>>(
        in, o, unsound, n_par, n_buf, w, two_k, k_out, n2, eos, pad, stop_at_count,
        always_allow_eos, tie_bits, neg_inf);
    return (int)cudaGetLastError();
  }
  if (route != ROUTE_LARGE && route != ROUTE_TABLE) return (int)cudaErrorInvalidValue;
  // the per-beam stage: one chunk a beam on the large route
  if (route == ROUTE_LARGE) chunk = ncand;
  const int n_chunks = (ncand + chunk - 1) / chunk;
  if (route == ROUTE_TABLE) {
    rc = clear_table(table, rows, vocab, st);
    if (rc) return rc;
    select_table_kernel<<<blocks_of(rows * ncand, 256), 256, 0, st>>>(in, rows, n_buf, w, eos,
                                                                      pad, vocab, table);
  }
  const int n2b = pow2_at_least(chunk);
  const size_t smem_b = (size_t)beams_smem(chunk, ties);
  const auto beams = ties ? select_beams_kernel<true> : select_beams_kernel<false>;
  rc = set_smem(beams, smem_b);
  if (rc) return rc;
  beams<<<(unsigned)(rows * n_chunks), n2b >= 1024 ? 512 : 256, smem_b, st>>>(
      in, n_par, n_buf, w, two_k, n2b, eos, pad, stop_at_count, always_allow_eos, tie_bits,
      neg_inf, chunk, n_chunks, route == ROUTE_TABLE ? table : nullptr, vocab, scratch_keys,
      scratch_slots);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const u64* keys = scratch_keys;
  const int* slots = scratch_slots;
  if (n_chunks > 1) {
    const long long off = rows * n_chunks * two_k;
    const int m = n_chunks * two_k;
    const int n2r = pow2_at_least(m);
    const size_t smem_r = (size_t)((ties ? 12LL : 8LL) * n2r);
    const auto reduce = ties ? select_reduce_kernel<true> : select_reduce_kernel<false>;
    rc = set_smem(reduce, smem_r);
    if (rc) return rc;
    reduce<<<(unsigned)rows, n2r >= 1024 ? 512 : 256, smem_r, st>>>(
        scratch_keys, scratch_slots, m, two_k, n2r, scratch_keys + off,
        ties ? scratch_slots + off : nullptr);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
    keys = scratch_keys + off;
    slots = ties ? scratch_slots + off : nullptr;
  }
  const int n2f = pow2_at_least(n_par * two_k);
  const size_t smem_f = (size_t)finish_smem(n_par * two_k, two_k, k_out, ties);
  const auto finish = ties ? select_finish_kernel<true> : select_finish_kernel<false>;
  rc = set_smem(finish, smem_f);
  if (rc) return rc;
  finish<<<(unsigned)n_queries, n2f >= 2048 ? 1024 : 256, smem_f, st>>>(
      in, o, unsound, n_par, n_buf, w, two_k, k_out, n2f, eos, pad, neg_inf, keys, slots);
  return (int)cudaGetLastError();
}

// The candidate mode: with `table` ([rows, vocab] scratch) the first
// instances come from it (a row past SERIAL_MAX candidates), else from a
// hash table in a warp's own region.
int seal_beam_candidates(const int* buf_tok, const float* buf_lp, const unsigned char* buf_valid,
                         const int* win_tok, const unsigned char* win_valid, const float* win_lp,
                         const unsigned char* eos_ok, long long eos_ok_stride, const float* lp,
                         long long lp_stride, const int* prev_count,
                         const unsigned char* finished, long long rows, int n_buf, int w, int eos,
                         int pad, int stop_at_count, int always_allow_eos, int keep_invalid,
                         float neg_inf, unsigned* table, int vocab, int* out_tok,
                         float* out_cons, float* out_lp, void* stream) {
  if (rows <= 0) return (int)cudaGetLastError();
  const SelectIn in{buf_tok, buf_lp,     buf_valid,  win_tok,  win_valid, win_lp,
                    eos_ok,  eos_ok_stride, lp,      lp_stride, prev_count, finished,
                    nullptr, nullptr,   nullptr, keep_invalid};
  const cudaStream_t st = (cudaStream_t)stream;
  const int ncand = n_buf + w + 2;
  if (table != nullptr) {
    int rc = clear_table(table, rows, vocab, st);
    if (rc) return rc;
    select_table_kernel<<<blocks_of(rows * ncand, 256), 256, 0, st>>>(in, rows, n_buf, w, eos,
                                                                      pad, vocab, table);
    candidates_table_kernel<<<(unsigned)rows, 128, 0, st>>>(
        in, n_buf, w, eos, pad, stop_at_count, always_allow_eos, neg_inf, table, vocab, out_tok,
        out_cons, out_lp);
    return (int)cudaGetLastError();
  }
  const int slots = 2 * ncand;
  const int region = cand_region_words(ncand, slots);
  const size_t smem = 4 * (size_t)CAND_WARPS * region;
  const int rc = set_smem(candidates_kernel, smem);
  if (rc) return rc;
  candidates_kernel<<<(unsigned)((rows + CAND_WARPS - 1) / CAND_WARPS), 32 * CAND_WARPS, smem, st>>>(
      in, rows, n_buf, w, eos, pad, stop_at_count, always_allow_eos, neg_inf, slots, region,
      out_tok, out_cons, out_lp);
  return (int)cudaGetLastError();
}

// The selection after kernel 3's top 2K (step 0, the dense step, free
// generation): the picks in 16 * 2K + 4 * K bytes of shared memory, or
// past SELECT_TOP_SMEM in `scratch` (that many bytes a query, 8-byte words;
// the wrapper allocates it).
int seal_beam_select_top(const float* top_cons_in, const long long* top_idx, const float* lp,
                         long long lp_stride, const float* beam_scores, long long bs_stride,
                         const int* table, long long n_queries, int n_par, int ncand, int k_out,
                         int eos,
                         float neg_inf, int* top_tok, int* top_parent, float* top_uncons,
                         unsigned char* finite, int* sel_tok, int* sel_parent, float* sel_uncons,
                         unsigned char* sel_finite, float* top_cons,
                         unsigned long long* scratch, void* stream) {
  if (n_queries <= 0) return (int)cudaGetLastError();
  const SelectOut o{top_tok, top_parent, top_uncons, finite, sel_tok,
                    sel_parent, sel_uncons, sel_finite, top_cons};
  const int two_k = 2 * k_out;
  const size_t smem = 16 * (size_t)two_k + 4 * (size_t)k_out;
  if (smem > SELECT_TOP_SMEM && scratch == nullptr) return (int)cudaErrorInvalidValue;
  select_top_kernel<<<(unsigned)n_queries, 64, scratch != nullptr ? 0 : smem,
                      (cudaStream_t)stream>>>(top_cons_in, top_idx, lp, lp_stride, beam_scores,
                                              bs_stride, table, o, n_par, ncand, two_k, k_out, eos,
                                              neg_inf, scratch);
  return (int)cudaGetLastError();
}

}  // extern "C"
