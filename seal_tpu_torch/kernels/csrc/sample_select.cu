// Kernel 20: constrained sampling's draw, one Gumbel-max per sampler chain.
//
// Replaces seal_tpu/decoding/constrained.py:_select_sample (:1092-1122) with
// its jax.random.gumbel noise, and dispatch_select's EOS slot (:1270-1282).
// Per chain (a row of [B*K, N] candidates): finite = cons > NEG_INF/4; the
// slot of the largest cons + g over the finite slots, ties to the lower
// slot (jnp.argmax); a chain with no finite slot takes EOS at the log-prob
// of the first slot holding EOS (slot 0 if none).  The drawn score is that
// log-prob plus the chain's score, one f32 add; the history is 2K slots,
// the K draws and K PAD slots at NEG_INF.
//
// Noise: counter-based, with no state between calls.  Philox4x32-10
// (Random123's round and key schedule) with key (seed mod 2^32, step) and
// counter (column / 4, row_offset + row, 0, 0) gives the 32-bit word w of
// each column (word column % 4); row_offset is the global row of the call's
// first row (a data-parallel rank decodes rows past the earlier ranks', and
// draws what one process draws for the whole batch); u = ((w >> 9) + 0.5) * 2^-23 lies strictly inside
// (0, 1) and is exact in f32, and g = -logf(-logf(u)).  (Twenty-four bits,
// (w >> 8) + 0.5, would need 25 and round to 1.0 at the top.)  The plain
// version computes the same words in int64 torch arithmetic, bit for bit.
//
// Columns come three ways (a `Cols` policy): a candidate list with its
// token table (8c's candidates, free generation's top-top_m); V-wide rows
// with token = column and an optional corpus mask read four bytes a quad
// (step 0); and the exact_mask steps' count masks (a bit a token, kernel
// 15's or 16's mask mode), read as kernel 17's branches
// (dense_branches.cuh) with cons = lp where a token is allowed, else
// NEG_INF, at zero beam scores: kernel 17's streaming pass and its
// [B, K * V] write are not launched.  Flat indices are 64-bit.
//
// Bound on the card: bytes.  At step 0, [480, 50265] f32 log-probs are read
// once (96.5 MB; 0.0288 ms at 3.35 TB/s); a count-reading step reads the
// count mask once (3.0 MB, a word a warp's quad of 4 tokens a lane) and
// the allowed tokens' log-probs; on flat
// rows, where every quad can still lead, its Philox calls (ten rounds of
// two 32-bit products a quad) cost more than the bytes.  The parent
// kernel (one 256-thread CTA a row, a Philox call and two logf a
// column, one column's loads in flight a thread) was bound by its
// instructions and its load latency instead.  Design: a thread takes a
// quad of four columns (one Philox call) at a time, U quads a round, with
// 16-byte loads (two where odd rows leave a quad unaligned), the next
// round's values and the round after's mask or count reads in flight
// while it draws; a quad with no allowed column reads nothing more and
// draws nothing.  A column whose cons plus the bound of its word's bucket
// (the word's top byte: 256 bounds a CTA) cannot reach the best so far
// needs no logf: of a row's thousands of columns only those that can still
// lead pay for a Gumbel value.  (A quad-wide test, the largest cons plus
// the largest Gumbel value the generator gives, saved no Philox call on
// the bench's rows and cost time: it went.)  On count vectors, where a
// quarter of the quads hold an allowed token at a step's ~7%, the draw
// runs as a warp on two lists in shared memory (draw_quads: a Philox call
// a lane, then two logf a lane), so that no lane idles while another pays;
// on dense rows, where every quad needs its Philox call, each lane draws
// its own (draw_lane).  The draw is exact: every column left out is
// strictly below a value another column reached, or ties it from a higher
// slot, and every other one is drawn as the plain version draws it.
// Routes (kernels/sample_select.py:plan): a list row of up to WARP_MAX
// columns is one warp (two rows a CTA); a wider row is one CTA of 256
// threads, or a cluster of 2-8 where rows are few, whose
// (best, slot, first EOS slot) are reduced through the first CTA's shared
// memory.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "dense_branches.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WARP_THREADS = 64;  // the warp route: two rows a CTA, spread over the SMs
// the block route: a row (slice) a CTA of 256 threads, four CTAs an SM (64
// registers a thread), so that 480 rows take one wave
constexpr int BLOCK_THREADS = 256;
constexpr int U = 2;  // quads a thread draws a round of the lists (three rounds of loads in flight)
constexpr int U_LANE = 2;  // quads a lane draws a round on its own
constexpr int MAX_SPLITS = 8;
constexpr unsigned NEG_INF_BITS = 0xff800000u;  // -inf
constexpr unsigned FULL = 0xffffffffu;

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

// A chain's running draw: the best perturbed score and its slot (INT_MAX:
// no finite slot yet), and the first slot holding EOS (list rows)
struct Draw {
  float best;
  int j, eos_j;
};

__device__ __forceinline__ void better(Draw& d, float v, int j) {
  if (v > d.best || (v == d.best && j < d.j)) {
    d.best = v;
    d.j = j;
  }
}

__device__ __forceinline__ void merge(Draw& d, const Draw& o) {
  better(d, o.best, o.j);
  d.eos_j = min(d.eos_j, o.eos_j);
}

__device__ __forceinline__ Draw warp_reduce(Draw d) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Draw o;
    o.best = __shfl_xor_sync(0xffffffffu, d.best, off);
    o.j = __shfl_xor_sync(0xffffffffu, d.j, off);
    o.eos_j = __shfl_xor_sync(0xffffffffu, d.eos_j, off);
    merge(d, o);
  }
  return d;
}

// A quad's four 4-byte values row[j0 .. j0 + 3] (j0 a multiple of 4, the
// quad inside the row of n) by 16-byte loads: the aligned vector holding
// row[j0] and, where the row is not 16-byte aligned (odd widths: h, the
// row's start mod 4, is one value for the whole row), the next one.  The
// row's last quads, where the next vector would pass the row, read one
// value at a time.
template <class T4, class T>
__device__ __forceinline__ T4 load_quad(const T* row, int j0, int n) {
  const int h = (int)(((unsigned long long)row >> 2) & 3);
  const T4* a = (const T4*)(row + j0 - h);
  if (h == 0 && j0 + 4 <= n) return __ldg(a);
  if (h != 0 && j0 - h + 8 <= n) {
    const T4 x = __ldg(a), y = __ldg(a + 1);
    return h == 1 ? T4{x.y, x.z, x.w, y.x} : h == 2 ? T4{x.z, x.w, y.x, y.y}
                                                    : T4{x.w, y.x, y.y, y.z};
  }
  T v[4] = {0, 0, 0, 0};
  for (int t = 0; t < 4 && j0 + t < n; ++t) v[t] = __ldg(row + j0 + t);
  return T4{v[0], v[1], v[2], v[3]};
}

__device__ __forceinline__ unsigned in_row(int j0, int n) {
  return n - j0 >= 4 ? 0xfu : (1u << (n - j0)) - 1u;
}

// Column policies.  `allow(R, q, d)` reads what decides which of quad q's
// columns can hold a candidate (the token table, the corpus mask, the
// count mask) and returns them as bits; `values(R, q)` reads the quad's cons.
// The draw issues every `allow` of a round's quads, then the values of
// those with a candidate, then draws: each thread keeps U quads of 16-byte
// loads in flight.

// (a) a candidate list: cons and tokens [rows, N], N columns; every slot is
// a candidate, and the first EOS slot is kept
struct ListCols {
  static constexpr bool kLists = false;  // see draw_lane
  // a short list pays less for its Gumbel values than for the bounds' table
  static constexpr bool kBound = false;
  const float* cons;
  const int* tokens;
  int N, eos;
  struct Row {
    const float* c;
    const int* t;
  };
  __device__ __forceinline__ Row row(long long r) const { return {cons + r * N, tokens + r * N}; }
  __device__ __forceinline__ unsigned allow(const Row& R, int q, Draw& d) const {
    const int4 tk = load_quad<int4>(R.t, 4 * q, N);
    const int tt[4] = {tk.x, tk.y, tk.z, tk.w};
    const unsigned a = in_row(4 * q, N);
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (((a >> t) & 1u) && tt[t] == eos && 4 * q + t < d.eos_j) d.eos_j = 4 * q + t;
    return a;
  }
  __device__ __forceinline__ float4 values(const Row& R, int q) const {
    return load_quad<float4>(R.c, 4 * q, N);
  }
  __device__ __forceinline__ int token(const Row& R, int j) const { return R.t[j]; }
};

// (b) V-wide rows, token = column, an optional corpus mask [N] (4-byte
// aligned: a quad's four bytes in one load)
struct WideCols {
  static constexpr bool kLists = false;
  static constexpr bool kBound = true;
  const float* cons;
  const unsigned char* mask;
  int N;
  using Row = const float*;
  __device__ __forceinline__ Row row(long long r) const { return cons + r * N; }
  __device__ __forceinline__ unsigned allow(const Row&, int q, Draw&) const {
    const int j0 = 4 * q;
    const unsigned in = in_row(j0, N);
    if (mask == nullptr) return in;
    if (j0 + 4 <= N) {
      const uchar4 m = __ldg((const uchar4*)mask + q);
      return (m.x != 0) | (m.y != 0) << 1 | (m.z != 0) << 2 | (m.w != 0) << 3;
    }
    unsigned a = 0;
    for (int t = 0; j0 + t < N; ++t) a |= (unsigned)(__ldg(mask + j0 + t) != 0) << t;
    return a;
  }
  __device__ __forceinline__ float4 values(const Row& R, int q) const {
    return load_quad<float4>(R, 4 * q, N);
  }
  __device__ __forceinline__ int token(const Row&, int j) const { return j; }
};

// (c) the exact_mask step's count masks [rows, W] (kernels/count_mask.py,
// W = 4 * ceil(V / 128): a quad's 4 bits lie in one word) and log-probs
// (row stride lp_stride): kernel 17's branches, cons = lp where allowed
struct CountCols {
  static constexpr bool kLists = true;  // see draw_quads
  static constexpr bool kBound = true;
  const unsigned* mask;
  const float* lp;
  long long lp_stride;
  Branches br;
  int N, W;
  struct Row {
    const unsigned* m;
    const float* x;
    BeamState s;
  };
  __device__ __forceinline__ Row row(long long r) const {
    return {mask + r * W, lp + r * lp_stride, br.state(r)};
  }
  __device__ __forceinline__ unsigned allow(const Row& R, int q, Draw&) const {
    const int j0 = 4 * q;
    // a stop-forced or finished beam allows one token: no mask word is read
    const unsigned bits = R.s.by_counts ? (__ldg(R.m + (j0 >> 5)) >> (j0 & 31)) & 15u : 0u;
    const unsigned in = in_row(j0, N);
    unsigned a = 0;
#pragma unroll
    for (int t = 0; t < 4; ++t)
      a |= (unsigned)(((in >> t) & 1u) && br.allowed((int)((bits >> t) & 1u), j0 + t, R.s)) << t;
    return a;
  }
  __device__ __forceinline__ float4 values(const Row& R, int q) const {
    return load_quad<float4>(R.x, 4 * q, N);
  }
  __device__ __forceinline__ int token(const Row&, int j) const { return j; }
};

// A warp's work lists of one round, in shared memory: the quads whose
// Philox words are needed (their cons and finite columns), then the
// columns whose Gumbel values are.
struct WarpLists {
  int q[32 * U];
  unsigned fin[32 * U];
  float4 c[32 * U];
  float cc[128];
  unsigned cw[128];
  int cj[128];
};

// Each thread's share of a row: quads q0, q0 + step, ... below q1, U at a
// time (the lanes of a warp hold consecutive quads), into d.  The next
// round's values and the `allow` reads of the round after it are issued
// before this round draws.  The draw then works as a warp on lists, so
// that no lane idles while another pays for a rare column: the quads with
// a finite column go to a list, and each lane takes an entry's Philox
// call; of their columns, those whose cons plus the bound of their word's
// bucket (gub[w >> 24]: no word of the bucket gives a larger g) reaches
// the warp's best so far (each lane's best, reduced) go to a second list,
// and each lane takes an entry's two logf.  Every column left out is
// strictly below a value some column reached, so it cannot win or tie;
// every other one is drawn exactly.  A lane's best may then hold another
// lane's column: the reductions order equal values by slot.
template <class Cols>
__device__ __forceinline__ void draw_quads(const Cols& cols, const typename Cols::Row& R,
                                           long long row, int q0, int q1, int step,
                                           unsigned seed, unsigned kstep, float fin_cut,
                                           const float* gub, WarpLists& wl, Draw& d) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  // three rounds in flight: this round's values (loaded a round ago), the
  // next round's values and the round after's `allow` reads
  const auto allow_at = [&](int q) { return q < q1 ? cols.allow(R, q, d) : 0u; };
  unsigned al_next[U], al_far[U];
  float4 v_next[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    al_next[u] = allow_at(q0 + u * step);
    al_far[u] = allow_at(q0 + (U + u) * step);
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
    v_next[u] = al_next[u] ? cols.values(R, q0 + u * step) : make_float4(0.f, 0.f, 0.f, 0.f);
  // rounds counted from the warp's first lane, so that every lane of the
  // warp takes every round; a lane's quads past q1 are empty
  for (int lead = q0 - lane; lead < q1; lead += U * step) {
    const int base = lead + lane;
    unsigned al[U];
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      al[u] = al_next[u];
      v[u] = v_next[u];
      al_next[u] = al_far[u];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = base + (U + u) * step;
      v_next[u] = al_next[u] ? cols.values(R, q) : make_float4(0.f, 0.f, 0.f, 0.f);
      al_far[u] = allow_at(base + (2 * U + u) * step);
    }
    float best = d.best;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) best = fmaxf(best, __shfl_xor_sync(FULL, best, off));
    // the quads that can still reach the best
    int n = 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float c[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
      unsigned fin = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) fin |= (unsigned)(((al[u] >> t) & 1u) && c[t] > fin_cut) << t;
      const bool need = fin != 0;
      const unsigned ball = __ballot_sync(FULL, need);
      if (need) {
        const int at = n + __popc(ball & below);
        wl.q[at] = base + u * step;
        wl.fin[at] = fin;
        wl.c[at] = v[u];
      }
      n += __popc(ball);
    }
    __syncwarp();
    for (int i0 = 0; i0 < n; i0 += 32) {
      // an entry's Philox words; its columns that can still reach the best
      const int i = i0 + lane;
      unsigned ev = 0, wd[4] = {0, 0, 0, 0};
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      int q = 0;
      if (i < n) {
        q = wl.q[i];
        const unsigned fin = wl.fin[i];
        const float4 cv = wl.c[i];
        c[0] = cv.x, c[1] = cv.y, c[2] = cv.z, c[3] = cv.w;
        const uint4 w = philox4x32_10(make_uint4((unsigned)q, (unsigned)row, 0u, 0u), seed, kstep);
        wd[0] = w.x, wd[1] = w.y, wd[2] = w.z, wd[3] = w.w;
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (((fin >> t) & 1u) && (!Cols::kBound || __fadd_rn(c[t], gub[wd[t] >> 24]) >= best))
            ev |= 1u << t;
      }
      int m = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const bool e = (ev >> t) & 1u;
        const unsigned ball = __ballot_sync(FULL, e);
        if (e) {
          const int at = m + __popc(ball & below);
          wl.cc[at] = c[t];
          wl.cw[at] = wd[t];
          wl.cj[at] = 4 * q + t;
        }
        m += __popc(ball);
      }
      __syncwarp();
      for (int k = lane; k < m; k += 32)
        better(d, __fadd_rn(wl.cc[k], gumbel_of(wl.cw[k])), wl.cj[k]);
      __syncwarp();
    }
  }
}

// The same draw a lane at a time, for dense rows (V-wide under the corpus
// mask, candidate lists), where nearly every quad needs its Philox call and
// the lists would only add their traffic: a lane draws its own quads, U_LANE
// at a time (their loads issued together), so its best holds its own
// columns, in rising slots, and a column that can only tie it loses.
template <class Cols>
__device__ __forceinline__ void draw_lane(const Cols& cols, const typename Cols::Row& R,
                                          long long row, int q0, int q1, int step,
                                          unsigned seed, unsigned kstep, float fin_cut,
                                          const float* gub, Draw& d) {
  for (int base = q0; base < q1; base += U_LANE * step) {
    unsigned al[U_LANE];
    float4 v[U_LANE];
#pragma unroll
    for (int u = 0; u < U_LANE; ++u) {
      const int q = base + u * step;
      al[u] = q < q1 ? cols.allow(R, q, d) : 0u;
    }
#pragma unroll
    for (int u = 0; u < U_LANE; ++u)
      v[u] = al[u] ? cols.values(R, base + u * step) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int u = 0; u < U_LANE; ++u) {
      const int q = base + u * step;
      const float c[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
      unsigned fin = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) fin |= (unsigned)(((al[u] >> t) & 1u) && c[t] > fin_cut) << t;
      if (!fin) continue;
      const uint4 w = philox4x32_10(make_uint4((unsigned)q, (unsigned)row, 0u, 0u), seed, kstep);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const unsigned wt = word_of(w, t);
        if (((fin >> t) & 1u) && (!Cols::kBound || __fadd_rn(c[t], gub[wt >> 24]) > d.best))
          better(d, __fadd_rn(c[t], gumbel_of(wt)), 4 * q + t);
      }
    }
  }
}

// gub[b] for the 256 buckets of a word's top byte: the largest g of the
// bucket (at its top word), plus a margin far above logf's ulps
__device__ __forceinline__ void fill_bounds(float* gub) {
  for (int b = threadIdx.x; b < 256; b += blockDim.x)
    gub[b] = gumbel_of(((unsigned)(b + 1) << 24) - 1u) + 1e-3f;
  __syncthreads();
}

struct Common {
  float fin_cut;  // finite: cons > neg_inf / 4
  const float* cand_lp;
  long long lp_stride;  // cand_lp's row stride
  const float* beam_scores;
  long long rows;
  int K, N, eos, pad;
  unsigned seed, step;
  float neg_inf;
  bool listed;  // the EOS slot comes from a token table
  long long row0;  // the global row of row 0: the noise counter's row word is row0 + row
};

// The chain's outputs from its reduced draw
template <class Cols>
__device__ __forceinline__ void write_draw(const Cols& cols, const typename Cols::Row& R,
                                           long long row, Draw d, const Common& a,
                                           const SampleOut& o) {
  // the EOS slot of dispatch_select: argmax(tokens == eos), slot 0 if none
  const int eos = a.eos, K = a.K;
  int eos_j = a.listed ? d.eos_j : ((eos >= 0 && eos < a.N) ? eos : INT_MAX);
  if (eos_j == INT_MAX) eos_j = 0;
  const bool dead = d.j == INT_MAX;
  const int j = dead ? eos_j : d.j;
  const int tok = dead ? eos : cols.token(R, j);
  const float sco = __fadd_rn(a.cand_lp[row * a.lp_stride + j], a.beam_scores[row]);
  const long long b = row / K;
  const int k = (int)(row - b * K);
  o.sel_tok[row] = tok;
  o.sel_par[row] = k;
  o.sel_sco[row] = sco;
  o.sel_fin[row] = 1;
  const long long h = b * 2 * K;
  o.c_tok[h + k] = tok;
  o.c_tok[h + K + k] = a.pad;
  o.c_par[h + k] = k;
  o.c_par[h + K + k] = k;
  o.c_sco[h + k] = sco;
  o.c_sco[h + K + k] = a.neg_inf;
  o.c_fin[h + k] = 1;
  o.c_fin[h + K + k] = 0;
}


// the warp route: one warp a row
template <class Cols>
__global__ void __launch_bounds__(WARP_THREADS)
sample_warp_kernel(Cols cols, Common a, SampleOut o) {
  __shared__ float gub[256];
  if constexpr (Cols::kBound) fill_bounds(gub);
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (WARP_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= a.rows) return;
  const auto R = cols.row(row);
  Draw d{__uint_as_float(NEG_INF_BITS), INT_MAX, INT_MAX};
  const int nq = (a.N + 3) >> 2;
  if constexpr (Cols::kLists) {
    __shared__ WarpLists lists[WARP_THREADS / 32];
    draw_quads(cols, R, a.row0 + row, lane, nq, 32, a.seed, a.step, a.fin_cut, gub,
               lists[threadIdx.x >> 5], d);
  } else {
    draw_lane(cols, R, a.row0 + row, lane, nq, 32, a.seed, a.step, a.fin_cut, gub, d);
  }
  d = warp_reduce(d);
  if (lane == 0)
    write_draw(cols, R, row, d, a, o);
}

// the cluster barrier in two halves (a CTA may touch another's shared
// memory once every CTA of the cluster has arrived)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// the block route: a row's quads over a cluster of `splits` CTAs (a
// contiguous share each), reduced in the first CTA
template <class Cols>
__global__ void __launch_bounds__(BLOCK_THREADS, 4)
sample_block_kernel(Cols cols, Common a, SampleOut o) {
  __shared__ Draw s_warp[BLOCK_THREADS / 32];
  __shared__ Draw s_cta[MAX_SPLITS];
  __shared__ float gub[256];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int c = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row = blockIdx.x / C;
  const auto R = cols.row(row);
  const int nq = (a.N + 3) >> 2;
  const int per = (nq + C - 1) / C;
  if (C > 1) cluster_arrive_relaxed();  // waited on before the first remote write
  if constexpr (Cols::kBound) fill_bounds(gub);
  Draw d{__uint_as_float(NEG_INF_BITS), INT_MAX, INT_MAX};
  const int q0 = c * per + tid, q1 = min(nq, (c + 1) * per);
  if constexpr (Cols::kLists) {
    __shared__ WarpLists lists[BLOCK_THREADS / 32];
    draw_quads(cols, R, a.row0 + row, q0, q1, BLOCK_THREADS, a.seed, a.step, a.fin_cut, gub,
               lists[warp], d);
  } else {
    draw_lane(cols, R, a.row0 + row, q0, q1, BLOCK_THREADS, a.seed, a.step, a.fin_cut, gub, d);
  }
  d = warp_reduce(d);
  if (lane == 0) s_warp[warp] = d;
  __syncthreads();
  if (C > 1) cluster_wait();
  if (tid == 0) {
    for (int w = 1; w < BLOCK_THREADS / 32; ++w) merge(d, s_warp[w]);
    if (C > 1) cluster.map_shared_rank(s_cta, 0)[c] = d;
  }
  if (C > 1) {
    cluster.sync();
    if (c != 0 || tid != 0) return;
    for (int r = 1; r < C; ++r) merge(d, s_cta[r]);
  } else if (tid != 0) {
    return;
  }
  write_draw(cols, R, row, d, a, o);
}

template <class Cols>
int launch(const Cols& cols, const Common& a, const SampleOut& o, int splits,
           cudaStream_t stream) {
  if (a.rows <= 0) return (int)cudaGetLastError();
  if (splits == 0) {  // the warp route
    const long long per = WARP_THREADS / 32;
    sample_warp_kernel<Cols><<<(unsigned)((a.rows + per - 1) / per), WARP_THREADS, 0, stream>>>(
        cols, a, o);
    return (int)cudaGetLastError();
  }
  if (splits < 1 || splits > MAX_SPLITS) return (int)cudaErrorInvalidValue;
  if (splits == 1) {
    sample_block_kernel<Cols><<<(unsigned)a.rows, BLOCK_THREADS, 0, stream>>>(cols, a, o);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.rows * splits));
  cfg.blockDim = dim3(BLOCK_THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, sample_block_kernel<Cols>, cols, a, o);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}

// The noise alone, [rows, n] words and Gumbel values, for checking the
// generator against its plain version.
__global__ void noise_kernel(int n, unsigned seed, unsigned step, long long row0,
                             unsigned* words, float* g) {
  const long long row = blockIdx.x;
  for (int q = threadIdx.x; 4 * q < n; q += blockDim.x) {
    const uint4 w =
        philox4x32_10(make_uint4((unsigned)q, (unsigned)(row0 + row), 0u, 0u), seed, step);
    for (int i = 0; i < 4 && 4 * q + i < n; ++i) {
      words[row * n + 4 * q + i] = word_of(w, i);
      g[row * n + 4 * q + i] = gumbel_of(word_of(w, i));
    }
  }
}

}  // namespace

extern "C" {

// cons, cand_lp [rows, N] f32 contiguous; tokens [rows, N] int32 (None:
// token = column) or mask [N] bool, 4-byte aligned (None: every column);
// splits 0 (the warp route) or 1-8 CTAs a row (kernels/sample_select.py:plan)
int seal_sample_select(const float* cons, const float* cand_lp, const int* tokens,
                       const unsigned char* mask, const float* beam_scores, long long rows, int K,
                       int N, long long seed, long long step, long long row_offset, int eos,
                       int pad, float neg_inf, int splits, int* c_tok, int* c_par, float* c_sco, unsigned char* c_fin,
                       int* sel_tok, int* sel_par, float* sel_sco, unsigned char* sel_fin,
                       void* stream) {
  const SampleOut o{c_tok, c_par, c_sco, c_fin, sel_tok, sel_par, sel_sco, sel_fin};
  const Common a{neg_inf / 4.0f, cand_lp, N, beam_scores, rows, K, N, eos, pad,
                 (unsigned)seed, (unsigned)step, neg_inf, tokens != nullptr, row_offset};
  if (tokens != nullptr)
    return launch(ListCols{cons, tokens, N, eos}, a, o, splits, (cudaStream_t)stream);
  if (((unsigned long long)mask & 3) != 0) return (int)cudaErrorInvalidValue;
  return launch(WideCols{cons, mask, N}, a, o, splits, (cudaStream_t)stream);
}

// The count-reading mode: mask [rows, 4 * ceil(V / 128)] (the count mask)
// contiguous, lp [rows, V] f32 with row stride lp_stride, prev_count /
// finished / beam_scores [rows]; cons = lp where kernel 17's branches allow
// a token, else neg_inf
int seal_sample_counts(const unsigned* mask, const float* lp, long long lp_stride,
                       const int* prev_count, const unsigned char* finished,
                       const float* beam_scores, long long rows, int K, int V, int eos, int pad,
                       int stop_at_count, int always_allow_eos, long long seed, long long step,
                       long long row_offset, float neg_inf, int splits, int* c_tok, int* c_par,
                       float* c_sco, unsigned char* c_fin, int* sel_tok, int* sel_par,
                       float* sel_sco, unsigned char* sel_fin, void* stream) {
  const SampleOut o{c_tok, c_par, c_sco, c_fin, sel_tok, sel_par, sel_sco, sel_fin};
  const Common a{neg_inf / 4.0f, lp, lp_stride, beam_scores, rows, K, V, eos, pad,
                 (unsigned)seed, (unsigned)step, neg_inf, false, row_offset};
  const Branches br{prev_count, finished, beam_scores, eos, pad, stop_at_count, always_allow_eos,
                    neg_inf};
  return launch(CountCols{mask, lp, lp_stride, br, V, 4 * ((V + 127) / 128)}, a, o, splits,
                (cudaStream_t)stream);
}

int seal_gumbel_noise(long long rows, int n, long long seed, long long step, long long row_offset,
                      unsigned* words, float* g, void* stream) {
  if (rows <= 0) return (int)cudaGetLastError();
  noise_kernel<<<(unsigned)rows, 256, 0, (cudaStream_t)stream>>>(n, (unsigned)seed,
                                                                  (unsigned)step, row_offset, words,
                                                                  g);
  return (int)cudaGetLastError();
}

}  // extern "C"
