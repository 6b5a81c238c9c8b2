// Kernel 13: the wavelet layouts' window and slab rows fused with the
// log-prob gather, in kernel 2's three modes.
//
// Replaces seal_tpu/ops/wt_ops.py: access (:115) with _digit_at, bwt_at
// (:154) and window_continuations (:176, through seal_tpu/ops/_generic.py:
// window_continuations), the take_along_axis of the log-probs that follows
// them in seal_tpu/decoding/constrained.py, and merge_round's slab
// (:622-635).  The rows, the modes and the outputs are kernel 2's
// (window_gather.cu), for each range [lo, hi):
//
// * the window: slot j < w reads row lo + j * max((hi - lo) / w, 1), invalid
//   slots carry fill_win;
// * the slab: slot j < width reads row s_lo + j of [s_lo, s_hi), s_lo =
//   min(lo + rows_prev, hi), s_hi = min(s_lo + width, hi), computed here;
//   invalid slots carry token 0.
//
// The window + slab mode (rows_prev 0) is a decode step's window and its
// proposal round 0's slab in one launch, the slab mode a straggler round's,
// the window mode the speculative step's.  A slot unshifts its symbol, drops
// the sentinel and out-of-vocabulary symbols and reads lp[range, token];
// where the window is stride 1 and no wider than round 0's slab, window
// slot j is slab slot j and is read once.  The symbol comes from:
//
// * the descent (compact layout, SYM 0), `digits` levels of the 16-ary
//   tree.  A level needs its node's row (node_cnt, and the node_start of
//   its 16 children) and the block that holds the position; both are known
//   as soon as the level above has its digit, so they load together, in one
//   round: the node row (eight 16-byte loads; the children's starts sit at
//   heap_base(l + 1) + 16c, one word past a 64-byte line, so four aligned
//   loads and one word), the code word of x, and the 16 directory words
//   and code words of the block's nearer half: below x under this block's
//   directory, or, from the middle on, above x under the next block's (at
//   most four 16-byte code loads; the level's last block has no next, and
//   a position past its middle reads its upper words in a second round).
//   The digit comes from x's word, its rank from the popcount of the
//   matched nibbles (four words folded into one popcount) added to or taken
//   from the directory word, and the next position from the registers: one
//   dependent round a level where the descent read
//   the node start, then the digit, then the block and the node count (about
//   12 dependent loads a slot at 4 digits).  The last level reads only the
//   digit's word: no rank follows it.
// * one read of the raw BWT (hybrid layout, SYM 2 or 4: uint16 when the
//   alphabet fits 16 bits, else 32 bits).
//
// Bound on the card: latency and launch.  ~15k window and ~31k slab slots
// a decode step at the bench point, each a chain of `digits` rounds (or one
// read) and then a scattered lp read: a few hundred KB.  A warp takes a
// range (one broadcast load of lo and hi) and a segment of 32 * PER of its
// slots, a flat list: the slab's, then the window's unless a shared window
// reads none of its own; CTAs of two warps with a slab, four without.  The
// direct read takes two slots a lane (kernel 2's shape), issuing both reads
// before either lp read; the descent one: its chain holds ~85 registers,
// and a lane that ran a window slot's and a slab slot's chains in lockstep
// spilled (255 registers) and ran the window + slab 1.8x the window alone
// (chip_smoke.py, NVIDIA H100).  A segment loop over blockIdx.y takes any
// width.  (Lanes whose rows share a block need no sharing of their own: a
// warp's loads of one address are one request.)

#include "wt_common.cuh"

namespace {

using seal_wt::Index;
using seal_wt::RADIX;
using seal_wt::SHIFT;
using seal_wt::WORDS_PER_BLOCK;

constexpr int MAX_GRID_Y = 65535;

struct Out {
  int* tok;
  unsigned char* valid;
  float* lp;
};

__device__ __forceinline__ bool in_vocab(int sym, int vocab) { return sym >= 0 && sym < vocab; }

// v[d] for a digit d known only at run time, by selects: no local memory
__device__ __forceinline__ int pick16(const int (&v)[16], int d) {
  int r = v[0];
#pragma unroll
  for (int k = 1; k < RADIX; ++k) r = k == d ? v[k] : r;
  return r;
}

// the 16 ints at p (16-byte aligned), four 16-byte loads
__device__ __forceinline__ void load16(const int* p, int (&v)[16]) {
  const int4* q = reinterpret_cast<const int4*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int4 t = __ldg(q + k);
    v[4 * k] = t.x;
    v[4 * k + 1] = t.y;
    v[4 * k + 2] = t.z;
    v[4 * k + 3] = t.w;
  }
}

// The unshifted BWT symbols at rows[m] (in [0, n_rows), where ok[m]) of
// the compact layout, M descents in lockstep (their loads overlap):
// L levels, each one round of independent loads (see the top).  The
// arithmetic is seal_wt::access's: x clamped to [0, n_rows] at every level,
// rank(d, x) = directory word d + the matches before x (or the next block's
// word d - the matches from x on), the next position node_start[child] +
// rank - node_cnt[node][d].  Rows not ok load nothing and give -1.
template <int L, int M>
__device__ __forceinline__ void descend(const Index& ix, const long long* rows, const bool* ok,
                                        int* sym) {
  int x[M], c[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    x[m] = ok[m] ? (int)rows[m] : 0;  // level 0's node starts at 0
    c[m] = 0;  // the digits so far: level l's node is heap_base(l) + c
  }
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const uint32_t* blk[M];
    uint32_t word[M];
    int cnt[M][16], child[M][16], dir[M][16];
    uint32_t code[M][16];
    bool up[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {  // the round's loads, every row's
      x[m] = min(max(x[m], 0), ix.n_rows);
      blk[m] = ix.blocks + ((long long)l * ix.n_blocks + (x[m] >> 8)) * WORDS_PER_BLOCK;
      const int last = (x[m] & 255) >> 3;
      word[m] = ok[m] ? __ldg(blk[m] + RADIX + last) : 0u;  // the code word of x
      if (l == L - 1 || !ok[m]) continue;  // the last level reads only the digit
      load16(ix.node_cnt + (long long)(seal_wt::heap_base(l) + c[m]) * RADIX, cnt[m]);
      // the children's starts: heap_base(l + 1) + 16c is 1 mod 16
      const int first = seal_wt::heap_base(l + 1) + c[m] * RADIX;
      int v[16];
      load16(ix.node_start + first - 1, v);
#pragma unroll
      for (int k = 0; k < RADIX - 1; ++k) child[m][k] = v[k + 1];
      child[m][RADIX - 1] = __ldg(ix.node_start + first + RADIX - 1);
      // the rank from the nearer half of the block: the words below x's
      // under this block's directory, or, from the middle on, the words
      // above it under the next block's (the last block has no next)
      up[m] = last >= 16 && (x[m] >> 8) + 1 < ix.n_blocks;
      load16(reinterpret_cast<const int*>(blk[m] + (up[m] ? WORDS_PER_BLOCK : 0)), dir[m]);
      const uint4* codes = reinterpret_cast<const uint4*>(blk[m] + RADIX) + (up[m] ? 4 : 0);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int g = 4 * q + (up[m] ? 16 : 0);  // the group's first word
        uint4 t = make_uint4(0u, 0u, 0u, 0u);
        if (up[m] ? g + 3 > last : g < last) t = __ldg(codes + q);  // a word on x's side
        code[m][4 * q] = t.x;
        code[m][4 * q + 1] = t.y;
        code[m][4 * q + 2] = t.z;
        code[m][4 * q + 3] = t.w;
      }
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int shift = (x[m] & 7) << 2, last = (x[m] & 255) >> 3;
      const int d = (int)((word[m] >> shift) & 15u);
      if (l == L - 1) {
        sym[m] = ok[m] ? ((c[m] << seal_wt::DIGIT_BITS) | d) - SHIFT : -1;
        continue;
      }
      if (!ok[m]) continue;
      const uint32_t pat = (uint32_t)d * 0x11111111u;
      // the matches in x's word on x's side, then in the loaded words, four
      // folded into one popcount (word k's matches on bit k of the nibble)
      const uint32_t below = (1u << shift) - 1u, mw = seal_wt::match_nibbles(word[m], pat);
      int part = __popc(mw & (up[m] ? ~below : below));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t t = 0u;
#pragma unroll
        for (int k = 0; k < 4; ++k) t |= seal_wt::match_nibbles(code[m][4 * q + k], pat) << k;
        const int g = 4 * q + (up[m] ? 16 : 0);
        // the group's words below x's (its first ones), or above it (its last)
        const int n_lo = min(max(last - g, 0), 4), n_hi = min(max(g + 3 - last, 0), 4);
        const uint32_t k_mask = up[m] ? ((1u << n_hi) - 1u) << (4 - n_hi) : (1u << n_lo) - 1u;
        part += __popc(t & (0x11111111u * k_mask));
      }
      if (!up[m] && last > 16) {  // the last block past its middle: its upper words too
        const uint4* codes = reinterpret_cast<const uint4*>(blk[m] + RADIX) + 4;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int g = 16 + 4 * q;
          const uint4 v = g < last ? __ldg(codes + q) : make_uint4(0u, 0u, 0u, 0u);
          const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
          uint32_t t = 0u;
#pragma unroll
          for (int k = 0; k < 4; ++k) t |= seal_wt::match_nibbles(w4[k], pat) << k;
          part += __popc(t & (0x11111111u * ((1u << min(max(last - g, 0), 4)) - 1u)));
        }
      }
      const int rank = pick16(dir[m], d) + (up[m] ? -part : part);
      x[m] = pick16(child[m], d) + rank - pick16(cnt[m], d);
      c[m] = (c[m] << seal_wt::DIGIT_BITS) | d;
    }
  }
}

// The unshifted symbols at rows[m] where ok[m] (else -1): the descent (SYM
// 0) or one read each of the raw BWT, every row's loads issued together
// (rows, ok and sym point into a caller's arrays at constant offsets: the
// unrolled, inlined accesses stay in registers)
template <int SYM, int L, int M>
__device__ __forceinline__ void read_symbols(const Index& ix, const void* bwt,
                                             const long long* rows, const bool* ok, int* sym) {
  if constexpr (SYM == 0) {
    descend<L, M>(ix, rows, ok, sym);
  } else {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      int s = 0;
      if (ok[m]) {
        s = SYM == 2 ? (int)__ldg(static_cast<const unsigned short*>(bwt) + rows[m])
                     : __ldg(static_cast<const int*>(bwt) + rows[m]);
      }
      sym[m] = ok[m] ? s - SHIFT : -1;
    }
  }
}

// SYM: 0 descent, 2 or 4 the raw BWT's bytes; L: the descent's levels;
// PER: slots a lane takes in a segment of 32 * PER; WARPS: warps (ranges)
// a CTA; SLAB: whether the launch has a slab (width > 0).  A range's slots
// are one flat list: with a slab, its width slab slots, then the window's w
// slots unless the window is shared (window slot j is then slab slot j,
// written by that slot's lane); without, the window's.  So a lane runs PER
// chains, never a chain for a slot that reads nothing.
template <int SYM, int L, int PER, int WARPS, bool SLAB>
__global__ void __launch_bounds__(32 * WARPS)
wt_window_kernel(Index ix, const void* __restrict__ bwt, const float* __restrict__ lp,
                 long long lp_stride, const int* __restrict__ lo, const int* __restrict__ hi,
                 long long n, int w, int width, int rows_prev, int vocab, int fill_win, Out win,
                 Out slab) {
  const long long r = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= n) return;  // whole warps
  const int lane = threadIdx.x & 31;
  const int l = __ldg(lo + r);  // one address a warp: a broadcast load
  const int h = __ldg(hi + r);
  const int stride = w > 0 ? max(max(h - l, 0) / w, 1) : 1;
  const long long s_lo = min((long long)l + rows_prev, (long long)h);
  const long long s_hi = min(s_lo + width, (long long)h);
  // round 0 (rows_prev 0) with a stride-1 window no wider than the slab:
  // window row l + j is slab row s_lo + j, valid under the same test
  const bool share = SLAB && rows_prev == 0 && stride == 1 && w <= width;
  const long long slab_slots = SLAB ? width : 0;
  const long long total = slab_slots + (share ? 0 : w);  // the same over the warp
  const float* __restrict__ lrow = lp + r * lp_stride;
  const long long step = (long long)gridDim.y * 32 * PER;
  for (long long seg = (long long)blockIdx.y * 32 * PER; seg < total; seg += step) {
    long long rows[PER];
    bool ok[PER];
    int sym[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {  // this lane's slots: a slab slot or a window slot
      const long long f = seg + i * 32 + lane;
      if (f < slab_slots) {
        rows[i] = s_lo + f;
        ok[i] = rows[i] < s_hi;
      } else {
        const long long j = f - slab_slots;
        rows[i] = (long long)l + j * stride;
        ok[i] = j < w && f < total && rows[i] < h;
      }
    }
    read_symbols<SYM, L, PER>(ix, bwt, rows, ok, sym);
#pragma unroll
    for (int i = 0; i < PER; ++i) {  // the lp reads, then the stores
      const long long f = seg + i * 32 + lane;
      if (f >= total) continue;
      const bool sok = in_vocab(sym[i], vocab);
      float slp = 0.0f;
      long long j = f - slab_slots;  // the window slot this lane writes, if any
      if (f < slab_slots) {
        const int tk = sok ? sym[i] : 0;
        slp = __ldg(lrow + tk);
        const long long at = r * width + f;
        slab.tok[at] = tk;
        slab.valid[at] = sok ? 1 : 0;
        slab.lp[at] = slp;
        j = share && f < w ? f : -1;
      }
      if (j >= 0) {
        const int tk = sok ? sym[i] : fill_win;
        const long long at = r * w + j;
        win.tok[at] = tk;
        win.valid[at] = sok ? 1 : 0;
        win.lp[at] = share && sok ? slp : __ldg(lrow + tk);
      }
    }
  }
}

struct Args {
  Index ix;
  const void* bwt;
  const float* lp;
  long long lp_stride;
  const int *lo, *hi;
  long long n;
  int w, width, rows_prev, vocab, fill;
  Out win, slab;
  cudaStream_t stream;
};

template <int SYM, int L, int PER, int WARPS, bool SLAB>
int launch(const Args& a) {
  const long long slots = (long long)a.w + (SLAB ? a.width : 0);  // a range's most
  const long long segs = (slots + 32 * PER - 1) / (32 * PER);
  const dim3 grid((unsigned)((a.n + WARPS - 1) / WARPS),
                  (unsigned)(segs < MAX_GRID_Y ? segs : MAX_GRID_Y));
  wt_window_kernel<SYM, L, PER, WARPS, SLAB><<<grid, 32 * WARPS, 0, a.stream>>>(
      a.ix, a.bwt, a.lp, a.lp_stride, a.lo, a.hi, a.n, a.w, a.width, a.rows_prev, a.vocab, a.fill,
      a.win, a.slab);
  return (int)cudaGetLastError();
}

// a symbol reader's two shapes: the window alone (a slot a lane, CTAs of
// four warps) and with a slab (CTAs of two warps; two slots a lane for the
// direct read, kernel 2's shape, one for the descent, whose chain holds
// ~85 registers)
template <int SYM, int L>
int launch_shape(const Args& a) {
  if (a.width == 0) return launch<SYM, L, 1, 4, false>(a);
  return launch<SYM, L, SYM == 0 ? 1 : 2, 2, true>(a);
}

}  // namespace

// The wavelet index, then bwt (null: the descent) and its bytes, lp [n, V]
// with row stride lp_stride, lo/hi [n]; w = 0 skips the window, width = 0
// the slab (their outputs may then be null); window outputs [n, w], slab
// outputs [n, width]
extern "C" int seal_wt_window_slab(const uint32_t* blocks, const int* node_start,
                                   const int* node_cnt, const int* C, long long n_blocks,
                                   int n_rows, int digits, int sigma, const void* bwt,
                                   int bwt_bytes, const float* lp, long long lp_stride,
                                   const int* lo, const int* hi, long long n, int w, int width,
                                   int rows_prev, int vocab, int fill_win, int* win_tok,
                                   unsigned char* win_valid, float* win_lp, int* slab_tok,
                                   unsigned char* slab_valid, float* slab_lp, void* stream) {
  if (w < 0 || width < 0 || rows_prev < 0) return (int)cudaErrorInvalidValue;
  if (n <= 0 || (w == 0 && width == 0)) return (int)cudaGetLastError();
  const Args a{{blocks, node_start, node_cnt, C, n_blocks, n_rows, digits, sigma},
               bwt, lp, lp_stride, lo, hi, n, w, width, rows_prev, vocab, fill_win,
               {win_tok, win_valid, win_lp}, {slab_tok, slab_valid, slab_lp},
               (cudaStream_t)stream};
  if (bwt != nullptr) {
    if (bwt_bytes == 2) return launch_shape<2, 0>(a);
    if (bwt_bytes == 4) return launch_shape<4, 0>(a);
    return (int)cudaErrorInvalidValue;
  }
  return seal_wt::with_digits(digits, [&](auto dg) {
    return launch_shape<0, decltype(dg)::value>(a);
  });
}
