// The 16-ary wavelet tree's device functions, shared by kernels 12-14 and
// 16 (wt_search.cu, wt_window.cu, wt_bucket_counts.cu).
//
// Layout (seal_tpu_torch/index/wavelet.py): blocks [digits, n_blocks, 48]
// uint32, per 256 rows of a level 16 cumulative digit counts (the rank
// directory) then 32 code words of 8 four-bit digits each, little-endian;
// node_start / node_cnt give each heap node's start in its level sequence
// and the per-digit ranks at that start.  A rank of digit d at level
// position x is one block: the directory word d plus the popcount of the
// matched nibbles of the code words before x & 255.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace seal_wt {

constexpr int SHIFT = 1;  // real token ids are stored +1; 0 is the sentinel
constexpr int DIGIT_BITS = 4;
constexpr int RADIX = 16;
constexpr int WORDS_PER_BLOCK = 48;

struct Index {
  const uint32_t* blocks;   // [digits, n_blocks, 48]
  const int* node_start;    // [heap]
  const int* node_cnt;      // [heap, 16]
  const int* C;             // [sigma_bound + 1]
  long long n_blocks;
  int n_rows;
  int digits;
  int sigma;                // symbols >= sigma never occur: rank 0
};

// start of level `level` in the 16-ary node heap: sum of 16^j, j < level
__device__ __forceinline__ int heap_base(int level) {
  return ((1 << (DIGIT_BITS * level)) - 1) / (RADIX - 1);
}

// nibble-low bits of the digits of w equal to the digit broadcast in pat:
// XOR, OR each nibble down to its bit 0, complement under the lane mask
__device__ __forceinline__ uint32_t match_nibbles(uint32_t w, uint32_t pat) {
  uint32_t x = w ^ pat;
  x |= x >> 2;
  x |= x >> 1;
  return ~x & 0x11111111u;
}

// the 48 words of the block that holds level position x (x clamped to
// [0, n_rows]; block n_rows >> 8 exists, as the builder adds one)
__device__ __forceinline__ const uint32_t* block_of(const Index& ix, int level, int& x) {
  x = min(max(x, 0), ix.n_rows);
  return ix.blocks + ((long long)level * ix.n_blocks + (x >> 8)) * WORDS_PER_BLOCK;
}

// occurrences of digit d among the level positions before x, x in blk
__device__ __forceinline__ int rank_in_block(const uint32_t* blk, int x, int d) {
  const int within = x & 255;
  const int last = within >> 3;  // the code word that holds x
  const uint32_t pat = (uint32_t)d * 0x11111111u;
  int cnt = (int)__ldg(blk + d);
  // blocks are 192 bytes and the codes start 64 bytes in: 16-byte aligned
  const uint4* codes = reinterpret_cast<const uint4*>(blk + RADIX);
  for (int q = 0; q <= (last >> 2); ++q) {
    const uint4 v = __ldg(codes + q);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * q + k;
      uint32_t m = match_nibbles(w[k], pat);
      if (i == last) m &= (1u << ((within & 7) << 2)) - 1u;
      cnt += i <= last ? __popc(m) : 0;
    }
  }
  return cnt;
}

// Occurrences of digit d at offsets [wa, wb) of the block at blk,
// 0 <= wa <= wb <= 256: the matched nibbles of the code words between,
// read 16 bytes at a time.
__device__ __forceinline__ int count_between(const uint32_t* blk, int wa, int wb, int d) {
  if (wb <= wa) return 0;
  const uint32_t pat = (uint32_t)d * 0x11111111u;
  const uint4* codes = reinterpret_cast<const uint4*>(blk + RADIX);
  int cnt = 0;
  for (int q = wa >> 5; q <= (wb - 1) >> 5; ++q) {  // 32 offsets a 16-byte load
    const uint4 v = __ldg(codes + q);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int at = 32 * q + 8 * k;  // the word's first offset
      const int lo = min(max(wa - at, 0), 8), hi = min(max(wb - at, 0), 8);
      const uint32_t below_hi = hi == 8 ? 0xffffffffu : (1u << (4 * hi)) - 1u;
      const uint32_t keep = below_hi & ~((1u << (4 * lo)) - 1u);
      cnt += __popc(match_nibbles(w[k], pat) & keep);
    }
  }
  return cnt;
}

// Occ of digit d before level position x (clamped as block_of clamps it),
// counted from the nearer end of its block: the block's directory word
// plus the codes before x, or the next block's directory word less the
// codes from x on (every block but the last holds 256 positions).
__device__ __forceinline__ int rank_near(const Index& ix, int level, int x, int d) {
  const uint32_t* blk = block_of(ix, level, x);
  const int w = x & 255;
  if (w > 128 && (x >> 8) + 1 < ix.n_blocks)
    return (int)__ldg(blk + WORDS_PER_BLOCK + d) - count_between(blk, w, 256, d);
  return (int)__ldg(blk + d) + count_between(blk, 0, w, d);
}

// Occ(c, pos) for a shifted symbol c in [0, sigma) over the index's L =
// digits levels.  A level's node and digit follow from the symbol alone, so
// every level's node start and start rank are loaded first, all
// independent; then the L block reads chain through the position: one
// round of table loads and L block rounds, where a level at a time took L x
// (table -> block).  L is a template argument so the loads unroll: each
// kernel that ranks is instantiated for every digit count and picked on the
// host (with_digits below).
template <int L>
__device__ __forceinline__ int rank(const Index& ix, int c, int pos) {
  int start[L], below[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int node = heap_base(l) + (c >> (DIGIT_BITS * (L - l)));
    const int d = (c >> (DIGIT_BITS * (L - 1 - l))) & 15;
    start[l] = __ldg(ix.node_start + node);
    below[l] = __ldg(ix.node_cnt + (long long)node * RADIX + d);
  }
  int p = pos;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    int x = start[l] + p;
    const uint32_t* blk = block_of(ix, l, x);
    p = rank_in_block(blk, x, (c >> (DIGIT_BITS * (L - 1 - l))) & 15) - below[l];
  }
  return p;
}

template <int L>
struct Digits {
  static constexpr int value = L;
};

// launch(Digits<L>{}) at the index's digit count, one instance a count.
// The ranking kernels are built for 1 to 5 digits (kernels/wt_search.py:
// MAX_DIGITS): index/wavelet.py sizes the digits to the vocab, 4 for BART's
// 50,265 tokens and T5's 32,128, 5 up to 2^20 - 1 tokens; more give
// cudaErrorInvalidValue.
template <typename F>
int with_digits(int digits, F&& launch) {
  switch (digits) {
    case 1: return launch(Digits<1>{});
    case 2: return launch(Digits<2>{});
    case 3: return launch(Digits<3>{});
    case 4: return launch(Digits<4>{});
    case 5: return launch(Digits<5>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// the shifted BWT symbol at row (in [0, n_rows)): read each level's digit
// and descend by its rank
__device__ __forceinline__ int access(const Index& ix, int row) {
  int p = row;
  int c = 0;
  for (int l = 0; l < ix.digits; ++l) {
    const int node = heap_base(l) + c;
    int x = __ldg(ix.node_start + node) + p;
    const uint32_t* blk = block_of(ix, l, x);
    const int d = (int)((__ldg(blk + RADIX + ((x & 255) >> 3)) >> ((x & 7) << 2)) & 15u);
    p = rank_in_block(blk, x, d) - __ldg(ix.node_cnt + node * RADIX + d);
    c = (c << DIGIT_BITS) | d;
  }
  return c;
}

// the shifted BWT symbol at row (in [0, n_rows)): one read of the hybrid
// layout's raw BWT at the JAX width (BWT_BYTES 2: uint16, 4: int32), or
// the descent in the compact layout (BWT_BYTES 0)
template <int BWT_BYTES>
__device__ __forceinline__ int symbol_at(const Index& ix, const void* bwt, long long row) {
  if (BWT_BYTES == 2) return (int)__ldg(static_cast<const unsigned short*>(bwt) + row);
  if (BWT_BYTES == 4) return __ldg(static_cast<const int*>(bwt) + row);
  return access(ix, (int)row);
}

}  // namespace seal_wt
