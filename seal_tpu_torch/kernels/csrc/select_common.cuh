// The ordered top-n shared by kernel 8 (beam_select.cu) and kernel 21
// (diverse_select.cu): lax.top_k's order as 64-bit keys, sorted in shared
// memory.
//
// Each candidate maps to a key, (monotone f32 bits << 32) | ~id, so the
// largest key is the best score and, among equal scores, the lowest id; +0.0
// ranks above -0.0 (f32 total order, as lax.top_k).  The id is the slot, or
// a tie id (exact_ties) that several slots may share: then each key carries
// its slot beside it, and equal keys order by slot, as a stable sort does.
#pragma once

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

__device__ __forceinline__ u64 pack(float v, int id) {
  const unsigned u = __float_as_uint(v);
  const unsigned mono = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((u64)mono << 32) | (u64)(~(unsigned)id);
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
// SLOTS, slots[i] travels with keys[i] and breaks equal keys, lower slot
// first (the caller pads slots with INT_MAX); without, keys are unique.
template <bool SLOTS>
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
        if (SLOTS && a == b) {
          b_first = slots[hi] < slots[lo];
          a_first = !b_first;
        }
        if (desc ? b_first : a_first) {
          keys[lo] = b;
          keys[hi] = a;
          if (SLOTS) {
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

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Opt a kernel into dynamic shared memory past the default 48 KB.
template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
