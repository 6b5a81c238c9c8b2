// A descending bitonic sort of [rows, n2] 64-bit words in device memory,
// shared by kernel 3's large-k route (row_topk.cu) and kernel 8's merge past
// shared memory (beam_select.cu).
//
// sort_tile_kernel sorts 8192-word tiles in shared memory; then, for each
// larger size, merge_global_kernel runs the strides of a tile and wider, one
// launch each, and sort_tile_kernel the narrower ones inside a tile.  The
// last of these hands each row's first k words to the caller's `Out`
// functor, out(row, j, word), instead of writing them back.  Words that are
// unique order totally, so the result is exact.
#pragma once

#include <cuda_runtime.h>

#include "select_common.cuh"

namespace {

constexpr int GTILE = 8192;     // words of a tile sorted in shared memory (64 KB)
constexpr int GTHREADS = 1024;  // threads of a tile's block

__device__ __forceinline__ void cmp_swap(u64* w, int lo, int hi, bool desc) {
  const u64 a = w[lo], b = w[hi];
  if (desc ? a < b : a > b) {
    w[lo] = b;
    w[hi] = a;
  }
}

// The strides < GTILE of bitonic sizes lo_size .. hi_size inside one tile
// of a row's n2 words (block b: tile b % (n2 / GTILE) of row b / (n2 /
// GTILE)), descending where the row index's `size` bit is 0.  With `last`
// the tile's words j < k go to `out` instead of back.
template <class Out>
__global__ void __launch_bounds__(GTHREADS)
sort_tile_kernel(u64* __restrict__ gbuf, int n2, int lo_size, int hi_size, int k, int last,
                 Out out) {
  extern __shared__ u64 tile[];
  const int tiles = n2 / GTILE;
  const long long row = blockIdx.x / tiles;
  const int t0 = (blockIdx.x % tiles) * GTILE;  // the tile's first index in the row
  u64* w = gbuf + row * n2 + t0;
  for (int j = threadIdx.x; j < GTILE; j += GTHREADS) tile[j] = w[j];
  for (int size = lo_size; size <= hi_size; size <<= 1) {
    for (int stride = min(size, GTILE) >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int t = threadIdx.x; t < GTILE / 2; t += GTHREADS) {
        const int lo = 2 * t - (t & (stride - 1));
        cmp_swap(tile, lo, lo + stride, ((t0 + lo) & size) == 0);
      }
    }
  }
  __syncthreads();
  if (!last) {
    for (int j = threadIdx.x; j < GTILE; j += GTHREADS) w[j] = tile[j];
    return;
  }
  for (int j = threadIdx.x; j < GTILE && t0 + j < k; j += GTHREADS) out(row, t0 + j, tile[j]);
}

// One stride >= GTILE of bitonic size `size`: a thread a pair.
__global__ void merge_global_kernel(u64* __restrict__ gbuf, int n2, int size, int stride,
                                    long long pairs) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pairs) return;
  const long long row = p / (n2 / 2);
  const int t = (int)(p % (n2 / 2));
  const int lo = 2 * t - (t & (stride - 1));
  cmp_swap(gbuf + row * n2, lo, lo + stride, (lo & size) == 0);
}

// The network over [rows, n2] words (n2 a power of two, at least GTILE),
// filled by the caller; hands each row's first k words to `out`.
template <class Out>
int global_sort(u64* gbuf, long long n_rows, int n2, int k, Out out, cudaStream_t stream) {
  constexpr int SMEM = GTILE * 8;
  constexpr int MAX_DEVICES = 64;
  static int smem_set[MAX_DEVICES];  // one a device and Out type
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES || n2 < GTILE || n2 % GTILE != 0) return (int)cudaErrorInvalidValue;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(sort_tile_kernel<Out>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = 1;
  }
  const unsigned blocks = (unsigned)(n_rows * (n2 / GTILE));
  sort_tile_kernel<Out><<<blocks, GTHREADS, SMEM, stream>>>(gbuf, n2, 2, GTILE, k,
                                                            n2 == GTILE, out);
  const long long pairs = n_rows * (n2 / 2);
  for (int size = 2 * GTILE; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride >= GTILE; stride >>= 1)
      merge_global_kernel<<<(unsigned)((pairs + 255) / 256), 256, 0, stream>>>(gbuf, n2, size,
                                                                               stride, pairs);
    sort_tile_kernel<Out><<<blocks, GTHREADS, SMEM, stream>>>(gbuf, n2, size, size, k,
                                                              size == n2, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace
