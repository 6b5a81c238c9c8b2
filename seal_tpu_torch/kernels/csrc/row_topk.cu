// Kernel 3: exact row top-k with lax.top_k's order (value descending,
// index ascending on ties).
//
// Replaces seal_tpu/decoding/constrained.py: _exact_topk and every
// lax.top_k of the decode path (_top_idx, the proposal loop, step 0).
// torch.topk does not specify its tie order, and the decoder's token and
// parent equality depends on it.  The order is f32's total order (+0.0
// above -0.0), as lax.top_k's is.
//
// Design: one block per row.  The row is staged in shared memory (a
// 50265-wide f32 row is 201 KB, under the 227 KB a block may opt into;
// wider rows keep their tail in device memory and stay exact).  Each
// element maps to a 64-bit key, (monotone float bits << 32) | ~index, so
// the largest key is the best (value, index) pair and keys are unique.
// Each thread keeps the best key of its strided slice; pass p takes the
// block maximum of those, and only the thread that owned the winner
// rescans its slice for its best key below the winner.  The row is never
// modified and k passes cost k block reductions plus k slice rescans.
//
// Bound on the card: the k block-wide reductions (two barriers each); the
// row is read from device memory once.  A radix select is later work.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_STAGED = 56 * 1024;  // floats staged in shared memory

__device__ __forceinline__ unsigned long long pack(float v, int i) {
  const unsigned u = __float_as_uint(v);
  const unsigned mono = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)mono << 32) | (unsigned long long)(~(unsigned)i);
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  return v;
}

template <int THREADS>
__global__ void __launch_bounds__(THREADS)
row_topk_kernel(const float* __restrict__ x, int width, int k, int staged,
                float* __restrict__ vals, long long* __restrict__ idx) {
  extern __shared__ float sx[];
  __shared__ unsigned long long warp_best[THREADS / 32];
  __shared__ unsigned long long winner;
  const float* xr = x + (long long)blockIdx.x * width;
  for (int i = threadIdx.x; i < staged; i += THREADS) sx[i] = xr[i];
  __syncthreads();

  // best key of this thread's slice strictly below `below`
  auto slice_best = [&](unsigned long long below) {
    unsigned long long best = 0;
    for (int i = threadIdx.x; i < width; i += THREADS) {
      const float v = i < staged ? sx[i] : __ldg(xr + i);
      const unsigned long long key = pack(v, i);
      if (key < below && key > best) best = key;
    }
    return best;
  };

  unsigned long long best = slice_best(~0ull);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int p = 0; p < k; ++p) {
    unsigned long long v = warp_max(best);
    if (lane == 0) warp_best[warp] = v;
    __syncthreads();
    if (warp == 0) {
      v = lane < THREADS / 32 ? warp_best[lane] : 0ull;
      v = warp_max(v);
      if (lane == 0) winner = v;
    }
    __syncthreads();
    const unsigned long long w = winner;
    if (best == w) {
      // this thread owned the pick: write it, then refill from its slice
      const int i = (int)(~(unsigned)(w & 0xffffffffull));
      vals[(long long)blockIdx.x * k + p] = i < staged ? sx[i] : __ldg(xr + i);
      idx[(long long)blockIdx.x * k + p] = i;
      best = slice_best(w);
    }
  }
}

template <int THREADS>
int launch(const float* x, long long n_rows, int width, int k, float* vals, long long* idx,
           cudaStream_t stream) {
  const int staged = width < MAX_STAGED ? width : MAX_STAGED;
  const size_t smem = (size_t)staged * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(row_topk_kernel<THREADS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  row_topk_kernel<THREADS><<<(unsigned)n_rows, THREADS, smem, stream>>>(x, width, k, staged, vals,
                                                                         idx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int seal_row_topk(const float* x, long long n_rows, int width, int k, float* vals,
                             long long* idx, void* stream) {
  if (n_rows <= 0 || k <= 0) return (int)cudaGetLastError();
  if (width <= 4096) return launch<128>(x, n_rows, width, k, vals, idx, (cudaStream_t)stream);
  return launch<1024>(x, n_rows, width, k, vals, idx, (cudaStream_t)stream);
}
