// Kernel 19: the k-th largest value of each row, by radix select.
//
// Replaces, in seal_tpu/decoding/constrained.py, lax.top_k(logits,
// topk)[0][..., -1:] of the top-k warper (_apply_topk_warper :289-294).
// (The decode modes' top-top_m, which this kernel also served until the
// port routed it to kernel 3, is kernels/row_topk.py's.)
//
// The order is lax.top_k's: value descending in f32's total order (+0.0
// above -0.0).  Each element maps to a 32-bit key whose unsigned order is
// that order (kernel 3's key), so the value is bit for bit the row's, and
// the kernel equals the plain version (kernels/row_select.py:row_kth_plain)
// exactly.
//
// Design: one 1024-thread block per row.  The row's keys are staged in
// shared memory (a 50265-wide row is 201 KB; a wider row keeps its tail in
// device memory and re-reads it each pass, exact at any width).  Four
// passes of 8-bit digits, most significant first, histogram the keys that
// match the digits found so far into 256 shared bins (one atomic per
// distinct digit of a warp: log-prob rows share their first digits, and
// per-lane atomics on three bins would serialise), and a warp-wide scan of
// the bins finds the digit of the k-th largest key.  After the fourth pass
// the k-th key T is known, and its value is written.
//
// Bound on the card: one read of the row from device memory (0.0288 ms at
// [480, 50265] f32 at 3.35 TB/s); the passes over shared memory and the
// one block a row (201 KB of shared memory each) are its cost above that.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;
constexpr int RADIX = 256;
// dynamic shared memory a block may take: the card's 227 KB, less the
// static bins and counters
constexpr int MAX_DYNAMIC = 227 * 1024 - 2048;

__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

__global__ void __launch_bounds__(THREADS)
row_kth_kernel(const float* __restrict__ x, int width, int k, int staged,
               float* __restrict__ kth) {
  extern __shared__ unsigned skey[];  // [staged]
  __shared__ unsigned hist[RADIX];
  __shared__ unsigned s_prefix, s_rank;
  const float* xr = x + (long long)blockIdx.x * width;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < staged; i += THREADS) skey[i] = order_key(xr[i]);
  auto key_at = [&](int i) { return i < staged ? skey[i] : order_key(__ldg(xr + i)); };

  // ---- radix select of the k-th largest key ---------------------------
  unsigned prefix = 0, mask = 0, rank = (unsigned)k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = tid; b < RADIX; b += THREADS) hist[b] = 0;
    __syncthreads();
    // warp-uniform trip count: every lane takes part in the match
    for (int base = 0; base < width; base += THREADS) {
      const int i = base + tid;
      int digit = -1;
      if (i < width) {
        const unsigned key = key_at(i);
        if ((key & mask) == prefix) digit = (int)((key >> shift) & 255u);
      }
      const unsigned same = __match_any_sync(0xffffffffu, digit);
      if (digit >= 0 && lane == __ffs(same) - 1) atomicAdd(&hist[digit], __popc(same));
    }
    __syncthreads();
    if (warp == 0) {
      // lane l holds digits 255 - 8l - j, j = 0..7: a scan in descending
      // digit order finds the bin where the count from the top reaches rank
      unsigned c[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = hist[255 - 8 * lane - j];
        sum += c[j];
      }
      unsigned incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned t = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += t;
      }
      unsigned acc = incl - sum;
      if (acc < rank && rank <= incl) {
        for (int j = 0; j < 8; ++j) {
          if (acc + c[j] >= rank) {
            s_prefix = prefix | ((unsigned)(255 - 8 * lane - j) << shift);
            s_rank = rank - acc;
            break;
          }
          acc += c[j];
        }
      }
    }
    __syncthreads();
    prefix = s_prefix;
    rank = s_rank;
    mask |= 255u << shift;
  }
  // prefix is the k-th key
  if (tid == 0) kth[blockIdx.x] = key_value(prefix);
}

}  // namespace

extern "C" {

int seal_row_kth(const float* x, long long n_rows, int width, int k, float* kth,
                 void* stream) {
  if (n_rows <= 0) return (int)cudaGetLastError();
  const long long room = MAX_DYNAMIC / 4;
  const int staged = width < room ? width : (int)room;
  const size_t smem = 4 * (size_t)staged;
  const cudaError_t err =
      cudaFuncSetAttribute(row_kth_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  row_kth_kernel<<<(unsigned)n_rows, THREADS, smem, (cudaStream_t)stream>>>(x, width, k, staged,
                                                                            kth);
  return (int)cudaGetLastError();
}

}  // extern "C"
