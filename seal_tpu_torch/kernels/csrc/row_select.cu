// Kernel 19: exact row top-k at large k, and the k-th value, by radix select.
//
// Replaces, in seal_tpu/decoding/constrained.py:
//   top-k mode -- _exact_topk(lp, top_m) of free generation (:332, via
//                 _candidates_general :329-336) and lax.approx_max_k(lp,
//                 top_m) of the speculative mode (:348), exactly;
//   k-th mode  -- lax.top_k(logits, topk)[0][..., -1:] of the top-k warper
//                 (_apply_topk_warper :289-294).
//
// The order is lax.top_k's: value descending in f32's total order (+0.0
// above -0.0), ties to the lower index.  Each element maps to a 32-bit key
// whose unsigned order is that order (kernel 3's key), so the selected
// values are bit for bit the row's, and the kernel equals the plain version
// (kernels/row_topk.py:row_topk_plain) exactly.
//
// Design: one 1024-thread block per row.  The row's keys are staged in
// shared memory (a 50265-wide row is 201 KB; a wider row keeps its tail in
// device memory and re-reads it each pass, exact at any width).  Four
// passes of 8-bit digits, most significant first, histogram the keys that
// match the digits found so far into 256 shared bins (one atomic per
// distinct digit of a warp: log-prob rows share their first digits, and
// per-lane atomics on three bins would serialise), and a warp-wide scan of
// the bins finds the digit of the k-th largest key.  After the fourth pass
// the k-th key T is known, with the number of keys equal to T that the top
// k takes.  The k-th mode writes T's value and stops.  The top-k mode
// compacts the keys above T, plus the first of those equal to T in index
// order (a block-wide ballot scan over the row, skipped when every equal
// key is taken), into a buffer of k (key << 32 | ~index) words, and
// bitonic-sorts it descending: the output order.
//
// Bound on the card: one read of the row from device memory (0.0288 ms at
// [480, 50265] f32 at 3.35 TB/s); the passes over shared memory and the
// one block a row (201 KB of shared memory each) are its cost above that.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int RADIX = 256;
// dynamic shared memory a block may take: the card's 227 KB, less the
// static bins and counters
constexpr int MAX_DYNAMIC = 227 * 1024 - 2048;

typedef unsigned long long u64;

__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// Descending bitonic sort of n2 (a power of two) unique words in shared
// memory; padding words are 0 and sort last.
__device__ void sort_desc(u64* w, int n2) {
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int t = threadIdx.x; t < n2 / 2; t += blockDim.x) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool desc = (lo & size) == 0;
        const u64 a = w[lo], b = w[hi];
        if (desc ? a < b : a > b) {
          w[lo] = b;
          w[hi] = a;
        }
      }
    }
  }
  __syncthreads();
}

template <bool KTH>
__global__ void __launch_bounds__(THREADS)
row_select_kernel(const float* __restrict__ x, int width, int k, int staged, int n2,
                  float* __restrict__ vals, long long* __restrict__ idx, float* __restrict__ kth) {
  extern __shared__ u64 smem[];
  u64* buf = smem;                        // [n2] top-k mode only
  unsigned* skey = (unsigned*)(smem + n2);  // [staged]
  __shared__ unsigned hist[RADIX];
  __shared__ unsigned warp_tot[WARPS];
  __shared__ unsigned s_prefix, s_rank, s_eq, s_fill;
  const float* xr = x + (long long)blockIdx.x * width;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < staged; i += THREADS) skey[i] = order_key(xr[i]);
  auto key_at = [&](int i) { return i < staged ? skey[i] : order_key(__ldg(xr + i)); };

  // ---- radix select of the k-th largest key ---------------------------
  unsigned prefix = 0, mask = 0, rank = (unsigned)k, eq = 0;
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
            s_eq = c[j];
            break;
          }
          acc += c[j];
        }
      }
    }
    __syncthreads();
    prefix = s_prefix;
    rank = s_rank;
    eq = s_eq;
    mask |= 255u << shift;
  }
  // prefix is the k-th key T: the top k holds every key above it and the
  // first `rank` (in index order) of the `eq` keys equal to it
  if (KTH) {
    if (tid == 0) kth[blockIdx.x] = key_value(prefix);
    return;
  }

  // ---- compaction into the buffer ---------------------------------------
  if (tid == 0) s_fill = 0;
  __syncthreads();
  const bool all_ties = rank == eq;
  unsigned ties_before = 0;  // keys equal to T in earlier chunks
  for (int base = 0; base < width; base += THREADS) {
    const int i = base + tid;
    const unsigned key = i < width ? key_at(i) : 0u;
    const bool is_eq = i < width && key == prefix;
    bool take = (i < width && key > prefix) || (is_eq && all_ties);
    if (!all_ties) {  // block-uniform
      const unsigned ball = __ballot_sync(0xffffffffu, is_eq);
      if (lane == 0) warp_tot[warp] = __popc(ball);
      __syncthreads();
      unsigned before = ties_before + __popc(ball & ((1u << lane) - 1u)), chunk = 0;
      for (int w = 0; w < WARPS; ++w) {
        if (w < warp) before += warp_tot[w];
        chunk += warp_tot[w];
      }
      take = take || (is_eq && before < rank);
      ties_before += chunk;
      __syncthreads();
    }
    if (take) buf[atomicAdd(&s_fill, 1u)] = ((u64)key << 32) | (u64)(~(unsigned)i);
  }
  for (int j = k + tid; j < n2; j += THREADS) buf[j] = 0ull;
  sort_desc(buf, n2);
  for (int j = tid; j < k; j += THREADS) {
    const u64 w = buf[j];
    vals[(long long)blockIdx.x * k + j] = key_value((unsigned)(w >> 32));
    idx[(long long)blockIdx.x * k + j] = (long long)(~(unsigned)(w & 0xffffffffull));
  }
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

// Largest k the top-k mode takes: its sort buffer of 16384 words (128 KB)
// leaves room for a staged slice of the row (the k-th mode takes any k up
// to the row width).
long long seal_row_select_max_k() { return 16384; }

int seal_row_select(const float* x, long long n_rows, int width, int k, int kth_only, float* vals,
                    long long* idx, float* kth, void* stream) {
  if (n_rows <= 0) return (int)cudaGetLastError();
  const int n2 = kth_only ? 0 : pow2_at_least(k);
  const long long room = (MAX_DYNAMIC - 8LL * n2) / 4;
  const int staged = width < room ? width : (int)room;
  const size_t smem = 8 * (size_t)n2 + 4 * (size_t)staged;
  const auto kernel = kth_only ? row_select_kernel<true> : row_select_kernel<false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)n_rows, THREADS, smem, (cudaStream_t)stream>>>(x, width, k, staged, n2, vals,
                                                                    idx, kth);
  return (int)cudaGetLastError();
}

}  // extern "C"
