// Kernel 18: the suffix-array gather and the document search of a located
// occurrence, one source with two kernels.
//
// Replaces, in seal_tpu/ops/fm_ops.py:
//   gather -- locate_rows (:322): sa[row] for rows in [0, n_rows), else -1;
//   search -- doc_index_of (:330): searchsorted(beginnings, pos,
//             side="right") - 1, the document that holds each position.
//
// The gather is one thread an element, one guarded, scattered 4-byte read.
// The search is two-level: each block stages a sample of the beginnings,
// every `stride`-th (8, doubled until the sample fits 4096 entries: 5 KB at
// 10k documents), in shared memory and binary-searches it there; a position
// then lies in one segment of `stride` beginnings, narrowed by a binary
// search over its 32-entry blocks when the stride is wider than 32, and
// resolved inside one block of at most 32 entries (8 entries: one 32-byte
// sector) by independent 16-byte loads -- in place of ~14 dependent L2
// reads of a binary search over the whole array.  A grid of up to two
// 512-thread blocks an SM strides over the positions, so the sample is
// staged once a block.  (Every 32nd entry reads one 128-byte line a
// position, four times the bytes; `python -m seal_tpu_torch.bench_row_topk`
// times the strides.)
// Bound on the card: latency (launch, staging, the chain of one L2 line);
// the inputs are read once and the outputs written once.  Integer outputs:
// the kernel equals the plain version exactly.

#include <cuda_runtime.h>

namespace {

constexpr int SAMPLE_MAX = 4096;  // staged beginnings (16 KB)
constexpr int THREADS = 512;

__global__ void gather_kernel(const int* __restrict__ sa, int n_rows, const int* __restrict__ in,
                              long long n, int* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n; i += stride) {
    const int x = in[i];
    out[i] = (x >= 0 && x < n_rows) ? __ldg(sa + x) : -1;
  }
}

// beg: n_beg ascending beginnings; the result is the number of them <= x,
// minus one
__global__ void __launch_bounds__(THREADS)
search_kernel(const int* __restrict__ beg, int n_beg, int stride, int aligned,
              const int* __restrict__ in, long long n, int* __restrict__ out) {
  __shared__ int samp[SAMPLE_MAX];
  const long long step = (long long)gridDim.x * THREADS;
  long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
  int x = i < n ? in[i] : 0;  // in flight while the sample is staged
  const int ns = (int)(((long long)n_beg + stride - 1) / stride);
  for (int j = threadIdx.x; j < ns; j += THREADS) samp[j] = __ldg(beg + (long long)j * stride);
  __syncthreads();
  for (; i < n; i += step, x = i < n ? in[i] : 0) {
    int lo = 0, hi = ns;  // samples <= x
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (samp[mid] <= x)
        lo = mid + 1;
      else
        hi = mid;
    }
    if (lo == 0) {
      out[i] = -1;
      continue;
    }
    // beg[seg] <= x < beg[seg + stride] (or the end)
    const long long seg = (long long)(lo - 1) * stride;
    const int len = (int)min((long long)stride, (long long)n_beg - seg);
    int b_lo = 0, b_hi = (len + 31) >> 5;  // block b_lo starts <= x, block b_hi > x
    while (b_hi - b_lo > 1) {
      const int mid = (b_lo + b_hi) >> 1;
      if (__ldg(beg + seg + 32 * mid) <= x)
        b_lo = mid;
      else
        b_hi = mid;
    }
    const long long base = seg + 32 * b_lo;
    const int m = min(32, len - 32 * b_lo);
    int cnt = 0;
    if (aligned && (m & 3) == 0) {
      const int4* p = (const int4*)(beg + base);
      int4 v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = 4 * q < m ? __ldg(p + q) : make_int4(0, 0, 0, 0);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (4 * q < m) cnt += (v[q].x <= x) + (v[q].y <= x) + (v[q].z <= x) + (v[q].w <= x);
    } else {
      for (int q = 0; q < m; ++q) cnt += __ldg(beg + base + q) <= x;
    }
    out[i] = (int)(base + cnt - 1);
  }
}

}  // namespace

extern "C" int seal_locate(const int* table, int n_table, const int* in, long long n, int search,
                           int* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  long long blocks = (n + THREADS - 1) / THREADS;
  if (!search) {
    if (blocks > 65535) blocks = 65535;
    gather_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(table, n_table, in, n, out);
    return (int)cudaGetLastError();
  }
  int stride = 8;  // doubled until the sample fits
  while (((long long)n_table + stride - 1) / stride > SAMPLE_MAX) stride <<= 1;
  static int sms = 0;  // the card's SM count, read once
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return (int)cudaGetLastError();
  }
  if (blocks > 2LL * sms) blocks = 2LL * sms;
  const int aligned = ((unsigned long long)table & 15) == 0;
  search_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(table, n_table, stride, aligned, in, n, out);
  return (int)cudaGetLastError();
}
