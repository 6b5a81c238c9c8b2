// Kernel 18: the suffix-array gather and the document search of a located
// occurrence, one kernel with two modes.
//
// Replaces, in seal_tpu/ops/fm_ops.py:
//   gather -- locate_rows (:322): sa[row] for rows in [0, n_rows), else -1;
//   search -- doc_index_of (:330): searchsorted(beginnings, pos,
//             side="right") - 1, the document that holds each position.
//
// One thread per element.  The gather is one guarded, scattered 4-byte read;
// the search a binary search of log2(n_docs + 1) dependent reads over the
// beginnings (40 KB at 10k documents, L2-resident after the first warps).
// Bound on the card: latency, the dependent chain of the search; the inputs
// are read once and the outputs written once.  Integer outputs: the kernel
// equals the plain version exactly.

#include <cuda_runtime.h>

namespace {

// table: sa [n_table] (gather) or beginnings [n_table] ascending (search)
__global__ void locate_kernel(const int* __restrict__ table, int n_table,
                              const int* __restrict__ in, long long n, int search,
                              int* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n; i += stride) {
    const int x = in[i];
    if (!search) {
      out[i] = (x >= 0 && x < n_table) ? __ldg(table + x) : -1;
      continue;
    }
    // the number of beginnings <= x (side="right"), minus one
    int lo = 0, hi = n_table;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(table + mid) <= x)
        lo = mid + 1;
      else
        hi = mid;
    }
    out[i] = lo - 1;
  }
}

}  // namespace

extern "C" int seal_locate(const int* table, int n_table, const int* in, long long n, int search,
                           int* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 65535) blocks = 65535;
  locate_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(table, n_table, in, n,
                                                                       search, out);
  return (int)cudaGetLastError();
}
