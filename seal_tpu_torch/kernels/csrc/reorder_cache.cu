// Kernel 11: the beam reorder of the decoder's self-attention K/V cache.
//
// Replaces seal_tpu/models/bart.py: reorder_cache (:356-358), the gather of
// every layer's K and V rows by the selected parent beam after each step.
//
// Design: one launch for all of a step's tensors (decoder layers x {k, v}).
// Their source and destination pointers travel by value in the kernel's
// parameter block, so the launch needs no table in device memory.  Only the
// live columns [0, step] of each row are copied, into the other of two
// preallocated buffers (ping-pong): a row's columns are contiguous in the
// [rows, max_len, heads, head_dim] layout, so that is one contiguous span
// of (step + 1) * heads * head_dim elements per (tensor, row).  Columns past
// step were never written in either buffer, so the result equals the full
// gather bit for bit.  Step 0's fan-out (stride K0 into B*K rows) is the
// same copy with a narrower source.
//
// Bound on the card: bytes.  Each (tensor, row) span is read once and
// written once, 16 bytes a thread per access; at the generation point a step
// moves up to 24 x 480 x 10 x 2 KB x 2 = 472 MB (step 9), >= 0.14 ms at
// 3.35 TB/s.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_TENSORS = 128;

struct Table {
  const char* src[MAX_TENSORS];
  char* dst[MAX_TENSORS];
};

// grid (rows, n_tensors): destination row r of tensor t takes source row
// index[r]'s first copy_bytes bytes.  An index outside [0, src_rows) stops
// the launch with an error (as torch's own indexing does on the card)
// instead of reading past the source.
__global__ void reorder_kernel(Table table, const long long* __restrict__ index,
                               long long src_rows, long long copy_bytes, long long row_bytes) {
  const long long r = blockIdx.x;
  const int t = blockIdx.y;
  const long long s = index[r];
  if (s < 0 || s >= src_rows) __trap();
  const uint4* src = (const uint4*)(table.src[t] + s * row_bytes);
  uint4* dst = (uint4*)(table.dst[t] + r * row_bytes);
  const long long n = copy_bytes / 16;
  for (long long i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

}  // namespace

// table: host array of n_tensors source pointers followed by n_tensors
// destination pointers; every pointer, row_bytes and copy_bytes must be
// multiples of 16 (the wrapper checks).
extern "C" int seal_reorder_cache(const unsigned long long* table, int n_tensors,
                                  const long long* index, long long rows, long long src_rows,
                                  long long copy_bytes, long long row_bytes, void* stream) {
  if (rows <= 0 || n_tensors <= 0 || copy_bytes <= 0) return (int)cudaGetLastError();
  if (n_tensors > MAX_TENSORS) return (int)cudaErrorInvalidValue;
  Table t;
  for (int i = 0; i < n_tensors; ++i) {
    t.src[i] = (const char*)table[i];
    t.dst[i] = (char*)table[n_tensors + i];
  }
  const dim3 grid((unsigned)rows, (unsigned)n_tensors);
  reorder_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(t, index, src_rows, copy_bytes,
                                                         row_bytes);
  return (int)cudaGetLastError();
}
