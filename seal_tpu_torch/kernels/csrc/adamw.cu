// Kernel 23: the optimizer step of training -- optax's global-norm clip and
// AdamW -- over every parameter tensor in one launch a mode.
//
// Replaces the optax chain of seal_tpu/training/trainer.py:make_optimizer
// (:49-66) as make_train_step applies it (:88-90):
//   clip_by_global_norm(max_norm), then adamw(schedule, b1, b2, eps=1e-8,
//   weight_decay=wd), then apply_updates.
//
// Mode `norm`: the global norm sqrt(sum over every tensor of sum g^2).
// Mode `update`: per element, in place on p, mu and nu,
//   g'  = g                      if norm < max_norm
//       = (g / norm) * max_norm  otherwise  (optax's select; no eps)
//   mu  = (1 - b1) g' + b1 mu
//   nu  = (1 - b2) g'^2 + b2 nu
//   u   = (mu / bc1) / (sqrt(nu / bc2) + eps) + wd p
//   p   = p + (-lr) u
// with bc1 = 1 - b1^t, bc2 = 1 - b2^t (t = count + 1) and lr the schedule
// at the count before the increment, all computed by the host from its own
// count (no sync).  The norm is read from device memory.  Each operation is
// rounded on its own (__fmul_rn / __fadd_rn: no contraction into FMAs), as
// the plain version and optax compute them.
//
// Bound on the card: bytes.  For BART-large's 406M f32 parameters the norm
// reads 4 B a parameter (1.6 GB, 0.49 ms at 3.35 TB/s) and the update
// reads p, g, mu and nu and writes p, mu and nu (28 B a parameter, 11.4 GB,
// 3.4 ms).
//
// Design: the tensors' pointers and sizes travel by value in the kernel's
// parameter block (as kernel 11's table does), with each tensor's first
// block: a CTA finds its tensor by a binary search over those offsets (the
// same search in every thread: the parameter bank broadcasts it) and walks
// CHUNK elements of it in 16-byte accesses (the wrapper checks that every
// tensor is 16-byte aligned; a tensor's last chunk ends in scalars).  The
// norm writes one partial sum of squares a CTA; the CTA that finishes last
// (a counter in device memory, reset by that CTA) adds the partials in
// block order with a fixed tree, in f64, and writes the norm: one launch,
// no float atomics, the same bits from run to run.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 8192;  // elements a CTA
// BART-large has 512 tensors; 600 keeps the table (26 KB) inside the
// 32,764 bytes a kernel's parameters may take since CUDA 12.1
constexpr int MAX_TENSORS = 600;

struct Table {
  float* p[MAX_TENSORS];
  const float* g[MAX_TENSORS];
  float* mu[MAX_TENSORS];
  float* nu[MAX_TENSORS];
  long long n[MAX_TENSORS];
  int block0[MAX_TENSORS + 1];  // a tensor's first CTA; block0[count] = the grid
  int count;
};

struct Hyper {
  float max_norm, c1, b1, c2, b2, bc1, bc2, eps, wd, neg_lr;
};

__device__ unsigned int g_norm_done = 0;

__device__ __forceinline__ int tensor_of(const Table& t, int block) {
  int lo = 0, hi = t.count - 1;  // the last tensor whose block0 <= block
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.block0[mid] <= block) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
norm_kernel(const __grid_constant__ Table t, float* __restrict__ partial,
            float* __restrict__ norm) {
  __shared__ float red[WARPS];
  __shared__ double dred[WARPS];
  __shared__ bool last;
  const int k = tensor_of(t, blockIdx.x);
  const long long start = (long long)(blockIdx.x - t.block0[k]) * CHUNK;
  const long long len = min((long long)CHUNK, t.n[k] - start);
  const float* g = t.g[k] + start;
  const int nvec = (int)(len >> 2);
  float s = 0.0f;
  for (int i = threadIdx.x; i < nvec; i += THREADS) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(g) + i);
    s += (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
  }
  if (threadIdx.x < (int)(len & 3)) {
    const float v = __ldg(g + 4 * nvec + threadIdx.x);
    s += v * v;
  }
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = 0.0f;
    for (int w = 0; w < WARPS; ++w) b += red[w];
    partial[blockIdx.x] = b;
    __threadfence();
    last = atomicAdd(&g_norm_done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  double d = 0.0;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += THREADS) d += (double)__ldcg(partial + i);
  for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
  if (lane == 0) dred[warp] = d;
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
    for (int w = 0; w < WARPS; ++w) total += dred[w];
    *norm = (float)sqrt(total);
    g_norm_done = 0;
  }
}

__device__ __forceinline__ void step(float& p, float g, float& m, float& v, float nrm,
                                     bool clip, const Hyper& h) {
  if (clip) g = __fmul_rn(__fdiv_rn(g, nrm), h.max_norm);
  m = __fadd_rn(__fmul_rn(h.c1, g), __fmul_rn(h.b1, m));
  v = __fadd_rn(__fmul_rn(h.c2, __fmul_rn(g, g)), __fmul_rn(h.b2, v));
  const float mh = __fdiv_rn(m, h.bc1);
  const float vh = __fdiv_rn(v, h.bc2);
  const float u = __fadd_rn(__fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), h.eps)),
                            __fmul_rn(h.wd, p));
  p = __fadd_rn(p, __fmul_rn(h.neg_lr, u));
}

__global__ void __launch_bounds__(THREADS)
update_kernel(const __grid_constant__ Table t, const float* __restrict__ norm, const Hyper h) {
  const int k = tensor_of(t, blockIdx.x);
  const long long start = (long long)(blockIdx.x - t.block0[k]) * CHUNK;
  const long long len = min((long long)CHUNK, t.n[k] - start);
  float* p = t.p[k] + start;
  const float* g = t.g[k] + start;
  float* mu = t.mu[k] + start;
  float* nu = t.nu[k] + start;
  const float nrm = *norm;
  const bool clip = !(nrm < h.max_norm);
  const int nvec = (int)(len >> 2);
  for (int i = threadIdx.x; i < nvec; i += THREADS) {
    float4 pv = reinterpret_cast<float4*>(p)[i];
    const float4 gv = __ldg(reinterpret_cast<const float4*>(g) + i);
    float4 mv = reinterpret_cast<float4*>(mu)[i];
    float4 vv = reinterpret_cast<float4*>(nu)[i];
    step(pv.x, gv.x, mv.x, vv.x, nrm, clip, h);
    step(pv.y, gv.y, mv.y, vv.y, nrm, clip, h);
    step(pv.z, gv.z, mv.z, vv.z, nrm, clip, h);
    step(pv.w, gv.w, mv.w, vv.w, nrm, clip, h);
    reinterpret_cast<float4*>(p)[i] = pv;
    reinterpret_cast<float4*>(mu)[i] = mv;
    reinterpret_cast<float4*>(nu)[i] = vv;
  }
  if (threadIdx.x < (int)(len & 3)) {
    const long long j = 4 * nvec + threadIdx.x;
    step(p[j], __ldg(g + j), mu[j], nu[j], nrm, clip, h);
  }
}

// tables: host arrays of n_tensors pointers each (p, mu and nu may be null
// for the norm); fills the by-value table and the CTAs' offsets
int make_table(Table& t, float* const* p, const float* const* g, float* const* mu,
               float* const* nu, const long long* n, int n_tensors) {
  if (n_tensors <= 0 || n_tensors > MAX_TENSORS) return -1;
  long long blocks = 0;
  for (int i = 0; i < n_tensors; ++i) {
    if (n[i] <= 0) return -1;
    t.p[i] = p ? p[i] : nullptr;
    t.g[i] = g[i];
    t.mu[i] = mu ? mu[i] : nullptr;
    t.nu[i] = nu ? nu[i] : nullptr;
    t.n[i] = n[i];
    t.block0[i] = (int)blocks;
    blocks += (n[i] + CHUNK - 1) / CHUNK;
    if (blocks > 0x7fffffffLL) return -1;
  }
  t.block0[n_tensors] = (int)blocks;
  t.count = n_tensors;
  return (int)blocks;
}

}  // namespace

extern "C" int seal_adamw_max_tensors() { return MAX_TENSORS; }

// the CTAs (and so the partial sums) a norm over tensors of these sizes takes
extern "C" long long seal_adamw_blocks(const long long* n, int n_tensors) {
  long long blocks = 0;
  for (int i = 0; i < n_tensors; ++i) blocks += (n[i] + CHUNK - 1) / CHUNK;
  return blocks;
}

// g: host array of n_tensors device pointers, n their sizes; partial: f32
// scratch of seal_adamw_blocks(...) entries; writes the norm (one f32)
extern "C" int seal_adamw_norm(const unsigned long long* g, const long long* n, int n_tensors,
                               float* partial, float* norm, void* stream) {
  Table t;  // 26 KB, copied into the launch's parameter block
  const int blocks = make_table(t, nullptr, (const float* const*)g, nullptr, nullptr, n,
                                n_tensors);
  if (blocks <= 0) return (int)cudaErrorInvalidValue;
  norm_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(t, partial, norm);
  return (int)cudaGetLastError();
}

// p, g, mu, nu: host arrays of n_tensors device pointers, n their sizes;
// norm: the global norm (one f32 on the device); the hyper-parameters as
// the host computed them for this step (c1 = 1 - b1, c2 = 1 - b2)
extern "C" int seal_adamw_update(const unsigned long long* p, const unsigned long long* g,
                                 const unsigned long long* mu, const unsigned long long* nu,
                                 const long long* n, int n_tensors, const float* norm,
                                 float max_norm, float c1, float b1, float c2, float b2,
                                 float bc1, float bc2, float eps, float wd, float neg_lr,
                                 void* stream) {
  Table t;
  const int blocks = make_table(t, (float* const*)p, (const float* const*)g, (float* const*)mu,
                                (float* const*)nu, n, n_tensors);
  if (blocks <= 0) return (int)cudaErrorInvalidValue;
  const Hyper h{max_norm, c1, b1, c2, b2, bc1, bc2, eps, wd, neg_lr};
  update_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(t, norm, h);
  return (int)cudaGetLastError();
}
