// Kernel 22: the label-smoothed NLL of training, forward and backward.
//
// Replaces seal_tpu/training/trainer.py:label_smoothed_nll (:38-46) and its
// VJP under jax.value_and_grad (:85-87).  Per row n of the LM head's f32
// logits x [N, V] with target t_n:
//   lse_n  = log(sum_v exp(x[n, v]))
//   loss_n = (1 - eps) (lse_n - x[n, t_n]) + eps (lse_n - sum_v x[n, v] / V)
// masked by m_n = (t_n != pad); loss = sum_n m_n loss_n / max(sum_n m_n, 1).
// The gradient wrt the logits:
//   grad[n, v] = g m_n / max(ntok, 1) (exp(x[n, v] - lse_n) - (1 - eps)[v = t_n] - eps / V)
// with g the upstream gradient of the loss, read from device memory.
//
// Bound on the card: bytes.  At the path shape [2560, 50265] the logits are
// 514.7 MB: the forward reads them once (0.154 ms at 3.35 TB/s), the
// backward reads them and writes as much (0.307 ms); neither reads the
// rows of pad targets, so the bound of a batch counts its other rows.
//
// Forward: one CTA a row, one pass; a masked row (t_n = pad) is not read.
// Each thread keeps a running max m, the sum of exp(x - m) and the sum of x
// over its share of the row (16-byte loads); the block merges those with a
// fixed tree (warp xor butterflies, then one warp over the warps'
// partials), so the result repeats bit for bit from run to run.  Thread 0 writes lse_n (kept for the backward) and
// the masked row loss.  The CTA that finishes last (a counter in device
// memory, reset by that CTA) sums the row losses and the mask in row order
// with a fixed tree, in f64, and writes loss and ntok: one launch, and no
// float atomics.  The counter makes one launch at a time on a device
// correct, which is how the trainer calls it.
//
// Backward: one CTA a row writes a fresh f32 gradient (16-byte stores);
// masked rows are written as zeros without reading the logits.
//
// V = 50,265 is odd, so a row starts 16-byte aligned only every fourth
// row: each row is a scalar head up to the next 16-byte boundary, a body of
// float4s and a scalar tail (at most 3 elements each), so the body moves in
// 16-byte accesses whatever the row's alignment.  The logits and the
// backward's gradient both start 16-byte aligned (the wrapper refuses other
// logits), so their rows share one layout.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;

__device__ unsigned int g_rows_done = 0;

struct Row {  // a thread's running statistics of its share of a row
  float m, s, sum;
};

__device__ __forceinline__ void add4(Row& r, float a, float b, float c, float d) {
  const float m4 = fmaxf(fmaxf(a, b), fmaxf(c, d));
  if (m4 > r.m) {
    r.s *= expf(r.m - m4);
    r.m = m4;
  }
  r.s += expf(a - r.m) + expf(b - r.m) + expf(c - r.m) + expf(d - r.m);
  r.sum += (a + b) + (c + d);
}

__device__ __forceinline__ void add1(Row& r, float a) {
  if (a > r.m) {
    r.s *= expf(r.m - a);
    r.m = a;
  }
  r.s += expf(a - r.m);
  r.sum += a;
}

__device__ __forceinline__ Row merge(Row a, Row b) {
  const float m = fmaxf(a.m, b.m);
  return {m, a.s * expf(a.m - m) + b.s * expf(b.m - m), a.sum + b.sum};
}

__device__ __forceinline__ Row warp_merge(Row r) {
  for (int o = 16; o > 0; o >>= 1) {
    Row q{__shfl_xor_sync(0xffffffffu, r.m, o), __shfl_xor_sync(0xffffffffu, r.s, o),
          __shfl_xor_sync(0xffffffffu, r.sum, o)};
    r = merge(r, q);
  }
  return r;
}

// the row's layout: `head` scalars up to a 16-byte boundary, `nvec` float4s,
// then `tail` scalars
struct Span {
  int head, nvec, tail;
};

__device__ __forceinline__ Span span_of(const float* row, int V) {
  const int mis = (int)(((unsigned long long)row >> 2) & 3);
  int head = (4 - mis) & 3;
  if (head > V) head = V;
  const int rest = V - head;
  return {head, rest >> 2, rest & 3};
}

__global__ void __launch_bounds__(THREADS)
nll_forward_kernel(const float* __restrict__ x, const int* __restrict__ targets, int V, int pad,
                   float eps, float* __restrict__ lse_out, float* __restrict__ row_loss,
                   float* __restrict__ loss_out, float* __restrict__ ntok_out) {
  __shared__ float red_m[WARPS], red_s[WARPS], red_x[WARPS];
  __shared__ double dred[WARPS];
  __shared__ bool last;
  const long long n = blockIdx.x;
  const int N = gridDim.x;
  const int t = targets[n];
  const float* row = x + n * (long long)V;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (t == pad) {  // a masked row: its loss is 0 and the backward reads no lse
    if (threadIdx.x == 0) {
      lse_out[n] = 0.0f;
      row_loss[n] = 0.0f;
      __threadfence();
      last = atomicAdd(&g_rows_done, 1u) == (unsigned)(N - 1);
    }
  } else {
    if (t < 0 || t >= V) __trap();  // a target outside the vocabulary
    const Span sp = span_of(row, V);
    Row r{-FLT_MAX, 0.0f, 0.0f};
    if (threadIdx.x < sp.head) add1(r, __ldg(row + threadIdx.x));
    const float4* body = reinterpret_cast<const float4*>(row + sp.head);
    for (int i = threadIdx.x; i < sp.nvec; i += THREADS) {
      const float4 v = __ldg(body + i);
      add4(r, v.x, v.y, v.z, v.w);
    }
    if (threadIdx.x < sp.tail) add1(r, __ldg(row + sp.head + 4 * sp.nvec + threadIdx.x));
    r = warp_merge(r);
    if (lane == 0) {
      red_m[warp] = r.m;
      red_s[warp] = r.s;
      red_x[warp] = r.sum;
    }
    __syncthreads();
    if (warp == 0) {
      r = lane < WARPS ? Row{red_m[lane], red_s[lane], red_x[lane]} : Row{-FLT_MAX, 0.0f, 0.0f};
      r = warp_merge(r);
      if (lane == 0) {
        const float lse = r.m + logf(r.s);
        lse_out[n] = lse;
        row_loss[n] = (1.0f - eps) * (lse - __ldg(row + t)) + eps * (lse - r.sum / (float)V);
        __threadfence();
        last = atomicAdd(&g_rows_done, 1u) == (unsigned)(N - 1);
      }
    }
  }
  __syncthreads();
  if (!last) return;
  // the last CTA: every row's loss is written; sum them in row order
  double s = 0.0, c = 0.0;
  for (int i = threadIdx.x; i < N; i += THREADS) {
    s += (double)__ldcg(row_loss + i);
    c += targets[i] != pad ? 1.0 : 0.0;
  }
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
  if (lane == 0) dred[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < WARPS ? dred[lane] : 0.0;
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  }
  __syncthreads();
  if (lane == 0) dred[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    double cnt = 0.0;
    for (int w = 0; w < WARPS; ++w) cnt += dred[w];  // exact: integers
    const double ntok = cnt > 1.0 ? cnt : 1.0;
    *loss_out = (float)(s / ntok);
    *ntok_out = (float)ntok;
    g_rows_done = 0;
  }
}

__global__ void __launch_bounds__(THREADS)
nll_backward_kernel(const float* __restrict__ x, const int* __restrict__ targets,
                    const float* __restrict__ lse, const float* __restrict__ ntok,
                    const float* __restrict__ gout, int V, int pad, float eps,
                    float* __restrict__ grad) {
  const long long n = blockIdx.x;
  const int t = targets[n];
  const float* row = x + n * (long long)V;
  float* out = grad + n * (long long)V;
  const Span sp = span_of(row, V);  // the gradient's rows: the same layout
  float4* obody = reinterpret_cast<float4*>(out + sp.head);
  const int tail0 = sp.head + 4 * sp.nvec;
  if (t == pad) {
    if (threadIdx.x < sp.head) out[threadIdx.x] = 0.0f;
    for (int i = threadIdx.x; i < sp.nvec; i += THREADS) {
      obody[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (threadIdx.x < sp.tail) out[tail0 + threadIdx.x] = 0.0f;
    return;
  }
  const float scale = *gout / *ntok;
  const float l = lse[n];
  const float smooth = eps / (float)V;
  const float hit = 1.0f - eps;
  auto g = [&](float v, int col) {
    const float p = expf(v - l);
    return scale * ((col == t ? p - hit : p) - smooth);
  };
  if (threadIdx.x < sp.head) out[threadIdx.x] = g(__ldg(row + threadIdx.x), threadIdx.x);
  const float4* body = reinterpret_cast<const float4*>(row + sp.head);
  for (int i = threadIdx.x; i < sp.nvec; i += THREADS) {
    const float4 v = __ldg(body + i);
    const int c = sp.head + 4 * i;
    obody[i] = make_float4(g(v.x, c), g(v.y, c + 1), g(v.z, c + 2), g(v.w, c + 3));
  }
  if (threadIdx.x < sp.tail) out[tail0 + threadIdx.x] = g(__ldg(row + tail0 + threadIdx.x),
                                                          tail0 + threadIdx.x);
}

}  // namespace

// x: f32 [n, V] (16-byte aligned), targets int32 [n]; writes lse [n],
// row_loss [n] (scratch), loss and ntok (one f32 each)
extern "C" int seal_nll_forward(const float* x, const int* targets, long long n, int V, int pad,
                                float eps, float* lse, float* row_loss, float* loss, float* ntok,
                                void* stream) {
  if (n <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  nll_forward_kernel<<<(unsigned)n, THREADS, 0, (cudaStream_t)stream>>>(
      x, targets, V, pad, eps, lse, row_loss, loss, ntok);
  return (int)cudaGetLastError();
}

// the forward's x, targets, lse and ntok, the upstream gradient gout (one
// f32); writes grad f32 [n, V] (16-byte aligned)
extern "C" int seal_nll_backward(const float* x, const int* targets, const float* lse,
                                 const float* ntok, const float* gout, long long n, int V,
                                 int pad, float eps, float* grad, void* stream) {
  if (n <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  nll_backward_kernel<<<(unsigned)n, THREADS, 0, (cudaStream_t)stream>>>(
      x, targets, lse, ntok, gout, V, pad, eps, grad);
  return (int)cudaGetLastError();
}
