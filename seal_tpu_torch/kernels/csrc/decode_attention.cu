// Kernels 9 and 10: one-token decode attention over cached K/V.
//
// Replaces, in seal_tpu/models/bart.py:
//   kernel 9  -- _cross_attention_step (:156-182): the g beams of a query
//                share its encoder K/V [Bq, M, H, Dh] (g = 1 at step 0);
//   kernel 10 -- decode_step's cached self-attention (:275-285, through
//                _attention :142) over the live slots [0, step] only.
//
// Both are one routine: a CTA per (query, head) stages that head's K and V
// rows in shared memory, TILE positions at a time, and serves all g beams
// from each tile -- the point of the grouped design, which reads per-query
// K/V once per pass instead of once per beam.  Shared memory does not grow
// with the number of positions (an encoder input may have up to
// max_position_embeddings = 1024 of them).
//
// Numerics follow the plain code: each score is an f32 dot of the (bf16)
// operands plus the f32 bias; the softmax is f32; the probabilities
// exp(s - max) / sum are rounded to the compute dtype before the PV
// product, which accumulates in f32 over the positions in order and rounds
// once at the end.  To round the normalised probabilities as the plain code
// does, the CTA makes two passes over the tiles: the first keeps each
// beam's running max and sum of exp (the sum rescaled when the max rises),
// the second recomputes the scores with the same dot and accumulates PV.
// With a single tile (M <= TILE, the generation point's 14 encoder
// positions and <= 10 cache slots) the scores and V stay staged, the sum
// is exactly sum_j exp(s_j - max), and the second pass reads nothing again.
// The sum orders differ from the plain einsums, so bf16 outputs may differ
// by one bf16 ulp plus one bf16 step of a probability, and f32 ones by f32
// rounding.
//
// Kernel 10 reads slots [0, step] only.  The plain code runs over all
// max_len slots with a -1e9 bias past step; dropping those slots is exact
// because exp(-1e9 - max) is 0.0 in f32, so they add nothing to the softmax
// sum or to the PV product.
//
// Kernel 10's relative-position-bias mode replaces T5's cached
// self-attention (seal_tpu/models/t5.py:decode_step :358-371 with
// _position_bias :188): the caller passes an un-scaled q, the bucket table
// [num_buckets, H] (f32, or bf16 as the serving cast leaves it: read and
// widened to f32 here, exactly as T5 widens the gathered rows) and the
// decoder's bucket of each distance, int32 [max_len], and the kernel adds
// table[bucket[step - j]][h] to the f32 score of slot j <= step, where T5
// adds its [1, H, 1, max_len] bias row (built per step there by arange,
// log, where, gather and transpose).  The table's entries are read through
// the read-only cache: shared memory does not grow with it.  Slots past step stay unread, exact for the reason
// above (rel + -1e9 leaves exp at 0.0).
//
// Bound on the card: latency.  At the generation point a CTA moves a few KB
// (cross: 14 positions x 64 x 2 x bf16; self: <= 10 positions) and does
// ~30 k flops, so the launch and the dependent load -> reduce -> store chain
// set its time, not bytes or flops.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;  // positions staged at a time
constexpr int THREADS = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* out) { *out = __float2bfloat16_rn(v); }
// the probabilities' rounding to the compute dtype before PV
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// floats of shared memory: K and V tiles with rows padded to head_dim + 1
// (the score loop's lanes read 32 rows at one column without a bank
// conflict), q, the tile's scores, the PV accumulators, each beam's max and
// sum
__host__ __device__ inline size_t smem_floats(int group, int tile, int head_dim) {
  return (size_t)2 * tile * (head_dim + 1) + (size_t)2 * group * head_dim +
         (size_t)group * tile + (size_t)2 * group;
}

// s[r][0 .. head_dim) <- x at positions j0 .. j0 + n of (query b, head h)
template <typename T>
__device__ __forceinline__ void stage(float* s, const T* __restrict__ x, long long base, int j0,
                                      int n, int head_dim, long long pos_stride) {
  const int ld = head_dim + 1;
  for (int i = threadIdx.x; i < n * head_dim; i += blockDim.x) {
    const int j = i / head_dim, d = i - j * head_dim;
    s[j * ld + d] = to_f(x[base + (long long)(j0 + j) * pos_stride + d]);
  }
}

// grid (n_queries, heads); q rows b*group .. b*group + group - 1 at stride
// q_stride; K/V row b at kv_row_stride, positions at heads * head_dim;
// bias [n_queries, m] at bias_stride or null; rel_table [buckets, heads]
// (bf16 if rel_bf16, else f32) and rel_bucket [>= m] (the bucket of each
// distance m - 1 - j) or null.
template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ bias,
                        const void* __restrict__ rel_table, int rel_bf16,
                        const int* __restrict__ rel_bucket, T* __restrict__ out, int group, int heads, int m, int head_dim, int tile,
                        long long q_stride, long long kv_row_stride, long long bias_stride) {
  extern __shared__ float smem[];
  const int ld = head_dim + 1;
  float* s_k = smem;                       // [tile][ld]
  float* s_v = s_k + tile * ld;            // [tile][ld]
  float* s_q = s_v + tile * ld;            // [group][head_dim]
  float* s_acc = s_q + group * head_dim;   // [group][head_dim]
  float* s_p = s_acc + group * head_dim;   // [group][tile]: scores, then probabilities
  float* s_max = s_p + group * tile;       // [group]
  float* s_sum = s_max + group;            // [group]
  const long long b = blockIdx.x;
  const int h = blockIdx.y;
  const long long pos_stride = (long long)heads * head_dim;
  const long long kv_base = b * kv_row_stride + (long long)h * head_dim;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
  const float neg_inf = -__int_as_float(0x7f800000);
  const int n_tiles = (m + tile - 1) / tile;

  for (int i = threadIdx.x; i < group * head_dim; i += blockDim.x) {
    const int g = i / head_dim, d = i - g * head_dim;
    s_q[i] = to_f(q[(b * group + g) * q_stride + (long long)h * head_dim + d]);
    s_acc[i] = 0.0f;
  }
  for (int g = threadIdx.x; g < group; g += blockDim.x) {
    s_max[g] = neg_inf;
    s_sum[g] = 0.0f;
  }

  for (int pass = 0; pass < 2; ++pass) {
    for (int t = 0; t < n_tiles; ++t) {
      const int j0 = t * tile, tm = min(tile, m - j0);
      // one tile: its scores and V are still staged from the first pass
      if (pass == 0 || n_tiles > 1) {
        __syncthreads();  // the previous tile's readers are done
        stage(s_k, k, kv_base, j0, tm, head_dim, pos_stride);
        if (pass == 1 || n_tiles == 1) stage(s_v, v, kv_base, j0, tm, head_dim, pos_stride);
        __syncthreads();
        for (int i = threadIdx.x; i < group * tm; i += blockDim.x) {
          const int g = i / tm, jj = i - g * tm;
          const float* qr = s_q + g * head_dim;
          const float* kr = s_k + jj * ld;
          float s = 0.0f;
          for (int d = 0; d < head_dim; ++d) s = fmaf(qr[d], kr[d], s);
          if (bias != nullptr) s += bias[b * bias_stride + j0 + jj];
          if (rel_table != nullptr) {
            const long long e = (long long)__ldg(rel_bucket + (m - 1 - j0 - jj)) * heads + h;
            s += rel_bf16 ? __bfloat162float(__ldg((const __nv_bfloat16*)rel_table + e))
                          : __ldg((const float*)rel_table + e);
          }
          s_p[g * tile + jj] = s;
        }
        __syncthreads();
      } else {
        __syncthreads();  // lane 0's max and sum of the first pass are visible
      }
      // one warp per beam
      for (int g = warp; g < group; g += n_warps) {
        float* p = s_p + g * tile;
        if (pass == 0) {  // the running max and sum of exp(s - max)
          float tmx = neg_inf;
          for (int j = lane; j < tm; j += 32) tmx = fmaxf(tmx, p[j]);
          const float old = s_max[g];
          const float mx = fmaxf(old, warp_max(tmx));
          float sum = 0.0f;
          for (int j = lane; j < tm; j += 32) sum += expf(p[j] - mx);
          sum = warp_sum(sum);
          if (lane == 0) {
            s_sum[g] = s_sum[g] * expf(old - mx) + sum;  // exp(-inf) = 0 on the first tile
            s_max[g] = mx;
          }
        } else {  // the probabilities in the compute dtype
          const float mx = s_max[g], sum = s_sum[g];
          for (int j = lane; j < tm; j += 32) p[j] = round_to(expf(p[j] - mx) / sum, out);
        }
      }
      if (pass == 1) {
        __syncthreads();
        for (int i = threadIdx.x; i < group * head_dim; i += blockDim.x) {
          const int g = i / head_dim, d = i - g * head_dim;
          const float* p = s_p + g * tile;
          float acc = s_acc[i];
          for (int j = 0; j < tm; ++j) acc = fmaf(p[j], s_v[j * ld + d], acc);
          s_acc[i] = acc;
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < group * head_dim; i += blockDim.x) {
    const int g = i / head_dim, d = i - g * head_dim;
    from_f(s_acc[i], out + (b * group + g) * pos_stride + (long long)h * head_dim + d);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* bias,
           const void* rel_table, int rel_bf16, const int* rel_bucket, void* out,
           long long n_queries,
           int group, int heads, int m, int head_dim, long long q_stride,
           long long kv_row_stride, long long bias_stride, cudaStream_t stream) {
  const int tile = m < TILE ? m : TILE;
  const size_t smem = sizeof(float) * smem_floats(group, tile, head_dim);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)n_queries, (unsigned)heads);
  decode_attention_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, bias, rel_table, rel_bf16, rel_bucket, (T*)out,
      group, heads, m, head_dim, tile, q_stride, kv_row_stride, bias_stride);
  return (int)cudaGetLastError();
}

}  // namespace

// bytes of shared memory a launch needs (the wrapper refuses more than a
// block may opt into); independent of m once m >= TILE
extern "C" long long seal_decode_attention_smem(int group, int m, int head_dim) {
  return (long long)(sizeof(float) * smem_floats(group, m < TILE ? m : TILE, head_dim));
}

extern "C" int seal_decode_attention(const void* q, const void* k, const void* v,
                                     const float* bias, const void* rel_table, int rel_bf16,
                                     const int* rel_bucket, void* out, long long n_queries,
                                     int group, int heads, int m, int head_dim,
                                     long long q_stride, long long kv_row_stride,
                                     long long bias_stride, int bf16, void* stream) {
  if (n_queries <= 0 || group <= 0 || m <= 0) return (int)cudaGetLastError();
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, bias, rel_table, rel_bf16, rel_bucket, out,
                                 n_queries, group, heads, m, head_dim, q_stride, kv_row_stride,
                                 bias_stride, (cudaStream_t)stream);
  return launch<float>(q, k, v, bias, rel_table, rel_bf16, rel_bucket, out, n_queries, group,
                       heads, m, head_dim, q_stride, kv_row_stride, bias_stride,
                       (cudaStream_t)stream);
}
