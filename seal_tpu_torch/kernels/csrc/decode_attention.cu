// Kernels 9 and 10: one-token decode attention over cached K/V.
//
// Replaces, in seal_tpu/models/bart.py:
//   kernel 9  -- _cross_attention_step (:156-182): the g beams of a query
//                share its encoder K/V [Bq, M, H, Dh] (g = 1 at step 0);
//   kernel 10 -- decode_step's cached self-attention (:275-285, through
//                _attention :142) over the live slots [0, step] only;
// and T5's (seal_tpu/models/t5.py: the cross-attention :212, and
// decode_step's self-attention :358-371 with _position_bias :188: kernel
// 10's relative-position-bias mode, below).
//
// Numerics (every route): each score is an f32 dot of the operands plus
// the f32 bias; the softmax is f32; the probabilities exp(s - max) / sum
// are rounded to the compute dtype before the PV product, which
// accumulates in f32 and rounds once.  The plain einsums do the same; the
// sum orders differ, so a bf16 output may differ by one bf16 ulp plus one
// bf16 step of a probability (decode_attention.bf16_error_ratio), an f32
// one by f32 rounding (f32_error_ratio).  Kernel 10 reads slots [0, step]
// only: the plain code's -1e9 bias past step leaves exp at 0.0 in f32, so
// those slots add nothing.
//
// Routes (kernels/decode_attention.py:route picks one by shape; each is
// counted):
//
//   warp  -- g = 1 (kernel 10, and kernel 9 at step 0), Dh = 64, any M.
//            A bandwidth problem: at step 8 of the generation point kernel
//            10 reads 17.7 MB (0.0053 ms at 3.35 TB/s).  One warp per
//            (row, head), `hpc` heads of one row to a CTA, so that a CTA's
//            reads of a slot are contiguous.  Each lane loads 16 bytes (8
//            bf16 or 4 f32): 8 (16) lanes cover a slot's 64 values and a
//            warp reads 4 (2) slots an instruction.  Every live slot's K
//            and V of a chunk of 32 (16) slots is loaded before the first
//            reduction; scores reduce by shuffles inside a slot's lanes;
//            max, sum and probabilities stay in registers, PV too.  No
//            shared memory, no __syncthreads.  Past one chunk the warp makes
//            two passes (running max and sum, then the probabilities and
//            PV, re-reading K): the probabilities are rounded after
//            normalising, so the sum must be known first.  A lane holds 2,
//            4 or 8 slots of a chunk (the fewest that hold a short cache):
//            55, 80 or 112 registers a thread in bf16, 48, 64 or 96 in f32
//            (ptxas -v, sm_90a), so a short cache leaves room for more warps.
//   mma   -- 2 <= g <= 32, Dh = 64, M <= 1024, bf16 (kernel 9).  Tensor
//            cores through warp-level mma.sync.m16n8k16 (bf16 in, f32
//            accumulate): the g beams of a (query, head) are the rows of A
//            (16 a tile, rows past g zero; g > 16 takes two tiles), K the
//            columns of B.  M is split over a thread-block cluster, one CTA
//            per 64-position slice (M <= 64: a cluster of one, up to 16
//            CTAs at M = 1024); `hpc` warps of a CTA serve `hpc` heads of one
//            query.  A warp stages its slice's K and V with 16-byte cp.async
//            into rows padded to 144 bytes (K read as 32-bit pairs and V by
//            ldmatrix.trans without bank conflicts), keeps its slice's scores
//            in registers (nothing is recomputed), combines its rows' max and
//            sum of exp with the other CTAs' through distributed shared
//            memory, rounds P to bf16 in registers (the score accumulators
//            are P's A fragments) and computes P.V with the same
//            instruction; the CTAs' f32 partial outputs are summed through
//            distributed shared memory (each CTA a share of the elements,
//            in rank order, every CTA's part loaded at once) and rounded
//            once.  Shared memory: 18,688 bytes
//            a warp (K and V of 64 positions, the row statistics; the
//            partial outputs reuse K and V), 74,752 at 4 warps.  Registers:
//            32 score and 32 output accumulators and 16 Q fragments per
//            m16 tile: 137 a thread with one tile, 177 with two.
//   ffma  -- 2 <= g <= 32, Dh = 64, M <= 64, f32 (T5-base as the JAX
//            searcher builds it).  Register-blocked FFMA, no TF32: a warp
//            stages its (query, head)'s q, K and V with 16-byte cp.async;
//            8, 16 or 32 lanes span the positions (two a lane past 32) and
//            the lane groups split the beams (a (beam, position) block of
//            up to 8 x 1 or 32 x 2 accumulators a lane), reading K rows as
//            float4 and q as float4 broadcasts; every beam's max and sum
//            reduce by interleaved shuffles; the probabilities go to shared memory,
//            and lane l sums output columns 2l, 2l + 1 for every beam from
//            float2 reads of V.  Shared memory: 4 (128 g + 132 M) bytes a
//            warp (50 KB at g = 32, M = 64; fewer heads a CTA past 100 KB).
//            Registers: 52 to 128 a thread by the block's size.
//   tiled -- anything else (another head_dim, more than 32 beams, a bf16
//            M past 1024 or an f32 one past 64, unaligned operands): a CTA
//            per (query, head) stages K and V in 64-position tiles and
//            serves all g beams from each tile, in two passes past one
//            tile.  Its shared memory is smem_floats' count; past
//            what a block may opt into (about 256 beams at Dh = 64, the
//            group's q rows and accumulators growing with g), the beams are
//            split over CTAs (grid.z), each staging the same tiles for its
//            share.  40 registers.
//
// Kernel 10's relative-position-bias mode (T5): the caller passes an
// un-scaled q, the bucket table [num_buckets, H] (f32, or bf16 as the
// serving cast leaves it: widened to f32 here, exactly as T5 widens the
// gathered rows) and the decoder's bucket of each distance, int32 [max_len],
// and the kernel adds table[bucket[step - j]][h] to the f32 score of slot
// j <= step, where T5 adds its [1, H, 1, max_len] bias row.  Slots past
// step stay unread, exact for the reason above.
//
// Bound on the card: kernel 10 reads its live K/V rows once (bytes); kernel
// 9 at the generation point moves a few KB a (query, head) and is bound by
// the launch and the dependent load -> reduce -> store chain, at M = 1024
// by its K/V bytes (134 MB at 480 x 16 heads: 0.040 ms).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------- tiled route
// (the general route: any head_dim and group; see the header)


constexpr int TILE = 64;  // positions staged at a time
constexpr size_t SMEM_MAX = 227 * 1024;  // what a block may opt into
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

// grid (n_queries, heads, chunks); q rows b*group .. b*group + group - 1
// at stride q_stride, chunk z serving beams z*gc .. z*gc + gc - 1 of them;
// K/V row b at kv_row_stride, positions at heads * head_dim;
// bias [n_queries, m] at bias_stride or null; rel_table [buckets, heads]
// (bf16 if rel_bf16, else f32) and rel_bucket [>= m] (the bucket of each
// distance m - 1 - j) or null.
template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ bias,
                        const void* __restrict__ rel_table, int rel_bf16,
                        const int* __restrict__ rel_bucket, T* __restrict__ out, int group_all,
                        int gc, int heads, int m, int head_dim, int tile, long long q_stride,
                        long long kv_row_stride, long long bias_stride) {
  extern __shared__ float smem[];
  // this CTA's beams: g0 .. g0 + group - 1 of the query's group_all
  const int g0 = blockIdx.z * gc;
  const int group = min(gc, group_all - g0);
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
    s_q[i] = to_f(q[(b * group_all + g0 + g) * q_stride + (long long)h * head_dim + d]);
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
    from_f(s_acc[i], out + (b * group_all + g0 + g) * pos_stride + (long long)h * head_dim + d);
  }
}


// ---------------------------------------------------------------- warp route

constexpr unsigned FULL = 0xffffffffu;
constexpr int DH = 64;  // the fast routes' head_dim

__device__ __forceinline__ float neg_inf_f() { return -__int_as_float(0x7f800000); }

// the 16 bytes of a lane as f32 (8 bf16 or 4 f32)
__device__ __forceinline__ void widen(uint4 u, float* f, const __nv_bfloat16*) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void widen(uint4 u, float* f, const float*) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ uint4 narrow(const float* f, const __nv_bfloat16*) {
  uint4 u;
  unsigned* w = (unsigned*)&u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *(const unsigned*)&h;
  }
  return u;
}
__device__ __forceinline__ uint4 narrow(const float* f, const float*) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

// grid: n_rows * heads / hpc CTAs of 32 * hpc threads; warp w of CTA c
// serves row c / (heads / hpc), head (c % (heads / hpc)) * hpc + w.  SPL
// slots a lane of a chunk: the fewest that hold m slots in one chunk (2, 4;
// 8 past one chunk), so that a short cache leaves registers free for more
// warps on an SM.  q rows
// at q_stride, K/V rows at kv_row_stride (slots at heads * 64), bias [n_rows,
// >= m] at bias_stride or null, the relative-bias table and buckets or
// null.
template <typename T, int SPL>
__global__ void __launch_bounds__(128)
warp_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const float* __restrict__ bias, const void* __restrict__ rel_table,
                      int rel_bf16, const int* __restrict__ rel_bucket, T* __restrict__ out,
                      int heads, int m, int hpc, long long q_stride, long long kv_row_stride,
                      long long bias_stride) {
  constexpr int VEC = 16 / sizeof(T);  // values a lane loads of a slot
  constexpr int LPS = DH / VEC;        // lanes a slot: 8 (bf16) or 16 (f32)
  constexpr int SPI = 32 / LPS;        // slots a warp instruction: 4 or 2
  constexpr int CHUNK = SPI * SPL;     // slots a chunk: SPL (2, 4 or 8) a lane
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int blocks_a_row = heads / hpc;
  const long long b = blockIdx.x / blocks_a_row;
  const int h = (blockIdx.x % blocks_a_row) * hpc + warp;
  const int sg = lane / LPS, sub = lane % LPS;
  const long long pos_stride = (long long)heads * DH;
  const T* kb = k + b * kv_row_stride + (long long)h * DH + sub * VEC;
  const T* vb = v + b * kv_row_stride + (long long)h * DH + sub * VEC;
  const T tag = T();
  float qf[VEC];
  widen(__ldg((const uint4*)(q + b * q_stride + (long long)h * DH + sub * VEC)), qf, &tag);
  const float ninf = neg_inf_f();

  // the scores of slots c0 + sg + SPI * t of a chunk, every lane of a slot
  // holding its slot's score (-inf past m)
  auto scores = [&](int c0, const uint4* kr, float* s) {
#pragma unroll
    for (int t = 0; t < SPL; ++t) {
      float kf[VEC];
      widen(kr[t], kf, &tag);
      float d = 0.0f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) d = fmaf(qf[i], kf[i], d);
#pragma unroll
      for (int off = 1; off < LPS; off <<= 1) d += __shfl_xor_sync(FULL, d, off);
      const int j = c0 + sg + SPI * t;
      if (j < m) {
        if (bias != nullptr) d += __ldg(bias + b * bias_stride + j);
        if (rel_table != nullptr) {
          const long long e = (long long)__ldg(rel_bucket + (m - 1 - j)) * heads + h;
          d += rel_bf16 ? __bfloat162float(__ldg((const __nv_bfloat16*)rel_table + e))
                        : __ldg((const float*)rel_table + e);
        }
        s[t] = d;
      } else {
        s[t] = ninf;
      }
    }
  };
  auto load = [&](const T* base, int c0, uint4* r) {
#pragma unroll
    for (int t = 0; t < SPL; ++t) {
      const int j = c0 + sg + SPI * t;
      r[t] = j < m ? __ldg((const uint4*)(base + j * pos_stride)) : make_uint4(0, 0, 0, 0);
    }
  };
  // across the slot groups of the warp (lanes of one slot hold one value)
  auto group_max = [&](float x) {
#pragma unroll
    for (int off = LPS; off < 32; off <<= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
    return x;
  };
  auto group_sum = [&](float x) {
#pragma unroll
    for (int off = LPS; off < 32; off <<= 1) x += __shfl_xor_sync(FULL, x, off);
    return x;
  };

  uint4 kr[SPL], vr[SPL];
  float s[SPL], acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
  float mx, sum;
  if (m <= CHUNK) {  // one chunk: K and V read once
    load(kb, 0, kr);
    load(vb, 0, vr);
    scores(0, kr, s);
    float lm = ninf;
#pragma unroll
    for (int t = 0; t < SPL; ++t) lm = fmaxf(lm, s[t]);
    mx = group_max(lm);
    float ls = 0.0f;
#pragma unroll
    for (int t = 0; t < SPL; ++t) ls += expf(s[t] - mx);
    sum = group_sum(ls);
  } else {  // pass 1: the running max and sum of exp(s - max)
    mx = ninf;
    sum = 0.0f;
    for (int c0 = 0; c0 < m; c0 += CHUNK) {
      load(kb, c0, kr);
      scores(c0, kr, s);
      float lm = ninf;
#pragma unroll
      for (int t = 0; t < SPL; ++t) lm = fmaxf(lm, s[t]);
      const float nmx = fmaxf(mx, group_max(lm));
      float ls = 0.0f;
#pragma unroll
      for (int t = 0; t < SPL; ++t) ls += expf(s[t] - nmx);
      sum = sum * expf(mx - nmx) + group_sum(ls);  // exp(-inf) = 0 on the first chunk
      mx = nmx;
    }
  }
  for (int c0 = 0; c0 < m; c0 += CHUNK) {
    if (m > CHUNK) {  // pass 2: the same scores again, and V
      load(kb, c0, kr);
      load(vb, c0, vr);
      scores(c0, kr, s);
    }
#pragma unroll
    for (int t = 0; t < SPL; ++t) {
      const float p = round_to(expf(s[t] - mx) / sum, out);
      float vf[VEC];
      widen(vr[t], vf, &tag);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(p, vf[i], acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = group_sum(acc[i]);
  if (sg == 0)
    *(uint4*)(out + b * pos_stride + (long long)h * DH + sub * VEC) = narrow(acc, &tag);
}

// ---------------------------------------------------------------- mma route

constexpr int SLICE = 64;       // positions a CTA of the cluster
constexpr int KV_LD = DH + 8;   // bf16 a staged row: 144 bytes, conflict-free fragment reads
constexpr int MMA_MAX_CTAS = 16;
// shared memory a warp: K and V of a slice, then each row's max and sum
constexpr int MMA_WARP_BYTES = 2 * SLICE * KV_LD * 2 + 2 * 32 * 4;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *(const unsigned*)&h;
}

// grid: clusters of C CTAs (C = ceil(m / 64); one CTA when m <= 64), one
// cluster per (query, group of hpc heads); CTA rank r of a cluster owns
// positions [r * slice, +slice), its warp w head hblk * hpc + w.  MT m16
// tiles of beams (g <= 16 * MT).
template <int MT>
__global__ void __launch_bounds__(128)
mma_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int group, int heads, int m, int hpc,
                     int slice, long long q_stride, long long kv_row_stride,
                     long long bias_stride) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;  // the fragments' row group and column pair
  const long long pair = blockIdx.x / C;
  const int blocks_a_query = heads / hpc;
  const long long b = pair / blocks_a_query;
  const int h = (int)(pair % blocks_a_query) * hpc + warp;
  const int j0 = rank * slice;
  const int ns = min(slice, m - j0);  // >= 1
  const long long pos_stride = (long long)heads * DH;

  unsigned char* wsm = dyn_smem + warp * MMA_WARP_BYTES;
  __nv_bfloat16* sK = (__nv_bfloat16*)wsm;
  __nv_bfloat16* sV = sK + SLICE * KV_LD;
  float* s_max = (float*)(sV + SLICE * KV_LD);  // [32] rows of the MT tiles
  float* s_sum = s_max + 32;

  // stage K and V of the slice (16-byte cp.async); rows past ns up to the
  // next 16 are zero, so that a zero probability meets no NaN
  const int ns16 = (ns + 15) & ~15;
  {
    const __nv_bfloat16* kg = k + b * kv_row_stride + (long long)j0 * pos_stride + h * DH;
    const __nv_bfloat16* vg = v + b * kv_row_stride + (long long)j0 * pos_stride + h * DH;
    for (int i = lane; i < 8 * ns16; i += 32) {
      const int r = i >> 3, c = (i & 7) * 8;
      if (r < ns) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         smem_u32(sK + r * KV_LD + c)),
                     "l"(kg + r * pos_stride + c));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         smem_u32(sV + r * KV_LD + c)),
                     "l"(vg + r * pos_stride + c));
      } else {
        *(uint4*)(sK + r * KV_LD + c) = make_uint4(0, 0, 0, 0);
        *(uint4*)(sV + r * KV_LD + c) = make_uint4(0, 0, 0, 0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  // Q's A fragments while the copies fly: rows past g are zero
  unsigned qa[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r0 = mt * 16 + gid, r1 = r0 + 8;
    const __nv_bfloat16* q0 = q + (b * group + r0) * q_stride + h * DH + tig * 2;
    const __nv_bfloat16* q1 = q + (b * group + r1) * q_stride + h * DH + tig * 2;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      qa[mt][ks][0] = r0 < group ? __ldg((const unsigned*)(q0 + ks * 16)) : 0u;
      qa[mt][ks][1] = r1 < group ? __ldg((const unsigned*)(q1 + ks * 16)) : 0u;
      qa[mt][ks][2] = r0 < group ? __ldg((const unsigned*)(q0 + ks * 16 + 8)) : 0u;
      qa[mt][ks][3] = r1 < group ? __ldg((const unsigned*)(q1 + ks * 16 + 8)) : 0u;
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncwarp();

  // S = Q K^T: n-tile nt holds positions nt * 8 .. +7 of the slice
  const int NT = ns16 >> 3;
  float sc[MT][8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (nt >= NT) break;
    const __nv_bfloat16* kr = sK + (nt * 8 + gid) * KV_LD + tig * 2;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) sc[mt][nt][0] = sc[mt][nt][1] = sc[mt][nt][2] = sc[mt][nt][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const unsigned b0 = *(const unsigned*)(kr + ks * 16);
      const unsigned b1 = *(const unsigned*)(kr + ks * 16 + 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_bf16(sc[mt][nt], qa[mt][ks], b0, b1);
    }
  }
  // bias, the slice's end, and each row's max and sum of exp
  const float ninf = neg_inf_f();
  float mx[MT][2], sm[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) mx[mt][0] = mx[mt][1] = ninf;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (nt >= NT) break;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int jj = nt * 8 + tig * 2 + e;
      const float bb = jj < ns ? (bias != nullptr ? __ldg(bias + b * bias_stride + j0 + jj) : 0.0f)
                               : ninf;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        sc[mt][nt][e] = jj < ns ? sc[mt][nt][e] + bb : ninf;
        sc[mt][nt][2 + e] = jj < ns ? sc[mt][nt][2 + e] + bb : ninf;
        mx[mt][0] = fmaxf(mx[mt][0], sc[mt][nt][e]);
        mx[mt][1] = fmaxf(mx[mt][1], sc[mt][nt][2 + e]);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float x = mx[mt][hh];
      x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
      x = fmaxf(x, __shfl_xor_sync(FULL, x, 2));
      mx[mt][hh] = x;
      float y = 0.0f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt >= NT) break;
        y += expf(sc[mt][nt][2 * hh] - x) + expf(sc[mt][nt][2 * hh + 1] - x);
      }
      y += __shfl_xor_sync(FULL, y, 1);
      y += __shfl_xor_sync(FULL, y, 2);
      sm[mt][hh] = y;
    }
  }
  if (C > 1) {
    // the cluster's max and sum of each row: every CTA's (max, sum), the
    // sums rescaled to the common max, in rank order
    if (tig == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          s_max[mt * 16 + hh * 8 + gid] = mx[mt][hh];
          s_sum[mt * 16 + hh * 8 + gid] = sm[mt][hh];
        }
      }
    }
    cluster.sync();
    // every CTA's pair at once (the remote loads in flight together), then
    // the combination in rank order
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = mt * 16 + hh * 8 + gid;
        float rm[MMA_MAX_CTAS], rs[MMA_MAX_CTAS];
#pragma unroll
        for (int r = 0; r < MMA_MAX_CTAS; ++r) {
          if (r < C) {
            rm[r] = cluster.map_shared_rank(s_max, r)[row];
            rs[r] = cluster.map_shared_rank(s_sum, r)[row];
          }
        }
        float gm = ninf;
#pragma unroll
        for (int r = 0; r < MMA_MAX_CTAS; ++r)
          if (r < C) gm = fmaxf(gm, rm[r]);
        float gs = 0.0f;
#pragma unroll
        for (int r = 0; r < MMA_MAX_CTAS; ++r)
          if (r < C) gs += rs[r] * expf(rm[r] - gm);
        mx[mt][hh] = gm;
        sm[mt][hh] = gs;
      }
    }
  }
  // P in bf16 as the A fragments of P.V: k-step kk is n-tiles 2kk, 2kk + 1
  const int KS = ns16 >> 4;
  unsigned pa[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk >= KS) break;
      float p[2][4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float* c = sc[mt][2 * kk + hf];
        p[hf][0] = expf(c[0] - mx[mt][0]) / sm[mt][0];
        p[hf][1] = expf(c[1] - mx[mt][0]) / sm[mt][0];
        p[hf][2] = expf(c[2] - mx[mt][1]) / sm[mt][1];
        p[hf][3] = expf(c[3] - mx[mt][1]) / sm[mt][1];
      }
      pa[mt][kk][0] = pack_bf16(p[0][0], p[0][1]);
      pa[mt][kk][1] = pack_bf16(p[0][2], p[0][3]);
      pa[mt][kk][2] = pack_bf16(p[1][0], p[1][1]);
      pa[mt][kk][3] = pack_bf16(p[1][2], p[1][3]);
    }
  }
  // O = P V: d n-tile nd holds columns nd * 8 .. +7; V's B fragments by
  // ldmatrix.trans, two n-tiles a load
  float o[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nd = 0; nd < 8; ++nd) o[mt][nd][0] = o[mt][nd][1] = o[mt][nd][2] = o[mt][nd][3] = 0.0f;
  const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk >= KS) break;
#pragma unroll
    for (int jd = 0; jd < 4; ++jd) {
      const __nv_bfloat16* a = sV + (kk * 16 + (mi & 1) * 8 + mr) * KV_LD + jd * 16 + (mi >> 1) * 8;
      unsigned r0, r1, r2, r3;
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                   : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
                   : "r"(smem_u32(a)));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(o[mt][2 * jd], pa[mt][kk], r0, r1);
        mma_bf16(o[mt][2 * jd + 1], pa[mt][kk], r2, r3);
      }
    }
  }
  __nv_bfloat16* ob = out + b * group * pos_stride + (long long)h * DH;
  if (C == 1) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r0 = mt * 16 + gid, r1 = r0 + 8;
#pragma unroll
      for (int nd = 0; nd < 8; ++nd) {
        const int d = nd * 8 + tig * 2;
        if (r0 < group) *(unsigned*)(ob + r0 * pos_stride + d) = pack_bf16(o[mt][nd][0], o[mt][nd][1]);
        if (r1 < group) *(unsigned*)(ob + r1 * pos_stride + d) = pack_bf16(o[mt][nd][2], o[mt][nd][3]);
      }
    }
    return;
  }
  // the partial outputs, f32 [16 * MT][64], over this warp's K and V
  float* part = (float*)wsm;
  __syncwarp();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r0 = mt * 16 + gid, r1 = r0 + 8;
#pragma unroll
    for (int nd = 0; nd < 8; ++nd) {
      const int d = nd * 8 + tig * 2;
      *(float2*)(part + r0 * DH + d) = make_float2(o[mt][nd][0], o[mt][nd][1]);
      *(float2*)(part + r1 * DH + d) = make_float2(o[mt][nd][2], o[mt][nd][3]);
    }
  }
  cluster.sync();
  // this CTA's share of the elements, four at a time, summed over the CTAs
  // in rank order (every CTA's four loaded at once)
  for (int e4 = rank * 32 + lane; e4 < group * (DH / 4); e4 += C * 32) {
    float4 x[MMA_MAX_CTAS];
#pragma unroll
    for (int r = 0; r < MMA_MAX_CTAS; ++r)
      if (r < C) x[r] = ((const float4*)cluster.map_shared_rank(part, r))[e4];
    float4 t = x[0];
#pragma unroll
    for (int r = 1; r < MMA_MAX_CTAS; ++r) {
      if (r < C) {
        t.x += x[r].x;
        t.y += x[r].y;
        t.z += x[r].z;
        t.w += x[r].w;
      }
    }
    const int row = e4 / (DH / 4), d = (e4 % (DH / 4)) * 4;
    __nv_bfloat16* o = ob + row * pos_stride + d;
    *(unsigned*)o = pack_bf16(t.x, t.y);
    *(unsigned*)(o + 2) = pack_bf16(t.z, t.w);
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

// ---------------------------------------------------------------- ffma route

constexpr int FFMA_MAX_M = 64;
constexpr int K_LD = DH + 4;  // f32 a staged K row: float4 reads of 8 rows conflict-free
constexpr int FFMA_MAX_CTA_BYTES = 100 * 1024;

// shared memory a warp: q [g][64], P [g][64], K [m][68], V [m][64] (f32)
__host__ __device__ inline int ffma_warp_bytes(int group, int m) {
  return 4 * (2 * group * DH + m * K_LD + m * DH);
}

// grid: n_queries * heads / hpc CTAs of 32 * hpc threads; warp w serves
// head (c % (heads / hpc)) * hpc + w of query c / (heads / hpc); GMAX >= g.
// The warp stages q, K and V with 16-byte cp.async (all in flight at
// once).  Scores: PPL lanes span the positions (PPL >= m, or 32 lanes and
// two positions each past 32) and the 32 / PPL groups of them split the
// beams, so a short input keeps every lane busy; each lane reads its K
// rows as float4 and its beams' q as float4 broadcasts.  Output: lane l
// sums columns 2l, 2l + 1 for every beam.
template <int GMAX, int PPL>
__global__ void __launch_bounds__(128)
ffma_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ bias,
                      float* __restrict__ out, int group, int heads, int m, int hpc,
                      long long q_stride, long long kv_row_stride, long long bias_stride) {
  constexpr int BGN = 32 / PPL;         // beam groups of lanes
  constexpr int GL = GMAX / BGN;        // beams a lane scores
  constexpr int PL = PPL == 32 ? 2 : 1;  // positions a lane scores
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int blocks_a_query = heads / hpc;
  const long long b = blockIdx.x / blocks_a_query;
  const int h = (blockIdx.x % blocks_a_query) * hpc + warp;
  const long long pos_stride = (long long)heads * DH;
  float* sq = (float*)(dyn_smem + warp * ffma_warp_bytes(group, m));  // [g][64]
  float* sp = sq + group * DH;                                         // [g][64]: P
  float* sk = sp + group * DH;                                         // [m][68]
  float* sv = sk + m * K_LD;                                           // [m][64]
  const float ninf = neg_inf_f();

  const float* kb = k + b * kv_row_stride + (long long)h * DH;
  const float* vb = v + b * kv_row_stride + (long long)h * DH;
  for (int i = lane; i < group * (DH / 4); i += 32) {
    const int r = i / (DH / 4), c = (i % (DH / 4)) * 4;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(sq + r * DH + c)),
                 "l"(q + (b * group + r) * q_stride + h * DH + c));
  }
  for (int i = lane; i < m * (DH / 4); i += 32) {
    const int r = i / (DH / 4), c = (i % (DH / 4)) * 4;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(sk + r * K_LD + c)),
                 "l"(kb + r * pos_stride + c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(sv + r * DH + c)),
                 "l"(vb + r * pos_stride + c));
  }
  asm volatile("cp.async.commit_group;\n" ::);
  const int pl = lane % PPL, bg = lane / PPL;
  bool on[PL];
  float bb[PL];
#pragma unroll
  for (int p = 0; p < PL; ++p) {
    const int j = pl + PPL * p;
    on[p] = j < m;
    bb[p] = on[p] ? (bias != nullptr ? __ldg(bias + b * bias_stride + j) : 0.0f) : ninf;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncwarp();

  // scores of beams bg + BGN i at positions pl + PPL p
  float sc[GL][PL];
#pragma unroll
  for (int i = 0; i < GL; ++i)
#pragma unroll
    for (int p = 0; p < PL; ++p) sc[i][p] = 0.0f;
#pragma unroll 4
  for (int c = 0; c < DH; c += 4) {
    float4 kk[PL];
#pragma unroll
    for (int p = 0; p < PL; ++p) kk[p] = *(const float4*)(sk + (on[p] ? pl + PPL * p : 0) * K_LD + c);
#pragma unroll
    for (int i = 0; i < GL; ++i) {
      const int g = bg + BGN * i;
      if (g < group) {
        const float4 qq = *(const float4*)(sq + g * DH + c);
#pragma unroll
        for (int p = 0; p < PL; ++p)
          sc[i][p] = fmaf(qq.w, kk[p].w,
                          fmaf(qq.z, kk[p].z, fmaf(qq.y, kk[p].y, fmaf(qq.x, kk[p].x, sc[i][p]))));
      }
    }
  }
  // each beam's max over the positions, then its sum of exp, over the PPL
  // lanes of its group: the beams' shuffles are independent and interleave
  float mx[GL], sum[GL];
#pragma unroll
  for (int i = 0; i < GL; ++i) {
    mx[i] = ninf;
#pragma unroll
    for (int p = 0; p < PL; ++p) {
      sc[i][p] = on[p] ? sc[i][p] + bb[p] : ninf;
      mx[i] = fmaxf(mx[i], sc[i][p]);
    }
  }
#pragma unroll
  for (int off = PPL / 2; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < GL; ++i) mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], off));
#pragma unroll
  for (int i = 0; i < GL; ++i) {
    sum[i] = 0.0f;
#pragma unroll
    for (int p = 0; p < PL; ++p) {
      sc[i][p] = expf(sc[i][p] - mx[i]);
      sum[i] += sc[i][p];
    }
  }
#pragma unroll
  for (int off = PPL / 2; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < GL; ++i) sum[i] += __shfl_xor_sync(FULL, sum[i], off);
#pragma unroll
  for (int i = 0; i < GL; ++i) {
    const int g = bg + BGN * i;
    if (g < group) {
#pragma unroll
      for (int p = 0; p < PL; ++p) sp[g * DH + pl + PPL * p] = sc[i][p] / sum[i];
    }
  }
  __syncwarp();
  // out[g][2 lane, 2 lane + 1] = sum_j P[g][j] V[j][...]
  float2 acc[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) acc[g] = make_float2(0.0f, 0.0f);
  for (int j = 0; j < m; ++j) {
    const float2 vv = *(const float2*)(sv + j * DH + 2 * lane);
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < group) {
        const float p = sp[g * DH + j];
        acc[g].x = fmaf(p, vv.x, acc[g].x);
        acc[g].y = fmaf(p, vv.y, acc[g].y);
      }
    }
  }
  float* ob = out + b * group * pos_stride + (long long)h * DH + 2 * lane;
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
    if (g < group) *(float2*)(ob + g * pos_stride) = acc[g];
}

// ---------------------------------------------------------------- launches

// Opt a kernel into dynamic shared memory past the default 48 KB, once a
// device and size (the host path is part of a small call's time): `id`
// names the kernel.
template <typename K>
int set_smem(K kernel, int id, size_t smem) {
  constexpr int KERNELS = 10, MAX_DEVICES = 64;
  static size_t done[KERNELS][MAX_DEVICES];
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (smem <= done[id][dev]) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  done[id][dev] = smem;
  return 0;
}

template <typename T>
int launch_tiled(const void* q, const void* k, const void* v, const float* bias,
                 const void* rel_table, int rel_bf16, const int* rel_bucket, void* out,
                 long long n_queries, int group, int heads, int m, int head_dim,
                 long long q_stride, long long kv_row_stride, long long bias_stride,
                 cudaStream_t stream) {
  const int tile = m < TILE ? m : TILE;
  // the beams a CTA: all of them where they fit, else the most that do
  int gc = group;
  while (gc > 1 && sizeof(float) * smem_floats(gc, tile, head_dim) > SMEM_MAX)
    gc = (gc + 1) / 2;
  const size_t smem = sizeof(float) * smem_floats(gc, tile, head_dim);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int rc = set_smem(decode_attention_kernel<T>, sizeof(T) == 2 ? 0 : 1, smem);
  if (rc) return rc;
  const dim3 grid((unsigned)n_queries, (unsigned)heads, (unsigned)((group + gc - 1) / gc));
  decode_attention_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, bias, rel_table, rel_bf16, rel_bucket, (T*)out,
      group, gc, heads, m, head_dim, tile, q_stride, kv_row_stride, bias_stride);
  return (int)cudaGetLastError();
}

int launch_mma(const void* q, const void* k, const void* v, const float* bias, void* out,
               long long n_queries, int group, int heads, int m, int hpc, long long q_stride,
               long long kv_row_stride, long long bias_stride, cudaStream_t stream) {
  const int C = (m + SLICE - 1) / SLICE;
  const int slice = C == 1 ? m : SLICE;
  const size_t smem = (size_t)hpc * MMA_WARP_BYTES;
  const bool two = group > 16;
  const auto kernel = two ? mma_attention_kernel<2> : mma_attention_kernel<1>;
  int rc = set_smem(kernel, two ? 9 : 8, smem);
  if (rc) return rc;
  if (C > 8) {
    static int wide_set[2][64];
    int dev = 0;
    rc = (int)cudaGetDevice(&dev);
    if (rc) return rc;
    if (dev >= 64) return (int)cudaErrorInvalidDevice;
    if (!wide_set[two][dev]) {
      rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (rc) return rc;
      wide_set[two][dev] = 1;
    }
  }
  const auto args = [&](auto kern, cudaLaunchConfig_t& cfg) {
    return cudaLaunchKernelEx(&cfg, kern, (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                              (const __nv_bfloat16*)v, bias, (__nv_bfloat16*)out, group, heads, m,
                              hpc, slice, q_stride, kv_row_stride, bias_stride);
  };
  if (C == 1) {
    kernel<<<(unsigned)(n_queries * (heads / hpc)), 32 * hpc, smem, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, bias,
        (__nv_bfloat16*)out, group, heads, m, hpc, slice, q_stride, kv_row_stride, bias_stride);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n_queries * (heads / hpc) * C));
  cfg.blockDim = dim3(32 * hpc);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = args(kernel, cfg);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// route: 0 tiled, 1 warp, 2 mma, 3 ffma (kernels/decode_attention.py:route);
// hpc: heads a CTA of the warp, mma and ffma routes (1, 2 or 4, dividing
// heads).  A route refuses the shapes it does not take.
int seal_decode_attention(const void* q, const void* k, const void* v, const float* bias,
                          const void* rel_table, int rel_bf16, const int* rel_bucket, void* out,
                          long long n_queries, int group, int heads, int m, int head_dim,
                          long long q_stride, long long kv_row_stride, long long bias_stride,
                          int bf16, int route, int hpc, void* stream) {
  if (n_queries <= 0 || group <= 0 || m <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  if (route != 0 && (head_dim != DH || hpc < 1 || hpc > 4 || heads % hpc != 0))
    return (int)cudaErrorInvalidValue;
  if (route == 1) {
    if (group != 1) return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)(n_queries * (heads / hpc));
    const int spi = bf16 ? 4 : 2;  // slots a warp instruction
    const int spl = m <= 2 * spi ? 2 : m <= 4 * spi ? 4 : 8;
    if (bf16) {
      const auto kernel = spl == 2   ? warp_attention_kernel<__nv_bfloat16, 2>
                          : spl == 4 ? warp_attention_kernel<__nv_bfloat16, 4>
                                     : warp_attention_kernel<__nv_bfloat16, 8>;
      kernel<<<blocks, 32 * hpc, 0, s>>>(
          (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, bias,
          rel_table, rel_bf16, rel_bucket, (__nv_bfloat16*)out, heads, m, hpc, q_stride,
          kv_row_stride, bias_stride);
    } else {
      const auto kernel = spl == 2   ? warp_attention_kernel<float, 2>
                          : spl == 4 ? warp_attention_kernel<float, 4>
                                     : warp_attention_kernel<float, 8>;
      kernel<<<blocks, 32 * hpc, 0, s>>>((const float*)q, (const float*)k, (const float*)v, bias,
                                         rel_table, rel_bf16, rel_bucket, (float*)out, heads, m,
                                         hpc, q_stride, kv_row_stride, bias_stride);
    }
    return (int)cudaGetLastError();
  }
  if (route == 2) {
    if (!bf16 || group < 2 || group > 32 || m > SLICE * MMA_MAX_CTAS || rel_table != nullptr)
      return (int)cudaErrorInvalidValue;
    return launch_mma(q, k, v, bias, out, n_queries, group, heads, m, hpc, q_stride,
                      kv_row_stride, bias_stride, s);
  }
  if (route == 3) {
    if (bf16 || group < 2 || group > 32 || m > FFMA_MAX_M || rel_table != nullptr)
      return (int)cudaErrorInvalidValue;
    // fewer heads a CTA where four warps' staging would pass 100 KB
    while (hpc > 1 && hpc * ffma_warp_bytes(group, m) > FFMA_MAX_CTA_BYTES) hpc >>= 1;
    const size_t smem = (size_t)hpc * ffma_warp_bytes(group, m);
    const int ppl = m <= 8 ? 8 : m <= 16 ? 16 : 32;  // lanes spanning the positions
    const int id = 2 * (ppl == 8 ? 0 : ppl == 16 ? 1 : 2) + (group > 16);
    using Kernel = void (*)(const float*, const float*, const float*, const float*, float*, int,
                            int, int, int, long long, long long, long long);
    const Kernel kernels[6] = {ffma_attention_kernel<16, 8>,  ffma_attention_kernel<32, 8>,
                               ffma_attention_kernel<16, 16>, ffma_attention_kernel<32, 16>,
                               ffma_attention_kernel<16, 32>, ffma_attention_kernel<32, 32>};
    const Kernel kernel = kernels[id];
    const int rc = set_smem(kernel, 2 + id, smem);
    if (rc) return rc;
    kernel<<<(unsigned)(n_queries * (heads / hpc)), 32 * hpc, smem, s>>>(
        (const float*)q, (const float*)k, (const float*)v, bias, (float*)out, group, heads, m,
        hpc, q_stride, kv_row_stride, bias_stride);
    return (int)cudaGetLastError();
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (bf16)
    return launch_tiled<__nv_bfloat16>(q, k, v, bias, rel_table, rel_bf16, rel_bucket, out,
                                       n_queries, group, heads, m, head_dim, q_stride,
                                       kv_row_stride, bias_stride, s);
  return launch_tiled<float>(q, k, v, bias, rel_table, rel_bf16, rel_bucket, out, n_queries,
                             group, heads, m, head_dim, q_stride, kv_row_stride, bias_stride, s);
}

}  // extern "C"
