// The split-row radix select of kernel 3 (row_topk.cu, whose header sets
// out the design), shared with kernel 21's V-wide route (diverse_select.cu).
//
// The select kernel is a template on a value loader: `load(v, row, f)` maps
// the stored f32 v of element f of row `row` to the value that is ranked,
// and the select sees only what it returns.  Kernel 3 ranks the stored
// values (RawValue); kernel 21 ranks a candidate's constrained score plus
// its beam's score, under the corpus mask, computed as the slice is staged,
// so its rows are read from device memory once, as kernel 3's are; kernel
// 17's dense step (dense_scores.cu) ranks each (beam, token) candidate's
// allowed log-prob plus its beam's score.  A loader with data of its own
// beside the rows (an `Aux` type) also reads a 16-byte vector of it with
// each staged float4 and maps the four values at once (the hooks below).
// The loader inlines: RawValue leaves kernel 3's instructions as they were.
//
// The kernel is also a template on its output (MODE).  The top-k mode
// (OUT_TOPK) writes each row's top k; the k-th-value mode (OUT_KTH, kernel
// 19) stops after the three digit passes, when the row's k-th key T is
// known, and the cluster's first CTA writes T's f32 value: no survivor
// buffer, placement or index.  The warper mode (OUT_WARP, the top-k
// warper's masked log-softmax) goes on from T over the row it has staged:
// the row's max is its largest key (each CTA keeps its slice's while it
// stages it), only the values at or above T add to the sum of exps (a
// masked column holds `fill`, whose exp counts once a column), and each
// CTA writes its slice of the masked log-softmax with the min-length ban
// (WarperLoad).  Over a cluster the max and the sum are reduced through
// the first CTA's shared memory in CTA order, so the result does not
// depend on timing.  A slice not all staged re-reads its tail.
//
// radix_topk() launches one call: n_rows clusters of `splits` CTAs of
// `threads` threads (kernels/row_topk.py:plan gives the layout), writing
// each row's top k as values and int64 indices in the order, or, with
// `gbuf`, leaving the survivors unsorted in the [n_rows, n2] scratch for
// the caller's global sort (kernel 3's large-k route), or (OUT_KTH) each
// row's k-th value into vals[row], or (OUT_WARP) each row's masked
// log-softmax into vals [n_rows, width].
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "select_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_WARPS = 32;  // of a 1024-thread CTA (512 or 1024 threads)
constexpr int NB = 2048;        // bins of an 11-bit digit
constexpr int UNROLL = 4;       // 16-byte loads in flight a thread while staging
// the rounds of a loader with data of its own beside each float4 (4 rounds
// spilled and ran 14% slower on the dense step with its int4 of counts,
// and 1.5% slower with its word of the count mask)
constexpr int AUX_UNROLL = 2;
constexpr int RANK_MAX = 512;   // k up to which the output is placed by rank, not sorted
constexpr unsigned FULL = 0xffffffffu;
// the bins: the cluster's totals of the three passes (2048, 2048, 1024)
// and this CTA's histogram
constexpr int TOT1 = NB, TOT2 = 2 * NB, HIST = 2 * NB + NB / 2;
constexpr int BINS_BYTES = 4 * (HIST + NB);  // 28 KB

// the select's outputs (the MODE template argument)
constexpr int OUT_TOPK = 0, OUT_KTH = 1, OUT_WARP = 2;
constexpr int MAX_CLUSTER = 16;  // CTAs a row

struct Threshold {
  unsigned prefix, rank;
};

__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ u64 word(unsigned key, long long i) {
  return ((u64)key << 32) | (u64)(~(unsigned)i);
}

// A loader's vector hooks (see the header): `slice(row, f0, n)` is what a
// CTA works out once for its slice [f0, f0 + n) of row `row` (kept in
// registers), `fetch(row, f, sl)` reads the loader's own vector beside the
// staged float4 of elements f..f+3, and `apply4(v, a, row, f, sl)` maps the
// four values.  A loader without an `Aux` type maps each value alone.
struct NoAux {};
template <class L, class = void>
struct AuxOf {
  using type = NoAux;
};
template <class L>
struct AuxOf<L, std::void_t<typename L::Aux>> {
  using type = typename L::Aux;
};
template <class L>
struct HasAux : std::bool_constant<!std::is_same_v<typename AuxOf<L>::type, NoAux>> {};

template <class Load>
__device__ __forceinline__ auto slice_aux(const Load& load, long long row, int f0, int n) {
  if constexpr (HasAux<Load>::value) {
    return load.slice(row, f0, n);
  } else {
    return NoAux{};
  }
}

template <class Load, class A, class S>
__device__ __forceinline__ float4 apply_aux(const Load& load, float4 v, const A& a, long long row,
                                            int f, const S& sl) {
  if constexpr (HasAux<Load>::value) {
    return load.apply4(v, a, row, f, sl);
  } else {
    return make_float4(load(v.x, row, f), load(v.y, row, f + 1), load(v.z, row, f + 2),
                       load(v.w, row, f + 3));
  }
}

// The cluster barrier, split so that a CTA can work between its arrival
// and its wait; a cluster of one CTA takes the block barrier.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void sync_cluster(int C) {
  if (C == 1) {
    __syncthreads();
  } else {
    cluster_arrive();
    cluster_wait();
  }
}

// Count `digit` (< 0: no key) in the shared histogram.  Every lane of the
// warp calls it.  A warp whose keys share one digit (a -inf or NEG_INF
// row, a plateau) adds them in one atomic; otherwise each lane adds its
// own (log-prob rows spread a warp over several bins, and a match of equal
// digits costs more than the few collisions).
__device__ __forceinline__ void hist_add(unsigned* hist, int digit, int lane) {
  const int d0 = __shfl_sync(FULL, digit, 0);
  if (__all_sync(FULL, digit == d0)) {
    if (lane == 0 && d0 >= 0) atomicAdd(&hist[d0], 32u);
  } else if (digit >= 0) {
    atomicAdd(&hist[digit], 1u);
  }
}

// Append the taking lanes' words to the leader's buffer (warp-aggregated
// remote atomics).  Every lane of the warp calls it.
__device__ __forceinline__ void append(u64* buf0, unsigned* fill0, bool take, unsigned key,
                                       long long i, int lane) {
  const unsigned ball = __ballot_sync(FULL, take);
  if (!ball) return;
  unsigned base = 0;
  if (lane == 0) base = atomicAdd(fill0, (unsigned)__popc(ball));
  base = __shfl_sync(FULL, base, 0);
  if (take) buf0[base + __popc(ball & ((1u << lane) - 1u))] = word(key, i);
}

// Every thread of a CTA: the bin of the cluster's totals `tot` (nb bins, in
// the leader's shared memory) where the count from the top reaches `rank`,
// into `out`.  Thread t reads the nb / THREADS bins below
// nb - t * nb / THREADS, and a block-wide scan of their sums finds the
// thread whose bins hold the rank.
template <int THREADS>
__device__ void find_bin(const unsigned* tot, int nb, int shift, unsigned prefix, unsigned rank,
                         unsigned* warp_sum, Threshold* out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = nb / THREADS;  // 1, 2 or 4
  const int top = nb - 1 - per * tid;
  unsigned c[4] = {0, 0, 0, 0};  // this thread's bins, the highest first
  if (per == 4) {
    const uint4 v = *(const uint4*)(tot + top - 3);
    c[0] = v.w, c[1] = v.z, c[2] = v.y, c[3] = v.x;
  } else if (per == 2) {
    const uint2 v = *(const uint2*)(tot + top - 1);
    c[0] = v.y, c[1] = v.x;
  } else {
    c[0] = tot[top];
  }
  const unsigned sum = c[0] + c[1] + c[2] + c[3];
  unsigned incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned t = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += t;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  unsigned acc = incl - sum;
  for (int w = 0; w < warp; ++w) acc += warp_sum[w];
  if (acc < rank && rank <= acc + sum) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (acc + c[j] >= rank) {
        out->prefix = prefix | ((unsigned)(top - j) << shift);
        out->rank = rank - acc;
        break;
      }
      acc += c[j];
    }
  }
  __syncthreads();
}

// Descending bitonic sort of n2 (a power of two, >= 32 E) unique words in
// shared memory; padding words are 0 and sort last.  The first n2 / E
// threads (whole warps) hold E consecutive words each in registers: strides
// below E compare within a thread, strides below 32 E across the lanes of
// a warp, and only wider strides go through shared memory.
template <int E>
__device__ void sort_words(u64* w, int n2) {
  const int t = threadIdx.x;
  const bool on = t < n2 / E;
  u64 r[E];
  __syncthreads();  // the caller's writes
  if (on) {
#pragma unroll
    for (int e = 0; e < E; ++e) r[e] = w[t * E + e];
  }
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32 * E) {
        __syncthreads();
        if (on) {
#pragma unroll
          for (int e = 0; e < E; ++e) w[t * E + e] = r[e];
        }
        __syncthreads();
      }
      if (!on) continue;
      if (stride < E) {
        // s runs over the compile-time strides, so r stays in registers
#pragma unroll
        for (int s = E / 2; s > 0; s >>= 1) {
          if (s != stride) continue;
#pragma unroll
          for (int e = 0; e < E; ++e) {
            if ((e & s) == 0) {
              const bool desc = ((t * E + e) & size) == 0;
              const u64 a = r[e], b = r[e + s];
              if (desc ? a < b : a > b) {
                r[e] = b;
                r[e + s] = a;
              }
            }
          }
        }
      } else {
        const int lm = stride / E;  // the partner's lane (or thread) offset
        const bool lower = (t & lm) == 0;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int i = t * E + e;
          const u64 p = stride < 32 * E ? __shfl_xor_sync(FULL, r[e], lm) : w[i ^ stride];
          const bool keep_max = lower == ((i & size) == 0);
          r[e] = keep_max ? (p > r[e] ? p : r[e]) : (p < r[e] ? p : r[e]);
        }
      }
    }
  }
  __syncthreads();
  if (on) {
#pragma unroll
    for (int e = 0; e < E; ++e) w[t * E + e] = r[e];
  }
  __syncthreads();
}

// E words a thread: up to 4 a thread, then 8; a wider buffer (k past
// 8 * THREADS / 2) sorts in shared memory.  (k <= RANK_MAX places each
// survivor by its rank instead.)
template <int THREADS>
__device__ void sort_survivors(u64* w, int n2) {
  if (n2 <= 4 * THREADS) return sort_words<4>(w, n2);
  if (n2 <= 8 * THREADS) return sort_words<8>(w, n2);
  sort_desc<false>(w, nullptr, n2);
}

// x [rows, width]; CTA c of a row's cluster owns [c * slice, +slice) and
// stages its first `staged` keys.  Dynamic shared memory: the bins
// (BINS_BYTES; the leader's output buffer of n2 words reuses the first two
// passes' totals, or follows the bins where n2 > 2048), then the staged
// keys (rounded up to 4) from byte `region`, then `cap` candidates.
template <int THREADS, int MODE, class Load>
__global__ void __launch_bounds__(THREADS, 1024 / THREADS)
row_topk_kernel(const float* __restrict__ x, int width, int k, int slice, int staged, int cap,
                int n2, int region, u64* __restrict__ gbuf, float* __restrict__ vals,
                long long* __restrict__ idx, Load load) {
  extern __shared__ __align__(16) unsigned char topk_smem[];
  __shared__ Threshold s_res;
  __shared__ unsigned s_fill, s_ncand, s_red, s_take;
  __shared__ unsigned warp_tot[MAX_WARPS];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int c = (int)cluster.block_rank();
  const bool leader = c == 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row = blockIdx.x / C;

  unsigned* bins = (unsigned*)topk_smem;
  unsigned* hist = bins + HIST;
  // the survivors' buffer: the leader's shared memory, or (gbuf) the row's
  // global scratch, which every CTA of the row writes directly
  u64* buf = gbuf != nullptr ? gbuf + row * n2
                             : (u64*)(8 * n2 <= 4 * TOT2 ? topk_smem : topk_smem + BINS_BYTES);
  unsigned* skey = (unsigned*)(topk_smem + region);
  u64* scand = (u64*)(skey + ((staged + 3) & ~3));
  unsigned* bins0 = cluster.map_shared_rank(bins, 0);
  u64* buf0 = gbuf != nullptr ? buf : cluster.map_shared_rank(buf, 0);
  unsigned* fill0 = cluster.map_shared_rank(&s_fill, 0);

  const long long s0 = (long long)c * slice;
  const int L = (int)max(0LL, min((long long)width, s0 + slice) - s0);
  const int S = min(L, staged);  // keys staged in shared memory
  const float* xr = x + row * width + s0;
  // the key of slice element i, whose stored value is v
  const auto key_at = [&](float v, int i) { return order_key(load(v, row, (int)s0 + i)); };

  {
    uint4* z = (uint4*)(leader ? bins : hist);
    const int n4 = (leader ? HIST + NB : NB) / 4;
    for (int b = tid; b < n4; b += THREADS) z[b] = make_uint4(0, 0, 0, 0);
  }
  if (tid == 0) {
    s_fill = 0;
    s_ncand = 0;
  }
  __syncthreads();
  // arrive now, wait after the first histogram: the leader's totals are
  // zero, and every CTA has started, before the first remote access
  if (C > 1) cluster_arrive();

  bool cand_ok = false;  // the tail's candidates are in scand
  unsigned prefix = 0, mask = 0, rank = (unsigned)k;
  unsigned top = 0;  // OUT_WARP: the largest key this thread staged or streamed
  for (int pass = 0; pass < 3; ++pass) {
    const int shift = pass == 0 ? 21 : pass == 1 ? 10 : 0;
    const int nb = pass == 2 ? NB / 2 : NB;
    const unsigned dmask = (unsigned)nb - 1u;
    if (pass > 0) {
      for (int b = tid; b < nb; b += THREADS) hist[b] = 0;
      __syncthreads();
    }
    if (pass == 0) {
      // stage the slice: scalar head to 16-byte alignment and scalar
      // remainder in one round, then UNROLL float4 loads a thread a round
      int h = (int)(((16 - ((unsigned long long)xr & 15)) & 15) >> 2);
      h = min(h, S);
      const int nvec = (S - h) >> 2;
      const int rem = S - h - 4 * nvec;
      {
        const int e = tid < h ? tid : (tid < h + rem ? h + 4 * nvec + (tid - h) : -1);
        int digit = -1;
        if (e >= 0) {
          const unsigned key = key_at(__ldg(xr + e), e);
          skey[e] = key;
          digit = (int)(key >> 21);
          if constexpr (MODE == OUT_WARP) top = max(top, key);
        }
        hist_add(hist, digit, lane);
      }
      // a loader with its own vectors keeps as many bytes in flight in
      // half the rounds
      constexpr int U = HasAux<Load>::value ? AUX_UNROLL : UNROLL;
      const auto sl = slice_aux(load, row, (int)s0, L);
      const float4* xv = (const float4*)(xr + h);
      for (int base = 0; base < nvec; base += THREADS * U) {
        float4 v[U];
        typename AuxOf<Load>::type a[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int q = base + u * THREADS + tid;
          v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          a[u] = {};
          if (q < nvec) {
            v[u] = __ldg(xv + q);
            if constexpr (HasAux<Load>::value) a[u] = load.fetch(row, (int)s0 + h + 4 * q, sl);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int q = base + u * THREADS + tid;
          const bool ok = q < nvec;
          const float4 w = ok ? apply_aux(load, v[u], a[u], row, (int)s0 + h + 4 * q, sl) : v[u];
          const float f[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            int digit = -1;
            if (ok) {
              const unsigned key = order_key(f[t]);
              skey[h + 4 * q + t] = key;
              digit = (int)(key >> 21);
              if constexpr (MODE == OUT_WARP) top = max(top, key);
            }
            hist_add(hist, digit, lane);
          }
        }
      }
    } else {
      // the staged keys, four a thread
      const uint4* sk4 = (const uint4*)skey;
      const int nq = (S + 3) >> 2;
      for (int base = 0; base < nq; base += THREADS) {
        const int q = base + tid;
        uint4 kk = make_uint4(0, 0, 0, 0);
        if (q < nq) kk = sk4[q];
        const unsigned ks[4] = {kk.x, kk.y, kk.z, kk.w};
        bool ok[4], any = false;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          ok[t] = q < nq && 4 * q + t < S && (ks[t] & mask) == prefix;
          any |= ok[t];
        }
        if (!__any_sync(FULL, any)) continue;  // most warps: no key in the bucket
#pragma unroll
        for (int t = 0; t < 4; ++t) hist_add(hist, ok[t] ? (int)((ks[t] >> shift) & dmask) : -1, lane);
      }
    }
    // the tail past the staged keys: from device memory, or the candidates
    if (pass == 2 && cand_ok) {
      const int n = (int)s_ncand;
      for (int base = 0; base < n; base += THREADS) {
        const int j = base + tid;
        const unsigned key = j < n ? (unsigned)(scand[j] >> 32) : 0u;
        const bool ok = j < n && (key & mask) == prefix;
        hist_add(hist, ok ? (int)((key >> shift) & dmask) : -1, lane);
      }
    } else {
      for (int base = S; base < L; base += THREADS) {
        const int i = base + tid;
        const unsigned key = i < L ? key_at(__ldg(xr + i), i) : 0u;
        const bool ok = i < L && (key & mask) == prefix;
        hist_add(hist, ok ? (int)((key >> shift) & dmask) : -1, lane);
        if constexpr (MODE == OUT_WARP) {
          if (pass == 0) top = max(top, key);  // 0 past L: below every key
        }
        if (pass == 1 && cand_ok) {
          // keys at or above the first threshold digit: the candidates
          const bool keep = i < L && (key & 0xffe00000u) >= (prefix & 0xffe00000u);
          const unsigned ball = __ballot_sync(FULL, keep);
          if (ball) {
            unsigned at = 0;
            if (lane == 0) at = atomicAdd(&s_ncand, (unsigned)__popc(ball));
            at = __shfl_sync(FULL, at, 0);
            if (keep) scand[at + __popc(ball & ((1u << lane) - 1u))] = word(key, s0 + i);
          }
        }
      }
    }
    __syncthreads();
    // the cluster's totals in the leader: this pass's own bins (a cluster
    // of one reads its histogram)
    const int tot_at = pass == 0 ? 0 : pass == 1 ? TOT1 : TOT2;
    const unsigned* tot = hist;
    if (C > 1) {
      if (pass == 0) cluster_wait();
      for (int b = tid; b < nb; b += THREADS) {
        const unsigned v = hist[b];
        if (v) atomicAdd(bins0 + tot_at + b, v);
      }
      sync_cluster(C);
      tot = bins0 + tot_at;
    }
    find_bin<THREADS>(tot, nb, shift, prefix, rank, warp_tot, &s_res);
    prefix = s_res.prefix;
    rank = s_res.rank;
    mask |= dmask << shift;
    if (pass == 0 && S < L) {
      // the candidates fit if this slice's keys at or above the first
      // threshold digit do
      if (tid == 0) s_red = 0;
      __syncthreads();
      unsigned n = 0;
      for (int b = (int)(prefix >> 21) + tid; b < NB; b += THREADS) n += hist[b];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) n += __shfl_xor_sync(FULL, n, off);
      if (lane == 0 && n) atomicAdd(&s_red, n);
      __syncthreads();
      cand_ok = s_red <= (unsigned)cap;
    }
    __syncthreads();  // s_res and the histogram are read before they change
  }
  if constexpr (MODE == OUT_KTH) {
    // prefix is the row's k-th key T.  Every CTA has read the leader's
    // last totals once the cluster has met; then the leader writes T's
    // value (key_value inverts order_key: the row's own bits).
    sync_cluster(C);
    if (leader && tid == 0) vals[row] = key_value((u64)prefix << 32);
    return;
  }
  if constexpr (MODE == OUT_WARP) {
    // prefix is the row's k-th key T: a value x survives the warper where
    // !(x < T) in f32, so key >= T, and -0.0 also where T is +0.0
    __shared__ unsigned w_top[MAX_CLUSTER], w_cnt[MAX_CLUSTER];
    __shared__ float w_sum[MAX_CLUSTER], w_stat[2];
    const unsigned keep = prefix == 0x80000000u ? 0x7fffffffu : prefix;
    const auto key_of = [&](int i) { return i < S ? skey[i] : key_at(__ldg(xr + i), i); };
    // the row's max: each CTA's largest key, then the cluster's in the leader
    top = __reduce_max_sync(FULL, top);
    if (lane == 0) warp_tot[warp] = top;
    __syncthreads();
    if (tid == 0) {
      unsigned m = 0;
      for (int w = 0; w < THREADS / 32; ++w) m = max(m, warp_tot[w]);
      (C == 1 ? w_top : cluster.map_shared_rank(w_top, 0))[c] = m;
    }
    sync_cluster(C);
    if (tid == 0) {
      const unsigned* tops = C == 1 ? w_top : cluster.map_shared_rank(w_top, 0);
      unsigned m = 0;
      for (int r = 0; r < C; ++r) m = max(m, tops[r]);
      w_stat[0] = key_value((u64)m << 32);
    }
    __syncthreads();
    const float mx = w_stat[0];
    // the survivors' sum of exps and count: each CTA's in a fixed order,
    // the staged keys four at a time (a warp whose keys all fall below T
    // moves on), then a streamed tail
    float s = 0.f;
    unsigned n = 0;
    const uint4* sk4 = (const uint4*)skey;
    const int nq = (S + 3) >> 2;
    for (int base = 0; base < nq; base += THREADS) {
      const int q = base + tid;
      uint4 kk = make_uint4(0, 0, 0, 0);
      if (q < nq) kk = sk4[q];
      const unsigned ks[4] = {kk.x, kk.y, kk.z, kk.w};
      bool sv[4], any = false;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        sv[t] = q < nq && 4 * q + t < S && ks[t] >= keep;
        any |= sv[t];
      }
      if (!__any_sync(FULL, any)) continue;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (sv[t]) {
          s += expf(key_value((u64)ks[t] << 32) - mx);
          ++n;
        }
      }
    }
    for (int i = S + tid; i < L; i += THREADS) {
      const unsigned key = key_at(__ldg(xr + i), i);
      if (key >= keep) {
        s += expf(key_value((u64)key << 32) - mx);
        ++n;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(FULL, s, off);
      n += __shfl_xor_sync(FULL, n, off);
    }
    // the block's sum in warp order (the warps' sums in this CTA's
    // histogram, which no CTA reads any more), then the cluster's in CTA
    // order
    if (lane == 0) {
      warp_tot[warp] = n;
      hist[warp] = __float_as_uint(s);
    }
    __syncthreads();
    if (tid == 0) {
      float bs = 0.f;
      unsigned bn = 0;
      for (int w = 0; w < THREADS / 32; ++w) {
        bs += __uint_as_float(hist[w]);
        bn += warp_tot[w];
      }
      (C == 1 ? w_sum : cluster.map_shared_rank(w_sum, 0))[c] = bs;
      (C == 1 ? w_cnt : cluster.map_shared_rank(w_cnt, 0))[c] = bn;
    }
    sync_cluster(C);
    if (tid == 0) {
      const float* sums = C == 1 ? w_sum : cluster.map_shared_rank(w_sum, 0);
      const unsigned* cnts = C == 1 ? w_cnt : cluster.map_shared_rank(w_cnt, 0);
      float tot = 0.f;
      long long kept = 0;
      for (int r = 0; r < C; ++r) {
        tot += sums[r];
        kept += cnts[r];
      }
      // each masked column adds exp(fill - max) (0 unless the row's max is
      // within ~100 of fill)
      tot += (float)(width - kept) * expf(load.fill - mx);
      w_stat[1] = logf(tot);
    }
    __syncthreads();
    // the leader's partials have been read: a CTA may leave once the
    // cluster has met again, after its writes
    if (C > 1) cluster_arrive();
    const float log_s = w_stat[1];
    const float masked = (load.fill - mx) - log_s;
    float* orow = vals + row * width + s0;
    const auto out_of = [&](unsigned key, int i) {
      const float y = key >= keep ? (key_value((u64)key << 32) - mx) - log_s : masked;
      return (int)s0 + i == load.ban ? load.fill : y;
    };
    // the head to 16-byte alignment (the staging's: the logits and the
    // output share their rows' alignment) and the tail, one at a time
    const int h = min((int)(((16 - ((unsigned long long)orow & 15)) & 15) >> 2), S);
    const int nvec = (S - h) >> 2;
    if (tid < h) orow[tid] = out_of(skey[tid], tid);
    for (int i = h + 4 * nvec + tid; i < L; i += THREADS) orow[i] = out_of(key_of(i), i);
    // the rest a float4 at a time: staged words h + 4v .. h + 4v + 3, from
    // the aligned vectors v and v + 1 (read as words past the staged region)
    const int words = (staged + 3) & ~3;
    float4* o4 = (float4*)(orow + h);
    const int ban_at = load.ban - (int)s0 - h;  // the banned column's place past the head
    for (int base = 0; base < nvec; base += THREADS) {
      const int v = base + tid;
      const bool ok = v < nvec;
      uint4 kk = make_uint4(0, 0, 0, 0);
      if (ok) {
        const uint4 a = sk4[v];
        uint4 b = make_uint4(0, 0, 0, 0);
        if (h > 0) {
          if (4 * v + 8 <= words) {
            b = sk4[v + 1];
          } else {
            b.x = skey[4 * v + 4];
            if (h > 1) b.y = skey[4 * v + 5];
            if (h > 2) b.z = skey[4 * v + 6];
          }
        }
        kk = h == 0 ? a
           : h == 1 ? make_uint4(a.y, a.z, a.w, b.x)
           : h == 2 ? make_uint4(a.z, a.w, b.x, b.y)
                    : make_uint4(a.w, b.x, b.y, b.z);
      }
      const unsigned ks[4] = {kk.x, kk.y, kk.z, kk.w};
      float y[4] = {masked, masked, masked, masked};
      bool any = false;
#pragma unroll
      for (int t = 0; t < 4; ++t) any |= ok && ks[t] >= keep;
      if (__any_sync(FULL, any)) {
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (ok && ks[t] >= keep) y[t] = (key_value((u64)ks[t] << 32) - mx) - log_s;
      }
      if (ok) {
        const int b = ban_at - 4 * v;
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (b == t) y[t] = load.fill;
        o4[v] = make_float4(y[0], y[1], y[2], y[3]);
      }
    }
    if (C > 1) cluster_wait();
    return;
  }
  // prefix is T; the top k holds every key above it and the first `rank`
  // of the keys equal to it, in index order over the slices: this CTA's
  // share follows the counts of the CTAs before it (their last histograms)
  const unsigned T = prefix;
  const unsigned my_eq = hist[T & 1023u];
  if (tid == 0) {
    long long before = 0;
    for (int r = 0; r < c; ++r) before += cluster.map_shared_rank(hist, r)[T & 1023u];
    const long long t = (long long)rank - before;
    s_take = (unsigned)(t < 0 ? 0 : (t > (long long)my_eq ? (long long)my_eq : t));
  }
  __syncthreads();
  const unsigned take_eq = s_take;

  if (take_eq == 0 || take_eq == my_eq) {
    const bool all_eq = take_eq != 0;
    const uint4* sk4 = (const uint4*)skey;
    const int nq = (S + 3) >> 2;
    for (int base = 0; base < nq; base += THREADS) {
      const int q = base + tid;
      uint4 kk = make_uint4(0, 0, 0, 0);
      if (q < nq) kk = sk4[q];
      const unsigned ks[4] = {kk.x, kk.y, kk.z, kk.w};
      bool take[4], any = false;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        take[t] = q < nq && 4 * q + t < S && (ks[t] > T || (all_eq && ks[t] == T));
        any |= take[t];
      }
      if (!__any_sync(FULL, any)) continue;
#pragma unroll
      for (int t = 0; t < 4; ++t) append(buf0, fill0, take[t], ks[t], s0 + 4 * q + t, lane);
    }
    if (cand_ok) {
      const int n = (int)s_ncand;
      for (int base = 0; base < n; base += THREADS) {
        const int j = base + tid;
        const u64 w = j < n ? scand[j] : 0ull;
        const unsigned key = (unsigned)(w >> 32);
        const bool take = j < n && (key > T || (all_eq && key == T));
        append(buf0, fill0, take, key, key_slot(w), lane);
      }
    } else {
      for (int base = S; base < L; base += THREADS) {
        const int i = base + tid;
        const unsigned key = i < L ? key_at(__ldg(xr + i), i) : 0u;
        append(buf0, fill0, i < L && (key > T || (all_eq && key == T)), key, s0 + i, lane);
      }
    }
  } else {
    // a partial share of the equal keys: the first take_eq in index order
    unsigned seen = 0;
    for (int base = 0; base < L; base += THREADS) {
      const int i = base + tid;
      unsigned key = 0;
      if (i < L) key = i < S ? skey[i] : key_at(__ldg(xr + i), i);
      const bool is_eq = i < L && key == T;
      const unsigned ball = __ballot_sync(FULL, is_eq);
      if (lane == 0) warp_tot[warp] = __popc(ball);
      __syncthreads();
      unsigned before = seen + __popc(ball & ((1u << lane) - 1u)), chunk = 0;
      for (int w = 0; w < THREADS / 32; ++w) {
        if (w < warp) before += warp_tot[w];
        chunk += warp_tot[w];
      }
      __syncthreads();
      seen += chunk;
      append(buf0, fill0, i < L && (key > T || (is_eq && before < take_eq)), key, s0 + i, lane);
    }
  }
  // every survivor is in the leader's buffer, and no CTA reads another's
  // histogram any more
  sync_cluster(C);
  if (!leader) return;
  if (gbuf != nullptr) {  // padding for the global sort (the survivors fill [0, k))
    for (int j = k + tid; j < n2; j += THREADS) buf[j] = 0ull;
    return;
  }
  if (k <= RANK_MAX) {
    // each survivor's place is the number of survivors above it (words are
    // unique): k read passes over the buffer, cheaper than a sort at small k
    if (tid < k) {
      const u64 wi = buf[tid];
      int above = 0;
#pragma unroll 4
      for (int j = 0; j < k; ++j) above += buf[j] > wi;
      vals[row * k + above] = key_value(wi);
      idx[row * k + above] = (long long)key_slot(wi);
    }
    return;
  }
  for (int j = k + tid; j < n2; j += THREADS) buf[j] = 0ull;
  sort_survivors<THREADS>(buf, n2);
  for (int j = tid; j < k; j += THREADS) {
    const u64 w = buf[j];
    vals[row * k + j] = key_value(w);
    idx[row * k + j] = (long long)key_slot(w);
  }
}

// n / d for any 32-bit n by a multiply and shifts (Granlund and Montgomery,
// "Division by invariant integers using multiplication", 1994, fig. 4.1):
// the loaders' beam of a flat index
struct FastDiv {
  unsigned m;
  int s1, s2;
  explicit FastDiv(unsigned d) {
    int l = 0;
    while ((1ull << l) < d) ++l;
    m = (unsigned)((((1ull << l) - d) << 32) / d + 1);
    s1 = l < 1 ? l : 1;
    s2 = l > 1 ? l - 1 : 0;
  }
  __device__ __forceinline__ unsigned operator()(unsigned n) const {
    const unsigned t = __umulhi(m, n);
    return (t + ((n - t) >> s1)) >> s2;
  }
};

// n / d for any 64-bit n, the same way with 64-bit words: the flat index's
// row where rows * width may pass 2^31 (kernel 17's streaming pass)
struct FastDiv64 {
  unsigned long long m;
  int s1, s2;
  explicit FastDiv64(unsigned long long d) {
    int l = 0;
    while ((1ull << l) < d) ++l;
    m = (unsigned long long)((((unsigned __int128)((1ull << l) - d)) << 64) / d + 1);
    s1 = l < 1 ? l : 1;
    s2 = l > 1 ? l - 1 : 0;
  }
  __device__ __forceinline__ unsigned long long operator()(unsigned long long n) const {
    const unsigned long long t = __umul64hi(m, n);
    return (t + ((n - t) >> s1)) >> s2;
  }
};

// the stored value as it is (kernels 3 and 19)
struct RawValue {
  __device__ __forceinline__ float operator()(float v, long long, int) const { return v; }
};

// the warper mode's loader: the stored value as it is, with the column
// banned after the normalization (-1: none) and the masking value
struct WarperLoad {
  int ban;
  float fill;
  __device__ __forceinline__ float operator()(float v, long long, int) const { return v; }
};

template <int THREADS, int MODE, class Load>
int launch_select(const float* x, long long n_rows, int width, int k, int splits, int slice,
                  int staged, int cap, int n2, int region, int smem, u64* gbuf, float* vals,
                  long long* idx, Load load, cudaStream_t stream) {
  const auto kernel = row_topk_kernel<THREADS, MODE, Load>;
  // the kernel's attributes, set once a device (the host path is part of a
  // small call's time): the shared memory opted into so far, all of the
  // SM's 228 KB as shared memory so that several CTAs fit, and clusters of
  // 16
  constexpr int MAX_DEVICES = 64;
  static int smem_set[MAX_DEVICES], wide_set[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = smem;
  }
  if (splits > 8 && !wide_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    wide_set[dev] = 1;
  }
  if (splits == 1) {
    // a cluster of one CTA: a plain launch (cudaLaunchKernelEx with a
    // cluster attribute costs the host more)
    kernel<<<(unsigned)n_rows, THREADS, smem, stream>>>(x, width, k, slice, staged, cap, n2,
                                                        region, gbuf, vals, idx, load);
    err = cudaGetLastError();
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(n_rows * splits));
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)splits;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, x, width, k, slice, staged, cap, n2, region, gbuf,
                             vals, idx, load);
    if (err == cudaSuccess) err = cudaGetLastError();
  }
  return (int)err;
}

// MODE: OUT_TOPK (vals, idx [n_rows, k], or gbuf), OUT_KTH (vals
// [n_rows]; gbuf and idx unused) or OUT_WARP (vals [n_rows, width], a
// WarperLoad; gbuf and idx unused)
template <int MODE = OUT_TOPK, class Load>
int radix_topk(const float* x, long long n_rows, int width, int k, int threads, int splits,
               int slice, int staged, int cap, int n2, int region, int smem, u64* gbuf,
               float* vals, long long* idx, Load load, cudaStream_t stream) {
  if (threads == 1024)
    return launch_select<1024, MODE>(x, n_rows, width, k, splits, slice, staged, cap, n2, region,
                                    smem, gbuf, vals, idx, load, stream);
  return launch_select<512, MODE>(x, n_rows, width, k, splits, slice, staged, cap, n2, region,
                                 smem, gbuf, vals, idx, load, stream);
}

}  // namespace
