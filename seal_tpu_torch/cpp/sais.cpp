// The port's copy of seal_tpu/cpp/sais.cpp, built into its own library
// by seal_tpu_torch/cpp/native.py.
//
// SA-IS suffix array construction (Nong, Zhang & Chan, "Two Efficient
// Algorithms for Linear Time Suffix Array Construction", 2009).
//
// This is the native build-path equivalent of the reference's divsufsort /
// sdsl `construct` call (the reference's seal/cpp_modules/fm_index.cpp:43-48):
// the suffix sort runs on host; rank-table materialization happens on TPU.
//
// Contract: T[n-1] must be the unique smallest symbol (the 0 sentinel).
// Exposed through a plain C ABI and loaded from Python via ctypes.

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

using idx = int64_t;

template <typename TChar>
void sais_core(const TChar* T, idx* SA, idx n, idx K) {
  // --- classify suffix types: true = S-type -------------------------------
  std::vector<bool> t(n);
  t[n - 1] = true;
  for (idx i = n - 2; i >= 0; --i)
    t[i] = (T[i] < T[i + 1]) || (T[i] == T[i + 1] && t[i + 1]);

  auto is_lms = [&](idx i) { return i > 0 && t[i] && !t[i - 1]; };

  std::vector<idx> bkt(static_cast<size_t>(K) + 1);
  auto get_buckets = [&](bool end) {
    std::fill(bkt.begin(), bkt.end(), 0);
    for (idx i = 0; i < n; ++i) bkt[T[i]]++;
    idx sum = 0;
    for (idx c = 0; c <= K; ++c) {
      sum += bkt[c];
      bkt[c] = end ? sum : sum - bkt[c];
    }
  };

  auto induce = [&]() {
    // induce L-type suffixes left-to-right
    get_buckets(false);
    for (idx i = 0; i < n; ++i) {
      idx j = SA[i] - 1;
      if (SA[i] > 0 && !t[j]) SA[bkt[T[j]]++] = j;
    }
    // induce S-type suffixes right-to-left
    get_buckets(true);
    for (idx i = n - 1; i >= 0; --i) {
      idx j = SA[i] - 1;
      if (SA[i] > 0 && t[j]) SA[--bkt[T[j]]] = j;
    }
  };

  // --- stage 1: place LMS suffixes and induce an approximate order --------
  std::fill(SA, SA + n, idx(-1));
  get_buckets(true);
  for (idx i = 1; i < n; ++i)
    if (is_lms(i)) SA[--bkt[T[i]]] = i;
  induce();

  // --- compact sorted LMS substrings and name them -------------------------
  idx n1 = 0;
  for (idx i = 0; i < n; ++i)
    if (is_lms(SA[i])) SA[n1++] = SA[i];

  std::fill(SA + n1, SA + n, idx(-1));
  idx name = 0, prev = -1;
  for (idx i = 0; i < n1; ++i) {
    idx pos = SA[i];
    bool diff = false;
    if (prev < 0) {
      diff = true;
    } else {
      for (idx d = 0; d < n; ++d) {
        if (T[pos + d] != T[prev + d] || t[pos + d] != t[prev + d]) {
          diff = true;
          break;
        }
        if (d > 0 && (is_lms(pos + d) || is_lms(prev + d))) break;
      }
    }
    if (diff) {
      ++name;
      prev = pos;
    }
    SA[n1 + pos / 2] = name - 1;
  }
  for (idx i = n - 1, j = n - 1; i >= n1; --i)
    if (SA[i] >= 0) SA[j--] = SA[i];

  // --- recurse on the reduced string if names are not yet unique ----------
  idx* SA1 = SA;
  idx* T1 = SA + n - n1;
  if (name < n1) {
    sais_core<idx>(T1, SA1, n1, name - 1);
  } else {
    for (idx i = 0; i < n1; ++i) SA1[T1[i]] = i;
  }

  // --- stage 3: induce the full order from the sorted LMS suffixes --------
  for (idx i = 1, j = 0; i < n; ++i)
    if (is_lms(i)) T1[j++] = i;  // LMS positions in text order
  for (idx i = 0; i < n1; ++i) SA1[i] = T1[SA1[i]];
  std::fill(SA + n1, SA + n, idx(-1));
  get_buckets(true);
  for (idx i = n1 - 1; i >= 0; --i) {
    idx j = SA[i];
    SA[i] = -1;
    SA[--bkt[T[j]]] = j;
  }
  induce();
}

}  // namespace

extern "C" {

// Returns 0 on success. SA must have space for n entries.
int sais_i32(const int32_t* T, int64_t n, int64_t K, int64_t* SA) {
  if (n <= 0 || K < 0) return -1;
  if (n == 1) {
    SA[0] = 0;
    return 0;
  }
  sais_core<int32_t>(T, SA, n, K);
  return 0;
}
}
