// The port's copy of seal_tpu/cpp/agg.cpp, built into its own library
// by seal_tpu_torch/cpp/native.py.
//
// Native kernels for the evidence-aggregation hot loops.
//
// The TPU host VM is often single-core, so the per-row Python loops of the
// ranker (reference seal/keys.py:311-350 stage 1 and :397-497 stage 2)
// dominate end-to-end latency.  These kernels keep the exact sequential
// semantics:
//
//  * stage1_claim: first-come coverage claiming over corpus positions --
//    a row scores iff none of its span's positions were claimed before
//    (in row order), in which case it claims them.
//  * stage1_accumulate: the whole stage-1 pass for one query -- coverage
//    claiming, per-document score accumulation, best-single-key tracking,
//    and the per-document coverage re-scoring -- over all rare ngrams in
//    one call.
//  * ac_match: Aho-Corasick multi-pattern matching of all candidate ngrams
//    over all candidate documents, emitting (doc, pattern, start) triples --
//    the same match set the reference's streaming token trie produces.
//  * stage2_score: the full stage-2 ranker for all candidate docs -- match
//    grouping in streaming-completion order, best-single tracking, the
//    greedy maximum-score non-overlapping span assignment with repetition
//    (coverage) penalties, and the free-position unigram fallback.  The
//    reference builds a heap and pops it (keys.py:435-471); nothing is ever
//    pushed mid-loop, so processing spans in sorted order is identical.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <queue>
#include <unordered_map>
#include <vector>

extern "C" {

// covered: byte map over corpus positions (mutated). tok_ends/doc ids per
// occurrence row of one ngram, in row order.  new_flags[i] = 1 iff row i
// claimed its span [tok_ends[i]-L, tok_ends[i]).
// Spans are pre-clamped by the caller (tok_start >= 0).
int stage1_claim(uint8_t* covered, const int64_t* tok_ends, int64_t n_rows,
                 int64_t L, uint8_t* new_flags) {
  for (int64_t i = 0; i < n_rows; ++i) {
    int64_t e = tok_ends[i];
    int64_t s = e - L;
    if (s < 0) s = 0;
    bool fresh = true;
    for (int64_t j = s; j < e; ++j) {
      if (covered[j]) {
        fresh = false;
        break;
      }
    }
    new_flags[i] = fresh ? 1 : 0;
    if (fresh) {
      for (int64_t j = s; j < e; ++j) covered[j] = 1;
    }
  }
  return 0;
}

namespace {

// Coverage/repetition helpers shared by the stage kernels.  Token-id sets
// use epoch-stamped arrays (no clearing between documents/ngrams).
struct TokenSet {
  std::vector<int64_t> stamp;
  int64_t epoch = 0;
  explicit TokenSet(int64_t max_token) : stamp(size_t(max_token + 1), -1) {}
  void clear() { ++epoch; }
  bool contains(int32_t t) const { return stamp[size_t(t)] == epoch; }
  void add(int32_t t) { stamp[size_t(t)] = epoch; }
};

// repetition() (reference keys.py:188-192): score damped by the fraction of
// the ngram's distinct tokens already covered.  Mirrors the Python float
// expression order exactly.
double repetition_score(const int32_t* toks, int64_t len, double score,
                        double beta, const TokenSet& coverage,
                        int64_t coverage_size, TokenSet& scratch,
                        int64_t* out_set_len) {
  scratch.clear();
  int64_t set_len = 0, fresh = 0;
  for (int64_t k = 0; k < len; ++k) {
    int32_t t = toks[k];
    if (scratch.contains(t)) continue;
    scratch.add(t);
    ++set_len;
    if (!coverage.contains(t)) ++fresh;
  }
  if (out_set_len) *out_set_len = set_len;
  if (coverage_size == 0) return score;
  double coeff = 1.0 - beta + (beta * double(fresh) / double(set_len));
  return coeff * score;
}

// Python tuple '<' over two token sequences (element-wise, prefix-shorter
// is smaller).
bool lex_less(const int32_t* a, int64_t la, const int32_t* b, int64_t lb) {
  int64_t n = la < lb ? la : lb;
  for (int64_t k = 0; k < n; ++k) {
    if (a[k] != b[k]) return a[k] < b[k];
  }
  return la < lb;
}

}  // namespace

extern "C" {

// The complete stage-1 pass of aggregate_evidence for one query (reference
// keys.py:311-364): for each rare ngram (descending-score order, as given),
// claim occurrence spans first-come over the corpus coverage map, add the
// ngram's score once per newly-claiming document, track the best single key
// per document (every row, strict tuple-compare on (prim, score)), then
// re-score each document's matched list against its growing coverage set.
// Outputs one entry per distinct document in first-touch order; returns the
// number of distinct documents.
int64_t stage1_accumulate(
    const int32_t* pat_data, const int64_t* pat_off, const double* sco,
    const double* prim, int64_t n_ngrams, const int64_t* row_off,
    const int64_t* tok_ends, const int64_t* doc_ids, uint8_t* covered,
    double beta, double init_best_prim, int32_t allow_overlaps,
    int64_t max_token, int64_t* out_docs, double* out_scores,
    double* out_best) {
  std::unordered_map<int64_t, int32_t> slot_of;
  std::vector<int64_t> docs;
  struct Matched {
    int32_t ngram;
    double sco;
  };
  std::vector<std::vector<Matched>> matched;
  std::vector<double> best_prim, best_sco;
  std::vector<int64_t> done_stamp;  // per-doc "scored for ngram g" marker

  for (int64_t g = 0; g < n_ngrams; ++g) {
    const int64_t L = pat_off[g + 1] - pat_off[g];
    for (int64_t r = row_off[g]; r < row_off[g + 1]; ++r) {
      // first-come claiming over corpus positions (row order)
      int64_t e = tok_ends[r];
      int64_t s_pos = e - L;
      if (s_pos < 0) s_pos = 0;
      bool fresh = true;
      for (int64_t j = s_pos; j < e; ++j) {
        if (covered[j]) {
          fresh = false;
          break;
        }
      }
      if (fresh) {
        for (int64_t j = s_pos; j < e; ++j) covered[j] = 1;
      }

      int64_t doc = doc_ids[r];
      auto it = slot_of.find(doc);
      int32_t slot;
      if (it == slot_of.end()) {
        slot = int32_t(docs.size());
        slot_of.emplace(doc, slot);
        docs.push_back(doc);
        matched.emplace_back();
        best_prim.push_back(init_best_prim);
        best_sco.push_back(0.0);
        done_stamp.push_back(-1);
      } else {
        slot = it->second;
      }
      // best-single: strict (prim, sco) tuple compare, updated per row
      if (prim[g] > best_prim[slot] ||
          (prim[g] == best_prim[slot] && sco[g] > best_sco[slot])) {
        best_prim[slot] = prim[g];
        best_sco[slot] = sco[g];
      }
      if ((fresh || allow_overlaps) && done_stamp[slot] != g) {
        done_stamp[slot] = g;
        matched[slot].push_back({int32_t(g), sco[g]});
      }
    }
  }

  // per-document coverage re-scoring (reference keys.py:352-364)
  TokenSet coverage(max_token), scratch(max_token);
  for (size_t slot = 0; slot < docs.size(); ++slot) {
    coverage.clear();
    int64_t cov_size = 0;
    double total = 0.0;
    for (auto& m : matched[slot]) {
      const int32_t* toks = pat_data + pat_off[m.ngram];
      int64_t len = pat_off[m.ngram + 1] - pat_off[m.ngram];
      double new_sco = repetition_score(toks, len, m.sco, beta, coverage,
                                        cov_size, scratch, nullptr);
      total += new_sco;
      for (int64_t k = 0; k < len; ++k) {
        if (!coverage.contains(toks[k])) {
          coverage.add(toks[k]);
          ++cov_size;
        }
      }
    }
    out_docs[slot] = docs[slot];
    out_scores[slot] = total;
    out_best[slot] = best_sco[slot];
  }
  return int64_t(docs.size());
}

// Batched backward search over the host Psi layout: half-open row ranges
// for many (shifted-symbol) sequences in one call.  Replaces per-token
// numpy searchsorted chains (Python-call-bound on a 1-core host) and the
// device round-trip for small host-side batches.  Matches
// FMIndex.get_range exactly, including the no-early-exit representative of
// empty ranges.
int ranges_multi(const int32_t* psi, const int64_t* C, int64_t sigma,
                 const int32_t* seq_data, const int64_t* seq_off,
                 int64_t n_seqs, int64_t n_rows, int64_t* out_lo,
                 int64_t* out_hi) {
  auto occ = [&](int64_t c, int64_t pos) {
    const int32_t* first = psi + C[c];
    const int32_t* last = psi + C[c + 1];
    return int64_t(std::lower_bound(first, last, int32_t(pos)) - first);
  };
  for (int64_t s = 0; s < n_seqs; ++s) {
    int64_t lo = 0, hi = n_rows;
    for (int64_t k = seq_off[s]; k < seq_off[s + 1]; ++k) {
      int64_t c = seq_data[k];
      if (c < 0 || c + 1 > sigma) {
        lo = 0;
        hi = 0;
        continue;
      }
      int64_t base = C[c];
      int64_t nlo = base + occ(c, lo);
      int64_t nhi = base + occ(c, hi);
      lo = nlo;
      hi = nhi;
    }
    out_lo[s] = lo;
    out_hi[s] = hi;
  }
  return 0;
}

// The complete stage-2 ranker of aggregate_evidence (reference
// keys.py:377-497) for all candidate documents at once, fed by ac_match
// triples.  found_id encodes matched patterns as their id and fallback
// unigrams as -(token+1); entries are doc-contiguous with found_off
// boundaries.  Caller sizes found_id/found_sco to n_triples + total doc
// tokens (a hard upper bound).
int64_t stage2_score(
    const int32_t* pat_data, const int64_t* pat_off, const double* pat_sco,
    const double* pat_prim, int64_t n_pats, const int32_t* doc_data,
    const int64_t* doc_off, int64_t n_docs, const int64_t* triples,
    int64_t n_triples, const double* unigram_scores, int64_t n_unigram,
    double beta, double init_best_prim, int32_t allow_overlaps,
    int32_t unigrams_ignore_free_places, int64_t max_token,
    double* out_multi, double* out_single_best, int64_t* out_single_pat,
    double* out_unigram, int64_t* found_off, int64_t* found_id,
    double* found_sco) {
  // sort triple indices by (doc, end, pattern length): the streaming-trie
  // completion order the reference's matches dict is built in.
  // ac_match emits triples already (doc asc, end asc)-ordered -- its doc
  // scan is sequential and the output list at each position covers one end
  // -- with only tiny len-DESCENDING runs inside each (doc, end) group (a
  // node's own output precedes its fail-chain outputs, i.e. deeper first).
  // An adaptive insertion sort over precomputed (doc, end, len) arrays is
  // therefore O(n + sum run^2) instead of O(n log n) with a
  // pointer-chasing comparator; any caller that passes unordered triples
  // falls back to std::sort on the same precomputed keys (same order).
  std::vector<int64_t> order(static_cast<size_t>(n_triples), 0);
  for (int64_t i = 0; i < n_triples; ++i) order[size_t(i)] = i;
  auto plen = [&](int64_t p) { return pat_off[p + 1] - pat_off[p]; };
  const size_t nt = size_t(n_triples);
  std::vector<int32_t> t_doc(nt), t_end(nt), t_len(nt);
  bool doc_end_sorted = true;
  for (int64_t i = 0; i < n_triples; ++i) {
    int64_t p = triples[i * 3 + 1];
    int32_t L = int32_t(pat_off[p + 1] - pat_off[p]);
    t_doc[size_t(i)] = int32_t(triples[i * 3]);
    t_len[size_t(i)] = L;
    t_end[size_t(i)] = int32_t(triples[i * 3 + 2]) + L;
    if (i > 0 && (t_doc[size_t(i)] < t_doc[size_t(i - 1)] ||
                  (t_doc[size_t(i)] == t_doc[size_t(i - 1)] &&
                   t_end[size_t(i)] < t_end[size_t(i - 1)])))
      doc_end_sorted = false;
  }
  auto key_greater = [&](int64_t a, int64_t b) {
    if (t_doc[size_t(a)] != t_doc[size_t(b)])
      return t_doc[size_t(a)] > t_doc[size_t(b)];
    if (t_end[size_t(a)] != t_end[size_t(b)])
      return t_end[size_t(a)] > t_end[size_t(b)];
    return t_len[size_t(a)] > t_len[size_t(b)];
  };
  if (doc_end_sorted) {
    for (int64_t i = 1; i < n_triples; ++i) {
      int64_t oi = order[size_t(i)];
      int64_t j = i - 1;
      while (j >= 0 && key_greater(order[size_t(j)], oi)) {
        order[size_t(j + 1)] = order[size_t(j)];
        --j;
      }
      order[size_t(j + 1)] = oi;
    }
  } else {
    std::sort(order.begin(), order.end(),
              [&](int64_t a, int64_t b) { return key_greater(b, a); });
  }

  TokenSet coverage(max_token), scratch(max_token), seen(max_token);
  std::vector<int64_t> pat_entry_stamp(size_t(n_pats), -1);
  std::vector<int32_t> entry_of_pat(size_t(n_pats), -1);

  // one (score desc, pattern-lex asc) rank per pattern, computed once: the
  // per-doc greedy span sort then compares three ints instead of doubles +
  // a token-wise lex walk.  Patterns are unique upstream (all_ngrams is a
  // dict keyed by the token tuple), so (score, lex) is a strict total
  // order and rank-order == the original comparator's order exactly.
  const size_t npz = size_t(n_pats);
  std::vector<int32_t> pat_rank(npz);
  {
    std::vector<int32_t> pidx(npz);
    for (int64_t p = 0; p < n_pats; ++p) pidx[size_t(p)] = int32_t(p);
    std::sort(pidx.begin(), pidx.end(), [&](int32_t a, int32_t b) {
      if (pat_sco[a] != pat_sco[b]) return pat_sco[a] > pat_sco[b];
      return lex_less(pat_data + pat_off[a], plen(a), pat_data + pat_off[b],
                      plen(b));
    });
    for (int64_t r = 0; r < n_pats; ++r) pat_rank[size_t(pidx[size_t(r)])] = int32_t(r);
  }

  struct Span {
    int32_t pat;
    int32_t i, j;
  };
  std::vector<int32_t> entry_pats;  // per doc, insertion (completion) order
  std::vector<Span> spans;
  std::vector<uint8_t> free_map;

  int64_t found = 0;
  size_t cursor = 0;
  for (int64_t d = 0; d < n_docs; ++d) {
    found_off[d] = found;
    const int64_t dlen = doc_off[d + 1] - doc_off[d];
    const int32_t* dtoks = doc_data + doc_off[d];

    entry_pats.clear();
    spans.clear();
    while (cursor < order.size() && triples[order[cursor] * 3] == d) {
      int64_t t = order[cursor++];
      int32_t p = int32_t(triples[t * 3 + 1]);
      int32_t start = int32_t(triples[t * 3 + 2]);
      if (pat_entry_stamp[size_t(p)] != d) {
        pat_entry_stamp[size_t(p)] = d;
        entry_of_pat[size_t(p)] = int32_t(entry_pats.size());
        entry_pats.push_back(p);
      }
      spans.push_back({p, start, start + int32_t(plen(p))});
    }

    // best single key: iterate match entries in completion order with the
    // strict (prim, -score) tuple compare (reference keys.py:430-434)
    double best_prim = init_best_prim, best_sco = 0.0;
    int64_t best_pat = -1;
    for (int32_t p : entry_pats) {
      double pr = pat_prim[p], sc = pat_sco[p];
      if (pr < best_prim || (pr == best_prim && -sc < -best_sco)) {
        best_prim = pr;
        best_sco = sc;
        best_pat = p;
      }
    }
    out_single_pat[d] = best_pat;
    out_single_best[d] = best_sco;

    // greedy assignment: the reference's heap is fully built before any pop,
    // so sorted order over (-score, pattern-lex, start, end) is identical;
    // pat_rank encodes (-score, pattern-lex) as one int (see above)
    std::sort(spans.begin(), spans.end(), [&](const Span& a, const Span& b) {
      if (a.pat != b.pat) return pat_rank[size_t(a.pat)] < pat_rank[size_t(b.pat)];
      if (a.i != b.i) return a.i < b.i;
      return a.j < b.j;
    });

    coverage.clear();
    int64_t cov_size = 0;
    free_map.assign(size_t(dlen), 1);
    int32_t prev = -1;
    double prev_sco = 0.0;
    double multi = 0.0;
    int64_t doc_found_start = found;
    for (const Span& s : spans) {
      double new_s;
      if (s.pat == prev) {
        new_s = prev_sco;
      } else {
        new_s = repetition_score(pat_data + pat_off[s.pat], plen(s.pat),
                                 pat_sco[s.pat], beta, coverage, cov_size,
                                 scratch, nullptr);
      }
      if (new_s <= 0.0) continue;
      if (!allow_overlaps) {
        bool ok = true;
        for (int32_t k = s.i; k < s.j && ok; ++k) {
          if (k < 0 || k >= dlen || !free_map[size_t(k)]) ok = false;
        }
        if (!ok) continue;
      }
      if (s.pat == prev) {
        found_sco[found - 1] = new_s;  // replace-last (same value)
      } else {
        prev = s.pat;
        prev_sco = new_s;
        const int32_t* toks = pat_data + pat_off[s.pat];
        for (int64_t k = 0; k < plen(s.pat); ++k) {
          if (!coverage.contains(toks[k])) {
            coverage.add(toks[k]);
            ++cov_size;
          }
        }
        found_id[found] = s.pat;
        found_sco[found] = new_s;
        ++found;
      }
      for (int32_t k = s.i; k < s.j; ++k) {
        if (k >= 0 && k < dlen) free_map[size_t(k)] = 0;
      }
    }
    for (int64_t f = doc_found_start; f < found; ++f) multi += found_sco[f];

    // free-position unigram fallback (reference keys.py:473-491): distinct
    // free tokens in first-occurrence order; coverage is NOT extended
    if (unigrams_ignore_free_places) free_map.assign(size_t(dlen), 1);
    seen.clear();
    double unigram_total = 0.0;
    for (int64_t k = 0; k < dlen; ++k) {
      if (!free_map[size_t(k)]) continue;
      int32_t t = dtoks[k];
      // score-first: tokens with s <= 0 contribute nothing whether deduped
      // or not, so they skip the seen-set bookkeeping entirely (most of
      // the doc's tokens in practice)
      double s = (unigram_scores != nullptr && t < n_unigram && t >= 0)
                     ? unigram_scores[t]
                     : 0.0;
      if (s <= 0.0) continue;
      if (seen.contains(t)) continue;
      seen.add(t);
      {
        double s2;
        if (cov_size == 0) {
          s2 = s;
        } else {
          double coeff =
              1.0 - beta + (beta * (coverage.contains(t) ? 0.0 : 1.0) / 1.0);
          s2 = coeff * s;
        }
        if (s2 != 0.0) {
          unigram_total += s2;
          found_id[found] = -(int64_t(t) + 1);
          found_sco[found] = s2;
          ++found;
        }
      }
    }
    out_multi[d] = multi;
    out_unigram[d] = unigram_total;
  }
  found_off[n_docs] = found;
  return found;
}

}  // extern "C"

namespace {

struct Automaton {
  // goto edges keyed by (node << 32) | symbol
  std::unordered_map<uint64_t, int32_t> next;
  std::vector<int32_t> fail;
  std::vector<int32_t> out_head;   // head of pattern-output list per node
  std::vector<int32_t> out_next;   // linked list over pattern ids
  std::vector<int32_t> out_pat;
  std::vector<int32_t> depth;

  int32_t n_nodes = 1;

  int32_t step(int32_t node, int32_t sym) const {
    while (true) {
      auto it = next.find((uint64_t(node) << 32) | uint32_t(sym));
      if (it != next.end()) return it->second;
      if (node == 0) return 0;
      node = fail[node];
    }
  }
};

}  // namespace

// Patterns and docs as concatenated int32 arrays with exclusive-end offsets
// (offsets[0] = 0).  Emits triples (doc_id, pat_id, start) into out_buf
// (capacity out_cap triples).  Returns the number of triples found (which
// may exceed out_cap -- caller re-allocates and retries; out_buf holds the
// first out_cap triples).
int64_t ac_match(const int32_t* pat_data, const int64_t* pat_off, int64_t n_pats,
                 const int32_t* doc_data, const int64_t* doc_off, int64_t n_docs,
                 int64_t* out_buf, int64_t out_cap) {
  Automaton ac;
  // --- build goto trie ---------------------------------------------------
  int64_t total_len = pat_off[n_pats];
  ac.fail.reserve(total_len + 1);
  ac.depth.reserve(total_len + 1);
  ac.fail.push_back(0);
  ac.depth.push_back(0);
  ac.out_head.push_back(-1);
  for (int64_t p = 0; p < n_pats; ++p) {
    int32_t node = 0;
    for (int64_t k = pat_off[p]; k < pat_off[p + 1]; ++k) {
      uint64_t key = (uint64_t(node) << 32) | uint32_t(pat_data[k]);
      auto it = ac.next.find(key);
      if (it == ac.next.end()) {
        int32_t nn = ac.n_nodes++;
        ac.next.emplace(key, nn);
        ac.fail.push_back(0);
        ac.depth.push_back(ac.depth[node] + 1);
        ac.out_head.push_back(-1);
        node = nn;
      } else {
        node = it->second;
      }
    }
    ac.out_pat.push_back(int32_t(p));
    ac.out_next.push_back(ac.out_head[node]);
    ac.out_head[node] = int32_t(ac.out_pat.size()) - 1;
  }
  // --- BFS fail links ----------------------------------------------------
  std::queue<int32_t> q;
  std::vector<std::pair<uint64_t, int32_t>> edges(ac.next.begin(), ac.next.end());
  // collect children per node
  std::vector<std::vector<std::pair<int32_t, int32_t>>> children(ac.n_nodes);
  for (auto& kv : edges) {
    int32_t parent = int32_t(kv.first >> 32);
    int32_t sym = int32_t(kv.first & 0xffffffffu);
    children[parent].push_back({sym, kv.second});
  }
  for (auto& [sym, child] : children[0]) {
    ac.fail[child] = 0;
    q.push(child);
  }
  while (!q.empty()) {
    int32_t node = q.front();
    q.pop();
    for (auto& [sym, child] : children[node]) {
      int32_t f = ac.step(ac.fail[node], sym);
      ac.fail[child] = f;
      // merge output lists: append f's outputs after child's
      int32_t tail = ac.out_head[child];
      if (tail == -1) {
        ac.out_head[child] = ac.out_head[f];
      } else {
        while (ac.out_next[tail] != -1) tail = ac.out_next[tail];
        ac.out_next[tail] = ac.out_head[f];
      }
      q.push(child);
    }
  }
  // --- flatten to CSR + root table for the scan ---------------------------
  // The hash-map `step` costs ~150 ns/token (one uint64 hash probe per doc
  // token even when the automaton never leaves the root, which is the
  // common case); a direct-addressed root row + binary-searched per-node
  // child arrays make the root transition one array read.
  int32_t max_sym = 0;
  for (int64_t k = 0; k < pat_off[n_pats]; ++k)
    max_sym = std::max(max_sym, pat_data[k]);
  std::vector<int32_t> child_off(ac.n_nodes + 1, 0);
  for (auto& kv : ac.next) child_off[int32_t(kv.first >> 32) + 1]++;
  for (int32_t n = 0; n < ac.n_nodes; ++n) child_off[n + 1] += child_off[n];
  std::vector<int32_t> child_sym(ac.next.size()), child_node(ac.next.size());
  {
    std::vector<int32_t> cur(child_off.begin(), child_off.end() - 1);
    for (auto& kv : ac.next) {
      int32_t parent = int32_t(kv.first >> 32);
      int32_t at = cur[parent]++;
      child_sym[at] = int32_t(kv.first & 0xffffffffu);
      child_node[at] = kv.second;
    }
    for (int32_t n = 0; n < ac.n_nodes; ++n) {
      int32_t a = child_off[n], b = child_off[n + 1];
      // insertion sort of the (tiny) child run by symbol
      for (int32_t i = a + 1; i < b; ++i) {
        int32_t s = child_sym[i], c = child_node[i];
        int32_t j = i - 1;
        for (; j >= a && child_sym[j] > s; --j) {
          child_sym[j + 1] = child_sym[j];
          child_node[j + 1] = child_node[j];
        }
        child_sym[j + 1] = s;
        child_node[j + 1] = c;
      }
    }
  }
  std::vector<int32_t> root_next(size_t(max_sym) + 1, 0);
  for (int32_t i = child_off[0]; i < child_off[1]; ++i)
    root_next[child_sym[i]] = child_node[i];
  auto trans = [&](int32_t node, int32_t sym) -> int32_t {
    if (sym > max_sym) return 0;
    while (node != 0) {
      int32_t a = child_off[node], b = child_off[node + 1];
      while (a < b) {
        int32_t m = (a + b) >> 1;
        if (child_sym[m] < sym) a = m + 1;
        else b = m;
      }
      if (a < child_off[node + 1] && child_sym[a] == sym) return child_node[a];
      node = ac.fail[node];
    }
    return root_next[sym];
  };
  // --- scan documents ----------------------------------------------------
  int64_t found = 0;
  for (int64_t d = 0; d < n_docs; ++d) {
    int32_t node = 0;
    for (int64_t k = doc_off[d]; k < doc_off[d + 1]; ++k) {
      node = trans(node, doc_data[k]);
      for (int32_t o = ac.out_head[node]; o != -1; o = ac.out_next[o]) {
        int64_t pat = ac.out_pat[o];
        int64_t plen = pat_off[pat + 1] - pat_off[pat];
        int64_t pos_in_doc = k - doc_off[d];
        if (found < out_cap) {
          out_buf[found * 3 + 0] = d;
          out_buf[found * 3 + 1] = pat;
          out_buf[found * 3 + 2] = pos_in_doc - plen + 1;
        }
        ++found;
      }
    }
  }
  return found;
}
}
