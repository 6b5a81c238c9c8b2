"""Key scoring and evidence aggregation (counterpart of
``seal_tpu/scoring/keys.py``).

* ``deduplicate``, ``strip``, ``decompose_query_into_keys`` and ``_pad_to``
  are copies of the JAX module's (which imports jax); the tokenizer of the
  decomposition is the port's ``regex``-free ``word_tokenize``.
* ``rescore_keys``: the teacher-forced log-prob of each key.  The queries
  are encoded once; each sub-batch of keys gathers its queries' encoder
  rows, runs ``bart.decode_full`` and reduces the logits to one score per
  key with kernel 7 (``kernels/rescore.py``).  The JAX function pads the
  last sub-batch to the full size to keep one compiled shape; eager torch
  needs no such padding.
* ``compute_unigram_scores``: one teacher-forced decoder position's
  full-vocab log-softmax per query, through kernel 4
  (``kernels/triton_logsoftmax.py``), then f64 on the host.
* ``_stable_top_k_desc``, ``_log_odds_score`` and ``aggregate_evidence``
  (the host ranker: numpy and the C++ helpers of ``seal_tpu.cpp.native``)
  are copied line for line from ``seal_tpu/scoring/keys.py:237-749``;
  nothing in them differs but the imports.  The tests hold the copy's
  output identical to the original's.
"""

from __future__ import annotations

import math
from collections import defaultdict
from itertools import chain, product
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from seal_tpu_torch.kernels.rescore import rescore_logprob
from seal_tpu_torch.kernels.triton_logsoftmax import log_softmax_ban
from seal_tpu_torch.models import bart
from seal_tpu_torch.models.tokenizer import word_tokenize


# --------------------------------------------------------------------- utils


def deduplicate(list_of_lists):
    """Order-preserving dedup of keys / (score, key) pairs
    (parity: reference ``keys.py:19-35``)."""
    present = set()
    result = []
    for el in list_of_lists:
        x = el
        if el and isinstance(el[0], float):
            el = el[1]
        t_el = tuple(int(t) for t in el)
        if t_el in present:
            continue
        present.add(t_el)
        result.append(x)
    return result


def strip(seq, symbols_start, symbols_end):
    """Trim marker symbols from both ends (parity: ``keys.py:54-61``)."""
    i = 0
    while i < len(seq) and seq[i] in symbols_start:
        i += 1
    j = len(seq)
    while j > i and seq[j - 1] in symbols_end:
        j -= 1
    return seq[i:j]


def decompose_query_into_keys(query: str, length: int = 3) -> List[str]:
    """All <=length-word spans of the query in every capitalization variant,
    with a leading space (parity: ``keys.py:38-51``; the spaCy tokenizer is
    replaced by a word tokenizer)."""
    strings = set()
    tokens = word_tokenize(query.strip())
    for i in range(len(tokens)):
        for j in range(i + 1, min(1 + len(tokens), i + length + 1)):
            span = tokens[i:j]
            for upper in product(*([[True, False]] * (j - i))):
                ss = [s[0].upper() + s[1:] if u else s for u, s in zip(upper, span)]
                strings.add(" " + " ".join(ss))
    return list(strings)


# ---------------------------------------------------------------- LM scoring


def _pad_to(seqs: Sequence[Sequence[int]], pad: int, multiple: int = 8):
    """Right-pad to a length bucket (a multiple of 8)."""
    maxlen = max(len(s) for s in seqs)
    maxlen = ((maxlen + multiple - 1) // multiple) * multiple
    ids = np.full((len(seqs), maxlen), pad, np.int32)
    for i, s in enumerate(seqs):
        ids[i, : len(s)] = s
    return ids


def rescore_keys(
    model_cfg,
    params,
    inputs: Optional[Sequence[Sequence[int]]],
    list_of_decoded: Sequence[Sequence],
    batch_size: int = 256,
    length_penalty: float = 0.0,
    prefix: Sequence[int] = (),
    strip_from_bos: Sequence[int] = (),
    strip_from_eos: Sequence[int] = (),
) -> List[List[Tuple[float, List[int]]]]:
    """Per-query [(score, key), ...] with teacher-forced LM scores, on the
    device of ``params``.

    Accepts keys as token lists or (score, key) pairs (rescored), exactly
    like the reference.
    """
    start = model_cfg.decoder_start_token_id
    pad = model_cfg.pad_token_id
    if inputs is None:
        inputs = [[model_cfg.bos_token_id, model_cfg.eos_token_id]] * len(list_of_decoded)
    inputs = [list(i) for i in inputs]
    list_of_decoded = [
        [list(x[1]) if (x and isinstance(x[0], float)) else list(x) for x in xx]
        for xx in list_of_decoded
    ]

    jobs = []  # (query_idx, original_key, decoder_ids)
    for qi, keys in enumerate(list_of_decoded):
        for di in keys:
            stripped = strip(di, strip_from_bos, strip_from_eos)
            dec = [start] + list(prefix) + list(stripped)
            jobs.append((qi, di, dec))

    all_out: Dict[int, List[Tuple[float, List[int]]]] = {
        i: [] for i in range(len(list_of_decoded))
    }
    if not jobs:
        return [all_out[i] for i in range(len(list_of_decoded))]
    dev = params["shared"].device
    pending = []  # launch every sub-batch, then fetch once
    with torch.inference_mode():
        enc_ids = torch.as_tensor(_pad_to(inputs, pad), device=dev)
        enc_mask = (enc_ids != pad).to(torch.int32)
        enc_out = bart.encode(model_cfg, params, enc_ids, enc_mask)
        for off in range(0, len(jobs), batch_size):
            batch = jobs[off : off + batch_size]
            dec_ids = torch.as_tensor(_pad_to([d for _, _, d in batch], pad), device=dev)
            qidx = torch.as_tensor([q for q, _, _ in batch], device=dev)
            logits = bart.decode_full(
                model_cfg, params, enc_out[qidx], enc_mask[qidx], dec_ids[:, :-1]
            )
            pending.append((batch, rescore_logprob(logits, dec_ids[:, 1:], len(prefix))))
            del logits  # [256, T, V] f32: free it before the next sub-batch
        fetched = torch.cat([lls for _, lls in pending]).cpu().tolist()
    lls = iter(fetched)
    for batch, _ in pending:
        for qi, di, _ in batch:
            ll = next(lls)
            sco = float(ll) / (len(di) ** length_penalty) if di else float(ll)
            all_out[qi].append((sco, di))
    return [all_out[i] for i in range(len(list_of_decoded))]


def compute_unigram_scores(
    model_cfg,
    params,
    inputs: Sequence[Sequence[int]],
    temperature: float = 1.0,
    prefix: Sequence[int] = (),
    tolist: bool = True,
):
    """First-step (optionally after ``prefix``) full-vocab log-probs per
    query (parity: ``keys.py:144-176``), on the device of ``params``."""
    pad = model_cfg.pad_token_id
    dec = np.full((len(inputs), 1 + len(prefix)), model_cfg.decoder_start_token_id, np.int32)
    for i, t in enumerate(prefix, start=1):
        dec[:, i] = t
    dev = params["shared"].device
    with torch.inference_mode():
        ids = torch.as_tensor(_pad_to([list(i) for i in inputs], pad), device=dev)
        mask = (ids != pad).to(torch.int32)
        enc = bart.encode(model_cfg, params, ids, mask)
        logits = bart.decode_full(model_cfg, params, enc, mask, torch.as_tensor(dec, device=dev))
        lp = log_softmax_ban(logits[:, len(prefix)], -1, 0.0)
    lp = lp.cpu().numpy().astype(np.float64)
    if temperature != 1.0:
        lp = lp / temperature  # parity note: reference divides logits pre-softmax
    if tolist:
        return lp.tolist()
    return lp


# ------------------------------------------------------------------- ranking


def _stable_top_k_desc(u: np.ndarray, k: int) -> np.ndarray:
    """Indices of the ``k`` largest values in (value desc, index asc) order
    -- identical output to ``np.argsort(-u, kind="stable")[:k]`` at
    O(V + k log k) instead of a full stable sort (runs per query on a
    vocab-sized vector in ``aggregate_evidence``)."""
    if k <= 0:
        # k == 0 happens whenever a query ends up with zero scored keys
        # (every decoded key filtered out) and unigram budgeting scales by
        # the key count; np.partition(u, u.size) would raise
        return np.empty(0, dtype=np.intp)
    if k >= u.size:
        return np.argsort(-u, kind="stable")
    t = np.partition(u, u.size - k)[u.size - k]  # k-th largest value
    gt = np.flatnonzero(u > t)  # at most k-1 of these
    eq = np.flatnonzero(u == t)[: k - gt.size]
    cand = np.concatenate([gt, eq])
    return cand[np.lexsort((cand, -u[cand]))]


def _log_odds_score(sr: float, count: int, ntokens: float, smoothing: float,
                    alpha: float, length_penalty: float, ngram_len: int) -> float:
    """The LM-vs-corpus log-odds key score (``keys.py:216-227``)."""
    sr = sr - 1e-10
    sr *= (1.0 - length_penalty) ** (ngram_len - 1.0)
    snr = math.log((count + smoothing) / (ntokens + smoothing))
    sco = (sr + math.log1p(-math.exp(snr))) - (snr + math.log1p(-math.exp(sr)))
    sco = max(sco, 0.0)
    return sco ** alpha


def aggregate_evidence(
    ngrams_and_scores: List[Tuple[List[int], float]],
    unigram_scores: Optional[List[float]] = None,
    index=None,  # host FMIndex (or anything with its query API)
    max_occurrences_1: int = 1500,
    max_occurrences_2: int = 10_000_000,
    n_docs_complete_score: int = 500,
    alpha: float = 2.0,
    beta: float = 0.8,
    length_penalty: float = 0.0,
    use_fm_index_frequency: bool = True,
    add_best_unigrams_to_ngrams: bool = False,
    use_top_k_unigrams: int = 1000,
    sort_by_length: bool = False,
    sort_by_freq: bool = False,
    smoothing: float = 5.0,
    allow_overlaps: bool = False,
    single_key: float = 0.0,
    single_key_add_unigrams: bool = False,
    unigrams_ignore_free_places: bool = False,
    range_fn=None,  # optional batched List[ngram] -> [(lo, hi), ...] (device)
    collect_found: bool = True,
):
    """Aggregate key scores into ranked documents.

    Returns (results, all_ngrams): ``results[doc] = [score, matched_ngrams,
    None, doc_tokens, best_single_ngram]`` sorted by descending score --
    the reference's layout (``keys.py:493-497``) so downstream consumers
    are drop-in, with ONE documented difference: ``doc_tokens`` is an int
    *sequence* that may be a read-only numpy view rather than a Python
    list (converting all ``n_docs_complete_score`` token lists dominated
    the stage-2 frame; only the final top-k are ever read -- call
    ``list()``/``.tolist()`` if you need list semantics, as
    ``batch_search`` does).

    ``collect_found=False`` (TPU-serving extension; scores unchanged)
    skips materializing ``matched_ngrams`` -- building one (pattern,
    score) tuple per match for every fully-scored doc was ~30% of this
    function's wall time, and ``batch_search`` only reads the lists when
    ``include_keys`` is on.  With it off, ``matched_ngrams`` stays ``[]``.
    """

    def repetition(ngram_set, score, coverage):
        if not coverage:
            return score
        coeff = 1.0 - beta + (beta * len(ngram_set.difference(coverage)) / len(ngram_set))
        return coeff * score

    ntokens = float(index.beginnings[-1])
    ngrams_and_scores = [
        (list(ngram), float(sr)) for ngram, sr in ngrams_and_scores
    ]
    counts: Dict[tuple, int] = {(): len(index)}

    if not use_fm_index_frequency:
        cutoff = sorted(ngrams_and_scores, key=lambda x: x[1])[0][1] - 0.1
    else:
        cutoff = None

    # ranges (and thus counts) for every input ngram in one batched call
    # when a device range_fn is provided (the TPU host is often 1-core; the
    # per-ngram searchsorted chain dominates otherwise)
    ranges_pre: Dict[tuple, Tuple[int, int]] = {}
    if ngrams_and_scores:
        uniq = list({tuple(n) for n, _ in ngrams_and_scores})
        if range_fn is not None:
            ranges = range_fn([list(n) for n in uniq])
        elif hasattr(index, "get_ranges_batch"):
            ranges = index.get_ranges_batch([list(n) for n in uniq])
        else:
            ranges = None
        if ranges is not None:
            for n, r in zip(uniq, ranges):
                ranges_pre[n] = (int(r[0]), int(r[1]))

    def get_range_cached(ngram_t: tuple) -> Tuple[int, int]:
        r = ranges_pre.get(ngram_t)
        if r is None:
            r = index.get_range(list(ngram_t))
            ranges_pre[ngram_t] = r
        return r

    # ---- key scores ------------------------------------------------------
    unigrams = {0, 1, 2}
    scored: List[Tuple[List[int], float]] = []
    for ngram, sr in ngrams_and_scores:
        if len(ngram) == 1:
            unigrams.add(ngram[0])
        lo_, hi_ = get_range_cached(tuple(ngram))
        count = hi_ - lo_
        counts[tuple(ngram)] = count
        if count == 0:
            sco = 0.0
        elif use_fm_index_frequency:
            sco = _log_odds_score(sr, count, ntokens, smoothing, alpha, length_penalty, len(ngram))
        else:
            sco = max(sr - cutoff, 0.0)
            sco *= (1.0 - length_penalty) ** (len(ngram) - 1.0)
            sco **= alpha
        scored.append((ngram, sco))
    ngrams_and_scores = scored

    # ---- unigram scores (vectorized; reference keys.py:236-278) ----------
    if unigram_scores is not None:
        u = np.asarray(unigram_scores, np.float64).copy()
        V_u = u.size
        # top-k selection with the reference's tie order (stable descending:
        # equal values keep ascending index)
        if use_top_k_unigrams < V_u:
            top = _stable_top_k_desc(u, use_top_k_unigrams)
        else:
            top = np.arange(V_u)
        # O(1) single-token counts via the C array when available (the
        # reference walks the index for every vocab entry, keys.py:252)
        count1 = getattr(index, "token_count", lambda i: index.get_count([i]))
        out = np.zeros(V_u, np.float64)
        sel = top[~np.isin(top, np.fromiter(unigrams, np.int64, len(unigrams)))]
        if hasattr(index, "token_counts"):
            cnt = index.token_counts(sel)
        else:
            cnt = np.fromiter((count1(int(i)) for i in sel), np.int64, sel.size)
        nz = cnt > 0
        sel, cnt = sel[nz], cnt[nz]
        sr_v = u[sel]
        if use_fm_index_frequency:
            # note: the reference applies no alpha exponent here
            # (keys.py:255-261); sr >= 0 falls into the reference's
            # ValueError branch (log of a non-positive) -> score 0
            snr_v = np.log((cnt + smoothing) / (ntokens + smoothing))
            with np.errstate(divide="ignore", invalid="ignore"):
                sco_v = (sr_v + np.log1p(-np.exp(snr_v))) - (
                    snr_v + np.log1p(-np.exp(sr_v))
                )
            sco_v = np.where(sr_v < 0.0, np.maximum(sco_v, 0.0), 0.0)
        else:
            sco_v = np.maximum(sr_v - cutoff, 0.0) ** alpha
        out[sel] = sco_v
        unigram_scores = out

        if add_best_unigrams_to_ngrams:
            best_unigrams = _stable_top_k_desc(out, len(ngrams_and_scores))
            has_tr = hasattr(index, "token_range")
            for i in best_unigrams.tolist():
                counts[(i,)] = count1(i)
                if has_tr and (i,) not in ranges_pre:
                    # O(1) C-array block == get_range([i]) exactly; keeps
                    # these unigrams off the per-ngram searchsorted chain
                    ranges_pre[(i,)] = index.token_range(i)
                ngrams_and_scores.append(([i], float(out[i])))

    # ---- rare / frequent split (keys.py:280-309) -------------------------
    rare_ngrams: Dict[tuple, float] = defaultdict(float)
    freq_ngrams: Dict[tuple, float] = defaultdict(float)
    for ngram, sco in ngrams_and_scores:
        count = counts.get(tuple(ngram))
        if count is None:
            count = index.get_count(ngram)
            counts[tuple(ngram)] = count
        if count > max_occurrences_2 or sco == 0.0:
            continue
        target = freq_ngrams if (count > max_occurrences_1 or sco < 0.0) else rare_ngrams
        target[tuple(ngram)] = sco

    rare_ngrams = dict(sorted(rare_ngrams.items(), key=lambda x: x[1], reverse=True))
    freq_ngrams = dict(sorted(freq_ngrams.items(), key=lambda x: x[1], reverse=True))
    all_ngrams = dict(
        sorted(chain(rare_ngrams.items(), freq_ngrams.items()), key=lambda x: x[1], reverse=True)
    )

    # ---- stage 1: rare-ngram occurrence sampling (keys.py:311-364) -------
    n_corpus = int(index.beginnings[-1]) + getattr(index, "n_sentinels", 1)
    covered = np.zeros(n_corpus + 2, dtype=np.uint8)  # vectorized covered_points

    try:
        from seal_tpu.cpp import native as _native

        nat = _native.load()
    except Exception:  # pragma: no cover - g++ unavailable
        nat = None

    rare_list = list(rare_ngrams.items())
    # occurrence rows (vectorized locate; the reference walks a sampled SA
    # per row, keys.py:320-326).  One flat batched gather when the index
    # supports it (FMIndex.occurrences_multi) -- the per-ngram call loop is
    # Python-bound on a 1-core host -- else per-ngram occurrences().
    if rare_list and hasattr(index, "occurrences_multi"):
        # kept FLAT: the native stage-1 kernel consumes (row_off, flat
        # arrays) directly; only the python fallback needs per-ngram views
        flat_ends, flat_docs, row_off_a = index.occurrences_multi(
            [list(n) for n, _ in rare_list],
            max_occurrences_1,
            [get_range_cached(tuple(n)) for n, _ in rare_list],
        )
        row_off = row_off_a.tolist()
    else:
        ends_parts, docs_parts, row_off = [], [], [0]
        for ngram, _sco in rare_list:
            tok_ends, doc_ids = index.occurrences(
                list(ngram), max_occurrences_1, rng=ranges_pre.get(tuple(ngram))
            )
            ends_parts.append(np.asarray(tok_ends, np.int64))
            docs_parts.append(np.asarray(doc_ids, np.int64))
            row_off.append(row_off[-1] + len(tok_ends))
        flat_ends = np.concatenate(ends_parts) if ends_parts else np.zeros(0, np.int64)
        flat_docs = np.concatenate(docs_parts) if docs_parts else np.zeros(0, np.int64)

    def _stage1_prims():
        if sort_by_length:
            return [float(len(n)) for n, _ in rare_list], 0.0
        if sort_by_freq:
            return [-float(counts[n]) for n, _ in rare_list], -float(len(index))
        return [0.0] * len(rare_list), 0.0

    prims1, init_prim1 = _stage1_prims()
    max_token = 0
    for n, _ in rare_list:
        if n:
            max_token = max(max_token, max(n))

    if nat is not None and rare_list:
        docs_u, scores_u, best_u = nat.stage1_accumulate(
            [list(n) for n, _ in rare_list],
            [s for _, s in rare_list],
            prims1,
            row_off,
            flat_ends,
            flat_docs,
            covered,
            beta,
            init_prim1,
            allow_overlaps,
            max_token,
        )
        # stage-1 can surface tens of thousands of docs; the (score, best)
        # ranking below runs vectorized instead of materializing per-doc
        # tuples (same arithmetic, same stable tie order as sorted())
        fs_items = None
        fs_docs = np.asarray(docs_u, np.int64)
        fs_key = (1.0 - single_key) * (-np.asarray(scores_u, np.float64)) + (
            single_key * (-np.asarray(best_u, np.float64))
        )
    else:  # pragma: no cover - python mirror of stage1_accumulate
        fs_scores: Dict[int, list] = {}
        order_idx: List[int] = []
        for g, (ngram, sco) in enumerate(rare_list):
            L = len(ngram)
            for r in range(row_off[g], row_off[g + 1]):
                e = int(flat_ends[r])
                s_pos = max(e - L, 0)
                fresh = not covered[s_pos:e].any()
                if fresh:
                    covered[s_pos:e] = 1
                doc = int(flat_docs[r])
                info = fs_scores.get(doc)
                if info is None:
                    info = [init_prim1, 0.0, [], -1]  # best_prim, best, matched, done
                    fs_scores[doc] = info
                    order_idx.append(doc)
                if prims1[g] > info[0] or (prims1[g] == info[0] and sco > info[1]):
                    info[0], info[1] = prims1[g], sco
                if (fresh or allow_overlaps) and info[3] != g:
                    info[3] = g
                    info[2].append((ngram, sco))
        fs_items = []
        for doc in order_idx:
            info = fs_scores[doc]
            cov: set = set()
            total = 0.0
            for tt, sco in info[2]:
                total += repetition(set(tt), sco, cov)
                cov |= set(tt)
            fs_items.append((doc, (total, info[1])))

    if fs_items is None:
        order = np.argsort(fs_key, kind="stable")[:n_docs_complete_score]
        to_fully_score = [(int(d), None) for d in fs_docs[order]]
    else:  # pragma: no cover - python mirror
        to_fully_score = sorted(
            fs_items,
            key=lambda x: (1.0 - single_key) * (-x[1][0]) + single_key * (-x[1][1]),
        )[:n_docs_complete_score]

    # ---- stage 2: full multi-pattern matching + greedy assignment --------
    # (reference keys.py:377-497, heap form; the heap is fully built before
    # any pop, so span-sorted processing is identical)
    results: Dict[int, list] = defaultdict(
        lambda: [0.0, [], None, None, [[], 0.0]]
    )

    patterns = [n for n, s in all_ngrams.items() if len(n) >= 1 and s > 0.0]
    pat_scores = [all_ngrams[n] for n in patterns]
    doc_list = [doc for doc, _ in to_fully_score]

    # stage-2 document tokens [2] + doc[:-1] (reference keys.py:388), built
    # with one vectorized text gather + a global shift-by-one
    if doc_list and hasattr(index, "get_docs_flat"):
        raw_flat, doc_off = index.get_docs_flat(doc_list)
        doc_data = np.empty_like(raw_flat)
        doc_data[1:] = raw_flat[:-1]
        doc_data[doc_off[:-1]] = 2
    else:
        per_doc = [[2] + index.get_doc(doc)[:-1] for doc in doc_list]
        doc_off = np.zeros(len(doc_list) + 1, np.int64)
        np.cumsum([len(d) for d in per_doc], out=doc_off[1:])
        doc_data = (
            np.concatenate([np.asarray(d, np.int64) for d in per_doc])
            if per_doc
            else np.zeros(0, np.int64)
        )
    doc_flat32 = (doc_data.astype(np.int32), doc_off)

    def doc_tokens_of(di: int) -> List[int]:
        return doc_data[int(doc_off[di]) : int(doc_off[di + 1])].tolist()

    if sort_by_length:
        prims2 = [-float(len(n)) for n in patterns]
        init_prim2 = 0.0
    elif sort_by_freq:
        prims2 = [float(counts.get(tuple(n), 0)) for n in patterns]
        init_prim2 = float(len(index))
    else:
        prims2 = [0.0] * len(patterns)
        init_prim2 = 0.0
    for n in patterns:
        max_token = max(max_token, max(n))
    if doc_data.size:
        max_token = max(max_token, int(doc_data.max()))

    pat_flat = None
    if patterns:
        pat_off_ = np.zeros(len(patterns) + 1, np.int64)
        np.cumsum([len(p) for p in patterns], out=pat_off_[1:])
        pat_flat = (
            np.fromiter(chain.from_iterable(patterns), np.int32, int(pat_off_[-1])),
            pat_off_,
        )
    else:
        pat_flat = (np.zeros(0, np.int32), np.zeros(1, np.int64))

    if nat is not None:
        triples = nat.ac_match(pat_flat, doc_flat32)
        multi, single, best_pat, uni, f_off, f_id, f_sco = nat.stage2_score(
            pat_flat,
            pat_scores,
            prims2,
            doc_flat32,
            triples,
            unigram_scores,
            beta,
            init_prim2,
            allow_overlaps,
            unigrams_ignore_free_places,
            max_token,
        )
        # bulk host conversion once; per-entry int()/float() over
        # found-lists dominated this frame on a 1-core host
        f_off_l = np.asarray(f_off).tolist()
        multi_l = np.asarray(multi).tolist()
        single_l = np.asarray(single).tolist()
        best_l = np.asarray(best_pat).tolist()
        uni_l = np.asarray(uni).tolist()
        if collect_found:
            # one vectorized (pattern-object, score) pair build over ALL
            # docs' matches at once, then per-doc slicing: the per-doc
            # branchy comprehension this replaces was ~30% of the frame
            pid_arr = np.asarray(f_id)
            obj = np.empty(pid_arr.size, dtype=object)
            pos = np.flatnonzero(pid_arr >= 0)
            if pos.size:
                pat_objs = np.empty(len(patterns), dtype=object)
                pat_objs[:] = patterns
                obj[pos] = pat_objs[pid_arr[pos]]
            negi = np.flatnonzero(pid_arr < 0)
            if negi.size:
                # negative ids encode unigram fills as single-token tuples;
                # assign via an object buffer (a raw list of 1-tuples would
                # be broadcast as a 2-D int array by fancy indexing)
                neg_objs = np.empty(negi.size, dtype=object)
                neg_objs[:] = [(-p - 1,) for p in pid_arr[negi].tolist()]
                obj[negi] = neg_objs
            all_pairs = list(zip(obj.tolist(), np.asarray(f_sco).tolist()))
        for di, doc in enumerate(doc_list):
            entry = results[doc]
            # np view, not .tolist(): fully_score docs (1500) each get their
            # tokens recorded but only the final top-k are ever read --
            # converting every one to a Python list dominated this frame
            entry[3] = doc_data[int(doc_off[di]) : int(doc_off[di + 1])]
            if collect_found:
                entry[1] = all_pairs[f_off_l[di] : f_off_l[di + 1]]
            bp = best_l[di]
            entry[4] = [patterns[bp] if bp >= 0 else [], single_l[di]]
            single_sco = single_l[di]
            if single_key_add_unigrams:
                single_sco += uni_l[di]
            multi_sco = multi_l[di] + uni_l[di]
            entry[0] = (1.0 - single_key) * multi_sco + single_key * single_sco
    else:  # pragma: no cover - python mirror of ac_match + stage2_score
        for di, doc in enumerate(doc_list):
            doc_tokens = doc_tokens_of(di)
            results[doc][3] = doc_tokens
            # match spans: patterns grouped by first token, checked at each
            # start position; ordered by (end, shorter first) like the
            # native completion order
            by_first: Dict[int, List[int]] = defaultdict(list)
            for pi, p in enumerate(patterns):
                by_first[p[0]].append(pi)
            spans: List[tuple] = []
            for start, tok in enumerate(doc_tokens):
                for pi in by_first.get(tok, ()):
                    p = patterns[pi]
                    if list(doc_tokens[start : start + len(p)]) == list(p):
                        spans.append((start + len(p), len(p), pi, start))
            spans.sort()
            entry_order: List[int] = []
            seen_pat: set = set()
            for _e, _l, pi, _s in spans:
                if pi not in seen_pat:
                    seen_pat.add(pi)
                    entry_order.append(pi)
            best_prim, best_sco, best_pi = init_prim2, 0.0, -1
            for pi in entry_order:
                if prims2[pi] < best_prim or (
                    prims2[pi] == best_prim and -pat_scores[pi] < -best_sco
                ):
                    best_prim, best_sco, best_pi = prims2[pi], pat_scores[pi], pi
            results[doc][4] = [patterns[best_pi] if best_pi >= 0 else [], best_sco]

            greedy = sorted(
                spans,
                key=lambda x: (-pat_scores[x[2]], tuple(patterns[x[2]]), x[3], x[0]),
            )
            coverage: set = set()
            found: List[tuple] = []
            prev = -1
            free = [True] * len(doc_tokens)
            for _e, _l, pi, i in greedy:
                j = i + _l
                n = patterns[pi]
                if pi == prev:
                    new_s = found[-1][1]
                else:
                    new_s = repetition(set(n), pat_scores[pi], coverage)
                if new_s <= 0.0:
                    continue
                if not (allow_overlaps or all(free[i:j])):
                    continue
                if pi == prev:
                    found[-1] = (n, new_s)
                else:
                    prev = pi
                    coverage |= set(n)
                    found.append((n, new_s))
                free[i:j] = [False] * (j - i)
            if unigrams_ignore_free_places:
                free = [True] * len(free)
            multi_sco = sum(s for _, s in found)
            uni_total = 0.0
            seen_tok: set = set()
            for k, t in enumerate(doc_tokens):
                if not free[k] or t in seen_tok:
                    continue
                seen_tok.add(t)
                s = (
                    unigram_scores[t]
                    if unigram_scores is not None and t < len(unigram_scores)
                    else 0.0
                )
                if s > 0.0:
                    s2 = repetition({t}, s, coverage)
                    if s2 != 0.0:
                        uni_total += s2
                        found.append(((t,), s2))
            single_sco = best_sco + (uni_total if single_key_add_unigrams else 0.0)
            multi_sco += uni_total
            results[doc][0] = (1.0 - single_key) * multi_sco + single_key * single_sco
            if collect_found:
                results[doc][1] = found

    results = dict(sorted(results.items(), key=lambda x: -x[1][0]))
    return results, all_ngrams
