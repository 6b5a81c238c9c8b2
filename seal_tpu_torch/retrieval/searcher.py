"""SEALSearcher on the port (counterpart of
``seal_tpu/retrieval/searcher.py``): the retrieval orchestrator with the
same ``DEFAULTS`` knobs, the same key-generation pipeline (body and title
decodes with conditioning markers, query decomposition, rescoring,
deduplication, unigram scores) and the same two-stage evidence
aggregation.

Generation, rescoring and unigram scores run on the device of the model
parameters (``seal_tpu_torch.decoding``, ``seal_tpu_torch.scoring``); the
host ranker is the port's verbatim copy of ``aggregate_evidence``.  The
JAX module cannot be subclassed or imported here: it imports jax, and its
tokenizer ``regex``.

What changed in translation:

* ``process_batch`` does not pad a ragged last batch to ``batch_size``,
  and ``_device_ranges`` does not bucket its shapes: both keep the JAX
  program to one compiled shape, which eager torch does not need.  Every
  query's result is independent of its batch-mates, so the output is the
  same.
* Not ported yet (``NotImplementedError`` naming the knob):
  ``compact_index``, ``hybrid_index``, ``index_shards`` > 1, ``jobs`` >= 2
  (forked workers after CUDA init), ``free_generation``, ``decode_code``,
  T5 backbones, and the decode modes ``DecodeConfig`` refuses.  ``load``,
  ``from_args`` and the CLIs wait for a checkpoint loader without jax.
"""

from __future__ import annotations

import time
from itertools import islice
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from seal_tpu.index.fm_index import FMIndex
from seal_tpu.retrieval.document import SEALDocument
from seal_tpu.utils.profiling import PhaseTimer, ServingMetrics
from seal_tpu_torch.decoding.generate import fm_index_generate
from seal_tpu_torch.index.device_index import TorchFMIndex
from seal_tpu_torch.models import convert
from seal_tpu_torch.models.config import BartConfig
from seal_tpu_torch.ops import fm_ops
from seal_tpu_torch.scoring import keys as rk

# parity: reference module-level debug switch printing scored ngrams
DEBUG = False

# knobs of the JAX searcher whose modes are not ported, and when they ask
# for one
UNPORTED = {
    "compact_index": bool,
    "hybrid_index": bool,
    "index_shards": lambda v: (v or 0) > 1,
    "jobs": lambda v: v >= 2,
    "free_generation": bool,
    "decode_code": bool,
}


class SEALSearcher:
    # the JAX searcher's knobs: same names, same defaults
    DEFAULTS = {
        "backbone": "facebook/bart-large",
        "fairseq_checkpoint": True,
        "length": 10,
        "min_length": 0,
        "length_penalty": 0.0,
        "scoring_length_penalty": 0.0,
        "repetition_penalty": 0.8,
        "score_exponent": 2.0,
        "beam": 15,
        "max_hits": 1500,
        "fully_score": 1500,
        "skip_frequent_keys": 10_000_000,
        "add_query_to_keys": True,
        "batch_size": 20,
        "jobs": 1,
        "progress": False,
        "free_generation": False,
        "use_fm_index_frequency": True,
        "unigram_scores": True,
        "add_best_unigrams_to_ngrams": True,
        "use_top_k_ngrams": 5000,
        "sort_by_length": False,
        "sort_by_freq": False,
        "print_n_doc": False,
        "allow_overlaps": False,
        "diverse_bs_groups": 1,
        "diverse_bs_penalty": 0.0,
        "rescore": True,
        "detokenize": True,
        "include_keys": False,
        "single_key": 0.0,
        "unigrams_ignore_free_places": False,
        "use_markers": True,
        "value_conditioning": True,
        "decode_body": True,
        "decode_titles": True,
        "decode_code": False,
        "partial_code": False,
        "partial_titles": False,
        "smoothing": 5.0,
        "stop_at_count": 0,
        "topk": 0,
        "force_decoding_second_token": -1,
        "top_m": 256,
        "window": 0,
        "speculative": False,
        "exact_mask": False,
        "exact_ties": False,
        "compact_index": False,
        "hybrid_index": False,
        "pipeline": True,
        "index_shards": 0,
    }

    def __init__(
        self,
        fm_index: FMIndex,
        tokenizer,
        model_cfg: BartConfig,
        params,
        scorer_params=None,
        title_params=None,
        code_params=None,
        device_index: Optional[TorchFMIndex] = None,
        device=None,  # where the index goes; default: the device of ``params``
        **kwargs,
    ):
        self.fm_index = fm_index
        self.tokenizer = tokenizer
        self.model_cfg = model_cfg
        # bf16 configs serve from compute-dtype weight copies (no-op for
        # f32); shared parameter trees are cast once
        memo: Dict[int, object] = {}

        def _cast(p):
            if id(p) not in memo:
                memo[id(p)] = convert.cast_params(model_cfg, p)
            return memo[id(p)]

        self.params = _cast(params)
        self.scorer_params = _cast(scorer_params) if scorer_params is not None else self.params
        self.title_params = _cast(title_params) if title_params is not None else self.params
        self.code_params = _cast(code_params) if code_params is not None else self.params
        self.set_params(kwargs)
        if device_index is None:
            device = params["shared"].device if device is None else device
            device_index = TorchFMIndex.from_host(fm_index, vocab=model_cfg.vocab_size,
                                                  device=device)
        self.device_index = device_index
        self.docid2idx = (
            {k: i for i, k in enumerate(fm_index.labels)} if fm_index.labels else {}
        )
        self.num_docs = fm_index.n_docs
        self.docids = fm_index.labels
        self.metrics = ServingMetrics()
        # phase attribution (decode/rescore/unigram/aggregate/detokenize);
        # off by default.  Phases overlap under pipelining: shares, not a
        # wall-clock sum
        self.phase_timer = PhaseTimer(enabled=False)

        backbone = self.backbone
        if "t5" in backbone:
            raise NotImplementedError("not ported to seal_tpu_torch yet: T5 backbones")
        if "bart" in backbone:
            # reference retrieval.py:482-493
            self.title_bos_token_id = 2
            self.title_eos_token_id = 49314  # '@@'
            self.code_bos_token_id = 49314
            self.code_eos_token_id = 45056  # '||'
            self.prepend_space = True
            self.strip_token_ids = (0, 2)
        else:
            # generic backbone: the '@@' / '||' marker ids come from the
            # tokenizer, so word-vocab backbones work out of the box
            def _marker(text, fallback):
                ids = tokenizer.encode_plain(text)
                return ids[-1] if ids else fallback

            self.title_bos_token_id = model_cfg.eos_token_id
            self.title_eos_token_id = _marker(" @@", model_cfg.eos_token_id)
            self.code_bos_token_id = self.title_eos_token_id
            self.code_eos_token_id = _marker(" ||", model_cfg.eos_token_id)
            self.prepend_space = True
            self.strip_token_ids = (model_cfg.bos_token_id, model_cfg.eos_token_id)
        for key in (
            "title_bos_token_id", "title_eos_token_id",
            "code_bos_token_id", "code_eos_token_id",
        ):
            if key in kwargs:
                setattr(self, key, kwargs[key])

    # ------------------------------------------------------------- params

    def set_params(self, params: Dict):
        for key, val in self.DEFAULTS.items():
            setattr(self, key, params.get(key, val))
        self._check_ported()

    def _check_ported(self):
        asked = [k for k, on in UNPORTED.items() if on(getattr(self, k))]
        if asked:
            raise NotImplementedError(
                f"not ported to seal_tpu_torch yet: {', '.join(asked)} "
                "(use seal_tpu for these modes)"
            )

    # ---------------------------------------------------------- key generation

    def _generate(self, params, toks, **kw):
        with self.phase_timer.phase("decode"):
            return fm_index_generate(self.model_cfg, params, self.device_index, toks, **kw)

    def _rescore_keys(self, *args, **kw):
        with self.phase_timer.phase("rescore"):
            return rk.rescore_keys(*args, **kw)

    def _tokenize_batch(self, texts: Sequence[str]) -> List[List[int]]:
        limit = self.model_cfg.max_position_embeddings
        return [self.tokenizer.encode(t)[:limit] for t in texts]

    # ------------------------------------------------- batched index queries

    def _device_ranges(self, seqs: Sequence[Sequence[int]]):
        """get_range for many keys in one call: the host's native batch when
        the host index has psi (sub-ms, no device round trip), else kernel 5
        on the device index."""
        seqs = list(seqs)
        if not seqs:
            return []
        if getattr(self.fm_index, "psi", None) is not None:
            return self.fm_index.get_ranges_batch(seqs)
        L = max(len(s) for s in seqs)
        toks = np.zeros((len(seqs), L), np.int32)
        lens = np.zeros(len(seqs), np.int32)
        for i, s in enumerate(seqs):
            toks[i, : len(s)] = s
            lens[i] = len(s)
        lo, hi = fm_ops.range_for_sequences(self.device_index, toks, lens)
        return list(zip(lo.cpu().tolist(), hi.cpu().tolist()))

    def _device_counts(self, seqs: Sequence[Sequence[int]]) -> List[int]:
        return [hi - lo for lo, hi in self._device_ranges(seqs)]

    def _count_filter(self, fk):
        """Drop (score, key) pairs whose key does not occur in the corpus
        (reference retrieval.py:91), in one batched call."""
        fk = [(sc, k) for sc, k in fk if k]
        if not fk:
            return fk
        counts = self._device_counts([k for _, k in fk])
        return [(sc, k) for (sc, k), c in zip(fk, counts) if c > 0]

    def _marked(self, inputs: Sequence[str], marker: str) -> List[str]:
        batch = list(inputs)
        if self.use_markers:
            batch = [i + f" || {marker}" for i in batch]
        if self.value_conditioning:
            batch = [i + " || +" for i in batch]
        return batch

    def _strip_body_keys(self, fk):
        """Reference retrieval.py:85-91."""
        s = self.strip_token_ids
        fk = [(sc, k[1:] if k[0] in s else k) for sc, k in fk if k]
        fk = [(sc, k[1:] if k[0] in s else k) for sc, k in fk if k]
        fk = [(sc, k[:-1] if k[-1] in s else k) for sc, k in fk if k]
        if self.min_length > 0:
            fk = [(sc, k) for sc, k in fk if len(k) == self.min_length]
        return self._count_filter(fk)

    def process_batch(self, inputs: Sequence[str]):
        """Key generation for one query batch (reference retrieval.py:54-305)."""
        if not inputs:
            return []
        inputs = [
            (" " + q.strip()) if self.prepend_space else q.strip() for q in inputs
        ]
        gen_common = dict(
            num_beams=self.beam,
            forced_bos_token_id=None,
            top_m=self.top_m,
            window=self.window,
            speculative=self.speculative,
            exact_mask=self.exact_mask,
            exact_ties=self.exact_ties,
            topk=self.topk,
            diverse_bs_groups=self.diverse_bs_groups,
            diverse_bs_penalty=self.diverse_bs_penalty,
        )
        rescore_strip = dict(
            strip_from_bos=[
                self.title_bos_token_id,
                self.code_bos_token_id,
                self.model_cfg.decoder_start_token_id,
            ],
            strip_from_eos=[
                self.title_eos_token_id,
                self.code_eos_token_id,
                self.model_cfg.eos_token_id,
            ],
        )

        found_keys: List[List] = [[] for _ in inputs]

        if self.decode_body:
            batch_str = self._marked(inputs, "body")
            toks = self._tokenize_batch(batch_str)
            raw = self._generate(
                self.params,
                toks,
                min_length=self.length,
                max_length=self.length,
                stop_at_count=self.stop_at_count,
                **gen_common,
            )
            found_keys = [self._strip_body_keys(fk) for fk in raw]
            if self.rescore and self.use_markers:
                plain = self._tokenize_batch(inputs)
                found_keys = self._rescore_keys(
                    self.model_cfg, self.params, plain, found_keys, **rescore_strip
                )

        if self.add_query_to_keys:
            decomposed = []
            for inp in inputs:
                new_fk = [
                    self.tokenizer.encode_plain(s)
                    for s in rk.decompose_query_into_keys(inp, 3)
                ]
                s = self.strip_token_ids
                new_fk = [k[:-1] if k and k[-1] in s else k for k in new_fk if k]
                new_fk = [k[1:] if k and k[0] in s else k for k in new_fk if k]
                new_fk = [k[1:] if k and k[0] in s else k for k in new_fk if k]
                if self.min_length > 0:
                    new_fk = [k for k in new_fk if len(k) == self.min_length]
                new_fk = [k for k in new_fk if k]
                counts = self._device_counts(new_fk)
                new_fk = [k for k, c in zip(new_fk, counts) if c > 0]
                decomposed.append(new_fk)
            marked = self._tokenize_batch(self._marked(inputs, "body"))
            scored = self._rescore_keys(self.model_cfg, self.params, marked, decomposed)
            for fk, nfk in zip(found_keys, scored):
                fk += nfk

        if self.decode_titles:
            batch_str = self._marked(inputs, "title")
            toks = self._tokenize_batch(batch_str)
            raw = self._generate(
                self.title_params,
                toks,
                min_length=1,
                max_length=15,
                eos_token_id=self.title_eos_token_id,
                force_decoding_from=[self.title_bos_token_id],
                **gen_common,
            )
            new_keys = []
            for fk in raw:
                s = self.strip_token_ids
                if self.force_decoding_second_token >= 0:
                    fk = [(sc, k[:1] + k[2:]) for sc, k in fk if len(k) >= 3]
                fk = [(sc, k[:-1] if k and k[-1] in s else k) for sc, k in fk]
                if not self.partial_titles:
                    fk = [(sc, k) for sc, k in fk if k and k[-1] == self.title_eos_token_id]
                    if self.min_length > 0:
                        fk = [(sc, k) for sc, k in fk if len(k) == self.min_length + 1]
                fk = [
                    (sc, [self.title_bos_token_id] + k if k[0] != self.title_bos_token_id else k)
                    for sc, k in fk if k
                ]
                fk = self._count_filter(fk)
                new_keys.append(fk)
            if self.rescore and self.use_markers:
                new_keys = self._rescore_keys(
                    self.model_cfg,
                    self.title_params,
                    self._tokenize_batch(batch_str),
                    new_keys,
                    strip_from_bos=rescore_strip["strip_from_bos"],
                    strip_from_eos=[self.model_cfg.eos_token_id],
                )
            for fk, nfk in zip(found_keys, new_keys):
                fk += nfk

        if self.rescore and not self.use_markers:
            found_keys = self._rescore_keys(
                self.model_cfg,
                self.scorer_params,
                self._tokenize_batch(inputs),
                found_keys,
                **rescore_strip,
            )

        found_keys = [rk.deduplicate(fk) for fk in found_keys]
        found_keys = [[(n, s) for s, n in fk] for fk in found_keys]

        if self.unigram_scores:
            marked = self._tokenize_batch(self._marked(inputs, "body"))
            prefix = (
                [self.force_decoding_second_token]
                if self.force_decoding_second_token >= 0
                else []
            )
            with self.phase_timer.phase("unigram"):
                us = rk.compute_unigram_scores(
                    self.model_cfg, self.scorer_params, marked, prefix=prefix
                )
            return list(zip(found_keys, us))
        return found_keys

    def batch_generate_keys(self, queries: Sequence[str]):
        self._check_ported()
        for off in range(0, len(queries), self.batch_size):
            yield from self.process_batch(queries[off : off + self.batch_size])

    def _pipelined_keys(self, queries: Sequence[str]):
        """Key generation in a producer thread, so the device work of batch
        N+1 overlaps the host aggregation of batch N."""
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=4 * self.batch_size)
        sentinel = object()

        def producer():
            try:
                for item in self.batch_generate_keys(queries):
                    q.put(item)
                q.put(sentinel)
            except BaseException as e:  # surfaced in the consumer
                q.put(e)

        threading.Thread(target=producer, daemon=True).start()
        while True:
            item = q.get()
            if item is sentinel:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def generate_keys(self, query: str):
        return next(iter(self.batch_generate_keys([query])))

    # ------------------------------------------------------------- retrieval

    def retrieve_from_keys(self, keys):
        unigram_scores = None
        if isinstance(keys, tuple) and len(keys) == 2:
            keys, unigram_scores = keys
        with self.phase_timer.phase("aggregate"):
            results, ngrams = rk.aggregate_evidence(
                ngrams_and_scores=keys,
                unigram_scores=unigram_scores,
                range_fn=self._device_ranges,
                # matched-ngram lists are read only under include_keys
                # (batch_search) or DEBUG printing
                collect_found=self.include_keys or DEBUG,
                index=self.fm_index,
                max_occurrences_1=self.max_hits,
                n_docs_complete_score=self.fully_score,
                alpha=self.score_exponent,
                beta=self.repetition_penalty,
                length_penalty=self.scoring_length_penalty,
                use_fm_index_frequency=self.use_fm_index_frequency,
                add_best_unigrams_to_ngrams=self.add_best_unigrams_to_ngrams,
                use_top_k_unigrams=self.use_top_k_ngrams,
                sort_by_length=self.sort_by_length,
                sort_by_freq=self.sort_by_freq,
                smoothing=self.smoothing,
                allow_overlaps=self.allow_overlaps,
                single_key=self.single_key,
                unigrams_ignore_free_places=self.unigrams_ignore_free_places,
            )
        if DEBUG:
            for n, sc in ngrams.items():
                print(sc, self.tokenizer.decode(list(n)))
        return results, ngrams

    def batch_retrieve_from_keys(self, keys):
        self._check_ported()
        for i, kk in enumerate(keys):
            if self.print_n_doc:
                print(i)
            yield self.retrieve_from_keys(kk)

    # ----------------------------------------------------------------- search

    def search(self, query: str, k: int = 10) -> List[SEALDocument]:
        return self.batch_search([query], k=k)[0]

    def batch_search(self, queries: Sequence[str], k: int = 10, detokenize=None):
        if detokenize is None:
            detokenize = self.detokenize
        queries = list(queries)
        if not queries:
            return []
        batch_t0 = time.time()
        timer = PhaseTimer(enabled=True)
        with timer.phase("generate+aggregate"):
            keys_it = (
                self._pipelined_keys(queries) if self.pipeline
                else self.batch_generate_keys(queries)
            )
            results, keysets = zip(*self.batch_retrieve_from_keys(keys_it))

        key_texts: Dict[tuple, Tuple[str, int]] = {}
        if self.include_keys:
            uniq_keys = list({key for kk in keysets for key in kk})
            if uniq_keys:
                key_counts = self._device_counts([list(k) for k in uniq_keys])
                for key, cnt in zip(uniq_keys, key_counts):
                    key_texts[key] = (self.tokenizer.decode(list(key)), cnt)

        retrieved = []
        for query, res in zip(queries, results):
            docs = []
            for idx, (score, kk, _, full, _) in islice(res.items(), k):
                doc = SEALDocument(
                    idx,
                    score,
                    self.fm_index,
                    self.tokenizer,
                    delim1=self.title_eos_token_id,
                    delim2=self.code_eos_token_id,
                    query=query,
                )
                if self.include_keys:
                    for key, _s in kk:
                        if key not in key_texts:
                            key_texts[key] = (
                                self.tokenizer.decode(list(key)),
                                self.fm_index.get_count(list(key)),
                            )
                    doc.keys = [(*key_texts[key], s) for key, s in kk]
                # entry[3] may be a numpy view (the native ranker); document
                # helpers (.index / decode) expect a Python list
                doc._raw_tokens = full.tolist() if hasattr(full, "tolist") else full
                docs.append(doc)
            retrieved.append(docs)
        if detokenize:
            with timer.phase("detokenize"):
                # reference detokenize_retrieved strips surrounding
                # whitespace (retrieval.py:777-778), unlike lazy .text()
                for d in [d for docs in retrieved for d in docs]:
                    tt, bt = d.split_tokens(d.raw_tokens())
                    d._title = (
                        self.tokenizer.decode(tt, skip_special_tokens=True).strip()
                        if tt
                        else ""
                    )
                    d._body = self.tokenizer.decode(bt, skip_special_tokens=True).strip()
        if self.progress:
            timer.log_summary()
        self.metrics.observe_batch(
            n_queries=len(queries),
            n_keys=sum(len(kk) for kk in keysets),
            n_docs=sum(len(docs) for docs in retrieved),
            elapsed_s=time.time() - batch_t0,
            timer=timer,
        )
        return retrieved

    def doc(self, docid) -> Optional[SEALDocument]:
        idx = self.docid2idx[docid] if isinstance(docid, str) else docid
        return SEALDocument(
            idx,
            None,
            self.fm_index,
            self.tokenizer,
            delim1=self.title_eos_token_id,
            delim2=self.code_eos_token_id,
        )
