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
* ``compact_index`` / ``hybrid_index`` build a :class:`WaveletIndex` as the
  JAX searcher builds its ``WaveletFMIndex``; the decoder dispatches on the
  index's layout.
* ``diverse_bs_groups`` / ``diverse_bs_penalty`` reach every body and
  title decode, as in JAX (kernel 21 selects the groups).
* Both model families: a ``backbone`` naming ``t5`` takes the reference's
  T5 token constants (``retrieval.py:494-504``), and the model calls go
  through ``models/api.py:module_for`` with a ``T5Config`` (``models/t5.py``)
  as with a ``BartConfig``.
* ``index_shards`` > 1: ``build_sharded`` or ``sharded_index=`` (a
  ``ShardedTorchIndex`` with every shard on one card, ranked over a
  ``UnionHostIndex``), as the JAX searcher's sharded serving mode.  With
  ``mesh=`` (``parallel/mesh.py``) the shards spread over the ranks, as
  JAX's over its devices: every rank builds or loads all the shards' host
  indexes for the ranker, keeps its own block of shards on its device
  (``ShardedTorchIndex.place``), and runs ``batch_search`` on the same
  queries; the decode and the counts merge over the ranks, and every rank
  returns the same documents.  The ranker's counts take the mesh's second
  collective lane, the key producer's decode and count filter its first,
  so the two threads' collectives never interleave in one group.
* ``load`` / ``from_args`` put the index and the parameters on the device
  they are given (``--device``: ``auto``, ``cuda`` and ``cuda:N`` mean the
  card and raise where there is none; ``cpu`` the CPU).  A ``checkpoint``
  of ``None`` or ``"random"`` gives the port's own seeded weights
  (``init_params(cfg, 0)``), not the JAX package's ``PRNGKey(0)`` ones.
* ``jobs`` >= 2 ranks (and, above 2, detokenizes) in ``spawn``ed worker
  processes, not forked ones: forking after CUDA is initialized is unsafe.
  The parent finds every key's range of a unit as the serial path does
  (``_device_ranges``: on the card over shards and the wavelet layouts)
  and sends the table with the keys; the workers hold only what is on the
  host (the host index, the tokenizer, the ranker's knobs) and never touch
  CUDA.  The host ranker reaches them as files (its pickle, and its large
  arrays mapped copy-on-write, so the workers share one copy in the page
  cache).  The
  pool lives as long as the searcher, from its first use to ``close()``.
  As with any ``spawn`` pool, a script that sets ``jobs`` >= 2 keeps its
  own work under ``if __name__ == "__main__":`` (each worker imports it).
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import os
import pickle
import time
from itertools import islice
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from seal_tpu_torch.decoding.constrained import index_ops
from seal_tpu_torch.decoding.generate import fm_index_generate
from seal_tpu_torch.index.device_index import TorchFMIndex
from seal_tpu_torch.index.fm_index import FMIndex
from seal_tpu_torch.index.wavelet import WaveletIndex
from seal_tpu_torch.models import api as model_api
from seal_tpu_torch.models import convert
from seal_tpu_torch.models.config import BartConfig, bart_large, bart_tiny
from seal_tpu_torch.models.t5 import T5Config, t5_tiny
from seal_tpu_torch.models.tokenizer import load_tokenizer
from seal_tpu_torch.parallel.sharded_decode import sharded_fm_index_generate
from seal_tpu_torch.parallel.sharded_index import (
    ShardedTorchIndex,
    UnionHostIndex,
    load_sharded_hosts,
    sharded_count_sequences,
)
from seal_tpu_torch.retrieval.document import SEALDocument
from seal_tpu_torch.scoring import keys as rk
from seal_tpu_torch.utils.device import DEFAULT_DEVICE, checked_device, resolve_device
from seal_tpu_torch.utils.profiling import PhaseTimer, ServingMetrics

logger = logging.getLogger(__name__)

# parity: reference module-level debug switch printing scored ngrams
DEBUG = False

# what a jobs >= 2 worker process ranks with: the host-only copy of the
# searcher that its pool's initializer sends (one per worker process), and
# the wall-clock times its initializer started and ended
_WORKER: Dict[str, object] = {}

# arrays at least this large reach the workers as mapped files
_MAPPED_MIN_BYTES = 1 << 20

# a mesh's collective lanes (parallel/mesh.py): the key producer's (the
# decode and the count filter, on the pipeline's thread) and the ranker's
PRODUCER_LANE, RANKER_LANE = 0, 1


def _mapped_array(path: str) -> np.ndarray:
    # copy-on-write: the pages stay shared unless a worker writes to them
    return np.asarray(np.load(path, mmap_mode="c"))


class _HostPickler(pickle.Pickler):
    """Pickles the host ranker with each large numpy array written once to
    ``directory`` and mapped by every worker (``_mapped_array``): the
    pickle carries only the small objects."""

    def __init__(self, file, directory: str):
        super().__init__(file, protocol=pickle.HIGHEST_PROTOCOL)
        self.directory, self.n_files = directory, 0

    def reducer_override(self, obj):
        if type(obj) is not np.ndarray or obj.dtype.hasobject or obj.nbytes < _MAPPED_MIN_BYTES:
            return NotImplemented
        path = os.path.join(self.directory, f"{self.n_files}.npy")
        self.n_files += 1
        np.save(path, obj)
        return _mapped_array, (path,)


def _worker_init(path: str) -> None:
    t0 = time.time()
    with open(path, "rb") as f:
        _WORKER["ranker"] = pickle.load(f)
    _WORKER["init"] = (t0, time.time())


def _worker_info() -> Tuple[int, float, float]:
    """(pid, wall-clock start and end of its initializer): what a worker's
    start took apart from the spawn and its imports."""
    return (os.getpid(), *_WORKER["init"])


def _retrieve_from_keys_mp_aux(args):
    knobs, keys, ranges = args
    ranker = _WORKER["ranker"]
    ranker.set_params(knobs)  # the parent's knobs at the time of the call
    # the parent's ranges: a worker never counts a key itself
    return ranker.retrieve_from_keys(keys, ranges=ranges)


def _detokenize_mp_aux(args):
    # reference detokenization strips surrounding whitespace
    # (retrieval.py:778,823); the lazy SEALDocument.text() path does not
    title_tokens, body_tokens = args
    tok = _WORKER["ranker"].tokenizer
    title = tok.decode(title_tokens, skip_special_tokens=True).strip() if title_tokens else ""
    return title, tok.decode(body_tokens, skip_special_tokens=True).strip()


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
        model_cfg: Union[BartConfig, T5Config],
        params,
        scorer_params=None,
        title_params=None,
        code_params=None,
        device_index: Optional[Union[TorchFMIndex, WaveletIndex]] = None,
        sharded_index: Optional[ShardedTorchIndex] = None,  # serving mode over shards
        mesh=None,  # the mesh ``sharded_index`` was placed on
        device=None,  # where the index goes; default: the device of ``params``
        **kwargs,
    ):
        if mesh is not None and (sharded_index is None or sharded_index.mesh is not mesh):
            raise ValueError("a mesh serves a sharded index placed on it: "
                             "SEALSearcher(..., sharded_index=si.place(mesh), mesh=mesh)")
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
        self.sharded_index = sharded_index
        self.mesh = mesh
        if self.index_shards > 1 and sharded_index is None:
            raise ValueError(
                "index_shards>1 requires the sharded build path: use "
                "SEALSearcher.load(..., index_shards=N) or build_sharded()"
            )
        if device_index is None and sharded_index is None:
            device = params["shared"].device if device is None else device
            if self.compact_index or self.hybrid_index:
                # capacity mode: ~3.0 B/token wavelet-tree layout; hybrid
                # adds the raw BWT back (~5.0 B/token) for one-read windows
                device_index = WaveletIndex.from_host(
                    fm_index, vocab=model_cfg.vocab_size, keep_bwt=bool(self.hybrid_index),
                    device=device,
                )
            else:
                device_index = TorchFMIndex.from_host(fm_index, vocab=model_cfg.vocab_size,
                                                      device=device)
        self.device_index = device_index  # None in the sharded mode
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
        self._pool = None  # the jobs >= 2 worker pool, started at its first use
        self._pool_size = 0
        self._pool_files = None  # the directory of the pool's mapped arrays

        backbone = self.backbone
        if "bart" in backbone:
            # reference retrieval.py:482-493
            self.title_bos_token_id = 2
            self.title_eos_token_id = 49314  # '@@'
            self.code_bos_token_id = 49314
            self.code_eos_token_id = 45056  # '||'
            self.prepend_space = True
            self.strip_token_ids = (0, 2)
        elif "t5" in backbone:
            # reference retrieval.py:494-504
            self.title_bos_token_id = 1
            self.title_eos_token_id = 32000
            self.code_bos_token_id = 32000
            self.code_eos_token_id = 32001
            self.prepend_space = False
            self.strip_token_ids = (0, 1)
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

    @classmethod
    def add_args(cls, parser):
        """CLI flags from ``DEFAULTS`` (reference retrieval.py:521-535):
        ``--dont_X`` for a True default, ``--X`` for a False one."""
        parser.add_argument("--fm_index", required=True, type=str)
        parser.add_argument("--checkpoint", required=False, type=str)
        parser.add_argument("--checkpoint_scorer", required=False, type=str, default=None)
        parser.add_argument("--checkpoint_title", required=False, type=str, default=None)
        parser.add_argument("--checkpoint_code", required=False, type=str, default=None)
        parser.add_argument("--tokenizer", required=False, type=str, default=None)
        parser.add_argument("--device", default="auto", type=str,
                            help="auto, cuda or cuda:N (the card; raises without one) or cpu")
        for name, value in cls.DEFAULTS.items():
            if value is True:
                parser.add_argument(f"--dont_{name}", action="store_false", dest=name)
            elif value is False:
                parser.add_argument(f"--{name}", action="store_true")
            else:
                parser.add_argument(f"--{name}", required=False, type=type(value), default=value)

    @classmethod
    def from_args(cls, args):
        params = {name: getattr(args, name) for name in cls.DEFAULTS}
        return cls.load(
            args.fm_index,
            args.checkpoint,
            scorer_checkpoint=args.checkpoint_scorer,
            title_checkpoint=args.checkpoint_title,
            code_checkpoint=args.checkpoint_code,
            tokenizer_path=args.tokenizer,
            device=resolve_device(args.device),
            **params,
        )

    # ---------------------------------------------------------------- loading

    @staticmethod
    def load_fm_index(path: str) -> FMIndex:
        logger.warning("initializing FM-index from %s", path)
        index = FMIndex.load(path)
        logger.warning("FM-index initialized (%d docs, %d tokens)", index.n_docs, len(index))
        return index

    @classmethod
    def load(
        cls,
        fm_index_path: str,
        checkpoint: Optional[str] = None,
        scorer_checkpoint: Optional[str] = None,
        title_checkpoint: Optional[str] = None,
        code_checkpoint: Optional[str] = None,
        tokenizer_path: Optional[str] = None,
        model_cfg: Optional[Union[BartConfig, T5Config]] = None,
        device=DEFAULT_DEVICE,
        **params,
    ) -> "SEALSearcher":
        """Load index + model(s) + tokenizer onto ``device`` (the card
        unless the caller asks for the CPU; raises where no CUDA device
        exists).

        ``checkpoint`` may be a fairseq ``.pt`` (the default,
        ``fairseq_checkpoint``), a HF ``.pt`` / ``pytorch_model.bin`` / model
        directory, or ``None`` / ``"random"`` for the port's own seeded
        weights (``init_params(cfg, 0)``: not the JAX package's
        ``PRNGKey(0)`` weights).

        When ``fm_index_path`` has a shard manifest (``build_fm_index
        --shards N``), the per-shard indexes load directly, every shard on
        ``device``; the monolithic host index is never built.  With
        ``index_shards=N`` a monolithic index is re-split into N shards.
        """
        device = checked_device(device)
        if os.path.exists(fm_index_path + ".manifest.json"):
            return cls._load_sharded_manifest(
                fm_index_path,
                checkpoint,
                scorer_checkpoint=scorer_checkpoint,
                title_checkpoint=title_checkpoint,
                code_checkpoint=code_checkpoint,
                tokenizer_path=tokenizer_path,
                model_cfg=model_cfg,
                device=device,
                **params,
            )
        fm_index = cls.load_fm_index(fm_index_path)
        tokenizer, model_cfg, main, extra = cls._load_models(
            checkpoint, scorer_checkpoint, title_checkpoint, code_checkpoint,
            tokenizer_path, model_cfg, params, device,
        )
        n_shards = int(params.pop("index_shards", 0) or 0)
        if n_shards > 1:
            # re-split the loaded corpus into shards: a one-time cost at
            # load, the same decode as the monolithic index (numpy views,
            # not per-document Python lists)
            flat, off = fm_index.get_docs_flat(list(range(fm_index.n_docs)))
            docs = [flat[off[i] : off[i + 1]] for i in range(fm_index.n_docs)]
            labels = fm_index.labels or [str(i) for i in range(fm_index.n_docs)]
            return cls.build_sharded(
                docs, labels, tokenizer, model_cfg, main,
                n_shards=n_shards, device=device, **extra, **params,
            )
        return cls(fm_index, tokenizer, model_cfg, main, device=device, **extra, **params)

    @classmethod
    def _load_models(
        cls, checkpoint, scorer_checkpoint, title_checkpoint, code_checkpoint,
        tokenizer_path, model_cfg, params, device=DEFAULT_DEVICE,
    ):
        """The tokenizer, the model config (from ``backbone`` and the
        tokenizer's vocab unless given) and each checkpoint's parameters
        on ``device``, with the SEAL logit bias."""
        device = checked_device(device)
        backbone = params.get("backbone", cls.DEFAULTS["backbone"])
        tokenizer = load_tokenizer(tokenizer_path or backbone)
        if model_cfg is None:
            if "t5" in backbone:
                model_cfg = (
                    t5_tiny(vocab_size=tokenizer.vocab_size)
                    if "tiny" in backbone
                    else T5Config(vocab_size=max(32128, tokenizer.vocab_size))
                )
            elif "tiny" in backbone:
                model_cfg = bart_tiny(vocab_size=tokenizer.vocab_size)
            else:
                model_cfg = bart_large()
        if model_cfg.vocab_size < tokenizer.vocab_size:
            model_cfg = dataclasses.replace(model_cfg, vocab_size=tokenizer.vocab_size)
        model_mod = model_api.module_for(model_cfg)

        def load_params(path):
            if path in (None, "random"):
                p = model_mod.init_params(model_cfg, 0, device)
            elif getattr(model_cfg, "family", "bart") == "t5":
                sd = convert.torch_load(path)
                p = convert.from_hf_t5_state_dict(sd.get("model", sd), model_cfg, device)
            elif path.endswith(".pt") and params.get("fairseq_checkpoint", True):
                p = convert.load_fairseq_checkpoint(path, model_cfg, device)
            else:
                p = convert.load_hf_checkpoint(path, model_cfg, device)
            return convert.apply_seal_logits_bias(p, model_cfg)

        main = load_params(checkpoint)
        extra = dict(
            scorer_params=load_params(scorer_checkpoint) if scorer_checkpoint else None,
            title_params=load_params(title_checkpoint) if title_checkpoint else None,
            code_params=load_params(code_checkpoint) if code_checkpoint else None,
        )
        return tokenizer, model_cfg, main, extra

    @classmethod
    def _load_sharded_manifest(
        cls,
        fm_index_path: str,
        checkpoint=None,
        scorer_checkpoint=None,
        title_checkpoint=None,
        code_checkpoint=None,
        tokenizer_path=None,
        model_cfg=None,
        mesh=None,
        device=DEFAULT_DEVICE,
        **params,
    ) -> "SEALSearcher":
        """Sharded serving straight from the per-shard index files, every
        shard on ``device``; with ``mesh``, this rank's block of shards on
        the mesh's device (every rank loads every shard's host index)."""
        device = checked_device(device)
        hosts, assignments, labels = load_sharded_hosts(fm_index_path)
        n_shards = len(hosts)
        want = int(params.pop("index_shards", 0) or 0)
        if want and want != n_shards:
            raise ValueError(
                f"index at {fm_index_path} was built with {n_shards} shards; "
                f"index_shards={want} cannot re-split a shard-wise build"
            )
        logger.warning(
            "sharded FM-index from %s: %d shards, %d docs",
            fm_index_path, n_shards, sum(h.n_docs for h in hosts),
        )
        tokenizer, model_cfg, main, extra = cls._load_models(
            checkpoint, scorer_checkpoint, title_checkpoint, code_checkpoint,
            tokenizer_path, model_cfg, params, device,
        )
        if mesh is None:
            si = ShardedTorchIndex.from_hosts(hosts, vocab=model_cfg.vocab_size, device=device)
        else:
            si = ShardedTorchIndex.from_hosts(hosts, vocab=model_cfg.vocab_size,
                                              device="cpu").place(mesh)
        union = UnionHostIndex(hosts, assignments, labels=labels)
        return cls(union, tokenizer, model_cfg, main, sharded_index=si, mesh=mesh, **extra,
                   **params)

    @classmethod
    def build_sharded(
        cls,
        docs: Sequence[Sequence[int]],
        labels: Sequence[str],
        tokenizer,
        model_cfg: Union[BartConfig, T5Config],
        params,
        n_shards: int,
        mesh=None,
        **kwargs,
    ) -> "SEALSearcher":
        """Serving mode with the FM-index split into ``n_shards`` shards, all
        on the device of ``params`` (or ``device=``): generation runs the
        sharded decoder, ranking runs against the union host view.  With
        ``mesh``, every rank builds every shard and keeps its own block on
        the mesh's device."""
        device = kwargs.pop("device", None)
        device = params["shared"].device if device is None else device
        si, hosts, assignments = ShardedTorchIndex.build(
            docs, n_shards=n_shards, vocab=model_cfg.vocab_size, labels=labels,
            device=device if mesh is None else "cpu",
        )
        if mesh is not None:
            si = si.place(mesh)
        union = UnionHostIndex(hosts, assignments, labels=labels)
        return cls(union, tokenizer, model_cfg, params, sharded_index=si, mesh=mesh, **kwargs)

    # ---------------------------------------------------------- key generation

    def _generate(self, params, toks, **kw):
        with self.phase_timer.phase("decode"):
            if self.sharded_index is not None:
                return sharded_fm_index_generate(
                    self.model_cfg, params, self.sharded_index, self.mesh, toks, **kw
                )
            return fm_index_generate(self.model_cfg, params, self.device_index, toks, **kw)

    def _rescore_keys(self, *args, **kw):
        with self.phase_timer.phase("rescore"):
            return rk.rescore_keys(*args, **kw)

    def _tokenize_batch(self, texts: Sequence[str]) -> List[List[int]]:
        limit = self.model_cfg.max_position_embeddings
        return [self.tokenizer.encode(t)[:limit] for t in texts]

    # ------------------------------------------------- batched index queries

    def _device_ranges(self, seqs: Sequence[Sequence[int]], lane: int = RANKER_LANE):
        """get_range for many keys in one call: over a sharded index, (0,
        count) surrogate ranges of the summed shard counts (kernel 5's shard
        count mode; on a mesh summed over the ranks on collective ``lane``:
        the ranker's by default, the key producer's for the count filter);
        else the host's native batch when the host index has psi (sub-ms, no
        device round trip), else the device index's sequence kernel (kernel
        5 on the Psi layout, kernel 12 on the wavelet layouts)."""
        seqs = list(seqs)
        if not seqs:
            return []
        if self.sharded_index is None and getattr(self.fm_index, "psi", None) is not None:
            return self.fm_index.get_ranges_batch(seqs)
        rows = seqs
        if self.mesh is not None:
            # a collective's rows must be the same on every rank, and the
            # caller's order may follow this process's string hashes (the
            # query decomposition's set): each distinct key once, sorted
            rows = sorted({tuple(s) for s in seqs})
        L = max(len(s) for s in rows)
        toks = np.zeros((len(rows), L), np.int32)
        lens = np.zeros(len(rows), np.int32)
        for i, s in enumerate(rows):
            toks[i, : len(s)] = s
            lens[i] = len(s)
        if self.sharded_index is not None:
            counts = sharded_count_sequences(self.sharded_index, self.mesh, toks, lens, lane)
            counts = counts.cpu().tolist()
            if self.mesh is not None:
                of = dict(zip(rows, counts))
                counts = [of[tuple(s)] for s in seqs]
            # only the difference of a surrogate range is meaningful
            return [(0, c) for c in counts]
        lo, hi = index_ops(self.device_index).range_for_sequences(self.device_index, toks, lens)
        return list(zip(lo.cpu().tolist(), hi.cpu().tolist()))

    def _device_counts(self, seqs: Sequence[Sequence[int]],
                       lane: int = RANKER_LANE) -> List[int]:
        return [hi - lo for lo, hi in self._device_ranges(seqs, lane)]

    def _count_filter(self, fk):
        """Drop (score, key) pairs whose key does not occur in the corpus
        (reference retrieval.py:91), in one batched call (on the key
        producer's collective lane)."""
        fk = [(sc, k) for sc, k in fk if k]
        if not fk:
            return fk
        counts = self._device_counts([k for _, k in fk], PRODUCER_LANE)
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

    def process_batch(self, inputs: Sequence[str], constrained_generation: bool = True):
        """Key generation for one query batch (reference retrieval.py:54-305);
        ``constrained_generation=False`` decodes freely (``free_generation``):
        the count filters drop the keys that leave the corpus."""
        if not inputs:
            return []
        inputs = [
            (" " + q.strip()) if self.prepend_space else q.strip() for q in inputs
        ]
        gen_common = dict(
            num_beams=self.beam,
            disable_fm_index=not constrained_generation,
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
                counts = self._device_counts(new_fk, PRODUCER_LANE)
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

        if self.decode_code:
            batch_str = self._marked(inputs, "code")
            toks = self._tokenize_batch(batch_str)
            raw = self._generate(
                self.code_params,
                toks,
                min_length=1,
                max_length=15,
                eos_token_id=self.code_eos_token_id,
                force_decoding_from=[self.code_bos_token_id],
                **gen_common,
            )
            new_keys = []
            for fk in raw:
                s = self.strip_token_ids
                if self.force_decoding_second_token >= 0:
                    fk = [(sc, k[:1] + k[2:]) for sc, k in fk if len(k) >= 2]
                fk = [(sc, k[1:-1] if k[-1] in s else k[1:]) for sc, k in fk if k]
                if not self.partial_code:
                    fk = [(sc, k) for sc, k in fk if k and k[-1] == self.code_eos_token_id]
                fk = [
                    (sc, [self.code_bos_token_id] + k if k[0] != self.code_bos_token_id else k)
                    for sc, k in fk if k
                ]
                fk = self._count_filter(fk)
                new_keys.append(fk)
            if self.rescore and self.use_markers:
                new_keys = self._rescore_keys(
                    self.model_cfg,
                    self.code_params,
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
        for off in range(0, len(queries), self.batch_size):
            yield from self.process_batch(
                queries[off : off + self.batch_size],
                constrained_generation=not self.free_generation,
            )

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

    def retrieve_from_keys(self, keys, use_device: bool = True, ranges=None):
        """Rank documents by ``keys`` (or a (keys, unigram scores) pair).
        ``use_device=False`` finds each key's range on the host index
        (``range_fn=None``), as JAX's does; ``ranges`` (``_unit_ranges``'s
        table of every key) replaces the search.  The ranking is the same."""
        unigram_scores = None
        if isinstance(keys, tuple) and len(keys) == 2:
            keys, unigram_scores = keys
        if ranges is not None:
            range_fn = lambda seqs: [ranges[tuple(s)] for s in seqs]  # noqa: E731
        else:
            range_fn = self._device_ranges if use_device else None
        with self.phase_timer.phase("aggregate"):
            results, ngrams = rk.aggregate_evidence(
                ngrams_and_scores=keys,
                unigram_scores=unigram_scores,
                range_fn=range_fn,
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
        if self.jobs >= 2:
            yield from self._mp_batch_retrieve_from_keys(keys)
        else:
            for i, kk in enumerate(keys):
                if self.print_n_doc:
                    print(i)
                yield self.retrieve_from_keys(kk)

    # ------------------------------------------------ jobs >= 2: the workers

    def _knobs(self) -> Dict:
        return {key: getattr(self, key) for key in self.DEFAULTS}

    def _host_ranker(self) -> "SEALSearcher":
        """What a worker ranks with: a searcher holding only this one's host
        index, tokenizer and knobs (no parameters, no device index)."""
        ranker = object.__new__(type(self))
        ranker.fm_index, ranker.tokenizer = self.fm_index, self.tokenizer
        ranker.phase_timer = PhaseTimer(enabled=False)
        ranker.set_params(self._knobs())
        return ranker

    def _worker_pool(self):
        """The pool of ``jobs`` spawned workers, started at its first use and
        kept until ``close()``: a spawned worker takes seconds to import
        torch.  The host ranker goes to a directory of files that lives as
        long as the pool (its pickle and its large arrays), and the workers
        get its path: a start never waits for a worker to read its
        arguments."""
        if self._pool is None or self._pool_size != self.jobs:
            import multiprocessing
            import tempfile
            from concurrent.futures import ProcessPoolExecutor

            self.close()
            self._pool_files = tempfile.TemporaryDirectory(prefix="seal_ranker_")
            path = os.path.join(self._pool_files.name, "ranker.pkl")
            with open(path, "wb") as f:
                _HostPickler(f, self._pool_files.name).dump(self._host_ranker())
            self._pool = ProcessPoolExecutor(
                self.jobs, mp_context=multiprocessing.get_context("spawn"),
                initializer=_worker_init, initargs=(path,))
            self._pool_size = self.jobs
        return self._pool

    def close(self) -> None:
        """Stop the ``jobs`` >= 2 worker pool and remove its files (a no-op
        without one)."""
        if self._pool is not None:
            pool, self._pool = self._pool, None
            pool.shutdown(wait=True, cancel_futures=True)
        if self._pool_files is not None:
            files, self._pool_files = self._pool_files, None
            files.cleanup()

    def _unit_ranges(self, keys) -> Dict[tuple, Tuple[int, int]]:
        """{key: range} of every key of one unit, found as the serial path
        finds them (``_device_ranges`` in one call)."""
        if isinstance(keys, tuple) and len(keys) == 2:
            keys = keys[0]
        uniq = list({tuple(n) for n, _ in keys})
        return dict(zip(uniq, self._device_ranges([list(n) for n in uniq])))

    def _mp_batch_retrieve_from_keys(self, keys):
        """Process-parallel evidence aggregation (reference
        ``retrieval.py:762-775``), in the order of ``keys``, holding at most
        two units a worker in flight so key generation goes on meanwhile.
        Each unit's ranges are found here (``_unit_ranges``) and sent with
        it.  A worker that dies raises ``BrokenProcessPool`` here (and the
        pool is closed: the next call starts a new one)."""
        from concurrent.futures.process import BrokenProcessPool

        pool = self._worker_pool()
        knobs = self._knobs()
        pending: collections.deque = collections.deque()
        try:
            for kk in keys:
                with self.phase_timer.phase("aggregate"):
                    ranges = self._unit_ranges(kk)
                pending.append(pool.submit(_retrieve_from_keys_mp_aux, (knobs, kk, ranges)))
                if len(pending) >= 2 * self.jobs:
                    with self.phase_timer.phase("aggregate"):
                        out = pending.popleft().result()
                    yield out
            while pending:
                with self.phase_timer.phase("aggregate"):
                    out = pending.popleft().result()
                yield out
        except BrokenProcessPool:
            self.close()
            raise
        finally:
            for f in pending:
                f.cancel()

    def _mp_detokenize(self, docs):
        """Process-parallel detokenization (reference ``retrieval.py:693-712``,
        the jobs > 2 path): token splitting stays here (it reads the index),
        BPE decoding fans out to the workers."""
        from concurrent.futures.process import BrokenProcessPool

        splits = [d.split_tokens(d.raw_tokens()) for d in docs]
        try:
            texts = list(self._worker_pool().map(
                _detokenize_mp_aux, splits, chunksize=max(1, len(docs) // (4 * self.jobs))))
        except BrokenProcessPool:
            self.close()
            raise
        for d, (title, body) in zip(docs, texts):
            d._title, d._body = title, body

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
                flat = [d for docs in retrieved for d in docs]
                if self.jobs > 2 and len(flat) > 1:
                    self._mp_detokenize(flat)
                else:
                    # reference detokenize_retrieved strips surrounding
                    # whitespace (retrieval.py:777-778), unlike lazy .text()
                    for d in flat:
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
