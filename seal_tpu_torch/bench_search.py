"""The searcher's operating point, and a tiny searcher for card-vs-CPU
checks.

The operating point is the end-to-end leg of the JAX package's bench
(``bench.py:432-504``): a word-vocab corpus of 10k documents, each
``Title{i} @@`` and 110 words drawn from 30k words ``w0..w29999`` at Zipf
0.8, a ``WordVocabTokenizer`` trained on it (its GPT-2 split cuts " w123"
into " w" and "123": 2.24M tokens in all),
BART-large widths in bf16 with random weights from a seed and the plain
SEAL logit bias, and the searcher's default knobs (beam 15, key length 10,
body and title decodes, rescoring, query decomposition, unigram scores,
pipelining) at batch size 16.  The queries are 6-word spans of random
documents.  ``chip_smoke.py`` builds it on the card and times
``batch_search`` over it.  ``layout_knobs`` gives the searcher knobs that
pick its device index (``"psi"``, ``"compact"`` or ``"hybrid"``).

``sharded_searcher`` is the sharded operating point: the same documents,
tokenizer, model and knobs through ``SEALSearcher.build_sharded``, the
index split round-robin into ``bench_generate.SHARDS`` shards on one
device.

``t5_operating_point`` is a searcher unit over T5-base (f32, as the JAX
searcher builds it for a ``t5`` backbone) at ``backbone="t5-base"`` and the
default knobs: the T5 generation corpus's bodies (``bench_generate``,
Zipf ids in [2, 32000)) behind 3-id titles and T5's title marker 32000,
each document ending in eos 1, read by ``IdTokenizer``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from seal_tpu_torch.bench_generate import LAYOUTS, SHARDS

N_DOCS, N_WORDS, DOC_WORDS, ZIPF_A = 10_000, 30_000, 110, 0.8
BATCH_SIZE, N_QUERIES, TOP_K = 16, 32, 10


def layout_knobs(layout: str) -> dict:
    """The searcher knobs that build ``layout``'s device index."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown index layout {layout!r} (one of {LAYOUTS})")
    return dict(compact_index=layout == "compact", hybrid_index=layout == "hybrid")


def build_texts(rng, n_docs: int = N_DOCS):
    words = np.array([f"w{i}" for i in range(N_WORDS)])
    probs = 1.0 / np.arange(1, N_WORDS + 1) ** ZIPF_A
    probs /= probs.sum()
    return [
        f"Title{i} @@ " + " ".join(rng.choice(words, size=DOC_WORDS, p=probs))
        for i in range(n_docs)
    ]


def build_queries(rng, texts, n: int = N_QUERIES):
    queries = []
    for _ in range(n):
        d = texts[int(rng.integers(0, len(texts)))].split("@@ ")[1].split()
        s = int(rng.integers(0, max(1, len(d) - 6)))
        queries.append(" ".join(d[s : s + 6]))
    return queries


def operating_point(device="cuda", seed: int = 0):
    """(searcher, queries) at the end-to-end bench point on ``device``."""
    from seal_tpu_torch.index.fm_index import FMIndex
    from seal_tpu_torch.models import bart, convert
    from seal_tpu_torch.models.config import bart_large
    from seal_tpu_torch.models.tokenizer import WordVocabTokenizer
    from seal_tpu_torch.retrieval.searcher import SEALSearcher

    rng = np.random.default_rng(seed)
    texts = build_texts(rng)
    tok = WordVocabTokenizer.train([" " + t for t in texts], max_vocab=50_000)
    host = FMIndex()
    host.initialize([tok.encode_plain(" " + t) + [tok.eos_token_id] for t in texts],
                    labels=[f"d{i}" for i in range(len(texts))])
    cfg = dataclasses.replace(bart_large(), dtype="bfloat16")
    params = bart.init_params(cfg, seed=seed, device=device)
    params = convert.apply_seal_logits_bias(params, cfg)  # the plain SEAL bias
    searcher = SEALSearcher(host, tok, cfg, params, backbone="word-vocab-large",
                            batch_size=BATCH_SIZE)
    return searcher, build_queries(rng, texts)


def sharded_searcher(searcher, n_shards: int = SHARDS):
    """``searcher``'s documents, tokenizer, parameters and knobs over an
    index split round-robin into ``n_shards`` shards on its device
    (``SEALSearcher.build_sharded``)."""
    from seal_tpu_torch.retrieval.searcher import SEALSearcher

    host = searcher.fm_index
    docs = [host.get_doc(i) for i in range(host.n_docs)]
    knobs = {k: getattr(searcher, k) for k in SEALSearcher.DEFAULTS}
    return SEALSearcher.build_sharded(docs, host.labels, searcher.tokenizer, searcher.model_cfg,
                                      searcher.params, n_shards, **knobs)


class IdTokenizer:
    """An id-level tokenizer with T5's special ids (pad = bos = 0, eos 1):
    the word ``tN`` is id N; other words are dropped."""

    pad_token_id = bos_token_id = unk_token_id = mask_token_id = 0
    eos_token_id = 1

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def __len__(self):
        return self.vocab_size

    def encode_plain(self, text):
        return [int(w[1:]) for w in text.split() if w[:1] == "t" and w[1:].isdigit()]

    def encode(self, text, add_special_tokens=True):
        ids = self.encode_plain(text)
        return ids + [self.eos_token_id] if add_special_tokens else ids

    def decode(self, ids, skip_special_tokens=False):
        return " ".join(f"t{i}" for i in ids if not (skip_special_tokens and i < 2))

    def batch_decode(self, seqs, **kw):
        return [self.decode(s, **kw) for s in seqs]


def t5_operating_point(device="cuda", seed: int = 0, n_queries: int = BATCH_SIZE):
    """(searcher, queries): one unit of ``n_queries`` 6-id body spans over
    T5-base f32 (``bench_generate.build_t5_model``: random weights from
    ``seed``, the corpus-unigram logit bias, the SEAL bias), 10k documents
    ``title (3 ids) 32000 body (120 ids) 1``."""
    from seal_tpu_torch.bench_generate import T5_CONTENT, build_corpus, build_t5_model
    from seal_tpu_torch.index.fm_index import FMIndex
    from seal_tpu_torch.retrieval.searcher import SEALSearcher

    lo, hi = T5_CONTENT
    rng, bodies, _ = build_corpus(seed, lo=lo, hi=hi, eos=1)
    titles = rng.integers(lo, hi, size=(len(bodies), 3))
    host = FMIndex()
    host.initialize([t.tolist() + [32000] + b.tolist() + [1] for t, b in zip(titles, bodies)],
                    labels=[f"d{i}" for i in range(len(bodies))])
    cfg, params = build_t5_model(bodies, device, seed=seed)
    searcher = SEALSearcher(host, IdTokenizer(cfg.vocab_size), cfg, params, backbone="t5-base",
                            batch_size=BATCH_SIZE)
    queries = []
    for _ in range(n_queries):
        body = bodies[int(rng.integers(0, len(bodies)))]
        s = int(rng.integers(0, len(body) - 6))
        queries.append(" ".join(f"t{t}" for t in body[s : s + 6]))
    return searcher, queries


TINY_CORPUS = [
    ("d0", "Soup", "You can eat soup with a spoon but eating soup with a fork is hard."),
    ("d1", "Forks", "A fork is a utensil with tines used for spearing solid food."),
    ("d2", "Bicycles", "A bicycle has two wheels and is propelled by pedals."),
    ("d3", "Rivers", "A river is a natural stream of fresh water flowing toward an ocean."),
    ("d4", "Chess", "Chess is a board game for two players with sixteen pieces each."),
]
TINY_QUERIES = ["eating soup with a fork", "two wheels pedals bicycle",
                "fresh water river ocean", "chess board game", "spearing solid food"]


def tiny_searcher(device, seed: int = 0, layout: str = "psi"):
    """A bart_tiny f32 searcher over the five ``TINY_CORPUS`` documents and
    20 filler documents, with every key path on.  The logit bias (a
    stand-in for a trained model) boosts the documents' words, and their
    titles and the title marker most, each by a random amount so no two
    are tied.  The same seed gives the same weights on every device."""
    from seal_tpu_torch.index.fm_index import FMIndex
    from seal_tpu_torch.models import bart
    from seal_tpu_torch.models.config import bart_tiny
    from seal_tpu_torch.models.tokenizer import WordVocabTokenizer
    from seal_tpu_torch.retrieval.searcher import SEALSearcher

    rng = np.random.default_rng(seed)
    filler_words = [f"word{i}" for i in range(80)]
    corpus = TINY_CORPUS + [
        (f"f{i}", f"Filler{i}", " ".join(rng.choice(filler_words, size=30))) for i in range(20)
    ]
    texts = [f"{title} @@ {body}" for _, title, body in corpus]
    tok = WordVocabTokenizer.train([" " + t for t in texts], max_vocab=500)
    host = FMIndex()
    host.initialize([tok.encode_plain(" " + t) + [tok.eos_token_id] for t in texts],
                    labels=[d for d, _, _ in corpus])
    cfg = bart_tiny(vocab_size=tok.vocab_size)
    params = bart.init_params(cfg, seed=seed, device="cpu")
    bias = np.zeros(cfg.vocab_size, np.float32)
    for _, title, body in TINY_CORPUS:
        for t in tok.encode_plain(" " + body.lower()) + tok.encode_plain(" " + body):
            bias[t] = 6.0 + rng.random()
    for _, title, _ in TINY_CORPUS:
        for t in tok.encode_plain(" " + title + " @@"):
            bias[t] = 8.0 + rng.random()
    params["final_logits_bias"] = torch.as_tensor(bias)
    params = _tree_to(params, device)
    return SEALSearcher(host, tok, cfg, params, backbone="word-vocab", beam=4, length=4,
                        batch_size=2, **layout_knobs(layout))


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)
