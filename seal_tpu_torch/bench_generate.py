"""The port's generation operating points, and a profile of one batch.

The operating point is the JAX package's bench (``bench.py:147-193``): a
1.2M-token Zipf(1.3) corpus of 10k docs x 120 tokens, BART-large with
random weights from a seed plus a corpus-unigram logit bias, bf16, batch
32, beam 15, key length 10.  ``chip_smoke.py`` builds it on the card,
times generation over it and profiles one batch with ``profile_batch``.
``t5_operating_point`` is the same corpus shape and decode over T5-base
(``T5Config()``, the model the JAX searcher builds for a ``t5`` backbone),
f32 by default: content ids [2, 32000), documents ending in T5's eos 1,
queries without a BOS.  ``build_index`` builds the device index of a host
index in one of ``LAYOUTS``: ``"psi"`` (``TorchFMIndex``), ``"compact"``
or ``"hybrid"`` (``WaveletIndex`` without or with the raw BWT).
``sharded_index`` is the sharded operating point's index: the same corpus
split round-robin into ``SHARDS`` shards on one device
(``ShardedTorchIndex``), decoded with the same model and queries.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

BATCH, BEAM, KEY_LEN, VOCAB = 32, 15, 10, 50265
SHARDS = 4  # the sharded operating point: the generation corpus in 4 shards
LAYOUTS = ("psi", "compact", "hybrid")
# T5-base's content ids: below the extra ids of T5's 32128-id vocabulary,
# past pad 0 and eos 1
T5_CONTENT = (2, 32000)


def build_corpus(seed: int = 0, lo: int = 4, hi: int = VOCAB - 6, eos: int = 2):
    """(rng, tokens [10k, 120], docs): 10k docs of 120 Zipf(1.3) tokens,
    folded into the content ids [lo, hi), each doc ending in ``eos``; the
    defaults are BART's ids."""
    rng = np.random.default_rng(seed)
    n_docs, doc_len = 10_000, 120
    zipf = rng.zipf(1.3, size=n_docs * doc_len)
    tokens = (zipf % (hi - lo) + lo).astype(np.int64).reshape(n_docs, doc_len)
    return rng, tokens, [row.tolist() + [eos] for row in tokens]


def _unigram_bias(tokens, vocab: int):
    """A trained SEAL model concentrates its mass on corpus-plausible
    tokens; this f32 [vocab] logit bias (4 x the centred corpus log-unigram)
    gives random weights that shape."""
    unigram = np.bincount(tokens.ravel() % vocab, minlength=vocab).astype(np.float64)
    log_unigram = np.log((unigram + 0.5) / (unigram.sum() + 0.5 * vocab))
    return 4.0 * (log_unigram - log_unigram.mean())


def build_model(tokens, device, seed: int = 0):
    """BART-large bf16 serving params: random weights from ``seed``, the
    corpus-unigram logit bias, the SEAL -inf bias, bf16 weight matrices."""
    from seal_tpu_torch.models import bart, convert
    from seal_tpu_torch.models.config import bart_large

    cfg = dataclasses.replace(bart_large(), dtype="bfloat16")
    params = bart.init_params(cfg, seed=seed, device=device)
    params["final_logits_bias"] = params["final_logits_bias"] + torch.as_tensor(
        _unigram_bias(tokens, VOCAB), dtype=torch.float32, device=device
    )
    return cfg, convert.cast_params(cfg, convert.apply_seal_logits_bias(params, cfg))


def build_t5_model(tokens, device, seed: int = 0, dtype: str = "float32"):
    """T5-base serving params (``T5Config()``, in ``dtype``): random weights
    from ``seed``, the corpus-unigram logit bias as ``final_logits_bias`` (HF
    T5 has none; the JAX module adds one when the tree has it), the SEAL -inf
    bias (pad = bos = 0), compute-dtype weight matrices."""
    from seal_tpu_torch.models import convert, t5

    cfg = dataclasses.replace(t5.T5Config(), dtype=dtype)
    params = t5.init_params(cfg, seed=seed, device=device)
    params["final_logits_bias"] = torch.as_tensor(
        _unigram_bias(tokens, cfg.vocab_size), dtype=torch.float32, device=device
    )
    return cfg, convert.cast_params(cfg, convert.apply_seal_logits_bias(params, cfg))


def build_queries(rng, pad_id: int, lo: int = 4, hi: int = VOCAB, eos: int = 2,
                  lead: tuple = (0,)):
    """BATCH queries of 12 ids in [lo, hi) between ``lead`` and ``eos``,
    padded; the defaults are BART's (BOS 0 first)."""
    from seal_tpu_torch.decoding.generate import pad_batch

    queries = [list(lead) + rng.integers(lo, hi, size=12).tolist() + [eos] for _ in range(BATCH)]
    return pad_batch(queries, pad_id)


def build_index(host, layout: str, device, vocab: int = VOCAB):
    """The device index of ``host`` in ``layout`` (one of ``LAYOUTS``)."""
    from seal_tpu_torch.index.device_index import TorchFMIndex
    from seal_tpu_torch.index.wavelet import WaveletIndex

    if layout == "psi":
        return TorchFMIndex.from_host(host, vocab=vocab, device=device)
    if layout in ("compact", "hybrid"):
        return WaveletIndex.from_host(host, vocab=vocab, keep_bwt=layout == "hybrid",
                                      device=device)
    raise ValueError(f"unknown index layout {layout!r} (one of {LAYOUTS})")


def operating_point(device="cuda"):
    """(host FMIndex, device index, cfg, params, ids, mask, generate kwargs)."""
    from seal_tpu_torch.index.fm_index import FMIndex

    rng, tokens, docs = build_corpus()
    host = FMIndex()
    host.initialize(docs)
    index = build_index(host, "psi", device)
    cfg, params = build_model(tokens, device)
    ids, mask = build_queries(rng, cfg.pad_token_id)
    return host, index, cfg, params, ids, mask, _decode_kw()


def sharded_index(device="cuda", n_shards: int = SHARDS):
    """(``ShardedTorchIndex``, per-shard host FMIndexes) of the generation
    corpus split round-robin into ``n_shards`` shards on ``device``."""
    from seal_tpu_torch.parallel.sharded_index import ShardedTorchIndex

    _, _, docs = build_corpus()
    si, hosts, _ = ShardedTorchIndex.build(docs, n_shards, VOCAB, device=device)
    return si, hosts


def _decode_kw():
    return dict(num_beams=BEAM, max_length=KEY_LEN, min_length=KEY_LEN - 1,
                forced_bos_token_id=None)


def t5_operating_point(device="cuda", dtype: str = "float32"):
    """The generation point over T5-base: (host FMIndex, device index, cfg,
    params, ids, mask, generate kwargs)."""
    from seal_tpu_torch.index.fm_index import FMIndex

    lo, hi = T5_CONTENT
    rng, tokens, docs = build_corpus(lo=lo, hi=hi, eos=1)
    host = FMIndex()
    host.initialize(docs)
    cfg, params = build_t5_model(tokens, device, dtype=dtype)
    index = build_index(host, "psi", device, vocab=cfg.vocab_size)
    ids, mask = build_queries(rng, cfg.pad_token_id, lo=lo, hi=hi, eos=cfg.eos_token_id,
                              lead=())
    return host, index, cfg, params, ids, mask, _decode_kw()


def profile_batch(run) -> dict:
    """Device time by kernel and the device's busy share over one batch
    (kernel intervals on the device clock, from ``torch.profiler``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    spans = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        ms, calls = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, calls + 1)
    busy_us, last_end = 0.0, float("-inf")
    for start, end in sorted(spans):  # union of kernel intervals
        busy_us += max(0.0, end - max(start, last_end))
        last_end = max(last_end, end)
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_us / 1e3,
        "busy_share": busy_us / 1e3 / wall_ms,
        "kernels": len(spans),
        "top": [{"name": n[:100], "ms": ms, "calls": c} for n, (ms, c) in rows[:30]],
    }
