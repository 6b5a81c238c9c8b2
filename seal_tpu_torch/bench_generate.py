"""The port's generation operating point, and a profile of one batch.

The operating point is the JAX package's bench (``bench.py:147-193``): a
1.2M-token Zipf(1.3) corpus of 10k docs x 120 tokens, BART-large with
random weights from a seed plus a corpus-unigram logit bias, bf16, batch
32, beam 15, key length 10.  ``chip_smoke.py`` builds it on the card,
times generation over it and profiles one batch with ``profile_batch``.
``build_index`` builds the device index of a host index in one of
``LAYOUTS``: ``"psi"`` (``TorchFMIndex``), ``"compact"`` or ``"hybrid"``
(``WaveletIndex`` without or with the raw BWT).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

BATCH, BEAM, KEY_LEN, VOCAB = 32, 15, 10, 50265
LAYOUTS = ("psi", "compact", "hybrid")


def build_corpus(seed: int = 0):
    """(rng, tokens [10k, 120], docs): 10k docs of 120 Zipf(1.3) tokens + EOS."""
    rng = np.random.default_rng(seed)
    n_docs, doc_len = 10_000, 120
    zipf = rng.zipf(1.3, size=n_docs * doc_len)
    tokens = (zipf % (VOCAB - 10) + 4).astype(np.int64).reshape(n_docs, doc_len)
    return rng, tokens, [row.tolist() + [2] for row in tokens]


def build_model(tokens, device, seed: int = 0):
    """BART-large bf16 serving params: random weights from ``seed``, the
    corpus-unigram logit bias, the SEAL -inf bias, bf16 weight matrices."""
    from seal_tpu_torch.models import bart, convert
    from seal_tpu_torch.models.config import bart_large

    cfg = dataclasses.replace(bart_large(), dtype="bfloat16")
    params = bart.init_params(cfg, seed=seed, device=device)
    # a trained SEAL model concentrates its mass on corpus-plausible
    # tokens; the bias gives random weights that shape
    unigram = np.bincount(tokens.ravel() % VOCAB, minlength=VOCAB).astype(np.float64)
    log_unigram = np.log((unigram + 0.5) / (unigram.sum() + 0.5 * VOCAB))
    params["final_logits_bias"] = params["final_logits_bias"] + torch.as_tensor(
        4.0 * (log_unigram - log_unigram.mean()), dtype=torch.float32, device=device
    )
    return cfg, convert.cast_params(cfg, convert.apply_seal_logits_bias(params, cfg))


def build_queries(rng, pad_id: int):
    from seal_tpu_torch.decoding.generate import pad_batch

    queries = [[0] + rng.integers(4, VOCAB, size=12).tolist() + [2] for _ in range(BATCH)]
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
    kw = dict(num_beams=BEAM, max_length=KEY_LEN, min_length=KEY_LEN - 1, forced_bos_token_id=None)
    return host, index, cfg, params, ids, mask, kw


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
