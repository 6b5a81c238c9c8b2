#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``seal_tpu_torch``) on one GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi); exits non-zero
   without a result when no CUDA device is available or the package is
   missing.
2. Builds the CUDA kernels from ``seal_tpu_torch/kernels/csrc`` (timed).
3. Drives the main path: ``fm_index_generate`` with BART-large (random
   weights from a seed, bf16) over a 1.2M-token Zipf corpus (10k docs x
   120 tokens), batch 32, beam 15, key length 10 (the operating point of
   ``seal_tpu_torch.bench_generate``), and reports queries/s and how often
   each kernel was launched in that run.
4. Checks every emitted key against the host index (``get_count > 0``),
   that a ``force_full`` re-run gives identical hypotheses, and that every
   kernel of the path was launched; profiles one more batch (device time
   by kernel, the device's busy share).
5. Holds each of the four kernels against its plain PyTorch version at the
   main path's shapes, on the card, and times both; runs the port on the
   card against its plain CPU path on a small input; checks the bf16 LM
   head's f32 result.
6. Drives the second path, ``SEALSearcher.batch_search`` at the
   end-to-end bench point of ``seal_tpu_torch.bench_search`` (BART-large
   bf16, a 10k-document word corpus, 32 queries in units of 16, every key
   path on): reports queries/s, the phase split and each kernel's launches
   in that run; checks that the raw body and title keys of one unit are
   grounded and that a ``force_full`` re-run of its title decode is
   identical; profiles one unit; holds kernels 5-7 against their plain
   versions at the path's shapes; runs the tiny searcher on the card
   against its CPU path.

Each path's launch counts come from that path's own run (every count set
to 0 just before it, read just after).  Prints one JSON object with the
kernel table on the line before the last, and ``{"ok": true, "device":
{...}}`` as the last line.  Imports no jax.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# the TPU op each kernel replaces (file:line of its definition)
REPLACES = {
    "fm_search": "seal_tpu/ops/fm_ops.py:166",
    "window_gather": "seal_tpu/ops/_generic.py:41",
    "row_topk": "seal_tpu/decoding/constrained.py:395",
    "log_softmax_min_len": "seal_tpu/decoding/constrained.py:276",
    "fm_sequences": "seal_tpu/ops/_generic.py:17",
    "bucket_counts": "seal_tpu/ops/fm_ops.py:238",
    "rescore_logprob": "seal_tpu/scoring/keys.py:102",
}
SOURCES = {
    "fm_search": ("cuda", "seal_tpu_torch/kernels/csrc/fm_search.cu"),
    "window_gather": ("cuda", "seal_tpu_torch/kernels/csrc/window_gather.cu"),
    "row_topk": ("cuda", "seal_tpu_torch/kernels/csrc/row_topk.cu"),
    "log_softmax_min_len": ("triton", "seal_tpu_torch/kernels/triton_logsoftmax.py"),
    "fm_sequences": ("cuda", "seal_tpu_torch/kernels/csrc/fm_search.cu"),
    "bucket_counts": ("cuda", "seal_tpu_torch/kernels/csrc/bucket_counts.cu"),
    "rescore_logprob": ("cuda", "seal_tpu_torch/kernels/csrc/rescore.cu"),
}
# the kernels each driven path must launch (bucket_counts runs only in the
# proven loop's later rounds, which the force_full re-runs reach; kernel 4
# must also show from the unigram call on its own)
PATH_KERNELS = {
    "generate": ("fm_search", "window_gather", "row_topk", "log_softmax_min_len"),
    "generate_force_full": ("bucket_counts",),
    "batch_search": ("fm_search", "window_gather", "row_topk", "log_softmax_min_len",
                     "fm_sequences", "rescore_logprob"),
    "unigram": ("log_softmax_min_len",),
    "grounding_unit": ("fm_sequences",),
}
# kernel 4 sums a 50265-wide row in another order than torch: f32 rounding
# of a log-sum-exp near 11 is ~1e-6; 1e-4 leaves room for the sum order
LOGSOFTMAX_ATOL = 1e-4
# kernel 7 sums <= 16 log-probs per key, each off by f32 rounding of a
# 50265-wide log-sum-exp (~1e-6): 1e-4 per key leaves room for the order
RESCORE_ATOL = 1e-4
# the tiny searcher on the card against its CPU path (same f32 weights):
# doc scores are sums of log-odds of f32 log-probs
SEARCH_RTOL = 1e-4
# the bf16 LM head must return its f32 accumulator: against the f32 matmul it
# is off by ~1e-5 (summation order), while rounding the output to bf16 (logits
# up to ~3.5 here) would cost up to ~8e-3
LM_HEAD_ATOL = 1e-4

FAILURES: list[str] = []


def fail(msg: str) -> None:
    FAILURES.append(msg)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_phases(np, torch, host, index, V, B, K):
    """Each kernel against its plain version at main-path shapes."""
    from seal_tpu_torch.kernels import fm_search as k1
    from seal_tpu_torch.kernels import row_topk as k3
    from seal_tpu_torch.kernels import triton_logsoftmax as k4
    from seal_tpu_torch.kernels import window_gather as k2

    dev = index.device
    g = torch.Generator(device=dev).manual_seed(1)
    rng = np.random.default_rng(1)
    N = index.n_rows
    table = []

    # ranges like a decode's: one- and two-token prefixes of corpus text,
    # plus the full range, empty ranges and ranges at the end
    corpus_toks = torch.as_tensor(rng.choice(host.text[:-1] - 1, size=(2, B, K)), device=dev)
    full_lo, full_hi = index.full_range((B, K))
    lo1, hi1 = k1.backward_step_plain(index, corpus_toks[0].int(), full_lo, full_hi)
    lo2, hi2 = k1.backward_step_plain(index, corpus_toks[1].int(), lo1, hi1)
    lo = torch.where(torch.arange(K, device=dev) % 2 == 0, lo1, lo2)
    hi = torch.where(torch.arange(K, device=dev) % 2 == 0, hi1, hi2)
    lo[0, 0], hi[0, 0] = 0, N
    lo[0, 1], hi[0, 1] = 5, 5
    lo[0, 2], hi[0, 2] = N, N

    # kernel 1: backward step [B, K] and membership [B, K, 65]
    ext = torch.randint(-1, V + 2, (B, K), generator=g, device=dev, dtype=torch.int32)
    got = k1.fm_search(index, "backward_step", ext, lo, hi)
    want = k1.backward_step_plain(index, ext, lo, hi)
    err1 = max(int((a - b).abs().max()) for a, b in zip(got, want))
    cand = torch.randint(0, V, (B, K, 65), generator=g, device=dev, dtype=torch.int32)
    cand[..., :32] = corpus_toks[0, :, :, None].int()  # likely members
    cand[..., -1] = 2
    got_c = k1.fm_search(index, "contains", cand, lo, hi)
    want_c = k1.contains_plain(index, cand, lo, hi)
    err1 = max(err1, int((got_c != want_c).sum()))
    if err1:
        fail(f"fm_search differs from its plain version (max err {err1})")
    table.append(dict(
        name="fm_search", max_abs_err=err1,
        ms=time_ms(lambda: k1.fm_search(index, "contains", cand, lo, hi)),
        plain_ms=time_ms(lambda: k1.contains_plain(index, cand, lo, hi)),
        shape=f"contains [{B},{K},65]; backward_step [{B},{K}]",
        members=int(want_c.sum()),
    ))

    # kernel 2: window [B*K rows, w=32, fill pad] and a slab (w=64, fill 0)
    lp = torch.log_softmax(torch.randn(B * K, V, generator=g, device=dev), -1)
    err2 = 0.0
    for w, fill in ((32, 1), (64, 0)):
        got = k2.window_gather(index, lo, hi, w, lp, fill)
        want = k2.window_gather_plain(index, lo, hi, w, lp, fill)
        err2 = max(err2, float((got[0] - want[0]).abs().max()),
                   float((got[1] != want[1]).sum()), float((got[2] - want[2]).abs().max()))
    if err2:
        fail(f"window_gather differs from its plain version (max err {err2})")
    table.append(dict(
        name="window_gather", max_abs_err=err2,
        ms=time_ms(lambda: k2.window_gather(index, lo, hi, 32, lp, 1)),
        plain_ms=time_ms(lambda: k2.window_gather_plain(index, lo, hi, 32, lp, 1)),
        shape=f"[{B * K}, w=32] over lp [{B * K},{V}]",
    ))

    # kernel 3: every top-k of the path; values rounded so ties abound
    lpq = torch.round(lp * 8) / 8
    lpq[3] = float("-inf")
    lpq[5, :4000] = 7.5
    err3 = 0.0
    for x, k in ((lpq, 64), (lpq, 256), (lpq[:B], 2 * K),
                 (torch.round(torch.randn(B, K * 64, generator=g, device=dev) * 4) / 4, 2 * K),
                 (torch.round(torch.randn(B * K, 158, generator=g, device=dev) * 4) / 4, 2 * K)):
        gv, gi = k3.row_topk(x, k)
        wv, wi = k3.row_topk_plain(x, k)
        if not (torch.equal(gi, wi) and torch.equal(gv, wv)):
            err3 = max(err3, float((gi != wi).sum()), 1.0)
    if err3:
        fail(f"row_topk differs from its plain version ({err3} index mismatches)")
    table.append(dict(
        name="row_topk", max_abs_err=err3,
        ms=time_ms(lambda: k3.row_topk(lp, 64)),
        plain_ms=time_ms(lambda: k3.row_topk_plain(lp, 64)),
        shape=f"[{B * K},{V}] k=64",
    ))

    # kernel 4: log-softmax with the EOS ban over f32 logits
    logits = torch.randn(B * K, V, generator=g, device=dev) * 3
    logits[:, 1] = float("-inf")
    got = k4.log_softmax_ban(logits, 2, -1.7e38)
    want = k4.log_softmax_ban_plain(logits, 2, -1.7e38)
    fin = torch.isfinite(want)
    err4 = float((got[fin] - want[fin]).abs().max())
    if err4 > LOGSOFTMAX_ATOL or not torch.equal(torch.isfinite(got), fin):
        fail(f"log_softmax_min_len differs from its plain version (max err {err4})")
    table.append(dict(
        name="log_softmax_min_len", max_abs_err=err4, atol=LOGSOFTMAX_ATOL,
        ms=time_ms(lambda: k4.log_softmax_ban(logits, 2, -1.7e38)),
        plain_ms=time_ms(lambda: k4.log_softmax_ban_plain(logits, 2, -1.7e38)),
        shape=f"[{B * K},{V}]",
    ))
    torch.cuda.synchronize()
    return table


def small_parity(np, torch):
    """The port on the card vs the port's plain CPU path, on a tiny model
    and corpus (the CPU path is held to the JAX package by the tests)."""
    from seal_tpu.index import FMIndex
    from seal_tpu_torch.decoding.generate import fm_index_generate, pad_batch
    from seal_tpu_torch.index.device_index import TorchFMIndex
    from seal_tpu_torch.models import bart
    from seal_tpu_torch.models.config import bart_tiny

    cfg = bart_tiny(vocab_size=96)
    params_cpu = bart.init_params(cfg, seed=0, device="cpu")
    params_gpu = _tree_to(params_cpu, "cuda")
    n_keys = 0
    for seed in range(3):
        rng = np.random.default_rng(seed)
        docs = [rng.integers(4, 90, size=rng.integers(5, 30)).tolist() + [2] for _ in range(30)]
        host = FMIndex()
        host.initialize(docs)
        queries = [[0] + rng.integers(4, 90, size=5).tolist() + [2] for _ in range(3)]
        ids, mask = pad_batch(queries, cfg.pad_token_id)
        kw = dict(num_beams=4, max_length=6, min_length=1, window=4, exact_chunk=4)
        out = {}
        for dev, params in (("cpu", params_cpu), ("cuda", params_gpu)):
            idx = TorchFMIndex.from_host(host, vocab=96, device=dev)
            out[dev] = fm_index_generate(cfg, params, idx, ids, mask, **kw)
        for a, b in zip(out["cpu"], out["cuda"]):
            ka, kb = sorted((tuple(t), s) for s, t in a), sorted((tuple(t), s) for s, t in b)
            if [t for t, _ in ka] != [t for t, _ in kb]:
                fail(f"small-input parity: keys differ between card and CPU (seed {seed})")
            elif ka and max(abs(x[1] - y[1]) for x, y in zip(ka, kb)) > 1e-4:
                fail(f"small-input parity: scores differ by > 1e-4 (seed {seed})")
            n_keys += len(ka)
    return n_keys


def search_kernel_phases(np, torch, host, index, vocab):
    """Kernels 5-7 against their plain versions at the searcher path's
    shapes, on the searcher's index."""
    from seal_tpu_torch.kernels import bucket_counts as k6
    from seal_tpu_torch.kernels import fm_search as k5
    from seal_tpu_torch.kernels import rescore as k7

    dev = index.device
    rng = np.random.default_rng(2)
    g = torch.Generator(device=dev).manual_seed(2)
    text = host.text[:-1] - 1  # the documents, each reversed
    table = []

    # kernel 5: 4096 corpus n-grams (forward), lengths 1-16; an eighth are
    # random ids, some out of the vocab
    n, L = 4096, 16
    starts = rng.integers(0, text.size - L, size=n)
    toks = np.stack([text[s : s + L][::-1] for s in starts]).astype(np.int32)
    toks[: n // 8] = rng.integers(-1, vocab + 2, size=(n // 8, L))
    toks = torch.as_tensor(toks, device=dev)
    lens = torch.as_tensor(rng.integers(1, L + 1, size=n).astype(np.int32), device=dev)
    got = k5.fm_sequences(index, toks, lens)
    want = k5.sequences_plain(index, toks, lens)
    err5 = max(int((a - b).abs().max()) for a, b in zip(got, want))
    if err5:
        fail(f"fm_sequences differs from its plain version (max err {err5})")
    table.append(dict(
        name="fm_sequences", max_abs_err=err5,
        ms=time_ms(lambda: k5.fm_sequences(index, toks, lens)),
        plain_ms=time_ms(lambda: k5.sequences_plain(index, toks, lens)),
        shape=f"[{n}, {L}], lengths 1-{L}, {int(((want[1] - want[0]) > 0).sum())} non-empty",
    ))

    # kernel 6: [16, 15] ranges of one- and two-token corpus prefixes, plus
    # the full range, a whole bucket block and an empty range
    B, K = 16, 15
    first = torch.as_tensor(rng.choice(text, size=(2, B, K)).astype(np.int32), device=dev)
    full_lo, full_hi = index.full_range((B, K))
    lo1, hi1 = k5.backward_step_plain(index, first[0], full_lo, full_hi)
    lo2, hi2 = k5.backward_step_plain(index, first[1], lo1, hi1)
    even = torch.arange(K, device=dev) % 2 == 0
    lo, hi = torch.where(even, lo1, lo2), torch.where(even, hi1, hi2)
    lo[0, 0], hi[0, 0] = 0, index.n_rows
    lo[0, 1], hi[0, 1] = 1024, 2048
    lo[0, 2], hi[0, 2] = 5, 5
    err6 = int((k6.bucket_counts(index, lo, hi) - k6.bucket_counts_plain(index, lo, hi))
               .abs().max())
    if err6:
        fail(f"bucket_counts differs from its plain version (max err {err6})")
    table.append(dict(
        name="bucket_counts", max_abs_err=err6,
        ms=time_ms(lambda: k6.bucket_counts(index, lo, hi)),
        plain_ms=time_ms(lambda: k6.bucket_counts_plain(index, lo, hi)),
        shape=f"[{B},{K}] ranges x {index.n_buckets} buckets",
    ))

    # kernel 7: a full rescoring sub-batch of f32 logits, with the SEAL
    # bias's -inf columns and pad targets
    N, T = 256, 16
    logits = torch.randn((N, T, vocab), generator=g, device=dev) * 3
    logits[..., 1] = float("-inf")
    tgt = torch.randint(2, vocab, (N, T), generator=g, device=dev, dtype=torch.int32)
    tgt[:, -4:] = 1
    err7 = 0.0
    for n_prefix in (0, 1):
        got = k7.rescore_logprob(logits, tgt, n_prefix)
        want = k7.rescore_logprob_plain(logits, tgt, n_prefix)
        err7 = max(err7, float((got - want).abs().max()))
        if not torch.equal(got, k7.rescore_logprob(logits, tgt, n_prefix)):
            fail("rescore_logprob gives other bits on a second run")
    if err7 > RESCORE_ATOL:
        fail(f"rescore_logprob differs from its plain version (max err {err7})")
    table.append(dict(
        name="rescore_logprob", max_abs_err=err7, atol=RESCORE_ATOL,
        ms=time_ms(lambda: k7.rescore_logprob(logits, tgt, 0)),
        plain_ms=time_ms(lambda: k7.rescore_logprob_plain(logits, tgt, 0)),
        shape=f"[{N},{T},{vocab}] f32",
    ))
    del logits
    torch.cuda.synchronize()
    return table


def searcher_grounding(searcher, queries):
    """One unit's raw body and title hypotheses, decoded as
    ``process_batch`` decodes them: every body key occurs in the corpus; a
    title key occurs after the forced prefix from its second token on (its
    first token is chosen under the dense corpus mask, the JAX decoder's
    step-0 rule, and occurs on its own); a ``force_full`` re-run of the
    title decode gives identical hypotheses.  Returns (body keys, title
    keys) checked."""
    s = searcher
    cfg, host = s.model_cfg, s.fm_index
    inputs = [" " + q.strip() for q in queries]
    common = dict(num_beams=s.beam, forced_bos_token_id=None, top_m=s.top_m, window=s.window)
    special = (cfg.eos_token_id, cfg.pad_token_id, cfg.bos_token_id)
    body = s._generate(s.params, s._tokenize_batch(s._marked(inputs, "body")),
                       min_length=s.length, max_length=s.length, **common)
    n_body = 0
    for hyps in body:
        for _, toks in hyps:
            key = [t for t in toks[1:] if t not in special]
            if key:
                n_body += 1
                if host.get_count(key) <= 0:
                    fail(f"body key not in the corpus: {key}")
    title_toks = s._tokenize_batch(s._marked(inputs, "title"))
    title_kw = dict(min_length=1, max_length=15, eos_token_id=s.title_eos_token_id,
                    force_decoding_from=[s.title_bos_token_id], **common)
    title = s._generate(s.title_params, title_toks, **title_kw)
    n_title = 0
    for hyps in title:
        for _, toks in hyps:
            key = [t for t in toks[1:] if t not in (cfg.pad_token_id, cfg.bos_token_id)]
            n_title += 1
            want = [s.title_bos_token_id] + key if len(key) >= 2 else key
            if host.get_count(want) <= 0:
                fail(f"title key not in the corpus: {want}")
    full = s._generate(s.title_params, title_toks, force_full=True, **title_kw)
    if [sorted((tuple(t), sc) for sc, t in h) for h in title] != [
        sorted((tuple(t), sc) for sc, t in h) for h in full
    ]:
        fail("force_full title hypotheses differ from the fast path's")
    if not n_body or not n_title:
        fail(f"grounding check saw {n_body} body and {n_title} title keys")
    return n_body, n_title


def small_search_parity(np):
    """The tiny searcher on the card vs on the CPU: same doc ids in the same
    order, scores within SEARCH_RTOL."""
    from seal_tpu_torch import bench_search

    cpu = bench_search.tiny_searcher("cpu").batch_search(bench_search.TINY_QUERIES, k=5)
    gpu = bench_search.tiny_searcher("cuda").batch_search(bench_search.TINY_QUERIES, k=5)
    n = 0
    for a, b in zip(cpu, gpu):
        if [d.docid for d in a] != [d.docid for d in b]:
            fail("small searcher parity: doc ids differ between card and CPU")
        elif a and np.max(np.abs(np.subtract([d.score for d in b], [d.score for d in a]))
                          / np.abs([d.score for d in a])) > SEARCH_RTOL:
            fail("small searcher parity: scores differ by more than the tolerance")
        n += len(a)
    if n == 0:
        fail("small searcher parity: no documents retrieved")
    return n


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "seal_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")

    from seal_tpu_torch import bench_generate, bench_search
    from seal_tpu_torch.decoding import generate
    from seal_tpu_torch.kernels import (
        bucket_counts,
        build,
        fm_search,
        rescore,
        row_topk,
        triton_logsoftmax,
        window_gather,
    )
    from seal_tpu_torch.models import bart
    from seal_tpu_torch.scoring import keys as scoring

    counters = {
        "fm_search": fm_search.fm_search,
        "window_gather": window_gather.window_gather,
        "row_topk": row_topk.row_topk,
        "log_softmax_min_len": triton_logsoftmax.log_softmax_ban,
        "fm_sequences": fm_search.fm_sequences,
        "bucket_counts": bucket_counts.bucket_counts,
        "rescore_logprob": rescore.rescore_logprob,
    }
    by_path: dict = {}  # path -> {kernel: launches in that path's run}

    def zero_counts():
        for fn in counters.values():
            fn.launches = 0

    def read_counts(path):
        by_path[path] = {name: fn.launches for name, fn in counters.items()}
        for name in PATH_KERNELS[path]:
            if by_path[path][name] <= 0:
                fail(f"kernel {name} was not launched on the {path} path")
        return by_path[path]

    t0 = time.perf_counter()
    build.lib()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s (nvcc {build.BUILD_SECONDS})")

    # ---- corpus, index, model, queries: the bench operating point -------
    t0 = time.perf_counter()
    host, index, cfg, params, ids, mask, kw = bench_generate.operating_point("cuda")
    log(f"index: {index.n_rows} rows, search_iters {index.search_iters}, "
        f"dir_shift {index.dir_shift}; set-up {time.perf_counter() - t0:.1f} s")
    B, K, V = bench_generate.BATCH, bench_generate.BEAM, bench_generate.VOCAB

    # ---- main path, timed; the launch counts come from this run only -----
    def run(**extra):
        out = generate.fm_index_generate(cfg, params, index, ids, mask, **kw, **extra)
        torch.cuda.synchronize()
        return out

    zero_counts()
    t0 = time.perf_counter()
    hyps = run()
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        hyps = run()
        times.append(time.perf_counter() - t0)
    launches = read_counts("generate")
    fallback = dict(generate.LAST_DECODE_STATS)
    per_batch = statistics.median(times)
    log(f"main path: first call {first_s:.3f} s, then {[round(t, 4) for t in times]} s/batch; "
        f"median {per_batch:.4f} s = {B / per_batch:.1f} queries/s "
        f"(batch {B}, beam {K}, length {kw['max_length']}, BART-large bf16, {index.n_rows - 1} tokens); "
        f"fallback_steps {fallback['fallback_steps']} of {fallback['num_steps']}")
    log(f"launches in the main-path run: {launches}")

    # ---- checks of the main path's output ----------------------------------
    special = (cfg.eos_token_id, cfg.pad_token_id, cfg.bos_token_id)
    n_keys = n_hyps = 0
    for q in hyps:
        n_hyps += len(q)
        for score, toks in q:
            key = [t for t in toks[1:] if t not in special]
            if not np.isfinite(score):
                fail(f"non-finite score {score} for {toks}")
            if key:
                n_keys += 1
                if host.get_count(key) <= 0:
                    fail(f"key not in the corpus: {key}")
    if n_keys == 0:
        fail("no keys emitted")
    log(f"checked {n_keys} keys of {n_hyps} hypotheses: every one occurs in the corpus"
        if not FAILURES else f"checked {n_keys} keys")
    zero_counts()
    full = run(force_full=True)
    log(f"launches in the force_full re-run: {read_counts('generate_force_full')}")
    canon = [sorted((tuple(t), s) for s, t in q) for q in hyps]
    if canon != [sorted((tuple(t), s) for s, t in q) for q in full]:
        fail("force_full hypotheses differ from the fast path's")
    else:
        log("force_full re-run: identical hypotheses")

    # ---- one more batch under torch.profiler: where the device time goes --
    prof = bench_generate.profile_batch(run)
    log(f"profiled batch: {prof['kernels']} kernels, device busy {prof['device_busy_ms']:.2f} ms "
        f"of {prof['wall_ms']:.2f} ms wall ({100 * prof['busy_share']:.1f}%, the profiler slows the host)")
    for row in prof["top"][:12]:
        log(f"  {row['ms']:8.3f} ms {row['calls']:6d} calls  {row['name']}")

    # ---- each kernel against its plain version, at main-path shapes ------
    table = kernel_phases(np, torch, host, index, V, B, K)
    for row in table:
        log(f"kernel {row['name']}: {row['ms']:.4f} ms vs plain {row['plain_ms']:.4f} ms "
            f"at {row['shape']}, max err {row['max_abs_err']}")

    n_small = small_parity(np, torch)
    log(f"small-input parity (card vs CPU plain path): {n_small} keys compared")

    # ---- the bf16 LM head keeps an f32 result ----------------------------
    h = torch.randn(B * K, cfg.d_model, device="cuda").to(torch.bfloat16)
    head = bart.lm_logits(cfg, params, h)
    ref = h.float() @ params["shared"].float().T + params["final_logits_bias"]
    fin = torch.isfinite(ref)
    head_err = float((head[fin] - ref[fin]).abs().max())
    log(f"lm_logits: torch.mm(bf16, bf16, out_dtype=float32) -> {head.dtype}, "
        f"max err vs f32 matmul {head_err:.3e}")
    if head.dtype != torch.float32 or head_err > LM_HEAD_ATOL:
        fail(f"lm_logits bf16 head is off (dtype {head.dtype}, err {head_err})")

    # ---- second path: SEALSearcher.batch_search at the e2e bench point ----
    try:
        from seal_tpu.cpp import native

        native.load()
        native_state = "loaded"
    except (ImportError, OSError, RuntimeError, subprocess.SubprocessError) as e:
        native_state = f"NOT loaded ({type(e).__name__}: {e}); the ranker runs its Python mirror"
    log(f"seal_tpu.cpp.native (the ranker's C++ helpers): {native_state}")
    t0 = time.perf_counter()
    searcher, queries = bench_search.operating_point("cuda")
    log(f"searcher set-up {time.perf_counter() - t0:.1f} s: {searcher.num_docs} docs, "
        f"{searcher.device_index.n_rows - 1} tokens, vocab {searcher.tokenizer.vocab_size}, "
        f"title marker {searcher.title_eos_token_id}; knobs beam {searcher.beam}, length "
        f"{searcher.length}, batch_size {searcher.batch_size}, pipeline {searcher.pipeline}")
    unit = queries[: searcher.batch_size]
    t0 = time.perf_counter()
    searcher.batch_search(unit, k=bench_search.TOP_K)  # warm-up unit
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    searcher.phase_timer.enabled = True
    zero_counts()
    t0 = time.perf_counter()
    results = searcher.batch_search(queries, k=bench_search.TOP_K)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    search_launches = read_counts("batch_search")
    phases = dict(searcher.phase_timer.totals)
    searcher.phase_timer.enabled = False
    nonempty = sum(1 for r in results if r)
    e2e_qps = len(queries) / search_s
    log(f"batch_search: warm-up unit {warm_s:.3f} s; {len(queries)} queries in {search_s:.3f} s "
        f"= {e2e_qps:.2f} queries/s; phases (s, they overlap under the pipeline) "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(phases.items()))
        + f"; {nonempty}/{len(queries)} results non-empty, {sum(len(r) for r in results)} docs; "
        f"fallback_steps of the last decode {generate.LAST_DECODE_STATS['fallback_steps']}")
    log(f"launches in the batch_search run: {search_launches}")
    if nonempty == 0 or any(len(r) > bench_search.TOP_K for r in results):
        fail(f"batch_search results: {nonempty} non-empty")
    for r in results:
        scores = [d.score for d in r]
        if not all(np.isfinite(scores)) or scores != sorted(scores, reverse=True):
            fail("batch_search returned non-finite or unsorted scores")
    marked = searcher._tokenize_batch(searcher._marked([" " + q for q in unit], "body"))
    zero_counts()
    us = scoring.compute_unigram_scores(searcher.model_cfg, searcher.scorer_params, marked,
                                        tolist=False)
    log(f"launches in one unigram call: {read_counts('unigram')}")
    if us.shape != (len(unit), searcher.model_cfg.vocab_size) or not np.isfinite(us.max()):
        fail(f"unigram scores of shape {us.shape}")
    zero_counts()
    n_body, n_title = searcher_grounding(searcher, unit)
    log(f"launches in the grounding unit (body, title, title force_full): "
        f"{read_counts('grounding_unit')}")
    log(f"grounding unit: {n_body} raw body keys and {n_title} raw title keys checked"
        + ("; title force_full re-run identical" if not FAILURES else ""))
    sprof = bench_generate.profile_batch(lambda: searcher.batch_search(unit, k=bench_search.TOP_K))
    log(f"profiled unit ({len(unit)} queries): {sprof['kernels']} kernels, device busy "
        f"{sprof['device_busy_ms']:.2f} ms of {sprof['wall_ms']:.2f} ms wall "
        f"({100 * sprof['busy_share']:.1f}%, the profiler slows the host)")
    for row in sprof["top"][:12]:
        log(f"  {row['ms']:8.3f} ms {row['calls']:6d} calls  {row['name']}")
    stable = search_kernel_phases(np, torch, searcher.fm_index, searcher.device_index,
                                  searcher.model_cfg.vocab_size)
    for row in stable:
        log(f"kernel {row['name']}: {row['ms']:.4f} ms vs plain {row['plain_ms']:.4f} ms "
            f"at {row['shape']}, max err {row['max_abs_err']}")
    table += stable
    n_small_search = small_search_parity(np)
    log(f"small searcher parity (card vs CPU): {n_small_search} documents compared")
    total = {name: sum(p[name] for p in by_path.values()) for name in counters}
    for name, n in total.items():
        if n <= 0:
            fail(f"kernel {name} was launched on no path")

    # the run's readings again, next to the result lines at the end of stdout
    log(f"summary: {card}; {B / per_batch:.1f} queries/s (median {per_batch:.4f} s/batch of "
        f"{len(times)}); fallback_steps {fallback['fallback_steps']}; {n_keys} keys checked; "
        f"busy {100 * prof['busy_share']:.1f}% under the profiler; "
        f"lm_logits err {head_err:.3e}; nvcc {build.BUILD_SECONDS} s; batch_search "
        f"{e2e_qps:.2f} queries/s ({len(queries)} queries, {nonempty} non-empty), phases "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(phases.items()))
        + f"; searcher unit busy {100 * sprof['busy_share']:.1f}% under the profiler")
    log(f"launches by path: {json.dumps(by_path)}")
    kernels = []
    for row in table:
        route, src = SOURCES[row["name"]]
        kernels.append({
            "name": row["name"], "route": route, "source": src,
            "replaces": REPLACES[row["name"]], "launches": total[row["name"]],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed", file=sys.stderr)
        return 1
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
