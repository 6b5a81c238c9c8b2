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

Prints one JSON object with the kernel table on the line before the last,
and ``{"ok": true, "device": {...}}`` as the last line.  Imports no jax.
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
}
SOURCES = {
    "fm_search": ("cuda", "seal_tpu_torch/kernels/csrc/fm_search.cu"),
    "window_gather": ("cuda", "seal_tpu_torch/kernels/csrc/window_gather.cu"),
    "row_topk": ("cuda", "seal_tpu_torch/kernels/csrc/row_topk.cu"),
    "log_softmax_min_len": ("triton", "seal_tpu_torch/kernels/triton_logsoftmax.py"),
}
# kernel 4 sums a 50265-wide row in another order than torch: f32 rounding
# of a log-sum-exp near 11 is ~1e-6; 1e-4 leaves room for the sum order
LOGSOFTMAX_ATOL = 1e-4
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

    from seal_tpu_torch import bench_generate
    from seal_tpu_torch.decoding import generate
    from seal_tpu_torch.kernels import build, fm_search, row_topk, triton_logsoftmax, window_gather
    from seal_tpu_torch.models import bart

    counters = {
        "fm_search": fm_search.fm_search,
        "window_gather": window_gather.window_gather,
        "row_topk": row_topk.row_topk,
        "log_softmax_min_len": triton_logsoftmax.log_softmax_ban,
    }

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

    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    hyps = run()
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        hyps = run()
        times.append(time.perf_counter() - t0)
    launches = {name: fn.launches for name, fn in counters.items()}
    fallback = dict(generate.LAST_DECODE_STATS)
    per_batch = statistics.median(times)
    log(f"main path: first call {first_s:.3f} s, then {[round(t, 4) for t in times]} s/batch; "
        f"median {per_batch:.4f} s = {B / per_batch:.1f} queries/s "
        f"(batch {B}, beam {K}, length {kw['max_length']}, BART-large bf16, {index.n_rows - 1} tokens); "
        f"fallback_steps {fallback['fallback_steps']} of {fallback['num_steps']}")
    log(f"launches in the main-path run: {launches}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")

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
    full = run(force_full=True)
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

    # the run's readings again, next to the result lines at the end of stdout
    log(f"summary: {card}; {B / per_batch:.1f} queries/s (median {per_batch:.4f} s/batch of "
        f"{len(times)}); fallback_steps {fallback['fallback_steps']}; {n_keys} keys checked; "
        f"busy {100 * prof['busy_share']:.1f}% under the profiler; "
        f"lm_logits err {head_err:.3e}; nvcc {build.BUILD_SECONDS} s")
    kernels = []
    for row in table:
        route, src = SOURCES[row["name"]]
        kernels.append({
            "name": row["name"], "route": route, "source": src,
            "replaces": REPLACES[row["name"]], "launches": launches[row["name"]],
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
