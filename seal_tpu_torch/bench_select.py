"""Kernel 8's selection, the rank-search and window kernels (1, 2, 12,
13, 14, 16), the selects (3, 17, 19, 21), the top-k warper and kernel 20
on the card, in this checkout
and, with ``--parent DIR``, beside another.

    python -m seal_tpu_torch.bench_select [--parent DIR] [--turns parent,this,...]
                                          [--only PREFIX,...]

In each checkout, in a process of its own (parent, this, this, parent with
``--parent``; else this checkout once; ``--turns`` names another order),
at the generation point (``bench_generate.operating_point``: BART-large
bf16 over the 1.2M-token corpus, batch 32, beam 15):

1. Kernel 8's selection (``beam_select``) at [32, 15, 64] with the
   soundness flags, in the ties mode, with ``keep_invalid`` at [32, 15,
   386] (the speculative round) and at beam 32 [32, 32, 98]; at [32, 15,
   386] and beam 32 over the 4-shard window [32, 32, 578], in both orders,
   the route ``select_plan`` picks beside the block and large-n routes
   forced; the candidate mode at [32, 15, 64], [32, 15, 290] and [32, 15,
   386]; step 0's epilogue, plain and with free
   generation's token table; kernel 18's gather beside one
   ``torch.index_select``; kernel 1's
   ``contains`` at [32, 15, 65] (in this checkout at each group size), and
   the same over a symbol block of 1.08M rows at dir_shift 31 (a search
   the head directory does not shorten),
   ``backward_step`` at [32, 15], and the decode step's range update after
   a selection (kernel 1's step mode, or the composition of
   ``range_size``, gathers, ``extend`` and the stop rule where a checkout
   has none).  Kernel 2 at [32, 15]: a step's window (w 32) and round 0's
   slab (width 64) -- one call of its window + slab mode where the
   checkout has it, else two calls with ``merge_round``'s bounds, which
   every checkout also times as "two calls" -- the window alone, and a
   straggler round's slab (rows 64 to 320).  On the compact and hybrid
   layouts of the same corpus: kernel 12's ``contains`` [32, 15, 65] and
   ``backward_step``, the range update through the adapter (kernel 12's
   step mode, or the composition over its backward step) beside that
   composition, kernel 13's window, kernel 14's bucket counts and kernel
   16's count vectors at [32, 15]; kernel 13's window + slab (one call of
   the adapter's ``window_slab``: one launch where the checkout has kernel
   13's modes, else two window-mode calls and the bounds) beside those two
   calls and the bounds on both sides, and a straggler round's slab
   (``slab``).  Kernel 5 at [4096, 16] (corpus n-grams, an eighth random
   ids) and at the sharded searcher's count filters' shapes
   (``COUNT_FILTERS``, ``chip_smoke.py``'s kernel 5 log), monolithic on the
   Psi index and over the 4-shard index (``bench_generate.sharded_index``)
   in its count and ranges modes; in a checkout with kernel 5's groups,
   each again at every group width forced.  Kernel 1's shard modes over
   the same 4-shard index (``k1 sharded ...``: each shard's ranges of one-
   and two-token corpus prefixes): ``contains`` and ``validate`` at [32,
   15, 65], [32, 32, 129] (beam 32) and the sharded searcher's unit [16,
   15, 65], the backward step, and the range update through
   ``ShardedIndexOps.advance`` (the shard step mode where the checkout has
   it, else the composition) beside the composition over the backward step
   on both sides, at step 0 and later; in a checkout with the shard plan,
   each width forced.  Eager (20 calls back to back, the
   host's cost included) and graph-replayed (20 calls in one CUDA graph,
   the device time), ms a call, with CUDA events; beside them the floor:
   one eager one-element ``zero_()`` and the same kernel graph-replayed.
   Kernel 16's walk and histogram thresholds on both layouts where the
   checkout has the walk (the parent's rank route where it has not); kernel 3 at its call sites' shapes; kernel 21 in 3
   groups at penalty 0.5 on a [32, 15, 64] candidate list (both orders)
   and on V-wide [32, 15, 50265] rows under a corpus mask (both orders,
   and at penalty 0), and, where the checkout has its routes, its chunked
   route forced on both.  Kernel 19's k-th value at [480, 50265] and
   [120, 50265], k = 50.  The dense step's input at [32, 15]: the count
   mask (kernels 15 and 16's mask modes) where the checkout has it, else
   the counts (their counts modes, also timed on both sides).  Kernel 17
   at [32, 15, 50265] over that input: the dense step (one
   ``dense_select`` launch where the checkout has it, else the scores
   then kernel 3's top 2K), that two-launch composition on both sides, and
   the streaming pass (``dense_scores``); and the dense step, the
   streaming pass and kernel 20's count-reading mode each after its
   input's kernel (counts then consumer against mask then consumer).
   The top-k warper at [480, 50265] and [120, 50265], k = 50 (one
   ``topk_log_softmax`` launch where the checkout has it, else kernel 19
   then kernel 4's threshold mode, which is also timed alone).  Kernel 20
   on V-wide rows under a corpus mask at batch 32 and 8, on candidate
   lists of 64 and 290 slots, and on a sampled ``exact_mask`` step's input
   (the count-reading mode where the checkout has it, else kernel 17's
   streaming pass then the V-wide draw, which both sides also time).
2. With no ``--only`` or with ``--only "k8 paths"``: kernel 8's
   launches by route and mode (``ROUTES``, ``SPEC``, ``LARGE``,
   ``beam_candidates``), one batch's device ms and kernel 8's device ms by
   kernel (``k8_paths``) on the speculative batch over the three layouts,
   beam 15 and beam 32 over the 4-shard index, a sampled and a diverse
   batch.  With no ``--only`` or with one that ``k1 sharded paths``
   starts with: kernel 1's shard-mode launches (``fm_search_sharded`` and,
   where the checkout has them, ``ADVANCE_SHARDED`` and ``STEP_SHARDED``),
   one profiled batch's device ms and launches and kernel 1's shard
   kernels' device ms (``k1_sharded_paths``) on beam 15 and beam 32 over
   the 4-shard index.
   The Psi and the compact layout's batches at the generation point,
   taken before 1, ahead of any CUDA graph capture in the process, and
   again after 1's captures (``*_after_graphs``): five batches' wall ms
   after a warm-up batch, and one profiled batch's device ms, wall ms and
   kernel launches, with the device ms and calls of each index kernel (1,
   2, 12-14) and of kernel 8 (their kernels' names); then one profiled
   batch each of ``generate_dense_compact`` (``exact_mask`` on the compact
   layout), ``generate_diverse`` and ``generate_diverse_dense`` (3 groups
   at penalty 0.5 on the Psi index), ``generate_topk`` (the ``topk=50``
   warper), ``generate_dense`` (``exact_mask`` on the Psi index),
   ``generate_sample`` (sampling through the proven loop) and
   ``generate_sample_dense`` (sampling under ``exact_mask``): device ms,
   launches and the top kernels' device ms and calls.
3. Where the checkout has the fused step (``constrained._step_window``),
   before 1 as well: 15 pairs of batches on each of the two layouts,
   alternated in the process with the step as the parent launched it (two
   kernel 2 or 13 calls and ``merge_round``'s bounds; the wavelet range
   update composed over kernel 12's backward step): each side's median
   and quartile walls and the pairs the fused step won (``alternated``).

``--only PREFIX,...`` times only the calls whose names start with one of
the prefixes and profiles only the Psi and compact batches (before and
after the captures), with no alternated pairs.

Prints the card's name and power limit first, then one JSON line a turn.
Needs one CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

# run in a checkout's root: the timings and the profiled batch as one JSON
# line; only entry points both sides have, or what each side's decode calls
_TURN = """
import json, sys, time
import numpy as np
import torch
sys.path.insert(0, ".")
from seal_tpu_torch import bench_generate
from seal_tpu_torch.decoding import constrained as tc, generate
from seal_tpu_torch.kernels import beam_select as k8, fm_search as k1

torch.backends.cuda.matmul.allow_tf32 = False

def eager(fn, iters=20):
    fn(); torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record(); torch.cuda.synchronize()
    return a.elapsed_time(b) / iters

def graphed(fn, launches=20, replays=10):
    side = torch.cuda.Stream(); side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side); torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    g.replay(); torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        g.replay()
    b.record(); torch.cuda.synchronize()
    return a.elapsed_time(b) / (launches * replays)

host, index, cfg, params, ids, mask, kw = bench_generate.operating_point("cuda")
layouts = {name: bench_generate.build_index(host, name, "cuda") for name in ("compact", "hybrid")}
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
# the index kernels' names (kernels 1 and 12 share theirs: a batch runs one
# layout) and kernel 8's
INDEX = ("contains_kernel", "backward_step_kernel", "advance_kernel", "window_", "wt_window",
         "bucket")
KERNEL8 = ("select_", "merge_", "candidates_")

def profiled(ix, runs=5):  # runs batches' walls after a warm-up, then one profiled
    def run():
        generate.fm_index_generate(cfg, params, ix, ids, mask, **kw)
        torch.cuda.synchronize()
    run()
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        run()
        walls.append((time.perf_counter() - t0) * 1e3)
    prof = bench_generate.profile_batch(run)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        run(); torch.cuda.synchronize()
    by = {}
    for e in p.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.name.replace("(anonymous namespace)::", "")
        if any(k in name for k in INDEX) or (
                any(k in name for k in KERNEL8) and "sample" not in name
                and "diverse" not in name):
            key = name.split("(")[0][:80]
            ms, n = by.get(key, (0.0, 0))
            by[key] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    def total(names):
        rows = [v for k, v in by.items() if any(x in k for x in names)]
        return sum(ms for ms, _ in rows), sum(n for _, n in rows)
    return {"walls_ms": walls, "median_wall_ms": sorted(walls)[runs // 2],
            "batch_device_ms": prof["device_busy_ms"], "batch_wall_ms": prof["wall_ms"],
            "batch_launches": prof["kernels"], "index_device_ms": total(INDEX)[0],
            "index_calls": total(INDEX)[1], "k8_device_ms": total(KERNEL8)[0],
            "k8_calls": total(KERNEL8)[1],
            "by_kernel": {k: {"ms": ms, "calls": n} for k, (ms, n) in by.items()}}

# the batches first, before any CUDA graph is captured in this process
ONLY = tuple(p for p in sys.argv[1].split(",") if p) if len(sys.argv) > 1 else ()
batches = {"psi_batch": profiled(index), "compact_batch": profiled(layouts["compact"])}

# one profiled force_full batch a layout (every step through the proven
# loop, whose straggler rounds read kernel 6's or 14's output), after a
# warm-up: device ms, launches, and the device ms and calls of the bucket
# kernels, kernel 3's select instances and the slab mode
ROUND = ("bucket", "row_topk_kernel", "slab")
for name, ix in () if ONLY and not any(p.startswith("straggler") for p in ONLY) else (
        ("psi", index), *layouts.items()):
    def run(ix=ix):
        generate.fm_index_generate(cfg, params, ix, ids, mask, **kw, force_full=True)
        torch.cuda.synchronize()
    run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        run()
        wall = (time.perf_counter() - t0) * 1e3
    spans, by = [], {}
    for e in p.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        key = e.name.replace("(anonymous namespace)::", "").split("(")[0][:80]
        ms, n = by.get(key, (0.0, 0))
        by[key] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy, last = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, last))
        last = max(last, b)
    batches[f"force_full_{name}_batch"] = {
        "batch_device_ms": busy / 1e3, "batch_wall_ms": wall, "batch_launches": len(spans),
        "round_kernels": {k: {"ms": ms, "calls": n} for k, (ms, n) in by.items()
                          if any(x in k for x in ROUND)}}

# one profiled batch of each path that launches kernels 16 and 21, after a
# warm-up: the dense parity mode on the compact layout, diverse groups (3 of
# 5 at penalty 0.5) on the Psi index with and without it; the top kernels'
# device ms and calls
DIVERSE = dict(diverse_bs_groups=3, diverse_bs_penalty=0.5)
for path, ix, extra in () if ONLY else (
                        ("generate_dense_compact", layouts["compact"], dict(exact_mask=True)),
                        ("generate_diverse", index, DIVERSE),
                        ("generate_diverse_dense", index, dict(DIVERSE, exact_mask=True)),
                        ("generate_topk", index, dict(topk=50)),
                        ("generate_dense", index, dict(exact_mask=True)),
                        ("generate_sample", index, dict(sample=True, seed=0)),
                        ("generate_sample_dense", index, dict(sample=True, seed=0,
                                                              exact_mask=True))):
    def run(ix=ix, extra=extra):
        generate.fm_index_generate(cfg, params, ix, ids, mask, **kw, **extra)
        torch.cuda.synchronize()
    run()
    p = bench_generate.profile_batch(run)
    by = {}
    for r in p["top"]:  # names cut to 80 characters, their rows summed
        key = r["name"].replace("(anonymous namespace)::", "")[:80]
        ms, n = by.get(key, (0.0, 0))
        by[key] = (ms + r["ms"], n + r["calls"])
    batches[path] = {"batch_device_ms": p["device_busy_ms"], "batch_wall_ms": p["wall_ms"],
                     "batch_launches": p["kernels"],
                     "by_kernel": {k: {"ms": ms, "calls": n} for k, (ms, n) in
                                   sorted(by.items(), key=lambda kv: -kv[1][0])[:20]}}

# where the checkout has the fused step, batches alternated in this process
# with the step as the parent launched it (the window, merge_round's bounds
# and the slab as separate calls; the wavelet range update composed over
# kernel 12's backward step): PAIRS pairs a layout, after a warm-up pair
PAIRS = 15
if hasattr(tc, "_step_window") and not ONLY:
    import statistics
    from seal_tpu_torch.ops import _generic, wt_ops

    new_step, new_adv = tc._step_window, wt_ops.advance_ranges

    def old_step(ops, cfg, lp, lo, hi, prev_count, finished):
        win = ops.window_gather(lo, hi, cfg.window, lp, cfg.pad_token_id)
        count_eff = torch.where(finished, 0, prev_count)
        stop_trig = (count_eff <= cfg.stop_at_count) & (cfg.stop_at_count > 0)
        exempt = finished | stop_trig | ops.window_exhaustive(lo, hi, cfg.window)
        if not bool((~exempt).any()):
            return win, exempt, None
        chunk = tc._round0_width(cfg, lp.shape[-1])
        s_lo = torch.minimum(lo + 0, hi)
        return win, exempt, ops.window_gather(s_lo, torch.minimum(s_lo + chunk, hi), chunk,
                                              lp, 0)

    def old_adv(wix, sel_tok, sel_par, lo, hi, finished=None, *, eos, pad):
        return _generic.advance_ranges(lambda t, a, b: wt_ops.backward_step(wix, t, a, b),
                                       lambda a, b: b - a, sel_tok, sel_par, lo, hi, finished,
                                       eos=eos, pad=pad)

    def wall(ix):
        t0 = time.perf_counter()
        generate.fm_index_generate(cfg, params, ix, ids, mask, **kw)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    alternated = {}
    for name, ix in (("psi", index), ("compact", layouts["compact"])):
        res = {"fused": [], "parent_calls": []}
        for i in range(2 * PAIRS + 2):
            side = "fused" if i % 2 == 0 else "parent_calls"
            tc._step_window = new_step if side == "fused" else old_step
            wt_ops.advance_ranges = new_adv if side == "fused" else old_adv
            ms = wall(ix)
            if i >= 2:
                res[side].append(ms)
        tc._step_window, wt_ops.advance_ranges = new_step, new_adv
        alternated[name] = {
            **{f"{k}_median_ms": statistics.median(v) for k, v in res.items()},
            **{f"{k}_quartiles_ms": statistics.quantiles(v, n=4) for k, v in res.items()},
            "fused_wins": sum(a < b for a, b in zip(res["fused"], res["parent_calls"])),
            "pairs": PAIRS}
    batches["alternated"] = alternated
B, K, V = bench_generate.BATCH, bench_generate.BEAM, bench_generate.VOCAB
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(3)
rng = np.random.default_rng(1)
i32 = torch.int32

def rint(lo, hi, shape):
    return torch.randint(lo, hi, shape, generator=g, device=dev, dtype=i32)

def rbool(p, shape):
    return torch.rand(shape, generator=g, device=dev) < p

def select_args(Kb, n_buf, w):
    rows = B * Kb
    lp = torch.round(torch.log_softmax(torch.randn(rows, V, generator=g, device=dev) * 2, -1)
                     * 4) / 4
    take = lambda t: torch.gather(lp, 1, t.reshape(rows, -1).long()).reshape(t.shape)
    btok = rint(0, 400, (B, Kb, n_buf))
    win_valid = rbool(0.7, (B, Kb, w))
    win_tok = torch.where(win_valid, rint(0, 400, (B, Kb, w)), cfg.pad_token_id)
    bs = torch.round(torch.randn(B, Kb, generator=g, device=dev) * 2) / 2 - 3
    return ((btok, take(btok), rbool(0.7, (B, Kb, n_buf))), n_buf, win_tok, win_valid,
            take(win_tok), rbool(0.5, (B, Kb, 2))[..., 1:], lp, rint(0, 50, (B, Kb)),
            rbool(0.1, (B, Kb)), bs, rbool(0.5, (B, Kb)),
            torch.round(torch.randn(B, Kb, generator=g, device=dev)) - 4)

skw = dict(eos=cfg.eos_token_id, pad=cfg.pad_token_id)
a15 = select_args(K, 2 * K, 32)
spec = select_args(K, 256, 128)
a32 = select_args(32, 64, 32)
u32 = select_args(32, 64, 512)  # beam 32 over the 4-shard union window
calls = {
    "k8 select [32,15,64]": lambda: k8.beam_select(*a15, K=K, **skw),
    "k8 select ties [32,15,64]": lambda: k8.beam_select(*a15, K=K, ties=True, **skw),
    "k8 select keep_invalid [32,15,386]": lambda: k8.beam_select(
        *spec[:10], K=K, keep_invalid=True, **skw),
    "k8 select beam 32 [32,32,98]": lambda: k8.beam_select(*a32, K=32, **skw),
}
# kernel 8's routes at the speculative default and beam 32 over 4 shards:
# the route select_plan picks, in both orders, beside the block and large-n
# routes forced (each checkout's own); the candidate mode at the diverse,
# sampling and speculative widths; step 0's epilogue, plain and through
# free generation's token table
for ties in (False, True):
    t = " ties" if ties else ""
    calls[f"k8 select{t} keep_invalid [32,15,386]"] = (
        lambda ties=ties: k8.beam_select(*spec[:10], K=K, ties=ties, keep_invalid=True, **skw))
    calls[f"k8 select block{t} keep_invalid [32,15,386]"] = (
        lambda ties=ties: k8.beam_select(*spec[:10], K=K, ties=ties, keep_invalid=True,
                                         route="block", **skw))
    calls[f"k8 select{t} [32,32,578]"] = (
        lambda ties=ties: k8.beam_select(*u32, K=32, ties=ties, **skw))
    calls[f"k8 select large{t} [32,32,578]"] = (
        lambda ties=ties: k8.beam_select(*u32, K=32, ties=ties, route="large", **skw))
for label, args, kinv in (("[32,15,64]", select_args(K, 2 * K, 32), False),
                          ("[32,15,290]", select_args(K, 256, 32), False),
                          ("[32,15,386] keep_invalid", spec, True)):
    calls[f"k8 candidates {label}"] = (
        lambda args=args, kinv=kinv: k8.beam_candidates(*args[:9], keep_invalid=kinv, **skw))
top_lp0, top_tok0 = torch.topk(spec[6], 256)
bs0 = spec[9]
top_c0, top_i0 = torch.topk((top_lp0.reshape(B, K, 256) + bs0[..., None]).reshape(B, -1), 2 * K)
calls["k8 select_top tokens [32,15*256]"] = lambda: k8.beam_select_top(
    top_c0, top_i0, spec[6], bs0, K, K, cfg.eos_token_id, tokens=top_tok0.int())
v0c, v0i = torch.topk(spec[6][::K].contiguous(), 2 * K)
calls["k8 select_top step 0 [32,50265]"] = lambda: k8.beam_select_top(
    v0c, v0i, spec[6][::K].contiguous(), bs0, 1, K, cfg.eos_token_id)
# kernel 1: ranges like a decode's (one- and two-token prefixes, the full
# range, empty ones)
full_lo, full_hi = index.full_range((B, K))
ct = torch.as_tensor(rng.choice(host.text[:-1] - 1, size=(2, B, K)), device=dev).int()
lo1, hi1 = k1.backward_step_plain(index, ct[0], full_lo, full_hi)
lo2, hi2 = k1.backward_step_plain(index, ct[1], lo1, hi1)
lo = torch.where(torch.arange(K, device=dev) % 2 == 0, lo1, lo2).contiguous()
hi = torch.where(torch.arange(K, device=dev) % 2 == 0, hi1, hi2).contiguous()
cand = rint(0, V, (B, K, 65))
cand[..., :32] = ct[0, :, :, None]
ext = ct[1].contiguous()
groups = getattr(k1, "GROUPS", None)
if groups:
    for G in groups:
        calls[f"k1 contains [32,15,65] group {G}"] = (
            lambda G=G: k1.fm_search(index, "contains", cand, lo, hi, group=G))
calls["k1 contains [32,15,65]"] = lambda: k1.fm_search(index, "contains", cand, lo, hi)
# a search the head directory does not shorten: a symbol of 1.08M rows at
# dir_shift 31 (one position block), sub-ranges of the full range
from seal_tpu_torch.index.device_index import TorchFMIndex
from seal_tpu_torch.index.fm_index import FMIndex
ltoks = np.where(rng.random(1_200_000) < 0.9, 7, rng.integers(4, 30, size=1_200_000))
lhost = FMIndex()
lhost.initialize([d.tolist() + [2] for d in np.array_split(ltoks, 40)])
lix = TorchFMIndex.from_host(lhost, vocab=40, dir_shift=31, device=dev)
llo = torch.as_tensor(rng.integers(0, lhost.size() // 2, size=(B, K)).astype(np.int32), device=dev)
lhi = llo + torch.as_tensor(rng.integers(1, lhost.size() // 2, size=(B, K)).astype(np.int32),
                            device=dev)
lcand = torch.full((B, K, 65), 7, dtype=i32, device=dev)
lcand[..., 40:] = rint(4, 30, (B, K, 25))
for G in groups or ():
    calls[f"k1 contains long block group {G}"] = (
        lambda G=G: k1.fm_search(lix, "contains", lcand, llo, lhi, group=G))
calls["k1 contains long block"] = lambda: k1.fm_search(lix, "contains", lcand, llo, lhi)
calls["k1 backward_step [32,15]"] = lambda: k1.fm_search(index, "backward_step", ext, lo, hi)
ops = tc.SingleIndexOps(index)
sel_par = rint(0, K, (B, K))
finished = rbool(0.1, (B, K))
eos, pad = cfg.eos_token_id, cfg.pad_token_id
if hasattr(ops, "advance"):
    update = lambda: ops.advance(ext, sel_par, lo, hi, finished, eos=eos, pad=pad)
else:  # the parent's composition (decoding/constrained.py's loop)
    def update():
        prev = tc._gather(ops.range_size(lo, hi), sel_par)
        elo, ehi = ops.extend(ext, tc._gather(lo, sel_par), tc._gather(hi, sel_par))
        stop = (ext == eos) | (ext == pad) | tc._gather(finished, sel_par)
        return torch.where(stop, 0, elo), torch.where(stop, 0, ehi), prev
calls["range update [32,15]"] = update
# kernel 2: a step's window and round 0's slab, the window alone, and a
# straggler round's slab (rows_prev 64, width 256: the loop's 4 x 64)
lp = torch.log_softmax(torch.randn(B * K, V, generator=g, device=dev), -1)
w, width = 32, 64

def two_calls():  # the window, then the slab with merge_round's bounds
    ops.window_gather(lo, hi, w, lp, pad)
    s_lo = torch.minimum(lo + 0, hi)
    return ops.window_gather(s_lo, torch.minimum(s_lo + width, hi), width, lp, 0)

def straggler_calls():
    s_lo = torch.minimum(lo + 64, hi)
    return ops.window_gather(s_lo, torch.minimum(s_lo + 256, hi), 256, lp, 0)

fused = hasattr(ops, "window_slab")
calls["k2 window + slab [32,15] w 32 width 64"] = (
    (lambda: ops.window_slab(lo, hi, w, width, lp, pad)) if fused else two_calls)
calls["k2 two calls [32,15] w 32 width 64"] = two_calls
calls["k2 window [32,15] w 32"] = lambda: ops.window_gather(lo, hi, w, lp, pad)
calls["k2 straggler slab [32,15] width 256"] = (
    (lambda: ops.slab(lo, hi, 64, 256, lp)) if fused else straggler_calls)
# the wavelet layouts of the same corpus (the same row ranges): kernels 12,
# 13, 14 and 16, and the range update through the adapter beside the
# composition over kernel 12's backward step
from seal_tpu_torch.kernels import wt_bucket_counts as k14, wt_search as k12, wt_window as k13
from seal_tpu_torch.ops import _generic, wt_ops
for name, wix in layouts.items():
    wops = tc.SingleIndexOps(wix)
    calls[f"k12 contains [32,15,65] {name}"] = (
        lambda wix=wix: k12.wt_search(wix, "contains", cand, lo, hi))
    calls[f"k12 backward_step [32,15] {name}"] = (
        lambda wix=wix: k12.wt_search(wix, "backward_step", ext, lo, hi))
    calls[f"range update [32,15] {name}"] = (
        lambda wops=wops: wops.advance(ext, sel_par, lo, hi, finished, eos=eos, pad=pad))
    calls[f"range update composed [32,15] {name}"] = (
        lambda wix=wix: _generic.advance_ranges(
            lambda t, a, b: wt_ops.backward_step(wix, t, a, b), lambda a, b: b - a, ext,
            sel_par, lo, hi, finished, eos=eos, pad=pad))
    calls[f"k13 window [32,15] w 32 {name}"] = (
        lambda wix=wix: k13.wt_window_gather(wix, lo, hi, w, lp, pad))
    # a step's window and round 0's slab through the adapter (one launch of
    # kernel 13 where the checkout has its modes), the parent's two calls
    # and bounds, and a straggler round's slab
    calls[f"k13 window + slab [32,15] w 32 width 64 {name}"] = (
        lambda wops=wops: wops.window_slab(lo, hi, w, width, lp, pad))
    calls[f"k13 two calls + bounds [32,15] w 32 width 64 {name}"] = (
        lambda wix=wix: (k13.wt_window_gather(wix, lo, hi, w, lp, pad),
                         k13.wt_window_gather(wix, torch.minimum(lo + 0, hi),
                                              torch.minimum(torch.minimum(lo + 0, hi) + width,
                                                            hi), width, lp, 0)))
    calls[f"k13 straggler slab [32,15] width 256 {name}"] = (
        lambda wops=wops: wops.slab(lo, hi, 64, 256, lp))
    calls[f"k14 bucket counts [32,15] {name}"] = (
        lambda wix=wix: k14.wt_bucket_counts(wix, lo, hi))
    calls[f"k16 dense counts [32,15] {name}"] = lambda wix=wix: k12.wt_dense_counts(wix, lo, hi)
# kernel 16's routes where the checkout has the walk: every non-empty range
# walked, and the histogram's thresholds; the parent's rank route
for name, wix in layouts.items():
    if hasattr(k12, "WALK_CAP"):
        calls[f"k16 walk [32,15] {name}"] = (
            lambda wix=wix: k12.wt_dense_counts(wix, lo, hi, hist_max=0))
        for h in (1 << 6, 1 << 8, 1 << 10, 1 << 12, 1 << 14):  # the histogram's threshold
            calls[f"k16 hist_max {h} [32,15] {name}"] = (
                lambda wix=wix, h=h: k12.wt_dense_counts(wix, lo, hi, hist_max=h))
    else:
        calls[f"k16 rank route [32,15] {name}"] = (
            lambda wix=wix: k12.wt_dense_counts(wix, lo, hi, hist_max=0))
# kernel 3 at its call sites' shapes (its select is shared with kernel 21's
# wide route where the checkout has it): [480, 50265] at k = 64 and 256,
# step 0's [32, 50265] at k = 30, the dense [32, 753975] at k = 30
from seal_tpu_torch.kernels import row_topk as k3
dense_rows = torch.where(rbool(0.02, (B, K * V)), lp[:B].repeat(1, K), -3.4e38)
for label, x3, k in (("[480,50265] k=64", lp, 64), ("[480,50265] k=256", lp, 256),
                     ("[32,50265] k=30", lp[:B].contiguous(), 30),
                     ("[32,753975] k=30", dense_rows, 30)):
    calls[f"k3 {label}"] = lambda x3=x3, k=k: k3.row_topk(x3, k)
# kernel 21: 3 groups at penalty 0.5 on a [32, 15, 64] candidate list (the
# list route) and on step 0's V-wide rows under a corpus mask (the wide
# route), in both orders and at penalty 0; where the checkout has the
# routes, the chunked route (every call's route before them) forced
from seal_tpu_torch.kernels import diverse_select as k21
cons64 = torch.where(rbool(0.7, (B, K, 64)),
                     torch.round(torch.randn(B, K, 64, generator=g, device=dev) * 4) / 4 - 3,
                     tc.NEG_INF)
tok64 = rint(0, 40, (B, K, 64))
tok64[..., -2] = eos
bs21 = torch.round(torch.randn(B, K, generator=g, device=dev) * 2) / 2 - 3
wide21 = lp.reshape(B, K, V)
corpus = rbool(0.8, (V,))
kw21 = dict(groups=3, penalty=0.5, eos=eos, vocab=V)
calls["k21 list [32,15,64]"] = lambda: k21.diverse_select(cons64, tok64, bs21, **kw21)
calls["k21 list ties [32,15,64]"] = (
    lambda: k21.diverse_select(cons64, tok64, bs21, ties=True, **kw21))
calls["k21 wide [32,15,50265]"] = (
    lambda: k21.diverse_select(wide21, None, bs21, mask=corpus, **kw21))
calls["k21 wide ties [32,15,50265]"] = (
    lambda: k21.diverse_select(wide21, None, bs21, mask=corpus, ties=True, **kw21))
calls["k21 wide penalty 0 [32,15,50265]"] = (
    lambda: k21.diverse_select(wide21, None, bs21, mask=corpus, **{**kw21, "penalty": 0.0}))
if hasattr(k21, "ROUTES"):
    calls["k21 chunked list [32,15,64]"] = (
        lambda: k21.diverse_select(cons64, tok64, bs21, force="chunked", **kw21))
    calls["k21 chunked wide [32,15,50265]"] = (
        lambda: k21.diverse_select(wide21, None, bs21, mask=corpus, force="chunked", **kw21))
# kernel 19: the warper's k-th value, at batch 32 and batch 8
from seal_tpu_torch.kernels import row_select as k19
lp120 = lp[:120].contiguous()
calls["k19 row_kth [480,50265] k=50"] = lambda: k19.row_kth(lp, 50)
calls["k19 row_kth [120,50265] k=50"] = lambda: k19.row_kth(lp120, 50)
# the dense step's input over the ranges above: the count mask (kernels 15
# and 16's mask modes) where the checkout has it, else the counts; the
# counts modes on both sides
from seal_tpu_torch.kernels import dense_scores as k17
has_mask = hasattr(k1, "fm_dense_mask")
dcounts = ops.dense_mask(lo, hi, 2048) if has_mask else ops.dense_counts(lo, hi, 2048)
dense_in = {"psi": ((lambda: k1.fm_dense_mask(index, lo, hi)) if has_mask
                    else (lambda: k1.fm_dense_counts(index, lo, hi)))}
for name, wix in layouts.items():
    dense_in[name] = ((lambda wix=wix: k12.wt_dense_mask(wix, lo, hi)) if has_mask
                      else (lambda wix=wix: k12.wt_dense_counts(wix, lo, hi)))
for name, fn in dense_in.items():
    calls[f"dense step input (mask, else counts) [32,15] {name}"] = fn
calls["k15 counts [32,15] psi"] = lambda: k1.fm_dense_counts(index, lo, hi)
# kernel 17 over that input: the dense step (kernel 17 inside kernel 3's
# select where the checkout has it), the two launches (kernel 17's scores,
# kernel 3's top 2K), the streaming pass, and each after its input's
# kernel (15 on the Psi index, 16 on the compact layout)
prev17 = (hi - lo).to(i32)
bs17 = torch.round(torch.randn(B, K, generator=g, device=dev) * 2) / 2 - 3
args17 = (dcounts, lp, prev17, finished, bs17)
kw17 = dict(eos=eos, pad=pad)
composed17 = lambda: k3.row_topk(k17.dense_scores(*args17, **kw17), 2 * K)
calls["k17 dense step [32,15,50265]"] = (
    (lambda: k17.dense_select(*args17, 2 * K, **kw17)) if hasattr(k17, "dense_select")
    else composed17)
calls["k17 scores + k3 top-2K [32,15,50265]"] = composed17
calls["k17 streaming pass [32,15,50265]"] = lambda: k17.dense_scores(*args17, **kw17)
for name in ("psi", "compact"):
    calls[f"input + k17 dense step [32,15,50265] {name}"] = (
        lambda f=dense_in[name]: k17.dense_select(f(), *args17[1:], 2 * K, **kw17)
        if hasattr(k17, "dense_select") else k3.row_topk(
            k17.dense_scores(f(), *args17[1:], **kw17), 2 * K))
calls["input + k17 streaming pass [32,15,50265] psi"] = (
    lambda: k17.dense_scores(dense_in["psi"](), *args17[1:], **kw17))
# the top-k warper at k = 50: one launch where the checkout has the fused
# warper, else kernel 19's k-th value then kernel 4's threshold mode (and
# that mode alone)
from seal_tpu_torch.kernels import triton_logsoftmax as k4
for label, xw in (("[480,50265]", lp), ("[120,50265]", lp120)):
    calls[f"warper {label} k=50"] = (
        (lambda xw=xw: k19.topk_log_softmax(xw, 50, eos, tc.NEG_INF))
        if hasattr(k19, "topk_log_softmax")
        else (lambda xw=xw: k4.log_softmax_ban(xw, eos, tc.NEG_INF, k19.row_kth(xw, 50))))
if hasattr(k4, "THRESHOLD"):
    kth480 = k19.row_kth(lp, 50)
    calls["k4 threshold [480,50265]"] = lambda: k4.log_softmax_ban(lp, eos, tc.NEG_INF, kth480)
# kernel 20: step 0's V-wide rows under the corpus mask (batch 32 and 8),
# the proven loop's candidate lists (n_buf + w + 2 slots: 2K and 256
# buffers), and a sampled exact_mask step over the count vectors above (the
# count-reading mode where the checkout has it, else the streaming pass at
# zero beam scores and the V-wide draw)
from seal_tpu_torch.kernels import sample_select as k20
zero20 = torch.zeros(B, K, device=dev)
lp20 = lp.reshape(B, K, V)
calls["k20 V-wide [32,15,50265]"] = (
    lambda: k20.sample_select(lp20, lp20, None, zero20, 5, 0, eos=eos, pad=pad, mask=corpus))
calls["k20 V-wide [8,15,50265]"] = (
    lambda: k20.sample_select(lp20[:8], lp20[:8], None, zero20[:8], 5, 0, eos=eos, pad=pad,
                              mask=corpus))
for n20 in (2 * K + 32 + 2, 256 + 32 + 2):
    tok20 = rint(3, V, (B, K, n20))
    tok20[..., -2] = eos
    lpl = torch.gather(lp, 1, tok20.reshape(B * K, n20).long()).reshape(B, K, n20)
    consl = torch.where(rbool(0.7, (B, K, n20)), lpl, tc.NEG_INF)
    calls[f"k20 list [32,15,{n20}]"] = (
        lambda consl=consl, lpl=lpl, tok20=tok20: k20.sample_select(
            consl, lpl, tok20, bs17, 5, 3, eos=eos, pad=pad))
if hasattr(k20, "sample_select_counts"):
    calls["k20 count-reading [32,15,50265]"] = (
        lambda: k20.sample_select_counts(dcounts, lp, prev17, finished, bs17, 5, 4, **kw17))
    calls["input + k20 count-reading [32,15,50265] psi"] = (
        lambda: k20.sample_select_counts(dense_in["psi"](), lp, prev17, finished, bs17, 5, 4,
                                         **kw17))
else:
    calls["k20 count-reading [32,15,50265]"] = (
        lambda: k20.sample_select(k17.dense_scores(dcounts, lp, prev17, finished, zero20, **kw17)
                                  .reshape(B, K, V), lp, None, bs17, 5, 4, eos=eos, pad=pad))
calls["k17 streaming pass + k20 V-wide [32,15,50265]"] = (
    lambda: k20.sample_select(k17.dense_scores(dcounts, lp, prev17, finished, zero20, **kw17)
                              .reshape(B, K, V), lp, None, bs17, 5, 4, eos=eos, pad=pad))
# kernel 5: 4096 corpus n-grams of up to 16 tokens (an eighth random ids)
# and the sharded searcher's count filter's shape, on the Psi index and over
# the 4-shard index (count and ranges modes)
si5, hosts5 = bench_generate.sharded_index("cuda")
text5 = host.text[:-1] - 1
# (n, L) of the sharded searcher's count filters (chip_smoke.py's kernel 5
# log of a 32-query batch_search on an H100: 31 of its 98 calls at [60, 3],
# the most common; ~60 at [168-185, 9])
COUNT_FILTERS = ((60, 3), (184, 9))
for label, (n5, L5) in (("[4096,16]", (4096, 16)),
                        *((f"count filter [{a},{b}]", (a, b)) for a, b in COUNT_FILTERS)):
    starts = rng.integers(0, text5.size - L5, size=n5)
    seq5 = np.stack([text5[s5 : s5 + L5][::-1] for s5 in starts]).astype(np.int32)
    seq5[: n5 // 8] = rng.integers(-1, V + 2, size=(n5 // 8, L5))
    seq5 = torch.as_tensor(seq5, device=dev)
    len5 = torch.as_tensor(rng.integers(1, L5 + 1, size=n5).astype(np.int32), device=dev)
    calls[f"k5 sequences {label} psi"] = (
        lambda seq5=seq5, len5=len5: k1.fm_sequences(index, seq5, len5))
    calls[f"k5 sharded count {label} x4"] = (
        lambda seq5=seq5, len5=len5: k1.fm_sequences_sharded(si5, seq5, len5, count=True))
    calls[f"k5 sharded ranges {label} x4"] = (
        lambda seq5=seq5, len5=len5: k1.fm_sequences_sharded(si5, seq5, len5))
    for G in getattr(k1, "GROUPS", ()) if hasattr(k1, "sequences_plan") else ():
        calls[f"k5 sequences {label} psi group {G}"] = (
            lambda seq5=seq5, len5=len5, G=G: k1.fm_sequences(index, seq5, len5, group=G))
        calls[f"k5 sharded count {label} x4 group {G}"] = (
            lambda seq5=seq5, len5=len5, G=G: k1.fm_sequences_sharded(si5, seq5, len5, True,
                                                                      group=G))
        calls[f"k5 sharded ranges {label} x4 group {G}"] = (
            lambda seq5=seq5, len5=len5, G=G: k1.fm_sequences_sharded(si5, seq5, len5, group=G))
# kernel 1's shard modes over the same 4-shard index: each shard's ranges of
# one- and two-token corpus prefixes (its own rows), half of each row's
# candidates the first token (the rest random ids); beam 15 [32, 15] with 65
# candidates (round 0's 64 and EOS), beam 32 [32, 32] with 129, and the
# sharded searcher's unit (16 queries, beam 15).  contains, validate (the
# counts mode), backward_step, and the range update: the checkout's
# ShardedIndexOps.advance (one launch of the shard step mode where the
# checkout has it, else the composition) beside that composition over the
# backward step on both sides, at step 0 (one parent a query) and later;
# where the checkout has the shard plan, each group width forced
from seal_tpu_torch.parallel import sharded_decode as tsd
sops1 = tsd.ShardedIndexOps(si5)
rng1 = np.random.default_rng(21)
g1 = torch.Generator(device=dev).manual_seed(21)
forced = getattr(k1, "GROUPS", ()) if hasattr(k1, "shard_plan") else ()
for label, Bq, Kb, M in (("[32,15]", B, K, 65), ("[32,32]", B, 32, 129),
                         ("searcher [16,15]", 16, K, 65)):
    ctk = torch.as_tensor(rng1.choice(text5, size=(2, Bq, Kb)).astype(np.int32), device=dev)
    los1, his1 = [], []
    for s in range(si5.n_shards):
        v = si5.block_view(s)
        l1, h1 = k1.backward_step_plain(v, ctk[0], torch.zeros((Bq, Kb), dtype=i32, device=dev),
                                        torch.full((Bq, Kb), int(si5.n_rows[s]), dtype=i32,
                                                   device=dev))
        l2, h2 = k1.backward_step_plain(v, ctk[1], l1, h1)
        even = torch.arange(Kb, device=dev) % 2 == 0
        los1.append(torch.where(even, l1, l2))
        his1.append(torch.where(even, h1, h2))
    slo, shi = torch.stack(los1).contiguous(), torch.stack(his1).contiguous()
    scand = torch.randint(0, V, (Bq, Kb, M), generator=g1, device=dev, dtype=i32)
    scand[..., : M // 2] = ctk[0, :, :, None]
    sext = ctk[1].contiguous()
    spar = torch.randint(0, Kb, (Bq, Kb), generator=g1, device=dev, dtype=i32)
    sfin = torch.rand((Bq, Kb), generator=g1, device=dev) < 0.1
    spar0 = torch.zeros_like(spar)
    slo0, shi0 = slo[..., :1].contiguous(), shi[..., :1].contiguous()
    shape = f"{label[:-1]},{M}] x4"
    calls[f"k1 sharded contains {shape}"] = (
        lambda c=scand, a=slo, b=shi: k1.fm_search_sharded(si5, "contains", c, a, b))
    calls[f"k1 sharded validate {shape}"] = (
        lambda c=scand, a=slo, b=shi: k1.fm_search_sharded(si5, "validate", c, a, b))
    calls[f"k1 sharded backward_step {label} x4"] = (
        lambda e=sext, a=slo, b=shi: k1.fm_search_sharded(si5, "backward_step", e, a, b))
    calls[f"k1 sharded advance {label} x4"] = (
        lambda e=sext, p=spar, a=slo, b=shi, f=sfin: sops1.advance(e, p, a, b, f, eos=eos,
                                                                    pad=pad))
    calls[f"k1 sharded advance composed {label} x4"] = (
        lambda e=sext, p=spar, a=slo, b=shi, f=sfin: _generic.advance_ranges(
            lambda t, x, y: k1.fm_search_sharded(si5, "backward_step", t, x, y),
            lambda x, y: (y - x).sum(0, dtype=i32), e, p, a, b, f, eos=eos, pad=pad))
    calls[f"k1 sharded advance step 0 {label} x4"] = (
        lambda e=sext, p=spar0, a=slo0, b=shi0: sops1.advance(e, p, a, b, eos=eos, pad=pad))
    for G in getattr(k1, "CONTAINS_GROUPS", forced) if forced else ():
        calls[f"k1 sharded contains {shape} group {G}"] = (
            lambda c=scand, a=slo, b=shi, G=G: k1.fm_search_sharded(si5, "contains", c, a, b,
                                                                    group=G))
    for G in forced:
        calls[f"k1 sharded validate {shape} group {G}"] = (
            lambda c=scand, a=slo, b=shi, G=G: k1.fm_search_sharded(si5, "validate", c, a, b,
                                                                    group=G))
        calls[f"k1 sharded backward_step {label} x4 group {G}"] = (
            lambda e=sext, a=slo, b=shi, G=G: k1.fm_search_sharded(si5, "backward_step", e, a,
                                                                   b, group=G))
        calls[f"k1 sharded advance {label} x4 group {G}"] = (
            lambda e=sext, p=spar, a=slo, b=shi, f=sfin, G=G: k1.fm_advance_sharded(
                si5, e, p, a, b, f, eos=eos, pad=pad, group=G))
# kernels 6 and 14 at the decode's [32, 15] ranges: the counts modes, and
# the support bits where the checkout has them; kernel 18's gather of the
# ranges' first 64 rows each; the straggler round at chunk_l 256 over
# [480, 50265] from round 0's (lp, token) threshold: the parent's
# composition (bucket counts, the pruned copy, the consumed mask, kernel 3)
# on both sides, and the checkout's own round (the support bits, then one
# launch of kernel 3's select through the pruning loader) where it has it
from seal_tpu_torch.index.fm_index import SHIFT
from seal_tpu_torch.kernels import bucket_counts as k6, locate as k18
calls["k6 bucket counts [32,15] psi"] = lambda: k6.bucket_counts(index, lo, hi)
if hasattr(k6, "bucket_support"):
    calls["k6 support [32,15] psi"] = lambda: k6.bucket_support(index, lo, hi)
for name, wix in layouts.items():
    if hasattr(k14, "wt_bucket_support"):
        calls[f"k14 support [32,15] {name}"] = (
            lambda wix=wix: k14.wt_bucket_support(wix, lo, hi))
sa_ix = TorchFMIndex.from_host(host, vocab=V, device=dev, keep_sa=True)
gather_rows = torch.cat([torch.arange(a, min(b, a + 64), dtype=i32, device=dev) for a, b in
                         zip(lo.flatten().tolist(), hi.flatten().tolist())])
calls[f"k18 gather {gather_rows.numel()} rows"] = lambda: k18.locate_rows(sa_ix.sa, gather_rows)
# its library yardstick: one index_select of the same (in-range) rows
calls[f"k18 library index_select {gather_rows.numel()} rows"] = (
    lambda: torch.index_select(sa_ix.sa, 0, gather_rows))
th_vals, th_idx = k3.row_topk(lp, 64)
th_lp, th_ix = th_vals[:, -1:].contiguous(), th_idx[:, -1:].int().contiguous()
v_idx = torch.arange(V, dtype=i32, device=dev)
for name, wix in (("psi", index), *layouts.items()):
    rops = tc.SingleIndexOps(wix)
    v_bucket = ((v_idx + SHIFT) // rops.bucket_size()).long()

    def parent_round(rops=rops, v_bucket=v_bucket):
        bc = rops.bucket_counts(lo, hi).reshape(B * K, -1)
        base = torch.where(bc[:, v_bucket] > 0, lp, tc.NEG_INF)
        consumed = (base > th_lp) | ((base == th_lp) & (v_idx <= th_ix))
        return k3.row_topk(torch.where(consumed, tc.NEG_INF, base), 256)

    calls[f"straggler parent round [480,50265] k=256 {name}"] = parent_round
    if hasattr(rops, "bucket_support"):
        def round_(rops=rops):
            bits = rops.bucket_support(lo, hi).reshape(B * K, -1)
            return k3.pruned_topk(lp, bits, th_lp[:, 0], th_ix[:, 0], rops.bucket_size(), 256,
                                  tc.NEG_INF)

        calls[f"straggler round [480,50265] k=256 {name}"] = round_
# the round's select alone: the parent's consumed mask over a pruned copy
# and kernel 3 (and kernel 3 alone over the parent's finished rows),
# against the loader's select (the support computed once)
if hasattr(tc.SingleIndexOps, "bucket_support"):
    sops = tc.SingleIndexOps(index)
    bits6 = sops.bucket_support(lo, hi).reshape(B * K, -1)
    calls["straggler select [480,50265] k=256 psi"] = lambda: k3.pruned_topk(
        lp, bits6, th_lp[:, 0], th_ix[:, 0], sops.bucket_size(), 256, tc.NEG_INF)
    calls["straggler select [480,50265] k=20000 psi"] = lambda: k3.pruned_topk(
        lp, bits6, th_lp[:, 0], th_ix[:, 0], sops.bucket_size(), 20000, tc.NEG_INF)
base6 = torch.where(k6.bucket_counts(index, lo, hi).reshape(B * K, -1)[
    :, ((v_idx + SHIFT) // index.bucket_size).long()] > 0, lp, tc.NEG_INF)

def parent_select(k):
    consumed = (base6 > th_lp) | ((base6 == th_lp) & (v_idx <= th_ix))
    return k3.row_topk(torch.where(consumed, tc.NEG_INF, base6), k)

work6 = torch.where((base6 > th_lp) | ((base6 == th_lp) & (v_idx <= th_ix)), tc.NEG_INF, base6)
calls["straggler parent work k3 [480,50265] k=256 psi"] = lambda: k3.row_topk(work6, 256)
calls["straggler parent select [480,50265] k=256 psi"] = lambda: parent_select(256)
calls["straggler parent select [480,50265] k=20000 psi"] = lambda: parent_select(20000)
# kernel 8's launches a batch, by route and mode, and its device ms, on
# the paths that reach the routes above: speculative on the three layouts,
# beam 15 and beam 32 over the 4-shard index, a sampled and a diverse batch
if not ONLY or any(p.startswith("k8 paths") for p in ONLY):
    from seal_tpu_torch.parallel.sharded_decode import sharded_fm_index_generate
    si4, _ = bench_generate.sharded_index("cuda")
    counters = {**{f"route {r}": c for r, c in getattr(k8, "ROUTES", {}).items()},
                "beam_select": k8.beam_select, "spec": k8.SPEC, "large": k8.LARGE,
                "beam_candidates": k8.beam_candidates, "beam_merge": k8.beam_merge}
    runs = {
        "spec psi": lambda: generate.fm_index_generate(cfg, params, index, ids, mask, **kw,
                                                       speculative=True),
        "spec compact": lambda: generate.fm_index_generate(cfg, params, layouts["compact"], ids,
                                                           mask, **kw, speculative=True),
        "spec hybrid": lambda: generate.fm_index_generate(cfg, params, layouts["hybrid"], ids,
                                                          mask, **kw, speculative=True),
        "sharded beam 15": lambda: sharded_fm_index_generate(cfg, params, si4, None, ids, mask,
                                                             **kw),
        "sharded beam 32": lambda: sharded_fm_index_generate(
            cfg, params, si4, None, ids, mask, **{**kw, "num_beams": 32, "window": 0}),
        "sample": lambda: generate.fm_index_generate(cfg, params, index, ids, mask, **kw,
                                                     sample=True, seed=0),
        "diverse": lambda: generate.fm_index_generate(cfg, params, index, ids, mask, **kw,
                                                      **DIVERSE),
    }
    k8_paths = {}
    for name, fn in runs.items():
        fn(); torch.cuda.synchronize()  # warm-up
        for c in counters.values():
            c.launches = 0
        fn(); torch.cuda.synchronize()
        got = {k: c.launches for k, c in counters.items()}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            fn(); torch.cuda.synchronize()
        spans, k8ms = [], {}
        for e in p.events():
            if e.device_type != DeviceType.CUDA:
                continue
            spans.append((e.time_range.start, e.time_range.end))
            key = e.name.replace("(anonymous namespace)::", "").split("(")[0][:60]
            if any(x in key for x in KERNEL8) and not any(
                    x in key for x in ("sample", "diverse", "dense", "row_")):
                ms, n = k8ms.get(key, (0.0, 0))
                k8ms[key] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
        busy, last = 0.0, float("-inf")
        for a, b in sorted(spans):
            busy += max(0.0, b - max(a, last))
            last = max(last, b)
        k8_paths[name] = {"launches": got, "batch_device_ms": busy / 1e3,
                          "batch_launches": len(spans),
                          "k8_device_ms": sum(ms for ms, _ in k8ms.values()),
                          "k8_by_kernel": k8ms}
    batches["k8_paths"] = k8_paths
# kernel 1's shard modes on the sharded paths: beam 15 and beam 32 over the
# 4-shard index, after a warm-up batch: the launches of each shard-mode
# wrapper and counter, one profiled batch's device ms and launches, and the
# device ms and calls of kernel 1's shard kernels by name
if not ONLY or any("k1 sharded paths".startswith(p) for p in ONLY):
    from seal_tpu_torch.parallel.sharded_decode import sharded_fm_index_generate
    SHARD1 = ("backward_step_sharded", "contains_sharded", "step_sharded", "advance_sharded")
    counters1 = {"fm_search_sharded": k1.fm_search_sharded,
                 **{n: getattr(k1, n) for n in ("ADVANCE_SHARDED", "STEP_SHARDED")
                    if hasattr(k1, n)}}
    k1_paths = {}
    for name, extra in (("sharded beam 15", {}),
                        ("sharded beam 32", {"num_beams": 32, "window": 0})):
        def fn(extra=extra):
            sharded_fm_index_generate(cfg, params, si5, None, ids, mask, **{**kw, **extra})
            torch.cuda.synchronize()
        fn()  # warm-up
        for c in counters1.values():
            c.launches = 0
        fn()
        got = {k: c.launches for k, c in counters1.items()}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            fn()
        spans, k1ms = [], {}
        for e in p.events():
            if e.device_type != DeviceType.CUDA:
                continue
            spans.append((e.time_range.start, e.time_range.end))
            key = e.name.replace("(anonymous namespace)::", "").split("(")[0][:60]
            if any(x in key for x in SHARD1):
                ms, n = k1ms.get(key, (0.0, 0))
                k1ms[key] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
        busy, last = 0.0, float("-inf")
        for a, b in sorted(spans):
            busy += max(0.0, b - max(a, last))
            last = max(last, b)
        k1_paths[name] = {"launches": got, "batch_device_ms": busy / 1e3,
                          "batch_launches": len(spans),
                          "k1_device_ms": sum(ms for ms, _ in k1ms.values()),
                          "k1_by_kernel": k1ms}
    batches["k1_sharded_paths"] = k1_paths
one = torch.empty(1, device=dev)
calls["floor: one-element zero_()"] = lambda: one.zero_()
if ONLY:
    calls = {k: v for k, v in calls.items() if k.startswith(ONLY) or k.startswith("floor")}
out = {name: {"ms": eager(fn), "graph_ms": graphed(fn)} for name, fn in calls.items()}
# the same batches again after the captures above
batches["psi_batch_after_graphs"] = profiled(index)
batches["compact_batch_after_graphs"] = profiled(layouts["compact"])

if hasattr(k21, "proof_failures"):
    batches["k21_proof_failures"] = k21.proof_failures(dev)
print(json.dumps({"kernels": out, **batches}))
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench_select: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip() or "unknown card", flush=True)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    roots = {"this": here}
    order = ["this"]
    if "--parent" in sys.argv:
        roots["parent"] = os.path.abspath(sys.argv[sys.argv.index("--parent") + 1])
        order = ["parent", "this", "this", "parent"]
    if "--turns" in sys.argv:
        order = sys.argv[sys.argv.index("--turns") + 1].split(",")
    only = sys.argv[sys.argv.index("--only") + 1] if "--only" in sys.argv else ""
    for name in order:
        root = roots[name]
        proc = subprocess.run([sys.executable, "-c", _TURN, only], cwd=root, capture_output=True,
                              text=True)
        if proc.returncode != 0:
            print(f"{name} ({root}) failed:\n{proc.stderr[-3000:]}", file=sys.stderr)
            return 1
        line = proc.stdout.strip().splitlines()[-1]
        print(json.dumps({"turn": name, **json.loads(line)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
