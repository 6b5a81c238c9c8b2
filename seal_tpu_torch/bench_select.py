"""Kernel 8's selection and kernel 1's rank search on the card, in this
checkout and, with ``--parent DIR``, beside another.

    python -m seal_tpu_torch.bench_select [--parent DIR]

In each checkout, in a process of its own (parent, this, this, parent with
``--parent``; else this checkout once), at the generation point
(``bench_generate.operating_point``: BART-large bf16 over the 1.2M-token
corpus, batch 32, beam 15):

1. Kernel 8's selection (``beam_select``) at [32, 15, 64] with the
   soundness flags, in the ties mode, with ``keep_invalid`` at [32, 15,
   386] (the speculative round) and at beam 32 [32, 32, 98]; kernel 1's
   ``contains`` at [32, 15, 65] (in this checkout at each group size), and
   the same over a symbol block of 1.08M rows at dir_shift 31 (a search
   the head directory does not shorten),
   ``backward_step`` at [32, 15], and the decode step's range update after
   a selection (kernel 1's step mode here; the parent's composition of
   ``range_size``, gathers, ``extend`` and the stop rule).  Eager (20 calls
   back to back, the host's cost included) and graph-replayed (20 calls in
   one CUDA graph, the device time), ms a call, with CUDA events; beside
   them the floor: one eager one-element ``zero_()`` and the same kernel
   graph-replayed.
2. One profiled batch of the generation point after a warm-up batch: the
   batch's device ms, wall ms and kernel launches, and the device ms and
   calls of kernels 1 and 8 (their kernels' names).

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
import json, sys
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
calls = {
    "k8 select [32,15,64]": lambda: k8.beam_select(*a15, K=K, **skw),
    "k8 select ties [32,15,64]": lambda: k8.beam_select(*a15, K=K, ties=True, **skw),
    "k8 select keep_invalid [32,15,386]": lambda: k8.beam_select(
        *spec[:10], K=K, keep_invalid=True, **skw),
    "k8 select beam 32 [32,32,98]": lambda: k8.beam_select(*a32, K=32, **skw),
}
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
one = torch.empty(1, device=dev)
calls["floor: one-element zero_()"] = lambda: one.zero_()
out = {name: {"ms": eager(fn), "graph_ms": graphed(fn)} for name, fn in calls.items()}

run = lambda: generate.fm_index_generate(cfg, params, index, ids, mask, **kw)
run(); torch.cuda.synchronize()
prof = bench_generate.profile_batch(run)
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
KERNEL1 = ("contains_kernel", "backward_step_kernel", "advance_kernel")
KERNEL8 = ("select_", "merge_", "candidates_kernel")
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
    run(); torch.cuda.synchronize()
by = {}
for e in p.events():
    if e.device_type != DeviceType.CUDA:
        continue
    name = e.name.replace("(anonymous namespace)::", "")
    kern = "k1" if any(k in name for k in KERNEL1) else (
        "k8" if any(k in name for k in KERNEL8) and "sample" not in name
        and "diverse" not in name else None)
    if kern:
        key = name.split("(")[0][:80]
        ms, n = by.get(key, (0.0, 0))
        by[key] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
def total(prefix):
    names = KERNEL1 if prefix == "k1" else KERNEL8
    rows = [v for k, v in by.items() if any(x in k for x in names)]
    return sum(ms for ms, _ in rows), sum(n for _, n in rows)
print(json.dumps({"kernels": out, "batch_device_ms": prof["device_busy_ms"],
                  "batch_wall_ms": prof["wall_ms"], "batch_launches": prof["kernels"],
                  "k1_device_ms": total("k1")[0], "k1_calls": total("k1")[1],
                  "k8_device_ms": total("k8")[0], "k8_calls": total("k8")[1],
                  "by_kernel": {k: {"ms": ms, "calls": n} for k, (ms, n) in by.items()}}))
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
    turns = [("this", here)]
    if "--parent" in sys.argv:
        parent = os.path.abspath(sys.argv[sys.argv.index("--parent") + 1])
        turns = [("parent", parent), ("this", here), ("this", here), ("parent", parent)]
    for name, root in turns:
        proc = subprocess.run([sys.executable, "-c", _TURN], cwd=root, capture_output=True,
                              text=True)
        if proc.returncode != 0:
            print(f"{name} ({root}) failed:\n{proc.stderr[-3000:]}", file=sys.stderr)
            return 1
        line = proc.stdout.strip().splitlines()[-1]
        print(json.dumps({"turn": name, **json.loads(line)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
