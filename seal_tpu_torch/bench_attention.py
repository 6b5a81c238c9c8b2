"""Kernels 9 and 10 (decode attention, ``kernels/csrc/decode_attention.cu``)
on the card, in this checkout and, with ``--parent DIR``, beside another.

    python -m seal_tpu_torch.bench_attention [--parent DIR]

In each checkout, in a process of its own (parent, this, this, parent with
``--parent``; else this checkout once):

1. Kernel 9 at the generation point (q [480, 16, 64] bf16 against K/V
   [32, 14, 16, 64], a padded query in three), at step 0 (one beam a
   query), at 1024 encoder positions, and in f32 as T5-base calls it (q
   [480, 12, 64] un-scaled against [32, 16, 12, 64]); kernel 10 at step 8
   of a 10-slot bf16 cache and its relative-bias mode in f32 at step 9
   (T5-base's 12 heads); ``scaled_dot_product_attention`` on the same
   inputs.  Eager (20 calls back to back, the host's launch cost
   included) and graph-replayed (20 calls in one CUDA graph, the device
   time), ms a call, with CUDA events.
2. One profiled batch of the generation point (``bench_generate.
   operating_point``: BART-large bf16, batch 32, beam 15, length 10, after
   one warm-up batch): the batch's device ms, and the device ms and calls
   of every kernel whose name holds ``attention_kernel`` (kernels 9 and 10
   and nothing else).

Prints the card's name and power limit first, then one JSON line a turn.
Needs one CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

# run in a checkout's root: the kernel timings and the profiled batch, as one
# JSON line; only the wrappers' public entry points, which both sides have
_TURN = """
import json, sys
import torch
import torch.nn.functional as F
sys.path.insert(0, ".")
from seal_tpu_torch import bench_generate
from seal_tpu_torch.kernels import decode_attention as k910
from seal_tpu_torch.models import t5

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

dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(3)
bf, f32 = torch.bfloat16, torch.float32
B, K, H, Dh = 32, 15, 16, 64
def rnd(*shape, scale=1.0, dt=bf):
    return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dt)
q = rnd(B * K, H, Dh, scale=0.125)
kx, vx = rnd(B, 14, H, Dh), rnd(B, 14, H, Dh)
bias = torch.zeros(B, 14, device=dev); bias[::3, -3:] = -1e9
kl, vl = rnd(B, 1024, H, Dh), rnd(B, 1024, H, Dh)
bias_l = torch.zeros(B, 1024, device=dev); bias_l[::3, -300:] = -1e9
kc, vc = rnd(B * K, 10, H, Dh), rnd(B * K, 10, H, Dh)
Ht = 12
qt = rnd(B * K, Ht, Dh, scale=1.4, dt=f32)
kt, vt = rnd(B, 16, Ht, Dh, scale=1.4, dt=f32), rnd(B, 16, Ht, Dh, dt=f32)
bias_t = torch.zeros(B, 16, device=dev); bias_t[::3, -3:] = -1e9
kct, vct = rnd(B * K, 10, Ht, Dh, scale=1.4, dt=f32), rnd(B * K, 10, Ht, Dh, dt=f32)
table = torch.randn(32, Ht, generator=gen, device=dev)
buckets = t5.bucket_of_distance(t5.T5Config(), 10, dev)

def sdpa_cross(qq, kk, vv, bb, scale=None):
    g = qq.shape[0] // kk.shape[0]
    q4 = qq.reshape(kk.shape[0], g, *qq.shape[1:]).permute(0, 2, 1, 3).contiguous()
    k4, v4 = kk.permute(0, 2, 1, 3).contiguous(), vv.permute(0, 2, 1, 3).contiguous()
    m4 = bb[:, None, None, :].to(qq.dtype)
    return lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=m4, scale=scale)

qs = q[:, :, None, :].contiguous()
ks9, vs9 = kc[:, :9].permute(0, 2, 1, 3).contiguous(), vc[:, :9].permute(0, 2, 1, 3).contiguous()
qts = qt[:, :, None, :].contiguous()
kts, vts = kct.permute(0, 2, 1, 3).contiguous(), vct.permute(0, 2, 1, 3).contiguous()
relmask = k910.relative_bias_row(table, buckets, 9, 10)[None, :, None, :]
calls = {
    "k9 M=14": (lambda: k910.cross_attention_step(q, kx, vx, bias), sdpa_cross(q, kx, vx, bias)),
    "k9 step 0": (lambda: k910.cross_attention_step(q[:B], kx, vx, bias),
                  sdpa_cross(q[:B].contiguous(), kx, vx, bias)),
    "k9 M=1024": (lambda: k910.cross_attention_step(q, kl, vl, bias_l),
                  sdpa_cross(q, kl, vl, bias_l)),
    "k9 f32 T5": (lambda: k910.cross_attention_step(qt, kt, vt, bias_t),
                  sdpa_cross(qt, kt, vt, bias_t, scale=1.0)),
    "k10 step 8": (lambda: k910.self_attention_step(q, kc, vc, 8),
                   lambda: F.scaled_dot_product_attention(qs, ks9, vs9)),
    "k10 rel f32 step 9": (lambda: k910.self_attention_step_rel(qt, kct, vct, 9, table, buckets),
                           lambda: F.scaled_dot_product_attention(qts, kts, vts,
                                                                  attn_mask=relmask, scale=1.0)),
}
out = {}
for name, (fn, lib) in calls.items():
    out[name] = {"ms": eager(fn), "graph_ms": graphed(fn), "sdpa_ms": eager(lib),
                 "sdpa_graph_ms": graphed(lib)}
host, index, cfg, params, ids, mask, kw = bench_generate.operating_point("cuda")
from seal_tpu_torch.decoding import generate
run = lambda: generate.fm_index_generate(cfg, params, index, ids, mask, **kw)
run(); torch.cuda.synchronize()
prof = bench_generate.profile_batch(run)
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
    run(); torch.cuda.synchronize()
att = {}
for e in p.events():
    if e.device_type == DeviceType.CUDA and "attention_kernel" in e.name:
        key = e.name.replace("(anonymous namespace)::", "").split("(")[0][:80]
        ms, n = att.get(key, (0.0, 0))
        att[key] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
print(json.dumps({"kernels": out, "batch_device_ms": prof["device_busy_ms"],
                  "batch_wall_ms": prof["wall_ms"],
                  "attention_device_ms": sum(ms for ms, _ in att.values()),
                  "attention_calls": sum(n for _, n in att.values()),
                  "attention_by_kernel": {k: {"ms": ms, "calls": n} for k, (ms, n) in att.items()}}))
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench_attention: no CUDA device available", file=sys.stderr)
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
