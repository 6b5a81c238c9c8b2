"""Kernel 15's mask mode on the card: its design choices, each undone in a
copy of its source, and its route threshold, timed beside the counts mode.

    python -m seal_tpu_torch.bench_dense_mask

Copies of ``kernels/csrc/fm_search.cu``, each with one choice undone
(built into ``kernels/_build/mask_variants/``, loaded beside the kernel
library), run on the generation point's dense ranges: [32, 15] ranges of
one- and two-token prefixes of the 1.2M-token corpus, plus the full range
and empty ones (as ``chip_smoke.py``'s dense phase builds them), on the Psi
index, and each shard's such ranges over the corpus in 4 shards:

* ``shipped``: the kernel as built;
* ``strided``: group g of G holds ranges g, g + G, g + 2G, ... (a query's
  beams, whose widths go together, in different groups), not g C .. g C
  + C - 1;
* ``threads_256``: CTAs of 256 threads, not 512;
* ``unbound_registers``: no bound on the registers a thread (the kernel
  bounds them so that four 512-thread CTAs fit an SM);
* ``loads_1``, ``loads_4``: 1 or 4 16-byte row loads in flight a thread
  (not 2);
* ``split_4096``, ``split_16384``: a CTA reads a range alone up to 4,096
  or 16,384 rows (not 65,536).

Each variant's mask is checked against the shipped kernel's, then timed
graph-replayed (20 calls in one CUDA graph, 10 replays) at ``hist_max``
from 2^16 to every range by its rows (``rows``), and at 0 (every range
ranked); the counts mode (``fm_dense_counts``) is timed beside them at its
default.  Prints the card's name and power limit, then one JSON line.
Needs one CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

VARIANTS = {
    "strided": [
        ("  const long long g0 = (long long)(blockIdx.x / C) * C;  // the group's first range\n"
         "  // slot j's range: g0 + j; the slots below m hold one\n"
         "  const auto range_of = [&](int j) { return g0 + j; };\n"
         "  const int m = (int)min((long long)C, n - g0);",
         "  const int g = blockIdx.x / C, G = gridDim.x / C;\n"
         "  const auto range_of = [&](int j) { return (long long)j * G + g; };\n"
         "  const int m = (int)min((long long)C, (n - g + G - 1) / G);"),
    ],
    "threads_256": [
        ("constexpr int MASK_THREADS = 512;", "constexpr int MASK_THREADS = 256;"),
    ],
    "loads_1": [("constexpr int MASK_U = 2;", "constexpr int MASK_U = 1;")],
    "loads_4": [("constexpr int MASK_U = 2;", "constexpr int MASK_U = 4;")],
    "split_4096": [("constexpr int SPLIT_ROWS = 65536;", "constexpr int SPLIT_ROWS = 4096;")],
    "split_16384": [("constexpr int SPLIT_ROWS = 65536;", "constexpr int SPLIT_ROWS = 16384;")],
    "unbound_registers": [
        ("__global__ void __launch_bounds__(MASK_THREADS, 4)\ndense_mask_kernel(",
         "__global__ void __launch_bounds__(MASK_THREADS)\ndense_mask_kernel("),
    ],
}
HIST_MAX = {"0": 0, "2^16": 1 << 16, "2^18": 1 << 18, "2^19": 1 << 19, "2^20": 1 << 20,
            "2^21": 1 << 21, "rows": 2**31 - 1}
FNS = ("seal_fm_dense_mask", "seal_fm_dense_mask_sharded")


def graphed(torch, fn, launches=20, replays=10):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (launches * replays)


def _variant(name: str, src: str, build) -> ctypes.CDLL:
    """The copy of the source with ``name``'s edits, built and loaded."""
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the source holds {old!r} {src.count(old)} times")
        src = src.replace(old, new)
    out_dir = os.path.join(build.BUILD_DIR, "mask_variants")
    os.makedirs(out_dir, exist_ok=True)
    cu, so = os.path.join(out_dir, f"{name}.cu"), os.path.join(out_dir, f"{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC, "-shared", "-o",
                           so, cu], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(so)
    for fn in FNS:
        getattr(lib, fn).argtypes = build.SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _prefix_ranges(torch, np, ix, host, rng, B, K, full_n, end):
    """[B, K] ranges of one- and two-token prefixes of ``host``'s text over
    ``ix``, the full range, an empty one and the empty one at the end."""
    from seal_tpu_torch.kernels import fm_search as k15

    dev = ix.device
    first = torch.as_tensor(rng.choice(host.text[:-1] - 1, size=(2, B, K)).astype(np.int32),
                            device=dev)
    flo = torch.zeros((B, K), dtype=torch.int32, device=dev)
    fhi = torch.full((B, K), full_n, dtype=torch.int32, device=dev)
    lo1, hi1 = k15.backward_step_plain(ix, first[0], flo, fhi)
    lo2, hi2 = k15.backward_step_plain(ix, first[1], lo1, hi1)
    even = torch.arange(K, device=dev) % 2 == 0
    lo, hi = torch.where(even, lo1, lo2), torch.where(even, hi1, hi2)
    lo[0, :3] = torch.tensor([0, 5, end], dtype=torch.int32)
    hi[0, :3] = torch.tensor([full_n, 5, end], dtype=torch.int32)
    return lo, hi


def main() -> int:
    import numpy as np
    import torch

    from seal_tpu_torch import bench_generate
    from seal_tpu_torch.index.fm_index import FMIndex
    from seal_tpu_torch.kernels import build
    from seal_tpu_torch.kernels import fm_search as k15

    if not torch.cuda.is_available():
        print("bench_dense_mask: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card or "unknown card", flush=True)
    libs = {"shipped": build.lib()}
    with open(os.path.join(build.CSRC, "fm_search.cu")) as f:
        src = f.read()
    for name in VARIANTS:
        libs[name] = _variant(name, src, build)

    B, K = bench_generate.BATCH, bench_generate.BEAM
    _, _, docs = bench_generate.build_corpus()
    host = FMIndex()
    host.initialize(docs)
    psi = bench_generate.build_index(host, "psi", "cuda")
    rng = np.random.default_rng(5)
    lo, hi = _prefix_ranges(torch, np, psi, host, rng, B, K, psi.n_rows, psi.n_rows)
    si, hosts = bench_generate.sharded_index("cuda")
    slo, shi = (torch.stack(x) for x in zip(*(
        _prefix_ranges(torch, np, si.block_view(s), h, rng, B, K, h.size(), h.size())
        for s, h in enumerate(hosts))))
    W = 4 * -(-psi.vocab // 128)
    out = torch.empty((B, K, W), dtype=torch.int32, device="cuda")

    def psi_call(lib, h):
        return lambda: lib.seal_fm_dense_mask(
            *k15._index_args(psi), psi.bwt.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            out.data_ptr(), lo.numel(), psi.vocab, h, build.stream_ptr(lo))

    def shard_call(lib, h):
        return lambda: lib.seal_fm_dense_mask_sharded(
            *k15._shard_args(si), si.bwt.data_ptr(), slo.data_ptr(), shi.data_ptr(),
            out.data_ptr(), slo[0].numel(), si.vocab, h, build.stream_ptr(slo))

    def mask_of(fn):
        rc = fn()
        torch.cuda.synchronize()
        if rc:
            raise RuntimeError(f"CUDA error {rc}")
        return out.clone()

    cases = {"psi": psi_call, "sharded_4": shard_call}
    want = {case: mask_of(make(libs["shipped"], k15.HIST_MAX_ROWS))
            for case, make in cases.items()}
    widths = (hi - lo).reshape(-1)
    result = {"ranges": {"n": int(widths.numel()), "median_rows": int(widths.median()),
                         "max_rows": int(widths.max()), "sum_rows": int(widths.sum()),
                         "past_2^18": int((widths > 1 << 18).sum())},
              "counts_mode": {"psi": graphed(torch, lambda: k15.fm_dense_counts(psi, lo, hi)),
                              "sharded_4": graphed(
                                  torch, lambda: k15.fm_dense_counts_sharded(si, slo, shi))}}
    ok = True
    for name, lib in libs.items():
        row = {}
        for case, make in cases.items():
            for label, h in HIST_MAX.items():
                fn = make(lib, h)
                equal = torch.equal(mask_of(fn), want[case])
                ok &= equal
                row[f"{case} hist_max {label}"] = {"graph_ms": graphed(torch, fn),
                                                   "equal": equal}
        result[name] = row
    print(json.dumps({"card": card, **result}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
