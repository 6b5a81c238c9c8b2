"""Kernel 20's design choices on the card, each undone in a copy of its
source and timed beside the shipped kernel.

    python -m seal_tpu_torch.bench_sample

Copies of ``kernels/csrc/sample_select.cu``, each with one choice undone
(built into ``kernels/_build/sample_variants/``, loaded beside the kernel
library), run on the bench's inputs: step 0's V-wide [480, 50265]
log-prob rows under an 80% corpus mask (flat rows, from a seeded normal,
and the same rows times 4, whose log-probs spread further), a sampled
``exact_mask`` step's count vectors at [32, 15, 50265] (7% allowed) and
the sampling buffer's candidate lists at [32, 15, 290] (top_m 256):

* ``shipped``: the kernel as built;
* ``no_bound``: every finite column of the V-wide rows and count vectors
  pays its two ``logf`` (no Gumbel bound a bucket of words);
* ``lists_bound``: candidate lists take that bound too (the kernel's lists
  do not: each of their finite slots pays);
* ``quad_skip``: a quad whose largest cons plus the largest Gumbel value
  the generator gives (16.64) cannot beat the lane's best skips its Philox
  call (the skip the kernel does not take);
* ``counts_by_lane``: count vectors drawn a lane at a time, as dense rows
  are (no warp lists);
* ``wide_by_lists``: dense rows drawn on the warp lists, as count vectors
  are.

Each variant's draws are checked against the shipped kernel's (token and
score of every chain), then timed graph-replayed (20 calls in one CUDA
graph, 10 replays).  The shipped kernel also runs the 290-slot lists on
the warp route (a warp a row, which ``sample_select.plan`` gives only up
to ``WARP_MAX`` columns) beside its block route.  Prints the card's name
and power limit, then one JSON line.  Needs one CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

VARIANTS = {
    "no_bound": [
        ("  static constexpr bool kLists = false;\n  static constexpr bool kBound = true;",
         "  static constexpr bool kLists = false;\n  static constexpr bool kBound = false;"),
        ("  static constexpr bool kLists = true;  // see draw_quads\n"
         "  static constexpr bool kBound = true;",
         "  static constexpr bool kLists = true;\n  static constexpr bool kBound = false;"),
    ],
    "lists_bound": [
        ("  static constexpr bool kBound = false;\n", "  static constexpr bool kBound = true;\n"),
    ],
    "quad_skip": [
        ("      if (!fin) continue;\n      const uint4 w = philox4x32_10(",
         "      float cmax = -3.0e38f;\n"
         "      for (int t = 0; t < 4; ++t)\n"
         "        if ((fin >> t) & 1u) cmax = fmaxf(cmax, c[t]);\n"
         "      if (!fin || __fadd_rn(cmax, 16.64f) <= d.best) continue;\n"
         "      const uint4 w = philox4x32_10("),
    ],
    "counts_by_lane": [
        ("  static constexpr bool kLists = true;  // see draw_quads",
         "  static constexpr bool kLists = false;"),
    ],
    "wide_by_lists": [
        ("struct WideCols {\n  static constexpr bool kLists = false;",
         "struct WideCols {\n  static constexpr bool kLists = true;"),
    ],
}


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
    out_dir = os.path.join(build.BUILD_DIR, "sample_variants")
    os.makedirs(out_dir, exist_ok=True)
    cu, so = os.path.join(out_dir, f"{name}.cu"), os.path.join(out_dir, f"{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC, "-shared", "-o",
                           so, cu], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(so)
    for fn in ("seal_sample_select", "seal_sample_counts"):
        getattr(lib, fn).argtypes = build.SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def main() -> int:
    import torch

    from seal_tpu_torch.kernels import build
    from seal_tpu_torch.kernels import sample_select as k20
    from seal_tpu_torch.kernels.beam_select import NEG_INF, _select_outputs

    if not torch.cuda.is_available():
        print("bench_sample: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card or "unknown card", flush=True)
    libs = {"shipped": build.lib()}
    with open(os.path.join(build.CSRC, "sample_select.cu")) as f:
        src = f.read()
    for name in VARIANTS:
        libs[name] = _variant(name, src, build)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(20)
    B, K, V, n = 32, 15, 50265, 256 + 32 + 2
    rows = B * K
    flat = torch.log_softmax(torch.randn(rows, V, generator=g, device=dev) * 2, -1)
    spread = flat * 4
    corpus = torch.rand(V, generator=g, device=dev) < 0.8
    zero = torch.zeros(B, K, device=dev)
    counts = torch.where(torch.rand(B, K, V, generator=g, device=dev) < 0.07, 1, 0).int()
    prev = torch.full((B, K), 5, dtype=torch.int32, device=dev)
    fin = torch.zeros(B, K, dtype=torch.bool, device=dev)
    tok = torch.randint(3, V, (B, K, n), generator=g, device=dev, dtype=torch.int32)
    lpl = torch.gather(flat, 1, tok.reshape(rows, n).long()).reshape(B, K, n).contiguous()
    consl = torch.where(torch.rand(B, K, n, generator=g, device=dev) < 0.7, lpl, NEG_INF)
    outs = _select_outputs(B, K, dev)[:8]
    ptrs = [t.data_ptr() for t in outs]
    stream = lambda: build.stream_ptr(flat)  # noqa: E731

    def wide(lib, x):
        return lambda: lib.seal_sample_select(
            x.data_ptr(), x.data_ptr(), None, corpus.data_ptr(), zero.data_ptr(), rows, K, V, 5,
            0, 0, 2, 1, NEG_INF, k20.plan(rows, V).code, *ptrs, stream())

    def count(lib):
        return lambda: lib.seal_sample_counts(
            counts.data_ptr(), flat.data_ptr(), V, prev.data_ptr(), fin.data_ptr(),
            zero.data_ptr(), rows, K, V, 2, 1, 0, 0, 5, 4, 0, NEG_INF, k20.plan(rows, V).code,
            *ptrs, stream())

    def lists(lib, code):
        return lambda: lib.seal_sample_select(
            consl.data_ptr(), lpl.data_ptr(), tok.data_ptr(), None, zero.data_ptr(), rows, K, n,
            5, 3, 0, 2, 1, NEG_INF, code, *ptrs, stream())

    def draws(fn):
        fn()
        torch.cuda.synchronize()
        return outs[4].clone(), outs[6].clone()

    cases = {"v_wide_flat": lambda lib: wide(lib, flat),
             "v_wide_spread": lambda lib: wide(lib, spread),
             "count_vectors": count,
             "lists_290": lambda lib: lists(lib, k20.plan(rows, n).code)}
    want = {case: draws(make(libs["shipped"])) for case, make in cases.items()}
    result = {}
    for name, lib in libs.items():
        row = {}
        for case, make in cases.items():
            fn = make(lib)
            got = draws(fn)
            row[case] = {"graph_ms": graphed(torch, fn),
                         "equal": all(torch.equal(a, b) for a, b in zip(got, want[case]))}
        result[name] = row
    warp = lists(libs["shipped"], 0)
    result["shipped"]["lists_290_warp_route"] = {
        "graph_ms": graphed(torch, warp),
        "equal": all(torch.equal(a, b) for a, b in zip(draws(warp), want["lists_290"]))}
    print(json.dumps({"card": card, "variants": result}))
    return 0 if all(c["equal"] for r in result.values() for c in r.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
