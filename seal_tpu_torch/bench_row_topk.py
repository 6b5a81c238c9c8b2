"""Kernel 3's layouts and phases, kernel 19's layouts and kernel 18's sample
stride, on the card.

    python -m seal_tpu_torch.bench_row_topk

1. Kernel 3 (``kernels/csrc/row_topk.cu``) at each call site's shape
   (the rows of ``chip_smoke.py:row_topk_sites``, on log-softmax rows of a
   seeded normal) at every split that fits (1, 2, 4, 8 and 16 CTAs a row):
   eager and graph-replayed ms; ``*`` marks ``row_topk.plan``'s choice.
   Kernel 19 (kernel 3's select in its k-th-value mode) at the ``topk``
   warper's [480, 50265] and batch 8's [120, 50265], k = 50, at every
   split; ``*`` marks ``row_select.plan``'s choice.
2. Where a CTA's cycles go: an instrumented copy of kernel 3's source
   (``clock64`` at each phase boundary, thread 0 of each CTA, into a
   device array), built into ``kernels/_build/trace/`` and run at the
   plan's layout; the median of the leader CTAs' cycles in each phase.
3. Kernel 18's search (``kernels/csrc/locate.cu``) over 10,001 beginnings
   at sample strides 8, 16 and 32 (a copy of the source with the stride
   given), graph-replayed, beside ``torch.searchsorted``.
4. With ``--parent DIR`` (a checkout of another commit): ``doc_index_of``
   of that checkout and of this one, eager and graph-replayed, beside
   ``torch.searchsorted``, each in its own process, in turns (parent,
   this, this, parent).

Prints the card's name and power limit first.  Needs one CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

# the phases between the instrumented copy's marks (slot j to slot j + 1;
# pass p marks slots 2 + 3 p, 3 + 3 p and 4 + 3 p)
PHASES = ("init", "p0 histogram", "p0 totals+barrier", "p0 scan", "p1 histogram",
          "p1 totals+barrier", "p1 scan", "p2 histogram", "p2 totals+barrier", "p2 scan",
          "share", "gather", "final barrier", "place/sort")
KTH_SITES = (("warper", 480, 50265, 50), ("warper batch 8", 120, 50265, 50))
SITES = (("round 0", 480, 50265, 64), ("later rounds", 480, 50265, 256),
         ("sampling round 0", 480, 50265, 512), ("sampling later rounds", 480, 50265, 2048),
         ("step 0", 32, 50265, 30), ("dense", 32, 753975, 30), ("free", 32, 3840, 30))


# run in a checkout's root: its doc_index_of and torch.searchsorted on the
# same inputs, eager (back to back, host launch cost included) and
# graph-replayed (device time), as one JSON line
_K18_TURN = """
import json, sys
import numpy as np, torch
sys.path.insert(0, ".")
from seal_tpu_torch.kernels import locate

def eager(fn, iters=200):
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

beg = torch.as_tensor(np.cumsum(np.random.default_rng(0).integers(100, 300, 10001))
                      .astype(np.int32), device="cuda")
pos = torch.as_tensor(np.random.default_rng(1).integers(0, int(beg[-1]) + 10, 39025)
                      .astype(np.int32), device="cuda")
kern = lambda: locate.doc_index_of(beg, pos)
lib = lambda: torch.searchsorted(beg, pos, right=True, out_int32=True)
ok = bool(torch.equal(kern(), locate.doc_index_of_plain(beg, pos)))
print(json.dumps(dict(ok=ok, eager=eager(kern), graph=graphed(kern), lib_eager=eager(lib),
                      lib_graph=graphed(lib))))
"""


def _k18_turn(root: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", _K18_TURN], cwd=root, capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"doc_index_of turn in {root} failed:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _mark(n: int) -> str:
    return (f"\n  if (threadIdx.x == 0 && blockIdx.x < 8192) g_tr[blockIdx.x * 16 + {n}] = "
            "clock64();\n")


def _instrumented(src: str) -> str:
    def after(text, anchor, add):
        if anchor not in text:
            raise RuntimeError(f"bench_row_topk: the source lacks {anchor!r}")
        return text.replace(anchor, anchor + add, 1)

    pass_mark = ("  if (threadIdx.x == 0 && blockIdx.x < 8192) g_tr[blockIdx.x * 16 + {} + 3 * pass]"
                 " = clock64();\n")
    src = src.replace("namespace {\n", "namespace {\n__device__ long long g_tr[8192 * 16];\n", 1)
    src = after(src, "const long long row = blockIdx.x / C;", _mark(0))
    src = after(src, "  if (C > 1) cluster_arrive();\n", _mark(1))
    src = after(src, "    // the cluster's totals in the leader: this pass's own bins (a cluster\n",
                pass_mark.format(2))
    src = src.replace("    find_bin<THREADS>(tot,", pass_mark.format(3) + "    find_bin<THREADS>(tot,")
    src = after(src, "    mask |= dmask << shift;\n", pass_mark.format(4))
    src = after(src, "const unsigned take_eq = s_take;", _mark(11))
    src = src.replace("  sync_cluster(C);\n  if (!leader) return;",
                      _mark(12) + "  sync_cluster(C);\n  if (!leader) return;" + _mark(13))
    src = src.replace("    return;\n  }\n  for (int j = k + tid; j < n2; j += THREADS)",
                      _mark(14) + "    return;\n  }\n  for (int j = k + tid; j < n2; j += THREADS)")
    # (the kernel's end, the first of the two bodies that end so: the global
    # sort's output functor follows it)
    src = src.replace("    idx[row * k + j] = (long long)key_slot(w);\n  }\n}",
                      "    idx[row * k + j] = (long long)key_slot(w);\n  }\n" + _mark(14) + "}", 1)
    return src + ('\nextern "C" int seal_row_topk_trace(long long* h) {\n'
                  "  return (int)cudaMemcpyFromSymbol(h, g_tr, sizeof(long long) * 8192 * 16);\n}\n")


def _build(name: str, src: str, build) -> ctypes.CDLL:
    out_dir = os.path.join(build.BUILD_DIR, "trace")
    os.makedirs(out_dir, exist_ok=True)
    cu, so = os.path.join(out_dir, f"{name}.cu"), os.path.join(out_dir, f"{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC, "-shared", "-o",
                           so, cu], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr[-3000:]}")
    return ctypes.CDLL(so)


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from seal_tpu_torch.kernels import build, locate, row_select as k19, row_topk as k3

    if not torch.cuda.is_available():
        print("bench_row_topk: no CUDA device")
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    g = torch.Generator(device="cuda").manual_seed(1)
    lp = torch.log_softmax(torch.randn(480, 50265, generator=g, device="cuda") * 2, -1)
    dense = torch.full((32, 753975), -3.4e38, device="cuda")
    allowed = torch.rand(32, 753975, generator=g, device="cuda") < 0.02
    dense = torch.where(allowed, lp[:32].repeat(1, 15), dense)
    rows_of = {(480, 50265): lp, (32, 50265): lp[:32].contiguous(),
               (32, 753975): dense, (32, 3840): lp[:32, :3840].contiguous()}

    # 1. the layouts
    for label, rows, n, k in SITES:
        x = rows_of[(rows, n)]
        chosen = k3.plan(rows, n, k).splits
        cells = []
        for splits in (1, 2, 4, 8, 16):
            try:
                lay = k3.plan(rows, n, k, splits=splits)
            except ValueError:
                continue
            if lay.route != "staged" and splits != chosen:
                continue
            f = lambda lay=lay: k3.row_topk(x, k, layout=lay)  # noqa: E731
            cells.append(f"{splits}{'*' if splits == chosen else ''}: {cs.time_ms(f):.4f} "
                         f"(graph {cs.graph_ms(f):.4f})")
        print(f"row_topk layouts ({card}) {label} [{rows},{n}] k={k}, CTAs a row: ms (graph ms): "
              + "; ".join(cells), flush=True)

    for label, rows, n, k in KTH_SITES:
        x = lp[:rows].contiguous()
        want = k19.row_kth_plain(x, k).view(torch.int32)
        chosen = k19.plan(rows, n, k).splits
        cells = []
        for splits in (1, 2, 4, 8, 16):
            lay = k19.plan(rows, n, k, splits=splits)
            f = lambda lay=lay: k19.row_kth(x, k, layout=lay)  # noqa: E731
            ok = torch.equal(f().view(torch.int32), want)
            cells.append(f"{splits}{'*' if splits == chosen else ''} x {lay.threads}: "
                         f"{cs.time_ms(f):.4f} (graph {cs.graph_ms(f):.4f})"
                         + ("" if ok else " WRONG"))
        print(f"row_kth layouts ({card}) {label} [{rows},{n}] k={k}, CTAs a row x threads: ms "
              "(graph ms): " + "; ".join(cells), flush=True)

    # 2. the phases
    # the select kernel lives in radix_topk.cuh: inlined, then instrumented
    src = open(os.path.join(build.CSRC, "row_topk.cu")).read().replace(
        '#include "radix_topk.cuh"\n', open(os.path.join(build.CSRC, "radix_topk.cuh")).read())
    lib = _build("row_topk_trace", _instrumented(src), build)
    lib.seal_row_topk.argtypes = build.SIGNATURES["seal_row_topk"]
    lib.seal_row_topk_trace.argtypes = [ctypes.c_void_p]
    for label, rows, n, k in SITES:
        x = rows_of[(rows, n)]
        p = k3.plan(rows, n, k)
        vals = torch.empty(rows, k, device="cuda")
        idx = torch.empty(rows, k, dtype=torch.int64, device="cuda")
        for _ in range(2):
            rc = lib.seal_row_topk(x.data_ptr(), rows, n, k, *p.launch, None, vals.data_ptr(),
                                   idx.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"instrumented row_topk: CUDA error {rc}")
        torch.cuda.synchronize()
        h = np.zeros(8192 * 16, np.int64)
        lib.seal_row_topk_trace(h.ctypes.data)
        h = h.reshape(8192, 16)[: min(8192, rows * p.splits)]
        lead = h[np.arange(h.shape[0]) % p.splits == 0]
        d = np.diff(lead[:, :15], axis=1)
        print(f"row_topk phases ({card}) {label} [{rows},{n}] k={k}, {p.splits} x {p.threads} "
              f"threads a row, leader cycles median {np.median(lead[:, 14] - lead[:, 0]):.0f}: "
              + ", ".join(f"{name} {np.median(d[:, j]):.0f}" for j, name in enumerate(PHASES)),
              flush=True)

    # 3. kernel 18's sample stride
    src = open(os.path.join(build.CSRC, "locate.cu")).read()
    anchor = "  int stride = 8;  // doubled until the sample fits\n"
    if anchor not in src:
        raise RuntimeError("bench_row_topk: locate.cu lacks its stride line")
    src = src.replace(anchor, "  int stride = g_stride;\n").replace(
        'extern "C" int seal_locate', 'static int g_stride = 8;\nextern "C" void seal_locate_stride(int s) '
        '{ g_stride = s; }\nextern "C" int seal_locate')
    loc = _build("locate_stride", src, build)
    loc.seal_locate.argtypes = build.SIGNATURES["seal_locate"]
    beg = torch.as_tensor(np.cumsum(np.random.default_rng(0).integers(100, 300, 10001))
                          .astype(np.int32), device="cuda")
    pos = torch.randint(0, int(beg[-1]) + 10, (39025,), generator=g, dtype=torch.int32,
                        device="cuda")
    want = locate.doc_index_of_plain(beg, pos)
    cells = []
    for stride in (8, 16, 32):
        loc.seal_locate_stride(stride)
        out = torch.empty_like(pos)
        f = lambda: loc.seal_locate(beg.data_ptr(), beg.numel(), pos.data_ptr(), pos.numel(),  # noqa: E731
                                    1, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        ms = cs.graph_ms(f)
        cells.append(f"stride {stride}: {ms:.4f}{'' if torch.equal(out, want) else ' WRONG'}")
    lib_ms = cs.graph_ms(lambda: torch.searchsorted(beg, pos, right=True, out_int32=True))
    print(f"doc_index_of strides ({card}), 39025 positions over 10001 beginnings, graph-replayed "
          f"ms: " + "; ".join(cells) + f"; torch.searchsorted {lib_ms:.4f}", flush=True)

    # 4. against another checkout
    if "--parent" in sys.argv:
        parent = os.path.abspath(sys.argv[sys.argv.index("--parent") + 1])
        here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        for name, root in (("parent", parent), ("this", here), ("this", here),
                           ("parent", parent)):
            r = _k18_turn(root)
            print(f"doc_index_of turn ({card}) {name}: equal to plain {r['ok']}; kernel eager "
                  f"{r['eager']:.4f} ms, graph {r['graph']:.4f}; torch.searchsorted eager "
                  f"{r['lib_eager']:.4f}, graph {r['lib_graph']:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
