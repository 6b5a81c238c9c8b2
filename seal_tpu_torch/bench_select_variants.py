"""Kernel 8's wide route and candidate mode on the card: two design choices,
each undone, timed beside the kernel as built.

    python -m seal_tpu_torch.bench_select_variants

* ``sort_dedup``: a copy of ``kernels/csrc/beam_select.cu`` (built into
  ``kernels/_build/select_variants/``, loaded beside the kernel library)
  whose first instances come from a warp-wide bitonic sort of (token,
  slot) pairs in the warp's region, not from the hash table -- in the wide
  route and in the candidate mode alike.  The copy keeps the hash table's
  region sizes (the pairs fit in them), so only the dedup differs;
* ``splits_1``, ``splits_4``: the wide route at 1 or 4 CTAs a query where
  ``wide_splits`` gives 2 (the library as built, ``wide_splits`` replaced
  for the call; ``select_plan`` still raises the count where a CTA cannot
  hold its beams, and the JSON line gives the count each call took).

Inputs, made from a seed on the card as ``bench_select`` makes them (BART's
vocab of 50,265, batch 32, log-probs rounded to quarters so that scores
tie, tokens from [0, 400) so that they repeat): the selection at the
speculative default [32, 15, 386] with ``keep_invalid`` and at beam 32
over the 4-shard union window [32, 32, 578], both orders, with the
soundness flags; the candidate mode at 64, 290 and 386 slots a beam.  Each
variant's outputs are checked equal to the kernel's bit for bit, then
timed graph-replayed (20 calls in one CUDA graph, 10 replays).  Prints the
card's name and power limit, then one JSON line.  Needs one CUDA device.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import subprocess
import sys

# the sort's dedup, put in place of the hash table's (the copy keeps the
# hash table's function under another name, unused)
_SORT_FIRST = """\
__device__ __forceinline__ u64 dedup_pair(int tok, int j) {
  return ((u64)((unsigned)tok ^ 0x80000000u) << 32) | (unsigned)j;
}

// area[0, 2 ncand) hold (token ^ 2^31) << 32 | slot words, sorted ascending
// by a bitonic network of the warp in which every comparator puts the
// smaller word first (the first stride of each size compares mirrored
// places), so the absent words past ncand never move; a slot is first
// where its token's run starts.
__device__ void warp_first_instances(unsigned* area, int table, int ncand, unsigned* bits,
                                     const unsigned* want, int lane) {
  const int rows = (ncand + 31) >> 5;
  u64* pairs = (u64*)area;
  for (int i = lane; i < rows; i += 32) bits[i] = 0u;
  const int n2 = pow2_at_least(ncand);
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < n2 / 2; t += 32) {
        const int off = t & (stride - 1);
        const int i = 2 * t - off;
        const int j = stride == size >> 1 ? i - off + size - 1 - off : i + stride;
        if (j < ncand) {
          const u64 a = pairs[i], c = pairs[j];
          if (a > c) {
            pairs[i] = c;
            pairs[j] = a;
          }
        }
      }
      __syncwarp();
    }
  }
  for (int p = lane; p < ncand; p += 32) {
    const u64 v = pairs[p];
    if (p == 0 || (pairs[p - 1] >> 32) != (v >> 32))
      atomicOr(bits + ((unsigned)v >> 5), 1u << ((unsigned)v & 31u));
  }
  __syncwarp();
}

__device__ void warp_first_instances_hash("""
_HASH_HEAD = "__device__ void warp_first_instances("
VARIANTS = {  # name: [(old, new, times the source holds old)]
    "sort_dedup": [(_HASH_HEAD, _SORT_FIRST, 1),
                   ("((int*)area)[j] = tok;", "((u64*)area)[j] = dedup_pair(tok, j);", 2)],
}
FNS = ("seal_beam_select", "seal_beam_candidates")
EOS, PAD, V, B = 2, 1, 50265, 32


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
    for old, new, times in VARIANTS[name]:
        if src.count(old) != times:
            raise RuntimeError(f"{name}: the source holds {old!r} {src.count(old)} times")
        src = src.replace(old, new)
    out_dir = os.path.join(build.BUILD_DIR, "select_variants")
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


class _Lib:
    """The kernel library with ``FNS`` taken from another build."""

    def __init__(self, base, other):
        self._base, self._other = base, other

    def __getattr__(self, name):
        return getattr(self._other if name in FNS else self._base, name)


@contextlib.contextmanager
def _using(k8, build, lib=None, splits=None):
    """Kernel 8's wrappers launching ``lib``'s entry points, or the wide
    route at ``splits`` CTAs a query, inside the block."""
    base_lib, base_splits = build.lib, k8.wide_splits
    if not k8._FN:
        k8._lookup()
    if lib is not None:
        proxy = _Lib(base_lib(), lib)
        build.lib = lambda: proxy
        k8._FN["select"] = lib.seal_beam_select
    if splits is not None:
        k8.wide_splits = lambda n_par: splits
    k8.select_plan.cache_clear()
    try:
        yield
    finally:
        build.lib, k8.wide_splits = base_lib, base_splits
        k8._FN["select"] = base_lib().seal_beam_select
        k8.select_plan.cache_clear()


def main() -> int:
    import torch

    from seal_tpu_torch.kernels import beam_select as k8
    from seal_tpu_torch.kernels import build

    if not torch.cuda.is_available():
        print("bench_select_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card or "unknown card", flush=True)
    with open(os.path.join(build.CSRC, "beam_select.cu")) as f:
        src = f.read()
    libs = {name: _variant(name, src, build) for name in VARIANTS}

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(20)

    def rbool(p, shape):
        return torch.rand(shape, generator=g, device=dev) < p

    def rint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev, dtype=torch.int32)

    def select_args(Kb, n_buf, w):
        rows = B * Kb
        lp = torch.round(torch.log_softmax(torch.randn(rows, V, generator=g, device=dev) * 2, -1)
                         * 4) / 4
        take = lambda t: torch.gather(lp, 1, t.reshape(rows, -1).long()).reshape(t.shape)  # noqa: E731
        btok = rint(0, 400, (B, Kb, n_buf))
        win_valid = rbool(0.7, (B, Kb, w))
        win_tok = torch.where(win_valid, rint(0, 400, (B, Kb, w)), PAD)
        bs = torch.round(torch.randn(B, Kb, generator=g, device=dev) * 2) / 2 - 3
        return ((btok, take(btok), rbool(0.7, (B, Kb, n_buf))), n_buf, win_tok, win_valid,
                take(win_tok), rbool(0.5, (B, Kb, 2))[..., 1:], lp, rint(0, 50, (B, Kb)),
                rbool(0.1, (B, Kb)), bs, rbool(0.5, (B, Kb)),
                torch.round(torch.randn(B, Kb, generator=g, device=dev)) - 4)

    skw = dict(eos=EOS, pad=PAD)
    spec, u32 = select_args(15, 256, 128), select_args(32, 64, 512)
    select = {}
    for ties in (False, True):
        t = " ties" if ties else ""
        select[f"[32,15,386] keep_invalid{t}"] = (spec, dict(K=15, ties=ties, keep_invalid=True))
        select[f"[32,32,578]{t}"] = (u32, dict(K=32, ties=ties))
    cands = {f"[32,15,{n_buf + w + 2}]": (select_args(15, n_buf, w), n_buf == 256 and w == 128)
             for n_buf, w in ((30, 32), (256, 32), (256, 128))}

    def select_call(args, kw):
        return lambda: k8.beam_select(*args, **kw, **skw)

    def cand_call(args, kinv):
        return lambda: k8.beam_candidates(*args[:9], keep_invalid=kinv, **skw)

    def outputs(fn):
        out = fn()
        torch.cuda.synchronize()
        flat = []
        for x in out:
            flat.extend(x if isinstance(x, tuple) else (x,))
        return [x.clone() for x in flat if x is not None]

    def same(a, b):  # floats bit for bit
        bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x  # noqa: E731
        return len(a) == len(b) and all(torch.equal(bits(x), bits(y)) for x, y in zip(a, b))

    want_s = {k: outputs(select_call(*v)) for k, v in select.items()}
    want_c = {k: outputs(cand_call(*v)) for k, v in cands.items()}
    result = {"select": {}, "candidates": {}, "splits_taken": {}, "equal": {}}
    for k, (args, kw) in select.items():
        ncand = args[1] + args[2].shape[-1] + 2
        n_par = args[2].shape[1]
        plan = k8.select_plan(n_par, args[1], args[2].shape[-1], kw["K"], kw["ties"])
        result["select"][k] = {"shipped": graphed(torch, select_call(args, kw))}
        result["splits_taken"][k] = {"shipped": plan.n_chunks, "route": plan.route,
                                     "table": plan.chunk, "ncand": ncand}
    for k, v in cands.items():
        result["candidates"][k] = {"shipped": graphed(torch, cand_call(*v))}
    ok = True
    variants = [(name, dict(lib=lib)) for name, lib in libs.items()]
    variants += [(f"splits_{sp}", dict(splits=sp)) for sp in (1, 4)]
    for name, how in variants:
        with _using(k8, build, **how):
            for k, (args, kw) in select.items():
                equal = same(outputs(select_call(args, kw)), want_s[k])
                ok &= equal
                result["equal"][f"{name} {k}"] = equal
                result["select"][k][name] = graphed(torch, select_call(args, kw))
                if "splits" in how:
                    plan = k8.select_plan(args[2].shape[1], args[1], args[2].shape[-1], kw["K"],
                                          kw["ties"])
                    result["splits_taken"][k][name] = plan.n_chunks
            if "lib" in how:
                for k, v in cands.items():
                    equal = same(outputs(cand_call(*v)), want_c[k])
                    ok &= equal
                    result["equal"][f"{name} candidates {k}"] = equal
                    result["candidates"][k][name] = graphed(torch, cand_call(*v))
    # the kernel as built once more, after the variants: the drift of the call
    for k, (args, kw) in select.items():
        result["select"][k]["shipped_again"] = graphed(torch, select_call(args, kw))
    for k, v in cands.items():
        result["candidates"][k]["shipped_again"] = graphed(torch, cand_call(*v))
    result["card"] = card
    result["ok"] = ok
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
