"""Kernel 3 wrapper: exact row top-k, value descending and index ascending
on ties (``csrc/row_topk.cu``).

Replaces ``seal_tpu/decoding/constrained.py:_exact_topk`` (:395) and the
``lax.top_k`` calls of the decode path (``_top_idx`` :983, the proposal
loop :736, step-0 selection).  ``torch.topk`` leaves its tie order
unspecified, so it cannot stand in.  The order is lax.top_k's: f32's total
order (so +0.0 ranks above -0.0), ties to the lower index.  The plain
version is a stable descending sort of the order's integer key; the kernel
equals it exactly.  The kernel is a split-row radix select whose work
does not grow with k (see the source); :func:`plan` lays a call out.
Since the decode modes' top-``top_m`` (free generation, the speculative
round) came here from kernel 19, it serves those too.  Past k = 16384
(``MAX_K``: an ``exact_loop_chunk`` that wide) the survivors are sorted
in device memory by a bitonic network (``sort="global"``), exact as well.

:func:`pruned_topk` is the proven loop's straggler round in one launch:
kernel 3's select over the round's pruned log-probs (a token whose bucket
has no row in the beam's interval, or that the consumed-prefix threshold
has examined, is ``neg_inf``), computed by a value loader as the select
stages the log-probs (``PrunedLoad``), so the pruned copy is never written.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from seal_tpu_torch.index.fm_index import SHIFT
from seal_tpu_torch.kernels import Launches

MAX_SPLITS = 16  # CTAs a row: a thread-block cluster, 16 non-portable
MAX_K = 16384  # the leader CTA's sort buffer of 128 KB (seal_row_topk_max_k)
GTILE = 8192  # words a block of the large-k route's global sort orders in shared memory
FILL_CTAS = 128  # about one CTA per SM of an H100 (132 SMs)
MIN_SLICE = 4096  # no split for the card's sake below this many keys a CTA
WIDE_SLICE = 16384  # a slice of this many keys takes 1024 threads, a shorter one 512
CAND_CAP = 8192  # candidates a CTA holds on the streamed route (64 KB)
SMEM_BUDGET = 227 * 1024 - 1024  # Hopper's 227 KB a block, less the static part
_FN = _STREAM = None  # the C entry point and build.stream_ptr, looked up once
_PRUNED = None  # seal_pruned_topk, looked up once
GLOBAL_SORT = Launches()  # calls past MAX_K: the survivors sorted in device memory
BINS_BYTES = 28 * 1024  # three passes' cluster totals and a histogram (seal_row_topk_bins_bytes)


class Plan(NamedTuple):
    """A call's launch: ``splits`` CTAs of ``threads`` threads a row (one
    cluster) over slices of ``slice`` keys, ``staged`` of them in shared
    memory (the rest streamed from device memory, with ``cap`` candidates),
    a sort buffer of ``n2`` words after (or in) a ``region`` of bins, and
    ``smem`` dynamic bytes a CTA.  ``sort`` is "shared" (the leader sorts
    the survivors in its shared memory) or, past ``MAX_K``, "global" (they
    go to a [rows, n2] scratch in device memory, sorted there), or
    "none" (the k-th-value mode of kernel 19: no survivor is kept)."""

    route: str  # "staged": a slice in shared memory; "streamed": its tail not
    threads: int
    splits: int
    slice: int
    staged: int
    cap: int
    n2: int
    region: int
    smem: int
    ctas: int
    sort: str

    @property
    def launch(self) -> tuple:
        """The C entry point's layout arguments, in its order."""
        return (self.threads, self.splits, self.slice, self.staged, self.cap, self.n2,
                self.region, self.smem)


@functools.lru_cache(maxsize=256)
def plan(rows: int, width: int, k: int, splits: int | None = None,
         staged: int | None = None, cap: int = CAND_CAP, kth: bool = False) -> Plan:
    """The launch of kernel 3 for ``rows`` rows of ``width`` and top ``k``.

    By default a row is one CTA, and the split doubles (up to 16 CTAs a
    row) while the slice does not fit in shared memory, or while the card
    has fewer than ``FILL_CTAS`` CTAs and the slices stay at least
    ``MIN_SLICE`` keys.  A narrower row stays one CTA: its time is the
    CTA's fixed cost, and each cluster barrier adds to it
    (``python -m seal_tpu_torch.bench_row_topk`` times every call site at
    every split).  ``splits``, ``staged`` and ``cap`` force a route
    (tests and measurements).  Past ``MAX_K`` the survivors are sorted in
    device memory (``sort="global"``).  ``kth``: the k-th-value mode
    (kernel 19), which keeps no survivor, so no sort buffer (``n2`` 0) at
    any k, and splits a row only where it does not fit one CTA: each CTA
    of a cluster pays three passes of 2,048 remote bin adds and reads and
    a cluster barrier a pass, and at the warper's [480, 50265] and
    [120, 50265], k = 50, one CTA a row was the fastest of 1-16 even where
    more would fill the card (``bench_row_topk``'s ``row_kth layouts``).
    Raises where a forced layout is past the card's shared memory.
    Cached: the decode loop asks for the same few shapes every step."""
    if not 0 < k <= width:
        raise ValueError(f"row_topk: k={k} for rows of width {width}")
    n2 = 0 if kth else 1 << (k - 1).bit_length()
    sort = "none" if kth else "global" if k > MAX_K else "shared"
    # the bins; the sort buffer reuses two passes' totals up to 2048 words
    region = BINS_BYTES + (8 * n2 if 2048 < n2 and sort == "shared" else 0)
    room = (SMEM_BUDGET - region) // 4  # keys a CTA can stage
    if splits is None:
        splits = 1
        while splits < MAX_SPLITS and (
                -(-width // splits) > room
                or (not kth and rows * splits < FILL_CTAS
                    and -(-width // (2 * splits)) >= MIN_SLICE)):
            splits *= 2
    if not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"row_topk: {splits} CTAs a row; a cluster holds 1 to {MAX_SPLITS}")
    sl = -(-width // splits)
    if staged is None:
        staged = sl if sl <= room else (SMEM_BUDGET - region - 8 * cap) // 16 * 4
    staged = min(staged, sl)
    if staged == sl:
        cap = 0
    smem = region + 4 * (-(-staged // 4) * 4) + 8 * cap
    if staged < 0 or smem > SMEM_BUDGET:
        raise ValueError(f"row_topk: {smem} B of shared memory a CTA exceeds {SMEM_BUDGET} "
                         f"(k={k}, width {width}, {splits} CTAs a row)")
    route = "staged" if staged == sl else "streamed"
    threads = 1024 if sl >= WIDE_SLICE else 512
    return Plan(route, threads, splits, sl, staged, cap, n2, region, smem, rows * splits, sort)


def order_key(x):
    """int32 keys whose signed order is f32's total order (NaN-free x)."""
    i = x.contiguous().view(torch.int32)
    return torch.where(i < 0, i ^ 0x7FFFFFFF, i)


def row_topk_plain(x, k: int):
    idx = torch.sort(order_key(x), dim=-1, descending=True, stable=True)[1][..., :k]
    return torch.gather(x, -1, idx), idx


def row_topk(x, k: int, layout: Plan | None = None):
    """Top ``k`` of each row of f32 ``x`` [..., n]: (values, int64 indices),
    ordered like ``lax.top_k``.  ``x`` must be NaN-free.

    CPU tensors run the plain version; CUDA tensors launch the kernel, laid
    out by :func:`plan`, or by ``layout``: a plan with a forced split or
    route (tests and measurements).
    """
    n = x.shape[-1]
    if not 0 < k <= n:
        raise ValueError(f"row_topk: k={k} for rows of width {n}")
    if not x.is_cuda:
        return row_topk_plain(x, k)
    global _FN, _STREAM
    if x.dtype is not torch.float32:
        raise ValueError(f"row_topk: f32 input required, got {x.dtype}")
    if _FN is None:
        from seal_tpu_torch.kernels import build

        _FN, _STREAM = build.lib().seal_row_topk, build.stream_ptr
    x2 = x if x.dim() == 2 else x.reshape(-1, n)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    rows = x2.shape[0]
    p = plan(rows, n, k) if layout is None else layout
    vals = torch.empty((rows, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((rows, k), dtype=torch.int64, device=x.device)
    # the large-k route's survivors (freed after the launches, in stream order)
    scratch = (torch.empty((rows, p.n2), dtype=torch.int64, device=x.device)
               if p.sort == "global" else None)
    rc = _FN(x2.data_ptr(), rows, n, k, *p.launch,
             scratch.data_ptr() if scratch is not None else None, vals.data_ptr(),
             idx.data_ptr(), _STREAM(x))
    if rc:
        raise RuntimeError(f"row_topk: CUDA error {rc}")
    row_topk.launches += 1
    GLOBAL_SORT.launches += scratch is not None
    if x.dim() == 2:
        return vals, idx
    return vals.reshape(*x.shape[:-1], k), idx.reshape(*x.shape[:-1], k)


row_topk.launches = 0


def pruned_rows(lp, bits, th_lp, th_ix, bucket_size: int, neg_inf: float):
    """The round's ``work`` rows as JAX builds them (``seal_tpu/decoding/
    constrained.py:604-608, 734-735``): ``lp`` where the token's bucket
    ``(v + SHIFT) // bucket_size`` has its bit in ``bits`` and the token is
    past the (``th_lp``, ``th_ix``) threshold, else ``neg_inf``."""
    V = lp.shape[-1]
    v_idx = torch.arange(V, dtype=torch.int32, device=lp.device)
    bucket = (v_idx + SHIFT) // bucket_size
    support = ((bits[:, (bucket >> 5).long()] >> (bucket & 31)) & 1).bool()
    base = torch.where(support, lp, neg_inf)
    th, ix = th_lp[:, None], th_ix[:, None]
    consumed = (base > th) | ((base == th) & (v_idx <= ix))
    return torch.where(consumed, neg_inf, base)


def pruned_topk_plain(lp, bits, th_lp, th_ix, bucket_size: int, k: int, neg_inf: float):
    return row_topk_plain(pruned_rows(lp, bits, th_lp, th_ix, bucket_size, neg_inf), k)


def pruned_topk(lp, bits, th_lp, th_ix, bucket_size: int, k: int, neg_inf: float):
    """A straggler round's top ``k`` in one launch: ``row_topk`` of
    :func:`pruned_rows` (values and int64 indices, ``lax.top_k``'s order),
    bit for bit.  ``lp`` f32 [rows, V] (NaN-free), ``bits`` int32 [rows, 8]
    (the support modes of kernels 6 and 14), ``th_lp`` f32 and ``th_ix``
    int32 [rows]; every token's bucket below 256.

    CPU tensors run the plain version; CUDA tensors launch kernel 3's
    select through ``PrunedLoad`` (``csrc/row_topk.cu``), laid out by
    :func:`plan`, on every route ``row_topk`` takes at that width and k
    (the global sort past ``MAX_K``).
    """
    if lp.dim() != 2 or bits.shape != (lp.shape[0], 8) or th_lp.shape != (lp.shape[0],) \
            or th_ix.shape != (lp.shape[0],):
        raise ValueError(f"pruned_topk: lp {tuple(lp.shape)}, bits {tuple(bits.shape)}, "
                         f"thresholds {tuple(th_lp.shape)} / {tuple(th_ix.shape)}")
    rows, n = lp.shape
    if not 0 < k <= n:
        raise ValueError(f"pruned_topk: k={k} for rows of width {n}")
    if not 0 < bucket_size or (n - 1 + SHIFT) // bucket_size >= 256:
        raise ValueError(f"pruned_topk: bucket size {bucket_size} for a vocab of {n}")
    if not lp.is_cuda:
        return pruned_topk_plain(lp, bits, th_lp, th_ix, bucket_size, k, neg_inf)
    global _PRUNED, _STREAM
    if lp.dtype is not torch.float32 or bits.dtype is not torch.int32:
        raise ValueError(f"pruned_topk: f32 lp and int32 bits, got {lp.dtype}, {bits.dtype}")
    if _PRUNED is None:
        from seal_tpu_torch.kernels import build

        _PRUNED, _STREAM = build.lib().seal_pruned_topk, build.stream_ptr
    lp, bits = lp.contiguous(), bits.contiguous()
    th_lp = th_lp.to(torch.float32).contiguous()
    th_ix = th_ix.to(torch.int32).contiguous()
    p = plan(rows, n, k)
    vals = torch.empty((rows, k), dtype=torch.float32, device=lp.device)
    idx = torch.empty((rows, k), dtype=torch.int64, device=lp.device)
    scratch = (torch.empty((rows, p.n2), dtype=torch.int64, device=lp.device)
               if p.sort == "global" else None)
    rc = _PRUNED(lp.data_ptr(), bits.data_ptr(), th_lp.data_ptr(), th_ix.data_ptr(), rows, n,
                 k, bucket_size, neg_inf, *p.launch,
                 scratch.data_ptr() if scratch is not None else None, vals.data_ptr(),
                 idx.data_ptr(), _STREAM(lp))
    if rc:
        raise RuntimeError(f"pruned_topk: CUDA error {rc}")
    pruned_topk.launches += 1
    GLOBAL_SORT.launches += scratch is not None
    return vals, idx


pruned_topk.launches = 0
