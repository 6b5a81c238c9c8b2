"""Kernel 17 wrapper: the dense candidate pass of the ``exact_mask`` decode
mode (``csrc/dense_scores.cu``).

Replaces, in ``seal_tpu/decoding/constrained.py``: the dense branch of
``_candidates_general`` (:321-327) with ``_apply_branches`` (:897-912),
``cons = where(allowed, cand_lp, NEG_INF)`` (:1394) and the parent's beam
score added before ``_select`` (:1287-1294).  A selection and one f32 add
per element, so the kernel equals the plain version bit for bit.  Two
entry points:

* :func:`dense_select`, the dense step: the scores ranked for each query's
  top ``k`` inside kernel 3's select (one launch, the scores never
  written), in kernel 3's order; past the select's shared sort
  (``row_topk.MAX_K``) the streaming pass and kernel 3's global sort
  (:func:`route` states the choice);
* :func:`dense_scores`, a streaming pass that writes the flat [B, K * V]
  scores, where diverse groups (kernel 21) read them.

Both read each beam's allowed set as the count mask of kernel 15's or
16's mask mode (``kernels/count_mask.py``: int32 [B, K, words(V)], a bit
a token; 32x fewer bytes than [B, K, V] int32 counts); the plain versions
unpack it.  Flat indices are 64-bit: B * K * V may pass 2^31.  A
query's row K * V stays below 2^31, the width of one select row (kernel
3's ``int``).
"""

from __future__ import annotations

import torch

from seal_tpu_torch.kernels import Launches, count_mask, row_topk
from seal_tpu_torch.kernels.beam_select import NEG_INF, apply_branches

ROW_LIMIT = 2**31  # a query's K * V: one select row of kernel 3's int width
STREAM_SORT = Launches()  # dense steps past the shared sort: streaming pass, then kernel 3

_FNS = None  # (seal_dense_scores, seal_dense_select, build.stream_ptr), looked up once


def _lib():
    global _FNS
    if _FNS is None:
        from seal_tpu_torch.kernels import build

        so = build.lib()
        _FNS = so.seal_dense_scores, so.seal_dense_select, build.stream_ptr
    return _FNS


def dense_scores_plain(mask, lp, prev_count, finished, beam_scores, *, eos: int, pad: int,
                       stop_at_count: int = 0, always_allow_eos: bool = False):
    B, K = mask.shape[:2]
    V = lp.shape[-1]
    tokens = torch.arange(V, dtype=torch.int32, device=mask.device).expand(B, K, V)
    allowed = apply_branches(tokens, count_mask.unpack(mask, V), prev_count, finished, eos=eos,
                             pad=pad, stop_at_count=stop_at_count,
                             always_allow_eos=always_allow_eos)
    cons = torch.where(allowed, lp.reshape(B, K, V), NEG_INF) + beam_scores[..., None]
    return cons.reshape(B, K * V)


def dense_select_plain(mask, lp, prev_count, finished, beam_scores, k: int, *, eos: int,
                       pad: int, stop_at_count: int = 0, always_allow_eos: bool = False):
    scores = dense_scores_plain(mask, lp, prev_count, finished, beam_scores, eos=eos, pad=pad,
                                stop_at_count=stop_at_count, always_allow_eos=always_allow_eos)
    return row_topk.row_topk_plain(scores, k)


def route(B: int, K: int, V: int, k: int) -> str:
    """The dense step's route on the card for a query's top ``k`` of its
    [K * V] scores, by size: "select" (kernel 17 inside kernel 3's select,
    one launch, the scores never written) where ``k`` fits the select's
    shared sort (``row_topk.MAX_K``); past it "stream_sort": the streaming
    pass writes the [B, K * V] scores and kernel 3 takes their top ``k``
    (its global sort).  Both orders are kernel 3's, so the routes agree bit
    for bit.  Raises where a row K * V reaches 2^31 (``ROW_LIMIT``): either
    route ranks a query's row as one select row of ``int`` width."""
    if K * V >= ROW_LIMIT:
        raise ValueError(f"dense_select: a query's row of K * V = {K * V} scores; the select "
                         f"ranks rows below 2^31 (kernel 3's int width)")
    if not 0 < k <= K * V:
        raise ValueError(f"dense_select: k={k} for rows of width {K * V}")
    return "select" if k <= row_topk.MAX_K else "stream_sort"


def _check(mask, lp, prev_count, finished, beam_scores, name: str):
    """The shapes, and on the card the types; returns (B, K, V) and the
    branch state as the kernels read it."""
    B, K, W = mask.shape
    V = lp.shape[-1]
    if lp.shape != (B * K, V) or W != count_mask.words(V):
        raise ValueError(f"{name}: lp {tuple(lp.shape)} vs the count mask "
                         f"{tuple(mask.shape)} (words(V) = {count_mask.words(V)} a beam)")
    if not lp.is_cuda:
        return (B, K, V), None
    if lp.dtype != torch.float32 or lp.stride(1) != 1:
        raise ValueError(f"{name}: lp must be f32 with unit column stride")
    if mask.dtype != torch.int32 or beam_scores.dtype != torch.float32:
        raise ValueError(f"{name}: the count mask must be int32 and beam_scores f32")
    state = (prev_count.to(torch.int32).contiguous(), finished.to(torch.bool).contiguous(),
             beam_scores.contiguous())
    return (B, K, V), (mask.contiguous(),) + state


def dense_scores(mask, lp, prev_count, finished, beam_scores, *, eos: int, pad: int,
                 stop_at_count: int = 0, always_allow_eos: bool = False):
    """Constrained scores of every (beam, token) candidate of a step.

    ``mask`` int32 [B, K, words(V)]: each beam's count mask
    (``dense_mask``: a bit a token, set where its count is > 0); ``lp``
    f32 [B*K, V]: log-probs (any row stride); ``prev_count``, ``finished``,
    ``beam_scores`` [B, K].  A token is allowed by the reference branches
    (stop-forced beams: EOS only; finished beams: PAD only; else its bit;
    ``always_allow_eos`` adds EOS).  Returns f32 [B, K * V]: ``lp`` where
    allowed, else ``NEG_INF``, plus the beam score.

    CPU tensors run the plain version; CUDA tensors launch kernel 17's
    streaming pass.
    """
    kw = dict(eos=eos, pad=pad, stop_at_count=stop_at_count, always_allow_eos=always_allow_eos)
    (B, K, V), args = _check(mask, lp, prev_count, finished, beam_scores, "dense_scores")
    if args is None:
        return dense_scores_plain(mask, lp, prev_count, finished, beam_scores, **kw)
    fn, _, stream = _lib()
    mask, prev_count, finished, beam_scores = args
    out = torch.empty((B, K * V), dtype=torch.float32, device=lp.device)
    rc = fn(mask.data_ptr(), lp.data_ptr(), lp.stride(0), prev_count.data_ptr(),
            finished.data_ptr(), beam_scores.data_ptr(), B * K, V, eos, pad, stop_at_count,
            int(always_allow_eos), NEG_INF, out.data_ptr(), stream(lp))
    if rc:
        raise RuntimeError(f"dense_scores: CUDA error {rc}")
    dense_scores.launches += 1
    return out


def dense_select(mask, lp, prev_count, finished, beam_scores, k: int, *, eos: int, pad: int,
                 stop_at_count: int = 0, always_allow_eos: bool = False,
                 layout: row_topk.Plan | None = None):
    """The dense step's top ``k`` of each query's [K * V] constrained scores
    (:func:`dense_scores`' values), as (values f32, int64 flat indices)
    [B, k] in kernel 3's order (value descending, index ascending):
    ``row_topk(dense_scores(...), k)``, bit for bit.

    CPU tensors run the plain version.  CUDA tensors take the route that
    :func:`route` gives by size: up to ``row_topk.MAX_K``, one call of
    kernel 3's select with the scores computed as it stages the rows (never
    written), laid out by ``row_topk.plan(B, K * V, k)`` or by ``layout``,
    where ``lp`` must be contiguous ([B*K, V] seen as [B, K * V]) and
    16-byte aligned; past it, the streaming pass, then
    kernel 3 (its global sort), counted on ``STREAM_SORT``.  A row K * V of
    2^31 or more raises.
    """
    kw = dict(eos=eos, pad=pad, stop_at_count=stop_at_count, always_allow_eos=always_allow_eos)
    (B, K, V), args = _check(mask, lp, prev_count, finished, beam_scores, "dense_select")
    if not 0 < k <= K * V:
        raise ValueError(f"dense_select: k={k} for rows of width {K * V}")
    if args is None:
        return dense_select_plain(mask, lp, prev_count, finished, beam_scores, k, **kw)
    if route(B, K, V, k) == "stream_sort":
        if layout is not None:
            raise ValueError(f"dense_select: k={k} takes the streaming pass and kernel 3's "
                             f"global sort, which no select layout lays out")
        STREAM_SORT.launches += 1
        return row_topk.row_topk(dense_scores(mask, lp, prev_count, finished, beam_scores, **kw),
                                 k)
    if not lp.is_contiguous() or lp.data_ptr() % 16:
        raise ValueError("dense_select: lp must be contiguous and 16-byte aligned (its rows "
                         "are the select's [B, K * V] rows)")
    p = row_topk.plan(B, K * V, k) if layout is None else layout
    if p.sort != "shared":
        raise ValueError(f"dense_select: a layout of the shared sort is required, got "
                         f"{p.sort!r}")
    _, fn, stream = _lib()
    mask, prev_count, finished, beam_scores = args
    vals = torch.empty((B, k), dtype=torch.float32, device=lp.device)
    idx = torch.empty((B, k), dtype=torch.int64, device=lp.device)
    rc = fn(mask.data_ptr(), lp.data_ptr(), prev_count.data_ptr(), finished.data_ptr(),
            beam_scores.data_ptr(), B, K, V, eos, pad, stop_at_count, int(always_allow_eos),
            NEG_INF, k, *p.launch, vals.data_ptr(), idx.data_ptr(), stream(lp))
    if rc:
        raise RuntimeError(f"dense_select: CUDA error {rc}")
    dense_select.launches += 1
    return vals, idx


dense_scores.launches = 0
dense_select.launches = 0
