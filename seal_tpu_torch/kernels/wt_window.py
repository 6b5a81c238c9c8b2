"""Kernel 13 wrapper: the wavelet layouts' window and slab rows fused with
the log-prob gather (``csrc/wt_window.cu``), in kernel 2's three modes.

Replaces ``seal_tpu/ops/wt_ops.py``: ``access`` (:115) with ``_digit_at``
(:87), ``bwt_at`` (:154) and ``window_continuations`` (:176, through
``seal_tpu/ops/_generic.py:41``), the ``take_along_axis`` of the log-probs
after them (``seal_tpu/decoding/constrained.py:385-387`` and ``:632-634``)
and ``merge_round``'s slab (:622-635).  The rows and the output contract
are kernel 2's (``window_gather``): ``tok``, ``valid``, ``lp``; ``fill`` in
invalid window slots, token 0 in invalid slab slots.

* :func:`wt_window_gather`: a range's window (the speculative step's);
* :func:`wt_slab_gather`: a proposal round's slab, rows [lo + rows_prev,
  + width) cut at hi, the bounds computed in the kernel;
* :func:`wt_window_slab`: the step's window and round 0's slab (rows_prev
  0) in one launch; a stride-1 window no wider than the slab reads no row
  of its own.

Two symbol readers, chosen by the index: the descent (compact layout:
``digits`` levels, each one round of loads -- the node's row and the
position's block together, see the source) and one 2- or 4-byte read of
the raw BWT (hybrid layout).  Integer outputs and gathered floats, so the
kernel equals its plain version exactly; the plain versions are kernel 2's
compositions over :func:`bwt_at`.  ``wt_window_gather.launches`` counts
every launch, ``WINDOW_SLAB`` and ``SLAB`` the launches of those modes.
"""

from __future__ import annotations

import torch

from seal_tpu_torch.index.fm_index import SHIFT
from seal_tpu_torch.kernels import Launches
from seal_tpu_torch.kernels.window_gather import slab_bounds, window_rows
from seal_tpu_torch.kernels.wt_search import access_plain, check_index, index_args

WINDOW_SLAB = Launches()  # wt_window_gather launches in the window + slab mode
SLAB = Launches()  # wt_window_gather launches in the slab mode
_FN = {}  # kernel 13's C entry point, looked up once


def bwt_at(index, rows):
    """BWT symbols at rows, *unshifted* (sentinel -> -1): one read of the
    raw BWT in the hybrid layout, the descent in the compact one."""
    rows = torch.as_tensor(rows, dtype=torch.int32, device=index.device)
    if index.bwt is not None:
        sym = index.bwt[rows.long()].to(torch.int32)
        if index.bwt.dtype == torch.int16:
            sym = sym & 0xFFFF  # uint16 values stored as int16 bits
        return sym - SHIFT
    return access_plain(index, rows) - SHIFT


def wt_window_gather_plain(index, lo, hi, w: int, lp, fill: int):
    rows, ok = window_rows(lo, hi, w)
    sym = bwt_at(index, torch.where(ok, rows, 0))
    ok = ok & (sym >= 0) & (sym < index.vocab)
    tok = torch.where(ok, sym, fill).to(torch.int32)
    R = lo.numel()
    lp_out = torch.gather(lp, 1, tok.reshape(R, w).long()).reshape(tok.shape)
    return tok, ok, lp_out


def wt_slab_gather_plain(index, lo, hi, rows_prev: int, width: int, lp):
    return wt_window_gather_plain(index, *slab_bounds(lo, hi, rows_prev, width), width, lp, 0)


def wt_window_slab_plain(index, lo, hi, w: int, width: int, lp, fill: int):
    return (*wt_window_gather_plain(index, lo, hi, w, lp, fill),
            *wt_slab_gather_plain(index, lo, hi, 0, width, lp))


def _i32(x):
    if x.dtype != torch.int32:
        x = x.to(torch.int32)
    return x if x.is_contiguous() else x.contiguous()


def _empty(lo, k: int, lp):
    """Uninitialized (tok, valid, lp) outputs of ``k`` slots a range."""
    shape = (*lo.shape, k)
    return (torch.empty(shape, dtype=torch.int32, device=lp.device),
            torch.empty(shape, dtype=torch.bool, device=lp.device),
            torch.empty(shape, dtype=torch.float32, device=lp.device))


def _launch(index, lo, hi, w: int, width: int, rows_prev: int, lp, fill: int, name: str):
    """One launch; returns the window's and the slab's (tok, valid, lp),
    each ``lo.shape`` + [width], or None for a width of 0."""
    if lp.dim() != 2 or lp.shape[0] != lo.numel() or lo.shape != hi.shape:
        raise ValueError(f"{name}: lp {tuple(lp.shape)} vs ranges {tuple(lo.shape)} / "
                         f"{tuple(hi.shape)}")
    if lp.dtype != torch.float32 or lp.stride(1) != 1:
        raise ValueError(f"{name}: lp must be f32 with unit column stride")
    if min(w, width, rows_prev) < 0:
        raise ValueError(f"{name}: w {w}, width {width}, rows_prev {rows_prev} must be >= 0")
    check_index(index, name)
    if index.node_start.data_ptr() % 16 or index.node_cnt.data_ptr() % 16:
        raise ValueError(f"{name}: index.node_start and node_cnt must be 16-byte aligned")
    bwt, bwt_bytes = None, 0
    if index.bwt is not None:
        if index.bwt.dtype not in (torch.int16, torch.int32) or not index.bwt.is_contiguous():
            raise ValueError(f"{name}: index.bwt must be contiguous int16 or int32")
        bwt, bwt_bytes = index.bwt.data_ptr(), index.bwt.element_size()
    if not _FN:
        from seal_tpu_torch.kernels import build

        _FN.update(fn=build.lib().seal_wt_window_slab, check=build.check,
                   stream=build.stream_ptr)
    lo_c, hi_c = _i32(lo), _i32(hi)
    outs = [_empty(lo, k, lp) if k else None for k in (w, width)]
    ptrs = [t.data_ptr() if t is not None else None for o in outs for t in (o or (None,) * 3)]
    rc = _FN["fn"](*index_args(index), bwt, bwt_bytes, lp.data_ptr(), lp.stride(0),
                   lo_c.data_ptr(), hi_c.data_ptr(), lo_c.numel(), w, width, rows_prev,
                   index.vocab, fill, *ptrs, _FN["stream"](lp))
    _FN["check"](rc, name)
    wt_window_gather.launches += 1
    return outs


def wt_window_gather(index, lo, hi, w: int, lp, fill: int):
    """Window continuations of ranges [lo, hi) and their log-probs.

    lo/hi: int32 [...] with ``lo.numel()`` == lp rows; lp: f32 [R, V] (row r
    scores range r in flattened order).  Returns (tok int32 [..., w],
    valid bool [..., w], lp f32 [..., w]); invalid slots (past the range,
    sentinel, out of vocab) carry token ``fill`` and its log-prob.

    CPU tensors run the plain version; CUDA tensors launch kernel 13.
    """
    if lp.dim() != 2 or lp.shape[0] != lo.numel():
        raise ValueError(f"wt_window_gather: lp {tuple(lp.shape)} vs ranges {tuple(lo.shape)}")
    if not lp.is_cuda:
        return wt_window_gather_plain(index, lo, hi, w, lp, fill)
    if w == 0:
        return _empty(lo, 0, lp)
    win, _ = _launch(index, lo, hi, w, 0, 0, lp, fill, "wt_window_gather")
    return win


wt_window_gather.launches = 0


def wt_slab_gather(index, lo, hi, rows_prev: int, width: int, lp):
    """A proposal round's slab: the rows [lo + rows_prev, + width) of each
    range [lo, hi), cut at hi, as ``wt_window_gather``'s (tok, valid, lp)
    [..., width] (stride 1; invalid slots carry token 0, ``merge_round``'s
    fill).

    CPU tensors run the plain version; CUDA tensors launch kernel 13 once,
    which computes the bounds itself.
    """
    if not lp.is_cuda:
        return wt_slab_gather_plain(index, lo, hi, rows_prev, width, lp)
    if width == 0:
        return _empty(lo, 0, lp)
    _, slab = _launch(index, lo, hi, 0, width, rows_prev, lp, 0, "wt_slab_gather")
    SLAB.launches += 1
    return slab


def wt_window_slab(index, lo, hi, w: int, width: int, lp, fill: int):
    """A decode step's window (``wt_window_gather(..., w, lp, fill)``) and
    its proposal round 0's slab (``wt_slab_gather(..., 0, width, lp)``):
    six tensors, (tok, valid, lp) [..., w] then [..., width].

    CPU tensors run the plain version (the two calls); CUDA tensors launch
    kernel 13 once.
    """
    if not lp.is_cuda:
        return wt_window_slab_plain(index, lo, hi, w, width, lp, fill)
    if w == 0 or width == 0:
        return (*wt_window_gather(index, lo, hi, w, lp, fill),
                *wt_slab_gather(index, lo, hi, 0, width, lp))
    win, slab = _launch(index, lo, hi, w, width, 0, lp, fill, "wt_window_slab")
    WINDOW_SLAB.launches += 1
    return (*win, *slab)
