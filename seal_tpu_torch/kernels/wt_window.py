"""Kernel 13 wrapper: window rows of the wavelet layouts fused with the
log-prob gather (``csrc/wt_window.cu``).

Replaces ``seal_tpu/ops/wt_ops.py``: ``access`` (:115) with ``_digit_at``
(:87), ``bwt_at`` (:154) and ``window_continuations`` (:176, through
``seal_tpu/ops/_generic.py:41``), and the ``take_along_axis`` of the
log-probs after them (``seal_tpu/decoding/constrained.py:385-387`` and
``:632-634``).  The rows and the output contract are kernel 2's
(``window_gather.window_rows``): ``tok``, ``valid``, ``lp``, and ``fill``
in invalid slots.  Two modes, chosen by the index:

* descent (compact layout): each slot's symbol by ``digits`` levels of
  digit read + rank;
* direct (hybrid layout): one 2- or 4-byte read of the raw BWT.

Integer outputs and gathered floats, so the kernel equals the plain version
exactly.  Latency bound (a dependent chain of ``digits`` block reads, or
one read, then the log-prob); one thread per slot.
"""

from __future__ import annotations

import torch

from seal_tpu_torch.index.fm_index import SHIFT
from seal_tpu_torch.kernels.window_gather import window_rows
from seal_tpu_torch.kernels.wt_search import access_plain, check_index, index_args


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
    from seal_tpu_torch.kernels import build

    check_index(index, "wt_window_gather")
    if lp.dtype != torch.float32 or lp.stride(1) != 1:
        raise ValueError("wt_window_gather: lp must be f32 with unit column stride")
    bwt, bwt_bytes = None, 0
    if index.bwt is not None:
        if index.bwt.dtype not in (torch.int16, torch.int32) or not index.bwt.is_contiguous():
            raise ValueError("wt_window_gather: index.bwt must be contiguous int16 or int32")
        bwt, bwt_bytes = index.bwt.data_ptr(), index.bwt.element_size()
    lo_c = lo.to(torch.int32).contiguous()
    hi_c = hi.to(torch.int32).contiguous()
    shape = tuple(lo.shape) + (w,)
    tok = torch.empty(shape, dtype=torch.int32, device=lp.device)
    valid = torch.empty(shape, dtype=torch.bool, device=lp.device)
    lp_out = torch.empty(shape, dtype=torch.float32, device=lp.device)
    rc = build.lib().seal_wt_window_gather(
        *index_args(index), bwt, bwt_bytes, lp.data_ptr(), lp.stride(0), lo_c.data_ptr(),
        hi_c.data_ptr(), lo_c.numel(), w, index.vocab, fill, tok.data_ptr(), valid.data_ptr(),
        lp_out.data_ptr(), build.stream_ptr(lp),
    )
    build.check(rc, "wt_window_gather")
    wt_window_gather.launches += 1
    return tok, valid, lp_out


wt_window_gather.launches = 0
