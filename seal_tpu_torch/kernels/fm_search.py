"""Kernel 1 and kernel 5 wrappers: the FM-index rank search
(``csrc/fm_search.cu``).

Kernel 1, ``fm_search``, replaces ``seal_tpu/ops/fm_ops.py``:
``_symbol_bounds`` (:113), ``_searchsorted_impl`` (:42), ``backward_step``
(:166) and ``contains_tokens`` (:288).  Kernel 5, ``fm_sequences``, chains
the backward step over padded token sequences in one launch and replaces
``seal_tpu/ops/_generic.py:range_for_sequences`` (:17), the scan behind
``fm_ops.range_for_sequences`` and ``count_sequences``.  The plain
PyTorch versions below are the specification: the CPU path and the
reference the card's kernels are held to (integer results, so exactly
equal).  The kernels are latency bound: a chain of dependent psi loads per
query, one thread per (query, bound); see the source for the design.
"""

from __future__ import annotations

import torch

from seal_tpu.index.fm_index import SHIFT

MODES = ("backward_step", "contains")


def symbol_bounds(index, c, pos):
    """(blo, bhi, dlo, dhi): psi-block and directory-tightened search bounds.

    ``c`` holds shifted symbol ids (in range); ``pos`` broadcasts against
    it.  ``sym_dir[c] = (C[c], C[c+1], head_id, 0)``; a head symbol's
    ``head_pair`` row pins the search to one ``2^dir_shift`` position block.
    """
    d = index.sym_dir[c.long()]
    blo, bhi, hid = d[..., 0], d[..., 1], d[..., 2]
    shape = torch.broadcast_shapes(pos.shape, blo.shape)
    blo_b = blo.expand(shape)
    bhi_b = bhi.expand(shape)
    if index.head_pair is None:
        return blo, bhi, blo_b, bhi_b
    hb = hid.expand(shape)
    blk = pos.expand(shape).clamp(0, index.n_rows) >> index.dir_shift
    nb1 = (index.n_rows >> index.dir_shift) + 1
    pr = index.head_pair[(hb.clamp(min=0).long() * nb1 + blk.long())]
    is_head = hb >= 0
    dlo = torch.where(is_head, blo_b + pr[..., 0], blo_b)
    dhi = torch.where(is_head, blo_b + pr[..., 1], bhi_b)
    return blo, bhi, dlo, dhi


def searchsorted_psi(index, lo, hi, pos):
    """Smallest i in [lo, hi] with psi[i] >= pos (psi[lo:hi) increasing).

    ``index.search_iters`` halvings bound every span the directory leaves.
    """
    lo = lo.long()
    hi = hi.long()
    pos = pos.expand(lo.shape)
    last = index.n_rows - 1
    for _ in range(index.search_iters):
        mid = (lo + hi) >> 1
        active = lo < hi
        go_right = index.psi[mid.clamp(max=last)] < pos
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo.to(torch.int32)


def backward_step_plain(index, token, lo, hi):
    c = token + SHIFT
    valid = (c >= 1) & (c < index.sigma)
    safe_c = torch.where(valid, c, 0)
    pos = torch.stack([lo, hi], 0)
    _, _, dlo, dhi = symbol_bounds(index, safe_c, pos)
    row = searchsorted_psi(index, dlo, dhi, pos)
    new_lo = torch.where(valid, row[0], 0)
    new_hi = torch.where(valid, row[1], 0)
    return new_lo, torch.maximum(new_lo, new_hi)


def contains_plain(index, tokens, lo, hi):
    c = tokens + SHIFT
    valid = (c >= 1) & (c < index.sigma)
    safe_c = torch.where(valid, c, 0)
    pos = lo[..., None].expand(safe_c.shape)
    _, bhi, dlo, dhi = symbol_bounds(index, safe_c, pos)
    row = searchsorted_psi(index, dlo, dhi, pos)
    first = index.psi[row.clamp(max=index.n_rows - 1).long()]
    return valid & (row < bhi) & (first < hi[..., None])


def sequences_plain(index, tokens, lengths):
    """The JAX scan: one backward step per position from the full range;
    positions at or past a sequence's length keep its range."""
    lo, hi = index.full_range(tokens.shape[:-1])
    for t in range(tokens.shape[-1]):
        new_lo, new_hi = backward_step_plain(index, tokens[..., t], lo, hi)
        keep = t < lengths
        lo = torch.where(keep, new_lo, lo)
        hi = torch.where(keep, new_hi, hi)
    return lo, hi


def fm_sequences(index, tokens, lengths):
    """Row ranges of padded token sequences: tokens int32 [..., L]
    (unshifted), lengths int32 [...]; returns int32 (lo, hi) [...].

    CPU tensors run the plain version; CUDA tensors launch kernel 5.
    """
    tokens = torch.as_tensor(tokens, dtype=torch.int32, device=index.device)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=index.device)
    if tokens.shape[:-1] != lengths.shape:
        raise ValueError(f"fm_sequences: tokens {tuple(tokens.shape)} vs lengths "
                         f"{tuple(lengths.shape)}")
    if not tokens.is_cuda:
        return sequences_plain(index, tokens, lengths)
    from seal_tpu_torch.kernels import build

    tokens, lengths = tokens.contiguous(), lengths.contiguous()
    out_lo = torch.empty_like(lengths)
    out_hi = torch.empty_like(lengths)
    rc = build.lib().seal_fm_sequences(
        *_index_args(index), tokens.data_ptr(), lengths.data_ptr(), out_lo.data_ptr(),
        out_hi.data_ptr(), lengths.numel(), tokens.shape[-1], build.stream_ptr(tokens),
    )
    build.check(rc, "fm_sequences")
    fm_sequences.launches += 1
    return out_lo, out_hi


fm_sequences.launches = 0


def _index_args(index):
    return (
        index.psi.data_ptr(),
        index.sym_dir.data_ptr(),
        index.head_pair.data_ptr() if index.head_pair is not None else None,
        index.n_rows,
        index.sigma,
        index.dir_shift,
    )


def fm_search(index, mode: str, tokens, lo, hi):
    """Rank search in one of two modes.

    * ``"backward_step"``: tokens, lo, hi broadcast to one shape; returns
      the (new_lo, new_hi) int32 ranges after appending each token.
    * ``"contains"``: tokens [..., M], lo/hi [...]; returns bool [..., M],
      whether each token continues its range.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    if mode not in MODES:
        raise ValueError(f"unknown fm_search mode {mode!r}")
    tokens = torch.as_tensor(tokens, dtype=torch.int32, device=index.device)
    lo = torch.as_tensor(lo, dtype=torch.int32, device=index.device)
    hi = torch.as_tensor(hi, dtype=torch.int32, device=index.device)
    if mode == "backward_step":
        tokens, lo, hi = torch.broadcast_tensors(tokens, lo, hi)
    if not tokens.is_cuda:
        if mode == "backward_step":
            return backward_step_plain(index, tokens, lo, hi)
        return contains_plain(index, tokens, lo, hi)
    return _launch(index, mode, tokens, lo, hi)


fm_search.launches = 0


def _launch(index, mode, tokens, lo, hi):
    from seal_tpu_torch.kernels import build

    so = build.lib()
    common = _index_args(index)
    stream = build.stream_ptr(tokens)
    if mode == "backward_step":
        tokens, lo, hi = (t.contiguous() for t in (tokens, lo, hi))
        out_lo = torch.empty_like(tokens)
        out_hi = torch.empty_like(tokens)
        rc = so.seal_fm_backward_step(
            *common, tokens.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            out_lo.data_ptr(), out_hi.data_ptr(), tokens.numel(), stream,
        )
        build.check(rc, "fm_search(backward_step)")
        fm_search.launches += 1
        return out_lo, out_hi
    m = tokens.shape[-1]
    if tokens.shape[:-1] != lo.shape or lo.shape != hi.shape:
        raise ValueError(f"contains: tokens {tuple(tokens.shape)} vs ranges {tuple(lo.shape)}")
    tokens, lo, hi = (t.contiguous() for t in (tokens, lo, hi))
    out = torch.empty(tokens.shape, dtype=torch.bool, device=tokens.device)
    rc = so.seal_fm_contains(
        *common, tokens.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        out.data_ptr(), lo.numel(), m, stream,
    )
    build.check(rc, "fm_search(contains)")
    fm_search.launches += 1
    return out
