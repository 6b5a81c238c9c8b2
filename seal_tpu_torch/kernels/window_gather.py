"""Kernel 2 wrapper: fused BWT window gather + log-prob gather
(``csrc/window_gather.cu``).

Replaces ``seal_tpu/ops/fm_ops.py:bwt_at`` (:205) with
``seal_tpu/ops/_generic.py:window_continuations`` (:41) and the
``take_along_axis`` of the log-probs after them
(``seal_tpu/decoding/constrained.py:385-387`` and ``:632-634``).  Integer
outputs and gathered floats, so the kernel equals the plain version
exactly.  Latency bound (two dependent scattered loads per slot); one
thread per slot.

``window_gather_sharded`` is its shard mode over a ``ShardedTorchIndex``
(``seal_tpu_torch/parallel/sharded_index.py``), for
``seal_tpu/parallel/sharded_decode.py:ShardedIndexOps.window`` (:100-118):
shard s fills union slots [s * w, (s + 1) * w) of each range from its own
range, so the union is S * w wide; one launch for every shard.
"""

from __future__ import annotations

import torch

from seal_tpu_torch.index.fm_index import SHIFT


def window_rows(lo, hi, w: int):
    """Rows sampled from [lo, hi): exhaustive when it has <= w rows, else
    strided.  Returns (rows int64 [..., w], in_range bool [..., w])."""
    size = (hi - lo).clamp(min=0)
    stride = (size // w).clamp(min=1)[..., None]
    offs = torch.arange(w, dtype=torch.int32, device=lo.device)
    rows = lo[..., None] + offs * stride
    return rows, rows < hi[..., None]


def window_gather_plain(index, lo, hi, w: int, lp, fill: int):
    rows, ok = window_rows(lo, hi, w)
    sym = index.bwt[torch.where(ok, rows, 0).long()] - SHIFT
    ok = ok & (sym >= 0) & (sym < index.vocab)
    tok = torch.where(ok, sym, fill).to(torch.int32)
    R = lo.numel()
    lp_out = torch.gather(lp, 1, tok.reshape(R, w).long()).reshape(tok.shape)
    return tok, ok, lp_out


def window_gather(index, lo, hi, w: int, lp, fill: int):
    """Window continuations of ranges [lo, hi) and their log-probs.

    lo/hi: int32 [...] with ``lo.numel()`` == lp rows; lp: f32 [R, V] (row r
    scores range r in flattened order).  Returns (tok int32 [..., w],
    valid bool [..., w], lp f32 [..., w]); invalid slots (past the range,
    sentinel, out of vocab) carry token ``fill`` and its log-prob.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    if lp.dim() != 2 or lp.shape[0] != lo.numel():
        raise ValueError(f"window_gather: lp {tuple(lp.shape)} vs ranges {tuple(lo.shape)}")
    if not lp.is_cuda:
        return window_gather_plain(index, lo, hi, w, lp, fill)
    from seal_tpu_torch.kernels import build

    if lp.dtype != torch.float32 or lp.stride(1) != 1:
        raise ValueError("window_gather: lp must be f32 with unit column stride")
    lo_c = lo.to(torch.int32).contiguous()
    hi_c = hi.to(torch.int32).contiguous()
    shape = tuple(lo.shape) + (w,)
    tok = torch.empty(shape, dtype=torch.int32, device=lp.device)
    valid = torch.empty(shape, dtype=torch.bool, device=lp.device)
    lp_out = torch.empty(shape, dtype=torch.float32, device=lp.device)
    rc = build.lib().seal_window_gather(
        index.bwt.data_ptr(), lp.data_ptr(), lp.stride(0), lo_c.data_ptr(),
        hi_c.data_ptr(), lo_c.numel(), w, index.vocab, fill, tok.data_ptr(),
        valid.data_ptr(), lp_out.data_ptr(), build.stream_ptr(lp),
    )
    build.check(rc, "window_gather")
    window_gather.launches += 1
    return tok, valid, lp_out


window_gather.launches = 0


def window_gather_sharded_plain(si, lo, hi, w: int, lp, fill: int):
    outs = [window_gather_plain(si.block_view(s), lo[s], hi[s], w, lp, fill)
            for s in range(si.n_shards)]
    return tuple(torch.cat(parts, -1) for parts in zip(*outs))


def window_gather_sharded(si, lo, hi, w: int, lp, fill: int):
    """Kernel 2's shard mode: each shard's window of its own ranges lo/hi
    [S, ...] in its slice [s * w, (s + 1) * w) of the union, with the
    log-probs.  lp: f32 [R, V], R = ``lo[0].numel()``.  Returns (tok int32,
    valid bool, lp f32), each [..., S * w]; invalid slots carry ``fill``.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    if lo.dim() == 0 or lo.shape[0] != si.n_shards or lo.shape != hi.shape:
        raise ValueError(f"window_gather_sharded: ranges {tuple(lo.shape)} / {tuple(hi.shape)} "
                         f"for {si.n_shards} shards")
    if lp.dim() != 2 or lp.shape[0] != lo[0].numel():
        raise ValueError(f"window_gather_sharded: lp {tuple(lp.shape)} vs ranges "
                         f"{tuple(lo.shape)}")
    if not lp.is_cuda:
        return window_gather_sharded_plain(si, lo, hi, w, lp, fill)
    from seal_tpu_torch.kernels import build

    if lp.dtype != torch.float32 or lp.stride(1) != 1:
        raise ValueError("window_gather_sharded: lp must be f32 with unit column stride")
    lo_c = lo.to(torch.int32).contiguous()
    hi_c = hi.to(torch.int32).contiguous()
    shape = tuple(lo.shape[1:]) + (si.n_shards * w,)
    tok = torch.empty(shape, dtype=torch.int32, device=lp.device)
    valid = torch.empty(shape, dtype=torch.bool, device=lp.device)
    lp_out = torch.empty(shape, dtype=torch.float32, device=lp.device)
    rc = build.lib().seal_window_gather_sharded(
        si.bwt.data_ptr(), si.n_max, si.n_shards, lp.data_ptr(), lp.stride(0), lo_c.data_ptr(),
        hi_c.data_ptr(), lo_c[0].numel(), w, si.vocab, fill, tok.data_ptr(), valid.data_ptr(),
        lp_out.data_ptr(), build.stream_ptr(lp),
    )
    build.check(rc, "window_gather_sharded")
    window_gather_sharded.launches += 1
    return tok, valid, lp_out


window_gather_sharded.launches = 0
