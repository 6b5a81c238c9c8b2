"""Kernel 2 wrapper: fused BWT window gather + log-prob gather
(``csrc/window_gather.cu``).

Replaces ``seal_tpu/ops/fm_ops.py:bwt_at`` (:205) with
``seal_tpu/ops/_generic.py:window_continuations`` (:41) and the
``take_along_axis`` of the log-probs after them
(``seal_tpu/decoding/constrained.py:385-387`` and ``:632-634``), in three
modes of one kernel:

* :func:`window_gather`: a range's window (the decode step's window slots);
* :func:`slab_gather`: a proposal round's slab, the rows [lo + rows_prev,
  + width) of the range (``merge_round``'s bounds, :623-624, computed in
  the kernel), fill 0;
* :func:`window_slab`: the step's window and round 0's slab (rows_prev 0)
  in one launch; where the window is stride 1 and no wider than the slab,
  a window slot takes its slab slot's symbol and log-prob.

Integer outputs and gathered floats, so the kernel equals the plain version
exactly.  Latency and launch bound (two dependent scattered loads per
slot); a warp a range, see the source.  ``window_gather.launches`` counts
every launch, ``WINDOW_SLAB`` and ``SLAB`` the launches of those modes.

``window_gather_sharded``, ``window_slab_sharded`` and
``slab_gather_sharded`` are the shard mode over a ``ShardedTorchIndex``
(``seal_tpu_torch/parallel/sharded_index.py``), for
``seal_tpu/parallel/sharded_decode.py:ShardedIndexOps.window`` (:100-118):
shard s fills union slots [s * w, (s + 1) * w) of each range from its own
range, so the union is S * w wide; one launch for every shard.  Their
launches count on ``window_gather_sharded.launches`` and on
``WINDOW_SLAB_SHARDED`` / ``SLAB_SHARDED``.
"""

from __future__ import annotations

import torch

from seal_tpu_torch.index.fm_index import SHIFT
from seal_tpu_torch.kernels import Launches

WINDOW_SLAB = Launches()  # window_gather launches in the window + slab mode
SLAB = Launches()  # window_gather launches in the slab mode
WINDOW_SLAB_SHARDED = Launches()  # the same modes' launches in the shard mode
SLAB_SHARDED = Launches()
_FN = {}  # kernel 2's C entry point, looked up once


def window_rows(lo, hi, w: int):
    """Rows sampled from [lo, hi): exhaustive when it has <= w rows, else
    strided.  Returns (rows int64 [..., w], in_range bool [..., w])."""
    size = (hi - lo).clamp(min=0)
    stride = (size // w).clamp(min=1)[..., None]
    offs = torch.arange(w, dtype=torch.int32, device=lo.device)
    rows = lo[..., None] + offs * stride
    return rows, rows < hi[..., None]


def slab_bounds(lo, hi, rows_prev: int, width: int):
    """A proposal round's slab of [lo, hi): rows [lo + rows_prev, + width)
    cut at hi (``constrained.py:623-624``)."""
    s_lo = torch.minimum(lo + rows_prev, hi)
    return s_lo, torch.minimum(s_lo + width, hi)


def window_gather_plain(index, lo, hi, w: int, lp, fill: int):
    rows, ok = window_rows(lo, hi, w)
    sym = index.bwt[torch.where(ok, rows, 0).long()] - SHIFT
    ok = ok & (sym >= 0) & (sym < index.vocab)
    tok = torch.where(ok, sym, fill).to(torch.int32)
    R = lo.numel()
    lp_out = torch.gather(lp, 1, tok.reshape(R, w).long()).reshape(tok.shape)
    return tok, ok, lp_out


def slab_gather_plain(index, lo, hi, rows_prev: int, width: int, lp):
    return window_gather_plain(index, *slab_bounds(lo, hi, rows_prev, width), width, lp, 0)


def window_slab_plain(index, lo, hi, w: int, width: int, lp, fill: int):
    return (*window_gather_plain(index, lo, hi, w, lp, fill),
            *slab_gather_plain(index, lo, hi, 0, width, lp))


def _i32(x):
    if x.dtype != torch.int32:
        x = x.to(torch.int32)
    return x if x.is_contiguous() else x.contiguous()


def _check(lo, hi, lp, n: int, name: str) -> None:
    if lo.shape != hi.shape or lp.dim() != 2 or lp.shape[0] != n:
        raise ValueError(f"{name}: lp {tuple(lp.shape)} vs ranges {tuple(lo.shape)} / "
                         f"{tuple(hi.shape)}")


def _single(index, lo):
    """One index's arguments of ``_launch``: its BWT, no shard stride."""
    return index.bwt, 0, 1, index.vocab, lo.shape


def _stacked(si, lo):
    """A sharded index's: the stacked BWT [S, n_max], ranges [S, ...]."""
    return si.bwt, si.n_max, si.n_shards, si.vocab, lo.shape[1:]


def _launch(bwt, n_max: int, n_shards: int, vocab: int, lead, lo, hi, w: int, width: int,
            rows_prev: int, lp, fill: int, name: str):
    """One launch of the kernel; returns the window's and the slab's (tok,
    valid, lp), each ``lead`` + [n_shards * width], or None for a width of
    0."""
    if lp.dtype != torch.float32 or lp.stride(1) != 1:
        raise ValueError(f"{name}: lp must be f32 with unit column stride")
    if not _FN:
        from seal_tpu_torch.kernels import build

        _FN.update(fn=build.lib().seal_window_slab, stream=build.stream_ptr)
    lo, hi = _i32(lo), _i32(hi)
    outs = []
    for k in (w, width):
        shape = (*lead, n_shards * k)
        outs.append((torch.empty(shape, dtype=torch.int32, device=lp.device),
                     torch.empty(shape, dtype=torch.bool, device=lp.device),
                     torch.empty(shape, dtype=torch.float32, device=lp.device)) if k else None)
    ptrs = [t.data_ptr() if t is not None else None for o in outs for t in (o or (None,) * 3)]
    rc = _FN["fn"](bwt.data_ptr(), n_max, n_shards, lp.data_ptr(), lp.stride(0), lo.data_ptr(),
                   hi.data_ptr(), lp.shape[0], w, width, rows_prev, vocab, fill,
                   *ptrs, _FN["stream"](lp))
    if rc:
        raise RuntimeError(f"{name}: CUDA error {rc}")
    return outs


def window_gather(index, lo, hi, w: int, lp, fill: int):
    """Window continuations of ranges [lo, hi) and their log-probs.

    lo/hi: int32 [...] with ``lo.numel()`` == lp rows; lp: f32 [R, V] (row r
    scores range r in flattened order).  Returns (tok int32 [..., w],
    valid bool [..., w], lp f32 [..., w]); invalid slots (past the range,
    sentinel, out of vocab) carry token ``fill`` and its log-prob.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    _check(lo, hi, lp, lo.numel(), "window_gather")
    if not lp.is_cuda:
        return window_gather_plain(index, lo, hi, w, lp, fill)
    win, _ = _launch(*_single(index, lo), lo, hi, w, 0, 0, lp, fill, "window_gather")
    window_gather.launches += 1
    return win


window_gather.launches = 0


def slab_gather(index, lo, hi, rows_prev: int, width: int, lp):
    """A proposal round's slab: the rows [lo + rows_prev, + width) of each
    range [lo, hi), cut at hi, as ``window_gather``'s (tok, valid, lp) [...,
    width] (stride 1; invalid slots carry token 0, ``merge_round``'s fill).

    CPU tensors run the plain version; CUDA tensors launch the kernel once,
    which computes the bounds itself.
    """
    _check(lo, hi, lp, lo.numel(), "slab_gather")
    if not lp.is_cuda:
        return slab_gather_plain(index, lo, hi, rows_prev, width, lp)
    _, slab = _launch(*_single(index, lo), lo, hi, 0, width, rows_prev, lp, 0, "slab_gather")
    window_gather.launches += 1
    SLAB.launches += 1
    return slab


def window_slab(index, lo, hi, w: int, width: int, lp, fill: int):
    """A decode step's window (``window_gather(..., w, lp, fill)``) and its
    proposal round 0's slab (``slab_gather(..., 0, width, lp)``): six
    tensors, (tok, valid, lp) [..., w] then [..., width].

    CPU tensors run the plain version (the two calls); CUDA tensors launch
    the kernel once.
    """
    _check(lo, hi, lp, lo.numel(), "window_slab")
    if not lp.is_cuda:
        return window_slab_plain(index, lo, hi, w, width, lp, fill)
    win, slab = _launch(*_single(index, lo), lo, hi, w, width, 0, lp, fill, "window_slab")
    window_gather.launches += 1
    WINDOW_SLAB.launches += 1
    return (*win, *slab)


# ------------------------------------------------------------ shard mode


def _sharded_plain(fn, si, lo, hi, *args):
    outs = [fn(si.block_view(s), lo[s], hi[s], *args) for s in range(si.n_shards)]
    return tuple(torch.cat(parts, -1) for parts in zip(*outs))


def window_gather_sharded_plain(si, lo, hi, w: int, lp, fill: int):
    return _sharded_plain(window_gather_plain, si, lo, hi, w, lp, fill)


def slab_gather_sharded_plain(si, lo, hi, rows_prev: int, width: int, lp):
    return _sharded_plain(slab_gather_plain, si, lo, hi, rows_prev, width, lp)


def window_slab_sharded_plain(si, lo, hi, w: int, width: int, lp, fill: int):
    return (*window_gather_sharded_plain(si, lo, hi, w, lp, fill),
            *slab_gather_sharded_plain(si, lo, hi, 0, width, lp))


def _check_sharded(si, lo, hi, lp, name: str) -> None:
    if lo.dim() == 0 or lo.shape[0] != si.n_shards:
        raise ValueError(f"{name}: ranges {tuple(lo.shape)} for {si.n_shards} shards")
    _check(lo, hi, lp, lo[0].numel(), name)


def window_gather_sharded(si, lo, hi, w: int, lp, fill: int):
    """Kernel 2's shard mode: each shard's window of its own ranges lo/hi
    [S, ...] in its slice [s * w, (s + 1) * w) of the union, with the
    log-probs.  lp: f32 [R, V], R = ``lo[0].numel()``.  Returns (tok int32,
    valid bool, lp f32), each [..., S * w]; invalid slots carry ``fill``.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    _check_sharded(si, lo, hi, lp, "window_gather_sharded")
    if not lp.is_cuda:
        return window_gather_sharded_plain(si, lo, hi, w, lp, fill)
    win, _ = _launch(*_stacked(si, lo), lo, hi, w, 0, 0, lp, fill, "window_gather_sharded")
    window_gather_sharded.launches += 1
    return win


window_gather_sharded.launches = 0


def slab_gather_sharded(si, lo, hi, rows_prev: int, width: int, lp):
    """The slab mode over every shard: shard s's slab of its own range in
    union slots [s * width, (s + 1) * width); (tok, valid, lp) [..., S *
    width].  CPU tensors run the plain version; CUDA tensors launch the
    kernel once."""
    _check_sharded(si, lo, hi, lp, "slab_gather_sharded")
    if not lp.is_cuda:
        return slab_gather_sharded_plain(si, lo, hi, rows_prev, width, lp)
    _, slab = _launch(*_stacked(si, lo), lo, hi, 0, width, rows_prev, lp, 0,
                      "slab_gather_sharded")
    window_gather_sharded.launches += 1
    SLAB_SHARDED.launches += 1
    return slab


def window_slab_sharded(si, lo, hi, w: int, width: int, lp, fill: int):
    """The window + slab mode over every shard: the union window [..., S *
    w] and the union of round 0's slabs [..., S * width], six tensors as
    ``window_slab``.  CPU tensors run the plain version; CUDA tensors
    launch the kernel once."""
    _check_sharded(si, lo, hi, lp, "window_slab_sharded")
    if not lp.is_cuda:
        return window_slab_sharded_plain(si, lo, hi, w, width, lp, fill)
    win, slab = _launch(*_stacked(si, lo), lo, hi, w, width, 0, lp, fill, "window_slab_sharded")
    window_gather_sharded.launches += 1
    WINDOW_SLAB_SHARDED.launches += 1
    return (*win, *slab)
