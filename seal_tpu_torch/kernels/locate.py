"""Kernel 18 wrappers: the suffix-array gather of index rows and the document
search of corpus positions (``csrc/locate.cu``), with their plain versions.

Replaces ``seal_tpu/ops/fm_ops.py:locate_rows`` (:322) and
``doc_index_of`` (:330).  One launch per call; integer outputs, so the
kernel equals the plain version exactly.  The plain search is
``torch.searchsorted(..., right=True) - 1``, also the search mode's
library yardstick.  The search is two-level (``csrc/locate.cu``): a
sample of every 8th beginning (a wider stride past 32k documents) in shared
memory, then one block of at most 32 beginnings.
"""

from __future__ import annotations

import torch

_FN = _STREAM = None  # the C entry point and build.stream_ptr, looked up once


def locate_rows_plain(sa, rows):
    ok = (rows >= 0) & (rows < sa.shape[0])
    return torch.where(ok, sa[torch.where(ok, rows, 0).long()], -1).to(torch.int32)


def doc_index_of_plain(beginnings, positions):
    return torch.searchsorted(beginnings, positions, right=True, out_int32=True) - 1


def _launch(table, x, search: int, name: str):
    """One launch; the host path is kept short (kernel 18 runs near the
    launch floor): the C function is looked up once, and a contiguous
    tensor is not copied."""
    global _FN, _STREAM
    if x.dtype is not torch.int32 or table.dtype is not torch.int32 or not table.is_cuda:
        raise ValueError(f"{name}: CUDA int32 tensors required, got {table.dtype} / {x.dtype}")
    if _FN is None:
        from seal_tpu_torch.kernels import build

        _FN, _STREAM = build.lib().seal_locate, build.stream_ptr
    if not table.is_contiguous():
        table = table.contiguous()
    if not x.is_contiguous():
        x = x.contiguous()
    out = torch.empty_like(x)
    rc = _FN(table.data_ptr(), table.shape[0], x.data_ptr(), x.numel(), search, out.data_ptr(),
             _STREAM(x))
    if rc:
        raise RuntimeError(f"{name}: CUDA error {rc}")
    return out


def locate_rows(sa, rows):
    """``sa[row]`` for int32 ``rows`` [...] in [0, len(sa)), else -1 (int32).

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    if not rows.is_cuda:
        return locate_rows_plain(sa, rows)
    out = _launch(sa, rows, 0, "locate_rows")
    locate_rows.launches += 1
    return out


locate_rows.launches = 0


def doc_index_of(beginnings, positions):
    """The document holding each int32 corpus position [...]: the number of
    ``beginnings`` (ascending, int32 [n_docs + 1]) at or below it, minus one.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    if not positions.is_cuda:
        return doc_index_of_plain(beginnings, positions)
    out = _launch(beginnings, positions, 1, "doc_index_of")
    doc_index_of.launches += 1
    return out


doc_index_of.launches = 0
