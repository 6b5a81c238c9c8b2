"""Kernel 11 wrapper: the beam reorder of the decoder's K/V cache
(``csrc/reorder_cache.cu``), with its plain version.

Replaces ``seal_tpu/models/bart.py:reorder_cache`` (:356-358).  One launch
copies every tensor's rows by ``index`` into a second, preallocated cache,
and only the first ``cols`` columns (the live slots [0, step]): the columns
past them were never written in either buffer, so the destination equals
the full gather bit for bit.  The kernel equals the plain version exactly.
"""

from __future__ import annotations

import ctypes

import torch


def reorder_cache_plain(src, index, cols: int, dst):
    idx = index.long()
    for s, d in zip(src, dst):
        d[:, :cols] = s[idx, :cols]
    return dst


def reorder_cache(src, index, cols: int, dst):
    """``dst[t][r, :cols] = src[t][index[r], :cols]`` for every tensor t.

    src/dst: lists of tensors [rows, max_len, ...] (src may have fewer rows
    than dst); index: int [dst rows] in [0, src rows).  Returns ``dst``.  CPU
    tensors run the plain version; CUDA tensors launch the kernel, which
    stops with a CUDA error on an index outside the source (the plain
    version's IndexError), as torch's own indexing does on the card.
    """
    if len(src) != len(dst) or not src:
        raise ValueError("reorder_cache: src and dst need the same non-zero number of tensors")
    if not index.is_cuda:
        return reorder_cache_plain(src, index, cols, dst)
    from seal_tpu_torch.kernels import build

    rows, src_rows = dst[0].shape[0], src[0].shape[0]
    row_shape = tuple(dst[0].shape[1:])
    if index.shape != (rows,) or not 0 < cols <= row_shape[0]:
        raise ValueError(f"reorder_cache: index {tuple(index.shape)}, cols {cols}, rows {rows}")
    if any(t.shape[0] != src_rows for t in src) or any(t.shape[0] != rows for t in dst):
        raise ValueError("reorder_cache: the sources, and the destinations, need one row count")
    row_elems = 1
    for n in row_shape:
        row_elems *= n
    esize = dst[0].element_size()
    row_bytes = row_elems * esize
    copy_bytes = cols * (row_elems // row_shape[0]) * esize
    for t in (*src, *dst):
        if (tuple(t.shape[1:]) != row_shape or t.dtype != dst[0].dtype or not t.is_cuda
                or t.stride(0) != row_elems or not t[0].is_contiguous()):
            raise ValueError("reorder_cache: every tensor must be [rows, *row_shape] contiguous")
        if t.data_ptr() % 16 or row_bytes % 16 or copy_bytes % 16:
            raise ValueError("reorder_cache: rows must be 16-byte aligned")
    idx = index.to(torch.int64).contiguous()
    table = (ctypes.c_ulonglong * (2 * len(src)))(
        *(t.data_ptr() for t in src), *(t.data_ptr() for t in dst)
    )
    rc = build.lib().seal_reorder_cache(
        ctypes.addressof(table), len(src), idx.data_ptr(), rows, src_rows, copy_bytes, row_bytes,
        build.stream_ptr(idx),
    )
    build.check(rc, "reorder_cache")
    reorder_cache.launches += 1
    return dst


reorder_cache.launches = 0
