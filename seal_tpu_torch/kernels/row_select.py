"""Kernel 19 wrapper: the k-th value of each row, as the k-th-value mode of
kernel 3's split-row radix select (``csrc/row_select.cu`` over
``csrc/radix_topk.cuh``).

Replaces the top-k warper's k-th value in
``seal_tpu/decoding/constrained.py`` (``_apply_topk_warper`` :289,
``lax.top_k(logits, topk)[0][..., -1:]``).  The order is ``lax.top_k``'s,
as kernel 3's (``kernels/row_topk.py``): the plain version is kernel 3's
plain version, and the kernel equals it bit for bit.  A call is laid out by
:func:`plan`, kernel 3's plan in its k-th-value mode.
"""

from __future__ import annotations

import torch

from seal_tpu_torch.kernels import row_topk
from seal_tpu_torch.kernels.row_topk import row_topk_plain

_FN = _STREAM = None  # the C entry point and build.stream_ptr, looked up once


def plan(rows: int, width: int, k: int, splits: int | None = None) -> row_topk.Plan:
    """Kernel 19's launch: kernel 3's plan in its k-th-value mode (no sort
    buffer; a row split only where it does not fit one CTA's shared
    memory); ``splits`` forces the split (measurements)."""
    return row_topk.plan(rows, width, k, splits=splits, kth=True)


def row_kth_plain(x, k: int):
    return row_topk_plain(x, k)[0][..., k - 1]


def row_kth(x, k: int, layout: row_topk.Plan | None = None):
    """The ``k``-th largest value of each row of f32 ``x`` [..., n] in f32's
    total order: ``lax.top_k(x, k)[0][..., k - 1]``, bit for bit.  ``x``
    must be NaN-free.

    CPU tensors run the plain version; CUDA tensors launch the kernel, laid
    out by :func:`plan` or by ``layout`` (a k-th-value plan with a forced
    split or route: tests and measurements).
    """
    n = x.shape[-1]
    if not 0 < k <= n:
        raise ValueError(f"row_kth: k={k} for rows of width {n}")
    if not x.is_cuda:
        return row_kth_plain(x, k)
    global _FN, _STREAM
    if x.dtype is not torch.float32:
        raise ValueError(f"row_kth: f32 input required, got {x.dtype}")
    if layout is not None and layout.sort != "none":
        raise ValueError("row_kth: the layout must be a k-th-value plan (plan(..., kth=True))")
    if _FN is None:
        from seal_tpu_torch.kernels import build

        _FN, _STREAM = build.lib().seal_row_kth, build.stream_ptr
    x2 = x if x.dim() == 2 else x.reshape(-1, n)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    rows = x2.shape[0]
    p = plan(rows, n, k) if layout is None else layout
    kth = torch.empty((rows,), dtype=torch.float32, device=x.device)
    rc = _FN(x2.data_ptr(), rows, n, k, *p.launch, kth.data_ptr(), _STREAM(x))
    if rc:
        raise RuntimeError(f"row_kth: CUDA error {rc}")
    row_kth.launches += 1
    return kth.reshape(x.shape[:-1])


row_kth.launches = 0
