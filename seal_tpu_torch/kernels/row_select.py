"""Kernel 19 wrapper: the k-th value of each row, as the k-th-value mode of
kernel 3's split-row radix select (``csrc/row_select.cu`` over
``csrc/radix_topk.cuh``); and the top-k warper's masked log-softmax in one
launch of the same select (:func:`topk_log_softmax`).

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
from seal_tpu_torch.kernels.triton_logsoftmax import log_softmax_ban_plain

_FNS = None  # (seal_row_kth, seal_topk_log_softmax, build.stream_ptr), looked up once


def _lib():
    global _FNS
    if _FNS is None:
        from seal_tpu_torch.kernels import build

        so = build.lib()
        _FNS = so.seal_row_kth, so.seal_topk_log_softmax, build.stream_ptr
    return _FNS


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
    if x.dtype is not torch.float32:
        raise ValueError(f"row_kth: f32 input required, got {x.dtype}")
    if layout is not None and layout.sort != "none":
        raise ValueError("row_kth: the layout must be a k-th-value plan (plan(..., kth=True))")
    fn, _, stream = _lib()
    x2 = x if x.dim() == 2 else x.reshape(-1, n)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    rows = x2.shape[0]
    p = plan(rows, n, k) if layout is None else layout
    kth = torch.empty((rows,), dtype=torch.float32, device=x.device)
    rc = fn(x2.data_ptr(), rows, n, k, *p.launch, kth.data_ptr(), stream(x))
    if rc:
        raise RuntimeError(f"row_kth: CUDA error {rc}")
    row_kth.launches += 1
    return kth.reshape(x.shape[:-1])


row_kth.launches = 0


def topk_log_softmax_plain(logits, k: int, ban_col: int, fill: float):
    x = logits.float()
    return log_softmax_ban_plain(x, ban_col, fill, row_kth_plain(x, k))


def topk_log_softmax(logits, k: int, ban_col: int, fill: float,
                     layout: row_topk.Plan | None = None):
    """The top-k warper and the f32 log-softmax with the min-length ban, as
    the JAX step applies them (``_apply_topk_warper`` :289-294,
    ``_log_softmax`` :276, ``_apply_min_length`` :297): the logits of a row
    below its ``k``-th value become ``fill`` (a value equal to it stays),
    then the log-softmax over the row, then column ``ban_col`` (-1: none)
    becomes ``fill``.  ``logits`` f32 [rows, n], NaN-free.

    CPU tensors run the plain version; CUDA tensors launch one call of
    kernel 3's select in its warper mode (``csrc/row_select.cu``), laid out
    by :func:`plan` as kernel 19 is, or by ``layout`` (a k-th-value plan
    with a forced split or route: tests and measurements).  Every width and
    k that kernel 19 takes: a row that does not fit one CTA is split over a
    cluster, and past the cluster's shared memory a slice's tail is
    streamed (and read again for the output).  Values agree with the plain
    version to the f32 rounding of the sum of exps, taken in another order;
    the masked set is exact.
    """
    if logits.dim() != 2:
        raise ValueError(f"topk_log_softmax: 2-D logits required, got {tuple(logits.shape)}")
    rows, n = logits.shape
    if not 0 < k <= n:
        raise ValueError(f"topk_log_softmax: k={k} for rows of width {n}")
    if not -1 <= ban_col < n:
        raise ValueError(f"topk_log_softmax: ban column {ban_col} for rows of width {n}")
    if not logits.is_cuda:
        return topk_log_softmax_plain(logits, k, ban_col, fill)
    if logits.dtype is not torch.float32:
        raise ValueError(f"topk_log_softmax: f32 input required, got {logits.dtype}")
    if layout is not None and layout.sort != "none":
        raise ValueError("topk_log_softmax: the layout must be a k-th-value plan "
                         "(plan(..., kth=True))")
    x = logits.contiguous()
    out = torch.empty((rows, n), dtype=torch.float32, device=x.device)
    if rows == 0:
        return out
    _, fn, stream = _lib()
    p = plan(rows, n, k) if layout is None else layout
    rc = fn(x.data_ptr(), rows, n, k, *p.launch, ban_col, fill, out.data_ptr(), stream(x))
    if rc:
        raise RuntimeError(f"topk_log_softmax: CUDA error {rc}")
    topk_log_softmax.launches += 1
    return out


topk_log_softmax.launches = 0
