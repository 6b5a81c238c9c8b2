"""Kernel 19 wrappers: exact row top-k at large k, and the k-th value of each
row, by radix select (``csrc/row_select.cu``).

Replaces, in ``seal_tpu/decoding/constrained.py``, the top-``top_m`` of
free generation (``_exact_topk`` :395 via ``_candidates_general``
:329-336), the speculative mode's ``lax.approx_max_k`` (:348: an exact
top-k meets its recall target) and the top-k warper's k-th value
(``_apply_topk_warper`` :289).  The order is ``lax.top_k``'s, as kernel 3's
(``kernels/row_topk.py``): the plain versions are kernel 3's plain version,
and the kernel equals them exactly (values bit for bit, indices equal).
The call sites of kernel 3 keep it.
"""

from __future__ import annotations

import torch

from seal_tpu_torch.kernels.row_topk import row_topk_plain


def row_select_plain(x, k: int):
    return row_topk_plain(x, k)


def row_kth_plain(x, k: int):
    return row_topk_plain(x, k)[0][..., k - 1]


def _launch(x, k: int, kth_only: bool, name: str):
    from seal_tpu_torch.kernels import build

    if x.dtype != torch.float32:
        raise ValueError(f"{name}: f32 input required, got {x.dtype}")
    n = x.shape[-1]
    if not kth_only and k > build.lib().seal_row_select_max_k():
        raise ValueError(f"{name}: k={k} exceeds the shared-memory sort buffer")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, n).contiguous()
    rows = x2.shape[0]
    dev = x.device
    vals = idx = kth = None
    if kth_only:
        kth = torch.empty((rows,), dtype=torch.float32, device=dev)
    else:
        vals = torch.empty((rows, k), dtype=torch.float32, device=dev)
        idx = torch.empty((rows, k), dtype=torch.int64, device=dev)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    rc = build.lib().seal_row_select(x2.data_ptr(), rows, n, k, int(kth_only), ptr(vals),
                                     ptr(idx), ptr(kth), build.stream_ptr(x))
    build.check(rc, name)
    if kth_only:
        return kth.reshape(lead)
    return vals.reshape(*lead, k), idx.reshape(*lead, k)


def _check_k(x, k: int, name: str):
    if not 0 < k <= x.shape[-1]:
        raise ValueError(f"{name}: k={k} for rows of width {x.shape[-1]}")


def row_select(x, k: int):
    """Top ``k`` of each row of f32 ``x`` [..., n]: (values, int64 indices),
    ordered like ``lax.top_k``.  ``x`` must be NaN-free.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    _check_k(x, k, "row_select")
    if not x.is_cuda:
        return row_select_plain(x, k)
    out = _launch(x, k, False, "row_select")
    row_select.launches += 1
    return out


row_select.launches = 0


def row_kth(x, k: int):
    """The ``k``-th largest value of each row of f32 ``x`` [..., n] in f32's
    total order: ``lax.top_k(x, k)[0][..., k - 1]``, bit for bit.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    _check_k(x, k, "row_kth")
    if not x.is_cuda:
        return row_kth_plain(x, k)
    out = _launch(x, k, True, "row_kth")
    row_kth.launches += 1
    return out


row_kth.launches = 0
