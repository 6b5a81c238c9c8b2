"""Kernel 3 wrapper: exact row top-k, value descending and index ascending
on ties (``csrc/row_topk.cu``).

Replaces ``seal_tpu/decoding/constrained.py:_exact_topk`` (:395) and the
``lax.top_k`` calls of the decode path (``_top_idx`` :983, the proposal
loop :736, step-0 selection).  ``torch.topk`` leaves its tie order
unspecified, so it cannot stand in.  The order is lax.top_k's: f32's total
order (so +0.0 ranks above -0.0), ties to the lower index.  The plain
version is a stable descending sort of the order's integer key; the kernel
equals it exactly.  Bound by k block-wide reductions per row; see the
source.
"""

from __future__ import annotations

import torch


def order_key(x):
    """int32 keys whose signed order is f32's total order (NaN-free x)."""
    i = x.contiguous().view(torch.int32)
    return torch.where(i < 0, i ^ 0x7FFFFFFF, i)


def row_topk_plain(x, k: int):
    idx = torch.sort(order_key(x), dim=-1, descending=True, stable=True)[1][..., :k]
    return torch.gather(x, -1, idx), idx


def row_topk(x, k: int):
    """Top ``k`` of each row of f32 ``x`` [..., n]: (values, int64 indices),
    ordered like ``lax.top_k``.  ``x`` must be NaN-free.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    n = x.shape[-1]
    if not 0 < k <= n:
        raise ValueError(f"row_topk: k={k} for rows of width {n}")
    if not x.is_cuda:
        return row_topk_plain(x, k)
    from seal_tpu_torch.kernels import build

    if x.dtype != torch.float32:
        raise ValueError(f"row_topk: f32 input required, got {x.dtype}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, n).contiguous()
    rows = x2.shape[0]
    vals = torch.empty((rows, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((rows, k), dtype=torch.int64, device=x.device)
    rc = build.lib().seal_row_topk(
        x2.data_ptr(), rows, n, k, vals.data_ptr(), idx.data_ptr(), build.stream_ptr(x)
    )
    build.check(rc, "row_topk")
    row_topk.launches += 1
    return vals.reshape(*lead, k), idx.reshape(*lead, k)


row_topk.launches = 0
