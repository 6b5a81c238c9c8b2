"""Kernel 19 wrapper: the k-th value of each row, by radix select
(``csrc/row_select.cu``).

Replaces the top-k warper's k-th value in
``seal_tpu/decoding/constrained.py`` (``_apply_topk_warper`` :289,
``lax.top_k(logits, topk)[0][..., -1:]``).  The order is ``lax.top_k``'s,
as kernel 3's (``kernels/row_topk.py``): the plain version is kernel 3's
plain version, and the kernel equals it bit for bit.  The decode modes'
top-``top_m`` (free generation, the speculative round), which kernel 19
also served, is kernel 3's: it gives the same order and is faster there.
"""

from __future__ import annotations

import torch

from seal_tpu_torch.kernels.row_topk import row_topk_plain


def row_kth_plain(x, k: int):
    return row_topk_plain(x, k)[0][..., k - 1]


def row_kth(x, k: int):
    """The ``k``-th largest value of each row of f32 ``x`` [..., n] in f32's
    total order: ``lax.top_k(x, k)[0][..., k - 1]``, bit for bit.  ``x``
    must be NaN-free.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    if not 0 < k <= x.shape[-1]:
        raise ValueError(f"row_kth: k={k} for rows of width {x.shape[-1]}")
    if not x.is_cuda:
        return row_kth_plain(x, k)
    from seal_tpu_torch.kernels import build

    if x.dtype != torch.float32:
        raise ValueError(f"row_kth: f32 input required, got {x.dtype}")
    n = x.shape[-1]
    x2 = x.reshape(-1, n).contiguous()
    kth = torch.empty((x2.shape[0],), dtype=torch.float32, device=x.device)
    rc = build.lib().seal_row_kth(x2.data_ptr(), x2.shape[0], n, k, kth.data_ptr(),
                                  build.stream_ptr(x))
    build.check(rc, "row_kth")
    row_kth.launches += 1
    return kth.reshape(x.shape[:-1])


row_kth.launches = 0
