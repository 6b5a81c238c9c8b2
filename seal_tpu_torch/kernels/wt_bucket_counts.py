"""Kernel 14 wrapper: exact per-bucket symbol counts of BWT[lo:hi) by
wavelet interval bisection (``csrc/wt_bucket_counts.cu``).

Replaces ``seal_tpu/ops/wt_ops.py:bucket_counts`` (:203), the
support-pruning input of the exact proposal loop's later rounds in the
wavelet layouts.  The range descends ``depth = min(2, digits)`` levels,
tracked through every prefix node, so bucket ``b`` counts the shifted
symbols whose top ``4 * depth`` bits are ``b``: 256 buckets of
``bucket_size_of`` symbols (16 buckets when ``digits`` is 1).  These are
not the Psi layout's buckets, so the decoder maps tokens to buckets with
the layout's own ``bucket_size_of``.  Integer counts, so the kernel equals
the plain version exactly.  One CTA per range; see the source.

:func:`wt_bucket_support` is the support mode the decoder calls: the 8
words of ``bucket_counts.pack_support`` (bit ``b`` set iff bucket ``b``'s
count is positive), a CTA of four warps a range descending only into the
non-empty children; the counts mode stays an entry point of
``ops.bucket_counts`` that no decode path launches.
"""

from __future__ import annotations

import torch

from seal_tpu_torch.index.wavelet import BUCKET_DEPTH, DIGIT_BITS, RADIX, heap_base
from seal_tpu_torch.kernels.bucket_counts import SUPPORT_WORDS, pack_support
from seal_tpu_torch.kernels.wt_search import check_index, index_args, load_block, rank_from_block


def bucket_digits(index) -> int:
    """Levels the bisection descends."""
    return min(BUCKET_DEPTH // DIGIT_BITS, index.digits)


def bucket_counts_width(index) -> int:
    """Width of the ``bucket_counts`` output: 16 ** depth."""
    return 1 << (DIGIT_BITS * bucket_digits(index))


def bucket_size_of(index) -> int:
    """Shifted-symbol span of one bucket."""
    return 1 << (DIGIT_BITS * (index.digits - bucket_digits(index)))


def wt_bucket_counts_plain(index, lo, hi):
    plo, phi = lo[..., None], hi[..., None]  # bounds within each node's sequence
    digit = torch.arange(RADIX, dtype=torch.int32, device=lo.device)
    for lvl in range(bucket_digits(index)):
        nodes = heap_base(lvl) + torch.arange(1 << (DIGIT_BITS * lvl), device=lo.device)
        start = index.node_start[nodes]
        cnt0 = index.node_cnt[nodes]  # [nodes, 16]
        children = []
        for p in (plo, phi):
            x = (start + p)[..., None].expand(*p.shape, RADIX)  # [..., nodes, 16]
            w = load_block(index, lvl, x)
            children.append((rank_from_block(w, x, digit.expand(x.shape)) - cnt0)
                            .reshape(lo.shape + (-1,)))
        plo, phi = children
    return (phi - plo).clamp(min=0).to(torch.int32)


def wt_bucket_counts(index, lo, hi):
    """Per-bucket counts of the (shifted) BWT symbols in rows [lo, hi):
    int32 [..., bucket_counts_width] for ranges lo/hi [...].

    CPU tensors run the plain version; CUDA tensors launch kernel 14.
    """
    lo = torch.as_tensor(lo, dtype=torch.int32, device=index.device)
    hi = torch.as_tensor(hi, dtype=torch.int32, device=index.device)
    lo, hi = torch.broadcast_tensors(lo, hi)
    if not lo.is_cuda:
        return wt_bucket_counts_plain(index, lo, hi)
    from seal_tpu_torch.kernels import build

    check_index(index, "wt_bucket_counts")
    lo, hi = lo.contiguous(), hi.contiguous()
    width = bucket_counts_width(index)
    out = torch.empty(tuple(lo.shape) + (width,), dtype=torch.int32, device=lo.device)
    rc = build.lib().seal_wt_bucket_counts(
        *index_args(index), lo.data_ptr(), hi.data_ptr(), out.data_ptr(), lo.numel(),
        bucket_digits(index), build.stream_ptr(lo),
    )
    build.check(rc, "wt_bucket_counts")
    wt_bucket_counts.launches += 1
    return out


wt_bucket_counts.launches = 0


def wt_bucket_support_plain(index, lo, hi):
    return pack_support(wt_bucket_counts_plain(index, lo, hi))


def wt_bucket_support(index, lo, hi):
    """The bucket-support bits of rows [lo, hi): int32 [..., SUPPORT_WORDS],
    bit ``b`` set iff ``wt_bucket_counts(index, lo, hi)[..., b] > 0``.

    CPU tensors run the plain version; CUDA tensors launch kernel 14's
    support mode.
    """
    lo = torch.as_tensor(lo, dtype=torch.int32, device=index.device)
    hi = torch.as_tensor(hi, dtype=torch.int32, device=index.device)
    lo, hi = torch.broadcast_tensors(lo, hi)
    if not lo.is_cuda:
        return wt_bucket_support_plain(index, lo, hi)
    from seal_tpu_torch.kernels import build

    check_index(index, "wt_bucket_support")
    lo, hi = lo.contiguous(), hi.contiguous()
    out = torch.empty(tuple(lo.shape) + (SUPPORT_WORDS,), dtype=torch.int32, device=lo.device)
    rc = build.lib().seal_wt_bucket_support(
        *index_args(index), lo.data_ptr(), hi.data_ptr(), out.data_ptr(), lo.numel(),
        bucket_digits(index), build.stream_ptr(lo),
    )
    build.check(rc, "wt_bucket_support")
    wt_bucket_support.launches += 1
    return out


wt_bucket_support.launches = 0
