"""Kernel 6 wrapper: exact per-bucket symbol counts of BWT[lo:hi)
(``csrc/bucket_counts.cu``).

Replaces ``seal_tpu/ops/fm_ops.py:bucket_counts`` (:238), the
support-pruning input of the exact proposal loop's later rounds: the
``bucket_occ`` rows at both bounds plus a recount of the at most
``bucket_rows`` rows of each bound's partial block.  Integer counts, so
the kernel equals the plain version exactly.  One CTA per range with a
shared-memory histogram; see the source.
"""

from __future__ import annotations

import torch


def bucket_counts_plain(index, lo, hi):
    lo = lo.clamp(0, index.n_rows)
    hi = hi.clamp(0, index.n_rows)
    pos = torch.stack([lo, hi], 0)
    R, nb = index.bucket_rows, index.n_buckets
    blk = pos // R
    base = index.bucket_occ[blk.long()]  # [2, ..., nb]
    rows = blk[..., None] * R + torch.arange(R, dtype=torch.int32, device=lo.device)
    valid = rows < pos[..., None]
    sym = index.bwt[torch.where(valid, rows, 0).long()]
    # out-of-vocab symbols land past the last bucket, in the dropped column
    bid = torch.where(valid, (sym // index.bucket_size).clamp(max=nb), nb).long()
    partial = torch.zeros(pos.shape + (nb + 1,), dtype=torch.int32, device=lo.device)
    partial.scatter_add_(-1, bid, torch.ones_like(bid, dtype=torch.int32))
    pre = base + partial[..., :nb]
    return pre[1] - pre[0]


def bucket_counts(index, lo, hi):
    """Per-bucket counts of the (shifted) BWT symbols in rows [lo, hi):
    int32 [..., n_buckets] for ranges lo/hi [...] (clamped to the index).

    CPU tensors run the plain version; CUDA tensors launch kernel 6.
    """
    lo = torch.as_tensor(lo, dtype=torch.int32, device=index.device)
    hi = torch.as_tensor(hi, dtype=torch.int32, device=index.device)
    lo, hi = torch.broadcast_tensors(lo, hi)
    if not lo.is_cuda:
        return bucket_counts_plain(index, lo, hi)
    from seal_tpu_torch.kernels import build

    lo, hi = lo.contiguous(), hi.contiguous()
    nb = index.n_buckets
    if tuple(index.bucket_occ.shape[1:]) != (nb,):
        raise ValueError(
            f"bucket_counts: bucket_occ {tuple(index.bucket_occ.shape)} vs {nb} buckets"
        )
    out = torch.empty(tuple(lo.shape) + (nb,), dtype=torch.int32, device=lo.device)
    rc = build.lib().seal_bucket_counts(
        index.bwt.data_ptr(), index.bucket_occ.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        out.data_ptr(), lo.numel(), index.n_rows, index.bucket_rows, index.bucket_size, nb,
        build.stream_ptr(lo),
    )
    build.check(rc, "bucket_counts")
    bucket_counts.launches += 1
    return out


bucket_counts.launches = 0
