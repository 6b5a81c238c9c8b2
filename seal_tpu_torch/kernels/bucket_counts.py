"""Kernel 6 wrapper: exact per-bucket symbol counts of BWT[lo:hi), and
the bucket-support bits the decoder reads (``csrc/bucket_counts.cu``).

Replaces ``seal_tpu/ops/fm_ops.py:bucket_counts`` (:238), the
support-pruning input of the exact proposal loop's later rounds: the
``bucket_occ`` rows at both bounds plus a recount of the at most
``bucket_rows`` rows of each bound's partial block.  Integer counts, so
the kernel equals the plain version exactly.  One CTA per range with a
shared-memory histogram; see the source.

``bucket_counts_sharded`` is its shard mode over a ``ShardedTorchIndex``
(``seal_tpu_torch/parallel/sharded_index.py``), for
``seal_tpu/parallel/sharded_decode.py:ShardedIndexOps.bucket_counts``
(:138): every shard's counts of its own range, summed over the shards (the
shards share one bucket partition, so their columns line up), in one
launch.

The straggler rounds read a count only as ``count > 0``
(``seal_tpu/decoding/constrained.py:604``), so the decoder calls the
support modes, :func:`bucket_support` and :func:`bucket_support_sharded`:
8 int32 words a range, bit ``b`` of the 256 set iff bucket ``b``'s count is
positive (a warp a range, by the range's own rows where they are fewer than
the recount's, else the table and the recount of each bound's rows up to
its block's nearer end).  The counts
modes stay entry points of ``ops.bucket_counts`` that no decode path
launches.
"""

from __future__ import annotations

import torch

from seal_tpu_torch.kernels import count_mask

SUPPORT_WORDS = 8  # 256 bucket bits a range
SUPPORT_BUCKETS = count_mask.BITS * SUPPORT_WORDS


def pack_support(counts):
    """int32 counts ``[..., n <= 256]`` -> the support bits ``[...,
    SUPPORT_WORDS]`` (``count_mask.pack`` of ``counts > 0``, the buckets
    past ``n`` 0)."""
    n = counts.shape[-1]
    if n > SUPPORT_BUCKETS:
        raise ValueError(f"bucket support: {n} buckets, at most {SUPPORT_BUCKETS}")
    pos = torch.nn.functional.pad(counts > 0, (0, SUPPORT_BUCKETS - n))
    return count_mask.pack(pos)


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


def bucket_counts_sharded_plain(si, lo, hi):
    return sum(bucket_counts_plain(si.block_view(s), lo[s], hi[s]) for s in range(si.n_shards))


def bucket_counts_sharded(si, lo, hi):
    """Per-bucket counts of the (shifted) BWT symbols in each shard's rows
    [lo[s], hi[s]), summed over the shards: int32 [..., n_buckets] for
    ranges lo/hi [S, ...] (clamped to the padded shard size).

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    lo = torch.as_tensor(lo, dtype=torch.int32, device=si.device)
    hi = torch.as_tensor(hi, dtype=torch.int32, device=si.device)
    if lo.shape != hi.shape or lo.dim() == 0 or lo.shape[0] != si.n_shards:
        raise ValueError(f"bucket_counts_sharded: ranges {tuple(lo.shape)} / {tuple(hi.shape)} "
                         f"for {si.n_shards} shards")
    if not lo.is_cuda:
        return bucket_counts_sharded_plain(si, lo, hi)
    from seal_tpu_torch.kernels import build

    lo, hi = lo.contiguous(), hi.contiguous()
    nb = si.n_buckets
    if si.bucket_occ.shape[2] != nb or not si.bucket_occ.is_contiguous():
        raise ValueError(f"bucket_counts_sharded: bucket_occ {tuple(si.bucket_occ.shape)} vs "
                         f"{nb} buckets")
    out = torch.empty(tuple(lo.shape[1:]) + (nb,), dtype=torch.int32, device=lo.device)
    rc = build.lib().seal_bucket_counts_sharded(
        si.bwt.data_ptr(), si.bucket_occ.data_ptr(), si.n_max, si.bucket_occ.shape[1],
        si.n_shards, lo.data_ptr(), hi.data_ptr(), out.data_ptr(), lo[0].numel(), si.bucket_rows,
        si.bucket_size, nb, build.stream_ptr(lo),
    )
    build.check(rc, "bucket_counts_sharded")
    bucket_counts_sharded.launches += 1
    return out


bucket_counts_sharded.launches = 0


def bucket_support_plain(index, lo, hi):
    return pack_support(bucket_counts_plain(index, lo, hi))


def bucket_support(index, lo, hi):
    """The bucket-support bits of rows [lo, hi): int32 [..., SUPPORT_WORDS],
    bit ``b`` set iff ``bucket_counts(index, lo, hi)[..., b] > 0``.

    CPU tensors run the plain version; CUDA tensors launch kernel 6's
    support mode.
    """
    lo = torch.as_tensor(lo, dtype=torch.int32, device=index.device)
    hi = torch.as_tensor(hi, dtype=torch.int32, device=index.device)
    lo, hi = torch.broadcast_tensors(lo, hi)
    if not lo.is_cuda:
        return bucket_support_plain(index, lo, hi)
    from seal_tpu_torch.kernels import build

    lo, hi = lo.contiguous(), hi.contiguous()
    nb = index.n_buckets
    if tuple(index.bucket_occ.shape[1:]) != (nb,) or nb > SUPPORT_BUCKETS:
        raise ValueError(
            f"bucket_support: bucket_occ {tuple(index.bucket_occ.shape)} vs {nb} buckets")
    out = torch.empty(tuple(lo.shape) + (SUPPORT_WORDS,), dtype=torch.int32, device=lo.device)
    rc = build.lib().seal_bucket_support(
        index.bwt.data_ptr(), index.bucket_occ.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        out.data_ptr(), lo.numel(), index.n_rows, index.bucket_rows, index.bucket_size, nb,
        build.stream_ptr(lo),
    )
    build.check(rc, "bucket_support")
    bucket_support.launches += 1
    return out


bucket_support.launches = 0


def bucket_support_sharded_plain(si, lo, hi):
    return pack_support(bucket_counts_sharded_plain(si, lo, hi))


def bucket_support_sharded(si, lo, hi):
    """The support bits of the counts summed over the shards (each shard's
    bits ORed): int32 [..., SUPPORT_WORDS] for ranges lo/hi [S, ...].

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    lo = torch.as_tensor(lo, dtype=torch.int32, device=si.device)
    hi = torch.as_tensor(hi, dtype=torch.int32, device=si.device)
    if lo.shape != hi.shape or lo.dim() == 0 or lo.shape[0] != si.n_shards:
        raise ValueError(f"bucket_support_sharded: ranges {tuple(lo.shape)} / "
                         f"{tuple(hi.shape)} for {si.n_shards} shards")
    if not lo.is_cuda:
        return bucket_support_sharded_plain(si, lo, hi)
    from seal_tpu_torch.kernels import build

    lo, hi = lo.contiguous(), hi.contiguous()
    nb = si.n_buckets
    if (si.bucket_occ.shape[2] != nb or not si.bucket_occ.is_contiguous()
            or nb > SUPPORT_BUCKETS):
        raise ValueError(f"bucket_support_sharded: bucket_occ {tuple(si.bucket_occ.shape)} vs "
                         f"{nb} buckets")
    out = torch.empty(tuple(lo.shape[1:]) + (SUPPORT_WORDS,), dtype=torch.int32,
                      device=lo.device)
    rows = si.n_rows.to(torch.int32).contiguous()
    rc = build.lib().seal_bucket_support_sharded(
        si.bwt.data_ptr(), si.bucket_occ.data_ptr(), si.n_max, si.bucket_occ.shape[1],
        si.n_shards, rows.data_ptr(), lo.data_ptr(), hi.data_ptr(), out.data_ptr(),
        lo[0].numel(), si.bucket_rows, si.bucket_size, nb, build.stream_ptr(lo),
    )
    build.check(rc, "bucket_support_sharded")
    bucket_support_sharded.launches += 1
    return out


bucket_support_sharded.launches = 0
