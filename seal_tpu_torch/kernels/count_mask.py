"""The count mask: a bit a token of each range's continuation counts.

The ``exact_mask`` decode reads a beam's count vector only as ``count >
0`` (``seal_tpu/decoding/constrained.py:321-327``, ``fm_valid = counts >
0``).  Kernels 15 and 16 write that bit in place of the int32 count in
their mask modes, and kernel 17's two forms and kernel 20's count-reading
mode read it: 3.0 MB a dense step at [32, 15] x 50265 where the counts
are 96.5 MB.

The layout: int32 ``[..., W]`` with ``W = words(V) = 4 * ceil(V / 128)``
(every row 16-byte aligned); bit ``j`` of word ``w`` is set iff the range
has a row holding token ``32 * w + j``; the padding bits past ``V`` are 0.
"""

from __future__ import annotations

import torch

BITS = 32


def words(vocab: int) -> int:
    """Words a row of the mask: four for every 128 tokens."""
    return 4 * -(-vocab // 128)


def pack(allowed):
    """bool ``[..., V]`` -> the int32 mask ``[..., words(V)]``."""
    *lead, V = allowed.shape
    W = words(V)
    bits = torch.zeros((*lead, W * BITS), dtype=torch.int64, device=allowed.device)
    bits[..., :V] = allowed.to(torch.int64)
    shifts = torch.arange(BITS, dtype=torch.int64, device=allowed.device)
    word = (bits.reshape(*lead, W, BITS) << shifts).sum(-1)
    return torch.where(word >= 2**31, word - 2**32, word).to(torch.int32)


def unpack(mask, vocab: int):
    """The int32 mask ``[..., words(vocab)]`` -> bool ``[..., vocab]``."""
    if mask.shape[-1] != words(vocab):
        raise ValueError(f"count mask: {mask.shape[-1]} words a row for a vocab of {vocab} "
                         f"(want {words(vocab)})")
    shifts = torch.arange(BITS, dtype=torch.int64, device=mask.device)
    bits = ((mask.to(torch.int64)[..., None] >> shifts) & 1).bool()
    return bits.reshape(*mask.shape[:-1], -1)[..., :vocab]
