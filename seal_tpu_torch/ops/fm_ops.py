"""Batched FM-index query ops over a :class:`TorchFMIndex` (counterpart of
``seal_tpu/ops/fm_ops.py``).

All ops take *unshifted* token ids and shift internally (SHIFT == 1).
``backward_step``/``extend_ranges`` and ``contains_tokens`` go through the
rank-search kernel and ``range_for_sequences``/``count_sequences`` through
its sequence mode (``kernels/fm_search.py``), ``window_gather`` through the
window kernel and ``bucket_counts`` through the bucket kernel; the other
ops are plain torch on every device.
"""

from __future__ import annotations

import torch

from seal_tpu.index.fm_index import SHIFT
from seal_tpu_torch.kernels.bucket_counts import bucket_counts  # noqa: F401
from seal_tpu_torch.kernels.fm_search import (
    fm_search,
    fm_sequences,
    searchsorted_psi,
    symbol_bounds,
)
from seal_tpu_torch.kernels.window_gather import window_gather  # noqa: F401
from seal_tpu_torch.ops import _generic


def _i32(index, x):
    return torch.as_tensor(x, dtype=torch.int32, device=index.device)


def rank(index, symbol, pos):
    """Occ(symbol, pos): #occurrences of *shifted* symbol in bwt[0:pos)."""
    symbol = _i32(index, symbol)
    pos = _i32(index, pos)
    symbol, pos = torch.broadcast_tensors(symbol, pos)
    valid = (symbol >= 0) & (symbol < index.sigma)
    c = torch.where(valid, symbol, 0)
    blo, _, dlo, dhi = symbol_bounds(index, c, pos)
    row = searchsorted_psi(index, dlo, dhi, pos)
    return torch.where(valid, row - blo, 0)


def backward_step(index, token, lo, hi):
    """One backward-search step on half-open [lo, hi) with *unshifted*
    token(s); empty in, empty out.  Returns int32 (new_lo, new_hi)."""
    return fm_search(index, "backward_step", token, lo, hi)


def extend_ranges(index, tokens, lo, hi):
    """Ranges after appending one token per batch element (shapes match)."""
    return backward_step(index, tokens, lo, hi)


def contains_tokens(index, tokens, lo, hi):
    """Membership: does each token of [..., M] continue range [lo, hi)?
    Equal to ``validate_tokens(...) > 0`` at one search per token."""
    return fm_search(index, "contains", tokens, lo, hi)


def range_for_sequences(index, tokens, lengths):
    """Row ranges for padded token sequences: tokens int32 [..., L]
    (unshifted), lengths int32 [...]; positions >= length are ignored.
    Returns int32 (lo, hi) [...]."""
    return fm_sequences(index, tokens, lengths)


def count_sequences(index, tokens, lengths):
    """Corpus occurrence counts for padded sequences (``get_count`` parity)."""
    lo, hi = range_for_sequences(index, tokens, lengths)
    return hi - lo


def bwt_at(index, rows):
    """BWT symbols at the given rows, *unshifted* (sentinel -> -1)."""
    return index.bwt[torch.as_tensor(rows, device=index.device).long()] - SHIFT


def window_continuations(index, lo, hi, window: int):
    """Strided/exhaustive interval enumeration (see ``ops._generic``)."""
    return _generic.window_continuations(bwt_at, index, lo, hi, window)


def bucket_counts_width(index) -> int:
    """Width of ``bucket_counts`` output."""
    return int(index.bucket_occ.shape[-1])


def validate_tokens(index, tokens, lo, hi):
    """Counts of each candidate continuation token of ranges [lo, hi)."""
    return _generic.validate_tokens(backward_step, index, tokens, lo, hi)

