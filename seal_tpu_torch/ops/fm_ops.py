"""Batched FM-index query ops over a :class:`TorchFMIndex` (counterpart of
``seal_tpu/ops/fm_ops.py``).

All ops take *unshifted* token ids and shift internally (SHIFT == 1).
``backward_step``/``extend_ranges``, ``contains_tokens`` and
``advance_ranges`` (the decode step's range update) go through the
rank-search kernel, ``range_for_sequences``/``count_sequences`` through
its sequence mode and ``dense_counts`` / ``dense_mask`` through its dense
kernel's counts and mask modes (``kernels/fm_search.py``), ``window_gather``, ``window_slab`` and
``slab_gather`` through the window kernel's modes (kernel 2),
``bucket_counts`` and ``bucket_support`` through the bucket kernel's counts
and support modes (kernel 6) and ``locate_rows`` /
``doc_index_of`` through kernel 18 (``kernels/locate.py``); the other ops
are plain torch on every device.
"""

from __future__ import annotations

import torch

from seal_tpu_torch.index.fm_index import SHIFT
from seal_tpu_torch.kernels.bucket_counts import bucket_counts, bucket_support  # noqa: F401
from seal_tpu_torch.kernels.fm_search import (
    fm_advance,
    fm_dense_counts,
    fm_dense_mask,
    fm_search,
    fm_sequences,
    searchsorted_psi,
    symbol_bounds,
)
from seal_tpu_torch.kernels import locate
from seal_tpu_torch.kernels.window_gather import (  # noqa: F401
    slab_gather,
    window_gather,
    window_slab,
)
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


def advance_ranges(index, sel_tok, sel_par, lo, hi, finished=None, *, eos: int, pad: int):
    """The range update after a selection, in one launch of kernel 1's step
    mode: (lo, hi, prev_count) [B, K] (``ops/_generic.py:advance_ranges``)."""
    return fm_advance(index, sel_tok, sel_par, lo, hi, finished, eos=eos, pad=pad)


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


def bucket_size_of(index) -> int:
    """Shifted-symbol span of one ``bucket_counts`` bucket."""
    return index.bucket_size


def validate_tokens(index, tokens, lo, hi):
    """Counts of each candidate continuation token of ranges [lo, hi)."""
    return _generic.validate_tokens(backward_step, index, tokens, lo, hi)


def locate_rows(index, rows):
    """Corpus positions (reversed-text coordinates) of index rows: ``sa[row]``
    for rows in [0, n_rows), else -1.  Needs the index built with
    ``keep_sa=True``."""
    if index.sa is None:
        raise ValueError("locate_rows needs the suffix array on the device: build the index "
                         "with TorchFMIndex.from_host(..., keep_sa=True)")
    return locate.locate_rows(index.sa, _i32(index, rows))


def doc_index_of(index, positions):
    """Document index containing each corpus position (bisect_right - 1 over
    the document beginnings)."""
    return locate.doc_index_of(index.beginnings, _i32(index, positions))


def dense_counts(index, lo, hi, chunk: int = 4096):
    """Exact continuation-count vector over the whole model vocab: int32
    [..., vocab] (kernel 15 on the card, the chunked sweep on the CPU)."""
    return fm_dense_counts(index, lo, hi, chunk)


def dense_mask(index, lo, hi, chunk: int = 4096):
    """The count mask of every range: int32 [..., count_mask.words(vocab)],
    bit t set iff token t continues the range (kernel 15's mask mode on the
    card, the chunked sweep packed on the CPU)."""
    return fm_dense_mask(index, lo, hi, chunk)
