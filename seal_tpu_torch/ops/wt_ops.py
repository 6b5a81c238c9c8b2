"""Batched FM-index query ops over a :class:`WaveletIndex`, the compact and
hybrid layouts (counterpart of ``seal_tpu/ops/wt_ops.py``).

The same op surface as ``fm_ops`` (the Psi layout), so the constrained
decoder runs unchanged on either index.  All ops take *unshifted* token ids
and shift internally (SHIFT == 1).  ``backward_step``/``extend_ranges``,
``contains_tokens``, ``range_for_sequences``/``count_sequences`` and
``advance_ranges`` (the decode step's range update, its step mode) go
through the rank-search kernel (kernel 12, ``kernels/wt_search.py``),
``dense_counts`` through its dense kernel (16), ``window_gather``,
``window_slab`` and ``slab_gather`` through the window kernel's three modes
(13, kernel 2's contract: the window, the step's window and round 0's slab
in one launch, a round's slab), and ``bucket_counts`` and
``bucket_support`` through the bisection kernel's counts and support modes
(14); ``rank``,
``access``, ``bwt_at`` and ``window_continuations`` are plain torch on
every device.
"""

from __future__ import annotations

import torch

from seal_tpu_torch.kernels.wt_bucket_counts import (  # noqa: F401
    bucket_counts_width,
    bucket_size_of,
)
from seal_tpu_torch.kernels.wt_bucket_counts import wt_bucket_counts as bucket_counts  # noqa: F401
from seal_tpu_torch.kernels.wt_bucket_counts import wt_bucket_support as bucket_support  # noqa: F401
from seal_tpu_torch.kernels.wt_search import (
    access_plain,
    rank_plain,
    wt_advance,
    wt_dense_counts,
    wt_dense_mask,
    wt_search,
    wt_sequences,
)
from seal_tpu_torch.kernels.wt_window import bwt_at  # noqa: F401
from seal_tpu_torch.kernels.wt_window import wt_slab_gather as slab_gather  # noqa: F401
from seal_tpu_torch.kernels.wt_window import wt_window_gather as window_gather
from seal_tpu_torch.kernels.wt_window import wt_window_slab as window_slab  # noqa: F401
from seal_tpu_torch.ops import _generic


def _i32(index, x):
    return torch.as_tensor(x, dtype=torch.int32, device=index.device)


def rank(index, symbol, pos):
    """Occ(symbol, pos) for *shifted* symbols; 16-ary wavelet descent."""
    return rank_plain(index, _i32(index, symbol), _i32(index, pos))


def access(index, rows):
    """Shifted BWT symbols at the given rows; 16-ary wavelet descent."""
    return access_plain(index, _i32(index, rows))


def backward_step(index, token, lo, hi):
    """One backward-search step on half-open [lo, hi) with *unshifted*
    token(s); empty in, empty out.  Returns int32 (new_lo, new_hi)."""
    return wt_search(index, "backward_step", token, lo, hi)


def extend_ranges(index, tokens, lo, hi):
    """Ranges after appending one token per batch element (shapes match)."""
    return backward_step(index, tokens, lo, hi)


def advance_ranges(index, sel_tok, sel_par, lo, hi, finished=None, *, eos: int, pad: int):
    """The range update after a selection, in one launch of kernel 12's
    step mode: (lo, hi, prev_count) [B, K] (``ops/_generic.py:
    advance_ranges``)."""
    return wt_advance(index, sel_tok, sel_par, lo, hi, finished, eos=eos, pad=pad)


def contains_tokens(index, tokens, lo, hi):
    """Membership: does each token of [..., M] continue range [lo, hi)?
    Equal to ``validate_tokens(...) > 0``: the plain two-bound rank."""
    return wt_search(index, "contains", tokens, lo, hi)


def range_for_sequences(index, tokens, lengths):
    """Row ranges for padded token sequences: tokens int32 [..., L]
    (unshifted), lengths int32 [...]; positions >= length are ignored.
    Returns int32 (lo, hi) [...]."""
    return wt_sequences(index, tokens, lengths)


def count_sequences(index, tokens, lengths):
    """Corpus occurrence counts for padded sequences (``get_count`` parity)."""
    lo, hi = range_for_sequences(index, tokens, lengths)
    return hi - lo


def window_continuations(index, lo, hi, window: int):
    """Strided/exhaustive interval enumeration (see ``ops._generic``)."""
    return _generic.window_continuations(bwt_at, index, lo, hi, window)


def validate_tokens(index, tokens, lo, hi):
    """Counts of each candidate continuation token of ranges [lo, hi)."""
    return _generic.validate_tokens(backward_step, index, tokens, lo, hi)


def dense_counts(index, lo, hi, chunk: int = 4096):
    """Exact continuation-count vector over the whole model vocab: int32
    [..., vocab] (kernel 16 on the card, the chunked sweep on the CPU)."""
    return wt_dense_counts(index, lo, hi, chunk)


def dense_mask(index, lo, hi, chunk: int = 4096):
    """The count mask of every range: int32 [..., count_mask.words(vocab)],
    bit t set iff token t continues the range (kernel 16's mask mode on the
    card, the chunked sweep packed on the CPU)."""
    return wt_dense_mask(index, lo, hi, chunk)
