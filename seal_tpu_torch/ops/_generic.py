"""Layout-generic FM-index query ops (counterpart of
``seal_tpu/ops/_generic.py``), written over a ``backward_step`` /
``bwt_at`` primitive so another index layout can reuse them."""

from __future__ import annotations

import torch

from seal_tpu_torch.kernels import count_mask
from seal_tpu_torch.kernels.window_gather import window_rows


def window_continuations(bwt_at, index, lo, hi, window: int):
    """Continuation tokens sampled from rows of [lo, hi): exhaustive when
    ``hi - lo <= window``, strided otherwise.  Returns (tokens, valid), each
    [..., window]; invalid, sentinel and out-of-vocab slots are -1."""
    lo = torch.as_tensor(lo, dtype=torch.int32, device=index.device)
    hi = torch.as_tensor(hi, dtype=torch.int32, device=index.device)
    rows, valid = window_rows(lo, hi, window)
    toks = bwt_at(index, torch.where(valid, rows, 0))
    valid = valid & (toks >= 0) & (toks < index.vocab)
    return torch.where(valid, toks, -1), valid


def validate_tokens(backward_step, index, tokens, lo, hi):
    """Continuation counts for candidate tokens: [..., N] given [...] ranges."""
    tokens = torch.as_tensor(tokens, dtype=torch.int32, device=index.device)
    lo = torch.as_tensor(lo, dtype=torch.int32, device=index.device)
    hi = torch.as_tensor(hi, dtype=torch.int32, device=index.device)
    new_lo, new_hi = backward_step(
        index, tokens, lo[..., None].expand(tokens.shape), hi[..., None].expand(tokens.shape)
    )
    return new_hi - new_lo


def dense_counts(validate_fn, index, lo, hi, chunk: int):
    """Exact continuation-count vector over the whole model vocab: int32
    [..., vocab], the count of every possible next token of each range.
    Sweeps ``chunk`` tokens at a time through ``validate_fn`` (the last
    chunk runs past the vocab and is cut), which bounds the memory of a
    plain sweep."""
    lo = torch.as_tensor(lo, dtype=torch.int32, device=index.device)
    hi = torch.as_tensor(hi, dtype=torch.int32, device=index.device)
    vocab = index.vocab
    out = []
    for start in range(0, vocab, chunk):
        toks = torch.arange(start, start + chunk, dtype=torch.int32, device=index.device)
        out.append(validate_fn(index, toks.expand(*lo.shape, chunk), lo, hi))
    return torch.cat(out, -1)[..., :vocab]


def dense_mask(validate_fn, index, lo, hi, chunk: int):
    """The count mask of every range (``kernels/count_mask.py``): int32
    [..., words(vocab)], bit t set iff token t continues the range, i.e.
    ``pack(dense_counts(...) > 0)``.  The same sweep, each chunk packed as
    it is counted (``chunk`` rounded up to whole 128-token groups), so no
    [..., vocab] counts are held."""
    lo = torch.as_tensor(lo, dtype=torch.int32, device=index.device)
    hi = torch.as_tensor(hi, dtype=torch.int32, device=index.device)
    vocab = index.vocab
    step = -(-chunk // 128) * 128
    out = []
    for start in range(0, vocab, step):
        toks = torch.arange(start, start + step, dtype=torch.int32, device=index.device)
        ok = validate_fn(index, toks.expand(*lo.shape, step), lo, hi) > 0
        out.append(count_mask.pack(ok & (toks < vocab)))  # no bit past the vocab
    return torch.cat(out, -1)[..., :count_mask.words(vocab)]


def advance_ranges(extend, range_size, sel_tok, sel_par, lo, hi, finished=None, *, eos: int,
                   pad: int):
    """The decode step's range update after a selection
    (``seal_tpu/decoding/constrained.py:1416-1430``): each selection's
    parent range (``lo``, ``hi`` [..., B, P], gathered by ``sel_par`` [B,
    K], the index shared over leading axes) extended by ``sel_tok``, and the
    parent's ``range_size``; with ``finished`` [B, P] (steps >= 1) the
    range becomes (0, 0) where the token is EOS or PAD or the parent had
    finished.  At step 0 (``finished`` None: :1344-1349) there is no stop
    rule.  Returns (lo, hi, prev_count)."""
    def gather(x):
        idx = sel_par.long()
        return torch.gather(x, -1, idx.expand(*x.shape[: x.dim() - idx.dim()], *idx.shape))

    prev_count = gather(range_size(lo, hi))
    elo, ehi = extend(sel_tok, gather(lo), gather(hi))
    if finished is None:
        return elo, ehi, prev_count
    stop = (sel_tok == eos) | (sel_tok == pad) | gather(finished)
    return torch.where(stop, 0, elo), torch.where(stop, 0, ehi), prev_count
