"""Layout-generic FM-index query ops (counterpart of
``seal_tpu/ops/_generic.py``), written over a ``backward_step`` /
``bwt_at`` primitive so another index layout can reuse them."""

from __future__ import annotations

import torch

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

