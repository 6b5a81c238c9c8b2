"""The pieces both model families share: the tied LM head's matmul (with
its gradient on the card) and the beam reorder of the decode cache
(kernel 11).  ``models/bart.py`` and ``models/t5.py`` import them from
here, so neither family module depends on the other."""

from __future__ import annotations

import torch

from seal_tpu_torch.kernels import reorder_cache as k_reorder


class _HeadMM(torch.autograd.Function):
    """``torch.mm(h, w.T, out_dtype=torch.float32)`` for 16-bit operands on
    the card, with a gradient (that op has none in torch): the backward's
    two products take the f32 gradient in the operands' dtype, accumulate
    in f32 and round to that dtype, the gradients of 16-bit operands.  The
    tied table's f32 master copy then collects this gradient beside the
    embedding gather's (through the ``.to`` cast of ``shared``)."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        return torch.mm(h, w.T, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        g = g.to(h.dtype)
        f32 = torch.float32  # f32 accumulation: no reduced-precision split-K sums
        return (torch.mm(g, w, out_dtype=f32).to(h.dtype),
                torch.mm(g.T, h, out_dtype=f32).to(w.dtype))


def tied_head(cfg, shared, hidden):
    """hidden @ shared.T with operands in the compute dtype, f32 out.

    F32 accumulation AND an f32 result: a bf16 ``torch.matmul`` would round
    its output to bf16, so on the card the bf16 head is ``torch.mm(...,
    out_dtype=torch.float32)`` (through ``_HeadMM``, which gives it a
    gradient).  Elsewhere (f32 configs, or bf16 on the CPU, which lacks
    that op) the operands are widened to f32 first, which computes the same
    products exactly.
    """
    dt = cfg.compute_dtype
    w = shared.to(dt)
    h2 = hidden.to(dt).reshape(-1, hidden.shape[-1])
    if dt != torch.float32 and h2.is_cuda:
        logits = _HeadMM.apply(h2, w)
    else:
        logits = h2.float() @ w.float().T
    return logits.reshape(*hidden.shape[:-1], w.shape[0])


def reorder_cache(self_cache, beam_idx, step: int, out):
    """Gather cache rows along the batch dim after a beam permutation
    (kernel 11, one launch for every layer's K and V).

    ``out``: a preallocated cache with ``len(beam_idx)`` rows to gather into
    (the beam search ping-pongs between two).  Only the live columns
    [0, step] are copied: the columns past it were never written in either
    cache, so the result equals the full gather.  Returns ``out``.
    """
    k_reorder.reorder_cache([c[n] for c in self_cache for n in ("k", "v")], beam_idx, step + 1,
                            [c[n] for c in out for n in ("k", "v")])
    return out
