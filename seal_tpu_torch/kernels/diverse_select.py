"""Kernel 21 wrapper: diverse beam groups' selection
(``csrc/diverse_select.cu``), with its plain version.

Replaces ``seal_tpu/decoding/constrained.py:_select_diverse`` (:1125-1171)
and ``dispatch_select``'s ``cons + beam_scores`` (:1283-1286): the beams
split into G groups of gs; group by group, each candidate's constrained
score plus its beam's score, less ``penalty`` times how often the earlier
groups picked its token at this step, ranks the group's [gs * N] row; the
top 2*gs are the group's history and the first gs that are not EOS its
continuing beams.  The penalized score is both what selects and what is
recorded.

Candidates are a list with its token table ([B, K, N] from kernel 8's
candidate mode or free generation's top-``top_m``) or V-wide rows where the
token is the column (step 0 under the corpus mask, ``exact_mask``).  The
order is ``lax.top_k``'s, or under ``ties`` JAX's (score, (beam in group,
token)) order, as kernel 8's.  Every output is a selection or JAX's f32
arithmetic in its order, so the kernel equals the plain version bit for bit.
"""

from __future__ import annotations

import torch

from seal_tpu_torch.kernels.beam_select import (
    NEG_INF,
    _check,
    _select_outputs,
    beam_tok_tie,
    tie_bits,
    top_by_score_then_id,
)
from seal_tpu_torch.kernels.row_topk import row_topk_plain


def diverse_select_plain(cons, tokens, beam_scores, *, groups: int, penalty: float, eos: int,
                         ties: bool = False, vocab: int = 0, mask=None):
    B, K = beam_scores.shape
    N = cons.shape[-1]
    gs = K // groups
    cons = cons.reshape(B, K, N)
    if mask is not None:
        cons = torch.where(mask, cons, NEG_INF)
    if tokens is None:
        tokens = torch.arange(N, dtype=torch.int32, device=cons.device).expand(B, K, N)
    tokens = tokens.reshape(B, K, N)
    cum = cons + beam_scores[..., None]
    pen = torch.tensor(penalty, dtype=torch.float32, device=cons.device)
    hist, sel = [], []
    for g in range(groups):
        sc, tk = cum[:, g * gs:(g + 1) * gs], tokens[:, g * gs:(g + 1) * gs]
        if g > 0 and penalty > 0.0:
            freq = sum((tk == p[:, None, None]).to(torch.int32) for p in torch.cat(
                [s[0] for s in sel], -1).unbind(-1))
            sc = sc - pen * freq.to(torch.float32)
        flat, flat_tok = sc.reshape(B, gs * N), tk.reshape(B, gs * N)
        if ties:
            top_idx = top_by_score_then_id(flat, beam_tok_tie(flat_tok, N, vocab), 2 * gs)
        else:
            top_idx = row_topk_plain(flat, 2 * gs)[1]
        top_sc = torch.gather(flat, -1, top_idx)
        top_tok = torch.gather(flat_tok, -1, top_idx)
        top_par = (top_idx // N).to(torch.int32) + g * gs
        finite = top_sc > NEG_INF / 4
        cont = torch.argsort((top_tok == eos).to(torch.int8), dim=-1, stable=True)[:, :gs]
        hist.append((top_tok, top_par, top_sc, finite))
        sel.append(tuple(torch.gather(x, -1, cont) for x in (top_tok, top_par, top_sc, finite)))
    return tuple(torch.cat(xs, -1) for xs in zip(*hist)) + tuple(
        torch.cat(xs, -1) for xs in zip(*sel))


def diverse_select(cons, tokens, beam_scores, *, groups: int, penalty: float, eos: int,
                   ties: bool = False, vocab: int = 0, mask=None):
    """One step's selection of ``groups`` diverse beam groups per query.

    ``cons`` f32 [B, K, N]: constrained log-probs without the beam scores
    (``NEG_INF`` where not allowed); ``tokens`` int32 [B, K, N], or None
    where the token is the column; ``beam_scores`` f32 [B, K]; ``mask``
    bool [N] (with ``tokens`` None): columns allowed at all.  ``vocab``
    sizes the tie id's token field under ``ties``.  Returns
    ``_select_diverse``'s eight outputs: the [B, 2K] history (each group's
    top 2*gs: token, parent, penalized score, finite) and the [B, K]
    selection (each group's gs continuing beams).

    CPU tensors run the plain version; CUDA tensors launch the kernel (2G
    launches, counted as one call).
    """
    B, K = beam_scores.shape
    N = cons.shape[-1]
    if groups < 1 or K % groups:
        raise ValueError(f"diverse_select: {K} beams do not split into {groups} groups")
    gs = K // groups
    if gs * N < 2 * gs:
        raise ValueError(f"diverse_select: {N} candidates a beam for a top-{2 * gs}")
    bits = tie_bits(vocab, gs) if ties else 0
    kw = dict(groups=groups, penalty=penalty, eos=eos, ties=ties, vocab=vocab, mask=mask)
    if not cons.is_cuda:
        return diverse_select_plain(cons, tokens, beam_scores, **kw)
    from seal_tpu_torch.kernels import build

    if cons.numel() != B * K * N:
        raise ValueError(f"diverse_select: cons must be [B, K, N] = [{B}, {K}, {N}]")
    if mask is not None and (tokens is not None or mask.shape != (N,)):
        raise ValueError("diverse_select: a mask [N] goes with token = column only")
    if build.lib().seal_diverse_smem(gs * N, gs, K) > build.SMEM_LIMIT:
        raise ValueError(f"diverse_select: {gs * N} candidates a group exceed the shared memory")
    cons, beam_scores = cons.contiguous(), beam_scores.contiguous()
    _check(cons, torch.float32, beam_scores, torch.float32)
    if tokens is not None:
        tokens = tokens.contiguous()
        _check(tokens, torch.int32)
        if tokens.numel() != B * K * N:
            raise ValueError("diverse_select: tokens must be [B, K, N]")
    if mask is not None:
        mask = mask.contiguous()
        _check(mask, torch.bool)
    dev = cons.device
    n_part = build.lib().seal_diverse_chunks(gs * N) * 2 * gs
    part_key = torch.empty((B, n_part), dtype=torch.int64, device=dev)
    part_slot = torch.empty((B, n_part), dtype=torch.int32, device=dev)
    outs = _select_outputs(B, K, dev)[:8]
    opt = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    rc = build.lib().seal_diverse_select(
        cons.data_ptr(), opt(tokens), opt(mask), beam_scores.data_ptr(), B, K, N, groups, eos,
        bits, int(penalty > 0.0), penalty, NEG_INF, part_key.data_ptr(), part_slot.data_ptr(),
        *(t.data_ptr() for t in outs), build.stream_ptr(cons),
    )
    build.check(rc, "diverse_select")
    diverse_select.launches += 1
    return outs


diverse_select.launches = 0
