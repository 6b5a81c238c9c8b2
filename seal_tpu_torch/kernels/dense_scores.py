"""Kernel 17 wrapper: the dense candidate pass of the ``exact_mask`` decode
mode (``csrc/dense_scores.cu``).

Replaces, in ``seal_tpu/decoding/constrained.py``: the dense branch of
``_candidates_general`` (:321-327) with ``_apply_branches`` (:897-912),
``cons = where(allowed, cand_lp, NEG_INF)`` (:1394) and the parent's beam
score added before ``_select`` (:1287-1294).  The output is the flat
[B, K * V] row of constrained scores that kernel 3 ranks.  A selection and
one f32 add per element, so the kernel equals the plain version bit for
bit.  Bound by bytes: a count and a log-prob read and a score written per
element.
"""

from __future__ import annotations

import torch

from seal_tpu_torch.kernels.beam_select import NEG_INF, apply_branches


def dense_scores_plain(counts, lp, prev_count, finished, beam_scores, *, eos: int, pad: int,
                       stop_at_count: int, always_allow_eos: bool):
    B, K, V = counts.shape
    tokens = torch.arange(V, dtype=torch.int32, device=counts.device).expand(B, K, V)
    allowed = apply_branches(tokens, counts > 0, prev_count, finished, eos=eos, pad=pad,
                             stop_at_count=stop_at_count, always_allow_eos=always_allow_eos)
    cons = torch.where(allowed, lp.reshape(B, K, V), NEG_INF) + beam_scores[..., None]
    return cons.reshape(B, K * V)


def dense_scores(counts, lp, prev_count, finished, beam_scores, *, eos: int, pad: int,
                 stop_at_count: int = 0, always_allow_eos: bool = False):
    """Constrained scores of every (beam, token) candidate of a step.

    ``counts`` int32 [B, K, V]: each beam's continuation counts
    (``dense_counts``); ``lp`` f32 [B*K, V]: log-probs; ``prev_count``,
    ``finished``, ``beam_scores`` [B, K].  A token is allowed by the
    reference branches (stop-forced beams: EOS only; finished beams: PAD
    only; else count > 0; ``always_allow_eos`` adds EOS).  Returns f32
    [B, K * V]: ``lp`` where allowed, else ``NEG_INF``, plus the beam score.

    CPU tensors run the plain version; CUDA tensors launch kernel 17.
    """
    B, K, V = counts.shape
    if lp.shape != (B * K, V):
        raise ValueError(f"dense_scores: lp {tuple(lp.shape)} vs counts {tuple(counts.shape)}")
    kw = dict(eos=eos, pad=pad, stop_at_count=stop_at_count, always_allow_eos=always_allow_eos)
    if not lp.is_cuda:
        return dense_scores_plain(counts, lp, prev_count, finished, beam_scores, **kw)
    from seal_tpu_torch.kernels import build

    if lp.dtype != torch.float32 or lp.stride(1) != 1:
        raise ValueError("dense_scores: lp must be f32 with unit column stride")
    if counts.dtype != torch.int32 or beam_scores.dtype != torch.float32:
        raise ValueError("dense_scores: counts must be int32 and beam_scores f32")
    counts = counts.contiguous()
    prev_count = prev_count.to(torch.int32).contiguous()
    finished = finished.to(torch.bool).contiguous()
    beam_scores = beam_scores.contiguous()
    out = torch.empty((B, K * V), dtype=torch.float32, device=lp.device)
    rc = build.lib().seal_dense_scores(
        counts.data_ptr(), lp.data_ptr(), lp.stride(0), prev_count.data_ptr(),
        finished.data_ptr(), beam_scores.data_ptr(), B * K, V, eos, pad, stop_at_count,
        int(always_allow_eos), NEG_INF, out.data_ptr(), build.stream_ptr(lp),
    )
    build.check(rc, "dense_scores")
    dense_scores.launches += 1
    return out


dense_scores.launches = 0
