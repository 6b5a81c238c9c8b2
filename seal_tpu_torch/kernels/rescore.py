"""Kernel 7 wrapper: the per-key LM score of key rescoring
(``csrc/rescore.cu``).

Replaces the reduction of ``seal_tpu/scoring/keys.py:_jitted_rescore``
(:102): per key, the target logit minus the row's logsumexp, zero where the
target is below 2 (bos, pad), summed over positions ``n_prefix`` and on.
The kernel sums in position order with fixed reduction trees, so its
result repeats exactly from run to run; it agrees with the plain version
to f32 rounding (the row sums are taken in another order).
"""

from __future__ import annotations

import torch


def rescore_logprob_plain(logits, targets, n_prefix: int):
    tok = logits.gather(-1, targets.long()[..., None])[..., 0] - torch.logsumexp(logits, -1)
    tok = torch.where(targets < 2, 0.0, tok)
    return tok[:, n_prefix:].sum(-1)


def rescore_logprob(logits, targets, n_prefix: int):
    """logits f32 [N, T, V], targets int [N, T] (ids < V): f32 [N], the
    sum over t >= ``n_prefix`` of log_softmax(logits[:, t])[targets[:, t]],
    with the terms of targets < 2 set to zero.

    CPU tensors run the plain version; CUDA tensors launch kernel 7.
    """
    if logits.dim() != 3 or targets.shape != logits.shape[:2]:
        raise ValueError(f"rescore_logprob: logits {tuple(logits.shape)} vs targets "
                         f"{tuple(targets.shape)}")
    if not logits.is_cuda:
        return rescore_logprob_plain(logits, targets, n_prefix)
    from seal_tpu_torch.kernels import build

    if logits.dtype != torch.float32:
        raise ValueError(f"rescore_logprob: f32 logits required, got {logits.dtype}")
    N, T, V = logits.shape
    logits = logits.contiguous()
    targets = targets.to(torch.int32).contiguous()
    out = torch.empty(N, dtype=torch.float32, device=logits.device)
    rc = build.lib().seal_rescore_logprob(
        logits.data_ptr(), targets.data_ptr(), out.data_ptr(), N, T, V, n_prefix,
        build.stream_ptr(logits),
    )
    build.check(rc, "rescore_logprob")
    rescore_logprob.launches += 1
    return out


rescore_logprob.launches = 0
