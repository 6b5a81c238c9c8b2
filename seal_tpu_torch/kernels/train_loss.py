"""Kernel 22 wrapper: the label-smoothed NLL of training, forward and
backward (``csrc/train_loss.cu``), with its plain versions.

Replaces ``seal_tpu/training/trainer.py:label_smoothed_nll`` (:38-46) and
its gradient under ``jax.value_and_grad`` (:85-87): fairseq's
label-smoothed cross-entropy over f32 logits, masked by ``targets !=
pad_id`` and divided by ``max(ntok, 1)``, so an all-pad batch gives 0 (not
the NaN of ``F.cross_entropy(reduction="mean")``).

``LabelSmoothedNLL`` is the autograd function: its forward keeps each
row's log-sum-exp, and its backward writes the closed-form gradient

    g * m_n / max(ntok, 1) * (softmax(x_n) - (1 - eps) onehot(t_n) - eps / V)

into a fresh tensor.  Writing it over the logits would save their 4 N V
bytes, but is not safe under autograd in general: a caller may still hold
the logits (``decode_full`` returns them), so the backward never does.

The forward sums the row losses with a fixed tree and no float atomics,
so the loss repeats bit for bit from run to run; it agrees with the plain
version to f32 rounding of a V-wide log-sum-exp (the sums are taken in
another order).
"""

from __future__ import annotations

import torch


def label_smoothed_nll_plain(logits, targets, pad_id: int, eps: float):
    """JAX's formula in torch: f32 ``log_softmax``, the target's NLL and the
    mean over V, masked by pad.  Returns (loss, ntok), f32 0-dim; autograd
    gives its gradient."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    nll = -lp.gather(-1, targets.long()[..., None])[..., 0]
    smooth = -lp.mean(dim=-1)
    mask = (targets != pad_id).float()
    loss = (1.0 - eps) * nll + eps * smooth
    ntok = mask.sum().clamp(min=1.0)
    return (loss * mask).sum() / ntok, ntok


def nll_backward_plain(logits, targets, lse, ntok, gout, pad_id: int, eps: float):
    """The closed-form gradient wrt ``logits`` [N, V] of the loss, given each
    row's log-sum-exp ``lse`` [N], ``ntok`` and the upstream gradient
    ``gout`` (0-dim tensors)."""
    x = logits.float()
    V = x.shape[-1]
    scale = gout * (targets != pad_id).float() / ntok
    grad = torch.exp(x - lse[:, None]) - eps / V
    hit = torch.zeros_like(grad).scatter_(-1, targets.long()[:, None], 1.0 - eps)
    return (grad - hit) * scale[:, None]


def _check(logits, targets):
    if logits.dim() != 2 or targets.shape != logits.shape[:1]:
        raise ValueError(f"label_smoothed_nll: logits {tuple(logits.shape)} vs targets "
                         f"{tuple(targets.shape)}: want [N, V] and [N]")


def _checked_cuda(logits):
    """The contiguous f32 logits, refused unless 16-byte aligned: the
    backward's gradient (a fresh, aligned tensor) then shares each row's
    layout of 16-byte accesses (``csrc/train_loss.cu``)."""
    if logits.dtype != torch.float32:
        raise ValueError(f"label_smoothed_nll: f32 logits required, got {logits.dtype}")
    logits = logits.contiguous()
    if logits.data_ptr() % 16:
        raise ValueError("label_smoothed_nll: logits are not 16-byte aligned")
    return logits



def nll_forward(logits, targets, pad_id: int, eps: float):
    """logits f32 [N, V], targets int [N]: (loss, ntok, lse) with loss and
    ntok f32 0-dim and lse f32 [N] (0 on pad rows in the kernel).

    CPU tensors run the plain version; CUDA tensors launch kernel 22's
    forward (one launch; a target outside [0, V) that is not ``pad_id``
    stops it with a CUDA error, as torch's own gather does on the card).
    """
    _check(logits, targets)
    if not logits.is_cuda:
        loss, ntok = label_smoothed_nll_plain(logits, targets, pad_id, eps)
        return loss, ntok, torch.logsumexp(logits.float(), dim=-1)
    from seal_tpu_torch.kernels import build

    logits = _checked_cuda(logits)
    N, V = logits.shape
    targets = targets.to(torch.int32).contiguous()
    dev = logits.device
    lse = torch.empty(N, dtype=torch.float32, device=dev)
    row_loss = torch.empty(N, dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    ntok = torch.empty((), dtype=torch.float32, device=dev)
    rc = build.lib().seal_nll_forward(
        logits.data_ptr(), targets.data_ptr(), N, V, pad_id, eps, lse.data_ptr(),
        row_loss.data_ptr(), loss.data_ptr(), ntok.data_ptr(), build.stream_ptr(logits))
    build.check(rc, "nll_forward")
    nll_forward.launches += 1
    return loss, ntok, lse


def nll_backward(logits, targets, lse, ntok, gout, pad_id: int, eps: float):
    """The gradient wrt ``logits`` [N, V] (a fresh f32 tensor) from the
    forward's ``lse`` and ``ntok`` and the upstream gradient ``gout``
    (0-dim, read on the device: no host sync).

    CPU tensors run the plain version; CUDA tensors launch kernel 22's
    backward (one launch).
    """
    _check(logits, targets)
    if not logits.is_cuda:
        return nll_backward_plain(logits, targets, lse, ntok, gout, pad_id, eps)
    from seal_tpu_torch.kernels import build

    logits = _checked_cuda(logits)
    N, V = logits.shape
    targets = targets.to(torch.int32).contiguous()
    gout = gout.to(torch.float32).contiguous()
    grad = torch.empty_like(logits)
    rc = build.lib().seal_nll_backward(
        logits.data_ptr(), targets.data_ptr(), lse.data_ptr(), ntok.data_ptr(), gout.data_ptr(),
        N, V, pad_id, eps, grad.data_ptr(), build.stream_ptr(logits))
    build.check(rc, "nll_backward")
    nll_backward.launches += 1
    return grad


nll_forward.launches = 0
nll_backward.launches = 0


class LabelSmoothedNLL(torch.autograd.Function):
    """(loss, ntok) = label-smoothed NLL of f32 ``logits`` [N, V] against
    ``targets`` [N]; ``ntok`` is not differentiable."""

    @staticmethod
    def forward(ctx, logits, targets, pad_id: int, eps: float):
        loss, ntok, lse = nll_forward(logits, targets, pad_id, eps)
        ctx.save_for_backward(logits, targets, lse, ntok)
        ctx.pad_id, ctx.eps = pad_id, eps
        ctx.mark_non_differentiable(ntok)
        return loss, ntok

    @staticmethod
    def backward(ctx, gout, _gntok):
        logits, targets, lse, ntok = ctx.saved_tensors
        grad = nll_backward(logits, targets, lse, ntok, gout, ctx.pad_id, ctx.eps)
        return grad.to(logits.dtype), None, None, None
