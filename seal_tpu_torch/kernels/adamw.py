"""Kernel 23 wrapper: optax's global-norm clip and AdamW over every
parameter tensor (``csrc/adamw.cu``), with its plain versions.

Replaces the chain of ``seal_tpu/training/trainer.py:make_optimizer``
(:49-66), ``clip_by_global_norm(max_norm)`` then ``adamw(schedule, b1, b2,
weight_decay=wd)``, as ``make_train_step`` applies it (:88-90).  Two
modes, one launch each over a table of every tensor:

* ``global_norm(grads)``: sqrt of the sum of every gradient's squares, a
  0-dim f32 tensor left on the device;
* ``adamw_update(params, grads, mu, nu, norm, hyper)``: the clipped AdamW
  step, in place on ``params``, ``mu`` and ``nu``.

The clip is optax's ``select(norm < max_norm, g, (g / norm) * max_norm)``,
not ``clip_grad_norm_``'s division by ``norm + 1e-6``, and the weight decay
is optax's ``+ wd * p`` in the update, not torch's ``p * (1 - lr * wd)``
before it: ``torch.optim.AdamW`` computes another function.

The host computes the step's scalars (``Hyper``: lr from the schedule,
the bias corrections from its own count) with no sync.  The update rounds
each operation on its own, as the plain version does, so on the same norm
the two agree bit for bit where torch divides as IEEE does (the plain
version divides by 0-dim tensors, never by a Python scalar, which torch
would turn into a multiplication by its reciprocal on the card).  The
kernel's norm sums in another order than the plain version's: they agree
to f32 rounding of the sum.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Hyper:
    """One step's scalars, each an f32 value: ``c1 = 1 - b1``, ``c2 = 1 -
    b2``, ``bc1 = 1 - b1^t``, ``bc2 = 1 - b2^t`` (t = count + 1) and
    ``neg_lr`` = -(the schedule at count)."""

    max_norm: float
    c1: float
    b1: float
    c2: float
    b2: float
    bc1: float
    bc2: float
    eps: float
    wd: float
    neg_lr: float


def global_norm_plain(grads):
    """optax's ``global_norm``: the per-tensor sums of squares added in the
    tensors' order, then the square root."""
    total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for g in grads:
        total = total + g.float().square().sum()
    return total.sqrt()


def adamw_update_plain(params, grads, mu, nu, norm, h: Hyper):
    """The clipped AdamW step with torch ops, in place on ``params``, ``mu``
    and ``nu`` (lists of f32 tensors); ``norm`` a 0-dim tensor."""
    dev = norm.device
    bc1 = torch.full((), h.bc1, dtype=torch.float32, device=dev)
    bc2 = torch.full((), h.bc2, dtype=torch.float32, device=dev)
    keep = norm < h.max_norm
    for p, g, m, v in zip(params, grads, mu, nu):
        g = torch.where(keep, g, (g / norm) * h.max_norm)
        m.copy_(h.c1 * g + h.b1 * m)
        v.copy_(h.c2 * (g * g) + h.b2 * v)
        u = (m / bc1) / (torch.sqrt(v / bc2) + h.eps) + h.wd * p
        p.add_(h.neg_lr * u)


def _checked(name, *lists):
    """The tensors of each list with elements (all on one CUDA device, f32,
    contiguous, 16-byte aligned, the lists' shapes equal)."""
    ref = lists[0]
    keep = [i for i, t in enumerate(ref) if t.numel() > 0]
    if not keep:
        raise ValueError(f"{name}: no tensor with elements")
    dev = ref[keep[0]].device
    for lst in lists:
        if len(lst) != len(ref):
            raise ValueError(f"{name}: lists of {len(lst)} and {len(ref)} tensors")
        for i in keep:
            t = lst[i]
            if (t.device != dev or t.dtype != torch.float32 or not t.is_contiguous()
                    or t.shape != ref[i].shape):
                raise ValueError(f"{name}: tensor {i} must be f32, contiguous, on {dev}, "
                                 f"of shape {tuple(ref[i].shape)}")
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: tensor {i} is not 16-byte aligned")
    return [[lst[i] for i in keep] for lst in lists]


def _table(tensors):
    return (ctypes.c_ulonglong * len(tensors))(*(t.data_ptr() for t in tensors))


def _sizes(tensors, lib):
    if len(tensors) > lib.seal_adamw_max_tensors():
        raise ValueError(f"adamw: {len(tensors)} tensors, at most "
                         f"{lib.seal_adamw_max_tensors()} in one launch")
    return (ctypes.c_longlong * len(tensors))(*(t.numel() for t in tensors))


def global_norm(grads):
    """The global norm of ``grads`` (a list of f32 tensors), a 0-dim f32
    tensor on their device.

    CPU tensors run the plain version; CUDA tensors launch kernel 23's norm
    mode (one launch over every tensor).
    """
    if not grads[0].is_cuda:
        return global_norm_plain(grads)
    from seal_tpu_torch.kernels import build

    (gs,) = _checked("global_norm", grads)
    lib = build.lib()
    sizes = _sizes(gs, lib)
    ptrs = _table(gs)
    dev = gs[0].device
    blocks = lib.seal_adamw_blocks(ctypes.addressof(sizes), len(gs))
    partial = torch.empty(blocks, dtype=torch.float32, device=dev)
    norm = torch.empty((), dtype=torch.float32, device=dev)
    rc = lib.seal_adamw_norm(ctypes.addressof(ptrs), ctypes.addressof(sizes), len(gs),
                             partial.data_ptr(), norm.data_ptr(), build.stream_ptr(norm))
    build.check(rc, "global_norm")
    global_norm.launches += 1
    return norm


def adamw_update(params, grads, mu, nu, norm, h: Hyper):
    """The clipped AdamW step, in place on ``params``, ``mu`` and ``nu``.

    CPU tensors run the plain version; CUDA tensors launch kernel 23's
    update mode (one launch over every tensor).
    """
    if not params[0].is_cuda:
        return adamw_update_plain(params, grads, mu, nu, norm, h)
    from seal_tpu_torch.kernels import build

    ps, gs, ms, vs = _checked("adamw_update", params, grads, mu, nu)
    if norm.device != ps[0].device or norm.dtype != torch.float32 or norm.numel() != 1:
        raise ValueError("adamw_update: norm must be one f32 value on the params' device")
    lib = build.lib()
    sizes = _sizes(ps, lib)
    tables = [_table(t) for t in (ps, gs, ms, vs)]
    rc = lib.seal_adamw_update(
        *(ctypes.addressof(t) for t in tables), ctypes.addressof(sizes), len(ps),
        norm.data_ptr(), h.max_norm, h.c1, h.b1, h.c2, h.b2, h.bc1, h.bc2, h.eps, h.wd,
        h.neg_lr, build.stream_ptr(norm))
    build.check(rc, "adamw_update")
    adamw_update.launches += 1


global_norm.launches = 0
adamw_update.launches = 0
