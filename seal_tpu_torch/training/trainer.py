"""Seq2seq trainer (counterpart of ``seal_tpu/training/trainer.py``):
label-smoothed cross-entropy and optax's clipped AdamW, on the card.

The same objective and schedule as the JAX trainer (fairseq's
``label_smoothed_cross_entropy`` 0.1, lr 3e-5 with a linear warm-up then a
linear decay, global-norm clip 0.1, AdamW (0.9, 0.999) with weight decay
0.01).  The loss is kernel 22 (``kernels/train_loss.py``, forward and
backward) over the f32 logits of ``bart.decode_full``; autograd runs
through the model's dense math (GEMMs, LayerNorm, GELU, attention) in
torch; the optimizer step is kernel 23 (``kernels/adamw.py``: the global
norm, then the update, one launch each over every tensor).  On CPU tensors
both kernels run their plain versions.

``train_step`` updates the parameters and the moments in place and
returns the loss as a device tensor: a step never waits for the card.
BART only, as the JAX trainer is.  The mesh (data- and tensor-parallel
steps) is not ported: ``make_sharded_train_step`` raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from seal_tpu_torch.kernels import adamw, train_loss
from seal_tpu_torch.models import bart
from seal_tpu_torch.models.config import BartConfig
from seal_tpu_torch.utils.device import DEFAULT_DEVICE

@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-5
    warmup_steps: int = 500
    total_steps: int = 800_000
    label_smoothing: float = 0.1  # fairseq --label-smoothing 0.1
    weight_decay: float = 0.01
    adam_b1: float = 0.9
    adam_b2: float = 0.999  # fairseq --adam-betas "(0.9, 0.999)"
    max_grad_norm: float = 0.1  # fairseq --clip-norm 0.1


def label_smoothed_nll(logits, targets, pad_id: int, eps: float):
    """fairseq's label_smoothed_cross_entropy: (1-eps)*nll + eps*mean(-logp),
    over logits [..., V] and targets [...]; returns (loss, ntok), f32 0-dim
    tensors (kernel 22 on the card, its plain version on the CPU)."""
    v = logits.shape[-1]
    return train_loss.LabelSmoothedNLL.apply(logits.reshape(-1, v), targets.reshape(-1), pad_id,
                                             eps)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a parameter tree in JAX's leaf order (dict keys
    sorted, lists in order), so the global norm adds them in optax's order
    and a checkpoint lists them as the JAX package does."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _polynomial(init: float, end: float, steps: int, count: int) -> np.float32:
    """optax's ``polynomial_schedule`` at power 1, in f32 as optax computes it."""
    if steps <= 0:
        return np.float32(init)
    c = np.float32(min(max(count, 0), steps))
    frac = np.float32(1) - c / np.float32(steps)
    return np.float32(init - end) * frac + np.float32(end)


def learning_rate(tcfg: TrainConfig, count: int) -> np.float32:
    """The JAX trainer's schedule at ``count``: ``join_schedules`` of a
    linear warm-up from 0 and a linear decay to 0 at ``total_steps``."""
    w = tcfg.warmup_steps
    if count < w:
        return _polynomial(0.0, tcfg.learning_rate, w, count)
    return _polynomial(tcfg.learning_rate, 0.0, max(tcfg.total_steps - w, 1), count - w)


@dataclasses.dataclass
class OptState:
    """optax's chain state as the port keeps it: ``ScaleByAdamState``'s
    ``count``, ``mu`` and ``nu`` (trees shaped as the parameters) and the
    schedule's own ``count`` (host ints: the step's scalars need no sync)."""

    count: int
    mu: Any
    nu: Any
    schedule_count: int


class AdamW:
    """``clip_by_global_norm(max_grad_norm)`` then ``adamw(schedule, b1, b2,
    weight_decay)``, as ``seal_tpu.training.trainer.make_optimizer`` chains
    them, applied in place (kernel 23 on the card)."""

    def __init__(self, tcfg: TrainConfig):
        self.tcfg = tcfg

    def init(self, params) -> OptState:
        def zeros(tree):
            if isinstance(tree, dict):
                return {k: zeros(v) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return [zeros(v) for v in tree]
            return torch.zeros_like(tree, dtype=torch.float32)

        return OptState(count=0, mu=zeros(params), nu=zeros(params), schedule_count=0)

    def hyper(self, state: OptState) -> adamw.Hyper:
        """The step's scalars from the host's counts, each an f32 value."""
        t = self.tcfg
        f32 = np.float32
        step = min(state.count + 1, np.iinfo(np.int32).max)
        return adamw.Hyper(
            max_norm=float(f32(t.max_grad_norm)), c1=float(f32(1 - t.adam_b1)),
            b1=float(f32(t.adam_b1)), c2=float(f32(1 - t.adam_b2)), b2=float(f32(t.adam_b2)),
            bc1=float(f32(1) - f32(t.adam_b1) ** f32(step)),
            bc2=float(f32(1) - f32(t.adam_b2) ** f32(step)), eps=float(f32(1e-8)),
            wd=float(f32(t.weight_decay)),
            neg_lr=float(-learning_rate(t, state.schedule_count)))

    def update(self, grads, state: OptState, params) -> OptState:
        """Clip ``grads`` (a tree shaped as ``params``, or its leaves as a
        list) by their global norm and take the AdamW step: ``params``,
        ``state.mu`` and ``state.nu`` change in place; the counts advance.
        Returns ``state``."""
        ps, gs = tree_leaves(params), tree_leaves(grads)
        ms, vs = tree_leaves(state.mu), tree_leaves(state.nu)
        h = self.hyper(state)
        with torch.no_grad():
            norm = adamw.global_norm(gs)
            adamw.adamw_update(ps, gs, ms, vs, norm, h)
        cap = int(np.iinfo(np.int32).max)  # optax's safe_increment
        state.count = min(state.count + 1, cap)
        state.schedule_count = min(state.schedule_count + 1, cap)
        return state


def make_optimizer(tcfg: TrainConfig) -> AdamW:
    return AdamW(tcfg)


def loss_fn(model_cfg: BartConfig, params, batch, label_smoothing: float = 0.1):
    """batch: src_ids, src_mask, tgt_in (decoder inputs), tgt_out (labels),
    tensors on the parameters' device."""
    enc = bart.encode(model_cfg, params, batch["src_ids"], batch["src_mask"])
    logits = bart.decode_full(
        model_cfg, params, enc, batch["src_mask"], batch["tgt_in"],
        decoder_mask=batch.get("tgt_mask"),
    )
    loss, _ntok = label_smoothed_nll(
        logits, batch["tgt_out"], model_cfg.pad_token_id, label_smoothing
    )
    return loss


def batch_to(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as tensors on ``device``.  Host
    arrays reach the card through pinned memory without blocking (a copy
    from pageable memory may wait for the card's queue)."""
    dev = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if dev.type == "cuda" and not t.is_cuda:
            t = t.pin_memory().to(dev, non_blocking=True)
        out[k] = t.to(dev)
    return out


def make_train_step(model_cfg: BartConfig, tcfg: TrainConfig, optimizer=None):
    """(train_step, optimizer).  ``train_step(params, opt_state, batch)``
    returns ``(params, opt_state, loss)`` as JAX's does; the parameters and
    moments are updated in place and the loss is a 0-dim device tensor."""
    optimizer = optimizer or make_optimizer(tcfg)

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        batch = batch_to(batch, leaves[0].device)
        try:
            with torch.enable_grad():
                for p in leaves:
                    p.requires_grad_(True)
                loss = loss_fn(model_cfg, params, batch, tcfg.label_smoothing)
                grads = torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, loss.detach()

    return train_step, optimizer


def make_sharded_train_step(model_cfg: BartConfig, tcfg: TrainConfig, mesh,
                            tensor_parallel: bool = True):
    """Not ported: the data- and tensor-parallel step over a mesh of cards."""
    raise NotImplementedError(
        "not ported to seal_tpu_torch yet: the sharded train step (the mesh across cards, "
        "ROADMAP.md A.7); make_train_step trains on one device"
    )


def init_train_state(model_cfg: BartConfig, tcfg: TrainConfig, seed: int = 0,
                     device=DEFAULT_DEVICE):
    """Random f32 parameters from ``seed`` (``bart.init_params``) on
    ``device`` (the card unless the caller asks for the CPU; raises where
    no CUDA device exists) and the optimizer's zero state."""
    params = bart.init_params(model_cfg, seed, device)
    return params, make_optimizer(tcfg).init(params)
