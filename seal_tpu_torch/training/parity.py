"""The card against the CPU on a tiny train run: ``bart_tiny`` in f32,
trained for a few steps from the same parameters and batches on a device
(kernels 22 and 23 where it is the card) and on the CPU (their plain
versions).  ``chip_smoke.py`` and the card's tests both hold the port to
``card_against_cpu``."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from seal_tpu_torch.kernels import adamw, train_loss
from seal_tpu_torch.models.config import bart_tiny
from seal_tpu_torch.training import trainer

# losses within 1e-5 relative, params within 1e-5 absolute: cuBLAS and the
# CPU sum in other orders, and the embedding gather's backward accumulates
# with atomics on the card
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5
VOCAB = 61


def tiny_batches(steps: int = 3, seed: int = 3) -> List[Dict[str, np.ndarray]]:
    """``steps`` seeded batches of 4 pairs (sources of 12, targets of 9),
    with pad in one source and one target."""
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(steps):
        src = rng.integers(3, VOCAB, size=(4, 12)).astype(np.int32)
        sm = np.ones((4, 12), np.int32)
        src[1, 8:], sm[1, 8:] = 1, 0
        out = rng.integers(3, VOCAB, size=(4, 9)).astype(np.int32)
        out[2, 5:] = 1
        batches.append(dict(src_ids=src, src_mask=sm, tgt_out=out,
                            tgt_in=rng.integers(3, VOCAB, size=(4, 9)).astype(np.int32)))
    return batches


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return tree.to(device)


def card_against_cpu(device="cuda", steps: int = 3) -> dict:
    """Train ``bart_tiny`` (f32) for ``steps`` steps on the CPU and on
    ``device`` from the same seeded parameters and batches.  Returns each
    run's losses and launches of kernel 22's forward and kernel 23's
    update, the largest relative loss and absolute parameter differences,
    and ``ok``: both within ``LOSS_RTOL`` / ``PARAM_ATOL``."""
    cfg = bart_tiny(vocab_size=VOCAB)
    tcfg = trainer.TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    batches = tiny_batches(steps)
    runs = []
    for dev in ("cpu", device):
        params, _ = trainer.init_train_state(cfg, tcfg, seed=0, device="cpu")
        params = _tree_to(params, dev)
        step, opt = trainer.make_train_step(cfg, tcfg)
        state = opt.init(params)
        f0, u0 = train_loss.nll_forward.launches, adamw.adamw_update.launches
        losses = []
        for b in batches:
            params, state, loss = step(params, state, b)
            losses.append(loss.item())
        launched = (train_loss.nll_forward.launches - f0, adamw.adamw_update.launches - u0)
        runs.append((losses, trainer.tree_leaves(params), launched))
    (lc, pc, kc), (lg, pg, kg) = runs
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    param_err = max((a.cpu() - b).abs().max().item() for a, b in zip(pg, pc))
    return dict(cpu_losses=lc, losses=lg, cpu_launches=kc, launches=kg, loss_err=loss_err,
                param_err=param_err, ok=loss_err <= LOSS_RTOL and param_err <= PARAM_ATOL)
