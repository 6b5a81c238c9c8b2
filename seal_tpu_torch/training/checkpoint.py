"""Checkpoint save/restore of the training state (counterpart of
``seal_tpu/training/checkpoint.py``), in the JAX package's npz layout.

``<path>/step_<N>.npz`` holds the parameters and the optimizer state under
the keys the JAX package's ``_flatten`` gives them (``['params']/['shared']``,
``['opt_state']/[1]/[0]/.mu/...``: optax's chain state), and
``<path>/latest.json`` names the newest step.  So the JAX package's npz
route restores a checkpoint written here, and this module restores one the
JAX package wrote to npz.  There is no orbax (the machine with the card has
none): an orbax directory is refused.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from seal_tpu_torch.training.trainer import OptState

# optax's chain state of make_optimizer: (clip, (adam, decay, schedule))
_ADAM = "[1]/[0]"
_SCHEDULE = "[1]/[2]"


def _flatten(tree, prefix: str, out: Dict[str, Any]) -> None:
    """JAX's key paths: ``['key']`` for a dict entry (keys sorted), ``[i]``
    for a list entry, ``.name`` for a named-tuple field, joined by ``/``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}/[{k!r}]", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/[{i}]", out)
    else:
        out[prefix.lstrip("/")] = tree


def _state_leaves(params, opt_state: Optional[OptState]) -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    _flatten(params, "['params']", flat)
    if opt_state is not None:
        flat[f"['opt_state']/{_ADAM}/.count"] = opt_state.count
        _flatten(opt_state.mu, f"['opt_state']/{_ADAM}/.mu", flat)
        _flatten(opt_state.nu, f"['opt_state']/{_ADAM}/.nu", flat)
        flat[f"['opt_state']/{_SCHEDULE}/.count"] = opt_state.schedule_count
    return flat


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.int32)  # a count, int32 as optax keeps it


def save_checkpoint(path: str, step: int, params, opt_state: Optional[OptState] = None,
                    keep: int = 3):
    """Write ``<path>/step_<N>.npz`` and ``latest.json``, then keep the
    newest ``keep`` steps."""
    os.makedirs(path, exist_ok=True)
    flat = {k: _numpy(v) for k, v in _state_leaves(params, opt_state).items()}
    target = os.path.join(path, f"step_{step}")
    tmp = f"{target}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, target + ".npz")
    with open(os.path.join(path, "latest.json"), "w") as f:
        json.dump({"step": step}, f)
    _prune(path, keep)


def _prune(path: str, keep: int):
    steps = sorted(
        int(d.split("_")[1].split(".")[0])
        for d in os.listdir(path)
        if d.startswith("step_") and ".tmp" not in d
    )
    for s in steps[:-keep] if keep > 0 else []:
        for suffix in ("", ".npz"):
            p = os.path.join(path, f"step_{s}{suffix}")
            if os.path.isdir(p):
                shutil.rmtree(p)
            elif os.path.exists(p):
                os.remove(p)


def latest_step(path: str) -> Optional[int]:
    meta = os.path.join(path, "latest.json")
    if not os.path.exists(meta):
        return None
    with open(meta) as f:
        return json.load(f)["step"]


def restore_checkpoint(path: str, template) -> Tuple[int, Dict[str, Any]]:
    """Restore the newest checkpoint into the structure of ``template``
    ({"params": ..., "opt_state": ...}; ``opt_state`` may be left out):
    every tensor on its template tensor's device and dtype.  Returns
    (step, state)."""
    step = latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    target = os.path.join(path, f"step_{step}")
    if os.path.isdir(target):
        raise NotImplementedError(f"{target} is an orbax checkpoint; seal_tpu_torch reads the "
                                  "npz layout only")
    opt = template.get("opt_state")
    want = _state_leaves(template["params"], opt)
    with np.load(target + ".npz") as data:
        if set(data.files) != set(want):
            diff = sorted(set(data.files) ^ set(want))
            raise ValueError(f"checkpoint/template mismatch: {diff[:4]}")
        arrays = {k: data[k] for k in want}

    def build(tree, prefix):
        if isinstance(tree, dict):
            return {k: build(tree[k], f"{prefix}/[{k!r}]") for k in tree}
        if isinstance(tree, (list, tuple)):
            return [build(v, f"{prefix}/[{i}]") for i, v in enumerate(tree)]
        a = arrays[prefix.lstrip("/")]
        return torch.as_tensor(np.array(a, copy=True)).to(device=tree.device, dtype=tree.dtype)

    state = {"params": build(template["params"], "['params']")}
    if opt is not None:
        state["opt_state"] = OptState(
            count=int(arrays[f"['opt_state']/{_ADAM}/.count"]),
            mu=build(opt.mu, f"['opt_state']/{_ADAM}/.mu"),
            nu=build(opt.nu, f"['opt_state']/{_ADAM}/.nu"),
            schedule_count=int(arrays[f"['opt_state']/{_SCHEDULE}/.count"]))
    return step, state
