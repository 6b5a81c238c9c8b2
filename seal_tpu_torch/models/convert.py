"""Parameter conversion and serving casts (counterparts of
``seal_tpu/models/convert.py:189-201`` and ``seal_tpu/models/api.py:21-49``)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from seal_tpu_torch.utils.device import DEFAULT_DEVICE, checked_device

NEG_INF = float("-inf")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def params_from_jax(np_tree, cfg, device=DEFAULT_DEVICE) -> Dict[str, Any]:
    """The JAX parameter tree, as numpy arrays (``jax.device_get``), as
    torch tensors on ``device`` (the card unless the caller asks for the
    CPU).  The layouts are the same: dense kernels stay [d_in, d_out] and
    the tied ``shared`` table stays the LM head."""
    del cfg  # the layout does not depend on the config
    device = checked_device(device)

    def leaf(a):
        return torch.as_tensor(np.array(a, copy=True)).to(device)

    return _tree_map(leaf, np_tree)


def apply_seal_logits_bias(params: Dict[str, Any], cfg) -> Dict[str, Any]:
    """Set final_logits_bias of pad/bos/mask to -inf (reference
    ``retrieval.py:584-588``); returns a new dict, ``params`` is untouched."""
    if "final_logits_bias" not in params:
        return params
    bias = params["final_logits_bias"].clone()
    for tok in (cfg.pad_token_id, cfg.bos_token_id, cfg.mask_token_id):
        if tok is not None and tok < bias.shape[0]:
            bias[tok] = NEG_INF
    out = dict(params)
    out["final_logits_bias"] = bias
    return out


def cast_params(cfg, params):
    """Serving copy: floating leaves with >= 2 dims (weight matrices,
    embedding tables) go to ``cfg.compute_dtype``; 1-D leaves (biases,
    LayerNorm scales, ``final_logits_bias``) stay f32.  No-op for f32."""
    dt = cfg.compute_dtype
    if dt == torch.float32:
        return params

    def leaf(x):
        if x.dim() >= 2 and x.is_floating_point():
            return x.to(dt)
        return x

    return _tree_map(leaf, params)
