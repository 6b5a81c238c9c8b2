"""Parameter conversion and serving casts (counterparts of
``seal_tpu/models/convert.py:138-201`` and ``seal_tpu/models/api.py:21-49``).

``from_hf_t5_state_dict`` converts a HF ``T5ForConditionalGeneration``
state dict (torch tensors; neither transformers nor jax is needed) to the
T5 tree of ``models/t5.py``, as the JAX converter does: q/k/v/o and
wi/wi_0/wi_1/wo transposed to [d_in, d_out], each stack's layer-0
``relative_attention_bias``, ``shared.weight``.  Like the JAX converter it
never reads ``lm_head.weight``: an untied checkpoint (T5 v1.1, flan-T5,
mT5) is served against its input embedding table, as in the JAX package.
"""

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


def opt_state_from_jax(np_state, device=DEFAULT_DEVICE):
    """optax's chain state of ``seal_tpu.training.trainer.make_optimizer``
    (as numpy, ``jax.device_get``): ``(EmptyState(), (ScaleByAdamState(count,
    mu, nu), EmptyState(), ScaleByScheduleState(count)))``, as the port's
    ``OptState`` on ``device`` (the card unless the caller asks for the
    CPU)."""
    from seal_tpu_torch.training.trainer import OptState

    adam, _decay, schedule = np_state[1]
    return OptState(count=int(adam.count), mu=params_from_jax(adam.mu, None, device),
                    nu=params_from_jax(adam.nu, None, device),
                    schedule_count=int(schedule.count))


def from_hf_t5_state_dict(sd: Dict[str, Any], cfg, device=DEFAULT_DEVICE) -> Dict[str, Any]:
    """A HF ``T5ForConditionalGeneration.state_dict()`` as the port's T5
    tree, f32 on ``device`` (the card unless the caller asks for the CPU)."""
    device = checked_device(device)
    gated = cfg.feed_forward_proj == "gated-gelu"

    def t(key, transpose=False):
        a = sd[key].detach().to(device=device, dtype=torch.float32)
        return a.T.contiguous() if transpose else a.clone()

    def attn(prefix):
        return {n: t(f"{prefix}.{n}.weight", True) for n in ("q", "k", "v", "o")}

    def ffn(prefix):
        names = ("wi_0", "wi_1", "wo") if gated else ("wi", "wo")
        return {n: t(f"{prefix}.{n}.weight", True) for n in names}

    def stack(side: str, cross: bool):
        layers = []
        for i in range(cfg.num_layers):
            b = f"{side}.block.{i}.layer"
            p = {"self_attn": attn(f"{b}.0.SelfAttention"),
                 "ln_self": t(f"{b}.0.layer_norm.weight")}
            if cross:
                p["cross_attn"] = attn(f"{b}.1.EncDecAttention")
                p["ln_cross"] = t(f"{b}.1.layer_norm.weight")
            f = 2 if cross else 1
            p["ffn"] = ffn(f"{b}.{f}.DenseReluDense")
            p["ln_ffn"] = t(f"{b}.{f}.layer_norm.weight")
            layers.append(p)
        return {
            "rel_bias": t(f"{side}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
            "layers": layers,
            "final_ln": t(f"{side}.final_layer_norm.weight"),
        }

    return {"shared": t("shared.weight"), "encoder": stack("encoder", False),
            "decoder": stack("decoder", True)}


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
