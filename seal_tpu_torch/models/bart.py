"""BART encoder-decoder as plain functions over a parameter dict of torch
tensors (counterpart of ``seal_tpu/models/bart.py``).

The parameter tree has the JAX package's layout -- dense ``kernel`` is
[d_in, d_out], the tied ``shared`` table is also the LM head,
``final_logits_bias`` is a [V] row -- so ``convert.params_from_jax`` is a
leaf-by-leaf copy.  Semantics follow the JAX module: learned positions with
a +2 offset, post-LayerNorm blocks with LayerNorm in f32 (eps 1e-5),
exact (erf) GELU, attention scores and softmax in f32, and grouped decode
cross-attention over per-query K/V.  Inference only.

The decode step's attentions and the beam reorder of its cache are kernels
(``kernels/decode_attention.py``: 9 cross, 10 self; ``kernels/
reorder_cache.py``: 11, through ``models/common.py``, which both families
share with the tied head's matmul).  The encoder and ``decode_full`` keep the generic
``_attention``: plain large products over whole sequences, which the JAX
package also leaves to XLA outside any kernel.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from seal_tpu_torch.kernels import decode_attention
from seal_tpu_torch.models.common import reorder_cache, tied_head  # noqa: F401 (re-exported)
from seal_tpu_torch.models.config import BartConfig
from seal_tpu_torch.utils.device import DEFAULT_DEVICE, checked_device

Params = Dict[str, Any]

NEG_INF = -1e9  # attention-mask bias (not the constrained decoder's constant)


# ----------------------------------------------------------------- init


def init_params(cfg: BartConfig, seed: int = 0, device=DEFAULT_DEVICE) -> Params:
    """Random f32 parameters from a seeded ``torch.Generator`` (N(0, 0.02)
    matrices, zero biases, unit LayerNorm scales), in the JAX layout, on
    ``device`` (the card unless the caller asks for the CPU)."""
    device = checked_device(device)
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=device) * 0.02

    def zeros(n):
        return torch.zeros(n, device=device)

    def dense(d_in, d_out):
        return {"kernel": normal(d_in, d_out), "bias": zeros(d_out)}

    def ln(d):
        return {"scale": torch.ones(d, device=device), "bias": zeros(d)}

    def attn(d):
        return {n: dense(d, d) for n in ("q", "k", "v", "o")}

    def layer(cross: bool):
        ffn = cfg.decoder_ffn_dim if cross else cfg.encoder_ffn_dim
        d = cfg.d_model
        p = {
            "self_attn": attn(d),
            "self_attn_ln": ln(d),
            "fc1": dense(d, ffn),
            "fc2": dense(ffn, d),
            "final_ln": ln(d),
        }
        if cross:
            p["cross_attn"] = attn(d)
            p["cross_attn_ln"] = ln(d)
        return p

    n_pos = cfg.max_position_embeddings + cfg.position_offset
    return {
        "shared": normal(cfg.vocab_size, cfg.d_model),
        "final_logits_bias": zeros(cfg.vocab_size),
        "encoder": {
            "embed_positions": normal(n_pos, cfg.d_model),
            "layernorm_embedding": ln(cfg.d_model),
            "layers": [layer(False) for _ in range(cfg.encoder_layers)],
        },
        "decoder": {
            "embed_positions": normal(n_pos, cfg.d_model),
            "layernorm_embedding": ln(cfg.d_model),
            "layers": [layer(True) for _ in range(cfg.decoder_layers)],
        },
    }


# ------------------------------------------------------------- building


def _ln(p, x, eps=1e-5):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def _dense(p, x):
    return x @ p["kernel"].to(x.dtype) + p["bias"].to(x.dtype)


def _split_heads(x, n_heads):
    b, l, d = x.shape
    return x.reshape(b, l, n_heads, d // n_heads)


def _merge_heads(x):
    b, l, h, dh = x.shape
    return x.reshape(b, l, h * dh)


def _query(p, x_q, n_heads):
    return _split_heads(_dense(p["q"], x_q) * (1.0 / math.sqrt(x_q.shape[-1] // n_heads)), n_heads)


def _attention(p, x_q, kv, bias, n_heads, dtype):
    """Multi-head attention over projected, split (k, v)."""
    q = _query(p, x_q, n_heads)
    k, v = kv
    scores = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float())
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1).to(dtype)
    out = torch.einsum("bhlm,bmhd->blhd", probs, v)
    return _dense(p["o"], _merge_heads(out))


def _cross_attention_step(p, x_q, kv, bias, n_heads):
    """Decode-step cross-attention with PER-QUERY K/V [Bq, M, H, Dh]: the
    beams of a query share its encoder K/V, so the beam axis becomes the
    query axis of one grouped attention (kernel 9; one beam per query at
    step 0)."""
    k, v = kv
    b = x_q.shape[0]
    q = _query(p, x_q, n_heads)[:, 0]  # [b, H, Dh]
    bias2 = bias.reshape(k.shape[0], k.shape[1]) if bias is not None else None
    out = decode_attention.cross_attention_step(q, k, v, bias2)
    return _dense(p["o"], out.reshape(b, 1, -1))


def _project_kv(p, x, n_heads):
    return _split_heads(_dense(p["k"], x), n_heads), _split_heads(_dense(p["v"], x), n_heads)


def _ffn(p, x):
    return _dense(p["fc2"], F.gelu(_dense(p["fc1"], x)))


def _padding_bias(mask):
    """[B, L] 1/0 mask -> additive f32 [B, 1, 1, L] bias."""
    bias = torch.where(mask[:, None, None, :] > 0, 0.0, NEG_INF)
    return bias.to(torch.float32)


def _embed(cfg: BartConfig, table, pos_table, ids, ln, positions):
    dt = cfg.compute_dtype
    scale = math.sqrt(cfg.d_model) if cfg.scale_embedding else 1.0
    x = table[ids.long()].to(dt) * scale
    x = x + pos_table[(positions + cfg.position_offset).long()].to(dt)
    return _ln(ln, x)


# -------------------------------------------------------------- encoder


def encode(cfg: BartConfig, params: Params, input_ids, attention_mask):
    """Encoder forward.  input_ids/attention_mask: int [B, L] -> [B, L, D]."""
    enc = params["encoder"]
    l = input_ids.shape[1]
    positions = torch.arange(l, device=input_ids.device)[None, :]
    x = _embed(cfg, params["shared"], enc["embed_positions"], input_ids,
               enc["layernorm_embedding"], positions)
    bias = _padding_bias(attention_mask)
    n_heads = cfg.encoder_attention_heads
    for p in enc["layers"]:
        kv = _project_kv(p["self_attn"], x, n_heads)
        h = _attention(p["self_attn"], x, kv, bias, n_heads, cfg.compute_dtype)
        x = _ln(p["self_attn_ln"], x + h)
        x = _ln(p["final_ln"], x + _ffn(p, x))
    return x


# -------------------------------------------------------------- decoder


def encoder_bias(enc_mask):
    """Additive cross-attention bias from the encoder padding mask."""
    return _padding_bias(enc_mask)


def precompute_cross_kv(cfg: BartConfig, params: Params, enc_out):
    """Cross-attention K/V projected once per query."""
    return [
        _project_kv(p["cross_attn"], enc_out, cfg.decoder_attention_heads)
        for p in params["decoder"]["layers"]
    ]


def empty_self_cache(cfg: BartConfig, batch: int, max_len: int, device=DEFAULT_DEVICE):
    device = checked_device(device)
    h, dh = cfg.decoder_attention_heads, cfg.head_dim

    def z():
        return torch.zeros((batch, max_len, h, dh), dtype=cfg.compute_dtype, device=device)

    return [{"k": z(), "v": z()} for _ in range(cfg.decoder_layers)]


def decode_step(cfg: BartConfig, params: Params, token_ids, step: int, self_cache,
                cross_kv, enc_bias):
    """One incremental decoder step; returns (logits f32 [B, V], self_cache).

    ``self_cache`` is updated IN PLACE at column ``step`` (and returned):
    the beam search replaces it by a reordered copy after every step, so no
    caller sees the old cache again.
    """
    dec = params["decoder"]
    n_heads = cfg.decoder_attention_heads
    b = token_ids.shape[0]
    max_len = self_cache[0]["k"].shape[1]
    dev = token_ids.device
    if not 0 <= step < max_len:
        raise ValueError(f"decode_step: step {step} outside a cache of {max_len} slots")
    positions = torch.full((b, 1), step, dtype=torch.int32, device=dev)
    x = _embed(cfg, params["shared"], dec["embed_positions"], token_ids[:, None],
               dec["layernorm_embedding"], positions)
    for p, sc, ckv in zip(dec["layers"], self_cache, cross_kv):
        k_new, v_new = _project_kv(p["self_attn"], x, n_heads)  # [B,1,H,Dh]
        sc["k"][:, step] = k_new[:, 0].to(sc["k"].dtype)
        sc["v"][:, step] = v_new[:, 0].to(sc["v"].dtype)
        q = _query(p["self_attn"], x, n_heads)[:, 0]  # [B, H, Dh]
        h = decode_attention.self_attention_step(q, sc["k"], sc["v"], step)  # kernel 10
        x = _ln(p["self_attn_ln"], x + _dense(p["self_attn"]["o"], h.reshape(b, 1, -1)))
        h = _cross_attention_step(p["cross_attn"], x, ckv, enc_bias, n_heads)
        x = _ln(p["cross_attn_ln"], x + h)
        x = _ln(p["final_ln"], x + _ffn(p, x))
    return lm_logits(cfg, params, x[:, 0, :]), self_cache


def decode_full(cfg: BartConfig, params: Params, enc_out, enc_mask, decoder_input_ids,
                decoder_mask=None):
    """Teacher-forced decoder forward: f32 logits [B, L, V] (key rescoring
    and unigram scores).  A causal mask over the decoder ids (plus their
    padding bias when ``decoder_mask`` is given) and full cross-attention
    over the encoder output."""
    dec = params["decoder"]
    n_heads = cfg.decoder_attention_heads
    l = decoder_input_ids.shape[1]
    dev = decoder_input_ids.device
    positions = torch.arange(l, device=dev)[None, :]
    x = _embed(cfg, params["shared"], dec["embed_positions"], decoder_input_ids,
               dec["layernorm_embedding"], positions)
    rows = torch.arange(l, device=dev)
    causal = torch.where(rows[:, None] >= rows[None, :], 0.0, NEG_INF)
    causal = causal.to(torch.float32)[None, None]  # [1, 1, L(query), L(key)]
    if decoder_mask is not None:
        causal = causal + _padding_bias(decoder_mask)
    enc_bias = _padding_bias(enc_mask)
    for p, ckv in zip(dec["layers"], precompute_cross_kv(cfg, params, enc_out)):
        kv = _project_kv(p["self_attn"], x, n_heads)
        h = _attention(p["self_attn"], x, kv, causal, n_heads, cfg.compute_dtype)
        x = _ln(p["self_attn_ln"], x + h)
        h = _attention(p["cross_attn"], x, ckv, enc_bias, n_heads, cfg.compute_dtype)
        x = _ln(p["cross_attn_ln"], x + h)
        x = _ln(p["final_ln"], x + _ffn(p, x))
    return lm_logits(cfg, params, x)


def lm_logits(cfg: BartConfig, params: Params, hidden):
    """Tied LM head: hidden @ shared.T + final_logits_bias, f32 out
    (``tied_head``)."""
    return tied_head(cfg, params["shared"], hidden) + params["final_logits_bias"]
