"""T5 encoder-decoder as plain functions over a parameter dict of torch
tensors (counterpart of ``seal_tpu/models/t5.py``).

The second backbone family, with BART's interface (``init_params`` /
``encode`` / ``decode_full`` / ``decode_step`` / caches), so the
constrained decoder and the scorers reach either through
``models/api.py:module_for``.  The parameter tree has the JAX package's
layout (``q``/``k``/``v``/``o`` and ``wi``/``wi_0``/``wi_1``/``wo``
matrices [d_in, d_out], one ``rel_bias`` table [num_buckets, H] per
stack), so ``convert.params_from_jax`` is a leaf-by-leaf copy.

Semantics follow the JAX module: RMSNorm pre-norm blocks (f32 variance,
eps 1e-6), bias-free linears, un-scaled attention with f32 scores and
softmax, bucketed relative position bias (bidirectional in the encoder,
unidirectional in the decoder), relu or gated-gelu (tanh) FFN, tied
embeddings with the d_model^-0.5 logit scaling.  Inference only.

The decode step's attentions go through kernels 9 (grouped cross, fed an
un-scaled query) and 10's relative-position-bias mode (which adds
``table[bucket[step - j], h]`` itself, so no [1, H, 1, max_len] bias is
built per step); the cache reorder is kernel 11, shared with BART.  The
encoder and ``decode_full`` stay plain torch, as the JAX package leaves
them to XLA.

Bucket indices are computed on the CPU in f32 with ``_relative_bucket`` and
cached by length: the encoder's bidirectional buckets have exact integer
boundaries (``log(n / 8) / log(16) * 8`` is 2, 4 and 6 at n = 16, 32, 64),
where a device ``logf`` one ulp away from the CPU's would flip a bucket.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from seal_tpu_torch.kernels import decode_attention
from seal_tpu_torch.models.common import reorder_cache, tied_head  # noqa: F401 (re-exported)
from seal_tpu_torch.utils.device import DEFAULT_DEVICE, checked_device

Params = Dict[str, Any]
NEG_INF = -1e9  # attention-mask bias (the JAX module's constant)


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 768
    d_kv: int = 64
    d_ff: int = 3072
    num_layers: int = 12  # encoder == decoder depth
    num_heads: int = 12
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    feed_forward_proj: str = "relu"  # or "gated-gelu" (t5 v1.1)
    pad_token_id: int = 0
    eos_token_id: int = 1
    bos_token_id: int = 0  # T5 has no BOS; pad doubles as decoder start
    decoder_start_token_id: int = 0
    mask_token_id: Optional[int] = None
    forced_bos_token_id: Optional[int] = None
    tie_word_embeddings: bool = True
    dtype: str = "float32"
    # a training knob of the JAX package, unused here: kept so a JAX
    # config loads as T5Config(**dataclasses.asdict(jax_cfg))
    remat: bool = False
    family: str = "t5"

    # interface parity with BartConfig
    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def encoder_layers(self) -> int:
        return self.num_layers

    @property
    def decoder_layers(self) -> int:
        return self.num_layers

    @property
    def decoder_attention_heads(self) -> int:
        return self.num_heads

    @property
    def head_dim(self) -> int:
        return self.d_kv

    @property
    def max_position_embeddings(self) -> int:
        return 512


def t5_tiny(vocab_size: int = 128) -> T5Config:
    return T5Config(
        vocab_size=vocab_size, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4
    )


# ----------------------------------------------------------------- init


def init_params(cfg: T5Config, seed: int = 0, device=DEFAULT_DEVICE) -> Params:
    """Random f32 parameters from a seeded ``torch.Generator`` (N(0, 0.05)
    matrices and bucket tables, an N(0, 1) embedding, unit RMSNorm scales,
    the JAX module's scales), in the JAX layout, on ``device`` (the card
    unless the caller asks for the CPU)."""
    device = checked_device(device)
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape, scale=0.05):
        return torch.randn(shape, generator=g, device=device) * scale

    def ones():
        return torch.ones(cfg.d_model, device=device)

    inner = cfg.num_heads * cfg.d_kv

    def attn():
        return {"q": normal(cfg.d_model, inner), "k": normal(cfg.d_model, inner),
                "v": normal(cfg.d_model, inner), "o": normal(inner, cfg.d_model)}

    def ffn():
        if cfg.feed_forward_proj == "gated-gelu":
            p = {"wi_0": normal(cfg.d_model, cfg.d_ff), "wi_1": normal(cfg.d_model, cfg.d_ff)}
        else:
            p = {"wi": normal(cfg.d_model, cfg.d_ff)}
        p["wo"] = normal(cfg.d_ff, cfg.d_model)
        return p

    def layer(cross: bool):
        p = {"self_attn": attn(), "ln_self": ones(), "ffn": ffn(), "ln_ffn": ones()}
        if cross:
            p["cross_attn"] = attn()
            p["ln_cross"] = ones()
        return p

    def stack(cross: bool):
        return {
            "rel_bias": normal(cfg.relative_attention_num_buckets, cfg.num_heads),
            "layers": [layer(cross) for _ in range(cfg.num_layers)],
            "final_ln": ones(),
        }

    return {"shared": normal(cfg.vocab_size, cfg.d_model, scale=1.0),
            "encoder": stack(False), "decoder": stack(True)}


# ------------------------------------------------------------- building


def _rms(scale, x, eps=1e-6):
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _split(x, h, dk):
    b, l, _ = x.shape
    return x.reshape(b, l, h, dk)


def _merge(x):
    b, l, h, dk = x.shape
    return x.reshape(b, l, h * dk)


def _relative_bucket(rel, bidirectional: bool, num_buckets: int, max_distance: int):
    """HF T5 ``_relative_position_bucket`` semantics; ``rel`` (int) is
    memory_position - context_position.  The large-distance buckets take an
    f32 log, as the JAX function does."""
    ret = torch.zeros_like(rel)
    n = rel
    if bidirectional:
        num_buckets //= 2
        ret = ret + torch.where(n > 0, num_buckets, 0)
        n = n.abs()
    else:
        n = -torch.clamp(n, max=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_large = max_exact + (
        torch.log(torch.clamp(n, min=1).to(torch.float32) / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(rel.dtype)
    val_large = torch.clamp(val_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_large)


@functools.lru_cache(maxsize=64)
def _buckets(lq: int, lk: int, bidirectional: bool, num_buckets: int, max_distance: int,
             device: str):
    """[Lq, Lk] int64 buckets of positions 0.. (memory - context), computed
    on the CPU and moved to ``device`` once per shape."""
    pos_q, pos_k = torch.arange(lq), torch.arange(lk)
    rel = pos_k[None, :] - pos_q[:, None]
    return _relative_bucket(rel, bidirectional, num_buckets, max_distance).to(device)


@functools.lru_cache(maxsize=64)
def _distance_buckets(max_len: int, num_buckets: int, max_distance: int, device: str):
    dist = torch.arange(max_len)
    return _relative_bucket(-dist, False, num_buckets, max_distance).to(torch.int32).to(device)


def bucket_of_distance(cfg: T5Config, max_len: int, device) -> torch.Tensor:
    """int32 [max_len]: the decoder's (unidirectional) bucket of a query
    ``d`` positions after its key, d = 0 .. max_len - 1 (rel = -d); what
    kernel 10's relative-bias mode reads as ``bucket[step - j]``.  Computed
    on the CPU, moved to ``device`` once per length."""
    return _distance_buckets(max_len, cfg.relative_attention_num_buckets,
                             cfg.relative_attention_max_distance, str(torch.device(device)))


def _position_bias(cfg: T5Config, table, lq: int, lk: int, bidirectional: bool):
    """[1, H, Lq, Lk] f32 additive bias of positions 0.. from the bucket table."""
    bucket = _buckets(lq, lk, bidirectional, cfg.relative_attention_num_buckets,
                      cfg.relative_attention_max_distance, str(table.device))
    return table[bucket].permute(2, 0, 1)[None].to(torch.float32)


def _attention(p, x_q, kv, bias, h, dk, dtype):
    """Un-scaled multi-head attention over projected, split (k, v)."""
    q = _split(x_q @ p["q"].to(x_q.dtype), h, dk)  # no 1/sqrt(dk)
    k, v = kv
    scores = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float())
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1).to(dtype)
    out = torch.einsum("bhlm,bmhd->blhd", probs, v)
    return _merge(out) @ p["o"].to(dtype)


def _cross_attention_step(p, x_q, kv, bias, h, dk):
    """Decode-step cross-attention with PER-QUERY K/V [Bq, M, H, Dh] (kernel
    9, un-scaled q): T5's cross-attention carries only the padding bias
    [Bq, 1, 1, M], which the kernel takes as [Bq, M]."""
    k, v = kv
    b = x_q.shape[0]
    q = _split(x_q @ p["q"].to(x_q.dtype), h, dk)[:, 0]  # [b, H, Dh]
    bias2 = bias.reshape(k.shape[0], k.shape[1]) if bias is not None else None
    out = decode_attention.cross_attention_step(q, k, v, bias2)
    return out.reshape(b, 1, h * dk) @ p["o"].to(x_q.dtype)


def _project_kv(p, x, h, dk):
    return _split(x @ p["k"].to(x.dtype), h, dk), _split(x @ p["v"].to(x.dtype), h, dk)


def _in_dtype(v: float, dtype) -> float:
    """``v`` rounded to ``dtype``: JAX rounds a Python scalar to the dtype
    of the (weak-typed) array it meets, where torch would compute with the
    f32 value."""
    return float(torch.tensor(v, dtype=dtype))


def _gelu_tanh(x):
    """``jax.nn.gelu(approximate=True)`` op by op in x's dtype, with its
    constants in x's dtype: in bf16 XLA rounds after every op, where
    ``F.gelu(approximate="tanh")`` rounds once."""
    c = math.sqrt(2 / math.pi)
    cube = x * x * x
    inner = _in_dtype(c, x.dtype) * (x + _in_dtype(0.044715, x.dtype) * cube)
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def _ffn(cfg: T5Config, p, x):
    if cfg.feed_forward_proj == "gated-gelu":
        hidden = _gelu_tanh(x @ p["wi_0"].to(x.dtype)) * (x @ p["wi_1"].to(x.dtype))
    else:
        hidden = F.relu(x @ p["wi"].to(x.dtype))
    return hidden @ p["wo"].to(x.dtype)


def _padding_bias(mask):
    """[B, L] 1/0 mask -> additive f32 [B, 1, 1, L] bias."""
    return torch.where(mask[:, None, None, :] > 0, 0.0, NEG_INF).to(torch.float32)


def encoder_bias(mask):
    """Additive cross-attention bias from the encoder padding mask."""
    return _padding_bias(mask)


def _embed(cfg: T5Config, params: Params, ids):
    return params["shared"][ids.long()].to(cfg.compute_dtype)


def encode(cfg: T5Config, params: Params, input_ids, attention_mask):
    """Encoder forward.  input_ids/attention_mask: int [B, L] -> [B, L, D]."""
    enc = params["encoder"]
    h, dk = cfg.num_heads, cfg.d_kv
    x = _embed(cfg, params, input_ids)
    l = input_ids.shape[1]
    bias = _position_bias(cfg, enc["rel_bias"], l, l, bidirectional=True)
    bias = bias + _padding_bias(attention_mask)
    for p in enc["layers"]:
        y = _rms(p["ln_self"], x)
        x = x + _attention(p["self_attn"], y, _project_kv(p["self_attn"], y, h, dk), bias, h,
                           dk, cfg.compute_dtype)
        x = x + _ffn(cfg, p["ffn"], _rms(p["ln_ffn"], x))
    return _rms(enc["final_ln"], x)


def precompute_cross_kv(cfg: T5Config, params: Params, enc_out):
    """Cross-attention K/V projected once per query."""
    h, dk = cfg.num_heads, cfg.d_kv
    return [_project_kv(p["cross_attn"], enc_out, h, dk) for p in params["decoder"]["layers"]]


def empty_self_cache(cfg: T5Config, batch: int, max_len: int, device=DEFAULT_DEVICE):
    device = checked_device(device)
    h, dk = cfg.num_heads, cfg.d_kv

    def z():
        return torch.zeros((batch, max_len, h, dk), dtype=cfg.compute_dtype, device=device)

    return [{"k": z(), "v": z()} for _ in range(cfg.num_layers)]


def lm_logits(cfg: T5Config, params: Params, hidden):
    """The tied head: hidden (times d_model^-0.5 in the compute dtype when
    the embeddings are tied) @ shared.T with an f32 result, plus
    ``final_logits_bias`` when the tree has one (HF T5 has none).

    Like the JAX function, the head is ``shared`` even for an untied
    config: an untied checkpoint's ``lm_head`` is never read.
    """
    if cfg.tie_word_embeddings:
        hidden = hidden * _in_dtype(cfg.d_model ** -0.5, hidden.dtype)
    logits = tied_head(cfg, params["shared"], hidden)
    bias = params.get("final_logits_bias")
    return logits if bias is None else logits + bias


def decode_full(cfg: T5Config, params: Params, enc_out, enc_mask, decoder_input_ids,
                decoder_mask=None):
    """Teacher-forced decoder forward: f32 logits [B, L, V] (key rescoring
    and unigram scores).  The unidirectional position bias plus a causal
    mask (plus the decoder padding bias when ``decoder_mask`` is given);
    cross-attention under the encoder padding bias."""
    dec = params["decoder"]
    h, dk = cfg.num_heads, cfg.d_kv
    l = decoder_input_ids.shape[1]
    dev = decoder_input_ids.device
    x = _embed(cfg, params, decoder_input_ids)
    pos = torch.arange(l, device=dev)
    bias = _position_bias(cfg, dec["rel_bias"], l, l, bidirectional=False)
    causal = torch.where(pos[None, None, :, None] >= pos[None, None, None, :], 0.0, NEG_INF)
    bias = bias + causal.to(torch.float32)
    if decoder_mask is not None:
        bias = bias + _padding_bias(decoder_mask)
    e_bias = _padding_bias(enc_mask)
    for p, ckv in zip(dec["layers"], precompute_cross_kv(cfg, params, enc_out)):
        y = _rms(p["ln_self"], x)
        x = x + _attention(p["self_attn"], y, _project_kv(p["self_attn"], y, h, dk), bias, h,
                           dk, cfg.compute_dtype)
        y = _rms(p["ln_cross"], x)
        x = x + _attention(p["cross_attn"], y, ckv, e_bias, h, dk, cfg.compute_dtype)
        x = x + _ffn(cfg, p["ffn"], _rms(p["ln_ffn"], x))
    return lm_logits(cfg, params, _rms(dec["final_ln"], x))


def decode_step(cfg: T5Config, params: Params, token_ids, step: int, self_cache, cross_kv,
                enc_bias):
    """One incremental decoder step; returns (logits f32 [B, V], self_cache).

    ``self_cache`` is updated IN PLACE at column ``step`` (and returned), as
    ``bart.decode_step`` does.  The self-attention is kernel 10's
    relative-bias mode over the live slots [0, step], fed the bucket table
    as it is (the kernel widens a bf16 table) and the decoder's
    bucket-of-distance vector.
    """
    dec = params["decoder"]
    h, dk = cfg.num_heads, cfg.d_kv
    b = token_ids.shape[0]
    max_len = self_cache[0]["k"].shape[1]
    if not 0 <= step < max_len:
        raise ValueError(f"decode_step: step {step} outside a cache of {max_len} slots")
    x = _embed(cfg, params, token_ids[:, None])
    buckets = bucket_of_distance(cfg, max_len, token_ids.device)
    for p, sc, ckv in zip(dec["layers"], self_cache, cross_kv):
        y = _rms(p["ln_self"], x)
        k_new, v_new = _project_kv(p["self_attn"], y, h, dk)  # [B,1,H,Dh]
        sc["k"][:, step] = k_new[:, 0].to(sc["k"].dtype)
        sc["v"][:, step] = v_new[:, 0].to(sc["v"].dtype)
        q = _split(y @ p["self_attn"]["q"].to(y.dtype), h, dk)[:, 0]  # [B, H, Dh], un-scaled
        att = decode_attention.self_attention_step_rel(q, sc["k"], sc["v"], step,
                                                       dec["rel_bias"], buckets)
        x = x + att.reshape(b, 1, h * dk) @ p["self_attn"]["o"].to(x.dtype)
        y = _rms(p["ln_cross"], x)
        x = x + _cross_attention_step(p["cross_attn"], y, ckv, enc_bias, h, dk)
        x = x + _ffn(cfg, p["ffn"], _rms(p["ln_ffn"], x))
    x = _rms(dec["final_ln"], x)
    return lm_logits(cfg, params, x[:, 0, :]), self_cache
