"""Kernels 9 and 10 wrappers: one-token decode attention over cached K/V
(``csrc/decode_attention.cu``), with their plain versions.

* ``cross_attention_step`` (kernel 9) replaces
  ``seal_tpu/models/bart.py:_cross_attention_step`` (:156-182): the g beams
  of a query share its encoder K/V; g = 1 at step 0.
* ``self_attention_step`` (kernel 10) replaces ``decode_step``'s cached
  self-attention (``bart.py`` :275-285 through ``_attention`` :142), over
  the live slots [0, step] only.
* ``self_attention_step_rel`` (kernel 10's relative-position-bias mode)
  replaces T5's (``seal_tpu/models/t5.py:decode_step`` :358-371 with
  ``_position_bias`` :188): the kernel adds ``table[bucket[step - j], h]``
  to the score of slot j, from the bucket table [num_buckets, H] (f32, or
  bf16 as ``cast_params`` leaves it, widened in the kernel) and the
  decoder's bucket-of-distance vector int32 [max_len].  T5 feeds both
  modes, and kernel 9, an un-scaled q.

The inputs are the plain code's: q after the query projection and scaling
[rows, H, Dh], K/V [Bq, M, H, Dh] (a cache may have more rows and columns
than are used), the additive f32 bias [Bq, M] (0 or -1e9).  Scores and
softmax in f32, the probabilities rounded to the compute dtype before PV,
PV accumulated in f32 (the plain einsums' numerics).  The sum orders
differ, so a bf16 output may differ from the plain version's by one ulp plus
one bf16 step of any probability (``bf16_error_ratio``).

A call takes one of four routes (:func:`route`, ``csrc/decode_attention.cu``
states each one's limits): ``warp`` for one beam a query (kernel 10, and
kernel 9 at step 0), ``mma`` for grouped bf16 (tensor cores, M split over a
thread-block cluster), ``ffma`` for grouped f32 up to 64 positions, and the
``tiled`` general route for the rest.  Each wrapper counts one launch a
call; the route's counter (``ROUTES``) counts it too.
"""

from __future__ import annotations

import torch

from seal_tpu_torch.kernels import Launches

NEG_BIAS = -1e9  # BART's attention-mask bias (``models/bart.py``)
FAST_HEAD_DIM = 64  # the head_dim of the warp, mma and ffma routes
MMA_MAX_GROUP = 32  # beams a query on the mma and ffma routes (two m16 tiles)
MMA_MAX_M = 1024  # positions on the mma route: a cluster of 16 CTAs of 64
FFMA_MAX_M = 64  # positions on the ffma route: two a lane
ROUTE_CODES = {"tiled": 0, "warp": 1, "mma": 2, "ffma": 3}
ROUTES = {name: Launches() for name in ROUTE_CODES}  # launches by route


def decode_attention_plain(q, k, v, bias, m: int | None = None, head_bias=None):
    """q [Bq*g, H, Dh], k/v [Bq, M', H, Dh] (first ``m`` positions used),
    bias f32 [Bq, m] or None, head_bias f32 [H, m] (one row per head, the
    same for every query) or None -> [Bq*g, H, Dh] in q's dtype."""
    bq = k.shape[0]
    g = q.shape[0] // bq
    m = k.shape[1] if m is None else m
    k, v = k[:, :m], v[:, :m]
    qg = q.reshape(bq, g, *q.shape[1:])
    scores = torch.einsum("bghd,bmhd->bghm", qg.float(), k.float())
    if bias is not None:
        scores = scores + bias[:, None, None, :m]
    if head_bias is not None:
        scores = scores + head_bias[None, None, :, :m]
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bghm,bmhd->bghd", probs, v)
    return out.reshape(q.shape)


def bf16_error_ratio(got, want, q, k, v, bias=None, m: int | None = None,
                     head_bias=None) -> float:
    """Largest |got - want| over the bf16 tolerance, elementwise.

    Two bf16 decode attentions whose f32 sums run in other orders may round
    a probability to bf16 the other way (one bf16 ulp, <= 2^-7 p_j) and the
    output one step apart, so the tolerance of an element is one output ulp
    plus 2^-7 * sum_j p_j |v_j|.  A ratio <= 1 is within it.
    """
    a = torch.maximum(got.float().abs(), want.float().abs()).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(a)) - 7)
    weight = decode_attention_plain(q, k, v.abs(), bias, m, head_bias).float()
    return _max_ratio(got, want, ulp + 2.0 ** -7 * weight)


def f32_error_ratio(got, want, q, k, v, bias=None, m: int | None = None,
                    head_bias=None) -> float:
    """Largest |got - want| over the f32 tolerance, elementwise: the
    tolerance of un-scaled scores (T5), whose f32 rounding grows with them.

    An f32 dot of Dh products is off by at most Dh 2^-24 sum_d |q_d k_d|,
    so with e the largest such bound over a row's positions each
    probability moves by at most a factor exp(2e), and the output by about
    2e sum_j p_j |v_j|; the PV sum adds m 2^-24 sum_j p_j |v_j|.  Positions
    under the -1e9 bias carry no probability and are left out of e.  A
    ratio <= 1 is within it.
    """
    bq, dh = k.shape[0], q.shape[-1]
    m = k.shape[1] if m is None else m
    qa = q.float().abs().reshape(bq, q.shape[0] // bq, *q.shape[1:])
    dots = torch.einsum("bghd,bmhd->bghm", qa, k[:, :m].float().abs())
    if bias is not None:
        dots = dots.masked_fill(bias[:, None, None, :m] <= NEG_BIAS / 2, 0.0)
    if head_bias is not None:
        dots = dots.masked_fill(head_bias[None, None, :, :m] <= NEG_BIAS / 2, 0.0)
    e = dh * 2.0 ** -24 * dots.amax(-1)
    weight = decode_attention_plain(q.float(), k.float(), v.float().abs(), bias, m,
                                    head_bias).float()
    tol = (2 * e.reshape(q.shape[0], q.shape[1], 1) + (m + 2) * 2.0 ** -24) * weight
    return _max_ratio(got, want, tol.clamp(min=2.0 ** -126))


def _max_ratio(got, want, tol) -> float:
    """max |got - want| / tol in f32, a NaN on either side counted as
    infinitely far (a NaN ratio would compare as within any tolerance)."""
    ratio = (got.float() - want.float()).abs() / tol
    return float(ratio.nan_to_num(nan=float("inf")).max())


def cross_attention_step(q, k, v, bias):
    """Grouped decode cross-attention (kernel 9): q [Bq*g, H, Dh], per-query
    K/V [Bq, M, H, Dh], bias f32 [Bq, M] or None.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    if not q.is_cuda:
        return decode_attention_plain(q, k, v, bias)
    out = _launch(q, k, v, bias, k.shape[1])
    cross_attention_step.launches += 1
    return out


cross_attention_step.launches = 0


def self_attention_plain(q, k_cache, v_cache, step: int):
    """The plain code's cached self-attention: every cache slot, with the
    -1e9 bias past ``step``."""
    max_len = k_cache.shape[1]
    slots = torch.arange(max_len, device=q.device)
    bias = torch.where(slots <= step, 0.0, NEG_BIAS).to(torch.float32)
    return decode_attention_plain(q, k_cache, v_cache, bias.expand(k_cache.shape[0], max_len))


def self_attention_step(q, k_cache, v_cache, step: int):
    """Cached decode self-attention (kernel 10): q [rows, H, Dh], cache
    [rows, max_len, H, Dh] written at slots [0, step].  The kernel reads the
    live slots only; the plain version all of them under the -1e9 bias past
    ``step`` (exp(-1e9 - max) is 0.0 in f32, so both sums are the same).

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    if not q.is_cuda:
        return self_attention_plain(q, k_cache, v_cache, step)
    if not 0 <= step < k_cache.shape[1]:
        raise ValueError(f"self_attention_step: step {step} outside the cache")
    out = _launch(q, k_cache, v_cache, None, step + 1)
    self_attention_step.launches += 1
    return out


self_attention_step.launches = 0


def relative_bias_row(table, buckets, step: int, max_len: int):
    """T5's decode-step bias over every cache slot, f32 [H, max_len]: the
    bucket table's row of slot j's distance step - j (slots past ``step``
    are in bucket 0, as T5 computes them) plus -1e9 past ``step``."""
    slots = torch.arange(max_len, device=table.device)
    rel = table[buckets[(step - slots).clamp(min=0)].long()].T.to(torch.float32)
    return rel + torch.where(slots <= step, 0.0, NEG_BIAS).to(torch.float32)


def self_attention_rel_plain(q, k_cache, v_cache, step: int, table, buckets):
    """The plain code's T5 cached self-attention: every cache slot, under
    ``relative_bias_row``."""
    head_bias = relative_bias_row(table, buckets, step, k_cache.shape[1])
    return decode_attention_plain(q, k_cache, v_cache, None, head_bias=head_bias)


def self_attention_step_rel(q, k_cache, v_cache, step: int, table, buckets):
    """Cached decode self-attention with T5's relative position bias (kernel
    10's relative-bias mode): q [rows, H, Dh] un-scaled, cache [rows,
    max_len, H, Dh] written at slots [0, step], ``table`` f32 or bf16
    [num_buckets, H], ``buckets`` int32 [max_len] with every entry <
    num_buckets (the decoder's bucket of each distance,
    ``models/t5.py:bucket_of_distance``).

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    if not q.is_cuda:
        return self_attention_rel_plain(q, k_cache, v_cache, step, table, buckets)
    if not 0 <= step < k_cache.shape[1]:
        raise ValueError(f"self_attention_step_rel: step {step} outside the cache")
    out = _launch(q, k_cache, v_cache, None, step + 1, rel=(table, buckets))
    self_attention_step_rel.launches += 1
    return out


self_attention_step_rel.launches = 0


def route(group: int, m: int, head_dim: int, bf16: bool) -> str:
    """The route of a call with ``group`` beams a query over ``m`` positions
    (the caller's operands 16-byte aligned; else ``tiled``)."""
    if head_dim != FAST_HEAD_DIM:
        return "tiled"
    if group == 1:
        return "warp"
    if group > MMA_MAX_GROUP:
        return "tiled"
    if bf16:
        return "mma" if m <= MMA_MAX_M else "tiled"
    return "ffma" if m <= FFMA_MAX_M else "tiled"


def heads_a_cta(heads: int) -> int:
    """Heads (warps) a CTA of the warp, mma and ffma routes: 4, 2 or 1,
    dividing ``heads``, so that a CTA's reads of a position are contiguous."""
    return next(h for h in (4, 2, 1) if heads % h == 0)


_FN = _STREAM = None  # the C entry point and build.stream_ptr, looked up once
_PLANS: dict = {}  # (shapes, strides, dtypes, devices, m, bias, rel) -> (route code, hpc)


def _plan(q, k, v, bias, m: int, rel):
    """Check a call's shapes once a layout; returns the route code and the
    heads a CTA (the tiled route where the fast routes' 16-byte loads would
    not line up with the row strides)."""
    rows, heads, head_dim = q.shape
    bq = k.shape[0]
    if rows % bq or k.shape[2:] != (heads, head_dim) or k.shape != v.shape:
        raise ValueError(f"decode attention: q {tuple(q.shape)} vs K/V {tuple(k.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"decode attention: f32 or bf16 operands of one dtype, got {q.dtype}")
    if q.stride(2) != 1 or q.stride(1) != head_dim:
        raise ValueError("decode attention: q rows must be [H, Dh] contiguous")
    for t in (k, v):
        if t.stride(3) != 1 or t.stride(2) != head_dim or t.stride(1) != heads * head_dim:
            raise ValueError("decode attention: K/V rows must be [M, H, Dh] contiguous")
    if k.stride(0) != v.stride(0):
        raise ValueError("decode attention: K and V need one row stride")
    if bias is not None:
        if bias.dtype != torch.float32 or bias.shape != (bq, k.shape[1]) or bias.stride(1) != 1:
            raise ValueError(f"decode attention: bias must be f32 [{bq}, {k.shape[1]}]")
    if rel is not None:
        table, buckets = rel
        if (table.dtype not in (torch.float32, torch.bfloat16) or table.dim() != 2
                or table.shape[1] != heads or not table.is_contiguous()
                or table.device != q.device):
            raise ValueError(f"self_attention_step_rel: table must be f32 or bf16 [buckets, "
                             f"{heads}] contiguous on {q.device}")
        if (buckets.dtype != torch.int32 or buckets.dim() != 1 or buckets.numel() < m
                or not buckets.is_contiguous() or buckets.device != q.device):
            raise ValueError(f"self_attention_step_rel: buckets must be int32 [> {m - 1}] "
                             f"contiguous on {q.device}")
    g = rows // bq
    bf16 = q.dtype == torch.bfloat16
    name = route(g, m, head_dim, bf16)
    vec = 8 if bf16 else 4  # elements of 16 bytes
    if q.stride(0) % vec or k.stride(0) % vec:
        name = "tiled"
    return ROUTE_CODES[name], heads_a_cta(heads)


def _launch(q, k, v, bias, m: int, rel=None):
    global _FN, _STREAM
    if _FN is None:
        from seal_tpu_torch.kernels import build

        _FN, _STREAM = build.lib().seal_decode_attention, build.stream_ptr
    key = (q.shape, q.stride(), k.shape, k.stride(), v.stride(), q.dtype, k.dtype, v.dtype, m,
           q.device, k.device, v.device,
           None if bias is None else (bias.dtype, bias.shape, bias.stride(), bias.device),
           None if rel is None else tuple((t.dtype, t.shape, t.stride(), t.device) for t in rel))
    plan = _PLANS.get(key)
    if plan is None:
        plan = _PLANS[key] = _plan(q, k, v, bias, m, rel)
    code, hpc = plan
    rows, heads, head_dim = q.shape
    bq = k.shape[0]
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    if code and (qp | kp | vp) & 15:
        code = ROUTE_CODES["tiled"]  # a view off the 16-byte grid
    out = torch.empty((rows, heads, head_dim), dtype=q.dtype, device=q.device)
    table, buckets = rel if rel is not None else (None, None)
    rc = _FN(
        qp, kp, vp, bias.data_ptr() if bias is not None else None,
        table.data_ptr() if table is not None else None,
        int(table is not None and table.dtype == torch.bfloat16),
        buckets.data_ptr() if buckets is not None else None,
        out.data_ptr(), bq, rows // bq, heads, m, head_dim, q.stride(0), k.stride(0),
        bias.stride(0) if bias is not None else 0, int(q.dtype == torch.bfloat16), code, hpc,
        _STREAM(q),
    )
    if rc:
        raise RuntimeError(f"decode_attention: CUDA error {rc}")
    ROUTES[_NAMES[code]].launches += 1
    return out


_NAMES = {code: name for name, code in ROUTE_CODES.items()}
