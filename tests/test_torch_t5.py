"""The torch port's T5 against ``seal_tpu.models.t5`` at ``t5_tiny``, on the
CPU through ``params_from_jax``: the config, the parameter layout, the
bucket function (exactly, on every distance in [-1100, 1100]), encoder
outputs, ``decode_full`` and cached decode steps (beams 1 and 3, relu and
gated-gelu) within atol 2e-4 / rtol 1e-4 in f32 -- f32 sums run in other
orders -- and in bf16 too: the port rounds where XLA rounds (the head's
scale and the gated FFN's constants in bf16, the tanh GELU op by op), so
bf16 outputs agree to the same f32 tolerance.  Kernel 10's
relative-bias mode's plain version against JAX's masked ``_attention``;
``lm_logits`` with and without ``final_logits_bias``; ``cast_params``; and,
where transformers is installed, ``from_hf_t5_state_dict`` against JAX's
converter and the port's logits against HF's, with the untied-head gap
that the port keeps from JAX."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal_tpu.models import api as japi
from seal_tpu.models import convert as jconvert
from seal_tpu.models import t5 as jt5
from seal_tpu_torch.kernels import decode_attention as k910
from seal_tpu_torch.models import api as tapi
from seal_tpu_torch.models import bart as tbart
from seal_tpu_torch.models import convert as tconvert
from seal_tpu_torch.models import t5 as tt5
from seal_tpu_torch.models.config import bart_tiny

TOL = dict(atol=2e-4, rtol=1e-4)
FFNS = ("relu", "gated-gelu")
DTYPES = ("float32", "bfloat16")


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(jnp.asarray(a, jnp.float32)), tree)


def _pair(ffn="relu", dtype="float32", vocab=99, seed=0):
    """Both packages' configs and the same weights (the JAX tree cast to the
    compute dtype by each package's ``cast_params``)."""
    jcfg = dataclasses.replace(jt5.t5_tiny(vocab), feed_forward_proj=ffn, dtype=dtype)
    tcfg = dataclasses.replace(tt5.t5_tiny(vocab), feed_forward_proj=ffn, dtype=dtype)
    params = jt5.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = tconvert.params_from_jax(_np_tree(params), tcfg, device="cpu")
    return jcfg, tcfg, japi.cast_params(jcfg, params), tconvert.cast_params(tcfg, tparams)


@pytest.fixture(scope="module")
def pairs():
    return {(f, d): _pair(f, d) for f in FFNS for d in DTYPES}


def _batch(vocab, b=2, lsrc=70, seed=1):
    """Sources long enough (70) for the encoder's buckets at distances 16,
    32 and 64, with padding."""
    rng = np.random.default_rng(seed)
    src = rng.integers(2, vocab, size=(b, lsrc)).astype(np.int32)
    mask = np.ones((b, lsrc), np.int32)
    mask[0, -9:] = 0
    src[0, -9:] = 0
    return src, mask


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)),
                               **TOL)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _jax_leaves(tree):
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path): a
            for path, a in jax.tree_util.tree_leaves_with_path(tree)}


def test_config_matches_jax():
    for name in ("T5Config", "t5_tiny"):
        assert dataclasses.asdict(getattr(jt5, name)()) == dataclasses.asdict(getattr(tt5, name)())
    cfg = tt5.T5Config()
    jcfg = jt5.T5Config()
    for prop in ("encoder_layers", "decoder_layers", "decoder_attention_heads", "head_dim",
                 "max_position_embeddings"):
        assert getattr(cfg, prop) == getattr(jcfg, prop), prop
    assert (cfg.family, cfg.pad_token_id, cfg.eos_token_id, cfg.bos_token_id,
            cfg.decoder_start_token_id, cfg.mask_token_id) == ("t5", 0, 1, 0, 0, None)
    assert cfg.compute_dtype == torch.float32
    assert tt5.T5Config(dtype="bfloat16").compute_dtype == torch.bfloat16


def test_module_for_dispatches_on_the_family():
    assert tapi.module_for(tt5.t5_tiny()) is tt5
    assert tapi.module_for(bart_tiny()) is tbart

    @dataclasses.dataclass(frozen=True)
    class Other:
        family: str = "t5"

    assert tapi.module_for(Other()) is tt5
    with pytest.raises(TypeError):
        tapi.module_for(object())
    assert tapi.cast_params is tconvert.cast_params


@pytest.mark.parametrize("ffn", FFNS)
def test_init_params_layout_matches_jax(ffn):
    jcfg = dataclasses.replace(jt5.t5_tiny(50), feed_forward_proj=ffn)
    tcfg = dataclasses.replace(tt5.t5_tiny(50), feed_forward_proj=ffn)
    want = {k: a.shape for k, a in _jax_leaves(jt5.init_params(jax.random.PRNGKey(0), jcfg)).items()}
    got = dict(_leaves(tt5.init_params(tcfg, seed=0, device="cpu")))
    assert {k: tuple(v.shape) for k, v in got.items()} == want
    assert all(v.dtype == torch.float32 for v in got.values())
    # the JAX module's scales: unit RMSNorm scales, N(0, 1) embeddings
    assert all(bool((v == 1).all()) for k, v in got.items() if k[-1].startswith(("ln_", "final")))
    assert 0.8 < float(got[("shared",)].std()) < 1.2
    assert 0.03 < float(got[("decoder", "rel_bias")].std()) < 0.07


def test_params_from_jax_copies_the_t5_tree():
    """Lists of layers and the 2-D ``rel_bias`` tables, leaf for leaf."""
    jcfg, tcfg = jt5.t5_tiny(40), tt5.t5_tiny(40)
    params = jt5.init_params(jax.random.PRNGKey(3), jcfg)
    tparams = tconvert.params_from_jax(jax.device_get(params), tcfg, device="cpu")
    assert isinstance(tparams["decoder"]["layers"], list)
    want = _jax_leaves(params)
    got = dict(_leaves(tparams))
    assert set(got) == set(want)
    for k, a in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(a), str(k))


@pytest.mark.parametrize("int_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_bucket_matches_jax_exactly(bidirectional, int_dtype):
    rel = np.arange(-1100, 1101, dtype=np.int32)
    for nb, md in ((32, 128), (32, 64), (16, 32)):
        want = np.asarray(jt5._relative_bucket(jnp.asarray(rel), bidirectional, nb, md))
        got = tt5._relative_bucket(torch.as_tensor(rel).to(int_dtype), bidirectional, nb, md)
        np.testing.assert_array_equal(got.numpy(), want, f"{nb}, {md}")
    cfg = tt5.T5Config()
    dist = tt5.bucket_of_distance(cfg, 1024, "cpu")
    assert dist.dtype == torch.int32 and dist.shape == (1024,)
    want = np.asarray(jt5._relative_bucket(-jnp.arange(1024), False, 32, 128))
    np.testing.assert_array_equal(dist.numpy(), want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ffn", FFNS)
def test_encoder_matches_jax(pairs, ffn, dtype):
    jcfg, tcfg, params, tparams = pairs[ffn, dtype]
    src, mask = _batch(jcfg.vocab_size)
    want = jt5.encode(jcfg, params, jnp.asarray(src), jnp.asarray(mask))
    got = tt5.encode(tcfg, tparams, torch.as_tensor(src), torch.as_tensor(mask))
    assert got.dtype == tcfg.compute_dtype and got.shape == (2, 70, jcfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("with_dec_mask", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_full_matches_jax(pairs, dtype, with_dec_mask):
    """Teacher-forced logits (the rescoring forward), pad in the decoder
    ids; optionally with the decoder padding mask (pad = decoder start = 0,
    so the start column is masked too, as in JAX)."""
    for ffn in FFNS:
        jcfg, tcfg, params, tparams = pairs[ffn, dtype]
        src, mask = _batch(jcfg.vocab_size, b=3, lsrc=20)
        rng = np.random.default_rng(4)
        dec = rng.integers(2, jcfg.vocab_size, size=(3, 7)).astype(np.int32)
        dec[:, 0] = jcfg.decoder_start_token_id
        dec[1, 4:] = jcfg.pad_token_id
        dmask = (dec != jcfg.pad_token_id).astype(np.int32) if with_dec_mask else None
        jenc = jt5.encode(jcfg, params, jnp.asarray(src), jnp.asarray(mask))
        tenc = tt5.encode(tcfg, tparams, torch.as_tensor(src), torch.as_tensor(mask))
        want = jt5.decode_full(jcfg, params, jenc, jnp.asarray(mask), jnp.asarray(dec),
                               None if dmask is None else jnp.asarray(dmask))
        got = tt5.decode_full(tcfg, tparams, tenc, torch.as_tensor(mask), torch.as_tensor(dec),
                              None if dmask is None else torch.as_tensor(dmask))
        assert got.dtype == torch.float32 and got.shape == (3, 7, jcfg.vocab_size)
        _close(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("beams", [1, 3])
def test_decode_steps_match_jax(pairs, beams, dtype):
    """Every step of a cache of 6 slots over per-query cross K/V (``beams``
    1: one row per query, JAX's plain ``_attention``; 3: the grouped one),
    the cache reordered by a beam permutation between steps as the beam
    search does (kernel 11's ping-pong); logits and the cache."""
    for ffn in FFNS:
        jcfg, tcfg, params, tparams = pairs[ffn, dtype]
        src, mask = _batch(jcfg.vocab_size, lsrc=12)
        jenc = jt5.encode(jcfg, params, jnp.asarray(src), jnp.asarray(mask))
        tenc = tt5.encode(tcfg, tparams, torch.as_tensor(src), torch.as_tensor(mask))
        jkv = jt5.precompute_cross_kv(jcfg, params, jenc)
        tkv = tt5.precompute_cross_kv(tcfg, tparams, tenc)
        jbias = jt5.encoder_bias(jnp.asarray(mask))
        tbias = tt5.encoder_bias(torch.as_tensor(mask))
        np.testing.assert_array_equal(np.asarray(jbias), tbias.numpy())
        rows, L = 2 * beams, 6
        jcache = jt5.empty_self_cache(jcfg, rows, L)
        caches = [tt5.empty_self_cache(tcfg, rows, L, device="cpu") for _ in range(2)]
        tcache = caches[0]
        assert tcache[0]["k"].dtype == tcfg.compute_dtype
        rng = np.random.default_rng(beams)
        for step in range(L):
            toks = rng.integers(2, jcfg.vocab_size, size=rows).astype(np.int32)
            jl, jcache = jt5.decode_step(jcfg, params, jnp.asarray(toks), step, jcache, jkv,
                                         jbias)
            tl, tcache = tt5.decode_step(tcfg, tparams, torch.as_tensor(toks), step, tcache,
                                         tkv, tbias)
            assert tl.dtype == torch.float32 and tl.shape == (rows, jcfg.vocab_size)
            _close(tl, jl)
            perm = rng.permutation(rows).astype(np.int32)
            jcache = jt5.reorder_cache(jcache, jnp.asarray(perm))
            tcache = tt5.reorder_cache(tcache, torch.as_tensor(perm), step,
                                       caches[(step + 1) % 2])
            _close(tcache[1]["v"][:, : step + 1], jcache[1]["v"][:, : step + 1])
        with pytest.raises(ValueError):
            tt5.decode_step(tcfg, tparams, torch.as_tensor(toks), L, tcache, tkv, tbias)


@pytest.mark.parametrize("dtype", DTYPES)
def test_relative_bias_plain_matches_jax_attention(dtype):
    """Kernel 10's relative-bias mode's plain version against JAX's
    ``_attention`` under the decode step's bias (``_position_bias`` of the
    step against every slot, plus -1e9 past it), with identity q/o
    projections, at T5-base's 12 heads of 64 and every step of 10 slots:
    f32 within f32 rounding, bf16 within ``bf16_error_ratio``."""
    jcfg = dataclasses.replace(jt5.T5Config(), dtype=dtype)
    H, dk, L, rows = jcfg.num_heads, jcfg.d_kv, 10, 6
    rng = np.random.default_rng(0)
    jdt = jcfg.compute_dtype
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    table = (rng.normal(size=(32, H)) * 2).astype(np.float32)
    q = rng.normal(size=(rows, H, dk)).astype(np.float32) * 0.2
    k = rng.normal(size=(rows, L, H, dk)).astype(np.float32)
    v = rng.normal(size=(rows, L, H, dk)).astype(np.float32)
    eye = jnp.eye(H * dk, dtype=jdt)
    p = {"q": eye, "o": eye}
    tq, tk, tv = (torch.as_tensor(a).to(tdt) for a in (q, k, v))
    buckets = tt5.bucket_of_distance(tt5.T5Config(), L, "cpu")
    slot = jnp.arange(L)
    for step in range(L):
        bias = jt5._position_bias(jcfg, jnp.asarray(table).astype(jdt), jnp.full((1,), step),
                                  slot, bidirectional=False)
        bias = bias + jnp.where(slot[None, None, None, :] <= step, 0.0, jt5.NEG_INF)
        want = jt5._attention(p, jnp.asarray(q).astype(jdt).reshape(rows, 1, H * dk),
                              (jnp.asarray(k).astype(jdt), jnp.asarray(v).astype(jdt)), bias, H,
                              dk, jdt)
        want = torch.as_tensor(np.array(want.astype(jnp.float32))).reshape(rows, H, dk)
        ttable = torch.as_tensor(table).to(tdt)  # as cast_params leaves it
        got = k910.self_attention_step_rel(tq, tk, tv, step, ttable, buckets)
        assert got.dtype == tdt and got.shape == (rows, H, dk)
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
        else:
            head_bias = k910.relative_bias_row(ttable, buckets, step, L)
            assert k910.bf16_error_ratio(got, want, tq, tk, tv, head_bias=head_bias) <= 1.0
    assert k910.self_attention_step_rel.launches == 0  # CPU tensors: the plain version


def test_lm_logits_matches_jax(pairs):
    """With and without ``final_logits_bias`` (HF T5 has none), f32 and
    bf16 (the bf16 head keeps an f32 result)."""
    for dtype in DTYPES:
        jcfg, tcfg, params, tparams = pairs["relu", dtype]
        h = np.random.default_rng(3).normal(size=(5, jcfg.d_model)).astype(np.float32)
        jh = jnp.asarray(h).astype(jcfg.compute_dtype)
        th = torch.as_tensor(h).to(tcfg.compute_dtype)
        assert "final_logits_bias" not in tparams
        got = tt5.lm_logits(tcfg, tparams, th)
        assert got.dtype == torch.float32
        _close(got, jt5.lm_logits(jcfg, params, jh))
        bias = np.random.default_rng(4).normal(size=jcfg.vocab_size).astype(np.float32)
        bias[[0, 5]] = -np.inf
        jp = dict(params, final_logits_bias=jnp.asarray(bias))
        tp = dict(tparams, final_logits_bias=torch.as_tensor(bias))
        want = np.asarray(jt5.lm_logits(jcfg, jp, jh))
        got = tt5.lm_logits(tcfg, tp, th).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], **TOL)


def test_cast_params_and_seal_bias_match_jax():
    """Every floating leaf with >= 2 dims (the ``rel_bias`` tables too) goes
    to bf16, 1-D scales stay f32; the SEAL bias is a no-op without
    ``final_logits_bias`` and bans pad = bos = 0 with one."""
    jcfg = dataclasses.replace(jt5.t5_tiny(40), dtype="bfloat16")
    tcfg = dataclasses.replace(tt5.t5_tiny(40), dtype="bfloat16")
    params = jt5.init_params(jax.random.PRNGKey(1), jcfg)
    tparams = tconvert.params_from_jax(jax.device_get(params), tcfg, device="cpu")
    jb = _jax_leaves(japi.cast_params(jcfg, params))
    tb = dict(_leaves(tconvert.cast_params(tcfg, tparams)))
    assert set(jb) == set(tb)
    for key, a in jb.items():
        assert (a.dtype == jnp.bfloat16) == (tb[key].dtype == torch.bfloat16), key
        np.testing.assert_array_equal(np.asarray(a, np.float32), tb[key].float().numpy())
    assert tb[("decoder", "rel_bias")].dtype == torch.bfloat16
    assert tconvert.apply_seal_logits_bias(tparams, tcfg) is tparams
    with_bias = dict(tparams, final_logits_bias=torch.zeros(40))
    out = tconvert.apply_seal_logits_bias(with_bias, tcfg)
    want = jconvert.apply_seal_logits_bias(dict(params, final_logits_bias=jnp.zeros(40)), jcfg)
    np.testing.assert_array_equal(out["final_logits_bias"].numpy(),
                                  np.asarray(want["final_logits_bias"]))
    assert torch.isneginf(out["final_logits_bias"][0])
    assert torch.isfinite(out["final_logits_bias"][1:]).all()


# ------------------------------------------------- HF checkpoints (optional)


def _hf_model(ffn="relu", tied=True, vocab=99):
    transformers = pytest.importorskip("transformers")
    cfg = dataclasses.replace(jt5.t5_tiny(vocab), feed_forward_proj=ffn, tie_word_embeddings=tied)
    hf_cfg = transformers.T5Config(
        vocab_size=cfg.vocab_size, d_model=cfg.d_model, d_kv=cfg.d_kv, d_ff=cfg.d_ff,
        num_layers=cfg.num_layers, num_decoder_layers=cfg.num_layers, num_heads=cfg.num_heads,
        relative_attention_num_buckets=cfg.relative_attention_num_buckets,
        relative_attention_max_distance=cfg.relative_attention_max_distance, dropout_rate=0.0,
        feed_forward_proj=ffn, tie_word_embeddings=tied, pad_token_id=0, eos_token_id=1,
        decoder_start_token_id=0,
    )
    torch.manual_seed(0)
    hf = transformers.T5ForConditionalGeneration(hf_cfg).eval()
    return cfg, hf


def _hf_logits(hf, src, mask, dec):
    with torch.no_grad():
        return hf(input_ids=torch.as_tensor(src).long(), attention_mask=torch.as_tensor(mask).long(),
                  decoder_input_ids=torch.as_tensor(dec).long()).logits.numpy()


@pytest.mark.parametrize("ffn", FFNS)
def test_from_hf_t5_state_dict_matches_jax_and_hf(ffn):
    """The port's converter gives JAX's tree (leaf for leaf, exactly) from a
    seeded HF state dict, and the port's logits are HF's (the tolerance of
    ``tests/test_t5.py``)."""
    jcfg, hf = _hf_model(ffn)
    tcfg = tt5.T5Config(**dataclasses.asdict(jcfg))
    sd = hf.state_dict()
    want = _jax_leaves(jconvert.from_hf_t5_state_dict(sd, jcfg))
    tparams = tconvert.from_hf_t5_state_dict(sd, tcfg, device="cpu")
    got = dict(_leaves(tparams))
    assert set(got) == set(want)
    for key, a in want.items():
        assert got[key].dtype == torch.float32 and got[key].is_contiguous()
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(a), str(key))
    src, mask = _batch(jcfg.vocab_size, lsrc=9)
    dec = np.random.default_rng(2).integers(2, jcfg.vocab_size, size=(2, 5)).astype(np.int32)
    dec[:, 0] = 0
    tenc = tt5.encode(tcfg, tparams, torch.as_tensor(src), torch.as_tensor(mask))
    got = tt5.decode_full(tcfg, tparams, tenc, torch.as_tensor(mask), torch.as_tensor(dec))
    np.testing.assert_allclose(got.numpy(), _hf_logits(hf, src, mask, dec), atol=2e-3, rtol=1e-3)


def test_untied_head_follows_jax_not_hf():
    """A fault of the JAX package, kept: ``t5.lm_logits`` always multiplies
    by ``shared`` and the converter never reads ``lm_head.weight``, so an
    untied checkpoint (T5 v1.1, flan-T5, mT5) is served against its input
    embedding table.  The port equals JAX here; both are far from HF."""
    jcfg, hf = _hf_model("gated-gelu", tied=False)
    tcfg = tt5.T5Config(**dataclasses.asdict(jcfg))
    sd = hf.state_dict()
    assert "lm_head.weight" in sd and not torch.equal(sd["lm_head.weight"], sd["shared.weight"])
    params = jconvert.from_hf_t5_state_dict(sd, jcfg)
    tparams = tconvert.from_hf_t5_state_dict(sd, tcfg, device="cpu")
    src, mask = _batch(jcfg.vocab_size, lsrc=9)
    dec = np.zeros((2, 3), np.int32)
    jenc = jt5.encode(jcfg, params, jnp.asarray(src), jnp.asarray(mask))
    want = np.asarray(jt5.decode_full(jcfg, params, jenc, jnp.asarray(mask), jnp.asarray(dec)))
    tenc = tt5.encode(tcfg, tparams, torch.as_tensor(src), torch.as_tensor(mask))
    got = tt5.decode_full(tcfg, tparams, tenc, torch.as_tensor(mask), torch.as_tensor(dec))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.abs(got.numpy() - _hf_logits(hf, src, mask, dec)).max() > 0.1


def test_f32_error_ratio_holds_rounding_and_rejects_a_wrong_bias():
    """The f32 tolerance of un-scaled scores (chip_smoke's check of the
    relative-bias mode at T5-base magnitudes, scores up to ~50): an f64
    evaluation rounded to f32 is within it, a table 1% off is far outside."""
    g = torch.Generator().manual_seed(0)
    rows, L, H, dk, step = 64, 10, 12, 64, 9
    q = torch.randn(rows, H, dk, generator=g) * 1.4
    k = torch.randn(rows, L, H, dk, generator=g) * 1.4
    v = torch.randn(rows, L, H, dk, generator=g)
    table = torch.randn(32, H, generator=g)
    buckets = tt5.bucket_of_distance(tt5.T5Config(), L, "cpu")
    want = k910.self_attention_rel_plain(q, k, v, step, table, buckets)
    head_bias = k910.relative_bias_row(table, buckets, step, L)
    scores = torch.einsum("rhd,rmhd->rhm", q.double(), k.double()) + head_bias.double()[None]
    f64 = torch.einsum("rhm,rmhd->rhd", torch.softmax(scores, -1), v.double()).float()
    assert float((f64 - want).abs().max()) > 1e-6  # the sum orders differ
    assert k910.f32_error_ratio(f64, want, q, k, v, m=L, head_bias=head_bias) <= 1.0
    wrong = k910.self_attention_rel_plain(q, k, v, step, table * 1.01, buckets)
    assert k910.f32_error_ratio(wrong, want, q, k, v, m=L, head_bias=head_bias) > 10.0


@pytest.mark.parametrize("step", [4, 9])
@pytest.mark.parametrize("padded", [False, True])
def test_f32_error_ratio_holds_cross_attention_rounding(step, padded):
    """The same tolerance on kernel 9's T5 case (chip_smoke's f32 check of
    the grouped cross-attention, q un-scaled, 15 beams per query) and on
    the relative-bias mode before the cache is full: positions under the
    -1e9 bias leave the bound, an f64 evaluation stays within it, a q 1%
    off is far outside."""
    g = torch.Generator().manual_seed(step)
    bq, beams, M, H, dk = 4, 15, 40, 12, 64
    q = torch.randn(bq * beams, H, dk, generator=g) * 1.4
    k = torch.randn(bq, M, H, dk, generator=g) * 1.4
    v = torch.randn(bq, M, H, dk, generator=g)
    bias = torch.zeros(bq, M)
    if padded:
        bias[::3, -3:] = k910.NEG_BIAS
    want = k910.decode_attention_plain(q, k, v, bias)
    scores = torch.einsum("bghd,bmhd->bghm", q.double().reshape(bq, beams, H, dk), k.double())
    probs = torch.softmax(scores + bias.double()[:, None, None], -1)
    f64 = torch.einsum("bghm,bmhd->bghd", probs, v.double()).reshape(q.shape).float()
    assert float((f64 - want).abs().max()) > 1e-6
    assert k910.f32_error_ratio(f64, want, q, k, v, bias) <= 1.0
    wrong = k910.decode_attention_plain(q * 1.01, k, v, bias)
    assert k910.f32_error_ratio(wrong, want, q, k, v, bias) > 10.0
    # the relative-bias mode at a step short of the cache's end
    L = 10
    kc, vc = k[:, :L].repeat_interleave(beams, 0), v[:, :L].repeat_interleave(beams, 0)
    table = torch.randn(32, H, generator=g)
    buckets = tt5.bucket_of_distance(tt5.T5Config(), L, "cpu")
    head_bias = k910.relative_bias_row(table, buckets, step, L)
    want = k910.self_attention_rel_plain(q, kc, vc, step, table, buckets)
    scores = torch.einsum("rhd,rmhd->rhm", q.double(), kc.double()) + head_bias.double()[None]
    f64 = torch.einsum("rhm,rmhd->rhd", torch.softmax(scores, -1), vc.double()).float()
    assert k910.f32_error_ratio(f64, want, q, kc, vc, m=L, head_bias=head_bias) <= 1.0
    wrong = k910.self_attention_rel_plain(q * 1.01, kc, vc, step, table, buckets)
    assert k910.f32_error_ratio(wrong, want, q, kc, vc, m=L, head_bias=head_bias) > 10.0


@pytest.mark.parametrize("ratio", ["f32_error_ratio", "bf16_error_ratio"])
def test_error_ratios_refuse_nan(ratio):
    """A NaN in the kernel's output fails either tolerance: the ratio is
    infinite, not NaN (which compares as within any bound)."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn(6, 2, 8, generator=g)
    k, v = torch.randn(2, 5, 2, 8, generator=g), torch.randn(2, 5, 2, 8, generator=g)
    want = k910.decode_attention_plain(q, k, v, None)
    got = want.clone()
    got[3, 1, 4] = float("nan")
    assert getattr(k910, ratio)(want, want, q, k, v) == 0.0
    assert getattr(k910, ratio)(got, want, q, k, v) == float("inf")
