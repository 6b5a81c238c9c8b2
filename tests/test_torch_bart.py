"""The torch port's BART against ``seal_tpu.models.bart`` at ``bart_tiny``,
f32, through ``params_from_jax``: encoder outputs and decode-step logits
(plain and grouped cross-attention) within atol 1e-4 / rtol 1e-4 -- the
two frameworks accumulate f32 sums in other orders -- plus the config,
the parameter casts and the SEAL logit bias."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal_tpu.models import api as japi
from seal_tpu.models import bart as jbart
from seal_tpu.models import config as jconfig
from seal_tpu.models import convert as jconvert
from seal_tpu_torch.models import bart as tbart
from seal_tpu_torch.models import config as tconfig
from seal_tpu_torch.models import convert as tconvert

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def models():
    jcfg = jconfig.bart_tiny(vocab_size=99)
    tcfg = tconfig.bart_tiny(vocab_size=99)
    params = jbart.init_params(jax.random.PRNGKey(0), jcfg)
    # non-zero biases and LayerNorm affines, so the conversion of every
    # leaf shows in the outputs
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(0)
    leaves = [
        np.asarray(a) + (0.05 * rng.normal(size=a.shape)).astype(np.float32) if a.ndim == 1 else a
        for a in leaves
    ]
    params = jax.tree_util.tree_unflatten(tree, [jnp.asarray(a) for a in leaves])
    tparams = tconvert.params_from_jax(jax.device_get(params), tcfg, device="cpu")
    return jcfg, tcfg, params, tparams


def _batch(cfg, b=3, lsrc=11, seed=1):
    rng = np.random.default_rng(seed)
    src = rng.integers(3, cfg.vocab_size, size=(b, lsrc)).astype(np.int32)
    mask = np.ones((b, lsrc), np.int32)
    mask[0, -3:] = 0
    src[0, -3:] = cfg.pad_token_id
    return src, mask


def test_config_matches_jax():
    for name in ("bart_large", "bart_base", "bart_tiny"):
        j = dataclasses.asdict(getattr(jconfig, name)())
        t = dataclasses.asdict(getattr(tconfig, name)())
        assert j == t, name
    assert tconfig.BartConfig(dtype="bfloat16").compute_dtype == torch.bfloat16
    assert tconfig.BartConfig().compute_dtype == torch.float32
    assert tconfig.bart_large().head_dim == 64


def test_init_params_layout_matches_jax():
    jcfg, tcfg = jconfig.bart_tiny(vocab_size=50), tconfig.bart_tiny(vocab_size=50)
    jp = jax.tree_util.tree_leaves_with_path(jbart.init_params(jax.random.PRNGKey(0), jcfg))
    tp = tbart.init_params(tcfg, seed=0)
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(prefix + (k,), v)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(prefix + (i,), v)
        else:
            flat[prefix] = node

    walk((), tp)
    want = {
        tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path): a.shape
        for path, a in jp
    }
    assert {k: tuple(v.shape) for k, v in flat.items()} == want
    assert all(v.dtype == torch.float32 for v in flat.values())


def test_encoder_matches_jax(models):
    jcfg, tcfg, params, tparams = models
    src, mask = _batch(jcfg)
    want = np.asarray(jbart.encode(jcfg, params, jnp.asarray(src), jnp.asarray(mask)))
    got = tbart.encode(tcfg, tparams, torch.as_tensor(src), torch.as_tensor(mask))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("beams", [1, 3])
def test_decode_steps_match_jax(models, beams):
    """Cached decode steps over per-query cross K/V: ``beams`` 1 takes the
    plain cross-attention, 3 the grouped one; the cache is reordered by a
    beam permutation between steps, as the beam search does."""
    jcfg, tcfg, params, tparams = models
    src, mask = _batch(jcfg, b=2)
    jenc = jbart.encode(jcfg, params, jnp.asarray(src), jnp.asarray(mask))
    tenc = tbart.encode(tcfg, tparams, torch.as_tensor(src), torch.as_tensor(mask))
    jkv = jbart.precompute_cross_kv(jcfg, params, jenc)
    tkv = tbart.precompute_cross_kv(tcfg, tparams, tenc)
    jbias = jbart.encoder_bias(jnp.asarray(mask))
    tbias = tbart.encoder_bias(torch.as_tensor(mask))
    np.testing.assert_array_equal(np.asarray(jbias), tbias.numpy())
    rows, L = 2 * beams, 6
    jcache = jbart.empty_self_cache(jcfg, rows, L)
    tcache = tbart.empty_self_cache(tcfg, rows, L)
    rng = np.random.default_rng(beams)
    for step in range(4):
        toks = rng.integers(3, jcfg.vocab_size, size=rows).astype(np.int32)
        jl, jcache = jbart.decode_step(jcfg, params, jnp.asarray(toks), jnp.int32(step),
                                       jcache, jkv, jbias)
        tl, tcache = tbart.decode_step(tcfg, tparams, torch.as_tensor(toks), step,
                                       tcache, tkv, tbias)
        assert tl.dtype == torch.float32 and tl.shape == (rows, jcfg.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        perm = rng.permutation(rows).astype(np.int32)
        jcache = jbart.reorder_cache(jcache, jnp.asarray(perm))
        tcache = tbart.reorder_cache(tcache, torch.as_tensor(perm))
        np.testing.assert_allclose(tcache[1]["v"].numpy(), np.asarray(jcache[1]["v"]), **TOL)


@pytest.mark.parametrize("with_dec_mask", [False, True])
def test_decode_full_matches_jax(models, with_dec_mask):
    """Teacher-forced logits (the rescoring forward), with pad in the
    decoder ids; optionally with the decoder padding mask too."""
    jcfg, tcfg, params, tparams = models
    src, mask = _batch(jcfg, b=3)
    rng = np.random.default_rng(4)
    dec = rng.integers(3, jcfg.vocab_size, size=(3, 7)).astype(np.int32)
    dec[:, 0] = jcfg.decoder_start_token_id
    dec[1, 4:] = jcfg.pad_token_id
    dmask = (dec != jcfg.pad_token_id).astype(np.int32) if with_dec_mask else None
    jenc = jbart.encode(jcfg, params, jnp.asarray(src), jnp.asarray(mask))
    tenc = tbart.encode(tcfg, tparams, torch.as_tensor(src), torch.as_tensor(mask))
    want = np.asarray(jbart.decode_full(
        jcfg, params, jenc, jnp.asarray(mask), jnp.asarray(dec),
        None if dmask is None else jnp.asarray(dmask)))
    got = tbart.decode_full(tcfg, tparams, tenc, torch.as_tensor(mask), torch.as_tensor(dec),
                            None if dmask is None else torch.as_tensor(dmask))
    assert got.dtype == torch.float32 and got.shape == (3, 7, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_lm_logits_matches_jax(models):
    jcfg, tcfg, params, tparams = models
    h = np.random.default_rng(3).normal(size=(5, jcfg.d_model)).astype(np.float32)
    want = np.asarray(jbart.lm_logits(jcfg, params, jnp.asarray(h)))
    np.testing.assert_allclose(tbart.lm_logits(tcfg, tparams, torch.as_tensor(h)).numpy(),
                               want, **TOL)
    # bf16 operands keep an f32 result (the widened form off the card)
    bcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    got = tbart.lm_logits(bcfg, tconvert.cast_params(bcfg, tparams), torch.as_tensor(h))
    assert got.dtype == torch.float32


def test_cast_params_matches_jax(models):
    jcfg, tcfg, params, tparams = models
    jb = japi.cast_params(dataclasses.replace(jcfg, dtype="bfloat16"), params)
    tb = tconvert.cast_params(dataclasses.replace(tcfg, dtype="bfloat16"), tparams)
    assert tconvert.cast_params(tcfg, tparams) is tparams  # f32: no-op
    jl = jax.tree_util.tree_leaves(jb)
    tl = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, list):
            for v in node:
                walk(v)
        else:
            tl.append(node)

    walk(tb)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert (a.dtype == jnp.bfloat16) == (b.dtype == torch.bfloat16)
        np.testing.assert_array_equal(np.asarray(a, np.float32), b.float().numpy())


def test_apply_seal_logits_bias_matches_jax(models):
    jcfg, _, params, tparams = models
    cfg = dataclasses.replace(jcfg, mask_token_id=50)
    tcfg = tconfig.BartConfig(**dataclasses.asdict(cfg))
    want = np.asarray(jconvert.apply_seal_logits_bias(params, cfg)["final_logits_bias"])
    out = tconvert.apply_seal_logits_bias(tparams, tcfg)
    np.testing.assert_array_equal(out["final_logits_bias"].numpy(), want)
    assert np.isneginf(want[[0, 1, 50]]).all()
    assert not torch.isinf(tparams["final_logits_bias"]).any()  # input untouched
