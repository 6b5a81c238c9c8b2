"""The port's checkpoint loaders against ``seal_tpu.models.convert`` on the
same state dicts: the HF layout (with and without ``final_logits_bias``),
the fairseq layout (one embedding row short), a ``pytorch_model.bin``
directory, a ``.pt`` file with ``fairseq_checkpoint`` on and off and a T5
dict through both searchers' ``_load_models``.  The dicts are written from
JAX's seeded ``bart_tiny`` tree by ``chip_smoke.port_state_dict`` (the
inverse key map, which neither package writes; the card's checkpoints come
from the same writer).  The port's parameters equal JAX's, converted with
``params_from_jax``, bit for bit and dtype for dtype."""

import os

import jax
import numpy as np
import pytest
import torch

from chip_smoke import port_state_dict
from seal_tpu.models import bart as jbart
from seal_tpu.models import convert as jconvert
from seal_tpu.models import t5 as jt5
from seal_tpu.models.config import bart_tiny as jtiny
from seal_tpu.models.tokenizer import WordVocabTokenizer as JTok
from seal_tpu.retrieval.searcher import SEALSearcher as JSearcher
from seal_tpu_torch.models import convert as tconvert
from seal_tpu_torch.models.config import bart_tiny as ttiny
from seal_tpu_torch.retrieval.searcher import SEALSearcher as TSearcher

VOCAB = 40


def seeded_tree(cfg, seed=0, bias_seed=None):
    """JAX's ``bart_tiny`` tree from ``PRNGKey(seed)`` as numpy, with a
    seeded non-zero ``final_logits_bias`` when ``bias_seed`` is given."""
    tree = jax.device_get(dict(jbart.init_params(jax.random.PRNGKey(seed), cfg)))
    if bias_seed is not None:
        rng = np.random.default_rng(bias_seed)
        tree["final_logits_bias"] = rng.normal(0, 2, cfg.vocab_size).astype(np.float32)
    return tree


def assert_trees_equal(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            assert_trees_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_trees_equal(g, w)
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)


@pytest.fixture(scope="module")
def tree():
    return seeded_tree(jtiny(vocab_size=VOCAB), bias_seed=1)


def _want(jparams):
    return tconvert.params_from_jax(jax.device_get(jparams), None, device="cpu")


@pytest.mark.parametrize("layout,dtype", [("hf", torch.float32), ("hf_nobias", torch.float32),
                                          ("fairseq", torch.float32), ("hf", torch.float16),
                                          ("fairseq", torch.float16)])
def test_state_dict_loaders_match_jax(tree, layout, dtype):
    cfg_j, cfg_t = jtiny(vocab_size=VOCAB), ttiny(vocab_size=VOCAB)
    sd = port_state_dict(torch, tree, layout, dtype)
    before = {k: v.clone() for k, v in sd.items()}
    if layout == "fairseq":
        got = tconvert.from_fairseq_state_dict(sd, cfg_t, device="cpu")
        want = jconvert.from_fairseq_state_dict(sd, cfg_j)
        assert torch.equal(got["shared"][-1], torch.zeros(cfg_t.d_model, dtype=dtype))
    else:
        got = tconvert.from_hf_torch_state_dict(sd, cfg_t, device="cpu")
        want = jconvert.from_hf_torch_state_dict(sd, cfg_j)
    assert_trees_equal(got, _want(want))
    assert got["encoder"]["layers"][0]["fc1"]["kernel"].dtype == dtype
    got["shared"].add_(1.0)  # the dict is not aliased
    assert all(torch.equal(sd[k], before[k]) for k in sd)


def test_bf16_checkpoint_keeps_its_dtype(tree):
    """JAX cannot read a bf16 dict (numpy has no bf16); the port reads it
    as the same bf16 values."""
    cfg = ttiny(vocab_size=VOCAB)
    sd = port_state_dict(torch, tree, "hf", torch.bfloat16)
    got = tconvert.from_hf_torch_state_dict(sd, cfg, device="cpu")
    want = tconvert.from_hf_torch_state_dict(port_state_dict(torch, tree, "hf"), cfg, device="cpu")
    assert got["shared"].dtype == torch.bfloat16
    assert torch.equal(got["decoder"]["layers"][1]["cross_attn"]["q"]["kernel"],
                       want["decoder"]["layers"][1]["cross_attn"]["q"]["kernel"].bfloat16())
    with pytest.raises(TypeError):
        jconvert.from_hf_torch_state_dict(sd, jtiny(vocab_size=VOCAB))


def test_file_loaders_match_jax(tree, tmp_path):
    cfg_j, cfg_t = jtiny(vocab_size=VOCAB), ttiny(vocab_size=VOCAB)
    torch.save({"model": port_state_dict(torch, tree, "fairseq"), "args": None}, tmp_path / "fs.pt")
    assert_trees_equal(tconvert.load_fairseq_checkpoint(str(tmp_path / "fs.pt"), cfg_t, "cpu"),
                       _want(jconvert.load_fairseq_checkpoint(str(tmp_path / "fs.pt"), cfg_j)))
    os.makedirs(tmp_path / "hf")
    torch.save(port_state_dict(torch, tree, "hf"), tmp_path / "hf" / "pytorch_model.bin")
    want = _want(jconvert.load_hf_checkpoint(str(tmp_path / "hf"), cfg_j))
    for path in (tmp_path / "hf", tmp_path / "hf" / "pytorch_model.bin"):
        assert_trees_equal(tconvert.load_hf_checkpoint(str(path), cfg_t, device="cpu"), want)
    assert tconvert.load_lightning_checkpoint is tconvert.load_hf_checkpoint

    class Model:  # a model object: anything with ``state_dict()``
        def state_dict(self):
            return port_state_dict(torch, tree, "hf")

    assert_trees_equal(tconvert.load_hf_checkpoint(Model(), cfg_t, device="cpu"), want)


@pytest.mark.parametrize("fairseq", [True, False])
def test_load_models_pt_matches_jax(tree, tmp_path, fairseq):
    """``_load_models`` on a ``.pt`` file: the fairseq layout under
    ``fairseq_checkpoint`` (the default), the HF layout without it; the
    SEAL bias (-inf at pad and bos) applied after loading."""
    texts = [" alpha beta gamma delta", " epsilon zeta eta theta"]
    tok = JTok.train(texts, max_vocab=VOCAB)
    tok_path = str(tmp_path / "word_vocab.json")
    tok.save(tok_path)
    path = str(tmp_path / "model.pt")
    if fairseq:
        torch.save({"model": port_state_dict(torch, tree, "fairseq")}, path)
    else:
        torch.save(port_state_dict(torch, tree, "hf"), path)
    params = dict(backbone="tiny-word", fairseq_checkpoint=fairseq)
    cfg = jtiny(vocab_size=VOCAB)
    j = JSearcher._load_models(path, None, path, None, tok_path, cfg, params)
    t = TSearcher._load_models(path, None, path, None, tok_path, ttiny(vocab_size=VOCAB),
                               params, "cpu")
    assert t[0].encoder == j[0].encoder
    assert_trees_equal(t[2], _want(j[2]))
    assert t[3]["scorer_params"] is None and t[3]["code_params"] is None
    assert_trees_equal(t[3]["title_params"], _want(j[3]["title_params"]))
    assert t[2]["final_logits_bias"][1] == float("-inf")


def test_load_models_t5_dict_matches_jax(tmp_path):
    """A HF T5 dict (bare or under ``"model"``) through ``_load_models``
    with a ``t5`` backbone."""
    texts = [" alpha beta gamma delta", " epsilon zeta eta theta"]
    tok = JTok.train(texts, max_vocab=VOCAB)
    tok_path = str(tmp_path / "word_vocab.json")
    tok.save(tok_path)
    jcfg = jt5.t5_tiny(vocab_size=VOCAB)
    jparams = jax.device_get(jt5.init_params(jax.random.PRNGKey(3), jcfg))
    sd = {"shared.weight": torch.from_numpy(np.asarray(jparams["shared"]))}
    for side in ("encoder", "decoder"):
        p = jparams[side]
        sd[f"{side}.final_layer_norm.weight"] = torch.from_numpy(np.asarray(p["final_ln"]))
        sd[f"{side}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = \
            torch.from_numpy(np.asarray(p["rel_bias"]))
        for i, lp in enumerate(p["layers"]):
            b = f"{side}.block.{i}.layer"
            parts = [("0.SelfAttention", "self_attn", "ln_self")]
            if side == "decoder":
                parts.append(("1.EncDecAttention", "cross_attn", "ln_cross"))
            for name, key, ln in parts:
                for n in "qkvo":
                    sd[f"{b}.{name}.{n}.weight"] = torch.from_numpy(np.asarray(lp[key][n]).T.copy())
                sd[f"{b}.{name[0]}.layer_norm.weight"] = torch.from_numpy(np.asarray(lp[ln]))
            f = 2 if side == "decoder" else 1
            for n, w in lp["ffn"].items():
                sd[f"{b}.{f}.DenseReluDense.{n}.weight"] = torch.from_numpy(np.asarray(w).T.copy())
            sd[f"{b}.{f}.layer_norm.weight"] = torch.from_numpy(np.asarray(lp["ln_ffn"]))
    from seal_tpu_torch.models.t5 import t5_tiny as tt5_tiny

    for i, obj in enumerate((sd, {"model": sd})):
        path = str(tmp_path / f"t5_{i}.pt")
        torch.save(obj, path)
        params = dict(backbone="t5-tiny")
        j = JSearcher._load_models(path, None, None, None, tok_path, jcfg, params)
        t = TSearcher._load_models(path, None, None, None, tok_path, tt5_tiny(vocab_size=VOCAB),
                                   params, "cpu")
        assert_trees_equal(t[2], _want(j[2]))


def test_random_checkpoint_is_the_ports_own_seeded_weights(tmp_path):
    """``None`` and ``"random"`` give ``bart.init_params(cfg, 0)``, the
    port's seeded weights (not JAX's ``PRNGKey(0)`` ones), with the SEAL
    bias; the config follows the backbone and the tokenizer's vocab."""
    from seal_tpu_torch.models import bart as tbart

    tok = JTok.train([" alpha beta gamma"], max_vocab=VOCAB)
    tok_path = str(tmp_path / "word_vocab.json")
    tok.save(tok_path)
    for ckpt in (None, "random"):
        _, cfg, main, extra = TSearcher._load_models(ckpt, None, None, None, tok_path, None,
                                                     dict(backbone="tiny-word"), "cpu")
        assert cfg == ttiny(vocab_size=tok.vocab_size)
        want = tconvert.apply_seal_logits_bias(tbart.init_params(cfg, 0, "cpu"), cfg)
        assert_trees_equal(main, want)
        assert extra == dict(scorer_params=None, title_params=None, code_params=None)
