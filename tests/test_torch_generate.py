"""The torch port's constrained generation against ``seal_tpu``'s, on the
``test_exact_proposals`` setups (bart_tiny, vocab 96, f32, CPU; the port
runs its kernels' plain versions): identical hypotheses -- token lists
equal, scores within atol 1e-4 (f32 sums in another order) -- and
identical per-step candidates, parents and selections.  Also the host redo
of an unsound step, fast == force_full within the port, the forced-prefix
decode with a custom EOS, the keyword parity with the JAX entry point, the
numpy copies of the JAX helpers, the mode not ported yet (a mesh), and the
import guard.  The dense parity mode and the tie order are held in
``test_torch_dense.py``, free generation in ``test_torch_free.py``, the
speculative, top-k, forced-BOS and hook modes in ``test_torch_modes.py``,
sampling in ``test_torch_sample.py`` and diverse groups in
``test_torch_diverse.py``."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal_tpu.decoding import constrained as jc
from seal_tpu.decoding import generate as jg
from seal_tpu.index import FMIndex
from seal_tpu.index.device_index import DeviceFMIndex
from seal_tpu.models import bart as jbart
from seal_tpu.models.config import bart_tiny as jtiny
from seal_tpu_torch.decoding import constrained as tc
from seal_tpu_torch.decoding import generate as tg
from seal_tpu_torch.index.device_index import TorchFMIndex
from seal_tpu_torch.models import bart as tbart
from seal_tpu_torch.models import convert as tconvert
from seal_tpu_torch.models.config import bart_tiny as ttiny
from seal_tpu_torch.parallel.mesh import Mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORE_ATOL = 1e-4


def _models(V=96, bias=None, scale_bias=1.0):
    jcfg, tcfg = jtiny(vocab_size=V), ttiny(vocab_size=V)
    params = dict(jbart.init_params(jax.random.PRNGKey(0), jcfg))
    if bias is not None:
        params["final_logits_bias"] = params["final_logits_bias"] * scale_bias + jnp.asarray(bias)
    tparams = tconvert.params_from_jax(jax.device_get(params), tcfg, device="cpu")
    return jcfg, tcfg, params, tparams


@pytest.fixture(scope="module")
def models():
    return _models()


def _assert_same_hyps(jh, th):
    assert len(jh) == len(th)
    for a, b in zip(jh, th):
        ka = sorted((tuple(t), s) for s, t in a)
        kb = sorted((tuple(t), s) for s, t in b)
        assert [t for t, _ in ka] == [t for t, _ in kb]
        np.testing.assert_allclose([s for _, s in kb], [s for _, s in ka], atol=SCORE_ATOL, rtol=0)


def _random_corpus(seed, hi=90, n_docs=30):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(4, hi, size=rng.integers(5, 30)).tolist() + [2] for _ in range(n_docs)]
    host = FMIndex()
    host.initialize(docs)
    queries = [[0] + rng.integers(4, 90, size=5).tolist() + [2] for _ in range(3)]
    return host, queries


def _both(models, host, queries, V=96, **kw):
    jcfg, tcfg, params, tparams = models
    ids, mask = jg.pad_batch(queries, jcfg.pad_token_id)
    jh = jg.fm_index_generate(jcfg, params, DeviceFMIndex.from_host(host, vocab=V), ids, mask, **kw)
    th = tg.fm_index_generate(tcfg, tparams, TorchFMIndex.from_host(host, vocab=V, device="cpu"),
                              ids, mask, **kw)
    return jh, th


COMMON = dict(num_beams=4, max_length=6, min_length=1, forced_bos_token_id=None)


@pytest.mark.parametrize(
    "seed,stop_at_count,budget",
    [(0, 0, "tiny"), (1, 0, "tiny"), (2, 2, "tiny"), (3, 1, "tiny"), (0, 0, "default"),
     (1, 0, "default"), (4, 0, "default")],
)
def test_generate_matches_jax(models, seed, stop_at_count, budget):
    host, queries = _random_corpus(seed)
    kw = dict(window=4, exact_chunk=4) if budget == "tiny" else {}
    jh, th = _both(models, host, queries, stop_at_count=stop_at_count, **kw, **COMMON)
    assert sum(len(h) for h in th) > 0
    _assert_same_hyps(jh, th)


def test_generate_min_length_and_eos_options_match_jax(models):
    host, queries = _random_corpus(5)
    jh, th = _both(models, host, queries, num_beams=3, max_length=7, min_length=4,
                   forced_bos_token_id=None, always_allow_eos=True, window=4, exact_chunk=4)
    _assert_same_hyps(jh, th)


def test_skewed_and_oov_corpora_match_jax(models):
    """Huge intervals with few continuations (bucket pruning, dead space)
    and a corpus alphabet past the model vocab (OOV symbols filtered)."""
    rng = np.random.default_rng(7)
    docs = [[10, 11] * 40 + [2] for _ in range(40)]
    docs += [rng.integers(4, 90, size=20).tolist() + [2] for _ in range(10)]
    host = FMIndex()
    host.initialize(docs)
    queries = [[0] + rng.integers(4, 90, size=4).tolist() + [2] for _ in range(2)]
    kw = dict(num_beams=3, max_length=5, min_length=1, forced_bos_token_id=None)
    _assert_same_hyps(*_both(models, host, queries, window=4, exact_chunk=4, **kw))

    host, queries = _random_corpus(5, hi=140, n_docs=40)
    jh, th = _both(models, host, queries, window=4, exact_chunk=4, **COMMON)
    _assert_same_hyps(jh, th)
    assert all(t < 96 for h in th for _, toks in h for t in toks)


@pytest.mark.parametrize("seed", [0, 1])
def test_lm_averse_corpus_matches_jax(seed):
    """Every LM-preferred token is invalid; the slab floods the buffer."""
    rng = np.random.default_rng(100 + seed)
    alphabet = list(range(40, 70))
    docs = [[int(t) for t in rng.choice(alphabet, size=rng.integers(6, 20))] + [2]
            for _ in range(25)]
    host = FMIndex()
    host.initialize(docs)
    bias = np.zeros(96, np.float32)
    bias[alphabet] = -8.0
    bias[rng.choice(alphabet, size=4, replace=False)] = -2.0
    queries = [[0] + rng.integers(4, 90, size=4).tolist() + [2] for _ in range(2)]
    kw = dict(num_beams=4, max_length=5, min_length=1, forced_bos_token_id=None)
    _assert_same_hyps(*_both(_models(bias=bias), host, queries, window=4, exact_chunk=1, **kw))


def test_step_outputs_match_jax(models):
    """Raw beam-search outputs: candidate tokens, parents, finiteness and
    selections equal JAX's step by step; scores within tolerance."""
    jcfg, tcfg, params, tparams = models
    host, queries = _random_corpus(1)
    ids, mask = jg.pad_batch(queries, jcfg.pad_token_id)
    jdc = jc.DecodeConfig(num_beams=4, max_length=6, min_length=2, window=4, exact_chunk=4)
    tdc = tc.DecodeConfig(num_beams=4, max_length=6, min_length=2, window=4, exact_chunk=4)
    jenc = jbart.encode(jcfg, params, jnp.asarray(ids), jnp.asarray(mask))
    jo = jc.constrained_beam_search(jcfg, params, DeviceFMIndex.from_host(host, vocab=96), jdc,
                                    jenc, jnp.asarray(mask))
    tids, tmask = torch.as_tensor(ids), torch.as_tensor(mask)
    tenc = tbart.encode(tcfg, tparams, tids, tmask)
    to = tc.constrained_beam_search(tcfg, tparams,
                                    TorchFMIndex.from_host(host, vocab=96, device="cpu"), tdc,
                                    tenc, tmask)
    for f in ("cand_tokens", "cand_parents", "cand_finite", "sel_tokens", "sel_parents",
              "final_tokens", "final_valid", "fallback_steps"):
        np.testing.assert_array_equal(getattr(to, f).numpy(), np.asarray(getattr(jo, f)), f)
    for f in ("cand_scores", "final_scores"):
        a, b = np.asarray(getattr(jo, f)), getattr(to, f).numpy()
        fin = a > tc.NEG_INF / 2
        np.testing.assert_array_equal(fin, b > tc.NEG_INF / 2)
        np.testing.assert_allclose(b[fin], a[fin], atol=SCORE_ATOL, rtol=0)


def _fallback_setup():
    """One bigram interval whose high-lp continuation hides past round 0's
    examined prefix while the slab floods the buffer (the JAX package's
    ``test_host_redo_on_fallback_through_generate`` shape)."""
    V = 30
    units = [(20, 11), (21, 12), (22, 13), (23, 14), (24, 11), (25, 12), (26, 13), (27, 14),
             (28, 15)]
    host = FMIndex()
    host.initialize([[t for c, x in units for t in (c, 10, x)]])
    bias = np.full(V, -100.0, np.float32)
    bias[:8] = -1.0 - 0.01 * np.arange(8)
    bias[15] = -2.0
    for x in (11, 12, 13, 14):
        bias[x] = -50.0 - x
    bias[10] = -3.0
    return host, _models(V=V, bias=bias * 8.0, scale_bias=0.0)


def test_host_redo_on_fallback_matches_jax():
    host, models = _fallback_setup()
    kw = dict(num_beams=2, max_length=6, exact_chunk=1, window=4)
    jh, th = _both(models, host, [[0, 5, 6, 2]], V=30, **kw)
    assert jg.LAST_DECODE_STATS["fallback_steps"] > 0
    assert tg.LAST_DECODE_STATS["fallback_steps"] == jg.LAST_DECODE_STATS["fallback_steps"]
    _assert_same_hyps(jh, th)
    n = 0
    for _, toks in th[0]:
        key = [t for t in toks if t not in (0, 1, 2)]
        if key:
            assert host.get_count(key) > 0, key
            n += 1
    assert n > 0


def test_fast_select_flags_unsound_step():
    """``_fast_exact_select`` raises the flag when a missed token could
    reach the cutoff, and ``force_full`` selects it (token 15)."""
    host, _ = _fallback_setup()
    idx = TorchFMIndex.from_host(host, vocab=30, device="cpu")
    ops = tc.SingleIndexOps(idx)
    lo, hi = host.get_range([10])
    B, K, V = 1, 2, 30
    cfg = tc.DecodeConfig(num_beams=K, exact_chunk=1, window=4)
    lp = torch.full((B * K, V), -100.0)
    lp[:, :8] = -1.0 - 0.01 * torch.arange(8)
    lp[:, 15] = -2.0
    for x in (11, 12, 13, 14):
        lp[:, x] = -50.0 - x
    args = (lp, torch.full((B, K), lo, dtype=torch.int32), torch.full((B, K), hi, dtype=torch.int32),
            torch.full((B, K), hi - lo, dtype=torch.int32), torch.zeros((B, K), dtype=torch.bool),
            torch.zeros((B, K)))
    _, bad = tc._fast_exact_select(ops, cfg, *args, K)
    assert bool(bad)
    out, bad = tc._fast_exact_select(ops, cfg, *args, K, force_full=True)
    assert not bool(bad)
    c_tok, c_fin = out[0], out[3]
    assert 15 in {int(t) for t, f in zip(c_tok[0], c_fin[0]) if f}


def test_fast_equals_force_full(models):
    host, queries = _random_corpus(2)
    jcfg, tcfg, _, tparams = models
    idx = TorchFMIndex.from_host(host, vocab=96, device="cpu")
    kw = dict(window=4, exact_chunk=2, **COMMON)
    fast = tg.fm_index_generate(tcfg, tparams, idx, queries, **kw)
    full = tg.fm_index_generate(tcfg, tparams, idx, queries, force_full=True, **kw)
    assert [sorted((tuple(t), s) for s, t in h) for h in fast] == [
        sorted((tuple(t), s) for s, t in h) for h in full
    ]


def test_extract_hypotheses_and_pad_batch_match_jax():
    rng = np.random.default_rng(0)
    S, B, K, L = 4, 3, 2, 5
    arrays = dict(
        cand_tokens=rng.integers(0, 50, (S, B, 2 * K)).astype(np.int32),
        cand_parents=rng.integers(0, K, (S, B, 2 * K)).astype(np.int32),
        cand_scores=rng.normal(size=(S, B, 2 * K)).astype(np.float32),
        cand_finite=rng.random((S, B, 2 * K)) < 0.7,
        sel_tokens=rng.integers(0, 50, (S, B, K)).astype(np.int32),
        sel_parents=rng.integers(0, K, (S, B, K)).astype(np.int32),
        final_scores=np.where(rng.random((B, K)) < 0.8, rng.normal(size=(B, K)), -np.inf)
        .astype(np.float32),
        final_tokens=rng.integers(0, 50, (B, K, L)).astype(np.int32),
        final_valid=rng.random((B, K)) < 0.8,
        fallback_steps=np.int32(0),
    )
    arrays["cand_finite"][1] = False  # a step with no finite candidate
    want = jg.extract_hypotheses(jc.BeamSearchOutput(**arrays), jc.DecodeConfig(num_beams=K))
    got = tg.extract_hypotheses(tc.BeamSearchOutput(**arrays), tc.DecodeConfig(num_beams=K))
    assert got == want
    seqs = [[5, 6, 7], [1], list(range(11))]
    for multiple in (1, 8):
        for a, b in zip(tg.pad_batch(seqs, 1, multiple), jg.pad_batch(seqs, 1, multiple)):
            np.testing.assert_array_equal(a, b)


def _title_corpus(seed, marker=50):
    """Docs of ``title tokens, marker, body tokens, EOS``: a forced prefix
    [2] (EOS) pins a decode to the starts of documents, and the marker is
    the title decode's custom EOS."""
    rng = np.random.default_rng(seed)
    docs = [rng.integers(4, 40, size=rng.integers(1, 4)).tolist() + [marker]
            + rng.integers(4, 90, size=rng.integers(5, 20)).tolist() + [2] for _ in range(30)]
    host = FMIndex()
    host.initialize(docs)
    queries = [[0] + rng.integers(4, 90, size=5).tolist() + [2] for _ in range(3)]
    return host, queries


@pytest.mark.parametrize(
    "seed,forced,budget",
    [(0, [2], "tiny"), (1, [2], "default"), (2, "two", "tiny"), (3, [2, 95], "tiny")],
)
def test_force_decoding_from_matches_jax(models, seed, forced, budget):
    """Title-decode settings (the searcher's): a forced range prefix, a
    custom EOS (the title marker) and min_length 1; a two-token prefix
    taken from the corpus; and a prefix absent from the corpus (empty
    start range).  Hypotheses equal JAX's, and the fast path equals
    ``force_full`` within the port."""
    host, queries = _title_corpus(seed)
    if forced == "two":
        forced = [2, int(host.text[0]) - 1]  # EOS, then the first token of a document
    kw = dict(window=4, exact_chunk=4) if budget == "tiny" else {}
    kw.update(num_beams=4, max_length=7, min_length=1, eos_token_id=50,
              force_decoding_from=forced, forced_bos_token_id=None)
    jh, th = _both(models, host, queries, **kw)
    assert sum(len(h) for h in th) > 0
    _assert_same_hyps(jh, th)
    _, tcfg, _, tparams = models
    full = tg.fm_index_generate(tcfg, tparams,
                                TorchFMIndex.from_host(host, vocab=96, device="cpu"), queries,
                                force_full=True, **kw)
    assert [sorted((tuple(t), s) for s, t in h) for h in th] == [
        sorted((tuple(t), s) for s, t in h) for h in full
    ]


def test_generate_keywords_match_jax():
    """Every keyword of the JAX ``fm_index_generate_async`` is accepted by
    the port's, with the same default (the searcher passes them all)."""
    import inspect

    want = inspect.signature(jg.fm_index_generate_async).parameters
    got = inspect.signature(tg.fm_index_generate_async).parameters
    for name, p in want.items():
        assert name in got, name
        assert got[name].default == p.default, name
    _, tcfg, _, _ = _models(V=30)
    host, _ = _random_corpus(0, hi=28)
    # top_m is clamped to the vocab and stored, as in JAX
    captured = {}
    real = tg._search

    def spy(model_cfg, params, index, dcfg, ids, mask, *seed):
        captured["dcfg"] = dcfg
        return real(model_cfg, params, index, dcfg, ids, mask, *seed)

    tg._search = spy
    try:
        tg.fm_index_generate(tcfg, tbart.init_params(tcfg, device="cpu"),
                             TorchFMIndex.from_host(host, vocab=30, device="cpu"),
                             [[0, 5, 6, 2]], num_beams=2, max_length=3, top_m=256)
    finally:
        tg._search = real
    assert captured["dcfg"].top_m == 30


@pytest.mark.parametrize("option", [dict(mesh=Mesh(1, 2, 0, "cpu"))])
def test_unported_modes_raise(models, option):
    """A mesh with a ``model`` axis (tensor-parallel decode, ROADMAP A.7b)."""
    jcfg, tcfg, _, tparams = models
    host, queries = _random_corpus(0)
    with pytest.raises(NotImplementedError):
        tg.fm_index_generate(tcfg, tparams, TorchFMIndex.from_host(host, vocab=96, device="cpu"),
                             queries, num_beams=4, max_length=4, **option)


def test_port_imports_without_jax():
    """``seal_tpu_torch`` and ``chip_smoke`` import with jax, flax and regex
    blocked (the machine with the card has none of them), and with
    ``seal_tpu`` blocked too: the port keeps its own copies of the host
    modules it needs."""
    code = r"""
import importlib, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "flax", "regex", "seal_tpu")
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
import seal_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(seal_tpu_torch.__path__, "seal_tpu_torch.")]
assert {"seal_tpu_torch.kernels.locate", "seal_tpu_torch.kernels.row_select",
        "seal_tpu_torch.kernels.train_loss", "seal_tpu_torch.kernels.adamw",
        "seal_tpu_torch.training.trainer", "seal_tpu_torch.training.checkpoint",
        "seal_tpu_torch.training.data_gen", "seal_tpu_torch.training.parity",
        "seal_tpu_torch.utils.textfix",
        "seal_tpu_torch.cli.train", "seal_tpu_torch.cli.make_supervised_dpr_dataset",
        "seal_tpu_torch.cli.make_supervised_kilt_dataset",
        "seal_tpu_torch.cli.make_unsupervised_dataset",
        "seal_tpu_torch.cli.build_fm_index", "seal_tpu_torch.cli.search",
        "seal_tpu_torch.cli.serve", "seal_tpu_torch.data.formats",
        "seal_tpu_torch.utils.batching", "seal_tpu_torch.parallel.mesh",
        "seal_tpu_torch.parallel.multihost"} <= set(mods)
for m in mods:
    importlib.import_module(m)
import chip_smoke
assert not any(n.split(".")[0] in BLOCKED for n in sys.modules)
print(len(mods))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15
