"""The port's dense parity mode (``exact_mask``) and (beam, token) tie order
(``exact_ties``) against ``seal_tpu``'s, on the CPU (the port runs its
kernels' plain versions).

``exact_mask`` generation over the Psi, compact and hybrid layouts equals
JAX's (tokens equal, scores within 1e-4), step by step too, and equals the
port's fast path bit for bit; under exact logit ties with ``exact_ties``
the port's fast path equals its dense mode and JAX's.  The ops and kernels
under them are held in ``test_torch_dense_counts.py``."""

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
from seal_tpu_torch.decoding import constrained as tc
from seal_tpu_torch.decoding import generate as tg
from seal_tpu_torch.index.device_index import TorchFMIndex
from seal_tpu_torch.index.wavelet import WaveletIndex
from seal_tpu_torch.kernels import beam_select
from seal_tpu_torch.models import bart as tbart
from seal_tpu_torch.models import convert as tconvert
from test_torch_dense_counts import _oov_host, forbid_counts
from test_torch_generate import _assert_same_hyps, _models, _random_corpus, _title_corpus

LAYOUTS = ("psi", "compact", "hybrid")


@pytest.fixture(scope="module")
def models():
    return _models()


def _port_index(host, layout, vocab=96):
    if layout == "psi":
        return TorchFMIndex.from_host(host, vocab=vocab, device="cpu")
    return WaveletIndex.from_host(host, vocab=vocab, keep_bwt=layout == "hybrid", device="cpu")


def _skewed_host(rng):
    docs = [[10, 11] * 40 + [2] for _ in range(40)]
    docs += [rng.integers(4, 90, size=20).tolist() + [2] for _ in range(10)]
    host = FMIndex()
    host.initialize(docs)
    return host


def _dense_case(case):
    """The corpora of ``tests/test_exact_proposals.py``: four seeds (two with
    ``stop_at_count``), the skewed bigram corpus and the OOV corpus."""
    if case.startswith("seed"):
        seed, stop = {"seed0": (0, 0), "seed1": (1, 0), "seed2": (2, 2), "seed3": (3, 1)}[case]
        host, queries = _random_corpus(seed)
        return host, queries, dict(num_beams=4, max_length=6, stop_at_count=stop)
    rng = np.random.default_rng(7 if case == "skewed" else 5)
    host = _skewed_host(rng) if case == "skewed" else _oov_host()
    queries = [[0] + rng.integers(4, 90, size=4).tolist() + [2] for _ in range(2)]
    return host, queries, dict(num_beams=3 if case == "skewed" else 4,
                               max_length=5 if case == "skewed" else 6)


def _canon(hyps):
    return [sorted((tuple(t), s) for s, t in h) for h in hyps]


@pytest.mark.parametrize("case", ["seed0", "seed1", "seed2", "seed3", "skewed", "oov"])
def test_exact_mask_generate_matches_jax(models, monkeypatch, case):
    """``exact_mask`` over the Psi, compact and hybrid layouts equals JAX's
    dense decode (tokens equal, scores within 1e-4), and the port's fast
    path under tiny proposal budgets bit for bit; with every entry to the
    [B, K, V] counts raising (the decode reads the count mask alone)."""
    jcfg, tcfg, params, tparams = models
    forbid_counts(monkeypatch)
    host, queries, kw = _dense_case(case)
    kw.update(min_length=1, forced_bos_token_id=None)
    ids, mask = jg.pad_batch(queries, jcfg.pad_token_id)
    jh = jg.fm_index_generate(jcfg, params, DeviceFMIndex.from_host(host, vocab=96), ids, mask,
                              exact_mask=True, **kw)
    assert sum(len(h) for h in jh) > 0
    for layout in LAYOUTS:
        idx = _port_index(host, layout)
        dense = tg.fm_index_generate(tcfg, tparams, idx, ids, mask, exact_mask=True,
                                     dense_chunk=17, **kw)
        assert tg.LAST_DECODE_STATS["fallback_steps"] == 0
        _assert_same_hyps(jh, dense)
        fast = tg.fm_index_generate(tcfg, tparams, idx, ids, mask, top_m=8, window=4,
                                    exact_chunk=4, **kw)
        assert _canon(fast) == _canon(dense), layout
        if case == "oov":
            assert all(t < 96 for h in dense for _, toks in h for t in toks)


def test_exact_mask_step_outputs_match_jax(models):
    """Raw dense-mode outputs: candidate tokens, parents, finiteness and
    selections equal JAX's step by step; scores within tolerance."""
    jcfg, tcfg, params, tparams = models
    host, queries = _random_corpus(1)
    ids, mask = jg.pad_batch(queries, jcfg.pad_token_id)
    kw = dict(num_beams=4, max_length=6, min_length=2, exact_mask=True, stop_at_count=1)
    jo = jc.constrained_beam_search(
        jcfg, params, DeviceFMIndex.from_host(host, vocab=96), jc.DecodeConfig(**kw),
        jbart.encode(jcfg, params, jnp.asarray(ids), jnp.asarray(mask)), jnp.asarray(mask))
    tids, tmask = torch.as_tensor(ids), torch.as_tensor(mask)
    to = tc.constrained_beam_search(tcfg, tparams, _port_index(host, "psi"),
                                    tc.DecodeConfig(**kw), tbart.encode(tcfg, tparams, tids, tmask),
                                    tmask)
    for f in ("cand_tokens", "cand_parents", "cand_finite", "sel_tokens", "sel_parents",
              "final_tokens", "final_valid", "fallback_steps"):
        np.testing.assert_array_equal(getattr(to, f).numpy(), np.asarray(getattr(jo, f)), f)
    for f in ("cand_scores", "final_scores"):
        a, b = np.asarray(getattr(jo, f)), getattr(to, f).numpy()
        fin = a > tc.NEG_INF / 2
        np.testing.assert_array_equal(fin, b > tc.NEG_INF / 2)
        np.testing.assert_allclose(b[fin], a[fin], atol=1e-4, rtol=0)


def test_exact_mask_forced_prefix_matches_jax(models):
    """The title decode's settings (forced prefix, custom EOS, min_length 1)
    in dense mode: equal to JAX's, and to the port's fast path."""
    jcfg, tcfg, params, tparams = models
    host, queries = _title_corpus(2)
    kw = dict(num_beams=4, max_length=7, min_length=1, eos_token_id=50, force_decoding_from=[2],
              forced_bos_token_id=None)
    ids, mask = jg.pad_batch(queries, jcfg.pad_token_id)
    jh = jg.fm_index_generate(jcfg, params, DeviceFMIndex.from_host(host, vocab=96), ids, mask,
                              exact_mask=True, **kw)
    for layout in LAYOUTS:
        idx = _port_index(host, layout)
        dense = tg.fm_index_generate(tcfg, tparams, idx, ids, mask, exact_mask=True, **kw)
        _assert_same_hyps(jh, dense)
        fast = tg.fm_index_generate(tcfg, tparams, idx, ids, mask, window=4, exact_chunk=4, **kw)
        assert _canon(fast) == _canon(dense), layout


@pytest.fixture(scope="module")
def tied():
    """``tests/test_exact_proposals.py``'s adversarial ties: a block of
    tokens shares one embedding row, so their logits tie exactly at every
    step, and the corpus holds only them."""
    jcfg, tcfg, params, _ = _models()
    rng = np.random.default_rng(11)
    tied_toks = list(range(10, 26))
    docs = [[int(t) for t in rng.choice(tied_toks, size=10)] + [2] for _ in range(30)]
    host = FMIndex()
    host.initialize(docs)
    params = dict(params)
    shared = np.array(params["shared"])
    shared[tied_toks] = shared[tied_toks[0]]
    params["shared"] = jnp.asarray(shared)
    tparams = tconvert.params_from_jax(jax.device_get(params), tcfg, device="cpu")
    queries = [[0] + rng.integers(4, 90, size=4).tolist() + [2] for _ in range(2)]
    return jcfg, tcfg, params, tparams, host, queries


@pytest.mark.parametrize("layout", LAYOUTS)
def test_exact_ties_fast_equals_dense_and_jax(tied, layout):
    """Under exact ties: the port's fast path with ``exact_ties`` (kernel
    8's ties mode) equals its dense mode bit for bit, and both equal JAX's
    fast path with ``exact_ties`` and JAX's dense mode; without
    ``exact_ties`` the fast path differs from the dense mode."""
    jcfg, tcfg, params, tparams, host, queries = tied
    ids, mask = jg.pad_batch(queries, jcfg.pad_token_id)
    common = dict(num_beams=4, max_length=5, min_length=1, forced_bos_token_id=None,
                  exact_ties=True)
    jidx = DeviceFMIndex.from_host(host, vocab=96)
    jloop = jg.fm_index_generate(jcfg, params, jidx, ids, mask, top_m=8, window=4, exact_chunk=4,
                                 **common)
    jdense = jg.fm_index_generate(jcfg, params, jidx, ids, mask, exact_mask=True, **common)
    idx = _port_index(host, layout)
    n0 = beam_select.TIES.launches
    fast = tg.fm_index_generate(tcfg, tparams, idx, ids, mask, top_m=8, window=4, exact_chunk=4,
                                **common)
    assert beam_select.TIES.launches == n0  # plain versions on the CPU
    dense = tg.fm_index_generate(tcfg, tparams, idx, ids, mask, exact_mask=True, **common)
    assert _canon(fast) == _canon(dense)
    assert sum(len(h) for h in fast) > 0
    # the ties are real: without exact_ties the fast path keeps slot order
    common["exact_ties"] = False
    untied = tg.fm_index_generate(tcfg, tparams, idx, ids, mask, top_m=8, window=4,
                                  exact_chunk=4, **common)
    assert _canon(untied) != _canon(dense)
    _assert_same_hyps(jloop, fast)
    _assert_same_hyps(jdense, dense)
