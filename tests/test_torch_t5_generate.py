"""T5 through the port's constrained decoder and searcher against
``seal_tpu``'s, on the CPU (the kernels' plain versions), at ``t5_tiny``
(vocab 60, f32, weights through ``params_from_jax``) over corpora in T5's
convention (content ids 2.., documents ending in eos 1; pad = bos =
decoder start = 0).

``constrained_beam_search``'s raw outputs (every candidate, parent,
selection and final beam; scores within atol 1e-4, f32 sums in another
order) equal JAX's on the Psi, compact and hybrid layouts for the fast
path, ``force_full``, ``exact_mask`` and three diverse groups; the port's
fast path equals its own ``force_full`` bit for bit; ``fm_index_generate``
gives JAX's hypotheses.  ``SEALSearcher(backbone="t5-...")`` takes the
reference's T5 constants and returns the JAX searcher's documents in
order, with rescoring and unigram scores, titles off (the ``t5`` branch's
title markers are ids 32000-32001) and on (a 32128-id tiny model over a
corpus that carries them; as in JAX, no title key survives there)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal_tpu.decoding import constrained as jc
from seal_tpu.decoding import generate as jg
from seal_tpu.index import FMIndex
from seal_tpu.index.device_index import DeviceFMIndex
from seal_tpu.models import t5 as jt5
from seal_tpu.retrieval.searcher import SEALSearcher as JSearcher
from seal_tpu_torch.decoding import constrained as tc
from seal_tpu_torch.decoding import generate as tg
from seal_tpu_torch.models import convert as tconvert
from seal_tpu_torch.models import t5 as tt5
from seal_tpu_torch.retrieval.searcher import SEALSearcher as TSearcher
from test_t5_searcher import IdTokenizer
from test_torch_dense import LAYOUTS, _port_index
from test_torch_generate import _assert_same_hyps
from test_torch_modes import _assert_same_raw

V = 60
T5_IDS = dict(pad_token_id=0, eos_token_id=1, decoder_start_token_id=0)
ROUTES = {
    "fast": dict(window=4, exact_chunk=4),
    "force_full": dict(window=4, exact_chunk=4, force_full=True),
    "exact_mask": dict(exact_mask=True),
    "diverse": dict(num_beams=6, num_groups=3, diversity_penalty=0.5, window=4),
}


@functools.lru_cache(maxsize=None)
def _world(seed):
    """Corpus, queries (no BOS, eos last) and both packages' weights."""
    rng = np.random.default_rng(seed)
    docs = [rng.integers(2, V, size=rng.integers(5, 25)).tolist() + [1] for _ in range(30)]
    host = FMIndex()
    host.initialize(docs)
    queries = [rng.integers(2, V, size=5).tolist() + [1] for _ in range(3)]
    jcfg, tcfg = jt5.t5_tiny(V), tt5.t5_tiny(V)
    params = jt5.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = tconvert.params_from_jax(jax.device_get(params), tcfg, device="cpu")
    return host, queries, jcfg, tcfg, params, tparams


def _kw(route):
    kw = dict(num_beams=4, max_length=6, min_length=1, stop_at_count=0, **T5_IDS)
    kw.update(ROUTES[route])
    return kw


@functools.lru_cache(maxsize=None)
def _jax_raw(seed, route):
    host, queries, jcfg, _, params, _ = _world(seed)
    ids, mask = jg.pad_batch(queries, jcfg.pad_token_id)
    enc = jt5.encode(jcfg, params, jnp.asarray(ids), jnp.asarray(mask))
    return jc.constrained_beam_search(jcfg, params, DeviceFMIndex.from_host(host, vocab=V),
                                      jc.DecodeConfig(**_kw(route)), enc, jnp.asarray(mask))


def _port_raw(seed, route, layout):
    host, queries, _, tcfg, _, tparams = _world(seed)
    ids, mask = jg.pad_batch(queries, tcfg.pad_token_id)
    tids, tmask = torch.as_tensor(ids), torch.as_tensor(mask)
    enc = tt5.encode(tcfg, tparams, tids, tmask)
    return tc.constrained_beam_search(tcfg, tparams, _port_index(host, layout, vocab=V),
                                      tc.DecodeConfig(**_kw(route)), enc, tmask)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("seed", [0, 1])
def test_t5_raw_outputs_match_jax(seed, layout, route):
    to = _port_raw(seed, route, layout)
    assert bool(to.cand_finite.any())
    _assert_same_raw(_jax_raw(seed, route), to)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_t5_fast_path_equals_force_full(layout):
    """Within the port: the fast path's raw outputs are ``force_full``'s,
    scores bit for bit."""
    for seed in (0, 1):
        fast, full = _port_raw(seed, "fast", layout), _port_raw(seed, "force_full", layout)
        for f in ("cand_tokens", "cand_parents", "cand_finite", "sel_tokens", "sel_parents",
                  "final_tokens", "final_valid", "cand_scores", "final_scores"):
            assert torch.equal(getattr(fast, f), getattr(full, f)), f


@pytest.mark.parametrize("route", ["fast", "exact_mask", "diverse"])
def test_t5_fm_index_generate_matches_jax(route):
    """Through both entry points with their defaults (the auto window and
    proof budget); hypotheses carry the decoder start 0 first."""
    host, queries, jcfg, tcfg, params, tparams = _world(2)
    kw = dict(num_beams=4, max_length=6, min_length=1, forced_bos_token_id=None)
    if route == "exact_mask":
        kw["exact_mask"] = True
    elif route == "diverse":
        kw.update(num_beams=6, diverse_bs_groups=3, diverse_bs_penalty=0.5)
    jh = jg.fm_index_generate(jcfg, params, DeviceFMIndex.from_host(host, vocab=V), queries, **kw)
    th = tg.fm_index_generate(tcfg, tparams, _port_index(host, "psi", vocab=V), queries, **kw)
    assert sum(map(len, th)) > 0
    assert all(toks[0] == 0 for h in th for _, toks in h)
    _assert_same_hyps(jh, th)
    for h in th:  # every key occurs in the corpus
        for _, toks in h:
            key = [t for t in toks[1:] if t not in (0, 1)]
            if key:
                assert host.get_count(key) > 0, toks


# ------------------------------------------------------------------ searcher


SEARCH_KNOBS = dict(backbone="t5-base", beam=3, length=4, batch_size=2, rescore=True,
                    unigram_scores=True, add_query_to_keys=True, progress=False)


def _searchers(vocab, docs, titles, boosted):
    """Both searchers over ``docs``; a ``final_logits_bias`` (a stand-in for
    a trained model: the JAX module adds it when the tree has one) boosts
    the tokens of the ``boosted`` documents by 6-7 each, so their keys beat
    their corpus frequency in the log-odds score."""
    tok = IdTokenizer(vocab)
    index = FMIndex()
    index.initialize(docs, labels=[f"d{i}" for i in range(len(docs))])
    jcfg, tcfg = jt5.t5_tiny(vocab), tt5.t5_tiny(vocab)
    rng = np.random.default_rng(len(docs))
    bias = np.zeros(vocab, np.float32)
    for i in boosted:
        for t in docs[i]:
            bias[t] = 6.0 + rng.random()
    params = dict(jt5.init_params(jax.random.PRNGKey(0), jcfg), final_logits_bias=bias)
    tparams = tconvert.params_from_jax(jax.device_get(params), tcfg, device="cpu")
    knobs = dict(SEARCH_KNOBS, decode_titles=titles)
    return (JSearcher(index, tok, jcfg, params, **knobs),
            TSearcher(index, tok, tcfg, tparams, **knobs))


def _assert_same_search(js, ts, queries):
    for attr in ("title_bos_token_id", "title_eos_token_id", "code_bos_token_id",
                 "code_eos_token_id", "prepend_space", "strip_token_ids"):
        assert getattr(ts, attr) == getattr(js, attr), attr
    assert (ts.title_bos_token_id, ts.title_eos_token_id, ts.code_bos_token_id,
            ts.code_eos_token_id, ts.prepend_space, ts.strip_token_ids) == (
        1, 32000, 32000, 32001, False, (0, 1))
    for q in queries[:2]:
        (jk, ju), (tk, tu) = js.generate_keys(q), ts.generate_keys(q)
        assert [k for k, _ in tk] == [k for k, _ in jk]
        np.testing.assert_allclose([s for _, s in tk], [s for _, s in jk], atol=1e-4, rtol=0)
        np.testing.assert_allclose(tu, ju, atol=1e-5, rtol=0)
    jres, tres = js.batch_search(queries, k=5), ts.batch_search(queries, k=5)
    assert all(tres)
    for jd, td in zip(jres, tres):
        assert [d.docid for d in td] == [d.docid for d in jd]
        np.testing.assert_allclose([d.score for d in td], [d.score for d in jd], rtol=1e-4)


def test_t5_searcher_matches_jax():
    """``tests/test_t5_searcher.py``'s setting at 40 documents: the ``t5``
    constants, every key with its rescored score, the unigram vector, and
    the documents in order with their scores."""
    rng = np.random.default_rng(0)
    docs = [rng.integers(2, 80, size=14).tolist() + [1] for _ in range(40)]
    js, ts = _searchers(80, docs, titles=False, boosted=(0, 7, 19))
    queries = [" ".join(f"t{t}" for t in docs[i][2:6]) for i in (0, 7, 19)]
    _assert_same_search(js, ts, queries)


def test_t5_searcher_with_titles_matches_jax():
    """Titles on: documents ``title 32000 body 1`` (the markers of the
    ``t5`` branch), so the title decode forced from eos 1 reads titles; a
    32128-id tiny model."""
    rng = np.random.default_rng(1)
    docs = [rng.integers(2, 60, size=3).tolist() + [32000]
            + rng.integers(2, 80, size=12).tolist() + [1] for _ in range(30)]
    js, ts = _searchers(32128, docs, titles=True, boosted=(0, 11))
    queries = [" ".join(f"t{t}" for t in docs[i][5:9]) for i in (0, 11)]
    _assert_same_search(js, ts, queries)
    # a fault of the JAX package, kept: a title hypothesis starts with T5's
    # decoder start 0, where BART's decoder start is its title BOS, so the
    # searcher's [title BOS 1] + hypothesis never occurs in the corpus and
    # its count filter drops every title key
    for q in queries:
        keys, _ = ts.generate_keys(q)
        assert keys and not any(k[0] == ts.title_bos_token_id for k, _ in keys)
