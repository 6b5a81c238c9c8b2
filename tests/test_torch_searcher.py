"""The port's ``SEALSearcher.batch_search`` against ``seal_tpu``'s, end to
end on the CPU: body decode, title decode (forced prefix, custom EOS),
rescoring, query decomposition, unigram scores and the ranker, through the
same word-vocab corpus, the same bart_tiny weights (``params_from_jax``)
and a deterministic logit bias, with ``pipeline`` on and off.  Doc ids
equal and in the same order, scores within 1e-4 relative, ``include_keys``
key lists equal.  Also the ``res/sample`` corpus end to end, the knobs not
ported yet, and the raw title keys' grounding."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seal_tpu.index import FMIndex
from seal_tpu.models import bart as jbart
from seal_tpu.models.config import bart_tiny as jtiny
from seal_tpu.models.tokenizer import WordVocabTokenizer as JTok
from seal_tpu.retrieval.searcher import SEALSearcher as JSearcher
from seal_tpu_torch.models import convert as tconvert
from seal_tpu_torch.models.config import bart_tiny as ttiny
from seal_tpu_torch.models.tokenizer import WordVocabTokenizer as TTok
from seal_tpu_torch.retrieval.searcher import SEALSearcher as TSearcher

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CORPUS = [
    ("d0", "Soup", "You can eat soup with a spoon but eating soup with a fork is hard."),
    ("d1", "Forks", "A fork is a utensil with tines used for spearing solid food."),
    ("d2", "Bicycles", "A bicycle has two wheels and is propelled by pedals."),
    ("d3", "Rivers", "A river is a natural stream of fresh water flowing toward an ocean."),
    ("d4", "Chess", "Chess is a board game for two players with sixteen pieces each."),
]
QUERIES = ["eating soup with a fork", "two wheels pedals bicycle", "fresh water river ocean",
           "chess board game", "spearing solid food"]
KNOBS = dict(backbone="word-vocab", beam=4, length=4, batch_size=2, decode_body=True,
             decode_titles=True, rescore=True, add_query_to_keys=True, unigram_scores=True,
             progress=False)


def _build(corpus, seed=0):
    """Host index, both tokenizers and both parameter trees.  The bias (a
    stand-in for a trained model) boosts the tokens of ``CORPUS``, its
    titles and the title marker most, each by a random amount so no two
    are tied: the title decode's first token then starts a document."""
    texts = [f"{title} @@ {body}" for _, title, body in corpus]
    jtok = JTok.train([" " + t for t in texts], max_vocab=500)
    ttok = TTok.train([" " + t for t in texts], max_vocab=500)
    assert ttok.encoder == jtok.encoder
    docs = [jtok.encode_plain(" " + t) + [jtok.eos_token_id] for t in texts]
    index = FMIndex()
    index.initialize(docs, labels=[d for d, _, _ in corpus])
    jcfg, tcfg = jtiny(vocab_size=jtok.vocab_size), ttiny(vocab_size=jtok.vocab_size)
    params = dict(jbart.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    bias = np.zeros(jcfg.vocab_size, np.float32)
    for _, title, body in CORPUS:
        for t in jtok.encode_plain(" " + body.lower()) + jtok.encode_plain(" " + body):
            bias[t] = 6.0 + rng.random()
    for _, title, _ in CORPUS:
        for t in jtok.encode_plain(" " + title + " @@"):
            bias[t] = 8.0 + rng.random()
    params["final_logits_bias"] = jnp.asarray(bias)
    tparams = tconvert.params_from_jax(jax.device_get(params), tcfg)
    return index, jtok, ttok, jcfg, tcfg, params, tparams


@pytest.fixture(scope="module")
def searchers():
    rng = np.random.default_rng(0)
    filler_words = [f"word{i}" for i in range(80)]
    filler = [(f"f{i}", f"Filler{i}", " ".join(rng.choice(filler_words, size=30)))
              for i in range(20)]
    index, jtok, ttok, jcfg, tcfg, params, tparams = _build(CORPUS + filler)
    return (JSearcher(index, jtok, jcfg, params, **KNOBS),
            TSearcher(index, ttok, tcfg, tparams, **KNOBS))


def _assert_same_results(jres, tres, keys=False):
    assert len(jres) == len(tres)
    for jd, td in zip(jres, tres):
        assert [d.docid for d in td] == [d.docid for d in jd]
        np.testing.assert_allclose([d.score for d in td], [d.score for d in jd], rtol=1e-4)
        assert [d.text() for d in td] == [d.text() for d in jd]
        if keys:
            assert [[(t, c) for t, c, _ in d.keys] for d in td] == [
                [(t, c) for t, c, _ in d.keys] for d in jd]
            for a, b in zip(jd, td):
                np.testing.assert_allclose([s for *_, s in b.keys], [s for *_, s in a.keys],
                                           rtol=1e-4)


@pytest.mark.parametrize("pipeline", [True, False])
def test_batch_search_matches_jax(searchers, pipeline):
    js, ts = searchers
    js.pipeline = ts.pipeline = pipeline
    js.include_keys = ts.include_keys = True
    try:
        jres = js.batch_search(QUERIES, k=5)
        tres = ts.batch_search(QUERIES, k=5)
    finally:
        js.include_keys = ts.include_keys = False
    assert all(tres)
    _assert_same_results(jres, tres, keys=True)
    snap = ts.metrics.snapshot()
    assert snap["queries"] > 0 and snap["keys_generated"] > 0


def test_generated_keys_match_jax(searchers):
    """The raw key sets behind the ranking: body, title and decomposition
    keys with their rescored scores, and the unigram vector."""
    js, ts = searchers
    for q in QUERIES[:3]:
        (jk, ju), (tk, tu) = js.generate_keys(q), ts.generate_keys(q)
        assert [k for k, _ in tk] == [k for k, _ in jk]
        np.testing.assert_allclose([s for _, s in tk], [s for _, s in jk], atol=1e-4, rtol=0)
        np.testing.assert_allclose(tu, ju, atol=1e-5, rtol=0)
        assert any(k[0] == ts.title_bos_token_id and k[-1] == ts.title_eos_token_id
                   for k, _ in tk)  # title keys made it through
        assert all(ts.fm_index.get_count(list(k)) > 0 for k, _ in tk)


def test_title_decode_hypotheses_are_grounded(searchers):
    """The title decode's raw hypotheses: from the second generated token
    on, each lies in the corpus after the forced prefix; a step-0
    hypothesis is picked under the dense corpus mask (the JAX decoder's
    rule) and lies in the corpus on its own."""
    _, ts = searchers
    from seal_tpu_torch.decoding.generate import fm_index_generate

    toks = ts._tokenize_batch(ts._marked([" " + q for q in QUERIES], "title"))
    kw = dict(num_beams=4, min_length=1, max_length=15, eos_token_id=ts.title_eos_token_id,
              force_decoding_from=[ts.title_bos_token_id], forced_bos_token_id=None)
    raw = fm_index_generate(ts.model_cfg, ts.title_params, ts.device_index, toks, **kw)
    n_long = 0
    for hyps in raw:
        for _, t in hyps:
            key = [x for x in t[1:] if x not in (0, 1)]
            if len(key) >= 2:
                n_long += 1
                assert ts.fm_index.get_count([ts.title_bos_token_id] + key) > 0, key
            else:
                assert ts.fm_index.get_count(key) > 0, key
    assert n_long > 0
    full = fm_index_generate(ts.model_cfg, ts.title_params, ts.device_index, toks,
                             force_full=True, **kw)
    assert [sorted((tuple(t), s) for s, t in h) for h in raw] == [
        sorted((tuple(t), s) for s, t in h) for h in full]


def test_device_ranges_kernel_path_matches_host(searchers):
    """Without a host psi the key counts come from kernel 5's path."""
    _, ts = searchers
    seqs = [[5, 6], [ts.title_bos_token_id, 9], [400], [7, 8, 9, 10, 11]]
    want = ts._device_ranges(seqs)
    psi = ts.fm_index.psi
    ts.fm_index.psi = None
    try:
        got = ts._device_ranges(seqs)
    finally:
        ts.fm_index.psi = psi
    assert got == want == [ts.fm_index.get_range(s) for s in seqs]


def test_sample_corpus_ranks_soup_first():
    """``res/sample``: the soup query finds the soup document in both
    packages, and the rankings are the same."""
    corpus = []
    with open(os.path.join(REPO, "res", "sample", "sample_corpus.tsv")) as f:
        for line in f:
            docid, title, body = line.rstrip("\n").split("\t")
            corpus.append((docid, title, body))
    index, jtok, ttok, jcfg, tcfg, params, tparams = _build(corpus, seed=1)
    knobs = dict(KNOBS, batch_size=4)
    js = JSearcher(index, jtok, jcfg, params, **knobs)
    ts = TSearcher(index, ttok, tcfg, tparams, **knobs)
    queries = ["can you eat soup with a fork", "what is a fork used for",
               "bicycle wheels and pedals"]
    jres, tres = js.batch_search(queries, k=3), ts.batch_search(queries, k=3)
    assert tres[0][0].docid == jres[0][0].docid == "doc1"
    assert "Soup" in tres[0][0].text()[0]
    _assert_same_results(jres, tres)


def test_defaults_match_jax():
    assert TSearcher.DEFAULTS == JSearcher.DEFAULTS


@pytest.mark.parametrize("knob", [dict(compact_index=True), dict(hybrid_index=True),
                                  dict(index_shards=2), dict(jobs=2), dict(free_generation=True),
                                  dict(decode_code=True), dict(backbone="t5-small")])
def test_unported_knobs_raise(searchers, knob):
    _, ts = searchers
    with pytest.raises(NotImplementedError):
        TSearcher(ts.fm_index, ts.tokenizer, ts.model_cfg, ts.params,
                  device_index=ts.device_index, **dict(KNOBS, **knob))
    name, value = next(iter(knob.items()))
    if name != "backbone":  # flipped after construction: refused at the next search
        old = getattr(ts, name)
        setattr(ts, name, value)
        try:
            with pytest.raises(NotImplementedError, match=name):
                ts.batch_search(QUERIES[:1], k=1)
        finally:
            setattr(ts, name, old)
