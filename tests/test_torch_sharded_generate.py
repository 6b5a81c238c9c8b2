"""The port's constrained decoding and searcher over the corpus-sharded
FM-index against ``seal_tpu``'s, on the CPU (the shard modes' plain
versions; JAX on the conftest's 8-device mesh, one shard a device).

``sharded_fm_index_generate``'s raw outputs -- every candidate, parent,
selection and final beam of every step -- equal JAX's (scores within
1e-5: f32 sums in another order) at 4 shards for the fast path (also with a tiny
window and proposal budget), ``force_full``,
``exact_mask`` with ``exact_ties``, ``speculative``, free generation,
sampling with JAX's Gumbel draws replayed, diverse groups and a forced
prefix, at beam 32 (the shape of kernel 8's large-n route on the card)
and at 8 shards; the entry points' hypotheses equal JAX's, the host
redo of a failed proof included.  One shard equals the monolithic decoder's raw outputs.
``SEALSearcher.build_sharded`` ranks as JAX's at 4 and 8 shards, the
manifest route (per-shard files, ``load_sharded_hosts``) as
``build_sharded``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal_tpu.decoding import constrained as jc
from seal_tpu.decoding import generate as jg
from seal_tpu.models import bart as jbart
from seal_tpu.models.config import bart_tiny as jtiny
from seal_tpu.parallel import mesh as mesh_lib
from seal_tpu.parallel import sharded_decode as jsd
from seal_tpu.parallel.sharded_index import ShardedFMIndex
from seal_tpu.retrieval.searcher import SEALSearcher as JSearcher
from seal_tpu_torch.decoding import constrained as tc
from seal_tpu_torch.decoding import generate as tg
from seal_tpu_torch.index.device_index import TorchFMIndex
from seal_tpu_torch.kernels import sample_select as ks
from seal_tpu_torch.models import bart as tbart
from seal_tpu_torch.models import convert as tconvert
from seal_tpu_torch.models.config import bart_tiny as ttiny
from seal_tpu_torch.parallel import sharded_decode as tsd
from seal_tpu_torch.parallel import sharded_index as tsi
from seal_tpu_torch.retrieval.searcher import SEALSearcher as TSearcher
from test_torch_dense_counts import forbid_counts
from test_torch_generate import _assert_same_hyps, _fallback_setup
from test_torch_sample import _jax_noise
from test_torch_searcher import CORPUS, KNOBS, QUERIES, _assert_same_results, _build

VOCAB = 60
SCORE_ATOL = 1e-5
COMMON = dict(num_beams=4, max_length=6, min_length=0, forced_bos_token_id=None)


@pytest.fixture(scope="module")
def world():
    """``tests/test_sharded_decode.py``'s world: 32 documents over a
    60-token vocab, bart_tiny with PRNGKey(3) weights, 3 queries."""
    rng = np.random.default_rng(9)
    docs = [rng.integers(4, VOCAB, size=rng.integers(6, 25)).tolist() + [2] for _ in range(32)]
    jcfg, tcfg = jtiny(vocab_size=VOCAB), ttiny(vocab_size=VOCAB)
    params = jbart.init_params(jax.random.PRNGKey(3), jcfg)
    tparams = tconvert.params_from_jax(jax.device_get(params), tcfg, device="cpu")
    queries = [[0] + rng.integers(4, VOCAB, size=5).tolist() + [2] for _ in range(3)]
    ids, mask = jg.pad_batch(queries, jcfg.pad_token_id)
    shards = {}

    def sharded(S):
        if S not in shards:
            mesh = mesh_lib.make_mesh(n_data=S, n_model=1, devices=jax.devices()[:S])
            j, hosts, _ = ShardedFMIndex.build(docs, n_shards=S, vocab=VOCAB)
            shards[S] = (j.place(mesh), mesh, hosts,
                         tsi.ShardedTorchIndex.from_hosts(hosts, VOCAB, device="cpu"))
        return shards[S]

    return jcfg, tcfg, params, tparams, docs, ids, mask, sharded


def _raw(world, S, seed=0, **kw):
    """Both packages' raw ``BeamSearchOutput`` of one sharded decode."""
    jcfg, tcfg, params, tparams, _, ids, mask, sharded = world
    j, mesh, _, t = sharded(S)
    statics = (j.bwt.shape[1], j.C.shape[1] - 1, j.vocab, j.beginnings.shape[1] - 1,
               j.search_iters, j.bucket_size)
    run = jsd._jitted_sharded_search(jcfg, jc.DecodeConfig(**kw), mesh, statics)
    jo = jax.device_get(run(j, params, jnp.asarray(ids), jnp.asarray(mask),
                            jax.random.PRNGKey(seed)))
    return jo, _port_raw(world, tsd.ShardedIndexOps(t), seed=seed, **kw)


def _port_raw(world, ops, index=None, seed=0, **kw):
    _, tcfg, _, tparams, _, ids, mask, _ = world
    tids, tmask = torch.as_tensor(ids), torch.as_tensor(mask)
    return tc.constrained_beam_search(tcfg, tparams, index, tc.DecodeConfig(**kw),
                                      tbart.encode(tcfg, tparams, tids, tmask), tmask, seed=seed,
                                      index_ops=ops)


def _assert_same_raw(jo, to, dcfg_kw):
    for f in ("cand_tokens", "cand_parents", "cand_finite", "sel_tokens", "sel_parents",
              "final_tokens", "final_valid", "fallback_steps"):
        np.testing.assert_array_equal(getattr(to, f).numpy(), np.asarray(getattr(jo, f)), f)
    for f in ("cand_scores", "final_scores"):
        a, b = np.asarray(getattr(jo, f)), getattr(to, f).numpy()
        live = a > -1e30
        np.testing.assert_array_equal(b > -1e30, live, f)
        np.testing.assert_allclose(b[live], a[live], atol=SCORE_ATOL, rtol=0, err_msg=f)
    _assert_same_hyps(jg.extract_hypotheses(jo, jc.DecodeConfig(**dcfg_kw)),
                      tg.extract_hypotheses(tg._to_host(to), tc.DecodeConfig(**dcfg_kw)))
    assert to.cand_finite.any()


TINY = dict(window=4, exact_chunk=4)
MODES = {
    "fast": dict(window=32),
    "fast_tiny": dict(TINY, stop_at_count=2),
    "force_full": dict(TINY, force_full=True),
    "exact_mask_ties": dict(window=32, exact_mask=True, exact_ties=True),
    "speculative": dict(speculative=True, top_m=8, window=4),
    "free": dict(disable_fm_index=True, top_m=8, window=32),
    "diverse": dict(window=32, num_groups=2, diversity_penalty=0.5),
    "forced_prefix": dict(TINY, force_decoding_from=(7,)),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_sharded_raw_outputs_match_jax(world, monkeypatch, mode):
    if "exact_mask" in mode:  # the shards' count mask alone: the counts raise
        forbid_counts(monkeypatch)
    kw = dict(COMMON, **MODES[mode])
    kw.pop("forced_bos_token_id")
    if mode == "forced_prefix":
        _, _, _, _, docs, *_ = world
        kw["force_decoding_from"] = (docs[0][1],)
    jo, to = _raw(world, 4, **kw)
    _assert_same_raw(jo, to, kw)


def test_sharded_sampling_with_jax_noise_matches_jax(world, monkeypatch):
    """``sample=True`` with JAX's own Gumbel draws replayed through the
    plain version's noise hook: the proven proposal loop's buffer of
    ``top_m`` (a small one, several rounds) over the union window."""
    kw = dict(COMMON, sample=True, top_m=8, window=4)
    kw.pop("forced_bos_token_id")
    _, _, _, _, _, ids, _, _ = world
    monkeypatch.setattr(ks, "gumbel_noise", _jax_noise(5, kw["max_length"] - 1, len(ids), 4))
    jo, to = _raw(world, 4, seed=5, **kw)
    _assert_same_raw(jo, to, kw)


@pytest.mark.parametrize("S,beams", [(4, 32), (8, 4)])
def test_sharded_beam32_and_eight_shards_match_jax(world, S, beams):
    """Beam 32 over 4 shards (``BASELINE.md``'s config-5 shape; on the card
    its 18,496 candidates a query take kernel 8's large-n route) and the
    fast path over 8 shards."""
    kw = dict(num_beams=beams, max_length=4 if beams == 32 else 6, min_length=0,
              **(dict(window=tc.resolve_window(0, beams)) if beams == 32 else TINY))
    jo, to = _raw(world, S, **kw)
    _assert_same_raw(jo, to, kw)
    _, _, _, _, _, _, _, sharded = world
    hosts = sharded(S)[2]
    for q in tg.extract_hypotheses(tg._to_host(to), tc.DecodeConfig(**kw)):
        for _, toks in q:
            key = [x for x in toks[1:] if x not in (1, 2)]
            assert not key or sum(h.get_count(key) for h in hosts) > 0


def test_sharded_entry_point_matches_jax():
    """The entry points, with the host ``force_full`` redo of a batch whose
    fast proof failed (``test_torch_generate``'s fallback corpus, one copy
    a shard): hypotheses equal JAX's, and every key is grounded."""
    host, (jcfg, tcfg, params, tparams) = _fallback_setup()
    S = 4
    docs = [host.get_doc(0)] * S
    mesh = mesh_lib.make_mesh(n_data=S, n_model=1, devices=jax.devices()[:S])
    j, hosts, _ = ShardedFMIndex.build(docs, n_shards=S, vocab=30)
    t = tsi.ShardedTorchIndex.from_hosts(hosts, 30, device="cpu")
    kw = dict(num_beams=2, max_length=6, exact_chunk=1, window=4)
    jh = jsd.sharded_fm_index_generate(jcfg, params, j.place(mesh), mesh, [[0, 5, 6, 2]], **kw)
    th = tsd.sharded_fm_index_generate(tcfg, tparams, t, None, [[0, 5, 6, 2]], **kw)
    assert tg.LAST_DECODE_STATS["fallback_steps"] > 0
    _assert_same_hyps(jh, th)
    keys = [[x for x in toks if x not in (0, 1, 2)] for _, toks in th[0]]
    assert any(keys) and all(sum(h.get_count(k) for h in hosts) > 0 for k in keys if k)


def test_one_shard_matches_monolithic(world):
    """One shard is the monolithic index: raw outputs equal the monolithic
    decoder's exactly, on the fast path and with ``force_full``."""
    _, _, _, _, docs, *_, sharded = world
    host = sharded(1)[2][0]
    mono = TorchFMIndex.from_host(host, vocab=VOCAB, device="cpu")
    ops = tsd.ShardedIndexOps(sharded(1)[3])
    for extra in (dict(window=32), dict(TINY, force_full=True), dict(TINY, exact_mask=True)):
        kw = dict(COMMON, **extra)
        kw.pop("forced_bos_token_id")
        a = _port_raw(world, None, index=mono, **kw)
        b = _port_raw(world, ops, **kw)
        for f in ("cand_tokens", "cand_parents", "cand_scores", "cand_finite", "sel_tokens",
                  "sel_parents", "final_scores", "final_tokens", "final_valid",
                  "fallback_steps"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f


# --------------------------------------------------------------- searcher


@pytest.fixture(scope="module")
def corpus():
    """``tests/test_sharded_searcher.py``'s corpus: the five documents and
    19 fillers (24 documents: 3 a shard on 8 shards)."""
    rng = np.random.default_rng(0)
    filler_words = [f"word{i}" for i in range(80)]
    filler = [(f"f{i}", f"Filler{i}", " ".join(rng.choice(filler_words, size=30)))
              for i in range(19)]
    corpus = CORPUS + filler
    index, jtok, ttok, jcfg, tcfg, params, tparams = _build(corpus)
    docs = [jtok.encode_plain(f" {title} @@ {body}") + [jtok.eos_token_id]
            for _, title, body in corpus]
    return corpus, index.labels, docs, jtok, ttok, jcfg, tcfg, params, tparams


SEARCH_KNOBS = dict(KNOBS, batch_size=3)


@pytest.mark.parametrize("S", [4, 8])
def test_build_sharded_searcher_matches_jax(corpus, S):
    _, labels, docs, jtok, ttok, jcfg, tcfg, params, tparams = corpus
    js = JSearcher.build_sharded(docs, labels, jtok, jcfg, params, n_shards=S, **SEARCH_KNOBS)
    ts = TSearcher.build_sharded(docs, labels, ttok, tcfg, tparams, n_shards=S, **SEARCH_KNOBS)
    assert ts.device_index is None and ts.sharded_index.n_shards == S
    jres, tres = js.batch_search(QUERIES, k=5), ts.batch_search(QUERIES, k=5)
    assert all(tres)
    _assert_same_results(jres, tres)
    for ngram, _ in ts.generate_keys(QUERIES[0])[0]:
        assert ts.fm_index.get_count(list(ngram)) > 0


def test_manifest_route_matches_build_sharded(corpus, tmp_path):
    """Per-shard ``FMIndex.save`` + the manifest, then ``load_sharded_hosts``
    -> ``ShardedTorchIndex.from_hosts`` -> ``UnionHostIndex`` ->
    ``SEALSearcher`` (JAX's ``_load_sharded_manifest`` without the model
    loading): the same results as ``build_sharded``."""
    _, labels, docs, _, ttok, _, tcfg, _, tparams = corpus
    ts = TSearcher.build_sharded(docs, labels, ttok, tcfg, tparams, n_shards=4, **SEARCH_KNOBS)
    base = str(tmp_path / "idx")
    for s, h in enumerate(ts.fm_index.hosts):
        h.save(tsi.shard_path(base, s))
    tsi.save_shard_manifest(base, 4, len(docs))
    hosts, assignments, got_labels = tsi.load_sharded_hosts(base)
    assert got_labels == labels
    si = tsi.ShardedTorchIndex.from_hosts(hosts, tcfg.vocab_size, device="cpu")
    loaded = TSearcher(tsi.UnionHostIndex(hosts, assignments, labels=got_labels), ttok, tcfg,
                       tparams, sharded_index=si, index_shards=4, **SEARCH_KNOBS)
    want, got = ts.batch_search(QUERIES, k=5), loaded.batch_search(QUERIES, k=5)
    for a, b in zip(want, got):
        assert [(d.docid, d.score, d.text()) for d in a] == [(d.docid, d.score, d.text())
                                                              for d in b]
