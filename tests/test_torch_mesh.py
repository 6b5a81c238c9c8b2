"""The mesh's ``data`` axis over processes, on the CPU: two ranks of one
``spawn``ed gloo group (``parallel.multihost.spawn_ranks``), started once
for the module, run every check's rank body (``_rank_body``: torch, numpy
and the port only) and return their results to the asserting tests below;
the parent holds them to one process and to ``seal_tpu`` on the
conftest's 8 CPU devices.

Ported checks (``tests/test_parallel.py:29-110``,
``test_sharded_decode.py:48-130``, ``test_dp_generate.py:16-35``,
``test_multihost.py:17-90``): ``make_mesh``'s shapes and its refusal of a
``model`` axis; ``process_slice`` equal to JAX's; ``init_distributed`` a
no-op without a coordinator; ``host_batch_to_global``.  On 4 shards, 2 a
rank (``ShardedTorchIndex.place``): ``sharded_count_sequences`` /
``sharded_allowed_mask`` equal to one process's and to JAX's exactly;
``sharded_fm_index_generate`` bit-equal (tokens, score bits) to one
process's 4-shard decode in every mode, the merged fallback count equal on
the ranks, and the fast path equal to JAX's sharded decode.
``fm_index_generate(mesh=)``: each rank's rows bit-equal to one process
decoding those rows, the whole batch equal to one process's and to JAX's
``mesh=`` decode, a sampled decode drawing what one process draws, a batch
the ranks do not divide raising.  The searcher over the mesh
(``build_sharded`` and the manifest route) equal to ``mesh=None``, and the
``search`` / ``serve`` CLIs' ``--multihost``.  Kernel 20's plain noise with
a row offset equals the whole draw's rows."""

import json

import numpy as np
import pytest
import torch

from seal_tpu_torch.cli import search as tsearch
from seal_tpu_torch.cli import serve as tserve
from seal_tpu_torch.decoding import generate as tg
from seal_tpu_torch.index.device_index import TorchFMIndex
from seal_tpu_torch.index.fm_index import FMIndex
from seal_tpu_torch.kernels import sample_select as ks
from seal_tpu_torch.models import convert as tconvert
from seal_tpu_torch.models.config import bart_tiny as ttiny
from seal_tpu_torch.parallel import mesh as mesh_lib
from seal_tpu_torch.parallel import multihost
from seal_tpu_torch.parallel import sharded_decode as tsd
from seal_tpu_torch.parallel import sharded_index as tsi
from seal_tpu_torch.retrieval.searcher import SEALSearcher as TSearcher

VOCAB = 60
SHARDS = 4
RANKS = 2
COMMON = dict(num_beams=4, max_length=6, min_length=0, forced_bos_token_id=None)
TINY = dict(window=4, exact_chunk=4)
MODES = {
    "fast": dict(window=32),
    "fast_tiny": dict(TINY, stop_at_count=2),
    "force_full": dict(TINY, force_full=True),
    "exact_mask": dict(window=32, exact_mask=True),
    "exact_ties": dict(TINY, exact_ties=True),
    "speculative": dict(speculative=True, top_m=8, window=4),
    "sample": dict(sample=True, seed=5, top_m=8, window=4),
    "sample_exact_mask": dict(sample=True, seed=5, exact_mask=True),
    "diverse": dict(window=32, diverse_bs_groups=2, diverse_bs_penalty=0.5),
}
DP_KW = dict(num_beams=3, max_length=5, min_length=0, forced_bos_token_id=None)
DP_MODES = {"fast": {}, "exact_mask": dict(exact_mask=True)}
CLI_ARGS = ["--backbone", "tiny-word", "--dont_fairseq_checkpoint", "--beam", "3", "--length",
            "3", "--batch_size", "2", "--dont_decode_titles", "--dont_unigram_scores",
            "--device", "cpu"]


def _raised(fn):
    try:
        fn()
    except Exception as e:  # the type and message go back to the parent
        return type(e).__name__, str(e)
    return None


def _np_tree(tree):
    """A parameter tree (JAX's or the port's) as plain dicts and lists of
    numpy arrays: what a spawned rank unpickles with numpy alone."""
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return np.asarray(tree)


def _docs(rng, n, lo, hi):
    return [rng.integers(4, VOCAB, size=int(rng.integers(lo, hi))).tolist() + [2]
            for _ in range(n)]


# ------------------------------------------------------------ the rank body


def _sharded_checks(mesh, payload, tcfg, tparams):
    full, _, _ = tsi.ShardedTorchIndex.build(payload["docs"], SHARDS, VOCAB, device="cpu")
    placed = full.place(mesh)
    out = dict(placed=dict(
        n_shards=placed.n_shards, first_shard=placed.first_shard,
        shard_rows=placed.shard_rows, full_rows=full.shard_rows,
        bytes=placed.memory_bytes(), full_bytes=full.memory_bytes(),
        counts_equal=torch.equal(placed.corpus_counts, full.corpus_counts),
        psi_equal=torch.equal(placed.psi, full.psi[placed.first_shard:][:placed.n_shards]),
        again=_raised(lambda: placed.place(mesh))))
    toks, lens, prefix, plens, cands = payload["pats"]
    out["counts"] = (tsi.sharded_count_sequences(placed, mesh, toks, lens).numpy(),
                     tsi.sharded_count_sequences(full, None, toks, lens).numpy())
    out["mask"] = (tsi.sharded_allowed_mask(placed, mesh, prefix, plens, cands).numpy(),
                   tsi.sharded_allowed_mask(full, None, prefix, plens, cands).numpy())
    out["wrong_mesh"] = [_raised(lambda: tsi.sharded_count_sequences(placed, None, toks, lens)),
                         _raised(lambda: tsi.sharded_count_sequences(full, mesh, toks, lens))]
    ids, mask = payload["ids"], payload["mask"]
    out["decode"] = {}
    for name, extra in MODES.items():
        kw = dict(COMMON, **extra)
        steps = mesh.stats.copy()
        got = tsd.sharded_fm_index_generate(tcfg, tparams, placed, mesh, ids, mask, **kw)
        fallback = tg.LAST_DECODE_STATS["fallback_steps"]
        collectives = sum((mesh.stats - steps).values())
        want = tsd.sharded_fm_index_generate(tcfg, tparams, full, None, ids, mask, **kw)
        out["decode"][name] = dict(got=got, want=want, fallback=fallback,
                                   want_fallback=tg.LAST_DECODE_STATS["fallback_steps"],
                                   collectives=collectives)
    return out


def _ops_checks(mesh, payload):
    """Every ``ShardedIndexOps`` method over this rank's block of shards and
    the mesh, beside one process's over the 4 shards, on the same ranges
    (the rank's block of them) and inputs."""
    full, _, _ = tsi.ShardedTorchIndex.build(payload["docs"], SHARDS, VOCAB, device="cpu")
    placed = full.place(mesh)
    B, K, M, w = 3, 4, 6, 4
    g = torch.Generator().manual_seed(5)
    toks = torch.randint(3, VOCAB, (B * K, 2), generator=g, dtype=torch.int32)
    lens = torch.randint(0, 3, (B * K,), generator=g, dtype=torch.int32)
    # each shard's ranges of random one- and two-token prefixes (length 0:
    # the shard's whole range), some empty
    lens[:2] = lens[K:K + 2] = 0
    lo, hi = (x.reshape(SHARDS, B, K) for x in tsi.fm_sequences_sharded(full, toks, lens))
    # beams whose shards disagree across the ranks: empty on one rank's
    # shards, whole on the other's
    for q, empty in ((0, slice(0, 2)), (1, slice(2, 4))):
        lo[empty, q, :2] = hi[empty, q, :2] = 0
    block = slice(placed.first_shard, placed.first_shard + placed.n_shards)
    lp = torch.log_softmax(torch.randn(B * K, VOCAB, generator=g), -1)
    cands = torch.randint(0, VOCAB, (B, K, M), generator=g, dtype=torch.int32)
    sel_tok = torch.randint(0, VOCAB, (B, K), generator=g, dtype=torch.int32)
    sel_par = torch.randint(0, K, (B, K), generator=g, dtype=torch.int32)
    finished = torch.rand(B, K, generator=g) < 0.2
    calls = {
        "validate": lambda o, a, b: o.validate(cands, a, b),
        "contains": lambda o, a, b: o.contains(cands, a, b),
        "window_gather": lambda o, a, b: o.window_gather(a, b, w, lp, 1),
        "window_slab": lambda o, a, b: o.window_slab(a, b, w, 8, lp, 1),
        "slab": lambda o, a, b: o.slab(a, b, 2, 8, lp),
        "range_size": lambda o, a, b: o.range_size(a, b),
        "advance": lambda o, a, b: o.advance(sel_tok, sel_par, a, b, finished, eos=2, pad=1),
        "advance_step0": lambda o, a, b: o.advance(sel_tok, sel_par % 1, a[..., :1],
                                                   b[..., :1], eos=2, pad=1),
        "window_exhaustive": lambda o, a, b: o.window_exhaustive(a, b, w),
        "interval_covered": lambda o, a, b: o.interval_covered(a, b, 6),
        "bucket_counts": lambda o, a, b: o.bucket_counts(a, b),
        "bucket_support": lambda o, a, b: o.bucket_support(a, b),
        "dense_counts": lambda o, a, b: o.dense_counts(a, b, 16),
        "dense_mask": lambda o, a, b: o.dense_mask(a, b, 16),
        "host_any": lambda o, a, b: o.host_any((b - a) > 40),
    }
    mine, one = tsd.ShardedIndexOps(placed, mesh), tsd.ShardedIndexOps(full)
    out = {}
    for name, call in calls.items():
        got = call(mine, lo[block], hi[block])
        want = call(one, lo, hi)
        if name.startswith("advance"):  # the ranges stay each rank's
            got = (got[0], got[1], got[2])
            want = (want[0][block], want[1][block], want[2])
        out[name] = (got, want)
    return out


def _dp_checks(rank, mesh, payload, tcfg, tparams):
    host = FMIndex()
    host.initialize(payload["docs"])
    index = TorchFMIndex.from_host(host, vocab=VOCAB, device="cpu")
    ids, mask = payload["dp_ids"], payload["dp_mask"]
    b = ids.shape[0] // RANKS
    rows = slice(rank * b, (rank + 1) * b)
    out = {}
    for name, extra in dict(DP_MODES, sample=dict(sample=True, seed=3)).items():
        kw = dict(DP_KW, **extra)
        whole = tg.fm_index_generate(tcfg, tparams, index, ids, mask, mesh=mesh, **kw)
        single = tg.fm_index_generate(tcfg, tparams, index, ids, mask, **kw)
        mine = tg.fm_index_generate(tcfg, tparams, index, ids[rows], mask[rows], **kw)
        out[name] = dict(whole=whole, single=single, mine=mine, rows=(rows.start, rows.stop))
    out["indivisible"] = _raised(lambda: tg.fm_index_generate(
        tcfg, tparams, index, ids[:3], mask[:3], mesh=mesh, **DP_KW))
    gids, gmask = multihost.host_batch_to_global(mesh, ids[rows], mask[rows])
    out["global"] = (gids.numpy(), gmask.numpy())
    ragged = b - rank  # rank 1 brings a row fewer: every rank refuses
    out["ragged"] = _raised(lambda: multihost.host_batch_to_global(mesh, ids[:ragged],
                                                                   mask[:ragged]))
    return out


def _searcher_checks(mesh, payload):
    s = payload["searcher"]
    params = tconvert.params_from_jax(s["params"], s["cfg"], device="cpu")
    out = {}
    for pipeline in (True, False):
        res = []
        for m in (mesh, None):
            ts = TSearcher.build_sharded(s["docs"], s["labels"], s["tok"], s["cfg"], params,
                                         n_shards=SHARDS, mesh=m, pipeline=pipeline,
                                         include_keys=True, **s["knobs"])
            res.append([[(d.docid, d.score, [k[:2] for k in d.keys]) for d in r]
                        for r in ts.batch_search(s["queries"], k=5)])
        out[f"build_sharded_pipeline_{pipeline}"] = res
    res = []
    for m in (mesh, None):
        ts = TSearcher.load(s["manifest"], None, tokenizer_path=s["tok_path"], device="cpu",
                            model_cfg=s["cfg"], mesh=m, **s["knobs"])
        res.append([[(d.docid, d.score) for d in r] for r in ts.batch_search(s["queries"], k=5)])
        if m is not None:
            out["manifest_local_shards"] = ts.sharded_index.n_shards
    out["manifest"] = res
    return out


def _cli_checks(rank, payload):
    c = payload["cli"]
    argv = ["--fm_index", c["index"], "--tokenizer", c["tok"], "--checkpoint", c["ckpt"],
            *CLI_ARGS, "--multihost"]
    tsearch.main(["--topics", c["topics"], "--topics_format", "dpr", "--output", c["search_out"],
                  "--hits", "4", *argv])
    tserve.main(["--input", c["serve_in"], "--output", c["serve_out"], "--hits", "3", *argv])
    return True


def _rank_body(rank, payload):
    """Every check of one rank, in one order on both ranks (each group's
    collectives must match)."""
    torch.set_num_threads(1)
    mesh = mesh_lib.make_mesh(device="cpu")
    out = dict(shape=dict(mesh.shape), data_rank=mesh.data_rank, lanes=mesh.lanes,
               slice=multihost.process_slice(17))
    out["refused"] = [_raised(lambda: mesh_lib.make_mesh(n_model=2, device="cpu")),
                      _raised(lambda: mesh_lib.make_mesh(n_data=3, device="cpu")),
                      _raised(lambda: multihost.global_mesh(n_model=2))]
    tcfg = ttiny(vocab_size=VOCAB)
    tparams = tconvert.params_from_jax(payload["params"], tcfg, device="cpu")
    out["ops"] = _ops_checks(mesh, payload)
    out["sharded"] = _sharded_checks(mesh, payload, tcfg, tparams)
    out["dp"] = _dp_checks(rank, mesh, payload, tcfg, tparams)
    out["searcher"] = _searcher_checks(mesh, payload)
    out["cli"] = _cli_checks(rank, payload)
    return out


# ------------------------------------------------------------- the parent


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """``tests/test_sharded_decode.py``'s world (32 documents over a 60-token
    vocab, bart_tiny with PRNGKey(3) weights, 3 queries), 8 queries for the
    data-parallel decode, the sharded searcher's corpus and the CLIs'
    files."""
    import jax

    from seal_tpu.decoding.generate import pad_batch
    from seal_tpu.models import bart as jbart
    from seal_tpu.models.config import bart_tiny as jtiny
    from test_torch_searcher import _build
    from test_torch_searcher_load import QUERIES, boosted_checkpoint, corpus_rows, write_kilt
    from test_torch_sharded_generate import SEARCH_KNOBS
    from test_torch_searcher import CORPUS, QUERIES as S_QUERIES
    from seal_tpu_torch.cli import build_fm_index as tbuild
    from seal_tpu_torch.models.tokenizer import WordVocabTokenizer

    rng = np.random.default_rng(9)
    docs = _docs(rng, 32, 6, 25)
    params = jbart.init_params(jax.random.PRNGKey(3), jtiny(vocab_size=VOCAB))
    queries = [[0] + rng.integers(4, VOCAB, size=5).tolist() + [2] for _ in range(3)]
    ids, mask = pad_batch(queries, 1)
    dp_queries = [[0] + rng.integers(4, VOCAB, size=5).tolist() + [2] for _ in range(8)]
    dp_ids, dp_mask = pad_batch(dp_queries, 1)
    pats = [rng.integers(0, VOCAB, size=int(rng.integers(1, 4))).tolist() for _ in range(30)]
    toks = np.zeros((len(pats), 3), np.int32)
    for i, p in enumerate(pats):
        toks[i, : len(p)] = p
    lens = np.array([len(p) for p in pats], np.int32)
    prefix = np.array([[docs[0][0]], [docs[1][0]]], np.int32)
    cands = np.tile(np.arange(VOCAB, dtype=np.int32), (2, 1))

    # the sharded searcher's corpus (test_torch_sharded_generate's) and its manifest
    srng = np.random.default_rng(0)
    filler_words = [f"word{i}" for i in range(80)]
    corpus = CORPUS + [(f"f{i}", f"Filler{i}", " ".join(srng.choice(filler_words, size=30)))
                       for i in range(19)]
    index, jtok, ttok, _, tcfg, _, tparams = _build(corpus)
    sdocs = [jtok.encode_plain(f" {title} @@ {body}") + [jtok.eos_token_id]
             for _, title, body in corpus]
    d = tmp_path_factory.mktemp("mesh")
    base = str(d / "sharded")
    _, hosts, _ = tsi.ShardedTorchIndex.build(sdocs, SHARDS, tcfg.vocab_size,
                                              labels=index.labels, device="cpu")
    for s, h in enumerate(hosts):
        h.save(tsi.shard_path(base, s))
    tsi.save_shard_manifest(base, SHARDS, len(sdocs))
    ttok.save(str(d / "tok.json"))
    searcher = dict(docs=sdocs, labels=index.labels, tok=ttok, cfg=tcfg, params=_np_tree(tparams),
                    knobs=dict(SEARCH_KNOBS, backbone="tiny-word"), queries=S_QUERIES,
                    manifest=base, tok_path=str(d / "tok.json"))

    # the CLIs' files (test_torch_cli's KILT corpus, the port's build)
    write_kilt(d / "corpus.tsv", [(f"{10 + i}-{i % 3}", t, c, b)
                                  for i, (_, t, c, b) in enumerate(corpus_rows(12))])
    assert tbuild.main([str(d / "corpus.tsv"), str(d / "kilt"), "--include_title",
                        "--train_word_vocab"]) == 0
    tok = WordVocabTokenizer.load(str(d / "kilt.word_vocab.json"))
    boosted_checkpoint(str(d / "main.pt"), tok, [(" " + b, 6.0) for *_, b in corpus_rows(0)],
                       seed=0)
    (d / "topics.json").write_text(json.dumps([{"question": q, "answers": ["x"]}
                                               for q in QUERIES]))
    (d / "serve.jsonl").write_text("".join(json.dumps({"id": f"q{i}", "query": q}) + "\n"
                                           for i, q in enumerate(QUERIES)))
    cli = dict(index=str(d / "kilt"), tok=str(d / "kilt.word_vocab.json"),
               ckpt=str(d / "main.pt"), topics=str(d / "topics.json"),
               search_out=str(d / "search.trec"), serve_in=str(d / "serve.jsonl"),
               serve_out=str(d / "serve.out"))
    return dict(docs=docs, params=_np_tree(jax.device_get(params)), ids=ids, mask=mask,
                dp_ids=dp_ids,
                dp_mask=dp_mask, pats=(toks, lens, prefix, np.ones(2, np.int32), cands),
                searcher=searcher, cli=cli, jparams=params)


@pytest.fixture(scope="module")
def ranks(world):
    payload = {k: v for k, v in world.items() if k != "jparams"}
    return multihost.spawn_ranks(_rank_body, RANKS, (payload,), timeout_s=300)


def test_make_mesh_shapes(ranks):
    mesh = mesh_lib.make_mesh(device="cpu")  # this process alone
    assert mesh.shape == {"data": 1, "model": 1} and mesh.axis_names == ("data", "model")
    with pytest.raises(NotImplementedError, match="A.7b"):
        mesh_lib.make_mesh(n_model=2, device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        multihost.global_mesh(n_model=2)
    for r, out in enumerate(ranks):
        assert out["shape"] == {"data": RANKS, "model": 1} and out["data_rank"] == r
        assert out["lanes"] == 2
        (t1, m1), (t2, _), (t3, _) = out["refused"]
        assert (t1, t2, t3) == ("NotImplementedError", "ValueError", "ValueError")
        assert "A.7b" in m1


def test_one_rank_mesh_helpers_are_the_identity():
    mesh = mesh_lib.make_mesh(device="cpu")
    x = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    for fn in (mesh_lib.psum, mesh_lib.pmax, mesh_lib.por_bits, mesh_lib.gather_rows):
        assert fn(mesh, x) is x and fn(None, x) is x
    b = x > 2
    assert mesh_lib.pany(mesh, b) is b and mesh_lib.pall(mesh, b) is b
    assert mesh_lib.union_slots(mesh, x, b) == (x, b)
    assert mesh_lib.host_any(mesh, b) and not mesh_lib.host_any(None, x > 9)
    assert mesh_lib.gather_objects(mesh, "o") == ["o"] and not mesh.stats


def test_process_slice_matches_jax(monkeypatch):
    import jax

    from seal_tpu.parallel import multihost as jmh

    for n in (1, 2, 3, 4):
        for p in range(n):
            monkeypatch.setattr(jax, "process_index", lambda p=p: p)
            monkeypatch.setattr(jax, "process_count", lambda n=n: n)
            monkeypatch.setattr(multihost, "process_index", lambda p=p: p)
            monkeypatch.setattr(multihost, "process_count", lambda n=n: n)
            for items in (0, 1, 5, 17):
                assert multihost.process_slice(items) == jmh.process_slice(items), (n, p, items)


def test_process_slice_on_the_ranks(ranks):
    assert [out["slice"] for out in ranks] == [(0, 9), (9, 17)]


def test_init_distributed_noop_without_coordinator(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert multihost.init_distributed() is False
    assert multihost.process_index() == 0 and multihost.process_count() == 1


def test_place_keeps_a_block_of_shards(ranks):
    for r, out in enumerate(ranks):
        p = out["sharded"]["placed"]
        k = SHARDS // RANKS
        assert p["n_shards"] == k and p["first_shard"] == r * k
        assert p["shard_rows"] == p["full_rows"][r * k:(r + 1) * k]
        assert p["counts_equal"] and p["psi_equal"]
        assert p["bytes"] < p["full_bytes"]
        assert p["again"][0] == "ValueError"
        assert [e[0] for e in out["sharded"]["wrong_mesh"]] == ["ValueError", "ValueError"]


def test_counts_and_masks_match_one_process_and_jax(world, ranks):
    import jax

    from seal_tpu.parallel import mesh as jmesh
    from seal_tpu.parallel import sharded_index as jsi

    mesh = jmesh.make_mesh(n_data=SHARDS, n_model=1, devices=jax.devices()[:SHARDS])
    j, _, _ = jsi.ShardedFMIndex.build(world["docs"], n_shards=SHARDS, vocab=VOCAB)
    j = j.place(mesh)
    toks, lens, prefix, plens, cands = world["pats"]
    jcounts = np.asarray(jsi.sharded_count_sequences(j, mesh, toks, lens))
    jmask = np.asarray(jsi.sharded_allowed_mask(j, mesh, prefix, plens, cands))
    for out in ranks:
        got, one = out["sharded"]["counts"]
        np.testing.assert_array_equal(got, one)
        np.testing.assert_array_equal(got, jcounts)
        got, one = out["sharded"]["mask"]
        np.testing.assert_array_equal(got, one)
        np.testing.assert_array_equal(got, jmask)
    assert jcounts.any() and jmask.any()


OPS = ("validate", "contains", "window_gather", "window_slab", "slab", "range_size", "advance",
       "advance_step0", "window_exhaustive", "interval_covered", "bucket_counts",
       "bucket_support", "dense_counts", "dense_mask", "host_any")


def _flat(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


@pytest.mark.parametrize("op", OPS)
def test_sharded_ops_over_the_mesh_equal_one_process(ranks, op):
    """JAX's merges (``sharded_decode.py:91-148``) across the ranks:
    each op on a rank's 2 shards, merged over the mesh, equals one
    process's over the 4 (the range update's ranges are the rank's own
    block of them), exactly."""
    for out in ranks:
        got, want = out["ops"][op]
        for a, b in zip(_flat(got), _flat(want)):
            if isinstance(a, bool):
                assert a == b
            else:
                assert a.dtype == b.dtype and torch.equal(a, b)
    if op in ("window_gather", "slab"):  # the union of every shard's slots
        assert _flat(ranks[0]["ops"][op][0])[0].shape[-1] == SHARDS * (4 if op == "window_gather"
                                                                       else 8)


@pytest.mark.parametrize("mode", list(MODES))
def test_sharded_decode_bit_equal_to_one_process(ranks, mode):
    """Tokens and score bits: the hypotheses' f32 scores compared exactly."""
    for out in ranks:
        r = out["sharded"]["decode"][mode]
        assert r["got"] == r["want"] and sum(map(len, r["got"])) > 0
        assert r["collectives"] > 0
    assert ranks[0]["sharded"]["decode"][mode]["got"] == ranks[1]["sharded"]["decode"][mode]["got"]


def test_sharded_fallback_count_merged(ranks):
    """The host redo of a batch whose fast proof failed: the merged count is
    one process's, on both ranks, and every rank redid the batch."""
    r0, r1 = (out["sharded"]["decode"]["fast_tiny"] for out in ranks)
    assert r0["fallback"] == r1["fallback"] == r0["want_fallback"]


def test_sharded_decode_matches_jax(world, ranks):
    import jax

    from seal_tpu.models.config import bart_tiny as jtiny
    from seal_tpu.parallel import mesh as jmesh
    from seal_tpu.parallel import sharded_decode as jsd
    from seal_tpu.parallel import sharded_index as jsi
    from test_torch_generate import _assert_same_hyps

    mesh = jmesh.make_mesh(n_data=SHARDS, n_model=1, devices=jax.devices()[:SHARDS])
    j, _, _ = jsi.ShardedFMIndex.build(world["docs"], n_shards=SHARDS, vocab=VOCAB)
    kw = dict(COMMON, window=32)
    jh = jsd.sharded_fm_index_generate(jtiny(vocab_size=VOCAB), world["jparams"], j.place(mesh),
                                       mesh, world["ids"], world["mask"], **kw)
    _assert_same_hyps(jh, ranks[0]["sharded"]["decode"]["fast"]["got"])


def _rounded(hyps):
    return [{(round(s, 3), tuple(t)) for s, t in q} for q in hyps]


@pytest.mark.parametrize("mode", list(DP_MODES))
def test_dp_rows_bit_equal_to_one_process(ranks, mode):
    for out in ranks:
        r = out["dp"][mode]
        lo, hi = r["rows"]
        assert r["whole"][lo:hi] == r["mine"] and sum(map(len, r["mine"])) > 0
    assert ranks[0]["dp"][mode]["whole"] == ranks[1]["dp"][mode]["whole"]


def test_dp_matches_one_process_and_jax(world, ranks):
    """As ``tests/test_dp_generate.py`` compares them (scores rounded)."""
    import jax

    from seal_tpu.decoding import generate as jg
    from seal_tpu.index.device_index import DeviceFMIndex
    from seal_tpu.models.config import bart_tiny as jtiny
    from seal_tpu.parallel import mesh as jmesh
    from seal_tpu.index import FMIndex as JFMIndex

    host = JFMIndex()
    host.initialize(world["docs"])
    kw = dict(DP_KW, exact_mask=True)
    jh = jg.fm_index_generate(jtiny(vocab_size=VOCAB), world["jparams"],
                              DeviceFMIndex.from_host(host, vocab=VOCAB), world["dp_ids"],
                              world["dp_mask"], mesh=jmesh.make_mesh(), **kw)
    r = ranks[0]["dp"]["exact_mask"]
    assert _rounded(r["whole"]) == _rounded(r["single"]) == _rounded(jh)
    assert _rounded(ranks[0]["dp"]["fast"]["whole"]) == _rounded(ranks[0]["dp"]["fast"]["single"])
    del jax


def test_dp_sampled_draws_equal_one_process(ranks):
    """Rank 1's chains draw the noise of global rows past rank 0's
    (``row_offset``): the sampled data-parallel decode is one process's."""
    for out in ranks:
        r = out["dp"]["sample"]
        assert _rounded(r["whole"]) == _rounded(r["single"])
        assert [[t for _, t in q] for q in r["whole"]] == [[t for _, t in q] for q in r["single"]]


def test_dp_indivisible_batch_raises(ranks):
    for out in ranks:
        kind, msg = out["dp"]["indivisible"]
        assert kind == "ValueError" and "3 rows" in msg


def test_host_batch_to_global_round_trips(world, ranks):
    for out in ranks:
        gids, gmask = out["dp"]["global"]
        np.testing.assert_array_equal(gids, world["dp_ids"])
        np.testing.assert_array_equal(gmask, world["dp_mask"])
        assert out["dp"]["ragged"][0] == "ValueError"


@pytest.mark.parametrize("pipeline", [True, False])
def test_sharded_searcher_over_the_mesh(ranks, pipeline):
    """``build_sharded(..., mesh=)``: the same documents, order, scores and
    key counts as ``mesh=None``, with the key producer's and the ranker's
    collectives on their own lanes (pipeline on) and on one thread."""
    for out in ranks:
        got, want = out["searcher"][f"build_sharded_pipeline_{pipeline}"]
        assert got == want and all(got)
    # every rank returns the same documents (its keys' order follows its
    # own string hashes: the query decomposition's set)
    docs = [[[(d, s, sorted(k)) for d, s, k in q]
             for q in out["searcher"][f"build_sharded_pipeline_{pipeline}"][0]] for out in ranks]
    assert docs[0] == docs[1]


def test_sharded_manifest_over_the_mesh(ranks):
    for out in ranks:
        got, want = out["searcher"]["manifest"]
        assert got == want and out["searcher"]["manifest_local_shards"] == SHARDS // RANKS


def _trec(path):
    rows = [line.split() for line in open(path).read().splitlines()]
    return [(q, doc, int(rank), float(score)) for q, _, doc, rank, score, _ in rows]


def test_cli_multihost(world, ranks, tmp_path):
    """``search --multihost``: each rank's ``<output>.<rank>`` holds its
    ``process_slice`` of the topics, together one process's run; ``serve
    --multihost``: each rank's ``<output>.<rank>`` equals one process's."""
    assert all(out["cli"] for out in ranks)
    c = world["cli"]
    argv = ["--fm_index", c["index"], "--tokenizer", c["tok"], "--checkpoint", c["ckpt"],
            *CLI_ARGS]
    one = str(tmp_path / "one.trec")
    assert tsearch.main(["--topics", c["topics"], "--topics_format", "dpr", "--output", one,
                         "--hits", "4", *argv]) == 0
    parts = [_trec(f"{c['search_out']}.{r}") for r in range(RANKS)]
    want = _trec(one)
    assert all(parts) and [x[:3] for x in parts[0] + parts[1]] == [x[:3] for x in want]
    np.testing.assert_allclose([x[3] for x in parts[0] + parts[1]], [x[3] for x in want],
                               rtol=1e-6)
    assert {x[0] for x in parts[0]}.isdisjoint({x[0] for x in parts[1]})
    one = str(tmp_path / "one.jsonl")
    assert tserve.main(["--input", c["serve_in"], "--output", one, "--hits", "3", *argv]) == 0
    want = [json.loads(x) for x in open(one)]
    for r in range(RANKS):
        got = [json.loads(x) for x in open(f"{c['serve_out']}.{r}")]
        assert [[(h["docid"], h["text"]) for h in g["hits"]] for g in got] == [
            [(h["docid"], h["text"]) for h in w["hits"]] for w in want]


@pytest.mark.parametrize("offset", [0, 1, 7, 2**32 - 3])
def test_gumbel_noise_row_offset(offset):
    """Rows [o, o + rows) of the whole draw, bit for bit (the counter's row
    word wraps at 2^32 as the kernel's unsigned row does)."""
    seed, step, rows, n = 11, 3, 5, 37
    part = ks.gumbel_noise(seed, step, rows, n, row_offset=offset)
    if offset + rows <= 64:
        whole = ks.gumbel_noise(seed, step, 64, n)
        assert torch.equal(part, whole[offset:offset + rows])
    words = ks.philox_words(seed, step, rows, n, row_offset=offset)
    for r in range(rows):
        for j in (0, 5, n - 1):
            one = ks.philox4x32(*(torch.tensor([c], dtype=torch.int64)
                                  for c in (j // 4, (offset + r) % 2**32, 0, 0)), seed, step)
            assert int(words[r, j]) == int(one[j % 4])
