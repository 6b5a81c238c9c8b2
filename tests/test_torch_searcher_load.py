"""The port's ``SEALSearcher.load`` / ``from_args`` against the JAX
package's on the same files: an index built by the port's
``build_fm_index`` CLI (monolithic and ``--shards 2``) from a corpus of
``title @@ code || body`` documents, its trained word vocab, and two
checkpoints written from seeded JAX ``bart_tiny`` trees in the HF layout
(``--dont_fairseq_checkpoint``): the main one with the corpus's body and
title words boosted in ``final_logits_bias``, the code one
(``--checkpoint_code``) with the code words boosted as in
``tests/test_reference_searcher_differential.py:test_keygen_code``.

Documents equal and in the same order, scores within 1e-4 relative, texts
equal (as ``tests/test_torch_searcher.py``); the raw keys of
``decode_code`` / ``partial_code`` equal, scores within 1e-4.  ``jobs=2``
(one spawned pool of two workers for the whole module) equals ``jobs=1``
and JAX's forked ``jobs=2``, and a dead worker raises in the parent; over
a sharded index the parent finds each unit's ranges as ``jobs=1`` does,
and the workers read them (thread workers there, from the same pickle)."""

import os
import threading

import numpy as np
import pytest
import torch

from chip_smoke import port_state_dict
from seal_tpu.models.config import bart_tiny as jtiny
from seal_tpu.retrieval.searcher import SEALSearcher as JSearcher
from seal_tpu_torch.cli import build_fm_index as tbuild
from seal_tpu_torch.models.tokenizer import WordVocabTokenizer
from seal_tpu_torch.retrieval.searcher import SEALSearcher as TSearcher
from seal_tpu_torch.utils.device import resolve_device
from test_torch_loading import seeded_tree
from test_torch_searcher import _assert_same_results

CORPUS = [
    ("d0", "Soup", "c00", "You can eat soup with a spoon but eating soup with a fork is hard."),
    ("d1", "Forks", "c01", "A fork is a utensil with tines used for spearing solid food."),
    ("d2", "Bicycles", "c02", "A bicycle has two wheels and is propelled by pedals."),
    ("d3", "Rivers", "c03", "A river is a natural stream of fresh water flowing toward an ocean."),
    ("d4", "Chess", "c04", "Chess is a board game for two players with sixteen pieces each."),
    ("d5", "Bread", "c05", "Bread is baked from flour and water often with yeast added."),
]
QUERIES = ["eating soup with a fork", "two wheels pedals bicycle", "fresh water river ocean",
           "chess board game", "flour water yeast"]
KNOBS = dict(backbone="tiny-word", fairseq_checkpoint=False, beam=4, length=4, batch_size=2,
             progress=False)


def write_kilt(path, rows):
    """``id<TAB>title<TAB>code || body`` lines: with ``--include_title`` the
    documents read ``title @@ code || body``."""
    with open(path, "w") as f:
        for docid, title, code, body in rows:
            f.write(f"{docid}\t{title}\t{code} || {body}\n")


def corpus_rows(n_filler=16, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"word{i}" for i in range(60)]
    return CORPUS + [(f"f{i}", f"Filler{i}", f"c1{i}", " ".join(rng.choice(words, size=25)))
                     for i in range(n_filler)]


def boosted_checkpoint(path, tok, boosts, seed):
    """A JAX ``bart_tiny`` tree from ``PRNGKey(seed)`` whose
    ``final_logits_bias`` gives each (text, amount) of ``boosts`` its
    amount, plus a seeded jitter below 1 so no two boosted tokens tie,
    saved in the HF layout."""
    tree = seeded_tree(jtiny(vocab_size=tok.vocab_size), seed=seed)
    rng = np.random.default_rng(seed)
    bias = np.zeros(tok.vocab_size, np.float32)
    for text, amount in boosts:
        for t in tok.encode_plain(text):
            bias[t] = amount + rng.random()
    tree["final_logits_bias"] = bias
    torch.save(port_state_dict(torch, tree, "hf"), path)
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("load")
    write_kilt(d / "corpus.tsv", corpus_rows())
    idx = str(d / "idx")
    assert tbuild.main([str(d / "corpus.tsv"), idx, "--include_title", "--train_word_vocab"]) == 0
    assert tbuild.main([str(d / "corpus.tsv"), str(d / "sh"), "--include_title",
                        "--tokenizer", idx + ".word_vocab.json", "--shards", "2"]) == 0
    tok = WordVocabTokenizer.load(idx + ".word_vocab.json")
    main_boosts = [(" " + b, 6.0) for *_, b in CORPUS] + [(" " + b.lower(), 6.0) for *_, b in CORPUS]
    main_boosts += [(f" {t} @@", 8.0) for _, t, _, _ in CORPUS]
    code_boosts = [(" " + c, 12.0) for _, _, c, _ in CORPUS] + [(" c", 18.0)]
    return dict(
        dir=d, idx=idx, shards=str(d / "sh"), tok=idx + ".word_vocab.json",
        ckpt=boosted_checkpoint(str(d / "main.pt"), tok, main_boosts, seed=0),
        code=boosted_checkpoint(str(d / "code.pt"), tok, code_boosts, seed=1),
    )


def _argv(files, *extra):
    return ["--fm_index", files["idx"], "--checkpoint", files["ckpt"], "--tokenizer", files["tok"],
            "--backbone", "tiny-word", "--dont_fairseq_checkpoint", "--beam", "4", "--length", "4",
            "--batch_size", "2", *extra]


def _parse(cls, argv):
    import argparse

    parser = argparse.ArgumentParser()
    cls.add_args(parser)
    return parser.parse_args(argv)


def _load_both(files, index=None, **knobs):
    kw = dict(KNOBS, tokenizer_path=files["tok"], **knobs)
    path = index or files["idx"]
    return (JSearcher.load(path, files["ckpt"], **kw),
            TSearcher.load(path, files["ckpt"], device="cpu", **kw))


@pytest.fixture(scope="module")
def from_args(files):
    """Both packages' searchers from the same argv (the port's on the CPU);
    the jobs test reuses them (each JAX searcher costs a compile)."""
    ts = TSearcher.from_args(_parse(TSearcher, _argv(files, "--device", "cpu")))
    yield JSearcher.from_args(_parse(JSearcher, _argv(files))), ts
    ts.close()


def test_add_args_and_from_args_match_jax(files, from_args):
    """The same argv parses to the same namespace in both parsers, and the
    searchers ``from_args`` builds search alike."""
    for extra in ([], ["--jobs", "3", "--dont_rescore", "--decode_code", "--device", "cpu",
                       "--top_m", "64", "--index_shards", "2", "--checkpoint_code", "x.pt"]):
        assert vars(_parse(TSearcher, _argv(files, *extra))) == vars(
            _parse(JSearcher, _argv(files, *extra)))
    js, ts = from_args
    assert ts.device_index.bwt.device.type == "cpu" and ts.params["shared"].device.type == "cpu"
    assert ts.fm_index.n_docs == js.fm_index.n_docs == len(corpus_rows())
    jres, tres = js.batch_search(QUERIES, k=5), ts.batch_search(QUERIES, k=5)
    assert all(tres) and tres[0][0].docid == "d0"
    _assert_same_results(jres, tres)


@pytest.mark.parametrize("how", ["index_shards", "manifest"])
def test_sharded_load_matches_jax(files, how):
    """``index_shards=2`` re-splits the monolithic index; a ``--shards 2``
    manifest loads its shard files: both build a ``ShardedTorchIndex`` on
    the device asked for, and search as JAX's sharded searcher does."""
    # titles and unigrams off: the JAX side compiles its sharded decode once
    # (the sharded searcher's titles: tests/test_torch_sharded_generate.py)
    quick = dict(decode_titles=False, unigram_scores=False)
    if how == "index_shards":
        js, ts = _load_both(files, index_shards=2, **quick)
    else:
        js, ts = _load_both(files, index=files["shards"], **quick)
    assert ts.sharded_index is not None and ts.sharded_index.n_shards == 2
    assert ts.sharded_index.device.type == "cpu"
    _assert_same_results(js.batch_search(QUERIES, k=5), ts.batch_search(QUERIES, k=5))


def test_device_auto_raises_without_a_card(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in ("auto", "cuda", "cuda:1"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TSearcher.from_args(_parse(TSearcher, _argv(files, "--device", device)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSearcher.load(files["idx"], files["ckpt"], tokenizer_path=files["tok"], **KNOBS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSearcher.load(files["shards"], files["ckpt"], tokenizer_path=files["tok"], **KNOBS)
    with pytest.raises(ValueError, match="cuda or cpu"):
        resolve_device("tpu")
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.fixture(scope="module")
def code_pair(files):
    return _load_both(files, code_checkpoint=files["code"], decode_code=True, decode_body=False)


@pytest.mark.parametrize("partial", [False, True])
def test_code_decoding_matches_jax(code_pair, partial):
    """``decode_code`` (and ``partial_code``) from ``--checkpoint_code``: the
    raw keys equal JAX's, code keys among them, each starting with
    ``code_bos_token_id`` and grounded; the ranking equal."""
    js, ts = code_pair
    js.partial_code = ts.partial_code = partial  # a filter on the same decode
    assert ts.code_bos_token_id == ts.title_eos_token_id == js.code_bos_token_id
    n_code = 0
    for q in QUERIES[:3]:
        (jk, ju), (tk, tu) = js.generate_keys(q), ts.generate_keys(q)
        assert [k for k, _ in tk] == [k for k, _ in jk]
        np.testing.assert_allclose([s for _, s in tk], [s for _, s in jk], atol=1e-4, rtol=0)
        np.testing.assert_allclose(tu, ju, atol=1e-5, rtol=0)
        for k, _ in tk:
            assert ts.fm_index.get_count(list(k)) > 0
            n_code += k[0] == ts.code_bos_token_id
    assert n_code > 0, "no code keys: weak fixture"
    _assert_same_results(js.batch_search(QUERIES, k=5), ts.batch_search(QUERIES, k=5))


class _DieOnUnpickle(list):
    """Keys (none: the parent finds no range for them) that end the worker
    process that unpickles them."""

    def __reduce__(self):
        return os._exit, (1,)


def test_jobs_matches_serial_and_jax(from_args):
    """``jobs=2``: spawned workers (one pool, kept between searches and
    closed by ``close``) rank and detokenize as the serial path and as
    JAX's forked ``jobs=2``; a dead worker raises ``BrokenProcessPool`` in
    the parent (no hang) and drops the pool."""
    from concurrent.futures.process import BrokenProcessPool

    js, ts = from_args
    js.jobs, js.pipeline = 2, False  # JAX forks: no pipeline thread alive
    try:
        serial = ts.batch_search(QUERIES, k=5)
        ts.jobs = 2
        got = ts.batch_search(QUERIES, k=5)
        pool = ts._pool
        assert pool._mp_context.get_start_method() == "spawn"
        files = ts._pool_files.name
        assert os.path.isdir(files)
        again = ts.batch_search(QUERIES[:2], k=5)
        assert ts._pool is pool  # one pool for the searcher's life
        _assert_same_results(serial, got)
        _assert_same_results(serial[:2], again)
        _assert_same_results(js.batch_search(QUERIES, k=5), got)
        # the jobs > 2 detokenization, on the same two workers
        flat = [d for docs in got for d in docs]
        want = [(d._title, d._body) for d in flat]
        for d in flat:
            d._title = d._body = None
        ts._mp_detokenize(flat)
        assert [(d._title, d._body) for d in flat] == want
        keys = [ts.generate_keys(q) for q in QUERIES[:2]]
        box = {}

        def run():
            try:
                list(ts.batch_retrieve_from_keys([keys[0], _DieOnUnpickle(), keys[1]]))
            except BaseException as e:  # handed to the test thread
                box["error"] = e

        t = threading.Thread(target=run)
        t.start()
        t.join(timeout=120)
        assert not t.is_alive()
        assert isinstance(box.get("error"), BrokenProcessPool)
        assert ts._pool is None and not os.path.exists(files)
    finally:
        ts.close()
        ts.jobs, js.jobs, js.pipeline = 1, 1, True
    assert ts._pool is None


def test_jobs_ranges_found_in_the_parent(files, monkeypatch):
    """Over a ``--shards 2`` manifest ``jobs=2`` finds each unit's ranges
    where ``jobs=1`` does (``_device_ranges``: on the card, kernel 5's shard
    count mode), in the parent, and the workers rank from that table: the
    same ``_device_ranges`` calls, the same host counts and the same
    results as ``jobs=1``.  The workers are threads initialized as a
    spawned worker is, from the pickled host ranker with every array
    mapped from the pool's files (the suite's one spawned pool is
    ``test_jobs_matches_serial_and_jax``'s)."""
    import concurrent.futures
    from concurrent.futures import ThreadPoolExecutor

    from seal_tpu_torch.parallel.sharded_index import UnionHostIndex
    from seal_tpu_torch.retrieval import searcher as tsearcher

    monkeypatch.setattr(concurrent.futures, "ProcessPoolExecutor",
                        lambda n, mp_context, initializer, initargs: ThreadPoolExecutor(
                            n, initializer=initializer, initargs=initargs))
    monkeypatch.setattr(tsearcher, "_WORKER", {})
    monkeypatch.setattr(tsearcher, "_MAPPED_MIN_BYTES", 1)
    host_counts = []
    count = UnionHostIndex.get_count
    monkeypatch.setattr(UnionHostIndex, "get_count",
                        lambda self, ngram: host_counts.append(tuple(ngram)) or count(self, ngram))
    ts = TSearcher.load(files["shards"], files["ckpt"], tokenizer_path=files["tok"], device="cpu",
                        pipeline=False, **KNOBS)
    calls = []
    ranges = ts._device_ranges

    def spy(seqs, *lane):
        calls.append(sorted(map(tuple, seqs)))
        return ranges(seqs, *lane)

    ts._device_ranges = spy
    runs = {}
    try:
        for jobs in (1, 2):
            ts.jobs = jobs
            calls.clear()
            host_counts.clear()
            res = ts.batch_search(QUERIES, k=5)
            runs[jobs] = (res, sorted(calls), sorted(host_counts))
        worker = tsearcher._WORKER["ranker"]
        assert worker is not ts and worker.fm_index is not ts.fm_index
        text = worker.fm_index.hosts[0].text
        assert type(text.base) is np.memmap and text.base.filename.startswith(ts._pool_files.name)
        files_dir = ts._pool_files.name
    finally:
        ts.close()
    assert not os.path.exists(files_dir)
    (serial, serial_calls, serial_counts), (got, got_calls, got_counts) = runs[1], runs[2]
    assert len(serial_calls) > len(QUERIES)  # the count filter's and every unit's
    assert got_calls == serial_calls and got_counts == serial_counts
    _assert_same_results(serial, got)
