"""The port's copies of ``seal_tpu``'s host modules against the originals:
``FMIndex`` (every array, the query API, the on-disk format both ways), the
suffix array (native and numpy routes), every method of the native helper
library, ``SEALDocument``, ``PhaseTimer`` and ``ServingMetrics``, and the
sharded index's host helpers (``round_robin_assignments``, ``shard_path``,
``save_shard_manifest``, ``load_sharded_hosts``, ``UnionHostIndex``), and
the training data's text repair (``utils/textfix.py``), generation
(``training/data_gen.py``) and the three dataset CLIs' output files.  All
outputs must be identical."""

import copy
import json
import random

import numpy as np
import pytest

from seal_tpu.cli import make_supervised_dpr_dataset as jdpr_cli
from seal_tpu.cli import make_supervised_kilt_dataset as jkilt_cli
from seal_tpu.cli import make_unsupervised_dataset as junsup_cli
from seal_tpu.cpp import native as jnative
from seal_tpu.index import suffix_array as jsa
from seal_tpu.index.fm_index import FMIndex as JFMIndex
from seal_tpu.parallel import sharded_index as jsi
from seal_tpu.retrieval.document import SEALDocument as JDoc
from seal_tpu.scoring import keys as jk
from seal_tpu.training import data_gen as jdg
from seal_tpu.utils import profiling as jprof
from seal_tpu.utils import textfix as jtf
from seal_tpu_torch.cli import make_supervised_dpr_dataset as tdpr_cli
from seal_tpu_torch.cli import make_supervised_kilt_dataset as tkilt_cli
from seal_tpu_torch.cli import make_unsupervised_dataset as tunsup_cli
from seal_tpu_torch.cpp import native as tnative
from seal_tpu_torch.index import suffix_array as tsa
from seal_tpu_torch.index.fm_index import SHIFT
from seal_tpu_torch.index.fm_index import FMIndex as TFMIndex
from seal_tpu_torch.parallel import sharded_index as tsi
from seal_tpu_torch.retrieval.document import SEALDocument as TDoc
from seal_tpu_torch.training import data_gen as tdg
from seal_tpu_torch.utils import profiling as tprof
from seal_tpu_torch.utils import textfix as ttf

ARRAYS = ("text", "sa", "psi", "C", "bwt")
LISTS = ("beginnings", "occurring", "occurring_distinct", "occurring_counts", "labels")


def _docs(seed, n_docs=40, hi=60):
    rng = np.random.default_rng(seed)
    return [rng.integers(4, hi, size=rng.integers(3, 40)).tolist() + [2] for _ in range(n_docs)]


def _build(cls, docs, how):
    idx = cls()
    labels = [f"doc{i}" for i in range(len(docs))]
    if how == "memory":
        idx.initialize(docs, labels=labels)
    elif how == "stream":
        idx.initialize(iter(docs), in_memory=False, labels=labels)
    else:
        idx.initialize_from_arrays(np.concatenate(docs), np.array([len(d) for d in docs]),
                                   labels=labels)
    return idx


def _assert_same_index(a, b):
    for name in ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, name)
    for name in LISTS:
        assert getattr(a, name) == getattr(b, name), name


@pytest.mark.parametrize("how", ["memory", "stream", "arrays"])
@pytest.mark.parametrize("seed", [0, 1])
def test_fm_index_arrays_equal(seed, how):
    docs = _docs(seed)
    _assert_same_index(_build(TFMIndex, docs, how), _build(JFMIndex, docs, how))
    assert SHIFT == 1


@pytest.mark.parametrize("seed", [0, 1])
def test_fm_index_queries_equal(seed):
    docs = _docs(seed)
    t, j = _build(TFMIndex, docs, "memory"), _build(JFMIndex, docs, "memory")
    rng = np.random.default_rng(seed + 10)
    text = (j.text[:-1] - 1).tolist()
    seqs = []
    for _ in range(60):
        i = int(rng.integers(0, len(text) - 5))
        seqs.append(text[i : i + int(rng.integers(1, 5))][::-1])  # forward n-grams
    seqs += [rng.integers(0, 70, size=3).tolist() for _ in range(20)] + [[], [999]]
    for s in seqs:
        assert t.get_range(s) == j.get_range(s)
        assert t.get_count(s) == j.get_count(s)
        assert t.get_continuations(s) == j.get_continuations(s)
    assert t.get_ranges_batch(seqs[:-2]) == j.get_ranges_batch(seqs[:-2])
    rngs = [j.get_range(s) for s in seqs[:30]]
    for s, r in zip(seqs[:30], rngs):
        for a, b in zip(t.occurrences(s, 7), j.occurrences(s, 7)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(t.occurrences_multi(seqs[:30], 9, rngs), j.occurrences_multi(seqs[:30], 9, rngs)):
        np.testing.assert_array_equal(a, b)
    ids = rng.integers(0, len(docs), size=12)
    for a, b in zip(t.get_docs_flat(ids), j.get_docs_flat(ids)):
        np.testing.assert_array_equal(a, b)
    assert [t.get_doc(i) for i in ids] == [j.get_doc(i) for i in ids]
    np.testing.assert_array_equal(t.token_counts(np.arange(-2, 70)), j.token_counts(np.arange(-2, 70)))
    assert [t.get_distinct_count(lo, hi) for lo, hi in rngs] == [
        j.get_distinct_count(lo, hi) for lo, hi in rngs]
    assert [t.get_doc_index_from_row(r) for r in range(0, t.size(), 7)] == [
        j.get_doc_index_from_row(r) for r in range(0, j.size(), 7)]


@pytest.mark.parametrize("saver,loader", [(TFMIndex, JFMIndex), (JFMIndex, TFMIndex)])
def test_fm_index_files_load_in_the_other_package(tmp_path, saver, loader):
    docs = _docs(3)
    src = _build(saver, docs, "memory")
    src.save(str(tmp_path / "idx"))
    got = loader.load(str(tmp_path / "idx"))
    assert type(got) is loader
    _assert_same_index(got, src)
    assert got.get_count(docs[5][:3]) == src.get_count(docs[5][:3]) > 0


@pytest.mark.parametrize("prefer_native", [True, False])
def test_build_suffix_array_equal(prefer_native):
    rng = np.random.default_rng(4)
    for n in (1, 2, 50, 3000):
        text = np.concatenate([rng.integers(1, 9, size=n - 1), [0]]).astype(np.int32)
        want = jsa.build_suffix_array(text, prefer_native=prefer_native)
        got = tsa.build_suffix_array(text, prefer_native=prefer_native)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, tsa.brute_force_suffix_array(text) if n <= 50 else want)
    with pytest.raises(ValueError):
        tsa.build_suffix_array(np.array([3, 1, 2], np.int32))


def test_native_library_is_the_ports_own():
    t, j = tnative.load(), jnative.load()
    assert t is not j
    assert t._lib._name != j._lib._name
    assert "seal_tpu_torch" in t._lib._name and t._lib._name.endswith("libseal_torch_native.so")
    assert tsa._load_native() is t


_LOAD_IN_FRESH_PROCESS = """
import sys
from seal_tpu_torch.cpp import native
from seal_tpu_torch.index import suffix_array
native._BUILD_DIR = sys.argv[1]
lib = suffix_array._load_native()
assert lib is not None, "suffix_array fell back to numpy"
assert lib is native.load()
assert lib._lib._name.startswith(sys.argv[1]), lib._lib._name
print("loaded", lib._lib._name)
"""


def test_native_library_builds_atomically_under_concurrent_loads(tmp_path):
    """Four fresh processes build the library into one empty directory at
    once: each loads a whole library (none sees a half-written file and
    falls back to numpy), and no temporary file is left behind."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [
        subprocess.Popen([sys.executable, "-c", _LOAD_IN_FRESH_PROCESS, str(tmp_path)], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(4)
    ]
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-2000:]
        assert out.startswith("loaded ")
    assert sorted(os.listdir(tmp_path)) == ["libseal_torch_native.so"]


def _record_native_calls(monkeypatch):
    """Every Native method call the JAX ranker makes, with a deep copy of
    its arguments taken before the call (some mutate their inputs)."""
    calls = []
    for name in ("stage1_claim", "ac_match", "ranges_multi", "stage1_accumulate", "stage2_score",
                 "suffix_array"):
        real = getattr(jnative.Native, name)

        def spy(self, *args, _real=real, _name=name):
            calls.append((_name, copy.deepcopy(args)))
            return _real(self, *args)

        monkeypatch.setattr(jnative.Native, name, spy)
    return calls


def _same(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


def test_native_methods_equal(monkeypatch):
    """The original's methods, called by the JAX ranker on a real query,
    replayed on both libraries: identical outputs (and identical mutations
    of the inputs)."""
    calls = _record_native_calls(monkeypatch)
    docs = _docs(5, n_docs=60)
    host = _build(JFMIndex, docs, "memory")
    text = (host.text[:-1] - 1).tolist()
    rng = np.random.default_rng(5)
    keys = [(text[i : i + 3][::-1], -float(rng.random() * 5))
            for i in rng.integers(0, len(text) - 4, size=30)]
    jk.aggregate_evidence(keys, index=host, unigram_scores=(-rng.random(70) * 9).tolist())
    host.get_ranges_batch([k for k, _ in keys])
    covered = np.zeros(50, np.uint8)
    covered[3:7] = 1
    calls.append(("stage1_claim", (covered, np.array([2, 5, 12, 20, 12]), 3)))
    calls.append(("suffix_array", (host.text,)))
    names = {n for n, _ in calls}
    assert names == {"stage1_claim", "ac_match", "ranges_multi", "stage1_accumulate",
                     "stage2_score", "suffix_array"}, names
    monkeypatch.undo()
    t, j = tnative.load(), jnative.load()
    for name, args in calls:
        ta, ja = copy.deepcopy(args), copy.deepcopy(args)
        _same(getattr(t, name)(*ta), getattr(j, name)(*ja))
        for x, y in zip(ta, ja):
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y)


class _Tok:
    def decode(self, ids, skip_special_tokens=False):
        return " ".join(f"w{i}" for i in ids if not (skip_special_tokens and i < 3))


@pytest.mark.parametrize("delims", [(None, None), (50, None), (50, 51)])
def test_seal_document_equal(delims):
    docs = [[7, 8, 50, 9, 51, 10, 11, 2], [4, 5, 6, 2], [50, 9, 2]]
    t, j = _build(TFMIndex, docs, "memory"), _build(JFMIndex, docs, "memory")
    for i in range(len(docs)):
        a = TDoc(i, 1.5, t, _Tok(), *delims, keys=[(1,)], query="q")
        b = JDoc(i, 1.5, j, _Tok(), *delims, keys=[(1,)], query="q")
        assert (a.docid, a.id(), a.raw_tokens(), a.raw_text(), a.text(), repr(a)) == (
            b.docid, b.id(), b.raw_tokens(), b.raw_text(), b.text(), repr(b))
    t.labels = j.labels = None
    assert TDoc(2, 0.0, t, _Tok()).docid == JDoc(2, 0.0, j, _Tok()).docid == "2"


def test_phase_timer_and_serving_metrics_equal(monkeypatch):
    """Same phases on the same (fake) clock: same totals, counts, summary
    and snapshot."""
    out = []
    for mod in (tprof, jprof):
        ticks = iter(np.arange(0.0, 100.0, 0.25).tolist())
        monkeypatch.setattr(mod.time, "time", lambda: next(ticks))
        timer = mod.PhaseTimer(enabled=True)
        for name in ("decode", "rescore", "decode", "aggregate"):
            with timer.phase(name):
                pass
        off = mod.PhaseTimer(enabled=False)
        with off.phase("x"):
            pass
        metrics = mod.ServingMetrics()
        metrics.observe_batch(16, 120, 150, 2.5, timer)
        metrics.observe_batch(16, 100, 140, 1.5)
        out.append((timer.totals, timer.counts, timer.summary(), off.totals, metrics.snapshot()))
        metrics.reset()
        out.append(metrics.snapshot())
        monkeypatch.undo()
    assert out[0] == out[2] and out[1] == out[3]
    assert out[0][4]["queries"] == 32 and out[0][4]["phase_decode_s"] == 0.5


@pytest.mark.parametrize("n_docs,n_shards", [(0, 3), (7, 1), (24, 8), (25, 4)])
def test_shard_assignment_equal(n_docs, n_shards):
    assert tsi.round_robin_assignments(n_docs, n_shards) == \
        jsi.round_robin_assignments(n_docs, n_shards)
    assert tsi.shard_path("a/b", n_shards) == jsi.shard_path("a/b", n_shards)


def test_shard_manifest_and_hosts_load_equal(tmp_path):
    """A shard-wise build (per-shard ``FMIndex.save`` + the manifest) loads
    to the same hosts, assignments and labels in both packages; each
    package's manifest is byte-identical, and a wrong one is refused alike."""
    docs = _docs(3, n_docs=22)
    labels = [f"doc{i}" for i in range(len(docs))]
    assign = tsi.round_robin_assignments(len(docs), 4)
    for s, ids in enumerate(assign):
        _build(TFMIndex, [docs[i] for i in ids], "memory").save(
            tsi.shard_path(str(tmp_path / "t"), s))
    for pkg, base in ((tsi, "t"), (jsi, "j")):
        pkg.save_shard_manifest(str(tmp_path / base), 4, len(docs))
    assert (tmp_path / "t.manifest.json").read_bytes() == \
        (tmp_path / "j.manifest.json").read_bytes()
    t_hosts, t_assign, t_labels = tsi.load_sharded_hosts(str(tmp_path / "t"))
    j_hosts, j_assign, j_labels = jsi.load_sharded_hosts(str(tmp_path / "t"))
    assert t_assign == j_assign == assign
    # _build labels each shard's documents doc0.. locally; the global labels
    # come from the manifest's assignment
    assert t_labels == j_labels
    for a, b in zip(t_hosts, j_hosts):
        _assert_same_index(a, b)
    tsi.save_shard_manifest(str(tmp_path / "t"), 4, len(docs) + 1)
    for pkg in (tsi, jsi):
        with pytest.raises(ValueError, match="manifest says"):
            pkg.load_sharded_hosts(str(tmp_path / "t"))


def test_union_host_index_equal():
    """``UnionHostIndex`` over the same shards: counts, token counts,
    occurrences in the canonical order (capped too), documents."""
    docs = _docs(4, n_docs=30)
    labels = [f"d{i}" for i in range(len(docs))]
    assign = tsi.round_robin_assignments(len(docs), 3)
    hosts = [_build(TFMIndex, [docs[i] for i in ids], "memory") for ids in assign]
    t = tsi.UnionHostIndex(hosts, assign, labels=labels)
    j = jsi.UnionHostIndex(hosts, assign, labels=labels)
    assert (len(t), t.n_docs, t.n_sentinels, t.labels, t.beginnings) == \
        (len(j), j.n_docs, j.n_sentinels, j.labels, j.beginnings)
    np.testing.assert_array_equal(t.offsets, j.offsets)
    rng = np.random.default_rng(0)
    for _ in range(25):
        d = docs[int(rng.integers(len(docs)))]
        i = int(rng.integers(0, len(d) - 1))
        pat = d[i : i + int(rng.integers(1, 3))]
        assert t.get_count(pat) == j.get_count(pat) and t.get_range(pat) == j.get_range(pat)
        for cap in (100, 2):
            for a, b in zip(t.occurrences(pat, cap), j.occurrences(pat, cap)):
                np.testing.assert_array_equal(a, b)
    assert t.occurrences([99, 98], 5)[0].size == j.occurrences([99, 98], 5)[0].size == 0
    for tok in range(0, 62):
        assert t.token_count(tok) == j.token_count(tok)
    for g in range(len(docs)):
        assert t.get_doc(g) == j.get_doc(g) == docs[g]
        assert t.get_doc_length(g) == j.get_doc_length(g)


TEXTS = ["cafÃ©", "donâ€™t stop", "caf&eacute; &amp; tea", "plain text", "naïve café",
         "Ã¼ber &lt;b&gt;", "\u2022 bullet BULLET::::- item", "Section::::History. Soup",
         "  spaced   out\ttext  ", ""]


def test_textfix_copy_equal():
    for t in TEXTS:
        assert ttf.fix_text(t) == jtf.fix_text(t), t


def _dpr_json(path):
    data = [{"question": "who eats soup", "positive_ctxs": [
        {"text": "Soup is eaten with spoons by people who like soup", "title": "Soup",
         "score": "1000", "passage_id": "p1"},
        {"text": "A fork is a poor tool for eating soup with", "title": "Fork",
         "score": "600", "passage_id": "p2"}]},
        {"question": "what is a fork", "positive_ctxs": [
            {"text": "A fork is a utensil with prongs used for eating", "title": "Fork",
             "score": "1200", "passage_id": "p2"}]}]
    path.write_text(json.dumps(data))
    return str(path)


def _kilt_files(tmp_path, tag):
    kb = tmp_path / f"kb_{tag}.tsv"
    kb.write_text("12-3\tSoup\tSoup is eaten with spoons by hungry people\n"
                  "40-1\tFork\tSection::::Use. A fork has prongs for eating\n")
    inp = tmp_path / "kilt.jsonl"
    inp.write_text("".join(json.dumps(r) + "\n" for r in [
        {"id": "q1", "input": "who eats\nsoup", "output": [
            {"provenance": [{"wikipedia_id": "12", "start_paragraph_id": 3}]}]},
        {"id": "q2", "input": "what has prongs", "output": [
            {"provenance": [{"wikipedia_id": "40", "start_paragraph_id": 1}]}]}]))
    return str(inp), str(kb)


def test_data_gen_copy_equal(tmp_path):
    """Each function of the copy gives the JAX package's output on the
    inputs of ``tests/test_training.py``, with a fresh ``Random(0)`` each."""
    for a, b in [("soup", "soup"), ("soup", "xxxx"), ("eating soup", "eating soap")]:
        assert tdg.fuzz_ratio(a, b) == jdg.fuzz_ratio(a, b)
    toks = ["the", "soup", "is", "hot"]
    assert list(tdg.span_iterator(toks)) == list(jdg.span_iterator(toks))
    doc = "You can eat soup with a spoon but eating soup with a fork is hard"
    for mod in (tdg, jdg):
        assert mod.clean(doc) == jdg.clean(doc)
    assert list(tdg.extract_spans(doc, "eating soup with a fork", n_samples=3, min_length=3,
                                  max_length=3, rng=random.Random(0))) == \
        list(jdg.extract_spans(doc, "eating soup with a fork", n_samples=3, min_length=3,
                               max_length=3, rng=random.Random(0)))
    dpr = _dpr_json(tmp_path / "dpr.json")
    for kw in (dict(target="title", min_score=0, mark_target=True, mark_silver=True,
                    min_score_gold=500), dict(target="span", min_score=0, min_length=2,
                                              max_length=2),
               dict(target="code", min_score=0, id2code={"p1": "c42", "p2": "c7"},
                    mark_target=True)):
        assert list(tdg.supervised_dpr_pairs(dpr, rng=random.Random(0), **kw)) == \
            list(jdg.supervised_dpr_pairs(dpr, rng=random.Random(0), **kw))
    inp, kb_path = _kilt_files(tmp_path, "fn")
    kb = tdg.load_kilt_kb(kb_path, use_cache=False)
    assert kb == jdg.load_kilt_kb(kb_path, use_cache=False)
    for target in ("title", "span"):
        assert list(tdg.supervised_kilt_pairs(inp, kb, target=target, mark_target=True,
                                              min_length=2, max_length=2,
                                              rng=random.Random(0))) == \
            list(jdg.supervised_kilt_pairs(inp, kb, target=target, mark_target=True,
                                           min_length=2, max_length=2, rng=random.Random(0)))
    rows = [("1", "alpha beta gamma delta epsilon zeta eta theta", "Greek")]
    kw = dict(num_samples=2, num_title_samples=1, full_doc_n=1, min_length_input=2,
              max_length_input=2, min_length_output=2, max_length_output=2)
    assert list(tdg.unsupervised_pairs(rows, rng=random.Random(0), **kw)) == \
        list(jdg.unsupervised_pairs(rows, rng=random.Random(0), **kw))
    for mod, out in ((tdg, "t"), (jdg, "j")):
        mod.write_pairs([("a b", "c d")], str(tmp_path / out))
    for ext in (".source", ".target"):
        assert (tmp_path / f"t{ext}").read_text() == (tmp_path / f"j{ext}").read_text()


@pytest.mark.parametrize("cli", ["dpr", "kilt", "unsupervised"])
def test_dataset_cli_outputs_equal(tmp_path, cli):
    """The port's dataset CLIs write the same files as the JAX package's
    for one seed."""
    outs = {}
    for tag, mods in (("t", (tdpr_cli, tkilt_cli, tunsup_cli)),
                      ("j", (jdpr_cli, jkilt_cli, junsup_cli))):
        dpr_cli, kilt_cli, unsup_cli = mods
        out = str(tmp_path / f"out_{tag}")
        if cli == "dpr":
            args = [_dpr_json(tmp_path / "dpr.json"), out, "--min_score", "0",
                    "--min_length", "3", "--max_length", "3", "--n_samples", "2",
                    "--mark_target", "--mark_silver", "--seed", "5"]
            assert dpr_cli.main(args) == 0
            files = [out + ".source", out + ".target"]
        elif cli == "kilt":
            inp, kb = _kilt_files(tmp_path, tag)  # each run its own KB cache
            assert kilt_cli.main([inp, out, "--kb", kb, "--target", "title", "--mark_target",
                                  "--seed", "5"]) == 0
            files = [out + ".source", out + ".target"]
        else:
            tsv = tmp_path / "corpus.tsv"
            tsv.write_text("id\ttext\ttitle\n" + "".join(
                f"{i}\t{' '.join(f'w{j}' for j in range(i, i + 30))}\tTitle {i}\n"
                for i in range(4)))
            assert unsup_cli.main([str(tsv), out + ".source", out + ".target",
                                   "--min_length_input", "3", "--max_length_input", "4",
                                   "--num_samples", "3", "--seed", "5"]) == 0
            files = [out + ".source", out + ".target"]
        outs[tag] = [open(f).read() for f in files]
    assert outs["t"] == outs["j"] and outs["t"][0]
