"""The port's CLIs against the JAX package's, each ``main(argv)`` called in
this process on the same files.

``build_fm_index``: the same ``.fmi.npz`` arrays, ``.oth`` and word-vocab
files (KILT, DPR, ``--shards 2``: the shard files and the manifest).
``search --device cpu``: the DPR, KILT and TREC outputs, parsed, with the
same documents in the same order, scores within 1e-4 relative (the
searcher tests' tolerance) and the same texts.  ``serve``: the same JSONL
out for the same JSONL in, malformed lines skipped.  ``adaptive_batches``
flushes a partial batch on an idle pipe; ``--multihost`` without a card
(and without ``--device cpu``) raises; its two-rank runs are in
``test_torch_mesh.py``."""

import io
import json
import os
import threading

import numpy as np
import pytest
import torch

from seal_tpu.cli import build_fm_index as jbuild
from seal_tpu.cli import search as jsearch
from seal_tpu.cli import serve as jserve
from seal_tpu_torch.cli import build_fm_index as tbuild
from seal_tpu_torch.cli import search as tsearch
from seal_tpu_torch.cli import serve as tserve
from seal_tpu_torch.models.tokenizer import WordVocabTokenizer
from test_torch_searcher_load import CORPUS, QUERIES, boosted_checkpoint, corpus_rows, write_kilt

RTOL = 1e-4
# the title decode and the unigram scores stay off here: the searcher tests
# hold them to JAX, and each costs the JAX side a compile
QUICK = ["--dont_decode_titles", "--dont_unigram_scores"]


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Both packages' index builds on one KILT and one DPR corpus (monolithic, and
    the KILT one over 2 shards), a checkpoint and DPR / KILT topics."""
    d = tmp_path_factory.mktemp("cli")
    # KILT ids ("wikipedia id-paragraph"): the KILT writer parses them
    rows = [(f"{10 + i}-{i % 3}", t, c, b) for i, (_, t, c, b) in enumerate(corpus_rows(12))]
    write_kilt(d / "corpus.tsv", rows)
    (d / "corpus_dpr.tsv").write_text(
        "id\ttext\ttitle\n" + "".join(f"{i}\t{c} || {b}\t{t}\n" for i, t, c, b in rows))
    for pkg, build in (("j", jbuild), ("t", tbuild)):
        assert build.main([str(d / "corpus.tsv"), str(d / f"{pkg}_kilt"), "--include_title",
                           "--train_word_vocab"]) == 0
        assert build.main([str(d / "corpus_dpr.tsv"), str(d / f"{pkg}_dpr"), "--format", "dpr",
                           "--include_title", "--train_word_vocab"]) == 0
        assert build.main([str(d / "corpus.tsv"), str(d / f"{pkg}_sh"), "--include_title",
                           "--tokenizer", str(d / f"{pkg}_kilt.word_vocab.json"),
                           "--shards", "2"]) == 0
    tok = WordVocabTokenizer.load(str(d / "t_kilt.word_vocab.json"))
    boosts = [(" " + b, 6.0) for *_, b in CORPUS] + [(f" {t} @@", 8.0) for _, t, _, _ in CORPUS]
    boosted_checkpoint(str(d / "main.pt"), tok, boosts, seed=0)
    (d / "topics.json").write_text(json.dumps([{"question": q, "answers": ["x"]} for q in QUERIES]))
    (d / "topics.jsonl").write_text("".join(
        json.dumps({"id": f"q{i}", "input": q}) + "\n" for i, q in enumerate(QUERIES)))
    return d


@pytest.mark.parametrize("stem", ["kilt", "dpr", "sh"])
def test_build_fm_index_files_match_jax(built, stem):
    d = built
    jnames = [n[2:] for n in os.listdir(d) if n.startswith(f"j_{stem}.")]
    tnames = [n[2:] for n in os.listdir(d) if n.startswith(f"t_{stem}.")]
    assert sorted(jnames) == sorted(tnames) and tnames
    if stem == "sh":
        assert any(n.endswith(".manifest.json") for n in tnames)
        assert sum(n.endswith(".fmi.npz") for n in tnames) == 2
    for name in tnames:
        jp, tp = d / f"j_{name}", d / f"t_{name}"
        if name.endswith(".npz"):  # zip members carry a time stamp: compare the arrays
            with np.load(jp) as a, np.load(tp) as b:
                assert sorted(a.files) == sorted(b.files)
                for k in a.files:
                    assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
        else:
            assert jp.read_bytes() == tp.read_bytes(), name


def _search_argv(d, pkg, fmt, topics, out, *extra):
    return ["--topics", str(d / topics), "--topics_format", "dpr" if topics.endswith("json")
            else "kilt", "--output", str(out), "--output_format", fmt, "--hits", "4",
            "--fm_index", str(d / f"{pkg}_kilt"), "--tokenizer",
            str(d / f"{pkg}_kilt.word_vocab.json"), "--checkpoint", str(d / "main.pt"),
            "--dont_fairseq_checkpoint", "--backbone", "tiny-word", "--beam", "3",
            "--length", "3", "--batch_size", "2", *QUICK, *extra]


def _ranked(fmt, path):
    """(query id, [(docid, score, text)]) of each query of an output file."""
    text = path.read_text()
    if fmt == "trec":
        out = {}
        for line in text.splitlines():
            q, _, doc, rank, score, tag = line.split()
            out.setdefault(q, []).append((doc, float(score), int(rank), tag))
        return list(out.items())
    if fmt == "dpr":
        return [(t["question"], [(c["passage_id"], c["score"], c["title"], c["text"])
                                 for c in t["ctxs"]]) for t in json.loads(text)]
    return [(o["id"], [(p["wikipedia_id"], p["score"], p["start_paragraph_id"], p["text"])
                       for p in o["output"][0]["provenance"]])
            for o in map(json.loads, text.splitlines())]


def _assert_same_ranked(got, want):
    assert [q for q, _ in got] == [q for q, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert [(h[0],) + tuple(h[2:]) for h in g] == [(h[0],) + tuple(h[2:]) for h in w]
        np.testing.assert_allclose([h[1] for h in g], [h[1] for h in w], rtol=RTOL)


@pytest.mark.parametrize("fmt,topics", [("dpr", "topics.json"), ("kilt", "topics.jsonl"),
                                        ("trec", "topics.json")])
def test_search_cli_outputs_match_jax(built, tmp_path, fmt, topics):
    d = built
    assert jsearch.main(_search_argv(d, "j", fmt, topics, tmp_path / "j.out")) == 0
    assert tsearch.main(_search_argv(d, "t", fmt, topics, tmp_path / "t.out",
                                     "--device", "cpu")) == 0
    got, want = _ranked(fmt, tmp_path / "t.out"), _ranked(fmt, tmp_path / "j.out")
    assert len(got) == len(QUERIES) and all(hits for _, hits in got)
    _assert_same_ranked(got, want)


def test_serve_cli_matches_jax(built):
    d = built
    lines = [json.dumps({"id": f"q{i}", "query": q}) for i, q in enumerate(QUERIES[:3])]
    lines[1:1] = ["{not json", json.dumps({"id": 9, "query": 7}), "[1, 2]"]  # malformed
    lines.append(json.dumps(QUERIES[3]))  # a bare string
    outs = {}
    for pkg, serve in (("j", jserve), ("t", tserve)):
        argv = ["--fm_index", str(d / f"{pkg}_kilt"), "--tokenizer",
                str(d / f"{pkg}_kilt.word_vocab.json"), "--checkpoint", str(d / "main.pt"),
                "--dont_fairseq_checkpoint", "--backbone", "tiny-word", "--beam", "3",
                "--length", "3", "--batch_size", "2", "--hits", "3", *QUICK]
        if pkg == "t":
            argv += ["--device", "cpu"]
        out = io.StringIO()
        assert serve.main(argv, stdin=io.StringIO("\n".join(lines) + "\n"), stdout=out) == 0
        outs[pkg] = [json.loads(x) for x in out.getvalue().splitlines()]
    got, want = outs["t"], outs["j"]
    # "{not json" is served as a bare string, as JAX does; the other two are
    # skipped; a line without an id takes its place in the stream (skips count)
    assert [r["id"] for r in got] == [r["id"] for r in want] == ["q0", 1, "q1", "q2", 6]
    for g, w in zip(got, want):
        assert g["query"] == w["query"]
        assert [(h["docid"], h["title"], h["text"]) for h in g["hits"]] == [
            (h["docid"], h["title"], h["text"]) for h in w["hits"]]
        np.testing.assert_allclose([h["score"] for h in g["hits"]],
                                   [h["score"] for h in w["hits"]], rtol=RTOL)


def test_adaptive_batches_flushes_on_idle_pipe():
    """A trickling client on a pipe gets its partial batch flushed while the
    pipe stays open; a stream without a file descriptor batches plainly."""
    from seal_tpu_torch.utils.batching import adaptive_batches

    r_fd, w_fd = os.pipe()
    r, w = os.fdopen(r_fd, "r"), os.fdopen(w_fd, "w")
    got, done = [], threading.Event()

    def consume():
        for batch in adaptive_batches(r, lambda x: x.strip() or None, n=20):
            got.append(batch)
            done.set()

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    w.write("one\n")
    w.flush()
    assert done.wait(timeout=10), "partial batch was not flushed while idle"
    assert got[0] == ["one"]
    w.write("two\nthree")  # the last line without its newline, then EOF
    w.close()
    t.join(timeout=10)
    assert not t.is_alive() and got[1:] == [["two", "three"]]
    r.close()
    s = io.StringIO("a\nb\n\nc\n")
    assert list(adaptive_batches(s, lambda x: x.strip() or None, n=2)) == [["a", "b"], ["c"]]


@pytest.mark.parametrize("cli", [tsearch, tserve])
def test_multihost_raises(built, tmp_path, monkeypatch, cli):
    """``--multihost`` serves each rank on its own card (``cuda:LOCAL_RANK``):
    with no card and no ``--device cpu`` it raises, also as one process (no
    coordinator: ``init_distributed`` is a no-op)."""
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--fm_index", "x", "--multihost"]
    if cli is tsearch:
        argv += ["--topics", str(built / "topics.json"), "--topics_format", "dpr", "--output",
                 str(tmp_path / "o")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
