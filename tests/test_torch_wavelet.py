"""The port's compact and hybrid wavelet layouts against ``seal_tpu``'s, on
the CPU (the port runs its kernels' plain versions).

Corpora at 1, 2, 4 and 5 four-bit digits (vocab 14, 96, 50265 and one just
above 65535): the builder's arrays equal ``WaveletFMIndex.from_host``'s bit
for bit (the hybrid BWT at the JAX width too), and every ``wt_ops`` op
equals the JAX op exactly, with empty ranges, ``hi = n_rows``, the
sentinel's row, out-of-vocab symbols and tokens past sigma.  Generation
over either layout equals JAX's over its wavelet index (tokens equal,
scores within 1e-4) and the port's own Psi-layout run (tokens and scores
equal), ``force_full`` included; the searcher with ``compact_index`` or
``hybrid_index`` equals the JAX searcher with the same knob.  Also the
constructors' default device."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal_tpu.decoding import generate as jg
from seal_tpu.index import FMIndex
from seal_tpu.index.wavelet import WaveletFMIndex
from seal_tpu.ops import wt_ops as jops
from seal_tpu.retrieval.searcher import SEALSearcher as JSearcher
from seal_tpu_torch.decoding import constrained as tc
from seal_tpu_torch.decoding import generate as tg
from seal_tpu_torch.index.device_index import TorchFMIndex
from seal_tpu_torch.index.wavelet import WaveletIndex
from seal_tpu_torch.kernels import wt_bucket_counts, wt_search, wt_window
from seal_tpu_torch.models import bart as tbart
from seal_tpu_torch.models import convert as tconvert
from seal_tpu_torch.ops import wt_ops as tops
from seal_tpu_torch.retrieval.searcher import SEALSearcher as TSearcher
from test_torch_generate import _assert_same_hyps, _models, _random_corpus
from test_torch_searcher import CORPUS, KNOBS, QUERIES, _assert_same_results, _build

# (vocab, largest corpus symbol + 1, n_docs): digits 1, 2, 4 and 5
CASES = {"d1": (14, 14, 12), "d2": (96, 90, 30), "d4": (50265, 50200, 30),
         "d5": (65600, 65590, 8)}


def _host(name):
    vocab, hi, n_docs = CASES[name]
    rng = np.random.default_rng(vocab)
    docs = [rng.integers(0, hi, size=rng.integers(2, 40)).tolist() for _ in range(n_docs)]
    docs[0] += [hi - 1, hi - 1]  # the largest symbol occurs
    host = FMIndex()
    host.initialize(docs)
    return host


@pytest.fixture(scope="module", params=sorted(CASES))
def layouts(request):
    host = _host(request.param)
    vocab = CASES[request.param][0]
    pairs = {keep: (WaveletFMIndex.from_host(host, vocab=vocab, keep_bwt=keep),
                    WaveletIndex.from_host(host, vocab=vocab, keep_bwt=keep, device="cpu"))
             for keep in (False, True)}
    return request.param, host, vocab, pairs


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _ranges(host, rng, n=40):
    """Corpus ranges of one- and two-token n-grams, random sub-intervals,
    and full, empty, end-of-index, (0, 0) and the sentinel's row."""
    N = host.size()
    text = (host.text[:-1] - 1).tolist()
    los, his = [], []
    for _ in range(n // 2):
        i = int(rng.integers(0, len(text) - 2))
        lo, hi = host.get_range(text[i : i + int(rng.integers(1, 3))][::-1])
        los.append(lo)
        his.append(hi)
    for _ in range(n // 2 - 5):
        a = int(rng.integers(0, N))
        los.append(a)
        his.append(int(rng.integers(a, N + 1)))
    sentinel = int(np.flatnonzero(np.asarray(host.bwt) == 0)[0])
    los += [0, 5, N, 0, sentinel]
    his += [N, 5, N, 0, sentinel + 1]
    return np.asarray(los, np.int32), np.asarray(his, np.int32)


def test_builder_matches_jax(layouts):
    name, host, vocab, pairs = layouts
    want_digits = {"d1": 1, "d2": 2, "d4": 4, "d5": 5}[name]
    for keep, (j, t) in pairs.items():
        assert t.digits == j.digits == want_digits
        assert t.blocks.dtype == torch.int32
        _eq(np.asarray(j.blocks).view(np.int32), t.blocks)
        for field in ("node_start", "node_cnt", "C", "corpus_counts", "beginnings"):
            _eq(getattr(j, field), getattr(t, field))
        for field in ("n_rows", "digits", "sigma", "vocab", "n_docs"):
            assert getattr(t, field) == getattr(j, field), field
        assert t.memory_bytes() == j.memory_bytes()
        if keep:
            jb = np.asarray(j.bwt)
            assert t.bwt.element_size() == jb.dtype.itemsize == (2 if vocab < 0xFFFF else 4)
            _eq(jb, torch.from_numpy(t.bwt.numpy().view(jb.dtype)))
        else:
            assert t.bwt is None and j.bwt is None
        lo, hi = t.full_range((2, 3))
        assert lo.shape == (2, 3) and int(hi[0, 0]) == host.size() == t.n_rows
        assert t.device == torch.device("cpu")


def test_rank_access_bwt_at_match_jax(layouts):
    _, host, vocab, pairs = layouts
    rng = np.random.default_rng(1)
    n = host.size()
    (jc, tcm), (jh, th) = pairs[False], pairs[True]
    # shifted symbols past sigma and past the padded C too; positions 0..N
    symbols = rng.integers(-1, jc.C.size + 3, size=300).astype(np.int32)
    positions = rng.integers(0, n + 1, size=300).astype(np.int32)
    positions[:5] = n
    _eq(jops.rank(jc, symbols, positions), tops.rank(tcm, symbols, positions))
    want = [host.occ(int(s), int(p)) if 0 <= s < host.C.size - 1 else 0
            for s, p in zip(symbols, positions)]
    assert tops.rank(tcm, symbols, positions).tolist() == want
    rows = rng.integers(0, n, size=300).astype(np.int32)
    rows[:2] = (n - 1, int(np.flatnonzero(np.asarray(host.bwt) == 0)[0]))
    _eq(jops.access(jc, rows), tops.access(tcm, rows))
    _eq(host.bwt[rows], tops.access(tcm, rows))
    for j, t in ((jc, tcm), (jh, th)):
        _eq(jops.bwt_at(j, rows), tops.bwt_at(t, rows))


def test_descent_trace(layouts):
    """``trace`` records each level's (position, node, digit): the digits
    spell the symbol, the root level reads the position itself, and the
    result does not change."""
    _, host, _, pairs = layouts
    t = pairs[False][1]
    rng = np.random.default_rng(3)
    n = host.size()
    symbols = torch.as_tensor(rng.integers(0, t.sigma, size=50).astype(np.int32))
    positions = torch.as_tensor(rng.integers(0, n + 1, size=50).astype(np.int32))
    rows = torch.as_tensor(rng.integers(0, n, size=50).astype(np.int32))
    for run, args, spelled in ((wt_search.rank_plain, (symbols, positions), symbols),
                               (wt_search.access_plain, (rows,), None)):
        trace = []
        out = run(t, *args, trace=trace)
        assert torch.equal(out, run(t, *args))
        assert len(trace) == t.digits
        assert torch.equal(trace[0][0], args[-1]) and not trace[0][1].any()
        word = torch.zeros_like(out)
        for _, _, d in trace:
            word = (word << 4) | d
        assert torch.equal(word, out if spelled is None else spelled)


def test_backward_step_contains_sequences_match_jax(layouts):
    _, host, vocab, pairs = layouts
    rng = np.random.default_rng(2)
    j, t = pairs[False]
    los, his = _ranges(host, rng)
    toks = rng.integers(-2, vocab + 3, size=(los.size, 7)).astype(np.int32)
    toks[:, -1] = vocab - 1  # largest in-vocab id
    toks[:, -2] = (host.text[: los.size] - 1).astype(np.int32)  # likely members
    args = (toks, los[:, None], his[:, None])
    for a, b in zip(jops.backward_step(j, *args), tops.backward_step(t, *args)):
        _eq(a, b)
    for a, b in zip(jops.extend_ranges(j, toks[:, 0], los, his),
                    tops.extend_ranges(t, toks[:, 0], los, his)):
        _eq(a, b)
    got = tops.contains_tokens(t, toks, los, his)
    assert got.dtype == torch.bool and got.any()
    _eq(jops.contains_tokens(j, toks, los, his), got)
    _eq(jops.validate_tokens(j, toks, los, his), tops.validate_tokens(t, toks, los, his))
    # padded sequences at every length 0..L: corpus n-grams (forward, so
    # reversed slices of the text), random and out-of-range tokens
    L = 4
    text = (host.text[:-1] - 1).tolist()
    seqs = [text[i : i + L][::-1] for i in rng.integers(0, len(text) - L, size=24)]
    seqs += [rng.integers(-2, vocab + 3, size=L).tolist() for _ in range(8)]
    tk = np.asarray(seqs, np.int32)
    lens = (np.arange(len(seqs)) % (L + 1)).astype(np.int32)
    lo, hi = tops.range_for_sequences(t, tk, lens)
    for a, b in zip(jops.range_for_sequences(j, tk, lens), (lo, hi)):
        _eq(a, b)
    assert ((hi - lo) > 0).sum() >= 10
    _eq(jops.count_sequences(j, tk, lens), tops.count_sequences(t, tk, lens))


@pytest.mark.parametrize("w,fill", [(4, 1), (16, 0)])
def test_windows_match_jax(layouts, w, fill):
    """``window_continuations`` and kernel 13's plain version (the window +
    take_along_axis of the log-probs), compact and hybrid."""
    _, host, vocab, pairs = layouts
    los, his = _ranges(host, np.random.default_rng(3))
    lp = np.random.default_rng(4).normal(size=(los.size, vocab)).astype(np.float32)
    for j, t in pairs.values():
        jt, jv = jops.window_continuations(j, los, his, w)
        for a, b in zip((jt, jv), tops.window_continuations(t, los, his, w)):
            _eq(a, b)
        jt = jnp.where(jv, jt, fill)
        before = wt_window.wt_window_gather.launches
        tok, valid, tlp = tops.window_gather(t, torch.as_tensor(los), torch.as_tensor(his), w,
                                             torch.as_tensor(lp), fill)
        assert wt_window.wt_window_gather.launches == before  # CPU: no launch
        assert tok.dtype == torch.int32 and valid.dtype == torch.bool
        _eq(jt, tok)
        _eq(jv, valid)
        _eq(jnp.take_along_axis(jnp.asarray(lp), jt, axis=-1), tlp)


def test_bucket_counts_match_jax(layouts):
    _, host, vocab, pairs = layouts
    j, t = pairs[True]
    los, his = _ranges(host, np.random.default_rng(5))
    assert tops.bucket_counts_width(t) == jops.bucket_counts_width(j)
    assert tops.bucket_size_of(t) == jops.bucket_size_of(j)
    assert tc.SingleIndexOps(t).bucket_size() == jops.bucket_size_of(j)
    got = tops.bucket_counts(t, los, his)
    _eq(jops.bucket_counts(j, los, his), got)
    np.testing.assert_array_equal(got.sum(-1).numpy(), his - los)
    shape = (3, 4)
    _eq(jops.bucket_counts(j, los[:12].reshape(shape), his[:12].reshape(shape)),
        tops.bucket_counts(t, los[:12].reshape(shape), his[:12].reshape(shape)))


@pytest.mark.parametrize("keep_bwt", [False, True], ids=["compact", "hybrid"])
def test_bucket_support_match_jax(layouts, keep_bwt):
    """Kernel 14's support mode's plain version (and the adapter's
    ``bucket_support``) == JAX's ``wt_ops.bucket_counts > 0`` on the compact
    and hybrid layouts at 1, 2, 4 and 5 digits (16 buckets at 1), at corpus
    n-gram, random, full, empty and one-row ranges."""
    from test_torch_fm_ops import _assert_support

    _, host, vocab, pairs = layouts
    j, t = pairs[keep_bwt]
    los, his = _ranges(host, np.random.default_rng(6))
    want = jops.bucket_counts(j, los, his)
    before = wt_bucket_counts.wt_bucket_support.launches
    _assert_support(want, tops.bucket_support(t, los, his))
    _assert_support(want, tc.SingleIndexOps(t).bucket_support(torch.as_tensor(los),
                                                               torch.as_tensor(his)))
    assert wt_bucket_counts.wt_bucket_support.launches == before
    shape = (4, 5)
    _assert_support(jops.bucket_counts(j, los[:20].reshape(shape), his[:20].reshape(shape)),
                    tops.bucket_support(t, los[:20].reshape(shape), his[:20].reshape(shape)))


def test_wrappers_count_no_launch_on_cpu(layouts):
    _, host, _, pairs = layouts
    _, t = pairs[True]
    fns = (wt_search.wt_search, wt_window.wt_window_gather, wt_bucket_counts.wt_bucket_counts,
           wt_bucket_counts.wt_bucket_support)
    counts = [fn.launches for fn in fns]
    tops.backward_step(t, [3], [0], [host.size()])
    tops.contains_tokens(t, [[3, 4]], [0], [host.size()])
    tops.range_for_sequences(t, [[3, 4]], [2])
    tops.bucket_counts(t, [0], [host.size()])
    tops.bucket_support(t, [0], [host.size()])
    assert counts == [fn.launches for fn in fns]


def _wavelet_generate(models, host, queries, layout, V=96, **kw):
    """The JAX decode over its wavelet index and the port's over its own."""
    jcfg, tcfg, params, tparams = models
    keep = layout == "hybrid"
    ids, mask = jg.pad_batch(queries, jcfg.pad_token_id)
    jh = jg.fm_index_generate(jcfg, params, WaveletFMIndex.from_host(host, vocab=V, keep_bwt=keep),
                              ids, mask, **kw)
    t = WaveletIndex.from_host(host, vocab=V, keep_bwt=keep, device="cpu")
    th = tg.fm_index_generate(tcfg, tparams, t, ids, mask, **kw)
    return jh, th, t


def _canon(hyps):
    return [sorted((tuple(t), s) for s, t in h) for h in hyps]


COMMON = dict(num_beams=4, max_length=6, min_length=1, forced_bos_token_id=None)


@pytest.mark.parametrize("layout", ["compact", "hybrid"])
@pytest.mark.parametrize("seed,budget", [(0, "tiny"), (1, "tiny"), (4, "default"), (5, "oov")])
def test_generate_matches_jax_and_psi(seed, budget, layout):
    """Hypotheses equal JAX's over its wavelet index (scores within 1e-4)
    and the port's Psi-layout run's (tokens and scores equal); ``oov``
    draws the corpus from 140 symbols, past the model's 96."""
    models = _models()
    host, queries = _random_corpus(seed, **({"hi": 140, "n_docs": 40} if budget == "oov" else {}))
    kw = dict(window=4, exact_chunk=4) if budget != "default" else {}
    jh, th, _ = _wavelet_generate(models, host, queries, layout, **kw, **COMMON)
    assert sum(len(h) for h in th) > 0
    _assert_same_hyps(jh, th)
    _, tcfg, _, tparams = models
    psi = tg.fm_index_generate(tcfg, tparams, TorchFMIndex.from_host(host, vocab=96, device="cpu"),
                               queries, **kw, **COMMON)
    assert _canon(th) == _canon(psi)
    assert all(t < 96 for h in th for _, toks in h for t in toks)


@pytest.mark.parametrize("layout", ["compact", "hybrid"])
def test_force_full_and_forced_prefix_match(layout):
    """A three-digit alphabet (V = 300: wavelet buckets of 16 symbols, Psi
    buckets of 2) through the proven loop, with a forced prefix and a
    custom EOS: the fast path equals ``force_full`` and the Psi layout's
    ``force_full``, and JAX's fast path."""
    V = 300
    rng = np.random.default_rng(11)
    docs = [rng.integers(4, 40, size=rng.integers(1, 4)).tolist() + [50]
            + rng.integers(4, 290, size=rng.integers(5, 20)).tolist() + [2] for _ in range(30)]
    host = FMIndex()
    host.initialize(docs)
    queries = [[0] + rng.integers(4, 290, size=5).tolist() + [2] for _ in range(3)]
    models = _models(V=V)
    kw = dict(num_beams=4, max_length=7, min_length=1, eos_token_id=50, force_decoding_from=[2],
              forced_bos_token_id=None, window=4, exact_chunk=2)
    jh, th, t = _wavelet_generate(models, host, queries, layout, V=V, **kw)
    assert t.digits == 3 and tops.bucket_size_of(t) == 16
    _assert_same_hyps(jh, th)
    _, tcfg, _, tparams = models
    full = tg.fm_index_generate(tcfg, tparams, t, queries, force_full=True, **kw)
    psi_full = tg.fm_index_generate(
        tcfg, tparams, TorchFMIndex.from_host(host, vocab=V, device="cpu"), queries,
        force_full=True, **kw)
    assert _canon(th) == _canon(full) == _canon(psi_full)
    assert sum(len(h) for h in th) > 0


@pytest.fixture(scope="module")
def searcher_fixture():
    rng = np.random.default_rng(0)
    filler_words = [f"word{i}" for i in range(80)]
    filler = [(f"f{i}", f"Filler{i}", " ".join(rng.choice(filler_words, size=30)))
              for i in range(20)]
    return _build(CORPUS + filler)


@pytest.mark.parametrize("knob", ["compact_index", "hybrid_index"])
def test_searcher_layouts_match_jax(searcher_fixture, knob):
    """``SEALSearcher(compact_index=True)`` / ``(hybrid_index=True)``: the
    device index is the wavelet layout, and the results equal the JAX
    searcher's with the same knob (doc order, scores within 1e-4
    relative), also with the key counts taken from the device index."""
    index, jtok, ttok, jcfg, tcfg, params, tparams = searcher_fixture
    knobs = dict(KNOBS, **{knob: True})
    js = JSearcher(index, jtok, jcfg, params, **knobs)
    ts = TSearcher(index, ttok, tcfg, tparams, **knobs)
    assert isinstance(ts.device_index, WaveletIndex)
    assert (ts.device_index.bwt is not None) == (knob == "hybrid_index")
    jres, tres = js.batch_search(QUERIES, k=5), ts.batch_search(QUERIES, k=5)
    assert all(tres)
    _assert_same_results(jres, tres)
    seqs = [[5, 6], [ts.title_bos_token_id, 9], [400], [7, 8, 9, 10, 11]]
    want = ts._device_ranges(seqs)
    psi = index.psi
    index.psi = None  # the key counts through kernel 12's sequences mode
    try:
        got = ts._device_ranges(seqs)
    finally:
        index.psi = psi
    assert got == want == [index.get_range(s) for s in seqs]


def test_constructors_default_to_cuda(monkeypatch):
    """The entry points run on the card unless the caller asks for the CPU:
    every constructor defaults to ``"cuda"`` and raises, never falls back,
    where no CUDA device exists."""
    for fn in (tbart.init_params, tbart.empty_self_cache, tconvert.params_from_jax,
               TorchFMIndex.from_host, WaveletIndex.from_host):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg, _, _ = _models(V=30)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbart.init_params(tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WaveletIndex.from_host(_host("d1"))
    assert tbart.init_params(tcfg, device="cpu")["shared"].device.type == "cpu"
