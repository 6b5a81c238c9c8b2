"""The port's free generation (``disable_fm_index``, the searcher's
``free_generation``), ``locate_rows`` / ``doc_index_of`` and the kernels
under them against ``seal_tpu``'s, on the CPU (the kernels' plain
versions).

``locate_rows`` and ``doc_index_of`` equal the JAX ops and the host index
exactly, out-of-range rows and document starts and ends included; kernel
19's plain top-k and k-th value equal ``lax.top_k`` on rows with signed
zeros, -inf, ``NEG_INF`` and heavy ties; kernel 8's token-table epilogue
equals ``_select`` bit for bit.  Free generation equals JAX's (tokens
equal, scores within 1e-4) across seeds and options, step by step too, and
the reference mirror; ``exact_mask`` does not change it, and under exact
logit ties the fast order equals ``exact_ties``.  The free-generation
searcher equals the JAX searcher's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from seal_tpu.decoding import constrained as jc
from seal_tpu.decoding import generate as jg
from seal_tpu.index import FMIndex
from seal_tpu.index.device_index import DeviceFMIndex
from seal_tpu.models import bart as jbart
from seal_tpu.models.config import bart_tiny as jtiny
from seal_tpu.ops import fm_ops as jfm
from seal_tpu.retrieval.searcher import SEALSearcher as JSearcher
from seal_tpu_torch.decoding import constrained as tc
from seal_tpu_torch.decoding import generate as tg
from seal_tpu_torch.index.device_index import TorchFMIndex
from seal_tpu_torch.kernels import beam_select, locate, row_select, row_topk
from seal_tpu_torch.models import bart as tbart
from seal_tpu_torch.models import convert as tconvert
from seal_tpu_torch.models.config import bart_tiny as ttiny
from seal_tpu_torch.ops import fm_ops as tfm
from seal_tpu_torch.retrieval.searcher import SEALSearcher as TSearcher
from test_torch_dense import tied  # noqa: F401  (fixture)
from test_torch_generate import _assert_same_hyps, _models, _random_corpus
from test_torch_searcher import KNOBS, QUERIES, _assert_same_results, searchers  # noqa: F401
from tests.reference_impl import reference_generate

FREE = dict(num_beams=4, max_length=6, min_length=1, forced_bos_token_id=None,
            disable_fm_index=True)


@pytest.fixture(scope="module")
def models():
    return _models()


def _canon(hyps):
    return [sorted((tuple(t), s) for s, t in h) for h in hyps]


# ---------------------------------------------------------------- kernel 18


@pytest.mark.parametrize("seed", [0, 1])
def test_locate_rows_and_doc_index_match_jax(seed):
    """``tests/test_fm_ops.py:135-147`` on the port: rows in and out of
    range, positions at every document's start and end."""
    host, _ = _random_corpus(seed)
    jdev = DeviceFMIndex.from_host(host, keep_sa=True)
    t = TorchFMIndex.from_host(host, device="cpu", keep_sa=True)
    N = host.size()
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, N, size=50), [-1, 0, N - 1, N, N + 5, -(2**31)]])
    rows = rows.astype(np.int32)
    got = tfm.locate_rows(t, rows)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfm.locate_rows(jdev, rows)))
    np.testing.assert_array_equal(got.numpy()[:50], [host.locate(int(r)) for r in rows[:50]])
    assert (got.numpy()[-3:] == -1).all() and got.numpy()[-6] == -1

    begin = np.asarray(host.beginnings, np.int64)
    positions = np.concatenate([rng.integers(0, len(host), size=50), begin[:-1], begin[1:] - 1,
                                [0, len(host) - 1]]).astype(np.int32)
    got = tfm.doc_index_of(t, positions)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfm.doc_index_of(jdev, positions)))
    np.testing.assert_array_equal(got.numpy(), [host.get_doc_index(int(p)) for p in positions])
    # a scalar row, as the JAX test's out-of-bounds probe
    assert int(tfm.locate_rows(t, N + 5)) == int(jfm.locate_rows(jdev, jnp.int32(N + 5))) == -1


SAMPLE_MAX = 4096  # beginnings a block of the search kernel stages (csrc/locate.cu)


def _search_stride(n_beg):
    """``seal_locate``'s sample stride: 8, doubled until the sample fits."""
    stride = 8
    while -(-n_beg // stride) > SAMPLE_MAX:
        stride *= 2
    return stride


def _two_level_mirror(beg, pos, stride):
    """Kernel 18's search (``csrc/locate.cu:search_kernel``) in Python: the
    samples at or below x by binary search, the 32-entry block of the
    segment by binary search, then a count inside that block."""
    n = beg.size
    samp = beg[::stride]
    out = []
    for x in pos:
        lo, hi = 0, samp.size
        while lo < hi:
            mid = (lo + hi) // 2
            lo, hi = (mid + 1, hi) if samp[mid] <= x else (lo, mid)
        if lo == 0:
            out.append(-1)
            continue
        seg = (lo - 1) * stride
        length = min(stride, n - seg)
        b_lo, b_hi = 0, -(-length // 32)
        while b_hi - b_lo > 1:
            mid = (b_lo + b_hi) // 2
            b_lo, b_hi = (mid, b_hi) if beg[seg + 32 * mid] <= x else (b_lo, mid)
        base = seg + 32 * b_lo
        m = min(32, length - 32 * b_lo)
        out.append(base + int((beg[base:base + m] <= x).sum()) - 1)
    return np.asarray(out)


@pytest.mark.parametrize("n_docs,stride", [(1, None), (31, None), (32, None), (33, None),
                                           (1000, None), (200001, None), (1000, 64), (70, 32),
                                           (70, 16), (5000, 8)])
def test_doc_index_two_level_mirror(n_docs, stride):
    """The search kernel's two levels against ``np.searchsorted`` and the
    plain version: positions before the first beginning (-1), at, before
    and after each beginning, past the last; sample strides that do not
    divide the count, and a wider one (more than 4096 samples)."""
    rng = np.random.default_rng(n_docs)
    beg = (np.cumsum(rng.integers(0, 9, size=n_docs)) + 3).astype(np.int32)  # empty docs too
    stride = _search_stride(n_docs) if stride is None else stride
    assert stride % 8 == 0 and -(-n_docs // stride) <= SAMPLE_MAX
    if n_docs > 4096 * 8:
        assert stride > 8
    pick = beg if n_docs <= 2000 else rng.choice(beg, 2000)
    pos = np.concatenate([pick, pick - 1, pick + 1, [-5, 0, 2, int(beg[-1]) + 100],
                          rng.integers(-3, int(beg[-1]) + 5, size=300)]).astype(np.int32)
    want = np.searchsorted(beg, pos, side="right") - 1
    np.testing.assert_array_equal(_two_level_mirror(beg, pos, stride), want)
    got = locate.doc_index_of(torch.as_tensor(beg), torch.as_tensor(pos))
    np.testing.assert_array_equal(got.numpy(), want)


def test_locate_needs_keep_sa_and_default_bytes_unchanged():
    host, _ = _random_corpus(2)
    plain = TorchFMIndex.from_host(host, device="cpu")
    with_sa = TorchFMIndex.from_host(host, device="cpu", keep_sa=True)
    assert plain.sa is None
    with pytest.raises(ValueError, match="keep_sa"):
        tfm.locate_rows(plain, [0, 1])
    assert with_sa.memory_bytes() == plain.memory_bytes() + 4 * host.size()
    n0 = (locate.locate_rows.launches, locate.doc_index_of.launches)
    tfm.locate_rows(with_sa, [0, 1])
    tfm.doc_index_of(with_sa, [0, 1])
    assert (locate.locate_rows.launches, locate.doc_index_of.launches) == n0  # CPU: no launch


# ------------------------------------- the modes' top-top_m (kernel 3) and kernel 19


def _select_rows(rng, rows, n):
    x = np.round(rng.normal(0, 2, size=(rows, n)), 1).astype(np.float32)
    x[0, ::3] = 0.0
    x[0, 1::3] = -0.0  # signed zeros: +0.0 ranks above -0.0
    x[1] = -np.inf
    x[1, 5:40] = 1.0
    x[2, : n // 2] = 7.5  # a plateau wider than k
    x[3] = np.float32(jc.NEG_INF)
    x[3, ::11] = -1.0
    x[4, n - 5:] = 50.0
    x[5, : n // 4] = -np.inf
    return x


@pytest.mark.parametrize("k", [1, 256, 700])
def test_row_select_plain_matches_lax_top_k(k):
    """The decode modes' top-``top_m`` (kernel 3's plain version, which
    kernel 19's top-k mode used to serve) and kernel 19's k-th value
    against ``lax.top_k`` on rows with signed zeros, -inf, plateaus."""
    x = _select_rows(np.random.default_rng(k), 7, 700)
    jv, ji = lax.top_k(jnp.asarray(x), k)
    n0 = (row_topk.row_topk.launches, row_select.row_kth.launches)
    tv, ti = row_topk.row_topk(torch.as_tensor(x), k)  # kernel 3: the modes' top-top_m
    assert ti.dtype == torch.int64
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy().view(np.int32), np.asarray(jv).view(np.int32))
    kth = row_select.row_kth(torch.as_tensor(x).reshape(1, 7, 700), k)
    assert kth.shape == (1, 7)
    np.testing.assert_array_equal(kth[0].numpy().view(np.int32),
                                  np.asarray(jv[:, -1]).view(np.int32))
    assert (row_topk.row_topk.launches, row_select.row_kth.launches) == n0
    with pytest.raises(ValueError):
        row_topk.row_topk(torch.as_tensor(x), 701)
    with pytest.raises(ValueError):
        row_select.row_kth(torch.as_tensor(x), 701)


def test_row_select_matches_lax_top_k_past_the_block_route():
    """Past ``2 * top_m * 32`` columns JAX's free generation takes the
    one-hot route of ``_exact_topk(..., assume_finite=True)``.  On finite
    log-prob rows it equals ``lax.top_k``, and so does kernel 3's plain
    version.  With the SEAL bias's -inf columns JAX's route is not exact (0
    x -inf in its block gather; ROADMAP C), and the port keeps ``lax.top_k``'s
    result there."""
    rng = np.random.default_rng(3)
    x = rng.normal(0, 3, size=(3, 20000)).astype(np.float32)
    x = x - np.log(np.exp(x).sum(-1, keepdims=True))
    for fill in (-30.0, -np.inf):
        x[:, [0, 1, 3]] = fill
        want_v, want_i = lax.top_k(jnp.asarray(x), 256)
        tv, ti = row_topk.row_topk(torch.as_tensor(x), 256)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(want_v))
        _, got_i = jc._exact_topk(jnp.asarray(x), 256, blk=32, assume_finite=True)
        assert np.array_equal(np.asarray(got_i), np.asarray(want_i)) == (fill == -30.0)


# ---------------------------------------------------------------- kernel 8


@pytest.mark.parametrize("n_par,ties", [(1, False), (4, False), (4, True)])
def test_select_top_token_table_matches_jax_select(n_par, ties):
    """``beam_select_top`` with a token table (plain) after kernel 3 equals
    JAX ``_select`` over the same [B, n_par, m] candidates, bit for bit."""
    rng = np.random.default_rng(n_par)
    B, K, V, m = 3, 4, 50, 12
    lp = np.round(rng.normal(-3, 1, size=(B * n_par, V)), 1).astype(np.float32)
    lp[:, 7] = -0.0
    lp[:, 8] = 0.0
    tok = np.stack([rng.permutation(V)[:m] for _ in range(B * n_par)]).astype(np.int32)
    tok[0, :3] = [7, 8, 2]
    bs = np.round(rng.normal(-2, 1, size=(B, K)), 1).astype(np.float32)
    bs[:, n_par:] = jc.NEG_INF
    cand = np.take_along_axis(lp, tok, -1).reshape(B, n_par, m)
    cons = cand + bs[:, :n_par, None]
    cfg = jc.DecodeConfig(num_beams=K, exact_ties=ties)
    want = jc._select(cfg, jnp.asarray(cons), jnp.asarray(cons), jnp.asarray(tok.reshape(B, n_par, m)),
                      K, V)
    if ties:
        top_idx = beam_select.top_by_score_then_id(
            torch.as_tensor(cons.reshape(B, -1)),
            beam_select.beam_tok_tie(torch.as_tensor(tok.reshape(B, -1)), m, V), 2 * K)
        top_cons = torch.gather(torch.as_tensor(cons.reshape(B, -1)), 1, top_idx)
    else:
        top_cons, top_idx = row_select.row_topk_plain(torch.as_tensor(cons.reshape(B, -1)), 2 * K)
    got = beam_select.beam_select_top(top_cons, top_idx, torch.as_tensor(lp), torch.as_tensor(bs),
                                      n_par, K, 2, tokens=torch.as_tensor(tok))
    for a, b in zip(got, want):
        a, b = a.numpy(), np.asarray(b)
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b.astype(a.dtype))


# ---------------------------------------------------------------- generation


@pytest.mark.parametrize(
    "seed,extra",
    [(0, {}), (1, {}), (2, dict(stop_at_count=2)), (3, dict(min_length=4, max_length=7)),
     (4, dict(always_allow_eos=True)), (5, dict(top_m=8))],
)
def test_free_generation_matches_jax(models, seed, extra):
    jcfg, tcfg, params, tparams = models
    host, queries = _random_corpus(seed)
    kw = dict(FREE, **extra)
    ids, mask = jg.pad_batch(queries, jcfg.pad_token_id)
    jh = jg.fm_index_generate(jcfg, params, DeviceFMIndex.from_host(host, vocab=96), ids, mask,
                              **kw)
    idx = TorchFMIndex.from_host(host, vocab=96, device="cpu")
    th = tg.fm_index_generate(tcfg, tparams, idx, ids, mask, **kw)
    assert sum(len(h) for h in th) > 0
    _assert_same_hyps(jh, th)
    # the candidate set never leaves the exact top-top_m: exact_mask has no
    # say under disable_fm_index (it wins over the dense mode, as in JAX)
    assert _canon(tg.fm_index_generate(tcfg, tparams, idx, ids, mask, exact_mask=True, **kw)) \
        == _canon(th)


def test_free_generation_step_outputs_match_jax(models):
    """Raw free-generation outputs: candidate tokens, parents, finiteness and
    selections equal JAX's step by step; scores within tolerance."""
    jcfg, tcfg, params, tparams = models
    host, queries = _random_corpus(1)
    ids, mask = jg.pad_batch(queries, jcfg.pad_token_id)
    kw = dict(num_beams=4, max_length=6, min_length=2, disable_fm_index=True, top_m=16)
    jo = jc.constrained_beam_search(
        jcfg, params, DeviceFMIndex.from_host(host, vocab=96), jc.DecodeConfig(**kw),
        jbart.encode(jcfg, params, jnp.asarray(ids), jnp.asarray(mask)), jnp.asarray(mask))
    tids, tmask = torch.as_tensor(ids), torch.as_tensor(mask)
    to = tc.constrained_beam_search(tcfg, tparams,
                                    TorchFMIndex.from_host(host, vocab=96, device="cpu"),
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


@pytest.fixture(scope="module")
def mirror_world():
    """``tests/test_constrained.py``'s world: vocab 60, PRNGKey(1) weights."""
    rng = np.random.default_rng(3)
    V = 60
    docs = [rng.integers(4, V, size=rng.integers(5, 25)).tolist() + [2] for _ in range(30)]
    host = FMIndex()
    host.initialize(docs)
    jcfg, tcfg = jtiny(vocab_size=V), ttiny(vocab_size=V)
    params = jbart.init_params(jax.random.PRNGKey(1), jcfg)
    tparams = tconvert.params_from_jax(jax.device_get(params), tcfg, device="cpu")
    queries = [[0] + rng.integers(4, V, size=6).tolist() + [2],
               [0] + rng.integers(4, V, size=4).tolist() + [2]]
    ids, mask = jg.pad_batch(queries, jcfg.pad_token_id)
    return jcfg, tcfg, params, tparams, host, ids, mask


def test_free_generation_matches_reference_mirror(mirror_world):
    """The ``disable_fm_index`` case of ``tests/test_constrained.py:65-82``:
    the port against the slow mirror of the reference's beam search."""
    jcfg, tcfg, params, tparams, host, ids, mask = mirror_world
    kw = dict(num_beams=3, max_length=5, min_length=0, disable_fm_index=True)
    got = tg.fm_index_generate(tcfg, tparams, TorchFMIndex.from_host(host, vocab=60, device="cpu"),
                               ids, mask, forced_bos_token_id=None, **kw)
    expect = reference_generate(jcfg, params, host, ids, mask, **kw)
    for g, e in zip(got, expect):
        gb, eb = {}, {}
        for hyps, best in ((g, gb), (e, eb)):
            for s, t in hyps:
                best[tuple(t)] = max(s, best.get(tuple(t), -np.inf))
        assert set(gb) == set(eb)
        for key in gb:  # f32 device path vs the mirror's f64 log-softmax
            assert abs(gb[key] - eb[key]) < 5e-3, key


def test_free_generation_topk1_is_greedy():
    """``tests/test_decode_modes.py:69-79`` (its world: vocab 60,
    PRNGKey(2) weights): free generation under the top-1 warper collapses
    every query to one path, and equals JAX's."""
    rng = np.random.default_rng(5)
    V = 60
    docs = [rng.integers(4, V, size=rng.integers(5, 25)).tolist() + [2] for _ in range(30)]
    host = FMIndex()
    host.initialize(docs)
    jcfg, tcfg = jtiny(vocab_size=V), ttiny(vocab_size=V)
    params = jbart.init_params(jax.random.PRNGKey(2), jcfg)
    tparams = tconvert.params_from_jax(jax.device_get(params), tcfg, device="cpu")
    queries = [[0] + rng.integers(4, V, size=5).tolist() + [2] for _ in range(2)]
    ids, mask = jg.pad_batch(queries, jcfg.pad_token_id)
    kw = dict(num_beams=3, max_length=5, min_length=0, forced_bos_token_id=None,
              disable_fm_index=True, topk=1)
    out = tg.fm_index_generate(tcfg, tparams, TorchFMIndex.from_host(host, vocab=V, device="cpu"),
                               ids, mask, **kw)
    for hyps in out:
        assert len({tuple(t) for _, t in hyps if len(t) == 5}) == 1
    _assert_same_hyps(jg.fm_index_generate(jcfg, params, DeviceFMIndex.from_host(host, vocab=V),
                                           ids, mask, **kw), out)


def test_free_generation_ties_order_is_exact_ties(tied):  # noqa: F811
    """Under exact logit ties the flat index of equal scores rises with
    (beam, token): the default order equals ``exact_ties``, in the port and
    in JAX."""
    jcfg, tcfg, params, tparams, host, queries = tied
    ids, mask = jg.pad_batch(queries, jcfg.pad_token_id)
    kw = dict(num_beams=4, max_length=5, min_length=1, forced_bos_token_id=None,
              disable_fm_index=True, top_m=20)
    idx = TorchFMIndex.from_host(host, vocab=96, device="cpu")
    fast = tg.fm_index_generate(tcfg, tparams, idx, ids, mask, **kw)
    ties = tg.fm_index_generate(tcfg, tparams, idx, ids, mask, exact_ties=True, **kw)
    assert _canon(fast) == _canon(ties)
    jidx = DeviceFMIndex.from_host(host, vocab=96)
    _assert_same_hyps(jg.fm_index_generate(jcfg, params, jidx, ids, mask, exact_ties=True, **kw),
                      ties)
    _assert_same_hyps(jg.fm_index_generate(jcfg, params, jidx, ids, mask, **kw), fast)


# ---------------------------------------------------------------- searcher


@pytest.mark.parametrize("pipeline", [True, False])
def test_free_generation_searcher_matches_jax(searchers, pipeline):  # noqa: F811
    """``SEALSearcher(free_generation=True)``: documents and order equal to
    the JAX searcher's, scores within 1e-4 relative (the ungrounded keys
    are dropped by the count filters in both)."""
    js, ts = searchers
    js.pipeline = ts.pipeline = pipeline
    js.free_generation = ts.free_generation = True
    try:
        jres = js.batch_search(QUERIES, k=5)
        tres = ts.batch_search(QUERIES, k=5)
    finally:
        js.free_generation = ts.free_generation = False
    assert any(tres)
    _assert_same_results(jres, tres)


def test_free_generation_searcher_constructs(searchers):  # noqa: F811
    """The knob is accepted at construction (it used to raise), and one
    query's documents equal the JAX searcher's, as in
    ``tests/test_searcher.py:153-160``."""
    js, ts = searchers
    fs = TSearcher(ts.fm_index, ts.tokenizer, ts.model_cfg, ts.params,
                   device_index=ts.device_index, **dict(KNOBS, free_generation=True))
    jfs = JSearcher(js.fm_index, js.tokenizer, js.model_cfg, js.params,
                    **dict(KNOBS, free_generation=True))
    got = fs.search("eating soup with a fork", k=2)
    assert got
    _assert_same_results([jfs.search("eating soup with a fork", k=2)], [got])
