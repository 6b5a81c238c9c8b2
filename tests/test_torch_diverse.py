"""The port's diverse beam groups (``diverse_bs_groups``,
``diverse_bs_penalty``) against ``seal_tpu``'s, on the CPU (the kernels'
plain versions).

Kernel 21's plain version equals ``_select_diverse`` bit for bit (2 and 3
groups, penalties 0, 0.5 and 1e6, both tie orders, EOS-heavy rows, V-wide
rows under a corpus mask), and so does the mirror of its wide route's
top-M schedule on rows crowded for its lemma (one group, one beam a group,
M at its limit of 512); kernel 8's candidate mode equals
``_candidates_general``'s slots with ``_apply_branches`` and
``_dedup_mask``.  Generation equals JAX's (hypotheses equal, scores within
1e-4) over the three layouts and the four candidate routes, with and
without ``exact_ties``, and step by step; the JAX test's diversity
assertion holds; ``SEALSearcher(diverse_bs_groups=2,
diverse_bs_penalty=0.5)`` equals the JAX searcher with the same knobs."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal_tpu.decoding import constrained as jc
from seal_tpu.decoding import generate as jg
from seal_tpu.index.device_index import DeviceFMIndex
from seal_tpu.models import bart as jbart
from seal_tpu.retrieval.searcher import SEALSearcher as JSearcher
from seal_tpu_torch.decoding import constrained as tc
from seal_tpu_torch.decoding import generate as tg
from seal_tpu_torch.kernels import beam_select, diverse_select
from seal_tpu_torch.models import bart as tbart
from seal_tpu_torch.retrieval.searcher import SEALSearcher as TSearcher
from test_decode_modes import _grounded
from test_torch_dense import LAYOUTS, _canon, _port_index
from test_torch_dense_counts import forbid_counts
from test_torch_generate import _assert_same_hyps, _models, _random_corpus
from test_torch_modes import _assert_same_raw, world  # noqa: F401
from test_torch_searcher import KNOBS, QUERIES, _assert_same_results, searchers  # noqa: F401

COMMON = dict(num_beams=4, max_length=6, min_length=1, forced_bos_token_id=None,
              diverse_bs_groups=2, diverse_bs_penalty=0.5)


@pytest.fixture(scope="module")
def models():
    return _models()


def _bits(a, b):
    """Assert two output tuples equal, floats bit for bit."""
    for x, y in zip(a, b):
        x, y = x.numpy(), np.asarray(y)
        if x.dtype == np.float32:
            x, y = x.view(np.int32), y.view(np.int32)
        np.testing.assert_array_equal(x, y.astype(x.dtype))


# -------------------------------------------------------------- kernel 21


def _diverse_rows(rng, B, K, N, wide):
    """Candidate rows with ties, repeats of the earlier picks' tokens, dead
    slots and EOS-heavy rows."""
    cons = np.round(rng.normal(-3, 1, size=(B, K, N)) * 2) / 2
    cons[rng.random((B, K, N)) < 0.3] = jc.NEG_INF
    cons[:, :, 0] = -np.inf
    if wide:
        tokens = np.broadcast_to(np.arange(N, dtype=np.int32), (B, K, N))
        cons[0, :, 2] = 0.0  # EOS leads query 0's rows
    else:
        tokens = rng.integers(0, 9, size=(B, K, N)).astype(np.int32)
        tokens[0, :, :6] = 2  # EOS-heavy
        cons[0, :, :6] = -0.25
    bs = np.round(rng.normal(-1, 1, size=(B, K)) * 2) / 2
    bs[1, 1] = jc.NEG_INF
    return cons.astype(np.float32), tokens, bs.astype(np.float32)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("penalty", [0.0, 0.5, 1e6])
@pytest.mark.parametrize("groups", [2, 3])
def test_diverse_select_plain_matches_jax(groups, penalty, ties):
    """A candidate list ([B, K, N] with its token table)."""
    rng = np.random.default_rng(groups * 10 + int(ties))
    B, K, N, V = 3, 2 * groups, 7, 9
    cons, tokens, bs = _diverse_rows(rng, B, K, N, wide=False)
    cfg = jc.DecodeConfig(num_beams=K, num_groups=groups, diversity_penalty=penalty,
                          exact_ties=ties)
    want = jc._select_diverse(cfg, jnp.asarray(cons) + bs[..., None], jnp.asarray(tokens), K, V)
    t = torch.as_tensor
    got = diverse_select.diverse_select(t(cons), t(tokens), t(bs), groups=groups, penalty=penalty,
                                        eos=2, ties=ties, vocab=V)
    _bits(got, want)


@pytest.mark.parametrize("ties", [False, True])
def test_diverse_select_wide_rows_match_jax(ties):
    """V-wide rows (token = column) under a corpus mask, as step 0 and
    ``exact_mask`` give them."""
    rng = np.random.default_rng(3 + int(ties))
    B, K, V = 2, 6, 40
    cons, tokens, bs = _diverse_rows(rng, B, K, V, wide=True)
    mask = rng.random(V) < 0.6
    mask[2] = True
    cfg = jc.DecodeConfig(num_beams=K, num_groups=3, diversity_penalty=0.5, exact_ties=ties)
    want = jc._select_diverse(cfg, jnp.where(mask, cons, jc.NEG_INF) + bs[..., None],
                              jnp.asarray(tokens), K, V)
    t = torch.as_tensor
    got = diverse_select.diverse_select(t(cons), None, t(bs), groups=3, penalty=0.5, eos=2,
                                        ties=ties, vocab=V, mask=t(mask))
    _bits(got, want)


def _crowded_rows(rng, B, K, V, n_best=6):
    """V-wide rows crowded for the wide route's lemma: every beam's best
    columns are the same few (each earlier pick's token lies among the
    next group's best slots), NEG_INF plateaus, a -inf column, EOS (2)
    among the top and a corpus mask."""
    cons = np.round(rng.normal(-3, 1, size=(B, K, V)) * 2) / 2
    cons[rng.random((B, K, V)) < 0.3] = jc.NEG_INF
    cons[:, :, 0] = -np.inf
    best = rng.permutation(np.arange(3, V))[:n_best]
    cons[:, :, best] = np.round(rng.normal(0, 1, size=(B, 1, n_best)) * 2) / 4
    cons[:, :, 2] = 0.25
    bs = np.round(rng.normal(-1, 1, size=(B, K)) * 2) / 2
    bs[:, 1::3] = jc.NEG_INF
    mask = rng.random(V) < 0.8
    mask[best] = mask[2] = True
    return cons.astype(np.float32), bs.astype(np.float32), mask


# (B, K, V, groups) of the top-M mirror's cases: three groups, gs = 1 (G =
# K), one group
TOPM_CASES = {"g3": (3, 6, 40, 3), "gs1": (2, 5, 30, 5), "g1": (3, 4, 30, 1)}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("penalty", [0.0, 0.5, 1e6])
@pytest.mark.parametrize("case", sorted(TOPM_CASES))
def test_diverse_topm_mirror_matches_jax(case, penalty, ties, masked):
    """Kernel 21's wide route as scheduled on the card (each group's
    unpenalized top M, then the penalty, the sort and the finish) equals
    ``_select_diverse`` and the plain version bit for bit on crowded
    V-wide rows; no group is short of unpenalized survivors."""
    B, K, V, G = TOPM_CASES[case]
    rng = np.random.default_rng(len(case) * 7 + int(ties) + 2 * int(masked))
    cons, bs, mask = _crowded_rows(rng, B, K, V)
    mask = mask if masked else np.ones(V, bool)
    cfg = jc.DecodeConfig(num_beams=K, num_groups=G, diversity_penalty=penalty, exact_ties=ties)
    toks = np.broadcast_to(np.arange(V, dtype=np.int32), (B, K, V))
    want = jc._select_diverse(cfg, jnp.where(mask, cons, jc.NEG_INF) + bs[..., None],
                              jnp.asarray(toks), K, V)
    t = torch.as_tensor
    kw = dict(groups=G, penalty=penalty, eos=2, ties=ties, vocab=V,
              mask=t(mask) if masked else None)
    got, short = diverse_select.diverse_select_topm_plain(t(cons), t(bs), **kw)
    assert short == 0
    _bits(got, want)
    _bits(got, diverse_select.diverse_select_plain(t(cons), None, t(bs), **kw))


@pytest.mark.parametrize("groups,M", [(128, 512), (129, 516)])
def test_diverse_topm_mirror_at_its_limit(groups, M):
    """Two beams a group: M = 4 + 4 (G - 1) reaches the wide route's 512 at
    128 groups (past it, 129 groups take the chunked route on the card);
    the mirror still equals the plain version, with every group's picks
    among the best columns."""
    rng = np.random.default_rng(groups)
    B, K, V = 2, 2 * groups, 300
    cons, bs, mask = _crowded_rows(rng, B, K, V)
    t = torch.as_tensor
    kw = dict(groups=groups, penalty=0.5, eos=2, mask=t(mask))
    assert diverse_select.wide_survivors(K, groups, 0.5) == M
    assert diverse_select.wide_survivors(K, groups, 0.0) == 4
    got, short = diverse_select.diverse_select_topm_plain(t(cons), t(bs), **kw)
    assert short == 0
    _bits(got, diverse_select.diverse_select_plain(t(cons), None, t(bs), **kw))


def test_diverse_topm_mirror_short_survivors_flagged():
    """The proof counter's rule: with M cut to 2gs (a route without the
    lemma's margin) the mirror loses picks on crowded rows and counts the
    groups short of unpenalized survivors."""
    rng = np.random.default_rng(11)
    cons, bs, mask = _crowded_rows(rng, 3, 6, 40)
    t = torch.as_tensor
    kw = dict(groups=3, penalty=0.5, eos=2, mask=t(mask))
    want = diverse_select.diverse_select_plain(t(cons), None, t(bs), **kw)
    full = diverse_select.wide_survivors
    try:
        diverse_select.wide_survivors = lambda K, G, p: 2 * (K // G)
        got, short = diverse_select.diverse_select_topm_plain(t(cons), t(bs), **kw)
    finally:
        diverse_select.wide_survivors = full
    assert short > 0
    assert any(not torch.equal(a, b) for a, b in zip(got, want))


# ------------------------------------------------- kernel 8's candidate mode


@pytest.mark.parametrize("route", ["proposal", "speculative"])
@pytest.mark.parametrize("branches", [False, True])
def test_beam_candidates_plain_matches_jax(route, branches):
    """Kernel 8's candidate mode equals ``_candidates_general``'s
    [buffer, window, EOS, PAD] slots (the proposal buffer PAD-filled where
    unfilled, :808-809; the speculative round as it is), ``_apply_branches``
    and ``_dedup_mask`` (:1394-1399), bit for bit."""
    rng = np.random.default_rng(int(branches) + 2 * (route == "proposal"))
    B, K, V, m, w = 3, 4, 40, 10, 6
    eos, pad = 2, 1
    lp = np.round(rng.normal(-3, 1.5, size=(B * K, V)), 1).astype(np.float32)
    lp[::2, pad] = -np.inf
    top_tok = np.stack([rng.permutation(V)[:m] for _ in range(B * K)]).astype(np.int32)
    top_tok = top_tok.reshape(B, K, m)
    top_lp = np.take_along_axis(lp, top_tok.reshape(B * K, m), -1).reshape(B, K, m)
    top_ok = rng.random((B, K, m)) < 0.5
    win_valid = rng.random((B, K, w)) < 0.7
    win_tok = np.where(win_valid, rng.integers(0, 14, size=(B, K, w)), pad).astype(np.int32)
    win_tok[..., 0] = np.where(win_valid[..., 0], top_tok[..., 0], pad)  # a repeat
    win_lp = np.take_along_axis(lp, win_tok.reshape(B * K, w), -1).reshape(B, K, w)
    eos_ok = rng.random((B, K, 1)) < 0.5
    prev_count = rng.integers(0, 4, size=(B, K)).astype(np.int32)
    finished = rng.random((B, K)) < (0.3 if branches else 0.0)
    opts = dict(stop_at_count=2 if branches else 0, always_allow_eos=branches)
    cfg = jc.DecodeConfig(num_beams=K, eos_token_id=eos, pad_token_id=pad, **opts)
    buf_tok, buf_lp = top_tok, top_lp
    if route == "proposal":  # unfilled buffer slots are PAD at PAD's log-prob
        buf_tok = np.where(top_ok, top_tok, pad)
        buf_lp = np.where(top_ok, top_lp, lp[:, pad].reshape(B, K, 1))
    tokens = np.concatenate([buf_tok, win_tok, np.full((B, K, 1), eos), np.full((B, K, 1), pad)],
                            -1).astype(np.int32)
    fm_valid = np.concatenate([top_ok, win_valid, eos_ok, np.zeros((B, K, 1), bool)], -1)
    cand_lp = np.concatenate([buf_lp, win_lp, lp[:, eos].reshape(B, K, 1),
                              lp[:, pad].reshape(B, K, 1)], -1)
    tok_j, allowed, clp = jc._apply_branches(cfg, jnp.asarray(tokens), jnp.asarray(fm_valid),
                                             jnp.asarray(cand_lp), jnp.asarray(prev_count),
                                             jnp.asarray(finished))
    cons = jnp.where(allowed & jc._dedup_mask(tok_j), clp, jc.NEG_INF)
    t = torch.as_tensor
    got = beam_select.beam_candidates(
        (t(top_tok), t(top_lp), t(top_ok)), m, t(win_tok), t(win_valid), t(win_lp), t(eos_ok),
        t(lp), t(prev_count), t(finished), eos=eos, pad=pad, keep_invalid=route == "speculative",
        **opts)
    _bits(got, (tok_j, cons, clp))


def test_beam_candidates_without_a_buffer_is_all_pad():
    """No proposal round ran (every beam exempt): ``skip_proposals``'
    PAD-filled buffer (:766-771)."""
    B, K, n_buf, w, V = 2, 3, 4, 2, 12
    lp = torch.log_softmax(torch.arange(B * K * V, dtype=torch.float32).reshape(B * K, V), -1)
    win_tok = torch.full((B, K, w), 5, dtype=torch.int32)
    win_lp = lp[:, 5].reshape(B, K, 1).expand(B, K, w).contiguous()
    tok, cons, clp = beam_select.beam_candidates(
        None, n_buf, win_tok, torch.ones((B, K, w), dtype=torch.bool), win_lp,
        torch.zeros((B, K, 1), dtype=torch.bool), lp, torch.zeros((B, K), dtype=torch.int32),
        torch.zeros((B, K), dtype=torch.bool), eos=2, pad=1)
    assert tok.shape == (B, K, n_buf + w + 2)
    assert (tok[..., :n_buf] == 1).all() and (cons[..., :n_buf] == tc.NEG_INF).all()
    torch.testing.assert_close(clp[..., :n_buf], lp[:, 1].reshape(B, K, 1).expand(B, K, n_buf))
    assert (cons[..., n_buf] == win_lp[..., 0]).all() and (cons[..., n_buf + 1:] == tc.NEG_INF).all()


# ------------------------------------------------------------- generation


ROUTES = {
    "proposal": dict(window=4, exact_chunk=4),
    "exact_mask": dict(exact_mask=True),
    "speculative": dict(speculative=True, top_m=8, window=4),
    "disable_fm_index": dict(disable_fm_index=True, top_m=8),
}


@functools.lru_cache(maxsize=None)
def _jax_hyps(route, ties):
    jcfg, _, params, _ = _models()
    host, queries = _random_corpus(6)
    return jg.fm_index_generate(jcfg, params, DeviceFMIndex.from_host(host, vocab=96), queries,
                                exact_ties=ties, **COMMON, **ROUTES[route])


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_diverse_generation_matches_jax(models, monkeypatch, layout, route, ties):
    """Two groups at penalty 0.5 on every layout and route, in both tie
    orders: JAX's hypotheses, scores within 1e-4 (``exact_mask`` with
    every entry to the count vectors raising: it reads the count mask)."""
    _, tcfg, _, tparams = models
    if route == "exact_mask":
        forbid_counts(monkeypatch)
    host, queries = _random_corpus(6)
    th = tg.fm_index_generate(tcfg, tparams, _port_index(host, layout), queries, exact_ties=ties,
                              **COMMON, **ROUTES[route])
    assert sum(map(len, th)) > 0
    _assert_same_hyps(_jax_hyps(route, ties), th)


def test_diverse_step_outputs_match_jax(models):
    """Every candidate of every step at three groups, with a stop count and
    ``always_allow_eos``: JAX's raw outputs (the penalized scores in
    ``cand_scores``)."""
    jcfg, tcfg, params, tparams = models
    host, queries = _random_corpus(7)
    ids, mask = jg.pad_batch(queries, jcfg.pad_token_id)
    kw = dict(num_beams=6, max_length=6, min_length=2, num_groups=3, diversity_penalty=0.5,
              window=4, stop_at_count=2, always_allow_eos=True)
    jo = jc.constrained_beam_search(
        jcfg, params, DeviceFMIndex.from_host(host, vocab=96), jc.DecodeConfig(**kw),
        jbart.encode(jcfg, params, jnp.asarray(ids), jnp.asarray(mask)), jnp.asarray(mask))
    tids, tmask = torch.as_tensor(ids), torch.as_tensor(mask)
    to = tc.constrained_beam_search(tcfg, tparams, _port_index(host, "psi"), tc.DecodeConfig(**kw),
                                    tbart.encode(tcfg, tparams, tids, tmask), tmask)
    _assert_same_raw(jo, to)


def test_diverse_groups_produce_diverse_beams(world):  # noqa: F811
    """``tests/test_decode_modes.py:116-141`` on the port: a huge penalty
    gives at least as many distinct first tokens as none, every key stays
    grounded, and the proposal route equals ``exact_mask``."""
    _, tcfg, _, tparams, _, tdev, host, ids, mask = world
    common = dict(num_beams=4, max_length=6, min_length=0, forced_bos_token_id=None,
                  exact_mask=True)
    plain = tg.fm_index_generate(tcfg, tparams, tdev, ids, mask, diverse_bs_groups=2,
                                 diverse_bs_penalty=0.0, **common)
    diverse = tg.fm_index_generate(tcfg, tparams, tdev, ids, mask, diverse_bs_groups=2,
                                   diverse_bs_penalty=1e6, **common)
    for b in range(2):
        def first_tokens(hyps):
            return {t[1] for _, t in hyps if len(t) >= 2}

        assert len(first_tokens(diverse[b])) >= len(first_tokens(plain[b]))
    for hyps in diverse:
        for _, toks in hyps:
            assert _grounded(host, toks), toks
    proposal = tg.fm_index_generate(tcfg, tparams, tdev, ids, mask, diverse_bs_groups=2,
                                    diverse_bs_penalty=1e6, **dict(common, exact_mask=False))
    assert _canon(proposal) == _canon(diverse)


def test_single_group_penalty_is_the_beam_search(models):
    """One group with a penalty: accepted, no effect (the fast path)."""
    _, tcfg, _, tparams = models
    host, queries = _random_corpus(1)
    idx = _port_index(host, "psi")
    kw = dict(COMMON, diverse_bs_groups=1)
    assert _canon(tg.fm_index_generate(tcfg, tparams, idx, queries, **kw)) == _canon(
        tg.fm_index_generate(tcfg, tparams, idx, queries, **dict(kw, diverse_bs_penalty=0.0)))


# ---------------------------------------------------------------- searcher


@pytest.mark.parametrize("pipeline", [True, False])
def test_diverse_searcher_matches_jax(searchers, pipeline):  # noqa: F811
    """``SEALSearcher(diverse_bs_groups=2, diverse_bs_penalty=0.5)``: every
    body and title decode in two groups; documents and scores equal the JAX
    searcher's with the same knobs."""
    js, ts = searchers
    knobs = dict(KNOBS, diverse_bs_groups=2, diverse_bs_penalty=0.5, pipeline=pipeline)
    jm = JSearcher(js.fm_index, js.tokenizer, js.model_cfg, js.params, **knobs)
    tm = TSearcher(ts.fm_index, ts.tokenizer, ts.model_cfg, ts.params,
                   device_index=ts.device_index, **knobs)
    tres = tm.batch_search(QUERIES, k=5)
    assert all(tres)
    _assert_same_results(jm.batch_search(QUERIES, k=5), tres)
