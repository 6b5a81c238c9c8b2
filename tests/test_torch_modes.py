"""The port's deterministic decode modes against ``seal_tpu``'s, on the CPU
(the kernels' plain versions): ``speculative``, the top-k warper
(``topk``), ``forced_bos_token_id`` and ``adjust_logits_fn``.

Speculative generation equals JAX's on the Psi, compact and hybrid layouts,
raw outputs included (the candidates of masked slots too), at a small
``top_m`` and window and with ``exact_ties``; at ``top_m`` = vocab it
equals the dense mode.  ``topk`` equals JAX's on the fast, dense, free and
speculative paths; forced BOS on the fast and dense paths; a torch
ban-even-tokens hook equals JAX's, and a hook that reads ``cur_len`` gets
the same columns as a Python ``int``.  Kernel 8's speculative mode and
kernel 4's threshold equal the JAX ops bit for bit / to f32 rounding.
``DecodeConfig`` accepts what JAX's accepts and raises its errors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal_tpu.decoding import constrained as jc
from seal_tpu.decoding import generate as jg
from seal_tpu.index import FMIndex
from seal_tpu.index.device_index import DeviceFMIndex
from seal_tpu.models import bart as jbart
from seal_tpu.models.config import bart_tiny as jtiny
from seal_tpu_torch.decoding import constrained as tc
from seal_tpu_torch.decoding import generate as tg
from seal_tpu_torch.index.device_index import TorchFMIndex
from seal_tpu_torch.kernels import beam_select
from seal_tpu_torch.models import bart as tbart
from seal_tpu_torch.models import convert as tconvert
from seal_tpu_torch.models.config import bart_tiny as ttiny
from test_decode_modes import _ban_even_tokens
from test_torch_dense import LAYOUTS, _canon, _port_index
from test_torch_generate import _assert_same_hyps, _models, _random_corpus, _title_corpus

COMMON = dict(num_beams=4, max_length=6, min_length=1, forced_bos_token_id=None)


@pytest.fixture(scope="module")
def models():
    return _models()


@pytest.fixture(scope="module")
def world():
    """``tests/test_decode_modes.py``'s world: vocab 60, PRNGKey(2) weights."""
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
    return (jcfg, tcfg, params, tparams, DeviceFMIndex.from_host(host, vocab=V),
            TorchFMIndex.from_host(host, vocab=V, device="cpu"), host, ids, mask)


def _raw(models, host, queries, layout="psi", **kw):
    """Both packages' raw ``BeamSearchOutput`` for one config."""
    jcfg, tcfg, params, tparams = models
    ids, mask = jg.pad_batch(queries, jcfg.pad_token_id)
    jo = jc.constrained_beam_search(
        jcfg, params, DeviceFMIndex.from_host(host, vocab=96), jc.DecodeConfig(**kw),
        jbart.encode(jcfg, params, jnp.asarray(ids), jnp.asarray(mask)), jnp.asarray(mask))
    tids, tmask = torch.as_tensor(ids), torch.as_tensor(mask)
    to = tc.constrained_beam_search(tcfg, tparams, _port_index(host, layout), tc.DecodeConfig(**kw),
                                    tbart.encode(tcfg, tparams, tids, tmask), tmask)
    return jo, to


def _assert_same_raw(jo, to):
    for f in ("cand_tokens", "cand_parents", "cand_finite", "sel_tokens", "sel_parents",
              "final_tokens", "final_valid", "fallback_steps"):
        np.testing.assert_array_equal(getattr(to, f).numpy(), np.asarray(getattr(jo, f)), f)
    for f in ("cand_scores", "final_scores"):
        a, b = np.asarray(getattr(jo, f)), getattr(to, f).numpy()
        fin = a > tc.NEG_INF / 2
        np.testing.assert_array_equal(fin, b > tc.NEG_INF / 2)
        np.testing.assert_allclose(b[fin], a[fin], atol=1e-4, rtol=0)


# ------------------------------------------------------------- speculative


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("seed,stop", [(0, 0), (2, 2)])
def test_speculative_raw_outputs_match_jax(models, layout, seed, stop):
    """``tests/test_constrained.py:110-135``'s small budget (``top_m`` 8,
    window 4): every candidate of every step equals JAX's, masked ones
    included, on each layout."""
    host, queries = _random_corpus(seed)
    kw = dict(num_beams=4, max_length=7, min_length=2, speculative=True, top_m=8, window=4,
              stop_at_count=stop)
    jo, to = _raw(models, host, queries, layout, **kw)
    assert int(to.fallback_steps) == 0
    _assert_same_raw(jo, to)


@pytest.mark.parametrize("seed", [1, 3])
def test_speculative_generate_matches_jax(models, seed):
    """Through ``fm_index_generate`` (the auto window is the speculative
    rule's 128 rows), also with ``exact_ties``, ``always_allow_eos`` and a
    forced prefix with a custom EOS (the title decode)."""
    jcfg, tcfg, params, tparams = models
    host, queries = _random_corpus(seed)
    ids, mask = jg.pad_batch(queries, jcfg.pad_token_id)
    jidx = DeviceFMIndex.from_host(host, vocab=96)
    for kw in (dict(COMMON, top_m=8), dict(COMMON, top_m=8, exact_ties=True, window=4),
               dict(COMMON, top_m=6, window=4, always_allow_eos=True)):
        jh = jg.fm_index_generate(jcfg, params, jidx, ids, mask, speculative=True, **kw)
        th = tg.fm_index_generate(tcfg, tparams, _port_index(host, "psi"), ids, mask,
                                  speculative=True, **kw)
        assert sum(len(h) for h in th) > 0
        _assert_same_hyps(jh, th)
    host, queries = _title_corpus(seed)
    kw = dict(num_beams=4, max_length=7, min_length=1, eos_token_id=50, force_decoding_from=[2],
              forced_bos_token_id=None, speculative=True, top_m=8, window=4)
    _assert_same_hyps(
        jg.fm_index_generate(jcfg, params, DeviceFMIndex.from_host(host, vocab=96), queries, **kw),
        tg.fm_index_generate(tcfg, tparams, _port_index(host, "psi"), queries, **kw))


def test_speculative_full_budget_equals_dense(models):
    """At ``top_m`` = vocab the proposal round holds every token: the
    speculative mode equals the dense mode (``tests/test_constrained.py:99``)."""
    _, tcfg, _, tparams = models
    host, queries = _random_corpus(4)
    for layout in LAYOUTS:
        idx = _port_index(host, layout)
        spec = tg.fm_index_generate(tcfg, tparams, idx, queries, speculative=True, top_m=96,
                                    window=16, **COMMON)
        dense = tg.fm_index_generate(tcfg, tparams, idx, queries, exact_mask=True, **COMMON)
        assert _canon(spec) == _canon(dense), layout


@pytest.mark.parametrize("ties,branches", [(False, False), (True, False), (False, True),
                                           (True, True)])
def test_beam_select_keep_invalid_matches_jax(ties, branches):
    """Kernel 8's speculative mode (plain) equals the JAX candidate build of
    ``_candidates_general`` (:359-367), the branches, ``_dedup_mask`` and
    ``_select``, bit for bit; proposals repeat window tokens and fail
    membership."""
    rng = np.random.default_rng(int(ties) + 2 * int(branches))
    B, K, V, m, w = 3, 4, 40, 10, 6
    eos, pad = 2, 1
    lp = np.round(rng.normal(-3, 1.5, size=(B * K, V)), 1).astype(np.float32)
    lp[:, 9] = -0.0
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
    bs = np.round(rng.normal(-2, 1, size=(B, K)), 1).astype(np.float32)
    bs[0, 3] = jc.NEG_INF
    opts = dict(stop_at_count=2 if branches else 0, always_allow_eos=branches)
    cfg = jc.DecodeConfig(num_beams=K, exact_ties=ties, eos_token_id=eos, pad_token_id=pad, **opts)
    tokens = np.concatenate([top_tok, win_tok, np.full((B, K, 1), eos), np.full((B, K, 1), pad)],
                            -1).astype(np.int32)
    fm_valid = np.concatenate([top_ok, win_valid, eos_ok, np.zeros((B, K, 1), bool)], -1)
    cand_lp = np.concatenate([top_lp, win_lp, lp[:, eos].reshape(B, K, 1),
                              lp[:, pad].reshape(B, K, 1)], -1)
    tok_j, allowed, clp = jc._apply_branches(cfg, jnp.asarray(tokens), jnp.asarray(fm_valid),
                                             jnp.asarray(cand_lp), jnp.asarray(prev_count),
                                             jnp.asarray(finished))
    cons = jnp.where(allowed & jc._dedup_mask(tok_j), clp, jc.NEG_INF)
    want = jc._select(cfg, cons + bs[..., None], clp + bs[..., None], tok_j, K, V)
    t = torch.as_tensor
    got, _ = beam_select.beam_select(
        (t(top_tok), t(top_lp), t(top_ok)), m, t(win_tok), t(win_valid), t(win_lp), t(eos_ok),
        t(lp), t(prev_count), t(finished), t(bs), K=K, eos=eos, pad=pad, ties=ties,
        keep_invalid=True, **opts)
    for a, b in zip(got, want):
        a, b = a.numpy(), np.asarray(b)
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b.astype(a.dtype))


# ------------------------------------------------------------------ top-k


@pytest.mark.parametrize("path", ["fast", "dense", "free", "speculative"])
@pytest.mark.parametrize("topk", [1, 3])
def test_topk_warper_matches_jax(models, topk, path):
    jcfg, tcfg, params, tparams = models
    host, queries = _random_corpus(topk)
    mode = {"fast": dict(window=4, exact_chunk=4), "dense": dict(exact_mask=True),
            "free": dict(disable_fm_index=True), "speculative": dict(speculative=True, top_m=8)}
    kw = dict(COMMON, topk=topk, **mode[path])
    ids, mask = jg.pad_batch(queries, jcfg.pad_token_id)
    jh = jg.fm_index_generate(jcfg, params, DeviceFMIndex.from_host(host, vocab=96), ids, mask,
                              **kw)
    th = tg.fm_index_generate(tcfg, tparams, _port_index(host, "psi"), ids, mask, **kw)
    assert sum(len(h) for h in th) > 0
    _assert_same_hyps(jh, th)


@pytest.mark.parametrize("ban", [True, False])
@pytest.mark.parametrize("topk", [1, 7, 40])
def test_threshold_log_softmax_matches_jax_warper(topk, ban):
    """The warper's masked log-softmax (``topk_log_softmax``'s plain version
    through the step's ``_log_softmax``) against JAX's warper, log-softmax
    and min-length ban, with ties at the k-th value, the SEAL bias's -inf,
    a row whose k-th value is -inf (its -inf columns survive), a row of
    signed zeros at the k-th place, and the ban on and off."""
    rng = np.random.default_rng(topk)
    logits = np.round(rng.normal(size=(9, 300)) * 3, 1).astype(np.float32)
    logits[:, 1] = -np.inf
    logits[2, :50] = 4.0
    logits[3, 5:] = -np.inf  # five finite values: past them the k-th is -inf
    logits[4, ::2] = 0.0
    logits[4, 1::2] = -0.0
    min_length = 3 if ban else 0
    jcfg = jc.DecodeConfig(topk=topk, min_length=min_length)
    want = np.asarray(jc._apply_min_length(
        jc._log_softmax(jc._apply_topk_warper(jnp.asarray(logits), jcfg)), 2, jcfg))
    got = tc._log_softmax(torch.as_tensor(logits), 2,
                          tc.DecodeConfig(topk=topk, min_length=min_length))
    masked = want <= jc.NEG_INF / 2
    np.testing.assert_array_equal(got.numpy() <= tc.NEG_INF / 2, masked)
    np.testing.assert_allclose(got.numpy()[~masked], want[~masked], atol=1e-5, rtol=0)
    assert (got.numpy()[:, 2] == tc.NEG_INF).all() == ban  # the min-length ban
    if topk == 40:
        assert np.isneginf(got.numpy()[3, 5:]).all()  # T = -inf: -inf stays -inf


# ------------------------------------------------------------- forced BOS


@pytest.mark.parametrize("path", ["fast", "dense"])
def test_forced_bos_matches_jax(models, path):
    """``forced_bos_token_id=0`` (``tests/test_constrained.py:138-147``):
    every hypothesis has BOS in column 1, raw outputs equal JAX's (one step
    fewer), and the fast path equals ``force_full`` and the dense mode."""
    host, queries = _random_corpus(6)
    kw = dict(num_beams=3, max_length=6, min_length=3, forced_bos_token_id=0,
              exact_mask=path == "dense")
    jo, to = _raw(models, host, queries, **kw)
    assert to.cand_tokens.shape[0] == 4
    _assert_same_raw(jo, to)
    _, tcfg, _, tparams = models
    idx = _port_index(host, "psi")
    gen = dict(kw, exact_mask=False, window=4, exact_chunk=4)
    hyps = tg.fm_index_generate(tcfg, tparams, idx, queries, **gen)
    assert all(t[:2] == [2, 0] for h in hyps for _, t in h) and sum(map(len, hyps)) > 0
    full = tg.fm_index_generate(tcfg, tparams, idx, queries, force_full=True, **gen)
    dense = tg.fm_index_generate(tcfg, tparams, idx, queries, **dict(gen, exact_mask=True))
    assert _canon(hyps) == _canon(full) == _canon(dense)


def test_forced_bos_with_hook_topk_and_free(models):
    """Forced BOS beside the other modes: the BOS step takes the hook only
    (no ban, no warper), and every later step all of them."""
    jcfg, tcfg, params, tparams = models
    host, queries = _random_corpus(7)
    for extra in (dict(topk=5), dict(disable_fm_index=True, topk=5),
                  dict(speculative=True, top_m=8, window=4)):
        kw = dict(num_beams=3, max_length=6, min_length=4, forced_bos_token_id=0,
                  adjust_logits_fn=_ban_even_tokens, **extra)
        jh = jg.fm_index_generate(jcfg, params, DeviceFMIndex.from_host(host, vocab=96), queries,
                                  **kw)
        th = tg.fm_index_generate(tcfg, tparams, _port_index(host, "psi"), queries,
                                  **dict(kw, adjust_logits_fn=_ban_even_torch))
        _assert_same_hyps(jh, th)


# ---------------------------------------------------------- adjust_logits_fn


def _ban_even_torch(logits, cur_len):
    """The port's ``_ban_even_tokens``: even ids from 4 up get -inf."""
    del cur_len
    v = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where((v % 2 == 0) & (v >= 4), float("-inf"), logits)


def test_adjust_logits_hook_matches_jax(world):
    """``tests/test_decode_modes.py:82-113`` on the port: the torch hook's
    hypotheses equal JAX's with ``_ban_even_tokens``, the fast path equals
    the dense mode, and the hook changes the result."""
    jcfg, tcfg, params, tparams, jdev, tdev, host, ids, mask = world
    kw = dict(num_beams=4, max_length=6, min_length=0, forced_bos_token_id=None)
    out = tg.fm_index_generate(tcfg, tparams, tdev, ids, mask, adjust_logits_fn=_ban_even_torch,
                               exact_mask=True, **kw)
    fast = tg.fm_index_generate(tcfg, tparams, tdev, ids, mask, adjust_logits_fn=_ban_even_torch,
                                **kw)
    assert _canon(out) == _canon(fast)
    assert _canon(out) != _canon(tg.fm_index_generate(tcfg, tparams, tdev, ids, mask, **kw))
    for hyps in out:
        assert hyps
        for _, toks in hyps:
            assert all(t < 4 or t % 2 == 1 for t in toks[1:]), toks
    _assert_same_hyps(jg.fm_index_generate(jcfg, params, jdev, ids, mask,
                                           adjust_logits_fn=_ban_even_tokens, **kw), fast)


def _ban_by_cur_len_jax(logits, cur_len):
    v = jnp.arange(logits.shape[-1])
    return jnp.where((v == 10 + cur_len) | (v == 30 - cur_len), -jnp.inf, logits)


SEEN = []


def _ban_by_cur_len_torch(logits, cur_len):
    SEEN.append(cur_len)
    v = torch.arange(logits.shape[-1])
    return torch.where((v == 10 + cur_len) | (v == 30 - cur_len), float("-inf"), logits)


@pytest.mark.parametrize("bos", [None, 0])
def test_adjust_logits_hook_reads_cur_len(world, bos):
    """A hook that reads ``cur_len`` (a traced int32 in JAX, a Python ``int``
    here): the same columns as JAX's, one call per decode step with the
    column its token will fill (1 for the BOS step)."""
    jcfg, tcfg, params, tparams, jdev, tdev, host, ids, mask = world
    kw = dict(num_beams=4, max_length=7, min_length=0, forced_bos_token_id=bos)
    SEEN.clear()
    th = tg.fm_index_generate(tcfg, tparams, tdev, ids, mask,
                              adjust_logits_fn=_ban_by_cur_len_torch, **kw)
    assert all(type(c) is int for c in SEEN)
    assert SEEN == list(range(1, 7))
    _assert_same_hyps(jg.fm_index_generate(jcfg, params, jdev, ids, mask,
                                           adjust_logits_fn=_ban_by_cur_len_jax, **kw), th)


# --------------------------------------------------------------- the config


def test_decode_config_validation_matches_jax():
    """``DecodeConfig`` accepts what JAX's accepts (sampling, groups, a lone
    penalty) and raises JAX's two ``ValueError``s."""
    for kw in (dict(sample=True), dict(num_beams=4, num_groups=2), dict(diversity_penalty=1.0),
               dict(num_beams=6, num_groups=3, diversity_penalty=0.5)):
        t, j = tc.DecodeConfig(**kw), jc.DecodeConfig(**kw)
        assert (t.group_size, t.sample, t.num_groups) == (j.group_size, j.sample, j.num_groups)
    for kw in (dict(num_beams=5, num_groups=2), dict(sample=True, num_groups=2, num_beams=4)):
        with pytest.raises(ValueError):
            jc.DecodeConfig(**kw)
        with pytest.raises(ValueError):
            tc.DecodeConfig(**kw)
    for kw in (dict(max_length=6), dict(max_length=6, forced_bos_token_id=0),
               dict(max_length=1, forced_bos_token_id=0)):
        assert tc.DecodeConfig(**kw).num_steps == jc.DecodeConfig(**kw).num_steps


def test_resolve_window_follows_jax():
    for window in (0, 16):
        for beams in (4, 15, 32):
            for spec in (False, True):
                assert tc.resolve_window(window, beams, spec) == jc.resolve_window(window, beams,
                                                                                   spec)
