"""The plain versions of the decode step's kernels against ``seal_tpu``:

* kernel 8 ``merge`` through ``_exact_proposals`` (round 0, the skipped
  branch, and the proven loop's later rounds), ``select`` against
  ``_select`` . ``_dedup_mask`` . ``_apply_branches`` with the soundness
  flag, and step 0's epilogue after the row top-k -- integers equal,
  floats bit for bit, on rows with signed zeros, exact ties, duplicate
  tokens, dead beams, finished and stop-triggered beams, ``always_allow_eos``
  and fewer than K non-EOS candidates; the merge and the selection in the
  ``exact_ties`` order too (kernel 8's ties mode);
* kernels 9-11: the grouped cross-attention over padded encoder positions
  and ``decode_step`` through the beam search's ping-pong cache within
  1e-4 of JAX (f32 sums in another order), ``reorder_cache`` exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal_tpu.decoding import constrained as jc
from seal_tpu.index.device_index import DeviceFMIndex
from seal_tpu.models import bart as jbart
from seal_tpu.models.config import bart_tiny as jtiny
from seal_tpu_torch.decoding import constrained as tc
from seal_tpu_torch.index.device_index import TorchFMIndex
from seal_tpu_torch.index.fm_index import FMIndex
from seal_tpu_torch.kernels import beam_select as k8
from seal_tpu_torch.kernels import decode_attention as k910
from seal_tpu_torch.kernels.row_topk import row_topk_plain
from seal_tpu_torch.models import bart as tbart
from seal_tpu_torch.models import convert as tconvert
from seal_tpu_torch.models.config import bart_tiny as ttiny

NEG_INF = tc.NEG_INF
EOS, PAD = 2, 1
TOL = dict(atol=1e-4, rtol=1e-4)


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _assert_equal(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if want.dtype == np.float32:
        np.testing.assert_array_equal(_bits(got), _bits(want), what)
    else:
        np.testing.assert_array_equal(got, want.astype(got.dtype), what)


def _lp(rng, rows, V, step=0.25):
    """Log-prob-like rows rounded to ``step`` (ties), with +0.0 and -0.0,
    a -inf PAD column in some rows and NEG_INF entries."""
    lp = (np.round(rng.normal(-4, 2, size=(rows, V)) / step) * step).astype(np.float32)
    lp[:, 5] = 0.0
    lp[::2, 6] = -0.0
    lp[1::2, 6] = 0.0
    lp[::3, PAD] = -np.inf
    lp[1, 7:10] = NEG_INF
    return lp


# ------------------------------------------------------ kernel 8: merge


def _index(seed, V=96):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(4, 40, size=rng.integers(5, 30)).tolist() + [2] for _ in range(40)]
    docs += [[10, 11] * 30 + [2] for _ in range(6)]  # a large interval, few continuations
    host = FMIndex()
    host.initialize(docs)
    return host, jc.SingleIndexOps(DeviceFMIndex.from_host(host, vocab=V)), \
        tc.SingleIndexOps(TorchFMIndex.from_host(host, vocab=V, device="cpu"))


def _ranges(host, rng, B, K):
    N = host.size()
    toks = [int(t) for t in rng.integers(4, 40, size=B * K)]
    lo = np.array([host.get_range([t])[0] for t in toks], np.int32)
    hi = np.array([host.get_range([t])[1] for t in toks], np.int32)
    lo[0], hi[0] = 0, N  # the full range
    lo[1], hi[1] = host.get_range([10])
    lo[2], hi[2] = 7, 7  # empty
    return lo.reshape(B, K), hi.reshape(B, K)


def _finish(buf, lp, B, K, n_buf):
    """The buffer as the JAX function returns it: unfilled slots are PAD
    at PAD's log-prob (the port leaves that to the selection)."""
    pad_lp = lp[:, PAD].reshape(B, K, 1)
    if buf is None:
        return (np.full((B, K, n_buf), PAD, np.int32),
                np.broadcast_to(pad_lp, (B, K, n_buf)), np.zeros((B, K, n_buf), bool))
    tok, blp, valid = (np.asarray(t) for t in buf)
    return np.where(valid, tok, PAD), np.where(valid, blp, pad_lp), valid


def _proposals(seed, window, chunk, stop_at_count, round0_only, V=96, B=2, K=4, averse=False,
               ties=False):
    host, jops, tops = _index(seed, V)
    rng = np.random.default_rng(seed)
    lo, hi = _ranges(host, rng, B, K)
    lp = _lp(rng, B * K, V)
    if averse:  # every LM-preferred token invalid: the slab floods the buffer
        lp[:, 40:] = 0.0
    prev_count = (hi - lo).astype(np.int32)
    finished = np.zeros((B, K), bool)
    finished[1, 1] = True
    jcfg = jc.DecodeConfig(num_beams=K, window=window, exact_chunk=chunk,
                           stop_at_count=stop_at_count, exact_ties=ties)
    tcfg = tc.DecodeConfig(num_beams=K, window=window, exact_chunk=chunk,
                           stop_at_count=stop_at_count, exact_ties=ties)
    eos_tok = np.full((B, K, 1), EOS, np.int32)
    want = jc._exact_proposals(jops, jcfg, jnp.asarray(lp), jnp.asarray(lo), jnp.asarray(hi),
                               jnp.asarray(prev_count), jnp.asarray(finished),
                               jnp.asarray(lp[:, PAD].reshape(B, K, 1)), jnp.asarray(eos_tok),
                               round0_only=round0_only)
    # the port gathers the step's window and round 0's slab in one call
    # (``_step_window``) and hands the slab and the exempt beams on
    tlp, tlo, thi = torch.as_tensor(lp), torch.as_tensor(lo), torch.as_tensor(hi)
    _, exempt, slab0 = tc._step_window(tops, tcfg, tlp, tlo, thi, torch.as_tensor(prev_count),
                                       torch.as_tensor(finished))
    got = tc._exact_proposals(tops, tcfg, tlp, tlo, thi, torch.as_tensor(eos_tok), exempt, slab0,
                              round0_only=round0_only)
    return want, got, lp, (B, K, 2 * K)


@pytest.mark.parametrize(
    "seed,window,chunk,stop_at_count",
    [(0, 4, 4, 0), (1, 2, 1, 0), (2, 4, 4, 2), (3, 10**6, 4, 0)],  # the last: all exempt
)
def test_merge_round0_matches_jax(seed, window, chunk, stop_at_count):
    want, got, lp, (B, K, n_buf) = _proposals(seed, window, chunk, stop_at_count, True)
    if window == 10**6:
        assert got[0] is None  # no proposal round ran
    for g, w, name in zip(_finish(got[0], lp, B, K, n_buf), want[:3], ("tok", "lp", "valid")):
        _assert_equal(g, w, name)
    for g, w, name in zip(got[1:], want[3:], ("eos_ok", "need", "th_lp")):
        _assert_equal(g, w, name)


@pytest.mark.parametrize("seed", [0, 4])
def test_merge_loop_rounds_match_jax(seed, monkeypatch):
    """The proven loop (``force_full``): later rounds merge the buffer with
    wider LM chunks and slabs."""
    calls = []
    real = tc.beam_merge
    monkeypatch.setattr(tc, "beam_merge", lambda *a, **k: calls.append(1) or real(*a, **k))
    want, got, lp, (B, K, n_buf) = _proposals(seed, 2, 1, 0, False, averse=True)
    assert len(calls) >= 2  # round 0 and at least one loop round
    for g, w, name in zip(_finish(got[0], lp, B, K, n_buf), want[:3], ("tok", "lp", "valid")):
        _assert_equal(g, w, name)
    _assert_equal(got[1], want[3], "eos_ok")


@pytest.mark.parametrize("seed,round0_only", [(0, True), (4, False), (1, False)])
def test_merge_ties_matches_jax(seed, round0_only):
    """Kernel 8's ties mode, merge (``exact_ties``): round 0 and the proven
    loop's rounds keep equal log-probs in dedup-id order, as
    ``_top_by_score_then_id`` does; ties abound (log-probs rounded to 1/4,
    an LM-averse row flooding the buffer with 0.0)."""
    want, got, lp, (B, K, n_buf) = _proposals(seed, 2, 1, 0, round0_only, averse=True, ties=True)
    for g, w, name in zip(_finish(got[0], lp, B, K, n_buf), want[:3], ("tok", "lp", "valid")):
        _assert_equal(g, w, name)
    _assert_equal(got[1], want[3], "eos_ok")


# ----------------------------------------------------- kernel 8: select


def _select_inputs(seed, case, B=3, K=4, n_buf=8, w=4, V=40):
    rng = np.random.default_rng(seed)
    lp = _lp(rng, B * K, V)
    rows = np.arange(B * K).reshape(B, K, 1)
    buf_tok = rng.integers(3, 12, size=(B, K, n_buf)).astype(np.int32)  # duplicates
    buf_valid = rng.random((B, K, n_buf)) < 0.6
    buf_lp = lp[rows, buf_tok]
    win_valid = rng.random((B, K, w)) < 0.7
    win_tok = np.where(win_valid, rng.integers(3, 12, size=(B, K, w)), PAD).astype(np.int32)
    win_lp = lp[rows, win_tok]
    eos_ok = rng.random((B, K, 1)) < 0.5
    prev_count = rng.integers(0, 6, size=(B, K)).astype(np.int32)
    finished = rng.random((B, K)) < 0.25
    bs = (np.round(rng.normal(-3, 1, size=(B, K)) * 2) / 2).astype(np.float32)
    bs[0, 3] = NEG_INF  # a dead beam
    bs[2, :] = bs[2, 0]  # equal beam scores: cross-beam ties
    need = rng.random((B, K)) < 0.5
    th_lp = (np.round(rng.normal(-5, 2, size=(B, K)) * 2) / 2).astype(np.float32)
    stop_at_count, always_allow_eos = 0, False
    if case == "stop":
        stop_at_count = 2
    elif case == "always_eos":
        always_allow_eos = True
        finished[:] = False
    elif case == "eos_heavy":  # fewer than K non-EOS candidates
        lp[:, EOS] = 0.0
        eos_ok[:] = True
        buf_valid[:] = False
        win_valid[:] = False
        win_tok[:] = PAD
        win_lp = lp[rows, win_tok]
        finished[:] = False
        buf_tok[:] = EOS  # one EOS kept per beam, its copies at NEG_INF
        buf_valid[:] = True
        buf_tok[1, :, 0] = 20  # query 1: one non-EOS pick per beam
        buf_lp = lp[rows, buf_tok]
        bs[:] = 0.0
    elif case == "dead_query":
        bs[1, :] = NEG_INF
        finished[1, :] = True
    elif case == "tie_cutoff":  # a need beam's bound meets the cutoff exactly
        need[:] = True
        th_lp[:] = 0.0
    buf = (buf_tok, buf_lp, buf_valid) if case != "no_buffer" else None
    return dict(buf=buf, n_buf=n_buf, win_tok=win_tok, win_valid=win_valid, win_lp=win_lp,
                eos_ok=eos_ok, lp=lp, prev_count=prev_count, finished=finished, bs=bs,
                need=need, th_lp=th_lp, K=K, V=V, stop_at_count=stop_at_count,
                always_allow_eos=always_allow_eos)


def _jax_select(x, ties=False):
    """``_fast_exact_select``'s build_and_select (+ the buffer finish and
    the EOS/PAD slots) and the soundness test, as the JAX package runs them."""
    B, K = x["prev_count"].shape
    jcfg = jc.DecodeConfig(num_beams=x["K"], stop_at_count=x["stop_at_count"],
                           always_allow_eos=x["always_allow_eos"], exact_ties=ties)
    lp = jnp.asarray(x["lp"])
    pad_lp = lp[:, PAD].reshape(B, K, 1)
    eos_lp = lp[:, EOS].reshape(B, K, 1)
    if x["buf"] is None:
        n = x["n_buf"]
        buf_tok, buf_lp, buf_valid = (jnp.full((B, K, n), PAD, jnp.int32),
                                      jnp.broadcast_to(pad_lp, (B, K, n)),
                                      jnp.zeros((B, K, n), bool))
    else:
        buf_tok, buf_lp, buf_valid = (jnp.asarray(a) for a in x["buf"])
        buf_tok = jnp.where(buf_valid, buf_tok, PAD)
        buf_lp = jnp.where(buf_valid, buf_lp, pad_lp)
    tokens = jnp.concatenate([buf_tok, jnp.asarray(x["win_tok"]), jnp.full((B, K, 1), EOS, jnp.int32),
                              jnp.full((B, K, 1), PAD, jnp.int32)], -1)
    fm_valid = jnp.concatenate([buf_valid, jnp.asarray(x["win_valid"]), jnp.asarray(x["eos_ok"]),
                                jnp.zeros((B, K, 1), bool)], -1)
    cand_lp = jnp.concatenate([buf_lp, jnp.asarray(x["win_lp"]), eos_lp, pad_lp], -1)
    tokens, allowed, cand_lp = jc._apply_branches(jcfg, tokens, fm_valid, cand_lp,
                                                  jnp.asarray(x["prev_count"]),
                                                  jnp.asarray(x["finished"]))
    cons = jnp.where(allowed, cand_lp, NEG_INF)
    cons = jnp.where(jc._dedup_mask(tokens), cons, NEG_INF)
    bs = jnp.asarray(x["bs"])
    out = jc._select(jcfg, cons + bs[..., None], cand_lp + bs[..., None], tokens, x["K"], x["V"])
    unsound = jnp.asarray(x["need"]) & (bs + jnp.asarray(x["th_lp"]) >= out[8][:, -1][:, None])
    return out, unsound.any(-1)


def _port_select(x, ties=False):
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))  # noqa: E731
    return k8.beam_select(
        tuple(t(a) for a in x["buf"]) if x["buf"] is not None else None, x["n_buf"],
        t(x["win_tok"]), t(x["win_valid"]), t(x["win_lp"]), t(x["eos_ok"]), t(x["lp"]),
        t(x["prev_count"]), t(x["finished"]), t(x["bs"]), t(x["need"]), t(x["th_lp"]),
        K=x["K"], eos=EOS, pad=PAD, stop_at_count=x["stop_at_count"],
        always_allow_eos=x["always_allow_eos"], ties=ties,
    )


@pytest.mark.parametrize("case", ["plain", "stop", "always_eos", "eos_heavy", "dead_query",
                                  "tie_cutoff", "no_buffer"])
@pytest.mark.parametrize("seed", [0, 1])
def test_select_matches_jax(seed, case):
    x = _select_inputs(seed, case)
    want, want_unsound = _jax_select(x)
    got, unsound = _port_select(x)
    names = ("top_tok", "top_parent", "top_uncons", "finite", "sel_tok", "sel_parent",
             "sel_uncons", "sel_finite", "top_cons")
    for g, w, name in zip(got, want, names):
        _assert_equal(g.numpy(), w, name)
    _assert_equal(unsound.numpy(), want_unsound, "unsound")
    if case == "eos_heavy":  # the continuation rule had to take EOS picks
        assert (np.asarray(want[4]) == EOS).any()
    if case == "tie_cutoff":
        assert np.asarray(want_unsound).any()


@pytest.mark.parametrize("n_par", [1, 4])
def test_select_top_matches_jax(n_par):
    """Step 0: the V-wide rows ranked by the row top-k, then the epilogue;
    ``n_par`` 1 is the narrow beam axis of the slim step 0."""
    B, K, V = 3, 4, 40
    rng = np.random.default_rng(n_par)
    lp = _lp(rng, B * n_par, V)
    lp[0, EOS] = 3.0  # EOS among the picks
    mask = rng.random(V) < 0.6
    mask[[5, 6, EOS]] = True
    bs = np.full((B, K), NEG_INF, np.float32)
    bs[:, 0] = 0.0
    cons = np.where(mask, lp.reshape(B, n_par, V), NEG_INF) + bs[:, :n_par, None]
    tokens_all = np.broadcast_to(np.arange(V, dtype=np.int32), (B, n_par, V))
    jcfg = jc.DecodeConfig(num_beams=K)
    want = jc._select(jcfg, jnp.asarray(cons), jnp.asarray(lp.reshape(B, n_par, V) + bs[:, :n_par, None]),
                      jnp.asarray(tokens_all), K, V)
    top_cons, top_idx = row_topk_plain(torch.as_tensor(cons.reshape(B, -1)), 2 * K)
    got = k8.beam_select_top(top_cons, top_idx, torch.as_tensor(lp), torch.as_tensor(bs), n_par,
                             K, EOS)
    for g, w in zip(got, want):
        _assert_equal(g.numpy(), w)


# ------------------------------------------------------- kernels 9-11


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jtiny(vocab_size=99), ttiny(vocab_size=99)
    params = jbart.init_params(jax.random.PRNGKey(1), jcfg)
    return jcfg, tcfg, params, tconvert.params_from_jax(jax.device_get(params), tcfg, device="cpu")


def _encoded(models, b=3, lsrc=9, seed=2):
    jcfg, tcfg, params, tparams = models
    rng = np.random.default_rng(seed)
    src = rng.integers(3, 99, size=(b, lsrc)).astype(np.int32)
    mask = np.ones((b, lsrc), np.int32)
    mask[0, -4:] = 0  # padded encoder positions
    mask[2, -1:] = 0
    jenc = jbart.encode(jcfg, params, jnp.asarray(src), jnp.asarray(mask))
    tenc = tbart.encode(tcfg, tparams, torch.as_tensor(src), torch.as_tensor(mask))
    return (jbart.precompute_cross_kv(jcfg, params, jenc), jbart.encoder_bias(jnp.asarray(mask)),
            tbart.precompute_cross_kv(tcfg, tparams, tenc), tbart.encoder_bias(torch.as_tensor(mask)))


@pytest.mark.parametrize("g", [1, 4])
def test_cross_attention_step_matches_jax(models, g):
    jcfg, tcfg, params, tparams = models
    jkv, jbias, tkv, tbias = _encoded(models)
    x = np.random.default_rng(g).normal(size=(3 * g, 1, jcfg.d_model)).astype(np.float32)
    for layer in (0, len(params["decoder"]["layers"]) - 1):
        want = jbart._cross_attention_step(params["decoder"]["layers"][layer]["cross_attn"],
                                           jnp.asarray(x), jkv[layer], jbias,
                                           jcfg.decoder_attention_heads, jnp.float32)
        got = tbart._cross_attention_step(tparams["decoder"]["layers"][layer]["cross_attn"],
                                          torch.as_tensor(x), tkv[layer], tbias,
                                          tcfg.decoder_attention_heads)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_steps_with_pingpong_cache_match_jax(models):
    """The beam search's scheme: step 0 on one row per query, a fan-out to
    B*K rows (stride 1), then each step's live columns copied into the other
    of two preallocated caches; JAX gathers whole caches."""
    jcfg, tcfg, params, tparams = models
    jkv, jbias, tkv, tbias = _encoded(models)
    B, K, L = 3, 4, 6
    rng = np.random.default_rng(3)
    caches = [tbart.empty_self_cache(tcfg, B * K, L, device="cpu") for _ in range(2)]
    tcache = [{n: c[n][:B] for n in ("k", "v")} for c in caches[0]]
    jcache = jbart.empty_self_cache(jcfg, B, L)
    toks = np.full(B, 2, np.int32)
    for step in range(L - 1):
        rows = B if step == 0 else B * K
        jl, jcache = jbart.decode_step(jcfg, params, jnp.asarray(toks), jnp.int32(step), jcache,
                                       jkv, jbias)
        tl, tcache = tbart.decode_step(tcfg, tparams, torch.as_tensor(toks), step, tcache, tkv,
                                       tbias)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        parent = rng.integers(0, 1 if step == 0 else K, size=(B, K))
        idx = (np.arange(B)[:, None] * (1 if step == 0 else K) + parent).reshape(-1)
        jcache = jbart.reorder_cache(jcache, jnp.asarray(idx))
        tcache = tbart.reorder_cache(tcache, torch.as_tensor(idx), step=step,
                                     out=caches[(step + 1) % 2])
        for lj, lt in zip(jcache, tcache):
            for n in ("k", "v"):
                np.testing.assert_allclose(lt[n].numpy(), np.asarray(lj[n]), **TOL)
        toks = rng.integers(3, 99, size=B * K).astype(np.int32)
        assert rows <= B * K


def test_reorder_cache_matches_jax_exactly():
    """Live columns copied into a zeroed buffer equal JAX's full gather on
    every column when the columns past ``step`` were never written."""
    rng = np.random.default_rng(0)
    rows, L, H, Dh, step = 6, 5, 2, 4, 2
    arrays = []
    for _ in range(3):
        k, v = rng.normal(size=(2, rows, L, H, Dh)).astype(np.float32)
        k[:, step + 1:] = 0.0
        v[:, step + 1:] = 0.0
        arrays.append({"k": k, "v": v})
    idx = rng.integers(0, rows, size=8)
    want = jbart.reorder_cache([{n: jnp.asarray(a[n]) for n in a} for a in arrays],
                               jnp.asarray(idx))
    src = [{n: torch.as_tensor(a[n]) for n in a} for a in arrays]
    out = [{n: torch.zeros((8, L, H, Dh)) for n in ("k", "v")} for _ in arrays]
    got = tbart.reorder_cache(src, torch.as_tensor(idx), step=step, out=out)
    assert got is out
    for w, g in zip(want, got):
        for n in ("k", "v"):
            _assert_equal(g[n].numpy(), np.asarray(w[n]))
    full = [{n: torch.full((8, L, H, Dh), 7.0) for n in ("k", "v")} for _ in arrays]
    tbart.reorder_cache(src, torch.as_tensor(idx), step=L - 1, out=full)  # every column
    for w, g in zip(want, full):
        for n in ("k", "v"):
            _assert_equal(g[n].numpy(), np.asarray(w[n]))


@pytest.mark.parametrize("step", [0, 3, 6])
def test_self_attention_live_slots_equal_biased_slots(step):
    """Kernel 10 reads slots [0, step] only; the plain code reads all with a
    -1e9 bias past step.  exp(-1e9 - max) is 0.0 in f32, so both give the
    same result up to the order of the f32 sums."""
    g = torch.Generator().manual_seed(step)
    q = torch.randn(5, 2, 8, generator=g)
    k, v = torch.randn(2, 5, 7, 2, 8, generator=g)
    live = k910.decode_attention_plain(q, k, v, None, m=step + 1)
    torch.testing.assert_close(live, k910.self_attention_step(q, k, v, step), atol=1e-6, rtol=0)


@pytest.mark.parametrize("case", ["plain", "stop", "eos_heavy", "no_buffer"])
@pytest.mark.parametrize("seed", [0, 1])
def test_select_ties_matches_jax(seed, case):
    """Kernel 8's ties mode, select (``exact_ties``): equal scores across
    beams (query 2's beams share one score) order by (parent beam, token),
    as ``_select`` with ``_top_by_score_then_id`` does; bit for bit."""
    x = _select_inputs(seed, case)
    want, want_unsound = _jax_select(x, ties=True)
    got, unsound = _port_select(x, ties=True)
    for g, w, name in zip(got, want, ("top_tok", "top_parent", "top_uncons", "finite", "sel_tok",
                                      "sel_parent", "sel_uncons", "sel_finite", "top_cons")):
        _assert_equal(g.numpy(), w, name)
    _assert_equal(unsound.numpy(), want_unsound, "unsound")


def _merge_rows(rng, rows, n_buf, n_top, n_slab, V, with_buf, sparse=False):
    """A merge round's inputs with kernel 8's contract: each row's tokens
    take that row's log-prob (one per token, ties and NEG_INF among them),
    copies of a token across the buffer, the LM top and the slab, invalid
    slots (flag off, or NEG_INF log-prob) beside valid copies."""
    lp = _lp(rng, rows, V, step=0.5)
    lp[:, 3] = NEG_INF

    def draw(width, p_ok):
        tok = rng.integers(0, V, size=(rows, width)).astype(np.int32)
        tok[:, : width // 4] = rng.integers(0, 8, size=(rows, width // 4))  # many copies
        ok = rng.random((rows, width)) < (p_ok / 20 if sparse else p_ok)
        return tok, np.take_along_axis(lp, tok, -1), ok

    buf = None
    if with_buf:
        btok, blp, bok = draw(n_buf, 0.6)
        # a buffer holds distinct valid tokens, each with lp > NEG_INF/2
        bok &= (blp > NEG_INF / 2)
        for r in range(rows):
            seen = set()
            for j in range(n_buf):
                if bok[r, j] and btok[r, j] in seen:
                    bok[r, j] = False
                seen.add(int(btok[r, j])) if bok[r, j] else None
        buf = tuple(torch.as_tensor(x) for x in (btok, blp, bok))
    top = draw(n_top, 0.5)
    slab = draw(n_slab, 0.8)
    return buf, [torch.as_tensor(x) for x in top], [torch.as_tensor(x) for x in slab]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("seed,n_buf,n_top,n_slab,chunk,with_buf", [
    (0, 4, 40, 40, 8, True), (1, 4, 40, 40, 8, False), (2, 6, 100, 60, 16, True),
    (3, 30, 400, 400, 64, True), (4, 16, 64, 64, 32, False), (5, 3, 9, 0, 6, True),
    (6, 8, 60, 60, 16, False)])
def test_merge_large_route_plain_matches_merge_plain(seed, n_buf, n_top, n_slab, chunk,
                                                     with_buf, ties):
    """Kernel 8's large-n merge (passes over chunks, each keeping its
    n_buf best first instances in slot order) equals the one-CTA merge bit
    for bit in both orders, over one to several passes, with duplicates,
    invalid slots, unfilled outputs and exact ties."""
    rng = np.random.default_rng(seed)
    sparse = seed == 6  # most slots invalid: rows with unfilled outputs
    buf, top, slab = _merge_rows(rng, 5, n_buf, n_top, n_slab, 50, with_buf, sparse)
    args = (buf, *top, *slab, 50, n_buf)
    n = n_buf + n_top + n_slab
    assert len(k8.merge_widths(n, n_buf, chunk)) >= 2
    want = k8.beam_merge_plain(*args, ties=ties)
    got = k8.beam_merge_large_plain(*args, ties=ties, chunk=chunk)
    for g, w in zip(got, want):
        _assert_equal(g.numpy(), w.numpy())
    assert bool(want[2].all()) != sparse  # unfilled outputs in the sparse case only


@pytest.mark.parametrize("g,m,dh,bf16,want", [
    (1, 10, 64, True, "warp"), (1, 1024, 64, False, "warp"), (15, 14, 64, True, "mma"),
    (32, 1024, 64, True, "mma"), (32, 1025, 64, True, "tiled"), (33, 14, 64, True, "tiled"),
    (15, 64, 64, False, "ffma"), (2, 65, 64, False, "tiled"), (15, 14, 32, True, "tiled"),
    (1, 10, 128, False, "tiled")])
def test_decode_attention_route_rules(g, m, dh, bf16, want):
    """Kernels 9 and 10's route by shape, at each fast route's limits
    (``csrc/decode_attention.cu`` states them), and the heads a CTA."""
    assert k910.route(g, m, dh, bf16) == want
    assert [k910.heads_a_cta(h) for h in (16, 12, 6, 3)] == [4, 4, 2, 1]
