"""The port's constrained sampling (``sample``, ``seed``) against
``seal_tpu``'s, on the CPU (kernel 20's plain version).

The port's noise is counter-based Philox, JAX's threefry: the two agree in
distribution, not in bits.  So the port is held to JAX with JAX's own
Gumbel draws injected (``sample_select.gumbel_noise`` replays JAX's key
chain, ``seal_tpu/decoding/constrained.py:1325,1365``): ``_select_sample``'s
eight outputs equal JAX's exactly, and generation equals JAX's token for
token over the three layouts and the four candidate routes.  With its own
noise the sampler meets the known answers of Random123's Philox4x32-10,
draws from the softmax of the allowed log-probs (a chi-square test), and
keeps the JAX tests' seed contract (``tests/test_decode_modes.py:40-66``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from seal_tpu.decoding import constrained as jc
from seal_tpu.decoding import generate as jg
from seal_tpu.index.device_index import DeviceFMIndex
from seal_tpu.models import bart as jbart
from seal_tpu_torch.decoding import constrained as tc
from seal_tpu_torch.decoding import generate as tg
from seal_tpu_torch.kernels import sample_select as ks
from seal_tpu_torch.models import bart as tbart
from test_decode_modes import _grounded
from test_torch_dense import LAYOUTS, _port_index
from test_torch_dense_counts import forbid_counts
from test_torch_generate import _assert_same_hyps, _models, _random_corpus
from test_torch_modes import _assert_same_raw, world  # noqa: F401

COMMON = dict(num_beams=4, max_length=6, min_length=1, forced_bos_token_id=None)
M32 = 0xFFFFFFFF


@pytest.fixture(scope="module")
def models():
    return _models()


def _jax_noise(seed, steps, B, K):
    """JAX's Gumbel draws of each decode step under ``PRNGKey(seed)``, in the
    port's noise signature: step 0 takes the first split, the scan one split
    a step."""
    key = jax.random.PRNGKey(seed)
    key, k0 = jax.random.split(key)
    keys = [k0]
    for _ in range(steps - 1):
        key, sk = jax.random.split(key)
        keys.append(sk)

    def noise(seed_, step, rows, n, device="cpu", row_offset=0):
        assert seed_ == seed and rows == B * K and row_offset == 0
        g = np.array(jax.random.gumbel(keys[step], (B, K, n), jnp.float32))
        return torch.as_tensor(g).reshape(rows, n)

    return noise


# --------------------------------------------------------------- the noise


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32,) * 4, (M32, M32), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's Philox4x32-10 known-answer vectors."""
    got = ks.philox4x32(*(torch.tensor([c], dtype=torch.int64) for c in ctr), *key)
    assert tuple(int(w) for w in got) == want


def test_gumbel_noise_counter_layout():
    """Word ``column % 4`` of the Philox call at counter (column // 4, row),
    key (seed mod 2^32, step); u strictly inside (0, 1), g finite."""
    seed, step, rows, n = -3, 5, 3, 10
    words = ks.philox_words(seed, step, rows, n)
    for r in range(rows):
        for j in range(n):
            one = ks.philox4x32(*(torch.tensor([c], dtype=torch.int64)
                                  for c in (j // 4, r, 0, 0)), seed & M32, step)
            assert int(words[r, j]) == int(one[j % 4])
    assert not torch.equal(words, ks.philox_words(seed, step + 1, rows, n))
    top = torch.tensor([M32, 0], dtype=torch.int64)
    g = ks.gumbel_of_words(top)
    assert torch.isfinite(g).all() and g[0] > g[1]
    assert torch.isfinite(ks.gumbel_noise(0, 0, 4, 33)).all()


# ---------------------------------------------------- the draw against JAX


def _sample_case(case):
    rng = np.random.default_rng(len(case))
    B, K, N, eos, pad = 3, 4, 12, 2, 1
    cons = np.round(rng.normal(-3, 1.5, size=(B, K, N)), 1).astype(np.float32)
    cand_lp = np.where(rng.random((B, K, N)) < 0.5, cons,
                       np.round(rng.normal(-3, 1.5, size=(B, K, N)), 1)).astype(np.float32)
    cons[rng.random((B, K, N)) < 0.4] = jc.NEG_INF
    cons[0, 1] = jc.NEG_INF  # an all-dead chain
    cons[2, 3, ::2] = -np.inf
    bs = np.round(rng.normal(-2, 1, size=(B, K)), 1).astype(np.float32)
    if case == "wide":  # token = column under a corpus mask
        tokens, mask = np.broadcast_to(np.arange(N, dtype=np.int32), (B, K, N)), rng.random(N) < 0.7
        mask[eos] = False
        cons_j = np.where(mask, cons, jc.NEG_INF)
        return cons, cons_j, cand_lp, None, tokens, mask, bs, eos, pad
    tokens = rng.integers(0, 20, size=(B, K, N)).astype(np.int32)
    tokens[tokens == eos] = 7
    tokens[0, :, 5] = eos
    tokens[1, 2, [3, 8]] = eos  # EOS twice: the first slot counts
    # row [1, 0] and query 2 hold no EOS: the EOS slot falls back to slot 0
    return cons, cons, cand_lp, tokens, tokens, None, bs, eos, pad


@pytest.mark.parametrize("case", ["table", "wide"])
def test_sample_select_plain_matches_jax(case):
    """Kernel 20's plain version, fed JAX's Gumbel draws, equals
    ``dispatch_select``'s EOS slot and ``_select_sample`` in all eight
    outputs, bit for bit: NEG_INF and -inf slots, an all-dead chain, rows
    without an EOS slot (slot 0's log-prob) and with two."""
    cons, cons_j, cand_lp, tokens, tokens_j, mask, bs, eos, pad = _sample_case(case)
    B, K, N = cons.shape
    key = jax.random.PRNGKey(11)
    gumbel = np.array(jax.random.gumbel(key, (B, K, N), jnp.float32))
    cfg = jc.DecodeConfig(num_beams=K, sample=True, eos_token_id=eos, pad_token_id=pad)
    eos_slot = jnp.argmax(jnp.asarray(tokens_j) == eos, axis=-1)
    eos_lp = jnp.take_along_axis(jnp.asarray(cand_lp), eos_slot[..., None], -1)[..., 0]
    want = jc._select_sample(cfg, jnp.asarray(cons_j), jnp.asarray(cand_lp) + bs[..., None],
                             jnp.asarray(tokens_j), eos_lp + bs, key)
    t = torch.as_tensor
    got = ks.sample_select_plain(
        t(cons), t(cand_lp), None if tokens is None else t(tokens), t(bs), 0, 0, eos=eos,
        pad=pad, mask=None if mask is None else t(mask), noise=t(gumbel))
    for a, b in zip(got, want):
        a, b = a.numpy(), np.asarray(b)
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b.astype(a.dtype))
    assert not bool(got[7].logical_not().any()) and int(got[4][0, 1]) == eos


@pytest.mark.parametrize("stop_at_count,always_allow_eos", [(0, False), (2, True), (1, False)])
def test_sample_select_counts_plain_matches_jax(stop_at_count, always_allow_eos):
    """Kernel 20's count-reading mode's plain version (the sampled
    ``exact_mask`` step), fed JAX's Gumbel draws, equals JAX's dense
    candidates (``_candidates_general``'s ``exact_mask`` branch), its mask,
    ``dispatch_select``'s EOS slot and ``_select_sample`` in all eight
    outputs, bit for bit, with every branch taken."""
    from seal_tpu.ops import fm_ops as jfm
    from seal_tpu_torch.index.device_index import TorchFMIndex
    from seal_tpu_torch.ops import fm_ops as tfm
    from test_torch_kth_dense import _dense_case

    class _JaxOps:
        def __init__(self, dix):
            self.dix = dix

        def dense_counts(self, lo, hi, chunk):
            return jfm.dense_counts(self.dix, lo, hi, chunk)

    host, lo, hi, lp, prev_count, finished, bs = _dense_case(20 + 2 * stop_at_count
                                                             + always_allow_eos)
    B, K = lo.shape
    V = lp.shape[1]
    cfg = jc.DecodeConfig(num_beams=K, sample=True, exact_mask=True,
                          stop_at_count=stop_at_count, always_allow_eos=always_allow_eos)
    tokens, allowed, cand = jc._candidates_general(
        _JaxOps(DeviceFMIndex.from_host(host, vocab=V)), cfg, jnp.asarray(lp), jnp.asarray(lo),
        jnp.asarray(hi), jnp.asarray(prev_count), jnp.asarray(finished))
    cons = jnp.where(allowed, cand, jc.NEG_INF)
    key = jax.random.PRNGKey(17)
    gumbel = np.array(jax.random.gumbel(key, (B, K, V), jnp.float32))
    eos_slot = jnp.argmax(tokens == cfg.eos_token_id, axis=-1)
    eos_lp = jnp.take_along_axis(cand, eos_slot[..., None], -1)[..., 0]
    want = jc._select_sample(cfg, cons, cand + jnp.asarray(bs)[..., None], tokens,
                             eos_lp + jnp.asarray(bs), key)
    t = torch.as_tensor
    mask = tfm.dense_mask(TorchFMIndex.from_host(host, vocab=V, device="cpu"), t(lo), t(hi),
                          cfg.dense_chunk)
    n0 = ks.sample_select_counts.launches
    got = ks.sample_select_counts_plain(
        mask, t(lp), t(prev_count), t(finished), t(bs), 0, 0, eos=cfg.eos_token_id,
        pad=cfg.pad_token_id, stop_at_count=stop_at_count, always_allow_eos=always_allow_eos,
        noise=t(gumbel).reshape(B * K, V))
    for a, b in zip(got, want):
        a, b = a.numpy(), np.asarray(b)
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b.astype(a.dtype))
    # the wrapper runs the plain version on the CPU (no launch)
    ks.sample_select_counts(mask, t(lp), t(prev_count), t(finished), t(bs), 0, 0,
                            eos=cfg.eos_token_id, pad=cfg.pad_token_id)
    assert ks.sample_select_counts.launches == n0
    assert finished.any() and not bool(got[7].logical_not().any())


@pytest.mark.parametrize("rows,n,route,splits", [
    (480, 50265, "block", 1),  # step 0's V-wide rows: a CTA a row
    (120, 50265, "block", 4),  # batch 8: a cluster of 4
    (32, 50265, "block", 4),
    (480, 98, "warp", 1),  # a 2K buffer's list rows: a warp a row
    (480, 128, "warp", 1),
    (480, 290, "block", 1),  # the sampling buffer's (top_m 256): a CTA a row
    (480, 10034, "block", 1),  # sampling at top_m 10,000
])
def test_sample_plan_routes(rows, n, route, splits):
    """Kernel 20's layout as a function of (rows, columns): a warp a row up
    to ``WARP_MAX`` columns (a quad a lane), a CTA a row past it, split over
    a cluster where rows are few."""
    p = ks.plan(rows, n)
    assert (p.route, p.splits) == (route, splits)
    assert p.code == (0 if route == "warp" else splits)


@pytest.mark.parametrize("form", ["table", "mask"])
def test_sampler_draws_the_softmax(form):
    """2^16 draws of one 16-candidate row with 4 masked slots (one chain a
    draw) fit the softmax of the 12 allowed log-probs: chi-square p > 1e-3."""
    rng = np.random.default_rng(7)
    N, n = 16, 1 << 16
    lp = torch.as_tensor(np.log(rng.dirichlet(np.ones(N))).astype(np.float32))
    allowed = torch.ones(N, dtype=torch.bool)
    allowed[[0, 5, 9, 15]] = False
    cons = torch.where(allowed, lp, tc.NEG_INF)
    bs = torch.zeros((1, n))
    if form == "table":
        tokens = torch.arange(100, 100 + N, dtype=torch.int32).expand(1, n, N)
        out = ks.sample_select(cons.expand(1, n, N), lp.expand(1, n, N), tokens, bs, 5, 3, eos=2,
                               pad=1)
        drawn = out[4][0] - 100
    else:
        out = ks.sample_select(lp.expand(1, n, N), lp.expand(1, n, N), None, bs, 5, 3, eos=2, pad=1,
                               mask=allowed)
        drawn = out[4][0]
    counts = torch.bincount(drawn.long(), minlength=N).numpy()
    assert counts[~allowed.numpy()].sum() == 0
    p = torch.softmax(lp[allowed].double(), 0).numpy()
    assert stats.chisquare(counts[allowed.numpy()], p * n).pvalue > 1e-3
    np.testing.assert_array_equal(out[6][0].numpy(), lp[drawn.long()].numpy())


# ------------------------------------------------------ generation, JAX noise


ROUTES = {
    # a 12-slot buffer, not 2K = 8: JAX widens it to max(2K, top_m)
    "proposal": dict(top_m=12, exact_chunk=4),
    "exact_mask": dict(exact_mask=True),
    "speculative": dict(speculative=True, top_m=8, window=4),
    "disable_fm_index": dict(disable_fm_index=True, top_m=8),
}
CASES = [("proposal", layout) for layout in LAYOUTS] + [
    (route, "psi") for route in ROUTES if route != "proposal"]


@pytest.mark.parametrize("route,layout", CASES)
def test_sample_generation_with_jax_noise_matches_jax(models, monkeypatch, route, layout):
    """``fm_index_generate(sample=True)`` with JAX's draws equals JAX's token
    for token (scores within 1e-4): the proven proposal loop (a small
    ``top_m`` and chunk, so it sweeps several rounds) on the three layouts,
    and the ``exact_mask`` (no count vector read: every entry to them
    raises), speculative and free routes."""
    jcfg, tcfg, params, tparams = models
    if route == "exact_mask":
        forbid_counts(monkeypatch)
    host, queries = _random_corpus(2)
    kw = dict(COMMON, sample=True, seed=4, **ROUTES[route])
    jh = jg.fm_index_generate(jcfg, params, DeviceFMIndex.from_host(host, vocab=96), queries, **kw)
    monkeypatch.setattr(ks, "gumbel_noise", _jax_noise(4, 5, len(queries), 4))
    th = tg.fm_index_generate(tcfg, tparams, _port_index(host, layout), queries, **kw)
    assert sum(map(len, th)) > 0
    _assert_same_hyps(jh, th)


def test_sample_step_outputs_match_jax(models, monkeypatch):
    """Every candidate of every step, with forced BOS and a stop count:
    JAX's raw outputs (a sampled step records the K draws and K PAD
    slots)."""
    jcfg, tcfg, params, tparams = models
    host, queries = _random_corpus(5)
    ids, mask = jg.pad_batch(queries, jcfg.pad_token_id)
    kw = dict(num_beams=3, max_length=6, min_length=2, sample=True, top_m=8, window=4,
              stop_at_count=2, forced_bos_token_id=6)
    jo = jc.constrained_beam_search(
        jcfg, params, DeviceFMIndex.from_host(host, vocab=96), jc.DecodeConfig(**kw),
        jbart.encode(jcfg, params, jnp.asarray(ids), jnp.asarray(mask)), jnp.asarray(mask),
        rng_key=jax.random.PRNGKey(9))
    monkeypatch.setattr(ks, "gumbel_noise", _jax_noise(9, 4, len(queries), 3))
    tids, tmask = torch.as_tensor(ids), torch.as_tensor(mask)
    to = tc.constrained_beam_search(tcfg, tparams, _port_index(host, "psi"), tc.DecodeConfig(**kw),
                                    tbart.encode(tcfg, tparams, tids, tmask), tmask, seed=9)
    assert to.cand_tokens.shape[0] == 4
    _assert_same_raw(jo, to)


# ------------------------------------------------- the seed contract, own noise


def test_sampling_grounded_and_seeded(world):  # noqa: F811
    """``tests/test_decode_modes.py:40-54`` on the port's own noise: the same
    seed gives the same hypotheses, another seed others, every key occurs in
    the corpus."""
    _, tcfg, _, tparams, _, tdev, host, ids, mask = world
    kw = dict(num_beams=4, max_length=6, min_length=0, forced_bos_token_id=None, exact_mask=True,
              sample=True)
    out1 = tg.fm_index_generate(tcfg, tparams, tdev, ids, mask, seed=7, **kw)
    assert out1 == tg.fm_index_generate(tcfg, tparams, tdev, ids, mask, seed=7, **kw)
    assert out1 != tg.fm_index_generate(tcfg, tparams, tdev, ids, mask, seed=8, **kw)
    for hyps in out1:
        assert hyps
        for _, toks in hyps:
            assert _grounded(host, toks), toks


def test_sampling_chains_diverge(world):  # noqa: F811
    """``tests/test_decode_modes.py:57-66``: a query's six chains do not all
    end in one key."""
    _, tcfg, _, tparams, _, tdev, host, ids, mask = world
    out = tg.fm_index_generate(tcfg, tparams, tdev, ids, mask, num_beams=6, max_length=6,
                               min_length=0, forced_bos_token_id=None, exact_mask=True, sample=True,
                               seed=0)
    assert len({tuple(t) for _, t in out[0] if len(t) == 6}) > 1
