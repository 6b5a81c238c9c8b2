"""The ops and kernels under the port's dense parity mode and tie order,
against ``seal_tpu``'s, on the CPU (the kernels' plain versions).

``dense_counts`` on the Psi layout and on the compact and hybrid layouts
at 1, 2, 4 and 5 digits equals the JAX op exactly, with empty, full,
end-of-index and sentinel ranges, a ``chunk`` that does not divide the
vocab and a corpus alphabet wider than the model vocab; it also equals a
histogram of each range's BWT rows, the kernels' other route.  Kernel
16's walk, mirrored in numpy, equals the JAX op on both wavelet layouts
at every digit count, by one walk a range or, where the range's walk
outgrows the frontier's room, one walk a slice.  Kernel 17's
plain version equals JAX's branches, mask and beam-score add bit for bit.
Kernel 8's plain ties order equals ``_top_by_score_then_id`` on rows with
signed zeros, ``NEG_INF`` and repeated scores, and the ``_beam_tok_tie``
int32 limit raises in both packages.  The count mask (kernels 15 and 16's
mask modes, what the ``exact_mask`` decode reads) unpacked equals JAX's
``dense_counts > 0`` on the three layouts, at vocabs under 32 and odd ones
like BART's, its padding bits 0; the decode reads no counts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal_tpu.decoding import constrained as jc
from seal_tpu.index import FMIndex
from seal_tpu.index.device_index import DeviceFMIndex
from seal_tpu.index.wavelet import WaveletFMIndex
from seal_tpu.ops import fm_ops as jfm
from seal_tpu.ops import wt_ops as jwt
from seal_tpu_torch.index.device_index import TorchFMIndex
from seal_tpu_torch.index.wavelet import WaveletIndex
from seal_tpu_torch.kernels import beam_select, count_mask, dense_scores, fm_search, wt_search
from seal_tpu_torch.ops import fm_ops as tfm
from seal_tpu_torch.ops import wt_ops as twt
from test_torch_generate import _random_corpus
from test_torch_wavelet import CASES, _host, _ranges


def _histogram(host, lo, hi, vocab):
    """Counts of each token among the BWT rows of every range: the kernels'
    histogram route, in numpy."""
    bwt = np.asarray(host.bwt, np.int64) - 1  # unshifted; the sentinel is -1
    out = np.zeros((lo.size, vocab), np.int32)
    for i, (a, b) in enumerate(zip(lo.tolist(), hi.tolist())):
        sym = bwt[max(a, 0):max(b, 0)]
        sym = sym[(sym >= 0) & (sym < vocab)]
        out[i] = np.bincount(sym, minlength=vocab)
    return out


def _assert_mask(got, counts, vocab):
    """A count mask: int32 [..., words(vocab)], unpacked ``counts > 0``,
    packed as ``count_mask.pack`` packs, no bit set past the vocab."""
    counts = np.asarray(counts)
    assert got.dtype == torch.int32
    assert got.shape == (*counts.shape[:-1], count_mask.words(vocab))
    np.testing.assert_array_equal(count_mask.unpack(got, vocab).numpy(), counts > 0)
    bits = (got.numpy().astype(np.int64)[..., None] >> np.arange(32)) & 1
    assert not bits.reshape(*got.shape[:-1], -1)[..., vocab:].any()  # the padding bits


def forbid_counts(monkeypatch):
    """Make every entry to the exact count vectors raise: the ops, the
    adapters' methods, the kernels' counts modes and their plain sweeps.
    What then still runs reads the count mask alone."""
    from seal_tpu_torch.parallel import sharded_decode as tsd

    def refuse(*a, **k):
        raise AssertionError("an exact_mask step read the [B, K, V] counts")

    for mod, name in ((tfm, "dense_counts"), (twt, "dense_counts"),
                      (tsd.ShardedIndexOps, "dense_counts"),
                      (fm_search, "fm_dense_counts"), (fm_search, "dense_counts_plain"),
                      (fm_search, "fm_dense_counts_sharded"),
                      (fm_search, "dense_counts_sharded_plain"),
                      (wt_search, "wt_dense_counts"), (wt_search, "dense_counts_plain")):
        monkeypatch.setattr(mod, name, refuse)


def _oov_host(seed=5):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(4, 140, size=rng.integers(8, 25)).tolist() + [2] for _ in range(40)]
    host = FMIndex()
    host.initialize(docs)
    return host


@pytest.mark.parametrize("corpus", ["random", "oov"])
@pytest.mark.parametrize("chunk", [7, 4096])
def test_fm_dense_counts_match_jax(corpus, chunk):
    """Psi layout: the port's sweep equals ``fm_ops.dense_counts`` and the
    histogram of each range's rows, with an alphabet past the vocab (oov)
    and a chunk that does not divide it (7)."""
    host = _random_corpus(3)[0] if corpus == "random" else _oov_host()
    lo, hi = _ranges(host, np.random.default_rng(len(corpus) + chunk))
    want = np.asarray(jfm.dense_counts(DeviceFMIndex.from_host(host, vocab=96), lo, hi, chunk))
    n0 = fm_search.fm_dense_counts.launches
    got = tfm.dense_counts(TorchFMIndex.from_host(host, vocab=96, device="cpu"),
                           torch.as_tensor(lo), torch.as_tensor(hi), chunk)
    assert fm_search.fm_dense_counts.launches == n0  # the CPU runs the plain version
    assert got.dtype == torch.int32 and got.shape == (lo.size, 96)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, _histogram(host, lo, hi, 96))
    n0 = fm_search.fm_dense_mask.launches
    _assert_mask(tfm.dense_mask(TorchFMIndex.from_host(host, vocab=96, device="cpu"),
                                torch.as_tensor(lo), torch.as_tensor(hi), chunk), want, 96)
    assert fm_search.fm_dense_mask.launches == n0


@pytest.mark.parametrize("vocab", [1, 5, 31, 32, 33, 127, 128, 129, 50265])
def test_count_mask_layout(vocab):
    """``count_mask.pack``: bit j of word w is token 32 w + j (numpy's
    little-endian ``packbits``), 4 * ceil(V / 128) words a row, the padding
    0; ``unpack`` inverts it."""
    rng = np.random.default_rng(vocab)
    allowed = rng.random((3, 2, vocab)) < 0.3
    allowed[0, 0] = True
    got = count_mask.pack(torch.as_tensor(allowed))
    W = count_mask.words(vocab)
    assert W % 4 == 0 and 32 * W >= vocab > 32 * (W - 4)
    padded = np.zeros((3, 2, 32 * W), bool)
    padded[..., :vocab] = allowed
    want = np.packbits(padded, axis=-1, bitorder="little").view("<i4")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(count_mask.unpack(got, vocab).numpy(), allowed)
    with pytest.raises(ValueError, match="words"):
        count_mask.unpack(got[..., :-4] if W > 4 else got[..., :2], vocab)


# JAX's wt_ops.dense_counts of a case's ranges, computed once a case name
# and shared by its keep_bwt False and True cases: the ranges are the same,
# and both layouts' JAX results are held to the same rows' histogram
_JAX_WT_COUNTS = {}


def _jax_wt_counts(name, host, vocab, lo, hi, chunk, keep_bwt):
    if name not in _JAX_WT_COUNTS:
        j = WaveletFMIndex.from_host(host, vocab=vocab, keep_bwt=keep_bwt)
        _JAX_WT_COUNTS[name] = (lo.copy(), hi.copy(),
                                np.asarray(jwt.dense_counts(j, lo, hi, chunk)))
    c_lo, c_hi, counts = _JAX_WT_COUNTS[name]
    assert np.array_equal(c_lo, lo) and np.array_equal(c_hi, hi)
    return counts


@pytest.mark.parametrize("keep_bwt", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_wt_dense_counts_match_jax(name, keep_bwt):
    """Compact and hybrid layouts at 1, 2, 4 and 5 digits: the port's sweep
    equals ``wt_ops.dense_counts`` and the rows' histogram."""
    host = _host(name)
    vocab = CASES[name][0]
    rng = np.random.default_rng(vocab)
    lo, hi = _ranges(host, rng, n=40 if vocab < 1000 else 10)
    chunk = 5 if vocab < 1000 else 7000  # never divides the vocab
    t = WaveletIndex.from_host(host, vocab=vocab, keep_bwt=keep_bwt, device="cpu")
    want = _jax_wt_counts(name, host, vocab, lo, hi, chunk, keep_bwt)
    n0 = wt_search.wt_dense_counts.launches
    got = twt.dense_counts(t, torch.as_tensor(lo), torch.as_tensor(hi), chunk)
    assert wt_search.wt_dense_counts.launches == n0
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, _histogram(host, lo, hi, vocab))
    # the mask: the wide vocabs on one n-gram's range and the full, empty,
    # end-of-index, (0, 0) and sentinel ranges (a sweep of the vocab a range)
    few = slice(None) if vocab < 1000 else [0, 5, 6, 7, 8, 9]
    n0 = wt_search.wt_dense_mask.launches
    _assert_mask(twt.dense_mask(t, torch.as_tensor(lo[few]), torch.as_tensor(hi[few]), chunk),
                 want[few], vocab)
    assert wt_search.wt_dense_mask.launches == n0


@pytest.mark.parametrize("keep_bwt", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_wt_dense_walk_mirror_matches_jax(name, keep_bwt):
    """Kernel 16's walk (sdsl's interval_symbols over the 16-ary tree),
    mirrored in numpy over the compact and hybrid arrays at 1, 2, 4 and 5
    digits, equals ``wt_ops.dense_counts`` and the plain sweep: empty,
    inverted, full and one-row ranges, the sentinel's row, a model vocab
    two tokens short of the alphabet; and, on a corpus of ~1,800 rows at
    4 and 5 digits, ranges whose whole walk outgrows ``WALK_CAP`` nodes, so
    that each slice of the vocab is walked alone."""
    host = _host(name)
    vocab = CASES[name][1] - 2  # the alphabet's last two symbols lie past the vocab
    rng = np.random.default_rng(vocab + 1)
    lo, hi = _ranges(host, rng, n=16 if vocab < 1000 else 8)
    N = host.size()
    sentinel = int(np.flatnonzero(np.asarray(host.bwt) == 0)[0])
    lo[:4], hi[:4] = (7, sentinel, N - 1, 0), (3, sentinel + 1, N, N)  # inverted, one row, full
    j = WaveletFMIndex.from_host(host, vocab=vocab, keep_bwt=keep_bwt)
    t = WaveletIndex.from_host(host, vocab=vocab, keep_bwt=keep_bwt, device="cpu")
    want = np.asarray(jwt.dense_counts(j, lo, hi, 4096))
    tlo, thi = torch.as_tensor(lo), torch.as_tensor(hi)
    np.testing.assert_array_equal(wt_search.wt_dense_counts_walk_plain(t, tlo, thi).numpy(), want)
    few = slice(None) if vocab < 1000 else slice(0, 4)  # the wide vocabs' sweep: the four above
    np.testing.assert_array_equal(
        wt_search.dense_counts_plain(t, tlo[few], thi[few], 4096).numpy(), want[few])
    assert t.sigma - 1 > vocab  # symbols past the model vocab occur
    if vocab < 1000:
        return
    rng = np.random.default_rng(vocab + 2)  # a corpus whose wide ranges take a walk a slice
    big = FMIndex()
    big.initialize([rng.integers(0, CASES[name][1], size=rng.integers(20, 40)).tolist()
                    for _ in range(60)])
    tb = WaveletIndex.from_host(big, vocab=vocab, keep_bwt=keep_bwt, device="cpu")
    M = big.size()
    blo, bhi = np.array([0, 5, M // 3]), np.array([M, M - 7, M])
    c_all = min(vocab + 1, tb.sigma)
    assert all(wt_search.walk_nodes(tb.digits, b - a, 1, c_all) > wt_search.WALK_CAP
               for a, b in zip(blo, bhi))
    np.testing.assert_array_equal(wt_search.wt_dense_counts_walk_plain(
        tb, torch.as_tensor(blo), torch.as_tensor(bhi)).numpy(), _histogram(big, blo, bhi, vocab))


@pytest.mark.parametrize("stop_at_count,always_allow_eos", [(0, False), (2, True), (1, False)])
def test_dense_scores_plain_matches_jax(stop_at_count, always_allow_eos):
    """Kernel 17's plain version: JAX's dense ``_apply_branches``, the
    NEG_INF mask and the beam score added, bit for bit."""
    rng = np.random.default_rng(stop_at_count)
    B, K, V = 3, 4, 50
    counts = rng.integers(0, 3, size=(B, K, V)).astype(np.int32)
    counts[0, 1] = 0  # a dead interval
    lp = np.round(rng.normal(-3, 2, size=(B * K, V)) * 4).astype(np.float32) / 4
    lp[:, 7] = -0.0
    prev_count = rng.integers(0, 4, size=(B, K)).astype(np.int32)
    finished = rng.random((B, K)) < 0.3
    bs = (np.round(rng.normal(-2, 1, size=(B, K)) * 2) / 2).astype(np.float32)
    bs[1, 2] = jc.NEG_INF
    cfg = jc.DecodeConfig(num_beams=K, stop_at_count=stop_at_count,
                          always_allow_eos=always_allow_eos)
    toks = jnp.broadcast_to(jnp.arange(V, dtype=jnp.int32), (B, K, V))
    _, allowed, cand = jc._apply_branches(cfg, toks, jnp.asarray(counts) > 0,
                                          jnp.asarray(lp).reshape(B, K, V),
                                          jnp.asarray(prev_count), jnp.asarray(finished))
    want = np.asarray(jnp.where(allowed, cand, jc.NEG_INF) + jnp.asarray(bs)[..., None])
    mask = count_mask.pack(torch.as_tensor(counts) > 0)
    got = dense_scores.dense_scores(mask, torch.as_tensor(lp),
                                    torch.as_tensor(prev_count), torch.as_tensor(finished),
                                    torch.as_tensor(bs), eos=2, pad=1,
                                    stop_at_count=stop_at_count,
                                    always_allow_eos=always_allow_eos)
    assert got.shape == (B, K * V)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.reshape(B, K * V).view(np.int32))


@pytest.mark.parametrize("k", [1, 7, 40])
def test_ties_order_matches_jax(k):
    """Kernel 8's plain ties key == ``_top_by_score_then_id``: scores with
    +0.0 and -0.0 (+0.0 first), NEG_INF and many repeats; distinct tie ids
    per row in shuffled order."""
    rng = np.random.default_rng(k)
    rows, n = 6, 40
    score = (np.round(rng.normal(0, 1, size=(rows, n)) * 2) / 2).astype(np.float32)
    score[:, :6] = [0.0, -0.0, 0.0, -0.0, jc.NEG_INF, jc.NEG_INF]
    score[1] = jc.NEG_INF
    score[2, ::2] = 1.5
    tie = np.stack([rng.permutation(n) * 3 + 1 for _ in range(rows)]).astype(np.int32)
    want = np.asarray(jc._top_by_score_then_id(jnp.asarray(score), jnp.asarray(tie), k))
    got = beam_select.top_by_score_then_id(torch.as_tensor(score), torch.as_tensor(tie), k)
    np.testing.assert_array_equal(got.numpy(), want)
    flat_tok = rng.integers(-2, 70000, size=(2, 4 * 9)).astype(np.int32)
    for vocab in (96, 50265, 200000):
        np.testing.assert_array_equal(
            beam_select.beam_tok_tie(torch.as_tensor(flat_tok), 9, vocab).numpy(),
            np.asarray(jc._beam_tok_tie(jnp.asarray(flat_tok), 9, vocab)))


def test_beam_tok_tie_int32_limit_raises_in_both():
    flat_tok = np.zeros((1, 4096 * 3), np.int32)
    with pytest.raises(ValueError, match="exceeds int32"):
        jc._beam_tok_tie(jnp.asarray(flat_tok), 3, 2**20)
    with pytest.raises(ValueError, match="exceeds int32"):
        beam_select.beam_tok_tie(torch.as_tensor(flat_tok), 3, 2**20)
    with pytest.raises(ValueError, match="exceeds int32"):
        beam_select.tie_bits(2**20, 4096)
    assert beam_select.tie_bits(50265, 15) == 17
