"""Kernel 19's k-th-value mode and kernel 17's fused dense select on the
CPU, against ``seal_tpu``.

Kernel 19 is kernel 3's split-row radix select in its k-th-value mode.
Mirrored here in numpy at its layouts (the three digit passes of 11, 11 and
10 bits over each CTA's slice, the bins summed over the cluster, the
block-wide scan of ``find_bin``, the k-th key turned back into its f32), it
equals ``row_kth_plain`` and ``lax.top_k(x, k)[0][..., -1]`` bit for bit on
rows with ties at the k-th place, signed zeros, -inf and ``NEG_INF``
plateaus, at k = 1 and k = n.  The dense step's plain fused select
(``dense_select_plain``: kernel 17's plain scores, then kernel 3's plain top
2K) equals JAX's dense ``_candidates_general`` branch, the ``NEG_INF``
mask, the beam scores added and ``lax.top_k`` bit for bit, values and int64
indices, with every branch taken (``stop_at_count``, finished beams,
``always_allow_eos``), reading the count mask (kernel 15's mask mode),
whose plain version equals JAX's ``dense_counts > 0`` at vocabs of 29 and
50,265."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from seal_tpu.decoding import constrained as jc
from seal_tpu.index import FMIndex
from seal_tpu.index.device_index import DeviceFMIndex
from seal_tpu.ops import fm_ops as jfm
from seal_tpu_torch.index.device_index import TorchFMIndex
from seal_tpu_torch.kernels import count_mask, dense_scores, row_select, row_topk
from seal_tpu_torch.ops import fm_ops as tfm
from test_torch_dense_counts import _assert_mask, _oov_host
from test_torch_fm_ops import _find_bin, _order_keys
from test_torch_wavelet import _ranges


def _kth_mirror(x, k, p):
    """Kernel 19 in numpy: the digit passes over each of the plan's slices,
    the histograms summed over the cluster, T's value."""
    out = []
    for row in x:
        keys = _order_keys(row)
        slices = [keys[c * p.slice:(c + 1) * p.slice] for c in range(p.splits)]
        prefix, mask, rank = 0, 0, k
        for shift, nb in ((21, 2048), (10, 2048), (0, 1024)):
            tot = sum(np.bincount((s[(s & mask) == prefix] >> shift) & (nb - 1), minlength=nb)
                      for s in slices)
            prefix, rank = _find_bin(tot, shift, prefix, rank, p.threads)
            mask |= (nb - 1) << shift
        u = prefix & 0x7FFFFFFF if prefix >> 31 else ~prefix & 0xFFFFFFFF
        out.append(np.uint32(u).view(np.float32))
    return np.array(out, np.float32)


def _kth_rows(n, k, seed):
    """Rows that corner the k-th place: ties across it, +0.0 / -0.0 at it,
    -inf and NEG_INF plateaus reaching it, one value everywhere."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.normal(-4, 1, size=(7, n))).astype(np.float32)  # a few values: ties
    x[1] = -1.0
    x[1, : max(k - 3, 0)] = 3.0
    x[1, rng.permutation(n)[: n // 2]] = 0.0
    x[1, ::2] = np.where(x[1, ::2] == 0.0, -0.0, x[1, ::2])  # +0.0 above -0.0 at the k-th place
    x[2] = -np.inf
    x[2, : k // 2] = rng.normal(size=k // 2)
    x[3] = np.float32(jc.NEG_INF)
    x[3, rng.permutation(n)[: k // 3]] = -2.0
    x[4] = 7.5  # one value
    x[5, : n // 2] = -np.inf
    x[6] = np.where(rng.random(n) < 0.5, 0.0, -0.0)
    return x


# (width, k): the warper's k on a vocab-wide row, a narrow row at k = 1,
# a mid k, and k = n
KTH_CASES = [(50265, 50), (3000, 1), (3000, 1000), (3000, 3000), (257, 257)]


@pytest.mark.parametrize("splits", [None, 1, 3, 16])
@pytest.mark.parametrize("n,k", KTH_CASES)
def test_row_kth_mirror_matches_jax(n, k, splits):
    x = _kth_rows(n, k, n + k)
    p = row_select.plan(x.shape[0], n, k, splits=splits)
    got = _kth_mirror(x, k, p)
    want = np.asarray(lax.top_k(jnp.asarray(x), k)[0][:, -1])
    plain = row_select.row_kth(torch.as_tensor(x), k).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(plain.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("rows,n,k", [(480, 50265, 50), (120, 50265, 50), (8, 50265, 50265),
                                      (32, 70000, 1024)])
def test_row_kth_plan(rows, n, k):
    """Kernel 19's layouts keep no survivor (no sort buffer at any k, none
    sorted in device memory), fit the card's shared memory and cover the
    row; a row is split only where one CTA cannot stage it (one CTA a row
    at the warper's widths, at any row count)."""
    p = row_select.plan(rows, n, k)
    assert p.sort == "none" and p.n2 == 0 and p.region == row_topk.BINS_BYTES
    assert p.smem <= 227 * 1024 - 1024 and 1 <= p.splits <= 16 and p.route == "staged"
    assert p.slice * p.splits >= n > p.slice * (p.splits - 1)
    room, fits = (row_topk.SMEM_BUDGET - row_topk.BINS_BYTES) // 4, 1
    while -(-n // fits) > room:
        fits *= 2
    assert p.splits == fits
    for s in (1, 2, 4, 8, 16):
        assert row_select.plan(rows, n, k, splits=s).splits == s


@pytest.mark.parametrize("vocab", [29, 50265])
def test_fm_dense_mask_vocabs_match_jax(vocab):
    """Psi layout: the count mask at a vocab under 32 words' worth of the
    corpus (symbols past it occur) and at BART's odd 50,265, over full,
    empty, end-of-index, (0, 0) and sentinel ranges, equals JAX's
    ``dense_counts > 0``."""
    host = _oov_host(vocab)
    lo, hi = _ranges(host, np.random.default_rng(vocab), n=24 if vocab < 1000 else 10)
    if vocab > 1000:  # a sweep of the vocab a range: one n-gram's and the five above
        lo, hi = lo[[0, 5, 6, 7, 8, 9]], hi[[0, 5, 6, 7, 8, 9]]
    want = np.asarray(jfm.dense_counts(DeviceFMIndex.from_host(host, vocab=vocab), lo, hi, 4096))
    got = tfm.dense_mask(TorchFMIndex.from_host(host, vocab=vocab, device="cpu"),
                         torch.as_tensor(lo), torch.as_tensor(hi), 2048)
    _assert_mask(got, want, vocab)
    assert want.any() and not want.all()


def _dense_case(seed, B=3, K=4, V=96):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(4, 90, size=rng.integers(5, 30)).tolist() + [2] for _ in range(30)]
    host = FMIndex()
    host.initialize(docs)
    N = host.size()
    lo = rng.integers(0, N, size=(B, K))
    hi = np.minimum(lo + rng.integers(0, N // 3, size=(B, K)), N)
    lo[0, 0], hi[0, 0] = 0, N  # the full range
    lo[0, 1], hi[0, 1] = 4, 4  # an empty one
    lp = (np.round(rng.normal(-3, 1.5, size=(B * K, V)) * 2) / 2).astype(np.float32)  # ties
    lp[:, 5] = -0.0
    lp[:, 6] = 0.0
    prev_count = rng.integers(0, 5, size=(B, K)).astype(np.int32)
    finished = rng.random((B, K)) < 0.3
    bs = np.zeros((B, K), np.float32)  # equal beam scores: ties across beams
    bs[1] = (np.round(rng.normal(-2, 1, size=K) * 2) / 2).astype(np.float32)
    bs[2, 1] = jc.NEG_INF
    return host, lo.astype(np.int32), hi.astype(np.int32), lp, prev_count, finished, bs


class _JaxOps:
    def __init__(self, dix):
        self.dix = dix

    def dense_counts(self, lo, hi, chunk):
        return jfm.dense_counts(self.dix, lo, hi, chunk)


@pytest.mark.parametrize("stop_at_count,always_allow_eos", [(0, False), (2, True), (1, False),
                                                             (0, True)])
def test_dense_select_plain_matches_jax(stop_at_count, always_allow_eos):
    """The fused dense select's plain version against JAX's dense candidate
    branch, mask, beam scores and top 2K, values and indices bit for bit."""
    host, lo, hi, lp, prev_count, finished, bs = _dense_case(stop_at_count * 2 + always_allow_eos)
    B, K = lo.shape
    V = lp.shape[1]
    cfg = jc.DecodeConfig(num_beams=K, exact_mask=True, stop_at_count=stop_at_count,
                          always_allow_eos=always_allow_eos)
    _, allowed, cand = jc._candidates_general(
        _JaxOps(DeviceFMIndex.from_host(host, vocab=V)), cfg, jnp.asarray(lp), jnp.asarray(lo),
        jnp.asarray(hi), jnp.asarray(prev_count), jnp.asarray(finished))
    cons = jnp.where(allowed, cand, jc.NEG_INF) + jnp.asarray(bs)[..., None]
    jv, ji = lax.top_k(cons.reshape(B, K * V), 2 * K)
    mask = tfm.dense_mask(TorchFMIndex.from_host(host, vocab=V, device="cpu"),
                          torch.as_tensor(lo), torch.as_tensor(hi), cfg.dense_chunk)
    n0 = dense_scores.dense_select.launches
    tv, ti = dense_scores.dense_select(
        mask, torch.as_tensor(lp), torch.as_tensor(prev_count), torch.as_tensor(finished),
        torch.as_tensor(bs), 2 * K, eos=cfg.eos_token_id, pad=cfg.pad_token_id,
        stop_at_count=stop_at_count, always_allow_eos=always_allow_eos)
    assert dense_scores.dense_select.launches == n0  # the CPU runs the plain version
    assert ti.dtype == torch.int64 and tv.shape == (B, 2 * K)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy().view(np.int32), np.asarray(jv).view(np.int32))
    # every branch is taken on these rows
    fin = finished
    stop = (stop_at_count > 0) & (np.where(fin, 0, prev_count) <= stop_at_count)
    assert fin.any() and (~fin & ~stop).any() and (stop.any() or stop_at_count == 0)


def test_dense_select_limits():
    """The wrapper refuses a k past the row and mismatched shapes on the CPU
    as on the card."""
    host, lo, hi, lp, prev_count, finished, bs = _dense_case(9)
    mask = count_mask.pack(torch.zeros((3, 4, 96), dtype=torch.bool))
    args = (mask, torch.as_tensor(lp), torch.as_tensor(prev_count), torch.as_tensor(finished),
            torch.as_tensor(bs))
    with pytest.raises(ValueError, match="width"):
        dense_scores.dense_select(*args, 4 * 96 + 1, eos=2, pad=1)
    with pytest.raises(ValueError, match="lp"):  # 6 rows of log-probs for 12 beams
        dense_scores.dense_select(mask, torch.as_tensor(lp[:6]), *args[2:], 8, eos=2, pad=1)
    with pytest.raises(ValueError, match="count mask"):  # 2 words a beam for a vocab of 96
        dense_scores.dense_select(mask[..., :2], *args[1:], 8, eos=2, pad=1)
    v, i = dense_scores.dense_select(*args, 4 * 96, eos=2, pad=1)  # k = the whole row
    assert torch.equal(i, row_topk.row_topk_plain(dense_scores.dense_scores(*args, eos=2, pad=1),
                                                  4 * 96)[1])


@pytest.mark.parametrize("B,K,V,k,want", [
    (32, 15, 50265, 30, "select"),  # the bench point's dense step
    (1, 8192, 64, 16384, "select"),  # k at the shared sort's limit
    (1, 8193, 64, 16386, "stream_sort"),  # num_beams 8,193: past it
    (32, 1336, 50265, 2672, "select"),  # B * K * V past 2^31, a row below it
    (2, 9000, 50265, 18000, "stream_sort"),
])
def test_dense_route_by_size(B, K, V, k, want):
    """F3: the dense step's route is a function of (B, K, V, k) alone: the
    select up to ``row_topk.MAX_K``, the streaming pass and kernel 3's
    global sort past it, whatever B * K * V."""
    assert dense_scores.route(B, K, V, k) == want


def test_dense_route_limits():
    """A query's row K * V of 2^31 scores or more, and a k outside the row,
    raise with their reasons."""
    with pytest.raises(ValueError, match="2\\^31"):
        dense_scores.route(1, 42724, 50265, 30)
    assert dense_scores.route(1, 42723, 50265, 30) == "select"
    for k in (0, 3 * 96 + 1):
        with pytest.raises(ValueError, match="width"):
            dense_scores.route(2, 3, 96, k)
