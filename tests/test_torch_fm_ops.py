"""The torch port's FM-index layer against the JAX package: index arrays,
numpy builders and every FM op, exactly equal on the ``test_fm_ops``
corpora, with the head directory on and off and with empty, full and
end-of-index ranges.  Also the plain versions of the decode kernels (row
top-k, log-softmax, fused window gather) against their JAX counterparts.

On the CPU each kernel wrapper runs its plain version; the kernels
themselves are held to those on the card by ``test_torch_cuda.py`` and by
``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from seal_tpu.decoding import constrained as jc
from seal_tpu.index import FMIndex
from seal_tpu.index import device_index as jdi
from seal_tpu.ops import fm_ops as jops
from seal_tpu_torch.decoding import constrained as tc
from seal_tpu_torch.index import device_index as tdi
from seal_tpu_torch.kernels import fm_search, row_topk, triton_logsoftmax, window_gather
from seal_tpu_torch.ops import fm_ops as tops


def _zipf_host():
    rng = np.random.default_rng(5)
    toks = (rng.zipf(1.2, size=6000) % 28 + 4).astype(np.int64)
    host = FMIndex()
    host.initialize([d.tolist() for d in np.array_split(toks, 120)])
    return host


def _small_host():
    rng = np.random.default_rng(7)
    docs = [rng.integers(0, 30, size=rng.integers(2, 50)).tolist() for _ in range(25)]
    host = FMIndex()
    host.initialize(docs)
    return host


# (host builder, dir_shift): head directory pinned on, pinned off (no
# symbol exceeds 2^31 rows), and the auto-tuned default on a uniform corpus
VARIANTS = {"dir": (_zipf_host, 6), "nodir": (_zipf_host, 31), "auto": (_small_host, None)}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def pair(request):
    build, shift = VARIANTS[request.param]
    host = build()
    j = jdi.DeviceFMIndex.from_host(host, vocab=40, dir_shift=shift)
    t = tdi.TorchFMIndex.from_host(host, vocab=40, dir_shift=shift)
    return request.param, host, j, t


def _ranges(host, rng, n=48):
    """Corpus ranges, random sub-intervals, and degenerate ones."""
    N = host.size()
    text = (host.text[:-1] - 1).tolist()
    los, his = [], []
    for _ in range(n // 2):
        i = int(rng.integers(0, len(text) - 2))
        lo, hi = host.get_range(text[i : i + int(rng.integers(1, 3))])
        los.append(lo)
        his.append(hi)
    for _ in range(n // 2 - 4):
        a = int(rng.integers(0, N))
        los.append(a)
        his.append(int(rng.integers(a, N + 1)))
    los += [0, 5, N, 0]
    his += [N, 5, N, 0]  # full, empty, empty at the end, (0, 0)
    return np.asarray(los, np.int32), np.asarray(his, np.int32)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_index_arrays_match_device_index(pair):
    name, host, j, t = pair
    assert t.psi.dtype == t.bwt.dtype == torch.int32
    for field in ("psi", "bwt", "C", "sym_dir", "bucket_occ", "corpus_counts", "beginnings"):
        _eq(np.asarray(getattr(j, field)).astype(np.int32), getattr(t, field))
    assert (j.head_pair is None) == (t.head_pair is None)
    if t.head_pair is not None:
        _eq(j.head_pair, t.head_pair)
    assert (name == "dir") == (t.head_pair is not None)
    for field in ("n_rows", "sigma", "vocab", "n_docs", "search_iters", "dir_shift",
                  "bucket_rows", "bucket_size", "n_buckets"):
        assert getattr(t, field) == getattr(j, field), field
    lo, hi = t.full_range((2, 3))
    assert lo.shape == (2, 3) and int(hi[0, 0]) == host.size()


@pytest.mark.parametrize("shift", [None, 4, 6, 31])
def test_numpy_builders_match_jax(shift):
    host = _zipf_host()
    psi, C, n = np.asarray(host.psi), np.asarray(host.C), host.size()
    got = tdi.build_head_directory(psi, C, n, shift)
    want = jdi.build_head_directory(psi, C, n, shift)
    for a, b in zip(got, want):
        if a is None or b is None:
            assert a is None and b is None
        else:
            np.testing.assert_array_equal(a, b)
    for sigma_global in (41, 29, 300):
        np.testing.assert_array_equal(
            tdi.build_bucket_occ(host.bwt, sigma_global)[0],
            jdi.build_bucket_occ(host.bwt, sigma_global)[0],
        )
        assert (tdi.build_bucket_occ(host.bwt, sigma_global)[1]
                == jdi.build_bucket_occ(host.bwt, sigma_global)[1])


def test_int32_row_guard_raises_cleanly():
    class Huge:
        def size(self):
            return 2**31

    with pytest.raises(ValueError, match="sharded index"):
        tdi.TorchFMIndex.from_host(Huge(), vocab=50265)


def test_backward_step_matches_jax(pair):
    _, host, j, t = pair
    rng = np.random.default_rng(1)
    los, his = _ranges(host, rng)
    toks = rng.integers(-2, 45, size=(los.size, 6)).astype(np.int32)
    toks[:, -1] = 39  # largest in-vocab id
    args = (toks, los[:, None], his[:, None])
    for a, b in zip(jops.backward_step(j, *args), tops.backward_step(t, *args)):
        _eq(a, b)
    for a, b in zip(jops.extend_ranges(j, toks[:, 0], los, his),
                    tops.extend_ranges(t, toks[:, 0], los, his)):
        _eq(a, b)


def test_contains_tokens_matches_jax(pair):
    _, host, j, t = pair
    rng = np.random.default_rng(2)
    los, his = _ranges(host, rng)
    cands = rng.integers(-2, 45, size=(los.size, 9)).astype(np.int32)
    cands[:, -1] = 39
    got = tops.contains_tokens(t, cands, los, his)
    assert got.dtype == torch.bool
    _eq(jops.contains_tokens(j, cands, los, his), got)
    _eq(jops.validate_tokens(j, cands, los, his), tops.validate_tokens(t, cands, los, his))


def test_rank_and_sequences_match_host(pair):
    _, host, j, t = pair
    rng = np.random.default_rng(3)
    n = host.size()
    symbols = rng.integers(0, host.C.size - 1, size=128).astype(np.int32)
    positions = rng.integers(0, n + 1, size=128).astype(np.int32)
    want = [host.occ(int(s), int(p)) for s, p in zip(symbols, positions)]
    np.testing.assert_array_equal(tops.rank(t, symbols, positions).numpy(), want)
    pats = [rng.integers(0, 34, size=rng.integers(1, 5)).tolist() for _ in range(40)]
    pats.append([999])  # out of the index alphabet
    L = max(len(p) for p in pats)
    tk = np.zeros((len(pats), L), np.int32)
    lens = np.array([len(p) for p in pats], np.int32)
    for i, p in enumerate(pats):
        tk[i, : len(p)] = p
    lo, hi = tops.range_for_sequences(t, tk, lens)
    jlo, jhi = jops.range_for_sequences(j, tk, lens)
    _eq(jlo, lo)
    _eq(jhi, hi)
    cnt = tops.count_sequences(t, tk, lens)
    assert cnt.tolist() == [host.get_count(p) for p in pats]


@pytest.mark.parametrize("L", [1, 5, 16])
def test_sequences_match_jax_and_host(pair, L):
    """Kernel 5's plain version (``range_for_sequences``/``count_sequences``)
    == JAX's scan and host ``get_count``, at every length 0..L: corpus
    n-grams (non-empty ranges that may empty out), random tokens (empty
    ranges that stay empty) and out-of-vocab tokens (reset to (0, 0))."""
    _, host, j, t = pair
    rng = np.random.default_rng(10 + L)
    text = (host.text[:-1] - 1).tolist()  # the documents, each reversed
    seqs = []
    for _ in range(30):
        i = int(rng.integers(0, len(text) - L))
        seqs.append(text[i : i + L][::-1])
    seqs += [rng.integers(0, 34, size=L).tolist() for _ in range(10)]
    oov = [list(s) for s in seqs[:6]]
    for k, s in enumerate(oov):
        s[k % L] = 999 if k % 2 else -2
    seqs += oov
    tk = np.asarray(seqs, np.int32)
    n = len(seqs)
    lens = (np.arange(n) % (L + 1)).astype(np.int32)  # every length 0..L
    lo, hi = tops.range_for_sequences(t, tk, lens)
    jlo, jhi = jops.range_for_sequences(j, tk, lens)
    _eq(jlo, lo)
    _eq(jhi, hi)
    assert ((hi - lo) > 0).sum() >= 30 and ((hi - lo) == 0).any()
    cnt = tops.count_sequences(t, tk, lens)
    _eq(jops.count_sequences(j, tk, lens), cnt)
    assert cnt.tolist() == [host.get_count(s[:n_]) for s, n_ in zip(seqs, lens.tolist())]
    before = fm_search.fm_sequences.launches
    assert torch.equal(fm_search.fm_sequences(t, torch.as_tensor(tk), torch.as_tensor(lens))[0],
                       lo)
    assert fm_search.fm_sequences.launches == before  # CPU: the plain version


def test_bucket_counts_block_edges_match_jax(pair):
    """Kernel 6's plain version == JAX at ranges that start and end inside
    a bucket block and on its edges, and over the sentinel's row."""
    _, host, j, t = pair
    N, R = host.size(), t.bucket_rows
    sentinel = int(np.flatnonzero(np.asarray(host.bwt) == 0)[0])
    edges = [0, 1, R - 1, R, R + 1, 2 * R - 1, 2 * R, N - 1, N]
    edges = [e for e in edges if 0 <= e <= N]
    los, his = [], []
    for a in edges:
        for b in edges:
            if a <= b:
                los.append(a)
                his.append(b)
    los += [sentinel, sentinel, max(sentinel - 3, 0), 0, 5]
    his += [sentinel + 1, N, sentinel + 7, -4, N + 9]  # clamped to [0, N]
    los, his = np.asarray(los, np.int32), np.asarray(his, np.int32)
    got = tops.bucket_counts(t, los, his)
    _eq(jops.bucket_counts(j, los, his), got)
    assert int(got[-5, 0]) == 1  # the sentinel row counts in bucket 0
    # the [B, K] ranges of the decode loop
    _eq(jops.bucket_counts(j, los[:12].reshape(3, 4), his[:12].reshape(3, 4)),
        tops.bucket_counts(t, los[:12].reshape(3, 4), his[:12].reshape(3, 4)))


@pytest.mark.parametrize("w", [4, 16])
def test_window_continuations_matches_jax(pair, w):
    _, host, j, t = pair
    los, his = _ranges(host, np.random.default_rng(4))
    for a, b in zip(jops.window_continuations(j, los, his, w),
                    tops.window_continuations(t, los, his, w)):
        _eq(a, b)


def test_bucket_counts_matches_jax(pair):
    _, host, j, t = pair
    los, his = _ranges(host, np.random.default_rng(5))
    assert tops.bucket_counts_width(t) == jops.bucket_counts_width(j)
    _eq(jops.bucket_counts(j, los, his), tops.bucket_counts(t, los, his))


@pytest.mark.parametrize("w,fill", [(4, 1), (16, 0)])
def test_window_gather_plain_matches_jax_slots(pair, w, fill):
    """Kernel 2's plain version == the JAX window + take_along_axis of lp
    (``_exact_slots`` with the pad fill, the merge_round slab with 0)."""
    _, host, j, t = pair
    los, his = _ranges(host, np.random.default_rng(6))
    lp = np.random.default_rng(7).normal(size=(los.size, 40)).astype(np.float32)
    jt, jv = jops.window_continuations(j, los, his, w)
    jt = jnp.where(jv, jt, fill)
    jl = jnp.take_along_axis(jnp.asarray(lp), jt, axis=-1)
    before = window_gather.window_gather.launches
    tok, valid, tlp = window_gather.window_gather(
        t, torch.as_tensor(los), torch.as_tensor(his), w, torch.as_tensor(lp), fill
    )
    assert window_gather.window_gather.launches == before  # CPU: no launch
    assert tok.dtype == torch.int32 and valid.dtype == torch.bool
    _eq(jt, tok)
    _eq(jv, valid)
    _eq(jl, tlp)


def _tied_rows(rng, rows, n):
    x = np.round(rng.normal(0, 2, size=(rows, n)), 1).astype(np.float32)
    x[1] = -np.inf
    x[2, : n // 3] = 7.5  # plateau
    x[3, n - 5 :] = 50.0  # best values at the end
    x[4] = np.float32(jc.NEG_INF)
    x[4, ::7] = -1.0
    return x


@pytest.mark.parametrize("rows,n,k", [(6, 50265, 64), (24, 960, 30), (8, 158, 30), (5, 300, 256)])
def test_row_topk_plain_matches_lax_top_k(rows, n, k):
    x = _tied_rows(np.random.default_rng(n), rows, n)
    jv, ji = lax.top_k(jnp.asarray(x), k)
    tv, ti = row_topk.row_topk(torch.as_tensor(x), k)
    assert ti.dtype == torch.int64
    _eq(ji, ti)
    _eq(jv, tv)
    # leading dims fold like the JAX call sites' [B, K, n] operands
    tv3, ti3 = row_topk.row_topk(torch.as_tensor(x).reshape(1, rows, n), k)
    _eq(ji, ti3[0])


@pytest.mark.parametrize("cur_len", [1, 3])
def test_log_softmax_plain_matches_jax(cur_len):
    """Kernel 4's plain version == JAX ``_log_softmax`` + ``_apply_min_length``
    (ban EOS while cur_len < min_length 3), to f32 rounding."""
    rng = np.random.default_rng(cur_len)
    logits = (rng.normal(size=(12, 500)) * 4).astype(np.float32)
    logits[:, 1] = -np.inf  # apply_seal_logits_bias columns
    jcfg = jc.DecodeConfig(min_length=3)
    want = np.asarray(jc._apply_min_length(jc._log_softmax(jnp.asarray(logits)), cur_len, jcfg))
    got = tc._log_softmax(torch.as_tensor(logits), cur_len, tc.DecodeConfig(min_length=3))
    assert got.dtype == torch.float32
    # the two frameworks round the max-shift and log-sum differently: one
    # f32 ulp of values up to ~30 is 1.9e-6
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert (got[:, 2] == tc.NEG_INF).all().item() == (cur_len < 3)


def test_wrappers_count_no_launch_on_cpu(pair):
    _, host, _, t = pair
    counts = [fn.launches for fn in (fm_search.fm_search, row_topk.row_topk,
                                     triton_logsoftmax.log_softmax_ban)]
    tops.backward_step(t, [3], [0], [host.size()])
    tops.contains_tokens(t, [[3, 4]], [0], [host.size()])
    row_topk.row_topk(torch.zeros(2, 5), 3)
    triton_logsoftmax.log_softmax_ban(torch.zeros(2, 5), -1, tc.NEG_INF)
    assert counts == [fn.launches for fn in (fm_search.fm_search, row_topk.row_topk,
                                             triton_logsoftmax.log_softmax_ban)]
