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
from seal_tpu_torch.kernels import bucket_counts as k6
from seal_tpu_torch.kernels import count_mask, fm_search, row_topk, triton_logsoftmax, window_gather
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
    t = tdi.TorchFMIndex.from_host(host, vocab=40, dir_shift=shift, device="cpu")
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
        tdi.TorchFMIndex.from_host(Huge(), vocab=50265, device="cpu")


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("keep_text", [False, True])
def test_from_host_keywords_match_jax(compact, keep_text):
    """JAX's ``compact`` and ``keep_text`` keywords, in every combination:
    the port accepts both (``compact`` changes no array, ``keep_text``
    ships no text) and its ops equal JAX's index built with the same
    keywords."""
    host = _zipf_host()
    j = jdi.DeviceFMIndex.from_host(host, 40, compact, False, keep_text)
    t = tdi.TorchFMIndex.from_host(host, 40, compact, False, keep_text, device="cpu")
    assert t.bwt.dtype == torch.int32 and t.sa is None
    assert (j.text is not None) == keep_text
    _eq(np.asarray(j.bwt).astype(np.int32), t.bwt)
    rng = np.random.default_rng(11)
    los, his = _ranges(host, rng)
    toks = rng.integers(-2, 45, size=(los.size, 4)).astype(np.int32)
    for a, b in zip(jops.backward_step(j, toks, los[:, None], his[:, None]),
                    tops.backward_step(t, toks, los[:, None], his[:, None])):
        _eq(a, b)
    _eq(jops.contains_tokens(j, toks, los, his), tops.contains_tokens(t, toks, los, his))
    rows = rng.integers(0, host.size(), size=64).astype(np.int32)
    _eq(jops.bwt_at(j, rows), tops.bwt_at(t, rows))
    for a, b in zip(jops.window_continuations(j, los, his, 8),
                    tops.window_continuations(t, los, his, 8)):
        _eq(a, b)
    _eq(jops.bucket_counts(j, los, his), tops.bucket_counts(t, los, his))


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
    # the support bits the straggler rounds read: JAX's counts > 0
    _assert_support(jops.bucket_counts(j, los, his), tops.bucket_support(t, los, his))
    _assert_support(jops.bucket_counts(j, los[:12].reshape(3, 4), his[:12].reshape(3, 4)),
                    tops.bucket_support(t, los[:12].reshape(3, 4), his[:12].reshape(3, 4)))


def _assert_support(counts, bits):
    """``bits`` (int32 [..., 8]) is the 256-bit support of JAX's counts
    [..., n]: bit b set iff count b > 0, the bits past n 0."""
    counts = np.asarray(counts)
    assert bits.dtype == torch.int32 and bits.shape == counts.shape[:-1] + (8,)
    got = count_mask.unpack(bits, 256).numpy()
    n = counts.shape[-1]
    np.testing.assert_array_equal(got[..., :n], counts > 0)
    assert not got[..., n:].any()


def _oov_host():
    """A corpus with symbols past the 256 buckets of a vocab of 40 (bucket
    size 1): the ids 300, 301 and 700 go to the dropped column."""
    rng = np.random.default_rng(7)
    docs = [rng.integers(0, 30, size=rng.integers(2, 50)).tolist() for _ in range(120)]
    docs[3] += [300, 301, 700]
    docs[9] += [300]
    host = FMIndex()
    host.initialize(docs)
    return host


@pytest.mark.parametrize("where", ["full", "narrow", "block_edges", "oov_rows", "random"])
def test_bucket_support_matches_jax(where):
    """Kernel 6's support mode's plain version == JAX's ``bucket_counts >
    0`` on an index of three bucket blocks with out-of-vocab symbols: the
    full and empty ranges, narrow ones (the kernel's narrow route), ranges
    on the blocks' edges (its wide route), over the dropped symbols' rows
    and at random; the CPU wrapper launches nothing."""
    host = _oov_host()
    j = jdi.DeviceFMIndex.from_host(host, vocab=40)
    t = tdi.TorchFMIndex.from_host(host, vocab=40, device="cpu")
    N = host.size()
    assert 2 * t.bucket_rows < N < 3 * t.bucket_rows
    oov = np.flatnonzero(np.asarray(host.bwt) > 256)
    assert oov.size == 4
    rng = np.random.default_rng(len(where))
    if where == "full":
        los, his = np.array([0, 0, N, 3]), np.array([N, 0, N, N - 3])
    elif where == "narrow":
        a = rng.integers(0, N - 40, size=16)
        los, his = a, a + rng.integers(0, 40, size=16)
    elif where == "block_edges":
        R = t.bucket_rows
        edges = np.array([0, 1, R - 1, R, R + 1, 2 * R - 1, 2 * R, 2 * R + 1, N - 1, N])
        los, his = np.meshgrid(edges, edges)
        keep = los <= his
        los, his = los[keep], his[keep]
    elif where == "oov_rows":
        los, his = np.concatenate([oov, oov - 2]), np.concatenate([oov + 1, oov + 5])
    else:
        a = rng.integers(0, N, size=24)
        los, his = a, rng.integers(a, N + 1)
    los, his = los.astype(np.int32), np.minimum(his, N).astype(np.int32)
    before = k6.bucket_support.launches
    _assert_support(jops.bucket_counts(j, los, his), tops.bucket_support(t, los, his))
    assert k6.bucket_support.launches == before
    _assert_support(jops.bucket_counts(j, los, his), k6.bucket_support_plain(
        t, torch.as_tensor(los), torch.as_tensor(his)))


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
    if rows < 5:  # one row: random ties and signed zeros only
        return x
    x[1] = -np.inf
    x[2, : n // 3] = 7.5  # plateau
    x[3, n - 5 :] = 50.0  # best values at the end
    x[4] = np.float32(jc.NEG_INF)
    x[4, ::7] = -1.0
    return x


# the call sites' (width, k) at few rows: the proven loop's rounds (64,
# 256; sampling 512, 2048), free generation's [B, K * 256] rows, one dense
# [B, K * V] row, and k equal to the width
ROW_TOPK_CASES = [(6, 50265, 64), (24, 960, 30), (8, 158, 30), (5, 300, 256), (5, 50265, 512),
                  (5, 50265, 2048), (6, 3840, 30), (1, 753975, 30), (5, 300, 300)]


@pytest.mark.parametrize("rows,n,k", ROW_TOPK_CASES)
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


def _order_keys(x):
    u = x.view(np.uint32)
    return np.where(u >> 31 == 1, ~u, u | np.uint32(0x80000000)).astype(np.uint32)


def _find_bin(tot, shift, prefix, rank, threads):
    """The block-wide scan of ``csrc/row_topk.cu:find_bin``: thread t holds
    the nb / threads bins below nb - t * nb / threads, counted from the top;
    the thread whose bins reach the rank walks them."""
    nb = tot.size
    per = nb // threads
    sums = tot[::-1].reshape(threads, per).sum(1)  # thread t: bins nb-1-per*t down
    incl = np.cumsum(sums)
    t = int(np.searchsorted(incl, rank))  # the first thread with incl >= rank
    acc = int(incl[t]) - int(sums[t])
    top = nb - 1 - per * t
    for j in range(per):
        c = int(tot[top - j])
        if acc + c >= rank:
            return prefix | ((top - j) << shift), rank - acc
        acc += c
    raise AssertionError("rank past the row")


def _split_select_mirror(x, k, p):
    """Kernel 3's algorithm in numpy: per CTA slice, the three digit passes
    over the matching keys with the bins summed over the cluster, the
    equal-key cut by a prefix of the CTAs' counts, and the leader's sort of
    the (key << 32 | ~index) words."""
    vals, idx = [], []
    for row in x:
        keys = _order_keys(row)
        sl = [keys[c * p.slice:(c + 1) * p.slice] for c in range(p.splits)]
        prefix, mask, rank = 0, 0, k
        for shift, nb in ((21, 2048), (10, 2048), (0, 1024)):
            hists = [np.bincount((s[(s & mask) == prefix] >> shift) & (nb - 1), minlength=nb)
                     for s in sl]
            prefix, rank = _find_bin(sum(hists), shift, prefix, rank, p.threads)
            mask |= (nb - 1) << shift
        eqs = [int(h[prefix & 1023]) for h in hists]
        words, before = [], 0
        for c, s in enumerate(sl):
            take = min(max(rank - before, 0), eqs[c])
            before += eqs[c]
            eq = s == prefix
            sel = (s > prefix) | (eq & (np.cumsum(eq) <= take))
            i = np.nonzero(sel)[0] + c * p.slice
            words.append((s[sel].astype(np.uint64) << np.uint64(32))
                         | (~i.astype(np.uint64) & np.uint64(0xFFFFFFFF)))
        w = np.sort(np.concatenate(words))[::-1]
        assert w.size == k and len(np.unique(w)) == k
        key = (w >> np.uint64(32)).astype(np.uint32)
        u = np.where(key >> 31 == 1, key & np.uint32(0x7FFFFFFF), ~key).astype(np.uint32)
        vals.append(u.view(np.float32))
        idx.append((~w & np.uint64(0xFFFFFFFF)).astype(np.int64))
    return np.stack(vals), np.stack(idx)


@pytest.mark.parametrize("splits", [None, 1, 5, 16])
@pytest.mark.parametrize("rows,n,k", ROW_TOPK_CASES)
def test_row_topk_split_mirror_matches_plain(rows, n, k, splits):
    """The kernel's split-row radix select, rehearsed in numpy at its plan
    and at forced splits, equals the plain version bit for bit."""
    x = _tied_rows(np.random.default_rng(n), rows, n)
    p = row_topk.plan(rows, n, k, splits=splits)
    mv, mi = _split_select_mirror(x, k, p)
    wv, wi = row_topk.row_topk_plain(torch.as_tensor(x), k)
    np.testing.assert_array_equal(mi, wi.numpy())
    np.testing.assert_array_equal(mv.view(np.int32), wv.numpy().view(np.int32))


# (rows, width, k) of every call site at BART-large width, batch 32, beam 15
CALL_SITES = [(480, 50265, 64), (480, 50265, 256), (480, 50265, 512), (480, 50265, 2048),
              (32, 50265, 30), (32, 753975, 30), (32, 3840, 30), (480, 158, 30)]


@pytest.mark.parametrize("rows,n,k", CALL_SITES)
def test_row_topk_plan_fits_the_card(rows, n, k):
    """Each call site's launch fits 227 KB a CTA, stages its slice (each key
    read once), splits 32-row calls of wide rows into about one CTA an SM
    (a row narrower than two ``MIN_SLICE`` slices stays one CTA), and
    keeps the slices in the row."""
    p = row_topk.plan(rows, n, k)
    assert p.smem <= 227 * 1024 - 1024 and p.route == "staged"
    assert p.n2 >= k and p.region >= row_topk.BINS_BYTES and 8 * p.n2 <= max(p.region, 16384)
    assert 1 <= p.splits <= 16 and p.slice * p.splits >= n > p.slice * (p.splits - 1)
    assert p.ctas >= row_topk.FILL_CTAS or rows >= row_topk.FILL_CTAS or n < 2 * row_topk.MIN_SLICE
    assert p.threads in (512, 1024)


def test_row_topk_plan_limits():
    wide = row_topk.plan(32, 32 * 50265, 64)  # a beam-32 dense row
    assert wide.route == "streamed" and wide.splits == 16 and wide.cap > 0
    assert wide.smem <= 227 * 1024 - 1024
    assert row_topk.plan(8, 50265, row_topk.MAX_K).smem <= 227 * 1024 - 1024
    assert row_topk.plan(8, 50265, row_topk.MAX_K).sort == "shared"
    # past the shared sort buffer: the survivors sorted in device memory
    for k in (row_topk.MAX_K + 1, 20000, 50265):
        big = row_topk.plan(480, 50265, k)
        assert big.sort == "global" and big.region == row_topk.BINS_BYTES
        assert big.n2 >= k and big.n2 % row_topk.GTILE == 0 and big.route == "staged"
        assert big.smem <= 227 * 1024 - 1024
    with pytest.raises(ValueError, match="width"):
        row_topk.plan(8, 10, 11)
    with pytest.raises(ValueError, match="cluster"):
        row_topk.plan(8, 5000, 30, splits=17)
    with pytest.raises(ValueError, match="shared memory"):
        row_topk.plan(8, 5000, 30, splits=1, staged=4000, cap=30000)


def _global_sort_mirror(w, k, gtile):
    """``csrc/row_topk.cu:global_sort`` in numpy: ``sort_tile`` (sizes 2 ..
    gtile inside each tile), then for each larger size ``merge_global``
    (strides >= gtile) and ``sort_tile`` (the narrower strides), the
    direction of a pair from its row index's ``size`` bit."""
    rows, n2 = w.shape
    w = w.copy()

    def stage(size, stride, lo):
        hi = lo + stride
        desc = (lo & size) == 0
        a, b = w[:, lo], w[:, hi]
        swap = np.where(desc, a < b, a > b)
        w[:, lo], w[:, hi] = np.where(swap, b, a), np.where(swap, a, b)

    def tiles(lo_size, hi_size):
        size = lo_size
        while size <= hi_size:
            stride = min(size, gtile) // 2
            while stride > 0:
                t = np.arange(gtile // 2)
                local = 2 * t - (t & (stride - 1))
                for t0 in range(0, n2, gtile):
                    stage(size, stride, t0 + local)
                stride //= 2
            size *= 2

    tiles(2, gtile)
    size = 2 * gtile
    while size <= n2:
        stride = size // 2
        while stride >= gtile:
            t = np.arange(n2 // 2)
            stage(size, stride, 2 * t - (t & (stride - 1)))
            stride //= 2
        tiles(size, size)
        size *= 2
    return w[:, :k]


@pytest.mark.parametrize("k,n2,gtile", [(17, 32, 8), (40, 64, 16), (100, 128, 16),
                                        (129, 256, 32)])
def test_row_topk_global_sort_mirror(k, n2, gtile):
    """The large-k route's launch schedule sorts the survivors' unique
    words descending, padding (0) last, at several tile sizes."""
    rng = np.random.default_rng(k)
    w = np.zeros((3, n2), np.uint64)
    for r in range(3):
        w[r, :k] = rng.choice(2**40, size=k, replace=False).astype(np.uint64) + np.uint64(1)
    got = _global_sort_mirror(w, k, gtile)
    np.testing.assert_array_equal(got, np.sort(w, axis=1)[:, ::-1][:, :k])


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
