"""The port's corpus-sharded FM-index against ``seal_tpu``'s, on the CPU
(the shard modes' plain versions): every array of
``ShardedTorchIndex.from_hosts`` equals ``ShardedFMIndex.from_hosts`` on the
same host list (1, 3 and 8 shards, shards with different alphabets), each
``ShardedIndexOps`` method equals JAX's inside a ``shard_map`` over the
8-device CPU mesh (per-shard ranges and merged results exactly), and
``sharded_count_sequences`` / ``sharded_allowed_mask`` equal JAX's and the
host counts.  ``ShardedIndexOps.advance`` (kernel 1's shard step mode)
equals JAX's range update, composed from its ``extend`` and ``range_size``
as ``constrained.py`` composes them, at 1, 2 and 4 shards, at step 0 and
later; a numpy mirror of kernel 1's shard-mode lanes (a team of P groups
of G lanes an item, member p on shards p, p + P, ..., each group's
cooperative search, the team's OR or butterfly sum) equals the plain shard
search at every width the plan can pick.  Also kernel 8's large-n route:
its two-stage plain specification equals ``beam_select_plain`` bit for bit
past the one-block limit."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from seal_tpu.parallel import mesh as mesh_lib
from seal_tpu.parallel import sharded_decode as jsd
from seal_tpu.parallel import sharded_index as jsi
from seal_tpu_torch.kernels import beam_select as kb
from seal_tpu_torch.kernels import fm_search as k1
from seal_tpu_torch.parallel import sharded_decode as tsd
from seal_tpu_torch.parallel import sharded_index as tsi
from test_torch_dense_counts import _assert_mask
from test_torch_fm_ops import _assert_support
from test_torch_kernel_mirrors import _group_search

V = 64


def _docs(seed, n_docs=28):
    """Documents over [4, 40), and a few with tokens up to V - 1: with round
    robin, some shards lack the high symbols (their C is padded)."""
    rng = np.random.default_rng(seed)
    docs = [rng.integers(4, 40, size=rng.integers(4, 24)).tolist() + [2] for _ in range(n_docs)]
    docs[0] = docs[0][:-1] + [V - 1, 50, 2]
    docs[5] = docs[5][:-1] + [45, 45, 2]
    return docs


def _mesh(S):
    return mesh_lib.make_mesh(n_data=S, n_model=1, devices=jax.devices()[:S])


@pytest.fixture(scope="module", params=[2, 4])
def world(request):
    S = request.param
    docs = _docs(S)
    jsi_, hosts, _ = jsi.ShardedFMIndex.build(docs, n_shards=S, vocab=V)
    return S, docs, jsi_, hosts, tsi.ShardedTorchIndex.from_hosts(hosts, V, device="cpu")


# ------------------------------------------------------------------ index


@pytest.mark.parametrize("S", [1, 3, 8])
def test_sharded_index_arrays_equal_jax(S):
    docs = _docs(10 + S)
    j, hosts, _ = jsi.ShardedFMIndex.build(docs, n_shards=S, vocab=V)
    t = tsi.ShardedTorchIndex.from_hosts(hosts, V, device="cpu")
    for name in ("psi", "bwt", "C", "n_rows", "beginnings", "n_docs_shard", "bucket_occ",
                 "corpus_counts"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)).astype(np.int32), name)
    if S > 1:  # the alphabets differ, so some shard's C is padded
        assert len({h.C.size for h in hosts}) > 1
    for name in ("n_shards", "vocab", "search_iters", "n_docs", "bucket_size"):
        assert getattr(t, name) == getattr(j, name), name
    assert t.sigma == j.C.shape[1] - 1 and t.shard_rows == tuple(h.size() for h in hosts)
    np.testing.assert_array_equal(t.sym_dir[..., 0].numpy(), np.asarray(j.C)[:, :-1])
    np.testing.assert_array_equal(t.sym_dir[..., 1].numpy(), np.asarray(j.C)[:, 1:])
    for s in range(S):
        jv, tv = j.shard_view(s), t.shard_view(s)
        for name in ("psi", "bwt", "C", "beginnings", "bucket_occ"):
            np.testing.assert_array_equal(getattr(tv, name).numpy(),
                                          np.asarray(getattr(jv, name)).astype(np.int32))
        for name in ("n_rows", "sigma", "vocab", "n_docs", "search_iters", "bucket_size"):
            assert getattr(tv, name) == getattr(jv, name), name
    assert t.memory_bytes() == sum(
        x.numel() * 4 for x in (t.psi, t.bwt, t.C, t.sym_dir, t.n_rows, t.beginnings,
                                t.n_docs_shard, t.bucket_occ, t.corpus_counts))


def test_sharded_index_defaults_to_cuda_and_refuses_a_mesh(monkeypatch):
    for fn in (tsi.ShardedTorchIndex.from_hosts, tsi.ShardedTorchIndex.build):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__
    docs = _docs(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsi.ShardedTorchIndex.build(docs, 2, V)
    t, _, _ = tsi.ShardedTorchIndex.build(docs, 2, V, device="cpu")
    toks, lens = np.array([[5, 6]], np.int32), np.array([2], np.int32)
    # a mesh the index was not placed on (ShardedTorchIndex.place)
    with pytest.raises(ValueError, match="placed"):
        tsi.sharded_count_sequences(t, "mesh", toks, lens)
    with pytest.raises(ValueError, match="placed"):
        tsi.sharded_allowed_mask(t, "mesh", toks, lens, toks)
    with pytest.raises(ValueError, match="placed"):
        tsd.sharded_fm_index_generate(None, None, t, "mesh", toks)
    with pytest.raises(TypeError, match="ShardedTorchIndex"):
        tsd.sharded_fm_index_generate(None, None, t.shard_view(0), None, toks)


# -------------------------------------------------------------------- ops


def _ranges(t, hosts, rng, B, K):
    """Per-shard ranges [S, B, K]: one- and two-token prefixes of the
    shard's own text, the full range, empty, single-row, one reaching past
    the shard's rows into the padding, and one wider than the window."""
    S = t.n_shards
    lo = np.zeros((S, B, K), np.int32)
    hi = np.zeros((S, B, K), np.int32)
    for s, h in enumerate(hosts):
        n = h.size()
        for b in range(B):
            for k in range(K):
                toks = h.text[rng.integers(0, n - 3) :][:2] - 1
                toks = toks[: rng.integers(1, 3)]
                lo[s, b, k], hi[s, b, k] = h.get_range(list(toks[::-1])) if (toks > 0).all() \
                    else (0, n)
        lo[s, 0, :4] = (0, 5, 3, max(n - 3, 0))
        hi[s, 0, :4] = (n, 5, 4, t.n_max)
    return torch.as_tensor(lo), torch.as_tensor(hi)


def _jax_ops(j, mesh, lo, hi, toks, cands, w, rows_done, chunk):
    """JAX's ``ShardedIndexOps`` inside a test-local ``shard_map`` (the class
    runs only inside one): per-shard extends, and the merged results."""
    from jax import shard_map

    def per_shard(bwt, psi, C, beg, n_rows, bocc, lo, hi, toks, cands):
        dev = jsi._shard_device_index(j, bwt[0], psi[0], C[0], beg[0], None, bocc[0])
        ops = jsd.ShardedIndexOps(dev, n_rows[0])
        l, h = lo[0], hi[0]
        elo, ehi = ops.extend(toks, l, h)
        wt, wv = ops.window(l, h, w)
        return (elo[None], ehi[None], ops.contains(cands, l, h), ops.validate(cands, l, h),
                wt, wv, ops.range_size(l, h), ops.window_exhaustive(l, h, w),
                ops.interval_covered(l, h, rows_done), ops.bucket_counts(l, h),
                ops.dense_counts(l, h, chunk))

    fn = shard_map(per_shard, mesh=mesh, in_specs=(P("data"),) * 8 + (P(), P()),
                   out_specs=(P("data"), P("data")) + (P(),) * 9)
    return jax.device_get(jax.jit(fn)(j.bwt, j.psi, j.C, j.beginnings, j.n_rows, j.bucket_occ,
                             jnp.asarray(lo.numpy()), jnp.asarray(hi.numpy()),
                             jnp.asarray(toks.numpy()), jnp.asarray(cands.numpy())))


def test_sharded_ops_equal_jax(world):
    S, _, j, hosts, t = world
    mesh = _mesh(S)
    rng = np.random.default_rng(S)
    B, K, M, w, rows_done = 3, 5, 9, 4, 6
    lo, hi = _ranges(t, hosts, rng, B, K)
    toks = torch.as_tensor(rng.integers(-1, V + 2, size=(B, K)).astype(np.int32))
    cands = torch.as_tensor(rng.integers(-1, V + 2, size=(B, K, M)).astype(np.int32))
    want = _jax_ops(j.place(mesh), mesh, lo, hi, toks, cands, w, rows_done, chunk=16)
    ops = tsd.ShardedIndexOps(t)
    elo, ehi = ops.extend(toks, lo, hi)
    np.testing.assert_array_equal(elo.numpy(), want[0])
    np.testing.assert_array_equal(ehi.numpy(), want[1])
    np.testing.assert_array_equal(ops.contains(cands, lo, hi).numpy(), want[2])
    np.testing.assert_array_equal(ops.validate(cands, lo, hi).numpy(), want[3])
    np.testing.assert_array_equal(ops.range_size(lo, hi).numpy(), want[6])
    np.testing.assert_array_equal(ops.window_exhaustive(lo, hi, w).numpy(), want[7])
    np.testing.assert_array_equal(ops.interval_covered(lo, hi, rows_done).numpy(), want[8])
    np.testing.assert_array_equal(ops.bucket_counts(lo, hi).numpy(), want[9])
    _assert_support(want[9], ops.bucket_support(lo, hi))  # each shard's bits ORed
    np.testing.assert_array_equal(ops.dense_counts(lo, hi, 16).numpy(), want[10])
    _assert_mask(ops.dense_mask(lo, hi, 16), want[10], V)  # the summed counts > 0
    assert ops.range_size(lo, hi).dtype == torch.int32
    # the union window: shard s's slots [s * w, (s + 1) * w), JAX's -1 read
    # as the port's fill, and the log-probs gathered at the slot's token
    lp = torch.as_tensor(rng.normal(size=(B * K, V)).astype(np.float32))
    fill = 1
    tok, valid, wlp = ops.window_gather(lo, hi, w, lp, fill)
    assert tok.shape == (B, K, S * w)
    np.testing.assert_array_equal(valid.numpy(), want[5])
    np.testing.assert_array_equal(tok.numpy(), np.where(want[5], want[4], fill))
    np.testing.assert_array_equal(
        wlp.numpy(), np.take_along_axis(lp.numpy(), tok.reshape(B * K, -1).numpy(), 1)
        .reshape(tok.shape))
    assert want[5].any() and not want[7].all() and want[2].any()
    # the full range and the forced-prefix ranges
    flo, fhi = ops.full_range((B, K))
    assert flo.shape == (S, B, K) and (fhi == t.n_rows[:, None, None]).all()
    seq = torch.as_tensor(np.array([[hosts[0].text[-3] - 1]], np.int32))
    rlo, rhi = ops.range_for(seq, torch.tensor([1], dtype=torch.int32))
    for s, h in enumerate(hosts):
        assert (int(rlo[s, 0]), int(rhi[s, 0])) == h.get_range(seq[0].tolist())


def test_sharded_count_and_allowed_equal_jax(world):
    S, docs, j, hosts, t = world
    mesh = _mesh(S)
    jp = j.place(mesh)
    rng = np.random.default_rng(7)
    n, L = 40, 5
    toks = np.zeros((n, L), np.int32)
    lens = rng.integers(0, L + 1, size=n).astype(np.int32)
    for i in range(n):
        d = docs[rng.integers(len(docs))]
        a = rng.integers(0, max(len(d) - L, 1))
        toks[i, : len(d[a : a + L])] = d[a : a + L]
    toks[:5] = rng.integers(0, V + 3, size=(5, L))  # mostly absent, some out of vocab
    cands = rng.integers(-1, V + 2, size=(n, 7)).astype(np.int32)
    got = tsi.sharded_count_sequences(t, None, toks, lens)
    want = np.asarray(jsi.sharded_count_sequences(jp, mesh, toks, lens))
    np.testing.assert_array_equal(got.numpy(), want)
    host = [sum(h.get_count(list(toks[i, : lens[i]])) for h in hosts) for i in range(n)]
    np.testing.assert_array_equal(got.numpy(), host)
    assert (got > 0).sum() > 20
    allowed = tsi.sharded_allowed_mask(t, None, toks, lens, cands)
    np.testing.assert_array_equal(
        allowed.numpy(), np.asarray(jsi.sharded_allowed_mask(jp, mesh, toks, lens, cands)))
    assert allowed.dtype == torch.int32 and (allowed > 0).any()


# ------------------------------------------- kernel 1's shard step mode

EOS, PAD = 2, 1


def _jax_advance(j, mesh, lo, hi, sel_tok, sel_par, finished, step0):
    """JAX's range update inside the harness's ``shard_map``: ``extend`` of
    the parents' ranges and the summed ``range_size`` gathered at the
    parents (``constrained.py:1340-1349`` at step 0), and the stop rule
    after (:1416-1430)."""
    from jax import shard_map

    def per_shard(bwt, psi, C, beg, n_rows, bocc, lo, hi, tok, par, fin):
        dev = jsi._shard_device_index(j, bwt[0], psi[0], C[0], beg[0], None, bocc[0])
        ops = jsd.ShardedIndexOps(dev, n_rows[0])
        rows = jnp.arange(tok.shape[0])[:, None]
        prev = ops.range_size(lo[0], hi[0])[rows, par]
        elo, ehi = ops.extend(tok, lo[0][rows, par], hi[0][rows, par])
        if not step0:
            stop = (tok == EOS) | (tok == PAD)
            elo, ehi = jnp.where(stop, 0, elo), jnp.where(stop, 0, ehi)
            elo, ehi = jnp.where(fin[rows, par], 0, elo), jnp.where(fin[rows, par], 0, ehi)
        return elo[None], ehi[None], prev

    fn = shard_map(per_shard, mesh=mesh, in_specs=(P("data"),) * 8 + (P(),) * 3,
                   out_specs=(P("data"), P("data"), P()))
    return jax.device_get(jax.jit(fn)(j.bwt, j.psi, j.C, j.beginnings, j.n_rows, j.bucket_occ,
                                      *(jnp.asarray(np.asarray(x)) for x in (
                                          lo, hi, sel_tok, sel_par, finished))))


def _selections(rng, B, K):
    """A step's selections: tokens of [4, 40), EOS, PAD, -1 and past the
    vocab; random parents, a quarter finished."""
    sel_tok = rng.integers(4, 40, size=(B, K)).astype(np.int32)
    sel_tok[0, :5] = (EOS, PAD, -1, V, V + 1)
    sel_par = rng.integers(0, K, size=(B, K)).astype(np.int32)
    finished = rng.random((B, K)) < 0.25
    return sel_tok, sel_par, finished


@pytest.fixture(scope="module")
def world1():
    """The world's corpus as one shard (S = 1)."""
    docs = _docs(2)
    j, hosts, _ = jsi.ShardedFMIndex.build(docs, n_shards=1, vocab=V)
    return 1, docs, j, hosts, tsi.ShardedTorchIndex.from_hosts(hosts, V, device="cpu")


def _check_advance(w, step0):
    S, _, j, hosts, t = w
    mesh = _mesh(S)
    rng = np.random.default_rng(30 + S + step0)
    B, K = 3, 6
    lo, hi = _ranges(t, hosts, rng, B, K)
    sel_tok, sel_par, finished = _selections(rng, B, K)
    if step0:
        lo, hi = lo[..., :1].contiguous(), hi[..., :1].contiguous()
        sel_par[:] = 0
    want = _jax_advance(j.place(mesh), mesh, lo, hi, sel_tok, sel_par, finished, step0)
    n0, a0 = k1.fm_search_sharded.launches, k1.ADVANCE_SHARDED.launches
    tt = [torch.as_tensor(x) for x in (sel_tok, sel_par, finished)]
    got = tsd.ShardedIndexOps(t).advance(tt[0], tt[1], lo, hi, None if step0 else tt[2],
                                         eos=EOS, pad=PAD)
    assert (k1.fm_search_sharded.launches, k1.ADVANCE_SHARDED.launches) == (n0, a0)
    assert [x.dtype for x in got] == [torch.int32] * 3 and got[0].shape == (S, B, K)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (np.asarray(want[1]) > np.asarray(want[0])).any() and (np.asarray(want[1]) == 0).any()


@pytest.mark.parametrize("step0", [True, False])
def test_sharded_advance_equals_jax(world, step0):
    """The port's range update (kernel 1's shard step mode; on the CPU its
    plain version) equals JAX's composition exactly over 2 and 4 shards:
    each shard's extended ranges and the summed parent range size, at step
    0 (one parent a query, no stop rule) and later (EOS, PAD, finished
    parents), over empty ranges, ranges into the padding and tokens -1 and
    past the vocab; no launch is counted on the CPU."""
    _check_advance(world, step0)


@pytest.mark.parametrize("step0", [True, False])
def test_sharded_advance_one_shard_equals_jax(world1, step0):
    """The same over one shard."""
    _check_advance(world1, step0)


def _member_search(psi, sym_dir, s, c, pos, H):
    """One group's cooperative search of shard s's block of symbol c (no
    head directory: the whole block) at pos, H pivots a level."""
    return _group_search(psi[s], int(sym_dir[s, c, 0]), int(sym_dir[s, c, 1]), pos, H)


def _butterfly(lanes, op):
    """The team's merge: __shfl_xor_sync over its P groups (a ballot for
    the OR: the same result)."""
    off = 1
    while off < len(lanes):
        lanes = [op(lanes[p], lanes[p ^ off]) for p in range(len(lanes))]
        off <<= 1
    return lanes[0]


def _shard_mirror(t, mode, toks, lo, hi, G, P, sel=None):
    """``contains_sharded_kernel`` / ``step_sharded_kernel`` as their lanes
    run them: an item's team of P groups, member p on shards p, p + P, ...;
    membership by one search of G lanes at lo, counts and steps by G / 2
    lanes a bound.  ``sel``: (sel_par, finished or None) for the step
    mode."""
    psi, sym_dir, S = t.psi.numpy(), t.sym_dir.numpy(), t.n_shards
    lo, hi = lo.numpy(), hi.numpy()

    def step(s, c, a, b):
        if not 1 <= c < t.sigma:
            return 0, 0
        r = [_member_search(psi, sym_dir, s, c, pos, G // 2) for pos in (a, b)]
        return r[0], max(r)

    if mode in ("contains", "validate"):
        out = np.zeros(toks.shape, np.int64)
        for i in np.ndindex(*toks.shape):
            r, c = i[:-1], int(toks[i]) + 1
            lanes = []
            for p in range(P):
                acc = 0
                for s in range(p, S, P):
                    a, b = int(lo[(s, *r)]), int(hi[(s, *r)])
                    if not 1 <= c < t.sigma:
                        continue
                    if mode == "validate":
                        x, y = step(s, c, a, b)
                        acc += y - x
                    else:
                        row = _member_search(psi, sym_dir, s, c, a, G)
                        acc |= row < sym_dir[s, c, 1] and psi[s, row] < b
                lanes.append(acc)
            out[i] = _butterfly(lanes, (lambda x, y: x + y) if mode == "validate"
                                else (lambda x, y: x | y))
        return out
    # the backward step (sel None) or the step mode: shard s's (parent)
    # range extended by the token, the parents' sizes summed by the team
    B, K = toks.shape
    out_lo, out_hi = np.zeros((S, B, K), np.int64), np.zeros((S, B, K), np.int64)
    count = np.zeros((B, K), np.int64)
    for b, k in np.ndindex(B, K):
        tok = int(toks[b, k])
        par = (b, k) if sel is None else (b, int(sel[0][b, k]))
        stop = sel is not None and sel[1] is not None and (
            tok in (EOS, PAD) or bool(sel[1][par]))
        lanes = []
        for p in range(P):
            total = 0
            for s in range(p, S, P):
                a, h = int(lo[(s, *par)]), int(hi[(s, *par)])
                out_lo[s, b, k], out_hi[s, b, k] = (0, 0) if stop else step(s, tok + 1, a, h)
                total += h - a
            lanes.append(total)
        count[b, k] = _butterfly(lanes, lambda x, y: x + y)
    return out_lo, out_hi, count


def test_shard_modes_mirror_matches_plain(world):
    """The mirror of kernel 1's shard-mode lanes at every group width and
    team the plan can pick (and a team narrower than the shards: a member
    loops over its shards) equals the plain shard search in its four modes:
    backward step, membership, counts and the step mode."""
    S, _, _, hosts, t = world
    rng = np.random.default_rng(40 + S)
    B, K, M = 2, 5, 7
    lo, hi = _ranges(t, hosts, rng, B, K)
    cands = torch.as_tensor(rng.integers(-1, V + 2, size=(B, K, M)).astype(np.int32))
    cands[..., 0] = torch.as_tensor(hosts[0].text[1 : 1 + K] - 1)
    sel_tok, sel_par, finished = _selections(rng, B, K)
    tok = torch.as_tensor(sel_tok)
    want = {m: k1.fm_search_sharded_plain(t, m, cands, lo, hi) for m in ("contains", "validate")}
    want_step = k1.fm_search_sharded_plain(t, "backward_step", tok, lo, hi)
    want_adv = k1.advance_sharded_plain(t, tok, torch.as_tensor(sel_par), lo, hi,
                                        torch.as_tensor(finished), eos=EOS, pad=PAD)
    plans = {k1.shard_plan(1, 132, S, group=G) for G in k1.GROUPS} | {(16, 1)}
    assert {G for G, _ in plans} == set(k1.GROUPS)
    for G, P in sorted({k1.shard_plan(1, 132, S, group=G, contains=True)
                        for G in k1.CONTAINS_GROUPS}):  # one lane a shard too
        np.testing.assert_array_equal(_shard_mirror(t, "contains", cands.numpy(), lo, hi, G, P),
                                      want["contains"].numpy().astype(np.int64))
    for G, P in sorted(plans):
        for m, w in want.items():
            np.testing.assert_array_equal(_shard_mirror(t, m, cands.numpy(), lo, hi, G, P),
                                          w.numpy().astype(np.int64))
        got = _shard_mirror(t, "backward_step", sel_tok, lo, hi, G, P)
        for a, b in zip(got, want_step):
            np.testing.assert_array_equal(a, b.numpy())
        got = _shard_mirror(t, "advance", sel_tok, lo, hi, G, P, (sel_par, finished))
        for a, b in zip(got, want_adv):
            np.testing.assert_array_equal(a, b.numpy())
    assert want["contains"].any() and (want["validate"] > 1).any()


def test_shard_plan_rule():
    """Kernel 1's shard plan: kernel 5's rule (P the power of two holding
    the shards, at most 16; G the widest whose grid keeps within the lanes
    budget, never below 2) over SHARD_LANES_PER_SM; a forced G cuts P.  The
    membership mode: one lane a shard too (P up to 32) under
    CONTAINS_LANES_PER_SM."""
    budget = 132 * k1.SHARD_LANES_PER_SM
    for S in (1, 2, 3, 4, 8, 17):
        want_P = min(1 << (S - 1).bit_length(), 16)
        for n in (1, 480, 1024, 31_200, 10 ** 6):
            fits = [g for g in k1.GROUPS if g * want_P <= 32 and n * want_P * g <= budget]
            assert k1.shard_plan(n, 132, S) == (max(fits, default=2), want_P), (n, S)
            for g in k1.GROUPS:
                assert k1.shard_plan(n, 132, S, group=g) == (g, min(want_P, 32 // g))
        for n in (1, 480, 8_000, 31_200):  # membership: its widths and budget
            P = min(1 << (S - 1).bit_length(), 32)
            fits = [g for g in k1.CONTAINS_GROUPS
                    if g * P <= 32 and n * P * g <= 132 * k1.CONTAINS_LANES_PER_SM]
            assert k1.shard_plan(n, 132, S, contains=True) == (max(fits, default=1), P)
    with pytest.raises(ValueError, match="group of 3"):
        k1.shard_plan(5, 132, 4, group=3)
    with pytest.raises(ValueError, match="group of 1"):
        k1.shard_plan(5, 132, 4, group=1)


# ------------------------------------------------- kernel 8, large-n route


@pytest.mark.parametrize("ties,keep_invalid", [(False, False), (True, False), (False, True)])
def test_beam_select_large_route_plain_equals_plain(ties, keep_invalid):
    """Beam 32 over a 4-shard union window of 128 rows a shard: 18,496
    candidates a query, past the one-block sort's shared memory.  The
    two-stage specification (each beam's top 2K, then the query's finish)
    equals ``beam_select_plain``'s outputs and soundness flags bit for
    bit, with repeated tokens, ties, dead beams and masked slots."""
    rng = np.random.default_rng(int(ties) + 2 * int(keep_invalid))
    B, K, w, Vl = 2, 32, 4 * 128, 3000
    n_buf = 2 * K
    assert K * (n_buf + w + 2) == 18_496
    lp = np.round(rng.normal(-6, 2, size=(B * K, Vl)), 1).astype(np.float32)
    lp[:, 5] = 0.0
    rows = np.arange(B * K).reshape(B, K, 1)
    btok = rng.integers(0, 400, size=(B, K, n_buf)).astype(np.int32)
    win_valid = rng.random((B, K, w)) < 0.6
    win_tok = np.where(win_valid, rng.integers(0, 400, size=(B, K, w)), 1).astype(np.int32)
    bs = (np.round(rng.normal(-3, 1, size=(B, K)) * 2) / 2).astype(np.float32)
    bs[0, 3] = kb.NEG_INF
    bs[1, :] = bs[1, 0]  # cross-beam ties
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))  # noqa: E731
    args = ((t(btok), t(lp[rows, btok]), t(rng.random((B, K, n_buf)) < 0.7)), n_buf, t(win_tok),
            t(win_valid), t(lp[rows, win_tok]), t(rng.random((B, K, 1)) < 0.5), t(lp),
            t(rng.integers(0, 6, size=(B, K)).astype(np.int32)), t(rng.random((B, K)) < 0.2),
            t(bs), t(rng.random((B, K)) < 0.5),
            t(np.round(rng.normal(-4, 1, size=(B, K))).astype(np.float32)))
    kw = dict(K=K, eos=2, pad=1, stop_at_count=0, always_allow_eos=False, ties=ties,
              keep_invalid=keep_invalid)
    (got, gbad), (want, wbad) = kb.beam_select_large_plain(*args, **kw), \
        kb.beam_select_plain(*args, **kw)
    for a, b in zip(got + (gbad,), want + (wbad,)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert gbad.any() or not wbad.any()
