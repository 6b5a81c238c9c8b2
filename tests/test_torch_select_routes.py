"""Kernel 8's selection routes and merge past shared memory, and kernel 1's
cooperative search and step mode, as their algorithms in plain torch or
numpy on the CPU (the kernels themselves run only on the card,
``tests/test_torch_cuda.py``):

* the warp route's two stages (each beam's sorted top 2K, then a
  survivor's rank across the lists: ``beam_select_warp_plain``) equal to
  ``beam_select_plain`` bit for bit, across ties, ``keep_invalid``, the
  soundness flags, the branches and duplicate tokens;
* the table routes (F1, F2): the merge's device-memory route
  (``beam_merge_table_plain``) at a 3,000-wide buffer under ties and a
  10,000-wide one without, and the selection's (``beam_select_large_plain``
  with ``chunk``) at 20,034 candidates a beam, over a 60,000-token vocab
  with duplicate tokens, equal to the one-block plain versions;
* kernel 1's cooperative search (G pivots a level, one ballot, a final
  contiguous load) mirrored in numpy against ``np.searchsorted``;
* the step mode's plain version (``advance_plain`` and the adapters'
  ``advance``) against JAX's ``ops.extend`` and stop rule
  (``seal_tpu/decoding/constrained.py:1416-1430``; step 0 :1344-1349) on
  the Psi, compact and sharded layouts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from seal_tpu.decoding import constrained as jc
from seal_tpu.index.device_index import DeviceFMIndex
from seal_tpu.index.wavelet import WaveletFMIndex
from seal_tpu.parallel import mesh as mesh_lib
from seal_tpu.parallel import sharded_decode as jsd
from seal_tpu.parallel import sharded_index as jsi
from seal_tpu_torch.decoding import constrained as tc
from seal_tpu_torch.index.device_index import TorchFMIndex
from seal_tpu_torch.index.fm_index import FMIndex
from seal_tpu_torch.index.wavelet import WaveletIndex
from seal_tpu_torch.kernels import beam_select as k8
from seal_tpu_torch.kernels import fm_search as k1
from seal_tpu_torch.kernels.row_topk import row_topk_plain
from seal_tpu_torch.parallel import sharded_decode as tsd
from seal_tpu_torch.parallel import sharded_index as tsi

EOS, PAD = 2, 1


def _same(got, want):
    """Every output equal; floats bit for bit."""
    for a, b in zip(got, want):
        if a is None and b is None:
            continue
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


def _lp(g, rows, V):
    """Log-prob rows rounded to 0.25 (ties), with +0.0 and -0.0 and a -inf
    PAD column in some rows."""
    lp = torch.round(torch.log_softmax(torch.randn(rows, V, generator=g) * 2, -1) * 4) / 4
    lp[:, 5] = 0.0
    lp[::2, 6] = -0.0
    lp[::3, PAD] = float("-inf")
    return lp


def _select_args(seed, B, K, n_buf, w, V, tok_hi, case):
    """``beam_select``'s inputs: buffer and window tokens drawn from
    [0, tok_hi) (duplicates within and across them), ties, a dead beam,
    finished and stop-triggered beams."""
    g = torch.Generator().manual_seed(seed)
    lp = _lp(g, B * K, V)

    def take(tok):
        return torch.gather(lp, 1, tok.reshape(B * K, -1).long()).reshape(tok.shape)

    btok = torch.randint(0, tok_hi, (B, K, n_buf), generator=g, dtype=torch.int32)
    buf = (btok, take(btok), torch.rand(B, K, n_buf, generator=g) < 0.7)
    if case == "no_buffer":
        buf = None
    win_valid = torch.rand(B, K, w, generator=g) < 0.7
    win_tok = torch.where(win_valid, torch.randint(0, tok_hi, (B, K, w), generator=g,
                                                   dtype=torch.int32), PAD)
    eos_ok = (torch.rand(B, K, 3, generator=g) < 0.5)[..., 2:]
    prev_count = torch.randint(0, 6, (B, K), generator=g, dtype=torch.int32)
    finished = torch.rand(B, K, generator=g) < 0.2
    bs = torch.round(torch.randn(B, K, generator=g) * 2) / 2 - 3
    bs[0, min(1, K - 1)] = k8.NEG_INF  # a dead beam
    need = torch.rand(B, K, generator=g) < 0.5
    th_lp = torch.round(torch.randn(B, K, generator=g)) - 4
    if case == "no_flags":
        need = th_lp = None
    kw = dict(K=K, eos=EOS, pad=PAD, stop_at_count=2 if case == "branches" else 0,
              always_allow_eos=case == "branches", keep_invalid=case == "keep_invalid")
    return (buf, n_buf, win_tok, win_valid, take(win_tok), eos_ok, lp, prev_count, finished, bs,
            need, th_lp), kw


WARP_SHAPES = {  # B, K, n_buf, w: the bench's beam 15, beam 32 at w = 32, and
    "beam15": (4, 15, 30, 32),  # 64 candidates a beam
    "beam32": (3, 32, 64, 32),  # 98 (four slots a lane)
    "narrow": (3, 8, 4, 4),  # 10 candidates for a top-16: lists shorter than 2K
    "one_reg": (5, 6, 12, 8),  # 22 (one slot a lane)
}


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("case", ["need", "no_buffer", "branches", "keep_invalid", "no_flags"])
@pytest.mark.parametrize("shape", sorted(WARP_SHAPES))
def test_select_warp_route_mirror_equals_plain(shape, case, ties):
    B, K, n_buf, w = WARP_SHAPES[shape]
    args, kw = _select_args(len(shape) + len(case) + ties, B, K, n_buf, w, 500, 60, case)
    want = k8.beam_select_plain(*args, ties=ties, **kw)
    got = k8.beam_select_warp_plain(*args, ties=ties, **kw)
    _same(got[0] + (got[1],), want[0] + (want[1],))


@pytest.mark.parametrize("ties,keep_invalid", [(False, True), (True, True), (False, False)])
def test_select_table_route_mirror_equals_plain(ties, keep_invalid):
    """F2: a speculative round of top_m 20,000 at w = 32 (20,034 candidates
    a beam, three chunks), tokens over a 60,000-token vocab with
    duplicates; the table route's dedup and chunked per-beam stage equal
    the one-block plain version, and so does the large-n route's
    specification without chunks."""
    B, K, n_buf, w, V = 2, 15, 20000, 32, 60000
    args, kw = _select_args(7 + ties, B, 3, n_buf, w, V, 30000,
                            "keep_invalid" if keep_invalid else "need")
    kw["K"] = K
    want = k8.beam_select_plain(*args, ties=ties, **kw)
    got = k8.beam_select_large_plain(*args, ties=ties, chunk=k8.SELECT_CHUNK, **kw)
    _same(got[0] + (got[1],), want[0] + (want[1],))
    ncand = n_buf + w + 2
    assert -(-ncand // k8.SELECT_CHUNK) == 3
    tokens = k8.candidates_plain(*args[:9], eos=EOS, pad=PAD, keep_invalid=keep_invalid)[0]
    assert not bool(k8.dedup_mask(tokens).all())  # duplicates present
    assert torch.equal(k8.table_first(tokens, V), k8.dedup_mask(tokens))


def _merge_args(seed, rows, n_buf, n_top, V):
    g = torch.Generator().manual_seed(seed)
    lp = _lp(g, rows, V)
    top_lp, top_idx = row_topk_plain(lp, n_top)
    ok = (torch.rand(rows, n_top + 1, generator=g) < 0.5)[..., :n_top]  # a strided view
    slab_tok = torch.randint(0, 3 * n_top, (rows, n_top), generator=g, dtype=torch.int32)
    slab_lp = torch.gather(lp, 1, slab_tok.long())
    slab_ok = torch.rand(rows, n_top, generator=g) < 0.8
    bt = torch.stack([torch.randperm(V, generator=g)[:n_buf] for _ in range(rows)])
    blp = torch.gather(lp, 1, bt)
    bvalid = (torch.rand(rows, n_buf, generator=g) < 0.7) & (blp > k8.NEG_INF / 2)
    buf = (bt.to(torch.int32), blp, bvalid)  # distinct valid tokens, as a buffer holds
    return (buf, top_idx.to(torch.int32), top_lp, ok, slab_tok, slab_lp, slab_ok, V, n_buf)


@pytest.mark.parametrize("n_buf,ties", [(3000, True), (10000, False), (3000, False)])
def test_merge_table_route_mirror_equals_plain(n_buf, ties):
    """F1: buffers past the chunked merge's reach (2,048 under ties, 4,096
    without) through the device-memory route's keys and sort, with round
    0's empty buffer too; repeated slab tokens, ties and signed zeros."""
    args = _merge_args(n_buf + ties, 3, n_buf, 2 * n_buf, 60000)
    _same(k8.beam_merge_table_plain(*args, ties=ties), k8.beam_merge_plain(*args, ties=ties))
    none = (None,) + args[1:]
    _same(k8.beam_merge_table_plain(*none, ties=ties), k8.beam_merge_plain(*none, ties=ties))


def _group_search(psi, lo, hi, pos, H):
    """``csrc/fm_search.cu:group_search`` for one query: H pivots a level,
    ``step`` = n // (H + 1) apart, the first at or past ``pos`` found by a
    ballot, then the last <= H candidates in one load."""
    if lo >= hi:
        return lo
    while hi - lo > H:
        step = (hi - lo) // (H + 1)
        ge = [psi[lo + (g + 1) * step] >= pos for g in range(H)]
        if not any(ge):
            lo += H * step + 1
        else:
            f = ge.index(True)
            hi = lo + (f + 1) * step
            lo += f * step + (f > 0)
    ge = [g < hi - lo and psi[lo + g] >= pos for g in range(H)]
    return lo + ge.index(True) if any(ge) else hi


@pytest.mark.parametrize("H", [1, 2, 4, 8, 16, 32])
def test_group_search_mirror_equals_searchsorted(H):
    """Every pivot count the kernel takes (a backward step's half groups of
    1 to 16 lanes, and contains' groups of 2 to 32) over blocks of 0 to past
    2^20 rows, positions before, inside and past each."""
    rng = np.random.default_rng(H)
    psi = np.cumsum(rng.integers(1, 4, size=(1 << 21) + 77))
    for _ in range(300):
        lo = int(rng.integers(0, psi.size))
        hi = int(min(psi.size, lo + rng.choice([0, 1, H, H + 1, 2 * H + 3, 997, 1 << 20,
                                                (1 << 21) + 5])))
        for pos in (int(psi[lo]) - 1 if hi > lo else 0, int(rng.integers(psi[lo], psi[hi - 1] + 2))
                    if hi > lo else 5, int(psi[hi - 1]) + 1 if hi > lo else 9):
            want = lo + int(np.searchsorted(psi[lo:hi], pos, side="left"))
            assert _group_search(psi, lo, hi, pos, H) == want


# ------------------------------------------------ kernel 1's step mode


def _docs(seed, n_docs=30, V=64):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(4, 40, size=rng.integers(4, 24)).tolist() + [EOS] for _ in range(n_docs)]
    docs[0] = docs[0][:-1] + [V - 1, 50, EOS]
    docs += [[10, 11] * 20 + [EOS] for _ in range(4)]  # a large interval
    return docs


def _step_inputs(host_n, rng, B, P, K, V, step0):
    """Parent ranges [B, P] (full, empty, sub-intervals), selections [B, K]
    (corpus tokens, EOS, PAD, out-of-range ids), finished parents."""
    lo = rng.integers(0, host_n, size=(B, P))
    hi = np.minimum(lo + rng.integers(0, host_n // 3, size=(B, P)), host_n)
    lo[0, 0], hi[0, 0] = 0, host_n
    lo[0, 1 % P], hi[0, 1 % P] = 6, 6
    sel_par = rng.integers(0, 1 if step0 else P, size=(B, K))
    sel_tok = rng.integers(4, 40, size=(B, K))
    sel_tok[0, :4] = (EOS, PAD, -1, V + 1)
    finished = rng.random((B, P)) < 0.25
    return [np.asarray(x, np.int32) for x in (lo, hi, sel_par, sel_tok)] + [finished]


def _jax_step(ops, sel_tok, sel_par, lo, hi, finished, step0):
    """JAX's range update (``constrained.py:1416-1430``; step 0, :1344-1349,
    without the stop rule)."""
    par_rows = jnp.arange(sel_tok.shape[0])[:, None]
    prev = ops.range_size(lo, hi)[par_rows, sel_par]
    elo, ehi = ops.extend(sel_tok, lo[par_rows, sel_par], hi[par_rows, sel_par])
    if step0:
        return elo, ehi, prev
    sel_finished = (sel_tok == EOS) | (sel_tok == PAD)
    new_lo = jnp.where(sel_finished, 0, elo)
    new_hi = jnp.where(sel_finished, 0, ehi)
    par_finished = finished[par_rows, sel_par]
    return jnp.where(par_finished, 0, new_lo), jnp.where(par_finished, 0, new_hi), prev


@pytest.mark.parametrize("step0", [True, False])
@pytest.mark.parametrize("layout", ["psi", "psi_dir31", "compact"])
def test_advance_plain_matches_jax(layout, step0):
    V, B, P, K = 64, 3, 5, 5
    host = FMIndex()
    host.initialize(_docs(len(layout)))
    if layout == "compact":
        jops = jc.SingleIndexOps(WaveletFMIndex.from_host(host, vocab=V, keep_bwt=False))
        tix = WaveletIndex.from_host(host, vocab=V, keep_bwt=False, device="cpu")
    else:
        shift = {"psi": 3, "psi_dir31": 31}[layout]
        jops = jc.SingleIndexOps(DeviceFMIndex.from_host(host, vocab=V, dir_shift=shift))
        tix = TorchFMIndex.from_host(host, vocab=V, dir_shift=shift, device="cpu")
    rng = np.random.default_rng(step0)
    lo, hi, sel_par, sel_tok, finished = _step_inputs(host.size(), rng, B, P, K, V, step0)
    want = _jax_step(jops, *(jnp.asarray(x) for x in (sel_tok, sel_par, lo, hi, finished)), step0)
    t = [torch.as_tensor(x) for x in (sel_tok, sel_par, lo, hi, finished)]
    fin = None if step0 else t[4]
    got = tc.SingleIndexOps(tix).advance(*t[:4], fin, eos=EOS, pad=PAD)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if layout != "compact":  # the Psi layout's step mode, by its plain version
        plain = k1.advance_plain(tix, *t[:4], fin, eos=EOS, pad=PAD)
        for a, b in zip(plain, got):
            assert torch.equal(a, b)
    assert np.asarray(want[0]).any() and (np.asarray(want[0]) == 0).any()


@pytest.mark.parametrize("step0", [True, False])
def test_sharded_advance_matches_jax(step0):
    """The sharded index's ``advance`` (the plain composition over kernel 1's
    shard mode) against JAX's update inside ``shard_map`` over 4 CPU
    devices: per-shard ranges [S, B, K], the summed range size."""
    from jax import shard_map

    S, V, B, K = 4, 64, 3, 5
    j, hosts, _ = jsi.ShardedFMIndex.build(_docs(9), n_shards=S, vocab=V)
    t = tsi.ShardedTorchIndex.from_hosts(hosts, V, device="cpu")
    rng = np.random.default_rng(11 + step0)
    n_min = min(h.size() for h in hosts)
    per = [_step_inputs(n_min, rng, B, K, K, V, step0) for _ in range(S)]
    lo = np.stack([p[0] for p in per])
    hi = np.stack([p[1] for p in per])
    _, _, sel_par, sel_tok, finished = per[0]
    mesh = mesh_lib.make_mesh(n_data=S, n_model=1, devices=jax.devices()[:S])
    jp = j.place(mesh)

    def per_shard(bwt, psi, C, beg, n_rows, bocc, lo, hi, tok, par, fin):
        dev = jsi._shard_device_index(jp, bwt[0], psi[0], C[0], beg[0], None, bocc[0])
        ops = jsd.ShardedIndexOps(dev, n_rows[0])
        elo, ehi, prev = _jax_step(ops, tok, par, lo[0], hi[0], fin, step0)
        return elo[None], ehi[None], prev

    fn = shard_map(per_shard, mesh=mesh, in_specs=(P("data"),) * 8 + (P(),) * 3,
                   out_specs=(P("data"), P("data"), P()))
    want = jax.device_get(jax.jit(fn)(jp.bwt, jp.psi, jp.C, jp.beginnings, jp.n_rows,
                                      jp.bucket_occ, *(jnp.asarray(x) for x in (
                                          lo, hi, sel_tok, sel_par, finished))))
    tt = [torch.as_tensor(x) for x in (sel_tok, sel_par, lo, hi, finished)]
    got = tsd.ShardedIndexOps(t).advance(*tt[:4], None if step0 else tt[4], eos=EOS, pad=PAD)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
