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
* the wide route's stages (first instances by the hash table, mirrored
  in numpy; each beam's running first 64 over chunks of 64,
  ``merge_top``; the lists' merge: ``beam_select_wide_plain``) and the
  candidate mode's dedup equal to ``beam_select_plain`` /
  ``candidates_plain`` bit for bit at 290, 386 and 578 candidates a beam,
  and ``beam_select_plain`` equal to JAX's
  ``_apply_branches`` + ``_dedup_mask`` + ``_select`` at the speculative
  [15, 386] and the 4-shard beam-32 [32, 578] shapes;
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


def _hash_first(tok, table, order):
    """``csrc/beam_select.cu:warp_first_instances`` with a hash table for
    one row: the slots inserted in ``order`` (the lanes race on the card),
    each claiming an empty entry or lowering its token's entry where it
    holds a higher slot, then each slot looking its token up.  Returns the
    first-instance mask and the probes a slot took on average."""
    tab = np.full(table, -1, np.int64)
    probes = 0

    def home(t):  # __umulhi((unsigned)t * 0x9e3779b1, table)
        return (((int(t) & 0xFFFFFFFF) * 0x9E3779B1) & 0xFFFFFFFF) * table >> 32

    for j in order:
        p = home(tok[j])
        while True:
            probes += 1
            s = tab[p]
            if s < 0 or tok[s] == tok[j]:
                tab[p] = j if s < 0 else min(s, j)
                break
            p = (p + 1) % table
    first = np.zeros(len(tok), bool)
    for j in range(len(tok)):
        p = home(tok[j])
        while tok[tab[p]] != tok[j]:
            p = (p + 1) % table
        first[j] = tab[p] == j
    return first, probes / len(tok)


def _first_by(table, seed=0):
    """A ``first`` function for ``candidates_plain``: the kernel's hash table
    of ``table`` entries a row, the slots inserted in a random order."""
    def first(tokens):
        t = tokens.reshape(-1, tokens.shape[-1]).numpy()
        rng = np.random.default_rng(seed)
        rows = [_hash_first(r, table, rng.permutation(len(r))) for r in t]
        assert max(p for _, p in rows) < 4  # a few probes a slot at a load <= 0.8
        return torch.as_tensor(np.stack([f for f, _ in rows])).reshape(tokens.shape)
    return first


WIDE_SHAPES = {  # B, K, n_buf, w: candidates a beam
    "sample_290": (2, 15, 256, 32),  # sampling's buffer (the candidate mode's width)
    "spec_386": (2, 15, 256, 128),  # the speculative default
    "beam32_578": (2, 32, 64, 512),  # beam 32 over a 4-shard union window
    "narrow": (3, 8, 4, 4),  # 10 candidates for a top-16: no radix pass
}


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("case", ["need", "no_buffer", "branches", "keep_invalid", "no_flags"])
@pytest.mark.parametrize("shape", sorted(WIDE_SHAPES))
def test_select_wide_route_mirror_equals_plain(shape, case, ties):
    """The wide route's stages, with the first instances of the hash table
    at the size the card gives these shapes (2 ncand entries, a load of
    1/2: ``test_beam_select_route_choice_and_limits`` holds it there), equal
    ``beam_select_plain`` bit for bit: tokens from [0, 60) (many
    duplicates), ties, signed zeros, a dead beam."""
    B, K, n_buf, w = WIDE_SHAPES[shape]
    args, kw = _select_args(3 * len(shape) + len(case) + ties, B, K, n_buf, w, 500, 60, case)
    ncand = n_buf + w + 2
    want = k8.beam_select_plain(*args, ties=ties, **kw)
    got = k8.beam_select_wide_plain(*args, ties=ties, first=_first_by(2 * ncand), **kw)
    _same(got[0] + (got[1],), want[0] + (want[1],))


@pytest.mark.parametrize("n", [64, 65, 290, 578])
def test_merge_top_keeps_the_first_64(n):
    """The wide route's running list (``merge_top``: the better of each
    place and the chunk's mirrored place, then half-cleaners) over chunks
    of 64, on rows that corner it: keys from a small alphabet (equal keys
    across the 64th place: the ties mode's), one key everywhere, distinct
    keys, and keys in ascending order; the result is the first 64 of a
    stable descending sort, in its order."""
    g = torch.Generator().manual_seed(n)
    rows = torch.stack([torch.randint(0, 5, (n,), generator=g) << 40,
                        torch.full((n,), 7),
                        torch.randperm(n, generator=g) * 3 - 500,
                        torch.arange(n) - 2**62])
    slot = torch.arange(n).expand(rows.shape)
    low = torch.iinfo(torch.int64).min
    top = None
    for c0 in range(0, n, 64):
        pad = max(0, c0 + 64 - n)
        ck = torch.nn.functional.pad(rows[:, c0:c0 + 64], (0, pad), value=low)
        cs = torch.nn.functional.pad(slot[:, c0:c0 + 64], (0, pad), value=2**31 - 1)
        order = torch.sort(ck, dim=-1, descending=True, stable=True)[1]
        ck, cs = ck.gather(-1, order), cs.gather(-1, order)
        top = (ck, cs) if top is None else k8.merge_top(*top, ck, cs)
    want = torch.sort(rows, dim=-1, descending=True, stable=True)[1][:, :64]
    m = min(64, n)
    assert torch.equal(top[1][:, :m], want[:, :m])
    assert torch.equal(top[0][:, :m], rows.gather(-1, want[:, :m]))


@pytest.mark.parametrize("n_buf,w,case", [(30, 32, "need"), (256, 32, "keep_invalid"),
                                          (256, 32, "branches"), (256, 128, "keep_invalid")])
def test_candidates_dedup_mirror_equals_plain(n_buf, w, case):
    """The candidate mode's first instances, a warp a row through the hash
    table of 2 ncand entries, equal ``candidates_plain`` at 64, 290 and 386
    candidates a beam."""
    args, kw = _select_args(n_buf + w + 4, 2, 15, n_buf, w, 500, 60, case)
    ckw = {k: kw[k] for k in ("eos", "pad", "stop_at_count", "always_allow_eos",
                              "keep_invalid")}
    ncand = n_buf + w + 2
    want = k8.candidates_plain(*args[:9], **ckw)
    assert not bool(k8.dedup_mask(want[0]).all())  # duplicates present
    _same(k8.candidates_plain(*args[:9], **ckw, first=_first_by(2 * ncand, seed=1)), want)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape,keep_invalid", [("spec_386", True), ("beam32_578", False)])
def test_select_plain_matches_jax(shape, keep_invalid, ties):
    """``beam_select_plain`` (and the wide route's mirror) against JAX's
    candidates (the speculative mode's buffer as proposed, or the fast
    path's PAD-finished one: ``_candidates_general`` :343-367,
    ``build_and_select`` :850-871), ``_apply_branches``, ``_dedup_mask``
    (:1014), ``_select`` (:1046) and the soundness test, bit for bit."""
    B, K, n_buf, w = WIDE_SHAPES[shape]
    args, kw = _select_args(5 + ties, B, K, n_buf, w, 500, 60,
                            "keep_invalid" if keep_invalid else "branches")
    kw["stop_at_count"], kw["always_allow_eos"] = 2, True
    buf, _, win_tok, win_valid, win_lp, eos_ok, lp, prev_count, finished, bs, need, th_lp = \
        (x.numpy() if isinstance(x, torch.Tensor) else x for x in args)
    buf = tuple(t.numpy() for t in args[0])
    V = lp.shape[-1]
    lp3 = lp.reshape(B, K, V)
    btok, blp, bvalid = buf
    if not keep_invalid:  # unfilled slots become PAD candidates at PAD's log-prob
        btok = np.where(bvalid, btok, PAD)
        blp = np.where(bvalid, blp, lp3[..., PAD, None])
    one = lambda x: x[..., None]  # noqa: E731
    tokens = jnp.asarray(np.concatenate([btok, win_tok, np.full((B, K, 1), EOS),
                                         np.full((B, K, 1), PAD)], -1).astype(np.int32))
    fm_valid = jnp.asarray(np.concatenate([bvalid, win_valid, eos_ok,
                                           np.zeros((B, K, 1), bool)], -1))
    cand_lp = jnp.asarray(np.concatenate([blp, win_lp, one(lp3[..., EOS]), one(lp3[..., PAD])],
                                         -1))
    cfg = jc.DecodeConfig(num_beams=K, stop_at_count=2, always_allow_eos=True, exact_ties=ties)
    _, allowed, _ = jc._apply_branches(cfg, tokens, fm_valid, cand_lp, jnp.asarray(prev_count),
                                       jnp.asarray(finished))
    cons = jnp.where(allowed & jc._dedup_mask(tokens), cand_lp, jc.NEG_INF)
    jbs = jnp.asarray(bs)[..., None]
    want = [np.asarray(x) for x in jc._select(cfg, cons + jbs, cand_lp + jbs, tokens, K, V)]
    want.append(np.asarray((need & (bs + th_lp >= want[8][:, -1:])).any(-1)))
    for fn in (k8.beam_select_plain, k8.beam_select_wide_plain):
        out, unsound = fn(*args, ties=ties, **kw)
        _same(out + (unsound,), [torch.as_tensor(np.array(x)) for x in want])


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
