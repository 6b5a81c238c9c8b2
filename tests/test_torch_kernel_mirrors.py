"""Numpy mirrors of two kernels' device arithmetic against the JAX package
and the port's plain versions, on the CPU (the card runs the kernels
themselves in ``test_torch_cuda.py``).

* Kernel 13's descent (``csrc/wt_window.cu:descend``): a level's node row
  (node_cnt, and its children's node_start read as one aligned 16-word load
  and one word), x's code word and the block's nearer half (below x under
  its directory, or from the middle on above x under the next block's; the
  code words of x's side in 16-byte groups, the rest zero; the last
  block's upper words in a second round) are read in one round; the digit
  comes from x's word, its rank from popcounts of four words' matches
  folded into one, and the last level reads the digit alone.  Equal to
  ``access_plain`` and to JAX's ``wt_ops.access`` at every row of indexes
  at 1, 2, 4 and 5 digits (the sentinel's row and the last block
  included), and to ``access_plain`` on a wider corpus of 8 blocks a
  level, on the compact and hybrid layouts' arrays.
* Kernel 5's group search (``csrc/fm_search.cu:sequences_kernel``,
  ``sequences_sharded_kernel``): G lanes a (shard, sequence), G / 2 pivots a
  bound a level (kernel 1's ``group_search``, the warp's groups in step),
  each shard from its own [0, n_rows[s]), a team of P groups a sequence
  that takes shards p, p + P, ... and, in the count mode, adds its counts
  in a shuffle butterfly.
  At every group width, over 1 to 4 shards (and the monolithic Psi index
  with its head directory), with lengths 0 to L, out-of-range tokens
  ((0, 0) resets) and empty ranges, equal to ``sequences_plain``,
  ``sequences_sharded_plain``, JAX's ``range_for_sequences`` and
  ``sharded_count_sequences``.  ``sequences_plan``, the host's choice of G
  and P, equals a brute-force reading of its rule.
"""

import jax
import numpy as np
import pytest
import torch

from seal_tpu.index.device_index import DeviceFMIndex
from seal_tpu.index.wavelet import WaveletFMIndex
from seal_tpu.ops import fm_ops as jfm
from seal_tpu.ops import wt_ops as jwt
from seal_tpu.parallel import mesh as mesh_lib
from seal_tpu.parallel import sharded_index as jsi
from seal_tpu_torch.index.device_index import TorchFMIndex
from seal_tpu_torch.index.wavelet import WaveletIndex, heap_base
from seal_tpu_torch.kernels import fm_search as k1
from seal_tpu_torch.kernels import wt_search as k12
from seal_tpu_torch.parallel import sharded_index as tsi
from test_torch_wavelet import CASES, _host

ONES = 0x11111111


# ------------------------------------------------- kernel 13's descent


def _match(w: int, pat: int) -> int:
    """``seal_wt::match_nibbles``: bit 0 of each nibble of w equal to pat's."""
    x = w ^ pat
    x |= x >> 2
    x |= x >> 1
    return ~x & ONES


def _popc(x: int) -> int:
    return bin(x & 0xFFFFFFFF).count("1")


def _descend(blocks, node_start, node_cnt, n_rows: int, digits: int, row: int) -> int:
    """The shifted symbol at ``row`` as one lane of the kernel reads it."""
    x, c = row, 0
    for level in range(digits):
        x = min(max(x, 0), n_rows)
        blk = blocks[level][x >> 8]
        last, shift = (x & 255) >> 3, (x & 7) << 2
        word = blk[16 + last]  # the code word of x
        d = (word >> shift) & 15
        if level == digits - 1:
            return (c << 4) | d
        # the round: the node row, x's word, and the nearer half of the
        # block: the words below x's under its directory, or, from the middle
        # on (not in the last block), those above x's under the next block's
        cnt = node_cnt[heap_base(level) + c]
        first = heap_base(level + 1) + 16 * c
        assert (first - 1) % 16 == 0 and first + 15 < node_start.size  # the aligned load
        child = list(node_start[first - 1 : first + 15][1:]) + [node_start[first + 15]]
        up = last >= 16 and (x >> 8) + 1 < len(blocks[level])
        direc = blocks[level][(x >> 8) + 1][:16] if up else blk[:16]
        base = 16 if up else 0
        code = [blk[16 + base + 4 * q + k]
                if (base + 4 * q + 3 > last if up else base + 4 * q < last) else 0
                for q in range(4) for k in range(4)]
        pat = d * ONES
        below = (1 << shift) - 1
        part = _popc(_match(word, pat) & (~below if up else below))
        for q in range(4):
            t = 0
            for k in range(4):
                t |= _match(code[4 * q + k], pat) << k
            g = base + 4 * q
            n_lo, n_hi = min(max(last - g, 0), 4), min(max(g + 3 - last, 0), 4)
            k_mask = ((1 << n_hi) - 1) << (4 - n_hi) if up else (1 << n_lo) - 1
            part += _popc(t & (ONES * k_mask))
        if not up and last > 16:  # the last block past its middle: its upper words too
            for q in range(4):
                g = 16 + 4 * q
                t = 0
                for k in range(4):
                    t |= _match(blk[16 + g + k] if g < last else 0, pat) << k
                part += _popc(t & (ONES * ((1 << min(max(last - g, 0), 4)) - 1)))
        rank = direc[d] - part if up else direc[d] + part
        x = int(child[d]) + int(rank) - int(cnt[d])
        c = (c << 4) | d
    return c


def _wide_host(name):
    """A corpus of ~2,000 rows (8 blocks a level) over a case's alphabet."""
    from seal_tpu_torch.index.fm_index import FMIndex

    vocab, hi, _ = CASES[name]
    rng = np.random.default_rng(vocab + 2)
    docs = [rng.integers(0, hi, size=rng.integers(10, 50)).tolist() for _ in range(70)]
    docs[0] += [hi - 1, hi - 1]
    host = FMIndex()
    host.initialize(docs)
    return host


@pytest.mark.parametrize("keep_bwt", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_descent_mirror_matches_access(name, keep_bwt):
    """Every row of a case's corpus (hybrid: its compact arrays), against
    the plain descent and JAX's access, and of a wider one (8 blocks a
    level), against the plain descent; the sentinel's row and the last
    block's included."""
    _check_descent(_host(name), CASES[name][0], keep_bwt, name)
    _check_descent(_wide_host(name), CASES[name][0], keep_bwt, None)


# JAX's access of every row of a case's corpus, once a case: both layouts'
# blocks and node tables are the same arrays (the hybrid adds its raw BWT)
_JAX_ACCESS = {}


def _check_descent(host, vocab, keep_bwt, key):
    t = WaveletIndex.from_host(host, vocab=vocab, keep_bwt=keep_bwt, device="cpu")
    N = host.size()
    blocks = (t.blocks.numpy().astype(np.int64) & 0xFFFFFFFF).tolist()
    node_start, node_cnt = t.node_start.numpy(), t.node_cnt.numpy()
    rows = np.arange(N, dtype=np.int32)
    got = [_descend(blocks, node_start, node_cnt, t.n_rows, t.digits, r) for r in rows.tolist()]
    plain = k12.access_plain(t, torch.as_tensor(rows)).numpy()
    np.testing.assert_array_equal(got, plain)
    if key is not None:
        if key not in _JAX_ACCESS:
            j = WaveletFMIndex.from_host(host, vocab=vocab, keep_bwt=keep_bwt)
            _JAX_ACCESS[key] = np.asarray(jwt.access(j, rows))
        np.testing.assert_array_equal(got, _JAX_ACCESS[key])
    np.testing.assert_array_equal(got, np.asarray(host.bwt))
    sentinel = int(np.flatnonzero(np.asarray(host.bwt) == 0)[0])
    assert got[sentinel] == 0 and (N - 1) >> 8 == t.n_blocks - 1 - (N % 256 == 0)


# ------------------------------------------------- kernel 5's group search


def _group_search(psi, lo: int, hi: int, pos: int, H: int) -> int:
    """``csrc/fm_search.cu:group_search`` for one bound: H pivots a level."""
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


def _chain(psi, bounds, sigma: int, n_rows: int, toks, length: int, G: int):
    """One group's chain over a sequence: ``group_step`` a position, the
    lower half of the group on lo, the upper on hi; ``bounds(c, pos)`` the
    symbol's search interval (its block, narrowed by a head directory)."""
    lo, hi = 0, n_rows
    for tok in toks[: max(min(length, len(toks)), 0)]:
        c = int(tok) + 1
        if not 1 <= c < sigma:
            lo, hi = 0, 0
            continue
        rows = [_group_search(psi, *bounds(c, pos), pos, G // 2) for pos in (lo, hi)]
        lo, hi = rows[0], max(rows[0], rows[1])
    return lo, hi


def _sharded_mirror(t, toks, lens, G: int, P: int, count: bool):
    """``sequences_sharded_kernel``: ranges [S, n], or the teams' sums [n]."""
    psi, sym_dir, n_rows = t.psi.numpy(), t.sym_dir.numpy(), t.n_rows.numpy()
    S = t.n_shards

    def run(s, i):
        bounds = lambda c, pos: (int(sym_dir[s, c, 0]), int(sym_dir[s, c, 1]))  # noqa: E731
        return _chain(psi[s], bounds, t.sigma, int(n_rows[s]), toks[i], int(lens[i]), G)

    if not count:  # member p of sequence i's team writes shards p, p + P, ...
        out = np.zeros((S, len(lens), 2), np.int64)
        for i in range(len(lens)):
            for p in range(P):
                for s in range(p, S, P):
                    out[s, i] = run(s, i)
        return out[..., 0], out[..., 1]
    sums = []
    for i in range(len(lens)):
        lanes = [sum(b - a for a, b in (run(s, i) for s in range(p, S, P))) for p in range(P)]
        off = 1
        while off < P:  # the butterfly: __shfl_xor_sync over the team's groups
            lanes = [lanes[p] + lanes[p ^ off] for p in range(P)]
            off <<= 1
        sums.append(lanes[0])
    return np.array(sums)


def _sequences(rng, docs, n, L, V):
    """n corpus n-grams of lengths 0 to L (their prefixes: mostly found);
    a few random ids past the vocab and below 0 (the (0, 0) resets)."""
    toks = np.zeros((n, L), np.int32)
    lens = rng.integers(0, L + 1, size=n).astype(np.int32)
    lens[:2] = [0, L]
    for i in range(n):
        d = docs[int(rng.integers(len(docs)))]
        a = int(rng.integers(0, max(len(d) - L, 1)))
        seg = d[a : a + L]
        toks[i, : len(seg)] = seg
    toks[2:6] = rng.integers(-1, V + 3, size=(4, L))
    toks[6, 1] = -1
    toks[7, 0] = V + 40
    return toks, lens


V = 64


def _docs(seed, n_docs=24):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(4, 40, size=rng.integers(4, 24)).tolist() + [2] for _ in range(n_docs)]
    docs[0] = docs[0][:-1] + [V - 1, 50, 2]
    return docs


@pytest.mark.parametrize("S", [1, 2, 3, 4])
def test_sequences_sharded_mirror_matches_jax(S):
    """Kernel 5's shard mode at every group width and team the plan can
    pick: ranges against the plain version, summed counts against it and
    JAX's ``sharded_count_sequences`` on an S-device mesh."""
    docs = _docs(S)
    j, hosts, _ = jsi.ShardedFMIndex.build(docs, n_shards=S, vocab=V)
    t = tsi.ShardedTorchIndex.from_hosts(hosts, V, device="cpu")
    rng = np.random.default_rng(10 + S)
    toks, lens = _sequences(rng, docs, 24, 6, V)
    tt, tl = torch.as_tensor(toks), torch.as_tensor(lens)
    want_lo, want_hi = (x.numpy() for x in k1.sequences_sharded_plain(t, tt, tl))
    want = k1.sequences_sharded_plain(t, tt, tl, count=True).numpy()
    mesh = mesh_lib.make_mesh(n_data=S, n_model=1, devices=jax.devices()[:S])
    np.testing.assert_array_equal(
        want, np.asarray(jsi.sharded_count_sequences(j.place(mesh), mesh, toks, lens)))
    assert (want > 0).sum() > 8 and (want == 0).any()
    for G in k1.GROUPS:
        _, P = k1.sequences_plan(len(lens), 132, S, group=G)
        assert P * G <= 32 and P >= min(S, 32 // G)
        lo, hi = _sharded_mirror(t, toks, lens, G, P, count=False)
        np.testing.assert_array_equal(lo, want_lo)
        np.testing.assert_array_equal(hi, want_hi)
        np.testing.assert_array_equal(_sharded_mirror(t, toks, lens, G, P, count=True), want)
    # a team narrower than the shards (the loop over its shards)
    if S > 1:
        np.testing.assert_array_equal(_sharded_mirror(t, toks, lens, 16, 1, count=True), want)


def test_sequences_mirror_matches_jax():
    """The monolithic kernel 5 (the Psi index with its head directory) at
    every group width, against the plain version and JAX's scan."""
    docs = _docs(7, 40)
    from seal_tpu_torch.index.fm_index import FMIndex

    host = FMIndex()
    host.initialize(docs)
    t = TorchFMIndex.from_host(host, vocab=V, dir_shift=4, device="cpu")
    assert t.head_pair is not None
    j = DeviceFMIndex.from_host(host, vocab=V, dir_shift=4)
    rng = np.random.default_rng(3)
    toks, lens = _sequences(rng, docs, 32, 7, V)
    want = [x.numpy() for x in k1.sequences_plain(t, torch.as_tensor(toks), torch.as_tensor(lens))]
    for a, b in zip(want, jfm.range_for_sequences(j, toks, lens)):
        np.testing.assert_array_equal(a, np.asarray(b))
    psi = t.psi.numpy()

    def bounds(c, pos):
        _, _, dlo, dhi = k1.symbol_bounds(t, torch.tensor([c]), torch.tensor([pos]))
        return int(dlo[0]), int(dhi[0])

    for G in k1.GROUPS:
        got = np.array([_chain(psi, bounds, t.sigma, t.n_rows, toks[i], int(lens[i]), G)
                        for i in range(len(lens))])
        np.testing.assert_array_equal(got[:, 0], want[0])
        np.testing.assert_array_equal(got[:, 1], want[1])


@pytest.mark.parametrize("sms", [1, 132])
def test_sequences_plan_rule(sms):
    """P the power of two holding the shards, at most 16; G the widest group
    (P * G <= 32) whose grid keeps within SEQ_LANES_PER_SM lanes an SM,
    never below 2; a forced G cuts P to 32 // G."""
    budget = sms * k1.SEQ_LANES_PER_SM
    for S in (1, 2, 3, 4, 5, 8, 16, 17, 40):
        for n in (1, 15, 16, 100, 1000, 4096, 4097, 16384, 10 ** 6):
            G, P = k1.sequences_plan(n, sms, S)
            want_P = min(1 << (S - 1).bit_length(), 16)
            fits = [g for g in k1.GROUPS if g * want_P <= 32 and n * want_P * g <= budget]
            assert (G, P) == (max(fits, default=2), want_P), (n, S)
            for g in k1.GROUPS:
                assert k1.sequences_plan(n, sms, S, group=g) == (g, min(want_P, 32 // g))
    # the switch points of one index: each width on its side of the budget
    for G in (4, 8, 16, 32):
        n = budget // G
        assert k1.sequences_plan(n, sms)[0] == G
        assert k1.sequences_plan(n + 1, sms)[0] == G // 2
    assert k1.sequences_plan(15, 132, 4) == (8, 4)
    with pytest.raises(ValueError, match="group of 3"):
        k1.sequences_plan(5, 132, group=3)
