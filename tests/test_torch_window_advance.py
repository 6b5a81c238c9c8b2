"""Kernels 2 and 13's window + slab and slab modes and kernel 12's step
mode against the JAX package, on the CPU (the kernels' plain versions).

* ``window_slab`` (the step's window and proposal round 0's slab) and
  ``slab_gather`` (a straggler round's slab, its bounds from ``rows_prev``
  and ``width``) on the Psi, compact and hybrid layouts (kernel 2's plain
  versions on the Psi layout, kernel 13's on the wavelet ones) equal JAX's
  ``window_continuations`` + ``take_along_axis`` of the log-probs and the
  ``merge_round`` slab (``seal_tpu/decoding/constrained.py:381-387`` and
  ``:622-635``): empty ranges, ranges of exactly w and width rows, ranges
  between w and 2w (a stride-1 window the slab already holds) and strided
  ones; over 2 and 4 shards, the union window and slabs equal JAX's
  ``ShardedIndexOps.window`` inside a ``shard_map``.
* ``wt_ops.advance_ranges`` (kernel 12's step mode) equals JAX's range
  update (``extend`` and the stop rule, :1416-1430; step 0, :1344-1349) on
  compact and hybrid indexes at 1, 2, 4 and 5 digits, with EOS, PAD and
  out-of-vocab selections and finished parents.
* Generation through the proven loop's straggler rounds (``slab`` with
  ``rows_prev > 0``) on every layout equals JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from seal_tpu.decoding import constrained as jc
from seal_tpu.decoding import generate as jg
from seal_tpu.index.device_index import DeviceFMIndex
from seal_tpu.index.wavelet import WaveletFMIndex
from seal_tpu.ops import fm_ops as jfm
from seal_tpu.ops import wt_ops as jwt
from seal_tpu.parallel import mesh as mesh_lib
from seal_tpu.parallel import sharded_decode as jsd
from seal_tpu.parallel import sharded_index as jsi
from seal_tpu_torch.decoding import constrained as tc
from seal_tpu_torch.decoding import generate as tg
from seal_tpu_torch.index.device_index import TorchFMIndex
from seal_tpu_torch.index.wavelet import WaveletIndex
from seal_tpu_torch.kernels import window_gather as k2
from seal_tpu_torch.kernels import wt_search as k12
from seal_tpu_torch.kernels import wt_window as k13
from seal_tpu_torch.ops import fm_ops, wt_ops
from seal_tpu_torch.parallel import sharded_decode as tsd
from seal_tpu_torch.parallel import sharded_index as tsi
from test_torch_generate import _assert_same_hyps, _models, _random_corpus
from test_torch_wavelet import CASES, _host

EOS, PAD = 2, 1
V = 40


def _zipf_host():
    from seal_tpu_torch.index.fm_index import FMIndex

    rng = np.random.default_rng(5)
    toks = (rng.zipf(1.2, size=4000) % 28 + 4).astype(np.int64)
    host = FMIndex()
    host.initialize([d.tolist() for d in np.array_split(toks, 80)])
    return host


@pytest.fixture(scope="module")
def indexes():
    """One Zipf corpus in the three layouts, JAX's and the port's."""
    host = _zipf_host()
    return host, {
        "psi": (jfm, DeviceFMIndex.from_host(host, vocab=V),
                TorchFMIndex.from_host(host, vocab=V, device="cpu")),
        "compact": (jwt, WaveletFMIndex.from_host(host, vocab=V, keep_bwt=False),
                    WaveletIndex.from_host(host, vocab=V, keep_bwt=False, device="cpu")),
        "hybrid": (jwt, WaveletFMIndex.from_host(host, vocab=V, keep_bwt=True),
                   WaveletIndex.from_host(host, vocab=V, keep_bwt=True, device="cpu")),
    }


def _ranges(host, rng, w, width):
    """[6, 8] ranges: corpus n-grams, random sub-intervals, and ranges of 0,
    1, w - 1, w, w + 1, 2w - 1, 2w, width, width + 1 and 3 * width rows."""
    N = host.size()
    text = (host.text[:-1] - 1).tolist()
    los, his = [], []
    for _ in range(20):
        i = int(rng.integers(0, len(text) - 2))
        lo, hi = host.get_range(text[i : i + int(rng.integers(1, 3))][::-1])
        los.append(lo)
        his.append(hi)
    sizes = [0, 1, w - 1, w, w + 1, 2 * w - 1, 2 * w, width, width + 1, 3 * width, N]
    for size in sizes:
        a = int(rng.integers(0, N - size + 1))
        los.append(a)
        his.append(a + size)
    while len(los) < 48:
        a = int(rng.integers(0, N))
        los.append(a)
        his.append(int(rng.integers(a, N + 1)))
    los[-2:], his[-2:] = [N, 0], [N, 0]  # empty at the end, (0, 0)
    return (np.asarray(los, np.int32).reshape(6, 8), np.asarray(his, np.int32).reshape(6, 8))


def _jax_gather(jops, jix, lo, hi, w, lp, fill):
    """JAX's window rows and ``take_along_axis`` of the log-probs
    (``_exact_slots`` :381-387 with the PAD fill, the slab :625-632 with 0)."""
    tok, ok = jops.window_continuations(jix, lo, hi, w)
    tok = jnp.where(ok, tok, fill).astype(jnp.int32)
    R = lo.size
    lpj = jnp.take_along_axis(jnp.asarray(lp), tok.reshape(R, w), axis=-1).reshape(tok.shape)
    return tok, ok, lpj


def _jax_slab(jops, jix, lo, hi, rows_prev, width, lp):
    s_lo = jnp.minimum(lo + rows_prev, hi)  # merge_round :623-624
    s_hi = jnp.minimum(s_lo + width, hi)
    return _jax_gather(jops, jix, s_lo, s_hi, width, lp, 0)


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("w,width", [(4, 8), (8, 8), (8, 4), (16, 32)])
@pytest.mark.parametrize("layout", ["psi", "compact", "hybrid"])
def test_window_slab_matches_jax(indexes, layout, w, width):
    """The step's window (fill PAD) and round 0's slab (fill 0) through the
    adapter, and kernel 2's plain version on the Psi layout (kernel 13's on
    the wavelet layouts), equal JAX's two gathers."""
    host, pairs = indexes
    jops, jix, tix = pairs[layout]
    rng = np.random.default_rng(w * 100 + width)
    lo, hi = _ranges(host, rng, w, width)
    lp = rng.normal(size=(lo.size, V)).astype(np.float32)
    want = (*_jax_gather(jops, jix, lo, hi, w, lp, PAD),
            *_jax_slab(jops, jix, lo, hi, 0, width, lp))
    tlo, thi, tlp = torch.as_tensor(lo), torch.as_tensor(hi), torch.as_tensor(lp)
    got = tc.SingleIndexOps(tix).window_slab(tlo, thi, w, width, tlp, PAD)
    assert [t.dtype for t in got] == [torch.int32, torch.bool, torch.float32] * 2
    assert got[0].shape == (6, 8, w) and got[3].shape == (6, 8, width)
    _same(got, want)
    if layout == "psi":
        _same(k2.window_slab_plain(tix, tlo, thi, w, width, tlp, PAD), want)
    else:
        _same(k13.wt_window_slab_plain(tix, tlo, thi, w, width, tlp, PAD), want)
    # the ranges cover every case the kernel tells apart
    size = hi - lo
    assert (size == 0).any() and (size == w).any() and (size == width).any()
    assert ((size > w) & (size < 2 * w)).any() and (size >= 2 * w).any()
    assert np.asarray(want[1]).any() and np.asarray(want[4]).any()


@pytest.mark.parametrize("rows_prev,width", [(0, 8), (8, 32), (13, 4), (40, 64)])
@pytest.mark.parametrize("layout", ["psi", "compact", "hybrid"])
def test_slab_matches_jax(indexes, layout, rows_prev, width):
    """A straggler round's slab, its bounds computed from ``rows_prev`` and
    ``width``, equals ``merge_round``'s."""
    host, pairs = indexes
    jops, jix, tix = pairs[layout]
    rng = np.random.default_rng(rows_prev + width)
    lo, hi = _ranges(host, rng, 8, width)
    lp = rng.normal(size=(lo.size, V)).astype(np.float32)
    want = _jax_slab(jops, jix, lo, hi, rows_prev, width, lp)
    tlo, thi, tlp = torch.as_tensor(lo), torch.as_tensor(hi), torch.as_tensor(lp)
    _same(tc.SingleIndexOps(tix).slab(tlo, thi, rows_prev, width, tlp), want)
    if layout == "psi":
        _same(k2.slab_gather_plain(tix, tlo, thi, rows_prev, width, tlp), want)
    else:
        _same(k13.wt_slab_gather_plain(tix, tlo, thi, rows_prev, width, tlp), want)
    assert np.asarray(want[1]).any()


def test_wrappers_count_no_launch_on_cpu(indexes):
    """On the CPU every new mode runs its plain version: no counter moves."""
    host, pairs = indexes
    counters = (k2.window_gather, k2.WINDOW_SLAB, k2.SLAB, k2.window_gather_sharded,
                k12.wt_search, k12.ADVANCE, k13.wt_window_gather, k13.WINDOW_SLAB, k13.SLAB)
    before = [c.launches for c in counters]
    lo, hi = (torch.as_tensor(x) for x in _ranges(host, np.random.default_rng(0), 4, 8))
    lp = torch.zeros((lo.numel(), V))
    for _, _, tix in pairs.values():
        ops = tc.SingleIndexOps(tix)
        ops.window_slab(lo, hi, 4, 8, lp, PAD)
        ops.slab(lo, hi, 8, 16, lp)
    sel = torch.zeros((6, 8), dtype=torch.int32)
    wt_ops.advance_ranges(pairs["compact"][2], sel + 5, sel, lo, hi, eos=EOS, pad=PAD)
    assert before == [c.launches for c in counters]
    assert fm_ops.window_slab is k2.window_slab and fm_ops.slab_gather is k2.slab_gather
    assert wt_ops.window_slab is k13.wt_window_slab
    assert wt_ops.slab_gather is k13.wt_slab_gather


# ------------------------------------------------------------- shard mode


def _sharded_world(S):
    rng = np.random.default_rng(S)
    docs = [rng.integers(4, 40, size=rng.integers(4, 30)).tolist() + [EOS] for _ in range(28)]
    docs += [[10, 11] * 25 + [EOS] for _ in range(2)]  # wide intervals
    j, hosts, _ = jsi.ShardedFMIndex.build(docs, n_shards=S, vocab=V)
    return j, hosts, tsi.ShardedTorchIndex.from_hosts(hosts, V, device="cpu")


def _sharded_ranges(t, hosts, rng, B, K, w, width):
    """Per-shard ranges [S, B, K] inside each shard's rows, with sizes 0, w,
    between w and 2w, width and wider."""
    S = len(hosts)
    lo = np.zeros((S, B, K), np.int32)
    hi = np.zeros((S, B, K), np.int32)
    for s, h in enumerate(hosts):
        n = h.size()
        a = rng.integers(0, n, size=(B, K))
        lo[s] = a
        hi[s] = np.minimum(a + rng.integers(0, 3 * width, size=(B, K)), n)
        for k, size in enumerate((0, w, w + 1, width, 2 * width)):
            size = min(size, n)
            lo[s, 0, k], hi[s, 0, k] = n - size, n
    return torch.as_tensor(lo), torch.as_tensor(hi)


@pytest.mark.parametrize("S", [2, 4])
def test_sharded_window_slab_matches_jax(S):
    """The union window and the union slabs of kernel 2's shard mode equal
    JAX's ``ShardedIndexOps.window`` on the window's and the slabs' bounds
    (shard s in slots [s * w, (s + 1) * w)), with the log-probs."""
    from jax import shard_map

    j, hosts, t = _sharded_world(S)
    mesh = mesh_lib.make_mesh(n_data=S, n_model=1, devices=jax.devices()[:S])
    jp = j.place(mesh)
    B, K, w, width, rows_prev = 3, 5, 4, 8, 8
    rng = np.random.default_rng(10 + S)
    lo, hi = _sharded_ranges(t, hosts, rng, B, K, w, width)

    def per_shard(bwt, psi, C, beg, n_rows, bocc, lo, hi):
        dev = jsi._shard_device_index(jp, bwt[0], psi[0], C[0], beg[0], None, bocc[0])
        ops = jsd.ShardedIndexOps(dev, n_rows[0])
        l, h = lo[0], hi[0]
        out = ops.window(l, h, w)
        for rp in (0, rows_prev):
            s_lo = jnp.minimum(l + rp, h)
            out += ops.window(s_lo, jnp.minimum(s_lo + width, h), width)
        return out

    fn = shard_map(per_shard, mesh=mesh, in_specs=(P("data"),) * 8, out_specs=(P(),) * 6)
    wt, wv, s0t, s0v, s1t, s1v = jax.device_get(jax.jit(fn)(
        jp.bwt, jp.psi, jp.C, jp.beginnings, jp.n_rows, jp.bucket_occ,
        jnp.asarray(lo.numpy()), jnp.asarray(hi.numpy())))
    lp = torch.as_tensor(rng.normal(size=(B * K, V)).astype(np.float32))

    def expect(tok, ok, fill):
        tok = np.where(ok, tok, fill).astype(np.int32)
        lpj = np.take_along_axis(lp.numpy(), tok.reshape(B * K, -1), 1).reshape(tok.shape)
        return tok, ok, lpj

    ops = tsd.ShardedIndexOps(t)
    got = ops.window_slab(lo, hi, w, width, lp, PAD)
    assert got[0].shape == (B, K, S * w) and got[3].shape == (B, K, S * width)
    _same(got, (*expect(wt, wv, PAD), *expect(s0t, s0v, 0)))
    _same(ops.slab(lo, hi, rows_prev, width, lp), expect(s1t, s1v, 0))
    _same(k2.window_slab_sharded_plain(t, lo, hi, w, width, lp, PAD),
          (*ops.window_gather(lo, hi, w, lp, PAD), *ops.slab(lo, hi, 0, width, lp)))
    assert wv.any() and s1v.any() and not s1v.all()


# ------------------------------------------------------ kernel 12's step mode


@pytest.fixture(scope="module", params=sorted(CASES))
def wavelets(request):
    host = _host(request.param)
    vocab = CASES[request.param][0]
    return request.param, host, vocab, {
        keep: (WaveletFMIndex.from_host(host, vocab=vocab, keep_bwt=keep),
               WaveletIndex.from_host(host, vocab=vocab, keep_bwt=keep, device="cpu"))
        for keep in (False, True)}


def _jax_step(ops, sel_tok, sel_par, lo, hi, finished, step0):
    """JAX's range update (``constrained.py:1416-1430``; step 0, :1344-1349,
    without the stop rule)."""
    par_rows = jnp.arange(sel_tok.shape[0])[:, None]
    prev = ops.range_size(lo, hi)[par_rows, sel_par]
    elo, ehi = ops.extend(sel_tok, lo[par_rows, sel_par], hi[par_rows, sel_par])
    if step0:
        return elo, ehi, prev
    stop = (sel_tok == EOS) | (sel_tok == PAD) | finished[par_rows, sel_par]
    return jnp.where(stop, 0, elo), jnp.where(stop, 0, ehi), prev


@pytest.mark.parametrize("step0", [True, False])
@pytest.mark.parametrize("keep_bwt", [False, True])
def test_wavelet_advance_matches_jax(wavelets, keep_bwt, step0):
    """``wt_ops.advance_ranges`` (and ``SingleIndexOps.advance``) equal JAX's
    update: parents [B, P] with full, empty and n-gram ranges, selections
    of corpus tokens, EOS, PAD and ids outside the vocab."""
    name, host, vocab, pairs = wavelets
    jix, tix = pairs[keep_bwt]
    B, P_, K = 4, 6, 5
    rng = np.random.default_rng(len(name) + 2 * keep_bwt + step0)
    N = host.size()
    text = host.text[:-1] - 1
    lo = rng.integers(0, N, size=(B, P_))
    hi = np.minimum(lo + rng.integers(0, N // 2 + 1, size=(B, P_)), N)
    for b in range(B):  # one- and two-token prefixes of the corpus text
        i = int(rng.integers(0, text.size - 2))
        lo[b, 2], hi[b, 2] = host.get_range(text[i : i + 2][::-1].tolist())
    lo[0, :2], hi[0, :2] = (0, 5), (N, 5)
    sel_par = rng.integers(0, 1 if step0 else P_, size=(B, K))
    sel_tok = rng.choice(text, size=(B, K))
    sel_tok[0, :4] = (EOS, PAD, -1, vocab + 3)
    finished = rng.random((B, P_)) < 0.3
    args = [np.asarray(x, np.int32) for x in (sel_tok, sel_par, lo, hi)] + [finished]
    want = _jax_step(jc.SingleIndexOps(jix), *(jnp.asarray(x) for x in args), step0)
    t = [torch.as_tensor(x) for x in args]
    fin = None if step0 else t[4]
    got = wt_ops.advance_ranges(tix, *t[:4], fin, eos=EOS, pad=PAD)
    assert [x.dtype for x in got] == [torch.int32] * 3
    _same(got, want)
    _same(tc.SingleIndexOps(tix).advance(*t[:4], fin, eos=EOS, pad=PAD), want)
    _same(k12.advance_plain(tix, *t[:4], fin, eos=EOS, pad=PAD), want)
    assert (np.asarray(want[1]) > np.asarray(want[0])).any() and (np.asarray(want[0]) == 0).any()


# ---------------------------------------------- the straggler rounds, e2e


@pytest.mark.parametrize("layout", ["psi", "compact", "hybrid"])
def test_straggler_rounds_match_jax(layout, monkeypatch):
    """Generation through the proven loop (``force_full``, a 2-token round
    0) runs straggler rounds, each slab from ``rows_prev > 0``, and gives
    JAX's hypotheses; the fast path gives them too.  The rounds read the
    support bits (``bucket_support``: kernel 6's or 14's support mode) once
    a step and select through the pruning loader (``pruned_topk``) once a
    round; the counts modes are never called."""
    models = _models()
    jcfg, tcfg, params, tparams = models
    host, queries = _random_corpus(3, hi=14)  # wide intervals over few symbols
    module = fm_ops if layout == "psi" else wt_ops
    seen, calls = [], {"bucket_support": 0, "pruned_topk": 0}
    slab = module.slab_gather
    monkeypatch.setattr(module, "slab_gather",
                        lambda ix, lo, hi, rows_prev, *a: seen.append(rows_prev)
                        or slab(ix, lo, hi, rows_prev, *a))

    def counted(owner, name):
        fn = getattr(owner, name)

        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(owner, name, call)

    counted(module, "bucket_support")
    counted(tc, "pruned_topk")

    def no_counts(*a, **k):
        raise AssertionError("the straggler rounds read the support bits, not the counts")
    monkeypatch.setattr(module, "bucket_counts", no_counts)
    kw = dict(num_beams=4, max_length=6, min_length=1, forced_bos_token_id=None, window=4,
              exact_chunk=2, exact_loop_chunk=2)
    ids, mask = jg.pad_batch(queries, jcfg.pad_token_id)
    jix = (DeviceFMIndex.from_host(host, vocab=96) if layout == "psi"
           else WaveletFMIndex.from_host(host, vocab=96, keep_bwt=layout == "hybrid"))
    tix = (TorchFMIndex.from_host(host, vocab=96, device="cpu") if layout == "psi"
           else WaveletIndex.from_host(host, vocab=96, keep_bwt=layout == "hybrid",
                                       device="cpu"))
    jh = jg.fm_index_generate(jcfg, params, jix, ids, mask, **kw)
    full = tg.fm_index_generate(tcfg, tparams, tix, ids, mask, force_full=True, **kw)
    assert any(r > 0 for r in seen)
    rounds = sum(r > 0 for r in seen)  # a straggler round's slab each
    assert calls["pruned_topk"] == rounds and 0 < calls["bucket_support"] <= rounds
    _assert_same_hyps(jh, full)
    _assert_same_hyps(jh, tg.fm_index_generate(tcfg, tparams, tix, ids, mask, **kw))
