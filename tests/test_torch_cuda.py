"""The port's kernels on the card against their plain versions, and the
port's generation and searcher on the card against their CPU paths.
Needs a CUDA device and skips without one; imports no jax, so it runs
where the card is:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest configures jax.)"""

import numpy as np
import pytest
import torch

from seal_tpu_torch.index.fm_index import FMIndex
from seal_tpu_torch.decoding import constrained as tc
from seal_tpu_torch.decoding import generate as tg
from seal_tpu_torch.index.device_index import TorchFMIndex
from seal_tpu_torch.index.wavelet import WaveletIndex
from seal_tpu_torch import bench_search
from seal_tpu_torch.kernels import (
    adamw,
    beam_select,
    bucket_counts,
    build,
    count_mask,
    decode_attention,
    dense_scores,
    diverse_select,
    fm_search,
    locate,
    reorder_cache,
    rescore,
    row_select,
    row_topk,
    sample_select,
    train_loss,
    triton_logsoftmax,
    window_gather,
    wt_bucket_counts,
    wt_search,
    wt_window,
)
from seal_tpu_torch.models import bart, t5
from seal_tpu_torch.models.config import bart_tiny
from seal_tpu_torch.parallel import sharded_decode, sharded_index

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _zipf_host():
    rng = np.random.default_rng(5)
    toks = (rng.zipf(1.2, size=6000) % 28 + 4).astype(np.int64)
    host = FMIndex()
    host.initialize([d.tolist() for d in np.array_split(toks, 120)])
    return host


def _ranges(host, rng, n=48):
    N = host.size()
    lo = rng.integers(0, N, size=n)
    hi = np.minimum(lo + rng.integers(0, N // 4, size=n), N)
    lo[:3], hi[:3] = (0, 5, N), (N, 5, N)  # full, empty, empty at the end
    return (torch.as_tensor(lo.astype(np.int32)).cuda(),
            torch.as_tensor(hi.astype(np.int32)).cuda())


@pytest.mark.parametrize("dir_shift", [6, 31])
def test_fm_search_matches_plain(cuda, dir_shift):
    host = _zipf_host()
    t = TorchFMIndex.from_host(host, vocab=40, dir_shift=dir_shift, device=cuda)
    rng = np.random.default_rng(0)
    lo, hi = _ranges(host, rng)
    toks = torch.as_tensor(rng.integers(-2, 45, size=(lo.numel(), 9)).astype(np.int32)).cuda()
    n0 = fm_search.fm_search.launches
    got = fm_search.fm_search(t, "contains", toks, lo, hi)
    assert fm_search.fm_search.launches == n0 + 1
    assert torch.equal(got, fm_search.contains_plain(t, toks, lo, hi))
    args = torch.broadcast_tensors(toks, lo[:, None], hi[:, None])
    got = fm_search.fm_search(t, "backward_step", *args)
    want = fm_search.backward_step_plain(t, *args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_window_gather_matches_plain(cuda):
    host = _zipf_host()
    t = TorchFMIndex.from_host(host, vocab=30, device=cuda)  # symbols 30, 31 are OOV
    lo, hi = _ranges(host, np.random.default_rng(1))
    lp = torch.log_softmax(torch.randn(lo.numel(), 30, device=cuda), -1)
    for w, fill in ((4, 1), (16, 0), (32, 1)):
        got = window_gather.window_gather(t, lo, hi, w, lp, fill)
        want = window_gather.window_gather_plain(t, lo, hi, w, lp, fill)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def _topk_rows(rng, rows, n):
    x = np.round(rng.normal(0, 2, size=(rows, n)), 1).astype(np.float32)  # ties, +-0.0
    x[1 % rows] = -np.inf
    x[2 % rows, : n // 3] = 7.5
    x[3 % rows, n - 5 :] = 50.0
    x[4 % rows] = np.float32(tc.NEG_INF)
    x[4 % rows, ::7] = -1.0
    return x


@pytest.mark.parametrize("rows,n,k", [(6, 50265, 30), (6, 50265, 64), (6, 50265, 256),
                                      (6, 960, 30), (6, 158, 30), (6, 70000, 16),
                                      (6, 50265, 512), (6, 50265, 2048), (32, 753975, 30),
                                      (480, 50265, 64), (40, 200000, 64), (6, 3840, 30),
                                      (6, 300, 300), (2, 32 * 50265, 64)])
def test_row_topk_matches_plain(cuda, rows, n, k):
    """Kernel 3 at the call sites' shapes (a beam-32 dense row takes the
    streamed route) on rows with ties, +-0.0, -inf, NEG_INF and a plateau;
    bit for bit, one launch a call."""
    x = torch.as_tensor(_topk_rows(np.random.default_rng(n + k), rows, n)).cuda()
    n0 = row_topk.row_topk.launches
    gv, gi = row_topk.row_topk(x, k)
    assert row_topk.row_topk.launches == n0 + 1
    wv, wi = row_topk.row_topk_plain(x, k)
    assert torch.equal(gi, wi)
    assert torch.equal(gv.view(torch.int32), wv.view(torch.int32))  # bit-exact, signs too


@pytest.mark.parametrize("splits,staged,cap", [(16, None, 0), (5, None, 0), (4, 300, 4096),
                                               (4, 300, 16), (3, 0, 64)])
def test_row_topk_forced_layouts(cuda, splits, staged, cap):
    """Every route on small rows: 16 and 5 CTAs a row (the equal-key cut
    across slices), the streamed tail with room for its candidates, with
    too little (re-read), and with nothing staged."""
    x = torch.as_tensor(_topk_rows(np.random.default_rng(splits), 8, 5000)).cuda()
    for k in (1, 30, 700):
        lay = row_topk.plan(8, 5000, k, splits=splits, staged=staged, cap=cap)
        gv, gi = row_topk.row_topk(x, k, layout=lay)
        wv, wi = row_topk.row_topk_plain(x, k)
        assert torch.equal(gi, wi), (lay, k)
        assert torch.equal(gv.view(torch.int32), wv.view(torch.int32))


def test_row_topk_limits_raise(cuda):
    """The C side's limits equal the wrapper's; past the shared sort buffer
    the call takes the global sort (no refusal); a wrong dtype raises
    before any launch."""
    from seal_tpu_torch.kernels import build

    assert build.lib().seal_row_topk_max_k() == row_topk.MAX_K
    assert build.lib().seal_row_topk_bins_bytes() == row_topk.BINS_BYTES
    x = torch.as_tensor(_topk_rows(np.random.default_rng(7), 2, 20000)).cuda()
    n0 = row_topk.row_topk.launches
    with pytest.raises(ValueError, match="f32"):
        row_topk.row_topk(x.double(), 3)
    with pytest.raises(ValueError, match="width"):
        row_topk.row_topk(x, 20001)
    assert row_topk.row_topk.launches == n0
    gv, gi = row_topk.row_topk(x, row_topk.MAX_K + 1)
    wv, wi = row_topk.row_topk_plain(x, row_topk.MAX_K + 1)
    assert torch.equal(gi, wi) and torch.equal(gv.view(torch.int32), wv.view(torch.int32))
    assert row_topk.row_topk.launches == n0 + 1


@pytest.mark.parametrize("rows,n,k", [(6, 50265, 16385), (480, 50265, 20000), (6, 50265, 50265),
                                      (3, 70000, 40000), (4, 32 * 50265, 20000)])
def test_row_topk_large_k_matches_plain(cuda, rows, n, k):
    """Kernel 3's large-k route (the survivors sorted in device memory):
    just past the shared buffer, the proposal loop's 20000-wide chunk over
    480 rows, a whole row, a staged tail and a streamed dense row; bit for
    bit, one count a call."""
    x = torch.as_tensor(_topk_rows(np.random.default_rng(k), rows, n)).cuda()
    assert row_topk.plan(rows, n, k).sort == "global"
    n0, g0 = row_topk.row_topk.launches, row_topk.GLOBAL_SORT.launches
    gv, gi = row_topk.row_topk(x, k)
    assert (row_topk.row_topk.launches, row_topk.GLOBAL_SORT.launches) == (n0 + 1, g0 + 1)
    wv, wi = row_topk.row_topk_plain(x, k)
    assert torch.equal(gi, wi)
    assert torch.equal(gv.view(torch.int32), wv.view(torch.int32))


def test_stream_ptr_is_current_stream(cuda):
    """``build.stream_ptr`` names the current stream: the default one, a
    side stream's, and the capturing stream's under ``torch.cuda.graph``,
    where a kernel launched through it is captured and replays."""
    from seal_tpu_torch.kernels import build

    x = torch.zeros(4, device=cuda)
    assert build.stream_ptr(x) == torch.cuda.current_stream(cuda).cuda_stream
    side = torch.cuda.Stream(cuda)
    with torch.cuda.stream(side):
        assert build.stream_ptr(x) == side.cuda_stream == torch.cuda.current_stream().cuda_stream
    beg = torch.arange(0, 4000, 7, dtype=torch.int32, device=cuda)
    pos = torch.arange(-3, 4005, dtype=torch.int32, device=cuda)
    out = locate.doc_index_of(beg, pos)
    torch.cuda.synchronize()
    graph, seen = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph):
        seen.append((build.stream_ptr(x), torch.cuda.current_stream().cuda_stream))
        out = locate.doc_index_of(beg, pos)
    assert seen[0][0] == seen[0][1]
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, locate.doc_index_of_plain(beg, pos))


def test_log_softmax_matches_plain(cuda):
    logits = torch.randn(40, 50265, device=cuda) * 3
    logits[:, 1] = float("-inf")
    for ban in (-1, 2):
        got = triton_logsoftmax.log_softmax_ban(logits, ban, tc.NEG_INF)
        want = triton_logsoftmax.log_softmax_ban_plain(logits, ban, tc.NEG_INF)
        # f32 row sums in another order than torch's
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generate_on_card_matches_cpu(cuda, seed):
    """The kernels' path gives the CPU plain path's hypotheses: equal
    token lists, scores within 1e-4."""
    cfg = bart_tiny(vocab_size=96)
    params = bart.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(seed)
    docs = [rng.integers(4, 90, size=rng.integers(5, 30)).tolist() + [2] for _ in range(30)]
    host = FMIndex()
    host.initialize(docs)
    queries = [[0] + rng.integers(4, 90, size=5).tolist() + [2] for _ in range(3)]
    kw = dict(num_beams=4, max_length=6, min_length=1, window=4, exact_chunk=4)
    cpu = tg.fm_index_generate(cfg, params, TorchFMIndex.from_host(host, vocab=96, device="cpu"),
                               queries, **kw)
    gpu = tg.fm_index_generate(cfg, _to(params, cuda),
                               TorchFMIndex.from_host(host, vocab=96, device=cuda), queries, **kw)
    for a, b in zip(cpu, gpu):
        ka, kb = sorted((tuple(t), s) for s, t in a), sorted((tuple(t), s) for s, t in b)
        assert [t for t, _ in ka] == [t for t, _ in kb]
        np.testing.assert_allclose([s for _, s in kb], [s for _, s in ka], atol=1e-4, rtol=0)


@pytest.mark.parametrize("n,L", [(48, 3), (4096, 16)])
def test_fm_sequences_matches_plain(cuda, n, L):
    """Kernel 5: corpus n-grams (non-empty ranges), random and
    out-of-range tokens, every length 0..L; exactly equal."""
    host = _zipf_host()
    t = TorchFMIndex.from_host(host, vocab=40, device=cuda)
    rng = np.random.default_rng(n)
    text = host.text[:-1] - 1  # the documents, each reversed
    starts = rng.integers(0, text.size - L, size=n)
    toks = np.stack([text[s : s + L][::-1] for s in starts]).astype(np.int32)
    toks[: n // 8] = rng.integers(-2, 45, size=(n // 8, L))
    lens = rng.integers(0, L + 1, size=n).astype(np.int32)
    toks_c, lens_c = torch.as_tensor(toks).cuda(), torch.as_tensor(lens).cuda()
    n0 = fm_search.fm_sequences.launches
    got = fm_search.fm_sequences(t, toks_c, lens_c)
    assert fm_search.fm_sequences.launches == n0 + 1
    want = fm_search.sequences_plain(t, toks_c, lens_c)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ((got[1] - got[0]) > 0).any()


@pytest.mark.parametrize("shape", [(48,), (16, 15)])
def test_bucket_counts_matches_plain(cuda, shape):
    """Kernel 6: random ranges, block edges, the sentinel row, clamping."""
    host = _zipf_host()
    t = TorchFMIndex.from_host(host, vocab=30, device=cuda)  # symbols 30, 31 are OOV
    lo, hi = _ranges(host, np.random.default_rng(len(shape)), n=int(np.prod(shape)))
    lo[3], hi[3] = 1024, 2048
    lo[4], hi[4] = 1023, 1025
    lo[5], hi[5] = -7, host.size() + 9
    lo, hi = lo.reshape(shape), hi.reshape(shape)
    got = bucket_counts.bucket_counts(t, lo, hi)
    assert torch.equal(got, bucket_counts.bucket_counts_plain(t, lo, hi))


@pytest.mark.parametrize("shape,n_prefix", [((8, 7, 99), 0), ((64, 16, 50265), 1)])
def test_rescore_logprob_matches_plain(cuda, shape, n_prefix):
    """Kernel 7 within 1e-4 per key (f32 row sums in another order), and
    the same bits from run to run."""
    g = torch.Generator(device=cuda).manual_seed(0)
    logits = torch.randn(shape, generator=g, device=cuda) * 3
    logits[..., 1] = float("-inf")
    tgt = torch.randint(0, shape[-1], shape[:2], generator=g, device=cuda, dtype=torch.int32)
    tgt[:, -3:] = 1  # pad
    got = rescore.rescore_logprob(logits, tgt, n_prefix)
    want = rescore.rescore_logprob_plain(logits, tgt, n_prefix)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    assert torch.equal(got, rescore.rescore_logprob(logits, tgt, n_prefix))


def test_searcher_on_card_matches_cpu(cuda):
    """The tiny searcher on the card gives the CPU path's ranking: the same
    doc ids in the same order, scores within 1e-4 relative."""
    cpu = bench_search.tiny_searcher("cpu").batch_search(bench_search.TINY_QUERIES, k=5)
    gpu = bench_search.tiny_searcher(cuda).batch_search(bench_search.TINY_QUERIES, k=5)
    for a, b in zip(cpu, gpu):
        assert [d.docid for d in b] == [d.docid for d in a]
        np.testing.assert_allclose([d.score for d in b], [d.score for d in a], rtol=1e-4)


def _same(got, want):
    """Every output equal; floats bit for bit."""
    for a, b in zip(got, want):
        if a is None and b is None:
            continue
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


def _lp(g, rows, V, cuda):
    lp = torch.round(torch.log_softmax(torch.randn(rows, V, generator=g, device=cuda) * 2, -1) * 4) / 4
    lp[:, 5] = 0.0
    lp[::2, 6] = -0.0  # +0.0 ranks above -0.0
    lp[::3, 1] = float("-inf")
    return lp


@pytest.mark.parametrize("B,K,n_top,with_buf", [(32, 15, 64, False), (32, 15, 256, True),
                                                 (4, 32, 512, True)])
def test_beam_merge_matches_plain(cuda, B, K, n_top, with_buf):
    """Kernel 8, merge: buffer + LM top (a strided membership view) + slab,
    with repeated tokens, ties and signed zeros; exactly equal."""
    g = torch.Generator(device=cuda).manual_seed(n_top)
    V, n_buf = 3000, 2 * K
    lp = _lp(g, B * K, V, cuda)
    top_lp, top_idx = row_topk.row_topk_plain(lp, n_top)
    top_tok = top_idx.to(torch.int32).reshape(B, K, n_top)
    ok = (torch.rand(B, K, n_top + 1, generator=g, device=cuda) < 0.5)[..., :n_top]
    slab_tok = torch.randint(0, 300, (B, K, n_top), generator=g, device=cuda, dtype=torch.int32)
    slab_lp = torch.gather(lp, 1, slab_tok.reshape(B * K, -1).long()).reshape(B, K, n_top)
    slab_ok = torch.rand(B, K, n_top, generator=g, device=cuda) < 0.8
    buf = None
    if with_buf:
        btok = torch.randint(0, 300, (B, K, n_buf), generator=g, device=cuda, dtype=torch.int32)
        buf = (btok, torch.gather(lp, 1, btok.reshape(B * K, -1).long()).reshape(B, K, n_buf),
               torch.rand(B, K, n_buf, generator=g, device=cuda) < 0.7)
    args = (buf, top_tok, top_lp.reshape(B, K, n_top), ok, slab_tok, slab_lp, slab_ok, V, n_buf)
    n0 = beam_select.beam_merge.launches
    got = beam_select.beam_merge(*args)
    assert beam_select.beam_merge.launches == n0 + 1
    _same(got, beam_select.beam_merge_plain(*args))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("B,K,n_buf,n_top", [(32, 15, 512, 4096), (4, 15, 30, 20000),
                                             (2, 32, 2048, 8192), (2, 4, 8, 4100)])
def test_beam_merge_large_route_matches_plain(cuda, B, K, n_buf, n_top, ties):
    """Kernel 8's large-n merge at the sizes the one-CTA merge refused:
    sampling's loop round at top_m 512 (8,704 candidates a row), an
    exact_loop_chunk of 20,000 at beam 15 (40,030), a 2,048-wide buffer
    (the widest under ties) and a row just past one CTA; in both orders,
    with repeated tokens (one log-prob each, as the merge's inputs carry),
    ties and signed zeros; exactly equal to the one-CTA plain version."""
    g = torch.Generator(device=cuda).manual_seed(n_top + ties)
    V = 50265
    lp = _lp(g, B * K, V, cuda)
    top_lp, top_idx = row_topk.row_topk_plain(lp, n_top)
    top_tok = top_idx.to(torch.int32).reshape(B, K, n_top)
    ok = (torch.rand(B, K, n_top + 1, generator=g, device=cuda) < 0.5)[..., :n_top]
    slab_tok = torch.randint(0, min(3 * n_top, V), (B, K, n_top), generator=g, device=cuda,
                             dtype=torch.int32)
    slab_lp = torch.gather(lp, 1, slab_tok.reshape(B * K, -1).long()).reshape(B, K, n_top)
    slab_ok = torch.rand(B, K, n_top, generator=g, device=cuda) < 0.8
    bt = torch.stack([torch.randperm(V, generator=g, device=cuda)[:n_buf] for _ in range(B * K)])
    btok = bt.to(torch.int32).reshape(B, K, n_buf)  # distinct valid tokens, as a buffer holds
    bvalid = (torch.rand(B, K, n_buf, generator=g, device=cuda) < 0.7) & (
        torch.gather(lp, 1, bt).reshape(B, K, n_buf) > tc.NEG_INF / 2)
    buf = (btok, torch.gather(lp, 1, bt).reshape(B, K, n_buf), bvalid)
    args = (buf, top_tok, top_lp.reshape(B, K, n_top), ok, slab_tok, slab_lp, slab_ok, V, n_buf)
    from seal_tpu_torch.kernels import build

    assert build.lib().seal_beam_merge_smem(n_buf + 2 * n_top, int(ties)) > build.SMEM_LIMIT
    n0, l0 = beam_select.beam_merge.launches, beam_select.MERGE_LARGE.launches
    got = beam_select.beam_merge(*args, ties=ties)
    assert (beam_select.beam_merge.launches, beam_select.MERGE_LARGE.launches) == (n0 + 1, l0 + 1)
    _same(got, beam_select.beam_merge_plain(*args, ties=ties))
    none = beam_select.beam_merge(None, *args[1:], ties=ties)  # round 0's empty buffer
    _same(none, beam_select.beam_merge_plain(None, *args[1:], ties=ties))


LARGE_ROUTES = {
    # sampling's buffer max(2K, top_m) = 512: a loop round merges 8,704 a row
    "sample_top_m_512": dict(sample=True, seed=3, top_m=512),
    # and a 20,000-wide loop chunk: kernel 3 at k = 20,000, merges of 40,512
    "sample_loop_chunk_20000": dict(sample=True, seed=3, top_m=512, exact_loop_chunk=20000),
    # the proven loop at beam 15 with a 20,000-wide chunk
    "force_full_loop_chunk_20000": dict(force_full=True, exact_loop_chunk=20000),
}


@pytest.mark.parametrize("mode", sorted(LARGE_ROUTES))
def test_large_routes_generate_on_card_match_cpu(cuda, mode):
    """The sizes the card refused before (ROADMAP C.2) run through kernel
    routes at beam 15 on BART's vocab: a tiny BART with a corpus-unigram
    bias over a Zipf corpus, the card's hypotheses equal to the CPU plain
    path's (token lists, scores within 1e-4); the large-n merge and kernel
    3's global sort launched where the mode reaches them."""
    from seal_tpu_torch.bench_generate import _unigram_bias

    V = 50265
    cfg = bart_tiny(vocab_size=V)
    params = bart.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    toks = (rng.zipf(1.3, size=100000) % (V - 4) + 4).astype(np.int64)
    params["final_logits_bias"] = params["final_logits_bias"] + torch.as_tensor(
        _unigram_bias(toks, V), dtype=torch.float32)
    host = FMIndex()
    host.initialize([d.tolist() + [2] for d in np.array_split(toks, 300)])
    queries = [[0] + rng.integers(4, 400, size=6).tolist() + [2] for _ in range(2)]
    kw = dict(num_beams=15, max_length=5, min_length=1, **LARGE_ROUTES[mode])
    cpu = tg.fm_index_generate(cfg, params, TorchFMIndex.from_host(host, vocab=V, device="cpu"),
                               queries, **kw)
    m0, s0 = beam_select.MERGE_LARGE.launches, row_topk.GLOBAL_SORT.launches
    gpu = tg.fm_index_generate(cfg, _to(params, cuda),
                               TorchFMIndex.from_host(host, vocab=V, device=cuda), queries, **kw)
    if mode.startswith("sample"):
        assert beam_select.MERGE_LARGE.launches > m0
    if mode == "sample_loop_chunk_20000":
        assert row_topk.GLOBAL_SORT.launches > s0
    for a, b in zip(cpu, gpu):
        ka, kb = sorted((tuple(t), s) for s, t in a), sorted((tuple(t), s) for s, t in b)
        assert [t for t, _ in ka] == [t for t, _ in kb]
        np.testing.assert_allclose([s for _, s in kb], [s for _, s in ka], atol=1e-4, rtol=0)


@pytest.mark.parametrize("B,K,w,case", [(32, 15, 32, "need"), (32, 15, 32, "no_buffer"),
                                         (8, 32, 128, "need"), (8, 15, 32, "branches")])
def test_beam_select_matches_plain(cuda, B, K, w, case):
    """Kernel 8, select: beam 15 at the generation point and beam 32 with a
    128-row window (6,208 candidates a query); exactly equal."""
    g = torch.Generator(device=cuda).manual_seed(B * K + w)
    V, n_buf = 3000, 2 * K
    lp = _lp(g, B * K, V, cuda)

    def take(tok):
        return torch.gather(lp, 1, tok.reshape(B * K, -1).long()).reshape(tok.shape)

    btok = torch.randint(0, 400, (B, K, n_buf), generator=g, device=cuda, dtype=torch.int32)
    buf = (btok, take(btok), torch.rand(B, K, n_buf, generator=g, device=cuda) < 0.7)
    if case == "no_buffer":
        buf = None
    win_valid = torch.rand(B, K, w, generator=g, device=cuda) < 0.7
    win_tok = torch.where(win_valid, torch.randint(0, 400, (B, K, w), generator=g, device=cuda,
                                                   dtype=torch.int32), 1)
    eos_ok = (torch.rand(B, K, 3, generator=g, device=cuda) < 0.5)[..., 2:]
    prev_count = torch.randint(0, 6, (B, K), generator=g, device=cuda, dtype=torch.int32)
    finished = torch.rand(B, K, generator=g, device=cuda) < 0.2
    bs = torch.round(torch.randn(B, K, generator=g, device=cuda) * 2) / 2 - 3
    bs[0, 1] = tc.NEG_INF
    need = torch.rand(B, K, generator=g, device=cuda) < 0.5
    th_lp = torch.round(torch.randn(B, K, generator=g, device=cuda)) - 4
    kw = dict(K=K, eos=2, pad=1, stop_at_count=2 if case == "branches" else 0,
              always_allow_eos=case == "branches")
    args = (buf, n_buf, win_tok, win_valid, take(win_tok), eos_ok, lp, prev_count, finished, bs,
            need, th_lp)
    (got, bad), (want, wbad) = beam_select.beam_select(*args, **kw), \
        beam_select.beam_select_plain(*args, **kw)
    _same(got + (bad,), want + (wbad,))


@pytest.mark.parametrize("B,n_par,V,K", [(32, 1, 50265, 15), (4, 4, 1000, 4)])
def test_beam_select_top_matches_plain(cuda, B, n_par, V, K):
    """Kernel 8 on step 0: the epilogue after kernel 3's V-wide top-2K."""
    g = torch.Generator(device=cuda).manual_seed(V)
    lp = _lp(g, B * n_par, V, cuda)
    lp[0, 2] = 1.0  # EOS among the picks
    bs = torch.full((B, K), tc.NEG_INF, device=cuda)
    bs[:, 0] = 0.0
    cons = torch.where(torch.rand(V, generator=g, device=cuda) < 0.6, lp.reshape(B, n_par, V),
                       tc.NEG_INF) + bs[:, :n_par, None]
    top_cons, top_idx = row_topk.row_topk(cons.reshape(B, -1), 2 * K)
    args = (top_cons, top_idx, lp, bs, n_par, K, 2)
    _same(beam_select.beam_select_top(*args), beam_select.beam_select_top_plain(*args))


@pytest.mark.parametrize("Bq,g,M,dtype", [(32, 15, 14, torch.bfloat16), (32, 1, 14, torch.bfloat16),
                                          (6, 4, 37, torch.float32),
                                          (32, 15, 1024, torch.bfloat16),
                                          (4, 32, 1024, torch.bfloat16),
                                          (4, 3, 200, torch.float32)])
def test_cross_attention_matches_plain(cuda, Bq, g, M, dtype):
    """Kernel 9 over padded encoder positions: in bf16 within one output
    ulp plus one bf16 step of each probability (sums in another order),
    in f32 within 1e-5.  M up to the encoder's 1024 positions, staged in
    tiles (200 ends in a partial one)."""
    gen = torch.Generator(device=cuda).manual_seed(M)
    H, Dh = 16, 64
    q = (torch.randn(Bq * g, H, Dh, generator=gen, device=cuda) * 0.125).to(dtype)
    k = torch.randn(Bq, M, H, Dh, generator=gen, device=cuda).to(dtype)
    v = torch.randn(Bq, M, H, Dh, generator=gen, device=cuda).to(dtype)
    bias = torch.zeros(Bq, M, device=cuda)
    bias[::2, -3:] = -1e9
    got = decode_attention.cross_attention_step(q, k, v, bias)
    want = decode_attention.decode_attention_plain(q, k, v, bias)
    if dtype == torch.bfloat16:
        assert decode_attention.bf16_error_ratio(got, want, q, k, v, bias) <= 1.0
    else:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("rows,L,step,dtype", [(480, 10, 8, torch.bfloat16),
                                               (32, 10, 0, torch.bfloat16),
                                               (20, 25, 13, torch.float32),
                                               (16, 160, 150, torch.bfloat16)])
def test_self_attention_matches_plain(cuda, rows, L, step, dtype):
    """Kernel 10 over the live slots [0, step] of a cache against the plain
    version over every slot under the -1e9 bias."""
    gen = torch.Generator(device=cuda).manual_seed(step)
    H, Dh = 16, 64
    q = (torch.randn(rows, H, Dh, generator=gen, device=cuda) * 0.125).to(dtype)
    kc = torch.zeros(rows, L, H, Dh, device=cuda, dtype=dtype)
    vc = torch.zeros(rows, L, H, Dh, device=cuda, dtype=dtype)
    kc[:, : step + 1] = torch.randn(rows, step + 1, H, Dh, generator=gen, device=cuda).to(dtype)
    vc[:, : step + 1] = torch.randn(rows, step + 1, H, Dh, generator=gen, device=cuda).to(dtype)
    got = decode_attention.self_attention_step(q, kc, vc, step)
    want = decode_attention.self_attention_plain(q, kc, vc, step)
    if dtype == torch.bfloat16:
        assert decode_attention.bf16_error_ratio(got, want, q, kc, vc, None, step + 1) <= 1.0
    else:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("rows,L,step,dtype", [(480, 10, 9, torch.bfloat16),
                                               (480, 10, 0, torch.float32),
                                               (32, 10, 4, torch.bfloat16),
                                               (16, 160, 150, torch.bfloat16),
                                               (20, 25, 13, torch.float32)])
def test_self_attention_rel_matches_plain(cuda, rows, L, step, dtype):
    """Kernel 10's relative-bias mode (T5): an un-scaled q, T5-base's 12
    heads of 64, the bucket table in the compute dtype (a bf16 table is
    widened in the kernel) and the decoder's bucket-of-distance vector,
    against the plain version over every slot under the
    relative-bias row plus -1e9 past ``step`` (160 slots: three tiles and
    distances past the last bucket's 128)."""
    gen = torch.Generator(device=cuda).manual_seed(step + L)
    H, Dh = 12, 64
    q = (torch.randn(rows, H, Dh, generator=gen, device=cuda) * 0.2).to(dtype)
    kc = torch.zeros(rows, L, H, Dh, device=cuda, dtype=dtype)
    vc = torch.zeros(rows, L, H, Dh, device=cuda, dtype=dtype)
    kc[:, : step + 1] = torch.randn(rows, step + 1, H, Dh, generator=gen, device=cuda).to(dtype)
    vc[:, : step + 1] = torch.randn(rows, step + 1, H, Dh, generator=gen, device=cuda).to(dtype)
    table = (torch.randn(32, H, generator=gen, device=cuda) * 2).to(dtype)  # cast_params' dtype
    buckets = t5.bucket_of_distance(t5.T5Config(), L, cuda)
    n0 = decode_attention.self_attention_step_rel.launches
    got = decode_attention.self_attention_step_rel(q, kc, vc, step, table, buckets)
    assert decode_attention.self_attention_step_rel.launches == n0 + 1
    want = decode_attention.self_attention_rel_plain(q, kc, vc, step, table, buckets)
    if dtype == torch.bfloat16:
        head_bias = decode_attention.relative_bias_row(table, buckets, step, L)
        assert decode_attention.bf16_error_ratio(got, want, q, kc, vc, head_bias=head_bias) <= 1.0
    else:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    with pytest.raises(ValueError):  # the table must be f32 or bf16
        decode_attention.self_attention_step_rel(q, kc, vc, step, table.half(), buckets)


def _attn_ratio(got, want, q, k, v, bias=None, m=None, head_bias=None):
    """The share of its dtype's tolerance an attention output uses."""
    ratio_of = (decode_attention.bf16_error_ratio if q.dtype == torch.bfloat16
                else decode_attention.f32_error_ratio)
    return ratio_of(got, want, q, k, v, bias, m, head_bias)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M", [1, 14, 63, 64, 65, 200, 1024])
@pytest.mark.parametrize("g", [1, 15, 16, 17, 32])
def test_cross_attention_routes_match_plain(cuda, g, M, dtype):
    """Kernel 9 on every route at the routes' edges: one beam (the warp
    route: one chunk, two passes past 32 bf16 or 16 f32 positions), one and
    two m16 tiles of beams on the mma route (a cluster of 1 at M <= 64, 2
    at 65, 4 with a partial slice at 200, 16 at 1024), the ffma route up to
    64 f32 positions and the tiled route past it; a padded query and a
    query masked past half its positions; each dtype within its tolerance,
    one launch a call on the route ``route`` names."""
    gen = torch.Generator(device=cuda).manual_seed(g * 10000 + M)
    Bq, H, Dh = 3, 16, 64
    q = (torch.randn(Bq * g, H, Dh, generator=gen, device=cuda) * 0.125).to(dtype)
    k = torch.randn(Bq, M, H, Dh, generator=gen, device=cuda).to(dtype)
    v = torch.randn(Bq, M, H, Dh, generator=gen, device=cuda).to(dtype)
    bias = torch.zeros(Bq, M, device=cuda)
    bias[1, M - min(3, M - 1):] = decode_attention.NEG_BIAS
    bias[2, (M + 1) // 2:] = decode_attention.NEG_BIAS
    name = decode_attention.route(g, M, Dh, dtype == torch.bfloat16)
    assert name == ("warp" if g == 1 else "mma" if dtype == torch.bfloat16
                    else "ffma" if M <= 64 else "tiled")
    n0, r0 = decode_attention.cross_attention_step.launches, decode_attention.ROUTES[name].launches
    got = decode_attention.cross_attention_step(q, k, v, bias)
    assert decode_attention.cross_attention_step.launches == n0 + 1
    assert decode_attention.ROUTES[name].launches == r0 + 1
    want = decode_attention.decode_attention_plain(q, k, v, bias)
    assert _attn_ratio(got, want, q, k, v, bias) <= 1.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("L,step", [(10, 0), (10, 8), (10, 9), (40, 15), (40, 31), (40, 39)])
@pytest.mark.parametrize("rel", [False, True])
def test_self_attention_warp_route_matches_plain(cuda, L, step, dtype, rel):
    """Kernel 10 (and its relative-bias mode) on the warp route at steps 0,
    8 and max_len - 1 of the generation point's 10 slots and of a 40-slot
    cache (one chunk of 32 bf16 or 16 f32 slots, and two passes past it),
    T5's un-scaled q in the relative-bias mode; each dtype within its
    tolerance."""
    gen = torch.Generator(device=cuda).manual_seed(step + L + 100 * rel)
    rows, H, Dh = 48, 12 if rel else 16, 64
    scale = 1.0 if rel else 0.125
    q = (torch.randn(rows, H, Dh, generator=gen, device=cuda) * scale).to(dtype)
    kc = torch.zeros(rows, L, H, Dh, device=cuda, dtype=dtype)
    vc = torch.zeros(rows, L, H, Dh, device=cuda, dtype=dtype)
    kc[:, : step + 1] = torch.randn(rows, step + 1, H, Dh, generator=gen, device=cuda).to(dtype)
    vc[:, : step + 1] = torch.randn(rows, step + 1, H, Dh, generator=gen, device=cuda).to(dtype)
    r0 = decode_attention.ROUTES["warp"].launches
    if rel:
        table = (torch.randn(32, H, generator=gen, device=cuda) * 2).to(dtype)
        buckets = t5.bucket_of_distance(t5.T5Config(), L, cuda)
        got = decode_attention.self_attention_step_rel(q, kc, vc, step, table, buckets)
        want = decode_attention.self_attention_rel_plain(q, kc, vc, step, table, buckets)
        head_bias = decode_attention.relative_bias_row(table, buckets, step, L)
        assert _attn_ratio(got, want, q, kc, vc, m=L, head_bias=head_bias) <= 1.0
    else:
        got = decode_attention.self_attention_step(q, kc, vc, step)
        want = decode_attention.self_attention_plain(q, kc, vc, step)
        assert _attn_ratio(got, want, q, kc, vc, None, step + 1) <= 1.0
    assert decode_attention.ROUTES["warp"].launches == r0 + 1


@pytest.mark.parametrize("case", ["g33", "m1025", "f32_m65", "dh32", "unaligned", "heads6"])
def test_decode_attention_route_limits(cuda, case):
    """Past each fast route's limit a call takes the tiled route (33 beams,
    1,025 bf16 positions, 65 f32 positions with 2 beams, head_dim 32,
    operands off the 16-byte grid), and 6 heads take two heads a CTA;
    equal to the plain version within the dtype's tolerance."""
    gen = torch.Generator(device=cuda).manual_seed(33)
    Bq, g, M, H, Dh, dt = 2, 15, 14, 16, 64, torch.bfloat16
    if case == "g33":
        g = 33
    elif case == "m1025":
        M = 1025
    elif case == "f32_m65":
        g, M, dt = 2, 65, torch.float32
    elif case == "dh32":
        Dh = 32
    elif case == "heads6":
        H = 6
    q = (torch.randn(Bq * g, H, Dh, generator=gen, device=cuda) * 0.125).to(dt)
    k = torch.randn(Bq, M, H, Dh, generator=gen, device=cuda).to(dt)
    v = torch.randn(Bq, M, H, Dh, generator=gen, device=cuda).to(dt)
    if case == "unaligned":  # one element past the grid, strides as a cache's
        flat = torch.randn(2, Bq * M * H * Dh + 1, generator=gen, device=cuda).to(dt)
        k, v = (torch.as_strided(f, (Bq, M, H, Dh), (M * H * Dh, H * Dh, Dh, 1), 1) for f in flat)
    bias = torch.zeros(Bq, M, device=cuda)
    bias[1, -3:] = decode_attention.NEG_BIAS
    name = "mma" if case == "heads6" else "tiled"
    assert decode_attention.heads_a_cta(H) == (2 if case == "heads6" else 4)
    r0 = decode_attention.ROUTES[name].launches
    got = decode_attention.cross_attention_step(q, k, v, bias)
    assert decode_attention.ROUTES[name].launches == r0 + 1
    want = decode_attention.decode_attention_plain(q, k, v, bias)
    assert _attn_ratio(got, want, q, k, v, bias) <= 1.0


def test_decode_attention_under_graph_capture(cuda):
    """The routes launch on the capturing stream: kernels 9 (mma, with a
    cluster of 16) and 10 captured in a CUDA graph replay to the eager
    results."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    bf = torch.bfloat16
    q = (torch.randn(8 * 15, 16, 64, generator=gen, device=cuda) * 0.125).to(bf)
    k = torch.randn(8, 1024, 16, 64, generator=gen, device=cuda).to(bf)
    v = torch.randn(8, 1024, 16, 64, generator=gen, device=cuda).to(bf)
    kc = torch.randn(8 * 15, 10, 16, 64, generator=gen, device=cuda).to(bf)
    eager = (decode_attention.cross_attention_step(q, k, v, None),
             decode_attention.self_attention_step(q, kc, kc, 8))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = (decode_attention.cross_attention_step(q, k, v, None),
                decode_attention.self_attention_step(q, kc, kc, 8))
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(outs, eager):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_attention_unscaled_matches_plain(cuda, dtype):
    """Kernel 9 as T5 calls it: q un-scaled at T5-base's magnitudes, 15
    beams per query over a padded encoder of 40 positions, each dtype
    within its tolerance (f32: ``f32_error_ratio``, the scores reach ~50)."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    bq, beams, M, H, Dh = 8, 15, 40, 12, 64
    q = (torch.randn(bq * beams, H, Dh, generator=gen, device=cuda) * 1.4).to(dtype)
    k = (torch.randn(bq, M, H, Dh, generator=gen, device=cuda) * 1.4).to(dtype)
    v = torch.randn(bq, M, H, Dh, generator=gen, device=cuda).to(dtype)
    bias = torch.zeros(bq, M, device=cuda)
    bias[::3, -3:] = decode_attention.NEG_BIAS
    got = decode_attention.cross_attention_step(q, k, v, bias)
    want = decode_attention.decode_attention_plain(q, k, v, bias)
    ratio_of = (decode_attention.f32_error_ratio if dtype == torch.float32
                else decode_attention.bf16_error_ratio)
    assert ratio_of(got, want, q, k, v, bias) <= 1.0


def test_t5_buckets_on_card_equal_the_cpus(cuda):
    """The bucket indices are made on the CPU and moved: the card's
    bucket-of-distance vector over distances 0-1023 and the encoder's and
    decoder's [L, L] position biases equal the CPU's."""
    cfg = t5.T5Config()
    got = t5.bucket_of_distance(cfg, 1024, cuda)
    assert got.is_cuda and got.dtype == torch.int32
    assert torch.equal(got.cpu(), t5.bucket_of_distance(cfg, 1024, "cpu"))
    table = torch.randn(32, 12)
    for bidirectional in (True, False):
        want = t5._position_bias(cfg, table, 300, 300, bidirectional)
        assert torch.equal(t5._position_bias(cfg, table.to(cuda), 300, 300, bidirectional).cpu(),
                           want)


@pytest.mark.parametrize("mode", ["fast", "exact_mask"])
def test_t5_generate_on_card_matches_cpu(cuda, mode):
    """Tiny T5 through the kernels' path against the CPU plain path: equal
    token lists, scores within 1e-4; kernel 10's relative-bias mode and
    kernel 9 launch once per decoder layer and step, BART's self-attention
    mode never."""
    cfg = t5.t5_tiny(vocab_size=60)
    params = t5.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(3)
    docs = [rng.integers(2, 60, size=rng.integers(5, 25)).tolist() + [1] for _ in range(30)]
    host = FMIndex()
    host.initialize(docs)
    queries = [rng.integers(2, 60, size=5).tolist() + [1] for _ in range(3)]
    kw = dict(num_beams=4, max_length=6, min_length=1, forced_bos_token_id=None,
              exact_mask=mode == "exact_mask")
    cpu = tg.fm_index_generate(cfg, params, TorchFMIndex.from_host(host, vocab=60, device="cpu"),
                               queries, **kw)
    counts = (decode_attention.self_attention_step_rel, decode_attention.cross_attention_step,
              decode_attention.self_attention_step)
    n0 = [f.launches for f in counts]
    gpu = tg.fm_index_generate(cfg, _to(params, cuda),
                               TorchFMIndex.from_host(host, vocab=60, device=cuda), queries, **kw)
    n = [f.launches - a for f, a in zip(counts, n0)]
    per_decode = cfg.num_layers * (kw["max_length"] - 1)  # a force_full redo decodes twice
    assert n[0] == n[1] and n[0] in (per_decode, 2 * per_decode) and n[2] == 0
    assert sum(map(len, gpu)) > 0
    for a, b in zip(cpu, gpu):
        ka, kb = sorted((tuple(t), s) for s, t in a), sorted((tuple(t), s) for s, t in b)
        assert [t for t, _ in ka] == [t for t, _ in kb]
        np.testing.assert_allclose([s for _, s in kb], [s for _, s in ka], atol=1e-4, rtol=0)


@pytest.mark.parametrize("rows_src,rows,cols", [(480, 480, 9), (32, 480, 1)])
def test_reorder_cache_matches_plain(cuda, rows_src, rows, cols):
    """Kernel 11: 24 tensors in one launch, live columns only; equal to the
    plain copy and to the full gather (the columns past them are zero)."""
    gen = torch.Generator(device=cuda).manual_seed(cols)
    src = []
    for _ in range(24):
        t = torch.zeros(rows_src, 10, 16, 64, device=cuda, dtype=torch.bfloat16)
        t[:, :cols] = torch.randn(rows_src, cols, 16, 64, generator=gen, device=cuda).to(t.dtype)
        src.append(t)
    idx = torch.randint(0, rows_src, (rows,), generator=gen, device=cuda)
    dst = [torch.zeros(rows, 10, 16, 64, device=cuda, dtype=torch.bfloat16) for _ in src]
    n0 = reorder_cache.reorder_cache.launches
    reorder_cache.reorder_cache(src, idx, cols, dst)
    assert reorder_cache.reorder_cache.launches == n0 + 1
    for d, s in zip(dst, src):
        assert torch.equal(d.view(torch.int16), s[idx].view(torch.int16))


# wavelet corpora at 1 to 5 four-bit digits (each digit count the ranking
# kernels are built for): (vocab, largest symbol + 1, n_docs), as in
# tests/test_torch_wavelet.py, and 3 digits
WT_CASES = {"d1": (14, 14, 12), "d2": (96, 90, 30), "d3": (3000, 2990, 20),
            "d4": (50265, 50200, 30), "d5": (65600, 65590, 8)}


def _wt_host(name):
    vocab, hi, n_docs = WT_CASES[name]
    rng = np.random.default_rng(vocab)
    docs = [rng.integers(0, hi, size=rng.integers(2, 40)).tolist() for _ in range(n_docs)]
    docs[0] += [hi - 1, hi - 1]
    host = FMIndex()
    host.initialize(docs)
    return host


def _check_wt_kernels(t, host, vocab, lo, hi, toks, seqs, lens, lp):
    """Kernels 12-14 on the card against their plain versions, exactly."""
    n0 = wt_search.wt_search.launches
    got = wt_search.wt_search(t, "contains", toks, lo, hi)
    assert wt_search.wt_search.launches == n0 + 1
    assert torch.equal(got, wt_search.contains_plain(t, toks, lo, hi))
    args = torch.broadcast_tensors(toks, lo[..., None], hi[..., None])
    got = wt_search.wt_search(t, "backward_step", *args)
    want = wt_search.backward_step_plain(t, *args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = wt_search.wt_sequences(t, seqs, lens)
    want = wt_search.sequences_plain(t, seqs, lens)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ((got[1] - got[0]) > 0).any()
    for w, fill in ((4, 1), (32, 0)):
        n0 = wt_window.wt_window_gather.launches
        got = wt_window.wt_window_gather(t, lo, hi, w, lp, fill)
        assert wt_window.wt_window_gather.launches == n0 + 1
        want = wt_window.wt_window_gather_plain(t, lo, hi, w, lp, fill)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    n0 = wt_bucket_counts.wt_bucket_counts.launches
    got = wt_bucket_counts.wt_bucket_counts(t, lo, hi)
    assert wt_bucket_counts.wt_bucket_counts.launches == n0 + 1
    assert torch.equal(got, wt_bucket_counts.wt_bucket_counts_plain(t, lo, hi))
    assert torch.equal(got.sum(-1), (hi - lo).clamp(min=0))
    n0 = wt_bucket_counts.wt_bucket_support.launches
    bits = wt_bucket_counts.wt_bucket_support(t, lo, hi)
    assert wt_bucket_counts.wt_bucket_support.launches == n0 + 1
    assert torch.equal(bits, wt_bucket_counts.wt_bucket_support_plain(t, lo, hi))
    assert torch.equal(bits, bucket_counts.pack_support(got))


def _wt_sequences(host, rng, n, L, vocab, cuda):
    text = host.text[:-1] - 1  # the documents, each reversed
    starts = rng.integers(0, text.size - L, size=n)
    seqs = np.stack([text[s : s + L][::-1] for s in starts]).astype(np.int32)
    seqs[: n // 8] = rng.integers(-2, vocab + 3, size=(n // 8, L))
    lens = rng.integers(0, L + 1, size=n).astype(np.int32)
    return torch.as_tensor(seqs, device=cuda), torch.as_tensor(lens, device=cuda)


@pytest.mark.parametrize("keep_bwt", [False, True])
@pytest.mark.parametrize("name", sorted(WT_CASES))
def test_wt_kernels_match_plain(cuda, name, keep_bwt):
    """Kernels 12-14 (compact and hybrid) at 1 to 5 digits: full,
    empty and end-of-index ranges, out-of-range tokens, every sequence
    length 0..L; exactly equal."""
    host = _wt_host(name)
    vocab = WT_CASES[name][0]
    t = WaveletIndex.from_host(host, vocab=vocab, keep_bwt=keep_bwt, device=cuda)
    rng = np.random.default_rng(len(name))
    lo, hi = _ranges(host, rng)
    toks = torch.as_tensor(rng.integers(-2, vocab + 3, size=(lo.numel(), 9)).astype(np.int32),
                           device=cuda)
    toks[:, -1] = torch.as_tensor((np.resize(host.text, lo.numel()) - 1).astype(np.int32),
                                  device=cuda)  # likely members
    seqs, lens = _wt_sequences(host, rng, 64, 5, vocab, cuda)
    lp = torch.log_softmax(torch.randn(lo.numel(), vocab, device=cuda), -1)
    _check_wt_kernels(t, host, vocab, lo, hi, toks, seqs, lens, lp)


def test_wt_kernels_refuse_digits_past_limit(cuda):
    """The ranking kernels are built for 1 to ``MAX_DIGITS`` digits: an
    index of more (a vocab of 2^20 tokens or more) is refused by every
    wrapper with a ValueError, not launched."""
    host = _wt_host("d2")
    t = WaveletIndex.from_host(host, vocab=1 << 20, keep_bwt=True, device=cuda)
    assert t.digits == wt_search.MAX_DIGITS + 1
    lo, hi = t.full_range((4,))
    tok = torch.full((4,), 5, dtype=torch.int32, device=cuda)
    n0 = wt_search.wt_search.launches
    calls = (lambda: wt_search.wt_search(t, "contains", tok[:, None], lo, hi),
             lambda: wt_search.wt_search(t, "backward_step", tok, lo, hi),
             lambda: wt_search.wt_sequences(t, tok[:, None], torch.ones_like(tok)),
             lambda: wt_search.wt_advance(t, tok[None], torch.zeros_like(tok)[None], lo[None],
                                          hi[None], eos=2, pad=1),
             lambda: wt_search.wt_dense_counts(t, lo, hi))
    for call in calls:
        with pytest.raises(ValueError, match="digits"):
            call()
    assert wt_search.wt_search.launches == n0


@pytest.mark.parametrize("keep_bwt", [False, True])
def test_wt_kernels_match_plain_at_bench_shapes(cuda, keep_bwt):
    """The generation point's shapes on a 240k-token Zipf corpus at BART's
    vocab (4 digits): ranges [32, 15] of one- and two-token prefixes,
    membership [32, 15, 65], windows over lp [480, 50265], 4096 sequences
    of up to 16 tokens."""
    V, B, K = 50265, 32, 15
    rng = np.random.default_rng(9)
    zipf = rng.zipf(1.3, size=2000 * 120)
    docs = (zipf % (V - 10) + 4).reshape(2000, 120)
    host = FMIndex()
    host.initialize([d.tolist() + [2] for d in docs])
    t = WaveletIndex.from_host(host, vocab=V, keep_bwt=keep_bwt, device=cuda)
    assert t.digits == 4
    text = host.text[:-1] - 1
    first = torch.as_tensor(rng.choice(text, size=(2, B, K)).astype(np.int32), device=cuda)
    flo, fhi = t.full_range((B, K))
    lo1, hi1 = wt_search.backward_step_plain(t, first[0], flo, fhi)
    lo2, hi2 = wt_search.backward_step_plain(t, first[1], lo1, hi1)
    even = torch.arange(K, device=cuda) % 2 == 0
    lo, hi = torch.where(even, lo1, lo2), torch.where(even, hi1, hi2)
    lo[0, 0], hi[0, 0] = 0, t.n_rows
    lo[0, 1], hi[0, 1] = t.n_rows, t.n_rows
    toks = torch.randint(0, V, (B, K, 65), device=cuda, dtype=torch.int32)
    toks[..., :32] = first[0, :, :, None]
    toks[..., -1] = 2
    seqs, lens = _wt_sequences(host, rng, 4096, 16, V, cuda)
    lp = torch.log_softmax(torch.randn(B * K, V, device=cuda), -1)
    _check_wt_kernels(t, host, V, lo, hi, toks, seqs, lens, lp)


@pytest.mark.parametrize("layout", ["compact", "hybrid"])
@pytest.mark.parametrize("seed", [0, 1])
def test_wavelet_generate_on_card_matches_cpu(cuda, seed, layout):
    """Compact and hybrid generation through kernels 12-14 gives the CPU
    plain path's hypotheses (token lists equal, scores within 1e-4), and
    the card's Psi-layout run's exactly; kernels 12 and 13 launched."""
    cfg = bart_tiny(vocab_size=96)
    params = bart.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(seed)
    docs = [rng.integers(4, 90, size=rng.integers(5, 30)).tolist() + [2] for _ in range(30)]
    host = FMIndex()
    host.initialize(docs)
    queries = [[0] + rng.integers(4, 90, size=5).tolist() + [2] for _ in range(3)]
    kw = dict(num_beams=4, max_length=6, min_length=1, window=4, exact_chunk=4)
    keep = layout == "hybrid"
    cpu = tg.fm_index_generate(cfg, params, WaveletIndex.from_host(host, vocab=96, keep_bwt=keep,
                                                                   device="cpu"), queries, **kw)
    n12, n13 = wt_search.wt_search.launches, wt_window.wt_window_gather.launches
    gpu_params = _to(params, cuda)
    gpu = tg.fm_index_generate(cfg, gpu_params, WaveletIndex.from_host(
        host, vocab=96, keep_bwt=keep, device=cuda), queries, **kw)
    assert wt_search.wt_search.launches > n12 and wt_window.wt_window_gather.launches > n13
    psi = tg.fm_index_generate(cfg, gpu_params, TorchFMIndex.from_host(host, vocab=96,
                                                                       device=cuda), queries, **kw)
    for a, b, c in zip(cpu, gpu, psi):
        ka, kb = sorted((tuple(t), s) for s, t in a), sorted((tuple(t), s) for s, t in b)
        assert [t for t, _ in ka] == [t for t, _ in kb]
        np.testing.assert_allclose([s for _, s in kb], [s for _, s in ka], atol=1e-4, rtol=0)
        assert kb == sorted((tuple(t), s) for s, t in c)


@pytest.mark.parametrize("layout", ["compact", "hybrid"])
def test_wavelet_searcher_on_card_matches_cpu(cuda, layout):
    """The tiny searcher over a wavelet layout on the card gives its CPU
    path's ranking: the same doc ids in the same order, scores within 1e-4
    relative."""
    cpu = bench_search.tiny_searcher("cpu", layout=layout).batch_search(
        bench_search.TINY_QUERIES, k=5)
    gpu = bench_search.tiny_searcher(cuda, layout=layout).batch_search(
        bench_search.TINY_QUERIES, k=5)
    for a, b in zip(cpu, gpu):
        assert [d.docid for d in b] == [d.docid for d in a]
        np.testing.assert_allclose([d.score for d in b], [d.score for d in a], rtol=1e-4)


# kernel 15 and 16 routes: every non-empty range by rank (kernel 16: by
# the walk), the default threshold, every range by its rows' histogram
ROUTES = {"rank": 0, "default": None, "histogram": 2**31 - 1}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("layout", ["psi", "compact", "hybrid"])
@pytest.mark.parametrize("name", sorted(WT_CASES))
def test_dense_counts_match_plain(cuda, name, layout, route):
    """Kernels 15 (Psi) and 16 (compact, hybrid) at 1 to 5 digits on
    both routes: full, empty and end-of-index ranges; exactly equal to the
    plain sweep, one launch each."""
    host = _wt_host(name)
    vocab = WT_CASES[name][0]
    rng = np.random.default_rng(vocab)
    lo, hi = _ranges(host, rng, n=48 if vocab < 1000 else 12)
    if layout == "psi":
        t = TorchFMIndex.from_host(host, vocab=vocab, device=cuda)
        fn, plain = fm_search.fm_dense_counts, fm_search.dense_counts_plain
    else:
        t = WaveletIndex.from_host(host, vocab=vocab, keep_bwt=layout == "hybrid", device=cuda)
        fn, plain = wt_search.wt_dense_counts, wt_search.dense_counts_plain
    hist_max = ROUTES[route]
    kw = {} if hist_max is None else dict(hist_max=hist_max)
    n0 = fn.launches
    got = fn(t, lo, hi, **kw)
    assert fn.launches == n0 + 1
    want = plain(t, lo, hi, 4096)
    assert torch.equal(got, want)
    assert bool((got.sum(-1) <= (hi - lo).clamp(min=0)).all())


def _graph_call(fn):
    """``fn()``'s result from a replay of a CUDA graph that captured it
    (after an eager warm-up on a side stream)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("graph", [False, True])
@pytest.mark.parametrize("layout", ["compact", "hybrid"])
@pytest.mark.parametrize("name", sorted(WT_CASES))
def test_wt_dense_walk_matches_plain(cuda, name, layout, graph):
    """Kernel 16's walk (every non-empty range walked) and the layout's
    default at 1 to 5 digits, eagerly and replayed from a CUDA graph:
    full, empty, inverted, one-row and end-of-index ranges, the alphabet
    past the vocab (d1); exactly the plain sweep and the walk's numpy
    mirror."""
    host = _wt_host(name)
    vocab = WT_CASES[name][0] if name != "d1" else 12
    rng = np.random.default_rng(vocab + 1)
    lo, hi = _ranges(host, rng, n=24 if vocab < 1000 else 10)
    N = host.size()
    lo[3:6], hi[3:6] = torch.tensor([7, 0, N - 1]), torch.tensor([3, 1, N])  # inverted, one row
    t = WaveletIndex.from_host(host, vocab=vocab, keep_bwt=layout == "hybrid", device=cuda)
    want = wt_search.dense_counts_plain(t, lo, hi, 4096)
    assert torch.equal(wt_search.wt_dense_counts_walk_plain(t, lo.cpu(), hi.cpu()), want.cpu())
    for kw in (dict(hist_max=0), {}):
        call = lambda kw=kw: wt_search.wt_dense_counts(t, lo, hi, **kw)  # noqa: E731
        got = _graph_call(call) if graph else call()
        assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["d4", "d5"])
def test_wt_dense_walk_room_limit(cuda, name):
    """A range whose whole walk fits the frontier's room is walked by one
    block, a wider one a slice of the vocab a block: on a corpus of ~3,000
    rows, ranges on both sides of the room's limit, exactly the plain
    sweep."""
    vocab, hi_sym, _ = WT_CASES[name]
    rng = np.random.default_rng(vocab + 2)
    host = FMIndex()
    host.initialize([rng.integers(0, hi_sym, size=rng.integers(20, 80)).tolist()
                     for _ in range(60)])
    N = host.size()
    t = WaveletIndex.from_host(host, vocab=vocab, device=cuda)
    c_all = min(vocab + 1, t.sigma)
    nodes = lambda rows: wt_search.walk_nodes(t.digits, rows, 1, c_all)  # noqa: E731
    rows = max(r for r in range(1, N + 1) if nodes(r) <= wt_search.WALK_CAP)
    assert rows < N  # the full range walks a slice a block
    lo = torch.tensor([0, 0, 1, N - rows, 3], dtype=torch.int32, device=cuda)
    hi = torch.tensor([N, rows, rows + 2, N, N - 2], dtype=torch.int32, device=cuda)
    want = wt_search.dense_counts_plain(t, lo, hi, 4096)
    assert torch.equal(wt_search.wt_dense_counts(t, lo, hi, hist_max=0), want)
    assert torch.equal(wt_search.wt_dense_counts_walk_plain(t, lo.cpu(), hi.cpu()), want.cpu())


def _mask_fns(layout):
    """A layout's mask mode, its plain version and its counts' plain sweep."""
    if layout == "psi":
        return fm_search.fm_dense_mask, fm_search.dense_mask_plain, fm_search.dense_counts_plain
    return wt_search.wt_dense_mask, wt_search.dense_mask_plain, wt_search.dense_counts_plain


def _index(host, layout, vocab, cuda):
    if layout == "psi":
        return TorchFMIndex.from_host(host, vocab=vocab, device=cuda)
    return WaveletIndex.from_host(host, vocab=vocab, keep_bwt=layout == "hybrid", device=cuda)


@pytest.mark.parametrize("graph", [False, True])
@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("layout", ["psi", "compact", "hybrid"])
@pytest.mark.parametrize("name", sorted(WT_CASES))
def test_dense_mask_match_plain(cuda, name, layout, route, graph):
    """Kernels 15 and 16's mask modes at 1 to 5 digits on every route, eager
    and replayed from a CUDA graph: full, empty and end-of-index ranges;
    exactly the plain version, which is the plain counts > 0 packed (its
    padding bits 0); one launch each, no counts-mode launch."""
    host = _wt_host(name)
    vocab = WT_CASES[name][0]
    lo, hi = _ranges(host, np.random.default_rng(vocab), n=48 if vocab < 1000 else 12)
    t = _index(host, layout, vocab, cuda)
    fn, plain, counts = _mask_fns(layout)
    kw = {} if ROUTES[route] is None else dict(hist_max=ROUTES[route])
    n0, c0 = fn.launches, fm_search.fm_dense_counts.launches + wt_search.wt_dense_counts.launches
    call = lambda: fn(t, lo, hi, **kw)  # noqa: E731
    got = _graph_call(call) if graph else call()
    assert fn.launches == n0 + (2 if graph else 1)
    assert fm_search.fm_dense_counts.launches + wt_search.wt_dense_counts.launches == c0
    want = plain(t, lo, hi, 4096)
    assert got.shape == (lo.numel(), count_mask.words(vocab)) and torch.equal(got, want)
    assert torch.equal(want, count_mask.pack(counts(t, lo, hi, 4096) > 0))


@pytest.mark.parametrize("layout", ["psi", "compact", "hybrid"])
def test_dense_mask_at_hist_max(cuda, layout):
    """The routes' threshold: ranges of exactly ``hist_max`` rows take the
    rows, of ``hist_max`` + 1 the ranks (Psi) or the walk (wavelet), for
    thresholds at three ranges' widths; exactly the plain version."""
    host = _zipf_host()
    t = _index(host, layout, 40, cuda)
    lo, hi = _ranges(host, np.random.default_rng(11))
    fn, plain, _ = _mask_fns(layout)
    want = plain(t, lo, hi, 4096)
    widths = sorted(set((hi - lo).clamp(min=1).tolist()))
    for w in (widths[len(widths) // 4], widths[len(widths) // 2], widths[-2]):
        for h in (w - 1, w, w + 1):
            assert torch.equal(fn(t, lo, hi, hist_max=h), want), (w, h)


def _wide_corpus(S, cuda):
    """A 300,000-token Zipf corpus, monolithic (S = 0) or over S shards,
    with 13 ranges a shard (a group of 8 and one of 5): the full range,
    ranges past ``SPLIT_ROWS`` rows (the cluster's split), n-gram ranges,
    empty, inverted and end-of-index ones."""
    rng = np.random.default_rng(40 + S)
    toks = (rng.zipf(1.2, size=300000) % 36 + 4).astype(np.int64)
    docs = [d.tolist() + [2] for d in np.array_split(toks, 3000)]
    if S == 0:
        host = FMIndex()
        host.initialize(docs)
        hosts, ix = [host], TorchFMIndex.from_host(host, vocab=50265, device=cuda)
    else:
        ix, hosts, _ = sharded_index.ShardedTorchIndex.build(docs, S, 50265, device=cuda)
    los, his = [], []
    for h in hosts:
        n = h.size()
        a, b = h.get_range([int(h.text[7]) - 1]), h.get_range([int(h.text[30]) - 1])
        los.append([0, 0, 17, n // 3, a[0], b[0], 5, 9, n - 2, n, 0, 100, 1])
        his.append([n, 5000, n - 3, n, a[1], b[1], 5, 4, n, n, 1, 4100, n])
    lo = torch.tensor(los, dtype=torch.int32, device=cuda)
    hi = torch.tensor(his, dtype=torch.int32, device=cuda)
    return ix, (lo[0], hi[0]) if S == 0 else (lo, hi)


@pytest.mark.parametrize("graph", [False, True])
@pytest.mark.parametrize("S", [0, 1, 2, 4])
def test_dense_mask_cluster_split(cuda, S, graph):
    """Kernel 15's mask mode where a range is split over its group's
    cluster (rows past ``SPLIT_ROWS``, or ranked past ``hist_max`` a word a
    warp, the words split over the CTAs), on the Psi index (S = 0) and over
    1, 2 and 4 shards (ORed), at BART's vocab; groups of 8 and 5 ranges;
    thresholds at the split's edge, eager and graph-replayed; exactly the
    plain version."""
    ix, (lo, hi) = _wide_corpus(S, cuda)
    if S == 0:
        fn, want = fm_search.fm_dense_mask, fm_search.dense_mask_plain(ix, lo, hi, 8192)
    else:
        fn, want = fm_search.fm_dense_mask_sharded, \
            fm_search.dense_mask_sharded_plain(ix, lo, hi, 8192)
    widths = (hi - lo).reshape(-1, lo.shape[-1])
    assert (widths > fm_search.SPLIT_ROWS).any(-1).all() and lo.shape[-1] % fm_search.CLUSTER != 0
    for h in (fm_search.MASK_HIST_MAX_ROWS, fm_search.HIST_MAX_ROWS, 0, fm_search.SPLIT_ROWS,
              fm_search.SPLIT_ROWS + 1, 4999):
        n0 = fn.launches
        call = lambda h=h: fn(ix, lo, hi, hist_max=h)  # noqa: E731
        got = _graph_call(call) if graph else call()
        assert fn.launches == n0 + (2 if graph else 1)
        assert torch.equal(got, want), h
    assert bool(count_mask.unpack(want, 50265)[0, 4:40].all())  # the full range: every token


@pytest.mark.parametrize("case", ["plain", "branches"])
def test_dense_scores_match_plain(cuda, case):
    """Kernel 17 at the generation point's shape [32, 15, 50265], bit for
    bit, with dead beams, signed zeros and the branch options."""
    g = torch.Generator(device=cuda).manual_seed(17)
    B, K, V = 32, 15, 50265
    lp = _lp(g, B * K, V, cuda)
    mask = count_mask.pack(torch.randint(0, 3, (B, K, V), generator=g, device=cuda) > 0)
    prev_count = torch.randint(0, 6, (B, K), generator=g, device=cuda, dtype=torch.int32)
    finished = torch.rand(B, K, generator=g, device=cuda) < 0.2
    bs = torch.round(torch.randn(B, K, generator=g, device=cuda) * 2) / 2 - 3
    bs[0, 1] = tc.NEG_INF
    kw = dict(eos=2, pad=1, stop_at_count=2 if case == "branches" else 0,
              always_allow_eos=case == "branches")
    n0 = dense_scores.dense_scores.launches
    got = dense_scores.dense_scores(mask, lp, prev_count, finished, bs, **kw)
    assert dense_scores.dense_scores.launches == n0 + 1
    _same((got,), (dense_scores.dense_scores_plain(mask, lp, prev_count, finished, bs, **kw),))


def _dense_inputs(g, B, K, V, cuda, lp=None, allowed=None):
    """A dense step's count mask (``allowed``: the share of tokens with a
    count, default 2/3), log-probs and branch state, with dead beams,
    signed zeros and a query whose beams are all at NEG_INF."""
    lp = _lp(g, B * K, V, cuda) if lp is None else lp
    share = 2 / 3 if allowed is None else allowed
    ok = torch.rand(B, K, V, generator=g, device=cuda) < share
    ok[0, min(2, K - 1)] = False  # a dead interval
    prev_count = torch.randint(0, 6, (B, K), generator=g, device=cuda, dtype=torch.int32)
    finished = torch.rand(B, K, generator=g, device=cuda) < 0.2
    bs = torch.round(torch.randn(B, K, generator=g, device=cuda) * 2) / 2 - 3
    bs[0, min(1, K - 1)] = tc.NEG_INF
    bs[-1] = tc.NEG_INF  # an all-NEG_INF query
    ok[-1] = False
    return count_mask.pack(ok), lp, prev_count, finished, bs


DENSE_BRANCHES = {"plain": dict(stop_at_count=0, always_allow_eos=False),
                  "branches": dict(stop_at_count=2, always_allow_eos=True),
                  "stop": dict(stop_at_count=1, always_allow_eos=False)}


@pytest.mark.parametrize("graph", [False, True])
@pytest.mark.parametrize("case", sorted(DENSE_BRANCHES))
@pytest.mark.parametrize("B,K,V", [(32, 15, 50265), (4, 3, 97), (3, 5, 50264), (2, 32, 50265)])
def test_dense_select_matches_plain(cuda, B, K, V, case, graph):
    """Kernel 17 inside kernel 3's select (the dense step): the top 2K of the
    scores it never writes equal ``row_topk_plain(dense_scores_plain(...))``
    bit for bit, values and int64 indices, at the generation point, at odd
    and even V, at beam 32 (a slice streamed past the shared memory), with
    every branch and an all-NEG_INF query; eager and replayed from a CUDA
    graph; one launch a call."""
    g = torch.Generator(device=cuda).manual_seed(B * K + V)
    args = _dense_inputs(g, B, K, V, cuda)
    kw = dict(eos=2, pad=1, **DENSE_BRANCHES[case])
    n0 = dense_scores.dense_select.launches
    call = lambda: dense_scores.dense_select(*args, 2 * K, **kw)  # noqa: E731
    got = _graph_call(call) if graph else call()
    assert dense_scores.dense_select.launches == n0 + (2 if graph else 1)
    _same(got, dense_scores.dense_select_plain(*args, 2 * K, **kw))


@pytest.mark.parametrize("splits", [1, 2, 4, 8, 16])
def test_dense_select_forced_layouts(cuda, splits):
    """Every split of a [4, 3 * 50265] select, and a route that streams
    each slice's tail (staged cut to 4,000 keys), exactly the plain top-k."""
    g = torch.Generator(device=cuda).manual_seed(splits)
    B, K, V = 4, 3, 50265
    args = _dense_inputs(g, B, K, V, cuda)
    kw = dict(eos=2, pad=1, stop_at_count=2, always_allow_eos=True)
    want = dense_scores.dense_select_plain(*args, 2 * K, **kw)
    for staged in (None, 4000):
        lay = row_topk.plan(B, K * V, 2 * K, splits=splits, staged=staged)
        _same(dense_scores.dense_select(*args, 2 * K, layout=lay, **kw), want)


def test_dense_select_refuses_what_it_does_not_index(cuda):
    """A strided or unaligned ``lp`` is not the select's [B, K * V] rows: the
    wrapper raises (no second route for the select's k); a query's row of
    2^31 scores or more raises with its reason.  (Past the shared sort, k
    takes the streaming pass and kernel 3's global sort:
    ``test_dense_select_past_max_k_matches_plain``.)"""
    g = torch.Generator(device=cuda).manual_seed(3)
    B, K, V = 2, 3, 101
    wide = _lp(g, B * K, V + 7, cuda)
    mask, _, prev_count, finished, bs = _dense_inputs(g, B, K, V, cuda)
    kw = dict(eos=2, pad=1)
    for lp in (wide[:, :V], wide.reshape(-1)[1:1 + B * K * V].reshape(B * K, V)):
        with pytest.raises(ValueError, match="lp"):
            dense_scores.dense_select(mask, lp, prev_count, finished, bs, 2 * K, **kw)
    with pytest.raises(ValueError, match="2\\^31"):
        dense_scores.route(1, 42724, 50265, 30)


@pytest.mark.parametrize("graph", [False, True])
@pytest.mark.parametrize("lp_case", ["flat", "strided", "unaligned"])
@pytest.mark.parametrize("B,K,V", [(32, 15, 50265), (3, 1, 97), (1, 3, 50265), (2, 2, 7)])
def test_dense_scores_stream_matches_plain(cuda, B, K, V, lp_case, graph):
    """Kernel 17's streaming pass bit for bit: at the generation point, at
    odd V with vectors straddling beams and a flat size that is not a
    multiple of 4, with a strided ``lp`` (row stride past V) and an ``lp``
    that is not 16-byte aligned, every branch, eager and graph-replayed."""
    g = torch.Generator(device=cuda).manual_seed(B + K + V)
    if lp_case == "flat":
        lp = _lp(g, B * K, V, cuda)
    elif lp_case == "strided":
        lp = _lp(g, B * K, V + 5, cuda)[:, :V]
    else:
        lp = _lp(g, 1, B * K * V + 1, cuda).reshape(-1)[1:].reshape(B * K, V)
    args = _dense_inputs(g, B, K, V, cuda, lp=lp)
    for case in sorted(DENSE_BRANCHES):
        kw = dict(eos=2, pad=1, **DENSE_BRANCHES[case])
        n0 = dense_scores.dense_scores.launches
        call = lambda: dense_scores.dense_scores(*args, **kw)  # noqa: E731
        got = _graph_call(call) if graph else call()
        assert dense_scores.dense_scores.launches == n0 + (2 if graph else 1)
        _same((got,), (dense_scores.dense_scores_plain(*args, **kw),))


@pytest.mark.parametrize("B,K,n_top,with_buf", [(32, 15, 64, False), (32, 15, 256, True)])
def test_beam_merge_ties_match_plain(cuda, B, K, n_top, with_buf):
    """Kernel 8's ties mode, merge: equal log-probs kept by dedup id."""
    g = torch.Generator(device=cuda).manual_seed(n_top + 1)
    V, n_buf = 3000, 2 * K
    lp = _lp(g, B * K, V, cuda)
    top_lp, top_idx = row_topk.row_topk_plain(lp, n_top)
    top_tok = top_idx.to(torch.int32).reshape(B, K, n_top)
    ok = torch.rand(B, K, n_top, generator=g, device=cuda) < 0.5
    slab_tok = torch.randint(0, 300, (B, K, n_top), generator=g, device=cuda, dtype=torch.int32)
    slab_lp = torch.gather(lp, 1, slab_tok.reshape(B * K, -1).long()).reshape(B, K, n_top)
    slab_ok = torch.rand(B, K, n_top, generator=g, device=cuda) < 0.8
    buf = None
    if with_buf:
        btok = torch.randint(0, 300, (B, K, n_buf), generator=g, device=cuda, dtype=torch.int32)
        buf = (btok, torch.gather(lp, 1, btok.reshape(B * K, -1).long()).reshape(B, K, n_buf),
               torch.rand(B, K, n_buf, generator=g, device=cuda) < 0.7)
    args = (buf, top_tok, top_lp.reshape(B, K, n_top), ok, slab_tok, slab_lp, slab_ok, V, n_buf)
    n0 = beam_select.TIES.launches
    got = beam_select.beam_merge(*args, ties=True)
    assert beam_select.TIES.launches == n0 + 1
    _same(got, beam_select.beam_merge_plain(*args, ties=True))


@pytest.mark.parametrize("B,K,w,case", [(32, 15, 32, "need"), (8, 15, 32, "branches"),
                                         (8, 32, 128, "no_buffer")])
def test_beam_select_ties_match_plain(cuda, B, K, w, case):
    """Kernel 8's ties mode, select: equal scores ordered by (parent beam,
    token); exactly equal to the plain version."""
    g = torch.Generator(device=cuda).manual_seed(B * K + w + 1)
    V, n_buf = 3000, 2 * K
    lp = _lp(g, B * K, V, cuda)

    def take(tok):
        return torch.gather(lp, 1, tok.reshape(B * K, -1).long()).reshape(tok.shape)

    btok = torch.randint(0, 400, (B, K, n_buf), generator=g, device=cuda, dtype=torch.int32)
    buf = None if case == "no_buffer" else (
        btok, take(btok), torch.rand(B, K, n_buf, generator=g, device=cuda) < 0.7)
    win_valid = torch.rand(B, K, w, generator=g, device=cuda) < 0.7
    win_tok = torch.where(win_valid, torch.randint(0, 400, (B, K, w), generator=g, device=cuda,
                                                   dtype=torch.int32), 1)
    eos_ok = torch.rand(B, K, 1, generator=g, device=cuda) < 0.5
    prev_count = torch.randint(0, 6, (B, K), generator=g, device=cuda, dtype=torch.int32)
    finished = torch.rand(B, K, generator=g, device=cuda) < 0.2
    bs = torch.zeros(B, K, device=cuda)  # equal beam scores: ties across beams
    bs[0, 1] = tc.NEG_INF
    need = torch.rand(B, K, generator=g, device=cuda) < 0.5
    th_lp = torch.round(torch.randn(B, K, generator=g, device=cuda)) - 4
    kw = dict(K=K, eos=2, pad=1, stop_at_count=2 if case == "branches" else 0,
              always_allow_eos=case == "branches", ties=True)
    args = (buf, n_buf, win_tok, win_valid, take(win_tok), eos_ok, lp, prev_count, finished, bs,
            need, th_lp)
    n0 = beam_select.TIES.launches
    (got, bad), (want, wbad) = beam_select.beam_select(*args, **kw), \
        beam_select.beam_select_plain(*args, **kw)
    assert beam_select.TIES.launches == n0 + 1
    _same(got + (bad,), want + (wbad,))


@pytest.mark.parametrize("layout", ["psi", "compact", "hybrid"])
def test_dense_and_tie_modes_on_card_match_cpu(cuda, layout):
    """``exact_mask`` and ``exact_ties`` generation on the card: the CPU
    plain path's hypotheses (token lists equal, scores within 1e-4), the
    dense run bit for bit equal to the fast runs; kernels 15 or 16 in
    their mask modes (their counts modes not at all), 17 inside kernel 3's
    select (its streaming pass not at all) and 8's ties mode launched."""
    cfg = bart_tiny(vocab_size=96)
    params = bart.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(3)
    docs = [rng.integers(4, 90, size=rng.integers(5, 30)).tolist() + [2] for _ in range(30)]
    host = FMIndex()
    host.initialize(docs)
    queries = [[0] + rng.integers(4, 90, size=5).tolist() + [2] for _ in range(3)]
    kw = dict(num_beams=4, max_length=6, min_length=1, window=4, exact_chunk=4)

    def index(device):
        if layout == "psi":
            return TorchFMIndex.from_host(host, vocab=96, device=device)
        return WaveletIndex.from_host(host, vocab=96, keep_bwt=layout == "hybrid", device=device)

    gpu_params = _to(params, cuda)
    masks = fm_search.fm_dense_mask if layout == "psi" else wt_search.wt_dense_mask
    counts = fm_search.fm_dense_counts if layout == "psi" else wt_search.wt_dense_counts
    n15, n17, c15 = masks.launches, dense_scores.dense_select.launches, counts.launches
    n17s = dense_scores.dense_scores.launches
    canon = []
    for modes in (dict(exact_mask=True), dict(exact_ties=True), {}):
        cpu = tg.fm_index_generate(cfg, params, index("cpu"), queries, **kw, **modes)
        n8 = beam_select.TIES.launches
        gpu = tg.fm_index_generate(cfg, gpu_params, index(cuda), queries, **kw, **modes)
        assert (beam_select.TIES.launches > n8) == ("exact_ties" in modes)
        for a, b in zip(cpu, gpu):
            ka, kb = sorted((tuple(t), s) for s, t in a), sorted((tuple(t), s) for s, t in b)
            assert [t for t, _ in ka] == [t for t, _ in kb]
            np.testing.assert_allclose([s for _, s in kb], [s for _, s in ka], atol=1e-4, rtol=0)
        canon.append([sorted((tuple(t), s) for s, t in h) for h in gpu])
    assert masks.launches > n15 and dense_scores.dense_select.launches > n17
    assert dense_scores.dense_scores.launches == n17s and counts.launches == c15
    assert canon[0] == canon[1] == canon[2]


# ---- kernels 18-19, kernel 8's free and speculative modes, kernel 4's
# threshold, and the decode modes on the card


@pytest.mark.parametrize("n_beg", [None, 1, 33, 100000])
def test_locate_matches_plain(cuda, n_beg):
    """Kernel 18 in both modes: rows in and out of range, positions at every
    document's start and end and past the corpus; exactly equal.  Besides
    the index's beginnings, 1, 33 and 100,000 (a sample stride of 32 that
    does not divide them, and a wider one) with positions at, before and
    after each beginning."""
    host = _zipf_host()
    t = TorchFMIndex.from_host(host, vocab=40, device=cuda, keep_sa=True)
    rng = np.random.default_rng(8)
    N = host.size()
    rows = np.concatenate([rng.integers(-3, N + 3, size=5000), [-(2**31), 2**31 - 1]])
    rows = torch.as_tensor(rows.astype(np.int32)).cuda()
    n0 = (locate.locate_rows.launches, locate.doc_index_of.launches)
    got = locate.locate_rows(t.sa, rows)
    assert torch.equal(got, locate.locate_rows_plain(t.sa, rows))
    if n_beg is None:
        begin = np.asarray(host.beginnings, np.int64)
        end = len(host)
    else:
        begin = np.cumsum(rng.integers(0, 40, size=n_beg)) + 5  # empty documents too
        end = int(begin[-1]) + 30
    pos = np.concatenate([rng.integers(-2, end + 2, size=5000), begin, begin - 1, begin + 1,
                          [-(2**31), 2**31 - 1, 0]])
    pos = torch.as_tensor(pos.astype(np.int32)).cuda()
    beg = torch.as_tensor(begin.astype(np.int32)).cuda()
    got = locate.doc_index_of(beg, pos)
    assert torch.equal(got, locate.doc_index_of_plain(beg, pos))
    assert (locate.locate_rows.launches, locate.doc_index_of.launches) == (n0[0] + 1, n0[1] + 1)


def _select_rows(rng, rows, n):
    x = np.round(rng.normal(-4, 2, size=(rows, n)), 1).astype(np.float32)  # ties
    x[0, ::3] = 0.0
    x[0, 1::3] = -0.0  # +0.0 ranks above -0.0
    x[1] = -np.inf
    x[1, 7:2000] = -1.5  # a plateau wider than k
    x[2, : n // 3] = 7.5
    x[3, n - 5:] = 50.0
    x[4] = np.float32(tc.NEG_INF)
    x[4, ::13] = -1.0
    x[5, : n // 2] = -np.inf
    return x


@pytest.mark.parametrize("n", [50265, 70000])
@pytest.mark.parametrize("k", [1, 64, 256, 1024])
def test_row_select_matches_plain(cuda, n, k):
    """Kernel 19's k-th value at vocab width and past the staged part of a
    row (the tail re-read from device memory), bit for bit; the decode
    modes' top-``top_m`` it no longer serves is kernel 3's, equal too."""
    x = torch.as_tensor(_select_rows(np.random.default_rng(k), 8, n)).cuda()
    n0 = row_select.row_kth.launches
    kth = row_select.row_kth(x, k)
    assert torch.equal(kth.view(torch.int32), row_select.row_kth_plain(x, k).view(torch.int32))
    assert row_select.row_kth.launches == n0 + 1
    gv, gi = row_topk.row_topk(x, k)
    wv, wi = row_topk.row_topk_plain(x, k)
    assert torch.equal(gi, wi) and torch.equal(gv.view(torch.int32), wv.view(torch.int32))


def test_row_select_at_the_decode_shapes(cuda):
    """[480, 50265] log-prob rows (the speculative and free steps' top-256,
    now kernel 3's; the warper's 50th value, kernel 19's) and [32, 50265]
    (step 0)."""
    g = torch.Generator(device=cuda).manual_seed(19)
    lp = _lp(g, 480, 50265, cuda)
    for x, k in ((lp, 256), (lp[:32], 256), (lp, 50)):
        gv, gi = row_topk.row_topk(x, k)
        wv, wi = row_topk.row_topk_plain(x, k)
        assert torch.equal(gi, wi) and torch.equal(gv.view(torch.int32), wv.view(torch.int32))
        assert torch.equal(row_select.row_kth(x, k).view(torch.int32),
                           wv[:, -1].view(torch.int32))


@pytest.mark.parametrize("graph", [False, True])
def test_row_kth_at_the_warper_shape(cuda, graph):
    """Kernel 19 at the ``topk`` warper's [480, 50265], k = 50 (and the
    batch-8 [120, 50265]), eager and replayed from a CUDA graph: bit for
    bit the plain version, one launch a call."""
    g = torch.Generator(device=cuda).manual_seed(50)
    lp = _lp(g, 480, 50265, cuda)
    for x in (lp, lp[:120]):
        n0 = row_select.row_kth.launches
        call = lambda x=x: row_select.row_kth(x, 50)  # noqa: E731
        got = _graph_call(call) if graph else call()
        assert row_select.row_kth.launches == n0 + (2 if graph else 1)
        assert torch.equal(got.view(torch.int32), row_select.row_kth_plain(x, 50).view(torch.int32))


@pytest.mark.parametrize("splits", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("k", [1, 50, 2000, 50265])
def test_row_kth_forced_layouts(cuda, k, splits):
    """Kernel 19 at every split of a vocab-wide row and on the route that
    streams a slice's tail, on rows with ties at the k-th place, signed
    zeros, -inf and NEG_INF plateaus, k = 1 and k = n: bit for bit."""
    x = torch.as_tensor(_select_rows(np.random.default_rng(k + splits), 8, 50265)).cuda()
    want = row_select.row_kth_plain(x, k).view(torch.int32)
    p = row_select.plan(8, 50265, k, splits=splits)
    assert torch.equal(row_select.row_kth(x, k, layout=p).view(torch.int32), want)
    streamed = row_topk.plan(8, 50265, k, splits=splits, staged=p.slice // 3, kth=True)
    assert streamed.route == "streamed"
    assert torch.equal(row_select.row_kth(x, k, layout=streamed).view(torch.int32), want)
    with pytest.raises(ValueError, match="k-th-value plan"):
        row_select.row_kth(x, k, layout=row_topk.plan(8, 50265, k))


def test_log_softmax_threshold_matches_plain(cuda):
    """The warper's threshold (kernel 19's k-th value) then kernel 4's plain
    masked log-softmax, against the one launch that replaced kernel 4's
    threshold mode (``topk_log_softmax``): the masked set exact, the rest
    within 1e-4, ban off and on."""
    logits = torch.randn(40, 50265, device=cuda) * 3
    logits[:, 1] = float("-inf")
    kth = row_select.row_kth(logits, 50)
    n0 = row_select.topk_log_softmax.launches
    for ban in (-1, 2):
        got = row_select.topk_log_softmax(logits, 50, ban, tc.NEG_INF)
        want = triton_logsoftmax.log_softmax_ban_plain(logits, ban, tc.NEG_INF, kth)
        _close_masked(got, want)
    assert row_select.topk_log_softmax.launches == n0 + 2


def _close_masked(got, want, atol=1e-4):
    """The warper's output against its plain version: the masked set
    (values at or below NEG_INF / 2) exact, the other values within
    ``atol``."""
    masked = want <= tc.NEG_INF / 2
    assert torch.equal(got <= tc.NEG_INF / 2, masked)
    torch.testing.assert_close(got[~masked], want[~masked], atol=atol, rtol=0)


@pytest.mark.parametrize("graph", [False, True])
@pytest.mark.parametrize("rows,n,k", [(480, 50265, 50), (120, 50265, 50), (8, 250000, 50),
                                      (8, 50265, 1), (8, 50265, 2000), (8, 50265, 50265),
                                      (8, 97, 7)])
def test_topk_log_softmax_matches_plain(cuda, rows, n, k, graph):
    """The top-k warper's masked log-softmax in one launch of kernel 3's
    select (its warper mode) against ``topk_log_softmax_plain``: at the
    ``topk`` step's [480, 50265] and [120, 50265], k = 50; at a width split
    over a cluster (250,000 columns: 8 CTAs a row); at k = 1, k = 2000
    and k = n; on rows with ties at the k-th place, signed zeros, -inf and
    NEG_INF plateaus; ban off and on; eager and replayed from a CUDA graph.
    The masked set exact, the rest within 1e-4; one launch a call."""
    rng = np.random.default_rng(rows + n + k)
    x = torch.as_tensor(_select_rows(rng, rows, n)).cuda() if rows <= 8 else (
        torch.as_tensor(rng.normal(0, 3, size=(rows, n)).astype(np.float32)).cuda())
    x[:, 1] = float("-inf")  # a SEAL-bias column
    for ban in (-1, 2):
        n0 = row_select.topk_log_softmax.launches
        call = lambda: row_select.topk_log_softmax(x, k, ban, tc.NEG_INF)  # noqa: E731
        got = _graph_call(call) if graph else call()
        assert row_select.topk_log_softmax.launches == n0 + (2 if graph else 1)
        want = row_select.topk_log_softmax_plain(x, k, ban, tc.NEG_INF)
        _close_masked(got, want)
        if ban >= 0:
            assert (got[:, ban] == tc.NEG_INF).all()


@pytest.mark.parametrize("splits", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("k", [1, 50, 50265])
def test_topk_log_softmax_forced_layouts(cuda, k, splits):
    """The warper mode at every split of a vocab-wide row and on the route
    that streams a slice's tail (read again for the output): the masked set
    exact, the rest within 1e-4; a plan of another mode raises."""
    x = torch.as_tensor(_select_rows(np.random.default_rng(k + splits), 8, 50265)).cuda()
    want = row_select.topk_log_softmax_plain(x, k, 2, tc.NEG_INF)
    p = row_select.plan(8, 50265, k, splits=splits)
    _close_masked(row_select.topk_log_softmax(x, k, 2, tc.NEG_INF, layout=p), want)
    streamed = row_topk.plan(8, 50265, k, splits=splits, staged=p.slice // 3, kth=True)
    assert streamed.route == "streamed"
    _close_masked(row_select.topk_log_softmax(x, k, 2, tc.NEG_INF, layout=streamed), want)
    with pytest.raises(ValueError, match="k-th-value plan"):
        row_select.topk_log_softmax(x, k, 2, tc.NEG_INF, layout=row_topk.plan(8, 50265, k))


@pytest.mark.parametrize("ties", [False, True])
def test_beam_select_keep_invalid_matches_plain(cuda, ties):
    """Kernel 8's speculative mode at the generation point: a 256-slot
    proposal buffer, 128-row window, beam 15 (5,790 candidates a query)."""
    g = torch.Generator(device=cuda).manual_seed(256 + ties)
    B, K, V, m, w = 32, 15, 3000, 256, 128
    lp = _lp(g, B * K, V, cuda)
    top_lp, top_idx = row_topk.row_topk_plain(lp, m)
    buf = (top_idx.to(torch.int32).reshape(B, K, m), top_lp.reshape(B, K, m),
           torch.rand(B, K, m, generator=g, device=cuda) < 0.4)
    win_valid = torch.rand(B, K, w, generator=g, device=cuda) < 0.7
    win_tok = torch.where(win_valid, torch.randint(0, 400, (B, K, w), generator=g, device=cuda,
                                                   dtype=torch.int32), 1)
    win_lp = torch.gather(lp, 1, win_tok.reshape(B * K, -1).long()).reshape(B, K, w)
    eos_ok = (torch.rand(B, K, m + 1, generator=g, device=cuda) < 0.5)[..., m:]
    prev_count = torch.randint(0, 6, (B, K), generator=g, device=cuda, dtype=torch.int32)
    finished = torch.rand(B, K, generator=g, device=cuda) < 0.2
    bs = torch.round(torch.randn(B, K, generator=g, device=cuda) * 2) / 2 - 3
    kw = dict(K=K, eos=2, pad=1, stop_at_count=1, always_allow_eos=False, ties=ties,
              keep_invalid=True)
    args = (buf, m, win_tok, win_valid, win_lp, eos_ok, lp, prev_count, finished, bs)
    n0 = beam_select.SPEC.launches
    (got, _), (want, _) = beam_select.beam_select(*args, **kw), \
        beam_select.beam_select_plain(*args, None, None, **kw)
    _same(got, want)
    assert beam_select.SPEC.launches == n0 + 1


@pytest.mark.parametrize("B,K,m", [(32, 15, 256), (32, 15, 30), (4, 4, 7)])
def test_beam_select_top_token_table_matches_plain(cuda, B, K, m):
    """Kernel 8's free-generation epilogue: kernel 3's top-2K of [B, K*m]
    scores through a token table (kernel 3's top-m)."""
    g = torch.Generator(device=cuda).manual_seed(m)
    lp = _lp(g, B * K, 50265 if m == 256 else 1000, cuda)
    top_lp, tok = row_topk.row_topk(lp, m)
    bs = torch.round(torch.randn(B, K, generator=g, device=cuda) * 2) / 2 - 3
    bs[0, 1] = tc.NEG_INF
    top_cons, top_idx = row_topk.row_topk((top_lp.reshape(B, K, m) + bs[..., None]).reshape(B, -1),
                                          2 * K)
    args = (top_cons, top_idx, lp, bs, K, K, 2)
    n0 = beam_select.FREE.launches
    got = beam_select.beam_select_top(*args, tokens=tok.to(torch.int32))
    _same(got, beam_select.beam_select_top_plain(*args, tokens=tok.to(torch.int32)))
    assert beam_select.FREE.launches == n0 + 1


def _ban_even(logits, cur_len):
    v = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where((v % 2 == 0) & (v >= 4) & (cur_len > 1), float("-inf"), logits)


MODES = {
    "free": dict(disable_fm_index=True),
    "free_topk": dict(disable_fm_index=True, topk=3),
    "speculative": dict(speculative=True, top_m=8),
    "speculative_ties": dict(speculative=True, top_m=8, exact_ties=True),
    "forced_bos": dict(forced_bos_token_id=0),
    "topk": dict(topk=5),
    "hook": dict(adjust_logits_fn=_ban_even),
}


@pytest.mark.parametrize("layout", ["psi", "compact", "hybrid"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_decode_modes_on_card_match_cpu(cuda, mode, layout):
    """Free generation, speculative, forced BOS, the top-k warper and a
    ban-even-tokens hook: the card's hypotheses equal the CPU plain path's
    (token lists equal, scores within 1e-4), on every layout."""
    _modes_on_card(cuda, MODES[mode], layout)


def _modes_on_card(cuda, mode_kw, layout):
    cfg = bart_tiny(vocab_size=96)
    params = bart.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(3)
    docs = [rng.integers(4, 90, size=rng.integers(5, 30)).tolist() + [2] for _ in range(30)]
    host = FMIndex()
    host.initialize(docs)
    queries = [[0] + rng.integers(4, 90, size=5).tolist() + [2] for _ in range(3)]
    kw = dict(num_beams=4, max_length=6, min_length=2, window=4, **mode_kw)

    def index(dev):
        if layout == "psi":
            return TorchFMIndex.from_host(host, vocab=96, device=dev)
        return WaveletIndex.from_host(host, vocab=96, keep_bwt=layout == "hybrid", device=dev)

    cpu = tg.fm_index_generate(cfg, params, index("cpu"), queries, **kw)
    gpu = tg.fm_index_generate(cfg, _to(params, cuda), index(cuda), queries, **kw)
    assert sum(map(len, gpu)) > 0
    for a, b in zip(cpu, gpu):
        ka, kb = sorted((tuple(t), s) for s, t in a), sorted((tuple(t), s) for s, t in b)
        assert [t for t, _ in ka] == [t for t, _ in kb]
        np.testing.assert_allclose([s for _, s in kb], [s for _, s in ka], atol=1e-4, rtol=0)


def test_free_generation_searcher_on_card_matches_cpu(cuda):
    def run(dev):
        s = bench_search.tiny_searcher(dev)
        s.free_generation = True
        return s.batch_search(bench_search.TINY_QUERIES, k=5)

    cpu, gpu = run("cpu"), run(cuda)
    assert any(gpu)
    for a, b in zip(cpu, gpu):
        assert [d.docid for d in b] == [d.docid for d in a]
        np.testing.assert_allclose([d.score for d in b], [d.score for d in a], rtol=1e-4)


# ------------------------------------------- sampling and diverse groups


def test_philox_noise_matches_plain(cuda):
    """Kernel 20's Philox words equal the plain version's exactly (counter
    (0, 0) under key (0, 0) is Random123's first known answer), and its
    Gumbel values (logf) torch's log within 8 f32 ulps of max(|g|, 1)."""
    words, g = sample_select.noise_on_card(0, 0, 480, 50265, cuda)
    want = sample_select.philox_words(0, 0, 480, 50265, cuda)
    assert torch.equal(words, want)
    assert [int(w) for w in words[0, :4]] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    g_plain = sample_select.gumbel_of_words(want)
    assert float(((g - g_plain).abs() / (g_plain.abs().clamp(min=1.0) * 2.0**-23)).max()) <= 8
    w2, _ = sample_select.noise_on_card(-7, 9, 3, 10, cuda)
    assert torch.equal(w2, sample_select.philox_words(-7, 9, 3, 10, cuda))


def _sample_inputs(g, case, cuda):
    """Step 0's V-wide rows under a corpus mask, or 8c-shaped candidate
    lists at the sampling proposal route's width (256 + 32 + 2)."""
    B, K = 32, 15
    if case == "step0":
        lp = _lp(g, B * K, 50265, cuda)
        mask = torch.rand(50265, generator=g, device=cuda) < 0.8
        return lp, lp, None, torch.zeros(B, K, device=cuda), mask
    N = 290
    lp = _lp(g, B * K, N, cuda).reshape(B, K, N)
    cons = torch.where(torch.rand(B, K, N, generator=g, device=cuda) < 0.6, lp, tc.NEG_INF)
    cons[0, 3] = tc.NEG_INF  # an all-dead chain
    tokens = torch.randint(3, 5000, (B, K, N), generator=g, device=cuda, dtype=torch.int32)
    tokens[:, :, N - 2] = 2
    bs = torch.randn(B, K, generator=g, device=cuda) - 3
    return cons, lp, tokens, bs, None


def _drawn_margin(cons, noise, mask):
    """Each chain's gap between its best two perturbed finite scores."""
    if mask is not None:
        cons = torch.where(mask, cons, tc.NEG_INF)
    scored = torch.where(cons > tc.NEG_INF / 4, cons + noise, tc.NEG_INF)
    top2 = scored.topk(2, -1).values
    dead = top2[..., 0] <= tc.NEG_INF / 2  # takes EOS whatever the noise
    return torch.where(dead, float("inf"), top2[..., 0] - top2[..., 1]).reshape(-1)


@pytest.mark.parametrize("case", ["step0", "candidates"])
def test_sample_select_matches_plain(cuda, case):
    """Kernel 20 against its plain version: every output equal on every
    chain whose best two perturbed scores differ by more than 4e-5 (logf
    and torch's log may round a Gumbel value an ulp apart)."""
    g = torch.Generator(device=cuda).manual_seed(20)
    cons, lp, tokens, bs, mask = _sample_inputs(g, case, cuda)
    B, K = bs.shape
    n0 = sample_select.sample_select.launches
    got = sample_select.sample_select(cons, lp, tokens, bs, 3, 4, eos=2, pad=1, mask=mask)
    want = sample_select.sample_select_plain(cons, lp, tokens, bs, 3, 4, eos=2, pad=1, mask=mask)
    assert sample_select.sample_select.launches == n0 + 1
    noise = sample_select.gumbel_noise(3, 4, B * K, cons.shape[-1], cuda)
    clear = (_drawn_margin(cons.reshape(B, K, -1), noise.reshape(B, K, -1), mask) > 4e-5)
    assert float(clear.float().mean()) > 0.99
    for a, b in zip(got[4:], want[4:]):
        _same([a.reshape(-1)[clear]], [b.reshape(-1)[clear]])
    hist = clear.reshape(B, K).repeat(1, 2).reshape(-1)
    for a, b in zip(got[:4], want[:4]):
        _same([a.reshape(-1)[hist]], [b.reshape(-1)[hist]])


SAMPLE_ROUTES = {
    # step 0's V-wide rows under the corpus mask: a CTA a row
    "wide": (480, 50265, False, "block"),
    # batch 8's: a cluster of 4 CTAs a row
    "wide_cluster": (120, 50265, False, "block"),
    # candidate lists (n_buf + w + 2 slots): a 2K buffer's a warp a row,
    # the sampling buffer's (top_m 256) a CTA a row
    "list": (480, 64, True, "warp"),
    "list_290": (480, 290, True, "block"),
    # a list past the warp route (sampling at top_m 10,000): a CTA a row
    "list_block": (480, 10034, True, "block"),
    # V-wide rows too narrow for a CTA: a warp a row
    "narrow": (64, 97, False, "warp"),
}


def _draw_inputs(g, rows, n, listed, cuda):
    """A draw's inputs: V-wide rows under a corpus mask, or candidate lists
    with a token table (EOS twice in some rows, in none of others, an
    all-dead chain), at chain scores with NEG_INF beams."""
    K = 15 if rows % 15 == 0 else 4
    B = rows // K
    lp = _lp(g, rows, n, cuda)
    bs = torch.round(torch.randn(B, K, generator=g, device=cuda) * 2) / 2 - 3
    if not listed:
        mask = torch.rand(n, generator=g, device=cuda) < 0.8
        mask[7:11] = False  # a masked quad
        return lp.reshape(B, K, n), lp.reshape(B, K, n), None, bs, mask
    cons = torch.where(torch.rand(rows, n, generator=g, device=cuda) < 0.6, lp, tc.NEG_INF)
    cons[3] = tc.NEG_INF  # an all-dead chain
    tokens = torch.randint(3, 5000, (rows, n), generator=g, device=cuda, dtype=torch.int32)
    tokens[::2, n - 2] = 2
    tokens[::4, n // 3] = 2
    return (cons.reshape(B, K, n), lp.reshape(B, K, n), tokens.reshape(B, K, n), bs, None)


def _same_clear(got, want, cons, noise, mask, min_clear=0.99):
    """Kernel 20's outputs against the plain version's on every chain whose
    best two perturbed scores differ by more than 4e-5 (logf and torch's log
    may round a Gumbel value an ulp apart)."""
    B, K = got[4].shape
    clear = _drawn_margin(cons.reshape(B, K, -1), noise.reshape(B, K, -1), mask) > 4e-5
    assert float(clear.float().mean()) >= min_clear
    for a, b in zip(got[4:], want[4:]):
        _same([a.reshape(-1)[clear]], [b.reshape(-1)[clear]])
    hist = clear.reshape(B, K).repeat(1, 2).reshape(-1)
    for a, b in zip(got[:4], want[:4]):
        _same([a.reshape(-1)[hist]], [b.reshape(-1)[hist]])


@pytest.mark.parametrize("graph", [False, True])
@pytest.mark.parametrize("case", sorted(SAMPLE_ROUTES))
def test_sample_select_routes_match_plain(cuda, case, graph):
    """Kernel 20's routes against its plain version, eager and replayed from
    a CUDA graph: V-wide rows a CTA or a cluster a row, candidate lists a
    warp or a CTA a row, narrow V-wide rows a warp a row; the route's
    counter (and the list counter on lists) moves once a call."""
    rows, n, listed, route = SAMPLE_ROUTES[case]
    assert sample_select.plan(rows, n).route == route
    g = torch.Generator(device=cuda).manual_seed(rows + n)
    cons, lp, tokens, bs, mask = _draw_inputs(g, rows, n, listed, cuda)
    r0, l0 = sample_select.ROUTES[route].launches, sample_select.LIST.launches
    call = lambda: sample_select.sample_select(cons, lp, tokens, bs, 3, 4, eos=2, pad=1,  # noqa: E731
                                               mask=mask)
    got = _graph_call(call) if graph else call()
    assert sample_select.ROUTES[route].launches == r0 + (2 if graph else 1)
    assert sample_select.LIST.launches == l0 + (2 if graph else 1) * listed
    want = sample_select.sample_select_plain(cons, lp, tokens, bs, 3, 4, eos=2, pad=1, mask=mask)
    noise = sample_select.gumbel_noise(3, 4, rows, n, cuda)
    _same_clear(got, want, cons, noise, mask)


@pytest.mark.parametrize("graph", [False, True])
@pytest.mark.parametrize("case", sorted(DENSE_BRANCHES))
@pytest.mark.parametrize("B,K,V,lp_case", [(32, 15, 50265, "flat"), (8, 15, 50265, "strided"),
                                           (4, 3, 97, "flat"), (2, 2, 7, "strided")])
def test_sample_select_counts_matches_plain(cuda, B, K, V, lp_case, case, graph):
    """Kernel 20's count-reading mode (the sampled ``exact_mask`` step)
    against ``sample_select_counts_plain``: at the generation point and at
    batch 8 (a cluster a row), on narrow rows (a warp a row), with a strided
    ``lp``, every branch, dead beams and an all-NEG_INF query, eager and
    replayed from a CUDA graph; no streaming pass is launched."""
    g = torch.Generator(device=cuda).manual_seed(B * K + V)
    lp = _lp(g, B * K, V + (5 if lp_case == "strided" else 0), cuda)[:, :V]
    mask, lp, prev_count, finished, bs = _dense_inputs(g, B, K, V, cuda, lp=lp, allowed=0.067)
    kw = dict(eos=2, pad=1, **DENSE_BRANCHES[case])
    args = (mask, lp, prev_count, finished, bs, 7, 2)
    n0, d0 = sample_select.sample_select_counts.launches, dense_scores.dense_scores.launches
    call = lambda: sample_select.sample_select_counts(*args, **kw)  # noqa: E731
    got = _graph_call(call) if graph else call()
    assert sample_select.sample_select_counts.launches == n0 + (2 if graph else 1)
    assert dense_scores.dense_scores.launches == d0
    want = sample_select.sample_select_counts_plain(*args, **kw)
    zero = torch.zeros_like(bs)
    cons = dense_scores.dense_scores_plain(mask, lp, prev_count, finished, zero, **kw)
    _same_clear(got, want, cons, sample_select.gumbel_noise(7, 2, B * K, V, cuda), None)


@pytest.mark.parametrize("case", sorted(SAMPLE_ROUTES) + ["counts", "counts_cluster"])
def test_sample_select_row_offset(cuda, case):
    """Kernel 20 with ``row_offset`` (a data-parallel rank's rows): a call on
    the second half of a batch's queries with the offset of its first chain
    equals the whole batch's call on those chains bit for bit, on each route
    (warp, block, cluster, count-reading); the offset noise's words equal
    the plain version's exactly, and the draws equal the plain version's
    with that offset on the chains clear of near-ties."""
    w0, _ = sample_select.noise_on_card(3, 4, 6, 37, cuda, row_offset=2**32 - 2)
    assert torch.equal(w0, sample_select.philox_words(3, 4, 6, 37, cuda, row_offset=2**32 - 2))
    if case.startswith("counts"):
        B, K, V = (32, 15, 50265) if case == "counts" else (8, 15, 50265)
        g = torch.Generator(device=cuda).manual_seed(B * K + 1)
        mask, lp, prev, fin, bs = _dense_inputs(g, B, K, V, cuda, lp=_lp(g, B * K, V, cuda),
                                                allowed=0.067)
        h, o = B // 2, B // 2 * K
        kw = dict(eos=2, pad=1, stop_at_count=2, always_allow_eos=True)
        whole = sample_select.sample_select_counts(mask, lp, prev, fin, bs, 7, 2, **kw)
        part = sample_select.sample_select_counts(mask[h:], lp[o:], prev[h:], fin[h:], bs[h:], 7,
                                                  2, row_offset=o, **kw)
        want = sample_select.sample_select_counts_plain(mask[h:], lp[o:], prev[h:], fin[h:],
                                                        bs[h:], 7, 2, row_offset=o, **kw)
        zero = torch.zeros_like(bs[h:])
        cons = dense_scores.dense_scores_plain(mask[h:], lp[o:], prev[h:], fin[h:], zero, **kw)
        noise = sample_select.gumbel_noise(7, 2, (B - h) * K, V, cuda, row_offset=o)
        mask_n = None
    else:
        rows, n, listed, route = SAMPLE_ROUTES[case]
        g = torch.Generator(device=cuda).manual_seed(rows + n + 1)
        cons, lp, tokens, bs, mask_n = _draw_inputs(g, rows, n, listed, cuda)
        B, K = bs.shape
        h, o = B // 2, B // 2 * K
        assert sample_select.plan((B - h) * K, n).route == route
        cut = lambda t: t[h:] if t is not None else None  # noqa: E731
        whole = sample_select.sample_select(cons, lp, tokens, bs, 3, 4, eos=2, pad=1,
                                            mask=mask_n)
        part = sample_select.sample_select(cut(cons), cut(lp), cut(tokens), bs[h:], 3, 4, eos=2,
                                           pad=1, mask=mask_n, row_offset=o)
        want = sample_select.sample_select_plain(cut(cons), cut(lp), cut(tokens), bs[h:], 3, 4,
                                                 eos=2, pad=1, mask=mask_n, row_offset=o)
        cons = cons[h:]
        noise = sample_select.gumbel_noise(3, 4, (B - h) * K, n, cuda, row_offset=o)
    _same(part, [x[h:] for x in whole])
    _same_clear(part, want, cons, noise, mask_n)


def _past_2_31(cuda):
    """F3's second size: B * K * V just past 2^31 elements (32 x 1,336 x
    50,265: a 51 MB count mask, where the counts took 8.6 GB).  Only tokens
    5 and 100 of beam K - 6 are allowed in every query; in query 31 their
    flat index is past 2^31, so a 32-bit index would read another
    element."""
    B, K, V = 32, 1336, 50265
    assert B * K * V > 2**31 and 31 * K * V + (K - 6) * V > 2**31
    mask = torch.zeros((B, K, count_mask.words(V)), dtype=torch.int32, device=cuda)
    mask[:, K - 6, 0] = 1 << 5  # token 5
    mask[:, K - 6, 3] = 1 << 4  # token 100 = 32 * 3 + 4
    lp = torch.full((B * K, V), -7.0, device=cuda)
    lp.view(B, K, V)[:, K - 6, 5] = -0.5
    lp.view(B, K, V)[:, K - 6, 100] = -0.25
    prev_count = torch.full((B, K), 9, dtype=torch.int32, device=cuda)
    finished = torch.zeros((B, K), dtype=torch.bool, device=cuda)
    bs = torch.zeros((B, K), device=cuda)
    return (mask, lp, prev_count, finished, bs), (B, K, V)


def test_dense_select_past_2_31_elements(cuda):
    """The dense step at B * K * V past 2^31: each query's top 2K is its two
    allowed candidates, then NEG_INF ties in index order, exactly."""
    args, (B, K, V) = _past_2_31(cuda)
    assert dense_scores.route(B, K, V, 2 * K) == "select"
    vals, idx = dense_scores.dense_select(*args, 2 * K, eos=2, pad=1)
    del args
    head = [(K - 6) * V + 100, (K - 6) * V + 5]
    want_idx = torch.tensor(head + list(range(2 * K - 2)), device=cuda).expand(B, -1)
    want_val = torch.full((B, 2 * K), tc.NEG_INF, device=cuda)
    want_val[:, 0], want_val[:, 1] = -0.25, -0.5
    assert torch.equal(idx, want_idx)
    assert torch.equal(vals.view(torch.int32), want_val.view(torch.int32))


def test_dense_scores_past_2_31_elements(cuda):
    """Kernel 17's streaming pass at B * K * V past 2^31: the two allowed
    scores of every query where they belong, NEG_INF everywhere else
    (around flat index 2^31 too)."""
    args, (B, K, V) = _past_2_31(cuda)
    out = dense_scores.dense_scores(*args, eos=2, pad=1)
    del args
    col = (K - 6) * V
    assert (out[:, col + 5] == -0.5).all() and (out[:, col + 100] == -0.25).all()
    assert int((out > tc.NEG_INF / 2).sum()) == 2 * B
    flat = out.view(-1)
    assert (flat[2**31 - 8: 2**31 + 8] == tc.NEG_INF).all()


def test_sample_select_counts_past_2_31_elements(cuda):
    """Kernel 20's count-reading mode at B * K * V past 2^31: chain K - 6 of
    every query draws token 5 or 100, the one that the plain generator's
    Gumbel noise puts first; every other chain has no allowed token and
    takes EOS at its log-prob."""
    args, (B, K, V) = _past_2_31(cuda)
    out = sample_select.sample_select_counts(*args, 11, 3, eos=2, pad=1)
    del args
    sel_tok, sel_sco = out[4], out[6]
    rows = torch.arange(B, dtype=torch.int64) * K + (K - 6)
    cols = torch.tensor([5, 100], dtype=torch.int64)
    words = sample_select.philox4x32(
        (cols // 4).expand(B, 2), rows[:, None].expand(B, 2), torch.zeros(B, 2, dtype=torch.int64),
        torch.zeros(B, 2, dtype=torch.int64), 11, 3)
    w = torch.stack(words, -1)  # [B, 2, 4]: word column % 4 of each
    g = sample_select.gumbel_of_words(torch.stack([w[:, 0, 1], w[:, 1, 0]], -1))
    v = torch.tensor([-0.5, -0.25]) + g
    clear = (v[:, 0] - v[:, 1]).abs() > 4e-5
    assert int(clear.sum()) >= B - 1
    want = torch.where(v[:, 1] > v[:, 0], 100, 5).to(torch.int32)
    got = sel_tok[:, K - 6].cpu()
    assert torch.equal(got[clear], want[clear])
    assert ((got == 5) | (got == 100)).all()
    others = torch.ones(K, dtype=torch.bool)
    others[K - 6] = False
    assert (sel_tok[:, others] == 2).all() and (sel_sco[:, others] == -7.0).all()


def test_exact_mask_past_max_k_generates_on_card_matches_cpu(cuda):
    """F3's first size: ``exact_mask`` at ``num_beams`` 8,193, whose dense
    step asks for k = 2K past kernel 3's shared sort, on a 64-token
    vocabulary: the card's hypotheses equal the CPU plain path's (token
    lists, scores within 1e-4); the dense step takes the streaming pass and
    kernel 3's global sort (``dense_scores.STREAM_SORT``), never
    ``dense_select``'s one launch; kernel 9 splits the 8,193 beams over
    CTAs and kernel 8's epilogue keeps its picks in device memory."""
    V = 64
    cfg = bart_tiny(vocab_size=V)
    params = bart.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    toks = (rng.zipf(1.3, size=4000) % (V - 4) + 4).astype(np.int64)
    host = FMIndex()
    host.initialize([d.tolist() + [2] for d in np.array_split(toks, 40)])
    queries = [[0] + rng.integers(4, V, size=5).tolist() + [2]]
    kw = dict(num_beams=8193, max_length=3, min_length=1, exact_mask=True)
    assert dense_scores.route(1, 8193, V, 2 * 8193) == "stream_sort"
    cpu = tg.fm_index_generate(cfg, params, TorchFMIndex.from_host(host, vocab=V, device="cpu"),
                               queries, **kw)
    s0, d0 = dense_scores.STREAM_SORT.launches, dense_scores.dense_select.launches
    g0, m0 = row_topk.GLOBAL_SORT.launches, fm_search.fm_dense_mask.launches
    c0 = fm_search.fm_dense_counts.launches
    gpu = tg.fm_index_generate(cfg, _to(params, cuda),
                               TorchFMIndex.from_host(host, vocab=V, device=cuda), queries, **kw)
    assert dense_scores.STREAM_SORT.launches > s0 and dense_scores.dense_select.launches == d0
    assert row_topk.GLOBAL_SORT.launches > g0
    assert fm_search.fm_dense_mask.launches > m0 and fm_search.fm_dense_counts.launches == c0
    assert sum(map(len, gpu)) > 0
    for a, b in zip(cpu, gpu):
        ka, kb = sorted((tuple(t), s) for s, t in a), sorted((tuple(t), s) for s, t in b)
        assert [t for t, _ in ka] == [t for t, _ in kb]
        np.testing.assert_allclose([s for _, s in kb], [s for _, s in ka], atol=1e-4, rtol=0)


def test_dense_select_past_max_k_matches_plain(cuda):
    """The dense step past kernel 3's shared sort (k = 2K = 16,386 of a
    [2, 8,193 x 64] row): the streaming pass and kernel 3's global sort,
    bit for bit the plain version, with every branch; a forced select
    layout at that k raises."""
    g = torch.Generator(device=cuda).manual_seed(8193)
    B, K, V = 2, 8193, 64
    args = _dense_inputs(g, B, K, V, cuda)
    kw = dict(eos=2, pad=1, **DENSE_BRANCHES["branches"])
    s0, d0 = dense_scores.STREAM_SORT.launches, dense_scores.dense_select.launches
    got = dense_scores.dense_select(*args, 2 * K, **kw)
    assert (dense_scores.STREAM_SORT.launches, dense_scores.dense_select.launches) == (s0 + 1, d0)
    _same(got, dense_scores.dense_select_plain(*args, 2 * K, **kw))
    with pytest.raises(ValueError, match="global sort"):
        dense_scores.dense_select(*args, 2 * K, layout=row_topk.plan(B, K * V, 2 * K), **kw)


def test_sampler_draws_the_softmax_on_card(cuda):
    """2^16 chains of one 16-candidate row, 4 slots masked: the kernel's
    draws fit the softmax of the allowed log-probs (chi-square p > 1e-3)."""
    from scipy import stats

    rng = np.random.default_rng(7)
    N, n = 16, 1 << 16
    lp = torch.as_tensor(np.log(rng.dirichlet(np.ones(N))).astype(np.float32), device=cuda)
    allowed = torch.ones(N, dtype=torch.bool, device=cuda)
    allowed[[0, 5, 9, 15]] = False
    rows = lp.expand(1, n, N).contiguous()
    out = sample_select.sample_select(rows, rows, None, torch.zeros(1, n, device=cuda), 5, 3, eos=2,
                                      pad=1, mask=allowed)
    counts = torch.bincount(out[4][0].long(), minlength=N).cpu().numpy()
    ok = allowed.cpu().numpy()
    assert counts[~ok].sum() == 0
    p = torch.softmax(lp[allowed].double(), 0).cpu().numpy()
    assert stats.chisquare(counts[ok], p * n).pvalue > 1e-3


def _diverse_inputs(g, case, cuda):
    B, K = 32, 15
    V = 50265 if case == "wide" else 64
    lp = _lp(g, B * K, V, cuda).reshape(B, K, V)
    cons = torch.where(torch.rand(B, K, V, generator=g, device=cuda) < 0.7, lp, tc.NEG_INF)
    bs = torch.round(torch.randn(B, K, generator=g, device=cuda) * 2) / 2 - 3
    bs[:, 1::5] = tc.NEG_INF
    if case == "wide":
        return cons, None, bs, torch.rand(V, generator=g, device=cuda) < 0.8
    tokens = torch.randint(0, 40, (B, K, V), generator=g, device=cuda, dtype=torch.int32)
    tokens[:, :, -2] = 2
    return cons, tokens, bs, None


@pytest.mark.parametrize("case,ties", [("candidates", False), ("candidates", True),
                                       ("wide", False), ("wide", True)])
def test_diverse_select_matches_plain(cuda, case, ties):
    """Kernel 21 at beam 15 in three groups, penalty 0.5: a [32, 15, 64]
    candidate list (tokens repeat, so the penalty bites) and V-wide rows
    under a corpus mask; every output bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(21 + ties)
    cons, tokens, bs, mask = _diverse_inputs(g, case, cuda)
    kw = dict(groups=3, penalty=0.5, eos=2, ties=ties, vocab=50265, mask=mask)
    route = "wide" if case == "wide" else "list"
    n0, r0 = diverse_select.diverse_select.launches, diverse_select.ROUTES[route].launches
    got = diverse_select.diverse_select(cons, tokens, bs, **kw)
    assert diverse_select.diverse_select.launches == n0 + 1
    assert diverse_select.ROUTES[route].launches == r0 + 1
    _same(got, diverse_select.diverse_select_plain(cons, tokens, bs, **kw))
    assert diverse_select.proof_failures(cuda) == 0


# kernel 21's V-wide route at the bench point, one group, one beam a group,
# and M (the survivors a group) at its limit of 512 and past it
DIVERSE_WIDE = {"bench": (32, 15, 50265, 3), "one_group": (4, 15, 3000, 1),
                "gs1": (4, 15, 3000, 15), "m512": (2, 256, 300, 128), "m516": (2, 258, 300, 129)}


def _wide_inputs(g, B, K, V, cuda):
    """V-wide rows crowded for the lemma: every beam's best columns are
    the same few (each earlier pick's token among a group's best slots),
    NEG_INF plateaus, -inf columns, EOS among the top."""
    cons = torch.where(torch.rand(B, K, V, generator=g, device=cuda) < 0.7,
                       _lp(g, B * K, V, cuda).reshape(B, K, V), tc.NEG_INF)
    best = torch.randperm(V, generator=g, device=cuda)[:8]
    cons[:, :, best] = torch.round(torch.randn(B, 1, 8, generator=g, device=cuda)) / 4
    cons[:, :, 2] = 0.25  # EOS
    bs = torch.round(torch.randn(B, K, generator=g, device=cuda) * 2) / 2 - 3
    bs[:, 1::5] = tc.NEG_INF
    return cons, bs, torch.rand(V, generator=g, device=cuda) < 0.8


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("penalty", [0.0, 0.5])
@pytest.mark.parametrize("case", sorted(DIVERSE_WIDE))
def test_diverse_select_wide_route_matches_plain(cuda, case, penalty, ties, masked):
    """Kernel 21 on V-wide rows: the wide route (2 launches) up to M = 512,
    the chunked one past it, bit for bit against the plain version and the
    top-M mirror; the proof counter stays 0."""
    B, K, V, G = DIVERSE_WIDE[case]
    g = torch.Generator(device=cuda).manual_seed(len(case) + int(ties) + 2 * int(masked))
    cons, bs, mask = _wide_inputs(g, B, K, V, cuda)
    mask = mask if masked else None
    kw = dict(groups=G, penalty=penalty, eos=2, ties=ties, vocab=V, mask=mask)
    M = diverse_select.wide_survivors(K, G, penalty)
    route, _ = diverse_select.route(B, K, V, groups=G, penalty=penalty, ties=ties, vocab=V,
                                    wide=True)
    assert route == ("wide" if M <= diverse_select.WIDE_MAX else "chunked")
    r0 = diverse_select.ROUTES[route].launches
    got = diverse_select.diverse_select(cons, None, bs, **kw)
    assert diverse_select.ROUTES[route].launches == r0 + 1
    want = diverse_select.diverse_select_plain(cons, None, bs, **kw)
    _same(got, want)
    mirror, short = diverse_select.diverse_select_topm_plain(cons, bs, **kw)
    _same(mirror, want)
    assert short == 0 and diverse_select.proof_failures(cuda) == 0


@pytest.mark.parametrize("N,route", [(diverse_select.LIST_MAX // 2, "list"),
                                     (diverse_select.LIST_MAX // 2 + 1, "chunked")])
def test_diverse_select_list_route_limit(cuda, N, route):
    """A token table takes the list route up to ``LIST_MAX`` slots a group
    (two beams a group here) and the chunked route past it, where the list
    route forced (for measurements) still serves; all exact, in both
    orders."""
    g = torch.Generator(device=cuda).manual_seed(N)
    B, K, G = 3, 4, 2
    cons = torch.where(torch.rand(B, K, N, generator=g, device=cuda) < 0.7,
                       _lp(g, B * K, N, cuda).reshape(B, K, N), tc.NEG_INF)
    tokens = torch.randint(0, 40, (B, K, N), generator=g, device=cuda, dtype=torch.int32)
    bs = torch.round(torch.randn(B, K, generator=g, device=cuda) * 2) / 2 - 3
    for ties in (False, True):
        kw = dict(groups=G, penalty=0.5, eos=2, ties=ties, vocab=50265)
        assert diverse_select.route(B, K, N, groups=G, penalty=0.5, ties=ties, vocab=50265,
                                    wide=False)[0] == route
        r0 = diverse_select.ROUTES[route].launches
        got = diverse_select.diverse_select(cons, tokens, bs, **kw)
        assert diverse_select.ROUTES[route].launches == r0 + 1
        want = diverse_select.diverse_select_plain(cons, tokens, bs, **kw)
        _same(got, want)
        if route == "chunked":
            _same(diverse_select.diverse_select(cons, tokens, bs, force="list", **kw), want)


def _route_inputs(g, route, cuda):
    """(cons, tokens, bs, kw) of a call on ``route``."""
    if route == "list":
        cons, tokens, bs, _ = _diverse_inputs(g, "candidates", cuda)
        return cons, tokens, bs, dict(groups=3, penalty=0.5, eos=2, vocab=50265)
    B, K, V, G = DIVERSE_WIDE["bench" if route == "wide" else "m516"]
    cons, bs, mask = _wide_inputs(g, B, K, V, cuda)
    return cons, None, bs, dict(groups=G, penalty=0.5, eos=2, vocab=V, mask=mask)


@pytest.mark.parametrize("route", ["wide", "list", "chunked"])
def test_diverse_select_routes_launches_and_graph(cuda, route):
    """Each route's CUDA kernels a call (2, 1 and 2G, counted by the
    profiler), and its outputs replayed from a CUDA graph equal the plain
    version's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=cuda).manual_seed(7)
    cons, tokens, bs, kw = _route_inputs(g, route, cuda)
    call = lambda: diverse_select.diverse_select(cons, tokens, bs, **kw)  # noqa: E731
    call()
    torch.cuda.synchronize()
    r0 = diverse_select.ROUTES[route].launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    assert diverse_select.ROUTES[route].launches == r0 + 1
    kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    assert len(kernels) == {"wide": 2, "list": 1, "chunked": 2 * kw["groups"]}[route], kernels
    _same(_graph_call(call), diverse_select.diverse_select_plain(cons, tokens, bs, **kw))
    assert diverse_select.proof_failures(cuda) == 0


@pytest.mark.parametrize("n_buf,w,keep_invalid,with_buf", [(30, 32, False, True),
                                                           (30, 32, False, False),
                                                           (256, 32, False, True),
                                                           (256, 128, True, True),
                                                           (1900, 146, False, True)])
def test_beam_candidates_matches_plain(cuda, n_buf, w, keep_invalid, with_buf):
    """Kernel 8's candidate mode, a warp a beam row, at the routes' widths:
    the diverse proposal route (64 slots a beam, with a buffer or none),
    sampling's (290), the speculative route (386) and SERIAL_MAX (2,048),
    first instances from the hash table; every output bit for bit, no
    table launched."""
    g = torch.Generator(device=cuda).manual_seed(n_buf + w)
    B, K, V = 32, 15, 3000
    lp = _lp(g, B * K, V, cuda)
    top_lp, top_idx = row_topk.row_topk_plain(lp, n_buf)
    buf = (top_idx.to(torch.int32).reshape(B, K, n_buf), top_lp.reshape(B, K, n_buf),
           torch.rand(B, K, n_buf, generator=g, device=cuda) < 0.5) if with_buf else None
    win_valid = torch.rand(B, K, w, generator=g, device=cuda) < 0.7
    win_tok = torch.where(win_valid, torch.randint(0, 400, (B, K, w), generator=g, device=cuda,
                                                   dtype=torch.int32), 1)
    win_lp = torch.gather(lp, 1, win_tok.reshape(B * K, -1).long()).reshape(B, K, w)
    eos_ok = (torch.rand(B, K, 2, generator=g, device=cuda) < 0.5)[..., 1:]
    prev_count = torch.randint(0, 6, (B, K), generator=g, device=cuda, dtype=torch.int32)
    finished = torch.rand(B, K, generator=g, device=cuda) < 0.2
    args = (buf, n_buf, win_tok, win_valid, win_lp, eos_ok, lp, prev_count, finished)
    kw = dict(eos=2, pad=1, stop_at_count=1, always_allow_eos=False, keep_invalid=keep_invalid)
    n0, t0 = beam_select.beam_candidates.launches, beam_select.CAND_TABLE.launches
    got = beam_select.beam_candidates(*args, **kw)
    assert beam_select.beam_candidates.launches == n0 + 1
    assert beam_select.CAND_TABLE.launches == t0
    _same(got, beam_select.candidates_plain(*args, **kw))


SAMPLE_MODES = {
    "sample": dict(sample=True, seed=3),
    "sample_dense": dict(sample=True, seed=3, exact_mask=True),
    "sample_free": dict(sample=True, seed=3, disable_fm_index=True, top_m=8),
    "sample_spec": dict(sample=True, seed=3, speculative=True, top_m=8),
    "diverse": dict(diverse_bs_groups=2, diverse_bs_penalty=0.5),
    "diverse_dense": dict(diverse_bs_groups=2, diverse_bs_penalty=0.5, exact_mask=True),
    "diverse_ties": dict(diverse_bs_groups=2, diverse_bs_penalty=0.5, exact_ties=True),
    "diverse_dense_ties": dict(diverse_bs_groups=2, diverse_bs_penalty=0.5, exact_mask=True,
                               exact_ties=True),
    "diverse_free": dict(diverse_bs_groups=2, diverse_bs_penalty=0.5, disable_fm_index=True),
}


@pytest.mark.parametrize("layout", ["psi", "compact", "hybrid"])
@pytest.mark.parametrize("mode", sorted(SAMPLE_MODES))
def test_sample_and_diverse_on_card_match_cpu(cuda, mode, layout):
    """Sampling (the same seed) and diverse groups: the card's hypotheses
    equal the CPU plain path's on every layout (sampled draws too: the
    generators agree but where logf and log round a near-tie apart)."""
    _modes_on_card(cuda, SAMPLE_MODES[mode], layout)


def test_diverse_searcher_on_card_matches_cpu(cuda):
    def run(dev):
        s = bench_search.tiny_searcher(dev)
        s.diverse_bs_groups, s.diverse_bs_penalty = 2, 0.5
        return s.batch_search(bench_search.TINY_QUERIES, k=5)

    cpu, gpu = run("cpu"), run(cuda)
    assert any(gpu)
    for a, b in zip(cpu, gpu):
        assert [d.docid for d in b] == [d.docid for d in a]
        np.testing.assert_allclose([d.score for d in b], [d.score for d in a], rtol=1e-4)


# ------------------------------------------------------ the sharded index


def _sharded(S, device):
    """A Zipf corpus split round-robin into S shards (their alphabets differ),
    and per-shard ranges [S, 6, 8]: prefixes of each shard's text, its full
    range, an empty one and one into the padded rows."""
    rng = np.random.default_rng(S)
    toks = (rng.zipf(1.2, size=6000) % 28 + 4).astype(np.int64)
    docs = [d.tolist() + [2] for d in np.array_split(toks, 120)]
    docs[3] = docs[3][:-1] + [39, 38, 2]
    si, hosts, _ = sharded_index.ShardedTorchIndex.build(docs, S, 40, device=device)
    B, K = 6, 8
    los, his = [], []
    for s_, h in enumerate(hosts):
        v = si.block_view(s_)
        first = torch.as_tensor(rng.choice(h.text[:-1] - 1, size=(2, B, K)).astype(np.int32),
                                device=device)
        flo = torch.zeros((B, K), dtype=torch.int32, device=device)
        fhi = torch.full((B, K), h.size(), dtype=torch.int32, device=device)
        lo1, hi1 = fm_search.backward_step_plain(v, first[0], flo, fhi)
        lo2, hi2 = fm_search.backward_step_plain(v, first[1], lo1, hi1)
        lo, hi = torch.where(torch.arange(K, device=device) % 2 == 0, lo1, lo2), \
            torch.where(torch.arange(K, device=device) % 2 == 0, hi1, hi2)
        lo[0, :3] = torch.tensor([0, 5, max(h.size() - 3, 0)], dtype=torch.int32)
        hi[0, :3] = torch.tensor([h.size(), 5, si.n_max], dtype=torch.int32)
        los.append(lo)
        his.append(hi)
    return si, hosts, torch.stack(los), torch.stack(his)


@pytest.mark.parametrize("S", [1, 2, 3, 4, 8])
def test_shard_modes_match_plain(cuda, S):
    """Kernels 1, 2, 5, 6 and 15 in their shard modes: one launch a call
    whatever S, each equal to its plain version (every shard's plain
    result, then the OR, sum or concatenation), padded rows included.
    Kernel 1's modes at the plan's (G, P) and at every group width forced
    (P cut to 32 // G: a member loops over its shards), on ranges that are
    empty or reach the padding row, symbols a shard lacks and tokens
    outside [0, sigma)."""
    si, hosts, lo, hi = _sharded(S, cuda)
    g = torch.Generator(device=cuda).manual_seed(S)
    V = si.vocab
    B, K = lo.shape[1:]
    ext = torch.randint(-1, V + 2, (B, K), generator=g, device=cuda, dtype=torch.int32)
    cand = torch.randint(-1, V + 2, (B, K, 9), generator=g, device=cuda, dtype=torch.int32)
    cand[..., 0] = 38  # a symbol of one shard only
    n0, s0 = fm_search.fm_search_sharded.launches, fm_search.STEP_SHARDED.launches
    for group in (None,) + fm_search.CONTAINS_GROUPS:
        for mode, toks in (("backward_step", ext), ("contains", cand), ("validate", cand)):
            if group == 1 and mode != "contains":  # membership alone takes a lane a shard
                continue
            _same(_as_tuple(fm_search.fm_search_sharded(si, mode, toks, lo, hi, group=group)),
                  _as_tuple(fm_search.fm_search_sharded_plain(si, mode, toks, lo, hi)))
    assert fm_search.fm_search_sharded.launches == n0 + 3 * (1 + len(fm_search.GROUPS)) + 1
    assert fm_search.STEP_SHARDED.launches == s0 + 1 + len(fm_search.GROUPS)
    with pytest.raises(ValueError):
        fm_search.fm_search_sharded(si, "validate", cand, lo, hi, group=1)
    lp = torch.log_softmax(torch.randn(B * K, V, generator=g, device=cuda), -1)
    for w, fill in ((4, 1), (16, 0)):
        n0 = window_gather.window_gather_sharded.launches
        got = window_gather.window_gather_sharded(si, lo, hi, w, lp, fill)
        assert window_gather.window_gather_sharded.launches == n0 + 1
        assert got[0].shape == (B, K, S * w)
        _same(got, window_gather.window_gather_sharded_plain(si, lo, hi, w, lp, fill))
    n0 = bucket_counts.bucket_counts_sharded.launches
    _same((bucket_counts.bucket_counts_sharded(si, lo, hi),),
          (bucket_counts.bucket_counts_sharded_plain(si, lo, hi),))
    assert bucket_counts.bucket_counts_sharded.launches == n0 + 1
    n0 = bucket_counts.bucket_support_sharded.launches
    _same((bucket_counts.bucket_support_sharded(si, lo, hi),),
          (bucket_counts.bucket_support_sharded_plain(si, lo, hi),))
    assert bucket_counts.bucket_support_sharded.launches == n0 + 1
    want = fm_search.dense_counts_sharded_plain(si, lo, hi, 16)
    for hist_max in (fm_search.HIST_MAX_ROWS, 0, 7):
        _same((fm_search.fm_dense_counts_sharded(si, lo, hi, hist_max=hist_max),), (want,))
    rng = np.random.default_rng(S)
    seqs = torch.as_tensor(rng.integers(0, V + 2, size=(50, 6)).astype(np.int32), device=cuda)
    text = hosts[0].text[:-1] - 1
    for i in range(25):  # corpus n-grams of the first shard
        seqs[i] = torch.as_tensor(text[i * 7 : i * 7 + 6][::-1].copy())
    lens = torch.as_tensor(rng.integers(0, 7, size=50).astype(np.int32), device=cuda)
    n0 = fm_search.fm_sequences_sharded.launches
    _same(fm_search.fm_sequences_sharded(si, seqs, lens),
          fm_search.sequences_sharded_plain(si, seqs, lens))
    count = fm_search.fm_sequences_sharded(si, seqs, lens, count=True)
    assert fm_search.fm_sequences_sharded.launches == n0 + 2
    _same((count,), (fm_search.sequences_sharded_plain(si, seqs, lens, count=True),))
    host_counts = [sum(h.get_count(seqs[i, : lens[i]].tolist()) for h in hosts)
                   for i in range(50)]
    assert count.tolist() == host_counts and sum(c > 0 for c in host_counts) >= 25


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _sharded_selections(si, lo, hi, seed, cuda):
    """A step's selections over [S, B, K] ranges: random parents, tokens of
    the corpus, EOS, PAD and out-of-range ids, a quarter of the parents
    finished."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    B, K = lo.shape[1:]
    sel_tok = torch.randint(-1, si.vocab + 2, (B, K), generator=g, device=cuda,
                            dtype=torch.int32)
    sel_tok[0, :2] = torch.tensor([2, 1], dtype=torch.int32)  # EOS, PAD
    sel_par = torch.randint(0, K, (B, K), generator=g, device=cuda, dtype=torch.int32)
    finished = torch.rand((B, K), generator=g, device=cuda) < 0.25
    return sel_tok, sel_par, finished


@pytest.mark.parametrize("graph", [False, True])
@pytest.mark.parametrize("S", [1, 2, 3, 4, 8])
def test_fm_advance_sharded_matches_plain(cuda, S, graph):
    """Kernel 1's shard step mode (the sharded range update in one launch)
    at step 0 (one parent a query, no stop rule) and later, at the plan's
    width and each forced, eagerly and replayed from a CUDA graph: equal to
    its plain version, to ``advance_ranges`` over the kernel's own backward
    step and summed range size, and to ``ShardedIndexOps.advance``."""
    from seal_tpu_torch.ops import _generic

    run = _graph_call if graph else (lambda fn: fn())
    si, _, lo, hi = _sharded(S, cuda)
    sel_tok, sel_par, finished = _sharded_selections(si, lo, hi, S, cuda)
    steps = ((torch.zeros_like(sel_par), lo[..., :1].contiguous(), hi[..., :1].contiguous(),
              None), (sel_par, lo, hi, finished))
    kw = dict(eos=2, pad=1)
    for par, plo, phi, fin in steps:
        want = fm_search.advance_sharded_plain(si, sel_tok, par, plo, phi, fin, **kw)
        composed = _generic.advance_ranges(
            lambda t, a, b: fm_search.fm_search_sharded(si, "backward_step", t, a, b),
            lambda a, b: (b - a).sum(0, dtype=torch.int32), sel_tok, par, plo, phi, fin, **kw)
        _same(composed, want)
        assert want[0].shape == (S, *sel_tok.shape) and want[2].shape == sel_tok.shape
        for group in (None,) + fm_search.GROUPS:
            a0 = fm_search.ADVANCE_SHARDED.launches
            got = run(lambda: fm_search.fm_advance_sharded(si, sel_tok, par, plo, phi, fin,
                                                           group=group, **kw))
            assert fm_search.ADVANCE_SHARDED.launches == a0 + (2 if graph else 1)
            _same(got, want)
        s0 = fm_search.STEP_SHARDED.launches
        _same(sharded_decode.ShardedIndexOps(si).advance(sel_tok, par, plo, phi, fin, **kw), want)
        assert fm_search.STEP_SHARDED.launches == s0  # no backward-step launch
    assert (want[0] == 0).any() and (want[1] > want[0]).any()


def test_shard_modes_limits(cuda):
    """Kernel 1's shard modes at sizes past the bench point's: 16.9M
    (range, token) items over 4 shards, and 262,144 selections over 8
    shards (16.8M lanes at 8 a team of 8), equal to their plain versions;
    malformed inputs raise."""
    si, hosts, _, _ = _sharded(4, cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    B, K, M = 2048, 64, 129
    rows = torch.as_tensor([h.size() for h in hosts], device=cuda)[:, None, None]
    lo = (torch.rand((4, B, K), generator=g, device=cuda) * rows).int()
    hi = torch.minimum(lo + torch.randint(0, 600, (4, B, K), generator=g, device=cuda,
                                          dtype=torch.int32), rows.int())
    cand = torch.randint(-1, si.vocab + 2, (B, K, M), generator=g, device=cuda,
                         dtype=torch.int32)
    for mode in ("contains", "validate"):
        _same(_as_tuple(fm_search.fm_search_sharded(si, mode, cand, lo, hi)),
              _as_tuple(fm_search.fm_search_sharded_plain(si, mode, cand, lo, hi)))
    si8, _, _, _ = _sharded(8, cuda)
    B, K = 4096, 64
    lo8 = torch.zeros((8, B, K), dtype=torch.int32, device=cuda)
    hi8 = si8.n_rows[:, None, None].expand(8, B, K).contiguous()
    sel_tok, sel_par, finished = _sharded_selections(si8, lo8, hi8, 1, cuda)
    _same(fm_search.fm_advance_sharded(si8, sel_tok, sel_par, lo8, hi8, finished, eos=2, pad=1),
          fm_search.advance_sharded_plain(si8, sel_tok, sel_par, lo8, hi8, finished, eos=2,
                                          pad=1))
    with pytest.raises(ValueError):
        fm_search.fm_advance_sharded(si8, sel_tok, sel_par, lo8[:4], hi8[:4], eos=2, pad=1)
    with pytest.raises(ValueError):
        fm_search.fm_advance_sharded(si8, sel_tok, sel_par, lo8, hi8, finished.int(), eos=2,
                                     pad=1)
    with pytest.raises(ValueError):
        fm_search.fm_search_sharded(si8, "backward_step", sel_tok, lo8, hi8, group=3)


@pytest.mark.parametrize("ties,keep_invalid", [(False, False), (True, False), (False, True)])
def test_beam_select_large_route_matches_plain(cuda, ties, keep_invalid):
    """Kernel 8's large-n route at beam 32 over a 4-shard union window
    (18,496 candidates a query): two launches, equal to ``beam_select_plain``
    and to the route's two-stage specification bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(int(ties) + 2 * int(keep_invalid))
    B, K, V = 8, 32, 3000
    n_buf, w = 2 * K, 4 * 128
    lp = _lp(g, B * K, V, cuda)

    def take(tok):
        return torch.gather(lp, 1, tok.reshape(B * K, -1).long()).reshape(tok.shape)

    btok = torch.randint(0, 400, (B, K, n_buf), generator=g, device=cuda, dtype=torch.int32)
    win_valid = torch.rand(B, K, w, generator=g, device=cuda) < 0.6
    win_tok = torch.where(win_valid, torch.randint(0, 400, (B, K, w), generator=g, device=cuda,
                                                   dtype=torch.int32), 1)
    bs = torch.round(torch.randn(B, K, generator=g, device=cuda) * 2) / 2 - 3
    bs[0, 1] = tc.NEG_INF
    bs[1, :] = bs[1, 0]
    args = ((btok, take(btok), torch.rand(B, K, n_buf, generator=g, device=cuda) < 0.7), n_buf,
            win_tok, win_valid, take(win_tok),
            (torch.rand(B, K, 3, generator=g, device=cuda) < 0.5)[..., 2:], lp,
            torch.randint(0, 6, (B, K), generator=g, device=cuda, dtype=torch.int32),
            torch.rand(B, K, generator=g, device=cuda) < 0.2, bs,
            torch.rand(B, K, generator=g, device=cuda) < 0.5,
            torch.round(torch.randn(B, K, generator=g, device=cuda)) - 4)
    kw = dict(K=K, eos=2, pad=1, stop_at_count=0, always_allow_eos=False, ties=ties,
              keep_invalid=keep_invalid)
    n0 = beam_select.LARGE.launches
    got, bad = beam_select.beam_select(*args, route="large", **kw)
    assert beam_select.LARGE.launches == n0 + 1
    want, wbad = beam_select.beam_select_plain(*args, **kw)
    _same(got + (bad,), want + (wbad,))
    spec, sbad = beam_select.beam_select_large_plain(*args, **kw)
    _same(spec + (sbad,), want + (wbad,))


@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("mode", ["fast", "force_full", "exact_mask", "beam32"])
def test_sharded_generate_on_card_matches_cpu(cuda, S, mode):
    """The sharded decoder on the card equals its CPU path (tiny BART, f32):
    hypotheses, scores within 1e-4."""
    si_cpu, hosts, _, _ = _sharded(S, "cpu")
    si = sharded_index.ShardedTorchIndex.from_hosts(hosts, 40, device=cuda)
    cfg = bart_tiny(vocab_size=40)
    params = bart.init_params(cfg, seed=1, device="cpu")
    queries = [[0, 5, 7, 9, 11, 2], [0, 6, 6, 8, 2], [0, 12, 4, 2]]
    kw = dict(num_beams=32 if mode == "beam32" else 4, max_length=5, min_length=1,
              forced_bos_token_id=None, force_full=mode == "force_full",
              exact_mask=mode == "exact_mask", window=128 if mode == "beam32" else 4)
    want = sharded_decode.sharded_fm_index_generate(cfg, params, si_cpu, None, queries, **kw)
    got = sharded_decode.sharded_fm_index_generate(cfg, _to(params, cuda), si, None, queries,
                                                   **kw)
    for a, b in zip(want, got):
        ka, kb = sorted((tuple(t), sc) for sc, t in a), sorted((tuple(t), sc) for sc, t in b)
        assert [t for t, _ in ka] == [t for t, _ in kb]
        np.testing.assert_allclose([sc for _, sc in kb], [sc for _, sc in ka], atol=1e-4)



def _two_rank_sharded_decode(rank, queries, modes):
    """A rank of ``test_sharded_generate_two_ranks_on_one_card``: its 2 of
    the 4 shards on cuda:0, every mode's hypotheses."""
    from seal_tpu_torch.parallel import mesh as mesh_lib

    torch.cuda.set_device(0)
    mesh = mesh_lib.make_mesh(device="cuda:0")
    si = _sharded(4, "cpu")[0].place(mesh)
    cfg = bart_tiny(vocab_size=40)
    params = bart.init_params(cfg, seed=1, device="cuda:0")
    return {m: sharded_decode.sharded_fm_index_generate(cfg, params, si, mesh, queries, **kw)
            for m, kw in modes.items()}


def test_sharded_generate_two_ranks_on_one_card(cuda):
    """Two ranks of a gloo group on the one card, 2 shards each
    (``ShardedTorchIndex.place``): every mode's hypotheses bit-equal (tokens,
    score bits) to one process's 4-shard decode on the card."""
    from seal_tpu_torch.parallel import multihost

    base = dict(num_beams=4, max_length=5, min_length=1, forced_bos_token_id=None, window=4,
                exact_chunk=4)
    modes = {"fast": base, "force_full": dict(base, force_full=True),
             "exact_mask": dict(base, exact_mask=True),
             "sample": dict(base, sample=True, seed=3, top_m=8)}
    queries = [[0, 5, 7, 9, 11, 2], [0, 6, 6, 8, 2], [0, 12, 4, 2]]
    si = sharded_index.ShardedTorchIndex.from_hosts(_sharded(4, "cpu")[1], 40, device=cuda)
    cfg = bart_tiny(vocab_size=40)
    params = bart.init_params(cfg, seed=1, device=cuda)
    want = {m: sharded_decode.sharded_fm_index_generate(cfg, params, si, None, queries, **kw)
            for m, kw in modes.items()}
    outs = multihost.spawn_ranks(_two_rank_sharded_decode, 2, (queries, modes), timeout_s=240)
    for out in outs:
        for m in modes:
            assert out[m] == want[m] and sum(map(len, want[m])) > 0, m


# ---- kernel 8's selection routes and the routes past shared memory (F1, F2)


def _select_inputs(cuda, seed, B, K, n_buf, w, V, tok_hi, keep_invalid):
    """``beam_select``'s inputs on the card: buffer and window tokens from
    [0, tok_hi) (duplicates within and across them), ties, signed zeros, a
    dead beam, a query whose beams share one score, finished beams."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    lp = _lp(g, B * K, V, cuda)

    def take(tok):
        return torch.gather(lp, 1, tok.reshape(B * K, -1).long()).reshape(tok.shape)

    btok = torch.randint(0, tok_hi, (B, K, n_buf), generator=g, device=cuda, dtype=torch.int32)
    win_valid = torch.rand(B, K, w, generator=g, device=cuda) < 0.6
    win_tok = torch.where(win_valid, torch.randint(0, tok_hi, (B, K, w), generator=g, device=cuda,
                                                   dtype=torch.int32), 1)
    bs = torch.round(torch.randn(B, K, generator=g, device=cuda) * 2) / 2 - 3
    bs[0, 1 % K] = tc.NEG_INF
    bs[-1, :] = bs[-1, 0]
    args = ((btok, take(btok), torch.rand(B, K, n_buf, generator=g, device=cuda) < 0.7), n_buf,
            win_tok, win_valid, take(win_tok),
            (torch.rand(B, K, 3, generator=g, device=cuda) < 0.5)[..., 2:], lp,
            torch.randint(0, 6, (B, K), generator=g, device=cuda, dtype=torch.int32),
            torch.rand(B, K, generator=g, device=cuda) < 0.2, bs,
            torch.rand(B, K, generator=g, device=cuda) < 0.5,
            torch.round(torch.randn(B, K, generator=g, device=cuda)) - 4)
    return args, dict(eos=2, pad=1, stop_at_count=0, always_allow_eos=False,
                      keep_invalid=keep_invalid)


SELECT_ROUTES = {  # route: B, beams, n_buf, w, V -- each route at the path's shapes and limits
    "warp_bench": ("warp", 32, 15, 30, 32, 3000),  # 64 candidates a beam
    "warp_beam32": ("warp", 32, 32, 64, 32, 3000),  # 98
    "warp_limit": ("warp", 4, 32, 64, 62, 3000),  # 128 candidates, 2K = 64, 32 beams
    "warp_one_reg": ("warp", 8, 4, 8, 16, 3000),  # 26, one slot a lane
    "warp_narrow": ("warp", 8, 8, 4, 4, 3000),  # 10 candidates for a top-16
    "wide_spec": ("wide", 8, 15, 256, 128, 3000),  # the speculative default (386)
    "wide_beam32": ("wide", 4, 32, 64, 512, 3000),  # beam 32 over 4 shards (578)
    "wide_limit": ("wide", 2, 15, 256, 1342, 3000),  # 1,600 candidates a beam
    "wide_narrow": ("wide", 8, 8, 4, 4, 3000),  # 10 candidates for a top-16
    "block_spec": ("block", 8, 15, 256, 128, 3000),  # the speculative default (386)
    "large_beam32": ("large", 4, 32, 64, 512, 3000),  # beam 32 over 4 shards (578)
    "large_limit": ("large", 2, 15, 30, 2016, 3000),  # SERIAL_MAX candidates a beam
    "table_one_chunk": ("table", 2, 15, 3000, 32, 50265),
    "table_spec_20000": ("table", 2, 15, 20000, 128, 50265),  # F2: three chunks
    "table_vocab": ("table", 1, 15, 50265, 128, 50265),  # top_m = V: seven chunks
}


@pytest.mark.parametrize("keep_invalid", [False, True])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("name", sorted(SELECT_ROUTES))
def test_beam_select_routes_match_plain(cuda, name, ties, keep_invalid):
    """Every route of kernel 8's selection, forced, at the path's shapes and
    at its limits: the nine outputs and ``unsound`` equal
    ``beam_select_plain`` bit for bit, in both orders and with
    ``keep_invalid``; the launch counts on its ``ROUTES`` entry."""
    route, B, K, n_buf, w, V = SELECT_ROUTES[name]
    args, kw = _select_inputs(cuda, len(name) + 2 * ties + keep_invalid, B, K, n_buf, w, V,
                              min(V, max(400, n_buf // 2)), keep_invalid)
    n0 = beam_select.ROUTES[route].launches
    got, bad = beam_select.beam_select(*args, K=K, ties=ties, route=route, **kw)
    assert beam_select.ROUTES[route].launches == n0 + 1
    want, wbad = beam_select.beam_select_plain(*args, K=K, ties=ties, **kw)
    _same(got + (bad,), want + (wbad,))
    no_flags = args[:-2] + (None, None)
    got, bad = beam_select.beam_select(*no_flags, K=K, ties=ties, route=route, **kw)
    assert bad is None
    _same(got, beam_select.beam_select_plain(*no_flags, K=K, ties=ties, **kw)[0])


@pytest.mark.parametrize("keep_invalid", [False, True])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("B,K,n_buf,w", [(32, 15, 256, 128), (8, 32, 64, 512),
                                         (32, 15, 30, 512)])
def test_beam_select_wide_route_matches_plain(cuda, B, K, n_buf, w, ties, keep_invalid):
    """Kernel 8's wide route at the path's shapes as ``select_plan`` picks
    it -- the speculative default [32, 15, 386], beam 32 over 4 shards
    [8, 32, 578], beam 15 over 4 shards [32, 15, 544] --, a cluster of
    ``wide_splits`` CTAs a query (at beam 15 the last CTA has a spare
    warp), in both orders, with and without the soundness flags: equal to
    ``beam_select_plain`` bit for bit, one launch on ``ROUTES["wide"]``,
    none on the block or large-n route; and replayed from a CUDA graph."""
    args, kw = _select_inputs(cuda, B + K + w + ties, B, K, n_buf, w, 3000, 400, keep_invalid)
    counts = lambda: {r: c.launches for r, c in beam_select.ROUTES.items()}  # noqa: E731
    n0 = counts()
    got, bad = beam_select.beam_select(*args, K=K, ties=ties, **kw)
    n1 = counts()
    assert {r: n1[r] - n0[r] for r in n0} == {r: int(r == "wide") for r in n0}
    want, wbad = beam_select.beam_select_plain(*args, K=K, ties=ties, **kw)
    _same(got + (bad,), want + (wbad,))
    no_flags = args[:-2] + (None, None)
    _same(_graph_call(lambda: beam_select.beam_select(*no_flags, K=K, ties=ties, **kw)[0]),
          beam_select.beam_select_plain(*no_flags, K=K, ties=ties, **kw)[0])


def test_beam_select_route_choice_and_limits(cuda):
    """The routes ``select_plan`` picks on the path (the warp route at the
    bench's beam 15 and at beam 32 with a 32-row window; the wide route for
    the speculative default and over 4 shards at beam 15 and 32; the table
    route for a speculative top_m of 20,000; past the wide route's 2K and
    beams the block and large-n routes) and the shapes a forced route
    refuses; the wide route's hash table as ``wide_table`` sizes it from
    the C size query: 2 ncand entries at the CPU mirror tests' shapes,
    within the shared memory, and none where a CTA would hold more than
    16 beams."""
    plan = beam_select.select_plan
    assert plan(15, 30, 32, 15, False).route == "warp"
    assert plan(32, 64, 32, 32, True).route == "warp"
    for ties in (False, True):
        assert plan(15, 256, 128, 15, ties).route == "wide"
        assert plan(32, 64, 512, 32, ties).route == "wide"
        assert plan(15, 30, 512, 15, ties).route == "wide"
    assert plan(15, 256, 128, 15, False, "block").route == "block"
    assert plan(32, 64, 512, 32, False, "large").route == "large"
    assert plan(40, 80, 32, 40, False).route == "block"  # 40 beams, 2K = 80
    assert plan(64, 128, 512, 64, False).route == "large"  # beam 64 over 4 shards
    assert plan(15, 20000, 128, 15, True).route == "table"
    from seal_tpu_torch.kernels import build

    so = build.lib()
    for n_par, ncand, K in ((15, 386, 15), (32, 578, 32), (15, 1600, 15)):
        for splits in (1, 2, 4):
            table = beam_select.wide_table(n_par, ncand, 2 * K, K, splits)
            least = -(-5 * ncand // 4)
            if table is None:  # too many beams a CTA, or not even the least table fits
                assert so.seal_beam_select_wide_smem(n_par, ncand, 2 * K, K, least,
                                                     splits) > build.SMEM_LIMIT
                continue
            assert least <= table <= 2 * ncand
            assert so.seal_beam_select_wide_smem(n_par, ncand, 2 * K, K, table,
                                                 splits) <= build.SMEM_LIMIT
    assert beam_select.wide_splits(32) == 2 and beam_select.wide_splits(15) == 2
    assert beam_select.wide_splits(8) == 1
    # a load of 1/2 at tests/test_torch_select_routes.py's WIDE_SHAPES
    for n_par, ncand in ((15, 290), (15, 386), (32, 578), (8, 10)):
        splits = beam_select.wide_splits(n_par)
        assert beam_select.wide_table(n_par, ncand, 2 * n_par, n_par, splits) == 2 * ncand
    assert beam_select.wide_table(32, 578, 64, 32, 1) is None  # 32 beams in one CTA
    for shape in ((32, 64, 63, 32), (33, 60, 32, 33), (15, 30, 32, 33)):
        with pytest.raises(ValueError):
            plan(*shape, False, "warp")  # 129 candidates, 33 beams, 2K = 66
    with pytest.raises(ValueError):
        plan(15, 3000, 32, 15, False, "large")  # past SERIAL_MAX a beam
    for shape in ((15, 2100, 32, 15), (33, 256, 128, 33), (15, 256, 128, 33)):
        with pytest.raises(ValueError):
            plan(*shape, False, "wide")  # 2,134 candidates, 33 beams, 2K = 66


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n_buf,n_top", [(3000, 6000), (10000, 20000), (4097, 4100),
                                         (2049, 4100), (10000, 50265)])
def test_beam_merge_table_route_matches_plain(cuda, n_buf, n_top, ties):
    """F1: kernel 8's merge past the chunked route's reach (a buffer past
    4,096, or 2,048 under ties: sampling at top_m 3,000 and 10,000, a
    round-0 and a V-wide loop round) through the device-memory route,
    equal to the plain version bit for bit, with round 0's empty buffer
    too; the chunked route keeps the buffers it can halve (3,000 and 2,049
    without ties)."""
    g = torch.Generator(device=cuda).manual_seed(n_buf + n_top + ties)
    B, K, V = 2, 15, 50265
    lp = _lp(g, B * K, V, cuda)
    top_lp, top_idx = row_topk.row_topk_plain(lp, n_top)
    ok = (torch.rand(B, K, n_top + 1, generator=g, device=cuda) < 0.5)[..., :n_top]
    slab_tok = torch.randint(0, min(3 * n_top, V), (B, K, n_top), generator=g, device=cuda,
                             dtype=torch.int32)
    slab_lp = torch.gather(lp, 1, slab_tok.reshape(B * K, -1).long()).reshape(B, K, n_top)
    slab_ok = torch.rand(B, K, n_top, generator=g, device=cuda) < 0.8
    bt = torch.stack([torch.randperm(V, generator=g, device=cuda)[:n_buf] for _ in range(B * K)])
    blp = torch.gather(lp, 1, bt).reshape(B, K, n_buf)
    buf = (bt.to(torch.int32).reshape(B, K, n_buf), blp,
           (torch.rand(B, K, n_buf, generator=g, device=cuda) < 0.7) & (blp > tc.NEG_INF / 2))
    args = (buf, top_idx.to(torch.int32).reshape(B, K, n_top), top_lp.reshape(B, K, n_top), ok,
            slab_tok, slab_lp, slab_ok, V, n_buf)
    route = beam_select.merge_route(n_buf + 2 * n_top, n_buf, ties)[0]
    assert route == ("chunked" if n_buf <= (2048 if ties else 4096) else "table")
    counter = beam_select.MERGE_TABLE if route == "table" else beam_select.MERGE_LARGE
    n0 = counter.launches
    _same(beam_select.beam_merge(*args, ties=ties), beam_select.beam_merge_plain(*args, ties=ties))
    assert counter.launches == n0 + 1
    none = (None,) + args[1:]
    _same(beam_select.beam_merge(*none, ties=ties),
          beam_select.beam_merge_plain(*none, ties=ties))


@pytest.mark.parametrize("keep_invalid", [False, True])
@pytest.mark.parametrize("n_buf,w", [(2046, 4), (10000, 32), (20000, 128)])
def test_beam_candidates_table_route_matches_plain(cuda, n_buf, w, keep_invalid):
    """F2 in the candidate mode: a beam past SERIAL_MAX candidates takes its
    first instances from the table (sampling's buffer at top_m 10,000; a
    speculative round of 20,000), equal to the plain version bit for bit;
    2,048 candidates (SERIAL_MAX) stay on the serial dedup."""
    args, kw = _select_inputs(cuda, n_buf + keep_invalid, 2, 15, n_buf, w, 50265, n_buf // 2,
                              keep_invalid)
    kw["stop_at_count"] = 1
    n0 = beam_select.CAND_TABLE.launches
    got = beam_select.beam_candidates(*args[:9], **kw)
    assert beam_select.CAND_TABLE.launches == n0 + (n_buf + w + 2 > beam_select.SERIAL_MAX)
    _same(got, beam_select.candidates_plain(*args[:9], **kw))


FAULT_SIZES = {  # the sizes the card refused before F1 and F2
    "sample_ties_top_m_3000": dict(sample=True, seed=3, exact_ties=True, top_m=3000),
    "sample_top_m_10000": dict(sample=True, seed=3, top_m=10000),
    "speculative_top_m_20000": dict(speculative=True, top_m=20000),
}


@pytest.mark.parametrize("mode", sorted(FAULT_SIZES))
def test_fault_sizes_generate_on_card_match_cpu(cuda, mode):
    """F1 and F2 at beam 15 on BART's vocab: a tiny BART with a
    corpus-unigram bias over a Zipf corpus generates on the card, through
    the merge's device-memory route or the selection's table route, with
    hypotheses equal to the port's CPU path (token lists, scores within
    1e-4)."""
    from seal_tpu_torch.bench_generate import _unigram_bias

    V = 50265
    cfg = bart_tiny(vocab_size=V)
    params = bart.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    toks = (rng.zipf(1.3, size=100000) % (V - 4) + 4).astype(np.int64)
    params["final_logits_bias"] = params["final_logits_bias"] + torch.as_tensor(
        _unigram_bias(toks, V), dtype=torch.float32)
    host = FMIndex()
    host.initialize([d.tolist() + [2] for d in np.array_split(toks, 300)])
    queries = [[0] + rng.integers(4, 400, size=6).tolist() + [2] for _ in range(2)]
    kw = dict(num_beams=15, max_length=5, min_length=1, **FAULT_SIZES[mode])
    cpu = tg.fm_index_generate(cfg, params, TorchFMIndex.from_host(host, vocab=V, device="cpu"),
                               queries, **kw)
    m0, t0 = beam_select.MERGE_TABLE.launches, beam_select.ROUTES["table"].launches
    gpu = tg.fm_index_generate(cfg, _to(params, cuda),
                               TorchFMIndex.from_host(host, vocab=V, device=cuda), queries, **kw)
    if mode.startswith("sample"):
        assert beam_select.MERGE_TABLE.launches > m0
    else:
        assert beam_select.ROUTES["table"].launches > t0
    for a, b in zip(cpu, gpu):
        ka, kb = sorted((tuple(t), s) for s, t in a), sorted((tuple(t), s) for s, t in b)
        assert [t for t, _ in ka] == [t for t, _ in kb]
        np.testing.assert_allclose([s for _, s in kb], [s for _, s in ka], atol=1e-4, rtol=0)
    assert any(cpu)


# ---- kernel 1's cooperative search and step mode


_LONG = {}


def _long_block_host():
    """A corpus whose symbol 7 fills more than 2^20 rows: a search over its
    whole block (dir_shift 31 pins no head block) is longer than any of the
    bench's.  Built once a session."""
    if "host" in _LONG:
        return _LONG["host"]
    rng = np.random.default_rng(9)
    toks = np.where(rng.random(1_200_000) < 0.9, 7, rng.integers(4, 30, size=1_200_000))
    host = FMIndex()
    host.initialize([d.tolist() + [2] for d in np.array_split(toks, 40)])
    _LONG["host"] = host
    return host


@pytest.mark.parametrize("group", fm_search.GROUPS)
@pytest.mark.parametrize("corpus,dir_shift", [("zipf", 6), ("zipf", 31), ("long", 31),
                                              ("long", 12)])
def test_fm_search_groups_and_advance_match_plain(cuda, corpus, dir_shift, group):
    """Kernel 1's cooperative search at each group size, at dir_shift values
    that pin a head symbol's block (6, 12) and that do not (31), and over a
    symbol block past 2^20 rows: ``contains`` at the path's [32, 15, 65],
    ``backward_step`` at [32, 15] and the step mode at step 0 and later
    (finished parents, EOS and PAD, out-of-range tokens) equal their plain
    versions exactly."""
    host = _zipf_host() if corpus == "zipf" else _long_block_host()
    V = 40
    t = TorchFMIndex.from_host(host, vocab=V, dir_shift=dir_shift, device=cuda)
    if corpus == "long":
        blo, bhi = (int(x) for x in t.sym_dir[7 + 1, :2])
        assert bhi - blo > 1 << 20
    rng = np.random.default_rng(group + dir_shift)
    B, K = 32, 15
    lo, hi = _ranges(host, rng, n=B * K)
    lo, hi = lo.reshape(B, K), hi.reshape(B, K)
    toks = torch.as_tensor(rng.integers(-2, V + 3, size=(B, K, 65)).astype(np.int32)).cuda()
    toks[..., :20] = 7
    n0 = fm_search.fm_search.launches
    got = fm_search.fm_search(t, "contains", toks, lo, hi, group=group)
    assert fm_search.fm_search.launches == n0 + 1
    assert torch.equal(got, fm_search.contains_plain(t, toks, lo, hi))
    step = toks[..., 0].contiguous()
    got = fm_search.fm_search(t, "backward_step", step, lo, hi, group=group)
    _same(got, fm_search.backward_step_plain(t, step, lo, hi))
    sel_tok = toks[..., 1].contiguous()
    sel_tok[0, :2] = torch.tensor([2, 1])  # EOS, PAD
    finished = torch.as_tensor(rng.random((B, K)) < 0.25).cuda()
    for sel_par, fin in ((torch.zeros((B, K), dtype=torch.int32, device=cuda), None),
                         (torch.as_tensor(rng.integers(0, K, size=(B, K)).astype(np.int32)).cuda(),
                          finished)):
        a0 = fm_search.ADVANCE.launches
        got = fm_search.fm_advance(t, sel_tok, sel_par, lo, hi, fin, eos=2, pad=1, group=group)
        assert fm_search.ADVANCE.launches == a0 + 1
        _same(got, fm_search.advance_plain(t, sel_tok, sel_par, lo, hi, fin, eos=2, pad=1))


def test_fm_search_group_limits(cuda):
    t = TorchFMIndex.from_host(_zipf_host(), vocab=40, device=cuda)
    lo, hi = t.full_range((4,))
    with pytest.raises(ValueError):
        fm_search.fm_search(t, "contains", torch.zeros((4, 3), dtype=torch.int32, device=cuda),
                            lo, hi, group=3)


# ---- kernel 2's window + slab and slab modes, kernel 12's step mode


def _sized_ranges(host, rng, shape, sizes, cuda):
    """Ranges [shape] inside the index: random sub-intervals, and one of
    each row count in ``sizes`` (empty, w, between w and 2w, width, wide)."""
    N = host.size()
    n = int(np.prod(shape))
    lo = rng.integers(0, N, size=n)
    hi = np.minimum(lo + rng.integers(0, N // 8, size=n), N)
    for i, size in enumerate(sizes[:n]):
        size = min(size, N)
        lo[i] = rng.integers(0, N - size + 1)
        hi[i] = lo[i] + size
    lo[-1], hi[-1] = N, N
    return (torch.as_tensor(lo.astype(np.int32), device=cuda).reshape(shape),
            torch.as_tensor(hi.astype(np.int32), device=cuda).reshape(shape))


@pytest.mark.parametrize("shape,w,width", [((32, 15), 32, 64), ((32, 15), 128, 64),
                                           ((32, 15), 32, 1024), ((6, 8), 4, 8), ((6, 8), 8, 4),
                                           ((6, 8), 8, 8), ((3, 2), 33, 100)])
def test_window_slab_modes_match_plain(cuda, shape, w, width):
    """Kernel 2's window + slab mode (one launch: the window, fill PAD, and
    round 0's slab, fill 0), its slab mode at rows_prev 0, one slab width
    on and past the range, and its window mode, each bit-equal to its plain
    version, at the bench shape ([32, 15], w 32, width 64), at beam 32's
    window (128) and at sampling's wide slab; ranges of 0, w, w + 1, 2w -
    1, width and more rows."""
    host = _zipf_host()
    t = TorchFMIndex.from_host(host, vocab=30, device=cuda)  # symbols 30, 31 are OOV
    rng = np.random.default_rng(w + width)
    sizes = [0, 1, w - 1, w, w + 1, 2 * w - 1, 2 * w, width, width + 1, 3 * width]
    lo, hi = _sized_ranges(host, rng, shape, sizes, cuda)
    lp = torch.log_softmax(torch.randn(lo.numel(), 30, device=cuda), -1)
    n0, f0, s0 = (window_gather.window_gather.launches, window_gather.WINDOW_SLAB.launches,
                  window_gather.SLAB.launches)
    got = window_gather.window_slab(t, lo, hi, w, width, lp, 1)
    assert (window_gather.window_gather.launches, window_gather.WINDOW_SLAB.launches) == (
        n0 + 1, f0 + 1)
    want = window_gather.window_slab_plain(t, lo, hi, w, width, lp, 1)
    assert len(got) == len(want) == 6 and got[3].shape == (*shape, width)
    _same(got, want)
    for rows_prev in (0, width, 2 * width + 3):
        got = window_gather.slab_gather(t, lo, hi, rows_prev, width, lp)
        _same(got, window_gather.slab_gather_plain(t, lo, hi, rows_prev, width, lp))
    assert window_gather.SLAB.launches == s0 + 3
    _same(window_gather.window_gather(t, lo, hi, w, lp, 1),
          window_gather.window_gather_plain(t, lo, hi, w, lp, 1))
    assert window_gather.window_gather.launches == n0 + 5


@pytest.mark.parametrize("S", [1, 4])
def test_window_slab_shard_modes_match_plain(cuda, S):
    """The shard mode's window + slab and slab modes at 4 shards (and one):
    one launch a call, the union layout (shard s's slots [s * w, (s + 1) *
    w)) bit-equal to every shard's plain version concatenated."""
    si, _, lo, hi = _sharded(S, cuda)
    V = si.vocab
    B, K = lo.shape[1:]
    lp = torch.log_softmax(torch.randn(B * K, V, device=cuda), -1)
    for w, width in ((4, 8), (8, 4), (32, 64)):
        n0 = window_gather.window_gather_sharded.launches
        f0 = window_gather.WINDOW_SLAB_SHARDED.launches
        got = window_gather.window_slab_sharded(si, lo, hi, w, width, lp, 1)
        assert (window_gather.window_gather_sharded.launches,
                window_gather.WINDOW_SLAB_SHARDED.launches) == (n0 + 1, f0 + 1)
        assert got[0].shape == (B, K, S * w) and got[3].shape == (B, K, S * width)
        _same(got, window_gather.window_slab_sharded_plain(si, lo, hi, w, width, lp, 1))
        s0 = window_gather.SLAB_SHARDED.launches
        got = window_gather.slab_gather_sharded(si, lo, hi, width, width, lp)
        assert window_gather.SLAB_SHARDED.launches == s0 + 1
        _same(got, window_gather.slab_gather_sharded_plain(si, lo, hi, width, width, lp))


@pytest.mark.parametrize("K", [15, 32])
@pytest.mark.parametrize("keep_bwt", [False, True])
def test_wt_advance_matches_plain(cuda, keep_bwt, K):
    """Kernel 12's step mode on the compact and hybrid layouts at BART's
    vocab (4 digits), beam 15 and 32: step 0 (one parent, no stop rule)
    and later (finished parents, EOS, PAD and out-of-range tokens), bit-equal
    to ``advance_plain``, one launch a call; and at 1, 2 and 5 digits."""
    V, B = 50265, 32
    rng = np.random.default_rng(K + keep_bwt)
    zipf = rng.zipf(1.3, size=600 * 120)
    host = FMIndex()
    host.initialize([d.tolist() + [2] for d in (zipf % (V - 10) + 4).reshape(600, 120)])
    cases = [(host, V)] + [(_wt_host(name), WT_CASES[name][0]) for name in ("d1", "d2", "d5")]
    for h, vocab in cases:
        t = WaveletIndex.from_host(h, vocab=vocab, keep_bwt=keep_bwt, device=cuda)
        lo, hi = _ranges(h, rng, n=B * K)
        lo, hi = lo.reshape(B, K), hi.reshape(B, K)
        text = h.text[:-1] - 1
        sel_tok = torch.as_tensor(rng.choice(text, size=(B, K)).astype(np.int32), device=cuda)
        sel_tok[0, :4] = torch.tensor([2, 1, -1, vocab + 2])
        finished = torch.as_tensor(rng.random((B, K)) < 0.25, device=cuda)
        for sel_par, fin in ((torch.zeros((B, K), dtype=torch.int32, device=cuda), None),
                             (torch.as_tensor(rng.integers(0, K, size=(B, K)).astype(np.int32),
                                              device=cuda), finished)):
            n0, a0 = wt_search.wt_search.launches, wt_search.ADVANCE.launches
            got = wt_search.wt_advance(t, sel_tok, sel_par, lo, hi, fin, eos=2, pad=1)
            assert (wt_search.wt_search.launches, wt_search.ADVANCE.launches) == (n0 + 1, a0 + 1)
            want = wt_search.advance_plain(t, sel_tok, sel_par, lo, hi, fin, eos=2, pad=1)
            assert len(got) == 3
            _same(got, want)
            assert (want[1] > want[0]).any()


def test_generate_launches_fused_modes_once_a_step(cuda):
    """A fast decode launches kernel 2 once a step >= 1 on the Psi layout
    (its window + slab mode where a beam needs a proposal round, else the
    window alone; the straggler rounds' slabs besides), and kernel 12's
    step mode once a step on the compact one."""
    cfg = bart_tiny(vocab_size=96)
    params = _to(bart.init_params(cfg, seed=0, device="cpu"), cuda)
    rng = np.random.default_rng(3)
    docs = [rng.integers(4, 14, size=rng.integers(5, 30)).tolist() + [2] for _ in range(30)]
    host = FMIndex()
    host.initialize(docs)
    queries = [[0] + rng.integers(4, 90, size=5).tolist() + [2] for _ in range(3)]
    kw = dict(num_beams=4, max_length=6, min_length=1, window=4, exact_chunk=4,
              forced_bos_token_id=None)
    steps = kw["max_length"] - 1
    n0, f0 = window_gather.window_gather.launches, window_gather.WINDOW_SLAB.launches
    s0 = window_gather.SLAB.launches
    tg.fm_index_generate(cfg, params, TorchFMIndex.from_host(host, vocab=96, device=cuda),
                         queries, **kw)
    redo = tg.LAST_DECODE_STATS["fallback_steps"] > 0
    assert 0 < window_gather.WINDOW_SLAB.launches - f0 <= (steps - 1) * (1 + redo)
    assert window_gather.window_gather.launches - n0 == (
        (steps - 1) * (1 + redo) + window_gather.SLAB.launches - s0)
    a0 = wt_search.ADVANCE.launches
    tg.fm_index_generate(cfg, params, WaveletIndex.from_host(host, vocab=96, device=cuda),
                         queries, **kw)
    redo = tg.LAST_DECODE_STATS["fallback_steps"] > 0
    assert wt_search.ADVANCE.launches - a0 == steps * (1 + redo)


# ------------------------------- kernel 13's modes and kernel 5's groups


def _wt_window_ranges(host, rng, n=48):
    """Random ranges, then full, empty, inverted, (0, 0), end-of-index and
    the sentinel's row."""
    N = host.size()
    lo, hi = _ranges(host, rng, n)
    sentinel = int(np.flatnonzero(np.asarray(host.bwt) == 0)[0])
    extra = [(0, N), (7, 3), (0, 0), (N, N), (sentinel, sentinel + 1), (max(N - 40, 0), N)]
    for i, (a, b) in enumerate(extra):
        lo[3 + i], hi[3 + i] = a, b
    return lo, hi


def _check_modes(t, lo, hi, lp, w, width, rows_prev, graph):
    """Kernel 13's window, window + slab and slab modes at (w, width,
    rows_prev), eagerly or replayed from a CUDA graph, bit-equal to their
    plain versions; one launch each."""
    run = _graph_call if graph else (lambda fn: fn())
    calls = (
        (lambda: wt_window.wt_window_gather(t, lo, hi, w, lp, 1),
         wt_window.wt_window_gather_plain(t, lo, hi, w, lp, 1), None),
        (lambda: wt_window.wt_window_slab(t, lo, hi, w, width, lp, 1),
         wt_window.wt_window_slab_plain(t, lo, hi, w, width, lp, 1), wt_window.WINDOW_SLAB),
        (lambda: wt_window.wt_slab_gather(t, lo, hi, rows_prev, width, lp),
         wt_window.wt_slab_gather_plain(t, lo, hi, rows_prev, width, lp), wt_window.SLAB))
    for fn, want, mode in calls:
        n0, m0 = wt_window.wt_window_gather.launches, mode.launches if mode else 0
        got = run(fn)
        assert wt_window.wt_window_gather.launches - n0 == (2 if graph else 1)
        if mode is not None:
            assert mode.launches - m0 == (2 if graph else 1)
        _same(got, want)
        assert len(got) == len(want)


@pytest.mark.parametrize("graph", [False, True])
@pytest.mark.parametrize("keep_bwt", [False, True])
@pytest.mark.parametrize("name", sorted(WT_CASES))
def test_wt_window_modes_match_plain(cuda, name, keep_bwt, graph):
    """Kernel 13's three modes on the compact and hybrid layouts at 1 to 5
    digits: windows wider and narrower than the slab, of stride 1 and more,
    slabs past rows_prev > 0; empty, inverted, (0, 0), end-of-index and
    sentinel ranges; bit-equal to their plain versions, eagerly and under
    graph capture."""
    host = _wt_host(name)
    vocab = WT_CASES[name][0]
    t = WaveletIndex.from_host(host, vocab=vocab, keep_bwt=keep_bwt, device=cuda)
    lo, hi = _wt_window_ranges(host, np.random.default_rng(len(name) + keep_bwt))
    lp = torch.log_softmax(torch.randn(lo.numel(), vocab, device=cuda), -1)
    for w, width, rows_prev in ((4, 8, 5), (8, 8, 0), (32, 16, 3), (16, 64, 64), (1, 1, 1000),
                                (100, 33, 2)):
        _check_modes(t, lo, hi, lp, w, width, rows_prev, graph)
    # both stride cases and a shared window occurred
    size = (hi - lo).clamp(min=0)
    assert bool((size >= 2 * 32).any()) and bool(((size > 0) & (size < 2 * 8)).any())


@pytest.mark.parametrize("keep_bwt", [False, True])
def test_wt_window_grid_y_limit(cuda, keep_bwt):
    """Widths whose segments pass grid.y's 65,535: the window at 65,535 x 32
    + 40 slots and a slab at 65,535 x 64 + 7 (the direct read's segments
    are 64 slots, the descent's 32), two ranges of the whole index."""
    host = _wt_host("d4")
    vocab = WT_CASES["d4"][0]
    t = WaveletIndex.from_host(host, vocab=vocab, keep_bwt=keep_bwt, device=cuda)
    N = host.size()
    lo = torch.tensor([0, N - 30], dtype=torch.int32, device=cuda)
    hi = torch.tensor([N, N], dtype=torch.int32, device=cuda)
    lp = torch.log_softmax(torch.randn(2, vocab, device=cuda), -1)
    w, width = 65535 * 32 + 40, 65535 * 64 + 7
    _check_modes(t, lo, hi, lp, w, width, 3, graph=False)


def _seq_cases(host_texts, rng, n, L, V, device):
    """n sequences: corpus n-grams (reversed), random and out-of-range ids,
    lengths 0 to L."""
    text = np.concatenate(host_texts)
    starts = rng.integers(0, text.size - L, size=n)
    toks = np.stack([text[s : s + L][::-1] for s in starts]).astype(np.int32)
    toks[: max(n // 8, 1)] = rng.integers(-2, V + 3, size=(max(n // 8, 1), L))
    lens = rng.integers(0, L + 1, size=n).astype(np.int32)
    return torch.as_tensor(toks, device=device), torch.as_tensor(lens, device=device)


def _switch_points(budget, per_seq, P=1):
    """The sequence counts where the host rule changes its group width: the
    last n of each width and the first of the next, and n = 1."""
    ns = {1}
    for G in fm_search.GROUPS[1:]:
        if G * P <= 32:
            n = budget // (per_seq * G)
            ns.update((n, n + 1))
    return sorted(ns)


@pytest.mark.parametrize("graph", [False, True])
@pytest.mark.parametrize("S", [0, 1, 2, 3, 4])
def test_fm_sequences_groups_match_plain(cuda, S, graph):
    """Kernel 5 at every group width its host rule picks, at each switch
    point and at n = 1, monolithic (S = 0) and over 1 to 4 shards in the
    ranges and count modes, and at each width forced; eagerly and under
    graph capture, bit-equal to the plain versions."""
    run = _graph_call if graph else (lambda fn: fn())
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    budget = sms * fm_search.SEQ_LANES_PER_SM
    L, V = 5, 40
    rng = np.random.default_rng(S + 10 * graph)
    if S == 0:
        host = _zipf_host()
        t = TorchFMIndex.from_host(host, vocab=V, device=cuda)
        modes = [(False, 1, 1)]
        texts = [host.text[:-1] - 1]
    else:
        t, hosts, _, _ = _sharded(S, cuda)
        P = 1 << (S - 1).bit_length()
        modes = [(False, P, P), (True, P, P)]
        texts = [h.text[:-1] - 1 for h in hosts]
    seen = set()
    for count, per_seq, P in modes:
        for n in _switch_points(budget, per_seq, P) + [("forced", G) for G in fm_search.GROUPS]:
            group = None
            if isinstance(n, tuple):
                n, group = 48, n[1]
            toks, lens = _seq_cases(texts, rng, n, L, V, cuda)
            if S == 0:
                fn = lambda: fm_search.fm_sequences(t, toks, lens, group=group)  # noqa: E731
                want = fm_search.sequences_plain(t, toks, lens)
                counter = fm_search.fm_sequences
            else:
                fn = lambda: fm_search.fm_sequences_sharded(  # noqa: E731
                    t, toks, lens, count=count, group=group)
                want = fm_search.sequences_sharded_plain(t, toks, lens, count=count)
                counter = fm_search.fm_sequences_sharded
            n0 = counter.launches
            got = run(fn)
            assert counter.launches - n0 == (2 if graph else 1)
            _same(_as_tuple(got), _as_tuple(want))
            seen.add((count, fm_search.sequences_plan(n, sms, max(S, 1), group)))
    assert {G for _, (G, _) in seen} == set(fm_search.GROUPS)


# ------------------------------------ the straggler rounds: support, select


def _support_docs():
    """The Zipf corpus (6 bucket blocks) with ids past the 256 buckets of a
    vocab of 40 (bucket size 1): 300, 301 and 700 go to the dropped column."""
    rng = np.random.default_rng(5)
    toks = (rng.zipf(1.2, size=6000) % 28 + 4).astype(np.int64)
    docs = [d.tolist() for d in np.array_split(toks, 120)]
    docs[3] += [300, 301, 700]
    docs[50] += [300]
    return docs


def _support_host():
    host = FMIndex()
    host.initialize(_support_docs())
    return host


def _support_ranges(host, R, rng, n):
    """Random ranges, then: wider than one bucket block, across one block
    edge, the narrow/wide route boundary (hi - lo equal to the two partial
    blocks' rows, one row either side), inside one block, clamped, empty."""
    N = host.size()
    lo = rng.integers(0, N, size=n)
    hi = np.minimum(lo + rng.integers(0, N // 3, size=n), N)
    special = [(0, N), (R, 2 * R), (R - 1, R + 1), (R + R // 2, 2 * R + 100),
               (R + R // 2 - 1, 2 * R + 100), (R + R // 2 + 1, 2 * R + 100), (3, 3 * R + 5),
               (2 * R + 7, 2 * R + 60), (-7, N + 9), (N, N), (5, 5)]
    for i, (a, b) in enumerate(special):
        lo[i], hi[i] = a, b
    return lo.astype(np.int32), hi.astype(np.int32)


@pytest.mark.parametrize("shape", [(48,), (32, 15)])
def test_bucket_support_matches_plain(cuda, shape):
    """Kernel 6's support mode: one launch, bits equal to the plain version
    and to the counts mode's > 0, at random ranges and at the ranges of
    ``_support_ranges`` (both routes and their boundary), OOV symbols
    dropped; the decoder's [32, 15] shape."""
    host = _support_host()
    t = TorchFMIndex.from_host(host, vocab=40, device=cuda)
    n = int(np.prod(shape))
    lo, hi = _support_ranges(host, t.bucket_rows, np.random.default_rng(n), n)
    lo = torch.as_tensor(lo, device=cuda).reshape(shape)
    hi = torch.as_tensor(hi, device=cuda).reshape(shape)
    n0 = bucket_counts.bucket_support.launches
    got = bucket_counts.bucket_support(t, lo, hi)
    assert bucket_counts.bucket_support.launches == n0 + 1
    assert got.shape == shape + (8,)
    assert torch.equal(got, bucket_counts.bucket_support_plain(t, lo, hi))
    assert torch.equal(got, bucket_counts.pack_support(bucket_counts.bucket_counts(t, lo, hi)))
    assert (got != 0).any() and (got == 0).all(-1).any()


@pytest.mark.parametrize("S", [1, 4])
def test_bucket_support_sharded_routes_match_plain(cuda, S):
    """Kernel 6's shard support mode at ranges wider than a bucket block
    and at the route boundary in every shard: each shard's bits ORed."""
    from seal_tpu_torch.parallel.sharded_index import ShardedTorchIndex

    host = _support_host()
    si = ShardedTorchIndex.build(_support_docs(), S, 40, device=cuda)[0]
    rng = np.random.default_rng(S)
    pairs = [_support_ranges(host, si.bucket_rows, rng, 32) for _ in range(S)]
    lo = torch.as_tensor(np.stack([np.clip(a, -7, si.n_max) for a, _ in pairs]), device=cuda)
    hi = torch.as_tensor(np.stack([np.clip(b, -7, si.n_max) for _, b in pairs]), device=cuda)
    n0 = bucket_counts.bucket_support_sharded.launches
    got = bucket_counts.bucket_support_sharded(si, lo, hi)
    assert bucket_counts.bucket_support_sharded.launches == n0 + 1
    assert torch.equal(got, bucket_counts.bucket_support_sharded_plain(si, lo, hi))


def _round_case(g, cuda, rows, V, bucket_size):
    """A straggler round's inputs at [rows, V]: log-probs with -inf, signed
    zeros and ties; random support words with empty buckets; thresholds
    from the row's own top 64 (round 0's), and NEG_INF, -inf and -0.0."""
    lp = _lp(g, rows, V, cuda)
    n_buckets = (V - 1 + 1) // bucket_size + 1
    counts = (torch.rand(rows, n_buckets, generator=g, device=cuda) < 0.4).int()
    counts[0] = 1
    bits = bucket_counts.pack_support(counts)
    vals, idx = row_topk.row_topk(lp, 64)
    th_lp, th_ix = vals[:, -1].clone(), idx[:, -1].int()
    th_lp[1], th_lp[2], th_lp[3] = tc.NEG_INF, float("-inf"), -0.0
    th_ix[3] = 6
    return lp, bits, th_lp, th_ix


@pytest.mark.parametrize("graph", [False, True])
@pytest.mark.parametrize("k", [256, 20000])
@pytest.mark.parametrize("bucket_size", [197, 256])
def test_pruned_topk_matches_row_topk(cuda, bucket_size, k, graph):
    """The straggler round in one launch: kernel 3's select through the
    pruning loader equals kernel 3 over the eager pruned rows (the parent's
    ``work``) and the plain version, values and indices bit for bit, at
    the path's [480, 50265] with the Psi layout's bucket size (197, a
    multiply) and the wavelet's (256, a shift), at k = 256 and at 20,000
    (the global sort), eager and replayed from a CUDA graph."""
    g = torch.Generator(device=cuda).manual_seed(k + bucket_size)
    lp, bits, th_lp, th_ix = _round_case(g, cuda, 480, 50265, bucket_size)
    args = (lp, bits, th_lp, th_ix, bucket_size, k, tc.NEG_INF)
    work = row_topk.pruned_rows(*args[:5], tc.NEG_INF)
    want = row_topk.row_topk(work, k)
    n0 = row_topk.pruned_topk.launches
    if graph:
        row_topk.pruned_topk(*args)
        torch.cuda.synchronize()
        cg = torch.cuda.CUDAGraph()
        with torch.cuda.graph(cg):
            got = row_topk.pruned_topk(*args)
        cg.replay()
        torch.cuda.synchronize()
    else:
        got = row_topk.pruned_topk(*args)
    assert row_topk.pruned_topk.launches == n0 + 1 + graph
    _same(got, want)
    _same(got, row_topk.pruned_topk_plain(*args))
    assert (work[1] <= tc.NEG_INF).all() and (work[0] > tc.NEG_INF).any()


@pytest.mark.parametrize("layout", ["psi", "compact", "hybrid"])
def test_force_full_generate_on_card_matches_cpu(cuda, layout):
    """A force_full batch (every step through the proven loop, with
    straggler rounds) on each layout gives the CPU path's hypotheses; the
    rounds launch the support mode and the pruning select, and no counts
    mode."""
    cfg = bart_tiny(vocab_size=96)
    params = bart.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(3)
    docs = [rng.integers(4, 18, size=rng.integers(5, 30)).tolist() + [2] for _ in range(30)]
    host = FMIndex()
    host.initialize(docs)
    queries = [[0] + rng.integers(4, 18, size=5).tolist() + [2] for _ in range(3)]
    kw = dict(num_beams=4, max_length=6, min_length=1, window=4, exact_chunk=2,
              exact_loop_chunk=2, force_full=True)

    def index(dev):
        if layout == "psi":
            return TorchFMIndex.from_host(host, vocab=96, device=dev)
        return WaveletIndex.from_host(host, vocab=96, keep_bwt=layout == "hybrid", device=dev)

    support = (bucket_counts.bucket_support if layout == "psi"
               else wt_bucket_counts.wt_bucket_support)
    counts = (bucket_counts.bucket_counts if layout == "psi"
              else wt_bucket_counts.wt_bucket_counts)
    cpu = tg.fm_index_generate(cfg, params, index("cpu"), queries, **kw)
    n0, c0, p0 = support.launches, counts.launches, row_topk.pruned_topk.launches
    gpu = tg.fm_index_generate(cfg, _to(params, cuda), index(cuda), queries, **kw)
    assert support.launches > n0 and row_topk.pruned_topk.launches > p0
    assert counts.launches == c0
    for a, b in zip(cpu, gpu):
        ka, kb = sorted((tuple(t), s) for s, t in a), sorted((tuple(t), s) for s, t in b)
        assert [t for t, _ in ka] == [t for t, _ in kb]
        np.testing.assert_allclose([s for _, s in kb], [s for _, s in ka], atol=1e-4, rtol=0)


# kernel 22 against its plain version: the loss within 2e-6 relative (f32
# log-sum-exps of rows of up to 50,265 terms summed in another order; the
# row losses in f64), ntok exactly, the gradient within 1e-5 of the row's
# largest entry (exp(x - lse) inherits the lse's rounding: a few ulps of an
# lse near 16 are ~4e-6 of a probability near 1)
NLL_RTOL, NLL_GRAD_ATOL = 2e-6, 1e-5


def _nll_case(cuda, n, v, pad_rows, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(n, v, generator=g, device=cuda) * 4
    t = torch.randint(0, v, (n,), generator=g, device=cuda, dtype=torch.int32)
    t[pad_rows] = 1
    return x, t


@pytest.mark.parametrize("graph", [False, True])
@pytest.mark.parametrize("n,v,pads", [
    (1, 97, ()), (5, 50265, (2,)), (7, 64, (0, 6)), (33, 1001, (3,)),
    (6, 50263, (1,)), (4, 50265, (0, 1, 2, 3)), (2, 3, ())])
def test_label_smoothed_nll_matches_plain(cuda, n, v, pads, graph):
    """Kernel 22's forward and backward at V odd and even (at odd V most
    rows start off 16 bytes), N = 1, an all-pad batch and a 3-wide row,
    eager and replayed from a CUDA graph."""
    x, t = _nll_case(cuda, n, v, list(pads), n * v)
    gout = torch.tensor(1.7, device=cuda)
    f0, b0 = train_loss.nll_forward.launches, train_loss.nll_backward.launches

    def run():
        loss, ntok, lse = train_loss.nll_forward(x, t, 1, 0.1)
        return loss, ntok, lse, train_loss.nll_backward(x, t, lse, ntok, gout, 1, 0.1)

    loss, ntok, lse, grad = _graph_call(run) if graph else run()
    torch.cuda.synchronize()
    assert train_loss.nll_forward.launches - f0 == train_loss.nll_backward.launches - b0 \
        == (2 if graph else 1)
    want, want_ntok = train_loss.label_smoothed_nll_plain(x, t, 1, 0.1)
    assert ntok.item() == want_ntok.item() == max(int((t != 1).sum()), 1)
    np.testing.assert_allclose(loss.item(), want.item(), rtol=NLL_RTOL, atol=1e-7)
    want_lse = torch.logsumexp(x, -1)
    want_grad = train_loss.nll_backward_plain(x, t, want_lse, want_ntok, gout, 1, 0.1)
    scale = want_grad.abs().amax(-1, keepdim=True).clamp(min=1e-30)
    assert ((grad - want_grad).abs() / scale).max().item() <= NLL_GRAD_ATOL
    if len(pads) == n:
        assert loss.item() == 0.0 and not grad.any()
    again = train_loss.nll_forward(x, t, 1, 0.1)[0]
    assert again.item() == loss.item()  # no float atomics: the same bits


def test_label_smoothed_nll_limits(cuda):
    """Logits whose base is not 16-byte aligned are refused (the gradient's
    rows share the logits' layout only from an aligned base); so are other
    dtypes and mismatched targets."""
    buf = torch.randn(3 * 97 + 3, device=cuda)
    t = torch.zeros(3, dtype=torch.int32, device=cuda)
    for off in (1, 2, 3):
        x = buf[off : off + 3 * 97].view(3, 97)
        with pytest.raises(ValueError, match="aligned"):
            train_loss.nll_forward(x, t, 1, 0.1)
        with pytest.raises(ValueError, match="aligned"):
            train_loss.nll_backward(x, t, t.float(), t.float()[0], t.float()[0], 1, 0.1)
    with pytest.raises(ValueError, match="f32"):
        train_loss.nll_forward(buf[:3 * 97].view(3, 97).half(), t, 1, 0.1)
    with pytest.raises(ValueError, match="want"):
        train_loss.nll_forward(buf[:3 * 97].view(3, 97), t[:2], 1, 0.1)


def test_label_smoothed_nll_autograd_on_card(cuda):
    """The autograd function's gradient on the card equals autograd of the
    plain version (through the same closed form)."""
    x, t = _nll_case(cuda, 9, 50265, [4], 11)
    xa = x.clone().requires_grad_(True)
    loss, _ = train_loss.LabelSmoothedNLL.apply(xa, t, 1, 0.1)
    (g,) = torch.autograd.grad(loss * 3.0, xa)
    xb = x.clone().requires_grad_(True)
    (gb,) = torch.autograd.grad(train_loss.label_smoothed_nll_plain(xb, t, 1, 0.1)[0] * 3.0, xb)
    assert ((g - gb).abs().max() / gb.abs().max()).item() <= 1e-5


def _param_set(cuda, g, sizes, scale):
    return [torch.randn(sz, generator=g, device=cuda) * scale for sz in sizes]


# many small tensors (LayerNorm rows, biases, 4-wide tails) and one of the
# shared embedding's 51.5M elements
ADAMW_SIZES = [(1024,), (3, 5), (7,), (1, 1), (50265, 1024), (4096, 1024), (1024,), (13,)] + \
    [(1024,)] * 40


@pytest.mark.parametrize("graph", [False, True])
@pytest.mark.parametrize("grad_scale,count", [(1e-5, 3), (1e-2, 3), (1e-5, 0)])
def test_adamw_matches_plain(cuda, grad_scale, count, graph):
    """Kernel 23's norm and update: the norm within 1e-5 relative (sums of
    squares in another order), then one update from the same norm: p, mu
    and nu within 1e-6 relative of the plain version (the same f32
    operations); the norm below max_norm (1e-5 a gradient) and above it;
    count 0 under a warm-up (lr 0: p moves only by nothing)."""
    from seal_tpu_torch.training import trainer

    gen = torch.Generator(device=cuda).manual_seed(count + int(grad_scale * 1e5))
    p = _param_set(cuda, gen, ADAMW_SIZES, 0.02)
    grads = _param_set(cuda, gen, ADAMW_SIZES, grad_scale)
    mu = _param_set(cuda, gen, ADAMW_SIZES, 1e-3)
    nu = [x.abs() for x in _param_set(cuda, gen, ADAMW_SIZES, 1e-6)]
    opt = trainer.make_optimizer(trainer.TrainConfig(learning_rate=1e-3, warmup_steps=2))
    h = opt.hyper(trainer.OptState(count=count, mu=None, nu=None, schedule_count=count))
    assert (h.neg_lr == 0.0) == (count == 0)
    want_norm = adamw.global_norm_plain(grads)
    n0, u0 = adamw.global_norm.launches, adamw.adamw_update.launches
    norm = _graph_call(lambda: adamw.global_norm(grads)) if graph else adamw.global_norm(grads)
    np.testing.assert_allclose(norm.item(), want_norm.item(), rtol=1e-5)
    assert (norm.item() < h.max_norm) == (grad_scale < 1e-3)
    want = [[x.clone() for x in lst] for lst in (p, mu, nu)]
    adamw.adamw_update_plain(*want[:1], grads, *want[1:], norm, h)
    if graph:  # capture on copies, then replay once onto the originals
        got = [[x.clone() for x in lst] for lst in (p, mu, nu)]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            adamw.adamw_update(*[[x.clone() for x in lst] for lst in got[:1]], grads,
                               *[[x.clone() for x in lst] for lst in got[1:]], norm, h)
        torch.cuda.current_stream().wait_stream(side)
        cg = torch.cuda.CUDAGraph()
        with torch.cuda.graph(cg):
            adamw.adamw_update(got[0], grads, got[1], got[2], norm, h)
        for lst, orig in zip(got, (p, mu, nu)):
            for a, b in zip(lst, orig):
                a.copy_(b)
        cg.replay()
    else:
        got = [p, mu, nu]
        adamw.adamw_update(p, grads, mu, nu, norm, h)
    torch.cuda.synchronize()
    assert adamw.global_norm.launches - n0 == adamw.adamw_update.launches - u0 == 1 + graph
    for lst, ref in zip(got, want):
        for a, b in zip(lst, ref):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-12)
    if count == 0:
        for a, b in zip(got[0], want[0]):
            assert torch.equal(a, b)


def test_adamw_limits(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    big = torch.randn(41, generator=gen, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        adamw.global_norm([big[1:]])
    many = [torch.zeros(4, device=cuda) for _ in range(build.lib().seal_adamw_max_tensors() + 1)]
    with pytest.raises(ValueError, match="tensors"):
        adamw.global_norm(many)
    # empty tensors are skipped
    x = torch.ones(8, device=cuda)
    assert adamw.global_norm([torch.zeros(0, device=cuda), x]).item() == pytest.approx(8 ** 0.5)



def test_tied_head_gradient_on_card(cuda):
    """The bf16 head's gradient (``models/common.py:_HeadMM``) against the
    f32 products of the same bf16 operands and the bf16-rounded upstream
    gradient: the hidden state's gradient within one bf16 rounding of its
    f32 sum (2^-8 relative) plus f32 summation order, the table's in f32
    after the bf16 rounding of the cast's gradient."""
    from seal_tpu_torch.models.common import tied_head

    cfg = bart_tiny(vocab_size=1003)
    import dataclasses

    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    gen = torch.Generator(device=cuda).manual_seed(1)
    shared = torch.randn(1003, 32, generator=gen, device=cuda).requires_grad_(True)
    hidden = torch.randn(6, 32, generator=gen, device=cuda).to(torch.bfloat16).requires_grad_(True)
    gout = torch.randn(6, 1003, generator=gen, device=cuda)
    out = tied_head(cfg, shared, hidden)
    assert out.dtype == torch.float32
    gs, gh = torch.autograd.grad((out * gout).sum(), [shared, hidden])
    w = shared.detach().to(torch.bfloat16).float()
    gb = gout.to(torch.bfloat16).float()
    torch.testing.assert_close(gs, (gb.T @ hidden.detach().float()), rtol=2 ** -8, atol=1e-4)
    torch.testing.assert_close(gh.float(), gb @ w, rtol=2 ** -8, atol=1e-4)
    assert gs.dtype == torch.float32 and gh.dtype == torch.bfloat16


def test_train_steps_on_card_match_cpu(cuda):
    """3 train steps of bart_tiny in f32: the card (kernels 22 and 23) and
    the CPU path (their plain versions) from the same params and batches,
    within ``parity``'s tolerances (losses 1e-5 relative, params 1e-5)."""
    from seal_tpu_torch.training import parity

    res = parity.card_against_cpu(cuda)
    assert res["cpu_launches"] == (0, 0) and res["launches"] == (3, 3)
    assert res["ok"], res


def _tiny_files(tmp_path):
    """A tiny word-vocab index (``build_fm_index``) and a bart_tiny HF
    checkpoint directory from a seed."""
    import chip_smoke
    from seal_tpu_torch.cli import build_fm_index
    from seal_tpu_torch.models.tokenizer import WordVocabTokenizer

    with open(tmp_path / "corpus.tsv", "w") as f:
        f.write("".join(f"{i}\t{t}\t{b}\n" for i, t, b in bench_search.TINY_CORPUS))
    idx = str(tmp_path / "idx")
    assert build_fm_index.main([str(tmp_path / "corpus.tsv"), idx, "--include_title",
                                "--train_word_vocab"]) == 0
    tok = WordVocabTokenizer.load(idx + ".word_vocab.json")
    (tmp_path / "hf").mkdir()
    params = bart.init_params(bart_tiny(vocab_size=tok.vocab_size), seed=0, device="cpu")
    torch.save(chip_smoke.port_state_dict(torch, params, "hf"),
               str(tmp_path / "hf" / "pytorch_model.bin"))
    return idx, str(tmp_path / "hf")


@pytest.mark.parametrize("shards", [0, 2])
def test_searcher_load_defaults_to_the_card(cuda, tmp_path, shards):
    """``SEALSearcher.load`` without a device: the index (or its shards) and
    every parameter on the card, and a search runs there."""
    from seal_tpu_torch.retrieval.searcher import SEALSearcher
    from seal_tpu_torch.training.trainer import tree_leaves

    idx, ckpt = _tiny_files(tmp_path)
    s = SEALSearcher.load(idx, ckpt, tokenizer_path=idx + ".word_vocab.json",
                          backbone="tiny-word", beam=4, length=4, batch_size=2,
                          index_shards=shards)
    index = s.sharded_index if shards else s.device_index
    assert index.device.type == "cuda"
    assert all(p.is_cuda for p in tree_leaves(s.params))
    assert len(s.batch_search(bench_search.TINY_QUERIES, k=3)) == len(bench_search.TINY_QUERIES)


def test_tiny_cli_flow_on_card_matches_cpu(cuda, tmp_path):
    """``chip_smoke.tiny_cli_flow``: build, search on the card and with
    ``--device cpu`` (the same documents in the same order), the train CLI
    from ``--init_checkpoint``."""
    import chip_smoke

    chip_smoke.FAILURES.clear()
    res = chip_smoke.tiny_cli_flow(np, torch, str(tmp_path))
    assert not chip_smoke.FAILURES and res["docs"] > 0
