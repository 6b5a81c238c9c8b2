"""The port's kernels on the card against their plain versions, and the
port's generation and searcher on the card against their CPU paths.
Needs a CUDA device and skips without one; imports no jax, so it runs
where the card is:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest configures jax.)"""

import numpy as np
import pytest
import torch

from seal_tpu.index import FMIndex
from seal_tpu_torch.decoding import constrained as tc
from seal_tpu_torch.decoding import generate as tg
from seal_tpu_torch.index.device_index import TorchFMIndex
from seal_tpu_torch import bench_search
from seal_tpu_torch.kernels import (
    bucket_counts,
    fm_search,
    rescore,
    row_topk,
    triton_logsoftmax,
    window_gather,
)
from seal_tpu_torch.models import bart
from seal_tpu_torch.models.config import bart_tiny

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


@pytest.mark.parametrize("n,k", [(50265, 30), (50265, 64), (50265, 256), (960, 30), (158, 30),
                                 (70000, 16)])
def test_row_topk_matches_plain(cuda, n, k):
    rng = np.random.default_rng(n)
    x = np.round(rng.normal(0, 2, size=(6, n)), 1).astype(np.float32)  # ties, +-0.0
    x[1] = -np.inf
    x[2, : n // 3] = 7.5
    x[3, n - 5 :] = 50.0
    x = torch.as_tensor(x).cuda()
    gv, gi = row_topk.row_topk(x, k)
    wv, wi = row_topk.row_topk_plain(x, k)
    assert torch.equal(gi, wi)
    assert torch.equal(gv.view(torch.int32), wv.view(torch.int32))  # bit-exact, signs too


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
    params = bart.init_params(cfg, seed=0)
    rng = np.random.default_rng(seed)
    docs = [rng.integers(4, 90, size=rng.integers(5, 30)).tolist() + [2] for _ in range(30)]
    host = FMIndex()
    host.initialize(docs)
    queries = [[0] + rng.integers(4, 90, size=5).tolist() + [2] for _ in range(3)]
    kw = dict(num_beams=4, max_length=6, min_length=1, window=4, exact_chunk=4)
    cpu = tg.fm_index_generate(cfg, params, TorchFMIndex.from_host(host, vocab=96), queries, **kw)
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
