"""The port's key scoring against ``seal_tpu.scoring.keys``: rescoring
(teacher-forced ``decode_full`` + kernel 7's plain version) within 1e-4,
unigram scores (``decode_full`` + kernel 4's plain version) within 1e-5,
the helpers equal, and the copied ranker ``aggregate_evidence`` identical
to the original on the same keys and host index, with the native C++
ranker and with its Python mirror.  bart_tiny, f32, CPU."""

import jax
import numpy as np
import pytest
import torch

from seal_tpu.index import FMIndex
from seal_tpu.models import bart as jbart
from seal_tpu.models.config import bart_tiny as jtiny
from seal_tpu.scoring import keys as jk
from seal_tpu_torch.kernels import rescore as krescore
from seal_tpu_torch.models import convert as tconvert
from seal_tpu_torch.models.config import bart_tiny as ttiny
from seal_tpu_torch.scoring import keys as tk

V = 120


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jtiny(vocab_size=V), ttiny(vocab_size=V)
    params = jbart.init_params(jax.random.PRNGKey(3), jcfg)
    return jcfg, tcfg, params, tconvert.params_from_jax(jax.device_get(params), tcfg, device="cpu")


def _inputs(rng, n):
    return [[0] + rng.integers(4, V, size=rng.integers(3, 12)).tolist() + [2] for _ in range(n)]


def _keys(rng, n_queries):
    out = []
    for q in range(n_queries):
        keys = []
        for _ in range(int(rng.integers(0, 7))):
            k = rng.integers(4, V, size=rng.integers(1, 6)).tolist()
            if rng.random() < 0.3:
                k = [2] + k  # a bos-side marker to strip
            if rng.random() < 0.3:
                k = k + [7]  # an eos-side marker to strip
            keys.append((float(rng.normal()), k) if rng.random() < 0.5 else k)
        out.append(keys)
    out[0].append([2, 7])  # strips to nothing: scored as the prefix alone
    return out


@pytest.mark.parametrize("prefix,batch_size", [((), 256), ((9,), 256), ((9, 11), 5)])
def test_rescore_keys_matches_jax(models, prefix, batch_size):
    jcfg, tcfg, params, tparams = models
    rng = np.random.default_rng(len(prefix))
    inputs, keys = _inputs(rng, 6), _keys(rng, 6)
    kw = dict(batch_size=batch_size, prefix=prefix, strip_from_bos=[2, 5],
              strip_from_eos=[7], length_penalty=0.5)
    want = jk.rescore_keys(jcfg, params, inputs, keys, **kw)
    got = tk.rescore_keys(tcfg, tparams, inputs, keys, **kw)
    assert sum(len(w) for w in want) > 10
    assert [[k for _, k in w] for w in want] == [[k for _, k in g] for g in got]
    np.testing.assert_allclose([s for g in got for s, _ in g], [s for w in want for s, _ in w],
                               atol=1e-4, rtol=0)
    assert tk.rescore_keys(tcfg, tparams, inputs[:2], [[], []]) == [[], []]


def test_rescore_logprob_plain_matches_jax_formula():
    """Kernel 7's plain version == the JAX reduction (gather, logsumexp,
    zero targets < 2, drop the prefix, sum), with -inf logit columns."""
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(9, 7, 50)) * 3).astype(np.float32)
    logits[..., 1] = -np.inf  # the SEAL bias's -inf columns
    tgt = rng.integers(0, 50, size=(9, 7)).astype(np.int32)
    tgt[:, -2:] = 1  # pad
    for n_prefix in (0, 2):
        tok = np.take_along_axis(logits, tgt[..., None], -1)[..., 0]
        lse = np.asarray(jax.scipy.special.logsumexp(logits, axis=-1))
        want = np.where(tgt < 2, 0.0, tok - lse)[:, n_prefix:].sum(-1)
        got = krescore.rescore_logprob(torch.as_tensor(logits), torch.as_tensor(tgt), n_prefix)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("prefix", [(), (13,)])
def test_unigram_scores_match_jax(models, prefix):
    jcfg, tcfg, params, tparams = models
    inputs = _inputs(np.random.default_rng(5), 4)
    want = np.asarray(jk.compute_unigram_scores(jcfg, params, inputs, prefix=prefix))
    got = tk.compute_unigram_scores(tcfg, tparams, inputs, prefix=prefix, tolist=False)
    assert got.dtype == np.float64 and got.shape == (4, V)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    half = tk.compute_unigram_scores(tcfg, tparams, inputs, prefix=prefix, temperature=2.0)
    np.testing.assert_allclose(np.asarray(half), got / 2.0)


def test_helpers_match_jax():
    keys = [[5, 6], (0.5, [5, 6]), [7], (1.0, [7]), [8, 9, 10], [5, 6]]
    assert tk.deduplicate(keys) == jk.deduplicate(keys)
    for seq in ([2, 2, 5, 6, 7, 7], [2, 7], [], [5]):
        assert tk.strip(seq, [2], [7]) == jk.strip(seq, [2], [7])
    for q in ("eating soup with a fork", " Can you eat soup?! 3 times", "ünïcode wörds 東京 42"):
        assert sorted(tk.decompose_query_into_keys(q, 3)) == sorted(
            jk.decompose_query_into_keys(q, 3))
    seqs = [[1, 2, 3], [4], list(range(10))]
    np.testing.assert_array_equal(tk._pad_to(seqs, 1), jk._pad_to(seqs, 1))


def _corpus(seed):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(4, 60, size=rng.integers(10, 60)).tolist() + [2] for _ in range(80)]
    host = FMIndex()
    host.initialize(docs, labels=[f"d{i}" for i in range(len(docs))])
    text = (host.text[:-1] - 1).tolist()
    keys = []
    for _ in range(40):
        i = int(rng.integers(0, len(text) - 4))
        keys.append((text[i : i + int(rng.integers(1, 4))], float(-rng.random() * 6)))
    keys.append(([59, 58, 57, 56], -1.0))  # absent from the corpus
    uni = (-rng.random(70) * 10).tolist()
    return host, keys, uni


def _canon(results):
    return [(d, float(e[0]), [(tuple(n), s) for n, s in e[1]], list(e[3]),
             (tuple(e[4][0]), e[4][1])) for d, e in results.items()]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("native", [True, False])
def test_aggregate_evidence_copy_is_identical(seed, native, monkeypatch):
    """Same keys, same host index: the same ranked documents, scores,
    matched keys and best keys, bit for bit."""
    from seal_tpu.cpp import native as nat_mod
    from seal_tpu_torch.cpp import native as tnat_mod

    if not native:
        def no_native():
            raise OSError("native ranker disabled for this test")

        # both packages' copies of the native helpers
        monkeypatch.setattr(nat_mod, "load", no_native)
        monkeypatch.setattr(tnat_mod, "load", no_native)
    host, keys, uni = _corpus(seed)
    for kw in (dict(unigram_scores=uni, add_best_unigrams_to_ngrams=True),
               dict(unigram_scores=None, max_occurrences_1=5, n_docs_complete_score=10),
               dict(unigram_scores=uni, sort_by_length=True, single_key=0.3,
                    use_fm_index_frequency=False)):
        want, wall = jk.aggregate_evidence(keys, index=host, **kw)
        got, gall = tk.aggregate_evidence(keys, index=host, **kw)
        assert len(want) > 0
        assert _canon(got) == _canon(want)
        assert gall == wall
