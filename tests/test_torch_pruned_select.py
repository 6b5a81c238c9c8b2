"""The straggler round's pruned select on the CPU, against ``seal_tpu``.

A later round of the proven proposal loop ranks the log-probs of the tokens
whose symbol bucket has a row in the beam's interval and that the consumed
(lp, token) threshold has not examined
(``seal_tpu/decoding/constrained.py:604-608, 734-736``).  The port reads the
buckets as 8 support words a beam (kernels 6 and 14's support modes) and
computes the pruned row as kernel 3's select stages the log-probs
(``row_topk.pruned_topk``).  Its plain version equals JAX's composition --
the bucket gather ``> 0``, the ``NEG_INF`` prune, the consumed mask and
``lax.top_k`` -- bit for bit, values and indices, on rows with -inf
log-probs, signed zeros, ties and ``NEG_INF`` / -inf thresholds, for a
bucket size that is a power of two (the wavelet layouts) and one that is
not (the Psi layout's ceil(sigma / 256))."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from seal_tpu.decoding import constrained as jc
from seal_tpu_torch.decoding import constrained as tc
from seal_tpu_torch.index.fm_index import SHIFT
from seal_tpu_torch.kernels import bucket_counts, row_topk

# (vocab, bucket size): the Psi layout's ceil(sigma / 256) at BART's vocab,
# a small odd size, powers of two (wavelet: 16^(digits - 2)) and size 1
SHAPES = {"psi_bart": (50265, 197), "odd": (301, 3), "pow2": (1000, 4), "pow2_wide": (4095, 16),
          "one": (255, 1)}


def _case(V, bucket_size, rows=7, seed=0):
    """Log-probs with -inf entries, signed zeros and ties; bucket counts with
    empty buckets; and one threshold a row: a row's own value and token, a
    tie, NEG_INF, -inf, -0.0 and a value above the row."""
    rng = np.random.default_rng(seed + V)
    lp = np.round(rng.normal(-6, 2, size=(rows, V)) * 4) / 4
    lp[rng.random((rows, V)) < 0.05] = -np.inf
    lp[:, :6] = [0.0, -0.0, -0.0, 0.0, -np.inf, -0.0]
    lp = lp.astype(np.float32)
    n_buckets = (V - 1 + SHIFT) // bucket_size + 1
    counts = rng.integers(0, 3, size=(rows, n_buckets)) * (rng.random((rows, n_buckets)) < 0.6)
    counts[0] = 1  # every bucket allowed
    counts[1] = 0  # none
    th_lp = np.empty(rows, np.float32)
    th_ix = rng.integers(0, V, size=rows).astype(np.int32)
    th_lp[0] = lp[0, th_ix[0]]
    th_lp[1] = lp[1, th_ix[1]]
    th_lp[2] = jc.NEG_INF
    th_lp[3] = -np.inf
    th_lp[4] = -0.0
    th_ix[4] = 2
    th_lp[5] = 1.0  # above every value: nothing consumed
    th_lp[6] = np.sort(lp[6])[-V // 3]  # a third consumed, ties at the threshold
    return lp, counts.astype(np.int32), th_lp, th_ix


def _jax_round(lp, counts, th_lp, th_ix, bucket_size, k):
    """The JAX loop body's pruning and select (:604-608, :734-736)."""
    V = lp.shape[-1]
    v_idx = jnp.arange(V, dtype=jnp.int32)
    v_bucket = (v_idx + SHIFT) // bucket_size
    support = jnp.take(jnp.asarray(counts), v_bucket, axis=-1) > 0
    base = jnp.where(support, jnp.asarray(lp), jc.NEG_INF)
    th, ix = jnp.asarray(th_lp)[:, None], jnp.asarray(th_ix)[:, None]
    consumed = (base > th) | ((base == th) & (v_idx <= ix))
    return lax.top_k(jnp.where(consumed, jc.NEG_INF, base), k)


@pytest.mark.parametrize("k", [1, 64, "V"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_pruned_topk_plain_matches_jax(shape, k):
    V, bucket_size = SHAPES[shape]
    k = V if k == "V" else k
    lp, counts, th_lp, th_ix = _case(V, bucket_size)
    want_v, want_i = _jax_round(lp, counts, th_lp, th_ix, bucket_size, k)
    bits = bucket_counts.pack_support(torch.as_tensor(counts))
    args = (torch.as_tensor(lp), bits, torch.as_tensor(th_lp), torch.as_tensor(th_ix),
            bucket_size, k, tc.NEG_INF)
    before = row_topk.pruned_topk.launches
    for vals, idx in (row_topk.pruned_topk(*args), row_topk.pruned_topk_plain(*args)):
        np.testing.assert_array_equal(vals.view(torch.int32).numpy(),
                                      np.asarray(want_v).view(np.int32))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
        assert idx.dtype == torch.int64
    assert row_topk.pruned_topk.launches == before  # CPU: the plain version
    # every branch taken: pruned, consumed and kept values in the rows
    rows = row_topk.pruned_rows(*args[:5], tc.NEG_INF).numpy()
    assert (rows[0] > jc.NEG_INF).any() and (rows[1] == jc.NEG_INF).all()
    assert (rows[5] == -np.inf).any() and (rows == jc.NEG_INF).any()


def test_pruned_topk_refuses_bad_shapes():
    lp = torch.zeros((3, 300))
    bits = torch.zeros((3, 8), dtype=torch.int32)
    th = torch.zeros(3)
    ix = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="bucket size"):
        row_topk.pruned_topk(lp, bits, th, ix, 1, 4, tc.NEG_INF)  # 300 buckets
    with pytest.raises(ValueError, match="k="):
        row_topk.pruned_topk(lp, bits, th, ix, 2, 301, tc.NEG_INF)
    with pytest.raises(ValueError, match="bits"):
        row_topk.pruned_topk(lp, bits[:, :4], th, ix, 2, 4, tc.NEG_INF)


def test_pack_support_matches_counts():
    """The support words: bit b of the 256 set iff count b > 0, the bits
    past the counts' width 0 (16 wavelet buckets at one digit)."""
    rng = np.random.default_rng(3)
    for n in (16, 197, 256):
        counts = rng.integers(0, 2, size=(5, n)).astype(np.int32)
        bits = bucket_counts.pack_support(torch.as_tensor(counts)).numpy()
        assert bits.shape == (5, 8) and bits.dtype == np.int32
        unpacked = (bits.view(np.uint32)[..., None] >> np.arange(32, dtype=np.uint32)) & 1
        unpacked = unpacked.reshape(5, 256).astype(bool)
        np.testing.assert_array_equal(unpacked[:, :n], counts > 0)
        assert not unpacked[:, n:].any()
    with pytest.raises(ValueError, match="257 buckets"):
        bucket_counts.pack_support(torch.zeros((1, 257), dtype=torch.int32))
