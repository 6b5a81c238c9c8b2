"""Numpy mirrors of kernels 6 and 14's support modes on the CPU, against
the JAX package and the port's plain versions (the card runs the kernels
themselves in ``test_torch_cuda.py``).

* Kernel 6 (``csrc/bucket_counts.cu:support_range``): a warp a range reads
  the range's own rows where they are no more than the rows the recount
  would read (the narrow route, their buckets ORed), else the two table
  rows' difference with each bound's rows up to its block's nearer end
  added or subtracted (the wide route; the upper end only where the next
  block is all the index's, or a shard's, own rows: a shard's padding
  holds the sentinel, which its table does not count).  Equal to JAX's
  ``bucket_counts > 0`` on the Psi index with out-of-vocab symbols, and
  over 1-3 shards to ``bucket_counts_sharded_plain > 0``, ranges into the
  padding included, with both routes and both ends of a block taken.
* Kernel 14 (``csrc/wt_bucket_counts.cu:wt_support``): level 0 ranks each
  digit at both bounds (the count between them where both lie in one
  block), level 1 only the non-empty children, each from its block's
  nearer half (``wt_common.cuh:rank_near``); equal to JAX's
  ``wt_ops.bucket_counts > 0`` at 1, 2, 4 and 5 digits on the compact and
  hybrid layouts' arrays.
"""

import numpy as np
import pytest
import torch

from seal_tpu.index import device_index as jdi
from seal_tpu.index.wavelet import WaveletFMIndex
from seal_tpu.ops import fm_ops as jfm
from seal_tpu.ops import wt_ops as jwt
from seal_tpu_torch.index import device_index as tdi
from seal_tpu_torch.index.wavelet import WaveletIndex
from seal_tpu_torch.kernels import bucket_counts as k6
from seal_tpu_torch.kernels import wt_bucket_counts as k14
from seal_tpu_torch.parallel import sharded_index as tsi
from test_torch_fm_ops import _oov_host
from test_torch_wavelet import CASES, _host

# ------------------------------------------------------------- kernel 6


def _support6(bwt, occ, l, h, n_rows, whole, R, bs, nb):
    """One range's 256 support bits and route, as a warp of the kernel
    reads them."""
    l, h = min(max(l, 0), n_rows), min(max(h, 0), n_rows)
    out = np.zeros(256, bool)
    if h <= l:
        return out, "empty"
    blk_l, blk_h = l // R, h // R
    n_l, n_h = l - blk_l * R, h - blk_h * R
    up_l = 2 * n_l > R and (blk_l + 1) * R <= whole
    up_h = 2 * n_h > R and (blk_h + 1) * R <= whole
    a_h, c_h = (h, R - n_h) if up_h else (blk_h * R, n_h)
    a_l, c_l = (l, R - n_l) if up_l else (blk_l * R, n_l)
    if h - l <= c_h + c_l:
        b = bwt[l:h] // bs
        out[b[b < nb]] = True
        return out, "narrow"
    hist = occ[blk_h + up_h].astype(np.int64) - occ[blk_l + up_l]
    for a, c, sign in ((a_h, c_h, -1 if up_h else 1), (a_l, c_l, 1 if up_l else -1)):
        b = bwt[a : a + c] // bs
        np.add.at(hist, b[b < nb], sign)
    out[:nb] = hist > 0
    return out, "wide_up" if (up_l or up_h) else "wide"


def _ranges6(N, R, rng, n=60):
    """Random ranges, narrow ones, and bounds on and around block edges and
    middles (both ends of a block), the last block's, and clamped ones."""
    edges = sorted({e for k in range(N // R + 1)
                    for e in (k * R, k * R + 1, k * R + R // 2, k * R + R // 2 + 1,
                              k * R + R - 1) if 0 <= e <= N} | {N})
    lo = list(rng.integers(0, N, size=n))
    hi = [int(rng.integers(a, N + 1)) for a in lo]
    a = rng.integers(0, N - 60, size=n // 2)
    lo += list(a)
    hi += list(a + rng.integers(0, 60, size=n // 2))
    for x in edges:
        for y in edges:
            if x <= y:
                lo.append(x)
                hi.append(y)
    lo += [-5, 0, N]
    hi += [N + 7, 0, N]
    return np.asarray(lo, np.int32), np.asarray(hi, np.int32)


def test_bucket_support_mirror_matches_jax():
    host = _oov_host()
    j = jdi.DeviceFMIndex.from_host(host, vocab=40)
    t = tdi.TorchFMIndex.from_host(host, vocab=40, device="cpu")
    N, R = host.size(), t.bucket_rows
    lo, hi = _ranges6(N, R, np.random.default_rng(0))
    want = np.asarray(jfm.bucket_counts(j, lo, hi)) > 0
    bwt, occ = t.bwt.numpy(), t.bucket_occ.numpy()
    routes = set()
    for i in range(lo.size):
        got, route = _support6(bwt, occ, int(lo[i]), int(hi[i]), N, N, R, t.bucket_size,
                               t.n_buckets)
        routes.add(route)
        np.testing.assert_array_equal(got[: t.n_buckets], want[i], err_msg=f"range {i} {route}")
    assert routes == {"empty", "narrow", "wide", "wide_up"}
    plain = k6.bucket_support_plain(t, torch.as_tensor(lo), torch.as_tensor(hi))
    np.testing.assert_array_equal(plain.numpy(), k6.pack_support(torch.as_tensor(
        np.array(jfm.bucket_counts(j, lo, hi)))).numpy())


def _shard_docs(seed=3):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(0, 30, size=rng.integers(5, 60)).tolist() for _ in range(150)]
    docs[4] += [300, 700]
    return docs


@pytest.mark.parametrize("S", [1, 2, 3])
def test_bucket_support_sharded_mirror_matches_plain(S):
    si, hosts, _ = tsi.ShardedTorchIndex.build(_shard_docs(), S, 40, device="cpu")
    R, n_max = si.bucket_rows, si.n_max
    rng = np.random.default_rng(S)
    lo = np.stack([_ranges6(n_max, R, rng, n=40)[0][:200] for _ in range(S)])
    hi = np.stack([_ranges6(n_max, R, rng, n=40)[1][:200] for _ in range(S)])
    n = min(lo.shape[1], hi.shape[1])
    lo, hi = lo[:, :n], np.maximum(hi[:, :n], lo[:, :n])
    hi[:, :3] = n_max  # into every shard's padding
    want = (k6.bucket_counts_sharded_plain(si, torch.as_tensor(lo), torch.as_tensor(hi))
            > 0).numpy()
    bwt, occ = si.bwt.numpy(), si.bucket_occ.numpy()
    routes = set()
    for i in range(n):
        got = np.zeros(256, bool)
        for s in range(S):
            bits, route = _support6(bwt[s], occ[s], int(lo[s, i]), int(hi[s, i]), n_max,
                                    int(si.n_rows[s]), R, si.bucket_size, si.n_buckets)
            got |= bits
            routes.add(route)
        np.testing.assert_array_equal(got[: si.n_buckets], want[i], err_msg=f"range {i}")
    assert {"narrow", "wide", "wide_up"} <= routes
    plain = k6.bucket_support_sharded_plain(si, torch.as_tensor(lo), torch.as_tensor(hi))
    np.testing.assert_array_equal(plain.numpy(), k6.pack_support(torch.as_tensor(
        want.astype(np.int32))).numpy())


# ------------------------------------------------------------ kernel 14


def _nibbles(blocks, level, x):
    return ((blocks[level][x >> 8][16:, None] >> (4 * np.arange(8, dtype=np.uint32))) & 15
            ).reshape(-1)


def _count_between(blocks, level, x_blk, wa, wb, d):
    return int(np.count_nonzero(_nibbles(blocks, level, x_blk)[wa:wb] == d))


def _rank_near(blocks, n_rows, level, x, d):
    x = min(max(x, 0), n_rows)
    w = x & 255
    if w > 128 and (x >> 8) + 1 < len(blocks[level]):
        return int(blocks[level][(x >> 8) + 1][d]) - _count_between(blocks, level, x, w, 256, d)
    return int(blocks[level][x >> 8][d]) + _count_between(blocks, level, x, 0, w, d)


def _support14(t, blocks, node_start, node_cnt, lo, hi):
    """One range's support bits as the kernel's warps read them."""
    n_rows, depth = t.n_rows, k14.bucket_digits(t)
    out = np.zeros(256, bool)
    l, h = min(max(lo, 0), n_rows), min(max(hi, 0), n_rows)
    if h <= l:
        return out
    xl, xh = int(node_start[0]) + l, int(node_start[0]) + h
    one = (xl >> 8) == (xh >> 8)
    cnt, clo = [], []
    for d in range(16):
        rl = _rank_near(blocks, n_rows, 0, xl, d)
        c = (_count_between(blocks, 0, xl, xl & 255, xh & 255, d) if one
             else _rank_near(blocks, n_rows, 0, xh, d) - rl)
        cnt.append(c)
        clo.append(rl - int(node_cnt[0][d]))
    if depth == 1:
        out[:16] = np.asarray(cnt) > 0
        return out
    for node in range(16):
        if cnt[node] <= 0:
            continue  # only a non-empty child descends
        xa = int(node_start[1 + node]) + clo[node]
        xb = xa + cnt[node]
        for d in range(16):
            if (xa >> 8) == (xb >> 8):
                got = _count_between(blocks, 1, xa, xa & 255, xb & 255, d)
            else:
                got = (_rank_near(blocks, n_rows, 1, xb, d)
                       - _rank_near(blocks, n_rows, 1, xa, d))
            out[16 * node + d] = got > 0
    return out


@pytest.mark.parametrize("keep_bwt", [False, True], ids=["compact", "hybrid"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_wt_bucket_support_mirror_matches_jax(name, keep_bwt):
    host = _host(name)
    vocab = CASES[name][0]
    j = WaveletFMIndex.from_host(host, vocab=vocab, keep_bwt=keep_bwt)
    t = WaveletIndex.from_host(host, vocab=vocab, keep_bwt=keep_bwt, device="cpu")
    N = host.size()
    rng = np.random.default_rng(len(name) + keep_bwt)
    lo = rng.integers(0, N, size=24)
    hi = np.minimum(lo + rng.integers(0, N // 2 + 2, size=24), N)
    lo = np.minimum(np.concatenate([lo, [0, 5, N, 255, 256, 0]]), N).astype(np.int32)
    hi = np.minimum(np.concatenate([hi, [N, 5, N, 257, 300, 1]]), N).astype(np.int32)
    want = np.asarray(jwt.bucket_counts(j, lo, hi)) > 0
    blocks = t.blocks.numpy().view(np.uint32)
    node_start, node_cnt = t.node_start.numpy(), t.node_cnt.numpy().reshape(-1, 16)
    for i in range(lo.size):
        got = _support14(t, blocks, node_start, node_cnt, int(lo[i]), int(hi[i]))
        np.testing.assert_array_equal(got[: want.shape[-1]], want[i], err_msg=f"range {i}")
        assert not got[want.shape[-1]:].any()
    assert want.any() and not want.all()
