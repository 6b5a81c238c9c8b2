"""Compact device FM-index: a 16-ary wavelet tree over the BWT, as torch
tensors (counterpart of ``seal_tpu/index/wavelet.py``).

The layout is the JAX module's (see its docstring):

* ``blocks`` -- [digits, n_blocks, 48] words: per 256 rows of a level,
  words 0..15 count each digit value before the block (the rank
  directory), words 16..47 hold the rows' 4-bit digits, 8 to a word,
  little-endian.  The words are uint32 in JAX; here they are the same bits
  in int32 (torch's uint32 support is thin).  The kernels read them as
  ``uint32_t``; the plain versions widen them to int64.
* ``node_start`` / ``node_cnt`` -- each node's start offset in its level
  sequence and the per-digit ranks at that start, in 16-ary heap order
  (level ``l``'s node ``v`` at ``heap_base(l) + v``).

A symbol rank descends ``digits`` levels (4 symbol bits each); an access
walks the same path reading the stored digits.  ``compact_index`` is this
layout alone (~3.0 B/token at a 16-bit alphabet); ``hybrid_index`` adds the
raw shifted BWT (``bwt``, ``keep_bwt=True``) at the JAX width, 2 bytes a
row when the alphabet fits 16 bits (uint16 values stored as int16 bits)
and 4 otherwise, so the window reads one row instead of descending
(~5.0 B/token).

``from_host`` is a copy of the JAX builder (which imports jax and flax and
so cannot be imported here); the tests hold its arrays equal to the
original's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from seal_tpu_torch.index.fm_index import FMIndex, SHIFT
from seal_tpu_torch.utils.device import DEFAULT_DEVICE, checked_device, tensor_bytes

BUCKET_DEPTH = 8  # bucket id width in BITS for bucket_counts (256 buckets)
DIGIT_BITS = 4  # bits resolved per level (16-ary)
RADIX = 1 << DIGIT_BITS
BLOCK_ROWS = 256
CODE_WORDS = BLOCK_ROWS * DIGIT_BITS // 32  # 32
WORDS_PER_BLOCK = RADIX + CODE_WORDS  # 16 count words + 32 code words


def heap_base(level: int) -> int:
    """Start of level ``level`` in the 16-ary node heap: sum of 16^j, j<level."""
    return ((1 << (DIGIT_BITS * level)) - 1) // (RADIX - 1)


def build_host_arrays(index: FMIndex, vocab: int | None = None, keep_bwt: bool = False):
    """The JAX builder's numpy arrays: (blocks uint32, node_start int64,
    node_cnt int64, C int64, corpus_counts int32, bwt uint16/uint32 or None,
    digits, sigma, vocab)."""
    n = index.size()
    if n >= 2**31:
        raise ValueError("corpora >= 2^31 rows need the sharded index")
    bwt = np.asarray(index.bwt, np.int64)
    sigma = int(index.C.size - 1)
    if vocab is None:
        vocab = max(sigma - SHIFT, 1)
    sigma_bound = max(int(vocab) + SHIFT, sigma, 2)
    bits = math.ceil(math.log2(sigma_bound))
    digits = max(1, -(-bits // DIGIT_BITS))

    n_blocks = (n >> 8) + 1
    blocks = np.zeros((digits, n_blocks, WORDS_PER_BLOCK), np.uint32)
    heap = heap_base(digits)
    node_start = np.zeros(heap, np.int64)
    node_cnt = np.zeros((heap, RADIX), np.int64)

    seq = bwt  # level-l sequence: symbols stably grouped by l-digit prefix
    pad_rows = n_blocks * BLOCK_ROWS - n
    blk_of = np.arange(n) >> 8
    for lvl in range(digits):
        d = ((seq >> (DIGIT_BITS * (digits - 1 - lvl))) & 15).astype(np.uint8)
        # code words: 4-bit values little-endian, 8 rows per word
        dp = np.concatenate([d, np.zeros(pad_rows, np.uint8)])
        bits_mat = np.empty(dp.size * 4, np.uint8)
        for b in range(4):
            bits_mat[b::4] = (dp >> b) & 1
        codes = np.packbits(bits_mat, bitorder="little").view("<u4")
        codes = codes.reshape(n_blocks, CODE_WORDS)
        # cumulative per-digit counts at block starts
        hist = np.bincount(blk_of * RADIX + d, minlength=n_blocks * RADIX)
        hist = hist.reshape(n_blocks, RADIX)
        cum = np.zeros((n_blocks, RADIX), np.int64)
        cum[1:] = np.cumsum(hist, axis=0)[:-1]
        blocks[lvl, :, :RADIX] = cum.astype(np.uint32)
        blocks[lvl, :, RADIX:] = codes
        # node tables: prefix-grouped starts + their per-digit start ranks
        prefix = seq >> (DIGIT_BITS * (digits - lvl))
        n_nodes = 1 << (DIGIT_BITS * lvl)
        counts = np.bincount(prefix, minlength=n_nodes)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        base = heap_base(lvl)
        node_start[base : base + n_nodes] = starts
        nd = np.bincount(prefix * RADIX + d, minlength=n_nodes * RADIX)
        nd = nd.reshape(n_nodes, RADIX)
        node_cnt[base : base + n_nodes, :] = np.cumsum(nd, axis=0) - nd
        # next level: stable regroup by (l+1)-digit prefix
        if lvl + 1 < digits:
            order = np.argsort(seq >> (DIGIT_BITS * (digits - 1 - lvl)), kind="stable")
            seq = seq[order]

    counts_v = np.zeros(vocab, dtype=np.int32)
    occ = np.asarray(index.occurring_distinct)
    keep = occ < vocab
    counts_v[occ[keep]] = np.asarray(index.occurring_counts, dtype=np.int64)[keep]

    C = np.zeros(sigma_bound + 1, np.int64)
    C[: index.C.size] = index.C
    C[index.C.size :] = index.C[-1]

    bwt_out = None
    if keep_bwt:
        bwt_out = np.asarray(index.bwt, np.uint16 if sigma_bound <= 0xFFFF else np.uint32)
    return blocks, node_start, node_cnt, C, counts_v, bwt_out, digits, sigma, int(vocab)


@dataclasses.dataclass
class WaveletIndex:
    blocks: torch.Tensor  # int32 bits of uint32 [digits, n_blocks, 48]
    node_start: torch.Tensor  # int32 [heap]
    node_cnt: torch.Tensor  # int32 [heap, 16]
    C: torch.Tensor  # int32 [sigma_bound+1]
    beginnings: torch.Tensor  # int32 [n_docs+1]
    corpus_counts: torch.Tensor  # int32 [vocab]

    n_rows: int
    digits: int  # 4-bit digits per symbol
    sigma: int  # true corpus alphabet size: the validity gate, as in the Psi layout
    vocab: int
    n_docs: int
    # hybrid layout: the raw shifted BWT, int16 bits of uint16 (alphabet
    # <= 0xFFFF) or int32 [n_rows]; None in the compact layout
    bwt: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    @property
    def n_blocks(self) -> int:
        return int(self.blocks.shape[1])

    def memory_bytes(self) -> int:
        """Device bytes of every array."""
        return tensor_bytes(self)

    def full_range(self, shape=()) -> tuple[torch.Tensor, torch.Tensor]:
        """The [0, N) row range, broadcast to ``shape``."""
        lo = torch.zeros(shape, dtype=torch.int32, device=self.device)
        hi = torch.full(shape, self.n_rows, dtype=torch.int32, device=self.device)
        return lo, hi

    @classmethod
    def from_host(
        cls,
        index: FMIndex,
        vocab: int | None = None,
        keep_bwt: bool = False,
        device=DEFAULT_DEVICE,
    ) -> "WaveletIndex":
        """Build the layout from a host index and ship it to ``device`` (the
        card unless the caller asks for the CPU); refuses >= 2^31 rows.
        ``keep_bwt`` keeps the raw BWT beside it (the hybrid layout)."""
        device = checked_device(device)
        blocks, node_start, node_cnt, C, counts, bwt, digits, sigma, vocab = build_host_arrays(
            index, vocab, keep_bwt
        )

        def t(a, dtype=np.int32):
            return torch.from_numpy(np.ascontiguousarray(a).astype(dtype)).to(device)

        if bwt is not None:
            bwt = torch.from_numpy(bwt.view(np.int16 if bwt.dtype == np.uint16 else np.int32)
                                   .copy()).to(device)
        return cls(
            blocks=torch.from_numpy(blocks.view(np.int32)).to(device),
            node_start=t(node_start),
            node_cnt=t(node_cnt),
            C=t(C),
            beginnings=t(index.beginnings),
            corpus_counts=t(counts),
            bwt=bwt,
            n_rows=index.size(),
            digits=digits,
            sigma=sigma,
            vocab=vocab,
            n_docs=index.n_docs,
        )
