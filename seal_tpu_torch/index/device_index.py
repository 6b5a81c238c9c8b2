"""Device-resident FM-index as torch tensors (counterpart of
``seal_tpu/index/device_index.py``).

The arrays are the ones the JAX ``DeviceFMIndex`` ships, minus ``psi_blk``:
that blocked copy of psi exists only to give the TPU's gather unit a
row-shaped finish for the rank search (``seal_tpu/ops/fm_ops.py:50-58``).
On the GPU the search kernel reads ``psi`` directly.

``bwt`` is stored as int32: torch's uint16 support is thin and BART's 50265
symbols overflow int16.  The numpy builders below are copies of the JAX
module's (which imports jax and so cannot be imported here); the tests hold
them equal to the originals.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from seal_tpu_torch.index.fm_index import FMIndex, SHIFT
from seal_tpu_torch.utils.device import DEFAULT_DEVICE, checked_device, tensor_bytes

BUCKET_ROWS = 1024  # BWT rows per bucket-occ block
N_BUCKETS = 256  # symbol buckets (one coarse wavelet level)
MAX_HEAD_SYMBOLS = 4096  # directory rows safety cap (build-time bound)
DIR_BUDGET_BYTES = 64 << 20  # head directory memory budget


def build_bucket_occ(
    bwt: np.ndarray,
    sigma_global: int,
    bucket_rows: int = BUCKET_ROWS,
    n_buckets: int = N_BUCKETS,
) -> tuple[np.ndarray, int]:
    """Blocked per-bucket rank table over the BWT.

    ``occ[i, b]`` = #rows r < i*bucket_rows whose (shifted) BWT symbol falls
    in bucket b.  Symbols >= ``sigma_global`` route to a dropped pad column
    (they are unproposable).
    """
    bucket_size = max(1, -(-int(sigma_global) // n_buckets))
    n = int(bwt.shape[0])
    n_blocks = -(-n // bucket_rows)
    ids = np.minimum(bwt.astype(np.int64) // bucket_size, n_buckets)
    pad = n_blocks * bucket_rows - n
    if pad:
        ids = np.concatenate([ids, np.full(pad, n_buckets, np.int64)])
    ids = ids.reshape(n_blocks, bucket_rows)
    flat = ids + np.arange(n_blocks, dtype=np.int64)[:, None] * (n_buckets + 1)
    bc = np.bincount(flat.ravel(), minlength=n_blocks * (n_buckets + 1))
    bc = bc.reshape(n_blocks, n_buckets + 1)[:, :n_buckets]
    occ = np.zeros((n_blocks + 1, n_buckets), np.int32)
    occ[1:] = np.cumsum(bc, axis=0).astype(np.int32)
    return occ, bucket_size


def build_head_directory(
    psi: np.ndarray,
    C: np.ndarray,
    n_rows: int,
    dir_shift: int | None = None,
    budget_bytes: int = DIR_BUDGET_BYTES,
) -> tuple[np.ndarray | None, np.ndarray | None, int, int]:
    """Position-blocked Occ directory for frequent ("head") symbols.

    Returns (head_id, head_occ, dir_shift, search_iters).  A symbol whose
    psi block exceeds ``2^dir_shift`` rows gets a directory row that pins a
    rank query to one position block; the shift is chosen to minimise the
    worst-case search depth within ``budget_bytes``.  ``dir_shift`` pins
    the shift explicitly (tests).
    """
    counts = np.diff(C.astype(np.int64))
    max_block = int(counts.max()) if counts.size else 1
    base_iters = max(1, math.ceil(math.log2(max_block + 1)))
    budget_bytes = min(budget_bytes, 64 * n_rows)
    order = np.argsort(counts)[::-1]
    sorted_counts = counts[order]

    def plan(shift: int):
        nb = (n_rows >> shift) + 2
        h_fit = int(budget_bytes // (nb * 8))
        h_all = int((sorted_counts > (1 << shift)).sum())
        h_eff = min(h_all, h_fit, MAX_HEAD_SYMBOLS)
        if h_eff == 0:
            return None
        tail_max = int(sorted_counts[h_eff]) if h_eff < sorted_counts.size else 1
        depth = max(min(1 << shift, max_block), tail_max)
        iters = max(1, math.ceil(math.log2(depth + 1)))
        if iters >= base_iters:
            return None
        return iters, h_eff * nb * 8, h_eff

    if dir_shift is not None:
        choice = plan(dir_shift)
        if choice is None:
            return None, None, 0, base_iters
        shift = dir_shift
    else:
        best = None
        shift = 0
        for s in range(4, max(5, math.ceil(math.log2(max(n_rows, 2))))):
            p = plan(s)
            if p is not None and (best is None or p[:2] < best[:2]):
                best, shift = p, s
        if best is None:
            return None, None, 0, base_iters
        choice = best

    iters, _, h_eff = choice
    head = np.sort(order[:h_eff])
    head_id = np.full(counts.size, -1, np.int32)
    head_id[head] = np.arange(head.size, dtype=np.int32)
    nb = (n_rows >> shift) + 2
    bounds = np.arange(nb, dtype=np.int64) << shift
    head_occ = np.empty((head.size, nb), np.int32)
    for h, c in enumerate(head):
        block = psi[C[c] : C[c + 1]]
        head_occ[h] = np.searchsorted(block, bounds, side="left").astype(np.int32)
    return head_id, head_occ, shift, iters


@dataclasses.dataclass
class TorchFMIndex:
    psi: torch.Tensor  # int32 [N]
    bwt: torch.Tensor  # int32 [N] shifted BWT symbols (sentinel 0)
    C: torch.Tensor  # int32 [sigma+1]
    sym_dir: torch.Tensor  # int32 [sigma, 4]: (C[c], C[c+1], head_id[c], 0)
    # head_pair[h * (nb - 1) + j] = (Occ(c, j<<s), Occ(c, (j+1)<<s)),
    # nb = (N >> dir_shift) + 2; None when no symbol needs a directory
    head_pair: Optional[torch.Tensor]  # int32 [H * (nb - 1), 2]
    bucket_occ: torch.Tensor  # int32 [n_blocks+1, n_buckets]
    corpus_counts: torch.Tensor  # int32 [vocab]
    beginnings: torch.Tensor  # int32 [n_docs+1]

    n_rows: int  # N = tokens + 1
    sigma: int  # shifted alphabet size
    vocab: int  # model vocab size
    n_docs: int
    search_iters: int  # binary-search depth bound of every rank query
    dir_shift: int  # 0 = no head directory
    bucket_rows: int = BUCKET_ROWS
    bucket_size: int = 1
    n_buckets: int = N_BUCKETS
    sa: Optional[torch.Tensor] = None  # int32 [N] suffix array (``keep_sa``)

    @property
    def device(self) -> torch.device:
        return self.psi.device

    def memory_bytes(self) -> int:
        """Device bytes of every array."""
        return tensor_bytes(self)

    @classmethod
    def from_host(
        cls,
        index: FMIndex,
        vocab: int | None = None,
        compact: bool = True,
        keep_sa: bool = False,
        keep_text: bool = False,
        dir_shift: int | None = None,
        device=DEFAULT_DEVICE,
    ) -> "TorchFMIndex":
        """Ship a host-built index to ``device`` (the card unless the caller
        asks for the CPU); refuses >= 2^31 rows.  ``keep_sa`` adds the
        suffix array (+4 B/token) for ``fm_ops.locate_rows``.

        The keywords are JAX's (``DeviceFMIndex.from_host``), in its order,
        with ``device`` after them.  ``compact`` is accepted and changes
        nothing: ``bwt`` stays int32 (JAX stores uint16 where the alphabet
        fits; the kernels here read 32-bit symbols).  ``keep_text`` is
        accepted and ships nothing: JAX keeps the text for device document
        extraction, which the port does on the host, and the port's
        ``bwt_at`` reads ``bwt``, never the text.  Either way every op
        gives JAX's results."""
        device = checked_device(device)
        n_rows = index.size()
        if n_rows >= 2**31:
            raise ValueError("corpora >= 2^31 rows need the sharded index")
        sigma = int(index.C.size - 1)
        if vocab is None:
            vocab = max(sigma - SHIFT, 1)
        counts = np.zeros(vocab, dtype=np.int32)
        occ = np.asarray(index.occurring_distinct)
        keep = occ < vocab
        counts[occ[keep]] = np.asarray(index.occurring_counts, dtype=np.int64)[keep]
        bocc, bucket_size = build_bucket_occ(index.bwt, int(vocab) + SHIFT)
        head_id, head_occ, dshift, iters = build_head_directory(
            np.asarray(index.psi), np.asarray(index.C), n_rows, dir_shift
        )
        C_np = np.asarray(index.C, dtype=np.int32)
        sym_dir = np.zeros((sigma, 4), np.int32)
        sym_dir[:, 0] = C_np[:-1]
        sym_dir[:, 1] = C_np[1:]
        sym_dir[:, 2] = head_id if head_id is not None else -1
        head_pair = None
        if head_occ is not None:
            head_pair = np.stack([head_occ[:, :-1], head_occ[:, 1:]], axis=-1).reshape(-1, 2)

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32)).to(device)

        return cls(
            psi=t(index.psi),
            bwt=t(index.bwt),
            C=t(C_np),
            sym_dir=t(sym_dir),
            head_pair=t(head_pair) if head_pair is not None else None,
            bucket_occ=t(bocc),
            corpus_counts=t(counts),
            beginnings=t(index.beginnings),
            n_rows=n_rows,
            sigma=sigma,
            vocab=int(vocab),
            n_docs=index.n_docs,
            search_iters=iters,
            dir_shift=dshift,
            bucket_size=bucket_size,
            sa=t(index.sa) if keep_sa else None,
        )

    def full_range(self, shape=()) -> tuple[torch.Tensor, torch.Tensor]:
        """The [0, N) row range, broadcast to ``shape``."""
        lo = torch.zeros(shape, dtype=torch.int32, device=self.device)
        hi = torch.full(shape, self.n_rows, dtype=torch.int32, device=self.device)
        return lo, hi
