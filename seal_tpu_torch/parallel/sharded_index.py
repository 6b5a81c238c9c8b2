"""Corpus-sharded FM-index with every shard on one card (counterpart of
``seal_tpu/parallel/sharded_index.py``).

Documents are split round-robin into per-shard sub-corpora, each a
complete FM-index of its own.  The JAX package puts one shard on each
device of a mesh and merges with collectives (``psum``); here the shards
are stacked shard-major on one device, and the merge is a loop over the
shard axis inside each kernel (kernels 1, 2, 5, 6 and 15 in their shard
modes, ``kernels/fm_search.py``, ``window_gather.py``, ``bucket_counts.py``).
On one 80 GB card that is the layout for corpora of 2^31 rows and more,
which one int32-indexed index cannot hold.

``round_robin_assignments``, ``shard_path``, ``save_shard_manifest``,
``load_sharded_hosts`` and ``UnionHostIndex`` are copies of the JAX
module's (which imports jax); the tests hold them equal to the originals.
``ShardedTorchIndex`` is the counterpart of ``ShardedFMIndex``: the same
stacked arrays, ``bwt`` as int32 and, as there, no head directory.

Over a mesh (``parallel/mesh.py``: processes on the ``data`` axis), each
rank keeps a contiguous block of the shards on its own device
(``ShardedTorchIndex.place``): rank r of n holds shards [r * S / n,
(r + 1) * S / n), so the union window's slots keep the one-card order.
The kernels' shard modes merge a rank's own shards, and a collective on
the mesh's ``data`` group merges the ranks (``sharded_count_sequences``
and ``sharded_allowed_mask``: a SUM).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from seal_tpu_torch.index.device_index import (
    BUCKET_ROWS,
    N_BUCKETS,
    TorchFMIndex,
    build_bucket_occ,
)
from seal_tpu_torch.index.fm_index import FMIndex, SHIFT
from seal_tpu_torch.kernels.fm_search import fm_search_sharded, fm_sequences_sharded
from seal_tpu_torch.parallel import mesh as mesh_lib
from seal_tpu_torch.utils.device import DEFAULT_DEVICE, checked_device, tensor_bytes

PAD_BEGINNING = 2**30  # fills the beginnings rows of shards with fewer documents


def round_robin_assignments(n_docs: int, n_shards: int) -> List[List[int]]:
    """Global doc ids per shard: doc i lives on shard ``i % n_shards``.

    The single source of truth for shard assignment -- build, disk
    manifests, and load must all agree on it.
    """
    assignments: List[List[int]] = [[] for _ in range(n_shards)]
    for i in range(n_docs):
        assignments[i % n_shards].append(i)
    return assignments


def shard_path(base: str, s: int) -> str:
    return f"{base}.shard{s:03d}"


def save_shard_manifest(base: str, n_shards: int, n_docs: int) -> None:
    """Write ``<base>.manifest.json`` describing a shard-wise index build."""
    with open(base + ".manifest.json", "w") as f:
        json.dump(
            {
                "format": "seal_tpu-sharded-fm-index",
                "version": 1,
                "n_shards": n_shards,
                "n_docs": n_docs,
                "assignment": "round_robin",
            },
            f,
        )


def load_sharded_hosts(base: str):
    """Load per-shard host FMIndexes written by ``build_fm_index --shards``.

    Returns (hosts, assignments, global_labels).  Never materializes the
    monolithic index -- each shard's arrays load independently.
    """
    with open(base + ".manifest.json") as f:
        manifest = json.load(f)
    if manifest.get("assignment") != "round_robin":
        raise ValueError(f"unknown shard assignment {manifest.get('assignment')!r}")
    n_shards = int(manifest["n_shards"])
    hosts = [FMIndex.load(shard_path(base, s)) for s in range(n_shards)]
    n_docs = sum(h.n_docs for h in hosts)
    if n_docs != int(manifest["n_docs"]):
        raise ValueError(
            f"manifest says {manifest['n_docs']} docs, shards hold {n_docs}"
        )
    assignments = round_robin_assignments(n_docs, n_shards)
    for s, h in enumerate(hosts):
        if h.n_docs != len(assignments[s]):
            raise ValueError(f"shard {s}: {h.n_docs} docs != {len(assignments[s])}")
    labels: List[str] | None = [None] * n_docs  # type: ignore[list-item]
    for s, h in enumerate(hosts):
        if h.labels is None:
            labels = None
            break
        for local, g in enumerate(assignments[s]):
            labels[g] = h.labels[local]
    return hosts, assignments, labels


@dataclasses.dataclass
class ShardedTorchIndex:
    """Stacked per-shard index arrays on one device; leading axis = shard.

    Each shard's arrays are zero-padded to the largest shard (``n_max``
    rows); its ranges never reach the padding, since its own ``C`` ends at
    its true row count.  ``C`` repeats each shard's last count past its own
    alphabet, so a symbol a shard lacks gives it an empty range.
    """

    psi: torch.Tensor  # int32 [S, N_max]
    bwt: torch.Tensor  # int32 [S, N_max] shifted BWT symbols (sentinel 0)
    C: torch.Tensor  # int32 [S, sigma+1]
    sym_dir: torch.Tensor  # int32 [S, sigma, 4]: (C[s, c], C[s, c+1], -1, 0)
    n_rows: torch.Tensor  # int32 [S] true rows per shard
    beginnings: torch.Tensor  # int32 [S, D_max+1], padded with 2^30
    n_docs_shard: torch.Tensor  # int32 [S]
    bucket_occ: torch.Tensor  # int32 [S, nb_max+1, n_buckets], one bucket partition
    corpus_counts: torch.Tensor  # int32 [vocab] global step-1 counts

    n_shards: int
    vocab: int
    sigma: int  # shifted alphabet size, shared by every shard
    search_iters: int  # binary-search depth bound over every shard
    n_docs: int
    shard_rows: Tuple[int, ...]  # n_rows on the host
    bucket_rows: int = BUCKET_ROWS
    bucket_size: int = 1
    n_buckets: int = N_BUCKETS
    mesh: object = None  # the mesh this rank's block of shards was placed on
    first_shard: int = 0  # the global index of this block's first shard

    @property
    def device(self) -> torch.device:
        return self.psi.device

    @property
    def n_max(self) -> int:
        """Rows of every shard's padded arrays."""
        return int(self.psi.shape[1])

    def memory_bytes(self) -> int:
        """Device bytes of every array (on a mesh, this rank's)."""
        return tensor_bytes(self)

    def place(self, mesh) -> "ShardedTorchIndex":
        """This rank's block of the shards on ``mesh.device`` (counterpart
        of ``ShardedFMIndex.place``): rank r of the ``data`` axis's n keeps
        shards [r * S / n, (r + 1) * S / n), copied, with the union's
        ``corpus_counts`` and the whole index's padded sizes (``n_max``,
        ``sigma``, ``search_iters``), so that its kernels run as the
        one-card index's do on those shards.  Every rank places the same
        index; S must divide by n.  Nothing of another rank's shards
        reaches this rank's device."""
        if self.mesh is not None:
            raise ValueError("place: the index is already placed on a mesh")
        n, r = mesh.size("data"), mesh.data_rank
        if self.n_shards % n:
            raise ValueError(f"place: {self.n_shards} shards over a data axis of {n} ranks")
        k = self.n_shards // n
        block = slice(r * k, (r + 1) * k)

        def put(t, whole=False):
            return (t if whole else t[block]).to(mesh.device, copy=True).contiguous()

        return dataclasses.replace(
            self, psi=put(self.psi), bwt=put(self.bwt), C=put(self.C),
            sym_dir=put(self.sym_dir), n_rows=put(self.n_rows),
            beginnings=put(self.beginnings), n_docs_shard=put(self.n_docs_shard),
            bucket_occ=put(self.bucket_occ), corpus_counts=put(self.corpus_counts, whole=True),
            n_shards=k, shard_rows=self.shard_rows[block], mesh=mesh, first_shard=r * k,
        )

    @classmethod
    def build(
        cls,
        docs: Sequence[Sequence[int]],
        n_shards: int,
        vocab: int,
        labels: Sequence[str] | None = None,
        device=DEFAULT_DEVICE,
    ) -> Tuple["ShardedTorchIndex", List[FMIndex], List[List[int]]]:
        """Build per-shard host indexes (round-robin docs) and stack them.

        Returns (sharded_index, per-shard host FMIndex list, per-shard
        global-doc-id lists).
        """
        device = checked_device(device)
        assignments = round_robin_assignments(len(docs), n_shards)
        hosts: List[FMIndex] = []
        for s in range(n_shards):
            idx = FMIndex()
            idx.initialize(
                [docs[i] for i in assignments[s]],
                labels=[labels[i] for i in assignments[s]] if labels else None,
            )
            hosts.append(idx)
        return cls.from_hosts(hosts, vocab, device=device), hosts, assignments

    @classmethod
    def from_hosts(cls, hosts: List[FMIndex], vocab: int,
                   device=DEFAULT_DEVICE) -> "ShardedTorchIndex":
        """Stack already-built per-shard host indexes on ``device`` (the card
        unless the caller asks for the CPU): the shard-wise load path, which
        never materializes the monolithic index."""
        device = checked_device(device)
        n_shards = len(hosts)
        if any(h.size() >= 2**31 for h in hosts):
            raise ValueError("a shard of >= 2^31 rows: build the index with more shards")
        n_max = max(h.size() for h in hosts)
        sig_max = max(h.C.size for h in hosts)
        d_max = max(h.n_docs for h in hosts)

        def pad1(a, n, fill=0):
            out = np.full(n, fill, np.int32)
            out[: len(a)] = a
            return out

        bwt = np.stack([pad1(h.bwt, n_max) for h in hosts])
        psi = np.stack([pad1(h.psi, n_max) for h in hosts])
        # repeat each shard's final cumulative count past its own alphabet,
        # so that a symbol the shard lacks yields an empty range
        C = np.stack([pad1(h.C, sig_max) for h in hosts])
        for s, h in enumerate(hosts):
            C[s, h.C.size :] = h.C[-1]
        sym_dir = np.zeros((n_shards, sig_max - 1, 4), np.int32)
        sym_dir[..., 0] = C[:, :-1]
        sym_dir[..., 1] = C[:, 1:]
        sym_dir[..., 2] = -1  # no head directory
        beg = np.stack(
            [pad1(np.asarray(h.beginnings), d_max + 1, fill=PAD_BEGINNING) for h in hosts]
        )

        counts = np.zeros(vocab, np.int64)
        for h in hosts:
            occ = np.asarray(h.occurring_distinct)
            keep = occ < vocab
            counts[occ[keep]] += np.asarray(h.occurring_counts, dtype=np.int64)[keep]

        # per-shard bucket-occ tables on one bucket partition (sized by the
        # model alphabet), padded to the largest block count by repeating
        # the final cumulative row
        occ_tabs, bucket_size = [], 1
        for h in hosts:
            tab, bucket_size = build_bucket_occ(h.bwt, vocab + SHIFT)
            occ_tabs.append(tab)
        nb_max = max(t.shape[0] for t in occ_tabs)
        bucket_occ = np.stack(
            [np.concatenate([t, np.repeat(t[-1:], nb_max - t.shape[0], 0)]) for t in occ_tabs]
        )

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32)).to(device)

        rows = tuple(h.size() for h in hosts)
        return cls(
            psi=t(psi),
            bwt=t(bwt),
            C=t(C),
            sym_dir=t(sym_dir),
            n_rows=t(rows),
            beginnings=t(beg),
            n_docs_shard=t([h.n_docs for h in hosts]),
            bucket_occ=t(bucket_occ),
            corpus_counts=t(np.minimum(counts, 2**31 - 1)),
            n_shards=n_shards,
            vocab=int(vocab),
            sigma=sig_max - 1,
            # rank queries search one symbol block; depth = the largest
            # block across shards
            search_iters=max(
                1,
                math.ceil(math.log2(max(int(np.max(np.diff(h.C))) for h in hosts) + 1)),
            ),
            n_docs=sum(h.n_docs for h in hosts),
            shard_rows=rows,
            bucket_size=bucket_size,
        )

    def _view(self, s: int, n_rows: int, n_docs: int) -> TorchFMIndex:
        return TorchFMIndex(
            psi=self.psi[s],
            bwt=self.bwt[s],
            C=self.C[s],
            sym_dir=self.sym_dir[s],
            head_pair=None,
            bucket_occ=self.bucket_occ[s],
            corpus_counts=self.corpus_counts,
            beginnings=self.beginnings[s],
            n_rows=n_rows,
            sigma=self.sigma,
            vocab=self.vocab,
            n_docs=n_docs,
            search_iters=self.search_iters,
            dir_shift=0,
            bucket_rows=self.bucket_rows,
            bucket_size=self.bucket_size,
            n_buckets=self.n_buckets,
        )

    def shard_view(self, s: int) -> TorchFMIndex:
        """Shard ``s`` as a :class:`TorchFMIndex` (views of the stacked
        arrays, its own row and document counts)."""
        return self._view(s, self.shard_rows[s], int(self.n_docs_shard[s]))

    def block_view(self, s: int) -> TorchFMIndex:
        """Shard ``s`` at the padded sizes, as the JAX package's per-device
        block (``_shard_device_index``): what the plain versions of the
        shard modes run per shard."""
        return self._view(s, self.n_max, int(self.beginnings.shape[1]) - 1)

    def full_range(self, shape=()) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each shard's [0, n_rows[s]) row range, broadcast to [S, *shape]."""
        full = (self.n_shards, *shape)
        lo = torch.zeros(full, dtype=torch.int32, device=self.device)
        hi = self.n_rows.reshape(-1, *([1] * len(shape))).expand(full).contiguous()
        return lo, hi


class UnionHostIndex:
    """Host-side union view over per-shard FMIndexes.

    Presents the subset of the FMIndex API the evidence ranker consumes
    (counts, occurrences, docs, token stats) with global document ids.
    Range values are (0, count) surrogates -- only their difference is
    meaningful, and ``occurrences`` computes per-shard positions itself
    (offset into a disjoint global position space).
    """

    def __init__(self, hosts: List[FMIndex], assignments: List[List[int]],
                 labels: Sequence[str] | None = None):
        self.hosts = hosts
        self.assignments = assignments
        self.labels = list(labels) if labels else None
        self.offsets = np.cumsum([0] + [h.size() for h in hosts])
        total_tokens = sum(len(h) for h in hosts)
        self.beginnings = [0, total_tokens]
        self.n_sentinels = len(hosts)
        self.n_docs = sum(h.n_docs for h in hosts)
        # global doc id -> (shard, local idx)
        self._where = {}
        for s, ids in enumerate(assignments):
            for local, g in enumerate(ids):
                self._where[g] = (s, local)

    def __len__(self):
        return self.beginnings[-1]

    def get_count(self, ngram) -> int:
        return sum(h.get_count(ngram) for h in self.hosts)

    def get_range(self, ngram):
        return 0, self.get_count(ngram)

    def token_count(self, token: int) -> int:
        return sum(h.token_count(token) for h in self.hosts)

    def occurrences(self, ngram, cap: int, rng=None):
        """Occurrence rows in the CANONICAL order (global doc id asc,
        within-doc SA order) -- identical sequence to the monolithic
        ``FMIndex.occurrences`` over the same documents, for any shard
        count: within-doc SA order is corpus-layout-independent (same-doc
        suffix comparisons always resolve inside the doc), each shard
        already returns doc-sorted rows, and a stable global doc sort
        merges them.  This is what makes sharded ranking bit-identical to
        monolithic ranking end-to-end.  Truncation at ``cap`` applies AFTER
        the merge (global first-``cap`` by canonical order); the ranker
        never truncates (rare ngrams have count <= cap), so the monolithic
        SA-order-truncation difference is unreachable there.
        """
        del rng  # surrogate ranges carry no positions; compute per shard
        ends, docs = [], []
        for s, h in enumerate(self.hosts):
            e, d = h.occurrences(ngram, cap)
            if len(e) == 0:
                continue
            ends.append(e + int(self.offsets[s]))
            gmap = np.asarray(self.assignments[s], dtype=np.int64)
            docs.append(gmap[d])
        if not ends:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        ends_a = np.concatenate(ends)
        docs_a = np.concatenate(docs)
        order = np.argsort(docs_a, kind="stable")[:cap]
        return ends_a[order], docs_a[order]

    def get_doc(self, doc_index: int):
        s, local = self._where[doc_index]
        return self.hosts[s].get_doc(local)

    def get_doc_length(self, doc_index: int) -> int:
        s, local = self._where[doc_index]
        return self.hosts[s].get_doc_length(local)


def mesh_of(si: ShardedTorchIndex, mesh):
    """``mesh`` checked against the one ``si`` was placed on: the index
    of one card takes ``None``, a placed block of shards its own mesh
    (a rank's shards alone would give that rank's part of every count)."""
    if mesh is not si.mesh:
        raise ValueError(
            "a sharded index runs on the mesh it was placed on (ShardedTorchIndex.place), "
            f"and an unplaced one with mesh=None; got {mesh!r} for an index placed on "
            f"{si.mesh!r}")
    return mesh


def sharded_count_sequences(si: ShardedTorchIndex, mesh, tokens, lengths, lane: int = 0):
    """Global corpus counts of padded sequences: the per-shard counts,
    summed (kernel 5's shard count mode over this rank's shards, then a
    SUM over the mesh's ranks on collective lane ``lane``).

    tokens: [B, L]; lengths: [B].  Returns int32 [B] global counts.
    ``mesh``: the one ``si`` was placed on, or ``None`` for an index on one
    device.
    """
    return mesh_lib.psum(mesh_of(si, mesh), fm_sequences_sharded(si, tokens, lengths, count=True),
                         lane)


def sharded_allowed_mask(si: ShardedTorchIndex, mesh, tokens, lengths, cand_tokens):
    """Validate candidate continuations against the global (sharded) corpus.

    tokens: [B, L] prefix batch; cand_tokens: [B, M].  Returns [B, M] global
    counts of prefix+candidate (0 = not allowed anywhere): kernel 5's shard
    ranges, then kernel 1's shard count mode, then a SUM over the mesh.
    """
    mesh_of(si, mesh)
    lo, hi = fm_sequences_sharded(si, tokens, lengths)
    cands = torch.as_tensor(np.asarray(cand_tokens), dtype=torch.int32, device=si.device)
    return mesh_lib.psum(mesh, fm_search_sharded(si, "validate", cands, lo, hi))
