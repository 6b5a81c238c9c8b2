"""Constrained generation over the corpus-sharded FM-index (counterpart of
``seal_tpu/parallel/sharded_decode.py``), every shard on one card.

The JAX package runs the whole beam search inside ``shard_map`` over the
mesh's ``data`` axis: each device keeps its shard's ``[lo, hi)`` beam
ranges, and the constraint decisions merge with collectives.  Here the
decoder runs once, its ranges carry a leading shard axis ([S, B, K]), and
each merge is a loop over that axis inside one kernel launch
(:class:`ShardedIndexOps`).  The merges are JAX's: membership ORs over the
shards, counts and range sizes sum, window slots are the union of every
shard's window (shard s in slots [s * w, (s + 1) * w)), and the window is
exhaustive only where every shard's interval fits it.  Keys are grounded
in the union corpus: a key is valid iff it occurs in at least one shard.

Over a mesh (``parallel/mesh.py``), each rank holds a block of the shards
(``ShardedTorchIndex.place``) and runs the decoder on the whole batch, as
each JAX device does; every op launches the same shard mode over the
rank's own shards, and then JAX's merge runs across the ranks as a
collective on the mesh's ``data`` group (``sharded_decode.py:91-148``):
SUM for counts and range sizes, MAX of 0/1 for membership, MIN for the
window's and the interval's coverage, ``all_gather`` for the union window
and slabs (rank r's slots after rank r - 1's, the one-card order) and for
the bit words of the support and count masks (ORed as they arrive).  A
range update keeps each rank's ranges local and sums the parents' sizes.
Every host branch of the decode reads a merged value (``host_any``), so
every rank takes it and issues the same collectives.  Every rank returns
the same hypotheses.
"""

from __future__ import annotations

import torch

from seal_tpu_torch.decoding.generate import fm_index_generate
from seal_tpu_torch.kernels.bucket_counts import bucket_counts_sharded, bucket_support_sharded
from seal_tpu_torch.kernels.fm_search import (
    fm_advance_sharded,
    fm_dense_counts_sharded,
    fm_dense_mask_sharded,
    fm_search_sharded,
    fm_sequences_sharded,
)
from seal_tpu_torch.kernels.window_gather import (
    slab_gather_sharded,
    window_gather_sharded,
    window_slab_sharded,
)
from seal_tpu_torch.parallel import mesh as mesh_lib
from seal_tpu_torch.parallel.sharded_index import ShardedTorchIndex, mesh_of


class ShardedIndexOps:
    """Constraint ops over a :class:`ShardedTorchIndex` with the JAX
    merges (``sharded_decode.py:48-148``); the adapter interface of
    ``decoding.constrained.SingleIndexOps``.  Ranges are [S, ...] (this
    rank's S shards); every merged result drops the shard axis and, on a
    mesh, holds every rank's shards.  ``mesh``: the one the index was
    placed on, or None for an index on one device."""

    def __init__(self, index: ShardedTorchIndex, mesh=None):
        self.index = index
        self.mesh = mesh_of(index, mesh)

    def full_range(self, shape):
        return self.index.full_range(shape)

    def range_for(self, tokens, lengths):
        return fm_sequences_sharded(self.index, tokens, lengths)

    def corpus_mask(self):
        return self.index.corpus_counts > 0  # global counts

    def validate(self, tokens, lo, hi):
        return mesh_lib.psum(self.mesh, fm_search_sharded(self.index, "validate", tokens, lo, hi))

    def contains(self, tokens, lo, hi):
        return mesh_lib.pany(self.mesh, fm_search_sharded(self.index, "contains", tokens, lo, hi))

    def window_gather(self, lo, hi, w, lp, fill):
        return mesh_lib.union_slots(self.mesh,
                                    *window_gather_sharded(self.index, lo, hi, w, lp, fill))

    def window_slab(self, lo, hi, w, width, lp, fill):
        """The union window and the union of round 0's slabs (fill 0), in
        one launch of kernel 2's shard mode (and one gather on a mesh)."""
        return mesh_lib.union_slots(
            self.mesh, *window_slab_sharded(self.index, lo, hi, w, width, lp, fill))

    def slab(self, lo, hi, rows_prev, width, lp):
        return mesh_lib.union_slots(
            self.mesh, *slab_gather_sharded(self.index, lo, hi, rows_prev, width, lp))

    def extend(self, tokens, lo, hi):
        return fm_search_sharded(self.index, "backward_step", tokens, lo, hi)

    def range_size(self, lo, hi):
        return mesh_lib.psum(self.mesh, (hi - lo).sum(0, dtype=torch.int32))

    def advance(self, sel_tok, sel_par, lo, hi, finished=None, *, eos: int, pad: int):
        """The range update after a selection over [S, B, K] ranges: JAX's
        ``extend`` and summed ``range_size`` with the stop rule
        (``constrained.py:1416-1430``; step 0, ``finished`` None,
        :1340-1349), in one launch of kernel 1's shard step mode; on a mesh
        the ranges stay this rank's and the parents' sizes are summed."""
        lo, hi, prev_count = fm_advance_sharded(self.index, sel_tok, sel_par, lo, hi, finished,
                                                eos=eos, pad=pad)
        return lo, hi, mesh_lib.psum(self.mesh, prev_count)

    def window_exhaustive(self, lo, hi, w):
        """True where every shard's interval fits its w window slots (then
        the union window holds the union's whole distinct set)."""
        return mesh_lib.pall(self.mesh, ((hi - lo) <= w).all(0))

    def interval_covered(self, lo, hi, rows_done):
        """True where ``rows_done`` rows a shard enumerate every shard's
        interval."""
        return mesh_lib.pall(self.mesh, ((hi - lo) <= rows_done).all(0))

    def host_any(self, x) -> bool:
        """A decode branch's host read: whether ``x`` holds a true
        element on any rank."""
        return mesh_lib.host_any(self.mesh, x)

    def bucket_counts(self, lo, hi):
        return mesh_lib.psum(self.mesh, bucket_counts_sharded(self.index, lo, hi))

    def bucket_support(self, lo, hi):
        """The support bits of the summed counts: each shard's bits ORed,
        in one launch of kernel 6's support mode over the shards."""
        return mesh_lib.por_bits(self.mesh, bucket_support_sharded(self.index, lo, hi))

    def bucket_size(self):
        return self.index.bucket_size

    def dense_counts(self, lo, hi, chunk):
        return mesh_lib.psum(self.mesh, fm_dense_counts_sharded(self.index, lo, hi, chunk))

    def dense_mask(self, lo, hi, chunk):
        """The count mask of the summed counts: each shard's mask ORed, in
        one launch of kernel 15's mask mode over the shards."""
        return mesh_lib.por_bits(self.mesh, fm_dense_mask_sharded(self.index, lo, hi, chunk))

    @property
    def vocab(self) -> int:
        return self.index.vocab


def sharded_fm_index_generate(model_cfg, params, sharded_index: ShardedTorchIndex, mesh,
                              input_ids, attention_mask=None, **kwargs):
    """``fm_index_generate`` over a sharded index: the same keywords, every
    decode mode included, and the same host ``force_full`` redo of a batch
    whose fast proof failed.  ``mesh``: the one the index was placed on
    (every rank calls this with the same arguments and returns the same
    hypotheses), or ``None`` for an index on one device."""
    if not isinstance(sharded_index, ShardedTorchIndex):
        raise TypeError(f"sharded_fm_index_generate: a ShardedTorchIndex, not "
                        f"{type(sharded_index).__name__}")
    return fm_index_generate(model_cfg, params, sharded_index, input_ids, attention_mask,
                             mesh=mesh_of(sharded_index, mesh), **kwargs)
