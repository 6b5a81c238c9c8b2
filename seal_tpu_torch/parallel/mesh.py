"""The mesh over processes and its merges (counterpart of
``seal_tpu/parallel/mesh.py:25-36, 92-96``).

The JAX package's mesh has two axes: ``data`` shards the queries and the
corpus shards of the FM-index, ``model`` is Megatron tensor parallelism.
Here a process drives one device, and the mesh is the initialized
``torch.distributed`` process group laid out as ``("data", "model")``.
Only the ``data`` axis is ported: ``n_model > 1`` raises
``NotImplementedError`` (ROADMAP.md A.7b, with ``param_pspecs`` and
``shard_params``).

JAX merges with XLA collectives inside ``shard_map`` (``psum``); the port
merges with ``torch.distributed`` collectives on the mesh's ``data``
group, after each rank's kernels have merged its own shards.  The helpers
use only SUM, MAX, MIN and ``all_gather``, which NCCL and gloo both have
(NCCL has no bitwise reductions, so an OR of bit words is a gather and a
fold).  On a mesh of one rank, or with no mesh, every helper is the
identity.

A process group runs its collectives in the order they are issued, and
every rank must issue the same ones in the same order.  Two threads that
both issue collectives (the searcher's key producer and its ranker) take
one *lane* each: the mesh holds ``LANES`` groups over the same ranks,
and lane ``i``'s collectives never interleave with another lane's.

``Mesh.stats`` counts every collective a helper issues by kind; with
``Mesh.timed`` set, each helper also synchronizes the device around its
collective and adds the seconds (``Mesh.seconds``): what a decode step
spends merging.
"""

from __future__ import annotations

import collections
import time
from typing import Optional

import torch

AXES = ("data", "model")
LANES = 2  # collective lanes: the searcher's key producer's and its ranker's
MODEL_AXIS = ("the mesh's model axis (tensor parallelism) is not ported to seal_tpu_torch yet "
              "(ROADMAP.md A.7b)")


class Mesh:
    """The ``("data", "model")`` layout of the process group, this rank's
    place in it and the device its tensors live on.

    ``shape``: {"data": n_data, "model": n_model}; ``data_rank``: this
    rank's coordinate on the ``data`` axis (shard blocks and batch rows
    are taken in that order); ``device``: this rank's ``torch.device``.
    """

    axis_names = AXES

    def __init__(self, n_data: int, n_model: int, data_rank: int, device, groups=()):
        self.shape = {"data": n_data, "model": n_model}
        self.data_rank = data_rank
        self.device = torch.device(device)
        self._groups = tuple(groups)  # the data axis's lanes; () on one rank
        self.stats = collections.Counter()
        self.timed = False
        self.seconds = 0.0

    def size(self, axis: str = "data") -> int:
        return self.shape[axis]

    def get_group(self, axis: str = "data", lane: int = 0):
        """The process group of ``axis``'s ranks for lane ``lane`` (None on
        a mesh of one rank)."""
        if axis != "data":
            raise NotImplementedError(MODEL_AXIS)
        return self._groups[lane] if self._groups else None

    @property
    def lanes(self) -> int:
        return len(self._groups)

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, model={self.shape['model']}, "
                f"data_rank={self.data_rank}, device={self.device})")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device=None) -> Mesh:
    """A mesh over every rank of the initialized process group (one rank
    when none is initialized).  ``n_data`` defaults to the ranks over
    ``n_model``; ``device`` to the card of this process
    (``multihost.local_device``).  Every rank calls it, in the same order
    as its other group calls: each of the ``LANES`` lanes is a
    ``new_group`` over the ranks."""
    import torch.distributed as dist

    from seal_tpu_torch.parallel.multihost import local_device, process_count, process_index

    if n_model > 1:
        raise NotImplementedError(MODEL_AXIS)
    world = process_count()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh ({n_data}, {n_model}) over {world} ranks")
    device = local_device() if device is None else torch.device(device)
    groups = []
    if world > 1:
        groups = [dist.new_group(list(range(world))) for _ in range(LANES)]
    return Mesh(n_data, n_model, process_index(), device, groups)


# ------------------------------------------------------------------ merges


def _active(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.size("data") > 1


class _collective:
    """Counts a helper's collective on ``mesh.stats`` and, with
    ``mesh.timed``, adds its wall seconds, the device synchronized around
    it."""

    def __init__(self, mesh: Mesh, kind: str):
        self.mesh, self.kind = mesh, kind

    def __enter__(self):
        self.mesh.stats[self.kind] += 1
        if self.mesh.timed:
            if self.mesh.device.type == "cuda":
                torch.cuda.synchronize(self.mesh.device)
            self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if self.mesh.timed and exc[0] is None:
            if self.mesh.device.type == "cuda":
                torch.cuda.synchronize(self.mesh.device)
            self.mesh.seconds += time.perf_counter() - self.t0


def _reduce(mesh, x, op: str, lane: int):
    import torch.distributed as dist

    with _collective(mesh, op):
        dist.all_reduce(x, op=getattr(dist.ReduceOp, op), group=mesh.get_group(lane=lane))
    return x


def psum(mesh: Optional[Mesh], x, lane: int = 0):
    """``x`` summed over the ``data`` ranks (in place; ``x`` is returned)."""
    return _reduce(mesh, x, "SUM", lane) if _active(mesh) else x


def pmax(mesh: Optional[Mesh], x, lane: int = 0):
    """``x``'s elementwise largest over the ``data`` ranks (in place)."""
    return _reduce(mesh, x, "MAX", lane) if _active(mesh) else x


def pany(mesh: Optional[Mesh], x, lane: int = 0):
    """bool ``x`` ORed over the ``data`` ranks: a MAX of 0/1."""
    if not _active(mesh):
        return x
    return _reduce(mesh, x.to(torch.int32), "MAX", lane) > 0


def pall(mesh: Optional[Mesh], x, lane: int = 0):
    """bool ``x`` ANDed over the ``data`` ranks: a MIN of 0/1."""
    if not _active(mesh):
        return x
    return _reduce(mesh, x.to(torch.int32), "MIN", lane) > 0


def host_any(mesh: Optional[Mesh], x, lane: int = 0) -> bool:
    """Whether any element of ``x`` is true on any ``data`` rank: the one
    host read a decode branch takes, the same on every rank."""
    flag = x.any().reshape(1)
    return bool(pany(mesh, flag, lane).item())


def _gather(mesh: Mesh, x, lane: int):
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(mesh.size("data"))]
    with _collective(mesh, "all_gather"):
        dist.all_gather(parts, x.contiguous(), group=mesh.get_group(lane=lane))
    return parts


def por_bits(mesh: Optional[Mesh], words, lane: int = 0):
    """int32 bit words ORed over the ``data`` ranks: every rank's words
    gathered, then folded with ``bitwise_or`` (NCCL has no OR)."""
    if not _active(mesh):
        return words
    parts = _gather(mesh, words, lane)
    out = parts[0]
    for p in parts[1:]:
        out = out | p
    return out


def _as_i32(x):
    if x.dtype == torch.bool:
        return x.to(torch.int32)
    if x.dtype in (torch.int32, torch.float32):
        return x.view(torch.int32)
    raise TypeError(f"union_slots: int32, float32 or bool slots, not {x.dtype}")


def _from_i32(x, dtype):
    if dtype == torch.bool:
        return x != 0
    return x.view(dtype)


def union_slots(mesh: Optional[Mesh], *xs, lane: int = 0):
    """The union of every rank's window slots: each ``x`` is [..., n] (this
    rank's shards' slots, shard-major), and comes back [..., ranks * n]
    with rank r's slots at [r * n, (r + 1) * n), which is the global shard
    order when rank r holds the r-th block of shards.  All the tensors
    (int32, float32 or bool, one leading shape) travel in one
    ``all_gather`` as int32 words.  Returns a tuple."""
    if not _active(mesh):
        return xs
    lead = xs[0].shape[:-1]
    widths = [x.shape[-1] for x in xs]
    packed = torch.cat([_as_i32(x).reshape(-1, w) for x, w in zip(xs, widths)], -1)
    parts = [p.split(widths, -1) for p in _gather(mesh, packed, lane)]
    return tuple(
        _from_i32(torch.cat([p[i] for p in parts], -1), x.dtype).reshape(*lead, -1)
        for i, x in enumerate(xs))


def gather_rows(mesh: Optional[Mesh], x, lane: int = 0):
    """Every ``data`` rank's ``x`` (one shape on every rank) concatenated
    along axis 0 in rank order."""
    if not _active(mesh):
        return x
    return torch.cat(_gather(mesh, x, lane), 0)


def gather_objects(mesh: Optional[Mesh], obj, lane: int = 0) -> list:
    """Every ``data`` rank's ``obj`` in rank order (``all_gather_object``)."""
    if not _active(mesh):
        return [obj]
    import torch.distributed as dist

    out = [None] * mesh.size("data")
    with _collective(mesh, "all_gather_object"):
        dist.all_gather_object(out, obj, group=mesh.get_group(lane=lane))
    return out
