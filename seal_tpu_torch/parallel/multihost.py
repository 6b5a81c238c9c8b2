"""Processes across hosts (counterpart of ``seal_tpu/parallel/multihost.py``).

* ``init_distributed()`` initializes the ``torch.distributed`` process
  group from its arguments or torchrun's variables (``MASTER_ADDR``,
  ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); without a coordinator it is a
  no-op that returns False, as JAX's is.  The backend is NCCL for a process
  with a card of its own (``LOCAL_RANK`` picks it) and gloo on the CPU;
  ranks that share one card pass ``backend="gloo"`` (NCCL refuses two
  ranks on one device).  The group has a finite timeout, so a rank whose
  collectives diverge from the others' raises instead of hanging.
* ``global_mesh(n_model)`` is the mesh over every process
  (``mesh.make_mesh``), with JAX's check that the model axis stays within
  a host.
* ``process_slice(n)`` is this process's contiguous share of a global work
  list, the remainder to the first processes, as JAX's.
* ``host_batch_to_global(mesh, ids, mask)`` all-gathers each rank's
  equal-sized local rows, in rank order, into the global batch that every
  rank then passes to ``fm_index_generate(mesh=)``.
* ``spawn_ranks(fn, n, args)`` runs ``fn(rank, *args)`` in ``n`` spawned
  processes joined by a gloo process group on this host (the ranks may
  share one card), and returns their results in rank order; a rank that
  raises, dies or outlasts the timeout fails the call.

One process without a process group is the degenerate case: rank 0 of 1.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

TIMEOUT_S = 300.0  # a collective that waits longer raises


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist else 0


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist else 1


def local_device(device=None) -> torch.device:
    """This process's device: ``device`` when given (``auto`` and ``cuda``
    mean this process's card), else its card, ``cuda:LOCAL_RANK``; raises
    where no CUDA device exists (``utils.device.checked_device``)."""
    from seal_tpu_torch.utils.device import checked_device

    if device is None or str(device) in ("auto", "cuda"):
        return checked_device(f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")
    return checked_device(device)


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = TIMEOUT_S,
) -> bool:
    """Initialize the process group for processes across hosts.

    ``coordinator_address`` ("host:port") defaults to
    ``MASTER_ADDR:MASTER_PORT``, ``num_processes`` to ``WORLD_SIZE``,
    ``process_id`` to ``RANK``.  Returns True when a process group is (or
    already was) initialized, False for the no-op without a coordinator.
    ``backend`` defaults to ``"nccl"`` where a CUDA device exists (this
    process's card, ``cuda:LOCAL_RANK``, becomes the current device) and
    ``"gloo"`` elsewhere; it is never switched silently.
    """
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        port = os.environ.get("MASTER_PORT", 29500)
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{port}"
    if not coordinator_address:
        return False
    num_processes = int(num_processes if num_processes is not None
                        else os.environ.get("WORLD_SIZE", 1))
    process_id = int(process_id if process_id is not None else os.environ.get("RANK", 0))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_device())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    logger.warning("torch.distributed initialized: process %d/%d, backend %s",
                   process_id, num_processes, backend)
    return True


def global_mesh(n_model: int = 1):
    """One mesh over every process: ``data`` spans hosts, ``model`` must
    stay within one (its collectives never cross hosts), so ``n_model``
    must divide the processes of this host (``LOCAL_WORLD_SIZE``, one card
    each)."""
    from seal_tpu_torch.parallel import mesh as mesh_lib

    n_local = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    if n_model < 1 or n_local % n_model:
        raise ValueError(f"model axis {n_model} must divide the {n_local} processes of this "
                         "host (tensor-parallel collectives must not cross hosts)")
    return mesh_lib.make_mesh(n_model=n_model)


def process_slice(n_items: int) -> Tuple[int, int]:
    """This process's [start, end) slice of a globally-ordered work list
    (contiguous split; remainder spread over the first processes)."""
    p, n = process_index(), process_count()
    base, rem = divmod(n_items, n)
    start = p * base + min(p, rem)
    return start, start + base + (1 if p < rem else 0)


def host_batch_to_global(mesh, ids, mask):
    """The global batch from this rank's local rows: ``ids`` / ``mask``
    [b, L] (this rank's ``process_slice`` of the topics, padded to the
    same [b, L] on every rank) all-gathered over the mesh's ``data`` ranks
    in rank order.  Returns int32 tensors [ranks * b, L] on
    ``mesh.device``, the same on every rank."""
    from seal_tpu_torch.parallel import mesh as mesh_lib

    ids = torch.as_tensor(np.asarray(ids), dtype=torch.int32).to(mesh.device)
    mask = torch.as_tensor(np.asarray(mask), dtype=torch.int32).to(mesh.device)
    if ids.dim() != 2 or ids.shape != mask.shape:
        raise ValueError(f"host_batch_to_global: ids {tuple(ids.shape)} and mask "
                         f"{tuple(mask.shape)} must be one [b, L]")
    shape = torch.tensor(ids.shape, dtype=torch.int64, device=mesh.device)
    lo, hi = mesh_lib.pmax(mesh, -shape.clone()), mesh_lib.pmax(mesh, shape.clone())
    if not torch.equal(-lo, hi):
        raise ValueError(f"host_batch_to_global: the ranks' local batches differ in shape "
                         f"(this rank's {tuple(ids.shape)}); pad them to one [b, L]")
    return mesh_lib.gather_rows(mesh, ids), mesh_lib.gather_rows(mesh, mask)


def _rank_main(rank: int, n: int, port: int, timeout_s: float, fn, args, results):
    import pickle
    import traceback

    import torch.distributed as dist

    try:
        init_distributed(f"127.0.0.1:{port}", n, rank, backend="gloo", timeout_s=timeout_s)
        # pickled by value here: a queue would pass a tensor's storage by a
        # handle that dies with this process
        out = ("ok", pickle.dumps(fn(rank, *args)))
    except BaseException:  # reported to the parent, which fails the call
        out = ("error", traceback.format_exc())
    try:
        if dist.is_initialized():
            dist.destroy_process_group()
    finally:
        results.put((rank, out))


def spawn_ranks(fn, n: int, args=(), timeout_s: float = TIMEOUT_S):
    """``[fn(0, *args), ..., fn(n - 1, *args)]``, each rank in a process of
    its own (``spawn``: safe after CUDA is initialized) joined to the others
    by a gloo process group on ``127.0.0.1`` with a ``timeout_s``
    collective timeout (gloo: NCCL refuses two ranks on one card).
    ``fn`` and ``args`` must pickle (a module-level function); so must each
    result.  Raises ``RuntimeError`` with the rank's traceback when a rank
    raises or exits without a result, and when the ranks outlast ``2 *
    timeout_s``; every process is stopped before it returns."""
    import multiprocessing
    import pickle
    import queue as queue_mod
    import socket
    import time

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, n, port, timeout_s, fn, args, results),
                         daemon=True) for r in range(n)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + 2 * timeout_s
    try:
        while len(got) < n:
            try:
                rank, out = results.get(timeout=1.0)
            except queue_mod.Empty:
                if time.monotonic() > deadline:
                    raise RuntimeError(f"spawn_ranks: ranks {sorted(set(range(n)) - set(got))} "
                                       f"gave no result within {2 * timeout_s:.0f} s")
                dead = [r for r, p in enumerate(procs) if r not in got and p.exitcode is not None]
                if dead and results.empty():
                    time.sleep(1.0)  # a result put just before the exit
                    if results.empty():
                        raise RuntimeError(f"spawn_ranks: rank {dead[0]} exited with code "
                                           f"{procs[dead[0]].exitcode} and no result")
                continue
            if out[0] == "error":
                raise RuntimeError(f"spawn_ranks: rank {rank} failed:\n{out[1]}")
            got[rank] = pickle.loads(out[1])
    finally:
        for p in procs:
            p.join(timeout=10)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(n)]
