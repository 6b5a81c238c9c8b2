"""Tracing, the phase timer and the serving counters of the searcher.

The port's counterpart of ``seal_tpu/utils/profiling.py``: ``PhaseTimer``
and ``ServingMetrics`` are copies; ``device_trace`` captures a
``torch.profiler`` trace where the JAX module starts ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, Optional

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """Capture a profile of the block into ``log_dir`` as a Chrome trace
    (``trace_<pid>.json``: the host's ops, and the card's kernels where a
    CUDA device exists); a no-op when ``log_dir`` is None or empty."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        path = os.path.join(log_dir, f"trace_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        logger.warning("device trace written to %s", path)


class PhaseTimer:
    """Accumulates wall time per named phase; prints a summary on demand."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        parts = [
            f"{name}={self.totals[name]:.2f}s/{self.counts[name]}x"
            for name in sorted(self.totals, key=lambda n: -self.totals[n])
        ]
        return " ".join(parts)

    def log_summary(self):
        if self.enabled and self.totals:
            logger.warning("phase timings: %s", self.summary())


class ServingMetrics:
    """Cumulative serving-time counters.

    The reference exposes nothing beyond tqdm bars and RSS deltas
    (``retrieval.py:552-558``); production serving wants a live
    throughput readout.  The searcher updates these per ``batch_search``;
    ``snapshot()`` returns totals plus derived rates.
    """

    def __init__(self):
        self.reset()

    def reset(self):
        self.queries = 0
        self.batches = 0
        self.keys_generated = 0
        self.docs_returned = 0
        self.wall_s = 0.0
        self.phase_totals: Dict[str, float] = {}

    def observe_batch(
        self,
        n_queries: int,
        n_keys: int,
        n_docs: int,
        elapsed_s: float,
        timer: Optional[PhaseTimer] = None,
    ):
        self.queries += n_queries
        self.batches += 1
        self.keys_generated += n_keys
        self.docs_returned += n_docs
        self.wall_s += elapsed_s
        if timer is not None:
            for name, t in timer.totals.items():
                self.phase_totals[name] = self.phase_totals.get(name, 0.0) + t

    def snapshot(self) -> Dict[str, float]:
        wall = self.wall_s
        return {
            "queries": self.queries,
            "batches": self.batches,
            "keys_generated": self.keys_generated,
            "docs_returned": self.docs_returned,
            "wall_s": round(wall, 3),
            "queries_per_s": round(self.queries / wall, 3) if wall else 0.0,
            "keys_per_s": round(self.keys_generated / wall, 1) if wall else 0.0,
            **{f"phase_{k}_s": round(v, 3) for k, v in self.phase_totals.items()},
        }

    def log_snapshot(self):
        logger.warning("serving metrics: %s", self.snapshot())
