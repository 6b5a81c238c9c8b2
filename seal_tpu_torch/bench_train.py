"""The BART-large train step's wall on the card, before and after one
profiled step, in processes of their own.

    python -m seal_tpu_torch.bench_train [--procs 2] [--steps 6]

Each process (``--procs`` of them, one after another) builds BART-large
with bf16 compute and f32 master parameters from seed 0, takes
``--steps`` timed ``make_train_step`` steps on one seeded batch at the
train CLI's defaults (``train_batch``), profiles one step
(``bench_generate.profile_batch``), then takes ``--steps`` timed steps
twice more.  Each step is timed on the host's clock to a synchronize
after it; the medians leave out each series' first step.  The threads of
the process (Python's and the OS's) are read before and after the
profile.

Prints the card's name and power limit first, then one JSON line a
process.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

TRAIN_BATCH, TRAIN_SRC, TRAIN_TGT = 32, 128, 80  # the train CLI's defaults


def train_batch(cfg, seed: int = 0, batch: int = TRAIN_BATCH, src_len: int = TRAIN_SRC,
                tgt_len: int = TRAIN_TGT):
    """One seeded batch: ``batch`` pairs, sources padded to ``src_len``,
    targets bucketed to ``tgt_len`` (decoder inputs shifted right behind
    the start token), with some pad in both."""
    rng = np.random.default_rng(seed)
    B, S, T = batch, src_len, tgt_len
    src = rng.integers(3, cfg.vocab_size, size=(B, S)).astype(np.int32)
    src_mask = np.ones((B, S), np.int32)
    tgt_out = rng.integers(3, cfg.vocab_size, size=(B, T)).astype(np.int32)
    for r in range(B):
        n = int(rng.integers(S // 3, S + 1))
        src[r, n:], src_mask[r, n:] = cfg.pad_token_id, 0
        tgt_out[r, int(rng.integers(T // 4, T)):] = cfg.pad_token_id
    tgt_in = np.full((B, T), cfg.pad_token_id, np.int32)
    tgt_in[:, 0] = cfg.decoder_start_token_id
    tgt_in[:, 1:] = np.where(tgt_out[:, :-1] != cfg.pad_token_id, tgt_out[:, :-1],
                             cfg.pad_token_id)
    return dict(src_ids=src, src_mask=src_mask, tgt_in=tgt_in, tgt_out=tgt_out)


def _threads() -> dict:
    import threading

    return dict(python=threading.active_count(), os=len(os.listdir("/proc/self/task")))


def run_once(steps: int) -> dict:
    """One process's series: timed steps, a profiled step, timed steps."""
    import dataclasses
    import statistics
    import time

    import torch

    from seal_tpu_torch import bench_generate
    from seal_tpu_torch.models.config import bart_large
    from seal_tpu_torch.training import trainer

    cfg = dataclasses.replace(bart_large(), dtype="bfloat16")
    tcfg = trainer.TrainConfig(learning_rate=1e-4, warmup_steps=1)
    params, state = trainer.init_train_state(cfg, tcfg, seed=0)
    batch = train_batch(cfg)
    step, _ = trainer.make_train_step(cfg, tcfg)

    def walls():
        out = []
        for _ in range(steps):
            t0 = time.perf_counter()
            step(params, state, batch)
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return out

    res = {"before": walls(), "threads_before": _threads()}
    prof = bench_generate.profile_batch(lambda: step(params, state, batch))
    res.update(profiled_wall_ms=prof["wall_ms"], profiled_device_ms=prof["device_busy_ms"],
               profiled_kernels=prof["kernels"])
    res["after"], res["threads_after"] = walls(), _threads()
    res["after_again"] = walls()
    for k in ("before", "after", "after_again"):
        res[k + "_median"] = statistics.median(res[k][1:])
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(run_once(args.steps)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip() or "nvidia-smi: not available", flush=True)
    for _ in range(args.procs):
        out = subprocess.run([sys.executable, "-m", "seal_tpu_torch.bench_train", "--child",
                              "--steps", str(args.steps)], capture_output=True, text=True)
        if out.returncode != 0:
            sys.stderr.write(out.stderr)
            return out.returncode
        print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
