"""Trainer CLI (counterpart of ``seal_tpu/cli/train.py``): .source/.target
pairs -> a BART checkpoint, trained on the card.

The JAX CLI's arguments and behaviour: tokenization, length-bucketed
batching with static padded shapes, the label-smoothed-CE training loop
(``training/trainer.py``: kernels 22 and 23) and npz checkpoints in the
JAX package's layout (``training/checkpoint.py``).  Defaults mirror the
reference's fairseq run (lr 3e-5, warm-up 500, label smoothing 0.1, clip
0.1, save every 15k keep 3).  ``--device`` (default ``cuda``) picks the
device; ``cpu`` runs the kernels' plain versions.  Two flags need modules
that are not ported yet and raise: ``--init_checkpoint`` (the foreign
checkpoint loaders) and ``--tensor_parallel`` above 1 (the mesh).

    python -m seal_tpu_torch.cli.train DATA SAVE_DIR --tokenizer word_vocab.json
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def tokenize_pairs(tokenizer, source_path, target_path, max_src, max_tgt):
    srcs, tgts = [], []
    with open(source_path) as fs, open(target_path) as ft:
        for s, t in zip(fs, ft):
            src = tokenizer.encode(s.rstrip("\n"))[:max_src]
            tgt = tokenizer.encode(t.rstrip("\n"))[:max_tgt]
            srcs.append(src)
            tgts.append(tgt)
    return srcs, tgts


def make_batches(srcs, tgts, cfg, batch_size, rng):
    """Length-sorted batching with static padded shapes per batch bucket."""
    order = np.argsort([len(s) + len(t) for s, t in zip(srcs, tgts)])
    batches = [order[i : i + batch_size] for i in range(0, len(order), batch_size)]
    rng.shuffle(batches)

    def bucket(n, m=16):
        return ((n + m - 1) // m) * m

    for idx in batches:
        if len(idx) < batch_size:
            continue  # drop ragged tail (static shapes)
        bs = [srcs[i] for i in idx]
        bt = [tgts[i] for i in idx]
        ls = bucket(max(len(x) for x in bs))
        lt = bucket(max(len(x) for x in bt) + 1)
        src_ids = np.full((len(idx), ls), cfg.pad_token_id, np.int32)
        src_mask = np.zeros((len(idx), ls), np.int32)
        tgt_in = np.full((len(idx), lt), cfg.pad_token_id, np.int32)
        tgt_out = np.full((len(idx), lt), cfg.pad_token_id, np.int32)
        for r, (s, t) in enumerate(zip(bs, bt)):
            src_ids[r, : len(s)] = s
            src_mask[r, : len(s)] = 1
            tgt_in[r, 0] = cfg.decoder_start_token_id
            tgt_in[r, 1 : len(t) + 1] = t[: lt - 1]
            tgt_out[r, : len(t)] = t
        yield {
            "src_ids": src_ids, "src_mask": src_mask,
            "tgt_in": tgt_in, "tgt_out": tgt_out,
        }


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("data", help="prefix of <data>.source/<data>.target")
    parser.add_argument("save_dir")
    parser.add_argument("--tokenizer", required=True)
    parser.add_argument("--backbone", default="facebook/bart-large")
    parser.add_argument("--init_checkpoint", default=None,
                        help="fairseq .pt / HF dir to start from (not ported yet)")
    parser.add_argument("--lr", type=float, default=3e-5)
    parser.add_argument("--warmup", type=int, default=500)
    parser.add_argument("--max_update", type=int, default=800_000)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--max_src", type=int, default=128)
    parser.add_argument("--max_tgt", type=int, default=64)
    parser.add_argument("--save_interval", type=int, default=15_000)
    parser.add_argument("--keep", type=int, default=3)
    parser.add_argument("--log_interval", type=int, default=100)
    parser.add_argument("--epochs", type=int, default=1000)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--fp32", dest="bf16", action="store_false",
                        help="train in float32 (default: bfloat16 compute)")
    parser.add_argument("--tensor_parallel", type=int, default=1)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the kernels' plain versions)")
    args = parser.parse_args(argv)

    import dataclasses

    import torch

    from seal_tpu_torch.models.config import bart_large, bart_tiny
    from seal_tpu_torch.models.tokenizer import load_tokenizer
    from seal_tpu_torch.training import checkpoint as ckpt
    from seal_tpu_torch.training import trainer
    from seal_tpu_torch.utils.device import checked_device

    if args.init_checkpoint:
        raise NotImplementedError(
            "--init_checkpoint: the fairseq and HF checkpoint loaders are not ported to "
            "seal_tpu_torch yet (ROADMAP.md A.9)")
    if args.tensor_parallel > 1:
        raise NotImplementedError(
            "--tensor_parallel > 1: the mesh across cards is not ported to seal_tpu_torch yet "
            "(ROADMAP.md A.7)")
    device = checked_device(args.device)

    tokenizer = load_tokenizer(args.tokenizer)
    if "tiny" in args.backbone:
        cfg = bart_tiny(vocab_size=tokenizer.vocab_size)
    else:
        cfg = bart_large()
        if cfg.vocab_size < tokenizer.vocab_size:
            cfg = dataclasses.replace(cfg, vocab_size=tokenizer.vocab_size)
    if args.bf16:
        cfg = dataclasses.replace(cfg, dtype="bfloat16")

    tcfg = trainer.TrainConfig(
        learning_rate=args.lr, warmup_steps=args.warmup, total_steps=args.max_update
    )
    params, opt_state = trainer.init_train_state(cfg, tcfg, seed=args.seed, device=device)

    step = 0
    if args.resume and ckpt.latest_step(args.save_dir) is not None:
        step, state = ckpt.restore_checkpoint(
            args.save_dir, {"params": params, "opt_state": opt_state}
        )
        params, opt_state = state["params"], state["opt_state"]
        print(f"resumed from step {step}")

    train_step, _ = trainer.make_train_step(cfg, tcfg)

    print(f"tokenizing {args.data}.source/.target ...")
    srcs, tgts = tokenize_pairs(
        tokenizer, args.data + ".source", args.data + ".target", args.max_src, args.max_tgt
    )
    print(f"{len(srcs)} pairs; device={device}")

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    running = []  # the losses since the last log line, left on the device
    for epoch in range(args.epochs):
        for batch in make_batches(srcs, tgts, cfg, args.batch_size, rng):
            params, opt_state, loss = train_step(params, opt_state, batch)
            step += 1
            running.append(loss)
            if step % args.log_interval == 0:
                mean = torch.stack(running).mean().item()
                print(
                    f'{{"step": {step}, "epoch": {epoch}, '
                    f'"loss": {mean:.4f}, '
                    f'"ups": {args.log_interval / (time.time() - t0):.2f}}}'
                )
                running = []
                t0 = time.time()
            if step % args.save_interval == 0:
                ckpt.save_checkpoint(args.save_dir, step, params, opt_state, args.keep)
            if step >= args.max_update:
                break
        if step >= args.max_update:
            break
    ckpt.save_checkpoint(args.save_dir, step, params, opt_state, args.keep)
    print(f"done at step {step}; checkpoints in {args.save_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
