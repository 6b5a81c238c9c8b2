"""A copy of ``seal_tpu/cli/make_supervised_kilt_dataset.py`` over the port's ``data_gen``.

KILT jsonl + KB TSV -> .source/.target training pairs
(parity: the reference's ``scripts/training/make_supervised_kilt_dataset.py``)."""

import argparse
import random
import sys

from seal_tpu_torch.training import data_gen


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("input")
    parser.add_argument("output")
    parser.add_argument("--kb", required=True, type=str, help="KILT KB TSV (id\\ttitle\\ttext)")
    parser.add_argument("--limit", default=float("inf"), type=float)
    parser.add_argument("--template", action="store_true")
    parser.add_argument("--target", default="span", choices=["chunk", "span", "title", "code"])
    parser.add_argument("--min_length", default=10, type=int)
    parser.add_argument("--max_length", default=10, type=int)
    parser.add_argument("--temperature", default=1.0, type=float)
    parser.add_argument("--mark_target", action="store_true")
    parser.add_argument("--mark_silver", action="store_true")
    parser.add_argument("--n_samples", default=1, type=int)
    parser.add_argument("--id2code", default=None, type=str)
    parser.add_argument("--mode", choices=["w", "a"], default="w")
    parser.add_argument("--seed", default=None, type=int)
    args = parser.parse_args(argv)

    rng = random.Random(args.seed) if args.seed is not None else random
    kb = data_gen.load_kilt_kb(args.kb)
    id2code = data_gen.read_id2code(args.id2code) if args.id2code else None
    pairs = data_gen.supervised_kilt_pairs(
        args.input,
        kb,
        target=args.target,
        limit=args.limit,
        template=args.template,
        min_length=args.min_length,
        max_length=args.max_length,
        temperature=args.temperature,
        mark_target=args.mark_target,
        mark_silver=args.mark_silver,
        n_samples=args.n_samples,
        id2code=id2code,
        rng=rng,
    )
    n = data_gen.write_pairs(pairs, args.output, mode=args.mode)
    print(f"wrote {n} pairs -> {args.output}.source/.target")
    return 0


if __name__ == "__main__":
    sys.exit(main())
