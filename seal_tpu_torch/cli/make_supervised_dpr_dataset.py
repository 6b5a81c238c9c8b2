"""A copy of ``seal_tpu/cli/make_supervised_dpr_dataset.py`` over the port's ``data_gen``.

DPR retriever JSON -> .source/.target training pairs
(parity: the reference's ``scripts/training/make_supervised_dpr_dataset.py``)."""

import argparse
import random
import sys

from seal_tpu_torch.training import data_gen


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("input")
    parser.add_argument("output")
    parser.add_argument("--min_score", default=999.0, type=float)
    parser.add_argument("--min_score_gold", default=999.0, type=float)
    parser.add_argument("--max_rank", default=1, type=int)
    parser.add_argument("--target", default="span", choices=["chunk", "span", "title", "code"])
    parser.add_argument("--min_length", default=10, type=int)
    parser.add_argument("--max_length", default=10, type=int)
    parser.add_argument("--temperature", default=1.0, type=float)
    parser.add_argument("--jobs", default=1, type=int)
    parser.add_argument("--mark_target", action="store_true")
    parser.add_argument("--mark_silver", action="store_true")
    parser.add_argument("--n_samples", default=1, type=int)
    parser.add_argument("--id2code", default=None, type=str)
    parser.add_argument("--mode", choices=["w", "a"], default="w")
    parser.add_argument("--seed", default=None, type=int)
    args = parser.parse_args(argv)

    rng = random.Random(args.seed) if args.seed is not None else random
    id2code = data_gen.read_id2code(args.id2code) if args.id2code else None
    pairs = data_gen.supervised_dpr_pairs(
        args.input,
        target=args.target,
        min_score=args.min_score,
        min_score_gold=args.min_score_gold,
        max_rank=args.max_rank,
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
