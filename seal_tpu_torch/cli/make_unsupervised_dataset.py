"""A copy of ``seal_tpu/cli/make_unsupervised_dataset.py`` over the port's ``data_gen``.

Corpus TSV -> unsupervised pretraining pairs
(parity: the reference's ``scripts/training/make_unsupervised_dataset.py``)."""

import argparse
import csv
import random
import sys

from seal_tpu_torch.training import data_gen


def _dpr_rows(path):
    with open(path, "r", 2**20) as f:
        next(f)
        reader = csv.reader(f, delimiter="\t", quotechar='"')
        for row in reader:
            if len(row) == 3:
                yield row[0], row[1], row[2]  # id, text, title


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("input")
    parser.add_argument("source")
    parser.add_argument("target")
    parser.add_argument("--delim", default="@@")
    parser.add_argument("--format", choices=["kilt", "dpr"], default="dpr")
    parser.add_argument("--min_length_input", type=int, default=10)
    parser.add_argument("--max_length_input", type=int, default=10)
    parser.add_argument("--min_length_output", type=int, default=10)
    parser.add_argument("--max_length_output", type=int, default=10)
    parser.add_argument("--num_samples", type=int, default=10)
    parser.add_argument("--num_title_samples", type=int, default=3)
    parser.add_argument("--full_doc_n", type=int, default=1)
    parser.add_argument("--mark_pretraining", action="store_true")
    parser.add_argument("--seed", default=None, type=int)
    args = parser.parse_args(argv)
    if args.format == "kilt":
        raise NotImplementedError("kilt input format (reference parity)")

    rng = random.Random(args.seed) if args.seed is not None else random
    pairs = data_gen.unsupervised_pairs(
        _dpr_rows(args.input),
        num_samples=args.num_samples,
        num_title_samples=args.num_title_samples,
        delimiter=args.delim,
        min_length_input=args.min_length_input,
        max_length_input=args.max_length_input,
        min_length_output=args.min_length_output,
        max_length_output=args.max_length_output,
        full_doc_n=args.full_doc_n,
        mark_pretraining=args.mark_pretraining,
        rng=rng,
    )
    # 10% of sources lowercased (reference make_unsupervised_dataset.py:165-166)
    n = 0
    with open(args.source, "w", 2**20) as src, open(args.target, "w", 2**20) as tgt:
        for s, t in pairs:
            if rng.random() < 0.1:
                s = s.lower()
            src.write(" " + s + "\n")
            tgt.write(" " + t + "\n")
            n += 1
    print(f"wrote {n} pairs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
