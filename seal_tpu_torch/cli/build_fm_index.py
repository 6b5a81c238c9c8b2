"""Index-build CLI of the port (a copy of ``seal_tpu/cli/build_fm_index.py``,
over the port's tokenizers, host ``FMIndex`` and shard files):

    python -m seal_tpu_torch.cli.build_fm_index corpus.tsv out --include_title --train_word_vocab

TSV corpus -> cleaned text -> token ids -> FM-index files.

Formats: ``kilt`` = ``id<TAB>title<TAB>text``; ``dpr`` = csv with header and
``id,text,title`` columns.  With ``--include_title`` the document becomes
``"{title} {delim} {text}"`` (delim default ``@@``), which is what the
title-decoding path of the searcher keys on.

Tokenizers: ``--tokenizer`` accepts a dir with vocab.json+merges.txt (byte
BPE) or a word_vocab.json (the port resolves no HF names).  With
``--train_word_vocab`` a word-level vocab is trained from this corpus and
saved next to the index -- the network-free path used by tests/benchmarks.
"""

from __future__ import annotations

import argparse
import csv
import re
import sys

from seal_tpu_torch.utils.textfix import fix_text


def clean_text(text: str) -> str:
    # reference build_fm_index.py:50-54; ftfy.fix_text is replaced by the
    # HTML-entity unescape + conservative double-encoding repair in
    # utils/textfix.py (divergence characterized in
    # tests/test_text_divergence.py + PARITY.md)
    text = fix_text(text)
    text = re.sub(r"\s+", " ", text)
    text = text.replace("BULLET::::", "").replace("SECTION::::", "")
    return text.strip()


def iter_corpus(path: str, fmt: str):
    """Yields (docid, title, text) rows."""
    with open(path, "r", 2**16) as f:
        if fmt == "dpr":
            next(f)
            reader = csv.reader(f, delimiter="\t", quotechar='"')
            for pp in reader:
                if len(pp) == 3:
                    yield pp[0], pp[2], pp[1]
        elif fmt == "kilt":
            for line in f:
                pp = line.strip().split("\t", 2)
                if len(pp) == 3:
                    yield pp[0], pp[1], pp[2]
        else:
            raise ValueError(fmt)


def preprocess(args, rows):
    from seal_tpu_torch.models.tokenizer import word_tokenize

    for idx, title, text in rows:
        idx = idx.strip()
        title = title.strip()
        text = clean_text(text)
        if not text:
            continue
        if args.tokenize:
            title = " ".join(word_tokenize(title))
            text = " ".join(word_tokenize(text))
        if args.include_title and title:
            text = f"{title} {args.delim} {text}"
        if args.lowercase:
            text = text.lower()
        yield idx, text


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("input")
    parser.add_argument("output")
    parser.add_argument("--jobs", type=int, default=1)
    parser.add_argument("--include_title", action="store_true")
    parser.add_argument("--delim", default="@@")
    parser.add_argument("--format", choices=["kilt", "dpr"], default="kilt")
    parser.add_argument("--tokenizer", default=None, type=str,
                        help="tokenizer dir (vocab.json + merges.txt) / word_vocab.json")
    parser.add_argument("--hf_model", default=None, type=str,
                        help="alias of --tokenizer (reference flag name)")
    parser.add_argument("--train_word_vocab", action="store_true",
                        help="train a word-level vocab from this corpus")
    parser.add_argument("--max_vocab", type=int, default=50000)
    parser.add_argument("--lowercase", action="store_true")
    parser.add_argument("--tokenize", action="store_true")
    parser.add_argument("--in_memory", action="store_true",
                        help="keep tokenized docs in RAM instead of the "
                        "packed cache-file flow (reference default is the "
                        "cache file)")
    parser.add_argument("--shards", type=int, default=0,
                        help="build N per-shard indexes + a manifest instead "
                        "of one monolith (round-robin docs; suffix sorts run "
                        "one fork per shard when --jobs > 1); load with "
                        "SEALSearcher.load(..., index_shards=N)")
    args = parser.parse_args(argv)
    print(args)

    from seal_tpu_torch.index.fm_index import FMIndex
    from seal_tpu_torch.models.tokenizer import WordVocabTokenizer, load_tokenizer

    rows = list(preprocess(args, iter_corpus(args.input, args.format)))
    if not rows:
        print("no documents found", file=sys.stderr)
        return 1
    labels = [idx for idx, _ in rows]
    texts = [text for _, text in rows]

    if args.train_word_vocab:
        tokenizer = WordVocabTokenizer.train(
            [" " + t for t in texts], max_vocab=args.max_vocab
        )
        tokenizer.save(args.output + ".word_vocab.json")
        print(f"trained word vocab ({tokenizer.vocab_size} tokens)")
    else:
        tokenizer = load_tokenizer(args.tokenizer or args.hf_model)

    eos = tokenizer.eos_token_id

    if args.shards > 1:
        return _build_sharded(args, texts, labels, tokenizer, eos)

    sequences = (tokenizer.encode_plain(" " + t.strip()) + [eos] for t in texts)
    index = FMIndex()
    # cache-file flow (reference index.py:57-65): tokenized docs stream to a
    # packed temp file, so peak RAM is the text array + suffix-sort workspace
    index.initialize(sequences, in_memory=args.in_memory, labels=labels)
    index.save(args.output)
    print(f"indexed {index.n_docs} docs, {len(index)} tokens -> {args.output}.fmi.npz")
    return 0


# fork workers read the parent's state copy-on-write.  Forking is safe
# here, unlike in the searcher (whose pool is spawned): the index build runs on
# the host and never initializes CUDA
_SHARD_STATE = {}


def _build_one_shard(s: int):
    st = _SHARD_STATE
    from seal_tpu_torch.index.fm_index import FMIndex
    from seal_tpu_torch.parallel.sharded_index import shard_path

    idx = FMIndex()
    docs = st["assignments"][s]
    idx.initialize(
        (st["tokenize"](st["texts"][i]) for i in docs),
        in_memory=st["in_memory"],
        labels=[st["labels"][i] for i in docs],
    )
    idx.save(shard_path(st["output"], s))
    return idx.n_docs, len(idx)


def _build_sharded(args, texts, labels, tokenizer, eos):
    """Per-shard builds + manifest: corpora whose monolithic suffix sort /
    host arrays would not fit build shard-by-shard (in parallel forks with
    --jobs) and load without ever assembling the monolith."""
    import time

    from seal_tpu_torch.parallel.sharded_index import (
        round_robin_assignments,
        save_shard_manifest,
    )

    _SHARD_STATE.update(
        texts=texts,
        labels=labels,
        assignments=round_robin_assignments(len(texts), args.shards),
        tokenize=lambda t: tokenizer.encode_plain(" " + t.strip()) + [eos],
        in_memory=args.in_memory,
        output=args.output,
    )
    t0 = time.time()
    try:
        if args.jobs > 1:
            import multiprocessing

            ctx = multiprocessing.get_context("fork")
            with ctx.Pool(min(args.jobs, args.shards)) as pool:
                stats = pool.map(_build_one_shard, range(args.shards))
        else:
            stats = [_build_one_shard(s) for s in range(args.shards)]
    finally:
        _SHARD_STATE.clear()
    save_shard_manifest(args.output, args.shards, len(texts))
    total_docs = sum(d for d, _ in stats)
    total_tokens = sum(t for _, t in stats)
    print(
        f"indexed {total_docs} docs, {total_tokens} tokens into "
        f"{args.shards} shards in {time.time() - t0:.1f}s -> "
        f"{args.output}.shard*/.manifest.json"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
