"""Retrieval CLI of the port: ``python -m seal_tpu_torch.cli.search`` (the
counterpart of ``seal_tpu/cli/search.py``, reference ``python -m
seal.search``).

Flags are generated from ``SEALSearcher.DEFAULTS`` (``--dont_X`` for True
defaults, ``--X`` for False ones), plus topics/output format options.
``--device`` (default ``auto``) serves on the card and raises without one;
``--device cpu`` runs the kernels' plain versions.  ``--profile_dir``
writes a ``torch.profiler`` trace.  ``--multihost`` (as JAX's) initializes
``torch.distributed`` from torchrun's variables (``parallel/multihost.py``;
a no-op without ``MASTER_ADDR``): each rank searches its
``process_slice`` of the topics on its own card (``cuda:LOCAL_RANK``, or
``--device cpu``), with no mesh, and writes ``<output>.<rank>`` when there
is more than one rank.

    python -m seal_tpu_torch.cli.search --topics q.json --topics_format dpr \\
        --output run.trec --fm_index idx --checkpoint model.pt
"""

from __future__ import annotations

import argparse
import random
import sys


def main(argv=None):
    from seal_tpu_torch.data.formats import (
        OutputFormat,
        TopicsFormat,
        get_output_writer,
        get_query_iterator,
    )
    from seal_tpu_torch.retrieval.searcher import SEALSearcher

    parser = argparse.ArgumentParser()
    parser.add_argument("--topics", type=str, required=True)
    parser.add_argument("--hits", type=int, default=100)
    parser.add_argument(
        "--topics_format", type=str, default=TopicsFormat.DEFAULT.value,
        help=f"one of {[x.value for x in TopicsFormat]}",
    )
    parser.add_argument(
        "--output_format", type=str, default=OutputFormat.TREC.value,
        help=f"one of {[x.value for x in OutputFormat]}",
    )
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--max_passage", action="store_true", default=False)
    parser.add_argument("--max_passage_hits", type=int, default=100)
    parser.add_argument("--max_passage_delimiter", type=str, default="#")
    parser.add_argument("--remove_duplicates", action="store_true", default=False)
    parser.add_argument(
        "--hybrid", default="none",
        choices=["none", "ensemble", "recall", "recall-ensemble"],
        help="accepted for reference CLI compatibility; the reference parses "
        "this flag but never reads it (seal/search.py:19), so any value "
        "other than 'none' only emits a warning here",
    )
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--keep_samples", type=int, default=None)
    parser.add_argument("--chunked", type=int, default=0)
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace into this directory")
    parser.add_argument("--multihost", action="store_true", default=False,
                        help="init torch.distributed (coordinator from env): each rank "
                        "searches its slice of the topics")
    SEALSearcher.add_args(parser)
    args = parser.parse_args(argv)
    print(args)
    if args.hybrid != "none":
        print(
            f"warning: --hybrid {args.hybrid} is accepted for compatibility "
            "but has no effect (unused in the reference too)",
            file=sys.stderr,
        )

    output_path = args.output
    query_iterator = get_query_iterator(args.topics, TopicsFormat(args.topics_format))
    if args.multihost:
        from seal_tpu_torch.parallel import multihost

        multihost.init_distributed()
        args.device = str(multihost.local_device(args.device))
        if multihost.process_count() > 1:
            output_path = f"{args.output}.{multihost.process_index()}"
            start, end = multihost.process_slice(len(query_iterator.order))
            query_iterator.order = query_iterator.order[start:end]
            query_iterator.topics = {
                t: query_iterator.topics[t] for t in query_iterator.order
            }
    output_writer = get_output_writer(
        output_path,
        OutputFormat(args.output_format),
        "w",
        max_hits=args.hits,
        tag="seal_tpu",
        topics=query_iterator.topics,
        use_max_passage=args.max_passage,
        max_passage_delimiter=args.max_passage_delimiter,
        max_passage_hits=args.max_passage_hits,
    )

    if args.debug:
        query_iterator.order = query_iterator.order[:500]
        query_iterator.topics = {t: query_iterator.topics[t] for t in query_iterator.order}
    if args.keep_samples is not None and args.keep_samples < len(query_iterator.order):
        random.seed(42)
        random.shuffle(query_iterator.order)
        query_iterator.order = query_iterator.order[: args.keep_samples]
        query_iterator.topics = {t: query_iterator.topics[t] for t in query_iterator.order}

    searcher = SEALSearcher.from_args(args)

    from seal_tpu_torch.utils.batching import chunks
    from seal_tpu_torch.utils.profiling import device_trace

    try:
        with output_writer, device_trace(args.profile_dir):
            if args.chunked <= 0:
                topic_ids, texts = zip(*query_iterator)
                for topic_id, hits in zip(topic_ids,
                                          searcher.batch_search(list(texts), k=args.hits)):
                    output_writer.write(topic_id, hits)
            else:
                for batch in chunks(iter(query_iterator), args.chunked):
                    topic_ids, texts = zip(*batch)
                    for topic_id, hits in zip(
                        topic_ids, searcher.batch_search(list(texts), k=args.hits)
                    ):
                        output_writer.write(topic_id, hits)
    finally:
        searcher.close()
    searcher.metrics.log_snapshot()
    return 0


if __name__ == "__main__":
    sys.exit(main())
