"""Streaming serving CLI of the port: ``python -m seal_tpu_torch.cli.serve``
(the counterpart of ``seal_tpu/cli/serve.py``).

Reads queries as JSON lines (``{"id": ..., "query": ...}``; bare strings
also accepted) from stdin or ``--input``, batches them up to the searcher's
``batch_size`` -- flushing early when the input stream goes idle, so a
trickling client is never starved -- and emits one JSON result line per
query:

    {"id": ..., "query": ..., "hits": [{"docid", "score", "title", "text"}]}

Malformed lines are skipped with a warning (a long-running worker must not
die on one bad client line).  Serving metrics (queries/sec, keys/sec,
phase totals) are logged on exit.  The reference has no serving entry
point (its CLI is batch evaluation only); this is the long-running-worker
shape: stateless, index and model loaded once -- restart/reload IS the
fault-recovery story.  ``--device`` (default ``auto``) serves on the card
and raises without one; ``--device cpu`` runs the kernels' plain
versions.  ``--multihost`` (as JAX's) initializes ``torch.distributed``
from torchrun's variables (``parallel/multihost.py``; a no-op without
``MASTER_ADDR``): each rank serves its own input on its own card
(``cuda:LOCAL_RANK``, or ``--device cpu``), with no mesh, and writes
``<output>.<rank>`` when there is more than one rank.

    python -m seal_tpu_torch.cli.serve --fm_index idx --checkpoint model.pt < queries.jsonl
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

logger = logging.getLogger(__name__)


def _query_parser():
    """Line parser with a per-stream default-id counter; malformed lines
    (non-dict/non-string JSON, dicts without a string "query") are skipped
    with a warning rather than killing the worker."""
    count = 0

    def parse(line):
        nonlocal count
        line = line.strip()
        if not line:
            return None
        n = count
        count += 1
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            obj = line
        if isinstance(obj, str):
            return {"id": n, "query": obj}
        if isinstance(obj, dict) and isinstance(obj.get("query"), str):
            return {"id": obj.get("id", n), "query": obj["query"]}
        logger.warning("skipping malformed query line: %.80r", line)
        return None

    return parse


def main(argv=None, stdin=None, stdout=None):
    from seal_tpu_torch.retrieval.searcher import SEALSearcher
    from seal_tpu_torch.utils.batching import adaptive_batches

    parser = argparse.ArgumentParser()
    parser.add_argument("--input", type=str, default=None,
                        help="JSONL query file (default: stdin)")
    parser.add_argument("--output", type=str, default=None,
                        help="JSONL results file (default: stdout)")
    parser.add_argument("--hits", type=int, default=10)
    parser.add_argument("--multihost", action="store_true", default=False,
                        help="init torch.distributed (coordinator from env)")
    SEALSearcher.add_args(parser)
    args = parser.parse_args(argv)

    output_path = args.output
    if args.multihost:
        from seal_tpu_torch.parallel import multihost

        multihost.init_distributed()
        args.device = str(multihost.local_device(args.device))
        if multihost.process_count() > 1 and output_path:
            output_path = f"{output_path}.{multihost.process_index()}"
    searcher = SEALSearcher.from_args(args)
    in_f = open(args.input) if (stdin is None and args.input) else None
    out_f = open(output_path, "w") if (stdout is None and output_path) else None
    stdin = stdin if stdin is not None else (in_f or sys.stdin)
    stdout = stdout if stdout is not None else (out_f or sys.stdout)

    try:
        for batch in adaptive_batches(stdin, _query_parser(), searcher.batch_size):
            results = searcher.batch_search([q["query"] for q in batch], k=args.hits)
            for q, docs in zip(batch, results):
                hits = []
                for d in docs:
                    title, body = d.text()
                    hit = {"docid": d.docid, "score": d.score,
                           "title": title.strip(), "text": body.strip()}
                    if d.keys is not None:
                        hit["keys"] = d.keys
                    hits.append(hit)
                stdout.write(json.dumps({"id": q["id"], "query": q["query"],
                                         "hits": hits}) + "\n")
            stdout.flush()
    finally:
        searcher.close()
        searcher.metrics.log_snapshot()
        if in_f is not None:
            in_f.close()
        if out_f is not None:
            out_f.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
