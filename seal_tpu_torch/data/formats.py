"""Evaluation I/O: topic iterators and output writers (a copy of
``seal_tpu/data/formats.py`` over the port's ``SEALDocument``).

Re-implements in-repo the surface the reference takes from pyserini 0.13
(the reference's ``seal/data.py:16-17``: ``QueryIterator``/``OutputWriter``
plus the custom DPR/KILT/NQ formats at ``data.py:21-170``).  Formats:

topics:  default (TSV id\\tquery), kilt (jsonl), kilt_template, dpr (JSON),
         dpr_qas (TSV query\\t[answers]), nq (jsonlines)
outputs: trec, msmarco, kilt (jsonl w/ provenance), dpr (JSON w/ ctxs)
"""

from __future__ import annotations

import ast
import csv
import json
from enum import Enum, unique
from typing import Dict, List, Optional, Tuple

from seal_tpu_torch.retrieval.document import SEALDocument


@unique
class TopicsFormat(Enum):
    DEFAULT = "default"
    KILT = "kilt"
    KILT_TEMPLATE = "kilt_template"
    DPR = "dpr"
    DPR_QAS = "dpr_qas"
    NQ = "nq"


@unique
class OutputFormat(Enum):
    TREC = "trec"
    MSMARCO = "msmarco"
    KILT = "kilt"
    DPR = "dpr"


# ----------------------------------------------------------- query iterators


class QueryIterator:
    def __init__(self, topics: Dict, order: List):
        self.topics = topics
        self.order = order

    def get_query(self, id_):
        raise NotImplementedError

    def __iter__(self):
        for id_ in self.order:
            yield id_, self.get_query(id_)

    def __len__(self):
        return len(self.order)


class DefaultQueryIterator(QueryIterator):
    """TSV: ``id<TAB>query`` per line."""

    def get_query(self, id_):
        return self.topics[id_]

    @classmethod
    def from_topics(cls, path: str):
        topics, order = {}, []
        with open(path) as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                id_, query = line.split("\t", 1)
                topics[id_] = query
                order.append(id_)
        return cls(topics, order)


class KiltQueryIterator(QueryIterator):
    """KILT jsonl: objects with ``id`` and ``input``."""

    def get_query(self, id_):
        return self.topics[id_]["input"]

    @classmethod
    def from_topics(cls, path: str):
        topics, order = {}, []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                obj = json.loads(line)
                topics[obj["id"]] = obj
                order.append(obj["id"])
        return cls(topics, order)


class KiltTemplateQueryIterator(KiltQueryIterator):
    def get_query(self, id_):
        return self.topics[id_]["meta"]["template_questions"][0]


class DprQueryIterator(QueryIterator):
    """DPR retriever JSON: a list of {question, answers, ...}."""

    def get_query(self, id_):
        return self.topics[id_]["question"]

    @classmethod
    def from_topics(cls, path: str):
        topics, order = {}, []
        with open(path) as f:
            for id_, instance in enumerate(json.load(f)):
                topics[id_] = instance
                order.append(id_)
        return cls(topics, order)


class DprQueryQasIterator(QueryIterator):
    """DPR QAS TSV: ``query<TAB>["answer", ...]``."""

    def get_query(self, id_):
        return self.topics[id_]["question"]

    @classmethod
    def from_topics(cls, path: str):
        topics, order = {}, []
        with open(path) as f:
            reader = csv.reader(f, delimiter="\t", quotechar='"')
            for id_, (query, answers) in enumerate(reader):
                answers = ast.literal_eval(answers)
                assert isinstance(answers, list) and isinstance(answers[0], str)
                topics[id_] = {"question": query, "answers": answers}
                order.append(id_)
        return cls(topics, order)


class NqQueryIterator(QueryIterator):
    """NQ jsonlines: ``example_id`` + ``question_text``."""

    def get_query(self, id_):
        return self.topics[id_]["question_text"]

    @classmethod
    def from_topics(cls, path: str):
        topics, order = {}, []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                obj = json.loads(line)
                topics[obj["example_id"]] = obj
                order.append(obj["example_id"])
        return cls(topics, order)


def get_query_iterator(path: str, fmt: TopicsFormat) -> QueryIterator:
    mapping = {
        TopicsFormat.DEFAULT: DefaultQueryIterator,
        TopicsFormat.KILT: KiltQueryIterator,
        TopicsFormat.KILT_TEMPLATE: KiltTemplateQueryIterator,
        TopicsFormat.DPR: DprQueryIterator,
        TopicsFormat.DPR_QAS: DprQueryQasIterator,
        TopicsFormat.NQ: NqQueryIterator,
    }
    return mapping[fmt].from_topics(path)


# ------------------------------------------------------------ output writers


class OutputWriter:
    def __init__(
        self,
        file_path: str,
        mode: str = "w",
        max_hits: int = 100,
        tag: Optional[str] = None,
        topics: Optional[Dict] = None,
        use_max_passage: bool = False,
        max_passage_delimiter: str = "#",
        max_passage_hits: int = 100,
    ):
        self.file_path = file_path
        self.mode = mode
        self.max_hits = max_hits
        self.tag = tag
        self.topics = topics or {}
        self.use_max_passage = use_max_passage
        self.max_passage_delimiter = max_passage_delimiter
        self.max_passage_hits = max_passage_hits
        self._file = None

    def __enter__(self):
        self._file = open(self.file_path, self.mode)
        return self

    def __exit__(self, exc_type, exc_value, exc_traceback):
        self._file.close()

    def hits_iterator(self, hits: List[SEALDocument]):
        """(docid, rank, score, hit); optional passage collapsing to parent
        docids (pyserini ``OutputWriter.hits_iterator`` behavior)."""
        unique_docs = set()
        rank = 1
        for hit in hits:
            docid = str(hit.docid)
            if self.use_max_passage:
                docid = docid.split(self.max_passage_delimiter)[0]
                if docid in unique_docs:
                    continue
                unique_docs.add(docid)
            yield docid, rank, hit.score, hit
            rank += 1
            limit = self.max_passage_hits if self.use_max_passage else self.max_hits
            if rank > limit:
                break

    def write(self, topic: str, hits: List[SEALDocument]):
        raise NotImplementedError


class TrecWriter(OutputWriter):
    def write(self, topic, hits):
        for docid, rank, score, _ in self.hits_iterator(hits):
            self._file.write(f"{topic} Q0 {docid} {rank} {score:.6f} {self.tag}\n")


class MsMarcoWriter(OutputWriter):
    def write(self, topic, hits):
        for docid, rank, _score, _ in self.hits_iterator(hits):
            self._file.write(f"{topic}\t{docid}\t{rank}\n")


def _parse_kilt_docid(docid: str) -> Tuple[int, int, int]:
    """``"wid"`` / ``"wid-par"`` / ``"wid-p0-p1"`` ->
    (wikipedia_id, start_paragraph_id, end_paragraph_id)."""
    wid, *pars = str(docid).split("-")
    if not pars:
        return int(wid), 0, 0
    start = int(pars[0])
    return int(wid), start, int(pars[1]) if len(pars) > 1 else start


class KiltWriter(OutputWriter):
    """KILT jsonl with wikipedia provenance parsed from ``docid`` ("wid" or
    "wid-par" or "wid-p0-p1"; parity: reference ``data.py:106-136``)."""

    def _provenance(self, docid, score: float, hit) -> dict:
        wikipedia_id, start_par, end_par = _parse_kilt_docid(docid)
        title, body = hit.text()
        entry = {
            "wikipedia_id": wikipedia_id,
            "start_paragraph_id": start_par,
            "end_paragraph_id": end_par,
            "text": f"{title} @@ {body}",
            "score": score,
        }
        if hit.keys is not None:
            entry["meta"] = {"keys": hit.keys}
        return entry

    def write(self, topic, hits):
        ranked = list(self.hits_iterator(hits))
        query = next(
            (
                h.query
                for _d, _r, _s, h in ranked
                if isinstance(h, SEALDocument) and h.query is not None
            ),
            None,
        )
        datapoint = {
            "id": topic,
            "input": query,
            "output": [
                {
                    "provenance": [
                        self._provenance(d, s, h)
                        if isinstance(h, SEALDocument)
                        else {"wikipedia_id": d}
                        for d, _r, s, h in ranked
                    ]
                }
            ],
        }
        json.dump(datapoint, self._file)
        self._file.write("\n")


class DprWriter(OutputWriter):
    """DPR JSON: topics augmented with retrieved ``ctxs``; dumped on exit
    (parity: reference ``data.py:138-161``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.order: List = []

    @staticmethod
    def _ctx(docid, score: float, hit) -> dict:
        title, body = hit.text()
        return {
            "title": title.strip(),
            "text": body.strip(),
            "score": score,
            "passage_id": docid,
        }

    def write(self, topic, hits):
        self.order.append(topic)
        self.topics[topic]["ctxs"] = [
            self._ctx(docid, score, hit)
            for docid, _rank, score, hit in self.hits_iterator(hits)
        ]

    def __exit__(self, exc_type, exc_value, exc_traceback):
        data = [self.topics[t] for t in self.order]
        json.dump(data, self._file, indent="    ")
        return super().__exit__(exc_type, exc_value, exc_traceback)


def get_output_writer(path: str, fmt: OutputFormat, mode: str = "w", **kwargs) -> OutputWriter:
    mapping = {
        OutputFormat.TREC: TrecWriter,
        OutputFormat.MSMARCO: MsMarcoWriter,
        OutputFormat.KILT: KiltWriter,
        OutputFormat.DPR: DprWriter,
    }
    return mapping[fmt](path, mode, **kwargs)
