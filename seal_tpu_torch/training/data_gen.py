"""A copy of ``seal_tpu/training/data_gen.py`` (standard library and numpy)
over the port's ``fix_text``.

Training-data generation (reference ``scripts/training/*``).

Produces fairseq-style parallel ``.source``/``.target`` text files with the
SEAL conditioning markers (`` || body`` / `` || title`` / `` || code``,
silver/gold `` || ?``/`` || +``, pretraining `` || p``).  Three recipes:

* supervised from DPR retriever JSON   (``make_supervised_dpr_dataset.py``)
* supervised from KILT jsonl + KB TSV  (``make_supervised_kilt_dataset.py``)
* unsupervised from a corpus TSV       (``make_unsupervised_dataset.py``)

Environment substitutions: fuzzywuzzy's ``fuzz.ratio`` -> difflib
SequenceMatcher ratio (the same underlying algorithm); NLTK English
stopwords -> an embedded list; ftfy -> whitespace/BULLET/SECTION cleanup.
"""

from __future__ import annotations

import json
import random
import re
from difflib import SequenceMatcher
from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np

from seal_tpu_torch.utils.textfix import fix_text

# English stopwords (standard list; NLTK is unavailable offline)
STOPWORDS = set(
    """a about above after again against all am an and any are aren't as at be
    because been before being below between both but by can't cannot could
    couldn't did didn't do does doesn't doing don't down during each few for
    from further had hadn't has hasn't have haven't having he he'd he'll he's
    her here here's hers herself him himself his how how's i i'd i'll i'm i've
    if in into is isn't it it's its itself let's me more most mustn't my myself
    no nor not of off on once only or other ought our ours ourselves out over
    own same shan't she she'd she'll she's should shouldn't so some such than
    that that's the their theirs them themselves then there there's these they
    they'd they'll they're they've this those through to too under until up
    very was wasn't we we'd we'll we're we've were weren't what what's when
    when's where where's which while who who's whom why why's with won't would
    wouldn't you you'd you'll you're you've your yours yourself yourselves""".split()
)


def fuzz_ratio(a: str, b: str) -> int:
    """fuzzywuzzy-style similarity in [0, 100] (SequenceMatcher.ratio)."""
    return int(round(SequenceMatcher(None, a, b).ratio() * 100))


def clean(text: str) -> str:
    # ftfy.fix_text (reference make_supervised_{dpr,kilt}_dataset.py:125/128)
    # -> HTML-entity unescape + double-encoding repair in utils/textfix.py
    text = fix_text(text)
    text = re.sub(r"\s+", " ", text)
    text = text.replace("BULLET::::", "").replace("SECTION::::", "")
    return text.strip()


def preprocess_question(question: str) -> str:
    question = question.strip().replace("\n", " / ")
    return re.sub(r"\s+", " ", question)


def span_iterator(tokens, ngrams: int = 3, banned=STOPWORDS):
    """Candidate span starts: positions whose token is not a stopword
    (reference ``make_supervised_dpr_dataset.py:68-77``)."""
    for i in range(len(tokens)):
        if tokens[i] not in banned:
            yield (i, i + ngrams)


def _start_weights(
    query_tokens_lower: list, passage_tokens_lower: list
) -> Tuple[list, "np.ndarray"]:
    """Fuzzy-overlap weight for every candidate span start.

    Computes the same quantity the reference accumulates (sum over query
    3-grams of quantized SequenceMatcher ratios against the passage 3-gram at
    each non-stopword start, ``make_supervised_dpr_dataset.py:87-96``) but
    start-major: the passage gram is seq2, whose matcher-side index is built
    once per start and reused across every query gram, instead of rebuilt for
    each (query-gram, start) pair.
    """
    q_grams = [
        " ".join(query_tokens_lower[i : i + 3])
        for i in range(len(query_tokens_lower))
    ]
    starts = [i for i, _ in span_iterator(passage_tokens_lower, 3)]
    weights = np.zeros(len(starts))
    matcher = SequenceMatcher(None)
    for row, start in enumerate(starts):
        matcher.set_seq2(" ".join(passage_tokens_lower[start : start + 3]))
        acc = 0.0
        for qg in q_grams:
            matcher.set_seq1(qg)
            acc += int(round(matcher.ratio() * 100)) / 100.0
        weights[row] = acc
    return starts, weights


def extract_spans(
    text: str,
    source: str,
    n_samples: int,
    min_length: int,
    max_length: int,
    temperature: float = 1.0,
    rng: Optional[random.Random] = None,
) -> Iterator[str]:
    """Sample target spans from a passage, weighted by fuzzy-match overlap of
    query 3-grams against passage 3-gram starts (``:79-118``)."""
    rng = rng or random
    query_tokens_lower = [
        t.lower() for t in source.split("||", 1)[0].split()
    ]
    passage_tokens = text.split()
    starts, raw = _start_weights(
        query_tokens_lower, [t.lower() for t in passage_tokens]
    )

    if not starts or not query_tokens_lower:
        indices = [0]
    else:
        # descending weight; stable sort keeps position order among ties,
        # matching the reference's insertion-ordered dict sort
        order = np.argsort(-raw, kind="stable")
        ranked = [starts[k] for k in order]
        if raw.sum() == 0.0:
            ranked, probs = [0], np.ones(1)
        else:
            logits = raw[order] / temperature
            probs = np.exp(logits - logits.max())
        indices = rng.choices(ranked, weights=(probs / probs.sum()).tolist(),
                              k=n_samples)

    for start in indices:
        n_tokens = rng.randint(min_length, max_length)
        yield " ".join(passage_tokens[start : start + n_tokens])


def _silver_suffix(mark_silver: bool, score: float, min_score_gold: float) -> str:
    if not mark_silver:
        return ""
    return " || ?" if score < min_score_gold else " || +"


def supervised_dpr_pairs(
    input_path: str,
    target: str = "span",
    min_score: float = 999.0,
    min_score_gold: float = 999.0,
    max_rank: int = 1,
    min_length: int = 10,
    max_length: int = 10,
    temperature: float = 1.0,
    mark_target: bool = False,
    mark_silver: bool = False,
    n_samples: int = 1,
    id2code: Optional[Dict[str, str]] = None,
    rng: Optional[random.Random] = None,
) -> Iterator[Tuple[str, str]]:
    """(source, target) pairs from a DPR retriever JSON file."""
    rng = rng or random
    with open(input_path) as fin:
        data = json.load(fin)

    marker = {"chunk": " || body", "span": " || body", "title": " || title", "code": " || code"}[target]
    for sample in data:
        source = sample["question"].strip()
        if mark_target:
            source = source + marker
        for i, ctx in enumerate(sample["positive_ctxs"], start=1):
            if i > max_rank or float(ctx["score"]) < min_score:
                continue
            suffix = _silver_suffix(mark_silver, float(ctx["score"]), min_score_gold)
            if target == "span":
                for span in extract_spans(
                    ctx["text"].strip(), source, n_samples, min_length, max_length,
                    temperature, rng,
                ):
                    yield source + suffix, span
            elif target == "chunk":
                for _ in range(n_samples):
                    yield source + suffix, ctx["text"].strip()
            elif target == "title":
                for _ in range(n_samples):
                    yield source + suffix, ctx["title"].strip() + " @@"
            elif target == "code":
                code = (id2code or {}).get(ctx["passage_id"])
                if not code:
                    continue
                for _ in range(n_samples):
                    yield source + suffix, code.strip() + " ||"
            else:
                raise ValueError(target)


def load_kilt_kb(kb_path: str, use_cache: bool = True) -> Dict[str, Tuple[str, str]]:
    """KILT KB TSV -> {"wid-par": (title, text)}; pickled cache beside the
    file (reference ``make_supervised_kilt_dataset.py:295-317``)."""
    import os
    import pickle

    cache = kb_path + ".cached"
    if use_cache and os.path.exists(cache):
        with open(cache, "rb") as f:
            return pickle.load(f)
    kb: Dict[str, Tuple[str, str]] = {}
    with open(kb_path) as fin:
        for line in fin:
            line = line.strip()
            if not line:
                continue
            try:
                idx, title, text = line.split("\t", 2)
            except ValueError:
                continue
            idx, title = idx.strip(), title.strip()
            text = clean(text.replace("Section::::", ""))
            if idx and title and text:
                kb[idx] = (title, text)
    if use_cache:
        with open(cache, "wb") as f:
            pickle.dump(kb, f)
    return kb


def supervised_kilt_pairs(
    input_path: str,
    kb: Dict[str, Tuple[str, str]],
    target: str = "span",
    limit: float = float("inf"),
    template: bool = False,
    min_length: int = 10,
    max_length: int = 10,
    temperature: float = 1.0,
    mark_target: bool = False,
    mark_silver: bool = False,
    n_samples: int = 1,
    id2code: Optional[Dict[str, str]] = None,
    rng: Optional[random.Random] = None,
) -> Iterator[Tuple[str, str]]:
    """(source, target) pairs from KILT jsonl with provenance resolved
    against the KB."""
    rng = rng or random
    marker = {"chunk": " || body", "span": " || body", "title": " || title", "code": " || code"}[target]
    suffix = " || +" if mark_silver else ""
    with open(input_path) as fin:
        for line in fin:
            line = line.strip()
            if not line:
                continue
            sample = json.loads(line)
            source = (
                sample["meta"]["template_questions"][0]
                if template
                else sample["input"]
            )
            source = preprocess_question(source)
            if mark_target:
                source = source + marker
            i = 0
            for out in sample.get("output", []):
                if i >= limit:
                    break
                for ctx in out.get("provenance", []):
                    if i >= limit:
                        break
                    idx = str(ctx["wikipedia_id"]) + "-" + str(ctx["start_paragraph_id"])
                    if idx not in kb:
                        continue
                    title, text = kb[idx]
                    i += 1
                    if target == "span":
                        for span in extract_spans(
                            text, source, n_samples, min_length, max_length,
                            temperature, rng,
                        ):
                            yield source + suffix, span
                    elif target == "chunk":
                        for _ in range(n_samples):
                            yield source + suffix, text
                    elif target == "title":
                        for _ in range(n_samples):
                            yield source + suffix, title + " @@"
                    elif target == "code":
                        code = (id2code or {}).get(idx)
                        if not code:
                            continue
                        for _ in range(n_samples):
                            yield source + suffix, code.strip() + " ||"
                    else:
                        raise ValueError(target)


# ------------------------------------------------------------- unsupervised

BANNED_UNSUP = {
    "the", "The", "to", "a", "A", "an", "An",
    "he", "He", "his", "His", "him", "He's",
    "she", "She", "her", "Her", "she's", "She's",
    "it", "It", "its", "Its", "it's", "It's",
    "and", "And", "or", "Or", "this", "This", "that", "That",
    "those", "Those", "these", "These", '"', '""', "'", "''",
}


def _is_good(token: str) -> bool:
    if token in BANNED_UNSUP:
        return False
    if token and token[-1] in "?.!":
        return False
    if token and token[0] in "([":
        return False
    return True


def unsupervised_pairs(
    rows: Iterable[Tuple[str, str, str]],  # (id, text, title)
    num_samples: int = 10,
    num_title_samples: int = 3,
    delimiter: str = "@@",
    min_length_input: int = 10,
    max_length_input: int = 10,
    min_length_output: int = 10,
    max_length_output: int = 10,
    full_doc_n: int = 1,
    mark_pretraining: bool = False,
    rng: Optional[random.Random] = None,
) -> Iterator[Tuple[str, str]]:
    """(span->title), (title->span), (span->span) pretraining pairs
    (reference ``make_unsupervised_dataset.py:39-125``)."""
    rng = rng or random
    p = " || p" if mark_pretraining else ""
    for _, text, title in rows:
        if text == title:
            continue
        tokens = text.split()

        for _ in range(full_doc_n):
            yield text.strip() + " || title" + p, title.strip() + " " + delimiter

        sampled = failures = 0
        while sampled < num_title_samples and failures < 10:
            if rng.random() > 0.5:
                len_a = rng.randint(min_length_input, max_length_input)
                idx_a = rng.randint(0, max(0, len(tokens) - len_a))
                a = " ".join(tokens[idx_a : idx_a + len_a]).strip() + " || title" + p
                b = title.strip() + " " + delimiter
            else:
                len_b = rng.randint(min_length_output, max_length_output)
                idx_b = rng.randint(0, max(0, len(tokens) - len_b))
                if not _is_good(tokens[idx_b]):
                    failures += 1
                    continue
                b = " ".join(tokens[idx_b : idx_b + len_b]).strip()
                a = title.strip() + " || body" + p
            yield a, b
            sampled += 1

        sampled = failures = 0
        while sampled < num_samples and failures < 10:
            len_a = rng.randint(min_length_input, max_length_input)
            len_b = rng.randint(min_length_output, max_length_output)
            idx_a = rng.randint(0, max(0, len(tokens) - len_a))
            idx_b = rng.randint(0, max(0, len(tokens) - len_b))
            if idx_a == idx_b or not _is_good(tokens[idx_b]):
                failures += 1
                continue
            a = " ".join(tokens[idx_a : idx_a + len_a]).strip() + " || body" + p
            b = " ".join(tokens[idx_b : idx_b + len_b]).strip()
            yield a, b
            sampled += 1


def read_id2code(path: str) -> Dict[str, str]:
    id2code = {}
    with open(path) as fin:
        for line in fin:
            line = line.strip()
            if line:
                idx, code = line.split("\t")
                id2code[idx] = code
    return id2code


def write_pairs(pairs: Iterable[Tuple[str, str]], output: str, mode: str = "w",
                lowercase_frac: float = 0.0, rng: Optional[random.Random] = None):
    """Write .source/.target files with the reference's leading-space
    convention (every line starts with a space)."""
    rng = rng or random
    n = 0
    with open(output + ".source", mode) as src, open(output + ".target", mode) as tgt:
        for s, t in pairs:
            if lowercase_frac and rng.random() < lowercase_frac:
                s = s.lower()
            src.write(" " + s.strip() + "\n")
            tgt.write(" " + t.strip() + "\n")
            n += 1
    return n
