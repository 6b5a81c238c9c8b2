"""Word-level tokenizer without the ``regex`` package (counterpart of
``seal_tpu/models/tokenizer.py``: ``word_tokenize``, ``SpecialTokens``,
``WordVocabTokenizer`` and the word-vocab branches of ``load_tokenizer``).

The JAX module splits text with ``regex`` patterns that use ``\\p{L}``,
``\\p{N}`` and ``\\s``.  The standard ``re`` module has no Unicode property
classes, so the patterns here spell them out as explicit character classes,
built once at first use from ``unicodedata``: L is the categories Lu, Ll,
Lt, Lm and Lo, N is Nd, Nl and No.  ``\\s`` is spelled out too: ``re``'s
``\\s`` (``str.isspace``) also matches U+001C-U+001F, which ``regex``'s
(the Unicode White_Space property) does not.

The classes follow the interpreter's Unicode database
(``unicodedata.unidata_version``).  ``regex`` may carry a newer one; the
two then differ only on code points that the older version leaves
unassigned (the tests check every code point).

The byte-level BPE tokenizer is not ported yet: ``load_tokenizer`` raises
``NotImplementedError`` for a directory with ``vocab.json`` +
``merges.txt``.
"""

from __future__ import annotations

import functools
import json
import os
import re
import unicodedata
from typing import Dict, List, Sequence

# the Unicode White_Space property: what regex's \s matches
WHITESPACE = (
    "\t\n\x0b\x0c\r \x85\xa0\u1680"
    + "".join(chr(c) for c in range(0x2000, 0x200B))
    + "\u2028\u2029\u202f\u205f\u3000"
)


def _ranges(pred) -> List[tuple]:
    """Maximal code-point runs [a, b] on which ``pred(category)`` holds."""
    runs: List[tuple] = []
    start = None
    for cp in range(0x110000):
        if pred(unicodedata.category(chr(cp))):
            if start is None:
                start = cp
        elif start is not None:
            runs.append((start, cp - 1))
            start = None
    if start is not None:
        runs.append((start, 0x10FFFF))
    return runs


def _class_body(runs) -> str:
    return "".join(f"\\U{a:08x}-\\U{b:08x}" for a, b in runs)


@functools.cache
def char_classes() -> Dict[str, str]:
    """Bodies (without brackets) of the L, N and whitespace classes."""
    return {
        "L": _class_body(_ranges(lambda c: c in ("Lu", "Ll", "Lt", "Lm", "Lo"))),
        "N": _class_body(_ranges(lambda c: c in ("Nd", "Nl", "No"))),
        "S": _class_body((ord(c), ord(c)) for c in WHITESPACE),
    }


@functools.cache
def _gpt2_pat() -> re.Pattern:
    """GPT-2's pattern (contractions, letter runs, number runs, ...)."""
    k = char_classes()
    L, N, S = k["L"], k["N"], k["S"]
    return re.compile(
        rf"""'s|'t|'re|'ve|'m|'ll|'d| ?[{L}]+| ?[{N}]+| ?[^{S}{L}{N}]+|[{S}]+(?![^{S}])|[{S}]+"""
    )


@functools.cache
def _word_pat() -> re.Pattern:
    k = char_classes()
    L, N, S = k["L"], k["N"], k["S"]
    return re.compile(rf"[{L}]+|[{N}]+|[^{S}{L}{N}]")


def gpt2_split(text: str) -> List[str]:
    """The pieces GPT-2's pattern cuts ``text`` into."""
    return _gpt2_pat().findall(text)


def word_tokenize(text: str) -> List[str]:
    """Word tokenizer standing in for the reference's spaCy English
    tokenizer: letter runs, number runs and single other characters."""
    return _word_pat().findall(text)


class SpecialTokens:
    bos = "<s>"
    pad = "<pad>"
    eos = "</s>"
    unk = "<unk>"
    mask = "<mask>"


class WordVocabTokenizer:
    """Trainable word-level tokenizer (tests and benchmarks).

    Splits on the GPT-2 pattern so tokens carry their leading space exactly
    like byte-level BPE (" soup" vs "soup" are distinct), which the SEAL key
    machinery relies on (``prepend_space``, leading-space keys).
    """

    N_RESERVED = 4  # bos, pad, eos, unk

    def __init__(self, vocab: Dict[str, int]):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bos_token_id = 0
        self.pad_token_id = 1
        self.eos_token_id = 2
        self.unk_token_id = 3
        self.mask_token_id = 3  # no mask; alias unk

    @classmethod
    def train(cls, texts: Sequence[str], max_vocab: int = 50000) -> "WordVocabTokenizer":
        from collections import Counter

        counter: Counter = Counter()
        for t in texts:
            counter.update(gpt2_split(t))
        vocab = {
            SpecialTokens.bos: 0,
            SpecialTokens.pad: 1,
            SpecialTokens.eos: 2,
            SpecialTokens.unk: 3,
        }
        for tok, _ in counter.most_common(max_vocab - len(vocab)):
            vocab[tok] = len(vocab)
        return cls(vocab)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.encoder, f)

    @classmethod
    def load(cls, path: str) -> "WordVocabTokenizer":
        with open(path) as f:
            return cls(json.load(f))

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def __len__(self) -> int:
        return self.vocab_size

    def encode_plain(self, text: str) -> List[int]:
        return [self.encoder.get(tok, self.unk_token_id) for tok in gpt2_split(text)]

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = self.encode_plain(text)
        if add_special_tokens:
            return [self.bos_token_id] + ids + [self.eos_token_id]
        return ids

    def encode_batch(self, texts: Sequence[str], add_special_tokens: bool = True):
        return [self.encode(t, add_special_tokens) for t in texts]

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        pieces = []
        for i in ids:
            i = int(i)
            if skip_special_tokens and i < self.N_RESERVED:
                continue
            pieces.append(self.decoder.get(i, SpecialTokens.unk))
        return "".join(pieces)

    def batch_decode(self, seqs, skip_special_tokens: bool = False):
        return [self.decode(s, skip_special_tokens) for s in seqs]


def load_tokenizer(path_or_name: str):
    """Resolve a word-level tokenizer: a directory holding
    ``word_vocab.json``, or a ``.json`` file."""
    if os.path.isdir(path_or_name):
        wv = os.path.join(path_or_name, "word_vocab.json")
        if os.path.exists(wv):
            return WordVocabTokenizer.load(wv)
        if os.path.exists(os.path.join(path_or_name, "merges.txt")):
            raise NotImplementedError(
                "the byte-level BPE tokenizer is not ported to seal_tpu_torch yet"
            )
    if os.path.isfile(path_or_name) and path_or_name.endswith(".json"):
        return WordVocabTokenizer.load(path_or_name)
    raise FileNotFoundError(
        f"cannot resolve tokenizer {path_or_name!r}: provide a word_vocab.json "
        "file or a directory holding one"
    )
