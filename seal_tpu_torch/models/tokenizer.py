"""Tokenizers without the ``regex`` package (counterpart of
``seal_tpu/models/tokenizer.py``): ``word_tokenize``, ``SpecialTokens``,
GPT-2's byte-level BPE (``bytes_to_unicode``, ``ByteLevelBPETokenizer``:
local ``vocab.json`` + ``merges.txt``, the files a BART checkpoint
directory holds, or a vocab trained here), ``WordVocabTokenizer`` and
``load_tokenizer``.

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
"""

from __future__ import annotations

import functools
import json
import os
import re
import unicodedata
from collections import Counter
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


@functools.cache
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte <-> printable-unicode mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class ByteLevelBPETokenizer:
    """GPT-2 byte-level BPE with BART special-token conventions.

    BART ids: bos=0, pad=1, eos=2, unk=3, mask=vocab-1.  ``encode`` adds
    ``<s> ... </s>`` like HF's BART tokenizer.  Special tokens inside the
    text are not matched: they are split and byte-encoded like any text.
    """

    def __init__(self, vocab: Dict[str, int], merges: List[tuple]):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._cache: Dict[str, str] = {}
        self.bos_token_id = self.encoder.get(SpecialTokens.bos, 0)
        self.pad_token_id = self.encoder.get(SpecialTokens.pad, 1)
        self.eos_token_id = self.encoder.get(SpecialTokens.eos, 2)
        self.unk_token_id = self.encoder.get(SpecialTokens.unk, 3)
        self.mask_token_id = self.encoder.get(SpecialTokens.mask, len(self.encoder) - 1)

    # -- loading ----------------------------------------------------------

    @classmethod
    def from_files(cls, vocab_file: str, merges_file: str) -> "ByteLevelBPETokenizer":
        with open(vocab_file) as f:
            vocab = json.load(f)
        merges = []
        with open(merges_file) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                parts = line.split()
                if len(parts) == 2:
                    merges.append(tuple(parts))
        return cls(vocab, merges)

    @classmethod
    def from_dir(cls, path: str) -> "ByteLevelBPETokenizer":
        return cls.from_files(os.path.join(path, "vocab.json"), os.path.join(path, "merges.txt"))

    @classmethod
    def train(cls, texts: Sequence[str], vocab_size: int = 8000) -> "ByteLevelBPETokenizer":
        """Train a byte-level BPE vocab: greedy pair merging over word-type
        frequencies, ties broken by the larger (count, pair)."""
        be = bytes_to_unicode()
        word_freq: Counter = Counter()
        for t in texts:
            for w in gpt2_split(t):
                word_freq["".join(be[b] for b in w.encode("utf-8"))] += 1

        vocab: Dict[str, int] = {
            SpecialTokens.bos: 0,
            SpecialTokens.pad: 1,
            SpecialTokens.eos: 2,
            SpecialTokens.unk: 3,
        }
        # full byte coverage so encode never needs <unk> for unseen bytes
        for ch in be.values():
            vocab[ch] = len(vocab)
        # incremental pair counts: each merge touches only the words that
        # contain the merged pair
        words = {w: list(w) for w in word_freq}
        pairs: Counter = Counter()
        where: Dict[tuple, set] = {}
        for w, syms in words.items():
            f = word_freq[w]
            for p in zip(syms, syms[1:]):
                pairs[p] += f
                where.setdefault(p, set()).add(w)
        merges: List[tuple] = []
        budget = vocab_size - len(vocab) - 1  # reserve <mask>
        while len(merges) < budget and pairs:
            (a, b), cnt = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
            if cnt < 2:
                break
            merges.append((a, b))
            new = a + b
            vocab[new] = len(vocab)
            for w in list(where.get((a, b), ())):
                syms = words[w]
                f = word_freq[w]
                for p in zip(syms, syms[1:]):
                    pairs[p] -= f
                    if pairs[p] <= 0:
                        del pairs[p]
                out: List[str] = []
                i = 0
                while i < len(syms):
                    if i + 1 < len(syms) and syms[i] == a and syms[i + 1] == b:
                        out.append(new)
                        i += 2
                    else:
                        out.append(syms[i])
                        i += 1
                words[w] = out
                for p in zip(out, out[1:]):
                    pairs[p] = pairs.get(p, 0) + f
                    where.setdefault(p, set()).add(w)
        vocab[SpecialTokens.mask] = len(vocab)
        return cls(vocab, merges)

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "vocab.json"), "w") as f:
            json.dump(self.encoder, f)
        with open(os.path.join(path, "merges.txt"), "w") as f:
            f.write("#version: 0.2\n")
            for a, b in sorted(self.bpe_ranks, key=self.bpe_ranks.get):
                f.write(f"{a} {b}\n")

    # -- BPE core ---------------------------------------------------------

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token)
        if len(word) < 2:
            self._cache[token] = token
            return token
        while True:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
        out = " ".join(word)
        self._cache[token] = out
        return out

    # -- public api -------------------------------------------------------

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def __len__(self) -> int:
        return self.vocab_size

    def encode_plain(self, text: str) -> List[int]:
        """Encode without special tokens."""
        ids: List[int] = []
        for tok in gpt2_split(text):
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            for piece in self._bpe(mapped).split(" "):
                ids.append(self.encoder.get(piece, self.unk_token_id))
        return ids

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = self.encode_plain(text)
        if add_special_tokens:
            return [self.bos_token_id] + ids + [self.eos_token_id]
        return ids

    def encode_batch(self, texts: Sequence[str], add_special_tokens: bool = True):
        return [self.encode(t, add_special_tokens) for t in texts]

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        special = {self.bos_token_id, self.pad_token_id, self.eos_token_id, self.mask_token_id}
        pieces = []
        for i in ids:
            i = int(i)
            if skip_special_tokens and i in special:
                continue
            pieces.append(self.decoder.get(i, SpecialTokens.unk))
        data = bytearray()
        for ch in "".join(pieces):
            b = self.byte_decoder.get(ch)
            if b is None:
                data.extend(ch.encode("utf-8"))
            else:
                data.append(b)
        return data.decode("utf-8", errors="replace")

    def batch_decode(self, seqs, skip_special_tokens: bool = False):
        return [self.decode(s, skip_special_tokens) for s in seqs]


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
    """Resolve a tokenizer: a directory with ``vocab.json`` + ``merges.txt``
    (byte-level BPE), a directory holding ``word_vocab.json`` or a ``.json``
    file (word-level).  The JAX package's last resort, a name in the HF hub
    cache through ``transformers``, has no counterpart (the machine with
    the card has neither): anything else raises ``FileNotFoundError``."""
    if os.path.isdir(path_or_name):
        vj = os.path.join(path_or_name, "vocab.json")
        mg = os.path.join(path_or_name, "merges.txt")
        if os.path.exists(vj) and os.path.exists(mg):
            return ByteLevelBPETokenizer.from_dir(path_or_name)
        wv = os.path.join(path_or_name, "word_vocab.json")
        if os.path.exists(wv):
            return WordVocabTokenizer.load(wv)
    if os.path.isfile(path_or_name) and path_or_name.endswith(".json"):
        return WordVocabTokenizer.load(path_or_name)
    raise FileNotFoundError(
        f"cannot resolve tokenizer {path_or_name!r}: provide a directory "
        "with vocab.json+merges.txt or a word_vocab.json file"
    )
