"""Host FM-index over a token corpus, backed by dense NumPy arrays.

The port's copy of ``seal_tpu/index/fm_index.py`` (same class, same arrays,
same ``.fmi.npz`` + ``.oth`` files: an index saved by either package loads
in the other).  Only the imports differ: the suffix array and the native
helpers are the port's own copies (``seal_tpu_torch/index/suffix_array.py``,
``seal_tpu_torch/cpp/native.py``).

API parity with the reference ``seal/index.py`` (class ``FMIndex``,
``index.py:20-204``) and the C++ wrapper it subclasses
(``seal/cpp_modules/fm_index.cpp``), re-designed for a dense, device-shippable
layout instead of a succinct wavelet tree:

* ``text``  -- the concatenation of the *reversed* documents (reference
  ``index.py:52,61``), with every token id shifted by +1 and a terminal 0
  sentinel.  Storing reversed docs makes *appending* a token during
  generation equal to one *backward-search* step, exactly as in the
  reference.
* ``sa``    -- full suffix array of ``text``; ``locate`` (reference
  ``fm_index.cpp:163-167``) becomes a single gather instead of a
  sampled-SA walk.
* ``psi``   -- the Psi array (inverse LF mapping).  ``Occ(c, pos)`` =
  ``searchsorted(psi[C[c]:C[c+1]], pos)``, so a backward-search step
  (reference ``fm_index.cpp:67-76``) is a pair of branchless binary
  searches -- the form that vectorizes over beams on TPU.
* ``C``     -- cumulative symbol counts (``C[v]`` = #symbols < v).

Ranges are half-open ``[low, high)`` everywhere (the reference's sdsl
wrapper uses inclusive high bounds and patches ``+1`` at
``index.py:102-111``; we do not reproduce that quirk, only its observable
semantics through ``get_range``/``get_count``).
"""

from __future__ import annotations

import bisect
import json
import os
import pickle
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from seal_tpu_torch.index.suffix_array import build_suffix_array

SHIFT = 1  # real token ids are stored +1; 0 is the terminal sentinel


class FMIndex:
    """Dense FM-index with the reference's Python API surface.

    Attributes mirror the reference class (``seal/index.py:25-37``):
    ``beginnings`` (document start offsets in token space), ``occurring``
    (vocab present in the corpus), ``occurring_distinct`` /
    ``occurring_counts`` (the step-1 allowed-token set used by constrained
    decoding), and ``labels`` (docids).
    """

    def __init__(self):
        self.beginnings: List[int] = [0]
        self.occurring: List[int] = []
        self.occurring_distinct: List[int] = []
        self.occurring_counts: List[int] = []
        self.labels: Optional[List[str]] = None

        self.text: Optional[np.ndarray] = None  # int32 [N], shifted, sentinel last
        self.sa: Optional[np.ndarray] = None  # int32/int64 [N]
        self.psi: Optional[np.ndarray] = None  # int32/int64 [N]
        self.C: Optional[np.ndarray] = None  # int64 [sigma+1]
        self._bwt: Optional[np.ndarray] = None  # lazy
        self._beg_arr: Optional[np.ndarray] = None  # cached beginnings array
        self._beg_key = None

    # ------------------------------------------------------------------ build

    def initialize(
        self,
        sequences: Iterable[Sequence[int]],
        in_memory: bool = True,
        labels: Optional[List[str]] = None,
    ) -> None:
        """Build the index from an iterable of token-id lists.

        Parity: reference ``index.py:39-66``.  ``in_memory=False`` streams
        each (reversed, shifted) document to a packed-int temp file and
        builds from it via ``initialize_from_file`` -- no per-document
        Python lists are retained, so peak RAM is the final text array plus
        the suffix-sort workspace (the reference's cache-file flow,
        ``index.py:57-65`` -> ``fm_index.cpp:43-48``).
        """
        if not in_memory:
            self._initialize_streaming(sequences, labels)
            return
        chunks: List[np.ndarray] = []
        occurring: set = set()
        for seq in sequences:
            arr = np.asarray(seq, dtype=np.int64)
            if arr.size == 0:
                raise ValueError("empty documents are not supported")
            if arr.min() < 0:
                raise ValueError("token ids must be non-negative")
            self.beginnings.append(self.beginnings[-1] + int(arr.size))
            occurring |= set(np.unique(arr).tolist())
            chunks.append((arr[::-1] + SHIFT).astype(np.int32))
        if not chunks:
            raise ValueError("no documents given")
        self.occurring = list(occurring)
        text = np.concatenate(chunks + [np.zeros(1, dtype=np.int32)])
        self._finish_build(text)
        if labels is not None:
            self.labels = list(labels)

    def initialize_from_arrays(
        self,
        flat_tokens: np.ndarray,
        doc_lengths: np.ndarray,
        labels: Optional[List[str]] = None,
    ) -> None:
        """Vectorized build from a flat token array + per-doc lengths.

        Equivalent to ``initialize`` but without per-document Python loops --
        the practical path for 100M+-token corpora (the reverse/shift/concat
        becomes one scatter; the suffix sort dominates, as it should).
        """
        flat = np.ascontiguousarray(flat_tokens, dtype=np.int64).ravel()
        lens = np.ascontiguousarray(doc_lengths, dtype=np.int64).ravel()
        if lens.min() <= 0:
            raise ValueError("empty documents are not supported")
        total = int(lens.sum())
        if flat.size != total:
            raise ValueError(f"flat tokens ({flat.size}) != sum of lengths ({total})")
        if flat.min() < 0:
            raise ValueError("token ids must be non-negative")
        ends = np.cumsum(lens)
        starts = ends - lens
        self.beginnings = [0] + ends.tolist()
        doc_of = np.repeat(np.arange(lens.size), lens)
        off = np.arange(total) - starts[doc_of]
        out_pos = starts[doc_of] + (lens[doc_of] - 1 - off)
        text = np.zeros(total + 1, dtype=np.int32)
        text[out_pos] = flat + SHIFT
        self.occurring = np.unique(flat).tolist()
        self._finish_build(text)
        if labels is not None:
            self.labels = list(labels)

    def _initialize_streaming(self, sequences, labels=None) -> None:
        import tempfile

        BUFSZ = 1 << 22  # flush every ~16 MiB of packed ints
        fd, path = tempfile.mkstemp(suffix=".fmtoks")
        try:
            buf: List[np.ndarray] = []
            buffered = 0
            with os.fdopen(fd, "wb") as f:
                for seq in sequences:
                    arr = np.asarray(seq, dtype=np.int64)
                    if arr.size == 0:
                        raise ValueError("empty documents are not supported")
                    if arr.min() < 0:
                        raise ValueError("token ids must be non-negative")
                    self.beginnings.append(self.beginnings[-1] + int(arr.size))
                    buf.append((arr[::-1] + SHIFT).astype("<i4"))
                    buffered += arr.size
                    if buffered >= BUFSZ:
                        f.write(np.concatenate(buf).tobytes())
                        buf, buffered = [], 0
                if buf:
                    f.write(np.concatenate(buf).tobytes())
            if len(self.beginnings) == 1:
                raise ValueError("no documents given")
            self.initialize_from_file(path, width=4, _beginnings_set=True)
        finally:
            os.unlink(path)
        if labels is not None:
            self.labels = list(labels)

    def initialize_from_file(
        self, path: str, width: int = 4, _beginnings_set: bool = False
    ) -> None:
        """Build from a packed little-endian int file of *shifted*,
        per-document-reversed tokens (no sentinel; appended here).

        Wire parity with the reference C++ layer (``fm_index.cpp:43-48``);
        the byte format is exactly what ``initialize(..., in_memory=False)``
        streams (reference ``index.py:57-65``).  Like the reference method,
        this builds only the index structures -- document ``beginnings`` are
        the caller's (unless this is the internal streaming flow, or the
        file is treated as a single document).
        """
        dtype = {4: "<i4", 8: "<i8"}[int(width)]
        data = np.fromfile(path, dtype=dtype).astype(np.int32)
        if data.size and data.min() < SHIFT:
            raise ValueError("file must contain shifted (>0) symbols")
        text = np.concatenate([data, np.zeros(1, np.int32)])
        if not _beginnings_set and len(self.beginnings) == 1:
            self.beginnings = [0, int(data.size)]
        self._finish_build(text)
        self.occurring = self.occurring_distinct.copy()

    def _finish_build(self, text: np.ndarray) -> None:
        self.text = np.ascontiguousarray(text, dtype=np.int32)
        self.sa = build_suffix_array(self.text)
        self._derive()

    def occurrences(self, ngram: Sequence[int], cap: int, rng: Optional[Tuple[int, int]] = None):
        """Up to ``cap`` occurrence positions of ``ngram``: (tok_ends, doc_ids)
        as int64 arrays (reversed-text coordinates; the ranker's stage-1
        feed).  ``rng`` short-circuits the range computation.

        Rows are returned in CANONICAL order: ascending doc id, within-doc
        SA order.  Within one doc, two occurrence suffixes always compare
        within the doc (the later one hits the doc-ending sentinel first),
        so within-doc SA order is corpus-layout-independent -- which makes
        this ordering identical between a monolithic index and any sharded
        partition of the same documents (``UnionHostIndex.occurrences``
        merges per-shard lists in the same order).  The reference visits
        rows in raw SA order (``keys.py:320-326``); stage-1's per-doc
        coverage/credit state is provably order-invariant across doc
        interleavings (positions of distinct docs are disjoint), so the
        canonical order changes only equal-score tie-breaking.  Truncation
        at ``cap`` happens in SA order BEFORE the doc sort (it never fires
        in the ranker: rare ngrams have count <= max_occurrences_1 == cap).
        """
        lo, hi = rng if rng is not None else self.get_range(list(ngram))
        n = min(hi - lo, cap)
        tok_ends = np.asarray(self.sa[lo : lo + n], dtype=np.int64)
        doc_ids = np.searchsorted(self.doc_boundaries(), tok_ends, side="right") - 1
        order = np.argsort(doc_ids, kind="stable")
        return tok_ends[order], doc_ids[order]

    def occurrences_multi(self, ngrams, cap: int, rngs):
        """Batched :meth:`occurrences`: ONE flat SA gather + ONE
        doc-boundary searchsorted for all ngrams (the ranker's stage-1 feed
        is Python-call-bound per-ngram otherwise on a 1-core host).

        ``rngs``: per-ngram (lo, hi) row ranges (required -- the caller has
        them cached).  Returns (tok_ends int64 [total], doc_ids int64
        [total], row_off int64 [len+1]) with rows of ngram ``g`` at
        ``row_off[g]:row_off[g+1]`` -- identical content and order to
        per-ngram ``occurrences`` calls (canonical per-ngram order:
        doc id asc, within-doc SA order; see :meth:`occurrences`).
        """
        k = len(ngrams)
        lo = np.fromiter((r[0] for r in rngs), np.int64, k)
        hi = np.fromiter((r[1] for r in rngs), np.int64, k)
        ns = np.minimum(np.maximum(hi - lo, 0), cap)
        row_off = np.zeros(k + 1, np.int64)
        np.cumsum(ns, out=row_off[1:])
        total = int(row_off[-1])
        flat = (
            np.arange(total, dtype=np.int64)
            - np.repeat(row_off[:-1], ns)
            + np.repeat(lo, ns)
        )
        tok_ends = (
            self.sa[flat].astype(np.int64) if total else np.zeros(0, np.int64)
        )
        doc_ids = np.searchsorted(self.doc_boundaries(), tok_ends, side="right") - 1
        # one stable lexsort canonicalizes every segment at once:
        # primary = segment, secondary = doc id, residual = SA order
        seg = np.repeat(np.arange(k, dtype=np.int64), ns)
        order = np.lexsort((np.arange(total, dtype=np.int64), doc_ids, seg))
        return tok_ends[order], doc_ids[order], row_off

    def token_range(self, token: int) -> Tuple[int, int]:
        """O(1) row range of a single token: one backward step from the full
        range lands exactly on the C-array block ``[C[c], C[c+1])``."""
        c = int(token) + SHIFT
        if c < 1 or c + 1 >= self.C.size:
            return (0, 0)
        return (int(self.C[c]), int(self.C[c + 1]))

    def token_count(self, token: int) -> int:
        """O(1) corpus count of a single token (C-array difference); equals
        ``get_count([token])`` without the rank queries."""
        c = int(token) + SHIFT
        if c < 1 or c + 1 >= self.C.size:
            return 0
        return int(self.C[c + 1] - self.C[c])

    def token_counts(self, tokens) -> np.ndarray:
        """Vectorized ``token_count`` over an array of token ids."""
        c = np.asarray(tokens, np.int64) + SHIFT
        valid = (c >= 1) & (c + 1 < self.C.size)
        cc = np.clip(c, 0, self.C.size - 2)
        return np.where(valid, self.C[cc + 1] - self.C[cc], 0).astype(np.int64)

    def _derive(self) -> None:
        """Compute psi, C and the step-1 token statistics from text+sa."""
        self._beg_arr = None  # every (re)build path runs through here
        n = self.text.size
        dtype = np.int32 if n < 2**31 else np.int64
        self.sa = self.sa.astype(dtype)
        isa = np.empty(n, dtype=dtype)
        isa[self.sa] = np.arange(n, dtype=dtype)
        nxt = self.sa.astype(np.int64) + 1
        nxt[nxt == n] = 0
        self.psi = isa[nxt]
        sigma = int(self.text.max()) + 1
        counts = np.bincount(self.text, minlength=sigma)
        self.C = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        # Step-1 allowed set: exact corpus histogram (the reference computes
        # this through a BWT range query at index.py:66 with an off-by-one
        # that may drop one occurrence; we use the exact histogram).
        tok_counts = counts[SHIFT:]
        nz = np.nonzero(tok_counts)[0]
        self.occurring_distinct = nz.tolist()
        self.occurring_counts = tok_counts[nz].tolist()
        self._bwt = None

    # ------------------------------------------------------------- core query

    @property
    def bwt(self) -> np.ndarray:
        """BWT of ``text`` (lazy).  ``bwt[i] = text[(sa[i] - 1) mod N]``."""
        if self._bwt is None:
            prev = self.sa.astype(np.int64) - 1
            prev[prev < 0] = self.text.size - 1
            self._bwt = self.text[prev]
        return self._bwt

    def size(self) -> int:
        """Number of FM-index rows (corpus tokens + sentinel)."""
        return int(self.text.size)

    def __len__(self) -> int:
        """Corpus length in tokens (parity: reference ``index.py:173-177``)."""
        return self.beginnings[-1]

    @property
    def n_docs(self) -> int:
        return len(self.beginnings) - 1

    def occ(self, symbol: int, pos: int) -> int:
        """#occurrences of (shifted) ``symbol`` in ``bwt[0:pos)``."""
        lo, hi = int(self.C[symbol]), int(self.C[symbol + 1])
        return int(np.searchsorted(self.psi[lo:hi], pos, side="left"))

    def backward_search_step(self, symbol: int, low: int, high: int) -> Tuple[int, int]:
        """One LF step on half-open ``[low, high)`` with *shifted* ``symbol``.

        Dense equivalent of reference ``fm_index.cpp:67-76`` (which uses
        sdsl's inclusive bounds; we use half-open throughout).
        """
        if symbol < 0 or symbol + 1 >= self.C.size:
            return 0, 0
        base = int(self.C[symbol])
        return base + self.occ(symbol, low), base + self.occ(symbol, high)

    def backward_search_multi(self, query: Sequence[int]) -> Tuple[int, int]:
        """Full-pattern search over *shifted* symbols -> half-open row range
        (wire parity with the C++ wrapper, ``fm_index.cpp:55-65``)."""
        low, high = 0, self.size()
        for symbol in query:
            low, high = self.backward_search_step(int(symbol), low, high)
        return low, high

    def get_range(self, sequence: Sequence[int]) -> Tuple[int, int]:
        """Half-open row range of the token sequence (un-shifted ids).

        Feeding tokens first-to-last matches occurrences of the sequence in
        the *forward* documents because documents are stored reversed
        (parity: reference ``index.py:102-111``).
        """
        low, high = 0, self.size()
        for token in sequence:
            # an empty range stays empty under further steps; no early return
            # so host and device (which always runs the full scan) agree on
            # the representative (low == high) of empty ranges
            low, high = self.backward_search_step(int(token) + SHIFT, low, high)
        return low, high

    def get_count(self, sequence: Sequence[int]) -> int:
        low, high = self.get_range(sequence)
        return high - low

    def get_ranges_batch(
        self, sequences: Sequence[Sequence[int]]
    ) -> List[Tuple[int, int]]:
        """``get_range`` for many sequences in one native call.

        The per-token searchsorted chain is Python-call-bound on a 1-core
        host; the C++ kernel runs the identical binary searches in-process.
        Falls back to the Python loop when the native library (or an int32
        psi) is unavailable.
        """
        if not sequences:
            return []
        if self.psi is not None and self.psi.dtype == np.int32:
            try:
                from seal_tpu_torch.cpp import native

                lo, hi = native.load().ranges_multi(
                    self.psi,
                    self.C,
                    [[int(t) + SHIFT for t in s] for s in sequences],
                    self.size(),
                )
                return list(zip(lo.tolist(), hi.tolist()))
            except Exception:  # pragma: no cover - g++ unavailable
                pass
        return [self.get_range(s) for s in sequences]

    def locate(self, row: int) -> int:
        """Corpus position (in reversed-text coordinates) of an index row.

        Parity: reference ``fm_index.cpp:163-167`` (a sampled-SA walk there;
        a single array load here).
        """
        if row >= self.size():
            return -1
        return int(self.sa[row])

    def extract_text(self, begin: int, end: int) -> List[int]:
        """Shifted symbols ``text[end-1], ..., text[begin]`` (reference
        ``fm_index.cpp:169-184`` reconstructs the same order by walking the
        BWT; here it is a reversed slice)."""
        return self.text[begin:end][::-1].tolist()

    # ------------------------------------------------------------- doc lookup

    def get_docs_flat(self, doc_indices: Sequence[int]):
        """Concatenated forward-order unshifted tokens of many documents.

        Returns (flat int64 array, exclusive-end offsets int64).  One
        vectorized gather over ``text`` instead of a per-document
        slice+reverse+tolist loop -- the batched form stage 2 of the ranker
        consumes (it fetches ``n_docs_complete_score`` docs per query).
        """
        ids = np.asarray(doc_indices, np.int64)
        beg = self.doc_boundaries()
        starts = beg[ids]
        lens = beg[ids + 1] - starts
        off = np.zeros(ids.size + 1, np.int64)
        np.cumsum(lens, out=off[1:])
        total = int(off[-1])
        # doc j position k holds text[start_j + len_j - 1 - k] (docs are
        # stored reversed)
        pos = np.arange(total, dtype=np.int64)
        rep_off = np.repeat(off[:-1], lens)
        rep_last = np.repeat(starts + lens - 1, lens)
        flat = self.text[rep_last - (pos - rep_off)].astype(np.int64) - SHIFT
        return flat, off

    def get_doc(self, doc_index: int) -> List[int]:
        """Forward token ids of a document (parity: ``index.py:68-75``)."""
        doc = self.extract_text(self.beginnings[doc_index], self.beginnings[doc_index + 1])
        return [x - SHIFT for x in doc]

    def get_doc_index(self, token_index: int) -> int:
        """Document containing a corpus position (parity: ``index.py:77-82``)."""
        return bisect.bisect_right(self.beginnings, token_index) - 1

    def get_doc_length(self, doc_index: int) -> int:
        return self.beginnings[doc_index + 1] - self.beginnings[doc_index]

    def get_token_index_from_row(self, row: int) -> int:
        return self.locate(row)

    def get_doc_index_from_row(self, row: int) -> int:
        return self.get_doc_index(self.locate(row))

    def get_doc_indices(self, sequence: Sequence[int]) -> Iterator[int]:
        low, high = self.get_range(sequence)
        for row in range(low, high):
            yield self.get_doc_index_from_row(row)

    # ------------------------------------------------- distinct continuations

    def get_continuations(self, sequence: Sequence[int]) -> List[int]:
        low, high = self.get_range(sequence)
        return self.get_distinct(low, high)

    def distinct(self, low: int, high: int) -> List[int]:
        """Distinct *shifted* symbols in ``bwt[low:high)`` (ascending)."""
        if low >= high:
            return []
        return np.unique(self.bwt[low:high]).tolist()

    def distinct_count(self, low: int, high: int) -> List[int]:
        """Flat ``[sym0, count0, sym1, count1, ...]`` over shifted symbols
        (wire-format parity with reference ``fm_index.cpp:91-109``)."""
        if low >= high:
            return []
        syms, counts = np.unique(self.bwt[low:high], return_counts=True)
        out: List[int] = []
        for s, c in zip(syms.tolist(), counts.tolist()):
            out.extend((s, c))
        return out

    def get_distinct(self, low: int, high: int) -> List[int]:
        return [c - SHIFT for c in self.distinct(low, high) if c > 0]

    def get_distinct_count(self, low: int, high: int) -> Tuple[List[int], List[int]]:
        data = self.distinct_count(low, high)
        distinct, counts = [], []
        for d, c in zip(data[0::2], data[1::2]):
            if d > 0:
                distinct.append(d - SHIFT)
                counts.append(c)
        return distinct, counts

    def get_distinct_count_multi(
        self, lows: Sequence[int], highs: Sequence[int]
    ) -> List[Tuple[List[int], List[int]]]:
        """Batched variant (reference fans out one std::async thread per
        interval, ``fm_index.cpp:111-131``; the TPU query path replaces this
        wholesale -- this host version exists for API/test parity)."""
        return [self.get_distinct_count(lo, hi) for lo, hi in zip(lows, highs)]

    # ------------------------------------------------------------ persistence

    def save(self, path: str) -> None:
        """Write ``<path>.fmi.npz`` (arrays) + ``<path>.oth`` (metadata pickle,
        same tuple layout as reference ``index.py:186-192``)."""
        np.savez(path + ".fmi.npz", text=self.text, sa=self.sa)
        with open(path + ".oth", "wb") as f:
            pickle.dump((self.beginnings, self.occurring, self.labels), f)

    @classmethod
    def load(cls, path: str) -> "FMIndex":
        index = cls()
        with np.load(path + ".fmi.npz") as data:
            index.text = data["text"]
            index.sa = data["sa"]
        with open(path + ".oth", "rb") as f:
            index.beginnings, index.occurring, index.labels = pickle.load(f)
        index._derive()
        return index

    # ------------------------------------------------------------- utilities

    def doc_boundaries(self) -> np.ndarray:
        """int64 array view of ``beginnings``, cached.

        ``occurrences`` runs once per rare ngram; rebuilding an n_docs-sized
        array from the Python list each call dominated the stage-1 host cost
        (~30% of a profiled end-to-end batch).  The cache invalidates on
        list identity/length/endpoint change, so build-time appends and
        wholesale reassignment both refresh it.  In-place mutation of
        *interior* entries is NOT detected -- no code path does that; any
        future one must call :meth:`invalidate_doc_boundaries`.
        """
        key = (
            id(self.beginnings),
            len(self.beginnings),
            self.beginnings[-1] if self.beginnings else None,
        )
        if self._beg_arr is None or self._beg_key != key:
            self._beg_arr = np.asarray(self.beginnings, dtype=np.int64)
            self._beg_arr.setflags(write=False)
            self._beg_key = key
        return self._beg_arr

    def invalidate_doc_boundaries(self) -> None:
        """Drop the cached :meth:`doc_boundaries` array.  Required after any
        in-place mutation of interior ``beginnings`` entries (appends and
        reassignment are detected automatically)."""
        self._beg_arr = None
        self._beg_key = None
