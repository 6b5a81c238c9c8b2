"""Build (with g++) and load (with ctypes) the native C++ helpers.

The port's copy of ``seal_tpu/cpp/native.py`` with ``sais.cpp`` and
``agg.cpp`` beside it.  Its library has a name of its own
(``libseal_torch_native.so``), so the two packages' copies can load into
one process.

pybind11/SWIG are unavailable in this environment; the C ABI + ctypes keeps
the binding layer dependency-free (the reference used SWIG,
``seal/cpp_modules/fm_index.i``).  The shared object is built
on first use with g++ and cached under ``seal_tpu_torch/cpp/_build``
(rebuilt when a source is newer than it).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(_HERE, "_build")
_LOCK = threading.Lock()
_LIB = None


class Native:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        self._lib.sais_i32.restype = ctypes.c_int
        self._lib.sais_i32.argtypes = [i32p, ctypes.c_int64, ctypes.c_int64, i64p]
        self._lib.stage1_claim.restype = ctypes.c_int
        self._lib.stage1_claim.argtypes = [u8p, i64p, ctypes.c_int64, ctypes.c_int64, u8p]
        self._lib.ac_match.restype = ctypes.c_int64
        self._lib.ac_match.argtypes = [
            i32p, i64p, ctypes.c_int64, i32p, i64p, ctypes.c_int64, i64p, ctypes.c_int64,
        ]
        f64p = ctypes.POINTER(ctypes.c_double)
        self._lib.ranges_multi.restype = ctypes.c_int
        self._lib.ranges_multi.argtypes = [
            i32p, i64p, ctypes.c_int64, i32p, i64p, ctypes.c_int64,
            ctypes.c_int64, i64p, i64p,
        ]
        self._lib.stage1_accumulate.restype = ctypes.c_int64
        self._lib.stage1_accumulate.argtypes = [
            i32p, i64p, f64p, f64p, ctypes.c_int64,  # ngrams
            i64p, i64p, i64p,  # rows
            u8p, ctypes.c_double, ctypes.c_double, ctypes.c_int32,
            ctypes.c_int64,  # covered/beta/init_prim/overlaps/max_token
            i64p, f64p, f64p,  # outputs
        ]
        self._lib.stage2_score.restype = ctypes.c_int64
        self._lib.stage2_score.argtypes = [
            i32p, i64p, f64p, f64p, ctypes.c_int64,  # patterns
            i32p, i64p, ctypes.c_int64,  # docs
            i64p, ctypes.c_int64,  # triples
            f64p, ctypes.c_int64,  # unigram scores
            ctypes.c_double, ctypes.c_double, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64,  # beta/init_prim/overlaps/ignore_free/max_token
            f64p, f64p, i64p, f64p,  # per-doc outputs
            i64p, i64p, f64p,  # found triples
        ]

    def stage1_claim(self, covered: np.ndarray, tok_ends: np.ndarray, length: int) -> np.ndarray:
        """First-come coverage claiming; mutates ``covered`` (uint8)."""
        tok_ends = np.ascontiguousarray(tok_ends, dtype=np.int64)
        flags = np.empty(tok_ends.size, np.uint8)
        self._lib.stage1_claim(
            covered.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            tok_ends.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(tok_ends.size),
            ctypes.c_int64(length),
            flags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return flags.astype(bool)

    def ac_match(self, patterns, docs) -> np.ndarray:
        """All (doc, pattern, start) occurrences of the patterns in the docs."""
        pat_data, pat_off = self._flatten(patterns)
        doc_data, doc_off = self._flatten(docs)
        n_pats, n_docs = pat_off.size - 1, doc_off.size - 1

        # high-water-mark cap: an undersized buffer costs a FULL second
        # matching pass (the C side only counts past out_cap), and with
        # unigram patterns the triple count is routinely 10-20k per query
        # vs the old 4*n_docs=2k guess; queries in a batch are similar, so
        # remember the largest count seen
        cap = max(1024, 4 * n_docs, getattr(self, "_ac_cap", 0))
        while True:
            out = np.empty((cap, 3), np.int64)
            n = self._lib.ac_match(
                pat_data.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                pat_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                ctypes.c_int64(n_pats),
                doc_data.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                doc_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                ctypes.c_int64(n_docs),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                ctypes.c_int64(cap),
            )
            if n <= cap:
                self._ac_cap = max(getattr(self, "_ac_cap", 0), int(n))
                return out[:n]
            cap = int(n)

    def ranges_multi(self, psi, C, seqs, n_rows):
        """Half-open ranges of many shifted-symbol sequences (host psi)."""
        i64p = ctypes.POINTER(ctypes.c_int64)
        data, off = self._flatten(seqs)
        n_seqs = int(off.size - 1)  # correct for pre-flattened (data, off) input
        psi = np.ascontiguousarray(psi, np.int32)
        C = np.ascontiguousarray(C, np.int64)
        lo = np.empty(n_seqs, np.int64)
        hi = np.empty(n_seqs, np.int64)
        self._lib.ranges_multi(
            psi.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            C.ctypes.data_as(i64p),
            ctypes.c_int64(C.size - 1),
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            off.ctypes.data_as(i64p),
            ctypes.c_int64(n_seqs),
            ctypes.c_int64(n_rows),
            lo.ctypes.data_as(i64p),
            hi.ctypes.data_as(i64p),
        )
        return lo, hi

    @staticmethod
    def _flatten(seqs):
        """Concatenate sequences to (int32 data, int64 offsets); a
        pre-flattened ``(data, offsets)`` tuple passes through unchanged."""
        if (
            isinstance(seqs, tuple)
            and len(seqs) == 2
            and isinstance(seqs[0], np.ndarray)
        ):
            data, off = seqs
            return (
                np.ascontiguousarray(data, np.int32),
                np.ascontiguousarray(off, np.int64),
            )
        data = np.ascontiguousarray(
            np.concatenate([np.asarray(p, np.int32) for p in seqs])
            if len(seqs) else np.zeros(0, np.int32)
        )
        off = np.zeros(len(seqs) + 1, np.int64)
        np.cumsum([len(p) for p in seqs], out=off[1:])
        return data, off

    def stage1_accumulate(
        self, ngrams, scores, prims, row_off, tok_ends, doc_ids,
        covered, beta, init_prim, allow_overlaps, max_token,
    ):
        """Full stage-1 pass: claim + per-doc accumulate + coverage rescore.

        Returns (docs, scores, best_single) in first-touch order.
        """
        f64p = ctypes.POINTER(ctypes.c_double)
        i64p = ctypes.POINTER(ctypes.c_int64)
        pat_data, pat_off = self._flatten(ngrams)
        sco = np.ascontiguousarray(scores, np.float64)
        prim = np.ascontiguousarray(prims, np.float64)
        row_off = np.ascontiguousarray(row_off, np.int64)
        tok_ends = np.ascontiguousarray(tok_ends, np.int64)
        doc_ids = np.ascontiguousarray(doc_ids, np.int64)
        cap = max(1, tok_ends.size)
        out_docs = np.empty(cap, np.int64)
        out_scores = np.empty(cap, np.float64)
        out_best = np.empty(cap, np.float64)
        n = self._lib.stage1_accumulate(
            pat_data.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            pat_off.ctypes.data_as(i64p),
            sco.ctypes.data_as(f64p),
            prim.ctypes.data_as(f64p),
            # off-derived, not len(ngrams): _flatten accepts pre-flattened
            # (data, offsets) tuples, where len() would be 2 (same trap
            # ranges_multi already guards against)
            ctypes.c_int64(int(pat_off.size - 1)),
            row_off.ctypes.data_as(i64p),
            tok_ends.ctypes.data_as(i64p),
            doc_ids.ctypes.data_as(i64p),
            covered.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_double(beta),
            ctypes.c_double(init_prim),
            ctypes.c_int32(1 if allow_overlaps else 0),
            ctypes.c_int64(max_token),
            out_docs.ctypes.data_as(i64p),
            out_scores.ctypes.data_as(f64p),
            out_best.ctypes.data_as(f64p),
        )
        return out_docs[:n], out_scores[:n], out_best[:n]

    def stage2_score(
        self, patterns, pat_scores, pat_prims, docs, triples,
        unigram_scores, beta, init_prim, allow_overlaps,
        unigrams_ignore_free_places, max_token,
    ):
        """Full stage-2 ranker over all candidate docs.

        Returns (multi, single_best, single_pat, unigram_total, found_off,
        found_id, found_sco); found_id >= 0 is a pattern index, negative
        encodes a fallback unigram token as -(token+1).
        """
        f64p = ctypes.POINTER(ctypes.c_double)
        i64p = ctypes.POINTER(ctypes.c_int64)
        pat_data, pat_off = self._flatten(patterns)
        doc_data, doc_off = self._flatten(docs)
        n_pats = pat_off.size - 1
        triples = np.ascontiguousarray(triples, np.int64).reshape(-1, 3)
        psc = np.ascontiguousarray(pat_scores, np.float64)
        ppr = np.ascontiguousarray(pat_prims, np.float64)
        if unigram_scores is not None:
            uni = np.ascontiguousarray(unigram_scores, np.float64)
            uni_ptr, n_uni = uni.ctypes.data_as(f64p), uni.size
        else:
            uni, uni_ptr, n_uni = None, ctypes.cast(None, f64p), 0
        D = doc_off.size - 1
        out_multi = np.zeros(max(1, D), np.float64)
        out_single = np.zeros(max(1, D), np.float64)
        out_pat = np.full(max(1, D), -1, np.int64)
        out_uni = np.zeros(max(1, D), np.float64)
        found_off = np.zeros(D + 1, np.int64)
        cap = max(1, len(triples) + int(doc_off[-1]))
        found_id = np.empty(cap, np.int64)
        found_sco = np.empty(cap, np.float64)
        self._lib.stage2_score(
            pat_data.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            pat_off.ctypes.data_as(i64p),
            psc.ctypes.data_as(f64p),
            ppr.ctypes.data_as(f64p),
            ctypes.c_int64(n_pats),
            doc_data.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            doc_off.ctypes.data_as(i64p),
            ctypes.c_int64(D),
            triples.ctypes.data_as(i64p),
            ctypes.c_int64(len(triples)),
            uni_ptr,
            ctypes.c_int64(n_uni),
            ctypes.c_double(beta),
            ctypes.c_double(init_prim),
            ctypes.c_int32(1 if allow_overlaps else 0),
            ctypes.c_int32(1 if unigrams_ignore_free_places else 0),
            ctypes.c_int64(max_token),
            out_multi.ctypes.data_as(f64p),
            out_single.ctypes.data_as(f64p),
            out_pat.ctypes.data_as(i64p),
            out_uni.ctypes.data_as(f64p),
            found_off.ctypes.data_as(i64p),
            found_id.ctypes.data_as(i64p),
            found_sco.ctypes.data_as(f64p),
        )
        n_found = int(found_off[-1])
        return (
            out_multi[:D], out_single[:D], out_pat[:D], out_uni[:D],
            found_off, found_id[:n_found], found_sco[:n_found],
        )

    def suffix_array(self, text: np.ndarray) -> np.ndarray:
        t = np.ascontiguousarray(text, dtype=np.int32)
        n = t.size
        sa = np.empty(n, dtype=np.int64)
        k = int(t.max()) if n else 0
        rc = self._lib.sais_i32(
            t.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int64(n),
            ctypes.c_int64(k),
            sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        if rc != 0:
            raise RuntimeError(f"sais_i32 failed with code {rc}")
        return sa


def _build() -> str:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    srcs = [os.path.join(_HERE, f) for f in ("sais.cpp", "agg.cpp")]
    out = os.path.join(_BUILD_DIR, "libseal_torch_native.so")
    if os.path.exists(out) and all(
        os.path.getmtime(out) >= os.path.getmtime(s) for s in srcs
    ):
        return out
    # link under a name of this process's own and rename it into place: a
    # process that finds ``out`` sees no library or a whole one, never a
    # file another process is still writing
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, *srcs]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load() -> Native:
    """Build (if needed) and load the native library; raises on failure."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = Native(ctypes.CDLL(_build()))
        return _LIB
