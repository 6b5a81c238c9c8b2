"""Host-side suffix array construction.

The port's copy of ``seal_tpu/index/suffix_array.py``; the native SA-IS
path loads the port's own library (``seal_tpu_torch/cpp``).

The reference builds its index with divsufsort inside sdsl-lite
(``seal/cpp_modules/fm_index.cpp:37,44`` via ``construct_im`` /
``construct``).  Here the build path is host-only (NumPy with an optional C++
SA-IS fast path in ``seal_tpu_torch/cpp``); the resulting arrays are then
shipped to the device as torch tensors (see ``device_index.py``).

Conventions: the input text is an int array whose *last* element is a unique,
strictly-smallest sentinel (we use 0 and shift real symbols up by 1).
"""

from __future__ import annotations

import numpy as np

_NATIVE = None
_NATIVE_CHECKED = False


def _load_native():
    """Load the optional C++ SA-IS extension (built lazily from seal_tpu_torch/cpp)."""
    global _NATIVE, _NATIVE_CHECKED
    if _NATIVE_CHECKED:
        return _NATIVE
    _NATIVE_CHECKED = True
    try:
        from seal_tpu_torch.cpp import native

        _NATIVE = native.load()
    except Exception:  # pragma: no cover - fallback path
        _NATIVE = None
    return _NATIVE


def suffix_array_doubling(text: np.ndarray) -> np.ndarray:
    """O(n log^2 n) Manber-Myers prefix doubling, fully vectorized in NumPy.

    Correct for any non-negative int input; used as the reference
    implementation in tests and as the fallback when the native SA-IS
    extension is unavailable.
    """
    t = np.asarray(text, dtype=np.int64)
    n = t.size
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    if n == 1:
        return np.zeros(1, dtype=np.int64)

    order = np.argsort(t, kind="stable")
    sorted_t = t[order]
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.cumsum(np.r_[0, (np.diff(sorted_t) != 0).astype(np.int64)])

    k = 1
    while k < n and rank[order[-1]] != n - 1:
        second = np.full(n, -1, dtype=np.int64)
        second[: n - k] = rank[k:]
        order = np.lexsort((second, rank))
        r1 = rank[order]
        r2 = second[order]
        changed = np.r_[0, ((np.diff(r1) != 0) | (np.diff(r2) != 0)).astype(np.int64)]
        new_rank = np.empty(n, dtype=np.int64)
        new_rank[order] = np.cumsum(changed)
        rank = new_rank
        k *= 2
    return order.astype(np.int64)


def build_suffix_array(text: np.ndarray, prefer_native: bool = True) -> np.ndarray:
    """Build the suffix array of ``text`` (last element must be the unique min).

    Uses the C++ SA-IS extension when available (O(n), multi-GB/min), else the
    NumPy doubling fallback.
    """
    t = np.ascontiguousarray(text, dtype=np.int32)
    if t.size and (t[-1] != t.min() or (t[:-1] == t[-1]).any()):
        raise ValueError("text must end with a unique, strictly smallest sentinel")
    if prefer_native:
        native = _load_native()
        if native is not None:
            return native.suffix_array(t)
    return suffix_array_doubling(t)


def brute_force_suffix_array(text: np.ndarray) -> np.ndarray:
    """O(n^2 log n) oracle for tests only."""
    t = list(np.asarray(text))
    return np.array(sorted(range(len(t)), key=lambda i: t[i:]), dtype=np.int64)
