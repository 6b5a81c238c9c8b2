"""Build and load the CUDA kernels (``csrc/*.cu``) as one shared library.

The sources compile with ``nvcc`` for ``sm_90a`` into a library with a plain
C interface that ``ctypes`` loads: a build takes seconds, where a
PyTorch-extension build that includes the torch headers takes minutes.  The
library is built at first use into ``kernels/_build/`` and rebuilt when a
source is newer than it (the scheme of ``seal_tpu/cpp/native.py``).

Every C entry point launches on the stream it is given, allocates nothing
and returns ``cudaGetLastError()``; :func:`check` turns a non-zero code into
an exception.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("fm_search.cu", "window_gather.cu", "row_topk.cu", "bucket_counts.cu", "rescore.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures: every pointer (and the stream) as c_void_p, so ctypes never
# truncates one to a 32-bit int
SIGNATURES = {
    # psi, sym_dir, head_pair, n_rows, sigma, dir_shift,
    # token, lo, hi, out_lo, out_hi, n, stream
    "seal_fm_backward_step": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _L, _P],
    # psi, sym_dir, head_pair, n_rows, sigma, dir_shift,
    # tokens, lo, hi, out, n_ranges, m, stream
    "seal_fm_contains": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _L, _I, _P],
    # psi, sym_dir, head_pair, n_rows, sigma, dir_shift,
    # tokens, lengths, out_lo, out_hi, n, L, stream
    "seal_fm_sequences": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _L, _I, _P],
    # bwt, lp, lp_stride, lo, hi, n, w, vocab, fill, tok, valid, lp_out, stream
    "seal_window_gather": [_P, _P, _L, _P, _P, _L, _I, _I, _I, _P, _P, _P, _P],
    # x, n_rows, width, k, vals, idx, stream
    "seal_row_topk": [_P, _L, _I, _I, _P, _P, _P],
    # bwt, bucket_occ, lo, hi, out, n, n_rows, bucket_rows, bucket_size,
    # n_buckets, stream
    "seal_bucket_counts": [_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P],
    # logits, targets, out, n, T, V, n_prefix, stream
    "seal_rescore_logprob": [_P, _P, _P, _L, _I, _I, _I, _P],
}

_LOCK = threading.Lock()
_LIB = None
BUILD_SECONDS = None  # wall time of the last nvcc run in this process


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def build() -> str:
    """Compile the kernel library if it is missing or stale; returns its path.

    One ``nvcc`` per source, all started together, then one link.
    """
    global BUILD_SECONDS
    os.makedirs(BUILD_DIR, exist_ok=True)
    srcs = [os.path.join(CSRC, s) for s in SOURCES]
    out = os.path.join(BUILD_DIR, "libseal_kernels.so")
    if os.path.exists(out) and all(
        os.path.getmtime(out) >= os.path.getmtime(s) for s in srcs
    ):
        return out
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o") for s in srcs]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, s], stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
        for s, o in zip(srcs, objs)
    ]
    errors = []
    for s, p in zip(srcs, procs):
        _, err = p.communicate()
        if p.returncode != 0:
            errors.append(f"{os.path.basename(s)} ({p.returncode}):\n{err[-4000:]}")
    try:
        if errors:
            raise RuntimeError("nvcc failed: " + "\n".join(errors))
        tmp = f"{out}.{tag}"
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    BUILD_SECONDS = time.perf_counter() - t0
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            so = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(so, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = so
        return _LIB


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def stream_ptr(t) -> int:
    """The current CUDA stream of ``t``'s device, as an int for ctypes."""
    return torch.cuda.current_stream(t.device).cuda_stream
