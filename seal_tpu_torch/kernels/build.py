"""Build and load the CUDA kernels (``csrc/*.cu``) as one shared library.

The sources compile with ``nvcc`` for ``sm_90a`` into a library with a plain
C interface that ``ctypes`` loads: a build takes seconds, where a
PyTorch-extension build that includes the torch headers takes minutes.  The
library is built at first use into ``kernels/_build/`` and rebuilt when a
source is newer than it (the scheme of ``seal_tpu/cpp/native.py``).

Every C entry point launches on the stream it is given, allocates nothing
and returns ``cudaGetLastError()``; :func:`check` turns a non-zero code into
an exception.

    python -m seal_tpu_torch.kernels.build --ptxas SOURCE [MATCH [THREADS]]

prints ``nvcc -Xptxas -v``'s resources of each kernel instance of a source
(:func:`ptxas_report`), one JSON line each.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("fm_search.cu", "window_gather.cu", "row_topk.cu", "bucket_counts.cu", "rescore.cu",
           "beam_select.cu", "decode_attention.cu", "reorder_cache.cu", "wt_search.cu",
           "wt_window.cu", "wt_bucket_counts.cu", "dense_scores.cu", "locate.cu",
           "row_select.cu", "sample_select.cu", "diverse_select.cu", "train_loss.cu", "adamw.cu")
# included by the wt_*.cu sources, by fm_search.cu and wt_search.cu, by
# beam_select.cu, diverse_select.cu and row_topk.cu, by beam_select.cu and
# row_topk.cu, by row_topk.cu, row_select.cu, dense_scores.cu,
# diverse_select.cu and sample_select.cu, and by dense_scores.cu and
# sample_select.cu
HEADERS = ("wt_common.cuh", "dense_counts.cuh", "select_common.cuh", "global_sort.cuh",
           "radix_topk.cuh", "dense_branches.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_WT = [_P, _P, _P, _P, _L, _I, _I, _I]  # a wavelet index (kernels/wt_search.py:index_args)
# C signatures: every pointer (and the stream) as c_void_p, so ctypes never
# truncates one to a 32-bit int
SIGNATURES = {
    # psi, sym_dir, head_pair, n_rows, sigma, dir_shift,
    # token, lo, hi, out_lo, out_hi, n, group (lanes an item), stream
    "seal_fm_backward_step": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _L, _I, _P],
    # psi, sym_dir, head_pair, n_rows, sigma, dir_shift,
    # tokens, lo, hi, out, n_ranges, m, group, stream
    "seal_fm_contains": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _L, _I, _I, _P],
    # psi, sym_dir, head_pair, n_rows, sigma, dir_shift, lo, hi, P (parents a
    # query), sel_par, sel_tok, finished (None: step 0), eos, pad, out_lo,
    # out_hi, out_count, n (selections), n_sel (a query's), group, stream
    "seal_fm_advance": [_P, _P, _P, _I, _I, _I, _P, _P, _I, _P, _P, _P, _I, _I, _P, _P, _P, _L,
                        _I, _I, _P],
    # psi, sym_dir, head_pair, n_rows, sigma, dir_shift,
    # tokens, lengths, out_lo, out_hi, n, L, group (lanes a sequence), stream
    "seal_fm_sequences": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _L, _I, _I, _P],
    # psi, sym_dir, head_pair, n_rows, sigma, dir_shift,
    # bwt, lo, hi, out, n, vocab, hist_max, stream
    "seal_fm_dense_counts": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _L, _I, _I, _P],
    # the mask mode: the same arguments, out [n, 4 * ceil(vocab / 128)]
    "seal_fm_dense_mask": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _L, _I, _I, _P],
    # the shard modes take a sharded index as psi, sym_dir, n_max (row
    # stride), sigma (sym_dir rows a shard), n_shards
    # (kernels/fm_search.py:_shard_args), then
    # token, lo, hi, out_lo, out_hi, n (ranges a shard), group (lanes a
    # (shard, range)), team (groups a range), stream
    "seal_fm_backward_step_sharded": [_P, _P, _L, _I, _I, _P, _P, _P, _P, _P, _L, _I, _I, _P],
    # tokens, lo, hi, out, n_ranges, m, count (0 membership, 1 counts),
    # group, team, stream
    "seal_fm_contains_sharded": [_P, _P, _L, _I, _I, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P],
    # the step mode: lo, hi, P (parents a query), sel_par, sel_tok, finished
    # (None: step 0), eos, pad, out_lo, out_hi, out_count, n (selections),
    # n_sel (a query's), group, team, stream
    "seal_fm_advance_sharded": [_P, _P, _L, _I, _I, _P, _P, _I, _P, _P, _P, _I, _I, _P, _P, _P,
                                _L, _I, _I, _I, _P],
    # n_rows, tokens, lengths, out_lo, out_hi, out_count (None: ranges), n,
    # L, group (lanes a (shard, sequence)), team (groups a sequence in the
    # count mode), stream
    "seal_fm_sequences_sharded": [_P, _P, _L, _I, _I, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I,
                                  _P],
    # bwt, lo, hi, out, n, vocab, hist_max, stream
    "seal_fm_dense_counts_sharded": [_P, _P, _L, _I, _I, _P, _P, _P, _P, _L, _I, _I, _P],
    # bwt, lo, hi, out (the mask, ORed over the shards), n, vocab, hist_max,
    # stream
    "seal_fm_dense_mask_sharded": [_P, _P, _L, _I, _I, _P, _P, _P, _P, _L, _I, _I, _P],
    # bwt, n_max (a shard's row stride; 0 for one index), n_shards, lp,
    # lp_stride, lo, hi, n (ranges a shard), w (0: no window), width (0: no
    # slab), rows_prev, vocab, fill_win, the window's tok, valid, lp, the
    # slab's tok, valid, lp (None where skipped), stream
    "seal_window_slab": [_P, _L, _I, _P, _L, _P, _P, _L, _I, _I, _I, _I, _I] + [_P] * 7,
    # x, n_rows, width, k, threads, splits, slice, staged, cap, n2, region,
    # smem (kernels/row_topk.py:plan), scratch (None: the shared sort), vals,
    # idx, stream
    "seal_row_topk": [_P, _L, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    # lp, bits, th_lp, th_ix, n_rows, width, k, bucket_size, neg_inf, the
    # layout (as seal_row_topk's), scratch, vals, idx, stream
    "seal_pruned_topk": [_P, _P, _P, _P, _L, _I, _I, _I, _F] + [_I] * 8 + [_P, _P, _P, _P],
    # bwt, bucket_occ, lo, hi, out, n, n_rows, bucket_rows, bucket_size,
    # n_buckets, stream
    "seal_bucket_counts": [_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P],
    # bwt, bucket_occ, n_max, occ_rows, n_shards, lo, hi, out, n,
    # bucket_rows, bucket_size, n_buckets, stream
    "seal_bucket_counts_sharded": [_P, _P, _L, _I, _I, _P, _P, _P, _L, _I, _I, _I, _P],
    # the support modes: the same arguments, out [n, 8] words (the shard
    # mode also each shard's own rows [S] after n_shards)
    "seal_bucket_support": [_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P],
    "seal_bucket_support_sharded": [_P, _P, _L, _I, _I, _P, _P, _P, _P, _L, _I, _I, _I, _P],
    # logits, targets, out, n, T, V, n_prefix, stream
    "seal_rescore_logprob": [_P, _P, _P, _L, _I, _I, _I, _P],
    # buf_tok, buf_lp, buf_valid, top_tok, top_lp, top_ok, top_stride,
    # top_ok_stride, slab_tok, slab_lp, slab_ok, n_top, n_slab, in_tok, in_lp,
    # in_ok, in_slot (None: the first pass), rows, width, chunk, n_buf, vocab,
    # ties, neg_inf, out_tok, out_lp, out_ok, out_slot (None: the last pass),
    # stream
    "seal_beam_merge": [_P, _P, _P, _P, _P, _P, _L, _L, _P, _P, _P, _I, _I, _P, _P, _P, _P,
                        _L, _I, _I, _I, _I, _I, _F, _P, _P, _P, _P, _P],
    # buf_tok, buf_lp, buf_valid, top_tok, top_lp, top_ok, top_stride,
    # top_ok_stride, slab_tok, slab_lp, slab_ok, n_top, n_slab, rows, n_buf,
    # vocab, ties, neg_inf, table, keys, n2, out_tok, out_lp, out_ok, stream
    "seal_beam_merge_table": [_P, _P, _P, _P, _P, _P, _L, _L, _P, _P, _P, _I, _I, _L, _I, _I, _I,
                              _F, _P, _P, _I, _P, _P, _P, _P],
    # buf_tok, buf_lp, buf_valid, win_tok, win_valid, win_lp, eos_ok,
    # eos_ok_stride, lp, lp_stride, prev_count, finished, beam_scores, need,
    # th_lp, n_queries, n_par, n_buf, w, k, eos, pad, stop_at_count,
    # always_allow_eos, tie_bits (0: no ties mode), keep_invalid, neg_inf,
    # route (kernels/beam_select.py:_ROUTE_CODES), vocab (the table's width),
    # chunk (the table route's candidates a CTA; the wide route's hash table
    # entries a beam), splits (the wide route's CTAs a query, a cluster; else
    # ignored), 9 outputs, unsound, scratch
    # keys and slots, table (None where the route needs none), stream
    "seal_beam_select": [_P, _P, _P, _P, _P, _P, _P, _L, _P, _L, _P, _P, _P, _P, _P, _L, _I, _I,
                         _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I] + [_P] * 14,
    # top_cons, top_idx, lp, lp_stride, beam_scores, bs_stride, table (None:
    # token = slot % V), n_queries, n_par, ncand, k, eos, neg_inf, 9 outputs,
    # scratch (None: the picks in shared memory), stream
    "seal_beam_select_top": [_P, _P, _P, _L, _P, _L, _P, _L, _I, _I, _I, _I, _F] + [_P] * 11,
    # q, k, v, bias, rel_table, rel_bf16, rel_bucket, out, n_queries, group,
    # heads, m, head_dim, q_stride, kv_row_stride, bias_stride, dtype (0 f32,
    # 1 bf16), route (kernels/decode_attention.py:ROUTE_CODES), heads a CTA,
    # stream
    "seal_decode_attention": [_P, _P, _P, _P, _P, _I, _P, _P, _L, _I, _I, _I, _I, _L, _L, _L,
                              _I, _I, _I, _P],
    # table (host array of 2*n_tensors pointers), n_tensors, index, rows,
    # src_rows, copy_bytes, row_bytes, stream
    "seal_reorder_cache": [_P, _I, _P, _L, _L, _L, _L, _P],
    # the wavelet index (blocks, node_start, node_cnt, C, n_blocks, n_rows,
    # digits, sigma), then token, lo, hi, out_lo, out_hi, n, stream
    "seal_wt_backward_step": _WT + [_P, _P, _P, _P, _P, _L, _P],
    # the wavelet index, tokens, lo, hi, out, n_ranges, m, stream
    "seal_wt_contains": _WT + [_P, _P, _P, _P, _L, _I, _P],
    # the wavelet index, lo, hi, P (parents a query), sel_par, sel_tok,
    # finished (None: step 0), eos, pad, out_lo, out_hi, out_count, n
    # (selections), n_sel (a query's), stream
    "seal_wt_advance": _WT + [_P, _P, _I, _P, _P, _P, _I, _I, _P, _P, _P, _L, _I, _P],
    # the wavelet index, tokens, lengths, out_lo, out_hi, n, L, stream
    "seal_wt_sequences": _WT + [_P, _P, _P, _P, _L, _I, _P],
    # the wavelet index, bwt (None: descent), bwt_bytes, lp, lp_stride, lo,
    # hi, n, w, width, rows_prev, vocab, fill_win, the window's tok, valid,
    # lp and the slab's (None where its width is 0), stream
    "seal_wt_window_slab": _WT + [_P, _I, _P, _L, _P, _P, _L, _I, _I, _I, _I, _I] + [_P] * 7,
    # the wavelet index, lo, hi, out, n, depth, stream
    "seal_wt_bucket_counts": _WT + [_P, _P, _P, _L, _I, _P],
    "seal_wt_bucket_support": _WT + [_P, _P, _P, _L, _I, _P],
    # the wavelet index, bwt (None: descent), bwt_bytes, lo, hi, out, n,
    # vocab, hist_max, stream
    "seal_wt_dense_counts": _WT + [_P, _I, _P, _P, _P, _L, _I, _I, _P],
    # the same arguments, out the mask [n, 4 * ceil(vocab / 128)]
    "seal_wt_dense_mask": _WT + [_P, _I, _P, _P, _P, _L, _I, _I, _P],
    # counts, lp, lp_stride, prev_count, finished, beam_scores, rows, V, eos,
    # pad, stop_at_count, always_allow_eos, neg_inf, out, stream
    "seal_dense_scores": [_P, _P, _L, _P, _P, _P, _L, _I, _I, _I, _I, _I, _F, _P, _P],
    # counts, lp, prev_count, finished, beam_scores, n_queries, K, V, eos, pad,
    # stop_at_count, always_allow_eos, neg_inf, k, the select's layout
    # (kernels/row_topk.py:Plan.launch), vals, idx, stream
    "seal_dense_select": [_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _F, _I] + [_I] * 8
                         + [_P, _P, _P],
    # table (sa or beginnings), n_table, in, n, search (0 gather, 1 search),
    # out, stream
    "seal_locate": [_P, _I, _P, _L, _I, _P, _P],
    # x, n_rows, width, k, the layout (kernels/row_topk.py:Plan.launch of
    # plan(..., kth=True)), kth, stream
    "seal_row_kth": [_P, _L, _I, _I] + [_I] * 8 + [_P, _P],
    # x, n_rows, width, k, the layout (as seal_row_kth's), ban column (-1:
    # none), fill, out, stream
    "seal_topk_log_softmax": [_P, _L, _I, _I] + [_I] * 8 + [_I, _F, _P, _P],
    # buf_tok, buf_lp, buf_valid, win_tok, win_valid, win_lp, eos_ok,
    # eos_ok_stride, lp, lp_stride, prev_count, finished, rows, n_buf, w, eos,
    # pad, stop_at_count, always_allow_eos, keep_invalid, neg_inf, table
    # (None: the dedup in a warp's shared memory), vocab, tok, cons, cand_lp,
    # stream
    "seal_beam_candidates": [_P, _P, _P, _P, _P, _P, _P, _L, _P, _L, _P, _P, _L, _I, _I, _I, _I,
                             _I, _I, _I, _F, _P, _I, _P, _P, _P, _P],
    # cons, cand_lp, tokens (None: token = column), mask (None), beam_scores,
    # rows, K, N, seed, step, row_offset, eos, pad, neg_inf, splits (0: the
    # warp route; kernels/sample_select.py:Plan.code), 8 outputs, stream
    "seal_sample_select": [_P, _P, _P, _P, _P, _L, _I, _I, _L, _L, _L, _I, _I, _F, _I]
                          + [_P] * 9,
    # counts, lp, lp_stride, prev_count, finished, beam_scores, rows, K, V,
    # eos, pad, stop_at_count, always_allow_eos, seed, step, row_offset,
    # neg_inf, splits, 8 outputs, stream
    "seal_sample_counts": [_P, _P, _L, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _L, _L, _L, _F,
                           _I] + [_P] * 9,
    # rows, n, seed, step, row_offset, words, g, stream
    "seal_gumbel_noise": [_L, _I, _L, _L, _L, _P, _P, _P],
    # cons, tokens (None: token = column), mask (None), beam_scores, n_queries,
    # K, N, G, eos, tie_bits (0: lax.top_k's order), penalize, penalty,
    # neg_inf, part_key, part_slot, 8 outputs, stream
    "seal_diverse_select": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _F, _F, _P, _P]
                           + [_P] * 9,
    # cons, tokens, beam_scores, n_queries, K, N, G, eos, tie_bits, penalize,
    # penalty, neg_inf, 8 outputs, stream
    "seal_diverse_list": [_P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _F, _F] + [_P] * 9,
    # cons, mask (None), beam_scores, n_queries, K, N, G, eos, tie_bits,
    # penalize, penalty, neg_inf, M, launch 1's layout (kernels/row_topk.py:
    # Plan.launch), top_val, top_idx, 8 outputs, stream
    "seal_diverse_wide": [_P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _F, _F, _I]
                         + [_I] * 8 + [_P] * 11,
    # out (int [1] on the host): the wide route's proof counter on the
    # current device
    "seal_diverse_proof_failures": [_P],
    # logits, targets, n, V, pad, eps, lse, row_loss (scratch), loss, ntok,
    # stream
    "seal_nll_forward": [_P, _P, _L, _I, _I, _F, _P, _P, _P, _P, _P],
    # logits, targets, lse, ntok, gout, n, V, pad, eps, grad, stream
    "seal_nll_backward": [_P, _P, _P, _P, _P, _L, _I, _I, _F, _P, _P],
    # g (host array of n_tensors pointers), sizes, n_tensors, partial
    # (scratch), norm, stream
    "seal_adamw_norm": [_P, _P, _I, _P, _P, _P],
    # p, g, mu, nu (host arrays of n_tensors pointers), sizes, n_tensors,
    # norm, max_norm, c1, b1, c2, b2, bc1, bc2, eps, wd, neg_lr
    # (kernels/adamw.py:Hyper), stream
    "seal_adamw_update": [_P, _P, _P, _P, _P, _I, _P] + [_F] * 10 + [_P],
}
# C functions that return a size rather than an error code
SIZE_QUERIES = {"seal_beam_merge_smem": [_I, _I], "seal_beam_select_smem": [_I, _I, _I, _I],
                "seal_beam_select_large_smem": [_I, _I, _I, _I, _I],
                "seal_beam_select_warp_smem": [_I, _I, _I, _I, _I],
                "seal_beam_select_table_smem": [_I, _I, _I, _I, _I, _I],
                "seal_beam_select_wide_smem": [_I, _I, _I, _I, _I, _I],
                "seal_row_topk_max_k": [], "seal_row_topk_bins_bytes": [],
                "seal_diverse_chunks": [_I], "seal_diverse_smem": [_I, _I, _I],
                "seal_diverse_list_smem": [_I, _I, _I], "seal_adamw_max_tensors": [],
                "seal_adamw_blocks": [_P, _I]}

# shared memory one block may opt into on Hopper (the wrappers refuse shapes
# that need more)
SMEM_LIMIT = 227 * 1024

# an SM's registers and threads (sm_90), and the registers a warp is
# allocated in: they bound the blocks an SM holds (ptxas_report)
SM_REGISTERS = 65536
SM_THREADS = 2048
WARP_REGISTER_UNIT = 256

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
    deps = srcs + [os.path.join(CSRC, h) for h in HEADERS]
    if os.path.exists(out) and all(
        os.path.getmtime(out) >= os.path.getmtime(s) for s in deps
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
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            so = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(so, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            for name, argtypes in SIZE_QUERIES.items():
                fn = getattr(so, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_longlong
            _LIB = so
        return _LIB


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def stream_ptr(t) -> int:
    """The current CUDA stream of ``t``'s device, as an int for ctypes: the
    raw handle ``torch.cuda.current_stream(t.device).cuda_stream`` names (a
    side stream's, or the capturing stream's under ``torch.cuda.graph``),
    read without building a ``Stream`` object."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def ptxas_report(source: str, match: str = "", threads: int = 0) -> list[dict]:
    """``nvcc -Xptxas -v``'s resources of each kernel instance of ``source``
    (a file of ``csrc``) whose mangled name holds ``match``: its template's
    integer arguments, registers a thread, stack frame and spill stores and
    loads (bytes a thread) and, given ``threads`` a block, the blocks of
    that size an SM's registers and threads allow."""
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                               os.path.join(tmp, "k.o"), os.path.join(CSRC, source)],
                              capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    entries, frames, entry, fn = {}, {}, None, None
    for line in (proc.stdout + proc.stderr).splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            entry = m.group(1)
        elif m := re.search(r"Function properties for (\S+)", line):
            fn = m.group(1)
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                            r"(\d+) bytes spill loads", line):
            frames[fn] = [int(x) for x in m.groups()]
        elif (m := re.search(r"Used (\d+) registers", line)) and entry is not None:
            entries[entry] = int(m.group(1))
    rows = []
    for name, regs in entries.items():
        if match not in name:
            continue
        stack, stores, loads = frames.get(name, [0, 0, 0])
        t = re.search(r"I((?:Li-?\d+E)+)E", name)
        row = dict(kernel=name, template=[int(x) for x in re.findall(r"Li(-?\d+)E", t.group(1))]
                   if t else [], registers=regs, stack_bytes=stack, spill_store_bytes=stores,
                   spill_load_bytes=loads)
        if threads:
            per_warp = -(-regs * 32 // WARP_REGISTER_UNIT) * WARP_REGISTER_UNIT
            row["blocks_an_sm"] = min(SM_THREADS // threads,
                                      SM_REGISTERS // (threads // 32 * per_warp))
        rows.append(row)
    return rows


if __name__ == "__main__":
    if len(sys.argv) < 3 or sys.argv[1] != "--ptxas":
        sys.exit("usage: python -m seal_tpu_torch.kernels.build --ptxas SOURCE [MATCH [THREADS]]")
    for r in ptxas_report(sys.argv[2], *sys.argv[3:4], *[int(x) for x in sys.argv[4:5]]):
        print(json.dumps(r))
