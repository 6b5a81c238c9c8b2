"""Kernel 4: f32 row log-softmax with the min-length EOS ban, in Triton.

Replaces ``seal_tpu/decoding/constrained.py:_log_softmax`` (:276) and
``_apply_min_length`` (:297), and with a per-row threshold the mask of the
top-k warper (``_apply_topk_warper`` :289-294: logits below the row's k-th
value, from kernel 19, become ``fill`` before the max and the sum; launches
in that mode also count on ``THRESHOLD``).  One program per row: a max pass, a sum-exp
pass and a write pass over the row in 8192-wide blocks with 16 warps.  It
reads the [rows, V] f32 logits three times and writes them once; a row
(201 KB) mostly stays in L2 between its passes, so the device-memory
traffic is ~one read and one write (~190 MB per decode step at batch 32 x
beam 15), and the rest is latency: wide blocks keep more loads in flight
per program.  (Measured on the H100 at [480, 50265]: 8192 x 16 warps beat
the other 4096/2048/1024-wide and 4/8-warp variants, and a one-pass online
max/sum variant.)  The
kernel agrees with the plain version to f32 rounding only: the row sums
are taken in another order.

``triton`` is imported when the kernel is first launched, never when this
module is imported (the CPU tests import it).
"""

from __future__ import annotations

import functools
import os

import torch

from seal_tpu_torch.kernels import Launches

BLOCK = 8192
NUM_WARPS = 16
THRESHOLD = Launches()  # kernel 4 launches with a warper threshold


def log_softmax_ban_plain(logits, ban_col: int, fill: float, threshold=None):
    x = logits.float()
    if threshold is not None:
        x = torch.where(x < threshold[:, None], fill, x)
    lp = torch.log_softmax(x, dim=-1)
    if ban_col >= 0:
        lp[:, ban_col] = fill
    return lp


@functools.cache
def _kernel():
    global triton, tl
    from seal_tpu_torch.kernels.build import BUILD_DIR

    # keep Triton's compile cache beside the CUDA build, inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(BUILD_DIR, "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def log_softmax_rows(x_ptr, out_ptr, th_ptr, n_cols, x_stride, ban_col, fill,
                         BLOCK: tl.constexpr, HAS_TH: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        x_row = x_ptr + row * x_stride
        o_row = out_ptr + row * n_cols
        offs = tl.arange(0, BLOCK)
        th = 0.0
        if HAS_TH:
            th = tl.load(th_ptr + row)
        m = tl.full([BLOCK], float("-inf"), tl.float32)
        for start in range(0, n_cols, BLOCK):
            cols = start + offs
            x = tl.load(x_row + cols, mask=cols < n_cols, other=float("-inf")).to(tl.float32)
            if HAS_TH:
                x = tl.where(x < th, fill, x)
            m = tl.maximum(m, x)
        mx = tl.max(m, 0)
        s = tl.zeros([BLOCK], tl.float32)
        for start in range(0, n_cols, BLOCK):
            cols = start + offs
            x = tl.load(x_row + cols, mask=cols < n_cols, other=float("-inf")).to(tl.float32)
            if HAS_TH:
                x = tl.where(x < th, fill, x)
            s += tl.exp(x - mx)
        log_s = tl.log(tl.sum(s, 0))
        for start in range(0, n_cols, BLOCK):
            cols = start + offs
            x = tl.load(x_row + cols, mask=cols < n_cols, other=0.0).to(tl.float32)
            if HAS_TH:
                x = tl.where(x < th, fill, x)
            y = (x - mx) - log_s
            y = tl.where(cols == ban_col, fill, y)
            tl.store(o_row + cols, y, mask=cols < n_cols)

    return log_softmax_rows


def log_softmax_ban(logits, ban_col: int, fill: float, threshold=None):
    """f32 log-softmax over the last axis of ``logits`` [rows, V], with
    column ``ban_col`` set to ``fill`` (``ban_col`` -1: no ban).  With
    ``threshold`` (f32 [rows]), the logits of a row below its threshold are
    ``fill`` before the log-softmax (the top-k warper).

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    if not logits.is_cuda:
        return log_softmax_ban_plain(logits, ban_col, fill, threshold)
    if logits.dim() != 2 or logits.stride(1) != 1:
        raise ValueError("log_softmax_ban: 2-D logits with unit column stride required")
    rows, n = logits.shape
    if threshold is not None and (threshold.shape != (rows,) or threshold.dtype != torch.float32
                                  or not threshold.is_cuda):
        raise ValueError("log_softmax_ban: the threshold must be a CUDA f32 tensor [rows]")
    out = torch.empty((rows, n), dtype=torch.float32, device=logits.device)
    if rows:
        th = threshold.contiguous() if threshold is not None else out
        _kernel()[(rows,)](
            logits, out, th, n, logits.stride(0), ban_col, fill, BLOCK=BLOCK,
            HAS_TH=threshold is not None, num_warps=NUM_WARPS
        )
        log_softmax_ban.launches += 1
        THRESHOLD.launches += int(threshold is not None)
    return out


log_softmax_ban.launches = 0
