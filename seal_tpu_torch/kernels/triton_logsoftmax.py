"""Kernel 4: f32 row log-softmax with the min-length EOS ban, in Triton.

Replaces ``seal_tpu/decoding/constrained.py:_log_softmax`` (:276) and
``_apply_min_length`` (:297).  (With the top-k warper the step takes
``row_select.topk_log_softmax`` instead, one launch for the k-th value, the
mask and the log-softmax; the plain version here keeps the warper's
``threshold``, which that kernel's plain version passes.)  One program per
row: a max pass, a sum-exp pass and a write pass over the row in
8192-wide blocks with 16 warps.  It
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

BLOCK = 8192
NUM_WARPS = 16


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
    def log_softmax_rows(x_ptr, out_ptr, n_cols, x_stride, ban_col, fill, BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        x_row = x_ptr + row * x_stride
        o_row = out_ptr + row * n_cols
        offs = tl.arange(0, BLOCK)
        m = tl.full([BLOCK], float("-inf"), tl.float32)
        for start in range(0, n_cols, BLOCK):
            cols = start + offs
            x = tl.load(x_row + cols, mask=cols < n_cols, other=float("-inf")).to(tl.float32)
            m = tl.maximum(m, x)
        mx = tl.max(m, 0)
        s = tl.zeros([BLOCK], tl.float32)
        for start in range(0, n_cols, BLOCK):
            cols = start + offs
            x = tl.load(x_row + cols, mask=cols < n_cols, other=float("-inf")).to(tl.float32)
            s += tl.exp(x - mx)
        log_s = tl.log(tl.sum(s, 0))
        for start in range(0, n_cols, BLOCK):
            cols = start + offs
            x = tl.load(x_row + cols, mask=cols < n_cols, other=0.0).to(tl.float32)
            y = (x - mx) - log_s
            y = tl.where(cols == ban_col, fill, y)
            tl.store(o_row + cols, y, mask=cols < n_cols)

    return log_softmax_rows


def log_softmax_ban(logits, ban_col: int, fill: float):
    """f32 log-softmax over the last axis of ``logits`` [rows, V], with
    column ``ban_col`` set to ``fill`` (``ban_col`` -1: no ban).

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    if not logits.is_cuda:
        return log_softmax_ban_plain(logits, ban_col, fill)
    if logits.dim() != 2 or logits.stride(1) != 1:
        raise ValueError("log_softmax_ban: 2-D logits with unit column stride required")
    rows, n = logits.shape
    out = torch.empty((rows, n), dtype=torch.float32, device=logits.device)
    if rows:
        _kernel()[(rows,)](logits, out, n, logits.stride(0), ban_col, fill, BLOCK=BLOCK,
                           num_warps=NUM_WARPS)
        log_softmax_ban.launches += 1
    return out


log_softmax_ban.launches = 0
