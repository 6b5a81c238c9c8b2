"""Kernel 12 and kernel 16 wrappers: the 16-ary wavelet rank search
(``csrc/wt_search.cu``).

Replaces ``seal_tpu/ops/wt_ops.py``: ``rank`` (:96) with ``_load_block``
(:41), ``_match_nibbles`` (:52), ``_rank_from_block`` (:65) and
``_rank_digit`` (:83), behind ``backward_step`` (:136) -- mode
``"backward_step"`` -- and ``contains_tokens`` (:184) -- mode
``"contains"``; and, through ``wt_sequences``, the scan of backward steps
behind ``range_for_sequences`` (:167) and ``count_sequences`` -- mode
``"sequences"``.  Its step mode, :func:`wt_advance`, is the decode step's
range update after a selection in one launch
(``seal_tpu/decoding/constrained.py:1416-1430``, step 0 :1344-1349); its
plain version, :func:`advance_plain`, is ``ops/_generic.py:
advance_ranges`` over the plain backward step.  The four modes share one
launch counter, ``wt_search.launches``; the step mode's also count on
``ADVANCE``.  Kernel 16, ``wt_dense_counts``, counts every
token of the vocab over each range in one launch and replaces
``seal_tpu/ops/wt_ops.py:dense_counts`` (:237), the chunked
``validate_tokens`` sweep of ``seal_tpu/ops/_generic.py:dense_counts``
(:75); a range of at most ``hist_max`` rows counts its rows' symbols (the
hybrid layout's raw BWT, or the compact layout's descent), a wider one
lists its distinct symbols with their counts by walking the 16-ary tree
top-down, by one block where the whole walk fits the frontier's room
(``WALK_CAP`` nodes), else a block a slice of the vocab (sdsl's
``interval_symbols``; :func:`wt_dense_counts_walk_plain` mirrors it in
numpy).  Its mask mode, :func:`wt_dense_mask`, runs the same routes and
writes the count mask (``kernels/count_mask.py``, a bit a token) that the
``exact_mask`` decode reads.

The plain PyTorch versions below are the specification: the CPU path and
the reference the kernel is held to on the card (integer results, so
exactly equal).  The 32-bit words are widened to int64 and masked, because
``d * 0x11111111`` overflows int32 and torch has no popcount: the
population count is the SWAR one.  The kernel is latency bound: the node
words of all ``digits`` levels (they depend on the symbol alone), then
``digits`` dependent 192-byte blocks; one thread per (query, bound), see
the source.
"""

from __future__ import annotations

import numpy as np
import torch

from seal_tpu_torch.index.fm_index import SHIFT
from seal_tpu_torch.index.wavelet import CODE_WORDS, DIGIT_BITS, RADIX, heap_base
from seal_tpu_torch.kernels import Launches, count_mask
from seal_tpu_torch.ops import _generic

MODES = ("backward_step", "contains")
ADVANCE = Launches()  # wt_search launches in the step mode (wt_advance)
# the digit counts the ranking kernels are built for, one instance each
# (``csrc/wt_common.cuh``): 4 for BART's and T5's vocabs, 5 up to 2^20 - 1
# tokens
MAX_DIGITS = 5
_FN = {}  # kernel 12's C entry points, looked up once
# kernel 16's histogram route up to these many rows (one read a row of the
# hybrid layout's raw BWT, a descent of ``digits`` levels a row without
# it), the walk past them: two block reads a visited node of the tree, at
# most ~550 nodes a block's slice of the vocab.  Chosen by a sweep at the
# generation point on an H100 (``chip_smoke.py``'s "dense counts by
# histogram threshold" line)
HIST_MAX_ROWS = {"hybrid": 1 << 18, "compact": 0}
WALK_CAP = 1024  # frontier nodes the walk holds a block (csrc/wt_search.cu's WALK_CAP)
SLICE = 8192  # tokens a block of kernel 16 counts (csrc/dense_counts.cuh)
_WORD = 0xFFFFFFFF
_ONES = 0x11111111  # bit 0 of each nibble


def load_block(index, level: int, pos):
    """The 48 words of ``pos``'s block on ``level``, as int64 [..., 48]
    holding the uint32 values."""
    return index.blocks[level][(pos >> 8).long()].long() & _WORD


def nibble_bits(x):
    """Set bits of each 32-bit value whose bits lie at nibbles' bit 0 (as
    ``match_nibbles`` gives them): the multiply adds the eight nibbles, each
    0 or 1, into the top one without a carry."""
    return ((x * _ONES) >> 28) & 15


def match_nibbles(w, d):
    """Per code word, the nibble-low bits of the rows whose digit is ``d``:
    XOR with the broadcast digit, OR each nibble down to its bit 0, and
    complement under the lane mask."""
    codes = w[..., RADIX:]
    x = codes ^ (d[..., None].long() * _ONES)
    y = x | (x >> 2)
    y = y | (y >> 1)
    return ~y & _ONES


def rank_from_block(w, pos, d):
    """Count of digit ``d`` in the level sequence before ``pos``, given the
    block words ``w`` (= ``load_block`` at ``pos``)."""
    base = torch.gather(w, -1, d[..., None].long())[..., 0]
    match = match_nibbles(w, d)
    within = (pos & 255).long()
    word_idx = within >> 3
    bit_lim = (within & 7) << 2
    lane = torch.arange(CODE_WORDS, device=w.device)
    # the words before pos's word whole, pos's word below pos, none after:
    # masked first, so one count covers every lane
    keep = torch.where(lane < word_idx[..., None], _WORD,
                       torch.where(lane == word_idx[..., None], (1 << bit_lim[..., None]) - 1, 0))
    return (base + nibble_bits(match & keep).sum(-1)).to(torch.int32)


def digit_at(w, pos):
    """The 4-bit digit of row ``pos`` from its block words."""
    within = (pos & 255).long()
    word = torch.gather(w, -1, (RADIX + (within >> 3))[..., None])[..., 0]
    return ((word >> ((within & 7) << 2)) & 15).to(torch.int32)


def _node_cnt(index, node, d):
    return index.node_cnt[node.long(), d.long()]


def rank_plain(index, symbol, pos, trace=None):
    """Occ(symbol, pos) for *shifted* symbols by the ``digits``-level
    descent; symbols outside [0, sigma) give 0.  A list ``trace`` gets each
    level's (position, node, digit) read."""
    symbol, pos = torch.broadcast_tensors(symbol, pos)
    valid = (symbol >= 0) & (symbol < index.sigma)
    c = torch.where(valid, symbol, 0)
    L = index.digits
    p = pos
    for lvl in range(L):
        node = heap_base(lvl) + (c >> (DIGIT_BITS * (L - lvl)))
        d = (c >> (DIGIT_BITS * (L - 1 - lvl))) & 15
        x = index.node_start[node.long()] + p
        if trace is not None:
            trace.append((x, node, d))
        p = rank_from_block(load_block(index, lvl, x), x, d) - _node_cnt(index, node, d)
    return torch.where(valid, p, 0)


def access_plain(index, rows, trace=None):
    """Shifted BWT symbols at ``rows`` by descent; rows outside [0, N) give
    0.  A list ``trace`` gets each level's (position, node, digit) read."""
    ok = (rows >= 0) & (rows < index.n_rows)
    p = torch.where(ok, rows, 0)
    c = torch.zeros_like(p)
    for lvl in range(index.digits):
        node = heap_base(lvl) + c
        x = index.node_start[node.long()] + p
        w = load_block(index, lvl, x)
        d = digit_at(w, x)
        if trace is not None:
            trace.append((x, node, d))
        p = rank_from_block(w, x, d) - _node_cnt(index, node, d)
        c = (c << DIGIT_BITS) | d
    return torch.where(ok, c, 0)


def backward_step_plain(index, token, lo, hi):
    c = token + SHIFT
    valid = (c >= 1) & (c < index.sigma)
    safe_c = torch.where(valid, c, 0)
    base = index.C[safe_c.long()]
    r = rank_plain(index, torch.stack([safe_c, safe_c], 0), torch.stack([lo, hi], 0))
    new_lo = torch.where(valid, base + r[0], 0)
    new_hi = torch.where(valid, base + r[1], 0)
    return new_lo, torch.maximum(new_lo, new_hi)


def advance_plain(index, sel_tok, sel_par, lo, hi, finished=None, *, eos: int, pad: int):
    """The step mode's plain version: ``ops/_generic.py:advance_ranges``
    over the plain backward step."""
    return _generic.advance_ranges(
        lambda t, a, b: backward_step_plain(index, t, a, b), lambda a, b: b - a,
        sel_tok, sel_par, lo, hi, finished, eos=eos, pad=pad)


def contains_plain(index, tokens, lo, hi):
    shape = tokens.shape
    new_lo, new_hi = backward_step_plain(
        index, tokens, lo[..., None].expand(shape), hi[..., None].expand(shape)
    )
    return new_hi - new_lo > 0


def sequences_plain(index, tokens, lengths):
    """The JAX scan: one backward step per position from the full range;
    positions at or past a sequence's length keep its range."""
    lo, hi = index.full_range(tokens.shape[:-1])
    for t in range(tokens.shape[-1]):
        new_lo, new_hi = backward_step_plain(index, tokens[..., t], lo, hi)
        keep = t < lengths
        lo = torch.where(keep, new_lo, lo)
        hi = torch.where(keep, new_hi, hi)
    return lo, hi


def index_args(index):
    """The wavelet arrays as the C entry points take them."""
    return (
        index.blocks.data_ptr(),
        index.node_start.data_ptr(),
        index.node_cnt.data_ptr(),
        index.C.data_ptr(),
        index.n_blocks,
        index.n_rows,
        index.digits,
        index.sigma,
    )


def check_index(index, name: str) -> None:
    """Refuse arrays the kernels cannot read as they are laid out."""
    for field in ("blocks", "node_start", "node_cnt", "C"):
        a = getattr(index, field)
        if a.dtype != torch.int32 or not a.is_contiguous() or not a.is_cuda:
            raise ValueError(f"{name}: index.{field} must be a contiguous int32 CUDA tensor")
    if index.blocks.data_ptr() % 16:
        raise ValueError(f"{name}: index.blocks must be 16-byte aligned (16-byte code loads)")
    if not 1 <= index.digits <= MAX_DIGITS:
        raise ValueError(f"{name}: {index.digits} digits (the kernels descend 1 to {MAX_DIGITS})")


def _i32(x, device):
    """``x`` as an int32 tensor on ``device``, converted only where it is not."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.int32 or x.device != device:
        x = torch.as_tensor(x, dtype=torch.int32, device=device)
    return x


def _c(x):
    return x if x.is_contiguous() else x.contiguous()


def _lookup():
    if not _FN:
        from seal_tpu_torch.kernels import build

        so = build.lib()
        _FN.update(step=so.seal_wt_backward_step, contains=so.seal_wt_contains,
                   advance=so.seal_wt_advance, stream=build.stream_ptr)


def wt_sequences(index, tokens, lengths):
    """Row ranges of padded token sequences: tokens int32 [..., L]
    (unshifted), lengths int32 [...]; returns int32 (lo, hi) [...].

    CPU tensors run the plain version; CUDA tensors launch kernel 12 in its
    sequences mode.
    """
    tokens = torch.as_tensor(tokens, dtype=torch.int32, device=index.device)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=index.device)
    if tokens.shape[:-1] != lengths.shape:
        raise ValueError(f"wt_sequences: tokens {tuple(tokens.shape)} vs lengths "
                         f"{tuple(lengths.shape)}")
    if not tokens.is_cuda:
        return sequences_plain(index, tokens, lengths)
    from seal_tpu_torch.kernels import build

    check_index(index, "wt_sequences")
    tokens, lengths = tokens.contiguous(), lengths.contiguous()
    out_lo = torch.empty_like(lengths)
    out_hi = torch.empty_like(lengths)
    rc = build.lib().seal_wt_sequences(
        *index_args(index), tokens.data_ptr(), lengths.data_ptr(), out_lo.data_ptr(),
        out_hi.data_ptr(), lengths.numel(), tokens.shape[-1], build.stream_ptr(tokens),
    )
    build.check(rc, "wt_search(sequences)")
    wt_search.launches += 1
    return out_lo, out_hi


def wt_search(index, mode: str, tokens, lo, hi):
    """Wavelet rank search in one of two modes.

    * ``"backward_step"``: tokens, lo, hi broadcast to one shape; returns
      the (new_lo, new_hi) int32 ranges after appending each token.
    * ``"contains"``: tokens [..., M], lo/hi [...]; returns bool [..., M],
      whether each token continues its range.

    CPU tensors run the plain version; CUDA tensors launch kernel 12.
    """
    if mode not in MODES:
        raise ValueError(f"unknown wt_search mode {mode!r}")
    dev = index.device
    tokens, lo, hi = _i32(tokens, dev), _i32(lo, dev), _i32(hi, dev)
    if mode == "backward_step":
        if not tokens.shape == lo.shape == hi.shape:
            tokens, lo, hi = torch.broadcast_tensors(tokens, lo, hi)
    elif tokens.shape[:-1] != lo.shape or lo.shape != hi.shape:
        raise ValueError(f"contains: tokens {tuple(tokens.shape)} vs ranges {tuple(lo.shape)}")
    if not tokens.is_cuda:
        if mode == "backward_step":
            return backward_step_plain(index, tokens, lo, hi)
        return contains_plain(index, tokens, lo, hi)
    check_index(index, f"wt_search({mode})")
    _lookup()
    tokens, lo, hi = _c(tokens), _c(lo), _c(hi)
    stream = _FN["stream"](tokens)
    if mode == "backward_step":
        out = torch.empty((2, *tokens.shape), dtype=torch.int32, device=tokens.device)
        p = out.data_ptr()
        rc = _FN["step"](*index_args(index), tokens.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                         p, p + 4 * tokens.numel(), tokens.numel(), stream)
        out = out.unbind(0)
    else:
        out = torch.empty(tokens.shape, dtype=torch.bool, device=tokens.device)
        rc = _FN["contains"](*index_args(index), tokens.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                             out.data_ptr(), lo.numel(), tokens.shape[-1], stream)
    if rc:
        raise RuntimeError(f"wt_search({mode}): CUDA error {rc}")
    wt_search.launches += 1
    return out


wt_search.launches = 0


def wt_advance(index, sel_tok, sel_par, lo, hi, finished=None, *, eos: int, pad: int):
    """Kernel 12's step mode: the range update after a selection.

    ``sel_tok``, ``sel_par`` [B, K]: each selection's token and parent
    beam; ``lo``, ``hi`` [B, P]: the parents' ranges; ``finished`` [B, P]
    (bool) or None at step 0.  Returns int32 (lo, hi, prev_count) [B, K]:
    the parent's range extended by the token -- (0, 0) where ``finished``
    is given and the token is EOS or PAD or the parent had finished -- and
    the parent's range size.  CPU tensors run :func:`advance_plain`; CUDA
    tensors launch the kernel once.
    """
    if not sel_tok.is_cuda:
        return advance_plain(index, sel_tok, sel_par, lo, hi, finished, eos=eos, pad=pad)
    B, K = sel_tok.shape
    if lo.shape != hi.shape or lo.dim() != 2 or lo.shape[0] != B or sel_par.shape != (B, K):
        raise ValueError(f"wt_advance: selections {tuple(sel_tok.shape)}, parents "
                         f"{tuple(sel_par.shape)}, ranges {tuple(lo.shape)}")
    if finished is not None and (finished.shape != lo.shape or finished.dtype != torch.bool):
        raise ValueError("wt_advance: finished must be bool, shaped as the ranges")
    check_index(index, "wt_advance")
    _lookup()
    sel_tok, sel_par, lo, hi = (
        _c(t if t.dtype == torch.int32 else t.to(torch.int32)) for t in (sel_tok, sel_par, lo, hi))
    out = torch.empty((3, B, K), dtype=torch.int32, device=sel_tok.device)
    p = out.data_ptr()
    rc = _FN["advance"](
        *index_args(index), lo.data_ptr(), hi.data_ptr(), lo.shape[1], sel_par.data_ptr(),
        sel_tok.data_ptr(), _c(finished).data_ptr() if finished is not None else None, eos, pad,
        p, p + 4 * B * K, p + 8 * B * K, B * K, K, _FN["stream"](sel_tok),
    )
    if rc:
        raise RuntimeError(f"wt_advance: CUDA error {rc}")
    wt_search.launches += 1
    ADVANCE.launches += 1
    return out.unbind(0)


def dense_counts_plain(index, lo, hi, chunk: int = 4096):
    """The JAX sweep: ``chunk`` tokens at a time, each counted by one plain
    backward step (``_generic.validate_tokens``)."""
    return _generic.dense_counts(
        lambda ix, toks, a, b: _generic.validate_tokens(backward_step_plain, ix, toks, a, b),
        index, lo, hi, chunk,
    )


def walk_nodes(digits: int, rows: int, c_lo: int, c_hi: int) -> int:
    """Nodes the walk of a range of ``rows`` rows can visit over the
    symbols [c_lo, c_hi): a level-l node is a distinct l-digit prefix of a
    symbol in the range, and the walk keeps the prefixes that meet them."""
    return sum(min(((c_hi - 1) >> (DIGIT_BITS * (digits - lvl)))
                   - (c_lo >> (DIGIT_BITS * (digits - lvl))) + 1, rows)
               for lvl in range(digits))


def _ranks_in_blocks(level_blocks, x, n_rows):
    """Each digit's rank before level positions ``x`` [n]: [n, 16], from
    the directory and the digits of the blocks, read out nibble by nibble."""
    x = np.clip(x, 0, n_rows)
    w = level_blocks[x >> 8]  # [n, 48]
    digits = (w[:, RADIX:, None] >> (DIGIT_BITS * np.arange(8, dtype=np.uint32))) & 15
    before = np.arange(256) < (x & 255)[:, None]  # [n, 256]
    onehot = digits.reshape(len(x), 256, 1) == np.arange(RADIX)
    return w[:, :RADIX].astype(np.int64) + (onehot & before[..., None]).sum(1)


def wt_dense_counts_walk_plain(index, lo, hi):
    """Kernel 16's walk in numpy over the index's arrays: int32 [...,
    vocab].  For each range (each ``SLICE`` of tokens of a range whose
    whole walk could outgrow ``WALK_CAP`` nodes), its distinct symbols
    there level by level from the root: a node (prefix, lo, hi) ranks every
    digit at both bounds, and each digit with a nonzero count whose symbols
    meet the slice becomes a child; the last level's counts go to token
    c - 1 (c in the slice, below ``sigma``).  A slice's walk always fits
    the room (the kernel asserts its node bound)."""
    blocks = index.blocks.cpu().numpy().view(np.uint32)
    node_start = index.node_start.cpu().numpy().astype(np.int64)
    node_cnt = index.node_cnt.cpu().numpy().astype(np.int64)
    L, sigma, vocab, n_rows = index.digits, index.sigma, index.vocab, index.n_rows
    lo_t = torch.as_tensor(lo, dtype=torch.int32)
    hi_t = torch.as_tensor(hi, dtype=torch.int32)
    lo_np, hi_np = lo_t.reshape(-1).numpy(), hi_t.reshape(-1).numpy()
    out = np.zeros((lo_np.size, vocab), np.int32)
    c_all = min(vocab + SHIFT, sigma)
    for r, (a, b) in enumerate(zip(lo_np.tolist(), hi_np.tolist())):
        r0, r1 = min(max(a, 0), n_rows), min(max(b, 0), n_rows)
        if r1 <= r0:
            continue
        # one walk over the whole row where it fits the room, else a slice a walk
        whole = c_all > SHIFT and walk_nodes(L, r1 - r0, SHIFT, c_all) <= WALK_CAP
        for t0 in range(0, vocab, vocab if whole else SLICE):
            t1 = vocab if whole else min(t0 + SLICE, vocab)
            c_lo, c_hi = t0 + SHIFT, min(t1 + SHIFT, sigma)
            if c_hi <= c_lo:
                continue
            pre, flo, fhi = np.zeros(1, np.int64), np.array([r0]), np.array([r1])
            for lvl in range(L):
                node = heap_base(lvl) + pre
                start = node_start[node]
                rl = _ranks_in_blocks(blocks[lvl], start + flo, n_rows) - node_cnt[node]
                rh = _ranks_in_blocks(blocks[lvl], start + fhi, n_rows) - node_cnt[node]
                c = (pre[:, None] << DIGIT_BITS) | np.arange(RADIX)
                below = DIGIT_BITS * (L - 1 - lvl)
                keep = (rh > rl) & ((c << below) < c_hi) & (((c + 1) << below) > c_lo)
                if lvl == L - 1:
                    out[r, c[keep] - SHIFT] = (rh - rl)[keep]
                else:
                    pre, flo, fhi = c[keep], rl[keep], rh[keep]
    return torch.as_tensor(out).reshape(*lo_t.shape, vocab)


def wt_dense_counts(index, lo, hi, chunk: int = 4096, hist_max=None):
    """Continuation count of every token ``0..index.vocab-1`` over ranges
    [lo, hi): int32 [..., vocab].

    CPU tensors run the plain version, ``chunk`` tokens at a time; CUDA
    tensors launch kernel 16 once for the whole vocab (``chunk`` has no
    effect there), which histograms ranges of at most ``hist_max`` rows
    (default: the layout's ``HIST_MAX_ROWS``) and walks the wider ones, by
    one block where the whole walk fits ``WALK_CAP`` nodes, else a block a
    ``SLICE`` of tokens.
    """
    return _dense(index, lo, hi, chunk, hist_max, "wt_dense_counts")


wt_dense_counts.launches = 0


def dense_mask_plain(index, lo, hi, chunk: int = 4096):
    """``pack(dense_counts_plain(...) > 0)``, packed a chunk at a time."""
    return _generic.dense_mask(
        lambda ix, toks, a, b: _generic.validate_tokens(backward_step_plain, ix, toks, a, b),
        index, lo, hi, chunk,
    )


def wt_dense_mask(index, lo, hi, chunk: int = 4096, hist_max=None):
    """Kernel 16's mask mode: the count mask of ranges [lo, hi), int32
    [..., count_mask.words(index.vocab)], bit t set iff token t continues
    the range; :func:`wt_dense_counts`' routes, a bit a token stored.

    CPU tensors run the plain version, ``chunk`` tokens at a time; CUDA
    tensors launch the kernel once.
    """
    return _dense(index, lo, hi, chunk, hist_max, "wt_dense_mask")


wt_dense_mask.launches = 0


def _dense(index, lo, hi, chunk, hist_max, name):
    mask = name == "wt_dense_mask"
    lo = torch.as_tensor(lo, dtype=torch.int32, device=index.device)
    hi = torch.as_tensor(hi, dtype=torch.int32, device=index.device)
    if lo.shape != hi.shape:
        raise ValueError(f"{name}: lo {tuple(lo.shape)} vs hi {tuple(hi.shape)}")
    if not lo.is_cuda:
        return (dense_mask_plain if mask else dense_counts_plain)(index, lo, hi, chunk)
    from seal_tpu_torch.kernels import build

    check_index(index, name)
    bwt, bwt_bytes = None, 0
    if index.bwt is not None:
        if index.bwt.dtype not in (torch.int16, torch.int32) or not index.bwt.is_contiguous():
            raise ValueError(f"{name}: index.bwt must be contiguous int16 or int32")
        bwt, bwt_bytes = index.bwt.data_ptr(), index.bwt.element_size()
    if hist_max is None:
        hist_max = HIST_MAX_ROWS["hybrid" if bwt is not None else "compact"]
    lo, hi = lo.contiguous(), hi.contiguous()
    width = count_mask.words(index.vocab) if mask else index.vocab
    out = torch.empty((*lo.shape, width), dtype=torch.int32, device=lo.device)
    fn = build.lib().seal_wt_dense_mask if mask else build.lib().seal_wt_dense_counts
    rc = fn(*index_args(index), bwt, bwt_bytes, lo.data_ptr(), hi.data_ptr(), out.data_ptr(),
            lo.numel(), index.vocab, hist_max, build.stream_ptr(lo))
    build.check(rc, name)
    (wt_dense_mask if mask else wt_dense_counts).launches += 1
    return out
