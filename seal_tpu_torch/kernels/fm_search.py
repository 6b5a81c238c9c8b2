"""Kernel 1, kernel 5 and kernel 15 wrappers: the FM-index rank search
(``csrc/fm_search.cu``).

Kernel 1, ``fm_search``, replaces ``seal_tpu/ops/fm_ops.py``:
``_symbol_bounds`` (:113), ``_searchsorted_impl`` (:42), ``backward_step``
(:166) and ``contains_tokens`` (:288).  Kernel 5, ``fm_sequences``, chains
the backward step over padded token sequences in one launch and replaces
``seal_tpu/ops/_generic.py:range_for_sequences`` (:17), the scan behind
``fm_ops.range_for_sequences`` and ``count_sequences``.  Kernel 15,
``fm_dense_counts``, counts every token of the vocab over each range in one
launch and replaces ``seal_tpu/ops/fm_ops.py:dense_counts`` (:339), the
chunked ``validate_tokens`` sweep of ``seal_tpu/ops/_generic.py:
dense_counts`` (:75).  The plain PyTorch versions below are the
specification: the CPU path and the reference the card's kernels are held
to (integer results, so exactly equal).  Kernels 1 and 5 are latency
bound: a chain of dependent psi loads per query.  Kernel 1's Psi modes
search cooperatively, a group of ``GROUP`` lanes an item loading as many
pivots a level (see the source); kernel 5 runs the same search a position
at a time, a group a sequence (a (shard, sequence) in its shard mode, a
sequence's shards side by side), every group of a warp in step (no split
warp), the group's width chosen by :func:`sequences_plan` from the grid
against the card's SMs; kernel 1's shard modes take a team of groups an
item, a group a shard (:func:`shard_plan`; membership may take one lane a
shard).
Kernel 1's step mode, :func:`fm_advance`,
is the decode step's range update after a selection in one launch
(``seal_tpu/decoding/constrained.py:1416-1430``, step 0 :1344-1349); its
plain version, :func:`advance_plain`, is the composition the other
layouts run (``ops/_generic.py:advance_ranges``).  Its launches count on
``fm_search`` and on ``ADVANCE``.  Kernel 15 is bound by its
[ranges, vocab] output; a range of at most ``HIST_MAX_ROWS`` rows counts
its BWT rows (``csrc/dense_counts.cuh``).

Each kernel has a shard mode over a :class:`ShardedTorchIndex`
(``seal_tpu_torch/parallel/sharded_index.py``: shard-major stacked arrays,
ranges [S, ...]) for ``seal_tpu/parallel/sharded_decode.py:
ShardedIndexOps`` (:48-148) and ``sharded_index.py`` (:401-483):
``fm_search_sharded`` (kernel 1: per-shard backward steps; membership ORed
or counts summed over the shards, ``contains`` :95 / ``validate`` :91),
``fm_advance_sharded`` (kernel 1's step mode over the shards: the range
update, ``constrained.py:1416-1430`` over ``extend`` :120 and the summed
``range_size`` :123, counted on ``ADVANCE_SHARDED``; the backward step on
``STEP_SHARDED``),
``fm_sequences_sharded`` (kernel 5: per-shard sequence ranges, or their
summed counts, ``_range_scan`` :401 / ``sharded_count_sequences`` :455;
the shards side by side, a sequence's shards in one warp) and
``fm_dense_counts_sharded`` (kernel 15: the count vectors summed,
``dense_counts`` :147).  One launch per call whatever the shard count:
the JAX ``psum`` is a loop over the shard axis inside the kernel.  Their
plain versions run the plain version above on each shard's block
(``ShardedTorchIndex.block_view``) and sum, OR or stack the results.

Kernel 15's mask mode, :func:`fm_dense_mask` and its shard mode
:func:`fm_dense_mask_sharded`, writes the count mask
(``kernels/count_mask.py``: a bit a token, ORed over the shards) that the
``exact_mask`` decode reads; the counts mode stays for
``ops.dense_counts``.  A range of at most ``SPLIT_ROWS`` rows is read by
one CTA into a shared bitset of the whole vocab; a wider one by the
cluster of ``CLUSTER`` CTAs its group of ranges runs on, whose bitsets
are ORed through distributed shared memory (``csrc/fm_search.cu``).
"""

from __future__ import annotations

import torch

from seal_tpu_torch.index.fm_index import SHIFT
from seal_tpu_torch.kernels import Launches, count_mask
from seal_tpu_torch.ops import _generic

MODES = ("backward_step", "contains")
GROUPS = (2, 4, 8, 16, 32)  # lanes an item of the cooperative search can take
GROUP = 8  # the default (python -m seal_tpu_torch.bench_select times each)
ADVANCE = Launches()  # fm_search launches in the step mode (fm_advance)
_FN = {}  # kernel 1's C entry points, looked up once
# kernel 15 counts a range of at most this many rows by a histogram of its
# BWT rows, a wider one by kernel 1's rank at both bounds of every token
HIST_MAX_ROWS = 1 << 18
# the mask mode: a range of at most SPLIT_ROWS rows is one CTA's, a wider
# one is read by the CLUSTER CTAs of its group (csrc/fm_search.cu); its
# shared bitset holds the whole vocab, at most MASK_MAX_WORDS words.  Its
# rows, read once by a cluster, cost less than its ranks up to ~10^6 rows:
# the mask modes' default hist_max (the counts mode's, 2^18, ran 1.39x
# slower, every range ranked 3.6x; python -m seal_tpu_torch.bench_dense_mask
# on an H100 at the generation point's dense ranges)
SPLIT_ROWS = 65536
CLUSTER = 8
MASK_MAX_WORDS = 1 << 15
MASK_HIST_MAX_ROWS = 1 << 20
# kernel 5: a group of G lanes a sequence (a (shard, sequence)), G the
# widest of GROUPS whose grid stays within SEQ_LANES_PER_SM lanes an SM (a
# wider group shortens the chain but issues more L2 requests, a loss where
# every lane is busy, as kernel 1's contains showed at [32, 15, 65]); in the
# shard mode a team of up to 32 // G groups a sequence, its shards side by
# side.  The fastest width at each of [4096, 16] and the sharded searcher's
# count filters ([60, 3], [184, 9]), monolithic and over 4 shards
# (bench_select's forced widths on an H100)
SEQ_LANES_PER_SM = 1024
# kernel 1's shard modes: a team of P groups of G lanes an item, member p
# searching shards p, p + P, ... with the cooperative search (the warp's
# groups in step), G the widest of GROUPS whose grid keeps within
# SHARD_LANES_PER_SM lanes an SM (:func:`shard_plan`)
SHARD_LANES_PER_SM = 1024
# the membership mode's widths: one lane a (shard, item) too, a binary search
# with no ballot, and its budget of CONTAINS_LANES_PER_SM lanes an SM: one
# lane a shard was the fastest width at [16, 15, 65], [32, 15, 65] and [32,
# 32, 129] over 4 shards (2,000-16,770 searches an SM: the loads bind, not
# their chain), the counts mode's two lanes at each (bench_select's forced
# widths on an H100)
CONTAINS_GROUPS = (1,) + GROUPS
CONTAINS_LANES_PER_SM = 512
ADVANCE_SHARDED = Launches()  # fm_search_sharded launches in the step mode
STEP_SHARDED = Launches()  # fm_search_sharded launches in the backward step
_SMS = {}  # the SM count of each card, read once


def symbol_bounds(index, c, pos):
    """(blo, bhi, dlo, dhi): psi-block and directory-tightened search bounds.

    ``c`` holds shifted symbol ids (in range); ``pos`` broadcasts against
    it.  ``sym_dir[c] = (C[c], C[c+1], head_id, 0)``; a head symbol's
    ``head_pair`` row pins the search to one ``2^dir_shift`` position block.
    """
    d = index.sym_dir[c.long()]
    blo, bhi, hid = d[..., 0], d[..., 1], d[..., 2]
    shape = torch.broadcast_shapes(pos.shape, blo.shape)
    blo_b = blo.expand(shape)
    bhi_b = bhi.expand(shape)
    if index.head_pair is None:
        return blo, bhi, blo_b, bhi_b
    hb = hid.expand(shape)
    blk = pos.expand(shape).clamp(0, index.n_rows) >> index.dir_shift
    nb1 = (index.n_rows >> index.dir_shift) + 1
    pr = index.head_pair[(hb.clamp(min=0).long() * nb1 + blk.long())]
    is_head = hb >= 0
    dlo = torch.where(is_head, blo_b + pr[..., 0], blo_b)
    dhi = torch.where(is_head, blo_b + pr[..., 1], bhi_b)
    return blo, bhi, dlo, dhi


def searchsorted_psi(index, lo, hi, pos):
    """Smallest i in [lo, hi] with psi[i] >= pos (psi[lo:hi) increasing).

    ``index.search_iters`` halvings bound every span the directory leaves.
    """
    lo = lo.long()
    hi = hi.long()
    pos = pos.expand(lo.shape)
    last = index.n_rows - 1
    for _ in range(index.search_iters):
        mid = (lo + hi) >> 1
        active = lo < hi
        go_right = index.psi[mid.clamp(max=last)] < pos
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo.to(torch.int32)


def backward_step_plain(index, token, lo, hi):
    c = token + SHIFT
    valid = (c >= 1) & (c < index.sigma)
    safe_c = torch.where(valid, c, 0)
    pos = torch.stack([lo, hi], 0)
    _, _, dlo, dhi = symbol_bounds(index, safe_c, pos)
    row = searchsorted_psi(index, dlo, dhi, pos)
    new_lo = torch.where(valid, row[0], 0)
    new_hi = torch.where(valid, row[1], 0)
    return new_lo, torch.maximum(new_lo, new_hi)


def contains_plain(index, tokens, lo, hi):
    c = tokens + SHIFT
    valid = (c >= 1) & (c < index.sigma)
    safe_c = torch.where(valid, c, 0)
    pos = lo[..., None].expand(safe_c.shape)
    _, bhi, dlo, dhi = symbol_bounds(index, safe_c, pos)
    row = searchsorted_psi(index, dlo, dhi, pos)
    first = index.psi[row.clamp(max=index.n_rows - 1).long()]
    return valid & (row < bhi) & (first < hi[..., None])


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


def _team_plan(n: int, sms: int, shards: int, group, lanes: int, name: str,
               widths=GROUPS):
    """(G, P): a team of P groups of G lanes an item, P the smallest power
    of two holding the shards, at most 32 // ``widths[0]`` (16 at 2-lane
    groups: they fill a warp; past that each member loops over its shards);
    G the widest of ``widths`` (``group`` if given, P cut to 32 // G) with
    P * G <= 32 whose grid, n x P groups, keeps within ``lanes`` lanes for
    each of the card's ``sms`` SMs; never below ``widths[0]``."""
    if group is not None and group not in widths:
        raise ValueError(f"{name}: a group of {group} lanes (take one of {widths})")
    P = min(1 << max(shards - 1, 0).bit_length(), 32 // (group or widths[0]))
    if group is not None:
        return group, P
    G = widths[0]
    for g in widths[1:]:
        if P * g <= 32 and n * P * g <= sms * lanes:
            G = g
    return G, P


def sequences_plan(n: int, sms: int, shards: int = 1, group: int | None = None):
    """Kernel 5's launch: (G, P), G lanes a (shard, sequence) and a team
    of P groups a sequence (P = 1 on one index), by :func:`_team_plan`'s
    rule over ``SEQ_LANES_PER_SM``."""
    return _team_plan(n, sms, shards, group, SEQ_LANES_PER_SM, "kernel 5")


def shard_plan(n: int, sms: int, shards: int, group: int | None = None,
               contains: bool = False):
    """Kernel 1's shard modes' launch: (G, P), G lanes a (shard, item) and a
    team of P groups an item (a (range, token) of ``contains`` and
    ``validate``, a range of the backward step, a selection of the step
    mode), by :func:`_team_plan`'s rule over ``SHARD_LANES_PER_SM``; the
    membership mode (``contains``) over ``CONTAINS_LANES_PER_SM``, and it
    may take one lane a shard (``CONTAINS_GROUPS``)."""
    if contains:
        return _team_plan(n, sms, shards, group, CONTAINS_LANES_PER_SM,
                          "kernel 1's shard modes", CONTAINS_GROUPS)
    return _team_plan(n, sms, shards, group, SHARD_LANES_PER_SM, "kernel 1's shard modes")


def _sms(device) -> int:
    key = torch.device(device).index or 0
    if key not in _SMS:
        _SMS[key] = torch.cuda.get_device_properties(key).multi_processor_count
    return _SMS[key]


def fm_sequences(index, tokens, lengths, group: int | None = None):
    """Row ranges of padded token sequences: tokens int32 [..., L]
    (unshifted), lengths int32 [...]; returns int32 (lo, hi) [...].

    CPU tensors run the plain version; CUDA tensors launch kernel 5, a
    group of lanes a sequence (:func:`sequences_plan`; ``group`` forces
    its width).
    """
    tokens = torch.as_tensor(tokens, dtype=torch.int32, device=index.device)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=index.device)
    if tokens.shape[:-1] != lengths.shape:
        raise ValueError(f"fm_sequences: tokens {tuple(tokens.shape)} vs lengths "
                         f"{tuple(lengths.shape)}")
    if not tokens.is_cuda:
        return sequences_plain(index, tokens, lengths)
    from seal_tpu_torch.kernels import build

    G, _ = sequences_plan(lengths.numel(), _sms(tokens.device), group=group)
    tokens, lengths = tokens.contiguous(), lengths.contiguous()
    out_lo = torch.empty_like(lengths)
    out_hi = torch.empty_like(lengths)
    rc = build.lib().seal_fm_sequences(
        *_index_args(index), tokens.data_ptr(), lengths.data_ptr(), out_lo.data_ptr(),
        out_hi.data_ptr(), lengths.numel(), tokens.shape[-1], G, build.stream_ptr(tokens),
    )
    build.check(rc, "fm_sequences")
    fm_sequences.launches += 1
    return out_lo, out_hi


fm_sequences.launches = 0


def _index_args(index):
    return (
        index.psi.data_ptr(),
        index.sym_dir.data_ptr(),
        index.head_pair.data_ptr() if index.head_pair is not None else None,
        index.n_rows,
        index.sigma,
        index.dir_shift,
    )


def fm_search(index, mode: str, tokens, lo, hi, group: int | None = None):
    """Rank search in one of two modes.

    * ``"backward_step"``: tokens, lo, hi broadcast to one shape; returns
      the (new_lo, new_hi) int32 ranges after appending each token.
    * ``"contains"``: tokens [..., M], lo/hi [...]; returns bool [..., M],
      whether each token continues its range.

    CPU tensors run the plain version; CUDA tensors launch the kernel, a
    group of ``group`` lanes (default ``GROUP``; one of ``GROUPS``) an
    item.
    """
    if mode not in MODES:
        raise ValueError(f"unknown fm_search mode {mode!r}")
    tokens = torch.as_tensor(tokens, dtype=torch.int32, device=index.device)
    lo = torch.as_tensor(lo, dtype=torch.int32, device=index.device)
    hi = torch.as_tensor(hi, dtype=torch.int32, device=index.device)
    if mode == "backward_step":
        tokens, lo, hi = torch.broadcast_tensors(tokens, lo, hi)
    if not tokens.is_cuda:
        if mode == "backward_step":
            return backward_step_plain(index, tokens, lo, hi)
        return contains_plain(index, tokens, lo, hi)
    return _launch(index, mode, tokens, lo, hi, _group(group))


fm_search.launches = 0


def _group(group):
    group = GROUP if group is None else group
    if group not in GROUPS:
        raise ValueError(f"fm_search: a group of {group} lanes (take one of {GROUPS})")
    if not _FN:
        from seal_tpu_torch.kernels import build

        so = build.lib()
        _FN.update(step=so.seal_fm_backward_step, contains=so.seal_fm_contains,
                   advance=so.seal_fm_advance, stream=build.stream_ptr)
    return group


def _launch(index, mode, tokens, lo, hi, group):
    common = _index_args(index)
    stream = _FN["stream"](tokens)
    if mode == "backward_step":
        tokens, lo, hi = (t.contiguous() for t in (tokens, lo, hi))
        out_lo = torch.empty_like(tokens)
        out_hi = torch.empty_like(tokens)
        rc = _FN["step"](
            *common, tokens.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            out_lo.data_ptr(), out_hi.data_ptr(), tokens.numel(), group, stream,
        )
        if rc:
            raise RuntimeError(f"fm_search(backward_step): CUDA error {rc}")
        fm_search.launches += 1
        return out_lo, out_hi
    m = tokens.shape[-1]
    if tokens.shape[:-1] != lo.shape or lo.shape != hi.shape:
        raise ValueError(f"contains: tokens {tuple(tokens.shape)} vs ranges {tuple(lo.shape)}")
    tokens, lo, hi = (t.contiguous() for t in (tokens, lo, hi))
    out = torch.empty(tokens.shape, dtype=torch.bool, device=tokens.device)
    rc = _FN["contains"](
        *common, tokens.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        out.data_ptr(), lo.numel(), m, group, stream,
    )
    if rc:
        raise RuntimeError(f"fm_search(contains): CUDA error {rc}")
    fm_search.launches += 1
    return out


def advance_plain(index, sel_tok, sel_par, lo, hi, finished=None, *, eos: int, pad: int):
    """The step mode's plain version: ``ops/_generic.py:advance_ranges``
    over the plain backward step."""
    return _generic.advance_ranges(
        lambda t, a, b: backward_step_plain(index, t, a, b), lambda a, b: b - a,
        sel_tok, sel_par, lo, hi, finished, eos=eos, pad=pad)


def fm_advance(index, sel_tok, sel_par, lo, hi, finished=None, *, eos: int, pad: int,
               group: int | None = None):
    """Kernel 1's step mode: the range update after a selection.

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
    group = _group(group)
    B, K = sel_tok.shape
    if lo.shape != hi.shape or lo.dim() != 2 or lo.shape[0] != B or sel_par.shape != (B, K):
        raise ValueError(f"fm_advance: selections {tuple(sel_tok.shape)}, parents "
                         f"{tuple(sel_par.shape)}, ranges {tuple(lo.shape)}")
    if finished is not None and (finished.shape != lo.shape or finished.dtype != torch.bool):
        raise ValueError("fm_advance: finished must be bool, shaped as the ranges")
    sel_tok, sel_par, lo, hi = (
        (t if t.dtype == torch.int32 else t.to(torch.int32)).contiguous()
        for t in (sel_tok, sel_par, lo, hi))
    if finished is not None:
        finished = finished.contiguous()
    out = torch.empty((3, B, K), dtype=torch.int32, device=sel_tok.device)
    p = out.data_ptr()
    rc = _FN["advance"](
        *_index_args(index), lo.data_ptr(), hi.data_ptr(), lo.shape[1], sel_par.data_ptr(),
        sel_tok.data_ptr(), finished.data_ptr() if finished is not None else None, eos, pad,
        p, p + 4 * B * K, p + 8 * B * K, B * K, K, group, _FN["stream"](sel_tok),
    )
    if rc:
        raise RuntimeError(f"fm_advance: CUDA error {rc}")
    fm_search.launches += 1
    ADVANCE.launches += 1
    return out.unbind(0)


def dense_counts_plain(index, lo, hi, chunk: int = 4096):
    """The JAX sweep: ``chunk`` tokens at a time, each counted by one plain
    backward step (``_generic.validate_tokens``)."""
    return _generic.dense_counts(
        lambda ix, toks, a, b: _generic.validate_tokens(backward_step_plain, ix, toks, a, b),
        index, lo, hi, chunk,
    )


def fm_dense_counts(index, lo, hi, chunk: int = 4096, hist_max: int = HIST_MAX_ROWS):
    """Continuation count of every token ``0..index.vocab-1`` over ranges
    [lo, hi): int32 [..., vocab].

    CPU tensors run the plain version, ``chunk`` tokens at a time; CUDA
    tensors launch kernel 15 once for the whole vocab (``chunk`` has no
    effect there), which histograms ranges of at most ``hist_max`` rows.
    """
    lo = torch.as_tensor(lo, dtype=torch.int32, device=index.device)
    hi = torch.as_tensor(hi, dtype=torch.int32, device=index.device)
    if lo.shape != hi.shape:
        raise ValueError(f"fm_dense_counts: lo {tuple(lo.shape)} vs hi {tuple(hi.shape)}")
    if not lo.is_cuda:
        return dense_counts_plain(index, lo, hi, chunk)
    from seal_tpu_torch.kernels import build

    if index.bwt.dtype != torch.int32 or not index.bwt.is_contiguous():
        raise ValueError("fm_dense_counts: index.bwt must be contiguous int32")
    lo, hi = lo.contiguous(), hi.contiguous()
    out = torch.empty((*lo.shape, index.vocab), dtype=torch.int32, device=lo.device)
    rc = build.lib().seal_fm_dense_counts(
        *_index_args(index), index.bwt.data_ptr(), lo.data_ptr(), hi.data_ptr(), out.data_ptr(),
        lo.numel(), index.vocab, hist_max, build.stream_ptr(lo),
    )
    build.check(rc, "fm_dense_counts")
    fm_dense_counts.launches += 1
    return out


fm_dense_counts.launches = 0


def _mask_words(vocab: int, name: str) -> int:
    W = count_mask.words(vocab)
    if W > MASK_MAX_WORDS:
        raise ValueError(f"{name}: a vocab of {vocab} tokens takes {W} words of shared "
                         f"bitset, past the mask mode's {MASK_MAX_WORDS}")
    return W


def dense_mask_plain(index, lo, hi, chunk: int = 4096):
    """``pack(dense_counts_plain(...) > 0)``, packed a chunk at a time."""
    return _generic.dense_mask(
        lambda ix, toks, a, b: _generic.validate_tokens(backward_step_plain, ix, toks, a, b),
        index, lo, hi, chunk,
    )


def fm_dense_mask(index, lo, hi, chunk: int = 4096, hist_max: int = MASK_HIST_MAX_ROWS):
    """Kernel 15's mask mode: the count mask of ranges [lo, hi), int32
    [..., count_mask.words(index.vocab)], bit t set iff token t continues
    the range.

    CPU tensors run the plain version, ``chunk`` tokens at a time; CUDA
    tensors launch the kernel once: a range of at most ``hist_max`` rows
    sets the bits of its BWT rows' tokens, a wider one searches each
    token's psi block once (a warp four words a round).
    """
    lo = torch.as_tensor(lo, dtype=torch.int32, device=index.device)
    hi = torch.as_tensor(hi, dtype=torch.int32, device=index.device)
    if lo.shape != hi.shape:
        raise ValueError(f"fm_dense_mask: lo {tuple(lo.shape)} vs hi {tuple(hi.shape)}")
    if not lo.is_cuda:
        return dense_mask_plain(index, lo, hi, chunk)
    from seal_tpu_torch.kernels import build

    if index.bwt.dtype != torch.int32 or not index.bwt.is_contiguous():
        raise ValueError("fm_dense_mask: index.bwt must be contiguous int32")
    W = _mask_words(index.vocab, "fm_dense_mask")
    lo, hi = lo.contiguous(), hi.contiguous()
    out = torch.empty((*lo.shape, W), dtype=torch.int32, device=lo.device)
    rc = build.lib().seal_fm_dense_mask(
        *_index_args(index), index.bwt.data_ptr(), lo.data_ptr(), hi.data_ptr(), out.data_ptr(),
        lo.numel(), index.vocab, hist_max, build.stream_ptr(lo),
    )
    build.check(rc, "fm_dense_mask")
    fm_dense_mask.launches += 1
    return out


fm_dense_mask.launches = 0


# ------------------------------------------------------------ shard modes

SHARD_MODES = ("backward_step", "contains", "validate")


def _shard_args(si):
    """The stacked Psi arrays of a sharded index and their strides."""
    if si.psi.dtype != torch.int32 or not si.psi.is_contiguous() \
            or not si.sym_dir.is_contiguous():
        raise ValueError("shard mode: the index's psi and sym_dir must be contiguous int32")
    return (si.psi.data_ptr(), si.sym_dir.data_ptr(), si.n_max, si.sigma, si.n_shards)


def _ranges_of(si, lo, hi, name):
    lo = torch.as_tensor(lo, dtype=torch.int32, device=si.device)
    hi = torch.as_tensor(hi, dtype=torch.int32, device=si.device)
    if lo.shape != hi.shape or lo.dim() == 0 or lo.shape[0] != si.n_shards:
        raise ValueError(f"{name}: ranges must be [{si.n_shards}, ...], got lo "
                         f"{tuple(lo.shape)} hi {tuple(hi.shape)}")
    return lo, hi


def fm_search_sharded_plain(si, mode: str, tokens, lo, hi):
    views = [si.block_view(s) for s in range(si.n_shards)]
    if mode == "backward_step":
        outs = [backward_step_plain(v, tokens, lo[s], hi[s]) for s, v in enumerate(views)]
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
    if mode == "contains":
        out = contains_plain(views[0], tokens, lo[0], hi[0])
        for s, v in enumerate(views[1:], 1):
            out = out | contains_plain(v, tokens, lo[s], hi[s])
        return out
    return sum(_generic.validate_tokens(backward_step_plain, v, tokens, lo[s], hi[s])
               for s, v in enumerate(views))


def fm_search_sharded(si, mode: str, tokens, lo, hi, group: int | None = None):
    """Kernel 1's shard mode: the rank search of every shard, in one launch.

    lo/hi: int32 [S, ...], each shard's own ranges.

    * ``"backward_step"``: tokens [...] (one per range, the same for every
      shard); returns each shard's (new_lo, new_hi) [S, ...].
    * ``"contains"``: tokens [..., M]; returns bool [..., M], whether each
      token continues its range in some shard (ORed over the shards).
    * ``"validate"``: tokens [..., M]; returns int32 [..., M], each token's
      continuation count summed over the shards.

    CPU tensors run the plain version; CUDA tensors launch the kernel, a
    team of groups an item, its shards side by side (:func:`shard_plan`;
    ``group`` forces the group's width).  Limits: any shard count, tokens
    and ranges (out-of-range tokens give (0, 0) and no membership), and as
    many items as the grid's 2^31 - 1 blocks of 256 lanes hold (64-bit
    offsets).
    """
    if mode not in SHARD_MODES:
        raise ValueError(f"unknown fm_search_sharded mode {mode!r}")
    lo, hi = _ranges_of(si, lo, hi, "fm_search_sharded")
    tokens = torch.as_tensor(tokens, dtype=torch.int32, device=si.device)
    if mode == "backward_step":
        tokens = tokens.expand(lo.shape[1:])
    elif tokens.shape[:-1] != lo.shape[1:]:
        raise ValueError(f"fm_search_sharded: tokens {tuple(tokens.shape)} vs ranges "
                         f"{tuple(lo.shape)}")
    if not tokens.is_cuda:
        return fm_search_sharded_plain(si, mode, tokens, lo, hi)
    from seal_tpu_torch.kernels import build

    so = build.lib()
    tokens, lo, hi = (t.contiguous() for t in (tokens, lo, hi))
    n = lo[0].numel()
    stream = build.stream_ptr(tokens)
    if mode == "backward_step":
        G, P = shard_plan(n, _sms(tokens.device), si.n_shards, group)
        out_lo, out_hi = torch.empty_like(lo), torch.empty_like(hi)
        rc = so.seal_fm_backward_step_sharded(
            *_shard_args(si), tokens.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            out_lo.data_ptr(), out_hi.data_ptr(), n, G, P, stream,
        )
        build.check(rc, "fm_search_sharded(backward_step)")
        fm_search_sharded.launches += 1
        STEP_SHARDED.launches += 1
        return out_lo, out_hi
    count = mode == "validate"
    G, P = shard_plan(tokens.numel(), _sms(tokens.device), si.n_shards, group, not count)
    out = torch.empty(tokens.shape, dtype=torch.int32 if count else torch.bool,
                      device=tokens.device)
    rc = so.seal_fm_contains_sharded(
        *_shard_args(si), tokens.data_ptr(), lo.data_ptr(), hi.data_ptr(), out.data_ptr(), n,
        tokens.shape[-1], int(count), G, P, stream,
    )
    build.check(rc, f"fm_search_sharded({mode})")
    fm_search_sharded.launches += 1
    return out


fm_search_sharded.launches = 0


def advance_sharded_plain(si, sel_tok, sel_par, lo, hi, finished=None, *, eos: int, pad: int):
    """The shard step mode's plain version: ``ops/_generic.py:
    advance_ranges`` over the plain shard backward step, the range size
    summed over the shards."""
    return _generic.advance_ranges(
        lambda t, a, b: fm_search_sharded_plain(si, "backward_step", t, a, b),
        lambda a, b: (b - a).sum(0, dtype=torch.int32), sel_tok, sel_par, lo, hi, finished,
        eos=eos, pad=pad)


def fm_advance_sharded(si, sel_tok, sel_par, lo, hi, finished=None, *, eos: int, pad: int,
                       group: int | None = None):
    """Kernel 1's shard step mode: the range update after a selection over
    every shard, in one launch.

    ``sel_tok``, ``sel_par`` [B, K]: each selection's token and parent
    beam; ``lo``, ``hi`` [S, B, P]: each shard's parent ranges;
    ``finished`` [B, P] (bool) or None at step 0.  Returns int32 (lo, hi)
    [S, B, K], each shard's parent range extended by the token -- (0, 0)
    where ``finished`` is given and the token is EOS or PAD or the parent
    had finished -- and prev_count [B, K], the parent's range size summed
    over the shards.  CPU tensors run :func:`advance_sharded_plain`; CUDA
    tensors launch the kernel once, a team of groups a selection
    (:func:`shard_plan`; ``group`` forces the group's width).  Limits:
    any shard count, tokens and ranges, and as many selections as the
    grid's 2^31 - 1 blocks of 256 lanes hold (64-bit offsets).
    """
    if not sel_tok.is_cuda:
        return advance_sharded_plain(si, sel_tok, sel_par, lo, hi, finished, eos=eos, pad=pad)
    from seal_tpu_torch.kernels import build

    B, K = sel_tok.shape
    S = si.n_shards
    if (lo.shape != hi.shape or lo.dim() != 3 or lo.shape[:2] != (S, B)
            or sel_par.shape != (B, K)):
        raise ValueError(f"fm_advance_sharded: selections {tuple(sel_tok.shape)}, parents "
                         f"{tuple(sel_par.shape)}, ranges {tuple(lo.shape)} over {S} shards")
    if finished is not None and (finished.shape != lo.shape[1:] or finished.dtype != torch.bool):
        raise ValueError("fm_advance_sharded: finished must be bool, shaped as a shard's ranges")
    sel_tok, sel_par, lo, hi = (
        (t if t.dtype == torch.int32 else t.to(torch.int32)).contiguous()
        for t in (sel_tok, sel_par, lo, hi))
    if finished is not None:
        finished = finished.contiguous()
    G, P = shard_plan(B * K, _sms(sel_tok.device), S, group)
    out = torch.empty((2 * S + 1, B, K), dtype=torch.int32, device=sel_tok.device)
    p = out.data_ptr()
    rc = build.lib().seal_fm_advance_sharded(
        *_shard_args(si), lo.data_ptr(), hi.data_ptr(), lo.shape[2], sel_par.data_ptr(),
        sel_tok.data_ptr(), finished.data_ptr() if finished is not None else None, eos, pad,
        p, p + 4 * S * B * K, p + 8 * S * B * K, B * K, K, G, P, build.stream_ptr(sel_tok),
    )
    build.check(rc, "fm_advance_sharded")
    fm_search_sharded.launches += 1
    ADVANCE_SHARDED.launches += 1
    return out[:S], out[S : 2 * S], out[2 * S]


def sequences_sharded_plain(si, tokens, lengths, count: bool = False):
    outs = [sequences_plain(si.shard_view(s), tokens, lengths) for s in range(si.n_shards)]
    if count:
        return sum(hi - lo for lo, hi in outs)
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def fm_sequences_sharded(si, tokens, lengths, count: bool = False, group: int | None = None):
    """Kernel 5's shard mode: each shard's row ranges of padded token
    sequences (tokens int32 [..., L], lengths [...]) from its own full range,
    as int32 (lo, hi) [S, ...]; with ``count``, their counts summed over the
    shards, int32 [...].

    CPU tensors run the plain version; CUDA tensors launch the kernel, a
    group of lanes a (shard, sequence), a sequence's shards side by side
    (:func:`sequences_plan`; ``group`` forces the group's width).
    """
    tokens = torch.as_tensor(tokens, dtype=torch.int32, device=si.device)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=si.device)
    if tokens.shape[:-1] != lengths.shape:
        raise ValueError(f"fm_sequences_sharded: tokens {tuple(tokens.shape)} vs lengths "
                         f"{tuple(lengths.shape)}")
    if not tokens.is_cuda:
        return sequences_sharded_plain(si, tokens, lengths, count)
    from seal_tpu_torch.kernels import build

    tokens, lengths = tokens.contiguous(), lengths.contiguous()
    if count:
        out_lo = out_hi = None
        out_count = torch.empty_like(lengths)
    else:
        out_lo = torch.empty((si.n_shards, *lengths.shape), dtype=torch.int32,
                             device=lengths.device)
        out_hi = torch.empty_like(out_lo)
        out_count = None
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    G, P = sequences_plan(lengths.numel(), _sms(tokens.device), si.n_shards, group)
    rc = build.lib().seal_fm_sequences_sharded(
        *_shard_args(si), si.n_rows.data_ptr(), tokens.data_ptr(), lengths.data_ptr(),
        ptr(out_lo), ptr(out_hi), ptr(out_count), lengths.numel(), tokens.shape[-1], G, P,
        build.stream_ptr(tokens),
    )
    build.check(rc, "fm_sequences_sharded")
    fm_sequences_sharded.launches += 1
    return out_count if count else (out_lo, out_hi)


fm_sequences_sharded.launches = 0


def dense_counts_sharded_plain(si, lo, hi, chunk: int = 4096):
    return sum(dense_counts_plain(si.block_view(s), lo[s], hi[s], chunk)
               for s in range(si.n_shards))


def fm_dense_counts_sharded(si, lo, hi, chunk: int = 4096, hist_max: int = HIST_MAX_ROWS):
    """Kernel 15's shard mode: the continuation count of every token
    ``0..si.vocab-1`` over each shard's ranges lo/hi [S, ...], summed over
    the shards: int32 [..., vocab].  A shard's range of at most ``hist_max``
    rows adds a histogram of its BWT rows, a wider one both bounds' ranks.

    CPU tensors run the plain version, ``chunk`` tokens at a time; CUDA
    tensors launch the kernel once for the whole vocab and every shard.
    """
    lo, hi = _ranges_of(si, lo, hi, "fm_dense_counts_sharded")
    if not lo.is_cuda:
        return dense_counts_sharded_plain(si, lo, hi, chunk)
    from seal_tpu_torch.kernels import build

    if si.bwt.dtype != torch.int32 or not si.bwt.is_contiguous():
        raise ValueError("fm_dense_counts_sharded: the index's bwt must be contiguous int32")
    lo, hi = lo.contiguous(), hi.contiguous()
    out = torch.empty((*lo.shape[1:], si.vocab), dtype=torch.int32, device=lo.device)
    rc = build.lib().seal_fm_dense_counts_sharded(
        *_shard_args(si), si.bwt.data_ptr(), lo.data_ptr(), hi.data_ptr(), out.data_ptr(),
        lo[0].numel(), si.vocab, hist_max, build.stream_ptr(lo),
    )
    build.check(rc, "fm_dense_counts_sharded")
    fm_dense_counts_sharded.launches += 1
    return out


fm_dense_counts_sharded.launches = 0


def dense_mask_sharded_plain(si, lo, hi, chunk: int = 4096):
    out = dense_mask_plain(si.block_view(0), lo[0], hi[0], chunk)
    for s in range(1, si.n_shards):
        out = out | dense_mask_plain(si.block_view(s), lo[s], hi[s], chunk)
    return out


def fm_dense_mask_sharded(si, lo, hi, chunk: int = 4096,
                          hist_max: int = MASK_HIST_MAX_ROWS):
    """Kernel 15's mask mode over the shards: the count mask of each
    shard's ranges lo/hi [S, ...], ORed over the shards (a summed count is
    > 0 iff some shard's is): int32 [..., count_mask.words(si.vocab)].

    CPU tensors run the plain version, ``chunk`` tokens at a time; CUDA
    tensors launch the kernel once for every shard, each shard's range on
    its own route (``hist_max``).
    """
    lo, hi = _ranges_of(si, lo, hi, "fm_dense_mask_sharded")
    if not lo.is_cuda:
        return dense_mask_sharded_plain(si, lo, hi, chunk)
    from seal_tpu_torch.kernels import build

    if si.bwt.dtype != torch.int32 or not si.bwt.is_contiguous():
        raise ValueError("fm_dense_mask_sharded: the index's bwt must be contiguous int32")
    W = _mask_words(si.vocab, "fm_dense_mask_sharded")
    lo, hi = lo.contiguous(), hi.contiguous()
    out = torch.empty((*lo.shape[1:], W), dtype=torch.int32, device=lo.device)
    rc = build.lib().seal_fm_dense_mask_sharded(
        *_shard_args(si), si.bwt.data_ptr(), lo.data_ptr(), hi.data_ptr(), out.data_ptr(),
        lo[0].numel(), si.vocab, hist_max, build.stream_ptr(lo),
    )
    build.check(rc, "fm_dense_mask_sharded")
    fm_dense_mask_sharded.launches += 1
    return out


fm_dense_mask_sharded.launches = 0
