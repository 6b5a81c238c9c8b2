"""Kernel 8 wrappers: the decode step's candidate merge and beam selection
(``csrc/beam_select.cu``), with their plain versions.

Replaces, in ``seal_tpu/decoding/constrained.py``:

* ``beam_merge``: ``_exact_proposals.merge_round`` (:612-663) -- buffer,
  LM top and interval slab, ``_dedup_mask`` (:1014), top-``n_buf``.
* ``beam_select``: ``_fast_exact_select``'s ``build_and_select``
  (:850-871) -- the buffer's PAD finish (:798-799), ``_exact_slots``' EOS
  and PAD slots (:388-391), ``_apply_branches`` (:897), ``_dedup_mask``,
  ``_select`` (:1046) -- and the soundness test (:889-894).
* ``beam_select_top``: ``_select``'s epilogue after kernel 3 ranked step
  0's V-wide rows (gathers, the first-K-non-EOS rule, ``finite``).

Every output is a selection or one f32 add done in the plain code's order,
so the kernels equal the plain versions exactly, floats bit for bit.  The
order is ``lax.top_k``'s (f32 total order, ties to the lower slot).

Under ``exact_ties`` (``ties=True``) ``beam_merge`` and ``beam_select`` take
``_top_idx``'s other order, ``_top_by_score_then_id`` (:934): equal scores
order by a tie id, ascending -- the dedup id in the merge, the (parent
beam, token) id of ``_beam_tok_tie`` (:958) in the selection.  The plain
versions sort one int64 key, (score's order key << 32) | (2^32 - 1 -
tie id), stably; torch has int64, so JAX's two-key ``lax.sort`` (a
workaround for x64 being off) is not carried over.  Launches in that mode
also count on ``TIES``.

Three more modes, for the decode modes of ``_candidates_general`` (:305):

* ``beam_select(..., keep_invalid=True)`` (speculative, :343-367): the
  buffer is the LM proposal round itself, and a slot that fails membership
  keeps its token and log-prob with ``fm_valid`` false, where the fast path
  turns it into a PAD candidate.  The two differ only among masked
  candidates, which ``cand_tokens`` records too.  Counts on ``SPEC``.
* ``beam_select_top(..., tokens=table)`` (free generation, :329-336): the
  ranked flat axis is [B, n_par * ncand] slots of a per-beam token table
  (kernel 19's top-``top_m``), token = table[parent, slot % ncand].  Counts
  on ``FREE``.
* ``beam_candidates`` (sampling and diverse groups, :359-367 with
  ``_dedup_mask`` :1394-1399): ``beam_select``'s candidates, the branches
  and first-instance dedup applied, written out in slot order (token,
  constrained log-prob, log-prob) for kernels 20 and 21 to select from; no
  selection.  Its plain version is ``beam_select``'s first half.

``beam_select`` runs one of five routes (:func:`select_plan`, counted in
``ROUTES``): ``"warp"`` -- a warp a beam, its slots in registers sorted by
shuffles, each beam's top 2K a sorted list, a survivor placed by its rank
across the lists (``beam_select_warp_plain`` is that algorithm in torch)
-- where a beam has at most 128 candidates, 2K <= 64 and n_par <= 32 (the
bench's beam 15 and beam 32 at a 32-row window); ``"wide"`` -- a warp a
beam in its own region of shared memory, first instances from a hash
table of its tokens, its first 2K as a running first 64 in registers
(each chunk of 64 keys sorted and merged in), then the beams' lists
merged (``beam_select_wide_plain``) -- past 128 candidates a beam up to
``SERIAL_MAX`` (the speculative default's [15, 386], beam 32 over 4
shards' [32, 578]); ``"block"`` -- the
query's n = n_par * (n_buf + w + 2) candidates sorted in one CTA -- while
that fits the shared memory; ``"large"`` (past the wide route's 2K or
beams, while a beam fits a CTA) -- each beam's top 2K by the same key, then the
query's finish over the n_par * 2K survivors -- two launches, the same
result bit for bit (dedup and branches are per beam, and the key order is
total; ``beam_select_large_plain`` is its specification, and its launches
also count on ``LARGE``); and ``"table"`` -- a beam past a CTA (a
speculative round of ``top_m`` up to V) finds first instances through a
[rows, V] table in device memory and keeps its top 2K of chunks of
``SELECT_CHUNK`` candidates (``beam_select_large_plain(..., chunk=)``).
``beam_merge`` likewise merges a row in one CTA while it fits, and
otherwise in passes over chunks, each keeping its chunk's n_buf best
first instances (``sample=True`` with ``top_m >= 482``, an
``exact_loop_chunk`` past 4,081 at beam 15): exact because valid copies of
a token carry one log-prob (``csrc/beam_select.cu`` gives the argument;
``beam_merge_large_plain`` is the specification).  Those calls also count
on ``MERGE_LARGE``.  A buffer past 4,096 (2,048 under ``ties``), where a
chunk could no longer halve a row, takes the device-memory route: the
table, one 64-bit key a slot sorted in device memory
(``beam_merge_table_plain``), counted on ``MERGE_TABLE``.
``beam_candidates`` finds first instances as the wide route does, a warp
a beam row, and takes the table past ``SERIAL_MAX`` candidates a beam
(``CAND_TABLE``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from seal_tpu_torch.kernels import Launches
from seal_tpu_torch.kernels.row_topk import order_key, row_topk_plain

NEG_INF = float(np.finfo(np.float32).min) / 2  # the decoder's masking constant
TOK_BITS = 17  # minimum token-id field width in selection tie ids
SELECT_TOP_SMEM = 48 * 1024  # beam_select_top's picks in shared memory up to here


TIES = Launches()  # kernel 8 launches in the ties mode (merge and select)
FREE = Launches()  # beam_select_top launches with a candidate token table
SPEC = Launches()  # beam_select launches that keep invalid buffer slots
LARGE = Launches()  # beam_select calls through the two-launch large-n route
# beam_select calls by route (select_plan)
ROUTES = {"warp": Launches(), "wide": Launches(), "block": Launches(), "large": LARGE,
          "table": Launches()}
_ROUTE_CODES = {"block": 0, "large": 1, "warp": 2, "table": 3, "wide": 4}  # csrc/beam_select.cu's
MERGE_LARGE = Launches()  # beam_merge calls through the chunked large-n route
MERGE_TABLE = Launches()  # beam_merge calls through the device-memory route
CAND_TABLE = Launches()  # beam_candidates calls that dedup through the table
MERGE_CHUNK = 4096  # candidates a CTA of the large-n merge (MERGE_CHUNK_WIDE past n_buf 2048)
MERGE_CHUNK_WIDE = 8192
MERGE_SORT_MIN = 8192  # the device-memory sort's smallest row (global_sort.cuh's GTILE)
SELECT_CHUNK = 8192  # candidates a CTA of the table route's per-beam stage
SERIAL_MAX = 2048  # candidates a beam dedups in shared memory (block and large-n: a serial scan)
WARP_MAX = (128, 64, 32)  # the warp route's most candidates a beam, 2K and beams
WIDE_WARPS = 8  # beams a query up to which the wide route takes one CTA (wide_splits)
_FN = {}  # kernel 8's C entry points, looked up once


def top_by_score_then_id(score, tie_id, k: int):
    """Indices of the ``k`` best entries of each row by (score desc in f32's
    total order, tie id asc); equal pairs keep slot order.  Tie ids are in
    [0, 2^31)."""
    key = (order_key(score).long() << 32) | (0xFFFFFFFF - tie_id.long())
    return torch.sort(key, dim=-1, descending=True, stable=True)[1][..., :k]


def tie_bits(vocab: int, n_parents: int) -> int:
    """Token bits of the (parent, token) tie id; raises the JAX package's
    ``ValueError`` where the packed id would leave int32."""
    bits = max(TOK_BITS, int(vocab - 1).bit_length())
    if (n_parents << bits) > 2**31 - 1:
        raise ValueError(
            f"exact_ties tie ids need {bits} token bits x {n_parents} beams "
            f"-- exceeds int32; reduce beams or disable exact_ties"
        )
    return bits


def beam_tok_tie(flat_tok, ncand: int, vocab: int):
    """Tie ids for a [B, n_par * ncand] candidate axis: (parent beam << bits)
    + token, the token clipped to the field (``_beam_tok_tie``)."""
    n = flat_tok.shape[-1]
    bits = tie_bits(vocab, -(-n // ncand))
    parent = torch.arange(n, dtype=torch.int32, device=flat_tok.device) // ncand
    return (parent << bits) + flat_tok.clamp(0, (1 << bits) - 1)


def dedup_mask(tokens):
    """Keep-mask of the FIRST instance of each token id within a row: a
    stable sort puts each id's lowest slot first in its run (n log n, where
    comparing every pair would hold an [n, n] mask: 1.6 GB a row at the
    40,030 candidates of ``exact_loop_chunk=20000``)."""
    vals, order = torch.sort(tokens, dim=-1, stable=True)
    first = torch.ones_like(vals, dtype=torch.bool)
    first[..., 1:] = vals[..., 1:] != vals[..., :-1]
    return torch.empty_like(first).scatter_(-1, order, first)


def apply_branches(tokens, fm_valid, prev_count, finished, *, eos: int, pad: int,
                   stop_at_count: int, always_allow_eos: bool):
    """Reference branch logic (beam_search.py:114-138) on candidate level:
    stop-forced beams allow only EOS, finished beams only PAD, the rest the
    FM-valid set.  Returns the allowed mask."""
    is_eos = tokens == eos
    is_pad = tokens == pad
    count_eff = torch.where(finished, 0, prev_count)
    stop_trig = (count_eff <= stop_at_count) & (stop_at_count > 0)
    allowed = torch.where(
        stop_trig[..., None], is_eos, torch.where(finished[..., None], is_pad, fm_valid)
    )
    if always_allow_eos:
        allowed = allowed | is_eos
    return allowed


def _g(x, idx):
    return torch.gather(x, -1, idx.long())


# ------------------------------------------------------------------ merge


def _merge_candidates(buf, top_tok, top_lp, top_ok, slab_tok, slab_lp, slab_ok, n_buf):
    """A merge's candidates in slot order, [..., n] (tok, lp, valid)."""
    lead = top_tok.shape[:-1]
    dev = top_tok.device
    if buf is None:
        buf = (torch.zeros((*lead, n_buf), dtype=torch.int32, device=dev),
               torch.full((*lead, n_buf), NEG_INF, dtype=torch.float32, device=dev),
               torch.zeros((*lead, n_buf), dtype=torch.bool, device=dev))
    tok = torch.cat([buf[0], top_tok, slab_tok], -1)
    lp = torch.cat([buf[1], top_lp, slab_lp], -1)
    ok = torch.cat([buf[2], top_ok & (top_lp > NEG_INF / 2), slab_ok & (slab_lp > NEG_INF / 2)],
                   -1)
    return tok, lp, ok


def beam_merge_plain(buf, top_tok, top_lp, top_ok, slab_tok, slab_lp, slab_ok, vocab: int,
                     n_buf: int, ties: bool = False):
    all_tok, all_lp, all_valid = _merge_candidates(buf, top_tok, top_lp, top_ok, slab_tok,
                                                   slab_lp, slab_ok, n_buf)
    n = all_tok.shape[-1]
    # an invalid slot gets an id of its own, so it cannot shadow a valid copy
    uniq = torch.where(all_valid, all_tok,
                       vocab + torch.arange(n, dtype=torch.int32, device=all_tok.device))
    fresh = dedup_mask(uniq)
    rank = torch.where(all_valid & fresh, all_lp, NEG_INF)
    keep = top_by_score_then_id(rank, uniq, n_buf) if ties else row_topk_plain(rank, n_buf)[1]
    return _g(all_tok, keep), _g(all_lp, keep), _g(all_valid & fresh, keep)


def merge_chunk(n_buf: int) -> int:
    """Candidates a CTA of the large-n merge takes: at least 2 n_buf, so
    each pass at least halves a row."""
    return MERGE_CHUNK if 2 * n_buf <= MERGE_CHUNK else MERGE_CHUNK_WIDE


@functools.lru_cache(maxsize=256)
def merge_route(n: int, n_buf: int, ties: bool) -> tuple[str, int]:
    """The merge's route for rows of ``n`` candidates: ("block", n) where a
    row fits one CTA, ("chunked", chunk) where chunks of at least 2 n_buf
    do, else ("table", n2): the device-memory route over rows of n2 keys."""
    from seal_tpu_torch.kernels import build

    smem = build.lib().seal_beam_merge_smem
    if smem(n, int(ties)) <= build.SMEM_LIMIT:
        return "block", n
    chunk = merge_chunk(n_buf)
    if 2 * n_buf <= chunk and smem(chunk, int(ties)) <= build.SMEM_LIMIT:
        return "chunked", chunk
    return "table", max(1 << (n - 1).bit_length(), MERGE_SORT_MIN)


def merge_widths(n: int, n_buf: int, chunk: int) -> list[int]:
    """The row width of each pass of the large-n merge, from ``n`` down to
    the last pass's (at most ``chunk``)."""
    widths = [n]
    while widths[-1] > chunk:
        w = widths[-1]
        full = -(-w // chunk) - 1
        widths.append(full * n_buf + min(n_buf, w - full * chunk))
    return widths


def beam_merge_large_plain(buf, top_tok, top_lp, top_ok, slab_tok, slab_lp, slab_ok, vocab: int,
                           n_buf: int, ties: bool = False, chunk: int | None = None):
    """The large-n route's specification (``csrc/beam_select.cu``,
    ``merge_kernel`` over several chunks): passes over chunks of ``chunk`` candidates,
    each keeping its chunk's ``n_buf`` best first instances in slot order,
    until one chunk holds a row; equal to :func:`beam_merge_plain` when
    valid copies of a token carry one log-prob (the merge's inputs do)."""
    chunk = merge_chunk(n_buf) if chunk is None else chunk
    tok, lp, ok = _merge_candidates(buf, top_tok, top_lp, top_ok, slab_tok, slab_lp, slab_ok,
                                    n_buf)
    slot = torch.arange(tok.shape[-1], dtype=torch.int32, device=tok.device).expand(tok.shape)
    while True:
        width = tok.shape[-1]
        parts = []
        for c0 in range(0, width, chunk):
            t, l, o, sl = (x[..., c0:c0 + chunk] for x in (tok, lp, ok, slot))
            uniq = torch.where(o, t, vocab + sl)
            fresh = o & dedup_mask(uniq)
            rank = torch.where(fresh, l, NEG_INF)
            keep = min(n_buf, t.shape[-1])
            idx = top_by_score_then_id(rank, uniq, keep) if ties else row_topk_plain(rank, keep)[1]
            if width <= chunk:  # the last pass
                return _g(t, idx), _g(l, idx), _g(fresh, idx)
            idx = idx.sort(-1).values  # slot order
            parts.append((_g(t, idx), _g(l, idx), _g(o, idx), _g(sl, idx)))
        tok, lp, ok, slot = (torch.cat(p, -1) for p in zip(*parts))


def table_first(tok, vocab: int, keep=None):
    """The table routes' dedup (``csrc/beam_select.cu``): a [rows, vocab]
    table of each token's lowest slot in its row, over the slots ``keep``
    marks (all by default); True where a slot holds its token's entry, and
    where its token lies outside [0, vocab) (never recorded)."""
    t = tok.long()
    inside = (t >= 0) & (t < vocab)
    if keep is not None:
        inside = inside & keep
    col = torch.where(inside, t, vocab)  # a spare column for the rest
    slot = torch.arange(t.shape[-1], device=t.device).expand(t.shape)
    table = torch.full((*t.shape[:-1], vocab + 1), 0xFFFFFFFF, dtype=torch.int64, device=t.device)
    table.scatter_reduce_(-1, col, slot, "amin")
    return ~inside | (torch.gather(table, -1, col) == slot)


def beam_merge_table_plain(buf, top_tok, top_lp, top_ok, slab_tok, slab_lp, slab_ok, vocab: int,
                           n_buf: int, ties: bool = False):
    """The device-memory route's algorithm (``merge_table_kernel``,
    ``merge_keys_kernel``, ``global_sort``): first instances from the table
    of each valid token's lowest slot, one unique 64-bit key a slot, the
    row sorted by key and its first ``n_buf`` read back.  Equal to
    :func:`beam_merge_plain` where valid tokens lie in [0, vocab) and carry
    lp > NEG_INF/2 (the decode's merges)."""
    tok, lp, ok = _merge_candidates(buf, top_tok, top_lp, top_ok, slab_tok, slab_lp, slab_ok,
                                    n_buf)
    n = tok.shape[-1]
    slot = torch.arange(n, dtype=torch.int64, device=tok.device).expand(tok.shape)
    fresh = ok & table_first(tok, vocab, keep=ok)
    rank = order_key(torch.where(fresh, lp, NEG_INF)).long() & 0xFFFFFFFF
    mono = rank ^ 0x80000000  # the unsigned order key of the f32 total order
    if ties:
        uid = torch.where(ok, tok.long(), vocab + slot)
        key = torch.where(fresh, (mono << 32) | (0xFFFFFFFF - tok.long()),
                          ((0x7FFFFF - uid) << 32) | (0xFFFFFFFF - slot))
    else:
        key = (mono << 32) | (0xFFFFFFFF - slot)
    # descending unsigned order as signed int64: flip the top bit
    order = torch.sort(key ^ (-(1 << 63)), dim=-1, descending=True)[1][..., :n_buf]
    return _g(tok, order), _g(lp, order), _g(fresh, order)


def beam_merge(buf, top_tok, top_lp, top_ok, slab_tok, slab_lp, slab_ok, vocab: int,
               n_buf: int, ties: bool = False):
    """One proposal round's merge, per beam row.

    ``buf``: (tok int32, lp f32, valid bool) [..., n_buf], or None for round
    0's empty buffer (token 0, NEG_INF, invalid).  ``top_*`` [..., n_top]:
    LM top tokens, their log-probs and membership; ``slab_*`` [..., n_slab]:
    the interval's own rows.  An LM or slab slot is valid when its flag is
    set and its log-prob > NEG_INF/2.  Returns the ``n_buf`` best valid,
    first-instance candidates (tok, lp, valid), unfilled slots after them;
    equal log-probs keep slot order, or with ``ties`` the order of their
    dedup ids (the token if valid, else ``vocab`` + slot).

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    :func:`merge_route`'s route: one CTA a row while the row's candidates
    fit its shared memory (n <= 8,192, 4,096 under ``ties``, by
    ``seal_beam_merge_smem``), passes of :func:`merge_chunk` candidates a
    CTA (``beam_merge_large_plain``) for buffers up to 4,096 (2,048 under
    ``ties``), else the device-memory route (``beam_merge_table_plain``;
    valid tokens in [0, vocab)).  ``top_tok``/``top_lp`` and ``top_ok`` may
    be row-strided views.
    """
    if not top_tok.is_cuda:
        return beam_merge_plain(buf, top_tok, top_lp, top_ok, slab_tok, slab_lp, slab_ok, vocab,
                                n_buf, ties)
    from seal_tpu_torch.kernels import build

    lead = top_tok.shape[:-1]
    n_top, n_slab = top_tok.shape[-1], slab_tok.shape[-1]
    rows = top_tok[..., 0].numel()
    n = n_buf + n_top + n_slab
    route, chunk = merge_route(n, n_buf, bool(ties))
    top_stride = _row_stride(top_tok, "top_tok")
    if _row_stride(top_lp, "top_lp") != top_stride:
        raise ValueError("beam_merge: top_tok and top_lp need one row stride")
    ok_stride = _row_stride(top_ok, "top_ok")
    slab_tok, slab_lp, slab_ok = (t.contiguous() for t in (slab_tok, slab_lp, slab_ok))
    _check(top_tok, torch.int32, top_lp, torch.float32, top_ok, torch.bool, slab_tok, torch.int32,
           slab_lp, torch.float32, slab_ok, torch.bool)
    if buf is not None:
        buf = tuple(t.contiguous() for t in buf)
        _check(buf[0], torch.int32, buf[1], torch.float32, buf[2], torch.bool)
        if buf[0].shape[-1] != n_buf:
            raise ValueError("beam_merge: buffer width differs from n_buf")
    dev = top_tok.device
    out_tok = torch.empty((*lead, n_buf), dtype=torch.int32, device=dev)
    out_lp = torch.empty((*lead, n_buf), dtype=torch.float32, device=dev)
    out_valid = torch.empty((*lead, n_buf), dtype=torch.bool, device=dev)
    ptr = (lambda i: buf[i].data_ptr()) if buf is not None else (lambda i: None)
    src = (ptr(0), ptr(1), ptr(2), top_tok.data_ptr(), top_lp.data_ptr(), top_ok.data_ptr(),
           top_stride, ok_stride, slab_tok.data_ptr(), slab_lp.data_ptr(), slab_ok.data_ptr())
    stream = build.stream_ptr(top_tok)
    if route == "table":
        if vocab + n > 0x7FFFFF:
            raise ValueError(f"beam_merge: {n} candidates over a vocab of {vocab} exceed the "
                             "device-memory route's 23-bit dedup ids")
        table = torch.empty((rows, vocab), dtype=torch.int32, device=dev)
        keys = torch.empty((rows, chunk), dtype=torch.int64, device=dev)
        rc = build.lib().seal_beam_merge_table(
            *src, n_top, n_slab, rows, n_buf, vocab, int(ties), NEG_INF, table.data_ptr(),
            keys.data_ptr(), chunk, out_tok.data_ptr(), out_lp.data_ptr(), out_valid.data_ptr(),
            stream)
        build.check(rc, "beam_merge")
        MERGE_TABLE.launches += 1
    else:
        # a pass per width: survivors (tok, lp, ok, slot) [rows, width] between passes
        widths = merge_widths(n, n_buf, chunk)
        prev = (None, None, None, None)
        for width, nxt in zip(widths, widths[1:] + [None]):
            if nxt is None:
                outs = (out_tok, out_lp, out_valid, None)
            else:
                outs = (torch.empty((rows, nxt), dtype=torch.int32, device=dev),
                        torch.empty((rows, nxt), dtype=torch.float32, device=dev),
                        torch.empty((rows, nxt), dtype=torch.bool, device=dev),
                        torch.empty((rows, nxt), dtype=torch.int32, device=dev))
            rc = build.lib().seal_beam_merge(
                *src, n_top, n_slab, *(t.data_ptr() if t is not None else None for t in prev),
                rows, width, chunk, n_buf, vocab, int(ties), NEG_INF,
                *(t.data_ptr() if t is not None else None for t in outs), stream)
            build.check(rc, "beam_merge")
            prev = outs
        MERGE_LARGE.launches += len(widths) > 1
    beam_merge.launches += 1
    TIES.launches += int(ties)
    return out_tok, out_lp, out_valid


beam_merge.launches = 0


# ----------------------------------------------------------------- select


def select_top_plain(cons_scores, uncons_scores, tokens, K: int, eos: int, tie_vocab=None):
    """top-2K by constrained score + the first-K-non-EOS continuation rule
    (``beam_search.py:301-320``) over [B, n_par, ncand] candidates; the
    candidate-beam axis may be narrower than K (step 0).  With
    ``tie_vocab``, equal scores order by (parent beam, token)."""
    B, n_par, ncand = cons_scores.shape
    flat_cons = cons_scores.reshape(B, n_par * ncand)
    flat_tok = tokens.reshape(B, -1)
    if tie_vocab is None:
        top_cons, top_idx = row_topk_plain(flat_cons, 2 * K)
    else:
        top_idx = top_by_score_then_id(flat_cons, beam_tok_tie(flat_tok, ncand, tie_vocab), 2 * K)
        top_cons = _g(flat_cons, top_idx)
    return _epilogue(top_cons, top_idx, uncons_scores.reshape(B, -1), flat_tok, ncand, K, eos)


def _epilogue(top_cons, top_idx, flat_uncons, flat_tok, ncand, K, eos):
    top_tok = _g(flat_tok, top_idx)
    top_uncons = _g(flat_uncons, top_idx)
    top_parent = (top_idx // ncand).to(torch.int32)
    is_eos = (top_tok == eos).to(torch.int8)
    cont = torch.argsort(is_eos, dim=-1, stable=True)[:, :K]
    finite = top_cons > NEG_INF / 4
    return (
        top_tok, top_parent, top_uncons, finite,
        _g(top_tok, cont), _g(top_parent, cont), _g(top_uncons, cont), _g(finite, cont),
        top_cons,  # [B, 2K] desc; top_cons[:, -1] is the selection cutoff
    )


def candidates_plain(buf, n_buf: int, win_tok, win_valid, win_lp, eos_ok, lp, prev_count,
                     finished, *, eos: int, pad: int, stop_at_count: int = 0,
                     always_allow_eos: bool = False, keep_invalid: bool = False, first=None):
    """The candidates of ``beam_select`` before selection: (tokens,
    constrained log-probs, log-probs) [B, n_par, n_buf + w + 2].  ``first``
    maps the tokens to their first-instance mask (default
    :func:`dedup_mask`; the table routes' :func:`table_first`)."""
    B, n_par = prev_count.shape
    dev = lp.device
    eos_lp = lp[:, eos].reshape(B, n_par, 1)
    pad_lp = lp[:, pad].reshape(B, n_par, 1)
    if buf is None:
        buf = (torch.zeros((B, n_par, n_buf), dtype=torch.int32, device=dev),
               torch.zeros((B, n_par, n_buf), dtype=torch.float32, device=dev),
               torch.zeros((B, n_par, n_buf), dtype=torch.bool, device=dev))
    buf_tok, buf_lp, buf_valid = buf
    if not keep_invalid:
        # unfilled slots become PAD candidates at PAD's log-prob
        buf_tok = torch.where(buf_valid, buf_tok, pad)
        buf_lp = torch.where(buf_valid, buf_lp, pad_lp)
    eos_tok = torch.full((B, n_par, 1), eos, dtype=torch.int32, device=dev)
    pad_tok = torch.full((B, n_par, 1), pad, dtype=torch.int32, device=dev)
    tokens = torch.cat([buf_tok, win_tok, eos_tok, pad_tok], -1)
    fm_valid = torch.cat(
        [buf_valid, win_valid, eos_ok.reshape(B, n_par, 1),
         torch.zeros((B, n_par, 1), dtype=torch.bool, device=dev)], -1
    )
    cand_lp = torch.cat([buf_lp, win_lp, eos_lp, pad_lp], -1)
    allowed = apply_branches(tokens, fm_valid, prev_count, finished, eos=eos, pad=pad,
                             stop_at_count=stop_at_count, always_allow_eos=always_allow_eos)
    # proposal slots can repeat a window token; keep one per token id
    cons = torch.where(allowed & (first or dedup_mask)(tokens), cand_lp, NEG_INF)
    return tokens, cons, cand_lp


def beam_select_plain(buf, n_buf: int, win_tok, win_valid, win_lp, eos_ok, lp, prev_count,
                      finished, beam_scores, need, th_lp, *, K: int, eos: int, pad: int,
                      stop_at_count: int, always_allow_eos: bool, ties: bool = False,
                      keep_invalid: bool = False):
    tokens, cons, cand_lp = candidates_plain(
        buf, n_buf, win_tok, win_valid, win_lp, eos_ok, lp, prev_count, finished, eos=eos, pad=pad,
        stop_at_count=stop_at_count, always_allow_eos=always_allow_eos, keep_invalid=keep_invalid)
    bs = beam_scores[..., None]
    out = select_top_plain(cons + bs, cand_lp + bs, tokens, K, eos,
                           tie_vocab=lp.shape[-1] if ties else None)
    if need is None:
        return out, None
    unsound = (need & (beam_scores + th_lp >= out[8][:, -1:])).any(-1)
    return out, unsound


def _select_key(score, tie):
    """int64 keys whose descending order is (score desc, tie id asc), with
    the flat slot beside them breaking equal keys (``pack`` in
    ``csrc/select_common.cuh``, as signed int64)."""
    return (order_key(score).long() << 32) | (0xFFFFFFFF - tie.long())


def _ties_of(tokens, ncand, vocab, ties):
    B = tokens.shape[0]
    flat = tokens.reshape(B, -1)
    if ties:
        return beam_tok_tie(flat, ncand, vocab).reshape(tokens.shape)
    return torch.arange(flat.shape[-1], dtype=torch.int32,
                        device=tokens.device).expand(flat.shape).reshape(tokens.shape)


def beam_select_large_plain(buf, n_buf: int, win_tok, win_valid, win_lp, eos_ok, lp,
                            prev_count, finished, beam_scores, need, th_lp, *, K: int, eos: int,
                            pad: int, stop_at_count: int, always_allow_eos: bool,
                            ties: bool = False, keep_invalid: bool = False,
                            chunk: int | None = None):
    """The large-n route's two stages, as the kernel takes them: each beam's
    best 2K candidates by (score, slot) -- or (score, tie id, slot) --, then
    the query's best 2K of those survivors in the same order.  With
    ``chunk``, the table route: first instances from the table
    (:func:`table_first`), and each beam's best 2K taken from its chunks'
    best 2K.  Equals ``beam_select_plain``."""
    first = None if chunk is None else (lambda t: table_first(t, lp.shape[-1]))
    tokens, cons, cand_lp = candidates_plain(
        buf, n_buf, win_tok, win_valid, win_lp, eos_ok, lp, prev_count, finished, eos=eos, pad=pad,
        stop_at_count=stop_at_count, always_allow_eos=always_allow_eos, keep_invalid=keep_invalid,
        first=first)
    B, n_par, ncand = tokens.shape
    bs = beam_scores[..., None]
    score = cons + bs
    two_k = 2 * K
    key = _select_key(score, _ties_of(tokens, ncand, lp.shape[-1], ties))
    slot = torch.arange(n_par * ncand, device=lp.device).reshape(n_par, ncand).expand(key.shape)

    def best(k_, s_, m):  # the m best (key, slot) pairs of each row, in order
        order = torch.sort(k_, dim=-1, descending=True, stable=True)[1][..., :m]
        return _g(k_, order), _g(s_, order)

    # the slots hold each key's slot in slot order, so a stable sort breaks
    # equal keys by slot
    step = ncand if chunk is None else chunk
    parts = [best(key[..., c:c + step], slot[..., c:c + step], two_k)
             for c in range(0, ncand, step)]
    bk, bsl = (torch.cat(p, -1) for p in zip(*parts))
    if len(parts) > 1:  # the reduction of each beam's chunks
        ordr = torch.sort(bsl, -1)[1]
        bk, bsl = best(_g(bk, ordr), _g(bsl, ordr), two_k)
    bk, bsl = bk.reshape(B, -1), bsl.reshape(B, -1)
    ordr = torch.sort(bsl, -1)[1]  # the survivors in slot order
    _, top_idx = best(_g(bk, ordr), _g(bsl, ordr), two_k)
    flat = score.reshape(B, -1)
    out = _epilogue(_g(flat, top_idx), top_idx, (cand_lp + bs).reshape(B, -1),
                    tokens.reshape(B, -1), ncand, K, eos)
    if need is None:
        return out, None
    return out, (need & (beam_scores + th_lp >= out[8][:, -1:])).any(-1)


def beam_select_warp_plain(buf, n_buf: int, win_tok, win_valid, win_lp, eos_ok, lp,
                           prev_count, finished, beam_scores, need, th_lp, *, K: int, eos: int,
                           pad: int, stop_at_count: int, always_allow_eos: bool,
                           ties: bool = False, keep_invalid: bool = False):
    """The warp route's algorithm in torch: each beam's first
    min(2K, ncand) candidates by (key, slot) as a sorted list; a survivor's
    rank in the query is its place in its own list plus, in every other
    list, the number of entries before it; the survivors ranked below 2K
    are the query's top 2K in rank order.  Equals ``beam_select_plain``."""
    tokens, cons, cand_lp = candidates_plain(
        buf, n_buf, win_tok, win_valid, win_lp, eos_ok, lp, prev_count, finished, eos=eos, pad=pad,
        stop_at_count=stop_at_count, always_allow_eos=always_allow_eos, keep_invalid=keep_invalid)
    B, n_par, ncand = tokens.shape
    bs = beam_scores[..., None]
    score = cons + bs
    two_k, L = 2 * K, min(2 * K, ncand)
    key = _select_key(score, _ties_of(tokens, ncand, lp.shape[-1], ties))
    order = torch.sort(key, dim=-1, descending=True, stable=True)[1][..., :L]
    lk = _g(key, order)  # [B, n_par, L] each beam's list
    ls = order + torch.arange(n_par, device=lp.device)[:, None] * ncand  # flat slots
    # entries of list k2 before survivor (k, p): [B, n_par, L, n_par, L]
    a_k, a_s = lk[:, :, :, None, None], ls[:, :, :, None, None]
    b_k, b_s = lk[:, None, None], ls[:, None, None]
    before = (b_k > a_k) | ((b_k == a_k) & (b_s < a_s))
    rank = before.sum((-1, -2))  # its own list's entries before it are its place p
    top_idx = torch.zeros((B, two_k), dtype=torch.int64, device=lp.device)
    keep = rank < two_k
    top_idx[torch.nonzero(keep)[:, 0], rank[keep]] = ls[keep]
    flat = score.reshape(B, -1)
    out = _epilogue(_g(flat, top_idx), top_idx, (cand_lp + bs).reshape(B, -1),
                    tokens.reshape(B, -1), ncand, K, eos)
    if need is None:
        return out, None
    return out, (need & (beam_scores + th_lp >= out[8][:, -1:])).any(-1)


def _better(ak, asl, bk, bsl):
    """(key desc, slot asc): a ranks before b."""
    return (ak > bk) | ((ak == bk) & (asl < bsl))


def merge_top(key, slot, ck, cs):
    """The wide route's merge (``warp_merge_top``) over rows of 64 sorted
    (key desc, slot asc) pairs: the better of ``key[e]`` and the chunk's
    (63 - e)-th pair, a bitonic sequence of the union's first 64, sorted by
    half-cleaners at strides 32 to 1."""
    rk, rs = ck.flip(-1), cs.flip(-1)
    take = _better(rk, rs, key, slot)
    key, slot = torch.where(take, rk, key), torch.where(take, rs, slot)
    e = torch.arange(64, device=key.device)
    for stride in (32, 16, 8, 4, 2, 1):
        lo = e[(e & stride) == 0]
        hi = lo + stride
        swap = _better(key[..., hi], slot[..., hi], key[..., lo], slot[..., lo])
        kl, kh = key[..., lo], key[..., hi]
        sl_, sh = slot[..., lo], slot[..., hi]
        key = key.clone()
        slot = slot.clone()
        key[..., lo], key[..., hi] = torch.where(swap, kh, kl), torch.where(swap, kl, kh)
        slot[..., lo], slot[..., hi] = torch.where(swap, sh, sl_), torch.where(swap, sl_, sh)
    return key, slot


def beam_select_wide_plain(buf, n_buf: int, win_tok, win_valid, win_lp, eos_ok, lp,
                           prev_count, finished, beam_scores, need, th_lp, *, K: int, eos: int,
                           pad: int, stop_at_count: int, always_allow_eos: bool,
                           ties: bool = False, keep_invalid: bool = False, first=None):
    """The wide route's stages: first instances (``first``, default
    :func:`dedup_mask`; the kernel's hash table is
    ``tests/test_torch_select_routes.py``'s mirror), each beam's keys, its
    running first 64 -- the first chunk of 64 keys sorted, each next sorted
    and merged in (:func:`merge_top`) unless no key of it ranks before the
    list's L-th --, then the beams' 64s merged in
    pairs, a level of a tree at a time, list 0's first 2K the query's picks
    in order.  Equals ``beam_select_plain``."""
    tokens, cons, cand_lp = candidates_plain(
        buf, n_buf, win_tok, win_valid, win_lp, eos_ok, lp, prev_count, finished, eos=eos, pad=pad,
        stop_at_count=stop_at_count, always_allow_eos=always_allow_eos, keep_invalid=keep_invalid,
        first=first)
    ncand = tokens.shape[-1]
    key = _select_key(cons + beam_scores[..., None], _ties_of(tokens, ncand, lp.shape[-1], ties))
    slots = torch.arange(ncand, device=lp.device).expand(key.shape)
    low = torch.iinfo(torch.int64).min  # the kernel's padding, key 0 unsigned
    top = None
    for c0 in range(0, ncand, 64):
        ck = torch.nn.functional.pad(key[..., c0:c0 + 64], (0, max(0, c0 + 64 - ncand)),
                                     value=low)
        cs = torch.nn.functional.pad(slots[..., c0:c0 + 64], (0, max(0, c0 + 64 - ncand)),
                                     value=2**31 - 1)
        order = torch.sort(ck, dim=-1, descending=True, stable=True)[1]  # slots ascend
        ck, cs = _g(ck, order), _g(cs, order)
        if top is None:
            top = (ck, cs)
            continue
        # a chunk with no key before the list's L-th is skipped
        L = min(2 * K, ncand)
        lk, ls = top[0][..., L - 1:L], top[1][..., L - 1:L]
        use = _better(ck, cs, lk, ls).any(-1, keepdim=True)
        merged = merge_top(*top, ck, cs)
        top = (torch.where(use, merged[0], top[0]), torch.where(use, merged[1], top[1]))
    B, n_par = tokens.shape[:2]
    flat = top[1] + torch.arange(n_par, device=lp.device)[:, None] * ncand  # flat slots
    lists = [(top[0][:, k], flat[:, k]) for k in range(n_par)]
    stride = 1
    while stride < n_par:
        for j in range(0, n_par - stride, 2 * stride):
            lists[j] = merge_top(*lists[j], *lists[j + stride])
        stride *= 2
    top_idx = lists[0][1][:, :2 * K]
    bs = beam_scores[..., None]
    out = _epilogue(_g((cons + bs).reshape(B, -1), top_idx), top_idx,
                    (cand_lp + bs).reshape(B, -1), tokens.reshape(B, -1), ncand, K, eos)
    if need is None:
        return out, None
    return out, (need & (beam_scores + th_lp >= out[8][:, -1:])).any(-1)


def wide_splits(n_par: int) -> int:
    """The wide route's CTAs a query (a cluster): one up to ``WIDE_WARPS``
    beams, else two, so a query's beams spread over two SMs.  (Four a query
    took 0.0601 ms against two's 0.0370 at [32, 32, 578] on an H100,
    ``bench_select_variants``: 32 clusters of four do not all fit one
    wave.)"""
    return 1 if n_par <= WIDE_WARPS else 2


def wide_table(n_par: int, ncand: int, two_k: int, k_out: int, splits: int):
    """The wide route's hash table entries a beam at ``splits`` CTAs a
    query: 2 ncand (a load of 1/2) where the CTA's shared memory holds them
    (``seal_beam_select_wide_smem``), else as many as fit down to 5/4
    ncand; None where not even that fits or the route cannot launch the
    shape (too many beams a CTA)."""
    from seal_tpu_torch.kernels import build

    smem, limit = build.lib().seal_beam_select_wide_smem, build.SMEM_LIMIT
    if smem(n_par, ncand, two_k, k_out, -(-5 * ncand // 4), splits) > limit:
        return None
    table = 2 * ncand
    while smem(n_par, ncand, two_k, k_out, table, splits) > limit:
        table -= 2
    return table


class SelectPlan(NamedTuple):
    """A selection's launch: its ``route`` (``ROUTES``' key) and C code, the
    per-beam stage's ``chunk`` and chunks a beam (table route; the wide
    route's hash table entries a beam and its CTAs a query), and the
    scratch keys a query needs (0: none)."""

    route: str
    code: int
    chunk: int
    n_chunks: int
    scratch: int


@functools.lru_cache(maxsize=256)
def select_plan(n_par: int, n_buf: int, w: int, K: int, ties: bool,
                route: str | None = None) -> SelectPlan:
    """The route of ``beam_select`` for beams of ``n_buf + w + 2``
    candidates: the warp route where a beam has at most 128 of them, 2K <=
    64 and n_par <= 32; else the wide route (a warp a beam in shared memory,
    :func:`wide_table`) where a beam has at most ``SERIAL_MAX``, 2K <= 64
    and n_par <= 32; else one CTA a query while its candidates fit (and a
    beam's at most ``SERIAL_MAX``, its serial dedup); else the large-n
    route (per beam, then per query) while a beam fits a CTA; else the
    table route.  The wide route takes :func:`wide_splits` CTAs a query, or
    more where its regions need it; ``seal_beam_select_wide_smem`` holds its
    limits.  ``route`` forces one (tests and measurements).  Raises where
    no route fits the shared memory.  Cached: the decode loop asks for the
    same few shapes every step (the route does not depend on the batch,
    ``keep_invalid`` or the soundness flags)."""
    from seal_tpu_torch.kernels import build

    so, limit = build.lib(), build.SMEM_LIMIT
    ncand = n_buf + w + 2
    n, two_k, t = n_par * ncand, 2 * K, int(ties)
    n_chunks = -(-ncand // SELECT_CHUNK)
    # the wide route's CTAs a query: from wide_splits up while its regions
    # do not fit (fewer beams a CTA)
    splits, table = 0, None
    for splits in range(wide_splits(n_par), min(8, n_par) + 1):
        table = wide_table(n_par, ncand, two_k, K, splits)
        if table is not None:
            break
    fits = {
        "warp": (ncand <= WARP_MAX[0] and two_k <= WARP_MAX[1] and n_par <= WARP_MAX[2]
                 and so.seal_beam_select_warp_smem(n_par, ncand, two_k, K, t) <= limit),
        "wide": table is not None,  # the C size query holds the route's limits
        "block": ncand <= SERIAL_MAX and so.seal_beam_select_smem(n, two_k, K, t) <= limit,
        "large": (ncand <= SERIAL_MAX
                  and so.seal_beam_select_large_smem(n_par, ncand, two_k, K, t) <= limit),
        "table": so.seal_beam_select_table_smem(n_par, SELECT_CHUNK, n_chunks, two_k, K,
                                                t) <= limit,
    }
    if route is None:
        route = next((r for r in ("warp", "wide", "block", "large", "table") if fits[r]), None)
        if route is None:
            raise ValueError(f"beam_select: {n_par} x {two_k} survivors per query exceed the "
                             "shared memory")
    elif not fits[route]:
        raise ValueError(f"beam_select: the {route} route cannot take {n_par} beams of {ncand} "
                         f"candidates at 2K = {two_k}")
    chunk, scratch = 0, 0
    if route == "large":
        chunk, n_chunks, scratch = ncand, 1, n_par * two_k
    elif route == "table":
        chunk = SELECT_CHUNK
        scratch = n_par * two_k * (n_chunks + (n_chunks > 1))
    elif route == "wide":  # chunk: the hash table's entries; n_chunks: CTAs a query
        chunk, n_chunks = table, splits
    else:
        n_chunks = 0
    return SelectPlan(route, _ROUTE_CODES[route], chunk, n_chunks, scratch)


def beam_select(buf, n_buf: int, win_tok, win_valid, win_lp, eos_ok, lp, prev_count, finished,
                beam_scores, need=None, th_lp=None, *, K: int, eos: int, pad: int, stop_at_count: int = 0,
                always_allow_eos: bool = False, ties: bool = False, keep_invalid: bool = False,
                route: str | None = None):
    """Candidate build, branches, dedup, top-2K and the continuation rule of
    one decode step, per query.

    ``buf``: the proposal buffer (tok, lp, valid) [B, n_par, n_buf], or
    None when no proposal round ran (``n_buf`` unfilled slots); unfilled
    slots are PAD candidates at PAD's log-prob.  ``win_*`` [B, n_par, w]: window slots; ``eos_ok``
    [B, n_par, 1] (may be a strided view): EOS membership; ``lp`` [B*n_par,
    V] f32: log-probs (the EOS and PAD columns are read from it);
    ``prev_count``, ``finished``, ``beam_scores`` [B, n_par].  With ``need``
    and ``th_lp`` [B, n_par], also the per-query ``unsound`` flag [B].
    Equal scores keep slot order, or with ``ties`` the (parent beam, token)
    order (V = ``lp``'s width sizes the token field).  With ``keep_invalid``
    a buffer slot that is not valid keeps its token and log-prob (the
    speculative mode's candidates).

    Returns (nine outputs of ``_select``, unsound or None).  CPU tensors run
    the plain version; CUDA tensors launch the kernel on
    :func:`select_plan`'s route (``route`` forces one; the table route
    needs every token in [0, V)).
    """
    if not lp.is_cuda:
        return beam_select_plain(buf, n_buf, win_tok, win_valid, win_lp, eos_ok, lp, prev_count,
                                 finished, beam_scores, need, th_lp, K=K, eos=eos, pad=pad,
                                 stop_at_count=stop_at_count, always_allow_eos=always_allow_eos,
                                 ties=ties, keep_invalid=keep_invalid)
    B, n_par = prev_count.shape
    w = win_tok.shape[-1]
    if n_par * (n_buf + w + 2) < 2 * K:
        raise ValueError(f"beam_select: {n_par * (n_buf + w + 2)} candidates for a top-{2 * K}")
    plan = select_plan(n_par, n_buf, w, K, bool(ties), route)
    if not _FN:
        _lookup()
    V = lp.shape[-1]
    bits = tie_bits(V, n_par) if ties else 0
    if (need is None) != (th_lp is None):
        raise ValueError("beam_select: need and th_lp go together")
    keep, args = _candidate_args(buf, n_buf, win_tok, win_valid, win_lp, eos_ok, lp, prev_count,
                                 finished, "beam_select")
    beam_scores = beam_scores.contiguous()
    _check(beam_scores, torch.float32)
    if need is not None:
        need, th_lp = need.contiguous(), th_lp.contiguous()
        _check(need, torch.bool, th_lp, torch.float32)
    dev = lp.device
    carved = _select_outputs(B, K, dev, need is not None)
    outs, unsound = carved[:9], carved[9]
    scratch_keys = scratch_slots = table = None
    if plan.scratch:  # each beam's top 2K keys (and their slots in the ties mode)
        scratch_keys = torch.empty(B * plan.scratch, dtype=torch.int64, device=dev)
        if ties:
            scratch_slots = torch.empty(B * plan.scratch, dtype=torch.int32, device=dev)
    if plan.route == "table":
        table = torch.empty((B * n_par, V), dtype=torch.int32, device=dev)
    opt = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    rc = _FN["select"](
        *args, beam_scores.data_ptr(), opt(need), opt(th_lp), B, n_par, n_buf, w, K, eos, pad,
        stop_at_count, int(always_allow_eos), bits, int(keep_invalid), NEG_INF, plan.code, V,
        plan.chunk, plan.n_chunks, *(t.data_ptr() for t in outs), opt(unsound),
        opt(scratch_keys), opt(scratch_slots), opt(table), _FN["stream"](lp),
    )
    del keep
    if rc:
        raise RuntimeError(f"beam_select: CUDA error {rc}")
    beam_select.launches += 1
    ROUTES[plan.route].launches += 1
    TIES.launches += int(ties)
    SPEC.launches += int(keep_invalid)
    return outs, unsound


beam_select.launches = 0


def beam_candidates(buf, n_buf: int, win_tok, win_valid, win_lp, eos_ok, lp, prev_count, finished,
                    *, eos: int, pad: int, stop_at_count: int = 0, always_allow_eos: bool = False,
                    keep_invalid: bool = False):
    """The candidate mode: ``beam_select``'s candidates of each beam, the
    branches and first-instance dedup applied, without selecting.

    Takes ``beam_select``'s candidate inputs and returns (tokens int32,
    constrained log-probs f32 -- ``NEG_INF`` where not allowed or a repeat
    --, log-probs f32), each [B, n_par, n_buf + w + 2] in slot order
    [buffer, window, EOS, PAD].

    CPU tensors run the plain version; CUDA tensors launch the kernel: a
    warp a beam row, its first instances from a hash table in shared
    memory, or past ``SERIAL_MAX`` candidates from a [rows, V] table in
    device memory.
    """
    kw = dict(eos=eos, pad=pad, stop_at_count=stop_at_count, always_allow_eos=always_allow_eos,
              keep_invalid=keep_invalid)
    if not lp.is_cuda:
        return candidates_plain(buf, n_buf, win_tok, win_valid, win_lp, eos_ok, lp, prev_count,
                                finished, **kw)
    from seal_tpu_torch.kernels import build

    B, n_par = prev_count.shape
    w = win_tok.shape[-1]
    ncand = n_buf + w + 2
    keep, args = _candidate_args(buf, n_buf, win_tok, win_valid, win_lp, eos_ok, lp, prev_count,
                                 finished, "beam_candidates")
    dev = lp.device
    V = lp.shape[-1]
    # past SERIAL_MAX a beam's first instances come from the table (F2)
    table = (torch.empty((B * n_par, V), dtype=torch.int32, device=dev)
             if ncand > SERIAL_MAX else None)
    tokens = torch.empty((B, n_par, ncand), dtype=torch.int32, device=dev)
    cons = torch.empty((B, n_par, ncand), dtype=torch.float32, device=dev)
    cand_lp = torch.empty((B, n_par, ncand), dtype=torch.float32, device=dev)
    rc = build.lib().seal_beam_candidates(
        *args, B * n_par, n_buf, w, eos, pad, stop_at_count, int(always_allow_eos),
        int(keep_invalid), NEG_INF, table.data_ptr() if table is not None else None, V,
        tokens.data_ptr(), cons.data_ptr(), cand_lp.data_ptr(),
        build.stream_ptr(lp),
    )
    del keep
    build.check(rc, "beam_candidates")
    beam_candidates.launches += 1
    CAND_TABLE.launches += table is not None
    return tokens, cons, cand_lp


beam_candidates.launches = 0


def beam_select_top_plain(top_cons, top_idx, lp, beam_scores, n_par: int, K: int, eos: int,
                          tokens=None):
    B = top_cons.shape[0]
    V = lp.shape[-1]
    if tokens is None:
        ncand = V
        cand_lp = lp.reshape(B, n_par * V)
        flat_tok = torch.arange(V, dtype=torch.int32, device=lp.device).repeat(n_par).expand(B, -1)
    else:
        ncand = tokens.shape[-1]
        cand_lp = torch.gather(lp, 1, tokens.long()).reshape(B, n_par * ncand)
        flat_tok = tokens.reshape(B, n_par * ncand)
    bs = beam_scores[:, :n_par, None].expand(B, n_par, ncand).reshape(B, n_par * ncand)
    return _epilogue(top_cons, top_idx, cand_lp + bs, flat_tok, ncand, K, eos)


def beam_select_top(top_cons, top_idx, lp, beam_scores, n_par: int, K: int, eos: int,
                    tokens=None):
    """Step 0's selection after kernel 3: ``top_cons``/``top_idx`` [B, 2K]
    rank the flat [B, n_par * V] constrained scores (token = slot % V);
    ``lp`` [B*n_par, V] gives the unconstrained scores (plus the parent's
    ``beam_scores``).  With ``tokens`` (int32 [B*n_par, ncand]) the flat
    axis is [B, n_par * ncand] and slot s of parent k is token
    ``tokens[k, s % ncand]`` (free generation).  Returns ``_select``'s nine
    outputs.

    CPU tensors run the plain version; CUDA tensors launch kernel 8.
    """
    if not lp.is_cuda:
        return beam_select_top_plain(top_cons, top_idx, lp, beam_scores, n_par, K, eos, tokens)
    from seal_tpu_torch.kernels import build

    B = top_cons.shape[0]
    V = lp.shape[-1]
    if top_cons.shape != (B, 2 * K) or top_idx.dtype != torch.int64:
        raise ValueError("beam_select_top: top_cons/top_idx must be [B, 2K] (f32, int64)")
    if lp.dtype != torch.float32 or lp.stride(1) != 1 or lp.shape[0] != B * n_par:
        raise ValueError("beam_select_top: lp must be f32 [B*n_par, V] with unit column stride")
    top_cons, top_idx = top_cons.contiguous(), top_idx.contiguous()
    if beam_scores.dtype != torch.float32 or beam_scores.stride(1) != 1:
        raise ValueError("beam_select_top: beam_scores must be f32 with unit column stride")
    ncand = V
    if tokens is not None:
        tokens = tokens.contiguous()
        _check(tokens, torch.int32)
        if tokens.dim() != 2 or tokens.shape[0] != B * n_par:
            raise ValueError("beam_select_top: tokens must be int32 [B*n_par, ncand]")
        ncand = tokens.shape[1]
    outs = _select_outputs(B, K, lp.device)[:9]
    # past 48 KB of picks a query (1,365 beams) they live in device memory
    pick_bytes = 16 * 2 * K + 4 * K
    scratch = (torch.empty((B, -(-pick_bytes // 8)), dtype=torch.int64, device=lp.device)
               if pick_bytes > SELECT_TOP_SMEM else None)
    rc = build.lib().seal_beam_select_top(
        top_cons.data_ptr(), top_idx.data_ptr(), lp.data_ptr(), lp.stride(0),
        beam_scores.data_ptr(), beam_scores.stride(0),
        tokens.data_ptr() if tokens is not None else None, B, n_par, ncand, K, eos, NEG_INF,
        *(t.data_ptr() for t in outs), scratch.data_ptr() if scratch is not None else None,
        build.stream_ptr(lp),
    )
    build.check(rc, "beam_select_top")
    beam_select.launches += 1
    FREE.launches += int(tokens is not None)
    return outs


def _candidate_args(buf, n_buf, win_tok, win_valid, win_lp, eos_ok, lp, prev_count, finished,
                    name):
    """Checks the candidate inputs that ``beam_select`` and
    ``beam_candidates`` share and returns (the tensors the pointers point
    into, which the caller keeps alive over the call; the C arguments buffer
    tok/lp/valid, window tok/valid/lp, eos_ok and its row stride, lp and its
    row stride, prev_count, finished)."""
    B, n_par = prev_count.shape
    if lp.dtype != torch.float32 or lp.stride(1) != 1 or lp.shape[0] != B * n_par:
        raise ValueError(f"{name}: lp must be f32 [B*n_par, V] with unit column stride")
    win_tok, win_valid, win_lp = (t.contiguous() for t in (win_tok, win_valid, win_lp))
    prev_count = prev_count.to(torch.int32).contiguous()
    finished = finished.contiguous()
    _check(win_tok, torch.int32, win_valid, torch.bool, win_lp, torch.float32, eos_ok,
           torch.bool, finished, torch.bool)
    eos_stride = _row_stride(eos_ok, "eos_ok")
    if buf is not None:
        buf = tuple(t.contiguous() for t in buf)
        _check(buf[0], torch.int32, buf[1], torch.float32, buf[2], torch.bool)
        if buf[0].shape[-1] != n_buf:
            raise ValueError(f"{name}: buffer width differs from n_buf")
    keep = (buf, win_tok, win_valid, win_lp, prev_count, finished)
    ptrs = tuple(t.data_ptr() for t in buf) if buf is not None else (None, None, None)
    return keep, (*ptrs, win_tok.data_ptr(), win_valid.data_ptr(), win_lp.data_ptr(),
                  eos_ok.data_ptr(), eos_stride, lp.data_ptr(), lp.stride(0),
                  prev_count.data_ptr(), finished.data_ptr())


def _select_outputs(B, K, dev, unsound: bool = False):
    """The nine outputs of ``_select`` and ``unsound`` [B] (or None): ten
    tensors from five allocations, three of them unbound or split in one
    call each (a view costs the host about a third of an allocation, and
    carving all ten from one buffer cost more than allocating them)."""
    i32 = torch.empty((2, B, 2 * K), dtype=torch.int32, device=dev).unbind(0)
    f32 = torch.empty((2, B, 2 * K), dtype=torch.float32, device=dev).unbind(0)
    sel = torch.empty((2, B, K), dtype=torch.int32, device=dev).unbind(0)
    flags = torch.empty(B * (3 * K + 1), dtype=torch.bool, device=dev).split_with_sizes(
        (B * 2 * K, B * K, B))
    return (i32[0], i32[1], f32[0], flags[0].view(B, 2 * K), sel[0], sel[1],
            torch.empty((B, K), dtype=torch.float32, device=dev), flags[1].view(B, K), f32[1],
            flags[2] if unsound else None)


def _lookup():
    """kernel 8's C entry point and the stream reader, looked up once."""
    from seal_tpu_torch.kernels import build

    _FN["select"] = build.lib().seal_beam_select
    _FN["stream"] = build.stream_ptr


def _row_stride(t, name):
    """Element stride between the rows of ``t`` [..., n] (unit column
    stride, rows evenly spaced); raises otherwise."""
    if t.stride(-1) != 1 and t.shape[-1] > 1:
        raise ValueError(f"{name}: unit column stride required")
    if t.dim() == 1:
        return t.shape[-1]
    s = t.stride(-2)
    span = s
    for d in range(t.dim() - 3, -1, -1):  # each leading axis steps over the ones after it
        span *= t.shape[d + 1]
        if t.shape[d] > 1 and t.stride(d) != span:
            raise ValueError(f"{name}: rows must be evenly spaced")
    return s


def _check(*pairs):
    for t, dt in zip(pairs[::2], pairs[1::2]):
        if t.dtype != dt or not t.is_cuda:
            raise ValueError(f"kernel 8: expected a CUDA {dt} tensor, got {t.dtype} on {t.device}")
