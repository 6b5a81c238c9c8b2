"""Kernel 21 wrapper: diverse beam groups' selection
(``csrc/diverse_select.cu``), with its plain version.

Replaces ``seal_tpu/decoding/constrained.py:_select_diverse`` (:1125-1171)
and ``dispatch_select``'s ``cons + beam_scores`` (:1283-1286): the beams
split into G groups of gs; group by group, each candidate's constrained
score plus its beam's score, less ``penalty`` times how often the earlier
groups picked its token at this step, ranks the group's [gs * N] row; the
top 2*gs are the group's history and the first gs that are not EOS its
continuing beams.  The penalized score is both what selects and what is
recorded.

Candidates are a list with its token table ([B, K, N] from kernel 8's
candidate mode or free generation's top-``top_m``) or V-wide rows where the
token is the column (step 0 under the corpus mask, ``exact_mask``).  The
order is ``lax.top_k``'s, or under ``ties`` JAX's (score, (beam in group,
token)) order, as kernel 8's.  Every output is a selection or JAX's f32
arithmetic in its order, so the kernel equals the plain version bit for bit.

On the card a call takes one of three routes (:func:`route`, counted in
``ROUTES``; every call also counts once in ``diverse_select.launches``):

* ``"wide"`` (V-wide rows): 2 launches whatever G.  Each (query, group)
  row's unpenalized top M (:func:`wide_survivors`) by kernel 3's radix
  select, then one CTA a query penalizes, sorts and finishes the groups in
  order.  A penalty only lowers a score and a V-wide token is one column,
  so a group's penalized top 2*gs lies in its unpenalized top M (the lemma
  in ``csrc/diverse_select.cu``); :func:`diverse_select_topm_plain` mirrors
  the schedule, and the kernel counts the groups the lemma would fail on
  in a device counter (:func:`proof_failures`) that must read 0.
* ``"list"`` (a token table): 1 launch, one CTA a query with each group's
  slots in shared memory, up to ``LIST_MAX`` slots a group (past them the
  chunked route's many CTAs win: ``chip_smoke.py``'s sweep on an H100).
* ``"chunked"``: 2 launches a group, past the other two's limits (M past
  ``WIDE_MAX``, a list past ``LIST_MAX``, a tie field narrower than
  the rows, a penalty that is not finite).
"""

from __future__ import annotations

import math

import torch

from seal_tpu_torch.kernels import Launches
from seal_tpu_torch.kernels import row_topk as k3
from seal_tpu_torch.kernels.beam_select import (
    NEG_INF,
    _check,
    _select_outputs,
    beam_tok_tie,
    tie_bits,
    top_by_score_then_id,
)
from seal_tpu_torch.kernels.row_topk import row_topk_plain

WIDE_MAX = 512  # survivors a group the wide route takes (kernel 3 places up to 512 by rank)
# slots a group the list route takes (it can sort up to 16,384 in shared
# memory: ``force="list"``, for measurements)
LIST_MAX = 2048
ROUTES = {name: Launches() for name in ("wide", "list", "chunked")}


def wide_survivors(K: int, groups: int, penalty: float) -> int:
    """M: the unpenalized top a group's V-wide row must keep so that its
    penalized top 2*gs lies inside, 2gs + (G - 1) gs^2 (2gs where nothing is
    penalized)."""
    gs = K // groups
    return 2 * gs + ((groups - 1) * gs * gs if penalty > 0.0 and groups > 1 else 0)


def diverse_select_plain(cons, tokens, beam_scores, *, groups: int, penalty: float, eos: int,
                         ties: bool = False, vocab: int = 0, mask=None):
    B, K = beam_scores.shape
    N = cons.shape[-1]
    gs = K // groups
    cons = cons.reshape(B, K, N)
    if mask is not None:
        cons = torch.where(mask, cons, NEG_INF)
    if tokens is None:
        tokens = torch.arange(N, dtype=torch.int32, device=cons.device).expand(B, K, N)
    tokens = tokens.reshape(B, K, N)
    cum = cons + beam_scores[..., None]
    pen = torch.tensor(penalty, dtype=torch.float32, device=cons.device)
    hist, sel = [], []
    for g in range(groups):
        sc, tk = cum[:, g * gs:(g + 1) * gs], tokens[:, g * gs:(g + 1) * gs]
        if g > 0 and penalty > 0.0:
            freq = sum((tk == p[:, None, None]).to(torch.int32) for p in torch.cat(
                [s[0] for s in sel], -1).unbind(-1))
            sc = sc - pen * freq.to(torch.float32)
        flat, flat_tok = sc.reshape(B, gs * N), tk.reshape(B, gs * N)
        if ties:
            top_idx = top_by_score_then_id(flat, beam_tok_tie(flat_tok, N, vocab), 2 * gs)
        else:
            top_idx = row_topk_plain(flat, 2 * gs)[1]
        top_sc = torch.gather(flat, -1, top_idx)
        top_tok = torch.gather(flat_tok, -1, top_idx)
        top_par = (top_idx // N).to(torch.int32) + g * gs
        finite = top_sc > NEG_INF / 4
        cont = torch.argsort((top_tok == eos).to(torch.int8), dim=-1, stable=True)[:, :gs]
        hist.append((top_tok, top_par, top_sc, finite))
        sel.append(tuple(torch.gather(x, -1, cont) for x in (top_tok, top_par, top_sc, finite)))
    return tuple(torch.cat(xs, -1) for xs in zip(*hist)) + tuple(
        torch.cat(xs, -1) for xs in zip(*sel))


def diverse_select_topm_plain(cons, beam_scores, *, groups: int, penalty: float, eos: int,
                              ties: bool = False, vocab: int = 0, mask=None):
    """The wide route's schedule on V-wide rows (token = column), in torch:
    each (query, group) row's unpenalized top M in the order (launch 1),
    then group by group the M survivors penalized against the picks so
    far, sorted by (key, slot) and finished as the plain version finishes
    (launch 2).  Returns the eight outputs and the count of groups with
    fewer than 2*gs unpenalized survivors where M is short of the row (the
    kernel's proof counter; 0 by the lemma)."""
    B, K = beam_scores.shape
    N = cons.shape[-1]
    gs = K // groups
    M = min(wide_survivors(K, groups, penalty), gs * N)
    cons = cons.reshape(B, K, N)
    if mask is not None:
        cons = torch.where(mask, cons, NEG_INF)
    cum = (cons + beam_scores[..., None]).reshape(B, groups, gs * N)
    top_val, top_idx = row_topk_plain(cum, M)  # launch 1
    bits = tie_bits(vocab, gs) if ties else 0
    pen = torch.tensor(penalty, dtype=torch.float32, device=cons.device)
    hist, sel, picks, short = [], [], [], 0
    for g in range(groups):
        f, sc = top_idx[:, g], top_val[:, g]
        tok = (f % N).to(torch.int32)
        if g > 0 and penalty > 0.0:
            freq = (tok[..., None] == torch.cat(picks, -1)[:, None, :]).sum(-1)
            if M < gs * N:
                short += int(((freq == 0).sum(-1) < 2 * gs).sum())
            sc = sc - pen * freq.to(torch.float32)
        tie = ((f // N) << bits) + tok.clamp(0, (1 << bits) - 1) if ties else f
        # equal keys order by slot, as the kernel's sort breaks them
        by_slot = torch.argsort(f, dim=-1)
        sc, f, tok, tie = (torch.gather(x, -1, by_slot) for x in (sc, f, tok, tie))
        top = top_by_score_then_id(sc, tie.to(torch.int32), 2 * gs)
        top_sc, top_tok = torch.gather(sc, -1, top), torch.gather(tok, -1, top)
        top_par = (torch.gather(f, -1, top) // N).to(torch.int32) + g * gs
        finite = top_sc > NEG_INF / 4
        cont = torch.argsort((top_tok == eos).to(torch.int8), dim=-1, stable=True)[:, :gs]
        hist.append((top_tok, top_par, top_sc, finite))
        sel.append(tuple(torch.gather(x, -1, cont) for x in (top_tok, top_par, top_sc, finite)))
        picks.append(sel[-1][0])
    return tuple(torch.cat(xs, -1) for xs in zip(*hist)) + tuple(
        torch.cat(xs, -1) for xs in zip(*sel)), short


def route(B: int, K: int, N: int, *, groups: int, penalty: float, ties: bool = False,
          vocab: int = 0, wide: bool):
    """The card's route for a call: (``"wide"``, kernel 3's plan of launch
    1), (``"list"``, None) or (``"chunked"``, None).  ``wide``: token =
    column."""
    from seal_tpu_torch.kernels import build

    gs = K // groups
    if wide:
        M = min(wide_survivors(K, groups, penalty), gs * N)
        tie_ok = not ties or N <= 1 << tie_bits(vocab, gs)
        if M <= WIDE_MAX and tie_ok and math.isfinite(penalty):
            try:
                return "wide", k3.plan(B * groups, gs * N, M)
            except ValueError:  # past the card's shared memory
                pass
    elif gs * N <= LIST_MAX and _list_fits(gs * N, gs, K):
        return "list", None
    return "chunked", None


def _list_fits(n: int, gs: int, K: int) -> bool:
    """Whether the list route can sort a group's ``n`` slots in shared
    memory."""
    from seal_tpu_torch.kernels import build

    return 0 < build.lib().seal_diverse_list_smem(n, gs, K) <= build.SMEM_LIMIT


def proof_failures(device) -> int:
    """Groups the wide route found on ``device`` with fewer than 2*gs
    unpenalized survivors since the kernel library loaded (must be 0): a
    device variable of the library, so no call allocates it."""
    import ctypes

    from seal_tpu_torch.kernels import build

    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        build.check(build.lib().seal_diverse_proof_failures(ctypes.byref(out)),
                    "diverse_select.proof_failures")
    return out.value


def diverse_select(cons, tokens, beam_scores, *, groups: int, penalty: float, eos: int,
                   ties: bool = False, vocab: int = 0, mask=None, force: str | None = None):
    """One step's selection of ``groups`` diverse beam groups per query.

    ``cons`` f32 [B, K, N]: constrained log-probs without the beam scores
    (``NEG_INF`` where not allowed); ``tokens`` int32 [B, K, N], or None
    where the token is the column; ``beam_scores`` f32 [B, K]; ``mask``
    bool [N] (with ``tokens`` None): columns allowed at all.  ``vocab``
    sizes the tie id's token field under ``ties``.  Returns
    ``_select_diverse``'s eight outputs: the [B, 2K] history (each group's
    top 2*gs: token, parent, penalized score, finite) and the [B, K]
    selection (each group's gs continuing beams).

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the route :func:`route` picks (2, 1 or 2G launches, counted as one
    call), or on ``force="chunked"`` (measurements: the route every call
    took before the other two) or, for a token table past ``LIST_MAX``
    slots a group that its sort still holds, ``force="list"``.
    """
    B, K = beam_scores.shape
    N = cons.shape[-1]
    if groups < 1 or K % groups:
        raise ValueError(f"diverse_select: {K} beams do not split into {groups} groups")
    gs = K // groups
    if gs * N < 2 * gs:
        raise ValueError(f"diverse_select: {N} candidates a beam for a top-{2 * gs}")
    bits = tie_bits(vocab, gs) if ties else 0
    kw = dict(groups=groups, penalty=penalty, eos=eos, ties=ties, vocab=vocab, mask=mask)
    if not cons.is_cuda:
        return diverse_select_plain(cons, tokens, beam_scores, **kw)
    from seal_tpu_torch.kernels import build

    if cons.numel() != B * K * N:
        raise ValueError(f"diverse_select: cons must be [B, K, N] = [{B}, {K}, {N}]")
    if mask is not None and (tokens is not None or mask.shape != (N,)):
        raise ValueError("diverse_select: a mask [N] goes with token = column only")
    cons, beam_scores = cons.contiguous(), beam_scores.contiguous()
    _check(cons, torch.float32, beam_scores, torch.float32)
    if tokens is not None:
        tokens = tokens.contiguous()
        _check(tokens, torch.int32)
        if tokens.numel() != B * K * N:
            raise ValueError("diverse_select: tokens must be [B, K, N]")
    if mask is not None:
        mask = mask.contiguous()
        _check(mask, torch.bool)
    dev = cons.device
    name, layout = route(B, K, N, groups=groups, penalty=penalty, ties=ties, vocab=vocab,
                         wide=tokens is None)
    if force is not None:
        forced_list = force == "list" and tokens is not None and _list_fits(gs * N, gs, K)
        if force not in ("chunked", name) and not forced_list:
            raise ValueError(f"diverse_select: route {force!r} cannot serve this call ({name})")
        name = force
    outs = _select_outputs(B, K, dev)[:8]
    out_ptrs = [t.data_ptr() for t in outs]
    opt = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    common = (B, K, N, groups, eos, bits, int(penalty > 0.0), penalty, NEG_INF)
    stream = build.stream_ptr(cons)
    if name == "wide":
        M = min(wide_survivors(K, groups, penalty), gs * N)
        top_val = torch.empty((B * groups, M), dtype=torch.float32, device=dev)
        top_idx = torch.empty((B * groups, M), dtype=torch.int64, device=dev)
        rc = build.lib().seal_diverse_wide(
            cons.data_ptr(), opt(mask), beam_scores.data_ptr(), *common, M, *layout.launch,
            top_val.data_ptr(), top_idx.data_ptr(), *out_ptrs, stream)
    elif name == "list":
        rc = build.lib().seal_diverse_list(cons.data_ptr(), tokens.data_ptr(),
                                           beam_scores.data_ptr(), *common, *out_ptrs, stream)
    else:
        if build.lib().seal_diverse_smem(gs * N, gs, K) > build.SMEM_LIMIT:
            raise ValueError(f"diverse_select: {gs * N} candidates a group exceed the shared "
                             "memory")
        n_part = build.lib().seal_diverse_chunks(gs * N) * 2 * gs
        part_key = torch.empty((B, n_part), dtype=torch.int64, device=dev)
        part_slot = torch.empty((B, n_part), dtype=torch.int32, device=dev)
        rc = build.lib().seal_diverse_select(
            cons.data_ptr(), opt(tokens), opt(mask), beam_scores.data_ptr(), *common,
            part_key.data_ptr(), part_slot.data_ptr(), *out_ptrs, stream)
    build.check(rc, f"diverse_select({name})")
    diverse_select.launches += 1
    ROUTES[name].launches += 1
    return outs


diverse_select.launches = 0
