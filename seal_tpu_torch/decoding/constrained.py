"""FM-index-constrained beam search, fast-exact path (counterpart of
``seal_tpu/decoding/constrained.py``).

Semantics are the JAX module's (see its docstring): candidates are selected
by constrained scores and accumulate unconstrained ones; every candidate of
every step is recorded for host extraction; the allowed set of each beam is
exact.  Each step takes one exact proposal round (the top ``exact_chunk``
LM tokens validated by membership queries, plus a BWT slab and window of
the beam's own interval), selects, and then proves that no token the round
missed could have reached the selection cutoff.  A step that cannot be
proven sound is flagged, and the caller re-runs the whole decode with
``force_full=True`` (every step through the proven proposal loop).

What changed in translation:

* The ``lax.scan`` over steps is a Python loop, and ``lax.cond`` /
  ``lax.while_loop`` are Python control flow on ``.any()``; each costs a
  host sync.
* ``_sel1`` (masked reductions that dodge TPU scalar gathers) is
  ``torch.gather``.
* Not ported, because they work around the TPU: ``check_dense_budget`` /
  ``DENSE_GUARD_BACKENDS`` (a TPU worker fault) and the one-hot-matmul
  block gather of ``_exact_topk`` (the TPU's slow scalar gathers).  Every
  top-k is one exact row top-k, ``kernels.row_topk``.
* ``force_decoding_from`` starts every beam's range at the forced
  sequence's (kernel 5).  Step 0 still picks its token under the dense
  corpus mask and then extends the forced range, as the JAX decoder does.
* Not ported yet (``DecodeConfig`` raises ``NotImplementedError``): the
  sample, diverse, speculative, ``exact_mask``, ``exact_ties`` and
  ``disable_fm_index`` modes, ``forced_bos``, the top-k warper and
  ``adjust_logits_fn``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from seal_tpu.index.fm_index import SHIFT
from seal_tpu_torch.kernels.row_topk import row_topk
from seal_tpu_torch.kernels.triton_logsoftmax import log_softmax_ban
from seal_tpu_torch.models import bart
from seal_tpu_torch.ops import fm_ops

NEG_INF = float(np.finfo(np.float32).min) / 2  # large-negative, -inf-safe


class SingleIndexOps:
    """Constraint-op adapter over one :class:`TorchFMIndex`."""

    def __init__(self, index):
        self.index = index

    def full_range(self, shape):
        return self.index.full_range(shape)

    def range_for(self, tokens, lengths):
        return fm_ops.range_for_sequences(self.index, tokens, lengths)

    def corpus_mask(self):
        return self.index.corpus_counts > 0

    def contains(self, tokens, lo, hi):
        return fm_ops.contains_tokens(self.index, tokens, lo, hi)

    def window_gather(self, lo, hi, w, lp, fill):
        return fm_ops.window_gather(self.index, lo, hi, w, lp, fill)

    def extend(self, tokens, lo, hi):
        return fm_ops.extend_ranges(self.index, tokens, lo, hi)

    def range_size(self, lo, hi):
        return hi - lo

    def window_exhaustive(self, lo, hi, w):
        """True where the w-row window enumerates the whole interval."""
        return (hi - lo) <= w

    def interval_covered(self, lo, hi, rows_done):
        """True where the first ``rows_done`` rows enumerate all of [lo, hi)."""
        return (hi - lo) <= rows_done

    def bucket_counts(self, lo, hi):
        return fm_ops.bucket_counts(self.index, lo, hi)

    def bucket_size(self):
        return self.index.bucket_size


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Generation knobs; same names and defaults as the JAX package's."""

    num_beams: int = 5
    max_length: int = 25  # total decoder length incl. decoder_start
    min_length: int = 3
    eos_token_id: int = 2
    pad_token_id: int = 1
    decoder_start_token_id: int = 2
    stop_at_count: int = 0
    always_allow_eos: bool = False
    window: int = 128  # BWT rows enumerated per beam per step
    exact_chunk: int = 64  # LM candidates validated in proposal round 0
    exact_loop_chunk: int = 0  # LM candidates per straggler round (0 = auto)
    force_full: bool = False  # every step through the proven proposal loop
    force_decoding_from: Optional[Tuple[int, ...]] = None  # forced range prefix
    top_m: int = 256  # read by the speculative and sample modes only
    # --- modes of the JAX package not ported yet: must stay at defaults ---
    forced_bos_token_id: Optional[int] = None
    disable_fm_index: bool = False
    speculative: bool = False
    exact_mask: bool = False
    exact_ties: bool = False
    sample: bool = False
    topk: int = 0
    adjust_logits_fn: Optional[Callable] = None
    num_groups: int = 1
    diversity_penalty: float = 0.0

    def __post_init__(self):
        unported = {
            "forced_bos_token_id": self.forced_bos_token_id is not None,
            "disable_fm_index": self.disable_fm_index,
            "speculative": self.speculative,
            "exact_mask": self.exact_mask,
            "exact_ties": self.exact_ties,
            "sample": self.sample,
            "topk": self.topk > 0,
            "adjust_logits_fn": self.adjust_logits_fn is not None,
            "diverse groups": self.num_groups > 1 or self.diversity_penalty != 0.0,
        }
        asked = [name for name, on in unported.items() if on]
        if asked:
            raise NotImplementedError(
                f"not ported to seal_tpu_torch yet: {', '.join(asked)} "
                "(use seal_tpu for these modes)"
            )

    @property
    def num_steps(self) -> int:
        return max(self.max_length - 1, 0)


@dataclasses.dataclass
class BeamSearchOutput:
    """Decode outputs (see the JAX package's ``BeamSearchOutput``)."""

    cand_tokens: Any  # int32 [S, B, 2K]   all candidates per step
    cand_parents: Any  # int32 [S, B, 2K]  parent beam of each candidate
    cand_scores: Any  # f32  [S, B, 2K]    cumulative unconstrained scores
    cand_finite: Any  # bool [S, B, 2K]    constrained score was finite
    sel_tokens: Any  # int32 [S, B, K]     continuing-beam tokens
    sel_parents: Any  # int32 [S, B, K]
    final_scores: Any  # f32 [B, K]
    final_tokens: Any  # int32 [B, K, L]
    final_valid: Any  # bool [B, K]        never back-filled from a masked candidate
    fallback_steps: Any = None  # int []   steps whose fast proof failed


def resolve_window(window: int, num_beams: int) -> int:
    """0/None = auto: 32 rows for beams <= 16, else 128 (the JAX package's
    rule for the exact path)."""
    if window:
        return window
    return 32 if num_beams <= 16 else 128


def _apply_min_length(cur_len: int, cfg: DecodeConfig) -> int:
    """Column to ban (EOS while cur_len < min_length), or -1."""
    return cfg.eos_token_id if cur_len < cfg.min_length else -1


def _log_softmax(logits, cur_len: int, cfg: DecodeConfig):
    """f32 log-softmax with the min-length EOS ban (kernel 4)."""
    return log_softmax_ban(logits, _apply_min_length(cur_len, cfg), NEG_INF)


def _gather(x, idx):
    return torch.gather(x, -1, idx.long())


def _top_idx(score, k: int):
    """Indices of the top-k by score, ties to the lower index (kernel 3)."""
    lead = score.shape[:-1]
    return row_topk(score.reshape(-1, score.shape[-1]), k)[1].reshape(*lead, k)


def _dedup_mask(tokens):
    """Keep-mask of the FIRST instance of each token id within a row."""
    n = tokens.shape[-1]
    j_lt_i = torch.ones((n, n), dtype=torch.bool, device=tokens.device).tril(-1)
    dup = ((tokens[..., :, None] == tokens[..., None, :]) & j_lt_i).any(-1)
    return ~dup


def _exact_slots(ops, cfg: DecodeConfig, lp, lo, hi):
    """Window slots (with log-probs, kernel 2) plus explicit EOS/PAD slots.
    ``lp`` is FLAT [B*K, V]."""
    B, K = lo.shape
    win_tok, win_valid, win_lp = ops.window_gather(lo, hi, cfg.window, lp, cfg.pad_token_id)
    dev = lo.device
    eos_tok = torch.full((B, K, 1), cfg.eos_token_id, dtype=torch.int32, device=dev)
    eos_lp = lp[:, cfg.eos_token_id].reshape(B, K, 1)
    pad_tok = torch.full((B, K, 1), cfg.pad_token_id, dtype=torch.int32, device=dev)
    pad_lp = lp[:, cfg.pad_token_id].reshape(B, K, 1)
    return win_tok, win_valid, win_lp, eos_tok, eos_lp, pad_tok, pad_lp


def _exact_proposals(
    ops, cfg: DecodeConfig, lp, lo, hi, prev_count, finished, pad_lp, eos_tok,
    round0_only: bool = False,
):
    """Per beam, the ``2K`` best *allowed* tokens by LM log-prob.

    Round 0 validates the exact top-``chunk`` LM tokens and enumerates a
    ``chunk``-row slab of the interval; later rounds (the full loop only)
    sweep wider chunks past the consumed (lp, token) threshold under
    bucket-support pruning until every beam is complete, covered, dead or
    exempt.  ``round0_only`` stops after round 0 and also returns the
    beams still unproven (``need``) and their threshold (``th_lp``).
    ``lp`` is FLAT [B*K, V].  See the JAX function for the proofs.
    """
    B, K = lo.shape
    V = lp.shape[-1]
    dev = lo.device
    n_buf = 2 * cfg.num_beams
    chunk = min(V, max(cfg.exact_chunk, 2 * n_buf))
    chunk_l = min(V, max(cfg.exact_loop_chunk or 4 * chunk, chunk))

    count_eff = torch.where(finished, 0, prev_count)
    stop_trig = (count_eff <= cfg.stop_at_count) & (cfg.stop_at_count > 0)
    exempt = finished | stop_trig | ops.window_exhaustive(lo, hi, cfg.window)
    v_idx = torch.arange(V, dtype=torch.int32, device=dev)

    def merge_round(buf_tok, buf_lp, buf_valid, top_tok, top_lp, valid, rows_prev, width):
        # the interval's own BWT rows [lo + rows_prev, +width): allowed by
        # construction
        s_lo = torch.minimum(lo + rows_prev, hi)
        s_hi = torch.minimum(s_lo + width, hi)
        slab_tok, slab_ok, slab_lp = ops.window_gather(s_lo, s_hi, width, lp, 0)
        slab_ok = slab_ok & (slab_lp > NEG_INF / 2)
        all_tok = torch.cat([buf_tok, top_tok, slab_tok], -1)
        all_lp = torch.cat([buf_lp, top_lp, slab_lp], -1)
        all_valid = torch.cat([buf_valid, valid, slab_ok], -1)
        n = all_tok.shape[-1]
        uniq = torch.where(
            all_valid, all_tok, V + torch.arange(n, dtype=torch.int32, device=dev)
        )
        fresh = _dedup_mask(uniq)
        rank_score = torch.where(all_valid & fresh, all_lp, NEG_INF)
        keep = _top_idx(rank_score, n_buf)
        return _gather(all_tok, keep), _gather(all_lp, keep), _gather(all_valid & fresh, keep)

    def round0():
        buf_tok = torch.zeros((B, K, n_buf), dtype=torch.int32, device=dev)
        buf_lp = torch.full((B, K, n_buf), NEG_INF, dtype=torch.float32, device=dev)
        buf_valid = torch.zeros((B, K, n_buf), dtype=torch.bool, device=dev)
        top_lp0, top_tok0 = row_topk(lp, chunk)
        top_tok0 = top_tok0.reshape(B, K, chunk).to(torch.int32)
        top_lp0 = top_lp0.reshape(B, K, chunk)
        ok0 = ops.contains(torch.cat([top_tok0, eos_tok], -1), lo, hi)
        eos_ok = ok0[..., chunk:]
        valid0 = ok0[..., :chunk] & (top_lp0 > NEG_INF / 2)
        buf = merge_round(buf_tok, buf_lp, buf_valid, top_tok0, top_lp0, valid0, 0, chunk)
        th_lp = top_lp0[..., -1]
        th_ix = top_tok0[..., -1]
        dead = top_lp0[..., 0] <= NEG_INF / 2  # proposal space exhausted
        covered = ops.interval_covered(lo, hi, chunk)
        return buf, th_lp, th_ix, dead, covered, eos_ok

    def unproven(buf, th_lp, dead, covered):
        _, buf_lp, buf_valid = buf
        complete = (buf_valid.sum(-1) >= n_buf) & (buf_lp[..., -1] >= th_lp)
        return ~exempt & ~dead & ~covered & ~complete

    def skipped():
        # every beam exempt: the window slots enumerate each live interval
        # exactly, so LM proposals could only duplicate them
        return (
            torch.full((B, K, n_buf), cfg.pad_token_id, dtype=torch.int32, device=dev),
            pad_lp.expand(B, K, n_buf),
            torch.zeros((B, K, n_buf), dtype=torch.bool, device=dev),
        ), ops.contains(eos_tok, lo, hi)

    def finish(buf):
        buf_tok, buf_lp, buf_valid = buf
        # unfilled slots become PAD candidates at PAD's true log-prob
        return (
            torch.where(buf_valid, buf_tok, cfg.pad_token_id),
            torch.where(buf_valid, buf_lp, pad_lp),
            buf_valid,
        )

    any_live = bool((~exempt).any())
    if round0_only:
        if any_live:
            buf, th_lp, _, dead, covered, eos_ok = round0()
            need = unproven(buf, th_lp, dead, covered)
        else:
            buf, eos_ok = skipped()
            need = torch.zeros((B, K), dtype=torch.bool, device=dev)
            th_lp = torch.full((B, K), NEG_INF, dtype=torch.float32, device=dev)
        return (*finish(buf), eos_ok, need, th_lp)

    if not any_live:
        buf, eos_ok = skipped()
        return (*finish(buf), eos_ok)

    buf, th_lp, th_ix, dead, covered, eos_ok = round0()
    v_bucket = ((v_idx + SHIFT) // ops.bucket_size()).long()
    bcounts = None
    it = 1
    while chunk + (it - 1) * chunk_l < V and bool(unproven(buf, th_lp, dead, covered).any()):
        if bcounts is None:
            # bucket-support pruning: a token whose symbol bucket has no
            # row in [lo, hi) cannot continue the range
            bcounts = ops.bucket_counts(lo, hi).reshape(B * K, -1)
            base = torch.where(bcounts[:, v_bucket] > 0, lp, NEG_INF)
        th_lp_f = th_lp.reshape(B * K, 1)
        th_ix_f = th_ix.reshape(B * K, 1)
        consumed = (base > th_lp_f) | ((base == th_lp_f) & (v_idx <= th_ix_f))
        work = torch.where(consumed, NEG_INF, base)
        top_lp, top_tok = row_topk(work, chunk_l)
        top_tok = top_tok.reshape(B, K, chunk_l).to(torch.int32)
        top_lp = top_lp.reshape(B, K, chunk_l)
        valid = ops.contains(top_tok, lo, hi) & (top_lp > NEG_INF / 2)
        rows_prev = chunk + (it - 1) * chunk_l  # slab rows already enumerated
        buf = merge_round(*buf, top_tok, top_lp, valid, rows_prev, chunk_l)
        th_lp = top_lp[..., -1]
        th_ix = top_tok[..., -1]
        dead = top_lp[..., 0] <= NEG_INF / 2
        covered = ops.interval_covered(lo, hi, rows_prev + chunk_l)
        it += 1
    return (*finish(buf), eos_ok)


def _apply_branches(cfg: DecodeConfig, tokens, fm_valid, prev_count, finished):
    """Reference branch logic (beam_search.py:114-138) on candidate level:
    stop-forced beams allow only EOS, finished beams only PAD, the rest the
    FM-valid set.  Returns the allowed mask."""
    is_eos = tokens == cfg.eos_token_id
    is_pad = tokens == cfg.pad_token_id
    count_eff = torch.where(finished, 0, prev_count)
    stop_trig = (count_eff <= cfg.stop_at_count) & (cfg.stop_at_count > 0)
    allowed = torch.where(
        stop_trig[..., None], is_eos, torch.where(finished[..., None], is_pad, fm_valid)
    )
    if cfg.always_allow_eos:
        allowed = allowed | is_eos
    return allowed


def _select(cfg: DecodeConfig, cons_scores, uncons_scores, tokens, K: int):
    """top-2K by constrained score + the first-K-non-EOS continuation rule
    (``beam_search.py:301-320``).  The candidate-beam axis may be narrower
    than K (step 0)."""
    B, n_par, ncand = cons_scores.shape
    flat_cons = cons_scores.reshape(B, n_par * ncand)
    flat_uncons = uncons_scores.reshape(B, n_par * ncand)
    flat_tok = tokens.reshape(B, n_par * ncand)
    top_idx = _top_idx(flat_cons, 2 * K)
    top_cons = _gather(flat_cons, top_idx)
    top_tok = _gather(flat_tok, top_idx)
    top_uncons = _gather(flat_uncons, top_idx)
    top_parent = (top_idx // ncand).to(torch.int32)

    is_eos = (top_tok == cfg.eos_token_id).to(torch.int8)
    cont = torch.argsort(is_eos, dim=-1, stable=True)[:, :K]
    finite = top_cons > NEG_INF / 4
    return (
        top_tok,
        top_parent,
        top_uncons,
        finite,
        _gather(top_tok, cont),
        _gather(top_parent, cont),
        _gather(top_uncons, cont),
        _gather(finite, cont),
        top_cons,  # [B, 2K] desc; top_cons[:, -1] is the selection cutoff
    )


def _fast_exact_select(ops, cfg: DecodeConfig, lp, lo, hi, prev_count, finished,
                       beam_scores, K: int, force_full: bool = False):
    """One proposal round + selection + the post-selection soundness proof.

    A beam's missed tokens all score ``<= beam_score + th_lp``; when that
    bound is below the global 2K-th selected score for every unproven beam,
    the round-0 set was sufficient.  Returns ``(result8, unsound)`` with
    ``unsound`` a bool scalar tensor; ``force_full`` runs the proven loop.
    """
    B = lo.shape[0]
    win_tok, win_valid, win_lp, eos_tok, eos_lp, pad_tok, pad_lp = _exact_slots(
        ops, cfg, lp, lo, hi
    )

    def build_and_select(buf_tok, buf_lp, buf_valid, eos_ok):
        tokens = torch.cat([buf_tok, win_tok, eos_tok, pad_tok], -1)
        fm_valid = torch.cat(
            [buf_valid, win_valid, eos_ok,
             torch.zeros((B, K, 1), dtype=torch.bool, device=lo.device)], -1
        )
        cand_lp = torch.cat([buf_lp, win_lp, eos_lp, pad_lp], -1)
        allowed = _apply_branches(cfg, tokens, fm_valid, prev_count, finished)
        # proposal slots can repeat a window token; keep one per token id
        cons = torch.where(allowed & _dedup_mask(tokens), cand_lp, NEG_INF)
        return _select(
            cfg, cons + beam_scores[..., None], cand_lp + beam_scores[..., None], tokens, K
        )

    if force_full:
        out = build_and_select(
            *_exact_proposals(ops, cfg, lp, lo, hi, prev_count, finished, pad_lp, eos_tok)
        )
        return out[:8], torch.zeros((), dtype=torch.bool, device=lo.device)

    buf_tok, buf_lp, buf_valid, eos_ok, need, th_lp = _exact_proposals(
        ops, cfg, lp, lo, hi, prev_count, finished, pad_lp, eos_tok, round0_only=True
    )
    fast = build_and_select(buf_tok, buf_lp, buf_valid, eos_ok)
    s_star = fast[8][:, -1]  # global 2K-th selected constrained score
    # ">=": an exact tie with the cutoff would make tie resolution depend on
    # the sweep schedule -- fall back instead
    unsound = need & (beam_scores + th_lp >= s_star[:, None])
    return fast[:8], unsound.any()


def constrained_beam_search(model_cfg, params, index, cfg: DecodeConfig, enc_out,
                            enc_mask) -> BeamSearchOutput:
    """Constrained beam search for a batch of queries (tensors on the
    index's device)."""
    B = enc_out.shape[0]
    K = cfg.num_beams
    L = cfg.max_length
    S = cfg.num_steps
    V = model_cfg.vocab_size
    dev = enc_out.device
    ops = SingleIndexOps(index)
    i32 = torch.int32

    # per-QUERY encoder state, never beam-tiled: decode_step's grouped
    # cross-attention reads it once per query
    cross_kv = bart.precompute_cross_kv(model_cfg, params, enc_out)
    enc_bias = bart.encoder_bias(enc_mask)

    # step 0 has ONE live beam per query (beam 0 at score 0, the rest at
    # NEG_INF never win) and identical model state across beams: run it on
    # [B] rows and fan out at the first selection
    slim0 = V >= 2 * K
    rows0 = B if slim0 else B * K
    K0 = 1 if slim0 else K
    self_cache = bart.empty_self_cache(model_cfg, rows0, L, dev)

    tokens = torch.full((B * K, L), cfg.pad_token_id, dtype=i32, device=dev)
    tokens[:, 0] = cfg.decoder_start_token_id
    beam_scores = torch.full((B, K), NEG_INF, dtype=torch.float32, device=dev)
    beam_scores[:, 0] = 0.0
    if cfg.force_decoding_from:
        fseq = torch.as_tensor(cfg.force_decoding_from, dtype=i32, device=dev)
        flen = torch.tensor([fseq.numel()], dtype=i32, device=dev)
        flo, fhi = ops.range_for(fseq[None, :], flen)
        lo0, hi0 = flo.expand(B, K), fhi.expand(B, K)
    else:
        lo0, hi0 = ops.full_range((B, K))
    brow = torch.arange(B, device=dev)[:, None]

    # ---- step 0: first constrained token (dense corpus mask) -----------
    start_col = 1
    logits, self_cache = bart.decode_step(
        model_cfg, params,
        torch.full((rows0,), cfg.decoder_start_token_id, dtype=i32, device=dev),
        0, self_cache, cross_kv, enc_bias,
    )
    lp = _log_softmax(logits, start_col, cfg).reshape(B, K0, V)
    corpus_mask = ops.corpus_mask()
    if cfg.always_allow_eos:
        corpus_mask = corpus_mask.clone()
        corpus_mask[cfg.eos_token_id] = True
    cons0 = torch.where(corpus_mask, lp, NEG_INF)
    tokens_all = torch.arange(V, dtype=i32, device=dev).expand(B, K0, V)
    bs0 = beam_scores[:, :K0, None]
    c_tok, c_par, c_sco, c_fin, sel_tok, sel_par, beam_scores, sel_fin = _select(
        cfg, cons0 + bs0, lp + bs0, tokens_all, K
    )[:8]
    tainted = ~sel_fin

    # fan out: tokens live in [B*K] rows (identical per query), the cache
    # in [rows0] rows -- gather it with the K0 stride
    tokens = tokens[(brow * K + sel_par).reshape(-1).long()]
    tokens[:, start_col] = sel_tok.reshape(-1)
    self_cache = bart.reorder_cache(self_cache, (brow * K0 + sel_par).reshape(-1))
    prev_count = _gather(ops.range_size(lo0, hi0), sel_par)
    lo, hi = ops.extend(sel_tok, _gather(lo0, sel_par), _gather(hi0, sel_par))
    hist = [(c_tok, c_par, c_sco, c_fin, sel_tok, sel_par)]
    unsound = []

    # ---- steps 1..S-1 ---------------------------------------------------
    for t in range(S - 1):
        cur_col = start_col + t  # column holding the last written token
        last = tokens[:, cur_col]
        logits, self_cache = bart.decode_step(
            model_cfg, params, last, 1 + t, self_cache, cross_kv, enc_bias
        )
        lp = _log_softmax(logits, cur_col + 1, cfg)
        finished = ((last == cfg.eos_token_id) | (last == cfg.pad_token_id)).reshape(B, K)
        (c_tok, c_par, c_sco, c_fin, sel_tok, sel_par, new_scores, sel_fin), bad = (
            _fast_exact_select(ops, cfg, lp, lo, hi, prev_count, finished, beam_scores, K,
                               force_full=cfg.force_full)
        )
        unsound.append(bad)
        # candidates of tainted (back-filled) parents are ungrounded: drop
        c_fin = c_fin & ~_gather(tainted, c_par)

        tokens = tokens[(brow * K + sel_par).reshape(-1).long()]
        tokens[:, cur_col + 1] = sel_tok.reshape(-1)
        self_cache = bart.reorder_cache(self_cache, (brow * K + sel_par).reshape(-1))

        new_prev_count = _gather(ops.range_size(lo, hi), sel_par)
        # EOS/PAD selections end the constraint sequence (range (0, 0)),
        # and a finished parent stays finished
        elo, ehi = ops.extend(sel_tok, _gather(lo, sel_par), _gather(hi, sel_par))
        stop = (
            (sel_tok == cfg.eos_token_id)
            | (sel_tok == cfg.pad_token_id)
            | _gather(finished, sel_par)
        )
        lo = torch.where(stop, 0, elo)
        hi = torch.where(stop, 0, ehi)
        prev_count = new_prev_count
        tainted = _gather(tainted, sel_par) | ~sel_fin
        beam_scores = new_scores
        hist.append((c_tok, c_par, c_sco, c_fin, sel_tok, sel_par))

    c_tok, c_par, c_sco, c_fin, s_tok, s_par = (torch.stack(x, 0) for x in zip(*hist))
    fallback = (
        torch.stack(unsound).sum().to(i32) if unsound else torch.zeros((), dtype=i32, device=dev)
    )
    return BeamSearchOutput(
        cand_tokens=c_tok,
        cand_parents=c_par,
        cand_scores=c_sco,
        cand_finite=c_fin,
        sel_tokens=s_tok,
        sel_parents=s_par,
        final_scores=beam_scores,
        final_tokens=tokens.reshape(B, K, L),
        final_valid=~tainted,
        fallback_steps=fallback,
    )
