"""FM-index-constrained beam search, fast-exact path and dense parity mode
(counterpart of ``seal_tpu/decoding/constrained.py``).

Semantics are the JAX module's (see its docstring): candidates are selected
by constrained scores and accumulate unconstrained ones; every candidate of
every step is recorded for host extraction; the allowed set of each beam is
exact.  Each step takes one exact proposal round (the top ``exact_chunk``
LM tokens validated by membership queries, plus a BWT slab and window of
the beam's own interval), selects, and then proves that no token the round
missed could have reached the selection cutoff.  A step that cannot be
proven sound is flagged, and the caller re-runs the whole decode with
``force_full=True`` (every step through the proven proposal loop).

``exact_mask`` is the dense parity mode the fast path is held to: each
step's allowed set is the whole count vector of every beam's interval,
read as its count mask (``dense_mask``: a bit a token, kernels 15/16's
mask modes), and one launch of kernel 3's select computes kernel 17's
candidate scores as it ranks the flat [B, K*V] rows for the step's top 2K
(``dense_select``: the scores are never written), as step 0 ranks its
rows.  ``exact_ties`` orders equal scores by (beam,
token) in the fast path's merge and selection (kernel 8's ties mode); the
dense mode needs no tie mode, since its flat index already rises with
(beam, token).

What changed in translation:

* The ``lax.scan`` over steps is a Python loop, and ``lax.cond`` /
  ``lax.while_loop`` are Python control flow on ``.any()``; each costs a
  host sync.
* ``_sel1`` (masked reductions that dodge TPU scalar gathers) has no
  counterpart: the proposal merge and the selection are kernel 8
  (``kernels/beam_select.py``), which reads its candidates straight from
  the proposal buffer, the window slots and ``lp``'s EOS and PAD columns,
  and turns unfilled buffer slots into PAD candidates itself.
* The decoder's self-attention cache lives in two preallocated buffers:
  each step's beam reorder (kernel 11) copies the live columns from one
  into the other instead of gathering a new cache.
* Not ported, because they work around the TPU: ``check_dense_budget`` /
  ``DENSE_GUARD_BACKENDS`` (a TPU worker fault) and the one-hot-matmul
  block gather of ``_exact_topk`` (the TPU's slow scalar gathers).  Every
  top-k is one exact row top-k, ``kernels.row_topk`` (kernel 3), and the
  warper is ``kernels.row_select.topk_log_softmax`` (kernel 3's select in
  its warper mode: the k-th value, the mask and the log-softmax).
* ``force_decoding_from`` starts every beam's range at the forced
  sequence's (kernel 5).  Step 0 still picks its token under the dense
  corpus mask and then extends the forced range, as the JAX decoder does.
* ``disable_fm_index`` (free generation) takes each beam's exact
  top-``top_m`` (kernel 3), ranks the flat [B, K*top_m] scores (kernel 3)
  and selects through a token table (kernel 8's ``beam_select_top``); no
  index op runs.  ``speculative`` takes one exact top-``top_m`` round
  (kernel 3: its recall is 1, above ``approx_max_k``'s 0.95 target) with
  one membership query, and kernel 8 keeps the slots that fail it as masked
  candidates.  The top-k warper and its log-softmax are one launch of
  kernel 3's select in its warper mode.  ``adjust_logits_fn`` is a Python
  hook on the raw f32 logits [rows, V], given ``cur_len`` as a Python
  ``int`` (a traced int32 in JAX).  ``forced_bos_token_id`` adds one
  decode step that pins column 1.
* ``sample`` (K independent sampler chains) and diverse groups
  (``num_groups``, ``diversity_penalty``) take JAX's beam-tiled step 0 and
  ``_candidates_general``'s routes: the proven proposal loop (its buffer
  ``max(2K, top_m)`` wide under sampling), written out as candidates by
  kernel 8's candidate mode; ``speculative`` through the same mode with
  ``keep_invalid``; ``exact_mask`` under sampling through kernel 20's
  count-reading mode (kernel 17's branches applied as it reads the counts,
  no scores written), under diverse groups through kernel 17's streaming
  pass (the scores written, since kernel 21 reads them); free generation
  through kernel 3's top-``top_m``.  Kernel 20 draws each chain's token by
  Gumbel-max with counter-based Philox noise keyed by (``seed``, step), in
  place of JAX's threefry key chain: the same distribution and seed
  contract, not the same draws.  Kernel 21 runs the groups' selection with
  the Hamming penalty.  Step 0 hands both kernels the V-wide rows and the
  corpus mask.
* ``index_ops`` (JAX's adapter argument) takes
  ``parallel.sharded_decode.ShardedIndexOps`` for a corpus-sharded index
  on one device: the decode's ranges then carry a leading shard axis
  ([S, B, K]), so B and K come from the beam state and ``_gather`` expands
  its index over the leading axes; every merged op returns [B, K, ...].
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from seal_tpu_torch.kernels.beam_select import (
    NEG_INF,
    beam_candidates,
    beam_merge,
    beam_select,
    beam_select_top,
)
from seal_tpu_torch.kernels.dense_scores import dense_scores, dense_select
from seal_tpu_torch.kernels.diverse_select import diverse_select
from seal_tpu_torch.kernels.row_select import topk_log_softmax
from seal_tpu_torch.kernels.row_topk import pruned_topk, row_topk
from seal_tpu_torch.kernels.sample_select import sample_select, sample_select_counts
from seal_tpu_torch.kernels.triton_logsoftmax import log_softmax_ban
from seal_tpu_torch.index.wavelet import WaveletIndex
from seal_tpu_torch.models import api as model_api
from seal_tpu_torch.ops import fm_ops, wt_ops


def index_ops(index):
    """The op module of ``index``'s layout: ``wt_ops`` for the compact and
    hybrid wavelet layouts, ``fm_ops`` for the Psi layout."""
    return wt_ops if isinstance(index, WaveletIndex) else fm_ops


class SingleIndexOps:
    """Constraint-op adapter over one device index: a :class:`TorchFMIndex`
    or a :class:`WaveletIndex`, dispatched to its layout's op module."""

    def __init__(self, index):
        self.index = index
        self._ops = index_ops(index)

    def full_range(self, shape):
        return self.index.full_range(shape)

    def range_for(self, tokens, lengths):
        return self._ops.range_for_sequences(self.index, tokens, lengths)

    def corpus_mask(self):
        return self.index.corpus_counts > 0

    def contains(self, tokens, lo, hi):
        return self._ops.contains_tokens(self.index, tokens, lo, hi)

    def window_gather(self, lo, hi, w, lp, fill):
        return self._ops.window_gather(self.index, lo, hi, w, lp, fill)

    def window_slab(self, lo, hi, w, width, lp, fill):
        """The step's window (fill ``fill``) and proposal round 0's slab of
        ``width`` rows (fill 0): one launch of kernel 2 on the Psi layout,
        of kernel 13 on the wavelet layouts."""
        return self._ops.window_slab(self.index, lo, hi, w, width, lp, fill)

    def slab(self, lo, hi, rows_prev, width, lp):
        """A straggler round's slab, rows [lo + rows_prev, + width) cut at
        hi (fill 0): kernel 2's or kernel 13's slab mode."""
        return self._ops.slab_gather(self.index, lo, hi, rows_prev, width, lp)

    def advance(self, sel_tok, sel_par, lo, hi, finished=None, *, eos: int, pad: int):
        """The range update after a selection (:1416-1430; step 0, with
        ``finished`` None, :1344-1349): (lo, hi, prev_count) [B, K].  One
        launch of kernel 1's step mode on the Psi layout, of kernel 12's on
        the wavelet layouts."""
        return self._ops.advance_ranges(self.index, sel_tok, sel_par, lo, hi, finished, eos=eos,
                                        pad=pad)

    def window_exhaustive(self, lo, hi, w):
        """True where the w-row window enumerates the whole interval."""
        return (hi - lo) <= w

    def interval_covered(self, lo, hi, rows_done):
        """True where the first ``rows_done`` rows enumerate all of [lo, hi)."""
        return (hi - lo) <= rows_done

    def host_any(self, x) -> bool:
        """A decode branch's host read: whether ``x`` holds a true element
        (one host sync; over a mesh, ``ShardedIndexOps`` merges it)."""
        return bool(x.any())

    def bucket_counts(self, lo, hi):
        return self._ops.bucket_counts(self.index, lo, hi)

    def bucket_support(self, lo, hi):
        """The straggler rounds' pruning input: 8 int32 words a range, bit b
        set iff ``bucket_counts(lo, hi)[..., b] > 0`` (kernel 6's support
        mode on the Psi layout, kernel 14's on the wavelet layouts)."""
        return self._ops.bucket_support(self.index, lo, hi)

    def bucket_size(self):
        """Symbols per ``bucket_counts`` bucket: the layout's own (wavelet
        buckets are 16^(digits-2) symbols, Psi buckets ceil(sigma/256))."""
        return self._ops.bucket_size_of(self.index)

    def dense_mask(self, lo, hi, chunk):
        """The count mask of every range, a bit a token (kernel 15's or
        16's mask mode): what the ``exact_mask`` step reads."""
        return self._ops.dense_mask(self.index, lo, hi, chunk=chunk)

    @property
    def vocab(self) -> int:
        return self.index.vocab


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
    exact_mask: bool = False  # dense O(vocab) mask (parity mode)
    dense_chunk: int = 2048  # tokens a plain dense_mask sweep takes at once
    exact_ties: bool = False  # resolve equal-score ties (beam, token)-asc
    forced_bos_token_id: Optional[int] = None  # one extra step pins column 1
    disable_fm_index: bool = False  # free generation: no constraint at all
    speculative: bool = False  # one exact top-top_m proposal round, no proof
    topk: int = 0  # TopKLogitsWarper on the raw logits (0 = off)
    adjust_logits_fn: Optional[Callable] = None  # (logits f32 [rows, V], cur_len: int)
    #   -> logits: a torch function on the raw logits, before the warper
    sample: bool = False  # num_beams independent constrained samplers
    num_groups: int = 1  # diverse beam groups
    diversity_penalty: float = 0.0  # Hamming diversity between groups

    def __post_init__(self):
        if self.num_groups > 1 and self.num_beams % self.num_groups:
            raise ValueError("num_beams must be divisible by num_groups")
        if self.sample and self.num_groups > 1:
            raise ValueError("sample and diverse groups are mutually exclusive")

    @property
    def num_steps(self) -> int:
        n = self.max_length - 1
        if self.forced_bos_token_id is not None:
            n -= 1
        return max(n, 0)

    @property
    def group_size(self) -> int:
        return self.num_beams // self.num_groups

    @property
    def n_buf(self) -> int:
        """Proposal buffer slots per beam: sampling draws from the whole
        allowed distribution, so it gets the ``top_m`` budget; beam modes
        only ever select 2K."""
        two_k = 2 * self.num_beams
        return max(two_k, self.top_m) if self.sample else two_k


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


def resolve_window(window: int, num_beams: int, speculative: bool = False) -> int:
    """0/None = auto: the JAX package's rule -- 128 rows in speculative mode
    (there the window is a fidelity budget), else 32 for beams <= 16 and
    128 above."""
    if window:
        return window
    if speculative:
        return 128
    return 32 if num_beams <= 16 else 128


def _apply_min_length(cur_len: int, cfg: DecodeConfig) -> int:
    """Column to ban (EOS while cur_len < min_length), or -1."""
    return cfg.eos_token_id if cur_len < cfg.min_length else -1


def _adjust_logits(logits, cur_len: int, cfg: DecodeConfig):
    """The ``adjust_logits_fn`` hook on the raw logits (HF semantics: cur_len
    is the column the chosen token will occupy)."""
    if cfg.adjust_logits_fn is None:
        return logits
    return cfg.adjust_logits_fn(logits, cur_len).float()


def _log_softmax(logits, cur_len: int, cfg: DecodeConfig):
    """The hook, then the f32 log-softmax with the min-length EOS ban, as
    the JAX step applies them: kernel 4, or with the top-k warper one
    launch of kernel 3's select in its warper mode (``topk_log_softmax``:
    the k-th value, the mask, the log-softmax and the ban)."""
    logits = _adjust_logits(logits, cur_len, cfg)
    ban = _apply_min_length(cur_len, cfg)
    if cfg.topk > 0:
        return topk_log_softmax(logits, cfg.topk, ban, NEG_INF)
    return log_softmax_ban(logits, ban, NEG_INF)


def _gather(x, idx):
    """``x`` [..., n] gathered along its last axis by ``idx`` [*, m], the
    index shared over ``x``'s leading axes (a sharded index's shard axis)."""
    idx = idx.long()
    return torch.gather(x, -1, idx.expand(*x.shape[: x.dim() - idx.dim()], *idx.shape))


def _round0_width(cfg: DecodeConfig, V: int) -> int:
    """Proposal round 0's width: the LM tokens it validates and the rows of
    the interval it enumerates (``constrained.py:578``)."""
    return min(V, max(cfg.exact_chunk, 2 * cfg.n_buf))


def _step_window(ops, cfg: DecodeConfig, lp, lo, hi, prev_count, finished):
    """A step's window slots and, where a beam needs a proposal round,
    round 0's slab, from one call of kernel 2 (or, on the wavelet layouts,
    kernel 13): ((tok, valid, lp) [B, K, w], exempt [B, K], the slab's
    (tok, valid, lp) [B, K, chunk] or None).  A beam is exempt when it has
    finished, ``stop_at_count`` stops it, or the window enumerates its whole
    interval (LM proposals could only duplicate the window); the slab is
    read only where some beam is not (one host sync, ``ops.host_any``)."""
    count_eff = torch.where(finished, 0, prev_count)
    stop_trig = (count_eff <= cfg.stop_at_count) & (cfg.stop_at_count > 0)
    exempt = finished | stop_trig | ops.window_exhaustive(lo, hi, cfg.window)
    if not ops.host_any(~exempt):
        return ops.window_gather(lo, hi, cfg.window, lp, cfg.pad_token_id), exempt, None
    out = ops.window_slab(lo, hi, cfg.window, _round0_width(cfg, lp.shape[-1]), lp,
                          cfg.pad_token_id)
    return out[:3], exempt, out[3:]


def _exact_proposals(
    ops, cfg: DecodeConfig, lp, lo, hi, eos_tok, exempt, slab0, round0_only: bool = False,
):
    """Per beam, the ``cfg.n_buf`` best *allowed* tokens by LM log-prob.

    Round 0 validates the exact top-``chunk`` LM tokens and enumerates a
    ``chunk``-row slab of the interval (``slab0``, from ``_step_window``;
    None when every beam is ``exempt``); later rounds (the full loop only)
    sweep wider chunks past the consumed (lp, token) threshold under
    bucket-support pruning until every beam is complete, covered, dead or
    exempt: the support bits once (kernel 6's or 14's support mode), then a
    round's top ``chunk_l`` in one launch of kernel 3's select, which prunes
    as it stages ``lp`` (``pruned_topk``).  Each round's merge is kernel 8
    (``beam_merge``).  Returns the raw buffer (tok, lp, valid) [B, K,
    n_buf] -- or None when every beam is exempt and no round ran -- and the
    EOS membership; ``round0_only`` stops after round 0 and also returns
    the beams still unproven (``need``) and their threshold (``th_lp``).
    Unfilled buffer slots become PAD candidates in the selection
    (``beam_select``).  ``lp`` is FLAT [B*K, V].  See the JAX function for
    the proofs.
    """
    B, K = exempt.shape  # lo/hi may carry a leading shard axis
    V = lp.shape[-1]
    dev = lo.device
    n_buf = cfg.n_buf
    chunk = _round0_width(cfg, V)
    chunk_l = min(V, max(cfg.exact_loop_chunk or 4 * chunk, chunk))

    def merge_round(buf, top_tok, top_lp, top_ok, slab):
        # with the interval's own BWT rows, allowed by construction
        slab_tok, slab_ok, slab_lp = slab
        return beam_merge(buf, top_tok, top_lp, top_ok, slab_tok, slab_lp, slab_ok, V, n_buf,
                          ties=cfg.exact_ties)

    def round0():
        top_lp0, top_tok0 = row_topk(lp, chunk)
        top_tok0 = top_tok0.reshape(B, K, chunk).to(torch.int32)
        top_lp0 = top_lp0.reshape(B, K, chunk)
        ok0 = ops.contains(torch.cat([top_tok0, eos_tok], -1), lo, hi)
        buf = merge_round(None, top_tok0, top_lp0, ok0[..., :chunk], slab0)
        th_lp = top_lp0[..., -1]
        th_ix = top_tok0[..., -1]
        dead = top_lp0[..., 0] <= NEG_INF / 2  # proposal space exhausted
        covered = ops.interval_covered(lo, hi, chunk)
        return buf, th_lp, th_ix, dead, covered, ok0[..., chunk:]

    def unproven(buf, th_lp, dead, covered):
        _, buf_lp, buf_valid = buf
        complete = (buf_valid.sum(-1) >= n_buf) & (buf_lp[..., -1] >= th_lp)
        return ~exempt & ~dead & ~covered & ~complete

    # every beam exempt: the window slots enumerate each live interval
    # exactly, so LM proposals could only duplicate them
    any_live = slab0 is not None
    if round0_only:
        if any_live:
            buf, th_lp, _, dead, covered, eos_ok = round0()
            return buf, eos_ok, unproven(buf, th_lp, dead, covered), th_lp
        need = torch.zeros((B, K), dtype=torch.bool, device=dev)
        th_lp = torch.full((B, K), NEG_INF, dtype=torch.float32, device=dev)
        return None, ops.contains(eos_tok, lo, hi), need, th_lp

    if not any_live:
        return None, ops.contains(eos_tok, lo, hi)

    buf, th_lp, th_ix, dead, covered, eos_ok = round0()
    bits = None
    it = 1
    while chunk + (it - 1) * chunk_l < V and ops.host_any(unproven(buf, th_lp, dead, covered)):
        if bits is None:
            # bucket-support pruning: a token whose symbol bucket has no
            # row in [lo, hi) cannot continue the range
            bits = ops.bucket_support(lo, hi).reshape(B * K, -1)
        # the round's top chunk_l of the pruned log-probs past the consumed
        # (lp, token) threshold, the pruning done as kernel 3 stages lp
        top_lp, top_tok = pruned_topk(lp, bits, th_lp.reshape(-1), th_ix.reshape(-1),
                                      ops.bucket_size(), chunk_l, NEG_INF)
        top_tok = top_tok.reshape(B, K, chunk_l).to(torch.int32)
        top_lp = top_lp.reshape(B, K, chunk_l)
        rows_prev = chunk + (it - 1) * chunk_l  # slab rows already enumerated
        buf = merge_round(buf, top_tok, top_lp, ops.contains(top_tok, lo, hi),
                          ops.slab(lo, hi, rows_prev, chunk_l, lp))
        th_lp = top_lp[..., -1]
        th_ix = top_tok[..., -1]
        dead = top_lp[..., 0] <= NEG_INF / 2
        covered = ops.interval_covered(lo, hi, rows_prev + chunk_l)
        it += 1
    return buf, eos_ok


def _fast_exact_select(ops, cfg: DecodeConfig, lp, lo, hi, prev_count, finished,
                       beam_scores, K: int, force_full: bool = False):
    """One proposal round + selection + the post-selection soundness proof.

    A beam's missed tokens all score ``<= beam_score + th_lp``; when that
    bound is below the global 2K-th selected score for every unproven beam,
    the round-0 set was sufficient.  Returns ``(result8, unsound)`` with
    ``unsound`` a bool scalar tensor; ``force_full`` runs the proven loop.
    The candidate build, branches, dedup, selection and the test are
    kernel 8 (``beam_select``); the window slots and round 0's slab are one
    call of kernel 2 (``_step_window``).
    """
    B = prev_count.shape[0]
    (win_tok, win_valid, win_lp), exempt, slab0 = _step_window(ops, cfg, lp, lo, hi, prev_count,
                                                               finished)
    eos_tok = torch.full((B, K, 1), cfg.eos_token_id, dtype=torch.int32, device=lo.device)
    n_buf = 2 * cfg.num_beams

    def select(buf, eos_ok, need=None, th_lp=None):
        return beam_select(
            buf, n_buf, win_tok, win_valid, win_lp, eos_ok, lp, prev_count, finished,
            beam_scores, need, th_lp, K=K, eos=cfg.eos_token_id, pad=cfg.pad_token_id,
            stop_at_count=cfg.stop_at_count, always_allow_eos=cfg.always_allow_eos,
            ties=cfg.exact_ties,
        )

    if force_full:
        out, _ = select(*_exact_proposals(ops, cfg, lp, lo, hi, eos_tok, exempt, slab0))
        return out[:8], torch.zeros((), dtype=torch.bool, device=lo.device)
    out, unsound = select(*_exact_proposals(
        ops, cfg, lp, lo, hi, eos_tok, exempt, slab0, round0_only=True
    ))
    return out[:8], unsound.any()


def _dense_select(ops, cfg: DecodeConfig, lp, lo, hi, prev_count, finished, beam_scores,
                  K: int):
    """The dense parity mode's step: every beam's count mask (kernel 15's
    or 16's mask mode); then one launch of kernel 3's select that computes
    the branches, mask and beam score of every (beam, token) candidate as
    it stages the [B, K * V] rows (kernel 17's ``dense_select``) and keeps
    each query's top 2K; and ``_select``'s epilogue (kernel 8's
    ``beam_select_top``), as step 0 selects.  The scores are never written.

    The candidate at flat index k * V + v is (beam k, token v), so kernel
    3's order, value descending and index ascending, is also the
    ``exact_ties`` order (the (beam, token) tie id rises with the index):
    the dense mode needs no tie mode.  Past the select's shared sort (2K
    above ``row_topk.MAX_K``: beam 8,193 and up) ``dense_select`` takes
    the streaming pass and kernel 3's global sort instead, by size
    (``dense_scores.route``), in the same order.
    """
    mask = _dense_mask(ops, cfg, lp, lo, hi)
    top_cons, top_idx = dense_select(mask, lp, prev_count, finished, beam_scores, 2 * K,
                                     **_branches(cfg))
    return beam_select_top(top_cons, top_idx, lp, beam_scores, K, K, cfg.eos_token_id)[:8]


def _dense_mask(ops, cfg: DecodeConfig, lp, lo, hi):
    """Every beam's count mask (kernel 15's or 16's mask mode): int32
    [B, K, count_mask.words(V)], bit t set iff token t continues the beam's
    interval (JAX's ``fm_valid = counts > 0``)."""
    if ops.vocab != lp.shape[-1]:
        raise ValueError(f"exact_mask: the index's vocab {ops.vocab} differs from the "
                         f"model's {lp.shape[-1]}")
    return ops.dense_mask(lo, hi, cfg.dense_chunk)


def _branches(cfg: DecodeConfig) -> dict:
    """Kernel 17's branch options (``_apply_branches``)."""
    return dict(eos=cfg.eos_token_id, pad=cfg.pad_token_id, stop_at_count=cfg.stop_at_count,
                always_allow_eos=cfg.always_allow_eos)


def _free_select(cfg: DecodeConfig, lp, beam_scores, K: int):
    """Free generation's step (``disable_fm_index``): each beam's exact
    top-``top_m`` (kernel 3), the flat top-2K of their scores plus the beam
    score (kernel 3) and ``_select``'s epilogue through the token table
    (kernel 8).  Every candidate is allowed, finished beams included.

    Within a beam the top-``top_m`` list is in (lp desc, token asc) order,
    so among equal scores the flat index rises with (beam, token): kernel
    3's order is the ``exact_ties`` order, and no tie mode is needed.  Only
    two log-probs that differ but round to one score with the beam score
    added would break that; under ``exact_ties`` the list is therefore
    taken on the scores themselves (lp + beam score, a [B*K, V] add), whose
    (score desc, token asc) order is exact.
    """
    B = beam_scores.shape[0]
    m = cfg.top_m
    bs = beam_scores.reshape(B * K, 1)
    if cfg.exact_ties:
        cons, tok = row_topk(lp + bs, m)
    else:
        top_lp, tok = row_topk(lp, m)
        cons = top_lp + bs
    top_cons, top_idx = row_topk(cons.reshape(B, K * m), 2 * K)
    return beam_select_top(top_cons, top_idx, lp, beam_scores, K, K, cfg.eos_token_id,
                           tokens=tok.to(torch.int32))[:8]


def _speculative_round(ops, cfg: DecodeConfig, lp, lo, hi, eos_tok):
    """The speculative mode's one proposal round: each beam's exact
    top-``top_m`` (kernel 3), checked with one membership query (kernel 1
    or 12, the EOS column included).  Returns the buffer (tok, lp, valid)
    [B, K, top_m] and the EOS membership."""
    B, K = eos_tok.shape[:2]
    m = cfg.top_m
    top_lp, top_idx = row_topk(lp, m)
    top_tok = top_idx.to(torch.int32).reshape(B, K, m)
    ok = ops.contains(torch.cat([top_tok, eos_tok], -1), lo, hi)
    return (top_tok, top_lp.reshape(B, K, m), ok[..., :m].contiguous()), ok[..., m:]


def _speculative_select(ops, cfg: DecodeConfig, lp, lo, hi, prev_count, finished, beam_scores,
                        K: int):
    """The speculative mode's step: the proposal round, plus the window
    (kernel 2 or 13), EOS and PAD slots; the branches, first-instance dedup
    and selection are kernel 8 with ``keep_invalid`` (a proposal that fails
    membership stays a masked candidate, as ``_candidates_general``
    :359-367 builds it)."""
    B = prev_count.shape[0]
    win_tok, win_valid, win_lp = ops.window_gather(lo, hi, cfg.window, lp, cfg.pad_token_id)
    eos_tok = torch.full((B, K, 1), cfg.eos_token_id, dtype=torch.int32, device=lo.device)
    buf, eos_ok = _speculative_round(ops, cfg, lp, lo, hi, eos_tok)
    out, _ = beam_select(
        buf, cfg.top_m, win_tok, win_valid, win_lp, eos_ok, lp, prev_count, finished,
        beam_scores, K=K, eos=cfg.eos_token_id, pad=cfg.pad_token_id,
        stop_at_count=cfg.stop_at_count, always_allow_eos=cfg.always_allow_eos,
        ties=cfg.exact_ties, keep_invalid=True,
    )
    return out[:8]


def _general_candidates(ops, cfg: DecodeConfig, lp, lo, hi, prev_count, finished, K: int):
    """``_candidates_general`` (:305-367) with its mask and dedup (:1394-1399):
    the candidates of the sampling and diverse-group modes' steps >= 1.

    Returns (tokens int32 or None where the token is the column, cons,
    cand_lp), each [B, K, N]: ``cons`` holds the allowed, first-instance
    log-probs (``NEG_INF`` elsewhere) without the beam scores.  The proven
    proposal loop's buffer and the speculative round go through kernel 8's
    candidate mode (N = n_buf + w + 2, slots [buffer, window, EOS, PAD]);
    ``exact_mask`` under diverse groups through kernels 15/16's mask modes
    and 17's streaming pass at zero beam scores (N = V; a sampled ``exact_mask``
    step takes ``_sample_dense_select`` instead, which writes no scores);
    free generation through kernel 3's exact top-``top_m`` (N = ``top_m``).
    """
    B = lp.shape[0] // K
    V = lp.shape[-1]
    if cfg.disable_fm_index:
        top_lp, tok = row_topk(lp, cfg.top_m)
        top_lp = top_lp.reshape(B, K, -1)
        return tok.to(torch.int32).reshape(B, K, -1), top_lp, top_lp
    if cfg.exact_mask:
        zero = torch.zeros((B, K), dtype=torch.float32, device=lp.device)
        cons = dense_scores(_dense_mask(ops, cfg, lp, lo, hi), lp, prev_count, finished, zero,
                            **_branches(cfg))
        return None, cons.reshape(B, K, V), lp.reshape(B, K, V)
    eos_tok = torch.full((B, K, 1), cfg.eos_token_id, dtype=torch.int32, device=lo.device)
    if cfg.speculative:
        win_tok, win_valid, win_lp = ops.window_gather(lo, hi, cfg.window, lp, cfg.pad_token_id)
        n_buf = cfg.top_m
        buf, eos_ok = _speculative_round(ops, cfg, lp, lo, hi, eos_tok)
    else:
        (win_tok, win_valid, win_lp), exempt, slab0 = _step_window(ops, cfg, lp, lo, hi,
                                                                   prev_count, finished)
        n_buf = cfg.n_buf
        buf, eos_ok = _exact_proposals(ops, cfg, lp, lo, hi, eos_tok, exempt, slab0)
    return beam_candidates(buf, n_buf, win_tok, win_valid, win_lp, eos_ok, lp, prev_count,
                           finished, eos=cfg.eos_token_id, pad=cfg.pad_token_id,
                           stop_at_count=cfg.stop_at_count, always_allow_eos=cfg.always_allow_eos,
                           keep_invalid=cfg.speculative)


def _sample_dense_select(ops, cfg: DecodeConfig, lp, lo, hi, prev_count, finished, beam_scores,
                         seed: int, step: int, row_offset: int = 0):
    """A sampled ``exact_mask`` step: every beam's count mask (kernel 15's
    or 16's mask mode), then kernel 20's count-reading mode, which applies
    kernel 17's branches as it reads the mask (cons = lp where allowed, at
    zero beam scores) and draws each chain's token: no [B, K * V] scores
    are written, and kernel 17's streaming pass is not launched."""
    return sample_select_counts(_dense_mask(ops, cfg, lp, lo, hi), lp, prev_count, finished,
                                beam_scores, seed, step, row_offset=row_offset, **_branches(cfg))


def _mode_select(cfg: DecodeConfig, cons, cand_lp, tokens, beam_scores, seed: int, step: int,
                 V: int, mask=None, row_offset: int = 0):
    """``dispatch_select`` (:1268-1286) for the sampling (kernel 20) and
    diverse-group (kernel 21) modes; ``step`` keys draw ``step``'s noise,
    ``row_offset`` its first chain's global row, ``V`` sizes the tie id's
    token field."""
    if cfg.sample:
        return sample_select(cons, cand_lp, tokens, beam_scores, seed, step,
                             eos=cfg.eos_token_id, pad=cfg.pad_token_id, mask=mask,
                             row_offset=row_offset)
    return diverse_select(cons, tokens, beam_scores, groups=cfg.num_groups,
                          penalty=cfg.diversity_penalty, eos=cfg.eos_token_id,
                          ties=cfg.exact_ties, vocab=V, mask=mask)


def constrained_beam_search(model_cfg, params, index, cfg: DecodeConfig, enc_out,
                            enc_mask, seed: int = 0, index_ops=None,
                            row_offset: int = 0) -> BeamSearchOutput:
    """Constrained beam search for a batch of queries (tensors on the
    index's device); ``seed`` keys the sampling mode's noise, and
    ``row_offset`` is the global query of the batch's first (a
    data-parallel rank's rows: its chains draw the whole batch's noise).
    ``index_ops``: the constraint-op adapter (default ``SingleIndexOps``
    over ``index``; ``parallel.sharded_decode.ShardedIndexOps`` for a
    sharded index, whose ranges carry a leading shard axis)."""
    B = enc_out.shape[0]
    K = cfg.num_beams
    L = cfg.max_length
    S = cfg.num_steps
    V = model_cfg.vocab_size
    dev = enc_out.device
    ops = index_ops if index_ops is not None else SingleIndexOps(index)
    i32 = torch.int32
    # free generation runs no index op: every candidate is allowed
    constrained = not cfg.disable_fm_index

    model = model_api.module_for(model_cfg)  # family dispatch (bart / t5)
    # per-QUERY encoder state, never beam-tiled: decode_step's grouped
    # cross-attention reads it once per query
    cross_kv = model.precompute_cross_kv(model_cfg, params, enc_out)
    enc_bias = model.encoder_bias(enc_mask)

    # step 0 (and the forced-BOS step) has ONE live beam per query (beam 0
    # at score 0, the rest at NEG_INF never win) and identical model state
    # across beams: run it on [B] rows and fan out at the first selection.
    # Sampling (every chain live) and diverse groups (one live beam per
    # group) keep the [B*K] rows.
    modes = cfg.sample or cfg.num_groups > 1
    slim0 = not modes and V >= 2 * K
    rows0 = B if slim0 else B * K
    K0 = 1 if slim0 else K
    # two [B*K]-row caches: each step's reorder (kernel 11) copies the live
    # columns from one into the other; step 0 runs on the first rows0 rows
    caches = [model.empty_self_cache(model_cfg, B * K, L, dev) for _ in range(2)]
    self_cache = [{n: c[n][:rows0] for n in ("k", "v")} for c in caches[0]]

    tokens = torch.full((B * K, L), cfg.pad_token_id, dtype=i32, device=dev)
    tokens[:, 0] = cfg.decoder_start_token_id
    beam_scores = torch.full((B, K), NEG_INF, dtype=torch.float32, device=dev)
    if cfg.sample:
        beam_scores.fill_(0.0)  # independent chains, all live
    else:  # beam 0 of each group (diverse groups), else of the query
        beam_scores[:, ::cfg.group_size] = 0.0
    if not constrained:
        lo0 = hi0 = None
    elif cfg.force_decoding_from:
        fseq = torch.as_tensor(cfg.force_decoding_from, dtype=i32, device=dev)
        flen = torch.tensor([fseq.numel()], dtype=i32, device=dev)
        flo, fhi = ops.range_for(fseq[None, :], flen)  # [..., 1]
        lo0, hi0 = (x[..., None].expand(*x.shape[:-1], B, K) for x in (flo, fhi))
    else:
        lo0, hi0 = ops.full_range((B, K))
    brow = torch.arange(B, device=dev)[:, None]

    # ---- optional forced-BOS step: the hook only, no ban, no warper ------
    pos0 = 0  # decoder position of step 0
    tok0 = cfg.decoder_start_token_id
    if cfg.forced_bos_token_id is not None:
        bos = cfg.forced_bos_token_id
        logits, self_cache = model.decode_step(
            model_cfg, params, torch.full((rows0,), tok0, dtype=i32, device=dev), 0, self_cache,
            cross_kv, enc_bias,
        )
        lp = log_softmax_ban(_adjust_logits(logits, 1, cfg), -1, NEG_INF)
        # every beam takes the add, the NEG_INF ones too ([B, K] + [B, K0])
        beam_scores = beam_scores + lp[:, bos].reshape(B, K0)
        tokens[:, 1] = bos
        pos0, tok0 = 1, bos

    # ---- step 0: first token (dense corpus mask; none when free) --------
    start_col = pos0 + 1
    logits, self_cache = model.decode_step(
        model_cfg, params, torch.full((rows0,), tok0, dtype=i32, device=dev), pos0, self_cache,
        cross_kv, enc_bias,
    )
    lp = _log_softmax(logits, start_col, cfg)  # [rows0, V]
    corpus_mask = None
    if constrained:
        corpus_mask = ops.corpus_mask()
        if cfg.always_allow_eos:
            corpus_mask = corpus_mask.clone()
            corpus_mask[cfg.eos_token_id] = True
    if modes:
        # kernel 20 or 21 reads the V-wide rows under the corpus mask
        out = _mode_select(cfg, lp, lp, None, beam_scores, seed, 0, V, mask=corpus_mask,
                           row_offset=row_offset * K)
    else:
        cons0 = lp.reshape(B, K0, V)
        if corpus_mask is not None:
            cons0 = torch.where(corpus_mask, cons0, NEG_INF)
        # kernel 3 ranks the V-wide rows; kernel 8 takes its top-2K from there
        cons0 = cons0 + beam_scores[:, :K0, None]
        top_cons, top_idx = row_topk(cons0.reshape(B, K0 * V), 2 * K)
        out = beam_select_top(top_cons, top_idx, lp, beam_scores, K0, K, cfg.eos_token_id)
    c_tok, c_par, c_sco, c_fin, sel_tok, sel_par, beam_scores, sel_fin = out[:8]
    tainted = ~sel_fin

    # fan out: tokens live in [B*K] rows (identical per query), the cache
    # in [rows0] rows -- gather it with the K0 stride
    tokens = tokens[(brow * K + sel_par).reshape(-1).long()]
    tokens[:, start_col] = sel_tok.reshape(-1)
    self_cache = model.reorder_cache(self_cache, (brow * K0 + sel_par).reshape(-1), step=pos0,
                                    out=caches[1])
    prev_count = lo = hi = None  # free generation keeps no constraint state
    if constrained:  # no stop rule at step 0
        lo, hi, prev_count = ops.advance(sel_tok, sel_par, lo0, hi0, eos=cfg.eos_token_id,
                                         pad=cfg.pad_token_id)
    hist = [(c_tok, c_par, c_sco, c_fin, sel_tok, sel_par)]
    unsound = []

    # ---- steps 1..S-1 ---------------------------------------------------
    for t in range(S - 1):
        cur_col = start_col + t  # column holding the last written token
        step = pos0 + 1 + t  # decoder position
        last = tokens[:, cur_col]
        logits, self_cache = model.decode_step(
            model_cfg, params, last, step, self_cache, cross_kv, enc_bias
        )
        lp = _log_softmax(logits, cur_col + 1, cfg)
        finished = ((last == cfg.eos_token_id) | (last == cfg.pad_token_id)).reshape(B, K)
        if modes and cfg.sample and cfg.exact_mask and constrained:
            out = _sample_dense_select(ops, cfg, lp, lo, hi, prev_count, finished, beam_scores,
                                       seed, t + 1, row_offset * K)
        elif modes:
            tok_c, cons, cand_lp = _general_candidates(ops, cfg, lp, lo, hi, prev_count, finished,
                                                       K)
            out = _mode_select(cfg, cons, cand_lp, tok_c, beam_scores, seed, t + 1, V,
                               row_offset=row_offset * K)
        elif not constrained:
            out = _free_select(cfg, lp, beam_scores, K)
        elif cfg.exact_mask:
            out = _dense_select(ops, cfg, lp, lo, hi, prev_count, finished, beam_scores, K)
        elif cfg.speculative:
            out = _speculative_select(ops, cfg, lp, lo, hi, prev_count, finished, beam_scores, K)
        else:
            out, bad = _fast_exact_select(ops, cfg, lp, lo, hi, prev_count, finished,
                                          beam_scores, K, force_full=cfg.force_full)
            unsound.append(bad)
        c_tok, c_par, c_sco, c_fin, sel_tok, sel_par, new_scores, sel_fin = out
        # candidates of tainted (back-filled) parents are ungrounded: drop
        c_fin = c_fin & ~_gather(tainted, c_par)

        tokens = tokens[(brow * K + sel_par).reshape(-1).long()]
        tokens[:, cur_col + 1] = sel_tok.reshape(-1)
        self_cache = model.reorder_cache(self_cache, (brow * K + sel_par).reshape(-1), step=step,
                                        out=caches[t % 2])

        if constrained:
            # EOS/PAD selections end the constraint sequence (range (0, 0)),
            # and a finished parent stays finished
            lo, hi, prev_count = ops.advance(sel_tok, sel_par, lo, hi, finished,
                                             eos=cfg.eos_token_id, pad=cfg.pad_token_id)
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
