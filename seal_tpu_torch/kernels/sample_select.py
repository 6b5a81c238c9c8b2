"""Kernel 20 wrapper: constrained sampling's per-chain Gumbel-max draw
(``csrc/sample_select.cu``), with its plain version.

Replaces ``seal_tpu/decoding/constrained.py:_select_sample`` (:1092-1122),
its ``jax.random.gumbel`` noise and ``dispatch_select``'s EOS slot
(:1270-1282): each of a query's K chains draws one candidate from its own
row, by the largest constrained log-prob plus Gumbel noise over the finite
slots, and accumulates that slot's log-prob; a chain with no finite slot
takes EOS.

The noise is counter-based, as the source states: Philox4x32-10 words
under key (seed mod 2^32, step) and counter (column // 4, row_offset +
row, 0, 0), u = ((w >> 9) + 0.5) * 2^-23 and g = -log(-log(u)).  Every
entry point takes ``row_offset`` (default 0), the global row of the
call's first row: a data-parallel rank that decodes rows [r0, r1) of a
batch passes r0 (in chains, K a query) and draws what one process draws
for those rows of the whole batch.  The plain version computes
the words in int64 torch arithmetic (32-bit words, products in 16-bit
halves), so they equal the kernel's bit for bit; ``log`` may differ from
the kernel's ``logf`` by an ulp.  It also takes a ``noise`` tensor in place
of its own, and looks up :func:`gumbel_noise` at each call, so that a test
can replay another generator's draws.  JAX's threefry draws are not
reproduced: the two generators agree in distribution, not in bits.

Two entry points: :func:`sample_select` over given constrained log-probs
(a candidate list with its token table, or V-wide rows under an optional
corpus mask), and :func:`sample_select_counts`, the ``exact_mask`` steps'
mode, which reads each beam's count mask (a bit a token) and applies
kernel 17's branches as it reads (so no [B, K * V] scores are written).  :func:`plan`
gives a call's route: a list of up to ``WARP_MAX`` columns a warp, a
wider row a CTA of 256 threads or a cluster of up to 8.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from seal_tpu_torch.kernels import Launches, count_mask
from seal_tpu_torch.kernels.beam_select import NEG_INF, _check, _select_outputs

MASK32 = 0xFFFFFFFF
WARP_MAX = 128  # columns a row up to which one warp draws it (a quad a lane)
BLOCK = 256  # threads of a CTA of the block route (four CTAs an SM)
SLOTS = 4 * 132  # CTAs of the block route an H100 holds at once
MIN_SLICE = 8192  # columns a CTA at least where a row is split over a cluster
MAX_SPLITS = 8
ROUTES = {"warp": Launches(), "block": Launches()}  # sample_select's launches by route
LIST = Launches()  # sample_select's launches on candidate lists (a token table)
PHILOX_M = (0xD2511F53, 0xCD9E8D57)  # Random123's Philox4x32 multipliers
PHILOX_W = (0x9E3779B9, 0xBB67AE85)  # and its key increments (Weyl sequence)


def _mulhilo(a, m: int):
    """(hi, lo) 32-bit words of a * m for int64 ``a`` < 2^32 and a 32-bit
    constant ``m``; each partial product stays below 2^49."""
    t_lo = (a & 0xFFFF) * m
    t_hi = (a >> 16) * m
    mid = t_lo + ((t_hi & 0xFFFF) << 16)
    return (t_hi >> 16) + (mid >> 32), mid & MASK32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int, rounds: int = 10):
    """Philox4x32-``rounds`` (Random123) on int64 tensors of 32-bit words."""
    for r in range(rounds):
        if r:
            k0, k1 = (k0 + PHILOX_W[0]) & MASK32, (k1 + PHILOX_W[1]) & MASK32
        hi0, lo0 = _mulhilo(c0, PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_words(seed: int, step: int, rows: int, n: int, device="cpu", row_offset: int = 0):
    """The 32-bit word of every (row, column) of a [rows, n] draw, int64;
    row r takes the counter of global row ``row_offset + r``."""
    q = (n + 3) // 4
    c0 = torch.arange(q, dtype=torch.int64, device=device).expand(rows, q)
    c1 = (torch.arange(rows, dtype=torch.int64, device=device) + row_offset) & MASK32
    c1 = c1[:, None].expand(rows, q)
    zero = torch.zeros((rows, q), dtype=torch.int64, device=device)
    words = philox4x32(c0, c1, zero, zero, seed & MASK32, step & MASK32)
    return torch.stack(words, -1).reshape(rows, 4 * q)[:, :n]


def gumbel_of_words(words):
    """Gumbel(0, 1) f32 values of 32-bit words: u = ((w >> 9) + 0.5) * 2^-23,
    exact in f32 and strictly inside (0, 1), then -log(-log(u))."""
    u = ((words >> 9).to(torch.float32) + 0.5) * 2.0**-23
    return -torch.log(-torch.log(u))


def gumbel_noise(seed: int, step: int, rows: int, n: int, device="cpu", row_offset: int = 0):
    """The plain version's noise for draw ``step`` of a [rows, n] candidate
    matrix under ``seed``, its rows from global row ``row_offset`` on."""
    return gumbel_of_words(philox_words(seed, step, rows, n, device, row_offset))


def noise_on_card(seed: int, step: int, rows: int, n: int, device, row_offset: int = 0):
    """The kernel's own words (int64) and Gumbel values for the same draw,
    for checking the generator against :func:`philox_words`."""
    from seal_tpu_torch.kernels import build

    words = torch.empty((rows, n), dtype=torch.int32, device=device)
    g = torch.empty((rows, n), dtype=torch.float32, device=device)
    rc = build.lib().seal_gumbel_noise(rows, n, seed, step, row_offset, words.data_ptr(),
                                       g.data_ptr(), build.stream_ptr(words))
    build.check(rc, "gumbel_noise")
    return words.to(torch.int64) & MASK32, g


class Plan(NamedTuple):
    """A call's layout: ``route`` "warp" (one warp a row, two rows a CTA)
    or "block" (``splits`` CTAs of ``BLOCK`` threads a row, a cluster where
    more than one)."""

    route: str
    splits: int

    @property
    def code(self) -> int:
        """The C entry points' ``splits`` argument (0: the warp route)."""
        return 0 if self.route == "warp" else self.splits


def plan(rows: int, n: int) -> Plan:
    """The layout of a draw over ``rows`` chains of ``n`` columns: a row of
    up to ``WARP_MAX`` columns is one warp, a quad a lane (a wider CTA
    would leave most of its threads idle); a wider row one CTA of ``BLOCK``
    threads, split over a cluster (up to 8) while the card would hold twice
    the CTAs (``SLOTS``) and a slice keeps ``MIN_SLICE`` columns (480 V-wide
    rows: one CTA a row; 120: four).  A warp a row lost past one quad a
    lane: at the sampling buffer's 290 slots it took 0.0059 ms against the
    256-thread CTA's 0.0045 on an H100 (``bench_sample``), its lanes'
    quads drawn in series."""
    if n <= WARP_MAX:
        return Plan("warp", 1)
    splits = 1
    while (splits < MAX_SPLITS and rows * splits * 2 <= SLOTS
           and n // (2 * splits) >= MIN_SLICE):
        splits *= 2
    return Plan("block", splits)


def sample_select_plain(cons, cand_lp, tokens, beam_scores, seed: int, step: int, *, eos: int,
                        pad: int, mask=None, noise=None, row_offset: int = 0):
    B, K = beam_scores.shape
    N = cons.shape[-1]
    cons = cons.reshape(B, K, N)
    cand_lp = cand_lp.reshape(B, K, N)
    if mask is not None:
        cons = torch.where(mask, cons, NEG_INF)
    if tokens is None:
        tokens = torch.arange(N, dtype=torch.int32, device=cons.device).expand(B, K, N)
    tokens = tokens.reshape(B, K, N)
    if noise is None:
        noise = gumbel_noise(seed, step, B * K, N, cons.device, row_offset)
    finite = cons > NEG_INF / 4
    idx = torch.where(finite, cons + noise.reshape(B, K, N), NEG_INF).argmax(-1, keepdim=True)
    dead = ~finite.any(-1)
    # dispatch_select's EOS slot: the first slot holding EOS, else slot 0
    eos_slot = (tokens == eos).to(torch.int32).argmax(-1, keepdim=True)
    slot = torch.where(dead[..., None], eos_slot, idx)
    sel_tok = torch.where(dead, eos, torch.gather(tokens, -1, slot)[..., 0]).to(torch.int32)
    sel_sco = torch.gather(cand_lp, -1, slot)[..., 0] + beam_scores
    par = torch.arange(K, dtype=torch.int32, device=cons.device).expand(B, K)
    fin = torch.ones((B, K), dtype=torch.bool, device=cons.device)
    return (
        torch.cat([sel_tok, torch.full_like(sel_tok, pad)], -1),
        torch.cat([par, par], -1),
        torch.cat([sel_sco, torch.full_like(sel_sco, NEG_INF)], -1),
        torch.cat([fin, ~fin], -1),
        sel_tok, par.contiguous(), sel_sco, fin,
    )


def sample_select(cons, cand_lp, tokens, beam_scores, seed: int, step: int, *, eos: int, pad: int,
                  mask=None, row_offset: int = 0):
    """One sampling step of K independent chains per query.

    ``cons`` f32 [B, K, N]: constrained log-probs, without the chain scores
    (``NEG_INF`` where not allowed); ``cand_lp`` f32 [B, K, N]: log-probs;
    ``tokens`` int32 [B, K, N], or None where the token is the column;
    ``beam_scores`` f32 [B, K]; ``mask`` bool [N] (with ``tokens`` None):
    columns allowed at all, applied to ``cons``.  ``seed`` and ``step`` key
    the noise; chain row r draws global row ``row_offset + r``'s.  Returns ``_select_sample``'s eight outputs: the [B, 2K]
    history (the K draws, then K PAD slots at ``NEG_INF``; parents 0..K-1
    twice; finite true then false) and the [B, K] selection (token, parent
    = the chain itself, score, finite = true).

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    if not cons.is_cuda:
        return sample_select_plain(cons, cand_lp, tokens, beam_scores, seed, step, eos=eos,
                                   pad=pad, mask=mask, row_offset=row_offset)
    from seal_tpu_torch.kernels import build

    B, K = beam_scores.shape
    N = cons.shape[-1]
    if cons.numel() != B * K * N or cand_lp.numel() != B * K * N:
        raise ValueError(f"sample_select: cons/cand_lp must be [B, K, N] = [{B}, {K}, {N}]")
    if mask is not None and (tokens is not None or mask.shape != (N,)):
        raise ValueError("sample_select: a mask [N] goes with token = column only")
    cons, cand_lp, beam_scores = cons.contiguous(), cand_lp.contiguous(), beam_scores.contiguous()
    _check(cons, torch.float32, cand_lp, torch.float32, beam_scores, torch.float32)
    if tokens is not None:
        tokens = tokens.contiguous()
        _check(tokens, torch.int32)
        if tokens.numel() != B * K * N:
            raise ValueError("sample_select: tokens must be [B, K, N]")
    if mask is not None:
        mask = mask.contiguous()
        _check(mask, torch.bool)
        if mask.data_ptr() % 4:  # a quad's four bytes in one load
            mask = mask.clone()
    dev = cons.device
    outs = _select_outputs(B, K, dev)[:8]
    opt = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    p = plan(B * K, N)
    rc = build.lib().seal_sample_select(
        cons.data_ptr(), cand_lp.data_ptr(), opt(tokens), opt(mask), beam_scores.data_ptr(), B * K,
        K, N, seed, step, row_offset, eos, pad, NEG_INF, p.code, *(t.data_ptr() for t in outs),
        build.stream_ptr(cons),
    )
    build.check(rc, "sample_select")
    sample_select.launches += 1
    ROUTES[p.route].launches += 1
    LIST.launches += tokens is not None
    return outs


sample_select.launches = 0


def sample_select_counts_plain(mask, lp, prev_count, finished, beam_scores, seed: int,
                               step: int, *, eos: int, pad: int, stop_at_count: int = 0,
                               always_allow_eos: bool = False, noise=None, row_offset: int = 0):
    from seal_tpu_torch.kernels.dense_scores import dense_scores_plain

    B, K = mask.shape[:2]
    V = lp.shape[-1]
    zero = torch.zeros((B, K), dtype=torch.float32, device=lp.device)
    # kernel 17's candidates at zero beam scores
    cons = dense_scores_plain(mask, lp, prev_count, finished, zero, eos=eos, pad=pad,
                              stop_at_count=stop_at_count, always_allow_eos=always_allow_eos)
    return sample_select_plain(cons.reshape(B, K, V), lp, None, beam_scores, seed, step, eos=eos,
                               pad=pad, noise=noise, row_offset=row_offset)


def sample_select_counts(mask, lp, prev_count, finished, beam_scores, seed: int, step: int, *,
                         eos: int, pad: int, stop_at_count: int = 0,
                         always_allow_eos: bool = False, row_offset: int = 0):
    """One sampling step of the ``exact_mask`` mode: :func:`sample_select`
    over ``dense_scores(mask, lp, ..., zero beam scores)`` (kernel 17's
    candidates, N = V), the scores never written.

    ``mask`` int32 [B, K, count_mask.words(V)]: each beam's count mask
    (``dense_mask``, a bit a token); ``lp`` f32 [B*K, V] (any row stride);
    ``prev_count``, ``finished``, ``beam_scores`` [B, K].  A token is
    allowed by kernel 17's branches (stop-forced beams: EOS only; finished
    beams: PAD only; else its bit; ``always_allow_eos`` adds EOS).
    ``row_offset`` as :func:`sample_select`'s.  Returns
    :func:`sample_select`'s eight outputs.

    CPU tensors run the plain version; CUDA tensors launch kernel 20's
    count-reading mode.  Flat indices are 64-bit: B * K * V may pass 2^31.
    """
    kw = dict(eos=eos, pad=pad, stop_at_count=stop_at_count, always_allow_eos=always_allow_eos)
    B, K, W = mask.shape
    V = lp.shape[-1]
    if lp.shape != (B * K, V) or beam_scores.shape != (B, K) or W != count_mask.words(V):
        raise ValueError(f"sample_select_counts: lp {tuple(lp.shape)}, beam_scores "
                         f"{tuple(beam_scores.shape)} vs the count mask {tuple(mask.shape)}")
    if not lp.is_cuda:
        return sample_select_counts_plain(mask, lp, prev_count, finished, beam_scores, seed,
                                          step, row_offset=row_offset, **kw)
    from seal_tpu_torch.kernels import build

    if lp.stride(1) != 1:
        raise ValueError("sample_select_counts: lp must have a unit column stride")
    mask = mask.contiguous()
    prev_count = prev_count.to(torch.int32).contiguous()
    finished = finished.to(torch.bool).contiguous()
    beam_scores = beam_scores.contiguous()
    _check(mask, torch.int32, lp, torch.float32, beam_scores, torch.float32)
    outs = _select_outputs(B, K, lp.device)[:8]
    p = plan(B * K, V)
    rc = build.lib().seal_sample_counts(
        mask.data_ptr(), lp.data_ptr(), lp.stride(0), prev_count.data_ptr(),
        finished.data_ptr(), beam_scores.data_ptr(), B * K, K, V, eos, pad, stop_at_count,
        int(always_allow_eos), seed, step, row_offset, NEG_INF, p.code,
        *(t.data_ptr() for t in outs),
        build.stream_ptr(lp),
    )
    build.check(rc, "sample_select_counts")
    # kernel 20's launches, and this mode's share of them
    sample_select.launches += 1
    sample_select_counts.launches += 1
    return outs


sample_select_counts.launches = 0
