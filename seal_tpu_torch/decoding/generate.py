"""Host-facing generation entry point (counterpart of
``seal_tpu/decoding/generate.py``): encode, constrained beam search on the
index's device, then hypothesis extraction on the host.

With a ``mesh`` (``parallel/mesh.py``) the decode is data-parallel, as
JAX's ``mesh=`` decode with one ``model`` rank (``generate.py:79-117``):
every rank passes the whole batch and decodes its own block of rows, and
the hypotheses are all-gathered in row order, so every rank returns the
whole list.  A sharded index placed on the mesh is JAX's sharded decode
instead (``parallel/sharded_decode.py``): every rank decodes every row
over its own shards.

``extract_hypotheses`` and ``pad_batch`` are numpy copies of the JAX
module's (which imports jax); the tests hold them equal to the originals.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from seal_tpu_torch.decoding.constrained import (
    BeamSearchOutput,
    DecodeConfig,
    constrained_beam_search,
    resolve_window,
)
from seal_tpu_torch.models import api as model_api
from seal_tpu_torch.parallel import mesh as mesh_lib
from seal_tpu_torch.parallel.sharded_index import ShardedTorchIndex

#: Most recent decode's fast-path fallback counters (single-dispatch
#: diagnostics; see BeamSearchOutput.fallback_steps).
LAST_DECODE_STATS = {"fallback_steps": 0, "num_steps": 0}


def pad_batch(seqs: Sequence[Sequence[int]], pad_id: int, multiple: int = 8):
    """Right-pad token lists into [B, L] arrays + attention mask."""
    maxlen = max(len(s) for s in seqs)
    maxlen = ((maxlen + multiple - 1) // multiple) * multiple
    ids = np.full((len(seqs), maxlen), pad_id, np.int32)
    mask = np.zeros((len(seqs), maxlen), np.int32)
    for i, s in enumerate(seqs):
        ids[i, : len(s)] = s
        mask[i, : len(s)] = 1
    return ids, mask


def extract_hypotheses(
    out: BeamSearchOutput, dcfg: DecodeConfig
) -> List[List[Tuple[float, List[int]]]]:
    """Backtrack the candidate history (numpy arrays) into (score,
    token_list) hypotheses; token lists include the decoder-start prefix."""
    c_tok = np.asarray(out.cand_tokens)
    c_par = np.asarray(out.cand_parents)
    c_sco = np.asarray(out.cand_scores)
    c_fin = np.asarray(out.cand_finite)
    s_tok = np.asarray(out.sel_tokens)
    s_par = np.asarray(out.sel_parents)
    f_sco = np.asarray(out.final_scores)
    f_tok = np.asarray(out.final_tokens)
    f_ok = np.asarray(out.final_valid)

    S, B, twoK = c_tok.shape
    K = s_tok.shape[-1]
    prefix = [dcfg.decoder_start_token_id]
    if dcfg.forced_bos_token_id is not None:
        prefix = prefix + [dcfg.forced_bos_token_id]

    # paths[s] is [B, K, s]: the tokens of beam k after s steps
    paths = [np.zeros((B, K, 0), dtype=c_tok.dtype)]
    for s in range(S):
        parent_paths = np.take_along_axis(paths[s], s_par[s][:, :, None], axis=1)
        paths.append(np.concatenate([parent_paths, s_tok[s][:, :, None]], axis=2))

    results: List[List[Tuple[float, List[int]]]] = [[] for _ in range(B)]
    for s in range(S):
        step_fin = c_fin[s]
        if not step_fin.any():
            continue
        base = np.take_along_axis(paths[s], c_par[s][:, :, None], axis=1)
        seqs = np.concatenate([base, c_tok[s][:, :, None]], axis=2).tolist()
        scores = c_sco[s].tolist()
        finite = step_fin.tolist()
        for b in range(B):
            row_seq, row_sco, row_fin = seqs[b], scores[b], finite[b]
            hyps = results[b]
            for j in range(twoK):
                if row_fin[j]:
                    hyps.append((row_sco[j], prefix + row_seq[j]))
    final_ok = f_ok & np.isfinite(f_sco) & (f_sco > -1e30)
    f_sco_l = f_sco.tolist()
    f_tok_l = f_tok.tolist()
    for b, k in zip(*np.nonzero(final_ok)):
        results[b].append((f_sco_l[b][k], list(f_tok_l[b][k])))
    return results


def _to_host(out: BeamSearchOutput) -> BeamSearchOutput:
    return BeamSearchOutput(
        **{
            f.name: getattr(out, f.name).cpu().numpy()
            for f in dataclasses.fields(out)
        }
    )


def _search(model_cfg, params, index, dcfg, ids, mask, seed: int = 0, mesh=None,
            row_offset: int = 0) -> BeamSearchOutput:
    ops = None
    if isinstance(index, ShardedTorchIndex):  # sharded_fm_index_generate's route
        from seal_tpu_torch.parallel.sharded_decode import ShardedIndexOps

        ops = ShardedIndexOps(index, mesh)
    with torch.inference_mode():
        enc = model_api.module_for(model_cfg).encode(model_cfg, params, ids, mask)
        return constrained_beam_search(model_cfg, params, index, dcfg, enc, mask, seed=seed,
                                       index_ops=ops, row_offset=row_offset)


def _data_rows(mesh, B: int) -> slice:
    """This rank's block of a data-parallel batch of ``B`` rows."""
    n = mesh.size("data")
    if B % n:
        raise ValueError(f"data-parallel decode: a batch of {B} rows over a data axis of {n} "
                         "ranks (pad the batch to a multiple of the ranks)")
    b = B // n
    return slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)


def fm_index_generate_async(
    model_cfg,
    params,
    index,
    input_ids,  # [B, L] np/torch int or list of token lists
    attention_mask=None,
    min_length: int = 3,
    max_length: int = 25,
    length_penalty: float = 1.0,  # accepted for parity; cancels in history mode
    num_beams: int = 3,
    eos_token_id: Optional[int] = None,
    force_decoding_from: Optional[Sequence[int]] = None,
    always_allow_eos: bool = False,
    keep_history: bool = True,
    disable_fm_index: bool = False,
    stop_at_count: int = 0,
    forced_bos_token_id: Optional[int] = "default",
    top_m: int = 256,
    window: int = 0,  # 0 = auto (constrained.resolve_window)
    exact_chunk: int = 64,
    exact_topk_blk: int = 0,  # the TPU's block width for its top-k: no effect here
    exact_loop_chunk: int = 0,
    dense_chunk: int = 2048,  # tokens a plain (CPU) exact_mask count sweep takes at once
    speculative: bool = False,
    exact_mask: bool = False,
    exact_ties: bool = False,
    sample: bool = False,
    topk: int = 0,
    adjust_logits_fn=None,
    diverse_bs_groups: int = 1,
    diverse_bs_penalty: float = 0.0,
    seed: int = 0,  # keys the sample mode's noise
    mesh=None,
    force_full: bool = False,
):
    """Run constrained generation on the index's device; returns a
    zero-arg ``finalize`` that moves the result to the host, re-runs the
    batch with ``force_full`` when some step's fast proof failed, and
    extracts the hypotheses.  ``force_full=True`` runs every step through
    the proven loop from the start (a check of the fast path: the
    hypotheses must be identical).  Takes every keyword of the JAX
    function: ``disable_fm_index`` (free generation), ``speculative``,
    ``topk``, ``forced_bos_token_id``, ``adjust_logits_fn`` (a torch
    function of the raw f32 logits [rows, V] and ``cur_len``, a Python
    ``int``), ``sample`` with its ``seed`` and diverse groups
    (``diverse_bs_groups``, ``diverse_bs_penalty``) run as in JAX; the
    sampler's noise is the port's own (counter-based Philox keyed by
    ``seed``), so a seed gives other draws than JAX's.  ``mesh``: a
    data-parallel decode over the mesh's ``data`` ranks (the batch's rows
    must divide by them; every rank passes the whole batch and gets every
    row's hypotheses; a sampled decode draws what one process draws), or,
    for a sharded index placed on the mesh, the sharded decode."""
    del length_penalty, keep_history  # no effect on the exact beam path
    del exact_topk_blk
    dev = index.device
    if isinstance(input_ids, (list, tuple)):
        input_ids, attention_mask = pad_batch(input_ids, model_cfg.pad_token_id)
    ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.int32).to(dev)
    if attention_mask is None:
        mask = (ids != model_cfg.pad_token_id).to(torch.int32)
    else:
        mask = torch.as_tensor(np.asarray(attention_mask), dtype=torch.int32).to(dev)
    if mesh is not None and mesh.size("model") > 1:
        raise NotImplementedError(mesh_lib.MODEL_AXIS)
    data_parallel = mesh is not None and not isinstance(index, ShardedTorchIndex)
    row_offset = 0
    if data_parallel:
        rows = _data_rows(mesh, ids.shape[0])
        ids, mask, row_offset = ids[rows], mask[rows], rows.start
    if forced_bos_token_id == "default":
        forced_bos_token_id = model_cfg.forced_bos_token_id

    dcfg = DecodeConfig(
        num_beams=num_beams,
        max_length=max_length,
        min_length=min_length,
        eos_token_id=int(eos_token_id if eos_token_id is not None else model_cfg.eos_token_id),
        pad_token_id=model_cfg.pad_token_id,
        decoder_start_token_id=model_cfg.decoder_start_token_id,
        forced_bos_token_id=forced_bos_token_id,
        force_decoding_from=tuple(force_decoding_from) if force_decoding_from else None,
        stop_at_count=stop_at_count,
        always_allow_eos=always_allow_eos,
        disable_fm_index=disable_fm_index,
        top_m=min(top_m, model_cfg.vocab_size),
        window=resolve_window(window, num_beams, speculative),
        exact_chunk=exact_chunk,
        exact_loop_chunk=exact_loop_chunk,
        dense_chunk=dense_chunk,
        speculative=speculative,
        exact_mask=exact_mask,
        exact_ties=exact_ties,
        sample=sample,
        topk=topk,
        adjust_logits_fn=adjust_logits_fn,
        num_groups=diverse_bs_groups,
        diversity_penalty=diverse_bs_penalty,
        force_full=force_full,
    )
    out = _search(model_cfg, params, index, dcfg, ids, mask, seed, mesh, row_offset)

    def finalize() -> List[List[Tuple[float, List[int]]]]:
        fetched = _to_host(out)
        # the largest rank's count: every rank takes the redo branch together
        n_fallback = int(mesh_lib.pmax(mesh, out.fallback_steps.reshape(1).clone()).item())
        LAST_DECODE_STATS["fallback_steps"] = n_fallback
        LAST_DECODE_STATS["num_steps"] = dcfg.num_steps
        if n_fallback and not dcfg.force_full:
            # some step's round-0 candidate set could not be proven
            # sufficient: redecode the batch through the proven loop
            full = dataclasses.replace(dcfg, force_full=True)
            fetched = _to_host(_search(model_cfg, params, index, full, ids, mask, seed, mesh,
                                       row_offset))
        hyps = extract_hypotheses(fetched, dcfg)
        if data_parallel:  # every rank's rows, in row order
            hyps = [h for part in mesh_lib.gather_objects(mesh, hyps) for h in part]
        return hyps

    return finalize


def fm_index_generate(*args, **kwargs) -> List[List[Tuple[float, List[int]]]]:
    """Constrained generation; returns per-query [(score, token_list), ...]."""
    return fm_index_generate_async(*args, **kwargs)()
