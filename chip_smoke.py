#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``seal_tpu_torch``) on one GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi); exits non-zero
   without a result when no CUDA device is available or the package is
   missing.
2. Builds the CUDA kernels from ``seal_tpu_torch/kernels/csrc`` (timed).
3. Drives the main path: ``fm_index_generate`` with BART-large (random
   weights from a seed, bf16) over a 1.2M-token Zipf corpus (10k docs x
   120 tokens), batch 32, beam 15, key length 10 (the operating point of
   ``seal_tpu_torch.bench_generate``), and reports queries/s and how often
   each kernel was launched in that run.
4. Checks every emitted key against the host index (``get_count > 0``),
   that a ``force_full`` re-run gives identical hypotheses, and that every
   kernel of the path was launched; profiles one more batch (device time
   by kernel, the device's busy share).
5. Holds kernels 1-4 and 8-11 (8 in both orders) against their plain
   PyTorch versions at the main path's shapes, on the card, and times both
   beside each kernel's bound and, where one PyTorch call computes the same
   function, that call (``torch.topk``, ``torch.log_softmax``,
   ``scaled_dot_product_attention``); kernel 3 also at every call site's
   shape and k (the ``row_topk sites:`` line: bit-equal to its plain
   version, beside ``torch.topk`` at the same k and its bound); runs the port on the card against
   its plain CPU path on a small input (over each index layout); checks
   the bf16 LM head's f32 result.
6. Builds the compact and hybrid wavelet indexes of the same corpus
   (``bench_generate.build_index``), logs each layout's device bytes and
   bytes/token beside the Psi index's, and drives the same generation
   point over each: queries/s, the run's launches (kernels 12-13 and none
   of the Psi index kernels 1, 2, 5, 6), every key grounded, hypotheses
   identical to the Psi layout's (tokens, score bits), a ``force_full``
   re-run identical and through kernel 14's support mode, one profiled
   batch; then times
   the three layouts in turns (the host clock drifts between phases) and
   profiles one batch of each again in the reverse order.  Holds
   kernels 12-14 against their plain versions at the path's shapes on both
   layouts, exactly, each timed beside its Psi counterpart.
7. Drives the second path, ``SEALSearcher.batch_search`` at the
   end-to-end bench point of ``seal_tpu_torch.bench_search`` (BART-large
   bf16, a 10k-document word corpus, 32 queries in units of 16, every key
   path on): reports queries/s, the phase split and each kernel's launches
   in that run; checks that the raw body and title keys of one unit are
   grounded and that a ``force_full`` re-run of its title decode is
   identical; profiles one unit; holds kernels 5-7 against their plain
   versions at the path's shapes; builds the searcher with
   ``compact_index`` and with ``hybrid_index`` from the same host index,
   tokenizer and parameters and runs ``batch_search`` on the same queries
   (queries/s, phases, launches; documents and order equal to the Psi
   searcher's, scores within 1e-6 relative), then all three in turns;
   runs the tiny searcher on the card, over each layout, against its CPU
   path.
8. Drives the dense parity mode (``exact_mask``) at the generation point
   over the three layouts (kernels 15, 16 and 17, kernel 3 on [B, K * V]
   rows, kernel 8's epilogue; no proposal merge): queries/s, launches,
   every key grounded, hypotheses bit-identical to the fast path's; the
   fast path with ``exact_ties`` (kernel 8's ties mode), identical too;
   a tiny model with exact logit ties (fast with ``exact_ties`` == dense,
   card == CPU); one searcher unit with ``exact_mask`` (documents equal to
   the fast searcher's); kernels 15-17 and the ties mode against their
   plain versions at the path's shapes, on both routes of 15 and 16.
9. Drives the decode modes at the generation point: free generation
   (``disable_fm_index``: kernel 3's top-256 and top-2K, kernel 8's
   token-table epilogue; no index kernel; hypotheses identical at
   ``top_m`` 256 and 2K), ``speculative`` over the three layouts (kernel
   3's top-256, one membership query and the window a step, kernel 8's
   ``keep_invalid`` mode; every key grounded, hypotheses bit-identical
   across layouts; how many queries equal the fast path's is logged),
   ``forced_bos_token_id=0`` (column 1 pinned, keys grounded, ``force_full``
   identical) and the top-k warper (``topk=50``: its masked log-softmax in
   one launch of kernel 3's select, ``topk_log_softmax``, every step, and
   neither kernel 19 nor kernel 4); a tiny model's modes on the card
   against its CPU path (``topk=1`` free generation collapses to one
   path); one ``free_generation`` searcher unit at the e2e point and the
   tiny searcher's; ``locate_rows`` / ``doc_index_of`` (kernel 18) on every
   occurrence row of one unit's keys (at most ``max_hits`` each) of a
   ``keep_sa`` index, against their plain versions and the host index;
   the search timed beside ``torch.searchsorted`` eager and graph-replayed.
   Kernels 18-19, the warper and the modes of 8 against their plain
   versions.
10. Drives constrained sampling (``sample``: kernel 20 every step, the V-wide
   step 0 under the corpus mask; steps >= 1 through the proven loop and
   kernel 8's candidate mode, kernel 20 on the candidate lists; ``exact_mask``
   steps >= 1 through kernel 20's count-reading mode, with no streaming
   pass; kernel 8 selects nothing) at the generation
   point: seeds 0 and 1 on the Psi layout (three batches each: one seed
   gives identical hypotheses every batch, the two seeds differ, a query's
   chains end in more than one key), the compact and hybrid layouts
   (identical to the Psi layout's draws), ``exact_mask`` and free
   generation; diverse groups (three groups, penalty 0.5: kernel 21 every
   step) on the three layouts, with ``exact_mask`` and ``exact_ties``
   (hypotheses bit-identical across layouts and between the proposal route
   and ``exact_mask``); every key grounded; one searcher unit with
   ``diverse_bs_groups=3``; the tiny model's sampling and diverse groups on
   the card against its CPU path; a profiled batch each of sampling,
   sampled ``exact_mask``, ``topk=50`` and diverse groups (device ms,
   launches, kernel 20's and the warper's device ms).  Kernels 20 (V-wide,
   at batch 32 and on batch 8's cluster route; list; count-reading, beside
   the streaming pass and the V-wide draw it replaced), 21 and 8's
   candidate mode against their plain versions at the path's shapes,
   eager and graph-replayed: Philox words exactly,
   Gumbel values within 8 ulps, draws equal away from near-ties, and 2^16
   draws of one row against its softmax (chi-square); 21 and 8c bit for
   bit, 21 on its wide, list and chunked routes with its kernels a call
   counted by the profiler and the wide route's proof counter at 0.

11. Drives T5-base (``T5Config()``, random weights from a seed, f32 as the
   JAX searcher builds it for a ``t5`` backbone; ``bench_generate.
   t5_operating_point``) through ``fm_index_generate`` at the generation
   point's shape (10k docs x 120 Zipf ids in [2, 32000) ending in eos 1,
   batch 32, beam 15, length 10) on the Psi layout: queries/s, launches
   (kernels 9 and 10's relative-bias mode once per decoder layer and step,
   BART's self-attention mode never, 11 once per step), every key grounded,
   ``force_full``, ``exact_mask`` and the hybrid layout identical (tokens,
   score bits), one profiled batch, one batch in bf16; kernel 10's
   relative-bias mode against its plain version at rows 480, 12 heads of
   64, every step 0-9, in f32 and bf16 (timed beside SDPA with the bias as
   its mask and scale 1), kernel 9 with an un-scaled q, the card's
   bucket-of-distance vector against the CPU's; one 16-query
   ``batch_search`` unit at ``backbone="t5-base"`` (``bench_search.
   t5_operating_point``: titles on, its corpus carries T5's markers) with
   its raw keys grounded; the tiny T5 on the card against its CPU path
   (fast path and ``exact_mask``).
12. Drives the corpus-sharded index with every shard on the card
   (``bench_generate.sharded_index``: the generation corpus split
   round-robin into 4 shards, ``ShardedTorchIndex``) through
   ``sharded_fm_index_generate`` at the generation point: queries/s beside
   the monolithic Psi index's in turns, the index's bytes/token, launches
   (the shard modes of kernels 1, 2, 5, 6 and 15, none of the monolithic
   index kernels, each shard mode once per op call); every key grounded in
   the union (the shards' summed counts), the fast path identical to
   ``force_full`` and ``exact_mask``, 4 shards identical to the monolithic
   index and one shard identical with the monolithic kernels' launches
   (an exact score tie, shown by both agreeing under ``exact_ties``, is the
   only admissible difference); beam 32 over the shards (``BASELINE.md``'s
   config-5 shape) through kernel 8's wide route, identical to
   ``force_full`` and ``exact_mask``; ``SEALSearcher.build_sharded`` at the
   e2e point (``bench_search.sharded_searcher``) beside the monolithic
   searcher: queries/s, raw keys grounded in the union, body keys identical,
   the top-10 overlap and score difference.  The shard modes and kernel 8's
   large-n route (forced: an entry point no path launches) against their
   plain versions at the path's shapes, exactly.

13. Kernel 8's selection routes against their plain versions, bit for
   bit, in both orders (``select_route_phase``): the warp route at the
   bench's [32, 15, 64] (timed beside the one-block route on the same
   inputs) and beam 32's [32, 32, 98], the wide route at the speculative
   default [32, 15, 386] and beam 32 over 4 shards [32, 32, 578] (timed
   beside the block and large-n routes on the same inputs; no path
   launches those two), the table route at a speculative
   round of top_m 20000 and the candidate mode's table, the merge in
   device memory at buffers of 3000 (ties) and 10000; kernel 1's groups
   and step mode against their plain versions (the step mode beside the
   composition it replaced); one batch each at the sizes the card refused
   before F1 and F2 (sampling at top_m 3000 under ``exact_ties`` and
   10000, speculative at 20000), every key grounded, each through its
   route.
14. Kernel 2's window + slab mode (a step's window and proposal round 0's
   slab in one launch, where a beam needs the round), its slab mode (a straggler round's, the bounds
   computed in the kernel) and the same modes over the shards, and kernel
   12's step mode (the range update after a selection on the compact and
   hybrid layouts), each against its plain version at the path's shapes,
   exactly, and timed eager and graph-replayed beside the separate calls
   the decode step made before them.
15. Kernels 6 and 14's support modes (the straggler rounds' pruning input:
   8 words a range, bit b set iff bucket b's count is positive; kernel 6
   also over the shards) against their plain versions and their counts
   modes' > 0, at the path's ranges and kernel 6's narrow/wide route
   boundary, timed beside the counts modes; and a straggler round's select
   in one launch (``pruned_topk``: kernel 3's select through the pruning
   loader) bit for bit against kernel 3 over the parent's pruned rows at
   [480, 50265], k = 256 and 20,000, on the Psi and compact bucket sizes,
   timed beside the parent's round (``composed_*``).
16. Drives the training path: BART-large (``bart_large()`` with bf16
   compute, f32 master parameters from a seed) through
   ``training.trainer.make_train_step`` for 5 steps on one seeded batch at
   the train CLI's defaults (32 pairs, sources padded to 128, targets
   bucketed to 80, some pad; warm-up 1, lr 1e-4): every loss finite, the
   5th below the 1st, kernel 22's forward and backward and kernel 23's
   norm and update modes once a step each; the step's wall, its peak
   memory and one profiled step (device ms, kernels, busy share).  Holds
   kernel 22 at the step's own [2560, 50265] logits (loss, ntok, each
   row's lse against an f64 log-sum-exp, the gradient) and kernel 23 over the step's own gradients, parameters and moments
   (the norm, then p, mu and nu after one update) against their plain
   versions, eager and graph-replayed, beside ``F.cross_entropy`` with
   ``label_smoothing`` and ``clip_grad_norm_`` + fused ``AdamW`` (another
   function: its clip's eps and decay differ); 3 steps of bart_tiny in f32
   on the card against the CPU path (``training.parity``, which the card's
   tests call too); the train CLI on a tiny word-vocab
   dataset (6 steps, a checkpoint at step 6).

Each path's launch counts come from that path's own run (every count set
to 0 just before it, read just after); on every decoding path kernels 9
and 10 (BART's mode, or the relative-bias mode on the T5 paths) must launch
once per decoder layer and decode step, kernels 8 (select) and 11 once per
decode step, kernel 1's step mode once per selecting step where the
decode runs over the Psi index with the constraint on, kernel 12's once
per selecting step on the compact and hybrid layouts, and kernel 2 (or its
shard mode) once per selecting step after step 0 where the step takes a
window and proposals on the Psi index (or the shards): its window + slab
mode where a beam needs a proposal round, its window mode where none does,
besides the straggler rounds' slab mode; each straggler round launches
the pruning select once (as many as the slab mode's round launches), and
no path launches a bucket counts mode; the main path selects on kernel
8's warp route.
Prints one JSON object with the kernel table on the line before the last,
and ``{"ok": true, "device": {...}}`` as the last line.  Imports no jax.
"""

from __future__ import annotations

import collections
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# the TPU op each kernel replaces (file:line of its definition)
REPLACES = {
    "fm_search": "seal_tpu/ops/fm_ops.py:166",
    "window_gather": "seal_tpu/ops/_generic.py:41",
    "row_topk": "seal_tpu/decoding/constrained.py:395",
    "log_softmax_min_len": "seal_tpu/decoding/constrained.py:276",
    "fm_sequences": "seal_tpu/ops/_generic.py:17",
    "bucket_counts": "seal_tpu/ops/fm_ops.py:238",
    "rescore_logprob": "seal_tpu/scoring/keys.py:102",
    "beam_merge": "seal_tpu/decoding/constrained.py:612",
    "beam_select": "seal_tpu/decoding/constrained.py:1046",
    "cross_attention_step": "seal_tpu/models/bart.py:156",
    "self_attention_step": "seal_tpu/models/bart.py:275",
    "reorder_cache": "seal_tpu/models/bart.py:356",
    "wt_search": "seal_tpu/ops/wt_ops.py:136",
    "wt_window_gather": "seal_tpu/ops/wt_ops.py:115",
    "wt_bucket_counts": "seal_tpu/ops/wt_ops.py:203",
    "fm_dense_counts": "seal_tpu/ops/fm_ops.py:339",
    "wt_dense_counts": "seal_tpu/ops/wt_ops.py:237",
    # the mask modes: the counts as exact_mask reads them (fm_valid = counts > 0)
    "fm_dense_mask": "seal_tpu/ops/fm_ops.py:339",
    "wt_dense_mask": "seal_tpu/ops/wt_ops.py:237",
    "dense_scores": "seal_tpu/decoding/constrained.py:321",
    "dense_select": "seal_tpu/decoding/constrained.py:321",
    "beam_select_ties": "seal_tpu/decoding/constrained.py:934",
    "locate_rows": "seal_tpu/ops/fm_ops.py:322",
    "doc_index_of": "seal_tpu/ops/fm_ops.py:330",
    "row_kth": "seal_tpu/decoding/constrained.py:289",
    "beam_select_free": "seal_tpu/decoding/constrained.py:329",
    "beam_select_spec": "seal_tpu/decoding/constrained.py:343",
    "topk_log_softmax": "seal_tpu/decoding/constrained.py:294",
    "sample_select": "seal_tpu/decoding/constrained.py:1092",
    "sample_select_list": "seal_tpu/decoding/constrained.py:1092",
    "sample_select_counts": "seal_tpu/decoding/constrained.py:1092",
    "diverse_select": "seal_tpu/decoding/constrained.py:1125",
    "diverse_select_wide": "seal_tpu/decoding/constrained.py:1125",
    "beam_candidates": "seal_tpu/decoding/constrained.py:359",
    "self_attention_step_t5": "seal_tpu/models/t5.py:349",
    "fm_search_sharded": "seal_tpu/parallel/sharded_decode.py:95",
    "window_gather_sharded": "seal_tpu/parallel/sharded_decode.py:100",
    "fm_sequences_sharded": "seal_tpu/parallel/sharded_index.py:455",
    "bucket_counts_sharded": "seal_tpu/parallel/sharded_decode.py:138",
    "fm_dense_counts_sharded": "seal_tpu/parallel/sharded_decode.py:147",
    "fm_dense_mask_sharded": "seal_tpu/parallel/sharded_decode.py:147",
    "beam_select_large": "seal_tpu/decoding/constrained.py:1046",
    "beam_merge_large": "seal_tpu/decoding/constrained.py:612",
    "row_topk_global": "seal_tpu/decoding/constrained.py:736",
    "cross_attention_step_f32": "seal_tpu/models/t5.py:212",
    "fm_search_advance": "seal_tpu/decoding/constrained.py:1416",
    # kernel 1's shard modes: the step mode (the sharded range update in one
    # launch) and the backward step (ShardedIndexOps.extend), an entry point
    "fm_search_advance_sharded": "seal_tpu/decoding/constrained.py:1416",
    "fm_search_step_sharded": "seal_tpu/parallel/sharded_decode.py:120",
    "beam_select_warp": "seal_tpu/decoding/constrained.py:1046",
    "beam_select_table": "seal_tpu/decoding/constrained.py:343",
    "beam_merge_table": "seal_tpu/decoding/constrained.py:612",
    "beam_select_wide": "seal_tpu/decoding/constrained.py:1046",
    "beam_select_block": "seal_tpu/decoding/constrained.py:1046",
    "window_slab": "seal_tpu/decoding/constrained.py:622",
    "slab_gather": "seal_tpu/decoding/constrained.py:622",
    "window_slab_sharded": "seal_tpu/parallel/sharded_decode.py:100",
    "slab_gather_sharded": "seal_tpu/parallel/sharded_decode.py:100",
    "wt_search_advance": "seal_tpu/decoding/constrained.py:1416",
    "wt_window_slab": "seal_tpu/decoding/constrained.py:622",
    "wt_slab_gather": "seal_tpu/decoding/constrained.py:622",
    # the support modes: the counts as the straggler rounds read them
    # (bucket_counts(...) > 0, seal_tpu/decoding/constrained.py:604)
    "bucket_support": "seal_tpu/ops/fm_ops.py:238",
    "wt_bucket_support": "seal_tpu/ops/wt_ops.py:203",
    "bucket_support_sharded": "seal_tpu/parallel/sharded_decode.py:138",
    # a straggler round's pruning (:604-608), consumed mask and top-k
    # (:734-736) in one launch of kernel 3's select
    "pruned_topk": "seal_tpu/decoding/constrained.py:734",
    # kernel 22: the loss and its gradient under value_and_grad; kernel 23:
    # optax's clip_by_global_norm, then adamw
    "label_smoothed_nll": "seal_tpu/training/trainer.py:38",
    "label_smoothed_nll_backward": "seal_tpu/training/trainer.py:85",
    "clip_global_norm": "seal_tpu/training/trainer.py:61",
    "adamw_update": "seal_tpu/training/trainer.py:62",
}
SOURCES = {
    "fm_search": ("cuda", "seal_tpu_torch/kernels/csrc/fm_search.cu"),
    "window_gather": ("cuda", "seal_tpu_torch/kernels/csrc/window_gather.cu"),
    "row_topk": ("cuda", "seal_tpu_torch/kernels/csrc/row_topk.cu"),
    "log_softmax_min_len": ("triton", "seal_tpu_torch/kernels/triton_logsoftmax.py"),
    "fm_sequences": ("cuda", "seal_tpu_torch/kernels/csrc/fm_search.cu"),
    "bucket_counts": ("cuda", "seal_tpu_torch/kernels/csrc/bucket_counts.cu"),
    "rescore_logprob": ("cuda", "seal_tpu_torch/kernels/csrc/rescore.cu"),
    "beam_merge": ("cuda", "seal_tpu_torch/kernels/csrc/beam_select.cu"),
    "beam_select": ("cuda", "seal_tpu_torch/kernels/csrc/beam_select.cu"),
    "cross_attention_step": ("cuda", "seal_tpu_torch/kernels/csrc/decode_attention.cu"),
    "self_attention_step": ("cuda", "seal_tpu_torch/kernels/csrc/decode_attention.cu"),
    "reorder_cache": ("cuda", "seal_tpu_torch/kernels/csrc/reorder_cache.cu"),
    "wt_search": ("cuda", "seal_tpu_torch/kernels/csrc/wt_search.cu"),
    "wt_window_gather": ("cuda", "seal_tpu_torch/kernels/csrc/wt_window.cu"),
    "wt_bucket_counts": ("cuda", "seal_tpu_torch/kernels/csrc/wt_bucket_counts.cu"),
    "fm_dense_counts": ("cuda", "seal_tpu_torch/kernels/csrc/fm_search.cu"),
    "wt_dense_counts": ("cuda", "seal_tpu_torch/kernels/csrc/wt_search.cu"),
    "fm_dense_mask": ("cuda", "seal_tpu_torch/kernels/csrc/fm_search.cu"),
    "wt_dense_mask": ("cuda", "seal_tpu_torch/kernels/csrc/wt_search.cu"),
    "dense_scores": ("cuda", "seal_tpu_torch/kernels/csrc/dense_scores.cu"),
    "dense_select": ("cuda", "seal_tpu_torch/kernels/csrc/dense_scores.cu"),
    "beam_select_ties": ("cuda", "seal_tpu_torch/kernels/csrc/beam_select.cu"),
    "locate_rows": ("cuda", "seal_tpu_torch/kernels/csrc/locate.cu"),
    "doc_index_of": ("cuda", "seal_tpu_torch/kernels/csrc/locate.cu"),
    "row_kth": ("cuda", "seal_tpu_torch/kernels/csrc/row_select.cu"),
    "beam_select_free": ("cuda", "seal_tpu_torch/kernels/csrc/beam_select.cu"),
    "beam_select_spec": ("cuda", "seal_tpu_torch/kernels/csrc/beam_select.cu"),
    "topk_log_softmax": ("cuda", "seal_tpu_torch/kernels/csrc/row_select.cu"),
    "sample_select": ("cuda", "seal_tpu_torch/kernels/csrc/sample_select.cu"),
    "sample_select_list": ("cuda", "seal_tpu_torch/kernels/csrc/sample_select.cu"),
    "sample_select_counts": ("cuda", "seal_tpu_torch/kernels/csrc/sample_select.cu"),
    "diverse_select": ("cuda", "seal_tpu_torch/kernels/csrc/diverse_select.cu"),
    "diverse_select_wide": ("cuda", "seal_tpu_torch/kernels/csrc/diverse_select.cu"),
    "beam_candidates": ("cuda", "seal_tpu_torch/kernels/csrc/beam_select.cu"),
    "self_attention_step_t5": ("cuda", "seal_tpu_torch/kernels/csrc/decode_attention.cu"),
    "fm_search_sharded": ("cuda", "seal_tpu_torch/kernels/csrc/fm_search.cu"),
    "window_gather_sharded": ("cuda", "seal_tpu_torch/kernels/csrc/window_gather.cu"),
    "fm_sequences_sharded": ("cuda", "seal_tpu_torch/kernels/csrc/fm_search.cu"),
    "bucket_counts_sharded": ("cuda", "seal_tpu_torch/kernels/csrc/bucket_counts.cu"),
    "fm_dense_counts_sharded": ("cuda", "seal_tpu_torch/kernels/csrc/fm_search.cu"),
    "fm_dense_mask_sharded": ("cuda", "seal_tpu_torch/kernels/csrc/fm_search.cu"),
    "beam_select_large": ("cuda", "seal_tpu_torch/kernels/csrc/beam_select.cu"),
    "beam_merge_large": ("cuda", "seal_tpu_torch/kernels/csrc/beam_select.cu"),
    "row_topk_global": ("cuda", "seal_tpu_torch/kernels/csrc/row_topk.cu"),
    "cross_attention_step_f32": ("cuda", "seal_tpu_torch/kernels/csrc/decode_attention.cu"),
    "fm_search_advance": ("cuda", "seal_tpu_torch/kernels/csrc/fm_search.cu"),
    "fm_search_advance_sharded": ("cuda", "seal_tpu_torch/kernels/csrc/fm_search.cu"),
    "fm_search_step_sharded": ("cuda", "seal_tpu_torch/kernels/csrc/fm_search.cu"),
    "beam_select_warp": ("cuda", "seal_tpu_torch/kernels/csrc/beam_select.cu"),
    "beam_select_table": ("cuda", "seal_tpu_torch/kernels/csrc/beam_select.cu"),
    "beam_merge_table": ("cuda", "seal_tpu_torch/kernels/csrc/beam_select.cu"),
    "beam_select_wide": ("cuda", "seal_tpu_torch/kernels/csrc/beam_select.cu"),
    "beam_select_block": ("cuda", "seal_tpu_torch/kernels/csrc/beam_select.cu"),
    "window_slab": ("cuda", "seal_tpu_torch/kernels/csrc/window_gather.cu"),
    "slab_gather": ("cuda", "seal_tpu_torch/kernels/csrc/window_gather.cu"),
    "window_slab_sharded": ("cuda", "seal_tpu_torch/kernels/csrc/window_gather.cu"),
    "slab_gather_sharded": ("cuda", "seal_tpu_torch/kernels/csrc/window_gather.cu"),
    "wt_search_advance": ("cuda", "seal_tpu_torch/kernels/csrc/wt_search.cu"),
    "wt_window_slab": ("cuda", "seal_tpu_torch/kernels/csrc/wt_window.cu"),
    "wt_slab_gather": ("cuda", "seal_tpu_torch/kernels/csrc/wt_window.cu"),
    "bucket_support": ("cuda", "seal_tpu_torch/kernels/csrc/bucket_counts.cu"),
    "wt_bucket_support": ("cuda", "seal_tpu_torch/kernels/csrc/wt_bucket_counts.cu"),
    "bucket_support_sharded": ("cuda", "seal_tpu_torch/kernels/csrc/bucket_counts.cu"),
    "pruned_topk": ("cuda", "seal_tpu_torch/kernels/csrc/row_topk.cu"),
    "label_smoothed_nll": ("cuda", "seal_tpu_torch/kernels/csrc/train_loss.cu"),
    "label_smoothed_nll_backward": ("cuda", "seal_tpu_torch/kernels/csrc/train_loss.cu"),
    "clip_global_norm": ("cuda", "seal_tpu_torch/kernels/csrc/adamw.cu"),
    "adamw_update": ("cuda", "seal_tpu_torch/kernels/csrc/adamw.cu"),
}
# the kernels each driven path must launch (the straggler rounds' support
# bits, pruning select and merges run only in the proven loop, which the
# force_full re-runs reach; kernel 4 must also show from the unigram call on
# its own)
DECODE_STEP = ("beam_merge", "beam_select", "cross_attention_step", "self_attention_step",
               "reorder_cache")
PATH_KERNELS = {
    # the bench point selects on kernel 8's warp route, kernel 1's step mode
    # advances the ranges once a step, kernel 2's window + slab mode gathers
    # a step's window and round 0's slab (its slab mode a straggler round's)
    "generate": ("fm_search", "window_gather", "row_topk", "log_softmax_min_len",
                 "fm_search_advance", "beam_select_warp", "window_slab") + DECODE_STEP,
    "generate_force_full": ("bucket_support", "pruned_topk", "beam_merge", "slab_gather"),
    "batch_search": ("fm_search", "window_gather", "row_topk", "log_softmax_min_len",
                     "fm_sequences", "rescore_logprob", "fm_search_advance",
                     "window_slab") + DECODE_STEP,
    "unigram": ("log_softmax_min_len",),
    "grounding_unit": ("fm_sequences",),
}
# the compact and hybrid wavelet layouts: the same paths through kernels
# 12-14, and none of the Psi index kernels they replace (1, 2, 5, 6); the
# hybrid window is kernel 13's direct mode, not kernel 2.  Kernel 12's step
# mode advances the ranges, kernel 13's window + slab mode gathers a step's
# window and round 0's slab in one launch (its slab mode a straggler
# round's), as kernel 2 does on the Psi index
WAVELET_LAYOUTS = ("compact", "hybrid")
PSI_INDEX_KERNELS = ("fm_search", "window_gather", "fm_sequences", "bucket_counts",
                     "bucket_support", "fm_dense_counts", "fm_dense_mask")
for _layout in WAVELET_LAYOUTS:
    PATH_KERNELS[f"generate_{_layout}"] = (
        "wt_search", "wt_window_gather", "row_topk", "log_softmax_min_len",
        "wt_search_advance", "wt_window_slab") + DECODE_STEP
    PATH_KERNELS[f"generate_{_layout}_force_full"] = ("wt_bucket_support", "pruned_topk",
                                                      "beam_merge", "wt_slab_gather")
    PATH_KERNELS[f"batch_search_{_layout}"] = (
        "wt_search", "wt_window_gather", "row_topk", "log_softmax_min_len",
        "rescore_logprob", "wt_search_advance", "wt_window_slab") + DECODE_STEP
# the dense parity mode (exact_mask): each step's count mask (kernel 15's
# mask mode, or 16's on the wavelet layouts; never their counts modes), then
# the candidate pass (17) inside the
# flat top-2K's select (3) in one launch (dense_select; kernel 3 alone at
# step 0) and kernel 8's epilogue; no proposal merge, no streaming pass.
# The tie order (exact_ties): the fast path with kernel 8 in its ties mode.
DENSE_STEP = ("dense_select", "row_topk", "log_softmax_min_len", "beam_select",
              "cross_attention_step", "self_attention_step", "reorder_cache")
PATH_KERNELS["generate_dense"] = ("fm_dense_mask", "fm_search") + DENSE_STEP
for _layout in WAVELET_LAYOUTS:
    PATH_KERNELS[f"generate_dense_{_layout}"] = ("wt_dense_mask", "wt_search") + DENSE_STEP
PATH_KERNELS["generate_ties"] = PATH_KERNELS["generate"] + ("beam_select_ties",)
PATH_KERNELS["batch_search_dense"] = ("fm_dense_mask", "fm_search", "fm_sequences",
                                      "rescore_logprob") + DENSE_STEP
# the decode modes: free generation runs no index kernel (kernel 3's
# top-256 and top-2K, kernel 8's token-table epilogue); speculative takes
# kernel 3's top-256, one membership query and the window a step, and
# kernel 8's keep_invalid mode on its wide route; forced BOS is the main path plus one decode step with
# no selection; the warper's masked log-softmax is one launch of kernel 3's
# select in its warper mode (topk_log_softmax) in place of kernel 4 (and of
# kernel 19's k-th value); locate is kernel 18 in both modes
ATTN_STEP = ("cross_attention_step", "self_attention_step", "reorder_cache")
FREE_STEP = ("row_topk", "log_softmax_min_len", "beam_select", "beam_select_free") + ATTN_STEP
PATH_KERNELS["generate_free"] = FREE_STEP
PATH_KERNELS["batch_search_free"] = FREE_STEP + ("rescore_logprob",)
SPEC_STEP = ("row_topk", "log_softmax_min_len", "beam_select", "beam_select_spec",
             "beam_select_wide") + ATTN_STEP
PATH_KERNELS["generate_spec"] = ("fm_search", "window_gather") + SPEC_STEP
for _layout in WAVELET_LAYOUTS:
    PATH_KERNELS[f"generate_spec_{_layout}"] = ("wt_search", "wt_window_gather") + SPEC_STEP
PATH_KERNELS["generate_bos"] = PATH_KERNELS["generate"]
PATH_KERNELS["generate_topk"] = tuple(k for k in PATH_KERNELS["generate"]
                                      if k != "log_softmax_min_len") + ("topk_log_softmax",)
PATH_KERNELS["locate"] = ("locate_rows", "doc_index_of")
# sampling and diverse groups: kernel 20 or 21 selects every step (step 0 on
# the V-wide rows); steps >= 1 take the proven loop's buffer (kernels 3, 1
# or 12, kernel 8's merge) and window through kernel 8's candidate mode
# (kernel 20 on candidate lists), or the dense route (15's
# or 16's mask mode, then 17's streaming pass under diverse groups, kernel
# 20's count-reading mode under sampling), or free generation's top-top_m (3)
LOOP_STEP = ("row_topk", "log_softmax_min_len", "beam_merge", "beam_candidates") + ATTN_STEP
# (kernel 21 on its list route every step >= 1 and on its wide route, 2
# launches, on the V-wide rows)
for _mode, _select, _dense in (
        ("sample", ("sample_select", "sample_select_list"), "sample_select_counts"),
        ("diverse", ("diverse_select", "diverse_select_wide"), "dense_scores")):
    PATH_KERNELS[f"generate_{_mode}"] = ("fm_search", "window_gather") + _select + LOOP_STEP
    for _layout in WAVELET_LAYOUTS:
        PATH_KERNELS[f"generate_{_mode}_{_layout}"] = (
            "wt_search", "wt_window_gather") + _select + LOOP_STEP
    PATH_KERNELS[f"generate_{_mode}_dense"] = ("fm_dense_mask", "fm_search", _dense,
                                               "log_softmax_min_len", _select[0]) + ATTN_STEP
PATH_KERNELS["generate_sample_seed1"] = PATH_KERNELS["generate_sample"]
# the sizes the card refused before its large routes (ROADMAP C.2): a
# sampling buffer of top_m 512 and a 20000-wide loop chunk, through kernel
# 8's large-n merge and kernel 3's global sort
PATH_KERNELS["generate_sample_large"] = PATH_KERNELS["generate_sample"] + (
    "beam_merge_large", "row_topk_global")
# the sizes the card refused before F1 and F2 (ROADMAP C): sampling's buffer
# at top_m 3000 under exact_ties and at 10000, through kernel 8's merge in
# device memory (and its candidate mode's table); a speculative round of
# top_m 20000, through the selection's table route
PATH_KERNELS["generate_sample_ties_3000"] = PATH_KERNELS["generate_sample"] + (
    "beam_merge_table",)
PATH_KERNELS["generate_sample_10000"] = PATH_KERNELS["generate_sample"] + ("beam_merge_table",)
PATH_KERNELS["generate_spec_20000"] = tuple(k for k in PATH_KERNELS["generate_spec"]
                                            if k != "beam_select_wide") + ("beam_select_table",)
PATH_KERNELS["generate_sample_free"] = ("row_topk", "log_softmax_min_len",
                                        "sample_select") + ATTN_STEP
PATH_KERNELS["generate_diverse_ties"] = PATH_KERNELS["generate_diverse"]
PATH_KERNELS["batch_search_diverse"] = ("fm_search", "window_gather", "fm_sequences",
                                        "rescore_logprob", "diverse_select",
                                        "diverse_select_wide") + LOOP_STEP
# T5: the same decode loop with kernel 10's relative-bias mode in place of
# BART's self-attention mode
T5_STEP = ("beam_merge", "beam_select", "cross_attention_step", "self_attention_step_t5",
           "reorder_cache")
PATH_KERNELS["generate_t5"] = ("fm_search", "window_gather", "row_topk",
                               "log_softmax_min_len", "cross_attention_step_f32") + T5_STEP
# (kernel 9 in f32 runs on its ffma route; the bf16 batch takes the mma route)
PATH_KERNELS["generate_t5_bf16"] = tuple(k for k in PATH_KERNELS["generate_t5"]
                                         if k != "cross_attention_step_f32")
PATH_KERNELS["generate_t5_force_full"] = PATH_KERNELS["generate_force_full"]
PATH_KERNELS["generate_t5_dense"] = (
    "fm_dense_mask", "fm_search", "dense_select", "row_topk", "log_softmax_min_len",
    "beam_select", "cross_attention_step", "self_attention_step_t5", "reorder_cache")
PATH_KERNELS["generate_t5_hybrid"] = ("wt_search", "wt_window_gather", "row_topk",
                                      "log_softmax_min_len") + T5_STEP
PATH_KERNELS["batch_search_t5"] = ("fm_search", "window_gather", "row_topk",
                                   "log_softmax_min_len", "fm_sequences",
                                   "rescore_logprob") + T5_STEP
# the corpus-sharded index on the card: the same decode loop through the
# shard modes of kernels 1, 2, 5, 6 and 15's mask mode (and none of the monolithic
# index kernels); kernel 1's shard step mode advances the ranges once a
# selecting step; beam 32 over the shards' union window through kernel 8's
# wide route.  The proven loop may prove a sharded step in round 0, so
# its bucket counts are held only where one shard repeats the monolithic
# run; the generate_mono* paths are those monolithic runs
SHARDED_STEP = ("fm_search_sharded", "window_gather_sharded", "row_topk",
                "log_softmax_min_len", "window_slab_sharded",
                "fm_search_advance_sharded") + DECODE_STEP
SHARDED_DENSE = ("fm_dense_mask_sharded", "fm_search_sharded",
                 "fm_search_advance_sharded") + DENSE_STEP
for _path in ("generate_sharded", "generate_sharded_once", "generate_sharded_s1"):
    PATH_KERNELS[_path] = SHARDED_STEP
for _path in ("generate_sharded_dense", "generate_sharded_s1_dense",
              "generate_sharded_beam32_dense"):
    PATH_KERNELS[_path] = SHARDED_DENSE
PATH_KERNELS["generate_sharded_force_full"] = ("beam_merge",)
PATH_KERNELS["generate_sharded_beam32_force_full"] = ("beam_merge",)
PATH_KERNELS["generate_sharded_s1_force_full"] = ("bucket_support_sharded", "pruned_topk",
                                                   "beam_merge",
                                                   "slab_gather_sharded")
PATH_KERNELS["generate_sharded_beam32"] = SHARDED_STEP + ("beam_select_wide",)
# (a searcher's key lengths leave every shard's interval inside the window
# after step 1, so no proposal round, and no merge, need run)
PATH_KERNELS["batch_search_sharded"] = ("fm_search_sharded", "window_gather_sharded", "row_topk",
                                        "log_softmax_min_len", "fm_sequences_sharded",
                                        "rescore_logprob", "beam_select", "cross_attention_step",
                                        "self_attention_step", "reorder_cache",
                                        "fm_search_advance_sharded")
for _path in ("generate_once", "generate_mono"):
    PATH_KERNELS[_path] = PATH_KERNELS["generate"]
PATH_KERNELS["generate_mono_force_full"] = PATH_KERNELS["generate_force_full"]
PATH_KERNELS["generate_mono_dense"] = PATH_KERNELS["generate_dense"]
# the train step: kernel 22's forward and backward and kernel 23's two
# modes, each once a step
TRAIN_STEP = ("label_smoothed_nll", "label_smoothed_nll_backward", "clip_global_norm",
              "adamw_update")
PATH_KERNELS["train"] = TRAIN_STEP


def psi_constrained(path: str) -> bool:
    """A decode path over the monolithic Psi index with the constraint on:
    kernel 1's step mode advances the ranges once a selecting step (the
    wavelet layouts take kernel 12's, the sharded index kernel 1's shard
    step mode; free generation keeps no ranges)."""
    return not any(x in path for x in ("sharded", "compact", "hybrid", "free"))


def sharded_constrained(path: str) -> bool:
    """A decode path over the sharded index: kernel 1's shard step mode
    advances the ranges once a selecting step, and its backward step
    (``ShardedIndexOps.extend``) never launches."""
    return "sharded" in path and "free" not in path


def wavelet_constrained(path: str) -> bool:
    """A decode path over a wavelet layout: kernel 12's step mode advances
    the ranges once a selecting step."""
    return any(x in path for x in WAVELET_LAYOUTS) and "free" not in path


def fused_window(path: str):
    """The window kernel's counters on a decode path whose selecting steps
    after step 0 take one launch of it: the window + slab mode where a beam
    needs a proposal round, the window mode alone where every beam is
    exempt; (every launch, the window + slab mode, the straggler rounds'
    slab mode) of kernel 2 on the Psi index or the shards, of kernel 13 on
    the wavelet layouts.  None where the step takes no round 0 slab (speculative, ``exact_mask``,
    free generation)."""
    if any(x in path for x in ("spec", "dense", "free")):
        return None
    if "sharded" in path:
        return "window_gather_sharded", "window_slab_sharded", "slab_gather_sharded"
    if any(x in path for x in WAVELET_LAYOUTS):
        return "wt_window_gather", "wt_window_slab", "wt_slab_gather"
    return "window_gather", "window_slab", "slab_gather"


# kernels kept as entry points that no driven path launches, held against
# their plain versions by their phases: kernel 19's k-th value (the warper
# computes it inside topk_log_softmax since that launch replaced kernel 19
# and kernel 4's threshold mode), and kernels 15 and 16's counts modes (the
# exact counts of ops.dense_counts; every exact_mask path reads their mask
# modes)
COUNTS_MODES = ("fm_dense_counts", "wt_dense_counts", "fm_dense_counts_sharded")
# and kernels 6 and 14's counts modes (the exact counts of ops.bucket_counts;
# the straggler rounds read their support modes)
BUCKET_COUNTS_MODES = ("bucket_counts", "wt_bucket_counts", "bucket_counts_sharded")
# and kernel 8's block and large-n selection routes (the wide route takes
# every shape of theirs on the paths; no path launches them)
PARENT_SELECT_ROUTES = ("beam_select_block", "beam_select_large")
# and kernel 1's backward step over the shards (ShardedIndexOps.extend: the
# decode's range update is the shard step mode)
ENTRY_POINTS_ONLY = ("row_kth", "fm_search_step_sharded") + COUNTS_MODES + \
    BUCKET_COUNTS_MODES + PARENT_SELECT_ROUTES


def dense_mask_of(path: str) -> str:
    """The mask mode that an exact_mask path launches once a step after
    step 0: kernel 15's over the shards, kernel 16's on a wavelet layout,
    else kernel 15's."""
    if "sharded" in path:
        return "fm_dense_mask_sharded"
    return "wt_dense_mask" if any(x in path for x in WAVELET_LAYOUTS) else "fm_dense_mask"



# the calls of each ShardedIndexOps method that a shard mode serves
SHARD_OPS = ("extend", "contains", "validate", "window_gather", "window_slab", "slab",
             "range_for", "bucket_counts", "dense_counts", "dense_mask", "advance")
# the selection kernel of each path whose selection is not kernel 8's
SELECTS = {path: ("sample_select" if "sample" in path else "diverse_select")
           for path in PATH_KERNELS if "sample" in path or "diverse" in path}
# the searchers' documents on the wavelet layouts against the Psi
# searcher's: the same computation but for the index arithmetic
LAYOUT_SEARCH_RTOL = 1e-6
# kernel 4 sums a 50265-wide row in another order than torch: f32 rounding
# of a log-sum-exp near 11 is ~1e-6; 1e-4 leaves room for the sum order
LOGSOFTMAX_ATOL = 1e-4
# kernel 7 sums <= 16 log-probs per key, each off by f32 rounding of a
# 50265-wide log-sum-exp (~1e-6): 1e-4 per key leaves room for the order
RESCORE_ATOL = 1e-4
# the tiny searcher on the card against its CPU path (same f32 weights):
# doc scores are sums of log-odds of f32 log-probs
SEARCH_RTOL = 1e-4
# the bf16 LM head must return its f32 accumulator: against the f32 matmul it
# is off by ~1e-5 (summation order), while rounding the output to bf16 (logits
# up to ~3.5 here) would cost up to ~8e-3
LM_HEAD_ATOL = 1e-4
# kernels 9/10 against their plain versions: bf16 outputs within one output
# ulp plus one bf16 step of each probability (f32 sums in another order can
# round a probability the other way; decode_attention.bf16_error_ratio <= 1),
# f32 outputs within f32 rounding of sums of <= 14 terms
ATTN_F32_ATOL = 1e-5
# kernel 20 against its plain version: the Philox words are equal; logf
# and torch's log may round a Gumbel value apart by a few ulps of max(|g|, 1)
# (CUDA's logf is within 1 ulp; near g = 0 the outer log of a value near 1
# keeps an absolute, not a relative, error), so a draw is compared where its
# best two perturbed scores differ by more than 4e-5
SAMPLE_ULPS = 8
SAMPLE_MARGIN = 4e-5
# the card's peaks for the bound column (H100 SXM data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12  # dense tensor-core rate

FAILURES: list[str] = []
CARD = "unknown"  # nvidia-smi's name and power limit, beside every kernel line


def fail(msg: str) -> None:
    FAILURES.append(msg)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, launches: int = 20, replays: int = 10) -> float:
    """Device time of one call of ``fn``: ``launches`` calls captured in one
    CUDA graph, replayed ``replays`` times, timed with CUDA events (no host
    launch cost in the loop)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def graph_result(torch, fn):
    """``fn()``'s result from a replay of a CUDA graph that captured it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return out


def kernels_per_call(torch, fn) -> int:
    """CUDA kernels one call of ``fn`` launches: the kernel nodes of a CUDA
    graph that captured the call, counted through libcuda (cuGraphGetNodes,
    cuGraphNodeGetType; copies and memsets are other node types).  A
    profiler trace of one short call can lose its kernels' records."""
    import ctypes

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(raw, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)):
            raise RuntimeError("cuGraphNodeGetType failed")
        kinds.append(kind.value)
    return sum(k == 0 for k in kinds)  # CU_GRAPH_NODE_TYPE_KERNEL


def log_kernel(row) -> None:
    """One kernel line, with its bound (the least time the card could take:
    the bytes it must move at the HBM rate, or its flops at the f32 rate --
    or at ``flops_rate``, the tensor cores' for a route on them --
    whichever is larger)."""
    byte_ms = row["bytes"] / HBM_BYTES_PER_S * 1e3
    flop_ms = row.get("flops", 0) / row.get("flops_rate", F32_FLOPS) * 1e3
    row["bound_ms"] = max(byte_ms, flop_ms)
    row["bound_by"] = "bytes" if byte_ms >= flop_ms else "operations"
    lib = f", library {row['library_ms']:.4f} ms" if row["library_ms"] is not None else ""
    log(f"kernel {row['name']} ({CARD}): {row['ms']:.4f} ms vs plain {row['plain_ms']:.4f} ms"
        f"{lib}, "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}, {row['bytes']} B) at {row['shape']}, "
        f"max err {row['max_abs_err']}"
        + "".join(f", {k} {row[k]}" for k in ("tol_ratio", "f32_max_abs_err", "step0_ms",
                                               "step0_plain_ms", "long_ms", "long_plain_ms",
                                               "psi_ms", "sequences_ms", "sequences_psi_ms",
                                               "hybrid_ms", "hybrid_plain_ms", "rank_route_ms",
                                               "histogram_route_ms",
                                               "topk_dense_ms", "topk_dense_plain_ms",
                                               "default_ms", "merge_ms", "merge_plain_ms",
                                               "merge_default_ms", "k64_ms", "row_topk_k64_ms",
                                               "library_k64_ms", "narrow_ms", "narrow_plain_ms",
                                               "ulps", "chi_square_p", "ties_ms", "wide_ms",
                                               "wide_plain_ms", "sample_ms", "spec_ms",
                                               "bf16_ms", "bf16_plain_ms", "cross_ms",
                                               "cross_plain_ms", "cross_tol_ratio",
                                               "cross_f32_ms", "cross_f32_plain_ms",
                                               "cross_f32_tol_ratio", "f32_tol_ratio",
                                               "extend_ms", "ranges_ms", "spec_plain_ms",
                                               "graph_ms", "library_graph_ms", "route",
                                               "chunked_ms", "chunked_graph_ms", "nopen_ms",
                                               "kernels_per_call", "proof_failures", "walk_ms",
                                               "hybrid_walk_ms", "hybrid_graph_ms",
                                               "step0_graph_ms", "long_library_ms",
                                               "long_graph_ms", "long_library_graph_ms",
                                               "long_bound_ms", "long_tol_ratio",
                                               "bf16_graph_ms", "loop_chunk_ms",
                                               "loop_chunk_plain_ms", "group_graph_ms",
                                               "composed_ms", "composed_graph_ms", "block_ms",
                                               "block_graph_ms", "beam32_ms", "cand_ms",
                                               "n_buf_3000_ms", "cluster_ms", "cluster_graph_ms",
                                               "hybrid_composed_graph_ms", "hybrid_bound_ms",
                                               "ranges_graph_ms", "count_filter_shape",
                                               "count_filter_plan", "count_filter_ms",
                                               "count_filter_graph_ms",
                                               "count_filter_ranges_graph_ms",
                                               "count_filter_group_graph_ms",
                                               "mono_count_filter_ms",
                                               "mono_count_filter_graph_ms",
                                               "count_filter_bound_ms",
                                               "ranges_group_graph_ms", "counts_ms",
                                               "counts_graph_ms", "row_topk_graph_ms",
                                               "large_k_graph_ms", "round_graph_ms",
                                               "ties_graph_ms", "beam32_graph_ms",
                                               "beam32_ties_graph_ms", "large_graph_ms",
                                               "beam32_bound_ms", "sample_graph_ms",
                                               "spec_graph_ms", "counts_group_graph_ms",
                                               "limit_graph_ms", "searcher_contains_shape",
                                               "searcher_contains_graph_ms",
                                               "searcher_advance_shape",
                                               "searcher_advance_graph_ms", "fwd_bwd_ms",
                                               "library_abs_err", "lse_abs_err")
                  if k in row))


def kernel_phases(np, torch, host, index, V, B, K):
    """Each kernel against its plain version at main-path shapes."""
    from seal_tpu_torch.kernels import fm_search as k1
    from seal_tpu_torch.kernels import row_topk as k3
    from seal_tpu_torch.kernels import triton_logsoftmax as k4
    from seal_tpu_torch.kernels import window_gather as k2

    dev = index.device
    g = torch.Generator(device=dev).manual_seed(1)
    rng = np.random.default_rng(1)
    N = index.n_rows
    table = []

    # ranges like a decode's: one- and two-token prefixes of corpus text,
    # plus the full range, empty ranges and ranges at the end
    corpus_toks = torch.as_tensor(rng.choice(host.text[:-1] - 1, size=(2, B, K)), device=dev)
    full_lo, full_hi = index.full_range((B, K))
    lo1, hi1 = k1.backward_step_plain(index, corpus_toks[0].int(), full_lo, full_hi)
    lo2, hi2 = k1.backward_step_plain(index, corpus_toks[1].int(), lo1, hi1)
    lo = torch.where(torch.arange(K, device=dev) % 2 == 0, lo1, lo2)
    hi = torch.where(torch.arange(K, device=dev) % 2 == 0, hi1, hi2)
    lo[0, 0], hi[0, 0] = 0, N
    lo[0, 1], hi[0, 1] = 5, 5
    lo[0, 2], hi[0, 2] = N, N

    # kernel 1: backward step [B, K] and membership [B, K, 65]
    ext = torch.randint(-1, V + 2, (B, K), generator=g, device=dev, dtype=torch.int32)
    got = k1.fm_search(index, "backward_step", ext, lo, hi)
    want = k1.backward_step_plain(index, ext, lo, hi)
    err1 = max(int((a - b).abs().max()) for a, b in zip(got, want))
    cand = torch.randint(0, V, (B, K, 65), generator=g, device=dev, dtype=torch.int32)
    cand[..., :32] = corpus_toks[0, :, :, None].int()  # likely members
    cand[..., -1] = 2
    got_c = k1.fm_search(index, "contains", cand, lo, hi)
    want_c = k1.contains_plain(index, cand, lo, hi)
    err1 = max(err1, int((got_c != want_c).sum()))
    # the cooperative search at every group size, each timed
    group_ms = {}
    for G in k1.GROUPS:
        err1 = max(err1, int((k1.fm_search(index, "contains", cand, lo, hi, group=G)
                              != want_c).sum()))
        err1 = max(err1, max(int((a - b).abs().max()) for a, b in zip(
            k1.fm_search(index, "backward_step", ext, lo, hi, group=G), want)))
        group_ms[G] = graph_ms(lambda G=G: k1.fm_search(index, "contains", cand, lo, hi,
                                                        group=G))
    if err1:
        fail(f"fm_search differs from its plain version (max err {err1})")
    table.append(dict(
        name="fm_search", max_abs_err=err1,
        ms=time_ms(lambda: k1.fm_search(index, "contains", cand, lo, hi)),
        graph_ms=graph_ms(lambda: k1.fm_search(index, "contains", cand, lo, hi)),
        plain_ms=time_ms(lambda: k1.contains_plain(index, cand, lo, hi)),
        group_graph_ms=group_ms,
        shape=f"contains [{B},{K},65] (group {k1.GROUP}; group_graph_ms: each group size, "
              "graph-replayed); "
              f"backward_step [{B},{K}]",
        members=int(want_c.sum()), library_ms=None,
        # tokens, membership, ranges, and one dependent psi read per search
        # step (search_iters bounds the chain) plus the symbol's directory row
        bytes=cand.numel() * (4 + 1 + 16 + 4 * index.search_iters) + 8 * B * K,
    ))

    # kernel 1's step mode: the range update after a selection, at step 0
    # (no stop rule) and later (finished parents, EOS and PAD selections),
    # against its plain version and the composition it replaces
    from seal_tpu_torch.ops import _generic

    sel_tok = ext.clone()
    sel_tok[0, :2] = torch.tensor([2, 1], device=dev)
    sel_par = torch.randint(0, K, (B, K), generator=g, device=dev, dtype=torch.int32)
    fin = torch.rand(B, K, generator=g, device=dev) < 0.2
    errA = 0
    for sp, f in ((torch.zeros_like(sel_par), None), (sel_par, fin)):
        got = k1.fm_advance(index, sel_tok, sp, lo, hi, f, eos=2, pad=1)
        want_a = k1.advance_plain(index, sel_tok, sp, lo, hi, f, eos=2, pad=1)
        errA += sum(int((a != b).sum()) for a, b in zip(got, want_a))
    if errA:
        fail(f"fm_search_advance differs from its plain version ({errA} elements)")
    adv = lambda: k1.fm_advance(index, sel_tok, sel_par, lo, hi, fin, eos=2, pad=1)  # noqa: E731

    def composed():  # the update as the decode step wrote it before the step mode
        return _generic.advance_ranges(
            lambda t, a, b: k1.fm_search(index, "backward_step", t, a, b), lambda a, b: b - a,
            sel_tok, sel_par, lo, hi, fin, eos=2, pad=1)

    table.append(dict(
        name="fm_search_advance", max_abs_err=errA, library_ms=None,
        ms=time_ms(adv), graph_ms=graph_ms(adv),
        plain_ms=time_ms(lambda: k1.advance_plain(index, sel_tok, sel_par, lo, hi, fin, eos=2,
                                                   pad=1)),
        composed_ms=time_ms(composed), composed_graph_ms=graph_ms(composed),
        shape=f"[{B},{K}] selections over [{B},{K}] parents (composed_ms: range_size, the "
              "gathers, kernel 1's backward step and the stop rule as separate launches)",
        # the parents' ranges and flags, the selections, three outputs, and
        # both bounds' psi chains and directory rows
        bytes=B * K * (8 + 1 + 8 + 12) + 2 * B * K * (4 * index.search_iters + 16),
    ))

    # kernel 2: window [B*K rows, w=32, fill pad] and a slab (w=64, fill 0)
    lp = torch.log_softmax(torch.randn(B * K, V, generator=g, device=dev), -1)
    err2 = 0.0
    for w, fill in ((32, 1), (64, 0)):
        got = k2.window_gather(index, lo, hi, w, lp, fill)
        want = k2.window_gather_plain(index, lo, hi, w, lp, fill)
        err2 = max(err2, float((got[0] - want[0]).abs().max()),
                   float((got[1] != want[1]).sum()), float((got[2] - want[2]).abs().max()))
    if err2:
        fail(f"window_gather differs from its plain version (max err {err2})")
    table.append(dict(
        name="window_gather", max_abs_err=err2,
        ms=time_ms(lambda: k2.window_gather(index, lo, hi, 32, lp, 1)),
        graph_ms=graph_ms(lambda: k2.window_gather(index, lo, hi, 32, lp, 1)),
        plain_ms=time_ms(lambda: k2.window_gather_plain(index, lo, hi, 32, lp, 1)),
        shape=f"[{B * K}, w=32] over lp [{B * K},{V}]", library_ms=None,
        bytes=window_bytes(torch, lo, hi, 32, 0, 0,
                           k2.window_gather_plain(index, lo, hi, 32, lp, 1)[:1]),
    ))
    table += window_slab_rows(torch, k2, index, lo, hi, lp, "", B, K, V)

    # kernel 3: every top-k of the path; values rounded so ties abound
    lpq = torch.round(lp * 8) / 8
    lpq[3] = float("-inf")
    lpq[5, :4000] = 7.5
    err3 = 0.0
    for x, k in ((lpq, 64), (lpq, 256), (lpq[:B], 2 * K),
                 (torch.round(torch.randn(B, K * 64, generator=g, device=dev) * 4) / 4, 2 * K),
                 (torch.round(torch.randn(B * K, 158, generator=g, device=dev) * 4) / 4, 2 * K)):
        gv, gi = k3.row_topk(x, k)
        wv, wi = k3.row_topk_plain(x, k)
        if not (torch.equal(gi, wi) and torch.equal(gv, wv)):
            err3 = max(err3, float((gi != wi).sum()), 1.0)
    if err3:
        fail(f"row_topk differs from its plain version ({err3} index mismatches)")
    sites = row_topk_sites(torch, k3, lp, lpq, B, K, V, g)
    table.append(dict(
        name="row_topk", max_abs_err=err3,
        ms=time_ms(lambda: k3.row_topk(lp, 64)),
        plain_ms=time_ms(lambda: k3.row_topk_plain(lp, 64)),
        shape=f"[{B * K},{V}] k=64", bytes=lp.numel() * 4 + B * K * 64 * 12,
        library_ms=time_ms(lambda: torch.topk(lp, 64)), sites=sites,
    ))

    # kernel 4: log-softmax with the EOS ban over f32 logits
    logits = torch.randn(B * K, V, generator=g, device=dev) * 3
    logits[:, 1] = float("-inf")
    got = k4.log_softmax_ban(logits, 2, -1.7e38)
    want = k4.log_softmax_ban_plain(logits, 2, -1.7e38)
    fin = torch.isfinite(want)
    err4 = float((got[fin] - want[fin]).abs().max())
    if err4 > LOGSOFTMAX_ATOL or not torch.equal(torch.isfinite(got), fin):
        fail(f"log_softmax_min_len differs from its plain version (max err {err4})")
    table.append(dict(
        name="log_softmax_min_len", max_abs_err=err4, atol=LOGSOFTMAX_ATOL,
        ms=time_ms(lambda: k4.log_softmax_ban(logits, 2, -1.7e38)),
        plain_ms=time_ms(lambda: k4.log_softmax_ban_plain(logits, 2, -1.7e38)),
        shape=f"[{B * K},{V}]", bytes=2 * logits.numel() * 4, flops=4 * logits.numel(),
        library_ms=time_ms(lambda: torch.log_softmax(logits, -1)),
    ))
    torch.cuda.synchronize()
    return table


def window_row_keys(torch, lo, hi, w: int, width: int, rows_prev: int):
    """The rows a window (w slots) and a slab (width slots past rows_prev)
    of ranges lo/hi read, as keys range * span + row (a row both read is
    one key), and span."""
    l, h = lo.reshape(-1).long(), hi.reshape(-1).long()
    q = torch.arange(l.numel(), device=l.device)[:, None]
    span = int(h.max()) + 1
    keys = []
    if w:
        stride = ((h - l).clamp(min=0) // w).clamp(min=1)[:, None]
        r = l[:, None] + torch.arange(w, device=l.device) * stride
        keys.append((q * span + r)[r < h[:, None]])
    if width:
        s_lo = torch.minimum(l + rows_prev, h)[:, None]
        r = s_lo + torch.arange(width, device=l.device)
        keys.append((q * span + r)[r < torch.minimum(s_lo + width, h[:, None])])
    return torch.unique(torch.cat(keys)), span


def window_bytes(torch, lo, hi, w: int, width: int, rows_prev: int, toks,
                 row_bytes: float = 4) -> int:
    """Bytes kernel 2 (or 13) must move for ranges lo/hi (a leading shard
    axis included): each range's bounds; each distinct BWT row its window
    and slab read (a row both read counts once) at ``row_bytes`` (0: the
    caller counts the index's bytes itself); each distinct lp element, a
    (range, token) pair among the output tokens ``toks`` (the window's and
    the slab's, [..., slots]: a fill token is one address a range, a token
    two slots hold is read once); and 9 output bytes a slot."""
    l = lo.reshape(-1)
    rows = int(window_row_keys(torch, lo, hi, w, width, rows_prev)[0].numel()) * row_bytes / 4
    vocab = max(int(t.max()) for t in toks) + 1
    n_lp = int(torch.unique(torch.cat([
        (torch.arange(t[..., 0].numel(), device=t.device)[:, None] * vocab
         + t.reshape(t[..., 0].numel(), -1).long()).reshape(-1) for t in toks])).numel())
    return int(l.numel() * (8 + (w + width) * 9) + 4 * rows + 4 * n_lp)


def wt_window_slab_rows(torch, k12, k13, layouts, lo, hi, lp, B, K, V):
    """Kernel 13's window + slab mode (w 32, round 0's width 64; beam 32's
    window of 128; a narrow step) and slab mode (a straggler round: rows 64
    to 320) on the compact and hybrid layouts against their plain versions,
    exactly; each timed eager and graph-replayed beside the parent's
    launches (two window-mode calls and the bounds' eager ops, or the bounds
    and one call).  The bound: the ranges, outputs and lp bytes of
    ``window_bytes``, and the index bytes the rows' symbols need (the
    compact layout's descents' distinct sectors; the hybrid's 2-byte rows)."""
    from seal_tpu_torch.kernels.window_gather import slab_bounds

    err = 0
    for ix in layouts.values():
        for w, width in ((32, 64), (128, 64), (4, 8)):
            got = k13.wt_window_slab(ix, lo, hi, w, width, lp, 1)
            want = k13.wt_window_slab_plain(ix, lo, hi, w, width, lp, 1)
            err += sum(int((a != b).sum()) for a, b in zip(got, want)) + (len(got) != 6)
        for rows_prev, width in ((64, 256), (0, 64), (320, 1024)):
            got = k13.wt_slab_gather(ix, lo, hi, rows_prev, width, lp)
            want = k13.wt_slab_gather_plain(ix, lo, hi, rows_prev, width, lp)
            err += sum(int((a != b).sum()) for a, b in zip(got, want))
        for got, want in ((graph_result(torch, lambda: k13.wt_window_slab(ix, lo, hi, 32, 64, lp,
                                                                          1)),
                           k13.wt_window_slab_plain(ix, lo, hi, 32, 64, lp, 1)),
                          (graph_result(torch, lambda: k13.wt_slab_gather(ix, lo, hi, 64, 256,
                                                                          lp)),
                           k13.wt_slab_gather_plain(ix, lo, hi, 64, 256, lp))):
            err += sum(int((a != b).sum()) for a, b in zip(got, want))
    if err:
        fail(f"wt_window_slab / wt_slab_gather differ from their plain versions ({err} elements)")
    compact, hybrid = layouts["compact"], layouts["hybrid"]

    def index_bytes(w, width, rows_prev):
        keys, span = window_row_keys(torch, lo, hi, w, width, rows_prev)
        rows = torch.unique(keys % span)
        trace = []
        k12.access_plain(compact, rows.int(), trace=trace)
        return touched_bytes(torch, trace), 2 * int(rows.numel())

    def two_calls(ix):  # the step's gathers as the parent launched them
        k13.wt_window_gather(ix, lo, hi, 32, lp, 1)
        return k13.wt_window_gather(ix, *slab_bounds(lo, hi, 0, 64), 64, lp, 0)

    def straggler_calls(ix):
        return k13.wt_window_gather(ix, *slab_bounds(lo, hi, 64, 256), 256, lp, 0)

    rows = []
    for name, fn, parent, w, width, rows_prev, what in (
            ("wt_window_slab", lambda ix: k13.wt_window_slab(ix, lo, hi, 32, 64, lp, 1),
             two_calls, 32, 64, 0, "window w=32 and round 0's slab width=64 in one launch"),
            ("wt_slab_gather", lambda ix: k13.wt_slab_gather(ix, lo, hi, 64, 256, lp),
             straggler_calls, 0, 256, 64, "a straggler round's slab, rows 64 to 320")):
        plain = (k13.wt_window_slab_plain if width == 64 else k13.wt_slab_gather_plain)
        plain_args = (32, 64, lp, 1) if width == 64 else (64, 256, lp)
        compact_bytes, hybrid_bytes = index_bytes(w, width, rows_prev)
        out = fn(compact)
        toks = [out[0], out[3]] if w else [out[0]]
        rows.append(dict(
            name=name, max_abs_err=err, library_ms=None,
            ms=time_ms(lambda: fn(compact)), graph_ms=graph_ms(lambda: fn(compact)),
            plain_ms=time_ms(lambda: plain(compact, lo, hi, *plain_args)),
            composed_ms=time_ms(lambda: parent(compact)),
            composed_graph_ms=graph_ms(lambda: parent(compact)),
            hybrid_ms=time_ms(lambda: fn(hybrid)), hybrid_graph_ms=graph_ms(lambda: fn(hybrid)),
            hybrid_composed_graph_ms=graph_ms(lambda: parent(hybrid)),
            hybrid_bound_ms=(window_bytes(torch, lo, hi, w, width, rows_prev, toks, 0)
                             + hybrid_bytes) / HBM_BYTES_PER_S * 1e3,
            shape=f"[{B},{K}] ranges over lp [{B * K},{V}], compact ({compact.digits} levels a "
                  f"slot; hybrid_*: the hybrid layout): {what} (composed_*: the parent's "
                  "launches, kernel 13's window mode and the bounds' eager ops)",
            bytes=window_bytes(torch, lo, hi, w, width, rows_prev, toks, 0) + compact_bytes,
            index_bytes=compact_bytes,
        ))
    return rows


def window_slab_rows(torch, k2, ix, lo, hi, lp, shard: str, B, K, V):
    """Kernel 2's window + slab mode (w 32, round 0's width 64; and beam
    32's window of 128) and slab mode (a straggler round: rows 64 to 320)
    against their plain versions, exactly, each timed eager and
    graph-replayed beside the separate calls it replaced (the window, the
    bounds' eager ops, the slab).  ``shard``: "" for one index, "_sharded"
    for the shard mode over ``ix``, a ``ShardedTorchIndex``."""
    fused = getattr(k2, f"window_slab{shard}")
    slab = getattr(k2, f"slab_gather{shard}")
    window = getattr(k2, f"window_gather{shard}")
    err = 0
    for w, width in ((32, 64), (128, 64), (4, 8)):
        got = fused(ix, lo, hi, w, width, lp, 1)
        want = getattr(k2, f"window_slab{shard}_plain")(ix, lo, hi, w, width, lp, 1)
        err += sum(int((a != b).sum()) for a, b in zip(got, want)) + (len(got) != 6)
    for rows_prev, width in ((64, 256), (0, 64), (320, 1024)):
        got = slab(ix, lo, hi, rows_prev, width, lp)
        want = getattr(k2, f"slab_gather{shard}_plain")(ix, lo, hi, rows_prev, width, lp)
        err += sum(int((a != b).sum()) for a, b in zip(got, want))
    if err:
        fail(f"window_slab{shard} / slab_gather{shard} differ from their plain versions "
             f"({err} elements)")

    def two_calls():  # the step's two gathers as constrained.py made them before
        window(ix, lo, hi, 32, lp, 1)
        s_lo = torch.minimum(lo + 0, hi)
        return window(ix, s_lo, torch.minimum(s_lo + 64, hi), 64, lp, 0)

    def straggler_calls():
        s_lo = torch.minimum(lo + 64, hi)
        return window(ix, s_lo, torch.minimum(s_lo + 256, hi), 256, lp, 0)

    step = lambda: fused(ix, lo, hi, 32, 64, lp, 1)  # noqa: E731
    round_ = lambda: slab(ix, lo, hi, 64, 256, lp)  # noqa: E731
    where = f"[{B},{K}] ranges{' x ' + str(ix.n_shards) + ' shards' if shard else ''}"
    return [dict(
        name=f"window_slab{shard}", max_abs_err=err, library_ms=None,
        ms=time_ms(step), graph_ms=graph_ms(step),
        plain_ms=time_ms(lambda: getattr(k2, f"window_slab{shard}_plain")(
            ix, lo, hi, 32, 64, lp, 1)),
        composed_ms=time_ms(two_calls), composed_graph_ms=graph_ms(two_calls),
        shape=f"{where}: window w=32 and round 0's slab width=64 over lp [{B * K},{V}] in one "
              "launch (composed_ms: the window, the bounds, the slab as separate launches)",
        bytes=window_bytes(torch, lo, hi, 32, 64, 0, step()[0::3]),
    ), dict(
        name=f"slab_gather{shard}", max_abs_err=err, library_ms=None,
        ms=time_ms(round_), graph_ms=graph_ms(round_),
        plain_ms=time_ms(lambda: getattr(k2, f"slab_gather{shard}_plain")(
            ix, lo, hi, 64, 256, lp)),
        composed_ms=time_ms(straggler_calls), composed_graph_ms=graph_ms(straggler_calls),
        shape=f"{where}: a straggler round's slab, rows 64 to 320 (composed_ms: the bounds' "
              "eager ops, then the window mode)",
        bytes=window_bytes(torch, lo, hi, 0, 256, 64, round_()[:1]),
    )]


def row_topk_sites(torch, k3, lp, lpq, B, K, V, g):
    """Kernel 3 at every call site's shape (``decoding/constrained.py``):
    the proven loop's rounds on [B*K, V] log-probs at k = 64 and 256
    (sampling: 512, 2048), step 0's [B, V] scores at 2K, the dense mode's
    [B, K*V] rows at 2K and free generation's [B, K*256] rows at 2K; each
    bit-equal to the plain version (also on the tied rows ``lpq``), timed
    beside ``torch.topk`` at the same k and its bound (one read of the rows,
    the k values and indices written), eager (host launch cost included:
    it dominates the small calls) and graph-replayed (device time)."""
    from seal_tpu_torch.decoding.constrained import NEG_INF

    bs = torch.round(torch.randn(B, K, generator=g, device=lp.device) * 2) / 2 - 3
    step0 = lp[:B] + bs[:, :1]
    dense = torch.full((B, K * V), NEG_INF, device=lp.device)
    allowed = torch.rand(B, K * V, generator=g, device=lp.device) < 0.02
    scores = (lp[: B * K].reshape(B, K, V) + bs[..., None]).reshape(B, K * V)
    dense = torch.where(allowed, scores, dense)
    free = (torch.topk(lp[: B * K], 256).values.reshape(B, K, 256) + bs[..., None]).reshape(B, -1)
    rows = [("round 0", lp, 64), ("later rounds; the modes' top_m", lp, 256),
            ("sampling round 0", lp, 512),
            ("sampling later rounds", lp, 2048), ("step 0", step0, 2 * K),
            ("dense", dense, 2 * K), ("free", free, 2 * K)]
    out, cells, bad = [], [], 0
    for label, x, k in rows:
        for xx in ((x, lpq) if x is lp else (x,)):
            gv, gi = k3.row_topk(xx, k)
            wv, wi = k3.row_topk_plain(xx, k)
            if not (torch.equal(gi, wi) and torch.equal(gv.view(torch.int32), wv.view(torch.int32))):
                bad += 1
        r, n = x.shape
        row = dict(site=label, shape=f"[{r},{n}]", k=k, plan=k3.plan(r, n, k).splits,
                   ms=time_ms(lambda: k3.row_topk(x, k)),
                   library_ms=time_ms(lambda: torch.topk(x, k)),
                   graph_ms=graph_ms(lambda: k3.row_topk(x, k)),
                   library_graph_ms=graph_ms(lambda: torch.topk(x, k)),
                   bound_ms=(x.numel() * 4 + r * k * 12) / HBM_BYTES_PER_S * 1e3)
        out.append(row)
        cells.append(f"{label} [{r},{n}] k={k} ({row['plan']} CTAs a row) {row['ms']:.4f} ms "
                     f"(graph {row['graph_ms']:.4f}), torch.topk {row['library_ms']:.4f} (graph "
                     f"{row['library_graph_ms']:.4f}), bound {row['bound_ms']:.4f}")
    if bad:
        fail(f"row_topk differs from its plain version at {bad} call-site shapes")
    k64 = out[0]["ms"]
    log(f"row_topk sites ({CARD}): " + "; ".join(cells) + f"; bit-equal to the plain version: "
        f"{not bad}; k=2048 / k=64 time {out[3]['ms'] / k64:.2f}x")
    return out


def mismatches(torch, got, want) -> int:
    """Elements that differ; floats compared bit for bit."""
    n = 0
    for a, b in zip(got, want):
        if a is None and b is None:
            continue
        if a.is_floating_point():
            a, b = a.view(torch.int32 if a.element_size() == 4 else torch.int16), b.view(
                torch.int32 if b.element_size() == 4 else torch.int16)
        n += int((a != b).sum())
    return n


def decode_kernel_phases(np, torch, cfg, V, B, K, window, enc_len, key_len, device="cuda"):
    """Kernels 8-11 against their plain versions at the generation path's
    shapes, each beside its library yardstick where one PyTorch call
    computes the same function."""
    import torch.nn.functional as F

    from seal_tpu_torch.kernels import beam_select as k8
    from seal_tpu_torch.kernels import decode_attention as k910
    from seal_tpu_torch.kernels import reorder_cache as k11
    from seal_tpu_torch.kernels.row_topk import row_topk

    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(3)
    i32, f32 = torch.int32, torch.float32
    table = []
    n_buf = 2 * K
    rows = B * K
    lp = torch.log_softmax(torch.randn(rows, V, generator=g, device=dev) * 2, -1)
    lp = torch.round(lp * 4) / 4  # ties
    lp[:, 5] = 0.0
    lp[::2, 6] = -0.0
    lp[::3, cfg.pad_token_id] = float("-inf")

    def rint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev, dtype=i32)

    def rbool(p, shape):
        return torch.rand(shape, generator=g, device=dev) < p

    def take(tok):  # the log-probs of [B, K, n] tokens
        return torch.gather(lp, 1, tok.reshape(rows, -1).long()).reshape(tok.shape)

    # kernel 8, merge: round 0 [B, K, 30 + 64 + 64] (empty buffer, strided
    # membership view) and a loop round [B, K, 30 + 256 + 256]
    err8m = 0
    timed = None
    for n_top, with_buf in ((64, False), (256, True)):
        top_lp, top_idx = row_topk(lp, n_top)
        top_tok = top_idx.to(i32).reshape(B, K, n_top)
        top_lp = top_lp.reshape(B, K, n_top)
        ok = rbool(0.5, (B, K, n_top + 1))[..., :n_top]
        slab_tok = rint(0, 300, (B, K, n_top))  # repeats tokens and the LM top
        slab_lp, slab_ok = take(slab_tok), rbool(0.8, (B, K, n_top))
        buf = None
        if with_buf:
            btok = rint(0, 300, (B, K, n_buf))
            buf = (btok, take(btok), rbool(0.7, (B, K, n_buf)))
        args = (buf, top_tok, top_lp, ok, slab_tok, slab_lp, slab_ok, V, n_buf)
        err8m += mismatches(torch, k8.beam_merge(*args), k8.beam_merge_plain(*args))
        nbytes = sum(t.numel() * t.element_size() for t in (top_tok, top_lp, slab_tok, slab_lp))
        nbytes += (ok.numel() + slab_ok.numel()) + (0 if buf is None else 9 * B * K * n_buf)
        nbytes += 9 * B * K * n_buf  # outputs
        timed = timed or dict(
            name="beam_merge", ms=time_ms(lambda: k8.beam_merge(*args)),
            plain_ms=time_ms(lambda: k8.beam_merge_plain(*args)), bytes=nbytes,
            shape=f"[{B},{K},{n_buf}+{n_top}+{n_top}] (round 0); the loop round also checked",
        )
    if err8m:
        fail(f"beam_merge differs from its plain version ({err8m} elements)")
    table.append(dict(timed, max_abs_err=err8m, library_ms=None))

    # kernel 8, select: [B, K, 30 + 32 + 2] with the soundness test, and
    # step 0's epilogue after kernel 3 on [B, 1, V]
    btok = rint(0, 400, (B, K, n_buf))
    buf = (btok, take(btok), rbool(0.7, (B, K, n_buf)))
    win_valid = rbool(0.7, (B, K, window))
    win_tok = torch.where(win_valid, rint(0, 400, (B, K, window)), cfg.pad_token_id)
    eos_ok = rbool(0.5, (B, K, 2))[..., 1:]
    prev_count = rint(0, 50, (B, K))
    finished = rbool(0.1, (B, K))
    bs = torch.round(torch.randn(B, K, generator=g, device=dev) * 2) / 2 - 3
    bs[0, 1] = k8.NEG_INF  # a dead beam
    need, th_lp = rbool(0.5, (B, K)), torch.round(torch.randn(B, K, generator=g, device=dev)) - 4
    sargs = (buf, n_buf, win_tok, win_valid, take(win_tok), eos_ok, lp, prev_count, finished, bs,
             need, th_lp)
    skw = dict(K=K, eos=cfg.eos_token_id, pad=cfg.pad_token_id)
    err8s = 0
    for a in (sargs, (None,) + sargs[1:]):
        (gout, gbad), (wout, wbad) = k8.beam_select(*a, **skw), k8.beam_select_plain(
            *a, stop_at_count=0, always_allow_eos=False, **skw)
        err8s += mismatches(torch, gout + (gbad,), wout + (wbad,))
    lp0 = lp[:B]
    cons0 = torch.where(rbool(0.6, (V,)), lp0, k8.NEG_INF)
    top_cons, top_idx = row_topk(cons0, 2 * K)
    bs0 = torch.full((B, K), k8.NEG_INF, device=dev)
    bs0[:, 0] = 0.0
    targs = (top_cons, top_idx, lp0, bs0, 1, K, cfg.eos_token_id)
    err8s += mismatches(torch, k8.beam_select_top(*targs), k8.beam_select_top_plain(*targs))
    if err8s:
        fail(f"beam_select differs from its plain version ({err8s} elements)")
    # kernel 8's ties mode (exact_ties) on the same inputs: the loop round's
    # merge and the selection, against its plain version and timed beside
    # the default mode
    errt = mismatches(torch, k8.beam_merge(*args, ties=True), k8.beam_merge_plain(*args, ties=True))
    for a in (sargs, (None,) + sargs[1:]):
        (gout, gbad), (wout, wbad) = k8.beam_select(*a, ties=True, **skw), k8.beam_select_plain(
            *a, stop_at_count=0, always_allow_eos=False, ties=True, **skw)
        errt += mismatches(torch, gout + (gbad,), wout + (wbad,))
    if errt:
        fail(f"beam_select_ties differs from its plain version ({errt} elements)")
    ncand = n_buf + window + 2
    sel_bytes = (B * K * (n_buf * 9 + window * 9 + 1 + 4 + 1 + 4 + 1 + 4) + rows * 8
                 + B * (2 * K * 13 + K * 13 + 1))
    table.append(dict(
        name="beam_select", max_abs_err=err8s, library_ms=None, bytes=sel_bytes,
        route=k8.select_plan(K, n_buf, window, K, False).route,
        ms=time_ms(lambda: k8.beam_select(*sargs, **skw)),
        graph_ms=graph_ms(lambda: k8.beam_select(*sargs, **skw)),
        plain_ms=time_ms(lambda: k8.beam_select_plain(*sargs, stop_at_count=0,
                                                      always_allow_eos=False, **skw)),
        step0_ms=time_ms(lambda: k8.beam_select_top(*targs)),
        step0_plain_ms=time_ms(lambda: k8.beam_select_top_plain(*targs)),
        shape=f"[{B},{K},{ncand}] with the soundness test; step 0's epilogue on [{B},1,{V}]",
    ))
    table.append(dict(
        name="beam_select_ties", max_abs_err=errt, library_ms=None, bytes=sel_bytes,
        ms=time_ms(lambda: k8.beam_select(*sargs, ties=True, **skw)),
        plain_ms=time_ms(lambda: k8.beam_select_plain(*sargs, stop_at_count=0,
                                                      always_allow_eos=False, ties=True, **skw)),
        default_ms=time_ms(lambda: k8.beam_select(*sargs, **skw)),
        merge_ms=time_ms(lambda: k8.beam_merge(*args, ties=True)),
        merge_plain_ms=time_ms(lambda: k8.beam_merge_plain(*args, ties=True)),
        merge_default_ms=time_ms(lambda: k8.beam_merge(*args)),
        shape=f"select [{B},{K},{ncand}] with the soundness test (default_ms: the default "
              f"mode on the same inputs); merge (loop round) [{B},{K},{n_buf}+256+256]",
    ))

    # kernels 9 and 10: bf16 at the generation point (and f32 once)
    H, Dh = cfg.decoder_attention_heads, cfg.head_dim
    bf = torch.bfloat16
    q = (torch.randn(rows, H, Dh, generator=g, device=dev) * 0.125).to(bf)
    kx = torch.randn(B, enc_len, H, Dh, generator=g, device=dev).to(bf)
    vx = torch.randn(B, enc_len, H, Dh, generator=g, device=dev).to(bf)
    bias = torch.zeros(B, enc_len, device=dev)
    bias[::3, -3:] = -1e9  # padded encoder positions
    step = key_len - 2  # the last decode step
    kc = torch.zeros(rows, key_len, H, Dh, device=dev, dtype=bf)
    vc = torch.zeros(rows, key_len, H, Dh, device=dev, dtype=bf)
    kc[:, : step + 1] = torch.randn(rows, step + 1, H, Dh, generator=g, device=dev).to(bf)
    vc[:, : step + 1] = torch.randn(rows, step + 1, H, Dh, generator=g, device=dev).to(bf)

    # the encoder's longest input (max_position_embeddings positions, staged
    # by the kernel in tiles), a third of the queries padded
    m_long = cfg.max_position_embeddings
    kl = torch.randn(B, m_long, H, Dh, generator=g, device=dev).to(bf)
    vl = torch.randn(B, m_long, H, Dh, generator=g, device=dev).to(bf)
    bias_l = torch.zeros(B, m_long, device=dev)
    bias_l[::3, -300:] = -1e9

    def attn_err(got, want, *args):
        """(share of the bf16 tolerance, absolute error)"""
        return (k910.bf16_error_ratio(got, want, *args),
                float((got.float() - want.float()).abs().max()))

    e9 = [attn_err(k910.cross_attention_step(*a), k910.decode_attention_plain(*a), *a)
          for a in ((q, kx, vx, bias), (q[:B], kx, vx, bias), (q, kl, vl, bias_l))]
    e10 = [attn_err(k910.self_attention_step(qq, kk, vv, s),
                    k910.self_attention_plain(qq, kk, vv, s), qq, kk, vv, None, s + 1)
           for qq, kk, vv, s in ((q, kc, vc, step), (q[:B], kc[:B], vc[:B], 0))]
    r9, a9 = max(r for r, _ in e9), max(a for _, a in e9)
    r10, a10 = max(r for r, _ in e10), max(a for _, a in e10)
    qf, kf, vf = q[:64].float(), kx[:4].float(), vx[:4].float()
    f9 = float((k910.cross_attention_step(qf, kf, vf, bias[:4])
                - k910.decode_attention_plain(qf, kf, vf, bias[:4])).abs().max())
    kcf, vcf = kc[:64].float(), vc[:64].float()
    f10 = float((k910.self_attention_step(qf, kcf, vcf, step)
                 - k910.self_attention_plain(qf, kcf, vcf, step)).abs().max())
    if r9 > 1.0 or f9 > ATTN_F32_ATOL:
        fail(f"cross_attention_step differs from its plain version (bf16 {r9} of the "
             f"tolerance, {a9} absolute; f32 {f9})")
    if r10 > 1.0 or f10 > ATTN_F32_ATOL:
        fail(f"self_attention_step differs from its plain version (bf16 {r10} of the "
             f"tolerance, {a10} absolute; f32 {f10})")
    # the library yardstick: one fused attention call on [batch, heads, len, Dh]
    g_ = K
    q4 = q.reshape(B, g_, H, Dh).permute(0, 2, 1, 3).contiguous()
    k4, v4 = kx.permute(0, 2, 1, 3).contiguous(), vx.permute(0, 2, 1, 3).contiguous()
    mask4 = bias[:, None, None, :].to(bf)
    kl4, vl4 = kl.permute(0, 2, 1, 3).contiguous(), vl.permute(0, 2, 1, 3).contiguous()
    maskl4 = bias_l[:, None, None, :].to(bf)
    qs = q[:, :, None, :].contiguous()  # [rows, H, 1, Dh]
    ks = kc[:, : step + 1].permute(0, 2, 1, 3).contiguous()
    vs = vc[:, : step + 1].permute(0, 2, 1, 3).contiguous()
    cross_bytes = 2 * (q.numel() * 2) + 2 * kx.numel() * 2 + bias.numel() * 4
    long_bytes = 2 * (q.numel() * 2) + 2 * kl.numel() * 2 + bias_l.numel() * 4
    self_bytes = 2 * (q.numel() * 2) + 2 * rows * (step + 1) * H * Dh * 2
    # QK and PV, counted at the bf16 tensor-core peak where the route runs on
    # it (kernel 9's mma route), else at the f32 rate (the bound's rule)
    cross_flops = 4 * rows * H * enc_len * Dh
    long_flops = 4 * rows * H * m_long * Dh
    self_flops = 4 * rows * H * (step + 1) * Dh
    route9 = k910.route(K, enc_len, Dh, True)
    long_bound = max(long_bytes / HBM_BYTES_PER_S, long_flops / BF16_FLOPS) * 1e3
    table.append(dict(
        name="cross_attention_step", max_abs_err=a9, tol_ratio=r9, f32_max_abs_err=f9,
        bytes=cross_bytes, flops=cross_flops, flops_rate=BF16_FLOPS, route=route9,
        ms=time_ms(lambda: k910.cross_attention_step(q, kx, vx, bias)),
        plain_ms=time_ms(lambda: k910.decode_attention_plain(q, kx, vx, bias)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask4)),
        graph_ms=graph_ms(lambda: k910.cross_attention_step(q, kx, vx, bias)),
        library_graph_ms=graph_ms(
            lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask4)),
        step0_ms=time_ms(lambda: k910.cross_attention_step(q[:B], kx, vx, bias)),
        step0_graph_ms=graph_ms(lambda: k910.cross_attention_step(q[:B], kx, vx, bias)),
        long_ms=time_ms(lambda: k910.cross_attention_step(q, kl, vl, bias_l)),
        long_plain_ms=time_ms(lambda: k910.decode_attention_plain(q, kl, vl, bias_l)),
        long_library_ms=time_ms(
            lambda: F.scaled_dot_product_attention(q4, kl4, vl4, attn_mask=maskl4)),
        long_graph_ms=graph_ms(lambda: k910.cross_attention_step(q, kl, vl, bias_l)),
        long_library_graph_ms=graph_ms(
            lambda: F.scaled_dot_product_attention(q4, kl4, vl4, attn_mask=maskl4)),
        long_bound_ms=long_bound, long_tol_ratio=e9[2][0],
        shape=f"q [{rows},{H},{Dh}] bf16, K/V [{B},{enc_len},{H},{Dh}] ({route9} route; "
              f"step0: g = 1, the warp route; long: {m_long} positions, "
              f"{k910.route(K, m_long, Dh, True)} route, a cluster of "
              f"{-(-m_long // 64)} CTAs); max err absolute, tol_ratio its share of the bf16 "
              "tolerance; graph_ms: 20 calls in one CUDA graph, replayed",
    ))
    table.append(dict(
        name="self_attention_step", max_abs_err=a10, tol_ratio=r10, f32_max_abs_err=f10,
        bytes=self_bytes, flops=self_flops, route=k910.route(1, step + 1, Dh, True),
        ms=time_ms(lambda: k910.self_attention_step(q, kc, vc, step)),
        plain_ms=time_ms(lambda: k910.self_attention_plain(q, kc, vc, step)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs)),
        graph_ms=graph_ms(lambda: k910.self_attention_step(q, kc, vc, step)),
        library_graph_ms=graph_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs)),
        shape=f"q [{rows},{H},{Dh}] bf16, cache [{rows},{key_len},{H},{Dh}] at step {step} "
              "(the warp route); max err absolute, tol_ratio its share of the bf16 tolerance; "
              "graph_ms: 20 calls in one CUDA graph, replayed",
    ))

    # kernel 11: 12 layers x {k, v} [rows, 10, H, Dh] bf16 at step 8, and
    # step 0's fan-out from B rows
    n_t = 2 * cfg.decoder_layers
    src = [torch.zeros(rows, key_len, H, Dh, device=dev, dtype=bf) for _ in range(n_t)]
    for t in src:
        t[:, : step + 1] = torch.randn(rows, step + 1, H, Dh, generator=g, device=dev).to(bf)
    dst = [torch.zeros_like(t) for t in src]
    dst_p = [torch.zeros_like(t) for t in src]
    idx = (torch.arange(B, device=dev)[:, None] * K + rint(0, K, (B, K))).reshape(-1)
    k11.reorder_cache(src, idx, step + 1, dst)
    k11.reorder_cache_plain(src, idx, step + 1, dst_p)
    err11 = mismatches(torch, dst, dst_p) + mismatches(torch, dst, [t[idx] for t in src])
    fan = torch.arange(B, device=dev).repeat_interleave(K)  # step 0: K0 = 1
    k11.reorder_cache([t[:B] for t in src], fan, 1, dst)
    err11 += mismatches(torch, [t[:, :1] for t in dst], [t[fan, :1] for t in src])
    if err11:
        fail(f"reorder_cache differs from its plain version ({err11} elements)")
    table.append(dict(
        name="reorder_cache", max_abs_err=err11, library_ms=None,
        bytes=2 * n_t * rows * (step + 1) * H * Dh * 2,
        ms=time_ms(lambda: k11.reorder_cache(src, idx, step + 1, dst)),
        plain_ms=time_ms(lambda: k11.reorder_cache_plain(src, idx, step + 1, dst_p)),
        shape=f"{n_t} x [{rows},{key_len},{H},{Dh}] bf16, live columns 0..{step}",
    ))
    torch.cuda.synchronize()
    return table


def small_parity(np, torch):
    """The port on the card, over each index layout, vs the port's plain
    CPU path, on a tiny model and corpus (the CPU path is held to the JAX
    package by the tests)."""
    from seal_tpu_torch.index.fm_index import FMIndex
    from seal_tpu_torch.decoding.generate import fm_index_generate, pad_batch
    from seal_tpu_torch.index.device_index import TorchFMIndex
    from seal_tpu_torch.index.wavelet import WaveletIndex
    from seal_tpu_torch.models import bart
    from seal_tpu_torch.models.config import bart_tiny

    cfg = bart_tiny(vocab_size=96)
    params_cpu = bart.init_params(cfg, seed=0, device="cpu")
    params_gpu = _tree_to(params_cpu, "cuda")
    n_keys = 0
    for seed in range(3):
        rng = np.random.default_rng(seed)
        docs = [rng.integers(4, 90, size=rng.integers(5, 30)).tolist() + [2] for _ in range(30)]
        host = FMIndex()
        host.initialize(docs)
        queries = [[0] + rng.integers(4, 90, size=5).tolist() + [2] for _ in range(3)]
        ids, mask = pad_batch(queries, cfg.pad_token_id)
        kw = dict(num_beams=4, max_length=6, min_length=1, window=4, exact_chunk=4)
        out = {}
        for dev, params in (("cpu", params_cpu), ("cuda", params_gpu)):
            idx = TorchFMIndex.from_host(host, vocab=96, device=dev)
            out[dev] = fm_index_generate(cfg, params, idx, ids, mask, **kw)
        for layout in WAVELET_LAYOUTS:
            idx = WaveletIndex.from_host(host, vocab=96, keep_bwt=layout == "hybrid",
                                         device="cuda")
            out[layout] = fm_index_generate(cfg, params_gpu, idx, ids, mask, **kw)
        for run in ("cuda",) + WAVELET_LAYOUTS:
            for a, b in zip(out["cpu"], out[run]):
                ka, kb = sorted((tuple(t), s) for s, t in a), sorted((tuple(t), s) for s, t in b)
                if [t for t, _ in ka] != [t for t, _ in kb]:
                    fail(f"small-input parity: keys differ between card ({run}) and CPU "
                         f"(seed {seed})")
                elif ka and max(abs(x[1] - y[1]) for x, y in zip(ka, kb)) > 1e-4:
                    fail(f"small-input parity: scores differ by > 1e-4 ({run}, seed {seed})")
                n_keys += len(ka)
    return n_keys + small_tie_parity(np, torch, cfg, params_cpu)


def small_tie_parity(np, torch, cfg, params_cpu):
    """Exact logit ties (a block of tokens shares one embedding row, and the
    corpus holds only them; ``tests/test_exact_proposals.py:61``): on the
    card, over each layout, the fast path with ``exact_ties`` equals the
    dense mode bit for bit, and both equal the CPU plain path's."""
    from seal_tpu_torch.decoding.generate import fm_index_generate, pad_batch
    from seal_tpu_torch.index.device_index import TorchFMIndex
    from seal_tpu_torch.index.fm_index import FMIndex
    from seal_tpu_torch.index.wavelet import WaveletIndex

    rng = np.random.default_rng(11)
    tied = list(range(10, 26))
    host = FMIndex()
    host.initialize([[int(t) for t in rng.choice(tied, size=10)] + [2] for _ in range(30)])
    params = dict(params_cpu)
    params["shared"] = params["shared"].clone()
    params["shared"][tied] = params["shared"][tied[0]].clone()
    params_gpu = _tree_to(params, "cuda")
    ids, mask = pad_batch([[0] + rng.integers(4, 90, size=4).tolist() + [2] for _ in range(2)],
                          cfg.pad_token_id)
    kw = dict(num_beams=4, max_length=5, min_length=1, window=4, exact_chunk=4,
              exact_ties=True)
    canon = lambda hyps: [sorted((tuple(t), s) for s, t in q) for q in hyps]  # noqa: E731
    cpu_idx = TorchFMIndex.from_host(host, vocab=96, device="cpu")
    want = canon(fm_index_generate(cfg, params, cpu_idx, ids, mask, **kw))
    if want != canon(fm_index_generate(cfg, params, cpu_idx, ids, mask, exact_mask=True, **kw)):
        fail("tie parity: the CPU fast path with exact_ties differs from its dense mode")
    n = 0
    for layout in ("psi",) + WAVELET_LAYOUTS:
        idx = (TorchFMIndex.from_host(host, vocab=96, device="cuda") if layout == "psi" else
               WaveletIndex.from_host(host, vocab=96, keep_bwt=layout == "hybrid",
                                      device="cuda"))
        fast = canon(fm_index_generate(cfg, params_gpu, idx, ids, mask, **kw))
        dense = canon(fm_index_generate(cfg, params_gpu, idx, ids, mask, exact_mask=True, **kw))
        if fast != dense:
            fail(f"tie parity ({layout}): exact_ties fast path differs from the dense mode")
        for a, b in zip(want, fast):
            if [t for t, _ in a] != [t for t, _ in b]:
                fail(f"tie parity ({layout}): keys differ between card and CPU")
            elif a and max(abs(x[1] - y[1]) for x, y in zip(a, b)) > 1e-4:
                fail(f"tie parity ({layout}): scores differ by > 1e-4")
            n += len(b)
    if n == 0:
        fail("tie parity: no keys emitted")
    return n


def search_kernel_phases(np, torch, host, index, vocab):
    """Kernels 5-7 against their plain versions at the searcher path's
    shapes, on the searcher's index."""
    from seal_tpu_torch.kernels import bucket_counts as k6
    from seal_tpu_torch.kernels import fm_search as k5
    from seal_tpu_torch.kernels import rescore as k7

    dev = index.device
    rng = np.random.default_rng(2)
    g = torch.Generator(device=dev).manual_seed(2)
    text = host.text[:-1] - 1  # the documents, each reversed
    table = []

    # kernel 5: 4096 corpus n-grams (forward), lengths 1-16; an eighth are
    # random ids, some out of the vocab
    n, L = 4096, 16
    starts = rng.integers(0, text.size - L, size=n)
    toks = np.stack([text[s : s + L][::-1] for s in starts]).astype(np.int32)
    toks[: n // 8] = rng.integers(-1, vocab + 2, size=(n // 8, L))
    toks = torch.as_tensor(toks, device=dev)
    lens = torch.as_tensor(rng.integers(1, L + 1, size=n).astype(np.int32), device=dev)
    got = k5.fm_sequences(index, toks, lens)
    want = k5.sequences_plain(index, toks, lens)
    err5 = max(int((a - b).abs().max()) for a, b in zip(got, want))
    if err5:
        fail(f"fm_sequences differs from its plain version (max err {err5})")
    for G in k5.GROUPS:  # every group width, forced
        got = k5.fm_sequences(index, toks, lens, group=G)
        err5 = max([err5] + [int((a - b).abs().max()) for a, b in zip(got, want)])
    if err5:
        fail("fm_sequences at a forced group width differs from its plain version")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    table.append(dict(
        name="fm_sequences", max_abs_err=err5,
        ms=time_ms(lambda: k5.fm_sequences(index, toks, lens)),
        graph_ms=graph_ms(lambda: k5.fm_sequences(index, toks, lens)),
        group_graph_ms={G: graph_ms(lambda G=G: k5.fm_sequences(index, toks, lens, group=G))
                        for G in k5.GROUPS},
        plain_ms=time_ms(lambda: k5.sequences_plain(index, toks, lens)),
        shape=f"[{n}, {L}], lengths 1-{L}, {int(((want[1] - want[0]) > 0).sum())} non-empty; "
              f"group {k5.sequences_plan(n, sms)[0]} lanes a sequence (group_graph_ms: each "
              "width forced)",
        library_ms=None,
        # tokens, lengths, ranges out, and per position two search chains of
        # at most search_iters dependent psi reads
        bytes=n * (L * 4 + 4 + 8) + int(lens.sum()) * 2 * 4 * index.search_iters,
    ))

    # kernel 6: [16, 15] ranges of one- and two-token corpus prefixes, plus
    # the full range, a whole bucket block and an empty range
    B, K = 16, 15
    first = torch.as_tensor(rng.choice(text, size=(2, B, K)).astype(np.int32), device=dev)
    full_lo, full_hi = index.full_range((B, K))
    lo1, hi1 = k5.backward_step_plain(index, first[0], full_lo, full_hi)
    lo2, hi2 = k5.backward_step_plain(index, first[1], lo1, hi1)
    even = torch.arange(K, device=dev) % 2 == 0
    lo, hi = torch.where(even, lo1, lo2), torch.where(even, hi1, hi2)
    lo[0, 0], hi[0, 0] = 0, index.n_rows
    lo[0, 1], hi[0, 1] = 1024, 2048
    lo[0, 2], hi[0, 2] = 5, 5
    err6 = int((k6.bucket_counts(index, lo, hi) - k6.bucket_counts_plain(index, lo, hi))
               .abs().max())
    # the rows each range recounts from the BWT: its partial blocks
    br = index.bucket_rows
    lo_c, hi_c = lo.clamp(0, index.n_rows).long(), hi.clamp(0, index.n_rows).long()
    same = lo_c // br == hi_c // br
    partial = torch.where(same, (hi_c - lo_c).clamp(min=0),
                          (lo_c // br + 1) * br - lo_c + hi_c - hi_c // br * br)
    if err6:
        fail(f"bucket_counts differs from its plain version (max err {err6})")
    table.append(dict(
        name="bucket_counts", max_abs_err=err6,
        ms=time_ms(lambda: k6.bucket_counts(index, lo, hi)),
        plain_ms=time_ms(lambda: k6.bucket_counts_plain(index, lo, hi)),
        shape=f"[{B},{K}] ranges x {index.n_buckets} buckets", library_ms=None,
        bytes=B * K * (8 + 2 * 4 * index.n_buckets + 4 * index.n_buckets) + int(partial.sum()) * 4,
    ))

    # kernel 7: a full rescoring sub-batch of f32 logits, with the SEAL
    # bias's -inf columns and pad targets
    N, T = 256, 16
    logits = torch.randn((N, T, vocab), generator=g, device=dev) * 3
    logits[..., 1] = float("-inf")
    tgt = torch.randint(2, vocab, (N, T), generator=g, device=dev, dtype=torch.int32)
    tgt[:, -4:] = 1
    err7 = 0.0
    for n_prefix in (0, 1):
        got = k7.rescore_logprob(logits, tgt, n_prefix)
        want = k7.rescore_logprob_plain(logits, tgt, n_prefix)
        err7 = max(err7, float((got - want).abs().max()))
        if not torch.equal(got, k7.rescore_logprob(logits, tgt, n_prefix)):
            fail("rescore_logprob gives other bits on a second run")
    if err7 > RESCORE_ATOL:
        fail(f"rescore_logprob differs from its plain version (max err {err7})")
    table.append(dict(
        name="rescore_logprob", max_abs_err=err7, atol=RESCORE_ATOL,
        ms=time_ms(lambda: k7.rescore_logprob(logits, tgt, 0)),
        plain_ms=time_ms(lambda: k7.rescore_logprob_plain(logits, tgt, 0)),
        shape=f"[{N},{T},{vocab}] f32", library_ms=None,
        bytes=logits.numel() * 4 + tgt.numel() * 4 + N * 4, flops=3 * logits.numel(),
    ))
    del logits
    torch.cuda.synchronize()
    return table


def block_sectors(torch, x, d=None) -> int:
    """Distinct 32-byte sectors of one level's 192-byte blocks (6 sectors:
    count words in 0-1, code words in 2-5) that ranks at positions ``x``
    read: the sector of count word ``d`` (both count sectors when ``d`` is
    None: every digit), and the code sectors up to the word holding x."""
    x = x.reshape(-1).long()
    base = (x >> 8) * 6
    last = 2 + ((x & 255) >> 6)  # the sector of code word 16 + (x & 255) / 8
    code = base[:, None] + torch.minimum(torch.arange(2, 6, device=x.device), last[:, None])
    if d is None:
        count = base[:, None] + torch.arange(2, device=x.device)
    else:
        count = (base + (d.reshape(-1).long() >> 3))[:, None]
    return torch.unique(torch.cat([count.reshape(-1), code.reshape(-1)])).numel()


def touched_bytes(torch, *traces) -> int:
    """Bytes of the distinct 32-byte sectors that descents read, each
    counted once: what the data needs, not one block per query.  Each
    trace is a plain descent's per-level (position, node, digit) list
    (``wt_search.rank_plain`` / ``access_plain``); per level it counts the
    block sectors, the node_start words and the node_cnt words read."""
    n = 0
    for level in zip(*traces):
        x, node, d = (torch.cat([t[i].reshape(-1) for t in level]).long() for i in range(3))
        n += 32 * (block_sectors(torch, x, d) + torch.unique(node >> 3).numel()
                   + torch.unique((node * 16 + d) >> 3).numel())
    return n


def wavelet_kernel_phases(np, torch, host, psi, layouts, V, B, K):
    """Kernels 12-14 against their plain versions at the generation path's
    shapes on both wavelet layouts, exactly, each timed beside its Psi
    counterpart (kernels 1, 5, 2 and 6) on the same ranges.  The bound is
    bytes: the distinct 32-byte sectors of blocks and node tables that the
    inputs' descents read, each once, beside a dependent chain of
    ``digits`` levels."""
    from seal_tpu_torch.kernels import bucket_counts as k6
    from seal_tpu_torch.kernels import fm_search as k1
    from seal_tpu_torch.kernels import window_gather as k2
    from seal_tpu_torch.kernels import wt_bucket_counts as k14
    from seal_tpu_torch.kernels import wt_search as k12
    from seal_tpu_torch.kernels import wt_window as k13

    compact, hybrid = layouts["compact"], layouts["hybrid"]
    dev = compact.device
    g = torch.Generator(device=dev).manual_seed(4)
    rng = np.random.default_rng(4)
    N, digits = compact.n_rows, compact.digits
    table = []

    # the decode's ranges: one- and two-token prefixes of corpus text, the
    # full range, an empty range and the empty range at the end; the same
    # rows in every layout
    text = host.text[:-1] - 1
    first = torch.as_tensor(rng.choice(text, size=(2, B, K)).astype(np.int32), device=dev)
    full_lo, full_hi = psi.full_range((B, K))
    lo1, hi1 = k1.backward_step_plain(psi, first[0], full_lo, full_hi)
    lo2, hi2 = k1.backward_step_plain(psi, first[1], lo1, hi1)
    even = torch.arange(K, device=dev) % 2 == 0
    lo, hi = torch.where(even, lo1, lo2), torch.where(even, hi1, hi2)
    lo[0, 0], hi[0, 0] = 0, N
    lo[0, 1], hi[0, 1] = 5, 5
    lo[0, 2], hi[0, 2] = N, N
    wlo, whi = k12.backward_step_plain(compact, first[1], lo1, hi1)
    if not (torch.equal(wlo, lo2) and torch.equal(whi, hi2)):
        fail("the wavelet layout's ranges differ from the Psi layout's")

    # kernel 12: membership [B, K, 65], backward step [B, K], 4096 sequences
    cand = torch.randint(0, V, (B, K, 65), generator=g, device=dev, dtype=torch.int32)
    cand[..., :32] = first[0, :, :, None]
    cand[..., -1] = 2
    ext = torch.randint(-1, V + 2, (B, K), generator=g, device=dev, dtype=torch.int32)
    n_seq, L = 4096, 16
    starts = rng.integers(0, text.size - L, size=n_seq)
    seqs = np.stack([text[s : s + L][::-1] for s in starts]).astype(np.int32)
    seqs[: n_seq // 8] = rng.integers(-1, V + 2, size=(n_seq // 8, L))
    seqs = torch.as_tensor(seqs, device=dev)
    lens = torch.as_tensor(rng.integers(1, L + 1, size=n_seq).astype(np.int32), device=dev)
    err12 = 0
    for ix in (compact, hybrid):
        err12 += int((k12.wt_search(ix, "contains", cand, lo, hi)
                      != k12.contains_plain(ix, cand, lo, hi)).sum())
        err12 += int((k12.wt_search(ix, "contains", cand, lo, hi)
                      != k1.contains_plain(psi, cand, lo, hi)).sum())
        for a, b in zip(k12.wt_search(ix, "backward_step", ext, lo, hi),
                        k12.backward_step_plain(ix, ext, lo, hi)):
            err12 = max(err12, int((a - b).abs().max()))
        for a, b in zip(k12.wt_sequences(ix, seqs, lens), k12.sequences_plain(ix, seqs, lens)):
            err12 = max(err12, int((a - b).abs().max()))
    if err12:
        fail(f"wt_search differs from its plain version (max err {err12})")
    n_q = cand.numel()
    c = cand + 1
    c = torch.where((c >= 1) & (c < compact.sigma), c, 0)
    traces = ([], [])
    for pos, trace in zip((lo, hi), traces):
        k12.rank_plain(compact, c, pos[..., None], trace=trace)
    index12 = touched_bytes(torch, *traces)
    table.append(dict(
        name="wt_search", max_abs_err=err12, library_ms=None,
        ms=time_ms(lambda: k12.wt_search(compact, "contains", cand, lo, hi)),
        graph_ms=graph_ms(lambda: k12.wt_search(compact, "contains", cand, lo, hi)),
        plain_ms=time_ms(lambda: k12.contains_plain(compact, cand, lo, hi)),
        psi_ms=time_ms(lambda: k1.fm_search(psi, "contains", cand, lo, hi)),
        sequences_ms=time_ms(lambda: k12.wt_sequences(compact, seqs, lens)),
        sequences_psi_ms=time_ms(lambda: k1.fm_sequences(psi, seqs, lens)),
        shape=f"contains [{B},{K},65] (compact; hybrid checked too); backward_step [{B},{K}]; "
              f"sequences [{n_seq},{L}]; a chain of {digits} dependent levels",
        # tokens, membership out, the range pair, and the index bytes read
        bytes=n_q * (4 + 1) + B * K * 8 + index12, index_bytes=index12,
    ))

    # kernel 12's step mode: the range update after a selection, at step 0
    # (no stop rule) and later (finished parents, EOS and PAD selections),
    # on both layouts, against its plain version and beside the composition
    # over its backward step that it replaced
    from seal_tpu_torch.ops import _generic

    sel_tok = ext.clone()
    sel_tok[0, :2] = torch.tensor([2, 1], device=dev)
    sel_par = torch.randint(0, K, (B, K), generator=g, device=dev, dtype=torch.int32)
    fin = torch.rand(B, K, generator=g, device=dev) < 0.2
    errA = 0
    for ix in (compact, hybrid):
        for sp, f in ((torch.zeros_like(sel_par), None), (sel_par, fin)):
            got = k12.wt_advance(ix, sel_tok, sp, lo, hi, f, eos=2, pad=1)
            want_a = k12.advance_plain(ix, sel_tok, sp, lo, hi, f, eos=2, pad=1)
            errA += sum(int((a != b).sum()) for a, b in zip(got, want_a)) + (len(got) != 3)
    if errA:
        fail(f"wt_search_advance differs from its plain version ({errA} elements)")

    def adv(ix=compact):
        return k12.wt_advance(ix, sel_tok, sel_par, lo, hi, fin, eos=2, pad=1)

    def composed():  # the update as the decode step made it before the step mode
        return _generic.advance_ranges(
            lambda t, a, b: k12.wt_search(compact, "backward_step", t, a, b), lambda a, b: b - a,
            sel_tok, sel_par, lo, hi, fin, eos=2, pad=1)

    # the descents this run's selections need: a valid token, no stop
    sc = sel_tok + 1
    search = ((sc >= 1) & (sc < compact.sigma) & (sel_tok != 2) & (sel_tok != 1)
              & ~torch.gather(fin, 1, sel_par.long()))
    traces = ([], [])
    for pos, trace in zip((lo, hi), traces):
        k12.rank_plain(compact, sc[search], torch.gather(pos, 1, sel_par.long())[search],
                       trace=trace)
    index_a = touched_bytes(torch, *traces)
    table.append(dict(
        name="wt_search_advance", max_abs_err=errA, library_ms=None,
        ms=time_ms(adv), graph_ms=graph_ms(adv),
        hybrid_ms=time_ms(lambda: adv(hybrid)),
        plain_ms=time_ms(lambda: k12.advance_plain(compact, sel_tok, sel_par, lo, hi, fin, eos=2,
                                                    pad=1)),
        composed_ms=time_ms(composed), composed_graph_ms=graph_ms(composed),
        shape=f"[{B},{K}] selections over [{B},{K}] parents, compact (hybrid_ms: the hybrid "
              "layout; composed_ms: range_size, the gathers, kernel 12's backward step and the "
              "stop rule as separate launches)",
        # the parents' ranges and flags, the selections, three outputs, and
        # the index bytes both bounds' descents read
        bytes=B * K * (8 + 1 + 8 + 12) + index_a, index_bytes=index_a,
    ))

    # kernel 13: the window [B*K rows, w=32, fill pad] and a slab (w=64,
    # fill 0), descent (compact) and direct (hybrid)
    lp = torch.log_softmax(torch.randn(B * K, V, generator=g, device=dev), -1)
    err13 = 0.0
    for ix in (compact, hybrid):
        for w, fill in ((32, 1), (64, 0)):
            got = k13.wt_window_gather(ix, lo, hi, w, lp, fill)
            want = k13.wt_window_gather_plain(ix, lo, hi, w, lp, fill)
            psi_out = k2.window_gather_plain(psi, lo, hi, w, lp, fill)
            for ref in (want, psi_out):
                err13 = max(err13, float((got[0] - ref[0]).abs().max()),
                            float((got[1] != ref[1]).sum()), float((got[2] - ref[2]).abs().max()))
    if err13:
        fail(f"wt_window_gather differs from its plain version (max err {err13})")
    slots = B * K * 32
    rows, ok = k2.window_rows(lo, hi, 32)
    trace = []
    k12.access_plain(compact, rows[ok], trace=trace)
    index13 = touched_bytes(torch, trace)
    table.append(dict(
        name="wt_window_gather", max_abs_err=err13, library_ms=None,
        ms=time_ms(lambda: k13.wt_window_gather(compact, lo, hi, 32, lp, 1)),
        plain_ms=time_ms(lambda: k13.wt_window_gather_plain(compact, lo, hi, 32, lp, 1)),
        psi_ms=time_ms(lambda: k2.window_gather(psi, lo, hi, 32, lp, 1)),
        hybrid_ms=time_ms(lambda: k13.wt_window_gather(hybrid, lo, hi, 32, lp, 1)),
        hybrid_plain_ms=time_ms(lambda: k13.wt_window_gather_plain(hybrid, lo, hi, 32, lp, 1)),
        shape=f"[{B * K}, w=32] over lp [{B * K},{V}], descent (compact; {digits} levels a slot) "
              "and direct (hybrid_ms: one 2-byte read a slot)",
        # ranges, the descents' index bytes, the lp reads and the outputs
        bytes=B * K * 8 + index13 + slots * (4 + 9), index_bytes=index13,
        graph_ms=graph_ms(lambda: k13.wt_window_gather(compact, lo, hi, 32, lp, 1)),
        hybrid_graph_ms=graph_ms(lambda: k13.wt_window_gather(hybrid, lo, hi, 32, lp, 1)),
    ))
    table += wt_window_slab_rows(torch, k12, k13, layouts, lo, hi, lp, B, K, V)

    # kernel 14: [B, K] ranges into 256 buckets, plus a range inside one
    # block and one across a block edge
    blo, bhi = lo.clone(), hi.clone()
    blo[0, 3], bhi[0, 3] = 256, 300
    blo[0, 4], bhi[0, 4] = 255, 1025
    width = k14.bucket_counts_width(compact)
    err14 = 0
    for ix in (compact, hybrid):
        got = k14.wt_bucket_counts(ix, blo, bhi)
        err14 += int((got != k14.wt_bucket_counts_plain(ix, blo, bhi)).sum())
        err14 += int((got.sum(-1) != (bhi - blo).clamp(min=0)).sum())
    if err14:
        fail(f"wt_bucket_counts differs from its plain version ({err14} counts)")
    # level 0 ranks every digit at the bounds, level 1 at the 16 children's
    # positions of each bound (every count word, the code words up to x);
    # the node tables' first 17 rows
    x0 = torch.stack([blo, bhi]).reshape(-1, 1).expand(-1, k14.RADIX)
    digit = torch.arange(k14.RADIX, device=dev, dtype=torch.int32).expand(x0.shape)
    child = (k12.rank_from_block(k12.load_block(compact, 0, x0), x0, digit)
             - compact.node_cnt[0])
    x1 = compact.node_start[1 : 1 + k14.RADIX] + child
    index14 = (block_sectors(torch, x0[:, 0]) + block_sectors(torch, x1)) * 32 \
        + (1 + k14.RADIX) * k14.RADIX * 4 + (1 + k14.RADIX) * 4
    table.append(dict(
        name="wt_bucket_counts", max_abs_err=err14, library_ms=None,
        ms=time_ms(lambda: k14.wt_bucket_counts(compact, blo, bhi)),
        plain_ms=time_ms(lambda: k14.wt_bucket_counts_plain(compact, blo, bhi)),
        psi_ms=time_ms(lambda: k6.bucket_counts(psi, blo, bhi)),
        shape=f"[{B},{K}] ranges x {width} buckets ({k14.bucket_size_of(compact)} symbols each)",
        # ranges in, counts out, and the index bytes read
        bytes=B * K * (8 + 4 * width) + index14, index_bytes=index14,
    ))
    table += support_rows(torch, k6, k14, psi, layouts, blo, bhi, x0, child, B, K)
    table.append(straggler_row(torch, k6, k14, psi, compact, lo, hi, lp, B, K, V))
    torch.cuda.synchronize()
    return table


def support_rows(torch, k6, k14, psi, layouts, lo, hi, x0, child, B, K):
    """Kernels 6 and 14's support modes (what the straggler rounds read) on
    kernel 14's ranges, and on kernel 6's narrow/wide route boundary (hi -
    lo equal to the rows the wide route reads, and a row either side), each
    equal to its plain version and to its counts mode's > 0.  Bounds:
    bytes, the ranges in, 32 B out a range and the rows read: kernel 6 a
    range's own BWT rows on the narrow route, else each bound's rows to its
    block's nearer end and two table rows; kernel 14 a sector of each
    distinct block its descent reads (level 0 at the bounds, level 1 at the
    non-empty children's bounds)."""
    compact, hybrid = layouts["compact"], layouts["hybrid"]
    N, br = psi.n_rows, psi.bucket_rows
    slo, shi = lo.clone(), hi.clone()
    slo[0, 5:8] = torch.tensor([br + br // 2 - 1, br + br // 2, br + br // 2 + 1])
    shi[0, 5:8] = 2 * br + 100
    got = k6.bucket_support(psi, slo, shi)
    err6 = int((got != k6.bucket_support_plain(psi, slo, shi)).sum())
    err6 += int((got != k6.pack_support(k6.bucket_counts(psi, slo, shi))).sum())
    if err6:
        fail(f"bucket_support differs from its plain version or the counts mode ({err6} words)")
    narrow, wide, rows6 = support_routes(torch, slo, shi, N, N, br)
    counts6 = lambda: k6.bucket_counts(psi, slo, shi)  # noqa: E731
    rows = [dict(
        name="bucket_support", max_abs_err=err6, library_ms=None,
        ms=time_ms(lambda: k6.bucket_support(psi, slo, shi)),
        graph_ms=graph_ms(lambda: k6.bucket_support(psi, slo, shi)),
        plain_ms=time_ms(lambda: k6.bucket_support_plain(psi, slo, shi)),
        counts_ms=time_ms(counts6), counts_graph_ms=graph_ms(counts6),
        shape=f"[{B},{K}] ranges -> 8 words, {int(narrow.sum())} on the narrow route, "
              f"{int(wide.sum())} on the wide (counts_*: the counts mode on the same ranges)",
        bytes=B * K * (8 + 32) + 4 * rows6 + 2 * 4 * psi.n_buckets * int(wide.sum()),
    )]
    err14 = 0
    for ix in (compact, hybrid):
        got = k14.wt_bucket_support(ix, lo, hi)
        err14 += int((got != k14.wt_bucket_support_plain(ix, lo, hi)).sum())
        err14 += int((got != k6.pack_support(k14.wt_bucket_counts(ix, lo, hi))).sum())
    if err14:
        fail(f"wt_bucket_support differs from its plain version or the counts mode ({err14})")
    n = B * K
    live1 = (child[n:] > child[:n]).repeat(2, 1)  # the non-empty children, at both bounds
    x1 = (compact.node_start[1 : 1 + k14.RADIX] + child)[live1]
    blocks = torch.unique(x0[:, 0].long() >> 8).numel() + torch.unique(x1.long() >> 8).numel()
    counts14 = lambda: k14.wt_bucket_counts(compact, lo, hi)  # noqa: E731
    rows.append(dict(
        name="wt_bucket_support", max_abs_err=err14, library_ms=None,
        ms=time_ms(lambda: k14.wt_bucket_support(compact, lo, hi)),
        graph_ms=graph_ms(lambda: k14.wt_bucket_support(compact, lo, hi)),
        hybrid_graph_ms=graph_ms(lambda: k14.wt_bucket_support(hybrid, lo, hi)),
        plain_ms=time_ms(lambda: k14.wt_bucket_support_plain(compact, lo, hi)),
        counts_ms=time_ms(counts14), counts_graph_ms=graph_ms(counts14),
        shape=f"[{B},{K}] ranges -> 8 words, {int(live1[n:].sum())} non-empty children "
              "descended (counts_*: the counts mode on the same ranges)",
        bytes=n * (8 + 32) + 32 * blocks,
    ))
    return rows


def support_routes(torch, lo, hi, n_rows, whole, R):
    """Kernel 6's support mode's routes and rows read: (narrow, wide, rows)
    for ranges clamped to ``n_rows``; each bound reads its rows up to its
    block's nearer end (the upper only where that block ends at or below
    ``whole``: the index's rows, or a shard's own)."""
    lo_c, hi_c = lo.clamp(0, n_rows).long(), hi.clamp(0, n_rows).long()

    def bound_rows(p):
        n = p % R
        up = (2 * n > R) & ((p // R + 1) * R <= whole)
        return torch.where(up, R - n, n)

    c = bound_rows(lo_c) + bound_rows(hi_c)
    live = hi_c > lo_c
    narrow = live & (hi_c - lo_c <= c)
    wide = live & ~narrow
    rows = int(torch.where(narrow, hi_c - lo_c, 0).sum() + torch.where(wide, c, 0).sum())
    return narrow, wide, rows


def straggler_row(torch, k6, k14, psi, compact, lo, hi, lp, B, K, V):
    """A straggler round's select in one launch (``pruned_topk``: kernel 3's
    select through the pruning loader) at the decode's [B * K, V] from
    round 0's (lp, token) threshold (its top 64), k = 256: bit for bit its
    plain version and kernel 3 over the parent's pruned ``work`` rows, with
    the Psi index's
    support bits (bucket size ceil(sigma / 256): a multiply) and the compact
    layout's (a shift), and at k = 20,000 (the global sort).  composed_*:
    the parent's round (kernel 6's counts, the pruned copy, the consumed
    mask, kernel 3); round_graph_ms: this round (the support bits, then the
    select).  Bound: bytes, lp read once, the words and thresholds, the
    top k written."""
    from seal_tpu_torch.decoding.constrained import NEG_INF
    from seal_tpu_torch.index.fm_index import SHIFT
    from seal_tpu_torch.kernels import row_topk as k3

    vals, idx = k3.row_topk(lp, 64)
    th_lp, th_ix = vals[:, -1].contiguous(), idx[:, -1].int()
    err = 0
    for ix, ops in ((psi, k6.bucket_support), (compact, k14.wt_bucket_support)):
        bs = psi.bucket_size if ix is psi else k14.bucket_size_of(compact)
        bits = ops(ix, lo, hi).reshape(B * K, -1)
        for k in (256, 20000):
            args = (lp, bits, th_lp, th_ix, bs, k, NEG_INF)
            got = k3.pruned_topk(*args)
            for want in (k3.pruned_topk_plain(*args),
                         k3.row_topk(k3.pruned_rows(*args[:5], NEG_INF), k)):
                err += sum(int((a.view(torch.int32) if a.is_floating_point() else a)
                               .ne(b.view(torch.int32) if b.is_floating_point() else b).sum())
                           for a, b in zip(got, want))
    if err:
        fail(f"pruned_topk differs from its plain version or kernel 3 over the pruned rows "
             f"({err} values or indices)")
    bits = k6.bucket_support(psi, lo, hi).reshape(B * K, -1)
    args = (lp, bits, th_lp, th_ix, psi.bucket_size, 256, NEG_INF)
    v_idx = torch.arange(V, dtype=torch.int32, device=lp.device)
    v_bucket = ((v_idx + SHIFT) // psi.bucket_size).long()
    th, thi = th_lp[:, None], th_ix[:, None]

    def parent_round():
        bc = k6.bucket_counts(psi, lo, hi).reshape(B * K, -1)
        base = torch.where(bc[:, v_bucket] > 0, lp, NEG_INF)
        consumed = (base > th) | ((base == th) & (v_idx <= thi))
        return k3.row_topk(torch.where(consumed, NEG_INF, base), 256)

    def round_():
        b = k6.bucket_support(psi, lo, hi).reshape(B * K, -1)
        return k3.pruned_topk(lp, b, th_lp, th_ix, psi.bucket_size, 256, NEG_INF)

    large = (lp, bits, th_lp, th_ix, psi.bucket_size, 20000, NEG_INF)
    return dict(
        name="pruned_topk", max_abs_err=err, library_ms=None,
        ms=time_ms(lambda: k3.pruned_topk(*args)),
        graph_ms=graph_ms(lambda: k3.pruned_topk(*args)),
        plain_ms=time_ms(lambda: k3.pruned_topk_plain(*args)),
        row_topk_graph_ms=graph_ms(lambda: k3.row_topk(lp, 256)),
        large_k_graph_ms=graph_ms(lambda: k3.pruned_topk(*large)),
        composed_ms=time_ms(parent_round), composed_graph_ms=graph_ms(parent_round),
        round_graph_ms=graph_ms(round_),
        shape=f"[{B * K},{V}] k=256 (large_k_graph_ms: k=20000; row_topk_graph_ms: kernel 3 on "
              "the raw rows; composed_*: the parent's round; round_graph_ms: support + select)",
        bytes=B * K * (V * 4 + 32 + 8 + 256 * 12),
    )


def rows_bytes(torch, index_rows, lo, hi, hist_max, row_bytes: float) -> int:
    """Bytes of the distinct index rows that the histogram route's ranges
    (at most ``hist_max`` rows) cover, each counted once at ``row_bytes``
    a row, in 32-byte sectors: what the data needs of the index, not one
    read per slice.  The rank route's ranges add nothing: a lower bound."""
    width = (hi - lo).reshape(-1).long()
    keep = (width > 0) & (width <= hist_max)
    cover = torch.zeros(index_rows + 1, dtype=torch.int64, device=lo.device)
    cover.index_add_(0, lo.reshape(-1).long()[keep], torch.ones_like(width[keep]))
    cover.index_add_(0, hi.reshape(-1).long()[keep], -torch.ones_like(width[keep]))
    rows = torch.nonzero(torch.cumsum(cover, 0)[:index_rows] > 0).reshape(-1)
    per_sector = max(1, int(32 / row_bytes))
    return 32 * torch.unique(rows // per_sector).numel()


def dense_kernel_phases(np, torch, host, psi, layouts, V, B, K):
    """Kernels 15-17 against their plain versions at the dense decode's
    shapes: the count vector of [B, K] ranges of one- and two-token
    prefixes (the ranges of steps 1 and 2, plus the full range and empty
    ones) over the three layouts, on both routes, exactly, in the counts
    modes and in the mask modes that the exact_mask decode reads; the
    candidate pass over the mask, bit for bit; kernel 3 on the [B, K * V]
    rows it writes.  Each bound is its output (R x V int32 counts, or the R
    x words(V) mask; kernel 17 reads the mask and the allowed log-probs)
    plus the index rows the histogram route reads."""
    from seal_tpu_torch.kernels import beam_select as k8
    from seal_tpu_torch.kernels import count_mask
    from seal_tpu_torch.kernels import dense_scores as k17
    from seal_tpu_torch.kernels import fm_search as k15
    from seal_tpu_torch.kernels import row_topk as k3
    from seal_tpu_torch.kernels import wt_search as k16

    compact, hybrid = layouts["compact"], layouts["hybrid"]
    dev = psi.device
    g = torch.Generator(device=dev).manual_seed(5)
    rng = np.random.default_rng(5)
    N, R = psi.n_rows, B * K
    text = host.text[:-1] - 1
    first = torch.as_tensor(rng.choice(text, size=(2, B, K)).astype(np.int32), device=dev)
    full_lo, full_hi = psi.full_range((B, K))
    lo1, hi1 = k15.backward_step_plain(psi, first[0], full_lo, full_hi)
    lo2, hi2 = k15.backward_step_plain(psi, first[1], lo1, hi1)
    even = torch.arange(K, device=dev) % 2 == 0
    lo, hi = torch.where(even, lo1, lo2), torch.where(even, hi1, hi2)
    lo[0, 0], hi[0, 0] = 0, N
    lo[0, 1], hi[0, 1] = 5, 5
    lo[0, 2], hi[0, 2] = N, N
    widths = (hi - lo).reshape(-1)
    log(f"dense ranges: {R}, rows a range median {int(widths.median())}, max {int(widths.max())}, "
        f"sum {int(widths.sum())}; histogram route (<= {k15.HIST_MAX_ROWS} rows) on "
        f"{int((widths <= k15.HIST_MAX_ROWS).sum())}")
    table = []
    t0 = time.perf_counter()
    # (contiguous, as kernels 15 and 16 write it: the plain sweep's cut of
    # its last chunk leaves a strided view, which kernel 17's wrappers would
    # copy inside their timings)
    want = k15.dense_counts_plain(psi, lo, hi, 2048).contiguous()
    err15 = 0
    for hist_max in (k15.HIST_MAX_ROWS, 0, 2**31 - 1):
        err15 += int((k15.fm_dense_counts(psi, lo, hi, hist_max=hist_max) != want).sum())
    if err15:
        fail(f"fm_dense_counts differs from its plain version ({err15} counts)")
    out_bytes = R * 8 + R * V * 4
    table.append(dict(
        name="fm_dense_counts", max_abs_err=err15, library_ms=None,
        ms=time_ms(lambda: k15.fm_dense_counts(psi, lo, hi)),
        plain_ms=time_ms(lambda: k15.dense_counts_plain(psi, lo, hi, 2048), iters=2),
        rank_route_ms=time_ms(lambda: k15.fm_dense_counts(psi, lo, hi, hist_max=0), iters=5),
        histogram_route_ms=time_ms(lambda: k15.fm_dense_counts(psi, lo, hi, hist_max=2**31 - 1)),
        shape=f"[{B},{K}] ranges x {V} tokens (rank route: every range by kernel 1's search)",
        bytes=out_bytes + rows_bytes(torch, N, lo, hi, k15.HIST_MAX_ROWS, 4),
    ))
    # kernel 16 on both layouts at every route: the default, every
    # non-empty range walked (hist_max 0), histogrammed, and the default
    # replayed from a CUDA graph
    err16 = 0
    k16_routes = {"default": {}, "walk": dict(hist_max=0), "histogram": dict(hist_max=2**31 - 1)}
    for ix in (compact, hybrid):
        for rkw in k16_routes.values():
            err16 += int((k16.wt_dense_counts(ix, lo, hi, **rkw) != want).sum())
        err16 += int((graph_result(torch, lambda ix=ix: k16.wt_dense_counts(ix, lo, hi))
                      != want).sum())
    hmax = k16.HIST_MAX_ROWS
    # the route threshold: ranges of at most this many rows take the
    # histogram, wider ones the rank route (kernel 15) or the walk (kernel
    # 16, held to the plain sweep at every threshold); the defaults are
    # marked *
    sweep = []
    for name, fn, ix, default in (("psi", k15.fm_dense_counts, psi, k15.HIST_MAX_ROWS),
                                  ("compact", k16.wt_dense_counts, compact, hmax["compact"]),
                                  ("hybrid", k16.wt_dense_counts, hybrid, hmax["hybrid"])):
        cells = []
        for h in (0, 1 << 6, 1 << 8, 1 << 10, 1 << 12, 1 << 14, 1 << 16, 1 << 18, 1 << 20,
                  2**31 - 1):
            ms = time_ms(lambda: fn(ix, lo, hi, hist_max=h), iters=5)
            cells.append(f"{h}{'*' if h == default else ''} {ms:.4f}")
            if fn is k16.wt_dense_counts:
                err16 += int((fn(ix, lo, hi, hist_max=h) != want).sum())
        sweep.append(f"{name}: " + ", ".join(cells))
    log("dense counts by histogram threshold (rows: ms): " + "; ".join(sweep))
    if err16:
        fail(f"wt_dense_counts differs from its plain version ({err16} counts)")
    table.append(dict(
        name="wt_dense_counts", max_abs_err=err16, library_ms=None,
        ms=time_ms(lambda: k16.wt_dense_counts(compact, lo, hi)),
        graph_ms=graph_ms(lambda: k16.wt_dense_counts(compact, lo, hi)),
        plain_ms=time_ms(lambda: k16.dense_counts_plain(compact, lo, hi, 2048), iters=1),
        hybrid_ms=time_ms(lambda: k16.wt_dense_counts(hybrid, lo, hi)),
        hybrid_graph_ms=graph_ms(lambda: k16.wt_dense_counts(hybrid, lo, hi)),
        walk_ms=time_ms(lambda: k16.wt_dense_counts(compact, lo, hi, hist_max=0)),
        hybrid_walk_ms=time_ms(lambda: k16.wt_dense_counts(hybrid, lo, hi, hist_max=0)),
        histogram_route_ms=time_ms(lambda: k16.wt_dense_counts(compact, lo, hi,
                                                               hist_max=2**31 - 1), iters=5),
        psi_ms=time_ms(lambda: k15.fm_dense_counts(psi, lo, hi)),
        shape=f"[{B},{K}] ranges x {V} tokens, compact (ranges past {hmax['compact']} rows "
              f"walked) and hybrid (hybrid_ms: one 2-byte read a row up to {hmax['hybrid']} "
              "rows, the walk past them); walk_ms: every non-empty range walked; checked on "
              "every route against the plain sweep",
        # the compact layout's rows: one 4-bit code of each of `digits` levels
        bytes=out_bytes + rows_bytes(torch, N, lo, hi, hmax["compact"], compact.digits / 2),
    ))
    # the mask modes (what every exact_mask step reads: a bit a token) on
    # every route, eager and replayed from a graph, against the plain
    # version, itself the plain counts > 0 packed
    mask = k15.dense_mask_plain(psi, lo, hi, 2048)
    W = mask.shape[-1]
    err_m = {"fm_dense_mask": int((mask != count_mask.pack(want > 0)).sum()), "wt_dense_mask": 0}
    for name, fn, ix, routes in (
            ("fm_dense_mask", k15.fm_dense_mask, psi,
             (k15.MASK_HIST_MAX_ROWS, k15.HIST_MAX_ROWS, 0, k15.SPLIT_ROWS, 2**31 - 1)),
            ("wt_dense_mask", k16.wt_dense_mask, compact, (None, 0, 2**31 - 1)),
            ("wt_dense_mask", k16.wt_dense_mask, hybrid, (None, 0, 2**31 - 1))):
        for h in routes:
            mkw = {} if h is None else dict(hist_max=h)
            err_m[name] += int((fn(ix, lo, hi, **mkw) != mask).sum())
        err_m[name] += int((graph_result(torch, lambda fn=fn, ix=ix: fn(ix, lo, hi)) != mask).sum())
    for name, err in err_m.items():
        if err:
            fail(f"{name} differs from its plain version ({err} words)")
    log("dense mask by histogram threshold (rows: ms): psi: " + ", ".join(
        f"{h}{'*' if h == k15.MASK_HIST_MAX_ROWS else ''} "
        f"{time_ms(lambda h=h: k15.fm_dense_mask(psi, lo, hi, hist_max=h), iters=5):.4f}"
        for h in (0, 1 << 16, 1 << 18, 1 << 19, 1 << 20, 1 << 21, 2**31 - 1)))
    table.append(dict(
        name="fm_dense_mask", max_abs_err=err_m["fm_dense_mask"], library_ms=None,
        ms=time_ms(lambda: k15.fm_dense_mask(psi, lo, hi)),
        graph_ms=graph_ms(lambda: k15.fm_dense_mask(psi, lo, hi)),
        plain_ms=time_ms(lambda: k15.dense_mask_plain(psi, lo, hi, 2048), iters=2),
        counts_ms=time_ms(lambda: k15.fm_dense_counts(psi, lo, hi)),
        counts_graph_ms=graph_ms(lambda: k15.fm_dense_counts(psi, lo, hi)),
        rank_route_ms=time_ms(lambda: k15.fm_dense_mask(psi, lo, hi, hist_max=0), iters=5),
        histogram_route_ms=time_ms(lambda: k15.fm_dense_mask(psi, lo, hi, hist_max=2**31 - 1)),
        shape=f"[{B},{K}] ranges x {V} tokens -> [{B},{K},{W}] mask words, clusters of "
              f"{k15.CLUSTER} CTAs a group of ranges (counts_*: the counts mode on the same "
              "ranges; rank route: every range by one search a token, four words a warp)",
        # the ranges, the mask written, the histogram route's rows once
        bytes=R * 8 + R * W * 4 + rows_bytes(torch, N, lo, hi, k15.MASK_HIST_MAX_ROWS, 4),
    ))
    table.append(dict(
        name="wt_dense_mask", max_abs_err=err_m["wt_dense_mask"], library_ms=None,
        ms=time_ms(lambda: k16.wt_dense_mask(compact, lo, hi)),
        graph_ms=graph_ms(lambda: k16.wt_dense_mask(compact, lo, hi)),
        plain_ms=time_ms(lambda: k16.dense_mask_plain(compact, lo, hi, 2048), iters=1),
        hybrid_ms=time_ms(lambda: k16.wt_dense_mask(hybrid, lo, hi)),
        hybrid_graph_ms=graph_ms(lambda: k16.wt_dense_mask(hybrid, lo, hi)),
        counts_graph_ms=graph_ms(lambda: k16.wt_dense_counts(compact, lo, hi)),
        hybrid_counts_graph_ms=graph_ms(lambda: k16.wt_dense_counts(hybrid, lo, hi)),
        shape=f"[{B},{K}] ranges x {V} tokens -> [{B},{K},{W}] mask words, compact (the walk) "
              f"and hybrid (hybrid_*: rows up to {hmax['hybrid']}); counts_*: the counts mode",
        bytes=R * 8 + R * W * 4 + rows_bytes(torch, N, lo, hi, hmax["compact"],
                                             compact.digits / 2),
    ))
    # kernel 17 over the step's count mask, with the branches' states: its
    # streaming pass (the scores written, as diverse groups read them) and
    # the dense step's select (the scores ranked inside kernel 3's select,
    # never written)
    lp = torch.log_softmax(torch.randn(R, V, generator=g, device=dev) * 2, -1)
    lp = torch.round(lp * 4) / 4
    prev_count = (hi - lo).to(torch.int32)
    finished = torch.rand(B, K, generator=g, device=dev) < 0.1
    bs = torch.round(torch.randn(B, K, generator=g, device=dev) * 2) / 2 - 3
    bs[0, 1] = k8.NEG_INF
    dargs = (mask, lp, prev_count, finished, bs)
    dkw = dict(eos=2, pad=1, stop_at_count=0, always_allow_eos=False)
    bkw = dict(dkw, stop_at_count=2, always_allow_eos=True)
    got = k17.dense_scores(*dargs, **dkw)
    plain17 = k17.dense_scores_plain(*dargs, **dkw)
    err17 = mismatches(torch, (got,), (plain17,))
    err17 += mismatches(torch, (graph_result(torch, lambda: k17.dense_scores(*dargs, **dkw)),),
                        (plain17,))
    err17 += mismatches(torch, (k17.dense_scores(*dargs, **bkw),),
                        (k17.dense_scores_plain(*dargs, **bkw),))
    # a strided and an unaligned lp (read a token at a time), odd V
    wide = torch.log_softmax(torch.randn(R, V + 3, generator=g, device=dev), -1)
    wide = torch.round(wide * 4) / 4
    for lp2 in (wide[:, :V], wide.reshape(-1)[1:1 + R * V].reshape(R, V)):
        a2 = (mask, lp2, prev_count, finished, bs)
        err17 += mismatches(torch, (k17.dense_scores(*a2, **bkw),),
                            (k17.dense_scores_plain(*a2, **bkw),))
    if err17:
        fail(f"dense_scores differs from its plain version ({err17} elements)")
    gv, gi = k3.row_topk(got, 2 * K)
    wv, wi = k3.row_topk_plain(got, 2 * K)
    if not (torch.equal(gi, wi) and torch.equal(gv, wv)):
        fail("row_topk differs from its plain version on the dense rows")
    # the dense step's select: equal to kernel 3's plain top 2K of the plain
    # scores, eager and replayed from a graph, in both branch settings
    err_sel = 0
    for kw17 in (dkw, bkw):
        want_sel = k17.dense_select_plain(*dargs, 2 * K, **kw17)
        err_sel += mismatches(torch, k17.dense_select(*dargs, 2 * K, **kw17), want_sel)
        err_sel += mismatches(torch, graph_result(
            torch, lambda kw17=kw17: k17.dense_select(*dargs, 2 * K, **kw17)), want_sel)
    if err_sel:
        fail(f"dense_select differs from its plain version ({err_sel} elements)")
    tokens = torch.arange(V, dtype=torch.int32, device=dev).expand(B, K, V)
    n_allowed = int(k8.apply_branches(tokens, want > 0, prev_count, finished, **dkw).sum())

    def composed():  # the step in two launches: kernel 17's pass, then kernel 3
        return k3.row_topk(k17.dense_scores(*dargs, **dkw), 2 * K)

    table.append(dict(
        name="dense_scores", max_abs_err=err17, library_ms=None,
        ms=time_ms(lambda: k17.dense_scores(*dargs, **dkw)),
        graph_ms=graph_ms(lambda: k17.dense_scores(*dargs, **dkw)),
        plain_ms=time_ms(lambda: k17.dense_scores_plain(*dargs, **dkw)),
        topk_dense_ms=time_ms(lambda: k3.row_topk(got, 2 * K), iters=5),
        topk_dense_plain_ms=time_ms(lambda: k3.row_topk_plain(got, 2 * K), iters=2),
        shape=f"mask [{B},{K},{W}] -> [{B},{K * V}] f32, the streaming pass "
              f"({n_allowed} tokens allowed; topk_dense_ms: kernel 3's top-{2 * K} of those "
              "rows)",
        # the mask read and the scores written, the allowed tokens'
        # log-probs, the row state once
        bytes=R * W * 4 + R * V * 4 + n_allowed * 4 + R * 9,
    ))
    table.append(dict(
        name="dense_select", max_abs_err=err_sel, library_ms=None,
        ms=time_ms(lambda: k17.dense_select(*dargs, 2 * K, **dkw)),
        graph_ms=graph_ms(lambda: k17.dense_select(*dargs, 2 * K, **dkw)),
        plain_ms=time_ms(lambda: k17.dense_select_plain(*dargs, 2 * K, **dkw), iters=2),
        composed_ms=time_ms(composed, iters=5), composed_graph_ms=graph_ms(composed),
        shape=f"mask [{B},{K},{W}] and lp [{R},{V}] -> the top {2 * K} of [{B},{K * V}] "
              "scores, one launch of kernel 3's select (composed_ms: kernel 17's pass, then "
              "kernel 3)",
        # the mask read once, the allowed tokens' log-probs, the row state,
        # the top 2K written
        bytes=R * W * 4 + n_allowed * 4 + R * 9 + B * 2 * K * 12,
    ))
    log(f"dense kernel phases: {time.perf_counter() - t0:.1f} s")
    del got, plain17, want, mask, lp
    torch.cuda.synchronize()
    return table


def mode_kernel_phases(np, torch, cfg, V, B, K, window):
    """Kernel 19 (the k-th value at 50 on [B*K, V] log-probs), kernel 8's
    free and speculative modes and the warper (kernel 3's select in its
    warper mode) against their plain versions at the decode modes' shapes,
    each timed beside its default mode and its library yardstick.  (The modes' top-256 is kernel 3's:
    the ``row_topk sites:`` line holds it at k = 256.)"""
    from seal_tpu_torch.kernels import beam_select as k8
    from seal_tpu_torch.kernels import row_select as k19
    from seal_tpu_torch.kernels import row_topk as k3
    from seal_tpu_torch.kernels import triton_logsoftmax as k4

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    i32, rows, m = torch.int32, B * K, 256
    eos, pad = cfg.eos_token_id, cfg.pad_token_id
    table = []
    lp = torch.log_softmax(torch.randn(rows, V, generator=g, device=dev) * 2, -1)
    lp[:, pad] = float("-inf")  # a SEAL-bias column
    lpq = torch.round(lp * 8) / 8  # ties
    lpq[0, ::2] = 0.0
    lpq[0, 1::2] = -0.0

    # kernel 19 (kernel 3's select in its k-th-value mode): the warper's k
    # and others, on plain and tied rows, and on rows that corner the k-th
    # place (ties across it, signed zeros at it, -inf and NEG_INF plateaus
    # reaching it, k = 1 and k = V); eager and replayed from a graph
    adv = lpq[:8].clone()
    adv[1] = -1.0
    adv[1, :47] = 3.0
    adv[1, 47::2] = 0.0
    adv[1, 48::2] = -0.0
    adv[2] = float("-inf")
    adv[2, :20] = 1.0
    adv[3] = k8.NEG_INF
    adv[3, ::3000] = -2.0
    adv[4] = 7.5
    adv[5, : V // 2] = float("-inf")
    err19 = 0
    for x, k in ((lp, 50), (lpq, 50), (lpq, 1), (lpq, 1024), (lpq[:B], 256), (adv, 1),
                 (adv, 50), (adv, 2000), (adv, V)):
        want19 = k19.row_kth_plain(x, k)
        err19 += mismatches(torch, (k19.row_kth(x, k),), (want19,))
        err19 += mismatches(torch, (graph_result(torch, lambda x=x, k=k: k19.row_kth(x, k)),),
                            (want19,))
    if err19:
        fail(f"row_kth differs from its plain version ({err19} elements)")
    p19 = k19.plan(rows, V, 50)
    table.append(dict(
        name="row_kth", max_abs_err=err19,
        ms=time_ms(lambda: k19.row_kth(lp, 50)),
        plain_ms=time_ms(lambda: k19.row_kth_plain(lp, 50), iters=5),
        library_ms=time_ms(lambda: torch.topk(lp, 50)),
        graph_ms=graph_ms(lambda: k19.row_kth(lp, 50)),
        library_graph_ms=graph_ms(lambda: torch.topk(lp, 50)),
        shape=f"[{rows},{V}] k=50, one f32 a row; {p19.splits} CTAs of {p19.threads} threads "
              "a row (kernel 3's select, k-th-value mode)",
        bytes=lp.numel() * 4 + rows * 4,
    ))

    # kernel 8, free generation: kernel 3's top-2K of [B, K*256] scores,
    # then the epilogue through kernel 3's top-256 token table
    top_lp, tok = k3.row_topk(lpq, m)
    tok = tok.to(i32)
    bs = torch.round(torch.randn(B, K, generator=g, device=dev) * 2) / 2 - 3
    bs[0, 1] = k8.NEG_INF
    top_cons, top_idx = k3.row_topk((top_lp.reshape(B, K, m) + bs[..., None]).reshape(B, -1),
                                    2 * K)
    targs = (top_cons, top_idx, lpq, bs, K, K, eos)
    err8f = mismatches(torch, k8.beam_select_top(*targs, tokens=tok),
                       k8.beam_select_top_plain(*targs, tokens=tok))
    if err8f:
        fail(f"beam_select_free differs from its plain version ({err8f} elements)")
    table.append(dict(
        name="beam_select_free", max_abs_err=err8f, library_ms=None,
        ms=time_ms(lambda: k8.beam_select_top(*targs, tokens=tok)),
        plain_ms=time_ms(lambda: k8.beam_select_top_plain(*targs, tokens=tok)),
        default_ms=time_ms(lambda: k8.beam_select_top(*targs)),
        shape=f"top-{2 * K} of [{B},{K * m}] through a [{rows},{m}] token table (default_ms: "
              "the step-0 epilogue on the same picks)",
        # the picks, their table and log-prob reads, the nine outputs
        bytes=B * 2 * K * (12 + 4 + 4) + B * (2 * K * 17 + K * 13),
    ))

    # kernel 8, speculative: a 256-slot proposal buffer whose failed slots
    # stay candidates, the window, EOS and PAD, beam 15
    def rbool(p, shape):
        return torch.rand(shape, generator=g, device=dev) < p

    buf = (tok.reshape(B, K, m), top_lp.reshape(B, K, m), rbool(0.4, (B, K, m)))
    win_valid = rbool(0.7, (B, K, window))
    win_tok = torch.where(win_valid, torch.randint(0, 400, (B, K, window), generator=g,
                                                   device=dev, dtype=i32), pad)
    win_lp = torch.gather(lpq, 1, win_tok.reshape(rows, -1).long()).reshape(B, K, window)
    eos_ok = rbool(0.5, (B, K, m + 1))[..., m:]
    prev_count = torch.randint(0, 6, (B, K), generator=g, device=dev, dtype=i32)
    finished = rbool(0.1, (B, K))
    sargs = (buf, m, win_tok, win_valid, win_lp, eos_ok, lpq, prev_count, finished, bs)
    skw = dict(K=K, eos=eos, pad=pad, stop_at_count=0, always_allow_eos=False)
    err8s = 0
    for ties in (False, True):
        (got, _), (want, _) = (k8.beam_select(*sargs, ties=ties, keep_invalid=True, **skw),
                               k8.beam_select_plain(*sargs, None, None, ties=ties,
                                                    keep_invalid=True, **skw))
        err8s += mismatches(torch, got, want)
    if err8s:
        fail(f"beam_select_spec differs from its plain version ({err8s} elements)")
    ncand = m + window + 2
    table.append(dict(
        name="beam_select_spec", max_abs_err=err8s, library_ms=None,
        ms=time_ms(lambda: k8.beam_select(*sargs, keep_invalid=True, **skw)),
        plain_ms=time_ms(lambda: k8.beam_select_plain(*sargs, None, None, keep_invalid=True,
                                                      **skw)),
        default_ms=time_ms(lambda: k8.beam_select(*sargs, **skw)),
        shape=f"[{B},{K},{ncand}] ({K * ncand} candidates a query; default_ms: the fast "
              "path's mode on the same inputs)",
        bytes=rows * (m * 9 + window * 9 + 1 + 4 + 1 + 4) + rows * 8
        + B * (2 * K * 13 + K * 13 + 4 * K),
    ))

    # the warper: kernel 3's select in its warper mode (the k-th value, the
    # mask, the log-softmax and the ban in one launch) against its plain
    # version (kernel 19's and kernel 4's plain versions), at the step's
    # shape and, for the held limits, on the corner rows above at k = 1, 50
    # and V and at a width split over a cluster (250,000 columns, 8 CTAs)
    logits = torch.randn(rows, V, generator=g, device=dev) * 3
    logits[:, pad] = float("-inf")
    wide = torch.randn(8, 250000, generator=g, device=dev) * 3
    err4 = 0.0
    for x, k, ban in ((logits, 50, eos), (logits, 50, -1), (adv, 1, eos), (adv, 50, eos),
                      (adv, V, -1), (wide, 50, eos)):
        want = k19.topk_log_softmax_plain(x, k, ban, k8.NEG_INF)
        live = want > k8.NEG_INF / 2
        for got in (k19.topk_log_softmax(x, k, ban, k8.NEG_INF),
                    graph_result(torch, lambda x=x, k=k, ban=ban: k19.topk_log_softmax(
                        x, k, ban, k8.NEG_INF))):
            if not torch.equal(got > k8.NEG_INF / 2, live):
                fail(f"topk_log_softmax: the masked set differs at [{x.shape[0]},{x.shape[1]}] "
                     f"k={k}")
            err4 = max(err4, float((got[live] - want[live]).abs().max()))
    if err4 > LOGSOFTMAX_ATOL:
        fail(f"topk_log_softmax differs from its plain version (max err {err4})")
    pw = k19.plan(rows, V, 50)
    table.append(dict(
        name="topk_log_softmax", max_abs_err=err4, atol=LOGSOFTMAX_ATOL, library_ms=None,
        ms=time_ms(lambda: k19.topk_log_softmax(logits, 50, eos, k8.NEG_INF)),
        graph_ms=graph_ms(lambda: k19.topk_log_softmax(logits, 50, eos, k8.NEG_INF)),
        plain_ms=time_ms(lambda: k19.topk_log_softmax_plain(logits, 50, eos, k8.NEG_INF),
                         iters=5),
        default_ms=time_ms(lambda: k4.log_softmax_ban(logits, eos, k8.NEG_INF)),
        wide_ms=time_ms(lambda: k19.topk_log_softmax(wide, 50, eos, k8.NEG_INF)),
        shape=f"[{rows},{V}] k=50 with the min-length ban, {pw.splits} CTA(s) of "
              f"{pw.threads} threads a row (default_ms: kernel 4 without a warper; wide_ms: "
              "[8,250000], 8 CTAs a row)",
        # the logits read once, the log-probs written once
        bytes=2 * logits.numel() * 4, flops=3 * logits.numel(),
    ))
    torch.cuda.synchronize()
    return table


def draw_margin(torch, cons, noise, mask=None):
    """Each chain's gap between its best two perturbed finite scores [rows];
    infinite for a chain with no finite slot (it takes EOS whatever the
    noise)."""
    from seal_tpu_torch.kernels.beam_select import NEG_INF

    if mask is not None:
        cons = torch.where(mask, cons, NEG_INF)
    scored = torch.where(cons > NEG_INF / 4, cons + noise, NEG_INF)
    top2 = scored.reshape(-1, scored.shape[-1]).topk(2, -1).values
    return torch.where(top2[:, 0] > NEG_INF / 2, top2[:, 0] - top2[:, 1], float("inf"))


def sample_mismatches(torch, got, want, clear):
    """Kernel 20's outputs against the plain version's on the chains whose
    draw is clear of a near-tie (``clear`` [B*K]); floats bit for bit."""
    B = got[0].shape[0]
    hist = clear.reshape(B, -1).repeat(1, 2).reshape(-1)
    return sum(mismatches(torch, (a.reshape(-1)[m],), (b.reshape(-1)[m],))
               for a, b, m in zip(got, want, (hist,) * 4 + (clear,) * 4))


def sample_kernel_phases(np, torch, cfg, V, B, K, window, device="cuda"):
    """Kernel 8's candidate mode at the diverse, sampling and speculative
    routes' widths; kernel 20 on step 0's [B*K, V] rows under a corpus mask
    and on the sampling route's candidates (its Philox words against the
    plain version's exactly, Gumbel values within SAMPLE_ULPS, draws equal on
    chains clear of a near-tie, 2^16 draws of one row against its softmax);
    kernel 21 at three groups, penalties 0 and 0.5, on the diverse route's
    candidates (its list route) and on V-wide rows (its wide route), in both
    orders, each beside its chunked route; all against their plain
    versions, timed."""
    from scipy import stats

    from seal_tpu_torch.kernels import beam_select as k8
    from seal_tpu_torch.kernels import count_mask
    from seal_tpu_torch.kernels import dense_scores as k17
    from seal_tpu_torch.kernels import diverse_select as k21
    from seal_tpu_torch.kernels import row_topk as k3
    from seal_tpu_torch.kernels import sample_select as k20

    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(20)
    i32, rows = torch.int32, B * K
    eos, pad = cfg.eos_token_id, cfg.pad_token_id
    table = []
    lp = torch.log_softmax(torch.randn(rows, V, generator=g, device=dev) * 2, -1)
    lp[:, pad] = float("-inf")  # a SEAL-bias column
    corpus = torch.rand(V, generator=g, device=dev) < 0.8
    bs = torch.round(torch.randn(B, K, generator=g, device=dev) * 2) / 2 - 3
    bs[:, 1::5] = k8.NEG_INF

    def rbool(p, shape):
        return torch.rand(shape, generator=g, device=dev) < p

    def candidate_inputs(n_buf, w, keep_invalid):
        top_lp, top_idx = k3.row_topk(lp, n_buf)
        buf = (top_idx.to(i32).reshape(B, K, n_buf), top_lp.reshape(B, K, n_buf),
               rbool(0.5, (B, K, n_buf)))
        win_valid = rbool(0.7, (B, K, w))
        win_tok = torch.where(win_valid, torch.randint(0, 400, (B, K, w), generator=g, device=dev,
                                                       dtype=i32), pad)
        win_lp = torch.gather(lp, 1, win_tok.reshape(rows, -1).long()).reshape(B, K, w)
        args = (buf, n_buf, win_tok, win_valid, win_lp, rbool(0.5, (B, K, 2))[..., 1:], lp,
                torch.randint(0, 6, (B, K), generator=g, device=dev, dtype=i32),
                rbool(0.1, (B, K)))
        return args, dict(eos=eos, pad=pad, keep_invalid=keep_invalid)

    # kernel 8, candidate mode: the diverse proposal route (2K-slot buffer),
    # sampling's (a max(2K, 256)-slot buffer) and the speculative round's
    n_samp = max(2 * K, 256)
    widths = {"diverse": (2 * K, window, False), "sample": (n_samp, window, False),
              "spec": (256, 128, True)}
    inputs = {r: candidate_inputs(*v) for r, v in widths.items()}
    # a warp a beam row, its first instances from a hash table; no table
    # in device memory at these widths
    t0 = k8.CAND_TABLE.launches
    err8c = sum(mismatches(torch, k8.beam_candidates(*a, **kw), k8.candidates_plain(*a, **kw))
                for a, kw in inputs.values())
    if err8c or k8.CAND_TABLE.launches != t0:
        fail(f"beam_candidates differs from its plain version ({err8c} elements) or took the "
             "table")
    ms8 = {r: time_ms(lambda a=a, kw=kw: k8.beam_candidates(*a, **kw))
           for r, (a, kw) in inputs.items()}
    g8 = {r: graph_ms(lambda a=a, kw=kw: k8.beam_candidates(*a, **kw))
          for r, (a, kw) in inputs.items()}
    n8 = {r: n_buf + w + 2 for r, (n_buf, w, _) in widths.items()}
    table.append(dict(
        name="beam_candidates", max_abs_err=err8c, library_ms=None, ms=ms8["diverse"],
        plain_ms=time_ms(lambda: k8.candidates_plain(*inputs["diverse"][0],
                                                     **inputs["diverse"][1])),
        sample_ms=ms8["sample"], spec_ms=ms8["spec"],
        graph_ms=g8["diverse"], sample_graph_ms=g8["sample"], spec_graph_ms=g8["spec"],
        shape=f"[{B},{K},{n8['diverse']}] (sample_*: [{B},{K},{n8['sample']}]; spec_*: "
              f"[{B},{K},{n8['spec']}] with keep_invalid)",
        # buffer (tok, lp, valid), window (tok, valid, lp), EOS membership,
        # the EOS and PAD log-probs, count and finished flag in; three outputs
        bytes=rows * (2 * K * 9 + window * 9 + 1 + 8 + 5) + rows * n8["diverse"] * 12,
    ))

    # kernel 20: the noise, then step 0's rows and the sampling candidates
    words, g20 = k20.noise_on_card(0, 0, rows, V, dev)
    want_words = k20.philox_words(0, 0, rows, V, dev)
    err_words = int((words != want_words).sum())
    g_plain = k20.gumbel_of_words(want_words)
    ulps = float(((g20 - g_plain).abs() / (g_plain.abs().clamp(min=1.0) * 2.0**-23)).max())
    del words, want_words, g20, g_plain
    args0 = (lp, lp, None, torch.zeros(B, K, device=dev), 5, 0)
    got = k20.sample_select(*args0, eos=eos, pad=pad, mask=corpus)
    want = k20.sample_select_plain(*args0, eos=eos, pad=pad, mask=corpus)
    clear0 = draw_margin(torch, lp, k20.gumbel_noise(5, 0, rows, V, dev), corpus) > SAMPLE_MARGIN
    err20 = sample_mismatches(torch, got, want, clear0)
    tok8, cons8, lp8 = k8.beam_candidates(*inputs["sample"][0], **inputs["sample"][1])
    args1 = (cons8, lp8, tok8, bs, 5, 3)
    got = k20.sample_select(*args1, eos=eos, pad=pad)
    want = k20.sample_select_plain(*args1, eos=eos, pad=pad)
    clear1 = draw_margin(torch, cons8, k20.gumbel_noise(5, 3, rows, n8["sample"], dev)
                         .reshape(cons8.shape)) > SAMPLE_MARGIN
    err20 += sample_mismatches(torch, got, want, clear1)
    # 2^16 chains of one 16-candidate row, 4 slots masked: the draws against
    # the softmax of the 12 allowed log-probs
    rng = np.random.default_rng(7)
    row = torch.as_tensor(np.log(rng.dirichlet(np.ones(16))).astype(np.float32), device=dev)
    allowed = torch.ones(16, dtype=torch.bool, device=dev)
    allowed[[0, 5, 9, 15]] = False
    many = row.expand(1, 1 << 16, 16).contiguous()
    drawn = k20.sample_select(many, many, None, torch.zeros(1, 1 << 16, device=dev), 5, 3, eos=eos,
                              pad=pad, mask=allowed)[4][0]
    counts = torch.bincount(drawn.long(), minlength=16).cpu().numpy()
    ok = allowed.cpu().numpy()
    p_chi = float(stats.chisquare(counts[ok], torch.softmax(row[allowed].double(), 0).cpu()
                                  .numpy() * (1 << 16)).pvalue)
    if err_words or ulps > SAMPLE_ULPS or err20 or counts[~ok].sum() or p_chi <= 1e-3:
        fail(f"sample_select: {err_words} Philox words differ, Gumbel values {ulps:.2f} ulps apart, "
             f"{err20} outputs differ on clear draws, chi-square p {p_chi:.3g}")
    log(f"sample_select checks: Philox words equal on [{rows},{V}]: {err_words == 0}; Gumbel "
        f"values within {ulps:.2f} ulps of max(|g|, 1); clear draws {int(clear0.sum())}/{rows} (step 0) and "
        f"{int(clear1.sum())}/{rows} (candidates), all equal: {err20 == 0}; 2^16 draws of one "
        f"row: chi-square p {p_chi:.4f}")
    # batch 8's V-wide rows: a cluster of CTAs a row
    r8 = rows // 4
    args8 = (lp[:r8], lp[:r8], None, torch.zeros(B // 4, K, device=dev), 5, 0)
    got = k20.sample_select(*args8, eos=eos, pad=pad, mask=corpus)
    want = k20.sample_select_plain(*args8, eos=eos, pad=pad, mask=corpus)
    err20 += sample_mismatches(torch, got, want, clear0[:r8])
    err20 += sample_mismatches(torch, graph_result(torch, lambda: k20.sample_select(
        *args0, eos=eos, pad=pad, mask=corpus)), k20.sample_select_plain(
        *args0, eos=eos, pad=pad, mask=corpus), clear0)
    err_list = sample_mismatches(torch, graph_result(torch, lambda: k20.sample_select(
        *args1, eos=eos, pad=pad)), k20.sample_select_plain(*args1, eos=eos, pad=pad), clear1)
    # the count-reading mode (a sampled exact_mask step): a step's sparse
    # count masks, every branch, against its plain version and beside the
    # composition of kernel 17's streaming pass and the V-wide draw
    cmask = count_mask.pack(torch.rand(B, K, V, generator=g, device=dev) < 0.07)
    prev_count = torch.randint(0, 6, (B, K), generator=g, device=dev, dtype=i32)
    finished = rbool(0.1, (B, K))
    zero = torch.zeros(B, K, device=dev)
    ckw = dict(eos=eos, pad=pad, stop_at_count=1, always_allow_eos=True)
    cargs = (cmask, lp, prev_count, finished, bs, 5, 4)
    cons_c = k17.dense_scores_plain(cmask, lp, prev_count, finished, zero, **ckw)
    clear_c = draw_margin(torch, cons_c.reshape(rows, V),
                          k20.gumbel_noise(5, 4, rows, V, dev)) > SAMPLE_MARGIN
    want_c = k20.sample_select_counts_plain(*cargs, **ckw)
    err_counts = sample_mismatches(torch, k20.sample_select_counts(*cargs, **ckw), want_c, clear_c)
    err_counts += sample_mismatches(torch, graph_result(
        torch, lambda: k20.sample_select_counts(*cargs, **ckw)), want_c, clear_c)
    if err20 or err_list or err_counts:
        fail(f"sample_select: {err20} V-wide, {err_list} list and {err_counts} count-reading "
             "outputs differ from the plain version on clear draws")

    def composed_counts():  # the scores written, then drawn: two launches
        cons = k17.dense_scores(cmask, lp, prev_count, finished, zero, **ckw)
        return k20.sample_select(cons.reshape(B, K, V), lp, None, bs, 5, 4, eos=eos, pad=pad)

    table.append(dict(
        name="sample_select", max_abs_err=err20, library_ms=None,
        ms=time_ms(lambda: k20.sample_select(*args0, eos=eos, pad=pad, mask=corpus)),
        graph_ms=graph_ms(lambda: k20.sample_select(*args0, eos=eos, pad=pad, mask=corpus)),
        plain_ms=time_ms(lambda: k20.sample_select_plain(*args0, eos=eos, pad=pad, mask=corpus),
                         iters=3),
        cluster_ms=time_ms(lambda: k20.sample_select(*args8, eos=eos, pad=pad, mask=corpus)),
        cluster_graph_ms=graph_ms(lambda: k20.sample_select(*args8, eos=eos, pad=pad,
                                                            mask=corpus)),
        ulps=ulps, chi_square_p=p_chi,
        shape=f"[{rows},{V}] under a corpus mask, {k20.plan(rows, V).splits} CTA a row "
              f"(cluster_ms: [{r8},{V}], {k20.plan(r8, V).splits} CTAs a row)",
        # the log-probs once (cons and cand_lp are one tensor), the mask, the
        # chain scores, the eight outputs; two logf, an add and a compare a slot
        bytes=rows * V * 4 + V + rows * 4 + B * (2 * K * 13 + K * 13), flops=4 * rows * V,
    ))
    table.append(dict(
        name="sample_select_list", max_abs_err=err_list, library_ms=None,
        ms=time_ms(lambda: k20.sample_select(*args1, eos=eos, pad=pad)),
        graph_ms=graph_ms(lambda: k20.sample_select(*args1, eos=eos, pad=pad)),
        plain_ms=time_ms(lambda: k20.sample_select_plain(*args1, eos=eos, pad=pad)),
        shape=f"[{B},{K},{n8['sample']}] candidates with their tokens, "
              f"{k20.plan(rows, n8['sample']).route} route",
        # cons, cand_lp and tokens once, the chain scores, the eight outputs
        bytes=rows * n8["sample"] * 12 + rows * 4 + B * (2 * K * 13 + K * 13),
        flops=4 * rows * n8["sample"],
    ))
    n_allowed = int((cons_c > k8.NEG_INF / 2).sum())
    table.append(dict(
        name="sample_select_counts", max_abs_err=err_counts, library_ms=None,
        ms=time_ms(lambda: k20.sample_select_counts(*cargs, **ckw)),
        graph_ms=graph_ms(lambda: k20.sample_select_counts(*cargs, **ckw)),
        plain_ms=time_ms(lambda: k20.sample_select_counts_plain(*cargs, **ckw), iters=3),
        composed_ms=time_ms(composed_counts), composed_graph_ms=graph_ms(composed_counts),
        shape=f"[{B},{K},{V}] count masks, {100 * n_allowed / (rows * V):.1f}% allowed "
              "(composed: kernel 17's streaming pass, then the V-wide draw)",
        # the count mask once, the allowed tokens' log-probs, the row state
        # and chain scores, the eight outputs; two logf, an add and a compare
        # an allowed slot
        bytes=cmask.numel() * 4 + n_allowed * 4 + rows * 9 + B * (2 * K * 13 + K * 13),
        flops=4 * n_allowed,
    ))

    # kernel 21: three groups at penalties 0 and 0.5, in both orders, on the
    # diverse route's candidates (the list route) and on step 0's V-wide rows
    # under the corpus mask (the wide route), each beside the chunked route
    # forced on the same inputs, all against the plain version; each route's
    # kernels a call counted by the profiler; the wide route's proof counter
    # must read 0
    tok8, cons8, _ = k8.beam_candidates(*inputs["diverse"][0], **inputs["diverse"][1])
    wide = lp.reshape(B, K, V)
    err21 = err21w = 0
    for pen in (0.0, 0.5):
        for ties in (False, True):
            kw = dict(groups=3, penalty=pen, eos=eos, vocab=V, ties=ties)
            want = k21.diverse_select_plain(cons8, tok8, bs, **kw)
            for force in (None, "chunked"):
                err21 += mismatches(torch, k21.diverse_select(cons8, tok8, bs, force=force, **kw),
                                    want)
            want = k21.diverse_select_plain(wide, None, bs, mask=corpus, **kw)
            for force in (None, "chunked"):
                err21w += mismatches(torch, k21.diverse_select(wide, None, bs, mask=corpus,
                                                               force=force, **kw), want)
    kw21 = dict(groups=3, penalty=0.5, eos=eos, vocab=V)
    per_call = {
        "wide": kernels_per_call(torch, lambda: k21.diverse_select(wide, None, bs, mask=corpus,
                                                                   **kw21)),
        "list": kernels_per_call(torch, lambda: k21.diverse_select(cons8, tok8, bs, **kw21)),
        "chunked": kernels_per_call(torch, lambda: k21.diverse_select(
            wide, None, bs, mask=corpus, force="chunked", **kw21))}
    proof = k21.proof_failures(dev)
    routes = {r: k21.route(B, K, n, groups=3, penalty=0.5, vocab=V, wide=w)[0]
              for r, n, w in (("wide", V, True), ("list", n8["diverse"], False))}
    log(f"diverse_select routes: {routes}; kernels a call {per_call} (want wide 2, list 1, "
        f"chunked 6); survivors a group on the wide route {k21.wide_survivors(K, 3, 0.5)}; "
        f"proof counter {proof}")
    if err21 or err21w:
        fail(f"diverse_select differs from its plain version ({err21} list, {err21w} wide "
             "elements)")
    if per_call != {"wide": 2, "list": 1, "chunked": 6} or proof or routes != {
            "wide": "wide", "list": "list"}:
        fail(f"diverse_select: kernels a call {per_call}, proof counter {proof}, routes {routes}")
    # the list route against the chunked one by a group's slots (3 groups of
    # 5 beams: 320, 1,280, 4,100 and 16,380 slots; each forced, the default
    # named: the list route up to LIST_MAX), each call held to the plain
    # version; graph-replayed ms a call
    gl = torch.Generator(device=dev).manual_seed(21)
    cells21, err21s = [], 0
    for n in (64, 256, 820, 3276):
        cl = torch.where(torch.rand(B, K, n, generator=gl, device=dev) < 0.7,
                         torch.round(torch.randn(B, K, n, generator=gl, device=dev) * 4) / 4 - 3,
                         k8.NEG_INF)
        tl = torch.randint(0, V, (B, K, n), generator=gl, device=dev, dtype=torch.int32)
        want = k21.diverse_select_plain(cl, tl, bs, **kw21)
        ms = {}
        for force in ("list", "chunked"):
            err21s += mismatches(torch, k21.diverse_select(cl, tl, bs, force=force, **kw21), want)
            ms[force] = graph_ms(lambda f=force: k21.diverse_select(cl, tl, bs, force=f, **kw21))
        name = k21.route(B, K, n, groups=3, penalty=0.5, vocab=V, wide=False)[0]
        cells21.append(f"{K // 3 * n} ({name}): list {ms['list']:.4f}, chunked "
                       f"{ms['chunked']:.4f}")
    log(f"diverse_select by slots a group, [B, K] = [{B}, {K}] in 3 groups (graph ms): "
        + "; ".join(cells21))
    if err21s:
        fail(f"diverse_select differs from its plain version on wider lists ({err21s} elements)")
    table.append(dict(
        name="diverse_select", max_abs_err=err21, library_ms=None,
        ms=time_ms(lambda: k21.diverse_select(cons8, tok8, bs, **kw21)),
        graph_ms=graph_ms(lambda: k21.diverse_select(cons8, tok8, bs, **kw21)),
        plain_ms=time_ms(lambda: k21.diverse_select_plain(cons8, tok8, bs, **kw21)),
        ties_ms=time_ms(lambda: k21.diverse_select(cons8, tok8, bs, ties=True, **kw21)),
        chunked_ms=time_ms(lambda: k21.diverse_select(cons8, tok8, bs, force="chunked", **kw21)),
        chunked_graph_ms=graph_ms(lambda: k21.diverse_select(cons8, tok8, bs, force="chunked",
                                                             **kw21)),
        kernels_per_call=per_call["list"],
        shape=f"[{B},{K},{n8['diverse']}] in 3 groups, the list route (ties_ms: exact_ties; "
              "chunked_ms: the chunked route forced)",
        # candidates (score, token) and beam scores in, the eight outputs
        bytes=rows * n8["diverse"] * 8 + rows * 4 + B * (2 * K * 13 + K * 13),
    ))
    table.append(dict(
        name="diverse_select_wide", max_abs_err=err21w, library_ms=None,
        ms=time_ms(lambda: k21.diverse_select(wide, None, bs, mask=corpus, **kw21)),
        graph_ms=graph_ms(lambda: k21.diverse_select(wide, None, bs, mask=corpus, **kw21)),
        plain_ms=time_ms(lambda: k21.diverse_select_plain(wide, None, bs, mask=corpus, **kw21),
                         iters=3),
        nopen_ms=time_ms(lambda: k21.diverse_select(wide, None, bs, mask=corpus,
                                                    **{**kw21, "penalty": 0.0})),
        ties_ms=time_ms(lambda: k21.diverse_select(wide, None, bs, mask=corpus, ties=True,
                                                   **kw21)),
        chunked_ms=time_ms(lambda: k21.diverse_select(wide, None, bs, mask=corpus,
                                                      force="chunked", **kw21)),
        chunked_graph_ms=graph_ms(lambda: k21.diverse_select(wide, None, bs, mask=corpus,
                                                             force="chunked", **kw21), launches=5),
        kernels_per_call=per_call["wide"], proof_failures=k21.proof_failures(dev),
        shape=f"[{B},{K},{V}] in 3 groups under a corpus mask, penalty 0.5, the wide route "
              f"(top {k21.wide_survivors(K, 3, 0.5)} a group; nopen_ms: penalty 0; chunked_ms: "
              "the chunked route forced)",
        # the rows once, the mask, the beam scores, the eight outputs
        bytes=rows * V * 4 + V + rows * 4 + B * (2 * K * 13 + K * 13),
    ))
    torch.cuda.synchronize()
    return table


def locate_phase(np, torch, searcher, unit, zero_counts, read_counts):
    """Kernel 18 on the ranker's workload: every occurrence row of one
    unit's keys (at most ``max_hits`` a key), located in a ``keep_sa`` copy
    of the searcher's index, then the documents of those positions; both
    against their plain versions, and a sample against the host index."""
    from seal_tpu_torch.index.device_index import TorchFMIndex
    from seal_tpu_torch.kernels import locate as k18
    from seal_tpu_torch.ops import fm_ops

    host = searcher.fm_index
    six = TorchFMIndex.from_host(host, vocab=searcher.model_cfg.vocab_size, device="cuda",
                                 keep_sa=True)
    n_tok = six.n_rows - 1
    log(f"index bytes: psi with keep_sa {six.memory_bytes()} ({six.memory_bytes() / n_tok:.2f} "
        f"B/token); default {searcher.device_index.memory_bytes()} "
        f"({searcher.device_index.memory_bytes() / n_tok:.2f} B/token)")
    keys = [list(n) for item in searcher.process_batch(unit)
            for n, _ in (item[0] if isinstance(item, tuple) else item)]
    spans = [(lo, min(hi, lo + searcher.max_hits)) for lo, hi in searcher._device_ranges(keys)]
    rows = torch.as_tensor(np.concatenate([np.arange(a, b) for a, b in spans if b > a])
                           .astype(np.int32), device="cuda")
    zero_counts()
    pos = fm_ops.locate_rows(six, rows)
    docs = fm_ops.doc_index_of(six, pos)
    torch.cuda.synchronize()
    launches = read_counts("locate")
    err = int((pos != k18.locate_rows_plain(six.sa, rows)).sum())
    err += int((docs != k18.doc_index_of_plain(six.beginnings, pos)).sum())
    pick = np.random.default_rng(7).choice(rows.numel(), size=min(300, rows.numel()),
                                           replace=False)
    rows_h, pos_h, docs_h = rows.cpu().numpy(), pos.cpu().numpy(), docs.cpu().numpy()
    err += sum(int(host.locate(int(rows_h[i])) != pos_h[i])
               + int(host.get_doc_index(int(pos_h[i])) != docs_h[i]) for i in pick)
    if err:
        fail(f"locate_rows / doc_index_of differ from their plain versions or the host ({err})")
    n = rows.numel()
    log(f"locate: {len(keys)} keys of one {len(unit)}-query unit, {n} occurrence rows (at most "
        f"{searcher.max_hits} a key) -> {len(np.unique(docs_h))} documents; launches {launches}; "
        f"{len(pick)} sampled rows equal the host's locate / get_doc_index")
    beg = six.beginnings
    shape = f"{n} rows of {len(keys)} keys"
    # the search beside torch.searchsorted (same int32 output, one call),
    # eager back to back (host launch cost included) and graph-replayed
    # (device time alone), in turns
    kern = lambda: k18.doc_index_of(beg, pos)  # noqa: E731
    lib = lambda: torch.searchsorted(beg, pos, right=True, out_int32=True)  # noqa: E731
    eager = {"kernel": [], "library": []}
    graphed = {"kernel": [], "library": []}
    for name in ("kernel", "library", "library", "kernel"):
        fn = kern if name == "kernel" else lib
        eager[name].append(time_ms(fn, iters=200))
        graphed[name].append(graph_ms(fn))
    log(f"doc_index_of search ({CARD}), {n} positions over {beg.numel()} beginnings, in turns "
        f"(kernel, searchsorted, searchsorted, kernel): eager {eager['kernel'][0]:.4f} "
        f"{eager['library'][0]:.4f} {eager['library'][1]:.4f} {eager['kernel'][1]:.4f} ms; "
        f"graph-replayed {graphed['kernel'][0]:.4f} {graphed['library'][0]:.4f} "
        f"{graphed['library'][1]:.4f} {graphed['kernel'][1]:.4f} ms")
    return [
        dict(name="locate_rows", max_abs_err=err, library_ms=None, shape=shape,
             ms=time_ms(lambda: k18.locate_rows(six.sa, rows)),
             plain_ms=time_ms(lambda: k18.locate_rows_plain(six.sa, rows)),
             bytes=n * 12),  # a row in, its sa word, a position out
        dict(name="doc_index_of", max_abs_err=err, shape=f"{n} positions over {beg.numel()} "
             "beginnings", ms=min(eager["kernel"]),
             plain_ms=time_ms(lambda: k18.doc_index_of_plain(beg, pos)),
             library_ms=min(eager["library"]), graph_ms=min(graphed["kernel"]),
             library_graph_ms=min(graphed["library"]), bytes=n * 8 + beg.numel() * 4),
    ]


def _ban_even_tokens(logits, cur_len):
    """A torch ``adjust_logits_fn``: even token ids from 4 up get -inf."""
    import torch

    del cur_len
    v = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where((v % 2 == 0) & (v >= 4), float("-inf"), logits)


def small_mode_parity(np, torch):
    """The decode modes on a tiny model and corpus, on the card against the
    port's CPU path: free generation, speculative, forced BOS, the top-k
    warper, a ban-even-tokens hook, sampling (one seed) and diverse groups,
    and on the compact and hybrid layouts ``exact_mask`` and diverse groups
    with and without it; under ``topk=1`` free generation collapses every
    query to one path."""
    from seal_tpu_torch.decoding.generate import fm_index_generate, pad_batch
    from seal_tpu_torch.index.device_index import TorchFMIndex
    from seal_tpu_torch.index.fm_index import FMIndex
    from seal_tpu_torch.index.wavelet import WaveletIndex
    from seal_tpu_torch.models import bart
    from seal_tpu_torch.models.config import bart_tiny

    cfg = bart_tiny(vocab_size=96)
    params_cpu = bart.init_params(cfg, seed=0, device="cpu")
    params_gpu = _tree_to(params_cpu, "cuda")
    rng = np.random.default_rng(4)
    host = FMIndex()
    host.initialize([rng.integers(4, 90, size=rng.integers(5, 30)).tolist() + [2]
                     for _ in range(30)])
    ids, mask = pad_batch([[0] + rng.integers(4, 90, size=5).tolist() + [2] for _ in range(3)],
                          cfg.pad_token_id)
    idx = {dev: TorchFMIndex.from_host(host, vocab=96, device=dev) for dev in ("cpu", "cuda")}
    base = dict(num_beams=4, max_length=6, min_length=2, window=4)
    modes = {"free": dict(disable_fm_index=True), "speculative": dict(speculative=True, top_m=8),
             "forced_bos": dict(forced_bos_token_id=0), "topk": dict(topk=5),
             "hook": dict(adjust_logits_fn=_ban_even_tokens),
             # min_length 0: under the top-1 warper a banned EOS leaves nothing
             "free_topk1": dict(disable_fm_index=True, topk=1, min_length=0),
             # one seed on both: the same Philox draws (logf and log agree
             # but for a near-tie)
             "sample": dict(sample=True, seed=3),
             "sample_dense": dict(sample=True, seed=3, exact_mask=True),
             "diverse": dict(diverse_bs_groups=2, diverse_bs_penalty=0.5),
             "diverse_dense": dict(diverse_bs_groups=2, diverse_bs_penalty=0.5, exact_mask=True),
             "diverse_ties": dict(diverse_bs_groups=2, diverse_bs_penalty=0.5, exact_ties=True)}
    n = 0

    def parity(name, idx, extra):
        nonlocal n
        out = {dev: fm_index_generate(cfg, p, idx[dev], ids, mask, **{**base, **extra})
               for dev, p in (("cpu", params_cpu), ("cuda", params_gpu))}
        for a, b in zip(out["cpu"], out["cuda"]):
            ka, kb = sorted((tuple(t), s) for s, t in a), sorted((tuple(t), s) for s, t in b)
            if [t for t, _ in ka] != [t for t, _ in kb]:
                fail(f"small mode parity ({name}): keys differ between card and CPU")
            elif ka and max(abs(x[1] - y[1]) for x, y in zip(ka, kb)) > 1e-4:
                fail(f"small mode parity ({name}): scores differ by > 1e-4")
            n += len(kb)
        return out

    # the wavelet layouts under the dense parity mode and diverse groups:
    # kernel 16's walk and kernel 21's wide and list routes
    for layout in ("compact", "hybrid"):
        wix = {dev: WaveletIndex.from_host(host, vocab=96, keep_bwt=layout == "hybrid",
                                           device=dev) for dev in ("cpu", "cuda")}
        for name in ("exact_mask", "diverse", "diverse_dense"):
            parity(f"{name}_{layout}", wix, modes.get(name, dict(exact_mask=True)))
    for name, extra in modes.items():
        out = parity(name, idx, extra)
        if name == "free_topk1":
            # one live beam: every hypothesis is a prefix of the longest
            for h in out["cuda"]:
                paths = sorted((t for _, t in h), key=len)
                if not paths or any(p != paths[-1][:len(p)] for p in paths):
                    fail("small mode parity: topk=1 free generation did not collapse to one path")
    return n


def searcher_grounding(searcher, queries):
    """One unit's raw body and title hypotheses, decoded as
    ``process_batch`` decodes them: every body key occurs in the corpus; a
    title key occurs after the forced prefix from its second token on (its
    first token is chosen under the dense corpus mask, the JAX decoder's
    step-0 rule, and occurs on its own); a ``force_full`` re-run of the
    title decode gives identical hypotheses.  Returns (body keys, title
    keys) checked."""
    s = searcher
    cfg, host = s.model_cfg, s.fm_index
    inputs = [" " + q.strip() for q in queries]
    common = dict(num_beams=s.beam, forced_bos_token_id=None, top_m=s.top_m, window=s.window,
                  diverse_bs_groups=s.diverse_bs_groups, diverse_bs_penalty=s.diverse_bs_penalty)
    special = (cfg.eos_token_id, cfg.pad_token_id, cfg.bos_token_id)
    body = s._generate(s.params, s._tokenize_batch(s._marked(inputs, "body")),
                       min_length=s.length, max_length=s.length, **common)
    n_body = 0
    for hyps in body:
        for _, toks in hyps:
            key = [t for t in toks[1:] if t not in special]
            if key:
                n_body += 1
                if host.get_count(key) <= 0:
                    fail(f"body key not in the corpus: {key}")
    title_toks = s._tokenize_batch(s._marked(inputs, "title"))
    title_kw = dict(min_length=1, max_length=15, eos_token_id=s.title_eos_token_id,
                    force_decoding_from=[s.title_bos_token_id], **common)
    title = s._generate(s.title_params, title_toks, **title_kw)
    n_title = 0
    for hyps in title:
        for _, toks in hyps:
            key = [t for t in toks[1:] if t not in (cfg.pad_token_id, cfg.bos_token_id)]
            n_title += 1
            want = [s.title_bos_token_id] + key if len(key) >= 2 else key
            if host.get_count(want) <= 0:
                fail(f"title key not in the corpus: {want}")
    full = s._generate(s.title_params, title_toks, force_full=True, **title_kw)
    if [sorted((tuple(t), sc) for sc, t in h) for h in title] != [
        sorted((tuple(t), sc) for sc, t in h) for h in full
    ]:
        fail("force_full title hypotheses differ from the fast path's")
    if not n_body or not n_title:
        fail(f"grounding check saw {n_body} body and {n_title} title keys")
    return n_body, n_title


def small_search_parity(np, free_generation=False):
    """The tiny searcher on the card, over each index layout, vs on the CPU
    over the Psi layout: same doc ids in the same order, scores within
    SEARCH_RTOL.  ``free_generation`` runs both so."""
    from seal_tpu_torch import bench_search

    def tiny(dev, layout="psi"):
        s = bench_search.tiny_searcher(dev, layout=layout)
        s.free_generation = free_generation
        return s

    cpu = tiny("cpu").batch_search(bench_search.TINY_QUERIES, k=5)
    n = 0
    for layout in ("psi",) + WAVELET_LAYOUTS:
        gpu = tiny("cuda", layout).batch_search(bench_search.TINY_QUERIES, k=5)
        for a, b in zip(cpu, gpu):
            if [d.docid for d in a] != [d.docid for d in b]:
                fail(f"small searcher parity: doc ids differ between card ({layout}) and CPU")
            elif a and np.max(np.abs(np.subtract([d.score for d in b], [d.score for d in a]))
                              / np.abs([d.score for d in a])) > SEARCH_RTOL:
                fail(f"small searcher parity ({layout}): scores differ by more than the "
                     "tolerance")
            n += len(a)
    if n == 0:
        fail("small searcher parity: no documents retrieved")
    return n


def t5_kernel_phase(np, torch, cfg, B, K, enc_len, key_len):
    """Kernel 10's relative-bias mode against its plain version at the T5
    path's shapes (rows B*K, T5-base's heads, every step of the cache) in
    f32 and bf16, kernel 9 with T5's un-scaled q, and the card's
    bucket-of-distance vector against the CPU's."""
    import torch.nn.functional as F

    from seal_tpu_torch.kernels import decode_attention as k910
    from seal_tpu_torch.models import t5

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    rows, H, Dh = B * K, cfg.num_heads, cfg.d_kv
    bf, f32 = torch.bfloat16, torch.float32
    far = t5.bucket_of_distance(cfg, 1024, dev)
    if far.device.type != "cuda" or not torch.equal(far.cpu(),
                                                    t5.bucket_of_distance(cfg, 1024, "cpu")):
        fail("T5: the card's bucket-of-distance vector differs from the CPU's")
    buckets = t5.bucket_of_distance(cfg, key_len, dev)
    table = torch.randn(cfg.relative_attention_num_buckets, H, generator=g, device=dev)
    # un-scaled q and K at T5-base's magnitudes (entries ~N(0, 1.4^2)), the
    # cache filled at every slot
    inputs = {}
    for dt in (f32, bf):
        q = (torch.randn(rows, H, Dh, generator=g, device=dev) * 1.4).to(dt)
        kc = (torch.randn(rows, key_len, H, Dh, generator=g, device=dev) * 1.4).to(dt)
        vc = torch.randn(rows, key_len, H, Dh, generator=g, device=dev).to(dt)
        inputs[dt] = (q, kc, vc)
    # the table in the compute dtype, as cast_params leaves it (the kernel
    # widens a bf16 table)
    tables = {f32: table, bf: table.to(bf)}
    # each dtype within its tolerance: the un-scaled scores reach ~50 here,
    # so f32 rounding is held to decode_attention.f32_error_ratio, bf16 to
    # bf16_error_ratio
    f32_err, f32_ratio, ratio, bf_abs = 0.0, 0.0, 0.0, 0.0
    for step in range(key_len):
        for dt, (q, kc, vc) in inputs.items():
            got = k910.self_attention_step_rel(q, kc, vc, step, tables[dt], buckets)
            want = k910.self_attention_rel_plain(q, kc, vc, step, tables[dt], buckets)
            err = float((got.float() - want.float()).abs().max())
            head_bias = k910.relative_bias_row(tables[dt], buckets, step, key_len)
            if dt == f32:
                f32_err = max(f32_err, err)
                f32_ratio = max(f32_ratio, k910.f32_error_ratio(got, want, q, kc, vc,
                                                                m=key_len, head_bias=head_bias))
            else:
                ratio = max(ratio, k910.bf16_error_ratio(got, want, q, kc, vc,
                                                         head_bias=head_bias))
                bf_abs = max(bf_abs, err)
    if f32_ratio > 1.0 or ratio > 1.0:
        fail(f"self_attention_step_t5 differs from its plain version (f32 {f32_ratio} of the "
             f"tolerance, {f32_err} absolute; bf16 {ratio} of the tolerance, {bf_abs} absolute)")
    # kernel 9 with T5's un-scaled q over the encoder's positions, padded, in
    # f32 (the path's dtype) and bf16, each within its dtype's tolerance
    bias = torch.zeros(B, enc_len, device=dev)
    bias[::3, -3:] = -1e9
    cross, r9 = {}, {}
    for dt, ratio_of in ((f32, k910.f32_error_ratio), (bf, k910.bf16_error_ratio)):
        qx = (torch.randn(rows, H, Dh, generator=g, device=dev) * 1.4).to(dt)
        kx = (torch.randn(B, enc_len, H, Dh, generator=g, device=dev) * 1.4).to(dt)
        vx = torch.randn(B, enc_len, H, Dh, generator=g, device=dev).to(dt)
        cross[dt] = (qx, kx, vx)
        r9[dt] = ratio_of(k910.cross_attention_step(qx, kx, vx, bias),
                          k910.decode_attention_plain(qx, kx, vx, bias), qx, kx, vx, bias)
    if r9[f32] > 1.0 or r9[bf] > 1.0:
        fail(f"cross_attention_step with an un-scaled q: f32 {r9[f32]} of the f32 tolerance, "
             f"bf16 {r9[bf]} of the bf16 tolerance")
    step = key_len - 1  # the last step: every slot live
    q, kc, vc = inputs[f32]
    es = 4
    qs = q[:, :, None, :]
    ks, vs = kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3)
    mask4 = k910.relative_bias_row(table, buckets, step, key_len)[None, :, None, :]
    qb, kb, vb = inputs[bf]
    row = dict(
        name="self_attention_step_t5", max_abs_err=f32_err, tol_ratio=ratio,
        f32_max_abs_err=f32_err, f32_tol_ratio=f32_ratio, cross_tol_ratio=r9[bf],
        cross_f32_tol_ratio=r9[f32],
        bytes=2 * q.numel() * es + 2 * rows * (step + 1) * H * Dh * es + table.numel() * 4
        + (step + 1) * 4,
        flops=4 * rows * H * (step + 1) * Dh,
        ms=time_ms(lambda: k910.self_attention_step_rel(q, kc, vc, step, table, buckets)),
        plain_ms=time_ms(lambda: k910.self_attention_rel_plain(q, kc, vc, step, table, buckets)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask4,
                                                                  scale=1.0)),
        bf16_ms=time_ms(lambda: k910.self_attention_step_rel(qb, kb, vb, step, tables[bf],
                                                             buckets)),
        bf16_plain_ms=time_ms(lambda: k910.self_attention_rel_plain(qb, kb, vb, step, tables[bf],
                                                                    buckets)),
        cross_ms=time_ms(lambda: k910.cross_attention_step(*cross[bf], bias)),
        cross_plain_ms=time_ms(lambda: k910.decode_attention_plain(*cross[bf], bias)),
        cross_f32_ms=time_ms(lambda: k910.cross_attention_step(*cross[f32], bias)),
        cross_f32_plain_ms=time_ms(lambda: k910.decode_attention_plain(*cross[f32], bias)),
        graph_ms=graph_ms(lambda: k910.self_attention_step_rel(q, kc, vc, step, table, buckets)),
        library_graph_ms=graph_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                                         attn_mask=mask4,
                                                                         scale=1.0)),
        bf16_graph_ms=graph_ms(lambda: k910.self_attention_step_rel(qb, kb, vb, step, tables[bf],
                                                                    buckets)),
        shape=f"q [{rows},{H},{Dh}] f32 un-scaled, cache [{rows},{key_len},{H},{Dh}] at step "
              f"{step}, table [{table.shape[0]},{H}]; checked at steps 0-{key_len - 1} in f32 "
              f"and bf16 (tol_ratio / f32_tol_ratio: each dtype's share of its tolerance); "
              f"cross: kernel 9, q [{rows},{H},{Dh}] un-scaled, K/V [{B},{enc_len},{H},{Dh}], "
              f"padded; cross_* bf16, cross_f32_* f32 (the path's dtype)",
    )
    # kernel 9 in f32, the T5 path's dtype (its ffma route), as a row of its
    # own: SDPA in f32 with the padding bias as its mask and scale 1
    qx, kx, vx = cross[f32]
    qx4 = qx.reshape(B, K, H, Dh).permute(0, 2, 1, 3).contiguous()
    kx4, vx4 = kx.permute(0, 2, 1, 3).contiguous(), vx.permute(0, 2, 1, 3).contiguous()
    maskx4 = bias[:, None, None, :]
    cross_row = dict(
        name="cross_attention_step_f32", max_abs_err=float(
            (k910.cross_attention_step(qx, kx, vx, bias)
             - k910.decode_attention_plain(qx, kx, vx, bias)).abs().max()),
        tol_ratio=r9[f32], route=k910.route(K, enc_len, Dh, False),
        ms=time_ms(lambda: k910.cross_attention_step(qx, kx, vx, bias)),
        plain_ms=time_ms(lambda: k910.decode_attention_plain(qx, kx, vx, bias)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(qx4, kx4, vx4, attn_mask=maskx4,
                                                                  scale=1.0)),
        graph_ms=graph_ms(lambda: k910.cross_attention_step(qx, kx, vx, bias)),
        library_graph_ms=graph_ms(lambda: F.scaled_dot_product_attention(
            qx4, kx4, vx4, attn_mask=maskx4, scale=1.0)),
        bytes=2 * qx.numel() * 4 + 2 * kx.numel() * 4 + bias.numel() * 4,
        flops=4 * rows * H * enc_len * Dh,
        shape=f"q [{rows},{H},{Dh}] f32 un-scaled, K/V [{B},{enc_len},{H},{Dh}] padded "
              f"({k910.route(K, enc_len, Dh, False)} route); tol_ratio: its share of the f32 "
              "tolerance",
    )
    torch.cuda.synchronize()
    return [row, cross_row]


def small_t5_parity(np, torch):
    """The tiny T5 on the card vs its plain CPU path (the fast path and
    ``exact_mask``; the CPU path is held to the JAX package by the tests).
    Returns the keys compared."""
    from seal_tpu_torch.decoding.generate import fm_index_generate
    from seal_tpu_torch.index.device_index import TorchFMIndex
    from seal_tpu_torch.index.fm_index import FMIndex
    from seal_tpu_torch.models import t5

    cfg = t5.t5_tiny(vocab_size=60)
    params_cpu = t5.init_params(cfg, seed=0, device="cpu")
    params_gpu = _tree_to(params_cpu, "cuda")
    n_keys = 0
    for seed in range(2):
        rng = np.random.default_rng(seed)
        docs = [rng.integers(2, 60, size=rng.integers(5, 25)).tolist() + [1] for _ in range(30)]
        host = FMIndex()
        host.initialize(docs)
        queries = [rng.integers(2, 60, size=5).tolist() + [1] for _ in range(3)]
        for extra in ({}, {"exact_mask": True}):
            kw = dict(num_beams=4, max_length=6, min_length=1, forced_bos_token_id=None, **extra)
            out = [fm_index_generate(cfg, p, TorchFMIndex.from_host(host, vocab=60, device=d),
                                     queries, **kw)
                   for d, p in (("cpu", params_cpu), ("cuda", params_gpu))]
            for a, b in zip(*out):
                ka, kb = sorted((tuple(t), s) for s, t in a), sorted((tuple(t), s) for s, t in b)
                if [t for t, _ in ka] != [t for t, _ in kb]:
                    fail(f"small T5 parity: keys differ between card and CPU ({extra}, seed "
                         f"{seed})")
                elif ka and max(abs(x[1] - y[1]) for x, y in zip(ka, kb)) > 1e-4:
                    fail(f"small T5 parity: scores differ by > 1e-4 ({extra}, seed {seed})")
                n_keys += len(ka)
    if n_keys == 0:
        fail("small T5 parity: no keys")
    return n_keys


def t5_phase(np, torch, zero_counts, read_counts):
    """T5-base on the card through both entry points (the module
    docstring's item 11).  Returns (kernel rows, readings)."""
    import dataclasses

    from seal_tpu_torch import bench_generate, bench_search
    from seal_tpu_torch.decoding import generate
    from seal_tpu_torch.models import convert

    t0 = time.perf_counter()
    host, index, cfg, params, ids, mask, kw = bench_generate.t5_operating_point("cuda")
    B, K = ids.shape[0], kw["num_beams"]
    layers = cfg.decoder_layers
    log(f"T5 set-up: T5-base {cfg.dtype} ({cfg.num_layers} + {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads, vocab {cfg.vocab_size}), {index.n_rows - 1} "
        f"tokens; {time.perf_counter() - t0:.1f} s")
    special = (cfg.eos_token_id, cfg.pad_token_id, cfg.bos_token_id)
    grounded = {}

    def check(hyp_lists, what):
        n = 0
        for q in hyp_lists:
            for score, toks in q:
                key = tuple(t for t in toks[1:] if t not in special)
                if toks[0] != cfg.decoder_start_token_id or not np.isfinite(score):
                    fail(f"{what}: hypothesis {toks} with score {score}")
                if key:
                    n += 1
                    if key not in grounded:
                        grounded[key] = host.get_count(list(key)) > 0
                    if not grounded[key]:
                        fail(f"{what}: key not in the corpus: {list(key)}")
        if n == 0:
            fail(f"{what}: no keys emitted")
        return n

    def run(c=cfg, p=params, idx=index, **extra):
        out = generate.fm_index_generate(c, p, idx, ids, mask, **kw, **extra)
        torch.cuda.synchronize()
        return out

    def canon(hyps):
        return [sorted((tuple(t), s) for s, t in q) for q in hyps]

    run()  # warm-up
    zero_counts()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        hyps = run()
        times.append(time.perf_counter() - t0)
    launches = read_counts("generate_t5", layers=layers)
    fallback = generate.LAST_DECODE_STATS["fallback_steps"]
    per_batch = statistics.median(times)
    n_keys = check(hyps, "generate_t5")
    log(f"generate_t5: {[round(t, 4) for t in times]} s/batch; median {per_batch:.4f} s = "
        f"{B / per_batch:.1f} queries/s (batch {B}, beam {K}, length {kw['max_length']}, "
        f"T5-base f32); fallback_steps {fallback}; {n_keys} keys grounded")
    log(f"launches in the generate_t5 run: {launches}")
    same = {}
    for path, extra, idx in (("generate_t5_force_full", {"force_full": True}, index),
                             ("generate_t5_dense", {"exact_mask": True}, index),
                             ("generate_t5_hybrid", {},
                              bench_generate.build_index(host, "hybrid", "cuda",
                                                         vocab=cfg.vocab_size))):
        zero_counts()
        other = run(idx=idx, **extra)
        log(f"launches in the {path} run: {read_counts(path, layers=layers)}")
        check(other, path)
        same[path] = canon(other) == canon(hyps)
        if not same[path]:
            fail(f"{path}: hypotheses differ from the fast Psi path's (tokens or score bits)")
    log("T5 checks: force_full, exact_mask and the hybrid layout give hypotheses bit-identical "
        f"to the fast path's: {same}")
    prof = bench_generate.profile_batch(run)
    log(f"T5 profiled batch: {prof['kernels']} kernels, device busy {prof['device_busy_ms']:.2f} "
        f"ms of {prof['wall_ms']:.2f} ms wall ({100 * prof['busy_share']:.1f}%)")
    for row in prof["top"][:10]:
        log(f"  {row['ms']:8.3f} ms {row['calls']:6d} calls  {row['name']}")
    bcfg = dataclasses.replace(cfg, dtype="bfloat16")
    bparams = convert.cast_params(bcfg, params)
    run(c=bcfg, p=bparams)  # warm-up
    zero_counts()
    t0 = time.perf_counter()
    bhyps = run(c=bcfg, p=bparams)
    bf16_s = time.perf_counter() - t0
    b_launches = read_counts("generate_t5_bf16", layers=layers)
    n_bkeys = check(bhyps, "generate_t5_bf16")
    log(f"generate_t5_bf16: one batch in {bf16_s:.4f} s = {B / bf16_s:.1f} queries/s; "
        f"{n_bkeys} keys grounded; launches {b_launches}")
    del bparams

    table = t5_kernel_phase(np, torch, cfg, B, K, ids.shape[1], kw["max_length"])

    t0 = time.perf_counter()
    searcher, queries = bench_search.t5_operating_point("cuda")
    log(f"T5 searcher set-up {time.perf_counter() - t0:.1f} s: backbone {searcher.backbone}, "
        f"title markers {searcher.title_bos_token_id} / {searcher.title_eos_token_id} (the "
        f"corpus carries them: titles on), prepend_space {searcher.prepend_space}, "
        f"strip {searcher.strip_token_ids}")
    searcher.batch_search(queries, k=bench_search.TOP_K)  # warm-up unit
    torch.cuda.synchronize()
    searcher.phase_timer.enabled = True
    zero_counts()
    t0 = time.perf_counter()
    res = searcher.batch_search(queries, k=bench_search.TOP_K)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    s_launches = read_counts("batch_search_t5", layers=layers)
    nonempty = sum(1 for r in res if r)
    if not nonempty or any(not all(np.isfinite([d.score for d in r])) for r in res):
        fail(f"batch_search_t5: {nonempty} non-empty results, or non-finite scores")
    n_body, n_title = searcher_grounding(searcher, queries)
    keys, _ = searcher.generate_keys(queries[0])
    n_title_keys = sum(1 for k, _ in keys if k[0] == searcher.title_bos_token_id)
    log(f"batch_search_t5: one unit of {len(queries)} queries in {search_s:.3f} s = "
        f"{len(queries) / search_s:.2f} queries/s (after a warm-up unit); phases "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(searcher.phase_timer.totals.items()))
        + f"; {nonempty}/{len(queries)} results non-empty; {n_body} raw body and {n_title} raw "
        f"title keys grounded; {n_title_keys} title keys among query 0's {len(keys)} keys (the "
        f"JAX searcher drops T5 title keys: a hypothesis starts with decoder start 0, not the "
        f"title BOS 1)")
    log(f"launches in the batch_search_t5 run: {s_launches}")
    del searcher
    n_small = small_t5_parity(np, torch)
    log(f"small T5 parity (card vs CPU, fast and exact_mask): {n_small} keys compared")
    return table, dict(qps=B / per_batch, bf16_qps=B / bf16_s, busy=prof["busy_share"],
                       search_qps=len(queries) / search_s, keys=n_keys)


# kernel 1's shard modes' limit size: [B, K, M] (range, token) items of
# membership and counts, [2B, K] selections of the step mode
SHARD_LIMIT = (2048, 64, 129)


def shard_search_rows(np, torch, k1, si, hosts, lo, hi, g, rng, V, B, K, searcher_calls=None):
    """Kernel 1's shard modes against their plain versions at the sharded
    path's shapes (ranges [S, B, K]; membership and counts of [B, K, 65]
    candidates, half of them a corpus token), at the plan's width and each
    forced, eagerly and replayed from a CUDA graph, and at a limit size
    ([2048, 64, 129] items, 262,144 selections); timed, with the step
    mode beside the composition it replaced (``range_size``, the gathers,
    the backward step and the stop rule as separate launches).
    ``searcher_calls``: (the sharded searcher's index, its most common
    ``contains`` call's inputs, its most common step mode call's inputs),
    timed on that index."""
    from seal_tpu_torch.ops import _generic

    S, R = si.n_shards, B * K
    sms = torch.cuda.get_device_properties(si.device).multi_processor_count
    dev = si.device
    chain = 16 + 4 * si.search_iters  # a search: the directory row, a chain of psi reads
    ext = torch.randint(-1, V + 2, (B, K), generator=g, device=dev, dtype=torch.int32)
    cand = torch.randint(0, V, (B, K, 65), generator=g, device=dev, dtype=torch.int32)
    cand[..., :32] = torch.as_tensor(rng.choice(hosts[0].text[:-1] - 1, size=(B, K, 1)),
                                     device=dev).int()
    cand[..., -1] = 2
    sel_tok = ext.clone()
    sel_tok[0, :2] = torch.tensor([2, 1], device=dev)
    sel_par = torch.randint(0, K, (B, K), generator=g, device=dev, dtype=torch.int32)
    fin = torch.rand(B, K, generator=g, device=dev) < 0.2
    kw = dict(eos=2, pad=1)

    def diff(got, want):
        got, want = (got if isinstance(got, tuple) else (got,)), (
            want if isinstance(want, tuple) else (want,))
        return sum(int((a != b).sum()) for a, b in zip(got, want))

    # every width, eagerly; the plan's, replayed from a graph
    err = 0
    want_c = {m: k1.fm_search_sharded_plain(si, m, cand, lo, hi) for m in ("contains", "validate")}
    want_s = k1.fm_search_sharded_plain(si, "backward_step", ext, lo, hi)
    steps = ((torch.zeros_like(sel_par), lo[..., :1].contiguous(), hi[..., :1].contiguous(),
              None), (sel_par, lo, hi, fin))
    want_a = [k1.advance_sharded_plain(si, sel_tok, p, a, b, f, **kw) for p, a, b, f in steps]
    err += diff(k1.fm_search_sharded(si, "contains", cand, lo, hi, group=1), want_c["contains"])
    for group in (None,) + k1.GROUPS:
        for m, w in want_c.items():
            err += diff(k1.fm_search_sharded(si, m, cand, lo, hi, group=group), w)
        err += diff(k1.fm_search_sharded(si, "backward_step", ext, lo, hi, group=group), want_s)
        for (p, a, b, f), w in zip(steps, want_a):
            err += diff(k1.fm_advance_sharded(si, sel_tok, p, a, b, f, group=group, **kw), w)
    for m, w in want_c.items():
        err += diff(graph_result(torch, lambda m=m: k1.fm_search_sharded(si, m, cand, lo, hi)), w)
    err += diff(graph_result(torch, lambda: k1.fm_search_sharded(si, "backward_step", ext, lo,
                                                                  hi)), want_s)
    for (p, a, b, f), w in zip(steps, want_a):
        err += diff(graph_result(torch, lambda p=p, a=a, b=b, f=f: k1.fm_advance_sharded(
            si, sel_tok, p, a, b, f, **kw)), w)
    # the limit sizes: 16.9M (range, token) items, 262,144 selections
    Bl, Kl, Ml = SHARD_LIMIT
    rows = si.n_rows[:, None, None].long()
    llo = (torch.rand((S, Bl, Kl), generator=g, device=dev) * rows).int()
    lhi = torch.minimum(llo + torch.randint(0, 600, (S, Bl, Kl), generator=g, device=dev,
                                            dtype=torch.int32), rows.int())
    lcand = torch.randint(-1, V + 2, (Bl, Kl, Ml), generator=g, device=dev, dtype=torch.int32)
    for m in ("contains", "validate"):
        err += diff(k1.fm_search_sharded(si, m, lcand, llo, lhi),
                    k1.fm_search_sharded_plain(si, m, lcand, llo, lhi))
    llo2 = torch.zeros((S, 2 * Bl, Kl), dtype=torch.int32, device=dev)
    lhi2 = si.n_rows[:, None, None].expand(S, 2 * Bl, Kl).contiguous()
    ltok = torch.randint(-1, V + 2, (2 * Bl, Kl), generator=g, device=dev, dtype=torch.int32)
    lpar = torch.randint(0, Kl, (2 * Bl, Kl), generator=g, device=dev, dtype=torch.int32)
    lfin = torch.rand((2 * Bl, Kl), generator=g, device=dev) < 0.2
    err += diff(k1.fm_advance_sharded(si, ltok, lpar, llo2, lhi2, lfin, **kw),
                k1.advance_sharded_plain(si, ltok, lpar, llo2, lhi2, lfin, **kw))
    extra = {}
    if searcher_calls is not None:  # the sharded searcher's own calls, on its index
        ssi, (scand, slo, shi), adv_args = searcher_calls
        err += diff(k1.fm_search_sharded(ssi, "contains", scand, slo, shi),
                    k1.fm_search_sharded_plain(ssi, "contains", scand, slo, shi))
        err += diff(k1.fm_advance_sharded(ssi, *adv_args, **kw),
                    k1.advance_sharded_plain(ssi, *adv_args, **kw))
        extra = dict(
            searcher_contains_shape=list(scand.shape),
            searcher_contains_graph_ms=graph_ms(
                lambda: k1.fm_search_sharded(ssi, "contains", scand, slo, shi)),
            searcher_advance_shape=list(adv_args[0].shape),
            searcher_advance_graph_ms=graph_ms(lambda: k1.fm_advance_sharded(ssi, *adv_args,
                                                                             **kw)))
    if err:
        fail(f"kernel 1's shard modes differ from their plain versions ({err} elements)")
    contains = lambda: k1.fm_search_sharded(si, "contains", cand, lo, hi)  # noqa: E731
    validate = lambda: k1.fm_search_sharded(si, "validate", cand, lo, hi)  # noqa: E731
    step = lambda: k1.fm_search_sharded(si, "backward_step", ext, lo, hi)  # noqa: E731
    adv = lambda: k1.fm_advance_sharded(si, sel_tok, sel_par, lo, hi, fin, **kw)  # noqa: E731

    def composed():  # the update as the sharded decode launched it before the step mode
        return _generic.advance_ranges(
            lambda t, a, b: k1.fm_search_sharded(si, "backward_step", t, a, b),
            lambda a, b: (b - a).sum(0, dtype=torch.int32), sel_tok, sel_par, lo, hi, fin, **kw)

    def widths(fn, groups=k1.GROUPS):
        return {G: graph_ms(lambda G=G: fn(G)) for G in groups}

    rows_ = [dict(
        name="fm_search_sharded", max_abs_err=err, library_ms=None,
        ms=time_ms(contains), graph_ms=graph_ms(contains),
        plain_ms=time_ms(lambda: k1.fm_search_sharded_plain(si, "contains", cand, lo, hi)),
        counts_ms=time_ms(validate), counts_graph_ms=graph_ms(validate),
        group_graph_ms=widths(lambda G: k1.fm_search_sharded(si, "contains", cand, lo, hi,
                                                             group=G), k1.CONTAINS_GROUPS),
        counts_group_graph_ms=widths(lambda G: k1.fm_search_sharded(si, "validate", cand, lo,
                                                                    hi, group=G)),
        limit_graph_ms=graph_ms(lambda: k1.fm_search_sharded(si, "contains", lcand, llo, lhi)),
        shape=f"contains [{B},{K},65] over {S} shards, (group, team) "
              f"{k1.shard_plan(cand.numel(), sms, S, contains=True)}, counts "
              f"{k1.shard_plan(cand.numel(), sms, S)} (counts_*: validate, the counts summed; "
              f"group_graph_ms: each width forced; limit: {list(SHARD_LIMIT)})",
        members=int(want_c["contains"].sum()),
        # tokens and membership once; per shard the ranges and a search
        bytes=cand.numel() * (4 + 1 + S * chain) + 8 * S * R, **extra,
    ), dict(
        name="fm_search_step_sharded", max_abs_err=err, library_ms=None,
        ms=time_ms(step), graph_ms=graph_ms(step),
        plain_ms=time_ms(lambda: k1.fm_search_sharded_plain(si, "backward_step", ext, lo, hi)),
        group_graph_ms=widths(lambda G: k1.fm_search_sharded(si, "backward_step", ext, lo, hi,
                                                             group=G)),
        shape=f"backward_step [{S},{B},{K}], (group, team) {k1.shard_plan(R, sms, S)} (an "
              "entry point: the decode's range update is the step mode)",
        # tokens, ranges in and out, both bounds' searches a shard
        bytes=4 * R + 16 * S * R + 2 * S * R * chain,
    ), dict(
        name="fm_search_advance_sharded", max_abs_err=err, library_ms=None,
        ms=time_ms(adv), graph_ms=graph_ms(adv),
        plain_ms=time_ms(lambda: k1.advance_sharded_plain(si, sel_tok, sel_par, lo, hi, fin,
                                                          **kw)),
        composed_ms=time_ms(composed), composed_graph_ms=graph_ms(composed),
        group_graph_ms=widths(lambda G: k1.fm_advance_sharded(si, sel_tok, sel_par, lo, hi, fin,
                                                              group=G, **kw)),
        limit_graph_ms=graph_ms(lambda: k1.fm_advance_sharded(si, ltok, lpar, llo2, lhi2, lfin,
                                                              **kw)),
        shape=f"[{B},{K}] selections over [{S},{B},{K}] parents, (group, team) "
              f"{k1.shard_plan(R, sms, S)} (composed_*: range_size, the gathers, the backward "
              f"step and the stop rule as separate launches; limit: {2 * Bl * Kl} selections)",
        # the selections and flags, the parents' ranges, the outputs, and
        # both bounds' searches a shard
        bytes=R * (8 + 1 + 4) + 16 * S * R + 2 * S * R * chain,
    )]
    return rows_


def sharded_kernel_phases(np, torch, si, hosts, V, B, K, count_filter=None, searcher_calls=None):
    """Kernels 1, 2, 5, 6 and 15 (counts and mask) in their shard modes against their plain
    versions at the sharded generation path's shapes (S shards stacked on
    the card, ranges [S, B, K]), exactly: integer results and gathered
    floats.  Each bound counts every shard's inputs read once and the merged
    output written once.  ``count_filter``: (tokens, lengths, the searcher's
    monolithic Psi index) of the sharded searcher's most common kernel 5
    call, timed beside the [4096, 16] shape.  ``searcher_calls``: the
    sharded searcher's kernel 1 calls (``shard_search_rows``)."""
    from seal_tpu_torch.kernels import bucket_counts as k6
    from seal_tpu_torch.kernels import count_mask
    from seal_tpu_torch.kernels import fm_search as k1
    from seal_tpu_torch.kernels import window_gather as k2

    dev = si.device
    S = si.n_shards
    g = torch.Generator(device=dev).manual_seed(11)
    rng = np.random.default_rng(11)
    table = []
    # each shard's ranges of one- and two-token prefixes of its own text,
    # plus its full range, an empty range and one into the padded rows
    los, his = [], []
    for s, h in enumerate(hosts):
        v = si.block_view(s)
        text = h.text[:-1] - 1
        first = torch.as_tensor(rng.choice(text, size=(2, B, K)).astype(np.int32), device=dev)
        flo = torch.zeros((B, K), dtype=torch.int32, device=dev)
        fhi = torch.full((B, K), h.size(), dtype=torch.int32, device=dev)
        lo1, hi1 = k1.backward_step_plain(v, first[0], flo, fhi)
        lo2, hi2 = k1.backward_step_plain(v, first[1], lo1, hi1)
        even = torch.arange(K, device=dev) % 2 == 0
        lo, hi = torch.where(even, lo1, lo2), torch.where(even, hi1, hi2)
        lo[0, 0], hi[0, 0] = 0, h.size()
        lo[0, 1], hi[0, 1] = 5, 5
        lo[0, 2], hi[0, 2] = max(h.size() - 3, 0), si.n_max
        los.append(lo)
        his.append(hi)
    lo, hi = torch.stack(los), torch.stack(his)
    R = B * K

    table += shard_search_rows(np, torch, k1, si, hosts, lo, hi, g, rng, V, B, K,
                               searcher_calls)

    # kernel 2: the union window [B*K rows, S*32 slots, fill pad] and a
    # slab (S*64, fill 0)
    lp = torch.log_softmax(torch.randn(R, V, generator=g, device=dev), -1)
    err2 = 0
    for w, fill in ((32, 1), (64, 0)):
        got = k2.window_gather_sharded(si, lo, hi, w, lp, fill)
        want = k2.window_gather_sharded_plain(si, lo, hi, w, lp, fill)
        err2 += sum(int((a != b).sum()) for a, b in zip(got, want))
    if err2:
        fail(f"window_gather_sharded differs from its plain version ({err2} elements)")
    table.append(dict(
        name="window_gather_sharded", max_abs_err=err2, library_ms=None,
        ms=time_ms(lambda: k2.window_gather_sharded(si, lo, hi, 32, lp, 1)),
        graph_ms=graph_ms(lambda: k2.window_gather_sharded(si, lo, hi, 32, lp, 1)),
        plain_ms=time_ms(lambda: k2.window_gather_sharded_plain(si, lo, hi, 32, lp, 1)),
        shape=f"[{S},{R}] ranges, {S}x32 union slots over lp [{R},{V}]",
        bytes=window_bytes(torch, lo, hi, 32, 0, 0,
                           k2.window_gather_sharded_plain(si, lo, hi, 32, lp, 1)[:1]),
    ))
    table += window_slab_rows(torch, k2, si, lo, hi, lp, "_sharded", B, K, V)

    # kernel 5: 4096 corpus n-grams of lengths 1-16 (an eighth random ids),
    # per-shard ranges and summed counts
    n, L = 4096, 16
    text = np.concatenate([h.text[:-1] - 1 for h in hosts])
    starts = rng.integers(0, text.size - L, size=n)
    toks = np.stack([text[s : s + L][::-1] for s in starts]).astype(np.int32)
    toks[: n // 8] = rng.integers(-1, V + 2, size=(n // 8, L))
    toks = torch.as_tensor(toks, device=dev)
    lens = torch.as_tensor(rng.integers(1, L + 1, size=n).astype(np.int32), device=dev)
    want5 = k1.sequences_sharded_plain(si, toks, lens)
    err5 = sum(int((a != b).sum()) for a, b in zip(k1.fm_sequences_sharded(si, toks, lens),
                                                    want5))
    wcount = k1.sequences_sharded_plain(si, toks, lens, count=True)
    err5 += int((k1.fm_sequences_sharded(si, toks, lens, count=True) != wcount).sum())
    err5 += int((graph_result(torch, lambda: k1.fm_sequences_sharded(si, toks, lens, count=True))
                 != wcount).sum())
    for G in k1.GROUPS:  # every group width forced, both modes
        err5 += int((k1.fm_sequences_sharded(si, toks, lens, count=True, group=G)
                     != wcount).sum())
        err5 += sum(int((a != b).sum()) for a, b in zip(
            k1.fm_sequences_sharded(si, toks, lens, group=G), want5))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    extra = {}
    if count_filter is not None:  # the searcher's count filter, as it called kernel 5
        ctoks, clens, mono = count_filter
        cwant = k1.sequences_sharded_plain(si, ctoks, clens, count=True)
        err5 += int((k1.fm_sequences_sharded(si, ctoks, clens, count=True) != cwant).sum())
        err5 += sum(int((a != b).sum()) for a, b in zip(
            k1.fm_sequences_sharded(si, ctoks, clens), k1.sequences_sharded_plain(si, ctoks,
                                                                                   clens)))
        err5 += sum(int((a != b).sum()) for a, b in zip(
            k1.fm_sequences(mono, ctoks, clens), k1.sequences_plain(mono, ctoks, clens)))
        cn, cL = ctoks.shape
        extra = dict(
            count_filter_shape=f"[{cn},{cL}]",
            count_filter_plan=k1.sequences_plan(cn, sms, S),
            count_filter_ms=time_ms(lambda: k1.fm_sequences_sharded(si, ctoks, clens,
                                                                    count=True)),
            count_filter_graph_ms=graph_ms(lambda: k1.fm_sequences_sharded(si, ctoks, clens,
                                                                           count=True)),
            count_filter_ranges_graph_ms=graph_ms(lambda: k1.fm_sequences_sharded(si, ctoks,
                                                                                  clens)),
            count_filter_group_graph_ms={G: graph_ms(
                lambda G=G: k1.fm_sequences_sharded(si, ctoks, clens, count=True, group=G))
                for G in k1.GROUPS},
            mono_count_filter_ms=time_ms(lambda: k1.fm_sequences(mono, ctoks, clens)),
            mono_count_filter_graph_ms=graph_ms(lambda: k1.fm_sequences(mono, ctoks, clens)),
            count_filter_bound_ms=(cn * (cL * 4 + 4 + 4) + S * int(clens.sum()) * 2 * 4
                                   * si.search_iters) / HBM_BYTES_PER_S * 1e3,
        )
    if err5:
        fail(f"fm_sequences_sharded differs from its plain version ({err5} elements)")
    table.append(dict(
        name="fm_sequences_sharded", max_abs_err=err5, library_ms=None,
        ms=time_ms(lambda: k1.fm_sequences_sharded(si, toks, lens, count=True)),
        graph_ms=graph_ms(lambda: k1.fm_sequences_sharded(si, toks, lens, count=True)),
        group_graph_ms={G: graph_ms(
            lambda G=G: k1.fm_sequences_sharded(si, toks, lens, count=True, group=G))
            for G in k1.GROUPS},
        plain_ms=time_ms(lambda: k1.sequences_sharded_plain(si, toks, lens, count=True)),
        ranges_ms=time_ms(lambda: k1.fm_sequences_sharded(si, toks, lens)),
        ranges_graph_ms=graph_ms(lambda: k1.fm_sequences_sharded(si, toks, lens)),
        ranges_group_graph_ms={G: graph_ms(
            lambda G=G: k1.fm_sequences_sharded(si, toks, lens, group=G)) for G in k1.GROUPS},
        shape=f"[{n},{L}] over {S} shards, counts summed; {int((wcount > 0).sum())} non-empty; "
              f"(group, team) {k1.sequences_plan(n, sms, S)} (group_graph_ms: each "
              f"width forced; count_filter_*: the sharded searcher's most common call, mono_*: "
              "the same on the searcher's monolithic Psi index)",
        bytes=n * (L * 4 + 4 + 4) + S * int(lens.sum()) * 2 * 4 * si.search_iters,
        **extra,
    ))

    # kernel 6: every shard's bucket counts of its [B, K] ranges, summed
    err6 = int((k6.bucket_counts_sharded(si, lo, hi)
                != k6.bucket_counts_sharded_plain(si, lo, hi)).sum())
    br = si.bucket_rows
    lo_c, hi_c = lo.clamp(0, si.n_max).long(), hi.clamp(0, si.n_max).long()
    same = lo_c // br == hi_c // br
    partial = torch.where(same, (hi_c - lo_c).clamp(min=0),
                          (lo_c // br + 1) * br - lo_c + hi_c - hi_c // br * br)
    if err6:
        fail(f"bucket_counts_sharded differs from its plain version ({err6} counts)")
    nb = si.n_buckets
    table.append(dict(
        name="bucket_counts_sharded", max_abs_err=err6, library_ms=None,
        ms=time_ms(lambda: k6.bucket_counts_sharded(si, lo, hi)),
        plain_ms=time_ms(lambda: k6.bucket_counts_sharded_plain(si, lo, hi)),
        shape=f"[{S},{B},{K}] ranges x {nb} buckets, summed",
        bytes=S * R * (8 + 2 * 4 * nb) + R * 4 * nb + int(partial.sum()) * 4,
    ))
    # its support mode (what the straggler rounds read): each shard's bits
    # ORed; a range's rows by its route, as the monolithic mode's bound
    got = k6.bucket_support_sharded(si, lo, hi)
    errs = int((got != k6.bucket_support_sharded_plain(si, lo, hi)).sum())
    errs += int((got != k6.pack_support(k6.bucket_counts_sharded(si, lo, hi))).sum())
    if errs:
        fail(f"bucket_support_sharded differs from its plain version or the counts ({errs})")
    whole = si.n_rows.reshape((-1,) + (1,) * (lo.dim() - 1)).long()
    narrow, wide, rows6 = support_routes(torch, lo, hi, si.n_max, whole, br)
    counts = lambda: k6.bucket_counts_sharded(si, lo, hi)  # noqa: E731
    table.append(dict(
        name="bucket_support_sharded", max_abs_err=errs, library_ms=None,
        ms=time_ms(lambda: k6.bucket_support_sharded(si, lo, hi)),
        graph_ms=graph_ms(lambda: k6.bucket_support_sharded(si, lo, hi)),
        plain_ms=time_ms(lambda: k6.bucket_support_sharded_plain(si, lo, hi)),
        counts_ms=time_ms(counts), counts_graph_ms=graph_ms(counts),
        shape=f"[{S},{B},{K}] ranges -> 8 words ORed, {int(narrow.sum())} shard ranges on the "
              f"narrow route, {int(wide.sum())} on the wide (counts_*: the counts mode)",
        bytes=S * R * 8 + R * 32 + 4 * rows6 + 2 * 4 * nb * int(wide.sum()),
    ))

    # kernel 15: every shard's count vector of its [B, K] ranges, summed,
    # on both routes
    want15 = k1.dense_counts_sharded_plain(si, lo, hi, 4096)
    err15 = 0
    for hist_max in (k1.HIST_MAX_ROWS, 0, 2**31 - 1):
        err15 += int((k1.fm_dense_counts_sharded(si, lo, hi, hist_max=hist_max) != want15).sum())
    if err15:
        fail(f"fm_dense_counts_sharded differs from its plain version ({err15} counts)")
    hist_rows = sum(rows_bytes(torch, si.n_max, lo[s], hi[s], k1.HIST_MAX_ROWS, 4)
                    for s in range(S))
    table.append(dict(
        name="fm_dense_counts_sharded", max_abs_err=err15, library_ms=None,
        ms=time_ms(lambda: k1.fm_dense_counts_sharded(si, lo, hi)),
        graph_ms=graph_ms(lambda: k1.fm_dense_counts_sharded(si, lo, hi)),
        plain_ms=time_ms(lambda: k1.dense_counts_sharded_plain(si, lo, hi, 4096), iters=2),
        rank_route_ms=time_ms(lambda: k1.fm_dense_counts_sharded(si, lo, hi, hist_max=0),
                              iters=5),
        histogram_route_ms=time_ms(
            lambda: k1.fm_dense_counts_sharded(si, lo, hi, hist_max=2**31 - 1)),
        shape=f"[{S},{B},{K}] ranges x {V} tokens, summed (an entry point: the exact_mask "
              "decode reads the mask mode)",
        bytes=S * R * 8 + R * V * 4 + hist_rows,
    ))
    # the mask mode over the shards (what a sharded exact_mask step reads):
    # the summed counts > 0, every route, eager and replayed from a graph
    want_m = k1.dense_mask_sharded_plain(si, lo, hi, 4096)
    err_m = int((want_m != count_mask.pack(want15 > 0)).sum())
    for hist_max in (k1.MASK_HIST_MAX_ROWS, k1.HIST_MAX_ROWS, 0, k1.SPLIT_ROWS, 2**31 - 1):
        err_m += int((k1.fm_dense_mask_sharded(si, lo, hi, hist_max=hist_max) != want_m).sum())
    err_m += int((graph_result(torch, lambda: k1.fm_dense_mask_sharded(si, lo, hi))
                  != want_m).sum())
    if err_m:
        fail(f"fm_dense_mask_sharded differs from its plain version ({err_m} words)")
    table.append(dict(
        name="fm_dense_mask_sharded", max_abs_err=err_m, library_ms=None,
        ms=time_ms(lambda: k1.fm_dense_mask_sharded(si, lo, hi)),
        graph_ms=graph_ms(lambda: k1.fm_dense_mask_sharded(si, lo, hi)),
        plain_ms=time_ms(lambda: k1.dense_mask_sharded_plain(si, lo, hi, 4096), iters=2),
        counts_graph_ms=graph_ms(lambda: k1.fm_dense_counts_sharded(si, lo, hi)),
        rank_route_ms=time_ms(lambda: k1.fm_dense_mask_sharded(si, lo, hi, hist_max=0),
                              iters=5),
        shape=f"[{S},{B},{K}] ranges x {V} tokens -> [{B},{K},{want_m.shape[-1]}] mask words, "
              "ORed over the shards (counts_graph_ms: the counts mode on the same ranges)",
        # the ranges, the mask written, the histogram route's rows once
        bytes=S * R * 8 + want_m.numel() * 4 + sum(
            rows_bytes(torch, si.n_max, lo[s], hi[s], k1.MASK_HIST_MAX_ROWS, 4)
            for s in range(S)),
    ))
    torch.cuda.synchronize()
    return table


def select_route_phase(np, torch, cfg, V, B, K, window):
    """Kernel 8's routes against the plain versions at the path's shapes
    (ROADMAP C's F1 and F2 included), bit for bit, in both orders: the warp
    route at the bench's [B, K, 2K + w + 2] and at beam 32 [B, 32, 98],
    each beside the one-block route on the same inputs (the design before
    the warp route); the table route at a speculative round of top_m 20000
    ([B, K, 20130]) and the candidate mode's table at top_m 10000; the
    merge in device memory at sampling's buffers of 3000 (under ties) and
    10000."""
    from seal_tpu_torch.kernels import beam_select as k8
    from seal_tpu_torch.kernels import row_topk as k3

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    i32 = torch.int32
    rows = B * K
    lp_cache = {}

    def lp_of(r):
        if r not in lp_cache:
            lp = torch.log_softmax(torch.randn(r, V, generator=g, device=dev) * 2, -1)
            lp = torch.round(lp * 4) / 4  # ties
            lp[:, 5] = 0.0
            lp[::2, 6] = -0.0
            lp_cache[r] = lp
        return lp_cache[r]

    def sel_args(Kb, n_buf, w, tok_hi):
        lp = lp_of(B * Kb)
        take = lambda t: torch.gather(lp, 1, t.reshape(B * Kb, -1).long()).reshape(t.shape)  # noqa: E731
        btok = torch.randint(0, tok_hi, (B, Kb, n_buf), generator=g, device=dev, dtype=i32)
        win_valid = torch.rand(B, Kb, w, generator=g, device=dev) < 0.6
        win_tok = torch.where(win_valid, torch.randint(0, tok_hi, (B, Kb, w), generator=g,
                                                       device=dev, dtype=i32), cfg.pad_token_id)
        bs = torch.round(torch.randn(B, Kb, generator=g, device=dev) * 2) / 2 - 3
        bs[0, 1] = k8.NEG_INF
        return ((btok, take(btok), torch.rand(B, Kb, n_buf, generator=g, device=dev) < 0.7),
                n_buf, win_tok, win_valid, take(win_tok),
                (torch.rand(B, Kb, 2, generator=g, device=dev) < 0.5)[..., 1:], lp,
                torch.randint(0, 50, (B, Kb), generator=g, device=dev, dtype=i32),
                torch.rand(B, Kb, generator=g, device=dev) < 0.1, bs,
                torch.rand(B, Kb, generator=g, device=dev) < 0.5,
                torch.round(torch.randn(B, Kb, generator=g, device=dev)) - 4)

    skw = dict(eos=cfg.eos_token_id, pad=cfg.pad_token_id)
    pkw = dict(skw, stop_at_count=0, always_allow_eos=False)

    def check(route, args, Kb, keep_invalid=False, forced=False):
        """``route`` held against the plain version in both orders: the
        route select_plan picks at the shape (or, ``forced``, the one
        asked for), its launch counted on ``ROUTES``."""
        err = 0
        for ties in (False, True):
            n0 = k8.ROUTES[route].launches
            got = k8.beam_select(*args, K=Kb, ties=ties, keep_invalid=keep_invalid,
                                 **(dict(route=route) if forced else {}), **skw)
            if k8.ROUTES[route].launches != n0 + 1:
                fail(f"beam_select: the {route} route did not run at {args[2].shape[:2]}")
            want = k8.beam_select_plain(*args, K=Kb, ties=ties, keep_invalid=keep_invalid, **pkw)
            err += mismatches(torch, got[0] + (got[1],), want[0] + (want[1],))
        return err

    table = []
    a15 = sel_args(K, 2 * K, window, 400)
    a32 = sel_args(32, 64, 32, 400)
    errw = check("warp", a15, K) + check("warp", a32, 32) + check("warp", a15, K, True)
    if errw:
        fail(f"beam_select_warp differs from its plain version ({errw} elements)")
    warp = lambda: k8.beam_select(*a15, K=K, **skw)  # noqa: E731
    block = lambda: k8.beam_select(*a15, K=K, route="block", **skw)  # noqa: E731
    ncand = 2 * K + window + 2
    table.append(dict(
        name="beam_select_warp", max_abs_err=errw, library_ms=None, route="warp",
        ms=time_ms(warp), graph_ms=graph_ms(warp),
        plain_ms=time_ms(lambda: k8.beam_select_plain(*a15, K=K, **pkw)),
        block_ms=time_ms(block), block_graph_ms=graph_ms(block),
        beam32_ms=time_ms(lambda: k8.beam_select(*a32, K=32, **skw)),
        shape=f"[{B},{K},{ncand}] with the soundness test (block_ms: the one-block route on "
              f"the same inputs); beam32_ms at [{B},32,98]; both orders and keep_invalid "
              "checked",
        bytes=(B * K * (2 * K * 9 + window * 9 + 1 + 4 + 1 + 4 + 1 + 4) + rows * 8
               + B * (2 * K * 13 + K * 13 + 1)),
    ))

    # the wide route: the speculative default (a 256-slot buffer that keeps
    # its failed slots, a 128-row window) and beam 32 over the 4-shard union
    # window (2K + 4 x 128 + 2), the route select_plan picks at both, in
    # both orders, with and without the soundness flags; beside the routes it replaced on the same inputs
    # (the one-block route at the first, the large-n route's two launches at
    # the second), held against the plain version too
    asp = sel_args(K, 256, 128, 400)
    u32 = sel_args(32, 64, 4 * 128, 400)
    no_flags = lambda a: a[:10] + (None, None)  # noqa: E731
    errx = (check("wide", asp, K, True) + check("wide", no_flags(asp), K, True)
            + check("wide", u32, 32) + check("wide", no_flags(u32), 32))
    if errx:
        fail(f"beam_select_wide differs from its plain version ({errx} elements)")
    errb = check("block", asp, K, True, forced=True) + check("large", u32, 32, forced=True)
    if errb:
        fail(f"beam_select_block / large differ from their plain version ({errb} elements)")
    def sel(a, Kb, **kw_):  # the speculative inputs keep their failed slots
        return lambda: k8.beam_select(*a, K=Kb, keep_invalid=a is asp, **kw_, **skw)

    n386, n578 = 256 + 128 + 2, 64 + 4 * 128 + 2
    sel_bytes = lambda Kb, n: (B * Kb * (n * 9 + 1 + 4 + 1 + 4 + 1 + 4)  # noqa: E731
                               + B * Kb * 8 + B * (2 * Kb * 13 + Kb * 13 + 1))
    table.append(dict(
        name="beam_select_wide", max_abs_err=errx, library_ms=None, route="wide",
        ms=time_ms(sel(asp, K)), graph_ms=graph_ms(sel(asp, K)),
        plain_ms=time_ms(lambda: k8.beam_select_plain(*asp, K=K, keep_invalid=True, **pkw)),
        ties_graph_ms=graph_ms(sel(asp, K, ties=True)),
        block_ms=time_ms(sel(asp, K, route="block")),
        block_graph_ms=graph_ms(sel(asp, K, route="block")),
        beam32_ms=time_ms(sel(u32, 32)), beam32_graph_ms=graph_ms(sel(u32, 32)),
        beam32_ties_graph_ms=graph_ms(sel(u32, 32, ties=True)),
        large_graph_ms=graph_ms(sel(u32, 32, route="large")),
        beam32_bound_ms=sel_bytes(32, n578) / HBM_BYTES_PER_S * 1e3,
        shape=f"[{B},{K},{n386}] keep_invalid with the soundness test (block_ms: the "
              f"one-block route on the same inputs); beam32_*: [{B},32,{n578}] "
              "(large_graph_ms: the large-n route's two launches on the same inputs); both "
              "orders, with and without the flags checked",
        bytes=sel_bytes(K, n386),
    ))
    table.append(dict(
        name="beam_select_block", max_abs_err=errb, library_ms=None, route="block",
        ms=time_ms(sel(asp, K, route="block")), graph_ms=graph_ms(sel(asp, K, route="block")),
        plain_ms=time_ms(lambda: k8.beam_select_plain(*asp, K=K, keep_invalid=True, **pkw)),
        shape=f"[{B},{K},{n386}] keep_invalid, forced (the speculative default's route before "
              "the wide route); the large-n route forced at "
              f"[{B},32,{n578}] checked too (its row: beam_select_large)",
        bytes=sel_bytes(K, n386),
    ))

    # F2: the table route at a speculative round of top_m 20000
    n_spec, w_spec = 20000, 128
    aspec = sel_args(K, n_spec, w_spec, n_spec // 2)[:10] + (None, None)
    errt = check("table", aspec, K, keep_invalid=True)
    ccand = sel_args(K, 10000, 32, 5000)[:9]
    ckw = dict(skw, stop_at_count=0, always_allow_eos=False, keep_invalid=False)
    c0 = k8.CAND_TABLE.launches
    errt += mismatches(torch, k8.beam_candidates(*ccand, **ckw), k8.candidates_plain(*ccand, **ckw))
    if k8.CAND_TABLE.launches != c0 + 1:
        fail("beam_candidates: the table did not run at 10034 candidates a beam")
    if errt:
        fail(f"beam_select_table differs from its plain version ({errt} elements)")
    spec = lambda: k8.beam_select(*aspec, K=K, keep_invalid=True, **skw)  # noqa: E731
    nsc = n_spec + w_spec + 2
    table.append(dict(
        name="beam_select_table", max_abs_err=errt, library_ms=None, route="table",
        ms=time_ms(spec), graph_ms=graph_ms(spec),
        plain_ms=time_ms(lambda: k8.beam_select_plain(*aspec, K=K, keep_invalid=True, **pkw),
                         iters=3),
        cand_ms=time_ms(lambda: k8.beam_candidates(*ccand, **ckw)),
        shape=f"[{B},{K},{nsc}] keep_invalid (a speculative round of top_m {n_spec}); "
              f"cand_ms: the candidate mode's table at [{B},{K},10034]",
        # the candidates (9 B a slot), their lp columns, the outputs
        bytes=B * K * nsc * 9 + rows * 8 + B * (2 * K * 13 + K * 13),
    ))

    # F1: the merge in device memory at sampling's buffers of 10000 and, under
    # ties, 3000 (round 0: n_buf + 2 * 2 n_buf candidates a row)
    def merge_args(n_buf, n_top):
        lp = lp_of(rows)
        top_lp, top_idx = k3.row_topk_plain(lp, n_top)
        ok = (torch.rand(B, K, n_top + 1, generator=g, device=dev) < 0.5)[..., :n_top]
        slab = torch.randint(0, min(3 * n_top, V), (B, K, n_top), generator=g, device=dev,
                             dtype=i32)
        slab_lp = torch.gather(lp, 1, slab.reshape(rows, -1).long()).reshape(B, K, n_top)
        bt = torch.argsort(torch.rand(rows, V, generator=g, device=dev), -1)[:, :n_buf]
        blp = torch.gather(lp, 1, bt).reshape(B, K, n_buf)
        buf = (bt.to(i32).reshape(B, K, n_buf), blp,
               (torch.rand(B, K, n_buf, generator=g, device=dev) < 0.7) & (blp > k8.NEG_INF / 2))
        return (buf, top_idx.to(i32).reshape(B, K, n_top), top_lp.reshape(B, K, n_top), ok,
                slab, slab_lp, torch.rand(B, K, n_top, generator=g, device=dev) < 0.8, V, n_buf)

    errm = 0
    m10 = merge_args(10000, 20000)
    m3 = merge_args(3000, 6000)
    for args, ties in ((m10, False), (m10, True), (m3, True)):
        n0 = k8.MERGE_TABLE.launches
        got = k8.beam_merge(*args, ties=ties)
        if k8.MERGE_TABLE.launches != n0 + 1:
            fail(f"beam_merge: the device-memory route did not run at n_buf {args[-1]}")
        errm += mismatches(torch, got, k8.beam_merge_plain(*args, ties=ties))
    if errm:
        fail(f"beam_merge_table differs from its plain version ({errm} elements)")
    n10 = 10000 + 2 * 20000
    table.append(dict(
        name="beam_merge_table", max_abs_err=errm, library_ms=None, route="table",
        ms=time_ms(lambda: k8.beam_merge(*m10)), graph_ms=graph_ms(lambda: k8.beam_merge(*m10)),
        plain_ms=time_ms(lambda: k8.beam_merge_plain(*m10), iters=3),
        ties_ms=time_ms(lambda: k8.beam_merge(*m10, ties=True)),
        n_buf_3000_ms=time_ms(lambda: k8.beam_merge(*m3, ties=True)),
        shape=f"[{B},{K}] rows of {n10} candidates, n_buf 10000 (sampling at top_m 10000, "
              "round 0); n_buf_3000_ms: 3000 under ties",
        bytes=rows * n10 * 9 + rows * 10000 * 9,
    ))
    torch.cuda.synchronize()
    return table


def large_select_phase(np, torch, cfg, V, B, K, S):
    """Kernel 8's large-n route, forced (the wide route takes the shape on
    the path), at beam K over S shards' union window (n = K * (2K + S * 128
    + 2) candidates a query), against ``beam_select_plain`` and the route's
    own two-stage specification, bit for bit, in both orders."""
    from seal_tpu_torch.kernels import beam_select as k8
    from seal_tpu_torch.kernels import build

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    i32 = torch.int32
    n_buf, w = 2 * K, S * 128
    n = K * (n_buf + w + 2)
    one_block = build.lib().seal_beam_select_smem(n, 2 * K, K, 0)
    if one_block <= build.SMEM_LIMIT:
        fail(f"beam_select_large: {n} candidates fit one block ({one_block} B)")
    rows = B * K
    lp = torch.log_softmax(torch.randn(rows, V, generator=g, device=dev) * 2, -1)
    lp = torch.round(lp * 4) / 4  # ties
    lp[:, 5] = 0.0

    def rint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev, dtype=i32)

    def rbool(p, shape):
        return torch.rand(shape, generator=g, device=dev) < p

    def take(tok):
        return torch.gather(lp, 1, tok.reshape(rows, -1).long()).reshape(tok.shape)

    btok = rint(0, 400, (B, K, n_buf))
    win_valid = rbool(0.6, (B, K, w))
    win_tok = torch.where(win_valid, rint(0, 400, (B, K, w)), cfg.pad_token_id)
    bs = torch.round(torch.randn(B, K, generator=g, device=dev) * 2) / 2 - 3
    bs[0, 1] = k8.NEG_INF
    args = ((btok, take(btok), rbool(0.7, (B, K, n_buf))), n_buf, win_tok, win_valid,
            take(win_tok), rbool(0.5, (B, K, 2))[..., 1:], lp, rint(0, 50, (B, K)),
            rbool(0.1, (B, K)), bs, rbool(0.5, (B, K)),
            torch.round(torch.randn(B, K, generator=g, device=dev)) - 4)
    kw = dict(K=K, eos=cfg.eos_token_id, pad=cfg.pad_token_id)
    plain_kw = dict(kw, stop_at_count=0, always_allow_eos=False)
    kw["route"] = "large"
    err = 0
    for ties in (False, True):
        n0 = k8.LARGE.launches
        got, gbad = k8.beam_select(*args, ties=ties, **kw)
        if k8.LARGE.launches != n0 + 1:
            fail("beam_select_large: the large-n route did not run")
        want, wbad = k8.beam_select_plain(*args, ties=ties, **plain_kw)
        spec, sbad = k8.beam_select_large_plain(*args, ties=ties, **plain_kw)
        err += mismatches(torch, got + (gbad,), want + (wbad,))
        err += mismatches(torch, spec + (sbad,), want + (wbad,))
    if err:
        fail(f"beam_select_large differs from its plain version ({err} elements)")
    ncand = n_buf + w + 2
    return [dict(
        name="beam_select_large", max_abs_err=err, library_ms=None,
        ms=time_ms(lambda: k8.beam_select(*args, **kw)),
        plain_ms=time_ms(lambda: k8.beam_select_plain(*args, **plain_kw), iters=3),
        spec_plain_ms=time_ms(lambda: k8.beam_select_large_plain(*args, **plain_kw), iters=3),
        ties_ms=time_ms(lambda: k8.beam_select(*args, ties=True, **kw)),
        shape=f"[{B},{K},{ncand}]: {n} candidates a query (one block would need "
              f"{one_block} B of shared memory)",
        bytes=(B * K * (n_buf * 9 + w * 9 + 1 + 4 + 1 + 4 + 1 + 4) + rows * 8
               + B * (2 * K * 13 + K * 13 + 1)),
    )]


def large_route_phase(np, torch, V, B, K):
    """The large routes of kernels 8 and 3 (ROADMAP C.2) against their
    plain versions at the sizes that reach them: kernel 8's merge of a
    sampling loop round at top_m 512 ([B, K] rows of 512 + 4096 + 4096
    candidates) and of a 20000-wide loop chunk at beam 15 (30 + 20000 +
    20000), in both orders; kernel 3 at k = 16385 and 20000 on [B*K, V]
    and k = V on [B, V], bit for bit, beside ``torch.topk``."""
    from seal_tpu_torch.kernels import beam_select as k8
    from seal_tpu_torch.kernels import row_topk as k3

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    rows = B * K
    lp = torch.round(torch.log_softmax(torch.randn(rows, V, generator=g, device=dev) * 2, -1)
                     * 8) / 8
    lp[:, 5] = 0.0
    lp[::2, 6] = -0.0

    def merge_args(n_buf, n_top):
        top_lp, top_idx = k3.row_topk_plain(lp, n_top)
        ok = (torch.rand(B, K, n_top + 1, generator=g, device=dev) < 0.5)[..., :n_top]
        slab = torch.randint(0, min(3 * n_top, V), (B, K, n_top), generator=g, device=dev,
                             dtype=torch.int32)
        slab_lp = torch.gather(lp, 1, slab.reshape(rows, -1).long()).reshape(B, K, n_top)
        bt = torch.argsort(torch.rand(rows, V, generator=g, device=dev), -1)[:, :n_buf]
        blp = torch.gather(lp, 1, bt).reshape(B, K, n_buf)
        buf = (bt.to(torch.int32).reshape(B, K, n_buf), blp,
               torch.rand(B, K, n_buf, generator=g, device=dev) < 0.7)
        return (buf, top_idx.to(torch.int32).reshape(B, K, n_top), top_lp.reshape(B, K, n_top),
                ok, slab, slab_lp, torch.rand(B, K, n_top, generator=g, device=dev) < 0.8, V,
                n_buf)

    table = []
    err8, timed = 0, {}
    for label, n_buf, n_top in (("sample", 512, 4096), ("loop_chunk", 2 * K, 20000)):
        args = merge_args(n_buf, n_top)
        for ties in (False, True):
            n0 = k8.MERGE_LARGE.launches
            got = k8.beam_merge(*args, ties=ties)
            if k8.MERGE_LARGE.launches != n0 + 1:
                fail(f"beam_merge_large: the large-n route did not run ({label})")
            err8 += mismatches(torch, got, k8.beam_merge_plain(*args, ties=ties))
        timed[label] = (args, n_buf + 2 * n_top)
    if err8:
        fail(f"beam_merge_large differs from its plain version ({err8} elements)")
    args, n = timed["sample"]
    largs, ln = timed["loop_chunk"]
    table.append(dict(
        name="beam_merge_large", max_abs_err=err8, library_ms=None,
        ms=time_ms(lambda: k8.beam_merge(*args)),
        plain_ms=time_ms(lambda: k8.beam_merge_plain(*args), iters=3),
        ties_ms=time_ms(lambda: k8.beam_merge(*args, ties=True)),
        graph_ms=graph_ms(lambda: k8.beam_merge(*args)),
        loop_chunk_ms=time_ms(lambda: k8.beam_merge(*largs)),
        loop_chunk_plain_ms=time_ms(lambda: k8.beam_merge_plain(*largs), iters=3),
        shape=f"[{B},{K}] rows of {n} candidates (sampling at top_m 512; "
              f"{k8.merge_widths(n, 512, k8.merge_chunk(512))} a pass); loop_chunk: {ln} "
              f"(exact_loop_chunk 20000, beam {K})",
        bytes=rows * n * 9 + rows * 512 * 9,
    ))
    err3, sites = 0, []
    for x, k in ((lp, k3.MAX_K + 1), (lp, 20000), (lp[:B], V)):
        n0 = k3.GLOBAL_SORT.launches
        gv, gi = k3.row_topk(x, k)
        if k3.GLOBAL_SORT.launches != n0 + 1:
            fail(f"row_topk_global: k = {k} did not take the global sort")
        wv, wi = k3.row_topk_plain(x, k)
        err3 += int((gi != wi).sum()) + mismatches(torch, (gv,), (wv,))
        r = x.shape[0]
        sites.append(dict(shape=f"[{r},{V}]", k=k, ms=time_ms(lambda: k3.row_topk(x, k)),
                          library_ms=time_ms(lambda: torch.topk(x, k)),
                          bound_ms=(x.numel() * 4 + r * k * 12) / HBM_BYTES_PER_S * 1e3))
    if err3:
        fail(f"row_topk_global differs from its plain version ({err3} elements)")
    log(f"row_topk global sort ({CARD}): " + "; ".join(
        f"{c['shape']} k={c['k']} {c['ms']:.4f} ms, torch.topk {c['library_ms']:.4f}, bound "
        f"{c['bound_ms']:.4f}" for c in sites) + f"; bit-equal: {not err3}")
    table.append(dict(
        name="row_topk_global", max_abs_err=err3,
        ms=time_ms(lambda: k3.row_topk(lp, 20000)),
        plain_ms=time_ms(lambda: k3.row_topk_plain(lp, 20000), iters=3),
        library_ms=time_ms(lambda: torch.topk(lp, 20000)),
        graph_ms=graph_ms(lambda: k3.row_topk(lp, 20000)),
        sites=sites, shape=f"[{rows},{V}] k=20000 (the 20000-wide loop chunk); sites: k = "
                           f"{k3.MAX_K + 1}, 20000 and {V}",
        bytes=lp.numel() * 4 + rows * 20000 * 12,
    ))
    torch.cuda.synchronize()
    return table


def sharded_phase(np, torch, m, zero_counts, read_counts, op_calls):
    """The corpus-sharded index (the module docstring's item 12): generation
    over 4 shards on the card beside the monolithic Psi index, the gates,
    the config-5 shape (beam 32) through kernel 8's wide route, the
    sharded searcher beside the monolithic one, and the shard modes
    against their plain versions.  ``m`` carries the main path's objects.
    Returns (kernel rows, readings)."""
    from seal_tpu_torch import bench_generate, bench_search
    from seal_tpu_torch.decoding import generate
    from seal_tpu_torch.kernels import beam_select
    from seal_tpu_torch.parallel.sharded_decode import sharded_fm_index_generate
    from seal_tpu_torch.parallel.sharded_index import ShardedTorchIndex

    cfg, params, ids, mask, kw = m["cfg"], m["params"], m["ids"], m["mask"], m["kw"]
    host, index, canon = m["host"], m["index"], m["canon"]
    B, K = ids.shape[0], kw["num_beams"]
    special = (cfg.eos_token_id, cfg.pad_token_id, cfg.bos_token_id)
    t0 = time.perf_counter()
    si, hosts = bench_generate.sharded_index("cuda")
    S = si.n_shards
    n_tokens = sum(len(h) for h in hosts)
    log(f"sharded index: {S} shards of {list(si.shard_rows)} rows (padded to {si.n_max}), "
        f"{si.memory_bytes()} B = {si.memory_bytes() / n_tokens:.2f} B/token (psi "
        f"{index.memory_bytes() / (index.n_rows - 1):.2f}); set-up {time.perf_counter() - t0:.1f} s")
    si1 = ShardedTorchIndex.from_hosts([host], bench_generate.VOCAB, device="cuda")
    grounded = {}

    def hyp_keys(hyp_lists, what):
        n = 0
        for q in hyp_lists:
            for score, toks in q:
                key = tuple(t for t in toks[1:] if t not in special)
                if not np.isfinite(score):
                    fail(f"{what}: non-finite score {score} for {toks}")
                if key:
                    n += 1
                    if key not in grounded:
                        grounded[key] = sum(h.get_count(list(key)) for h in hosts) > 0
                    if not grounded[key]:
                        fail(f"{what}: key in no shard: {list(key)}")
        if n == 0:
            fail(f"{what}: no keys emitted")
        return n

    def run(ix=si, **extra):
        out = sharded_fm_index_generate(cfg, params, ix, None, ids, mask, **{**kw, **extra})
        torch.cuda.synchronize()
        return out

    def run_mono(**extra):
        out = generate.fm_index_generate(cfg, params, index, ids, mask, **{**kw, **extra})
        torch.cuda.synchronize()
        return out

    def canon_of(hyps):
        return [sorted((tuple(t), s) for s, t in q) for q in hyps]

    def same_or_tie(a, b, rerun_a, rerun_b, what):
        """``a`` == ``b``, or they differ by an exact score tie: then both
        agree under exact_ties, and the tie order changes one of them."""
        if a == b:
            return True
        ta, tb = canon_of(rerun_a()), canon_of(rerun_b())
        if ta != tb or (ta == a and tb == b):
            fail(f"{what}: hypotheses differ, and no exact tie explains it")
        else:
            log(f"{what}: the hypotheses differ by an exact score tie; under exact_ties both "
                "agree")
        return False

    def once_per_call(path, counts):
        """Each shard mode launched once per op call of its run."""
        want = {"fm_search_sharded": op_calls["extend"] + op_calls["contains"]
                + op_calls["validate"] + op_calls["advance"],
                "fm_search_step_sharded": op_calls["extend"],
                "fm_search_advance_sharded": op_calls["advance"],
                "window_gather_sharded": op_calls["window_gather"] + op_calls["window_slab"]
                + op_calls["slab"],
                "window_slab_sharded": op_calls["window_slab"],
                "slab_gather_sharded": op_calls["slab"],
                "fm_sequences_sharded": op_calls["range_for"],
                "bucket_counts_sharded": op_calls["bucket_counts"],
                "fm_dense_counts_sharded": op_calls["dense_counts"],
                "fm_dense_mask_sharded": op_calls["dense_mask"]}
        for name, n in want.items():
            if counts[name] != n:
                fail(f"{path}: {name} launched {counts[name]} times for {n} op calls")
        return want

    # ---- generation over 4 shards: timed, counted, grounded --------------
    t_phase = time.perf_counter()
    run()  # warm-up
    zero_counts()
    op_calls.clear()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        hyps = run()
        times.append(time.perf_counter() - t0)
    counts = read_counts("generate_sharded")
    calls = once_per_call("generate_sharded", counts)
    fallback = generate.LAST_DECODE_STATS["fallback_steps"]
    per_batch = statistics.median(times)
    n_keys = hyp_keys(hyps, "generate_sharded")
    log(f"generate_sharded ({S} shards): {[round(t, 4) for t in times]} s/batch; median "
        f"{per_batch:.4f} s = {B / per_batch:.1f} queries/s; fallback_steps {fallback}; {n_keys} "
        f"keys grounded in the union; op calls {dict(calls)}")
    log(f"launches in the generate_sharded run: {counts}")
    # the same call's monolithic Psi index, in turns (5 rounds)
    turns = {"psi": [], "sharded": []}
    for _ in range(5):
        for name, fn in (("psi", run_mono), ("sharded", run)):
            t0 = time.perf_counter()
            fn()
            turns[name].append(time.perf_counter() - t0)
    qps = {k: B / statistics.median(v) for k, v in turns.items()}
    log("generation in turns (5 rounds of psi, sharded): " + "; ".join(
        f"{k} {[round(t, 4) for t in v]} s, median {qps[k]:.1f} queries/s"
        for k, v in turns.items()))
    # one monolithic batch and one of each sharded route, counted
    zero_counts()
    run_mono()
    mono_counts = read_counts("generate_once")
    zero_counts()
    op_calls.clear()
    one = run()
    one_counts = read_counts("generate_sharded_once")
    once_per_call("generate_sharded_once", one_counts)
    pairs = {"fm_search": "fm_search_sharded", "fm_search_advance": "fm_search_advance_sharded",
             "window_gather": "window_gather_sharded",
             "window_slab": "window_slab_sharded", "slab_gather": "slab_gather_sharded",
             "bucket_counts": "bucket_counts_sharded", "fm_dense_mask": "fm_dense_mask_sharded",
             "fm_sequences": "fm_sequences_sharded"}
    log("one batch, launches: monolithic kernel / its shard mode at 4 shards: " + ", ".join(
        f"{a} {mono_counts[a]} / {one_counts[b]}" for a, b in pairs.items()))
    if canon_of(one) != canon_of(hyps):
        fail("generate_sharded: a batch differs from the timed batches")

    # ---- the gates --------------------------------------------------------
    zero_counts()
    op_calls.clear()
    full = run(force_full=True)
    once_per_call("generate_sharded_force_full", read_counts("generate_sharded_force_full"))
    same_ff = same_or_tie(canon_of(full), canon_of(hyps),
                          lambda: run(force_full=True, exact_ties=True),
                          lambda: run(exact_ties=True), "generate_sharded force_full")
    zero_counts()
    op_calls.clear()
    dense = run(exact_mask=True)
    once_per_call("generate_sharded_dense", read_counts("generate_sharded_dense"))
    same_dense = same_or_tie(canon_of(dense), canon_of(hyps),
                             lambda: run(exact_mask=True, exact_ties=True),
                             lambda: run(exact_ties=True), "generate_sharded_dense")
    hyp_keys(full, "generate_sharded_force_full")
    hyp_keys(dense, "generate_sharded_dense")
    same_mono = same_or_tie(canon_of(hyps), canon, lambda: run(exact_ties=True),
                            lambda: run_mono(exact_ties=True), "generate_sharded vs monolithic")
    # one shard is the monolithic index: identical hypotheses and, route by
    # route, the same launches as the monolithic kernels
    s1 = {}
    for path, extra in (("generate_sharded_s1", {}),
                        ("generate_sharded_s1_force_full", {"force_full": True}),
                        ("generate_sharded_s1_dense", {"exact_mask": True})):
        zero_counts()
        mono = canon_of(run_mono(**extra))
        want = read_counts(path.replace("sharded_s1", "mono"))
        zero_counts()
        got = canon_of(run(ix=si1, **extra))
        have = read_counts(path)
        s1[path] = got == mono
        if not s1[path]:
            fail(f"{path}: one shard's hypotheses differ from the monolithic index's")
        for a, b in pairs.items():
            if have[b] != want[a]:
                fail(f"{path}: {b} launched {have[b]} times, the monolithic {a} {want[a]}")
    log(f"sharded gates: {n_keys} keys grounded; force_full identical {same_ff}; exact_mask "
        f"identical {same_dense}; 4 shards identical to the monolithic index {same_mono}; one "
        f"shard identical with the monolithic launches {s1}; each shard mode once per op call")

    # ---- the config-5 shape: beam 32 over the shards ----------------------
    K32 = 32
    kw32 = dict(num_beams=K32, window=0)
    zero_counts()
    t0 = time.perf_counter()
    h32 = run(**kw32)
    b32_s = time.perf_counter() - t0
    c32 = read_counts("generate_sharded_beam32")
    n_wide = c32["beam_select_wide"]
    n_dec = c32["decode_steps"] // (kw["max_length"] - 1)  # decodes, a redo included
    if n_wide != c32["decode_steps"] - n_dec:  # one launch a selection (the parent's two)
        fail(f"generate_sharded_beam32: the wide route ran {n_wide} times for "
             f"{c32['decode_steps'] - n_dec} selections")
    n32 = hyp_keys(h32, "generate_sharded_beam32")
    zero_counts()
    f32_ = run(force_full=True, **kw32)
    read_counts("generate_sharded_beam32_force_full")
    same32 = same_or_tie(canon_of(f32_), canon_of(h32),
                         lambda: run(force_full=True, exact_ties=True, **kw32),
                         lambda: run(exact_ties=True, **kw32), "beam 32 force_full")
    zero_counts()
    d32 = run(exact_mask=True, **kw32)
    read_counts("generate_sharded_beam32_dense")
    same32d = same_or_tie(canon_of(d32), canon_of(h32),
                          lambda: run(exact_mask=True, exact_ties=True, **kw32),
                          lambda: run(exact_ties=True, **kw32), "beam 32 exact_mask")
    hyp_keys(f32_, "generate_sharded_beam32_force_full")
    hyp_keys(d32, "generate_sharded_beam32_dense")
    log(f"beam 32 over {S} shards: one batch in {b32_s:.3f} s = {B / b32_s:.1f} queries/s; "
        f"kernel 8's wide route {n_wide} times; {n32} keys grounded; force_full identical "
        f"{same32}; exact_mask identical {same32d}; launches {c32}")
    log(f"sharded generation phase wall {time.perf_counter() - t_phase:.1f} s")

    # ---- the searcher over 4 shards beside the monolithic one -------------
    searcher, queries = m["searcher"], m["queries"]
    t0 = time.perf_counter()
    sharded = bench_search.sharded_searcher(searcher)
    ssi = sharded.sharded_index
    s_tokens = len(sharded.fm_index)
    log(f"sharded searcher set-up {time.perf_counter() - t0:.1f} s: {ssi.n_shards} shards, "
        f"{ssi.memory_bytes() / s_tokens:.2f} B/token")
    unit = queries[: searcher.batch_size]
    sharded.batch_search(unit, k=bench_search.TOP_K)  # warm-up unit
    torch.cuda.synchronize()
    sharded.phase_timer.enabled = True
    # kernel 5's calls in the timed run: (mode, n, L) of each, and the first
    # inputs of each shape (the count filter's, timed in the kernel phase)
    from seal_tpu_torch.parallel import sharded_decode as sd_mod
    from seal_tpu_torch.parallel import sharded_index as si_mod

    k5_calls, k5_inputs, k5_fns = [], {}, {}
    for mod in (si_mod, sd_mod):
        k5_fns[mod] = mod.fm_sequences_sharded

        def logged(si_, tokens, lengths, count=False, _fn=k5_fns[mod], **kw_):
            key = (bool(count), *tuple(np.shape(tokens)))
            k5_calls.append(key)
            k5_inputs.setdefault(key, (torch.as_tensor(tokens, dtype=torch.int32,
                                                       device=si_.device).clone(),
                                       torch.as_tensor(lengths, dtype=torch.int32,
                                                       device=si_.device).clone()))
            return _fn(si_, tokens, lengths, count=count, **kw_)

        mod.fm_sequences_sharded = logged
    # kernel 1's shard modes in the same run: (mode, shape) of each call,
    # and the first inputs of each (the most common timed in the kernel
    # phase, on the searcher's index)
    k1_calls, k1_inputs = collections.Counter(), {}
    k1_fns = {name: getattr(sd_mod, name) for name in ("fm_search_sharded", "fm_advance_sharded")}

    def logged_search(si_, mode, tokens, lo, hi, **kw_):
        key = (mode, *tuple(tokens.shape))
        k1_calls[key] += 1
        k1_inputs.setdefault(key, tuple(x.clone() for x in (tokens, lo, hi)))
        return k1_fns["fm_search_sharded"](si_, mode, tokens, lo, hi, **kw_)

    def logged_advance(si_, sel_tok, sel_par, lo, hi, finished=None, **kw_):
        key = ("advance" if finished is not None else "advance step 0", *tuple(sel_tok.shape))
        k1_calls[key] += 1
        k1_inputs.setdefault(key, tuple(x.clone() if x is not None else None
                                        for x in (sel_tok, sel_par, lo, hi, finished)))
        return k1_fns["fm_advance_sharded"](si_, sel_tok, sel_par, lo, hi, finished, **kw_)

    sd_mod.fm_search_sharded, sd_mod.fm_advance_sharded = logged_search, logged_advance
    zero_counts()
    t0 = time.perf_counter()
    try:
        s_res = sharded.batch_search(queries, k=bench_search.TOP_K)
        torch.cuda.synchronize()
    finally:
        for mod, fn in k5_fns.items():
            mod.fm_sequences_sharded = fn
        for name, fn in k1_fns.items():
            setattr(sd_mod, name, fn)
    s_search = time.perf_counter() - t0
    s_counts = read_counts("batch_search_sharded")
    shapes = collections.Counter(k5_calls)
    log(f"kernel 5 in the batch_search_sharded run: {len(k5_calls)} launches; (count mode, n, "
        "L): launches " + ", ".join(f"{k}: {v}" for k, v in shapes.most_common())
        + f"; {sum(k[1] for k in k5_calls)} sequences in all")
    log(f"kernel 1's shard modes in the batch_search_sharded run: {sum(k1_calls.values())} "
        "launches; (mode, shape): launches " + ", ".join(
            f"{k}: {v}" for k, v in k1_calls.most_common()))
    searcher_calls = None
    k1_contains = [k for k, _ in k1_calls.most_common() if k[0] == "contains"]
    k1_advance = [k for k, _ in k1_calls.most_common() if k[0] == "advance"]
    if k1_contains and k1_advance:
        searcher_calls = (sharded.sharded_index, k1_inputs[k1_contains[0]],
                          k1_inputs[k1_advance[0]])
    count_filter = None
    if shapes:
        common = shapes.most_common(1)[0][0]
        count_filter = (*k5_inputs[common], searcher.device_index)
        log(f"kernel 5's most common call in the batch_search_sharded run: {common} "
            f"({shapes[common]} of {len(k5_calls)})")
    t0 = time.perf_counter()
    m_res = searcher.batch_search(queries, k=bench_search.TOP_K)
    torch.cuda.synchronize()
    m_search = time.perf_counter() - t0
    for r in s_res:
        sc = [d.score for d in r]
        if not r or not all(np.isfinite(sc)) or sc != sorted(sc, reverse=True):
            fail("batch_search_sharded: an empty result, or non-finite or unsorted scores")
    n_body, n_title = searcher_grounding(sharded, unit)
    # the generated keys: the body decode's hypotheses of one unit
    inputs = [" " + q.strip() for q in unit]

    def body(s, **extra):
        return s._generate(s.params, s._tokenize_batch(s._marked(inputs, "body")),
                           min_length=s.length, max_length=s.length, num_beams=s.beam,
                           forced_bos_token_id=None, top_m=s.top_m, window=s.window, **extra)

    same_keys = same_or_tie(canon_of(body(sharded)), canon_of(body(searcher)),
                            lambda: body(sharded, exact_ties=True),
                            lambda: body(searcher, exact_ties=True),
                            "batch_search_sharded body keys")
    overlap = [len({d.docid for d in a} & {d.docid for d in b}) for a, b in zip(s_res, m_res)]
    diffs = [abs(x.score - y.score) / abs(y.score) for a, b in zip(s_res, m_res)
             for x, y in zip(a, b) if x.docid == y.docid and y.score]
    log(f"batch_search_sharded: {len(queries)} queries in {s_search:.3f} s = "
        f"{len(queries) / s_search:.2f} queries/s (monolithic {len(queries) / m_search:.2f} in "
        f"turn, {m['e2e_qps']:.2f} earlier in this call); phases "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(sharded.phase_timer.totals.items()))
        + f"; {n_body} raw body and {n_title} raw title keys grounded in the union; body keys "
        f"identical to the monolithic searcher's {same_keys}; top-{bench_search.TOP_K} docids in "
        f"common with the monolithic searcher: mean {statistics.mean(overlap):.2f}, min "
        f"{min(overlap)}; largest relative score difference on shared docids "
        f"{max(diffs, default=0.0):.3e} (the ranker counts a sentinel a shard)")
    log(f"launches in the batch_search_sharded run: {s_counts}")
    del sharded
    table = sharded_kernel_phases(np, torch, si, hosts, bench_generate.VOCAB, B, K,
                                  count_filter=count_filter, searcher_calls=searcher_calls)
    table += large_select_phase(np, torch, cfg, bench_generate.VOCAB, B, K32, S)
    return table, dict(qps=B / per_batch, turns=qps, beam32_qps=B / b32_s,
                       bytes_per_token=si.memory_bytes() / n_tokens,
                       search_qps=len(queries) / s_search, mono_search_qps=len(queries) / m_search)


# the training phase: kernels 22 and 23 and the train step at BART-large's
# full width (section 16 of the docstring)
TRAIN_STEPS = 5
# kernel 22 against its plain version at the path shape: the loss within
# 2e-6 relative (V-wide f32 log-sum-exps summed in another order), ntok
# exactly; each row's lse within 2e-6 of an f64 log-sum-exp (about two ulps
# of an lse near 11); the gradient within 1e-6 of each row's largest entry
# (the target's, about 0.9 of the row's scale; 1.05e-7 measured on an H100
# at 700 W), so a backward that dropped the -eps/V term (2.2e-6 of it at
# V = 50,265) fails
NLL_RTOL, NLL_LSE_ATOL, NLL_GRAD_TOL = 2e-6, 2e-6, 1e-6
# kernel 23: the norm within 1e-5 relative (406M squares summed in another
# order); p, mu and nu after one update from the same norm within 1e-6
# relative of the plain version (the same f32 operations)
ADAMW_NORM_RTOL, ADAMW_RTOL = 1e-5, 1e-6


def train_kernel_rows(np, torch, cfg, tcfg, params, state, batch):
    """Kernels 22 and 23 against their plain versions at the path's shapes:
    the step's own logits and targets, its own gradients, parameters and
    moments; each timed eagerly and graph-replayed beside its plain
    version, its bound and one PyTorch call of the same function."""
    import torch.nn.functional as F

    from seal_tpu_torch.kernels import adamw, train_loss
    from seal_tpu_torch.models import bart
    from seal_tpu_torch.training import trainer

    pad, eps = cfg.pad_token_id, tcfg.label_smoothing
    b = trainer.batch_to(batch, "cuda")
    leaves = trainer.tree_leaves(params)
    with torch.no_grad():
        enc = bart.encode(cfg, params, b["src_ids"], b["src_mask"])
        x = bart.decode_full(cfg, params, enc, b["src_mask"], b["tgt_in"])
        x = x.reshape(-1, cfg.vocab_size).contiguous()
    del enc
    t = b["tgt_out"].reshape(-1).to(torch.int32)
    N, V = x.shape
    live = int((t != pad).sum())
    gout = torch.ones((), device="cuda")
    rows = []
    # ---- kernel 22, forward ------------------------------------------------
    loss, ntok, lse = train_loss.nll_forward(x, t, pad, eps)
    want, want_ntok = train_loss.label_smoothed_nll_plain(x, t, pad, eps)
    graph_loss = graph_result(torch, lambda: train_loss.nll_forward(x, t, pad, eps)[0])
    again = train_loss.nll_forward(x, t, pad, eps)[0]
    err = abs(loss.item() - want.item())
    if ntok.item() != want_ntok.item() or err > NLL_RTOL * abs(want.item()) \
            or graph_loss.item() != loss.item() or again.item() != loss.item():
        fail(f"label_smoothed_nll: loss {loss.item()} (graph {graph_loss.item()}, again "
             f"{again.item()}) vs plain {want.item()}, ntok {ntok.item()} vs "
             f"{want_ntok.item()}")

    def library_loss():
        return F.cross_entropy(x, t.long(), ignore_index=pad, label_smoothing=eps,
                               reduction="sum") / want_ntok

    lse_err = (lse - torch.logsumexp(x.double(), -1)).abs()[t != pad].max().item()
    if lse_err > NLL_LSE_ATOL:
        fail(f"label_smoothed_nll: lse off an f64 log-sum-exp by {lse_err:.3e} (tolerance "
             f"{NLL_LSE_ATOL})")
    lib_err = abs(library_loss().item() - want.item())
    rows.append(dict(
        name="label_smoothed_nll", shape=f"[{N}, {V}] f32, {live} rows not pad",
        ms=time_ms(lambda: train_loss.nll_forward(x, t, pad, eps)),
        graph_ms=graph_ms(lambda: train_loss.nll_forward(x, t, pad, eps)),
        plain_ms=time_ms(lambda: train_loss.label_smoothed_nll_plain(x, t, pad, eps), iters=5),
        library_ms=time_ms(library_loss, iters=5), max_abs_err=err,
        library_abs_err=lib_err, lse_abs_err=lse_err, bytes=live * V * 4 + N * 4 * 3,
        flops=4 * live * V))
    # ---- kernel 22, backward -----------------------------------------------
    grad = train_loss.nll_backward(x, t, lse, ntok, gout, pad, eps)
    want_grad = train_loss.nll_backward_plain(x, t, torch.logsumexp(x, -1), want_ntok, gout,
                                              pad, eps)
    graph_grad = graph_result(torch, lambda: train_loss.nll_backward(x, t, lse, ntok, gout,
                                                                      pad, eps))
    scale = want_grad.abs().amax(-1, keepdim=True).clamp(min=1e-30)
    rel = ((grad - want_grad).abs() / scale).max().item()
    if rel > NLL_GRAD_TOL or not torch.equal(graph_grad, grad):
        fail(f"label_smoothed_nll_backward: {rel:.3e} of a row's largest entry (tolerance "
             f"{NLL_GRAD_TOL}), graph-replayed equal {torch.equal(graph_grad, grad)}")
    del want_grad, graph_grad, grad
    xg = x.clone().requires_grad_(True)

    def library_fwd_bwd():
        ce = F.cross_entropy(xg, t.long(), ignore_index=pad, label_smoothing=eps,
                             reduction="sum") / want_ntok
        return torch.autograd.grad(ce, xg)

    def kernel_fwd_bwd():
        lo, nt, ls = train_loss.nll_forward(x, t, pad, eps)
        return train_loss.nll_backward(x, t, ls, nt, gout, pad, eps)

    rows.append(dict(
        name="label_smoothed_nll_backward", shape=f"[{N}, {V}] f32, {live} rows not pad",
        ms=time_ms(lambda: train_loss.nll_backward(x, t, lse, ntok, gout, pad, eps)),
        graph_ms=graph_ms(lambda: train_loss.nll_backward(x, t, lse, ntok, gout, pad, eps),
                          launches=5, replays=4),
        plain_ms=time_ms(lambda: train_loss.nll_backward_plain(x, t, lse, ntok, gout, pad, eps),
                         iters=5),
        # the library's forward and backward together, beside the kernel's
        library_ms=time_ms(library_fwd_bwd, iters=5), fwd_bwd_ms=time_ms(kernel_fwd_bwd),
        max_abs_err=rel, bytes=live * V * 4 + N * V * 4 + N * 8, flops=5 * live * V))
    del xg, x, lse
    torch.cuda.empty_cache()
    # ---- kernel 23: the step's own gradients -------------------------------
    try:
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            grads = torch.autograd.grad(trainer.loss_fn(cfg, params, b, eps), leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    n_par = sum(g.numel() for g in grads)
    norm = adamw.global_norm(list(grads))
    want_norm = adamw.global_norm_plain(list(grads))
    graph_norm = graph_result(torch, lambda: adamw.global_norm(list(grads)))
    norm_err = abs(norm.item() - want_norm.item())
    if norm_err > ADAMW_NORM_RTOL * want_norm.item() or graph_norm.item() != norm.item():
        fail(f"clip_global_norm: {norm.item()} (graph {graph_norm.item()}) vs plain "
             f"{want_norm.item()}")
    gl = list(grads)
    rows.append(dict(
        name="clip_global_norm", shape=f"{len(gl)} tensors, {n_par} f32",
        ms=time_ms(lambda: adamw.global_norm(gl)),
        graph_ms=graph_ms(lambda: adamw.global_norm(gl)),
        plain_ms=time_ms(lambda: adamw.global_norm_plain(gl), iters=5),
        library_ms=time_ms(lambda: torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(gl))), iters=5),
        max_abs_err=norm_err, bytes=n_par * 4, flops=2 * n_par))
    opt = trainer.make_optimizer(tcfg)
    h = opt.hyper(state)
    ms_, vs_ = trainer.tree_leaves(state.mu), trainer.tree_leaves(state.nu)
    want = [[a.clone() for a in lst] for lst in (leaves, ms_, vs_)]
    adamw.adamw_update_plain(want[0], gl, want[1], want[2], norm, h)
    got = [[a.clone() for a in lst] for lst in (leaves, ms_, vs_)]
    adamw.adamw_update(got[0], gl, got[1], got[2], norm, h)
    torch.cuda.synchronize()
    worst = 0.0
    for lst, ref in zip(got, want):
        for a, r in zip(lst, ref):
            d = ((a - r).abs() / r.abs().clamp(min=1e-30)).max().item()
            worst = max(worst, d)
    if worst > ADAMW_RTOL:
        fail(f"adamw_update: p, mu or nu off the plain version by {worst:.3e} relative")
    del want

    def update():
        adamw.adamw_update(got[0], gl, got[1], got[2], norm, h)

    def plain_update():
        adamw.adamw_update_plain(got[0], gl, got[1], got[2], norm, h)

    # the library's clip and fused AdamW on copies of the same tensors (its
    # clip divides by norm + 1e-6 and its decay is p * (1 - lr wd) before
    # the step: another function)
    lib_params = [torch.nn.Parameter(a.clone()) for a in got[0]]
    for p_, g_ in zip(lib_params, gl):
        p_.grad = g_
    lib_opt = torch.optim.AdamW(lib_params, lr=-h.neg_lr or 1e-4, betas=(tcfg.adam_b1,
                                tcfg.adam_b2), eps=1e-8, weight_decay=tcfg.weight_decay,
                                fused=True)

    def library_update():
        torch.nn.utils.clip_grad_norm_(lib_params, tcfg.max_grad_norm, foreach=True)
        lib_opt.step()

    rows.append(dict(
        name="adamw_update", shape=f"{len(gl)} tensors, {n_par} f32",
        ms=time_ms(update, iters=5), graph_ms=graph_ms(update, launches=5, replays=3),
        plain_ms=time_ms(plain_update, iters=3), library_ms=time_ms(library_update, iters=5),
        max_abs_err=worst, bytes=n_par * 28, flops=18 * n_par))
    del lib_params, lib_opt, got, grads, gl
    torch.cuda.empty_cache()
    return rows


def train_cli_run(np):
    """The train CLI on the card: a tiny word-vocab dataset in a temp dir,
    6 steps and the checkpoint at step 6 (restored into the port)."""
    import contextlib
    import io
    import tempfile

    from seal_tpu_torch.cli import train as train_cli
    from seal_tpu_torch.models.tokenizer import WordVocabTokenizer
    from seal_tpu_torch.training import checkpoint

    texts = ["alpha beta gamma", "delta epsilon zeta", "eta theta iota"]
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        tok = WordVocabTokenizer.train([" " + t for t in texts])
        tok_path = os.path.join(tmp, "word_vocab.json")
        tok.save(tok_path)
        with open(os.path.join(tmp, "train.source"), "w") as f:
            f.write("".join(f" {t} || body\n" for t in texts * 4))
        with open(os.path.join(tmp, "train.target"), "w") as f:
            f.write("".join(f" {t}\n" for t in texts * 4))
        save = os.path.join(tmp, "save")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = train_cli.main([os.path.join(tmp, "train"), save, "--tokenizer", tok_path,
                                 "--backbone", "tiny", "--batch_size", "4", "--max_update", "6",
                                 "--save_interval", "5", "--log_interval", "2", "--lr", "1e-3"])
        step = checkpoint.latest_step(save)
        files = sorted(os.listdir(save))
        logs = [json.loads(line) for line in out.getvalue().splitlines()
                if line.startswith('{"step"')]
    if rc != 0 or step != 6 or "step_6.npz" not in files or len(logs) != 3 \
            or not all(np.isfinite(r["loss"]) for r in logs):
        fail(f"train CLI on the card: rc {rc}, latest step {step}, files {files}, logs {logs}")
    return logs, files


def training_phase(np, torch, zero_counts, read_counts):
    """BART-large (bf16 compute, f32 master params from a seed) trained for
    5 steps on one seeded batch at the train CLI's defaults through
    ``make_train_step``; kernels 22 and 23 against their plain versions at
    its shapes; the card against the CPU on bart_tiny; the train CLI."""
    import dataclasses
    import threading

    from seal_tpu_torch import bench_generate
    from seal_tpu_torch.bench_train import TRAIN_BATCH, TRAIN_SRC, TRAIN_TGT, train_batch
    from seal_tpu_torch.models.config import bart_large
    from seal_tpu_torch.training import parity, trainer

    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()  # what the earlier phases still hold
    cfg = dataclasses.replace(bart_large(), dtype="bfloat16")
    tcfg = trainer.TrainConfig(learning_rate=1e-4, warmup_steps=1)
    t0 = time.perf_counter()
    params, state = trainer.init_train_state(cfg, tcfg, seed=0)
    batch = train_batch(cfg)  # one seeded batch at the train CLI's defaults
    step, _ = trainer.make_train_step(cfg, tcfg)
    n_par = sum(p.numel() for p in trainer.tree_leaves(params))
    log(f"training set-up {time.perf_counter() - t0:.1f} s: BART-large bf16, {n_par} f32 params "
        f"in {len(trainer.tree_leaves(params))} tensors, batch {TRAIN_BATCH} x "
        f"{TRAIN_SRC} / {TRAIN_TGT}, {int((batch['tgt_out'] != cfg.pad_token_id).sum())} "
        f"target tokens not pad")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses, walls = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, state, loss = step(params, state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = read_counts("train")
    peak = torch.cuda.max_memory_allocated()
    for name in TRAIN_STEP:
        if launches[name] != TRAIN_STEPS:
            fail(f"train: {name} launched {launches[name]} times in {TRAIN_STEPS} steps")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"train: losses {losses} (all finite, the last below the first)")
    log(f"train ({CARD}): {TRAIN_STEPS} steps, losses {losses}, step wall s "
        f"{[round(w, 4) for w in walls]} (median {statistics.median(walls[1:]):.4f} after the "
        f"first), peak memory {peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f} GB above the "
        f"{base / 1e9:.2f} GB the earlier phases hold); threads {threading.active_count()} "
        f"Python, {len(os.listdir('/proc/self/task'))} in the process; launches {launches}")
    prof = bench_generate.profile_batch(lambda: step(params, state, batch))
    log(f"train profiled step ({CARD}): {prof['kernels']} kernels, device busy "
        f"{prof['device_busy_ms']:.2f} ms of {prof['wall_ms']:.2f} ms wall "
        f"({100 * prof['busy_share']:.1f}%)")
    for row in prof["top"][:12]:
        log(f"  {row['ms']:8.3f} ms {row['calls']:6d} calls  {row['name']}")
    rows = train_kernel_rows(np, torch, cfg, tcfg, params, state, batch)
    del params, state
    torch.cuda.empty_cache()
    par = parity.card_against_cpu("cuda")
    if not par["ok"] or par["launches"] != (3, 3):
        fail(f"train steps on the card vs the CPU: losses {par['losses']} vs "
             f"{par['cpu_losses']}, params off by {par['param_err']:.3e}, kernels 22 and 23 "
             f"launched {par['launches']} times in 3 steps")
    log(f"train parity (bart_tiny f32, 3 steps, card vs CPU): losses within "
        f"{par['loss_err']:.3e} relative (tolerance {parity.LOSS_RTOL}), params within "
        f"{par['param_err']:.3e} (tolerance {parity.PARAM_ATOL})")
    logs, files = train_cli_run(np)
    log(f"train CLI on the card (tiny, bf16): log lines {logs}, checkpoint files {files}")
    return rows, dict(batch=TRAIN_BATCH, losses=losses, step_s=statistics.median(walls[1:]),
                      peak_gb=(peak - base) / 1e9,
                      device_ms=prof["device_busy_ms"], busy=prof["busy_share"],
                      kernels=prof["kernels"], wall_ms=prof["wall_ms"])


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "seal_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    global CARD
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    CARD = card
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")

    from seal_tpu_torch import bench_generate, bench_search
    from seal_tpu_torch.decoding import generate
    from seal_tpu_torch.kernels import (
        adamw,
        beam_select,
        bucket_counts,
        build,
        decode_attention,
        dense_scores,
        diverse_select,
        fm_search,
        locate,
        reorder_cache,
        rescore,
        row_select,
        row_topk,
        sample_select,
        train_loss,
        triton_logsoftmax,
        window_gather,
        wt_bucket_counts,
        wt_search,
        wt_window,
    )
    from seal_tpu_torch.models import bart, t5
    from seal_tpu_torch.parallel import sharded_decode
    from seal_tpu_torch.retrieval.searcher import SEALSearcher
    from seal_tpu_torch.scoring import keys as scoring

    counters = {
        "fm_search": fm_search.fm_search,
        "window_gather": window_gather.window_gather,
        "row_topk": row_topk.row_topk,
        "log_softmax_min_len": triton_logsoftmax.log_softmax_ban,
        "fm_sequences": fm_search.fm_sequences,
        "bucket_counts": bucket_counts.bucket_counts,
        "rescore_logprob": rescore.rescore_logprob,
        "beam_merge": beam_select.beam_merge,
        "beam_select": beam_select.beam_select,
        "cross_attention_step": decode_attention.cross_attention_step,
        "self_attention_step": decode_attention.self_attention_step,
        "reorder_cache": reorder_cache.reorder_cache,
        "wt_search": wt_search.wt_search,
        "wt_window_gather": wt_window.wt_window_gather,
        "wt_bucket_counts": wt_bucket_counts.wt_bucket_counts,
        "fm_dense_counts": fm_search.fm_dense_counts,
        "wt_dense_counts": wt_search.wt_dense_counts,
        "fm_dense_mask": fm_search.fm_dense_mask,
        "wt_dense_mask": wt_search.wt_dense_mask,
        "dense_scores": dense_scores.dense_scores,
        "dense_select": dense_scores.dense_select,
        "beam_select_ties": beam_select.TIES,
        "locate_rows": locate.locate_rows,
        "doc_index_of": locate.doc_index_of,
        "row_kth": row_select.row_kth,
        "beam_select_free": beam_select.FREE,
        "beam_select_spec": beam_select.SPEC,
        "topk_log_softmax": row_select.topk_log_softmax,
        "sample_select": sample_select.sample_select,
        # kernel 20 on candidate lists, and its count-reading mode
        "sample_select_list": sample_select.LIST,
        "sample_select_counts": sample_select.sample_select_counts,
        "diverse_select": diverse_select.diverse_select,
        "diverse_select_wide": diverse_select.ROUTES["wide"],
        "beam_candidates": beam_select.beam_candidates,
        "self_attention_step_t5": decode_attention.self_attention_step_rel,
        "fm_search_sharded": fm_search.fm_search_sharded,
        "window_gather_sharded": window_gather.window_gather_sharded,
        "fm_sequences_sharded": fm_search.fm_sequences_sharded,
        "bucket_counts_sharded": bucket_counts.bucket_counts_sharded,
        "fm_dense_counts_sharded": fm_search.fm_dense_counts_sharded,
        "fm_dense_mask_sharded": fm_search.fm_dense_mask_sharded,
        "beam_select_large": beam_select.LARGE,
        "beam_merge_large": beam_select.MERGE_LARGE,
        "row_topk_global": row_topk.GLOBAL_SORT,
        # kernel 9 in f32 (T5 as the JAX searcher builds it): its ffma route
        "cross_attention_step_f32": decode_attention.ROUTES["ffma"],
        "fm_search_advance": fm_search.ADVANCE,
        "fm_search_advance_sharded": fm_search.ADVANCE_SHARDED,
        "fm_search_step_sharded": fm_search.STEP_SHARDED,
        "beam_select_warp": beam_select.ROUTES["warp"],
        "beam_select_table": beam_select.ROUTES["table"],
        "beam_merge_table": beam_select.MERGE_TABLE,
        "beam_select_wide": beam_select.ROUTES["wide"],
        "beam_select_block": beam_select.ROUTES["block"],
        "window_slab": window_gather.WINDOW_SLAB,
        "slab_gather": window_gather.SLAB,
        "window_slab_sharded": window_gather.WINDOW_SLAB_SHARDED,
        "slab_gather_sharded": window_gather.SLAB_SHARDED,
        "wt_search_advance": wt_search.ADVANCE,
        "wt_window_slab": wt_window.WINDOW_SLAB,
        "wt_slab_gather": wt_window.SLAB,
        "bucket_support": bucket_counts.bucket_support,
        "wt_bucket_support": wt_bucket_counts.wt_bucket_support,
        "bucket_support_sharded": bucket_counts.bucket_support_sharded,
        "pruned_topk": row_topk.pruned_topk,
        "label_smoothed_nll": train_loss.nll_forward,
        "label_smoothed_nll_backward": train_loss.nll_backward,
        "clip_global_norm": adamw.global_norm,
        "adamw_update": adamw.adamw_update,
    }
    # the calls of the sharded index's ops (each must be one launch)
    op_calls: collections.Counter = collections.Counter()

    def counting_op(name, method):
        def counted_op(*a, **k):
            op_calls[name] += 1
            return method(*a, **k)
        return counted_op

    for _name in SHARD_OPS:
        setattr(sharded_decode.ShardedIndexOps, _name,
                counting_op(_name, getattr(sharded_decode.ShardedIndexOps, _name)))
    by_path: dict = {}  # path -> {kernel: launches in that path's run}
    # decode steps each path runs (the beam search calls the family's
    # decode_step through its module, so a counting wrapper sees every step)
    steps = {"n": 0, "decodes": 0}

    def counting(decode_step):
        def counted_decode_step(*a, **k):
            steps["n"] += 1
            return decode_step(*a, **k)
        return counted_decode_step

    bart.decode_step = counting(bart.decode_step)
    t5.decode_step = counting(t5.decode_step)

    def counting_decodes(search):  # each decode (a host redo included)
        def counted_search(*a, **k):
            steps["decodes"] += 1
            return search(*a, **k)
        return counted_search

    generate.constrained_beam_search = counting_decodes(generate.constrained_beam_search)

    def zero_counts():
        for fn in counters.values():
            fn.launches = 0
        steps["n"] = steps["decodes"] = 0

    def read_counts(path, no_select=0, layers=None):
        """The launches of ``path``'s run; ``no_select``: its decode steps
        that select nothing (forced-BOS steps); ``layers``: its model's
        decoder layers (default: BART-large's)."""
        by_path[path] = {name: fn.launches for name, fn in counters.items()}
        for name in PATH_KERNELS[path]:
            if by_path[path][name] <= 0:
                fail(f"kernel {name} was not launched on the {path} path")
        # the straggler rounds: one launch of the pruning select a round
        # (each round also gathers one slab), and no bucket counts mode
        fused = fused_window(path)
        rounds = by_path[path][fused[2]] if fused else 0
        if by_path[path]["pruned_topk"] != rounds:
            fail(f"{path}: pruned_topk launched {by_path[path]['pruned_topk']} times for "
                 f"{rounds} straggler rounds")
        for name in BUCKET_COUNTS_MODES:
            if by_path[path][name]:
                fail(f"{path}: the counts mode {name} was launched {by_path[path][name]} times")
        for name in PARENT_SELECT_ROUTES:
            if by_path[path][name]:
                fail(f"{path}: kernel 8's {name} was launched {by_path[path][name]} times")
        if "sharded" in path or path.endswith(WAVELET_LAYOUTS + tuple(
                f"{w}_force_full" for w in WAVELET_LAYOUTS)):
            for name in PSI_INDEX_KERNELS:
                if by_path[path][name]:
                    fail(f"{path}: the Psi index kernel {name} was launched "
                         f"{by_path[path][name]} times")
        if path.startswith(("generate", "batch_search")) and not path.endswith("force_full"):
            # every decode step ran both attentions in every layer, one
            # reorder and one selection: no plain attention, gather or
            # selection is left on the card, step 0 included
            n, layers = steps["n"], layers or cfg.decoder_layers
            select = SELECTS.get(path, "beam_select")
            self_attn, other = ("self_attention_step_t5", "self_attention_step")
            if "t5" not in path:
                self_attn, other = other, self_attn
            want = {"cross_attention_step": layers * n, self_attn: layers * n, other: 0,
                    "reorder_cache": n - no_select, select: n - no_select,
                    "fm_search_advance": n - no_select if psi_constrained(path) else 0,
                    "wt_search_advance": n - no_select if wavelet_constrained(path) else 0,
                    "fm_search_advance_sharded": n - no_select if sharded_constrained(path)
                    else 0, "fm_search_step_sharded": 0}
            for name in ("window_slab", "window_slab_sharded", "wt_window_slab"):
                if not fused or name != fused[1]:
                    want[name] = 0
            if fused:  # once a step after step 0, besides the straggler rounds' slabs
                want[fused[0]] = n - no_select - steps["decodes"] + by_path[path][fused[2]]
            if select != "beam_select":  # kernel 20 or 21 selects, kernel 8 nothing
                want["beam_select"] = 0
            # the counts modes on no path: exact_mask reads the mask modes
            want.update(dict.fromkeys(COUNTS_MODES, 0))
            if "dense" in path:
                # the dense step: kernel 15's or 16's mask mode and kernel 17
                # inside kernel 3's select once a step after step 0, its
                # streaming pass never; under sampling and diverse groups the
                # streaming pass, the select never
                selects = select == "beam_select"
                want[dense_mask_of(path)] = n - no_select - steps["decodes"]
                want["dense_select"] = n - no_select - steps["decodes"] if selects else 0
                if selects:
                    want["dense_scores"] = 0
            for name, count in want.items():
                if by_path[path][name] != count:
                    fail(f"{path}: {name} launched {by_path[path][name]} times for {n} decode "
                         f"steps (want {count})")
            by_path[path]["decode_steps"] = n
            by_path[path]["decodes"] = steps["decodes"]
        if "dense" in path and by_path[path]["beam_merge"]:
            fail(f"{path}: the dense mode launched the proposal merge "
                 f"{by_path[path]['beam_merge']} times")
        return by_path[path]

    t0 = time.perf_counter()
    build.lib()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s (nvcc {build.BUILD_SECONDS})")

    # ---- corpus, index, model, queries: the bench operating point -------
    t0 = time.perf_counter()
    host, index, cfg, params, ids, mask, kw = bench_generate.operating_point("cuda")
    log(f"index: {index.n_rows} rows, search_iters {index.search_iters}, "
        f"dir_shift {index.dir_shift}; set-up {time.perf_counter() - t0:.1f} s")
    B, K, V = bench_generate.BATCH, bench_generate.BEAM, bench_generate.VOCAB

    # ---- main path, timed; the launch counts come from this run only -----
    def run(**extra):
        out = generate.fm_index_generate(cfg, params, index, ids, mask, **kw, **extra)
        torch.cuda.synchronize()
        return out

    zero_counts()
    t0 = time.perf_counter()
    hyps = run()
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        hyps = run()
        times.append(time.perf_counter() - t0)
    launches = read_counts("generate")
    fallback = dict(generate.LAST_DECODE_STATS)
    per_batch = statistics.median(times)
    log(f"main path: first call {first_s:.3f} s, then {[round(t, 4) for t in times]} s/batch; "
        f"median {per_batch:.4f} s = {B / per_batch:.1f} queries/s "
        f"(batch {B}, beam {K}, length {kw['max_length']}, BART-large bf16, {index.n_rows - 1} tokens); "
        f"fallback_steps {fallback['fallback_steps']} of {fallback['num_steps']}")
    log(f"launches in the main-path run: {launches}")

    # ---- checks of the main path's output ----------------------------------
    special = (cfg.eos_token_id, cfg.pad_token_id, cfg.bos_token_id)
    n_keys = n_hyps = 0
    for q in hyps:
        n_hyps += len(q)
        for score, toks in q:
            key = [t for t in toks[1:] if t not in special]
            if not np.isfinite(score):
                fail(f"non-finite score {score} for {toks}")
            if key:
                n_keys += 1
                if host.get_count(key) <= 0:
                    fail(f"key not in the corpus: {key}")
    if n_keys == 0:
        fail("no keys emitted")
    log(f"checked {n_keys} keys of {n_hyps} hypotheses: every one occurs in the corpus"
        if not FAILURES else f"checked {n_keys} keys")
    zero_counts()
    full = run(force_full=True)
    log(f"launches in the force_full re-run: {read_counts('generate_force_full')}")
    canon = [sorted((tuple(t), s) for s, t in q) for q in hyps]
    if canon != [sorted((tuple(t), s) for s, t in q) for q in full]:
        fail("force_full hypotheses differ from the fast path's")
    else:
        log("force_full re-run: identical hypotheses")

    # ---- one more batch under torch.profiler: where the device time goes --
    prof = bench_generate.profile_batch(run)
    log(f"profiled batch: {prof['kernels']} kernels, device busy {prof['device_busy_ms']:.2f} ms "
        f"of {prof['wall_ms']:.2f} ms wall ({100 * prof['busy_share']:.1f}%, the profiler slows the host)")
    for row in prof["top"][:12]:
        log(f"  {row['ms']:8.3f} ms {row['calls']:6d} calls  {row['name']}")

    # ---- each kernel against its plain version, at main-path shapes ------
    table = kernel_phases(np, torch, host, index, V, B, K)
    table += decode_kernel_phases(np, torch, cfg, V, B, K, generate.resolve_window(0, K),
                                  ids.shape[1], kw["max_length"])
    table += select_route_phase(np, torch, cfg, V, B, K, generate.resolve_window(0, K))
    for row in table:
        log_kernel(row)
    one = torch.empty(1, device="cuda")
    log(f"launch floor: one eager zero_() of one element, {time_ms(lambda: one.zero_()):.4f} ms "
        "a launch back to back (CUDA events, 20 launches)")

    t0 = time.perf_counter()
    n_small = small_parity(np, torch)
    log(f"small-input parity (card vs CPU plain path, exact ties included): {n_small} keys "
        f"compared; phase wall {time.perf_counter() - t0:.1f} s")

    # ---- the bf16 LM head keeps an f32 result ----------------------------
    h = torch.randn(B * K, cfg.d_model, device="cuda").to(torch.bfloat16)
    head = bart.lm_logits(cfg, params, h)
    ref = h.float() @ params["shared"].float().T + params["final_logits_bias"]
    fin = torch.isfinite(ref)
    head_err = float((head[fin] - ref[fin]).abs().max())
    log(f"lm_logits: torch.mm(bf16, bf16, out_dtype=float32) -> {head.dtype}, "
        f"max err vs f32 matmul {head_err:.3e}")
    if head.dtype != torch.float32 or head_err > LM_HEAD_ATOL:
        fail(f"lm_logits bf16 head is off (dtype {head.dtype}, err {head_err})")

    # ---- the compact and hybrid layouts at the same generation point -------
    grounded = {}  # key -> occurs in the corpus (the host count, once a key)

    def hyp_keys(hyp_lists, what):
        """Check every key of ``hyp_lists`` against the host index."""
        n = 0
        for q in hyp_lists:
            for score, toks in q:
                key = tuple(t for t in toks[1:] if t not in special)
                if not np.isfinite(score):
                    fail(f"{what}: non-finite score {score} for {toks}")
                if key:
                    n += 1
                    if key not in grounded:
                        grounded[key] = host.get_count(list(key)) > 0
                    if not grounded[key]:
                        fail(f"{what}: key not in the corpus: {list(key)}")
        return n

    psi_bytes = index.memory_bytes()
    log(f"index bytes: psi {psi_bytes} ({psi_bytes / (index.n_rows - 1):.2f} B/token)")
    layouts, wt_runs = {}, {}
    for layout in WAVELET_LAYOUTS:
        t0 = time.perf_counter()
        wix = layouts[layout] = bench_generate.build_index(host, layout, "cuda")
        nbytes = wix.memory_bytes()
        log(f"index bytes: {layout} {nbytes} ({nbytes / (wix.n_rows - 1):.2f} B/token), digits "
            f"{wix.digits}, set-up {time.perf_counter() - t0:.1f} s")

        def run_layout(wix=wix, **extra):
            out = generate.fm_index_generate(cfg, params, wix, ids, mask, **kw, **extra)
            torch.cuda.synchronize()
            return out

        zero_counts()
        run_layout()  # warm-up
        l_times = []
        for _ in range(5):
            t0 = time.perf_counter()
            l_hyps = run_layout()
            l_times.append(time.perf_counter() - t0)
        l_launches = read_counts(f"generate_{layout}")
        l_fallback = generate.LAST_DECODE_STATS["fallback_steps"]
        l_batch = statistics.median(l_times)
        log(f"{layout} layout: {[round(t, 4) for t in l_times]} s/batch; median {l_batch:.4f} s = "
            f"{B / l_batch:.1f} queries/s (psi {B / per_batch:.1f} in this call); "
            f"fallback_steps {l_fallback}")
        log(f"launches in the {layout} run: {l_launches}")
        n_l = hyp_keys(l_hyps, layout)
        if n_l == 0:
            fail(f"{layout}: no keys emitted")
        if [sorted((tuple(t), s) for s, t in q) for q in l_hyps] != canon:
            fail(f"{layout}: hypotheses differ from the psi layout's (tokens or score bits)")
        zero_counts()
        l_full = run_layout(force_full=True)
        log(f"launches in the {layout} force_full re-run: "
            f"{read_counts(f'generate_{layout}_force_full')}")
        if [sorted((tuple(t), s) for s, t in q) for q in l_full] != canon:
            fail(f"{layout}: force_full hypotheses differ from the fast path's")
        l_prof = bench_generate.profile_batch(run_layout)
        log(f"{layout} checks: {n_l} keys grounded; hypotheses bit-identical to the psi layout's; "
            f"force_full identical" if not FAILURES else f"{layout} checks: {n_l} keys")
        log(f"{layout} profiled batch: {l_prof['kernels']} kernels, device busy "
            f"{l_prof['device_busy_ms']:.2f} ms of {l_prof['wall_ms']:.2f} ms wall "
            f"({100 * l_prof['busy_share']:.1f}%)")
        for row in l_prof["top"][:8]:
            log(f"  {row['ms']:8.3f} ms {row['calls']:6d} calls  {row['name']}")
        wt_runs[layout] = dict(qps=B / l_batch, bytes=nbytes, busy=l_prof["busy_share"])
    # the host clock drifts between phases: compare the layouts only in
    # turns (five rounds of psi, compact, hybrid; launches not counted)
    turns = {"psi": [], **{layout: [] for layout in WAVELET_LAYOUTS}}
    for _ in range(5):
        for layout, ix in (("psi", index), *layouts.items()):
            t0 = time.perf_counter()
            generate.fm_index_generate(cfg, params, ix, ids, mask, **kw)
            torch.cuda.synchronize()
            turns[layout].append(time.perf_counter() - t0)
    for layout, ts in turns.items():
        wt_runs.setdefault(layout, {})["turns_qps"] = B / statistics.median(ts)
    log("generation in turns (5 rounds of psi, compact, hybrid): " + "; ".join(
        f"{k} {[round(t, 4) for t in ts]} s, median {B / statistics.median(ts):.1f} queries/s"
        for k, ts in turns.items()))
    # one more profiled batch of each, in the reverse order (hybrid,
    # compact, psi): whether a profiled batch's host wall follows the layout
    # or its place in the call
    again = []
    for layout, ix in reversed((("psi", index), *layouts.items())):
        p = bench_generate.profile_batch(
            lambda ix=ix: generate.fm_index_generate(cfg, params, ix, ids, mask, **kw))
        again.append(f"{layout} busy {p['device_busy_ms']:.2f} ms of {p['wall_ms']:.2f} ms wall "
                     f"({100 * p['busy_share']:.1f}%)")
    log("profiled again, reverse order: " + "; ".join(again))
    wt_table = wavelet_kernel_phases(np, torch, host, index, layouts, V, B, K)
    for row in wt_table:
        log_kernel(row)
    table += wt_table

    # ---- the dense parity mode over the three layouts, and the tie order --
    # exact_mask: every step's allowed set is the whole count vector
    # (kernel 15 or 16, then 17, 3 and 8's epilogue); a parity mode, so two
    # timed batches after one warm-up.  Hypotheses must be bit-identical to
    # the fast path's (canon).
    t_dense = time.perf_counter()
    dense_runs = {}
    for layout, ix in (("psi", index), *layouts.items()):
        path = "generate_dense" + ("" if layout == "psi" else f"_{layout}")

        def run_dense(ix=ix, **extra):
            out = generate.fm_index_generate(cfg, params, ix, ids, mask, exact_mask=True, **kw,
                                             **extra)
            torch.cuda.synchronize()
            return out

        t_layout = time.perf_counter()
        run_dense()  # warm-up
        zero_counts()
        d_times = []
        for _ in range(2):
            t0 = time.perf_counter()
            d_hyps = run_dense()
            d_times.append(time.perf_counter() - t0)
        d_launches = read_counts(path)
        d_batch = statistics.median(d_times)
        d_canon = [sorted((tuple(t), s) for s, t in q) for q in d_hyps]
        same = d_canon == canon
        # hypotheses equal to the main path's are its grounded keys; any
        # other set is grounded here, key by key
        n_d = n_keys if same else hyp_keys(d_hyps, path)
        if not same:
            # the only admissible cause is an exact score tie at the 2K
            # cutoff: then both paths agree under exact_ties, and the tie
            # order changes at least one of them
            ties_f = [sorted((tuple(t), s) for s, t in q)
                      for q in generate.fm_index_generate(cfg, params, ix, ids, mask,
                                                          exact_ties=True, **kw)]
            ties_d = [sorted((tuple(t), s) for s, t in q) for q in run_dense(exact_ties=True)]
            if ties_f != ties_d or (ties_f == canon and ties_d == d_canon):
                fail(f"{path}: dense hypotheses differ from the fast path's, and no exact tie "
                     "explains it")
            else:
                log(f"{path}: dense and fast hypotheses differ by an exact score tie; under "
                    "exact_ties both paths agree")
        log(f"{path}: {[round(t, 4) for t in d_times]} s/batch; median {d_batch:.4f} s = "
            f"{B / d_batch:.1f} queries/s (fast path psi {B / per_batch:.1f}); {n_d} keys "
            f"grounded; hypotheses bit-identical to the fast path's (tokens and score bits): "
            f"{same}")
        log(f"launches in the {path} run: {d_launches}; phase wall "
            f"{time.perf_counter() - t_layout:.1f} s")
        dense_runs[layout] = dict(qps=B / d_batch, canon=d_canon)
    t0 = time.perf_counter()
    d_prof = bench_generate.profile_batch(
        lambda: generate.fm_index_generate(cfg, params, index, ids, mask, exact_mask=True, **kw))
    # the dense step's select is kernel 3's select instance on DenseScoreLoad
    sel_ms = sum(r["ms"] for r in d_prof["top"] if "DenseScoreLoad" in r["name"])
    topk_ms = sum(r["ms"] for r in d_prof["top"]
                  if "row_topk" in r["name"] and "DenseScoreLoad" not in r["name"])
    log(f"dense profiled batch (psi): {d_prof['kernels']} kernels, device busy "
        f"{d_prof['device_busy_ms']:.2f} ms of {d_prof['wall_ms']:.2f} ms wall "
        f"({100 * d_prof['busy_share']:.1f}%); the dense select (kernel 17 in kernel 3's "
        f"select) {sel_ms:.2f} ms, kernel 3 alone {topk_ms:.2f} ms = "
        f"{100 * (sel_ms + topk_ms) / d_prof['device_busy_ms']:.1f}% of the busy time; phase "
        f"wall {time.perf_counter() - t0:.1f} s")
    for row in d_prof["top"][:10]:
        log(f"  {row['ms']:8.3f} ms {row['calls']:6d} calls  {row['name']}")
    dense_runs["psi"].update(busy=d_prof["busy_share"],
                             topk_share=(sel_ms + topk_ms) / d_prof["device_busy_ms"])

    # exact_ties on the fast path (kernel 8's ties mode): the same
    # hypotheses as without it and as the dense run
    t0 = time.perf_counter()
    run(exact_ties=True)  # warm-up
    zero_counts()
    t_times = []
    for _ in range(2):
        t0 = time.perf_counter()
        t_hyps = run(exact_ties=True)
        t_times.append(time.perf_counter() - t0)
    t_launches = read_counts("generate_ties")
    t_canon = [sorted((tuple(t), s) for s, t in q) for q in t_hyps]
    if t_canon != canon or t_canon != dense_runs["psi"]["canon"]:
        fail("generate_ties: exact_ties hypotheses differ from the fast path's or the dense run's")
    log(f"generate_ties: {[round(t, 4) for t in t_times]} s/batch, "
        f"{B / statistics.median(t_times):.1f} queries/s; hypotheses equal to the fast path's and "
        f"the dense run's: {t_canon == canon == dense_runs['psi']['canon']}; fallback_steps "
        f"{generate.LAST_DECODE_STATS['fallback_steps']}")
    log(f"launches in the generate_ties run: {t_launches}; phase wall "
        f"{time.perf_counter() - t0:.1f} s")
    dense_table = dense_kernel_phases(np, torch, host, index, layouts, V, B, K)
    for row in dense_table:
        log_kernel(row)
    table += dense_table
    log(f"dense and tie phases: {time.perf_counter() - t_dense:.1f} s")

    # ---- the decode modes at the generation point --------------------------
    # modes, not the operating point: one warm-up and three timed batches each
    # (speculative on the wavelet layouts: one batch), counted from the
    # timed batches; q/s beside the fast path's from the top of this call
    def run_mode(path, ix=index, batches=3, warm=True, no_select=0, outs=None, **extra):
        def once():
            out = generate.fm_index_generate(cfg, params, ix, ids, mask, **{**kw, **extra})
            torch.cuda.synchronize()
            return out

        t_phase = time.perf_counter()
        if warm:
            once()
        zero_counts()
        ts = []
        for _ in range(batches):
            t0 = time.perf_counter()
            out = once()
            ts.append(time.perf_counter() - t0)
            if outs is not None:
                outs.append(out)
        counts = read_counts(path, no_select=no_select * batches)
        qps = B / statistics.median(ts)
        log(f"{path}: {[round(t, 4) for t in ts]} s/batch, {qps:.1f} queries/s (fast path "
            f"{B / per_batch:.1f}); phase wall {time.perf_counter() - t_phase:.1f} s")
        log(f"launches in the {path} run: {counts}")
        return out, counts, batches, qps

    def expect(path, counts, want):
        for name, n in want.items():
            if counts[name] != n:
                fail(f"{path}: {name} launched {counts[name]} times (want {n})")

    def canon_of(hyps):
        return [sorted((tuple(t), s) for s, t in q) for q in hyps]

    mode_qps = {}
    # free generation: kernel 3's top-256 and top-2K each step >= 1 (step
    # 0: the V-wide rows' top-2K), no index kernel
    f_hyps, c, nb, mode_qps["free"] = run_mode("generate_free", disable_fm_index=True)
    n = c["decode_steps"]
    expect("generate_free", c, {"row_topk": 2 * n - nb, "beam_select_free": n - nb,
                                "fm_search": 0,
                                "window_gather": 0, "beam_merge": 0, "bucket_counts": 0,
                                "fm_sequences": 0})
    f_canon = canon_of(f_hyps)
    narrow = canon_of(generate.fm_index_generate(cfg, params, index, ids, mask, **kw,
                                                 disable_fm_index=True, top_m=2 * K))
    if narrow != f_canon:
        fail("generate_free: hypotheses differ between top_m 256 and 2K")
    if not all(np.isfinite(sc) for q in f_hyps for sc, _ in q) or not any(f_hyps):
        fail("generate_free: no or non-finite hypotheses")
    n_off = sum(1 for q in f_hyps for _, t in q
                if [x for x in t[1:] if x not in special]
                and host.get_count([x for x in t[1:] if x not in special]) <= 0)
    log(f"generate_free: {sum(map(len, f_hyps))} hypotheses, identical at top_m 256 and "
        f"{2 * K}: {narrow == f_canon}; {n_off} keys leave the corpus (free generation)")

    # speculative over the three layouts: kernel 3's top-256, one membership
    # query and the window a step >= 1 (step 0: the V-wide top-2K); every key
    # grounded, bit-identical across layouts
    s_hyps, c, nb, mode_qps["speculative"] = run_mode("generate_spec", speculative=True)
    n = c["decode_steps"]
    expect("generate_spec", c, {"row_topk": n, "beam_select_spec": n - nb,
                                "beam_select_wide": n - nb, "window_gather": n - nb,
                                "fm_search": 2 * n - nb, "beam_merge": 0})
    s_canon = canon_of(s_hyps)
    n_s = hyp_keys(s_hyps, "generate_spec")
    spec_same = True
    for layout, wix in layouts.items():
        path = f"generate_spec_{layout}"
        l_hyps, c, nb, _ = run_mode(path, ix=wix, batches=1, warm=False, speculative=True)
        n = c["decode_steps"]
        expect(path, c, {"row_topk": n, "wt_window_gather": n - nb, "beam_select_wide": n - nb,
                         "wt_search": 2 * n - nb, "beam_merge": 0})
        if canon_of(l_hyps) != s_canon:
            spec_same = False
            fail(f"{path}: hypotheses differ from the psi layout's (tokens or score bits)")
    same_fast = sum(a == b for a, b in zip(s_canon, canon))
    log(f"speculative: {n_s} keys grounded; bit-identical across psi, compact and hybrid: "
        f"{spec_same}; {same_fast} of {B} queries' hypotheses equal the fast path's")
    mode_qps["speculative_same_as_fast"] = same_fast

    # forced BOS on the fast path: one more decode step, no selection in it.
    # BOS 0 carries the SEAL bias's NEG_INF logit, so its forced step leaves
    # every beam at NEG_INF and extraction drops every hypothesis (the JAX
    # decoder's semantics: the step adds lp[bos]); the timed run forces the
    # corpus's most frequent token instead, whose logit the bias leaves
    b0 = generate.fm_index_generate(cfg, params, index, ids, mask,
                                    **{**kw, "forced_bos_token_id": 0})
    if any(t[1] != 0 for q in b0 for _, t in q):
        fail("forced BOS 0: a hypothesis without BOS in column 1")
    bos = int(index.corpus_counts.argmax())
    b_hyps, c, nb, mode_qps["forced_bos"] = run_mode("generate_bos", no_select=1,
                                                      forced_bos_token_id=bos)
    n_b = 0
    for q in b_hyps:
        for sc, t in q:
            key = [x for x in t[2:] if x not in special]  # the BOS column is forced
            if t[:2] != [cfg.decoder_start_token_id, bos] or not np.isfinite(sc):
                fail(f"generate_bos: column 1 not pinned or a non-finite score: {t}")
            if key:
                n_b += 1
                if host.get_count(key) <= 0:
                    fail(f"generate_bos: key not in the corpus: {key}")
    b_full = generate.fm_index_generate(cfg, params, index, ids, mask,
                                        **{**kw, "forced_bos_token_id": bos}, force_full=True)
    if canon_of(b_full) != canon_of(b_hyps) or n_b == 0:
        fail("generate_bos: no keys, or force_full hypotheses differ from the fast path's")
    log(f"forced BOS: with BOS 0, {sum(map(len, b0))} hypotheses (its logit is NEG_INF); with "
        f"BOS {bos}, {n_b} keys grounded after the pinned column, force_full identical "
        f"{canon_of(b_full) == canon_of(b_hyps)}; {c['decode_steps']} decode steps")

    # the top-k warper: its masked log-softmax in one launch of kernel 3's
    # select (warper mode) at every step, step 0 included; neither kernel 19
    # nor kernel 4
    t_hyps, c, nb, mode_qps["topk"] = run_mode("generate_topk", topk=50)
    n = c["decode_steps"]
    expect("generate_topk", c, {"topk_log_softmax": n, "row_kth": 0, "log_softmax_min_len": 0})
    log(f"topk=50: {hyp_keys(t_hyps, 'generate_topk')} keys grounded")
    mode_table = mode_kernel_phases(np, torch, cfg, V, B, K,
                                    generate.resolve_window(0, K, speculative=True))
    for row in mode_table:
        log_kernel(row)
    table += mode_table
    t0 = time.perf_counter()
    n_small_modes = small_mode_parity(np, torch)
    log(f"small-input mode parity (card vs CPU plain path: free, speculative, forced BOS, topk, "
        f"hook, topk=1 free, sample, diverse; on the compact and hybrid layouts exact_mask, "
        f"diverse and diverse exact_mask): {n_small_modes} keys compared; phase wall "
        f"{time.perf_counter() - t0:.1f} s")
    # ---- constrained sampling and diverse groups at the generation point ----
    # modes, not the operating point: counted and timed as the decode modes
    # above.  Sampling: kernel 20 every step (step 0 on the V-wide rows under
    # the corpus mask), the proven loop's buffer through kernel 8's candidate
    # mode, no selection by kernel 8.  Under one seed the draws depend only
    # on (seed, step, chain, slot), so every batch and every layout (whose
    # candidates are identical) gives the same hypotheses.
    t_sd = time.perf_counter()
    L = kw["max_length"]
    s_outs = {0: [], 1: []}
    _, c, nb, mode_qps["sample"] = run_mode("generate_sample", outs=s_outs[0], sample=True, seed=0)
    n = c["decode_steps"]
    expect("generate_sample", c, {"sample_select": n, "beam_candidates": n - nb,
                                  "sample_select_list": n - nb, "sample_select_counts": 0})
    _, c, nb, mode_qps["sample_seed1"] = run_mode("generate_sample_seed1", warm=False,
                                                  outs=s_outs[1], sample=True, seed=1)
    s_canon = {seed: [canon_of(o) for o in outs] for seed, outs in s_outs.items()}
    same_seed = all(x == xs[0] for xs in s_canon.values() for x in xs)
    seeds_differ = s_canon[0][0] != s_canon[1][0]
    if not same_seed or not seeds_differ:
        fail(f"generate_sample: one seed identical in every batch {same_seed}, seeds 0 and 1 "
             f"differ {seeds_differ}")
    n_ks = hyp_keys(s_outs[0][0], "generate_sample") + hyp_keys(s_outs[1][0], "generate_sample")
    spread = sum(len({tuple(x for x in t[1:] if x not in special) for _, t in q if len(t) == L})
                 > 1 for q in s_outs[0][0])
    if 2 * spread <= B:
        fail(f"generate_sample: the chains of {B - spread} of {B} queries end in one key")
    sample_layouts = True
    for layout, wix in layouts.items():
        l_hyps, c, nb, _ = run_mode(f"generate_sample_{layout}", ix=wix, batches=1, warm=False,
                                    sample=True, seed=0)
        n_ks += hyp_keys(l_hyps, f"generate_sample_{layout}")
        if canon_of(l_hyps) != s_canon[0][0]:
            sample_layouts = False
            fail(f"generate_sample_{layout}: draws differ from the psi layout's under one seed")
    d_hyps, c, nb, mode_qps["sample_dense"] = run_mode(
        "generate_sample_dense", batches=1, warm=False, sample=True, seed=0, exact_mask=True)
    n = c["decode_steps"]
    # kernel 20 reads the count masks itself: no streaming pass, no write
    expect("generate_sample_dense", c, {"sample_select": n, "fm_dense_mask": n - nb,
                                        "fm_dense_counts": 0,
                                        "sample_select_counts": n - nb, "dense_scores": 0,
                                        "beam_candidates": 0, "beam_merge": 0})
    n_ks += hyp_keys(d_hyps, "generate_sample_dense")
    f_hyps, c, nb, mode_qps["sample_free"] = run_mode(
        "generate_sample_free", batches=1, warm=False, sample=True, seed=0, disable_fm_index=True)
    n = c["decode_steps"]
    expect("generate_sample_free", c, {"sample_select": n, "row_topk": n - nb, "fm_search": 0,
                                       "window_gather": 0, "beam_candidates": 0, "beam_merge": 0})
    if not any(f_hyps) or not all(np.isfinite(sc) for q in f_hyps for sc, _ in q):
        fail("generate_sample_free: no or non-finite hypotheses")
    # the sizes the card refused before (ROADMAP C.2): one sampled batch at
    # top_m 512 with a 20000-wide loop chunk, through kernel 8's large-n
    # merge and kernel 3's global sort
    lg_hyps, c, nb, mode_qps["sample_large"] = run_mode(
        "generate_sample_large", batches=1, warm=False, sample=True, seed=0, top_m=512,
        exact_loop_chunk=20000)
    n_kl = hyp_keys(lg_hyps, "generate_sample_large")
    log(f"large routes: sampling at top_m 512 with exact_loop_chunk 20000, {n_kl} keys grounded; "
        f"kernel 8's large-n merge {c['beam_merge_large']} calls, kernel 3's global sort "
        f"{c['row_topk_global']} calls")
    large_table = large_route_phase(np, torch, V, B, K)
    for row in large_table:
        log_kernel(row)
    table += large_table
    # the sizes the card refused before F1 and F2: one batch each, through
    # kernel 8's merge in device memory or its selection's table route
    fault = {}
    for path, extra, route in (
            ("generate_sample_ties_3000", dict(sample=True, seed=0, exact_ties=True, top_m=3000),
             "beam_merge_table"),
            ("generate_sample_10000", dict(sample=True, seed=0, top_m=10000), "beam_merge_table"),
            ("generate_spec_20000", dict(speculative=True, top_m=20000), "beam_select_table")):
        f_hyps, c, nb, fqps = run_mode(path, batches=1, warm=False, **extra)
        fault[path] = (hyp_keys(f_hyps, path), c[route], fqps)
    log("fault sizes (F1, F2): " + "; ".join(
        f"{p} {k} keys grounded, {n} calls of its route, {q:.1f} queries/s"
        for p, (k, n, q) in fault.items()))
    log(f"sampling: {n_ks} keys grounded; one seed identical in every batch: {same_seed}; seeds "
        f"0 and 1 differ: {seeds_differ}; {spread} of {B} queries' chains end in more than one "
        f"key; compact and hybrid draws identical to psi's: {sample_layouts}; free generation "
        f"{sum(map(len, f_hyps))} hypotheses")

    # diverse groups: three groups of five at penalty 0.5 (fairseq's
    # --diverse-beam-strength default), kernel 21 every step.  Each beam's
    # buffer holds its top 2K allowed tokens; the earlier groups' picks
    # penalize at most 2/3 of them, so no token outside the buffer can enter
    # a group's top 2*gs: the proposal route equals exact_mask bit for bit
    dkw = dict(diverse_bs_groups=3, diverse_bs_penalty=0.5)
    dv_hyps, c, nb, mode_qps["diverse"] = run_mode("generate_diverse", **dkw)
    n = c["decode_steps"]
    expect("generate_diverse", c, {"diverse_select": n, "beam_candidates": n - nb,
                                   "diverse_select_wide": nb})
    dv_canon = canon_of(dv_hyps)
    n_kd = hyp_keys(dv_hyps, "generate_diverse")
    dv_same = {}
    for layout, wix in layouts.items():
        l_hyps, *_ = run_mode(f"generate_diverse_{layout}", ix=wix, batches=1, warm=False, **dkw)
        n_kd += hyp_keys(l_hyps, f"generate_diverse_{layout}")
        dv_same[layout] = canon_of(l_hyps) == dv_canon
        if not dv_same[layout]:
            fail(f"generate_diverse_{layout}: hypotheses differ from the psi layout's")
    dd_hyps, c, nb, mode_qps["diverse_dense"] = run_mode(
        "generate_diverse_dense", batches=1, warm=False, exact_mask=True, **dkw)
    n = c["decode_steps"]
    expect("generate_diverse_dense", c, {"diverse_select": n, "fm_dense_mask": n - nb,
                                         "fm_dense_counts": 0,
                                         "dense_scores": n - nb, "beam_candidates": 0,
                                         "beam_merge": 0, "diverse_select_wide": n})
    n_kd += hyp_keys(dd_hyps, "generate_diverse_dense")
    dv_same["exact_mask"] = canon_of(dd_hyps) == dv_canon
    if not dv_same["exact_mask"]:
        # the only admissible cause is an exact score tie at a group's cutoff:
        # then both routes agree under exact_ties
        ties_p, ties_d = (canon_of(generate.fm_index_generate(
            cfg, params, index, ids, mask, **kw, **dkw, exact_ties=True, exact_mask=em))
            for em in (False, True))
        if ties_p != ties_d:
            fail("generate_diverse_dense: hypotheses differ from the proposal route's, and no "
                 "exact tie explains it")
        else:
            log("generate_diverse_dense: the routes differ by an exact score tie; under "
                "exact_ties they agree")
    dt_hyps, c, nb, mode_qps["diverse_ties"] = run_mode(
        "generate_diverse_ties", batches=1, warm=False, exact_ties=True, **dkw)
    n_kd += hyp_keys(dt_hyps, "generate_diverse_ties")
    dv_same["exact_ties"] = canon_of(dt_hyps) == dv_canon
    log(f"diverse groups: {n_kd} keys grounded; bit-identical to the psi proposal route's: "
        f"{dv_same}; phase wall {time.perf_counter() - t_sd:.1f} s")
    for name, extra in (("sample", dict(sample=True, seed=0)),
                        ("sample_dense", dict(sample=True, seed=0, exact_mask=True)),
                        ("topk", dict(topk=50)), ("diverse", dkw)):
        p = bench_generate.profile_batch(
            lambda extra=extra: generate.fm_index_generate(cfg, params, index, ids, mask, **kw,
                                                           **extra))
        # kernel 3's select (its warper mode apart), kernel 20 and the warper
        warp_ms = sum(r["ms"] for r in p["top"] if "WarperLoad" in r["name"])
        k3_ms = sum(r["ms"] for r in p["top"] if "row_topk" in r["name"]) - warp_ms
        k20_ms = sum(r["ms"] for r in p["top"] if "sample_" in r["name"])
        log(f"{name} profiled batch (psi): {p['kernels']} kernels, device busy "
            f"{p['device_busy_ms']:.2f} ms of {p['wall_ms']:.2f} ms wall "
            f"({100 * p['busy_share']:.1f}%); kernel 3 {k3_ms:.2f} ms = "
            f"{100 * k3_ms / p['device_busy_ms']:.1f}% of the busy time; kernel 20 "
            f"{k20_ms:.3f} ms; the warper (topk_log_softmax) {warp_ms:.3f} ms")
        for row in p["top"][:8]:
            log(f"  {row['ms']:8.3f} ms {row['calls']:6d} calls  {row['name']}")
    sd_table = sample_kernel_phases(np, torch, cfg, V, B, K, generate.resolve_window(0, K))
    for row in sd_table:
        log_kernel(row)
    table += sd_table
    del layouts

    # ---- second path: SEALSearcher.batch_search at the e2e bench point ----
    try:
        from seal_tpu_torch.cpp import native

        native.load()
        native_state = "loaded"
    except (ImportError, OSError, RuntimeError, subprocess.SubprocessError) as e:
        native_state = f"NOT loaded ({type(e).__name__}: {e}); the ranker runs its Python mirror"
    log(f"seal_tpu_torch.cpp.native (the ranker's C++ helpers): {native_state}")
    t0 = time.perf_counter()
    searcher, queries = bench_search.operating_point("cuda")
    log(f"searcher set-up {time.perf_counter() - t0:.1f} s: {searcher.num_docs} docs, "
        f"{searcher.device_index.n_rows - 1} tokens, vocab {searcher.tokenizer.vocab_size}, "
        f"title marker {searcher.title_eos_token_id}; knobs beam {searcher.beam}, length "
        f"{searcher.length}, batch_size {searcher.batch_size}, pipeline {searcher.pipeline}")
    unit = queries[: searcher.batch_size]
    t0 = time.perf_counter()
    searcher.batch_search(unit, k=bench_search.TOP_K)  # warm-up unit
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    searcher.phase_timer.enabled = True
    zero_counts()
    t0 = time.perf_counter()
    results = searcher.batch_search(queries, k=bench_search.TOP_K)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    search_launches = read_counts("batch_search")
    phases = dict(searcher.phase_timer.totals)
    searcher.phase_timer.enabled = False
    nonempty = sum(1 for r in results if r)
    e2e_qps = len(queries) / search_s
    log(f"batch_search: warm-up unit {warm_s:.3f} s; {len(queries)} queries in {search_s:.3f} s "
        f"= {e2e_qps:.2f} queries/s; phases (s, they overlap under the pipeline) "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(phases.items()))
        + f"; {nonempty}/{len(queries)} results non-empty, {sum(len(r) for r in results)} docs; "
        f"fallback_steps of the last decode {generate.LAST_DECODE_STATS['fallback_steps']}")
    log(f"launches in the batch_search run: {search_launches}")
    if nonempty == 0 or any(len(r) > bench_search.TOP_K for r in results):
        fail(f"batch_search results: {nonempty} non-empty")
    for r in results:
        scores = [d.score for d in r]
        if not all(np.isfinite(scores)) or scores != sorted(scores, reverse=True):
            fail("batch_search returned non-finite or unsorted scores")
    marked = searcher._tokenize_batch(searcher._marked([" " + q for q in unit], "body"))
    zero_counts()
    us = scoring.compute_unigram_scores(searcher.model_cfg, searcher.scorer_params, marked,
                                        tolist=False)
    log(f"launches in one unigram call: {read_counts('unigram')}")
    if us.shape != (len(unit), searcher.model_cfg.vocab_size) or not np.isfinite(us.max()):
        fail(f"unigram scores of shape {us.shape}")
    zero_counts()
    n_body, n_title = searcher_grounding(searcher, unit)
    log(f"launches in the grounding unit (body, title, title force_full): "
        f"{read_counts('grounding_unit')}")
    log(f"grounding unit: {n_body} raw body keys and {n_title} raw title keys checked"
        + ("; title force_full re-run identical" if not FAILURES else ""))
    sprof = bench_generate.profile_batch(lambda: searcher.batch_search(unit, k=bench_search.TOP_K))
    log(f"profiled unit ({len(unit)} queries): {sprof['kernels']} kernels, device busy "
        f"{sprof['device_busy_ms']:.2f} ms of {sprof['wall_ms']:.2f} ms wall "
        f"({100 * sprof['busy_share']:.1f}%, the profiler slows the host)")
    for row in sprof["top"][:12]:
        log(f"  {row['ms']:8.3f} ms {row['calls']:6d} calls  {row['name']}")
    stable = search_kernel_phases(np, torch, searcher.fm_index, searcher.device_index,
                                  searcher.model_cfg.vocab_size)
    for row in stable:
        log_kernel(row)
    table += stable
    # ---- the searcher in the dense parity mode: one unit, Psi index ------
    t0 = time.perf_counter()
    dsearch = SEALSearcher(searcher.fm_index, searcher.tokenizer, searcher.model_cfg,
                           searcher.params, backbone=searcher.backbone,
                           batch_size=searcher.batch_size, device_index=searcher.device_index,
                           exact_mask=True)
    zero_counts()
    d_res = dsearch.batch_search(unit, k=bench_search.TOP_K)
    torch.cuda.synchronize()
    d_search_s = time.perf_counter() - t0
    log(f"launches in the batch_search_dense unit: {read_counts('batch_search_dense')}")
    n_dense_docs = 0
    for want, got in zip(results[: len(unit)], d_res):
        if [d.docid for d in got] != [d.docid for d in want]:
            fail("batch_search_dense: documents differ from the fast searcher's")
        elif want and max(abs(a.score - b.score) / abs(b.score) for a, b in zip(got, want)) \
                > LAYOUT_SEARCH_RTOL:
            fail(f"batch_search_dense: scores differ from the fast searcher's by more than "
                 f"{LAYOUT_SEARCH_RTOL} relative")
        n_dense_docs += len(got)
    log(f"batch_search_dense: one unit of {len(unit)} queries in {d_search_s:.3f} s (set-up "
        f"included); {n_dense_docs} documents compared with the fast searcher's")
    del dsearch
    # ---- the searcher with free_generation: one unit, Psi index -----------
    fsearch = SEALSearcher(searcher.fm_index, searcher.tokenizer, searcher.model_cfg,
                           searcher.params, backbone=searcher.backbone,
                           batch_size=searcher.batch_size, device_index=searcher.device_index,
                           free_generation=True)
    fsearch.phase_timer.enabled = True
    zero_counts()
    t0 = time.perf_counter()
    f_res = fsearch.batch_search(unit, k=bench_search.TOP_K)
    torch.cuda.synchronize()
    f_search_s = time.perf_counter() - t0
    f_launches = read_counts("batch_search_free")
    for name in ("fm_search", "window_gather", "beam_merge", "bucket_counts"):
        if f_launches[name]:
            fail(f"batch_search_free: the index kernel {name} was launched in the decodes")
    f_nonempty = sum(1 for r in f_res if r)
    if not f_nonempty or any(not all(np.isfinite([d.score for d in r])) for r in f_res):
        fail(f"batch_search_free: {f_nonempty} non-empty results, or non-finite scores")
    log(f"batch_search_free: one unit of {len(unit)} queries in {f_search_s:.3f} s = "
        f"{len(unit) / f_search_s:.2f} queries/s (no warm-up); phases "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(fsearch.phase_timer.totals.items()))
        + f"; {f_nonempty}/{len(unit)} results non-empty; launches {f_launches}")
    mode_qps["batch_search_free"] = len(unit) / f_search_s
    del fsearch
    # ---- the searcher with diverse groups: one unit, Psi index ------------
    dvsearch = SEALSearcher(searcher.fm_index, searcher.tokenizer, searcher.model_cfg,
                            searcher.params, backbone=searcher.backbone,
                            batch_size=searcher.batch_size, device_index=searcher.device_index,
                            diverse_bs_groups=3, diverse_bs_penalty=0.5)
    dvsearch.phase_timer.enabled = True
    zero_counts()
    t0 = time.perf_counter()
    dv_res = dvsearch.batch_search(unit, k=bench_search.TOP_K)
    torch.cuda.synchronize()
    dv_search_s = time.perf_counter() - t0
    dv_launches = read_counts("batch_search_diverse")
    dv_nonempty = sum(1 for r in dv_res if r)
    if not dv_nonempty or any(not all(np.isfinite([d.score for d in r])) for r in dv_res):
        fail(f"batch_search_diverse: {dv_nonempty} non-empty results, or non-finite scores")
    n_dv_body, n_dv_title = searcher_grounding(dvsearch, unit)
    log(f"batch_search_diverse: one unit of {len(unit)} queries in {dv_search_s:.3f} s = "
        f"{len(unit) / dv_search_s:.2f} queries/s (no warm-up); phases "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(dvsearch.phase_timer.totals.items()))
        + f"; {dv_nonempty}/{len(unit)} results non-empty; {n_dv_body} raw body and "
        f"{n_dv_title} raw title keys grounded; launches {dv_launches}")
    mode_qps["batch_search_diverse"] = len(unit) / dv_search_s
    del dvsearch
    loc_table = locate_phase(np, torch, searcher, unit, zero_counts, read_counts)
    for row in loc_table:
        log_kernel(row)
    table += loc_table
    # ---- the searcher over the compact and hybrid layouts -----------------
    psi_docs = [[(d.docid, d.score) for d in r] for r in results]
    searchers = {"psi": searcher}
    for layout in WAVELET_LAYOUTS:
        t0 = time.perf_counter()
        ws = SEALSearcher(searcher.fm_index, searcher.tokenizer, searcher.model_cfg,
                          searcher.params, backbone=searcher.backbone,
                          batch_size=searcher.batch_size, **bench_search.layout_knobs(layout))
        nbytes = ws.device_index.memory_bytes()
        log(f"{layout} searcher set-up {time.perf_counter() - t0:.1f} s: index {nbytes} B "
            f"({nbytes / (ws.device_index.n_rows - 1):.2f} B/token; psi "
            f"{searcher.device_index.memory_bytes() / (ws.device_index.n_rows - 1):.2f})")
        ws.batch_search(unit, k=bench_search.TOP_K)  # warm-up unit
        torch.cuda.synchronize()
        ws.phase_timer.enabled = True
        zero_counts()
        t0 = time.perf_counter()
        wres = ws.batch_search(queries, k=bench_search.TOP_K)
        torch.cuda.synchronize()
        ws_s = time.perf_counter() - t0
        ws_launches = read_counts(f"batch_search_{layout}")
        ws_phases = dict(ws.phase_timer.totals)
        log(f"{layout} batch_search: {len(queries)} queries in {ws_s:.3f} s = "
            f"{len(queries) / ws_s:.2f} queries/s (psi {e2e_qps:.2f} in this call); phases "
            + ", ".join(f"{k} {v:.3f}" for k, v in sorted(ws_phases.items())))
        log(f"launches in the {layout} batch_search run: {ws_launches}")
        n_same = 0
        for want, got in zip(psi_docs, wres):
            got = [(d.docid, d.score) for d in got]
            if [d for d, _ in got] != [d for d, _ in want]:
                fail(f"{layout} batch_search: documents differ from the psi searcher's")
            elif want and max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(got, want)) \
                    > LAYOUT_SEARCH_RTOL:
                fail(f"{layout} batch_search: scores differ from the psi searcher's by more "
                     f"than {LAYOUT_SEARCH_RTOL} relative")
            n_same += len(got)
        log(f"{layout} batch_search: {n_same} documents compared with the psi searcher's")
        wt_runs[layout]["search_qps"] = len(queries) / ws_s
        searchers[layout] = ws
    search_turns = {layout: [] for layout in searchers}
    for _ in range(2):  # in turns, as the generation runs above
        for layout, srch in searchers.items():
            t0 = time.perf_counter()
            srch.batch_search(queries, k=bench_search.TOP_K)
            torch.cuda.synchronize()
            search_turns[layout].append(time.perf_counter() - t0)
    for layout, ts in search_turns.items():
        wt_runs[layout]["search_turns_qps"] = len(queries) / statistics.median(ts)
    log("batch_search in turns (2 rounds of psi, compact, hybrid): " + "; ".join(
        f"{k} {[round(t, 3) for t in ts]} s, {len(queries) / statistics.median(ts):.2f} queries/s"
        for k, ts in search_turns.items()))
    del searchers
    n_small_search = small_search_parity(np)
    log(f"small searcher parity (card vs CPU): {n_small_search} documents compared")
    n_small_free = small_search_parity(np, free_generation=True)
    log(f"small free_generation searcher parity (card vs CPU): {n_small_free} documents compared")
    # ---- T5-base: generation, the kernel mode, a searcher unit -------------
    t0 = time.perf_counter()
    t5_table, t5_run = t5_phase(np, torch, zero_counts, read_counts)
    for row in t5_table:
        log_kernel(row)
    table += t5_table
    log(f"T5 phase wall {time.perf_counter() - t0:.1f} s")
    # ---- the corpus-sharded index on one card -----------------------------
    t0 = time.perf_counter()
    sh_table, sh_run = sharded_phase(
        np, torch, dict(cfg=cfg, params=params, ids=ids, mask=mask, kw=kw, host=host, index=index,
                        canon=canon, searcher=searcher, queries=queries, e2e_qps=e2e_qps),
        zero_counts, read_counts, op_calls)
    for row in sh_table:
        log_kernel(row)
    table += sh_table
    log(f"sharded phase wall {time.perf_counter() - t0:.1f} s")
    # ---- the training path: BART-large train steps, kernels 22 and 23 -------
    t0 = time.perf_counter()
    tr_table, tr_run = training_phase(np, torch, zero_counts, read_counts)
    for row in tr_table:
        log_kernel(row)
    table += tr_table
    log(f"training phase wall {time.perf_counter() - t0:.1f} s")
    total = {name: sum(p[name] for p in by_path.values()) for name in counters}
    for name, n in total.items():
        if n <= 0 and name not in ENTRY_POINTS_ONLY:
            fail(f"kernel {name} was launched on no path")

    # the run's readings again, next to the result lines at the end of stdout
    log(f"summary: {card}; {B / per_batch:.1f} queries/s (median {per_batch:.4f} s/batch of "
        f"{len(times)}); fallback_steps {fallback['fallback_steps']}; {n_keys} keys checked; "
        f"busy {100 * prof['busy_share']:.1f}% under the profiler; "
        f"lm_logits err {head_err:.3e}; nvcc {build.BUILD_SECONDS} s; batch_search "
        f"{e2e_qps:.2f} queries/s ({len(queries)} queries, {nonempty} non-empty), phases "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(phases.items()))
        + f"; searcher unit busy {100 * sprof['busy_share']:.1f}% under the profiler; "
        + "; ".join(f"{k}: {v['qps']:.1f} queries/s, {v['bytes']} index bytes, busy "
                    f"{100 * v['busy']:.1f}%, batch_search {v['search_qps']:.2f} queries/s"
                    for k, v in wt_runs.items() if k != "psi")
        + "; in turns (generation, batch_search queries/s): " + ", ".join(
            f"{k} {v['turns_qps']:.1f} / {v['search_turns_qps']:.2f}" for k, v in wt_runs.items())
        + "; dense (exact_mask) generation queries/s: " + ", ".join(
            f"{k} {v['qps']:.1f}" for k, v in dense_runs.items())
        + f", psi busy {100 * dense_runs['psi']['busy']:.1f}% under the profiler, kernel 3 "
        f"(the dense select included) {100 * dense_runs['psi']['topk_share']:.1f}% of it; "
        "decode modes queries/s: "
        + ", ".join(f"{k} {v:.1f}" for k, v in mode_qps.items())
        + f"; T5-base f32 generation {t5_run['qps']:.1f} queries/s (bf16 batch "
        f"{t5_run['bf16_qps']:.1f}), busy {100 * t5_run['busy']:.1f}% under the profiler, "
        f"batch_search_t5 {t5_run['search_qps']:.2f} queries/s"
        f"; 4 shards on the card: generation {sh_run['qps']:.1f} queries/s (in turns: psi "
        f"{sh_run['turns']['psi']:.1f}, sharded {sh_run['turns']['sharded']:.1f}), "
        f"{sh_run['bytes_per_token']:.2f} index B/token, beam 32 {sh_run['beam32_qps']:.1f} "
        f"queries/s, batch_search {sh_run['search_qps']:.2f} (monolithic "
        f"{sh_run['mono_search_qps']:.2f})"
        f"; training BART-large bf16 batch {tr_run['batch']}: {tr_run['step_s']:.4f} s a step, "
        f"losses {[round(x, 4) for x in tr_run['losses']]}, peak {tr_run['peak_gb']:.2f} GB "
        f"above the earlier phases', "
        f"profiled step {tr_run['device_ms']:.2f} device ms of {tr_run['wall_ms']:.2f} ms "
        f"({100 * tr_run['busy']:.1f}% busy, {tr_run['kernels']} kernels)")
    log(f"launches by path: {json.dumps(by_path)}")
    kernels = []
    for row in table:
        route, src = SOURCES[row["name"]]
        kernels.append({
            "name": row["name"], "route": route, "source": src,
            "replaces": REPLACES[row["name"]], "launches": total[row["name"]],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "card": CARD,
            # kernels 9-10 and 8 name their own route (warp, mma, ...) beside
            # the contract's "cuda" or "triton"
            **({"kernel_route": row["route"]} if "route" in row else {}),
            **{k: row[k] for k in ("tol_ratio", "psi_ms", "hybrid_ms", "rank_route_ms",
                                   "default_ms", "merge_ms", "topk_dense_ms", "k64_ms",
                                   "row_topk_k64_ms", "library_k64_ms", "narrow_ms", "ties_ms",
                                   "wide_ms", "sample_ms", "spec_ms", "bf16_ms", "cross_ms",
                                   "f32_tol_ratio", "cross_tol_ratio", "cross_f32_ms",
                                   "cross_f32_tol_ratio", "extend_ms", "ranges_ms",
                                   "histogram_route_ms", "sites", "graph_ms",
                                   "library_graph_ms", "step0_ms", "step0_graph_ms",
                                   "long_ms", "long_plain_ms", "long_library_ms",
                                   "long_graph_ms", "long_library_graph_ms", "long_bound_ms",
                                   "long_tol_ratio", "bf16_graph_ms", "loop_chunk_ms",
                                   "group_graph_ms", "composed_ms", "composed_graph_ms", "block_ms",
                                   "block_graph_ms", "beam32_ms", "cand_ms", "n_buf_3000_ms",
                                   "chunked_ms", "chunked_graph_ms", "nopen_ms",
                                   "kernels_per_call", "proof_failures", "walk_ms",
                                   "hybrid_walk_ms", "hybrid_graph_ms", "cluster_ms",
                                   "cluster_graph_ms", "counts_ms", "counts_graph_ms",
                                   "hybrid_counts_graph_ms", "hybrid_composed_graph_ms",
                                   "hybrid_bound_ms", "ranges_graph_ms", "count_filter_shape",
                                   "count_filter_plan", "count_filter_ms",
                                   "count_filter_graph_ms", "count_filter_ranges_graph_ms",
                                   "count_filter_group_graph_ms", "mono_count_filter_ms",
                                   "mono_count_filter_graph_ms", "count_filter_bound_ms",
                                   "ranges_group_graph_ms", "row_topk_graph_ms",
                                   "large_k_graph_ms", "round_graph_ms", "ties_graph_ms",
                                   "beam32_graph_ms", "beam32_ties_graph_ms", "large_graph_ms",
                                   "beam32_bound_ms", "sample_graph_ms", "spec_graph_ms",
                                   "counts_group_graph_ms", "limit_graph_ms",
                                   "searcher_contains_shape", "searcher_contains_graph_ms",
                                   "searcher_advance_shape", "searcher_advance_graph_ms",
                                   "fwd_bwd_ms", "library_abs_err", "lse_abs_err")
               if k in row},
        })
    missing = set(SOURCES) - {k["name"] for k in kernels}
    if missing:
        fail(f"kernels not held against their plain versions: {sorted(missing)}")
    print(json.dumps({"kernels": kernels}))
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed", file=sys.stderr)
        return 1
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
