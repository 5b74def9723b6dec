#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # the full run, one card

1. Print the card (``nvidia-smi``) and build the CUDA selection kernels
   from ``src/repro_torch/kernels/csrc`` with nvcc.
2. Hold each kernel against its plain PyTorch version on the card, bit
   for bit (rows of 4096 plus a short and an odd row length, f32 and bf16
   inputs, k in {1, 4, 5, 8, 16, 64, 512, bs - 1, bs} up to bs: both the
   arg-max and the radix path; threshold gate on and off; for
   ``ef_accum_sparsify`` flat vectors of 100 to 2^22 + 5 elements, four
   (lr, thr) pairs and a misaligned view), then time it at the main
   path's largest shape beside its byte bound, its plain version and
   ``torch.topk`` on the same rows (no one PyTorch call computes
   ``ef_accum_sparsify``: its ``library_ms`` is null); every kernel's
   timed outputs are held bitwise against the plain version's too.
3. Small-input reference: the kernel-backed exchanges on the card
   (``lags_dp`` under three compressors, ``lags_hier2`` with 2 pods x 2;
   leaves of 10 to 28,000 entries) against the same exchanges on the
   CPU (plain versions), bitwise.
3a. The autotune pipeline (Eq. 18): ``profile_model`` of the real train
   step at full width and depth on the world-size-1 NCCL mesh,
   ``fit_hardware`` (measured FLOP/s; ``H100_NVLINK``'s α and β: one
   rank has no wire), then ``plan_schedule`` at P = 2 (the simulation
   path) and P = 4 (the distributed path, a what-if at world size 1:
   ``validate_for``'s worker-count warning is printed), a
   ``HierSchedule`` of pod 2 × data 2 (``plan_hier_schedule``: the inner
   tier on the fitted wire, the outer on the paper's 1 Gbps Ethernet)
   and ``plan_waves`` of the P = 4 plan; each saved and loaded back
   equal, every leaf's (name, d, ratio, k, k_b, and for a sparse leaf
   Eq. 18's t_spar at the fitted device-memory rate) printed; the
   profile's device-memory bytes per dense step and the rate fitted from
   them are printed too.  ``ef_select_pack`` and ``block_topk`` are then
   timed at a fixed sweep of k_b (5 to 2048) and at every k_b the block
   exchanges run under the plans, on the largest leaf, beside
   ``torch.topk`` and the byte bound, with the path each launch took; at
   k_b up to 64 both paths are timed, the numbers that place the
   crossover; every output of the three per-row kernels is held bitwise
   to its plain version at every k_b.
4. The main path: LAGS-SGD training of TinyLlama-1.1B at its published
   width (bf16 parameters), one 1024-token sequence per simulated
   worker, ratio 1000, 3 steps per configuration of ``SIM_CONFIGS``
   through ``Session.simulator``: P=2 workers at the published depth for
   ``dense`` and for ``lags_dp`` with the kernel backend under
   ``topk_exact``, ``topk_block`` and ``topk_hier``; and the two-tier
   ``lags_hier2`` with P=4 (2 pods x 2, inner ratio 100 under
   ``topk_block``, outer ratio 1000 under ``topk_exact``) at 16 of the
   22 layers, the depth at which its two f32 residuals per worker fit
   the card; and, under the P = 2 plan, ``lags_dp`` + kernel backend +
   ``topk_exact`` with ``measure_delta`` (the Eq. 20 delta of every
   leaf printed each step) and ``lags_dp`` + ``randk`` or
   ``topk_sampled`` (xla backend: neither has a kernel variant; every
   pick checked distinct, in range and equal to x[idx], every stream
   drawing anew each step).  Every loss must be finite and every kernel
   of a configuration must launch in it; the EF invariant is checked on
   one leaf (for ``lags_hier2`` on each tier).
5. ``ef_accum_sparsify``'s own path, the entry point
   ``ops.ef_accum_sparsify`` as its users call it: two error-feedback
   threshold passes over every leaf of one full-size TinyLlama-1.1B
   gradient, the threshold from ``ops.hier_topk_threshold`` at ratio
   1000; every leaf's (selected, residual) equals the plain version's
   bit for bit, and ``selected + residual == acc``.
5b. The paper's own workloads at their published widths: the CNN
   (``paper_cnn_cifar``, 41 leaves, 8 simulated workers x 32 CIFAR-shaped
   ``Blobs`` images, ratio 16, lr 0.05) through ``SimTrainer`` over
   ``cnn.cnn_loss``, and the 2 x 1500 sLSTM LM with layer norm
   (``paper_lstm_ptb``, 2 workers x 20 sequences of 35 tokens, ratio
   250) through ``Session.simulator``: 3 steps each of ``dense`` and
   ``lags_dp`` + kernel backend under ``topk_exact`` and ``topk_hier``,
   every kernel launch of step 0 held to its plain version bit for bit
   (one-row leaves of 10 to 2304 entries among them); then 40 CNN
   ``topk_exact`` steps whose loss must fall and 3 LSTM ones, with the
   Eq. 20 delta of every leaf (the max over leaves of >= 64 entries and
   over all printed).  ``ef_select_pack`` is then timed at the CNN's
   one-row widths (8 rows each; CUDA events and profiler device time,
   beside ``torch.topk`` and the byte bound).
6. The distributed surface: one NCCL rank (world size 1), full-size
   TinyLlama-1.1B, one 1024-token sequence (the same every step), 3
   steps each of the configurations of ``DIST_CONFIGS`` through
   ``Session(cfg, run, mesh=...).train_step()``: ``dense``, ``lags_dp``
   (kernel backend) and ``lags_dp`` + momentum correction 0.9, each
   ``off`` (the exchange after backward), ``wave`` (exchanges launched by
   autograd hooks inside backprop) or ``async1`` (the previous step's
   exchange launched before the forward); ``slgs`` (kernel backend: one
   global top-k over the 1,100,048,384-element whole-model vector) off
   and in its one wave; ``lags_hier2`` (kernel backend, the simulation
   phase's tiers) off and ``wave``, and ``lags_hier`` (kernel backend),
   on the ``make_mesh()`` of one rank: one pod, so the outer tier runs
   over no axis; and under the autotune phase's plans ``lags_dp``
   (kernel backend, the P = 4 plan) off and in its planned waves, and
   ``lags_hier2`` (the two-tier plan).  Step 0 runs under deterministic algorithms: step 0's
   exchanged mean and EF residuals (every tier's) of ``lags_dp``,
   ``slgs``, ``lags_hier2`` and ``lags_hier`` must equal the simulation
   path's (P = 1) bit for bit, every kernel launch of that exchange (for
   ``slgs`` the 268,567-row block view of the whole-model vector) must
   equal its plain version on the same inputs bit for bit, step 0's
   parameters and residuals of each ``wave`` configuration must equal its
   ``off`` twin's, and the losses of each ``async1`` configuration must
   be ``[L0, L0, L1]`` of its twin's ``[L0, L1, ...]``.  Each step prints
   its time, peak memory and kernel launches, and each ``wave`` step how
   long before the end of backward each wave launched; the kernels of
   ``DIST_EXPECTED`` must launch.  Then, in the same process group, the
   paper LSTM (20 sequences of 35 tokens): ``dense``, ``lags_dp`` (kernel
   backend) ``off`` with step 0 held as above, and its ``wave`` twin.
6a. Tensor parallelism (``tp_phase``), in the same NCCL group:
   TinyLlama-1.1B at full width on the ("data", "model") = 1 × 1 mesh
   (the parameters DTensors over 'model', or under ``lags_hier`` over
   ('data', 'model'); ``lags_dp``'s exchange on each rank's chunk rows,
   the other modes' on whole leaves), 3 steps each of ``lags_dp``,
   ``slgs``, ``lags_hier2`` and ``lags_hier`` with the kernel backend
   under deterministic algorithms, step 0 with every ``ef_select_pack``
   and ``ef_block_candidates`` launch held to its plain version inside
   the step; every loss, and the parameters and residuals after the
   last step, must equal the same steps on the data-only mesh from the
   same weights and batch (a twin run per mode, its launches not counted
   in the phase's), bit for bit; the gradients' placements before their
   reduction print.  Then its families part (``tp_families``, its
   launches in their own row, ``tp_families``): Granite-3.0-MoE-3B at
   full width cut to ``TP1_GRANITE_LAYERS`` layers (the MoE layers on a
   'model' axis of one rank: ``models.moe``'s local path, its sum over
   'model' an all-reduce over one rank), 3 ``lags_dp`` + kernel steps
   on 1 × 1 bitwise the same steps on the data-only mesh.  Then its
   recurrent part (``tp_recurrent``, its launches in their own row,
   ``tp_recurrent``): xLSTM-1.3B at full width cut to
   ``TP1_XLSTM_LAYERS`` layers (one mLSTM, one sLSTM) on
   ``TP_XLSTM_SEQ`` tokens and Jamba-v0.1 at the jamba phase's training
   cut, the same way (the layers' local paths of ``models.xlstm`` and
   ``models.ssm``, every 'model' boundary the identity at one rank).
   Then serving at 1 × 1 (``tp_serving_phase``): TinyLlama-1.1B (bf16)
   served by ``ServeSession`` and ``launch/serve``'s steps on the
   ("data", "model") = 1 × 1 mesh against ``mesh=None``, every step's
   logits and the tokens bit for bit, then Jamba-v0.1 at its training
   cut and SeamlessM4T-Large-v2 whole (bf16) the same way
   (``TP1_SERVE_FAMILIES``).  ``--ranks 4`` runs, after the
   tp phases, ``moe_span_phase`` (Granite-3.0-MoE-3B at
   ``MOE_SPAN_LAYERS`` layers under ``lags_hier`` on pod 2 × data 2 at
   a global batch of 4: each pod's rows ONE MoE token group gathered
   over its 'data' ranks; ``off`` with every launch held to its plain
   version, ``wave`` == ``off``, the parameters FSDP blocks over each
   pod's 'data' ranks, each card's bytes at rest against the replicated
   layout's, the blocks bitwise across the pods, its launches in
   their own row, ``moe_span``), ``tp_serving_phase`` at data 2 ×
   model 2 (the model in f32 against each card's own one-card serve:
   the same tokens, logits within ``TP_SERVE_RTOL``; tok/s and the
   peak a card printed; then the other families the same way,
   ``tp_serve_family_cuts``: xLSTM-1.3B at 12 of 48 layers, Jamba-v0.1
   at 8 of 32 with dense FFNs, SeamlessM4T-Large-v2 whole with 256
   frames, LLaVA-NeXT-Mistral-7B whole with 2880 patches),
   ``fsdp_serving_phase`` (Jamba-v0.1 whole, 32 layers, 16 experts,
   bf16, built chunk by chunk, served with FSDP over 'data' on data 2 ×
   model 2: every logit and token bitwise its twin without FSDP, its
   bytes at rest a card at most ``FSDP_REST_RATIO`` of the twin's) and
   ``tp_stream_phase`` (full-width TinyLlama packets under
   ``topk_block_kernel``, every ``block_topk`` launch held bitwise to
   its plain version, applied by a ``ServeSession`` over 'model'
   bitwise a one-card session's, a gap refused, a resync bitwise, its
   launches in their own row, ``tp_stream``).
   Then the rest of the stack on 'model' (``tp_observe_phase``, item
   7g) at 1 × 1: TinyLlama-1.1B (bf16) ``lags_dp`` + kernel, step s
   with and without the health quantities, then ``Session.run`` with
   ``health_every=1``, a controller (cadence trigger, a fake trace whose
   wire degrades: it must swap) and a ``StreamPublisher`` under
   ``topk_block_kernel`` whose every packet must be a one-card
   publisher's of the gathered parameters, bit for bit; every
   ``ef_select_pack`` and ``block_topk`` launch held to its plain
   version; then ``profile_model`` on the mesh; its launches in their
   own row, ``tp_observe``.  ``--ranks 4`` runs it last, at data 2 ×
   model 2, the four ranks swapping at one step and the data replicas
   bitwise equal.
6b. The observe plane and online re-planning, in the same NCCL group:
   ``Session(TinyLlama-1.1B, lags_dp + kernel, health_every=1)``: a
   warm-up step each with the health quantities off and on, then 3 of
   each in turn (their step times and medians),
   then ``Session.run`` of 12 steps with a ``HealthMonitor`` and a
   ``ReplanController`` (cadence 4, an anomaly detector, the health
   monitor) from a plan for the healthy wire, its telemetry a fake trace
   whose wire degrades after step 6: the anomaly must swap the live step
   (memory allocated at the start of the swap step and of the next,
   printed, must agree), the losses after it stay finite; every leaf's δ
   gauge finite and >= 0; the final checkpoint (2.2 GB, in the
   git-ignored ``.observe_scratch/``) restored bit for bit into a fresh
   state and deleted, ``runtime_final`` restored into a fresh
   controller; the snapshot through ``observe.check`` and its CLI
   (copied to ``chiprun_out/observe_snapshot.*``); a real
   ``capture_trace`` of the live step: its ``lags/comm/...`` device
   ranges and durations, the step's, ``overlap_report`` (the
   collectives' share of the step), ``ReplanController.ingest_trace``
   and a re-plan on it, ``profile_model(trace=...)``.
6c. The weight stream and the serving path (``stream_phase``), in the
   same NCCL group: ``Session.run`` of 8 full-width TinyLlama-1.1B
   ``lags_dp`` + kernel steps publishing through a
   ``StreamPublisher(every=2, compressor="topk_block_kernel")`` into the
   git-ignored ``.stream_scratch/`` (deleted at the end), then a flush:
   the per-leaf plan (key, d, k, k_b, kind), each packet's bytes against
   ``full_bytes`` and its encode time; every ``block_topk`` launch of
   the first delta held bitwise to its plain version, and that delta
   encoded again under ``topk_hier_ef_kernel`` with every
   ``ef_block_candidates`` and ``ef_select_pack`` launch held the same
   way (a check the publisher never runs: its launches are kept apart,
   as ``stream_check``).  A cold ``ServeSession`` guarded by a ``RolloutGuard`` (held-out
   NLL) applies every packet file; after the flush its parameters must
   equal the trained ones bit for bit.  Two requests (4 prompts of 128
   tokens, 32 generated) from the streamed weights print their
   ``RequestRecord`` (prefill s, decode tok/s, version, cache regime,
   step-cache miss then hit); a dropped version must be refused and
   ``resync`` recover; the phase's peak device memory.  Outside the
   counted window: ``block_topk`` timed at the stream's per-block budget
   on the largest leaf's first-delta accumulator beside its byte bound
   and ``torch.topk``, and the prefill → ``pad_states_for_decode`` →
   decode logits held to a token-by-token replay (``HANDOFF_RTOL``) on
   TinyLlama at full width (bf16, and the same weights in f32), gemma3's
   smoke config (ring and local/global caches) and the paper LSTM at
   full width (sLSTM state).
6d. The MoE family (``moe_phase``), in the same NCCL group:
   Granite-3.0-MoE-3B at its published width (32 layers, d 1536, 40
   experts top 8, expert d_ff 512, bf16, seeded random weights) trains 3
   distributed ``lags_dp`` + kernel steps on one 1024-token ``MarkovLM``
   sequence ``off`` and 3 under ``wave`` (``LARGE_DIST``, the health plane
   on: the Eq. 20 δ of every leaf printed each step): losses finite,
   step 0 of ``off`` with every ``ef_select_pack`` launch held to its
   plain version inside the step (the expert stacks: 245,760 rows of
   4096), ``wave``'s step 0 bitwise to it; step time and peak memory per
   step.  Outside the counted window ``ef_select_pack`` is timed on one
   expert stack (f32 updates and residuals, the step's k_b) beside its
   byte bound, ``torch.topk`` and its plain version.  The trained weights
   (residuals and gradients freed) serve two requests of 4 prompts of 128
   tokens + 32 generated, OLMoE-1B-7B at its published width (16 layers,
   64 experts top 8, untied head, seeded random weights) one; their
   ``RequestRecord``, the aten ops of one decode step, and the handoff
   check in bf16 (``HANDOFF_RTOL_MOE``) and in f32 on the same weights,
   with the planted fault and the tokens whose experts differ between
   the two paths.
6e. The xLSTM family (``xlstm_phase``), in the same NCCL group:
   xLSTM-1.3B at its published width cut to ``XLSTM_LAYERS`` of its 48
   layers (alternating mLSTM and sLSTM, d 2048, 4 heads, vocab 50304,
   untied, bf16, seeded
   random weights) trains ``XLSTM_STEPS`` distributed ``lags_dp`` +
   kernel steps on one ``XLSTM_SEQ``-token ``MarkovLM`` sequence ``off``
   and as many under ``wave`` (``LARGE_DIST``), each period of the stack
   recomputed in the backward (``loss_fn``'s ``remat``, the training
   default): losses
   finite and falling, step 0 of ``off`` with every ``ef_select_pack``
   launch held to its plain version inside the step, ``wave``'s step 0
   bitwise to it; step time, peak memory and δ per leaf per step.  The
   trained weights (residuals and gradients freed) serve two requests of
   4 prompts of 128 tokens + 32 generated; the handoff is checked in
   bf16 (``HANDOFF_RTOL_XLSTM``) and in f32 with the planted fault (the
   mLSTM and sLSTM states zeroed).
6f. Encoders and frontends (``encdec_phase``), in the same NCCL group:
   SeamlessM4T-Large-v2 at its published width and depth (12 encoder and
   12 decoder layers with cross-attention, d 1024, vocab 256,206, tied,
   layer norm, bf16, seeded random weights; ratio 250, so k_b 17 and
   every ``ef_select_pack`` launch on the radix path) trains 3 simulated
   steps (P = 2, ``lags_dp`` + kernel backend + ``topk_exact``, step 0's
   every launch held to its plain version) and 3 + 3 distributed
   ``lags_dp`` + kernel steps ``off`` and ``wave`` (``LARGE_DIST``), each
   worker on one 1024-token sequence beside its 256 frames
   (``frontend_batch``: ``launch/specs.concrete_batch``'s frames, uniform
   tokens); then the trained weights serve two requests of 4 prompts of
   128 tokens + 256 frames, 32 generated, through ``launch/serve``'s
   prefill and decode steps (``serve_frontend``).  LLaVA-NeXT-Mistral-7B
   at its published width trains the same distributed steps cut to
   ``LLAVA_TRAIN_LAYERS`` layers on 2048 patches + 2048 tokens, and
   serves at full depth (32 layers) two requests of 4 prompts of 2880
   patches + 128 tokens.  Every run's losses fall, every leaf's δ is at
   most 1, ``wave``'s step 0 is bitwise ``off``'s; the handoff is checked
   in bf16 (LLaVA's within ``HANDOFF_RTOL_LLAVA``) and f32 against
   prefills of the prompt and the tokens fed so far, with the planted
   faults (SeamlessM4T: the cross caches zeroed; LLaVA: decode at
   positions without the patches).
6g. The Mamba/attention hybrid (``jamba_phase``), in the same NCCL
   group: first the selective scan's memory at Jamba-v0.1's width (d
   4096: d_inner 8192, d_state 16; bf16, seeded random weights): what
   autograd keeps after the forward of one and of two Mamba layers on
   ``JAMBA_SEQ`` tokens must grow by less than one (1, S, d_inner,
   d_state) f32 tensor a layer, and the scan's share of a layer's
   forward and backward is timed.  Then Jamba-v0.1 cut to
   ``JAMBA_TRAIN_LAYERS`` layers (one ``attn_period``: attention at
   layer 4, 7 Mamba layers) with the dense gated FFN in place of its
   experts trains ``JAMBA_STEPS`` distributed ``lags_dp`` + kernel
   steps ``off`` and as many under ``wave`` (``LARGE_DIST``) on one
   ``JAMBA_SEQ``-token sequence of uniform tokens: losses finite and
   falling, δ <= 1 on every leaf, step 0 of ``off`` with every
   ``ef_select_pack`` launch held to its plain version inside the step,
   ``wave``'s step 0 bitwise to it; the handoff is checked in f32 on the
   trained weights.  Jamba at ``JAMBA_SERVE_LAYERS`` layers with all 16
   experts (top 2) serves two requests of 4 prompts of 128 tokens + 32
   generated, the handoff checked in bf16 (``HANDOFF_RTOL_JAMBA``), then
   one ``serve_step`` at ``long_500k``'s shape (batch 1, capacity
   524,288).  Each handoff has two planted faults that must read above
   its tolerance: the SSM states zeroed, and the conv tails zeroed.
7. Print the kernels' JSON line (each kernel's launches in every phase
   under ``phase_launches``, the re-encode check's beside them and not in
   ``launches``), the card line and the result line.

    python3 chip_smoke.py --ranks 4  # the distributed phases alone, 4 cards

runs phase 6 on 4 NCCL ranks, one process and one card each, 4
sequences per global batch: the flat configurations on the ("data",)
mesh of 4, the hierarchy on the ("pod", "data") mesh of 2 x 2; after
every step each rank's parameters must equal rank 0's bit for bit (the
paper LSTM's ``lags_dp`` on data = 4 too), with
deterministic algorithms off (the replicas are never re-synchronised, so
the exchange itself must give every rank the same bits).  Its schedules
come from the autotune pipeline over the 4 ranks: every rank profiles
(the real step and ``time_collectives``); rank 0 prints the wire
samples and the fitted α and β (the source of ``H100_NVLINK``), plans,
and sends the plans to every rank.  Then the tp phase (6a) at data 2 ×
model 2, each run beside its data-only twin (data 4 × model 1, each
data rank's rows on both ranks of its pair): 3 ``lags_dp`` + kernel
steps ``off`` (step 0 held to the plain versions) and 3 under ``wave``,
the two data replicas of each model chunk bitwise equal after every
step, ``wave`` bitwise ``off``, step 0's loss within ``TP_LOSS_RTOL``
of the twin's; 3 ``dense`` steps, every loss within ``TP_LOSS_RTOL`` of
its twin's and the gathered parameters within ``TP_PARAM_RTOL``, and a
planted fault of the gradients' reduction (``tp_fault``) above it; the
same ``off``/``wave`` pairs for ``slgs``, ``lags_hier2`` and
``lags_hier`` (the data replicas not under ``lags_hier``, whose FSDP
blocks differ over 'data'; ``slgs`` and ``lags_hier2``'s parameters
after one f32 step within ``TP_PARAM_RTOL`` of a twin's), and the
bytes a card holds at rest under ``lags_hier`` beside ``lags_dp``'s;
then pod 2 × data 1 × model 2: 3 steps each of ``lags_dp``,
``lags_hier2`` and ``lags_hier``, the pods' chunks bitwise equal after
every step; each step's time and peak memory over the four ranks beside
the twins'.  Then the tp phase's families part at data 2 × model 2
(``tp_families``; one sequence a data rank): Granite-3.0-MoE-3B (the F
layout: expert d_ff 512, 256 a rank) and OLMoE-1B-7B (the E layout: 64
experts, 32 a rank) at full width and depth, 3 ``lags_dp`` + kernel
steps ``off`` and ``wave``; SeamlessM4T-Large-v2 at full width and
depth and LLaVA-NeXT-Mistral-7B at ``LLAVA_TRAIN_LAYERS`` layers, 2 of
each; losses finite, step 0's ``ef_select_pack`` launches held to the
plain version, ``wave`` bitwise ``off`` (each step's parameters and
residuals by ``bit_digest``), the data replicas bitwise, step 0's loss
within ``TP_FAMILY_LOSS_RTOL`` of the data-only forward's; Granite's
``dense`` held to its data 4 × model 1 twin above ``moe_sum_fault``;
the bytes a card holds at rest.  Then its recurrent part at data 2 ×
model 2 (``tp_recurrent``): xLSTM-1.3B at full width and
``TP_XLSTM_LAYERS`` layers (512 tokens a data rank), the paper LSTM at
its full size (20 × 35 tokens a data rank) and Jamba-v0.1 at the
training cut under ``lags_dp`` and ``lags_hier`` (1024 tokens a data
rank), ``off`` and ``wave``, with the same bitwise checks, step 0's loss
within ``TP_RECURRENT_LOSS_RTOL`` of the data-only forward's and
``recurrent_fault`` (the layers' output sums averaged) above it.  The launches by phase, summed over the ranks,
print before the card line.  Then the
observe phase (6b) on the four ranks: the replicas must stay bitwise equal after the swap, every
rank ingests rank 0's trace, and the wire α and β attributed from it
print beside ``H100_NVLINK``'s (the re-plan's fit must be
``attr_wire_fit``); rank 0 alone writes the checkpoint and snapshot.

Any failure raises (non-zero exit).  Without a CUDA card, or without the
repository's ``src/`` beside it, the script exits 1 and prints no result.
Results also go to ``chiprun_out/chip_smoke.json``; ``--profile`` adds one
profiled step per configuration (``chiprun_out/profile_*.txt``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
REPLACES = {
    "block_topk": "src/repro/kernels/block_topk.py:49",
    "ef_select_pack": "src/repro/kernels/ef_sparsify.py:137",
    "ef_block_candidates": "src/repro/kernels/ef_sparsify.py:177",
    "ef_accum_sparsify": "src/repro/kernels/ef_sparsify.py:55",
}
SOURCE = "src/repro_torch/kernels/csrc/selection.cu"
#: the main path's simulation configurations: label -> (RunConfig
#: kwargs, simulated workers, layers (None = the published depth), the
#: kernels it must launch)
SIM_CONFIGS = {
    "dense/topk_exact/xla": (dict(mode="dense"), 2, None, ()),
    "lags_dp/topk_exact/kernel": (
        dict(mode="lags_dp", compressor="topk_exact"), 2, None,
        ("ef_block_candidates", "ef_select_pack")),
    "lags_dp/topk_block/kernel": (
        dict(mode="lags_dp", compressor="topk_block"), 2, None,
        ("ef_select_pack",)),
    "lags_dp/topk_hier/kernel": (
        dict(mode="lags_dp", compressor="topk_hier"), 2, None,
        ("block_topk",)),
    # 2 pods x 2: the outer tier topk_exact (candidates + sort + gated
    # pack), the inner tier topk_block (pack).  Two f32 residuals per
    # worker (8 copies of the model at P = 4, old and new alive together
    # in the exchange) do not fit 80 GB at 22 layers: 16 layers, full width
    "lags_hier2/topk_exact+topk_block/kernel": (
        dict(mode="lags_hier2", compressor="topk_exact",
             inner_compressor="topk_block", ratio=1000.0, ratio_inner=100.0,
             inner_workers=2), 4, 16,
        ("ef_block_candidates", "ef_select_pack")),
    # the adaptive ratios: the P = 2 plan of the autotune phase drives
    # every leaf's budget ("sim" resolves to it); planned-dense leaves
    # keep everything without a selection
    "lags_dp/topk_exact/kernel/sched": (
        dict(mode="lags_dp", compressor="topk_exact", schedule="sim",
             measure_delta=True), 2, None,
        ("ef_block_candidates", "ef_select_pack")),
    # the sampling compressors have no kernel variant (as in the
    # reference): the xla backend, the same plan
    "lags_dp/randk/xla/sched": (
        dict(mode="lags_dp", compressor="randk", schedule="sim"), 2, None,
        ()),
    "lags_dp/topk_sampled/xla/sched": (
        dict(mode="lags_dp", compressor="topk_sampled", schedule="sim"), 2,
        None, ()),
}
SAMPLERS = ("randk", "topk_sampled")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    return out.strip().splitlines()[0]


def bits(t):
    import torch
    t = t.float() if t.dtype in (torch.bfloat16, torch.float16) else t
    return t.contiguous().view(torch.int32)


def assert_bitwise(what, got, want) -> float:
    """Raise unless every output matches bit for bit; return the largest
    absolute difference of the float outputs (0.0 when they match)."""
    import torch
    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{what} output {i}: {g.dtype}{tuple(g.shape)}"
                                 f" vs {w.dtype}{tuple(w.shape)}")
        if g.is_floating_point():
            err = max(err, float((g.float() - w.float()).abs().max()))
        if not torch.equal(bits(g), bits(w)):
            raise AssertionError(f"{what} output {i} differs from the plain "
                                 f"version")
    return err


def cuda_ms(fn, iters: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def parity(dev) -> dict:
    """Each kernel against its plain version, bitwise; returns the largest
    absolute error per kernel."""
    import torch
    from repro_torch.kernels import ef_sparsify, ref
    from repro_torch.kernels.block_topk import block_topk
    errs = {"block_topk": 0.0, "ef_select_pack": 0.0,
            "ef_block_candidates": 0.0}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n_cases = 0
    for n, bs in ((256, 4096), (37, 130), (37, 1023)):
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.randn((n, bs), generator=gen, device=dev).to(dtype)
            e = torch.randn((n, bs), generator=gen, device=dev)
            # ties: a run of equal magnitudes in every row
            g[:, 7:19] = 0.75
            g[:, 40:44] = -0.75
            e[:, 7:44] = 0.0
            lr1 = torch.ones((), device=dev)
            lr3 = torch.full((), 0.3, device=dev)
            thr = torch.full((), 0.5, device=dev)
            thr_groups = torch.tensor([0.5, 1.5], device=dev) \
                if n % 2 == 0 else thr
            for k in sorted({k for k in (1, 4, 5, 8, 16, 64, 512)
                             if k < bs} | {bs - 1, bs}):
                tag = f"n={n} bs={bs} {dtype} k={k}"
                errs["block_topk"] = max(errs["block_topk"], assert_bitwise(
                    f"block_topk {tag}", block_topk(g, k),
                    ref.block_topk_ref(g, k)))
                for t, lr in ((None, lr1), (thr, lr1), (thr_groups, lr1),
                              (thr, lr3)):
                    errs["ef_select_pack"] = max(
                        errs["ef_select_pack"], assert_bitwise(
                            f"ef_select_pack {tag} thr={t} lr={float(lr)}",
                            ef_sparsify.ef_select_pack(g, e, lr, t, k),
                            ref.ef_select_pack_ref(g, e, lr, t, k)))
                for lr in (lr1, lr3):
                    errs["ef_block_candidates"] = max(
                        errs["ef_block_candidates"], assert_bitwise(
                            f"ef_block_candidates {tag} lr={float(lr)}",
                            ef_sparsify.ef_block_candidates(g, e, lr, k),
                            ref.ef_block_candidates_ref(g, e, lr, k)))
                n_cases += 1
    errs["ef_accum_sparsify"] = 0.0
    # 2^22 + 5: each thread of the one-wave grid (132 SMs x 8 blocks x 256
    # threads on an H100) goes round its grid-stride loop several times
    for d in (100, 1024, 5000, 70000, 2**20 + 3, 2**22 + 5):
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.randn((d + 1,), generator=gen, device=dev).to(dtype)
            e = torch.randn((d + 1,), generator=gen, device=dev)
            # |acc| == thr exactly at (lr, thr) = (0.1, 0.5): 0.3 + 0.2
            g[:32], e[:32] = 2.0, 0.3
            views = {"aligned": (g[:d], e[:d]),
                     # one element in: no pointer is 16-byte aligned, so
                     # the kernel takes its element-by-element path
                     "misaligned": (g[1:], e[1:])}
            for lr, thr in ((0.1, 0.5), (1.0, 0.0), (0.01, 2.0),
                            (0.3, 0.7)):
                for view, (gv, ev) in views.items():
                    errs["ef_accum_sparsify"] = max(
                        errs["ef_accum_sparsify"], assert_bitwise(
                            f"ef_accum_sparsify d={d} {dtype} lr={lr} "
                            f"thr={thr} {view}",
                            ef_sparsify.ef_accum_sparsify(gv, ev, lr, thr),
                            ref.ef_accum_sparsify_ref(gv, ev, lr, thr)))
                    n_cases += 1
    torch.cuda.synchronize()
    print(f"parity: {n_cases} shape/dtype/k cases, every kernel bitwise "
          f"equal to its plain version (max_abs_err {errs})")
    return errs


def timings(dev, cfg, p: int) -> dict:
    """Each kernel at the main path's largest leaf (the stacked FFN
    weights of every layer, P workers: P·n_blocks rows of 4096)."""
    import torch
    from repro_torch.kernels import ef_sparsify, ref
    from repro_torch.kernels.block_topk import block_topk
    d = cfg.n_layers * cfg.d_model * cfg.d_ff
    bs = 4096
    n = p * -(-d // bs)
    k_b = max(1, min(bs, -(-max(1, round(d / cfg.compression_ratio)) * bs
                           // d)))
    r = 4
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    g = torch.randn((n, bs), generator=gen, device=dev)
    e = 0.01 * torch.randn((n, bs), generator=gen, device=dev)
    lr = torch.ones((), device=dev)
    acc = e + g
    mag = acc.abs()
    out = {}

    def bound(nbytes, ops):
        b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
        return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")

    cases = {
        "ef_select_pack": (
            k_b, lambda: ef_sparsify.ef_select_pack(g, e, lr, None, k_b),
            lambda: ref.ef_select_pack_ref(g, e, lr, None, k_b),
            n * bs * 12 + n * k_b * 8),
        "ef_block_candidates": (
            r, lambda: ef_sparsify.ef_block_candidates(g, e, lr, r),
            lambda: ref.ef_block_candidates_ref(g, e, lr, r),
            n * bs * 8 + n * r * 8),
        "block_topk": (
            r, lambda: block_topk(acc, r), lambda: ref.block_topk_ref(acc, r),
            n * bs * 4 + n * r * 8),
    }
    for name, (k, kern, plain, nbytes) in cases.items():
        ms = cuda_ms(kern, 10)
        plain_ms = cuda_ms(plain, 3)
        library_ms = cuda_ms(lambda: torch.topk(mag, k, dim=1), 3)
        err = assert_bitwise(f"{name} rows {n}x{bs} k={k}", kern(), plain())
        b_ms, b_by = bound(nbytes, k * n * bs)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": library_ms,
                     "shape": [n, bs], "k": k, "bytes": nbytes,
                     "max_abs_err": err}
        print(f"time {name}: rows {n}x{bs} k={k}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, torch.topk {library_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), {b_ms / ms:.3f} of the bound; "
              f"outputs bitwise equal to the plain version's")
    # ef_accum_sparsify on the same elements as one flat vector, the
    # threshold at ratio 1000 from the hierarchical top-k of the same acc
    from repro_torch.kernels import ops
    d_all = n * bs
    thr, _ = ops.hier_topk_threshold(acc.reshape(-1),
                                     round(d_all / cfg.compression_ratio))
    del mag
    for dtype, per in ((torch.float32, 16), (torch.bfloat16, 14)):
        gf = g.reshape(-1).to(dtype)
        ef = e.reshape(-1)
        ms = cuda_ms(lambda: ef_sparsify.ef_accum_sparsify(gf, ef, lr, thr),
                     10)
        plain_ms = cuda_ms(
            lambda: ref.ef_accum_sparsify_ref(gf, ef, lr, thr), 3)
        err = assert_bitwise(
            f"ef_accum_sparsify {d_all} elements g {dtype}",
            ef_sparsify.ef_accum_sparsify(gf, ef, lr, thr),
            ref.ef_accum_sparsify_ref(gf, ef, lr, thr))
        b_ms, b_by = bound(d_all * per, 4 * d_all)
        row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": None, "shape": [d_all],
               "g_dtype": str(dtype), "thr": float(thr),
               "bytes": d_all * per, "max_abs_err": err}
        name = "ef_accum_sparsify" + ("" if dtype == torch.float32
                                      else "_bf16")
        out[name] = row
        print(f"time {name}: {d_all} elements g {dtype}: kernel {ms:.4f} "
              f"ms, plain {plain_ms:.4f} ms, no library call, bound "
              f"{b_ms:.4f} ms ({b_by}), {b_ms / ms:.3f} of the bound; "
              f"outputs bitwise equal to the plain version's")
        del gf
    del g, e, acc
    torch.cuda.empty_cache()
    return out


def block_kb(d: int, k: int, block_size: int = 4096) -> int:
    """``BlockLAGSExchange``'s per-block budget of a leaf of d with k."""
    bs = min(block_size, d)
    return max(1, min(bs, -(-k * bs // d)))


def make_plans(cfg, prof, hw, out_dir: Path, tag: str, world: int) -> dict:
    """Eq. 18 per leaf over a measured profile and a fitted ``hw``: the
    P = 2 plan of the simulation path ("sim"), the P = 4 plan of the
    distributed path ("flat"), a two-tier plan of pod 2 × data 2
    ("hier": the inner tier on ``hw``'s wire, the outer on the paper's
    1 Gbps Ethernet with ``hw``'s compute) and the planned waves of the
    flat plan.  Each schedule is saved, loaded back and held equal to
    itself; every leaf's (name, d, ratio, k, k_b) is printed; the
    worker-count warning of a P = 4 plan run on ``world`` ranks is
    printed, not suppressed."""
    import warnings
    from repro_torch import tree
    from repro_torch.autotune import planner, profiler
    from repro_torch.autotune import schedule as S
    from repro_torch.core import adaptive
    from repro_torch.core import comm_model as cm
    from repro_torch.models import transformer as T
    from repro_torch.pipeline import buckets as WB
    from repro_torch.pipeline import waves as W
    from repro_torch.runtime import hier as H
    leaves = prof.leaves
    outer_hw = dataclasses.replace(hw, name="eth_1gbps_wire",
                                   alpha=cm.ETH_1GBPS.alpha,
                                   beta=cm.ETH_1GBPS.beta)
    kw = dict(arch=prof.arch, shape=prof.shape)
    plans = {"sim": planner.plan_schedule(leaves, 2, hw, **kw),
             "flat": planner.plan_schedule(leaves, 4, hw, **kw),
             "hier": H.plan_hier_schedule(
                 leaves, p_inner=2, p_outer=2, hw_inner=hw,
                 hw_outer=outer_hw, train_mode="lags_hier2", **kw)}
    plans["waves"] = W.plan_waves(
        leaves, plans["flat"], 4, hw, pipeline="wave",
        t_forward=prof.t_step_dense * (1 - profiler.BWD_FRACTION),
        flat_names=tree.leaf_paths(T.abstract_params(cfg)))
    for name in ("sim", "flat", "hier"):
        path = out_dir / f"schedule_{tag}_{name}.json"
        plans[name].save(str(path))
        if S.load_any(str(path)) != plans[name]:
            raise AssertionError(f"schedule {name}: the JSON round trip "
                                 f"changed it")
    if WB.WaveSchedule.from_json(plans["waves"].to_json()) != plans["waves"]:
        raise AssertionError("planned waves: the JSON round trip changed "
                             "them")
    print(f"autotune {tag}: sim (P=2), flat (P=4) and hier (2 x 2) "
          f"schedules and {plans['waves'].n_waves} planned waves, each "
          f"equal to itself after save and load")
    tables = (("sim", plans["sim"]), ("flat", plans["flat"]),
              ("hier/inner", plans["hier"].inner),
              ("hier/outer", plans["hier"].outer))

    def leaf_row(lp) -> str:
        row = (f"{lp.name} d={lp.d} ratio={lp.ratio:g} k={lp.k} "
               f"k_b={block_kb(lp.d, lp.k)}")
        if lp.ratio > 1:        # Eq. 18's selection time at the fitted rate
            t_spar = adaptive.sparsification_overhead(lp.d, hw)
            row += f" t_spar={t_spar:.4e} s"
        return row

    for name, sched in tables:
        print(f"autotune {tag} {name} (P={sched.n_workers}, wire "
              f"{sched.hardware['name']}): "
              + "; ".join(leaf_row(lp) for lp in sched.leaves))
    for mode, name in (("lags_dp", "flat"), ("lags_hier2", "hier")):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            S.validate_for(plans[name], mode, n_workers=world)
        for w in caught:
            print(f"autotune {tag}: validate_for({name}, {mode!r}, "
                  f"n_workers={world}) warns: {w.message}")
    return plans


def plans_json(plans: dict) -> dict:
    return {name: plans[name].to_json() for name in plans}


def plans_from_json(obj: dict) -> dict:
    from repro_torch.autotune import schedule as S
    from repro_torch.pipeline import buckets as WB
    out = {name: S.schedule_from_json(obj[name])
           for name in ("sim", "flat", "hier")}
    out["waves"] = WB.WaveSchedule.from_json(obj["waves"])
    return out


def autotune_phase(dev, cfg, seq: int, out_dir: Path) -> tuple[dict, dict]:
    """The autotune pipeline on one card: ``profile_model`` of the real
    train step (dense and lags_dp, one 1024-token sequence, on the
    world-size-1 NCCL mesh: no wire samples), ``fit_hardware`` (the
    measured FLOP/s, ``H100_NVLINK``'s α and β), then ``make_plans``.
    Returns (plans, the phase's record)."""
    import torch
    import torch.distributed as dist
    from repro_torch.autotune import costfit, profiler
    from repro_torch.launch import mesh as M
    M.init_process_group(f"tcp://localhost:{free_port()}", 1, 0,
                         device=dev.type)
    try:
        t0 = time.perf_counter()
        prof = profiler.profile_model(cfg, M.make_mesh(device=dev.type),
                                      seq=seq, global_batch=1, iters=3,
                                      arch=cfg.name,
                                      shape_name=f"train_1x{seq}")
        prof_s = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    (out_dir / "profile_1card.json").write_text(prof.to_json())
    hw = costfit.fit_hardware(prof)
    print(f"autotune: profile of {prof.arch} {prof.shape} in {prof_s:.1f} "
          f"s: dense step {prof.t_step_dense:.4f} s, lags_dp step "
          f"{prof.t_step_lags:.4f} s, {prof.flops_per_step:.4e} FLOPs and "
          f"{prof.hbm_bytes_per_step:.4e} device-memory bytes per dense "
          f"step, {len(prof.comm_samples)} wire samples (one rank); fitted "
          f"hbm_bw {hw.hbm_bw:.4e} B/s (the bytes over the dense step), "
          f"{hw}")
    plans = make_plans(cfg, prof, hw, out_dir, "1card", world=1)
    return plans, {"profile": json.loads(prof.to_json()),
                   "hardware": dataclasses.asdict(hw), "profile_s": prof_s,
                   "plans": plans_json(plans)}


#: the fixed k_b sweep of the pack timings, beside the planned k_b
SWEEP_KB = (5, 16, 32, 64, 128, 256, 512, 1024, 2048)
#: k_b at which both paths are timed, to place the crossover
CROSSOVER_KB = (1, 2, 4, 5, 6, 7, 8, 10, 12, 16, 24, 32, 48, 64)


def planned_pack_timings(dev, cfg, plans: dict | None) -> list:
    """``ef_select_pack`` and ``block_topk`` at the fixed sweep
    ``SWEEP_KB`` and at every planned k_b < bs (the flat plan's
    ``BlockLAGSExchange`` leaves, the two-tier plan's inner
    ``topk_block`` tier, the unscheduled budget at ratio 1000), on the
    largest scheduled leaf (one worker's stacked FFN weight, as the
    distributed step launches it): each beside ``torch.topk`` at the same
    k on the precomputed magnitudes and its byte bound, with the path its
    launch took (k arg-max passes below ``RADIX_MIN_K``, radix select from
    it).  At ``CROSSOVER_KB`` both paths are timed, forced through
    ``radix_min_k``.  Every output (the pack with the gate off and on,
    ``ef_block_candidates``, ``block_topk`` on acc) is held bitwise to
    the plain version at every k."""
    import torch
    from repro_torch.kernels import ef_sparsify, ref
    from repro_torch.kernels.block_topk import RADIX_MIN_K, block_topk
    d = cfg.n_layers * cfg.d_model * cfg.d_ff
    bs = 4096
    n = -(-d // bs)
    planned = {block_kb(d, max(1, round(d / cfg.compression_ratio)))}
    if plans is not None:
        planned |= {block_kb(lp.d, lp.k) for sched in (
            plans["flat"], plans["hier"].inner) for lp in sched.leaves
            if lp.d >= bs and block_kb(lp.d, lp.k) < bs}
    kbs = sorted(set(SWEEP_KB) | set(CROSSOVER_KB) | planned)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    g = torch.randn((n, bs), generator=gen, device=dev)
    e = 0.01 * torch.randn((n, bs), generator=gen, device=dev)
    lr = torch.ones((), device=dev)
    # ~50 entries of a row pass |acc| >= 2.5: from k_b 64 on, gated picks
    thr = torch.full((), 2.5, device=dev)
    acc = e + g
    mag = acc.abs()
    forced = {"argmax": bs + 1, "radix": 1}

    def bound(nbytes):
        # a selection by threshold needs ~3 operations per entry
        # (accumulate, magnitude, compare): far below the f32 rate
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = 3 * n * bs / F32_OPS_PER_S * 1e3
        return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")

    rows = []
    for k in kbs:
        path = "radix" if k >= RADIX_MIN_K else "argmax"
        iters = 10 if path == "radix" or k <= 16 else 3
        pack = {p: (lambda m=m: ef_sparsify.ef_select_pack(
            g, e, lr, None, k, radix_min_k=m)) for p, m in forced.items()}
        topk = {p: (lambda m=m: block_topk(acc, k, radix_min_k=m))
                for p, m in forced.items()}
        err = 0.0
        for t in (None, thr):
            err = max(err, assert_bitwise(
                f"ef_select_pack rows {n}x{bs} k={k} thr={t}",
                ef_sparsify.ef_select_pack(g, e, lr, t, k),
                ref.ef_select_pack_ref(g, e, lr, t, k)))
        err = max(err, assert_bitwise(
            f"ef_block_candidates rows {n}x{bs} k={k}",
            ef_sparsify.ef_block_candidates(g, e, lr, k),
            ref.ef_block_candidates_ref(g, e, lr, k)))
        err = max(err, assert_bitwise(
            f"block_topk rows {n}x{bs} k={k}", block_topk(acc, k),
            ref.block_topk_ref(acc, k)))
        library_ms = cuda_ms(lambda: torch.topk(mag, k, dim=1), 3)
        row = {"k": k, "shape": [n, bs], "path": path,
               "planned": k in planned, "library_ms": library_ms,
               "max_abs_err": err}
        for name, fns, nbytes in (
                ("ef_select_pack", pack, n * bs * 12 + n * k * 8),
                ("block_topk", topk, n * bs * 4 + n * k * 8)):
            ms = cuda_ms(fns[path], iters)
            b_ms, by = bound(nbytes)
            both = {}
            if k in CROSSOVER_KB:
                for p, fn in fns.items():
                    assert_bitwise(f"{name} rows {n}x{bs} k={k} {p} path",
                                   fn(), fns[path]())
                    both[p] = ms if p == path else cuda_ms(fn, iters)
            row[name] = {"ms": ms, "bound_ms": b_ms, "bound_by": by,
                         "share": b_ms / ms, "paths_ms": both}
            print(f"pack sweep{' (planned)' if row['planned'] else ''}: "
                  f"{name} rows {n}x{bs} k={k} {path} path: kernel "
                  f"{ms:.4f} ms, torch.topk {library_ms:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({by}), {b_ms / ms:.3f} of the bound"
                  + ("".join(f"; {p} {t:.4f} ms" for p, t in both.items())
                     if both else "")
                  + "; every output bitwise equal to the plain version")
        rows.append(row)
    del g, e, acc, mag
    torch.cuda.empty_cache()
    return rows


def small_reference(dev) -> None:
    """The kernel-backed exchange on the card == the same exchange on the
    CPU (plain versions), bitwise, on small leaves with short tails and
    on one-row leaves of 10 and 432 entries (the paper CNN's head bias
    and stem, narrower than a warp and between warps): lags_dp under each
    compressor (P = 2) and lags_hier2 (2 pods x 2)."""
    import torch
    from repro_torch import tree
    from repro_torch.api import registry as R
    like = {"a": torch.zeros(100), "b": torch.zeros(40, 130),
            "c": torch.zeros(3, 700), "d": torch.zeros(10),
            "e": torch.zeros(432)}
    cases = [("lags_dp", dict(compressor=comp), 2)
             for comp in ("topk_exact", "topk_block", "topk_hier")]
    cases.append(("lags_hier2", dict(compressor="topk_exact",
                                     inner_compressor="topk_block",
                                     ratio_inner=4.0, n_inner=2), 4))
    for mode, kw, p in cases:
        gen = torch.Generator().manual_seed(5)
        u = {k: torch.randn((p,) + tuple(v.shape), generator=gen)
             for k, v in like.items()}
        ex = R.build_exchange(R.ExchangeSpec(
            mode=mode, params_like=like, ratio=16.0,
            selection_backend="kernel", block_size=1024, sim=True,
            n_workers=p, **kw))
        e_cpu = ex.init(u)
        e_gpu = tree.map(lambda v: v.to(dev), e_cpu)
        for _ in range(2):
            m_cpu, e_cpu = ex.exchange(u, e_cpu, None)
            m_gpu, e_gpu = ex.exchange({k: v.to(dev) for k, v in u.items()},
                                       e_gpu, None)
            got = tree.leaves(m_gpu) + tree.leaves(e_gpu)
            for i, (g, w) in enumerate(zip(got, tree.leaves(m_cpu)
                                           + tree.leaves(e_cpu))):
                assert_bitwise(f"exchange {mode} {kw} output {i}",
                               (g.cpu(),), (w,))
    print("small reference: kernel-backed exchanges (lags_dp under three "
          "compressors, lags_hier2 2 pods x 2; leaves of 10 to 28,000 "
          "entries) on the card == plain versions on the CPU, bitwise")


def profile_step(trainer, batch, label: str, out_dir: Path) -> dict:
    """One more step under ``torch.profiler``: device time by kernel
    group, the device's busy and idle share of the step's wall time; the
    per-kernel table goes to ``out_dir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(trainer.step(batch)["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            kernels.append((ev.key, us / 1e3, ev.count))
    kernels.sort(key=lambda r: -r[1])
    groups: dict[str, float] = {}
    for name, ms, _ in kernels:
        low = name.lower()
        group = ("selection kernels" if ("block_topk" in low
                                         or "ef_select" in low)
                 else "matmul" if any(w in low for w in (
                     "gemm", "cutlass", "nvjet", "xmma", "cublas"))
                 else "sort" if ("sort" in low or "radix" in low)
                 else "index_add/scatter/gather" if any(
                     w in low for w in ("index", "scatter", "gather"))
                 else "elementwise/reduce/copy")
        groups[group] = groups.get(group, 0.0) + ms
    busy = sum(groups.values())
    safe = label.replace("/", "_")
    with open(out_dir / f"profile_{safe}.txt", "w") as f:
        f.write(f"{label}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms\n")
        for name, ms, count in kernels:
            f.write(f"{ms:10.3f} ms {count:6d}x  {name}\n")
    row = {"wall_ms": wall_ms, "device_busy_ms": busy,
           "idle_share": max(0.0, 1 - busy / wall_ms), "groups": groups}
    print(f"profile {label}: wall {wall_ms:.2f} ms, device busy "
          f"{busy:.2f} ms, idle share {row['idle_share']:.3f}; " + ", ".join(
              f"{g} {ms:.2f} ms" for g, ms in sorted(
                  groups.items(), key=lambda kv: -kv[1])))
    return row


def resolve(kw: dict, plans: dict) -> dict:
    """A configuration's run kwargs with its ``schedule`` and ``waves``
    names replaced by the autotune phase's artifacts."""
    return {k: (plans[v] if k in ("schedule", "waves") else v)
            for k, v in kw.items()}


@contextlib.contextmanager
def sampler_checks(name: str, draws: dict):
    """While active, every pick of the sampling compressor ``name`` is
    checked as it is made (min(k, d) distinct indices in [0, d), values
    equal to x[idx]) and every index draw is recorded under its stream's
    (leaf, worker) with its step and first 8 indices, so that the caller
    can show each step drew anew.  Yields the count of picks."""
    import torch
    from repro_torch.core import compressors as C
    entry, real_draw = C.REGISTRY[name], C._sample_indices
    count = {"picks": 0}

    def compress(x, k, **kw):
        vals, idx = entry.compress(x, k, **kw)
        d, il = x.shape[-1], idx.long()
        if il.numel() != min(k, d) or int(il.min()) < 0 \
                or int(il.max()) >= d:
            raise AssertionError(f"{name}: {il.numel()} picks of k={k} "
                                 f"outside [0, {d})")
        if torch.unique(il).numel() != il.numel():
            raise AssertionError(f"{name}: repeated indices")
        if not torch.equal(vals, x[il]):
            raise AssertionError(f"{name}: values are not x[idx]")
        count["picks"] += 1
        return vals, idx

    def draw(key, d, n, replace, device):
        out = real_draw(key, d, n, replace, device)
        step, coord = key.path[0], key.path[1:]
        draws.setdefault(coord, []).append((step, out[:8].cpu()))
        return out

    C.REGISTRY[name] = dataclasses.replace(entry, compress=compress)
    C._sample_indices = draw
    try:
        yield count
    finally:
        C.REGISTRY[name] = entry
        C._sample_indices = real_draw


def check_fresh_draws(label: str, draws: dict, steps: int) -> int:
    """Every (leaf, worker) stream drew once per step, and no two steps
    drew the same first indices."""
    import torch
    for coord, seen in draws.items():
        if [t for t, _ in seen] != list(range(steps)):
            raise AssertionError(f"{label}: stream {coord} drew at steps "
                                 f"{[t for t, _ in seen]}")
        for i in range(steps):
            for j in range(i):
                if torch.equal(seen[i][1], seen[j][1]):
                    raise AssertionError(f"{label}: stream {coord} drew the "
                                         f"same indices at steps {j}, {i}")
    return len(draws)


def main_path(dev, cfg, seq: int, steps: int, plans: dict,
              profile_dir: Path | None = None) -> tuple[dict, dict]:
    """Train ``steps`` steps in each configuration of ``SIM_CONFIGS``
    (``plans``: the autotune phase's schedules); returns (kernel launches
    summed over the run, per-step rows)."""
    import torch
    from repro_torch import api, kernels, tree
    from repro_torch.data import synthetic
    from repro_torch.models import transformer as T

    data = synthetic.MarkovLM(vocab=cfg.vocab, seed=3)
    torch.cuda.empty_cache()
    totals = dict.fromkeys(kernels.WRAPPERS, 0)
    results = {}

    for label, (kw, p, n_layers, expect) in SIM_CONFIGS.items():
        kw = resolve(kw, plans)
        c = cfg if n_layers is None else dataclasses.replace(
            cfg, n_layers=n_layers)
        batches = [data.worker_batches(t, p, 1, seq, device=dev)
                   for t in range(steps)]

        def loss_fn(params, batch, c=c):
            return T.loss_fn(params, c, batch, chunk=1024, loss_chunk=512)

        model = T.Transformer(c, seed=0, device=dev)
        n_params = sum(x.numel() for x in tree.leaves(model.params))
        run = api.RunConfig(selection_backend="kernel" if expect else "xla",
                            lr=0.01, **kw)
        trainer = api.Session(c, run, device=dev).simulator(
            loss_fn, model.params, n_workers=p)
        names = tree.leaf_paths(model.params)
        sampler = kw.get("compressor") if kw.get("compressor") in SAMPLERS \
            else None
        draws: dict = {}

        def checks():
            return (sampler_checks(sampler, draws) if sampler
                    else contextlib.nullcontext({}))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        rows = []
        for t in range(steps):
            t0 = time.perf_counter()
            with checks() as picked:
                metrics = trainer.step(batches[t])
                loss = float(metrics["loss"])                # device sync
            step_s = time.perf_counter() - t0
            if "delta_per_leaf" in metrics:
                deltas = metrics["delta_per_leaf"].tolist()
                if not all(math.isfinite(x) for x in deltas):
                    raise AssertionError(f"{label} step {t}: delta {deltas}")
                print(f"main {label} step {t}: Eq. 20 delta per leaf "
                      + ", ".join(f"{n} {x:.4f}" for n, x in
                                  zip(names, deltas))
                      + f"; max {max(deltas):.4f}")
            counts = kernels.launch_counts()
            mem = torch.cuda.max_memory_allocated()
            held = torch.cuda.memory_allocated()
            stats = torch.cuda.memory_stats()
            alloc = {k: stats.get(k, 0) for k in (
                "num_device_alloc", "num_device_free", "num_alloc_retries")}
            rows.append({"step": t, "loss": loss, "step_s": step_s,
                         "max_memory_allocated": mem,
                         "memory_allocated_after": held, "allocator": alloc,
                         "launches": counts})
            if "delta_per_leaf" in metrics:
                rows[-1]["delta_per_leaf"] = dict(zip(names, deltas))
            if sampler:
                rows[-1]["sampled_picks"] = picked["picks"]
            print(f"main {label} step {t}: loss {loss:.6f} step_s "
                  f"{step_s:.4f} max_memory_allocated {mem / 2**30:.3f} GiB "
                  f"(held after the step {held / 2**30:.3f} GiB, allocator "
                  f"{alloc}) launches {counts}")
            if not math.isfinite(loss):
                raise AssertionError(f"{label} step {t}: loss {loss}")
        counts = kernels.launch_counts()
        missing = [k for k in expect if counts[k] == 0]
        if missing:
            raise AssertionError(f"{label}: kernels {missing} never launched")
        if sampler:
            n_streams = check_fresh_draws(label, draws, steps)
            print(f"main {label}: every {sampler} pick held min(k, d) "
                  f"distinct indices in range with values x[idx]; "
                  f"{n_streams} (leaf, worker) streams each drew anew in "
                  f"every one of {steps} steps")
        for k, v in counts.items():
            totals[k] += v
        results[label] = {"params": n_params, "workers": p,
                          "n_layers": c.n_layers, "steps": rows}
        if label.startswith("lags_dp/topk_exact/kernel"):
            check_ef_invariant(trainer, dev)
        if kw["mode"] == "lags_hier2":
            check_ef_invariant_tiers(trainer, dev)
        if profile_dir is not None:
            results[label]["profile"] = profile_step(
                trainer, batches[-1], label, profile_dir)
        del trainer, model, batches
        torch.cuda.empty_cache()
    return totals, results


def check_ef_invariant(trainer, dev) -> None:
    """e + u == scatter(values, indices) + residual on the embedding leaf
    (P workers, the live residual, a fresh update), bit for bit."""
    import torch
    from repro_torch import tree
    from repro_torch.core import compressors as C
    from repro_torch.core import lags
    paths = tree.leaf_paths(trainer.state["ef"])
    i = paths.index("embed/embedding")
    e = tree.leaves(trainer.state["ef"])[i]
    k = tree.leaves(trainer.exchange.ks)[i]
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    u = 1e-3 * torch.randn(e.shape, generator=gen, device=dev)
    torch.use_deterministic_algorithms(True)
    try:
        vals, idx, res = lags.local_select_ef(
            u, e, k, trainer.exchange.compressor,
            **dict(trainer.exchange.compressor_kwargs))
        p = e.shape[0]
        recon = res.reshape(p, -1) + C.decompress(vals, idx, e[0].numel())
        if not torch.equal(recon, (e + u).reshape(p, -1)):
            raise AssertionError("EF invariant broken on embed/embedding")
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"EF invariant e + u == scatter(vals, idx) + residual holds "
          f"bitwise on embed/embedding ({tuple(e.shape)}, k={k})")


def check_ef_invariant_tiers(trainer, dev) -> None:
    """Each tier of lags_hier2 on the embedding leaf, with the live
    residuals and a fresh update: the inner tier's ``e_in + u ==
    scatter(values, indices) + residual`` per worker, and the outer
    tier's ``e_out + m == ...`` per pod, ``m`` the pod means of the inner
    picks; bit for bit."""
    import torch
    from repro_torch import tree
    from repro_torch.core import compressors as C
    from repro_torch.core import lags
    ex = trainer.exchange
    ef = trainer.state["ef"]
    i = tree.leaf_paths(ef["inner"]).index("embed/embedding")
    e_in, e_out = tree.leaves(ef["inner"])[i], tree.leaves(ef["outer"])[i]
    k_in, k_out = tree.leaves(ex.ks_inner)[i], tree.leaves(ex.ks)[i]
    (icomp, ikw), (comp, kw) = ex._tiers()
    p, n_in = e_in.shape[0], ex.n_inner
    n_out, d = p // n_in, e_in[0].numel()
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    u = 1e-3 * torch.randn(e_in.shape, generator=gen, device=dev)
    torch.use_deterministic_algorithms(True)
    try:
        vals, idx, res = lags.local_select_ef(u, e_in, k_in, icomp, **ikw)
        recon = res.reshape(p, -1) + C.decompress(vals, idx, d)
        if not torch.equal(recon, (e_in + u).reshape(p, -1)):
            raise AssertionError("inner-tier EF invariant broken")
        m = torch.stack([lags._gathered_scatter_mean(
            vals[o * n_in:(o + 1) * n_in], idx[o * n_in:(o + 1) * n_in], d,
            n_in) for o in range(n_out)])
        del vals, idx, res, recon, u
        e_pod = e_out.reshape(n_out, n_in, d)[:, 0].contiguous()
        vals, idx, res = lags.local_select_ef(m, e_pod, k_out, comp, **kw)
        if not torch.equal(res + C.decompress(vals, idx, d), e_pod + m):
            raise AssertionError("outer-tier EF invariant broken")
        for o in range(n_out):
            for w in range(o * n_in, (o + 1) * n_in):
                if not torch.equal(e_out[w].reshape(-1), e_pod[o]):
                    raise AssertionError("outer residual differs within a "
                                         "pod")
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"EF invariant acc == scatter(vals, idx) + residual holds bitwise "
          f"on embed/embedding for both tiers (inner: {p} workers, k={k_in}; "
          f"outer: {n_out} pods, k={k_out}); the outer residual is the same "
          f"on every worker of a pod")


def ef_accum_path(dev, cfg, seq: int) -> dict:
    """``ops.ef_accum_sparsify`` as its users call it: two error-feedback
    threshold passes (the residual feeds the second) over every leaf of
    one full-size gradient, lr 0.01, the threshold of each pass from
    ``ops.hier_topk_threshold`` of that pass's acc at the config's ratio.
    Every leaf's (selected, residual) must equal the plain version's bit
    for bit.  Returns (the launch counts of the pass, the largest
    absolute error)."""
    import torch
    from repro_torch import kernels, tree
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer as T

    model = T.Transformer(cfg, seed=0, device=dev)
    batch = synthetic.MarkovLM(vocab=cfg.vocab, seed=3).batch(
        0, 1, seq, device=dev)
    leaves = tree.leaves(model.params)
    loss, _ = T.loss_fn(model.params, cfg, batch)
    grads = torch.autograd.grad(loss, leaves)
    del model, leaves, loss
    lr = 0.01
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    kept, err = 0, 0.0
    with torch.no_grad():
        for i, g in enumerate(grads):
            g = g.reshape(-1)
            e = torch.zeros(g.shape, dtype=torch.float32, device=dev)
            k = max(1, round(g.numel() / cfg.compression_ratio))
            for t in range(2):
                acc = e + lr * g.float()
                thr, _ = ops.hier_topk_threshold(acc, k)
                sel, e_new = ops.ef_accum_sparsify(g, e, lr, thr)
                # the plain version launches nothing, so counts stay
                err = max(err, assert_bitwise(
                    f"ef_accum path leaf {i} pass {t}", (sel, e_new),
                    ref.ef_accum_sparsify_ref(g, e, lr, thr)))
                if not torch.equal(sel + e_new, acc):
                    raise AssertionError("ef_accum_sparsify: selected + "
                                         "residual != acc")
                kept += int((sel != 0).sum())
                e = e_new
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    if counts["ef_accum_sparsify"] == 0:
        raise AssertionError("ef_accum_sparsify never launched on its path")
    print(f"ef_accum path: 2 threshold passes over {len(grads)} leaves of a "
          f"TinyLlama-1.1B gradient, {kept} entries selected, (selected, "
          f"residual) bitwise equal to the plain version's and selected + "
          f"residual == acc on every leaf; launches {counts}")
    del grads
    torch.cuda.empty_cache()
    return counts, err


#: the paper's workloads (phase 5b): the simulation configurations,
#: label -> (RunConfig kwargs, the kernels each must launch)
PAPER_SIM = {
    "dense": (dict(mode="dense"), ()),
    "lags_dp/topk_exact/kernel": (
        dict(mode="lags_dp", compressor="topk_exact",
             selection_backend="kernel"),
        ("ef_block_candidates", "ef_select_pack")),
    "lags_dp/topk_hier/kernel": (
        dict(mode="lags_dp", compressor="topk_hier",
             selection_backend="kernel"), ("block_topk",)),
}
#: the CNN as ``bench_convergence.py`` / ``bench_assumption.py`` run it:
#: P simulated workers of IMAGES images each, ratio 16, lr 0.05; the
#: 40-step convergence gate
CNN_WORKERS, CNN_IMAGES, CNN_RATIO, CNN_LR, CNN_STEPS = 8, 32, 16.0, 0.05, 40
#: the LSTM: P workers of 20 sequences of 35 tokens (PTB's usual batch
#: and BPTT length), the config's own ratio (250)
LSTM_WORKERS, LSTM_SEQS, LSTM_SEQ = 2, 20, 35
#: Fig. 2 reads delta on real layers, not few-element norm scales
DELTA_MIN_D = 64


def sim_run(dev, label: str, trainer, batches, expect, errs: dict,
            shapes: dict, tag: str = "paper") -> tuple[dict, list]:
    """``len(batches)`` steps of ``trainer``; step 0 with every kernel
    launch held to its plain version (``held_to_plain``), every loss
    finite, every kernel of ``expect`` launched; ``tag`` prefixes the
    printed lines.  Returns (the launch counts of the run, per-step
    rows)."""
    import torch
    from repro_torch import kernels
    kernels.reset_launch_counts()
    rows = []
    for t, batch in enumerate(batches):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = kernels.launch_counts()
        check = held_to_plain(errs, shapes) if t == 0 and expect \
            else contextlib.nullcontext()
        t0 = time.perf_counter()
        with check:
            metrics = trainer.step(batch)
            loss = float(metrics["loss"])                    # device sync
        step_s = time.perf_counter() - t0
        mem = torch.cuda.max_memory_allocated()
        counts = {k: v - before[k] for k, v in kernels.launch_counts().items()}
        row = {"step": t, "loss": loss, "step_s": step_s,
               "max_memory_allocated": mem, "launches": counts,
               "held_to_plain": t == 0 and bool(expect)}
        if "delta_per_leaf" in metrics:
            row["delta_per_leaf"] = metrics["delta_per_leaf"].tolist()
        rows.append(row)
        print(f"{tag} {label} step {t}: loss {loss:.6f} step_s {step_s:.4f}"
              f" max_memory_allocated {mem / 2**30:.3f} GiB launches "
              f"{counts}" + (" (every launch held to its plain version)"
                             if row["held_to_plain"] else ""))
        if not math.isfinite(loss):
            raise AssertionError(f"{tag} {label} step {t}: loss {loss}")
    counts = kernels.launch_counts()
    missing = [k for k in expect if counts[k] == 0]
    if missing:
        raise AssertionError(f"{tag} {label}: kernels {missing} never "
                             f"launched")
    return counts, rows


def delta_report(label: str, names: list, sizes: list, rows: list) -> dict:
    """Eq. 20 delta per leaf, the largest over the run's steps; the max
    over leaves of at least ``DELTA_MIN_D`` entries and over all."""
    per_leaf = [max(r["delta_per_leaf"][i] for r in rows)
                for i in range(len(names))]
    if not all(math.isfinite(x) for x in per_leaf):
        raise AssertionError(f"paper {label}: delta {per_leaf}")
    big = max(x for x, d in zip(per_leaf, sizes) if d >= DELTA_MIN_D)
    print(f"paper {label}: Eq. 20 delta per leaf (max over {len(rows)} "
          f"steps) " + ", ".join(f"{n} (d {d}) {x:.4f}" for n, d, x in
                                 zip(names, sizes, per_leaf)))
    print(f"paper {label}: delta max over leaves of >= {DELTA_MIN_D} "
          f"entries {big:.4f}, over all leaves {max(per_leaf):.4f} (Fig. 2: "
          f"delta <= 1)")
    return {"per_leaf": dict(zip(names, per_leaf)), "max_big": big,
            "max_all": max(per_leaf)}


def paper_path(dev, steps: int) -> tuple[dict, dict, dict]:
    """The paper's own workloads at their published widths through the
    simulation surface: the CNN (``paper_cnn_cifar``: ResNet-20's
    16/32/64 widths, 41 leaves) on CIFAR-10-shaped ``Blobs`` through
    ``SimTrainer`` over ``cnn.cnn_loss``, and the 2 x 1500 sLSTM LM with
    layer norm (``paper_lstm_ptb``) on ``MarkovLM`` through
    ``Session.simulator``; ``steps`` steps of each ``PAPER_SIM``
    configuration, then ``CNN_STEPS`` steps of the CNN's lags_dp /
    topk_exact with the Eq. 20 metric (the loss must fall) and the
    LSTM's with it for ``steps`` steps.  Returns (launch counts summed
    over the runs, per-configuration rows, each kernel's largest
    absolute error against its plain version)."""
    import torch
    from repro_torch import api, kernels, tree
    from repro_torch.configs import paper_cnn_cifar, paper_lstm_ptb
    from repro_torch.data import synthetic
    from repro_torch.models import cnn
    from repro_torch.models import transformer as T
    from repro_torch.training import train_loop as TL

    totals = dict.fromkeys(kernels.WRAPPERS, 0)
    errs, results = {}, {}
    ccfg, lcfg = paper_cnn_cifar.CONFIG, paper_lstm_ptb.CONFIG
    blobs = synthetic.Blobs(n_classes=ccfg.n_classes, image_size=32,
                            channels=ccfg.channels)
    markov = synthetic.MarkovLM(vocab=lcfg.vocab, seed=3)

    def cnn_trainer(run):
        model = cnn.CNN(ccfg, seed=0, device=dev)
        return model, TL.SimTrainer(lambda p, b: cnn.cnn_loss(p, ccfg, b),
                                    model.params, run,
                                    n_workers=CNN_WORKERS, device=dev)

    def lstm_trainer(run):
        model = T.Transformer(lcfg, seed=0, device=dev)
        return model, api.Session(lcfg, run, device=dev).simulator(
            lambda p, b: T.loss_fn(p, lcfg, b), model.params,
            n_workers=LSTM_WORKERS)

    workloads = {
        "cnn": (cnn_trainer, dict(ratio=CNN_RATIO, lr=CNN_LR),
                lambda t: blobs.worker_batches(t, CNN_WORKERS, CNN_IMAGES,
                                               device=dev)),
        "lstm": (lstm_trainer, dict(lr=0.01),
                 lambda t: markov.worker_batches(t, LSTM_WORKERS, LSTM_SEQS,
                                                 LSTM_SEQ, device=dev)),
    }
    runs = [(w, label, kw, expect, steps)
            for w in workloads for label, (kw, expect) in PAPER_SIM.items()]
    delta_kw, delta_expect = PAPER_SIM["lags_dp/topk_exact/kernel"]
    runs += [("cnn", "lags_dp/topk_exact/kernel/delta", delta_kw,
              delta_expect, CNN_STEPS),
             ("lstm", "lags_dp/topk_exact/kernel/delta", delta_kw,
              delta_expect, steps)]
    for w, label, kw, expect, n_steps in runs:
        make, common, data = workloads[w]
        delta = label.endswith("/delta")
        run = api.RunConfig(**common, **kw, measure_delta=delta)
        model, trainer = make(run)
        names = tree.leaf_paths(model.params)
        sizes = [x.numel() for x in tree.leaves(model.params)]
        batches = [data(t) for t in range(n_steps)]
        shapes: dict = {}
        tag = f"{model.cfg.name} {label}"
        counts, rows = sim_run(dev, tag, trainer, batches, expect, errs,
                               shapes)
        for k, v in counts.items():
            totals[k] += v
        res = {"params": sum(sizes), "leaves": len(names),
               "workers": trainer.n_workers, "steps": rows,
               "launches": counts,
               "held_shapes": {k: sorted(v) for k, v in shapes.items()}}
        if shapes:
            print(f"paper {tag}: step 0's kernel launches (rows, bs, k) "
                  + "; ".join(f"{k} {sorted(v)}" for k, v in shapes.items())
                  + ", each bitwise equal to its plain version")
        if delta:
            res["delta"] = delta_report(tag, names, sizes, rows)
        if w == "cnn" and delta:
            first, last = rows[0]["loss"], rows[-1]["loss"]
            if not last < first:
                raise AssertionError(f"paper {tag}: loss {first} -> {last} "
                                     f"did not fall")
            print(f"paper {tag}: loss {first:.6f} -> {last:.6f} over "
                  f"{n_steps} steps (fell)")
        results[tag] = res
        del trainer, model, batches
        torch.cuda.empty_cache()
    return totals, results, errs


def device_ms(fn, n: int = 20) -> float:
    """Device time per call of ``fn``: the summed self device time of
    every kernel ``torch.profiler`` records over ``n`` calls, over n (no
    host time in it: CUDA events around launch-bound calls read the
    host's)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            t = getattr(ev, "self_device_time_total", None)
            us += getattr(ev, "self_cuda_time_total", 0.0) if t is None else t
    return us / n / 1e3


def host_us(fn, calls: int = 200, repeats: int = 5) -> float:
    """Host time per call of a launch-bound ``fn`` (µs): the least, over
    ``repeats`` runs of ``calls`` back-to-back calls ended by a
    synchronize, of the run's time over ``calls`` (the least run is the
    one the host's other tenants disturbed least)."""
    import torch
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best / calls * 1e6


def narrow_timings(dev) -> list:
    """``ef_select_pack`` at the paper CNN's one-row leaves (d <= 4096,
    ratio 16, P = 8 rows each, lr a Python float as the exchanges pass
    it): kernel, plain version and ``torch.topk`` on |acc| (CUDA events
    over back-to-back calls: launch-bound, so the host's time), the host
    time per call (``host_us``), the kernel's and ``torch.topk``'s device
    time alone (``device_ms``), beside the byte bound; outputs bitwise to
    the plain version."""
    import torch
    from repro_torch import tree
    from repro_torch.configs import paper_cnn_cifar
    from repro_torch.kernels import ef_sparsify, ref
    from repro_torch.models import cnn
    sizes = sorted({x.numel() for x in tree.leaves(
        cnn.abstract_params(paper_cnn_cifar.CONFIG)) if x.numel() <= 4096})
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    lr = 1.0          # as the exchanges pass it (a Python float)
    out = []
    for bs in sizes:
        k = max(1, round(bs / CNN_RATIO))
        g = torch.randn((CNN_WORKERS, bs), generator=gen, device=dev)
        e = 0.01 * torch.randn((CNN_WORKERS, bs), generator=gen, device=dev)
        mag = (e + g).abs()
        ms = cuda_ms(lambda: ef_sparsify.ef_select_pack(g, e, lr, None, k),
                     50)
        plain_ms = cuda_ms(lambda: ref.ef_select_pack_ref(g, e, lr, None, k),
                           20)
        library_ms = cuda_ms(lambda: torch.topk(mag, k, dim=1), 50)
        dev_ms = device_ms(
            lambda: ef_sparsify.ef_select_pack(g, e, lr, None, k))
        lib_dev_ms = device_ms(lambda: torch.topk(mag, k, dim=1))
        call_us = host_us(lambda: ef_sparsify.ef_select_pack(g, e, lr, None,
                                                             k))
        lib_call_us = host_us(lambda: torch.topk(mag, k, dim=1))
        assert_bitwise(f"narrow ef_select_pack {CNN_WORKERS}x{bs} k={k}",
                       ef_sparsify.ef_select_pack(g, e, lr, None, k),
                       ref.ef_select_pack_ref(g, e, lr, None, k))
        nbytes = CNN_WORKERS * (bs * 12 + k * 8)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out.append({"bs": bs, "k": k, "rows": CNN_WORKERS, "ms": ms,
                    "plain_ms": plain_ms, "library_ms": library_ms,
                    "device_ms": dev_ms, "library_device_ms": lib_dev_ms,
                    "host_us": call_us, "library_host_us": lib_call_us,
                    "bound_ms": bound_ms})
        print(f"narrow ef_select_pack {CNN_WORKERS}x{bs} k={k}: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.topk "
              f"{library_ms:.4f} ms per call; host time per call kernel "
              f"{call_us:.1f} us, torch.topk {lib_call_us:.1f} us; device "
              f"time kernel "
              f"{dev_ms:.4f} ms, torch.topk {lib_dev_ms:.4f} ms; bound "
              f"{bound_ms:.6f} ms (bytes), "
              f"{bound_ms / dev_ms if dev_ms else float('nan'):.4f} of the "
              f"bound in device time; bitwise equal to the plain version")
    return out


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


#: the distributed phase's configurations, in run order: each pipelined
#: one comes after its "off" twin (``TWINS``), which it is held to
DIST_CONFIGS = {
    "dense": dict(mode="dense"),
    "dense/wave": dict(mode="dense", pipeline="wave"),
    "lags_dp/kernel": dict(mode="lags_dp", selection_backend="kernel"),
    "lags_dp/kernel/wave": dict(mode="lags_dp", selection_backend="kernel",
                                pipeline="wave"),
    "lags_dp/kernel/async1": dict(mode="lags_dp", selection_backend="kernel",
                                  pipeline="async1"),
    "lags_dp/kernel/mc0.9": dict(mode="lags_dp", selection_backend="kernel",
                                 momentum_correction=0.9),
    "lags_dp/kernel/async1/mc0.9": dict(
        mode="lags_dp", selection_backend="kernel", pipeline="async1",
        momentum_correction=0.9),
    "slgs/kernel": dict(mode="slgs", selection_backend="kernel"),
    "slgs/kernel/wave": dict(mode="slgs", selection_backend="kernel",
                             pipeline="wave"),
    # the hierarchy, on the (pod, data) mesh when there are several ranks
    "lags_hier2/kernel": dict(mode="lags_hier2", selection_backend="kernel",
                              inner_compressor="topk_block",
                              ratio_inner=100.0),
    "lags_hier2/kernel/wave": dict(
        mode="lags_hier2", selection_backend="kernel",
        inner_compressor="topk_block", ratio_inner=100.0, pipeline="wave"),
    "lags_hier/kernel": dict(mode="lags_hier", selection_backend="kernel"),
    # the adaptive ratios: "flat" is the P = 4 plan, "hier" the 2 x 2
    # two-tier plan, "waves" the flat plan's planned waves
    "lags_dp/kernel/sched": dict(mode="lags_dp", selection_backend="kernel",
                                 schedule="flat"),
    "lags_dp/kernel/sched/wave": dict(
        mode="lags_dp", selection_backend="kernel", schedule="flat",
        pipeline="wave", waves="waves"),
    "lags_hier2/kernel/sched": dict(
        mode="lags_hier2", selection_backend="kernel",
        inner_compressor="topk_block", schedule="hier"),
}
TWINS = {"dense/wave": "dense", "lags_dp/kernel/wave": "lags_dp/kernel",
         "lags_dp/kernel/sched/wave": "lags_dp/kernel/sched",
         "lags_dp/kernel/async1": "lags_dp/kernel",
         "lags_dp/kernel/async1/mc0.9": "lags_dp/kernel/mc0.9",
         "slgs/kernel/wave": "slgs/kernel",
         "lags_hier2/kernel/wave": "lags_hier2/kernel"}
# kernels each distributed configuration must launch, by mode
DIST_EXPECTED = {"dense": (), "lags_dp": ("ef_select_pack",),
                 "slgs": ("ef_block_candidates", "ef_select_pack"),
                 "lags_hier2": ("ef_block_candidates", "ef_select_pack"),
                 "lags_hier": ("ef_select_pack",)}
HIER_MODES = ("lags_hier", "lags_hier2")
#: the paper LSTM's distributed rows: lags_dp off and in waves, beside
#: dense (``--ranks``: lags_dp off alone)
PAPER_DIST = {k: DIST_CONFIGS[k]
              for k in ("dense", "lags_dp/kernel", "lags_dp/kernel/wave")}


def ranks_plans(cfg, seq: int, mesh, world: int, rank: int,
                out_dir: Path) -> dict:
    """The autotune pipeline on ``world`` NCCL ranks: every rank profiles
    (the real step over the mesh, and the collective sweep); rank 0 fits
    α and β from its samples, plans, and sends the plans to every rank,
    which all run the same schedules."""
    import torch.distributed as dist
    from repro_torch.autotune import costfit, profiler
    prof = profiler.profile_model(cfg, mesh, seq=seq, global_batch=world,
                                  iters=3, arch=cfg.name,
                                  shape_name=f"train_{world}x{seq}")
    obj = [None]
    if rank == 0:
        (out_dir / f"profile_{world}ranks.json").write_text(prof.to_json())
        for smp in prof.comm_samples:
            print(f"autotune {world} ranks: {smp.kind} {int(smp.nbytes)} B "
                  f"over {smp.p} ranks: {smp.t * 1e6:.2f} us")
        alpha, beta = costfit.fit_alpha_beta(prof.comm_samples)
        hw = costfit.fit_hardware(prof, name="h100_nvlink_fit")
        print(f"autotune {world} ranks: fitted alpha {alpha!r} s, beta "
              f"{beta!r} s/B ({1 / beta / 1e9:.2f} GB/s); dense step "
              f"{prof.t_step_dense:.4f} s, lags_dp step "
              f"{prof.t_step_lags:.4f} s; {hw}")
        obj = [plans_json(make_plans(cfg, prof, hw, out_dir,
                                     f"{world}ranks", world))]
    dist.broadcast_object_list(obj, src=0)
    return plans_from_json(obj[0])


@contextlib.contextmanager
def process_group(dev, world: int = 1, rank: int = 0,
                  init_method: str | None = None):
    """One NCCL process group of ``world`` ranks (this process is
    ``rank``) for the distributed phase's runs, destroyed at the end."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    M.init_process_group(init_method or f"tcp://localhost:{free_port()}",
                         world, rank, device=dev.type)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()


def distributed(dev, cfg, seq: int, steps: int, world: int = 1,
                rank: int = 0, plans: dict | None = None,
                out_dir: Path | None = None, configs: dict = DIST_CONFIGS,
                per_rank: int = 1, name: str = "", step0: str = "simulation",
                keep: dict | None = None,
                batch: dict | None = None) -> tuple[dict, dict, dict]:
    """The data-parallel surface on ``world`` NCCL ranks (inside
    ``process_group``; this process is ``rank``; ``per_rank`` sequences
    per rank, the same global batch every step): ``steps`` steps of each
    configuration of ``configs`` (``DIST_CONFIGS`` or a part of it);
    ``name`` prefixes its lines.  ``batch``: the global batch of every
    step (default: ``MarkovLM`` sequences of ``seq`` tokens, which a
    vocab of SeamlessM4T's size cannot hold, and which carry no
    frontend's embeddings).  One rank:
    step 0 of every configuration runs under deterministic algorithms;
    step 0 of lags_dp and slgs is held against the simulation path, step
    0's parameters and residuals of each ``wave`` configuration against
    its ``off`` twin bit for bit, and each ``async1`` configuration's
    losses against ``[L0, L0, L1]`` of its twin.  ``step0="launches"``
    (a model whose step-0 simulation replay would not fit beside its
    state) holds every kernel launch of an ``off`` step 0 against its
    plain version inside the step itself instead (``held_to_plain``).
    ``keep`` takes the last configuration's parameters (``"params"``)
    when it ends; its residuals go.  Configurations with
    ``health_every`` print the Eq. 20 δ of every leaf each step.
    Several ranks: after every step each rank's parameters must equal
    rank 0's bit for bit (under ``lags_hier``, whose parameters are
    FSDP blocks over each pod's 'data' ranks, the ranks of one block
    across the pods).
    ``plans``: the schedules of the autotune phase; None (``--ranks``)
    runs that phase here, over the ranks (``ranks_plans``, writing its
    artifacts to ``out_dir``).  Returns (launch counts summed over the run, per-step rows, each
    kernel's largest absolute error against its plain version in the
    step-0 checks)."""
    import torch
    from repro_torch import api, kernels, tree
    from repro_torch.data import synthetic
    from repro_torch.launch import mesh as M
    from repro_torch.pipeline import step as WS
    from repro_torch.sharding import dtensor as D

    if batch is None:
        batch = synthetic.MarkovLM(vocab=cfg.vocab, seed=3).batch(
            0, world * per_rank, seq, device=dev)
    totals = dict.fromkeys(kernels.WRAPPERS, 0)
    results, twins, errs = {}, {}, {}
    try:
        flat_mesh = M.make_mesh(device=dev.type)
        # two pods when the ranks split in two; one pod (no outer tier)
        # otherwise, as on the reference's single-pod mesh
        pods = 2 if world > 1 and world % 2 == 0 else 1
        pod_mesh = (M.make_mesh(pod=pods, device=dev.type) if pods > 1
                    else flat_mesh)
        if plans is None:
            plans = ranks_plans(cfg, seq, flat_mesh, world, rank, out_dir)
            torch.cuda.empty_cache()
        for label, kw in configs.items():
            run = api.RunConfig(lr=0.01, **resolve(kw, plans))
            shown = name + label
            mesh = pod_mesh if run.mode in HIER_MODES else flat_mesh
            sess = api.Session(cfg, run, mesh=mesh)
            step_fn = sess.step_fn
            state, _ = sess.init_state(seed=0)
            waves = sess.meta["waves"]
            if rank == 0:
                print(f"distributed {shown}: mesh "
                      f"{dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}, "
                      f"{sess.meta['n_workers']} workers")
            if waves is not None and rank == 0:
                for i, w in enumerate(waves.waves):
                    print(f"distributed {shown} wave {i}: {len(w.leaf_ids)} "
                          f"leaves {list(w.names)}")
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            counts = dict.fromkeys(kernels.WRAPPERS, 0)
            rows, losses = [], []
            for t in range(steps):
                det = world == 1 and t == 0
                # step 0 of an exchange without a wave twin to hold it
                inside = (det and step0 == "launches"
                          and run.mode != "dense" and run.pipeline == "off")
                shapes0: dict = {}
                if det:
                    p0 = ([D.local(x).detach().clone()
                           for x in tree.leaves(state["params"])]
                          if step0 == "simulation" else None)
                    torch.use_deterministic_algorithms(True)
                kernels.reset_launch_counts()
                torch.cuda.reset_peak_memory_stats()
                marks = [] if run.pipeline == "wave" else None
                t0 = time.perf_counter()
                with (held_to_plain(errs, shapes0) if inside
                      else contextlib.nullcontext()):
                    state, metrics = step_fn(state, batch, marks=marks)
                    loss = float(metrics["loss"])            # device sync
                step_s = time.perf_counter() - t0
                step_counts = kernels.launch_counts()
                for k, v in step_counts.items():
                    counts[k] += v
                mem = torch.cuda.max_memory_allocated()
                losses.append(loss)
                leads = None if marks is None else WS.launch_leads(marks)
                if inside:
                    if not shapes0:
                        raise AssertionError(f"{shown} step 0: no kernel "
                                             f"launched in the exchange")
                    print(f"distributed {shown} step 0: every kernel launch "
                          f"of the step's exchange == its plain version on "
                          f"the same inputs, bitwise (checked inside the "
                          f"step, its time included); (rows, bs, k) "
                          f"{dict((k, sorted(v)) for k, v in shapes0.items())}")
                if det:    # its comparison launches are not counted
                    try:
                        if p0 is not None and run.mode != "dense" \
                                and run.pipeline == "off":
                            for k, v in check_step0(sess, state, p0,
                                                    batch).items():
                                errs[k] = max(errs.get(k, 0.0), v)
                        held(label, state, twins, shown)
                    finally:
                        torch.use_deterministic_algorithms(False)
                    del p0
                delta = None
                if "health_delta" in metrics:
                    delta = dict(zip(tree.leaf_paths(state["params"]),
                                     metrics["health_delta"].tolist()))
                    print(f"distributed {shown} step {t}: Eq. 20 delta per "
                          f"leaf " + ", ".join(f"{k} {v:.4f}"
                                               for k, v in delta.items()))
                fsdp = sess.meta["param_axes"] is not None
                if world > 1:
                    check_replicas(state["params"], f"{shown} step {t}",
                                   group=mesh.get_group("pod") if fsdp
                                   else None)
                rows.append({"step": t, "loss": loss, "step_s": step_s,
                             "max_memory_allocated": mem,
                             "launches": step_counts, "wave_leads": leads,
                             "deterministic": det, "delta": delta})
                who = f" rank {rank}/{world}" if world > 1 else ""
                print(f"distributed {shown}{who} step {t}: loss {loss:.6f} "
                      f"step_s {step_s:.4f} max_memory_allocated "
                      f"{mem / 2**30:.3f} GiB launches {step_counts}"
                      + (" (deterministic algorithms)" if det else "")
                      + ((", parameters equal across the pods" if fsdp
                          else ", parameters equal on every rank")
                         if world > 1 else ""))
                if leads is not None:
                    print(f"distributed {shown}{who} step {t}: launch lead "
                          f"before the end of backward, per wave (host ms "
                          f"/ device ms): " + ", ".join(
                              f"w{x['wave']} {x['host_ms']:.3f}/"
                              f"{x['device_ms'] or 0.0:.3f}" for x in leads))
                if not math.isfinite(loss):
                    raise AssertionError(f"distributed {shown} step {t}: "
                                         f"loss {loss}")
            if world == 1 and "async1" in label:
                want = twins[TWINS[label]]["losses"]
                if losses[:3] != [want[0], want[0], want[1]]:
                    raise AssertionError(
                        f"{shown}: losses {losses} are not [L0, L0, L1] of "
                        f"{TWINS[label]}'s {want}")
                print(f"distributed {shown}: losses {losses[:3]} == [L0, "
                      f"L0, L1] of {TWINS[label]} ({want[:2]}), exactly")
            if world == 1 and label not in TWINS:
                twins.setdefault(label, {})["losses"] = losses
            for k in DIST_EXPECTED[run.mode]:
                if counts[k] == 0:
                    raise AssertionError(f"distributed {shown}: {k} never "
                                         f"launched")
            for k, v in counts.items():
                totals[k] += v
            results[label] = {"steps": rows, "launches": counts,
                              "n_waves": None if waves is None
                              else waves.n_waves,
                              "mesh": dict(zip(mesh.mesh_dim_names,
                                               mesh.mesh.shape))}
            if keep is not None:
                keep["params"] = tree.map(lambda x: x.detach(),
                                          state["params"])
            del state, step_fn, sess
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    return totals, results, errs


def held(label: str, state, twins: dict, shown: str) -> None:
    """Step 0 of an ``off`` configuration with a ``wave`` twin: keep its
    parameters and residuals on the host.  Step 0 of a ``wave``
    configuration: they must equal its twin's, bit for bit (``shown``:
    the label as printed)."""
    from repro_torch import tree
    from repro_torch.sharding import dtensor as D
    parts = [D.local(x) for x in tree.leaves(state["params"])
             + tree.leaves(state["ef"])]
    wave_twins = {v for k, v in TWINS.items() if k.endswith("/wave")}
    if label in wave_twins:
        twins.setdefault(label, {})["step0"] = [
            x.detach().to("cpu", copy=True) for x in parts]
        return
    if not label.endswith("/wave"):
        return
    twin = TWINS[label]
    want = twins[twin].pop("step0")
    if len(want) != len(parts):
        raise AssertionError(f"{shown}: {len(parts)} leaves, {twin} has "
                             f"{len(want)}")
    for i, (got, ref0) in enumerate(zip(parts, want)):
        assert_bitwise(f"{shown} step 0 leaf {i} vs {twin}",
                       (got.detach().cpu(),), (ref0,))
    print(f"distributed {shown} step 0: parameters and residuals == "
          f"{twin}'s, bitwise ({len(parts)} leaves)")


def check_replicas(params, what: str, group=None) -> None:
    """Every rank's parameters == those of the first rank of ``group``
    (default: every rank, rank 0 first), bit for bit (a broadcast of each
    leaf, or of this rank's chunk of a DTensor, compared on every rank; a
    rank that differs fails the collective check on all of them)."""
    import torch
    import torch.distributed as dist
    from repro_torch import tree
    from repro_torch.sharding import dtensor as D
    src = 0 if group is None else dist.get_process_group_ranks(group)[0]
    bad = 0
    for path, x in zip(tree.leaf_paths(params), tree.leaves(params)):
        x = D.local(x.detach())
        ref0 = x.clone()
        dist.broadcast(ref0, src, group=group)
        if not torch.equal(bits(x), bits(ref0)):
            print(f"rank {dist.get_rank()}: {what} {path} differs from "
                  f"rank {src}")
            bad += 1
        del ref0
    flag = torch.tensor([bad], device=D.local(tree.leaves(params)[0]).device)
    dist.all_reduce(flag)
    if int(flag):
        raise AssertionError(f"{what}: parameters differ across ranks "
                             f"({int(flag)} leaf copies)")


@contextlib.contextmanager
def aside(counts: dict):
    """Inside the block, kernel launches go to ``counts`` (added per
    kernel) and not to the wrappers' counts, which leave the block as
    they entered it: a check run inside a counted window that the path
    itself does not take."""
    from repro_torch import kernels
    before = kernels.launch_counts()
    try:
        yield
    finally:
        for name, fn in kernels.WRAPPERS.items():
            counts[name] = counts.get(name, 0) + fn.launches - before[name]
            fn.launches = before[name]


@contextlib.contextmanager
def held_to_plain(errs: dict, shapes: dict, chunk_rows: int = 1 << 15):
    """Inside the block, every ``ef_select_pack``,
    ``ef_block_candidates`` and ``block_topk`` launch is held against its
    plain version on the same inputs, bit for bit: the plain version runs
    chunk by chunk of ``chunk_rows`` rows (rows are independent; a gate
    with one threshold per row group runs whole), so the check fits
    beside the step at its full shapes.  ``errs`` takes each kernel's
    largest absolute error, ``shapes`` the (rows, bs, k) it was launched
    at."""
    import types

    import torch
    from repro_torch.kernels import ef_sparsify, ops, ref
    kernel = {"ef_select_pack": ef_sparsify.ef_select_pack,
              "ef_block_candidates": ef_sparsify.ef_block_candidates,
              "block_topk": ops.block_topk}
    plain = {"ef_select_pack": ref.ef_select_pack_ref,
             "ef_block_candidates": ref.ef_block_candidates_ref,
             "block_topk": ref.block_topk_ref}
    # leading row arguments of each wrapper (the rest are per call)
    n_rows = {"ef_select_pack": 2, "ef_block_candidates": 2, "block_topk": 1}

    def checked(name):
        def call(*args):
            out = kernel[name](*args)
            rows, rest = args[:n_rows[name]], args[n_rows[name]:]
            n, bs = rows[0].shape
            thr = rest[1] if name == "ef_select_pack" else None
            whole = thr is not None and torch.as_tensor(thr).numel() > 1
            step = n if whole else chunk_rows
            for lo in range(0, n, step):
                hi = min(n, lo + step)
                errs[name] = max(errs.get(name, 0.0), assert_bitwise(
                    f"{name} rows {n}x{bs} [{lo}:{hi}]",
                    tuple(o[lo:hi] for o in out),
                    plain[name](*(x[lo:hi] for x in rows), *rest)))
            shapes.setdefault(name, set()).add((n, bs, rest[-1]))
            return out
        return call

    # the exchanges reach the kernels through ``ops``; the wrappers
    # themselves (and their launch counts) stay as they are
    ops._ef = types.SimpleNamespace(**{
        **vars(ef_sparsify), **{name: checked(name) for name in kernel
                                if name != "block_topk"}})
    ops.block_topk = checked("block_topk")
    try:
        yield
    finally:
        ops._ef = ef_sparsify
        ops.block_topk = kernel["block_topk"]


def check_step0(sess, state, p0, batch) -> dict:
    """Step 0 of a distributed exchange mode against the simulation path,
    bit for bit: the gradient is taken again at the step's starting
    parameters (deterministic algorithms make it the step's own), and
    the step's exchange (``meta["exchange"]``) runs over the step's axes
    and on its simulation path (P = 1) on the same updates; their means
    and residuals (every tier's) must be equal, the residuals must be the
    step's, and the step's parameters must be ``p0 - mean``.  (At world
    size 1 lags_hier's mean over the pod's ranks divides by 1, and with
    no pod axis its exchange is the simulation path itself.)  Every
    kernel launch of the distributed exchange (the step's own inputs and
    shapes: 268,567 rows of the whole-model vector for slgs) is held
    against its plain version too (``held_to_plain``).  Returns each
    kernel's largest absolute error there."""
    import torch
    from repro_torch import tree
    from repro_torch.api import registry as R
    from repro_torch.models import transformer as T
    from repro_torch.sharding import dtensor as D
    run, meta = sess.run_config, sess.meta
    ex, axes = meta["exchange"], meta["axes"]
    tiers = R.get_exchange(meta["mode"]).ef_tiers
    treedef = tree.flatten(state["params"])[1]
    start = [x.clone().requires_grad_() for x in p0]
    loss, _ = T.loss_fn(tree.unflatten(treedef, start), sess.cfg, batch,
                        chunk=run.chunk, loss_chunk=run.loss_chunk)
    grads = torch.autograd.grad(loss, start)
    del start, loss
    with torch.no_grad():
        lr = torch.full((), run.lr, device=p0[0].device)
        u = [g.float().mul_(lr) for g in grads]
        del grads

        def zeros(lead):
            z = tree.unflatten(treedef, [torch.zeros(lead + tuple(x.shape),
                                                     device=x.device)
                                         for x in u])
            return {t: tree.map(torch.zeros_like, z) for t in tiers} \
                if tiers else z

        def sim():
            return ex.exchange(tree.unflatten(treedef, [x[None] for x in u]),
                               zeros((1,)), None)

        errs, shapes = {}, {}
        with held_to_plain(errs, shapes):
            if axes is None:
                m_d, e_d = sim()
                e_d = tree.map(lambda x: x[0], e_d)
            else:
                m_d, e_d = ex.exchange(tree.unflatten(treedef, u), zeros(()),
                                       axes)
        if not errs:
            raise AssertionError(f"step 0 of {meta['mode']}: no kernel "
                                 f"launched in the exchange")
        m_s, e_s = sim()
        del u
        nonzero = 0
        for path, md, ms, p_start, p_new in zip(
                tree.leaf_paths(m_d), tree.leaves(m_d), tree.leaves(m_s),
                p0, tree.leaves(state["params"])):
            assert_bitwise(f"step 0 {path} mean vs simulation", (md,), (ms,))
            p_new = D.local(p_new)    # lags_hier's FSDP block: all of it
            assert_bitwise(f"step 0 {path} parameters vs p0 - mean",
                           (p_new,), ((p_start.float() - md).to(p_new.dtype),))
            nonzero += int((md != 0).sum())
        n_resid = 0
        for path, ed, es, ef in zip(
                tree.leaf_paths(e_s), tree.leaves(e_d), tree.leaves(e_s),
                tree.leaves(state["ef"])):
            assert_bitwise(f"step 0 {path} residual vs simulation",
                           (ed[None],), (es,))
            assert_bitwise(f"step 0 {path} residual vs the step's", (ef,),
                           (es,))
            n_resid += 1
    what = (f"{type(ex).__name__} simulation path (P = 1), bitwise "
            f"({n_resid} residual leaves{', tiers ' + str(tiers) if tiers else ''});"
            f" the step's residuals and parameters agree; {nonzero} nonzero "
            f"entries in the mean")
    if meta["mode"] == "slgs":
        d = sum(x.numel() for x in p0)
        n_blocks = -(-d // run.block_size)
        what += (f" of d = {d}: k_total = {ex.k_total}, {n_blocks} blocks x "
                 f"r = 4 = {4 * n_blocks} candidates, the k-th clamped to "
                 f"the last (every candidate passes the gate)"
                 if 4 * n_blocks < ex.k_total else
                 f" of d = {d}: k_total = {ex.k_total}")
    print(f"distributed {sess.cfg.name} {meta['mode']} step 0: exchanged "
          f"mean and EF residual == {what}")
    print(f"distributed {sess.cfg.name} {meta['mode']} step 0: every kernel "
          f"launch of the exchange == its plain version on the same inputs, "
          f"bitwise; (rows, bs, k) {dict((k, sorted(v)) for k, v in shapes.items())}")
    return errs


#: the observe/runtime phase: Session.run steps, the controller count
#: after which the fake trace's wire degrades, the cadence, and the
#: wire it degrades to (the reference tests' "degraded" numbers)
OBSERVE_STEPS, OBSERVE_SHIFT, OBSERVE_CADENCE = 12, 6, 4
#: the tensor-parallel phase's runs: the distributed phase's rows, at its
#: learning rate
TP_RUN = dict(lr=0.01, **DIST_CONFIGS["lags_dp/kernel"])
TP_RUNS = {"lags_dp": TP_RUN, "dense": {**TP_RUN, "mode": "dense"},
           **{m: dict(lr=0.01, **DIST_CONFIGS[f"{m}/kernel"])
              for m in ("slgs", "lags_hier2", "lags_hier")}}
#: the modes that select on whole leaves (and lags_hier's FSDP blocks)
TP_WHOLE = ("slgs", "lags_hier2", "lags_hier")
#: the modes on pod 2 x data 1 x model 2
TP_POD = ("lags_dp", "lags_hier2", "lags_hier")
#: data 2 x model 2 against its data-only twin (data 4 x model 1, each
#: data rank's rows on both ranks of its pair, so that the twin's four
#: workers average what data 2's two do), under ``dense`` (no selection:
#: the mean gradient is the update, so the gradients' reduction and the
#: in-place update of each chunk are what differ): every step's loss,
#: relative (step 0's under every mode too, the same forward).  The two
#: differ only where bf16 roundings fall: a row-parallel product (``wo``,
#: ``w_down``) is two partial sums, each rounded to bf16 before their
#: all-reduce, where the one-card product rounds once.  Read on four
#: H100s (deterministic, so the same bits every run): sound 5.29e-05 at
#: step 0, 4.8e-06 / 8.4e-06 at steps 1-2; ``tp_fault`` 3.6e-03 /
#: 7.1e-03 at steps 1-2.
TP_LOSS_RTOL = 1e-4
#: ... and, after the last step, the gathered parameters' distance from
#: the twin's over the twin's own update, ``|p - p_twin| / |p_twin -
#: p_0|`` (2-norms over the whole tree; per leaf it is no larger than
#: the largest leaf's).  Read per leaf: sound at most 0.123, on
#: layer 0's ``wk``, whose update is a few f32 ulps, so that the
#: roundings of ``p + u`` are all of it; ``tp_fault`` 0.866 (``lm_head``),
#: about 0.5 wherever an update is halved.  On the whole tree: sound
#: 0.112, ``tp_fault`` 0.846.  ``slgs`` and ``lags_hier2`` select on
#: whole leaves, the twin's entries, so their parameters after step 0
#: are held to a one-step twin's too, in f32: in bf16 the row-parallel
#: partial sums move the gradients by ~2^-8 relative, enough to swap the
#: picks nearest the top-k threshold (read on four H100s: 0.2853 and
#: 0.2981 after step 0), so the bf16 reading is printed, not held.
TP_PARAM_RTOL = 0.25


@contextlib.contextmanager
def tp_fault():
    """A planted fault of the gradients' reduction for the block's
    steps: every DTensor gradient reduced as a mean over the 'model'
    ranks where a sum belongs (``sharding.dtensor.grad_to_local`` then
    divided by the 'model' size), wrong the same way on every data
    replica, so the replicas stay equal."""
    from repro_torch.sharding import dtensor as D
    real = D.grad_to_local

    def averaged(g, p):
        out = real(g, p)
        return out / g.device_mesh.size() if D.is_dtensor(g) else out
    D.grad_to_local = averaged
    try:
        yield
    finally:
        D.grad_to_local = real


@contextlib.contextmanager
def grad_placements(seen: list):
    """Inside the block, each gradient's placements as the step meets
    them (before ``sharding.dtensor.grad_to_local`` reduces them to its
    parameter's) go to ``seen``, beside the parameter's, as
    ``"<param> <- <grad>"``."""
    from repro_torch.sharding import dtensor as D
    real = D.grad_to_local

    def spy(g, p):
        if D.is_dtensor(g):
            seen.append(f"{tuple(p.placements)} <- {tuple(g.placements)}")
        return real(g, p)
    D.grad_to_local = spy
    try:
        yield
    finally:
        D.grad_to_local = real


def replicated_bytes(state) -> int:
    """What :func:`at_rest_bytes` would be with every leaf whole on the
    card: the full parameters and an f32 leaf of each per-worker
    state."""
    from repro_torch import tree
    params = tree.leaves(state["params"])
    rest = tree.leaves(state["ef"]) + tree.leaves(state.get("extra", {}))
    return sum(p.numel() * p.element_size() for p in params) + sum(
        4 * params[i % len(params)].numel() for i in range(len(rest)))


def at_rest_bytes(state) -> int:
    """The bytes of this rank's parameters and residuals (every tier),
    and velocity when there is one, between steps."""
    from repro_torch import tree
    from repro_torch.sharding import dtensor as D
    return sum(D.local(x).numel() * D.local(x).element_size()
               for x in tree.leaves(state["params"]) + tree.leaves(state["ef"])
               + tree.leaves(state.get("extra", {})))


def tp_phase(dev, cfg, seq: int, steps: int, world: int = 1,
             rank: int = 0, families: bool = False, recurrent: bool = False
             ) -> tuple[dict, dict, dict]:
    """Tensor parallelism (``sharding.dtensor``: the parameters DTensors
    over the mesh's 'model' axis, under ``lags_hier`` over the pod's
    ('data', 'model') sub-mesh; ``BlockLAGSExchange(row_axes=)``: the
    ``lags_dp`` exchange on each rank's chunk rows; ``slgs``,
    ``lags_hier2`` and ``lags_hier`` on whole leaves gathered from the
    chunks) at ``cfg``'s full width, ``steps`` ``TP_RUNS`` steps each,
    under deterministic algorithms, inside ``process_group``.

    One card: the ("data", "model") = 1 × 1 mesh, for ``lags_dp``,
    ``slgs``, ``lags_hier2`` and ``lags_hier``: step 0 with every
    ``ef_select_pack`` and ``ef_block_candidates`` launch held to its
    plain version inside it (``held_to_plain``), against the same steps
    on the data-only mesh from the same weights and batch (its launches
    counted in its own row, not the phase's; its state kept on the host,
    so that the 1 × 1 run's peak is its own): every loss, and the
    parameters and residuals after the last step, bit for bit.  The
    gradients' placements before their reduction print (``lags_dp``'s
    step 0).

    ``world`` = 4 ranks, two meshes.  Data 2 × model 2, 4 sequences a
    global batch; each ``lags_dp`` run beside its data-only twin, data 4
    × model 1 on the same rows (each data rank's two on both ranks of its
    pair; launches in its own row).  ``lags_dp``, ``slgs``, ``lags_hier2``
    and ``lags_hier`` ``off`` (step 0 held as above) and ``wave``: after
    every step the two data replicas of each model chunk equal bit for
    bit (``check_replicas`` over the data group; not under ``lags_hier``,
    whose blocks differ over 'data'), ``wave``'s losses, parameters and
    residuals equal ``off``'s after every step, step 0's loss within
    ``TP_LOSS_RTOL`` of the twin's; ``slgs`` and ``lags_hier2`` select on
    whole leaves, so their gathered parameters after one f32 step are
    within ``TP_PARAM_RTOL`` of their own f32 twins' (the bf16 reading
    and the entries one run moved and the other did not print beside).  The twin of
    ``lags_dp`` selects on the data-only block layout, where 2 × 2 lays a
    leaf's blocks out over its 'model' dim first, as the reference does,
    so later steps pick other entries; ``dense`` has no selection: its
    every loss within ``TP_LOSS_RTOL`` of its twin's and its gathered
    parameters after the last step within ``TP_PARAM_RTOL``, and with
    ``tp_fault`` planted (launches not counted) above it.  The bytes of
    parameters and residuals a card holds at rest under ``lags_hier``
    (its FSDP blocks) print beside ``lags_dp``'s.  Then pod 2 × data 1 ×
    model 2: ``lags_dp``, ``lags_hier2`` and ``lags_hier``, the two pods'
    chunks equal bit for bit after every step.  Each step's time and peak
    memory print as the range over the four ranks, beside the twins'.

    ``families``: the other families instead of ``cfg``
    (``tp_families``' docstring), its launches in their own row;
    ``recurrent``: the recurrent families (``tp_recurrent``'s
    docstring), likewise.

    Returns (launch counts of the DTensor runs, per-run rows, each
    kernel's largest error against its plain version)."""
    import torch
    import torch.distributed as dist
    from repro_torch import api, kernels, tree
    from repro_torch.data import synthetic
    from repro_torch.launch import mesh as M
    from repro_torch.sharding import dtensor as D

    batch = None if families or recurrent else synthetic.MarkovLM(
        vocab=cfg.vocab, seed=3).batch(0, world, seq, device=dev)
    model = 1 if world == 1 else 2
    tp_mesh = M.make_mesh(model=model, device=dev.type)
    data_group = M.worker_axes(tp_mesh, ("data",)).group
    errs, results = {}, {}
    totals = dict.fromkeys(kernels.WRAPPERS, 0)
    shape = dict(zip(tp_mesh.mesh_dim_names, tp_mesh.mesh.shape))
    label = f"{shape['data']}x{shape['model']}"

    def snapshot(state, digest=False):
        parts = tree.leaves(state["params"]) + tree.leaves(state["ef"])
        if digest:
            return [bit_digest(D.local(x)) for x in parts]
        return [D.local(x.detach()).to("cpu", copy=True) for x in parts]

    def count(counts):
        for k, v in counts.items():
            totals[k] += v

    def train(label, mesh, pipeline, hold=None, rows_of=batch, ends=None,
              keep=False, mode="lags_dp", plain0=False, n_steps=steps,
              replicas=None, first=None, placements=None, config=cfg,
              digest=False):
        """``n_steps`` steps on the global batch ``rows_of``; returns
        (losses, state, launch counts, per-step (loss, snapshot) when
        ``keep``); ``plain0``: step 0's kernel launches held to their
        plain versions; ``hold`` (the label and per-step snapshots of an
        earlier run, or None) is held bitwise after each step
        (``digest``: the snapshots are each leaf's ``bit_digest``, for
        models whose per-step host copies would not fit);
        ``replicas``: a group whose ranks must hold equal chunks after
        each step; ``ends`` (a dict, or None) takes host copies of the
        parameters before the first step and after the last, ``first``
        the gathered parameters after step 0; ``placements`` (a list, or
        None) step 0's gradient placements; ``config``: the model."""
        sess = api.Session(config, api.RunConfig(**{**TP_RUNS[mode],
                                                 "pipeline": pipeline}),
                           mesh=mesh)
        state, _ = sess.init_state(seed=0)
        if ends is not None:
            ends["paths"] = tree.leaf_paths(state["params"])
            ends["init"] = [x.detach().to("cpu", copy=True)
                            for x in tree.leaves(state["params"])]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        rows, losses, snaps = [], [], []
        counts = dict.fromkeys(kernels.WRAPPERS, 0)
        torch.use_deterministic_algorithms(True)
        try:
            for t in range(n_steps):
                shapes0: dict = {}
                inside = plain0 and t == 0
                kernels.reset_launch_counts()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                with (held_to_plain(errs, shapes0) if inside
                      else contextlib.nullcontext()), \
                        (grad_placements(placements)
                         if placements is not None and t == 0
                         else contextlib.nullcontext()):
                    state, metrics = sess.step_fn(state, rows_of)
                    loss = float(metrics["loss"])            # device sync
                step_s = time.perf_counter() - t0
                mem = torch.cuda.max_memory_allocated()
                step_counts = kernels.launch_counts()
                for k, v in step_counts.items():
                    counts[k] += v
                missing = [k for k in DIST_EXPECTED[mode]
                           if inside and not shapes0.get(k)]
                if missing:
                    raise AssertionError(f"tp {label} step 0: {missing} "
                                         f"not launched")
                if not math.isfinite(loss):
                    raise AssertionError(f"tp {label} step {t}: loss {loss}")
                losses.append(loss)
                if replicas is not None:
                    check_replicas(state["params"], f"tp {label} step {t}",
                                   group=replicas)
                if first is not None and t == 0:
                    with torch.no_grad():
                        first["params"] = [
                            (x.full_tensor() if D.is_dtensor(x)
                             else x.detach()).to("cpu", copy=True)
                            for x in tree.leaves(state["params"])]
                if hold is not None:
                    want_loss, want = hold[1][t]
                    if loss != want_loss:
                        raise AssertionError(f"tp {label} step {t}: loss "
                                             f"{loss!r} != {want_loss!r}")
                    got = snapshot(state, digest)
                    for i, (g, w) in enumerate(zip(got, want)):
                        if digest and g != w:
                            raise AssertionError(
                                f"tp {label} step {t} leaf {i}: bit "
                                f"digest {g} != {hold[0]}'s {w}")
                        if not digest:
                            assert_bitwise(f"tp {label} step {t} leaf {i}",
                                           (g,), (w,))
                    del got
                elif keep:
                    snaps.append((loss, snapshot(state, digest)))
                rows.append({"step": t, "loss": loss, "step_s": step_s,
                             "max_memory_allocated": mem,
                             "launches": step_counts})
                who = f" rank {rank}/{world}" if world > 1 else ""
                print(f"tp {label}{who} step {t}: loss {loss:.6f} step_s "
                      f"{step_s:.4f} max_memory_allocated "
                      f"{mem / 2**30:.3f} GiB launches {step_counts}"
                      + ("".join(f"; every {k} launch == its plain "
                                 f"version, bitwise, (rows, bs, k) "
                                 f"{sorted(v)}" for k, v in shapes0.items())
                         if inside else "")
                      + (f"; == {hold[0]}'s, bitwise"
                         if hold is not None else "")
                      + ("; replicas equal" if replicas is not None
                         else ""))
        finally:
            torch.use_deterministic_algorithms(False)
        if ends is not None:
            ends["final"] = [x.detach().to("cpu", copy=True)
                             for x in tree.leaves(state["params"])]
        results[label] = {"mesh": dict(zip(mesh.mesh_dim_names,
                                           mesh.mesh.shape)),
                          "steps": rows, "launches": counts,
                          "at_rest_bytes": at_rest_bytes(state)}
        if world > 1:
            # each step's time and peak on every rank
            every = [None] * world
            dist.all_gather_object(every, [(r["step_s"],
                                            r["max_memory_allocated"])
                                           for r in rows])
            results[label]["ranks"] = every
        return losses, state, counts, snaps

    def param_rel(label, full, ends, after):
        """``|p - p_twin| / |p_twin - p_0|`` over the whole tree (2-norms;
        ``full`` the gathered parameters, on the host or gathered here
        from DTensors, in one order on every rank), the leaf where it is
        largest beside; printed and kept in ``label``'s row."""
        nums, dens, worst, where = 0.0, 0.0, -1.0, None
        moved = apart = 0
        for path, x, ref, p0 in zip(ends["paths"], full, ends["final"],
                                    ends["init"]):
            with torch.no_grad():
                x = x.full_tensor() if D.is_dtensor(x) else x.detach()
                x, ref, p0 = x.to(dev), ref.to(dev), p0.to(dev)
                num = float(torch.linalg.vector_norm(x - ref))
                den = float(torch.linalg.vector_norm(ref - p0))
                # entries the twin's steps moved, and those only one of
                # the two runs moved (a sparse update: the picks)
                moved += int((ref != p0).sum())
                apart += int(((x != p0) != (ref != p0)).sum())
            nums, dens = nums + num * num, dens + den * den
            rel = num / den if den else (0.0 if num == 0 else math.inf)
            if rel > worst:
                worst, where = rel, path
            del x, ref, p0
        rel = math.sqrt(nums / dens)
        results[label].setdefault("vs_twin", {}).update(
            param_rel=rel, worst_leaf=[where, worst], moved=moved,
            moved_by_one=apart)
        if rank == 0:
            print(f"tp {label} vs the data 4 x model 1 twin: parameters "
                  f"after step {after}: |p - p_twin| / |p_twin - p_0| "
                  f"{rel:.4e} (limit {TP_PARAM_RTOL}), largest on one "
                  f"leaf {worst:.4e} at {where}; {apart} entries moved by "
                  f"one run and not the other, of {moved} the twin moved "
                  f"({apart / max(moved, 1):.4f})")
        return rel

    def loss_rel(label, losses, twin_losses, note=""):
        rels = [abs(a - b) / abs(b) for a, b in zip(losses, twin_losses)]
        results[label].setdefault("vs_twin", {})["loss_rel"] = rels
        if rank == 0:
            print(f"tp {label} vs the data 4 x model 1 twin: losses "
                  f"relative {[f'{r:.3e}' for r in rels]} (limit "
                  f"{TP_LOSS_RTOL:.1e}{note})")
        return rels

    def print_ranks():
        """Each step's time and peak memory over the ranks, per run."""
        if rank != 0:
            return
        for name, res in results.items():
            if not isinstance(res, dict) or "ranks" not in res:
                continue
            for t in range(len(res["steps"])):
                ts = [r[t][0] for r in res["ranks"]]
                ms = [r[t][1] / 2**30 for r in res["ranks"]]
                print(f"tp {name} step {t} over the {world} ranks: "
                      f"step_s {min(ts):.4f}-{max(ts):.4f} peak "
                      f"{min(ms):.3f}-{max(ms):.3f} GiB")

    if families:
        tp_families(dev, seq, steps, world, rank, tp_mesh, train, snapshot,
                    loss_rel, param_rel, count, print_ranks, results)
    elif recurrent:
        tp_recurrent(dev, steps, world, rank, tp_mesh, train, snapshot, count,
                     print_ranks, results)
    elif world == 1:
        flat = M.make_mesh(device=dev.type)
        for mode in ("lags_dp",) + TP_WHOLE:
            # its launches stay in its own row, out of the phase's counts
            want_losses, twin, _, _ = train(f"data-only/{mode}", flat, "off",
                                            mode=mode)
            # on the host, so that the 1 x 1 run's peak is its own
            want = snapshot(twin)
            del twin
            torch.cuda.empty_cache()
            seen = [] if mode == "lags_dp" else None
            losses, state, counts, _ = train(f"1x1/{mode}", tp_mesh, "off",
                                             mode=mode, plain0=True,
                                             placements=seen)
            if losses != want_losses:
                raise AssertionError(f"tp 1x1 {mode}: losses {losses} != "
                                     f"data-only's {want_losses}")
            got = snapshot(state)
            if len(got) != len(want):
                raise AssertionError(f"tp 1x1 {mode}: {len(got)} leaves, "
                                     f"data-only {len(want)}")
            for i, (g, w) in enumerate(zip(got, want)):
                assert_bitwise(f"tp 1x1 {mode} leaf {i} vs data-only",
                               (g,), (w,))
            print(f"tp 1x1 {mode}: {steps} steps == the data-only mesh's, "
                  f"bitwise (losses; {len(got)} parameter and residual "
                  f"leaves after the last step)")
            if seen is not None:
                results["gradient_placements"] = seen
                print(f"tp 1x1 gradient placements before their reduction "
                      f"(torch {torch.__version__}): "
                      f"{ {s: seen.count(s) for s in sorted(set(seen))} }")
            del got, want, state
            torch.cuda.empty_cache()
            count(counts)
    else:
        flat = M.make_mesh(device=dev.type)
        # the twins: rank r takes the rows of data rank r // model
        twin_rows = {k: v.reshape(shape["data"], -1, *v.shape[1:])
                     .repeat_interleave(model, dim=0)
                     .reshape(-1, *v.shape[1:]) for k, v in batch.items()}
        twin_losses, state, _, _ = train("data4x1-twin", flat, "off",
                                         rows_of=twin_rows)
        del state
        torch.cuda.empty_cache()
        seen: list = []
        losses, state, counts, snaps = train(
            label, tp_mesh, "off", keep=True, plain0=True,
            replicas=data_group, placements=seen)
        at_rest = {"lags_dp": at_rest_bytes(state)}
        results["gradient_placements"] = seen
        if rank == 0:
            print(f"tp {label} gradient placements before their reduction "
                  f"(torch {torch.__version__}): "
                  f"{ {s: seen.count(s) for s in sorted(set(seen))} }")
        del state
        torch.cuda.empty_cache()
        wave_losses, state, wave_counts, _ = train(
            f"{label}/wave", tp_mesh, "wave", ("off", snaps),
            replicas=data_group)
        del state, snaps
        torch.cuda.empty_cache()
        count(counts)
        count(wave_counts)
        step0 = loss_rel(label, losses, twin_losses,
                         "; step 0 held, later steps select on another "
                         "block layout")[0]
        ends: dict = {}
        dense_twin, state, _, _ = train("data4x1-twin/dense", flat, "off",
                                        rows_of=twin_rows, ends=ends,
                                        mode="dense")
        del state
        torch.cuda.empty_cache()
        d_losses, state, _, _ = train(f"{label}/dense", tp_mesh, "off",
                                      mode="dense")
        sound = (loss_rel(f"{label}/dense", d_losses, dense_twin),
                 param_rel(f"{label}/dense", tree.leaves(state["params"]),
                           ends, steps - 1))
        del state
        torch.cuda.empty_cache()
        with tp_fault():
            f_losses, state, _, _ = train(f"{label}/dense/fault", tp_mesh,
                                          "off", mode="dense")
        fault = (loss_rel(f"{label}/dense/fault", f_losses, dense_twin),
                 param_rel(f"{label}/dense/fault",
                           tree.leaves(state["params"]), ends, steps - 1))
        del state, ends
        torch.cuda.empty_cache()
        # the whole-leaf modes and lags_hier's FSDP blocks
        whole = {}
        for mode in TP_WHOLE:
            lab = f"{label}/{mode}"
            reps = None if mode == "lags_hier" else data_group
            m_losses, state, m_counts, snaps = train(
                lab, tp_mesh, "off", keep=True, mode=mode, plain0=True,
                replicas=reps)
            at_rest[mode] = at_rest_bytes(state)
            del state
            torch.cuda.empty_cache()
            w_losses, state, w_counts, _ = train(
                f"{lab}/wave", tp_mesh, "wave", ("off", snaps), mode=mode,
                replicas=reps)
            del state, snaps
            torch.cuda.empty_cache()
            count(m_counts)
            count(w_counts)
            rel0 = loss_rel(lab, m_losses[:1], twin_losses[:1],
                            "; step 0")[0]
            p_rel = None
            if mode != "lags_hier":
                # whole-leaf selection: step 0 picks the twin's entries,
                # held in f32 (``TP_PARAM_RTOL``), read in bf16 too
                for dtype in ("bfloat16", "float32"):
                    c = dataclasses.replace(cfg, dtype=dtype,
                                            param_dtype=dtype)
                    ends, first = {}, {}
                    train(f"data4x1-twin/{mode}/{dtype}", flat, "off",
                          rows_of=twin_rows, ends=ends, mode=mode,
                          n_steps=1, config=c)
                    torch.cuda.empty_cache()
                    one = f"{lab}/{dtype}"
                    train(one, tp_mesh, "off", mode=mode, n_steps=1,
                          replicas=data_group, first=first, config=c)
                    count(results[one]["launches"])
                    rel = param_rel(one, first["params"], ends, 0)
                    if dtype == "float32":
                        p_rel = rel
                    del ends, first
                    torch.cuda.empty_cache()
            whole[mode] = (rel0, p_rel, w_losses == m_losses)
        if rank == 0:
            gib = {m: b / 2**30 for m, b in at_rest.items()}
            print(f"tp {label} at rest a card (parameters + residuals): "
                  + ", ".join(f"{m} {at_rest[m]} B = {g:.3f} GiB"
                              for m, g in gib.items())
                  + f"; lags_hier / lags_dp "
                  f"{at_rest['lags_hier'] / at_rest['lags_dp']:.4f}")
        results["at_rest_bytes"] = at_rest
        # pod 2 x data 1 x model 2: the pods' chunks equal after every step
        pod_mesh = M.make_mesh(model=model, pod=2, device=dev.type)
        pod_group = M.worker_axes(pod_mesh, ("pod",)).group
        for mode in TP_POD:
            _, state, p_counts, _ = train(f"pod2x1x2/{mode}", pod_mesh, "off",
                                          mode=mode, replicas=pod_group)
            del state
            torch.cuda.empty_cache()
            count(p_counts)
        print_ranks()
        if wave_losses != losses:
            raise AssertionError(f"tp wave losses {wave_losses} != off's "
                                 f"{losses}")
        if not (max(sound[0] + [step0]) <= TP_LOSS_RTOL
                and sound[1] <= TP_PARAM_RTOL):
            raise AssertionError(
                f"tp {label} vs the twins: lags_dp step 0's loss {step0}, "
                f"dense losses {sound[0]} (limit {TP_LOSS_RTOL}), dense "
                f"parameters {sound[1]} (limit {TP_PARAM_RTOL})")
        if not (fault[1] > TP_PARAM_RTOL
                and fault[0][-1] > TP_LOSS_RTOL):
            raise AssertionError(
                f"tp planted fault: parameters {fault[1]} and the last "
                f"loss {fault[0][-1]} from the twin's, not above "
                f"{TP_PARAM_RTOL} and {TP_LOSS_RTOL}")
        for mode, (rel0, p_rel, same) in whole.items():
            if not (same and rel0 <= TP_LOSS_RTOL
                    and (p_rel is None or p_rel <= TP_PARAM_RTOL)):
                raise AssertionError(
                    f"tp {label} {mode}: wave == off {same}, step 0's loss "
                    f"{rel0} from the twin's (limit {TP_LOSS_RTOL}), "
                    f"parameters after step 0 {p_rel} (limit "
                    f"{TP_PARAM_RTOL})")
    if totals["ef_select_pack"] == 0:
        raise AssertionError("tp: ef_select_pack never launched")
    return totals, results, errs


#: the families part of the tp phase on one card: Granite-3.0-MoE-3B at
#: full width cut to this depth on the 1 × 1 mesh against its data-only
#: twin (bitwise needs no depth; the single-card run's time limit does)
TP1_GRANITE_LAYERS = 8
#: ... and on four cards, data 2 × model 2: each model at full width
#: (LLaVA at its training depth) and its steps a run
TP_FAMILY_STEPS = {"granite-moe": 3, "olmoe": 3, "seamless": 2, "llava": 2}
#: the families' step-0 loss on data 2 × model 2 against the data-only
#: forward of the same weights and rows, relative.  The bf16 roundings of
#: the row-parallel partial sums (``TP_LOSS_RTOL``'s) reach the routers,
#: whose top-8 picks near a tie then flip, so an MoE model reads above
#: TinyLlama's 5.29e-05.  Read on four H100s (deterministic, the same
#: bits every run): sound 6.439e-05 Granite, 1.076e-04 OLMoE, 1.431e-05
#: SeamlessM4T, 8.129e-05 LLaVA; ``moe_sum_fault`` on Granite 9.245e-04
#: (its step 0 against the same forward)
TP_FAMILY_LOSS_RTOL = 3e-4


def bit_digest(x, chunk: int = 1 << 26) -> tuple:
    """Two wrap-around int64 sums of ``x``'s bit patterns (int16 for a
    2-byte dtype, else int32), each weighted by a fixed odd multiplier
    below 2^31 that depends on the position, computed on ``x``'s device
    a chunk at a time.  One entry that differs changes both sums (a
    nonzero difference below 2^32 times an odd number below 2^31 is
    never 0 mod 2^64); several cancel in both with negligible
    probability.  What ``wave`` == ``off`` is held by where per-step host
    copies of a multi-billion-parameter state would not fit."""
    import torch
    v = x.detach().contiguous().reshape(-1)
    v = v.view(torch.int16 if v.element_size() == 2 else torch.int32)
    out = [0, 0]
    for lo in range(0, v.numel(), chunk):
        part = v[lo:lo + chunk].to(torch.int64)
        i = torch.arange(lo, lo + part.numel(), device=v.device,
                         dtype=torch.int64)
        for j, (a, b) in enumerate(((2654435761, 97), (40503, 11))):
            m = ((i * a + b) % 2147483647) | 1
            out[j] = (out[j] + int((part * m).sum())) % 2**64
        del part, i
    return tuple(out)


@contextlib.contextmanager
def moe_sum_fault():
    """A planted fault of the MoE layers' sum over 'model': each rank's
    partial output averaged over the 'model' ranks where a sum belongs
    (``models.moe._model_sum`` divided by the 'model' size), wrong the
    same way on every data replica."""
    from repro_torch.models import moe
    real = moe._model_sum
    moe._model_sum = lambda x, mesh: real(x, mesh) / mesh.size()
    try:
        yield
    finally:
        moe._model_sum = real


def tp_families(dev, seq: int, steps: int, world: int, rank: int, tp_mesh,
                train, snapshot, loss_rel, param_rel, count, print_ranks,
                results) -> None:
    """The families part of ``tp_phase`` (its helpers passed in): the MoE
    layers on 'model' (``models.moe``: Granite's F layout, OLMoE's E
    layout), the encoder-decoder and the VLM, ``TP_RUN`` steps under
    deterministic algorithms.

    One card: Granite-3.0-MoE-3B at full width cut to
    ``TP1_GRANITE_LAYERS`` layers, 3 steps on the 1 × 1 mesh (step 0's
    ``ef_select_pack`` launches held to the plain version) against the
    same steps on the data-only mesh: every loss, and the parameters and
    residuals after the last step, bit for bit; and the sum over a
    'model' axis of one rank returns its input's bits.

    Four cards, data 2 × model 2, one ``seq``-token sequence a data rank
    (``MarkovLM``; the encoder-decoder's and the VLM's ``frontend_batch``
    at their phase's shapes): Granite-3.0-MoE-3B and OLMoE-1B-7B at full
    width and depth, SeamlessM4T-Large-v2 at full width and depth and
    LLaVA-NeXT-Mistral-7B at full width and ``LLAVA_TRAIN_LAYERS``
    layers, ``TP_FAMILY_STEPS`` ``lags_dp`` + kernel steps each ``off``
    (step 0's ``ef_select_pack`` launches held to the plain version) and
    ``wave``: finite losses; ``wave``'s losses, and each step's
    parameters and residuals (by ``bit_digest``), equal ``off``'s; the
    two data replicas of each model chunk bitwise after every step
    (``check_replicas``); step 0's loss within ``TP_FAMILY_LOSS_RTOL`` of
    the data-only loss (a forward of the same seeded weights, plain, on the
    same rows, averaged over the data ranks).  Then Granite's ``dense``
    against its data 4 × model 1 twin (each data rank's sequence on both
    ranks of its pair): every loss within ``TP_LOSS_RTOL``, the gathered
    parameters after the last step within ``TP_PARAM_RTOL`` of the
    twin's update, and with ``moe_sum_fault`` planted above both.  Each
    run's bytes at rest a card print; each step's time and peak memory
    over the four ranks."""
    import torch
    import torch.distributed as dist
    from repro_torch import api, tree
    from repro_torch.configs import (granite_moe_3b_a800m,
                                     llava_next_mistral_7b, olmoe_1b_7b,
                                     seamless_m4t_large_v2)
    from repro_torch.data import synthetic
    from repro_torch.launch import mesh as M
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.sharding import dtensor as D

    shape = dict(zip(tp_mesh.mesh_dim_names, tp_mesh.mesh.shape))
    label = f"{shape['data']}x{shape['model']}"
    flat = M.make_mesh(device=dev.type)
    granite = granite_moe_3b_a800m.CONFIG

    def markov(config, rows):
        return synthetic.MarkovLM(vocab=config.vocab, seed=3).batch(
            0, rows, seq, device=dev)

    if world == 1:
        g = dataclasses.replace(granite, n_layers=TP1_GRANITE_LAYERS)
        rows = markov(g, 1)
        want_losses, twin, _, _ = train("data-only/granite-moe", flat, "off",
                                        rows_of=rows, config=g)
        want = snapshot(twin)
        del twin
        torch.cuda.empty_cache()
        losses, state, counts, _ = train("1x1/granite-moe", tp_mesh, "off",
                                         rows_of=rows, config=g, plain0=True)
        if losses != want_losses:
            raise AssertionError(f"tp 1x1 granite-moe: losses {losses} != "
                                 f"data-only's {want_losses}")
        got = snapshot(state)
        if len(got) != len(want):
            raise AssertionError(f"tp 1x1 granite-moe: {len(got)} leaves, "
                                 f"data-only {len(want)}")
        for i, (a, b) in enumerate(zip(got, want)):
            assert_bitwise(f"tp 1x1 granite-moe leaf {i} vs data-only",
                           (a,), (b,))
        x = torch.randn((seq, granite.d_model), device=dev)
        assert_bitwise("the MoE sum over a 'model' axis of one rank",
                       (moe._model_sum(x, D.sub_mesh(tp_mesh)),), (x,))
        print(f"tp 1x1 granite-moe ({TP1_GRANITE_LAYERS} of "
              f"{granite.n_layers} layers, full width): {steps} steps == "
              f"the data-only mesh's, bitwise (losses; {len(got)} parameter "
              f"and residual leaves after the last step); the sum over a "
              f"'model' axis of one rank returns its input's bits")
        del got, want, state
        torch.cuda.empty_cache()
        count(counts)
        return

    run = api.RunConfig(**TP_RUN)
    data_group = M.worker_axes(tp_mesh, ("data",)).group
    models = {
        "granite-moe": granite, "olmoe": olmoe_1b_7b.CONFIG,
        "seamless": seamless_m4t_large_v2.CONFIG,
        "llava": dataclasses.replace(llava_next_mistral_7b.CONFIG,
                                     n_layers=LLAVA_TRAIN_LAYERS)}
    shapes = {"seamless": seq, "llava": LLAVA_SEQ}

    def rows_for(name, config):
        if name in shapes:
            return frontend_batch(config, shapes[name], shape["data"], dev,
                                  seed=3)
        return markov(config, shape["data"])

    def forward_loss(config, rows) -> float:
        """The loss of the same seeded weights, plain, on this rank's
        data rows (a forward, no gradient), averaged over the data
        ranks: step 0's loss on the data-only layout."""
        d, n = dist.get_rank(data_group), shape["data"]
        per = rows["tokens"].shape[0] // n
        with torch.no_grad():
            params = T.init_params(config, seed=0, device=dev)
            loss, _ = T.loss_fn(params, config,
                                {k: v[d * per:(d + 1) * per]
                                 for k, v in rows.items()},
                                chunk=run.chunk, loss_chunk=run.loss_chunk)
            del params
            loss = loss.float().clone()
            dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=data_group)
        torch.cuda.empty_cache()
        return float(loss) / n

    fails, at_rest = [], {}
    for name, config in models.items():
        n_steps = TP_FAMILY_STEPS[name]
        rows = rows_for(name, config)
        if rank == 0:
            print(f"tp families: {name} ({config.name}, {config.n_layers} "
                  f"layers, {config.param_count()} parameters) on {label}",
                  flush=True)
        twin0 = forward_loss(config, rows)
        lab = f"{label}/{name}"
        losses, state, counts, snaps = train(
            lab, tp_mesh, "off", rows_of=rows, keep=True, plain0=True,
            replicas=data_group, n_steps=n_steps, config=config, digest=True)
        at_rest[name] = results[lab]["at_rest_bytes"]
        del state
        torch.cuda.empty_cache()
        w_losses, state, w_counts, _ = train(
            f"{lab}/wave", tp_mesh, "wave", ("off", snaps), rows_of=rows,
            replicas=data_group, n_steps=n_steps, config=config, digest=True)
        del state, snaps, rows
        torch.cuda.empty_cache()
        count(counts)
        count(w_counts)
        rel0 = abs(losses[0] - twin0) / abs(twin0)
        results[lab]["vs_forward"] = {"loss": twin0, "loss_rel": rel0}
        if rank == 0:
            print(f"tp {lab}: step 0's loss {losses[0]!r} vs the data-only "
                  f"forward's {twin0!r}: relative {rel0:.3e} (limit "
                  f"{TP_FAMILY_LOSS_RTOL:.1e}); wave == off, bitwise "
                  f"{w_losses == losses}; at rest a card (parameters + "
                  f"residuals) {at_rest[name]} B = "
                  f"{at_rest[name] / 2**30:.3f} GiB", flush=True)
        if not (w_losses == losses and rel0 <= TP_FAMILY_LOSS_RTOL):
            fails.append(f"{lab}: wave == off {w_losses == losses}, step "
                         f"0's loss {rel0} from the data-only forward's")
    results["families_at_rest_bytes"] = at_rest

    # Granite's dense against its data 4 x model 1 twin, and the fault
    rows = rows_for("granite-moe", granite)
    twin_rows = {k: v.reshape(shape["data"], -1, *v.shape[1:])
                 .repeat_interleave(shape["model"], dim=0)
                 .reshape(-1, *v.shape[1:]) for k, v in rows.items()}
    ends: dict = {}
    dense_twin, state, _, _ = train("data4x1-twin/granite-moe/dense", flat,
                                    "off", rows_of=twin_rows, ends=ends,
                                    mode="dense", config=granite)
    del state
    torch.cuda.empty_cache()
    lab = f"{label}/granite-moe/dense"
    d_losses, state, _, _ = train(lab, tp_mesh, "off", rows_of=rows,
                                  mode="dense", config=granite)
    sound = (loss_rel(lab, d_losses, dense_twin),
             param_rel(lab, tree.leaves(state["params"]), ends, steps - 1))
    del state
    torch.cuda.empty_cache()
    with moe_sum_fault():
        f_losses, state, _, _ = train(f"{lab}/fault", tp_mesh, "off",
                                      rows_of=rows, mode="dense",
                                      config=granite)
    fault = (loss_rel(f"{lab}/fault", f_losses, dense_twin),
             param_rel(f"{lab}/fault", tree.leaves(state["params"]), ends,
                       steps - 1))
    del state, ends
    torch.cuda.empty_cache()
    print_ranks()
    if not (max(sound[0]) <= TP_LOSS_RTOL and sound[1] <= TP_PARAM_RTOL):
        fails.append(f"{lab} vs its twin: losses {sound[0]} (limit "
                     f"{TP_LOSS_RTOL}), parameters {sound[1]} (limit "
                     f"{TP_PARAM_RTOL})")
    if not (fault[1] > TP_PARAM_RTOL and fault[0][-1] > TP_LOSS_RTOL):
        fails.append(f"the MoE sum fault: parameters {fault[1]} and the last "
                     f"loss {fault[0][-1]} from the twin's, not above "
                     f"{TP_PARAM_RTOL} and {TP_LOSS_RTOL}")
    if fails:
        raise AssertionError("tp families: " + "; ".join(fails))


#: the recurrent part of the tp phase on one card: xLSTM-1.3B at full
#: width cut to this depth (one mLSTM and one sLSTM layer) and these
#: tokens, and Jamba-v0.1 at the jamba phase's training cut
#: (``JAMBA_TRAIN_LAYERS``, dense FFNs) on ``JAMBA_SEQ`` tokens, on the
#: 1 × 1 mesh against their data-only twins (the single-card run's time
#: limit sets the depth)
TP1_XLSTM_LAYERS = 2
TP_XLSTM_SEQ = 512
#: ... and on four cards, data 2 × model 2: xLSTM-1.3B cut to this depth
TP_XLSTM_LAYERS = 8
#: each four-card run's steps
TP_RECURRENT_STEPS = {"xlstm": 2, "paper-lstm": 3, "jamba": 2,
                      "jamba/lags_hier": 2}
#: the recurrent models' step-0 loss on data 2 × model 2 against the
#: data-only forward of the same weights and rows, relative: where the
#: row-parallel products' bf16 partial outputs (``down_proj``,
#: ``out_proj``, ``wo``) round twice before their f32 sum, and the
#: recurrences carry it.  Read on four H100s (deterministic, the same
#: bits every run): sound 5.263e-05 xLSTM-1.3B (8 layers), 4.118e-06
#: Jamba-v0.1 (8 layers, both modes), 0 the f32 paper LSTM;
#: ``recurrent_fault`` 1.262e-03 xLSTM, 3.169e-04 Jamba.  Set between
#: the largest sound and the smallest fault reading, ~2.4x from each
TP_RECURRENT_LOSS_RTOL = 1.3e-4


@contextlib.contextmanager
def recurrent_fault():
    """A planted fault of the recurrent layers' sum over 'model': each
    rank's partial output averaged over the 'model' ranks where a sum
    belongs (``models.tp.model_sum`` divided by the 'model' size, as
    ``moe_sum_fault`` plants it in the MoE layer), wrong the same way on
    every data replica."""
    from repro_torch.models import tp
    real = tp.model_sum
    tp.model_sum = lambda x, mesh: real(x, mesh) / mesh.size()
    try:
        yield
    finally:
        tp.model_sum = real


def tp_recurrent(dev, steps: int, world: int, rank: int, tp_mesh, train,
                 snapshot, count, print_ranks, results) -> None:
    """The recurrent part of ``tp_phase`` (its helpers passed in): the
    mLSTM, sLSTM and Mamba layers on 'model' (``models.xlstm``,
    ``models.ssm``: each rank's heads or channels on local tensors
    between the boundaries of ``models.tp``), ``TP_RUN`` steps under
    deterministic algorithms.

    One card: xLSTM-1.3B at full width cut to ``TP1_XLSTM_LAYERS`` layers
    on ``TP_XLSTM_SEQ`` tokens, and Jamba-v0.1 at full width at the
    jamba phase's training cut on ``JAMBA_SEQ`` tokens, ``steps`` steps
    each on the 1 × 1 mesh (step 0's ``ef_select_pack`` launches held to
    the plain version) against the same steps on the data-only mesh:
    every loss, and the parameters and residuals after the last step,
    bit for bit.

    Four cards, data 2 × model 2: xLSTM-1.3B at full width cut to
    ``TP_XLSTM_LAYERS`` layers, one ``TP_XLSTM_SEQ``-token sequence a
    data rank; the paper's LSTM at its full size (2 × 1500), the
    paper's ``LSTM_SEQS`` sequences of ``LSTM_SEQ`` tokens a data rank;
    Jamba-v0.1 at the training cut, one ``JAMBA_SEQ``-token sequence a
    data rank, under ``lags_dp`` and under ``lags_hier`` (its own
    ``train_mode``).  ``TP_RECURRENT_STEPS`` ``lags_dp`` (or
    ``lags_hier``) + kernel steps each ``off`` (step 0's
    ``ef_select_pack`` launches held to the plain version) and ``wave``:
    finite losses; ``wave``'s losses, and each step's parameters and
    residuals (by ``bit_digest``), equal ``off``'s; the two data replicas
    of each model chunk bitwise after every step (not under
    ``lags_hier``, whose FSDP blocks differ over 'data'); step 0's loss
    within ``TP_RECURRENT_LOSS_RTOL`` of the data-only forward's (the
    same seeded weights, plain, on the same rows, averaged over the data
    ranks), and one step of xLSTM and of Jamba's ``lags_dp`` with
    ``recurrent_fault`` planted above it.  Each run's bytes
    at rest a card print; each step's time and peak memory over the four
    ranks."""
    import torch
    import torch.distributed as dist
    from repro_torch import api
    from repro_torch.configs import jamba_v0_1_52b, paper_lstm_ptb, xlstm_1_3b
    from repro_torch.data import synthetic
    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as T

    shape = dict(zip(tp_mesh.mesh_dim_names, tp_mesh.mesh.shape))
    label = f"{shape['data']}x{shape['model']}"
    flat = M.make_mesh(device=dev.type)
    jamba = dataclasses.replace(jamba_v0_1_52b.CONFIG,
                                n_layers=JAMBA_TRAIN_LAYERS, n_experts=0,
                                moe_top_k=0)

    def uniform(config, rows, tokens):
        return synthetic.lm_input_batch(3, rows, tokens, config.vocab,
                                        device=dev)

    if world == 1:
        models = {"xlstm": (dataclasses.replace(
            xlstm_1_3b.CONFIG, n_layers=TP1_XLSTM_LAYERS), TP_XLSTM_SEQ),
            "jamba": (jamba, JAMBA_SEQ)}
        for name, (config, tokens) in models.items():
            rows = uniform(config, 1, tokens)
            want_losses, twin, _, _ = train(f"data-only/{name}", flat, "off",
                                            rows_of=rows, config=config)
            want = snapshot(twin)
            del twin
            torch.cuda.empty_cache()
            losses, state, counts, _ = train(f"1x1/{name}", tp_mesh, "off",
                                             rows_of=rows, config=config,
                                             plain0=True)
            if losses != want_losses:
                raise AssertionError(f"tp 1x1 {name}: losses {losses} != "
                                     f"data-only's {want_losses}")
            got = snapshot(state)
            if len(got) != len(want):
                raise AssertionError(f"tp 1x1 {name}: {len(got)} leaves, "
                                     f"data-only {len(want)}")
            for i, (a, b) in enumerate(zip(got, want)):
                assert_bitwise(f"tp 1x1 {name} leaf {i} vs data-only",
                               (a,), (b,))
            print(f"tp 1x1 {name} ({config.name}, {config.n_layers} "
                  f"layers, full width, {tokens} tokens): {steps} steps == "
                  f"the data-only mesh's, bitwise (losses; {len(got)} "
                  f"parameter and residual leaves after the last step)")
            del got, want, state
            torch.cuda.empty_cache()
            count(counts)
        return

    data_group = M.worker_axes(tp_mesh, ("data",)).group
    n_data = shape["data"]
    xlstm = dataclasses.replace(xlstm_1_3b.CONFIG, n_layers=TP_XLSTM_LAYERS)
    lstm = paper_lstm_ptb.CONFIG
    # name -> (model, mode, global batch, whether a fault is planted)
    runs = {
        "xlstm": (xlstm, "lags_dp", uniform(xlstm, n_data, TP_XLSTM_SEQ),
                  True),
        "paper-lstm": (lstm, "lags_dp", synthetic.MarkovLM(
            vocab=lstm.vocab, seed=3).batch(0, n_data * LSTM_SEQS, LSTM_SEQ,
                                            device=dev), False),
        "jamba": (jamba, "lags_dp", uniform(jamba, n_data, JAMBA_SEQ), True),
        "jamba/lags_hier": (jamba, "lags_hier",
                            uniform(jamba, n_data, JAMBA_SEQ), False)}
    run = api.RunConfig(**TP_RUN)

    def forward_loss(config, rows) -> float:
        """The loss of the same seeded weights, plain, on this rank's
        data rows (a forward, no gradient), averaged over the data
        ranks: step 0's loss on the data-only layout."""
        d = dist.get_rank(data_group)
        per = rows["tokens"].shape[0] // n_data
        with torch.no_grad():
            params = T.init_params(config, seed=0, device=dev)
            loss, _ = T.loss_fn(params, config,
                                {k: v[d * per:(d + 1) * per]
                                 for k, v in rows.items()},
                                chunk=run.chunk, loss_chunk=run.loss_chunk)
            del params
            loss = loss.float().clone()
            dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=data_group)
        torch.cuda.empty_cache()
        return float(loss) / n_data

    fails, at_rest, readings = [], {}, {}
    for name, (config, mode, rows, fault) in runs.items():
        n_steps = TP_RECURRENT_STEPS[name]
        reps = None if mode == "lags_hier" else data_group
        if rank == 0:
            print(f"tp recurrent: {name} ({config.name}, {config.n_layers} "
                  f"layers, {config.param_count()} parameters, {mode}, "
                  f"{tuple(rows['tokens'].shape)} tokens a step) on {label}",
                  flush=True)
        twin0 = forward_loss(config, rows)
        lab = f"{label}/{name}"
        losses, state, counts, snaps = train(
            lab, tp_mesh, "off", rows_of=rows, keep=True, plain0=True,
            replicas=reps, n_steps=n_steps, config=config, digest=True,
            mode=mode)
        at_rest[name] = results[lab]["at_rest_bytes"]
        del state
        torch.cuda.empty_cache()
        w_losses, state, w_counts, _ = train(
            f"{lab}/wave", tp_mesh, "wave", ("off", snaps), rows_of=rows,
            replicas=reps, n_steps=n_steps, config=config, digest=True,
            mode=mode)
        del state, snaps
        torch.cuda.empty_cache()
        count(counts)
        count(w_counts)
        rel0 = abs(losses[0] - twin0) / abs(twin0)
        results[lab]["vs_forward"] = {"loss": twin0, "loss_rel": rel0}
        readings[name] = rel0
        fault_rel = None
        if fault:
            with recurrent_fault():
                f_losses, state, _, _ = train(
                    f"{lab}/fault", tp_mesh, "off", rows_of=rows, n_steps=1,
                    config=config, mode=mode)
            del state
            torch.cuda.empty_cache()
            fault_rel = abs(f_losses[0] - twin0) / abs(twin0)
            results[lab]["fault"] = {"loss_rel": fault_rel}
        del rows
        if rank == 0:
            print(f"tp {lab}: step 0's loss {losses[0]!r} vs the data-only "
                  f"forward's {twin0!r}: relative {rel0:.3e} (limit "
                  f"{TP_RECURRENT_LOSS_RTOL:.1e})"
                  + (f"; with the planted sum fault {fault_rel:.3e}"
                     if fault else "")
                  + f"; wave == off, bitwise {w_losses == losses}; at rest "
                  f"a card (parameters + residuals) {at_rest[name]} B = "
                  f"{at_rest[name] / 2**30:.3f} GiB", flush=True)
        if not (w_losses == losses and rel0 <= TP_RECURRENT_LOSS_RTOL
                and (fault_rel is None
                     or fault_rel > TP_RECURRENT_LOSS_RTOL)):
            fails.append(f"{lab}: wave == off {w_losses == losses}, step "
                         f"0's loss {rel0} from the data-only forward's, "
                         f"planted fault {fault_rel}")
    results["recurrent_at_rest_bytes"] = at_rest
    results["recurrent_step0_loss_rel"] = readings
    print_ranks()
    if fails:
        raise AssertionError("tp recurrent: " + "; ".join(fails))


#: the MoE token groups across a pod's ranks (``moe_span_phase``):
#: Granite-3.0-MoE-3B at full width cut to this depth, one sequence of
#: ``MOE_SPAN_SEQ`` tokens a rank (a global batch of 4 on pod 2 x data 2)
MOE_SPAN_LAYERS = 8
MOE_SPAN_SEQ = 1024
MOE_SPAN_STEPS = 3


def moe_span_phase(dev, world: int, rank: int) -> tuple[dict, dict, dict]:
    """``lags_hier`` (kernel backend) on pod 2 × data 2 at a global
    batch of 4: each pod's 2 rows make ONE MoE token group across its
    two ranks (``launch.train.pod_auto_moe_groups`` gives ``POD_SPAN``),
    gathered over the pod's 'data' ranks (``models.moe.TokenSpan``).
    Granite-3.0-MoE-3B at full width cut to ``MOE_SPAN_LAYERS`` layers
    (seeded random weights), ``MOE_SPAN_STEPS`` steps ``off`` and
    ``wave`` under deterministic algorithms: every kernel launch of the
    ``off`` steps held to its plain version inside the step
    (``held_to_plain``); the parameters FSDP blocks over each pod's
    'data' ranks, each card's bytes at rest below 0.55 of the replicated
    layout's; after every step the blocks equal across the pods;
    ``wave``'s losses equal ``off``'s every step and its
    parameters and residuals after the last, bit for bit.  The span's
    row gathers are counted (``models.tp.gather_rows``).  Returns (launch
    counts of both runs, results, each kernel's largest error against
    its plain version)."""
    import torch
    from repro_torch import api, kernels, tree
    from repro_torch.configs import granite_moe_3b_a800m
    from repro_torch.data import synthetic
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train as LT
    from repro_torch.models import tp as TP
    cfg = dataclasses.replace(granite_moe_3b_a800m.CONFIG,
                              n_layers=MOE_SPAN_LAYERS)
    mesh = M.make_mesh(pod=2, device=dev.type)
    batch = synthetic.MarkovLM(vocab=cfg.vocab, seed=11).batch(
        0, world, MOE_SPAN_SEQ, device=dev)
    groups = LT.pod_auto_moe_groups(world, 2, world // 2)
    if groups != LT.POD_SPAN:
        raise AssertionError(f"moe_span: {world} rows on 2 pods give "
                             f"{groups} groups, not a span")
    totals = dict.fromkeys(kernels.WRAPPERS, 0)
    errs, res, kept = {}, {}, {}
    gathers = [0]
    real_gather = TP.gather_rows

    def counted(x, group, n):
        gathers[0] += 1
        return real_gather(x, group, n)
    TP.gather_rows = counted
    torch.use_deterministic_algorithms(True)
    try:
        for pipeline in ("off", "wave"):
            label = f"moe_span {pipeline}"
            sess = api.Session(cfg, api.RunConfig(
                lr=0.01, mode="lags_hier", selection_backend="kernel",
                pipeline=pipeline), mesh=mesh)
            state, _ = sess.init_state(seed=0)
            rows, shapes = [], {}
            gathers[0] = 0
            for t in range(MOE_SPAN_STEPS):
                kernels.reset_launch_counts()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                with (held_to_plain(errs, shapes) if pipeline == "off"
                      else contextlib.nullcontext()):
                    state, metrics = sess.step_fn(state, batch)
                    loss = float(metrics["loss"])
                step_s = time.perf_counter() - t0
                counts = kernels.launch_counts()
                for k, v in counts.items():
                    totals[k] += v
                mem = torch.cuda.max_memory_allocated() / 2 ** 30
                if not math.isfinite(loss):
                    raise AssertionError(f"{label} step {t}: loss {loss}")
                # each rank holds its pod's block of every leaf (FSDP
                # over 'data'): the ranks of one block across the pods
                check_replicas(state["params"], f"{label} step {t}",
                               group=mesh.get_group("pod"))
                if pipeline == "wave" and loss != kept["losses"][t]:
                    raise AssertionError(f"{label} step {t}: loss {loss} != "
                                         f"off's {kept['losses'][t]}")
                rows.append({"step": t, "loss": loss, "step_s": step_s,
                             "peak_gib": mem, "launches": counts})
                print(f"{label} rank {rank}/{world} step {t}: loss "
                      f"{loss:.6f} step_s {step_s:.4f} peak {mem:.3f} GiB "
                      f"launches {counts}, parameters equal across the "
                      f"pods" + (", loss == off's" if pipeline == "wave"
                                 else ""), flush=True)
            if not gathers[0]:
                raise AssertionError(f"{label}: no token group was gathered")
            rest, whole = at_rest_bytes(state), replicated_bytes(state)
            print(f"{label} rank {rank}: bytes at rest {rest / 2**30:.3f} "
                  f"GiB a card, {rest / whole:.4f} of the replicated "
                  f"layout's {whole / 2**30:.3f} (FSDP over 'data')",
                  flush=True)
            if not rest < 0.55 * whole:
                raise AssertionError(f"{label}: {rest} bytes at rest, the "
                                     f"replicated layout {whole}")
            parts = [host_copy(x) for x in tree.leaves(state["params"])
                     + tree.leaves(state["ef"])]
            if pipeline == "off":
                if not shapes.get("ef_select_pack"):
                    raise AssertionError(f"{label}: ef_select_pack never "
                                         f"launched")
                kept = {"losses": [r["loss"] for r in rows], "parts": parts}
                print(f"{label} rank {rank}: every kernel launch of its "
                      f"{MOE_SPAN_STEPS} steps == its plain version, "
                      f"bitwise; (rows, bs, k) "
                      f"{dict((k, sorted(v)) for k, v in shapes.items())}; "
                      f"{gathers[0]} row gathers", flush=True)
            else:
                for i, (got, want) in enumerate(zip(parts, kept["parts"])):
                    assert_bitwise(f"{label} leaf {i} vs off", (got,),
                                   (want,))
                print(f"{label} rank {rank}: losses, parameters and "
                      f"residuals == off's, bitwise ({len(parts)} leaves); "
                      f"{gathers[0]} row gathers", flush=True)
            res[pipeline] = {"steps": rows, "gathers": gathers[0],
                             "at_rest_bytes": rest,
                             "replicated_bytes": whole}
            del state, sess
            torch.cuda.empty_cache()
    finally:
        TP.gather_rows = real_gather
        torch.use_deterministic_algorithms(False)
    return totals, res, errs


def host_copy(x):
    """A leaf's host copy (this rank's chunk of a ``DTensor``)."""
    from repro_torch.sharding import dtensor as D
    return D.local(x.detach()).to("cpu", copy=True)


#: serving over ("data", "model") (``tp_serving_phase``): requests of
#: ``SERVE_BATCH`` prompts of ``SERVE_PROMPT`` tokens, this many
#: generated, in f32 (the logits' comparison and the greedy tokens
#: against one card then see only the sums' order)
TP_SERVE_GEN = 16
TP_SERVE_REQUESTS = 2
#: |logits - one card's| over max |one card's|, at 2 x 2 in f32
TP_SERVE_RTOL = 1e-4
def tp_serve_family_cuts() -> dict:
    """The families ``tp_serving_phase`` adds at 2 x 2, in f32 at full
    width: name -> (config, layers kept (None: all), frontend rows beside
    each prompt (-1: the config's patches)).  xLSTM-1.3B at the xlstm
    phase's cut (``XLSTM_LAYERS`` of 48), Jamba-v0.1 at the jamba
    phase's training cut (``JAMBA_TRAIN_LAYERS`` of 32, dense FFNs: the
    Mamba states on 'model'), SeamlessM4T-Large-v2 whole with
    ``ENCDEC_FRAMES`` frames, LLaVA-NeXT-Mistral-7B whole with its 2880
    patches."""
    return {"xlstm": ("xlstm_1_3b", XLSTM_LAYERS, 0),
            "jamba": ("jamba_v0_1_52b", JAMBA_TRAIN_LAYERS, 0),
            "seamless": ("seamless_m4t_large_v2", None, ENCDEC_FRAMES),
            "llava": ("llava_next_mistral_7b", None, -1)}


#: the families the one-card run adds at 1 x 1, in the config's bf16,
#: held bitwise against ``mesh=None``
TP1_SERVE_FAMILIES = ("jamba", "seamless")


def family_config(name: str, f32: bool):
    """``tp_serve_family_cuts()[name]``'s config at its cut (the jamba
    cut with dense FFNs), in f32 when ``f32``, and its frontend rows."""
    from repro_torch.configs import base
    arch, layers, rows = tp_serve_family_cuts()[name]
    cfg = base.get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if name == "jamba":
        cfg = dataclasses.replace(cfg, n_experts=0, moe_top_k=0)
    if f32:
        cfg = dataclasses.replace(cfg, dtype="float32",
                                  param_dtype="float32")
    return cfg, (cfg.n_frontend_tokens if rows < 0 else rows)


def serve_by_steps(dev, cfg, mesh, params, batch, gen: int,
                   toks=None) -> dict:
    """``launch/serve``'s prefill and ``gen`` decode steps on ``mesh``
    (None: one card): greedy, or fed ``toks`` (B, gen).  Returns the
    logits of every step (f32), the greedy token of every step, decode
    tok/s and the peak device memory (GiB) over the run."""
    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import serve as SV
    from repro_torch.serving import engine as E
    b, n = batch["tokens"].shape
    front = batch.get("frontend_embeds")
    plen = n + (front.shape[1] if front is not None
                and not cfg.n_encoder_layers else 0)
    shape = InputShape("serve", n, b, "prefill")
    pre, _ = SV.make_prefill_step(cfg, mesh, shape, chunk=64)
    step, _ = SV.make_serve_step(cfg, mesh, dataclasses.replace(
        shape, seq_len=plen + gen, kind="decode"), chunk=64)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    placed = SV.place_params(cfg, mesh, params)
    logits, states = pre(placed, batch)
    states = E.pad_states_for_decode(cfg, states, plen, plen + gen)
    out, greedy = [logits.float()], []
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for i in range(gen):
        greedy.append(torch.argmax(logits, -1)[:, None])
        tok = greedy[-1] if toks is None else toks[:, i:i + 1]
        logits, states = step(placed, tok, states, plen + i)
        out.append(logits.float())
    torch.cuda.synchronize(dev)
    tok_s = b * gen / (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    del states, placed
    torch.cuda.empty_cache()
    return {"logits": out, "tokens": torch.cat(greedy, 1), "tok_s": tok_s,
            "peak_gib": peak}


def serve_family(dev, name: str, mesh, world: int, rank: int) -> dict:
    """One family of ``tp_serve_family_cuts()`` (seeded random weights, the
    same on every card) served on ``mesh`` against one card: at 2 x 2 in
    f32 the mesh fed one card's greedy tokens must pick them at every
    step, its logits within ``TP_SERVE_RTOL``; at 1 x 1 in bf16 every
    logit and token bit for bit.  Returns its row."""
    import torch
    from repro_torch.data import synthetic
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    tp = world > 1
    cfg, rows = family_config(name, f32=tp)
    params = T.init_params(cfg, seed=0, device=dev)
    batch = synthetic.lm_input_batch(7, SERVE_BATCH, SERVE_PROMPT, cfg.vocab,
                                     device=dev)
    batch = {"tokens": batch["tokens"]}
    if rows:
        gen = torch.Generator(device=dev)
        gen.manual_seed(11)
        batch["frontend_embeds"] = torch.randn(
            (SERVE_BATCH, rows, cfg.d_model), generator=gen, device=dev,
            dtype=torch.float32).to(L.DTYPES[cfg.dtype])
    label = "2x2" if tp else "1x1"
    one = serve_by_steps(dev, cfg, None, params, batch, TP_SERVE_GEN)
    got = serve_by_steps(dev, cfg, mesh, params, batch, TP_SERVE_GEN,
                         toks=one["tokens"] if tp else None)
    if not torch.equal(got["tokens"], one["tokens"]):
        raise AssertionError(f"tp serving {label} {name}: greedy tokens "
                             f"differ from one card's")
    worst = 0.0
    for i, (a, b) in enumerate(zip(got["logits"], one["logits"])):
        if tp:
            rel = float((a - b).abs().max() / b.abs().max())
            worst = max(worst, rel)
            if not rel <= TP_SERVE_RTOL:
                raise AssertionError(f"tp serving {label} {name} step {i}: "
                                     f"logits {rel:.3e} from one card's")
        else:
            assert_bitwise(f"tp serving 1x1 {name} step {i} logits", (a,),
                           (b,))
    how = (f"logits within {worst:.3e} of one card's (rtol "
           f"{TP_SERVE_RTOL:g})" if tp else "logits == one device's, bitwise")
    print(f"tp serving {label} {name} rank {rank}/{world} ({cfg.name}, "
          f"{cfg.n_layers} layers, {cfg.dtype}, {SERVE_BATCH} x "
          f"{SERVE_PROMPT} tokens" + (f" + {rows} frontend rows" if rows
                                       else "") +
          f", {TP_SERVE_GEN} generated): tokens == one card's; {how}; decode "
          f"{got['tok_s']:.1f} tok/s (one card {one['tok_s']:.1f}); peak "
          f"{got['peak_gib']:.3f} GiB a card (one card "
          f"{one['peak_gib']:.3f})", flush=True)
    del params
    torch.cuda.empty_cache()
    return {"config": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
            "frontend_rows": rows, "tok_s": got["tok_s"],
            "one_card_tok_s": one["tok_s"], "peak_gib": got["peak_gib"],
            "one_card_peak_gib": one["peak_gib"], "logits_rel": worst}


def tp_serving_phase(dev, world: int = 1, rank: int = 0) -> dict:
    """TinyLlama-1.1B at full width (seeded random weights) served by
    ``ServeSession`` and ``launch/serve``'s steps, inside
    ``process_group``.  One card: ("data", "model") = 1 × 1 in the
    config's bf16 against the one-device path (``mesh=None``) on the same
    weights and prompts: every step's logits and the generated tokens
    bit for bit.  ``world`` = 4: data 2 × model 2 in f32 (the parameters
    over 'model', the batch over 'data', the caches' sequence over
    'model'; every rank serves the same requests) against every rank's
    own one-card serve: the generated tokens equal, prefill's and every
    decode step's logits (fed the one card's tokens) within
    ``TP_SERVE_RTOL``; the decode tok/s and the peak device memory a
    card print for both.  Returns its rows."""
    import torch
    from repro_torch.configs import tinyllama_1_1b
    from repro_torch.configs.base import InputShape
    from repro_torch.data import synthetic
    from repro_torch.launch import mesh as M
    from repro_torch.launch import serve as SV
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine as E
    from repro_torch.stream import ServeSession
    tp = world > 1
    cfg = tinyllama_1_1b.CONFIG
    if tp:
        cfg = dataclasses.replace(cfg, dtype="float32",
                                  param_dtype="float32")
    mesh = M.make_mesh(model=2 if tp else 1, device=dev.type)
    label = "2x2" if tp else "1x1"
    params = T.init_params(cfg, seed=0, device=dev)
    prompts = synthetic.MarkovLM(vocab=cfg.vocab, seed=7).batch(
        20_000, SERVE_BATCH, SERVE_PROMPT, device=dev)["tokens"]
    n, cap = SERVE_PROMPT, SERVE_PROMPT + TP_SERVE_GEN
    shape = InputShape("serve", cap, SERVE_BATCH, "decode")
    res: dict = {}

    def requests(m):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        sub = ServeSession(cfg, shape, params, mesh=m)
        outs, rates = [], []
        for _ in range(TP_SERVE_REQUESTS):
            outs.append(sub.generate(prompts, TP_SERVE_GEN))
            rates.append(sub.requests[-1].decode_tok_s)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        del sub
        torch.cuda.empty_cache()
        return outs, rates, peak

    def logits_of(m, toks):
        """Prefill's and every decode step's logits, fed ``toks``."""
        pre, _ = SV.make_prefill_step(cfg, m, dataclasses.replace(
            shape, seq_len=n, kind="prefill"), chunk=64)
        step, _ = SV.make_serve_step(cfg, m, shape, chunk=64)
        placed = SV.place_params(cfg, m, params)
        logits, states = pre(placed, {"tokens": prompts})
        states = E.pad_states_for_decode(cfg, states, n, cap)
        out = [logits.float()]
        for i in range(TP_SERVE_GEN):
            logits, states = step(placed, toks[:, i:i + 1], states, n + i)
            out.append(logits.float())
        del states, placed
        torch.cuda.empty_cache()
        return out

    one_toks, one_rates, one_peak = requests(None)
    got_toks, got_rates, got_peak = requests(mesh)
    for i, (a, b) in enumerate(zip(got_toks, one_toks)):
        if not torch.equal(a, b):
            raise AssertionError(f"tp serving {label} request {i}: tokens "
                                 f"differ from one card's")
    want = logits_of(None, one_toks[0])
    got = logits_of(mesh, one_toks[0])
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if tp:
            rel = float((a - b).abs().max() / b.abs().max())
            worst = max(worst, rel)
            if not rel <= TP_SERVE_RTOL:
                raise AssertionError(f"tp serving {label} step {i}: logits "
                                     f"{rel:.3e} from one card's")
        else:
            assert_bitwise(f"tp serving 1x1 step {i} logits", (a,), (b,))
    res = {"mesh": label, "dtype": cfg.dtype,
           "requests": TP_SERVE_REQUESTS, "batch": SERVE_BATCH,
           "prompt": n, "generated": TP_SERVE_GEN,
           "tok_s": got_rates, "one_card_tok_s": one_rates,
           "peak_gib": got_peak, "one_card_peak_gib": one_peak,
           "logits_rel": worst}
    how = (f"logits within {worst:.3e} of one card's (rtol "
           f"{TP_SERVE_RTOL:g})" if tp else "logits == one device's, bitwise")
    print(f"tp serving {label} rank {rank}/{world} ({cfg.dtype}): "
          f"{TP_SERVE_REQUESTS} requests of {SERVE_BATCH} x {n} tokens, "
          f"{TP_SERVE_GEN} generated: tokens == one card's; {how}; decode "
          f"{', '.join(f'{r:.1f}' for r in got_rates)} tok/s (one card "
          f"{', '.join(f'{r:.1f}' for r in one_rates)}); peak "
          f"{got_peak:.3f} GiB a card (one card {one_peak:.3f})",
          flush=True)
    del params
    torch.cuda.empty_cache()
    res["families"] = {
        name: serve_family(dev, name, mesh, world, rank)
        for name in (tp_serve_family_cuts() if tp else TP1_SERVE_FAMILIES)}
    return res


#: FSDP serving (``fsdp_serving_phase``): Jamba-v0.1 whole, one request
#: of ``SERVE_BATCH`` prompts of ``SERVE_PROMPT`` tokens, this many
#: generated
FSDP_SERVE_GEN = 16
#: FSDP's bytes at rest a card over its twin's, at most (half, plus 1 %
#: for the small leaves the rules leave whole over 'data')
FSDP_REST_RATIO = 0.5 * 1.01


def fsdp_serving_phase(dev, world: int, rank: int) -> dict:
    """Jamba-v0.1 whole (32 layers, 16 experts top 2, bf16, 51.57 B
    parameters: 96.06 GiB, which no card holds) served on data 2 ×
    model 2, where ``launch.serve.needs_fsdp_serving`` holds: the
    parameters built chunk by chunk from a seed
    (``launch.serve.init_placed_params``: each rank makes a leaf, or one
    layer of a stacked leaf, keeps its ('data', 'model') chunk and frees
    the rest), each layer gathered over 'data' just before it runs.  One
    request, greedy.  Its twin is this phase with
    ``launch.serve.DEVICE_BYTES`` raised past the model, so that the
    same draws rest over 'model' alone (48 GiB a card): every logit and
    token of the FSDP run must equal the twin's bit for bit, and its
    bytes at rest a card be at most ``FSDP_REST_RATIO`` of the twin's.
    Prints the bytes at rest, tok/s and the peak a card of both, and the
    gathers' time a decode token.  Returns its row."""
    import torch
    from repro_torch import tree
    from repro_torch.configs import jamba_v0_1_52b
    from repro_torch.data import synthetic
    from repro_torch.launch import mesh as M
    from repro_torch.launch import serve as SV
    from repro_torch.sharding import dtensor as D
    cfg = jamba_v0_1_52b.CONFIG
    mesh = M.make_mesh(model=2, device=dev.type)
    prompts = synthetic.lm_input_batch(7, SERVE_BATCH, SERVE_PROMPT,
                                       cfg.vocab, device=dev)["tokens"]
    runs: dict = {}
    real = SV.DEVICE_BYTES
    gather_s: list = []
    for name, bytes_ in (("fsdp", real), ("twin", 2 ** 40)):
        SV.DEVICE_BYTES = bytes_
        try:
            on = SV.fsdp(cfg, mesh)
            if on != (name == "fsdp"):
                raise AssertionError(f"fsdp serving {name}: fsdp(cfg, mesh) "
                                     f"is {on}")
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            params = SV.init_placed_params(cfg, mesh, seed=0, device=dev)
            torch.cuda.synchronize(dev)
            build_s = time.perf_counter() - t0
            rest = sum(D.local(p).numel() * p.element_size()
                       for p in tree.leaves(params))
            fetch = SV.make_fetch(cfg, mesh)
            # the gathers alone: each layer's leaves as a decode token
            # fetches them, a pass over the whole stack; the second
            # pass timed (the first takes the allocator's blocks)
            for _ in range(2 if fetch is not None else 0):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                for stack in params["decoder"]["blocks"]:
                    for t in range(tree.leaves(stack)[0].shape[0]):
                        fetch(tree.map(lambda w: w[t], stack))
                fetch({k: v for k, v in params.items() if k != "decoder"})
                torch.cuda.synchronize(dev)
                gather_s[:] = [time.perf_counter() - t0]
            run = serve_by_steps(dev, cfg, mesh, params,
                                 {"tokens": prompts}, FSDP_SERVE_GEN)
        finally:
            SV.DEVICE_BYTES = real
        del params
        torch.cuda.empty_cache()
        run.update(rest_gib=rest / 2 ** 30, build_s=build_s)
        runs[name] = run
        print(f"fsdp serving {name} rank {rank}/{world}: {cfg.name} whole "
              f"({cfg.n_layers} layers, {cfg.n_experts} experts top "
              f"{cfg.moe_top_k}, {cfg.param_dtype}, {cfg.param_count()} "
              f"parameters), FSDP {on}: {rest / 2 ** 30:.3f} GiB at rest a "
              f"card (built in {build_s:.1f} s); {SERVE_BATCH} x "
              f"{SERVE_PROMPT} tokens, {FSDP_SERVE_GEN} generated: decode "
              f"{run['tok_s']:.2f} tok/s, peak {run['peak_gib']:.3f} GiB a "
              f"card", flush=True)
    fs, twin = runs["fsdp"], runs["twin"]
    for i, (a, b) in enumerate(zip(fs["logits"], twin["logits"])):
        assert_bitwise(f"fsdp serving step {i} logits", (a,), (b,))
    if not torch.equal(fs["tokens"], twin["tokens"]):
        raise AssertionError("fsdp serving: tokens differ from the twin's")
    ratio = fs["rest_gib"] / twin["rest_gib"]
    if not ratio <= FSDP_REST_RATIO:
        raise AssertionError(f"fsdp serving: {fs['rest_gib']:.3f} GiB at "
                             f"rest a card, {ratio:.4f} of the twin's "
                             f"(at most {FSDP_REST_RATIO})")
    print(f"fsdp serving rank {rank}/{world}: logits and tokens == the "
          f"twin's, bitwise; at rest {ratio:.4f} of the twin's; the gathers "
          f"of one decode token (one pass over the stack) "
          f"{gather_s[0]:.3f} s", flush=True)
    return {"config": cfg.name, "layers": cfg.n_layers,
            "params": cfg.param_count(), "gen": FSDP_SERVE_GEN,
            "rest_ratio": ratio, "gather_pass_s": gather_s[0],
            **{f"{k}_{name}": runs[name][k] for name in runs
               for k in ("rest_gib", "tok_s", "peak_gib", "build_s")}}


#: the stream over 'model' (``tp_stream_phase``): delta packets after
#: the full one, and the budget of each
TP_STREAM_DELTAS = 2
TP_STREAM_BUDGET = 1 << 24


def tp_stream_phase(dev, world: int, rank: int) -> tuple[dict, dict, dict]:
    """TinyLlama-1.1B at full width in f32 (seeded random weights, the
    same on every rank; f32, as ``tp_serving_phase``'s 2 x 2 serve, so
    that the one card's greedy tokens are a fair target for the ranks'
    sums in another order): a ``StreamPublisher`` under
    ``topk_block_kernel`` cuts a full packet, then ``TP_STREAM_DELTAS``
    deltas of the weights moved by seeded noise (every ``block_topk``
    launch held to its plain version, ``held_to_plain``); a
    ``ServeSession`` on data 2 × model 2 and a one-card one apply each:
    the same status, and the former's gathered parameters the latter's
    bit for bit.  Then a dropped version (both refuse it: ``gap``), a
    ``resync`` from ``save_full`` (rank 0 writes it to the git-ignored
    ``.stream_scratch/``; deleted after): both restore the published
    version, bit for bit; ``generate`` gives the one card's tokens.
    Returns (the launches, its row, each kernel's largest error against
    its plain version)."""
    import torch
    import torch.distributed as dist
    from repro_torch import kernels, tree
    from repro_torch.configs import tinyllama_1_1b
    from repro_torch.configs.base import InputShape
    from repro_torch.data import synthetic
    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as T
    from repro_torch.sharding import dtensor as D
    from repro_torch.stream import ServeSession, StreamPublisher
    cfg = dataclasses.replace(tinyllama_1_1b.CONFIG, dtype="float32",
                              param_dtype="float32")
    mesh = M.make_mesh(model=2, device=dev.type)
    params = T.init_params(cfg, seed=0, device=dev)
    shape = InputShape("serve", SERVE_PROMPT, SERVE_BATCH, "decode")
    subs = [ServeSession(cfg, shape, tree.map(lambda p: p.clone(), params),
                         mesh=m) for m in (mesh, None)]
    pub = StreamPublisher(params, every=1, compressor="topk_block_kernel",
                          budget_bytes=TP_STREAM_BUDGET)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    errs: dict = {}
    shapes: dict = {}
    rows = []

    def publish(step):
        with torch.no_grad():
            for p in tree.leaves(params):
                p.add_((1e-3 * torch.randn(p.shape, generator=gen,
                                           device=dev)).to(p.dtype))
        with held_to_plain(errs, shapes):
            return pub.publish(step, params)

    def same() -> bool:
        return all(torch.equal(a, b) for a, b in zip(
            tree.leaves(D.gather(subs[0].params)),
            tree.leaves(subs[1].params)))

    kernels.reset_launch_counts()
    for step in range(1 + TP_STREAM_DELTAS):
        pkt = publish(step)
        status = [sub.apply_packet(pkt) for sub in subs]
        if status != ["applied"] * 2 or not same():
            raise AssertionError(f"tp stream packet {pkt.version} "
                                 f"({pkt.kind}): {status}, parameters "
                                 f"differ from the one card's")
        rows.append({"version": pkt.version, "kind": pkt.kind,
                     "nbytes": pkt.nbytes})
        del pkt
    launches = kernels.launch_counts()
    if not launches["block_topk"]:
        raise AssertionError("tp stream: no block_topk launch")
    publish(1 + TP_STREAM_DELTAS)
    pkt = publish(2 + TP_STREAM_DELTAS)
    gap = [sub.apply_packet(pkt) for sub in subs]
    if gap != ["gap"] * 2 or not subs[0].needs_resync:
        raise AssertionError(f"tp stream: a dropped version gave {gap}")
    del pkt
    STREAM_SCRATCH.mkdir(exist_ok=True)
    path = str(STREAM_SCRATCH / "tp_resync")
    if rank == 0:
        pub.save_full(path, step=9)
    dist.barrier()
    try:
        versions = [sub.resync(path) for sub in subs]
    finally:
        dist.barrier()
        if rank == 0:
            for suffix in (".npz", ".json"):
                Path(path + suffix).unlink(missing_ok=True)
    if versions != [pub.version] * 2 or not same():
        raise AssertionError(f"tp stream resync: versions {versions} "
                             f"(published {pub.version}), or parameters "
                             f"differ from the one card's")
    prompts = synthetic.MarkovLM(vocab=cfg.vocab, seed=7).batch(
        20_000, SERVE_BATCH, SERVE_PROMPT, device=dev)["tokens"]
    toks = [sub.generate(prompts, TP_SERVE_GEN) for sub in subs]
    if not torch.equal(*toks):
        raise AssertionError("tp stream: tokens after the resync differ "
                             "from the one card's")
    print(f"tp stream rank {rank}/{world}: {cfg.name} f32, a full packet "
          f"and {TP_STREAM_DELTAS} deltas (topk_block_kernel, "
          f"{launches['block_topk']} block_topk launches == plain, bitwise) "
          f"applied over data 2 x model 2 == one card's, bitwise; a gap "
          f"refused; resync to version {pub.version} bitwise; generate == "
          f"one card's tokens", flush=True)
    del subs, params, pub
    torch.cuda.empty_cache()
    return launches, {"packets": rows, "resync_version": versions[0]}, errs


DEGRADED = dict(name="degraded", alpha=50e-3, beta=1e-6)
#: where the phase's large artifacts (the chrome trace, the full-width
#: checkpoint) go before they are deleted: in the checkout, not copied
#: back from the chip (git-ignored)
OBSERVE_SCRATCH = ROOT / ".observe_scratch"


def alternate_steps(fns: dict, state, data_fn, rounds: int = 3):
    """Step times of each step function of ``fns`` (label -> fn) on one
    live state: one warm-up step of each first, then ``rounds`` rounds
    in which each runs once, in turn, so no function takes the warm-up
    or a drift of the card alone.  Returns (state, label -> the timed
    steps' seconds, label -> their median)."""
    import numpy as np
    import torch
    times = {label: [] for label in fns}
    t = 0
    for r in range(rounds + 1):
        for label, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = fn(state, data_fn(t))
            float(m["loss"])
            if r:
                times[label].append(time.perf_counter() - t0)
            t += 1
    return state, times, {k: float(np.median(v)) for k, v in times.items()}


def observe_phase(dev, cfg, seq: int, out_dir: Path, world: int = 1,
                  rank: int = 0) -> tuple[dict, dict]:
    """The observe plane and online re-planning at full width, over the
    NCCL group of ``world`` ranks (inside ``process_group``):
    ``Session(cfg, lags_dp + kernel, health_every=1).run`` for
    ``OBSERVE_STEPS`` steps with a ``HealthMonitor`` and a controller
    whose triggers are a cadence, an anomaly detector and the health
    monitor, its telemetry from a fake trace whose wire degrades after
    step ``OBSERVE_SHIFT`` (the anomaly must swap the live step); step
    times with and without health and under a capture; a real
    ``torch.profiler`` trace of the live step fed to the controller, to
    ``overlap_report`` and to ``profile_model(trace=...)``; the health
    gauges of every leaf; the snapshot through ``observe.check``; and
    (rank 0) the final checkpoint and controller state restored bit for
    bit.  Under several ranks the replicas must stay bitwise equal and
    rank 0's trace is the one every rank ingests.  Returns (launch
    counts of the phase, results)."""
    import shutil

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import api, kernels, tree
    from repro_torch.autotune import costfit, planner, profiler
    from repro_torch.checkpoint import io as ckpt
    from repro_torch.core import comm_model as cm
    from repro_torch.data import synthetic
    from repro_torch.launch import mesh as M
    from repro_torch.observe import anomaly as AN
    from repro_torch.observe import attribution as OA
    from repro_torch.observe import check as OC
    from repro_torch.observe import events as OE
    from repro_torch.observe import health as OH
    from repro_torch.observe import metrics as OM
    from repro_torch.observe import names as ON
    from repro_torch.observe import trace as OT
    from repro_torch.observe import triggers as OTG
    from repro_torch.runtime import RuntimeConfig

    who = f" rank {rank}/{world}" if world > 1 else ""

    def say(msg: str) -> None:
        print(f"observe{who}: {msg}", flush=True)

    scratch = OBSERVE_SCRATCH / f"rank{rank}"
    shutil.rmtree(scratch, ignore_errors=True)
    scratch.mkdir(parents=True)
    res: dict = {"world": world}
    try:
        mesh = M.make_mesh(device=dev.type)
        run = api.RunConfig(mode="lags_dp", selection_backend="kernel",
                            lr=0.01, health_every=1)
        sess = api.Session(cfg, run, mesh=mesh)
        state, _ = sess.init_state(seed=0)
        data = synthetic.MarkovLM(vocab=cfg.vocab, seed=3)

        def data_fn(t):
            return data.batch(t, world, seq, device=dev)

        kernels.reset_launch_counts()
        # step time with and without the health quantities (a warm-up
        # step of each, then 3 in turn), then the live step under a capture
        plain_fn = api.build_train_step(
            cfg, mesh, dataclasses.replace(run, health_every=0))[0]
        state, times, med = alternate_steps(
            {"health_every=0": plain_fn, "health_every=1": sess.step_fn},
            state, data_fn)
        for label, ts in times.items():
            say(f"step s {label}: {[round(x, 4) for x in ts]} (in turn "
                f"after a warm-up step each), median {med[label]:.4f}")
        del plain_fn
        res["step_s"], res["step_s_median"] = times, med
        t_plain = med["health_every=0"]
        if world > 1:      # one plan and one fake trace on every rank
            t_plain = torch.tensor([t_plain], dtype=torch.float64,
                                   device=dev)
            dist.broadcast(t_plain, 0)
            t_plain = float(t_plain)
        # the live plan before the shift: Eq. 18 on the healthy wire over
        # the fake trace's budgets (the plain step's time split 2:1 into
        # backward and forward), leaves whose exchange hides kept dense
        # one card: the tests' what-if of 8 workers (one rank prices no
        # wire); several: the ranks
        p_plan = world if world > 1 else 8
        budgets = profiler.apportion_backward(
            profiler.backprop_leaves(cfg, 1.0),
            profiler.BWD_FRACTION * t_plain)
        healthy = planner.plan_schedule(budgets, p=p_plan,
                                        hw=cm.H100_NVLINK, arch=cfg.name,
                                        shape="observe")
        say(f"healthy-wire plan at P = {p_plan}: ratios "
            f"{[lp.ratio for lp in healthy.leaves]}")
        sess = api.Session(cfg, dataclasses.replace(run, schedule=healthy),
                           mesh=mesh)

        # the controller: cadence, anomaly and health triggers; telemetry
        # from a fake trace over those budgets, whose wire degrades
        mon = OH.HealthMonitor()
        reg, evs = OM.MetricsRegistry(), OE.EventLog()
        wires = {"flat": cm.H100_NVLINK}
        slow = dataclasses.replace(cm.H100_NVLINK, **DEGRADED)
        rcfg = RuntimeConfig(replan_every=OBSERVE_CADENCE, fence_every=1,
                             min_step_samples=1)
        # the cadence resets the detector every OBSERVE_CADENCE steps, so
        # it judges one step against the two before it
        anomaly_cfg = AN.AnomalyConfig(warmup=0, recent=1, min_history=2)
        ctl = sess.controller(
            rcfg=rcfg, triggers=(OTG.CadenceTrigger(OBSERVE_CADENCE),
                                 OTG.AnomalyTrigger(cfg=anomaly_cfg),
                                 OTG.HealthTrigger(mon)),
            metrics=reg, events=evs)
        ctl.meta["n_workers"] = p_plan
        fake = OT.FakeTraceBackend(
            budgets, wires=wires, tier_workers={"flat": p_plan},
            t_forward=(1.0 - profiler.BWD_FRACTION) * t_plain,
            schedule_fn=lambda: ctl.schedule)
        ctl.trace_source = fake.capture
        live_step, per_step = ctl.step, []

        def watched(state_, batch):
            """``ctl.step``, with the memory around it; the wire shift
            after step OBSERVE_SHIFT; the what-if worker count again
            after a rebuild."""
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            n_swaps = sum(e.swapped for e in ctl.history)
            out = live_step(state_, batch)
            torch.cuda.synchronize()
            per_step.append({
                "count": ctl._step_count, "before": before,
                "after": torch.cuda.memory_allocated(),
                "peak": torch.cuda.max_memory_allocated(),
                "swapped": sum(e.swapped for e in ctl.history) > n_swaps,
                "end": time.perf_counter()})
            ctl.meta["n_workers"] = p_plan
            if ctl._step_count == OBSERVE_SHIFT:
                wires["flat"] = slow
            return out

        ctl.step = watched
        run_dir = scratch / "run" if rank == 0 else None
        t0 = time.perf_counter()
        state, hist = sess.run(data_fn, OBSERVE_STEPS, controller=ctl,
                               state=state,
                               out_dir=None if run_dir is None
                               else str(run_dir),
                               metrics=reg, events=evs, health_monitor=mon,
                               log_every=1, print_fn=say)
        t_return = time.perf_counter()
        ctl.step = live_step
        losses = [r["loss"] for r in hist]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"observe: losses {losses}")
        for ev in ctl.history:
            say(f"replan at controller step {ev.step}: trigger "
                f"{ev.trigger}, swapped {ev.swapped}, predicted improvement "
                f"{ev.improvement:.4f} ({ev.t_pred_current:.6f} -> "
                f"{ev.t_pred_candidate:.6f} s), fit {ev.hw_name}")
        swaps = [ev for ev in ctl.history
                 if ev.swapped and "anomaly" in ev.trigger]
        if not swaps:
            raise AssertionError(f"observe: no anomaly-triggered swap in "
                                 f"{ctl.history}")
        swap = swaps[0]
        after = [r["loss"] for r, s in zip(hist, per_step)
                 if s["count"] > swap.step]
        if len(after) < 2:
            raise AssertionError(f"observe: {len(after)} steps after the "
                                 f"swap at {swap.step}")
        # the caller holds the old state until the step returns, so the
        # steady memory after the swap is the next step's starting one
        at = next(i for i, s in enumerate(per_step)
                  if s["count"] == swap.step)
        mem = dict(per_step[at], after=per_step[at + 1]["before"])
        say(f"anomaly-triggered swap at controller step {swap.step} (wire "
            f"degraded after {OBSERVE_SHIFT}): "
            f"{sum(lp.ratio > 1.0 for lp in ctl.schedule.leaves)} of "
            f"{len(ctl.schedule.leaves)} leaves sparse, ratios "
            f"{sorted({lp.ratio for lp in ctl.schedule.leaves})}; losses "
            f"after it {after}; device memory allocated at the start of "
            f"the swap step {mem['before'] / 2**30:.3f} GiB and of the "
            f"next {mem['after'] / 2**30:.3f} GiB, peak in the swap step "
            f"{mem['peak'] / 2**30:.3f} GiB (other steps "
            f"{min(s['peak'] for s in per_step) / 2**30:.3f}-"
            f"{max(s['peak'] for s in per_step) / 2**30:.3f})")
        if mem["after"] > mem["before"] + (64 << 20):
            raise AssertionError(f"observe: {mem['after'] - mem['before']} "
                                 f"bytes more alive after the swap")
        if world > 1:
            check_replicas(state["params"], "observe after the swap")
            say("parameters equal on every rank after the swap")
        res.update(losses=losses, rows=hist, memory=per_step,
                   history=[dataclasses.asdict(e) for e in ctl.history],
                   schedule=json.loads(ctl.schedule.to_json()))

        # (c) the health gauges of every leaf
        fam = reg.get("train_health_delta")
        got = {fam.labels_dict(k)["leaf"]: v for k, v in fam.items()}
        deltas = {}
        for leaf in tree.leaf_paths(state["params"]):
            v = got.get(ON.health_name("delta", leaf))
            if v is None or not math.isfinite(v) or v < 0.0:
                raise AssertionError(f"observe: delta of {leaf} = {v}")
            deltas[leaf] = v
        say("delta per leaf (last step): " + ", ".join(
            f"{k} {v:.4f}" for k, v in deltas.items()))
        res["delta"] = deltas

        if rank == 0:
            # (d) the final checkpoint and controller state, restored into
            # a fresh state and a fresh controller
            npz = run_dir / "ckpt_final.npz"
            size = npz.stat().st_size
            t_save = t_return - per_step[-1]["end"]
            fresh, _ = sess.init_state(seed=1)
            t0 = time.perf_counter()
            back = ckpt.restore(str(run_dir / "ckpt_final"),
                                {"params": fresh["params"],
                                 "step": np.int32(0)})
            torch.cuda.synchronize()
            t_restore = time.perf_counter() - t0
            bad = [path for path, a, b in zip(
                tree.leaf_paths(state["params"]),
                tree.leaves(back["params"]), tree.leaves(state["params"]))
                if a.dtype != b.dtype or not torch.equal(bits(a), bits(b))]
            step_back = int(back["step"])
            del fresh, back
            npz.unlink()
            torch.cuda.empty_cache()
            if bad or step_back != state["step"]:
                raise AssertionError(f"observe: checkpoint step {step_back}, "
                                     f"leaves {bad} differ")
            ctl2 = sess.controller(
                rcfg=rcfg, triggers=(OTG.CadenceTrigger(OBSERVE_CADENCE),
                                     OTG.AnomalyTrigger(cfg=anomaly_cfg),
                                     OTG.HealthTrigger(OH.HealthMonitor())),
                metrics=OM.MetricsRegistry(), events=OE.EventLog())
            ctl2.restore_state(str(run_dir / "runtime_final"))
            same = {
                "schedule": ctl2.schedule.to_json() == ctl.schedule.to_json(),
                "history": ctl2.history == ctl.history,
                "steps": (ctl2.telemetry.step_samples()
                          == ctl.telemetry.step_samples()),
                "comm": (ctl2.telemetry.comm_samples()
                         == ctl.telemetry.comm_samples()),
                "triggers": [t.state_dict() for t in ctl2.triggers[1:]]
                == [t.state_dict() for t in ctl.triggers[1:]],
                "step_count": ctl2._step_count == ctl._step_count}
            del ctl2
            if not all(same.values()):
                raise AssertionError(f"observe: runtime_final restored "
                                     f"{same}")
            say(f"ckpt_final.npz {size} bytes ({size / 2**30:.3f} GiB): saved "
                f"in {t_save:.2f} s (the end of Session.run after its last "
                f"step), restored bitwise into a fresh state in "
                f"{t_restore:.2f} s, then deleted; runtime_final restored the "
                f"same {', '.join(same)}")
            res["checkpoint"] = {"bytes": size, "save_s": t_save,
                                 "restore_s": t_restore}

            # (c) the snapshot, through the checker and its CLI
            snap_base = run_dir / "metrics_snapshot"
            problems = OC.validate(OM.load_snapshot(str(snap_base)),
                                   require=("train", "replan"),
                                   require_health=True)
            if problems:
                raise AssertionError(f"observe: snapshot {problems}")
            out_dir.mkdir(exist_ok=True)
            for ext in (".jsonl", ".json", ".prom"):
                shutil.copy(str(snap_base) + ext,
                            out_dir / f"observe_snapshot{ext}")
            cli = subprocess.run(
                [sys.executable, "-m", "repro_torch.observe.check",
                 str(out_dir / "observe_snapshot"), "--require", "train",
                 "replan", "--require-health"],
                env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                capture_output=True, text=True, stdin=subprocess.DEVNULL)
            say(f"python -m repro_torch.observe.check "
                f"chiprun_out/observe_snapshot --require train replan "
                f"--require-health: exit {cli.returncode} "
                f"{cli.stdout.strip()}")
            if cli.returncode != 0:
                raise AssertionError(f"observe: check CLI {cli.stdout} "
                                     f"{cli.stderr}")

        # (a) a real trace of the live (swapped) step: rank 0's is the one
        # every rank ingests, so that their decisions agree
        box = {"state": state}

        def one():
            box["state"], m = ctl.step_fn(box["state"], data_fn(100))
            return box["state"], m

        t0 = time.perf_counter()
        trace = OT.capture_trace(one, log_dir=str(scratch / "trace"),
                                 steps=1)
        t_capture = time.perf_counter() - t0
        state = box.pop("state")
        if world > 1:
            obj = [trace.to_json()]
            dist.broadcast_object_list(obj, src=0)
            trace = OT.Trace.from_json(obj[0])
        comm = trace.named(ON.COMM_PREFIX)
        groups: dict = {}
        for e in comm:
            info = ON.parse(e.name)
            key = (info["tier"], info["kind"], info["label"].split("/")[0],
                   info["p"])
            n, dur = groups.get(key, (0, 0.0))
            groups[key] = (n + 1, dur + e.dur)
        t_step_trace = OA.step_time(trace)
        say(f"trace: {len(comm)} lags/comm events; timed "
            f"{trace.meta['categories']}; step "
            f"{t_step_trace * 1e3:.3f} ms (the device span of its work), "
            f"the capture "
            f"{t_capture:.3f} s (host)")
        for (tier, kind, label, p), (n, dur) in sorted(groups.items()):
            say(f"trace: lags/comm/{tier}/{kind}/{label} p={p}: {n} events, "
                f"{dur * 1e3:.3f} ms in all")
        if not trace.meta["categories"]["device_comm"]:
            raise AssertionError(f"observe: no lags/comm range timed on the "
                                 f"device ({trace.meta['categories']})")
        if not groups.get(("flat", "allgather", "blocks", world)):
            raise AssertionError(f"observe: no block gathers in {groups}")
        report = OA.overlap_report(trace)
        share = report["comm_s"] / t_step_trace if t_step_trace else 0.0
        say(f"overlap_report: comm {report['comm_s'] * 1e3:.3f} ms, hidden "
            f"{report['hidden_s'] * 1e3:.3f} ms, exposed "
            f"{report['exposed_s'] * 1e3:.3f} ms; the collectives' share "
            f"of the step {share:.4f}")
        samples = OA.comm_samples(trace)
        res["trace"] = {"events": len(comm),
                        "categories": trace.meta["categories"],
                        "t_step": t_step_trace, "capture_s": t_capture,
                        "comm_s": report["comm_s"],
                        "exposed_s": report["exposed_s"],
                        "comm_share": share,
                        "groups": {"/".join(map(str, k)): v
                                   for k, v in groups.items()}}
        if samples:
            alpha, beta = costfit.fit_alpha_beta(samples)
            say(f"attributed wire over {world} ranks ({len(samples)} "
                f"samples): alpha {alpha!r} s, beta {beta!r} s/B "
                f"({1 / beta / 1e9:.2f} GB/s); H100_NVLINK alpha "
                f"{cm.H100_NVLINK.alpha!r} s, beta {cm.H100_NVLINK.beta!r} "
                f"s/B ({1 / cm.H100_NVLINK.beta / 1e9:.2f} GB/s)")
            res["trace"]["alpha_beta"] = [alpha, beta]
        else:
            say("no wire samples at world size 1 (attribution drops p <= "
                "1): the fit falls back to H100_NVLINK")
        ctl.ingest_trace(ctl._step_count + 1, trace)
        ev = ctl.maybe_replan(ctl._step_count + 1, trigger="trace")
        say(f"replan on the real trace: fit {ev.hw_name}, budgets from "
            f"{ctl.measurement_source}, swapped {ev.swapped}")
        if world > 1 and ev.hw_name != "attr_wire_fit":
            raise AssertionError(f"observe: fit {ev.hw_name} from the trace")
        res["trace_replan"] = dataclasses.asdict(ev)
        t0 = time.perf_counter()
        prof = profiler.profile_model(cfg, mesh, seq=seq, global_batch=world,
                                      iters=1, arch=cfg.name, trace=trace)
        say(f"profile_model(trace=...): {len(prof.comm_samples)} comm "
            f"samples ({'the trace' if samples else 'the sweep'}'s), dense "
            f"step {prof.t_step_dense:.4f} s, lags step "
            f"{prof.t_step_lags:.4f} s, {time.perf_counter() - t0:.1f} s")
        if samples and [dataclasses.asdict(x) for x in prof.comm_samples] != [
                dataclasses.asdict(x)
                for x in OA.comm_samples(trace, tier="flat")]:
            raise AssertionError("observe: the profile's comm samples are "
                                 "not the trace's")
        res["profile"] = {"comm_samples": len(prof.comm_samples),
                          "t_step_dense": prof.t_step_dense,
                          "t_step_lags": prof.t_step_lags}
        if world > 1:
            check_replicas(state["params"], "observe after the trace")
        counts = kernels.launch_counts()
        say(f"launches in the phase: {counts}")
        if not counts["ef_select_pack"]:
            raise AssertionError("observe: ef_select_pack never launched")
        del state, ctl, sess
        torch.cuda.empty_cache()
        return counts, res
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


#: the tp_observe phase (item 7g): by world size, the Session.run steps,
#: the controller's cadence and the controller step after which the fake
#: trace's wire degrades; the publish cadence; the rounds of step times
#: with and without the health quantities
TP_OBSERVE_STEPS = {1: 4, 4: 8}
TP_OBSERVE_CADENCE = {1: 2, 4: 4}
TP_OBSERVE_SHIFT = {1: 1, 4: 2}
TP_OBSERVE_EVERY = 2
TP_OBSERVE_ROUNDS = 3


def tp_observe_phase(dev, cfg, seq: int, world: int = 1,
                     rank: int = 0) -> tuple[dict, dict, dict]:
    """The rest of the stack on a 'model' axis (item 7g), over the NCCL
    group of ``world`` ranks (inside ``process_group``): data 2 × model
    2 on four cards, data 1 × model 1 on one.  TinyLlama-1.1B at full
    width (bf16, seeded random weights), one ``seq``-token sequence a
    data rank, ``lags_dp`` + kernel backend:

    (a) a warm-up step each with ``health_every`` 0 and 1, then
        ``TP_OBSERVE_ROUNDS`` rounds of one step each, in turn (the
        median step s of each);
    (b) ``Session.run`` for ``TP_OBSERVE_STEPS`` steps with the health
        quantities, a controller (a cadence trigger of
        ``TP_OBSERVE_CADENCE``, its telemetry from a fake trace whose
        wire degrades after controller step ``TP_OBSERVE_SHIFT``, the
        live plan the healthy wire's: it must swap, at the same step on
        every rank) and a ``StreamPublisher`` every
        ``TP_OBSERVE_EVERY`` steps at ``full_bytes // 8`` under
        ``topk_block_kernel``, each packet bitwise the packet of a
        one-card publisher fed ``dtensor.gather`` of the parameters (its
        launches aside); every ``ef_select_pack`` and ``block_topk``
        launch of (a) and (b) held to its plain version
        (``held_to_plain``); after it the replicas over 'data' bitwise
        equal; δ max per step, packet bytes / ``full_bytes``, peak and
        bytes at rest a card printed;
    (c) ``profile_model`` on the mesh: its dense and LAGS step times,
        data workers and per-card FLOPs and bytes.

    Returns (the launch counts of (a) and (b), results, each kernel's
    largest error against its plain version)."""
    import torch
    import torch.distributed as dist
    from repro_torch import api, kernels, tree
    from repro_torch.autotune import planner, profiler
    from repro_torch.core import comm_model as cm
    from repro_torch.data import synthetic
    from repro_torch.launch import mesh as M
    from repro_torch.observe import trace as OT
    from repro_torch.observe import triggers as OTG
    from repro_torch.runtime import RuntimeConfig
    from repro_torch.sharding import dtensor as D
    from repro_torch.stream import StreamPublisher

    who = f" rank {rank}/{world}" if world > 1 else ""

    def say(msg: str) -> None:
        print(f"tp_observe{who}: {msg}", flush=True)

    model = 2 if world > 1 else 1
    n_data = world // model
    steps, cadence = TP_OBSERVE_STEPS[world], TP_OBSERVE_CADENCE[world]
    mesh = M.make_mesh(model=model, device=dev.type)
    run = api.RunConfig(mode="lags_dp", selection_backend="kernel", lr=0.01,
                        health_every=1)
    data = synthetic.MarkovLM(vocab=cfg.vocab, seed=3)

    def data_fn(t):
        return data.batch(t, n_data, seq, device=dev)

    sess = api.Session(cfg, run, mesh=mesh)
    state, _ = sess.init_state(seed=0)
    torch.cuda.empty_cache()
    res: dict = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}
    errs, shapes, checks = {}, {}, {}
    kernels.reset_launch_counts()

    # (a) step s with and without the health quantities: a warm-up step
    # of each, then TP_OBSERVE_ROUNDS in turn
    plain_fn = api.build_train_step(
        cfg, mesh, dataclasses.replace(run, health_every=0))[0]
    with held_to_plain(errs, shapes):
        state, times, med = alternate_steps(
            {"health_every=0": plain_fn, "health_every=1": sess.step_fn},
            state, data_fn, rounds=TP_OBSERVE_ROUNDS)
    for label, ts in times.items():
        say(f"step s {label}: {[round(x, 4) for x in ts]} (in turn after "
            f"a warm-up step each), median {med[label]:.4f}")
    del plain_fn
    t_plain = torch.tensor([med["health_every=0"]],
                           dtype=torch.float64, device=dev)
    dist.broadcast(t_plain, 0)      # one plan and one fake trace for all
    t_plain = float(t_plain)

    # (b) the controller and the publisher, through Session.run; the
    # live plan the healthy wire's (one data rank: the what-if of 8
    # workers, as the observe phase prices it)
    p_plan = n_data if n_data > 1 else 8
    budgets = profiler.apportion_backward(
        profiler.backprop_leaves(cfg, 1.0), profiler.BWD_FRACTION * t_plain)
    healthy = planner.plan_schedule(budgets, p=p_plan, hw=cm.H100_NVLINK,
                                    arch=cfg.name, shape="tp_observe")
    sess = api.Session(cfg, dataclasses.replace(run, schedule=healthy),
                       mesh=mesh)
    wires = {"flat": cm.H100_NVLINK}
    ctl = sess.controller(
        rcfg=RuntimeConfig(replan_every=cadence, fence_every=1,
                           min_step_samples=1),
        triggers=(OTG.CadenceTrigger(cadence),))
    ctl.meta["n_workers"] = p_plan
    fake = OT.FakeTraceBackend(
        budgets, wires=wires, tier_workers={"flat": p_plan},
        t_forward=(1.0 - profiler.BWD_FRACTION) * t_plain,
        schedule_fn=lambda: ctl.schedule)
    ctl.trace_source = fake.capture
    live_step, peaks = ctl.step, []

    def watched(state_, batch):
        torch.cuda.reset_peak_memory_stats()
        out = live_step(state_, batch)
        peaks.append(torch.cuda.max_memory_allocated())
        ctl.meta["n_workers"] = p_plan
        if ctl._step_count == TP_OBSERVE_SHIFT[world]:
            wires["flat"] = dataclasses.replace(cm.H100_NVLINK, **DEGRADED)
        return out

    class Checked:
        """The publisher; each packet held bitwise to the one-card
        publisher's of the gathered parameters."""

        def __init__(self, params):
            self.pub = StreamPublisher(params, every=TP_OBSERVE_EVERY,
                                       compressor="topk_block_kernel")
            self.one, self.rows = None, []

        def maybe_publish(self, step, params):
            pkt = self.pub.maybe_publish(step, params)
            if pkt is None:
                return None
            with aside(checks):
                full = D.gather(params)
                if self.one is None:
                    self.one = StreamPublisher(
                        full, every=TP_OBSERVE_EVERY,
                        compressor="topk_block_kernel")
                ref = self.one.publish(step, full)
                for key, entry in ref.payload.items():
                    got = pkt.payload[key]
                    assert_bitwise(f"tp_observe packet {pkt.version} {key}",
                                   tuple(got[f] for f in sorted(entry)),
                                   tuple(entry[f] for f in sorted(entry)))
                if (pkt.kind, pkt.nbytes, sorted(pkt.payload)) != (
                        ref.kind, ref.nbytes, sorted(ref.payload)):
                    raise AssertionError(f"tp_observe packet {pkt.version}: "
                                         f"{pkt.kind} {pkt.nbytes} B, the "
                                         f"one card's {ref.kind} "
                                         f"{ref.nbytes} B")
                del full, ref
            self.rows.append({"version": pkt.version, "kind": pkt.kind,
                              "nbytes": pkt.nbytes,
                              "share": pkt.nbytes / self.pub.codec.full_bytes})
            return pkt

    checked = Checked(state["params"])
    ctl.step = watched
    t0 = time.perf_counter()
    try:
        with held_to_plain(errs, shapes):
            state, hist = sess.run(data_fn, steps, controller=ctl,
                                   state=state, publisher=checked,
                                   log_every=1, print_fn=say)
    finally:
        ctl.step = live_step
    run_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    events = [(e.step, e.swapped, e.trigger) for e in ctl.history]
    every = [None] * world
    dist.all_gather_object(every, events)
    if any(e != events for e in every) or not any(s for _, s, _ in events):
        raise AssertionError(f"tp_observe: the ranks' re-plan decisions "
                             f"{every}: each must swap, at one step")
    if n_data > 1:
        check_replicas(state["params"], "tp_observe",
                       group=M.worker_axes(mesh, ("data",)).group)
    for name in ("ef_select_pack", "block_topk"):
        if not counts[name] or not shapes.get(name):
            raise AssertionError(f"tp_observe: {name} launched "
                                 f"{counts[name]} times")
    deltas = [r["health"]["delta_max"] for r in hist]
    if not all(math.isfinite(x) and x >= 0.0 for x in deltas):
        raise AssertionError(f"tp_observe: delta max {deltas}")
    rest = at_rest_bytes(state)
    pub_rest = sum(D.local(x).numel() * x.element_size() for x in
                   tree.leaves(checked.pub.published)) + sum(
        4 * r.numel() for r in checked.pub.residual.values())
    say(f"{steps} steps in {run_s:.2f} s, step s (health, controller, "
        f"publisher) {[round(r['step_s'], 4) for r in hist]}")
    say(f"re-plans (controller step, swapped, trigger): {events}, the "
        f"same on every rank; the live plan {sum(lp.ratio > 1.0 for lp in ctl.schedule.leaves)} "
        f"of {len(ctl.schedule.leaves)} leaves sparse")
    say(f"delta max per step {[round(x, 4) for x in deltas]}")
    say(f"packets {[(r['kind'], r['nbytes'], round(r['share'], 4)) for r in checked.rows]}"
        f" (bytes, / full_bytes {checked.pub.codec.full_bytes}), each == "
        f"the one card's, bitwise")
    say(f"peak {max(peaks) / 2**30:.3f} GiB a card; at rest "
        f"{rest / 2**30:.3f} GiB (parameters, residuals), the publisher's "
        f"published copy and residual {pub_rest / 2**30:.3f} GiB (chunks)")
    say(f"launches {counts}, every ef_select_pack and block_topk launch == "
        f"its plain version, bitwise; (rows, bs, k) "
        f"{dict((k, sorted(v)) for k, v in shapes.items())}; the one-card "
        f"publisher's aside {checks}")
    res.update(step_s=times, step_s_median=med, run_s=run_s, rows=hist,
               history=[dataclasses.asdict(e) for e in ctl.history],
               delta_max=deltas, packets=checked.rows, peak=max(peaks),
               at_rest_bytes=rest, publisher_bytes=pub_rest, launches=counts)
    del checked, ctl, sess
    torch.cuda.empty_cache()

    # (c) the autotune profile on the mesh
    t0 = time.perf_counter()
    prof = profiler.profile_model(cfg, mesh, seq=seq, global_batch=n_data,
                                  iters=1, arch=cfg.name,
                                  comm_sizes=(1 << 20,))
    say(f"profile_model: dense step {prof.t_step_dense:.4f} s, lags step "
        f"{prof.t_step_lags:.4f} s, {prof.n_workers} data workers, mesh "
        f"{prof.mesh_shape}, per card {prof.flops_per_step:.4g} FLOPs and "
        f"{prof.hbm_bytes_per_step:.4g} B a dense step "
        f"({time.perf_counter() - t0:.1f} s)")
    res["profile"] = {"t_step_dense": prof.t_step_dense,
                      "t_step_lags": prof.t_step_lags,
                      "n_workers": prof.n_workers,
                      "flops_per_step": prof.flops_per_step,
                      "hbm_bytes_per_step": prof.hbm_bytes_per_step}
    del state, prof
    torch.cuda.empty_cache()
    return counts, res, errs


STREAM_STEPS, STREAM_EVERY = 8, 2
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 128, 32
#: the handoff check's requests: batch, prompt and generated tokens
HANDOFF_BATCH, HANDOFF_PROMPT, HANDOFF_GEN = 2, 32, 4
#: its tolerance, |prefill->decode - replay| over max |replay| of each
#: step's logits: bf16 activations and caches round at other places
#: along the two paths (one 32-token product against 32 one-token ones,
#: through 22 layers); f32 ones only sum in another order.  On an H100,
#: TinyLlama's sound bf16 handoff reads at most 1.641e-2 and a cache one
#: slot off (``slot_fault``) at least 1.453e-1 on the steps it touches
HANDOFF_RTOL = {"bfloat16": 2e-2, "float32": 1e-4}
#: the MoE models' bf16 tolerance: a token near a tie between experts
#: can route differently along the two paths (``route_flips``).  On an
#: H100 at 700 W the sound handoff reads at most 2.493e-2 (Granite) and
#: 5.085e-2 (OLMoE), the planted fault at least 7.066e-2 and 9.759e-2
HANDOFF_RTOL_MOE = {"granite_moe_3b_a800m": 4e-2, "olmoe_1b_7b": 7e-2}
#: xLSTM-1.3B's bf16 tolerance: prefill runs each bf16 projection over
#: every prompt token at once and decode over one, and their rounding
#: differences carry through 48 recurrent layers (the prompt's own last
#: logits read the same gap).  On an H100 at 700 W the sound handoff reads
#: at most 3.778e-2, the planted fault at least 1.149 on its decode steps
HANDOFF_RTOL_XLSTM = 6e-2
#: LLaVA-NeXT-Mistral-7B's bf16 tolerance: decode's one-token
#: projections round apart from a prefill's batched ones by about one
#: bf16 ulp at the first layer (3.1e-3 of the hidden state's largest
#: entry), and the gap grows through the 32 layers to 2.8e-2 (f32 on the
#: same weights: 2.6e-6 to 1.0e-5 at every layer).  On an H100 at 700 W
#: the sound handoff reads at most 2.796e-2, the planted fault at least
#: 1.159
HANDOFF_RTOL_LLAVA = 6e-2
STREAM_SCRATCH = ROOT / ".stream_scratch"


def slot_fault(states):
    """A broken handoff, for the check to catch: every attention cache
    one slot off its decode layout (rolled one slot along time), every
    other state (the xLSTM's) dropped to zeros."""
    import torch
    if isinstance(states, torch.Tensor):
        return torch.zeros_like(states)
    if isinstance(states, (list, tuple)):
        return type(states)(slot_fault(x) for x in states)
    if "self" in states:
        return {**states, "self": {k: torch.roll(v, 1, dims=v.ndim - 3)
                                   for k, v in states["self"].items()}}
    return {k: slot_fault(v) for k, v in states.items()}


@contextlib.contextmanager
def routes_recorded(calls: list):
    """Inside the block, every MoE router call appends the expert sets it
    picked (``expert_idx`` sorted along k) to ``calls``."""
    import torch
    from repro_torch.models import moe
    route = moe._route

    def recording(p, xt, top_k):
        out = route(p, xt, top_k)
        calls.append(torch.sort(out[1], dim=-1).values)
        return out

    moe._route = recording
    try:
        yield
    finally:
        moe._route = route


def route_flips(handoff_calls: list, replay_calls: list, n_moe: int,
                prompt: int) -> int:
    """(token, layer) pairs whose expert set differs between the handoff
    (one prefill call per MoE layer over every prompt token, then one
    call per layer per decode step) and the token-by-token replay (one
    call per layer per position)."""
    flips = 0
    prefill, decode = handoff_calls[:n_moe], handoff_calls[n_moe:]
    for i, got in enumerate(replay_calls):
        pos, layer = divmod(i, n_moe)
        got = got.reshape(-1, got.shape[-1])
        if pos < prompt:
            want = prefill[layer].reshape(got.shape[0], prompt, -1)[:, pos]
        else:
            want = decode[(pos - prompt) * n_moe + layer].reshape(got.shape)
        flips += int((got != want).any(-1).sum())
    return flips


def cross_zeroed(states):
    """A broken encoder-decoder handoff, for the check to catch: every
    cross-attention cache zeroed (decode attends over no encoder)."""
    import torch
    return {part: [{**st, "cross": {k: torch.zeros_like(v)
                                    for k, v in st["cross"].items()}}
                   for st in sts]
            for part, sts in states.items()}


def handoff_check(dev, name: str, cfg, params, *, tag: str = "stream",
                  rtol: float | None = None, frontend=None,
                  faults: dict | None = None) -> dict:
    """Prefill -> ``pad_states_for_decode`` -> decode against a replay of
    the same tokens, on the card: the prompt's last logits and
    ``HANDOFF_GEN - 1`` decode steps' (the same known tokens fed to both
    paths) within ``HANDOFF_RTOL`` of max |logit| (the dtype's, or
    ``rtol``), finite.  The replay feeds the tokens one at a time from
    cold caches; with a frontend's embeddings (``frontend`` (B, N, D),
    fed to every prefill), which a token-by-token replay can neither
    feed nor put in the cross caches, the replay of decode step i is a
    prefill of the prompt and the i tokens fed so far, its last
    position's logits.  The same handoff with a planted fault must land
    outside that tolerance: every attention cache one slot off
    (``slot_fault``), or with a frontend a VLM's decode at positions that
    leave out its N patches, an encoder-decoder's cross caches zeroed
    (``cross_zeroed``).  For an MoE model, the (token, layer) pairs whose
    experts differ between the two paths are counted (``route_flips``).
    ``faults`` (name -> a function of the handed-off states) replaces
    that fault by these, each of which must land outside the tolerance.
    ``tag`` prefixes the printed line."""
    import torch
    from repro_torch import tree
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    toks = torch.randint(0, cfg.vocab,
                         (HANDOFF_BATCH, HANDOFF_PROMPT + HANDOFF_GEN),
                         generator=gen, device=dev, dtype=torch.int32)
    cap = HANDOFF_PROMPT + HANDOFF_GEN
    # the patches a VLM's prompt holds ahead of its tokens
    n_f = 0 if frontend is None or cfg.n_encoder_layers \
        else frontend.shape[1]
    fault_name = ("one slot off" if frontend is None else
                  "cross caches zeroed" if cfg.n_encoder_layers else
                  f"decode positions without the {n_f} patches")
    t0 = time.perf_counter()

    def handoff(fault: bool, plant=None) -> tuple[list, dict]:
        logits, st = engine.prefill(params, cfg, toks[:, :HANDOFF_PROMPT],
                                    frontend_embeds=frontend, chunk=64)
        st = engine.pad_states_for_decode(cfg, st, n_f + HANDOFF_PROMPT,
                                          n_f + cap)
        offset = n_f
        if fault and plant is not None:
            st = plant(st)
        elif fault and frontend is None:
            st = slot_fault(st)
        elif fault and cfg.n_encoder_layers:
            st = cross_zeroed(st)
        elif fault:
            offset = 0
        out = [logits]
        for pos in range(HANDOFF_PROMPT, cap - 1):
            logits, st = engine.serve_step(params, cfg, toks[:, pos:pos + 1],
                                           st, offset + pos, chunk=64)
            out.append(logits)
        return out, st

    n_moe = sum(s.ffn == "moe" for s in T.build_blockspecs(cfg))
    handoff_routes: list = []
    replay_routes: list = []
    with (routes_recorded(handoff_routes) if n_moe
          else contextlib.nullcontext()):
        sound, st = handoff(False)
    replay = []
    if frontend is not None:
        for pos in range(HANDOFF_PROMPT - 1, cap - 1):
            replay.append(engine.prefill(params, cfg, toks[:, :pos + 1],
                                         frontend_embeds=frontend,
                                         chunk=64)[0])
    else:
        rst = engine.init_states(cfg, HANDOFF_BATCH, cap,
                                 L.DTYPES[cfg.dtype], device=dev)
        with (routes_recorded(replay_routes) if n_moe
              else contextlib.nullcontext()):
            for pos in range(cap - 1):
                logits, rst = engine.serve_step(
                    params, cfg, toks[:, pos:pos + 1], rst, pos, chunk=64)
                if pos >= HANDOFF_PROMPT - 1:
                    replay.append(logits)
        del rst
    flips = (route_flips(handoff_routes, replay_routes, n_moe,
                         HANDOFF_PROMPT) if n_moe else None)
    del handoff_routes, replay_routes
    rtol = HANDOFF_RTOL[cfg.dtype] if rtol is None else rtol

    def rel_err(got) -> list:
        rel = []
        for i, (h, r) in enumerate(zip(got, replay)):
            if not (torch.isfinite(h).all() and torch.isfinite(r).all()):
                raise AssertionError(f"handoff {name}: step {i} not finite")
            rel.append(float((h - r).abs().max() / r.abs().max()))
        return rel

    rel = rel_err(sound)
    if max(rel) > rtol:
        raise AssertionError(f"handoff {name}: logits differ from the "
                             f"replay by {rel} of max |logit| (> {rtol})")
    planted = {}
    for fname, plant in (faults or {fault_name: None}).items():
        fault = rel_err(handoff(True, plant)[0])
        if max(fault) <= rtol:
            raise AssertionError(f"handoff {name}: the planted fault "
                                 f"({fname}) reads {fault} of max |logit|, "
                                 f"inside the tolerance {rtol}: the check "
                                 f"cannot see it")
        planted[fname] = fault
    out = {"rel_err": rel, "faults": planted, "rtol": rtol,
           "s": time.perf_counter() - t0,
           "cache": [tuple(x.shape) for x in tree.leaves(st)][:2]}
    del st
    routed = ""
    if n_moe:
        pairs = HANDOFF_BATCH * (cap - 1) * n_moe
        out["route_flips"] = [flips, pairs]
        routed = (f"; experts differ between the paths on {flips} of "
                  f"{pairs} (token, layer) pairs")
    front = "" if frontend is None else \
        f", {frontend.shape[1]} frontend embeddings, replayed by prefills"
    print(f"{tag}: handoff {name} ({cfg.dtype}, prompt {HANDOFF_PROMPT}"
          f"{front}, then {HANDOFF_GEN - 1} decode steps, batch "
          f"{HANDOFF_BATCH}): |prefill->decode - replay| / max|logit| per "
          f"step {[f'{x:.3e}' for x in rel]} (tolerance {rtol}); "
          + "; ".join(f"{k} {[f'{x:.3e}' for x in v]}"
                      for k, v in planted.items())
          + f"; states {out['cache']}{routed}", flush=True)
    return out


def aten_ops(fn) -> int:
    """The aten ops ``fn()`` dispatches: each is at least one launch
    from the host."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def decode_op_count(sub, prompts) -> int:
    """The aten ops one ``serve_step`` of ``sub``'s model dispatches at
    ``prompts``' batch and a ``SERVE_PROMPT + SERVE_GEN`` cache."""
    from repro_torch.models import layers as L
    from repro_torch.serving import engine
    states = engine.init_states(sub.cfg, prompts.shape[0],
                                SERVE_PROMPT + SERVE_GEN,
                                L.DTYPES[sub.cfg.dtype], device=prompts.device)
    return aten_ops(lambda: engine.serve_step(
        sub.params, sub.cfg, prompts[:, :1], states, SERVE_PROMPT,
        chunk=sub.chunk))


def stream_timings(dev, acc, k_b: int, block_size: int = 4096) -> dict:
    """``block_topk`` at the stream's per-block budget on the largest
    leaf's first-delta accumulator (f32, as the codec selects it):
    kernel (CUDA events over back-to-back launches of ~1 ms: device
    bound), its plain version and
    ``torch.topk`` on |rows|, beside the byte bound (rows read once, the
    (values, idx) pairs written once); the kernel's outputs bitwise to the
    plain version's; and how many rows hold an exact tie at their k_b-th
    magnitude."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.block_topk import RADIX_MIN_K, block_topk
    d = acc.numel()
    n_blocks = -(-d // block_size)
    rows = ops.block_view(acc, n_blocks, block_size).contiguous()
    n = rows.shape[0]
    err = assert_bitwise(f"stream block_topk {n}x{block_size} k_b={k_b}",
                         block_topk(rows, k_b), ref.block_topk_ref(rows,
                                                                      k_b))
    mag = rows.abs()
    top = torch.topk(mag, k_b + 1, dim=1).values
    tie_rows = int((top[:, k_b - 1] == top[:, k_b]).sum())
    ms = cuda_ms(lambda: block_topk(rows, k_b), 20)
    plain_ms = cuda_ms(lambda: ref.block_topk_ref(rows, k_b), 3)
    library_ms = cuda_ms(lambda: torch.topk(mag, k_b, dim=1), 10)
    nbytes = n * block_size * 4 + n * k_b * 8
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    path = "radix" if k_b >= RADIX_MIN_K else "arg-max"
    out = {"rows": n, "bs": block_size, "k_b": k_b, "path": path,
           "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "share": bound_ms / ms, "tie_rows": tie_rows,
           "max_abs_err": err}
    print(f"stream: block_topk at the stream's k_b {k_b} ({path} path) on "
          f"the largest leaf, {n} x {block_size} f32: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, torch.topk "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes), "
          f"{bound_ms / ms:.3f} of the bound; {tie_rows} rows tie at their "
          f"k_b-th |acc|; bitwise equal to the plain version", flush=True)
    return out


def stream_phase(dev, cfg, seq: int) -> tuple[dict, dict]:
    """The weight stream and the serving path at full width, over the
    world-size-1 NCCL group (inside ``process_group``).

    Train and publish: ``Session.run`` of ``STREAM_STEPS`` ``lags_dp`` +
    kernel steps with a ``StreamPublisher(every=STREAM_EVERY,
    compressor="topk_block_kernel")`` writing packets to the git-ignored
    ``.stream_scratch/``, then a flush; every ``block_topk`` launch of the
    first delta held bitwise to its plain version, and that delta encoded
    again under ``topk_hier_ef_kernel`` with every launch held the same
    way.  Follow: a cold ``ServeSession`` guarded by a ``RolloutGuard``
    applies every packet file; after the flush its parameters equal the
    trained ones bit for bit.  Serve: two requests of ``SERVE_BATCH``
    prompts of ``SERVE_PROMPT`` tokens, ``SERVE_GEN`` generated, from the
    streamed weights (their ``RequestRecord``s).  A dropped version is
    refused and ``resync`` recovers.  Then ``block_topk``'s timing at the
    stream's k_b (``stream_timings``, outside the counted window) and the
    handoff check on TinyLlama, gemma3's smoke config and the paper LSTM.
    Returns (launch counts of the phase, results)."""
    import shutil

    import torch
    from repro_torch import api, kernels, tree
    from repro_torch.configs import gemma3_27b, paper_lstm_ptb
    from repro_torch.configs.base import InputShape
    from repro_torch.data import synthetic
    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as T
    from repro_torch.stream import (DeltaCodec, RolloutGuard, ServeSession,
                                    StreamPublisher, quality_probe)

    def say(msg: str) -> None:
        print(f"stream: {msg}", flush=True)

    shutil.rmtree(STREAM_SCRATCH, ignore_errors=True)
    STREAM_SCRATCH.mkdir(parents=True)
    res: dict = {}
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        mesh = M.make_mesh(device=dev.type)
        sess = api.Session(cfg, api.RunConfig(
            mode="lags_dp", selection_backend="kernel", lr=0.01),
            mesh=mesh)
        state, _ = sess.init_state(seed=0)
        data = synthetic.MarkovLM(vocab=cfg.vocab, seed=5)
        pub = StreamPublisher(state["params"], every=STREAM_EVERY,
                              compressor="topk_block_kernel",
                              out_dir=str(STREAM_SCRATCH))
        codec = pub.codec
        say(f"codec {codec.compressor.name}, {len(codec.keys)} leaves, "
            f"full_bytes {codec.full_bytes}, budget {pub.budget_bytes} "
            f"bytes per packet")
        encode_s: list = []

        def timed(fn):
            def call(*args, **kw):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize(dev)
                encode_s.append(time.perf_counter() - t0)
                return out
            return call

        codec.encode = timed(codec.encode)
        codec.encode_full = timed(codec.encode_full)
        errs: dict = {}
        shapes: dict = {}
        largest = max(codec.keys, key=lambda k: codec.sizes[k])
        first: dict = {}
        check_counts: dict = {}

        class Watched:
            """The publisher as ``Session.run`` sees it; its first delta
            runs with every kernel launch held to the plain version."""

            def maybe_publish(self, step, params):
                if not pub.due(step):
                    return None
                if pub.version != 1:
                    return pub.publish(step, params)
                first["plan"] = pub.split_budget()
                ks = {e.key: e.k for e in first["plan"]}
                now = dict(zip(tree.leaf_paths(params),
                               tree.leaves(params)))[largest]
                was = dict(zip(tree.leaf_paths(pub.published),
                               tree.leaves(pub.published)))[largest]
                first["acc"] = pub.residual[largest] + (
                    now.detach().float().reshape(-1)
                    - was.float().reshape(-1))
                hier = DeltaCodec(params, compressor="topk_hier_ef_kernel")
                hier_errs: dict = {}
                hier_shapes: dict = {}
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                # a check only: the publisher never takes this path
                with aside(check_counts), held_to_plain(hier_errs,
                                                        hier_shapes):
                    _, _, n_hier, _ = hier.encode(pub.published, params,
                                                  hier.zero_residual(), ks)
                torch.cuda.synchronize(dev)
                first["hier"] = {"nbytes": n_hier,
                                 "s_held": time.perf_counter() - t0,
                                 "launches": {k: sorted(v) for k, v in
                                              hier_shapes.items()}}
                for name, e in hier_errs.items():
                    errs[name] = max(errs.get(name, 0.0), e)
                say(f"first delta again under topk_hier_ef_kernel: "
                    f"{n_hier} bytes, every launch bitwise to its plain "
                    f"version: {first['hier']['launches']}")
                if "ef_block_candidates" not in hier_shapes or \
                        "ef_select_pack" not in hier_shapes:
                    raise AssertionError("stream: the hierarchical re-encode "
                                         "launched no kernel")
                with held_to_plain(errs, shapes):
                    pkt = pub.publish(step, params)
                if "block_topk" not in shapes:
                    raise AssertionError("stream: the first delta launched "
                                         "no block_topk")
                say(f"first delta: every block_topk launch bitwise to its "
                    f"plain version: (rows, bs, k_b) "
                    f"{sorted(shapes['block_topk'])}")
                return pkt

        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        state, hist = sess.run(lambda t: data.batch(t, 1, seq, device=dev),
                               STREAM_STEPS, state=state, publisher=Watched(),
                               print_fn=lambda *_: None)
        pub.flush(STREAM_STEPS, state["params"])
        train_s = time.perf_counter() - t0
        losses = [r["loss"] for r in hist]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"stream: losses {losses}")
        say(f"{STREAM_STEPS} steps + {pub.n_publishes} packets in "
            f"{train_s:.2f} s; losses {[round(x, 4) for x in losses]}")
        plan = [{"key": e.key, "d": e.d, "k": e.k,
                 "k_b": block_kb(e.d, e.k), "kind": e.kind,
                 "nbytes": e.nbytes} for e in first["plan"]]
        for e in plan:
            say(f"plan {e['key']}: d {e['d']}, k {e['k']}, k_b {e['k_b']}, "
                f"{e['kind']}, {e['nbytes']} bytes")
        if len(encode_s) != len(pub.packets):
            raise AssertionError(f"stream: {len(encode_s)} encode times for "
                                 f"{len(pub.packets)} packets")
        packets = [{"version": p.version, "step": p.step, "kind": p.kind,
                    "nbytes": p.nbytes, "of_full": p.nbytes / codec.full_bytes,
                    "encode_s": s} for p, s in zip(pub.packets, encode_s)]
        over = [p for p in packets
                if p["kind"] == "delta" and p["of_full"] > 0.25]
        if over:
            raise AssertionError(f"stream: delta packets above 0.25 of "
                                 f"full_bytes: {over}")
        for p in packets:
            say(f"packet v{p['version']} (step {p['step']}, {p['kind']}): "
                f"{p['nbytes']} bytes = {p['of_full']:.4f} of full_bytes "
                f"{codec.full_bytes}; encode {p['encode_s']:.4f} s"
                + (" (its block_topk launches held to plain)"
                   if p["version"] == 2 else ""))
        say(f"streamed {pub.bytes_streamed} bytes against "
            f"{pub.bytes_full_equiv} in full checkpoints "
            f"({pub.bytes_streamed / pub.bytes_full_equiv:.4f})")
        res.update(losses=losses, train_s=train_s, plan=plan,
                   packets=packets, full_bytes=codec.full_bytes,
                   first_hier=first["hier"])

        # follow: a cold guarded subscriber, from the files alone
        shape = InputShape("serve", SERVE_PROMPT + SERVE_GEN, SERVE_BATCH,
                           "decode")
        heldout = data.batch(10_000, 2, 256, device=dev)
        guard = RolloutGuard(quality_probe(cfg, heldout, chunk=256,
                                           loss_chunk=256))
        sub = ServeSession(cfg, shape, tree.map(
            lambda p: torch.zeros(p.shape, dtype=p.dtype, device=p.device),
            state["params"]), guard=guard)
        t0 = time.perf_counter()
        applied = []
        for path in pub.packet_paths:
            t1 = time.perf_counter()
            status = sub.apply_packet_file(path)
            applied.append((status, time.perf_counter() - t1))
            if status != "applied":
                raise AssertionError(f"stream: {path} {status}")
        same = all(torch.equal(a, b) for a, b in zip(
            tree.leaves(sub.params), tree.leaves(state["params"])))
        if not same or sub.version != pub.version:
            raise AssertionError("stream: the subscriber is not bitwise the "
                                 "trained parameters after the flush")
        nll = [round(s.t_step, 4) for s in guard.samples]
        say(f"follow: {len(applied)} packet files applied through the guard "
            f"in {time.perf_counter() - t0:.2f} s "
            f"({[round(t, 3) for _, t in applied]} s each), version "
            f"{sub.version}, held-out NLL per version {nll}, guard halted "
            f"{guard.halted}; parameters bitwise equal to the trained ones")
        res["follow"] = {"apply_s": [t for _, t in applied], "nll": nll,
                         "bitwise": same}

        # serve from the streamed weights
        prompts = data.batch(20_000, SERVE_BATCH, SERVE_PROMPT,
                             device=dev)["tokens"]
        records = []
        for _ in range(2):
            out = sub.generate(prompts, SERVE_GEN)
            if tuple(out.shape) != (SERVE_BATCH, SERVE_GEN) or \
                    int(out.min()) < 0 or int(out.max()) >= cfg.vocab:
                raise AssertionError(f"stream: generated {tuple(out.shape)}")
            rec = dataclasses.asdict(sub.requests[-1])
            records.append(rec)
            say(f"request {rec['index']}: batch {rec['batch']}, prompt "
                f"{rec['prompt_len']}, {rec['n_tokens']} tokens: prefill "
                f"{rec['prefill_s']:.4f} s, decode {rec['decode_s']:.4f} s "
                f"= {rec['decode_tok_s']:.1f} tok/s, version "
                f"{rec['version']}, cache {rec['cache']}, prefill "
                f"{rec['prefill_jit']}, decode {rec['decode_jit']}")
        if [r["decode_jit"] for r in records] != ["miss", "hit"]:
            raise AssertionError("stream: the step cache did not hit")
        res["requests"] = records
        res["decode_ops"] = decode_op_count(sub, prompts)
        say(f"one decode step (batch {SERVE_BATCH}, cache "
            f"{SERVE_PROMPT + SERVE_GEN}) dispatches {res['decode_ops']} "
            f"aten ops ({res['decode_ops'] / cfg.n_layers:.0f} a layer)")

        # a dropped version is refused; resync recovers
        status = sub.apply_packet_file(pub.packet_paths[2])
        if status != "gap" or not sub.needs_resync:
            raise AssertionError(f"stream: a dropped version gave {status}")
        t0 = time.perf_counter()
        version = sub.resync(pub.save_full(str(STREAM_SCRATCH / "full"),
                                           step=STREAM_STEPS))
        same = all(torch.equal(a, b) for a, b in zip(
            tree.leaves(sub.params), tree.leaves(state["params"])))
        if not same or version != pub.version or sub.needs_resync:
            raise AssertionError("stream: resync did not recover")
        say(f"a dropped version refused ({status}); save_full + resync to "
            f"version {version} in {time.perf_counter() - t0:.2f} s, "
            f"bitwise equal")
        counts = kernels.launch_counts()
        res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        res["check_launches"] = check_counts
        say(f"launches in the phase: {counts} (training: ef_select_pack; "
            f"the publisher: block_topk); the topk_hier_ef_kernel "
            f"re-encode's, not among them: {check_counts}; peak device "
            f"memory {res['peak_gib']:.3f} GiB")
        for name in ("ef_select_pack", "block_topk"):
            if not counts[name]:
                raise AssertionError(f"stream: {name} never launched")

        # outside the counted window
        k_b = block_kb(codec.sizes[largest],
                       {e["key"]: e["k"] for e in plan}[largest])
        res["block_topk"] = stream_timings(dev, first.pop("acc"), k_b)
        res["block_topk"]["leaf"] = largest
        res["handoff"] = {"tinyllama_1_1b": handoff_check(
            dev, "tinyllama_1_1b", cfg, sub.params)}
        # the same weights in f32: the handoff itself exact to the sums
        f32 = dataclasses.replace(cfg, dtype="float32",
                                  param_dtype="float32")
        params = tree.map(lambda p: p.detach().float(), sub.params)
        del sub, guard, pub, codec, state, sess
        torch.cuda.empty_cache()
        res["handoff"]["tinyllama_1_1b f32"] = handoff_check(
            dev, "tinyllama_1_1b f32", f32, params)
        del params
        for name, small in (("gemma3_27b smoke", gemma3_27b.smoke_config()),
                            ("paper_lstm_ptb", paper_lstm_ptb.CONFIG)):
            params = T.init_params(small, seed=0, device=dev)
            res["handoff"][name] = handoff_check(dev, name, small, params)
            del params
        res["errs"] = errs
        return counts, res
    finally:
        shutil.rmtree(STREAM_SCRATCH, ignore_errors=True)


#: the MoE phase: Granite-3.0-MoE-3B trains in the distributed step at
#: world size 1 (lags_dp + kernel, off and its wave twin, the health
#: plane on for Eq. 20's delta per leaf)
#: the large models' distributed rows (the moe and xlstm phases): lags_dp
#: + kernel off and its wave twin, the health plane's δ on
LARGE_DIST = {k: {**DIST_CONFIGS[k], "health_every": 1}
              for k in ("lags_dp/kernel", "lags_dp/kernel/wave")}


def check_falls(label: str, rows: dict) -> None:
    """Every run of a distributed phase: its last loss below its first."""
    for name, row in rows.items():
        losses = [r["loss"] for r in row["steps"]]
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{label} {name}: losses {losses} do not "
                                 f"fall")


def expert_pack_timing(dev, cfg, chunk: int = 1 << 15) -> dict:
    """``ef_select_pack`` on one expert stack of ``cfg`` as the step
    launches it: the (layers, E, d, F) leaf's rows of 4096, f32 updates
    (the step scales the gradient into f32) and f32 residuals, lr 1, at
    the k_b of the config's ratio; beside its byte bound (rows read
    twice over: updates and residuals; the residual written; the (value,
    index) pairs written), ``torch.topk`` on |e + u| and the plain
    version, which runs (and is timed) chunk by chunk of ``chunk`` rows
    so that its sort fits beside the inputs; the outputs bitwise to the
    plain version's."""
    import torch
    from repro_torch.kernels import ef_sparsify, ref
    from repro_torch.kernels.block_topk import RADIX_MIN_K
    bs = 4096
    d = cfg.n_layers * cfg.n_experts * cfg.d_model * cfg.d_ff
    n = -(-d // bs)
    k_b = block_kb(d, max(1, round(d / cfg.compression_ratio)), bs)
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    u = 1e-3 * torch.randn((n, bs), generator=gen, device=dev)
    e = 1e-4 * torch.randn((n, bs), generator=gen, device=dev)

    def plain(lo: int, hi: int):
        return ref.ef_select_pack_ref(u[lo:hi], e[lo:hi], 1.0, None, k_b)

    got = ef_sparsify.ef_select_pack(u, e, 1.0, None, k_b)
    err = 0.0
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        err = max(err, assert_bitwise(
            f"moe ef_select_pack {n}x{bs} k_b={k_b} [{lo}:{hi}]",
            tuple(o[lo:hi] for o in got), plain(lo, hi)))
    del got
    ms = cuda_ms(lambda: ef_sparsify.ef_select_pack(u, e, 1.0, None, k_b), 10)

    def plain_all() -> None:
        for lo in range(0, n, chunk):
            plain(lo, min(n, lo + chunk))

    plain_ms = cuda_ms(plain_all, 2)
    mag = (e + u).abs()
    library_ms = cuda_ms(lambda: torch.topk(mag, k_b, dim=1), 5)
    del mag, u, e
    torch.cuda.empty_cache()
    nbytes = n * bs * 12 + n * k_b * 8
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    out = {"rows": n, "bs": bs, "k_b": k_b, "dtypes": "f32 u, f32 e",
           "path": "radix" if k_b >= RADIX_MIN_K else "arg-max",
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": "bytes",
           "share": bound_ms / ms, "max_abs_err": err}
    print(f"moe: ef_select_pack on one expert stack ({cfg.n_layers} x "
          f"{cfg.n_experts} x {cfg.d_model} x {cfg.d_ff}), {n} x {bs} f32 "
          f"u and e, k_b {k_b} ({out['path']} path): kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, torch.topk {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms (bytes), {bound_ms / ms:.3f} of the bound; "
          f"bitwise equal to the plain version", flush=True)
    return out


def serve_full(dev, tag: str, name: str, cfg, params, n_requests: int, *,
               rtol: float, faults: dict | None = None, f32: bool = True,
               prompts=None) -> dict:
    """Serve ``params`` at full width: ``n_requests`` requests of
    ``SERVE_BATCH`` prompts of ``SERVE_PROMPT`` tokens, ``SERVE_GEN``
    generated (their ``RequestRecord``s), the aten ops of one decode
    step, then the handoff check (``handoff_check``) in the config's
    bf16 (within ``rtol``) and, with ``f32``, in f32 on the same
    weights, each with its planted fault (or ``faults``); the peak
    device memory of the requests.  ``prompts``: the requests' tokens
    (default ``MarkovLM``'s, whose dense transition matrix a vocab of
    Jamba's size cannot hold: 16 GiB).  ``tag`` prefixes the printed
    lines."""
    import torch
    from repro_torch import tree
    from repro_torch.configs.base import InputShape
    from repro_torch.data import synthetic
    from repro_torch.stream import ServeSession
    shape = InputShape("serve", SERVE_PROMPT + SERVE_GEN, SERVE_BATCH,
                       "decode")
    sub = ServeSession(cfg, shape, params)
    if prompts is None:
        prompts = synthetic.MarkovLM(vocab=cfg.vocab, seed=7).batch(
            20_000, SERVE_BATCH, SERVE_PROMPT, device=dev)["tokens"]
    torch.cuda.reset_peak_memory_stats(dev)
    records = []
    for _ in range(n_requests):
        out = sub.generate(prompts, SERVE_GEN)
        if tuple(out.shape) != (SERVE_BATCH, SERVE_GEN) or \
                int(out.min()) < 0 or int(out.max()) >= cfg.vocab:
            raise AssertionError(f"{tag} {name}: generated "
                                 f"{tuple(out.shape)}")
        rec = dataclasses.asdict(sub.requests[-1])
        records.append(rec)
        print(f"{tag}: {name} request {rec['index']}: batch {rec['batch']}, "
              f"prompt {rec['prompt_len']}, {rec['n_tokens']} tokens: "
              f"prefill {rec['prefill_s']:.4f} s, decode "
              f"{rec['decode_s']:.4f} s = {rec['decode_tok_s']:.1f} tok/s, "
              f"cache {rec['cache']}", flush=True)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    ops = decode_op_count(sub, prompts)
    print(f"{tag}: {name} one decode step (batch {SERVE_BATCH}, cache "
          f"{SERVE_PROMPT + SERVE_GEN}) dispatches {ops} aten ops "
          f"({ops / cfg.n_layers:.0f} a layer); peak device memory of the "
          f"requests {peak:.3f} GiB", flush=True)
    del sub
    handoff = {cfg.dtype: handoff_check(dev, name, cfg, params, tag=tag,
                                        rtol=rtol, faults=faults)}
    if f32:
        cfg32 = dataclasses.replace(cfg, dtype="float32",
                                    param_dtype="float32")
        p32 = tree.map(lambda p: p.float(), params)
        handoff["float32"] = handoff_check(dev, f"{name} f32", cfg32, p32,
                                           tag=tag, faults=faults)
        del p32
    torch.cuda.empty_cache()
    return {"requests": records, "decode_ops": ops, "peak_gib": peak,
            "handoff": handoff}


def moe_phase(dev, seq: int, steps: int) -> tuple[dict, dict, dict]:
    """The MoE family at full width, over the world-size-1 NCCL group
    (inside ``process_group``).  Granite-3.0-MoE-3B (32 layers, 40
    experts top 8, seeded random weights) trains ``steps`` distributed
    ``lags_dp`` + kernel steps on one ``seq``-token ``MarkovLM`` sequence
    under ``off`` and ``wave`` (``MOE_DIST``): step 0 of ``off`` with
    every ``ef_select_pack`` launch held to its plain version inside the
    step, ``wave``'s step 0 bitwise to it; then, outside the counted
    window, ``ef_select_pack`` timed on one expert stack; then the
    trained weights (residuals and gradients freed) serve two requests,
    and OLMoE-1B-7B (16 layers, 64 experts top 8, seeded random weights)
    one.  Returns (launch counts of the training, results, each kernel's
    largest absolute error against its plain version)."""
    import torch
    from repro_torch.configs import granite_moe_3b_a800m, olmoe_1b_7b
    from repro_torch.models import transformer as T
    res: dict = {}
    kept: dict = {}
    torch.cuda.empty_cache()
    granite = granite_moe_3b_a800m.CONFIG
    print(f"moe: {granite.name}: {granite.param_count()} parameters, "
          f"{granite.active_param_count()} active per token", flush=True)
    totals, res["train"], errs = distributed(
        dev, granite, seq, steps, plans={}, configs=LARGE_DIST,
        name="granite-moe ", step0="launches", keep=kept)
    params = kept.pop("params")
    torch.cuda.empty_cache()
    res["pack"] = expert_pack_timing(dev, granite)
    errs["ef_select_pack"] = max(errs.get("ef_select_pack", 0.0),
                                 res["pack"]["max_abs_err"])
    res["granite"] = serve_full(dev, "moe", "granite_moe_3b_a800m", granite,
                                params, 2,
                                rtol=HANDOFF_RTOL_MOE["granite_moe_3b_a800m"])
    del params
    torch.cuda.empty_cache()
    olmoe = olmoe_1b_7b.CONFIG
    print(f"moe: {olmoe.name}: {olmoe.param_count()} parameters, "
          f"{olmoe.active_param_count()} active per token", flush=True)
    params = T.init_params(olmoe, seed=0, device=dev)
    res["olmoe"] = serve_full(dev, "moe", "olmoe_1b_7b", olmoe, params, 1,
                              rtol=HANDOFF_RTOL_MOE["olmoe_1b_7b"])
    del params
    torch.cuda.empty_cache()
    return totals, res, errs


#: xLSTM-1.3B's training sequence, the longest of 1024, 512 and 256 whose
#: step peaks under ~70 GiB (``PERF.md`` §4): the parameters, gradients,
#: EF residual and the exchange's f32 copies peak at ~50 GiB, and the
#: recompute of one period keeps ~0.1 GiB at 1024 tokens (the mLSTM's
#: chunkwise form holds (B, H, S, S) weights, not a C a token)
XLSTM_SEQ = 1024
#: steps per configuration: two show the loss fall, and the sLSTM's time
#: loop makes each ~24–42 s at 48 layers (``PERF.md`` §5)
XLSTM_STEPS = 2
#: its depth, cut from 48 for the single-card run's time limit: at 48 the
#: phase took ~4 min, and the whole run once 1176.5 s of the 1200 on an
#: H100 at 700 W (its time loops scale with the depth)
XLSTM_LAYERS = 12


def xlstm_phase(dev, seq: int, steps: int) -> tuple[dict, dict, dict]:
    """The xLSTM family at full width, over the world-size-1 NCCL group
    (inside ``process_group``).  xLSTM-1.3B (cut to ``XLSTM_LAYERS`` of
    its 48 layers alternating mLSTM and sLSTM, d 2048, 4 heads, vocab
    50304, untied, bf16, seeded random weights) trains ``steps`` distributed ``lags_dp`` + kernel
    steps on one ``seq``-token ``MarkovLM`` sequence under ``off`` and
    ``wave`` (``LARGE_DIST``; each period recomputed in the backward,
    the training default): step 0 of ``off`` with every
    ``ef_select_pack`` launch held to its plain version inside the
    step, ``wave``'s step 0 bitwise to it; then the trained weights
    (residuals and gradients freed) serve two requests, with the
    handoff checked in bf16 and f32.  Returns (launch counts of the
    training, results, each kernel's largest absolute error against its
    plain version)."""
    import torch
    from repro_torch.configs import xlstm_1_3b
    res: dict = {}
    kept: dict = {}
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(xlstm_1_3b.CONFIG, n_layers=XLSTM_LAYERS)
    print(f"xlstm: {cfg.name}: {cfg.param_count()} parameters, "
          f"{cfg.n_layers} layers {cfg.xlstm_pattern}, d {cfg.d_model}, "
          f"{cfg.param_dtype}, {seq} tokens a step", flush=True)
    totals, res["train"], errs = distributed(
        dev, cfg, seq, steps, plans={}, configs=LARGE_DIST, name="xlstm ",
        step0="launches", keep=kept)
    check_falls("xlstm", res["train"])
    params = kept.pop("params")
    torch.cuda.empty_cache()
    res["serve"] = serve_full(dev, "xlstm", "xlstm_1_3b", cfg, params, 2,
                              rtol=HANDOFF_RTOL_XLSTM)
    del params
    torch.cuda.empty_cache()
    return totals, res, errs


#: the encoder-decoder's training: one sequence of ``ENCDEC_SEQ`` tokens
#: and its ``audio_frames`` (256) frames per worker, ``ENCDEC_STEPS``
#: steps per configuration
ENCDEC_SEQ, ENCDEC_STEPS = 1024, 3
#: the frames beside each serving prompt of SeamlessM4T:
#: ``audio_frames(1024)``, the training sequence's
ENCDEC_FRAMES = 256
#: LLaVA-NeXT's training depth, the deepest of 16 and 12 layers whose
#: step peaks under ~70 GiB (``PERF.md`` §4): at 16 bytes a parameter
#: (bf16 parameter and gradient, f32 residual, the exchange's f32 update
#: and new residual) all 32 layers would need 116 GB; 16 peak at 65.6
#: GiB (``off``) and 59.5 (``wave``) on an H100
LLAVA_TRAIN_LAYERS = 16
#: its training shape, ``train_4k``'s sequence: ``train_batch_specs``
#: gives 2048 patch embeddings and 2048 tokens
LLAVA_SEQ = 4096


def frontend_batch(cfg, seq: int, rows: int, dev, seed: int) -> dict:
    """A training batch of ``rows`` sequences at ``seq`` under
    ``launch/specs``: the frontend's embeddings from ``concrete_batch``
    (a standard normal in the config's dtype), tokens uniform in the
    vocab with the labels the next token (``lm_input_batch``; a vocab of
    SeamlessM4T's size is too large for ``MarkovLM``'s dense
    transition matrix)."""
    from repro_torch.configs.base import InputShape
    from repro_torch.data import synthetic
    from repro_torch.launch import specs as SP
    batch = SP.concrete_batch(cfg, InputShape("train", seq, rows, "train"),
                              seed=seed, device=dev)
    batch.update(synthetic.lm_input_batch(
        seed, rows, batch["tokens"].shape[1], cfg.vocab, device=dev))
    return batch


def check_delta(label: str, rows: dict) -> float:
    """Eq. 20's δ of every leaf in every step of a distributed run
    (``health_every``): finite and at most 1.  Returns the largest."""
    worst = 0.0
    for name, row in rows.items():
        for r in row["steps"]:
            for leaf, x in r["delta"].items():
                if not (math.isfinite(x) and x <= 1.0):
                    raise AssertionError(f"{label} {name} step {r['step']}: "
                                         f"delta {x} on {leaf}")
                worst = max(worst, x)
    print(f"{label}: Eq. 20 delta <= {worst:.4f} on every leaf in every "
          f"step (Fig. 2: delta <= 1)", flush=True)
    return worst


def serve_frontend(dev, tag: str, name: str, cfg, params, n_requests: int, *,
                   n_front: int, rtol: float | None = None) -> dict:
    """Serve ``params`` at full width through ``launch/serve``'s steps
    (``make_prefill_step``, then ``pad_states_for_decode``, then
    ``make_serve_step``'s decode; ``ServeSession.generate`` takes tokens
    only, as the reference's does): ``n_requests`` requests of
    ``SERVE_BATCH`` prompts of ``SERVE_PROMPT`` tokens beside ``n_front``
    frontend embeddings each, ``SERVE_GEN`` tokens generated greedily;
    prefill s, decode tok/s, the aten ops of one decode step and the
    requests' peak device memory; then ``handoff_check`` with the
    frontend in the config's bf16 (within ``rtol``) and in f32 on the
    same weights, each with its planted fault."""
    import torch
    from repro_torch import tree
    from repro_torch.configs.base import InputShape
    from repro_torch.data import synthetic
    from repro_torch.launch import serve as SV
    from repro_torch.models import layers as L
    from repro_torch.serving import engine
    n_f = 0 if cfg.n_encoder_layers else n_front
    prompt = n_f + SERVE_PROMPT
    cap = prompt + SERVE_GEN
    prefill, _ = SV.make_prefill_step(
        cfg, None, InputShape("serve", prompt, SERVE_BATCH, "prefill"))
    step, _ = SV.make_serve_step(
        cfg, None, InputShape("serve", cap, SERVE_BATCH, "decode"))
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    batch = {"tokens": synthetic.lm_input_batch(
                 7, SERVE_BATCH, SERVE_PROMPT, cfg.vocab,
                 device=dev)["tokens"].to(torch.int32),
             "frontend_embeds": torch.randn(
                 (SERVE_BATCH, n_front, cfg.d_model), generator=gen,
                 device=dev).to(L.DTYPES[cfg.dtype])}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    records = []
    for i in range(n_requests):
        t0 = time.perf_counter()
        logits, states = prefill(params, batch)
        states = engine.pad_states_for_decode(cfg, states, prompt, cap)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        out = []
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        for j in range(SERVE_GEN):
            out.append(tok)
            logits, states = step(params, tok, states, prompt + j)
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        tokens = torch.cat(out, dim=1)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t1
        if tuple(tokens.shape) != (SERVE_BATCH, SERVE_GEN) or \
                int(tokens.min()) < 0 or int(tokens.max()) >= cfg.vocab or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{tag} {name}: generated "
                                 f"{tuple(tokens.shape)}")
        rec = {"index": i, "batch": SERVE_BATCH, "prompt_len": SERVE_PROMPT,
               "frontend": n_front, "n_tokens": SERVE_GEN,
               "prefill_s": prefill_s, "decode_s": decode_s,
               "decode_tok_s": SERVE_BATCH * SERVE_GEN / decode_s}
        records.append(rec)
        print(f"{tag}: {name} request {i}: batch {SERVE_BATCH}, prompt "
              f"{SERVE_PROMPT} tokens + {n_front} frontend embeddings, "
              f"{SERVE_GEN} tokens: prefill {prefill_s:.4f} s, decode "
              f"{decode_s:.4f} s = {rec['decode_tok_s']:.1f} tok/s",
              flush=True)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    ops = aten_ops(lambda: step(params, tok, states, cap - 1))
    print(f"{tag}: {name} one decode step (batch {SERVE_BATCH}, cache "
          f"{cap}{', cross caches ' + str(n_front) if cfg.n_encoder_layers else ''}"
          f") dispatches {ops} aten ops ({ops / cfg.n_layers:.0f} a layer); "
          f"peak device memory of the requests {peak:.3f} GiB", flush=True)
    del states, logits, batch
    torch.cuda.empty_cache()
    front = torch.randn((HANDOFF_BATCH, n_front, cfg.d_model), generator=gen,
                        device=dev)
    handoff = {cfg.dtype: handoff_check(
        dev, name, cfg, params, tag=tag, rtol=rtol,
        frontend=front.to(L.DTYPES[cfg.dtype]))}
    f32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    p32 = tree.map(lambda p: p.float(), params)
    handoff["float32"] = handoff_check(dev, f"{name} f32", f32, p32, tag=tag,
                                       frontend=front)
    del p32, front
    torch.cuda.empty_cache()
    return {"requests": records, "decode_ops": ops, "peak_gib": peak,
            "handoff": handoff}


def add_run(totals: dict, errs: dict, run: tuple) -> dict:
    """Add a run's (launch counts, results, errors) into ``totals`` and
    ``errs``; return its results."""
    counts, res, run_errs = run
    for k, v in counts.items():
        totals[k] += v
    for k, v in run_errs.items():
        errs[k] = max(errs.get(k, 0.0), v)
    return res


def encdec_phase(dev) -> tuple[dict, dict, dict]:
    """Encoders and frontends at full width, over the world-size-1 NCCL
    group (inside ``process_group``): ``seamless_phase``, then
    ``llava_phase``.  Returns (launch counts of the training, results,
    each kernel's largest absolute error against its plain version)."""
    from repro_torch import kernels
    totals = dict.fromkeys(kernels.WRAPPERS, 0)
    errs: dict = {}
    res = add_run(totals, errs, seamless_phase(dev))
    res.update(add_run(totals, errs, llava_phase(dev)))
    return totals, res, errs


def seamless_phase(dev) -> tuple[dict, dict, dict]:
    """SeamlessM4T-Large-v2 (12 encoder and 12 decoder layers, d 1024,
    vocab 256,206, tied, layer norm, GELU, bf16, seeded random weights)
    trains ``ENCDEC_STEPS`` simulated steps
    (P = 2, ``lags_dp`` + kernel backend + ``topk_exact``, step 0 with
    every launch held to its plain version) and as many distributed
    ``lags_dp`` + kernel steps under ``off`` and ``wave``
    (``LARGE_DIST``: step 0 of ``off`` with every ``ef_select_pack``
    launch held to its plain version inside the step, ``wave``'s step 0
    bitwise to it), each worker on one ``ENCDEC_SEQ``-token sequence
    beside its frames; every run's losses fall and every leaf's δ is at
    most 1; the trained weights (residuals and gradients freed) serve two
    requests.  Returns (launch counts of the training, results, each
    kernel's largest absolute error against its plain version)."""
    import torch
    from repro_torch import api, kernels
    from repro_torch.configs import seamless_m4t_large_v2 as seamless_mod
    from repro_torch.launch import specs as SP
    from repro_torch.models import transformer as T
    res: dict = {}
    kept: dict = {}
    errs: dict = {}
    totals = dict.fromkeys(kernels.WRAPPERS, 0)
    torch.cuda.empty_cache()
    cfg = seamless_mod.CONFIG
    frames = SP.audio_frames(ENCDEC_SEQ)
    print(f"encdec: {cfg.name}: {cfg.param_count()} parameters, "
          f"{cfg.n_encoder_layers} encoder + {cfg.n_layers} decoder layers, "
          f"d {cfg.d_model}, vocab {cfg.vocab}, {cfg.param_dtype}; "
          f"{ENCDEC_SEQ} tokens and {frames} frames a sequence", flush=True)
    p = 2
    model = T.Transformer(cfg, seed=0, device=dev)
    trainer = api.Session(cfg, api.RunConfig(
        mode="lags_dp", compressor="topk_exact", selection_backend="kernel",
        lr=0.01), device=dev).simulator(
        lambda q, b: T.loss_fn(q, cfg, b, chunk=1024, loss_chunk=512),
        model.params, n_workers=p)
    whole = frontend_batch(cfg, ENCDEC_SEQ, p, dev, seed=3)
    batches = [{k: v.reshape(p, 1, *v.shape[1:]) for k, v in whole.items()}
               ] * ENCDEC_STEPS
    shapes: dict = {}
    counts, rows = sim_run(dev, "seamless sim P=2 lags_dp/topk_exact/kernel",
                           trainer, batches,
                           ("ef_block_candidates", "ef_select_pack"), errs,
                           shapes, tag="encdec")
    print(f"encdec: seamless sim step 0: every kernel launch == its plain "
          f"version, bitwise; (rows, bs, k) "
          f"{dict((k, sorted(v)) for k, v in shapes.items())}", flush=True)
    if not rows[-1]["loss"] < rows[0]["loss"]:
        raise AssertionError(f"encdec seamless sim: losses "
                             f"{[r['loss'] for r in rows]} do not fall")
    res["seamless_sim"] = {"workers": p, "steps": rows, "launches": counts}
    for k, v in counts.items():
        totals[k] += v
    del trainer, model, batches, whole
    torch.cuda.empty_cache()
    batch = frontend_batch(cfg, ENCDEC_SEQ, 1, dev, seed=3)
    res["seamless_train"] = add_run(totals, errs, distributed(
        dev, cfg, ENCDEC_SEQ, ENCDEC_STEPS, plans={}, configs=LARGE_DIST,
        name="seamless ", step0="launches", keep=kept, batch=batch))
    check_falls("encdec seamless", res["seamless_train"])
    res["seamless_delta"] = check_delta("encdec seamless",
                                        res["seamless_train"])
    params = kept.pop("params")
    del batch
    torch.cuda.empty_cache()
    res["seamless_serve"] = serve_frontend(
        dev, "encdec", "seamless_m4t_large_v2", cfg, params, 2,
        n_front=ENCDEC_FRAMES)
    del params
    torch.cuda.empty_cache()
    return totals, res, errs


def llava_phase(dev) -> tuple[dict, dict, dict]:
    """LLaVA-NeXT-Mistral-7B at its published width (d 4096, 32 heads,
    8 kv, d_ff 14336, vocab 32,000, untied, bf16, seeded random weights)
    trains ``ENCDEC_STEPS`` distributed ``lags_dp`` + kernel steps under
    ``off`` and ``wave`` (``LARGE_DIST``, checked as SeamlessM4T's) cut
    to ``LLAVA_TRAIN_LAYERS`` layers, on ``LLAVA_SEQ`` (2048 patches and
    2048 tokens), then serves two requests at full depth (2880 patches
    and 128 tokens a prompt).  Returns (launch counts of the training,
    results, each kernel's largest absolute error against its plain
    version)."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import llava_next_mistral_7b as llava_mod
    from repro_torch.models import transformer as T
    res: dict = {}
    errs: dict = {}
    totals = dict.fromkeys(kernels.WRAPPERS, 0)
    torch.cuda.empty_cache()
    full = llava_mod.CONFIG
    cut = dataclasses.replace(full, n_layers=LLAVA_TRAIN_LAYERS)
    batch = frontend_batch(cut, LLAVA_SEQ, 1, dev, seed=3)
    print(f"encdec: {full.name}: {full.param_count()} parameters; trains "
          f"at {cut.n_layers} of its {full.n_layers} layers "
          f"({cut.param_count()} parameters), d {full.d_model}, "
          f"{full.param_dtype}; {batch['frontend_embeds'].shape[1]} patches "
          f"and {batch['tokens'].shape[1]} tokens a sequence", flush=True)
    res["llava_train"] = add_run(totals, errs, distributed(
        dev, cut, LLAVA_SEQ, ENCDEC_STEPS, plans={}, configs=LARGE_DIST,
        name="llava ", step0="launches", batch=batch))
    check_falls("encdec llava", res["llava_train"])
    res["llava_delta"] = check_delta("encdec llava", res["llava_train"])
    del batch
    torch.cuda.empty_cache()
    params = T.init_params(full, seed=0, device=dev)
    res["llava_serve"] = serve_frontend(
        dev, "encdec", "llava_next_mistral_7b", full, params, 2,
        n_front=full.n_frontend_tokens, rtol=HANDOFF_RTOL_LLAVA)
    del params
    torch.cuda.empty_cache()
    return totals, res, errs


#: Jamba-v0.1's training depth: one ``attn_period`` (attention at layer
#: 4, 7 Mamba layers), the dense gated FFN in place of its 16 experts
#: (2,725,326,848 parameters; with its experts 8 layers hold
#: 13,295,235,072, which the exchange's ~16 bytes a parameter cannot
#: fit)
JAMBA_TRAIN_LAYERS = 8
#: its training sequence, the longest of 1024, 512 and 256 whose step
#: peaks under ~70 GiB: 1024 peaks at 46.8 GiB on an H100 (``PERF.md``
#: §4), most of it the exchange's f32 copies
JAMBA_SEQ = 1024
JAMBA_STEPS = 3
#: Jamba's serving depth: two periods (2 attention and 14 Mamba layers,
#: 8 MoE layers of 16 experts; 26,053,595,136 parameters, 48.5 GiB in
#: bf16); at 24 layers ~73 GiB would leave no room
JAMBA_SERVE_LAYERS = 16
#: Jamba's bf16 handoff tolerance at 16 layers: decode's one-token
#: projections round apart from prefill's batched ones, and 20 of 560
#: (token, layer) pairs route to other experts along the two paths.  On
#: an H100 at 700 W the sound handoff reads at most 3.624e-2, the SSM
#: states zeroed at most 1.804e-1 (their weaker fault: the states rebuild
#: within a few tokens), the conv tails zeroed at least 1.172; 8e-2 sits
#: 2.2x above the first and 2.25x below the second
HANDOFF_RTOL_JAMBA = 8e-2


def mamba_zeroed(part: str):
    """A broken hybrid handoff, for the check to catch: ``part``
    (``"ssm"`` or ``"conv"``) of every Mamba state zeroed, the attention
    caches sound."""
    import torch

    def plant(states):
        def fix(st):
            if isinstance(st, dict) and part in st:
                return {**st, part: torch.zeros_like(st[part])}
            return st
        return {k: [fix(st) for st in sts] for k, sts in states.items()}

    return plant


JAMBA_FAULTS = {"SSM states zeroed": mamba_zeroed("ssm"),
                "conv tails zeroed": mamba_zeroed("conv")}


def mamba_memory_check(dev, cfg, seq: int) -> dict:
    """What autograd keeps for Mamba layers at ``cfg``'s width (bf16,
    seeded random weights, one ``seq``-token sequence, each layer
    residual as in the model): the memory held after the forward of one
    and of two layers; the second layer must add less than one (1, seq,
    d_inner, d_state) f32 tensor, of which the reference's associative
    scan keeps ~2·log2(seq).  Also the backward's peak above the start,
    and the time of one layer's forward and backward beside the
    selective scan's alone (its f32 inputs at the same shape)."""
    import torch
    import torch.nn.functional as F_
    from repro_torch.models import layers as L
    from repro_torch.models import ssm
    d = cfg.d_model
    d_inner = ssm.EXPAND * d
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)

    def leaf(spec):
        shape, init = spec
        if isinstance(init, L.Values):
            w = init.fn().to(dev)
        elif isinstance(init, L.Full):
            w = torch.full(shape, init.value, device=dev)
        else:
            w = torch.randn(shape, generator=gen, device=dev) * init
        return w.to(torch.bfloat16).requires_grad_()

    specs, _ = ssm.mamba_specs(d)
    layers = [{k: leaf(v) for k, v in specs.items()} for _ in range(2)]
    x = torch.randn((1, seq, d), generator=gen, device=dev).to(
        torch.bfloat16).requires_grad_()
    held = {}
    for n in (1, 2):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        start = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        h = x
        for p in layers[:n]:
            h = h + ssm.mamba_forward(p, h)
        torch.cuda.synchronize()
        kept = torch.cuda.memory_allocated(dev) - start
        fwd_peak = torch.cuda.max_memory_allocated(dev) - start
        leaves = [x] + [w for p in layers[:n] for w in p.values()]
        grads = torch.autograd.grad(h.float().square().mean(), leaves)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - start
        if not all(bool(torch.isfinite(g).all()) for g in grads):
            raise AssertionError(f"jamba: {n} Mamba layers: gradients not "
                                 f"finite")
        held[n] = {"kept": kept, "forward_peak": fwd_peak, "peak": peak}
        del h, grads, leaves
    state_bytes = seq * d_inner * ssm.D_STATE * 4
    per_layer = held[2]["kept"] - held[1]["kept"]
    if not per_layer < state_bytes:
        raise AssertionError(f"jamba: a Mamba layer keeps {per_layer} bytes "
                             f"for its backward, not less than one (1, "
                             f"{seq}, {d_inner}, {ssm.D_STATE}) f32 state "
                             f"({state_bytes})")
    p = layers[0]
    xs = x.detach().clone().requires_grad_()

    def layer_fb() -> None:
        torch.autograd.grad(ssm.mamba_forward(p, xs).float().sum(),
                            [xs, *p.values()])

    args = [F_.softplus(torch.randn((1, seq, d_inner), generator=gen,
                                    device=dev) - 4.0),
            -torch.exp(ssm._a_log(d_inner).to(dev)),
            torch.randn((1, seq, ssm.D_STATE), generator=gen, device=dev),
            torch.randn((1, seq, ssm.D_STATE), generator=gen, device=dev),
            torch.randn((1, seq, d_inner), generator=gen, device=dev)]
    args = [a.requires_grad_() for a in args]

    def scan_fb() -> None:
        y, _ = ssm.selective_scan(*args)
        torch.autograd.grad(y.sum(), args)

    layer_ms = cuda_ms(layer_fb, 3)
    scan_ms = cuda_ms(scan_fb, 3)
    out = {"seq": seq, "d_inner": d_inner, "held": held,
           "per_layer_bytes": per_layer, "state_bytes": state_bytes,
           "layer_fwd_bwd_ms": layer_ms, "scan_fwd_bwd_ms": scan_ms}
    print(f"jamba: Mamba layers at d {d} (d_inner {d_inner}, d_state "
          f"{ssm.D_STATE}), {seq} bf16 tokens: kept after the forward "
          f"{held[1]['kept'] / 2**20:.1f} MiB (1 layer), "
          f"{held[2]['kept'] / 2**20:.1f} MiB (2 layers): "
          f"{per_layer / 2**20:.1f} MiB a layer, under one (1, S, d_inner, "
          f"d_state) f32 state of {state_bytes / 2**20:.1f} MiB; peak above "
          f"the start {held[1]['peak'] / 2**20:.1f} / "
          f"{held[2]['peak'] / 2**20:.1f} MiB (forward "
          f"{held[1]['forward_peak'] / 2**20:.1f} / "
          f"{held[2]['forward_peak'] / 2**20:.1f}); one layer's forward + "
          f"backward {layer_ms:.3f} ms, the selective scan's "
          f"{scan_ms:.3f} ms ({scan_ms / layer_ms:.3f} of it)", flush=True)
    del layers, x, xs, args, p
    torch.cuda.empty_cache()
    return out


def long_context_step(dev, cfg, params) -> dict:
    """One ``serve_step`` of ``launch/serve`` at ``long_500k``'s shape
    (batch 1, a full cache of 524,288 slots, the token at the last
    slot), twice (the second timed warm): logits finite, the states'
    bytes and the step's peak device memory above the weights."""
    import torch
    from repro_torch import tree
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.launch import serve as SV
    from repro_torch.models import layers as L
    from repro_torch.serving import engine
    shape = INPUT_SHAPES["long_500k"]
    step, _ = SV.make_serve_step(cfg, None, shape)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    start = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    states = engine.init_states(cfg, shape.global_batch, shape.seq_len,
                                L.DTYPES[cfg.dtype], device=dev)
    attn = sum(x.numel() * x.element_size()
               for st in states["blocks"] + states["tail"]
               if isinstance(st, dict) and "self" in st
               for x in tree.leaves(st))
    total = sum(x.numel() * x.element_size() for x in tree.leaves(states))
    tok = torch.zeros((shape.global_batch, 1), dtype=torch.int32, device=dev)
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        logits, states = step(params, tok, states, shape.seq_len - 1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if tuple(logits.shape) != (1, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"jamba long_500k: logits "
                             f"{tuple(logits.shape)} not finite")
    peak = torch.cuda.max_memory_allocated(dev) - start
    out = {"capacity": shape.seq_len, "step_s": times,
           "attn_cache_bytes": attn, "mamba_state_bytes": total - attn,
           "peak_above_weights": peak}
    print(f"jamba: long_500k serve_step (batch 1, capacity "
          f"{shape.seq_len}, position {shape.seq_len - 1}): "
          f"{times[0]:.4f} s cold, {times[1]:.4f} s warm; attention caches "
          f"{attn / 1e9:.3f} GB, Mamba states {(total - attn) / 2**20:.3f} "
          f"MiB; peak above the weights {peak / 2**30:.3f} GiB", flush=True)
    del states, logits
    torch.cuda.empty_cache()
    return out


def jamba_phase(dev) -> tuple[dict, dict, dict]:
    """The Mamba/attention hybrid at Jamba-v0.1's published width (d
    4096, 32 heads, 8 kv, d_ff 14336, vocab 65,536, untied, bf16; d_inner
    8192, d_state 16, dt_rank 256; seeded random weights), over the
    world-size-1 NCCL group (inside ``process_group``):
    ``mamba_memory_check``; ``JAMBA_STEPS`` + ``JAMBA_STEPS`` distributed
    ``lags_dp`` + kernel steps (``LARGE_DIST``) of ``JAMBA_TRAIN_LAYERS``
    layers with dense FFNs on one ``JAMBA_SEQ``-token sequence of
    uniform tokens, checked as the encoder phase's runs are, and the f32
    handoff on the trained weights; then ``JAMBA_SERVE_LAYERS`` layers
    with all their experts serve two requests (bf16 handoff) and one
    ``long_500k`` step.  Returns (launch counts of the training,
    results, each kernel's largest absolute error against its plain
    version)."""
    import torch
    from repro_torch import tree
    from repro_torch.configs import jamba_v0_1_52b
    from repro_torch.data import synthetic
    from repro_torch.models import transformer as T
    res: dict = {}
    kept: dict = {}
    torch.cuda.empty_cache()
    full = jamba_v0_1_52b.CONFIG
    cut = dataclasses.replace(full, n_layers=JAMBA_TRAIN_LAYERS, n_experts=0,
                              moe_top_k=0)
    serve = dataclasses.replace(full, n_layers=JAMBA_SERVE_LAYERS)
    print(f"jamba: {full.name}: {full.param_count()} parameters "
          f"({full.active_param_count()} active per token), d "
          f"{full.d_model}, {full.param_dtype}; trains at "
          f"{cut.n_layers} layers with dense FFNs ({cut.param_count()} "
          f"parameters, {len(tree.leaves(T.abstract_params(cut)))} leaves) "
          f"on {JAMBA_SEQ} tokens, serves at {serve.n_layers} layers "
          f"({serve.param_count()} parameters)", flush=True)
    res["memory"] = mamba_memory_check(dev, full, JAMBA_SEQ)
    batch = synthetic.lm_input_batch(3, 1, JAMBA_SEQ, full.vocab, device=dev)
    totals, res["train"], errs = distributed(
        dev, cut, JAMBA_SEQ, JAMBA_STEPS, plans={}, configs=LARGE_DIST,
        name="jamba ", step0="launches", keep=kept, batch=batch)
    check_falls("jamba", res["train"])
    res["delta"] = check_delta("jamba", res["train"])
    params = kept.pop("params")
    del batch
    torch.cuda.empty_cache()
    cut32 = dataclasses.replace(cut, dtype="float32", param_dtype="float32")
    p32 = tree.map(lambda p: p.float(), params)
    del params
    res["handoff_trained_f32"] = handoff_check(
        dev, "jamba 8 layers trained f32", cut32, p32, tag="jamba",
        faults=JAMBA_FAULTS)
    del p32
    torch.cuda.empty_cache()
    params = T.init_params(serve, seed=0, device=dev)
    prompts = synthetic.lm_input_batch(7, SERVE_BATCH, SERVE_PROMPT,
                                       serve.vocab, device=dev)["tokens"]
    res["serve"] = serve_full(dev, "jamba", "jamba_v0_1_52b 16 layers",
                              serve, params, 2, rtol=HANDOFF_RTOL_JAMBA,
                              faults=JAMBA_FAULTS, f32=False,
                              prompts=prompts)
    res["long_500k"] = long_context_step(dev, serve, params)
    del params
    torch.cuda.empty_cache()
    return totals, res, errs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one extra step of each main-path "
                         "configuration (tables to chiprun_out/)")
    ap.add_argument("--ranks", type=int, default=1,
                    help="> 1: run only the distributed phase, on this "
                         "many NCCL ranks (one card each)")
    # a rank process of --ranks N, started by this script itself
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    # deterministic cuBLAS, for the distributed step-0 check; read when
    # the first cuBLAS handle is made
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; "
              f"run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import paper_lstm_ptb, tinyllama_1_1b
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tinyllama_1_1b.CONFIG            # published width and depth
    seq, steps = 1024, 3
    if args.rank is not None:
        return rank_main(args, cfg, seq, steps)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib_path = build.build(verbose=True)
    build_s = time.perf_counter() - t0
    print(f"built {lib_path.name} in {build_s:.1f} s")
    if args.ranks > 1:
        return ranks_main(args.ranks)
    dev = torch.device("cuda", 0)

    clock: dict = {}
    torch.use_deterministic_algorithms(True)
    try:
        with timed("parity", clock):
            errs = parity(dev)
            small_reference(dev)
    finally:
        torch.use_deterministic_algorithms(False)

    p = 2
    with timed("timings", clock):
        times = timings(dev, cfg, p)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    with timed("autotune", clock):
        plans, autotune = autotune_phase(dev, cfg, seq, out_dir)
        planned = planned_pack_timings(dev, cfg, plans)
    with timed("main", clock):
        main_totals, results = main_path(dev, cfg, seq, steps, plans,
                                         out_dir if args.profile else None)
    # each later path: counts set to 0 just before it, read just after
    with timed("ef_accum", clock):
        path_counts, path_err = ef_accum_path(dev, cfg, seq)
    errs["ef_accum_sparsify"] = max(
        errs["ef_accum_sparsify"], path_err,
        times["ef_accum_sparsify_bf16"]["max_abs_err"])
    for name in REPLACES:
        errs[name] = max(errs[name], times[name]["max_abs_err"])
    with timed("paper", clock):
        paper_totals, paper_results, paper_errs = paper_path(dev, steps)
        narrow = narrow_timings(dev)
    with process_group(dev):
        with timed("distributed", clock):
            dist_totals, dist_results, dist_errs = distributed(
                dev, cfg, seq, steps, plans=plans)
        with timed("tp", clock):
            tp_totals, tp, tp_errs = tp_phase(dev, cfg, seq, steps)
        with timed("tp_families", clock):
            fam_totals, tp_fam, fam_errs = tp_phase(dev, cfg, seq, steps,
                                                    families=True)
        with timed("tp_recurrent", clock):
            rec_totals, tp_rec, rec_errs = tp_phase(dev, cfg, seq, steps,
                                                    recurrent=True)
        with timed("tp_serving", clock):
            tp_serve = tp_serving_phase(dev)
        with timed("tp_observe", clock):
            obs_tp_totals, tp_obs, obs_tp_errs = tp_observe_phase(dev, cfg,
                                                                  seq)
        with timed("paper_distributed", clock):
            lstm_totals, lstm_results, lstm_errs = distributed(
                dev, paper_lstm_ptb.CONFIG, LSTM_SEQ, steps, plans={},
                configs=PAPER_DIST, per_rank=LSTM_SEQS,
                name="paper-lstm-ptb ")
        with timed("observe", clock):
            observe_totals, observe = observe_phase(dev, cfg, seq, out_dir)
        with timed("stream", clock):
            stream_totals, stream = stream_phase(dev, cfg, seq)
        with timed("moe", clock):
            moe_totals, moe, moe_errs = moe_phase(dev, seq, steps)
        with timed("xlstm", clock):
            xlstm_totals, xlstm, xlstm_errs = xlstm_phase(dev, XLSTM_SEQ,
                                                          XLSTM_STEPS)
        with timed("encdec", clock):
            encdec_totals, encdec, encdec_errs = encdec_phase(dev)
        with timed("jamba", clock):
            jamba_totals, jamba, jamba_errs = jamba_phase(dev)
    for part in (paper_errs, dist_errs, tp_errs, fam_errs, rec_errs,
                 obs_tp_errs, lstm_errs,
                 stream.pop("errs"),
                 moe_errs, xlstm_errs, encdec_errs, jamba_errs):
        for name, err in part.items():
            errs[name] = max(errs[name], err)
    errs["block_topk"] = max(errs["block_topk"],
                             stream["block_topk"]["max_abs_err"])
    phases = {"main": main_totals, "ef_accum": path_counts,
              "paper": paper_totals, "distributed": dist_totals,
              "tp": tp_totals, "tp_families": fam_totals,
              "tp_recurrent": rec_totals, "tp_observe": obs_tp_totals,
              "paper_distributed": lstm_totals, "observe": observe_totals,
              "stream": stream_totals, "moe": moe_totals,
              "xlstm": xlstm_totals, "encdec": encdec_totals,
              "jamba": jamba_totals}
    totals = {name: sum(c[name] for c in phases.values())
              for name in REPLACES}
    # the stream phase's topk_hier_ef_kernel re-encode: a check, apart
    check_launches = stream["check_launches"]

    kernels_line = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": totals[name],
         "max_abs_err": errs[name], "ms": times[name]["ms"],
         "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"],
         "bound_by": times[name]["bound_by"],
         "library_ms": times[name]["library_ms"],
         "phase_launches": {**{ph: c[name] for ph, c in phases.items()},
                            "stream_check": check_launches.get(name, 0)}}
        for name in REPLACES]}
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "torch": torch.__version__, "build_s": build_s,
         "phase_s": clock,
         "config": dataclasses.asdict(cfg), "workers": p, "seq": seq,
         "timings": times, "autotune": autotune, "planned_pack": planned,
         "main": results, "distributed": dist_results, "tp": tp,
         "tp_families": tp_fam, "tp_recurrent": tp_rec,
         "tp_serving": tp_serve, "tp_observe": tp_obs,
         "paper": paper_results, "paper_narrow": narrow,
         "paper_distributed": lstm_results, "observe": observe,
         "stream": stream, "moe": moe, "xlstm": xlstm, "encdec": encdec,
         "jamba": jamba,
         **kernels_line},
        indent=1,
        default=str))
    print(json.dumps(kernels_line))
    print(card_line())
    print(result_line(torch))
    return 0


@contextlib.contextmanager
def timed(name: str, clock: dict):
    """The block's wall time into ``clock[name]``, printed."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        clock[name] = time.perf_counter() - t0
        print(f"phase {name}: {clock[name]:.1f} s", flush=True)


def result_line(torch) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


def ranks_main(world: int) -> int:
    """Start ``world`` rank processes of this script (the kernels are
    already built), wait for all of them, print their output; every
    rank must exit 0."""
    import torch
    if torch.cuda.device_count() < world:
        print(f"chip_smoke: --ranks {world} needs {world} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    init = f"tcp://localhost:{free_port()}"
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    logs = [out_dir / f"chip_smoke_rank{r}.log" for r in range(world)]
    procs = []
    try:
        for r, log in enumerate(logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()),
                     "--ranks", str(world), "--rank", str(r), "--init",
                     init],
                    stdin=subprocess.DEVNULL, stdout=f,
                    stderr=subprocess.STDOUT, text=True))
        # a rank that fails leaves the others waiting in a collective:
        # stop them all then, or at the deadline
        deadline = time.monotonic() + 1200
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or any(codes):
                break
            time.sleep(1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        print(f"--- rank {r} (exit {p.returncode})")
        print(log.read_text(), end="")
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        print(f"chip_smoke: ranks {failed} failed", file=sys.stderr)
        return 1
    # each kernel's launches by phase, summed over the ranks
    phases = {"distributed": "launches", "tp": "tp_launches",
              "tp_families": "tp_families_launches",
              "tp_recurrent": "tp_recurrent_launches",
              "moe_span": "moe_span_launches",
              "tp_stream": "tp_stream_launches",
              "paper_distributed": "paper_launches",
              "observe": "observe_launches",
              "tp_observe": "tp_observe_launches"}
    rows = [json.loads((out_dir / f"chip_smoke_rank{r}.json").read_text())
            for r in range(world)]
    print(json.dumps({"launches_by_phase": {
        ph: {k: sum(row[key][k] for row in rows) for k in rows[0][key]}
        for ph, key in phases.items()}}))
    print(card_line())
    print(result_line(torch))
    return 0


def rank_main(args, cfg, seq: int, steps: int) -> int:
    """One rank of ``--ranks N``: the distributed phase on card ``rank``,
    its rows to ``chiprun_out/chip_smoke_rank<r>.json``."""
    import torch
    torch.cuda.set_device(args.rank)
    dev = torch.device("cuda", args.rank)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    from repro_torch.configs import paper_lstm_ptb
    with process_group(dev, args.ranks, args.rank, args.init):
        totals, results, _ = distributed(dev, cfg, seq, steps,
                                         world=args.ranks, rank=args.rank,
                                         out_dir=out_dir)
        tp_totals, tp, _ = tp_phase(dev, cfg, seq, steps, world=args.ranks,
                                    rank=args.rank)
        fam_totals, tp_fam, _ = tp_phase(dev, cfg, seq, steps,
                                         world=args.ranks, rank=args.rank,
                                         families=True)
        rec_totals, tp_rec, _ = tp_phase(dev, cfg, seq, steps,
                                         world=args.ranks, rank=args.rank,
                                         recurrent=True)
        span_totals, span, _ = moe_span_phase(dev, args.ranks, args.rank)
        tp_serve = tp_serving_phase(dev, args.ranks, args.rank)
        fsdp_serve = fsdp_serving_phase(dev, args.ranks, args.rank)
        stream_totals, tp_stream, _ = tp_stream_phase(dev, args.ranks,
                                                      args.rank)
        lstm_totals, lstm_results, _ = distributed(
            dev, paper_lstm_ptb.CONFIG, LSTM_SEQ, steps, world=args.ranks,
            rank=args.rank, plans={},
            configs={"lags_dp/kernel": DIST_CONFIGS["lags_dp/kernel"]},
            per_rank=LSTM_SEQS, name="paper-lstm-ptb ")
        observe_totals, observe = observe_phase(
            dev, cfg, seq, out_dir, world=args.ranks, rank=args.rank)
        obs_tp_totals, tp_obs, _ = tp_observe_phase(
            dev, cfg, seq, world=args.ranks, rank=args.rank)
    (out_dir / f"chip_smoke_rank{args.rank}.json").write_text(json.dumps(
        {"card": card_line(), "torch": torch.__version__,
         "world": args.ranks, "rank": args.rank, "seq": seq,
         "launches": totals, "distributed": results,
         "tp_launches": tp_totals, "tp": tp,
         "tp_families_launches": fam_totals, "tp_families": tp_fam,
         "tp_recurrent_launches": rec_totals, "tp_recurrent": tp_rec,
         "moe_span_launches": span_totals, "moe_span": span,
         "tp_serving": tp_serve, "fsdp_serving": fsdp_serve,
         "tp_stream_launches": stream_totals, "tp_stream": tp_stream,
         "paper_launches": lstm_totals, "paper_distributed": lstm_results,
         "observe_launches": observe_totals, "observe": observe,
         "tp_observe_launches": obs_tp_totals, "tp_observe": tp_obs},
        indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
