#!/usr/bin/env python3
"""Drive the PyTorch port of DRACO (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build   - compile every CUDA source of the port with nvcc (sm_90a),
               all sources at once (drain, mix, enqueue, ssd_chunk);
  2. kernels - each kernel's wrapper against its plain PyTorch version on
               the card, at the main paths' shapes and the edge cases
               (the drain in f32 and bf16 at every case: payload rows at
               every alignment, K under one tile, more senders than
               receivers, slots out of order, empty buckets between live
               ones, the largest staging; the wide route at N = M in
               {65, 100, 256} x K in {1, 4099, 146,447}, rectangular
               across 64 both ways, J in {8, 16} at N = M = 64; the mix
               on each of its routes and across their edges (N from 1 to
               64 on the CUDA cores, 65 to 272 on the tensor cores, 273 and
               1000 on the wide route), at K under one vector, odd and
               ragged, past 2^31 elements, at the vlm trainer's plane (2
               x 3,231,797,250: past 2^31 columns, K % 4 = 2), in bf16,
               and on a plane whose rows start off four elements; the SSD
               intra-chunk step at the mamba2 trainer's shape in bf16, with
               groups, with Q != N in f32, under strong decays in f32 and
               bf16, ragged against the MMA tiles and at Q = N = 256); the
               bucketed enqueue driven at the JAX package's own test cases,
               the windowed path's width and its wide route (N past 64,
               J in {8, 16} at N = 64), one launch per call; each
               wrapper's shared-memory reckoning and route against the
               kernel's own; the drain's seed axis (R in {1, 2, 4, 8} at
               the EMNIST plane and R = 2 on the wide route, live sets
               differing per seed, one seed with none live): one launch,
               each row equal to a solo launch, within 1e-5 of plain; the
               rectangular drain as the client mesh runs it (J 1, N_loc 2,
               M 4 at qwen2-1.5b's full plane; J 3, N_loc 5, M 25 at the
               fig4 window; J 1 and J 4, N_loc 5, M 25 at the EMNIST plane,
               a baseline round's mix and an event's drain, phase 21 (d);
               J 1, N_loc 1, M 64 at mamba2-2.7b's plane at 1
               and 2 layers, phase 22's dense pair, M K past 2^31; J 1,
               N_loc 2, M 4 and J 1, N_loc 2, M 2 at one model rank's
               qwen2-1.5b and olmoe-1b-7b planes at 2 layers, phase 23's
               (a) and (d); J 1, N_loc 2, M 2 at one model rank's
               mamba2-2.7b plane at 2 layers and zamba2-2.7b's at 6,
               phase 23's (f) and (g); and at llama-3.2-vision-11b's
               plane at one group, K % 4 = 1, and musicgen-large's at 2
               layers, phase 23's (i) and (j)) in f32
               and bf16, within 1e-5 of the largest |value| of the plain
               version, compared in column slices; `ssd_chunk` also at
               phase 22's mamba2 shapes (nc 32 at batch 1 and 4, nc 256)
               and at phase 23's local ssm heads (40 of 80 in (f) and
               (g), 5 in (h)'s (16, 16) share of train_4k, mamba2's and
               zamba2's);
  3. main    - `simulate("draco", ...)` at the paper's EMNIST scale
               (25 clients, MLP 784-160-100-47, Psi = 6, wireless channel)
               for 300 windows: launches per window, accuracy, finiteness,
               no host sync inside the window loop;
  4. plain   - 50 windows of the main path twice from one seed, through
               the kernel and through the plain drain: final params agree;
  5. trainer - the DRACO LM trainer `repro_torch.launch.train.main` at
               qwen2-1.5b's full width (28 layers, d_model 1536, vocab
               151,936, bf16), 4 clients, 5 steps, Psi = 1, 2
               unifications: one mix launch per step, finite losses, the
               first near ln V, peak device memory;
  6. trainer plain - 3 trainer steps twice from one seed, through the mix
               kernel and through its plain version: the losses and every
               leaf's |sum gap| / sum |p| within 1e-3; the kernel run's
               steps are profiled (device idle share, mix time per step);
  7. mamba2  - the trainer on mamba2-2.7b at full width (d_model 2560, 80
               SSD heads of 64, state 128, vocab 50,280, bf16) cut to 32 of
               its 64 layers (the 4 clients' planes of all 64 do not fit one
               card), 4 clients, batch 2 x 512 tokens (4 SSD chunks), 3
               steps: finite losses, the first near ln V, one mix launch per
               step, two SSD-kernel launches per block, client and step
               (forward and remat), peak device memory;
  8. mamba2 plain - 3 steps through the plain SSD step and plain mix, 3
               through the kernels and 3 through a control (the plain
               path with each SSD output moved by 2^-23 of itself): the
               losses within 1e-3, every leaf's gap to the plain path over
               that leaf's own 3-step change within 1.1 x the control's,
               and the kernel on the inputs of every SSD call of the
               plain run within 1e-4; the kernel run's steps are profiled
               (device idle share, SSD and mix time);
  10. wide window - `draco_window` at N = 100 clients for 50 windows
               through the drain kernel (its wide route) and through the
               plain drain: one launch per window, final params within
               1e-4, the same acceptances;
  11. baselines - sync-symm, sync-push, async-symm and async-push at the
               fig3 EMNIST setup, each for the rounds matching 300 DRACO
               windows of local compute: one mix launch per round, the
               final accuracy against its floor, the steady round under
               the sync detector and its device idle share, 50 rounds
               through the mix kernel against the plain mix (1e-4); then
               sync-symm at N = 100 (the mix's tensor route) and, printed
               and not held, each method's 50-round gap there;
  12. scenarios and optimizers - at phase 3's EMNIST setup, the rings of
               `benchmarks/fig_dynamic.py`'s knobs (period 32): 240 windows
               each under markov-edge-flip (churn 0.2), straggler-profile
               (fraction 0.5, slowdown 10, duty 0.5) and random-waypoint;
               tiny-lm (AdamW, warmup-cosine) under random-waypoint and
               small-cnn (Nesterov momentum) under straggler-profile at
               their default widths, 240 windows each (tiny-lm's
               perplexity must fall, small-cnn's accuracy end above
               chance);
               every run one drain launch a window, finite params and
               optimizer plane, the steady window under the sync detector
               (0 host syncs) and its device idle share; 50 windows of
               each new task through the kernel and the plain drain
               (params and optimizer plane within 1e-4, the same
               acceptances); the four baselines with momentum under
               markov-edge-flip, 60 rounds (one mix launch a round), the
               steady round (0 host syncs, idle share), 50 rounds through
               the kernel against the plain mix (1e-4);
  13. sweep  - `simulate_sweep` over benchmarks/fig4_psi_sweep.py's grid
               (Psi in {1, 2, 4, 8, 24}) x 4 seeds x 120 windows at the fig3
               EMNIST setup: one drain launch per batched window (the
               drain's seed axis), the (5, 4, 6) trace, finite params, each
               Psi's seed-mean accuracy against its floor
               (scripts/fig4_reference_floors.py); the steady batched
               window under the sync detector beside a solo window, idle
               shares; row (Psi 4, seed 1) against the solo `simulate`
               over 50 windows (1e-4, equal acceptances);
  14. events - draco-event, fedasync-gossip (poly) and event-triggered on
               one 300 s tape at the same setup: one drain launch per
               valid event, none per padding row, 0 host syncs (one per TX
               row for event-triggered, which suppresses some), accuracy
               floors; draco-event through `simulate_events`; ms per
               event and idle share; 300 events through the kernel and
               the plain drain (1e-4, equal counters); fedasync-window
               240 windows, one drain a window, against the plain drain;
  15-18. families - the trainer `main` on the other model families at
               their published widths, 2 clients, 2 steps each, Psi 1
               (`FAMILY_PHASES`): 15 olmoe-1b-7b
               (moe, 64 experts top-8, 8 of 16 layers), 16 zamba2-2.7b
               (hybrid: all 54 Mamba2 blocks at 2 x 512 tokens, the shared
               attention + MLP block after every 6), 17 llama-3.2-vision-
               11b (vlm: 10 of 40 layers, cross-attention to 1,600 patch
               embeddings behind a tanh gate), 18 musicgen-large (audio:
               all 48 layers, frame embeddings in), each cut in depth only
               as far as the card's memory forces: finite losses, the
               first near ln V, one mix launch per step, for zamba2 two
               SSD-kernel launches per Mamba2 block, client and step, peak
               device memory; 15 and 16 also 3 steps through the plain
               versions against 3 through the kernels (olmoe at 6 layers
               under phase 6's rule; zamba2 at 6 layers under phase 8's
               control rule, a leaf kind pooled over the Mamba2 blocks,
               against the largest of 3 controls, the kernel shadowing
               every SSD call of the plain run; the same rule must reject
               three planted faults: the SSD kernel's one-term variant,
               the mix with Q^T, the mix leaving its last 2^22 columns
               zero), 17 and 18 a
               profiled step; s/step, idle share and the kernels' device
               time per step printed;
  19. entry points - (a) 50 windows of the legacy engine
               (`draco_window_legacy`) and 50 of the fused window through the
               drain kernel at benchmarks/torch_run.py's draco_window shape
               (the fig3 EMNIST setup, N = 25, D = 8), from one seed on one
               draws record: params within 1e-4, equal acceptances, one
               drain launch a window, ms per window of both; (b) every
               benchmarks/torch_run.py bench at quick=True (its JSON and
               results/ files in a temporary directory): its rows printed
               and finite, launches of the drain, mix and ssd_chunk
               kernels wherever the bench reaches them; (c) every
               examples/torch_*.py at a reduced size (`EXAMPLES`), holding
               its own assertions; the phase's time printed;
  20. serving and long context - (a) `python -m repro_torch.launch.serve`'s
               `main` at batch 4, prompt 8, 8 new tokens (the reference's
               defaults are 32 and 16) for qwen2-1.5b, mamba2-2.7b,
               zamba2-2.7b, olmoe-1b-7b, llama-3.2-vision-11b (1,600 patch
               embeddings) and musicgen-large at full width in bf16, each
               cut to about a quarter of its layers (`SERVE_LAYERS`): tokens
               in range, ms per decode step, aggregate tok/s, device idle
               share of 4 steady decode steps, peak memory, 0 host syncs
               in the decode loops under the sync detector; (b) each in
               f32 (TF32 off), one at a time, decoded over a 64-token
               prompt at batch 2 against `apply_model` over it, within a
               bound of each model's (1e-4 of the largest |logit|;
               mamba2 5e-3 and zamba2 2e-3: the recurrence against the
               `ssd_chunk` kernel's forward, that forward within 1e-5 of
               the plain SSD step's); mamba2 also in f64, its decode
               within 1e-10 of its prefill; qwen2 with a 64-slot ring
               over 200 tokens against windowed `apply_model`; (c)
               `make_prefill_step` on qwen2-1.5b at prefill_32k's S =
               32,768 (batch cut from 32 to 1) through the flash path: the
               (B, S, V) logits finite, the first 4,096 positions against
               full attention on that prefix within 0.1 of the largest
               |logit| (bf16); (d) decode_32k (batch cut from 128 to 32,
               from pos 32,760) and long_500k (qwen2's 8,192-slot ring and
               mamba2's O(1) state from pos 524,000): ms per step, peak
               memory, 0 host syncs; (e) the trainer `main` on qwen2-1.5b
               at --seq 8192, 2 clients of batch 1, 1 step, Psi 1 (one
               mix launch a step, the first loss near ln V, peak memory,
               s/step), then `lm_loss` at that shape with vocab_chunk 1024
               against 0 (loss within 1e-3, each leaf's gradient within
               5e-2 in L2, and no farther from an f32 copy's gradient
               than 2x the full loss's), both peaks; the phase's time
               printed;
  21. client mesh - `repro_torch.launch.mesh` over spawned ranks: (a)
               `gossip_drain_sharded` at the fig4 window (J 3, N = M 25, K
               146,447) over nccl at one rank per card and over gloo at 5
               ranks sharing the card (every gloo collective staged through
               the host), each rank's rows within 1e-5 of the largest
               |value| of the plain unsharded drain, one launch a rank, ms
               per call and the collective's share; (b) `train.main
               --mesh-backend gloo` on qwen2-1.5b at full width cut to
               `MESH_LAYERS` of 28 layers, 4 clients, every sender
               transmitting: dense (f32 and bf16, over the complete graph)
               and none at 2 ranks, the ring at 4, one step each (none 2
               and a unification); each step's mix probed: step 1's
               per-client losses and delta rows (digests) bitwise equal to
               the single-process trainer's (and step 2's in the none mode),
               step 1's mixed plane against the mix kernel on the gathered
               plane (`MESH_MIX_TOL`), every step's finite, s/step and
               the collective's share,
               one drain launch a rank and step in the dense modes (in
               the whole run these modes run first in phase 23's worlds
               of 2 and 4 ranks, one world start each, their checks
               logged there and their seconds on the `phase times:` line
               as "21 (b) in 23's worlds"); (c)
               fig4's Psi grid (2 seeds, 30 windows) through
               `simulate_sweep(mesh=)` over the 5 gloo ranks against the
               unsharded sweep (params within 1e-4, the same
               acceptances), ms per batched window and the collective's
               share; (d) in that world, after (a) at the two tiles of
               `MESH_TILES`, every other registered algorithm through
               `simulate_sweep(mesh=)` (`MESH_ALGOS`: the four baselines
               10 rounds at the fig3 setup, fedasync-window 2 seeds x 10
               windows, the event family the first 60 rows of phase 14's
               tape), each against its unsharded run (params within
               1e-4, the counters exact, its accuracy printed), one drain
               launch a rank a round, batched window and valid event and
               no mix launch, ms per round, window and event sharded
               against unsharded and the collective's share, the part's
               seconds on the `phase times:` line as "21 (d) algorithms";
  9. times   - each kernel's time (CUDA events) beside its bound, its plain
               version and one PyTorch library call computing the same
               (where there is one), at its main path's shapes; the wide
               routes (drain at N = M = 100 and 256, enqueue at N = 100)
               and the mix at N = 25, 100 and 256 beside both bounds (f32
               rate and split-TF32 tensor cores); every mix row also beside
               a device-to-device copy of the same plane (the stream's
               floor); the drain's seed axis at R = 4 beside R solo
               launches, its bound (R x the solo drain's), the einsum and
               the plain version; the mix at the olmoe, musicgen and vlm
               trainers' planes (N = 2, f32, `FAMILY_MIX_PLANES`) beside
               its plain version and `torch.matmul` (or cuBLAS's refusal
               past 2^31 - 1 columns and the product over dense slices);
               the rectangular drain at phase 2's mesh shapes (21, 23) beside
               its bound, the plain version, the einsum and phase 21's
               collective; `ssd_chunk` also at a (16, 16) rank's 5 local
               heads of mamba2 x train_4k. Phase 9 runs last, after 10 to
               23.
  22. dry run - `python -m repro_torch.launch.dryrun`'s `lower_pair` on
               `DRY_PAIRS` (two train pairs, a prefill and two decode
               pairs, one rank's share of the client mesh at full width):
               each reckoned on ``meta`` (FLOPs, bytes, each kernel's
               work, the collective tally, the peak) and run with
               ``--run`` (`dryrun.RUN_STEPS` step after a warm-up, CUDA
               events, the sync detector; the dense train pair at depths
               1 and 2, extrapolated); each row printed; the reckoned peak
               against `torch.cuda.max_memory_allocated` within
               `DRY_PEAK_TOL` at every depth run and after extrapolating,
               the train pairs' `useful_flops_ratio` (6 N T over the
               counted FLOPs) inside `DRY_TRAIN_RATIO`, 0 host syncs, a
               finite `roofline_fraction` and `bound_fraction` in (0, 1];
               phase 2 holds the kernels at these pairs' shapes
               (`RECT_DRY`, the "dry run" rows of `SSD_CASES`);
  23. tensor parallelism - `repro_torch.sharding.tp` over a "model" axis,
               ranks sharing the card over gloo as phase 21's: (a)
               `train.main` on a (data 2, model 2) world, qwen2-1.5b at
               full width and 2 of 28 layers, 4 clients, 2 steps of the
               dense f32 mix and of none: step 1's per-client losses and
               every leaf of the rank's blocks against the single-process
               trainer on the same seeds (`TP_LOSS_TOL`; a weight within
               `TP_WEIGHT_TOL`, a zero-init leaf within `TP_PARAM_TOL`),
               the replicated leaves bit for bit equal across the model
               ranks after both steps, one drain launch a rank a dense
               step (phase 2 holds its J 1, N_loc 2, M 4 shape at one
               model rank's plane, `RECT_TP`); the model axis's tally,
               the staging seconds and the routes printed; (b) in (d)'s
               (1, 2) world: prefill and `TP_DECODE_STEPS` decode steps of
               qwen2-1.5b at full width and depth in f32, batch
               `TP_SERVE_BATCH`, the logits against one process within
               `TP_SERVE_TOL` of the largest |logit|; (c) the dry run's
               default mesh, the reference's (16, 16), for `TP_DRY`: one
               rank's 1 / 16 share of qwen2.5-32b (each rank its 3 of the
               40 heads, the padded route) reckoned, its full-depth peak
               within the card, and run at depths 1 and 2, each peak
               within `DRY_PEAK_TOL`; (d) `train.main` on a (data 1,
               model 2) world, olmoe-1b-7b (moe) at full width and 2 of
               16 layers, 2 clients, 2 steps of the dense mix: (a)'s
               checks, the router also within `TP_F32_TOL` of its step-1
               update, 32 of the 64 experts a rank (phase 2 holds its
               drain shape, `RECT_TP_MOE`); (e) as (c) for qwen3-moe-30b-
               a3b (8 of 128 experts a rank); (f) as (d) for mamba2-2.7b
               at 2 of 64 layers, 40 of its 80 ssm heads a rank, its
               zero-init and f32 leaves within `TP_SSM_TOLS`; (g) as (f)
               for zamba2-2.7b at 6 of 54 layers in f32, 1 step without
               remat (`TP_HYBRID_TOLS`), then served in f32 at that depth
               against one process within `TP_SSM_SERVE_TOL` ((d), (f),
               (g) and (b) in one (1, 2) world); (h) as (c) for mamba2-2.7b
               (`TP_DRY_SSM`: 5 ssm heads a rank, the loss in chunks of
               1,024 positions), and zamba2-2.7b's share reckoned; (i) as
               (d) for llama-3.2-vision-11b at one group (5 of 40 layers,
               the cross layer among them), its tanh gates set to
               `TP_GATE` in the ranks and the reference, 16 query and 4 kv
               heads a rank; (j) as (d) for musicgen-large at 2 of 48
               layers (frame embeddings in, the head vocab-parallel);
               both served in f32 in that world against one process
               within `TP_CROSS_SERVE_TOL` (the vlm's cross K/V on the
               rank's kv heads, musicgen fed back `TP_FEED` tokens'
               embeddings looked up vocab-parallel); (k) as (c) for the
               vlm (`TP_DRY_CROSS`: 2 query heads and 1 kv head a rank,
               `wk`/`wv` gathered), and musicgen-large's share reckoned;
               (l) sequence parallelism (`--seq-parallel`, `TP_SP`): in
               (a)'s and (d)'s worlds one step with the flag for
               qwen2-1.5b (none), olmoe, mamba2 and the vlm, each held
               against one process under its twin's checks and against
               its twin's step 1 without the flag in the same world under
               the same bounds, the sequence-parallel sub-blocks in the
               tally; the vlm in f32 with the flag and the none mix
               (`TP_SP_F32`), its cross layer's step-1 update against one
               process leaf by leaf within `TP_CROSS_F32_TOL` (ROADMAP
               F4); then the dry run's (16, 16) yi-34b x train_4k share
               with the flag (`TP_DRY_SP`: it fits only so) reckoned and
               run at depths 1 and 2 as (c), and qwen2.5-32b's reckoned
               with it; (m) the decode cache's other layouts
               (`steps.cache_layout`, ROADMAP item 20(f)) in (a)'s world:
               qwen2-1.5b at full width and depth in f32, `TP_CACHE_STEPS`
               decode steps from a cache pre-filled alike in every process
               at long_500k's ring of 8,192 slots and batch of 1 (the
               slots over "data", from position 8,190 across the wrap)
               and under `cache_shard` head_dim and seq on (b)'s batch and
               length, each against one process within `TP_SERVE_TOL`,
               the layout as `TP_CACHE` says, the merge over "data"
               tallied as client-axis all-reduces; then the (16, 16)
               shares of `TP_DRY_CACHE` reckoned and run at full depth,
               the peak within `DRY_PEAK_TOL`, and every other long_500k
               pair reckoned (one row a client rank);

The line before the last is one JSON object {"kernels": [...]}; the last
line is {"ok": true, "device": {...}}. Exits non-zero without CUDA and
without the repository's `src/` beside this file.

    python3 chip_smoke.py --ssd-variants [NAMES] [--flush zero,read,none]
    python3 chip_smoke.py --gossip-variants [NAMES] [--baseline TREE] [--gossip-kernels K]
    python3 chip_smoke.py --trainer-controls
    python3 chip_smoke.py --families
    python3 chip_smoke.py --entry-points
    python3 chip_smoke.py --serving
    python3 chip_smoke.py --mesh
    python3 chip_smoke.py --dryrun
    python3 chip_smoke.py --tp [--tp-faults]
    python3 chip_smoke.py --mesh --tp
    python3 chip_smoke.py --hybrid-depths 6,12,54

run one diagnostic instead: the first times variants of ssd_chunk.cu
(`repro_torch.kernels.ssd.variants`) at the trainer's shape; the second
variants of drain.cu, enqueue.cu and mix.cu
(`repro_torch.kernels.gossip.variants`, ``--gossip-kernels`` to choose;
``baseline`` is the same kernel's source under TREE, say the parent
commit unpacked) at the windowed path's shapes, for the drain also the
wide route's at N = 100, and for the mix at N = 25, 100, 256 and 4
(`MIX_VARIANT_SHAPES`); the third
runs phase 8 with further paths, printed and not held: the kernel's
forward built from `CONTROL_VARIANTS` of its source (a planted fault
among them), training beside the kernel's path and shadowing the plain
run's SSD calls; the fourth runs the build and phases 15-18 alone; the
fifth the build and phase 19 alone; the sixth the build and phase 20
alone; the seventh the build, phase 21 and the rectangular drain's
phase 2 and 9 rows; the eighth the build, phase 2's rectangular drain
and `ssd_chunk` checks (the kernels at phase 22's shapes) and phase 22;
the ninth the build, phase 2's rectangular drain and `ssd_chunk`
checks, phase 23 and its drain shapes' phase 9 rows (with ``--mesh``
also phase 21 before it, (b)'s modes in phase 23's worlds as in the
whole run; with
``--tp-faults``, then (a)'s, (d)'s, (f)'s and (i)'s checks against the
planted faults of `TP_FAULTS`, each of which must fail them, and
`TP_TRAP` beside, logged; ``--tp-faults`` alone runs only those); the
tenth phase 16's comparison at other zamba2 depths, block
by block (the only
run that reproduces the measurement behind `FAMILY_CONTROLS`; exits 1
when the rule fails at any depth).
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))
# the trainer holds two 24.7 GB f32 planes beside 12.4 GB of params:
# growable segments keep the allocator from fragmenting around them
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

RTOL = ATOL = 1e-5  # kernel against its plain version: f32 sums reordered
PATH_TOL = 1e-4  # 50 windows, kernel path against the plain-drain path
WINDOWS, EVAL_EVERY, PLAIN_WINDOWS = 300, 100, 50
TRAIN_ARGS = ["--arch", "qwen2-1.5b", "--clients", "4", "--batch-per-client", "2",
              "--seq", "128", "--steps", "5", "--unify-every", "2", "--psi", "1",
              "--log-every", "5"]
TRAIN_STEPS, TRAIN_PLAIN_STEPS = 5, 3
# kernel path against the plain path: every step's loss, and per leaf
# |sum gap| / sum |p| where the paths are equal up to the order of f32 sums
# (qwen2)
TRAIN_PATH_RTOL = 1e-3
# the mix: its narrow route at every receiver padding and across its
# edges, K under one 4-column vector, ragged and odd; its tensor route at
# the 64-receiver blocks' edges, two groups (129) and four (256), its last
# N (272 in f32); stream.cuh's wide route past what a block's Q splits hold
# (273 and 1000 clients); a plane that starts one element into its storage
# (no row aligned to four elements, even at K = 4096)
MIX_N, MIX_K = (1, 3, 4, 5, 8, 9, 16, 17, 25, 33, 64), (1, 3, 5, 511, 513, 4099, 146_447)
MIX_WIDE_N = (65, 100, 104, 105, 128, 129, 256)
BIG_MIX = (4, 536_870_919)  # N * K > 2^31
# the vlm trainer's plane (phase 17: llama-3.2-vision-11b at 10 layers, 2
# clients): K past 2^31 and K % 4 = 2, the narrow route without vectors
VLM_MIX = (2, 3_231_797_250)
# --gossip-variants: the mix at the baselines' width, at N = 100 and 256
# (the tensor route) and at the trainer's N = 4 with K cut to 2^28
MIX_VARIANT_SHAPES = ((25, 146_447), (100, 146_447), (256, 146_447), (4, 1 << 28))
SLICE = 1 << 27  # columns per comparison slice of a multi-GB plane
SPIN_CYCLES = 2_000_000  # about 1 ms of device clock, to cover host enqueue
SEED = 0
# mamba2-2.7b: the trainer's defaults at 512 tokens, at 32 of the 64
# layers (4 clients' bf16 params, two f32 planes and one gradient at 40 B
# per parameter: 113 GB at 64 layers, 57 GB at 32)
MAMBA_LAYERS = 32
MAMBA_ARGS = ["--arch", "mamba2-2.7b", "--clients", "4", "--batch-per-client", "2",
              "--seq", "512", "--steps", "3", "--unify-every", "3", "--psi", "1",
              "--log-every", "3"]
MAMBA_STEPS, MAMBA_PLAIN_STEPS = 3, 3
# mamba2's kernel path against its plain path, per leaf: sum |p - p_plain|
# over the leaf's own 3-step change sum |p_plain - p_init|, the kernel's at
# most this times the control's (the plain path with an f32-level change
# in its SSD outputs). Any f32-level change flips bf16 roundings of the
# activations and updates, so no leaf is equal up to summation order
# (PERF.md, PR 14)
CONTROL_MARGIN = 1.1
# builds of ssd_chunk.cu that --trainer-controls also trains through: two
# split terms (within SSD_REL_TOL) and one (a planted fault)
CONTROL_VARIANTS = ("two-term", "one-term")
SSD_REL_TOL = 1e-4  # kernel against plain, relative to the largest |Y| (|S|)
# phases 15-18, (label, arch, layers kept, layers of the comparison, seq):
# the other families at their published widths with 2 clients, cut in
# depth only where one card's memory forces it. Bytes per parameter: bf16
# params and the f32 delta and mixed planes, 20 at the mix (14 while a
# client's bf16 gradient lives; olmoe at 6 layers, 2.72 B params, peaked
# at 50.99 GiB on an H100 80GB against 50.7 reckoned); the phase 15 and 16
# comparisons keep the plain run's params (4 B) beside the kernel run's
# 20. olmoe-1b-7b's 16 layers need ~129 GiB: 8 (3.56 B params, ~66.4
# GiB), its comparison 6 (~60.8 GiB with the plain run's params);
# zamba2-2.7b all 54 (2.42 B, ~45 GiB), its comparison one group of 6
# (see `FAMILY_CONTROLS`); llama-3.2-vision-11b two groups of 5 of its 40
# layers (3.32 B, ~61.8 GiB; three groups ~82.9 GiB); musicgen-large all
# 48 (3.23 B, ~60.2 GiB). Batch 2 per client; 512 tokens for zamba2 (4
# SSD chunks of 128), 128 for the others
FAMILY_PHASES = (("15 moe", "olmoe-1b-7b", 8, 6, 128),
                 ("16 hybrid", "zamba2-2.7b", 54, 6, 512),
                 ("17 vlm", "llama-3.2-vision-11b", 10, 10, 128),
                 ("18 audio", "musicgen-large", 48, 48, 128))
FAMILY_STEPS, FAMILY_PLAIN_STEPS, FAMILY_PROFILE_STEPS = 2, 3, 3
# phase 16's comparison: zamba2 at one group (6 Mamba2 blocks and one
# application of the shared block), each leaf against the largest of 3
# controls, the 6 block positions' leaves of a kind pooled into one (as
# mamba2's leaves stack all its blocks). On an H100 80GB, at 12 to 54
# layers the 3-step trajectories are chaotic: one 2^-23 control moves the
# loss by up to 1.6e-3 and its most moved leaf by 0.8-1.45 of the leaf's
# own change, so no rule sees the kernel there; at 6 layers by <= 1.1e-4
# and 0.34. There a leaf of
# one block holds 80 f32 values (a_log) or a few bf16 flips (conv_w) and
# its ratio is one noisy sample: unpooled, the kernel exceeded 1.1 x one
# control in 2 of 66 leaves and the largest of 3 in 1 (a_log of block 5,
# whose 3-step change is ~1 f32 ulp a value); pooled, the kernel is within
# 0.96 x the largest of 3 and 1.26 x one control (`--hybrid-depths`;
# PERF.md)
FAMILY_CONTROLS = 3
# phase 16's planted faults, each a kernel path that its rule must
# reject: the SSD kernel's forward with one bf16 term of each split
# (`CONTROL_VARIANTS`' one-term, about 2^-9 of each operand), the mix
# reading Q^T for Q (a transposed weight index), the mix leaving its last
# `MIX_FAULT_TAIL` columns zero (a dropped last pass over the plane)
MIX_FAULT_TAIL = 1 << 22


def pool_ssm_positions(leaf):
    """``groups/<i>:ssm/...`` -> ``groups/*:ssm/...``: one leaf per kind
    over every Mamba2 block of a group."""
    return re.sub(r"^groups/\d+:ssm/", "groups/*:ssm/", leaf)
# (Bb, H, G, nc, Q, N, P, A scale, dtype): the trainer's shape (batch 2, 512
# tokens, 80 heads, one group), grouped, f32 with Q != N and a ragged P,
# decays that overflow exp above the diagonal unless masked first (f32
# and, through the tensor cores, bf16), Q, N and P ragged against the
# MMA tiles, the bf16 kernel's largest Q = N = 256, and zamba2's trainer
# shape (state 64)
SSD_MAIN = (2, 80, 1, 4, 128, 128, 64, 1.0, "bfloat16")
SSD_CASES = {
    "trainer shape bf16": SSD_MAIN,
    "grouped G=4 H=16 N=64": (2, 16, 4, 2, 128, 64, 64, 1.0, "bfloat16"),
    "f32 Q=64 N=128 P=48": (2, 8, 1, 3, 64, 128, 48, 1.0, "float32"),
    "strong decay A=-10h dt+1": (2, 80, 1, 4, 128, 128, 64, 10.0, "float32"),
    "strong decay A=-80h dt+1 bf16": (2, 80, 1, 4, 128, 128, 64, 80.0, "bfloat16"),
    "ragged Q=72 N=24 P=40 bf16": (2, 6, 2, 3, 72, 24, 40, 1.0, "bfloat16"),
    "Q=N=256 bf16": (1, 8, 1, 2, 256, 256, 64, 1.0, "bfloat16"),
    "zamba2 trainer shape bf16 N=64": (2, 80, 1, 4, 128, 64, 64, 1.0, "bfloat16"),
    "bench_ssd shape f32 N=64": (2, 16, 1, 8, 128, 64, 64, 1.0, "float32"),
    # phase 20 (b)'s f32 prefills: one chunk of the 64-token prompt
    "mamba2 f32 prefill Q=64 N=128": (2, 80, 1, 1, 64, 128, 64, 1.0, "float32"),
    "zamba2 f32 prefill Q=64 N=64": (2, 80, 1, 1, 64, 64, 64, 1.0, "float32"),
    # phase 22's mamba2 pairs: train_4k (32 chunks) at one sequence a rank
    # (the ring pair) and four (the dense pair), prefill_32k (256) at one
    "dry run train_4k nc=32 bf16": (1, 80, 1, 32, 128, 128, 64, 1.0, "bfloat16"),
    "dry run train_4k Bb=4 nc=32 bf16": (4, 80, 1, 32, 128, 128, 64, 1.0, "bfloat16"),
    "dry run prefill_32k nc=256 bf16": (1, 80, 1, 256, 128, 128, 64, 1.0, "bfloat16"),
    # phase 23's ranks over "model", each on its own ssm heads: (f) and (g)
    # at 40 of 80 (2 x 128 tokens a client; (g) in f32), (g)'s f32 prefills
    # of 4 x 32 tokens on a rank and in one process, (h)'s (16, 16) share
    # of train_4k (16 sequences of 4,096 tokens, 5 heads) for mamba2 and
    # zamba2
    "tp (f) mamba2 H_loc=40 bf16": (2, 40, 1, 1, 128, 128, 64, 1.0, "bfloat16"),
    "tp (g) zamba2 H_loc=40 N=64 f32": (2, 40, 1, 1, 128, 64, 64, 1.0, "float32"),
    "tp (g) f32 prefill H_loc=40 Q=32 N=64": (4, 40, 1, 1, 32, 64, 64, 1.0, "float32"),
    "tp (g) one-process f32 prefill Q=32 N=64": (4, 80, 1, 1, 32, 64, 64, 1.0, "float32"),
    "tp (h) train_4k H_loc=5 nc=32 bf16": (16, 5, 1, 32, 128, 128, 64, 1.0, "bfloat16"),
    "tp (h) zamba2 train_4k H_loc=5 N=64 bf16": (16, 5, 1, 32, 128, 64, 64, 1.0, "bfloat16"),
}
SSD_ZAMBA2 = SSD_CASES["zamba2 trainer shape bf16 N=64"]
SSD_TP_LOCAL = SSD_CASES["tp (h) train_4k H_loc=5 nc=32 bf16"]
# gossip_enqueue's path: the JAX package's own cases
# (tests/test_kernels_gossip_bucketed.py) and the windowed path's width
ENQ_MAIN = (3, 25, 146_447)  # J = D - 1 buckets, N clients, K = Dflat of EMNIST
ENQ_PATH = [(1, 16, 256), (3, 16, 256), (7, 16, 256), (3, 25, 192), (3, 7, 192),
            (3, 8, 513), (4, 10, 96), (1, 25, 146_447), (3, 25, 146_447),
            (7, 25, 146_447)]
# the gossip kernels' wide route (csrc/stream.cuh): clients past 64, at K
# under one tile, ragged, and the EMNIST plane's width
WIDE_N, WIDE_K = (65, 100, 256), (1, 4099, 146_447)
ENQ_WIDE = [(3, n, k) for n in WIDE_N for k in (4099, 146_447)] + [(8, 64, 4099),
                                                                  (16, 64, 4099)]
# a bf16 sum of the wide route (split-TF32 products, within ~2^-21 of the
# plain version's f32 sum) rounds to the bf16 value next to the plain
# version's where the sum lies near a rounding tie: one bf16 step, at most
# 2^-7 of the value
WIDE_BF16_RTOL = 2.0 ** -7
WIDE_CLIENTS = 100  # phase 10: draco past the drain's narrow route
# phase 11: the fig3 EMNIST setup (benchmarks/fig3_convergence.py:61-85),
# each baseline for the rounds matching FIG3_WINDOWS DRACO windows of local
# compute; each final accuracy must reach its floor, 0.8 x the smallest
# final accuracy of the JAX reference over 3 seeds on the CPU at the same
# setup (scripts/fig3_reference_floors.py: 0.5525, 0.5525, 0.5489, 0.9008)
FIG3_WINDOWS = 300
BASELINE_FLOORS = {"sync-symm": 0.44, "sync-push": 0.44, "async-symm": 0.43,
                   "async-push": 0.72}
BASELINE_STEADY, BASELINE_PLAIN_ROUNDS, BASELINE_WIDE_ROUNDS = 30, 50, 5
# phase 12: scenarios and local optimizers at phase 3's EMNIST setup, with
# benchmarks/fig_dynamic.py's knobs (rings of period 32)
SCENARIO_WINDOWS, SCENARIO_STEADY, SCENARIO_ROUNDS = 240, 60, 60
SCENARIOS = {
    "markov-edge-flip": dict(steps=32, churn=0.2),
    "straggler-profile": dict(steps=32, straggler_frac=0.5, slowdown=10.0, duty=0.5),
    "random-waypoint": dict(steps=32),
}
# the new tasks at their default widths, each with its optimizer and
# scenario (scripts/phase12_reference.py runs the JAX package at the same
# setups). tiny-lm's perplexity must fall, small-cnn's accuracy end above
# chance (0.2 for 5 classes). The latter is a thin margin: the JAX package
# ends at 0.23-0.29 there while its clients' own-shard loss rises
# (PERF.md, PR 18)
NEW_TASKS = {
    "tiny-lm": (dict(optimizer="adamw", schedule="warmup-cosine",
                     schedule_kwargs={"warmup": 24, "total_steps": SCENARIO_WINDOWS}),
                "random-waypoint"),
    "small-cnn": (dict(optimizer="momentum", opt_kwargs={"nesterov": True}),
                  "straggler-profile"),
}
SMALL_CNN_CHANCE = 0.2
# phase 2, the drain's seed axis: (R, J, N, M, K, ring rows) at the EMNIST
# plane for R in {1, 2, 4, 8} and the wide route at N = M = 100; seed r has
# (r + 3) % (J + 1) live buckets, so every R >= 2 has a seed with none live
SEED_DRAIN_CASES = {**{f"R={r} J=3 N=M=25 K=146447": (r, 3, 25, 25, 146_447, 4)
                       for r in (1, 2, 4, 8)},
                    "wide R=2 J=3 N=M=100 K=146447": (2, 3, 100, 100, 146_447, 4)}
SEED_TIMES_R = 4  # phase 9's seed-axis row, every seed 3 live
# phase 13: benchmarks/fig4_psi_sweep.py's grid at fig3_config(), 4 seeds,
# 120 windows (the reference runs 600) with an eval every 20. Each Psi's
# seed-mean final accuracy must reach 0.8 x the smallest final accuracy
# of the JAX reference over 2 setups x 4 seeds on the CPU
# (scripts/fig4_reference_floors.py: 0.0400, 0.0852, 0.1296, 0.2861,
# 0.3414; PERF.md PR 19)
SWEEP_PSIS, SWEEP_SEEDS, SWEEP_WINDOWS, SWEEP_EVAL = (1, 2, 4, 8, 24), 4, 120, 20
SWEEP_FLOORS = {1: 0.032, 2: 0.0681, 4: 0.1037, 8: 0.2289, 24: 0.2731}
SWEEP_ROW_PSI, SWEEP_ROW_SEED, SWEEP_STEADY = 4, 1, 30
# phase 14: the event engine at fig3_config() as an EventConfig (poly
# staleness, a = 0.5), one tape of horizon 300 s; the event-triggered
# threshold (0.2: the JAX reference suppresses 64.3% of tape 0's TX rows,
# 50.0% being empty backlogs) and the accuracy floors (0.8 x the smallest
# over 3 tape seeds: 0.7260, 0.6918, 0.7210) from
# scripts/fig4_reference_floors.py (PERF.md PR 19)
EVENT_HORIZON, EVENT_TAPE_SEED, EVENT_PLAIN, EVENT_PROFILE = 300.0, 0, 300, 100
EVENT_TRIGGER = 0.2
EVENT_FLOORS = {"draco-event": 0.5808, "fedasync-gossip": 0.5535, "event-triggered": 0.5768}
FEDASYNC_WINDOWS = 240
# phase 19: the entry points. (a) benchmarks/torch_run.py's draco_window
# bench at its full shape (the fig3 EMNIST setup, N = 25, D = 8): the
# legacy engine against the fused window, from one seed on shared draws
ENTRY_WINDOWS, ENTRY_WARMUP = 50, 5
ENTRY_DEPTH = 8
# (b) the kernels each torch_run bench reaches (at quick=True); (c) each
# example's reduced arguments and the kernels it reaches
BENCH_KERNELS = {"gossip": ("mix",), "ssd": ("ssd_chunk",), "draco_window": ("drain",),
                 "simulate_fused": ("drain",), "sweep": ("drain",), "tasks": ("drain",),
                 "events": ("drain",), "fig3": ("drain", "mix"), "fig4": ("drain",),
                 "fig_dynamic": ("drain",), "decode": ()}
EXAMPLES = {"quickstart": (["--windows", "120"], ("drain",)),
            "dynamic_topology": (["--windows", "60"], ("drain",)),
            "event_timeline": (["--horizon", "20"], ("drain",)),
            "seed_sweep": (["--windows", "40"], ("drain",)),
            "task_zoo": (["--windows", "40"], ("drain",)),
            "train_lm_federated": (["--reduced", "--steps", "6", "--seq", "64"], ("mix",)),
            "wireless_sim": ([], ("drain",)),
            "serve_batched": ([], ())}


def log(msg):
    print(msg, flush=True)


PHASE_TIMES = []  # (label, wall seconds) of each phase the whole run timed


def timed(label, fn, *args):
    """`fn(*args)`, its wall time kept in `PHASE_TIMES`."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_TIMES.append((label, time.perf_counter() - t0))
    return out


PROFILER = {"sessions": 0, "s": 0.0}  # the profiler's own set-up, tear-down and tables


@contextlib.contextmanager
def card_profile():
    """`torch.profiler.profile` of the host and the card, its own seconds
    (entering, leaving and `device_rows`' table) kept in `PROFILER`."""
    from torch.profiler import ProfilerActivity, profile

    PROFILER["sessions"] += 1
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        PROFILER["s"] += time.perf_counter() - t0
        yield prof
        t0 = time.perf_counter()
    PROFILER["s"] += time.perf_counter() - t0


def paper_config(rate, num_clients=None):
    """(DracoConfig, mlp Task) at `repro_torch.configs.draco_paper.EMNIST`:
    its clients (or `num_clients`), the cycle, the wireless channel with
    its message size and Gamma_max 10 s, its lr, batch and B, Psi = 6, D =
    4, P = 50, and Poisson rates lambda_grad = lambda_tx = `rate`."""
    from repro_torch.configs.draco_paper import EMNIST
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.protocol import DracoConfig
    from repro_torch.tasks import get_task

    cfg = DracoConfig(
        num_clients=num_clients or EMNIST.num_clients, lr=EMNIST.lr,
        local_batches=EMNIST.local_batches, batch_size=EMNIST.batch_size,
        lambda_grad=rate, lambda_tx=rate, unify_period=50, psi=6,
        topology="cycle", max_delay_windows=4,
        channel=ChannelConfig(message_bytes=EMNIST.message_bytes, gamma_max=10.0))
    task = get_task("mlp", input_dim=EMNIST.input_dim, hidden=EMNIST.hidden,
                    num_classes=EMNIST.num_classes, per_client=EMNIST.samples_per_client)
    return cfg, task


def emnist_config(num_clients=None):
    """The reference's examples/quickstart.py: EMNIST at lambda 0.3."""
    return paper_config(0.3, num_clients)


def fig3_config(num_clients=None):
    """benchmarks/fig3_convergence.py:setup("emnist"): EMNIST at its own
    lambda_grad (0.1) for both rates."""
    from repro_torch.configs.draco_paper import EMNIST

    return paper_config(EMNIST.lambda_grad, num_clients)


def drain_case(torch, j, n, m, k, s, live, dtype, seed, slots=None):
    """w_stack (J, N, M), ring (S, N, K), slots: a row-stochastic Q split
    over the live delay buckets, `live` the number of leading live
    buckets or the tuple of live bucket indices; `slots` the J ring rows
    (default: oldest first, ending at row S - 1, as the main path)."""
    live = tuple(range(live)) if isinstance(live, int) else tuple(live)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.rand((n, m), generator=g, device="cuda")
    q = q / q.sum(dim=1, keepdim=True)
    pick = torch.randint(0, max(len(live), 1), (n, m), generator=g, device="cuda")
    w = torch.stack([q * (pick == live.index(b)) if b in live else torch.zeros_like(q)
                     for b in range(j)])
    ring = torch.randn((s, n, k), generator=g, device="cuda").to(dtype)
    if slots is None:
        slots = [(s - 1 - a) % s for a in range(j, 0, -1)]  # widx = s-1, oldest first
    return w.float().contiguous(), ring, list(slots)


def bound_ms(kernel, *shape, tensor_cores=None, **kw):
    """(ms, "bytes" or "operations"): the least time of one call of
    `kernel` (drain, mix, enqueue, ssd_chunk) at `shape`, its work from
    `repro_torch.kernels.work` (each input read once, each output written
    once; the products at their type's rate) at the H100 SXM's rates
    (`repro_torch.launch.roofline.H100_SXM`). With `tensor_cores` (the
    payload's element bytes), its products as the wide route runs them,
    split-TF32 on the tensor cores."""
    from repro_torch.kernels import work
    from repro_torch.launch.roofline import H100_SXM

    w = getattr(work, kernel)(*shape, **kw)
    if tensor_cores is not None:
        w = work.tensor_core(w, tensor_cores)
    t, by = work.bound_s(w, H100_SXM)
    return t * 1e3, by


def mix_case(torch, n, k, dtype, seed):
    """q (N, N) row-stochastic f32 and deltas (N, K) in `dtype`."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.rand((n, n), generator=g, device="cuda")
    q = q / q.sum(dim=1, keepdim=True)
    deltas = torch.randn((n, k), generator=g, device="cuda").to(dtype)
    return q, deltas


def mix_against_plain(torch, ops, q, deltas, got, rtol=RTOL):
    """(max |kernel - plain|, agree?) over column slices, so that a
    multi-GB plane needs no second full-size plain result; each slice
    copied dense first (a row stride past 2^31 is no GEMM's)."""
    worst, ok = 0.0, True
    for lo in range(0, deltas.shape[1], SLICE):
        want = ops.gossip_mix_reference(q, deltas[:, lo:lo + SLICE].contiguous()).float()
        part = got[:, lo:lo + SLICE].float()
        worst = max(worst, float((part - want).abs().max()))
        ok = ok and bool(torch.allclose(part, want, rtol=rtol, atol=ATOL))
        ok = ok and bool(torch.isfinite(part).all())
    return worst, ok


def device_rows(prof):
    """(device us, kernel name, count) per kernel of a profiler run, summed
    over the run's raw device events (`key_averages` builds a Python
    event for every host op first: seconds a session)."""
    from torch.autograd import DeviceType

    t0 = time.perf_counter()
    rows = {}
    results = getattr(prof.profiler, "kineto_results", None)
    if results is None:  # a torch without the raw results: the averaged table
        for evt in prof.key_averages():
            dev = getattr(evt, "self_device_time_total", 0.0)
            if evt.device_type == DeviceType.CUDA and dev > 0:
                rows[evt.key] = [dev, evt.count]
    else:
        for evt in results.events():
            if evt.device_type() == DeviceType.CUDA and evt.duration_ns() > 0:
                row = rows.setdefault(evt.name(), [0.0, 0])
                row[0] += evt.duration_ns() / 1e3
                row[1] += 1
    PROFILER["s"] += time.perf_counter() - t0
    return [(dev, name, count) for name, (dev, count) in rows.items()]


def time_ms(torch, fn, reps=60, flush=None):
    """Median over `reps` launches of CUDA-event time, L2 flushed before each.

    A spin kernel ahead of the start event keeps the card busy while the
    host enqueues the start event, the call and the end event, so the
    interval holds device time only and no host launch gap. (A call that
    reads the device itself, as the plain drain does, still waits.)"""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        times.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in times)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def phase_build():
    """Every kernel source, and the one-term variant of ssd_chunk.cu that
    phase 16 plants (`MIX_FAULT_TAIL`), one nvcc each, all together."""
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd import variants

    t0 = time.perf_counter()
    paths = build.build(texts={"ssd_chunk-one-term": variants.variant_source("one-term")})
    log(f"phase 1 build: {len(paths)} CUDA source(s) in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, path in paths.items():
        log(f"  {name}: {ptxas_summary(path)}")
    return paths


def ptxas_summary(lib_path):
    """Instances, their register range and the ones that spill, from a
    library's ptxas report (``<lib>.log``)."""
    report = lib_path.with_suffix(".log")
    text = report.read_text() if report.exists() else ""
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
    if not regs:
        return "no ptxas report"
    spilled = re.findall(r"Function properties for (\S+)\n.*?(\d+) bytes spill stores", text)
    spilled = [f"{name} ({b} bytes)" for name, b in spilled if int(b)]
    return (f"{len(regs)} kernel instance(s), {min(regs)}-{max(regs)} registers; spill "
            f"stores in {', '.join(spilled) if spilled else 'none'}")


# (J, N, M, K, ring rows, live buckets, slots): the main path's shapes
# (most Psi-capped buckets are empty), D in {2, 4, 8}, rectangular both
# ways, N = M = 64, payload rows at every 4- and 2-byte phase (N = 5, odd
# K) and K under one tile, slots out of the main path's order, empty
# buckets between live ones, and the largest staging (J = 7, N = M = 64)
DRAIN_CASES = {
    "main J=3 N=M=25 K=146447 live=0": (3, 25, 25, 146_447, 4, 0, None),
    "main J=3 N=M=25 K=146447 live=1": (3, 25, 25, 146_447, 4, 1, None),
    "main J=3 N=M=25 K=146447 live=3": (3, 25, 25, 146_447, 4, 3, None),
    "N=7 K=1000 D=2": (1, 7, 7, 1000, 2, 1, None),
    "N=7 K=1000 D=4": (3, 7, 7, 1000, 4, 3, None),
    "N=7 K=1000 D=8": (7, 7, 7, 1000, 8, 7, None),
    "rectangular J=3 N=8 M=16 K=5000": (3, 8, 16, 5000, 4, 3, None),
    "senders > receivers J=3 N=16 M=8 K=5000": (3, 16, 8, 5000, 4, 3, None),
    "N=M=64 K=2049": (3, 64, 64, 2049, 4, 2, None),
    **{f"aligned N=M=5 K={k}": (3, 5, 5, k, 4, 3, None) for k in (1, 3, 8, 4096, 4099)},
    "slots [2, 0, 3] K=4099": (3, 25, 25, 4099, 4, 3, (2, 0, 3)),
    "live 0, 2, 4 of J=5 K=4099": (5, 25, 25, 4099, 6, (0, 2, 4), None),
    "largest staging J=7 N=M=64 K=4099": (7, 64, 64, 4099, 8, 7, None),
    # the wide route: N = M past 64, rectangular across 64 both ways, and
    # bucket sets whose weights overflow the narrow route's block
    **{f"wide N=M={n} K={k}": (3, n, n, k, 4, 3, None) for n in WIDE_N for k in WIDE_K},
    "wide N=100 M=40 K=4099": (3, 100, 40, 4099, 4, 3, None),
    "wide N=40 M=100 K=4099": (3, 40, 100, 4099, 4, 3, None),
    "J=8 N=M=64 K=4099": (8, 64, 64, 4099, 9, 8, None),
    "J=16 N=M=64 K=4099": (16, 64, 64, 4099, 17, 16, None),
}
ROUTES = {"narrow": 0, "wide": 1, None: -1}


def phase_kernels(torch):
    from repro_torch.kernels.gossip import ops

    lib = ops._drain_lib()
    limit = ops._max_smem("drain", 0)
    worst = 0.0
    for i, (label, (j, n, m, k, s, live, slots)) in enumerate(DRAIN_CASES.items()):
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = int(dtype == torch.bfloat16)
            route = ops.drain_route(j, n, m, dtype, limit)
            if ops.drain_smem_bytes(j, n, m, dtype) != lib.drain_smem_bytes(j, n, m, bf16) \
                    or ops.wide_smem_bytes(j, n, dtype) != lib.drain_wide_smem_bytes(j, n, bf16) \
                    or ROUTES[route] != lib.drain_route(j, n, m, bf16):
                raise AssertionError(f"drain shared memory or route reckoned apart: {label}")
            w, ring, slots_ = drain_case(torch, j, n, m, k, s, live, dtype, seed=i, slots=slots)
            got = ops.gossip_drain(w, ring, slots_)
            ref = ops.gossip_drain_reference(w, ring, slots_)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            ok = bool(torch.allclose(got, ref, rtol=RTOL, atol=ATOL))
            worst = max(worst, err)
            name = f"{label} {'bf16' if dtype == torch.bfloat16 else 'f32'}"
            log(f"  drain {name} ({route}): max_abs_err={err:.3e} {'ok' if ok else 'FAIL'}")
            if not ok or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"drain kernel disagrees with its plain version: {name}")
    log(f"phase 2 kernels: gossip_drain max_abs_err={worst:.3e} "
        f"(tolerance rtol={RTOL} atol={ATOL}) over {2 * len(DRAIN_CASES)} cases")
    return worst


def seed_drain_case(torch, r, j, n, m, k, s, dtype, seed, live=None):
    """The seed axis: (R, J, N, M) weights and an (R, S, N, K) ring from R
    `drain_case`s, seed i with ``live(i)`` live buckets (default ``(i + 3)
    % (J + 1)``), the slots shared."""
    live = live or (lambda i: (i + 3) % (j + 1))
    parts = [drain_case(torch, j, n, m, k, s, live(i), dtype, seed=seed + i) for i in range(r)]
    return (torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts]),
            parts[0][2])


def phase_seed_kernels(torch):
    """Phase 2, the drain's seed axis: one launch for R seeds whose live
    sets differ (one with none live), each row equal to a solo launch on
    it (max |diff| 0) and within RTOL/ATOL of the plain version, in f32
    and bf16, on the narrow route (R in {1, 2, 4, 8}) and the wide one."""
    from repro_torch.kernels.gossip import ops

    worst = 0.0
    for i, (label, (r, j, n, m, k, s)) in enumerate(SEED_DRAIN_CASES.items()):
        for dtype in (torch.float32, torch.bfloat16):
            name = f"{label} {'bf16' if dtype == torch.bfloat16 else 'f32'}"
            w, ring, slots = seed_drain_case(torch, r, j, n, m, k, s, dtype, seed=900 + 10 * i)
            before = ops.gossip_drain.launches
            got = ops.gossip_drain(w, ring, slots)
            launches = ops.gossip_drain.launches - before
            solo_gap = max(float((got[q] - ops.gossip_drain(w[q], ring[q], slots)).abs().max())
                           for q in range(r))
            ref = ops.gossip_drain_reference(w, ring, slots)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            ok = bool(torch.allclose(got, ref, rtol=RTOL, atol=ATOL)) and launches == 1 \
                and solo_gap == 0.0 and bool(torch.isfinite(got).all())
            worst = max(worst, err)
            log(f"  drain seed axis {name}: 1 launch, max |row - solo launch| = "
                f"{solo_gap:.1e}, max_abs_err={err:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"drain seed axis: {name} ({launches} launches, solo gap "
                                     f"{solo_gap}, error {err})")
            del w, ring, got, ref
    torch.cuda.empty_cache()
    log(f"phase 2 kernels: gossip_drain seed axis max_abs_err={worst:.3e} over "
        f"{2 * len(SEED_DRAIN_CASES)} cases, every row equal to its solo launch")
    return worst


def phase_main(torch):
    from repro_torch.api import make_context, simulate
    from repro_torch.core import protocol
    from repro_torch.kernels.gossip import ops

    cfg, task = emnist_config()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params0 = task.init_params(gen)
    data, eval_data = task.make_data(gen, cfg.num_clients)
    ctx = make_context(cfg, task=task, data=data, params0=params0)
    torch.cuda.synchronize()

    ops.gossip_drain.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, trace = simulate("draco", cfg, params0, data=data, num_steps=WINDOWS,
                            task=task, key=SEED + 1, eval_every=EVAL_EVERY,
                            eval_data=eval_data, ctx=ctx)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.gossip_drain.launches
    for step, acc, cons in zip(trace.step, trace.metrics["accuracy"],
                               trace.metrics["consensus"]):
        log(f"  window {int(step):4d}: mean client acc {float(acc):.4f}, "
            f"consensus distance {float(cons):.6f}")
    accepted = int(state.total_accept.sum())
    log(f"  msgs accepted total {accepted}; drain launches {launches}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    log(f"  {WINDOWS} windows + {len(trace.step)} evals in {wall:.3f} s: "
        f"{wall / WINDOWS * 1e3:.3f} ms/window")
    if launches != WINDOWS:
        raise AssertionError(f"drain launched {launches} times in {WINDOWS} windows")
    finite = all(np.isfinite(v).all() for v in trace.metrics.values()) and all(
        bool(torch.isfinite(p).all()) for p in state.params.values())
    if not finite:
        raise AssertionError("non-finite metrics or params")
    if float(trace.metrics["accuracy"][-1]) < 0.5:
        raise AssertionError(f"final accuracy {trace.metrics['accuracy'][-1]} < 0.5")

    # steady state, no host sync: a fresh run under the sync detector
    st = protocol.init_state(SEED + 2, cfg, params0)
    st = protocol.run_windows(st, cfg, ctx.q, ctx.adj, task, data, 5)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            st = protocol.run_windows(st, cfg, ctx.q, ctx.adj, task, data, 100)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    steady = (time.perf_counter() - t0) / 100 * 1e3
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    log(f"  steady state: {steady:.3f} ms/window over 100 windows; "
        f"host syncs in the loop: {len(syncs)}")
    if syncs:
        raise AssertionError(f"host sync inside the window loop: {syncs[0]}")
    profile_windows(torch, protocol, st, cfg, ctx, task, data, steady)
    log(f"phase 3 main: final accuracy {float(trace.metrics['accuracy'][-1]):.4f}")
    return launches, wall / WINDOWS * 1e3, steady, ctx, params0, data


def profile_windows(torch, protocol, st, cfg, ctx, task, data, steady_ms):
    """Device time by kernel over 20 profiled windows, and the device's
    busy share of an unprofiled steady window (`steady_ms`)."""
    try:
        with card_profile() as prof:
            t0 = time.perf_counter()
            protocol.run_windows(st, cfg, ctx.q, ctx.adj, task, data, 20)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        rows = device_rows(prof)
    except (RuntimeError, AttributeError) as exc:
        log(f"  profiler: not measured ({exc})")
        return
    busy = sum(r[0] for r in rows)
    if busy <= 0:
        log("  profiler: no device time recorded (not measured)")
        return
    per_window_us = busy / 20
    share = per_window_us / (steady_ms * 1e3)
    log(f"  profiler over 20 windows: device busy {per_window_us:.1f} us/window "
        f"({wall_us / 20:.1f} us/window wall under the profiler); against the "
        f"unprofiled steady window: {100 * share:.2f}% busy, "
        f"{100 - 100 * share:.2f}% idle")
    for dev, key, count in sorted(rows, reverse=True)[:8]:
        log(f"    {dev / 20:9.2f} us/window  {count:5d}x  {key[:90]}")
    for dev, key, count in rows:
        if "drain_kernel" in key:
            log(f"  drain row: {dev / 20:.2f} us/window, {count}x, {dev / count:.2f} us "
                f"per launch ({key[:60]})")


def phase_plain(torch, ctx, params0, data):
    from repro_torch.core import protocol
    from repro_torch.kernels.gossip import ops

    cfg, task = ctx.cfg, ctx.task
    runs = {}
    for name, drain in (("kernel", None), ("plain", ops.gossip_drain_reference)):
        st = protocol.init_state(SEED + 3, cfg, params0)
        runs[name] = protocol.run_windows(st, cfg, ctx.q, ctx.adj, task, data,
                                          PLAIN_WINDOWS, drain=drain)
    torch.cuda.synchronize()
    worst = 0.0
    for k in runs["kernel"].params:
        a, b = runs["kernel"].params[k], runs["plain"].params[k]
        worst = max(worst, float((a - b).abs().max()))
        if not torch.allclose(a, b, rtol=PATH_TOL, atol=PATH_TOL):
            raise AssertionError(f"kernel path and plain path differ in {k}")
    same_accept = torch.equal(runs["kernel"].total_accept, runs["plain"].total_accept)
    log(f"phase 4 plain: {PLAIN_WINDOWS} windows, kernel vs plain drain "
        f"max |dparams| = {worst:.3e} (tolerance {PATH_TOL}); same acceptances "
        f"{same_accept}")
    if not same_accept:
        raise AssertionError("kernel path and plain path accepted different messages")


def phase_mix_kernels(torch):
    from repro_torch.kernels.gossip import ops

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(f"N={n} K={k} f32", n, k, f32, 0) for n in MIX_N for k in MIX_K]
    cases += [(f"N={n} K={k} bf16", n, k, bf16, 0) for n in MIX_N for k in (5, 4099, 146_447)]
    cases += [("N=25 K=513 bf16", 25, 513, bf16, 0)]
    cases += [(f"N={BIG_MIX[0]} K={BIG_MIX[1]} f32 (N*K > 2^31)", *BIG_MIX, f32, 0)]
    cases += [(f"N={VLM_MIX[0]} K={VLM_MIX[1]} f32 (the vlm plane: K > 2^31, K % 4 = 2)",
               *VLM_MIX, f32, 0)]
    cases += [(f"N={n} K={k} {name}", n, k, dtype, 0) for n in MIX_WIDE_N for k in WIDE_K
              for name, dtype in (("f32", f32), ("bf16", bf16))]
    cases += [(f"N={n} K=4099 {name}", n, 4099, dtype, 0) for n in (272, 273, 1000)
              for name, dtype in (("f32", f32), ("bf16", bf16))]
    cases += [(f"rows off 16 bytes N={n} K={k} {name}", n, k, dtype, 1)
              for n, k in ((4, 4096), (25, 4099), (100, 4099))
              for name, dtype in (("f32", f32), ("bf16", bf16))]
    lib, limit = ops._mix_lib(), ops._max_smem("mix", 0)
    shape = (ctypes.c_int * 2)()
    worst = 0.0
    for i, (label, n, k, dtype, offset) in enumerate(cases):
        is_bf16 = int(dtype == bf16)
        route = ops.mix_route(n, dtype, limit)
        if ops.MIX_ROUTES.index(route) != lib.mix_route(n, is_bf16):
            raise AssertionError(f"mix route reckoned apart: {label}")
        if route == "tensor" and (lib.mix_tensor_shape(n, is_bf16, shape) != 1
                                  or tuple(shape) != ops.mix_tensor_shape(n, dtype, limit)):
            raise AssertionError(f"mix receiver groups reckoned apart: {label}")
        if route == "wide" and ops.wide_smem_bytes(1, n, dtype) != lib.mix_wide_smem_bytes(
                n, is_bf16):
            raise AssertionError(f"mix shared memory reckoned apart: {label}")
        q, deltas = mix_case(torch, n, k, dtype, seed=1000 + i)
        if offset:  # the same plane one element into its storage
            flat = torch.empty(n * k + offset, dtype=dtype, device="cuda")
            flat[offset:].copy_(deltas.flatten())
            deltas = flat[offset:].view(n, k)
        got = ops.gossip_mix(q, deltas)
        torch.cuda.synchronize()
        if got.dtype != dtype or tuple(got.shape) != (n, k):
            raise AssertionError(f"mix kernel returned {got.dtype} {tuple(got.shape)}")
        tc_bf16 = is_bf16 and route != "narrow"
        err, ok = mix_against_plain(torch, ops, q, deltas, got,
                                    rtol=WIDE_BF16_RTOL if tc_bf16 else RTOL)
        worst = max(worst, err)
        if n * k > 10**6 or not ok:
            log(f"  mix {label} ({route}): max_abs_err={err:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"mix kernel disagrees with its plain version: {label}")
        del q, deltas, got
        if n * k > 10**9:
            torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    log(f"phase 2 kernels: gossip_mix max_abs_err={worst:.3e} (tolerance "
        f"rtol={RTOL} atol={ATOL}; the tensor and wide routes in bf16 rtol={WIDE_BF16_RTOL}) "
        f"over {len(cases)} cases")
    return worst


def ssd_case(torch, bb, h, g, nc, q, n, p, decay, dtype, seed):
    """The SSD intra-chunk inputs as `ssm_block` hands them to the kernel:
    x, B and C are views of one (Bb, T, H * P + 2 * G * N) tensor (B and
    C one per group, never repeated over heads), dt = softplus(N(0, 1))
    (+1 under a strong decay), A = -decay * (1..H) as at the mamba2 init,
    cums = cumsum(dt * A) per chunk."""
    g_ = torch.Generator(device="cuda").manual_seed(seed)
    dtype = getattr(torch, dtype)
    t = nc * q
    proj = torch.randn((bb, t, h * p + 2 * g * n), generator=g_, device="cuda").to(dtype)
    x = proj[..., :h * p].reshape(bb, nc, q, h, p).permute(0, 3, 1, 2, 4)
    B = proj[..., h * p:h * p + g * n].reshape(bb, nc, q, g, n).permute(0, 3, 1, 2, 4)
    C = proj[..., h * p + g * n:].reshape(bb, nc, q, g, n).permute(0, 3, 1, 2, 4)
    dt = torch.nn.functional.softplus(
        torch.randn((bb, h, nc, q), generator=g_, device="cuda"))
    if decay > 1:
        dt = dt + 1.0
    a = -decay * torch.arange(1, h + 1, dtype=torch.float32, device="cuda")
    cums = torch.cumsum(dt * a[None, :, None, None], dim=-1)
    return C, B, x, cums, dt


def ssd_bound_ms(args):
    """`bound_ms` of one ssd_chunk call on these inputs: the bytes against
    the necessary products on the tensor cores at f32 accuracy
    (`repro_torch.kernels.work.ssd_chunk`)."""
    C, B, x, cums, dt = args
    bb, g, nc, q, n = C.shape
    return bound_ms("ssd_chunk", bb, x.shape[1], g, nc, q, n, x.shape[4], x.element_size())


def phase_ssd_kernels(torch):
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_chunk_ref

    worst = 0.0
    for i, (label, case) in enumerate(SSD_CASES.items()):
        args = ssd_case(torch, *case, seed=2000 + i)
        got = ssd_ops.ssd_chunk(*args)
        torch.cuda.synchronize()
        want = ssd_chunk_ref(*args)
        errs = []
        for name, a, b in zip("YS", got, want):
            if a.shape != b.shape or a.dtype != torch.float32:
                raise AssertionError(f"ssd_chunk returned {name} {a.dtype} {tuple(a.shape)}")
            err, scale = float((a - b).abs().max()), float(b.abs().max())
            finite = bool(torch.isfinite(a).all())
            errs.append((name, err, scale))
            worst = max(worst, err)
            if not finite or err > SSD_REL_TOL * scale:
                raise AssertionError(f"ssd_chunk kernel disagrees with its plain version: "
                                     f"{label}: {name} max |err| {err} vs largest |{name}| "
                                     f"{scale}")
        log(f"  ssd_chunk {label} {tuple(args[2].shape)}: " + ", ".join(
            f"{nm} max_abs_err={e:.3e} (largest |{nm}| {sc:.3e}, rel {e / sc:.2e})"
            for nm, e, sc in errs) + " ok")
        del args, got, want
    torch.cuda.empty_cache()
    log(f"phase 2 kernels: ssd_chunk max_abs_err={worst:.3e} (tolerance {SSD_REL_TOL} of "
        f"the largest |Y|, |S|) over {len(SSD_CASES)} cases")
    return worst


def enqueue_case(torch, j, n, k, dtype, seed):
    """w_stack (J, N, N): a row-stochastic Q split by a per-link delay
    bucket; pending (N, K) in `dtype`."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.softmax(torch.randn((n, n), generator=g, device="cuda"), dim=1)
    delay = torch.randint(0, j, (n, n), generator=g, device="cuda")
    w = torch.stack([q * (delay == b) for b in range(j)]).contiguous()
    pending = torch.randn((n, k), generator=g, device="cuda").to(dtype)
    return w, pending


def phase_enqueue(torch):
    """The enqueue's path: its wrapper driven at the JAX package's own
    cases and the windowed path's width, f32 and bf16 in, f32 and bf16
    out, with the launch count set to 0 before and read after; then each
    output against the plain version (which launches nothing)."""
    from repro_torch.kernels.gossip import ops

    calls = []
    for i, (j, n, k) in enumerate(ENQ_PATH):
        args = enqueue_case(torch, j, n, k, torch.float32, 3000 + i)
        calls.append((f"J={j} N={n} K={k} f32", args, torch.float32))
    w, p16 = enqueue_case(torch, *ENQ_MAIN, torch.bfloat16, 3100)
    calls.append(("J=3 N=25 K=146447 bf16 -> f32", (w, p16), torch.float32))
    calls.append(("J=3 N=25 K=146447 bf16 -> bf16", (w, p16), torch.bfloat16))
    for i, (j, n, k) in enumerate(ENQ_WIDE):  # the wide route
        args = enqueue_case(torch, j, n, k, torch.float32, 3200 + i)
        calls.append((f"wide J={j} N={n} K={k} f32", args, torch.float32))
    w, p16 = enqueue_case(torch, 3, 100, 4099, torch.bfloat16, 3300)
    calls.append(("wide J=3 N=100 K=4099 bf16 -> f32", (w, p16), torch.float32))
    lib, limit = ops._enqueue_lib(), ops._max_smem("enqueue", 0)
    for label, (w, pending), _ in calls:
        j, n, bf16 = w.shape[0], w.shape[1], int(pending.dtype == torch.bfloat16)
        route = ops.enqueue_route(j, n, pending.dtype, limit)
        if ROUTES[route] != lib.enqueue_route(j, n, bf16) or ops.wide_smem_bytes(
                j, n, pending.dtype) != lib.enqueue_wide_smem_bytes(j, n, bf16):
            raise AssertionError(f"enqueue shared memory or route reckoned apart: {label}")
    reset_launches()
    outs = [ops.gossip_enqueue(*args, out_dtype=od) for _, args, od in calls]
    torch.cuda.synchronize()
    launches = launch_counts()["enqueue"]
    if launches != len(calls):
        raise AssertionError(f"enqueue launched {launches} times in {len(calls)} calls")
    worst = 0.0
    for (label, (w, pending), od), got in zip(calls, outs):
        want = ops.gossip_enqueue_reference(w, pending, out_dtype=torch.float32)
        if od == torch.float32:
            err = float((got - want).abs().max())
            ok = bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL))
            worst = max(worst, err)
        else:  # the kernel's own f32 sums, rounded once
            f32 = outs[[c[0] for c in calls].index("J=3 N=25 K=146447 bf16 -> f32")]
            err = float((got.float() - want).abs().max())
            ok = torch.equal(got, f32.to(torch.bfloat16)) and bool(torch.allclose(
                got.float(), want.to(torch.bfloat16).float(), rtol=2.0 ** -8, atol=ATOL))
        ok = ok and bool(torch.isfinite(got).all()) and got.dtype == od
        if pending.shape[1] > 10**5 or label.startswith("wide") or not ok:
            log(f"  enqueue {label}: max_abs_err={err:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"enqueue kernel disagrees with its plain version: {label}")
    # buckets partition the edge set: they sum to the full mix
    w, pending = calls[8][1]
    full = ops.gossip_mix_reference(w.sum(0), pending)
    if not torch.allclose(outs[8].sum(0), full, rtol=1e-4, atol=1e-4):
        raise AssertionError("enqueue buckets do not sum to the full mix")
    del calls, outs
    torch.cuda.empty_cache()
    log(f"phase 2 kernels: gossip_enqueue {launches} launches over its path, "
        f"max_abs_err={worst:.3e} (f32 out, tolerance rtol={RTOL} atol={ATOL}; bf16 out "
        f"equal to the kernel's f32 sums rounded once, and within one bf16 step of "
        f"the plain version); buckets sum to the full mix")
    return launches, worst


def phase_new_times(torch):
    """ssd_chunk at the zamba2 trainer's shape, at a (16, 16) rank's 5
    local heads of mamba2 x train_4k and at the mamba2 trainer's shape
    (the last returned), the enqueue at the windowed path's width: kernel,
    plain version, library call, bound."""
    from repro_torch.kernels.gossip import ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_chunk_ref

    flush = torch.empty(96 * 2**20 // 4, device="cuda")  # > the 50 MB L2
    for shape in (SSD_ZAMBA2, SSD_TP_LOCAL, SSD_MAIN):
        args = ssd_case(torch, *shape, seed=4000)
        kern = time_ms(torch, lambda: ssd_ops.ssd_chunk(*args), reps=30, flush=flush)
        plain = time_ms(torch, lambda: ssd_chunk_ref(*args), reps=30, flush=flush)
        bound, by = ssd_bound_ms(args)
        ssd = dict(ms=kern, plain_ms=plain, library_ms=None, bound_ms=bound, bound_by=by)
        log(f"  ssd_chunk {tuple(args[2].shape)} N={shape[5]} bf16: kernel {kern:.4f} ms, "
            f"bound {bound:.4f} ms ({by}, {100 * bound / kern:.1f}% of bound), plain "
            f"{plain:.4f} ms, library: none (no one PyTorch call computes the masked SSD "
            f"step)")
        del args
    j, n, k = ENQ_MAIN
    w, pending = enqueue_case(torch, j, n, k, torch.float32, 4100)
    kern = time_ms(torch, lambda: ops.gossip_enqueue(w, pending), flush=flush)
    read = time_ms(torch, lambda: ops.gossip_enqueue(w, pending), flush=flushes(torch)["read"])
    plain = time_ms(torch, lambda: ops.gossip_enqueue_reference(w, pending), flush=flush)
    buf, wt = torch.empty((j, n, k), device="cuda"), w.transpose(1, 2)
    lib = time_ms(torch, lambda: torch.matmul(wt, pending, out=buf), flush=flush)
    bound, by = bound_ms("enqueue", j, n, k, 4, 4)
    enq = dict(ms=kern, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by)
    log(f"  enqueue J={j} N={n} K={k} f32: kernel {kern:.4f} ms (read flush {read:.4f}), "
        f"bound {bound:.4f} ms "
        f"({by}, {100 * bound / kern:.1f}% of bound), plain {plain:.4f} ms, library "
        f"matmul {lib:.4f} ms")
    return ssd, enq


def reset_launches():
    """Every kernel wrapper's launch count set to 0."""
    from repro_torch.kernels.gossip import ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    for fn in (ops.gossip_drain, ops.gossip_mix, ops.gossip_enqueue, ssd_ops.ssd_chunk):
        fn.launches = 0


def launch_counts():
    from repro_torch.kernels.gossip import ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    return {"drain": ops.gossip_drain.launches, "mix": ops.gossip_mix.launches,
            "enqueue": ops.gossip_enqueue.launches, "ssd_chunk": ssd_ops.ssd_chunk.launches}


def run_trainer(torch, argv, cfg, steps, label):
    """`repro_torch.launch.train.main(argv, cfg=cfg)` with every launch
    count set to 0 just before and read just after; checks the losses and
    one mix launch per step. Returns (launches, s/step, peak bytes)."""
    from repro_torch.launch import train

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    losses = train.main(argv, cfg=cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    ln_v = math.log(cfg.vocab_size)
    log(f"  trainer: {steps} steps of {cfg.name} ({cfg.num_layers} layers, "
        f"d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}) in {wall:.3f} s with init and data ({wall / steps:.4f} "
        f"s/step); launches {launches}; peak device memory "
        f"{peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB)")
    log(f"  losses: first {losses[0]:.6f} (ln V = {ln_v:.6f}), last {losses[-1]:.6f}; "
        + " ".join(f"{x:.4f}" for x in losses))
    if launches["mix"] != steps:
        raise AssertionError(f"mix launched {launches['mix']} times in {steps} steps")
    if not all(math.isfinite(x) for x in losses) or len(losses) != steps:
        raise AssertionError(f"trainer losses not finite: {losses}")
    if not ln_v - 1 <= losses[0] <= ln_v + 3:
        raise AssertionError(f"first loss {losses[0]} outside [ln V - 1, ln V + 3]")
    log(f"phase {label} trainer: ok, {wall / steps:.4f} s/step")
    return launches, wall / steps, peak


def phase_trainer(torch):
    from repro_torch.configs.base import get_config

    launches, s_step, peak = run_trainer(torch, TRAIN_ARGS, get_config("qwen2-1.5b"),
                                         TRAIN_STEPS, "5")
    return launches["mix"], s_step, peak


def leaf_gaps(flat_lib, params, ref):
    """Leaf name -> (sum p - sum r, sum |p - r|, sum |r|) of the tree
    `params` against the tree `ref`, on the card, a client at a time,
    in f64."""
    out = {}
    for (path, leaf), r in zip(flat_lib.tree_items(params), flat_lib.tree_leaves(ref)):
        acc = [0.0, 0.0, 0.0]
        for i in range(leaf.shape[0]):
            a, b = leaf[i].double(), r[i].double()
            acc[0] += float(a.sum() - b.sum())
            acc[1] += float((a - b).abs().sum())
            acc[2] += float(b.abs().sum())
            del a, b
        out["/".join(path)] = tuple(acc)
    return out


def check_trainer_paths(runs, gaps, moved, control, faults=()):
    """Holds every path's losses and per-leaf gaps against the plain
    path's, by the rules `compare_trainer_paths` states. The control
    paths are the gaps named ``control...``; each leaf is held against
    the largest of theirs. The rule must pass the kernel path and reject
    each path named in `faults`."""
    lp = runs["plain"]
    log(f"  plain path losses {' '.join(f'{x:.6f}' for x in lp)}")
    rel, loss_gaps, sums = {}, {}, {}
    for name in gaps:
        loss_gaps[name] = [abs(a - b) / abs(b) for a, b in zip(runs[name], lp)]
        sums[name] = {k: abs(d) / max(m, 1e-30) for k, (d, _, m) in gaps[name].items()}
        worst_sum = max(sums[name], key=sums[name].get)
        line = (f"  {name} path losses {' '.join(f'{x:.6f}' for x in runs[name])}; "
                f"relative loss gap by step "
                f"{' '.join(f'{x:.3e}' for x in loss_gaps[name])}; largest per-leaf "
                f"|sum gap| / sum|p| {sums[name][worst_sum]:.3e} ({worst_sum})")
        if moved:
            rel[name] = {k: g / moved[k] if moved[k] else (math.inf if g else 0.0)
                         for k, (_, g, _) in gaps[name].items()}
            worst = max(rel[name], key=rel[name].get)
            line += (f"; largest per-leaf sum|gap| / sum|p_plain - p_init| "
                     f"{rel[name][worst]:.3e} ({worst})")
        log(line)
    if moved:
        log(f"  per leaf, sum|gap| / sum|p_plain - p_init| by path ({', '.join(rel)})"
            + (f"; the kernel's held within {CONTROL_MARGIN} x the largest control's"
               if control else ""))
        for k in sorted(moved):
            log(f"    {k}: " + " ".join(f"{r[k]:.3e}" for r in rel.values())
                + f" (sum|p_plain - p_init| {moved[k]:.6e})")
    controls = [n for n in rel if n.startswith("control")]

    def rejected(name):
        """Why the rule rejects path `name` ("" when it passes)."""
        if max(loss_gaps[name]) > TRAIN_PATH_RTOL:
            return "their losses"
        if not control:
            return ", ".join(k for k, v in sums[name].items() if v > TRAIN_PATH_RTOL)
        return ", ".join(k for k in moved
                         if rel[name][k] > CONTROL_MARGIN * max(rel[n][k] for n in controls))

    why = {name: rejected(name) for name in ["kernel", *faults]}
    for name in faults:
        log(f"  planted {name}: " + (f"rejected ({why[name]})" if why[name]
                                     else "NOT rejected"))
    if why["kernel"]:
        raise AssertionError(f"trainer kernel path and plain path differ in {why['kernel']}")
    missed = [name for name in faults if not why[name]]
    if missed:
        raise AssertionError(f"the trainer-path rule passes planted faults {missed}")


def pool_leaves(values, key):
    """Leaf name -> value (a float or a tuple of floats), summed over the
    leaves `key` maps to one name."""
    out = {}
    for leaf, v in values.items():
        k = key(leaf)
        if k not in out:
            out[k] = v
        elif isinstance(v, tuple):
            out[k] = tuple(a + b for a, b in zip(out[k], v))
        else:
            out[k] += v
    return out


def compare_trainer_paths(torch, argv, cfg, steps, plain, kernel_rows, label,
                          control=None, others=(), pool=None, faults=()):
    """`steps` (at least 3) trainer steps from one seed through the plain
    versions (`plain`: keyword arguments of `train_step`) and through the
    kernels; the kernel run takes its first step to warm up (the
    allocator grows to the step's planes there), times its second
    unprofiled and profiles the others. The plain run's parameters stay on the card as the reference.
    With `plain` None only the kernel path runs, timed and profiled.

    The paths agree when every step's loss is within `TRAIN_PATH_RTOL`
    and every leaf is. Without `control`, by |sum p_kernel - sum p_plain|
    / sum |p_plain| <= `TRAIN_PATH_RTOL` (paths equal up to the order of
    f32 sums). With `control` (keyword arguments of a third path, the
    plain one with an f32-level change, or a list of such paths), by each
    leaf's gap over its own change, sum |p - p_plain| / sum |p_plain -
    p_init|: the kernel's within `CONTROL_MARGIN` times the largest
    control's. `pool` (leaf name -> name) sums the leaves it maps to one
    name first. `others` are further (name, keyword arguments) paths
    printed leaf by leaf and not held; `faults` such paths that the rule
    must reject.
    Returns Dflat, the unprofiled step (s), the device busy time per step
    and each of `kernel_rows`' device time per step (us)."""
    from repro_torch.api import make_context
    from repro_torch.core import flat as flat_lib
    from repro_torch.core.protocol import DracoConfig
    from repro_torch.launch import train

    args = train.parse_args(argv)
    n = args.clients
    q = make_context(DracoConfig(num_clients=n, topology=args.topology, channel=None),
                     device="cuda").q
    data = train.make_batches(train.stream_seed(SEED, train.STREAM_DATA), cfg, n,
                              8 * args.batch_per_client, args.seq, device="cuda")
    gen = torch.Generator(device="cuda")
    runs, gaps, out, ref = {}, {}, {}, None
    paths = ([("plain", plain)] if plain is not None else []) + [("kernel", {})]
    controls = [control] if isinstance(control, dict) else list(control or [])
    paths += [("control" + (f" {i + 1}" if i else ""), kw) for i, kw in enumerate(controls)]
    paths += list(others) + list(faults)
    for name, kw in paths:
        params = train.init_client_params(SEED, cfg, n, "cuda")
        out["dflat"] = flat_lib.spec_of(params).dim
        losses = []

        def step(i, params):
            gen.manual_seed(train.stream_seed(SEED, train.STREAM_EVENTS, i))
            q_eff = train.mixing_weights(q, args.psi, generator=gen,
                                         lambda_tx=args.lambda_tx)
            batch = train.select_batch(data, i, args.batch_per_client)
            params, loss = train.train_step(params, batch, q_eff, cfg, args.lr, **kw)
            losses.append(float(loss))
            return params

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = step(0, params)
        if name == "kernel":
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            params = step(1, params)
            torch.cuda.synchronize()
            out["steady_s"] = time.perf_counter() - t1
            log(f"  kernel path: first step {t1 - t0:.4f} s (warm-up), second "
                f"{out['steady_s']:.4f} s")
            try:
                with card_profile() as prof:
                    t0 = time.perf_counter()
                    for i in range(2, steps):
                        params = step(i, params)
                    torch.cuda.synchronize()
                    out["profiled_s"] = (time.perf_counter() - t0) / (steps - 2)
                out["rows"] = device_rows(prof)
            except (RuntimeError, AttributeError) as exc:
                log(f"  profiler: not measured ({exc})")
                for i in range(2, steps):
                    params = step(i, params)
        else:
            for i in range(1, steps):
                params = step(i, params)
        runs[name] = losses
        if ref is None:
            ref = params
        else:
            gaps[name] = leaf_gaps(flat_lib, params, ref)
        del params
        torch.cuda.empty_cache()
    moved = {}
    if control or others or faults:
        init = train.init_client_params(SEED, cfg, n, "cuda")
        moved = {k: v[1] for k, v in leaf_gaps(flat_lib, ref, init).items()}
        del init
    del ref
    torch.cuda.empty_cache()
    if pool is not None:
        gaps = {name: pool_leaves(g, pool) for name, g in gaps.items()}
        moved = pool_leaves(moved, pool)
    if plain is not None:
        check_trainer_paths(runs, gaps, moved, control, [name for name, _ in faults])
    rows = out.get("rows") or []
    busy_us = sum(r[0] for r in rows) / (steps - 2)
    per_kernel = {k: sum(r[0] for r in rows if key in r[1]) / (steps - 2)
                  for k, key in kernel_rows.items()}
    steady_us = out["steady_s"] * 1e6
    if busy_us > 0:
        share = busy_us / steady_us
        log(f"  profiler over {steps - 2} step(s): device busy "
            f"{busy_us / 1e3:.3f} ms/step ({out['profiled_s'] * 1e3:.3f} ms/step wall "
            f"under the profiler); against the unprofiled step "
            f"({steady_us / 1e3:.3f} ms): {100 * share:.2f}% busy, "
            f"{100 - 100 * share:.2f}% idle; "
            + ", ".join(f"{k} kernel {v / 1e3:.3f} ms/step" for k, v in per_kernel.items()))
        for dev, key, count in sorted(rows, reverse=True)[:10]:
            log(f"    {dev / 1e3 / (steps - 2):9.3f} ms/step  {count:6d}x  {key[:90]}")
    else:
        log("  profiler: no device time recorded (not measured)")
    log(f"phase {label}: " + ("kernel path and plain path agree; " if plain else "")
        + f"{out['steady_s']:.4f} s/step unprofiled")
    return out["dflat"], out["steady_s"], busy_us, per_kernel


def phase_trainer_plain(torch):
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.gossip import ops

    dflat, steady_s, busy_us, per_kernel = compare_trainer_paths(
        torch, TRAIN_ARGS, get_config("qwen2-1.5b"), TRAIN_PLAIN_STEPS,
        dict(mix=ops.gossip_mix_reference), {"mix": "mix_kernel"}, "6 trainer plain")
    return dflat, steady_s, busy_us, per_kernel["mix"]


def mamba2_config():
    from repro_torch.configs.base import get_config

    return get_config("mamba2-2.7b").with_(num_layers=MAMBA_LAYERS)


def phase_mamba2(torch):
    cfg = mamba2_config()
    launches, s_step, peak = run_trainer(torch, MAMBA_ARGS, cfg, MAMBA_STEPS, "7 mamba2")
    clients = int(MAMBA_ARGS[MAMBA_ARGS.index("--clients") + 1])
    # forward and the remat recompute: two per block, client and step
    want = MAMBA_STEPS * cfg.num_layers * clients * (2 if cfg.remat else 1)
    if launches["ssd_chunk"] != want:
        raise AssertionError(f"ssd_chunk launched {launches['ssd_chunk']} times, "
                             f"expected {want}")
    if launches["drain"] or launches["enqueue"]:
        raise AssertionError(f"unexpected launches on the trainer path: {launches}")
    log(f"  ssd_chunk launches {launches['ssd_chunk']} = {MAMBA_STEPS} steps x "
        f"{cfg.num_layers} layers x {clients} clients x 2 (forward, remat)")
    return launches, s_step, peak


CONTROL_HASHES = (2654435761, 2246822519, 3266489917)  # one sign pattern per control


def control_chunk_fn(torch, salt=0):
    """`ssd_chunk_ref` with each element of Y and S scaled by 1 +- 2^-23,
    the sign a hash of the element's index (`CONTROL_HASHES[salt]`): an
    f32-level change of the outputs, as a reordering of the sums makes,
    and the same in the forward and in its remat recompute."""
    from repro_torch.kernels.ssd.ref import ssd_chunk_ref

    mult = CONTROL_HASHES[salt]

    def chunk_fn(*args):
        out = []
        for t in ssd_chunk_ref(*args):
            idx = torch.arange(t.numel(), device=t.device).view(t.shape)
            sign = ((idx * mult) >> 15 & 1) * 2 - 1
            out.append(t * (1 + 2.0 ** -23 * sign))
        return tuple(out)

    return chunk_fn


def shadowed_ssd_chunk_ref(torch, shadows):
    """`ssd_chunk_ref` that also runs each of `shadows` (name -> a
    function of the same inputs, such as the kernel's wrapper) on every
    call's inputs, outside autograd, and keeps its largest |error| over
    the largest |Y|, |S| of that call; returns (chunk_fn, name -> list of
    0-d device tensors)."""
    from repro_torch.kernels.ssd.ref import ssd_chunk_ref

    errs = {name: [] for name in shadows}

    def chunk_fn(*args):
        out = ssd_chunk_ref(*args)
        with torch.no_grad():
            inputs = [t.detach() for t in args]
            for name, fn in shadows.items():
                errs[name] += [(a - b).abs().max() / b.abs().max()
                               for a, b in zip(fn(*inputs), out)]
        return out

    return chunk_fn, errs


def phase_mamba2_plain(torch, controls=False):
    """Phase 8. With `controls`, the kernel's forward built from
    `CONTROL_VARIANTS` of its source also trains and shadows, printed and
    not held."""
    others, shadows = [], {}
    if controls:
        from repro_torch.kernels.ssd import ops as ssd_ops
        from repro_torch.kernels.ssd import variants

        libs = variants.build_variants(CONTROL_VARIANTS)
        for v in CONTROL_VARIANTS:
            shadows[f"variant {v}"] = lambda *a, lib=libs[v]: ssd_ops.launch(lib, *a)
            others.append((f"variant {v}", dict(chunk_fn=variants.chunk_fn(libs[v]))))
    return compare_ssd_trainer_paths(torch, MAMBA_ARGS, mamba2_config(), MAMBA_PLAIN_STEPS,
                                     "8 mamba2 plain", shadows, others)


def compare_ssd_trainer_paths(torch, argv, cfg, steps, label, shadows=None, others=(),
                              controls=1, pool=None, faults=()):
    """`compare_trainer_paths` for a model with SSD blocks: the plain path
    (plain SSD step and plain mix) checks the kernel on the inputs of
    every SSD call it makes (`shadowed_ssd_chunk_ref`) within
    `SSD_REL_TOL`; each of the `controls` control paths is the plain path
    with `control_chunk_fn` (its own sign pattern); `pool` and `faults`
    as in `compare_trainer_paths`. `shadows` and `others` add further shadows
    and paths, not held."""
    from repro_torch.kernels.gossip import ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    chunk_fn, errs = shadowed_ssd_chunk_ref(torch, {"kernel": ssd_ops.ssd_chunk,
                                                    **(shadows or {})})
    result = compare_trainer_paths(
        torch, argv, cfg, steps, dict(mix=ops.gossip_mix_reference, chunk_fn=chunk_fn),
        {"mix": "mix_kernel", "ssd_chunk": "ssd_chunk_kernel"}, label,
        control=[dict(mix=ops.gossip_mix_reference, chunk_fn=control_chunk_fn(torch, salt))
                 for salt in range(controls)],
        others=others, pool=pool, faults=faults)
    for name, e in errs.items():
        worst = float(torch.stack(e).max())
        log(f"  {name} on the plain run's {len(e) // 2} SSD calls: largest |error| "
            f"{worst:.3e} of the largest |Y|, |S|"
            + (f" (tolerance {SSD_REL_TOL})" if name == "kernel" else " (not held)"))
        if name == "kernel" and not worst <= SSD_REL_TOL:
            raise AssertionError("ssd_chunk disagrees with its plain version on the "
                                 "trainer's inputs")
    return result


def hybrid_depths(torch, depths):
    """Phase 16's kernel-vs-plain comparison at each of `depths` zamba2
    layers, every block's leaves apart against `FAMILY_CONTROLS`
    controls (the measurement behind `FAMILY_CONTROLS`' choice of depth
    and pooling); a depth whose rule fails is reported and the next one
    run. Returns the depths that failed."""
    from repro_torch.configs.base import get_config

    argv = family_args("zamba2-2.7b", 512)
    failed = []
    for layers in depths:
        cfg = get_config("zamba2-2.7b").with_(num_layers=layers)
        log(f"zamba2 at {layers} layers:")
        try:
            compare_ssd_trainer_paths(torch, argv, cfg, FAMILY_PLAIN_STEPS,
                                      f"16 at {layers} layers", controls=FAMILY_CONTROLS)
        except AssertionError as exc:
            log(f"  not held at {layers} layers: {exc}")
            failed.append(layers)
        torch.cuda.empty_cache()
    return failed


def planted_faults(torch):
    """Phase 16's planted faults (`MIX_FAULT_TAIL`): (name, keyword
    arguments of `train_step`) paths."""
    from repro_torch.kernels.gossip import ops
    from repro_torch.kernels.ssd import variants

    one_term = variants.build_variants(["one-term"])["one-term"]

    def transposed(q, deltas):
        return ops.gossip_mix(q.T.contiguous(), deltas)

    def tail_dropped(q, deltas):
        out = ops.gossip_mix(q, deltas)
        out[:, -MIX_FAULT_TAIL:] = 0
        return out

    return [("fault ssd one-term", dict(chunk_fn=variants.chunk_fn(one_term))),
            ("fault mix transposed", dict(mix=transposed)),
            ("fault mix tail dropped", dict(mix=tail_dropped))]


def family_args(arch, seq, steps=FAMILY_STEPS):
    """The family trainer's arguments: its timed run unifies the clients
    after its last step (the comparisons call `train_step` alone)."""
    return ["--arch", arch, "--clients", "2", "--batch-per-client", "2", "--seq", str(seq),
            "--steps", str(steps), "--unify-every", str(steps), "--psi", "1", "--log-every",
            str(steps)]


def phase_families(torch):
    """Phases 15-18 (`FAMILY_PHASES`): each family through
    `repro_torch.launch.train.main` (`run_trainer`: losses, one mix launch
    per step, peak memory), its launches checked (zamba2: two `ssd_chunk`
    launches per Mamba2 block, client and step, forward and remat; no
    other kernel on any of these paths), then the moe trainer's kernel
    path against its plain mix under phase 6's rule (the paths are equal
    up to the order of f32 sums: the MoE's gathers and their backwards
    are deterministic), the hybrid's against the plain mix and plain SSD
    step under phase 8's control rule at one group, each leaf (a kind
    pooled over the group's Mamba2 blocks) against the largest of
    `FAMILY_CONTROLS` controls (the split-bf16 SSD kernel makes no leaf
    equal after bf16 rounding flips, and deeper the trajectories are
    chaotic: see `FAMILY_CONTROLS`; the kernel shadows every SSD call of
    the plain run; the rule must reject each planted fault of
    `planted_faults`), and the vlm and audio trainers' kernel paths timed
    and profiled alone, each at the depth its tuple names. Returns label -> dict of the launches,
    s/step, steady s/step, peak bytes, device busy us/step and per-kernel
    us/step."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.gossip import ops
    from repro_torch.models.model import block_pattern

    rows = {}
    for label, arch, layers, plain_layers, seq in FAMILY_PHASES:
        cfg = get_config(arch).with_(num_layers=layers)
        plain_cfg = cfg.with_(num_layers=plain_layers)
        argv = family_args(arch, seq)
        clients = int(argv[argv.index("--clients") + 1])
        launches, s_step, peak = run_trainer(torch, argv, cfg, FAMILY_STEPS, label)
        pattern, n_groups = block_pattern(cfg)
        ssm_blocks = pattern.count("ssm") * n_groups
        want = FAMILY_STEPS * ssm_blocks * clients * (2 if cfg.remat else 1)
        if launches["ssd_chunk"] != want or launches["drain"] or launches["enqueue"]:
            raise AssertionError(f"phase {label}: launches {launches}, expected "
                                 f"{want} ssd_chunk and no drain or enqueue")
        if ssm_blocks:
            log(f"  ssd_chunk launches {launches['ssd_chunk']} = {FAMILY_STEPS} steps x "
                f"{ssm_blocks} Mamba2 blocks x {clients} clients x 2 (forward, remat)")
        if cfg.family == "hybrid":
            result = compare_ssd_trainer_paths(torch, argv, plain_cfg, FAMILY_PLAIN_STEPS,
                                               f"{label} plain", controls=FAMILY_CONTROLS,
                                               pool=pool_ssm_positions,
                                               faults=planted_faults(torch))
        elif cfg.family == "moe":
            result = compare_trainer_paths(
                torch, argv, plain_cfg, FAMILY_PLAIN_STEPS,
                dict(mix=ops.gossip_mix_reference), {"mix": "mix_kernel"}, f"{label} plain")
        else:
            result = compare_trainer_paths(torch, argv, plain_cfg, FAMILY_PROFILE_STEPS, None,
                                           {"mix": "mix_kernel"}, f"{label} profile")
        dflat, steady_s, busy_us, per_kernel = result
        if cfg.family == "vlm" and dflat != VLM_MIX[1]:
            raise AssertionError(f"the vlm plane has {dflat} columns; phase 2 holds the mix "
                                 f"at VLM_MIX's {VLM_MIX[1]}")
        rows[label] = dict(cfg=cfg, plain_layers=plain_layers, launches=launches,
                           s_step=s_step, steady_s=steady_s, peak=peak, dflat=dflat,
                           busy_us=busy_us, kernels=per_kernel)
        torch.cuda.empty_cache()
    return rows


def ssd_variants(torch, names, flushes):
    """Times `repro_torch.kernels.ssd.variants` of ssd_chunk.cu at the
    trainer's shape (`SSD_MAIN`), three rounds in turns (forward,
    backward, forward) of `time_ms`' median of 40 launches, after holding
    the variants that keep the arithmetic to `ssd_chunk_ref`. `flushes`:
    ``zero`` clears L2 as phase 9 does (zeroing 96 MB, which leaves
    dirty lines), ``read`` reads 96 MB instead, ``none`` leaves the
    inputs in L2."""
    from repro_torch.kernels.ssd import ops, variants
    from repro_torch.kernels.ssd.ref import ssd_chunk_ref

    libs = variants.build_variants(names)
    inputs = ssd_case(torch, *SSD_MAIN, seed=4000)
    want = ssd_chunk_ref(*inputs)
    for name in names:
        if name in variants.EXACT:
            got = ops.launch(libs[name], *inputs)
            rel = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, want))
            log(f"{name}: max error {rel:.3e} of the largest |Y|, |S|")
            if rel > SSD_REL_TOL:
                raise AssertionError(f"variant {name} disagrees with ssd_chunk_ref")
    del want
    buf = torch.empty(96 * 2**20 // 4, device="cuda")  # > the 50 MB L2

    class ReadFlush:
        def zero_(self):
            buf.sum()

    by_mode = {"zero": buf, "read": ReadFlush(), "none": None}
    for mode in flushes:
        times = {name: [] for name in names}
        for rnd in range(3):
            for name in (names if rnd % 2 == 0 else names[::-1]):
                times[name].append(time_ms(
                    torch, lambda lib=libs[name]: ops.launch(lib, *inputs), reps=40,
                    flush=by_mode[mode]))
        for name in names:
            log(f"flush={mode} {name}: " + " ".join(f"{t:.4f}" for t in times[name]) + " ms")


def gossip_instances(torch):
    """The drain's and the enqueue's instances at the windowed path's
    shapes: registers, shared memory and blocks per SM, as launched."""
    from repro_torch.kernels.gossip import ops

    info = (ctypes.c_int * 3)()
    j, n, k = ENQ_MAIN
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = int(dtype == torch.bfloat16)
        name = "bf16" if bf16 else "f32"
        if ops._drain_lib().drain_info(j, n, n, k, bf16, info) != 0:
            raise AssertionError("drain_info failed")
        log(f"  drain instance J={j} N=M={n} {name} ring: {info[0]} registers, "
            f"{ops.drain_smem_bytes(j, n, n, dtype)} bytes of shared memory, "
            f"{info[1]} blocks per SM, grid {info[2]}")
        if ops._enqueue_lib().enqueue_info(j, n, k, bf16, info) != 0:
            raise AssertionError("enqueue_info failed")
        log(f"  enqueue instance J={j} N={n} {name} pending: {info[0]} registers, "
            f"{ops.enqueue_smem_bytes(j, n, dtype)} bytes of shared memory, "
            f"{info[1]} blocks per SM, grid {info[2]}")


def flushes(torch):
    """L2 flushes by name: ``zero`` writes 96 MB (phase 9's flush: it
    leaves the L2 full of dirty lines, whose write-back the timed kernel
    then pays), ``read`` reads 96 MB of clean lines (the
    kernel pays its own traffic only), ``none`` leaves the inputs in L2."""
    buf = torch.empty(96 * 2**20 // 4, device="cuda")  # > the 50 MB L2

    class ReadFlush:
        def zero_(self):
            buf.sum()

    return {"zero": buf, "read": ReadFlush(), "none": None}


def gossip_variants(torch, names, baseline, modes=("zero",), kernels=None):
    """Times `repro_torch.kernels.gossip.variants` of drain.cu, enqueue.cu
    and mix.cu (each of `kernels`, default all) at their paths' shapes (the
    drain with 3 and 1 live f32 buckets, the enqueue at `ENQ_MAIN` f32, both
    also on the wide route at N = WIDE_CLIENTS, the mix at
    `MIX_VARIANT_SHAPES`), three rounds in turns (forward, backward,
    forward) of `time_ms`' median of 40 launches with the L2 flushed
    (`flushes`, each of `modes`), after holding the variants that keep the
    arithmetic to the plain versions."""
    from repro_torch.kernels.gossip import ops, variants

    kernels = tuple(kernels or variants.KERNELS)
    libs = variants.build_variants(names, baseline, kernels)
    j, n, k = ENQ_MAIN
    # and, to see what odd K costs, rows 16-byte aligned (K + 1 = 146,448);
    # the wide route at N = M = WIDE_CLIENTS, 3 and 1 live buckets
    shapes = {
        "drain": [(f"f32 live={live}", drain_case(torch, j, n, n, k, 4, live, torch.float32,
                                                  4200 + live)) for live in (3, 1)]
        + [("f32 live=3 K+1", drain_case(torch, j, n, n, k + 1, 4, 3, torch.float32, 4210))]
        + [(f"wide N=M={WIDE_CLIENTS} f32 live={live}",
            drain_case(torch, j, WIDE_CLIENTS, WIDE_CLIENTS, k, 4, live, torch.float32,
                       4220 + live)) for live in (3, 1)],
        "enqueue": [("f32", enqueue_case(torch, j, n, k, torch.float32, 4300)),
                    ("f32 K+1", enqueue_case(torch, j, n, k + 1, torch.float32, 4310)),
                    (f"wide N={WIDE_CLIENTS} f32",
                     enqueue_case(torch, j, WIDE_CLIENTS, k, torch.float32, 4320))],
        "mix": [(f"N={mn} K={mk} f32", mix_case(torch, mn, mk, torch.float32, 4400 + mn))
                for mn, mk in MIX_VARIANT_SHAPES],
    }
    shapes = {kernel: shapes[kernel] for kernel in kernels}
    launch = {"drain": lambda lib, a: ops.launch_drain(lib, *a),
              "enqueue": lambda lib, a: ops.launch_enqueue(lib, *a, torch.float32),
              "mix": lambda lib, a: ops.launch_mix(lib, *a)}
    plain = {"drain": lambda a: ops.gossip_drain_reference(*a),
             "enqueue": lambda a: ops.gossip_enqueue_reference(*a),
             "mix": lambda a: ops.gossip_mix_reference(*a)}
    info = (ctypes.c_int * 3)()
    by_mode = flushes(torch)

    def takes(name, label):  # an earlier tree's kernels may stop at 64 clients
        return name != "baseline" or not label.startswith("wide") or all(
            hasattr(libs[kernel][name], f"{kernel}_route") for kernel in libs
            if name in libs[kernel])

    one = torch.empty(1, device="cuda")
    a, b, c = (torch.randn((n, k), device="cuda") for _ in range(3))
    for mode in modes:
        log(f"flush={mode} a one-element fill (the timing's floor): "
            f"{time_ms(torch, one.zero_, reps=40, flush=by_mode[mode]):.4f} ms; "
            f"torch.add of two ({n}, {k}) f32 planes (43.9 MB moved): "
            f"{time_ms(torch, lambda: torch.add(a, b, out=c), reps=40, flush=by_mode[mode]):.4f}"
            f" ms")
    del a, b, c
    for kernel, cases in shapes.items():
        kernel_names = [name for name in names if name in libs[kernel]]
        for name in kernel_names:
            lib = libs[kernel][name]
            if kernel == "mix" and hasattr(lib, "mix_info"):
                for mn, mk in MIX_VARIANT_SHAPES:
                    if lib.mix_info(mn, mk, 0, info) == 0:
                        log(f"mix {name} N={mn} K={mk}: {info[0]} registers, {info[1]} blocks "
                            f"per SM, grid {info[2]}")
            elif kernel != "mix" and hasattr(lib, f"{kernel}_info") and (
                    lib.drain_info(j, n, n, k, 0, info) if kernel == "drain"
                    else lib.enqueue_info(j, n, k, 0, info)) == 0:
                log(f"{kernel} {name}: {info[0]} registers, {info[1]} blocks per SM, "
                    f"grid {info[2]}")
            if name not in variants.EXACT:
                continue
            for label, args in cases:
                if not takes(name, label):
                    continue
                got = launch[kernel](lib, args)
                if kernel == "mix":
                    err, ok = mix_against_plain(torch, ops, *args, got)
                else:
                    want = plain[kernel](args)
                    err = float((got - want).abs().max())
                    ok = bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL))
                log(f"{kernel} {name} {label}: max_abs_err={err:.3e}")
                if not ok:
                    raise AssertionError(f"{kernel} variant {name} disagrees with the plain "
                                         f"version")
                del got
        for mode in modes:
            for label, args in cases:
                runs = [name for name in kernel_names if takes(name, label)]
                times = {name: [] for name in runs}
                for rnd in range(3):
                    for name in (runs if rnd % 2 == 0 else runs[::-1]):
                        times[name].append(time_ms(
                            torch, lambda lib=libs[kernel][name]: launch[kernel](lib, args),
                            reps=40, flush=by_mode[mode]))
                for name in runs:
                    log(f"flush={mode} {kernel} {label} {name}: median "
                        f"{statistics.median(times[name]):.4f} ms ("
                        + " ".join(f"{t:.4f}" for t in times[name]) + ")")


def phase_times(torch):
    """The drain at the windowed path's shape, 1 and 3 live buckets, f32
    and bf16 ring: kernel, plain version, library einsum, bound. The L2
    is flushed by zeroing 96 MB, as for every kernel of phase 9 (the
    kernel also pays the write-back of those dirty lines); the kernel's
    time after a read flush (`flushes`: clean lines) is logged beside it."""
    from repro_torch.kernels.gossip import ops

    gossip_instances(torch)
    j, n, m, k, s = 3, 25, 25, 146_447, 4
    by_mode = flushes(torch)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        for live in (1, 3):
            w, ring, slots = drain_case(torch, j, n, m, k, s, live, dtype, 100 + live)
            slots_dev = torch.tensor(slots, device="cuda")
            kern = time_ms(torch, lambda: ops.gossip_drain(w, ring, slots), flush=by_mode["zero"])
            read = time_ms(torch, lambda: ops.gossip_drain(w, ring, slots), flush=by_mode["read"])
            plain = time_ms(torch, lambda: ops.gossip_drain_reference(w, ring, slots),
                            flush=by_mode["zero"])
            lib = time_ms(torch, lambda: torch.einsum("jnm,jnk->mk", w, ring[slots_dev].float()),
                          flush=by_mode["zero"])
            bound, by = bound_ms("drain", j, n, m, k, ring.element_size(), live=live)
            out[name, live] = dict(ms=kern, plain_ms=plain, library_ms=lib, bound_ms=bound,
                                   bound_by=by)
            log(f"  drain J=3 N=M=25 K=146447 {name}, {live} live bucket(s): kernel "
                f"{kern:.4f} ms (read flush {read:.4f}), bound {bound:.4f} ms ({by}, "
                f"{100 * bound / kern:.1f}% of bound), plain {plain:.4f} ms, library einsum "
                f"{lib:.4f} ms")
    return out


def mix_instance(torch, n, k):
    """The mix's route and instance at (N, K) f32: registers, blocks per SM, grid."""
    from repro_torch.kernels.gossip import ops

    info = (ctypes.c_int * 3)()
    if ops._mix_lib().mix_info(n, k, 0, info) != 0:
        raise AssertionError("mix_info failed")
    route = ops.mix_route(n, torch.float32, ops._max_smem("mix", 0))
    return (f"{route} route, {info[0]} registers, {info[1]} blocks per SM, grid {info[2]}")


def phase_mix_times(torch, k):
    """The mix at the trainer's shape: N = 4 clients, K = Dflat, f32; its
    time after a zero and a read flush, the plain version, torch.matmul,
    and a device-to-device copy of the same plane (the stream's floor)."""
    from repro_torch.kernels.gossip import ops

    n = 4
    q, deltas = mix_case(torch, n, k, torch.float32, seed=7)
    got = ops.gossip_mix(q, deltas)
    err, ok = mix_against_plain(torch, ops, q, deltas, got)
    log(f"  mix N={n} K={k} f32 (the trainer's plane): max_abs_err={err:.3e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("mix kernel disagrees with its plain version at the "
                             "trainer's shape")
    del got
    by_mode = flushes(torch)
    kern = time_ms(torch, lambda: ops.gossip_mix(q, deltas), reps=10, flush=by_mode["zero"])
    read = time_ms(torch, lambda: ops.gossip_mix(q, deltas), reps=10, flush=by_mode["read"])
    plain = time_ms(torch, lambda: ops.gossip_mix_reference(q, deltas), reps=10)
    buf, qt = torch.empty_like(deltas), q.T
    lib = time_ms(torch, lambda: torch.matmul(qt, deltas, out=buf), reps=10)
    copy = time_ms(torch, lambda: buf.copy_(deltas), reps=10, flush=by_mode["zero"])
    bound, by = bound_ms("mix", n, k, 4)
    log(f"  mix N={n} K={k} f32 ({mix_instance(torch, n, k)}): kernel {kern:.4f} ms (read "
        f"flush {read:.4f}), bound {bound:.4f} ms ({by}, {100 * bound / kern:.1f}% of bound), "
        f"plain {plain:.4f} ms, library matmul {lib:.4f} ms, copy of the plane {copy:.4f} ms")
    del q, deltas, buf
    torch.cuda.empty_cache()
    return dict(ms=kern, plain_ms=plain, library_ms=lib, bound_ms=bound,
                bound_by=by), err


def phase_wide_window(torch):
    """`draco_window` at N = 100 clients (the EMNIST width): 50 windows
    through the drain kernel (its wide route) with the launch count set to
    0 before and read after, and 50 through the plain drain, from one
    seed: one launch per window, final params within PATH_TOL, the same
    acceptances."""
    from repro_torch.api import make_context
    from repro_torch.core import protocol
    from repro_torch.kernels.gossip import ops

    cfg, task = emnist_config(WIDE_CLIENTS)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    params0 = task.init_params(gen)
    data, _ = task.make_data(gen, cfg.num_clients)
    ctx = make_context(cfg, task=task, data=data, params0=params0)
    runs = {}
    for name, drain in (("kernel", None), ("plain", ops.gossip_drain_reference)):
        st = protocol.init_state(SEED + 11, cfg, params0)
        reset_launches()
        t0 = time.perf_counter()
        runs[name] = protocol.run_windows(st, cfg, ctx.q, ctx.adj, task, data,
                                          PLAIN_WINDOWS, drain=drain)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if name == "kernel":
            launches = launch_counts()["drain"]
            log(f"  N={cfg.num_clients}: {PLAIN_WINDOWS} windows in {wall:.3f} s "
                f"({wall / PLAIN_WINDOWS * 1e3:.3f} ms/window with the first), "
                f"{launches} drain launches")
    if launches != PLAIN_WINDOWS:
        raise AssertionError(f"drain launched {launches} times in {PLAIN_WINDOWS} windows")
    worst = 0.0
    for k in runs["kernel"].params:
        a, b = runs["kernel"].params[k], runs["plain"].params[k]
        worst = max(worst, float((a - b).abs().max()))
        if not torch.allclose(a, b, rtol=PATH_TOL, atol=PATH_TOL) \
                or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"N={cfg.num_clients}: kernel path and plain path differ in {k}")
    accepted = int(runs["kernel"].total_accept.sum())
    if not torch.equal(runs["kernel"].total_accept, runs["plain"].total_accept) or not accepted:
        raise AssertionError("N=100: the paths accepted different (or no) messages")
    log(f"phase 10 wide window: N={cfg.num_clients}, {PLAIN_WINDOWS} windows, kernel vs plain "
        f"drain max |dparams| = {worst:.3e} (tolerance {PATH_TOL}); {accepted} messages "
        f"accepted on both")
    return worst


def profile_rounds(torch, algo, st, ctx, rounds, steady_ms, kernel="mix_kernel",
                   unit="round"):
    """Device busy share of `rounds` profiled steps against the
    unprofiled steady step (`steady_ms`); the `kernel`'s row (the mix's
    by default). None when the profiler records no device time."""
    try:
        with card_profile() as prof:
            for _ in range(rounds):
                st = algo.step(st, ctx)
            torch.cuda.synchronize()
        rows = device_rows(prof)
    except (RuntimeError, AttributeError) as exc:
        log(f"    profiler: not measured ({exc})")
        return None
    busy = sum(r[0] for r in rows) / rounds
    if busy <= 0:
        log("    profiler: no device time recorded (not measured)")
        return None
    mix = sum(r[0] for r in rows if kernel in r[1]) / rounds
    share = busy / (steady_ms * 1e3)
    log(f"    profiler over {rounds} {unit}s: device busy {busy:.1f} us/{unit}, "
        f"{kernel.split('_')[0]} {mix:.2f} us/{unit}; {100 * share:.2f}% busy, "
        f"{100 - 100 * share:.2f}% idle")
    return 1.0 - share


def baseline_paths(torch, method, cfg, task, data, params0, rounds, seed):
    """`rounds` rounds of `method` through the mix kernel and through the
    plain mix, from one seed: (max |d eval params|, agree within PATH_TOL?)."""
    from repro_torch.core import baselines
    from repro_torch.kernels.gossip import ops

    runs = {}
    for name, mix in (("kernel", None), ("plain", ops.gossip_mix_reference)):
        st = baselines.init_baseline_state(seed, cfg, params0)
        st = baselines.run_baseline(method, st, cfg, task, data, rounds, mix=mix)
        runs[name] = baselines.eval_params(method, st)
    torch.cuda.synchronize()
    worst, ok = 0.0, True
    for k in runs["kernel"]:
        a, b = runs["kernel"][k], runs["plain"][k]
        worst = max(worst, float((a - b).abs().max()))
        ok = ok and bool(torch.allclose(a, b, rtol=PATH_TOL, atol=PATH_TOL))
        ok = ok and bool(torch.isfinite(a).all())
    return worst, ok


def phase_baselines(torch):
    """The four baselines at the fig3 EMNIST setup: `simulate` for the
    compute-matched rounds of FIG3_WINDOWS DRACO windows (one mix launch
    per round, the accuracy floor), the steady round under the sync
    detector and its device idle share, and 50 rounds of the kernel path
    against the plain mix; then sync-symm at N = 100 (the mix's tensor
    route) for a few rounds, against its plain path too, and each method
    for 50 rounds at N = 100 beside the plain mix, printed."""
    from repro_torch.api import get_algorithm, make_context, simulate, steps_for_budget
    from repro_torch.core.baselines import BASELINES

    cfg, task = fig3_config()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    params0 = task.init_params(gen)
    data, eval_data = task.make_data(gen, cfg.num_clients)
    ctx = make_context(cfg, task=task, data=data, params0=params0)
    budget = FIG3_WINDOWS * get_algorithm("draco").grads_per_step(cfg)
    out, total = {}, 0
    for i, method in enumerate(BASELINES):
        algo = get_algorithm(method)
        rounds = steps_for_budget(method, cfg, budget)
        reset_launches()
        t0 = time.perf_counter()
        state, trace = simulate(method, cfg, params0, data=data, num_steps=rounds, task=task,
                                key=SEED + 21 + i, eval_every=rounds, eval_data=eval_data,
                                ctx=ctx)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()["mix"]
        total += launches
        acc = float(trace.metrics["accuracy"][-1])
        log(f"  {method}: {rounds} rounds in {wall:.3f} s with the eval, {launches} mix "
            f"launches, final accuracy {acc:.4f} (floor {BASELINE_FLOORS[method]}), "
            f"consensus {float(trace.metrics['consensus'][-1]):.6f}")
        if launches != rounds:
            raise AssertionError(f"{method}: mix launched {launches} times in {rounds} rounds")
        if not all(np.isfinite(v).all() for v in trace.metrics.values()):
            raise AssertionError(f"{method}: non-finite metrics")
        if acc < BASELINE_FLOORS[method]:
            raise AssertionError(f"{method}: final accuracy {acc} under its floor")
        # the steady round, no host sync in the loop
        st = algo.init(SEED + 30 + i, cfg, params0, device="cuda")
        for _ in range(5):
            st = algo.step(st, ctx)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                for _ in range(BASELINE_STEADY):
                    st = algo.step(st, ctx)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        steady = (time.perf_counter() - t0) / BASELINE_STEADY * 1e3
        syncs = [str(w.message) for w in caught if "called a synchronizing" in str(w.message)]
        log(f"    steady {steady:.3f} ms/round over {BASELINE_STEADY} rounds; host syncs in "
            f"the loop: {len(syncs)}")
        if syncs:
            raise AssertionError(f"{method}: host sync inside the round loop: {syncs[0]}")
        idle = profile_rounds(torch, algo, st, ctx, 10, steady)
        err, ok = baseline_paths(torch, method, cfg, task, data, params0,
                                 BASELINE_PLAIN_ROUNDS, SEED + 40 + i)
        log(f"    {BASELINE_PLAIN_ROUNDS} rounds, kernel vs plain mix: max |d eval params| = "
            f"{err:.3e} (tolerance {PATH_TOL})")
        if not ok:
            raise AssertionError(f"{method}: kernel path and plain path differ")
        out[method] = dict(rounds=rounds, accuracy=acc, steady_ms=steady, idle=idle, err=err)
    # past the mix's narrow route
    cfg100, _ = fig3_config(WIDE_CLIENTS)
    data100, eval100 = task.make_data(gen, WIDE_CLIENTS)
    reset_launches()
    state, trace = simulate("sync-symm", cfg100, params0, data=data100,
                            num_steps=BASELINE_WIDE_ROUNDS, task=task, key=SEED + 50,
                            eval_every=BASELINE_WIDE_ROUNDS, eval_data=eval100)
    torch.cuda.synchronize()
    launches = launch_counts()["mix"]
    total += launches
    err, ok = baseline_paths(torch, "sync-symm", cfg100, task, data100, params0,
                             BASELINE_WIDE_ROUNDS, SEED + 51)
    log(f"  sync-symm at N={WIDE_CLIENTS}: {launches} mix launches in {BASELINE_WIDE_ROUNDS} "
        f"rounds, accuracy {float(trace.metrics['accuracy'][-1]):.4f}, kernel vs plain mix "
        f"max |d eval params| = {err:.3e}")
    if launches != BASELINE_WIDE_ROUNDS or not ok or not all(
            np.isfinite(v).all() for v in trace.metrics.values()):
        raise AssertionError(f"sync-symm at N={WIDE_CLIENTS} failed")
    # printed, not held: the tensor route's split-TF32 sums differ from the
    # plain mix's f32 ones by ~1e-6 a call, and training amplifies that over
    # the rounds (PERF.md, PR 17)
    for method in BASELINES:
        err, _ = baseline_paths(torch, method, cfg100, task, data100, params0,
                                BASELINE_PLAIN_ROUNDS, SEED + 51)
        log(f"  {method} at N={WIDE_CLIENTS}: {BASELINE_PLAIN_ROUNDS} rounds, kernel vs plain "
            f"mix max |d eval params| = {err:.3e} (printed, not held)")
    accs = ", ".join(f"{m} {r['accuracy']:.4f}" for m, r in out.items())
    log(f"phase 11 baselines: final accuracies {accs}; {total} mix launches")
    return out, total


def steady_steps(torch, algo, st, ctx, steps):
    """Five warm-up steps of `algo`, then `steps` under the sync detector:
    ``(state, host ms/step, host syncs seen)``."""
    for _ in range(5):
        st = algo.step(st, ctx)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            for _ in range(steps):
                st = algo.step(st, ctx)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    return st, ms, [str(w.message) for w in caught if "called a synchronizing" in str(w.message)]


def scenario_windows(torch, cfg, task, ctx, params0, data, eval_data, seed, label):
    """`SCENARIO_WINDOWS` DRACO windows of `simulate` under ``ctx.schedule``
    with the drain's count set to 0 before and read after (one launch a
    window, finite params and optimizer plane), then the steady window
    under the sync detector (0 host syncs) and its device idle share."""
    from repro_torch.api import get_algorithm, simulate
    from repro_torch.core import flat as flat_lib

    reset_launches()
    t0 = time.perf_counter()
    state, trace = simulate("draco", cfg, params0, data=data, num_steps=SCENARIO_WINDOWS,
                            task=task, key=seed, eval_every=SCENARIO_WINDOWS,
                            eval_data=eval_data, ctx=ctx)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()["drain"]
    metric = float(trace.metrics[task.metric_name][-1])
    finite = all(bool(torch.isfinite(p).all()) for p in flat_lib.tree_leaves(state.params)) \
        and bool(torch.isfinite(state.opt_state).all())
    log(f"  {label}: {SCENARIO_WINDOWS} windows in {wall:.3f} s with the eval, {launches} "
        f"drain launches, final {task.metric_name} {metric:.4f}, "
        f"{int(state.total_accept.sum())} messages accepted")
    if launches != SCENARIO_WINDOWS:
        raise AssertionError(f"{label}: drain launched {launches} times in "
                             f"{SCENARIO_WINDOWS} windows")
    if not finite or not np.isfinite(metric):
        raise AssertionError(f"{label}: non-finite params, plane or metric")
    algo = get_algorithm("draco")
    st = algo.init(seed + 1, cfg, params0, task=task, device="cuda")
    st, ms, syncs = steady_steps(torch, algo, st, ctx, SCENARIO_STEADY)
    log(f"    steady {ms:.3f} ms/window over {SCENARIO_STEADY} windows; host syncs in the "
        f"loop: {len(syncs)}")
    if syncs:
        raise AssertionError(f"{label}: host sync inside the window loop: {syncs[0]}")
    idle = profile_rounds(torch, algo, st, ctx, 20, ms, kernel="drain_kernel", unit="window")
    return dict(label=label, state=state, metric=metric, ms=ms, idle=idle,
                launches=launches)


def same_path(torch, a, b, what):
    """Max |a - b| over two runs' params and optimizer planes; raises
    unless within PATH_TOL and finite."""
    worst = 0.0
    from repro_torch.core import flat as flat_lib

    pairs = [(path, x, y) for (path, x), y in zip(flat_lib.tree_items(a.params),
                                                   flat_lib.tree_leaves(b.params))]
    pairs.append(("opt_state", a.opt_state, b.opt_state))
    for k, x, y in pairs:
        worst = max(worst, float((x - y).abs().max())) if x.numel() else worst
        if not torch.allclose(x, y, rtol=PATH_TOL, atol=PATH_TOL) \
                or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{what}: kernel path and plain path differ in {k}")
    return worst


def phase_scenarios(torch):
    """Phase 12: (a) the EMNIST windows under each scenario; (b) tiny-lm
    (AdamW, warmup-cosine) and small-cnn (Nesterov momentum) at their
    default widths under their scenarios; (c) 50 windows of each (b) run
    through the drain kernel and through the plain drain; (d) the four
    baselines with momentum under markov-edge-flip: one mix launch a
    round, 0 host syncs, 50 rounds through the kernel against the plain
    mix. Returns the drain and mix launches of the runs and their rows."""
    from repro_torch.api import get_algorithm, make_context, simulate
    from repro_torch.core import baselines, protocol
    from repro_torch.core import flat as flat_lib
    from repro_torch.core.baselines import BASELINES
    from repro_torch.kernels.gossip import ops
    from repro_torch.tasks import get_task

    drain_total, mix_total, rows = 0, 0, []
    cfg, mlp = emnist_config()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 60)
    params0 = mlp.init_params(gen)
    data, eval_data = mlp.make_data(gen, cfg.num_clients)
    for i, (name, knobs) in enumerate(SCENARIOS.items()):
        ctx = make_context(cfg, task=mlp, data=data, params0=params0, scenario=name,
                           scenario_key=SEED + 61 + i, scenario_kwargs=knobs)
        r = scenario_windows(torch, cfg, mlp, ctx, params0, data, eval_data,
                             SEED + 64 + i, f"EMNIST mlp/sgd, {name}")
        drain_total += r["launches"]
        rows.append(r)
    for i, (name, (opt, scenario)) in enumerate(NEW_TASKS.items()):
        task = get_task(name, **opt)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 70 + i)
        p0 = task.init_params(gen)
        tdata, tev = task.make_data(gen, cfg.num_clients)
        ctx = make_context(cfg, task=task, data=tdata, params0=p0, scenario=scenario,
                           scenario_key=SEED + 72 + i, scenario_kwargs=SCENARIOS[scenario])
        with torch.no_grad():
            before = float(task.eval_fn(flat_lib.tree_map(lambda v: v[None], p0), *tev).mean())
            stacked = protocol.init_state(0, cfg, p0, device="cuda").params
            loss0 = float(task.loss_fn(stacked, *tdata).mean())
        r = scenario_windows(torch, cfg, task, ctx, p0, tdata, tev, SEED + 74 + i,
                             f"{name} {task.opt_name}/{task.schedule}, {scenario}")
        with torch.no_grad():
            loss1 = float(task.loss_fn(r["state"].params, *tdata).mean())
        log(f"    {task.metric_name} {before:.4f} -> {r['metric']:.4f}; mean own-shard loss "
            f"{loss0:.4f} -> {loss1:.4f}")
        if name == "tiny-lm" and not r["metric"] < before:
            raise AssertionError(f"tiny-lm: perplexity {r['metric']} not below {before}")
        if name == "small-cnn" and not r["metric"] > SMALL_CNN_CHANCE:
            raise AssertionError(f"small-cnn: accuracy {r['metric']} not above chance")
        drain_total += r["launches"]
        rows.append(r)
        runs = {}
        for path, drain in (("kernel", None), ("plain", ops.gossip_drain_reference)):
            st = protocol.init_state(SEED + 76 + i, cfg, p0, task=task)
            runs[path] = protocol.run_windows(st, cfg, None, None, task, tdata, PLAIN_WINDOWS,
                                              drain=drain, schedule=ctx.schedule)
        torch.cuda.synchronize()
        worst = same_path(torch, runs["kernel"], runs["plain"], name)
        same = torch.equal(runs["kernel"].total_accept, runs["plain"].total_accept)
        log(f"    {PLAIN_WINDOWS} windows, kernel vs plain drain: max |d params, plane| = "
            f"{worst:.3e} (tolerance {PATH_TOL}); same acceptances {same}")
        if not same:
            raise AssertionError(f"{name}: the paths accepted different messages")
    cfg3, mlp3 = fig3_config()
    task = mlp3.with_optimizer("momentum")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 80)
    p0 = task.init_params(gen)
    bdata, bev = task.make_data(gen, cfg3.num_clients)
    ctx = make_context(cfg3, task=task, data=bdata, params0=p0, scenario="markov-edge-flip",
                       scenario_key=SEED + 81, scenario_kwargs=SCENARIOS["markov-edge-flip"])
    for i, method in enumerate(BASELINES):
        algo = get_algorithm(method)
        reset_launches()
        state, trace = simulate(method, cfg3, p0, data=bdata, num_steps=SCENARIO_ROUNDS,
                                task=task, key=SEED + 82 + i, eval_every=SCENARIO_ROUNDS,
                                eval_data=bev, ctx=ctx)
        torch.cuda.synchronize()
        launches = launch_counts()["mix"]
        mix_total += launches
        acc = float(trace.metrics["accuracy"][-1])
        log(f"  {method} mlp/momentum, markov-edge-flip: {SCENARIO_ROUNDS} rounds, {launches} "
            f"mix launches, final accuracy {acc:.4f}")
        if launches != SCENARIO_ROUNDS or not all(np.isfinite(v).all()
                                                  for v in trace.metrics.values()):
            raise AssertionError(f"{method}: {launches} mix launches in {SCENARIO_ROUNDS} "
                                 f"rounds, or non-finite metrics")
        st = algo.init(SEED + 86 + i, cfg3, p0, task=task, device="cuda")
        st, ms, syncs = steady_steps(torch, algo, st, ctx, BASELINE_STEADY)
        log(f"    steady {ms:.3f} ms/round over {BASELINE_STEADY} rounds; host syncs in the "
            f"loop: {len(syncs)}")
        if syncs:
            raise AssertionError(f"{method}: host sync inside the round loop: {syncs[0]}")
        idle = profile_rounds(torch, algo, st, ctx, 10, ms)
        runs = {}
        for path, mix in (("kernel", None), ("plain", ops.gossip_mix_reference)):
            st = baselines.init_baseline_state(SEED + 90 + i, cfg3, p0, task=task)
            runs[path] = baselines.run_baseline(method, st, cfg3, task, bdata,
                                                BASELINE_PLAIN_ROUNDS, mix=mix,
                                                schedule=ctx.schedule)
        torch.cuda.synchronize()
        worst = same_path(torch, runs["kernel"], runs["plain"], method)
        log(f"    {BASELINE_PLAIN_ROUNDS} rounds, kernel vs plain mix: max |d params, plane| = "
            f"{worst:.3e} (tolerance {PATH_TOL})")
        rows.append(dict(label=f"{method} mlp/momentum, markov-edge-flip", metric=acc, ms=ms,
                         idle=idle))
    log(f"phase 12 scenarios: {drain_total} drain launches, {mix_total} mix launches")
    return drain_total, mix_total, rows


def sweep_final(state):
    """final_fn of phase 13: each row's params and message counters."""
    return state.params, state.total_accept


def phase_sweep(torch):
    """Phase 13: benchmarks/fig4_psi_sweep.py's Psi grid through
    `simulate_sweep` at fig3_config(): one drain launch per batched window,
    the trace's shape, finite params, each Psi's seed-mean accuracy
    against its floor; the steady batched window under the sync detector
    beside R solo windows, its idle share; row (Psi 4, seed 1) for 50
    windows against the solo `simulate`."""
    from repro_torch.api import get_algorithm, make_context, simulate, simulate_sweep
    from repro_torch.core import protocol

    cfg, task = fig3_config()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 130)
    params0 = task.init_params(gen)
    data, eval_data = task.make_data(gen, cfg.num_clients)
    grid = [cfg.replace(psi=p) for p in SWEEP_PSIS]
    keys = [SEED + 131 + r for r in range(SWEEP_SEEDS)]
    ctx = make_context(grid[0], task=task, data=data, params0=params0)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    (params, accepted), trace = simulate_sweep(
        "draco", grid, params0, data=data, num_steps=SWEEP_WINDOWS, task=task, keys=keys,
        eval_every=SWEEP_EVAL, eval_data=eval_data, ctx=ctx, final_fn=sweep_final)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()["drain"]
    acc = trace.metrics["accuracy"]
    windows = len(grid) * SWEEP_WINDOWS
    log(f"  sweep: {len(grid)} Psi x {SWEEP_SEEDS} seeds x {SWEEP_WINDOWS} windows in "
        f"{wall:.3f} s with the evals ({wall / windows * 1e3:.3f} ms per batched window), "
        f"{launches} drain launches, trace {acc.shape}")
    if launches != windows:
        raise AssertionError(f"sweep: {launches} drain launches in {windows} batched windows")
    if acc.shape != (len(grid), SWEEP_SEEDS, SWEEP_WINDOWS // SWEEP_EVAL):
        raise AssertionError(f"sweep trace shape {acc.shape}")
    if not all(bool(torch.isfinite(p).all()) for p in params.values()) \
            or not np.isfinite(acc).all():
        raise AssertionError("sweep: non-finite params or accuracies")
    for g, psi in enumerate(SWEEP_PSIS):
        mean = float(acc[g, :, -1].mean())
        log(f"    Psi {psi:2d}: final accuracy by seed "
            + " ".join(f"{a:.4f}" for a in acc[g, :, -1])
            + f", seed mean {mean:.4f} (floor {SWEEP_FLOORS[psi]}), messages accepted "
            f"{int(accepted[g].sum()) // SWEEP_SEEDS} per seed")
        if mean < SWEEP_FLOORS[psi]:
            raise AssertionError(f"sweep: Psi {psi} seed-mean accuracy {mean} below its floor")

    # the steady batched window against R solo windows, in this call
    g = SWEEP_PSIS.index(SWEEP_ROW_PSI)
    ctx_g = ctx._replace(cfg=grid[g])
    algo = get_algorithm("draco")
    seeds_st = protocol.stack_seeds([algo.init(k, grid[g], params0, task=task) for k in keys])
    seeds_st, ms, syncs = steady_steps(torch, algo, seeds_st, ctx_g, SWEEP_STEADY)
    solo_st = algo.init(keys[0], grid[g], params0, task=task)
    solo_st, solo_ms, solo_syncs = steady_steps(torch, algo, solo_st, ctx_g, SWEEP_STEADY)
    log(f"    steady: {ms:.3f} ms per batched window of {SWEEP_SEEDS} seeds against "
        f"{solo_ms:.3f} ms per solo window ({SWEEP_SEEDS} solo windows {SWEEP_SEEDS * solo_ms:.3f} "
        f"ms, {SWEEP_SEEDS * solo_ms / ms:.2f}x); host syncs in the loops: {len(syncs)}, "
        f"{len(solo_syncs)}")
    if syncs or solo_syncs:
        raise AssertionError(f"sweep: host sync inside the window loop: {(syncs + solo_syncs)[0]}")
    idle = profile_rounds(torch, algo, seeds_st, ctx_g, 20, ms, kernel="drain_kernel",
                          unit="batched window")
    solo_idle = profile_rounds(torch, algo, solo_st, ctx_g, 20, solo_ms,
                               kernel="drain_kernel", unit="solo window")

    # row (Psi 4, seed 1) against the solo run
    finals, _ = simulate_sweep("draco", grid[g], params0, data=data, num_steps=PLAIN_WINDOWS,
                               task=task, keys=keys, ctx=ctx_g)
    solo, _ = simulate("draco", grid[g], params0, data=data, num_steps=PLAIN_WINDOWS,
                       task=task, key=keys[SWEEP_ROW_SEED], ctx=ctx_g)
    torch.cuda.synchronize()
    gap = max(float((finals.params[k][0, SWEEP_ROW_SEED] - solo.params[k]).abs().max())
              for k in solo.params)
    same = torch.equal(finals.total_accept[0, SWEEP_ROW_SEED], solo.total_accept)
    log(f"    row (Psi {SWEEP_ROW_PSI}, seed {SWEEP_ROW_SEED}), {PLAIN_WINDOWS} windows against "
        f"the solo simulate: max |d params| = {gap:.3e} (tolerance {PATH_TOL}); same "
        f"acceptances {same}")
    if gap > PATH_TOL or not same:
        raise AssertionError("sweep: a grid row differs from its solo run")
    log(f"phase 13 sweep: {launches} drain launches; Psi seed-mean final accuracies "
        + ", ".join(f"{p} {float(acc[i, :, -1].mean()):.4f}" for i, p in enumerate(SWEEP_PSIS)))
    return dict(launches=launches, ms=ms, solo_ms=solo_ms, idle=idle, solo_idle=solo_idle,
                wall_ms=wall / windows * 1e3, gap=gap)


def event_config(threshold):
    """fig3_config() as an EventConfig: poly staleness (a = 0.5) and the
    event-triggered threshold."""
    import dataclasses

    from repro_torch.events import EventConfig

    cfg, task = fig3_config()
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return EventConfig(**fields, staleness="poly", staleness_a=0.5,
                       trigger_threshold=threshold), task


def phase_events(torch):
    """Phase 14: draco-event, fedasync-gossip and event-triggered on one
    300 s tape at the fig3 EMNIST setup, each under the sync detector (0
    host syncs, one per TX row for event-triggered) with one drain launch
    per valid event and none per padding row, final accuracy against its
    floor; draco-event once more through `simulate_events`; 300 events
    through the kernel and the plain drain; fedasync-window for 240
    windows through both."""
    from repro_torch.api import get_algorithm
    from repro_torch.core import protocol
    from repro_torch.events import events_context, run_events, simulate_events
    from repro_torch.events.staleness import staleness_damping_vector, staleness_fn
    from repro_torch.kernels.gossip import ops

    cfg, task = event_config(EVENT_TRIGGER)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 140)
    params0 = task.init_params(gen)
    data, eval_data = task.make_data(gen, cfg.num_clients)
    ctx = events_context(cfg, task=task, data=data, params0=params0, horizon=EVENT_HORIZON,
                         tape_seed=EVENT_TAPE_SEED)
    tape = ctx.tape
    counts = tape.counts()
    log(f"  tape: {tape.num_valid} valid events of {tape.capacity} rows ({counts}), "
        f"horizon {EVENT_HORIZON:.0f} s")
    out, total = {}, 0
    for i, name in enumerate(("draco-event", "fedasync-gossip", "event-triggered")):
        algo = get_algorithm(name)
        st = algo.init(SEED + 141, cfg, params0, task=task)
        torch.cuda.synchronize()
        reset_launches()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                for _ in range(tape.capacity):
                    st = algo.step(st, ctx)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        syncs = [w for w in caught if "called a synchronizing" in str(w.message)]
        launches = launch_counts()["drain"]
        total += launches
        with torch.no_grad():
            acc = float(task.eval_fn(st.params, *eval_data).mean())
        sent = int(st.tx_sent.sum())
        want_syncs = counts["tx"] if name == "event-triggered" else 0
        log(f"  {name}: {tape.capacity} rows in {wall:.3f} s ({wall / tape.num_valid * 1e3:.3f} "
            f"ms/event), {launches} drain launches, host syncs {len(syncs)} (expected "
            f"{want_syncs}), {sent} broadcasts of {counts['tx']} TX rows, final accuracy "
            f"{acc:.4f} (floor {EVENT_FLOORS[name]})")
        if launches != tape.num_valid:
            raise AssertionError(f"{name}: {launches} drain launches for {tape.num_valid} "
                                 "valid events")
        if len(syncs) != want_syncs:
            raise AssertionError(f"{name}: {len(syncs)} host syncs, expected {want_syncs}")
        if name == "event-triggered" and not sent < counts["tx"]:
            raise AssertionError("event-triggered suppressed no TX row")
        if not all(bool(torch.isfinite(p).all()) for p in st.params.values()) \
                or acc < EVENT_FLOORS[name]:
            raise AssertionError(f"{name}: non-finite params or accuracy {acc} below its floor")
        out[name] = dict(ms=wall / tape.num_valid * 1e3, acc=acc, sent=sent, launches=launches)
    # the entry point: draco-event through simulate_events, the same run
    reset_launches()
    st, trace = simulate_events("draco-event", cfg, params0, ctx=ctx, key=SEED + 141,
                                eval_every=tape.capacity, eval_data=eval_data)
    torch.cuda.synchronize()
    launches = launch_counts()["drain"]
    total += launches
    acc = float(trace.metrics["accuracy"][-1])
    log(f"  simulate_events('draco-event'): {launches} drain launches, final accuracy "
        f"{acc:.4f} (the loop's {out['draco-event']['acc']:.4f})")
    if launches != tape.num_valid or abs(acc - out["draco-event"]["acc"]) > 1e-6:
        raise AssertionError("simulate_events differs from the step loop")
    # steady ms per event and the device's idle share, over the tape's start
    algo = get_algorithm("draco-event")
    st = algo.init(SEED + 142, cfg, params0, task=task)
    st, ms, _ = steady_steps(torch, algo, st, ctx, EVENT_PROFILE)
    st = algo.init(SEED + 142, cfg, params0, task=task)
    idle = profile_rounds(torch, algo, st, ctx, EVENT_PROFILE, ms, kernel="drain_kernel",
                          unit="event")
    # 300 events through the kernel and through the plain drain
    runs = {}
    damping = staleness_fn(cfg)
    for path, drain in (("kernel", None), ("plain", ops.gossip_drain_reference)):
        st = algo.init(SEED + 143, cfg, params0, task=task)
        runs[path] = run_events(st, ctx, EVENT_PLAIN, damping=damping, drain=drain)
    torch.cuda.synchronize()
    gap = same_path(torch, runs["kernel"], runs["plain"], "fedasync-gossip events")
    same = all(torch.equal(getattr(runs["kernel"], f), getattr(runs["plain"], f))
               for f in ("total_accept", "tx_sent", "accept_count")) \
        and runs["kernel"].tx_count == runs["plain"].tx_count
    log(f"  fedasync-gossip, {EVENT_PLAIN} events, kernel vs plain drain: max |d params, plane| "
        f"= {gap:.3e} (tolerance {PATH_TOL}); same counters {same}")
    if not same:
        raise AssertionError("events: the kernel and plain paths count differently")
    # fedasync-window: 240 windows, one drain a window, against the plain drain
    wcfg, wctx = cfg, ctx._replace(tape=None)
    walgo = get_algorithm("fedasync-window")
    st = walgo.init(SEED + 144, wcfg, params0, task=task)
    reset_launches()
    for _ in range(FEDASYNC_WINDOWS):
        st = walgo.step(st, wctx)
    torch.cuda.synchronize()
    launches = launch_counts()["drain"]
    total += launches
    vec = staleness_damping_vector(wcfg, device="cuda")
    plain = protocol.init_state(SEED + 144, wcfg, params0, task=task)
    for _ in range(FEDASYNC_WINDOWS):
        plain = protocol.draco_window(plain, wcfg, wctx.q, wctx.adj, task, data, wctx.flat_spec,
                                      damping=vec, drain=ops.gossip_drain_reference)
    torch.cuda.synchronize()
    wgap = same_path(torch, st, plain, "fedasync-window")
    with torch.no_grad():
        wacc = float(task.eval_fn(st.params, *eval_data).mean())
    log(f"  fedasync-window (poly): {FEDASYNC_WINDOWS} windows, {launches} drain launches, final "
        f"accuracy {wacc:.4f}; kernel vs plain drain max |d params, plane| = {wgap:.3e}; same "
        f"acceptances {torch.equal(st.total_accept, plain.total_accept)}")
    if launches != FEDASYNC_WINDOWS or not torch.equal(st.total_accept, plain.total_accept):
        raise AssertionError("fedasync-window: launches or acceptances off")
    del runs, st, plain
    torch.cuda.empty_cache()
    log(f"phase 14 events: {total} drain launches; " + ", ".join(
        f"{k} {v['acc']:.4f}" for k, v in out.items()) + f"; steady {ms:.3f} ms/event")
    return dict(launches=total, ms=ms, idle=idle, runs=out, gap=gap, wgap=wgap)


def phase_seed_times(torch):
    """Phase 9's seed-axis row: the drain at R = 4 seeds of the EMNIST
    plane, 3 live buckets each, against its bound (R times the solo
    drain's bytes), the plain version and the einsum over the seed axis;
    zero and read flushes, and R solo launches beside it."""
    from repro_torch.kernels.gossip import ops

    r, j, n, m, k, s = SEED_TIMES_R, 3, 25, 25, 146_447, 4
    w, ring, slots = seed_drain_case(torch, r, j, n, m, k, s, torch.float32, 950,
                                     live=lambda i: 3)
    slots_dev = torch.tensor(slots, device="cuda")
    by_mode = flushes(torch)
    kern = time_ms(torch, lambda: ops.gossip_drain(w, ring, slots), flush=by_mode["zero"])
    read = time_ms(torch, lambda: ops.gossip_drain(w, ring, slots), flush=by_mode["read"])

    def solo():
        for q in range(r):
            ops.gossip_drain(w[q], ring[q], slots)

    solos = time_ms(torch, solo, flush=by_mode["zero"])
    plain = time_ms(torch, lambda: ops.gossip_drain_reference(w, ring, slots),
                    flush=by_mode["zero"])
    lib = time_ms(torch, lambda: torch.einsum("rjnm,rjnk->rmk", w, ring[:, slots_dev]),
                  flush=by_mode["zero"])
    one, by = bound_ms("drain", j, n, m, k, 4, live=3)
    bound = r * one
    log(f"  drain seed axis R={r} J=3 N=M=25 K={k} f32, 3 live each: kernel {kern:.4f} ms "
        f"(read flush {read:.4f}), bound {bound:.4f} ms ({by}, {100 * bound / kern:.1f}% of "
        f"bound), {r} solo launches {solos:.4f} ms, plain {plain:.4f} ms, library einsum "
        f"{lib:.4f} ms")
    del w, ring
    torch.cuda.empty_cache()
    return dict(ms=kern, read_ms=read, solo_ms=solos, plain_ms=plain, library_ms=lib,
                bound_ms=bound, bound_by=by)


def phase_wide_times(torch):
    """Times past 64 clients beside both bounds (the f32 rate and the
    split-TF32 tensor cores), the plain version and one library call: the
    drain's wide route at N = M = 100 and 256 (3 live f32 buckets), the
    enqueue's at J = 3, N = 100; and the mix at the baselines' fig3 width
    (N = 25, its narrow route) and at N = 100 and 256 (its tensor route),
    beside torch.matmul and a copy of the deltas. K = 146,447 f32
    throughout; zero flush as in phase 9, read flush beside."""
    from repro_torch.kernels.gossip import ops

    by_mode = flushes(torch)
    k = 146_447
    rows = {}

    def row(label, kern, read, plain, lib, work, copy=None):
        bound, by = bound_ms(*work)
        tc, tc_by = bound_ms(*work, tensor_cores=4)
        rows[label] = dict(ms=kern, plain_ms=plain, library_ms=lib, bound_ms=bound,
                           bound_by=by, tc_bound_ms=tc, tc_bound_by=tc_by, copy_ms=copy)
        log(f"  {label}: kernel {kern:.4f} ms (read flush {read:.4f}), bound {bound:.4f} ms "
            f"({by}, f32 rate; {100 * bound / kern:.1f}%), tensor-core bound {tc:.4f} ms "
            f"({tc_by}; {100 * tc / kern:.1f}%), plain {plain:.4f} ms, library {lib:.4f} ms"
            + ("" if copy is None else f", copy of the deltas {copy:.4f} ms"))

    for n in (100, 256):
        w, ring, slots = drain_case(torch, 3, n, n, k, 4, 3, torch.float32, 500 + n)
        slots_dev = torch.tensor(slots, device="cuda")
        drain = lambda: ops.gossip_drain(w, ring, slots)  # noqa: E731
        row(f"drain wide J=3 N=M={n} K={k} f32 3 live",
            time_ms(torch, drain, reps=30, flush=by_mode["zero"]),
            time_ms(torch, drain, reps=30, flush=by_mode["read"]),
            time_ms(torch, lambda: ops.gossip_drain_reference(w, ring, slots), reps=20,
                    flush=by_mode["zero"]),
            time_ms(torch, lambda: torch.einsum("jnm,jnk->mk", w, ring[slots_dev]), reps=20,
                    flush=by_mode["zero"]),
            ("drain", 3, n, n, k, 4))
        del w, ring
    for n in (25, 100, 256):
        q, deltas = mix_case(torch, n, k, torch.float32, seed=600 + n)
        buf, qt = torch.empty_like(deltas), q.T
        log(f"  mix N={n} K={k} f32: {mix_instance(torch, n, k)}")
        row(f"mix N={n} K={k} f32{' (the baselines at fig3)' if n == 25 else ''}",
            time_ms(torch, lambda: ops.gossip_mix(q, deltas), reps=30, flush=by_mode["zero"]),
            time_ms(torch, lambda: ops.gossip_mix(q, deltas), reps=30, flush=by_mode["read"]),
            time_ms(torch, lambda: ops.gossip_mix_reference(q, deltas), reps=20,
                    flush=by_mode["zero"]),
            time_ms(torch, lambda: torch.matmul(qt, deltas, out=buf), reps=20,
                    flush=by_mode["zero"]),
            ("mix", n, k, 4), copy=time_ms(torch, lambda: buf.copy_(deltas), reps=30, flush=by_mode["zero"]))
        del q, deltas, buf
    w, pending = enqueue_case(torch, 3, 100, k, torch.float32, 700)
    buf, wt = torch.empty((3, 100, k), device="cuda"), w.transpose(1, 2)
    row(f"enqueue wide J=3 N=100 K={k} f32",
        time_ms(torch, lambda: ops.gossip_enqueue(w, pending), reps=30, flush=by_mode["zero"]),
        time_ms(torch, lambda: ops.gossip_enqueue(w, pending), reps=30, flush=by_mode["read"]),
        time_ms(torch, lambda: ops.gossip_enqueue_reference(w, pending), reps=20,
                flush=by_mode["zero"]),
        time_ms(torch, lambda: torch.matmul(wt, pending, out=buf), reps=20,
                flush=by_mode["zero"]),
        ("enqueue", 3, 100, k, 4, 4))
    del w, pending, buf
    torch.cuda.empty_cache()
    info = (ctypes.c_int * 3)()
    if ops._drain_lib().drain_info(3, 100, 100, k, 0, info) != 0:
        raise AssertionError("drain_info failed")
    log(f"  drain wide instance J=3 N=M=100 f32: {info[0]} registers, "
        f"{ops.wide_smem_bytes(3, 100, torch.float32)} bytes of shared memory, {info[1]} "
        f"blocks per SM, grid {info[2]}")
    return rows


def phase_entry_legacy(torch):
    """Phase 19 (a): `ENTRY_WINDOWS` windows of the legacy engine and of the
    fused window (the drain kernel) at benchmarks/torch_run.py's
    draco_window shape, from one seed on one draws record: params within
    `PATH_TOL`, equal acceptances, one drain launch per fused window."""
    from benchmarks.torch_fig3_convergence import setup
    from repro_torch.core import protocol

    cfg, train, _, params0, loss, _, key = setup("emnist", device="cuda")
    cfg = cfg.replace(max_delay_windows=ENTRY_DEPTH)
    q, adj = protocol.build_graph(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 190)
    draws = [protocol.sample_window_draws(gen, cfg, train[0].shape[1])
             for _ in range(ENTRY_WINDOWS)]
    # warm both engines up on throwaway states (the first windows pay the
    # allocator's growth and the libraries' first calls)
    protocol.run_windows(protocol.init_state(key + 1, cfg, params0), cfg, q, adj, loss,
                         train, ENTRY_WARMUP)
    protocol.run_windows_legacy(protocol.init_state_legacy(key + 1, cfg, params0), cfg, q,
                                adj, loss, train, ENTRY_WARMUP)
    fused = protocol.init_state(key, cfg, params0)
    legacy = protocol.init_state_legacy(key, cfg, params0)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    fused = protocol.run_windows(fused, cfg, q, adj, loss, train, ENTRY_WINDOWS,
                                 draws_fn=lambda w: draws[w])
    torch.cuda.synchronize()
    t_fused = time.perf_counter() - t0
    launches = launch_counts()["drain"]
    t0 = time.perf_counter()
    legacy = protocol.run_windows_legacy(legacy, cfg, q, adj, loss, train, ENTRY_WINDOWS,
                                         draws_fn=lambda w: draws[w])
    torch.cuda.synchronize()
    t_legacy = time.perf_counter() - t0
    gap = max(float((fused.params[k] - legacy.params[k]).abs().max()) for k in legacy.params)
    ok = all(torch.allclose(fused.params[k], legacy.params[k], rtol=PATH_TOL, atol=PATH_TOL)
             for k in legacy.params)
    same = torch.equal(fused.total_accept, legacy.total_accept)
    ms_f, ms_l = t_fused / ENTRY_WINDOWS * 1e3, t_legacy / ENTRY_WINDOWS * 1e3
    log(f"  legacy against fused: N={cfg.num_clients}, D={ENTRY_DEPTH}, {ENTRY_WINDOWS} "
        f"windows on shared draws: max |d params| = {gap:.3e} (tolerance {PATH_TOL}); same "
        f"acceptances {same} ({int(fused.total_accept.sum())} messages); {launches} drain "
        f"launches; fused {ms_f:.3f} ms/window, legacy {ms_l:.3f} ms/window")
    if launches != ENTRY_WINDOWS:
        raise AssertionError(f"fused window: {launches} drain launches in {ENTRY_WINDOWS}")
    if not ok or not same:
        raise AssertionError("the legacy engine and the fused window differ")
    return dict(launches=launches, ms_fused=ms_f, ms_legacy=ms_l, gap=gap)


def entry_run(torch, label, call, kernels):
    """`call()` with every launch count set to 0 just before and read just
    after, its standard output captured and echoed indented; raises
    unless it launched each of `kernels`. Returns (printed lines, launch
    counts, seconds)."""
    import contextlib
    import io

    out = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        call()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    printed = out.getvalue().splitlines()
    for line in printed[-12:]:
        log(f"    {line}")
    idle = [k for k in kernels if counts[k] == 0]
    if idle:
        raise AssertionError(f"{label} launched no {idle} kernel: {counts}")
    log(f"  {label}: ok in {wall:.2f} s; launches drain {counts['drain']}, mix "
        f"{counts['mix']}, ssd_chunk {counts['ssd_chunk']}")
    return printed, counts, wall


def phase_entry_benches(torch, out_dir):
    """Phase 19 (b): every benchmarks/torch_run.py bench at quick=True on
    the card, its files under `out_dir`: rows printed and finite, and
    launches of each kernel the bench reaches."""
    from benchmarks import torch_common, torch_run

    totals = {"drain": 0, "mix": 0, "ssd_chunk": 0}
    for name, fn in torch_run.BENCHES.items():
        torch_common.RESULTS.clear()
        printed, counts, _ = entry_run(
            torch, f"bench {name}", lambda fn=fn: fn(quick=True, device="cuda",
                                                     out_dir=out_dir),
            BENCH_KERNELS[name])
        rows = dict(torch_common.RESULTS)
        missing = [r for r in rows if not any(line.startswith(f"{r},") for line in printed)]
        if not rows or missing or not torch_common.finite(rows):
            raise AssertionError(f"bench {name}: rows {rows}, not printed {missing}")
        for k in totals:
            totals[k] += counts[k]
    return totals


def phase_entry_examples(torch):
    """Phase 19 (c): every examples/torch_*.py at its reduced size
    (`EXAMPLES`), holding its own assertions, with launches of each kernel
    it reaches."""
    import importlib.util

    totals = {"drain": 0, "mix": 0, "ssd_chunk": 0}
    for name, (args, kernels) in EXAMPLES.items():
        path = os.path.join(HERE, "examples", f"torch_{name}.py")
        spec = importlib.util.spec_from_file_location(f"torch_example_{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _, counts, _ = entry_run(torch, " ".join(["example", name] + args),
                                 lambda module=module, args=args: module.main(args), kernels)
        for k in totals:
            totals[k] += counts[k]
    return totals


def phase_entry_points(torch):
    """Phase 19: (a) legacy against fused, (b) every torch_run bench, (c)
    every torch example; their files go to a temporary directory. Returns
    the launches of each kernel over (a)-(c) and (a)'s numbers."""
    import tempfile

    t0 = time.perf_counter()
    legacy = phase_entry_legacy(torch)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_entry_") as tmp:
        benches = phase_entry_benches(torch, tmp)
    examples = phase_entry_examples(torch)
    launches = {k: benches[k] + examples[k] for k in benches}
    launches["drain"] += legacy["launches"]
    log(f"phase 19 entry points: {time.perf_counter() - t0:.1f} s; legacy "
        f"{legacy['ms_legacy']:.3f} ms/window against fused {legacy['ms_fused']:.3f}; "
        f"launches " + ", ".join(f"{k} {v}" for k, v in launches.items()))
    return dict(legacy, launches=launches)


# phase 20: serving and long context. (a) `python -m repro_torch.launch.serve`
# at its (the reference's) defaults for one model of each family at full
# width and depth; (b) each of them in f32, decoded over a prompt against
# `apply_model` over it; (c) prefill_32k's length through the flash path;
# (d) decode_32k and long_500k; (e) the trainer at --seq 8192 and the
# chunked-vocab loss against the full one
SERVE_ARCHS = ("qwen2-1.5b", "mamba2-2.7b", "zamba2-2.7b", "olmoe-1b-7b",
               "llama-3.2-vision-11b", "musicgen-large")
SERVE_ARGS = ["--batch", "4", "--prompt-len", "8", "--new-tokens", "8"]
# phase 20 (a) serves each family at full width cut to about a quarter of
# its depth (whole layer groups): the phase times serving and holds it
# against nothing; phase 20 (b) compares at full depth
SERVE_LAYERS = {"qwen2-1.5b": 7, "mamba2-2.7b": 16, "zamba2-2.7b": 12, "olmoe-1b-7b": 4,
                "llama-3.2-vision-11b": 10, "musicgen-large": 12}
SERVE_STEADY = 4  # decode steps after the prompt, timed, then as many profiled
EXACT_BATCH, EXACT_PROMPT = 2, 64
# decode against prefill, max |gap| over the largest |logit| (f32, TF32
# off), a bound for each model from its own readings. The attention, moe,
# vlm and audio families and the ring read 1.7e-6 to 2.8e-6 on the card
# (qwen2 5.0e-7, musicgen 1.2e-6 on the CPU, scripts/decode_gap_reference.py):
# 1e-4.
# The SSD's chunked scan drifts from the recurrence in f32: mamba2 read
# 1.830e-3 on the card (1.6e-4 on the CPU at reduced width), zamba2
# 3.707e-4: 5e-3 and 2e-3. `F64_ARCH` in f64 shows that drift to be
# rounding: there decode and prefill agree within `F64_REL_TOL`.
EXACT_REL_TOL = {"qwen2-1.5b": 1e-4, "mamba2-2.7b": 5e-3, "zamba2-2.7b": 2e-3,
                 "olmoe-1b-7b": 1e-4, "llama-3.2-vision-11b": 1e-4, "musicgen-large": 1e-4}
F64_ARCH = "mamba2-2.7b"
F64_REL_TOL = 1e-10  # f64 rounding: 1.5e-14 on the CPU at 4 layers
# the kernel's prefill against the plain SSD step's, as phase 2 holds the
# kernel against its plain version
SSD_PREFILL_REL_TOL = 1e-5
RING_WINDOW, RING_TOKENS = 64, 200
PREFILL_PREFIX = 4096
PREFILL_BATCH = 1  # prefill_32k's batch of 32, cut to 1
# bf16 flash path against bf16 full attention, max |gap| over the largest
# |logit|: 2.2e-2 on the CPU at 28 reduced-width layers; x ~4.5
BF16_REL_TOL = 0.1
DECODE_BATCH = 32  # decode_32k's batch of 128, cut to 32 (~30 GB of cache)
DECODE_STEPS = 8
LONG_POS = 524_000
LONG_TRAIN_STEPS = 1
LONG_TRAIN_ARGS = ["--arch", "qwen2-1.5b", "--clients", "2", "--batch-per-client", "1",
                   "--seq", "8192", "--steps", str(LONG_TRAIN_STEPS), "--psi", "1",
                   "--log-every", str(LONG_TRAIN_STEPS)]
VOCAB_CHUNK = 1024
# chunked against full loss in bf16: the loss within 1e-3 of itself, each
# leaf's gradient within 5e-2 in L2. The card read 1.847e-2 at the
# attention's bk, wq and wk, where each bf16 path lies 3.3e-2 to 3.9e-2
# from an f32 copy's gradient (the head's own gradient 5.7e-3): bf16
# rounding, 2.7x under the bound. Held also against that f32 gradient: the
# chunked path's largest leaf gap to it within `GRAD_F32_RATIO` of the
# full path's (1.03 on the card); a fault in the chunking moves a
# gradient by ~1/8 or more.
LOSS_REL_TOL, GRAD_REL_TOL, GRAD_F32_RATIO = 1e-3, 5e-2, 2.0


def watched(torch, fn):
    """`fn()` under the sync detector, the device synchronised after:
    (result, seconds, host syncs seen)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, [str(w.message) for w in caught
                       if "called a synchronizing" in str(w.message)]


def device_busy_us(torch, fn):
    """Device time of every kernel of one profiled `fn()`; None when the
    profiler records none."""
    try:
        with card_profile() as prof:
            fn()
            torch.cuda.synchronize()
        busy = sum(r[0] for r in device_rows(prof))
    except (RuntimeError, AttributeError) as exc:
        log(f"    profiler: not measured ({exc})")
        return None
    return busy if busy > 0 else None


def idle_text(busy_us, wall_s):
    return "idle not measured" if busy_us is None else \
        f"{100 - 100 * busy_us / (wall_s * 1e6):.2f}% idle"


def steady_decode(torch, cfg, params, prompts, cross_embeds, dev):
    """`SERVE_STEADY` greedy decode steps after the prompt under the sync
    detector, then as many more profiled: (wall s of the first, device
    busy us of the second, host syncs)."""
    from repro_torch.models import model as M

    b, p = prompts.shape
    state = M.init_decode_state(cfg, b, p + 2 * SERVE_STEADY, dev)
    cross_kv = M.init_cross_kv(params, cfg, cross_embeds) if cfg.family == "vlm" else None

    def feed(tok):  # as serve_batch: an embeds-in model takes its token's embedding
        return params["embed"][tok][:, None, :].to(cfg.torch_dtype) if cfg.embeds_in else tok

    logits = None
    for i in range(p):
        logits, state = M.decode_step(params, cfg, feed(prompts[:, i]), state, cross_kv)
    held = [torch.argmax(logits, dim=-1), state]

    def steps():
        for _ in range(SERVE_STEADY):
            out, held[1] = M.decode_step(params, cfg, feed(held[0]), held[1], cross_kv)
            held[0] = torch.argmax(out, dim=-1)

    _, wall, syncs = watched(torch, steps)
    return wall, device_busy_us(torch, steps), syncs


def phase_serve(torch, dev):
    """Phase 20 (a): `serve.main` at `SERVE_ARGS` for each of `SERVE_ARCHS`
    at full width and depth, in its dtype. Its `serve_batch` call runs
    under the sync detector (0 host syncs); then the same call again,
    timed (ms per decode step, prompt steps included, and aggregate
    tok/s), and `steady_decode` on its inputs (device idle share of
    steady decode steps)."""
    import contextlib
    import io

    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve

    rows = {}
    real = serve.serve_batch
    for arch in SERVE_ARCHS:
        cfg = get_config(arch).with_(num_layers=SERVE_LAYERS[arch])
        held = {}

        def first_call(cfg_, params, prompts, max_new, **kw):
            call = lambda: real(cfg_, params, prompts, max_new, **kw)  # noqa: E731
            toks, _, syncs = watched(torch, call)
            held.update(call=call, syncs=syncs, steps=prompts.shape[1] + max_new,
                        batch=prompts.shape[0], new=max_new,
                        steady=lambda: steady_decode(torch, cfg_, params, prompts,
                                                     kw.get("cross_embeds"), dev))
            return toks

        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = io.StringIO()
        serve.serve_batch = first_call
        try:
            with contextlib.redirect_stdout(out):
                toks = serve.main(["--arch", arch, *SERVE_ARGS, "--device", dev], cfg=cfg)
        finally:
            serve.serve_batch = real
        for line in out.getvalue().splitlines():
            log(f"    {line}")
        _, wall, syncs = watched(torch, held["call"])
        steady_wall, busy, steady_syncs = held["steady"]()
        syncs += steady_syncs
        peak = torch.cuda.max_memory_allocated()
        in_range = bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
        steps = held["steps"]
        row = dict(dtype=cfg.dtype, batch=held["batch"], ms_step=wall / steps * 1e3,
                   tok_s=held["batch"] * held["new"] / wall,
                   busy_us=busy, wall=steady_wall, peak=peak,
                   syncs=len(held["syncs"]) + len(syncs))
        log(f"  serve {arch} ({cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.dtype}): "
            f"tokens {tuple(toks.shape)} in range {in_range}; {row['ms_step']:.3f} ms per "
            f"decode step ({steps} steps of batch {held['batch']}), {row['tok_s']:.1f} tok/s "
            f"aggregate; {SERVE_STEADY} steady decode steps: device busy "
            f"{0 if busy is None else busy / 1e3:.3f} ms of {steady_wall * 1e3:.3f} "
            f"({idle_text(busy, steady_wall)}); peak {peak / 2**30:.2f} GiB; host syncs in "
            f"the decode loops {row['syncs']}; {time.perf_counter() - t0:.1f} s")
        if row["syncs"] or not in_range:
            raise AssertionError(f"serve {arch}: syncs {held['syncs'] + syncs}, "
                                 f"tokens in range {in_range}")
        rows[arch] = row
        held.clear()
        del toks
    torch.cuda.empty_cache()
    return rows


def prompt_batch(torch, cfg, gen, b, s, dev):
    """Random prompt inputs: tokens (an embeds-in model: embeddings) and,
    for a vlm, patch embeddings."""
    if cfg.embeds_in:
        batch = {"embeds": torch.randn((b, s, cfg.d_model), generator=gen, device=dev
                                       ).to(cfg.torch_dtype)}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)}
    if cfg.family == "vlm":
        batch["cross_embeds"] = torch.randn((b, cfg.num_patch_tokens, cfg.d_model),
                                            generator=gen, device=dev).to(cfg.torch_dtype)
    return batch


def decode_against_prefill(torch, cfg, params, batch, dev, chunk_fn=None):
    """`decode_step` over the prompt (under the sync detector) and
    `apply_model` over it (its SSD through `chunk_fn`, default the
    kernel): (decode logits, prefill logits, host syncs)."""
    from repro_torch.models import model as M

    with torch.no_grad():
        full, _ = M.apply_model(params, cfg, batch, chunk_fn=chunk_fn)
    inputs = batch["embeds"] if cfg.embeds_in else batch["tokens"]
    b, s = inputs.shape[:2]
    state = M.init_decode_state(cfg, b, s, dev)
    cross_kv = M.init_cross_kv(params, cfg, batch["cross_embeds"]) \
        if cfg.family == "vlm" else None

    def loop():
        st, outs = state, []
        for t in range(s):
            x = inputs[:, t:t + 1] if cfg.embeds_in else inputs[:, t]
            logits, st = M.decode_step(params, cfg, x, st, cross_kv)
            outs.append(logits)
        return torch.stack(outs, 1)

    dec, _, syncs = watched(torch, loop)
    return dec, full, len(syncs)


def rel_gap(a, b):
    """max |a - b| over the largest |b|."""
    return float((a - b).abs().max() / b.abs().max())


def f64_witness(torch, cfg, params, batch, dev, dec32, full32):
    """`F64_ARCH` in f64 with the same weights (the prefill through the
    plain SSD step: the kernel takes f32 and bf16): its decode against its
    prefill, and the f32 decode and the f32 kernel prefill against the f64
    prefill."""
    from repro_torch.core import flat as flat_lib
    from repro_torch.kernels.ssd.ref import ssd_chunk_ref

    t0 = time.perf_counter()
    p64 = flat_lib.tree_map(lambda t: t.double() if t.is_floating_point() else t, params)
    dec, full, syncs = decode_against_prefill(torch, cfg.with_(dtype="float64"), p64, batch, dev,
                                              chunk_fn=ssd_chunk_ref)
    del p64
    row = dict(gap=rel_gap(dec, full), dec32=rel_gap(dec32.double(), full),
               full32=rel_gap(full32.double(), full))
    log(f"  {cfg.name} in f64: decode against prefill {row['gap']:.3e} of the largest |logit| "
        f"(bound {F64_REL_TOL}); against the f64 prefill, the f32 decode {row['dec32']:.3e} "
        f"and the f32 kernel prefill {row['full32']:.3e}; host syncs {syncs}; "
        f"{time.perf_counter() - t0:.1f} s")
    if not row["gap"] <= F64_REL_TOL or syncs:
        raise AssertionError(f"{cfg.name}: f64 decode and prefill differ ({row['gap']:.3e})")
    return row


def phase_exact(torch, dev):
    """Phase 20 (b): each of `SERVE_ARCHS` in f32 (TF32 off; olmoe with a
    capacity factor of E / k, so that no expert drops a prompt token),
    one at a time: the decode over an `EXACT_PROMPT`-token prompt at batch
    `EXACT_BATCH` against `apply_model` over it, within its
    `EXACT_REL_TOL` of the largest |logit| (mamba2 and zamba2: the
    recurrence against the `ssd_chunk` kernel's forward, and that prefill
    against the plain SSD step's within `SSD_PREFILL_REL_TOL`); for qwen2
    also a `RING_WINDOW`-slot ring over `RING_TOKENS` tokens against
    windowed `apply_model`; `F64_ARCH` also in f64 (`f64_witness`)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.ssd.ref import ssd_chunk_ref
    from repro_torch.models import model as M

    rows = {}
    for arch in SERVE_ARCHS:
        cfg = get_config(arch).with_(dtype="float32")
        if cfg.family == "moe":
            cfg = cfg.with_(capacity_factor=cfg.num_experts / cfg.experts_per_token)
        gen = torch.Generator(device=dev).manual_seed(SEED + 200)
        params = M.init_params(gen, cfg)
        cases = [(arch, cfg, prompt_batch(torch, cfg, gen, EXACT_BATCH, EXACT_PROMPT, dev))]
        if arch == "qwen2-1.5b":
            ring = cfg.with_(sliding_window=RING_WINDOW)
            cases.append((f"{arch} ring of {RING_WINDOW}", ring,
                          prompt_batch(torch, ring, gen, EXACT_BATCH, RING_TOKENS, dev)))
        for label, c, batch in cases:
            t0 = time.perf_counter()
            dec, full, syncs = decode_against_prefill(torch, c, params, batch, dev)
            gap, tol = rel_gap(dec, full), EXACT_REL_TOL[arch]
            rows[label] = dict(gap=gap)
            plain = ""
            if c.family in ("ssm", "hybrid"):
                with torch.no_grad():
                    ref, _ = M.apply_model(params, c, batch, chunk_fn=ssd_chunk_ref)
                rows[label].update(plain=rel_gap(dec, ref), kernel=rel_gap(full, ref))
                plain = (f"; against the prefill through the plain SSD step "
                         f"{rows[label]['plain']:.3e}; the kernel's prefill against that "
                         f"{rows[label]['kernel']:.3e} (bound {SSD_PREFILL_REL_TOL})")
                del ref
            log(f"  decode against prefill, {label} ({c.num_layers} layers, f32, batch "
                f"{EXACT_BATCH}, {next(iter(batch.values())).shape[1]} positions): max |gap| "
                f"{float((dec - full).abs().max()):.3e}, largest |logit| "
                f"{float(full.abs().max()):.3e}, ratio {gap:.3e} (bound {tol}){plain}; "
                f"host syncs {syncs}; {time.perf_counter() - t0:.1f} s")
            if not gap <= tol or syncs:
                raise AssertionError(f"{label}: decode and prefill differ ({gap:.3e})")
            if not rows[label].get("kernel", 0.0) <= SSD_PREFILL_REL_TOL:
                raise AssertionError(f"{label}: the kernel's prefill and the plain SSD step's "
                                     f"differ ({rows[label]['kernel']:.3e})")
            if arch == F64_ARCH:
                rows[label]["f64"] = f64_witness(torch, c, params, batch, dev, dec, full)
            del dec, full
        del params, cases
        torch.cuda.empty_cache()
    return rows


def phase_prefill(torch, dev, params, cfg):
    """Phase 20 (c): `make_prefill_step` at prefill_32k's length (batch
    `PREFILL_BATCH`), time and peak memory; `apply_model` at that length
    (the flash path) finite, its first `PREFILL_PREFIX` positions against
    `apply_model` on that prefix (full attention) and its last against
    the step's, within `BF16_REL_TOL` of the largest |logit|."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import steps
    from repro_torch.models import model as M

    shape = SHAPES["prefill_32k"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 201)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, shape.seq_len), generator=gen,
                           device=dev)
    prefill = steps.make_prefill_step(cfg, shape)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    last = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t0
    peak_step = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, _ = M.apply_model(params, cfg, {"tokens": tokens})
        torch.cuda.synchronize()
        t_logits = time.perf_counter() - t0
        finite = bool(torch.isfinite(logits).all())
        prefix, _ = M.apply_model(params, cfg, {"tokens": tokens[:, :PREFILL_PREFIX]})
    a, b = logits[:, :PREFILL_PREFIX].float(), prefix.float()
    gap, scale = float((a - b).abs().max()), float(b.abs().max())
    rms = float((a - b).norm() / b.norm())
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    last_gap = float((last.float() - logits[:, -1].float()).abs().max())
    last_scale = float(logits[:, -1].float().abs().max())
    peak = torch.cuda.max_memory_allocated()
    log(f"  prefill {cfg.name} (bf16) at S = {shape.seq_len}, batch {PREFILL_BATCH}: "
        f"make_prefill_step {t_step:.3f} s (peak {peak_step / 2**30:.2f} GiB); apply_model "
        f"with the (B, S, V) logits {t_logits:.3f} s, finite {finite} (peak with the "
        f"{PREFILL_PREFIX}-token prefix {peak / 2**30:.2f} GiB); first {PREFILL_PREFIX} "
        f"positions against full attention on the prefix: max |gap| {gap:.3e} of "
        f"{scale:.3e} ({gap / scale:.3e}, bound {BF16_REL_TOL}), rms {rms:.3e}, argmax "
        f"agreement {agree:.4f}; the step's last logits against apply_model's: "
        f"{last_gap:.3e} of {last_scale:.3e}")
    if not finite or not gap / scale <= BF16_REL_TOL or not last_gap / last_scale <= \
            BF16_REL_TOL:
        raise AssertionError("prefill: non-finite logits or flash against full too far")
    del logits, prefix, a, b, last
    torch.cuda.empty_cache()
    return dict(s=t_step, peak=peak_step, rel=gap / scale)


def decode_steps(torch, dev, params, cfg, shape_name, batch, pos, label):
    """`DECODE_STEPS` serve steps (`make_serve_step` under `shape_name`)
    from `pos` against a random cache: a warm-up pass, then one under the
    sync detector; ms per step and peak memory."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.models.attention import KVCache

    shape = SHAPES[shape_name]
    scfg = steps.serve_config(cfg, shape)
    gen = torch.Generator(device=dev).manual_seed(SEED + 202)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = M.init_decode_state(scfg, batch, shape.seq_len, dev)
    for cache in state.caches.values():
        for leaf in cache:
            leaf.normal_(generator=gen)
    state = state._replace(pos=torch.tensor(pos, dtype=torch.int32, device=dev))
    tok = torch.randint(0, cfg.vocab_size, (batch,), generator=gen, device=dev)
    step = steps.make_serve_step(cfg, shape)

    def loop():
        st, logits = state, None
        for _ in range(DECODE_STEPS):
            logits, st = step(params, tok, st)
        return logits, st

    loop()
    (logits, st), wall, syncs = watched(torch, loop)
    peak = torch.cuda.max_memory_allocated()
    cache_bytes = sum(leaf.numel() * leaf.element_size()
                      for cache in state.caches.values() for leaf in cache)
    finite = bool(torch.isfinite(logits).all())
    slots = [c.k.shape[2] for c in state.caches.values() if isinstance(c, KVCache)]
    log(f"  {label}: {cfg.name} batch {batch}, pos {pos}..{pos + DECODE_STEPS - 1}, cache "
        f"{cache_bytes / 1e9:.2f} GB ({f'{slots[0]} KV slots' if slots else 'SSM state'}, "
        f"sliding window {scfg.sliding_window}): {wall / DECODE_STEPS * 1e3:.3f} ms per step; "
        f"peak {peak / 2**30:.2f} GiB; finite {finite}; host syncs {len(syncs)}")
    if not finite or syncs or int(st.pos) != pos + DECODE_STEPS:
        raise AssertionError(f"{label}: finite {finite}, syncs {syncs}")
    del state, st, logits
    torch.cuda.empty_cache()
    return dict(ms_step=wall / DECODE_STEPS * 1e3, peak=peak, cache=cache_bytes)


def phase_long_train(torch, dev):
    """Phase 20 (e): the trainer `main` at full width with --seq 8192 (the
    flash path), then `lm_loss` with ``vocab_chunk`` `VOCAB_CHUNK` and 0 on
    one client's parameters at that shape: losses and each leaf's
    gradient within `LOSS_REL_TOL` and `GRAD_REL_TOL`, the chunked
    gradients against an f32 copy's within `GRAD_F32_RATIO` of the full
    loss's; `head_grad_gaps`."""
    from repro_torch.configs.base import get_config
    from repro_torch.core import flat as flat_lib
    from repro_torch.models import model as M

    cfg = get_config("qwen2-1.5b")
    launches, s_step, peak = run_trainer(torch, LONG_TRAIN_ARGS + ["--device", dev], cfg,
                                         LONG_TRAIN_STEPS, "20 (e)")
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(SEED + 203)
    params = M.init_params(gen, cfg)
    seq = int(LONG_TRAIN_ARGS[LONG_TRAIN_ARGS.index("--seq") + 1])
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, seq), generator=gen, device=dev)}
    runs = {}
    for vc in (VOCAB_CHUNK, 0):
        p = flat_lib.tree_map(lambda x: x.detach().requires_grad_(), params)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = M.lm_loss(p, cfg, batch, vocab_chunk=vc)
        grads = torch.autograd.grad(loss, flat_lib.tree_leaves(p))
        torch.cuda.synchronize()
        runs[vc] = dict(loss=float(loss.detach()), grads=grads, s=time.perf_counter() - t0,
                        peak=torch.cuda.max_memory_allocated())
        del p, loss
    chunked, full = runs[VOCAB_CHUNK], runs[0]
    loss_rel = abs(chunked["loss"] - full["loss"]) / abs(full["loss"])
    p32 = flat_lib.tree_map(lambda x: x.detach().float().requires_grad_(), params)
    truth = torch.autograd.grad(M.lm_loss(p32, cfg.with_(dtype="float32"), batch,
                                          vocab_chunk=VOCAB_CHUNK), flat_lib.tree_leaves(p32))
    del p32

    def l2(a, b):
        return float((a.float() - b).norm() / b.norm())

    # (chunked against full, chunked against f32, full against f32, leaf)
    gaps = sorted(((l2(a, b.float()), l2(a, t), l2(b, t), "/".join(path))
                   for (path, _), a, b, t in zip(flat_lib.tree_items(params), chunked["grads"],
                                                 full["grads"], truth) if float(t.norm()) > 0),
                  reverse=True)
    grad_rel = gaps[0][0]
    log(f"  lm_loss at S = {seq}, batch 1: vocab_chunk {VOCAB_CHUNK} loss "
        f"{chunked['loss']:.6f} in {chunked['s']:.3f} s, peak {chunked['peak'] / 2**30:.2f} "
        f"GiB; vocab_chunk 0 loss {full['loss']:.6f} in {full['s']:.3f} s, peak "
        f"{full['peak'] / 2**30:.2f} GiB; loss gap {loss_rel:.3e} (bound {LOSS_REL_TOL}), "
        f"leaf gradient gaps (bound {GRAD_REL_TOL}; each path's gap to the f32 gradient): "
        + ", ".join(f"{name} {g:.3e} ({a:.3e}, {b:.3e})" for g, a, b, name in gaps[:3]))
    worst_ratio = max(gaps, key=lambda r: r[1] / r[2])
    to_f32 = (max(r[1] for r in gaps), max(r[2] for r in gaps))
    log(f"    over all {len(gaps)} leaves: the chunked path at most {to_f32[0]:.3e} from the "
        f"f32 gradient, the full path at most {to_f32[1]:.3e} (ratio bound {GRAD_F32_RATIO}); "
        f"the largest leaf ratio {worst_ratio[1] / worst_ratio[2]:.3f} ({worst_ratio[3]}: "
        f"{worst_ratio[1]:.3e} against {worst_ratio[2]:.3e})")
    del runs, chunked, full, truth
    head = head_grad_gaps(torch, params, cfg, batch)
    if not loss_rel <= LOSS_REL_TOL or not grad_rel <= GRAD_REL_TOL or \
            not to_f32[0] <= GRAD_F32_RATIO * to_f32[1]:
        raise AssertionError("chunked-vocab loss against the full loss too far")
    del params
    torch.cuda.empty_cache()
    return dict(launches=launches, s_step=s_step, peak=peak, loss_rel=loss_rel,
                grad_rel=grad_rel, to_f32=to_f32, head=head)


def head_grad_gaps(torch, params, cfg, batch):
    """The head's share of the gradient of its weight `w`, the hidden
    states held fixed: `w`'s gradient through one product over all
    positions (as the full loss takes it) against the sum over
    `VOCAB_CHUNK`-position chunks, summed by autograd in `w`'s dtype (as
    `lm_loss` sums them) and summed in f32. Relative L2 gaps (that sum,
    the f32 sum)."""
    from repro_torch.models import model as M

    with torch.no_grad():
        h, _ = M.apply_model(params, cfg, batch, return_hidden=True)
    labels, mask = M._labels_and_mask(batch)
    w = M._head(params, cfg).detach().requires_grad_()
    one, = torch.autograd.grad(M._chunk_nll(h, w, labels, mask), w)
    spans = [slice(c, c + VOCAB_CHUNK) for c in range(0, h.shape[1], VOCAB_CHUNK)]
    summed, = torch.autograd.grad(sum(M._chunk_nll(h[:, s], w, labels[:, s], mask[:, s])
                                      for s in spans), w)
    wide = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
    for s in spans:
        wide += torch.autograd.grad(M._chunk_nll(h[:, s], w, labels[:, s], mask[:, s]),
                                    w)[0].float()
    one = one.float()
    out = (float((summed.float() - one).norm() / one.norm()),
           float((wide - one).norm() / one.norm()))
    log(f"  the head's gradient ({cfg.dtype} {tuple(w.shape)}), the hidden states fixed, "
        f"against one product over the {h.shape[1]} positions: {len(spans)} chunks summed "
        f"in {cfg.dtype} {out[0]:.3e}, summed in f32 {out[1]:.3e}")
    return out


def log_serving(r):
    """Phase 20's summary lines."""
    for arch, row in r["serve"].items():
        log(f"serving path ({arch}, {row['dtype']}, batch {row['batch']}): {row['ms_step']:.3f} "
            f"ms per decode step, "
            f"{row['tok_s']:.1f} tok/s aggregate, {idle_text(row['busy_us'], row['wall'])} "
            f"over {SERVE_STEADY} steady steps, "
            f"peak {row['peak'] / 2**30:.2f} GiB")
    log(f"long context: prefill {r['prefill']['s']:.3f} s at S = 32,768 (peak "
        f"{r['prefill']['peak'] / 2**30:.2f} GiB); " + ", ".join(
            f"{k} {v['ms_step']:.3f} ms/step (peak {v['peak'] / 2**30:.2f} GiB)"
            for k, v in r["decode"].items())
        + f"; trainer at --seq 8192 {r['train']['s_step']:.4f} s/step (peak "
        f"{r['train']['peak'] / 2**30:.2f} GiB)")


def phase_serving(torch, dev="cuda"):
    """Phase 20: (a) serving at full width, (b) decode against prefill in
    f32, (c) the 32k prefill, (d) decode at long contexts, (e) the
    long-context trainer and the chunked loss. Returns the launches of
    each kernel over the phase and its rows."""
    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.models import model as M

    t0 = time.perf_counter()
    reset_launches()
    serve_rows = phase_serve(torch, dev)
    log(f"phase 20 (a): {time.perf_counter() - t0:.1f} s")
    exact = phase_exact(torch, dev)
    log(f"phase 20 (b): {time.perf_counter() - t0:.1f} s")
    cfg = get_config("qwen2-1.5b")
    params = M.init_params(SEED + 204, cfg, dev)
    prefill = phase_prefill(torch, dev, params, cfg)
    log(f"phase 20 (c): {time.perf_counter() - t0:.1f} s")
    decode = {"decode_32k": decode_steps(torch, dev, params, cfg, "decode_32k", DECODE_BATCH,
                                         SHAPES["decode_32k"].seq_len - DECODE_STEPS,
                                         "decode_32k")}
    decode["long_500k"] = decode_steps(torch, dev, params, cfg, "long_500k", 1, LONG_POS,
                                       "long_500k")
    del params
    torch.cuda.empty_cache()
    mamba = get_config("mamba2-2.7b")
    params = M.init_params(SEED + 205, mamba, dev)
    decode["long_500k mamba2"] = decode_steps(torch, dev, params, mamba, "long_500k", 1,
                                              LONG_POS, "long_500k")
    del params
    torch.cuda.empty_cache()
    log(f"phase 20 (d): {time.perf_counter() - t0:.1f} s")
    launches = launch_counts()
    train = phase_long_train(torch, dev)
    for k, v in train["launches"].items():
        launches[k] += v
    log(f"phase 20 serving and long context: {time.perf_counter() - t0:.1f} s; launches "
        + ", ".join(f"{k} {v}" for k, v in launches.items()))
    return dict(launches=launches, serve=serve_rows, exact=exact, prefill=prefill,
                decode=decode, train=train)


FAMILY_MIX_PLANES = (("olmoe-1b-7b", 6), ("musicgen-large", 48),
                     ("llama-3.2-vision-11b", 10))  # the planes of phases 15-18's profiles


def family_mix_times(torch):
    """The mix at the new families' trainer planes (`FAMILY_MIX_PLANES`, N
    = 2, f32, K = the model's Dflat at that depth): the kernel (zero
    flush), its plain version (which mixes a plane past 2^27 columns in
    dense slices) and the library: one `torch.matmul` over the whole
    plane where cuBLAS takes it, else its refusal and `torch.matmul`
    over the plain version's dense slices. Returns one row per plane."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.flat import tree_leaves
    from repro_torch.kernels.gossip import ops
    from repro_torch.models import model as M

    flush = flushes(torch)["zero"]
    rows = []
    for arch, layers in FAMILY_MIX_PLANES:
        params = M.init_params(SEED, get_config(arch).with_(num_layers=layers), "cuda")
        k = sum(p.numel() for p in tree_leaves(params))
        del params
        torch.cuda.empty_cache()
        q, deltas = mix_case(torch, 2, k, torch.float32, seed=11)
        kern = time_ms(torch, lambda: ops.gossip_mix(q, deltas), reps=5, flush=flush)
        plain = time_ms(torch, lambda: ops.gossip_mix_reference(q, deltas), reps=2)
        qt, refusal = q.T.contiguous(), None
        try:
            out = torch.matmul(qt, deltas)
            torch.cuda.synchronize()
            del out
            lib = time_ms(torch, lambda: torch.matmul(qt, deltas), reps=2)
        except RuntimeError as exc:
            refusal = str(exc).splitlines()[0][:160]

            def sliced():
                for lo in range(0, k, SLICE):
                    torch.matmul(qt, deltas[:, lo:lo + SLICE].contiguous())

            lib = time_ms(torch, sliced, reps=2)
        bound, by = bound_ms("mix", 2, k, 4)
        log(f"  mix N=2 K={k} f32 ({arch}, {layers} layers, K % 4 = {k % 4}): kernel "
            f"{kern:.4f} ms, bound {bound:.4f} ms ({by}, {100 * bound / kern:.1f}% of bound), "
            f"plain {plain:.4f} ms, library "
            + (f"torch.matmul {lib:.4f} ms" if refusal is None else
               f"refused by cuBLAS ({refusal}); torch.matmul over dense {SLICE}-column "
               f"slices {lib:.4f} ms"))
        rows.append(dict(arch=arch, k=k, ms=kern, plain_ms=plain, library_ms=lib,
                         refused=refusal, bound_ms=bound))
        del q, deltas
        torch.cuda.empty_cache()
    return rows


def log_families(rows):
    """One summary line per family trainer of phases 15-18."""
    for label, r in rows.items():
        cfg = r["cfg"]
        share = r["busy_us"] / (r["steady_s"] * 1e6)
        idle = f"{100 - 100 * share:.2f}% idle" if r["busy_us"] > 0 else "idle not measured"
        log(f"trainer path ({cfg.name}, phase {label}, {cfg.num_layers} layers): "
            f"{r['s_step']:.4f} s/step over {FAMILY_STEPS} steps with init; at "
            f"{r['plain_layers']} layers (Dflat {r['dflat']}) {r['steady_s']:.4f} s/step "
            f"steady, device busy {r['busy_us'] / 1e3:.3f} "
            f"ms/step ({idle}), " + ", ".join(f"{k} {v / 1e3:.3f} ms/step"
                                              for k, v in r["kernels"].items())
            + f"; peak {r['peak'] / 2**30:.2f} GiB")


# phase 2 and 9: the drain's rectangular route as the client mesh runs it,
# (J, N_loc, M, K, ring rows), K an (arch, layer groups) plane counted from
# the config's meta parameters (None: every group): the mesh trainer's
# dense mix at qwen2-1.5b's full plane (one bucket of each rank's 2
# senders against the 4 receivers) and the sharded fig4 window at 5 ranks
# (5 senders against 25 receivers). Phase 2 also holds phase 22's dense
# train pair: one sender a rank against 64 receivers over mamba2-2.7b's
# plane at 1 and 2 of its 64 layers (M K past 2^31; 40.3 and 49.9 GiB f32
# out)
RECT_QWEN2, RECT_FIG4 = (1, 2, 4, ("qwen2-1.5b", None), 1), (3, 5, 25, 146_447, 4)
# phase 23 (a)'s dense mix: each model rank's tile, qwen2-1.5b's plane at 2
# layers as one of 2 model ranks holds it (K = 163,491,328)
RECT_TP = (1, 2, 4, ("qwen2-1.5b", 2, 2), 1)
# phase 23 (d)'s: olmoe-1b-7b's plane at 2 layers as one of 2 model ranks
# holds it, 2 senders against 2 receivers on one client rank
RECT_TP_MOE = (1, 2, 2, ("olmoe-1b-7b", 2, 2), 1)
# phase 23 (f)'s and (g)'s: mamba2-2.7b's plane at 2 layers and zamba2-2.7b's
# at 6 (one group) as one of 2 model ranks holds it, 2 senders against 2
# receivers on one client rank
RECT_TP_SSM = {"mamba2 plane of one model rank": (1, 2, 2, ("mamba2-2.7b", 2, 2), 1),
               "zamba2 plane of one model rank": (1, 2, 2, ("zamba2-2.7b", 1, 2), 1)}
RECT_DRY = {f"mamba2 plane at {d} layer(s)": (1, 1, 64, ("mamba2-2.7b", d), 1) for d in (1, 2)}
# phase 23 (i)'s and (j)'s: llama-3.2-vision-11b's plane at one group (5
# layers) and musicgen-large's at 2 layers as one of 2 model ranks holds
# it, 2 senders against 2 receivers on one client rank. The vlm's K =
# 1,070,641,153 is odd (K % 4 = 1: its rows start 4-byte aligned in f32,
# 2-byte in bf16), the first such rectangular tile; musicgen's K % 4 = 0
RECT_TP_CROSS = {"vlm plane of one model rank": (1, 2, 2, ("llama-3.2-vision-11b", 1, 2), 1),
                 "musicgen plane of one model rank": (1, 2, 2, ("musicgen-large", 2, 2), 1)}
# phase 21: the client mesh (`repro_torch.launch.mesh`). (a) the sharded
# drain at fig4's window (J 3, N = M 25, K 146,447), over NCCL at one rank
# per card and over gloo at MESH_RANKS ranks sharing the card; (c) fig4's
# Psi grid (SWEEP_PSIS) at the fig3 EMNIST setup, MESH_SWEEP_SEEDS seeds x
# MESH_SWEEP_WINDOWS windows, in the same gloo world, against the unsharded
# sweep in this process: params within PATH_TOL and the same acceptances.
# The sharded drain's call is timed over MESH_DRAIN_REPS calls after its
# checked one (a time held against nothing: 3 calls)
MESH_DRAIN, MESH_RANKS, MESH_DRAIN_REPS = (3, 25, 146_447), 5, 3
MESH_SWEEP_SEEDS, MESH_SWEEP_WINDOWS, MESH_SWEEP_EVAL = 2, 30, 10
# (d) every other registered algorithm through `simulate_sweep(mesh=)` in
# (c)'s world: the baselines at fig3_config() for MESH_ALGO_ROUNDS rounds,
# fedasync-window at event_config() for MESH_SWEEP_SEEDS seeds x
# MESH_ALGO_ROUNDS windows, the event family on the first MESH_ALGO_EVENTS
# rows of phase 14's tape; each against its unsharded run in this process
# (params within PATH_TOL, the counters of MESH_COUNTERS exact), one drain
# launch a rank a round, batched window and valid event, no mix launch
MESH_BASELINES = ("sync-symm", "sync-push", "async-symm", "async-push")
MESH_EVENTS = ("draco-event", "fedasync-gossip", "event-triggered")
MESH_ALGOS = MESH_BASELINES + ("fedasync-window",) + MESH_EVENTS
MESH_ALGO_ROUNDS, MESH_ALGO_EVENTS = 10, 60
MESH_COUNTERS = ("push_weight", "total_accept", "accept_count", "tx_sent", "tx_count")
# (d)'s drain tiles on each of the MESH_RANKS ranks, (J, N_loc, M, K, ring
# rows): a baseline round's mix (one bucket) and an event's drain (the D
# slots of the ring), each held in phase 2, run sharded in (a)'s way in
# (c)'s world and timed in phase 9
RECT_MIX_TILE, RECT_EVENT_TILE = (1, 5, 25, 146_447, 1), (4, 5, 25, 146_447, 4)
MESH_TILES = {"baseline mix tile": RECT_MIX_TILE, "event drain tile": RECT_EVENT_TILE}
# (b) the mesh trainer `train.main --mesh-backend gloo` on qwen2-1.5b at full
# width, 4 clients, cut to MESH_LAYERS of its 28 layers: gloo stages every
# collective through host memory and the loopback, and the dense mix
# reduce-scatters a (4, K) f32 partial per rank (24.7 GB at 28 layers, K =
# 1,543,714,304; 5.2 GB at 2, K = 327,000,576, of which the tied embedding
# is 233,373,696), then holds step 1's mixed plane against the mix kernel
# on the gathered plane (another pass of the plane through the host). The
# none mode runs 2 steps (a unification after the second), its step 2 also
# held bit for bit; the others 1, since their step 2 is held against
# nothing (its inputs carry step 1's mix). Modes: (label, ranks, argv)
MESH_LAYERS = 2
MESH_TRAIN_ARGS = ["--arch", "qwen2-1.5b", "--clients", "4", "--batch-per-client", "2",
                   "--seq", "128", "--steps", "2", "--unify-every", "2", "--psi", "0",
                   "--lambda-tx", "50", "--log-every", "1", "--mesh-backend", "gloo"]
MESH_MODES = (("dense", 2, ["--mix", "dense", "--topology", "complete", "--steps", "1"]),
              ("dense bf16", 2, ["--mix", "dense", "--mix-dtype", "bfloat16",
                                 "--topology", "complete", "--steps", "1"]),
              ("none", 2, ["--mix", "none"]),
              ("ring", 4, ["--mix", "ring", "--steps", "1"]))
# Every sender transmits (lambda_tx 50, Psi 0), and the dense modes mix
# over the complete graph (weights 1/3), so that each receiver sums three
# senders from two ranks: on the cycle (weights 1/2, every product exact)
# a sum of two terms rounds alike in any order, and a window with one
# sender per receiver sums nothing. Step 1's mixed plane against the mix
# kernel on the gathered plane, relative to its largest |value|: f32 sums
# re-associated (dense); the partials sent and summed in bf16 (dense
# bf16); the ring's sum formed in the bf16 leaves' dtype, as the
# reference's (ring); the delta itself (none)
MESH_MIX_TOL = {"dense": 1e-5, "dense bf16": 1e-2, "ring": 1e-2, "none": 0.0}


def rect_k(torch, arch, groups, model=1):
    """`arch`'s per-client Dflat at full width, at `groups` layer groups
    (None: its full depth), as one of `model` ranks of "model" holds it."""
    from repro_torch.configs.base import get_config
    from repro_torch.core import flat as flat_lib
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.sharding.specs import tree_param_specs

    cfg = get_config(arch)
    if groups is not None:
        cfg = steps.depth_config(cfg, groups)
    params = steps.param_specs_abstract(cfg)
    if model > 1:
        mesh = mesh_lib.Mesh.dry((1, model), ("data", "model"))
        params = steps.local_abstract(params, tree_param_specs(params, mesh=mesh), mesh)
    return sum(p.numel() for p in flat_lib.tree_leaves(params))


def rect_case(torch, shape, dtype, seed):
    j, n, m, k, s = shape
    return drain_case(torch, j, n, m, k if isinstance(k, int) else rect_k(torch, *k), s, j,
                      dtype, seed)


def drain_against_plain(torch, ops, w, ring, slots, got):
    """(max |kernel - plain|, largest |plain|, agree?) over column slices
    of at most 4 SLICE / M columns, so that a multi-GB drain needs no
    second full-size plain result."""
    worst = scale = 0.0
    cols = min(SLICE, SLICE * 4 // w.shape[-1])
    for lo in range(0, ring.shape[-1], cols):
        want = ops.gossip_drain_reference(w, ring[..., lo:lo + cols].contiguous(), slots)
        part = got[:, lo:lo + cols]
        worst = max(worst, float((part - want).abs().max()))
        scale = max(scale, float(want.abs().max()))
        if not bool(torch.isfinite(part).all()):
            return worst, scale, False
    return worst, scale, True


def phase_rect_kernels(torch):
    """Phase 2: the drain's rectangular route at the client mesh's shapes
    (`RECT_QWEN2`, `RECT_FIG4`, `MESH_TILES`, `RECT_DRY`, `RECT_TP`,
    `RECT_TP_MOE`, `RECT_TP_SSM`, `RECT_TP_CROSS`) in f32 and bf16, against
    its plain version in column slices, within RTOL of the largest
    |value|."""
    from repro_torch.kernels.gossip import ops

    worst = 0.0
    for label, shape in (("qwen2 plane", RECT_QWEN2), ("fig4 window", RECT_FIG4),
                         *MESH_TILES.items(),
                         *RECT_DRY.items(), ("qwen2 plane of one model rank", RECT_TP),
                         ("olmoe plane of one model rank", RECT_TP_MOE),
                         *RECT_TP_SSM.items(), *RECT_TP_CROSS.items()):
        for i, dtype in enumerate((torch.float32, torch.bfloat16)):
            w, ring, slots = rect_case(torch, shape, dtype, seed=2000 + i)
            got = ops.gossip_drain(w, ring, slots)
            err, scale, finite = drain_against_plain(torch, ops, w, ring, slots, got)
            ok = finite and err <= RTOL * scale
            worst = max(worst, err)
            name = (f"rectangular {label} J={w.shape[0]} N={w.shape[1]} M={w.shape[2]} "
                    f"K={ring.shape[-1]} {'bf16' if i else 'f32'}")
            log(f"  drain {name}: max_abs_err={err:.3e} of largest |value| {scale:.3e} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"drain kernel disagrees with its plain version: {name}")
            del w, ring, got
            torch.cuda.empty_cache()
    log(f"phase 2 kernels: rectangular drain max_abs_err={worst:.3e}")
    return worst


def rect_time_cases(mesh=None, tp=None):
    """Phase 9's rectangular rows: (label, shape, the collective beside it)
    of phase 21's results `mesh` and phase 23's `tp` (either may be None)."""
    cases = []
    if mesh is not None:
        cases += [("qwen2 plane", RECT_QWEN2, mesh["train_collective_ms"]),
                  ("fig4 window", RECT_FIG4, mesh["gloo_collective_ms"])]
        cases += [(label, shape, mesh["tile_collective_ms"][label])
                  for label, shape in MESH_TILES.items()]
    if tp is not None:
        cases += [("qwen2 plane of one model rank", RECT_TP, tp["collective_ms"]),
                  ("olmoe plane of one model rank", RECT_TP_MOE, tp["moe_collective_ms"])]
        cases += [(label, shape, tp["plane_collective_ms"][label])
                  for label, shape in (*RECT_TP_SSM.items(), *RECT_TP_CROSS.items())]
    return cases


def phase_rect_times(torch, cases):
    """Phase 9's rectangular drain rows of `cases` (`rect_time_cases`):
    kernel, plain (in `SLICE`-column pieces at the qwen2 planes, where one
    plain call does not fit the card), one library call (the product over
    the same buckets), the bound (N_loc * K payload read, M * K f32
    written), and the collective beside them from phase 21 or 23 (its mean
    ms per call)."""
    from repro_torch.kernels.gossip import ops

    flush = flushes(torch)["zero"]
    rows = {}
    for label, shape, coll in cases:
        w, ring, slots = rect_case(torch, shape, torch.float32, seed=2100)
        j, n, m = w.shape
        k = ring.shape[-1]
        kern = time_ms(torch, lambda: ops.gossip_drain(w, ring, slots), reps=10, flush=flush)
        plain = sum(time_ms(torch, lambda lo=lo: ops.gossip_drain_reference(
            w, ring[..., lo:lo + SLICE], slots), reps=3, flush=flush)
            for lo in range(0, k, SLICE))
        # the buckets' ring rows in bucket order (the ring itself when it is)
        ordered = ring if slots == list(range(ring.shape[0])) else ring[
            torch.tensor(slots, device="cuda")]
        lib = time_ms(torch, lambda: torch.einsum("jnm,jnk->mk", w, ordered), reps=10,
                      flush=flush)
        bound, by = bound_ms("drain", j, n, m, k, 4)
        rows[label] = dict(ms=kern, plain_ms=plain, library_ms=lib, bound_ms=bound,
                           bound_by=by, collective_ms=coll)
        log(f"  drain rectangular {label} J={j} N_loc={n} M={m} K={k} f32: kernel "
            f"{kern:.4f} ms, bound {bound:.4f} ms ({by}, {100 * bound / kern:.1f}% of bound), "
            f"plain {plain:.4f} ms, library einsum {lib:.4f} ms; the mesh's collective "
            f"{coll['ms']:.3f} ms per call ({coll['what']})")
        del w, ring, ordered
        torch.cuda.empty_cache()
    return rows


def row_digest(torch, row):
    """Two int64 sums of a row's bit patterns (plain and position-weighted,
    wrapping), equal for equal rows: a bitwise comparison of multi-GB rows
    held in other processes."""
    v = row.contiguous().view(torch.int32)
    total = torch.zeros((), dtype=torch.int64, device=row.device)
    weighted = torch.zeros((), dtype=torch.int64, device=row.device)
    for lo in range(0, v.numel(), SLICE):
        c = v[lo:lo + SLICE].to(torch.int64)
        total += c.sum()
        weighted += (c * torch.arange(lo + 1, lo + 1 + c.numel(), device=row.device)).sum()
    return int(total), int(weighted)


def mesh_probe(torch, mesh_box, record):
    """Wrappers of `steps.mesh_mix` and `train.train_step_clients` (the
    pieces `steps.make_train_step` composes) for a rank: each step records
    its per-client losses, its delta rows' digests (`row_digest`), its
    time and its collective's, and whether the mixed plane is finite; step
    1 also holds the mixed plane against the mix kernel on the gathered
    plane, column slice by slice (the check's own time and collectives
    recorded apart). Step 1's inputs are the single-process trainer's bit
    for bit, so there the mix kernel on the gathered plane is that
    trainer's own mix."""
    from repro_torch.kernels.gossip import ops
    from repro_torch.launch import steps, train

    real_mix, real_clients = steps.mesh_mix, train.train_step_clients

    def mesh_mix(mesh, mix_mode="dense", mix_dtype=None, spec=None):
        fn = real_mix(mesh, mix_mode, mix_dtype, spec)
        mesh_box.append(mesh)

        def mix(q_eff, plane):
            torch.cuda.synchronize()
            c0, t0 = mesh.collective_s, time.perf_counter()
            mixed = fn(q_eff, plane)
            torch.cuda.synchronize()
            entry = dict(mix_s=time.perf_counter() - t0, collective_s=mesh.collective_s - c0,
                         digests=[row_digest(torch, r) for r in plane])
            c1, t1 = mesh.collective_s, time.perf_counter()
            entry["finite"] = bool(torch.isfinite(mixed).all())
            if not record:  # step 1: its inputs are the single-process trainer's
                n = q_eff.shape[0]
                q = q_eff
                if mix_mode == "ring":
                    q = torch.zeros_like(q_eff)
                    idx = torch.arange(n, device=q.device)
                    q[(idx - 1) % n, idx] = 0.5
                    q[(idx + 1) % n, idx] = 0.5
                sl = mesh.client_slice(n)
                err = scale = 0.0
                for lo in range(0, plane.shape[1], SLICE):
                    part = plane[:, lo:lo + SLICE].contiguous()
                    want = part if mix_mode == "none" else ops.gossip_mix(
                        q, mesh.all_gather(part))[sl]
                    err = max(err, float((mixed[:, lo:lo + SLICE] - want).abs().max()))
                    scale = max(scale, float(want.abs().max()))
                entry.update(err=err, scale=scale)
            torch.cuda.synchronize()
            entry.update(check_s=time.perf_counter() - t1,
                         check_collective_s=mesh.collective_s - c1)
            record.append(entry)
            return mixed

        return mix

    def train_step_clients(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, losses = real_clients(*args, **kw)
        torch.cuda.synchronize()
        record[-1].update(step_s=time.perf_counter() - t0, losses=losses.tolist())
        return params, losses

    return mesh_mix, train_step_clients


def mesh_rank_train(rank, world, modes):
    """Phase 21 (b) in one rank: `train.main` on the mesh for each mode of
    `modes` (those of `MESH_MODES` with this world's size), probed
    (`mesh_probe`); the drain launches counted from 0 around each run."""
    import torch

    import repro_torch  # noqa: F401  (TF32 off)
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.gossip import ops
    from repro_torch.launch import steps, train

    cfg = get_config("qwen2-1.5b").with_(num_layers=MESH_LAYERS)
    out = {}
    for label, argv in modes:
        record, mesh_box = [], []
        real = steps.mesh_mix, train.train_step_clients
        steps.mesh_mix, train.train_step_clients = mesh_probe(torch, mesh_box, record)
        torch.cuda.reset_peak_memory_stats()
        ops.gossip_drain.launches = 0
        t0 = time.perf_counter()
        try:
            losses = train.main(MESH_TRAIN_ARGS + argv, cfg=cfg)
        finally:
            steps.mesh_mix, train.train_step_clients = real
        torch.cuda.synchronize()
        out[label] = dict(losses=losses, launches=ops.gossip_drain.launches,
                          wall=time.perf_counter() - t0, steps=record,
                          peak=torch.cuda.max_memory_allocated(),
                          staged=mesh_box[0].staged if mesh_box else None)
    return out


def mesh_drain_run(torch, mesh, j, n, k, s):
    """Phase 21 (a) in one rank: the sharded drain on this rank's senders
    of J buckets of N clients, K columns and a ring of S rows, against
    the plain unsharded drain's rows (within RTOL of the largest |value|),
    one launch; then `MESH_DRAIN_REPS` calls, the mean ms per call and per
    collective."""
    from repro_torch.kernels.gossip import ops

    w, ring, slots = drain_case(torch, j, n, n, k, s, j, torch.float32, seed=2200)
    sl = mesh.client_slice(n)
    w_loc, ring_loc = w[:, sl].contiguous(), ring[:, sl].contiguous()
    ops.gossip_drain.launches = 0
    got = ops.gossip_drain_sharded(w_loc, ring_loc, slots, mesh, ("data",))
    launches = ops.gossip_drain.launches
    want = ops.gossip_drain_reference(w, ring, slots)[sl]
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    finite = bool(torch.isfinite(got).all())
    torch.cuda.synchronize()
    c0, t0 = mesh.collective_s, time.perf_counter()
    for _ in range(MESH_DRAIN_REPS):
        ops.gossip_drain_sharded(w_loc, ring_loc, slots, mesh, ("data",))
    torch.cuda.synchronize()
    call = (time.perf_counter() - t0) / MESH_DRAIN_REPS * 1e3
    coll = (mesh.collective_s - c0) / MESH_DRAIN_REPS * 1e3
    return dict(err=err, scale=scale, finite=finite, launches=launches, call_ms=call,
                collective_ms=coll, rows=(sl.start, sl.stop), staged=mesh.staged)


def mesh_sweep_args(torch):
    """Phase 21 (c)'s sweep: fig4's Psi grid at fig3_config(), made alike
    in every process from one seed."""
    cfg, task = fig3_config()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 210)
    params0 = task.init_params(gen)
    data, eval_data = task.make_data(gen, cfg.num_clients)
    return dict(cfg_grid=[cfg.replace(psi=p) for p in SWEEP_PSIS], params0=params0, data=data,
                num_steps=MESH_SWEEP_WINDOWS, task=task,
                keys=[SEED + 211 + r for r in range(MESH_SWEEP_SEEDS)],
                eval_every=MESH_SWEEP_EVAL, eval_data=eval_data, final_fn=sweep_final)


def mesh_rank_drain(rank, world, backend, with_sweep):
    """Phase 21 (a), and (c) with `with_sweep`, in one rank."""
    import torch

    import repro_torch  # noqa: F401  (TF32 off)
    from repro_torch.api import simulate_sweep
    from repro_torch.kernels.gossip import ops
    from repro_torch.launch import mesh as mesh_lib

    mesh = mesh_lib.make_sweep_mesh(backend=backend)
    out = dict(drain=mesh_drain_run(torch, mesh, *MESH_DRAIN, MESH_DRAIN[0] + 1),
               device=str(mesh.device))
    if with_sweep:
        out["tiles"] = {label: mesh_drain_run(torch, mesh, j, m, k, s)
                        for label, (j, _, m, k, s) in MESH_TILES.items()}
        args = mesh_sweep_args(torch)
        torch.cuda.synchronize()
        ops.gossip_drain.launches = 0
        c0, t0 = mesh.collective_s, time.perf_counter()
        (params, accepted), trace = simulate_sweep("draco", mesh=mesh, **args)
        torch.cuda.synchronize()
        out["sweep"] = dict(wall=time.perf_counter() - t0, collective_s=mesh.collective_s - c0,
                            launches=ops.gossip_drain.launches,
                            accuracy=trace.metrics["accuracy"],
                            params=params if rank == 0 else None,
                            accepted=accepted if rank == 0 else None)
        t0 = time.perf_counter()
        out["algos"] = {algo: mesh_algo_run(torch, mesh, algo, rank == 0) for algo in MESH_ALGOS}
        out["algos_s"] = time.perf_counter() - t0
    return out


def algo_final(state):
    """final_fn of phase 21 (d): each row's params and `MESH_COUNTERS`."""
    return {"params": state.params,
            **{f: getattr(state, f) for f in MESH_COUNTERS if hasattr(state, f)}}


def mesh_algo_args(torch, algo):
    """Phase 21 (d)'s sweep of `algo` (see `MESH_ALGOS`), made alike in
    every process from one seed: ``simulate_sweep``'s keyword arguments
    but ``mesh``."""
    from repro_torch.events import events_context

    cfg, task = fig3_config() if algo in MESH_BASELINES else event_config(EVENT_TRIGGER)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 215)
    params0 = task.init_params(gen)
    data, eval_data = task.make_data(gen, cfg.num_clients)
    steps = MESH_ALGO_EVENTS if algo in MESH_EVENTS else MESH_ALGO_ROUNDS
    seeds = MESH_SWEEP_SEEDS if algo == "fedasync-window" else 1
    kw = dict(cfg_grid=cfg, params0=params0, data=data, num_steps=steps, task=task,
              keys=[SEED + 216 + r for r in range(seeds)], eval_every=steps,
              eval_data=eval_data, final_fn=algo_final)
    if algo in MESH_EVENTS:
        kw["ctx"] = events_context(cfg, task=task, data=data, params0=params0,
                                   horizon=EVENT_HORIZON, tape_seed=EVENT_TAPE_SEED)
    return kw


def algo_drains(algo, args):
    """The drain launches `algo`'s sweep of `args` makes on one rank: one a
    round, a batched window (all seeds at once) or a valid tape row."""
    if algo in MESH_EVENTS:
        return int(args["ctx"].tape.valid[:args["num_steps"]].sum()) * len(args["keys"])
    return args["num_steps"] * (1 if algo == "fedasync-window" else len(args["keys"]))


def mesh_algo_run(torch, mesh, algo, keep):
    """Phase 21 (d) of `algo` in one rank: its sweep on `mesh` (the wall
    time with its init and one eval, the collective's seconds, the drain
    and mix launches, the accuracy, and the N-wide finals when `keep`)."""
    from repro_torch.api import simulate_sweep
    from repro_torch.kernels.gossip import ops

    args = mesh_algo_args(torch, algo)
    torch.cuda.synchronize()
    ops.gossip_drain.launches = ops.gossip_mix.launches = 0
    c0, t0 = mesh.collective_s, time.perf_counter()
    final, trace = simulate_sweep(algo, mesh=mesh, **args)
    torch.cuda.synchronize()
    return dict(wall=time.perf_counter() - t0, collective_s=mesh.collective_s - c0,
                drains=ops.gossip_drain.launches, mixes=ops.gossip_mix.launches,
                expect=algo_drains(algo, args), steps=args["num_steps"],
                accuracy=trace.metrics["accuracy"], final=final if keep else None)


def phase_mesh_algos(torch, gloo):
    """Phase 21 (d) in this process: each algorithm's unsharded sweep
    against rank 0's N-wide finals (params within PATH_TOL, the counters
    exact) and every rank's launches; ms per round, window or event,
    sharded (rank 0, with its init and one eval) against unsharded, and
    the collective's share. Returns (rows, drain launches of the ranks and
    this process, mix launches of this process)."""
    from repro_torch.api import simulate_sweep

    rows, drains, mixes = {}, 0, 0
    for algo in MESH_ALGOS:
        ranks = [o["algos"][algo] for o in gloo]
        args = mesh_algo_args(torch, algo)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        want, trace = simulate_sweep(algo, **args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        plain = launch_counts()
        got = ranks[0]["final"]
        gap = max(float((got["params"][k] - want["params"][k]).abs().max())
                  for k in want["params"])
        same = sorted(got) == sorted(want) and all(
            np.array_equal(np.asarray(torch.as_tensor(got[f]).cpu()),
                           np.asarray(torch.as_tensor(want[f]).cpu()))
            for f in want if f != "params")
        acc_gap = max(float(np.abs(r["accuracy"] - trace.metrics["accuracy"]).max())
                      for r in ranks)
        launches_ok = all(r["drains"] == r["expect"] and r["mixes"] == 0 for r in ranks)
        unit = ("round" if algo in MESH_BASELINES else "event" if algo in MESH_EVENTS
                else "batched window")
        sent = (f", {int(torch.as_tensor(want['tx_sent']).sum())} broadcasts sent"
                if "tx_sent" in want else "")
        r0 = ranks[0]
        row = dict(unit=unit, ms=r0["wall"] / r0["steps"] * 1e3,
                   plain_ms=wall / r0["steps"] * 1e3, share=r0["collective_s"] / r0["wall"],
                   gap=gap, acc_gap=acc_gap, drains=sum(r["drains"] for r in ranks))
        ok = gap <= PATH_TOL and same and launches_ok
        log(f"  {algo} over {len(ranks)} gloo ranks, {r0['steps']} {unit}s: "
            f"{row['ms']:.3f} ms per {unit} with its init and one eval (collective "
            f"{100 * row['share']:.1f}%) against {row['plain_ms']:.3f} ms unsharded; drain "
            f"launches a rank {[r['drains'] for r in ranks]} (expected {r0['expect']}), mix "
            f"launches {sum(r['mixes'] for r in ranks)} (unsharded: {plain['mix']} mix, "
            f"{plain['drain']} drain); max |d params| {gap:.3e} (tolerance {PATH_TOL}), same "
            f"counters {same}{sent}, max |d accuracy| {acc_gap:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"phase 21 (d): {algo} on the mesh differs from its "
                                 "unsharded run or launched off count")
        rows[algo] = row
        drains += row["drains"] + plain["drain"]
        mixes += plain["mix"]
    return rows, drains, mixes


def check_sharded_drain(runs, backend, device, what, tail):
    """Phase 21 (a)'s verdict on the ranks' `mesh_drain_run` results:
    each within RTOL of the largest |value|, finite, one launch a rank;
    logged with rank 0's ms per call and the collective's. Returns rank
    0's result."""
    worst = max(r["err"] / max(r["scale"], 1e-30) for r in runs)
    ok = all(r["finite"] and r["launches"] == 1 for r in runs) and worst <= RTOL
    d = runs[0]
    log(f"  sharded drain {what} over {len(runs)} {backend} rank(s) on {device} (staged "
        f"through the host: {d['staged']}): max |err| / largest |value| {worst:.3e} "
        f"(tolerance {RTOL}), one launch per rank; {d['call_ms']:.3f} ms per call, collective "
        f"{d['collective_ms']:.3f} ms ({100 * d['collective_ms'] / d['call_ms']:.1f}%)"
        f"{'; ' + tail if tail else ''} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"phase 21: the sharded drain {what} over {backend} disagrees")
    return d


def log_mesh(r):
    """Phase 21's summary lines."""
    for label, row in r["train"].items():
        log(f"mesh trainer path ({label}, qwen2-1.5b at {MESH_LAYERS} layers, {row['ranks']} "
            f"gloo ranks on one card): {row['s_step']:.4f} s/step, collective "
            f"{100 * row['share']:.1f}% of the step, peak {row['peak'] / 2**30:.2f} GiB per rank")
    sw = r["sweep"]
    log(f"mesh sweep path (fig4 Psi grid over {MESH_RANKS} gloo ranks): {sw['ms']:.3f} ms per "
        f"batched window with the evals (collective {100 * sw['share']:.1f}%) against "
        f"{sw['plain_ms']:.3f} ms unsharded")
    for algo, a in r["algos"].items():
        log(f"mesh sweep path ({algo} over {MESH_RANKS} gloo ranks): {a['ms']:.3f} ms per "
            f"{a['unit']} (collective {100 * a['share']:.1f}%) against {a['plain_ms']:.3f} ms "
            f"unsharded; max |d params| {a['gap']:.3e}")


def phase_mesh(torch, share=False):
    """Phase 21: the client mesh (see `MESH_MODES` and the constants
    above them). Returns its numbers for the kernels line and PERF.md;
    with `share`, (b)'s modes are left to phase 23's worlds of 4 and 2
    ranks (`phase_tp` with these results), which fill its numbers in."""
    from repro_torch.api import simulate_sweep
    from repro_torch.configs.base import get_config
    from repro_torch.launch import mesh as mesh_lib

    t_start = time.perf_counter()
    torch.cuda.empty_cache()
    res = {}

    # (a) NCCL at one rank per card: the world of this machine's cards
    world = torch.cuda.device_count()
    t0 = time.perf_counter()
    nccl = mesh_lib.spawn_ranks(mesh_rank_drain, world, "nccl", False, backend="nccl",
                                timeout=120, threads=0, deadline=600)
    # (a) gloo at MESH_RANKS ranks sharing the card, with (c) the sweep
    t1 = time.perf_counter()
    gloo = mesh_lib.spawn_ranks(mesh_rank_drain, MESH_RANKS, "gloo", True, backend="gloo",
                                timeout=300, threads=0, deadline=900)
    t2 = time.perf_counter()
    for label, outs, wall in (("nccl", nccl, t1 - t0), ("gloo", gloo, t2 - t1)):
        d = check_sharded_drain([o["drain"] for o in outs], label, outs[0]["device"],
                                "J={} N=M={} K={}".format(*MESH_DRAIN),
                                f"world {wall:.1f} s with process start")
        res[f"{label}_collective_ms"] = dict(
            ms=d["collective_ms"], what=f"{label} reduce-scatter of (25, 146447) f32 partials, "
            f"{len(outs)} rank(s)")
    res["tile_collective_ms"] = {}
    for tile, (j, n_loc, m, k, _) in MESH_TILES.items():
        d = check_sharded_drain([o["tiles"][tile] for o in gloo], "gloo", gloo[0]["device"],
                                f"{tile} J={j} N_loc={n_loc} M={m} K={k}", "")
        res["tile_collective_ms"][tile] = dict(
            ms=d["collective_ms"], what=f"gloo reduce-scatter of the ({m}, {k}) f32 partials, "
            f"{len(gloo)} ranks")

    # (c) against the unsharded sweep in this process
    sweep = [o["sweep"] for o in gloo]
    args = mesh_sweep_args(torch)
    reset_launches()
    t0 = time.perf_counter()
    (params, accepted), trace = simulate_sweep("draco", **args)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    gap = max(float((sweep[0]["params"][k] - params[k]).abs().max()) for k in params)
    same = torch.equal(sweep[0]["accepted"], accepted)
    acc_gap = max(float(np.abs(s["accuracy"] - trace.metrics["accuracy"]).max()) for s in sweep)
    windows = len(args["cfg_grid"]) * MESH_SWEEP_WINDOWS
    s0 = sweep[0]
    sweep_launches = sum(s["launches"] for s in sweep)
    log(f"  sharded sweep: {len(SWEEP_PSIS)} Psi x {MESH_SWEEP_SEEDS} seeds x "
        f"{MESH_SWEEP_WINDOWS} windows over {MESH_RANKS} gloo ranks, "
        f"{s0['wall'] / windows * 1e3:.3f} ms per batched window with the evals (collective "
        f"{100 * s0['collective_s'] / s0['wall']:.1f}%), against {plain_wall / windows * 1e3:.3f} "
        f"ms unsharded; {sweep_launches} drain launches ({s0['launches']} per rank); max |d params| "
        f"{gap:.3e} (tolerance {PATH_TOL}), same acceptances {same}, max |d accuracy| "
        f"{acc_gap:.3e}")
    if gap > PATH_TOL or not same or any(s["launches"] != windows for s in sweep):
        raise AssertionError("phase 21: the sharded sweep differs from the unsharded one")
    res["sweep"] = dict(ms=s0["wall"] / windows * 1e3, plain_ms=plain_wall / windows * 1e3,
                        share=s0["collective_s"] / s0["wall"], gap=gap, acc_gap=acc_gap)
    del params, sweep

    # (d) every other algorithm against its unsharded run in this process
    t0 = time.perf_counter()
    res["algos"], algo_launches, res["mix_launches"] = phase_mesh_algos(torch, gloo)
    algos_s = max(o["algos_s"] for o in gloo) + time.perf_counter() - t0
    PHASE_TIMES.append(("21 (d) algorithms", algos_s))
    log(f"  (d): {algos_s:.1f} s (the ranks' {max(o['algos_s'] for o in gloo):.1f} s and this "
        f"process's unsharded runs)")
    del gloo, nccl
    torch.cuda.empty_cache()

    # (b) the single-process references (shared with phase 23 (a)), then
    # the mesh trainer's worlds: with `share`, phase 23's worlds of the same
    # sizes run (b)'s modes first (`mesh_train_verdict` after them)
    cfg = get_config("qwen2-1.5b").with_(num_layers=MESH_LAYERS)
    ref, _ = single_reference(torch, cfg, MESH_TRAIN_ARGS + ["--topology", "complete"], False,
                              1)
    ref_none, _ = single_reference(torch, cfg, MESH_TRAIN_ARGS, True, 2)
    res["refs"] = ref, ref_none
    res["launches"] = sweep_launches + algo_launches
    if not share:
        outs = {}
        for ranks in sorted({r for _, r, _ in MESH_MODES}):
            t0 = time.perf_counter()
            outs[ranks] = mesh_lib.spawn_ranks(mesh_rank_train, ranks, mesh_modes(ranks),
                                               backend="gloo", timeout=600, threads=0,
                                               deadline=1200)
            log(f"  mesh trainer world of {ranks} gloo ranks: {time.perf_counter() - t0:.1f} s "
                f"with process start")
        mesh_train_verdict(res, outs)
    log(f"phase 21 mesh: {time.perf_counter() - t_start:.1f} s" +
        (" ((b)'s modes run in phase 23's worlds)" if share else ""))
    return res


def mesh_modes(ranks):
    """Phase 21 (b)'s (label, argv) of `MESH_MODES` that run on `ranks` ranks."""
    return [(label, argv) for label, r, argv in MESH_MODES if r == ranks]


def mesh_train_verdict(res, outs_by_ranks):
    """Phase 21 (b)'s checks of each world's ranks' `mesh_rank_train`
    results ({ranks: [rank results]}) against the single-process
    references ``res["refs"]``; fills ``res["train"]``,
    ``res["train_collective_ms"]`` and adds the drain launches to
    ``res["launches"]``."""
    ref, ref_none = res["refs"]
    train_launches, rows = 0, {}
    for ranks, outs in sorted(outs_by_ranks.items()):
        for label, _ in mesh_modes(ranks):
            runs = [o[label] for o in outs]
            want = ref_none if label == "none" else ref
            n_loc = 4 // ranks
            for step in range(len(runs[0]["steps"])):
                entries = [r["steps"][step] for r in runs]
                losses = [x for e in entries for x in e["losses"]]
                digests = [d for e in entries for d in e["digests"]]
                exact = losses == want[step]["losses"] and digests == want[step]["digests"]
                held = step == 0 or label == "none"
                err = max(e.get("err", 0.0) / max(e.get("scale", 1.0), 1e-30)
                          for e in entries)
                ok = all(e["finite"] for e in entries) and err <= MESH_MIX_TOL[label] \
                    and (exact or not held)
                e0 = entries[0]
                step_s = e0["step_s"] - e0["check_s"]
                log(f"  {label} ({ranks} ranks, {n_loc} clients each) step {step + 1}: losses "
                    + " ".join(f"{x:.6f}" for x in losses)
                    + f"; losses and delta rows bitwise equal to one process {exact}"
                    + ("" if held else " (not held: its inputs carry step 1's mix)")
                    + (f"; mixed plane against the mix kernel: max |err| / largest |value| "
                       f"{err:.3e} (tolerance {MESH_MIX_TOL[label]})" if step == 0 else
                       "; mixed plane finite")
                    + f"; {step_s:.4f} s/step, "
                    f"collective {e0['collective_s']:.4f} s ({100 * e0['collective_s'] / step_s:.1f}%)"
                    f" {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"phase 21: mesh trainer {label} step {step + 1}")
            launches = sum(r["launches"] for r in runs)
            expect = len(runs[0]["steps"]) * ranks if label.startswith("dense") else 0
            if launches != expect or not all(math.isfinite(x) for x in runs[0]["losses"]):
                raise AssertionError(f"phase 21: {label} launched the drain {launches} times "
                                     f"(expected {expect}) or lost finiteness")
            train_launches += launches
            last = len(runs[0]["steps"])
            steady = [r["steps"][-1]["step_s"] - r["steps"][-1]["check_s"] for r in runs]
            rows[label] = dict(ranks=ranks, s_step=max(steady), step=last,
                               share=runs[0]["steps"][-1]["collective_s"] / steady[0],
                               peak=max(r["peak"] for r in runs), launches=launches,
                               collective_ms=runs[0]["steps"][-1]["collective_s"] * 1e3,
                               wall=max(r["wall"] for r in runs))
            log(f"  {label}: {launches} drain launches, peak {rows[label]['peak'] / 2**30:.2f} "
                f"GiB per rank, {rows[label]['s_step']:.4f} s/step at step {last} (its check's "
                f"time left out), {rows[label]['wall']:.1f} s with set-up")
    res["train"] = rows
    res["train_collective_ms"] = dict(
        ms=rows["dense"]["collective_ms"],
        what=f"gloo reduce-scatter of the (4, K) f32 partial at {MESH_LAYERS} layers, 2 ranks")
    res["launches"] += train_launches


# phase 22: (arch, shape, client ranks W, mix mode). The dense mix's
# partial plane, (W, Dflat) f32 on a rank, fits no card at full depth at
# a W whose activations fit (the dry run's reckoning): the first train
# pair runs the ring at full depth, the second the dense mix (the drain
# kernel) at depths 1 and 2, extrapolated to 64 layers
DRY_PAIRS = (("mamba2-2.7b", "train_4k", 256, "ring"),
             ("mamba2-2.7b", "train_4k", 64, "dense"),
             ("mamba2-2.7b", "prefill_32k", 32, "dense"),
             ("qwen2-1.5b", "decode_32k", 16, "dense"),
             ("mamba2-2.7b", "long_500k", 1, "dense"))
# measured against reckoned peak, within 128 MiB + 0.1% of the reckoned:
# the caching allocator rounds each block up (to 512 B, and a large block
# keeps a remainder under 1 MiB unsplit) and may hold a block outside the
# step's tensors (PR 24's readings: gaps of 0 to 67,109,372 bytes, the
# latter one 64 MiB block); the meta run sees neither. Held at every depth
# run, before and after the extrapolation
DRY_PEAK_TOL = (1e-3, 128 << 20)  # relative, absolute (bytes)
# 6 N T over the counted FLOPs of mamba2's train step at full width:
# remat runs each block's forward twice (6/8), the SSD's own products add
DRY_TRAIN_RATIO = (0.6, 0.95)


# The dry run's pairs are reckoned on ``meta`` (a pure host computation,
# the same on any host: 0.5-16 s a pair of the meta run's Python per op,
# ~110 s in all) by RECKON_WORKERS background process(es) from phase 21 on,
# while the card works; phases 22 and 23 take each row
# (`dryrun.lower_pair(reckoned=)`) where they used to count it in turn. One
# process stays ahead of them and takes one core, not two, from phase 21's
# gloo worlds, which share the host (with two, phase 21 took 90.1 s on a
# host ~17% slower than one where it took 57.3 s alone; PERF.md §6)
RECKON_WORKERS = 1
_RECKONS = {}


def dry_key(arch, shape, clients=None, mix="dense", threshold=8192, chunk=0, sp=False,
            cache_shard="kv_heads"):
    """One dry-run pair's reckoning: `lower_pair`'s arguments."""
    return arch, shape, clients, mix, threshold, chunk, bool(sp), cache_shard


def tp_key(pair, cache_shard="kv_heads"):
    """`dry_key` of a phase 23 pair ((arch, shape, mix, blocked_threshold[,
    vocab_chunk[, seq_parallel]]), the (16, 16) mesh)."""
    arch, shape, mix, threshold, chunk, sp = (*pair, 0, False)[:6]
    return dry_key(arch, shape, None, mix, threshold, chunk, sp, cache_shard)


def reckon_row(key):
    """A background process's reckoning of the pair `key` (`dry_key`):
    `lower_pair`'s row without ``run``, on one CPU thread."""
    import torch

    from repro_torch.launch import dryrun

    torch.set_num_threads(1)
    arch, shape, clients, mix, threshold, chunk, sp, cache_shard = key
    return dryrun.lower_pair(arch, shape, clients=clients, mix_mode=mix,
                             blocked_threshold=threshold, vocab_chunk=chunk, seq_parallel=sp,
                             cache_shard=cache_shard, verbose=False)


def start_reckons(keys):
    """Submit the pairs of `keys` (in order of need) to the background
    reckoning processes (`reckoned` waits for one; `stop_reckons` ends
    them)."""
    import concurrent.futures
    import multiprocessing

    if "pool" not in _RECKONS:
        _RECKONS["pool"] = concurrent.futures.ProcessPoolExecutor(
            RECKON_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    for key in keys:
        _RECKONS[key] = _RECKONS["pool"].submit(reckon_row, key)


def reckoned(key):
    """The background row of `key`, waited for; None where none was
    submitted (the caller then counts it itself)."""
    future = _RECKONS.pop(key, None)
    return None if future is None else future.result()


def stop_reckons():
    """End the background reckoning processes (pending pairs cancelled)."""
    pool = _RECKONS.pop("pool", None)
    _RECKONS.clear()
    if pool is not None:
        pool.shutdown(wait=True, cancel_futures=True)


def tp_dry_keys():
    """Phase 23's pairs in order of need: (c), (e), (h), (k), the reckoned
    zamba2 and musicgen, (l)'s two, (m)'s three and the other long_500k
    pairs."""
    keys = [tp_key(p) for p in (TP_DRY, TP_DRY_MOE, TP_DRY_SSM, TP_DRY_CROSS, TP_DRY_HYBRID,
                                TP_DRY_AUDIO, TP_DRY_SP, TP_DRY_SP_RECKON)]
    keys += [tp_key((a, s, "dense", 8192), cs) for a, s, cs in TP_DRY_CACHE]
    return keys + [tp_key((a, "long_500k", "dense", 8192)) for a in long_reckoned()]


def long_reckoned():
    """(m)'s long_500k pairs reckoned only: every `ARCH_IDS` config's but
    those `TP_DRY_CACHE` runs, by config name."""
    from repro_torch.configs.base import ARCH_IDS, get_config

    names = [get_config(a).name for a in ARCH_IDS]
    return [n for n in names if (n, "long_500k", "kv_heads") not in TP_DRY_CACHE]


def peak_gaps(row):
    """[(what, measured, reckoned)] of one row's peaks: each depth run and,
    extrapolated or not, the row's own."""
    out = []
    how = row["cost_correction"].get("measured", {})
    for d, reckoned in zip((1, 2), how.get("reckoned_peaks", ())):
        out.append((f"depth {d}", how[f"depth{d}"]["peak_bytes"], reckoned))
    out.append((str(row["run_depth"]), row["measured_peak_bytes"],
                row["reckoned_run_peak_bytes"]))
    return out


def phase_dryrun(torch):
    """Phase 22: the dry run's pairs reckoned and run; returns the launch
    counts of their runs."""
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    reset_launches()
    rows, failures = [], []
    for arch, shape, clients, mix in DRY_PAIRS:
        row = dryrun.lower_pair(arch, shape, clients=clients, mix_mode=mix, run=True,
                                verbose=False,
                                reckoned=reckoned(dry_key(arch, shape, clients, mix)))
        rows.append(row)
        log(f"phase 22 row: {json.dumps(row)}")
        peaks = []
        for what, got, want in peak_gaps(row):
            gap, tol = abs(got - want), DRY_PEAK_TOL[0] * want + DRY_PEAK_TOL[1]
            peaks.append(f"{what} {got / 2**30:.3f} GiB measured, {want / 2**30:.3f} "
                         f"reckoned, gap {gap} bytes (bound {tol:.0f})")
            if gap > tol:
                failures.append(f"{arch} x {shape} at {what}: peak gap {gap} > {tol:.0f}")
        fracs = {k: row[k] for k in ("roofline_fraction", "bound_fraction")}
        log(f"phase 22 dry run: {arch} x {shape} x {row['mesh']} ({mix}): "
            f"{row['measured_s_per_step']:.6f} s/step against max(compute "
            f"{row['t_compute_s']:.6f}, memory {row['t_memory_s']:.6f}) s, roofline_fraction "
            f"{fracs['roofline_fraction']:.4f}; bound {row['t_bound_s']:.6f} s (model FLOPs, "
            f"{row['necessary_bytes']} necessary bytes), bound_fraction "
            f"{fracs['bound_fraction']:.4f}; peaks: {'; '.join(peaks)}; useful_flops_ratio "
            f"{row['useful_flops_ratio']:.4f}; {row['host_syncs']} host syncs; reckoned in "
            f"{row['t_compile_s']:.1f} s")
        for name, frac in fracs.items():
            if not (math.isfinite(frac) and 0 < frac <= 1):
                failures.append(f"{arch} x {shape}: {name} {frac}")
        if row["host_syncs"]:
            failures.append(f"{arch} x {shape}: {row['host_syncs']} host syncs")
        if row["mode"] == "train" and not (
                DRY_TRAIN_RATIO[0] <= row["useful_flops_ratio"] <= DRY_TRAIN_RATIO[1]):
            failures.append(f"{arch} x {shape}: useful_flops_ratio "
                            f"{row['useful_flops_ratio']} outside {DRY_TRAIN_RATIO}")
    launches = launch_counts()
    if not (launches["ssd_chunk"] and launches["drain"]):
        failures.append(f"a kernel of the dry run's pairs never launched: {launches}")
    log(f"phase 22 dry run: {len(rows)} pairs in {time.perf_counter() - t0:.1f} s; "
        f"launches {launches}")
    if failures:
        raise RuntimeError("phase 22 dry run: " + "; ".join(failures))
    return launches


# phase 23: tensor parallelism over "model" (`repro_torch.sharding.tp`),
# the ranks sharing the card over gloo as phase 21's (NCCL refuses two ranks
# on one device). (a) `train.main` on a (data 2, model 2) world
# (`TP_SHAPE`): phase 21 (b)'s run, 4 clients at 2 layers, each client now
# over 2 ranks of "model"; its step 1 against the single-process trainer on
# the same seeds (`single_reference`, phase 21's own run where phase 21 ran
# first). The ranks' bf16 products (other widths, other cuBLAS tiles) and
# sums (re-associated across the model ranks) round otherwise, so each
# client's loss is held within TP_LOSS_TOL (relative) and a leaf's largest
# gap within its bound of its largest |value|: a weight (`TP_WEIGHTS`)
# within TP_WEIGHT_TOL, a zero-init leaf (a bias, a norm scale) within
# TP_PARAM_TOL. Read on an H100 (PERF.md, PR 25): 7.8e-5 for the losses;
# the weights 8.3e-4 to 1.7e-3; 1.7e-2 and 1.9e-2 at bk and bv: a zero-init
# bias is its bf16 update alone, a sum over 256 positions that cancels to
# ~1e-5, so a few bf16 steps of its terms are percents of it. Each bound is
# ~2.6x its reading; a reduction left out (a gradient left partial) moves a
# leaf by O(1) of itself, and a wrong partial sum on one weight shard that
# moves it by 1e-2 of its largest |value| (`--tp-faults`) fails
# TP_WEIGHT_TOL
TP_SHAPE = (2, 2)
TP_MODES = (("dense", ["--mix", "dense", "--topology", "complete"]),
            ("none", ["--mix", "none"]))
TP_LOSS_TOL = 1e-3
TP_WEIGHT_TOL = 4.5e-3
TP_PARAM_TOL = 5e-2
# a weight's leaf name begins so
TP_WEIGHTS = ("w", "embed", "lm_head", "experts_", "router", "in_proj", "out_proj", "conv_w")
# (b) serving in (d)'s (1, 2) world at qwen2-1.5b's full width and depth, in
# f32 (phase 20's exact comparisons are in f32): the logits of a prefill
# and of TP_DECODE_STEPS decode steps from an empty cache against one
# process, within phase 20's 1e-4 of the largest |logit|
TP_SERVE_SHAPE, TP_SERVE_BATCH, TP_SERVE_PROMPT, TP_DECODE_STEPS = (1, 2), 4, 32, 4
TP_SERVE_TOL = 1e-4
# (c) the dry run at its default mesh, the reference's (16, 16): (arch,
# shape, mix, blocked_threshold), run at depths 1 and 2. qwen2.5-32b's 40
# heads over 16 ranks: the padded route, 3 heads a rank (1 on rank 13, none
# on 14 and 15); its full-depth reckoned peak must fit the card (67.7 GiB
# reckoned on the CPU)
TP_DRY = ("qwen2.5-32b", "train_4k", "ring", 8192)
# (d) `train.main` on a (data 1, model 2) world, olmoe-1b-7b at full width
# and TP_MOE_LAYERS of its 16 layers, 2 clients on the one client rank,
# each over the 2 model ranks (one client alone would learn nothing: its
# window's weights have no edge, so step 1 would leave every leaf at its
# init), the dense mix (one drain launch a rank a step over a client group
# of one, no client collective: phase 2 holds its J 1, N_loc 2, M 2 shape,
# `RECT_TP_MOE`): step 1 against the single-process trainer under (a)'s
# bounds (a zero-init leaf within TP_MOE_PARAM_TOL), the router (f32,
# `TP_F32_TOL`) also against its step-1 update:
# a bf16 step of the weights is a few times one update, so a router
# gradient summed over the ranks (twice its update) shows only there; the
# replicated leaves (the router, the norms) bit for bit equal across the
# model ranks after both steps; TP_MOE_EXPERTS experts a rank in the tally
TP_MOE_ARCH, TP_MOE_LAYERS, TP_MOE_SHAPE, TP_MOE_EXPERTS = "olmoe-1b-7b", 2, (1, 2), 32
TP_MOE_ARGS = ["--arch", TP_MOE_ARCH, "--clients", "2", "--mix", "dense", "--topology",
               "complete"]
# (d)'s readings (PERF.md, PR 26 calls 1-2): the weights as (a)'s (1.9e-3,
# under TP_WEIGHT_TOL); a zero-init norm scale of the moe block 0.115-0.121
# of its largest |value| (its update a sum over 256 positions that cancels
# to ~1.5e-5, as (a)'s biases); the router 0.122-0.130 of its update. Each
# bound ~2.6x its reading; an unreduced expert output moves that norm by
# 0.86 of itself, a router gradient summed over the ranks the router by
# 0.919 of its update
TP_MOE_PARAM_TOL = 0.3
TP_F32_TOL = 0.33  # an f32 leaf's largest gap over its largest step-1 update
F32_EPS = 2.0 ** -23  # one rounding of an f32 value, relative
# (e) the dry run's (16, 16) pair of the moe family at depths 1 and 2:
# 8 of qwen3-moe-30b-a3b's 128 experts a rank
TP_DRY_MOE, TP_DRY_MOE_EXPERTS = ("qwen3-moe-30b-a3b", "train_4k", "ring", 8192), 8
# `--tp-faults`: each planted in one run of (a), (d), (f) or (i), each must fail
# its check. weight-shard: model rank 1 adds TP_FAULT_SHIFT of its largest
# |value| to one element of its w_down shard after step 1; router-twice: a
# `TP.copy` on the router, its gradient summed over the 2 model ranks;
# unreduced: each rank's partial expert output left unreduced;
# norm-forward-only: a Mamba2 block's gated-norm sum of squares reduced
# over the ranks forward only, its gradient left partial
# (f) `train.main` on a (data 1, model 2) world as (d), mamba2-2.7b at full
# width and 2 of its 64 layers (bf16), 2 clients, 2 steps of the dense mix:
# (d)'s checks, a Mamba2 block's weights (in_proj, out_proj, conv_w) among
# the weights, its zero-init leaves (conv_b, gnorm, dt_bias) within
# TP_SSM_TOLS[0] of themselves and its f32 leaves (a_log, ssm_d, dt_bias)
# within TP_SSM_TOLS[1] of their step-1 update; TP_SSM_HEADS ssm heads a
# rank in the tally. Read on an H100 (PERF.md, PR 27 calls 1-2, the same
# to the last digit): losses 3.7e-05, in_proj 2.2e-03 of its largest
# |value|, gnorm 7.0e-02 of itself, dt_bias 3.4e-02 of its update; each
# bound ~2.6x its reading. The gated norm's sum reduced forward only
# (`--tp-faults`) moves dt_bias by 0.30 of itself and of its update. (g)
# the same for zamba2-2.7b at 6 of its 54 layers (one group: 6 Mamba2
# blocks and the shared block), in f32: in bf16 its step-1 gaps are a few
# bf16 steps of each leaf (call 1: the embedding 1.2e-02 of its largest
# |value|, a conv_b 0.52 of itself, the losses within 2.0e-04), phase 16's
# chaotic one-group trajectories, so a bound read there would hold
# nothing; in f32 (call 2) every leaf sits within 1.2e-04 of its update
# (dt_bias) and the losses within 8.9e-08, and TP_HYBRID_TOLS is ~2.6x
# that. Then serving in (g)'s world as (b): prefill and TP_DECODE_STEPS
# decode steps in f32 at that depth against one process, within
# TP_SSM_SERVE_TOL of the largest |logit| (calls 1-2: 2.1e-05 and
# 4.0e-06). Phase 2 holds the drain at both planes (`RECT_TP_SSM`) and
# `ssd_chunk` at their local heads. (d), (f), (g), (i), (j) and the
# servings of (b), (g), (i) and (j) share one (1, 2) world: one start and
# one first step's warm-up (~13 s a world) for all of them. (g) runs 1
# step without remat (the f32 gathers staged through the host were 95% of
# its step, twice over with remat; (f) keeps both steps and remat). (tag,
# arch, layers, config overrides, argv, zero-init bound, f32 bound)
TP_SSM_HEADS = 40
TP_SSM_TOLS, TP_HYBRID_TOLS = (0.18, 0.09), (3e-4, 3e-4)
TP_SSM = (("f", "mamba2-2.7b", 2, None, [], *TP_SSM_TOLS),
          ("g", "zamba2-2.7b", 6, {"dtype": "float32", "remat": False}, ["--steps", "1"],
           *TP_HYBRID_TOLS))
TP_SSM_SERVE = ("zamba2-2.7b", 6)
TP_SSM_SERVE_TOL = 6e-5


def tp_family_modes():
    """(f)'s, (g)'s, (i)'s and (j)'s `tp_world` modes, and their checks by
    label."""
    modes, checks = [], {}
    for _, arch, layers, overrides, argv, *tols in TP_SSM + TP_CROSS:
        label = f"{arch} dense"
        modes.append((label, arch, layers, overrides, ["--arch", arch, "--clients", "2",
                                                       "--mix", "dense", "--topology",
                                                       "complete", *argv], None))
        checks[label] = (({"ssm_heads": TP_SSM_HEADS}, *tols) if tols else
                         (TP_CROSS_ROUTES, TP_PARAM_TOL, TP_F32_TOL))
    return modes, checks


# (h) the dry run's (16, 16) pair of the ssm family, as (c): (arch, shape,
# mix, blocked_threshold, vocab_chunk). mamba2's vocabulary of 50,280 does
# not divide by 16, so each rank's loss holds the whole (16, 4,096, 50,280)
# logits: 84.6 GiB reckoned with them at full depth, 39.2 in chunks of 1,024
# positions (the CPU's reckoning); TP_DRY_SSM_HEADS ssm heads a rank. Then
# zamba2-2.7b's share (`TP_DRY_HYBRID`) reckoned on `meta` and printed
TP_DRY_SSM, TP_DRY_SSM_HEADS = ("mamba2-2.7b", "train_4k", "ring", 8192, 1024), 5
TP_DRY_HYBRID = ("zamba2-2.7b", "train_4k", "ring", 8192, 0)
# (i) `train.main` on (d)'s (1, 2) world, llama-3.2-vision-11b at full width
# and one group of its 40 layers (4 self-attention layers, the cross layer
# and 5 MLPs), 2 clients, the dense mix, each cross layer's tanh gate set
# to TP_GATE at init in the ranks and in the single-process reference (at
# its init of 0 the layer adds nothing and its projections' gradients are
# exactly 0, so a wrong cross layer would pass); (j) the same for
# musicgen-large at 2 of its 48 layers (frame embeddings in, the head
# vocab-parallel, the unused token embedding's update zero on every rank).
# (d)'s checks, with (a)'s zero-init bound; the routes held: the heads
# route in every attention layer (32 query heads a layer over 2 ranks, and
# 8 or 32 kv heads: whole heads, nothing gathered). Read on an H100
# (PERF.md §6), bf16 and stable: the vlm's losses 3.9e-05,
# its embedding 2.7e-03 of its largest |value|, a norm 2.0e-02 of itself;
# musicgen's 4.0e-05, 5.6e-04 and 1.4e-02, all under (a)'s bounds. (tag,
# arch, layers, config overrides, argv)
TP_GATE = 0.5
TP_CROSS = (("i", "llama-3.2-vision-11b", 5, None, []),
            ("j", "musicgen-large", 2, None, []))
TP_CROSS_ROUTES = {"padded": 0, "gathered_leaves": 0}
# then both served in f32 in the same world as (b): the vlm with patch
# embeddings and its cross K/V on the rank's kv heads, musicgen with frame
# embeddings as its prompt and TP_FEED decode steps past them fed back
# their tokens' embeddings, looked up vocab-parallel (`M.token_embeds`);
# (arch, layers) and the bound on the largest gap / largest |logit|, ~2.6x
# its reading on an H100 (PERF.md §6: the vlm's prefill 2.474e-06,
# musicgen's 8.214e-07)
TP_CROSS_SERVE = (("llama-3.2-vision-11b", 5), ("musicgen-large", 2))
TP_CROSS_SERVE_TOL = {"llama-3.2-vision-11b": 6.5e-6, "musicgen-large": 2.2e-6}
TP_FEED = 2
# (k) the dry run's (16, 16) pair of the vlm, as (c): 2 of the 32 query
# heads a rank in every layer, the cross layer's too, its 8 kv heads cut
# inside a head (each rank gathers wk and wv and slices the kv head its
# heads read); the full-depth share reckoned on the CPU at 52.85 GiB (its
# whole logits: 128,256 / 16 divides), so no loss in chunks. Then
# musicgen-large's share reckoned on `meta` and printed
TP_DRY_CROSS, TP_DRY_CROSS_HEADS = ("llama-3.2-vision-11b", "train_4k", "ring", 8192, 0), 2
TP_DRY_AUDIO = ("musicgen-large", "train_4k", "ring", 8192, 0)
# (l) sequence parallelism over "model" (`train.main --seq-parallel`,
# ROADMAP item 20(e)): the residual stream between the layers is each
# model rank's half of the 128 positions. In (a)'s world qwen2-1.5b with
# the none mix (the dense mix's (4, K) reduce-scatter staged through the
# host is most of a (2, 2) dense step and moves nothing the flag touches),
# in (d)'s olmoe, mamba2 and the vlm with the dense mix: one step each
# (`TP_SP_ARGV`), held against one process under its twin's checks (the
# same mode without the flag: (a)'s none, (d)'s, (f)'s and (i)'s) and
# against that twin's step 1 in the same world: the losses within
# TP_LOSS_TOL (relative), each leaf under the twin's checks (a weight
# within TP_WEIGHT_TOL of its largest |value|, a zero-init leaf within the
# twin's bound, an f32 leaf within its bound of the twin's update). The
# flag changes the order of the bf16 sums (reduce-scatters and
# all-gathers in place of all-reduces), not what is computed, so the two
# sit as close as either sits to one process. The twins' labels:
TP_SP = ("none", "moe dense", "mamba2-2.7b dense", "llama-3.2-vision-11b dense")
TP_SP_ARGV = ["--seq-parallel", "--steps", "1"]
# ROADMAP F4: the vlm at (i)'s depth in f32 with the flag and the none mix
# (so that a step's update is -lr times the gradient; the dense mix's f32
# planes of two clients in each of two ranks do not fit the card beside
# them, PERF.md §6), 1 step: its losses against one process within
# TP_LOSS_TOL, and each of its cross layer's leaves (the 0-d gate, the norm
# and the four projections of its ":cross" block) within TP_CROSS_F32_TOL
# of that leaf's largest step-1 update in one process (f32 steps: an update
# is exact to f32 rounding, where a bf16 step rounds most of it away). One
# process saves only the cross layers' leaves (`single_reference`'s
# `keep`); the bf16 step with the flag holds the rest. The bound is ~2.7x
# its reading on an H100 (PERF.md §6: 4.381e-06, at the cross norm; the
# losses equal one process's to the last digit); the cross layer's output
# left unsummed over the ranks (`--tp-faults`, `TP_F4_FAULT`) reads 1.8 at
# the gate, where the replicated leaves stay equal across the ranks.
TP_SP_F32 = ("llama-3.2-vision-11b", 5, {"dtype": "float32"})
TP_SP_F32_ARGV = ["--arch", TP_SP_F32[0], "--clients", "2", "--mix", "none", *TP_SP_ARGV]
TP_SP_F32_LABEL = "llama-3.2-vision-11b f32 sp"
TP_CROSS_F32_TOL = 1.2e-5
# the dry run's (16, 16) pair with the flag: yi-34b's 1 / 16 share of
# train_4k, 86.86 GiB reckoned without it (past the card), 33.49 with it
# (the CPU's reckoning: each rank's 1 / 16 of the 60 layer groups' saved
# carries), run at depths 1 and 2 as (c); then qwen2.5-32b's share with the
# flag reckoned on `meta` (67.66 GiB without it). (arch, shape, mix,
# blocked_threshold, vocab_chunk, seq_parallel)
TP_DRY_SP = ("yi-34b", "train_4k", "ring", 8192, 0, True)
TP_DRY_SP_RECKON = ("qwen2.5-32b", "train_4k", "ring", 8192, 0, True)
# cross-unreduced: the cross layer's output product left partial on each
# rank (its `TP.leave` the identity; with the flag its positions of the
# partial kept, unsummed), the other layers' joined
TP_F4_FAULT = "cross-unreduced, f32 sp"
TP_FAULTS = (("weight-shard", "a"), ("router-twice", "d"), ("unreduced", "d"),
             ("norm-forward-only", "f"), ("cross-unreduced", "i"), (TP_F4_FAULT, "l"))
# and the same fault at the cross layer's init gate of 0, run beside it
# under `--tp-faults` to show what a zero gate hides (not held)
TP_TRAP = "cross-unreduced at gate 0"
TP_FAULT_SHIFT = 1e-2

# (m) the decode cache's other layouts (ROADMAP item 20(f),
# `steps.cache_layout`), qwen2-1.5b at full width and depth in f32 served
# in (a)'s (2, 2) world, TP_CACHE_STEPS decode steps from a cache pre-filled
# alike in every process (`cache_fill`, each rank its block) against one
# process on the same params and cache, within TP_SERVE_TOL of the largest
# |logit|: long_500k's ring of 8,192 slots at its batch of 1 (whole on both
# client ranks, the ring's slots 4,096 a data rank, the merge of the
# partial softmaxes over "data"), from position TP_CACHE_LONG_POS so that
# the steps wrap the ring; and `cache_shard` head_dim (64 of 128 a rank,
# every kv head) and seq (16 of the 32 slots a rank) on (b)'s served batch
# and cache length, from position TP_CACHE_POS so that the steps cross from
# one rank's slots to the other's. (label, shape name or None for (b)'s,
# cache_shard, start position, the layout that must take effect)
TP_CACHE_STEPS, TP_CACHE_LONG_POS, TP_CACHE_POS = 4, 8190, 14
TP_CACHE = (("long_500k ring, batch 1", "long_500k", "kv_heads", TP_CACHE_LONG_POS,
             {"slots": "data", "head_dim": None, "kv_heads": "the rank's"}),
            ("head_dim", None, "head_dim", TP_CACHE_POS,
             {"slots": None, "head_dim": "model", "kv_heads": "every"}),
            ("seq", None, "seq", TP_CACHE_POS,
             {"slots": "model", "head_dim": None, "kv_heads": "every"}))
# then the dry run's (16, 16) shares reckoned and run at full depth (they
# fit the card; run at depths 1 and 2, a decode step's few ms left the
# extrapolation to one timed step's noise: stablelm's head_dim pair read
# bound_fraction 1.11 so; PERF.md §6), the peak within DRY_PEAK_TOL:
# qwen2.5-32b x long_500k (the padded route's kv heads a rank, the ring over
# the 16 data ranks) and stablelm-3b x decode_32k (32 heads over 32 kv heads
# of 80: 2 heads a rank under seq, 5 head_dims a rank under head_dim; ~5.4
# GB of bf16 cache a rank in either); every other long_500k pair reckoned.
# (arch, shape, cache_shard)
TP_DRY_CACHE = (("qwen2.5-32b", "long_500k", "kv_heads"), ("stablelm-3b", "decode_32k", "head_dim"),
                ("stablelm-3b", "decode_32k", "seq"))


def cache_shape(torch, name):
    """(m)'s serving shape: `name`'s, or (b)'s served batch and length."""
    from repro_torch.configs.base import SHAPES, ShapeConfig

    if name is not None:
        return SHAPES[name]
    return ShapeConfig("serve", TP_SERVE_PROMPT, TP_SERVE_BATCH, "decode")


def cache_block(cfg, t, mesh, layout, rows):
    """The rank's block of a whole KV cache leaf `t` (groups, B, C, Hkv, hd)
    as `init_decode_state` lays it under `layout` on `mesh` (None: one
    process, the whole): its `rows`, its block of the slots, its kv heads
    (every one, or those of `attention.rank_heads`), its block of head_dim."""
    from repro_torch.models import attention

    if mesh is None:
        return t
    if rows < t.shape[1]:
        t = t[:, mesh.client_slice(t.shape[1])]
    for dim, (i, n) in ((2, (0, 1) if layout is None else layout.slot_block()),
                        (4, (0, 1) if layout is None else layout.hd_block())):
        k = t.shape[dim] // n
        t = t.narrow(dim, i * k, k)
    if (layout is None or not layout.every_head) and mesh.model_size > 1:
        hd, size = cfg.resolved_head_dim, mesh.model_size
        _, _, k0, hkv = attention.rank_heads(cfg, mesh.model_rank, size,
                                             cfg.num_heads * hd % size == 0,
                                             cfg.num_kv_heads % size == 0)
        t = t.narrow(3, k0, hkv)
    return t


def cache_serve(torch, mesh):
    """(m) on `mesh` (None: one process): for each of `TP_CACHE`, the serve
    step under its `cache_shard` from a cache pre-filled from one seed
    (the rank's block of it) at its start position, `TP_CACHE_STEPS` steps
    of seeded tokens: the logits on the host, ms a step, the layout that
    took effect, a KV cache's shape, the collective tally."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.sharding import tp as tp_lib

    cfg = get_config("qwen2-1.5b").with_(dtype="float32")
    params = M.init_params(SEED + 230, cfg, "cuda", shard=tp_lib.sharder(mesh))
    out = {}
    for i, (label, name, cache_shard, pos, _) in enumerate(TP_CACHE):
        shape = cache_shape(torch, name)
        scfg = steps.serve_config(cfg, shape)
        serve = steps.make_serve_step(cfg, shape, mesh, cache_shard)
        rows = steps.serving_rows(shape, mesh)
        state = M.init_decode_state(scfg, rows, shape.seq_len, device="cuda", mesh=mesh,
                                    layout=serve.layout)
        whole = M.init_decode_state(scfg, shape.global_batch, shape.seq_len, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(SEED + 232 + i)
        for cname, c in state.caches.items():
            for field in ("k", "v"):
                full = torch.randn(tuple(getattr(whole.caches[cname], field).shape),
                                   generator=gen, device="cuda")
                getattr(c, field).copy_(cache_block(scfg, full, mesh, serve.layout, rows))
        del whole
        state = state._replace(pos=torch.tensor(pos, dtype=torch.int32, device="cuda"))
        toks = torch.randint(0, cfg.vocab_size, (shape.global_batch, TP_CACHE_STEPS),
                             generator=gen, device="cuda")
        if rows < shape.global_batch:
            toks = toks[mesh.client_slice(shape.global_batch)]
        if mesh is not None:
            mesh.reset_tally()
        torch.cuda.synchronize()
        t0, logits = time.perf_counter(), []
        for t in range(TP_CACHE_STEPS):
            lg, state = serve(params, toks[:, t], state)
            logits.append(lg)
        torch.cuda.synchronize()
        kv = next(c.k for c in state.caches.values())
        out[label] = dict(
            logits=torch.stack(logits, 1).cpu(), rows=rows,
            ms=(time.perf_counter() - t0) / TP_CACHE_STEPS * 1e3,
            layout=None if serve.layout is None else serve.layout.describe(),
            kv=tuple(kv.shape), tally=None if mesh is None else mesh.collective_tally(),
            coords=None if mesh is None else (mesh.rank, mesh.model_rank))
        del state, logits
        torch.cuda.empty_cache()
    return out


def cache_verdict(torch, outs, failures):
    """(m)'s check of the ranks' `cache_serve` results `outs` against one
    process: each layout's logits within TP_SERVE_TOL of the largest
    |logit|, the layout that took effect as `TP_CACHE` says, the merge
    over "data" tallied as client-axis all-reduces (none elsewhere);
    returns each layout's readings."""
    one = cache_serve(torch, None)
    res = {}
    for label, _, cache_shard, pos, want_layout in TP_CACHE:
        want = one[label]["logits"]
        gaps = []
        for o in outs:
            got = o[label]
            rows = (slice(None) if got["rows"] == want.shape[0] else
                    slice(got["coords"][0] * got["rows"], (got["coords"][0] + 1) * got["rows"]))
            gaps.append(rel_gap(got["logits"], want[rows]))
        o0 = outs[0][label]
        counts, tally = o0["tally"]["_counts"], o0["tally"]
        client = counts["client_all_reduce"]
        ok = (max(gaps) <= TP_SERVE_TOL and o0["layout"] == want_layout
              and (client > 0) == (want_layout["slots"] == "data")
              and all(bool(torch.isfinite(o[label]["logits"]).all()) for o in outs))
        res[label] = dict(gap=max(gaps), ms=max(o[label]["ms"] for o in outs),
                          one_ms=one[label]["ms"], client_calls=client,
                          client_bytes=tally["client_all_reduce"],
                          model_calls=counts["model_all_reduce"] + counts["model_all_gather"],
                          kv=o0["kv"], one_kv=one[label]["kv"])
        log(f"  (m) {label} (cache_shard {cache_shard}, from position {pos}, "
            f"{TP_CACHE_STEPS} steps, qwen2-1.5b f32, all layers) on {TP_SHAPE}: layout "
            f"{o0['layout']}, a rank's KV cache {o0['kv']} of {one[label]['kv']}; "
            f"{res[label]['ms']:.2f} ms/step (one process {one[label]['ms']:.2f}); client-axis "
            f"all-reduces {client} calls {tally['client_all_reduce']} bytes, model axis "
            f"{counts['model_all_reduce']} all-reduces, {counts['model_all_gather']} "
            f"all-gathers; logits against one process, largest gap / largest |logit| "
            f"{max(gaps):.3e} (tolerance {TP_SERVE_TOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"(m) {label}")
    return res


_REFS = {}


def single_reference(torch, cfg, argv, none, steps, gate=TP_GATE, keep=None):
    """The single-process trainer on `argv` (a mesh run's CLI without
    --mesh-backend) for `steps` steps, its plane unmixed with `none`, a
    vlm's cross layers' gates set to `gate` at init (`gate_init`): per
    step, each client's loss and delta-row digest (`row_digest`), and the
    params after step 1 saved to a file on the host (with `keep`
    ``"cross"`` only the cross layers' leaves: a whole f32 vlm's 17 GB
    would take the machine's disk past its limit, PERF.md §6). Cached
    by config, argv, `none`, `gate` and `keep`: phase 21 (b) and phase 23
    (a) share one run. Returns (record, path)."""
    import tempfile

    from repro_torch.core import flat as flat_lib
    from repro_torch.core import mixing
    from repro_torch.launch import train

    key = (cfg, tuple(argv), none, gate, keep)
    if key in _REFS and len(_REFS[key][0]) >= steps:
        return _REFS[key]
    if "dir" not in _REFS:
        _REFS["dir"] = tempfile.TemporaryDirectory(prefix="refs-")
    path = os.path.join(_REFS["dir"].name, f"ref{len(_REFS)}.pt")
    record, real = [], (mixing.mix_plane, train.train_step_clients)

    def mix_plane(q_eff, plane, mix=None):
        record.append(dict(digests=[row_digest(torch, r) for r in plane]))
        return plane.clone() if none else real[0](q_eff, plane, mix)

    def train_step_clients(*args, **kw):
        params, losses = real[1](*args, **kw)
        record[-1]["losses"] = losses.tolist()
        if len(record) == 1:
            torch.save(flat_lib.tree_from_items(
                (p, leaf.cpu()) for p, leaf in flat_lib.tree_items(params)
                if keep is None or p[1:2] and p[1].endswith(":cross")), path)
        return params, losses

    argv = [a for a in argv if a not in ("--mesh-backend", "gloo")] + ["--steps", str(steps)]
    mixing.mix_plane, train.train_step_clients = mix_plane, train_step_clients
    ungate = gate_init(gate)
    try:
        train.main(argv, cfg=cfg)
    finally:
        ungate()
        mixing.mix_plane, train.train_step_clients = real
    torch.cuda.empty_cache()
    _REFS[key] = record, path
    return record, path


def mode_gate(fault):
    """The cross layers' init gate of a phase 23 run planted with `fault`."""
    return 0.0 if fault == TP_TRAP else TP_GATE


def gate_init(gate):
    """Make `M.init_params` set every cross layer's tanh gate to `gate` in
    this process (a vlm's; other models have none); returns the function
    that removes it."""
    from repro_torch.models import model as M

    real = M.init_params

    def init_params(*a, **k):
        params = real(*a, **k)
        for name, block in params["groups"].items():
            if name.endswith(":cross"):
                block["gate"].fill_(gate)
        return params

    M.init_params = init_params
    return lambda: setattr(M, "init_params", real)


def plant(fault):
    """Install `fault` of `TP_FAULTS` (or `TP_TRAP`) in this process;
    returns the function that removes it."""
    from repro_torch.models import model as M
    from repro_torch.models import moe

    if fault in ("cross-unreduced", TP_TRAP, TP_F4_FAULT):
        from repro_torch.models import attention

        real = attention.full_attention

        class NoReduce:  # the rank's `TP`, its output join the identity
            def __init__(self, tp):
                self.tp = tp

            def __getattr__(self, name):
                return getattr(self.tp, name)

            def leave(self, x):  # the partial output (its positions with the flag)
                return self.tp.positions(x) if self.tp.seq else x

        def full_attention(*a, cross=False, tp=None, **k):
            return real(*a, cross=cross, tp=NoReduce(tp) if cross and tp else tp, **k)

        attention.full_attention = full_attention
        return lambda: setattr(attention, "full_attention", real)
    if fault == "router-twice":
        real = M.moe_block

        def moe_block(p, x, cfg, tp=None, rows=None):
            return real(dict(p, router=tp.copy(p["router"])) if tp else p, x, cfg, tp, rows)

        M.moe_block = moe_block
        return lambda: setattr(M, "moe_block", real)
    if fault == "unreduced":
        real = moe._Combine

        class Combine(real):
            @staticmethod
            def forward(ctx, out_e, gate, dst, src, tp, batch=0):
                out = real.forward(ctx, out_e, gate, dst, src, None)  # the rank's part alone
                ctx.tp = tp
                return out

        moe._Combine = Combine
        return lambda: setattr(moe, "_Combine", real)
    if fault == "norm-forward-only":
        from repro_torch.models import ssm

        real = ssm._gated_norm

        class ReduceOnly:  # `TP.reduce` forward, no `TP.copy` on its result
            def __init__(self, tp):
                self.reduce = tp.reduce

            @staticmethod
            def copy(x):
                return x

        def gated_norm(y, z, scale, cfg, tp=None):
            return real(y, z, scale, cfg, tp and ReduceOnly(tp))

        ssm._gated_norm = gated_norm
        return lambda: setattr(ssm, "_gated_norm", real)
    return lambda: None


def tp_rank_train(rank, world, layout, modes, serves=(), mesh_modes=(), cache=False):
    """Phase 21 (b)'s `mesh_modes` first (`mesh_rank_train`, under
    ``"mesh"``: the world shared, phase 23's worlds of 4 and 2 ranks), then
    phase 23's trainers in one rank of the `layout` mesh: for each
    (label, arch, layers, config overrides, argv, reference path, planted
    fault) of `modes`, `train.main` on `arch` at `layers` layers
    (`tp_config`). Around each step of the rank's clients: its time, the
    collectives' seconds, the model axis's tally, the routes, experts and
    ssm heads taken; after step 1 every leaf of the rank's blocks against
    its block of the single-process params; after each step the
    replicated leaves (no "model" in their spec) on the host, for the
    parent to compare across the model ranks. The drain launches are
    counted from 0 around each run, the `ssd_chunk` launches from 0 over
    the rank's whole work (``"ssd_chunk"``). A mode labelled ``"<twin>
    sp"`` (the flag's, part (l)) also holds step 1's blocks against those
    of the mode ``<twin>`` run before it in the world (``"twin_gaps"``,
    ``"twin_updates"``). Each mode's wall seconds, its process's set-up
    and steps, under ``"wall_s"``. Then each (arch, layers) of `serves`
    served in the same world (``"serve"``, keyed by them), and with `cache`
    part (m)'s cache layouts (``"cache"``, `cache_serve`)."""
    import torch

    import repro_torch  # noqa: F401  (TF32 off)
    from repro_torch.core import flat as flat_lib
    from repro_torch.kernels.gossip import ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch import steps, train
    from repro_torch.sharding import tp as tp_lib
    from repro_torch.sharding.specs import tree_param_specs

    out = {"serve": {}}
    if mesh_modes:
        out["mesh"] = mesh_rank_train(rank, world, mesh_modes)
        torch.cuda.empty_cache()
    ssd_ops.ssd_chunk.launches = 0
    twins = {m[0][:-len(" sp")] for m in modes if m[0].endswith(" sp")}
    firsts = {}  # a twin's step-1 blocks on the host
    for label, arch, layers, overrides, argv, ref_path, fault in modes:
        t_mode = time.perf_counter()
        twin = firsts.get(label[:-len(" sp")]) if label.endswith(" sp") else None
        cfg = tp_config(arch, layers, overrides)
        ref = torch.load(ref_path, mmap=True, weights_only=True)
        record, box = [], []
        real_mix, real_clients = steps.mesh_mix, train.train_step_clients

        def mesh_mix(mesh, *a, **k):
            box.append(mesh)
            return real_mix(mesh, *a, **k)

        ref_leaves = dict(flat_lib.tree_items(ref))

        def train_step_clients(*a, **k):
            mesh = box[-1]
            n = next(iter(ref_leaves.values())).shape[0]
            whole = steps.stack_clients_abstract(steps.param_specs_abstract(cfg), n)
            specs = dict(flat_lib.tree_items(tree_param_specs(whole, prefix=("data",),
                                                              mesh=mesh)))
            torch.cuda.synchronize()
            c0, t0 = mesh.collective_s, time.perf_counter()
            tally0, routes0 = mesh.collective_tally(), dict(mesh.tp_routes)
            before = {} if record else {path: leaf.clone() for path, leaf in
                                        flat_lib.tree_items(a[0]) if leaf.dtype == torch.float32}
            params, losses = real_clients(*a, **k)
            torch.cuda.synchronize()
            if fault == "weight-shard" and not record and mesh.model_rank == 1:
                w = params["groups"]["1:mlp"]["mlp"]["w_down"]
                w.view(-1)[0] += TP_FAULT_SHIFT * w.abs().max()
            tally = mesh.collective_tally()
            entry = dict(step_s=time.perf_counter() - t0, collective_s=mesh.collective_s - c0,
                         losses=losses.tolist(),
                         tally={kind: (tally["_counts"][kind] - tally0["_counts"][kind],
                                       tally[kind] - tally0[kind])
                                for kind in ("model_all_reduce", "model_all_gather",
                                             "model_reduce_scatter", "reduce_scatter")},
                         routes={k: v if k in ("experts", "ssm_heads") else v - routes0[k]
                                 for k, v in mesh.tp_routes.items()},
                         replicated={}, gaps={}, updates={}, twin_gaps={}, twin_updates={})
            for path, leaf in flat_lib.tree_items(params):
                if "model" not in specs[path]:
                    entry["replicated"][path] = leaf.cpu()
                if not record and path in ref_leaves:  # step 1: against one process
                    want = tp_lib.block(ref_leaves[path], specs[path], mesh).to(leaf.device)
                    entry["gaps"][path] = (float((leaf.float() - want.float()).abs().max()),
                                           float(want.float().abs().max()))
                    if path in before:
                        entry["updates"][path] = float((want - before[path]).abs().max())
                    if label in twins:
                        firsts[label] = firsts.get(label, {})
                        firsts[label][path] = leaf.cpu()
                    if twin is not None:  # against the twin's step 1, without the flag
                        other = twin[path].to(leaf.device)
                        entry["twin_gaps"][path] = (
                            float((leaf.float() - other.float()).abs().max()),
                            float(other.float().abs().max()))
                        if path in before:
                            entry["twin_updates"][path] = float(
                                (other - before[path]).abs().max())
            record.append(entry)
            return params, losses

        real_layout = train.mesh_layout
        steps.mesh_mix, train.train_step_clients = mesh_mix, train_step_clients
        # 4 clients on (2, 2): the reference's rule lays 4 ranks of 4 clients as (4, 1)
        train.mesh_layout = lambda world, clients: layout
        unplant, ungate = plant(fault), gate_init(mode_gate(fault))
        torch.cuda.reset_peak_memory_stats()
        ops.gossip_drain.launches = 0
        try:
            losses = train.main(MESH_TRAIN_ARGS + argv, cfg=cfg)
        finally:
            ungate()
            unplant()
            steps.mesh_mix, train.train_step_clients = real_mix, real_clients
            train.mesh_layout = real_layout
        torch.cuda.synchronize()
        out[label] = dict(losses=losses, launches=ops.gossip_drain.launches, steps=record,
                          coords=(box[0].rank, box[0].model_rank), staged=box[0].staged,
                          peak=torch.cuda.max_memory_allocated(),
                          wall_s=time.perf_counter() - t_mode)
        del ref, ref_leaves
        torch.cuda.empty_cache()
    for serve in serves:
        out["serve"][serve] = tp_rank_serve(rank, world, *serve)
        torch.cuda.empty_cache()
    if cache:
        from repro_torch.launch import mesh as mesh_lib

        out["cache"] = cache_serve(torch, mesh_lib.make_mesh(layout, ("data", "model"),
                                                             backend="gloo"))
        torch.cuda.empty_cache()
    out["ssd_chunk"] = ssd_ops.ssd_chunk.launches
    return out


def tp_verdict(torch, runs, ref_losses, dense, routes=None, zero_tol=TP_PARAM_TOL,
               f32_tol=TP_F32_TOL):
    """Phase 23 (a)'s, (d)'s, (f)'s or (g)'s checks of one mode's `runs`
    (each rank's result) against the single-process step-1 losses
    `ref_losses`, a zero-init leaf within `zero_tol` of its largest
    |value|, an f32 leaf within `f32_tol` of its largest step-1 update
    (unless the gap is one rounding of its largest |value|: an update
    under a few steps of the value's spacing, as a_log's, is no yardstick
    then), every step's `routes` entries (say the experts or ssm heads a
    rank) as given: (ok, the readings)."""
    runs = sorted(runs, key=lambda r: r["coords"])
    losses = [x for r in runs if r["coords"][1] == 0 for x in r["steps"][0]["losses"]]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    worst = worst_gaps(runs)
    # every model rank of a client index: the same losses, and the
    # replicated leaves bit for bit, after each step
    first = {r["coords"][0]: r for r in runs if r["coords"][1] == 0}
    equal = all(
        r["steps"][step]["losses"] == first[r["coords"][0]]["steps"][step]["losses"]
        and all(torch.equal(leaf, first[r["coords"][0]]["steps"][step]["replicated"][p])
                for p, leaf in r["steps"][step]["replicated"].items())
        for r in runs for step in range(len(r["steps"])))
    launches = sum(r["launches"] for r in runs)
    expect = sum(len(r["steps"]) for r in runs) if dense else 0
    got = {k: sorted({e["routes"][k] for r in runs for e in r["steps"]})
           for k in (routes or {})}
    finite = all(math.isfinite(x) for r in runs for x in r["losses"])
    ok = (loss_gap <= TP_LOSS_TOL and worst["weight"][0] <= TP_WEIGHT_TOL
          and worst.get("other", (0.0,))[0] <= zero_tol
          and worst.get("f32", (0.0,))[0] <= f32_tol and equal and launches == expect
          and finite and all(got[k] == [v] for k, v in (routes or {}).items()))
    return ok, dict(losses=losses, loss_gap=loss_gap, worst=worst, equal=equal,
                    zero_tol=zero_tol, f32_tol=f32_tol, launches=launches, expect=expect, routes=got,
                    n_repl=len(runs[0]["steps"][0]["replicated"]), runs=runs)


def worst_gaps(runs, gaps="gaps", updates="updates"):
    """The largest step-1 gap of `runs` by kind of leaf: of a weight
    (`TP_WEIGHTS`) and of another leaf over its largest |value|, of an f32
    leaf over its largest update (where the gap is more than one rounding
    of its value), each as (ratio, path, gap, scale)."""
    worst = {}
    for r in runs:
        e = r["steps"][0]
        for path, (gap, scale) in e[gaps].items():
            kind = "weight" if path[-1].startswith(TP_WEIGHTS) else "other"
            worst[kind] = max(worst.get(kind, (0.0,)), (gap / max(scale, 1e-30), path, gap,
                                                        scale))
            if path in e[updates] and gap > F32_EPS * scale:
                upd = e[updates][path]
                worst["f32"] = max(worst.get("f32", (0.0,)), (gap / max(upd, 1e-30), path, gap,
                                                              upd))
    return worst


def twin_verdict(runs, twin_runs, zero_tol=TP_PARAM_TOL, f32_tol=TP_F32_TOL):
    """Part (l)'s second check of a mode with the flag: its step 1 (`runs`,
    each rank's) against its twin's without the flag in the same world
    (`twin_runs`), the losses and every leaf under the twin's bounds, and
    the sequence-parallel sub-blocks tallied on every rank at every step:
    (ok, the readings)."""
    runs = sorted(runs, key=lambda r: r["coords"])
    twin_runs = sorted(twin_runs, key=lambda r: r["coords"])
    loss_gap = max(abs(a - b) / abs(b) for r, t in zip(runs, twin_runs)
                   for a, b in zip(r["steps"][0]["losses"], t["steps"][0]["losses"]))
    worst = worst_gaps(runs, "twin_gaps", "twin_updates")
    split = all(e["routes"]["seq"] > 0 and not e["routes"]["seq_whole"]
                for r in runs for e in r["steps"])
    ok = (loss_gap <= TP_LOSS_TOL and worst["weight"][0] <= TP_WEIGHT_TOL
          and worst.get("other", (0.0,))[0] <= zero_tol
          and worst.get("f32", (0.0,))[0] <= f32_tol and split)
    return ok, dict(loss_gap=loss_gap, worst=worst, split=split,
                    seq=runs[0]["steps"][0]["routes"]["seq"],
                    wall_s=max(r["wall_s"] for r in runs))


def cross_update_reading(v):
    """ROADMAP F4's reading: the largest step-1 gap / largest step-1 update
    among a verdict's cross-layer leaves (the ``:cross`` blocks' gate, norm
    and projections) over the ranks, a gap within one rounding of the
    leaf's largest |value| read as 0 (`worst_gaps`' rule): (reading,
    path)."""
    return max(((gap / max(r["steps"][0]["updates"][path], 1e-30), path) for r in v["runs"]
                for path, (gap, scale) in r["steps"][0]["gaps"].items()
                if len(path) > 2 and path[1].endswith(":cross")
                and path in r["steps"][0]["updates"] and gap > F32_EPS * scale),
               default=(0.0, None))


def log_verdict(tag, label, ok, v, ref_losses):
    def leaf(kind, what, tol):
        if kind not in v["worst"]:
            return f"no {what}"
        rel, path, gap, scale = v["worst"][kind]
        return (f"of a {what} {rel:.3e} at {'/'.join(path)} ({gap:.3e} of {scale:.3e}; "
                f"tolerance {tol:.3e})")

    log(f"  ({tag}) {label}: step 1 losses " + " ".join(f"{x:.6f}" for x in v["losses"])
        + " against one process " + " ".join(f"{x:.6f}" for x in ref_losses)
        + f", largest relative gap {v['loss_gap']:.3e} (tolerance {TP_LOSS_TOL}); params: the "
        f"largest gap / largest |value| {leaf('weight', 'weight', TP_WEIGHT_TOL)}, "
        f"{leaf('other', 'zero-init leaf', v['zero_tol'])}; the largest gap / largest update "
        f"{leaf('f32', 'f32 leaf', v['f32_tol'])}; {v['n_repl']} replicated leaves bit for bit "
        f"equal "
        f"across the model ranks after every step {v['equal']}; {v['launches']} drain launches "
        f"(expected {v['expect']}); routes held {v['routes']} {'ok' if ok else 'FAIL'}")


def tp_train_rows(tag, label, v):
    """Log each step of rank 0 of a verdict's runs; the mode's row for
    PERF.md and phase 9."""
    runs = v["runs"]
    for step, e in enumerate(runs[0]["steps"]):
        log(f"  ({tag}) {label} step {step + 1} (rank 0): {e['step_s']:.4f} s, collectives "
            f"{e['collective_s']:.4f} s staged through the host "
            f"({100 * e['collective_s'] / e['step_s']:.1f}%); model axis: "
            + ", ".join(f"{k} {c} calls {b} bytes" for k, (c, b) in e["tally"].items())
            + f"; routes {e['routes']}")
    s2 = runs[0]["steps"][-1]
    return dict(s_step=max(r["steps"][-1]["step_s"] for r in runs),
                collective_s=s2["collective_s"], share=s2["collective_s"] / s2["step_s"],
                tally=s2["tally"], routes=s2["routes"], peak=max(r["peak"] for r in runs),
                loss_gap=v["loss_gap"], weight_gap=v["worst"]["weight"][0])


def tp_reference_argv(argv):
    """The single-process reference's CLI of a mode's own arguments
    `argv`: without the mix mode (one device mixes densely; `none` skips
    the mix), the flag (one device has no "model" axis) and the step
    count (`single_reference` sets it)."""
    out, skip = [], False
    for a in argv:
        if skip or a in ("--mix", "--steps"):
            skip = a in ("--mix", "--steps")
            continue
        if a != "--seq-parallel":
            out.append(a)
    return out


def tp_config(arch, layers, overrides=None):
    """`arch` at full width and `layers` layers, with the config fields of
    `overrides` (a dict, say the dtype) replaced."""
    from repro_torch.configs.base import get_config

    return get_config(arch).with_(num_layers=layers, **(overrides or {}))


def tp_world(torch, tag, layout, modes, steps=1, serves=(), mesh_modes=(), cache=False):
    """The single-process references and one world of phase 23's trainers:
    `modes` (label, arch, layers, config overrides, argv, fault) on the
    `layout` mesh, after phase 21 (b)'s `mesh_modes`, then `serves`
    ((arch, layers) each) and with `cache` part (m)'s cache layouts in the
    same world (`tp_rank_train`); returns (each rank's results, {label:
    step-1 losses of the reference})."""
    from repro_torch.launch import mesh as mesh_lib

    refs, rank_modes = {}, []
    for label, arch, layers, overrides, argv, fault in modes:
        record, path = single_reference(torch, tp_config(arch, layers, overrides),
                                        MESH_TRAIN_ARGS + tp_reference_argv(argv),
                                        "none" in argv, steps, mode_gate(fault),
                                        "cross" if argv is TP_SP_F32_ARGV else None)
        refs[label] = record[0]["losses"]
        rank_modes.append((label, arch, layers, overrides, argv, path, fault))
    t0 = time.perf_counter()
    outs = mesh_lib.spawn_ranks(tp_rank_train, math.prod(layout), layout, rank_modes,
                                tuple(serves), tuple(mesh_modes), cache, backend="gloo",
                                timeout=600, threads=0, deadline=1100)
    log(f"  ({tag}) tensor-parallel world {layout} of {math.prod(layout)} gloo ranks: "
        f"{time.perf_counter() - t0:.1f} s with process start")
    return outs, refs


def tp_dry(torch, tag, pair, failures, cache_shard="kv_heads", by_depth=True):
    """Phase 23 (c), (e), (h), (k), (l) or (m): the dry run's (16, 16) `pair`
    ((arch, shape, mix, blocked_threshold[, vocab_chunk[, seq_parallel]]))
    reckoned and run at depths 1 and 2 (`by_depth`; else at full depth
    where it fits), a decode pair's caches laid by `cache_shard`, each peak
    within `DRY_PEAK_TOL`; returns its row, the run's kernel launches under
    ``"launches"``."""
    from repro_torch.launch import dryrun

    arch, shape, mix, threshold, chunk, sp = (*pair, 0, False)[:6]
    reset_launches()
    row = dryrun.lower_pair(arch, shape, mix_mode=mix, blocked_threshold=threshold, run=True,
                            by_depth=by_depth, vocab_chunk=chunk, seq_parallel=bool(sp),
                            cache_shard=cache_shard, verbose=False,
                            reckoned=reckoned(tp_key(pair, cache_shard)))
    row["launches"] = launch_counts()
    log(f"phase 23 ({tag}) row: {json.dumps(row)}")
    peaks = []
    for what, got, want in peak_gaps(row):
        gap, tol = abs(got - want), DRY_PEAK_TOL[0] * want + DRY_PEAK_TOL[1]
        peaks.append(f"{what} {got / 2**30:.3f} GiB measured, {want / 2**30:.3f} reckoned, "
                     f"gap {gap} bytes (bound {tol:.0f})")
        if gap > tol:
            failures.append(f"({tag}) peak gap {gap} > {tol:.0f} at {what}")
    frac = row["bound_fraction"]
    if not (math.isfinite(frac) and 0 < frac <= 1) or row["host_syncs"]:
        failures.append(f"({tag}) bound_fraction {frac}, {row['host_syncs']} host syncs")
    total = torch.cuda.get_device_properties(0).total_memory
    if row["reckoned_peak_bytes"] > total:
        failures.append(f"({tag}) reckoned full-depth peak {row['reckoned_peak_bytes']} past "
                        f"the card's {total} bytes")
    coll = row["coll_breakdown"]
    what = (f"cache_shard {cache_shard}, layout {row['cache_layout']}, {row['serving_rows']} "
            f"rows a client rank, client-axis all-reduces {coll['counts']['client_all_reduce']} "
            f"calls {coll['client_all_reduce']} bytes" if row["mode"] == "decode" else
            f"{mix}, flash from {threshold} tokens, loss in chunks of {chunk or 'all'} "
            f"positions, seq_parallel {row['seq_parallel']}")
    log(f"  ({tag}) dry run {arch} x {shape} x {row['mesh']} ({what}): run at "
        f"{row['run_depth']}, peak "
        f"{row['measured_peak_bytes'] / 2**30:.3f} GiB, {row['measured_s_per_step']:.6f} s/step, "
        f"bound {row['t_bound_s']:.6f} s, bound_fraction {frac:.4f}, roofline_fraction "
        f"{row['roofline_fraction']:.4f}, useful_flops_ratio {row['useful_flops_ratio']:.3f}; "
        f"routes {row['tp_routes']}; model-axis bytes {coll['model_all_reduce']} all-reduce, "
        f"{coll['model_all_gather']} all-gather, {coll['model_reduce_scatter']} "
        f"reduce-scatter; full-depth reckoned peak {row['reckoned_peak_bytes'] / 2**30:.3f} "
        f"GiB (the card {total / 2**30:.3f}); peaks: {'; '.join(peaks)}; "
        f"{row['host_syncs']} host syncs; reckoned in {row['t_compile_s']:.1f} s; launches "
        f"{row['launches']}")
    return row


def tp_serve_inputs(torch, arch, layers):
    """Phase 23 (b)'s, (g)'s, (i)'s or (j)'s config (f32, `layers` of
    `arch`'s layers or all of them), prompt and shapes, alike in every
    process: the prompt's tokens (an audio model: its frame embeddings)
    and a vlm's patch embeddings."""
    from repro_torch.configs.base import ShapeConfig, get_config

    cfg = get_config(arch).with_(dtype="float32")
    if layers is not None:
        cfg = cfg.with_(num_layers=layers)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 231)
    batch = prompt_batch(torch, cfg, gen, TP_SERVE_BATCH, TP_SERVE_PROMPT, "cuda")
    return (cfg, batch, ShapeConfig("prefill", TP_SERVE_PROMPT, TP_SERVE_BATCH, "prefill"),
            ShapeConfig("serve", TP_SERVE_PROMPT, TP_SERVE_BATCH, "decode"))


def tp_serve(torch, mesh, arch="qwen2-1.5b", layers=None, fed=None):
    """Prefill and `TP_DECODE_STEPS` decode steps of `arch` at `layers`
    layers on `mesh` (None: one process), a vlm's gates at `TP_GATE` and
    its cross K/V the rank's kv heads; an audio model then decodes
    `TP_FEED` steps more, each fed back a token's embedding
    (`M.token_embeds`, vocab-parallel on the mesh): the argmax of the last
    logits, or the tokens `fed` (another run's, so that one process feeds
    what the ranks fed). The logits on the host, the tokens fed, the
    times, and the heads of each cache of group 0 (a KV cache's kv heads,
    an SSM state's ssm heads, the cross K/V's kv heads)."""
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.models.attention import KVCache
    from repro_torch.sharding import tp as tp_lib

    cfg, batch, pshape, dshape = tp_serve_inputs(torch, arch, layers)
    ungate = gate_init(TP_GATE)
    try:
        params = M.init_params(SEED + 230, cfg, "cuda", shard=tp_lib.sharder(mesh))
    finally:
        ungate()
    prefill_step = steps.make_prefill_step(cfg, pshape, mesh)
    prefill_step(params, batch)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill = prefill_step(params, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    serve = steps.make_serve_step(cfg, dshape, mesh)
    state = M.init_decode_state(cfg, TP_SERVE_BATCH, TP_SERVE_PROMPT, device="cuda", mesh=mesh)
    cross = None
    if cfg.family == "vlm":
        cross = M.init_cross_kv(params, cfg, batch["cross_embeds"], mesh)
    logits, fed_now = [], []
    for t in range(TP_DECODE_STEPS):
        x = batch["embeds"][:, t:t + 1] if cfg.embeds_in else batch["tokens"][:, t]
        lg, state = serve(params, x, state, cross)
        logits.append(lg)
    for j in range(TP_FEED if cfg.embeds_in else 0):
        tok = torch.argmax(logits[-1], dim=-1) if fed is None else fed[:, j].to(lg.device)
        fed_now.append(tok)
        lg, state = serve(params, M.token_embeds(params, cfg, tok, mesh), state, cross)
        logits.append(lg)
    torch.cuda.synchronize()
    heads = {name: c.k.shape[-2] if isinstance(c, KVCache) else c.h.shape[-3]
             for name, c in state.caches.items()}
    if cross is not None:
        heads["cross"] = cross["k"].shape[-2]
    return dict(prefill=prefill.cpu(), decode=torch.stack(logits, 1).cpu(),
                fed=torch.stack(fed_now, 1).cpu() if fed_now else None,
                prefill_s=t1 - t0, decode_s=(time.perf_counter() - t1) / len(logits),
                heads=heads)


def tp_rank_serve(rank, world, arch, layers):
    """Phase 23 (b) or (g)'s serving in one rank of its (1, 2) world."""
    import torch

    import repro_torch  # noqa: F401  (TF32 off)
    from repro_torch.launch import mesh as mesh_lib

    mesh = mesh_lib.make_mesh(TP_SERVE_SHAPE, ("data", "model"), backend="gloo")
    out = tp_serve(torch, mesh, arch, layers)
    out.update(tally=mesh.collective_tally(), collective_s=mesh.collective_s,
               routes=dict(mesh.tp_routes))
    return out


def tp_served(torch, tag, outs, arch, layers, tol):
    """(b)'s, (g)'s, (i)'s or (j)'s check: the served logits of `outs`
    (each rank's) against one process within `tol` of the largest
    |logit|; (ok, row)."""
    one = tp_serve(torch, None, arch, layers, fed=outs[0]["fed"])
    gaps = {k: max(rel_gap(o[k], one[k]) for o in outs) for k in ("prefill", "decode")}
    ok = all(g <= tol for g in gaps.values()) and all(
        bool(torch.isfinite(o["decode"]).all()) for o in outs)
    o0 = outs[0]
    log(f"  ({tag}) serving {arch} (f32, full width, {layers or 'all'} layers) on "
        f"{TP_SERVE_SHAPE}: prefill {TP_SERVE_BATCH} x {TP_SERVE_PROMPT} {o0['prefill_s']:.4f} s "
        f"(one process {one['prefill_s']:.4f}), decode {o0['decode_s'] * 1e3:.2f} ms/step (one "
        f"process {one['decode_s'] * 1e3:.2f}); cache heads a rank {o0['heads']} of "
        f"{one['heads']}; routes {o0['routes']}; model-axis calls "
        f"{o0['tally']['_counts']['model_all_reduce']} all-reduce, "
        f"{o0['tally']['_counts']['model_all_gather']} all-gather, collectives "
        f"{o0['collective_s']:.3f} s; logits against one process, largest gap / largest "
        f"|logit|: prefill {gaps['prefill']:.3e}, decode {gaps['decode']:.3e} (tolerance "
        f"{tol}) {'ok' if ok else 'FAIL'}")
    return ok, dict(gaps=gaps, prefill_s=o0["prefill_s"], decode_s=o0["decode_s"],
                    one_prefill_s=one["prefill_s"], one_decode_s=one["decode_s"])


def cross_heads(cfg, size):
    """Each of `size` model ranks' (query heads, kv heads) in an attention
    layer of `cfg` (`attention.rank_heads`), for phase 23's logs."""
    from repro_torch.models import attention

    hd = cfg.resolved_head_dim
    return [attention.rank_heads(cfg, r, size, cfg.num_heads * hd % size == 0,
                                 cfg.num_kv_heads % size == 0)[1::2] for r in range(size)]


def phase_tp(torch, mesh=None):
    """Phase 23 (see `TP_MODES` and the constants above them): returns
    its numbers for the kernels line, phase 9 and PERF.md. Given phase
    21's results `mesh` (`phase_mesh(share=True)`), its worlds of 4 and 2
    ranks run phase 21 (b)'s modes first, whose checks then fill `mesh`
    in (`mesh_train_verdict`)."""
    t_start = time.perf_counter()
    torch.cuda.empty_cache()
    res, failures, rows, launches, served = {}, [], {}, 0, {}
    ssd_launches = 0

    # (a) the (2, 2) world of qwen2-1.5b; the (1, 2) world of (d) olmoe,
    # (f) mamba2, (g) zamba2, (i) the vlm and (j) musicgen, which then
    # serves (b) qwen2, (g) zamba2, (i) the vlm and (j) musicgen
    family_modes, checks = tp_family_modes()
    checks.update({label: (None, TP_PARAM_TOL, TP_F32_TOL) for label, _ in TP_MODES})
    checks["moe dense"] = ({"experts": TP_MOE_EXPERTS}, TP_MOE_PARAM_TOL, TP_F32_TOL)
    worlds = [("a, l", TP_SHAPE, [(label, "qwen2-1.5b", MESH_LAYERS, None, argv, None)
                                  for label, argv in TP_MODES], ()),
              ("d, f, g, i, j, l", TP_MOE_SHAPE,
               [("moe dense", TP_MOE_ARCH, TP_MOE_LAYERS, None, TP_MOE_ARGS, None),
                *family_modes],
               (("qwen2-1.5b", None), TP_SSM_SERVE, *TP_CROSS_SERVE))]
    for _, _, modes, _ in worlds:  # (l): each twin's run with the flag after it
        modes += [(f"{m[0]} sp", *m[1:4], m[4] + TP_SP_ARGV, None) for twin in TP_SP
                  for m in modes if m[0] == twin]
    checks.update({f"{twin} sp": checks[twin] for twin in TP_SP})
    worlds[1][2].append(tp_f32_mode())
    checks[TP_SP_F32_LABEL] = checks[f"{TP_SP_F32[0]} dense"]
    res["sp"], sp_s = {}, 0.0
    shared, cache_outs = {}, None
    for tag, layout, modes, serves in worlds:
        t0 = time.perf_counter()
        ranks = math.prod(layout)
        outs, refs = tp_world(torch, tag, layout, modes, serves=serves,
                              mesh_modes=() if mesh is None else mesh_modes(ranks),
                              cache=layout == TP_SHAPE)
        if mesh is not None:
            shared[ranks] = [o["mesh"] for o in outs]
        if layout == TP_SHAPE:
            cache_outs = [o["cache"] for o in outs]
        for label, _, _, _, argv, _ in modes:
            ok, v = tp_verdict(torch, [o[label] for o in outs], refs[label],
                               "dense" in argv, *checks[label])
            log_verdict(tag, label, ok, v, refs[label])
            rows[label] = tp_train_rows(tag, label, v)
            if not ok:
                failures.append(f"({tag}) {label}")
            launches += v["launches"]
            if "--seq-parallel" in argv:
                ok_sp, res["sp"][label] = sp_verdict(label, outs, v, checks[label])
                sp_s += res["sp"][label]["wall_s"]
                if not ok_sp:
                    failures.append(f"(l) {label}")
        for _, arch, layers, overrides, _ in (w for w in TP_CROSS
                                              if any(m[1] == w[1] for m in modes)):
            log(f"  ({tag}) {arch} dense: (query heads, kv heads) a model rank in each "
                f"attention layer, the cross layer's too: "
                f"{cross_heads(tp_config(arch, layers, overrides), layout[1])}")
        ssd_launches += sum(o["ssd_chunk"] for o in outs)
        for serve in serves:
            served[serve] = [o["serve"][serve] for o in outs]
        log(f"phase 23 ({tag}): {time.perf_counter() - t0:.1f} s")
        del outs
        torch.cuda.empty_cache()
    res["train"] = rows
    res["launches"] = launches
    res["collective_ms"] = dict(
        ms=1e3 * rows["dense"]["collective_s"],
        what=f"gloo collectives of a {TP_SHAPE} dense step at {MESH_LAYERS} layers (the "
        f"reduce-scatter of the (4, K) f32 partial and the model axis's), rank 0, a step")
    res["moe_collective_ms"] = dict(
        ms=1e3 * rows["moe dense"]["collective_s"],
        what=f"gloo collectives of a {TP_MOE_SHAPE} step of {TP_MOE_ARCH} at {TP_MOE_LAYERS} "
        f"layers (the model axis's; a client group of one sends nothing), rank 0, a step")
    res["plane_collective_ms"] = {
        label: dict(ms=1e3 * rows[f"{arch} dense"]["collective_s"],
                    what=f"gloo collectives of a {TP_MOE_SHAPE} step of {arch} at {layers} "
                    f"layers (the model axis's), rank 0, a step")
        for label, (_, arch, layers, *_) in zip((*RECT_TP_SSM, *RECT_TP_CROSS),
                                                TP_SSM + TP_CROSS)}

    # (b), (g), (i) and (j)'s servings, in the (1, 2) world, against one process
    res["serve"] = {}
    for tag, (arch, layers), tol in (("b", ("qwen2-1.5b", None), TP_SERVE_TOL),
                                     ("g", TP_SSM_SERVE, TP_SSM_SERVE_TOL),
                                     *(("ij"[i], sv, TP_CROSS_SERVE_TOL[sv[0]])
                                       for i, sv in enumerate(TP_CROSS_SERVE))):
        ok, res["serve"][arch] = tp_served(torch, tag, served[arch, layers], arch, layers, tol)
        if not ok:
            failures.append(f"({tag}) serving")
        torch.cuda.empty_cache()
    del served
    if mesh is not None:  # phase 21 (b)'s checks of its modes in these worlds
        mesh_train_verdict(mesh, shared)
        PHASE_TIMES.append(("21 (b) in 23's worlds", sum(r["wall"] for r in
                                                        mesh["train"].values())))
        del shared
    # (m) the cache's other layouts served in (a)'s world, against one process
    t0 = time.perf_counter()
    res["cache"] = cache_verdict(torch, cache_outs, failures)
    del cache_outs
    torch.cuda.empty_cache()
    cache_s = time.perf_counter() - t0

    # (c), (e), (h) and (k) the dry run's default mesh
    for tag, key, pair in (("c", "dry", TP_DRY), ("e", "dry_moe", TP_DRY_MOE),
                           ("h", "dry_ssm", TP_DRY_SSM), ("k", "dry_cross", TP_DRY_CROSS)):
        t0 = time.perf_counter()
        res[key] = row = tp_dry(torch, tag, pair, failures)
        routes = row["tp_routes"]
        if tag == "c" and (routes["heads"] or not routes["padded"]):
            failures.append(f"(c) routes {routes}: every layer on the padded route")
        if tag == "e" and (routes["experts"] != TP_DRY_MOE_EXPERTS or not routes["moe"]):
            failures.append(f"(e) routes {routes}: {TP_DRY_MOE_EXPERTS} experts a rank")
        if tag == "h" and (routes["ssm_heads"] != TP_DRY_SSM_HEADS or not routes["ssm"]
                           or not row["launches"]["ssd_chunk"]):
            failures.append(f"(h) routes {routes}, launches {row['launches']}: "
                            f"{TP_DRY_SSM_HEADS} ssm heads a rank, ssd_chunk launched")
        if tag == "k":
            from repro_torch.configs.base import get_config

            heads = cross_heads(get_config(pair[0]), 16)[0]
            log(f"  (k) (query heads, kv heads) of model rank 0 in each attention layer: "
                f"{heads}")
            if (routes["padded"] or not routes["heads"] or not routes["gathered_leaves"]
                    or heads != (TP_DRY_CROSS_HEADS, 1)):
                failures.append(f"(k) routes {routes}, heads {heads}: the heads route, "
                                f"{TP_DRY_CROSS_HEADS} heads a rank, wk and wv gathered")
        ssd_launches += row["launches"]["ssd_chunk"]
        log(f"phase 23 ({tag}): {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
    for tag, key, pair in (("h", "dry_hybrid", TP_DRY_HYBRID), ("k", "dry_audio", TP_DRY_AUDIO)):
        t0 = time.perf_counter()
        res[key] = row = tp_dry_reckon(tag, pair)
        routes = row["tp_routes"]
        if (routes["ssm_heads"] != TP_DRY_SSM_HEADS if tag == "h"
                else routes["padded"] or not routes["heads"]):
            failures.append(f"({tag}) {pair[0]} routes {routes}")
        log(f"phase 23 ({tag}) {pair[0]}: {time.perf_counter() - t0:.1f} s")
    PHASE_TIMES.append(("23 (l) steps with the flag", sp_s))
    # (l) the dry run's (16, 16) share with the flag: yi-34b's, which fits
    # the card only so, run; qwen2.5-32b's reckoned
    t0 = time.perf_counter()
    res["dry_sp"] = row = tp_dry(torch, "l", TP_DRY_SP, failures)
    if not row["tp_routes"]["seq"] or row["tp_routes"]["seq_whole"]:
        failures.append(f"(l) routes {row['tp_routes']}: every sub-block sequence-parallel")
    res["dry_sp_reckon"] = tp_dry_reckon("l", TP_DRY_SP_RECKON)
    PHASE_TIMES.append(("23 (l) dry run", time.perf_counter() - t0))
    log(f"phase 23 (l) dry run: {time.perf_counter() - t0:.1f} s")
    # (m) the (16, 16) decode shares under the cache's other layouts, run;
    # every other long_500k pair reckoned
    t0 = time.perf_counter()
    res["dry_cache"] = {}
    for arch, shape, cache_shard in TP_DRY_CACHE:
        row = tp_dry(torch, "m", (arch, shape, "dense", 8192), failures, cache_shard,
                     by_depth=False)
        res["dry_cache"][arch, shape, cache_shard] = row
        want = steps_layout(arch, shape, cache_shard)
        if row["cache_layout"] != want or (row["coll_breakdown"]["counts"]["client_all_reduce"]
                                           > 0) != (want["slots"] == "data"):
            failures.append(f"(m) {arch} x {shape} layout {row['cache_layout']}, not {want}")
    long_rows = {}
    for arch in long_reckoned():
        row = tp_dry_reckon("m", (arch, "long_500k", "dense", 8192), quiet=True)
        long_rows[arch] = row
        if row["serving_rows"] != 1:
            failures.append(f"(m) {arch} x long_500k serves {row['serving_rows']} rows")
    res["dry_cache_reckoned"] = long_rows
    PHASE_TIMES.append(("23 (m) cache layouts", cache_s + time.perf_counter() - t0))
    log(f"phase 23 (m) cache layouts: {cache_s + time.perf_counter() - t0:.1f} s (served "
        f"{cache_s:.1f} s, with the world's share not counted)")
    res["ssd_chunk"] = ssd_launches
    log(f"phase 23 tensor parallelism: {time.perf_counter() - t_start:.1f} s; ssd_chunk "
        f"launches {ssd_launches} (the ssm worlds' ranks and (h)'s runs)")
    if failures:
        raise RuntimeError("phase 23: " + "; ".join(failures))
    return res


def steps_layout(arch, shape, cache_shard):
    """The layout `steps.cache_layout` gives `arch` x `shape` under
    `cache_shard` at the dry run's (16, 16), as its row records it."""
    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.launch import dryrun, steps

    mesh, _ = dryrun.make_dry_mesh(None)
    layout = steps.cache_layout(get_config(arch), SHAPES[shape], mesh, cache_shard)
    return None if layout is None else layout.describe()


def tp_f32_mode(fault=None):
    """Part (l)'s f32 vlm mode (`TP_SP_F32`, ROADMAP F4) as a `tp_world`
    mode, planted with `fault`."""
    return (TP_SP_F32_LABEL if fault is None else fault, *TP_SP_F32, TP_SP_F32_ARGV, fault)


def sp_verdict(label, outs, v, checks):
    """Part (l)'s checks of the flag's mode `label` beyond `tp_verdict`'s
    (`v`): against its twin's step 1 in the same world (`twin_verdict`),
    and for the f32 vlm (`TP_SP_F32_LABEL`) ROADMAP F4's cross-layer
    bound; logs them; (ok, the readings)."""
    runs = [o[label] for o in outs]
    out = dict(wall_s=max(r["wall_s"] for r in runs), loss_gap=v["loss_gap"])
    ok = True
    twin = label[:-len(" sp")]
    if twin in outs[0]:
        ok, t = twin_verdict(runs, [o[twin] for o in outs], *checks[1:])
        out.update(twin=t)
        leaves = {kind: f"{t['worst'][kind][0]:.3e} at {'/'.join(t['worst'][kind][1])}"
                  for kind in ("weight", "other", "f32") if kind in t["worst"]}
        log(f"  (l) {label} against {twin} (no flag) at step 1: losses' largest relative gap "
            f"{t['loss_gap']:.3e} (tolerance {TP_LOSS_TOL}), the largest gap / largest |value| "
            f"or update {leaves}; {t['seq']} sequence-parallel sub-blocks a step on rank 0, "
            f"every step split {t['split']}; {t['wall_s']:.1f} s with set-up "
            f"{'ok' if ok else 'FAIL'}")
    if label == TP_SP_F32_LABEL:
        rel, path = cross_update_reading(v)
        out.update(f4=rel)
        held = rel <= TP_CROSS_F32_TOL
        ok = ok and held
        log(f"  (l) {label}: ROADMAP F4, the cross layer's step-1 update against one process, "
            f"largest gap / largest update {rel:.3e} at {'/'.join(path or ())} (tolerance "
            f"{TP_CROSS_F32_TOL}) {'ok' if held else 'FAIL'}")
    return ok, out


def tp_dry_reckon(tag, pair, quiet=False):
    """(h)'s, (k)'s, (l)'s or (m)'s second part: the (16, 16) share of
    `pair` reckoned on ``meta`` alone, its row printed (not with `quiet`);
    returns the row."""
    from repro_torch.launch import dryrun

    arch, shape, mix, threshold, chunk, sp = (*pair, 0, False)[:6]
    row = reckoned(tp_key(pair)) or dryrun.lower_pair(
        arch, shape, mix_mode=mix, blocked_threshold=threshold, vocab_chunk=chunk,
        seq_parallel=sp, verbose=False)
    if not quiet:
        log(f"phase 23 ({tag}) reckoned row: {json.dumps(row)}")
    coll = row["coll_breakdown"]
    log(f"  ({tag}) dry run {arch} x {shape} x {row['mesh']} ({mix}, seq_parallel "
        f"{row['seq_parallel']}) reckoned on meta: "
        f"full-depth peak {row['reckoned_peak_bytes'] / 2**30:.3f} GiB, bound "
        f"{row['t_bound_s']:.6f} s, useful_flops_ratio {row['useful_flops_ratio']:.3f}; "
        f"routes {row['tp_routes']}; model-axis bytes {coll['model_all_reduce']} all-reduce, "
        f"{coll['model_all_gather']} all-gather, {coll['model_reduce_scatter']} "
        f"reduce-scatter; client-axis all-reduces {coll['counts']['client_all_reduce']} calls "
        f"{coll['client_all_reduce']} bytes; reckoned in {row['t_compile_s']:.1f} s")
    return row


def cross_reading(v):
    """The largest gap / largest |value| among a verdict's cross-layer
    projections (wq, wk, wv, wo of the ``:cross`` blocks) after step 1,
    over the ranks: (reading, path)."""
    return max(((gap / max(scale, 1e-30), path) for r in v["runs"]
                for path, (gap, scale) in r["steps"][0]["gaps"].items()
                if len(path) > 2 and path[1].endswith(":cross") and path[-1].startswith("w")),
               default=(0.0, None))


def tp_faults(torch):
    """`--tp-faults`: each of `TP_FAULTS` planted in its world, held by
    (a)'s, (d)'s, (f)'s or (i)'s checks, or `TP_F4_FAULT` in (l)'s f32
    vlm with the flag by ROADMAP F4's cross-layer bound alone, and
    `TP_TRAP` beside cross-unreduced (logged, not held); returns the
    faults that passed them."""
    passed = []
    family_modes, checks = tp_family_modes()
    runs = {"a": ("qwen2-1.5b", MESH_LAYERS, None, TP_MODES[0][1],
                  (None, TP_PARAM_TOL, TP_F32_TOL)),
            "d": (TP_MOE_ARCH, TP_MOE_LAYERS, None, TP_MOE_ARGS,
                  ({"experts": TP_MOE_EXPERTS}, TP_MOE_PARAM_TOL, TP_F32_TOL))}
    for tag, (_, arch, *_) in (("f", TP_SSM[0]), ("i", TP_CROSS[0])):
        (_, _, layers, overrides, argv, _), = [m for m in family_modes if m[1] == arch]
        runs[tag] = (arch, layers, overrides, argv, checks[f"{arch} dense"])
    runs["l"] = (*tp_f32_mode()[1:5], checks[f"{TP_SP_F32[0]} dense"])
    faults = TP_FAULTS + ((TP_TRAP, "i"),)
    for tags, layout in (("a", TP_SHAPE), ("dfil", TP_MOE_SHAPE)):
        modes = [(fault, *runs[where][:4], fault) for fault, where in faults if where in tags]
        outs, refs = tp_world(torch, ", ".join(tags), layout, modes)
        for fault, where in faults:
            if where not in tags:
                continue
            ok, v = tp_verdict(torch, [o[fault] for o in outs], refs[fault],
                               "dense" in runs[where][3], *runs[where][4])
            log_verdict(where, f"planted fault {fault}", ok, v, refs[fault])
            if where == "i":
                rel, path = cross_reading(v)
                log(f"  planted fault {fault}: the cross layer's projections' largest gap / "
                    f"largest |value| {rel:.3e} at {'/'.join(path or ())}")
            if where == "l":  # held by F4's bound alone, not the replicated leaves' equality
                rel, path = cross_update_reading(v)
                ok = rel <= TP_CROSS_F32_TOL
                log(f"  planted fault {fault}: ROADMAP F4's reading, the cross layer's largest "
                    f"step-1 gap / largest update {rel:.3e} at {'/'.join(path or ())} (tolerance "
                    f"{TP_CROSS_F32_TOL}; the replicated leaves equal across the ranks "
                    f"{v['equal']}, not read here)")
            if fault == TP_TRAP:
                log(f"  {fault} (gate {mode_gate(fault)}, not held): "
                    f"{'passes' if ok else 'fails'} the checks")
                continue
            log(f"  planted fault {fault}: {'PASSED the checks' if ok else 'rejected'}")
            if ok:
                passed.append(fault)
        del outs
        torch.cuda.empty_cache()
    return passed


def log_tp(r):
    """Phase 23's summary lines."""
    for label, row in r["train"].items():
        base = label[:-len(" sp")] if label.endswith(" sp") else label
        if base.startswith("moe"):
            what = f"{TP_MOE_ARCH} at {TP_MOE_LAYERS} layers on {TP_MOE_SHAPE}, 2"
        elif base in ("dense", "none"):
            what = f"qwen2-1.5b at {MESH_LAYERS} layers on {TP_SHAPE}, 4"
        elif label == TP_SP_F32_LABEL:
            what = f"{TP_SP_F32[0]} at {TP_SP_F32[1]} layers in f32 on {TP_MOE_SHAPE}, 2"
        else:
            (_, arch, layers, *_), = [w for w in TP_SSM + TP_CROSS if base == f"{w[1]} dense"]
            what = f"{arch} at {layers} layers on {TP_MOE_SHAPE}, 2"
        log(f"tensor-parallel trainer path ({label}, {what} gloo ranks on one card): "
            f"{row['s_step']:.4f} s/step, collectives {100 * row['share']:.1f}% of the step, "
            f"peak {row['peak'] / 2**30:.2f} GiB per rank")
    for arch, sv in r["serve"].items():
        log(f"tensor-parallel serving path ({arch} f32 on {TP_SERVE_SHAPE}): decode "
            f"{sv['decode_s'] * 1e3:.2f} ms/step against {sv['one_decode_s'] * 1e3:.2f} in one "
            f"process")
    for key in ("dry", "dry_moe", "dry_ssm", "dry_cross", "dry_sp"):
        row = r[key]
        log(f"tensor-parallel dry run ({row['arch']} x {row['shape']} x {row['mesh']}): "
            f"{row['measured_s_per_step']:.6f} s/step at {row['run_depth']}, bound_fraction "
            f"{row['bound_fraction']:.4f}, full-depth reckoned peak "
            f"{row['reckoned_peak_bytes'] / 2**30:.3f} GiB")
    for key in ("dry_hybrid", "dry_audio", "dry_sp_reckon"):
        row = r[key]
        log(f"tensor-parallel dry run ({row['arch']} x {row['shape']} x {row['mesh']}, "
            f"seq_parallel {row['seq_parallel']}, reckoned): full-depth peak "
            f"{row['reckoned_peak_bytes'] / 2**30:.3f} GiB, useful_flops_ratio "
            f"{row['useful_flops_ratio']:.3f}")
    row = r["dry_sp"]
    log(f"sequence-parallel dry run ({row['arch']} x {row['shape']} x {row['mesh']}, "
        f"seq_parallel {row['seq_parallel']}): {row['measured_s_per_step']:.6f} s/step at "
        f"{row['run_depth']}, measured peak {row['measured_peak_bytes'] / 2**30:.3f} GiB "
        f"(reckoned {row['reckoned_run_peak_bytes'] / 2**30:.3f}), bound_fraction "
        f"{row['bound_fraction']:.4f}, full-depth reckoned peak "
        f"{row['reckoned_peak_bytes'] / 2**30:.3f} GiB")
    for label, c in r["cache"].items():
        log(f"cache layout serving path ({label}, qwen2-1.5b f32 on {TP_SHAPE}): "
            f"{c['ms']:.2f} ms/step against {c['one_ms']:.2f} in one process, a rank's KV "
            f"cache {c['kv']} of {c['one_kv']}, client-axis all-reduces {c['client_calls']} "
            f"calls {c['client_bytes']} bytes in {TP_CACHE_STEPS} steps, logits within "
            f"{c['gap']:.3e}")
    for (arch, shape, cache_shard), row in r["dry_cache"].items():
        coll = row["coll_breakdown"]
        log(f"cache layout dry run ({arch} x {shape} x {row['mesh']}, cache_shard "
            f"{cache_shard}, layout {row['cache_layout']}): {row['measured_s_per_step']:.6f} "
            f"s/step at {row['run_depth']}, bound_fraction {row['bound_fraction']:.4f}, "
            f"{row['host_syncs']} host syncs, client-axis all-reduces "
            f"{coll['counts']['client_all_reduce']} calls {coll['client_all_reduce']} bytes, "
            f"full-depth reckoned peak {row['reckoned_peak_bytes'] / 2**30:.3f} GiB")
    for arch, row in r["dry_cache_reckoned"].items():
        coll = row["coll_breakdown"]
        log(f"cache layout dry run ({arch} x long_500k x {row['mesh']}, reckoned): layout "
            f"{row['cache_layout']}, full-depth peak {row['reckoned_peak_bytes'] / 2**30:.3f} "
            f"GiB, client-axis all-reduces {coll['counts']['client_all_reduce']} calls "
            f"{coll['client_all_reduce']} bytes")
    for label, sp in r["sp"].items():
        twin = sp.get("twin")
        log(f"sequence-parallel trainer step ({label}): losses within {sp['loss_gap']:.3e} of "
            f"one process" + (f", {twin['loss_gap']:.3e} of the step without the flag"
                              if twin else "")
            + (f"; F4's cross-layer reading {sp['f4']:.3e}" if "f4" in sp else "")
            + f"; {sp['wall_s']:.1f} s with set-up")


def main(argv=None) -> int:
    try:
        return run_phases(argv)
    finally:
        stop_reckons()


def run_phases(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ssd-variants", nargs="?", const="", metavar="NAMES",
                        help="only time variants of ssd_chunk.cu (comma-separated; "
                             "default: repro_torch.kernels.ssd.variants.DEFAULT)")
    parser.add_argument("--flush", default="zero", help="for --ssd-variants and "
                        "--gossip-variants: zero, read, none; comma-separated")
    parser.add_argument("--gossip-variants", nargs="?", const="", metavar="NAMES",
                        help="only time variants of drain.cu, enqueue.cu and mix.cu (comma-"
                             "separated; default: repro_torch.kernels.gossip.variants."
                             "DEFAULT, and baseline with --baseline)")
    parser.add_argument("--baseline", metavar="TREE", help="for --gossip-variants: a tree "
                        "whose drain.cu, enqueue.cu and mix.cu are the baseline variant")
    parser.add_argument("--gossip-kernels", default="drain,enqueue,mix",
                        help="for --gossip-variants: which of drain, enqueue, mix")
    parser.add_argument("--trainer-controls", action="store_true",
                        help="only phase 8, with the control and planted-fault paths")
    parser.add_argument("--families", action="store_true",
                        help="only phases 15-18, the other model families' trainers")
    parser.add_argument("--entry-points", action="store_true",
                        help="only phase 19, the benches, the legacy engine and the examples")
    parser.add_argument("--serving", action="store_true",
                        help="only phase 20, serving and long context")
    parser.add_argument("--mesh", action="store_true",
                        help="only phase 21, the client mesh (and phase 2's and 9's "
                             "rectangular drain)")
    parser.add_argument("--dryrun", action="store_true",
                        help="only phase 22, the dry run's pairs reckoned and run (and "
                             "phase 2's rectangular drain and ssd_chunk, which hold the "
                             "kernels at its shapes)")
    parser.add_argument("--tp", action="store_true",
                        help="only phase 23, tensor parallelism over \"model\" (and phase 2's "
                             "and 9's rectangular drain and phase 2's ssd_chunk)")
    parser.add_argument("--tp-faults", action="store_true",
                        help="only phase 23 (a)'s, (d)'s, (f)'s and (i)'s checks against planted "
                             "faults (TP_FAULTS), after the rest of phase 23 with --tp; exits 1 "
                             "when one passes them")
    parser.add_argument("--hybrid-depths", metavar="LAYERS",
                        help="only phase 16's comparison at these zamba2 depths "
                             "(comma-separated multiples of 6), leaf by leaf; exits 1 "
                             "when the rule fails at any")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (TF32 off)

    if args.ssd_variants is not None:
        from repro_torch.kernels.ssd import variants

        ssd_variants(torch, args.ssd_variants.split(",") if args.ssd_variants
                     else variants.DEFAULT, args.flush.split(","))
        log(card_line())
        return 0
    if args.gossip_variants is not None:
        from repro_torch.kernels.gossip import variants

        names = (args.gossip_variants.split(",") if args.gossip_variants
                 else variants.DEFAULT + (["baseline"] if args.baseline else []))
        gossip_variants(torch, names, args.baseline, args.flush.split(","),
                        args.gossip_kernels.split(","))
        log(card_line())
        return 0
    if args.trainer_controls:
        phase_build()
        phase_mamba2_plain(torch, controls=True)
        log(card_line())
        return 0
    if args.families:
        phase_build()
        log_families(phase_families(torch))
        log(card_line())
        return 0
    if args.entry_points:
        t_start = time.perf_counter()
        phase_build()
        phase_entry_points(torch)
        log(f"chip_smoke --entry-points: {time.perf_counter() - t_start:.1f} s")
        log(card_line())
        return 0
    if args.serving:
        t_start = time.perf_counter()
        phase_build()
        log_serving(phase_serving(torch))
        log(f"chip_smoke --serving: {time.perf_counter() - t_start:.1f} s")
        log(card_line())
        return 0
    if args.mesh and args.tp:  # phase 21, then phase 23 in worlds shared with 21 (b)
        t_start = time.perf_counter()
        start_reckons(tp_dry_keys())
        phase_build()
        phase_rect_kernels(torch)
        phase_ssd_kernels(torch)
        mesh = timed("21 mesh", phase_mesh, torch, True)
        tp = timed("23 tensor parallelism", phase_tp, torch, mesh)
        phase_rect_times(torch, rect_time_cases(mesh, tp))
        log_mesh(mesh)
        log_tp(tp)
        log("phase times: " + ", ".join(f"{label} {s:.1f} s" for label, s in PHASE_TIMES))
        log(f"chip_smoke --mesh --tp: {time.perf_counter() - t_start:.1f} s")
        log(card_line())
        return 0
    if args.mesh:
        t_start = time.perf_counter()
        phase_build()
        phase_rect_kernels(torch)
        mesh = phase_mesh(torch)
        phase_rect_times(torch, rect_time_cases(mesh=mesh))
        log_mesh(mesh)
        log(f"chip_smoke --mesh: {time.perf_counter() - t_start:.1f} s")
        log(card_line())
        return 0
    if args.dryrun:
        t_start = time.perf_counter()
        start_reckons([dry_key(*pair) for pair in DRY_PAIRS])
        phase_build()
        phase_rect_kernels(torch)
        phase_ssd_kernels(torch)
        phase_dryrun(torch)
        log(f"chip_smoke --dryrun: {time.perf_counter() - t_start:.1f} s")
        log(card_line())
        return 0
    if args.tp:
        t_start = time.perf_counter()
        start_reckons(tp_dry_keys())
        phase_build()
        phase_rect_kernels(torch)
        phase_ssd_kernels(torch)
        tp = phase_tp(torch)
        phase_rect_times(torch, rect_time_cases(tp=tp))
        log_tp(tp)
        passed = tp_faults(torch) if args.tp_faults else []
        log(f"chip_smoke --tp: {time.perf_counter() - t_start:.1f} s; planted faults that "
            f"passed the checks: {passed or 'none'}")
        log(card_line())
        return 1 if passed else 0
    if args.tp_faults:
        phase_build()
        passed = tp_faults(torch)
        log(f"chip_smoke --tp-faults: passed the checks: {passed or 'none'}")
        log(card_line())
        return 1 if passed else 0
    if args.hybrid_depths:
        phase_build()
        failed = hybrid_depths(torch, [int(x) for x in args.hybrid_depths.split(",")])
        log(card_line())
        return 1 if failed else 0
    t_start = time.perf_counter()
    timed("1 build", phase_build)
    max_err = timed("2 drain", phase_kernels, torch)
    seed_err = timed("2 drain seed axis", phase_seed_kernels, torch)
    rect_err = timed("2 drain rectangular", phase_rect_kernels, torch)
    mix_err = timed("2 mix", phase_mix_kernels, torch)
    ssd_err = timed("2 ssd_chunk", phase_ssd_kernels, torch)
    enq_launches, enq_err = timed("2 enqueue", phase_enqueue, torch)
    launches, ms_window, steady, ctx, params0, data = timed("3 main", phase_main, torch)
    timed("4 plain", phase_plain, torch, ctx, params0, data)
    del ctx, params0, data
    mix_launches, s_step, peak = timed("5 trainer", phase_trainer, torch)
    dflat, steady_s, busy_us, mix_us = timed("6 trainer plain", phase_trainer_plain, torch)
    m_launches, m_step, m_peak = timed("7 mamba2", phase_mamba2, torch)
    m_dflat, m_steady, m_busy, m_kernels = timed("8 mamba2 plain", phase_mamba2_plain, torch)
    torch.cuda.empty_cache()
    timed("10 wide window", phase_wide_window, torch)
    baseline_runs, baseline_launches = timed("11 baselines", phase_baselines, torch)
    scen_drain, scen_mix, scen_rows = timed("12 scenarios", phase_scenarios, torch)
    sweep = timed("13 sweep", phase_sweep, torch)
    events = timed("14 events", phase_events, torch)
    families = timed("15-18 families", phase_families, torch)
    torch.cuda.empty_cache()
    entry = timed("19 entry points", phase_entry_points, torch)
    torch.cuda.empty_cache()
    serving = timed("20 serving", phase_serving, torch)
    torch.cuda.empty_cache()
    start_reckons([dry_key(*pair) for pair in DRY_PAIRS] + tp_dry_keys())
    mesh = timed("21 mesh", phase_mesh, torch, True)  # (b) in phase 23's worlds
    torch.cuda.empty_cache()
    dry = timed("22 dry run", phase_dryrun, torch)
    torch.cuda.empty_cache()
    tp = timed("23 tensor parallelism", phase_tp, torch, mesh)
    times = timed("9 drain, mix, enqueue, ssd_chunk times", phase_times, torch)
    mix_times, mix_err_train = timed("9 mix times", phase_mix_times, torch, dflat)
    ssd_times, enq_times = timed("9 ssd_chunk and enqueue times", phase_new_times, torch)
    timed("9 wide times", phase_wide_times, torch)
    timed("9 seed times", phase_seed_times, torch)
    timed("9 rectangular times", phase_rect_times, torch, rect_time_cases(mesh, tp))
    timed("9 family mix times", family_mix_times, torch)
    log("phase 9 times: done")
    kernels = [
        dict(name="gossip_drain", route="cuda",
             source="src/repro_torch/kernels/gossip/csrc/drain.cu",
             replaces="src/repro/kernels/gossip/gossip.py:100",
             launches=(launches + scen_drain + sweep["launches"] + events["launches"]
                       + entry["launches"]["drain"] + mesh["launches"] + dry["drain"]
                       + tp["launches"]),
             max_abs_err=max(max_err, seed_err, rect_err), **times["f32", 3]),
        dict(name="gossip_mix", route="cuda",
             source="src/repro_torch/kernels/gossip/csrc/mix.cu",
             replaces="src/repro/kernels/gossip/gossip.py:33",
             launches=(mix_launches + m_launches["mix"] + baseline_launches + scen_mix
                       + sum(r["launches"]["mix"] for r in families.values())
                       + entry["launches"]["mix"] + serving["launches"]["mix"]
                       + mesh["mix_launches"]),
             max_abs_err=max(mix_err, mix_err_train),
             **mix_times),
        dict(name="gossip_enqueue", route="cuda",
             source="src/repro_torch/kernels/gossip/csrc/enqueue.cu",
             replaces="src/repro/kernels/gossip/gossip.py:62",
             launches=enq_launches, max_abs_err=enq_err, **enq_times),
        dict(name="ssd_chunk", route="cuda",
             source="src/repro_torch/kernels/ssd/csrc/ssd_chunk.cu",
             replaces="src/repro/kernels/ssd/ssd.py:47",
             launches=(m_launches["ssd_chunk"]
                       + sum(r["launches"]["ssd_chunk"] for r in families.values())
                       + entry["launches"]["ssd_chunk"] + serving["launches"]["ssd_chunk"]
                       + dry["ssd_chunk"] + tp["ssd_chunk"]),
             max_abs_err=ssd_err, **ssd_times)]
    log(f"windowed path: {ms_window:.3f} ms/window (300-window simulate, evals "
        f"included), {steady:.3f} ms/window steady")
    log(f"trainer path (qwen2-1.5b): {s_step:.4f} s/step over {TRAIN_STEPS} steps with "
        f"init, {steady_s:.4f} s/step steady; device busy {busy_us / 1e3:.3f} ms/step, "
        f"mix {mix_us / 1e3:.3f} ms/step; peak {peak / 2**30:.2f} GiB")
    log(f"trainer path (mamba2-2.7b, {MAMBA_LAYERS} of 64 layers, Dflat {m_dflat}): "
        f"{m_step:.4f} s/step over {MAMBA_STEPS} steps with init, {m_steady:.4f} s/step "
        f"steady; device busy {m_busy / 1e3:.3f} ms/step, ssd_chunk "
        f"{m_kernels['ssd_chunk'] / 1e3:.3f} ms/step, mix {m_kernels['mix'] / 1e3:.3f} "
        f"ms/step; peak {m_peak / 2**30:.2f} GiB")
    log_families(families)
    for method, r in baseline_runs.items():
        idle = "not measured" if r["idle"] is None else f"{100 * r['idle']:.2f}% idle"
        log(f"baseline path ({method}, fig3 EMNIST): {r['rounds']} rounds, final accuracy "
            f"{r['accuracy']:.4f}, {r['steady_ms']:.3f} ms/round steady, {idle}")
    for r in scen_rows:
        idle = "not measured" if r["idle"] is None else f"{100 * r['idle']:.2f}% idle"
        unit = "window" if "launches" in r else "round"
        log(f"scenario path ({r['label']}): {r['ms']:.3f} ms/{unit} steady, {idle}, final "
            f"metric {r['metric']:.4f}")
    idle = {k: "not measured" if v is None else f"{100 * v:.2f}% idle"
            for k, v in (("batched", sweep["idle"]), ("solo", sweep["solo_idle"]),
                         ("event", events["idle"]))}
    log(f"sweep path (fig4 Psi grid, {SWEEP_SEEDS} seeds): {sweep['ms']:.3f} ms per batched "
        f"window steady ({idle['batched']}) against {sweep['solo_ms']:.3f} ms per solo window "
        f"({idle['solo']}); {sweep['wall_ms']:.3f} ms per batched window with the evals")
    log(f"event path (fig3 EMNIST, {EVENT_HORIZON:.0f} s tape): {events['ms']:.3f} ms/event "
        f"steady ({idle['event']}); " + ", ".join(
            f"{k} {v['ms']:.3f} ms/event, accuracy {v['acc']:.4f}, {v['sent']} broadcasts"
            for k, v in events["runs"].items()))
    log(f"entry points (phase 19): legacy engine {entry['ms_legacy']:.3f} ms/window against "
        f"the fused window {entry['ms_fused']:.3f} ms/window (N = 25, D = {ENTRY_DEPTH}, "
        f"{ENTRY_WINDOWS} windows, max |d params| {entry['gap']:.3e})")
    log_serving(serving)
    log_mesh(mesh)
    log_tp(tp)
    log(f"drain launches: {launches} on the windowed path, {scen_drain} on the scenario "
        f"paths, {sweep['launches']} on the sweep's, {events['launches']} on the event "
        f"engine's, {entry['launches']['drain']} on the entry points', {mesh['launches']} on "
        f"the client mesh's (its ranks' sum and phase 21 (d)'s unsharded runs), {dry['drain']} on the dry run's dense train "
        f"pair (phase 22), {tp['launches']} on the tensor-parallel trainer's (phase 23, its "
        f"ranks' sum)")
    log(f"mix launches: {mix_launches} on the qwen2 trainer's path, {m_launches['mix']} on "
        f"mamba2's, {baseline_launches} on the baselines', {scen_mix} on the scenario "
        f"baselines', " + ", ".join(f"{r['launches']['mix']} on {r['cfg'].name}'s"
                                    for r in families.values())
        + f", {entry['launches']['mix']} on the entry points', "
        f"{serving['launches']['mix']} on the long-context trainer's, "
        f"{mesh['mix_launches']} on the unsharded baselines beside the client mesh's (phase 21 "
        f"(d); none on the mesh)")
    log(f"ssd_chunk launches: {m_launches['ssd_chunk']} on mamba2's trainer path, "
        + ", ".join(f"{r['launches']['ssd_chunk']} on {r['cfg'].name}'s"
                    for r in families.values() if r["launches"]["ssd_chunk"])
        + f", {entry['launches']['ssd_chunk']} on the entry points', "
        f"{serving['launches']['ssd_chunk']} on the f32 prefills of phase 20 (b), "
        f"{dry['ssd_chunk']} on the dry run's mamba2 pairs (phase 22), {tp['ssd_chunk']} on "
        f"the tensor-parallel ssm paths (phase 23 (f)-(h), the ranks' sum)")
    log("phase times: " + ", ".join(f"{label} {s:.1f} s" for label, s in PHASE_TIMES))
    log(f"profiler: {PROFILER['sessions']} sessions, {PROFILER['s']:.1f} s of set-up, tear-down "
        f"and tables")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    log(card_line())
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
