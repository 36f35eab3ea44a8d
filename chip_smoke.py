#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device: the card's name and power limit (``nvidia-smi``), the CUDA
   version, and TF32 switched off for float32 products (TF32 in the
   prolongation or the coarse inverse moves T by ~1e-3 relative, enough to
   flip a feasibility decision);
2. build: ``nvcc`` compiles every kernel source from the repository (one
   process each, started together) and ``-Xptxas -v`` reports registers,
   shared memory and spills; ``cuobjdump -sass`` counts each kernel's
   tensor-core (IMMA, HMMA) and dp4a instructions, and the int8 kernels
   must run on IMMA with no dp4a left;
3. stencil vs plain: every grid the main path gives the thermal-stencil
   kernel and both launch shapes (resident and global), both sweep kinds and
   batch sizes 1 and 86, compared with the plain PyTorch version on the same
   inputs on the card (tolerance 0: bit for bit), and timed with CUDA events
   at the main path's shapes beside the bound (bytes over the memory rate or
   float operations over the float32 rate, whichever is larger);
3b. fused solve vs plain: the one-launch multigrid solve
   (``thermal_mg.thermal_mg_solve``) on every grid of the paths (92x92 and
   56x56 and 69x69 at theta_JA 12, 152x152 at 2) at B = 1 and 86, cold and
   warm, a mixed batch and a stop at ``max_cycles``, held to its plain
   version (tolerance 0: T and the cycle counts), and timed per solve
   (CUDA events) and on the card alone (a CUDA graph of 20 calls) beside
   the bound (bytes of b, diag, T0 and T over the memory rate, or the float
   operations of the cycles actually run over the float32 rate, whichever
   is larger), the parent's form (the per-step composition with the
   stencil kernel, one stop-test read per cycle) and the plain version;
4. main path (Algorithm 1) at full size through the entry points a user
   calls: Table II on mkDelayWorker32B and mcml (152x152), the 86-ambient
   dynamic LUT as one batched solve, Algorithm 2 on mkPktMerge, and one
   256x256 solve (too large for one CTA: the per-step form with the
   stencil kernel as smoother); each is held against the port on the CPU
   and the reference values (the LUT: all 86 entries against the
   reference's table, 6 of them, one batch, against the CPU port; the
   256x256 solve against the plain version on the card, bit for bit); per
   run it prints the solves, fused launches
   per solve, stencil launches, thermal host syncs per solve, the fixed
   point's host syncs and the wall, and every multigrid solve at a path
   grid must be one fused launch with no thermal host sync;
5. over-scaling path (§III-D, Fig 8): ``overscaling.sweep`` of the LeNet and
   HD netlists over six budgets (one batched solve each) on the card, held
   against the CPU port and the reference decisions, GOLDEN_OS (the same
   counts as path 4, one fused launch and no thermal host sync per sweep
   solve); LeNet
   trained on the card (500 steps), then its int8 inference at n = 1024
   through the error-injecting kernel for every budget, its logits equal bit
   for bit to the plain path's; HD's accuracies beside them;
6. §V path: ``AbftMatmul`` at llama3.2-1b's MLP widths (2048 -> 8192 ->
   2048) for 48 and 4096 tokens at eight rails at 65 C, its ledgers through
   the kernel equal to those through the plain version, and the guard-band
   rails injecting nothing;
7. int8 kernels vs plain: both error-injecting kernels on every shape of
   paths 5 and 6, three edges (1x1x1, 65x33x127, and 16x8192x64, K split
   128 ways) and five bit profiles, plus two products whose accumulators
   wrap, one of them past 2^31 and back (tolerance 0: int32 equality),
   timed per call and on the card alone (the profiler) beside the bound
   and, where it accepts the shape, ``torch._int_mm`` (the product alone),
   each with the tile and split the host's plan picked;
8. attention kernels vs plain: the paged-attention kernel on split-K
   decode rows (8 rows over 128 permuted pages, one row at pos = -1,
   window 0 and 48) and on three chunk forms of the serve path (the first
   8 x 256 chunk at positions 0-255, the 8 x 256 extend at 256 i, a
   speculative 4-row chunk per slot), at the mixtral path's shapes (32/8
   heads of 128, window 4096: 8 decode rows on wrapped 4096-entry rings
   after their write, and 8 x 256 chunks over [256 ring pages | 16
   scratch pages] before their ring-scatter: the first wrap, a padded
   tail, an empty ring, a decode row mid-page, an idle slot), and the
   flash-attention kernel at
   B = 4, H = 32 / 8 kv heads, S = T in {128, 1000, 2048}, causal and not,
   and at the multimodal paths' non-causal shapes (S in {1, 64, 256}
   against T = 1601 with 32 / 8 heads of 128, the vlm's cross steps, and
   against T = 1500 with 12 / 12 heads of 64, whisper's; whisper's encoder,
   1500 x 1500), those bit for bit and also timed on the card alone (a
   CUDA graph of 20 calls), all
   held to their plain versions (1e-5 in float32, 5e-2 in bfloat16) and,
   in bfloat16, both set beside a float64 softmax attention over the same
   inputs, and the speculative chunk equal bit for bit to the decode of its
   rows; timed beside the bound, the plain version and one library call
   (``F.scaled_dot_product_attention``, timed only, never used);
9. scan kernel vs plain: the Mamba2 SSD-scan kernel (two launches a
   call: C B^T once per (b, group, chunk), then the scan) at the reference
   test's shapes and at both recurrent models' prefill shapes (mamba2: 48
   heads of 64, state 128; zamba2: 64 heads of 64, state 64; chunk 256,
   S = 256 and 512 at B = 1 and 4, and at B = 1 every other prompt length
   of path 11), and with more than one B/C group at the models' widths
   (mamba2 G = 4 and 48 at B = 2, S = 512; zamba2 G = 2 at B = 2, S =
   256), float32 and bfloat16, held to its plain version (tolerance 0: bit
   for bit, y and the final state) and in float32 to the reference-form
   ``ssd_chunked`` (2e-4, the reference's kernel-vs-oracle bound), timed
   (``scan_timing``, which ``tools/scan_ab.py`` runs on other trees)
   beside the bound (C B^T once per group at the peak of the inputs'
   type, the products with a float32 operand at the float32 rate) and the
   plain version;
10. serve path: ``Engine`` on llama3.2-1b at full width with random weights
   from a seed. The float32 gate: the paged engine (the paged-attention
   kernel, launched ticks x 16 layers times) serves 8 prompts plus one
   submitted after 10 ticks, token for token equal to the contiguous engine
   (plain ``_sdpa``), or a printed near-tie (top-2 margin under 1e-4) at
   the first differing token; ``speculate=3`` on the two repeating prompts
   gives the same streams. Then the same traffic in bfloat16 with its
   times, launches, peak memory and agreement with the contiguous engine
   (reported), ``speculate=3`` in bfloat16 against a greedy run of the
   same two prompts (every stream equal) and against the full traffic's
   streams (reported), the row probe (one verify tick whose drafts are
   greedy's next 3 tokens against the 4 decode ticks it stands for, layer
   by layer: with the chunk's products taken whole, the reading, and a
   column at a time as shipped, logits bit for bit), each product and norm
   reduction of a layer whole against a column at a time (reported), one
   decode tick through the kernel and through the plain
   version from the same cache (|d logits| <= 0.06 and top-1 agreement >
   0.95), and the prefill step (B = 4, S = 2048, every position's logits)
   through the flash kernel against the plain version under the same gate;
   one warm all-decode tick and one prefill-chunk tick of the bf16 engine
   and one warm prefill step profiled (the paged and flash kernels' shares
   of device time);
10b. control loop: the serving control plane (the TPU-fleet substrate,
   the RailField, the planner, the runtime, the controller, the actuators,
   thermal-aware admission) governing llama3.2-1b at full width through
   ``scenarios.serve_replay`` (8 slots, max_len 2048, pages of 16, prefill
   chunk 256; ``serve_day(14, 42 C hot, 12 C from tick 7)``; a burst of 12
   384-token prompts with 32 new tokens each and a Poisson tail). The
   card's RailField (4 x 4 knots x 256 chips) equals the CPU port's (rails
   exactly, p_nom within 1e-3), with the admission price's margin against
   ``defer_premium`` per marginal slot at the day's ambients; every
   replay's cap trace and counts equal a CPU replay of the same kind at
   reduced width (a differing cap prints its margins; the CPU replays, and
   phase 10c's CPU drill, run in a spawned process of their own from the
   start of the script, ``CpuOracles``, off the card's critical path).
   float32: thermal-aware
   admission against the throughput-only baseline (streams held as in
   path 10, deferrals, higher tokens/J), the paged engine against the
   contiguous one, a hotspot on chip 0 at ticks 9 and 10 whose preempted
   requests resume to the undisturbed streams, paged launches == (model
   steps + 2 warm-up steps) x 16 layers; bf16 thermal-aware and
   throughput-only runs (streams compared, reported). Each replay prints
   its wall, ticks, tokens/s, energy ledger, launches and peak memory,
   and ``loop.step``'s mean wall and host syncs (``set_sync_debug_mode``);
10c. fault, monitor and fleet tier: ``scenarios.replay`` of three named
   days at the default knots (8 x 4) on the card and on the CPU port --
   ``diurnal_load_spike``, ``chaos_day`` (the §9 chaos plane: sensor storm,
   NACK burst, watchdog) and ``sdc_storm`` (an ErrorTolerant controller
   with a seeded ``FaultInjector``) -- each card replay's rails, util trace,
   shares and decisions equal the CPU port's (the SDC counts: injected
   within 1e-5, escaped within 5 sigma of its binomial draw, as fields an
   ulp apart move the draws); ``fleet_replay(pod_loss_day(16),
   n_pods=2)``, its health events and state trace equal the CPU port's,
   one quarantine and one restore; then the pod-loss serving drill,
   ``fleet_serve_replay`` with two paged llama3.2-1b engines at full width
   over one host page pool (phase 10b's engine settings; 12 requests, 2 a
   tick over ticks 1-6, the serve path's prompt lengths in turn, 32 new
   tokens, 2 engine steps a tick): float32 migrates requests, loses none,
   and serves the no-failure day's streams (held as in path 10), its cap
   trace and counts equal a CPU drill at reduced width, paged launches ==
   (model steps + 2 warm-up steps x 2 engines) x 16 layers; bf16 reported.
   Each run prints its wall and ``loop.step`` / ``FleetLoop.step`` wall
   and host syncs per tick (fast path and replan ticks apart);
10d. mixtral serve path: ``Engine`` on mixtral-8x7b at full width (d_model
   4096, 32/8 heads of 128, 8 experts top-2 of 14336, window 4096, vocab
   32000) with random weights from a seed, the depth cut (one layer is
   1.4513 B parameters, the 32 layers 93.4 GB in bf16): 16 layers in bf16,
   the deepest that fits with headroom, and 4 in float32, for the gate's
   time. 8 slots, max_len 6144, pages of 16,
   prefill chunk 256, 32 new tokens; two prompts of 4352 and 5000 tokens
   (their 4096-entry rings wrap), the serve path's prompts, one late. First
   the reduced mixtral (a 32-entry ring, chunks of 12) in a paged engine on
   the card and on the CPU port: each step's routes equal and logits
   within 1e-4, steps past the wrap included. The float32 gate: the paged
   engine (the kernel with the window bound; a chunk passes through each
   slot's scratch pages; launched model steps x 4 layers times) serves the
   contiguous engine's streams (the ring form of ``_sdpa``): both run one
   schedule, their routes are compared step by step, the first routes that
   differ (while the steps' tokens are equal) must be router near-ties
   (k-th and (k + 1)-th probabilities within 1e-6), and a stream may
   first differ only at or after the step the runs part, or at a row whose
   top-2 logit margin is under 1e-4 (printed). Then bf16 with its times,
   launches, peak memory, agreement with the contiguous engine and the
   share of routes dropped by capacity at decode and extend steps
   (reported); one warm 256-row extend step past the wrap and one warm
   decode step profiled (the experts' products, the dispatch scatter and
   gather, the paged kernel as shares of device time);
10e. deepseek serve path: ``Engine`` on deepseek-v2-236b at full width
   (d_model 5120, 128 MLA heads, q_lora 1536, kv_lora 512, 160 experts
   top-6 of 1536 plus 2 shared, vocab 102400) with random weights from a
   seed, the depth cut (an MoE layer is ~3.97 B parameters): 1 dense + 5
   MoE layers in bf16, 1 + 1 in float32. MLA's prefill and absorbed decode
   run in plain PyTorch (no kernel takes its heads; the reference computes
   it outside any Pallas kernel), its compressed rows in the contiguous
   cache or in the page pool. The reduced model in a paged engine on the
   card and on the CPU port (routes equal, logits within 1e-4 step by
   step); the float32 gate: the serve path's traffic and settings, paged
   against contiguous, routes compared step by step as in 10d; bf16 with
   its times, peak memory and routes dropped by capacity;
   ``speculate=3`` on the two repeating prompts against greedy: with a
   capacity that drops nothing, every stream equal, and the row probe
   (as in phase 10) at that capacity: the verify rows' logits equal their
   decode rows' bit for bit; at the config's capacity a stream departs
   only after the capacity dropped routes of that request's own real
   tokens (the reference's engine departs there too: a verify chunk's
   rows share the capacity); an extend and a decode step profiled;
10f. multimodal paths: llama-3.2-vision-11b (gated cross blocks over
   1601 image tokens) and whisper-small (encoder layers over 1500 frames)
   at full width with random weights from a seed, the bf16 runs at half
   depth (``MM_BF16_DEPTH``: 20 self + 4 cross blocks; 6 encoder + 6
   decoder layers), served through ``serve/step``: 4 requests of 37 to
   256 tokens with 0.1 N(0, 1) embeddings, a prefill step each, then 32
   greedy decode steps of all four. The reduced model's logits on the card
   equal the CPU port's (1e-4); the float32 gate (depth cut: 5 + 1 and
   1 + 1 layers, 8 decode steps): the streams through the kernels equal
   those under
   ``plain_kernels()`` or part at a top-2 margin under 1e-4, flash
   launches counted; bf16: flash launches per prefill (24, 18) and per
   decode step (4, 6), times, peak memory, a decode step profiled, and
   each prefill's logits within 0.06 of the plain path with top-1 above
   0.95;
10g. the §V study: the reference's ``accuracy_vs_rail`` on llama3.2-1b at
   full width (16 layers, bf16), 2 x 24 tokens, its MLP products through
   ``AbftMatmul`` inside ``tolerance.routed_matmuls`` at the study's rails
   (nominal, 0.730 V down to 0.700 V, 65 C): 48 ABFT launches a forward,
   per rail the overshoot, the ledger, top-1 agreement with the clean
   forward and the wall; the plain version gives equal ledgers and logits
   bit for bit, guard-band rails inject nothing;
11. recurrent serve path: the stateful ``Engine`` on mamba2-780m (8 slots,
   max_len 1024, prompts of 37 to 256 tokens and one of 512, one more
   after 4 ticks, 32 new tokens each) and zamba2-1.2b (4 slots, four
   prompts and one late, 16 new tokens) at full width with random weights
   from a seed. The float32 gate, at half depth (``REC_F32_LAYERS``: 24
   of mamba2's 48 layers, 20 of zamba2's 38): the engine through the
   kernels (the scan kernel launched layers x prefills times; zamba2's
   flash kernel groups x prefills times) serves the same greedy streams
   as the same engine under
   ``plain_kernels()``, or a printed near-tie (top-2 margin under 1e-4) at
   the first differing token. Then bf16 with its times, launches and peak
   memory, and a ``preempt_to`` mid-run whose resumed streams equal the
   uninterrupted bf16 run's; one bf16 mamba2 decode tick and one 512-token
   prefill profiled;
11b. training (``repro_torch.train``): the flash Function at llama's
   causal B 4, S 4096 (32/8 heads of 64), the vlm's cross step (S 256, T
   1601, 32/8 of 128) and whisper's encoder (1500 x 1500, 12/12 of 64),
   bf16 and float32: its forward (the kernel) equal to the plain version
   bit for bit, its dq, dk, dv (the plain backward) against float64
   autograd (``GRAD_TOL``), each backward timed;
   the scan Function against autograd through its plain version at a
   mamba2 shape; the gradient gate: llama3.2-1b at full width with 2
   layers, float32, B 1, S 2048, every leaf's gradient through the
   kernels against the same step through ``_sdpa`` and every leaf's norm
   above 0; the full-width run: llama3.2-1b, 2 of its 16 layers (the
   sharded bf16 run of 13c 8), bf16 over float32
   masters, remat, AdamW (warmup 5), 6 steps of global batch 8 as 2
   microbatches of 4 at 4096 tokens, per step loss, grad norm, wall,
   tokens/s, peak memory and flash launches (gated: 16), the losses finite
   and falling, the last step profiled; an async checkpoint after step 3
   (its write overlapping the next steps), restored after the run (no
   second sha256 pass) by a fresh model and optimizer on the card equal
   to a host copy of the
   saved state bit for bit, whose first resumed step's loss equals the
   uninterrupted run's bit for bit (later steps reported); then the CLI
   (``launch.train.main``) at full width for 3 short steps with
   ``--energy-policy power_save`` and a checkpoint directory (its
   interval past the run: the run's ~6 GB save and restore stand for
   it),
   flash launches gated (3 steps x 16 layers x 2);
12. expandable serving (``Engine(expandable=True)``, capacity 64 at the
   start, doubling to max_len): phase 10's traffic at llama3.2-1b full
   width, float32, contiguous and paged, every stream equal to phase 10's
   float32 stream of the same cache kind (gated), paged launches == ticks
   x 16 layers on block tables that widen between ticks, grows, capacity,
   pages in use and peak pages, tokens/s beside phase 10's; bf16 paged
   beside phase 10's bf16 paged streams (reported), timed in turns with
   the fixed-size engine on the same traffic (fixed, expandable,
   expandable, fixed);
13. SPMD on one card: (a) ``sharding.pipeline.pipeline_apply`` over a
   2-rank gloo group on cuda:0 (llama3.2-1b at full width in bf16, the 16
   blocks split 8 + 8, B 8, S 1024, 4 microbatches, activations through
   pinned host memory), its output equal bit for bit to the same blocks
   run in one process over the same microbatches, flash launches gated
   (16 x 4 across both ranks), wall and each rank's idle share beside the
   bubble bound (P-1)/(M+P-1), the whole-batch run reported on the
   logits; (b) ``ft.elastic.rescale`` of llama3.2-1b at full width with 2
   layers from a checkpoint the phase writes, under a world-1 gloo group
   on the card: every leaf a DTensor equal bit for bit to the saved
   tensor; (a), (c), (d) and (e) run in one 4-rank gloo world on cuda:0,
   spawned once ((a) on ranks 0 and 1 of it); (c) the train step across
   ranks (``train/step.py``'s
   sharded step) over a ``{data 2, model 2}`` mesh,
   llama3.2-1b at full width, each rank's flash kernel on its 16 query and
   4 kv heads; float32 at 2 layers, global B 4, S 1024, 2 microbatches,
   ``hoist_gather`` off and on: the loss and every leaf's gathered
   gradient against the one-process step on the card through the same
   kernels (``TRAIN_GATE_TOL``), flash launches gated (ranks x layers x 2
   (remat) x microbatches), each rank's bytes of parameter and optimizer
   shards equal to the dry run's ``argument_bytes_per_device`` less the
   batch and the step; bf16 over float32 masters at 8 layers with
   ``hoist_gather``, 2 steps: step wall, tokens/s, each rank's peak memory
   and flash launches; the
   dry run (``launch/dryrun.run_cell``) of llama3.2-1b's cells on both
   production meshes, each ok; (d) the sharded step of the moe, ssm and
   hybrid families: one 4-rank gloo world on cuda:0, float32 at full width
   and cut depth, B 4, S 1024, 2 microbatches, the FSDP gather hoisted
   (``hoist_gather``, as the CLI runs it): mamba2-780m (2 layers) and
   zamba2-1.2b (one hybrid group of 6 mamba layers and the shared block,
   then 1 tail layer) over ``{data 2, model 2}`` (the scan kernel on 24 of
   48 and 32 of 64 heads a rank, zamba2's flash kernel on 16 of 32), and
   mixtral-8x7b (1 MoE layer, 1.71 B parameters, ``ep``: 2 experts a rank)
   over ``{data 1, model 4}``, where one data rank dispatches the whole
   microbatch, so the one-process step is its oracle. Each config's loss and
   every leaf's gathered gradient against the one-process step on the card
   through the same kernels (``TRAIN_GATE_TOL``; for mamba2 and zamba2
   plus ``FAM_FLOOR_FACTOR`` times their float32 floor, the one-process
   step's own distance when every master moves one ulp, leaf by leaf, as a
   Mamba2 chunk's decay exponent amplifies rounding), scan and flash launches
   gated (ranks x layers or groups x 2 (remat) x microbatches), rank 0's
   scan calls (y and the final state) and flash calls held bit for bit
   against the plain versions, each rank's peak memory and the one-process
   step's printed; the gradients are gathered to rank 0's host alone
   (``rank0_leaves``). deepseek-v2-236b's sharded step is held on the CPU
   only (one MoE layer at full width does not fit one card beside its
   gathered copies); (e) the sharded step of the vlm and audio families,
   float32 at full width, hoisted, the cross gates opened (``MM_GATE``):
   llama-3.2-vision-11b cut to one group (5 self-attention blocks and the
   gated cross block over 1601 image tokens, 2.36 B parameters) over
   ``{data 2, model 2}`` at B 4, S 1024; whisper-small whole (12 encoder
   layers over 1500 frames, 12 decoder layers) at B 8 over ``{data 2,
   model 2}`` and ``{pod 2, data 2, model 1}``. Each run's loss and every
   leaf's gradient against the one-process step on the card
   (``TRAIN_GATE_TOL``), flash launches gated (ranks x blocks x 2 (remat)
   x microbatches), rank 0's calls held bit for bit against the plain
   version (vlm's self and cross calls, whisper's encoder, decoder and
   cross calls of the first microbatch's forward); then whisper's sharded
   state saved across ranks (rank 0 writes), the next step taken, the
   state restored with ``shardings`` on every rank and that step taken
   again: its loss and every leaf bit for bit the uninterrupted run's;
   (f) sequence parallelism (``make_plan(..., sequence_parallel=True)``:
   the residual stream split along the sequence over the model axis), in
   the same world: 13c's float32 gate (llama3.2-1b, 2 layers, ``{data 2,
   model 2}``), 13d's three configs and 13e's whisper-small on ``{data 2,
   model 2}`` each taken again from the same weights and batch with the
   flag, hoisted, every leaf's gradient held against the same run's
   without it on the ranks' shards (no gather: the placements are the
   same), within 13c's gate and, for mamba2 and zamba2, 13d's; the loss
   too; flash and scan launches equal to the run's without the flag;
   rank 0's flash and scan calls held bit for bit against the plain
   versions; then 13c's bf16 run continues one step with the flag: step
   wall, tokens/s, each rank's peak memory beside the run without it;
14. profile: one warm Table II run, one warm 86-ambient LUT and one warm
   LeNet inference at gamma = 1.35 under ``torch.profiler``: device time
   by kernel, the card's busy time and idle share of the wall time (the
   serve profiles run in phases 10 and 11).

Each path runs with every launch count set to 0 just before it and read
just after. The last lines are the kernel table as one JSON object, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the card's published peaks (H100 SXM data sheet) for the bound
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12  # float32 outside the tensor cores
BF16_FLOP_PER_S = 989e12  # bf16 tensor cores, dense
INT8_OP_PER_S = 1979e12  # int8 tensor cores, dense
# float operations per cell and sweep: 3 adds of neighbours, P + g_v_tamb,
# one product, one add, one division
STENCIL_FLOPS_PER_CELL = 7
# reference decisions (the JAX package on the CPU)
TABLE_II = {"iters": 4, "v_core": 0.75, "v_bram": 0.83, "power_mw": 554.60}
MCML = {"iters": 3, "v_core": 0.75, "v_bram": 0.70, "power_mw": 1753.45}
# the 86-ambient LUT (dynamic_lut of mkDelayWorker32B at 0..85 C, theta_JA
# 12, act 1.0; the JAX package on the CPU) as its change points: from each
# ambient on, (v_core, v_bram) until the next
LUT_86 = [(0, 0.70, 0.83), (11, 0.70, 0.84), (14, 0.71, 0.82),
          (16, 0.71, 0.83), (29, 0.71, 0.84), (30, 0.72, 0.82),
          (31, 0.72, 0.83), (41, 0.73, 0.82), (42, 0.73, 0.83),
          (49, 0.74, 0.82), (51, 0.74, 0.83), (56, 0.75, 0.82),
          (58, 0.75, 0.83), (61, 0.76, 0.82), (64, 0.76, 0.83),
          (65, 0.77, 0.82), (68, 0.78, 0.82), (71, 0.79, 0.82),
          (72, 0.80, 0.81), (73, 0.80, 0.82), (74, 0.80, 0.95)]
# the ambients at which the CPU port recomputes the LUT (one batch of 6:
# the whole 86 take 93-127 s of the host's CPU)
LUT_CPU_AMBS = [float(t) for t in range(0, 86, 17)]
GOLDEN_EO = {"v_core": 0.55, "v_bram": 0.55, "d_opt_ns": 17.019848,
             "energy": 27.992240, "saving": 0.640888,
             "freq_ratio": 0.367218}  # energy_opt.run(mkPktMerge, 65C, theta 2)
# (m, n, B) of the smoother's calls on the main path and on the
# over-scaling path (the LeNet and HD netlists, 56x56 and 69x69, and their
# coarse levels; B = 6 budgets in the sweep, 1 in the baseline)
MAIN_PATH_SHAPES = [(92, 92, 1), (46, 46, 1), (23, 23, 1), (152, 152, 1),
                    (76, 76, 1), (38, 38, 1), (92, 92, 86), (46, 46, 86),
                    (23, 23, 86), (56, 56, 6), (28, 28, 6), (69, 69, 6),
                    (35, 35, 6), (56, 56, 1), (69, 69, 1)]
# --- the over-scaling path (§III-D, Fig 8) ---------------------------------
GAMMAS = [1.0, 1.1, 1.2, 1.3, 1.35, 1.4]
# reference decisions, overscaling.sweep at 40 C, theta_JA 12 (the JAX
# package on the CPU): gamma -> (v_core, v_bram, power mW, frac_violating)
FIG8 = {
    "lenet": {1.0: (0.73, 0.71, 419.3254, 0.0),
              1.2: (0.66, 0.70, 316.2118, 0.5664),
              1.35: (0.63, 0.55, 275.0631, 0.8438)},
    "hd": {1.0: (0.72, 0.70, 456.4909, 0.0),
           1.2: (0.65, 0.70, 335.3452, 0.6289),
           1.35: (0.63, 0.55, 303.9151, 0.8633)},
}
GOLDEN_OS = {"v_core": 0.66, "v_bram": 0.70, "power_mw": 39.173454,
             "frac_violating": 0.542969}  # overscaling.run(raygentop, 1.2)
APP_SEED = 42
LENET_STEPS = 500  # examples/overscaling_study.py without --quick
LENET_N = 1024  # lenet_accuracy's evaluation set
# --- the §V path: llama3.2-1b's MLP widths (configs/llama3_2_1b.py) --------
D_MODEL, D_FF = 2048, 8192
TOKENS = [48, 4096]  # 2 x 24 tokens (the study), and a 4096-token batch
SEC5_T = 65.0  # chip temperature of the study's rail sweep
DEV = "cuda"
# (M, K, N) of the error-injecting kernels' calls on the two paths
LENET_MM = [(262144, 9, 8), (65536, 72, 16), (1024, 256, 10)]
LLAMA_MM = [(M, k, n) for M in TOKENS
            for k, n in ((D_MODEL, D_FF), (D_FF, D_MODEL))]
# the fused multigrid solve: (m, n, theta_JA) of the paths' grids
MG_GRIDS = [(92, 92, 12.0), (152, 152, 2.0), (56, 56, 12.0), (69, 69, 12.0)]
MG_BATCHES = (1, 86)  # Table II and mcml; the 86-ambient LUT
LARGE_GRID = 256  # a die whose hierarchy does not fit one CTA
# shapes held bit for bit against the plain version at B = 1 and 86: every
# grid of the main path, plus the edges (1x1, odd, the global shape)
STENCIL_SHAPES = [(1, 1), (23, 17), (256, 256)] + sorted(
    {(m, n) for m, n, _ in MAIN_PATH_SHAPES})


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def device_phase(torch) -> str:
    card = smi_line()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"tf32 before: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is off")
    return card


KERNEL_SOURCES = ("thermal_stencil", "int8_error_matmul", "paged_attention",
                  "flash_attention", "mamba_scan")


SASS_OPS = ("IMMA", "IDP.4A", "HMMA")  # tensor-core int8, dp4a, bf16


def sass_counts(lib) -> dict:
    """{kernel: {op: count}} of the tensor-core and dot-product
    instructions in a built library (``cuobjdump -sass``)."""
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    counts = {}
    for block in out.split("Function :")[1:]:
        fn, _, body = block.partition("\n")
        counts[fn.strip()] = {op: body.count(f" {op}") for op in SASS_OPS}
    return counts


def build_phase() -> dict:
    from repro_torch.kernels import _build
    t0 = time.time()
    libs = _build.build_all(KERNEL_SOURCES)
    print(f"build: {', '.join(KERNEL_SOURCES)} in {time.time() - t0:.1f} s")
    for name in KERNEL_SOURCES:
        for line in _build.build_log(name).splitlines():
            if "ptxas info" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    return libs


def sass_phase(libs) -> dict:
    """The tensor-core instructions of every built kernel; the int8 kernels
    must run on IMMA with no dp4a left."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        sass = dict(zip(KERNEL_SOURCES, pool.map(
            sass_counts, (libs[name] for name in KERNEL_SOURCES))))
    for name, fns in sass.items():
        for fn, ops in fns.items():
            if any(ops.values()):
                print(f"  sass {name}: {fn[:70]} {ops}")
    mm = sass["int8_error_matmul"].values()
    check(sum(c["IMMA"] for c in mm) > 0 and not any(c["IDP.4A"] for c in mm),
          "the int8 kernels run on IMMA, with no IDP.4A left")
    return sass


def _wrappers():
    from repro_torch.kernels import abft_matmul as AB
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import mamba_scan as MS
    from repro_torch.kernels import overscale_matmul as OM
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import thermal_mg as MG
    from repro_torch.kernels import thermal_stencil as TS
    return {"thermal_stencil": TS.thermal_stencil,
            "thermal_mg_solve": MG.thermal_mg_solve,
            "overscale_matmul": OM.overscale_matmul,
            "abft_matmul": AB.abft_matmul,
            "paged_attention": PA.paged_attention,
            "flash_attention": FA.flash_attention,
            "mamba_scan": MS.mamba_scan}


def reset_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def _stencil_inputs(torch, m, n, B, seed=11):
    from repro_torch.core import thermal
    g_v, g_lat = thermal.conductances(m, n, thermal.ThermalConfig(theta_ja=12.0))
    rng = np.random.default_rng(seed)
    T = torch.tensor(rng.uniform(25, 40, (B, m, n)), dtype=torch.float32,
                     device="cuda")
    P = torch.tensor(rng.uniform(0, 5e-3, (B, m, n)), dtype=torch.float32,
                     device="cuda")
    diag = torch.tensor(thermal._diag_np(np.full((m, n), g_v), g_lat),
                        dtype=torch.float32, device="cuda")
    return T, P, diag, g_lat, g_v * 25.0


def _events_ms(torch, fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _time_ms(torch, fn, reps: int = 0) -> float:
    """Mean time of one call over ``reps`` back-to-back calls after warm-up,
    with CUDA events; ``reps=0`` picks enough calls for ~100 ms (3 to 200)."""
    for _ in range(5 if reps else 2):
        fn()
    torch.cuda.synchronize()
    if not reps:
        one = max(_events_ms(torch, fn, 1), 1e-3)
        reps = int(min(max(100.0 / one, 3), 200))
    return _events_ms(torch, fn, reps)


def _graph_ms(torch, fn, calls: int = 20) -> float:
    """Time per call on the card alone: ``calls`` calls captured in one CUDA
    graph (after warm-up), the graph replayed 3 times, CUDA events; the
    host's launch overhead is left out."""
    side = torch.cuda.Stream()  # warm-up off the default stream, as
    side.wait_stream(torch.cuda.current_stream())  # capture asks
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _events_ms(torch, graph.replay, 3) / calls


def _timed_call(torch, fn):
    """-> (fn's output, the one call's time in ms, CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def _time_once_ms(torch, fn) -> float:
    """One call after one warm-up, with CUDA events: for the plain
    versions that repeat a kernel's arithmetic one operation at a time and
    take up to seconds a call."""
    fn()
    torch.cuda.synchronize()
    return _events_ms(torch, fn, 1)


def stencil_bound(T, P, diag, iters: int):
    """(ms, "bytes" | "operations"): the least time for one call on these
    inputs. Each input is read once and T written once; an input shared
    across the batch (P or diag of shape (m, n)) is read once."""
    B, m, n = T.shape
    per_grid = lambda x: B if x.dim() == 3 and x.shape[0] == B else 1
    nbytes = 4 * m * n * (2 * B + per_grid(P) + per_grid(diag))
    flops = STENCIL_FLOPS_PER_CELL * m * n * B * iters
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(torch) -> dict:
    from repro_torch.kernels import thermal_stencil as TS
    worst = 0.0
    for (m, n) in STENCIL_SHAPES:
        for B in (1, 86):
            T, P, diag, g_lat, g_vt = _stencil_inputs(torch, m, n, B)
            for phase in (None, 0, 1):
                for iters in (1, 31):
                    kw = dict(g_lat=g_lat, g_v_tamb=g_vt, iters=iters,
                              phase=phase)
                    out = TS.thermal_stencil(T, P, diag, **kw)
                    ref = TS.thermal_stencil_ref(T, P, diag, g_lat, g_vt,
                                                 iters, phase)
                    torch.cuda.synchronize()
                    err = float((out - ref).abs().max())
                    worst = max(worst, err)
                    shape = ("resident" if TS.is_resident(m, n, phase, T.device)
                             else "global")
                    print(f"stencil {m}x{n} B={B} phase={phase} iters={iters}"
                          f" {shape}: max|kernel-plain|={err:.3e}")
    # tolerance 0: the kernel rounds every operation as the plain version
    check(worst == 0.0, f"stencil kernel equals plain bit for bit "
                        f"(max {worst})")

    rows = []
    for (m, n, B) in MAIN_PATH_SHAPES:
        T, P, diag, g_lat, _ = _stencil_inputs(torch, m, n, B)
        kw = dict(g_lat=g_lat, g_v_tamb=0.0, iters=1, phase=0)
        k_ms = _time_ms(torch, lambda: TS.thermal_stencil(T, P, diag, **kw),
                        200)
        p_ms = _time_ms(torch, lambda: TS.thermal_stencil_ref(
            T, P, diag, g_lat, 0.0, 1, 0), 200)
        bound, by = stencil_bound(T, P, diag, 1)
        rows.append({"m": m, "n": n, "B": B, "iters": 1, "phase": 0,
                     "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                     "bound_by": by})
        print(f"time {m}x{n} B={B} rb iters=1: kernel {k_ms:.5f} ms, plain "
              f"{p_ms:.5f} ms, bound {bound:.7f} ms ({by})")
    print("library: no single PyTorch call computes K fused stencil sweeps; "
          "library_ms is null")
    return {"max_abs_err": worst, "rows": rows}


def thermal_timing(torch, reps: int = 5) -> dict:
    """Warm walls of the main path's multigrid runs (Table II, mcml, the
    86-ambient LUT) through whichever ``repro_torch`` is first on the path:
    one warm-up, then the median of ``reps`` runs (host clock around work
    that ends in a synchronise), each run's thermal solves, stencil and
    fused launches and thermal host syncs, and one warm Table II run under
    the profiler (wall, busy, idle share). ``tools/thermal_ab.py`` runs it
    on several checkouts in turns."""
    import importlib.util
    from repro_torch.core import thermal
    from repro_torch.core import voltage_scaling as VS
    from repro_torch.core import vtr_benchmarks as vb
    from repro_torch.kernels import thermal_stencil as TS
    fused = (importlib.import_module("repro_torch.kernels.thermal_mg")
             .thermal_mg_solve
             if importlib.util.find_spec("repro_torch.kernels.thermal_mg")
             else None)
    mkdelay, mcml = vb.load("mkDelayWorker32B"), vb.load("mcml")
    tc12, tc2 = (thermal.ThermalConfig(theta_ja=t) for t in (12.0, 2.0))
    runs = {
        "table2": lambda: VS.run(mkdelay, 60.0, 1.0, tc12, device="cuda"),
        "mcml": lambda: VS.run(mcml, 60.0, 1.0, tc2, device="cuda"),
        "lut86": lambda: VS.dynamic_lut(mkdelay, [float(t) for t in
                                                  range(86)], 1.0, tc12,
                                        device="cuda"),
    }
    counters = lambda: (thermal.solve.calls, thermal.solve.host_syncs,
                        TS.thermal_stencil.launches,
                        fused.launches if fused else 0)
    out = {}
    for name, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        c0, walls = counters(), []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        d = [(b - a) / reps for a, b in zip(c0, counters())]
        out[name] = {"wall_ms": float(np.median(walls)), "walls_ms": walls,
                     "solves": d[0], "thermal_host_syncs": d[1],
                     "stencil_launches": d[2], "fused_launches": d[3]}
    prof = _profile(torch, "table2", runs["table2"])
    out["table2_profile"] = {"wall_ms": prof["wall_ms"],
                             "busy_ms": prof["busy_ms"],
                             "idle": 1 - prof["busy_ms"] / prof["wall_ms"]}
    return out


def _mg_problem(torch, m, n, theta, B, seed=4):
    """(b, plan, kwargs) as ``thermal.solve`` builds them, from random power
    maps (the middle one zero) and ambients."""
    from repro_torch.core import thermal
    tc = thermal.ThermalConfig(theta_ja=theta)
    g_v, g_lat = thermal.conductances(m, n, tc)
    plan = thermal._plan_on(m, n, g_v, g_lat, tc.coarse_cells,
                            torch.device("cuda"))
    rng = np.random.default_rng(seed)
    P = rng.uniform(0.0, 5.0, (B, m, n))
    P[B // 2] = 0.0
    t_amb = rng.uniform(0.0, 85.0, (B, 1, 1))
    b = torch.tensor(P * 1e-3 + g_v * t_amb, dtype=torch.float32,
                     device="cuda")
    kw = dict(tol=tc.tol, max_cycles=tc.max_cycles, n_smooth=tc.n_smooth)
    return b, plan, kw


def mg_flops(dims, n_smooth: int, cycles, cold: bool) -> int:
    """Float operations of one fused solve: per element, the cold start (if
    any), the V-cycles it ran and one scaled residual per cycle plus the
    first. Per cell: a sweep 7 (STENCIL_FLOPS_PER_CELL), a residual 7, a
    prolongation 9 (+1 when added), a scaled residual 8; per coarse cell a
    restriction 3; the direct tier 2 N^2."""
    cells = [m * n for m, n in dims]
    top = len(dims) - 1
    coarse = 2 * cells[top] ** 2

    def vcycle(lvl):
        return coarse + sum(2 * n_smooth * STENCIL_FLOPS_PER_CELL * cells[l]
                            + 7 * cells[l] + 3 * cells[l + 1]
                            + 10 * cells[l] for l in range(lvl, top))

    fmg = (sum(3 * c for c in cells[1:]) + coarse
           + sum(9 * cells[l] + vcycle(l) for l in range(top)))
    return sum((fmg if cold else 0) + c * vcycle(0) + (c + 1) * 8 * cells[0]
               for c in cycles)


def mg_bound(b, T0, plan, cycles, n_smooth: int):
    """(ms, "bytes" | "operations"): read b, the diagonal and T0 once and
    write T once; the operations of the cycles these inputs ran."""
    m, n = plan.dims[0]
    nbytes = 4 * (2 * b.numel() + m * n + (0 if T0 is None else T0.numel()))
    flops = mg_flops(plan.dims, n_smooth, cycles, T0 is None)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def mg_kernel_phase(torch) -> dict:
    """The fused multigrid solve against its plain version (tolerance 0, T
    and cycle counts) on every path grid at B = 1 and 86, cold and warm, a
    mixed batch and a stop at max_cycles; timed beside its bound, the
    parent's per-step form and the plain version."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import thermal_mg as MG
    worst, cyc_ok, rows = 0.0, True, []

    def held(label, b, T0, plan, kw):
        nonlocal worst, cyc_ok
        T, cycles = MG.thermal_mg_solve(b, T0, plan, **kw)
        ref, ref_cycles = MG.thermal_mg_solve_ref(b, T0, plan, **kw)
        torch.cuda.synchronize()
        err = float((T - ref).abs().max())
        same = torch.equal(cycles, ref_cycles)
        worst, cyc_ok = max(worst, err), cyc_ok and same
        c = cycles.tolist()
        print(f"fused solve {label}: max|kernel-plain|={err:.3e}, cycles "
              f"equal {same} (min {min(c)}, max {max(c)}, sum {sum(c)})")
        return c

    for m, n, theta in MG_GRIDS:
        for B in MG_BATCHES:
            for warm in (False, True):
                b, plan, kw = _mg_problem(torch, m, n, theta, B)
                T0 = (torch.full_like(b, 40.0) + b * 1e3) if warm else None
                label = (f"{m}x{n} theta={theta} B={B} "
                         f"{'warm' if warm else 'cold'}")
                cycles = held(label, b, T0, plan, kw)
                fused = lambda: MG.thermal_mg_solve(b, T0, plan, **kw)
                smooth = lambda T, b_l, diag: ops.thermal_sweep(
                    T, b_l, diag, g_lat=plan.g_lat, g_v_tamb=0.0,
                    iters=kw["n_smooth"], phase=0)
                k_ms = _time_ms(torch, fused)
                alone = _graph_ms(torch, fused)
                parent = _time_ms(torch, lambda: MG.thermal_mg_solve_ref(
                    b, T0, plan, smooth=smooth, **kw))
                plain = _time_once_ms(torch, lambda: MG.thermal_mg_solve_ref(
                    b, T0, plan, **kw))
                bound, by = mg_bound(b, T0, plan, cycles, kw["n_smooth"])
                rows.append({"m": m, "n": n, "B": B, "warm": warm,
                             "theta_ja": theta, "cycles_max": max(cycles),
                             "cycles_sum": sum(cycles), "ms": k_ms,
                             "alone_ms": alone, "parent_ms": parent,
                             "plain_ms": plain, "bound_ms": bound,
                             "bound_by": by, "library_ms": None})
                print(f"time fused solve {label}: {k_ms:.5f} ms per solve, "
                      f"alone {alone:.5f} ms; parent's per-step form "
                      f"{parent:.5f} ms; plain {plain:.5f} ms; bound "
                      f"{bound:.7f} ms ({by})")
    # a converged field (0 cycles), a start far from the solution and a
    # zero map; then tol 0 with a budget of 2 cycles
    b, plan, kw = _mg_problem(torch, 56, 56, 12.0, 3)
    done, _ = MG.thermal_mg_solve_ref(b[:1], None, plan, **kw)
    T0 = torch.cat([done, torch.full((2, 56, 56), 60.0, device="cuda")])
    mixed = held("56x56 mixed batch", b, T0, plan, kw)
    budget = held("56x56 max_cycles=2 tol=0", b, T0, plan,
                  dict(kw, max_cycles=2, tol=0.0))
    check(mixed[0] == 0 and budget[1:] == [2, 2],
          f"the converged field runs 0 cycles ({mixed}) and the budget "
          f"stops the far starts at 2 ({budget})")
    check(worst == 0.0 and cyc_ok, f"fused solve equals plain bit for bit "
                                   f"(max {worst}, cycles equal {cyc_ok})")
    print("library: no single PyTorch call computes a multigrid solve; "
          "library_ms is null")
    return {"max_abs_err": worst, "rows": rows}


def _trace(r):
    return [(t.v_core, t.v_bram, t.power_mw) for t in r.trace]


def _same_trace(a, b) -> bool:
    return (len(a) == len(b)
            and all(abs(x[0] - y[0]) < 1e-6 and abs(x[1] - y[1]) < 1e-6
                    and abs(x[2] / y[2] - 1.0) <= 1e-3 for x, y in zip(a, b)))


def _final_ok(r, ref) -> bool:
    return (len(r.trace) == ref["iters"]
            and abs(r.v_core - ref["v_core"]) < 1e-3
            and abs(r.v_bram - ref["v_bram"]) < 1e-3
            and abs(r.power_mw / ref["power_mw"] - 1.0) <= 1e-3)


def _thermal_counts(pol, thermal) -> dict:
    """The counters a path's run is read by: thermal solves, kernel
    launches, stop-test reads of the thermal solve and of the fixed
    point, and solves that took the per-step form."""
    from repro_torch.kernels import thermal_mg as MG
    from repro_torch.kernels import thermal_stencil as TS
    return {"solves": thermal.solve.calls,
            "fused": MG.thermal_mg_solve.launches,
            "stencil": TS.thermal_stencil.launches,
            "thermal_syncs": thermal.solve.host_syncs,
            "composed": thermal.solve.composed,
            "fixed_point_syncs": sum(s.host_syncs for s in
                                     pol.solver._SOLVER_CACHE.values())}


def _run_stats(before: dict, after: dict, wall: float) -> dict:
    d = {k: after[k] - before[k] for k in after}
    solves = max(d["solves"], 1)
    return {"wall_s": wall, "thermal_solves": d["solves"],
            "fused_launches": d["fused"],
            "fused_launches_per_solve": d["fused"] / solves,
            "stencil_launches": d["stencil"],
            "thermal_host_syncs_per_solve": d["thermal_syncs"] / solves,
            "composed_solves": d["composed"],
            "fixed_point_host_syncs": d["fixed_point_syncs"]}


def lut_86() -> dict:
    """``LUT_86`` as ``dynamic_lut`` returns it: {t_amb: (v_core, v_bram)},
    the rails as float32 values."""
    f32 = lambda v: float(np.float32(v))
    out = {}
    for (t0, vc, vb), nxt in zip(LUT_86, LUT_86[1:] + [(86,)]):
        for t in range(t0, nxt[0]):
            out[float(t)] = (f32(vc), f32(vb))
    return out


def main_path_phase(torch) -> dict:
    from repro_torch import policy as pol
    from repro_torch.core import energy_opt as EO
    from repro_torch.core import thermal
    from repro_torch.core import voltage_scaling as VS
    from repro_torch.core import vtr_benchmarks as vb

    TC12 = thermal.ThermalConfig(theta_ja=12.0)
    TC2 = thermal.ThermalConfig(theta_ja=2.0)
    mkdelay, mcml, mkpkt = (vb.load(n) for n in
                            ("mkDelayWorker32B", "mcml", "mkPktMerge"))
    t_ambs = [float(t) for t in range(86)]
    big = np.random.default_rng(5).uniform(0.0, 1.0, (LARGE_GRID ** 2,))
    runs = {
        "table2_mkDelayWorker32B": lambda dev: VS.run(
            mkdelay, 60.0, 1.0, TC12, device=dev),
        "mcml_152x152": lambda dev: VS.run(mcml, 60.0, 1.0, TC2, device=dev),
        "dynamic_lut_86": lambda dev: VS.dynamic_lut(
            mkdelay, t_ambs, 1.0, TC12, device=dev),
        "energy_opt_mkPktMerge": lambda dev: EO.run(
            mkpkt, 65.0, 1.0, TC2, device=dev),
        f"solve_{LARGE_GRID}x{LARGE_GRID}": lambda dev: thermal.solve(
            big, LARGE_GRID, LARGE_GRID, 25.0, TC2, device=dev),
    }

    # the counts are set to 0 just before the main path and read just after
    reset_counts()
    thermal.solve.calls = thermal.solve.host_syncs = 0
    thermal.solve.composed = 0
    stats, gpu = {}, {}
    for name, fn in runs.items():
        before = _thermal_counts(pol, thermal)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        gpu[name] = fn("cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats[name] = dict(_run_stats(before, _thermal_counts(pol, thermal),
                                      wall),
                           max_memory_allocated_bytes=(
                               torch.cuda.max_memory_allocated()))
        print(f"main path {name}: {json.dumps(stats[name])}")
    counts = read_counts()
    print(f"main path: launches {counts}")
    check(counts["thermal_mg_solve"] > 0,
          "the main path launched the fused solve kernel")
    for name in ("table2_mkDelayWorker32B", "mcml_152x152",
                 "dynamic_lut_86"):
        st = stats[name]
        check(st["fused_launches"] == st["thermal_solves"] > 0
              and st["stencil_launches"] == 0
              and st["thermal_host_syncs_per_solve"] == 0,
              f"{name}: one fused launch and no thermal host sync per "
              f"solve ({st})")
    st = stats["energy_opt_mkPktMerge"]
    check(st["fused_launches"] == st["stencil_launches"] == 0
          and st["thermal_host_syncs_per_solve"] == 0,
          f"Algorithm 2 on 8x8 is the direct tier ({st})")
    st = stats[f"solve_{LARGE_GRID}x{LARGE_GRID}"]
    check(st["composed_solves"] == 1 and st["fused_launches"] == 0
          and st["stencil_launches"] > 0,
          f"{LARGE_GRID}x{LARGE_GRID} takes the per-step form with the "
          f"stencil kernel ({st})")

    # the same runs on the CPU port (plain stencil) as the yardstick; the
    # large grid against the plain version on the card
    large = gpu.pop(f"solve_{LARGE_GRID}x{LARGE_GRID}")
    plain = thermal.solve(big, LARGE_GRID, LARGE_GRID, 25.0,
                          thermal.ThermalConfig(theta_ja=2.0, backend="torch"),
                          device="cuda")
    check(torch.equal(large, plain), f"{LARGE_GRID}x{LARGE_GRID}: stencil "
                                     "kernel form == plain, bit for bit")
    t0 = time.perf_counter()
    cpu = {name: runs[name]("cpu") for name in gpu
           if name != "dynamic_lut_86"}
    cpu["dynamic_lut_86"] = VS.dynamic_lut(mkdelay, LUT_CPU_AMBS, 1.0, TC12,
                                           device="cpu")
    print(f"cpu port: the four runs (the LUT at {len(LUT_CPU_AMBS)} "
          f"ambients) in {time.perf_counter() - t0:.1f} s")

    for name in ("table2_mkDelayWorker32B", "mcml_152x152"):
        g, c = gpu[name], cpu[name]
        print(f"{name} trace (v_core, v_bram, mW, Tj): "
              + str([(t.v_core, t.v_bram, round(t.power_mw, 4),
                      round(t.t_junct, 4)) for t in g.trace]))
        check(_same_trace(_trace(g), _trace(c)), f"{name}: card == cpu port")
    check(_final_ok(gpu["table2_mkDelayWorker32B"], TABLE_II),
          "Table II: 4 iterations -> (0.75, 0.83), 554.60 mW")
    check(_final_ok(gpu["mcml_152x152"], MCML),
          "mcml: 3 iterations -> (0.75, 0.70), 1753.45 mW")
    lut_g, lut_c = gpu["dynamic_lut_86"], cpu["dynamic_lut_86"]
    check(len(lut_g) == 86 and lut_g == lut_86(),
          "86-ambient LUT: card == the reference's table")
    check(all(lut_g[t] == lut_c[t] for t in LUT_CPU_AMBS),
          f"86-ambient LUT: card == cpu port at {LUT_CPU_AMBS}")
    print(f"dynamic LUT (every 17 C): {list(lut_g.items())[::17]}")
    eo = gpu["energy_opt_mkPktMerge"]
    check(abs(eo.v_core - GOLDEN_EO["v_core"]) < 1e-3
          and abs(eo.v_bram - GOLDEN_EO["v_bram"]) < 1e-3
          and all(abs(getattr(eo, k) / GOLDEN_EO[k] - 1.0) <= 1e-3
                  for k in ("d_opt_ns", "energy", "freq_ratio"))
          and abs(eo.saving - GOLDEN_EO["saving"]) < 1e-3,
          f"energy_opt == GOLDEN_EO ({eo})")
    print(f"energy_opt mkPktMerge: ({eo.v_core}, {eo.v_bram}) d_opt "
          f"{eo.d_opt_ns:.6f} ns energy {eo.energy:.6f} saving "
          f"{eo.saving:.6f}")
    return {"counts": counts, "runs": stats}


def _same_decision(got, want_vc, want_vb, want_mw, want_frac) -> bool:
    return (abs(got.v_core - want_vc) < 1e-3
            and abs(got.v_bram - want_vb) < 1e-3
            and abs(got.power_mw / want_mw - 1.0) <= 1e-3
            and abs(got.frac_violating - want_frac) <= 1 / 256)


def overscaling_path(torch) -> dict:
    """§III-D at full size through the entry points: the Fig-8 sweep of the
    LeNet and HD netlists (one batched solve each), GOLDEN_OS, LeNet trained
    on the card and run through the error-injecting int8 kernel for every
    budget, HD beside it. Counts are read just after; the checks against
    the plain path, the CPU port and the reference values follow."""
    from repro_torch import policy as pol
    from repro_torch.core import apps
    from repro_torch.core import netlist as NL
    from repro_torch.core import overscaling as OS
    from repro_torch.core import thermal
    from repro_torch.core import vtr_benchmarks as vb

    tc = thermal.ThermalConfig(theta_ja=12.0)
    nets = {"lenet": NL.generate(apps.LENET_STATS),
            "hd": NL.generate(apps.HD_STATS)}
    reset_counts()
    thermal.solve.calls = thermal.solve.host_syncs = 0
    thermal.solve.composed = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sweeps, stats = {}, {}
    for k, nl in nets.items():
        before = _thermal_counts(pol, thermal)
        t1 = time.perf_counter()
        sweeps[k] = OS.sweep(nl, GAMMAS, t_amb=40.0, tc=tc, device=DEV)
        torch.cuda.synchronize()
        stats[k] = _run_stats(before, _thermal_counts(pol, thermal),
                              time.perf_counter() - t1)
        print(f"over-scaling sweep {k}: {json.dumps(stats[k])}")
        check(stats[k]["fused_launches"] == stats[k]["thermal_solves"] > 0
              and stats[k]["stencil_launches"] == 0
              and stats[k]["thermal_host_syncs_per_solve"] == 0,
              f"{k} sweep: one fused launch and no thermal host sync per "
              f"solve ({stats[k]})")
    before = _thermal_counts(pol, thermal)
    t1 = time.perf_counter()
    golden = OS.run(vb.load("raygentop"), 1.2, t_amb=40.0, tc=tc,
                    device=DEV)
    torch.cuda.synchronize()
    stats["golden_os_raygentop"] = _run_stats(
        before, _thermal_counts(pol, thermal), time.perf_counter() - t1)
    print(f"over-scaling GOLDEN_OS (raygentop 21x21, the direct tier): "
          f"{json.dumps(stats['golden_os_raygentop'])}")
    t_sweep = time.perf_counter() - t0
    p, info = apps.lenet_train(APP_SEED, steps=LENET_STEPS, device=DEV)
    hd = apps.hd_train(APP_SEED, device=DEV)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0 - t_sweep
    acc_float = apps.lenet_accuracy(p, APP_SEED, n=LENET_N, device=DEV)
    acc_int8 = apps.lenet_accuracy(p, APP_SEED, n=LENET_N,
                                   bit_probs=np.zeros(32), device=DEV)
    hd_clean = apps.hd_accuracy(hd, APP_SEED, device=DEV)
    rows, logits = [], {}
    for r_l, r_h in zip(sweeps["lenet"], sweeps["hd"]):
        probs = apps.scale_bit_probs(r_l.bit_probs)
        lg, y = apps.lenet_logits(p, APP_SEED, LENET_N, probs,
                                  device=DEV)
        logits[r_l.gamma] = lg
        rows.append({
            "gamma": r_l.gamma,
            "lenet": (r_l.v_core, r_l.v_bram, r_l.power_mw, r_l.saving,
                      r_l.frac_violating),
            "lenet_acc": float((lg.argmax(-1) == y).float().mean()),
            "hd": (r_h.v_core, r_h.v_bram, r_h.power_mw, r_h.saving,
                   r_h.frac_violating),
            "hd_acc": apps.hd_accuracy(
                hd, APP_SEED, flip_prob=apps.hd_flip_prob(r_h.bit_probs),
                device=DEV)})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    print(f"over-scaling path: wall {wall:.3f} s (sweeps + GOLDEN_OS "
          f"{t_sweep:.3f} s, LeNet {LENET_STEPS} steps + HD training "
          f"{t_train:.3f} s); launches {counts}; LeNet final loss "
          f"{info['final_loss']:.4f}")
    check(counts["thermal_mg_solve"] > 0 and counts["overscale_matmul"] > 0,
          "the over-scaling path launched the fused solve and the int8 "
          "kernel")

    # the plain path on the same seeds gives the same logits, bit for bit
    for r_l in sweeps["lenet"]:
        lg_p, _ = apps.lenet_logits(
            p, APP_SEED, LENET_N, apps.scale_bit_probs(r_l.bit_probs),
            use_kernel=False, device=DEV)
        check(torch.equal(lg_p, logits[r_l.gamma]),
              f"LeNet logits at gamma {r_l.gamma}: kernel == plain")
    check(rows[0]["gamma"] == 1.0 and rows[0]["lenet"][4] == 0.0
          and rows[0]["lenet_acc"] == acc_int8,
          "gamma 1.0 violates nothing: accuracy == clean int8 accuracy")
    # the same sweeps on the CPU port, and the reference's decisions
    t0 = time.perf_counter()
    for k, nl in nets.items():
        cpu = OS.sweep(nl, GAMMAS, t_amb=40.0, tc=tc, device="cpu")
        for g, c in zip(sweeps[k], cpu):
            check(_same_decision(g, c.v_core, c.v_bram, c.power_mw,
                                 c.frac_violating)
                  and abs(g.saving - c.saving) < 1e-3,
                  f"{k} gamma {g.gamma}: card == cpu port")
        for g in sweeps[k]:
            if g.gamma in FIG8[k]:
                check(_same_decision(g, *FIG8[k][g.gamma]),
                      f"{k} gamma {g.gamma}: == reference {FIG8[k][g.gamma]}")
    print(f"cpu port: both sweeps in {time.perf_counter() - t0:.1f} s")
    check(_same_decision(golden, GOLDEN_OS["v_core"], GOLDEN_OS["v_bram"],
                         GOLDEN_OS["power_mw"], GOLDEN_OS["frac_violating"]),
          f"GOLDEN_OS ({golden.v_core}, {golden.v_bram}, {golden.power_mw})")

    print(f"Fig 8 (40 C, theta_JA 12): clean LeNet float {acc_float:.4f}, "
          f"int8 {acc_int8:.4f}; HD {hd_clean:.4f}")
    print(f"{'app':6s} {'gamma':6s} {'V_core':7s} {'V_bram':7s} "
          f"{'power_mW':10s} {'saving':8s} {'frac_viol':10s} accuracy")
    for r in rows:
        for app in ("lenet", "hd"):
            vc, vbr, mw, sav, frac = r[app]
            print(f"{app:6s} {r['gamma']:<6.2f} {vc:<7.2f} {vbr:<7.2f} "
                  f"{mw:<10.4f} {sav:<8.4f} {frac:<10.4f} "
                  f"{r[app + '_acc']:.4f}")
    fig8 = apps.scale_bit_probs(
        next(r for r in sweeps["lenet"] if r.gamma == 1.35).bit_probs)
    return {"counts": counts, "wall_s": wall, "fig8_probs": fig8,
            "params": p, "rows": rows, "runs": stats}


def sec5_path(torch) -> dict:
    """§V at llama3.2-1b's MLP widths: AbftMatmul on the up and down
    products for 48 and 4096 tokens at each rail of the study (nominal, then
    0.730 V down to 0.700 V) at 65 C, through the kernel (counted), then
    through the plain version on the same seeds."""
    from repro_torch.core import tpu_fleet as TF
    from repro_torch.tolerance import AbftMatmul, TimingFaultModel

    fm = TimingFaultModel()
    rails = [TF.V_CORE_NOM] + [round(0.730 - 0.005 * i, 3) for i in range(7)]
    g = torch.Generator(device=DEV)
    g.manual_seed(0)
    randn = lambda *shape: torch.randn(shape, generator=g, device=DEV)
    x = {M: randn(M, D_MODEL) for M in TOKENS}
    h = {M: randn(M, D_FF) for M in TOKENS}
    # the model's init scale: normal / sqrt(fan_in) (models/params.py)
    w_up = randn(D_MODEL, D_FF) / D_MODEL ** 0.5
    w_down = randn(D_FF, D_MODEL) / D_FF ** 0.5

    def run(use_kernel: bool):
        ledgers, outs = [], []
        for vc in rails:
            mm = AbftMatmul(fm.bit_probs(vc, TF.V_SRAM_NOM, SEC5_T), 9,
                            use_kernel=use_kernel, device=DEV)
            for M in TOKENS:
                outs += [mm(x[M], w_up), mm(h[M], w_down)]
            ledgers.append(mm.counters)
        return ledgers, outs

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    led_k, out_k = run(True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    print(f"§V path: wall {wall:.3f} s; launches {counts}")
    check(counts["abft_matmul"] > 0, "the §V path launched the ABFT kernel")
    led_p, out_p = run(False)
    check(led_k == led_p, "§V ledgers: kernel == plain")
    check(all(torch.equal(a, b) for a, b in zip(out_k, out_p)),
          "§V outputs: kernel == plain")
    print(f"{'v_core':7s} {'overshoot':10s} {'checked':>9s} {'inj':>8s} "
          f"{'det':>8s} {'corr':>8s} {'esc':>8s}")
    guard = 0
    for vc, c in zip(rails, led_k):
        x_over = float(fm.overshoot(vc, TF.V_SRAM_NOM, SEC5_T))
        print(f"{vc:<7.3f} {x_over:<10.4f} {c.checked:>9d} {c.injected:>8d} "
              f"{c.detected:>8d} {c.corrected:>8d} {c.escaped:>8d}")
        if x_over == 0.0:
            guard += 1
            check(c.injected == 0 and c.escaped == 0,
                  f"guard-band rail {vc} injects nothing")
    check(guard >= 1 and led_k[-1].injected > 0,
          "the sweep spans the guard band and rails below it")
    return {"counts": counts, "wall_s": wall,
            "ledgers": [(vc, vars(c)) for vc, c in zip(rails, led_k)]}


def _mm_bound(M, K, N, sums: bool):
    """(ms, "bytes" | "operations"): a and b read once, both planes read, c
    written (and the two checksums), against 2*M*N*K int8 operations."""
    nbytes = M * K + K * N + 4 * 2 * M * N + 4 * M * N + 33 * 4
    nbytes += 4 * (M + N) if sums else 0
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2.0 * M * N * K / INT8_OP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# edges held bit for bit beside the paths' shapes: ragged tiles, odd K and
# N (byte loads), and K split 128 ways across CTAs
MM_EDGES = [(1, 1, 1), (65, 33, 127), (16, 8192, 64)]
# (name, (M, K, N), B's value over the second half of K (None: -128)):
# "wrap" adds 2^17 products of 16384 = 2^31, which wraps to -2^31 (and so
# does every checksum); "wrap-and-return" adds 2^17 of them, passing 2^31,
# then 2^17 of (-128)(127) = -16256, coming back to 2^17 x 128 = 2^24 (an
# accumulator that saturates ends at 2^24 - 1)
WRAP_CASES = [("wrap", (8, 1 << 17, 8), None),
              ("wrap-and-return", (16, 1 << 18, 16), 127)]
WRAP_WANT = {"wrap": -2 ** 31, "wrap-and-return": 1 << 24}


def int8_kernel_phase(torch, fig8_probs) -> dict:
    """Both error-injecting kernels against their plain versions on every
    (M, K, N) of the two paths and the edges, five bit profiles (tolerance
    0), and two products whose accumulators wrap, then times beside the
    bound and ``torch._int_mm``."""
    from repro_torch.core import tpu_fleet as TF
    from repro_torch.kernels import abft_matmul as AB
    from repro_torch.kernels import overscale_matmul as OM
    from repro_torch.tolerance import TimingFaultModel

    tail24 = np.zeros(32)
    tail24[24:] = 0.02
    profiles = {
        "zero": np.zeros(32), "fig8_lenet_g1.35": fig8_probs,
        "tail24_0.02": tail24, "bit30_0.05": np.eye(32)[30] * 0.05,
        "fault_0.70V_65C": TimingFaultModel().bit_probs(0.70, TF.V_SRAM_NOM,
                                                        65.0)}
    g = torch.Generator(device=DEV)
    g.manual_seed(17)
    worst = {"overscale_matmul": 0, "abft_matmul": 0}

    def diff(x, y):
        return int((x.long() - y.long()).abs().max()) if x.numel() else 0

    inputs = {}
    for (M, K, N) in LENET_MM + LLAMA_MM + MM_EDGES:
        a = torch.randint(-128, 128, (M, K), dtype=torch.int8, generator=g,
                          device=DEV)
        b = torch.randint(-128, 128, (K, N), dtype=torch.int8, generator=g,
                          device=DEV)
        ug, ub = OM.random_planes(g, (M, N), DEV)
        inputs[(M, K, N)] = (a, b, ug, ub)
        for name, probs in profiles.items():
            cdf = OM.bit_probs_to_cdf(probs, DEV)
            c, clean = OM.overscale_matmul(a, b, ug, ub, cdf,
                                           return_clean=True)
            c_r, clean_r = OM.overscale_matmul_ref(a, b, ug, ub, cdf,
                                                   return_clean=True)
            abft = AB.abft_matmul(a, b, ug, ub, cdf)
            abft_r = AB.abft_matmul_ref(a, b, ug, ub, cdf)
            torch.cuda.synchronize()
            e_o = max(diff(c, c_r), diff(clean, clean_r))
            e_a = max(diff(x, y) for x, y in zip(abft, abft_r))
            worst["overscale_matmul"] = max(worst["overscale_matmul"], e_o)
            worst["abft_matmul"] = max(worst["abft_matmul"], e_a)
            wraps = bool((c.long().sum(1) != abft[1].long()).any())
            print(f"int8 {M}x{K}x{N} {name} ({OM.plan(M, K, N).tile}): flipped "
                  f"{int((c != clean).sum())}, checksums wrap {wraps}, "
                  f"max|kernel-plain| overscale {e_o} abft {e_a}")
    cdf = OM.bit_probs_to_cdf(profiles["fault_0.70V_65C"], DEV)
    for name, (M, K, N), b_half in WRAP_CASES:
        a = torch.full((M, K), -128, dtype=torch.int8, device=DEV)
        b = torch.full((K, N), -128, dtype=torch.int8, device=DEV)
        if b_half:
            b[K // 2:] = b_half
        ug, ub = OM.random_planes(g, (M, N), DEV)
        abft = AB.abft_matmul(a, b, ug, ub, cdf, return_clean=True)
        abft_r = AB.abft_matmul_ref(a, b, ug, ub, cdf, return_clean=True)
        c_o = OM.overscale_matmul(a, b, ug, ub, cdf)
        e = max(diff(x, y) for x, y in zip(abft, abft_r))
        e_o = diff(c_o, abft_r[0])
        worst["abft_matmul"] = max(worst["abft_matmul"], e)
        worst["overscale_matmul"] = max(worst["overscale_matmul"], e_o)
        clean = int(abft_r[3][0, 0])
        print(f"int8 {name} {M}x{K}x{N} ({OM.plan(M, K, N)}): clean[0,0] "
              f"{clean}, rowsum[0] {int(abft_r[1][0])}, max|kernel-plain| "
              f"abft {e} overscale {e_o}")
        check(clean == WRAP_WANT[name], f"the {name} case gives "
                                        f"{WRAP_WANT[name]}")
    check(worst == {"overscale_matmul": 0, "abft_matmul": 0},
          f"int8 kernels equal their plain versions bit for bit ({worst})")

    rows = {"overscale_matmul": [], "abft_matmul": []}
    cdf = OM.bit_probs_to_cdf(tail24, DEV)
    for (M, K, N), (a, b, ug, ub) in inputs.items():
        if (M, K, N) not in LENET_MM + LLAMA_MM:
            continue  # an edge, held above and not timed
        lib_ok = M > 16 and K % 8 == 0 and N % 8 == 0
        lib_ms = (_time_ms(torch, lambda: torch._int_mm(a, b)) if lib_ok
                  else None)
        lib_dev = (_graph_ms(torch, lambda: torch._int_mm(a, b)) if lib_ok
                   else None)
        for name, kern, plain, sums in (
                ("overscale_matmul", OM.overscale_matmul,
                 OM.overscale_matmul_ref, False),
                ("abft_matmul", AB.abft_matmul, AB.abft_matmul_ref, True)):
            k_ms = _time_ms(torch, lambda: kern(a, b, ug, ub, cdf))
            k_dev = _graph_ms(torch, lambda: kern(a, b, ug, ub, cdf))
            p_ms = _time_ms(torch, lambda: plain(a, b, ug, ub, cdf))
            bound, by = _mm_bound(M, K, N, sums)
            rows[name].append({"M": M, "K": K, "N": N, "ms": k_ms,
                               "plain_ms": p_ms, "bound_ms": bound,
                               "bound_by": by, "library_ms": lib_ms,
                               "device_ms": k_dev,
                               "library_device_ms": lib_dev,
                               "plan": vars(OM.plan(M, K, N))})
            print(f"time {name} {M}x{K}x{N}: on the card alone (CUDA graph) "
                  f"{k_dev:.5f} ms a call ({k_dev / bound:.2f}x bound"
                  + (f", {k_dev / lib_dev:.3f}x _int_mm's {lib_dev:.5f} ms"
                     if lib_ok else "") + ")")
            print(f"time {name} {M}x{K}x{N}: kernel {k_ms:.5f} ms "
                  f"({k_ms / bound:.2f}x bound"
                  + (f", {k_ms / lib_ms:.3f}x _int_mm" if lib_ok else "")
                  + f"), plain {p_ms:.5f} ms, bound {bound:.7f} ms ({by}), "
                  f"torch._int_mm (product only) "
                  + (f"{lib_ms:.5f} ms" if lib_ok else
                     "refuses the shape (needs M > 16, K and N % 8 == 0)"))
    return {"max_abs_err": worst, "rows": rows}


def _profile(torch, label: str, run) -> dict:
    """Device time by kernel (the torch profiler) and the card's idle share
    of the wall time of one warm ``run()``; returns the busy time and each
    kernel's device time, in ms."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = lambda e: (getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0) or 0)
    # the kernels themselves (device-side events); the aten ops that
    # launched them carry the same device time again
    averages = prof.key_averages()
    events = [e for e in averages
              if str(e.device_type).endswith("CUDA") and dev(e) > 0]
    busy_us = sum(dev(e) for e in events)
    # an aten op's device time: the time of the kernels it launched
    total = lambda e: (getattr(e, "device_time_total", None)
                       or getattr(e, "cuda_time_total", 0) or 0)
    ops = {e.key: total(e) / 1e3 for e in averages
           if e.key.startswith("aten::") and total(e) > 0}
    print(f"profile {label} (warm): wall {wall * 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms, idle share {1 - busy_us / 1e6 / wall:.4f}")
    for e in sorted(events, key=dev, reverse=True)[:12]:
        print(f"  {dev(e) / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")
    return {"wall_ms": wall * 1e3, "busy_ms": busy_us / 1e3,
            "kernels_ms": {e.key: dev(e) / 1e3 for e in events},
            "ops_ms": ops}


def _share(prof: dict, name: str) -> float:
    """The share of a profile's device time in kernels whose name holds
    ``name``."""
    ms = sum(v for k, v in prof["kernels_ms"].items() if name in k)
    return ms / prof["busy_ms"] if prof["busy_ms"] else 0.0


def profile_phase(torch, table2_launches: int, lenet_params, fig8_probs):
    """Where the time goes in one warm Table II run, one warm 86-ambient LUT
    and one warm LeNet inference at gamma = 1.35 (n = 1024). Runs after the
    paths' counts were
    read; the Table II warm-up repeats the main path's run, and its launch
    count is printed beside that one's."""
    from repro_torch.core import apps
    from repro_torch.core import thermal
    from repro_torch.core import voltage_scaling as VS
    from repro_torch.core import vtr_benchmarks as vb
    from repro_torch.kernels import thermal_mg as MG
    table2 = lambda: VS.run(vb.load("mkDelayWorker32B"), 60.0, 1.0,
                            thermal.ThermalConfig(theta_ja=12.0),
                            device="cuda")
    l0 = MG.thermal_mg_solve.launches
    table2()  # warm: the substrate and its STA are cached
    torch.cuda.synchronize()
    print(f"repeat table2: fused solve launches "
          f"{MG.thermal_mg_solve.launches - l0} (main path's run: "
          f"{table2_launches})")
    prof = _profile(torch, "table2", table2)
    print(f"profile table2: fused solve {_share(prof, 'mg_solve'):.4f} of "
          f"the busy time")
    lut = lambda: VS.dynamic_lut(vb.load("mkDelayWorker32B"),
                                 [float(t) for t in range(86)], 1.0,
                                 thermal.ThermalConfig(theta_ja=12.0),
                                 device="cuda")
    lut()
    prof = _profile(torch, "dynamic_lut_86", lut)
    print(f"profile dynamic_lut_86: fused solve "
          f"{_share(prof, 'mg_solve'):.4f} of the busy time")
    lenet = lambda: apps.lenet_accuracy(lenet_params, APP_SEED, n=LENET_N,
                                        bit_probs=fig8_probs, device="cuda")
    lenet()
    _profile(torch, "lenet gamma=1.35 n=1024", lenet)


# --- attention kernels (the serving tier) ------------------------------------
ATT_H, ATT_HKV, ATT_D, ATT_PS = 32, 8, 64, 16  # llama3.2-1b's heads, pages
PAGED_DECODE_POS = [-1, 37, 255, 700, 1000, 1500, 2000, 2047]
PAGED_N_PAGES = 128  # 2048 positions of 16
EXTEND_S = 256  # the serve path's prefill chunk, 8 slots
SPEC_S = 4  # a speculative chunk: the last token and 3 drafts
FLASH_B, FLASH_S = 4, [128, 1000, 2048]
# the multimodal paths' flash shapes (phase 10f), all non-causal:
# (label, S, T, H, Hkv, D) at B = FLASH_B: the vlm's cross steps over 1601
# image tokens (decode S = 1, prefill chunks), whisper's over 1500 frames,
# and whisper's encoder, 1500 x 1500
FLASH_CROSS = ([("vlm cross", S, 1601, 32, 8, 128) for S in (1, 64, 256)]
               + [("whisper cross", S, 1500, 12, 12, 64)
                  for S in (1, 64, 256)]
               + [("whisper encoder", 1500, 1500, 12, 12, 64)])
ATT_TOL = {"float32": 1e-5, "bfloat16": 5e-2}


def _peak(dtype: str) -> float:
    return BF16_FLOP_PER_S if dtype == "bfloat16" else FP32_FLOP_PER_S


def _paged_pool(torch, dtype, slot_ends, g):
    """A pool laid out as the serving tier lays it out: slot b owns the
    pages of positions [0, slot_ends[b]) (its K, V and ids written), drawn
    from a permutation of the pool; the rest of its table is the null page
    (the last page, ids -1). Returns (k, v, ids, bt)."""
    n, ps = PAGED_N_PAGES, ATT_PS
    B = len(slot_ends)
    P = B * n
    k = torch.randn((P + 1, ps, ATT_HKV, ATT_D), generator=g,
                    device=DEV).to(dtype)
    v = torch.randn((P + 1, ps, ATT_HKV, ATT_D), generator=g,
                    device=DEV).to(dtype)
    perm = torch.randperm(P, generator=g, device=DEV).to(torch.int32)
    bt = torch.full((B, n), P, dtype=torch.int32, device=DEV)
    ids = torch.full((P + 1, ps), -1, dtype=torch.int32, device=DEV)
    for b, end in enumerate(slot_ends):
        pages = -(-end // ps)
        bt[b, :pages] = perm[b * n:b * n + pages]
        span = torch.arange(pages * ps, dtype=torch.int32, device=DEV)
        ids[bt[b, :pages].long()] = torch.where(
            span < end, span, -1).reshape(pages, ps).to(torch.int32)
    return k, v, ids, bt


def paged_cases(torch, dtype, g):
    """{name: (q, k, v, ids, bt, pos)} at the serve path's shapes: the
    decode rows (split-K; one row at pos = -1), and three chunk forms, one
    table row per slot and S rows at their own positions: the first
    256-row chunk of 8 prompts (positions 0-255), the 256-row extend of 8
    slots at 256 i, and a speculative 4-row chunk at the decode
    positions."""
    k, v, ids, bt = _paged_pool(torch, dtype,
                                [p + 1 for p in PAGED_DECODE_POS], g)
    pos = torch.tensor(PAGED_DECODE_POS, dtype=torch.int32, device=DEV)
    q = torch.randn((len(PAGED_DECODE_POS), ATT_H, ATT_D), generator=g,
                    device=DEV).to(dtype)
    cases = {"decode": (q, k, v, ids, bt, pos)}
    top = PAGED_N_PAGES * ATT_PS
    for name, starts, S in (
            ("first_chunk", [0] * 8, EXTEND_S),
            ("extend", [EXTEND_S * i for i in range(8)], EXTEND_S),
            ("spec", [min(max(p, 0), top - SPEC_S) for p in PAGED_DECODE_POS],
             SPEC_S)):
        k, v, ids, bt = _paged_pool(torch, dtype, [s + S for s in starts], g)
        pos = (torch.tensor(starts, dtype=torch.int32, device=DEV)[:, None]
               + torch.arange(S, dtype=torch.int32, device=DEV)[None])
        q = torch.randn((len(starts), S, ATT_H, ATT_D), generator=g,
                        device=DEV).to(dtype)
        cases[name] = (q, k, v, ids, bt, pos.contiguous())
    return cases


# mixtral's heads and window on the paged ring path (phase 10d's shapes)
RING_H, RING_HKV, RING_D, RING_W = 32, 8, 128, 4096
RING_DECODE_POS = [-1, 37, 4095, 4096, 4351, 4999, 5200, 6143]
# (start, real rows) of each slot's 256-row chunk: the first wrap, the last
# chunk of a 5000-token prompt, an empty ring, a decode row at mid-page,
# the ring's last chunk before max_len 6144, two unwrapped chunks, and an
# idle slot (every row at pos = -1)
RING_CHUNKS = [(4096, 256), (4864, 136), (0, 256), (4399, 1), (5888, 256),
               (300, 256), (1000, 200), (-1, 0)]


def ring_cases(torch, dtype, g):
    """{name: (q, k, v, ids, bt, pos)} as the paged ring path hands them to
    the kernel (window 4096) at mixtral's heads, 8 slots of 4096-entry
    rings over a permuted pool: the decode rows after their write
    (position p at ring index p % 4096; one row at pos = -1), and the
    256-row chunks before their ring-scatter, each table [256 ring pages |
    16 scratch pages] (the pre-update ring, then the chunk at start + j,
    the padded tail's ids -1). Ring pages that hold nothing are the null
    page (the last page, ids -1), as unallocated pages are."""
    ps, n = ATT_PS, RING_W // ATT_PS
    idx = torch.arange(RING_W, device=DEV)
    cases = {}
    for name, S, slots in (
            ("ring_decode", 1, [(p, 1) for p in RING_DECODE_POS]),
            ("ring_chunk", EXTEND_S, RING_CHUNKS)):
        m = n + (S // ps if S > 1 else 0)
        B = len(slots)
        P = B * m
        k = torch.randn((P + 1, ps, RING_HKV, RING_D), generator=g,
                        device=DEV).to(dtype)
        v = torch.randn((P + 1, ps, RING_HKV, RING_D), generator=g,
                        device=DEV).to(dtype)
        bt = torch.randperm(P, generator=g, device=DEV).to(torch.int32)
        bt = bt.reshape(B, m).contiguous()
        ids = torch.full((P + 1, ps), -1, dtype=torch.int32, device=DEV)
        for b, (s, nv) in enumerate(slots):
            newest = s if S == 1 else s - 1
            last = newest - ((newest - idx) % RING_W)
            ent = ring = torch.where(last >= 0, last, -1)
            if S > 1:
                ent = torch.cat([ring, torch.where(idx[:S] < nv,
                                                   s + idx[:S], -1)])
            ids[bt[b].long()] = ent.reshape(m, ps).to(torch.int32)
            bt[b, :n][(ring.reshape(n, ps) < 0).all(1)] = P
        starts = torch.tensor([s for s, _ in slots], dtype=torch.int32,
                              device=DEV)
        if S == 1:
            q = torch.randn((B, RING_H, RING_D), generator=g, device=DEV)
            pos = starts
        else:
            q = torch.randn((B, S, RING_H, RING_D), generator=g, device=DEV)
            pos = starts[:, None] + torch.arange(
                S, dtype=torch.int32, device=DEV)[None]
            pos[starts < 0] = -1
        cases[name] = (q.to(dtype), k, v, ids, bt, pos.contiguous())
    return cases


def _visible_keys(torch, ids, bt, pos, window=0):
    """(B, S, n * ps) bool: the logical cache entries each row may see."""
    B = bt.shape[0]
    seen = ids[bt.long()].reshape(B, 1, -1).long()
    p = pos.reshape(B, -1, 1).long()
    vis = (seen >= 0) & (seen <= p)
    if window:
        vis &= seen > p - window
    return vis


def paged_bound(torch, dtype, q, k, ids, bt, pos, window=0):
    """(ms, "bytes" | "operations"): the distinct pages the tables name
    (K, V and ids), q and the output once, against 4 * H * D operations per
    entry each row may see."""
    pages = torch.unique(bt.long())
    page_bytes = 2 * k[0].numel() * k.element_size() + ids.shape[1] * 4
    nbytes = (pages.numel() * page_bytes + 2 * q.numel() * q.element_size()
              + bt.numel() * 4 + pos.numel() * 4)
    vis = _visible_keys(torch, ids, bt, pos, window)
    ops = 4.0 * q.shape[-2] * q.shape[-1] * float(vis.sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / _peak(dtype)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def paged_library_call(torch, q, k, v, ids, bt, pos, window=0):
    """One ``F.scaled_dot_product_attention`` over the gathered logical
    cache with a boolean mask, each slot's rows as (B, H, S, D)."""
    import torch.nn.functional as F
    qc = q[:, None] if q.dim() == 3 else q
    B, S = qc.shape[:2]
    n, (ps, Hkv, D) = bt.shape[1], k.shape[1:]
    btl = bt.long()
    kl = k[btl].reshape(B, n * ps, Hkv, D).transpose(1, 2)
    vl = v[btl].reshape(B, n * ps, Hkv, D).transpose(1, 2)
    mask = _visible_keys(torch, ids, bt, pos, window)[:, None]
    ql = qc.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(
        ql, kl, vl, attn_mask=mask, enable_gqa=True)


def attention64(torch, q, k, v, mask):
    """softmax(q k^T / sqrt(D)) v in float64 over the same inputs: q
    (B, S, H, D), k and v (B, T, Hkv, D), mask (B, S, T) bool; a row that
    sees nothing is 0."""
    import math
    H, Hkv = q.shape[2], k.shape[2]
    heads = torch.arange(H, device=q.device) // (H // Hkv)
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    for b in range(q.shape[0]):  # one slot at a time: (H, S, T) in float64
        qb = q[b].double().transpose(0, 1)
        kb = k[b][:, heads].double().transpose(0, 1)
        vb = v[b][:, heads].double().transpose(0, 1)
        s = (qb @ kb.transpose(1, 2)) / math.sqrt(q.shape[-1])
        s = s.masked_fill(~mask[b][None], float("-inf"))
        w = torch.nan_to_num(torch.softmax(s, -1), nan=0.0)
        out[b] = (w @ vb).transpose(0, 1)
    return out


def paged64(torch, q, k, v, ids, bt, pos, window=0):
    qc = q[:, None] if q.dim() == 3 else q
    (B, n), (ps, Hkv, D) = bt.shape, k.shape[1:]
    kl = k[bt.long()].reshape(B, n * ps, Hkv, D)
    vl = v[bt.long()].reshape(B, n * ps, Hkv, D)
    out = attention64(torch, qc, kl, vl,
                      _visible_keys(torch, ids, bt, pos, window))
    return out[:, 0] if q.dim() == 3 else out


def flash_bound(dtype, B, S, T, causal, elem, H=ATT_H, Hkv=ATT_HKV, D=ATT_D):
    ops = 4.0 * B * H * S * T * D * (0.5 if causal else 1.0)
    nbytes = elem * D * (2 * B * S * H + 2 * B * T * Hkv)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / _peak(dtype)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def attention_kernel_phase(torch) -> dict:
    """Both attention kernels against their plain versions at the serving
    path's shapes (the paged kernel also at the mixtral path's: wrapped
    4096-entry rings, scratch pages, window 4096, heads of 128; the flash
    kernel also at the multimodal paths' non-causal S != T shapes, bit for
    bit, and timed on the card alone too), both
    dtypes, and in bf16 both against a float64
    softmax attention over the same inputs; then times beside the bound,
    the plain version and the library call."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA
    g = torch.Generator(device=DEV)
    g.manual_seed(23)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    worst = {"paged_attention": {}, "paged_ring": {}, "flash_attention": {}}
    rows = {"paged_attention": [], "flash_attention": []}

    def err(a, b):
        return float((a.float() - b.float()).abs().max())

    def vs64(dt, got, want, exact):
        if dt != "bfloat16":
            return {}
        e = {"kernel": err(got, exact), "plain": err(want, exact)}
        print(f"    vs float64 softmax attention: kernel {e['kernel']:.3e},"
              f" plain {e['plain']:.3e}")
        return {"err64_kernel": e["kernel"], "err64_plain": e["plain"]}

    for dt in ("float32", "bfloat16"):
        cases = {name: (args, 0) for name, args in
                 paged_cases(torch, tdt[dt], g).items()}
        cases.update({name: (args, RING_W) for name, args in
                      ring_cases(torch, tdt[dt], g).items()})
        for name, (args, win) in cases.items():
            q, k, v, ids, bt, pos = args
            e64 = {}
            for window in ((0, 48) if name == "decode" else (win,)):
                got = PA.paged_attention(*args, window=window)
                # the plain version's time is this call's: it repeats the
                # kernel's arithmetic op by op and takes up to seconds
                want, ms = _timed_call(torch, lambda: PA.paged_attention_ref(
                    *args, window=window))
                if window == win:
                    p_ms = ms
                e = err(got, want)
                worst["paged_attention"][dt] = max(
                    worst["paged_attention"].get(dt, 0.0), e)
                if name.startswith("ring"):
                    worst["paged_ring"][dt] = max(
                        worst["paged_ring"].get(dt, 0.0), e)
                if bool((pos < 0).any()):
                    check(bool((got[pos < 0] == 0).all()),
                          f"paged {name}: the pos = -1 rows are exactly zero")
                print(f"paged {name} {dt} q={tuple(q.shape)} pages/table="
                      f"{bt.shape[1]} window={window}: max|kernel-plain|="
                      f"{e:.3e}" + (" (bit for bit)" if e == 0 else ""))
                if window == win:
                    e64 = vs64(dt, got, want,
                               paged64(torch, q, k, v, ids, bt, pos, win))
                if name == "spec":  # what greedy decoding of its rows gives
                    B, S, H, D = q.shape
                    dec = PA.paged_attention(
                        q.reshape(B * S, H, D), k, v, ids,
                        bt.repeat_interleave(S, dim=0), pos.reshape(-1))
                    check(torch.equal(got.reshape(dec.shape), dec),
                          f"paged spec {dt}: the chunk equals the decode of "
                          f"its rows bit for bit")
            k_ms = _time_ms(torch, lambda: PA.paged_attention(
                *args, window=win))
            l_ms = _time_ms(torch, paged_library_call(torch, *args, win))
            bound, by = paged_bound(torch, dt, q, k, ids, bt, pos, win)
            rows["paged_attention"].append(dict(
                case=name, dtype=dt, shape=list(q.shape),
                n_pages=bt.shape[1], window=win, ms=k_ms, plain_ms=p_ms,
                bound_ms=bound, bound_by=by, library_ms=l_ms, **e64))
            print(f"time paged {name} {dt}: kernel {k_ms:.5f} ms "
                  f"({k_ms / bound:.1f}x the bound), plain {p_ms:.5f} ms, "
                  f"bound {bound:.7f} ms ({by}), sdpa over the gathered "
                  f"cache {l_ms:.5f} ms")
        for S in FLASH_S:
            q = torch.randn((FLASH_B, S, ATT_H, ATT_D), generator=g,
                            device=DEV).to(tdt[dt])
            k = torch.randn((FLASH_B, S, ATT_HKV, ATT_D), generator=g,
                            device=DEV).to(tdt[dt])
            v = torch.randn((FLASH_B, S, ATT_HKV, ATT_D), generator=g,
                            device=DEV).to(tdt[dt])
            for causal in (True, False):
                got = FA.flash_attention(q, k, v, causal=causal)
                want, p_ms = _timed_call(torch, lambda: FA.flash_attention_ref(
                    q, k, v, causal=causal))  # the plain's time, as above
                e = err(got, want)
                worst["flash_attention"][dt] = max(
                    worst["flash_attention"].get(dt, 0.0), e)
                print(f"flash {dt} S=T={S} causal={causal}: "
                      f"max|kernel-plain|={e:.3e}")
                idx = torch.arange(S, device=DEV)
                mask = ((idx[None, :] <= idx[:, None]) if causal else
                        torch.ones((S, S), dtype=torch.bool, device=DEV))
                e64 = vs64(dt, got, want, attention64(
                    torch, q, k, v, mask[None].expand(FLASH_B, S, S)))
                k_ms = _time_ms(torch, lambda: FA.flash_attention(
                    q, k, v, causal=causal))
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                l_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True))
                bound, by = flash_bound(dt, FLASH_B, S, S, causal,
                                        q.element_size())
                rows["flash_attention"].append(dict(
                    dtype=dt, B=FLASH_B, S=S, T=S, causal=causal, ms=k_ms,
                    plain_ms=p_ms, bound_ms=bound, bound_by=by,
                    library_ms=l_ms, **e64))
                print(f"time flash {dt} S=T={S} causal={causal}: kernel "
                      f"{k_ms:.5f} ms, plain {p_ms:.5f} ms, bound "
                      f"{bound:.7f} ms ({by}), sdpa {l_ms:.5f} ms")
        for label, S, T, H, Hkv, D in FLASH_CROSS:
            q = torch.randn((FLASH_B, S, H, D), generator=g,
                            device=DEV).to(tdt[dt])
            k = torch.randn((FLASH_B, T, Hkv, D), generator=g,
                            device=DEV).to(tdt[dt])
            v = torch.randn((FLASH_B, T, Hkv, D), generator=g,
                            device=DEV).to(tdt[dt])
            run = lambda: FA.flash_attention(q, k, v, causal=False)
            got = run()
            want, p_ms = _timed_call(torch, lambda: FA.flash_attention_ref(
                q, k, v, causal=False))  # the plain's time, as above
            check(torch.equal(got, want), f"flash {label} {dt} S={S} T={T}: "
                                          f"kernel == plain bit for bit")
            k_ms, alone = _time_ms(torch, run), _graph_ms(torch, run)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            l_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=True))
            bound, by = flash_bound(dt, FLASH_B, S, T, False,
                                    q.element_size(), H, Hkv, D)
            rows["flash_attention"].append(dict(
                case=label, dtype=dt, B=FLASH_B, S=S, T=T, H=H, Hkv=Hkv,
                D=D, causal=False, ms=k_ms, alone_ms=alone, plain_ms=p_ms,
                bound_ms=bound, bound_by=by, library_ms=l_ms,
                max_abs_err=0.0))
            print(f"time flash {label} {dt} S={S} T={T} {H}/{Hkv} heads of "
                  f"{D} (bit for bit): kernel {k_ms:.5f} ms, alone "
                  f"{alone:.5f} ms ({k_ms / bound:.1f}x the bound), plain "
                  f"{p_ms:.5f} ms, bound {bound:.7f} ms ({by}), sdpa "
                  f"{l_ms:.5f} ms")
    for kern, by_dt in worst.items():
        for dt, e in by_dt.items():
            check(e <= ATT_TOL[dt], f"{kern} {dt}: kernel == plain within "
                                    f"{ATT_TOL[dt]} (max {e:.3e})")
    return {"max_abs_err": {k: max(v.values()) for k, v in worst.items()},
            "max_abs_err_by_dtype": worst, "rows": rows}


# --- the serve path: llama3.2-1b at full width ----------------------------------
SERVE_ARCH = "llama3.2-1b"
SERVE_SEED = 0
SERVE_PROMPTS = [37, 100, 255, 256, 511, 700, 1000, 1500]
LATE_PROMPT, LATE_AT = 300, 10  # one more request after 10 ticks
SERVE_NEW = 32
SERVE_KW = dict(batch_slots=8, max_len=2048, page_size=16,
                prefill_chunk=256, eos_id=-1)
NEAR_TIE = 1e-4
BF16_ATOL, BF16_TOP1 = 0.06, 0.95
PREFILL_B, PREFILL_S = 4, 2048


def serve_prompts(vocab: int):
    """The gate's traffic, numpy-seeded: prompts 0 and 1 repeat a short
    pattern (the speculative run drafts from them), the rest are random;
    the last one is the late request."""
    rng = np.random.default_rng(SERVE_SEED)
    prompts = []
    for i, n in enumerate(SERVE_PROMPTS):
        if i < 2:
            pat = rng.integers(0, vocab, 5 + 2 * i)
            prompts.append(np.resize(pat, n).astype(np.int32))
        else:
            prompts.append(rng.integers(0, vocab, n).astype(np.int32))
    prompts.append(rng.integers(0, vocab, LATE_PROMPT).astype(np.int32))
    return prompts


def drive(engine, prompts, late=True, new=SERVE_NEW, late_at=LATE_AT,
          hook=None):
    """Submit the prompts (the last after ``late_at`` ticks when ``late``),
    run to the end, calling ``hook(engine, ticks_done)`` after each step;
    return ({rid: tokens}, [(width, tick_s, tokens, admitted)], wall)."""
    from repro_torch.serve import Request
    ticks = []
    engine.on_tick.append(lambda smp: ticks.append(
        (engine.tick_width, smp.tick_s, smp.tokens, smp.admitted)))
    first = prompts[:-1] if late else prompts
    for rid, p in enumerate(first):
        engine.submit(Request(rid, p, max_new=new))
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    while engine.step():
        n += 1
        if late and n == late_at:
            engine.submit(Request(len(first), prompts[-1], max_new=new))
        if hook is not None:
            hook(engine, n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {r.rid: list(r.out) for r in engine.finished}, ticks, wall


def _first_diff(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def plain_margin(torch, model, prompt, out, i) -> float:
    """Top-2 margin of the plain path's float32 logits after the prompt and
    the first i tokens of the plain run: one extend of the whole context
    through a fresh contiguous cache (``_sdpa``)."""
    ctx = np.concatenate([prompt, np.asarray(out[:i], np.int32)])
    cache = model.cache(1, SERVE_KW["max_len"])
    logits, _ = model.decode(torch.as_tensor(ctx, device=DEV)[None], cache, 0)
    top = torch.topk(logits[0, -1].float(), 2).values
    return float(top[0] - top[1])


def replay_margin(torch, model, prompt, out, i) -> float:
    """Top-2 margin of the plain path's logits after the prompt and the
    first i tokens of the plain run, for the stateful path: the prompt's
    exact-length prefill, then i one-token steps, at batch 1, through the
    plain versions (the engine's run had the other slots beside it)."""
    from repro_torch.models import attention as attn
    with attn.plain_kernels():
        logits, cache = model.prefill(
            {"tokens": torch.as_tensor(prompt, device=DEV)[None]},
            max_len=len(prompt) + i + 1)
        last = logits[0, -1]
        for t in range(i):
            logits, cache = model.decode(
                torch.tensor([[out[t]]], device=DEV), cache, len(prompt) + t)
            last = logits[0, 0]
    top = torch.topk(last.float(), 2).values
    return float(top[0] - top[1])


def hold_streams(torch, label, model, prompts, got, want,
                 margin=plain_margin) -> int:
    """Every stream of ``got`` equals ``want``'s, or differs first at a
    near-tie of the plain run; returns the count of equal streams."""
    same = 0
    for rid, w in want.items():
        i = _first_diff(got[rid], w)
        if i is None:
            same += 1
            continue
        m = margin(torch, model, prompts[rid], w, i)
        print(f"{label}: request {rid} first differs at generated token {i} "
              f"({got[rid][i] if i < len(got[rid]) else None} vs "
              f"{w[i] if i < len(w) else None}); the plain run's top-2 "
              f"margin there is {m:.3e}")
        check(m < NEAR_TIE, f"{label}: request {rid} differs only at a "
                            f"near-tie (margin {m:.3e} < {NEAR_TIE})")
    print(f"{label}: {same} of {len(want)} streams equal token for token")
    return same


def _tick_times(ticks, stateful=False):
    """Tick counts and mean tick times by kind: a prefill tick streams a
    prompt chunk (width > 1) or, on the stateful path, admits a request
    (its exact-length prefill runs inside the tick)."""
    is_pre = lambda w, a: w > 1 or (stateful and a > 0)
    dec = [t for w, t, _, a in ticks if w == 1 and not is_pre(w, a)]
    pre = [t for w, t, _, a in ticks if is_pre(w, a)]
    mean = lambda xs: sum(xs) / len(xs) if xs else None
    return {"ticks": len(ticks), "decode_ticks": len(dec),
            "prefill_ticks": len(pre), "decode_tick_s": mean(dec),
            "prefill_tick_s": mean(pre),
            "tokens": sum(n for _, _, n, _ in ticks)}


def serve_bf16_run(torch, engine, prompts):
    """One run of the bf16 traffic (``prompts``, the last one late) through
    a fresh paged engine (built, and so warmed up, by the caller):
    ({rid: tokens}, the tick counts and mean tick times with the wall time
    and tokens/s)."""
    got, ticks, wall = drive(engine, prompts)
    tt = _tick_times(ticks)
    return got, dict(tt, wall_s=wall, tokens_per_s=tt["tokens"] / wall)


def prefill_tokens(torch, vocab: int):
    """The prefill step's seeded tokens, (PREFILL_B, PREFILL_S)."""
    return torch.as_tensor(np.random.default_rng(SERVE_SEED + 1).integers(
        0, vocab, (PREFILL_B, PREFILL_S)), device=DEV)


def prefill_step(torch, model, toks):
    """The prefill step on ``toks``: a function of no arguments that runs
    it."""
    from repro_torch.serve import make_prefill_step
    step = make_prefill_step(model, PREFILL_S)
    return lambda: step({"tokens": toks})


def spec_bf16_run(torch, model, prompts) -> dict:
    """One timed run of the two repeating prompts through a fresh bf16
    paged engine with ``speculate=3``: tokens/s and the drafts accepted."""
    from repro_torch.serve import Engine
    eng = Engine(model, paged=True, speculate=3, **SERVE_KW)
    _, ticks, wall = drive(eng, prompts[:2], late=False)
    tokens = sum(n for _, _, n, _ in ticks)
    return {"spec_tokens_per_s": tokens / wall, "spec_wall_s": wall,
            "spec_ticks": len(ticks), "spec_accepted": eng.spec_accepted,
            "spec_proposed": eng.spec_proposed}


def serve_timing(torch) -> dict:
    """The bf16 serve path's times on their own, for comparing two
    versions of the package on one card (``tools/serve_ab.py``): llama's
    bf16 model from the seed, the traffic served once to warm up and once
    timed (:func:`serve_bf16_run`), the speculative run of its two
    repeating prompts the same way (:func:`spec_bf16_run`), and the prefill
    step over 3 calls after warm-up; with the card's name and power
    limit."""
    from repro_torch.configs import registry
    from repro_torch.models.model import Model
    from repro_torch.serve import Engine
    cfg = registry.get(SERVE_ARCH)
    prompts = serve_prompts(cfg.vocab_size)
    m16 = Model(cfg).init(SERVE_SEED)
    for _ in range(2):  # the first run warms up
        _, tt = serve_bf16_run(
            torch, Engine(m16, paged=True, **SERVE_KW), prompts)
        spec = spec_bf16_run(torch, m16, prompts)
    step = prefill_step(torch, m16, prefill_tokens(torch, cfg.vocab_size))
    return dict(tt, **spec, prefill_step_ms=_time_ms(torch, step, 3),
                card=smi_line())


def bf16_gate(torch, label, got, want) -> dict:
    """The reference's bf16 bound between the kernel path and the plain
    path: |d logits| <= 0.06 and top-1 agreement > 0.95 over the rows of
    the bf16 logits as the model returns them (what the engine samples)."""
    d = (got.float() - want.float()).abs().max().item()
    a = got.reshape(-1, got.shape[-1]).argmax(-1)
    b = want.reshape(-1, want.shape[-1]).argmax(-1)
    agree = float((a == b).float().mean())
    print(f"{label}: max|kernel-plain| {d:.4f}, top-1 agreement {agree:.4f} "
          f"over {a.numel()} rows")
    check(d <= BF16_ATOL and agree > BF16_TOP1,
          f"{label}: |d logits| <= {BF16_ATOL} and top-1 > {BF16_TOP1}")
    return {"max_abs_diff": d, "top1_agreement": agree, "rows": a.numel()}


def row_probe(torch, model, prompts, whole, k=3, title="") -> dict:
    """One verify tick (width k + 1, the drafts set to greedy's next k
    tokens) against the k + 1 greedy decode ticks it stands for, from one
    paged slot state past prefill (the pool restored between the runs),
    compared layer by layer on the model's tape (``L.TAPE``): the first
    intermediate where a verify row differs from its decode row and the
    largest |difference| there. ``whole``: the verify chunk takes every op
    whole (``L.by_column`` off for the run); else as shipped."""
    from repro_torch.models import layers as L
    from repro_torch.serve import Engine, Request
    eng = Engine(model, paged=True, **SERVE_KW)
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid, p, max_new=SERVE_NEW))
    while True:
        eng.step()
        plan, _ = eng._compose()
        if plan.width == 1:
            break
    live = [w.slot for w in plan.work]
    for slot in live:  # the pages of all k + 1 rows, for both runs
        eng.mgr.extend(slot, int(eng.mgr.pos[slot]) + k + 1)
    pool = eng.mgr.pool["stack"]
    saved = {name: v.clone() for name, v in pool.items()}
    step = (plan.n_valid > 0).astype(np.int32)
    by_column = L.by_column
    if whole:
        L.by_column = lambda S: False
    try:
        decode, toks = [], plan.tokens.copy()
        greedy = np.zeros((plan.tokens.shape[0], k + 1), np.int32)
        for j in range(k + 1):
            L.TAPE = []
            logits = eng.step_logits(toks, plan.pos + j * step, plan.n_valid)
            decode.append(L.TAPE)
            greedy[:, j] = toks[:, 0]
            toks = logits.argmax(-1).to(torch.int32).cpu().numpy()
        for name, v in saved.items():
            pool[name].copy_(v)
        L.TAPE = []
        eng.step_logits(greedy, plan.pos, step * (k + 1))
        verify = L.TAPE
    finally:
        L.TAPE = None
        L.by_column = by_column
    first, layer, logits_equal = None, -1, True
    for i, (name, v) in enumerate(verify):
        layer += name == "ln1"
        for j in range(k + 1):
            d_name, d = decode[j][i]
            check(d_name == name, f"the probe's tapes line up ({d_name} vs "
                                  f"{name})")
            got, want = v[live, j].float(), d[live, 0].float()
            if not torch.equal(got, want):
                logits_equal &= name != "logits"
                if first is None:
                    first = {"layer": layer, "name": name, "row": j,
                             "max_abs_diff": float((got - want).abs().max())}
    how = "every op whole" if whole else "as shipped"
    print(f"{title}row probe bf16 ({how}, {len(live)} slots, {k + 1} rows, "
          f"{len(verify)} intermediates): "
          + ("every verify row equals its decode row" if first is None else
             f"first differs at layer {first['layer']} {first['name']} (row "
             f"{first['row']}), max|d| {first['max_abs_diff']:.4e}")
          + f"; logits equal {logits_equal}")
    return {"first_diff": first, "logits_equal": logits_equal}


def isolated_ops(torch, model, B=8, S=4) -> dict:
    """Each product and norm reduction of a llama layer on one seeded bf16
    input (B, S, width), whole against a column at a time: which of them
    round a row otherwise in a chunk of S rows than alone."""
    from repro_torch.models import attention as attn
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as tf
    p = model.params
    lay = tf.layer(p["blocks"]["stack"], 0)
    d = model.cfg.d_model
    emb = p["embed"]["embedding"]
    ops = {
        "norm (mean of squares)": (d, lambda t: t.float().square().mean(
            -1, keepdim=True)),
        "q": (d, lambda t: attn._proj(t, lay["attn"]["wq"])),
        "k": (d, lambda t: attn._proj(t, lay["attn"]["wk"])),
        "v": (d, lambda t: attn._proj(t, lay["attn"]["wv"])),
        "o": (d, lambda t: t @ lay["attn"]["wo"].reshape(-1, d)),
        "gate": (d, lambda t: t @ lay["mlp"]["wg"]),
        "up": (d, lambda t: t @ lay["mlp"]["wu"]),
        "down": (model.cfg.d_ff, lambda t: t @ lay["mlp"]["wd"]),
        "unembed": (d, lambda t: t @ emb.T),
    }
    g = torch.Generator(device=DEV)
    g.manual_seed(SERVE_SEED + 5)
    out = {}
    for name, (width, fn) in ops.items():
        x = torch.randn((B, S, width), generator=g, device=DEV).to(emb.dtype)
        whole = fn(x)
        cols = L.join([fn(t) for t in L.columns(x, True)])
        out[name] = float((whole.float() - cols.float()).abs().max())
        print(f"isolated {name} ({B} x {S} rows): max|whole - by column| "
              f"{out[name]:.4e}")
    return out


def serve_path(torch) -> dict:
    """The serving tier at full width: the float32 gate and speculative
    run, the bf16 run, the bf16 speculative gate and row probe, the bf16
    decode-tick gate, the bf16 prefill gate."""
    from repro_torch.configs import registry
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import attention as attn
    from repro_torch.models.model import Model
    from repro_torch.serve import Engine, Request

    cfg = registry.get(SERVE_ARCH)
    n_layers = cfg.num_layers
    prompts = serve_prompts(cfg.vocab_size)
    out = {}

    # 1. the float32 gate: paged (the kernel) against contiguous (_sdpa)
    t0 = time.perf_counter()
    m32 = Model(cfg.replace(dtype="float32")).init(SERVE_SEED)
    print(f"serve: {SERVE_ARCH} ({m32.n_params()} parameters, "
          f"{n_layers} layers) float32 from seed {SERVE_SEED} in "
          f"{time.perf_counter() - t0:.1f} s")
    eng = Engine(m32, paged=True, **SERVE_KW)
    reset_counts()
    paged, ticks, wall = drive(eng, prompts)
    counts = read_counts()
    n_ticks = sum(1 for w, _, _, _ in ticks if w > 0)
    print(f"serve gate float32 paged: wall {wall:.3f} s, {n_ticks} ticks, "
          f"launches {counts}")
    check(counts["paged_attention"] > 0
          and counts["paged_attention"] == n_ticks * n_layers,
          f"paged launches == ticks x {n_layers} layers")
    out["gate_counts"] = counts
    out["gate"] = dict(_tick_times(ticks), wall_s=wall)
    del eng
    cont, ticks_c, wall_c = drive(Engine(m32, **SERVE_KW), prompts)
    print(f"serve gate float32 contiguous: wall {wall_c:.3f} s")
    out["gate_contiguous"] = dict(_tick_times(ticks_c), wall_s=wall_c)
    out["gate_equal_streams"] = hold_streams(
        torch, "float32 paged vs contiguous", m32, prompts, paged, cont)
    # phase 12 holds the expandable engines to these (popped before the
    # summary line is printed)
    out["streams"] = {"paged": paged, "contiguous": cont}
    for rid in sorted(paged):
        print(f"  request {rid} ({len(prompts[rid])} prompt tokens): "
              f"{paged[rid][:8]}...")

    # 2. speculative, float32: the two repeating prompts
    eng = Engine(m32, paged=True, speculate=3, **SERVE_KW)
    spec, _, wall_s = drive(eng, prompts[:2], late=False)
    print(f"serve speculate=3 float32: wall {wall_s:.3f} s, accepted "
          f"{eng.spec_accepted} of {eng.spec_proposed} drafts")
    hold_streams(torch, "speculative vs greedy", m32, prompts, spec,
                 {rid: paged[rid] for rid in spec})
    out["spec"] = {"accepted": eng.spec_accepted,
                   "proposed": eng.spec_proposed, "wall_s": wall_s}
    del eng, m32
    gc.collect()
    torch.cuda.empty_cache()

    # 3. bf16, the working type
    m16 = Model(cfg).init(SERVE_SEED)
    eng = Engine(m16, paged=True, **SERVE_KW)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    got16, tt = serve_bf16_run(torch, eng, prompts)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"serve bf16 paged: wall {tt['wall_s']:.3f} s, {tt['tokens']} "
          f"tokens, {tt['tokens_per_s']:.1f} tokens/s, decode tick "
          f"{tt['decode_tick_s']:.5f} s ({tt['decode_ticks']}), prefill tick "
          f"{tt['prefill_tick_s']:.5f} s ({tt['prefill_ticks']}), launches "
          f"{counts}, peak memory {peak / 2 ** 20:.1f} MiB")
    check(counts["paged_attention"] > 0, "the bf16 run launched the kernel")
    del eng
    cont16, _, _ = drive(Engine(m16, **SERVE_KW), prompts)
    agree = sum(a == b for rid in cont16
                for a, b in zip(got16[rid], cont16[rid]))
    total = sum(len(v) for v in cont16.values())
    same = sum(got16[rid] == cont16[rid] for rid in cont16)
    print(f"serve bf16 paged vs contiguous (reported): {same} of "
          f"{len(cont16)} streams equal, {agree} of {total} tokens agree "
          f"position by position")
    out["bf16"] = dict(tt, counts=counts, peak_memory_bytes=peak,
                       streams_equal_contiguous=same,
                       tokens_agree_contiguous=agree, tokens_total=total)
    out["streams"]["bf16_paged"] = got16

    # speculative in bf16 against greedy on the same traffic (the gate: a
    # verify row takes its decode row's arithmetic in every layer), and
    # against the full traffic's streams (reported: bf16 streams depend on
    # what else shares the batch)
    greedy16, _, _ = drive(Engine(m16, paged=True, **SERVE_KW), prompts[:2],
                           late=False)
    eng = Engine(m16, paged=True, speculate=3, **SERVE_KW)
    spec16, _, wall_s = drive(eng, prompts[:2], late=False)
    same16 = sum(spec16[rid] == greedy16[rid] for rid in greedy16)
    print(f"serve speculate=3 bf16: wall {wall_s:.3f} s, accepted "
          f"{eng.spec_accepted} of {eng.spec_proposed} drafts; {same16} of "
          f"{len(greedy16)} streams equal a greedy run of the same traffic")
    diffs = {rid: _first_diff(spec16[rid], got16[rid]) for rid in spec16}
    for rid, i in diffs.items():
        if i is not None:
            m = plain_margin(torch, m16, prompts[rid], got16[rid], i)
            print(f"speculative (2 prompts) vs greedy (9 prompts) bf16, "
                  f"reported: request {rid} first differs at generated token "
                  f"{i}; the plain run's top-2 margin there is {m:.3e}")
    print(f"speculative (2 prompts) vs greedy (9 prompts) bf16, reported: "
          f"{sum(i is None for i in diffs.values())} of {len(diffs)} streams "
          f"equal")
    out["spec_bf16"] = {
        "accepted": eng.spec_accepted, "proposed": eng.spec_proposed,
        "wall_s": wall_s, "streams_equal_greedy_same_traffic": same16,
        "streams_equal_full_traffic": sum(i is None for i in diffs.values()),
        "first_diff_full_traffic": {str(r): i for r, i in diffs.items()}}
    check(same16 == len(greedy16), "bf16 speculate=3 equals greedy on the "
                                   "same traffic in every stream")
    del eng
    out["row_probe"] = {
        label: row_probe(torch, m16, prompts[:2], whole)
        for label, whole in (("one product", True), ("by column", False))}
    check(out["row_probe"]["by column"]["logits_equal"],
          "bf16 verify rows equal their decode rows bit for bit (logits)")
    out["isolated_ops"] = isolated_ops(torch, m16)

    # the decode-tick gate and the profile's engine: 8 slots of 256-token
    # prompts, one prefill tick, then decode ticks
    eng = Engine(m16, paged=True, **SERVE_KW)
    for rid in range(SERVE_KW["batch_slots"]):
        eng.submit(Request(rid, prompts[3], max_new=64))
    prof = _profile(torch, "serve bf16 prefill-chunk tick (8 x 256)",
                    eng.step)
    out["prefill_chunk_profile"] = dict(
        busy_ms=prof["busy_ms"], wall_ms=prof["wall_ms"],
        paged_ms=prof["busy_ms"] * _share(prof, "paged_"))
    for _ in range(3):
        eng.step()
    prof = _profile(torch, "serve bf16 all-decode tick (8 x 1)", eng.step)
    out["decode_tick_profile"] = dict(
        busy_ms=prof["busy_ms"], wall_ms=prof["wall_ms"],
        paged_ms=prof["busy_ms"] * _share(prof, "paged_"))
    plan, spec_tick = eng._compose()
    check(plan is not None and not spec_tick and plan.width == 1
          and eng._reserve_pages(plan), "a decode tick to compare")
    pool = eng.mgr.pool["stack"]
    saved = {k: v.clone() for k, v in pool.items()}

    def tick(plain: bool):
        """The planned tick from the saved cache state, pool restored."""
        with attn.plain_kernels() if plain else contextlib.nullcontext():
            logits = eng.step_logits(plan.tokens, plan.pos, plan.n_valid)
        for k, v in saved.items():
            pool[k].copy_(v)
        return logits

    out["decode_tick_gate"] = bf16_gate(torch, "bf16 decode tick",
                                        tick(False), tick(True))
    del saved

    # 4. the prefill step, bf16, through the flash kernel
    toks = prefill_tokens(torch, cfg.vocab_size)
    step = prefill_step(torch, m16, toks)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last_k, _ = step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    print(f"prefill bf16 B={PREFILL_B} S={PREFILL_S}: first call {wall:.3f}"
          f" s, launches {counts}")
    check(counts["flash_attention"] == n_layers,
          "the prefill step launched the flash kernel once per layer")
    out["prefill_counts"] = counts
    del last_k
    p_ms = _time_ms(torch, step, 3)

    def full(plain):
        """The logits of every position (the step returns the last)."""
        with attn.plain_kernels() if plain else contextlib.nullcontext():
            return m16.prefill({"tokens": toks}, max_len=PREFILL_S)[0]

    # one call each, timed: a plain prefill is ~16 x 2 s of the float64
    # tensor-core model, so its gate's call is its timing too
    got, k_ms = _timed_call(torch, lambda: full(False))
    want, pp_ms = _timed_call(torch, lambda: full(True))
    out["prefill_gate"] = bf16_gate(torch, "bf16 prefill, every position",
                                    got, want)
    del got, want
    print(f"prefill step bf16: {p_ms:.3f} ms through the kernel; the "
          f"prefill of every position's logits {k_ms:.3f} ms through the "
          f"kernel, {pp_ms:.3f} ms through the plain version")
    prof = _profile(torch, f"bf16 prefill step B={PREFILL_B} S={PREFILL_S}",
                    step)
    share = _share(prof, "flash_attention")
    print(f"prefill step bf16: the flash kernel takes {share:.4f} of its "
          f"device time ({prof['busy_ms'] * share:.3f} ms)")
    out["prefill_profile"] = dict(busy_ms=prof["busy_ms"],
                                  wall_ms=prof["wall_ms"], flash_share=share)
    out["prefill_ms"] = {"kernel": p_ms, "full_kernel": k_ms,
                         "full_plain": pp_ms}
    return out

# --- the serving control loop (scenarios.serve_replay) -----------------------------
CTL_DAY = dict(ticks=14, hot=42.0, cool=12.0, cool_at=7)
CTL_BURST = dict(burst_at=1, burst_n=12, prompt_len=384, max_new=32,
                 tail_ticks=4, tail_rate=0.5, seed=0)
CTL_SWEEP = ((10.0, 45.0, 4), (0.25, 1.0, 4))  # serve_replay's own knots
CTL_HOT_TICKS = (9, 10)  # chip 0 at T_MAX_CHIP - 1, slots busy
CTL_PNOM_RTOL = 1e-3
CTL_DEFER_PREMIUM = 1.05  # serve_replay's default


def _ctl_inputs():
    from repro_torch import scenarios as sc
    from repro_torch.core import tpu_fleet as TF
    day = sc.serve_day(**CTL_DAY)
    hot = dataclasses.replace(day, hotspots=tuple(
        sc.Hotspot(t, 0, TF.T_MAX_CHIP - 1.0) for t in CTL_HOT_TICKS))
    return day, hot, sc.poisson_burst(**CTL_BURST)


def _ctl_runtime(device):
    from repro_torch.core import runtime as RT
    from repro_torch.core import tpu_fleet as TF
    return RT.EnergyAwareRuntime(
        TF.StepProfile.from_roofline(compute_s=0.8, memory_s=0.45,
                                     collective_s=0.2),
        policy="power_save", device=device)


# (label, serve_replay keyword arguments): the float32 pairs and the
# preempting run; each card run is held to a CPU run of the same kind
CTL_RUNS = {
    "thermal": dict(admission=True),
    "throughput": dict(admission=False),
    "thermal_contiguous": dict(admission=True, paged=False),
    "preempt": dict(admission=True, preempt=True),
}
CTL_DECISIONS = ("deferred", "forced", "finished", "preempts",
                 "preempted_reqs", "ticks", "engine_ticks", "model_ticks")


def _loop_replans(loop) -> int:
    """Replans so far of a ``ControlLoop``'s controller, or summed over a
    ``FleetLoop``'s pod controllers."""
    ctls = ([p.controller for p in loop.pods] if hasattr(loop, "pods")
            else [loop.controller])
    return sum(getattr(c, "inner", c).stats.replans for c in ctls)


class _TickMeter:
    """Wall time and host syncs of every ``ControlLoop.step`` (or, with
    ``fleet=True``, ``FleetLoop.step``) while installed: the loop's method
    is wrapped, and the syncs are the warnings
    ``torch.cuda.set_sync_debug_mode("warn")`` raises inside the call
    (every device -> host read, and every blocking host -> device copy,
    waits for the card)."""

    def __init__(self, torch, fleet=False):
        from repro_torch import control
        self.torch = torch
        self.cls = control.FleetLoop if fleet else control.ControlLoop
        self.orig = self.cls.step
        self.rows = []  # (wall s, syncs, replanned)

    def __enter__(self):
        torch, orig, rows = self.torch, self.orig, self.rows

        def step(loop, *a, **kw):
            replans = _loop_replans(loop)
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                t0 = time.perf_counter()
                try:
                    rep = orig(loop, *a, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            rows.append((time.perf_counter() - t0,
                         sum("synchroniz" in str(w.message) for w in caught),
                         _loop_replans(loop) > replans))
            return rep

        self.cls.step = step
        return self

    def __exit__(self, *exc):
        self.cls.step = self.orig

    def summary(self) -> dict:
        mean = lambda xs: sum(xs) / len(xs) if xs else 0.0
        out = {}
        for name, rows in (("all", self.rows),
                           ("fast", [r for r in self.rows if not r[2]]),
                           ("replan", [r for r in self.rows if r[2]])):
            out[name] = {"ticks": len(rows),
                         "step_ms": mean([r[0] for r in rows]) * 1e3,
                         "syncs": mean([r[1] for r in rows])}
        return out


def _price_margins(rt, field, t_amb: float, slots: int) -> str:
    """Where the admission price of each marginal slot of an idle pod sits
    against ``defer_premium`` at ``t_amb``: m_now / m_best - premium, by
    ``AdmissionController``'s own pod-power pricing."""
    from repro_torch import control as ctl
    pod = ctl.AdmissionController(ctl.LutController(
        rt.planner, field=field))._pod_power
    out = []
    for k in range(1, slots + 1):
        u0, u1 = (k - 1) / slots, k / slots
        now = pod(t_amb, u1) - pod(t_amb, u0)
        best = min(pod(float(t), u1) - pod(float(t), u0) for t in field.t)
        out.append(f"{now / best - CTL_DEFER_PREMIUM:+.3e}")
    return ", ".join(out)


def _hold_decisions(label, got, want, rt, field, day) -> None:
    """A card replay's decisions against the CPU replay of the same kind:
    the cap trace and the counts."""
    caps, wcaps = got.caps.tolist(), want.caps.tolist()
    if caps != wcaps:
        for k, (a, b) in enumerate(zip(caps, wcaps)):
            if a != b:
                print(f"{label}: cap at control tick {k} is {a} on the card, "
                      f"{b} on the CPU; price - defer_premium per marginal "
                      f"slot at {day.ambient_at(k)} C: "
                      f"{_price_margins(rt, field, day.ambient_at(k), 8)}")
    check(caps == wcaps, f"{label}: the cap trace equals the CPU replay's")
    for name in CTL_DECISIONS:
        check(getattr(got, name) == getattr(want, name),
              f"{label}: {name} {getattr(got, name)} equals the CPU "
              f"replay's {getattr(want, name)}")
    check(abs(got.energy_j / want.energy_j - 1) <= CTL_PNOM_RTOL,
          f"{label}: energy_j {got.energy_j} within {CTL_PNOM_RTOL} of the "
          f"CPU replay's {want.energy_j}")


def _decisions(r, names) -> "types.SimpleNamespace":
    """What the card's run is held to of a CPU replay or drill: its cap
    trace, energy and the counts ``names``."""
    import types
    return types.SimpleNamespace(caps=np.asarray(r.caps), energy_j=r.energy_j,
                                 **{n: getattr(r, n) for n in names})


def _ctl_engine_kw() -> dict:
    """The control replays' engine settings (the serve path's)."""
    return {k: SERVE_KW[k] for k in ("batch_slots", "max_len", "page_size",
                                     "prefill_chunk", "eos_id")}


def control_cpu_replays() -> dict:
    """The control loop's CPU replays at reduced width, one of each kind of
    ``CTL_RUNS``: the decisions phase 10b holds the card's to."""
    from repro_torch import scenarios as sc
    from repro_torch.configs import registry
    from repro_torch.models.model import Model
    day, hot, wl = _ctl_inputs()
    cpu_rt = _ctl_runtime("cpu")
    rcfg = registry.get(SERVE_ARCH).reduced().replace(dtype="float32")
    rmodel = Model(rcfg, device="cpu").init(SERVE_SEED)
    kw = _ctl_engine_kw()
    cpu = {}
    for label, args in CTL_RUNS.items():
        args = dict(args)
        cpu[label] = _decisions(sc.serve_replay(
            hot if label == "preempt" else day, wl, rmodel, runtime=cpu_rt,
            **dict(kw, paged=args.pop("paged", True), **args)),
            CTL_DECISIONS)
    return cpu


def fleet_cpu_drill():
    """The pod-loss drill on the CPU port at reduced width: the decisions
    phase 10c holds the card's drill to."""
    from repro_torch.configs import registry
    from repro_torch.models.model import Model
    rcfg = registry.get(SERVE_ARCH).reduced().replace(dtype="float32")
    return _decisions(_drill(Model(rcfg, device="cpu").init(SERVE_SEED),
                             _fleet_runtime("cpu"), clean=False),
                      DRILL_DECISIONS)


# the CPU oracles of phases 10b and 10c run in a process of their own from
# the start of the script (~80 s of the host, none of the card)
ORACLE_DIR = ROOT / "build" / "cpu_oracles"
ORACLE_THREADS = 4


def cpu_oracles_worker(path: str) -> None:
    """The spawned process's target: both oracles on the CPU, pickled to
    ``path`` with their seconds."""
    import pickle

    import torch
    torch.set_num_threads(ORACLE_THREADS)
    t0 = time.perf_counter()
    out = {"control": control_cpu_replays()}
    out["control_s"] = time.perf_counter() - t0
    out["drill"] = fleet_cpu_drill()
    out["seconds"] = time.perf_counter() - t0
    Path(path).write_bytes(pickle.dumps(out))


class CpuOracles:
    """:func:`cpu_oracles_worker` in a spawned process (daemonic: it ends
    with the script), started on construction; :meth:`get` waits for it
    and fails the script if it failed."""

    def __init__(self):
        import multiprocessing
        ORACLE_DIR.mkdir(parents=True, exist_ok=True)
        self.path = ORACLE_DIR / "oracles.pkl"
        self.path.unlink(missing_ok=True)
        self.proc = multiprocessing.get_context("spawn").Process(
            target=cpu_oracles_worker, args=(str(self.path),), daemon=True)
        self.proc.start()
        self.out = None

    def get(self, name: str):
        if self.out is None:
            import pickle
            t0 = time.perf_counter()
            self.proc.join()
            waited = time.perf_counter() - t0
            check(self.proc.exitcode == 0 and self.path.exists(),
                  "the CPU oracles' process ran to its end")
            self.out = pickle.loads(self.path.read_bytes())
            print(f"CPU oracles (control replays and fleet drill, reduced "
                  f"width, {ORACLE_THREADS} threads): "
                  f"{self.out['control_s']:.1f} s and "
                  f"{self.out['seconds'] - self.out['control_s']:.1f} s in "
                  f"their own process; the script waited {waited:.1f} s")
        return self.out[name]


def control_path(torch, card: str, oracles: CpuOracles) -> dict:
    """The serving control plane on the card: the RailField against the CPU
    port's, then ``scenarios.serve_replay`` at llama3.2-1b full width
    under the full control loop (float32 pairs, preemption, bf16), each
    replay's decisions held to a CPU replay at reduced width (run in the
    oracles' process)."""
    from repro_torch import scenarios as sc
    from repro_torch.configs import registry
    from repro_torch.control import sweep_points
    from repro_torch.models.model import Model

    out = {}
    day, hot, wl = _ctl_inputs()
    knots = [sweep_points(*s) for s in CTL_SWEEP]

    # 1. the field: the card against the CPU port
    rt = _ctl_runtime(None)
    walls = []
    for _ in range(2):  # cold (first solves on the card), then warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        field = rt.build_field(*knots)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    cpu_rt = _ctl_runtime("cpu")
    t0 = time.perf_counter()
    cpu_field = cpu_rt.build_field(*knots)
    cpu_wall = time.perf_counter() - t0
    pnom_err = float(np.max(np.abs(field.p_nom / cpu_field.p_nom - 1)))
    print(f"control: build_field {len(knots[0])}x{len(knots[1])} knots x "
          f"{field.chips} chips on the card: {walls[0] * 1e3:.3f} ms cold, "
          f"{walls[1] * 1e3:.3f} ms warm; the CPU port: {cpu_wall * 1e3:.3f}"
          f" ms; p_nom max rel diff {pnom_err:.3e} ({card})")
    check(np.array_equal(field.vc, cpu_field.vc)
          and np.array_equal(field.vs, cpu_field.vs),
          "the card's RailField rails equal the CPU port's at every knot "
          "and chip")
    check(pnom_err <= CTL_PNOM_RTOL,
          f"the card's p_nom within {CTL_PNOM_RTOL} of the CPU port's")
    for t in sorted({day.ambient_at(k) for k in range(day.ticks)}):
        print(f"control: admission price - defer_premium per marginal slot "
              f"of an idle pod at {t} C: {_price_margins(rt, field, t, 8)}")
    out["build_field_ms"] = {"cold": walls[0] * 1e3, "warm": walls[1] * 1e3,
                             "cpu_port": cpu_wall * 1e3}
    out["p_nom_max_rel_diff"] = pnom_err

    # 2. the CPU replays at reduced width: the decisions to hold
    kw = _ctl_engine_kw()
    cpu = oracles.get("control")

    # 3. the card, float32
    cfg = registry.get(SERVE_ARCH)
    n_layers = cfg.num_layers
    vocab = cfg.vocab_size
    prompts = {a.rid: sc.serve_prompt(a.rid, a.prompt_len, vocab)
               for a in wl.arrivals}

    def replay(model, label, dtype):
        args = dict(CTL_RUNS[label])
        paged = args.pop("paged", True)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        with _TickMeter(torch) as meter:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = sc.serve_replay(hot if label == "preempt" else day, wl, model,
                                runtime=rt, **dict(kw, paged=paged, **args))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        ticks = meter.summary()
        print(f"control {dtype} {label}: wall {wall:.3f} s, {r.ticks} control"
              f" ticks, {r.engine_ticks} engine ticks ({r.model_ticks} model "
              f"steps), {r.tokens} tokens, {r.tokens / wall:.1f} tokens/s, "
              f"energy {r.energy_j:.1f} J, {r.tokens_per_joule:.6e} tokens/J,"
              f" deferred {r.deferred}, forced {r.forced}, preempts "
              f"{r.preempts}, caps {r.caps.tolist()}, launches {counts}, "
              f"peak memory {peak / 2 ** 20:.1f} MiB ({card})")
        print(f"control {dtype} {label}: loop.step " + "; ".join(
            f"{k} {v['step_ms']:.3f} ms and {v['syncs']:.2f} host syncs "
            f"per tick over {v['ticks']} ticks" for k, v in ticks.items())
            + f" ({card})")
        got = {rid: list(o) for rid, o in zip(sorted(prompts), r.outputs)}
        stats = dict(wall_s=wall, ticks=r.ticks, engine_ticks=r.engine_ticks,
                     model_ticks=r.model_ticks, tokens=r.tokens,
                     tokens_per_s=r.tokens / wall, energy_j=r.energy_j,
                     tokens_per_joule=r.tokens_per_joule,
                     deferred=r.deferred, forced=r.forced,
                     preempts=r.preempts, caps=r.caps.tolist(),
                     counts=counts, peak_memory_bytes=peak, loop=ticks)
        return r, got, stats

    m32 = Model(cfg.replace(dtype="float32")).init(SERVE_SEED)
    f32, streams = {}, {}
    for label in CTL_RUNS:
        r, streams[label], out[f"float32_{label}"] = replay(m32, label,
                                                            "float32")
        _hold_decisions(f"float32 {label}", r, cpu[label], rt, field,
                        hot if label == "preempt" else day)
        f32[label] = r
        counts = out[f"float32_{label}"]["counts"]
        if CTL_RUNS[label].get("paged", True):
            # the engine's warm-up runs its two width buckets (1 and the
            # prefill chunk) through the model once before the day
            check(counts["paged_attention"]
                  == (r.model_ticks + 2) * n_layers,
                  f"float32 {label}: paged launches == (model steps + 2 "
                  f"warm-up steps) x {n_layers} layers")
        else:
            check(counts["paged_attention"] == 0,
                  f"float32 {label}: the contiguous engine launches no paged "
                  f"kernel")
    print(f"control float32 thermal_contiguous: flash launches "
          f"{out['float32_thermal_contiguous']['counts']['flash_attention']}"
          f" (the contiguous engine's chunked prefill attends through "
          f"gqa_decode's plain _sdpa, as the reference's engine does)")
    therm, thru = f32["thermal"], f32["throughput"]
    check(therm.deferred > 0, "the thermal-aware run deferred admissions")
    check(therm.tokens_per_joule > thru.tokens_per_joule,
          f"thermal-aware tokens/J {therm.tokens_per_joule:.6e} > "
          f"throughput-only {thru.tokens_per_joule:.6e}")
    out["float32_thermal_vs_throughput_equal_streams"] = hold_streams(
        torch, "control float32 thermal vs throughput", m32, prompts,
        streams["thermal"], streams["throughput"])
    out["float32_paged_vs_contiguous_equal_streams"] = hold_streams(
        torch, "control float32 paged vs contiguous", m32, prompts,
        streams["thermal"], streams["thermal_contiguous"])
    check(f32["preempt"].preempts > 0 and f32["preempt"].preempted_reqs > 0,
          "the hotspot preempted running requests")
    out["float32_preempt_vs_undisturbed_equal_streams"] = hold_streams(
        torch, "control float32 preempted vs undisturbed", m32, prompts,
        streams["preempt"], streams["thermal"])
    del m32
    gc.collect()
    torch.cuda.empty_cache()

    # 4. bf16, the working type: reported, not gated
    m16 = Model(cfg).init(SERVE_SEED)
    b16 = {}
    for label in ("thermal", "throughput"):
        r, b16[label], out[f"bf16_{label}"] = replay(m16, label, "bfloat16")
        _hold_decisions(f"bf16 {label}", r, cpu[label], rt, field, day)
    same = sum(b16["thermal"][rid] == b16["throughput"][rid]
               for rid in prompts)
    print(f"control bf16 thermal vs throughput (reported): {same} of "
          f"{len(prompts)} streams equal")
    out["bf16_thermal_vs_throughput_equal_streams"] = same
    del m16
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --- the fault, monitor and fleet tier (replay, fleet_replay, the drill) ----------
FLEET_KNOTS = ((10.0, 45.0, 8), (0.25, 1.0, 4))  # replay's default knots
FLEET_DAYS = ("diurnal_load_spike", "chaos_day", "sdc_storm")
SDC_BUDGET = 1e-5  # the ErrorTolerant policy's escaped-SDC budget
# SDC counts of one day on the card and on the CPU: the settled fields an
# ulp apart move a Poisson draw of injected flips by a few, and the
# escaped count is then a binomial draw over another n from the same
# stream; injected within SDC_RTOL, escaped within SDC_SIGMAS standard
# deviations of that draw (tests/test_torch_faults.py::sdc_agree)
SDC_RTOL = 1e-5
SDC_SIGMAS = 5.0
FLEET_DECISIONS = ("replans", "lut_hits", "boosts", "rebalances",
                   "replan_reasons", "condemned", "backoffs", "restores",
                   "quarantined", "stale_fallbacks", "degraded_ticks",
                   "frozen_ticks", "safe_states", "below_axis_clamps",
                   "write_nacks", "write_retries", "watchdog_events",
                   "recover_ticks")
FLEET_EVENTS = ("events", "state_trace", "states", "quarantines",
                "pod_restores", "replans", "replan_reasons", "condemned",
                "write_nacks", "watchdog_events")
# the pod-loss drill: 12 requests, 2 a tick over ticks 1-6, the serve
# path's prompt lengths in turn, 32 new tokens; phase 10b's engine settings
DRILL_PODS = 2
DRILL_STEPS = 2  # engine steps per control tick
DRILL_LENS = [SERVE_PROMPTS[i % len(SERVE_PROMPTS)] for i in range(12)]
DRILL_DECISIONS = ("ticks", "engine_ticks", "model_ticks", "finished",
                   "rejected", "migrated", "quarantines", "pod_restores",
                   "preempts", "preempted_reqs")


def _fleet_runtime(device, policy="power_save"):
    from repro_torch.core import runtime as RT
    from repro_torch.core import tpu_fleet as TF
    return RT.EnergyAwareRuntime(
        TF.StepProfile.from_roofline(compute_s=0.8, memory_s=0.45,
                                     collective_s=0.2),
        policy=policy, device=device)


def _hold_replay(label, got, want, names, arrays=("rails",)) -> None:
    """A card replay's decisions against the CPU port's: equal, and the
    energy ledger within 1e-3."""
    for name in arrays:
        check(np.array_equal(getattr(got, name), getattr(want, name)),
              f"{label}: {name} equal the CPU port's")
    for name in names:
        a, b = getattr(got, name), getattr(want, name)
        check(a == b, f"{label}: {name} {a} equals the CPU port's {b}")
    for name in ("mean_saving", "energy_j", "t_max"):
        a, b = getattr(got, name), getattr(want, name)
        check(abs(a / b - 1) <= CTL_PNOM_RTOL,
              f"{label}: {name} {a} within {CTL_PNOM_RTOL} of the CPU "
              f"port's {b}")


def _sdc_agree(got, want) -> bool:
    from repro_torch.policy.policies import ABFT_ESCAPE as p
    gi, wi = got.sdc_injected, want.sdc_injected
    return (got.sdc_checked == want.sdc_checked
            and abs(gi - wi) <= SDC_RTOL * max(wi, 1)
            and abs(got.sdc_escaped - want.sdc_escaped)
            <= SDC_SIGMAS * (wi * p * (1 - p)) ** 0.5 + p * abs(gi - wi) + 1)


def _meter_line(label, meter, card) -> dict:
    ticks = meter.summary()
    print(f"{label}: step " + "; ".join(
        f"{k} {v['step_ms']:.3f} ms and {v['syncs']:.2f} host syncs per "
        f"tick over {v['ticks']} ticks" for k, v in ticks.items())
        + f" ({card})")
    return ticks


def _day_replay(torch, day, device):
    """One named day through ``scenarios.replay`` on ``device`` at the
    default knots (``sdc_storm``: an ErrorTolerant controller with an SDC
    budget and a seeded FaultInjector); returns (result, wall s)."""
    from repro_torch import scenarios as sc
    from repro_torch.control import sweep_points
    from repro_torch.tolerance import FaultInjector, TimingFaultModel
    sdc = day == "sdc_storm"
    rt = _fleet_runtime(device, f"error_tolerant:{SDC_BUDGET}" if sdc
                        else "power_save")
    field = rt.build_field(*[sweep_points(*k) for k in FLEET_KNOTS])
    kw = {"sdc_budget": SDC_BUDGET} if sdc else {}
    inj = (FaultInjector(TimingFaultModel(rt.lib), seed=7) if sdc
           else None)
    controller = rt.controller(field=field, guard_band_c=3.0, **kw)
    solves = rt.planner.baseline_solves
    if device is None:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = sc.replay(sc.SCENARIOS[day](), runtime=rt, controller=controller,
                  injector=inj)
    if device is None:
        torch.cuda.synchronize()
    return r, time.perf_counter() - t0, rt.planner.baseline_solves - solves


def _drill(model, rt, clean):
    from repro_torch import scenarios as sc
    day = sc.pod_loss_day(ticks=16)
    if clean:
        day = sc.Scenario(name=day.name, ticks=day.ticks,
                          ambient=day.ambient, load=day.load)
    wl = sc.trace_requests([(1 + i // 2, n, SERVE_NEW)
                            for i, n in enumerate(DRILL_LENS)],
                           name="pod_loss_drill")
    return sc.fleet_serve_replay(
        day, wl, model, n_pods=DRILL_PODS, runtime=rt,
        engine_steps=DRILL_STEPS, paged=True, **SERVE_KW)


def fleet_path(torch, card: str, oracles: CpuOracles) -> dict:
    """The control plane's fault, monitor and fleet tier on the card:
    three named days through ``replay``, the pod-loss day through
    ``fleet_replay`` at 2 pods, each held to the CPU port; then the
    pod-loss serving drill at llama3.2-1b full width through
    ``fleet_serve_replay`` (two paged engines over one host page pool),
    held to the CPU drill of the oracles' process."""
    from repro_torch import scenarios as sc
    from repro_torch.configs import registry
    from repro_torch.models.model import Model

    out = {}
    # 1. replay: the card against the CPU port
    for day in FLEET_DAYS:
        with _TickMeter(torch) as meter:
            got, wall, solves = _day_replay(torch, day, None)
        want, cpu_wall, _ = _day_replay(torch, day, "cpu")
        label = f"fleet replay {day}"
        print(f"{label}: {got.ticks} ticks, wall {wall:.3f} s on the card "
              f"(the CPU port {cpu_wall:.3f} s), replans {got.replans}, "
              f"lut_hits {got.lut_hits}, mean_saving {got.mean_saving:.6f},"
              f" t_max {got.t_max:.3f} C, quarantined {got.quarantined}, "
              f"frozen {got.frozen_ticks}, safe_states {got.safe_states}, "
              f"write_nacks {got.write_nacks}, backoffs {got.backoffs}, "
              f"below-axis clamps {got.below_axis_clamps}, nominal-baseline "
              f"solves {solves} (ticks whose load left the field's util "
              f"axis), sdc injected / escaped {got.sdc_injected} / "
              f"{got.sdc_escaped} (CPU {want.sdc_injected} / "
              f"{want.sdc_escaped}) ({card})")
        _hold_replay(label, got, want, FLEET_DECISIONS,
                     ("rails", "util_trace", "shares"))
        check(_sdc_agree(got, want),
              f"{label}: SDC counts agree with the CPU port's (injected "
              f"within {SDC_RTOL}, escaped within {SDC_SIGMAS} sigma)")
        check(got.t_max < 95.0, f"{label}: t_max under the junction limit")
        out[f"replay_{day}"] = {
            "wall_s": wall, "cpu_wall_s": cpu_wall, "ticks": got.ticks,
            "replans": got.replans, "fingerprint": got.fingerprint,
            "sdc_injected": got.sdc_injected, "baseline_solves": solves,
            "loop": _meter_line(label + " loop", meter, card)}
    check(out["replay_chaos_day"]["loop"]["all"]["ticks"] == 48,
          "the chaos day ticked 48 times")

    # 2. fleet_replay of the pod-loss day at 2 pods
    kw = dict(n_pods=2, sweep=FLEET_KNOTS[0], util_sweep=FLEET_KNOTS[1])
    rt = _fleet_runtime(None)
    with _TickMeter(torch, fleet=True) as meter:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = sc.fleet_replay(sc.pod_loss_day(ticks=16), runtime=rt, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    solves = rt.planner.baseline_solves
    want = sc.fleet_replay(sc.pod_loss_day(ticks=16),
                           runtime=_fleet_runtime("cpu"), **kw)
    print(f"fleet_replay pod_loss_day x 2 pods: wall {wall:.3f} s (the "
          f"field build included), nominal-baseline solves {solves} beside "
          f"the field's, events {got.events} ({card})")
    _hold_replay("fleet_replay pod_loss_day", got, want, FLEET_EVENTS)
    check(got.quarantines == 1 and got.pod_restores == 1,
          "fleet_replay pod_loss_day: one quarantine and one restore")
    out["fleet_replay"] = {
        "wall_s": wall, "events": got.events, "baseline_solves": solves,
        "loop": _meter_line("fleet_replay FleetLoop", meter, card)}

    # 3. the pod-loss serving drill, held to the CPU drill at reduced width
    cpu = oracles.get("drill")
    cfg = registry.get(SERVE_ARCH)
    n_layers = cfg.num_layers
    prompts = {rid: sc.serve_prompt(rid, n, cfg.vocab_size)
               for rid, n in enumerate(DRILL_LENS)}

    def run(model, dtype, clean):
        label = f"fleet drill {dtype} {'no-failure' if clean else 'pod loss'}"
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        solves = rt.planner.baseline_solves
        with _TickMeter(torch, fleet=True) as meter:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = _drill(model, rt, clean)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        print(f"{label}: wall {wall:.3f} s, {r.ticks} control ticks, "
              f"{r.engine_ticks} engine ticks ({r.model_ticks} model steps),"
              f" {r.tokens} tokens, {r.tokens / wall:.1f} tokens/s, "
              f"finished {r.finished}, rejected {r.rejected}, migrated "
              f"{r.migrated}, quarantines {r.quarantines}, restores "
              f"{r.pod_restores}, energy {r.energy_j:.1f} J, nominal-baseline "
              f"solves {rt.planner.baseline_solves - solves}, launches "
              f"{counts}, peak memory {peak / 2 ** 20:.1f} MiB ({card})")
        # each engine's warm-up runs its two width buckets once
        check(counts["paged_attention"]
              == (r.model_ticks + 2 * DRILL_PODS) * n_layers,
              f"{label}: paged launches == (model steps + 2 warm-up steps "
              f"x {DRILL_PODS} engines) x {n_layers} layers")
        stats = dict(wall_s=wall, ticks=r.ticks, engine_ticks=r.engine_ticks,
                     model_ticks=r.model_ticks, tokens=r.tokens,
                     tokens_per_s=r.tokens / wall, migrated=r.migrated,
                     finished=r.finished, energy_j=r.energy_j,
                     baseline_solves=rt.planner.baseline_solves - solves,
                     caps=r.caps.tolist(), counts=counts,
                     peak_memory_bytes=peak,
                     loop=_meter_line(label + " FleetLoop", meter, card))
        got = {rid: list(o) for rid, o in zip(sorted(prompts), r.outputs)}
        return r, got, stats

    m32 = Model(cfg.replace(dtype="float32")).init(SERVE_SEED)
    loss, loss_streams, out["float32_pod_loss"] = run(m32, "float32", False)
    _, clean_streams, out["float32_no_failure"] = run(m32, "float32", True)
    check(loss.migrated > 0, "the drill migrated in-flight requests")
    check(loss.finished == len(DRILL_LENS) and loss.rejected == 0,
          f"the drill finished all {len(DRILL_LENS)} requests, none lost")
    check(loss.caps.tolist() == cpu.caps.tolist(),
          "the drill's cap trace equals the CPU drill's")
    for name in DRILL_DECISIONS:
        a, b = getattr(loss, name), getattr(cpu, name)
        check(a == b, f"fleet drill: {name} {a} equals the CPU drill's {b}")
    check(abs(loss.energy_j / cpu.energy_j - 1) <= CTL_PNOM_RTOL,
          "fleet drill: energy_j within 1e-3 of the CPU drill's")
    out["float32_migrated_vs_no_failure_equal_streams"] = hold_streams(
        torch, "fleet drill float32 pod loss vs no failure", m32, prompts,
        loss_streams, clean_streams)
    out["paged_launches"] = out["float32_pod_loss"]["counts"][
        "paged_attention"]
    del m32
    gc.collect()
    torch.cuda.empty_cache()

    # 4. bf16, the working type: reported, not gated
    m16 = Model(cfg).init(SERVE_SEED)
    _, b_loss, out["bf16_pod_loss"] = run(m16, "bfloat16", False)
    _, b_clean, out["bf16_no_failure"] = run(m16, "bfloat16", True)
    same = sum(b_loss[rid] == b_clean[rid] for rid in prompts)
    print(f"fleet drill bf16 pod loss vs no failure (reported): {same} of "
          f"{len(prompts)} streams equal")
    out["bf16_migrated_vs_no_failure_equal_streams"] = same
    del m16
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --- the mixtral serve path: mixtral-8x7b at full width (phase 10d) ----------
MIX_ARCH = "mixtral-8x7b"
MIX_SEED = 0
# the depth cut: one layer is 1.4513 B parameters, so the 32 layers are
# 93.4 GB in bf16, more than the card's 85 GB. The bf16 timing run takes
# the deepest stack that fits with headroom: drawing a stacked expert leaf
# holds a float32 copy beside the bf16 leaves, 4.7 GB a layer at its peak,
# so 16 layers peak near 76 GB (17 would leave the allocator about 3 GB).
# The float32 gate serves the traffic twice with products on the CUDA
# cores (TF32 off); memory would hold about 12 layers, and 4 keep it
# inside the phase's time.
MIX_LAYERS = {"float32": 4, "bfloat16": 16}
MIX_LONG = [4352, 5000]  # cross the 4096-token window: the ring wraps
MIX_KW = dict(batch_slots=8, max_len=6144, page_size=16, prefill_chunk=256,
              eos_id=-1)
MIX_PROFILE_PROMPT = 4352  # 8 of them: the 17th chunk wraps every ring
# the card against the CPU port at reduced width: a 32-entry ring, chunks
# of 12 (the chunk at 24 wraps mid-chunk), ticks compared in turn
MIX_REDUCED = dict(window=32, chunk=12, ticks=5,
                   prompts=[60, 45, 12, 3, 33, 50, 27, 8])
ROUTE_TIE = 1e-6  # tests/test_torch_moe.py: a near-tie of two experts


def mix_prompts(vocab: int):
    """The two long prompts first (they take slots at once and wrap their
    rings early), then the serve path's prompts, the last one late."""
    rng = np.random.default_rng(MIX_SEED + 2)
    return ([rng.integers(0, vocab, n).astype(np.int32) for n in MIX_LONG]
            + serve_prompts(vocab))


class _MixMeter:
    """Per step of an engine, kept on the device until read: the step's
    plan (tokens' shape, pos, n_valid), the top-2 logit margin of each
    slot's sampled row, with ``keep_routes`` the step's tokens and the
    routes of every layer (the experts chosen, the kept routes and each
    token's router margin, :func:`moe.route_margin`), and the routes and
    drops of decode and extend steps (all rows, and the rows of real
    tokens); each step's dropped routes of each slot's real tokens over
    all layers, and the request each slot served; and which step and slot
    produced each (request, token). It wraps the engine's
    ``step_logits`` and ``_append``."""

    def __init__(self, torch, engine, keep_routes=False):
        from repro_torch.models import moe
        self.margins, self.made, self.plans = {}, {}, {}
        self.tokens, self.layers = {}, {}
        self.slot_drops, self.slot_rids = {}, {}
        z = lambda: torch.zeros(4, dtype=torch.long, device=DEV)
        self.routes = {"decode": z(), "extend": z()}
        step_logits, append = engine.step_logits, engine._append
        k = engine.model.cfg.num_experts_per_tok

        def metered(tokens, pos, n_valid):
            with moe.capture_routes() as routes:
                logits = step_logits(tokens, pos, n_valid)
            B, S = logits.shape[:2]
            tick = engine.ticks
            self.plans[tick] = (tuple(np.shape(tokens)),
                                tuple(np.asarray(pos).tolist()),
                                tuple(np.asarray(n_valid).tolist()))
            nv = torch.as_tensor(n_valid, device=DEV).long()
            last = logits[torch.arange(B, device=DEV),
                          (nv - 1).clamp(0, S - 1)].float()
            top = torch.topk(last, 2).values
            self.margins[tick] = top[:, 0] - top[:, 1]
            if keep_routes:
                self.tokens[tick] = np.array(tokens)
                self.layers[tick] = [
                    (r["idx"], r["keep"], moe.route_margin(r["logits"], k))
                    for r in routes]
            real = (torch.arange(S, device=DEV)[None] < nv[:, None]
                    ).reshape(-1).repeat_interleave(k)
            keep = torch.stack([r["keep"].reshape(-1) for r in routes])
            self.routes["decode" if S == 1 else "extend"] += torch.stack([
                torch.ones_like(keep).sum(), (~keep).sum(),
                real.sum() * keep.shape[0], (~keep & real).sum()])
            self.slot_drops[tick] = (~keep & real).reshape(
                len(routes), B, S * k).sum((0, 2))
            self.slot_rids[tick] = [None if q is None else q.rid
                                    for q in engine.slot_req]
            return logits

        def appended(req, slot, tok):
            self.made[(req.rid, len(req.out))] = (engine.ticks, slot)
            append(req, slot, tok)

        engine.step_logits, engine._append = metered, appended

    def own_drops(self, rid, i) -> int:
        """The routes of request ``rid``'s real tokens that the capacity
        dropped, in any layer, at the steps after the one that made its
        first token (its prompt's last chunk) up to the one that made its
        token i: the steps at which two runs of one schedule can differ."""
        first, last = self.made[(rid, 0)][0], self.made[(rid, i)][0]
        return sum(int(self.slot_drops[t][s]) for t in self.slot_drops
                   if first < t <= last
                   for s, r in enumerate(self.slot_rids[t]) if r == rid)

    def margin(self, rid, i) -> float:
        """The top-2 logit margin of the row that made token i."""
        tick, slot = self.made[(rid, i)]
        return float(self.margins[tick][slot])

    def drop_shares(self) -> dict:
        out = {}
        for kind, (n, dropped, n_real, dropped_real) in self.routes.items():
            n, dropped, n_real, dropped_real = (int(v) for v in (
                n, dropped, n_real, dropped_real))
            out[kind] = {"routes": n, "dropped": dropped,
                         "share": dropped / n if n else None,
                         "real_routes": n_real, "real_dropped": dropped_real,
                         "real_share": dropped_real / n_real if n_real
                         else None}
        return out


def route_split(label, a, b):
    """(step, details): the first step at which the two meters' runs part
    (None if they never do). Both engines run one schedule (checked step
    by step), and each step is one dispatch group a layer. The runs part
    where the steps' tokens differ (a stream parted earlier, which
    :func:`hold_mix` holds), or, at the first layer whose routes differ:
    where the experts of a live slot's token differ (a slot with real
    tokens this step, its padded tail included), every such token must be
    a router near-tie (its k-th and (k + 1)-th probabilities within
    ``ROUTE_TIE`` in one of the two runs); where only idle slots' tokens
    moved (they route too, on whatever their caches hold, which differs
    between the two layouts) and that moved a live route across the
    capacity, the runs part there too. Past such a layer the layers'
    inputs differ."""
    check(a.plans == b.plans, f"{label}: both engines ran one schedule")
    for tick in sorted(a.layers):
        if not np.array_equal(a.tokens[tick], b.tokens[tick]):
            print(f"{label}: the steps' tokens first differ at step {tick}")
            return tick, {"by": "tokens"}
        (B, S), _, n_valid = a.plans[tick]
        # (1, B * S): the tokens of slots with real tokens this step
        live = a.layers[tick][0][0].new_tensor(
            np.repeat(np.asarray(n_valid) > 0, S)[None]).bool()
        for layer, ((ia, ka, ma), (ib, kb, mb)) in enumerate(
                zip(a.layers[tick], b.layers[tick])):
            check(ia.shape[:2] == (1, B * S), f"{label}: one dispatch group "
                                              f"a layer")
            moved = (ia != ib).any(-1)  # (1, B * S): their experts differ
            if not bool(moved.any()):
                check(bool((ka == kb).all()),
                      f"{label}: step {tick} layer {layer}: the same experts "
                      f"keep the same routes")
                continue
            if bool((moved & live).any()):
                margin = float(ma.minimum(mb)[moved & live].max())
                n_moved = int((moved & live).sum())
                print(f"{label}: the routes first differ at step {tick}, "
                      f"layer {layer}: {n_moved} live tokens' experts, the "
                      f"largest of their router margins {margin:.3e}")
                check(margin < ROUTE_TIE,
                      f"{label}: the first routes that differ are near-ties "
                      f"(router margin {margin:.3e} < {ROUTE_TIE})")
                return tick, {"by": "routes", "layer": layer,
                              "tokens": n_moved, "router_margin": margin}
            k = ia.shape[-1]
            crossed = (ka != kb) & live.repeat_interleave(k, dim=-1)
            if bool(crossed.any()):
                print(f"{label}: at step {tick}, layer {layer}, "
                      f"{int(moved.sum())} idle slots' tokens route apart "
                      f"and move {int(crossed.sum())} live routes across "
                      f"the capacity")
                return tick, {"by": "capacity", "layer": layer,
                              "idle_tokens": int(moved.sum()),
                              "live_routes": int(crossed.sum())}
    return None


def hold_mix(label, got, want, meters) -> dict:
    """The float32 gate. Every stream of ``got`` equals ``want``'s, or
    first differs at a token made at or after the step at which the runs
    first part (:func:`route_split`: a live token's route flip, itself
    held to a near-tie, idle slots' routes moving live routes across the
    capacity, or tokens that differ), or at a row whose top-2 logit margin
    is under ``NEAR_TIE`` in one of the two runs (``meters``)."""
    split = route_split(label, *meters)
    at = split[0] if split else None
    same, after, logit_ties = 0, 0, 0
    for rid, w in want.items():
        i = _first_diff(got[rid], w)
        if i is None:
            same += 1
            continue
        ticks = {m.made[(rid, i)][0] for m in meters if (rid, i) in m.made}
        check(len(ticks) == 1, f"{label}: request {rid}'s token {i} was made "
                               f"at one step in both runs")
        tick = ticks.pop()
        logit_m = min(m.margin(rid, i) for m in meters)
        print(f"{label}: request {rid} first differs at generated token {i} "
              f"({got[rid][i] if i < len(got[rid]) else None} vs "
              f"{w[i] if i < len(w) else None}), made at step {tick} (the "
              f"runs first part at step {at}); top-2 logit margin "
              f"{logit_m:.3e}")
        if at is not None and tick >= at:
            after += 1
        else:
            check(logit_m < NEAR_TIE,
                  f"{label}: request {rid} differs before the runs part, "
                  f"so only at a logit near-tie ({logit_m:.3e} < {NEAR_TIE})")
            logit_ties += 1
    print(f"{label}: {same} of {len(want)} streams equal token for token, "
          f"{after} part at or after the step the runs part, {logit_ties} "
          f"at logit near-ties")
    return {"streams_equal": same, "streams": len(want),
            "after_route_split": after, "at_logit_ties": logit_ties,
            "split": None if split is None else dict(step=at, **split[1])}


def mix_card_vs_cpu(torch) -> dict:
    """The reduced mixtral (a 32-entry ring, float32) in a paged engine on
    the card and on the CPU port (:func:`card_vs_cpu`); the steps compared
    include extends past the ring's wrap."""
    from repro_torch.configs import registry
    r = MIX_REDUCED
    cfg = registry.get(MIX_ARCH).reduced().replace(
        dtype="float32", sliding_window=r["window"])
    rng = np.random.default_rng(MIX_SEED + 3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in r["prompts"]]
    compared, worst, end = card_vs_cpu(torch, "mixtral", cfg, prompts,
                                       r["chunk"], r["ticks"], MIX_SEED)
    check(end > r["window"], "mixtral card vs CPU: steps past the ring's "
                             "wrap compared")
    return {"steps_compared": compared, "logits_max_abs_err": worst}


def _op_ms(prof: dict, names) -> float:
    """Device time (ms) of the aten ops named (their kernels' time)."""
    return sum(v for k, v in prof["ops_ms"].items() if k in names)


def mix_profile(torch, model) -> dict:
    """One warm 256-row extend step past the wrap (8 slots of 4352-token
    prompts, the 17th chunk: positions 4096-4351) and one warm decode step
    on the wrapped rings, bf16: the experts' products (``aten::bmm``), the
    dispatch scatter and gather, and the paged kernel as shares of the
    device time."""
    from repro_torch.serve import Engine, Request
    rng = np.random.default_rng(MIX_SEED + 4)
    eng = Engine(model, paged=True, **MIX_KW)
    for rid in range(MIX_KW["batch_slots"]):
        eng.submit(Request(rid, rng.integers(0, model.cfg.vocab_size,
                                             MIX_PROFILE_PROMPT).astype(
                                                 np.int32), max_new=8))
    chunks = MIX_PROFILE_PROMPT // MIX_KW["prefill_chunk"]
    for _ in range(chunks - 1):
        eng.step()
    out = {}
    for label, extra in (("extend", 0), ("decode", 2)):
        for _ in range(extra):
            eng.step()
        plan, _ = eng._compose()
        prof = _profile(torch, f"mixtral bf16 {label} step ({plan.width} "
                               f"rows x {plan.tokens.shape[0]} slots, pos "
                               f"{int(plan.pos.min())})", eng.step)
        busy = prof["busy_ms"]
        parts = {"experts": _op_ms(prof, ("aten::bmm",)),
                 "dispatch_scatter": _op_ms(prof, ("aten::scatter_",)),
                 "combine_gather": _op_ms(prof, ("aten::gather",)),
                 "paged": busy * _share(prof, "paged_")}
        shares = {k: v / busy if busy else 0.0 for k, v in parts.items()}
        print(f"mixtral bf16 {label} step: shares of device time "
              + ", ".join(f"{k} {v:.4f}" for k, v in shares.items()))
        out[label] = dict(busy_ms=busy, wall_ms=prof["wall_ms"], ms=parts,
                          shares=shares)
    return out


def mixtral_path(torch) -> dict:
    """mixtral-8x7b at full width (depth cut): the card against
    the CPU port at reduced width, the float32 gate (paged through the
    kernel with the window bound against the contiguous ring form), the
    bf16 run with its drops, and the bf16 profiles."""
    from repro_torch.configs import registry
    from repro_torch.models.model import Model
    from repro_torch.serve import Engine
    cfg = registry.get(MIX_ARCH)
    prompts = mix_prompts(cfg.vocab_size)
    per_layer = (Model(cfg.replace(num_layers=2), device="cpu").n_params()
                 - Model(cfg.replace(num_layers=1), device="cpu").n_params())
    full_gb = (Model(cfg, device="cpu").n_params() * 2) / 1e9
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    print(f"mixtral: {MIX_ARCH} at full width (d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, "
          f"{cfg.num_experts} experts top-{cfg.num_experts_per_tok} of "
          f"{cfg.moe_d_ff}, window {cfg.sliding_window}); one layer "
          f"{per_layer} parameters, the {cfg.num_layers} layers {full_gb:.1f}"
          f" GB in bf16 against the card's {card_gb:.1f} GB: depth cut to "
          f"{MIX_LAYERS['bfloat16']} layers in bf16 (the deepest that fits "
          f"with headroom) and {MIX_LAYERS['float32']} in float32 (the "
          f"gate's time)")
    out = {"depth": dict(MIX_LAYERS), "layer_params": per_layer,
           "full_bf16_gb": full_gb,
           "card_vs_cpu": mix_card_vs_cpu(torch)}

    # 1. the float32 gate: paged (the kernel, window bound, scratch pages)
    # against contiguous (the ring form of _sdpa)
    n32 = MIX_LAYERS["float32"]
    m32 = Model(cfg.replace(dtype="float32", param_dtype="float32",
                            num_layers=n32)).init(MIX_SEED)
    eng = Engine(m32, paged=True, **MIX_KW)
    check(eng.mgr.seq_len == cfg.sliding_window
          and eng.mgr.scratch_table is not None,
          "mixtral: the paged slot is a 4096-entry ring with scratch pages")
    meters = [_MixMeter(torch, eng, keep_routes=True)]
    reset_counts()
    paged, ticks, wall = drive(eng, prompts)
    counts = read_counts()
    n_steps = sum(1 for w, _, _, _ in ticks if w > 0)
    print(f"mixtral gate float32 paged: wall {wall:.3f} s, {n_steps} model "
          f"steps, launches {counts}")
    check(counts["paged_attention"] == n_steps * n32,
          f"mixtral paged launches == model steps x {n32} layers")
    out["gate_counts"] = counts
    out["gate"] = dict(_tick_times(ticks), wall_s=wall,
                       drops=meters[0].drop_shares())
    del eng
    eng = Engine(m32, **MIX_KW)
    meters.append(_MixMeter(torch, eng, keep_routes=True))
    cont, _, wall_c = drive(eng, prompts)
    print(f"mixtral gate float32 contiguous: wall {wall_c:.3f} s")
    out["gate_hold"] = hold_mix(
        "mixtral float32 paged vs contiguous", paged, cont, meters)
    for rid in sorted(paged):
        print(f"  request {rid} ({len(prompts[rid])} prompt tokens): "
              f"{paged[rid][:8]}...")
    print(f"mixtral float32 drops (paged run): {meters[0].drop_shares()}")
    del eng, meters, m32
    gc.collect()
    torch.cuda.empty_cache()

    # 2. bf16, the working type: times, launches, peak memory; agreement
    # with the contiguous engine and the drops reported
    n16 = MIX_LAYERS["bfloat16"]
    torch.cuda.reset_peak_memory_stats()
    m16 = Model(cfg.replace(param_dtype="bfloat16",
                            num_layers=n16)).init(MIX_SEED)
    init_peak = torch.cuda.max_memory_allocated()
    print(f"mixtral bf16 ({n16} layers): weights "
          f"{torch.cuda.memory_allocated() / 2 ** 20:.1f} MiB, the init's "
          f"peak {init_peak / 2 ** 20:.1f} MiB")
    eng = Engine(m16, paged=True, **MIX_KW)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    got16, tt = serve_bf16_run(torch, eng, prompts)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"mixtral bf16 paged ({n16} layers): wall {tt['wall_s']:.3f} s, "
          f"{tt['tokens']} tokens, {tt['tokens_per_s']:.1f} tokens/s, decode "
          f"tick {tt['decode_tick_s']:.5f} s ({tt['decode_ticks']}), extend "
          f"tick {tt['prefill_tick_s']:.5f} s ({tt['prefill_ticks']}), "
          f"launches {counts}, peak memory {peak / 2 ** 20:.1f} MiB")
    check(counts["paged_attention"] == (tt["decode_ticks"]
                                        + tt["prefill_ticks"]) * n16,
          f"mixtral bf16: paged launches == model steps x {n16} layers")
    del eng
    eng = Engine(m16, **MIX_KW)
    meter = _MixMeter(torch, eng)
    cont16, _, _ = drive(eng, prompts)
    agree = sum(a == b for rid in cont16
                for a, b in zip(got16[rid], cont16[rid]))
    total = sum(len(v) for v in cont16.values())
    same = sum(got16[rid] == cont16[rid] for rid in cont16)
    drops = meter.drop_shares()
    print(f"mixtral bf16 paged vs contiguous (reported): {same} of "
          f"{len(cont16)} streams equal, {agree} of {total} tokens agree "
          f"position by position; routes dropped by capacity (contiguous "
          f"run): {drops}")
    out["bf16"] = dict(tt, counts=counts, peak_memory_bytes=peak,
                       init_peak_memory_bytes=init_peak,
                       streams_equal_contiguous=same,
                       tokens_agree_contiguous=agree, tokens_total=total,
                       drops=drops)
    del eng, meter
    out["profile"] = mix_profile(torch, m16)
    del m16
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --- the deepseek-v2 serve path: MLA through the engine (phase 10e) -----------
DS_ARCH = "deepseek-v2-236b"
DS_SEED = 0
# the depth cut: an MoE layer is ~3.97 B parameters (its 160 experts 3.77
# B), the dense first layer ~0.34 B, the embedding and unembedding ~1.05 B,
# so the 60 layers (~236 B) are far past the card's 85 GB. The bf16 run
# takes the deepest stack that fits with headroom: the init draws each
# stacked expert leaf in float32 beside the bf16 weights (5.03 GB a MoE
# layer at its peak), so 1 dense + 5 MoE layers peak near 68 GB (6 would
# reach ~81 GB). The float32 gate serves the traffic twice: 1 dense + 1
# MoE layer (~5.4 B parameters, ~21.6 GB).
DS_LAYERS = {"float32": 2, "bfloat16": 6}
DS_REDUCED = dict(chunk=12, ticks=6, prompts=[60, 45, 12, 3, 33, 50, 27, 8])
# a capacity factor at which no route can be dropped (reported, not
# gated): each expert's capacity is the dispatch group's token count
DS_DROPLESS = 160 / 6 * (1 + 1e-6)


def card_vs_cpu(torch, label, cfg, prompts, chunk, ticks, seed):
    """A reduced model (float32) in a paged engine on the card and on the
    CPU port, the same weights and traffic, ticks compared in turn: each
    model step's routes (the experts chosen and the capacity's kept
    routes, every MoE layer) equal, or differing only at router near-ties,
    and its logits within 1e-4, step by step while the sampled streams
    agree. Returns (steps compared, worst logit difference, the largest
    position written)."""
    from repro_torch.models import moe
    from repro_torch.models.model import Model
    from repro_torch.serve import Engine, Request
    cpu = Model(cfg, device="cpu").init(seed)
    models = {"card": Model(cfg).load_reference(cpu.weights()), "cpu": cpu}
    seen = {}
    for name, model in models.items():
        eng = Engine(model, paged=True, batch_slots=len(prompts), max_len=64,
                     page_size=16, prefill_chunk=chunk, eos_id=-1)
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid, p, max_new=8))
        steps = seen[name] = []

        def capture(tokens, pos, n_valid, _step=eng.step_logits, _s=steps):
            with moe.capture_routes() as routes:
                logits = _step(tokens, pos, n_valid)
            _s.append({"end": int((pos + n_valid).max()), "routes": routes,
                       "logits": logits.cpu()})
            return logits

        eng.step_logits = capture
        for _ in range(ticks):
            eng.step()
            steps[-1]["streams"] = [None if q is None else list(q.out)
                                    for q in eng.slot_req]
    worst, compared, end = 0.0, 0, 0
    k = cfg.num_experts_per_tok
    for t, (a, b) in enumerate(zip(seen["card"], seen["cpu"])):
        for la, lb in zip(a["routes"], b["routes"]):
            idx_a, idx_b = la["idx"].cpu(), lb["idx"]
            if torch.equal(idx_a, idx_b):
                check(torch.equal(la["keep"].cpu(), lb["keep"]),
                      f"{label} card vs CPU, step {t}: the kept routes")
                continue
            bad = (idx_a != idx_b).any(-1)
            m = float(moe.route_margin(lb["logits"], k)[bad].max())
            print(f"{label} card vs CPU, step {t}: {int(bad.sum())} routes "
                  f"differ, largest margin {m:.3e}")
            check(m < ROUTE_TIE, f"{label} card vs CPU: routes differ only "
                                 f"at near-ties")
        worst = max(worst, float((a["logits"] - b["logits"]).abs().max()))
        compared += 1
        end = max(end, a["end"])
        if a["streams"] != b["streams"]:
            print(f"{label} card vs CPU: the streams part after step {t}")
            break
    print(f"{label} card vs CPU (reduced, chunks of {chunk}): {compared} "
          f"steps compared, positions up to {end}, logits within "
          f"{worst:.3e}")
    check(compared >= 3, f"{label} card vs CPU: steps compared")
    check(worst <= 1e-4, f"{label} card vs CPU: logits within 1e-4")
    return compared, worst, end


@contextlib.contextmanager
def _capacity(model, cf):
    """The model's MoE capacity factor set to ``cf`` inside the block
    (None: the config's)."""
    cfg = model.cfg
    if cf is not None:
        model.cfg = cfg.replace(moe_capacity_factor=cf)
    try:
        yield
    finally:
        model.cfg = cfg


def ds_spec(torch, model, prompts, cf) -> dict:
    """bf16 ``speculate=3`` against greedy on ``prompts`` (paged), the
    model's capacity factor set to ``cf`` for the two runs (None: the
    config's). At the dropless ``cf`` no real route is dropped in either
    run, and every stream equals greedy's: each verify row takes its decode
    row's arithmetic (:func:`row_probe`). At the config's capacity a verify
    chunk's rows share the dispatch group's capacity, so the reference's
    own engine departs from greedy where the chunk's routes overflow an
    expert (``tests/test_torch_mla.py``, ROADMAP queue 3): a stream may
    depart only at a token before which, past its prompt, the capacity
    dropped routes of that request's own real tokens in one run or the
    other (:meth:`_MixMeter.own_drops`)."""
    from repro_torch.serve import Engine
    label = "dropless" if cf is not None else "capacity"
    with _capacity(model, cf):
        eng = Engine(model, paged=True, **SERVE_KW)
        meters = {"greedy": _MixMeter(torch, eng)}
        greedy, _, _ = drive(eng, prompts, late=False)
        eng = Engine(model, paged=True, speculate=3, **SERVE_KW)
        meters["speculative"] = _MixMeter(torch, eng)
        spec, _, wall = drive(eng, prompts, late=False)
    drops = {name: m.drop_shares() for name, m in meters.items()}
    real_dropped = sum(kind["real_dropped"] for d in drops.values()
                       for kind in d.values())
    same, departures = 0, {}
    for rid in greedy:
        i = _first_diff(spec[rid], greedy[rid])
        if i is None:
            same += 1
            continue
        own = {name: m.own_drops(rid, i) for name, m in meters.items()}
        departures[str(rid)] = dict(token=i, own_drops=own)
        print(f"deepseek bf16 {label} speculate=3: request {rid} departs "
              f"from greedy at token {i} ({spec[rid][i:i + 3]} vs "
              f"{greedy[rid][i:i + 3]}); the routes of its own real tokens "
              f"dropped by the capacity up to there: {own}")
        if cf is None:
            check(sum(own.values()) > 0,
                  f"deepseek bf16 capacity: request {rid} departs from "
                  f"greedy only after the capacity dropped routes of its "
                  f"own real tokens")
    print(f"deepseek bf16 {label} speculate=3 vs greedy (two repeating "
          f"prompts): {same} of {len(greedy)} streams equal, "
          f"{eng.spec_accepted} of {eng.spec_proposed} drafts accepted, "
          f"real routes dropped {real_dropped}, wall {wall:.3f} s")
    check(eng.spec_accepted > 0, f"deepseek bf16 {label}: drafts accepted")
    if cf is not None:
        check(real_dropped == 0, "deepseek bf16 dropless: no real token's "
                                 "route dropped in either run")
        check(same == len(greedy), "deepseek bf16 dropless: speculate=3 "
                                   "serves greedy's streams")
    return {"streams_equal": same, "streams": len(greedy),
            "departures": departures, "real_routes_dropped": real_dropped,
            "drops": drops, "accepted": eng.spec_accepted,
            "proposed": eng.spec_proposed, "wall_s": wall}


def ds_profile(torch, model) -> dict:
    """One warm 256-row extend step (8 slots, positions 256-511) and one
    warm decode step of the bf16 paged engine: MLA's einsums, the batched
    products (the experts' and the einsums'), the dispatch scatter and the
    combine gather as shares of the device time."""
    from repro_torch.serve import Engine, Request
    rng = np.random.default_rng(DS_SEED + 4)
    eng = Engine(model, paged=True, **SERVE_KW)
    for rid in range(SERVE_KW["batch_slots"]):
        eng.submit(Request(rid, rng.integers(0, model.cfg.vocab_size, 600)
                           .astype(np.int32), max_new=8))
    eng.step()
    out = {}
    for label, extra in (("extend", 0), ("decode", 2)):
        for _ in range(extra):
            eng.step()
        plan, _ = eng._compose()
        prof = _profile(torch, f"deepseek bf16 {label} step ({plan.width} "
                               f"rows x {plan.tokens.shape[0]} slots, pos "
                               f"{int(plan.pos.min())})", eng.step)
        busy = prof["busy_ms"]
        parts = {"mla_einsums": _op_ms(prof, ("aten::einsum",)),
                 "batched_products": _op_ms(prof, ("aten::bmm",)),
                 "dispatch_scatter": _op_ms(prof, ("aten::scatter_",)),
                 "combine_gather": _op_ms(prof, ("aten::gather",))}
        shares = {k: v / busy if busy else 0.0 for k, v in parts.items()}
        print(f"deepseek bf16 {label} step: shares of device time "
              + ", ".join(f"{k} {v:.4f}" for k, v in shares.items()))
        out[label] = dict(busy_ms=busy, wall_ms=prof["wall_ms"], ms=parts,
                          shares=shares)
    return out


def deepseek_path(torch) -> dict:
    """deepseek-v2-236b at full width (depth cut): MLA's compressed cache
    through the engine, paged and contiguous, in plain PyTorch (no kernel:
    its heads do not fit the flash or paged kernel, and the reference
    computes it outside any Pallas kernel). The card against the CPU port
    at reduced width, the float32 gate (paged against contiguous, routes
    compared step by step), the bf16 run with its drops, bf16
    ``speculate=3`` against greedy on the two repeating prompts
    (:func:`ds_spec`: with a capacity that drops nothing, greedy's
    streams; at the config's, departures only after the capacity dropped
    the request's own routes), the row probe at the dropless capacity, and
    the step profiles."""
    from repro_torch.configs import registry
    from repro_torch.models.model import Model
    from repro_torch.serve import Engine
    cfg = registry.get(DS_ARCH)
    prompts = serve_prompts(cfg.vocab_size)
    n_par = lambda n: Model(cfg.replace(num_layers=n),
                            device="cpu").n_params()
    moe_layer, outer = n_par(3) - n_par(2), n_par(1)
    full_gb = n_par(cfg.num_layers) * 2 / 1e9
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    print(f"deepseek: {DS_ARCH} at full width (d_model {cfg.d_model}, "
          f"{cfg.num_heads} MLA heads, q_lora {cfg.q_lora_rank}, kv_lora "
          f"{cfg.kv_lora_rank}, {cfg.num_experts} experts top-"
          f"{cfg.num_experts_per_tok} of {cfg.moe_d_ff} + "
          f"{cfg.num_shared_experts} shared, vocab {cfg.vocab_size}); an MoE "
          f"layer {moe_layer} parameters, the dense layer with the embeddings "
          f"{outer}, the {cfg.num_layers} layers {full_gb:.1f} GB in bf16 "
          f"against the card's {card_gb:.1f} GB: depth cut to "
          f"{DS_LAYERS['bfloat16']} layers in bf16 and "
          f"{DS_LAYERS['float32']} in float32")
    r = DS_REDUCED
    rcfg = registry.get(DS_ARCH).reduced().replace(dtype="float32")
    rng = np.random.default_rng(DS_SEED + 3)
    steps, worst, _ = card_vs_cpu(
        torch, "deepseek", rcfg,
        [rng.integers(0, rcfg.vocab_size, n).astype(np.int32)
         for n in r["prompts"]], r["chunk"], r["ticks"], DS_SEED)
    out = {"depth": dict(DS_LAYERS), "moe_layer_params": moe_layer,
           "dense_and_embeddings_params": outer, "full_bf16_gb": full_gb,
           "card_vs_cpu": {"steps_compared": steps,
                           "logits_max_abs_err": worst}}

    # 1. the float32 gate: paged (the compressed rows in pages) against
    # contiguous, one schedule, routes compared step by step
    n32 = DS_LAYERS["float32"]
    m32 = Model(cfg.replace(dtype="float32", param_dtype="float32",
                            num_layers=n32)).init(DS_SEED)
    eng = Engine(m32, paged=True, **SERVE_KW)
    check(set(eng.mgr.pool["stack"]) == {"c_kv", "k_rope", "pos_ids"},
          "deepseek: the page pool holds MLA's compressed rows")
    meters = [_MixMeter(torch, eng, keep_routes=True)]
    reset_counts()
    paged, ticks, wall = drive(eng, prompts)
    counts = read_counts()
    n_steps = sum(1 for w, _, _, _ in ticks if w > 0)
    print(f"deepseek gate float32 paged: wall {wall:.3f} s, {n_steps} model "
          f"steps, launches {counts} (MLA runs no kernel)")
    out["gate_counts"] = counts
    out["gate"] = dict(_tick_times(ticks), wall_s=wall,
                       drops=meters[0].drop_shares())
    del eng
    eng = Engine(m32, **SERVE_KW)
    meters.append(_MixMeter(torch, eng, keep_routes=True))
    cont, _, wall_c = drive(eng, prompts)
    print(f"deepseek gate float32 contiguous: wall {wall_c:.3f} s")
    out["gate_hold"] = hold_mix(
        "deepseek float32 paged vs contiguous", paged, cont, meters)
    for rid in sorted(paged):
        print(f"  request {rid} ({len(prompts[rid])} prompt tokens): "
              f"{paged[rid][:8]}...")
    del eng, meters, m32
    gc.collect()
    torch.cuda.empty_cache()

    # 2. bf16: times, peak memory, drops; speculate=3 against greedy
    n16 = DS_LAYERS["bfloat16"]
    torch.cuda.reset_peak_memory_stats()
    m16 = Model(cfg.replace(param_dtype="bfloat16",
                            num_layers=n16)).init(DS_SEED)
    init_peak = torch.cuda.max_memory_allocated()
    print(f"deepseek bf16 ({n16} layers): weights "
          f"{torch.cuda.memory_allocated() / 2 ** 20:.1f} MiB, the init's "
          f"peak {init_peak / 2 ** 20:.1f} MiB")
    eng = Engine(m16, paged=True, **SERVE_KW)
    meter = _MixMeter(torch, eng)
    torch.cuda.reset_peak_memory_stats()
    got16, tt = serve_bf16_run(torch, eng, prompts)
    peak = torch.cuda.max_memory_allocated()
    drops = meter.drop_shares()
    print(f"deepseek bf16 paged ({n16} layers): wall {tt['wall_s']:.3f} s, "
          f"{tt['tokens']} tokens, {tt['tokens_per_s']:.1f} tokens/s, decode "
          f"tick {tt['decode_tick_s']:.5f} s ({tt['decode_ticks']}), prefill "
          f"tick {tt['prefill_tick_s']:.5f} s ({tt['prefill_ticks']}), peak "
          f"memory {peak / 2 ** 20:.1f} MiB; routes dropped by capacity "
          f"{drops}")
    out["bf16"] = dict(tt, peak_memory_bytes=peak,
                       init_peak_memory_bytes=init_peak, drops=drops)
    del eng, meter
    out["spec"] = {label: ds_spec(torch, m16, prompts[:2], cf) for label, cf
                   in (("dropless", DS_DROPLESS), ("capacity", None))}
    with _capacity(m16, DS_DROPLESS):
        out["row_probe"] = {
            label: row_probe(torch, m16, prompts[:2], whole,
                             title="deepseek ")
            for label, whole in (("one product", True), ("by column", False))}
    check(out["row_probe"]["by column"]["logits_equal"],
          "deepseek bf16 (dropless): verify rows equal their decode rows bit "
          "for bit (logits)")
    out["profile"] = ds_profile(torch, m16)
    del m16
    gc.collect()
    torch.cuda.empty_cache()
    out["card"] = smi_line()
    print(f"deepseek path on {out['card']}")
    return out


# --- the multimodal serve path: llama-3.2-vision and whisper (phase 10f) -----
MM_ARCHS = {"vlm": "llama-3.2-vision-11b", "whisper": "whisper-small"}
MM_SEED = 0
MM_PROMPTS = [37, 100, 200, 256]  # 4 requests
MM_NEW = 32
MM_MAX_LEN = MM_PROMPTS[-1] + MM_NEW
# the float32 gate runs the traffic twice, once through the plain versions:
# the float32 flash plain version takes ~0.3 s a call at these cross
# shapes (one launch per head dim per 16 keys), so the gate's depth is cut
# (vlm: 1 group of 5 self + 1 cross block; whisper: 1 encoder + 1 decoder
# layer); the bf16 runs take the full depth
MM_F32_DEPTH = {"vlm": dict(num_layers=5),
                "whisper": dict(num_layers=1, encoder_layers=1)}
# and its streams are cut to 8 new tokens (at 32 the plain decode took
# 20.3 s of the vlm's 49 s and 11.9 s of whisper's 45 s on the H100); the
# bf16 runs decode MM_NEW
MM_F32_NEW = 8
# the bf16 runs' depth, cut to half (to pay for phase 13e: the prefill
# gates' plain bf16 attention, a float64 model of the tensor cores, took
# most of each path): vlm 4 groups of 5 self + 1 cross block, whisper 6
# encoder and 6 decoder layers
MM_BF16_DEPTH = {"vlm": dict(num_layers=20),
                 "whisper": dict(num_layers=6, encoder_layers=6)}


def mm_inputs(torch, cfg):
    """The 4 requests' prompts (numpy, from the seed) and their frontend
    embeddings, 0.1 N(0, 1) of (4, n, d_model) as the reference's tests
    draw them, from a ``torch.Generator`` on the card."""
    rng = np.random.default_rng(MM_SEED + 5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in MM_PROMPTS]
    g = torch.Generator(device=DEV)
    g.manual_seed(MM_SEED)
    key, n = (("image_embeds", cfg.num_image_tokens) if cfg.family == "vlm"
              else ("audio_frames", cfg.encoder_frames))
    emb = 0.1 * torch.randn((len(prompts), n, cfg.d_model), generator=g,
                            device=DEV)
    return prompts, key, emb


def mm_serve(torch, model, prompts, key, emb, new=MM_NEW,
             profile=None) -> dict:
    """The requests through ``serve/step``: each one's prefill step at its
    exact length (batch 1, its own embeddings), the four caches joined on
    their slot axes, then ``new`` greedy decode steps of all four at their
    own positions. Returns the streams, every step's top-2 logit margin
    per row, the launches and times of the prefills and of the decode;
    with ``profile`` (a label) one more decode step profiled."""
    from repro_torch.serve import make_decode_step, make_prefill_step
    from repro_torch.serve.cache import slot_axes, tree_map
    prefill = make_prefill_step(model, MM_MAX_LEN)
    decode = make_decode_step(model)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lasts, caches = [], []
    for i, p in enumerate(prompts):
        last, cache = prefill({"tokens": torch.as_tensor(p, device=DEV)[None],
                               key: emb[i:i + 1]})
        lasts.append(last)
        caches.append(cache)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    pre_counts = read_counts()
    cache = tree_map(lambda path, ax, *leaves: torch.cat(leaves, dim=ax),
                     slot_axes(model, MM_MAX_LEN), *caches)
    del caches
    last = torch.cat(lasts)
    pos = torch.as_tensor([len(p) for p in prompts], device=DEV)
    toks, margins = [], []
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(new):
        top = torch.topk(last.float(), 2).values
        margins.append(top[:, 0] - top[:, 1])
        toks.append(torch.argmax(last, -1))
        last, cache = decode(cache, toks[-1][:, None], pos + t)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    counts = read_counts()
    prof = None if profile is None else _profile(
        torch, profile, lambda: decode(cache, toks[-1][:, None], pos + new))
    streams = torch.stack(toks, 1).cpu().numpy()
    return {"streams": {i: streams[i].tolist() for i in range(len(prompts))},
            "margins": torch.stack(margins, 1).cpu().numpy(),
            "prefill_counts": pre_counts, "decode_counts": counts,
            "prefill_s": t_pre, "decode_s": t_dec, "profile": prof}


def _mm_card_vs_cpu(torch, name, cfg) -> float:
    """The reduced model (float32) on the card and on the CPU port, the
    same weights and inputs: the forward, a prefill of 24 tokens and 4
    decode steps; the largest logit difference."""
    from repro_torch.models.model import Model
    cpu = Model(cfg, device="cpu").init(MM_SEED)
    card = Model(cfg).load_reference(cpu.weights())
    prompts, key, emb = mm_inputs(torch, cfg)
    toks = np.stack([p[:32] for p in prompts])

    def run(m, dev):
        batch = {"tokens": torch.as_tensor(toks, device=dev),
                 key: emb.to(dev)}
        got = [m.apply(batch)[0]]
        lg, c = m.prefill({**batch, "tokens": batch["tokens"][:, :24]},
                          max_len=32)
        got.append(lg)
        for t in range(24, 28):
            lg, c = m.decode(batch["tokens"][:, t:t + 1], c, t)
            got.append(lg)
        return [x.cpu() for x in got]

    worst = max(float((a - b).abs().max())
                for a, b in zip(run(card, DEV), run(cpu, "cpu")))
    print(f"{name} card vs CPU (reduced): forward, prefill and 4 decode "
          f"steps, logits within {worst:.3e}")
    check(worst <= 1e-4, f"{name} card vs CPU: logits within 1e-4")
    return worst


def _mm_flash(cfg):
    """(flash calls a prefill, a decode step): every self-attention layer,
    cross block and encoder layer of a prefill; every cross step of a
    decode step."""
    if cfg.family == "vlm":
        n_cross = cfg.num_layers // cfg.cross_attn_every
        return n_cross * (cfg.cross_attn_every + 1), n_cross
    return 2 * cfg.num_layers + cfg.encoder_layers, cfg.num_layers


def mm_path(torch, name: str) -> dict:
    """One multimodal model at full width through ``serve/step``: the card
    against the CPU port at reduced width, the float32 gate (the kernels
    against their plain versions, depth cut), and the bf16 run at half
    depth (``MM_BF16_DEPTH``) with the flash launches per prefill and
    decode step and the prefill held to the plain path (|d logits| <=
    0.06, top-1 > 0.95)."""
    from repro_torch.configs import registry
    from repro_torch.models import attention as attn
    from repro_torch.models.model import Model
    cfg = registry.get(MM_ARCHS[name])
    vlm = cfg.family == "vlm"
    c16 = cfg.replace(param_dtype="bfloat16", **MM_BF16_DEPTH[name])
    per_prefill, n_cross = _mm_flash(c16)
    out = {"arch": cfg.name, "bf16_depth": MM_BF16_DEPTH[name],
           "flash_per_prefill": per_prefill,
           "flash_per_decode_step": n_cross}

    out["card_vs_cpu_logits_max_abs_err"] = _mm_card_vs_cpu(
        torch, name, cfg.reduced().replace(dtype="float32"))

    # 1. the float32 gate: kernels against plain versions, depth cut
    c32 = cfg.replace(dtype="float32", param_dtype="float32",
                      **MM_F32_DEPTH[name])
    m32 = Model(c32).init(MM_SEED)
    prompts, key, emb = mm_inputs(torch, c32)
    k32 = mm_serve(torch, m32, prompts, key, emb, new=MM_F32_NEW)
    with attn.plain_kernels():
        p32 = mm_serve(torch, m32, prompts, key, emb, new=MM_F32_NEW)
    pre32, n_c32 = _mm_flash(c32)
    want_pre = len(prompts) * pre32
    check(k32["prefill_counts"]["flash_attention"] == want_pre,
          f"{name} float32: flash launches == {want_pre} over the prefills")
    check(k32["decode_counts"]["flash_attention"] == MM_F32_NEW * n_c32,
          f"{name} float32: flash launches == {n_c32} per decode step")
    check(p32["prefill_counts"]["flash_attention"] == 0,
          f"{name} float32 plain: no kernel launched")
    same = 0
    for rid, w in p32["streams"].items():
        i = _first_diff(k32["streams"][rid], w)
        if i is None:
            same += 1
            continue
        m = float(min(k32["margins"][rid, i], p32["margins"][rid, i]))
        print(f"{name} float32 kernels vs plain: request {rid} first differs "
              f"at token {i}; top-2 margin {m:.3e}")
        check(m < NEAR_TIE, f"{name} float32: request {rid} differs only at "
                            f"a near-tie ({m:.3e} < {NEAR_TIE})")
    print(f"{name} float32 gate ({c32.num_layers} layers"
          f"{', ' + str(c32.encoder_layers) + ' encoder' if not vlm else ''}"
          f"): {same} of {len(prompts)} streams equal; prefills "
          f"{k32['prefill_s']:.3f} s through the kernels, "
          f"{p32['prefill_s']:.3f} s plain; decode {k32['decode_s']:.3f} / "
          f"{p32['decode_s']:.3f} s")
    out["gate"] = {"depth": MM_F32_DEPTH[name], "streams_equal": same,
                   "streams": len(prompts),
                   "prefill_counts": k32["prefill_counts"],
                   "decode_counts": k32["decode_counts"]}
    del m32, k32, p32
    gc.collect()
    torch.cuda.empty_cache()

    # 2. bf16 at half depth: launches, times, peak memory; the prefills
    # held to the plain path
    torch.cuda.reset_peak_memory_stats()
    m16 = Model(c16).init(MM_SEED)
    prompts, key, emb = mm_inputs(torch, cfg)
    mm_serve(torch, m16, prompts[:1], key, emb, new=2)  # warm-up
    k16 = mm_serve(torch, m16, prompts, key, emb,
                   profile=f"{name} bf16 decode step (4 rows)")
    peak = torch.cuda.max_memory_allocated()
    pre, dec = k16["prefill_counts"], k16["decode_counts"]
    check(pre["flash_attention"] == len(prompts) * per_prefill,
          f"{name} bf16: flash launches == {per_prefill} per prefill")
    check(dec["flash_attention"] == MM_NEW * n_cross,
          f"{name} bf16: flash launches == {n_cross} per decode step")
    tokens = len(prompts) * MM_NEW
    print(f"{name} bf16 ({m16.n_params()} parameters): {len(prompts)} "
          f"prefills {k16['prefill_s']:.3f} s, {MM_NEW} decode steps "
          f"{k16['decode_s']:.3f} s ({k16['decode_s'] / MM_NEW * 1e3:.3f} ms "
          f"a step, {tokens / k16['decode_s']:.1f} tokens/s), flash "
          f"{per_prefill} a prefill and {n_cross} a decode step, peak memory "
          f"{peak / 2 ** 20:.1f} MiB")
    gates = []
    for i, p in enumerate(prompts):
        batch = {"tokens": torch.as_tensor(p, device=DEV)[None],
                 key: emb[i:i + 1]}
        got = m16.prefill(batch, max_len=MM_MAX_LEN)[0]
        with attn.plain_kernels():
            want = m16.prefill(batch, max_len=MM_MAX_LEN)[0]
        gates.append(bf16_gate(torch, f"{name} bf16 prefill {i} ({len(p)} "
                                      f"tokens)", got, want))
    out["bf16"] = {"prefill_s": k16["prefill_s"],
                   "decode_s": k16["decode_s"],
                   "decode_step_ms": k16["decode_s"] / MM_NEW * 1e3,
                   "tokens_per_s": tokens / k16["decode_s"],
                   "prefill_counts": pre, "decode_counts": dec,
                   "peak_memory_bytes": peak, "prefill_gates": gates,
                   "n_params": m16.n_params(),
                   "decode_profile": {k: k16["profile"][k] for k in
                                      ("wall_ms", "busy_ms")}}
    out["launches"] = {"prefill": pre["flash_attention"],
                       "decode": dec["flash_attention"]}
    del m16, k16
    gc.collect()
    torch.cuda.empty_cache()
    out["card"] = smi_line()
    print(f"{name} path on {out['card']}")
    return out


# --- the §V accuracy-vs-rail study: llama3.2-1b through the ABFT kernel ------
STUDY_ARCH = "llama3.2-1b"
STUDY_SEED = 0
STUDY_TOKENS = (2, 24)  # examples/overscaling_study.py's accuracy_vs_rail


def routed_study(torch) -> dict:
    """The reference's ``accuracy_vs_rail`` at full width: llama3.2-1b (16
    layers, bf16, random weights from the seed) with its MLP products
    (``wg``, ``wu``, ``wd``) routed through ``AbftMatmul``
    (``tolerance.routed_matmuls``) at the study's rails (nominal, then
    0.730 V down to 0.700 V at 65 C): per rail the overshoot, the ledger,
    top-1 agreement with the clean forward and the forward's wall; each
    rail again through the plain version (``use_kernel=False``): equal
    ledgers and logits bit for bit."""
    from repro_torch.configs import registry
    from repro_torch.core import tpu_fleet as TF
    from repro_torch.models.model import Model
    from repro_torch.tolerance import (AbftMatmul, TimingFaultModel,
                                       routed_matmuls, topk_agreement)
    cfg = registry.get(STUDY_ARCH)
    model = Model(cfg).init(STUDY_SEED)
    n, s = STUDY_TOKENS
    tokens = torch.as_tensor(np.arange(n * s).reshape(n, s) % cfg.vocab_size,
                             device=DEV)
    clean = model.apply({"tokens": tokens})[0]
    fm = TimingFaultModel()
    rails = [TF.V_CORE_NOM] + [round(0.730 - 0.005 * i, 3) for i in range(7)]
    per_forward = 3 * cfg.num_layers
    rows, total = [], 0
    print(f"§V study: {STUDY_ARCH} ({cfg.num_layers} layers, "
          f"{cfg.d_model} -> {cfg.d_ff}), {n} x {s} tokens, 65 C")
    print(f"{'v_core':7s} {'overshoot':10s} {'checked':>8s} {'inj':>6s} "
          f"{'det':>6s} {'corr':>6s} {'esc':>6s} {'top1':>6s} {'wall ms':>9s}")
    for vc in rails:
        probs = fm.bit_probs(vc, TF.V_SRAM_NOM, SEC5_T)
        runs = {}
        for use_kernel in (True, False):
            mm = AbftMatmul(probs, 9, use_kernel=use_kernel, device=DEV)
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with routed_matmuls(mm):
                logits = model.apply({"tokens": tokens})[0]
            torch.cuda.synchronize()
            runs[use_kernel] = (mm, logits, time.perf_counter() - t0,
                                read_counts()["abft_matmul"])
        (mk, lk, wall, launches), (mp, lp, wall_p, lp_n) = runs[True], \
            runs[False]
        check(launches == per_forward and lp_n == 0,
              f"§V study {vc}: {per_forward} ABFT launches a forward "
              f"({launches})")
        total += launches
        check(mk.counters == mp.counters, f"§V study {vc}: ledger, kernel "
                                          f"== plain")
        check(torch.equal(lk, lp), f"§V study {vc}: logits, kernel == plain "
                                   f"bit for bit")
        c = mk.counters
        x_over = float(fm.overshoot(vc, TF.V_SRAM_NOM, SEC5_T))
        top1 = topk_agreement(lk, clean, k=1)
        print(f"{vc:<7.3f} {x_over:<10.4f} {c.checked:>8d} {c.injected:>6d} "
              f"{c.detected:>6d} {c.corrected:>6d} {c.escaped:>6d} "
              f"{top1:>6.3f} {wall * 1e3:>9.3f}")
        if x_over == 0.0:
            check(c.injected == 0 and c.escaped == 0,
                  f"§V study: guard-band rail {vc} injects nothing")
        rows.append(dict(v_core=vc, overshoot=x_over, ledger=vars(c),
                         top1=top1, wall_s=wall, plain_wall_s=wall_p))
    check(rows[0]["overshoot"] == 0.0 and rows[-1]["ledger"]["injected"] > 0,
          "§V study: the sweep spans the guard band and rails that inject")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    card = smi_line()
    print(f"§V study on {card}: {total} ABFT launches ({per_forward} a "
          f"forward)")
    return {"launches": total, "per_forward": per_forward, "rails": rows,
            "card": card}


# --- the Mamba2 SSD-scan kernel ---------------------------------------------------
# (b, S, H, P, G, N, chunk): the reference test's shapes (per-head B and C),
# then the recurrent models' prefills (one B/C group, chunk 256)
SCAN_REF_SHAPES = [(2, 128, 4, 16, 4, 32, 32), (2, 256, 8, 32, 8, 64, 64),
                   (2, 64, 2, 8, 2, 16, 64)]
SCAN_MODELS = {"mamba2": (48, 64, 128), "zamba2": (64, 64, 64)}  # H, P, N
SCAN_ARCH = {"mamba2": "mamba2-780m", "zamba2": "zamba2-1.2b"}
SCAN_PREFILL = [(B, S) for B in (1, 4) for S in (256, 512)]
# more than one B/C group at the models' widths: C B^T is shared by H / G
# heads, down to one head a group
SCAN_GROUPS = [("mamba2", (2, 512, 48, 64, 4, 128, 256)),
               ("mamba2", (2, 512, 48, 64, 48, 128, 256)),
               ("zamba2", (2, 256, 64, 64, 2, 64, 256))]
SCAN_ORACLE_TOL = 2e-4  # tests/test_kernels.py: kernel vs ssd_chunked


def scan_cases() -> list:
    """(name, (b, S, H, P, G, N, chunk)) of phase 9: the reference test's
    shapes ("ref", held but not timed), each model's prefills at S = 256 and
    512, B = 1 and 4, every other prompt length that path 11 prefills at
    B = 1, and the group cases."""
    cases = [("ref", sh) for sh in SCAN_REF_SHAPES]
    for name, (H, P, N) in SCAN_MODELS.items():
        _, lengths, late, _, _ = REC_SERVE[SCAN_ARCH[name]]
        others = sorted(set(lengths + [late]) - {S for _, S in SCAN_PREFILL})
        cases += [(name, (B, S, H, P, 1, N, 256))
                  for B, S in SCAN_PREFILL + [(1, S) for S in others]]
    return cases + SCAN_GROUPS


def scan_inputs(torch, b, S, H, P, G, N, dtype, g):
    """The reference test's scales: x 0.5 N(0,1), dt softplus(N(0,1)),
    A = -exp(0.3 N(0,1)), B and C 0.3 N(0,1)."""
    r = lambda *shape: torch.randn(shape, generator=g, device=DEV)
    xh = (0.5 * r(b, S, H, P)).to(dtype)
    dt = torch.nn.functional.softplus(r(b, S, H)).to(dtype)
    A = -torch.exp(0.3 * r(H))
    return (xh, dt, A, (0.3 * r(b, S, G, N)).to(dtype),
            (0.3 * r(b, S, G, N)).to(dtype))


def scan_bound(b, S, H, P, G, N, chunk, dtype, elem):
    """(ms, "bytes" | "operations"): x, dt, B, C and A read once, y and the
    final state written once, against the least work the function needs.
    The lower triangle of C B^T (Q(Q+1)/2 N multiply-adds) depends on
    (b, group, chunk) alone, so it is counted once per group and chunk; it
    takes two operands of the inputs' type, so it is priced at that type's
    peak (bf16 tensor cores for bf16 inputs). The weighted sum over x, the
    read-out and the state update (Q(Q+1)/2 P + 2 Q P N per chunk and
    head) each have a float32 operand (the weights, the state, the decay)
    and are priced at the float32 rate of the CUDA cores. Both rates are
    the earlier bound's, the published peaks every bound here uses."""
    Q = min(chunk, S)
    nbytes = (elem * (2 * b * S * H * P + b * S * H + 2 * b * S * G * N)
              + 4 * H + 4 * b * H * P * N)
    flops = 2.0 * (S // Q) * b  # per multiply-add and chunk
    t_ops = (flops * G * (Q * (Q + 1) // 2 * N) / _peak(dtype)
             + flops * H * (Q * (Q + 1) // 2 * P + 2 * Q * P * N)
             / FP32_FLOP_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def scan_timing(torch) -> dict:
    """The scan kernel's time per call at every timed case of phase 9
    (all but "ref"), float32 and bfloat16, through whichever
    ``repro_torch`` is first on the path: CUDA events over back-to-back
    calls after warm-up (``ms``, ``_time_ms``; at the short prompts the
    host's time per call), and on the card alone (``graph_ms``, 20 calls
    in one CUDA graph, ``_graph_ms``). Phase 9 and ``tools/scan_ab.py``
    both time with it, so every tree is measured by the same code."""
    from repro_torch.kernels import mamba_scan as MS
    g = torch.Generator(device=DEV)
    g.manual_seed(31)
    rows = []
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        for name, (b, S, H, P, G, N, chunk) in scan_cases():
            if name == "ref":
                continue
            args = scan_inputs(torch, b, S, H, P, G, N, dtype, g)
            call = lambda: MS.mamba_scan(*args, chunk=chunk)
            rows.append({"model": name, "dtype": dt, "B": b, "S": S, "H": H,
                         "P": P, "G": G, "N": N, "chunk": chunk,
                         "ms": _time_ms(torch, call),
                         "graph_ms": _graph_ms(torch, call)})
            del args
    return {"rows": rows}


def scan_kernel_phase(torch) -> dict:
    """The scan kernel against its plain version (y and the final state, bit
    for bit) at every case of ``scan_cases``, both dtypes; against the
    reference-form ``ssd_chunked`` in float32; then ``scan_timing``'s times
    beside the bound and the plain version's time."""
    from repro_torch.kernels import mamba_scan as MS
    from repro_torch.models import ssm
    g = torch.Generator(device=DEV)
    g.manual_seed(29)
    worst, worst_oracle, plain = 0.0, 0.0, {}
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        for name, (b, S, H, P, G, N, chunk) in scan_cases():
            args = scan_inputs(torch, b, S, H, P, G, N, dtype, g)
            y, st = MS.mamba_scan(*args, chunk=chunk)
            y_p, st_p = MS.mamba_scan_ref(*args, chunk=chunk)
            torch.cuda.synchronize()
            e = max(float((y.float() - y_p.float()).abs().max()),
                    float((st - st_p).abs().max()))
            worst = max(worst, e)
            line = (f"scan {name} {dt} b={b} S={S} H={H} P={P} G={G} N={N} "
                    f"chunk={chunk}: max|kernel-plain|={e:.3e}")
            if dt == "float32":
                heads = torch.arange(H, device=DEV) // (H // G)
                y_o, st_o = ssm.ssd_chunked(*args[:3], args[3][:, :, heads],
                                            args[4][:, :, heads], chunk)
                rel = max(float(((a - o).abs() / (SCAN_ORACLE_TOL
                                                 + SCAN_ORACLE_TOL * o.abs()))
                                .max()) for a, o in ((y, y_o), (st, st_o)))
                worst_oracle = max(worst_oracle, rel)
                line += (f", max|kernel-ssd_chunked| "
                         f"{float((y - y_o).abs().max()):.3e} (y), "
                         f"{float((st - st_o).abs().max()):.3e} (state), "
                         f"|d| / (atol + rtol|ref|) {rel:.3f}")
            print(line)
            if name != "ref":
                plain[(dt, b, S, H, G)] = _time_once_ms(
                    torch, lambda: MS.mamba_scan_ref(*args, chunk=chunk))
            del args, y, st, y_p, st_p
    # tolerance 0: the plain version repeats the kernel's order of sums
    check(worst == 0.0, f"scan kernel equals plain bit for bit (max {worst})")
    check(worst_oracle <= 1.0, f"scan kernel within {SCAN_ORACLE_TOL} of "
                               f"ssd_chunked in float32 ({worst_oracle:.3f})")
    rows = scan_timing(torch)["rows"]
    for r in rows:
        b, S, H, P, G, N = (r[k] for k in ("B", "S", "H", "P", "G", "N"))
        bound, by = scan_bound(b, S, H, P, G, N, r["chunk"], r["dtype"],
                               2 if r["dtype"] == "bfloat16" else 4)
        r.update(plain_ms=plain[(r["dtype"], b, S, H, G)], bound_ms=bound,
                 bound_by=by, library_ms=None)
        print(f"time scan {r['model']} {r['dtype']} B={b} S={S} G={G}: "
              f"kernel {r['ms']:.5f} ms (alone {r['graph_ms']:.5f}), plain "
              f"{r['plain_ms']:.5f} ms, bound {bound:.7f} ms ({by})")
    print("library: no single PyTorch call computes the chunked SSD scan; "
          "library_ms is null")
    return {"max_abs_err": worst, "rows": rows}


# --- the recurrent serve path: mamba2-780m and zamba2-1.2b at full width ------
REC_SERVE = {
    # arch: (engine kwargs, prompt lengths, late prompt, late after ticks,
    #        new tokens); 512 = two chunks of the scan, the only length
    #        above ssm_chunk (256) the reference's stateful engine serves here
    "mamba2-780m": (dict(batch_slots=8, max_len=1024, eos_id=-1),
                    [37, 64, 100, 128, 200, 255, 256, 512], 150, 4, 32),
    "zamba2-1.2b": (dict(batch_slots=4, max_len=1024, eos_id=-1),
                    [37, 128, 256, 512], 100, 3, 16),
}
PROFILE_PREFILL_S = 512
# the float32 gate's depth, cut to half (to pay for phase 13e: the plain
# scan took most of each path): mamba2 24 of 48 layers, zamba2 3 of its 6
# hybrid groups and the 2 tail layers; the bf16 runs take the full depth
REC_F32_LAYERS = {"mamba2-780m": 24, "zamba2-1.2b": 20}


def rec_prompts(vocab: int, lengths, late: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32)
            for n in list(lengths) + [late]]


def recurrent_serve(torch, arch: str, profile: bool) -> dict:
    """One recurrent model through the stateful engine: the float32 gate
    (kernels vs plain versions), the bf16 run, a preemption run, and (for
    mamba2) the decode-tick and 512-token prefill profiles."""
    from repro_torch.configs import registry
    from repro_torch.models import attention as attn
    from repro_torch.models.model import Model
    from repro_torch.serve import Engine, Request
    kw, lengths, late, late_at, new = REC_SERVE[arch]
    cfg = registry.get(arch)
    prompts = rec_prompts(cfg.vocab_size, lengths, late, SERVE_SEED)
    n_req = len(prompts)
    # every layer is a mamba layer; zamba2's one shared attention block runs
    # after each group of hybrid_attn_every of them
    layers = cfg.num_layers
    groups = (cfg.num_layers // cfg.hybrid_attn_every
              if cfg.family == "hybrid" else 0)
    run = lambda eng, hook=None: drive(eng, prompts, new=new,
                                       late_at=late_at, hook=hook)
    # a tick counts the tokens its decode step samples; each request's
    # first token comes from its admission's prefill, so count the streams
    times = lambda ticks, streams: dict(
        _tick_times(ticks, stateful=True),
        tokens=sum(len(v) for v in streams.values()))
    out = {}

    # 1. the float32 gate: the kernels against their plain versions, at
    # REC_F32_LAYERS
    t0 = time.perf_counter()
    c32 = cfg.replace(dtype="float32", num_layers=REC_F32_LAYERS[arch])
    groups32 = (c32.num_layers // c32.hybrid_attn_every
                if cfg.family == "hybrid" else 0)
    m32 = Model(c32).init(SERVE_SEED)
    print(f"serve: {arch} ({m32.n_params()} parameters, {c32.num_layers} "
          f"mamba layers, {groups32} shared-attention groups) float32 from "
          f"seed {SERVE_SEED} in {time.perf_counter() - t0:.1f} s")
    eng = Engine(m32, **kw)
    reset_counts()
    got, ticks, wall = run(eng)
    counts = read_counts()
    print(f"serve {arch} float32 gate through the kernels: wall {wall:.3f} "
          f"s, {len(ticks)} ticks, launches {counts}")
    check(counts["mamba_scan"] == c32.num_layers * n_req,
          f"{arch}: scan launches == {c32.num_layers} mamba layers x "
          f"{n_req} prefills")
    check(counts["flash_attention"] == groups32 * n_req,
          f"{arch}: flash launches == {groups32} shared-attention groups x "
          f"{n_req} prefills")
    out["gate_counts"] = counts
    out["gate"] = dict(times(ticks, got), wall_s=wall)
    del eng
    with attn.plain_kernels():
        plain, _, wall_p = run(Engine(m32, **kw))
    print(f"serve {arch} float32 through the plain versions: wall "
          f"{wall_p:.3f} s")
    out["gate_equal_streams"] = hold_streams(
        torch, f"{arch} float32 kernels vs plain", m32, prompts, got, plain,
        margin=replay_margin)
    for rid in sorted(got):
        print(f"  request {rid} ({len(prompts[rid])} prompt tokens): "
              f"{got[rid][:8]}...")
    del m32
    gc.collect()
    torch.cuda.empty_cache()

    # 2. bf16, the working type; then the same traffic with a preemption
    m16 = Model(cfg).init(SERVE_SEED)
    eng = Engine(m16, **kw)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    got16, ticks, wall = run(eng)
    counts = read_counts()
    tt = times(ticks, got16)
    peak = torch.cuda.max_memory_allocated()
    print(f"serve {arch} bf16: wall {wall:.3f} s, {tt['tokens']} tokens, "
          f"{tt['tokens'] / wall:.1f} tokens/s, decode tick "
          f"{tt['decode_tick_s']:.5f} s ({tt['decode_ticks']}), prefill tick "
          f"{tt['prefill_tick_s']:.5f} s ({tt['prefill_ticks']}), launches "
          f"{counts}, peak memory {peak / 2 ** 20:.1f} MiB")
    check(counts["mamba_scan"] == layers * n_req,
          f"{arch}: the bf16 run launched the scan kernel per layer and "
          f"prefill")
    out["bf16"] = dict(tt, wall_s=wall, tokens_per_s=tt["tokens"] / wall,
                       counts=counts, peak_memory_bytes=peak)
    del eng
    keep = kw["batch_slots"] // 2
    evicted = []

    def preempt(engine, n):
        if n == late_at + 4:
            evicted.append(engine.preempt_to(keep))

    eng = Engine(m16, **kw)
    resumed, _, wall_r = run(eng, hook=preempt)
    print(f"serve {arch} bf16 with preempt_to({keep}) after {late_at + 4} "
          f"ticks: {evicted[0]} requests parked in the host pool and "
          f"resumed, wall {wall_r:.3f} s")
    check(evicted[0] > 0 and eng.pool.pages_held == 0,
          f"{arch}: the preemption parked requests and resumed them all")
    check(resumed == got16, f"{arch}: the resumed streams equal the "
                            f"uninterrupted bf16 run's")
    out["preempt"] = {"evicted": evicted[0], "wall_s": wall_r,
                      "streams_equal": True}
    del eng

    if profile:
        eng = Engine(m16, **kw)
        for rid in range(kw["batch_slots"]):
            eng.submit(Request(rid, prompts[3], max_new=64))
        for _ in range(3):
            eng.step()  # admits every slot, then decode ticks
        _profile(torch, f"serve {arch} bf16 all-decode tick "
                        f"({kw['batch_slots']} x 1)", eng.step)
        del eng
        toks = torch.as_tensor(np.random.default_rng(SERVE_SEED + 2).integers(
            0, cfg.vocab_size, (1, PROFILE_PREFILL_S)), device=DEV)
        pre = lambda: m16.prefill({"tokens": toks}, max_len=kw["max_len"])
        pre()
        torch.cuda.synchronize()
        _profile(torch, f"{arch} bf16 prefill of {PROFILE_PREFILL_S} tokens",
                 pre)
    del m16
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --- training on the card: llama3.2-1b at full width (phase 11b) ------------
TRAIN_ARCH, TRAIN_SEED = "llama3.2-1b", 0
# the Functions' shapes, (label, B, S, T, H, Hkv, D, causal): llama's
# causal self-attention at train_4k's length, the vlm's cross step over
# 1601 image tokens, whisper's encoder
GRAD_SHAPES = [("llama causal", 4, 4096, 4096, 32, 8, 64, True),
               ("vlm cross", 4, 256, 1601, 32, 8, 128, False),
               ("whisper encoder", 4, 1500, 1500, 12, 12, 64, False)]
# dq, dk and dv against float64 autograd, as a share of each gradient's
# largest magnitude. float32: sums over up to 4096 keys and 64 dims in
# float32 (2^-24 a rounding, a few hundred roundings deep at worst);
# bfloat16: the inputs are exact in float64, but the forward's output and
# the gradients are rounded to bfloat16 (2^-9 relative each), and the
# output enters rowsum(dO o)
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the scan Function at mamba2's prefill shape (b, S, H, P, G, N, chunk),
# against autograd through its plain version: the same computation, but
# the B and C gradients sum the 48 heads' shares of each group with
# atomics (the index's backward), in no fixed order
SCAN_GRAD_SHAPE = (1, 512, 48, 64, 1, 128, 256)
SCAN_GRAD_TOL = 1e-5
# the gradient gate: full width, 2 layers, float32, B 1, S 2048; each
# leaf's gradient through the kernels against the same step with the
# attention as plain autograd (``_sdpa``), within this share of its
# largest magnitude: two float32 orders of the attention's sums (the
# kernel's online softmax and the blockwise backward against one softmax
# and autograd's backward)
TRAIN_GATE_LAYERS, TRAIN_GATE_B, TRAIN_GATE_S = 2, 1, 2048
TRAIN_GATE_TOL = 1e-4
# the full-width run: train_4k's length, global batch 8 as 2 microbatches
# of 4, AdamW warming up over 5 steps; the checkpoint after step 3. Depth
# cut to keep the script inside its limit (16 layers: 166.6 s of it, ~84 s
# the 14.8 GB checkpoint's round trip; 4 layers 61.2 s; 2 since phase 13f)
TRAIN_SEQ, TRAIN_BATCH, TRAIN_ACCUM, TRAIN_STEPS = 4096, 8, 2, 6
TRAIN_RUN_LAYERS = 2
TRAIN_WARMUP, TRAIN_SAVE_AT = 5, 3
TRAIN_PROFILED = 2  # a warm step before the save
TRAIN_DIR = ROOT / "build" / "train_ckpt"
# the CLI at full width: a few short steps with the energy loop
# (its checkpoint interval past its last step: the full-width save and
# restore are train_run's, ~6 GB each way; the CLI's save, resume and
# retry run in tests/test_torch_train.py)
TRAIN_CLI = ["--arch", TRAIN_ARCH, "--no-smoke", "--steps", "3", "--batch",
             "4", "--seq", "1024", "--log-every", "1", "--energy-policy",
             "power_save", "--checkpoint-every", "10"]


def attention64_grads(torch, q, k, v, do, causal):
    """(dq, dk, dv) of softmax(q k^T / sqrt(D)) v in float64, materialised,
    by autograd: one (b, kv head) at a time, so the (g, S, T) scores of
    its g query heads fit (dk and dv of a kv head are its group's alone)."""
    import math
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    grads = [torch.empty(t.shape, dtype=torch.float64, device=t.device)
             for t in (q, k, v)]
    for b in range(B):
        for h in range(Hkv):
            heads = slice(h * g, (h + 1) * g)
            qs = q[b, :, heads].double().requires_grad_()
            ks = k[b, :, h].double().requires_grad_()
            vs = v[b, :, h].double().requires_grad_()
            s = torch.einsum("sgd,td->gst", qs, ks) / math.sqrt(D)
            if causal:
                hide = torch.arange(T, device=q.device)[None] > \
                    torch.arange(S, device=q.device)[:, None]
                s = s.masked_fill(hide, float("-inf"))
            o = torch.einsum("gst,td->sgd", torch.softmax(s, -1), vs)
            dq, dk, dv = torch.autograd.grad(o, (qs, ks, vs),
                                             do[b, :, heads].double())
            grads[0][b, :, heads], grads[1][b, :, h], grads[2][b, :, h] = \
                dq, dk, dv
    return grads


def _rel_err(got, want) -> float:
    """max |got - want| over the largest magnitude of want."""
    return float((got.double() - want).abs().max() / want.abs().max())


def flash_grad_check(torch, card: str) -> dict:
    """The flash Function at the training paths' shapes: its forward (the
    kernel) equal to the plain version bit for bit, as phase 8 holds the
    kernel at the serving shapes, and its dq, dk, dv (the plain PyTorch
    backward) against float64 autograd; the backward timed once per shape
    (CUDA events)."""
    from repro_torch.kernels import flash_attention as FA
    rows, worst = [], {}
    for label, B, S, T, H, Hkv, D, causal in GRAD_SHAPES:
        # bf16 values, taken as they are in float32 too: one float64
        # reference holds both dtypes
        g = torch.Generator(device=DEV).manual_seed(13)
        mk = lambda *shape: torch.randn(shape, generator=g,
                                        device=DEV).bfloat16()
        ins = [mk(B, S, H, D), mk(B, T, Hkv, D), mk(B, T, Hkv, D),
               mk(B, S, H, D)]
        want = attention64_grads(torch, *ins, causal)
        for dt in ("bfloat16", "float32"):
            q, k, v, do = (t.to(getattr(torch, dt)) for t in ins)
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            o = FA.flash_attention(*leaves, causal=causal)
            check(o.grad_fn is not None, f"flash {label} {dt}: a grad_fn")
            fwd_err = float((o.detach().float() - FA.flash_attention_ref(
                q, k, v, causal=causal).float()).abs().max())
            check(fwd_err == 0.0, f"flash {label} {dt}: the Function's "
                                  f"forward == plain bit for bit "
                                  f"(max {fwd_err:.3e})")
            got = torch.autograd.grad(o, leaves, do)
            errs = [_rel_err(a, b) for a, b in zip(got, want)]
            ok = all(gr.dtype == q.dtype for gr in got) and \
                max(errs) <= GRAD_TOL[dt]
            od = o.detach()
            bwd_ms = _time_once_ms(torch, lambda: FA.flash_attention_backward(
                q, k, v, od, do, causal=causal))
            print(f"[{card}] flash grad {label} B={B} S={S} T={T} "
                  f"H={H}/{Hkv} D={D} {dt}: forward max|kernel-plain| "
                  f"{fwd_err:.3e}, dq/dk/dv rel err "
                  f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} (tol "
                  f"{GRAD_TOL[dt]:g}), backward {bwd_ms:.3f} ms")
            check(ok, f"flash Function gradients, {label} {dt}")
            worst[dt] = max(worst.get(dt, 0.0), max(errs))
            rows.append({"case": label, "dtype": dt, "B": B, "S": S,
                         "T": T, "H": H, "Hkv": Hkv, "D": D,
                         "causal": causal, "forward_max_abs_err": fwd_err,
                         "rel_err": errs, "backward_ms": bwd_ms})
            del q, k, v, do, o, got, leaves, od
        del ins, want
        torch.cuda.empty_cache()
    return {"rows": rows, "worst": worst}


def scan_grad_check(torch, card: str) -> dict:
    """The scan Function's gradients (the kernel's forward, the plain
    version recomputed under autograd) at mamba2's prefill shape against
    autograd through ``mamba_scan_ref``."""
    from repro_torch.kernels import mamba_scan as MS
    b, S, H, P, G, N, chunk = SCAN_GRAD_SHAPE
    g = torch.Generator(device=DEV).manual_seed(17)
    mk = lambda *sh: torch.randn(sh, generator=g, device=DEV)
    ins = [mk(b, S, H, P), torch.nn.functional.softplus(mk(b, S, H)),
           -torch.exp(mk(H) * 0.5), mk(b, S, G, N), mk(b, S, G, N)]
    leaves = [t.requires_grad_() for t in ins]
    y, state = MS.mamba_scan(*leaves, chunk=chunk)
    check(y.grad_fn is not None and not state.requires_grad,
          "scan Function: y differentiable, the state not")
    dy = mk(*y.shape)
    got = torch.autograd.grad(y, leaves, dy)
    ref, _ = MS.mamba_scan_ref(*leaves, chunk=chunk)
    want = torch.autograd.grad(ref, leaves, dy)
    errs = [_rel_err(a, w.double()) for a, w in zip(got, want)]
    print(f"[{card}] scan grad b={b} S={S} H={H} P={P} G={G} N={N} chunk "
          f"{chunk}: rel err x/dt/A/B/C " + "/".join(f"{e:.2e}" for e in errs)
          + f" (tol {SCAN_GRAD_TOL:g})")
    check(max(errs) <= SCAN_GRAD_TOL, "scan Function gradients")
    return {"rel_err": errs, "shape": SCAN_GRAD_SHAPE}


@contextlib.contextmanager
def sdpa_attention():
    """Within the block the model's flash attention is ``_sdpa`` (plain
    autograd through a materialised softmax): the gradient gate's
    reference."""
    from repro_torch.models import attention as attn

    def sdpa(q, k, v, *, causal=True):
        mask = attn.causal_mask(q.shape[1], k.shape[1], 0, 0, q.device) \
            if causal else None
        return attn._sdpa(q, k, v, mask)

    saved = attn.KERNELS["flash"]
    attn.KERNELS["flash"] = sdpa
    try:
        yield
    finally:
        attn.KERNELS["flash"] = saved


def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}/{k}")]
    return [prefix]


def train_gate(torch, card: str) -> dict:
    """llama3.2-1b at full width and cut depth, float32: every leaf's
    gradient through the flash Function against the same step through
    ``_sdpa``, and every leaf's gradient norm above 0 (a gradient that
    stopped at a kernel would leave wq, wk and wv at 0)."""
    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import params as pm
    from repro_torch.models.model import Model
    from repro_torch.train.step import make_grad_fn
    layers, B, S = TRAIN_GATE_LAYERS, TRAIN_GATE_B, TRAIN_GATE_S
    cfg = registry.get(TRAIN_ARCH).replace(num_layers=layers,
                                           dtype="float32")
    model = Model(cfg).init(TRAIN_SEED)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), device=DEV,
                         generator=torch.Generator(device=DEV).manual_seed(5))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    grad_fn = make_grad_fn(model)
    n0 = FA.flash_attention.launches
    loss, _, grads = grad_fn(model.weights(), batch)
    launches = FA.flash_attention.launches - n0
    with sdpa_attention():
        loss_ref, _, ref = grad_fn(model.weights(), batch)
    names = _leaf_names(grads)
    errs = {n: _rel_err(a, b.double()) for n, a, b in
            zip(names, pm.tree_leaves(grads), pm.tree_leaves(ref))}
    norms = {n: float(a.norm()) for n, a in
             zip(names, pm.tree_leaves(grads))}
    worst = max(errs, key=errs.get)
    print(f"[{card}] train gate {TRAIN_ARCH} {layers} layers float32 B={B} "
          f"S={S}: loss {float(loss):.6f} (sdpa {float(loss_ref):.6f}), "
          f"{len(errs)} leaves, worst rel err {errs[worst]:.3e} at {worst} "
          f"(tol {TRAIN_GATE_TOL:g}), smallest grad norm "
          f"{min(norms.values()):.3e} at {min(norms, key=norms.get)}, "
          f"flash launches {launches}")
    check(launches == 2 * layers, "gate: flash twice a layer (remat)")
    check(errs[worst] <= TRAIN_GATE_TOL, "gate: gradients through the "
          "kernel equal the plain path's")
    check(min(norms.values()) > 0, "gate: every leaf has a gradient")
    out = {"worst_rel_err": errs[worst], "worst_leaf": worst,
           "min_grad_norm": min(norms.values()), "launches": launches}
    del model, grads, ref
    return out


def _state_trees_equal(torch, restored, saved) -> bool:
    """Leaf by leaf: restored tensors (on the card) equal the saved ones (a
    host copy), bit for bit."""
    from repro_torch.models import params as pm
    a, b = pm.tree_leaves(restored), pm.tree_leaves(saved)
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x.cpu(), y) for x, y in zip(a, b))


def train_run(torch, card: str) -> dict:
    """llama3.2-1b at full width and ``TRAIN_RUN_LAYERS`` layers, bf16
    over float32 masters, remat, AdamW: ``TRAIN_STEPS`` steps of global
    batch 8 (2 microbatches of 4) at 4096 tokens, the flash launches of
    every step gated exactly (layers x 2 (remat) x 2 microbatches), the
    profiled step's breakdown printed.
    After step 3 the state is saved asynchronously (the write overlaps the
    next steps) beside a host copy; after the run a fresh model and
    optimizer restore it on the card, the restored tensors equal to the
    host copy bit for bit, and run the remaining steps: the first equal to
    the uninterrupted run's loss bit for bit, the later ones reported (the
    embedding gradient's atomics may move them by ulps)."""
    import shutil
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, make_iterator
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import params as pm
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.step import make_train_step
    cfg = registry.get(TRAIN_ARCH).replace(num_layers=TRAIN_RUN_LAYERS)
    per_step = cfg.num_layers * 2 * TRAIN_ACCUM
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                    global_batch=TRAIN_BATCH)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    took = {}

    def fresh():
        model = Model(cfg).init(TRAIN_SEED)
        opt = make_optimizer(cfg, warmup_steps=TRAIN_WARMUP)
        return model, opt, make_train_step(model, opt, n_accum=TRAIN_ACCUM)

    def step_once(train, params, state, batch, i, label):
        torch.cuda.reset_peak_memory_stats()
        n0 = FA.flash_attention.launches
        t0 = time.perf_counter()
        params, state, m = train(params, state, batch, i)
        loss = float(m["loss"])  # waits for the step
        wall = time.perf_counter() - t0
        row = {"step": i, "loss": loss, "grad_norm": float(m["grad_norm"]),
               "wall_s": wall, "tokens_per_s": tokens / wall,
               "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
               "flash": FA.flash_attention.launches - n0}
        print(f"[{card}] train {label} step {i}: loss {loss:.6f} grad norm "
              f"{row['grad_norm']:.4f} wall {wall:.3f} s "
              f"{row['tokens_per_s']:.0f} tokens/s peak "
              f"{row['peak_mib']:.1f} MiB flash {row['flash']}")
        check(row["flash"] == per_step, f"train: {per_step} flash launches "
              f"a step ({cfg.num_layers} layers x remat x 2 microbatches)")
        return params, state, row

    t0 = time.perf_counter()
    model, opt, train = fresh()
    print(f"[{card}] train {TRAIN_ARCH}: {model.n_params():,} parameters, "
          f"{cfg.dtype} over {cfg.param_dtype} masters, remat "
          f"{cfg.remat}, seq {TRAIN_SEQ}, batch {TRAIN_BATCH} as "
          f"{TRAIN_ACCUM} x {TRAIN_BATCH // TRAIN_ACCUM}")
    params, state = model.weights(), opt.init(model.weights())
    it = make_iterator(cfg, dc)
    rows, saved, prof = [], None, None
    mgr = CheckpointManager(str(TRAIN_DIR), keep_last=1)
    reset_counts()
    for i in range(TRAIN_STEPS):
        batch = next(it)
        if i == TRAIN_PROFILED:
            box = {}
            prof = _profile(torch, f"train step {i}", lambda: box.update(
                out=step_once(train, params, state, batch, i,
                              "uninterrupted")))
            params, state, row = box.pop("out")
        else:
            params, state, row = step_once(train, params, state, batch, i,
                                           "uninterrupted")
        rows.append(row)
        if i + 1 == TRAIN_SAVE_AT:
            tree = {"params": params, "opt": state}
            t1 = time.perf_counter()
            saved = pm.tree_map(lambda t: t.to("cpu", copy=True), tree)
            t2 = time.perf_counter()
            mgr.save(TRAIN_SAVE_AT, tree)
            took["host_copy_s"] = t2 - t1
            took["save_returned_s"] = time.perf_counter() - t2
            t_write = time.perf_counter()
    counts = read_counts()
    mgr.wait()
    took["write_done_after_s"] = time.perf_counter() - t_write
    took["run_s"] = time.perf_counter() - t0
    losses = [r["loss"] for r in rows]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"train: losses finite and falling {losses}")
    del model, opt, train, params, state, batch, tree
    gc.collect()
    torch.cuda.empty_cache()

    # the resumed run: a fresh model and optimizer restore the checkpoint
    t0 = time.perf_counter()
    model, opt, train = fresh()
    like = {"params": model.weights(), "opt": opt.init(model.weights())}
    # no second sha256 pass over the ~6 GB file: the restored state is
    # held against the host copy bit for bit just below
    restored, at = mgr.restore(like, verify=False)
    took["restore_s"] = time.perf_counter() - t0
    del like
    same = _state_trees_equal(torch, restored, saved)
    print(f"[{card}] train checkpoint after step {at}: host copy "
          f"{took['host_copy_s']:.2f} s, save returned in "
          f"{took['save_returned_s']:.2f} s, the write done "
          f"{took['write_done_after_s']:.2f} s after it (steps "
          f"{TRAIN_SAVE_AT}-{TRAIN_STEPS - 1} ran meanwhile), restored on "
          f"the card with a fresh model in {took['restore_s']:.2f} s, equal "
          f"to the saved state bit for bit: {same}")
    check(same and at == TRAIN_SAVE_AT, "restored state == saved")
    del saved
    params, state = restored["params"], restored["opt"]
    model.set_weights(params)
    it = make_iterator(cfg, dc, start_step=TRAIN_SAVE_AT)
    resumed_rows = []
    for i in range(TRAIN_SAVE_AT, TRAIN_STEPS):
        params, state, row = step_once(train, params, state, next(it), i,
                                       "resumed")
        resumed_rows.append(row)
    diffs = [r["loss"] - losses[r["step"]] for r in resumed_rows]
    print(f"[{card}] train resumed losses - uninterrupted: "
          + ", ".join(f"step {i}: {d:+.3e}"
                      for i, d in enumerate(diffs, TRAIN_SAVE_AT)))
    check(diffs[0] == 0.0, "resume: the first resumed step's loss equals "
          "the uninterrupted run's bit for bit")
    del model, opt, train, params, state, restored
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    # steady steps: not the first (warm-up), not the profiled one, not
    # those that share the host with the save's write; the resumed ones
    steady = [r for r in rows[1:TRAIN_SAVE_AT] + resumed_rows
              if r is not rows[TRAIN_PROFILED]]
    mean = lambda k: float(np.mean([r[k] for r in steady]))
    print(f"[{card}] train steady steps {[r['step'] for r in steady]}: "
          f"mean wall {mean('wall_s'):.3f} s, {mean('tokens_per_s'):.0f} "
          f"tokens/s")
    return {"rows": rows, "resumed_rows": resumed_rows,
            "resumed_diffs": diffs, "counts": counts,
            "per_step_flash": per_step, "mean_wall_s": mean("wall_s"),
            "mean_tokens_per_s": mean("tokens_per_s"),
            "peak_mib": max(r["peak_mib"] for r in rows), "took": took,
            "profile": None if prof is None else {
                "wall_ms": prof["wall_ms"], "busy_ms": prof["busy_ms"],
                "flash_share": _share(prof, "flash"),
                "top": sorted(prof["kernels_ms"].items(),
                              key=lambda kv: -kv[1])[:8]}}


def train_cli(torch, card: str) -> dict:
    """``repro_torch.launch.train.main`` at full width: a few short steps
    with the energy loop and a checkpoint directory (``TRAIN_CLI``). The
    loop plans the modelled 16 x 16 pod, whose 256-cell thermal solve is
    one direct product (``core/thermal``: at most 512 cells): no thermal
    kernel launches there, and the counts are reported."""
    import shutil
    from repro_torch.configs import registry
    from repro_torch.launch import train as launch
    ckpt = ROOT / "build" / "train_cli_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    reset_counts()
    t0 = time.perf_counter()
    final = launch.main(TRAIN_CLI + ["--checkpoint-dir", str(ckpt)])
    wall = time.perf_counter() - t0
    counts = read_counts()
    print(f"[{card}] train CLI: final loss {final:.4f}, wall {wall:.1f} s, "
          f"launches {counts}")
    check(final is not None and np.isfinite(final), "CLI: a finite loss")
    steps, cfg = int(TRAIN_CLI[TRAIN_CLI.index("--steps") + 1]), \
        registry.get(TRAIN_ARCH)
    check(counts["flash_attention"] == steps * cfg.num_layers * 2,
          "CLI: flash twice a layer a step (remat)")
    shutil.rmtree(ckpt, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"final_loss": final, "wall_s": wall, "counts": counts}


def train_path(torch, card: str) -> dict:
    out, took = {}, {}
    for name, fn in (("flash_grads", flash_grad_check),
                     ("scan_grads", scan_grad_check), ("gate", train_gate),
                     ("run", train_run), ("cli", train_cli)):
        t0 = time.perf_counter()
        out[name] = fn(torch, card)
        took[name] = round(time.perf_counter() - t0, 1)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[{card}] train path times (s): {json.dumps(took)}")
    out["took_s"] = took
    return out


# --- expandable serving: llama3.2-1b at full width (phase 12) ----------------
EXP_INITIAL = 64  # the managers' initial capacity (the reference's default)


class kernel_taps:
    """Within the block, one of the model's kernel entries
    (``attention.KERNELS[name]``) is wrapped: each call goes to it
    unchanged, and the first call at each ``key(call index, *args)`` (None:
    keep nothing) leaves a copy of its inputs and of the kernel's output in
    ``self.cases``: {key: (args, kwargs, output)}."""

    def __init__(self, name, key):
        self.name, self.key, self.cases, self.calls = name, key, {}, 0

    def __enter__(self):
        from repro_torch.models import attention as attn
        inner = self.inner = attn.KERNELS[self.name]

        def tap(*args, **kw):
            out = inner(*args, **kw)
            key = self.key(self.calls, *args)
            self.calls += 1
            if key is not None and key not in self.cases:
                copy = (tuple(t.detach().clone() for t in out)
                        if isinstance(out, tuple) else out.detach().clone())
                self.cases[key] = ([t.detach().clone() for t in args], kw,
                                   copy)
            return out

        attn.KERNELS[self.name] = tap
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention as attn
        attn.KERNELS[self.name] = self.inner


def paged_taps() -> kernel_taps:
    """The first paged call at each (table width in pages, rows per slot;
    0 for decode rows)."""
    return kernel_taps("paged", lambda i, q, k, v, ids, bt, pos: (
        bt.shape[1], q.shape[1] if q.dim() == 4 else 0))


def hold_paged_taps(torch, label, taps, capacities) -> list:
    """Each tapped call's output (the paged kernel's, in the engine's
    warm-up and in the run) against ``paged_attention_ref`` on the same
    inputs, bit for bit as phase 7 holds the kernel at 128 pages; every
    table width the run attended over (its capacities over the page size)
    must be among the run's."""
    from repro_torch.kernels import paged_attention as PA
    ps = SERVE_KW["page_size"]
    rows = []
    for when, cases in taps.items():
        for (n, S), (args, kw, got) in sorted(cases.items()):
            want = PA.paged_attention_ref(*args, **kw)
            torch.cuda.synchronize()
            e = float((got.float() - want.float()).abs().max())
            seen = int((args[3][args[4].long()] >= 0).sum())
            form = "decode rows" if S == 0 else f"{S}-row chunks"
            print(f"  paged {label} {when} at {n} pages ({n * ps} entries),"
                  f" {form}, q={tuple(args[0].shape)}, {seen} cache entries "
                  f"written: max|kernel-plain|={e:.3e}"
                  + (" (bit for bit)" if torch.equal(got, want) else ""))
            check(torch.equal(got, want), f"paged {label} {when} at {n} "
                                          f"pages, {form}: kernel == plain "
                                          f"bit for bit")
            rows.append({"when": when, "n_pages": n, "rows_per_slot": S,
                         "q": list(args[0].shape), "entries_written": seen,
                         "max_abs_err": e})
    widths = {n for n, _ in taps["run"]}
    check({c // ps for c in capacities} <= widths,
          f"paged {label}: every table width of the run was held "
          f"({sorted(widths)} pages)")
    return rows


def _exp_run(torch, model, prompts, paged: bool,
             expandable: bool = True, tap: bool = False) -> dict:
    """One run of phase 10's traffic through a fresh expandable (or
    fixed-size) engine, the launch counts set to 0 just before it and read
    just after; with ``tap`` the paged kernel's calls in the engine's
    warm-up and in the run are tapped (:func:`paged_taps`), returned as
    ``taps``."""
    import contextlib

    from repro_torch.serve import Engine
    warm, run = ((paged_taps(), paged_taps()) if tap else
                 (contextlib.nullcontext(), contextlib.nullcontext()))
    with warm:
        eng = Engine(model, paged=paged, expandable=expandable, **SERVE_KW)
    caps = []
    reset_counts()
    with run:
        got, ticks, wall = drive(eng, prompts, hook=lambda e, n: caps.append(
            getattr(e.mgr, "capacity", e.max_len)))
    counts = read_counts()
    tt = _tick_times(ticks)
    mgr = eng.mgr
    return {"streams": got, "ticks": ticks, "counts": counts,
            "taps": ({"warm-up": warm.cases, "run": run.cases} if tap
                     else None),
            "summary": dict(tt, wall_s=wall, tokens_per_s=tt["tokens"] / wall,
                            grows=getattr(mgr, "grows", 0),
                            capacity=getattr(mgr, "capacity", eng.max_len),
                            capacities=sorted(set(caps)),
                            pages_in_use=mgr.pages_in_use,
                            peak_pages=mgr.peak_pages,
                            recount_pages=mgr.recount_pages(),
                            counts=counts)}


def expandable_path(torch, serve: dict) -> dict:
    """Phase 10's traffic through the expandable engines (capacity 64 at
    the start, doubling to max_len): float32 contiguous and paged, each
    stream equal to phase 10's float32 stream of the same cache kind
    (gated), and bf16 paged beside phase 10's bf16 paged streams
    (reported), timed in turns with the fixed-size engine. In the float32
    paged run and the first bf16 expandable one, the paged kernel's first
    call at each table width and rows per slot is held bit for bit against
    its plain version on the same inputs (:func:`hold_paged_taps`)."""
    from repro_torch.configs import registry
    from repro_torch.models.model import Model
    cfg = registry.get(SERVE_ARCH)
    n_layers = cfg.num_layers
    prompts = serve_prompts(cfg.vocab_size)
    streams = serve.pop("streams")
    base = {"contiguous": serve["gate_contiguous"], "paged": serve["gate"]}
    out = {}
    m32 = Model(cfg.replace(dtype="float32")).init(SERVE_SEED)
    for paged in (False, True):
        kind = "paged" if paged else "contiguous"
        r = _exp_run(torch, m32, prompts, paged, tap=paged)
        sm, want = r["summary"], streams[kind]
        same = sum(r["streams"][rid] == want[rid] for rid in want)
        n_ticks = sum(1 for w, _, _, _ in r["ticks"] if w > 0)
        print(f"expandable float32 {kind}: grows {sm['grows']}, capacities "
              f"{sm['capacities']}, final capacity {sm['capacity']}, pages "
              f"in use {sm['pages_in_use']} (recount {sm['recount_pages']})"
              f", peak pages {sm['peak_pages']}, {sm['tokens']} tokens in "
              f"{sm['wall_s']:.3f} s = {sm['tokens_per_s']:.1f} tokens/s "
              f"(phase 10 {kind}: {base[kind]['tokens']} tokens in "
              f"{base[kind]['wall_s']:.3f} s = "
              f"{base[kind]['tokens'] / base[kind]['wall_s']:.1f} tokens/s), "
              f"launches {r['counts']} (phase 10 paged: "
              f"{serve['gate_counts']['paged_attention']}); {same} of "
              f"{len(want)} streams equal phase 10's")
        for rid in want:
            i = _first_diff(r["streams"][rid], want[rid])
            if i is not None:
                print(f"  request {rid} first differs at generated token "
                      f"{i}; the plain run's top-2 margin there is "
                      f"{plain_margin(torch, m32, prompts[rid], want[rid], i):.3e}")
        check(same == len(want), f"float32 expandable {kind} streams equal "
                                 f"phase 10's")
        check(sm["grows"] > 0 and sm["capacity"] > EXP_INITIAL,
              f"the {kind} capacity grew")
        check(sm["pages_in_use"] == sm["recount_pages"] == 0,
              f"{kind} pages all returned")
        if paged:
            check(r["counts"]["paged_attention"] == n_ticks * n_layers,
                  f"paged launches == ticks x {n_layers} layers")
            out["gate_counts"] = r["counts"]
            sm["paged_vs_plain"] = hold_paged_taps(
                torch, "float32 expandable", r.pop("taps"), sm["capacities"])
        out[kind] = dict(sm, streams_equal_phase10=same)
    del m32
    gc.collect()
    torch.cuda.empty_cache()
    m16 = Model(cfg).init(SERVE_SEED)
    # the fixed-size and the expandable engine in turns (fixed first and
    # last) on the same traffic: this phase runs late in the script, where
    # phase 10's times are no yardstick for its own
    turns = [(exp, _exp_run(torch, m16, prompts, True, exp, tap=i == 1))
             for i, exp in enumerate((False, True, True, False))]
    r = turns[1][1]
    held = hold_paged_taps(torch, "bf16 expandable", r.pop("taps"),
                           r["summary"]["capacities"])
    want = streams["bf16_paged"]
    same = sum(r["streams"][rid] == want[rid] for rid in want)
    sm = r["summary"]
    by = {name: [t["summary"] for e, t in turns if e == exp]
          for name, exp in (("fixed", False), ("expandable", True))}
    keys = ("tokens_per_s", "decode_tick_s", "prefill_tick_s", "wall_s")
    print(f"expandable bf16 paged (reported): {same} of {len(want)} streams "
          f"equal phase 10's bf16 paged streams; grows {sm['grows']}, peak "
          f"pages {sm['peak_pages']}; in turns fixed, expandable, "
          f"expandable, fixed: " + "; ".join(
              f"{k} tokens/s {[round(t['tokens_per_s'], 1) for t in v]}, "
              f"decode tick {[round(t['decode_tick_s'], 5) for t in v]} s"
              for k, v in by.items()))
    out["bf16_paged"] = dict(sm, streams_equal_phase10=same,
                             paged_vs_plain=held, turns={
        k: [{key: t[key] for key in keys} for t in v]
        for k, v in by.items()})
    del m16
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --- SPMD on one card: the GPipe pipeline and the rescale (phase 13) ---------
PIPE_P, PIPE_M, PIPE_B, PIPE_S = 2, 4, 8, 1024
PIPE_RUNS = 2  # timed runs after one warm-up
PIPE_DIR = ROOT / "build" / "spmd"


def _pipe_setup(torch):
    """llama3.2-1b at full width in bf16 from the serve seed, its blocks,
    the stage function (blocks in order, no grad) and the input: the
    embeddings of (PIPE_B, PIPE_S) seeded tokens."""
    from repro_torch.configs import registry
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import Model
    cfg = registry.get(SERVE_ARCH)
    model = Model(cfg).init(SERVE_SEED)
    stack = model.params["blocks"]["stack"]
    blocks = [tf.layer(stack, i) for i in range(cfg.num_layers)]

    @torch.no_grad()
    def stage(ps, x):
        for lp in ps:
            x, _ = tf.attn_block_apply(lp, x, cfg)
        return x

    toks = torch.as_tensor(np.random.default_rng(SERVE_SEED + 2).integers(
        0, cfg.vocab_size, (PIPE_B, PIPE_S)), device=DEV)
    x = model.params["embed"]["embedding"][toks]
    return model, blocks, stage, x


def pipe_run(torch, rank: int, group) -> list:
    """Phase 13a on one rank of the world's first PIPE_P ranks (``group``,
    a gloo group over them): this rank's half of the blocks on cuda:0, one
    warm-up and PIPE_RUNS timed runs, each with the launch counts set to
    0 just before it and read just after; rank 0 writes the output under
    SPMD_DIR. -> this rank's timings."""
    import torch.distributed as dist
    from repro_torch.sharding.pipeline import pipeline_apply
    _, blocks, stage, x = _pipe_setup(torch)
    per = len(blocks) // PIPE_P
    mine = blocks[rank * per:(rank + 1) * per]
    busy = [0.0]

    def timed_stage(ps, h):
        t0 = time.perf_counter()
        y = stage(ps, h)
        torch.cuda.synchronize()
        busy[0] += time.perf_counter() - t0
        return y

    runs = []
    for i in range(PIPE_RUNS + 1):
        busy[0] = 0.0
        dist.barrier(group)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        y = pipeline_apply(timed_stage, mine, x, group, PIPE_M)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        if i:
            runs.append({"wall_s": wall, "busy_s": busy[0],
                         "idle_share": 1 - busy[0] / wall,
                         "flash": counts["flash_attention"],
                         "launches": counts})
    if rank == 0:
        torch.save(y.cpu(), SPMD_DIR / "pipe_out.pt")
    del blocks, x, y
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def hold_flash_taps(torch, cases, n_calls: int, what="pipeline") -> dict:
    """Each tapped flash call (the kernel's output in the run: one per
    block of the pipeline, or each call of a sharded step on one rank)
    against ``flash_attention_ref`` on the same inputs, bit for bit."""
    from repro_torch.kernels import flash_attention as FA
    check(sorted(cases) == list(range(n_calls)),
          f"{what}: {n_calls} flash calls tapped")
    worst = 0.0
    for i, (args, kw, got) in sorted(cases.items()):
        want = FA.flash_attention_ref(*args, **kw)
        torch.cuda.synchronize()
        worst = max(worst, float((got.float() - want.float()).abs().max()))
        check(torch.equal(got, want), f"{what} call {i}: flash kernel "
                                      f"== plain bit for bit")
    q, k = cases[0][0][:2]
    print(f"  flash at the {what}'s shapes, q={tuple(q.shape)} "
          f"kv={tuple(k.shape)} {str(q.dtype).split('.')[-1]} causal="
          f"{cases[0][1].get('causal')}: {n_calls} calls, "
          f"max|kernel-plain|={worst:.3e}")
    return {"q": list(q.shape), "kv": list(k.shape),
            "dtype": str(q.dtype).split(".")[-1], "calls": n_calls,
            "max_abs_err": worst}


def pipeline_check(torch, card: str, ranks: list, got) -> dict:
    """Phase 13a: the GPipe pipeline of llama3.2-1b's 16 blocks over a
    2-rank gloo group on cuda:0 (8 + 8 blocks, B 8, S 1024, 4
    microbatches; ``ranks``: each pipeline rank's timings from
    :func:`spmd_world`, ``got``: its output), the output equal bit for bit
    to the same blocks run in one process over the same microbatches,
    whose 16 flash calls on the first microbatch are held bit for bit
    against the plain version; the whole-batch run reported beside it on
    the logits (test_torch_models.py's bf16 bound)."""
    got = got.to(DEV)
    model, blocks, stage, x = _pipe_setup(torch)
    n_blocks = len(blocks)
    # each block's flash call on the first microbatch, at the pipeline's
    # shapes: its inputs are the pipeline's when the outputs agree
    taps = kernel_taps("flash", lambda i, *a: i if i < n_blocks else None)
    with taps:
        mbs = [stage(blocks, mb) for mb in x.chunk(PIPE_M)]
    seq = torch.cat(mbs)
    equal = torch.equal(got, seq)
    flash_held = hold_flash_taps(torch, taps.cases, n_blocks)
    del taps
    whole = stage(blocks, x)
    from repro_torch.models import layers as L
    with torch.no_grad():
        logits = [L.unembed_apply(model.params["embed"], L.norm_apply(
            model.params["final_ln"], h, model.cfg), model.cfg).float()
            for h in (seq, whole)]
    d_logits = float((logits[0] - logits[1]).abs().max())
    top1 = float((logits[0].argmax(-1) == logits[1].argmax(-1)).float()
                 .mean())
    del logits, model, blocks
    flash = [[run["flash"] for run in r] for r in ranks]
    bubble = (PIPE_P - 1) / (PIPE_M + PIPE_P - 1)
    print(f"pipeline {PIPE_P} ranks x {len(mbs)} microbatches on one card "
          f"({card}): output {'equals' if equal else 'DIFFERS FROM'} the "
          f"microbatched sequential run bit for bit; whole-batch run "
          f"(reported): max |d logits| {d_logits:.4g}, top-1 agreement "
          f"{top1:.4f} (bound {BF16_ATOL}, {BF16_TOP1}); flash launches per "
          f"rank and run {flash}; bubble bound {bubble:.3f}")
    for r, runs in enumerate(ranks):
        for run in runs:
            print(f"  rank {r}: wall {run['wall_s']:.4f} s, stage busy "
                  f"{run['busy_s']:.4f} s, idle share "
                  f"{run['idle_share']:.4f}")
    check(equal, "the pipeline's output equals the microbatched sequential "
                 "run bit for bit")
    check(all(sum(f[i] for f in flash) == n_blocks * PIPE_M
              for i in range(PIPE_RUNS)),
          f"flash launches == {n_blocks} blocks x {PIPE_M} microbatches")
    return {"equal": equal, "flash_vs_plain": flash_held,
            "d_logits_whole_batch": d_logits,
            "top1_whole_batch": top1, "bubble_bound": bubble,
            "launches": sum(f[0] for f in flash), "ranks": ranks}


RESCALE_LAYERS = 2


def rescale_check(torch, card: str) -> dict:
    """Phase 13b: llama3.2-1b at full width with 2 layers, float32
    weights, checkpointed, then ``ft.elastic.rescale`` under a world-1
    gloo group on the card: every restored leaf a DTensor on the rebuilt
    (1, 1) mesh, equal bit for bit to the saved tensor."""
    import shutil

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import registry
    from repro_torch.ft import elastic
    from repro_torch.models import params as pm
    from repro_torch.models.model import Model
    cfg = registry.get(SERVE_ARCH).replace(num_layers=RESCALE_LAYERS)
    model = Model(cfg).init(SERVE_SEED)
    ckpt = PIPE_DIR / "ckpt"
    shutil.rmtree(PIPE_DIR, ignore_errors=True)
    PIPE_DIR.mkdir(parents=True)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(PIPE_DIR / "store1"), 1), rank=0, world_size=1)
    try:
        mgr = CheckpointManager(str(ckpt), async_save=False)
        t0 = time.perf_counter()
        mgr.save(1, model.weights())
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        mesh, plan, params, step = elastic.rescale(cfg, mgr, model, 1)
        restore_s = time.perf_counter() - t0
        saved = pm.tree_leaves(model.weights())
        leaves = pm.tree_leaves(params)
        ok = (step == 1 and len(leaves) == len(saved) and all(
            isinstance(a, DTensor) and a.device_mesh is mesh
            and torch.equal(a.full_tensor(), b)
            for a, b in zip(leaves, saved)))
        nbytes = sum(b.numel() * b.element_size() for b in saved)
        print(f"rescale ({card}): {len(leaves)} leaves, "
              f"{nbytes / 2 ** 30:.3f} GiB, onto mesh {tuple(mesh.shape)} "
              f"{mesh.mesh_dim_names} ({mesh.device_type}); save "
              f"{save_s:.2f} s, rescale {restore_s:.2f} s; every leaf a "
              f"DTensor equal to the saved tensor: {ok}")
        check(ok, "every restored leaf is a DTensor equal bit for bit to "
                  "the saved tensor")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(PIPE_DIR, ignore_errors=True)
    return {"leaves": len(leaves), "bytes": nbytes, "save_s": save_s,
            "rescale_s": restore_s, "plan_tp": plan.tp}


# the train step across ranks (phase 13c): 4 gloo ranks on cuda:0 as
# {data 2, model 2}; the float32 gate at 2 layers, hoist_gather off and on,
# then bf16 over float32 masters at 8 of the 16 layers (cut from 16 to
# pay for phase 13e)
SPMD_WORLD, SPMD_MODEL = 4, 2
SPMD_B, SPMD_S, SPMD_ACCUM = 4, 1024, 2
SPMD_GATE_LAYERS, SPMD_RUN_STEPS, SPMD_RUN_LAYERS = 2, 2, 8
SEQ_RUN_STEPS = 1  # phase 13f's bf16 steps with sequence parallelism
# phases 13c, 13d and 13e run in one spawned world (a spawn each cost ~15 s)
SPMD_DIR = ROOT / "build" / "spmd_world"


def _spmd_batch(torch, cfg):
    toks = torch.randint(0, cfg.vocab_size, (SPMD_B, SPMD_S + 1), device=DEV,
                         generator=torch.Generator(device=DEV).manual_seed(5))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _local_bytes(tree) -> int:
    from repro_torch.models import params as pm
    return sum(t.to_local().numel() * t.to_local().element_size()
               for t in pm.tree_leaves(tree))


def spmd_gate(torch, rank: int, mesh) -> dict:
    """One rank's float32 gate: the sharded step's gradients with
    hoist_gather off and on, gathered; rank 0 holds them against the
    one-process step through the same kernels, and each of its flash
    calls in the step (its local heads at its rows of a microbatch: the
    kernel's shapes on this path) against the plain version. The shard
    bytes beside the dry run's count."""
    import torch.distributed as dist

    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.train import init_sharded
    from repro_torch.models import params as pm
    from repro_torch.models.model import Model
    from repro_torch.sharding import spmd
    from repro_torch.sharding.plan import make_plan
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.step import make_grad_fn, make_train_step
    cfg = registry.get(TRAIN_ARCH).replace(num_layers=SPMD_GATE_LAYERS,
                                           dtype="float32")
    opt = make_optimizer(cfg)
    model = Model(cfg, plan=make_plan(cfg, mesh))
    params, state = init_sharded(model, opt, TRAIN_SEED)
    batch = _spmd_batch(torch, cfg)
    low = dryrun.lower_cell(cfg, ShapeSpec("spmd_gate", SPMD_S, SPMD_B,
                                           "train"), mesh)
    out = {"shard_bytes": _local_bytes(params) + _local_bytes(state),
           "dryrun_bytes": low.argument_bytes() - sum(
               dryrun.tree_bytes(t, sp, mesh)
               for t, sp in zip(low.args[2:], low.arg_specs[2:])),
           "n_accum_dryrun": low.info["n_accum"], "runs": {},
           "flash_vs_plain": {}}
    got = {}
    n_calls = SPMD_GATE_LAYERS * 2 * SPMD_ACCUM
    for hoist in (False, True):
        step = make_train_step(model, opt, n_accum=SPMD_ACCUM,
                               hoist_gather=hoist)
        taps = kernel_taps("flash", lambda i, *a: i if rank == 0 else None)
        dist.barrier()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with taps:
            loss, _, grads = step.grads(params, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        if rank == 0:
            out["flash_vs_plain"][str(hoist)] = hold_flash_taps(
                torch, taps.cases, n_calls,
                f"sharded float32 step (hoist_gather={hoist})")
        del taps
        full = [spmd.full_tensor(g) for g in pm.tree_leaves(grads)]
        if rank == 0:
            got[hoist] = (float(loss), full)
        del full
        out["runs"][str(hoist)] = {"wall_s": wall, "loss": float(loss),
                                   "flash": counts["flash_attention"],
                                   "launches": counts}
        if hoist:  # phase 13f: the same step with the flag
            out["seq"] = seq_gate(torch, rank, cfg, mesh, params, batch,
                                  grads, float(loss), {"flash": n_calls})
        del grads
    del params, state
    if rank == 0:  # the one-process step on the card, the same kernels
        one = Model(cfg).init(TRAIN_SEED)
        loss1, _, ref = make_grad_fn(one, SPMD_ACCUM)(one.weights(), batch)
        names = _leaf_names(ref)
        ref = [r.double() for r in pm.tree_leaves(ref)]
        for hoist, (loss, gs) in got.items():
            errs = {n: _rel_err(a, b) for n, a, b in zip(names, gs, ref)}
            worst = max(errs, key=errs.get)
            out["runs"][str(hoist)].update(
                one_process_loss=float(loss1),
                loss_rel_err=abs(loss - float(loss1)) / abs(float(loss1)),
                worst_rel_err=errs[worst], worst_leaf=worst)
        del one, ref
    del got
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _timed_steps(torch, rank: int, step_fn, params, state, batch,
                 layers: int, first: int, n: int, label: str):
    """``n`` steps of ``step_fn`` from step ``first``, each with the counts
    set to 0 just before it: wall (host clock after the loss is read),
    tokens/s, loss and flash launches per step; rank 0's flash calls on
    the first microbatch's forward of the first step held against the
    plain version after it."""
    import torch.distributed as dist
    steps, held = [], None
    for i in range(n):
        taps = kernel_taps("flash", lambda c, *a: c if rank == 0 and i == 0
                           and c < layers else None)
        dist.barrier()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with taps:
            params, state, metrics = step_fn(params, state, batch, first + i)
            loss = float(metrics["loss"])
        wall = time.perf_counter() - t0
        steps.append({"wall_s": wall, "tokens_per_s": SPMD_B * SPMD_S / wall,
                      "loss": loss, "flash": read_counts()["flash_attention"]})
        if taps.cases:
            held = hold_flash_taps(torch, taps.cases, layers, label)
        del taps
    return params, state, steps, held


def spmd_timed(torch, rank: int, mesh) -> dict:
    """bf16 over float32 masters at SPMD_RUN_LAYERS, ``hoist_gather`` on (one
    bf16 gather a step in place of a float32 one a microbatch: 14.0-15.6 s
    a step without it on the H100, against 7.1-9.3 s with it in the
    float32 gate's 2 layers): SPMD_RUN_STEPS steps (:func:`_timed_steps`)
    and this rank's peak memory; then (phase 13f) SEQ_RUN_STEPS more with
    sequence parallelism, from where those left the state, their peak
    memory apart."""
    from repro_torch.configs import registry
    from repro_torch.launch.train import init_sharded
    from repro_torch.models.model import Model
    from repro_torch.sharding.plan import make_plan
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.step import make_train_step
    cfg = registry.get(TRAIN_ARCH).replace(num_layers=SPMD_RUN_LAYERS)
    opt = make_optimizer(cfg)
    model = Model(cfg, plan=make_plan(cfg, mesh))
    params, state = init_sharded(model, opt, TRAIN_SEED)
    batch = _spmd_batch(torch, cfg)
    layers = cfg.num_layers
    out = {"layers": layers}
    for sp in (False, True):
        model = Model(cfg, plan=make_plan(cfg, mesh, sequence_parallel=sp))
        step_fn = make_train_step(model, opt, n_accum=SPMD_ACCUM,
                                  hoist_gather=True)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, state, steps, held = _timed_steps(
            torch, rank, step_fn, params, state, batch, layers,
            SPMD_RUN_STEPS * sp, SEQ_RUN_STEPS if sp else SPMD_RUN_STEPS,
            "sharded bf16 step" + (" with sequence parallelism" if sp
                                   else ""))
        run = {"steps": steps, "flash_vs_plain": held,
               "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
               "total_s": time.perf_counter() - t0}
        if sp:
            out["seq"] = run
        else:
            out.update(run)
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def spmd_train_check(torch, card: str, ranks: list) -> dict:
    """Phase 13c: the sharded train step over 4 gloo ranks on the card
    (module docstring; ``ranks``: each rank's results of it from
    :func:`spmd_world`), then the dry run of llama3.2-1b's cells."""
    from repro_torch.configs import registry
    from repro_torch.launch import dryrun
    gate = ranks[0]["gate"]
    want_flash = SPMD_WORLD * SPMD_GATE_LAYERS * 2 * SPMD_ACCUM
    for hoist, run in gate["runs"].items():
        flash = sum(r["gate"]["runs"][hoist]["flash"] for r in ranks)
        print(f"[{card}] sharded step {TRAIN_ARCH} {SPMD_GATE_LAYERS} layers "
              f"float32 {{data 2, model 2}} B={SPMD_B} S={SPMD_S} "
              f"n_accum={SPMD_ACCUM} hoist_gather={hoist}: loss "
              f"{run['loss']:.6f} (one process {run['one_process_loss']:.6f},"
              f" rel {run['loss_rel_err']:.3e}), worst leaf rel err "
              f"{run['worst_rel_err']:.3e} at {run['worst_leaf']} (tol "
              f"{TRAIN_GATE_TOL:g}), flash launches {flash} (gate "
              f"{want_flash}), rank walls "
              f"{[round(r['gate']['runs'][hoist]['wall_s'], 3) for r in ranks]}"
              f" s")
        check(run["worst_rel_err"] <= TRAIN_GATE_TOL
              and run["loss_rel_err"] <= TRAIN_GATE_TOL,
              f"sharded step (hoist_gather={hoist}) == one-process step")
        check(flash == want_flash, f"sharded step: flash launches == "
                                   f"{want_flash}")
    held = [*gate["flash_vs_plain"].values(),
            ranks[0]["timed"]["flash_vs_plain"]]
    check(len(held) == 3 and all(h is not None for h in held),
          "sharded step: rank 0's flash calls held against the plain "
          "version (gate, hoist off and on; bf16 step 0)")
    byte_ok = all(r["gate"]["shard_bytes"] == r["gate"]["dryrun_bytes"]
                  for r in ranks)
    print(f"[{card}] shard bytes per rank "
          f"{[r['gate']['shard_bytes'] for r in ranks]}, dry run's "
          f"argument bytes less batch and step {gate['dryrun_bytes']}")
    check(byte_ok, "each rank's shard bytes == the dry run's count")
    for r, rr in enumerate(ranks):
        t = rr["timed"]
        print(f"[{card}] sharded bf16 step, {t['layers']} layers, "
              f"hoist_gather=True, rank {r}: "
              + ", ".join(f"step {i} {s['wall_s']:.3f} s "
                          f"({s['tokens_per_s']:.1f} tokens/s, flash "
                          f"{s['flash']}, loss {s['loss']:.4f})"
                          for i, s in enumerate(t["steps"]))
              + f"; peak {t['peak_mib']:.1f} MiB")
    timed_flash = [sum(rr["timed"]["steps"][i]["flash"] for rr in ranks)
                   for i in range(SPMD_RUN_STEPS)]
    check(all(np.isfinite(s["loss"]) for rr in ranks
              for s in rr["timed"]["steps"]), "sharded bf16: finite losses")
    layers = ranks[0]["timed"]["layers"]
    check(timed_flash == [SPMD_WORLD * layers * 2 * SPMD_ACCUM]
          * SPMD_RUN_STEPS, "sharded bf16: flash launches == ranks x "
                            "layers x 2 x microbatches a step")
    t0 = time.perf_counter()
    cells = [dryrun.run_cell(TRAIN_ARCH, shape, mesh)
             for shape in registry.get(TRAIN_ARCH).shapes()
             for mesh in ("pod", "multipod")]
    dry_s = time.perf_counter() - t0
    check(all(c["ok"] for c in cells), "dry run: llama3.2-1b's cells ok")
    print(f"[{card}] dry run of {TRAIN_ARCH}: {len(cells)} cells ok in "
          f"{dry_s:.1f} s on the host; 13c in the world "
          f"{ranks[0]['world_s']:.1f} s")
    return {"gate": gate["runs"], "flash_vs_plain": held,
            "shard_bytes": [r["gate"]["shard_bytes"] for r in ranks],
            "dryrun_bytes": gate["dryrun_bytes"],
            "flash_gate": sum(r["gate"]["runs"][h]["flash"] for r in ranks
                              for h in gate["runs"]),
            "timed": [rr["timed"] for rr in ranks],
            "timed_flash": timed_flash,
            "dryrun_cells": [{k: c[k] for k in (
                "shape", "mesh", "ok", "argument_bytes_per_device",
                "output_bytes_per_device", "run_s", "flops_model")}
                for c in cells],
            "world_s": ranks[0]["world_s"], "dryrun_s": dry_s}


# the sharded step of the moe, ssm and hybrid families (phase 13d): one
# 4-rank gloo world on cuda:0, float32 at full width and cut depth, phase
# 13c's global batch (B 4, S 1024, 2 microbatches), the FSDP gather
# hoisted as the CLI runs it; (arch, model axis, the cut). zamba2: one
# hybrid group of 6 mamba layers and the shared block, then 1 tail layer;
# mixtral: one MoE layer (1.71 B parameters)
FAM_RUNS = (("mamba2-780m", 2, {"num_layers": 2}),
            ("zamba2-1.2b", 2, {"num_layers": 7}),
            ("mixtral-8x7b", 4, {"num_layers": 1}))
FAM_SEED = 3
# the recurrent families' float32 floor: the one-process step again with
# every master moved by one float32 ulp (times a random sign), leaf by
# leaf the distance to the unmoved step; a sharded leaf passes within
# TRAIN_GATE_TOL plus FAM_FLOOR_FACTOR times it
FAM_FLOOR_ULP = 2.0 ** -23
FAM_FLOOR_FACTOR = 10.0


def _fam_calls(cfg) -> dict:
    """Each kernel's calls on one rank in a step of phase 13d: per layer
    (mamba) or hybrid group (the shared attention's flash), twice under
    remat, once per microbatch; mixtral's windowed attention takes
    ``_sdpa``."""
    remat = 2 if cfg.remat == "full" else 1
    groups = cfg.num_layers // cfg.hybrid_attn_every \
        if cfg.family == "hybrid" else 0
    scan = cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0
    return {"mamba": scan * remat * SPMD_ACCUM,
            "flash": groups * remat * SPMD_ACCUM}


def hold_scan_taps(torch, cases, n_calls: int, what: str) -> dict:
    """Each tapped scan call (the kernel's y and final state in the run)
    against ``mamba_scan_ref`` on the same inputs, bit for bit."""
    from repro_torch.kernels import mamba_scan as MS
    check(sorted(cases) == list(range(n_calls)),
          f"{what}: {n_calls} scan calls tapped")
    worst = 0.0
    for i, (args, kw, got) in sorted(cases.items()):
        want = MS.mamba_scan_ref(*args, **kw)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            worst = max(worst, float((g.float() - w.float()).abs().max()))
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"{what} call {i}: scan kernel == plain bit for bit (y and "
              f"the final state)")
    xh, bm = cases[0][0][0], cases[0][0][3]
    print(f"  scan at the {what}'s shapes, xh={tuple(xh.shape)} "
          f"B={tuple(bm.shape)} {str(xh.dtype).split('.')[-1]} chunk="
          f"{cases[0][1].get('chunk')}: {n_calls} calls, "
          f"max|kernel-plain|={worst:.3e}")
    return {"xh": list(xh.shape), "B": list(bm.shape),
            "dtype": str(xh.dtype).split(".")[-1], "calls": n_calls,
            "max_abs_err": worst}


def _fam_floor(torch, one, batch, names, ref) -> dict:
    """Leaf by leaf, how far the one-process step's gradients move when
    every master moves by one float32 ulp (``FAM_FLOOR_ULP`` times a random
    sign): the recurrent families' float32 floor. A perturbation of the
    steps in a Mamba2 chunk's decay exponent (a cumulative sum of dt A,
    hundreds in magnitude over 256 steps) comes out of each exp(cs_i -
    cs_j) hundreds of times larger, and compounds layer by layer."""
    from repro_torch.models import params as pm
    from repro_torch.train.step import make_grad_fn
    gen = torch.Generator(device=DEV)
    gen.manual_seed(FAM_SEED + 1)
    moved = pm.tree_map(lambda t: t * (1 + FAM_FLOOR_ULP * (torch.randint(
        0, 2, t.shape, generator=gen, device=DEV) * 2 - 1)), one.weights())
    _, _, bumped = make_grad_fn(one, SPMD_ACCUM)(moved, batch)
    return {n: _rel_err(b, a.double()) for n, a, b in zip(
        names, pm.tree_leaves(ref), pm.tree_leaves(bumped))}


def fam_gate(torch, rank: int, meshes: dict, arch: str, tp: int,
             cut: dict) -> dict:
    """One config of phase 13d on this rank: the sharded step's float32
    gradients (rank 0's flash and scan calls tapped), gathered; rank 0
    then takes the one-process step on the card through the same kernels
    and holds every leaf against it, and its tapped calls against the
    plain versions."""
    import torch.distributed as dist

    from repro_torch.configs import registry
    from repro_torch.models import params as pm
    from repro_torch.models.model import Model
    from repro_torch.sharding import spmd
    from repro_torch.sharding.plan import make_plan
    from repro_torch.train.step import make_grad_fn, make_sharded_grad_fn
    cfg = registry.get(arch).replace(dtype="float32", **cut)
    plan = make_plan(cfg, meshes[tp])
    model = Model(cfg, plan=plan)
    meta = model.param_meta()
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(FAM_SEED)  # Model.init's draws
    full = pm.materialize(meta, gen, cfg.param_dtype, DEV)
    it = iter(pm.tree_leaves(plan.param_shardings(meta)))
    params = pm.tree_map(lambda t: spmd.place(t, next(it)), full)
    del full
    gc.collect()
    torch.cuda.empty_cache()
    batch = _spmd_batch(torch, cfg)
    grad_fn = make_sharded_grad_fn(model, SPMD_ACCUM, hoist_gather=True)
    mine = lambda i, *a: i if rank == 0 else None
    taps = {k: kernel_taps(k, mine) for k in ("flash", "mamba")}
    dist.barrier()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t_init, t0 = t0, time.perf_counter()
    with taps["flash"], taps["mamba"]:
        loss, metrics, grads = grad_fn(params, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    out = {"arch": arch, "layers": cfg.num_layers, "model": tp,
           "data": 4 // tp, "init_s": t0 - t_init, "wall_s": wall,
           "loss": float(loss),
           "moe_aux": float(metrics.get("moe_aux", float("nan"))),
           "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
           "scan": counts["mamba_scan"], "flash": counts["flash_attention"],
           "params": model.n_params()}
    calls = _fam_calls(cfg)
    out["seq"] = seq_gate(torch, rank, cfg, meshes[tp], params, batch, grads,
                          float(loss), {"flash": calls["flash"],
                                        "mamba": calls["mamba"]})
    t0 = time.perf_counter()
    names = _leaf_names(grads)
    got = rank0_leaves(torch, grads)
    out["gather_s"] = time.perf_counter() - t0
    del grads, params
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:
        label = f"sharded {arch} step"
        out["flash_vs_plain"] = (hold_flash_taps(
            torch, taps["flash"].cases, calls["flash"], label)
            if calls["flash"] else None)
        out["scan_vs_plain"] = (hold_scan_taps(
            torch, taps["mamba"].cases, calls["mamba"], label)
            if calls["mamba"] else None)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        one = Model(registry.get(arch).replace(dtype="float32", **cut)) \
            .init(FAM_SEED)
        loss1, m1, ref = make_grad_fn(one, SPMD_ACCUM)(one.weights(), batch)
        torch.cuda.synchronize()
        out["one_process_s"] = time.perf_counter() - t0
        out["one_process_peak_mib"] = \
            torch.cuda.max_memory_allocated() / 2 ** 20
        floors = {}
        if cfg.family in ("ssm", "hybrid"):
            floors = _fam_floor(torch, one, batch, names, ref)
        del one
        errs = {}
        for n, a, b in zip(names, got, pm.tree_leaves(ref)):
            errs[n] = _rel_err(a.to(DEV), b.double())
        del ref, got
        worst = max(errs, key=errs.get)
        out.update(leaf_rel_errs=errs, floors=floors,
                   one_process_loss=float(loss1),
                   one_process_moe_aux=float(m1.get("moe_aux",
                                                    float("nan"))),
                   loss_rel_err=abs(float(loss) - float(loss1))
                   / abs(float(loss1)),
                   worst_rel_err=errs[worst], worst_leaf=worst)
    del taps
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def spmd_families_check(torch, card: str, ranks: list) -> dict:
    """Phase 13d: the sharded train step of the moe, ssm and hybrid
    families over 4 gloo ranks on the card (FAM_RUNS; ``ranks``: each
    rank's results of it from :func:`spmd_world`), each config's loss
    and every leaf's gradient against the one-process step on the card
    (``TRAIN_GATE_TOL``, phase 13c's gate; for mamba2 and zamba2 plus
    ``FAM_FLOOR_FACTOR`` times their float32 floor, :func:`_fam_floor`),
    the launches of the scan and flash kernels gated, rank 0's calls of
    each held bit for bit against the plain versions."""
    from repro_torch.configs import registry
    world_s = ranks[0]["world_s"]
    ranks = [r["runs"] for r in ranks]
    runs, held = [], {"flash": [], "scan": []}
    launches = {"flash": 0, "scan": 0}
    for i, (arch, tp, cut) in enumerate(FAM_RUNS):
        r0 = ranks[0][i]
        cfg = registry.get(arch).replace(**cut)
        calls = _fam_calls(cfg)
        got = {k: sum(rr[i][k] for rr in ranks) for k in ("scan", "flash")}
        want = {"scan": SPMD_WORLD * calls["mamba"],
                "flash": SPMD_WORLD * calls["flash"]}
        peaks = [round(rr[i]["peak_mib"], 1) for rr in ranks]
        print(f"[{card}] sharded step {arch} {cfg.num_layers} layers "
              f"({r0['params']:,} parameters) float32 {{data "
              f"{r0['data']}, model {tp}}} B={SPMD_B} S={SPMD_S} "
              f"n_accum={SPMD_ACCUM}: loss {r0['loss']:.6f} (one process "
              f"{r0['one_process_loss']:.6f}, rel {r0['loss_rel_err']:.3e})"
              + (f", moe_aux {r0['moe_aux']:.6f} (one process "
                 f"{r0['one_process_moe_aux']:.6f})" if cfg.is_moe else "")
              + f", worst leaf rel err {r0['worst_rel_err']:.3e} at "
              f"{r0['worst_leaf']} (tol {TRAIN_GATE_TOL:g}), scan launches "
              f"{got['scan']} (gate {want['scan']}), flash launches "
              f"{got['flash']} (gate {want['flash']}), rank walls "
              f"{[round(rr[i]['wall_s'], 3) for rr in ranks]} s, peak "
              f"memory per rank {peaks} MiB, the one-process step's "
              f"{r0['one_process_peak_mib']:.1f} MiB")
        floors = r0["floors"]
        over = {n: e for n, e in r0["leaf_rel_errs"].items()
                if e > TRAIN_GATE_TOL + FAM_FLOOR_FACTOR * floors.get(n, 0.0)}
        if floors:
            ratio = max(e / max(floors[n], 1e-30)
                        for n, e in r0["leaf_rel_errs"].items())
            print(f"  float32 floor of {arch} (one-process step, masters "
                  f"moved one ulp): largest {max(floors.values()):.3e}; "
                  f"the sharded step's distance over the floor, largest "
                  f"{ratio:.3f} (gate: {TRAIN_GATE_TOL:g} + "
                  f"{FAM_FLOOR_FACTOR:g} x the floor, leaf by leaf)")
        check(not over and r0["loss_rel_err"] <= TRAIN_GATE_TOL
              and np.isfinite(r0["loss"]),
              f"sharded {arch} step == one-process step"
              + (f" (over the gate: {over})" if over else ""))
        check(got == want, f"sharded {arch} step: scan and flash launches "
                           f"== {want}")
        for k, tap in (("flash", "flash_vs_plain"), ("scan", "scan_vs_plain")):
            check((r0[tap] is not None) == bool(want[k]),
                  f"sharded {arch} step: rank 0's {k} calls held against "
                  f"the plain version")
            if r0[tap] is not None:
                held[k].append(dict(r0[tap], arch=arch))
            launches[k] += got[k]
        runs.append({k: r0[k] for k in (
            "arch", "layers", "model", "data", "params", "loss",
            "one_process_loss", "loss_rel_err", "worst_rel_err",
            "worst_leaf", "moe_aux", "one_process_moe_aux", "init_s",
            "gather_s", "one_process_s", "one_process_peak_mib")}
            | {"walls_s": [rr[i]["wall_s"] for rr in ranks],
               "peak_mib": peaks, "launches": got,
               "floor_max": max(floors.values()) if floors else None,
               "floors_top": dict(sorted(floors.items(),
                                         key=lambda kv: -kv[1])[:5]),
               "worst_leaves": dict(sorted(
                   r0["leaf_rel_errs"].items(), key=lambda kv: -kv[1])[:5])})
    print(f"[{card}] phase 13d: {world_s:.1f} s in the world")
    return {"runs": runs, "held": held, "launches": launches,
            "world_s": world_s}


# sequence parallelism (phase 13f), in the same world: 13c's float32 gate
# (llama3.2-1b, 2 layers, {data 2, model 2}), 13d's three configs and 13e's
# whisper-small on {data 2, model 2}, each taken again from the same
# weights and batch under make_plan(..., sequence_parallel=True), hoisted,
# and held against the same run without the flag on the ranks' shards (the
# flag moves activations only, so the gradients come back at the same
# placements): no gather to rank 0. Then 13c's bf16 run continues for
# SEQ_RUN_STEPS steps with the flag (spmd_timed)
def seq_gate(torch, rank: int, cfg, mesh, params, batch, base, base_loss,
             holds: dict, kinds: bool = False) -> dict:
    """One run of phase 13f on this rank: the sharded step with sequence
    parallelism from ``params`` and ``batch`` (hoisted), the counts set to
    0 just before it; every leaf's gradient against ``base`` (the same
    step's without the flag) on this rank's shard, each leaf's largest
    distance and magnitude max-reduced over the world, so every rank holds
    each leaf's relative error. Rank 0's calls of each kernel in
    ``holds`` ({"flash" or "mamba": calls}; with ``kinds`` the first flash
    call of each kind, :func:`kind_taps`) held against the plain versions
    bit for bit."""
    import torch.distributed as dist

    from repro_torch.models import params as pm
    from repro_torch.models.model import Model
    from repro_torch.sharding.plan import make_plan
    from repro_torch.train.step import make_sharded_grad_fn
    t_start = time.perf_counter()
    model = Model(cfg, plan=make_plan(cfg, mesh, sequence_parallel=True))
    grad_fn = make_sharded_grad_fn(model, SPMD_ACCUM, hoist_gather=True)
    taps = {k: kind_taps(rank) if kinds and k == "flash" else kernel_taps(
        k, lambda i, *a: i if rank == 0 else None) for k, n in holds.items()
        if n}
    dist.barrier()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for t in taps.values():
            stack.enter_context(t)
        loss, _, grads = grad_fn(params, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    names = _leaf_names(grads)
    stats = torch.stack([torch.stack([
        (a.to_local().double() - b.to_local().double()).abs().max(),
        b.to_local().double().abs().max()])
        for a, b in zip(pm.tree_leaves(grads), pm.tree_leaves(base))])
    del grads
    dist.all_reduce(stats, op=dist.ReduceOp.MAX)
    errs = dict(zip(names, (stats[:, 0] / stats[:, 1]).tolist()))
    worst = max(errs, key=errs.get)
    out = {"arch": cfg.name, "wall_s": wall, "loss": float(loss),
           "loss_rel_err": abs(float(loss) - base_loss) / abs(base_loss),
           "peak_mib": peak, "flash": counts["flash_attention"],
           "scan": counts["mamba_scan"], "leaf_rel_errs": errs,
           "worst_rel_err": errs[worst], "worst_leaf": worst, "held": {}}
    if rank == 0:
        label = f"sharded {cfg.name} step with sequence parallelism"
        for k, tap in taps.items():
            hold = hold_flash_taps if k == "flash" else hold_scan_taps
            out["held"][k] = hold(torch, tap.cases, holds[k], label)
    del taps
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    out["total_s"] = time.perf_counter() - t_start
    return out


def spmd_seq_check(card: str, ranks: list) -> dict:
    """Phase 13f (``ranks``: every rank's results of phases 13c-13e from
    :func:`spmd_world`): each run with sequence parallelism against the
    same run without it, every leaf within 13c's gate (``TRAIN_GATE_TOL``;
    for mamba2 and zamba2 13d's, plus ``FAM_FLOOR_FACTOR`` times their
    one-ulp floor from 13d), the loss too; its flash and scan launches
    equal to those of the run without the flag; rank 0's calls held; then
    the bf16 steps with the flag beside 13c's."""
    fam = [r["13d"]["runs"] for r in ranks]
    whisper = next(i for i, (arch, mesh, _, _) in enumerate(MM_SPMD_RUNS)
                   if (arch, mesh) == ("whisper-small", "d2m2"))
    gates = [("13c", [r["13c"]["gate"]["seq"] for r in ranks], {},
              {"flash": sum(r["13c"]["gate"]["runs"]["True"]["flash"]
                            for r in ranks), "scan": 0})]
    for i, (arch, tp, cut) in enumerate(FAM_RUNS):
        gates.append((f"13d {arch}", [f[i]["seq"] for f in fam],
                      fam[0][i]["floors"],
                      {"flash": sum(f[i]["flash"] for f in fam),
                       "scan": sum(f[i]["scan"] for f in fam)}))
    mm = [r["13e"]["runs"][whisper] for r in ranks]
    gates.append(("13e whisper-small", [m["seq"] for m in mm], {},
                  {"flash": sum(m["flash"] for m in mm), "scan": 0}))
    runs, held, launches, world_s = [], {"flash": [], "scan": []}, \
        {"flash": 0, "scan": 0}, 0.0
    for what, rr, floors, want in gates:
        r0 = rr[0]
        got = {k: sum(r[k] for r in rr) for k in ("flash", "scan")}
        over = {n: e for n, e in r0["leaf_rel_errs"].items()
                if e > TRAIN_GATE_TOL + FAM_FLOOR_FACTOR * floors.get(n, 0.0)}
        print(f"[{card}] phase 13f, {what} with sequence parallelism: loss "
              f"{r0['loss']:.6f} (rel {r0['loss_rel_err']:.3e} from the "
              f"step without it), worst leaf rel err "
              f"{r0['worst_rel_err']:.3e} at {r0['worst_leaf']} (gate "
              f"{TRAIN_GATE_TOL:g}" + (f" + {FAM_FLOOR_FACTOR:g} x the "
                                       f"floor" if floors else "")
              + f"), flash launches {got['flash']} (gate {want['flash']}), "
              f"scan launches {got['scan']} (gate {want['scan']}), rank "
              f"walls {[round(r['wall_s'], 3) for r in rr]} s, peak memory "
              f"per rank {[round(r['peak_mib'], 1) for r in rr]} MiB")
        check(not over and r0["loss_rel_err"] <= TRAIN_GATE_TOL,
              f"13f {what}: sequence parallelism == the step without it"
              + (f" (over the gate: {over})" if over else ""))
        check(got == want, f"13f {what}: launches {got} == {want}")
        for k in ("flash", "scan"):
            tap = r0["held"].get("mamba" if k == "scan" else k)
            check((tap is not None) == bool(want[k]),
                  f"13f {what}: rank 0's {k} calls held")
            if tap is not None:
                held[k].append(dict(tap, run=what))
            launches[k] += got[k]
        world_s += r0["total_s"]
        runs.append({k: r0[k] for k in (
            "arch", "loss", "loss_rel_err", "worst_rel_err", "worst_leaf")}
            | {"what": what, "walls_s": [r["wall_s"] for r in rr],
               "peak_mib": [r["peak_mib"] for r in rr], "launches": got})
    timed = [r["13c"]["timed"] for r in ranks]
    layers = timed[0]["layers"]
    for r, t in enumerate(timed):
        for name, run in (("without", t), ("with", t["seq"])):
            print(f"[{card}] sharded bf16 step, {layers} layers, hoisted, "
                  f"{name} sequence parallelism, rank {r}: "
                  + ", ".join(f"step {i} {s['wall_s']:.3f} s "
                              f"({s['tokens_per_s']:.1f} tokens/s, flash "
                              f"{s['flash']}, loss {s['loss']:.4f})"
                              for i, s in enumerate(run["steps"]))
                  + f"; peak {run['peak_mib']:.1f} MiB")
    seq_flash = [sum(t["seq"]["steps"][i]["flash"] for t in timed)
                 for i in range(SEQ_RUN_STEPS)]
    check(all(np.isfinite(s["loss"]) for t in timed
              for s in t["seq"]["steps"]), "13f bf16: finite losses")
    check(seq_flash == [SPMD_WORLD * layers * 2 * SPMD_ACCUM]
          * SEQ_RUN_STEPS, "13f bf16: flash launches == ranks x layers x "
                           "2 x microbatches a step")
    check(timed[0]["seq"]["flash_vs_plain"] is not None,
          "13f bf16: rank 0's flash calls held against the plain version")
    held["flash"].append(dict(timed[0]["seq"]["flash_vs_plain"],
                              run="13f bf16"))
    world_s += timed[0]["seq"]["total_s"]
    print(f"[{card}] phase 13f: {world_s:.1f} s in the world")
    return {"runs": runs, "held": held, "launches": launches,
            "bf16": {"steps": [t["seq"]["steps"] for t in timed],
                     "peak_mib": [t["seq"]["peak_mib"] for t in timed],
                     "without_steps": [t["steps"] for t in timed],
                     "without_peak_mib": [t["peak_mib"] for t in timed],
                     "flash": seq_flash},
            "world_s": world_s}


def rank0_leaves(torch, tree):
    """Every leaf of a tree of ``DTensor`` s whole on rank 0's host (None
    on the other ranks): each rank copies its shard to the host and a gloo
    gather of the host shards brings them to rank 0 (gloo gathers no CUDA
    tensor), which joins them by placement, mesh dimension by mesh
    dimension (pod before data: the reference's pod-major split). A
    quarter of the bytes of an all-gather to every rank."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    from repro_torch.models import params as pm
    rank, n = dist.get_rank(), dist.get_world_size()
    out = [] if rank == 0 else None
    for x in pm.tree_leaves(tree):
        local = x.to_local().cpu()
        parts = [torch.empty_like(local) for _ in range(n)] \
            if rank == 0 else None
        dist.gather(local, parts, dst=0)
        del local
        if rank == 0:
            mesh = x.device_mesh
            ranks = mesh.mesh.tolist()

            def join(node, i):
                if i == mesh.ndim:
                    return parts[node]
                p = x.placements[i]
                if isinstance(p, Shard):
                    return torch.cat([join(c, i + 1) for c in node], p.dim)
                return join(node[0], i + 1)
            out.append(join(ranks, 0))
        del parts
    return out


# the sharded step of the vlm and audio families (phase 13e), in the same
# world, float32 at full width with the FSDP gather hoisted, the cross
# gates opened (MM_GATE: the init's zero gates shut every cross-attention's
# gradient). (arch, mesh, the cut, global batch): llama-3.2-vision-11b cut
# to one group (5 self-attention blocks and its gated cross block over
# 1601 image tokens, 2.36 B parameters) at 13c's batch; whisper-small whole
# (12 + 12 layers over 1500 frames) at B 8, on both meshes: its rows split
# over the 4 data ranks of {pod 2, data 2, model 1}. whisper's state on
# {data 2, model 2} then takes the checkpoint round trip (MM_CKPT_DIR)
MM_SPMD_RUNS = (("llama-3.2-vision-11b", "d2m2", {"num_layers": 5}, 4),
                ("whisper-small", "d2m2", {}, 8),
                ("whisper-small", "p2d2m1", {}, 8))
MM_SPMD_SEED, MM_GATE = 4, 0.5
MM_SPMD_MESHES = {"d2m2": (("data", "model"), (2, 2)),
                  "p2d2m1": (("pod", "data", "model"), (2, 2, 1))}
MM_CKPT_DIR = ROOT / "build" / "spmd_ckpt"
# the step after the save, taken twice, at (B, S): its bit-for-bit
# equality needs no long batch
MM_CKPT_BATCH = (4, 256)


def _mm_calls(cfg) -> dict:
    """A rank's flash calls in a step of phase 13e, every block's attention
    twice (remat: a vlm group, a whisper layer), once per microbatch; and
    the kinds of call the taps hold, one call each (vlm: self and cross;
    whisper: encoder, decoder self and cross)."""
    remat = 2 if cfg.remat == "full" else 1
    if cfg.family == "vlm":
        fwd = cfg.num_layers + cfg.num_layers // cfg.cross_attn_every
    else:
        fwd = cfg.encoder_layers + 2 * cfg.num_layers
    return {"per_step": fwd * remat * SPMD_ACCUM,
            "kinds": 2 if cfg.family == "vlm" else 3}


def kind_taps(rank: int) -> kernel_taps:
    """Rank 0's first flash call of each kind, (q's shape, k's shape), keyed
    0, 1, ... in the order the step first makes them."""
    seen = []

    def key(i, q, k, *rest):
        kind = (tuple(q.shape), tuple(k.shape))
        if rank or kind in seen:
            return None
        seen.append(kind)
        return len(seen) - 1
    return kernel_taps("flash", key)


def _mm_batch(torch, cfg, B: int, S: int = SPMD_S, seed: int = 5) -> dict:
    """Tokens and the frontend's stub inputs (0.1 N(0, 1) float32) from a
    generator seeded with ``seed`` on the card."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), device=DEV,
                         generator=g)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    key, shape = (("image_embeds", (B, cfg.num_image_tokens, cfg.d_model))
                  if cfg.family == "vlm" else
                  ("audio_frames", (B, cfg.encoder_frames, cfg.d_model)))
    out[key] = 0.1 * torch.randn(shape, device=DEV, generator=g)
    return out


def _mm_weights(torch, cfg, meta):
    """``Model.init`` 's draws from MM_SPMD_SEED, every cross gate at
    MM_GATE."""
    from repro_torch.models import params as pm
    gen = torch.Generator(device=DEV)
    gen.manual_seed(MM_SPMD_SEED)
    full = pm.materialize(meta, gen, cfg.param_dtype, DEV)

    def open_gates(tree):
        return {k: v.fill_(MM_GATE) if k == "gate" else open_gates(v)
                for k, v in tree.items()} if isinstance(tree, dict) else tree
    return open_gates(full)


def _state_equal(torch, a, b) -> bool:
    """Two trees of ``DTensor`` s with equal local shards, bit for bit."""
    from repro_torch.models import params as pm
    return all(x.placements == y.placements
               and torch.equal(x.to_local(), y.to_local())
               for x, y in zip(pm.tree_leaves(a), pm.tree_leaves(b)))


def mm_ckpt_round_trip(torch, rank, model, opt, params, state, loss,
                       metrics, grads) -> dict:
    """After the gate: the step's update, the sharded state saved across
    ranks (rank 0 writes), the next step, then the state restored with
    ``shardings`` on every rank and that step again: its loss and every
    leaf of the parameters and the optimizer state equal the
    uninterrupted run's, bit for bit."""
    import shutil

    import torch.distributed as dist

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.train.step import make_train_step
    step = make_train_step(model, opt, n_accum=SPMD_ACCUM, hoist_gather=True)
    params, state, _ = step.update(params, state, loss, metrics, grads, 0)
    if rank == 0:
        shutil.rmtree(MM_CKPT_DIR, ignore_errors=True)
    dist.barrier()
    mgr = CheckpointManager(str(MM_CKPT_DIR), keep_last=1,
                            across_ranks=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(1, {"params": params, "opt": state})
    save_s = time.perf_counter() - t0
    batch = _mm_batch(torch, model.cfg, *MM_CKPT_BATCH, seed=6)
    params, state, m = step(params, state, batch, 1)
    loss1 = float(m["loss"])
    t0 = time.perf_counter()
    mgr.wait()
    wait_s = time.perf_counter() - t0
    meta = model.param_meta()
    t0 = time.perf_counter()
    back, at = mgr.restore({"params": params, "opt": state}, shardings={
        "params": model.plan.param_shardings(meta),
        "opt": model.plan.param_shardings(opt.state_meta(meta))})
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    p2, s2, m2 = step(back["params"], back["opt"], batch, 1)
    ok = at == 1 and float(m2["loss"]) == loss1 \
        and _state_equal(torch, p2, params) and _state_equal(torch, s2, state)
    nbytes = os.path.getsize(MM_CKPT_DIR / "step_00000001" / "arrays.npz") \
        if rank == 0 else 0
    dist.barrier()
    if rank == 0:
        shutil.rmtree(MM_CKPT_DIR, ignore_errors=True)
    return {"ok": bool(ok), "loss": loss1, "resumed_loss": float(m2["loss"]),
            "save_s": save_s, "write_wait_s": wait_s,
            "restore_s": restore_s, "bytes": nbytes}


def mm_gate(torch, rank: int, mesh, arch: str, cut: dict, B: int,
            ckpt: bool, seq: bool) -> dict:
    """One run of phase 13e on this rank: the sharded step's float32
    gradients (rank 0's flash calls tapped, launches counted), gathered
    to rank 0's host; with ``seq`` phase 13f's run of the same step with
    sequence parallelism beside it; with ``ckpt`` the checkpoint round
    trip after it."""
    import torch.distributed as dist

    from repro_torch.configs import registry
    from repro_torch.models import params as pm
    from repro_torch.models.model import Model
    from repro_torch.sharding import spmd
    from repro_torch.sharding.plan import make_plan
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.step import make_sharded_grad_fn
    cfg = registry.get(arch).replace(dtype="float32", **cut)
    plan = make_plan(cfg, mesh)
    model = Model(cfg, plan=plan, device=DEV)
    meta = model.param_meta()
    t0 = time.perf_counter()
    full = _mm_weights(torch, cfg, meta)
    it = iter(pm.tree_leaves(plan.param_shardings(meta)))
    params = pm.tree_map(lambda t: spmd.place(t, next(it)), full)
    del full
    gc.collect()
    torch.cuda.empty_cache()
    batch = _mm_batch(torch, cfg, B)
    grad_fn = make_sharded_grad_fn(model, SPMD_ACCUM, hoist_gather=True)
    calls = _mm_calls(cfg)
    taps = kind_taps(rank)
    dist.barrier()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t_init, t0 = t0, time.perf_counter()
    with taps:
        loss, metrics, grads = grad_fn(params, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    out = {"arch": arch, "layers": cfg.num_layers, "mesh": dict(zip(
        mesh.mesh_dim_names, mesh.shape)), "B": B, "init_s": t0 - t_init,
        "wall_s": wall, "loss": float(loss),
        "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
        "flash": counts["flash_attention"], "launches": counts,
        "params": model.n_params(), "heads": plan.num_heads // plan.tp,
        "kv_heads": plan.num_kv_heads // plan.tp}
    if seq:
        out["seq"] = seq_gate(torch, rank, cfg, mesh, params, batch, grads,
                              float(loss), {"flash": calls["kinds"]},
                              kinds=True)
    t0 = time.perf_counter()
    got = rank0_leaves(torch, grads)
    out["gather_s"] = time.perf_counter() - t0
    out["names"] = _leaf_names(grads)
    if ckpt:
        opt = make_optimizer(cfg)
        state_meta = opt.state_meta(meta)
        it = iter(pm.tree_leaves(plan.param_shardings(state_meta)))
        state = pm.tree_map(lambda m: spmd.zeros(
            m.shape, pm.torch_dtype(m.dtype), next(it), DEV), state_meta)
        out["ckpt"] = mm_ckpt_round_trip(torch, rank, model, opt, params,
                                         state, loss, metrics, grads)
        del state
    del grads, params
    if rank == 0:
        out["flash_vs_plain"] = hold_flash_taps(
            torch, taps.cases, calls["kinds"],
            f"sharded {arch} step on {out['mesh']}")
        out["flash_vs_plain"]["kinds"] = [
            (tuple(a[0].shape), tuple(a[1].shape), kw.get("causal"))
            for _, (a, kw, _) in sorted(taps.cases.items())]
    del taps
    gc.collect()
    torch.cuda.empty_cache()
    return out, got, batch


def mm_hold(torch, arch: str, cut: dict, batch, runs) -> None:
    """Rank 0: the one-process step on the card through the same kernels,
    on the same weights and batch, and every run's gathered gradients
    (``runs``: (result, leaves)) against it, leaf by leaf."""
    from repro_torch.configs import registry
    from repro_torch.models import params as pm
    from repro_torch.models.model import Model
    from repro_torch.train.step import make_grad_fn
    cfg = registry.get(arch).replace(dtype="float32", **cut)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    one = Model(cfg, device=DEV)
    one.set_weights(_mm_weights(torch, cfg, one.param_meta()))
    loss1, _, ref = make_grad_fn(one, SPMD_ACCUM)(one.weights(), batch)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    del one
    ref = pm.tree_leaves(ref)
    for out, got in runs:
        errs = {n: _rel_err(a.to(DEV), b.double())
                for n, a, b in zip(out["names"], got, ref)}
        worst = max(errs, key=errs.get)
        out.update(one_process_loss=float(loss1), one_process_s=one_s,
                   one_process_peak_mib=peak,
                   loss_rel_err=abs(out["loss"] - float(loss1))
                   / abs(float(loss1)),
                   worst_rel_err=errs[worst], worst_leaf=worst,
                   worst_leaves=dict(sorted(errs.items(),
                                            key=lambda kv: -kv[1])[:5]))
    del ref
    gc.collect()
    torch.cuda.empty_cache()


def mm_spmd_runs(torch, rank: int) -> dict:
    """This rank's part of phase 13e: MM_SPMD_RUNS in turn, rank 0 holding
    each arch's runs against its one-process step once they are done."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    meshes = {k: DeviceMesh(DEV, torch.arange(SPMD_WORLD).reshape(sizes),
                            mesh_dim_names=names)
              for k, (names, sizes) in MM_SPMD_MESHES.items()}
    results, pending = [], []
    for i, (arch, mesh, cut, B) in enumerate(MM_SPMD_RUNS):
        whisper = (arch, mesh) == ("whisper-small", "d2m2")
        out, got, batch = mm_gate(torch, rank, meshes[mesh], arch, cut, B,
                                  ckpt=whisper, seq=whisper)
        results.append(out)
        pending.append((out, got))
        last = i + 1 == len(MM_SPMD_RUNS) or MM_SPMD_RUNS[i + 1][0] != arch
        if last:
            if rank == 0:
                mm_hold(torch, arch, cut, batch, pending)
            pending = []
            dist.barrier()
        del got, batch
    for out in results:
        del out["names"]
    return {"runs": results}


def spmd_worker(rank: int, world: int, store: str) -> None:
    """One rank of phases 13a and 13c-13f
    (``torch.multiprocessing.spawn`` target): a gloo group on cuda:0, the
    pipeline on ranks 0 and 1, then 13c's gate and timed run, each config
    of FAM_RUNS and each run of MM_SPMD_RUNS in turn, 13f's runs beside
    those they repeat; writes its results, each phase's wall in the world
    beside them, under SPMD_DIR."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        out, t0 = {}, time.perf_counter()
        pipe = dist.new_group(list(range(PIPE_P)))
        out["13a"] = pipe_run(torch, rank, pipe) if rank < PIPE_P else None
        dist.barrier()
        out["13a_s"], t0 = time.perf_counter() - t0, time.perf_counter()
        mesh = make_host_mesh(model=SPMD_MODEL)
        out["13c"] = {"gate": spmd_gate(torch, rank, mesh),
                      "timed": spmd_timed(torch, rank, mesh)}
        out["13c"]["world_s"], t0 = time.perf_counter() - t0, \
            time.perf_counter()
        meshes = {tp: make_host_mesh(model=tp)
                  for tp in sorted({tp for _, tp, _ in FAM_RUNS})}
        out["13d"] = {"runs": [fam_gate(torch, rank, meshes, arch, tp, cut)
                               for arch, tp, cut in FAM_RUNS]}
        out["13d"]["world_s"], t0 = time.perf_counter() - t0, \
            time.perf_counter()
        out["13e"] = mm_spmd_runs(torch, rank)
        out["13e"]["world_s"] = time.perf_counter() - t0
        (SPMD_DIR / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def spmd_world(torch) -> tuple:
    """Phases 13a and 13c-13f's 4-rank gloo world on cuda:0, spawned
    once -> (each rank's results, the spawn's wall in s, the pipeline's
    output on the host)."""
    import shutil

    import torch.multiprocessing as mp
    shutil.rmtree(SPMD_DIR, ignore_errors=True)
    SPMD_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    mp.spawn(spmd_worker, args=(SPMD_WORLD, str(SPMD_DIR / "store")),
             nprocs=SPMD_WORLD)
    world_s = time.perf_counter() - t0
    ranks = [json.loads((SPMD_DIR / f"rank{r}.json").read_text())
             for r in range(SPMD_WORLD)]
    pipe_out = torch.load(SPMD_DIR / "pipe_out.pt")
    shutil.rmtree(SPMD_DIR, ignore_errors=True)
    return ranks, world_s, pipe_out


def spmd_multimodal_check(card: str, ranks: list) -> dict:
    """Phase 13e: the sharded train step of the vlm and audio families
    over 4 gloo ranks on the card (MM_SPMD_RUNS; ``ranks``: each rank's
    results of it from :func:`spmd_world`): each run's loss and every
    leaf's gathered gradient against the one-process step on the card
    (``TRAIN_GATE_TOL``), the flash launches gated, rank 0's tapped flash
    calls held bit for bit against the plain version, and whisper's
    checkpoint round trip bit for bit."""
    from repro_torch.configs import registry
    world_s = ranks[0]["13e"]["world_s"]
    runs, held, launches = [], [], 0
    for i, (arch, mesh, cut, B) in enumerate(MM_SPMD_RUNS):
        r0 = ranks[0]["13e"]["runs"][i]
        cfg = registry.get(arch).replace(**cut)
        want = SPMD_WORLD * _mm_calls(cfg)["per_step"]
        flash = sum(rr["13e"]["runs"][i]["flash"] for rr in ranks)
        peaks = [round(rr["13e"]["runs"][i]["peak_mib"], 1) for rr in ranks]
        print(f"[{card}] sharded step {arch} {cfg.num_layers} layers "
              f"({r0['params']:,} parameters) float32 {r0['mesh']} B={B} "
              f"S={SPMD_S} n_accum={SPMD_ACCUM}, {r0['heads']} of "
              f"{cfg.num_heads} heads and {r0['kv_heads']} of "
              f"{cfg.num_kv_heads} kv heads a rank: loss {r0['loss']:.6f} "
              f"(one process {r0['one_process_loss']:.6f}, rel "
              f"{r0['loss_rel_err']:.3e}), worst leaf rel err "
              f"{r0['worst_rel_err']:.3e} at {r0['worst_leaf']} (tol "
              f"{TRAIN_GATE_TOL:g}), flash launches {flash} (gate {want}), "
              f"rank walls "
              f"{[round(rr['13e']['runs'][i]['wall_s'], 3) for rr in ranks]}"
              f" s, gather to rank 0 {r0['gather_s']:.1f} s, peak memory "
              f"per rank {peaks} MiB, the one-process step's "
              f"{r0['one_process_peak_mib']:.1f} MiB in "
              f"{r0['one_process_s']:.1f} s")
        check(r0["worst_rel_err"] <= TRAIN_GATE_TOL
              and r0["loss_rel_err"] <= TRAIN_GATE_TOL
              and np.isfinite(r0["loss"]),
              f"sharded {arch} step on {r0['mesh']} == one-process step")
        check(flash == want, f"sharded {arch} step on {r0['mesh']}: flash "
                             f"launches == {want}")
        held.append(dict(r0["flash_vs_plain"], arch=arch, mesh=r0["mesh"]))
        print(f"  rank 0's flash calls held bit for bit, one of each kind "
              f"(q, kv, causal): {r0['flash_vs_plain']['kinds']}")
        launches += flash
        runs.append({k: r0[k] for k in (
            "arch", "layers", "mesh", "B", "params", "heads", "kv_heads",
            "loss", "one_process_loss", "loss_rel_err", "worst_rel_err",
            "worst_leaf", "worst_leaves", "init_s", "gather_s",
            "one_process_s", "one_process_peak_mib")}
            | {"walls_s": [rr["13e"]["runs"][i]["wall_s"] for rr in ranks],
               "peak_mib": peaks, "flash": flash})
        if "ckpt" in r0:
            ck = [rr["13e"]["runs"][i]["ckpt"] for rr in ranks]
            print(f"[{card}] {arch} sharded checkpoint on {r0['mesh']}: "
                  f"{ck[0]['bytes'] / 2 ** 20:.1f} MiB written by rank 0, "
                  f"save {ck[0]['save_s']:.2f} s (the gather and the host "
                  f"copy), write waited {ck[0]['write_wait_s']:.2f} s after "
                  f"the next step, restore {ck[0]['restore_s']:.2f} s; the "
                  f"resumed step's loss {ck[0]['resumed_loss']:.6f} "
                  f"(uninterrupted {ck[0]['loss']:.6f}); every rank's state "
                  f"equal bit for bit: {[c['ok'] for c in ck]}")
            check(all(c["ok"] for c in ck), f"{arch}: the step after a "
                  f"sharded checkpoint's restore == the uninterrupted "
                  f"step, bit for bit, on every rank")
            runs[-1]["ckpt"] = ck[0]
    print(f"[{card}] phase 13e: {world_s:.1f} s in the world")
    return {"runs": runs, "held": held, "launches": launches,
            "world_s": world_s}


def spmd_path(torch, card: str) -> dict:
    """Phase 13b in this process, then 13a and 13c-13f in one spawned
    world, then each one's checks."""
    out = {"rescale": rescale_check(torch, card)}
    gc.collect()
    torch.cuda.empty_cache()
    ranks, out["world_s"], pipe_out = spmd_world(torch)
    print(f"[{card}] phases 13a, 13c-13f: world spawned and run in "
          f"{out['world_s']:.1f} s (13a {ranks[0]['13a_s']:.1f} s)")
    out["pipeline"] = pipeline_check(
        torch, card, [r["13a"] for r in ranks[:PIPE_P]], pipe_out)
    del pipe_out
    gc.collect()
    torch.cuda.empty_cache()
    out["train"] = spmd_train_check(torch, card,
                                    [r["13c"] for r in ranks])
    out["families"] = spmd_families_check(torch, card,
                                          [r["13d"] for r in ranks])
    out["multimodal"] = spmd_multimodal_check(card, ranks)
    out["seq"] = spmd_seq_check(card, ranks)
    return out


def _kernel_entry(name, source, replaces, launches, err, rep, shapes):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"], "shapes": shapes}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import resolve_device
    resolve_device(None)
    t_start = time.perf_counter()
    took = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        took[name] = round(time.perf_counter() - t0, 1)
        return out

    card = timed("device", device_phase, torch)
    oracles = CpuOracles()
    timed("build", lambda: sass_phase(build_phase()))
    k = timed("stencil vs plain", kernel_phase, torch)
    mg = timed("fused solve vs plain", mg_kernel_phase, torch)
    mp = timed("main path", main_path_phase, torch)
    osp = timed("over-scaling path", overscaling_path, torch)
    sec5 = timed("§V path", sec5_path, torch)
    mm = timed("int8 vs plain", int8_kernel_phase, torch, osp["fig8_probs"])
    att = timed("attention vs plain", attention_kernel_phase, torch)
    scan = timed("scan vs plain", scan_kernel_phase, torch)
    serve = timed("serve path", serve_path, torch)
    gc.collect()
    torch.cuda.empty_cache()
    control = timed("control loop", control_path, torch, card, oracles)
    gc.collect()
    torch.cuda.empty_cache()
    fleet = timed("fleet tier", fleet_path, torch, card, oracles)
    gc.collect()
    torch.cuda.empty_cache()
    mix = timed("mixtral serve path", mixtral_path, torch)
    ds = timed("deepseek serve path", deepseek_path, torch)
    mmp = {name: timed(f"{name} path", mm_path, torch, name)
           for name in MM_ARCHS}
    study = timed("§V study", routed_study, torch)
    rec = {arch: timed(f"serve {arch}", recurrent_serve, torch, arch,
                       arch == "mamba2-780m") for arch in REC_SERVE}
    gc.collect()
    torch.cuda.empty_cache()
    train = timed("train path", train_path, torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    exp = timed("expandable serve path", expandable_path, torch, serve)
    spmd = timed("spmd on one card", spmd_path, torch, card)
    fam, mms, seq = spmd["families"], spmd["multimodal"], spmd["seq"]
    timed("profile", profile_phase, torch,
          mp["runs"]["table2_mkDelayWorker32B"]["fused_launches"],
          osp["params"], osp["fig8_probs"])
    print(f"serve path: {json.dumps(serve)}")
    print(f"control loop: {json.dumps(control)}")
    print(f"fleet tier: {json.dumps(fleet)}")
    print(f"mixtral serve path: {json.dumps(mix)}")
    print(f"deepseek serve path: {json.dumps(ds)}")
    print(f"multimodal paths: {json.dumps(mmp)}")
    print(f"§V study: {json.dumps(study)}")
    print(f"recurrent serve path: {json.dumps(rec)}")
    print(f"train path: {json.dumps(train)}")
    print(f"expandable serve path: {json.dumps(exp)}")
    print(f"spmd on one card: {json.dumps(spmd)}")
    print(f"phase times (s): {json.dumps(took)}")
    print(f"chip_smoke: all phases in {time.perf_counter() - t_start:.1f} s")
    src = "src/repro_torch/kernels/csrc/"
    rep_stencil = dict(k["rows"][0], library_ms=None)  # 92x92, B = 1
    # Table II's solves: warm starts of the fixed point at 92x92, B = 1
    rep_mg = next(r for r in mg["rows"]
                  if (r["m"], r["B"], r["warm"]) == (92, 1, True))
    # the representative rows: LeNet's conv2 product (65536x72x16, which
    # torch._int_mm accepts) and llama's up product at 4096 tokens
    rep_os = mm["rows"]["overscale_matmul"][1]
    rep_abft = next(r for r in mm["rows"]["abft_matmul"]
                    if (r["M"], r["K"], r["N"]) == (4096, D_MODEL, D_FF))
    # the serve path's working type: the bf16 decode rows, and the bf16
    # prefill's causal 2048-token attention
    rep_paged = next(r for r in att["rows"]["paged_attention"]
                     if (r["case"], r["dtype"]) == ("decode", "bfloat16"))
    rep_flash = next(r for r in att["rows"]["flash_attention"]
                     if (r["dtype"], r["S"], r["causal"])
                     == ("bfloat16", FLASH_S[-1], True))
    # the recurrent serve path's working type: mamba2's 512-token prefill
    rep_scan = next(r for r in scan["rows"]
                    if (r["model"], r["dtype"], r["B"], r["S"], r["G"])
                    == ("mamba2", "bfloat16", 1, 512, 1))
    print(json.dumps({"kernels": [
        # the smoother of the per-step form: launched on the main path by
        # the large-grid solve
        _kernel_entry("thermal_stencil", src + "thermal_stencil.cu",
                      "src/repro/kernels/thermal_stencil.py:82",
                      mp["counts"]["thermal_stencil"], k["max_abs_err"],
                      rep_stencil, k["rows"]),
        # the whole multigrid solve in one launch: the stencil kernel as
        # smoother of repro/core/thermal.py:168-181 inside :201-266
        _kernel_entry("thermal_mg_solve", src + "thermal_stencil.cu",
                      "src/repro/kernels/thermal_stencil.py:82",
                      mp["counts"]["thermal_mg_solve"], mg["max_abs_err"],
                      rep_mg, mg["rows"]),
        _kernel_entry("overscale_matmul", src + "int8_error_matmul.cu",
                      "src/repro/kernels/overscale_matmul.py:78",
                      osp["counts"]["overscale_matmul"],
                      mm["max_abs_err"]["overscale_matmul"], rep_os,
                      mm["rows"]["overscale_matmul"]),
        dict(_kernel_entry("abft_matmul", src + "int8_error_matmul.cu",
                           "src/repro/kernels/abft_matmul.py:98",
                           sec5["counts"]["abft_matmul"] + study["launches"],
                           mm["max_abs_err"]["abft_matmul"], rep_abft,
                           mm["rows"]["abft_matmul"]),
             launches_by_path={"sec5": sec5["counts"]["abft_matmul"],
                               "routed_study": study["launches"]},
             routed_per_forward=study["per_forward"]),
        dict(_kernel_entry("paged_attention", src + "paged_attention.cu",
                           "src/repro/kernels/paged_attention.py:118",
                           serve["gate_counts"]["paged_attention"]
                           + fleet["paged_launches"]
                           + mix["gate_counts"]["paged_attention"]
                           + exp["gate_counts"]["paged_attention"],
                           att["max_abs_err"]["paged_attention"], rep_paged,
                           att["rows"]["paged_attention"]),
             launches_by_path={
                 "serve_gate": serve["gate_counts"]["paged_attention"],
                 "fleet_drill": fleet["paged_launches"],
                 "mixtral_gate": mix["gate_counts"]["paged_attention"],
                 "expandable_gate": exp["gate_counts"]["paged_attention"]},
             # the mixtral path's shapes: 4096-entry rings, window 4096
             max_abs_err_ring=att["max_abs_err"]["paged_ring"],
             mixtral_rows=[r for r in att["rows"]["paged_attention"]
                           if r["case"].startswith("ring")]),
        dict(_kernel_entry("flash_attention", src + "flash_attention.cu",
                           "src/repro/kernels/flash_attention.py:76",
                           serve["prefill_counts"]["flash_attention"]
                           + sum(p["launches"]["prefill"]
                                 + p["launches"]["decode"]
                                 for p in mmp.values())
                           + train["run"]["counts"]["flash_attention"]
                           + spmd["pipeline"]["launches"]
                           + spmd["train"]["flash_gate"]
                           + sum(spmd["train"]["timed_flash"])
                           + fam["launches"]["flash"] + mms["launches"]
                           + seq["launches"]["flash"]
                           + sum(seq["bf16"]["flash"]),
                           att["max_abs_err"]["flash_attention"], rep_flash,
                           att["rows"]["flash_attention"]),
             launches_by_path={
                 "serve_prefill_step":
                     serve["prefill_counts"]["flash_attention"],
                 **{f"{name}_{kind}": p["launches"][kind]
                    for name, p in mmp.items()
                    for kind in ("prefill", "decode")},
                 "train_full_width": train["run"]["counts"]
                 ["flash_attention"],
                 "pipeline": spmd["pipeline"]["launches"],
                 "sharded_train_gate": spmd["train"]["flash_gate"],
                 "sharded_train_bf16": sum(spmd["train"]["timed_flash"]),
                 "sharded_families_gate": fam["launches"]["flash"],
                 "sharded_multimodal_gate": mms["launches"],
                 "sharded_seq_gates": seq["launches"]["flash"],
                 "sharded_seq_bf16": sum(seq["bf16"]["flash"])},
             sharded_train_vs_plain=spmd["train"]["flash_vs_plain"],
             sharded_seq_vs_plain=seq["held"]["flash"],
             sharded_families_vs_plain=fam["held"]["flash"],
             sharded_multimodal_vs_plain=mms["held"],
             per_train_step=train["run"]["per_step_flash"],
             grad_rel_err=train["flash_grads"]["worst"],
             per_prefill={n: p["flash_per_prefill"] for n, p in mmp.items()},
             per_decode_step={n: p["flash_per_decode_step"]
                              for n, p in mmp.items()}),
        dict(_kernel_entry("mamba_scan", src + "mamba_scan.cu",
                           "src/repro/kernels/mamba_scan.py:70",
                           rec["mamba2-780m"]["gate_counts"]["mamba_scan"]
                           + fam["launches"]["scan"]
                           + seq["launches"]["scan"],
                           scan["max_abs_err"], rep_scan, scan["rows"]),
             launches_by_path={
                 "mamba2_serve_gate":
                     rec["mamba2-780m"]["gate_counts"]["mamba_scan"],
                 "sharded_families_gate": fam["launches"]["scan"],
                 "sharded_seq_gates": seq["launches"]["scan"]},
             sharded_families_vs_plain=fam["held"]["scan"],
             sharded_seq_vs_plain=seq["held"]["scan"]),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
