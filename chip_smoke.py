#!/usr/bin/env python3
"""Chip smoke of the PyTorch + CUDA port: builds the kernels, drives the
paper's main path, the LM serving paths, the streaming runtime, multi-tenant
scheduling, the paper's reproduction, MoE serving, xLSTM, the Whisper
encoder-decoder, qwen2-vl's backbone, the LM-serving planner, LM
training (xLSTM's too) and the mesh route on one NVIDIA GPU,
holds every kernel against its plain PyTorch version, and prints the
kernels' numbers.

Run from the root of a checkout, with no arguments: ``python3 chip_smoke.py``.
Phases (each raises on failure; nothing is caught):

1. build the seven kernel sources (``sched_scoring.cu``, ``cut_traffic.cu``,
   ``flash_attention.cu``, ``decode_attention.cu``, ``rglru_scan.cu``,
   ``policy_scan.cu``, ``slstm_scan.cu``) for sm_90a, one nvcc each, all at
   once; card name and power limit;
2. the scorer (B1, B2) against its plain version on the card, over the
   scoring regimes and edge shapes (ids outside [0, m) among them), and the
   cut-traffic kernel against its plain version over shared, per-row and
   skew maps, m = 1, 3 and 180 in racks, on the linear, diamond, star and
   wide-fanout topologies, at shapes past one round of its product, past
   its widest tiles and past shared memory (98 contracted components at
   m = 180, 18 at m = 1000), and with ids outside [0, m) (identical
   feasibility mask and argmax, max abs error 0); the scorer at its
   one-block layout's widest m, ``max_machines`` (B1 with shared and
   per-row maps, B2 with memory and network), and one machine past it, in
   its table layout (the machines a row touches) and, one task past the
   table's most, its machine-tiled layout, each equal to its plain version;
3. main path at full width: ``schedule`` on ``paper_cluster((20, 70, 90))``
   (the reference golden), ``refine`` on the card (equal to the CPU path
   and to the reference's result), ``simulate`` / ``simulate_batch``;
4. resource path: the same cluster with memory and 6 racks, ``refine``
   (3 rounds) on the card equal to the CPU path and the reference's result;
   114 B2 launches, one cut-traffic launch for each, no eager network term
   on the card;
5. ``optimal_schedule`` on ``paper_cluster((1, 1, 1))``: the reference golden;
6. timings with CUDA events (cold L2, median): B1 and B2 at B=16384,
   T=478, m=180, the cut-traffic kernel at the resource path's sweep shape
   (B=5555, m=180, the refined placement's 537 tasks); each on the card
   alone (``ms``) and with the wrapper's host time (``wrapper_ms``); for
   cut_traffic also the ceiling without FMA (half the FP64 rate), registers
   and spills, resident blocks a SM and the waves;
7. the attention kernels (B3 flash, B4 decode) and the RG-LRU scan (B5)
   against their plain versions on the card: GQA (G 2 and 8), MQA, window,
   bidirectional, ragged S (192, 300, 600), per-row lengths down to 1,
   recurrentgemma-2b's shapes (B3 at 8 x 2304, window 2048, 10 heads on 1
   KV head of 256; B4 over 2048 slots, also with lengths on the split
   pass's slice boundaries, rerun bit-identical); B5 at ragged S (1, 37,
   100, 2304) and W (37, 2560) from a non-zero h0; float32 and bfloat16;
8. LM serving at full width: ``qwen1.5-0.5b`` (24 layers, bf16, random
   weights from a seed) serves 8 requests of 512 prompt tokens and 64
   generated tokens through ``init_params -> init_caches -> prefill ->
   decode_step``; 24 B3 launches per prefill, 24 B4 launches per decode
   step; then 2 requests x 128 prompt tokens x 8 steps on the card against
   the same weights in float32 on the CPU, fed the card's tokens;
   ``recurrentgemma-2b`` at full width and depth (26 layers, bf16) serves 8
   requests of 2304 prompt tokens and 64 generated tokens over 2048-slot
   local-attention rings that the prefill rolls and decode wraps; 18 B5 and
   8 B3 launches per prefill, 8 B4 launches per decode step; then its first
   6 layers (two periods of the block pattern), 2 requests x 2100 prompt
   tokens x 16 steps, on the card against float32 on the CPU;
9. B3 and B4 timed at both models' serving shapes beside their plain
   versions and ``scaled_dot_product_attention`` (B4 with its slice count
   and the bytes of its partials); B5 at its serving shape beside its plain
   version;
10. the streaming runtime at the paper's large scale (phase 3's cluster, the
   reference runtime benchmark's six drift traces against phase 3's R* at
   240 windows, ``max_queue`` 120): ``OnlineController(period=10,
   device="cuda")`` over the ramp and the failure trace, each from
   ``provision_schedule`` at the trace's initial rate, every replan's
   ``refine`` on B1 and no plain scorer on the card; each held against the
   same run with ``device="cpu"`` (equal fingerprints and replan ledgers),
   as is ``OracleRescheduler`` over the failure trace (Algorithm 1 on the
   host); a keyed skew shift (``keyed_rolling_count_topology`` on the same
   cluster, 240 windows) must carry out a skew_shift replan on B1, and the
   CPU holds its first 91 windows, through that replan; the oracle over the
   same keyed run must polish on B1 and move at window 0, and the CPU holds
   its first 2 windows; then
   ``evaluate_policies_batch(device="cuda")`` over the six traces x 256
   placements (the refined one and 255 with one task moved): one
   ``policy_scan`` launch, within 1e-12 of its plain version on the card,
   equal to it on the CPU for 8 placements, bit-identical on rerun, within
   1e-9 of the executor on 8 sampled pairs;
11. ``policy_scan`` timed at that sweep beside its plain version, with its
   ceiling without FMA, registers and spills, resident blocks a SM and
   the waves; the global-state instance, picked by hand, on the same sweep:
   equal to the one-block kernel bit for bit, and timed beside it;
12. multi-tenant scheduling and observability (``repro_torch.multitenant``,
   ``repro_torch.obs``): ``schedule_tenants(device="cuda")`` on
   ``benchmarks/bench_multitenant.py``'s 100-tenant fleet on
   ``paper_cluster((20, 30, 40))`` at capacity x1 and x4 (rounds,
   candidates, log, rates and every placement equal to the reference's; on
   B1 alone, no plain scorer on the card); every single-task relocation of
   the x1 fleet at 0.9 of its rates (112 763 rows) in one
   ``TenantBatchScorer.score`` call: one B1 launch with per-row maps and
   capacity, equal to its plain version on the card and to the
   reference's rates; the 20-tenant relocation sweep on phase 4's resource
   cluster (15 215 rows): one B2 and 20 cut_traffic launches, equal to
   their plain versions on the card and to the reference's rates; three
   tenants online over 240 windows (ramp, then a slowdown of the largest
   machine) with a ``TraceRecorder``: satisfaction, fingerprints, the
   arbiter's log, the replan decisions and the JSONL export (under the
   backend-name map) equal to the reference's, the export valid;
13. timings of phase 12: B1 at the relocation sweep's shape beside its
   plain version, the ``score`` call host to host with the capacity
   gather (and a host copy of it, which the port does not make), B2 and
   the 20 cut_traffic launches at the resource sweep's shape, and both
   fleets' walls with their B1 launches and the profiler's device-busy
   share;
14. the paper's reproduction and the other benchmarks
   (``repro_torch.paper_repro``'s sections, then ``repro_torch.paper``'s
   netaware, refine_speed, runtime, multitenant and dispatch benchmarks) on
   the card: every row's derived columns equal the reference's
   (``PAPER_REF``) and the same benchmark's on the CPU in this process, but
   for the fields a run measures (each benchmark's ``MEASURED``); the CPU
   twins leave out the 100-tenant scale rows (phase 12 holds those
   fleets), the runtime's parity row (itself the card against the CPU)
   and overhead rows (timed on the card) and the dispatch rows (timed on
   both); no plain version runs on the card; each section's B1, B2,
   cut_traffic and policy_scan launches and its walls;
15. the MoE family (``models.moe``, ``models.mla``):
   (a) ``granite-moe-1b-a400m`` at full width and depth (24 layers, 32
   experts top-8, bf16, random weights from a seed) serves 8 requests of
   512 prompt tokens and 64 generated tokens; 24 B3 launches per prefill
   and 24 B4 launches per decode step, no plain attention version on the
   card; its prefill's capacity drops, and 8 decode steps under the
   profiler with the device time of each MoE stage (route, dispatch,
   experts, combine); (b) its first 2 layers in float32 (TF32 off) on
   the card against the CPU, 2 x 128 prompt tokens + 8 steps, the CPU fed
   the card's tokens: routed expert ids equal wherever the top-k margin
   exceeds ``ROUTE_MARGIN``, logits within ``MOE_REL`` of their max-abs,
   argmax equal; then the full depth in bf16 against float32 on the CPU
   as in phase 8, the CPU teacher-forced on the card's tokens and expert
   choices (it prints how often its own choice differed); (c)
   ``deepseek-v3-671b`` at full width, its depth cut to 4 layers (3
   dense, 1 MoE of 1 shared + 256 routed experts; ~15.8 G parameters),
   bf16, serves 4 requests of 256 prompt tokens and 16 generated tokens
   (MLA runs no B3/B4: its absorbed form is torch ops); the MLA cache's
   bytes and the peak memory; then the same weights in float32 (capacity
   factor E / k, so that no choice is dropped at any length): 8 decode
   steps from a 2 x 64 prefill, each within ``MLA_REL`` of a
   teacher-forced prefill over the tokens so far; (d) B3 and B4 timed at
   granite's serving shapes (B4 over 576 slots) beside their plain
   versions and ``scaled_dot_product_attention``;
16. xLSTM and the Whisper encoder-decoder (``models.xlstm``, the encoder
   and cross-attention of ``models.model``): (a) ``xlstm-125m`` at full
   width and depth (12 blocks alternating mLSTM and sLSTM, d_model 768, 4
   heads, the mLSTM cell at head dim 384, bf16, random weights from a
   seed) serves 8 requests of 512 prompt tokens (two 256-token chunks, so
   the state carries between them) and 64 generated tokens, with no B3 or
   B4 launch and no plain attention version on the card; exactly one
   ``slstm_scan`` launch an sLSTM block a prefill and a decode step (6 x
   64), the plain sLSTM loop never on the card; one prefill and 8 decode
   steps under the profiler, with the device time of the mLSTM chunk loop
   and its one-token update (eager torch ops) and of the sLSTM time loop
   (the kernel) and the busy share; (a') the ``slstm_scan`` kernel in both
   layouts (one thread-block cluster a group of rows, which the plan takes
   for the prefill; the cooperative launch, which it takes for a decode
   step), with each plan (C, R, resident clusters, shared bytes, registers
   and spills), against its plain version (within ``SLSTM_TOL``) at (8, 512,
   768) and at S = 1, each from a fresh state and from the state a prompt
   left, at ``SLSTM_EDGES`` and with a NaN in one gate (reruns equal; the
   cluster layout refuses d 4100 by name), timed at the prefill's and a
   decode step's shape beside its bound, its serial floor (the same launch
   without the arithmetic: the grid-wide barriers, or the cluster's h
   exchange) and its plain version, and at ``SLSTM_STEPS``; (b) its
   full depth in float32 (TF32 off) on the card against the CPU, 2 x 512
   prompt tokens + 8 steps, the CPU fed the card's tokens: logits within
   ``F32_REL`` of their max-abs, argmax equal; then bf16 against float32
   on the CPU as in phase 8; (c) ``whisper-tiny`` at full width and depth
   (4 encoder + 4 decoder layers, d_model 384, 6 heads of 64, vocab 51 865
   padded to 52 224, bf16) serves 8 requests of 1 500 stub frames, a
   4-token prompt and 64 generated tokens: 12 B3 launches a prefill (4
   bidirectional over the frames in the encoder, 4 causal in the decoder,
   4 over the frames in cross-attention), 8 B4 a step (4 over the decoder's
   cache, 4 over the 1 500 frames), no plain attention version on the
   card; a profiled prefill and 8 steps with the encoder's and the
   cross-attention's device time; its full depth in float32 against the
   CPU at 2 x 1 500 frames, 4 prompt tokens and 8 steps, and bf16 against
   float32; (d) B3 at the encoder's shape (8 x 1 500, 6 heads of 64,
   bidirectional) and the cross-attention prefill's (8 x 4 queries over
   1 500 frames), and B4 over 1 500 cross slots, each beside its plain
   version and ``scaled_dot_product_attention``;
17. qwen2-vl-72b's backbone (M-RoPE, embedding inputs; the vision front
   end a stub in both packages): (a) at full width (d_model 8192, 64 query
   heads on 8 KV heads of 128, d_ff 29 568, bf16, random weights from a
   seed), its depth cut from 80 to 32 layers (30.58 G parameters, what one
   80 GB card holds with a margin), serves 8 requests of 512 prompt
   positions and 64 generated tokens through ``serve``: each prompt one
   image in Qwen2-VL's layout (16 text positions, a 20 x 20 grid of merged
   patches, 96 text positions; ``image_positions``), its text rows the
   embedded tokens and its image rows stub embeddings, decode steps from
   the generated tokens at their M-RoPE positions; 32 B3 launches a
   prefill and 32 B4 a step, no plain attention version on the card; the
   decode's and the prefill's floors (weights over the memory rate, FLOPs
   over the bf16 rate) and the peak memory; (b) one prefill and 8 decode
   steps under the profiler: busy share, device activities and where busy
   goes, the decode's device busy beside its weights' floor; (c) its first
   2 layers in float32 (TF32 off) on the card against the CPU, 2 x (64 + 8)
   with the image scaled to a 4 x 4 grid, the CPU fed the card's tokens:
   logits within ``F32_REL`` of their max-abs, argmax equal; (d) the same
   2 layers in bf16 against float32 on the CPU as in phase 8; (e) B3 at
   the prefill's shape (8 x 512, 64 heads on 8 of 128, causal) and B4 at
   the last step's (575 of 576 slots), each beside its plain version and
   ``scaled_dot_product_attention``;
18. the LM-serving planner (``repro_torch.sched``): (a)
   ``paper.planner.main`` on the card (H100 x 8 groups of 8, A100 x 4 of
   8, L4 x 12 of 4; no plan comes under ``refine``'s 64-task gate), then
   on the CPU in the same process: derived columns equal to each other and
   to the reference's (``PLANNER_REF``); (b) ``ElasticController`` over the
   serve example's fleet (H100 x 6 groups of 8, L4 x 8 of 4) for all ten
   archs, each with ``fail(0, 2)`` and ``restore(0, 2)``, on the card and
   on the CPU: replicas, assignments, rates and iterations equal; B1
   launches exactly for the archs of ``PLANNER_REFINED``, and no plain
   scorer runs on the card;
19. training (``repro_torch.runtime.trainer``, ``launch.steps``,
   ``optim.adamw``, ``checkpoint.store``, ``data.pipeline``): (a)
   qwen1.5-0.5b at full width and depth in its own types (bf16
   parameters, float32 AdamW moments, remat), 8 x 512 tokens a step from
   a ``SyntheticLM`` stream, 20 steps of the cosine schedule through the
   ``Trainer`` with async checkpoints at steps 10 and 20 in a temporary
   directory: the loss falls, no B3, B4 or B5 launch (training attends
   through ``sdpa``), the step wall (median of steps 3-10; and of steps
   11-20, beside the async write of the step-10 checkpoint), tokens/s, the
   achieved 6 N D FLOP/s and the peak memory; (b) a trainer of 10 steps
   into a second directory, the parameters in its checkpoint equal to its
   own bit for bit, then a new trainer there with 20 steps resumes at step 10: its
   losses within ``RESTART_REL`` of the uninterrupted run's; (c) one
   profiled step (device busy); (d) one float32 step at 2 layers on the
   card and on the CPU from the same parameters and batch (loss, grad
   norm, update); (e) B3 and B4 refuse CUDA inputs that require grad, B5
   under autograd launches its kernel and ``rglru_scan_bwd`` once each and
   gives the plain version's gradient; (f) the trained weights serve 8
   prompts of 128 tokens and 8 decode steps: exactly 24 B3 and 24 x 8 B4
   launches; (c') ``step_analysis.analyze_step`` on one step of the
   trained state: the counted product FLOPs beside 6 N D, touched and
   collective bytes, the three ``roofline_terms`` on H100 constants beside
   the measured step wall;
20. RG-LRU training (ROADMAP A13b): (a) ``recurrentgemma-2b`` at full
   width (d_model 2560, lru width 2560, d_ff 7 680, vocab 256 000), its
   depth cut to 9 of 26 layers (three Griffin periods, 1.43 G parameters:
   full depth needs ~116 GB at phase 19's recipe), bf16 parameters,
   float32 moments, remat, 8 x 512 ``SyntheticLM`` tokens a step, 10
   steps through the ``Trainer``: the loss falls, exactly 2 x 6 B5 and
   6 ``rglru_scan_bwd`` launches a step (the forward and remat's
   recompute; the backward), no B3 or B4; the step wall (median of steps
   3-10), tokens/s, peak memory; (b) one float32 step of the first 3
   layers (both block kinds) on the card and on the CPU from the same
   parameters and batch, within phase 19's tolerances; (c)
   ``rglru_scan_bwd`` at (8, 512, 2560) float32 against its plain version
   (within ``SCAN_TOL``), timed beside it with its bound;
21. the mesh route (``models.layers.MeshCtx``, ``launch.steps``' ``mesh=``,
   the MoE expert-parallel routes, ``launch.dryrun``): (a) dry-run cells
   over the production meshes (a fake group of 256 or 512 ranks, meta
   DTensors: accounting figures, no card work): every shape of
   qwen1.5-0.5b, granite-moe-1b-a400m and recurrentgemma-2b, and
   qwen2-vl-72b's train_4k at all 80 layers on the 16x16 and 2x16x16
   meshes; each cell's per-device arguments and peak, whether they fit 80
   GB, the three roofline terms on H100 constants and the dominant one,
   6 N D over the counted FLOPs, and the wall; (b) a one-rank NCCL group and
   a 1 x 1 ("data", "model") mesh on the card: one train step of
   qwen1.5-0.5b at full width and depth, of recurrentgemma-2b's first 3
   layers (exactly 4 B5 and 2 ``rglru_scan_bwd`` launches, inside
   ``local_map``), of granite-moe-1b-a400m's first 2 layers (the
   ``a2a`` route) and of xlstm-125m's first 2 blocks (exactly 2
   ``slstm_scan``, 1 ``slstm_scan_bwd`` and 1 ``slstm_scan_bwd_rest``
   launches, inside ``local_map``), each through ``make_train_step(mesh=...)`` on DTensors
   and equal bit for bit to the mesh-less step from the same state and
   batch; the group is destroyed after the phase;
22. wide clusters (``WIDE_COUNTS``: the paper's three types at 91 x 20/70/90,
   16 380 machines, past every scheduler kernel's one-block layout):
   ``max_stable_rate_batch`` at 16 384 x 478 (one B1 launch, a table of
   the machines a row touches), a ``refine(max_rounds=1, allow_add=False)``
   of a 4-task placement with memory (exactly 4 B2 launches, the table; one
   move) and ``evaluate_policies_batch`` of a 6 240-task topology, 3 traces
   x 16 placements x 24 windows (one ``policy_scan`` launch, the global-state
   instance over the occupied machines), each equal to ``device="cpu"``;
   B1/B2 at 16 380 machines and where the machine tiles' last one holds
   one machine, each at 478 tasks (the table) and one task past the
   table's most (the machine tiles), at ``TABLE_EDGES`` (one machine a row, distinct
   machines, ids outside [0, m), an untouched machine with cap_w < 0 or
   mem_cap_w < 0, per-row capacity with a zero ``net_var`` row, T at the
   table's most tasks and one past, B1 and B2 with memory and network: the
   machine tiles), cut_traffic at
   14 501 and 16 380 (the list layout), policy_scan at 6 240 tasks, 16 380
   machines, 65 536 traces, past 65 535 groups of traces and at
   ``SCAN_EDGES`` (a placement on one machine, one on every machine, T at
   each shared-memory split and one past), each equal to its plain version
   (the new layouts' reruns bit-identical too); then B1 (16 384 x 478), B2
   (4 096 x 478, memory and network), cut_traffic (128 rows of the 6 240-task
   placement, its list layout held bit for bit and rerun; its bound counts
   the products over each row's non-zero columns of X, ``cut_work``; its
   plan, list lengths and scratch bytes at B = 128 and 65 520 printed; an
   inf and a NaN in columns no task occupies at B = 2, NaN where its plain
   version has NaN; then the same placement on ``MID_COUNTS``' 8 100
   machines through ``network_unit_load``, one launch, timed beside the
   previous revision's kernel where a copy lies at ``PARENT_CUT_SOURCE``)
   and policy_scan (the sweep, then 6 x 256
   pairs) timed on the wide cluster beside their plain versions and bounds
   (B1/B2's over each row's touched machines, policy_scan's over the
   occupied machines, each beside the dense count over every machine;
   policy_scan's serial floor, ``SERIAL_ADD_CYCLES`` a dependent add, too);
23. xLSTM training (``slstm_scan`` under its ``torch.autograd.Function``,
   whose backward is the ``slstm_scan_bwd`` kernels: in the cluster layout
   a loop and a rest pass): (a) xlstm-125m at full
   width and depth (12 blocks, six mLSTM and six sLSTM, d_model 768), bf16
   parameters, float32 moments, remat, 8 x 512 ``SyntheticLM`` tokens a
   step, 10 steps of the cosine schedule through the ``Trainer``: the loss
   falls, exactly 12 ``slstm_scan``, 6 ``slstm_scan_bwd`` and 6
   ``slstm_scan_bwd_rest`` launches a step (the forward and remat's
   recompute; the backward's loop and rest), no B3, B4 or B5, the
   plain sLSTM loop and its plain backward never on the card; the step wall
   (median of steps 3-10), tokens/s, peak memory, and one profiled step's
   device busy; (b) one float32 step (TF32 off) of its first 4 blocks (two
   mLSTM, two sLSTM) on the card and on the CPU from the same parameters
   and batch, within phase 19's tolerances; (c) ``slstm_scan_bwd`` against
   its plain version on the card in both layouts (within
   ``SLSTM_BWD_TOL`` of each gradient's max-abs) at (8, 512, 768) from a
   fresh state and from a prompt's, at ``SLSTM_EDGES`` and with a NaN in
   one gate (NaN where the plain version has it; reruns equal bit for
   bit), timed in both layouts beside its bound, its serial floor (the
   dz_pre exchange alone, phased by row in the cluster layout) and its
   plain version; the cluster layout's loop and rest pass timed apart and
   each held to its own plain version, and the previous revision's kernel
   timed and compared bit for bit where a copy lies at
   ``PARENT_SLSTM_SOURCE``.

Every phase's wall and the whole run's are printed at the end. The reference's results for
phases 3-5, 12, 14 and 18 are constants below; ``tests/test_torch_multitenant_golden.py``
and ``tests/test_torch_multitenant_runtime_golden.py`` recompute phase 12's,
``tests/test_torch_paper_*.py`` phase 14's and phase 18's.
The last lines are the ``{"kernels": [...]}`` record (eleven kernels; B1, B2,
cut_traffic and policy_scan carry phase 22's shapes and times under
``wide_cluster``, cut_traffic's 8 100-machine shape under its
``mid_cluster``, and the four kernels its launches;
``rglru_scan_bwd`` counts its launches in phases 20 and 21, B5 in phases
8, 20 and 21; B1 counts its
launches in phases 3-4, 12, 14 and 18, B2 and cut_traffic in phases 3-4,
12 and 14, policy_scan in phases 10 and 14, B3 and B4 in phases 8
(qwen1.5-0.5b), 15 (granite-moe-1b-a400m), 16 (whisper-tiny), 17
(qwen2-vl-72b) and 19 (the trained qwen1.5-0.5b), with recurrentgemma-2b's, granite's, whisper-tiny's and
qwen2-vl-72b's own numbers in nested keys; whisper-tiny's holds its
launches and each timed shape, qwen2-vl-72b's its timed shape;
``slstm_scan`` counts xlstm-125m's launches in phases 16, 21 and 23, the
prefill in the plan's layout at top level, a decode step in its plan's
layout and both layouts' times and serial floors in its own keys;
``slstm_scan_bwd`` its launches in phases 21 and 23, the training shape in
the plan's layout at top level (the whole call, its loop and rest pass
apart), both layouts under ``layouts``; ``slstm_scan_bwd_rest`` the
cluster layout's rest kernel alone, its launches in phases 21 and 23), the
card's ``nvidia-smi`` name and power limit,
and ``{"ok": true, "device": ...}``.
Without a CUDA device, or away from the repository, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS_PER_S = 34e12  # vector FP64, outside the tensor cores
FP32_FLOPS_PER_S = 67e12  # vector FP32, outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # dense bf16 on the tensor cores

# The reference's results (``repro.core``, NumPy scoring) for phases 3-5.
MAIN_GOLDEN = dict(rate=297.0, n_instances=[2, 56, 210, 210], iterations=46,
                   md5="1dfed7471c737dcb63fc259cb03ffe02")
MAIN_REFINE_REF = ([], 1189.9999999999998)
RESOURCE_REFINE_REF = (["grow c0x4", "swap c0#0<->c2#0", "swap c0#1<->c1#0"], 1154.5354084899689)
# B2 sweeps of that refine, each with a network term (one cut_traffic
# launch apiece): its candidate rows are fixed by the goldens.
RESOURCE_REFINE_B2_LAUNCHES = 114
OPTIMAL_REF = dict(evaluated=26136, pruned=35, n_instances=[1, 2, 1, 3],
                   throughput=23.268698060941833)


# Phase 12's cells, built by the same functions below from either package.
# The large fleet's budgets (``benchmarks/bench_multitenant.py``).
FLEET_KW = dict(warm_refine_rounds=2, structure_attempts=1, refine_moves=1)
FLEET_TOPOLOGIES = ("linear_topology", "diamond_topology", "star_topology",
                    "rolling_count_topology")
# The reference's results for them (``repro.multitenant``, NumPy scoring);
# ``tests/test_torch_multitenant_golden.py`` recomputes every one.
MT_FLEET_REF = {
    1: dict(rounds=3201, candidates=100, log_md5='14200f34512f5482ff43916c98141876',
            rates_md5='1420d7bbfbd75b45d5375a7e00e92270',
            placement_md5='3f1d4537126daccac07f86440470b07a',
            total_rate=37.38002820315214),
    4: dict(rounds=3713, candidates=100, log_md5='945996fde0081327d6d879c6e8970c39',
            rates_md5='93995931ecc9932d6e54fdc1d4a2f43e',
            placement_md5='04cb8cefc0761693544c1739e66bee09',
            total_rate=324.31091995932854),
}
MT_RELOCATION_REF = dict(rows=112763, rates_md5='955a6eff26eab3674f466c0cb6c107d1',
                         thpt_md5='467039b932456bdfe3d8c6af3b9a4049',
                         mask_md5='338462503ee7ad6ab831b2c07e0ee10c', feasible=112763,
                         argmax=67297)
MT_RESOURCE_REF = dict(rows=15215, rates_md5='07bd4eeae77b93be0652df86fc090d4a',
                       thpt_md5='b69b5f94a3f0358df66f9aecea5faeea',
                       mask_md5='de41af58440d41fecde044add7ce3903', feasible=15215,
                       argmax=3581)
MT_RUNTIME_REF = dict(rates_md5='80b90f70413240da7cb8c16ee1414efc',
                      satisfaction=[5.2761983898809905, 4.978415944071098, 2.5248864379892724],
                      fingerprints=['d949c54f9926596187ffecc267f097c1',
                                    '4c0261e7f8a08e053aaaa323eee0cf6d',
                                    '3fa2146c04f90a7d460e75013ea15c8d'],
                      arbiter_md5='8ca1933922e467869d05e0ba24ec5460', requests=10,
                      decisions_md5='776950f51ceef1cfbecc97d0d8587dde',
                      jsonl_md5='6dccf88ac9b1a96a0ab82d1653f3dffb')
# Phase 14: the reference's rows (the scripts of ``benchmarks/`` on ``repro``'s
# NumPy paths), by benchmark and row name, without the fields that a run
# measures (each benchmark's ``MEASURED``: times, speedups, the evaluating
# device). ``runtime_eval_parity`` is what the reference's gate demands (its
# JAX evaluator cannot run on the installed JAX, ROADMAP C-ref-1), and the
# dispatch rows are the shapes of the reference's grid; the scale rows are
# the reference's 100-tenant fleets. ``tests/test_torch_paper_*.py``
# recompute them.
PAPER_REF = {
    "prediction": {
        "fig6_prediction_accuracy": "accuracy=98.5%;max_err=7.88pts;n=121;paper>=92%",
    },
    "throughput": {
        "fig8_throughput_linear":
            "default=13.9;proposed=21.1;refined=22.7;optimal=23.3;gain=52.3%(paper 7-44%);"
            "below_opt=9.1%;refined_below_opt=2.3%(paper<=4%)",
        "fig8_throughput_diamond":
            "default=14.0;proposed=16.0;refined=17.9;optimal=17.9;gain=14.6%(paper 7-44%);"
            "below_opt=10.6%;refined_below_opt=0.0%(paper<=4%)",
        "fig8_throughput_star":
            "default=15.8;proposed=21.5;refined=22.7;optimal=23.3;gain=36.2%(paper 7-44%);"
            "below_opt=7.6%;refined_below_opt=2.3%(paper<=4%)",
    },
    "instances": {
        "fig7_instances_rolling_count": "ours=(2, 2);optimal=(6, 5);loss=2.8%(paper<=2%)",
        "fig7_instances_unique_visitor": "ours=(2, 2);optimal=(5, 3);loss=3.7%(paper<=2%)",
    },
    "utilization": {
        "fig9_utilization_linear":
            "default:thpt=13.9,util=199;proposed:thpt=21.1,util=275;optimal:thpt=23.3,util=298",
        "fig9_utilization_diamond":
            "default:thpt=14.0,util=247;proposed:thpt=16.0,util=256;optimal:thpt=17.9,util=296",
        "fig9_utilization_star":
            "default:thpt=15.8,util=220;proposed:thpt=21.5,util=280;optimal:thpt=23.3,util=298",
    },
    "largescale": {
        "fig10_small_linear": "tasks=13;thpt_gain=33.4%;util_gain=31.9%;table5_ratio=1.05",
        "fig10_small_diamond": "tasks=10;thpt_gain=64.1%;util_gain=62.1%;table5_ratio=1.03",
        "fig10_small_star": "tasks=10;thpt_gain=58.2%;util_gain=56.6%;table5_ratio=1.03",
        "fig10_medium_linear": "tasks=75;thpt_gain=45.4%;util_gain=42.6%;table5_ratio=1.07",
        "fig10_medium_diamond": "tasks=72;thpt_gain=37.9%;util_gain=36.1%;table5_ratio=1.05",
        "fig10_medium_star": "tasks=106;thpt_gain=20.9%;util_gain=19.4%;table5_ratio=1.08",
        "fig10_large_linear": "tasks=478;thpt_gain=35.9%;util_gain=38.7%;table5_ratio=0.93",
        "fig10_large_diamond": "tasks=510;thpt_gain=17.0%;util_gain=36.8%;table5_ratio=0.46",
        "fig10_large_star": "tasks=276;thpt_gain=50.9%;util_gain=45.7%;table5_ratio=1.12",
    },
    "sched_speed": {
        "sec3_scheduler_walltime": "candidates=221247;paper_optimal=18h@27405cands",
        "sched_engine_large":
            "scenario=large_linear_20_70_90;tasks=478;iterations=46;rate=297.0;"
            "identical_schedule=True",
        "sim_batch_backends": "batch=2048;tasks=75",
    },
    "refine_speed": {
        "refine_engines_slow_suite": "scenario=slow_suite_1_1_1;identical=True",
        "refine_wide_lockstep":
            "scenario=wide14_2_2_2;tasks=30;components=16;moves=6;identical=True",
        "optimal_engines": "scenario=linear_mtt8;candidates=26136;identical=True",
    },
    "netaware": {
        "netaware_shuffle_heavy_2rack":
            "blind=6.3812;aware=6.6232;gain_pct=3.792;aware_ge_blind=True",
        "netaware_rolling_count_2rack":
            "blind=40.5697;aware=44.2973;gain_pct=9.188;aware_ge_blind=True",
        "netaware_wide_fanout_3rack_mem":
            "blind=25.7855;aware=29.1209;gain_pct=12.935;aware_ge_blind=True",
    },
    "runtime": {
        "runtime_linear_ramp":
            "online=21.691;static=11.233;oracle=21.38;migrations=7;slo=1.0;beats_static=True;"
            "within_10pct=True",
        "runtime_linear_burst":
            "online=18.949;static=14.316;oracle=19.069;migrations=2;slo=1.0;beats_static=True;"
            "within_10pct=True",
        "runtime_linear_sine":
            "online=16.067;static=15.5;oracle=16.067;migrations=5;slo=1.0;beats_static=True;"
            "within_10pct=True",
        "runtime_linear_slowdown":
            "online=17.795;static=9.445;oracle=17.663;migrations=6;slo=0.3;beats_static=True;"
            "within_10pct=True",
        "runtime_linear_failure":
            "online=12.879;static=0.241;oracle=12.407;migrations=2;slo=0.0;beats_static=True;"
            "within_10pct=True",
        "runtime_linear_ramp_slowdown":
            "online=20.14;static=7.106;oracle=20.508;migrations=12;slo=0.55;beats_static=True;"
            "within_10pct=True",
        "runtime_linear_elastic":
            "online=27.695;static=14.647;oracle=27.135;migrations=9;slo=1.0;beats_static=True;"
            "within_10pct=True",
        "runtime_rolling_count_ramp":
            "online=26.574;static=11.515;oracle=26.574;migrations=2;slo=1.0;beats_static=True;"
            "within_10pct=True",
        "runtime_rolling_count_burst":
            "online=22.883;static=15.333;oracle=22.883;migrations=2;slo=1.0;beats_static=True;"
            "within_10pct=True",
        "runtime_rolling_count_sine":
            "online=19.413;static=16.699;oracle=19.413;migrations=2;slo=1.0;beats_static=True;"
            "within_10pct=True",
        "runtime_rolling_count_slowdown":
            "online=22.986;static=12.057;oracle=18.621;migrations=4;slo=1.0;beats_static=True;"
            "within_10pct=True",
        "runtime_rolling_count_failure":
            "online=14.778;static=0.486;oracle=15.639;migrations=1;slo=0.333;beats_static=True;"
            "within_10pct=True",
        "runtime_rolling_count_ramp_slowdown":
            "online=25.289;static=8.77;oracle=24.508;migrations=4;slo=0.6;beats_static=True;"
            "within_10pct=True",
        "runtime_rolling_count_elastic":
            "online=33.402;static=16.958;oracle=33.176;migrations=7;slo=1.0;beats_static=True;"
            "within_10pct=True",
        "runtime_keyed_rolling_count_keyed_hot":
            "online=27.486;static=16.613;oracle=27.459;migrations=9;slo=1.0;beats_static=True;"
            "within_10pct=True;blind=27.486",
        "runtime_keyed_rolling_count_keyed_shift":
            "online=21.967;static=14.873;oracle=21.967;migrations=4;slo=1.0;beats_static=True;"
            "within_10pct=True;blind=21.967",
        "runtime_keyed_rolling_count_keyed_elastic":
            "online=29.21;static=16.218;oracle=27.641;migrations=9;slo=0.633;beats_static=True;"
            "within_10pct=True;blind=28.609",
        "runtime_eval_parity": "within_1e9=True",
        "runtime_obs_overhead_ramp": "records=233",
        "runtime_obs_overhead_keyed_hot": "records=499",
    },
    "multitenant": {
        "multitenant_scale_roomy_90x400":
            "tenants=100;rounds=3713;feasible=True;no_regression=True;jain=0.9321",
        "multitenant_scale_paper_90x100":
            "tenants=100;rounds=3201;feasible=True;no_regression=True;jain=0.8779",
        "multitenant_batching": "rows=2585;parity=True",
        "multitenant_runtime": "tenants=3;satisfaction=[0.257, 0.276, 0.138];all_served=True",
    },
    "dispatch": {
        "dispatch_crossover_small_shared": "tasks=14;machines=3",
        "dispatch_crossover_small_per_row": "tasks=14;machines=3",
        "dispatch_crossover_small_skew": "tasks=5;machines=3",
        "dispatch_crossover_medium_shared": "tasks=15;machines=6",
        "dispatch_crossover_medium_per_row": "tasks=15;machines=6",
        "dispatch_crossover_medium_skew": "tasks=13;machines=6",
        "dispatch_crossover_large_shared": "tasks=54;machines=15",
        "dispatch_crossover_large_per_row": "tasks=54;machines=15",
        "dispatch_crossover_large_skew": "tasks=46;machines=15",
        "dispatch_crossover_stress_shared": "tasks=657;machines=180",
        "dispatch_crossover_stress_per_row": "tasks=657;machines=180",
        "dispatch_crossover_stress_skew": "tasks=405;machines=180",
    },
}

# Phase 18: the reference's planner rows (``benchmarks/bench_planner.py`` on
# ``repro.sched``, over the port's GPU fleet built from its chip constants),
# derived columns; ``tests/test_torch_paper_planner.py`` recomputes them.
PLANNER_REF = {
    'planner_recurrentgemma_2b': 'admission=46,383tok/s;rr_baseline=5,433;gain=754%;iters=62',
    'planner_deepseek_v3_671b': 'admission=3,789tok/s;rr_baseline=231;gain=1539%;iters=49',
    'planner_granite_moe_1b_a400m': 'admission=307,605tok/s;rr_baseline=33,306;gain=824%;iters=76',
    'planner_xlstm_125m': 'admission=1,012,887tok/s;rr_baseline=61,623;gain=1544%;iters=76',
    'planner_whisper_tiny': 'admission=2,887,862tok/s;rr_baseline=281,108;gain=927%;iters=116',
    'planner_internlm2_1_8b': 'admission=77,798tok/s;rr_baseline=7,029;gain=1007%;iters=70',
    'planner_yi_9b': 'admission=15,730tok/s;rr_baseline=1,365;gain=1053%;iters=50',
    'planner_starcoder2_7b': 'admission=13,592tok/s;rr_baseline=832;gain=1533%;iters=59',
    'planner_qwen1_5_0_5b': 'admission=281,808tok/s;rr_baseline=28,099;gain=903%;iters=68',
    'planner_qwen2_vl_72b': 'admission=1,894tok/s;rr_baseline=142;gain=1238%;iters=45',
}
# The archs whose first plan on the serve example's fleet (H100 x 6 groups
# of 8, L4 x 8 groups of 4) comes under refine's gate (at most 64 tasks),
# and so launches B1 on the card; tests/test_torch_sched.py checks the same
# set. Once two H100 groups fail, every arch's plan comes under it.
PLANNER_REFINED = ("recurrentgemma_2b", "granite_moe_1b_a400m", "xlstm_125m", "whisper_tiny",
                   "starcoder2_7b", "qwen2_vl_72b")


def check(cond, message: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {message}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def scoring_problem(np, seed, B, T, m, n, per_row=False, skew=False, cap_rows=False,
                    memory=False, network=False, outside=False):
    rng = np.random.default_rng(seed)
    tm = rng.integers(0, m, size=(B, T))
    comp = np.sort(rng.integers(0, n, size=(B, T) if per_row else T), axis=-1)
    uir = rng.uniform(0.05, 1.5, size=(B, T) if (per_row or skew) else T)
    e_cm = rng.uniform(0.3, 3.0, size=(n, m)) * 10.0
    met_cm = rng.uniform(0.0, 2.0, size=(n, m))
    cap = rng.uniform(0.5, 1.5, size=(B, m) if cap_rows else m) * 100.0 * T / m
    if B >= 3 and m >= 3:
        tm[:3] = 0
        cap[..., 0] = 0.5 * T * met_cm[:, 0].mean()  # rows 0-2 over their fixed load
    extras = {}
    if network:
        extras["net_var"] = rng.uniform(0.0, 5.0, size=(B, m))
    if memory:
        mem_c = rng.uniform(0.5, 2.0, size=n)
        mem_w = np.zeros((B, m))
        np.add.at(mem_w, (np.repeat(np.arange(B), T), tm.reshape(-1)),
                  np.broadcast_to(mem_c[comp], (B, T)).reshape(-1))
        # A shared memory capacity at the median row's peak: about half the
        # rows fit.
        extras["mem_c"] = mem_c
        extras["mem_capacity"] = np.full(m, np.median(mem_w.max(axis=1)) if B else 1.0)
    if outside:  # every 7th task on an id outside [0, m): it matches no machine
        tm[:, ::7] = rng.choice([-1, m, m + 3], size=tm[:, ::7].shape)
    return (tm, comp, uir, e_cm, met_cm, cap), extras


def cut_problem(np, P, seed, topology, B, m, regime, outside=False):
    """Cut-traffic operands as the scorer's sweeps build them: shared
    counts, per-row counts, or per-row counts with skewed unit rates; six
    racks at m = 180, three random racks otherwise; with ``outside``, every
    7th task on an id outside [0, m)."""
    rng = np.random.default_rng(seed)
    utg = {"linear": P.linear_topology, "diamond": P.diamond_topology, "star": P.star_topology,
           "wide fanout": P.wide_fanout_topology,
           "fanout of 32": lambda: P.wide_fanout_topology(n_mid=32),
           "fanout of 48": lambda: P.wide_fanout_topology(n_mid=48)}[topology]()
    n = utg.n_components
    n_inst = rng.integers(1, 4 if m < 180 else 120, size=n)
    T = int(n_inst.sum())
    cir = P.component_rates(utg, 1.0)
    if regime == "shared":
        comp = np.repeat(np.arange(n), n_inst)
        uir = (cir / n_inst)[comp]
    else:
        counts = np.tile(n_inst, (B, 1))
        if np.any(n_inst > 1):
            counts[np.arange(B), rng.integers(0, n, size=B)] += 1
            counts[:, np.flatnonzero(n_inst > 1)[0]] -= 1
        comp, uir = P.cost_model.per_row_task_maps(cir, counts, T)
        if regime == "skew":
            uir = uir * rng.uniform(0.3, 1.7, size=uir.shape)
    racks = np.arange(m) % 6 if m == 180 else rng.integers(0, 3, size=m)
    dist = np.asarray(P.rack_distance_matrix(racks, 1.0, 2.0))
    tm = rng.integers(0, m, size=(B, T))
    if outside:
        tm[:, ::7] = rng.choice([-1, m, m + 3], size=tm[:, ::7].shape)
    return (tm, comp, uir, np.asarray(utg.alpha, dtype=np.float64), cir), utg.edges, dist


def cut_tensors(torch, np, device, args, dist):
    tm, comp, uir, alpha, cir = args
    t = lambda x, dt: torch.from_numpy(np.ascontiguousarray(x, dtype=dt)).to(device)  # noqa: E731
    return (t(tm, np.int32), t(comp, np.int32), t(uir, np.float64), t(alpha, np.float64),
            t(cir, np.float64)), t(dist, np.float64)


def cut_work(np, tm, comp, edges, m):
    """What cut_traffic's rows need, from this run's data: (operations,
    bytes of ``distance`` read). A contracted row of X (one a source and one
    a destination component of the edges) is non-zero only on the machines
    that hold its component's tasks in that row, and each of them needs m
    products and m sums against its column of ``distance``; then 4 m a row
    and edge, and 3 a task for the masses. Only those machines' columns are
    read, each once."""
    B, T = tm.shape
    comp = np.broadcast_to(comp, (B, T))
    rows = np.broadcast_to(np.arange(B, dtype=np.int64)[:, None], (B, T))
    valid = (tm >= 0) & (tm < m)
    nnz, used = 0, np.zeros(m, dtype=bool)
    for c in sorted({a for a, _ in edges}) + sorted({b for _, b in edges}):
        on = valid & (comp == c)
        nnz += np.unique(rows[on] * m + tm[on]).size
        used[tm[on]] = True
    return 2 * nnz * m + 4 * B * len(edges) * m + 3 * B * T, int(used.sum()) * m * 8


def md5_of(np, *arrays) -> str:
    """md5 over the bytes of ``arrays`` (float64 or int64), one after another."""
    import hashlib

    h = hashlib.md5()
    for x in arrays:
        x = np.asarray(x)
        h.update(np.ascontiguousarray(x, dtype=np.float64 if x.dtype.kind == "f"
                                      else np.int64).tobytes())
    return h.hexdigest()


def mt_fleet(np, C, MT, n_tenants, cap_scale=1.0):
    """``benchmarks/bench_multitenant.py``'s fleet: ``n_tenants`` tenants
    (linear, diamond, star and rolling-count topologies in turn, targets
    uniform in 20-200, priorities 1/1/2/4 from ``default_rng(0)``) on
    ``paper_cluster((20, 30, 40))`` with every capacity times ``cap_scale``.
    ``C`` and ``MT`` are a core package and its multitenant package."""
    rng = np.random.default_rng(0)
    tenants = [MT.Tenant(name=f"t{i:03d}", utg=getattr(C, FLEET_TOPOLOGIES[i % 4])(),
                         target_rate=float(rng.uniform(20, 200)),
                         priority=float(rng.choice([1.0, 1.0, 2.0, 4.0])))
               for i in range(n_tenants)]
    cluster = C.paper_cluster((20, 30, 40))
    return tenants, cluster.with_capacity(cluster.capacity * cap_scale)


def fleet_summary(np, ms) -> dict:
    """What phase 12a compares of a ``MultiTenantSchedule``: rounds,
    candidates, the log, the rates and every tenant's placement (digests)."""
    placements = [np.concatenate([a.etg.n_instances, a.etg.task_machine()])
                  for a in ms.allocations]
    return dict(rounds=ms.rounds, candidates=ms.candidates_evaluated,
                log_md5=md5_of(np, np.frombuffer("\n".join(ms.log).encode(), np.uint8)),
                rates_md5=md5_of(np, ms.rates), placement_md5=md5_of(np, *placements),
                total_rate=float(ms.rates.sum()))


def relocation_sweeps(np, mt):
    """Every single-task relocation of every tenant of ``mt``, in tenant,
    task and destination order: one ``(tenant, rows)`` sweep a tenant."""
    m = mt.cluster.n_machines
    sweeps = []
    for t, st in enumerate(mt.states):
        base = st.task_machine()
        T = base.shape[0]
        dest = np.tile(np.arange(m), T)
        col = np.repeat(np.arange(T), m)
        keep = dest != base[col]
        rows = np.tile(base, (int(keep.sum()), 1))
        rows[np.arange(rows.shape[0]), col[keep]] = dest[keep]
        sweeps.append((t, rows))
    return sweeps


def relocation_state(np, C, MT, tenants, cluster, ms):
    """Phase 12b's state: the fleet's allocation at 0.9 of its rates."""
    states = [C.schedule_state.ScheduleState.from_etg(a.etg, cluster) for a in ms.allocations]
    return MT.MultiTenantState(MT.TenantSet(tenants), cluster, states, rates=ms.rates * 0.9)


def resource_state(np, C, MT):
    """Phase 12c's state: the first 20 tenants of the fleet, first-assigned
    on 20/70/90 with memory (0.5/1/1.5/2 units an instance, 8 a machine)
    and six racks of 30 (``launch/profile_refine.py``'s resource cluster),
    each tenant at 0.04 of its residual R*."""
    base = C.paper_cluster((20, 70, 90))
    cluster = C.Cluster(machine_types=base.machine_types, capacity=base.capacity,
                        profile=base.profile.with_mem(np.array([0.5, 1.0, 1.5, 2.0])),
                        mem_capacity=np.full(180, 8.0),
                        distance=C.rack_distance_matrix(np.arange(180) % 6), net_penalty=0.05)
    tenants, _ = mt_fleet(np, C, MT, 20)
    mt = MT.MultiTenantState.first_assignment(MT.TenantSet(tenants), cluster)
    mt.rates = np.array([0.04 * mt.residual_rstar(t) for t in range(len(tenants))])
    return mt


def sweep_summary(np, scored) -> dict:
    """Rows, digests of the rates and the feasibility mask, feasible rows
    and the argmax of one ``TenantBatchScorer.score`` result."""
    rates = np.concatenate([r for r, _ in scored])
    thpt = np.concatenate([h for _, h in scored])
    return dict(rows=int(rates.size), rates_md5=md5_of(np, rates), thpt_md5=md5_of(np, thpt),
                mask_md5=md5_of(np, rates > 0.0), feasible=int((rates > 0.0).sum()),
                argmax=int(np.argmax(rates)))


def mt_runtime(np, C, MT, RS, recorder, sched_kw, run_kw):
    """Phase 12d: ``bench_multitenant.py``'s runtime tenants (alice linear
    8.0; bob diamond 8.0, priority 2; carol star 6.0) scheduled on
    ``paper_cluster((20, 30, 40))``; each tenant's trace is
    ``bench_runtime.py``'s ramp + slowdown over 240 windows (0.4 of its
    allocated rate, ramped to 1.1 of it over windows 20-120); the shared
    capacity grid slows the first largest machine to 0.6 from window 150.
    Runs online, 8 moves a period. Returns (schedule, runtime result)."""
    tenants = MT.TenantSet([
        MT.Tenant(name="alice", utg=C.linear_topology(), target_rate=8.0),
        MT.Tenant(name="bob", utg=C.diamond_topology(), target_rate=8.0, priority=2.0),
        MT.Tenant(name="carol", utg=C.star_topology(), target_rate=6.0),
    ])
    cluster = C.paper_cluster((20, 30, 40))
    ms = MT.schedule_tenants(list(tenants), cluster, **sched_kw)
    specs = [RS.TraceSpec(name=t.name, n_windows=240, base_rate=0.4 * float(r),
                          events=(RS.rate_ramp(1.1 * float(r), start=20, end=120),))
             for t, r in zip(tenants, ms.rates)]
    big = int(np.argmax(cluster.capacity))
    capacity = RS.TraceSpec(name="capacity", n_windows=240, base_rate=1.0,
                            events=(RS.machine_slowdown(big, 0.6, start=150),))
    mtrace = MT.compile_tenant_traces(tenants, specs, cluster, seed=0, capacity_spec=capacity)
    res = MT.MultiTenantRuntime(ms, tenants, cluster, mtrace).run(
        online=True, moves_per_period=8, recorder=recorder, **run_kw)
    return ms, res


# The one map under which the port's trace exports equal the reference's:
# every value that names a closed-form backend or a device (a dispatch
# record's ``requested`` and ``backend``, the ``refine`` span's ``backend``,
# the last part of a ``dispatch.<regime>.<backend>`` counter's name) becomes
# "numpy" — the port's devices and the reference's NumPy path give the same
# floats — and counters that then share a name are summed in the place of
# the first.
BACKEND_NAMES = {"auto": "numpy", "numpy": "numpy", "cpu": "numpy", "cuda": "numpy"}


def backend_map(jsonl: str) -> str:
    """``jsonl`` (a ``to_jsonl`` export) under the backend-name map."""
    out, counters = [], {}
    for line in jsonl.splitlines():
        rec = json.loads(line)
        args = rec.get("args")
        if rec["type"] == "dispatch":
            for key in ("requested", "backend"):
                args[key] = BACKEND_NAMES.get(args[key], args[key])
        elif rec["type"] == "span" and rec["name"] == "refine":
            args["backend"] = BACKEND_NAMES.get(args["backend"], args["backend"])
        elif rec["type"] == "metric" and rec["name"].startswith("dispatch."):
            head, _, name = rec["name"].rpartition(".")
            rec["name"] = f"{head}.{BACKEND_NAMES.get(name, name)}"
            first = counters.setdefault(rec["name"], rec)
            if first is not rec:
                first["value"] += rec["value"]
                first["count"] += rec["count"]
                continue
        out.append(rec)
    return "".join(json.dumps(r, sort_keys=True, separators=(",", ":")) + "\n" for r in out)


def runtime_summary(np, ms, res, jsonl) -> dict:
    """What phase 12d compares of a multi-tenant run: the allocation, each
    tenant's satisfaction and fingerprint, the arbiter's log, the recorded
    replan decisions and the whole export under the backend-name map."""
    decisions = [line for line in jsonl.splitlines() if '"type":"decision"' in line]
    return dict(rates_md5=md5_of(np, ms.rates), satisfaction=[float(s) for s in res.satisfaction],
                fingerprints=[r.fingerprint() for r in res.results],
                arbiter_md5=md5_of(np, np.frombuffer(repr(res.arbiter_log).encode(), np.uint8)),
                requests=len(res.arbiter_log),
                decisions_md5=md5_of(np, np.frombuffer("\n".join(decisions).encode(), np.uint8)),
                jsonl_md5=md5_of(np, np.frombuffer(backend_map(jsonl).encode(), np.uint8)))


def compare_cut(torch, np, cut_ops, args, edges, dist, penalty):
    """The cut-traffic kernel on the card vs its plain version (CPU) on the
    same inputs; returns the max abs error, which must be 0."""
    c_args, c_dist = cut_tensors(torch, np, "cpu", args, dist)
    g_args, g_dist = cut_tensors(torch, np, "cuda", args, dist)
    plain = cut_ops.cut_traffic(*c_args, edges, c_dist, penalty)
    got = cut_ops.cut_traffic(*g_args, edges, g_dist, penalty)
    torch.cuda.synchronize()
    got = got.cpu()
    check(got.shape == plain.shape and bool(torch.isfinite(got).all()), "cut_traffic output")
    err = float((got - plain).abs().max()) if got.numel() else 0.0
    check(err == 0.0 and torch.equal(got, plain),
          f"cut_traffic differs from its plain version by {err}")
    return err


def to_tensors(torch, np, device, args, extras):
    tm, comp, uir, e_cm, met_cm, cap = args
    t = lambda x, dt: torch.from_numpy(np.ascontiguousarray(x, dtype=dt)).to(device)  # noqa: E731
    out = (t(tm, np.int32), t(comp, np.int32), t(uir, np.float64), t(e_cm, np.float64),
           t(met_cm, np.float64), t(cap, np.float64))
    return out, {k: t(v, np.float64) for k, v in extras.items()}


def compare_kernel(torch, np, ops, args, extras, rerun=False):
    """Kernel on the card vs plain version (CPU) on the same inputs; returns
    the max abs error after checking mask and argmax (and, with ``rerun``,
    that a second launch gives the same bits)."""
    cpu_args, cpu_kw = to_tensors(torch, np, "cpu", args, extras)
    gpu_args, gpu_kw = to_tensors(torch, np, "cuda", args, extras)
    plain = ops.sched_scoring(*cpu_args, **cpu_kw).numpy()
    got = ops.sched_scoring(*gpu_args, **gpu_kw)
    if rerun:
        check(torch.equal(got, ops.sched_scoring(*gpu_args, **gpu_kw)),
              "kernel rerun differs")
    torch.cuda.synchronize()
    got = got.cpu().numpy()
    check(got.shape == plain.shape, "kernel output shape")
    check(np.array_equal(got == 0.0, plain == 0.0), "kernel feasibility mask differs")
    if got.size:
        check(int(np.argmax(got)) == int(np.argmax(plain)), "kernel argmax differs")
        finite = np.isfinite(plain)
        check(np.array_equal(np.isfinite(got), finite), "kernel infinities differ")
        err = float(np.max(np.abs(got[finite] - plain[finite]), initial=0.0))
    else:
        err = 0.0
    check(err == 0.0, f"kernel differs from its plain version by {err}")
    return err, int((plain == 0.0).sum())


# Phase 10's keyed run: the key realization's seed and the Zipf exponent
# its hot keys shift to, chosen so that the shift cuts the even-split
# schedule's skew-aware R* below the offered rate and the controller's
# replan clears its guard; the CPU holds its first 91 windows (the replan
# at window 89 and one window after it).
KEYED_SHIFT_SEED = 1
KEYED_SHIFT_ZIPF = 1.6
KEYED_PREFIX = 91
# The oracle's first plan lands at window 0; the CPU holds two windows.
ORACLE_PREFIX = 2
# A streaming run's per-window metrics (``RuntimeResult``).
RUN_FIELDS = ("offered", "admitted", "throughput", "dropped", "queue_total", "queue_max",
              "machine_util", "throttle", "migrations")


# Phase 7's cases: (label, B, Sq, Sk, H, Hkv, D, causal, window) for B3 and
# (label, B, H, Hkv, S, D) for B4, whose lengths run from 1 to S.
FLASH_CASES = [
    ("serving shape", 8, 512, 512, 16, 16, 64, True, 0),
    ("GQA G=2, right-aligned queries", 1, 128, 256, 4, 2, 64, True, 0),
    ("GQA G=8, ragged S=300", 2, 300, 300, 8, 1, 64, True, 0),
    ("MQA + window 128, D=128", 2, 256, 256, 2, 1, 128, True, 128),
    ("bidirectional, D=32", 1, 64, 64, 2, 2, 32, False, 0),
    ("ragged S=192", 1, 192, 192, 2, 2, 64, True, 0),
    ("window without causal, Sk=300", 1, 100, 300, 4, 2, 32, False, 40),
    ("ragged S=600, window 200, D=256", 1, 600, 600, 2, 2, 256, True, 200),
    ("recurrentgemma prefill, window 2048, MQA", 8, 2304, 2304, 10, 1, 256, True, 2048),
]
DECODE_CASES = [
    ("serving shape", 8, 16, 16, 576, 64),
    ("GQA G=4, S=1024", 2, 8, 2, 1024, 64),
    ("GQA G=8, ragged S=300", 2, 16, 2, 300, 64),
    ("MQA, D=128", 4, 4, 1, 512, 128),
    ("ragged S=600", 3, 16, 16, 600, 64),
    ("ragged S=192, D=256", 2, 16, 2, 192, 256),
    ("recurrentgemma ring of 2048, MQA", 8, 10, 1, 2048, 256),
]
# Phase 7's B5 cases: (label, B, S, W), from a non-zero h0.
SCAN_CASES = [
    ("serving shape", 8, 2304, 2560),
    ("S=1", 2, 1, 2560),
    ("S=37, W=37 (B x W = 111)", 3, 37, 37),
    ("S=100, W=100 (B x W = 500)", 5, 100, 100),
    ("S=2304, W=37", 1, 2304, 37),
]
# B5 against its plain version: both carry float32 and round each product
# and sum once, in the same order, so they agree bit for bit; the bound is
# the scan tolerance of tests/test_kernels.py, float32 1e-5 (bf16 outputs
# are the same float32 states, each rounded once).
SCAN_TOL = 1e-5
# Kernel vs plain version on the same card, elementwise |got - want| <=
# atol + rtol |want|. Both compute in float32 and differ only in the order of
# sums: float32 2e-5, the tolerance of tests/test_kernels.py. In bfloat16
# both round that float32 result once, so they may differ by one bf16 ulp,
# at most 2^-7 |want|; the 1e-5 covers the float32 part near zero.
ATTN_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-5, 2.0 ** -7)}
# Card (bf16) against the CPU (float32) on the same weights, per step:
# ||d||_2 / ||ref||_2 and max|d| / max|ref| of the logits, each at most
# 16 u with u = 2^-8 the bf16 unit roundoff. The same full-depth model at
# widths 256-512, bf16 against float32 on a CPU, gives 0.015-0.017.
LOGIT_TOL = 16 * 2.0 ** -8


def attention_error(torch, what, got, want) -> float:
    """Max abs error of a kernel's output against its plain version, after
    checking it is finite and within ``ATTN_TOL`` of its type."""
    atol, rtol = ATTN_TOL[str(got.dtype).split(".")[1]]
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    check(torch.allclose(got, want, atol=atol, rtol=rtol),
          f"{what}: max abs error {err}, over atol {atol} + rtol {rtol}")
    return err


def decode_boundary_case(torch, gen, decode_ops, decode_ref, dtype) -> float:
    """B4 over recurrentgemma-2b's ring with lengths on the split pass's
    slice boundaries and one slot either side; a rerun must be bit-identical
    (the combine pass sums the slices in a fixed order)."""
    from repro_torch.kernels.decode_attention.ref import split_starts

    B, H, Hkv, S, D = 8, 10, 1, 2048, 256
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for shape in ((B, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    n_split = decode_ops.split_count(B * Hkv, S, H // Hkv, D, q.element_size())
    bounds = split_starts(n_split, S)[1:-1]
    lengths = torch.tensor([bounds[0], bounds[0] + 1, bounds[1] - 1, bounds[1], bounds[-1],
                            bounds[-1] + 1, S - 1, S], dtype=torch.int32, device="cuda")
    got = decode_ops.decode_attention(q, k, v, lengths)
    again = decode_ops.decode_attention(q, k, v, lengths)
    name = str(dtype).split(".")[1]
    err = attention_error(torch, f"decode_attention slice boundaries {name}", got,
                          decode_ref(q, k, v, lengths))
    check(torch.equal(got, again), f"decode_attention slice boundaries {name}: rerun differs")
    print(f"  B4 {'ring, lengths on slice boundaries':<34} {name:<8} {n_split} slices, lengths "
          f"{lengths.tolist()} max abs err {err:.3e}; rerun bit-identical")
    return err


def scan_inputs(torch, gen, B, S, W, dtype):
    a = torch.sigmoid(torch.randn(B, S, W, generator=gen, device="cuda")).to(dtype)
    b = torch.randn(B, S, W, generator=gen, device="cuda").to(dtype)
    return a, b, torch.randn(B, W, generator=gen, device="cuda")


def scan_error(torch, what, got, want) -> float:
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    check(torch.allclose(got, want, atol=SCAN_TOL, rtol=SCAN_TOL),
          f"{what}: max abs error {err}, over {SCAN_TOL}")
    return err


def kernel_phase(torch, flash_ops, decode_ops, scan_ops, flash_ref, decode_ref, scan_ref):
    """Phase 7: each attention kernel and the scan against its plain version
    on the card."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    max_err = {"flash_attention": 0.0, "decode_attention": 0.0, "rglru_scan": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for label, B, Sq, Sk, H, Hkv, D, causal, window in FLASH_CASES:
            q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                       for shape in ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
            got = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
            want = flash_ref(q, k, v, causal=causal, window=window)
            err = attention_error(torch, f"flash_attention {label} {name}", got, want)
            max_err["flash_attention"] = max(max_err["flash_attention"], err)
            print(f"  B3 {label:<34} {name:<8} max abs err {err:.3e}")
        for label, B, H, Hkv, S, D in DECODE_CASES:
            q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                       for shape in ((B, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
            lengths = torch.randint(1, S + 1, (B,), generator=gen, device="cuda",
                                    dtype=torch.int32)
            lengths[0] = 1
            if B > 1:
                lengths[-1] = S
            got = decode_ops.decode_attention(q, k, v, lengths)
            want = decode_ref(q, k, v, lengths)
            err = attention_error(torch, f"decode_attention {label} {name}", got, want)
            max_err["decode_attention"] = max(max_err["decode_attention"], err)
            print(f"  B4 {label:<34} {name:<8} lengths {lengths.tolist()} max abs err {err:.3e}")
        err = decode_boundary_case(torch, gen, decode_ops, decode_ref, dtype)
        max_err["decode_attention"] = max(max_err["decode_attention"], err)
        for label, B, S, W in SCAN_CASES:
            a, b, h0 = scan_inputs(torch, gen, B, S, W, dtype)
            err = scan_error(torch, f"rglru_scan {label} {name}", scan_ops.rglru_scan(a, b, h0),
                             scan_ref(a, b, h0))
            max_err["rglru_scan"] = max(max_err["rglru_scan"], err)
            print(f"  B5 {label:<34} {name:<8} max abs err {err:.3e}")
    return max_err


def serve_run(torch, kernel_ops, M, serve, cfg, params, B, prompt_len, gen_len, expected, wall,
              serve_kw=None):
    """Serve at full width on the card with every launch count set to 0
    just before; check the launches of the run against ``expected`` and
    return them. A set-up run at the same batch and prompt length first
    (allocator growth, cuBLAS's first calls at these shapes), so the times
    are those of a warm server. ``serve_kw`` goes to ``serve`` (qwen2-vl's
    prompt embeddings and M-RoPE positions)."""
    n_params = sum(t.numel() for t in _leaves(params))
    kw = serve_kw or {}
    setup = {k: v[:, :, :1] if k == "decode_positions" else v for k, v in kw.items()}
    serve(cfg, batch=B, prompt_len=prompt_len, gen_len=2, params=params, device="cuda", **setup)
    for ops in kernel_ops:
        ops.reset_launches()
    res = serve(cfg, batch=B, prompt_len=prompt_len, gen_len=gen_len, params=params,
                device="cuda", **kw)
    launches = {k: v for ops in kernel_ops for k, v in ops.LAUNCHES.items()}
    check(launches == expected, f"{cfg.name}: launches {launches}, not {expected}")
    toks = res.tokens
    check(tuple(toks.shape) == (B, gen_len) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab_size, "served tokens out of shape or vocabulary")
    wall[f"{cfg.name}_prefill_s"], wall[f"{cfg.name}_decode_s"] = res.prefill_s, res.decode_s
    heads = (f"{cfg.n_heads} MLA heads (q/k {cfg.qk_nope_dim + cfg.qk_rope_dim}, v "
             f"{cfg.v_head_dim}, latent {cfg.kv_lora_rank} + rope {cfg.qk_rope_dim})"
             if cfg.use_mla else f"{cfg.n_heads} heads of {cfg.resolved_head_dim}")
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {heads}, "
          f"{n_params / 1e6:.1f} M parameters in {cfg.param_dtype}")
    print(f"  served {B} requests x {prompt_len} prompt + {gen_len} generated tokens: prefill "
          f"{res.prefill_s:.4f} s ({B * prompt_len / res.prefill_s:,.0f} prompt tok/s), decode "
          f"{res.decode_s:.4f} s for {gen_len - 1} steps ({B * (gen_len - 1) / res.decode_s:,.1f} "
          f"tok/s, {1e3 * res.decode_s / (gen_len - 1):.3f} ms/step); launches {launches}")
    print(f"  sample output ids: {toks[0, :12].tolist()}")
    return launches


def lockstep(torch, M, card, cpu, Bc, Pc, steps, frames=None, image=None):
    """The card's and the CPU's model, each a (cfg, params), on one random
    prompt (and an encoder-decoder's encoder on the same CPU ``frames``,
    each side's own output handed to every step), the CPU fed the card's
    tokens: yields (step, card logits on the CPU in float32, CPU logits)
    for the prefill and each of ``steps`` decode steps. With ``image`` =
    (text before, (rows, cols), text after), qwen2-vl's prompt: each side
    embeds the prompt's ids with its own table (``image_embeds``) around
    the same stub image rows, and every call takes its M-RoPE positions."""
    (cfg, params), (cfg_c, params_c) = card, cpu
    gen = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (Bc, Pc), generator=gen)
    card_x, cpu_x = {}, {}
    if frames is not None:
        card_x = {"encoder_out": M.encode(params, cfg, frames.to("cuda", M._DTYPES[cfg.dtype]))}
        cpu_x = {"encoder_out": M.encode(params_c, cfg_c, frames.to(M._DTYPES[cfg_c.dtype]))}
    card_b, cpu_b = {"tokens": prompt, **card_x}, {"tokens": prompt, **cpu_x}
    step_pos = None
    if image is not None:
        pre, grid, post = image
        check(pre + grid[0] * grid[1] + post == Pc, f"image layout {image} is not {Pc} positions")
        pos, step_pos = image_positions(torch, Bc, pre, grid, post, steps)
        stub = image_stub(torch, cfg, Bc, grid[0] * grid[1], gen)
        card_b = {"embeds": image_embeds(torch, M, cfg, params, prompt, stub, pre),
                  "mrope_positions": pos}
        cpu_b = {"embeds": image_embeds(torch, M, cfg_c, params_c, prompt, stub, pre),
                 "mrope_positions": pos}
    card_c = M.init_caches(cfg, Bc, Pc + steps, device="cuda")
    cpu_c = M.init_caches(cfg_c, Bc, Pc + steps, device="cpu")
    card_l, card_c = M.prefill(params, cfg, card_b, card_c, device="cuda")
    cpu_l, cpu_c = M.prefill(params_c, cfg_c, cpu_b, cpu_c, device="cpu")
    for step in range(steps + 1):
        got = card_l.float().cpu()
        check(bool(torch.isfinite(got).all()) and tuple(got.shape) == (Bc, cfg.vocab_size),
              f"card logits at step {step}: non-finite or misshapen")
        yield step, got, cpu_l
        if step < steps:
            tok = got.argmax(-1)[:, None]
            pos_x = {} if step_pos is None else {"mrope_positions": step_pos[:, :, step:step + 1]}
            card_l, card_c = M.decode_step(params, cfg, {"tokens": tok, **card_x, **pos_x},
                                           card_c, device="cuda")
            cpu_l, cpu_c = M.decode_step(params_c, cfg_c, {"tokens": tok, **cpu_x, **pos_x},
                                         cpu_c, device="cpu")


def _float32(cfg):
    return dataclasses.replace(cfg, dtype="float32", param_dtype="float32")


def cpu_check(torch, M, cfg, params, Bc, Pc, steps, frames=None, image=None) -> None:
    """The same weights on the CPU in float32, teacher-forced with the card's
    tokens: the card's bf16 logits within ``LOGIT_TOL`` at every step."""
    cpu = (_float32(cfg), _map_leaves(params, lambda t: t.float().cpu()))
    worst = (0.0, 0.0)
    agree = 0
    for step, got, want in lockstep(torch, M, (cfg, params), cpu, Bc, Pc, steps, frames, image):
        rel_l2 = float((got - want).norm() / want.norm())
        rel_max = float((got - want).abs().max() / want.abs().max())
        check(rel_l2 <= LOGIT_TOL and rel_max <= LOGIT_TOL,
              f"step {step}: card vs CPU logits differ by {rel_l2:.4f} (l2) / {rel_max:.4f} "
              f"(max) over {LOGIT_TOL}")
        worst = (max(worst[0], rel_l2), max(worst[1], rel_max))
        agree += int((got.argmax(-1) == want.argmax(-1)).sum())
    print(f"  card (bf16) vs CPU (float32), {Bc} x {Pc} prompt + {steps} steps, teacher-forced: "
          f"worst relative error {worst[0]:.4f} (l2) / {worst[1]:.4f} (max) <= {LOGIT_TOL}; "
          f"argmax agrees {agree}/{Bc * (steps + 1)}")


def first_layers(M, cfg, params, n_layers):
    """The config and parameters of ``cfg``'s first ``n_layers`` layers, the
    same tensors regrouped into the cut model's segments."""
    cut = dataclasses.replace(cfg, n_layers=n_layers,
                              block_pattern=cfg.resolved_block_pattern[:n_layers])
    layers = [params["segments"][si][pi][r] for si, (pattern, reps) in enumerate(M.segments_of(cfg))
              for r in range(reps) for pi in range(len(pattern))]
    segments, i = [], 0
    for pattern, reps in M.segments_of(cut):
        seg = [[None] * reps for _ in pattern]
        for r in range(reps):
            for pi in range(len(pattern)):
                seg[pi][r], i = layers[i], i + 1
        segments.append(seg)
    return cut, {**params, "segments": segments}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_leaves(v, fn) for v in tree]
    return fn(tree)


def sdpa_call(torch, F, q, k, v, causal, window):
    """One ``scaled_dot_product_attention`` call computing what B3 or B4
    computes (heads first; a window as a boolean mask; GQA by the call's own
    flag where the installed PyTorch has it, else K/V repeated beforehand)."""
    H, Hkv, Sq, Sk = q.shape[2], k.shape[2], q.shape[1], k.shape[1]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    kw = {}
    if H != Hkv:
        if "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or ""):
            kw["enable_gqa"] = True
        else:
            kt, vt = (x.repeat_interleave(H // Hkv, dim=1) for x in (kt, vt))
    if window:
        qpos = torch.arange(Sk - Sq, Sk, device=q.device)[:, None]
        kpos = torch.arange(Sk, device=q.device)[None, :]
        kw["attn_mask"] = (kpos <= qpos) & (kpos > qpos - window)
    else:
        kw["is_causal"] = causal
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw)


def time_flash(torch, F, flash_ops, flash_ref, B, S, H, Hkv, D, window, Sk=None, causal=True):
    """B3 at (B, S, H, Hkv, D), bf16, causal (or, with ``causal=False``,
    every query over ``Sk`` keys, S by default): (max abs err, ms, plain ms,
    bound, library ms) and a printed line."""
    from repro_torch.launch.timing import time_cuda
    Sk = Sk or S
    gen = torch.Generator(device="cuda").manual_seed(9)
    bf16 = dict(device="cuda", dtype=torch.bfloat16)
    q, k, v = (torch.randn(shape, generator=gen, **bf16)
               for shape in ((B, S, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
    kw = dict(causal=causal, window=window)
    err = attention_error(torch, f"B3 at B={B} S={S} Sk={Sk} H={H}",
                          flash_ops.flash_attention(q, k, v, **kw), flash_ref(q, k, v, **kw))
    ms = time_cuda(lambda: flash_ops.flash_attention(q, k, v, **kw))
    plain_ms = time_cuda(lambda: flash_ref(q, k, v, **kw), reps=5)
    lib_ms = time_cuda(sdpa_call(torch, F, q, k, v, causal, window))
    # (query, key) pairs that the causal and window masks leave.
    pairs = B * H * (sum(min(i + 1, window or S) for i in range(S)) if causal else S * Sk)
    flops = 4 * D * pairs
    n_bytes = 2 * B * (2 * S * H + 2 * Sk * Hkv) * D  # bf16 q, k, v read and o written once
    bound = _bound(flops / BF16_FLOPS_PER_S, n_bytes / HBM_BYTES_PER_S)
    mask = "causal" if causal else f"bidirectional over Sk={Sk}"
    print(f"  B3 flash_attention B={B} S={S} H={H} Hkv={Hkv} D={D} window={window} bf16 {mask}: "
          f"{ms:.4f} ms, bound {bound[0]:.4f} ms by {bound[1]} ({flops / 1e9:.2f} GFLOP, "
          f"{n_bytes / 1e6:.2f} MB; {100 * bound[0] / ms:.1f}% of it), plain {plain_ms:.4f} ms, "
          f"scaled_dot_product_attention {lib_ms:.4f} ms")
    return err, ms, plain_ms, bound, lib_ms


def time_decode(torch, F, decode_ops, decode_ref, B, H, Hkv, S_cache, length, D):
    """B4 over ``length`` of ``S_cache`` slots, bf16: as ``time_flash``."""
    from repro_torch.launch.timing import time_cuda
    gen = torch.Generator(device="cuda").manual_seed(10)
    bf16 = dict(device="cuda", dtype=torch.bfloat16)
    qd = torch.randn(B, H, D, generator=gen, **bf16)
    kc, vc = (torch.randn(B, S_cache, Hkv, D, generator=gen, **bf16) for _ in range(2))
    lengths = torch.full((B,), length, dtype=torch.int32, device="cuda")
    err = attention_error(torch, f"B4 at B={B} S={S_cache}", decode_ops.decode_attention(
        qd, kc, vc, lengths), decode_ref(qd, kc, vc, lengths))
    ms = time_cuda(lambda: decode_ops.decode_attention(qd, kc, vc, lengths))
    plain_ms = time_cuda(lambda: decode_ref(qd, kc, vc, lengths), reps=5)
    lib_ms = time_cuda(sdpa_call(torch, F, qd[:, None], kc[:, :length], vc[:, :length],
                                        False, 0))
    n_bytes = 2 * B * length * Hkv * D * 2 + 2 * B * H * D * 2 + B * 4
    flops = 4 * B * H * length * D
    bound = _bound(flops / BF16_FLOPS_PER_S, n_bytes / HBM_BYTES_PER_S)
    n_split = decode_ops.split_count(B * Hkv, S_cache, H // Hkv, D, 2)
    # float32 partials, written once and read once
    scratch = B * Hkv * n_split * (H // Hkv) * (D + 2) * 4
    kv_bytes = 2 * B * S_cache * Hkv * D * 2
    print(f"  B4 decode_attention B={B} H={H} Hkv={Hkv} S={S_cache} lengths {length} D={D} bf16: "
          f"{ms:.4f} ms, bound {bound[0]:.4f} ms by {bound[1]} ({n_bytes / 1e6:.2f} MB; "
          f"{100 * bound[0] / ms:.1f}% of it), plain {plain_ms:.4f} ms, "
          f"scaled_dot_product_attention {lib_ms:.4f} ms; {n_split} slices, partials "
          f"{scratch / 1e6:.2f} MB ({100 * scratch / kv_bytes:.1f}% of the K/V bytes)")
    return err, ms, plain_ms, bound, lib_ms


def time_scan(torch, scan_ops, scan_ref, B, S, W):
    """B5 at (B, S, W) float32 (the model's a and b): as ``time_flash``,
    without a library call (no single PyTorch call computes a linear
    recurrence)."""
    from repro_torch.launch.timing import time_cuda
    gen = torch.Generator(device="cuda").manual_seed(11)
    a, b, h0 = scan_inputs(torch, gen, B, S, W, torch.float32)
    err = scan_error(torch, "B5 at the serving shape", scan_ops.rglru_scan(a, b, h0),
                     scan_ref(a, b, h0))
    ms = time_cuda(lambda: scan_ops.rglru_scan(a, b, h0))
    plain_ms = time_cuda(lambda: scan_ref(a, b, h0), reps=5)
    n_bytes = 3 * B * S * W * 4 + B * W * 4  # a, b read and h written once; h0
    flops = 2 * B * S * W
    bound = _bound(flops / FP32_FLOPS_PER_S, n_bytes / HBM_BYTES_PER_S)
    print(f"  B5 rglru_scan B={B} S={S} W={W} float32: {ms:.4f} ms, bound {bound[0]:.4f} ms by "
          f"{bound[1]} ({n_bytes / 1e6:.2f} MB; {100 * bound[0] / ms:.1f}% of it), plain "
          f"{plain_ms:.4f} ms; no single PyTorch call computes it, so library_ms is null")
    return err, ms, plain_ms, bound, None


def time_cut_traffic(torch, np, P, cut_ops, etg, cluster, rng, launches, max_err):
    """The cut-traffic kernel at the resource refine's sweep shape (5 555
    rows of the refined placement, one task moved per row): checked equal
    to its plain version on the card, then timed beside it; its record."""
    from repro_torch.kernels.cut_traffic import kernel as cut_kernel
    from repro_torch.kernels.cut_traffic.ref import cut_traffic_ref
    from repro_torch.launch.timing import time_cuda

    B, base, utg = 5555, etg.task_machine(), etg.utg
    T, m = base.size, cluster.n_machines
    batch = np.tile(base, (B, 1))
    batch[np.arange(B), rng.integers(0, T, B)] = rng.integers(0, m, B)
    comp = etg.task_component()
    cir = P.component_rates(utg, 1.0)
    args = (batch, comp, (cir / etg.n_instances)[comp], np.asarray(utg.alpha, dtype=np.float64),
            cir)
    g_args, g_dist = cut_tensors(torch, np, "cuda", args, cluster.distance)
    pen, edges = cluster.net_penalty, utg.edges
    got = cut_ops.cut_traffic(*g_args, edges, g_dist, pen)
    plain = cut_traffic_ref(*g_args, edges, g_dist, pen)
    torch.cuda.synchronize()
    err = float((got - plain).abs().max())
    check(torch.equal(got, plain), f"cut_traffic at the sweep shape differs by {err}")
    max_err["cut_traffic"] = max(max_err["cut_traffic"], err)
    ms = time_cuda(lambda: cut_ops.cut_traffic(*g_args, edges, g_dist, pen))
    wrapper_ms = time_cuda(lambda: cut_ops.cut_traffic(*g_args, edges, g_dist, pen),
                           spin_cycles=0)
    plain_ms = time_cuda(lambda: cut_traffic_ref(*g_args, edges, g_dist, pen), reps=5)
    k2 = len({a for a, _ in edges}) + len({b for _, b in edges})
    flops, dist_bytes = cut_work(np, batch, comp, edges, m)
    n_bytes = sum(x.numel() * x.element_size() for x in g_args) + dist_bytes + B * m * 8
    bound = _bound(flops / FP64_FLOPS_PER_S, n_bytes / HBM_BYTES_PER_S)
    print(f"  cut_traffic B={B} T={T} m={m} ({len(edges)} edges, {k2} contracted rows a row): "
          f"{ms:.4f} ms ({wrapper_ms:.4f} ms with the wrapper's host time), bound "
          f"{bound[0]:.4f} ms by {bound[1]} ({flops / 1e9:.3f} GFLOP and {n_bytes / 1e6:.2f} MB "
          f"that the rows' non-zero columns need; {100 * bound[0] / ms:.1f}% of it), plain "
          f"{plain_ms:.3f} ms; no single PyTorch call computes it, so library_ms is null")
    plan = cut_kernel.launch_plan(B, T, edges, m)
    print(f"    {plan['rows']} rows a block, {plan['threads']} threads, {plan['smem_bytes']} shared "
          f"bytes, {plan['tile_columns']}-column distance tiles, {plan['tile_stages']} in flight; "
          + _launch_text(torch, flops, plan["blocks"], plan["blocks_per_sm"], plan["registers"],
                         plan["local_bytes"]))
    return dict(_record("cut_traffic", "src/repro_torch/kernels/cut_traffic/csrc/cut_traffic.cu",
                        "src/repro/core/cost_model.py:400", launches, max_err["cut_traffic"],
                        (err, ms, plain_ms, bound, None)), wrapper_ms=wrapper_ms)


def trace_prefix(tr, n):
    """The first ``n`` windows of a compiled trace: the same arrays, the
    events before window ``n``."""
    return dataclasses.replace(tr, rates=tr.rates[:n].copy(), capacity=tr.capacity[:n].copy(),
                               events=tuple(e for e in tr.events if e[0] < n))


def same_run(RS, what, card, cpu):
    """The (result, controller) of a run on the card and of the same run on
    the CPU: equal fingerprints, events and replan ledgers."""
    (g, g_ctl), (c, c_ctl) = card, cpu
    check(g.fingerprint() == c.fingerprint() and g.events == c.events,
          f"{what}: the run on the card differs from the CPU's")
    if isinstance(g_ctl, RS.OnlineController):
        check(g_ctl.ledger.to_records() == c_ctl.ledger.to_records(),
              f"{what}: the replan ledger on the card differs from the CPU's")
        return f"{len(g_ctl.ledger.accepted)} of {len(g_ctl.ledger)} decisions replanned"
    return f"{len(g_ctl._cache)} plans"


def held_run(RS, np, what, etg, cluster, trace, make_controller, n=None):
    """One run of ``trace`` on the card and the same on the CPU
    (``make_controller(device)``), held by ``same_run``. With ``n`` the CPU
    runs only the first ``n`` windows, and the card's run must equal it
    over those: metrics, events and replan decisions. Returns the card's
    (result, controller)."""
    from repro_torch.launch.profile_runtime import RUNTIME_CONFIG

    out, secs = {}, {}
    for device, tr in (("cuda", trace), ("cpu", trace if n is None else trace_prefix(trace, n))):
        t0 = time.perf_counter()
        ctl = make_controller(device)
        out[device] = (RS.StreamExecutor(etg, cluster, tr, config=RUNTIME_CONFIG)
                       .run(controller=ctl), ctl)
        secs[device] = time.perf_counter() - t0
    (g, g_ctl), (c, c_ctl) = out["cuda"], out["cpu"]
    if n is None:
        held = f"fingerprint {g.fingerprint()}; {same_run(RS, what, out['cuda'], out['cpu'])}"
    else:
        for field in RUN_FIELDS:
            check(np.array_equal(getattr(g, field)[:n], getattr(c, field)),
                  f"{what}: {field} on the card differs from the CPU's over {n} windows")
        check(tuple(e for e in g.events if e[0] < n) == c.events,
              f"{what}: events on the card differ from the CPU's over {n} windows")
        if isinstance(g_ctl, RS.OnlineController):
            check([r for r in g_ctl.ledger.to_records() if r["window"] < n]
                  == c_ctl.ledger.to_records(),
                  f"{what}: the replan ledger on the card differs from the CPU's over {n} windows")
        held = f"over the first {n} of {g.n_windows} windows"
    print(f"  {what}: card == cpu ({held}; {int(g.migrations.sum())} instances moved; card "
          f"{secs['cuda']:.2f} s, cpu {secs['cpu']:.2f} s)")
    return out["cuda"]


def runtime_phases(torch, np, P, ops, cut_ops, cluster, refined, wall):
    """Phases 10 and 11: the online path and the policy sweep at the paper's
    large scale; returns the ``policy_scan`` record."""
    import repro_torch.runtime_stream as RS
    from repro_torch.kernels.policy_scan import kernel as scan_kernel
    from repro_torch.kernels.policy_scan import ops as scan_ops
    from repro_torch.kernels.policy_scan.ref import policy_scan_ref
    from repro_torch.launch.profile_runtime import (
        N_WINDOWS,
        PROVISION,
        RUNTIME_CONFIG,
        SCENARIOS,
        online_run,
        refine_times,
        runtime_traces,
        sweep_policies,
    )
    from repro_torch.launch.timing import time_cuda
    from repro_torch.runtime_stream.eval_torch import scan_operands

    print("[10] streaming runtime at the paper's large scale: online replans on the card, the "
          "policy sweep")
    etg, utg, W = refined.etg, refined.etg.utg, N_WINDOWS
    traces = {k: s.compile(cluster, seed=0, utg=utg)
              for k, s in runtime_traces(cluster, refined.rate).items()}
    kernel_ops = (ops, cut_ops, scan_ops)
    # The plain scorer must not run on the card: count its calls on CUDA
    # tensors while the online, oracle and keyed runs go.
    plain_score, eager = ops.sched_scoring_ref, []

    def counting_score(task_machine, *args, **kwargs):
        if task_machine.is_cuda:
            eager.append(tuple(task_machine.shape))
        return plain_score(task_machine, *args, **kwargs)

    ops.sched_scoring_ref = counting_score
    for name in ("ramp", "failure"):
        # From provision_schedule at the trace's initial rate, as the
        # reference runtime benchmark's online policy starts.
        start = RS.provision_schedule(utg, cluster, PROVISION[name] * refined.rate)
        for k_ops in kernel_ops:
            k_ops.reset_launches()
        with refine_times([]) as refines:
            t0 = time.perf_counter()
            res, ctl = online_run(start, cluster, traces[name])
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        launches = {k: v for k_ops in kernel_ops for k, v in k_ops.LAUNCHES.items()}
        check(launches["sched_scoring"] > 0 and launches["sched_scoring_resources"] == 0
              and launches["cut_traffic"] == 0 and launches["policy_scan"] == 0,
              f"online {name}: replans did not run on B1 alone ({launches})")
        check(len(refines) == len(ctl.ledger) and ctl.ledger.accepted,
              f"online {name}: no replan was applied")
        check(res.throughput.shape == (W,) and res.machine_util.shape == (W, cluster.n_machines)
              and bool(np.all(np.isfinite(res.machine_util))), f"online {name}: bad metrics")
        wall[f"online_{name}_s"] = run_s
        t0 = time.perf_counter()
        decided = same_run(RS, f"online {name}", (res, ctl),
                           online_run(start, cluster, traces[name], device="cpu"))
        print(f"  online {name}, {W} windows from {start.total_tasks} tasks: {run_s:.3f} s on the "
              f"card, of which refine {sum(refines):.3f} s in {len(refines)} calls "
              f"({100 * sum(refines) / run_s:.1f}%); {decided}, {int(res.migrations.sum())} "
              f"instances moved, {res.final_etg.total_tasks} tasks at the end; sustained "
              f"{res.sustained_throughput():.4f}; launches {launches}; card == cpu (fingerprint "
              f"{res.fingerprint()}, cpu {time.perf_counter() - t0:.2f} s)")

    t_cpu = time.perf_counter()
    # On a shuffle topology the oracle plans by Algorithm 1 alone, on the
    # host; its refines (B1) run on keyed topologies, below.
    held_run(RS, np, "oracle, failure", etg, cluster, traces["failure"],
             lambda device: RS.OracleRescheduler(utg, cluster, device=device))
    # A keyed run (skew-aware replans) on the same cluster: the even-split
    # schedule at 0.8 of its skew-aware R* under the first key realization;
    # a third of the way in the hot keys move to a steeper Zipf, and the
    # controller must carry out a skew_shift replan on the card. The CPU
    # holds the run's first windows, through that replan.
    keyed = P.keyed_rolling_count_topology(n_keys=64, zipf_s=1.2)
    keyed_etg = P.schedule(keyed, cluster, r0=1.0, rate_epsilon=1.0).etg
    shift = RS.skew_shift_trace(1.0, n_windows=W, zipf_s=KEYED_SHIFT_ZIPF).compile(
        cluster, seed=KEYED_SHIFT_SEED, utg=keyed)
    probe = RS.StreamExecutor(keyed_etg, cluster, shift)
    r_skew, r_shifted = (P.max_stable_rate(keyed_etg, cluster, skew=probe.skew_model_at(t))[0]
                         for t in (0, W - 1))
    shift = dataclasses.replace(shift, rates=shift.rates * (0.8 * r_skew))
    ops.reset_launches()
    k_res, k_ctl = held_run(RS, np, "keyed skew shift", keyed_etg, cluster, shift,
                            lambda device: RS.OnlineController(keyed, cluster, period=10,
                                                               device=device),
                            n=KEYED_PREFIX)
    shifted = [d for d in k_ctl.ledger if d.trigger == "skew_shift" and d.accepted]
    check(bool(shifted) and shifted[0].window < KEYED_PREFIX and ops.LAUNCHES["sched_scoring"] > 0,
          "the keyed run carried out no skew_shift replan on the card inside the CPU's windows")
    print(f"  keyed skew shift: {len(k_ctl.ledger)} decisions ("
          + ", ".join(f"{d.window}: {d.trigger} {d.outcome}" for d in k_ctl.ledger)
          + f"), {int(k_res.migrations.sum())} instances moved, "
          f"{ops.LAUNCHES['sched_scoring']} B1 launches; {keyed_etg.total_tasks} tasks, skew-aware "
          f"R* {r_skew:.4f} before the shift and {r_shifted:.4f} after it, offered "
          f"{float(shift.rates[0]):.4f}; sustained {k_res.sustained_throughput():.4f}")
    # The oracle on the same keyed run: a skew-aware refine on the card at
    # window 0 and after the shift; the CPU holds its first windows, through
    # its first plan (two full refines, the slow side on the CPU).
    ops.reset_launches()
    o_res, o_ctl = held_run(RS, np, "oracle, keyed skew shift", keyed_etg, cluster, shift,
                            lambda device: RS.OracleRescheduler(keyed, cluster, device=device),
                            n=ORACLE_PREFIX)
    check(ops.LAUNCHES["sched_scoring"] > 0 and int(o_res.migrations[0]) > 0,
          "the oracle's skew-aware refines launched no B1 on the card or planned no move")
    print(f"  oracle, keyed skew shift: {len(o_ctl._cache)} plans, "
          f"{ops.LAUNCHES['sched_scoring']} B1 launches; sustained "
          f"{o_res.sustained_throughput():.4f}")
    wall["runtime_twins_s"] = time.perf_counter() - t_cpu
    ops.sched_scoring_ref = plain_score
    check(not eager, f"the plain scorer ran on the card {eager}")

    # The policy sweep: B = 6 traces x P = 256 placements x W = 240.
    order = [traces[k] for k in SCENARIOS]
    policies = sweep_policies(etg, cluster.n_machines)
    scan_ops.reset_launches()
    t0 = time.perf_counter()
    sweep = RS.evaluate_policies_batch(etg, cluster, order, policies, config=RUNTIME_CONFIG,
                                       device="cuda")
    wall["sweep_s"] = time.perf_counter() - t0
    sweep_launches = scan_ops.LAUNCHES["policy_scan"]
    check(sweep_launches == 1, f"the sweep launched policy_scan {sweep_launches} times, not 1")
    operands, topo, cfg = scan_operands(etg, cluster, order, policies, RUNTIME_CONFIG,
                                        torch.device("cuda"))
    got = scan_ops.policy_scan(*operands, topo, cfg)
    again = scan_ops.policy_scan(*operands, topo, cfg)
    plain = policy_scan_ref(*operands, topo, cfg)
    cpu_operands, _, _ = scan_operands(etg, cluster, order, policies[:8], RUNTIME_CONFIG,
                                       torch.device("cpu"))
    plain_cpu = policy_scan_ref(*cpu_operands, topo, cfg)
    torch.cuda.synchronize()
    err = 0.0
    for field, g_x, a_x, p_x, c_x in zip(got._fields, got, again, plain, plain_cpu):
        check(bool(torch.isfinite(g_x).all()), f"policy_scan {field}: non-finite output")
        check(torch.equal(g_x, a_x), f"policy_scan {field}: rerun differs")
        check(np.array_equal(g_x.cpu().numpy(), getattr(sweep, field)),
              f"policy_scan {field}: differs from the evaluator's result")
        f_err = float((g_x - p_x).abs().max())
        check(f_err <= 1e-12 * max(1.0, float(p_x.abs().max())),
              f"policy_scan {field}: {f_err} from its plain version on the card")
        check(torch.equal(g_x[:, :8].cpu(), c_x),
              f"policy_scan {field}: differs from its plain version on the CPU")
        err = max(err, f_err)
    rng = np.random.default_rng(17)
    comp = etg.task_component()
    worst = 0.0
    for b, p in zip(rng.integers(0, len(order), 8), rng.integers(0, policies.shape[0], 8)):
        pe = P.ExecutionGraph(utg=utg, n_instances=etg.n_instances.copy(),
                              assignment=[policies[p][comp == c] for c in range(utg.n_components)])
        run = RS.StreamExecutor(pe, cluster, order[b], config=RUNTIME_CONFIG).run()
        for field in ("throughput", "admitted", "dropped", "queue_total", "throttle"):
            x, y = getattr(sweep, field)[b, p], getattr(run, field)
            check(np.allclose(x, y, rtol=1e-9, atol=1e-9),
                  f"sweep pair ({b}, {p}) {field} differs from the executor")
            worst = max(worst, float(np.max(np.abs(x - y))))
        check(np.array_equal(sweep.machine_util_mean[b, p], run.machine_util.mean(axis=0)),
              f"sweep pair ({b}, {p}): utilization differs from the executor")
    print(f"  sweep B={len(order)} P={policies.shape[0]} W={W} T={etg.total_tasks}: 1 launch, "
          f"{wall['sweep_s']:.3f} s host to host; max abs err {err:.3e} against the plain version "
          f"on the card, equal to it on the CPU (8 placements), rerun bit-identical; 8 sampled "
          f"pairs within {worst:.3e} of the executor (utilization equal); sustained "
          f"{float(sweep.sustained.min()):.4f}-{float(sweep.sustained.max()):.4f}")

    # [11] timing ------------------------------------------------------------
    print("[11] policy_scan timed at the sweep (CUDA events, cold L2, median of 15; plain "
          "version median of 3)")
    ms = time_cuda(lambda: scan_ops.policy_scan(*operands, topo, cfg))
    plain_ms = time_cuda(lambda: policy_scan_ref(*operands, topo, cfg), reps=3)
    B, P_, T, m = len(order), policies.shape[0], etg.total_tasks, cluster.n_machines
    # The kernel's FP64 operations: about 23 a task and window (arrivals,
    # clip, desired, the machine sums, service, backlog, tcu, the four totals
    # and the maximum), 5 a machine and window, 2 a keyed share.
    flops = B * P_ * W * (23 * T + 5 * m + 2 * topo.n_shares)
    n_bytes = sum(x.numel() * x.element_size() for x in (*operands, *got))
    bound = _bound(flops / FP64_FLOPS_PER_S, n_bytes / HBM_BYTES_PER_S)
    print(f"  policy_scan B={B} P={P_} W={W} T={T} m={m}: {ms:.4f} ms, bound {bound[0]:.4f} ms "
          f"by {bound[1]} ({flops / 1e9:.2f} GFLOP, {n_bytes / 1e6:.2f} MB; "
          f"{100 * bound[0] / ms:.1f}% of it), plain {plain_ms:.3f} ms; no single PyTorch call "
          f"computes it, so library_ms is null")
    n_parents = sum(len(ps) for ps in topo.parents)
    G = scan_ops.pairs_a_block(B, T, m, topo.n_components, len(topo.keyed), n_parents)
    smem = scan_ops.smem_bytes(T, m, topo.n_components, len(topo.keyed), G, n_parents)
    occ = scan_kernel.occupancy(B, P_, G, smem)
    print(f"    {G} pairs (one placement, {G} traces) a block, {occ['threads']} threads, {smem} "
          f"shared bytes; " + _launch_text(torch, flops, occ["blocks"], occ["blocks_per_sm"],
                                           occ["registers"], occ["local_bytes"]))
    # The global-state instance (one pair a block, every warp on it) on the
    # same sweep, picked here by hand: equal to the one-block kernel bit for
    # bit, and timed beside it (whether it could take the one-block
    # kernel's place).
    picks = scan_ops.state_in_global
    scan_ops.state_in_global = lambda *_: True
    try:
        global_out = scan_ops.policy_scan(*operands, topo, cfg)
        wide_ms = time_cuda(lambda: scan_ops.policy_scan(*operands, topo, cfg))
    finally:
        scan_ops.state_in_global = picks
    for field, g_x, w_x in zip(got._fields, got, global_out):
        check(torch.equal(g_x, w_x), f"policy_scan {field}: the global-state instance differs "
              f"from the one-block kernel on the sweep")
    print(f"    the global-state instance on the same sweep: {wide_ms:.4f} ms against the "
          f"one-block kernel's {ms:.4f} ms, equal to it bit for bit")
    return _record("policy_scan", "src/repro_torch/kernels/policy_scan/csrc/policy_scan.cu",
                   "src/repro/runtime_stream/eval_jax.py:214", sweep_launches, err,
                   (err, ms, plain_ms, bound, None))


def plain_on_card(ops, cut_ops):
    """Within the block, every scorer and cut-traffic call runs its plain
    PyTorch version on the tensors it is given (the card's, here): the
    same inputs as the kernels, no launch counted."""
    import contextlib

    from repro_torch.kernels.cut_traffic.ref import cut_traffic_ref
    from repro_torch.kernels.sched_scoring.ref import sched_scoring_ref

    @contextlib.contextmanager
    def swapped():
        kernels = ops.sched_scoring, cut_ops.cut_traffic
        ops.sched_scoring, cut_ops.cut_traffic = sched_scoring_ref, cut_traffic_ref
        try:
            yield
        finally:
            ops.sched_scoring, cut_ops.cut_traffic = kernels

    return swapped()


def same_scores(np, what, got, want):
    """Two ``TenantBatchScorer.score`` results: equal bit for bit."""
    for (r_g, h_g), (r_w, h_w) in zip(got, want):
        check(np.array_equal(r_g, r_w) and np.array_equal(h_g, h_w),
              f"{what}: the kernels differ from their plain versions on the card")


def multitenant_phases(torch, np, P, ops, cut_ops, wall):
    """Phases 12 and 13: multi-tenant scheduling and observability on the
    card, then their timings. Returns the launches of B1, B2 and
    cut_traffic on these paths, and the fleets (tenants, cluster, schedule,
    B1 launches by capacity scale)."""
    import repro_torch.multitenant as MT
    import repro_torch.runtime_stream as RS
    from repro_torch.kernels.sched_scoring.ref import sched_scoring_ref
    from repro_torch.launch.profile_refine import REFINE_KERNELS
    from repro_torch.launch.profile_serve import profile_phase
    from repro_torch.launch.timing import time_cuda
    from repro_torch.obs import TraceRecorder, to_chrome_trace, to_jsonl
    from repro_torch.obs.validate import validate_chrome, validate_jsonl

    launches = {"sched_scoring": 0, "sched_scoring_resources": 0, "cut_traffic": 0}

    def counted():
        return {**ops.LAUNCHES, **cut_ops.LAUNCHES}

    # [12a] the 100-tenant fleet --------------------------------------------
    print("[12] multi-tenant scheduling and observability on the card")
    plain_score, eager = ops.sched_scoring_ref, []

    def counting_score(task_machine, *args, **kwargs):
        if task_machine.is_cuda:
            eager.append(tuple(task_machine.shape))
        return plain_score(task_machine, *args, **kwargs)

    fleets = {}
    ops.sched_scoring_ref = counting_score
    for scale in (1, 4):
        tenants, cluster = mt_fleet(np, P, MT, 100, float(scale))
        ops.reset_launches()
        cut_ops.reset_launches()
        t0 = time.perf_counter()
        ms = MT.schedule_tenants(tenants, cluster, validate=False, device="cuda", **FLEET_KW)
        torch.cuda.synchronize()
        wall[f"fleet_x{scale}_s"] = time.perf_counter() - t0
        n = counted()
        check(n["sched_scoring"] > 0 and n["sched_scoring_resources"] == 0
              and n["cut_traffic"] == 0, f"fleet x{scale}: not on B1 alone ({n})")
        got = fleet_summary(np, ms)
        check(got == MT_FLEET_REF[scale],
              f"fleet x{scale} differs from the reference's: {got} against {MT_FLEET_REF[scale]}")
        launches["sched_scoring"] += n["sched_scoring"]
        fleets[scale] = (tenants, cluster, ms, n["sched_scoring"])
        print(f"  12a fleet x{scale}: 100 tenants, {cluster.n_machines} machines, "
              f"{sum(a.etg.total_tasks for a in ms.allocations)} tasks: {ms.rounds} rounds, "
              f"{ms.candidates_evaluated} candidates, total rate {float(ms.rates.sum())!r}; rates, "
              f"log, instances and placements equal the reference's; {n['sched_scoring']} B1 "
              f"launches, {wall[f'fleet_x{scale}_s']:.3f} s on the card")
    ops.sched_scoring_ref = plain_score
    check(not eager, f"the plain scorer ran on the card {eager[:4]}")

    # [12b] the relocation sweep: one B1 launch, per-row capacity ------------
    tenants, cluster, ms, _ = fleets[1]
    mt = relocation_state(np, P, MT, tenants, cluster, ms)
    sweeps = relocation_sweeps(np, mt)
    scorer = MT.TenantBatchScorer(mt, device="cuda")
    ops.reset_launches()
    cut_ops.reset_launches()
    t0 = time.perf_counter()
    scored = scorer.score(sweeps)
    wall["relocation_sweep_s"] = time.perf_counter() - t0
    n = counted()
    check(n == {"sched_scoring": 1, "sched_scoring_resources": 0, "cut_traffic": 0},
          f"the relocation sweep launched {n}, not one B1")
    launches["sched_scoring"] += 1
    with plain_on_card(ops, cut_ops):
        same_scores(np, "relocation sweep", scored, scorer.score(sweeps))
    got = sweep_summary(np, scored)
    check(got == MT_RELOCATION_REF, f"the relocation sweep differs from the reference's: {got}")
    print(f"  12b relocation sweep: {got['rows']} rows of {scorer.t_max} tasks, m "
          f"{cluster.n_machines}, per-row capacity: 1 B1 launch, equal to its plain version on "
          f"the card and to the reference's rates (md5 {got['rates_md5']}; {got['feasible']} "
          f"feasible, argmax {got['argmax']}); {wall['relocation_sweep_s']:.3f} s host to host")

    # [12c] the resource sweep: one B2 launch, 20 cut_traffic launches -------
    rmt = resource_state(np, P, MT)
    check(rmt.feasible(), "the resource sweep's state is not feasible")
    r_sweeps = relocation_sweeps(np, rmt)
    r_scorer = MT.TenantBatchScorer(rmt, device="cuda")
    ops.reset_launches()
    cut_ops.reset_launches()
    t0 = time.perf_counter()
    r_scored = r_scorer.score(r_sweeps)
    wall["resource_sweep_s"] = time.perf_counter() - t0
    n = counted()
    check(n == {"sched_scoring": 0, "sched_scoring_resources": 1, "cut_traffic": len(r_sweeps)},
          f"the resource sweep launched {n}, not one B2 and {len(r_sweeps)} cut_traffic")
    launches["sched_scoring_resources"] += 1
    launches["cut_traffic"] += len(r_sweeps)
    with plain_on_card(ops, cut_ops):
        same_scores(np, "resource sweep", r_scored, r_scorer.score(r_sweeps))
    got = sweep_summary(np, r_scored)
    check(got == MT_RESOURCE_REF, f"the resource sweep differs from the reference's: {got}")
    r_rates = np.concatenate([r for r, _ in r_scored])
    print(f"  12c resource sweep: {got['rows']} rows of {r_scorer.t_max} tasks, 20 tenants, m "
          f"180, memory and 6 racks: 1 B2 and {n['cut_traffic']} cut_traffic launches, equal to "
          f"their plain versions on the card and to the reference's rates (md5 "
          f"{got['rates_md5']}; {got['feasible']} feasible, argmax {got['argmax']}; rates "
          f"{float(r_rates.min()):.4f}-{float(r_rates.max()):.4f}); "
          f"{wall['resource_sweep_s']:.3f} s host to host")

    # [12d] the multi-tenant runtime with a trace recorder -------------------
    ops.reset_launches()
    cut_ops.reset_launches()
    rec = TraceRecorder(name="mt")
    t0 = time.perf_counter()
    r_ms, res = mt_runtime(np, P, MT, RS, rec, dict(device="cuda"), dict(device="cuda"))
    wall["mt_runtime_s"] = time.perf_counter() - t0
    n = counted()
    jsonl = to_jsonl(rec, strip_wall=True)
    got = runtime_summary(np, r_ms, res, jsonl)
    check(got == MT_RUNTIME_REF, f"the multi-tenant runtime differs from the reference's: {got}")
    check(got["requests"] >= 1, "the arbiter saw no request")
    check(n["sched_scoring"] > 0 and n["sched_scoring_resources"] == 0,
          f"the multi-tenant runtime did not run on B1 ({n})")
    n_rec, errors = validate_jsonl(jsonl)
    n_ev, chrome_errors = validate_chrome(to_chrome_trace(rec))
    check(not errors and not chrome_errors,
          f"the runtime's export fails validation: {(errors + chrome_errors)[:3]}")
    launches["sched_scoring"] += n["sched_scoring"]
    dropped = ", ".join(f"{name} {float(r.dropped.sum()) * r.window_s!r}"
                        for name, r in zip(res.names, res.results))
    print(f"  12d runtime, 3 tenants on 20/30/40, 240 windows: satisfaction "
          f"{[round(s, 4) for s in got['satisfaction']]}, {got['requests']} arbiter requests, "
          f"fingerprints and replan decisions equal the reference's; JSONL ({n_rec} records, "
          f"{n_ev} Chrome events) validates and equals the reference's under the backend-name "
          f"map (md5 {got['jsonl_md5']}); {n['sched_scoring']} B1 launches; dropped tuples: "
          f"{dropped}; {wall['mt_runtime_s']:.3f} s")

    # [13] timings ---------------------------------------------------------------
    print("[13] multi-tenant timings (CUDA events, cold L2, median of 15; plain version median "
          "of 5; host walls median of 9 after a warm-up)")
    sizes = [r.shape[0] for _, r in sweeps]
    operands = scorer._operands(sweeps, sizes)
    tables, index, row_tenant = scorer._dev_tables, operands["index"], operands["row_tenant"]
    g_args = tuple(operands[k] for k in ("tm", "comp", "unit")) + (
        tables["e"], tables["met"], operands["cap"])
    (B, T), m = operands["tm"].shape, cluster.n_machines
    ms_b1 = time_cuda(lambda: ops.sched_scoring(*g_args))
    wrapper_ms = time_cuda(lambda: ops.sched_scoring(*g_args), spin_cycles=0)
    plain_ms = time_cuda(lambda: sched_scoring_ref(*g_args), reps=5)
    n_bytes = sum(x.numel() * x.element_size() for x in g_args) + B * 8
    bound = _bound((B * T * 3 + B * m * 4) / FP64_FLOPS_PER_S, n_bytes / HBM_BYTES_PER_S)
    print(f"  B1 at 12b's shape (B={B} T={T} m={m}, per-row maps and capacity): {ms_b1:.4f} ms "
          f"({wrapper_ms:.4f} ms with the wrapper's host time; bound {bound[0]:.4f} ms by "
          f"{bound[1]}, {n_bytes / 1e6:.1f} MB, {100 * bound[0] / ms_b1:.1f}% of it), plain "
          f"{plain_ms:.3f} ms")

    def host_walls(fn, reps=9):
        fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(walls)

    score_ms = host_walls(lambda: scorer.score(sweeps))
    operands_ms = host_walls(lambda: scorer._operands(sweeps, sizes))
    gather_ms = time_cuda(lambda: tables["cap"].index_select(0, index), spin_cycles=0)
    copy_ms = host_walls(lambda: torch.from_numpy(scorer._resid_cap[row_tenant]).to("cuda"))
    cap_mb = B * m * 8 / 1e6
    print(f"  score() at 12b, host to host: {score_ms:.3f} ms, of it {operands_ms:.3f} ms the "
          f"operands (host rows, their copy, the gathers); the (B, m) capacity gather on the "
          f"card {gather_ms:.4f} ms; a host fill and copy of the same {cap_mb:.1f} MB instead: "
          f"{copy_ms:.3f} ms (not run by the port)")
    # B2 and the 20 cut_traffic launches at 12c's shape.
    r_sizes = [r.shape[0] for _, r in r_sweeps]
    r_ops = r_scorer._operands(r_sweeps, r_sizes)
    r_tables = r_scorer._dev_tables
    b2_args = tuple(r_ops[k] for k in ("tm", "comp", "unit")) + (
        r_tables["e"], r_tables["met"], r_ops["cap"])
    b2_kw = dict(net_var=r_ops["net"], mem_c=r_tables["mem"], mem_capacity=r_ops["memcap"])
    ms_b2 = time_cuda(lambda: ops.sched_scoring(*b2_args, **b2_kw))
    plain_b2 = time_cuda(lambda: sched_scoring_ref(*b2_args, **b2_kw), reps=5)
    ms_cut = time_cuda(lambda: r_scorer._net_var(r_sweeps, r_sizes, r_ops["tm"]))
    rB, rT = r_ops["tm"].shape
    b2_bytes = sum(x.numel() * x.element_size() for x in (*b2_args, *b2_kw.values())) + rB * 8
    b2_bound = _bound((rB * rT * 3 + rB * 180 * 4) / FP64_FLOPS_PER_S, b2_bytes / HBM_BYTES_PER_S)
    print(f"  B2 at 12c's shape (B={rB} T={rT} m=180, memory, network, per-row capacity): "
          f"{ms_b2:.4f} ms (bound {b2_bound[0]:.4f} ms by {b2_bound[1]}), plain {plain_b2:.3f} ms; "
          f"its 20 cut_traffic launches and their concatenation together {ms_cut:.4f} ms")
    # The fleets' walls on the card, profiled.
    for scale in (1, 4):
        tenants, cluster, _ms, n_b1 = fleets[scale]
        prof = profile_phase(lambda: MT.schedule_tenants(tenants, cluster, validate=False,
                                                         device="cuda", **FLEET_KW),
                             top=4, kernels=REFINE_KERNELS)
        b1_ms = prof["port_kernels"]["sched_scoring"]["device_ms"]
        print(f"  fleet x{scale}: wall {wall[f'fleet_x{scale}_s']:.3f} s unprofiled, {n_b1} B1 "
              f"launches; profiled {prof['wall_s']:.3f} s, device busy "
              f"{prof['device_busy_s']:.4f} s ({100 * prof['busy_share']:.2f}%) over "
              f"{prof['launches']} activities, B1 {b1_ms:.3f} ms; top: "
              + ", ".join(f"{t['name'][:40]} {t['device_ms']:.2f} ms x{t['calls']}"
                          for t in prof["top"]))
    return launches, fleets


def paper_phase(torch, ops, cut_ops, fleets, wall, smi):
    """Phase 14: the paper's reproduction (``repro_torch.paper_repro``'s
    sections) and the other benchmarks (``repro_torch.paper``) on the
    card, each row's derived columns equal to the same benchmark's on the CPU
    and to the reference's (``PAPER_REF``). Returns each kernel's launches."""
    import contextlib
    import io

    from repro_torch import paper_repro
    from repro_torch.kernels.cut_traffic.ref import cut_traffic_ref
    from repro_torch.kernels.policy_scan import ops as scan_ops
    from repro_torch.kernels.policy_scan.ref import policy_scan_ref
    from repro_torch.kernels.sched_scoring.ref import sched_scoring_ref
    from repro_torch.paper import dispatch, multitenant, netaware, refine_speed, runtime
    from repro_torch.paper.common import comparable, fields

    print(f"[14] the paper's reproduction and the other benchmarks on the card; {smi}")
    counters = (ops, cut_ops, scan_ops)

    def quiet(fn):
        """The rows ``fn`` returns; what the benchmarks print is printed here
        once, indented, for the card's run only."""
        with contextlib.redirect_stdout(io.StringIO()):
            return fn()

    def mt_card():
        by_scale = {4.0: "roomy_90x400", 1.0: "paper_90x100"}
        rows = []
        for _n, _counts, cap_scale, label in multitenant.SCALE_ROWS:
            check(by_scale[cap_scale] == label, f"scale row {label} is not phase 12's fleet")
            tenants, cluster, ms, _ = fleets[int(cap_scale)]
            rows.append(multitenant.emit_scale(multitenant.scale_row(
                label, tenants, cluster, ms, wall[f"fleet_x{int(cap_scale)}_s"], "cuda")))
        rows.append(multitenant.emit_batching(multitenant.batching_row(device="cuda")))
        return rows + [multitenant.emit_runtime(multitenant.runtime_row("cuda"))]

    def mt_cpu():
        return [multitenant.emit_batching(multitenant.batching_row(device="cpu")),
                multitenant.emit_runtime(multitenant.runtime_row("cpu"))]

    # (title, benchmark, the card's rows, the CPU's rows). The CPU holds every
    # row but the 100-tenant scale rows (phase 12 held those fleets against
    # the reference's, and each takes seconds on the CPU), the parity and
    # overhead rows (the parity row compares the card with the CPU itself;
    # the overhead rows time the recorder on the card) and the dispatch rows
    # (their run on the card times the CPU on the same grid).
    sections = [(title, benchmark, lambda d=benchmark: d.main("cuda"), lambda d=benchmark: d.main("cpu"))
                for title, benchmark in paper_repro.SECTIONS]
    sections += [
        ("Network-aware placement", netaware, lambda: netaware.main("cuda"),
         lambda: netaware.main("cpu")),
        ("Refine / optimal walls", refine_speed, lambda: refine_speed.main("cuda"),
         lambda: refine_speed.main("cpu")),
        ("Online runtime", runtime, lambda: runtime.main("cuda"),
         lambda: runtime.scenario_rows("cpu")[1]),
        ("Multi-tenant scheduling", multitenant, mt_card, mt_cpu),
        ("Dispatch points, CPU against the card", dispatch, lambda: dispatch.main("cuda"), None),
    ]

    plain = ops.sched_scoring_ref, cut_ops.cut_traffic_ref, scan_ops.policy_scan_ref
    eager = []

    def counting(fn):
        def wrapped(*args, **kwargs):
            if args[0].is_cuda:
                eager.append(fn.__name__)
            return fn(*args, **kwargs)
        return wrapped

    total = {"sched_scoring": 0, "sched_scoring_resources": 0, "cut_traffic": 0,
             "policy_scan": 0}
    t_phase = time.perf_counter()
    n_rows = n_cpu = 0
    for title, benchmark, card_fn, cpu_fn in sections:
        key = benchmark.__name__.rsplit(".", 1)[1]
        for c in counters:
            c.reset_launches()
        ops.sched_scoring_ref, cut_ops.cut_traffic_ref, scan_ops.policy_scan_ref = (
            counting(sched_scoring_ref), counting(cut_traffic_ref), counting(policy_scan_ref))
        t0 = time.perf_counter()
        card = quiet(card_fn)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        ops.sched_scoring_ref, cut_ops.cut_traffic_ref, scan_ops.policy_scan_ref = plain
        n = {**ops.LAUNCHES, **cut_ops.LAUNCHES, **scan_ops.LAUNCHES}
        for k in total:
            total[k] += n[k]
        t0 = time.perf_counter()
        cpu = quiet(cpu_fn) if cpu_fn else []
        t_cpu = time.perf_counter() - t0
        wall[f"paper_{key}_s"] = t_card
        print(f"  # -- {title} -- launches B1 {n['sched_scoring']}, B2 "
              f"{n['sched_scoring_resources']}, cut_traffic {n['cut_traffic']}, policy_scan "
              f"{n['policy_scan']}; card {t_card:.3f} s, cpu {t_cpu:.3f} s")
        for name, us, derived in card:
            print(f"  {name},{us:.1f},{derived}")
        ours = {name: comparable(d, benchmark.MEASURED) for name, _us, d in card}
        check(len(ours) == len(card) and ours == PAPER_REF[key],
              f"{key}: the card's rows differ from the reference's: "
              f"{ {k: v for k, v in ours.items() if PAPER_REF[key].get(k) != v} }")
        for name, _us, d in cpu:
            check(comparable(d, benchmark.MEASURED) == ours[name],
                  f"{name}: the card's row differs from the CPU's: {ours[name]} against {d}")
        n_rows += len(card)
        n_cpu += len(cpu)
        if key == "sched_speed":
            rel = float(fields(dict((r[0], r[2]) for r in card)["sim_batch_backends"])[
                "cuda_vs_cpu_max_rel"])
            check(rel <= 1e-9, f"simulate_batch on the card differs from the CPU by {rel}")
    check(not eager, f"a plain version ran on the card: {sorted(set(eager))}")
    wall["phase_14_s"] = time.perf_counter() - t_phase
    for k, v in total.items():
        check(v > 0, f"phase 14 launched no {k} kernel")
    print(f"  {n_rows} rows equal the reference's, {n_cpu} of them also the CPU's run in this "
          f"process (exact strings; the simulator within 1e-9, the network term within "
          f"1e-12); no plain version on the card; launches {total}; phase 14 "
          f"{wall['phase_14_s']:.3f} s")
    return total


# Phase 15's checks: the routed expert ids of the card and the CPU agree
# wherever the top-k margin (the least gap between consecutive sorted
# probabilities down to the (k+1)-th) exceeds ROUTE_MARGIN; the float32 card
# and CPU logits within MOE_REL of their max-abs (float32 on both sides,
# only the order of sums differs: 1e-3 leaves room for 2 layers of d_model
# 1024); DeepSeek's decode steps within MLA_REL of a teacher-forced prefill
# (the same arithmetic in float32, the latent read back from the cache).
ROUTE_MARGIN = 1e-4
MOE_REL = 1e-3
MLA_REL = 1e-4


class RoutingTap:
    """While open, wraps ``models.moe._route``: records each call's expert
    ids and top-k margin, by device, in call order. With ``force``, the
    CPU's i-th call takes the card's i-th call's ids (its gates the CPU's
    own probabilities at those ids, renormalised): the CPU run is then
    teacher-forced on the card's routing, as it is on the card's tokens,
    and ``flips`` counts the tokens whose own choice differed."""

    def __init__(self, torch, moe, force=False):
        self.torch, self.moe, self.force = torch, moe, force
        self.card, self.cpu, self.flips = [], [], 0

    def __enter__(self):
        self.real = self.moe._route
        self.moe._route = self.route
        return self

    def __exit__(self, *exc):
        self.moe._route = self.real

    def route(self, tokens, router_w, k):
        torch = self.torch
        probs = torch.softmax(tokens.float() @ router_w, dim=-1)
        top = probs.sort(dim=-1, descending=True, stable=True).values[:, :k + 1]
        margin = (top[:, :-1] - top[:, 1:]).amin(dim=-1)
        gates, ids, aux = self.real(tokens, router_w, k)
        if tokens.is_cuda:
            self.card.append((ids.cpu(), margin.cpu()))
            return gates, ids, aux
        self.cpu.append((ids, margin))
        if self.force:
            card_ids = self.card[len(self.cpu) - 1][0]
            self.flips += int((card_ids != ids).any(dim=-1).sum())
            g = probs.gather(1, card_ids)
            return g / g.sum(-1, keepdim=True).clamp_min(1e-9), card_ids, aux
        return gates, ids, aux

    def compare(self):
        """(choices compared, tokens under the margin): the card's ids equal
        the CPU's at every token whose CPU margin exceeds ROUTE_MARGIN."""
        torch = self.torch
        check(len(self.card) == len(self.cpu) > 0, "routing calls differ between card and CPU")
        compared, near = 0, 0
        for (cid, _), (pid, margin) in zip(self.card, self.cpu):
            clear = margin > ROUTE_MARGIN
            check(torch.equal(cid[clear], pid[clear]),
                  f"routed expert ids differ at {int((cid != pid).any(-1)[clear].sum())} "
                  f"tokens with a top-k margin over {ROUTE_MARGIN}")
            compared += int(clear.sum()) * cid.shape[1]
            near += int((~clear).sum())
        return compared, near


class PlainOnCard:
    """While open, counts calls of the attention kernels' plain versions on
    CUDA tensors through their wrappers (there must be none), and of each
    further plain version named by its (module, attribute) in ``extra``."""

    def __init__(self, flash_ops, decode_ops, *extra):
        self.targets = ((flash_ops, "flash_attention_ref"), (decode_ops, "decode_attention_ref"),
                        *extra)
        self.calls = 0

    def __enter__(self):
        self.real = [getattr(mod, name) for mod, name in self.targets]
        for (mod, name), fn in zip(self.targets, self.real):
            setattr(mod, name, self.counting(fn))
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in zip(self.targets, self.real):
            setattr(mod, name, fn)

    def counting(self, fn):
        def run(*args, **kwargs):
            self.calls += any(getattr(a, "is_cuda", False) for a in args)
            return fn(*args, **kwargs)
        return run


def _to_float32_in_place(tree) -> None:
    """Every leaf of ``tree`` cast to float32 in its container, the largest
    first, each bf16 original freed as it goes: the peak stays near the
    float32 tree's size."""
    slots = []

    def walk(node):
        items = node.items() if isinstance(node, dict) else enumerate(node)
        for key, v in list(items):
            if isinstance(v, (dict, list)):
                walk(v)
            else:
                slots.append((v.numel(), node, key))

    walk(tree)
    for _n, node, key in sorted(slots, key=lambda s: -s[0]):
        node[key] = node[key].float()


def moe_phase(torch, F, M, serve, flash_ops, decode_ops, scan_ops, flash_ref, decode_ref,
              wall, smi):
    """Phase 15: the MoE family. Returns {kernel: (granite's launches,
    timing at granite's shapes)}."""
    from repro_torch.configs import get_config
    from repro_torch.launch.profile_serve import profile_phase, stages
    from repro_torch.models import moe

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    lm_ops = (flash_ops, decode_ops, scan_ops)
    print(f"[15] the MoE family: granite-moe-1b-a400m at full width and depth, "
          f"deepseek-v3-671b at full width, 4 layers; {smi}")

    # (a) granite at full width and depth, bf16 -------------------------------
    cfg = get_config("granite-moe-1b-a400m")
    params = M.init_params(cfg, seed=0, device="cuda")
    B, P, G = 8, 512, 64
    with PlainOnCard(flash_ops, decode_ops) as plain:
        launches = serve_run(torch, lm_ops, M, serve, cfg, params, B, P, G,
                             dict(flash_attention=cfg.n_layers,
                                  decode_attention=cfg.n_layers * (G - 1), rglru_scan=0, rglru_scan_bwd=0), wall)
    check(plain.calls == 0, f"a plain attention version ran on the card {plain.calls} times")
    print("  no plain attention version ran on the card")
    prompt = torch.randint(0, cfg.vocab_size, (B, P), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    with RoutingTap(torch, moe) as tap:
        M.prefill(params, cfg, {"tokens": prompt}, M.init_caches(cfg, B, P, device="cuda"),
                  device="cuda")
    C = moe.capacity(cfg, B * P)
    dropped = [int((~moe._slot_tables(ids, cfg.n_experts, C)[2]).sum()) for ids, _ in tap.card]
    print(f"  prefill routing: capacity {C} slots an expert for {B * P} tokens x top-"
          f"{cfg.top_k} of {cfg.n_experts}; choices dropped {sum(dropped)} of "
          f"{len(dropped) * B * P * cfg.top_k} over {len(dropped)} layers (per layer "
          f"{min(dropped)}-{max(dropped)})")

    # Where granite's decode step spends the card's time.
    steps = 8
    state = {}

    def prefill():
        caches = M.init_caches(cfg, B, P + steps + 1, device="cuda")
        logits, state["caches"] = M.prefill(params, cfg, {"tokens": prompt}, caches,
                                            device="cuda")
        state["tok"] = logits.argmax(-1)[:, None]

    prefill()

    def decode():
        for _ in range(steps):
            out, state["caches"] = M.decode_step(params, cfg, {"tokens": state["tok"]},
                                                 state["caches"], device="cuda")
            state["tok"] = out.argmax(-1)[:, None]

    with stages():
        prof = profile_phase(decode, again=prefill)
    busy_ms = prof["device_busy_s"] * 1e3
    print(f"  decode profile, {steps} steps at {B} requests: wall {prof['wall_s'] * 1e3 / steps:.3f} "
          f"ms/step, device busy {busy_ms / steps:.3f} ms/step ({100 * prof['busy_share']:.1f}%), "
          f"{prof['launches'] / steps:.0f} device activities a step")
    print("  MoE stages, device ms a step (share of device busy): " + ", ".join(
        f"{k.removeprefix('moe.')} {v / steps:.4f} ({100 * v / busy_ms:.1f}%)"
        for k, v in sorted(prof["stages_ms"].items())))
    for row in prof["top"]:
        print(f"    {row['device_ms'] / steps:9.4f} ms/step x{row['calls'] // steps:<5} "
              f"{row['name']}")

    # (b) its first 2 layers in float32, card against CPU ---------------------
    cut, cut_params = first_layers(M, cfg, params, 2)
    cut32 = dataclasses.replace(cut, dtype="float32", param_dtype="float32")
    card32 = _map_leaves(cut_params, lambda t: t.float())
    cpu32 = _map_leaves(cut_params, lambda t: t.float().cpu())
    Bc, Pc, n = 2, 128, 8
    prompt_c = torch.randint(0, cfg.vocab_size, (Bc, Pc), generator=torch.Generator().manual_seed(2))
    t0 = time.perf_counter()
    with RoutingTap(torch, moe) as tap:
        card_c = M.init_caches(cut32, Bc, Pc + n, device="cuda")
        cpu_c = M.init_caches(cut32, Bc, Pc + n, device="cpu")
        card_l, card_c = M.prefill(card32, cut32, {"tokens": prompt_c}, card_c, device="cuda")
        cpu_l, cpu_c = M.prefill(cpu32, cut32, {"tokens": prompt_c}, cpu_c, device="cpu")
        worst = 0.0
        for step in range(n + 1):
            got = card_l.cpu()
            rel = float((got - cpu_l).abs().max() / cpu_l.abs().max())
            worst = max(worst, rel)
            check(rel <= MOE_REL, f"granite 2 layers float32, step {step}: card vs CPU logits "
                                  f"differ by {rel:.3e} of their max-abs, over {MOE_REL}")
            tok = got.argmax(-1)
            check(torch.equal(tok, cpu_l.argmax(-1)), f"granite 2 layers float32, step {step}: "
                                                      "argmax differs")
            if step < n:
                card_l, card_c = M.decode_step(card32, cut32, {"tokens": tok[:, None]}, card_c,
                                               device="cuda")
                cpu_l, cpu_c = M.decode_step(cpu32, cut32, {"tokens": tok[:, None]}, cpu_c,
                                             device="cpu")
    compared, near = tap.compare()
    print(f"  first 2 layers in float32 (TF32 off), {Bc} x {Pc} prompt + {n} steps, card vs "
          f"CPU fed the card's tokens: logits within {worst:.3e} of their max-abs (<= {MOE_REL}), "
          f"argmax equal at every step; {compared} routed choices equal, {near} (token, layer) "
          f"pairs under the top-k margin {ROUTE_MARGIN} not compared")
    del card32, cpu32, card_c, cpu_c
    # The full depth in bf16 against float32 on the CPU, as phase 8; the CPU
    # takes the card's expert choices as it takes the card's tokens.
    with RoutingTap(torch, moe, force=True) as tap:
        cpu_check(torch, M, cfg, params, Bc, Pc, n)
    print(f"  (CPU teacher-forced on the card's routing: the CPU's own top-{cfg.top_k} differed "
          f"at {tap.flips} of {sum(ids.shape[0] for ids, _ in tap.cpu)} (token, layer) pairs)")
    wall["granite_cpu_check_s"] = time.perf_counter() - t0

    # (d) B3 and B4 at granite's serving shapes --------------------------------
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    timings = {
        "flash_attention": (launches["flash_attention"],
                            time_flash(torch, F, flash_ops, flash_ref, B, P, H, Hkv, D, 0)),
        # The last decode step: 512 + 63 tokens cached of 576 slots.
        "decode_attention": (launches["decode_attention"],
                             time_decode(torch, F, decode_ops, decode_ref, B, H, Hkv, P + G,
                                         P + G - 1, D)),
    }
    del params, state, prof
    torch.cuda.empty_cache()

    # (c) deepseek-v3-671b at full width, 4 layers, bf16 -----------------------
    ds = dataclasses.replace(get_config("deepseek-v3-671b"), n_layers=4)
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(ds, seed=0, device="cuda")
    Bd, Pd, Gd = 4, 256, 16
    serve_run(torch, lm_ops, M, serve, ds, params, Bd, Pd, Gd,
              dict(flash_attention=0, decode_attention=0, rglru_scan=0, rglru_scan_bwd=0), wall)
    peak = torch.cuda.max_memory_allocated()
    latent_bytes = Bd * (Pd + Gd) * (ds.kv_lora_rank + ds.qk_rope_dim) * 2
    mha_bytes = Bd * (Pd + Gd) * ds.n_heads * (ds.qk_nope_dim + ds.qk_rope_dim + ds.v_head_dim) * 2
    print(f"  {ds.n_layers} of {get_config('deepseek-v3-671b').n_layers} layers ({ds.n_dense_layers} dense, {ds.n_layers - ds.n_dense_layers}"
          f" MoE of {ds.n_experts} routed + {ds.n_shared_experts} shared, top-{ds.top_k}); the MTP "
          f"head's {sum(t.numel() for t in _leaves(params['mtp'])) / 1e6:.1f} M parameters carried, "
          f"not run")
    print(f"  MLA cache: {latent_bytes:,} bytes a layer for {Bd} x {Pd + Gd} positions (latent "
          f"{ds.kv_lora_rank} + rope {ds.qk_rope_dim}, bf16; expanded per-head K/V would take "
          f"{mha_bytes:,}); peak memory {peak / 2 ** 30:.2f} GiB")
    # The same model in float32 (TF32 off): every decode step against a
    # teacher-forced prefill. The capacity factor E / k drops no choice at
    # either length, so that the two compute the same function (at 1.25 a
    # prefill drops choices that one-token decode steps keep).
    _to_float32_in_place(params)
    torch.cuda.empty_cache()
    ds32 = dataclasses.replace(ds, dtype="float32", param_dtype="float32",
                               capacity_factor=ds.n_experts / ds.top_k)
    Bf, Pf, nf = 2, 64, 8
    tokens = torch.randint(0, ds.vocab_size, (Bf, Pf), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(3))
    caches = M.init_caches(ds32, Bf, Pf + nf, device="cuda")
    logits, caches = M.prefill(params, ds32, {"tokens": tokens}, caches, device="cuda")
    worst = 0.0
    for step in range(nf):
        tokens = torch.cat([tokens, logits.argmax(-1)[:, None]], dim=1)
        logits, caches = M.decode_step(params, ds32, {"tokens": tokens[:, -1:]}, caches,
                                       device="cuda")
        want, _ = M.prefill(params, ds32, {"tokens": tokens},
                            M.init_caches(ds32, Bf, tokens.shape[1], device="cuda"),
                            device="cuda")
        check(bool(torch.isfinite(logits).all()), f"deepseek float32 step {step}: non-finite")
        rel = float((logits - want).abs().max() / want.abs().max())
        worst = max(worst, rel)
        check(rel <= MLA_REL, f"deepseek float32 step {step}: decode vs teacher-forced prefill "
                              f"differ by {rel:.3e} of their max-abs, over {MLA_REL}")
    print(f"  float32 (TF32 off), capacity factor {ds32.capacity_factor:g}: {nf} decode steps "
          f"from a {Bf} x {Pf} prefill each within {worst:.3e} of a teacher-forced prefill's "
          f"logits (<= {MLA_REL} of their max-abs); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    del params, caches, logits, want
    torch.cuda.empty_cache()
    wall["phase_15_s"] = time.perf_counter() - t_phase
    print(f"  phase 15 {wall['phase_15_s']:.3f} s")
    return timings


# Phase 16's checks: the float32 card and CPU logits of the full-depth
# xLSTM and Whisper within F32_REL of their max-abs (float32 on both sides,
# TF32 off, only the order of sums differs: 1e-3, as phase 15's MOE_REL).
F32_REL = 1e-3


def float32_check(torch, M, cfg, params, Bc, Pc, steps, what, frames=None, image=None) -> float:
    """The same weights in float32 on the card (TF32 off) and on the CPU,
    the CPU fed the card's tokens: logits within ``F32_REL`` of their
    max-abs and argmax equal at every step. Returns the worst share."""
    cfg32 = _float32(cfg)
    card = (cfg32, _map_leaves(params, lambda t: t.float()))
    cpu = (cfg32, _map_leaves(params, lambda t: t.float().cpu()))
    worst = 0.0
    for step, got, want in lockstep(torch, M, card, cpu, Bc, Pc, steps, frames, image):
        rel = float((got - want).abs().max() / want.abs().max())
        worst = max(worst, rel)
        check(rel <= F32_REL, f"{what} float32, step {step}: card vs CPU logits differ by "
                              f"{rel:.3e} of their max-abs, over {F32_REL}")
        check(torch.equal(got.argmax(-1), want.argmax(-1)),
              f"{what} float32, step {step}: argmax differs")
    print(f"  {what} in float32 (TF32 off), {Bc} x {Pc} prompt + {steps} steps, card vs CPU fed "
          f"the card's tokens: logits within {worst:.3e} of their max-abs (<= {F32_REL}), "
          f"argmax equal at every step")
    return worst


def profiled_serve(torch, M, cfg, params, B, P, steps, names, frames=None, first=None,
                   step_x=None):
    """One prefill (an encoder-decoder's encoder included) and ``steps``
    decode steps at full width under the profiler, each labelled stage
    (``profile_serve.STAGES``) in its own range; prints the walls, device
    busy, the device ms of ``names`` and of the port's kernels and the top
    kernels of each. The prefill takes ``first`` (random tokens by default), decode step i also
    ``step_x(i)``. Returns the prefill's and the decode steps' records."""
    from repro_torch.launch.profile_serve import profile_phase, stages

    if first is None:
        first = {"tokens": torch.randint(0, cfg.vocab_size, (B, P), device="cuda",
                                         generator=torch.Generator(device="cuda").manual_seed(1))}
    state = {"extra": {}}

    def prefill():
        if frames is not None:
            state["extra"] = {"encoder_out": M.encode(params, cfg, frames)}
        caches = M.init_caches(cfg, B, P + steps, device="cuda")
        logits, state["caches"] = M.prefill(params, cfg, {**first, **state["extra"]},
                                            caches, device="cuda")
        state["tok"] = logits.argmax(-1)[:, None]

    def decode():
        for i in range(steps):
            out, state["caches"] = M.decode_step(
                params, cfg, {"tokens": state["tok"], **state["extra"],
                              **(step_x(i) if step_x else {})}, state["caches"], device="cuda")
            state["tok"] = out.argmax(-1)[:, None]

    with stages():
        profs = (("prefill", profile_phase(prefill), 1),
                 (f"decode, {steps} steps", profile_phase(decode, again=prefill), steps))
    for what, prof, per in profs:
        unit = "" if per == 1 else " a step"
        busy_ms = prof["device_busy_s"] * 1e3
        print(f"  {what} profiled at {B} requests: wall {prof['wall_s'] * 1e3 / per:.3f} ms{unit}, "
              f"device busy {busy_ms / per:.3f} ms{unit} ({100 * prof['busy_share']:.1f}%), "
              f"{prof['launches'] / per:.0f} device activities{unit}")
        seen = [n for n in names if n in prof["stages_ms"]]
        if seen:
            print(f"    stages, device ms{unit} (share of device busy): " + ", ".join(
                f"{n} {prof['stages_ms'][n] / per:.4f} "
                f"({100 * prof['stages_ms'][n] / busy_ms:.1f}%)" for n in seen))
        ran = {k: v for k, v in prof["port_kernels"].items() if v["calls"]}
        if ran:
            print(f"    port kernels, device ms{unit} (share of device busy): " + ", ".join(
                f"{k} {v['device_ms'] / per:.4f} x{v['calls'] // per} "
                f"({100 * v['device_ms'] / busy_ms:.1f}%)" for k, v in ran.items()))
        for row in prof["top"][:5]:
            print(f"    {row['device_ms'] / per:9.4f} ms{unit} x{row['calls'] // per:<6} "
                  f"{row['name']}")
    return profs[0][1], profs[1][1]


# Phase 16's sLSTM kernel against its plain version, in both layouts: atol =
# rtol = SLSTM_TOL (B5's), as its dot products sum in another order than
# cuBLAS (the update itself rounds as the plain version's); the shapes past
# the serving one (SLSTM_EDGES, (label, B, S, d)): a ragged column group or
# slice, rows past one staging tile, k past one chunk with rw read from
# global memory (d 4100: past the cluster layout, which refuses it by name),
# one feature, 9 rows (two a cluster), rows past the resident clusters, the
# last d the cluster layout holds and the first it does not. SLSTM_STEPS: the
# short calls where both layouts are timed, around the plan's
# CLUSTER_MIN_STEPS.
SLSTM_TOL = 1e-5
SLSTM_EDGES = (("a ragged column group or slice", 3, 7, 100),
               ("rows past a staging tile", 130, 3, 64),
               ("k past one chunk, rw in global memory", 2, 3, 4100), ("one feature", 1, 2, 1),
               ("9 rows", 9, 5, 768), ("rows past the resident clusters", 130, 3, 768),
               ("the widest d a cluster holds", 2, 3, 768),
               ("a feature past the cluster layout", 2, 3, 769))
SLSTM_STEPS = (1, 2, 3, 4)


def slstm_inputs(torch, gen, B, S, d, rw=None, state=None):
    """The kernel's arguments on the card, float32: gate pre-activations
    N(0, 1), the recurrent matrix ``rw`` or one drawn N(0, 1/d) (as
    ``init_dense`` draws r_z), and the entering state ``state`` (c, n, h, m)
    or a fresh one (zeros, m at -1e30)."""
    gates = [torch.randn(B, S, d, device="cuda", generator=gen) for _ in range(4)]
    if rw is None:
        rw = torch.randn(d, d, device="cuda", generator=gen) * d ** -0.5
    if state is None:
        state = (*(torch.zeros(B, d, device="cuda") for _ in range(3)),
                 torch.full((B, d), -1e30, device="cuda"))
    return (*gates, rw, *state)


def slstm_error(torch, what, got, want) -> float:
    """The kernel's (hs, c, n, h, m) against the plain version's: each
    within ``SLSTM_TOL``, NaN where the plain version has NaN. Returns the
    max abs error over the finite entries."""
    err = 0.0
    for name, g, w in zip(("hs", "c", "n", "h", "m"), got, want):
        check(g.shape == w.shape and torch.equal(torch.isnan(g), torch.isnan(w)),
              f"{what}: {name}'s shape or NaNs differ from the plain version's")
        both = torch.isfinite(g) & torch.isfinite(w)
        diff = float((g - w)[both].abs().max()) if both.any() else 0.0
        check(torch.allclose(g, w, atol=SLSTM_TOL, rtol=SLSTM_TOL, equal_nan=True),
              f"{what}: {name} differs from the plain version by {diff:.3e} (atol = rtol = "
              f"{SLSTM_TOL})")
        err = max(err, diff)
    return err


def time_slstm(torch, slstm_ops, slstm_ref, args, what, layout, plain_ms=None):
    """The sLSTM kernel on ``args`` in ``layout``: against its plain version,
    then timed as ``time_scan`` times B5, with its serial floor (the same
    launch without the arithmetic: the grid-wide barriers of the cooperative
    layout, the h exchange of the cluster layout) and without a library call
    (no single PyTorch call computes the recurrence). The plain version is
    timed unless ``plain_ms`` is given. Returns (err, ms, plain_ms, bound,
    None, floor_ms)."""
    from repro_torch.launch.timing import time_cuda

    B, S, d = args[0].shape
    err = slstm_error(torch, f"{what} ({layout} layout)",
                      slstm_ops.slstm_scan(*args, layout=layout), slstm_ref(*args))
    ms = time_cuda(lambda: slstm_ops.slstm_scan(*args, layout=layout))
    floor_ms = time_cuda(lambda: slstm_ops.serial_floor(*args, layout=layout))
    if plain_ms is None:
        plain_ms = time_cuda(lambda: slstm_ref(*args), reps=3 if S > 1 else 5)
    n_bytes = 5 * B * S * d * 4 + d * d * 4 + 8 * B * d * 4  # 4 gates, hs; rw; state in, out
    flops = 2 * B * S * d * d  # h_{t-1} @ rw every step
    bound = _bound(flops / FP32_FLOPS_PER_S, n_bytes / HBM_BYTES_PER_S)
    print(f"  slstm_scan {what} B={B} S={S} d={d} float32, {layout} layout: {ms:.4f} ms, bound "
          f"{bound[0]:.4f} ms by {bound[1]} ({flops / 1e9:.3f} GFLOP, {n_bytes / 1e6:.2f} MB; "
          f"{100 * bound[0] / ms:.1f}% of it), serial floor {floor_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms; library_ms null; max abs error {err:.3e}")
    return err, ms, plain_ms, bound, None, floor_ms


def each_layout(torch, slstm_ops, label, d, run, error):
    """``run(layout)`` (a kernel call that returns a tuple of tensors) in
    each of ``slstm_ops.LAYOUTS``: the cluster layout refusing d past it by
    name, every other call run twice and equal bit for bit, then held by
    ``error(what, got)``. Returns (the largest error, what each layout
    did)."""
    err, took = 0.0, []
    for layout in slstm_ops.LAYOUTS:
        if layout == "cluster" and slstm_ops.cluster_size(d) is None:
            try:
                run(layout)
            except ValueError as e:
                check("cluster layout cannot take" in str(e), f"{label}: refused as {e}")
                took.append("cluster refuses it by name")
                continue
            check(False, f"{label}: the cluster layout took d = {d}")
        got, again = run(layout), run(layout)
        check(all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                  for x, y in zip(got, again)), f"{label} ({layout} layout): a rerun differs")
        err = max(err, error(f"{label} ({layout} layout)", got))
        took.append(layout)
    return err, took


def slstm_checks(torch, B, S, d):
    """Phase 16 (a'): the sLSTM kernel against its plain version on the
    card in both layouts at xlstm-125m's shapes, from a fresh state and from
    the state a prompt left, at ``SLSTM_EDGES`` and with a NaN in one gate;
    both timed at the prefill's and a decode step's shape with their serial
    floors, and at ``SLSTM_STEPS``; the plan's layout checked the faster at
    the prefill and a decode step. Returns (max abs error, {layout: (prefill
    timing, decode timing)}, the plan's layout at the prefill, at a decode
    step)."""
    from repro_torch.kernels.slstm_scan import kernel as slstm_kernel
    from repro_torch.kernels.slstm_scan import ops as slstm_ops
    from repro_torch.kernels.slstm_scan.ref import slstm_scan_ref
    from repro_torch.launch.timing import time_cuda

    gen = torch.Generator(device="cuda").manual_seed(16)
    fresh = slstm_inputs(torch, gen, B, S, d)
    rw = fresh[4]
    left = slstm_scan_ref(*fresh)[1:]  # the state the prompt left
    step = slstm_inputs(torch, gen, B, 1, d, rw, left)
    attrs = slstm_kernel.device_attributes()
    dev = slstm_ops.device()
    print(f"  slstm_scan device: {attrs['sms']} SMs, {attrs['smem_optin']} opt-in shared bytes a "
          f"block, cooperative launch {attrs['cooperative_launch']}, cluster launch "
          f"{attrs['cluster_launch']}; resident clusters of C = 1..{len(dev.active_clusters)} "
          f"blocks: {list(dev.active_clusters)}")
    coop = slstm_kernel.launch_plan(B, d)
    print(f"  slstm_scan cooperative layout at B={B} d={d}: {coop['grid']} blocks of 256 threads, "
          f"all resident ({coop['blocks_per_sm']} a SM), {coop['groups_per_block']} group(s) of 8 "
          f"columns a block, rw {'in shared memory' if coop['rw_resident'] else 'in global memory'}"
          f", h staged {coop['rows']} rows x {coop['chunk']}, {coop['smem_bytes']} shared bytes; "
          f"{coop['registers']} registers, {coop['local_bytes']} local (spilled) bytes a thread")
    clu = slstm_ops.plan(B, S, d, dev, "cluster")
    print(f"  slstm_scan cluster layout at B={B} d={d}: {clu['clusters']} clusters of C = "
          f"{clu['C']} blocks of 384 threads ({clu['active_clusters']} resident at once, "
          f"{clu['waves']} wave(s)), R = {clu['R']} rows a cluster, {clu['width']} columns a block "
          f"(rw in registers), {clu['smem_bytes']} shared bytes; {attrs['registers']} registers, "
          f"{attrs['local_bytes']} local (spilled) bytes a thread")
    check(attrs["local_bytes"] == 0, "the cluster kernel spills registers")
    chosen = (slstm_ops.plan(B, S, d, dev)["layout"], slstm_ops.plan(B, 1, d, dev)["layout"])
    timings, plain = {}, {}
    for layout in slstm_ops.LAYOUTS:
        timings[layout] = (
            time_slstm(torch, slstm_ops, slstm_scan_ref, fresh, "prefill, fresh state", layout,
                       plain.get("prefill")),
            time_slstm(torch, slstm_ops, slstm_scan_ref, step,
                       "decode step, the state a prompt left", layout, plain.get("decode")))
        plain = {"prefill": timings[layout][0][2], "decode": timings[layout][1][2]}
    for what, i, layout in (("prefill", 0, chosen[0]), ("decode step", 1, chosen[1])):
        other = next(x for x in slstm_ops.LAYOUTS if x != layout)
        print(f"  slstm_scan {what}: the plan takes the {layout} layout, "
              f"{timings[layout][i][1]:.4f} ms against {timings[other][i][1]:.4f} ms")
        check(i == 1 or timings[layout][i][1] < timings[other][i][1],
              f"the plan's {layout} layout is not the faster at the {what}")
    for steps in SLSTM_STEPS:
        args = slstm_inputs(torch, gen, B, steps, d, rw, left)
        ms = {x: time_cuda(lambda: slstm_ops.slstm_scan(*args, layout=x))
              for x in slstm_ops.LAYOUTS}
        print(f"  slstm_scan at S = {steps}: " + ", ".join(f"{x} {v:.4f} ms" for x, v in ms.items())
              + f"; the plan takes {slstm_ops.plan(B, steps, d, dev)['layout']}")
    err = max(t[0] for pair in timings.values() for t in pair)
    cases = [("prefill, the state a prompt left", slstm_inputs(torch, gen, B, S, d, rw, left)),
             ("decode step, fresh state", slstm_inputs(torch, gen, B, 1, d, rw))]
    cases += [(label, slstm_inputs(torch, gen, b, s, w)) for label, b, s, w in SLSTM_EDGES]
    nan = slstm_inputs(torch, gen, 2, 6, 100)
    nan[2][1, 2, 7] = float("nan")  # one forget-gate pre-activation
    cases.append(("a NaN in one gate", nan))
    for label, args in cases:
        want = slstm_scan_ref(*args)
        nans = int(torch.isnan(want[0]).sum())
        check(label != "a NaN in one gate" or nans > 0, "the NaN case made no NaN")
        case_err, took = each_layout(
            torch, slstm_ops, label, args[0].shape[2],
            lambda layout, args=args: slstm_ops.slstm_scan(*args, layout=layout),
            lambda what, got, want=want: slstm_error(torch, what, got, want))
        err = max(err, case_err)
        print(f"  slstm_scan {label}, (B, S, d) {tuple(args[0].shape)}: within {SLSTM_TOL} of "
              f"its plain version, reruns equal ({', '.join(took)})"
              + (f", NaN in the same {nans} outputs" if nans else ""))
    return err, timings, chosen


def xlstm_whisper_phase(torch, F, M, serve, flash_ops, decode_ops, scan_ops, flash_ref,
                        decode_ref, wall, smi):
    """Phase 16: xLSTM and the Whisper encoder-decoder. Returns {kernel:
    (whisper's launches, {shape: timing at whisper's shapes})}, and under
    ``slstm_scan`` (xlstm-125m's launches, {max_err, prefill, decode}: the
    sLSTM kernel's timings)."""
    from repro_torch.configs import get_config

    from repro_torch.kernels.slstm_scan import ops as slstm_ops

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    lm_ops = (flash_ops, decode_ops, scan_ops, slstm_ops)
    print(f"[16] xlstm-125m and whisper-tiny at full width and depth; {smi}")

    # (a) xlstm-125m at full width and depth, bf16 -----------------------------
    cfg = get_config("xlstm-125m")
    params = M.init_params(cfg, seed=0, device="cuda")
    B, P, G = 8, 512, 64
    n_slstm = cfg.resolved_block_pattern.count("slstm")
    # The sLSTM time loop's plain versions, forward and backward.
    loops = slstm_loops(slstm_ops)
    # One sLSTM kernel launch a block a prefill and a block a decode step.
    with PlainOnCard(flash_ops, decode_ops, *loops) as plain:
        xl_launches = serve_run(torch, lm_ops, M, serve, cfg, params, B, P, G,
                                dict(flash_attention=0, decode_attention=0, rglru_scan=0,
                                     rglru_scan_bwd=0, slstm_scan=n_slstm * G, slstm_scan_bwd=0,
                                     slstm_scan_bwd_rest=0),
                                wall)
    check(plain.calls == 0, f"a plain attention version or the plain sLSTM loop ran on the card "
                            f"{plain.calls} times")
    H, Dm = cfg.n_heads, 2 * cfg.d_model // cfg.n_heads
    print(f"  blocks {'/'.join(sorted(set(cfg.resolved_block_pattern)))} alternating; mLSTM "
          f"cell {H} heads of {Dm}, its state {B * H * Dm * Dm * 4 / 1e6:.1f} MB (float32) a "
          f"block; prefill in {P // 256} chunks of 256; no attention kernel launched; "
          f"{xl_launches['slstm_scan']} slstm_scan launches ({n_slstm} a prefill, {n_slstm} a "
          f"decode step), the plain sLSTM loop 0 times on the card")
    # Where the card's time goes: one prefill and 8 decode steps, profiled.
    t0 = time.perf_counter()
    with PlainOnCard(flash_ops, decode_ops, *loops) as plain:
        pre, dec = profiled_serve(torch, M, cfg, params, B, P, 8,
                                  ("xlstm.mlstm_chunks", "xlstm.mlstm_decode",
                                   "xlstm.slstm_loop"))
    check(plain.calls == 0 and pre["port_kernels"]["slstm_scan"]["calls"] == n_slstm
          and dec["port_kernels"]["slstm_scan"]["calls"] == 8 * n_slstm,
          f"profiled xlstm: slstm_scan calls {pre['port_kernels']['slstm_scan']['calls']} and "
          f"{dec['port_kernels']['slstm_scan']['calls']}, plain loops {plain.calls}")
    wall["xlstm_profile_s"] = time.perf_counter() - t0

    # (a') the sLSTM kernel against its plain version, and timed ------------------
    t0 = time.perf_counter()
    slstm_err, slstm_times, slstm_chosen = slstm_checks(torch, B, P, cfg.d_model)
    wall["slstm_kernel_s"] = time.perf_counter() - t0

    # (b) xlstm's full depth, float32 and bf16, card against CPU --------------
    t0 = time.perf_counter()
    float32_check(torch, M, cfg, params, 2, P, 8, "xlstm-125m, 12 blocks")
    cpu_check(torch, M, cfg, params, 2, P, 8)
    wall["xlstm_cpu_check_s"] = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()

    # (c) whisper-tiny at full width and depth, bf16 ---------------------------
    cfg = get_config("whisper-tiny")
    params = M.init_params(cfg, seed=0, device="cuda")
    L, Pw, S_enc = cfg.n_layers, 4, cfg.encoder_seq
    # Per prefill: the encoder's bidirectional self-attention (encoder_layers),
    # the decoder's self-attention and its cross-attention over the frames
    # (L each), all B3; per step the decoder's two, B4.
    with PlainOnCard(flash_ops, decode_ops) as plain:
        launches = serve_run(torch, lm_ops, M, serve, cfg, params, B, Pw, G,
                             dict(flash_attention=cfg.encoder_layers + 2 * L,
                                  decode_attention=2 * L * (G - 1), rglru_scan=0, rglru_scan_bwd=0,
                                  slstm_scan=0, slstm_scan_bwd=0, slstm_scan_bwd_rest=0), wall)
    check(plain.calls == 0, f"a plain attention version ran on the card {plain.calls} times")
    print(f"  {cfg.encoder_layers} encoder layers over {S_enc} stub frames (d_model "
          f"{cfg.d_model}) + {L} decoder layers, vocab {cfg.vocab_size} padded to "
          f"{cfg.padded_vocab}: {cfg.encoder_layers + 2 * L} B3 launches a prefill, {2 * L} B4 "
          f"a step; no plain attention version ran on the card")
    profiled_serve(torch, M, cfg, params, B, Pw, 8, ("whisper.encoder", "whisper.cross_attention"),
                   frames=torch.randn(B, S_enc, cfg.d_model, device="cuda", dtype=torch.bfloat16,
                                      generator=torch.Generator(device="cuda").manual_seed(5)))
    frames = torch.randn(2, S_enc, cfg.d_model, generator=torch.Generator().manual_seed(4))
    t0 = time.perf_counter()
    float32_check(torch, M, cfg, params, 2, Pw, 8, f"whisper-tiny, {S_enc} frames", frames)
    cpu_check(torch, M, cfg, params, 2, Pw, 8, frames)
    wall["whisper_cpu_check_s"] = time.perf_counter() - t0

    # (d) B3 and B4 at whisper's shapes -----------------------------------------
    Hw, D = cfg.n_heads, cfg.resolved_head_dim
    timings = {
        "flash_attention": (launches["flash_attention"], {
            "encoder": time_flash(torch, F, flash_ops, flash_ref, B, S_enc, Hw, Hw, D, 0,
                                  causal=False),
            "cross": time_flash(torch, F, flash_ops, flash_ref, B, Pw, Hw, Hw, D, 0, Sk=S_enc,
                                causal=False)}),
        "decode_attention": (launches["decode_attention"], {
            "cross": time_decode(torch, F, decode_ops, decode_ref, B, Hw, Hw, S_enc, S_enc, D)}),
        "slstm_scan": (xl_launches["slstm_scan"], dict(max_err=slstm_err, times=slstm_times,
                                                   chosen=slstm_chosen)),
    }
    del params
    torch.cuda.empty_cache()
    wall["phase_16_s"] = time.perf_counter() - t_phase
    print(f"  phase 16 {wall['phase_16_s']:.3f} s")
    return timings


# Phase 17: qwen2-vl-72b at full width, its depth cut to what one 80 GB card
# holds in bf16 with a clear margin (30.58 G parameters, 61.15 GB). The prompt
# is Qwen2-VL's layout for one image (arXiv:2409.12191, M-RoPE): 16 text
# positions, one 560 x 560 image at patch 14 and a 2 x 2 merge (a 1 x 20 x 20
# grid of merged patches, 400 positions), 96 text positions; the CPU checks
# scale the grid to 4 x 4 in a 64-position prompt.
VLM_LAYERS = 32
VLM_IMAGE = (16, (20, 20), 96)
VLM_CHECK_IMAGE = (16, (4, 4), 32)


def image_positions(torch, B, pre, grid, post, steps):
    """Qwen2-VL's M-RoPE positions for a prompt of ``pre`` text positions,
    one image of ``grid`` = (rows, cols) merged patches and ``post`` text
    positions, then ``steps`` decode steps: (3, B, prompt) and (3, B, steps),
    on the CPU.

    Text runs 0.. on all three streams; patch (r, c) takes t = pre,
    h = pre + r, w = pre + c; text after the image resumes at the largest
    position so far + 1, and decode steps go on from there (at 16, 20 x 20,
    96: the text after the image from 36, decode step i at 132 + i).
    ``tests/test_torch_vlm.py`` holds a copy.
    """
    rows, cols = grid
    text = torch.arange(pre)
    t = torch.full((rows * cols,), pre)
    h = pre + torch.arange(rows).repeat_interleave(cols)
    w = pre + torch.arange(cols).repeat(rows)
    after = pre + max(rows, cols)
    tail = after + torch.arange(post)
    streams = [torch.cat([text, s, tail]) for s in (t, h, w)]
    prompt = torch.stack(streams)[:, None, :].expand(3, B, -1)
    steps = (after + post + torch.arange(steps))[None, None, :].expand(3, B, -1)
    return prompt.contiguous(), steps.contiguous()


def image_stub(torch, cfg, B, n, gen):
    """(B, n, d_model) float32 stub image embeddings from ``gen`` on its
    device, at the scale of the embedded tokens (the table's 0.02 times
    sqrt(d_model)): the vision front end is a stub in both packages."""
    return torch.randn(B, n, cfg.d_model, generator=gen, device=gen.device) * (
        0.02 * cfg.d_model ** 0.5)


def image_embeds(torch, M, cfg, params, ids, stub, pre):
    """The prompt's embeddings on the parameters' device, in the activation
    type: each text row ``embed_tokens(id) * sqrt(d_model)``, what a decode
    step computes for a token, and the image's rows (from ``pre`` on) the
    stub's."""
    table = params["embed"]["table"]
    x = table[ids.to(table.device)]
    emb = (x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype).item()).to(M._DTYPES[cfg.dtype])
    emb[:, pre:pre + stub.shape[1]] = stub.to(table.device, emb.dtype)
    return emb


def vlm_phase(torch, F, M, serve, flash_ops, decode_ops, scan_ops, flash_ref, decode_ref, wall,
              smi):
    """Phase 17: qwen2-vl-72b's backbone. Returns {kernel: (launches, timing
    at its serving shapes)}."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    lm_ops = (flash_ops, decode_ops, scan_ops)
    full = get_config("qwen2-vl-72b")
    cfg = dataclasses.replace(full, n_layers=VLM_LAYERS)
    L, H, Hkv, D = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    print(f"[17] qwen2-vl-72b at full width, its depth cut from {full.n_layers} to {L} layers, "
          f"from an image prompt; {smi}")

    # (a) serving at full width, bf16 -------------------------------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    wall["qwen2vl_init_s"] = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    embed_rows = params["embed"]["table"]
    # A decode step reads every weight but the embedding table's rows it
    # does not look up. A prefill's matmuls take 2 FLOPs a weight a token
    # in the layers, the lm head runs on the last position only, and
    # attention takes 4 D FLOPs a causal (query, key) pair a head.
    step_bytes = weight_bytes - embed_rows.numel() * embed_rows.element_size()
    B, G = 8, 64
    pre, grid, post = VLM_IMAGE
    P = pre + grid[0] * grid[1] + post
    head = cfg.padded_vocab * cfg.d_model
    attn_flops = L * 4 * D * B * H * P * (P + 1) // 2
    prefill_flops = 2 * (step_bytes // 2 - head) * B * P + 2 * head * B + attn_flops
    print(f"  {weight_bytes / 1e9:.2f} GB of bf16 weights ({weight_bytes / 2 ** 30:.2f} GiB); "
          f"floors at {HBM_BYTES_PER_S / 1e12:.2f} TB/s and {BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s: "
          f"decode {step_bytes / 1e9:.2f} GB a step, {1e3 * step_bytes / HBM_BYTES_PER_S:.2f} ms; "
          f"prefill {prefill_flops / 1e12:.1f} TFLOP for {B} x {P} positions, "
          f"{prefill_flops / BF16_FLOPS_PER_S:.4f} s (init {wall['qwen2vl_init_s']:.2f} s)")
    gen = torch.Generator(device="cuda").manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (B, P), generator=gen, device="cuda")
    emb = image_embeds(torch, M, cfg, params, ids,
                       image_stub(torch, cfg, B, grid[0] * grid[1], gen), pre)
    pos, step_pos = image_positions(torch, B, pre, grid, post, G - 1)
    kw = dict(prompt_embeds=emb, mrope_positions=pos.cuda(), decode_positions=step_pos.cuda())
    with PlainOnCard(flash_ops, decode_ops) as plain:
        launches = serve_run(torch, lm_ops, M, serve, cfg, params, B, P, G,
                             dict(flash_attention=L, decode_attention=L * (G - 1), rglru_scan=0, rglru_scan_bwd=0),
                             wall, serve_kw=kw)
    check(plain.calls == 0, f"a plain attention version ran on the card {plain.calls} times")
    peak = torch.cuda.max_memory_allocated()
    prefill_s, decode_s = wall[f"{cfg.name}_prefill_s"], wall[f"{cfg.name}_decode_s"]
    print(f"  prompt: {pre} text + {grid[0]} x {grid[1]} image patches + {post} text positions, "
          f"M-RoPE text after the image from {pre + max(grid)}, decode from "
          f"{int(step_pos[0, 0, 0])}; {L} B3 launches a prefill, {L} B4 a step; no plain "
          f"attention version ran on the card; peak memory {peak / 2 ** 30:.2f} GiB")
    print(f"  prefill {prefill_s:.4f} s ({100 * prefill_flops / BF16_FLOPS_PER_S / prefill_s:.1f}% "
          f"of its floor's rate), decode {1e3 * decode_s / (G - 1):.3f} ms a step "
          f"({100 * step_bytes / HBM_BYTES_PER_S / (decode_s / (G - 1)):.1f}% of the weights' "
          f"floor's rate)")

    # (b) one prefill and 8 decode steps under the profiler ----------------------
    t0 = time.perf_counter()
    steps = 8
    _, dec = profiled_serve(torch, M, cfg, params, B, P, steps, (), first={
        "embeds": emb, "mrope_positions": pos.cuda()},
        step_x=lambda i: {"mrope_positions": step_pos[:, :, i:i + 1].cuda()})
    busy_ms = dec["device_busy_s"] * 1e3 / steps
    print(f"  decode: device busy {busy_ms:.3f} ms a step against the weights' floor "
          f"{1e3 * step_bytes / HBM_BYTES_PER_S:.3f} ms, wall {dec['wall_s'] * 1e3 / steps:.3f} ms")
    wall["qwen2vl_profile_s"] = time.perf_counter() - t0

    # (c), (d) the first 2 layers in float32 and bf16, card against CPU ---------
    cut, cut_params = first_layers(M, cfg, params, 2)
    del params, emb, kw
    torch.cuda.empty_cache()
    n_cut = sum(t.numel() for t in _leaves(cut_params))
    pre_c, grid_c, post_c = VLM_CHECK_IMAGE
    Pc = pre_c + grid_c[0] * grid_c[1] + post_c
    print(f"  CPU checks on {cut.n_layers} of {full.n_layers} layers at full width: "
          f"{n_cut / 1e9:.2f} G parameters, {4 * n_cut / 1e9:.2f} GB in float32 on the host; "
          f"{pre_c} text + {grid_c[0]} x {grid_c[1]} image + {post_c} text positions")
    t0 = time.perf_counter()
    float32_check(torch, M, cut, cut_params, 2, Pc, 8, "qwen2-vl-72b, 2 layers",
                  image=VLM_CHECK_IMAGE)
    cpu_check(torch, M, cut, cut_params, 2, Pc, 8, image=VLM_CHECK_IMAGE)
    wall["qwen2vl_cpu_check_s"] = time.perf_counter() - t0
    del cut_params
    torch.cuda.empty_cache()

    # (e) B3 and B4 at qwen2-vl's serving shapes ---------------------------------
    timings = {
        "flash_attention": (launches["flash_attention"],
                            time_flash(torch, F, flash_ops, flash_ref, B, P, H, Hkv, D, 0)),
        # The last decode step: 512 + 63 tokens cached of 576 slots.
        "decode_attention": (launches["decode_attention"],
                             time_decode(torch, F, decode_ops, decode_ref, B, H, Hkv, P + G,
                                         P + G - 1, D)),
    }
    wall["phase_17_s"] = time.perf_counter() - t_phase
    print(f"  phase 17 {wall['phase_17_s']:.3f} s")
    return timings


def planner_phase(torch, ops, wall, smi):
    """Phase 18: the LM-serving planner on the card. Returns its B1 launches."""
    import contextlib
    import io

    from repro_torch.configs import ARCHS, get_config
    import repro_torch.sched.planner as planner_mod
    from repro_torch.paper import planner
    from repro_torch.paper.common import comparable
    from repro_torch.sched import ElasticController
    from repro_torch.serve_lm import FLEET

    print(f"[18] the LM-serving planner: paper.planner over H100 x 8 groups of 8, A100 x 4 of 8 "
          f"and L4 x 12 of 4, then ElasticController over serve_lm's H100 x 6 of 8 and L4 x 8 of "
          f"4; {smi}")
    t_phase = time.perf_counter()
    plain, eager = ops.sched_scoring_ref, []

    def counting(*args, **kwargs):
        if args[0].is_cuda:
            eager.append(tuple(args[0].shape))
        return plain(*args, **kwargs)

    ops.sched_scoring_ref = counting
    # (a) the benchmark on the card, then on the CPU ------------------------------
    ops.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        card = planner.main("cuda")
    wall["planner_card_s"] = time.perf_counter() - t0
    bench_b1 = ops.LAUNCHES["sched_scoring"]
    with contextlib.redirect_stdout(io.StringIO()):
        cpu = planner.main("cpu")
    for name, us, derived in card:
        print(f"  {name},{us:.1f},{derived}")
    ours = {name: comparable(d, planner.MEASURED) for name, _us, d in card}
    check(ours == PLANNER_REF, f"planner rows differ from the reference's: "
                               f"{ {k: v for k, v in ours.items() if PLANNER_REF.get(k) != v} }")
    check({name: comparable(d, planner.MEASURED) for name, _us, d in cpu} == ours,
          "planner rows on the card differ from the CPU's")
    print(f"  {len(card)} rows equal the reference's and the CPU's; {bench_b1} B1 launches (no "
          f"plan over these 24 groups comes under refine's 64 tasks); "
          f"{wall['planner_card_s']:.3f} s on the card")

    # (b) the elastic controller on the serve example's fleet ---------------------
    # Each plan's refine call (the tasks of the ETG it refines), counted on
    # the planner's own name for it.
    real_refine, refined = planner_mod.refine, []

    def counted(etg, cluster, **kwargs):
        refined.append(etg.total_tasks)
        return real_refine(etg, cluster, **kwargs)

    planner_mod.refine = counted
    b1, first = {}, []
    for arch in ARCHS:
        cfg = get_config(arch)
        ops.reset_launches()
        refined.clear()
        t0 = time.perf_counter()
        card = ElasticController(cfg, FLEET, device="cuda")
        if refined:
            first.append(arch)
        card.fail(0, 2)
        card.restore(0, 2)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        card_refines = list(refined)
        refined.clear()
        b1[arch] = ops.LAUNCHES["sched_scoring"]
        check(ops.LAUNCHES["sched_scoring_resources"] == 0, f"{arch}: B2 launched")
        check(bool(b1[arch]) == bool(card_refines),
              f"{arch}: {len(card_refines)} refines, {b1[arch]} B1 launches")
        t0 = time.perf_counter()
        cpu = ElasticController(cfg, FLEET, device="cpu")
        cpu.fail(0, 2)
        cpu.restore(0, 2)
        t_cpu = time.perf_counter() - t0
        check(refined == card_refines, f"{arch}: refined {card_refines} on the card, {refined} "
                                       f"on the CPU")
        for (reason, a), (_, b) in zip(card.history, cpu.history, strict=True):
            check(a.replicas.tolist() == b.replicas.tolist()
                  and all(x.tolist() == y.tolist() for x, y in zip(a.assignment, b.assignment,
                                                                  strict=True))
                  and (a.tokens_per_s, a.predicted_throughput, a.baseline_tokens_per_s,
                       a.iterations) == (b.tokens_per_s, b.predicted_throughput,
                                         b.baseline_tokens_per_s, b.iterations),
                  f"{arch}, {reason}: the card's plan differs from the CPU's")
        rates = " -> ".join(f"{p.tokens_per_s:,.0f}" for _, p in card.history)
        print(f"  {arch}: admission {rates} tok/s (initial, 2 h100 groups lost, restored); "
              f"refine in {len(card_refines)} of 3 plans (tasks {card_refines}), {b1[arch]} B1 "
              f"launches; card {t_card:.3f} s, cpu {t_cpu:.3f} s")
    planner_mod.refine = real_refine
    ops.sched_scoring_ref = plain
    check(not eager, f"the scorer's plain version ran on the card: {eager[:4]}")
    check(tuple(first) == PLANNER_REFINED,
          f"the first plans of {tuple(first)} ran refine, not those of {PLANNER_REFINED}")
    wall["phase_18_s"] = time.perf_counter() - t_phase
    print(f"  every plan equal to the CPU's (replicas, assignments, rates, iterations, refine "
          f"calls); the first plans of {len(first)} archs refine on B1 ({', '.join(first)}); "
          f"{sum(b1.values())} B1 launches; no plain scorer on the card; phase 18 "
          f"{wall['phase_18_s']:.3f} s")
    return bench_b1 + sum(b1.values())


# Phase 19: training. qwen1.5-0.5b at full width and depth in its config's
# types (bf16 parameters and activations, float32 AdamW moments), remat on,
# a SyntheticLM stream of TRAIN_B x TRAIN_S tokens from TRAIN_SEED, the
# cosine schedule over TRAIN_STEPS steps, checkpoints every 10.
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_SEED = 8, 512, 20, 0
TRAIN_LR, TRAIN_WARMUP = 6e-4, 5
# A run resumed from its step-10 checkpoint against the uninterrupted run,
# steps 11-20: |loss - loss'| <= RESTART_REL loss'. The restored state is
# the checkpoint's bit for bit; the two runs part only where the card's
# backward is not deterministic (the embedding gather's scatter-add, the
# order of bf16 atomics), each difference a bf16 rounding of a parameter.
RESTART_REL = 1e-2
# One float32 step at 2 layers, card (TF32 off) against the CPU from the
# same parameters and batch: the loss within F32_LOSS_REL, the grad norm
# within F32_NORM_REL, and the parameter update within F32_UPDATE_REL of
# the CPU's in l2 (an element whose gradient lies within rounding of 0 may
# take the opposite sign, and AdamW's first step moves it by +-lr: the
# largest difference is printed beside the count of such elements).
F32_LOSS_REL, F32_NORM_REL, F32_UPDATE_REL = 1e-4, 1e-3, 1e-3
# The trained model serves: TRAIN_B prompts of TRAIN_SERVE_P tokens, then
# TRAIN_SERVE_STEPS decode steps.
TRAIN_SERVE_P, TRAIN_SERVE_STEPS = 128, 8


class _Stream:
    """A ``SyntheticLM`` read in order, with the ``state()``/``seek()`` that
    the trainer writes into its checkpoints and seeks on resume (the
    reference's ``SyntheticLM`` has neither; ``MemmapDataset`` has both)."""

    def __init__(self, ds):
        self.ds, self.index = ds, 0

    def state(self):
        return {"index": self.index}

    def seek(self, state):
        self.index = int(state["index"])

    def __iter__(self):
        while True:
            batch = self.ds.batch_at(self.index)
            self.index += 1
            yield batch


def train_phase(torch, M, serve, flash_ops, decode_ops, scan_ops, scan_ref, wall, smi):
    """Phase 19: train qwen1.5-0.5b at full width and depth through the
    ``Trainer``, resume it from a checkpoint, hold one float32 step at 2
    layers against the CPU, and serve from the trained weights. Returns
    the serving's B3 and B4 launches."""
    import tempfile

    from repro_torch._tree import leaves
    from repro_torch.checkpoint import store
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.profile_serve import profile_phase
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw
    from repro_torch.roofline import model_flops, param_counts, roofline_terms
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.step_analysis import analyze_step

    cfg = get_config("qwen1.5-0.5b")
    print(f"[19] training {cfg.name} at full width and depth ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}, tied embeddings), {cfg.param_dtype} "
          f"parameters, float32 AdamW moments, remat; {TRAIN_B} x {TRAIN_S} tokens a step; {smi}")
    t_phase = time.perf_counter()
    opt = adamw.AdamWConfig(lr=TRAIN_LR)
    step = make_train_step(cfg, opt, device="cuda",
                           lr_fn=adamw.cosine_schedule(TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS),
                           remat=True)
    walls = []

    def timed(state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(state, batch)
        float(out[1]["loss"])
        walls.append(time.perf_counter() - t0)
        return out

    def init_state():
        params = M.init_params(cfg, seed=TRAIN_SEED, device="cuda")
        return {"params": params, "opt": adamw.init_opt_state(params, opt)}

    def trainer(ckpt_dir, total, logs):
        tcfg = TrainerConfig(total_steps=total, ckpt_dir=ckpt_dir, ckpt_every=10, keep=1,
                             log_every=10)
        data = _Stream(SyntheticLM(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=TRAIN_SEED))
        return Trainer(tcfg, timed, init_state, data, log=logs.append)

    for ops in (flash_ops, decode_ops, scan_ops):
        ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        # (a) 20 steps, checkpoints at 10 and 20 (async, keep 1) ------------
        logs = []
        t0 = time.perf_counter()
        straight = trainer(f"{tmp}/straight", TRAIN_STEPS, logs).run()
        wall["train_s"] = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launched = {k: v for ops in (flash_ops, decode_ops, scan_ops) for k, v in ops.LAUNCHES.items()}
        check(not any(launched.values()), f"training launched {launched}: qwen1.5-0.5b trains "
                                          "with no B3/B4 (attention through sdpa) and no RG-LRU")
        losses = straight["losses"]
        check(straight["final_step"] == TRAIN_STEPS and len(losses) == TRAIN_STEPS
              and all(map(math.isfinite, losses)), f"training: {straight['final_step']} steps, "
              f"losses {losses}")
        check(losses[-1] < losses[0], f"the loss did not fall: {losses[0]} -> {losses[-1]}")
        for line in logs:
            print(f"  {line}")
        # Steps 3-10 run alone; steps 11-20 beside the async write of the
        # step-10 checkpoint, which takes the host's time from the
        # (host-bound) steps.
        step_s = statistics.median(walls[2:10])
        saving_s = statistics.median(walls[10:TRAIN_STEPS])
        tokens = TRAIN_B * TRAIN_S
        flops = model_flops(cfg, ShapeConfig("train", TRAIN_S, TRAIN_B, "train"))
        n_params = sum(t.numel() for t in leaves(straight["state"]["params"]))
        print(f"  {n_params / 1e6:.1f} M parameters ({param_counts(cfg)['total'] / 1e6:.1f} M "
              f"without the vocab padding); loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
              f"{TRAIN_STEPS} steps: " + " ".join(f"{x:.3f}" for x in losses))
        print(f"  step wall {step_s * 1e3:.1f} ms (median of steps 3-10; first "
              f"{walls[0] * 1e3:.1f} ms, second {walls[1] * 1e3:.1f} ms; steps 11-{TRAIN_STEPS}, "
              f"beside the step-10 checkpoint's write, {saving_s * 1e3:.1f} ms), "
              f"{tokens / step_s:,.0f} "
              f"tokens/s; 6 N D = {flops / 1e12:.2f} TFLOP a step, {flops / step_s / 1e12:.1f} "
              f"TFLOP/s achieved ({100 * flops / step_s / BF16_FLOPS_PER_S:.1f}% of the bf16 "
              f"peak at 700 W); peak memory {peak / 2**30:.2f} GiB; the 20-step run "
              f"{wall['train_s']:.2f} s with its two checkpoints; {smi}")
        wall["train_step_ms"] = step_s * 1e3
        wall["train_step_saving_ms"] = saving_s * 1e3

        # (b) 10 steps, a checkpoint at 10; a new trainer resumes to 20 -----
        t0 = time.perf_counter()
        logs = []
        first = trainer(f"{tmp}/restart", 10, logs).run()
        # The parameters only (a sixth of the state's bytes); the resumed
        # losses below test the moments.
        ckpt, _ = store.restore(f"{tmp}/restart", {"params": first["state"]["params"]})
        check(all(torch.equal(a, b) for a, b in zip(leaves(ckpt["params"]),
                                                    leaves(first["state"]["params"]))),
              "the step-10 checkpoint does not hold the trained parameters bit for bit")
        del first, ckpt
        resumed = trainer(f"{tmp}/restart", TRAIN_STEPS, logs).run()
        check(any("resumed from step 10" in line for line in logs)
              and resumed["final_step"] == TRAIN_STEPS and len(resumed["losses"]) == 10,
              f"the second trainer did not resume at step 10: {logs}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(resumed["losses"], losses[10:]))
        check(rel <= RESTART_REL, f"resumed losses {resumed['losses']} differ from the "
                                  f"uninterrupted run's {losses[10:]} by {rel:.2e} (relative)")
        print(f"  restart: a trainer resumed at step 10 from the first 10 steps' checkpoint "
              f"(parameters equal bit for bit); its losses for steps 11-20 within {rel:.2e} of the "
              f"uninterrupted run's (relative, tolerance {RESTART_REL:g}); "
              f"{time.perf_counter() - t0:.2f} s")
        wall["train_restart_s"] = time.perf_counter() - t0
        del resumed

    # (c) one profiled step of the trained state --------------------------------
    trained = straight["state"]
    batch = SyntheticLM(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=TRAIN_SEED).batch_at(TRAIN_STEPS)
    prof = profile_phase(lambda: step(trained, batch))
    print(f"  one profiled step: wall {prof['wall_s'] * 1e3:.1f} ms, device busy "
          f"{prof['device_busy_s'] * 1e3:.1f} ms ({100 * prof['busy_share']:.1f}%), "
          f"{prof['launches']} device activities; top: " + "; ".join(
              f"{t['name'][:40]} {t['device_ms']:.1f} ms x{t['calls']}" for t in prof["top"][:5]))
    wall["train_busy_share"] = prof["busy_share"]

    # (c') the step analyser on one step, and its roofline terms on H100 constants
    t0 = time.perf_counter()
    costs = analyze_step(step, trained, batch)
    terms = roofline_terms(costs.matmul_flops, costs.touched_bytes, costs.collective_bytes)
    bound = max(terms.values())
    check(costs.matmul_flops >= flops and costs.collective_bytes == 0,
          f"the analyser counted {costs.matmul_flops:.4e} FLOP (6 N D {flops:.4e}) and "
          f"{costs.collective_bytes} collective bytes on one card")
    print(f"  analyze_step on one step: {costs.matmul_flops / 1e12:.3f} TFLOP of products "
          f"counted ({costs.matmul_flops / flops:.3f} x 6 N D = {flops / 1e12:.3f} TFLOP: remat "
          f"recomputes each repeat's forward, attention's products are counted), touched bytes "
          f"{costs.touched_bytes / 1e9:.2f} GB (an upper bound: every op's result, views "
          f"included), collective bytes {costs.collective_bytes:g}; roofline terms on H100 "
          f"constants: compute {terms['compute'] * 1e3:.2f} ms, memory "
          f"{terms['memory'] * 1e3:.2f} ms, collective {terms['collective'] * 1e3:.2f} ms, "
          f"against the measured step wall {step_s * 1e3:.1f} ms "
          f"({100 * bound / step_s:.1f}% of it is the larger term); "
          f"{time.perf_counter() - t0:.2f} s; {smi}")
    wall["train_analyse_s"] = time.perf_counter() - t0

    # (d) float32 at 2 layers: one step on the card and on the CPU ----------------
    t0 = time.perf_counter()
    c32 = dataclasses.replace(cfg, n_layers=2, dtype="float32", param_dtype="float32")
    p_cpu = M.init_params(c32, seed=TRAIN_SEED + 1, device="cpu")
    batch32 = SyntheticLM(c32.vocab_size, 128, 2, seed=TRAIN_SEED + 1).batch_at(0)
    out = {}
    for dev in ("cpu", "cuda"):
        p = _map_leaves(p_cpu, lambda t, d=dev: t.to(d))
        out[dev] = make_train_step(c32, opt, device=dev)(
            {"params": p, "opt": adamw.init_opt_state(p, opt)}, batch32)
    (cpu, m_cpu), (card, m_card) = out["cpu"], out["cuda"]
    loss_rel = abs(float(m_card["loss"]) - float(m_cpu["loss"])) / abs(float(m_cpu["loss"]))
    norm_rel = abs(float(m_card["grad_norm"]) - float(m_cpu["grad_norm"])) / float(
        m_cpu["grad_norm"])
    d_cpu = torch.cat([(a - b).flatten() for a, b in zip(leaves(cpu["params"]), leaves(p_cpu))])
    d_card = torch.cat([(a.cpu() - b).flatten()
                        for a, b in zip(leaves(card["params"]), leaves(p_cpu))])
    upd_rel = float((d_card - d_cpu).norm() / d_cpu.norm())
    flips = int(((d_card > 0) != (d_cpu > 0)).sum())
    max_abs = float((d_card - d_cpu).abs().max())
    check(loss_rel <= F32_LOSS_REL and norm_rel <= F32_NORM_REL and upd_rel <= F32_UPDATE_REL,
          f"float32 step, card vs CPU: loss {loss_rel:.2e}, grad norm {norm_rel:.2e}, update "
          f"{upd_rel:.2e} (relative)")
    print(f"  float32, {c32.n_layers} layers, 2 x 128 tokens, one step card vs CPU: loss "
          f"{float(m_card['loss']):.6f} vs {float(m_cpu['loss']):.6f} ({loss_rel:.2e} relative, "
          f"<= {F32_LOSS_REL:g}), grad norm {norm_rel:.2e} (<= {F32_NORM_REL:g}), update "
          f"{upd_rel:.2e} in l2 (<= {F32_UPDATE_REL:g}); largest parameter difference "
          f"{max_abs:.3e} (lr {TRAIN_LR:g}), {flips} of {d_cpu.numel()} updates of opposite "
          f"sign; {time.perf_counter() - t0:.2f} s")
    wall["train_f32_check_s"] = time.perf_counter() - t0
    del out, cpu, card, p_cpu

    # (e) B3 and B4 refuse autograd; B5 differentiates through its kernels -------
    q = torch.randn(1, 4, 2, 64, device="cuda", requires_grad=True)
    kv = torch.randn(1, 4, 2, 64, device="cuda")
    refusals = (lambda: flash_ops.flash_attention(q, kv, kv, causal=True),
                lambda: decode_ops.decode_attention(
                    q[:, 0], kv, kv, torch.full((1,), 4, dtype=torch.int32, device="cuda")))
    for call in refusals:
        try:
            call()
            check(False, "a kernel without a backward returned a result under autograd")
        except RuntimeError as e:
            check("no backward" in str(e), f"unexpected refusal: {e}")
    gen = torch.Generator(device="cuda").manual_seed(19)
    a, b, h0 = (t.requires_grad_(True) for t in scan_inputs(torch, gen, 2, 300, 640,
                                                           torch.float32))
    g = torch.randn(a.shape, device="cuda", generator=gen)
    scan_ops.reset_launches()
    got = torch.autograd.grad(scan_ops.rglru_scan(a, b, h0), (a, b, h0), g)
    launched = dict(scan_ops.LAUNCHES)
    want = torch.autograd.grad(scan_ref(a, b, h0), (a, b, h0), g)
    err = max(float((x - w).abs().max()) for x, w in zip(got, want))
    check(launched == {"rglru_scan": 1, "rglru_scan_bwd": 1},
          f"B5 under autograd launched {launched}, not one forward and one backward")
    check(err <= SCAN_TOL, f"B5's gradient differs from its plain version's by {err:.3e}")
    print(f"  B3 and B4 refuse CUDA inputs that require grad; B5 under autograd launches its "
          f"kernel and rglru_scan_bwd once each, its gradient within {err:.3e} of autograd "
          f"through the plain version (2 x 300 x 640, float32; <= {SCAN_TOL:g})")

    # (f) serve from the trained weights -----------------------------------------
    for ops in (flash_ops, decode_ops, scan_ops):
        ops.reset_launches()
    gen_len = TRAIN_SERVE_STEPS + 1
    res = serve(cfg, batch=TRAIN_B, prompt_len=TRAIN_SERVE_P, gen_len=gen_len,
                params=trained["params"], device="cuda")
    launches = {k: v for ops in (flash_ops, decode_ops, scan_ops) for k, v in ops.LAUNCHES.items()}
    want = dict(flash_attention=cfg.n_layers, decode_attention=cfg.n_layers * TRAIN_SERVE_STEPS,
                rglru_scan=0, rglru_scan_bwd=0)
    check(launches == want, f"serving the trained weights: launches {launches}, not {want}")
    toks = res.tokens
    check(tuple(toks.shape) == (TRAIN_B, gen_len) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab_size, "served tokens out of shape or vocabulary")
    print(f"  served the trained weights: {TRAIN_B} prompts x {TRAIN_SERVE_P} tokens + "
          f"{TRAIN_SERVE_STEPS} decode steps, launches {launches} ({cfg.n_layers} B3 a prefill, "
          f"{cfg.n_layers} B4 a step); sample ids {toks[0].tolist()}")
    wall["phase_19_s"] = time.perf_counter() - t_phase
    print(f"  phase 19 wall {wall['phase_19_s']:.1f} s")
    return {k: launches[k] for k in ("flash_attention", "decode_attention")}


# Phase 20: RG-LRU training. recurrentgemma-2b at full width, its depth cut
# to RG_TRAIN_LAYERS of 26 (three Griffin periods: 6 RG-LRU and 3
# local-attention blocks, 1.43 G parameters), phase 19's recipe (bf16
# parameters, float32 moments, remat, TRAIN_B x TRAIN_S SyntheticLM tokens
# from TRAIN_SEED, the cosine schedule) over RG_TRAIN_STEPS steps. Full
# depth (2.89 G parameters) needs ~116 GB at phase 19's ~40 bytes a
# parameter and waits for a leaner AdamW (ROADMAP A13a). The float32 check
# runs the first Griffin period (RG_CHECK_LAYERS, both block kinds).
RG_TRAIN_LAYERS, RG_TRAIN_STEPS, RG_CHECK_LAYERS = 9, 10, 3


def time_scan_bwd(torch, scan_ops, bwd_ref, B, S, W):
    """``rglru_scan_bwd`` at (B, S, W) float32 against its plain version on
    the card (within ``SCAN_TOL``), then timed beside it; no PyTorch call
    computes it (library_ms null). The training path asks for no dh0 (h0 is
    a constant zero state), so neither does the timed call."""
    from repro_torch.launch.timing import time_cuda

    gen = torch.Generator(device="cuda").manual_seed(20)
    before = dict(scan_ops.LAUNCHES)
    a, b, h0 = scan_inputs(torch, gen, B, S, W, torch.float32)
    h = scan_ops.rglru_scan(a, b, h0)
    g = torch.randn(B, S, W, device="cuda", generator=gen)
    got = scan_ops.rglru_scan_bwd(g, a, h, h0)
    want = bwd_ref(g, a, h, h0)
    err = max(scan_error(torch, f"rglru_scan_bwd {name} at {B} x {S} x {W}", x, w)
              for name, x, w in zip(("da", "db", "dh0"), got, want))
    ms = time_cuda(lambda: scan_ops.rglru_scan_bwd(g, a, h, h0, grad_h0=False))
    plain_ms = time_cuda(lambda: bwd_ref(g, a, h, h0), reps=5)
    scan_ops.LAUNCHES.update(before)  # the comparison's launches are not the path's
    n = B * S * W
    n_bytes = 5 * n * 4 + B * W * 4  # g, a, h read and da, db written once; h0 read
    bound = _bound(3 * n / FP32_FLOPS_PER_S, n_bytes / HBM_BYTES_PER_S)
    print(f"  rglru_scan_bwd B={B} S={S} W={W} float32: within {err:.3e} of its plain version "
          f"(<= {SCAN_TOL:g}); {ms:.4f} ms, bound {bound[0]:.4f} ms by {bound[1]} "
          f"({n_bytes / 1e6:.2f} MB; {100 * bound[0] / ms:.1f}% of it), plain {plain_ms:.4f} ms; "
          f"no single PyTorch call computes it, so library_ms is null")
    return err, ms, plain_ms, bound, None


def rglru_train_phase(torch, M, flash_ops, decode_ops, scan_ops, bwd_ref, wall, smi):
    """Phase 20: train recurrentgemma-2b at full width (RG_TRAIN_LAYERS of
    its layers) through the ``Trainer``, B5 and ``rglru_scan_bwd``, with the
    exact launch counts; one float32 step of its first Griffin period
    against the CPU; ``rglru_scan_bwd`` against its plain version at the
    training shape, timed. Returns (B5's and the backward's launches in the
    training run, the backward's timing)."""
    import tempfile

    from repro_torch._tree import leaves
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw
    from repro_torch.roofline import model_flops, param_counts
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    full = get_config("recurrentgemma-2b")
    cfg = dataclasses.replace(full, n_layers=RG_TRAIN_LAYERS,
                              block_pattern=full.resolved_block_pattern[:RG_TRAIN_LAYERS])
    kinds = cfg.resolved_block_pattern
    n_rec = kinds.count("rglru")
    print(f"[20] training {full.name} at full width (d_model {cfg.d_model}, lru width "
          f"{cfg.lru_width}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), {cfg.n_layers} of "
          f"{full.n_layers} layers ({n_rec} RG-LRU, {kinds.count('local_attn')} local attention; "
          f"full depth, {param_counts(full)['total'] / 1e9:.3f} G parameters, waits for a leaner "
          f"AdamW, ROADMAP A13a), {cfg.param_dtype} parameters, float32 AdamW moments, remat; "
          f"{TRAIN_B} x {TRAIN_S} tokens a step; {smi}")
    t_phase = time.perf_counter()
    opt = adamw.AdamWConfig(lr=TRAIN_LR)
    step = make_train_step(cfg, opt, device="cuda", remat=True,
                           lr_fn=adamw.cosine_schedule(TRAIN_LR, TRAIN_WARMUP, RG_TRAIN_STEPS))
    walls = []

    def timed(state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(state, batch)
        float(out[1]["loss"])
        walls.append(time.perf_counter() - t0)
        return out

    def init_state():
        params = M.init_params(cfg, seed=TRAIN_SEED, device="cuda")
        return {"params": params, "opt": adamw.init_opt_state(params, opt)}

    # (a) RG_TRAIN_STEPS steps through the Trainer ----------------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    logs = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rglru_train_") as tmp:
        data = _Stream(SyntheticLM(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=TRAIN_SEED))
        trainer = Trainer(TrainerConfig(total_steps=RG_TRAIN_STEPS, ckpt_dir=tmp,
                                        ckpt_every=10 ** 9, keep=1, log_every=RG_TRAIN_STEPS),
                          timed, init_state, data, log=logs.append)
        for ops in (flash_ops, decode_ops, scan_ops):
            ops.reset_launches()
        t0 = time.perf_counter()
        out = trainer.run()
        wall["rglru_train_s"] = time.perf_counter() - t0
        launches = {k: v for ops in (flash_ops, decode_ops, scan_ops)
                    for k, v in ops.LAUNCHES.items()}
    peak = torch.cuda.max_memory_allocated()
    # Remat: each recurrent block's scan runs in the forward and again in the
    # recompute of its repeat, its backward once; training attends through
    # sdpa (no B3, no B4).
    want = dict(flash_attention=0, decode_attention=0, rglru_scan=2 * n_rec * RG_TRAIN_STEPS,
                rglru_scan_bwd=n_rec * RG_TRAIN_STEPS)
    check(launches == want, f"RG-LRU training launched {launches}, not {want}")
    losses = out["losses"]
    check(out["final_step"] == RG_TRAIN_STEPS and len(losses) == RG_TRAIN_STEPS
          and all(map(math.isfinite, losses)), f"RG-LRU training: {out['final_step']} steps, "
          f"losses {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses[0]} -> {losses[-1]}")
    n_params = sum(t.numel() for t in leaves(out["state"]["params"]))
    del out, trainer
    step_s = statistics.median(walls[2:RG_TRAIN_STEPS])
    tokens = TRAIN_B * TRAIN_S
    flops = model_flops(cfg, ShapeConfig("train", TRAIN_S, TRAIN_B, "train"))
    for line in logs:
        print(f"  {line}")
    print(f"  {n_params / 1e9:.3f} G parameters; loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
          f"{RG_TRAIN_STEPS} steps: " + " ".join(f"{x:.3f}" for x in losses))
    print(f"  step wall {step_s * 1e3:.1f} ms (median of steps 3-{RG_TRAIN_STEPS}; first "
          f"{walls[0] * 1e3:.1f} ms), {tokens / step_s:,.0f} tokens/s; 6 N D = "
          f"{flops / 1e12:.2f} TFLOP a step, {flops / step_s / 1e12:.1f} TFLOP/s achieved "
          f"({100 * flops / step_s / BF16_FLOPS_PER_S:.1f}% of the bf16 peak at 700 W); peak "
          f"memory {peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB, {peak / n_params:.1f} bytes a "
          f"parameter); launches {launches} (B5 twice and rglru_scan_bwd once a recurrent "
          f"block a step); {wall['rglru_train_s']:.2f} s; {smi}")
    wall["rglru_train_step_ms"] = step_s * 1e3
    wall["rglru_train_peak_gib"] = peak / 2**30

    # (b) float32, the first Griffin period: one step on the card and the CPU ---
    t0 = time.perf_counter()
    c32 = dataclasses.replace(cfg, n_layers=RG_CHECK_LAYERS,
                              block_pattern=kinds[:RG_CHECK_LAYERS], dtype="float32",
                              param_dtype="float32")
    p_cpu = M.init_params(c32, seed=TRAIN_SEED + 1, device="cpu")
    batch32 = SyntheticLM(c32.vocab_size, 128, 2, seed=TRAIN_SEED + 1).batch_at(0)
    res = {}
    for dev in ("cpu", "cuda"):
        p = _map_leaves(p_cpu, lambda t, d=dev: t.to(d))
        res[dev] = make_train_step(c32, opt, device=dev)(
            {"params": p, "opt": adamw.init_opt_state(p, opt)}, batch32)
        del p
    (cpu, m_cpu), (card, m_card) = res["cpu"], res["cuda"]
    loss_rel = abs(float(m_card["loss"]) - float(m_cpu["loss"])) / abs(float(m_cpu["loss"]))
    norm_rel = abs(float(m_card["grad_norm"]) - float(m_cpu["grad_norm"])) / float(
        m_cpu["grad_norm"])
    d_cpu = torch.cat([(x - y).flatten() for x, y in zip(leaves(cpu["params"]), leaves(p_cpu))])
    d_card = torch.cat([(x.cpu() - y).flatten()
                        for x, y in zip(leaves(card["params"]), leaves(p_cpu))])
    upd_rel = float((d_card - d_cpu).norm() / d_cpu.norm())
    flips = int(((d_card > 0) != (d_cpu > 0)).sum())
    check(loss_rel <= F32_LOSS_REL and norm_rel <= F32_NORM_REL and upd_rel <= F32_UPDATE_REL,
          f"RG-LRU float32 step, card vs CPU: loss {loss_rel:.2e}, grad norm {norm_rel:.2e}, "
          f"update {upd_rel:.2e} (relative)")
    print(f"  float32, {c32.n_layers} layers ({', '.join(c32.resolved_block_pattern)}), 2 x 128 "
          f"tokens, one step card vs CPU: loss {float(m_card['loss']):.6f} vs "
          f"{float(m_cpu['loss']):.6f} ({loss_rel:.2e} relative, <= {F32_LOSS_REL:g}), grad norm "
          f"{norm_rel:.2e} (<= {F32_NORM_REL:g}), update {upd_rel:.2e} in l2 "
          f"(<= {F32_UPDATE_REL:g}); {flips} of {d_cpu.numel()} updates of opposite sign; "
          f"{time.perf_counter() - t0:.2f} s")
    wall["rglru_train_f32_check_s"] = time.perf_counter() - t0
    del res, cpu, card, p_cpu, d_cpu, d_card
    torch.cuda.empty_cache()

    # (c) rglru_scan_bwd at the training shape ---------------------------------
    timing = time_scan_bwd(torch, scan_ops, bwd_ref, TRAIN_B, TRAIN_S, cfg.lru_width)
    wall["phase_20_s"] = time.perf_counter() - t_phase
    print(f"  phase 20 wall {wall['phase_20_s']:.1f} s")
    return {k: launches[k] for k in ("rglru_scan", "rglru_scan_bwd")}, timing


# Phase 21: the mesh route. (a) dry-run cells over the production meshes
# (``launch.dryrun.run_cell``: a fake group of 256 or 512 ranks in this one
# process, meta DTensors, no card work): every shape of three archs, and
# qwen2-vl-72b's train_4k at all 80 layers on both meshes. (b) a one-rank
# NCCL group and a 1 x 1 ("data", "model") mesh on the card: one train step
# each of qwen1.5-0.5b (full width and depth), recurrentgemma-2b's first
# MESH_RG_LAYERS layers, granite-moe-1b-a400m's first MESH_MOE_LAYERS
# (through the ``a2a`` route) and xlstm-125m's first MESH_XL_LAYERS (an
# mLSTM and an sLSTM block), through ``make_train_step(mesh=...)`` on
# DTensors, against the mesh-less step from the same state and batch: equal
# bit for bit (deterministic algorithms on for both, as the embedding and
# MoE gathers' backward otherwise add in no fixed order).
MESH_DRYRUN_CELLS = tuple(
    [(arch, shape, False) for arch in ("qwen1.5-0.5b", "granite-moe-1b-a400m",
                                       "recurrentgemma-2b")
     for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k")]
    + [("qwen2-vl-72b", "train_4k", False), ("qwen2-vl-72b", "train_4k", True)])
MESH_RG_LAYERS, MESH_MOE_LAYERS, MESH_XL_LAYERS = 3, 2, 2


def _dtensor_full(tree):
    from torch.distributed.tensor import DTensor

    return _map_leaves(tree, lambda t: t.full_tensor() if isinstance(t, DTensor) else t)


def mesh_phase(torch, M, flash_ops, decode_ops, scan_ops, wall, smi):
    """Phase 21 (see MESH_DRYRUN_CELLS). Returns B5's, the sLSTM kernel's and
    their backwards' launches inside ``local_map`` in (b)."""
    import os
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.dist import partition
    from repro_torch.kernels.slstm_scan import ops as slstm_ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import moe as moe_lib
    from repro_torch.launch.steps import mesh_ctx
    from repro_torch.optim import adamw

    t_phase = time.perf_counter()
    check(not dist.is_initialized(), "a process group exists before phase 21")
    # (a) -----------------------------------------------------------------------
    print("[21] the mesh route: (a) dry-run cells (accounting figures from a traced step on "
          "meta DTensors over a fake group, per device; no card work; terms on H100 constants)")
    for arch, shape, multi in MESH_DRYRUN_CELLS:
        t0 = time.perf_counter()
        res = dryrun.run_cell(arch, shape, multi_pod=multi, print_analysis=False)
        check(not dist.is_initialized(), f"run_cell left a process group ({arch} {shape})")
        if "skipped" in res:
            check(not get_config(arch).is_sub_quadratic and shape == "long_500k",
                  f"{arch} {shape} skipped")
            print(f"  {arch:<22} {shape:<12} skipped: {res['skipped'][:60]}")
            continue
        mem, t = res["memory"], res["terms_s"]
        print(f"  {arch:<22} {shape:<12} {res['mesh']:<8} args "
              f"{mem['argument_size_in_bytes'] / 1e9:.2f} GB + peak "
              f"{mem['peak_live_bytes'] / 1e9:.2f} GB a device, fits 80 GB "
              f"{'yes' if res['fits_80gb'] else 'no'}; compute {t['compute']:.4f} s, memory "
              f"{t['memory']:.4f} s, collective {t['collective']:.4f} s -> {res['dominant']}; "
              f"6ND/counted {res['useful_flops_ratio']:.3f}; collectives "
              f"{res['collective_bytes_per_device'] / 1e9:.2f} GB a device; traced depths "
              f"{res['traced_depths']}; wall {time.perf_counter() - t0:.1f} s")
        check(all(math.isfinite(v) and v >= 0 for v in t.values())
              and res["flops_per_device"] > 0, f"{arch} {shape}: terms {t}")
    wall["mesh_dryrun_s"] = time.perf_counter() - t_phase

    # (b) -----------------------------------------------------------------------
    t0 = time.perf_counter()
    qwen = get_config("qwen1.5-0.5b")
    rg = get_config("recurrentgemma-2b")
    rg = dataclasses.replace(rg, n_layers=MESH_RG_LAYERS,
                             block_pattern=rg.resolved_block_pattern[:MESH_RG_LAYERS])
    gr = dataclasses.replace(get_config("granite-moe-1b-a400m"), n_layers=MESH_MOE_LAYERS)
    xl = get_config("xlstm-125m")
    xl = dataclasses.replace(xl, n_layers=MESH_XL_LAYERS,
                             block_pattern=xl.resolved_block_pattern[:MESH_XL_LAYERS])
    n_rec = rg.resolved_block_pattern.count("rglru")
    n_sl = xl.resolved_block_pattern.count("slstm")
    cases = (("qwen1.5-0.5b, full width and depth", qwen, {}),
             (f"recurrentgemma-2b, first {MESH_RG_LAYERS} layers", rg,
              {"rglru_scan": 2 * n_rec, "rglru_scan_bwd": n_rec}),
             (f"granite-moe-1b-a400m, first {MESH_MOE_LAYERS} layers", gr, {}),
             (f"xlstm-125m, first {MESH_XL_LAYERS} blocks", xl,
              {"slstm_scan": 2 * n_sl, "slstm_scan_bwd": n_sl, "slstm_scan_bwd_rest": n_sl}))
    all_ops = (flash_ops, decode_ops, scan_ops, slstm_ops)
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    b5 = {"rglru_scan": 0, "rglru_scan_bwd": 0, "slstm_scan": 0, "slstm_scan_bwd": 0,
          "slstm_scan_bwd_rest": 0}
    torch.cuda.set_device(0)  # the rank's card, before the mesh's communicator
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
            print(f"  (b) a one-rank NCCL group, a 1 x 1 (data, model) mesh on the card; "
                  f"{smi}")
            for label, cfg, want in cases:
                opt = adamw.AdamWConfig(lr=TRAIN_LR)
                params = M.init_params(cfg, seed=TRAIN_SEED, device="cuda")
                batch = {k: torch.as_tensor(v, device="cuda") for k, v in
                         SyntheticLM(cfg.vocab_size, TRAIN_S, TRAIN_B,
                                     seed=TRAIN_SEED).batch_at(0).items()}
                ref, ref_m = make_train_step(cfg, opt, device="cuda", remat=True)(
                    {"params": params, "opt": adamw.init_opt_state(params, opt)}, batch)
                ref = _dtensor_full(ref)

                def place(tree, specs):
                    if isinstance(tree, dict):
                        return {k: place(v, specs[k]) for k, v in tree.items()}
                    if isinstance(tree, list):
                        return [place(v, sp) for v, sp in zip(tree, specs)]
                    return distribute_tensor(tree, specs.mesh, list(specs.placements))

                pd = place(params, partition.shardings(partition.param_specs(params, mesh, cfg),
                                                        mesh))
                bd = place(batch, partition.shardings(partition.batch_specs(batch, mesh, cfg),
                                                       mesh))
                if cfg.is_moe:
                    route = moe_lib.moe_route(mesh_ctx(mesh, cfg), cfg, TRAIN_B, TRAIN_S)
                    check(route[0] == "a2a", f"{label}: MoE route {route}")
                for ops in all_ops:
                    ops.reset_launches()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                new, met = make_train_step(cfg, opt, device="cuda", remat=True, mesh=mesh)(
                    {"params": pd, "opt": adamw.init_opt_state(pd, opt)}, bd)
                new, met = _dtensor_full(new), _dtensor_full(met)
                torch.cuda.synchronize()
                step_s = time.perf_counter() - t1
                launches = {k: v for ops in all_ops for k, v in ops.LAUNCHES.items() if v}
                check(launches == want, f"{label}: mesh step launched {launches}, not {want}")
                for k in b5:
                    b5[k] += launches.get(k, 0)
                diffs = [(a != b).sum().item() for a, b in
                         zip(_leaves(ref), _leaves(new))]
                same = (sum(diffs) == 0 and all(torch.equal(ref_m[k], met[k])
                                                 for k in ("loss", "grad_norm", "lr")))
                check(same, f"{label}: the mesh step differs from the mesh-less one: loss "
                      f"{float(met['loss'])} vs {float(ref_m['loss'])}, {sum(diffs)} elements "
                      f"of {sum(t.numel() for t in _leaves(ref))} differ")
                print(f"  {label}: loss {float(met['loss']):.6f}, grad norm "
                      f"{float(met['grad_norm']):.4f}, every one of "
                      f"{sum(t.numel() for t in _leaves(ref)):,} state elements equal to the "
                      f"mesh-less step's bit for bit; launches {launches or 'none'}; mesh step "
                      f"{step_s:.2f} s (first, with DTensor's dispatch)")
                del params, pd, bd, ref, new, batch
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
            torch.use_deterministic_algorithms(det)
    check(not dist.is_initialized(), "phase 21 left a process group")
    wall["mesh_train_s"] = time.perf_counter() - t0
    wall["phase_21_s"] = time.perf_counter() - t_phase
    print(f"  phase 21 wall {wall['phase_21_s']:.1f} s (dry-run cells "
          f"{wall['mesh_dryrun_s']:.1f} s)")
    return b5


# Phase 22: the paper's three machine types at 91 times 20/70/90 machines,
# past every kernel's one-block layout; a 6 240-task topology (the
# multi-tenant x4 fleet's task count) for the policy sweep; the refine's
# small placement on the last machines of type 1 and the first of type 2.
WIDE_COUNTS = (20 * 91, 70 * 91, 90 * 91)
WIDE_SWEEP_INSTANCES = (40, 2000, 2100, 2100)
WIDE_REFINE_INSTANCES, WIDE_REFINE_START = (1, 1, 1, 1), 8188
WIDE_REFINE_B2_LAUNCHES = 4
# The repo's usual policy sweep (6 traces x 256 placements), timed on the
# wide cluster: more resident blocks' slabs than the L2 holds.
WIDE_FULL_SWEEP = (6, 256)
# cut_traffic's second timed cluster: the three types at 45 x 20/70/90,
# 8 100 machines, where its list layout starts well before 16 380.
MID_COUNTS = (900, 3150, 4050)
# A copy of an earlier revision's csrc/cut_traffic.cu (its C entry without
# the list layout's operands), put here by hand, for example with ``git show
# REV:src/repro_torch/kernels/cut_traffic/csrc/cut_traffic.cu``; where it
# exists, phase 22 builds it and times it at the 8 100-machine shape.
PARENT_CUT_SOURCE = ROOT / "build" / "parent" / "cut_traffic.cu"
# A copy of the previous revision's sLSTM source, timed in phase 23 where it lies.
PARENT_SLSTM_SOURCE = ROOT / "build" / "parent" / "slstm_scan.cu"


def scan_problem(torch, np, device, seed, B, P_, W, counts, m):
    """Random ``policy_scan`` operands of a linear topology with ``counts``
    tasks a component on m machines (every 13th task on an id outside [0,
    m); machine 0 fails half way; spout tasks offered 4 to 32 tuples a
    second against 2 to 6 CPU points a machine)."""
    from repro_torch.kernels.policy_scan import ops as scan_ops

    rng = np.random.default_rng(seed)
    offsets = tuple(int(x) for x in np.concatenate([[0], np.cumsum(counts)]))
    n, T = len(counts), offsets[-1]
    topo = scan_ops.ScanTopology(offsets=offsets, alpha=(1.0, 1.2, 0.9, 1.1)[:n],
                                 sources=(True,) + (False,) * (n - 1),
                                 parents=((),) + tuple((c - 1,) for c in range(1, n)))
    tm = rng.integers(0, m, size=(P_, T))
    tm[:, ::13] = m + 1
    caps = rng.uniform(2.0, 6.0, size=(B, W, m))
    caps[:, W // 2:, 0] = 0.0
    host = (rng.uniform(1.0, 8.0, size=(B, W)) * 4.0 * counts[0], caps, tm.astype(np.int32),
            rng.uniform(0.5, 2.0, size=(P_, T)), rng.uniform(0.0, 0.3, size=(P_, T)),
            np.zeros((B, W, 0)))
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in host), topo


# Phase 22 (d)'s edge shapes of the scorer's table layout (and, past it,
# the machine tiles), and of the policy sweep's global-state instance; the
# `cuda` tests hold the kernels to the same cases.
TABLE_EDGES = ("one machine", "distinct machines", "ids outside", "untouched cap < 0",
               "untouched mem_cap < 0", "per-row capacity, zero net row",
               "at the table boundary", "past the table boundary",
               "past the table boundary, memory and network")
# (B, P, W, counts, m, placement): the linear topology's tasks a component
# and where they sit ("random": scan_problem's; "one": all on machine 5;
# "all": every machine holds one, the tasks past m on ids outside [0, m)).
# The task counts sit at the global-state instance's shared-memory splits
# (csrc/policy_scan.cu's GlobalLayout, ops.global_split): at 16 380 machines
# 7 702 tasks' state fits beside the small state and 7 703 do not; at 180
# machines the per-machine state fits beside 7 445 tasks' and not 7 446's.
SCAN_EDGES = {
    "one machine occupied": (2, 3, 10, (10, 10, 10, 10), 16_380, "one"),
    "every machine occupied": (2, 2, 6, (1, 2000, 2000, 1999), 4_000, "all"),
    "per-task state at its split": (1, 2, 4, (1, 2567, 2567, 2567), 16_380, "random"),
    "per-task state past its split": (1, 2, 4, (2, 2567, 2567, 2567), 16_380, "random"),
    "per-machine state at its split": (1, 2, 4, (2, 2481, 2481, 2481), 180, "random"),
    "per-machine state past its split": (1, 2, 4, (3, 2481, 2481, 2481), 180, "random"),
}


def table_edge_problem(np, ops, case, m, B=24, T=478):
    """The scorer's operands for one of TABLE_EDGES on m machines: rows of T
    tasks (at the boundary cases, the table's most tasks and one more)."""
    flags = dict(memory="mem" in case or "per-row" in case,
                 network="net" in case, cap_rows="per-row" in case)
    if "boundary" in case:
        T = ops.max_table_tasks(m, flags["memory"], False, False) + ("past" in case)
    args, extras = scoring_problem(np, 2300 + TABLE_EDGES.index(case), B, T, m, 4,
                                   outside=case == "ids outside", **flags)
    tm, comp, uir, e_cm, met_cm, cap = args
    rng = np.random.default_rng(TABLE_EDGES.index(case))
    if case == "one machine":  # one slot, T rounds a row
        tm[:] = (np.arange(B) * 7919 % m)[:, None]
    elif case == "distinct machines":
        tm[:] = np.stack([rng.choice(m, T, replace=False) for _ in range(B)])
    elif case.startswith("untouched"):
        # Machine m - 1 fails every row (cap < 0, or memory capacity < 0);
        # only row 5 touches it. Machine m - 3's -0.0 fails none.
        tm[tm >= m - 3] = 7
        tm[5, 0] = m - 1
        if "mem_cap" in case:
            extras["mem_capacity"] = extras["mem_capacity"].copy()
            extras["mem_capacity"][[m - 1, m - 3]] = (-0.5, -0.0)
        else:
            cap[[m - 1, m - 3]] = (-1.0, -0.0)
    elif case.startswith("per-row"):
        extras["net_var"][4] = 0.0
    return (tm, comp, uir, e_cm, met_cm, cap), extras


def scan_edge_problem(torch, np, device, case):
    """``policy_scan``'s operands for one of SCAN_EDGES (``scan_problem``'s,
    with the case's placement)."""
    B, P_, W, counts, m, placement = SCAN_EDGES[case]
    operands, topo = scan_problem(torch, np, device, 4000 + sum(counts), B, P_, W, counts, m)
    T = sum(counts)
    if placement == "one":
        operands[2][:] = 5
    elif placement == "all":
        tm = np.arange(T) * 7 % m
        tm[m::13] = m + 1
        operands[2][:] = torch.from_numpy(tm.astype(np.int32))
    return operands, topo


def touched_machines(np, tm, m):
    """The (row, machine) pairs of a (B, T) placement batch with a task on
    an id in [0, m): each row's distinct machines, summed."""
    rows = np.sort(np.where((tm >= 0) & (tm < m), tm, -1), axis=1)
    distinct = np.ones(rows.shape, dtype=bool)
    distinct[:, 1:] = rows[:, 1:] != rows[:, :-1]
    return int((distinct & (rows >= 0)).sum())


def wide_cut_shape(np, P, etg, cluster, rng, B=128):
    """cut_traffic's host operands of ``etg``'s placement on ``cluster`` (B
    rows, one task moved a row), its edges and six racks' distances."""
    base, m = etg.task_machine(), cluster.n_machines
    tm = np.tile(base, (B, 1))
    tm[np.arange(B), rng.integers(0, base.size, B)] = rng.integers(0, m, B)
    comp = etg.task_component()
    cir = P.component_rates(etg.utg, 1.0)
    host = (tm, comp, (cir / etg.n_instances)[comp], np.asarray(etg.utg.alpha, dtype=np.float64),
            cir)
    return host, etg.utg.edges, P.rack_distance_matrix(np.arange(m) % 6, 1.0, 2.0)


def same_or_nan(torch, a, b):
    """Equal where not NaN, NaN in the same places."""
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(torch.where(nan, 0.0, a), torch.where(nan, 0.0, b)))


def list_lengths(torch, np, cut_ops, g_args, edges, g_dist):
    """The list layout's list lengths (groups x lists) of these operands,
    from the host mirror ``cut_ops.list_columns``."""
    flags = (~torch.isfinite(g_dist)).any(0).cpu().numpy()
    tm, comp = g_args[0].cpu().numpy(), g_args[1].cpu().numpy()
    lists = cut_ops.list_columns(tm, comp, edges, g_args[3].shape[0], flags)
    return [[len(c) for c in g] for g in lists]


def parent_cut_kernel(torch):
    """The kernel of ``PARENT_CUT_SOURCE`` (built on first use) as a call
    on the wrapper's operands, or None where no copy is there."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels.cut_traffic import kernel as cut_kernel
    from repro_torch.kernels.cut_traffic import ops as cut_ops

    if not PARENT_CUT_SOURCE.exists():
        return None
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib = _build.load_library(PARENT_CUT_SOURCE, "cut_traffic_launch", [
        i32, p, p, i64, p, i64, p, p, p, p, p, i32, i32, p, ctypes.c_double, p, i64, i64, i32,
        i32, p], cut_kernel.NVCC_FLAGS)

    def run(tm, comp, uir, alpha, cir, edges, dist, penalty):
        (B, T), n, m = tm.shape, alpha.shape[0], dist.shape[0]
        send, recv, pairs, _, _, k2, _ = cut_ops._device_slots(tuple(edges), n, tm.device)
        out = torch.empty((B, m), dtype=torch.float64, device=tm.device)
        err = lib.cut_traffic_launch(
            tm.device.index or 0, tm.data_ptr(), comp.data_ptr(), comp.shape[-1] * (comp.ndim == 2),
            uir.data_ptr(), uir.shape[-1] * (uir.ndim == 2), alpha.data_ptr(), cir.data_ptr(),
            send.data_ptr(), recv.data_ptr(), pairs.data_ptr(), len(edges), k2, dist.data_ptr(),
            float(penalty), out.data_ptr(), B, T, n, m, torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"the parent cut_traffic kernel failed with CUDA error {err}")
        return out

    return run


# Calls of cut_traffic in the profiler window that splits one call's device
# time by kernel (phase 22).
SPLIT_CALLS = 20


def time_wide_cut(torch, np, cut_ops, cut_kernel, host, edges, dist, entry=None, parent=None):
    """cut_traffic's list layout on ``host``'s rows: held bit for bit
    against its plain version on the card (and ``entry``, the result of an
    entry point's call, and the kernel of ``parent`` where given), rerun
    bit-identical, timed beside its plain version and ``parent`` (3 runs each);
    its plan, list lengths, bound (``cut_work``) and timing record."""
    from torch.autograd import DeviceType

    from repro_torch.kernels.cut_traffic.ref import cut_traffic_ref
    from repro_torch.launch.profile_serve import whole_trace
    from repro_torch.launch.timing import time_cuda

    tm, comp = host[:2]
    (B, T), m = tm.shape, dist.shape[0]
    g_args, g_dist = cut_tensors(torch, np, "cuda", host, dist)
    got = cut_ops.cut_traffic(*g_args, edges, g_dist, 0.05)
    again = cut_ops.cut_traffic(*g_args, edges, g_dist, 0.05)
    want = cut_traffic_ref(*g_args, edges, g_dist, 0.05)
    torch.cuda.synchronize()
    check(torch.equal(got, want) and torch.equal(got.view(torch.int64), again.view(torch.int64))
          and (entry is None or torch.equal(entry, got)),
          f"cut_traffic at m={m} differs from its plain version or its rerun")
    ms = time_cuda(lambda: cut_ops.cut_traffic(*g_args, edges, g_dist, 0.05))
    plain_ms = time_cuda(lambda: cut_traffic_ref(*g_args, edges, g_dist, 0.05), reps=3)
    parent_ms = None
    if parent is not None:
        check(torch.equal(parent(*g_args, edges, g_dist, 0.05), got),
              f"the parent cut_traffic kernel at m={m} differs")
        parent_ms = time_cuda(lambda: parent(*g_args, edges, g_dist, 0.05), reps=3)
    # Where one call's device time goes, by kernel (warm L2): SPLIT_CALLS
    # calls in one profiler window, each kernel's median record times its
    # records a call. Late in a long process the profiler drops device
    # records of a short window (ROADMAP C-port-7); a window of many calls
    # keeps most of them, and one without device activity is taken once
    # more (``whole_trace``); where the second has none either, the line
    # says why.
    def split_trace():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(SPLIT_CALLS):
                cut_ops.cut_traffic(*g_args, edges, g_dist, 0.05)
            torch.cuda.synchronize()
        records = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
                name = re.search(r"\w+_kernel|Memset", e.name)
                key = name.group() if name else e.name[:40]
                records.setdefault(key, []).append((e.time_range.end - e.time_range.start) / 1e3)
        return list(records), [], records

    try:
        records, why = whole_trace(split_trace, {}), None
    except RuntimeError as err:  # two traces without device activity
        records, why = {}, str(err)
    split = {k: statistics.median(v) * max(1, round(len(v) / SPLIT_CALLS))
             for k, v in records.items()}
    k2 = len({a for a, _ in edges}) + len({b for _, b in edges})
    flops, dist_bytes = cut_work(np, tm, comp, edges, m)
    n_bytes = sum(x.numel() * x.element_size() for x in g_args) + dist_bytes + B * m * 8
    bound = _bound(flops / FP64_FLOPS_PER_S, n_bytes / HBM_BYTES_PER_S)
    plan = cut_kernel.launch_plan(B, T, edges, m)
    lists = list_lengths(torch, np, cut_ops, g_args, edges, g_dist)
    print(f"  cut_traffic B={B} T={T} m={m} ({k2} contracted rows a row, {dist_bytes // (8 * m)} "
          f"machines hold tasks): {ms:.4f} ms, bound {bound[0]:.4f} ms by {bound[1]} "
          f"({flops / 1e9:.1f} GFLOP and {n_bytes / 1e6:.1f} MB that the rows' non-zero columns "
          f"need; {100 * bound[0] / ms:.2f}% of it), plain {plain_ms:.3f} ms, the previous "
          f"revision's kernel " + (f"{parent_ms:.4f} ms" if parent_ms is not None else
                                   "not timed (no copy at PARENT_CUT_SOURCE)")
          + "; library_ms null; equal to its plain version, rerun bit-identical")
    print(f"    layout {plan['layout']}: groups of {plan['rows']} rows, {plan['threads']} threads, "
          f"{plan['smem_bytes']} shared bytes, {plan['w_tile']}-machine by "
          f"{plan['tile_columns']}-column distance tiles, {plan['tile_stages']} in flight, "
          f"{plan['wave_rows']} rows a wave, {plan['scratch_bytes']} scratch bytes, lists of up "
          f"to {plan['list_capacity']} columns; list lengths (groups x lists) {lists}; "
          f"products by zero included, the dense product is {2 * B * k2 * m * m / 1e9:.1f} "
          f"GFLOP; " + _launch_text(torch, flops, plan["blocks"], plan["blocks_per_sm"],
                                   plan["registers"], plan["local_bytes"]))
    print(f"    device ms of one call by kernel (profiler, warm L2, {SPLIT_CALLS} calls, "
          f"{sum(len(v) for v in records.values())} device records): "
          + (", ".join(f"{k} {v:.4f}" for k, v in split.items()) if split else
             f"not measured ({why})"))
    return dict(shape=f"B={B} T={T} m={m} K2={k2}, groups of {plan['rows']}, w tiles of "
                f"{plan['w_tile']}", ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                bound_by=bound[1], library_ms=None, parent_ms=parent_ms,
                scratch_bytes=plan["scratch_bytes"])


def sm_clock_hz():
    """The card's top SM clock (nvidia-smi's clocks.max.sm)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


# Latency of a dependent FP64 add on an H100, in cycles: the policy sweep's
# totals are three chains of T such adds a window. An estimate, not measured
# by this script: the serial floor built on it is printed beside the bound
# and kept out of the kernels record.
SERIAL_ADD_CYCLES = 8


def wide_phase(torch, np, P, ops, cut_ops, scan_ops, base_etg, wall):
    """Phase 22: the entry points on a 16 380-machine cluster, card against
    CPU; the kernels past their one-block layouts against their plain
    versions; timings. Returns {kernel: (launches, timing record)}."""
    import repro_torch.runtime_stream as RS
    from repro_torch.kernels.cut_traffic import kernel as cut_kernel
    from repro_torch.kernels.cut_traffic.ref import cut_traffic_ref
    from repro_torch.kernels.policy_scan import kernel as scan_kernel
    from repro_torch.kernels.policy_scan.ref import policy_scan_ref
    from repro_torch.kernels.sched_scoring.ref import sched_scoring_ref
    from repro_torch.launch.timing import time_cuda
    from repro_torch.runtime_stream.eval_torch import scan_operands

    t_phase = time.perf_counter()
    wide = P.paper_cluster(WIDE_COUNTS)
    m = wide.n_machines
    wide_mem = P.Cluster(machine_types=wide.machine_types, capacity=wide.capacity,
                         profile=wide.profile.with_mem(np.array([0.5, 1.0, 1.5, 2.0])),
                         mem_capacity=np.full(m, 8.0))
    print(f"[22] wide clusters: paper_cluster({WIDE_COUNTS}), {m} machines")
    rng = np.random.default_rng(22)
    launches = {}

    # (a) max_stable_rate_batch at 16 384 x 478: B1, machine-tiled.
    T = base_etg.total_tasks
    batch = rng.integers(0, m, size=(16_384, T))
    ops.reset_launches()
    t0 = time.perf_counter()
    rates_gpu, thpt_gpu = P.max_stable_rate_batch(base_etg, wide, batch, device="cuda")
    wall["wide_sweep_s"] = time.perf_counter() - t0
    launches["sched_scoring"] = ops.LAUNCHES["sched_scoring"]
    t0 = time.perf_counter()
    rates_cpu, thpt_cpu = P.max_stable_rate_batch(base_etg, wide, batch, device="cpu")
    wall["wide_sweep_cpu_s"] = time.perf_counter() - t0
    check(launches["sched_scoring"] == 1, "the wide sweep did not launch B1 once")
    check(np.array_equal(rates_gpu, rates_cpu) and np.array_equal(thpt_gpu, thpt_cpu),
          "max_stable_rate_batch on the wide cluster: the card differs from the CPU")
    slots = ops.table_slots(T, m, False, False, False)
    print(f"  max_stable_rate_batch {batch.shape[0]} x {T} on {m} machines (B1, a table of "
          f"{slots} slots a row): 1 launch, equal to device='cpu'; {wall['wide_sweep_s']:.3f} s "
          f"host to host "
          f"(cpu {wall['wide_sweep_cpu_s']:.3f} s); R* {rates_gpu.min():.4f}-{rates_gpu.max():.4f}")

    # (b) refine of a small placement, memory on: B2, machine-tiled.
    tiny = P.round_robin_schedule(P.linear_topology(), wide_mem,
                                  np.array(WIDE_REFINE_INSTANCES), start=WIDE_REFINE_START)
    ops.reset_launches()
    t0 = time.perf_counter()
    ref_gpu = P.refine(tiny, wide_mem, max_rounds=1, allow_add=False, device="cuda")
    torch.cuda.synchronize()
    wall["wide_refine_s"] = time.perf_counter() - t0
    launches["sched_scoring_resources"] = ops.LAUNCHES["sched_scoring_resources"]
    t0 = time.perf_counter()
    ref_cpu = P.refine(tiny, wide_mem, max_rounds=1, allow_add=False, device="cpu")
    wall["wide_refine_cpu_s"] = time.perf_counter() - t0
    check(launches["sched_scoring_resources"] == WIDE_REFINE_B2_LAUNCHES
          and ops.LAUNCHES["sched_scoring"] == 0,
          f"the wide refine's launches {dict(ops.LAUNCHES)}: {WIDE_REFINE_B2_LAUNCHES} B2 "
          f"expected, and B2 alone")
    check(ref_gpu.moves == ref_cpu.moves and ref_gpu.throughput == ref_cpu.throughput
          and np.array_equal(ref_gpu.etg.task_machine(), ref_cpu.etg.task_machine()),
          "refine on the wide cluster: the card differs from the CPU")
    check(len(ref_gpu.moves) == 1, f"the wide refine made no move ({ref_gpu.moves})")
    print(f"  refine(max_rounds=1, allow_add=False) of {tiny.total_tasks} tasks on {m} machines "
          f"with memory: moves {ref_gpu.moves}, throughput {ref_gpu.throughput!r}, "
          f"{launches['sched_scoring_resources']} B2 launches, equal to device='cpu' "
          f"({wall['wide_refine_s']:.3f} s; cpu {wall['wide_refine_cpu_s']:.3f} s)")

    # (c) evaluate_policies_batch of a 6 240-task topology: policy_scan with
    # the pairs' state in its global scratch.
    sweep_etg = P.round_robin_schedule(P.linear_topology(), wide,
                                       np.array(WIDE_SWEEP_INSTANCES))
    Ts = sweep_etg.total_tasks
    rate, _ = P.max_stable_rate(sweep_etg, wide)
    W = 24
    traces = [RS.ramp_trace(0.3 * rate, 1.6 * rate, n_windows=W).compile(wide, seed=1),
              RS.failure_trace(0.9 * rate, machine=0, n_windows=W).compile(wide, seed=2),
              RS.burst_trace(0.7 * rate, n_windows=W).compile(wide, seed=3)]
    policies = np.tile(sweep_etg.task_machine(), (16, 1))
    for p in range(1, 16):
        policies[p, rng.integers(0, Ts, 3)] = rng.integers(0, m, 3)
    cfg = RS.RuntimeConfig(max_queue=120.0)
    scan_ops.reset_launches()
    t0 = time.perf_counter()
    sweep = RS.evaluate_policies_batch(sweep_etg, wide, traces, policies, config=cfg,
                                       device="cuda")
    wall["wide_policy_sweep_s"] = time.perf_counter() - t0
    launches["policy_scan"] = scan_ops.LAUNCHES["policy_scan"]
    t0 = time.perf_counter()
    sweep_cpu = RS.evaluate_policies_batch(sweep_etg, wide, traces, policies, config=cfg,
                                           device="cpu")
    wall["wide_policy_sweep_cpu_s"] = time.perf_counter() - t0
    check(launches["policy_scan"] == 1, "the wide sweep did not launch policy_scan once")
    for field in ("throughput", "admitted", "dropped", "queue_total", "throttle",
                  "machine_util_mean", "sustained"):
        check(np.array_equal(getattr(sweep, field), getattr(sweep_cpu, field)),
              f"evaluate_policies_batch on the wide cluster: {field} differs from the CPU")
    n_parents = 3
    check(scan_ops.state_in_global(Ts, m, 4, 0, n_parents), "the wide sweep fits one block")
    print(f"  evaluate_policies_batch {len(traces)} traces x {policies.shape[0]} placements x "
          f"{W} windows, {Ts} tasks on {m} machines (the pairs' state in the global scratch): "
          f"1 launch, equal to device='cpu' ({wall['wide_policy_sweep_s']:.3f} s; cpu "
          f"{wall['wide_policy_sweep_cpu_s']:.3f} s); sustained "
          f"{float(sweep.sustained.min()):.4f}-{float(sweep.sustained.max()):.4f}")

    # (d) the kernels past their one-block layouts against their plain versions.
    for label, kw in (("B1, shared maps", dict(n=4)),
                      ("B1, per-row maps", dict(n=4, per_row=True)),
                      ("B2, memory + network", dict(n=4, memory=True, network=True)),
                      ("B2, memory + network, per-row maps",
                       dict(n=4, per_row=True, memory=True, network=True))):
        use_mem, per_row = kw.get("memory", False), kw.get("per_row", False)
        width, _ = ops.machine_tiles(m, use_mem, per_row, per_row)
        limit = ops.max_machines(use_mem, per_row, per_row)
        for m_case in (m, (limit // width + 1) * width + 1):
            # 478 tasks take the table; one task past its most, the machine tiles.
            tiled_T = ops.max_table_tasks(m_case, use_mem, per_row, per_row) + 1
            for T_case in (478, tiled_T):
                args, extras = scoring_problem(np, 2200 + m_case % 97, 64, T_case, m_case, **kw)
                compare_kernel(torch, np, ops, args, extras, rerun=True)
                slots = ops.table_slots(T_case, m_case, use_mem, per_row, per_row)
                layout = (f"a table of {slots} slots a row" if slots else
                          f"{ops.machine_tiles(m_case, use_mem, per_row, per_row)[1]} tiles "
                          f"of {width}")
                print(f"  {label} m={m_case} T={T_case} ({layout}): equal to its plain "
                      f"version, rerun bit-identical")
    for case in TABLE_EDGES:
        args, extras = table_edge_problem(np, ops, case, m)
        _, n_zero = compare_kernel(torch, np, ops, args, extras, rerun=True)
        T_case = args[0].shape[1]
        flags = ("mem_capacity" in extras, False, False)
        slots = ops.table_slots(T_case, m, *flags)
        layout = (f"a table of {slots} slots" if slots else
                  f"{ops.machine_tiles(m, *flags)[1]} machine tiles")
        print(f"  B{2 if extras else 1} {case}, T={T_case} ({layout}): equal to its plain "
              f"version, rerun bit-identical; {n_zero} infeasible rows")
    for topology, m_case, B in (("diamond", 14_501, 3), ("linear", m, 2)):
        args, edges, _ = cut_problem(np, P, 2210 + B, topology, B, 6, "per_row")
        tm = rng.integers(0, m_case, size=args[0].shape)
        tm[:, 1] = m_case - 1
        g_args, _ = cut_tensors(torch, np, "cuda", (tm, *args[1:]), np.zeros((1, 1)))
        racks = torch.arange(m_case, device="cuda") % 6
        g_dist = torch.where(racks[:, None] == racks[None, :], 1.0, 2.0).to(torch.float64)
        g_dist.fill_diagonal_(0.0)
        got = cut_ops.cut_traffic(*g_args, edges, g_dist, 0.05)
        want = cut_traffic_ref(*g_args, edges, g_dist, 0.05)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"cut_traffic at m={m_case} differs from its plain version")
        plan = cut_kernel.launch_plan(B, tm.shape[1], edges, m_case)
        print(f"  cut_traffic {topology} m={m_case} B={B}: layout {plan['layout']}, distance tiles "
              f"of {plan['w_tile']} machines by {plan['tile_columns']} listed columns; equal to "
              f"its plain version on the card")
        del g_dist, racks
    for label, (B, P_, W_, counts, m_case) in (
            ("6 240 tasks on 180 machines", (3, 5, 12, (40, 2000, 2100, 2100), 180)),
            (f"40 tasks on {m} machines", (2, 3, 10, (10, 10, 10, 10), m)),
            ("65 536 traces", (65_536, 1, 2, (1, 1, 1, 1), 3)),
            ("past 65 535 groups of 6 traces", (6 * 65_535 + 7, 2, 2, (1, 1, 1, 1), 3)),
            *((edge, SCAN_EDGES[edge][:5]) for edge in SCAN_EDGES)):
        if label in SCAN_EDGES:
            gpu, topo = scan_edge_problem(torch, np, "cuda", label)
            label += (f", {sum(counts)} tasks on {m_case} machines, in shared memory "
                      f"(tasks, machines): {scan_ops.global_split(sum(counts), m_case, 4, 0, 3)}")
        else:
            gpu, topo = scan_problem(torch, np, "cuda", sum(counts), B, P_, W_, counts, m_case)
        cfg_k = scan_ops.ScanConfig(max_queue=60.0)
        got = scan_ops.policy_scan(*gpu, topo, cfg_k)
        again = scan_ops.policy_scan(*gpu, topo, cfg_k)
        torch.cuda.synchronize()
        plain = scan_ops.policy_scan(*(x.cpu() for x in gpu), topo, cfg_k)
        for name, g, a, w in zip(got._fields, got, again, plain):
            check(torch.equal(g, a) and torch.equal(g.cpu(), w),
                  f"policy_scan ({label}): {name} differs from its plain version or its rerun")
        print(f"  policy_scan {label} (B={B} P={P_} W={W_}): equal to its plain version on the "
              f"CPU, rerun bit-identical")

    # (e) timings (CUDA events, cold L2, median of 15; plain versions of 3-5).
    print("  timings past the one-block layouts (CUDA events, cold L2, median)")
    timings = {}
    state = P.ScheduleState.from_etg(base_etg, wide)
    comp = np.repeat(np.arange(base_etg.utg.n_components), base_etg.n_instances)
    uir = (state.cir_unit / base_etg.n_instances)[comp]
    e_cm, met_cm = state.e_cm, state.met_cm
    for key, B, extras in (
        ("sched_scoring", 16_384, {}),
        ("sched_scoring_resources", 4_096,
         dict(net_var=rng.uniform(0.0, 0.2, size=(4_096, m)),
              mem_c=np.array([0.5, 1.0, 1.5, 2.0]), mem_capacity=np.full(m, 8.0))),
    ):
        host = (batch[:B], comp, uir, e_cm, met_cm, wide.capacity)
        if extras:
            compare_kernel(torch, np, ops, host, extras)  # at the timed shape
        g_args, g_kw = to_tensors(torch, np, "cuda", host, extras)
        ms = time_cuda(lambda: ops.sched_scoring(*g_args, **g_kw))
        plain_ms = time_cuda(lambda: sched_scoring_ref(*g_args, **g_kw), reps=5)
        n_bytes = sum(x.numel() * x.element_size() for x in (*g_args, *g_kw.values())) + B * 8
        # The needed work: 3 operations a task, and the finalize (4 a
        # machine) of each row's touched machines; with a (B, m) operand
        # (net_var here) every machine of a row finalizes.
        finals = B * m if "net_var" in extras else touched_machines(np, batch[:B], m)
        flops = B * T * 3 + finals * 4
        bound = _bound(flops / FP64_FLOPS_PER_S, n_bytes / HBM_BYTES_PER_S)
        dense = _bound((B * T * 3 + B * m * 4) / FP64_FLOPS_PER_S, n_bytes / HBM_BYTES_PER_S)
        slots = ops.table_slots(T, m, bool(extras), False, False)
        timings[key] = dict(shape=f"B={B} T={T} m={m}, a table of {slots} slots a row", ms=ms,
                            plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                            library_ms=None)
        print(f"  {key} B={B} T={T} m={m} (a table of {slots} slots a row): {ms:.4f} ms, bound "
              f"{bound[0]:.4f} ms by {bound[1]} ({100 * bound[0] / ms:.1f}% of it; {finals} "
              f"machines finalized; the dense count over every (row, machine): "
              f"{dense[0]:.4f} ms by {dense[1]}), plain {plain_ms:.3f} ms; library_ms null")
        del g_args, g_kw
    # cut_traffic on rows of the 6 240-task placement, one task moved a row:
    # thousands of non-zero columns of X a row; on 16 380 machines, then on
    # 8 100 through ``network_unit_load`` (the launch counted) beside the
    # previous revision's kernel where its copy is built (PARENT_CUT_SOURCE).
    cut_kw = dict(torch=torch, np=np, cut_ops=cut_ops, cut_kernel=cut_kernel)
    host, edges, dist = wide_cut_shape(np, P, sweep_etg, wide, rng)
    timings["cut_traffic"] = time_wide_cut(**cut_kw, host=host, edges=edges, dist=dist)
    tm_c = host[0]
    print(f"    scratch bytes at B=128: {timings['cut_traffic']['scratch_bytes']}; at B=65 520 "
          f"(a 4-task refine's rows): "
          f"{cut_kernel.launch_plan(65_520, tm_c.shape[1], edges, m)['scratch_bytes']}")
    # The non-finite rule: an inf and a NaN in columns no task occupies.
    g_args, g_dist = cut_tensors(torch, np, "cuda", tuple(x[:2] if np.ndim(x) == 2 else x
                                                          for x in host), dist)
    free = np.setdiff1d(np.arange(m), tm_c[:2])
    g_dist[3, int(free[-1])] = float("inf")
    g_dist[int(free[0]), int(free[len(free) // 2])] = float("nan")
    got = cut_ops.cut_traffic(*g_args, edges, g_dist, 0.05)
    again = cut_ops.cut_traffic(*g_args, edges, g_dist, 0.05)
    want = cut_traffic_ref(*g_args, edges, g_dist, 0.05)
    nan_at = torch.isnan(got).any(0).nonzero().flatten().tolist()
    check(same_or_nan(torch, got, want) and same_or_nan(torch, got, again)
          and nan_at == sorted((3, int(free[0]))),
          "cut_traffic with non-finite unoccupied columns differs from its plain version")
    lists = list_lengths(torch, np, cut_ops, g_args, edges, g_dist)
    print(f"  cut_traffic B=2 m={m}, an inf in column {int(free[-1])} and a NaN in column "
          f"{int(free[len(free) // 2])}, no task on either: NaN at machines {nan_at}, as its "
          f"plain version (equal, rerun bit-identical); list lengths {lists}")
    del g_dist, g_args, got, again, want
    mid = P.paper_cluster(MID_COUNTS)
    mid_etg = P.round_robin_schedule(P.linear_topology(), mid, np.array(WIDE_SWEEP_INSTANCES))
    host, edges, dist = wide_cut_shape(np, P, mid_etg, mid, rng)
    cut_ops.reset_launches()
    net = P.cost_model.network_unit_load(*host, edges, dist, 0.05, device="cuda")
    torch.cuda.synchronize()
    launches["cut_traffic"] = cut_ops.LAUNCHES["cut_traffic"]
    check(launches["cut_traffic"] == 1, "network_unit_load did not launch cut_traffic once")
    timings["cut_traffic"]["mid_cluster"] = time_wide_cut(**cut_kw, host=host, edges=edges,
                                                         dist=dist, entry=net,
                                                         parent=parent_cut_kernel(torch))
    del net
    operands, topo, scfg = scan_operands(sweep_etg, wide, traces, policies, cfg,
                                         torch.device("cuda"))
    ms = time_cuda(lambda: scan_ops.policy_scan(*operands, topo, scfg))
    plain_ms = time_cuda(lambda: policy_scan_ref(*operands, topo, scfg), reps=3)
    out = scan_ops.policy_scan(*operands, topo, scfg)
    Bt, Pt = len(traces), policies.shape[0]
    # The needed work a window: 23 operations a task, 5 a machine that holds
    # a task (the dense count: 5 a machine, empty or not), 2 a share.
    occupied = touched_machines(np, policies, m)
    flops = Bt * W * (Pt * (23 * Ts + 2 * topo.n_shares) + 5 * occupied)
    n_bytes = sum(x.numel() * x.element_size() for x in (*operands, *out))
    bound = _bound(flops / FP64_FLOPS_PER_S, n_bytes / HBM_BYTES_PER_S)
    dense = _bound(Bt * Pt * W * (23 * Ts + 5 * m + 2 * topo.n_shares) / FP64_FLOPS_PER_S,
                   n_bytes / HBM_BYTES_PER_S)
    smem = scan_ops.global_smem_bytes(Ts, m, 4, 0, n_parents)
    occ = scan_kernel.occupancy(Bt, Pt, 0, smem)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = sm_clock_hz()
    floor_pair = W * Ts * SERIAL_ADD_CYCLES / clock * 1e3
    rounds = -(-Bt * Pt // (sms * max(occ["blocks_per_sm"], 1)))
    timings["policy_scan"] = dict(shape=f"B={Bt} P={Pt} W={W} T={Ts} m={m}, global-state "
                                  f"instance", ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                                  bound_by=bound[1], library_ms=None)
    print(f"  policy_scan B={Bt} P={Pt} W={W} T={Ts} m={m}: {ms:.4f} ms, bound {bound[0]:.4f} ms "
          f"by {bound[1]} ({100 * bound[0] / ms:.1f}% of it; {occupied / Pt:.1f} occupied "
          f"machines a placement; the dense count over every machine: {dense[0]:.4f} ms), "
          f"serial floor {floor_pair * rounds:.4f} ms ({W} x {Ts} dependent adds x "
          f"{SERIAL_ADD_CYCLES} cycles at {clock / 1e6:.0f} MHz a pair, {rounds} round(s) of "
          f"resident blocks), plain {plain_ms:.3f} ms; library_ms null")
    print(f"    one pair a block at a time, {occ['threads']} threads, {smem} shared bytes "
          f"(per-task, per-machine state in shared memory: "
          f"{scan_ops.global_split(Ts, m, 4, 0, n_parents)}), "
          f"{scan_ops.slab_bytes(Ts, m, 4, 0, n_parents)} bytes of slab a block; "
          + _launch_text(torch, flops, occ["blocks"], occ["blocks_per_sm"], occ["registers"],
                         occ["local_bytes"]))
    # The repo's usual sweep size: more pairs than resident blocks, and
    # their slabs together past the 50 MB L2. Its first 3 x 16 pairs are the
    # sweep above, which they must equal.
    n_tr, n_pl = WIDE_FULL_SWEEP
    full_traces = traces + [
        RS.ramp_trace(0.3 * rate, 1.6 * rate, n_windows=W).compile(wide, seed=4),
        RS.failure_trace(0.9 * rate, machine=1, n_windows=W).compile(wide, seed=5),
        RS.burst_trace(0.7 * rate, n_windows=W).compile(wide, seed=6)]
    full_policies = np.tile(sweep_etg.task_machine(), (n_pl, 1))
    full_policies[:Pt] = policies
    for p in range(Pt, n_pl):
        full_policies[p, rng.integers(0, Ts, 3)] = rng.integers(0, m, 3)
    f_operands, _, _ = scan_operands(sweep_etg, wide, full_traces, full_policies, cfg,
                                     torch.device("cuda"))
    full = scan_ops.policy_scan(*f_operands, topo, scfg)
    for name, f, o in zip(out._fields, full, out):
        check(torch.equal(f[:Bt, :Pt], o), f"policy_scan {n_tr} x {n_pl}: {name} of its first "
              f"{Bt} x {Pt} pairs differs from the {Bt} x {Pt} sweep")
    full_ms = time_cuda(lambda: scan_ops.policy_scan(*f_operands, topo, scfg))
    occupied = touched_machines(np, full_policies, m)
    flops = n_tr * W * (n_pl * (23 * Ts + 2 * topo.n_shares) + 5 * occupied)
    n_bytes = sum(x.numel() * x.element_size() for x in (*f_operands, *full))
    bound = _bound(flops / FP64_FLOPS_PER_S, n_bytes / HBM_BYTES_PER_S)
    dense = _bound(n_tr * n_pl * W * (23 * Ts + 5 * m + 2 * topo.n_shares) / FP64_FLOPS_PER_S,
                   n_bytes / HBM_BYTES_PER_S)
    occ = scan_kernel.occupancy(n_tr, n_pl, 0, smem)
    slabs = occ["blocks"] * scan_ops.slab_bytes(Ts, m, 4, 0, n_parents)
    rounds = -(-n_tr * n_pl // occ["blocks"])
    timings["policy_scan"]["full_sweep"] = dict(
        shape=f"B={n_tr} P={n_pl} W={W} T={Ts} m={m}", ms=full_ms, bound_ms=bound[0],
        bound_by=bound[1], blocks=occ["blocks"], slab_bytes=slabs)
    print(f"  policy_scan B={n_tr} P={n_pl} W={W} T={Ts} m={m}: {full_ms:.4f} ms "
          f"({full_ms / (n_tr * n_pl):.4f} ms a pair against {ms / (Bt * Pt):.4f} at {Bt} x {Pt}), "
          f"bound {bound[0]:.4f} ms by {bound[1]} ({100 * bound[0] / full_ms:.2f}% of it; counting "
          f"every machine: {dense[0]:.4f} ms), serial floor {floor_pair * rounds:.4f} ms "
          f"({rounds} rounds of {floor_pair:.4f}); {occ['blocks']} resident blocks "
          f"({occ['blocks_per_sm']} a SM), their slabs {slabs / 1e6:.1f} MB against the 50 MB L2; "
          f"first {Bt} x {Pt} pairs equal to the sweep above")
    del f_operands, full
    wall["phase_22_s"] = time.perf_counter() - t_phase
    print(f"  phase 22: {wall['phase_22_s']:.1f} s")
    return {k: (launches.get(k, 0), timings[k]) for k in timings}


def _launch_text(torch, flops, blocks, per_sm, registers, local_bytes):
    """A redesigned kernel's launch, printed beside its time: the ceiling
    without FMA (every product and sum its own FP64 instruction, half the
    FP64 rate), registers and local (spilled) bytes a thread, resident blocks
    a SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the waves."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fma_free_ms = flops / (FP64_FLOPS_PER_S / 2) * 1e3
    return (f"ceiling without FMA {fma_free_ms:.4f} ms (half the FP64 rate); {registers} "
            f"registers, {local_bytes} local (spilled) bytes a thread; {per_sm} resident blocks "
            f"a SM, {blocks} blocks in {blocks / (sms * max(per_sm, 1)):.2f} waves")


# Phase 23: xLSTM training. xlstm-125m at full width and depth (12 blocks,
# six mLSTM and six sLSTM, d_model 768), phase 19's recipe (bf16 parameters,
# float32 AdamW moments, remat, TRAIN_B x TRAIN_S SyntheticLM tokens from
# TRAIN_SEED, the cosine schedule) over XL_TRAIN_STEPS steps through the
# Trainer; every sLSTM block's time loop in the slstm_scan kernel and its
# backward in slstm_scan_bwd. The float32 check runs the first
# XL_CHECK_LAYERS blocks (two mLSTM, two sLSTM).
XL_TRAIN_STEPS, XL_CHECK_LAYERS = 10, 4
# slstm_scan_bwd against its plain version on the card: every gradient
# within SLSTM_BWD_TOL of its max-abs, NaN where the plain version has NaN.
# On the CPU at (8, 512, 768) the plain version (``slstm_scan_bwd_ref``, the
# kernel's twin) differs from autograd through the plain loop by at most
# 1.02e-6 of a gradient's max-abs (``rw``'s, a sum over B S rows), only the
# order of sums differing; the kernel's products sum in yet another order.
# Ten times the twin's own difference leaves room for that.
SLSTM_BWD_TOL = 1e-5


def slstm_loops(slstm_ops):
    """The sLSTM time loop's plain versions, forward and backward (whole,
    and the cluster layout's loop and rest pass), as the wrapper calls
    them: (module, attribute) pairs for ``PlainOnCard``."""
    return tuple((slstm_ops, name) for name in ("slstm_scan_ref", "slstm_scan_bwd_ref",
                                                 "slstm_scan_bwd_chain_ref",
                                                 "slstm_scan_bwd_rest_ref"))


def slstm_bwd_inputs(torch, gen, B, S, d, rw=None, state=None):
    """The backward kernel's arguments on the card: the gradients of hs and of
    the final state N(0, 1), and the gates, rw and entering state of
    ``slstm_inputs`` with the forward's saved steps."""
    from repro_torch.kernels.slstm_scan.ref import slstm_scan_ref

    args = slstm_inputs(torch, gen, B, S, d, rw, state)
    saved = slstm_scan_ref(*args, save=True)[5:]
    grads = [torch.randn(B, S, d, device="cuda", generator=gen)] + [
        torch.randn(B, d, device="cuda", generator=gen) for _ in range(4)]
    return [*grads, *args[1:7], args[8], *saved]


def slstm_bwd_error(torch, what, got, want) -> float:
    """The kernel's (dzx, dix, dfx, dox, dc0, dn0, dh0, dm0) against the
    plain version's: NaN in the same places, each within ``SLSTM_BWD_TOL``
    of its max-abs. Returns the max abs error over the finite entries."""
    err = 0.0
    for name, g, w in zip(("dzx", "dix", "dfx", "dox", "dc0", "dn0", "dh0", "dm0"), got, want):
        check(g.shape == w.shape and torch.equal(torch.isnan(g), torch.isnan(w)),
              f"{what}: {name}'s shape or NaNs differ from the plain version's")
        finite = ~torch.isnan(w)
        if not finite.any():
            continue
        diff = float((g - w)[finite].abs().max())
        scale = float(w[finite].abs().max())
        check(diff <= SLSTM_BWD_TOL * max(scale, 1e-30),
              f"{what}: {name} differs from the plain version by {diff:.3e} of max-abs "
              f"{scale:.3e} (tolerance {SLSTM_BWD_TOL:g} of it)")
        err = max(err, diff)
    return err


def time_slstm_bwd(torch, slstm_ops, bwd_ref, args, what, layout, plain_ms=None):
    """``slstm_scan_bwd`` on ``args`` in ``layout``: against its plain
    version, then timed beside its bound, its serial floor (the same launch
    without the arithmetic: the grid barriers, or the cluster's dz_pre
    exchange) and the plain version (timed unless ``plain_ms`` is given).
    No single PyTorch call computes it (library_ms null). Returns (err, ms,
    plain_ms, bound, None, floor_ms)."""
    from repro_torch.launch.timing import time_cuda

    B, S, d = args[5].shape
    err = slstm_bwd_error(torch, f"slstm_scan_bwd {what} ({layout} layout)",
                          slstm_ops.slstm_scan_bwd(*args, layout=layout), bwd_ref(*args))
    ms = time_cuda(lambda: slstm_ops.slstm_scan_bwd(*args, layout=layout))
    floor_ms = time_cuda(lambda: slstm_ops.bwd_serial_floor(*args, layout=layout))
    if plain_ms is None:
        plain_ms = time_cuda(lambda: bwd_ref(*args), reps=3)
    # Read once: dhs, ix, fx, ox and the four saved steps (B, S, d), rw, the
    # entering c, n, m and the final state's four gradients; written once:
    # dzx, dix, dfx, dox and the entering state's four gradients.
    n_bytes = (12 * B * S * d + d * d + 11 * B * d) * 4
    flops = 2 * B * S * d * d  # dz_pre,t @ rw^T every step
    bound = _bound(flops / FP32_FLOPS_PER_S, n_bytes / HBM_BYTES_PER_S)
    print(f"  slstm_scan_bwd {what} B={B} S={S} d={d} float32, {layout} layout: {ms:.4f} ms, "
          f"bound {bound[0]:.4f} ms by {bound[1]} ({flops / 1e9:.3f} GFLOP, {n_bytes / 1e6:.2f} "
          f"MB; {100 * bound[0] / ms:.1f}% of it), serial floor {floor_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms; library_ms null; max abs error {err:.3e}")
    return err, ms, plain_ms, bound, None, floor_ms


# The rest pass's operations a (row, column) a step, each product, sum,
# quotient, comparison and transcendental one: step_terms 21, step_chain 3
# (its dz_pre unused), step_rest 21.
SLSTM_REST_OPS = 45


def time_slstm_bwd_parts(torch, slstm_ops, args, whole_ms):
    """The cluster layout's two kernels apart on ``args``: the loop
    (``slstm_scan_bwd_chain``) against ``slstm_scan_bwd_chain_ref`` and the
    rest pass (``slstm_scan_bwd_rest``) on the loop's dh_t against
    ``slstm_scan_bwd_rest_ref`` on the same dh_t (each within
    ``SLSTM_BWD_TOL`` of every output's max-abs), each timed; the rest
    pass beside its own bound and plain version; and the previous
    revision's kernel (``PARENT_SLSTM_SOURCE``, where a copy lies) timed
    and its outputs compared bit for bit with the call's. Returns {loop_ms,
    rest: (err, ms, plain_ms, bound, None), parent_ms, parent_equal}."""
    from repro_torch.kernels.slstm_scan.ref import (slstm_scan_bwd_chain_ref,
                                                     slstm_scan_bwd_rest_ref)
    from repro_torch.launch.timing import time_cuda

    B, S, d = args[5].shape
    chain = slstm_ops.slstm_scan_bwd_chain(*args)
    loop_err = slstm_bwd_error(torch, "slstm_scan_bwd's loop", chain,
                               slstm_scan_bwd_chain_ref(*args))
    rest_args = (chain[1], *args[1:3], args[4], *args[5:8], *args[9:])
    rest_err = slstm_bwd_error(torch, "slstm_scan_bwd's rest pass",
                               slstm_ops.slstm_scan_bwd_rest(*rest_args),
                               slstm_scan_bwd_rest_ref(*rest_args))
    loop_ms = time_cuda(lambda: slstm_ops.slstm_scan_bwd_chain(*args))
    rest_ms = time_cuda(lambda: slstm_ops.slstm_scan_bwd_rest(*rest_args))
    rest_plain = time_cuda(lambda: slstm_scan_bwd_rest_ref(*rest_args), reps=3)
    # Read once: dh_t, ix, fx, ox, cs, ns, ms, zs (B, S, d), the entering c,
    # n, m and the final dc, dn, dm; written once: dix, dfx, dox and the
    # entering dc, dn, dm.
    n_bytes = (11 * B * S * d + 9 * B * d) * 4
    ops = SLSTM_REST_OPS * B * S * d
    rest_bound = _bound(ops / FP32_FLOPS_PER_S, n_bytes / HBM_BYTES_PER_S)
    parent = parent_slstm_bwd(torch)
    parent_ms = parent_equal = None
    if parent is not None:
        got, old = slstm_ops.slstm_scan_bwd(*args, layout="cluster"), parent(args)
        parent_equal = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                           for x, y in zip(got, old))
        parent_ms = time_cuda(lambda: parent(args))
    print(f"  slstm_scan_bwd's two kernels apart, cluster layout: the loop {loop_ms:.4f} ms "
          f"(within {SLSTM_BWD_TOL:g} of max-abs of its plain version, max abs error "
          f"{loop_err:.3e}), the rest pass {rest_ms:.4f} ms (bound {rest_bound[0]:.4f} ms by "
          f"{rest_bound[1]}, {n_bytes / 1e6:.2f} MB; {100 * rest_bound[0] / rest_ms:.1f}% of it; "
          f"plain {rest_plain:.4f} ms; max abs error {rest_err:.3e}); the call {whole_ms:.4f} ms; "
          + (f"the previous revision's kernel {parent_ms:.4f} ms, its outputs "
             f"{'equal bit for bit' if parent_equal else 'NOT equal bit for bit'} to the call's"
             if parent is not None else "the previous revision's kernel not timed (no copy at "
                                        "PARENT_SLSTM_SOURCE)"))
    return {"loop_ms": loop_ms, "loop_err": loop_err,
            "rest": (rest_err, rest_ms, rest_plain, rest_bound, None),
            "parent_ms": parent_ms, "parent_equal": parent_equal}


def parent_slstm_bwd(torch):
    """The cluster-layout backward of ``PARENT_SLSTM_SOURCE`` (the entry of
    commit 8326434,
    built on first use) as a call on ``slstm_scan_bwd``'s arguments, or None
    where no copy is there."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels.slstm_scan import ops as slstm_ops

    if not PARENT_SLSTM_SOURCE.exists():
        return None
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib = _build.load_library(PARENT_SLSTM_SOURCE, "slstm_scan_bwd_launch",
                              [i32] + [p] * 24 + [i64] * 3 + [i32] * 4 + [p])

    def run(args):
        B, S, d = args[5].shape
        plan = slstm_ops.plan(B, S, d, slstm_ops.device(), "cluster")
        out = [torch.empty_like(args[5]) for _ in range(4)] + [
            torch.empty_like(args[9]) for _ in range(4)]
        err = lib.slstm_scan_bwd_launch(
            0, *(None if t is None else t.data_ptr() for t in args),
            *(t.data_ptr() for t in out), B, S, d, 1, plan["C"], plan["R"], 0,
            torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"the parent slstm_scan_bwd kernel failed with CUDA error {err}")
        return out

    return run


def slstm_bwd_checks(torch, B, S, d):
    """Phase 23 (c): ``slstm_scan_bwd`` against its plain version on the
    card in both layouts at (B, S, d) from a fresh state and from a
    prompt's, at ``SLSTM_EDGES`` and with a NaN in one gate, reruns equal
    bit for bit; timed in both layouts at (B, S, d), the cluster layout's
    two kernels apart (``time_slstm_bwd_parts``). Returns (max abs error,
    {layout: timing}, the plan's layout, the parts)."""
    from repro_torch.kernels.slstm_scan import kernel as slstm_kernel
    from repro_torch.kernels.slstm_scan import ops as slstm_ops
    from repro_torch.kernels.slstm_scan.ref import slstm_scan_bwd_ref, slstm_scan_ref

    before = dict(slstm_ops.LAUNCHES)
    gen = torch.Generator(device="cuda").manual_seed(23)
    fresh = slstm_bwd_inputs(torch, gen, B, S, d)
    rw = fresh[8]
    attrs = slstm_kernel.device_attributes()
    coop = slstm_kernel.launch_plan(B, d, backward=True)
    clu = slstm_ops.plan(B, S, d, slstm_ops.device(), "cluster")
    chosen = slstm_ops.plan(B, S, d, slstm_ops.device())["layout"]
    print(f"  slstm_scan_bwd at B={B} S={S} d={d}: the plan takes the {chosen} layout; cluster "
          f"layout {clu['clusters']} clusters of C = {clu['C']} blocks (R = {clu['R']} rows, "
          f"one exchange phase of {clu['phase_bytes']} bytes a row, {clu['bwd_smem_bytes']} "
          f"shared bytes a block, rows {clu['width']} of rw a block in registers), its loop "
          f"{attrs['bwd_registers']} registers, {attrs['bwd_local_bytes']} local (spilled) bytes "
          f"a thread (the forward's {attrs['registers']}), its rest pass "
          f"{attrs['rest_registers']} and {attrs['rest_local_bytes']}; cooperative layout "
          f"{coop['grid']} blocks, rw^T in {'shared' if coop['rw_resident'] else 'global'} "
          f"memory, {coop['registers']} registers, {coop['local_bytes']} local bytes")
    check(attrs["bwd_local_bytes"] == 0 and attrs["rest_local_bytes"] == 0
          and coop["local_bytes"] == 0, "the backward kernel spills registers")
    timings, plain = {}, None
    for layout in slstm_ops.LAYOUTS:
        timings[layout] = time_slstm_bwd(torch, slstm_ops, slstm_scan_bwd_ref, fresh,
                                         "fresh state", layout, plain)
        plain = timings[layout][2]
    err = max(t[0] for t in timings.values())
    parts = time_slstm_bwd_parts(torch, slstm_ops, fresh, timings["cluster"][1])
    err = max(err, parts["loop_err"])
    left = slstm_scan_ref(*slstm_inputs(torch, gen, B, S, d, rw))[1:]
    cases = [("from the state a prompt left", slstm_bwd_inputs(torch, gen, B, S, d, rw, left))]
    cases += [(label, slstm_bwd_inputs(torch, gen, b, s, w)) for label, b, s, w in SLSTM_EDGES]
    args = slstm_inputs(torch, gen, 2, 6, 100)
    args[2][1, 2, 7] = float("nan")  # one forget-gate pre-activation
    nan = [torch.randn(2, 6, 100, device="cuda", generator=gen), None, None, None, None,
           *args[1:7], args[8], *slstm_scan_ref(*args, save=True)[5:]]
    cases.append(("a NaN in one gate", nan))
    for label, case in cases:
        want = slstm_scan_bwd_ref(*case)
        nans = int(torch.isnan(want[0]).sum())
        check(label != "a NaN in one gate" or 0 < nans < want[0].numel(),
              "the NaN case made no NaN, or nothing but NaN")
        case_err, took = each_layout(
            torch, slstm_ops, f"slstm_scan_bwd {label}", case[5].shape[2],
            lambda layout, case=case: slstm_ops.slstm_scan_bwd(*case, layout=layout),
            lambda what, got, want=want: slstm_bwd_error(torch, what, got, want))
        err = max(err, case_err)
        print(f"  slstm_scan_bwd {label}, (B, S, d) {tuple(case[5].shape)}: within "
              f"{SLSTM_BWD_TOL:g} of max-abs of its plain version, reruns equal ({', '.join(took)})"
              + (f", NaN in the same {nans} of dzx's outputs" if nans else ""))
    slstm_ops.LAUNCHES.update(before)  # the comparison's launches are not the path's
    return err, timings, chosen, parts


def xlstm_train_phase(torch, M, flash_ops, decode_ops, scan_ops, wall, smi):
    """Phase 23: train xlstm-125m at full width and depth through the
    ``Trainer``, its sLSTM blocks through ``slstm_scan`` and ``slstm_scan_bwd``
    with the exact launch counts and no plain loop on the card; one profiled
    step; one float32 step of its first XL_CHECK_LAYERS blocks against the
    CPU; ``slstm_scan_bwd`` against its plain version, timed. Returns (the
    training run's launches of the three kernels, the backward's max abs
    error, its timings by layout, the plan's layout, the cluster layout's
    two kernels apart)."""
    import tempfile

    from repro_torch._tree import leaves
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels.slstm_scan import ops as slstm_ops
    from repro_torch.launch.profile_serve import profile_phase
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw
    from repro_torch.roofline import model_flops
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = get_config("xlstm-125m")
    kinds = cfg.resolved_block_pattern
    n_slstm = kinds.count("slstm")
    print(f"[23] training {cfg.name} at full width and depth ({cfg.n_layers} blocks, "
          f"{kinds.count('mlstm')} mLSTM and {n_slstm} sLSTM, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab_size}), {cfg.param_dtype} parameters, float32 AdamW moments, remat; "
          f"{TRAIN_B} x {TRAIN_S} tokens a step; {smi}")
    t_phase = time.perf_counter()
    opt = adamw.AdamWConfig(lr=TRAIN_LR)
    step = make_train_step(cfg, opt, device="cuda", remat=True,
                           lr_fn=adamw.cosine_schedule(TRAIN_LR, TRAIN_WARMUP, XL_TRAIN_STEPS))
    walls = []

    def timed(state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(state, batch)
        float(out[1]["loss"])
        walls.append(time.perf_counter() - t0)
        return out

    def init_state():
        params = M.init_params(cfg, seed=TRAIN_SEED, device="cuda")
        return {"params": params, "opt": adamw.init_opt_state(params, opt)}

    # (a) XL_TRAIN_STEPS steps through the Trainer ----------------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    logs = []
    all_ops = (flash_ops, decode_ops, scan_ops, slstm_ops)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_xlstm_train_") as tmp:
        data = _Stream(SyntheticLM(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=TRAIN_SEED))
        trainer = Trainer(TrainerConfig(total_steps=XL_TRAIN_STEPS, ckpt_dir=tmp,
                                        ckpt_every=10 ** 9, keep=1, log_every=XL_TRAIN_STEPS),
                          timed, init_state, data, log=logs.append)
        for ops in all_ops:
            ops.reset_launches()
        t0 = time.perf_counter()
        with PlainOnCard(flash_ops, decode_ops, *slstm_loops(slstm_ops)) as plain:
            out = trainer.run()
        wall["xlstm_train_s"] = time.perf_counter() - t0
        launches = {k: v for ops in all_ops for k, v in ops.LAUNCHES.items()}
    peak = torch.cuda.max_memory_allocated()
    # Remat: each sLSTM block's time loop runs in the forward and again in
    # the recompute of its repeat, its backward once; no attention kernel.
    want = dict(flash_attention=0, decode_attention=0, rglru_scan=0, rglru_scan_bwd=0,
                slstm_scan=2 * n_slstm * XL_TRAIN_STEPS, slstm_scan_bwd=n_slstm * XL_TRAIN_STEPS,
                slstm_scan_bwd_rest=n_slstm * XL_TRAIN_STEPS)
    check(launches == want, f"xLSTM training launched {launches}, not {want}")
    check(plain.calls == 0, f"a plain attention version or sLSTM loop ran on the card "
                            f"{plain.calls} times")
    losses = out["losses"]
    check(out["final_step"] == XL_TRAIN_STEPS and len(losses) == XL_TRAIN_STEPS
          and all(map(math.isfinite, losses)), f"xLSTM training: {out['final_step']} steps, "
          f"losses {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses[0]} -> {losses[-1]}")
    trained = out["state"]
    n_params = sum(t.numel() for t in leaves(trained["params"]))
    del out, trainer
    step_s = statistics.median(walls[2:XL_TRAIN_STEPS])
    tokens = TRAIN_B * TRAIN_S
    flops = model_flops(cfg, ShapeConfig("train", TRAIN_S, TRAIN_B, "train"))
    for line in logs:
        print(f"  {line}")
    print(f"  {n_params / 1e6:.1f} M parameters; loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
          f"{XL_TRAIN_STEPS} steps: " + " ".join(f"{x:.3f}" for x in losses))
    print(f"  step wall {step_s * 1e3:.1f} ms (median of steps 3-{XL_TRAIN_STEPS}; first "
          f"{walls[0] * 1e3:.1f} ms), {tokens / step_s:,.0f} tokens/s; 6 N D = "
          f"{flops / 1e12:.3f} TFLOP a step, {flops / step_s / 1e12:.2f} TFLOP/s achieved "
          f"({100 * flops / step_s / BF16_FLOPS_PER_S:.2f}% of the bf16 peak at 700 W); peak "
          f"memory {peak / 2**30:.2f} GiB; launches {launches} (slstm_scan twice, "
          f"slstm_scan_bwd and its rest once an sLSTM block a step), the plain sLSTM loop and "
          f"its plain "
          f"backward 0 times on the card; {wall['xlstm_train_s']:.2f} s; {smi}")
    wall["xlstm_train_step_ms"] = step_s * 1e3
    wall["xlstm_train_peak_gib"] = peak / 2**30

    # (a') one profiled step of the trained state --------------------------------
    batch = SyntheticLM(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=TRAIN_SEED).batch_at(XL_TRAIN_STEPS)
    prof = profile_phase(lambda: step(trained, batch), top=64, kernels={})
    busy_ms = prof["device_busy_s"] * 1e3
    fwd = [t for t in prof["top"] if "slstm_scan" in t["name"] and "bwd" not in t["name"]]
    bwd = [t for t in prof["top"] if "slstm_scan_bwd" in t["name"] and "rest" not in t["name"]]
    rest = [t for t in prof["top"] if "slstm_scan_bwd_rest" in t["name"]]
    print(f"  one profiled step: wall {prof['wall_s'] * 1e3:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({100 * prof['busy_share']:.1f}%), {prof['launches']} device activities; slstm_scan "
          f"{sum(t['device_ms'] for t in fwd):.3f} ms x{sum(t['calls'] for t in fwd)}, "
          f"slstm_scan_bwd {sum(t['device_ms'] for t in bwd):.3f} ms "
          f"x{sum(t['calls'] for t in bwd)}, its rest {sum(t['device_ms'] for t in rest):.3f} ms "
          f"x{sum(t['calls'] for t in rest)}; top: " + "; ".join(
              f"{t['name'][:40]} {t['device_ms']:.2f} ms x{t['calls']}" for t in prof["top"][:5]))
    wall["xlstm_train_busy_share"] = prof["busy_share"]
    del trained
    torch.cuda.empty_cache()

    # (b) float32, the first XL_CHECK_LAYERS blocks: one step on the card and the CPU
    t0 = time.perf_counter()
    c32 = dataclasses.replace(cfg, n_layers=XL_CHECK_LAYERS,
                              block_pattern=kinds[:XL_CHECK_LAYERS], dtype="float32",
                              param_dtype="float32")
    p_cpu = M.init_params(c32, seed=TRAIN_SEED + 1, device="cpu")
    batch32 = SyntheticLM(c32.vocab_size, 128, 2, seed=TRAIN_SEED + 1).batch_at(0)
    res = {}
    slstm_ops.reset_launches()
    for dev in ("cpu", "cuda"):
        p = _map_leaves(p_cpu, lambda t, d=dev: t.to(d))
        res[dev] = make_train_step(c32, opt, device=dev)(
            {"params": p, "opt": adamw.init_opt_state(p, opt)}, batch32)
        del p
    n32 = c32.resolved_block_pattern.count("slstm")
    check(slstm_ops.LAUNCHES == {"slstm_scan": n32, "slstm_scan_bwd": n32,
                                 "slstm_scan_bwd_rest": n32},
          f"the float32 step launched {slstm_ops.LAUNCHES}")
    (cpu, m_cpu), (card, m_card) = res["cpu"], res["cuda"]
    loss_rel = abs(float(m_card["loss"]) - float(m_cpu["loss"])) / abs(float(m_cpu["loss"]))
    norm_rel = abs(float(m_card["grad_norm"]) - float(m_cpu["grad_norm"])) / float(
        m_cpu["grad_norm"])
    d_cpu = torch.cat([(x - y).flatten() for x, y in zip(leaves(cpu["params"]), leaves(p_cpu))])
    d_card = torch.cat([(x.cpu() - y).flatten()
                        for x, y in zip(leaves(card["params"]), leaves(p_cpu))])
    upd_rel = float((d_card - d_cpu).norm() / d_cpu.norm())
    flips = int(((d_card > 0) != (d_cpu > 0)).sum())
    check(loss_rel <= F32_LOSS_REL and norm_rel <= F32_NORM_REL and upd_rel <= F32_UPDATE_REL,
          f"xLSTM float32 step, card vs CPU: loss {loss_rel:.2e}, grad norm {norm_rel:.2e}, "
          f"update {upd_rel:.2e} (relative)")
    print(f"  float32, {c32.n_layers} blocks ({', '.join(c32.resolved_block_pattern)}), 2 x 128 "
          f"tokens, one step card vs CPU: loss {float(m_card['loss']):.6f} vs "
          f"{float(m_cpu['loss']):.6f} ({loss_rel:.2e} relative, <= {F32_LOSS_REL:g}), grad norm "
          f"{norm_rel:.2e} (<= {F32_NORM_REL:g}), update {upd_rel:.2e} in l2 "
          f"(<= {F32_UPDATE_REL:g}); {flips} of {d_cpu.numel()} updates of opposite sign; "
          f"{n32} slstm_scan, {n32} slstm_scan_bwd and {n32} of its rest launches on the card; "
          f"{time.perf_counter() - t0:.2f} s")
    wall["xlstm_train_f32_check_s"] = time.perf_counter() - t0
    del res, cpu, card, p_cpu, d_cpu, d_card
    torch.cuda.empty_cache()

    # (c) slstm_scan_bwd against its plain version, and timed ----------------------
    t0 = time.perf_counter()
    err, timings, chosen, parts = slstm_bwd_checks(torch, TRAIN_B, TRAIN_S, cfg.d_model)
    wall["slstm_bwd_kernel_s"] = time.perf_counter() - t0
    wall["phase_23_s"] = time.perf_counter() - t_phase
    print(f"  phase 23 wall {wall['phase_23_s']:.1f} s")
    return ({k: launches[k] for k in ("slstm_scan", "slstm_scan_bwd", "slstm_scan_bwd_rest")}, err,
            timings, chosen, parts)


def _bound(op_s, byte_s):
    """(ms, what bounds it): the larger of the operations' and the bytes' times."""
    return (max(op_s, byte_s) * 1e3, "operations" if op_s >= byte_s else "bytes")


def _record(name, source, replaces, launches, max_err, timing):
    _err, ms, plain_ms, bound, lib_ms = timing
    return dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches,
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                bound_by=bound[1], library_ms=lib_ms)


def main() -> int:
    t_start = time.perf_counter()
    if not (SRC / "repro_torch" / "core").is_dir():
        print("chip_smoke: run from the root of a checkout (src/repro_torch is missing)",
              file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a GPU",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(SRC))
    import repro_torch.core as P
    from repro_torch.launch.profile_refine import resource_cluster
    from repro_torch.launch.timing import time_cuda
    from repro_torch.core.schedule_state import ScheduleState
    from repro_torch.kernels._build import build_info
    from repro_torch.kernels.decode_attention import kernel as decode_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.rglru_scan import kernel as scan_kernel
    from repro_torch.kernels.slstm_scan import kernel as slstm_kernel
    from repro_torch.kernels.cut_traffic import kernel as cut_kernel
    from repro_torch.kernels.cut_traffic import ops as cut_ops
    from repro_torch.kernels.policy_scan import kernel as scan_policy_kernel
    from repro_torch.kernels.sched_scoring import kernel, ops

    wall = {}
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)

    # [1] build and device ------------------------------------------------
    print(f"[1] build and device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"  nvidia-smi: {smi}")
    t0 = time.perf_counter()
    kernel_modules = (kernel, cut_kernel, flash_kernel, decode_kernel, scan_kernel,
                      scan_policy_kernel, slstm_kernel)
    with ThreadPoolExecutor(len(kernel_modules) + 2) as pool:  # one nvcc per source, all at once
        builds = [pool.submit(k.load_library) for k in kernel_modules]
        builds.append(pool.submit(parent_cut_kernel, torch))  # phase 22's, where a copy lies
        builds.append(pool.submit(parent_slstm_bwd, torch))  # phase 23's, where a copy lies
        for build in builds:
            build.result()
    wall["build_s"] = time.perf_counter() - t0
    for k in kernel_modules:
        info = build_info(k.SOURCE)
        print(f"  built {k.SOURCE.relative_to(ROOT)} for sm_90a in "
              f"{info.get('seconds', 0.0):.2f} s -> {info['library']}")
        for line in info.get("log", "").splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                print(f"  ptxas: {line.strip()}")
    for copy, phase in ((PARENT_CUT_SOURCE, 22), (PARENT_SLSTM_SOURCE, 23)):
        if copy.exists():
            info = build_info(copy)
            print(f"  built the copy {copy.relative_to(ROOT)} in {info.get('seconds', 0.0):.2f} s "
                  f"(phase {phase} times it)")
    print(f"  all seven built in {wall['build_s']:.2f} s")

    # [2] kernel against its plain version on the card ---------------------
    print("[2] kernel against its plain PyTorch version on the card")
    max_err = {"sched_scoring": 0.0, "sched_scoring_resources": 0.0}
    cases = []
    for m in (1, 3, 180):
        for T in (1, 37, 478):
            cases.append((f"shared m={m} T={T}", dict(B=97, T=T, m=m, n=4)))
    cases += [
        ("per-row maps", dict(B=300, T=478, m=180, n=4, per_row=True)),
        ("skew per-row unit_ir", dict(B=257, T=478, m=180, n=4, skew=True)),
        ("per-row capacity (B, m)", dict(B=211, T=130, m=180, n=4, cap_rows=True)),
        ("T=130 (not a multiple of 32)", dict(B=129, T=130, m=17, n=3)),
        ("ids outside [0, m)", dict(B=97, T=478, m=180, n=4, outside=True)),
        ("B2 ids outside [0, m), m=3", dict(B=65, T=37, m=3, n=4, memory=True, network=True,
                                           outside=True)),
        ("B2 memory only", dict(B=333, T=478, m=180, n=4, memory=True)),
        ("B2 memory only m=3", dict(B=65, T=37, m=3, n=4, memory=True)),
        ("B2 network only", dict(B=333, T=478, m=180, n=4, network=True)),
        ("B2 memory + network, per-row maps", dict(B=129, T=533, m=180, n=4, per_row=True,
                                                   memory=True, network=True)),
        ("B2 memory + network, per-row capacity", dict(B=129, T=533, m=180, n=4, cap_rows=True,
                                                       memory=True, network=True)),
        ("B2 memory + network, m=1", dict(B=33, T=5, m=1, n=2, memory=True, network=True)),
    ]
    for i, (label, kw) in enumerate(cases):
        args, extras = scoring_problem(np, 100 + i, **kw)
        err, n_inf = compare_kernel(torch, np, ops, args, extras)
        key = "sched_scoring_resources" if extras else "sched_scoring"
        max_err[key] = max(max_err[key], err)
        print(f"  {label:<40} B={kw['B']:<6} -> equal; {n_inf} infeasible rows")
    max_err["cut_traffic"] = 0.0
    for i, topology in enumerate(("linear", "diamond", "star", "wide fanout")):
        for j, (m, B, regime) in enumerate(((1, 33, "shared"), (3, 65, "per_row"),
                                           (180, 257, "skew"), (180, 129, "shared"))):
            args, edges, dist = cut_problem(np, P, 200 + 10 * i + j, topology, B, m, regime)
            err = compare_cut(torch, np, cut_ops, args, edges, dist, 0.05)
            max_err["cut_traffic"] = max(max_err["cut_traffic"], err)
            print(f"  cut_traffic {topology:<12} {regime:<8} m={m:<4} B={B:<4} "
                  f"T={args[0].shape[1]:<4} -> equal")
    # Shapes past one round of the product (66 contracted rows a row), past
    # 16-column distance tiles (m = 1000), past shared memory (98 rows a
    # row at m = 180, 18 at m = 1000: X^T and Y^T in the global scratch),
    # and ids outside [0, m).
    for topology, m, B, regime, outside in (("fanout of 32", 180, 9, "per_row", False),
                                            ("linear", 1000, 7, "shared", False),
                                            ("fanout of 48", 180, 9, "per_row", False),
                                            ("wide fanout", 1000, 5, "per_row", False),
                                            ("diamond", 180, 65, "skew", True)):
        args, edges, dist = cut_problem(np, P, 300 + m, topology, B, m, regime, outside)
        err = compare_cut(torch, np, cut_ops, args, edges, dist, 0.05)
        max_err["cut_traffic"] = max(max_err["cut_traffic"], err)
        print(f"  cut_traffic {topology:<12} {regime:<8} m={m:<4} B={B:<4} "
              f"T={args[0].shape[1]:<4} -> equal" + (" (ids outside [0, m))" if outside else ""))
    before = dict(ops.LAUNCHES), dict(cut_ops.LAUNCHES)
    args, edges, dist = cut_problem(np, P, 1, "linear", 0, 180, "shared")
    g_args, g_dist = cut_tensors(torch, np, "cuda", args, dist)
    empty = cut_ops.cut_traffic(*g_args, edges, g_dist)
    args, extras = scoring_problem(np, 1, 0, 478, 180, 4)
    empty_b = ops.sched_scoring(*to_tensors(torch, np, "cuda", args, extras)[0])
    check(empty.shape == (0, 180) and empty_b.shape == (0,)
          and (ops.LAUNCHES, cut_ops.LAUNCHES) == before, "B=0 must return empty, no launch")
    print("  B = 0 -> empty result, no launch")
    # The scorer's layouts (ROADMAP C-port-4): at ``max_machines`` of the
    # operands' layout B1 and B2 launch their one-block layout, one machine
    # more their table of the machines a row touches (``table_slots``); each
    # equals its plain version.
    for label, kw in (("B1, shared maps", dict(n=4)),
                      ("B1, per-row maps", dict(n=4, per_row=True)),
                      ("B2, memory + network", dict(n=4, memory=True, network=True))):
        use_mem, per_row = kw.get("memory", False), kw.get("per_row", False)
        limit = ops.max_machines(use_mem, per_row, per_row)
        # One past the table's most tasks, the machine tiles.
        tiled_T = ops.max_table_tasks(limit + 1, use_mem, per_row, per_row) + 1
        for m, T_case in ((limit, 37), (limit + 1, 37), (limit + 1, tiled_T)):
            args, extras = scoring_problem(np, 7, 8, T_case, m, **kw)
            err, _ = compare_kernel(torch, np, ops, args, extras)
            key = "sched_scoring_resources" if extras else "sched_scoring"
            max_err[key] = max(max_err[key], err)
        slots = ops.table_slots(37, limit + 1, use_mem, per_row, per_row)
        width, count = ops.machine_tiles(limit + 1, use_mem, per_row, per_row)
        print(f"  {label}: m = {limit} (one block a row), m = {limit + 1} at T = 37 (a table "
              f"of {slots} slots a row) and at T = {tiled_T} ({count} tiles of {width} "
              f"machines) launch and equal their plain versions")

    # [3] main path at full width ------------------------------------------
    print("[3] main path: schedule -> refine -> simulate, paper_cluster((20, 70, 90))")
    import hashlib

    cluster = P.paper_cluster((20, 70, 90))
    t0 = time.perf_counter()
    sched = P.schedule(P.linear_topology(), cluster, r0=1.0, rate_epsilon=1.0)
    wall["schedule_s"] = time.perf_counter() - t0
    md5 = hashlib.md5(sched.etg.task_machine().tobytes()).hexdigest()
    check(sched.rate == MAIN_GOLDEN["rate"]
          and sched.etg.n_instances.tolist() == MAIN_GOLDEN["n_instances"]
          and sched.iterations == MAIN_GOLDEN["iterations"] and md5 == MAIN_GOLDEN["md5"],
          "schedule() left the 20/70/90 golden")
    print(f"  schedule: rate {sched.rate}, n_instances {sched.etg.n_instances.tolist()}, "
          f"{sched.iterations} iterations, md5 {md5} ({wall['schedule_s']:.3f} s)")
    ops.reset_launches()
    t0 = time.perf_counter()
    ref_gpu = P.refine(sched.etg, cluster, device="cuda")
    torch.cuda.synchronize()
    wall["refine_s"] = time.perf_counter() - t0
    main_launches = dict(ops.LAUNCHES)
    check(main_launches["sched_scoring"] > 0, "the main path launched no sched_scoring kernel")
    t0 = time.perf_counter()
    ref_cpu = P.refine(sched.etg, cluster, device="cpu")
    wall["refine_cpu_s"] = time.perf_counter() - t0
    check(ref_gpu.moves == ref_cpu.moves and ref_gpu.throughput == ref_cpu.throughput
          and np.array_equal(ref_gpu.etg.task_machine(), ref_cpu.etg.task_machine()),
          "refine on the card differs from the CPU path")
    check(ref_gpu.moves == MAIN_REFINE_REF[0] and ref_gpu.throughput == MAIN_REFINE_REF[1],
          "refine differs from the reference's result")
    print(f"  refine(device='cuda'): moves {ref_gpu.moves}, throughput {ref_gpu.throughput!r} "
          f"({wall['refine_s']:.3f} s; cpu path {wall['refine_cpu_s']:.3f} s), "
          f"launches {main_launches}")
    etg = ref_gpu.etg
    rate, thpt = P.max_stable_rate(etg, cluster)
    t0 = time.perf_counter()
    sim = P.simulate(etg, cluster, rate, device="cuda")
    wall["simulate_s"] = time.perf_counter() - t0
    check(abs(sim.throughput - thpt) <= 1e-9 * thpt, "simulated throughput != closed form at R*")
    rng = np.random.default_rng(0)
    base = etg.task_machine()
    batch = np.tile(base, (4096, 1))
    rows = np.arange(4096)
    batch[rows, rng.integers(0, base.size, 4096)] = rng.integers(0, 180, 4096)
    r0 = rng.uniform(0.5, 1.5, 4096) * rate
    t0 = time.perf_counter()
    sim_gpu = P.simulate_batch(etg, cluster, batch, r0, device="cuda")
    wall["simulate_batch_s"] = time.perf_counter() - t0
    sim_cpu = P.simulate_batch(etg, cluster, batch, r0, device="cpu")
    for field in ("ir", "pr", "tcu", "machine_util", "throughput"):
        a, b = getattr(sim_gpu, field), getattr(sim_cpu, field)
        check(a.shape == b.shape and np.all(np.isfinite(a)), f"simulate_batch {field} shape")
        check(np.allclose(a, b, rtol=1e-9, atol=1e-9), f"simulate_batch {field} cuda != cpu")
    print(f"  simulate(device='cuda') at R* {rate!r}: throughput {sim.throughput!r} "
          f"({wall['simulate_s']:.3f} s)")
    print(f"  simulate_batch(device='cuda') B=4096: matches cpu to 1e-9 "
          f"({wall['simulate_batch_s']:.3f} s)")

    # [4] resource path ----------------------------------------------------
    print("[4] resource path: memory + 6 racks, refine max_rounds=3")
    rcl = resource_cluster()
    rsched = P.schedule(P.linear_topology(), rcl, r0=1.0, rate_epsilon=1.0)
    # The network term's plain version must not run on the card: count its
    # calls on CUDA tensors while the card's refine runs.
    plain_cut, eager_on_card = cut_ops.cut_traffic_ref, []

    def counting_plain(task_machine, *args, **kwargs):
        if task_machine.is_cuda:
            eager_on_card.append(tuple(task_machine.shape))
        return plain_cut(task_machine, *args, **kwargs)

    cut_ops.cut_traffic_ref = counting_plain
    ops.reset_launches()
    cut_ops.reset_launches()
    t0 = time.perf_counter()
    res_gpu = P.refine(rsched.etg, rcl, max_rounds=3, device="cuda")
    torch.cuda.synchronize()
    wall["resource_refine_s"] = time.perf_counter() - t0
    res_launches = {**ops.LAUNCHES, **cut_ops.LAUNCHES}
    cut_ops.cut_traffic_ref = plain_cut
    check(res_launches["sched_scoring_resources"] == RESOURCE_REFINE_B2_LAUNCHES,
          f"the resource refine launched B2 {res_launches['sched_scoring_resources']} times, "
          f"not {RESOURCE_REFINE_B2_LAUNCHES}")
    check(res_launches["cut_traffic"] == res_launches["sched_scoring_resources"],
          "the resource refine did not launch one cut_traffic kernel per B2 launch")
    check(not eager_on_card, f"the network term's eager path ran on the card {eager_on_card}")
    t0 = time.perf_counter()
    res_cpu = P.refine(rsched.etg, rcl, max_rounds=3, device="cpu")
    wall["resource_refine_cpu_s"] = time.perf_counter() - t0
    check(res_gpu.moves == res_cpu.moves and res_gpu.throughput == res_cpu.throughput
          and np.array_equal(res_gpu.etg.task_machine(), res_cpu.etg.task_machine()),
          "resource refine on the card differs from the CPU path")
    check(res_gpu.moves == RESOURCE_REFINE_REF[0]
          and abs(res_gpu.throughput - RESOURCE_REFINE_REF[1]) <= 1e-12 * RESOURCE_REFINE_REF[1],
          "resource refine differs from the reference's result")
    check(np.all(ScheduleState.from_etg(res_gpu.etg, rcl).mem_load <= rcl.mem_capacity),
          "resource refine left a machine over memory")
    print(f"  180 machines, 6 racks, memory: schedule rate {rsched.rate}, "
          f"n_instances {rsched.etg.n_instances.tolist()}; moves {res_gpu.moves}, "
          f"throughput {res_gpu.throughput!r} ({wall['resource_refine_s']:.3f} s; cpu path "
          f"{wall['resource_refine_cpu_s']:.3f} s), launches {res_launches}; the network "
          f"term's eager path ran on the card 0 times")

    # [5] exhaustive search ------------------------------------------------
    print("[5] exhaustive search: optimal_schedule, paper_cluster((1, 1, 1)), 8 tasks")
    small = P.paper_cluster((1, 1, 1))
    ops.reset_launches()
    t0 = time.perf_counter()
    opt = P.optimal_schedule(P.linear_topology(), small, max_total_tasks=8, device="cuda")
    wall["optimal_s"] = time.perf_counter() - t0
    opt_launches = dict(ops.LAUNCHES)
    opt_cpu = P.optimal_schedule(P.linear_topology(), small, max_total_tasks=8, device="cpu")
    check(opt.candidates_evaluated == OPTIMAL_REF["evaluated"]
          and opt.classes_pruned == OPTIMAL_REF["pruned"]
          and opt.etg.n_instances.tolist() == OPTIMAL_REF["n_instances"]
          and opt.throughput == OPTIMAL_REF["throughput"], "optimal_schedule left the golden")
    check(opt.throughput == opt_cpu.throughput
          and opt.candidates_evaluated == opt_cpu.candidates_evaluated
          and np.array_equal(opt.etg.task_machine(), opt_cpu.etg.task_machine()),
          "optimal_schedule on the card differs from the CPU path")
    check(opt_launches["sched_scoring"] > 0, "optimal_schedule launched no kernel")
    print(f"  optimal_schedule: throughput {opt.throughput!r}, {opt.candidates_evaluated} "
          f"evaluated, {opt.classes_pruned} pruned, n_instances {opt.etg.n_instances.tolist()} "
          f"({wall['optimal_s']:.3f} s), launches {opt_launches}")

    # [6] timings ----------------------------------------------------------
    print("[6] timings (CUDA events, cold L2, median of 15) at B=16384 T=478 m=180")
    from repro_torch.kernels.sched_scoring.ref import sched_scoring_ref

    B, T, m, n = 16384, base.size, 180, 4
    batch = np.tile(base, (B, 1))
    batch[np.arange(B), rng.integers(0, T, B)] = rng.integers(0, m, B)
    state = ScheduleState.from_etg(etg, cluster)
    comp = np.repeat(np.arange(n), etg.n_instances)
    uir = (state.cir_unit / etg.n_instances)[comp]
    host_args = (batch, comp, uir, state.e_cm, state.met_cm, cluster.capacity)
    host_extras = dict(net_var=rng.uniform(0.0, 0.2, size=(B, m)),
                       mem_c=np.array([0.5, 1.0, 1.5, 2.0]), mem_capacity=np.full(m, 8.0))
    records = []
    for key, extras, replaces in (
        ("sched_scoring", {}, "src/repro/kernels/sched_scoring/kernel.py:130"),
        ("sched_scoring_resources", host_extras,
         "src/repro/kernels/sched_scoring/kernel.py:180"),
    ):
        err, _ = compare_kernel(torch, np, ops, host_args, extras)  # at the timed shape
        max_err[key] = max(max_err[key], err)
        g_args, g_kw = to_tensors(torch, np, "cuda", host_args, extras)
        ms = time_cuda(lambda: ops.sched_scoring(*g_args, **g_kw))
        wrapper_ms = time_cuda(lambda: ops.sched_scoring(*g_args, **g_kw), spin_cycles=0)
        plain_ms = time_cuda(lambda: sched_scoring_ref(*g_args, **g_kw), reps=5)
        n_bytes = sum(x.numel() * x.element_size() for x in (*g_args, *g_kw.values())) + B * 8
        flops = B * T * 3 + B * m * 4
        bound_ms = max(n_bytes / HBM_BYTES_PER_S, flops / FP64_FLOPS_PER_S) * 1e3
        launches = main_launches[key] if key == "sched_scoring" else res_launches[key]
        print(f"  {key}: {ms:.4f} ms ({wrapper_ms:.4f} ms with the wrapper's host time; bound "
              f"{bound_ms:.4f} ms by bytes, {100 * bound_ms / ms:.1f}% of it), plain "
              f"{plain_ms:.3f} ms; no single PyTorch call computes this function, so "
              f"library_ms is null")
        records.append(dict(
            name=key, route="cuda",
            source="src/repro_torch/kernels/sched_scoring/csrc/sched_scoring.cu",
            replaces=replaces, launches=launches, max_abs_err=max_err[key], ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes", library_ms=None,
            wrapper_ms=wrapper_ms,
        ))
    records.append(time_cut_traffic(torch, np, P, cut_ops, res_gpu.etg, rcl, rng,
                                    res_launches["cut_traffic"], max_err))
    sweep = []
    for _ in range(5):
        t0 = time.perf_counter()
        P.max_stable_rate_batch(sched.etg, cluster, batch, device="cuda")
        sweep.append((time.perf_counter() - t0) * 1e3)
    wall["sweep_ms"] = statistics.median(sweep)
    print(f"  one host-to-host sweep at {B} x {T} (int32 conversion, copy, kernel, readback): "
          f"{wall['sweep_ms']:.3f} ms median of 5")

    # [7] LM kernels against their plain versions ---------------------------
    print("[7] LM kernels (B3, B4, B5) against their plain PyTorch versions on the card")
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.rglru_scan import ops as scan_ops
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    from repro_torch.models import model as M
    from repro_torch.serve_lm import serve

    t_lm = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    torch.backends.cudnn.allow_tf32 = False
    lm_err = kernel_phase(torch, flash_ops, decode_ops, scan_ops, flash_attention_ref,
                          decode_attention_ref, rglru_scan_ref)
    lm_ops = (flash_ops, decode_ops, scan_ops)

    # [8] LM serving at full width ------------------------------------------
    print("[8] serving at full width: init_params -> init_caches -> prefill -> decode_step")
    lm_cfg = get_config("qwen1.5-0.5b")
    params = M.init_params(lm_cfg, seed=0, device="cuda")
    gen_len = 64
    qwen_launches = serve_run(
        torch, lm_ops, M, serve, lm_cfg, params, 8, 512, gen_len,
        dict(flash_attention=lm_cfg.n_layers, decode_attention=lm_cfg.n_layers * (gen_len - 1),
             rglru_scan=0, rglru_scan_bwd=0), wall)
    cpu_check(torch, M, lm_cfg, params, 2, 128, 8)
    del params

    rg_cfg = get_config("recurrentgemma-2b")
    kinds = rg_cfg.resolved_block_pattern
    n_rec, n_local = kinds.count("rglru"), kinds.count("local_attn")
    params = M.init_params(rg_cfg, seed=0, device="cuda")
    rg_launches = serve_run(
        torch, lm_ops, M, serve, rg_cfg, params, 8, 2304, gen_len,
        dict(flash_attention=n_local, decode_attention=n_local * (gen_len - 1),
             rglru_scan=n_rec, rglru_scan_bwd=0), wall)
    print(f"  local-attention rings of {min(2304 + gen_len, rg_cfg.local_window)} slots: the "
          f"prefill rolls 2304 tokens into them, decode wraps them {gen_len - 1} times")
    cut, cut_params = first_layers(M, rg_cfg, params, 6)
    print(f"  CPU check on {cut.n_layers} of {rg_cfg.n_layers} layers "
          f"({', '.join(cut.resolved_block_pattern)}) at full width, window {cut.local_window}")
    t0 = time.perf_counter()
    cpu_check(torch, M, cut, cut_params, 2, 2100, 16)
    wall["recurrentgemma_cpu_check_s"] = time.perf_counter() - t0
    del params, cut_params

    # [9] LM kernel timings -------------------------------------------------
    print("[9] LM kernel timings at the serving shapes (CUDA events, cold L2, median of 15; "
          "plain version median of 5)")
    H, Hkv, D = lm_cfg.n_heads, lm_cfg.n_kv_heads, lm_cfg.resolved_head_dim
    flash_t = time_flash(torch, F, flash_ops, flash_attention_ref, 8, 512, H, Hkv, D, 0)
    # The last decode step of the qwen run: 512 + 63 tokens cached of 576.
    decode_t = time_decode(torch, F, decode_ops, decode_attention_ref, 8, H, Hkv, 576, 575, D)
    H, Hkv, D = rg_cfg.n_heads, rg_cfg.n_kv_heads, rg_cfg.resolved_head_dim
    W, window = rg_cfg.lru_width, rg_cfg.local_window
    rg_flash_t = time_flash(torch, F, flash_ops, flash_attention_ref, 8, 2304, H, Hkv, D, window)
    # Every decode step of the recurrentgemma run attends over a full ring.
    rg_decode_t = time_decode(torch, F, decode_ops, decode_attention_ref, 8, H, Hkv, window,
                              window, D)
    scan_t = time_scan(torch, scan_ops, rglru_scan_ref, 8, 2304, W)
    for key, t in (("flash_attention", flash_t), ("flash_attention", rg_flash_t),
                   ("decode_attention", decode_t), ("decode_attention", rg_decode_t),
                   ("rglru_scan", scan_t)):
        lm_err[key] = max(lm_err[key], t[0])
    kernel_src = "src/repro_torch/kernels/{0}/csrc/{0}.cu"
    for key, replaces, timing, rg_timing in (
        ("flash_attention", "src/repro/kernels/flash_attention/kernel.py:102", flash_t, rg_flash_t),
        ("decode_attention", "src/repro/kernels/decode_attention/kernel.py:75", decode_t,
         rg_decode_t),
    ):
        # At qwen1.5-0.5b's shapes and launches, as since the kernel was
        # ported; recurrentgemma-2b's beside them.
        rec = _record(key, kernel_src.format(key), replaces, qwen_launches[key], lm_err[key],
                      timing)
        rg = _record(key, kernel_src.format(key), replaces, rg_launches[key], lm_err[key],
                     rg_timing)
        rec["recurrentgemma-2b"] = {k: rg[k] for k in ("launches", "ms", "plain_ms", "bound_ms",
                                                        "bound_by", "library_ms")}
        records.append(rec)
    records.append(_record("rglru_scan", kernel_src.format("rglru_scan"),
                           "src/repro/kernels/rglru_scan/kernel.py:50",
                           rg_launches["rglru_scan"], lm_err["rglru_scan"], scan_t))
    wall["phases_7_9_s"] = time.perf_counter() - t_lm

    # [10] and [11] streaming runtime ----------------------------------------
    t_rt = time.perf_counter()
    records.append(runtime_phases(torch, np, P, ops, cut_ops, cluster, ref_gpu, wall))
    wall["phases_10_11_s"] = time.perf_counter() - t_rt

    # [12] and [13] multi-tenant scheduling and observability ---------------
    t_mt = time.perf_counter()
    mt_launches, fleets = multitenant_phases(torch, np, P, ops, cut_ops, wall)
    wall["phases_12_13_s"] = time.perf_counter() - t_mt

    # [14] the paper's reproduction and the other benchmarks ---------
    paper_launches = paper_phase(torch, ops, cut_ops, fleets, wall, smi)
    # Each kernel's launches on the paths that run it: the main and resource
    # refines (phases 3-4) or the online runtime (phase 10), the multi-tenant
    # paths (phase 12) and the benchmarks (phase 14).
    for rec in records:
        if rec["name"] in paper_launches:
            earlier = "phase 10" if rec["name"] == "policy_scan" else "phases 3-4"
            print(f"  {rec['name']}: {rec['launches']} launches in {earlier}, "
                  f"{mt_launches.get(rec['name'], 0)} in phase 12, "
                  f"{paper_launches[rec['name']]} in phase 14")
            rec["launches"] += mt_launches.get(rec["name"], 0) + paper_launches[rec["name"]]

    # [15] the MoE family ---------------------------------------------------
    moe_timings = moe_phase(torch, F, M, serve, flash_ops, decode_ops, scan_ops,
                            flash_attention_ref, decode_attention_ref, wall, smi)
    for rec in records:
        if rec["name"] in moe_timings:
            launches, timing = moe_timings[rec["name"]]
            granite = _record(rec["name"], rec["source"], rec["replaces"], launches,
                              timing[0], timing)
            rec["granite-moe-1b-a400m"] = {k: granite[k] for k in (
                "launches", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
            print(f"  {rec['name']}: {rec['launches']} launches in phase 8 (qwen1.5-0.5b), "
                  f"{launches} in phase 15 (granite-moe-1b-a400m)")
            rec["launches"] += launches
            rec["max_abs_err"] = max(rec["max_abs_err"], timing[0])

    # [16] xLSTM and the Whisper encoder-decoder ------------------------------
    whisper_timings = xlstm_whisper_phase(torch, F, M, serve, flash_ops, decode_ops, scan_ops,
                                          flash_attention_ref, decode_attention_ref, wall, smi)
    for rec in records:
        if rec["name"] in whisper_timings:
            launches, shapes = whisper_timings[rec["name"]]
            nested = {"launches": launches}
            for shape, timing in shapes.items():
                one = _record(rec["name"], rec["source"], rec["replaces"], launches, timing[0],
                              timing)
                nested[shape] = {k: one[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                     "library_ms")}
                rec["max_abs_err"] = max(rec["max_abs_err"], timing[0])
            rec["whisper-tiny"] = nested
            print(f"  {rec['name']}: {launches} launches in phase 16 (whisper-tiny)")
            rec["launches"] += launches
    # The sLSTM kernel: no TPU kernel; it replaces the reference's lax.scan.
    slstm_launches, slstm = whisper_timings["slstm_scan"]
    # Top level: the prefill in the plan's layout; ``decode`` a decode step in
    # the plan's layout; ``layouts`` both layouts at both shapes.
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    pre_layout, dec_layout = slstm["chosen"]
    times = slstm["times"]
    rec = _record("slstm_scan", kernel_src.format("slstm_scan"), "src/repro/models/xlstm.py:312",
                  slstm_launches, slstm["max_err"], times[pre_layout][0][:5])
    decode = _record("slstm_scan", rec["source"], rec["replaces"], slstm_launches,
                     slstm["max_err"], times[dec_layout][1][:5])
    rec.update(shape="B=8 S=512 d=768 float32", layout=pre_layout,
               serial_floor_ms=times[pre_layout][0][5],
               decode={"shape": "B=8 S=1 d=768 float32", "layout": dec_layout,
                       "serial_floor_ms": times[dec_layout][1][5],
                       **{k: decode[k] for k in keys}},
               layouts={layout: {shape: {"ms": t[1], "serial_floor_ms": t[5]}
                                 for shape, t in zip(("prefill", "decode"), pair)}
                        for layout, pair in times.items()})
    records.append(rec)
    print(f"  slstm_scan: {slstm_launches} launches in phase 16 (xlstm-125m)")

    # [17] qwen2-vl-72b's backbone --------------------------------------------
    vlm_timings = vlm_phase(torch, F, M, serve, flash_ops, decode_ops, scan_ops,
                            flash_attention_ref, decode_attention_ref, wall, smi)
    shapes = {"flash_attention": "B=8 S=512 H=64 Hkv=8 D=128 causal",
              "decode_attention": "B=8 H=64 Hkv=8 S=576 lengths 575 D=128"}
    for rec in records:
        if rec["name"] in vlm_timings:
            launches, timing = vlm_timings[rec["name"]]
            one = _record(rec["name"], rec["source"], rec["replaces"], launches, timing[0], timing)
            rec["qwen2-vl-72b"] = {"shape": shapes[rec["name"]], **{k: one[k] for k in (
                "launches", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
            rec["max_abs_err"] = max(rec["max_abs_err"], timing[0])
            print(f"  {rec['name']}: {launches} launches in phase 17 (qwen2-vl-72b)")
            rec["launches"] += launches

    # [18] the LM-serving planner ----------------------------------------------
    planner_b1 = planner_phase(torch, ops, wall, smi)
    for rec in records:
        if rec["name"] == "sched_scoring":
            print(f"  sched_scoring: {planner_b1} launches in phase 18 (the planner's refine)")
            rec["launches"] += planner_b1
    # [19] training, then serving from the trained weights ------------------------
    train_launches = train_phase(torch, M, serve, flash_ops, decode_ops, scan_ops,
                                 rglru_scan_ref, wall, smi)
    for rec in records:
        if rec["name"] in train_launches:
            print(f"  {rec['name']}: {train_launches[rec['name']]} launches in phase 19 (serving "
                  f"the trained qwen1.5-0.5b)")
            rec["launches"] += train_launches[rec["name"]]
    # [20] RG-LRU training through B5 and its backward kernel --------------------
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_bwd_ref

    rg_train, bwd_timing = rglru_train_phase(torch, M, flash_ops, decode_ops, scan_ops,
                                             rglru_scan_bwd_ref, wall, smi)
    for rec in records:
        if rec["name"] == "rglru_scan":
            print(f"  rglru_scan: {rec['launches']} launches in phase 8, "
                  f"{rg_train['rglru_scan']} in phase 20 (training recurrentgemma-2b)")
            rec["launches"] += rg_train["rglru_scan"]
    # [21] the mesh route: dry-run cells, then train steps on a 1 x 1 mesh ------------
    mesh_b5 = mesh_phase(torch, M, flash_ops, decode_ops, scan_ops, wall, smi)
    for rec in records:
        if rec["name"] == "rglru_scan":
            print(f"  rglru_scan: {mesh_b5['rglru_scan']} launches in phase 21 (local_map)")
            rec["launches"] += mesh_b5["rglru_scan"]
    records.append(_record("rglru_scan_bwd", kernel_src.format("rglru_scan"),
                           "src/repro/models/rglru.py:95",
                           rg_train["rglru_scan_bwd"] + mesh_b5["rglru_scan_bwd"],
                           bwd_timing[0], bwd_timing))
    print(f"  rglru_scan_bwd: {rg_train['rglru_scan_bwd']} launches in phase 20, "
          f"{mesh_b5['rglru_scan_bwd']} in phase 21 (local_map)")
    slstm_rec = next(rec for rec in records if rec["name"] == "slstm_scan")
    print(f"  slstm_scan: {mesh_b5['slstm_scan']} launches in phase 21 (local_map)")
    slstm_rec["launches"] += mesh_b5["slstm_scan"]
    # [22] wide clusters: the scheduler's kernels past their one-block layouts --------
    from repro_torch.kernels.policy_scan import ops as policy_ops

    wide = wide_phase(torch, np, P, ops, cut_ops, policy_ops, sched.etg, wall)
    for rec in records:
        if rec["name"] in wide:
            launches, timing = wide[rec["name"]]
            rec["wide_cluster"] = {"launches": launches, **timing}
            print(f"  {rec['name']}: {launches} launches in phase 22 (wide clusters)")
            rec["launches"] += launches
    # [23] xLSTM training through slstm_scan and its backward kernel ------------------
    xl_train, bwd_err, bwd_times, bwd_layout, bwd_parts = xlstm_train_phase(
        torch, M, flash_ops, decode_ops, scan_ops, wall, smi)
    print(f"  slstm_scan: {xl_train['slstm_scan']} launches in phase 23 (training xlstm-125m)")
    slstm_rec["launches"] += xl_train["slstm_scan"]
    # The backward: no TPU kernel; it replaces autograd through the reference's
    # lax.scan. Top level: the training shape in the plan's layout (the whole
    # call; in the cluster layout its loop and rest pass apart); ``layouts``
    # both layouts with their serial floors. Its rest kernel's own record:
    # the cluster layout's rest pass alone.
    shape = f"B={TRAIN_B} S={TRAIN_S} d=768 float32"
    rec = _record("slstm_scan_bwd", kernel_src.format("slstm_scan"),
                  "src/repro/models/xlstm.py:312",
                  xl_train["slstm_scan_bwd"] + mesh_b5["slstm_scan_bwd"], bwd_err,
                  bwd_times[bwd_layout][:5])
    rec.update(shape=shape, layout=bwd_layout, serial_floor_ms=bwd_times[bwd_layout][5],
               loop_ms=bwd_parts["loop_ms"], rest_ms=bwd_parts["rest"][1],
               parent_ms=bwd_parts["parent_ms"], parent_equal=bwd_parts["parent_equal"],
               layouts={layout: {"ms": t[1], "serial_floor_ms": t[5]}
                        for layout, t in bwd_times.items()})
    records.append(rec)
    rest = _record("slstm_scan_bwd_rest", rec["source"], rec["replaces"],
                   xl_train["slstm_scan_bwd_rest"] + mesh_b5["slstm_scan_bwd_rest"],
                   bwd_parts["rest"][0], bwd_parts["rest"])
    rest.update(shape=shape, layout="cluster")
    records.append(rest)
    print(f"  slstm_scan_bwd: {xl_train['slstm_scan_bwd']} launches in phase 23, "
          f"{mesh_b5['slstm_scan_bwd']} in phase 21 (local_map); slstm_scan_bwd_rest: "
          f"{xl_train['slstm_scan_bwd_rest']} and {mesh_b5['slstm_scan_bwd_rest']}")
    wall["total_s"] = time.perf_counter() - t_start
    print("  wall: " + ", ".join(f"{k} {v:.3f}" for k, v in wall.items()))

    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
