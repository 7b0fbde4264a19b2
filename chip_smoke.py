#!/usr/bin/env python3
"""Chip smoke of the PyTorch + CUDA port: builds the kernels, drives the
paper's main path, the LM serving paths, the streaming runtime, multi-tenant
scheduling and the paper's reproduction on one NVIDIA GPU, holds every
kernel against its plain PyTorch version, and prints the kernels' numbers.

Run from the root of a checkout, with no arguments: ``python3 chip_smoke.py``.
Phases (each raises on failure; nothing is caught):

1. build the six kernel sources (``sched_scoring.cu``, ``cut_traffic.cu``,
   ``flash_attention.cu``, ``decode_attention.cu``, ``rglru_scan.cu``,
   ``policy_scan.cu``) for sm_90a, one nvcc each, all at once; card name
   and power limit;
2. the scorer (B1, B2) against its plain version on the card, over the
   scoring regimes and edge shapes (ids outside [0, m) among them), and the
   cut-traffic kernel against its plain version over shared, per-row and
   skew maps, m = 1, 3 and 180 in racks, on the linear, diamond, star and
   wide-fanout topologies, at shapes past one round of its product, past
   its widest tiles and past shared memory (98 contracted components at
   m = 180, 18 at m = 1000), and with ids outside [0, m) (identical
   feasibility mask and argmax, max abs error 0); the scorer at its
   ``max_machines`` limit (B1 with shared and per-row maps, B2 with memory
   and network), and one machine past it, refused by a ValueError before
   any launch;
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
   the waves;
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
   cut_traffic and policy_scan launches and its walls.

Every phase's wall is printed at the end. The reference's results for
phases 3-5, 12 and 14 are constants below; ``tests/test_torch_multitenant_golden.py``
and ``tests/test_torch_multitenant_runtime_golden.py`` recompute phase 12's,
``tests/test_torch_paper_*.py`` phase 14's.
The last lines are the ``{"kernels": [...]}`` record (B1, B2 and
cut_traffic count their launches in phases 3-4, 12 and 14, policy_scan
in phases 10 and 14), the card's ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": ...}``.
Without a CUDA device, or away from the repository, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import dataclasses
import json
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


def compare_kernel(torch, np, ops, args, extras):
    """Kernel on the card vs plain version (CPU) on the same inputs; returns
    the max abs error after checking mask and argmax."""
    cpu_args, cpu_kw = to_tensors(torch, np, "cpu", args, extras)
    gpu_args, gpu_kw = to_tensors(torch, np, "cuda", args, extras)
    plain = ops.sched_scoring(*cpu_args, **cpu_kw).numpy()
    got = ops.sched_scoring(*gpu_args, **gpu_kw)
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


def serve_run(torch, kernel_ops, M, serve, cfg, params, B, prompt_len, gen_len, expected, wall):
    """Serve at full width on the card with every launch count set to 0
    just before; check the launches of the run against ``expected`` and
    return them. A set-up run at the same batch and prompt length first
    (allocator growth, cuBLAS's first calls at these shapes), so the times
    are those of a warm server."""
    n_params = sum(t.numel() for t in _leaves(params))
    serve(cfg, batch=B, prompt_len=prompt_len, gen_len=2, params=params, device="cuda")
    for ops in kernel_ops:
        ops.reset_launches()
    res = serve(cfg, batch=B, prompt_len=prompt_len, gen_len=gen_len, params=params,
                device="cuda")
    launches = {k: v for ops in kernel_ops for k, v in ops.LAUNCHES.items()}
    check(launches == expected, f"{cfg.name}: launches {launches}, not {expected}")
    toks = res.tokens
    check(tuple(toks.shape) == (B, gen_len) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab_size, "served tokens out of shape or vocabulary")
    wall[f"{cfg.name}_prefill_s"], wall[f"{cfg.name}_decode_s"] = res.prefill_s, res.decode_s
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.resolved_head_dim}, {n_params / 1e6:.1f} M parameters in {cfg.param_dtype}")
    print(f"  served {B} requests x {prompt_len} prompt + {gen_len} generated tokens: prefill "
          f"{res.prefill_s:.4f} s ({B * prompt_len / res.prefill_s:,.0f} prompt tok/s), decode "
          f"{res.decode_s:.4f} s for {gen_len - 1} steps ({B * (gen_len - 1) / res.decode_s:,.1f} "
          f"tok/s, {1e3 * res.decode_s / (gen_len - 1):.3f} ms/step); launches {launches}")
    print(f"  sample output ids: {toks[0, :12].tolist()}")
    return launches


def cpu_check(torch, M, cfg, params, Bc, Pc, steps) -> None:
    """The same weights on the CPU in float32, teacher-forced with the card's
    tokens: the card's bf16 logits within ``LOGIT_TOL`` at every step."""
    prompt = torch.randint(0, cfg.vocab_size, (Bc, Pc),
                           generator=torch.Generator().manual_seed(2))
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    params32 = _map_leaves(params, lambda t: t.float().cpu())
    card_c = M.init_caches(cfg, Bc, Pc + steps, device="cuda")
    cpu_c = M.init_caches(cfg32, Bc, Pc + steps, device="cpu")
    card_l, card_c = M.prefill(params, cfg, {"tokens": prompt}, card_c, device="cuda")
    cpu_l, cpu_c = M.prefill(params32, cfg32, {"tokens": prompt}, cpu_c, device="cpu")
    worst = (0.0, 0.0)
    agree = 0
    for step in range(steps + 1):
        got = card_l.float().cpu()
        check(bool(torch.isfinite(got).all()) and tuple(got.shape) == (Bc, cfg.vocab_size),
              f"card logits at step {step}: non-finite or misshapen")
        rel_l2 = float((got - cpu_l).norm() / cpu_l.norm())
        rel_max = float((got - cpu_l).abs().max() / cpu_l.abs().max())
        check(rel_l2 <= LOGIT_TOL and rel_max <= LOGIT_TOL,
              f"step {step}: card vs CPU logits differ by {rel_l2:.4f} (l2) / {rel_max:.4f} "
              f"(max) over {LOGIT_TOL}")
        worst = (max(worst[0], rel_l2), max(worst[1], rel_max))
        tok = got.argmax(-1)
        agree += int((tok == cpu_l.argmax(-1)).sum())
        if step < steps:
            card_l, card_c = M.decode_step(params, cfg, {"tokens": tok[:, None]}, card_c,
                                           device="cuda")
            cpu_l, cpu_c = M.decode_step(params32, cfg32, {"tokens": tok[:, None]}, cpu_c,
                                         device="cpu")
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


def time_flash(torch, F, flash_ops, flash_ref, B, S, H, Hkv, D, window):
    """B3 at (B, S, H, Hkv, D), bf16, causal: (max abs err, ms, plain ms,
    bound, library ms) and a printed line."""
    from repro_torch.launch.timing import time_cuda
    gen = torch.Generator(device="cuda").manual_seed(9)
    bf16 = dict(device="cuda", dtype=torch.bfloat16)
    q, k, v = (torch.randn(shape, generator=gen, **bf16)
               for shape in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    kw = dict(causal=True, window=window)
    err = attention_error(torch, f"B3 at B={B} S={S} H={H}",
                          flash_ops.flash_attention(q, k, v, **kw), flash_ref(q, k, v, **kw))
    ms = time_cuda(lambda: flash_ops.flash_attention(q, k, v, **kw))
    plain_ms = time_cuda(lambda: flash_ref(q, k, v, **kw), reps=5)
    lib_ms = time_cuda(sdpa_call(torch, F, q, k, v, True, window))
    # (query, key) pairs that the causal and window masks leave.
    pairs = B * H * sum(min(i + 1, window or S) for i in range(S))
    flops = 4 * D * pairs
    n_bytes = 2 * B * S * (2 * H + 2 * Hkv) * D  # bf16 q, k, v read and o written once
    bound = _bound(flops / BF16_FLOPS_PER_S, n_bytes / HBM_BYTES_PER_S)
    print(f"  B3 flash_attention B={B} S={S} H={H} Hkv={Hkv} D={D} window={window} bf16 causal: "
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
    flops = 2 * B * k2 * m * m + 4 * B * len(edges) * m + 3 * B * T  # products and sums
    n_bytes = sum(x.numel() * x.element_size() for x in (*g_args, g_dist)) + B * m * 8
    bound = _bound(flops / FP64_FLOPS_PER_S, n_bytes / HBM_BYTES_PER_S)
    print(f"  cut_traffic B={B} T={T} m={m} ({len(edges)} edges, {k2} contracted rows a row): "
          f"{ms:.4f} ms ({wrapper_ms:.4f} ms with the wrapper's host time), bound "
          f"{bound[0]:.4f} ms by {bound[1]} ({flops / 1e9:.3f} GFLOP, "
          f"{n_bytes / 1e6:.2f} MB; {100 * bound[0] / ms:.1f}% of it), plain {plain_ms:.3f} ms; "
          f"no single PyTorch call computes it, so library_ms is null")
    plan = cut_kernel.launch_plan(B, T, k2, m)
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


def _bound(op_s, byte_s):
    """(ms, what bounds it): the larger of the operations' and the bytes' times."""
    return (max(op_s, byte_s) * 1e3, "operations" if op_s >= byte_s else "bytes")


def _record(name, source, replaces, launches, max_err, timing):
    _err, ms, plain_ms, bound, lib_ms = timing
    return dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches,
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                bound_by=bound[1], library_ms=lib_ms)


def main() -> int:
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
                      scan_policy_kernel)
    with ThreadPoolExecutor(len(kernel_modules)) as pool:  # one nvcc per source, all at once
        builds = [pool.submit(k.load_library) for k in kernel_modules]
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
    print(f"  all six built in {wall['build_s']:.2f} s")

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
    # The scorer's limit on m (ROADMAP C-port-4): at ``max_machines`` of the
    # operands' layout B1 and B2 launch and equal their plain versions; one
    # machine more raises a ValueError naming the limit, before any launch.
    for label, kw in (("B1, shared maps", dict(n=4)),
                      ("B1, per-row maps", dict(n=4, per_row=True)),
                      ("B2, memory + network", dict(n=4, memory=True, network=True))):
        limit = ops.max_machines(kw.get("memory", False), kw.get("per_row", False),
                                 kw.get("per_row", False))
        args, extras = scoring_problem(np, 7, 8, 37, limit, **kw)
        err, _ = compare_kernel(torch, np, ops, args, extras)
        key = "sched_scoring_resources" if extras else "sched_scoring"
        max_err[key] = max(max_err[key], err)
        args, extras = scoring_problem(np, 7, 8, 37, limit + 1, **kw)
        g_args, g_kw = to_tensors(torch, np, "cuda", args, extras)
        before = dict(ops.LAUNCHES)
        try:
            ops.sched_scoring(*g_args, **g_kw)
            refused = ""
        except ValueError as e:  # the refusal under test, not a fallback
            refused = str(e)
        check(f"at most {limit} machines" in refused and ops.LAUNCHES == before,
              f"{label}: m = {limit + 1} was not refused before a launch ({refused!r})")
        print(f"  {label}: m = {limit} launches and equals its plain version; m = {limit + 1} "
              f"-> ValueError before any launch ({refused.split(' (')[0]})")

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
             rglru_scan=0), wall)
    cpu_check(torch, M, lm_cfg, params, 2, 128, 8)
    del params

    rg_cfg = get_config("recurrentgemma-2b")
    kinds = rg_cfg.resolved_block_pattern
    n_rec, n_local = kinds.count("rglru"), kinds.count("local_attn")
    params = M.init_params(rg_cfg, seed=0, device="cuda")
    rg_launches = serve_run(
        torch, lm_ops, M, serve, rg_cfg, params, 8, 2304, gen_len,
        dict(flash_attention=n_local, decode_attention=n_local * (gen_len - 1),
             rglru_scan=n_rec), wall)
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
    print("  wall: " + ", ".join(f"{k} {v:.3f}" for k, v in wall.items()))

    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
