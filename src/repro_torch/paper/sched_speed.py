"""§3 — scheduler wall-time vs the exhaustive optimal search, plus the
scheduler-engine perf baseline, on the port.

Port of ``benchmarks/bench_sched_speed.py``. The paper reports the optimal
scheduler checking 27 405 possibilities in ~18 hours on a 4-socket Xeon
server; the batched closed-form evaluator covers a larger design space in
seconds, and the proposed heuristic is another 2-3 orders faster.

The large scenario (20/70/90 machines, 478 tasks) times ``schedule()``.
The port has no ``engine="reference"`` (README), so ``identical_schedule``
holds the schedule against the reference engine's frozen result (its rate,
instance counts, iterations and the md5 of its placement), which
``tests/test_sched_equivalence.py`` pins for ``repro``. ``simulate_batch``
placements/sec are timed on the CPU and, on a card, on ``device="cuda"``,
with the two paths' max relative difference.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import (
    linear_topology,
    optimal_schedule,
    paper_cluster,
    schedule,
    simulate_batch,
)
from repro_torch.core.refine import refine
from repro_torch.paper.common import cli, emit, sync, write_json

LARGE = (20, 70, 90)
SIM_BATCH = 2048
# The reference engine's schedule of the large scenario
# (``tests/test_sched_equivalence.py::test_large_scenario_golden``).
LARGE_REFERENCE = dict(rate=297.0, n_instances=[2, 56, 210, 210], iterations=46,
                       md5="1dfed7471c737dcb63fc259cb03ffe02")

MEASURED = frozenset({
    "heuristic", "optimal", "speedup_vs_paper", "reference_s", "speedup",
    "numpy_placements_per_s", "jax_placements_per_s", "jax_speedup",
    "cpu_placements_per_s", "cuda_placements_per_s", "cuda_speedup", "cuda_vs_cpu_max_rel",
})


def bench_engines() -> dict:
    """Large-scenario schedule() wall time, held against the reference's."""
    cluster = paper_cluster(LARGE)
    topo = linear_topology()

    t0 = time.perf_counter()
    inc = schedule(topo, cluster, r0=1.0, rate_epsilon=1.0)
    t_inc = time.perf_counter() - t0

    md5 = hashlib.md5(inc.etg.task_machine().tobytes()).hexdigest()
    return {
        "scenario": "large_linear_20_70_90",
        "tasks": int(inc.etg.total_tasks),
        "iterations": inc.iterations,
        "rate": inc.rate,
        "incremental_s": round(t_inc, 4),
        "identical_schedule": bool(
            inc.rate == LARGE_REFERENCE["rate"]
            and inc.etg.n_instances.tolist() == LARGE_REFERENCE["n_instances"]
            and inc.iterations == LARGE_REFERENCE["iterations"]
            and md5 == LARGE_REFERENCE["md5"]
        ),
    }


def bench_sim_backends(device="cuda") -> dict:
    """simulate_batch placements/sec on the CPU and on ``device``."""
    device = resolve_device(device)
    cluster = paper_cluster((10, 10, 10))
    etg = schedule(linear_topology(), cluster, r0=1.0, rate_epsilon=1.0).etg
    rng = np.random.default_rng(0)
    tm = rng.integers(0, cluster.n_machines, size=(SIM_BATCH, etg.total_tasks))
    r0 = 60.0

    t0 = time.perf_counter()
    cpu = simulate_batch(etg, cluster, tm, r0, device="cpu")
    t_cpu = time.perf_counter() - t0
    out = {
        "batch": SIM_BATCH,
        "tasks": int(etg.total_tasks),
        "cpu_placements_per_s": round(SIM_BATCH / t_cpu, 1),
    }
    if device.type == "cuda":
        simulate_batch(etg, cluster, tm, r0, device=device)  # warm
        sync(device)
        t0 = time.perf_counter()
        card = simulate_batch(etg, cluster, tm, r0, device=device)
        sync(device)
        t_card = time.perf_counter() - t0
        rel = max(
            float(np.max(np.abs(getattr(card, f) - getattr(cpu, f))
                         / np.maximum(np.abs(getattr(cpu, f)), 1e-300)))
            for f in ("ir", "pr", "tcu", "machine_util", "throughput")
        )
        out["cuda_placements_per_s"] = round(SIM_BATCH / t_card, 1)
        out["cuda_speedup"] = round(t_cpu / t_card, 1)
        out["cuda_vs_cpu_max_rel"] = rel
    return out


def main(device="cuda", json_path=None) -> list:
    device = resolve_device(device)
    cluster = paper_cluster((1, 1, 1))
    topo = linear_topology()

    t0 = time.perf_counter()
    sched = schedule(topo, cluster, r0=1.0, rate_epsilon=0.05)
    refine(sched.etg, cluster, device=device)
    sync(device)
    t_heur = time.perf_counter() - t0

    t0 = time.perf_counter()
    opt = optimal_schedule(topo, cluster, max_total_tasks=10, device=device)
    sync(device)
    t_opt = time.perf_counter() - t0

    rows = [emit(
        "sec3_scheduler_walltime",
        t_heur * 1e6,
        f"heuristic={t_heur*1e3:.1f}ms;optimal={t_opt:.2f}s;"
        f"candidates={opt.candidates_evaluated};"
        f"paper_optimal=18h@27405cands;"
        f"speedup_vs_paper={(18*3600)/max(t_opt,1e-9):,.0f}x",
    )]

    engines = bench_engines()
    rows.append(emit(
        "sched_engine_large",
        engines["incremental_s"] * 1e6,
        ";".join(f"{k}={v}" for k, v in engines.items() if k != "incremental_s"),
    ))
    sim = bench_sim_backends(device)
    rows.append(emit(
        "sim_batch_backends",
        0.0,
        ";".join(f"{k}={v}" for k, v in sim.items()),
    ))
    write_json(json_path, {"schedule": engines, "simulate_batch": sim})
    return rows


if __name__ == "__main__":
    main(**cli(__doc__))
