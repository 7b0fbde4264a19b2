"""Figs. 3 & 8 — throughput of default / proposed / proposed+refine /
optimal schedulers on the Micro-Benchmark topologies over the paper's
3-worker heterogeneous cluster, on the port.

Port of ``benchmarks/bench_throughput.py``: ``refine`` and
``optimal_schedule`` score their sweeps on ``device``.

Paper claims: proposed gives 7-44 % over the default scheduler and lands
within 4 % (worst case) of the optimal scheduler. We report the faithful
Alg. 1+2 result and the beyond-paper refined result separately.
"""

from __future__ import annotations

import time

from repro_torch import resolve_device
from repro_torch.core import (
    diamond_topology,
    linear_topology,
    max_stable_rate,
    optimal_schedule,
    paper_cluster,
    round_robin_schedule,
    schedule,
    star_topology,
)
from repro_torch.core.refine import refine
from repro_torch.paper.common import cli, emit, sync, write_json

MEASURED = frozenset()


def run_topology(topo_fn, device="cuda") -> dict:
    device = resolve_device(device)
    cluster = paper_cluster((1, 1, 1))
    topo = topo_fn()

    t0 = time.perf_counter()
    sched = schedule(topo, cluster, r0=1.0, rate_epsilon=0.05)
    t_sched = time.perf_counter() - t0
    _, ours = max_stable_rate(sched.etg, cluster)

    t0 = time.perf_counter()
    ref = refine(sched.etg, cluster, device=device)
    sync(device)
    t_refine = time.perf_counter() - t0

    rr = round_robin_schedule(topo, cluster, sched.etg.n_instances)
    _, default = max_stable_rate(rr, cluster)

    t0 = time.perf_counter()
    opt = optimal_schedule(
        topo, cluster, max_total_tasks=max(ref.etg.total_tasks + 1, 8), device=device
    )
    sync(device)
    t_opt = time.perf_counter() - t0

    return {
        "topology": topo.name,
        "default": default,
        "proposed": ours,
        "refined": ref.throughput,
        "optimal": opt.throughput,
        "gain_vs_default_pct": (ours / default - 1) * 100,
        "refined_gain_vs_default_pct": (ref.throughput / default - 1) * 100,
        "below_optimal_pct": (1 - ours / opt.throughput) * 100,
        "refined_below_optimal_pct": (1 - ref.throughput / opt.throughput) * 100,
        "t_sched_us": t_sched * 1e6,
        "t_refine_us": t_refine * 1e6,
        "t_optimal_us": t_opt * 1e6,
        "optimal_candidates": opt.candidates_evaluated,
    }


def main(device="cuda", json_path=None) -> list:
    device = resolve_device(device)
    rows, results = [], []
    for topo_fn in (linear_topology, diamond_topology, star_topology):
        r = run_topology(topo_fn, device)
        results.append(r)
        rows.append(emit(
            f"fig8_throughput_{r['topology']}",
            r["t_sched_us"],
            f"default={r['default']:.1f};proposed={r['proposed']:.1f};"
            f"refined={r['refined']:.1f};optimal={r['optimal']:.1f};"
            f"gain={r['gain_vs_default_pct']:.1f}%(paper 7-44%);"
            f"below_opt={r['below_optimal_pct']:.1f}%;"
            f"refined_below_opt={r['refined_below_optimal_pct']:.1f}%(paper<=4%)",
        ))
    write_json(json_path, {"throughput": results})
    return rows


if __name__ == "__main__":
    main(**cli(__doc__))
