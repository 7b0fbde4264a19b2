"""Network-aware vs distance-blind placement, on the port.

Port of ``benchmarks/bench_netaware.py``: on rack-structured clusters, does
pricing cut traffic into the closed form (R* = min_w (cap_w - met_w) /
(var_w + net_w)) buy throughput over the distance-blind scalar-CPU
schedule? Every ``refine`` and ``optimal_schedule`` sweep scores on
``device`` (the reference's ``backend="numpy"``): on a card the
network-aware sweeps run the resource scorer (B2) and the cut-traffic
kernel, the blind ones B1. Scores agree with the reference's to 1e-12
(the distances' contraction sums in machine order; ROADMAP C-port-1).

Per scenario both pipelines start from the same ``schedule`` + ``refine``
run on ``cluster.without_network()``. The *blind* row re-scores that
placement on the true network-aware objective; the *aware* row hands the
same placement to ``refine`` on the full cluster (the tiny shuffle-heavy
scenario runs the exhaustive network-aware ``optimal_schedule`` instead:
its colocation win sits across a hill-climb barrier). ``aware >= blind``
must hold on every row.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import (
    UserGraph,
    max_stable_rate,
    optimal_schedule,
    paper_cluster,
    rack_distance_matrix,
    refine,
    rolling_count_topology,
    schedule,
    wide_fanout_topology,
)
from repro_torch.paper.common import cli, emit, sync, write_json

MEM = np.array([1.0, 2.0, 3.0, 4.0])

MEASURED = frozenset()


def _shuffle_heavy(alpha: float = 4.0) -> UserGraph:
    """One hot shuffle edge: a spout fanning ``alpha`` tuples per input
    into a mid-type bolt — the cut-traffic-dominated shape."""
    return UserGraph(
        name="shuffle_heavy",
        component_types=np.array([0, 2]),
        edges=((0, 1),),
        alpha=np.array([alpha, 1.0]),
    )


def _racked(counts, racks, net_penalty, cross_rack=2.0, with_memory=False):
    profile = paper_cluster((1, 1, 1)).profile
    if with_memory:
        profile = profile.with_mem(MEM)
    cluster = paper_cluster(counts, profile)
    if with_memory:
        cluster = cluster.with_resources(
            mem_capacity=np.full(cluster.n_machines, 4.0 * float(MEM.sum()))
        )
    return cluster.with_resources(
        distance=rack_distance_matrix(np.asarray(racks), cross_rack=cross_rack),
        net_penalty=net_penalty,
    )


SCENARIOS = [
    # The colocation-wins golden: two same-type machines on different
    # racks, penalty steep enough that splitting the shuffle edge costs
    # more than the CPU headroom buys (exhaustive search, see above).
    (
        "shuffle_heavy_2rack",
        _shuffle_heavy(),
        _racked((0, 2, 0), [0, 1], 10.0),
        "optimal",
    ),
    # Paper topology on a 6-machine 2-rack cluster with a mild penalty:
    # the regime where CPU stays primary and network breaks ties.
    (
        "rolling_count_2rack",
        rolling_count_topology(),
        _racked((2, 2, 2), [0, 0, 0, 1, 1, 1], 1.0),
        "refine",
    ),
    # High-fan-out DAG across 3 racks with memory attached — the full
    # resource vector (CPU + memory + network) in one sweep.
    (
        "wide_fanout_3rack_mem",
        wide_fanout_topology(),
        _racked(
            (2, 2, 2), [0, 0, 1, 1, 2, 2], 2.0, cross_rack=3.0,
            with_memory=True,
        ),
        "refine",
    ),
]


def scenario_row(name: str, utg, cluster, engine: str, device="cuda") -> dict:
    device = resolve_device(device)
    blind_cluster = cluster.without_network()
    t0 = time.perf_counter()
    seed = schedule(utg, blind_cluster, r0=1.0, rate_epsilon=0.5)
    blind = refine(seed.etg, blind_cluster, device=device)
    sync(device)
    t_blind = time.perf_counter() - t0
    # Same placement, true objective: what the distance-blind engine
    # actually sustains once cut traffic is priced.
    _, blind_true = max_stable_rate(blind.etg, cluster)

    t0 = time.perf_counter()
    if engine == "optimal":
        # Budget = the blind engine's own task count, so the blind
        # placement is inside the searched space and optimal >= blind
        # holds structurally, same as the refine seeding.
        aware = optimal_schedule(
            utg, cluster, max_total_tasks=int(blind.etg.total_tasks), device=device
        )
    else:
        aware = refine(blind.etg, cluster, device=device)
    sync(device)
    t_aware = time.perf_counter() - t0
    aware_true = float(aware.throughput)
    _, check_rate = max_stable_rate(aware.etg, cluster)

    tm_blind = blind.etg.task_machine()
    tm_aware = aware.etg.task_machine()
    gain = (aware_true - float(blind_true)) / max(float(blind_true), 1e-12)
    return {
        "scenario": name,
        "engine": engine,
        "n_machines": cluster.n_machines,
        "net_penalty": float(cluster.net_penalty),
        "has_memory": bool(cluster.has_memory),
        "blind_rate_true_objective": float(blind_true),
        "aware_rate": aware_true,
        "gain_pct": round(100.0 * gain, 3),
        "aware_ge_blind": bool(aware_true >= float(blind_true) * (1 - 1e-12)),
        "rescore_consistent": bool(
            abs(check_rate - aware_true) <= 1e-9 * max(1.0, aware_true)
        ),
        "blind_tasks": int(tm_blind.size),
        "aware_tasks": int(tm_aware.size),
        "moved_tasks": (
            int(np.sum(tm_blind != tm_aware))
            if tm_blind.size == tm_aware.size else None
        ),
        "blind_machines_used": int(np.unique(tm_blind).size),
        "aware_machines_used": int(np.unique(tm_aware).size),
        "blind_wall_s": round(t_blind, 4),
        "aware_wall_s": round(t_aware, 4),
    }


def main(device="cuda", json_path=None) -> list:
    device = resolve_device(device)
    results = [
        scenario_row(name, utg, cluster, engine, device)
        for name, utg, cluster, engine in SCENARIOS
    ]
    rows = [
        emit(
            f"netaware_{row['scenario']}",
            row["aware_wall_s"] * 1e6,
            f"blind={row['blind_rate_true_objective']:.4f};"
            f"aware={row['aware_rate']:.4f};gain_pct={row['gain_pct']};"
            f"aware_ge_blind={row['aware_ge_blind']}",
        )
        for row in results
    ]
    write_json(json_path, {"scenarios": results})
    return rows


if __name__ == "__main__":
    main(**cli(__doc__))
