"""Refine/optimal engine walls, on the port.

Port of ``benchmarks/bench_refine.py``. The reference times its ``state``
engines against its per-candidate ``reference`` engines; the port has only
the state engines (README: the reference engines and ``lockstep=False``
are left out), so it times those on ``device`` and holds each result
against the reference's (``REFERENCE``: moves, rate, throughput, the md5 of
the placement; ``repro``'s state engine, which its tests hold identical to
its reference engine). ``identical`` is that comparison.

Scenarios: the slow test suite's (the paper's 3-worker cluster,
rate_epsilon=0.05 schedules), the wide fan-out (14 mid bolts on 2/2/2,
lockstep growth chains), and the exhaustive search with the closed-form
beam bound (linear, 8 tasks).
"""

from __future__ import annotations

import hashlib
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import (
    diamond_topology,
    linear_topology,
    optimal_schedule,
    paper_cluster,
    schedule,
    star_topology,
    wide_fanout_topology,
)
from repro_torch.core.refine import refine
from repro_torch.paper.common import cli, emit, sync, write_json

TOPOLOGIES = (linear_topology, diamond_topology, star_topology)
SLOW_SUITE_CLUSTER = (1, 1, 1)
WIDE_CLUSTER = (2, 2, 2)
# The reference's results (``repro``, NumPy scoring); the placement as the
# md5 of its int64 task -> machine map.
REFERENCE = {
    "linear": (["grow c2x3", "swap c1#0<->c3#1"], 5.681851258914277, 22.727405035657107,
               "e2013f31f1446693c03fed14e7c94990"),
    "diamond": (["grow c1x3"], 2.560435818862785, 17.923050732039496,
                "cf48d29782668be779d43986f00db4e6"),
    "star": (["swap c2#0<->c4#1", "relocate c1#0 m1->m0"], 2.841403305305886,
             22.73122644244709, "466074e85d5ca05337f5b53482691c4e"),
    "wide": (["pairgrow c12x1+c14x1", "swap c11#0<->c15#5", "swap c2#0<->c4#0", "add c0->m3",
              "swap c6#1<->c15#7", "relocate c0#0 m2->m3"], 48.85110654516367,
             "6daf09281048f93a65eaa7b4d1e22685"),
    "optimal": (23.268698060941833, 26136, "bb28e365b515948fbc8f008e882a7d96"),
}

MEASURED = frozenset({
    "reference_total_s", "speedup", "sequential_s", "lockstep_speedup", "reference_s",
    "speedup_vs_reference",
})


def placement_md5(etg) -> str:
    return hashlib.md5(etg.task_machine().astype(np.int64).tobytes()).hexdigest()


def _median_time(fn, device, repeats: int = 5) -> float:
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def bench_refine_wide(device="cuda") -> dict:
    """Wide-topology refine (lockstep growth chains): 14 mid bolts ->
    C(16, 2) = 120 pair chains per round; timed as the median of 5 runs."""
    device = resolve_device(device)
    cluster = paper_cluster(WIDE_CLUSTER)
    topo = wide_fanout_topology(14)
    etg = schedule(topo, cluster, r0=1.0, rate_epsilon=0.1).etg
    lock = refine(etg, cluster, device=device)   # warm + results
    t_lock = _median_time(lambda: refine(etg, cluster, device=device), device)
    moves, throughput, md5 = REFERENCE["wide"]
    return {
        "scenario": f"{topo.name}_{'_'.join(map(str, WIDE_CLUSTER))}",
        "tasks": int(etg.total_tasks),
        "components": int(topo.n_components),
        "moves": len(lock.moves),
        "lockstep_s": round(t_lock, 4),
        "identical": bool(lock.moves == moves and lock.throughput == throughput
                          and placement_md5(lock.etg) == md5),
    }


def bench_refine_engines(device="cuda") -> dict:
    """Slow-suite refine scenario, the state engine per topology."""
    device = resolve_device(device)
    cluster = paper_cluster(SLOW_SUITE_CLUSTER)
    per_topo = []
    total_state = 0.0
    identical = True
    for topo_fn in TOPOLOGIES:
        topo = topo_fn()
        etg = schedule(topo, cluster, r0=1.0, rate_epsilon=0.05).etg
        refine(etg, cluster, device=device)  # warm any lazy imports
        sync(device)
        t0 = time.perf_counter()
        state = refine(etg, cluster, device=device)
        sync(device)
        t_state = time.perf_counter() - t0
        moves, rate, throughput, md5 = REFERENCE[topo.name]
        same = (state.moves == moves and state.rate == rate
                and state.throughput == throughput and placement_md5(state.etg) == md5)
        per_topo.append({
            "topology": topo.name,
            "tasks": int(etg.total_tasks),
            "moves": len(state.moves),
            "state_s": round(t_state, 4),
            "identical": bool(same),
        })
        total_state += t_state
        identical = identical and same
    return {
        "scenario": f"slow_suite_{'_'.join(map(str, SLOW_SUITE_CLUSTER))}",
        "topologies": per_topo,
        "state_total_s": round(total_state, 4),
        "identical": identical,
    }


def bench_optimal_engines(device="cuda") -> dict:
    """Exhaustive search: the vectorized state engine."""
    device = resolve_device(device)
    cluster = paper_cluster(SLOW_SUITE_CLUSTER)
    topo = linear_topology()
    max_total_tasks = 8
    optimal_schedule(topo, cluster, max_total_tasks=max_total_tasks, device=device)  # warm
    sync(device)
    t0 = time.perf_counter()
    state = optimal_schedule(topo, cluster, max_total_tasks=max_total_tasks, device=device)
    sync(device)
    t_state = time.perf_counter() - t0
    throughput, candidates, md5 = REFERENCE["optimal"]
    return {
        "scenario": f"linear_mtt{max_total_tasks}",
        "candidates": int(state.candidates_evaluated),
        "state_s": round(t_state, 4),
        "identical": bool(state.throughput == throughput
                          and state.candidates_evaluated == candidates
                          and placement_md5(state.etg) == md5),
    }


def main(device="cuda", json_path=None) -> list:
    device = resolve_device(device)
    ref_bench = bench_refine_engines(device)
    rows = [emit(
        "refine_engines_slow_suite",
        ref_bench["state_total_s"] * 1e6,
        ";".join(
            f"{k}={v}" for k, v in ref_bench.items()
            if k not in ("topologies", "state_total_s")
        ),
    )]
    wide_bench = bench_refine_wide(device)
    rows.append(emit(
        "refine_wide_lockstep",
        wide_bench["lockstep_s"] * 1e6,
        ";".join(
            f"{k}={v}" for k, v in wide_bench.items() if k != "lockstep_s"
        ),
    ))
    opt_bench = bench_optimal_engines(device)
    rows.append(emit(
        "optimal_engines",
        opt_bench["state_s"] * 1e6,
        ";".join(f"{k}={v}" for k, v in opt_bench.items() if k != "state_s"),
    ))
    write_json(json_path, {"refine": ref_bench, "refine_wide": wide_bench,
                           "optimal": opt_bench})
    return rows


if __name__ == "__main__":
    main(**cli(__doc__))
