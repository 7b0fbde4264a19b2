"""Fig. 7 — execution-graph (instance count) selection quality on the
Storm-Benchmark two-bolt topologies (RollingCount, UniqueVisitor), on the
port.

Port of ``benchmarks/bench_instances.py``: every pair's placements score in
one ``max_stable_rate_batch`` sweep on ``device``, and ``refine`` scores its
sweeps there.

Sweep all <x, y> instance pairs, score each pair's best achievable
throughput (optimal placement at those counts), and check the pair the
proposed algorithm picks. Paper: RollingCount hits the optimal <5,4>
exactly; UniqueVisitor picks <4,5> vs optimal <5,5>, costing 2 %.
"""

from __future__ import annotations

import itertools

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import (
    max_stable_rate_batch,
    paper_cluster,
    rolling_count_topology,
    schedule,
    unique_visitor_topology,
)
from repro_torch.core.graph import ExecutionGraph
from repro_torch.core.optimal import _compositions  # composition enumerator
from repro_torch.core.refine import refine
from repro_torch.paper.common import cli, emit, timed, write_json

MEASURED = frozenset()


def best_at_counts(topo, cluster, counts, device="cuda") -> float:
    """Best achievable throughput with fixed instance counts (opt placement)."""
    n_inst = np.asarray(counts, dtype=np.int64)
    template = ExecutionGraph(
        utg=topo,
        n_instances=n_inst,
        assignment=[np.zeros(int(k), dtype=np.int64) for k in n_inst],
    )
    m = cluster.n_machines
    per_comp = [list(_compositions(int(k), m)) for k in n_inst]
    batch = []
    for combo in itertools.product(*per_comp):
        flat = np.concatenate(
            [np.repeat(np.arange(m), c) for c in combo]
        )
        batch.append(flat)
    tm = np.stack(batch)
    _, thpt = max_stable_rate_batch(template, cluster, tm, device=device)
    return float(thpt.max())


def run(topo_fn, max_per_bolt: int = 6, device="cuda") -> dict:
    device = resolve_device(device)
    cluster = paper_cluster((1, 1, 1))
    topo = topo_fn()
    sweep = {}
    for x in range(1, max_per_bolt + 1):
        for y in range(1, max_per_bolt + 1):
            sweep[(x, y)] = best_at_counts(topo, cluster, [1, x, y], device)
    best_pair = max(sweep, key=sweep.get)

    sched = schedule(topo, cluster, r0=1.0, rate_epsilon=0.05)
    ref = refine(sched.etg, cluster, device=device)
    ours_pair = (int(ref.etg.n_instances[1]), int(ref.etg.n_instances[2]))
    ours_thpt = sweep.get(ours_pair, ref.throughput)
    return {
        "topology": topo.name,
        "optimal_pair": best_pair,
        "optimal_thpt": sweep[best_pair],
        "ours_pair": ours_pair,
        "ours_thpt": ours_thpt,
        "loss_pct": (1 - ours_thpt / sweep[best_pair]) * 100,
    }


def main(device="cuda", json_path=None) -> list:
    device = resolve_device(device)
    rows, results = [], []
    for topo_fn in (rolling_count_topology, unique_visitor_topology):
        r, us = timed(lambda f=topo_fn: run(f, device=device), device)
        results.append(r)
        rows.append(emit(
            f"fig7_instances_{r['topology']}",
            us,
            f"ours={r['ours_pair']};optimal={r['optimal_pair']};"
            f"loss={r['loss_pct']:.1f}%(paper<=2%)",
        ))
    write_json(json_path, {"instances": results})
    return rows


if __name__ == "__main__":
    main(**cli(__doc__))
