"""Fig. 9 — per-machine CPU utilization under the three schedulers, on the
port.

Port of ``benchmarks/bench_utilization.py``: ``refine``,
``optimal_schedule`` and the simulator run on ``device``.

Runs each schedule at its own max stable rate through the simulator and
reports total and per-machine utilization. The paper's finding: the
optimal scheduler drives the highest total utilization; the proposed
scheduler uses the fast machine better than default even when its *total*
utilization is lower (Star), and its throughput is higher throughout.
"""

from __future__ import annotations

from repro_torch import resolve_device
from repro_torch.core import (
    diamond_topology,
    linear_topology,
    max_stable_rate,
    optimal_schedule,
    paper_cluster,
    round_robin_schedule,
    schedule,
    simulate,
    star_topology,
)
from repro_torch.core.refine import refine
from repro_torch.paper.common import cli, emit, timed, write_json

MEASURED = frozenset()


def run(topo_fn, device="cuda") -> dict:
    device = resolve_device(device)
    cluster = paper_cluster((1, 1, 1))
    topo = topo_fn()
    sched = schedule(topo, cluster, r0=1.0, rate_epsilon=0.05)
    ref = refine(sched.etg, cluster, device=device)
    rr = round_robin_schedule(topo, cluster, sched.etg.n_instances)
    opt = optimal_schedule(topo, cluster,
                           max_total_tasks=max(ref.etg.total_tasks + 1, 8), device=device)

    out = {"topology": topo.name}
    for name, etg in (("default", rr), ("proposed", sched.etg),
                      ("optimal", opt.etg)):
        rate, thpt = max_stable_rate(etg, cluster)
        sim = simulate(etg, cluster, rate, device=device)
        out[name] = {
            "throughput": thpt,
            "util": sim.machine_util.round(1).tolist(),
            "total_util": float(sim.machine_util.sum()),
        }
    return out


def main(device="cuda", json_path=None) -> list:
    device = resolve_device(device)
    rows, results = [], []
    for topo_fn in (linear_topology, diamond_topology, star_topology):
        r, us = timed(lambda f=topo_fn: run(f, device), device)
        results.append(r)
        rows.append(emit(
            f"fig9_utilization_{r['topology']}",
            us,
            ";".join(
                f"{k}:thpt={v['throughput']:.1f},util={v['total_util']:.0f}"
                for k, v in r.items() if k != "topology"
            ),
        ))
    write_json(json_path, {"utilization": results})
    return rows


if __name__ == "__main__":
    main(**cli(__doc__))
