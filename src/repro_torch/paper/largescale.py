"""Fig. 10 + Tables 4/5 — large-scale simulation: proposed vs default
scheduler on three cluster scenarios (small 2/2/2, medium 10/10/10, large
20/70/90 machines per type), on the port.

Port of ``benchmarks/bench_largescale.py``: the two placements of a
scenario simulate in one ``simulate_batch`` call on ``device`` (the
reference's ``backend="auto"``).

As in the paper (§6.3), the proposed algorithm first determines the
instance counts; both schedulers then place the *same* counts, isolating
placement quality. Reported per scenario x topology: throughput gain,
weighted-utilization gain (eq. 7/8), and the Table-5 gain ratio
diff_thpt / diff_util (> 1 = the scheduler converts utilization into
throughput more efficiently than round-robin).

Paper bands: small +26-49 %, medium +36-48 %, large +27-31 % throughput;
all Table-5 ratios > 1.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import (
    diamond_topology,
    gain_ratio,
    linear_topology,
    max_stable_rate,
    paper_cluster,
    round_robin_schedule,
    schedule,
    simulate_batch,
    star_topology,
    weighted_utilization,
)
from repro_torch.paper.common import cli, emit, write_json

MEASURED = frozenset()

SCENARIOS = {
    "small": (2, 2, 2),
    "medium": (10, 10, 10),
    "large": (20, 70, 90),
}


def run(scenario: str, topo_fn, device="cuda") -> dict:
    device = resolve_device(device)
    cluster = paper_cluster(SCENARIOS[scenario])
    topo = topo_fn()
    t0 = time.perf_counter()
    sched = schedule(topo, cluster, r0=1.0, rate_epsilon=1.0)
    t_sched = time.perf_counter() - t0

    rr = round_robin_schedule(topo, cluster, sched.etg.n_instances)
    rate_o, thpt_o = max_stable_rate(sched.etg, cluster)
    rate_d, thpt_d = max_stable_rate(rr, cluster)
    # Both placements share the instance-count vector (§6.3 fair-comparison
    # protocol), so they simulate in one batched call, each at its own
    # stable rate via the per-row r0 vector.
    tm = np.stack([sched.etg.task_machine(), rr.task_machine()])
    both = simulate_batch(
        sched.etg, cluster, tm, np.array([rate_o, rate_d]), device=device
    )
    sim_o = both.row(0)
    sim_d = both.row(1)
    util_o = weighted_utilization(sched.etg, cluster, sim_o)
    util_d = weighted_utilization(rr, cluster, sim_d)
    return {
        "scenario": scenario,
        "topology": topo.name,
        "tasks": int(sched.etg.total_tasks),
        "thpt_gain_pct": (thpt_o / thpt_d - 1) * 100,
        "util_gain_pct": (util_o / util_d - 1) * 100,
        "table5_ratio": gain_ratio(thpt_o, thpt_d, util_o, util_d),
        "t_sched_us": t_sched * 1e6,
        "instances": sched.etg.n_instances.tolist(),
    }


def main(device="cuda", json_path=None) -> list:
    device = resolve_device(device)
    rows, results = [], []
    for scenario in SCENARIOS:
        for topo_fn in (linear_topology, diamond_topology, star_topology):
            r = run(scenario, topo_fn, device)
            results.append(r)
            rows.append(emit(
                f"fig10_{scenario}_{r['topology']}",
                r["t_sched_us"],
                f"tasks={r['tasks']};thpt_gain={r['thpt_gain_pct']:.1f}%;"
                f"util_gain={r['util_gain_pct']:.1f}%;"
                f"table5_ratio={r['table5_ratio']:.2f}",
            ))
    write_json(json_path, {"largescale": results})
    return rows


if __name__ == "__main__":
    main(**cli(__doc__))
