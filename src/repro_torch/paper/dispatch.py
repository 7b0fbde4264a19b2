"""Where the card starts to win: the closed-form scorer on the CPU against
the card, on the port.

Port of ``benchmarks/bench_dispatch.py``. The reference times its NumPy
and JAX scorers to calibrate ``backend="auto"``; the port has no ``"auto"``
(every batched entry point takes an explicit ``device``; README), so this
benchmark measures the port's own dispatch points: it times
``ScheduleState.score_task_machine_batch`` with ``device="cpu"`` and, on a
card, with ``device="cuda"`` over the same scenarios × regimes × batch
grid, and reports for each scenario and regime the smallest sweep (in
B*T elements) from which the card wins by 10 % or more at that size and
every larger one ("none" where it never does, and on the CPU alone).

Scenarios span paper-realistic clusters (3 / 6 / 15 machines) plus the
wide ``stress`` shape (180 machines, the paper's 20/70/90 large scenario);
each is swept through the three regimes: ``shared`` ((T,) task maps),
``per_row`` ((B, T) maps) and ``skew`` (realized fields-grouping rates on
a keyed topology). The reference's ``--check`` gate replays its ``"auto"``
rule and is not ported.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import (
    keyed_rolling_count_topology,
    paper_cluster,
    schedule,
    wide_fanout_topology,
)
from repro_torch.core.schedule_state import ScheduleState
from repro_torch.paper.common import cli, emit, sync, write_json
from repro_torch.runtime_stream import StreamExecutor, TraceSpec

# Batch sizes swept per (scenario, regime) — rows per scored sweep.
BATCH_SIZES = (1, 8, 64, 256, 1024, 4096, 16384)
# (cluster counts, label, max batch), as in the reference.
SCENARIOS = (
    ((1, 1, 1), "small", 16384),
    ((2, 2, 2), "medium", 16384),
    ((4, 5, 6), "large", 16384),
    ((20, 70, 90), "stress", 4096),
)
REGIMES = ("shared", "per_row", "skew")

MEASURED = frozenset({"crossover_elements"})


def _skew_state(cluster) -> ScheduleState:
    """A ScheduleState carrying a realized fields-grouping skew model
    (keyed topology, key realization drawn at trace compile time)."""
    utg = keyed_rolling_count_topology(n_keys=16, zipf_s=1.5)
    etg = schedule(utg, cluster, r0=1.0, rate_epsilon=1.0).etg
    probe = StreamExecutor(
        etg, cluster, TraceSpec(name="probe", n_windows=2, base_rate=1.0), seed=5
    )
    return ScheduleState.from_etg(etg, cluster, skew=probe.skew_model_at(0))


def _time_device(state: ScheduleState, tm: np.ndarray, device,
                 n_instances: np.ndarray | None = None, iters: int = 5) -> float:
    """Median host-to-host wall (s) of one scored sweep after two warm-ups:
    operands in, rates back on the host, as every caller receives them."""
    for _ in range(2):
        state.score_task_machine_batch(tm, n_instances=n_instances, device=device)
    times = []
    for _ in range(iters):
        sync(device)
        t0 = time.perf_counter()
        state.score_task_machine_batch(tm, n_instances=n_instances, device=device)
        sync(device)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def bench_dispatch(device="cuda") -> dict:
    device = resolve_device(device)
    card = device.type == "cuda"
    rng = np.random.default_rng(0)
    grid = []
    crossovers = []
    for counts, label, max_batch in SCENARIOS:
        cluster = paper_cluster(counts)
        m = cluster.n_machines
        sched = schedule(wide_fanout_topology(6), cluster,
                         r0=1.0, rate_epsilon=1.0)
        plain = ScheduleState.from_etg(sched.etg, cluster)
        skewed = _skew_state(cluster)
        for regime in REGIMES:
            state = skewed if regime == "skew" else plain
            T = int(state.n_instances.sum())
            n = state.utg.n_components
            rows = []
            for B in BATCH_SIZES:
                if B > max_batch:
                    continue
                tm = rng.integers(0, m, size=(B, T))
                n_inst = (
                    np.tile(state.n_instances, (B, 1))
                    if regime == "per_row"
                    else None
                )
                row = {
                    "scenario": label,
                    "regime": regime,
                    "machines": m,
                    "tasks": T,
                    "components": n,
                    "batch": B,
                    "elements": B * T,
                    "cpu_us": round(_time_device(state, tm, "cpu", n_inst) * 1e6, 1),
                }
                if card:
                    t_card = _time_device(state, tm, device, n_inst)
                    row["cuda_us"] = round(t_card * 1e6, 1)
                    row["cuda_speedup"] = round(row["cpu_us"] / max(row["cuda_us"], 1e-6), 2)
                rows.append(row)
            grid.extend(rows)
            # Crossover = smallest sweep from which the card wins by a real
            # margin (10%+) at that size and every larger one.
            crossover = None
            if card:
                for i, row in enumerate(rows):
                    if all(r["cuda_speedup"] >= 1.1 for r in rows[i:]):
                        crossover = row["elements"]
                        break
            crossovers.append({
                "scenario": label,
                "regime": regime,
                "machines": m,
                "tasks": T,
                "crossover_elements": crossover,
            })
    return {"card": card, "grid": grid, "crossovers": crossovers}


def main(device="cuda", json_path=None) -> list:
    device = resolve_device(device)
    out = bench_dispatch(device)
    rows = [
        emit(
            f"dispatch_crossover_{c['scenario']}_{c['regime']}",
            float(c["crossover_elements"] or 0),
            f"tasks={c['tasks']};machines={c['machines']};"
            f"crossover_elements={c['crossover_elements'] or 'none'}",
        )
        for c in out["crossovers"]
    ]
    write_json(json_path, out)
    return rows


if __name__ == "__main__":
    main(**cli(__doc__))
