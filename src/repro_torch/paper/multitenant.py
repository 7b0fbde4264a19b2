"""Multi-tenant scheduling benchmark, on the port.

Port of ``benchmarks/bench_multitenant.py``; every batched sweep scores on
``device`` (the reference's ``backend="auto"``):

* **scale** — 100 tenants on one shared heterogeneous cluster must
  schedule in seconds, with the shared-load invariant intact and no tenant
  below its guaranteed floor (``fair_slice_floors``, recomputed here). Two
  cluster variants: roomy machines (capacity x4) and paper-capacity ones.
  ``fleet`` schedules a fleet and ``scale_row`` reports on it, so a caller
  that already holds a fleet's schedule (``chip_smoke.py`` phase 12) need
  not schedule it again.
* **batching** — candidate rows of many tenants scored in one
  tenant-batched per-row-capacity call vs the per-tenant residual loop on
  the CPU: speedup and max |diff|.
* **runtime** — a small fleet executes its traces on the shared capacity
  grid; per-tenant satisfaction and arbiter admissions are recorded.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import (
    ScheduleState,
    diamond_topology,
    jain_index,
    linear_topology,
    paper_cluster,
    rolling_count_topology,
    star_topology,
)
from repro_torch.multitenant import (
    MultiTenantRuntime,
    MultiTenantState,
    Tenant,
    TenantBatchScorer,
    TenantSet,
    compile_tenant_traces,
    fair_slice_floors,
    schedule_tenants,
)
from repro_torch.paper.common import cli, emit, sync, write_json
from repro_torch.runtime_stream import TraceSpec

SEED = 0
TOPOS = [linear_topology, diamond_topology, star_topology, rolling_count_topology]

# Large-fleet knobs: a light warm refine and one structural attempt per
# tenant keep 100 tenants in seconds; the guarantees (invariant,
# fair-slice no-regression) do not depend on these budgets.
FLEET_KW = dict(warm_refine_rounds=2, structure_attempts=1, refine_moves=1)
SCALE_ROWS = ((100, (20, 30, 40), 4.0, "roomy_90x400"), (100, (20, 30, 40), 1.0, "paper_90x100"))

MEASURED = frozenset({"speedup", "under_60s"})


def _fleet(n_tenants: int, rng: np.random.Generator) -> list[Tenant]:
    tenants = []
    for i in range(n_tenants):
        tenants.append(
            Tenant(
                name=f"t{i:03d}",
                utg=TOPOS[i % len(TOPOS)](),
                target_rate=float(rng.uniform(20, 200)),
                priority=float(rng.choice([1.0, 1.0, 2.0, 4.0])),
            )
        )
    return tenants


def _no_regression(tenants, cluster, ms, device) -> tuple[bool, int]:
    """Re-verify the warm-start guarantee against independently recomputed
    floors (``fair_slice_floors`` with the run's refine budget); only
    floors > 0 count as non-vacuous. Returns (all_ok, n_nonvacuous)."""
    floors = fair_slice_floors(
        tenants, cluster, warm_refine_rounds=FLEET_KW["warm_refine_rounds"], device=device
    )
    rates = np.array([ms.allocation(t.name).rate for t in tenants])
    ok = bool(np.all(rates >= floors * (1.0 - 1e-6)))
    return ok, int(np.sum(floors > 0.0))


def fleet(n_tenants: int, counts, cap_scale: float, device="cuda"):
    """``(tenants, cluster, schedule, wall s)`` of one scale row's fleet."""
    device = resolve_device(device)
    rng = np.random.default_rng(SEED)
    tenants = _fleet(n_tenants, rng)
    cluster = paper_cluster(counts)
    cluster = cluster.with_capacity(cluster.capacity * cap_scale)
    sync(device)
    t0 = time.perf_counter()
    ms = schedule_tenants(tenants, cluster, validate=False, device=device, **FLEET_KW)
    sync(device)
    return tenants, cluster, ms, time.perf_counter() - t0


def scale_row(label: str, tenants, cluster, ms, wall: float, device="cuda") -> dict:
    device = resolve_device(device)
    states = [
        ScheduleState.from_etg(a.etg, cluster, skew=t.skew)
        for a, t in zip(ms.allocations, tenants)
    ]
    mt = MultiTenantState(TenantSet(tenants), cluster, states, rates=ms.rates)
    feasible = mt.feasible(slack=1e-9)
    no_reg, nonvacuous = _no_regression(tenants, cluster, ms, device)
    levels = ms.levels
    return {
        "label": label,
        "n_tenants": len(tenants),
        "n_machines": cluster.n_machines,
        "capacity_per_machine": float(cluster.capacity[0]),
        "wall_s": round(wall, 3),
        "rounds": ms.rounds,
        "candidates_evaluated": ms.candidates_evaluated,
        "total_rate": round(float(ms.rates.sum()), 3),
        "min_level": float(levels.min()),
        "median_level": float(np.median(levels)),
        "jain_index_levels": round(jain_index(levels), 4),
        "feasible": bool(feasible),
        "no_regression_vs_fair_slice": bool(no_reg),
        "nonvacuous_baselines": nonvacuous,
        "under_60s": bool(wall < 60.0),
    }


def batching_row(n_tenants: int = 20, device="cuda") -> dict:
    """Tenant-batched met-fold scoring vs the per-tenant residual loop."""
    device = resolve_device(device)
    rng = np.random.default_rng(SEED)
    tenants = _fleet(n_tenants, rng)
    cluster = paper_cluster((4, 4, 4))
    ms = schedule_tenants(tenants, cluster, device=device, **FLEET_KW)
    states = [
        ScheduleState.from_etg(a.etg, cluster) for a in ms.allocations
    ]
    mt = MultiTenantState(
        TenantSet(tenants), cluster, states, rates=ms.rates * 0.9
    )
    m = cluster.n_machines
    sweeps = []
    for t, st in enumerate(mt.states):
        base = st.task_machine()
        rows = []
        for col in range(base.shape[0]):
            for dest in range(m):
                if dest == base[col]:
                    continue
                row = base.copy()
                row[col] = dest
                rows.append(row)
        sweeps.append((t, np.stack(rows)))
    n_rows = sum(r.shape[0] for _, r in sweeps)

    scorer = TenantBatchScorer(mt, device=device)
    sync(device)
    t0 = time.perf_counter()
    batched = scorer.score(sweeps)
    sync(device)
    t_batched = time.perf_counter() - t0

    t0 = time.perf_counter()
    looped = [scorer.reference_scores(t, rows) for t, rows in sweeps]
    t_loop = time.perf_counter() - t0

    diff = max(
        float(np.max(np.abs(b[0] - l[0]))) if b[0].size else 0.0
        for b, l in zip(batched, looped)
    )
    return {
        "n_tenants": n_tenants,
        "candidate_rows": n_rows,
        "batched_s": round(t_batched, 4),
        "per_tenant_loop_s": round(t_loop, 4),
        "speedup": round(t_loop / max(t_batched, 1e-9), 2),
        "max_abs_rate_diff": diff,
        "parity_1e9": bool(diff <= 1e-9),
    }


def runtime_row(device="cuda") -> dict:
    device = resolve_device(device)
    tenants = TenantSet(
        [
            Tenant(name="alice", utg=linear_topology(), target_rate=8.0),
            Tenant(name="bob", utg=diamond_topology(), target_rate=8.0, priority=2.0),
            Tenant(name="carol", utg=star_topology(), target_rate=6.0),
        ]
    )
    cluster = paper_cluster((2, 2, 2))
    ms = schedule_tenants(list(tenants), cluster, device=device)
    specs = [
        TraceSpec(name=t.name, n_windows=96, base_rate=0.8 * ms.rates[i])
        for i, t in enumerate(tenants)
    ]
    mtrace = compile_tenant_traces(tenants, specs, cluster, seed=SEED)
    rt = MultiTenantRuntime(ms, tenants, cluster, mtrace)
    sync(device)
    t0 = time.perf_counter()
    res = rt.run(online=True, moves_per_period=4, device=device)
    sync(device)
    wall = time.perf_counter() - t0
    admitted = [int(ok) for *_rest, ok in res.arbiter_log]
    return {
        "n_tenants": len(tenants),
        "n_windows": mtrace.n_windows,
        "wall_s": round(wall, 3),
        "allocated_rates": [round(float(r), 3) for r in ms.rates],
        "satisfaction": [round(float(s), 3) for s in res.satisfaction],
        "arbiter_requests": len(res.arbiter_log),
        "arbiter_admitted": int(sum(admitted)),
        "all_served": bool(np.all(res.satisfaction > 0.0)),
    }


def emit_scale(row: dict) -> tuple:
    return emit(
        f"multitenant_scale_{row['label']}",
        row["wall_s"] * 1e6,
        f"tenants={row['n_tenants']};rounds={row['rounds']};"
        f"feasible={row['feasible']};no_regression={row['no_regression_vs_fair_slice']};"
        f"jain={row['jain_index_levels']};under_60s={row['under_60s']}",
    )


def emit_batching(b: dict) -> tuple:
    return emit(
        "multitenant_batching",
        b["batched_s"] * 1e6,
        f"rows={b['candidate_rows']};speedup={b['speedup']};parity={b['parity_1e9']}",
    )


def emit_runtime(r: dict) -> tuple:
    return emit(
        "multitenant_runtime",
        r["wall_s"] * 1e6,
        f"tenants={r['n_tenants']};satisfaction={r['satisfaction']};"
        f"all_served={r['all_served']}",
    )


def main(device="cuda", json_path=None) -> list:
    device = resolve_device(device)
    results = {
        "scale": [
            scale_row(label, *fleet(n, counts, cap_scale, device), device)
            for n, counts, cap_scale, label in SCALE_ROWS
        ],
        "batching": batching_row(device=device),
        "runtime": runtime_row(device),
    }
    rows = [emit_scale(row) for row in results["scale"]]
    rows.append(emit_batching(results["batching"]))
    rows.append(emit_runtime(results["runtime"]))
    write_json(json_path, results)
    return rows


if __name__ == "__main__":
    main(**cli(__doc__))
