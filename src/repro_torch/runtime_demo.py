"""Online streaming runtime demo on the PyTorch + CUDA port: execute
schedules against a drifting workload and watch the online controller
adapt.

    PYTHONPATH=src python -m repro_torch.runtime_demo                 # on a GPU
    PYTHONPATH=src python -m repro_torch.runtime_demo --device cpu [--out DIR]

Port of ``examples/runtime_demo.py``; prints the same sections and numbers.
Three policies run the same rate-ramp + machine-slowdown trace: a frozen
schedule provisioned for the initial rate, the same schedule driven by the
online controller (incremental refine-move replans behind a migration
guard), and an oracle that re-runs the full scheduler every window with
free migrations. A final section shares the cluster between several
tenants (weighted max-min fairness + the shared multi-tenant runtime).
Every replan, polish and tenant-batched sweep is scored on ``--device``.

The online run is instrumented with ``repro_torch.obs.TraceRecorder``: the
controller's replan audit ledger drives the decision log below, and the
run's trace is exported into ``--out`` (default: the working directory) as
``runtime_demo_trace.jsonl`` plus ``runtime_demo_trace.trace.json``
(Chrome trace-event format — open https://ui.perfetto.dev and drag the
file in to see the executor windows, controller spans and closed-form
dispatch decisions on a timeline).
"""

import argparse
from pathlib import Path

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import (
    diamond_topology,
    keyed_rolling_count_topology,
    linear_topology,
    max_stable_rate,
    paper_cluster,
    schedule,
    star_topology,
)
from repro_torch.core.refine import refine
from repro_torch.multitenant import (
    MultiTenantRuntime,
    Tenant,
    TenantSet,
    compile_tenant_traces,
    schedule_tenants,
)
from repro_torch.obs import TraceRecorder, summary, to_chrome_trace, to_jsonl
from repro_torch.runtime_stream import (
    OnlineController,
    OracleRescheduler,
    RuntimeConfig,
    StreamExecutor,
    TraceSpec,
    machine_slowdown,
    provision_schedule,
    rate_ramp,
    skew_shift_trace,
)


def main(device: str = "cuda", out: str = ".") -> None:
    device = resolve_device(device)
    cluster = paper_cluster((1, 1, 1))
    topo = linear_topology()
    full = refine(schedule(topo, cluster, r0=1.0, rate_epsilon=0.05).etg, cluster,
                  device=device)
    print(f"cluster max stable rate: {full.rate:.2f} tuples/s "
          f"(throughput {full.throughput:.2f})")

    spec = TraceSpec(
        name="demo",
        n_windows=240,
        base_rate=full.rate * 0.3,
        events=(
            rate_ramp(full.rate * 1.1, start=20, end=140),
            machine_slowdown(2, 0.5, start=170),
        ),
    )
    start = provision_schedule(topo, cluster, full.rate * 0.3)
    print(f"initial schedule (provisioned for rate {full.rate * 0.3:.2f}): "
          f"instances={start.n_instances.tolist()}")

    static = StreamExecutor(start, cluster, spec).run()
    recorder = TraceRecorder(name="runtime_demo", wall_clock=True)
    ctl = OnlineController(topo, cluster, period=10, recorder=recorder, device=device)
    online = StreamExecutor(start, cluster, spec, recorder=recorder).run(
        controller=ctl
    )
    oracle = StreamExecutor(
        start, cluster, spec, config=RuntimeConfig(migration_pause=0)
    ).run(controller=OracleRescheduler(topo, cluster, device=device))

    print("\nsustained throughput (tail half of the trace):")
    print(f"  static   {static.sustained_throughput():7.2f} tuples/s")
    print(f"  online   {online.sustained_throughput():7.2f} tuples/s "
          f"({int(online.migrations.sum())} migrations)")
    print(f"  oracle   {oracle.sustained_throughput():7.2f} tuples/s "
          f"({int(oracle.migrations.sum())} migrations)")

    print("\ncontroller decisions (replan audit ledger):")
    for dec in ctl.ledger:
        print(f"  window {dec.window:3d}: {dec.message}")
    accepted = ctl.ledger.accepted
    print(f"  {len(accepted)} accepted / "
          f"{len(ctl.ledger) - len(accepted)} rejected or deferred")

    print(f"\nfinal online schedule: "
          f"instances={online.final_etg.n_instances.tolist()}")
    quarters = np.array_split(online.throughput, 4)
    means = " -> ".join(f"{q.mean():.1f}" for q in quarters)
    print(f"online throughput by quarter: {means} tuples/s")

    print("\n--- observability (repro_torch.obs) ---")
    print(summary(recorder))
    out_dir = Path(out)
    out_dir.mkdir(parents=True, exist_ok=True)
    to_jsonl(recorder, out_dir / "runtime_demo_trace.jsonl")
    to_chrome_trace(recorder, out_dir / "runtime_demo_trace.trace.json")
    print("trace exported: runtime_demo_trace.jsonl and "
          "runtime_demo_trace.trace.json")
    print("open https://ui.perfetto.dev and drag the .trace.json in to "
          "browse the run")

    keyed_demo(cluster, device)
    multitenant_demo(device)


def multitenant_demo(device) -> None:
    """Three tenants share one cluster: weighted max-min fair rates, then
    the shared runtime executes every tenant's plan against one capacity
    grid with a cross-tenant migration arbiter."""
    print("\n--- multi-tenant (shared cluster, weighted max-min) ---")
    cluster = paper_cluster((2, 2, 2))
    tenants = TenantSet(
        [
            Tenant(name="alice", utg=linear_topology(), target_rate=8.0,
                   priority=2.0),
            Tenant(name="bob", utg=diamond_topology(), target_rate=8.0),
            Tenant(name="carol", utg=star_topology(), target_rate=6.0),
        ]
    )
    ms = schedule_tenants(list(tenants), cluster, device=device)
    for a in ms.allocations:
        print(f"  {a.name:6s} rate {a.rate:6.2f} / target {a.target_rate:5.1f} "
              f"(priority {a.priority:.0f}, level {a.level:.3f})")
    print(f"  {ms.rounds} water-filling rounds, "
          f"{ms.candidates_evaluated} batched candidates")

    specs = [
        TraceSpec(name=t.name, n_windows=96, base_rate=0.8 * ms.rates[i])
        for i, t in enumerate(tenants)
    ]
    mtrace = compile_tenant_traces(tenants, specs, cluster, seed=0)
    res = MultiTenantRuntime(ms, tenants, cluster, mtrace).run(
        online=True, moves_per_period=4, device=device
    )
    for name, sat in zip(res.names, res.satisfaction):
        print(f"  {name:6s} runtime satisfaction {sat:.2f}")


def keyed_demo(cluster, device) -> None:
    """Fields grouping with Zipf-hot keys: the even-split score
    over-reports what the schedule sustains; the skew-aware controller
    replans around the hot instances (and a mid-trace key-skew shift)."""
    print("\n--- keyed streams (fields grouping, Zipf keys) ---")
    utg = keyed_rolling_count_topology(n_keys=16, zipf_s=1.5)
    etg = schedule(utg, cluster, r0=1.0, rate_epsilon=0.05).etg
    cfg = RuntimeConfig(max_queue=120.0)

    spec = skew_shift_trace(
        0.95 * max_stable_rate(etg, cluster)[0], n_windows=240, zipf_s=2.0
    )
    probe = StreamExecutor(etg, cluster, spec, seed=0, config=cfg)
    skew = probe.skew_model_at(0)
    r_even, _ = max_stable_rate(etg, cluster)
    r_skew, _ = max_stable_rate(etg, cluster, skew=skew)
    print(f"even-split R* {r_even:.2f} vs skew-aware R* {r_skew:.2f} "
          f"(hot keys cost {100 * (1 - r_skew / r_even):.0f}% capacity)")

    static = StreamExecutor(etg, cluster, spec, seed=0, config=cfg).run()
    ctl = OnlineController(utg, cluster, period=10, device=device)
    online = StreamExecutor(etg, cluster, spec, seed=0, config=cfg).run(
        controller=ctl
    )
    print(f"  static   {static.sustained_throughput():7.2f} tuples/s")
    print(f"  online   {online.sustained_throughput():7.2f} tuples/s "
          f"({int(online.migrations.sum())} migrations)")
    for window, msg in ctl.log[:6]:
        print(f"  window {window:3d}: {msg}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=".", help="directory for the trace exports")
    args = ap.parse_args()
    main(args.device, args.out)
