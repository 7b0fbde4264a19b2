"""Online-runtime benchmark, on the port.

Port of ``benchmarks/bench_runtime.py``: the policy ladder against every
drift scenario of the streaming runtime (``repro_torch.runtime_stream``),
with every replan's ``refine`` scored on ``device``:

* **static** — a schedule provisioned for the scenario's *initial* rate
  (``provision_schedule``), then frozen for the whole trace;
* **online** — the same starting schedule driven by ``OnlineController``
  (windowed drift detection, incremental ``refine``-move replanning, the
  state-aware migration cost/benefit guard);
* **online_blind** (keyed/stateful rows only) — the same controller with
  ``state_aware=False``, the ablation baseline;
* **oracle** — a full ``schedule()`` re-plan at every window with free
  migrations (``OracleRescheduler`` + ``migration_pause=0``).

It runs on ``paper_cluster((1, 1, 1))`` as the reference does. Per row:
sustained throughput for each policy, the latency-SLO column, migration
counts and the acceptance booleans. Then the batch evaluator's parity row
(``evaluate_policies_batch`` on ``device`` — one ``policy_scan`` launch on
a card — against its CPU path, 1e-9) and the recorder's overhead rows
(each run timed on the host clock after a synchronise, so on a card they
include the device's work). The reference's ``--check`` gate and
``--trace-out`` export are not ported (README).
"""

from __future__ import annotations

import statistics
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import linear_topology, paper_cluster, schedule
from repro_torch.core.graph import keyed_rolling_count_topology, rolling_count_topology
from repro_torch.core.refine import refine
from repro_torch.obs import TraceRecorder
from repro_torch.paper.common import cli, emit, sync, write_json
from repro_torch.runtime_stream import (
    OnlineController,
    OracleRescheduler,
    RuntimeConfig,
    StreamExecutor,
    evaluate_policies_batch,
    provision_schedule,
)
from repro_torch.runtime_stream.traces import (
    TraceSpec,
    burst_trace,
    elastic_trace,
    failure_trace,
    key_skew_shift,
    machine_addition,
    machine_slowdown,
    ramp_trace,
    rate_ramp,
    sine_trace,
    slowdown_trace,
)

N_WINDOWS = 240
SEED = 0
SLO_S = 5.0  # latency SLO: tail windows must estimate <= 5 s queueing delay
STATE_PER_TUPLE = 25.0   # keyed state retained per unit tuple rate (stateful rows)
STATE_RATE = 25.0        # state tuples shippable per second while migrating
# One event-loop config for every policy and scenario: a 120-tuple queue
# bound makes sustained overload trip real back-pressure (the default 500
# lets short transients hide entirely inside the queues).
CONFIG = RuntimeConfig(max_queue=120.0)
ORACLE_CONFIG = RuntimeConfig(max_queue=120.0, migration_pause=0)
# Stateful keyed rows: migrations ship keyed state at a finite rate; the
# oracle keeps its idealized free migrations.
STATE_CONFIG = RuntimeConfig(max_queue=120.0, state_transfer_rate=STATE_RATE)
DRAIN_CONFIG = RuntimeConfig(
    max_queue=120.0, state_transfer_rate=STATE_RATE, capacity_notice=25
)

# The recorder's overhead rows: samples of interleaved off/on pairs. The
# reference takes 4 pairs a sample; 2 keep ``chip_smoke.py``'s phase 14,
# which runs this benchmark on the card, within its minute.
OVERHEAD_SAMPLES = 7
OVERHEAD_PAIRS = 2

# "jax" and "card" name the device that evaluated the parity row.
MEASURED = frozenset({"card", "jax", "max_diff", "off", "on", "overhead", "within_5pct"})


def _scenarios(topo, cluster, device) -> list[tuple[TraceSpec, float, object, object]]:
    """(trace spec, provisioning rate, exec cluster, config) per scenario,
    with rates against the cluster's maximum stable rate for the topology
    (schedule+refine). The elastic row runs on a fleet with one spare i5
    whose capacity column switches on mid-trace (``machine_addition``)."""
    full = refine(schedule(topo, cluster, r0=1.0, rate_epsilon=0.05).etg, cluster,
                  device=device)
    r = full.rate
    big = int(np.argmax(cluster.capacity))  # the most capable machine
    rows: list[tuple[TraceSpec, float, object, object]] = [
        (ramp_trace(0.3 * r, 1.2 * r, n_windows=N_WINDOWS), 0.3 * r, cluster, CONFIG),
        (burst_trace(0.5 * r, factor=3.0, n_windows=N_WINDOWS, every=60,
                     width=20, jitter=3), 0.5 * r, cluster, CONFIG),
        (sine_trace(0.65 * r, amplitude=0.45, n_windows=N_WINDOWS, period=160),
         0.65 * r, cluster, CONFIG),
        (slowdown_trace(0.9 * r, machine=big, factor=0.5, n_windows=N_WINDOWS),
         0.9 * r, cluster, CONFIG),
        (failure_trace(0.85 * r, machine=big, n_windows=N_WINDOWS), 0.85 * r,
         cluster, CONFIG),
        (
            TraceSpec(
                name="ramp_slowdown",
                n_windows=N_WINDOWS,
                base_rate=0.4 * r,
                events=(
                    rate_ramp(1.1 * r, start=20, end=120),
                    machine_slowdown(big, 0.6, start=150),
                ),
            ),
            0.4 * r,
            cluster,
            CONFIG,
        ),
    ]
    # Cloud scale-out: a spare i5 (fleet machine 3) joins after the rate
    # ramp passes the initial fleet's bound.
    fleet = paper_cluster((1, 1, 2))
    r4 = refine(schedule(topo, fleet, r0=1.0, rate_epsilon=0.05).etg, fleet,
                device=device).rate
    rows.append(
        (
            elastic_trace(0.5 * r, 1.05 * r4, machine=3, n_windows=N_WINDOWS,
                          join=120),
            0.5 * r,
            fleet,
            CONFIG,
        )
    )
    return rows


def _keyed_scenarios(topo, cluster, device) -> list[tuple[TraceSpec, float, object, object]]:
    """Keyed-skew drift rows (``keyed_hot``, ``keyed_shift``,
    ``keyed_elastic``), all with operator state shipping at a finite rate:
    the static baseline provisions by the even-split closed form, which the
    realized key skew saturates below."""
    full = refine(schedule(topo, cluster, r0=1.0, rate_epsilon=0.05).etg, cluster,
                  device=device)
    r = full.rate  # even-split closed form — intentionally skew-blind
    rows: list[tuple[TraceSpec, float, object, object]] = [
        (
            TraceSpec(name="keyed_hot", n_windows=N_WINDOWS, base_rate=1.0 * r),
            1.0 * r,
            cluster,
            STATE_CONFIG,
        ),
        (
            TraceSpec(
                name="keyed_shift",
                n_windows=N_WINDOWS,
                base_rate=0.8 * r,
                events=(key_skew_shift(start=N_WINDOWS // 3, zipf_s=2.0),),
            ),
            0.8 * r,
            cluster,
            STATE_CONFIG,
        ),
    ]
    fleet = paper_cluster((1, 1, 2))
    rows.append(
        (
            TraceSpec(
                name="keyed_elastic",
                n_windows=N_WINDOWS,
                base_rate=0.7 * r,
                events=(
                    rate_ramp(1.2 * r, start=20, end=100),
                    machine_addition(3, start=80, end=160),
                ),
            ),
            0.7 * r,
            fleet,
            DRAIN_CONFIG,
        )
    )
    return rows


def _start_etg(topo, trace, provision_rate: float, cluster):
    """Provision against the machines alive at window 0 (an elastic fleet's
    spare column is off until its machine_addition fires)."""
    alive0 = trace.capacity[0] > 0.0
    prov_cluster = (
        cluster if alive0.all() else paper_cluster(
            tuple(
                int(np.sum(cluster.machine_types[alive0] == t))
                for t in range(cluster.profile.n_machine_types)
            )
        )
    )
    return provision_schedule(topo, prov_cluster, provision_rate)


def _ledger_complete(ctl: OnlineController, online) -> bool:
    """Every accepted and rejected replan is in the audit ledger with a full
    guard breakdown, and accepted decisions match the applied replans."""
    guard = [d for d in ctl.ledger if d.has_guard_breakdown]
    return bool(
        len(ctl.ledger.accepted) == int((online.migrations > 0).sum())
        and all(
            d.moves > 0
            and abs(d.cost - (d.move_cost + d.state_cost)) < 1e-9
            and d.candidate_moves
            for d in guard
        )
    )


def run_scenario(topo, spec: TraceSpec, provision_rate: float, cluster,
                 config: RuntimeConfig, device="cuda") -> dict:
    device = resolve_device(device)
    trace = spec.compile(cluster, seed=SEED, utg=topo)
    start_etg = _start_etg(topo, trace, provision_rate, cluster)

    t0 = time.perf_counter()
    static = StreamExecutor(start_etg, cluster, trace, config=config).run()
    t_static = time.perf_counter() - t0

    ctl = OnlineController(topo, cluster, period=10, device=device)
    t0 = time.perf_counter()
    online = StreamExecutor(start_etg, cluster, trace, config=config).run(
        controller=ctl
    )
    sync(device)
    t_online = time.perf_counter() - t0

    t0 = time.perf_counter()
    oracle = StreamExecutor(
        start_etg, cluster, trace, config=ORACLE_CONFIG
    ).run(controller=OracleRescheduler(topo, cluster, device=device))
    sync(device)
    t_oracle = time.perf_counter() - t0

    s_static = static.sustained_throughput()
    s_online = online.sustained_throughput()
    s_oracle = oracle.sustained_throughput()
    row = {
        "scenario": trace.name,
        "windows": trace.n_windows,
        "provision_rate": round(provision_rate, 3),
        "sustained_static": round(s_static, 3),
        "sustained_online": round(s_online, 3),
        "sustained_oracle": round(s_oracle, 3),
        "online_vs_static": round(s_online / max(s_static, 1e-9), 3),
        "online_vs_oracle": round(s_online / max(s_oracle, 1e-9), 3),
        "latency_slo_s": SLO_S,
        "latency_slo_static": round(static.latency_slo_frac(SLO_S), 3),
        "latency_slo_online": round(online.latency_slo_frac(SLO_S), 3),
        "latency_slo_oracle": round(oracle.latency_slo_frac(SLO_S), 3),
        "online_migrations": int(online.migrations.sum()),
        "online_replans": int((online.migrations > 0).sum()),
        "oracle_migrations": int(oracle.migrations.sum()),
        "controller_log_tail": [f"w{w}:{msg}" for w, msg in ctl.log[-3:]],
        "ledger_decisions": len(ctl.ledger),
        "ledger_accepted": len(ctl.ledger.accepted),
        "ledger_rejected": len(ctl.ledger.rejected),
        "ledger_complete": _ledger_complete(ctl, online),
        "beats_static": bool(s_online >= s_static),
        "within_10pct_of_oracle": bool(s_online >= 0.9 * s_oracle),
        "static_s": round(t_static, 3),
        "online_s": round(t_online, 3),
        "oracle_s": round(t_oracle, 3),
    }
    if topo.groupings:
        # Ablation on keyed/stateful rows: the state-blind controller
        # prices the same replans flat.
        blind = OnlineController(topo, cluster, period=10, state_aware=False, device=device)
        res_blind = StreamExecutor(
            start_etg, cluster, trace, config=config
        ).run(controller=blind)
        s_blind = res_blind.sustained_throughput()
        row["sustained_online_blind"] = round(s_blind, 3)
        row["latency_slo_online_blind"] = round(
            res_blind.latency_slo_frac(SLO_S), 3
        )
        row["blind_migrations"] = int(res_blind.migrations.sum())
        row["aware_beats_blind"] = bool(s_online >= s_blind)
        if bool(np.all(trace.capacity == trace.capacity[:1])):
            # On a fixed fleet the per-(capacity, skew-epoch) oracle must
            # not lose to the online controller (elastic keyed rows exempt).
            row["oracle_not_below_online"] = bool(s_oracle >= 0.99 * s_online)
    return row


def overhead_rows(cluster, device="cuda") -> list[dict]:
    """Recorder-on vs recorder-off time on one shuffle and one keyed
    scenario, replans on ``device``.

    Off and on runs are interleaved one by one (drift slower than a run
    cancels out of each sample's ratio of sums), ``OVERHEAD_SAMPLES``
    samples of ``OVERHEAD_PAIRS`` pairs, and the reported overhead is the
    minimum sample ratio, as in the reference.
    Each run is timed on the host clock, ending in a synchronise."""
    device = resolve_device(device)
    rows: list[dict] = []
    keyed = keyed_rolling_count_topology(
        n_keys=16, zipf_s=1.5, state_per_tuple=STATE_PER_TUPLE
    )
    for topo, scen_fn in ((linear_topology(), _scenarios),
                          (keyed, _keyed_scenarios)):
        spec, rate, clu, cfg = scen_fn(topo, cluster, device)[0]
        trace = spec.compile(clu, seed=SEED, utg=topo)
        start_etg = _start_etg(topo, trace, rate, clu)

        def run_once(recorder=None) -> float:
            ctl = OnlineController(topo, clu, period=10, recorder=recorder, device=device)
            sync(device)
            t0 = time.perf_counter()
            StreamExecutor(
                start_etg, clu, trace, config=cfg, recorder=recorder
            ).run(controller=ctl)
            sync(device)
            return time.perf_counter() - t0

        def make_rec():
            return TraceRecorder(
                name=f"overhead-{trace.name}", wall_clock=True
            )

        run_once()  # warm-up: imports, caches, first-touch allocations
        rec = make_rec()
        run_once(rec)
        ratios: list[float] = []
        off_times: list[float] = []
        on_times: list[float] = []
        for _ in range(OVERHEAD_SAMPLES):
            t_off = t_on = 0.0
            for _ in range(OVERHEAD_PAIRS):  # interleave singles within the sample
                t_off += run_once()
                rec = make_rec()
                t_on += run_once(rec)
            off_times.append(t_off / OVERHEAD_PAIRS)
            on_times.append(t_on / OVERHEAD_PAIRS)
            ratios.append(t_on / max(t_off, 1e-12))
        off = statistics.median(off_times)
        on = statistics.median(on_times)
        frac = min(ratios) - 1.0
        rows.append(
            {
                "scenario": trace.name,
                "recorder_off_s": round(off, 4),
                "recorder_on_s": round(on, 4),
                "overhead_pct": round(100.0 * frac, 2),
                "within_5pct": bool(frac < 0.05),
                "records": len(rec.records),
            }
        )
    return rows


def parity_smoke(topo, cluster, device="cuda") -> dict:
    """The batch evaluator on ``device`` against its CPU path (max |diff|)."""
    device = resolve_device(device)
    full = refine(schedule(topo, cluster, r0=1.0, rate_epsilon=0.05).etg, cluster,
                  device=device)
    traces = [
        ramp_trace(0.3 * full.rate, 1.5 * full.rate, n_windows=120).compile(
            cluster, seed=1
        ),
        slowdown_trace(0.9 * full.rate, machine=2, n_windows=120).compile(
            cluster, seed=2
        ),
    ]
    policies = full.etg.task_machine()[None, :]
    a = evaluate_policies_batch(full.etg, cluster, traces, policies, device="cpu")
    b = evaluate_policies_batch(full.etg, cluster, traces, policies, device=device)
    diff = float(np.max(np.abs(a.throughput - b.throughput)))
    lat_diff = float(np.max(np.abs(a.latency() - b.latency())))
    return {
        "card": device.type == "cuda",
        "max_abs_throughput_diff": diff,
        "max_abs_latency_diff": lat_diff,
        "within_1e9": bool(diff <= 1e-9),
    }


def scenario_rows(device="cuda") -> tuple[dict, list]:
    """Every scenario of the three tables: ``(results, rows)``."""
    device = resolve_device(device)
    cluster = paper_cluster((1, 1, 1))
    results, out = {}, []
    for topo_name, topo, scen_fn in (
        ("linear", linear_topology(), _scenarios),
        ("rolling_count", rolling_count_topology(), _scenarios),
        (
            "keyed_rolling_count",
            keyed_rolling_count_topology(
                n_keys=16, zipf_s=1.5, state_per_tuple=STATE_PER_TUPLE
            ),
            _keyed_scenarios,
        ),
    ):
        rows = [
            run_scenario(topo, spec, rate, clu, cfg, device)
            for spec, rate, clu, cfg in scen_fn(topo, cluster, device)
        ]
        results[topo_name] = rows
        for row in rows:
            extra = (
                f";blind={row['sustained_online_blind']}"
                if "sustained_online_blind" in row
                else ""
            )
            out.append(emit(
                f"runtime_{topo_name}_{row['scenario']}",
                row["online_s"] * 1e6,
                f"online={row['sustained_online']};static={row['sustained_static']};"
                f"oracle={row['sustained_oracle']};migrations={row['online_migrations']};"
                f"slo={row['latency_slo_online']};beats_static={row['beats_static']};"
                f"within_10pct={row['within_10pct_of_oracle']}{extra}",
            ))
    return results, out


def main(device="cuda", json_path=None) -> list:
    device = resolve_device(device)
    cluster = paper_cluster((1, 1, 1))
    results, out = scenario_rows(device)
    parity = parity_smoke(linear_topology(), cluster, device)
    out.append(emit(
        "runtime_eval_parity",
        0.0,
        f"card={parity['card']};max_diff={parity['max_abs_throughput_diff']:.2e};"
        f"within_1e9={parity['within_1e9']}",
    ))
    overhead = overhead_rows(cluster, device)
    for row in overhead:
        out.append(emit(
            f"runtime_obs_overhead_{row['scenario']}",
            row["recorder_on_s"] * 1e6,
            f"off={row['recorder_off_s']}s;on={row['recorder_on_s']}s;"
            f"overhead={row['overhead_pct']}%;within_5pct={row['within_5pct']};"
            f"records={row['records']}",
        ))
    write_json(json_path, {"scenarios": results, "parity": parity, "overhead": overhead})
    return out


if __name__ == "__main__":
    main(**cli(__doc__))
