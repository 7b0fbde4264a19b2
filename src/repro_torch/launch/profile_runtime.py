"""Where an online streaming run's time goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_runtime [--trace ramp]

Runs the streaming runtime at the paper's large scale (``runtime_setup``:
``linear_topology()`` on ``paper_cluster((20, 70, 90))``, 180 machines,
the refined placement's 478 tasks, R* its closed-form rate, ``N_WINDOWS``
windows) and prints:

1. an ``OnlineController(period=10, device="cuda")`` run over one of the six
   drift scenarios (``--trace``, default ``ramp``) from ``provision_schedule``
   at the scenario's initial rate (``PROVISION``): its wall time, the time
   inside the replans' ``refine`` calls (host clock, each ended by a
   synchronise), the replans and their B1 launches;
2. the same run under ``torch.profiler``: the device busy share and the
   device time and calls of B1/B2 and the cut-traffic kernel;
3. the policy sweep ``evaluate_policies_batch(device="cuda")`` over the six
   traces x ``N_POLICIES`` placements (``sweep_policies``): the median of
   ``SWEEP_WALLS`` host-to-host walls after one warm-up sweep, the
   ``policy_scan`` kernel's time (``timing.time_cuda``, as
   ``chip_smoke.py`` times it: cold L2, median of 15) and its plain
   version's on the card (median of 3).

It prints these, the card's ``nvidia-smi`` name and power limit, and one
JSON line with the same numbers. Needs a card; there is no CPU mode. Run
as a file with ``PYTHONPATH`` set to another checkout's ``src``, it times
that checkout: alternate two in one chip call to compare them on one card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import time

import numpy as np
import torch

import repro_torch.core as P
import repro_torch.runtime_stream as RS

__all__ = ["N_POLICIES", "N_WINDOWS", "PROVISION", "RUNTIME_CONFIG", "SCENARIOS", "SWEEP_SEED",
           "SWEEP_WALLS", "online_run", "refine_times", "runtime_setup", "runtime_traces",
           "sweep_policies", "main"]

# The runtime benchmark's event-loop constants: a 120-tuple queue bound, so
# sustained overload trips real back-pressure.
RUNTIME_CONFIG = RS.RuntimeConfig(max_queue=120.0)
SCENARIOS = ("ramp", "burst", "sine", "slowdown", "failure", "ramp_slowdown")
# The horizon of every run, and the sweep's placements and their seed.
N_WINDOWS = 240
N_POLICIES = 256
SWEEP_SEED = 0
# Host-to-host walls of the sweep whose median is reported: a single wall on
# the host's clock varies too much from run to run to compare two trees.
SWEEP_WALLS = 9
# Each scenario's initial rate as a fraction of R*: an online run starts from
# ``provision_schedule`` at it, as the reference benchmark's online policy
# does (the refined placement's two spout instances pass at most 2 x 120
# tuples a window, so from it a ramp never trips a trigger).
PROVISION = {"ramp": 0.3, "burst": 0.5, "sine": 0.65, "slowdown": 0.9, "failure": 0.85,
             "ramp_slowdown": 0.4}


def runtime_traces(cluster: P.Cluster, rate: float) -> dict:
    """The six drift scenarios of the reference's runtime benchmark
    (``benchmarks/bench_runtime.py``) against ``rate`` (R*), as
    ``TraceSpec``s by name: ramp 0.3 -> 1.2 R*, bursts to 3x of 0.5 R*, a
    sine around 0.65 R*, the largest machine slowed to half under 0.9 R*,
    removed under 0.85 R*, and a ramp 0.4 -> 1.1 R* then that machine at
    0.6."""
    r, W = rate, N_WINDOWS
    big = int(np.argmax(cluster.capacity))
    return {
        "ramp": RS.ramp_trace(0.3 * r, 1.2 * r, n_windows=W),
        "burst": RS.burst_trace(0.5 * r, factor=3.0, n_windows=W, every=60, width=20, jitter=3),
        "sine": RS.sine_trace(0.65 * r, amplitude=0.45, n_windows=W, period=160),
        "slowdown": RS.slowdown_trace(0.9 * r, machine=big, factor=0.5, n_windows=W),
        "failure": RS.failure_trace(0.85 * r, machine=big, n_windows=W),
        "ramp_slowdown": RS.TraceSpec(
            name="ramp_slowdown", n_windows=W, base_rate=0.4 * r,
            events=(RS.rate_ramp(1.1 * r, start=20, end=120),
                    RS.machine_slowdown(big, 0.6, start=150))),
    }


def runtime_setup():
    """The paper's large scenario: (cluster, topology, refined placement,
    its rate R*, ``runtime_traces``) for ``linear_topology()`` on
    ``paper_cluster((20, 70, 90))``, refined on the card."""
    cluster = P.paper_cluster((20, 70, 90))
    topo = P.linear_topology()
    etg = P.schedule(topo, cluster, r0=1.0, rate_epsilon=1.0).etg
    plan = P.refine(etg, cluster, device="cuda")
    return cluster, topo, plan.etg, plan.rate, runtime_traces(cluster, plan.rate)


def sweep_policies(etg: P.ExecutionGraph, n_machines: int) -> np.ndarray:
    """(``N_POLICIES``, T) placements: ``etg``'s, then ones that each move
    one random task to a random machine (from ``SWEEP_SEED``)."""
    rng = np.random.default_rng(SWEEP_SEED)
    base = etg.task_machine()
    pol = np.tile(base, (N_POLICIES, 1))
    rows = np.arange(1, N_POLICIES)
    pol[rows, rng.integers(0, base.size, rows.size)] = rng.integers(0, n_machines, rows.size)
    return pol


@contextlib.contextmanager
def refine_times(totals: list):
    """Within the block, every ``refine`` a controller runs appends its host
    seconds (ended by a synchronise) to ``totals``."""
    from repro_torch.runtime_stream import controller

    real = controller.refine

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        totals.append(time.perf_counter() - t0)
        return out

    controller.refine = timed
    try:
        yield totals
    finally:
        controller.refine = real


def online_run(etg, cluster, trace, device="cuda"):
    """One ``OnlineController(period=10)`` run of ``trace`` from ``etg``:
    (result, controller)."""
    ctl = RS.OnlineController(etg.utg, cluster, period=10, device=device)
    res = RS.StreamExecutor(etg, cluster, trace, config=RUNTIME_CONFIG).run(controller=ctl)
    return res, ctl


def main(argv: list[str] | None = None) -> None:
    from repro_torch.kernels.policy_scan import ops as scan_ops
    from repro_torch.kernels.policy_scan.ref import policy_scan_ref
    from repro_torch.kernels.sched_scoring import ops as sched_ops
    from repro_torch.launch.profile_refine import REFINE_KERNELS
    from repro_torch.launch.profile_serve import profile_phase
    from repro_torch.launch.timing import time_cuda
    from repro_torch.runtime_stream import eval_torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trace", default="ramp", choices=SCENARIOS)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_runtime measures the card: no CUDA device is available")
    cluster, topo, etg, rate, specs = runtime_setup()
    traces = {k: s.compile(cluster, seed=0, utg=topo) for k, s in specs.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    out = {"gpu": smi, "trace": args.trace, "windows": N_WINDOWS, "rate": rate}

    # 1. The online run, unprofiled (after a first-call set-up run).
    trace = traces[args.trace]
    start = RS.provision_schedule(topo, cluster, PROVISION[args.trace] * rate)
    online_run(start, cluster, trace)
    sched_ops.reset_launches()
    with refine_times([]) as refines:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, ctl = online_run(start, cluster, trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    replans = len(ctl.ledger.accepted)
    out["online"] = dict(wall_s=wall, refine_s=sum(refines), refine_calls=len(refines),
                         decisions=len(ctl.ledger), replans=replans,
                         launches=dict(sched_ops.LAUNCHES),
                         sustained=res.sustained_throughput(),
                         migrations=int(res.migrations.sum()))
    print(f"[online, {args.trace}, {N_WINDOWS} windows] wall {wall:.4f} s; refine "
          f"{sum(refines):.4f} s in {len(refines)} calls ({100 * sum(refines) / wall:.1f}%); "
          f"{len(ctl.ledger)} decisions, {replans} replans, {int(res.migrations.sum())} "
          f"instances moved; launches {dict(sched_ops.LAUNCHES)}; sustained "
          f"{res.sustained_throughput():.4f}")

    # 2. The same run under the profiler.
    prof = profile_phase(lambda: online_run(start, cluster, trace), top=8,
                         kernels=REFINE_KERNELS)
    out["online"]["profiled"] = prof
    print(f"  profiled: wall {prof['wall_s']:.4f} s, device busy {prof['device_busy_s']:.4f} s "
          f"({100 * prof['busy_share']:.2f}%), {prof['launches']} device activities; "
          + ", ".join(f"{k} {v['device_ms']:.3f} ms x{v['calls']}"
                      for k, v in prof["port_kernels"].items()))

    # 3. The policy sweep.
    policies = sweep_policies(etg, cluster.n_machines)
    order = list(traces.values())
    eval_torch.evaluate_policies_batch(etg, cluster, order, policies, config=RUNTIME_CONFIG)
    walls = []
    for _ in range(SWEEP_WALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eval_torch.evaluate_policies_batch(etg, cluster, order, policies, config=RUNTIME_CONFIG)
        walls.append(time.perf_counter() - t0)
    sweep_wall = statistics.median(walls)
    operands, topo_s, cfg = eval_torch.scan_operands(etg, cluster, order, policies,
                                                     RUNTIME_CONFIG, torch.device("cuda"))
    kernel_ms = time_cuda(lambda: scan_ops.policy_scan(*operands, topo_s, cfg))
    plain_ms = time_cuda(lambda: policy_scan_ref(*operands, topo_s, cfg), reps=3)
    out["sweep"] = dict(B=len(order), P=policies.shape[0], W=N_WINDOWS, wall_s=sweep_wall,
                        walls_s=walls, kernel_ms=kernel_ms, plain_ms=plain_ms)
    print(f"[sweep] B={len(order)} P={policies.shape[0]} W={N_WINDOWS} T={etg.total_tasks}: "
          f"host-to-host median {sweep_wall:.4f} s of {len(walls)} ("
          + ", ".join(f"{w:.4f}" for w in walls) + f"); policy_scan {kernel_ms:.4f} ms, plain "
          f"version {plain_ms:.3f} ms on the card")
    print(smi)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
