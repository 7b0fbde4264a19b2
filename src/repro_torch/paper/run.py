"""Every benchmark of the port, one function per paper table/figure.

Port of ``benchmarks/run.py``; prints ``name,us_per_call,derived`` CSV rows.

  fig6   CPU-usage prediction accuracy            (prediction)
  fig7   instance-count selection (RollingCount / UniqueVisitor)
  fig8   throughput: default vs proposed vs optimal (also fig3)
  fig9   per-machine utilization comparison
  fig10  large-scale simulation scenarios + Table 4/5
  sec3   scheduler wall-time vs exhaustive optimal (sched_speed)
  refine refine/optimal engine walls (refine_speed)
  dispatch where the card starts to win over the CPU scorer
  runtime online streaming runtime: static vs online controller vs oracle
         on drift scenarios
  multitenant 100-tenant fairness scale, tenant-batched scoring, shared
         runtime
  netaware network-aware vs distance-blind placement on rack-structured
         clusters
  roofline dry-run roofline aggregation (``launch.dryrun``'s artifacts)
  planner LM-serving pipeline-stage planning over a mixed GPU fleet

With ``--json-dir`` the
benchmarks that write a ``BENCH_*.json`` in the reference write it there,
under the same name.

    PYTHONPATH=src python -m repro_torch.paper.run [--device cpu] [--json-dir DIR]
"""

from __future__ import annotations

import argparse
import os

from repro_torch import resolve_device
from repro_torch.paper import (
    dispatch,
    instances,
    largescale,
    multitenant,
    netaware,
    planner,
    prediction,
    roofline,
    refine_speed,
    runtime,
    sched_speed,
    throughput,
    utilization,
)

# (benchmark, the reference's JSON file name or None), in the reference's order.
BENCHMARKS = (
    (prediction, None),
    (throughput, None),
    (instances, None),
    (utilization, None),
    (largescale, None),
    (sched_speed, "BENCH_sched.json"),
    (refine_speed, "BENCH_refine.json"),
    (dispatch, "BENCH_dispatch.json"),
    (runtime, "BENCH_runtime.json"),
    (multitenant, "BENCH_multitenant.json"),
    (netaware, "BENCH_netaware.json"),
    (roofline, None),
    (planner, None),
)


def main(device="cuda", json_dir=None) -> list:
    device = resolve_device(device)
    print("name,us_per_call,derived")
    rows = []
    for benchmark, name in BENCHMARKS:
        path = os.path.join(json_dir, name) if json_dir and name else None
        rows += benchmark.main(device, json_path=path)
    return rows


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--json-dir", default=None,
                        help="write the benchmarks' BENCH_*.json files here")
    args = parser.parse_args()
    main(args.device, args.json_dir)
