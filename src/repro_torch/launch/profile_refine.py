"""Where the re-plan time goes: the main and the resource-path ``refine``
under ``torch.profiler``, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_refine

Schedules ``linear_topology()`` on ``paper_cluster((20, 70, 90))`` (the
main path, scored by B1) and on ``resource_cluster()`` (the same machines
with memory and six racks: B2 and the cut-traffic term), then refines each
on the card three times:

1. unprofiled, for the wall time;
2. with the sweep's two stages on the host clock, each ended by a
   synchronise: ``network_unit_load`` (the cut-traffic term) and
   ``closed_form_rates`` (operands to the card, the scorer, the readback);
   the rest of the wall is the host's candidate rows and bookkeeping;
3. under ``torch.profiler``: device busy time, device activities, the
   device time and calls of the port's kernels, and the top device ops.

It prints these, the card's ``nvidia-smi`` name and power limit, and one
JSON line with the same numbers. Needs a card; there is no CPU mode.

    python src/repro_torch/launch/profile_refine.py --walls 5

only times each ``refine`` unprofiled ``--walls`` times (after one warm-up
call) and prints the walls, their median and spread, and one JSON line. This
mode uses nothing of the package past ``repro_torch.core``'s public
functions, so with ``PYTHONPATH`` set to an earlier checkout's ``src`` the
same script times that checkout's code: alternate the two in one chip call to
compare them on one card.
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

__all__ = ["REFINE_KERNELS", "resource_cluster", "stage_times", "main"]

# Substrings of the trace names of the scheduler's kernels (B1 and B2 are
# one template; the cut-traffic kernel feeds B2).
REFINE_KERNELS = {"sched_scoring": "sched_scoring", "cut_traffic": "cut_traffic"}


def resource_cluster() -> P.Cluster:
    """20/70/90 with per-type memory demand, 8 units of memory a machine and
    six racks of 30 machines (same rack 1, across racks 2)."""
    base = P.paper_cluster((20, 70, 90))
    profile = base.profile.with_mem(np.array([0.5, 1.0, 1.5, 2.0]))
    return P.Cluster(
        machine_types=base.machine_types, capacity=base.capacity, profile=profile,
        mem_capacity=np.full(180, 8.0),
        distance=P.rack_distance_matrix(np.arange(180) % 6), net_penalty=0.05,
    )


@contextlib.contextmanager
def stage_times(totals: dict[str, list]):
    """Within the block, every call of ``cost_model.network_unit_load`` and
    ``cost_model.closed_form_rates`` adds its host seconds (ended by a
    synchronise) and one call to ``totals[name]``."""
    from repro_torch.core import cost_model

    saved = {}
    for name in ("network_unit_load", "closed_form_rates"):
        fn = saved[name] = getattr(cost_model, name)
        totals[name] = [0.0, 0]

        def timed(*args, _fn=fn, _name=name, **kwargs):
            t0 = time.perf_counter()
            out = _fn(*args, **kwargs)
            torch.cuda.synchronize()
            totals[_name][0] += time.perf_counter() - t0
            totals[_name][1] += 1
            return out

        setattr(cost_model, name, timed)
    try:
        yield totals
    finally:
        for name, fn in saved.items():
            setattr(cost_model, name, fn)


def _wall(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--walls", type=int, default=0,
                        help="only time each refine this many times, unprofiled")
    args = parser.parse_args(argv)
    cases = {}
    for label, cl, rounds in (("main", P.paper_cluster((20, 70, 90)), 200),
                              ("resource", resource_cluster(), 3)):
        etg = P.schedule(P.linear_topology(), cl, r0=1.0, rate_epsilon=1.0).etg
        cases[label] = (lambda etg=etg, cl=cl, rounds=rounds:
                        P.refine(etg, cl, max_rounds=rounds, device="cuda"))
    for fn in cases.values():
        fn()  # first-call set-up (kernel build and load, allocator)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    out = {"gpu": smi}
    if args.walls > 0:
        for label, fn in cases.items():
            walls = [_wall(fn) for _ in range(args.walls)]
            out[label] = dict(walls_s=walls, median_s=statistics.median(walls),
                              min_s=min(walls), max_s=max(walls))
            print(f"[{label} refine] median {out[label]['median_s']:.4f} s of {args.walls} "
                  f"(min {min(walls):.4f}, max {max(walls):.4f}): "
                  + ", ".join(f"{w:.4f}" for w in walls))
        print(smi)
        print(json.dumps(out))
        return
    from repro_torch.launch.profile_serve import profile_phase

    for label, fn in cases.items():
        wall = _wall(fn)
        with stage_times({}) as totals:
            staged = _wall(fn)
        res = profile_phase(fn, top=10, kernels=REFINE_KERNELS)
        stages = {k: dict(s=v[0], calls=v[1]) for k, v in totals.items()}
        rest = staged - sum(v[0] for v in totals.values())
        out[label] = dict(wall_s=wall, staged_wall_s=staged, stages=stages, host_rest_s=rest,
                          profiled=res)
        print(f"[{label} refine] wall {wall:.4f} s unprofiled")
        print(f"  stages ({staged:.4f} s with a synchronise after each): " + ", ".join(
            f"{k} {v['s']:.4f} s x{v['calls']}" for k, v in stages.items())
            + f", host rows and bookkeeping {rest:.4f} s")
        print(f"  profiled: wall {res['wall_s']:.4f} s, device busy {res['device_busy_s']:.4f} s "
              f"({100 * res['busy_share']:.1f}%), {res['launches']} device activities")
        print("  port kernels: " + ", ".join(f"{k} {v['device_ms']:.3f} ms x{v['calls']}"
                                             for k, v in res["port_kernels"].items()))
        for row in res["top"]:
            print(f"  {row['device_ms']:10.3f} ms  x{row['calls']:<6} {row['name']}")
    print(smi)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
