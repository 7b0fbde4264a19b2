"""Quickstart on the PyTorch + CUDA port: schedule a stream topology on a
heterogeneous cluster and compare against Storm's default round-robin
scheduler.

    PYTHONPATH=src python -m repro_torch.quickstart                # on a GPU
    PYTHONPATH=src python -m repro_torch.quickstart --device cpu

Port of ``examples/quickstart.py``; prints the same numbers.
"""

import argparse

import numpy as np

from repro_torch.core import (
    linear_topology,
    max_stable_rate,
    paper_cluster,
    predict,
    refine,
    round_robin_schedule,
    schedule,
    simulate,
)


def main(device: str = "cuda") -> None:
    # The paper's 3-worker cluster: Pentium / Core i3 / Core i5 (Table 2/3).
    cluster = paper_cluster((1, 1, 1))
    topo = linear_topology()
    print(f"topology: {topo.name} with {topo.n_components} components, device {device}")

    # Proposed scheduler (Algorithm 1 + 2).
    sched = schedule(topo, cluster, r0=1.0, rate_epsilon=0.05)
    rate, thpt = max_stable_rate(sched.etg, cluster)
    print(f"\nproposed: instances={sched.etg.n_instances.tolist()} "
          f"rate={rate:.2f} tuples/s throughput={thpt:.2f}")
    pred = predict(sched.etg, cluster, rate)
    print(f"machine utilization: {np.round(pred.machine_util, 1).tolist()}")

    # Beyond-paper local-search refinement, candidate sweeps on `device`.
    ref = refine(sched.etg, cluster, device=device)
    print(f"refined:  instances={ref.etg.n_instances.tolist()} "
          f"throughput={ref.throughput:.2f} ({len(ref.moves)} moves)")

    # Storm default baseline at the same instance counts.
    rr = round_robin_schedule(topo, cluster, ref.etg.n_instances)
    _, rr_thpt = max_stable_rate(rr, cluster)
    print(f"default round-robin: throughput={rr_thpt:.2f}")
    print(f"\ngain vs default: {(ref.throughput / rr_thpt - 1) * 100:.1f}% "
          f"(paper reports 7-44%)")

    # Sanity: the simulator agrees with the prediction at the stable rate.
    sim = simulate(ref.etg, cluster, ref.rate, device=device)
    print(f"simulated throughput at stable rate: {sim.throughput:.2f}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(parser.parse_args().device)
