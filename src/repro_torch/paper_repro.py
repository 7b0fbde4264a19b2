"""Full paper reproduction on the PyTorch + CUDA port: every claim,
one script.

    PYTHONPATH=src python -m repro_torch.paper_repro                # on a GPU
    PYTHONPATH=src python -m repro_torch.paper_repro --device cpu

Port of ``examples/paper_repro.py``; prints the same sections and rows
(derived columns equal, times of ``--device``). Covers: prediction accuracy
(Fig. 6), throughput vs default/optimal (Figs. 3/8), instance selection
(Fig. 7), utilization (Fig. 9), large-scale scenarios (Fig. 10 / Tables
4-5) and the scheduler's wall time (§3).
"""

import argparse

from repro_torch import resolve_device
from repro_torch.paper import (
    instances,
    largescale,
    prediction,
    sched_speed,
    throughput,
    utilization,
)

SECTIONS = (
    ("Fig. 6: CPU usage prediction", prediction),
    ("Figs. 3/8: throughput comparison", throughput),
    ("Fig. 7: instance-count selection", instances),
    ("Fig. 9: utilization comparison", utilization),
    ("Fig. 10 / Tables 4-5: large-scale simulation", largescale),
    ("Sec. 3: scheduler wall-time", sched_speed),
)


def main(device: str = "cuda") -> list:
    """Run every section on ``device``; returns ``[(title, rows), ...]``."""
    device = resolve_device(device)
    print("name,us_per_call,derived")
    out = []
    for title, benchmark in SECTIONS:
        print(f"# -- {title} --")
        out.append((title, benchmark.main(device)))
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(parser.parse_args().device)
