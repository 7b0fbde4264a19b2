"""Fig. 6 — CPU-usage prediction accuracy, on the port.

Port of ``benchmarks/bench_prediction.py``. For the highCompute bolt of each
micro-benchmark topology on each machine type, sweep the input rate from low
to saturation (the paper starts at 8 tuples/s and multiplies by random
factors), compare predicted TCU (eq. 5) against the simulator's measured TCU
(with the paper's moderate-load noise profile, simulated on ``device``), and
report accuracy = 100 - mean |error|.

Paper claims: >= 92 % accuracy, max error < 8 CPU points.
"""

from __future__ import annotations

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import (
    diamond_topology,
    first_assignment,
    linear_topology,
    max_stable_rate,
    measured_tcu,
    paper_cluster,
    predict,
    prediction_accuracy,
    star_topology,
)
from repro_torch.paper.common import cli, emit, timed, write_json

MEASURED = frozenset()


def run(device="cuda") -> dict:
    device = resolve_device(device)
    cluster = paper_cluster((1, 1, 1))
    all_pred, all_meas = [], []
    worst = 0.0
    for topo_fn in (linear_topology, diamond_topology, star_topology):
        topo = topo_fn()
        etg = first_assignment(topo, cluster, 1.0)
        max_rate, _ = max_stable_rate(etg, cluster)
        rng = np.random.default_rng(0)
        rate = max(max_rate / 32.0, 0.05)
        while rate <= max_rate:
            pred = predict(etg, cluster, rate)
            meas = measured_tcu(etg, cluster, rate, seed=int(rate * 1000) % 2**31,
                                device=device)
            all_pred.extend(pred.tcu.tolist())
            all_meas.extend(meas.tolist())
            worst = max(worst, float(np.abs(pred.tcu - meas).max()))
            rate *= float(rng.uniform(1.2, 1.8))

    acc = prediction_accuracy(np.array(all_pred), np.array(all_meas))
    return {"accuracy": acc, "max_error": worst, "n_points": len(all_pred)}


def main(device="cuda", json_path=None) -> list:
    device = resolve_device(device)
    r, us = timed(lambda: run(device), device)
    write_json(json_path, {"prediction": r})
    return [emit(
        "fig6_prediction_accuracy",
        us,
        f"accuracy={r['accuracy']:.1f}%;max_err={r['max_error']:.2f}pts;"
        f"n={r['n_points']};paper>=92%",
    )]


if __name__ == "__main__":
    main(**cli(__doc__))
