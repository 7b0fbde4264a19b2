"""Beyond-paper — heterogeneous fleet planning for LM serving, on the port.

Port of ``benchmarks/bench_planner.py``: plan pipeline-stage replicas for
each assigned architecture over a mixed GPU fleet and compare the
admission rate against naive round-robin placement. The fleet is the GPU
counterpart of the reference's mixed TPU fleet: H100 x 8 groups of 8 (one
HGX node a group), A100 x 4 groups of 8 and L4 x 12 groups of 4
(``repro_torch.sched.fleet``'s data-sheet constants). Over its 24 groups
every architecture's plan has more than 64 tasks, so ``plan`` skips
``refine`` and each row is the host's work.
"""

from __future__ import annotations

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, get_config
from repro_torch.paper.common import cli, emit, timed
from repro_torch.sched.fleet import A100_SXM, H100_SXM, L4, DevicePool, Fleet
from repro_torch.sched.planner import plan

FLEET = Fleet(pools=(
    DevicePool(chip=H100_SXM, count=8, chips_per_group=8, name="h100"),
    DevicePool(chip=A100_SXM, count=4, chips_per_group=8, name="a100"),
    DevicePool(chip=L4, count=12, chips_per_group=4, name="l4"),
))

MEASURED = frozenset()


def main(device="cuda", json_path=None) -> list:
    """One ``planner_<arch>`` row an architecture (``json_path`` is taken
    for the common signature: the reference writes no JSON file)."""
    device = resolve_device(device)
    rows = []
    for arch in ARCHS:
        cfg = get_config(arch)
        p, us = timed(lambda: plan(cfg, FLEET, n_stages=4, device=device), device)
        gain = (p.tokens_per_s / max(p.baseline_tokens_per_s, 1e-9) - 1) * 100
        rows.append(emit(
            f"planner_{arch}",
            us,
            f"admission={p.tokens_per_s:,.0f}tok/s;"
            f"rr_baseline={p.baseline_tokens_per_s:,.0f};gain={gain:.0f}%;"
            f"iters={p.iterations}",
        ))
    return rows


if __name__ == "__main__":
    main(**cli(__doc__))
