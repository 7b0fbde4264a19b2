"""Refine and optimal walls on the port (``repro_torch.paper.refine_speed``,
``device="cpu"``) against ``benchmarks/bench_refine.py`` on the reference's
NumPy paths.

The reference runs with ``skip_reference=True`` (its per-candidate engines
take minutes), and the port has none (README): its ``identical`` holds each
result against ``refine_speed.REFERENCE``, recomputed here from ``repro``'s
state engines, which the reference's tests hold identical to its reference
engines. Its full run reports ``identical=True`` on every row."""

import hashlib

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.paper import refine_speed  # noqa: E402
from torch_paper_common import (  # noqa: E402
    chip_smoke,
    one_thread,  # noqa: F401  (autouse)
    comparable_rows,
    port_rows,
    printed_rows,
    reference_bench,
)


@pytest.fixture(scope="module")
def reference():
    with reference_bench("bench_refine") as (bench, _mp):
        rows = printed_rows(bench.main, skip_reference=True)
    for name, derived in rows.items():
        if "identical=" not in derived:
            rows[name] = derived + ";identical=True"
    return rows


def test_derived_columns_equal_the_reference(reference):
    ours = port_rows(refine_speed.main("cpu"))
    assert comparable_rows(ours, refine_speed.MEASURED) == comparable_rows(
        reference, refine_speed.MEASURED)


def test_reference_results_are_repros():
    import repro.core as R
    from repro.core.refine import refine

    def md5(etg):
        return hashlib.md5(etg.task_machine().astype(np.int64).tobytes()).hexdigest()

    got = {}
    cluster = R.paper_cluster(refine_speed.SLOW_SUITE_CLUSTER)
    for topo_fn in (R.linear_topology, R.diamond_topology, R.star_topology):
        etg = R.schedule(topo_fn(), cluster, r0=1.0, rate_epsilon=0.05).etg
        res = refine(etg, cluster, backend="numpy")
        got[topo_fn().name] = (res.moves, res.rate, res.throughput, md5(res.etg))
    wide = R.paper_cluster(refine_speed.WIDE_CLUSTER)
    etg = R.schedule(R.wide_fanout_topology(14), wide, r0=1.0, rate_epsilon=0.1).etg
    res = refine(etg, wide, backend="numpy")
    got["wide"] = (res.moves, res.throughput, md5(res.etg))
    opt = R.optimal_schedule(R.linear_topology(), cluster, max_total_tasks=8)
    got["optimal"] = (opt.throughput, opt.candidates_evaluated, md5(opt.etg))
    assert got == refine_speed.REFERENCE


def test_chip_smoke_constants(reference):
    assert chip_smoke().PAPER_REF["refine_speed"] == comparable_rows(reference,
                                                                   refine_speed.MEASURED)
