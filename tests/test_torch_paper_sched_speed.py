"""§3 and the scheduler's perf baseline on the port
(``repro_torch.paper.sched_speed``, ``device="cpu"``) against
``benchmarks/bench_sched_speed.py`` on the reference's NumPy paths.

The reference runs with ``skip_reference=True`` (its seed engine takes
15-25 s) and without its JAX column, which cannot run on this JAX
(ROADMAP C-ref-1). The port has no seed engine: its ``identical_schedule``
holds the schedule against the seed engine's frozen result, which
``tests/test_sched_equivalence.py`` pins for ``repro``."""

import hashlib

import pytest

pytest.importorskip("torch")

from repro_torch.paper import sched_speed  # noqa: E402
from repro_torch.paper.common import fields  # noqa: E402
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
    with reference_bench("bench_sched_speed") as (bench, mp):
        mp.setattr(bench, "_jax_available", lambda: False)
        rows = printed_rows(bench.main, skip_reference=True)
    # The seed engine's schedule equals the incremental one (the golden
    # below), so the reference's full run reports identical_schedule=True.
    rows["sched_engine_large"] += ";identical_schedule=True"
    return rows


def test_derived_columns_equal_the_reference(reference):
    ours = port_rows(sched_speed.main("cpu"))
    assert comparable_rows(ours, sched_speed.MEASURED) == comparable_rows(
        reference, sched_speed.MEASURED)
    sim = fields(ours["sim_batch_backends"])
    assert float(sim["cpu_placements_per_s"]) > 0.0 and "cuda_placements_per_s" not in sim


def test_large_reference_is_the_golden():
    import repro.core as R

    sched = R.schedule(R.linear_topology(), R.paper_cluster(sched_speed.LARGE), r0=1.0,
                       rate_epsilon=1.0)
    assert sched_speed.LARGE_REFERENCE == dict(
        rate=sched.rate, n_instances=sched.etg.n_instances.tolist(),
        iterations=sched.iterations,
        md5=hashlib.md5(sched.etg.task_machine().tobytes()).hexdigest())


def test_chip_smoke_constants(reference):
    assert chip_smoke().PAPER_REF["sched_speed"] == comparable_rows(reference,
                                                                  sched_speed.MEASURED)
