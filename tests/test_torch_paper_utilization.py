"""Fig. 9 on the port (``repro_torch.paper.utilization``, ``device="cpu"``:
refine, the optimal search and the simulator on the CPU path) against
``benchmarks/bench_utilization.py`` on the reference's NumPy paths."""

import functools

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.paper import utilization  # noqa: E402
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
    with reference_bench("bench_utilization") as (bench, mp):
        run = functools.cache(bench.run)  # main times a call, then makes another
        mp.setattr(bench, "run", run)
        from repro.core import star_topology

        return printed_rows(bench.main), run(star_topology)


def test_derived_columns_equal_the_reference(reference):
    assert port_rows(utilization.main("cpu")) == reference[0]


def test_utilizations_within_the_simulator_tolerance(reference):
    """Per machine and in total, each Star schedule's utilization at its R*
    agrees with the reference's simulator to 1e-9 (Star: the cheapest of
    the three topologies to rerun)."""
    from repro_torch.core import star_topology

    got, theirs = utilization.run(star_topology, "cpu"), reference[1]
    for name in ("default", "proposed", "optimal"):
        assert got[name]["throughput"] == theirs[name]["throughput"]
        assert got[name]["util"] == theirs[name]["util"]
        assert np.isclose(got[name]["total_util"], theirs[name]["total_util"],
                          rtol=1e-9, atol=1e-9)


def test_chip_smoke_constants(reference):
    assert chip_smoke().PAPER_REF["utilization"] == comparable_rows(reference[0],
                                                                  utilization.MEASURED)
