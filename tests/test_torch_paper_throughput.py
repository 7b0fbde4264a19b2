"""Figs. 3/8 on the port (``repro_torch.paper.throughput``, ``device="cpu"``:
``refine`` and ``optimal_schedule`` on the plain scorer) against
``benchmarks/bench_throughput.py`` on the reference's NumPy paths."""

import pytest

pytest.importorskip("torch")

from repro_torch.core import linear_topology  # noqa: E402
from repro_torch.paper import throughput  # noqa: E402
from torch_paper_common import (  # noqa: E402
    chip_smoke,
    one_thread,  # noqa: F401  (autouse)
    comparable_rows,
    port_rows,
    printed_rows,
    reference_bench,
)

FLOAT_KEYS = ("default", "proposed", "refined", "optimal", "gain_vs_default_pct",
              "refined_gain_vs_default_pct", "below_optimal_pct", "refined_below_optimal_pct")


@pytest.fixture(scope="module")
def reference():
    with reference_bench("bench_throughput") as (bench, _mp):
        from repro.core import linear_topology as ref_linear

        return printed_rows(bench.main), bench.run_topology(ref_linear)


def test_derived_columns_equal_the_reference(reference):
    rows = port_rows(throughput.main("cpu"))
    assert rows == reference[0]


def test_unrounded_results_equal_the_reference(reference):
    """The floats behind the rounded columns: the same schedules, refine
    and optimum, so the same rates to the last bit."""
    ours, theirs = throughput.run_topology(linear_topology, "cpu"), reference[1]
    assert {k: ours[k] for k in FLOAT_KEYS} == {k: theirs[k] for k in FLOAT_KEYS}
    assert ours["optimal_candidates"] == theirs["optimal_candidates"]


def test_chip_smoke_constants(reference):
    assert chip_smoke().PAPER_REF["throughput"] == comparable_rows(reference[0],
                                                                 throughput.MEASURED)
