"""Network-aware placement on the port (``repro_torch.paper.netaware``,
``device="cpu"``: B2's and the cut-traffic kernel's plain versions) against
``benchmarks/bench_netaware.py``, whose refines score with
``backend="numpy"``. Rates agree to 1e-12 (ROADMAP C-port-1)."""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.paper import netaware  # noqa: E402
from torch_paper_common import (  # noqa: E402
    chip_smoke,
    one_thread,  # noqa: F401  (autouse)
    comparable_rows,
    port_rows,
    printed_rows,
    reference_bench,
)

TIMES = ("blind_wall_s", "aware_wall_s")


@pytest.fixture(scope="module")
def reference():
    with reference_bench("bench_netaware") as (bench, _mp):
        name, utg, cluster, engine = bench.SCENARIOS[1]
        return printed_rows(bench.main), bench.scenario_row(name, utg, cluster, engine)


def test_derived_columns_equal_the_reference(reference):
    assert port_rows(netaware.main("cpu")) == reference[0]


def test_rolling_count_row_within_1e12(reference):
    name, utg, cluster, engine = netaware.SCENARIOS[1]
    ours, theirs = netaware.scenario_row(name, utg, cluster, engine, "cpu"), reference[1]
    for key in ("blind_rate_true_objective", "aware_rate"):
        assert np.isclose(ours[key], theirs[key], rtol=1e-12, atol=0.0), key
    assert ({k: v for k, v in ours.items() if k not in TIMES + ("blind_rate_true_objective",
                                                               "aware_rate")}
            == {k: v for k, v in theirs.items() if k not in TIMES + (
                "blind_rate_true_objective", "aware_rate")})


def test_chip_smoke_constants(reference):
    assert chip_smoke().PAPER_REF["netaware"] == comparable_rows(reference[0],
                                                               netaware.MEASURED)
