"""Fig. 10 and Tables 4-5 on the port (``repro_torch.paper.largescale``,
``device="cpu"``) against ``benchmarks/bench_largescale.py`` on the
reference's NumPy paths, at all three scales (small 2/2/2, medium
10/10/10, large 20/70/90): the whole benchmark takes a few seconds here."""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.core import star_topology  # noqa: E402
from repro_torch.paper import largescale  # noqa: E402
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
    with reference_bench("bench_largescale") as (bench, _mp):
        from repro.core import star_topology as ref_star

        return printed_rows(bench.main), bench.run("large", ref_star)


def test_derived_columns_equal_the_reference(reference):
    assert port_rows(largescale.main("cpu")) == reference[0]


def test_large_star_gains_within_the_simulator_tolerance(reference):
    ours, theirs = largescale.run("large", star_topology, "cpu"), reference[1]
    assert ours["tasks"] == theirs["tasks"] and ours["instances"] == theirs["instances"]
    for key in ("thpt_gain_pct", "util_gain_pct", "table5_ratio"):
        assert np.isclose(ours[key], theirs[key], rtol=1e-9, atol=1e-9), key


def test_chip_smoke_constants(reference):
    assert chip_smoke().PAPER_REF["largescale"] == comparable_rows(reference[0],
                                                                 largescale.MEASURED)
