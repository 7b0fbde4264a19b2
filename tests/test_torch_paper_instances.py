"""Fig. 7 on the port (``repro_torch.paper.instances``, ``device="cpu"``)
against ``benchmarks/bench_instances.py`` on the reference's NumPy paths."""

import functools

import pytest

pytest.importorskip("torch")

from repro_torch.core import rolling_count_topology  # noqa: E402
from repro_torch.paper import instances  # noqa: E402
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
    with reference_bench("bench_instances") as (bench, mp):
        mp.setattr(bench, "run", functools.cache(bench.run))  # main times, then reruns
        from repro.core import rolling_count_topology as ref_rc

        return printed_rows(bench.main), bench.run(ref_rc)


def test_derived_columns_equal_the_reference(reference):
    assert port_rows(instances.main("cpu")) == reference[0]


def test_sweep_optimum_equals_the_reference(reference):
    ours, theirs = instances.run(rolling_count_topology, device="cpu"), reference[1]
    assert ours == theirs  # pairs, throughputs and loss, bit for bit


def test_chip_smoke_constants(reference):
    assert chip_smoke().PAPER_REF["instances"] == comparable_rows(reference[0],
                                                                instances.MEASURED)
