"""The LM-serving planner benchmark on the port (``repro_torch.paper.planner``,
``device="cpu"``) against ``benchmarks/bench_planner.py`` run on the port's
GPU fleet (the reference's ``repro.sched`` objects built from the port's
chip constants in place of its TPU fleet), and ``chip_smoke.py``'s
``PLANNER_REF``, the rows that phase 18 holds the card against. Over the
fleet's 24 groups no plan comes under ``refine``'s gate; the reference's
``refine`` is held to its NumPy oracle all the same (ROADMAP C-ref-1).
"""

import dataclasses
import functools

import pytest

pytest.importorskip("torch")

from repro_torch.paper import planner  # noqa: E402
from torch_paper_common import (  # noqa: E402
    chip_smoke,
    comparable_rows,
    one_thread,  # noqa: F401  (autouse)
    port_rows,
    printed_rows,
    reference_bench,
)


@pytest.fixture(scope="module")
def reference():
    import repro.sched.fleet as F
    import repro.sched.planner as RP
    from repro.core.refine import refine

    with reference_bench("bench_planner") as (bench, mp):
        mp.setattr(RP, "refine", functools.partial(refine, backend="numpy"))
        mp.setattr(bench, "FLEET", F.Fleet(pools=tuple(
            F.DevicePool(chip=F.ChipSpec(**dataclasses.asdict(p.chip)), count=p.count,
                         chips_per_group=p.chips_per_group, name=p.name)
            for p in planner.FLEET.pools)))
        return printed_rows(bench.main)


def test_derived_columns_equal_the_reference(reference):
    ours = port_rows(planner.main("cpu"))
    assert list(ours) == [f"planner_{arch}" for arch in planner.ARCHS]
    assert ours == reference


def test_chip_smoke_constants(reference):
    assert chip_smoke().PLANNER_REF == comparable_rows(reference, planner.MEASURED)
