"""The multi-tenant benchmark on the port (``repro_torch.paper.multitenant``,
``device="cpu"``) against ``benchmarks/bench_multitenant.py`` on the
reference's NumPy paths.

The two scale rows schedule 100 tenants on 90 machines, which takes 20-50 s
a row in the reference alone on this host: here both benchmarks run their
scale rows on 20 tenants of the same fleet on ``paper_cluster((4, 4, 4))``
(capacity x4 and x1, the rows' names kept), the batching and runtime rows
as they are. ``chip_smoke.py`` holds the card's 100-tenant rows against
``PAPER_REF``; ``test_scale_constants_at_full_size`` (``slow``) recomputes
them."""

import pytest

pytest.importorskip("torch")

from repro_torch.paper import multitenant  # noqa: E402
from torch_paper_common import (  # noqa: E402
    chip_smoke,
    one_thread,  # noqa: F401  (autouse)
    comparable_rows,
    port_rows,
    printed_rows,
    reference_bench,
)

SMALL = ((20, (4, 4, 4), 4.0, "roomy_90x400"), (20, (4, 4, 4), 1.0, "paper_90x100"))


@pytest.fixture(scope="module")
def reference():
    with reference_bench("bench_multitenant") as (bench, mp):
        sizes = {label: (n, counts) for n, counts, _scale, label in SMALL}
        scale_row = bench.scale_row
        mp.setattr(bench, "scale_row", lambda n, counts, cap_scale, label: scale_row(
            *sizes[label], cap_scale, label))
        rows = printed_rows(bench.main)
        return rows, scale_row(20, (4, 4, 4), 1.0, "paper_90x100")


def test_derived_columns_equal_the_reference(reference):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(multitenant, "SCALE_ROWS", SMALL)
        ours = port_rows(multitenant.main("cpu"))
    assert comparable_rows(ours, multitenant.MEASURED) == comparable_rows(
        reference[0], multitenant.MEASURED)


def test_scale_row_equals_the_reference(reference):
    """Every field of a scale row but its wall: rounds, candidates, rates,
    levels, feasibility and the recomputed floors."""
    n, counts, cap_scale, label = SMALL[1]
    ours = multitenant.scale_row(label, *multitenant.fleet(n, counts, cap_scale, "cpu"), "cpu")
    theirs = reference[1]
    assert {k: v for k, v in ours.items() if k != "wall_s"} == {
        k: v for k, v in theirs.items() if k != "wall_s"}


def test_chip_smoke_constants(reference):
    """The batching and runtime rows recomputed; the 100-tenant scale rows'
    rounds against the fleets' constants that
    ``tests/test_torch_multitenant_golden.py`` recomputes."""
    cs = chip_smoke()
    ref = cs.PAPER_REF["multitenant"]
    ours = comparable_rows(reference[0], multitenant.MEASURED)
    for name in ("multitenant_batching", "multitenant_runtime"):
        assert ref[name] == ours[name]
    for scale, label in ((4, "roomy_90x400"), (1, "paper_90x100")):
        assert f"rounds={cs.MT_FLEET_REF[scale]['rounds']};" in ref[f"multitenant_scale_{label}"]
    assert set(ref) == set(ours)


@pytest.mark.slow
def test_scale_constants_at_full_size():
    with reference_bench("bench_multitenant") as (bench, _mp):
        rows = printed_rows(bench.main)
    assert chip_smoke().PAPER_REF["multitenant"] == comparable_rows(rows,
                                                                  multitenant.MEASURED)
