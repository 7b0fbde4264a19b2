"""The dispatch benchmark on the port (``repro_torch.paper.dispatch``,
``device="cpu"``) against ``benchmarks/bench_dispatch.py``: the same
scenarios x regimes with the same shapes (tasks, machines).

The derived columns name each grid's shape; every other number is a time.
So both benchmarks sweep batches of 1 and 8 rows only here, and the
reference runs without its JAX column, which cannot run on this JAX
(ROADMAP C-ref-1). On the CPU alone the port reports no crossover."""

import json

import pytest

pytest.importorskip("torch")

from repro_torch.paper import dispatch  # noqa: E402
from torch_paper_common import (  # noqa: E402
    chip_smoke,
    one_thread,  # noqa: F401  (autouse)
    comparable_rows,
    port_rows,
    reference_bench,
)


@pytest.fixture(scope="module")
def reference():
    with reference_bench("bench_dispatch") as (bench, mp):
        import repro.core.simulator as sim

        mp.setattr(sim, "_jax_available", lambda: False)
        mp.setattr(bench, "BATCH_SIZES", (1, 8))
        out = bench.bench_dispatch()
    assert not out["jax_available"] and not out["crossovers"]
    return {f"dispatch_crossover_{r['scenario']}_{r['regime']}":
            f"tasks={r['tasks']};machines={r['machines']}" for r in out["grid"]}


@pytest.fixture(scope="module")
def ours(tmp_path_factory):
    path = tmp_path_factory.mktemp("dispatch") / "BENCH_dispatch.json"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dispatch, "BATCH_SIZES", (1, 8))
        rows = dispatch.main("cpu", json_path=str(path))
    return port_rows(rows), json.loads(path.read_text())


def test_grid_shapes_equal_the_reference(reference, ours):
    assert comparable_rows(ours[0], dispatch.MEASURED) == reference
    assert all(d.endswith(";crossover_elements=none") for d in ours[0].values())


def test_grid_times_the_cpu_only(ours):
    grid = ours[1]["grid"]
    assert ours[1]["card"] is False and len(grid) == 4 * 3 * 2
    assert all(row["cpu_us"] > 0.0 and "cuda_us" not in row for row in grid)


def test_chip_smoke_constants(reference):
    assert chip_smoke().PAPER_REF["dispatch"] == reference
