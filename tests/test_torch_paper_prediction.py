"""Fig. 6 on the port (``repro_torch.paper.prediction``, ``device="cpu"``)
against ``benchmarks/bench_prediction.py`` on the reference's NumPy paths:
every derived field equal, and ``chip_smoke.py``'s constants fresh."""

import json

import pytest

pytest.importorskip("torch")

from repro_torch.paper import prediction  # noqa: E402
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
    with reference_bench("bench_prediction") as (bench, _mp):
        return printed_rows(bench.main)


def test_derived_columns_equal_the_reference(reference, tmp_path):
    path = tmp_path / "prediction.json"
    rows = port_rows(prediction.main("cpu", json_path=str(path)))
    assert rows == reference  # no field measured: the whole column
    result = json.loads(path.read_text())["prediction"]
    assert result["n_points"] == 121 and result["accuracy"] >= 92.0


def test_chip_smoke_constants(reference):
    assert chip_smoke().PAPER_REF["prediction"] == comparable_rows(reference,
                                                                 prediction.MEASURED)
