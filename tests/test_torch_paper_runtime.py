"""The online-runtime benchmark on the port (``repro_torch.paper.runtime``,
``device="cpu"``) against ``benchmarks/bench_runtime.py`` on the reference's
NumPy paths: all 17 drift rows (static, online, blind and oracle
policies), the evaluator's parity row and the recorder's record counts.

Two pieces of the reference are replaced in its run: ``parity_smoke``,
which cannot run on this JAX (ROADMAP C-ref-1), by the result its gate
demands (within 1e-9); and ``overhead_rows``, whose 58 timed runs a
scenario are only timing, by one recorded run of each scenario (the
record count, the row's one result). The port's overhead rows run with one
sample of one pair for the same reason."""

import json

import pytest

pytest.importorskip("torch")

from repro_torch.paper import runtime  # noqa: E402
from torch_paper_common import (  # noqa: E402
    chip_smoke,
    one_thread,  # noqa: F401  (autouse)
    comparable_rows,
    port_rows,
    printed_rows,
    reference_bench,
)


def _recorded_runs(bench):
    def overhead_rows(cluster):
        rows = []
        keyed = bench.keyed_rolling_count_topology(
            n_keys=16, zipf_s=1.5, state_per_tuple=bench.STATE_PER_TUPLE)
        for topo, scen_fn in ((bench.linear_topology(), bench._scenarios),
                              (keyed, bench._keyed_scenarios)):
            spec, rate, clu, cfg = scen_fn(topo, cluster)[0]
            trace = spec.compile(clu, seed=bench.SEED, utg=topo)
            start_etg = bench._start_etg(topo, trace, rate, clu)
            rec = bench.TraceRecorder(name=f"overhead-{trace.name}", wall_clock=True)
            ctl = bench.OnlineController(topo, clu, period=10, recorder=rec)
            bench.StreamExecutor(start_etg, clu, trace, config=cfg, recorder=rec).run(
                controller=ctl)
            rows.append(dict(scenario=trace.name, recorder_off_s=0.0, recorder_on_s=0.0,
                             overhead_pct=0.0, within_5pct=True, records=len(rec.records)))
        return rows

    return overhead_rows


@pytest.fixture(scope="module")
def reference():
    with reference_bench("bench_runtime") as (bench, mp):
        mp.setattr(bench, "overhead_rows", _recorded_runs(bench))
        mp.setattr(bench, "parity_smoke", lambda topo, cluster: dict(
            jax_available=False, max_abs_throughput_diff=0.0, max_abs_latency_diff=0.0,
            within_1e9=True))
        return printed_rows(bench.main)


@pytest.fixture(scope="module")
def ours(tmp_path_factory):
    path = tmp_path_factory.mktemp("runtime") / "BENCH_runtime.json"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(runtime, "OVERHEAD_SAMPLES", 1)
        mp.setattr(runtime, "OVERHEAD_PAIRS", 1)
        rows = runtime.main("cpu", json_path=str(path))
    return port_rows(rows), json.loads(path.read_text())


def test_derived_columns_equal_the_reference(reference, ours):
    assert len(reference) == 17 + 1 + 2
    assert comparable_rows(ours[0], runtime.MEASURED) == comparable_rows(
        reference, runtime.MEASURED)


def test_rows_carry_the_reference_acceptance(ours):
    """Every row beats static with a complete replan ledger; the keyed rows
    keep their ablation and oracle gates; the parity row compared the CPU
    path with itself."""
    data = ours[1]
    rows = [row for table in data["scenarios"].values() for row in table]
    assert len(rows) == 17
    assert all(row["beats_static"] and row["ledger_complete"] for row in rows)
    keyed = data["scenarios"]["keyed_rolling_count"]
    assert all(row["aware_beats_blind"] for row in keyed)
    assert [row.get("oracle_not_below_online") for row in keyed] == [True, True, None]
    assert data["parity"]["card"] is False and data["parity"]["max_abs_throughput_diff"] == 0.0
    assert [row["records"] for row in data["overhead"]] == [233, 499]


def test_chip_smoke_constants(reference):
    assert chip_smoke().PAPER_REF["runtime"] == comparable_rows(reference, runtime.MEASURED)
