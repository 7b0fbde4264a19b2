"""The port's LM-serving planner (``repro_torch.sched``) against the JAX
package's (``repro.sched``), on the CPU.

Both packages' fleets are built from one description, each chip from one
dict of ``ChipSpec`` fields: the reference's TPU generations (taken from
``repro.sched.fleet`` here; the port carries none of them) and the port's
GPUs (``repro_torch.sched.fleet``'s data-sheet constants). Four fleets:
the reference's benchmark fleet (v5e x 8 groups of 16, v4 x 4 of 8, lite
x 12 of 4) and example fleet (v5e x 6 of 8, lite x 8 of 4), and their GPU
counterparts, the port's benchmark fleet (H100 x 8 of 8, A100 x 4 of 8,
L4 x 12 of 4) and example fleet (H100 x 6 of 8, L4 x 8 of 4).

The stage model's e, met, FLOPs and bytes must be equal; ``plan`` and
``ElasticController`` (``device="cpu"``) must give equal replicas,
assignments and iterations, and rates equal or within 1e-12 relative.
The reference's ``plan`` calls ``refine`` with its default
``backend="auto"``, which on the CPU reaches its JAX scorer and stops on
the installed JAX (ROADMAP C-ref-1); the tests hold it to its NumPy
oracle by a scoped monkeypatch of ``repro.sched.planner.refine``.
"""

import dataclasses
import functools

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.sched.elastic as jax_elastic  # noqa: E402
import repro.sched.fleet as jax_fleet  # noqa: E402
import repro.sched.planner as jax_planner  # noqa: E402
import repro.sched.stage_model as jax_stage_model  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.refine import refine as jax_refine  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch import serve_lm  # noqa: E402
from repro_torch.paper import planner as paper_planner  # noqa: E402
from repro_torch.sched import elastic, fleet, planner, stage_model  # noqa: E402

CHIPS = {c.name: dataclasses.asdict(c) for c in (
    jax_fleet.TPU_V5E, jax_fleet.TPU_V4, jax_fleet.TPU_LITE,
    fleet.H100_SXM, fleet.A100_SXM, fleet.L4)}
# (chip, groups, chips a group, pool name) per pool.
FLEETS = {
    "tpu_bench": (("tpu_v5e", 8, 16, "v5e"), ("tpu_v4", 4, 8, "v4"), ("tpu_lite", 12, 4, "lite")),
    "tpu_example": (("tpu_v5e", 6, 8, "v5e"), ("tpu_lite", 8, 4, "lite")),
    "gpu_bench": (("h100_sxm", 8, 8, "h100"), ("a100_sxm", 4, 8, "a100"), ("l4", 12, 4, "l4")),
    "gpu_example": (("h100_sxm", 6, 8, "h100"), ("l4", 8, 4, "l4")),
}
# The archs whose plan comes under refine's gate (at most 64 tasks over at
# most 64 groups) on each fleet, with the tasks of the ETG it refines.
REFINED = {
    "tpu_bench": {"qwen2_vl_72b": 52},
    "tpu_example": {"deepseek_v3_671b": 53, "starcoder2_7b": 55, "qwen2_vl_72b": 62},
    "gpu_bench": {},
    "gpu_example": {"recurrentgemma_2b": 30, "granite_moe_1b_a400m": 43, "xlstm_125m": 49,
                    "whisper_tiny": 61, "starcoder2_7b": 35, "qwen2_vl_72b": 49},
}


def build(mod, name):
    return mod.Fleet(pools=tuple(
        mod.DevicePool(chip=mod.ChipSpec(**CHIPS[chip]), count=n, chips_per_group=g, name=pool)
        for chip, n, g, pool in FLEETS[name]))


@pytest.fixture
def numpy_refine(monkeypatch):
    """The reference's planner on its NumPy scorer (ROADMAP C-ref-1)."""
    monkeypatch.setattr(jax_planner, "refine", functools.partial(jax_refine, backend="numpy"))


@pytest.fixture
def refine_calls(monkeypatch):
    """The tasks of each ETG that the port's planner refines, in call order."""
    calls = []
    real = planner.refine

    def spy(etg, cluster, **kwargs):
        calls.append(etg.total_tasks)
        return real(etg, cluster, **kwargs)

    monkeypatch.setattr(planner, "refine", spy)
    return calls


def test_gpu_chips_and_fleets():
    assert (fleet.H100_SXM.peak_flops, fleet.H100_SXM.hbm_bw, fleet.H100_SXM.ici_bw,
            fleet.H100_SXM.hbm_bytes) == (989e12, 3.35e12, 50e9, 80e9)
    assert (fleet.A100_SXM.peak_flops, fleet.A100_SXM.hbm_bw) == (312e12, 2.039e12)
    assert (fleet.L4.peak_flops, fleet.L4.hbm_bw, fleet.L4.ici_bw, fleet.L4.hbm_bytes) == (
        121e12, 300e9, 64e9, 24e9)
    assert paper_planner.FLEET == build(fleet, "gpu_bench")
    assert serve_lm.FLEET == build(fleet, "gpu_example")
    nodes = fleet.h100_node_fleet(n_nodes=3, groups_per_node=2, gpus_per_group=4)
    assert nodes.n_groups == 6 and nodes.pools[0].group_flops == 4 * 989e12
    assert nodes.pool_of_group().tolist() == [0] * 6
    spec = fleet.L4
    assert spec.step_seconds(121e12, 0.0, 0.0) == 1.0 == spec.step_seconds(0.0, 0.0, 64e9)


@pytest.mark.parametrize("name", FLEETS)
@pytest.mark.parametrize("arch", ARCHS)
def test_stage_model_equals_the_reference(arch, name):
    ours = stage_model.build_stage_model(get_config(arch), build(fleet, name))
    theirs = jax_stage_model.build_stage_model(jax_get_config(arch), build(jax_fleet, name))
    for f in ("flops_per_token", "bytes_per_token"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(theirs, f))
    np.testing.assert_array_equal(ours.profile.e, theirs.profile.e)
    np.testing.assert_array_equal(ours.profile.met, theirs.profile.met)
    assert ours.profile.machine_type_names == theirs.profile.machine_type_names
    assert ours.utg.edges == theirs.utg.edges and ours.utg.name == theirs.utg.name
    cl = stage_model.fleet_cluster(build(fleet, name), ours)
    np.testing.assert_array_equal(cl.machine_types, build(fleet, name).pool_of_group())


def _same_plan(ours, theirs):
    assert ours.arch == theirs.arch and ours.n_stages == theirs.n_stages
    np.testing.assert_array_equal(ours.replicas, theirs.replicas)
    assert len(ours.assignment) == len(theirs.assignment)
    for a, b in zip(ours.assignment, theirs.assignment):
        np.testing.assert_array_equal(a, b)
    assert ours.iterations == theirs.iterations
    for f in ("tokens_per_s", "predicted_throughput", "baseline_tokens_per_s"):
        assert np.isclose(getattr(ours, f), getattr(theirs, f), rtol=1e-12, atol=0.0), f
    assert ours.summary() == theirs.summary()


@pytest.mark.parametrize("name", FLEETS)
def test_plan_equals_the_reference(name, numpy_refine, refine_calls):
    refined = {}
    for arch in ARCHS:
        before = len(refine_calls)
        ours = planner.plan(get_config(arch), build(fleet, name), device="cpu")
        if len(refine_calls) > before:
            refined[arch] = refine_calls[-1]
        _same_plan(ours, jax_planner.plan(jax_get_config(arch), build(jax_fleet, name)))
    assert refined == REFINED[name]


# The tasks of each ETG that the elastic run on the GPU example fleet
# refines (initial, two H100 groups lost, restored; a plan over 64 tasks
# skips refine): phase 18 launches B1 for every arch.
ELASTIC_REFINES = {
    "recurrentgemma_2b": [30, 29, 30], "deepseek_v3_671b": [50],
    "granite_moe_1b_a400m": [43, 56, 43], "xlstm_125m": [49, 22, 49],
    "whisper_tiny": [61, 53, 61], "internlm2_1_8b": [59], "yi_9b": [30],
    "starcoder2_7b": [35, 35], "qwen1_5_0_5b": [43], "qwen2_vl_72b": [49, 48, 49],
}


@pytest.mark.parametrize("name", ["tpu_example", "gpu_example"])
@pytest.mark.parametrize("arch", ARCHS)
def test_elastic_controller_equals_the_reference(arch, name, numpy_refine, refine_calls):
    ours = elastic.ElasticController(get_config(arch), build(fleet, name), device="cpu")
    theirs = jax_elastic.ElasticController(jax_get_config(arch), build(jax_fleet, name))
    for ctl in (ours, theirs):
        ctl.fail(0, 2)
        ctl.restore(0, 2)
    if name == "gpu_example":
        assert refine_calls == ELASTIC_REFINES[arch]
    assert [r for r, _ in ours.history] == [r for r, _ in theirs.history] == [
        "initial", "fail pool0 x2", "restore pool0 x2"]
    for (_, a), (_, b) in zip(ours.history, theirs.history):
        _same_plan(a, b)
    assert np.isclose(ours.admission_rate, theirs.admission_rate, rtol=1e-12, atol=0.0)
    # Losing every group of a pool drops the pool from the fleet.
    ours.fail(1, 100)
    theirs.fail(1, 100)
    _same_plan(ours.current, theirs.current)


def test_plan_without_refine(numpy_refine):
    cfg = get_config("qwen2-vl-72b")
    ours = planner.plan(cfg, build(fleet, "gpu_example"), use_refine=False, device="cpu")
    theirs = jax_planner.plan(jax_get_config("qwen2-vl-72b"), build(jax_fleet, "gpu_example"),
                              use_refine=False)
    _same_plan(ours, theirs)


def test_serve_example_prints_the_references_plans(numpy_refine, capsys):
    """``serve_lm.main``'s fleet half: the plan over the GPU example fleet,
    the plan after losing two H100 groups, then the reduced model served."""
    serve_lm.main(["--arch", "qwen2-vl-72b", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
          "--gen-len", "4"])
    out = capsys.readouterr().out
    theirs = jax_elastic.ElasticController(jax_get_config("qwen2-vl-72b"),
                                           build(jax_fleet, "gpu_example"))
    initial = theirs.current.summary()
    theirs.fail(0, 2)
    assert out.startswith(initial + "\n")
    assert (f"after losing 2 h100 groups -> admission {theirs.admission_rate:,.0f} tok/s\n"
            + theirs.current.summary()) in out
    assert "served 2 requests x 4 tokens of qwen2-vl-72b-smoke" in out


def test_chip_smoke_refined_archs():
    """Phase 18 expects B1 launches exactly for the archs refined here."""
    from torch_paper_common import chip_smoke

    assert chip_smoke().PLANNER_REFINED == tuple(REFINED["gpu_example"])
