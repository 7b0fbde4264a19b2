"""The port stands alone: no JAX, no ``repro``, no silent CPU fallback.

An AST scan proves that ``src/repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor the reference package; the batched entry points must
raise on ``device="cuda"`` when no card is present.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as P  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.core.schedule_state import ScheduleState  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, repro_torch.core, repro_torch.kernels.sched_scoring.ops,"
        " repro_torch.kernels.cut_traffic.ops, repro_torch.launch.profile_refine,"
        " repro_torch.kernels.flash_attention.ops, repro_torch.kernels.decode_attention.ops,"
        " repro_torch.kernels.rglru_scan.ops, repro_torch.kernels.slstm_scan.ops,"
        " repro_torch.kernels.slstm_scan.kernel, repro_torch.models.rglru,"
        " repro_torch.models.moe, repro_torch.models.mla, repro_torch.models.attention,"
        " repro_torch.configs.granite_moe_1b_a400m, repro_torch.configs.deepseek_v3_671b,"
        " repro_torch.models.xlstm, repro_torch.configs.xlstm_125m,"
        " repro_torch.configs.whisper_tiny,"
        " repro_torch.models.model, repro_torch.models.convert, repro_torch.configs,"
        " repro_torch.launch.steps, repro_torch.launch.profile_serve, repro_torch.serve_lm,"
        " repro_torch.runtime_stream, repro_torch.runtime_stream.convert,"
        " repro_torch.kernels.policy_scan.ops, repro_torch.kernels.policy_scan.kernel,"
        " repro_torch.obs.ledger, repro_torch.launch.profile_runtime, repro_torch.launch.timing,"
        " repro_torch.multitenant, repro_torch.obs, repro_torch.obs.validate,"
        " repro_torch.runtime_demo, repro_torch.paper_repro, repro_torch.paper.run,"
        " repro_torch.paper.common, repro_torch.paper.prediction, repro_torch.paper.throughput,"
        " repro_torch.paper.instances, repro_torch.paper.utilization,"
        " repro_torch.paper.largescale, repro_torch.paper.sched_speed,"
        " repro_torch.paper.refine_speed, repro_torch.paper.netaware, repro_torch.paper.runtime,"
        " repro_torch.paper.multitenant, repro_torch.paper.dispatch, repro_torch.paper.planner,"
        " repro_torch.configs.qwen2_vl_72b, repro_torch.roofline, repro_torch.sched,"
        " repro_torch.sched.fleet, repro_torch.sched.stage_model, repro_torch.sched.planner,"
        " repro_torch.sched.elastic, repro_torch._tree, repro_torch.optim.adamw,"
        " repro_torch.optim.compression, repro_torch.data.pipeline,"
        " repro_torch.checkpoint.store, repro_torch.runtime.trainer, repro_torch.train_lm,"
        " repro_torch.step_analysis, repro_torch.dist.partition, repro_torch.launch.mesh,"
        " repro_torch.dist.collectives, repro_torch.launch.dryrun,"
        " repro_torch.launch.rank_collectives, repro_torch.paper.roofline,"
        " repro_torch.paper.make_tables;"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')];"
        "sys.exit(1 if bad else 0)"
    )
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: 'cuda' requests are valid here")


def test_cuda_entry_points_raise_without_a_card(no_card):
    cl = P.paper_cluster((1, 1, 1))
    etg = P.schedule(P.linear_topology(), cl, rate_epsilon=0.5).etg
    tm = etg.task_machine()[None, :]
    calls = [
        lambda: resolve_device(),
        lambda: P.max_stable_rate_batch(etg, cl, tm),
        lambda: ScheduleState.from_etg(etg, cl).score_task_machine_batch(tm),
        lambda: P.refine(etg, cl),
        lambda: P.optimal_schedule(P.linear_topology(), cl, max_total_tasks=5),
        lambda: P.simulate_batch(etg, cl, tm, 1.0),
        lambda: P.simulate(etg, cl, 1.0),
    ]
    # The LM serving path defaults to the card as well.
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serve_lm import serve

    lm = get_config("qwen1.5-0.5b").reduced()
    params = M.init_params(lm, device="cpu")
    caches = M.init_caches(lm, 1, 4, device="cpu")
    tokens = {"tokens": np.zeros((1, 2), np.int64)}
    calls += [
        lambda: M.init_params(lm),
        lambda: M.init_caches(lm, 1, 4),
        lambda: M.prefill(params, lm, tokens, caches),
        lambda: M.decode_step(params, lm, tokens, caches),
        lambda: serve(lm, batch=1, prompt_len=2, gen_len=2),
    ]
    # The MoE family's (granite's routed experts; DeepSeek's MLA, its
    # shared expert and MTP parameters), xLSTM's and Whisper's (its encoder
    # and cross-attention) on the same entry points.
    from repro_torch.models import mla, xlstm

    for arch in ("granite-moe-1b-a400m", "deepseek-v3-671b", "xlstm-125m", "whisper-tiny",
                 "qwen2-vl-72b"):
        moe_lm = get_config(arch).reduced()
        moe_params = M.init_params(moe_lm, device="cpu")
        moe_caches = M.init_caches(moe_lm, 1, 4, device="cpu")
        batch = dict(tokens)
        if moe_lm.is_encoder_decoder:
            batch["encoder_embeds"] = torch.zeros(1, moe_lm.encoder_seq, moe_lm.d_model)
        if moe_lm.embedding_inputs:  # qwen2-vl: embeddings and M-RoPE positions
            batch = {"embeds": torch.zeros(1, 2, moe_lm.d_model),
                     "mrope_positions": torch.zeros(3, 1, 2, dtype=torch.int64)}
        calls += [
            lambda c=moe_lm: M.init_params(c),
            lambda c=moe_lm: M.init_caches(c, 1, 4),
            lambda c=moe_lm, p=moe_params, k=moe_caches, b=batch: M.prefill(p, c, b, k),
            lambda c=moe_lm, p=moe_params, k=moe_caches, b=batch: M.decode_step(p, c, b, k),
            lambda c=moe_lm: serve(c, batch=1, prompt_len=2, gen_len=2),
        ]
    calls.append(lambda: mla.init_mla_cache(1, 4, get_config("deepseek-v3-671b"),
                                            torch.bfloat16))
    calls += [lambda: xlstm.init_mlstm_state(1, get_config("xlstm-125m")),
              lambda: xlstm.init_slstm_state(1, get_config("xlstm-125m"))]
    # So do the streaming runtime's batch evaluator and its controllers.
    from repro_torch.runtime_stream import (
        OnlineController,
        OracleRescheduler,
        TraceSpec,
        evaluate_policies_batch,
    )

    trace = TraceSpec(name="flat", n_windows=4, base_rate=1.0).compile(cl)
    calls += [
        lambda: evaluate_policies_batch(etg, cl, [trace], tm),
        lambda: OnlineController(etg.utg, cl),
        lambda: OracleRescheduler(etg.utg, cl),
    ]
    # And multi-tenant scheduling: the water filling, its floors, the
    # tenant-batched scorer and the shared runtime.
    import repro_torch.multitenant as MT
    from repro_torch.runtime_demo import main as runtime_demo

    tenants = [MT.Tenant(name="a", utg=P.linear_topology(), target_rate=1.0),
               MT.Tenant(name="b", utg=P.star_topology(), target_rate=1.0)]
    ms = MT.schedule_tenants(tenants, cl, device="cpu", warm_refine_rounds=1)
    mt = MT.MultiTenantState.first_assignment(MT.TenantSet(tenants), cl)
    mtrace = MT.compile_tenant_traces(
        MT.TenantSet(tenants), [TraceSpec(name=t.name, n_windows=4, base_rate=0.5)
                                for t in tenants], cl)
    calls += [
        lambda: MT.schedule_tenants(tenants, cl),
        lambda: MT.fair_slice_floors(tenants, cl),
        lambda: MT.TenantBatchScorer(mt),
        lambda: MT.MultiTenantRuntime(ms, MT.TenantSet(tenants), cl, mtrace).run(),
        lambda: runtime_demo(),
    ]
    # And the serving planner: ``plan`` (also where its refine gate skips
    # the card), the elastic controller and the serve example's fleet half.
    from repro_torch.paper import planner as paper_planner
    from repro_torch.sched import ElasticController, plan
    from repro_torch.serve_lm import FLEET
    from repro_torch.serve_lm import main as serve_main

    vlm = get_config("qwen2-vl-72b")
    calls += [
        lambda: plan(vlm, FLEET),
        lambda: plan(vlm, paper_planner.FLEET),
        lambda: ElasticController(vlm, FLEET),
        lambda: paper_planner.main(),
        lambda: serve_main([]),
    ]
    # And the paper's reproduction and every benchmark.
    import repro_torch.paper_repro as paper_repro
    from repro_torch.paper import run as paper_run
    from repro_torch.paper.run import BENCHMARKS

    calls += [lambda: paper_repro.main(), lambda: paper_run.main()]
    calls += [lambda d=benchmark: d.main() for benchmark, _json in BENCHMARKS]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # The explicit CPU request works and scores the same as the host path.
    assert P.max_stable_rate_batch(etg, cl, tm, device="cpu")[1][0] == P.max_stable_rate(etg, cl)[1]
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_planner_resolves_the_device_before_any_host_work(no_card, monkeypatch):
    """``plan``, and with it the planner benchmark (``paper.run``'s last
    entry) and ``serve_lm.main``, refuse a ``"cuda"`` request before they
    build a stage model or a config's plan."""
    import repro_torch.sched.planner as planner_mod
    from repro_torch.paper import planner as paper_planner
    from repro_torch.paper.run import BENCHMARKS
    from repro_torch.serve_lm import main as serve_main

    assert BENCHMARKS[-1] == (paper_planner, None)
    work = []
    monkeypatch.setattr(planner_mod, "build_stage_model", lambda *a, **k: work.append(a))
    monkeypatch.setattr(paper_planner, "get_config", lambda *a: work.append(a))
    monkeypatch.setattr("repro_torch.serve_lm.get_config", lambda *a: work.append(a))
    from repro_torch.configs import get_config

    for call in (lambda: planner_mod.plan(get_config("xlstm-125m"), paper_planner.FLEET),
                 lambda: paper_planner.main("cuda"), lambda: serve_main(["--device", "cuda"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert work == []


def test_chip_smoke_refuses_to_run_without_a_card(no_card, tmp_path):
    """The chip smoke fails (and prints no result line) without a card,
    and when it is run alone, away from the repository."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
            env = {"PATH": "/usr/bin:/bin"}
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


def test_launch_counts_stay_zero_on_the_cpu_path():
    from repro_torch.kernels.sched_scoring import ops

    before = dict(ops.LAUNCHES)
    cl = P.paper_cluster((2, 2, 2))
    etg = P.schedule(P.star_topology(), cl, rate_epsilon=0.5).etg
    P.refine(etg, cl, device="cpu", max_rounds=1)
    assert ops.LAUNCHES == before
    assert np.all(np.isfinite(P.max_stable_rate_batch(etg, cl, etg.task_machine()[None, :],
                                                      device="cpu")[0]))
