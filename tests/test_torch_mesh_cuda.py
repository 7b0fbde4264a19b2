"""The mesh route on the card. Marked ``cuda``: the tests skip without a
card. This file imports no JAX (the card's machine has none):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_mesh_cuda.py

A one-rank NCCL group (a ``FileStore`` under the test's directory) and a
1 x 1 ("data", "model") mesh: one train step of reduced qwen1.5-0.5b,
recurrentgemma-2b (3 layers) and granite-moe-1b-a400m through
``make_train_step(mesh=...)`` on DTensors equals the mesh-less step from
the same state and batch bit for bit (deterministic algorithms on for
both), and the recurrent blocks launch B5 and its backward inside
``local_map`` exactly as the mesh-less step does. ``chip_smoke.py``
phase 21 runs the same at full width.
"""

import dataclasses
import os

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def one_rank_mesh(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(0)
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()
        torch.use_deterministic_algorithms(det)


def _place(tree, specs):
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, dict):
        return {k: _place(v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_place(v, s) for v, s in zip(tree, specs)]
    return distribute_tensor(tree, specs.mesh, list(specs.placements))


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "recurrentgemma-2b", "granite-moe-1b-a400m"])
def test_one_rank_mesh_step_equals_meshless(arch, one_rank_mesh):
    from torch.distributed.tensor import DTensor

    from repro_torch._tree import leaves
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.dist import partition
    from repro_torch.kernels.rglru_scan import ops as scan_ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import adamw

    mesh = one_rank_mesh
    cfg = get_config(arch).reduced()
    if cfg.block_pattern:
        cfg = dataclasses.replace(cfg, n_layers=3, block_pattern=cfg.resolved_block_pattern[:3])
    opt = adamw.AdamWConfig()
    params = M.init_params(cfg, seed=0, device="cuda")
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in SyntheticLM(cfg.vocab_size, 64, 4, seed=0).batch_at(0).items()}
    scan_ops.reset_launches()
    ref, ref_m = make_train_step(cfg, opt, device="cuda", remat=True)(
        {"params": params, "opt": adamw.init_opt_state(params, opt)}, batch)
    want = dict(scan_ops.LAUNCHES)
    pd = _place(params, partition.shardings(partition.param_specs(params, mesh, cfg), mesh))
    bd = _place(batch, partition.shardings(partition.batch_specs(batch, mesh, cfg), mesh))
    scan_ops.reset_launches()
    new, met = make_train_step(cfg, opt, device="cuda", remat=True, mesh=mesh)(
        {"params": pd, "opt": adamw.init_opt_state(pd, opt)}, bd)
    assert scan_ops.LAUNCHES == want
    if cfg.block_pattern:
        n_rec = cfg.resolved_block_pattern.count("rglru")
        assert want == {"rglru_scan": 2 * n_rec, "rglru_scan_bwd": n_rec}
    full = [t.full_tensor() if isinstance(t, DTensor) else t for t in leaves(new)]
    assert all(torch.equal(a, b) for a, b in zip(leaves(ref), full))
    for key in ("loss", "grad_norm", "lr"):
        got = met[key].full_tensor() if isinstance(met[key], DTensor) else met[key]
        assert torch.equal(got, ref_m[key]), key
