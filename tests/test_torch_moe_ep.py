"""The port's expert-parallel MoE routes against the JAX package's
``shard_map``, on the CPU.

One MoE layer of granite-moe-1b-a400m's reduced config (d_model 64, top-2,
float32), its weights and a (4, 64, 64) batch drawn with numpy from a seed,
on a 2 x 2 ("data", "model") mesh:

* ``a2a`` at ep 4: 8 experts over the full (data, model) group;
* ``a2a`` at ep 2: 6 experts, which divide the model axis only;
* ``replicated``: 8 experts, ``moe_ep_mode="replicated"``.

The reference runs ``repro.models.moe.moe_block`` under ``jax.jit`` on four
host devices, in one subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (the flag must be set
before JAX starts, and this process's JAX may already have one device); the
port runs ``moe_block`` with a ``MeshCtx`` in four gloo processes. Each
rank routes its own tokens, so the port's routing ids must equal the
reference's; outputs agree within 1e-6 (absolute plus relative: XLA's and
torch's float32 expert products sum in other orders) and the aux loss
within 1e-7 (each all-reduce is over two ranks, so no order of sums
differs there). A capacity
factor of 1.0 makes the routes drop choices; capacity is counted from a
rank's own tokens, so the mesh drops other choices than one device does,
which the case checks on both sides.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_mesh_common import full, place, run_gloo

CASES = {  # name: (n_experts, moe_ep_mode, expected route and EP size)
    "a2a_ep4": (8, "a2a", ("a2a", 4)),
    "a2a_ep2": (6, "a2a", ("a2a", 2)),
    "replicated": (8, "replicated", ("replicated", 2)),
}
SHAPE = (4, 64)  # (B, S): a rank holds 2 x 32 tokens under a2a, 2 x 64 replicated
CAPACITY_FACTOR = 1.0

_REFERENCE = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.models import moe
from repro.models.layers import MeshCtx

n_experts, mode, cf, path = json.loads(sys.argv[1])
data = dict(np.load(path))
cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(), n_experts=n_experts,
                          moe_ep_mode=mode, capacity_factor=cf)
p = {"router": {"w": jnp.asarray(data["router"])},
     "experts": {k: jnp.asarray(data[k]) for k in ("w_gate", "w_up", "w_down")}}
x = jnp.asarray(data["x"])
mesh = jax.make_mesh((2, 2), ("data", "model"))
ctx = MeshCtx(mesh=mesh, data_axes=("data",), tp_axis="model")
with mesh:
    out, aux = jax.jit(lambda p, x: moe.moe_block(p, x, ctx, cfg))(p, x)
one, aux1 = jax.jit(lambda p, x: moe.moe_block(p, x, MeshCtx(mesh=None), cfg))(p, x)
_, ids, _ = moe._route(x.reshape(-1, x.shape[-1]), p["router"]["w"], cfg.top_k)
np.savez(path.replace(".npz", "_ref.npz"), out=np.asarray(out), aux=np.asarray(aux),
         one=np.asarray(one), ids=np.asarray(ids))
"""


def _inputs(n_experts, seed=0):
    from repro_torch.configs import get_config

    cfg = get_config("granite-moe-1b-a400m").reduced()
    d, f = cfg.d_model, cfg.moe_d_ff
    rng = np.random.default_rng(seed)

    def draw(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {"router": draw(d, n_experts, scale=d ** -0.5),
            "w_gate": draw(n_experts, d, f, scale=d ** -0.5),
            "w_up": draw(n_experts, d, f, scale=d ** -0.5),
            "w_down": draw(n_experts, f, d, scale=f ** -0.5),
            "x": draw(*SHAPE, d, scale=1.0)}


def _port_rank(rank, world, n_experts, mode, data):
    """One gloo rank: the layer over the 2 x 2 mesh, gathered whole."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.dist import partition
    from repro_torch.launch.steps import mesh_ctx
    from repro_torch.models import moe

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(),
                              n_experts=n_experts, capacity_factor=CAPACITY_FACTOR)
    ctx = mesh_ctx(mesh, cfg, moe_ep_mode=mode)
    t = {k: torch.from_numpy(v) for k, v in data.items()}
    p = {"router": {"w": t["router"]},
         "experts": {k: t[k] for k in ("w_gate", "w_up", "w_down")}}
    p = place(p, partition.shardings(partition.param_specs(p, mesh, cfg), mesh))
    x = place(t["x"], partition.shardings(partition.batch_specs(t["x"], mesh, cfg), mesh))
    route = moe.moe_route(ctx, cfg, *SHAPE)
    with ctx.scope():
        out, aux = moe.moe_block(p, x, cfg, ctx)
    _, ids, _ = moe._route(t["x"].reshape(-1, t["x"].shape[-1]), t["router"], cfg.top_k)
    return route, full(out).numpy(), float(full(aux)), ids.numpy()


def _reference(n_experts, mode, data, tmp_path):
    path = str(tmp_path / f"moe_{n_experts}_{mode}.npz")
    np.savez(path, **data)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    arg = json.dumps([n_experts, mode, CAPACITY_FACTOR, path])
    done = subprocess.run([sys.executable, "-c", _REFERENCE, arg], env=env,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-4000:]
    return dict(np.load(path.replace(".npz", "_ref.npz")))


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_route_matches_reference_shard_map(case, tmp_path):
    n_experts, mode, want_route = CASES[case]
    data = _inputs(n_experts)
    ref = _reference(n_experts, mode, data, tmp_path)
    results = run_gloo(_port_rank, tmp_path, 4, (n_experts, mode, data))
    for route, out, aux, ids in results:  # every rank gathers the same layer
        assert tuple(route[::2]) == want_route
        np.testing.assert_array_equal(ids, ref["ids"])
        np.testing.assert_allclose(out, ref["out"], atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(aux, float(ref["aux"]), rtol=1e-7, atol=0)
    # capacity from each rank's tokens: the mesh drops other choices than
    # one device (an out past 1e-3 of the one-device layer on both sides)
    assert np.abs(ref["out"] - ref["one"]).max() > 1e-3
    assert np.abs(results[0][1] - ref["one"]).max() > 1e-3


def test_moe_route_choice_and_refusal():
    """``moe_route`` on a stand-in mesh: the reference's choice per (E, S),
    the local fallback for an indivisible batch, the refusal for an E that
    the TP axis does not divide."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.layers import MeshCtx

    class Mesh:
        mesh_dim_names, shape = ("data", "model"), (16, 16)

    cfg = get_config("granite-moe-1b-a400m")  # 32 experts
    ctx = MeshCtx(mesh=Mesh())
    assert moe.moe_route(ctx, cfg, 256, 4096) == ("a2a", ("model",), 16)
    assert moe.moe_route(ctx, cfg, 128, 1) == ("replicated", ("model",), 16)
    assert moe.moe_route(ctx, cfg, 8, 4096) == ("local", (), 1)
    big = dataclasses.replace(cfg, n_experts=256)
    assert moe.moe_route(ctx, big, 256, 4096) == ("a2a", ("data", "model"), 256)
    rep = dataclasses.replace(ctx, moe_ep_mode="replicated")
    assert moe.moe_route(rep, big, 256, 4096) == ("replicated", ("model",), 16)
    with pytest.raises(ValueError, match="must divide"):
        moe.moe_route(ctx, dataclasses.replace(cfg, n_experts=24), 256, 1)


def _grad_rank(rank, world, seed):
    """One gloo rank: for each route, the gradients of a random projection
    of the layer's output (capacity factor 64: no choice dropped), over the
    mesh and on one device."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.dist import partition
    from repro_torch.launch.steps import mesh_ctx
    from repro_torch.models import moe

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {}
    for case, (n_experts, mode, _) in sorted(CASES.items()):
        cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(),
                                  n_experts=n_experts, capacity_factor=64.0)
        data = {k: torch.from_numpy(v) for k, v in _inputs(n_experts, seed).items()}
        proj = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
            data["x"].shape).astype(np.float32))
        names = ("router", "w_gate", "w_up", "w_down", "x")

        def grads(t, ctx=None):
            t = {k: v.detach().requires_grad_() for k, v in t.items()}
            p = {"router": {"w": t["router"]},
                 "experts": {k: t[k] for k in ("w_gate", "w_up", "w_down")}}
            y, _ = (moe.moe_block(p, t["x"], cfg, ctx) if ctx else moe.moe_block(p, t["x"], cfg))
            return torch.autograd.grad((y * (pj if ctx else proj)).sum(), [t[n] for n in names])

        ctx = mesh_ctx(mesh, cfg, moe_ep_mode=mode)
        specs = partition.shardings(partition.param_specs(
            {"router": {"w": data["router"]}, "experts": {k: data[k] for k in names[1:4]}},
            mesh, cfg), mesh)
        batch = partition.shardings(partition.batch_specs(data["x"], mesh, cfg), mesh)
        placed = {"router": place(data["router"], specs["router"]["w"]),
                  **{k: place(data[k], specs["experts"][k]) for k in names[1:4]},
                  "x": place(data["x"], batch)}
        pj = place(proj, batch)
        with ctx.scope():
            got = [full(g).numpy() for g in grads(placed, ctx)]
        want = [g.numpy() for g in grads(data)]
        out[case] = (got, want)
    return out


def test_moe_route_gradients_equal_one_device_without_drops(tmp_path):
    """Without drops each route computes the one-device layer, so its
    gradients (through the all-to-alls, the combining all-reduce and the
    replicated operands' ``pvary``) equal the one-device layer's within
    1e-6 of each gradient's largest entry (the aux loss, computed from
    each rank's tokens by design, is left out)."""
    for result in run_gloo(_grad_rank, tmp_path, 4, (3,)):
        for case, (got, want) in result.items():
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * np.abs(w).max(),
                                           err_msg=case)
