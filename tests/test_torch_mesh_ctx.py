"""The port's ``MeshCtx`` and mesh route against the JAX package's, on the CPU.

* ``shard``'s dropped entries: for every constraint the models write (the
  reference's 29 ``ctx.`` sites: attention heads, MLA's expanded heads,
  the MLP / RG-LRU / xLSTM features, the residual stream with and without
  sequence parallelism) at every arch's full shapes of every cell, the
  port's placements equal the ``PartitionSpec`` the reference's
  ``MeshCtx.shard`` builds, on the 16x16, 2x16x16 and model-only meshes
  (stand-ins with the mapping each reads: the reference's ``shape``, the
  port's ``mesh_dim_names`` and ``shape``; the reference's constraint is
  captured by a scoped monkeypatch of ``with_sharding_constraint``).
* One train step of reduced qwen1.5-0.5b and recurrentgemma-2b (float32,
  a (4, 16) batch) on four gloo processes over a 2 x 2 ("data", "model")
  mesh against the mesh-less step from the same state and batch: loss and
  gradient norm within 1e-6 (relative), AdamW's moments (m and sqrt(v),
  both a multiple of the gradient) within 1e-6 of the entry plus 2e-6 of
  the leaf's largest entry (the mesh sums each gradient
  in shards, then across them: float32 rounding, measured up to 1.18e-6 of
  a leaf's largest entry), and the new parameters within 1e-6 wherever the
  step is not a sign: AdamW's first step moves a parameter by about
  ``lr * g / (|g| + eps)``, so an entry whose gradient is within a few eps
  of 0 moves by an amount that order-of-sums noise in g decides; those
  entries (|g| below 1e-3 of the leaf's largest) are held to ``lr``.
* ``gather_params``: with the use-site gather on, one all-gather per 2-D
  weight per use in the forward, and its backward one reduce-scatter each
  (fake group of 4 ranks, meta tensors).
"""

import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import layers as jax_layers
from repro.models.config import SHAPES
from repro_torch.configs import get_config
from repro_torch.models.layers import MeshCtx

from torch_mesh_common import full, place, run_gloo

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "model-only": ((16,), ("model",))}


class _JaxMesh:
    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))


class _TorchMesh:
    def __init__(self, shape, names):
        self.shape, self.mesh_dim_names = shape, names


def _sites(cfg, shape):
    """(site, tensor shape, spec of a ctx) of every constraint of a cell."""
    B, S = shape.global_batch, 1 if shape.is_decode else shape.seq_len
    hd, H = cfg.resolved_head_dim, cfg.n_heads
    heads = lambda c: (c.data_axes, None, c.tp_axis, None)  # noqa: E731
    out = [("attention.q", (B, S, H, hd), heads), ("attention.out", (B, S, H, hd), heads)]
    if cfg.use_mla:
        dq = cfg.qk_nope_dim + cfg.qk_rope_dim
        out += [("mla.q_full", (B, S, H, dq), heads), ("mla.v_full", (B, S, H, cfg.v_head_dim),
                                                       heads)]
    widths = {"mlp": cfg.d_ff, "moe.shared": cfg.moe_d_ff * max(cfg.n_shared_experts, 1),
              "rglru": cfg.lru_width or cfg.d_model, "xlstm.up": 2 * cfg.d_model}
    for name, f in widths.items():
        if f:
            out.append((name, (B, S, f), lambda c: (c.data_axes, None, c.tp_axis)))
    for seq in (False, True):
        out.append((f"tokens(seq={seq})", (B, S, cfg.d_model),
                    lambda c, seq=seq: (c.data_axes, c.tp_axis if seq else None, None)))
    return out


def _reference_spec(ctx, shape, spec, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(jax_layers.jax.sharding, "NamedSharding", lambda mesh, p: p)
        m.setattr(jax_layers.jax.lax, "with_sharding_constraint", lambda x, s: s)
        return ctx.shard(_Shaped(shape), *spec)


class _Shaped:
    def __init__(self, shape):
        self.shape, self.ndim = shape, len(shape)


def _as_spec(placements, names, ndim):
    """Port placements -> the PartitionSpec entries they stand for."""
    entries = [[] for _ in range(ndim)]
    for name, pl in zip(names, placements):
        if hasattr(pl, "dim"):
            entries[pl.dim].append(name)
    return tuple(None if not e else (e[0] if len(e) == 1 else tuple(e)) for e in entries)


def _norm(spec, ndim):
    """A reference PartitionSpec padded to ndim, 1-tuples unwrapped."""
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else
                 (None if isinstance(e, tuple) and not e else e) for e in spec)


@pytest.mark.parametrize("seq", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_shard_drops_the_reference_entries(mesh, seq, monkeypatch):
    shape_, names = MESHES[mesh]
    data = tuple(a for a in ("pod", "data") if a in names)
    jctx = jax_layers.MeshCtx(mesh=_JaxMesh(shape_, names), data_axes=data, tp_axis="model",
                              seq_sharded=seq)
    tctx = MeshCtx(mesh=_TorchMesh(shape_, names), data_axes=data, tp_axis="model",
                   seq_sharded=seq)
    n = 0
    for arch in JAX_ARCHS:
        cfg = get_config(arch)
        for cell in SHAPES.values():
            for site, shape, spec_of in _sites(cfg, cell):
                want = _reference_spec(jctx, shape, spec_of(jctx), monkeypatch)
                got = tctx.placements(shape, spec_of(tctx))
                assert _as_spec(got, names, len(shape)) == _norm(want, len(shape)), (
                    arch, cell.name, site, shape)
                n += 1
            # shard_tokens / shard_features build the same specs as the sites
            x = _Shaped((cell.global_batch, 1 if cell.is_decode else cell.seq_len, cfg.d_model))
            with monkeypatch.context() as m:
                m.setattr(jax_layers.jax.sharding, "NamedSharding", lambda mesh, p: p)
                m.setattr(jax_layers.jax.lax, "with_sharding_constraint", lambda x, s: s)
                want = jctx.shard_tokens(x)
            seq_e = tctx.tp_axis if seq else None
            got = tctx.placements(x.shape, (tctx.data_axes, seq_e, None))
            assert _as_spec(got, names, 3) == _norm(want, 3)
    assert n == 288  # 10 archs x 4 cells x their sites


def _train_rank(rank, world, arch):
    """One gloo rank: the mesh-less step and the 2 x 2 mesh step, gathered."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch._tree import leaves
    from repro_torch.dist import partition
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.optim import adamw

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16)))
    batch = {"tokens": tokens, "labels": torch.nn.functional.pad(tokens[:, 1:], (0, 1))}
    opt = adamw.AdamWConfig()
    ref, ref_m = steps.make_train_step(cfg, opt, device="cpu")(
        {"params": params, "opt": adamw.init_opt_state(params, opt)}, batch)
    pd = place(params, partition.shardings(partition.param_specs(params, mesh, cfg), mesh))
    bd = place(batch, partition.shardings(partition.batch_specs(batch, mesh, cfg), mesh))
    new, met = steps.make_train_step(cfg, opt, device="cpu", mesh=mesh)(
        {"params": pd, "opt": adamw.init_opt_state(pd, opt)}, bd)
    new, met = full(new), full(met)

    def np_leaves(tree):
        return [t.detach().numpy() for t in leaves(tree)]

    return ({k: float(v) for k, v in ref_m.items()}, {k: float(v) for k, v in met.items()},
            [np_leaves(ref[k]) for k in ("params",)] + [np_leaves(ref["opt"][k]) for k in "mv"],
            [np_leaves(new[k]) for k in ("params",)] + [np_leaves(new["opt"][k]) for k in "mv"],
            np_leaves(params))


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "recurrentgemma-2b"])
def test_mesh_train_step_equals_meshless(arch, tmp_path):
    lr = 3e-4  # AdamWConfig's default
    for ref_m, met, ref, got, before in run_gloo(_train_rank, tmp_path, 4, (arch,)):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(met[key], ref_m[key], rtol=1e-6, atol=0)
        (p0, m0, v0), (p1, m1, v1) = ref, got
        # m is (1 - b1) g, v (1 - b2) g^2: compare g's scale, m and sqrt(v)
        for a, b in zip(m0 + [np.sqrt(v) for v in v0], m1 + [np.sqrt(v) for v in v1]):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=2e-6 * max(np.abs(a).max(), 1e-30))
        for a, b, g, p in zip(p0, p1, m0, before):
            sign_like = np.abs(g) < 1e-3 * max(np.abs(g).max(), 1e-30)
            np.testing.assert_allclose(b[~sign_like], a[~sign_like], rtol=0, atol=1e-6)
            assert np.all(np.abs(b - a)[sign_like] <= 2 * lr)


def test_gather_params_one_gather_per_weight_per_use():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch import allow_meta
    from repro_torch.launch import dryrun
    from repro_torch.models.config import ShapeConfig
    from repro_torch.step_analysis import analyze_local

    def site():
        """"gather": the use-site all-gather (``gather``'s own redistribute);
        "relayout": the placement before it (a ``shard`` inside ``gather``)."""
        node = torch._C._current_autograd_node()
        names, f = [], sys._getframe(1)
        while f is not None:
            if f.f_code.co_filename.endswith("models/layers.py"):
                names.append(f.f_code.co_name)
            f = f.f_back
        if node is not None:
            return "backward"
        if "gather" not in names:
            return "other"
        return "gather" if names[0] == "gather" else "relayout"

    cfg = get_config("qwen1.5-0.5b").reduced()
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        with allow_meta():
            cell = dryrun.prepare_cell(cfg, ShapeConfig("t", 64, 8, "train"), mesh,
                                       mesh_opts={"zero3_use_site_gather": True},
                                       step_opts={"remat": False})
            _, _, sites, _ = analyze_local(lambda: cell.fn(*cell.args), site=site)
    finally:
        dist.destroy_process_group()
    # per block: wq, wk, wv, wo, w_gate, w_up, w_down (the biases are 1-D)
    uses = 7 * cfg.n_layers
    assert sites[("gather", "all-gather")][1] == uses
    assert set(sites) & {("gather", k) for k in ("all-reduce", "reduce-scatter", "all-to-all")} \
        == set()
    # the backward reduce-scatters each gathered weight's gradient (and
    # nothing else of this step reduce-scatters)
    assert sites[("backward", "reduce-scatter")][1] == uses
