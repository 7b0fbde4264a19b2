"""The port's partition rules and meshes against the JAX package's, on the CPU.

Every arch of ``configs.ARCHS`` at full size: meta tensors (no memory) of
the shapes of the reference's ``abstract_params``, ``abstract_caches`` and
``input_specs``, in the reference's stacked layout and in the port's
per-repeat layout. Each dimension's placement from
``repro_torch.dist.partition`` must equal the reference's
``PartitionSpec`` (padded with ``None``) on the 16x16, 2x16x16 and
model-only meshes; a per-repeat leaf equals its stacked leaf without the
stacked entry. The port's meshes are ``DeviceMesh``es over a fake process
group of 512 ranks, set up and destroyed around this module; the
reference reads only ``mesh.shape``, so a stand-in with that mapping
serves it. The port's own parameter trees (reduced configs) land the name
rules on the same leaves. Also the port of
``tests/test_substrate.py``'s mesh-without-a-data-axis test.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCHS, get_config as jax_get_config
from repro.dist import partition as jax_partition
from repro.launch import steps as jax_steps
from repro.models.config import SHAPES
from repro_torch.configs import get_config
from repro_torch.dist import partition
from repro_torch.dist.partition import Spec
from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh
from repro_torch.models import model as M

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "model-only": ((16,), ("model",))}


class _ShapeOnly:
    """What the reference reads of a mesh: ``shape``, {axis: size}."""

    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))


@pytest.fixture(scope="module")
def meshes():
    """A fake process group of 512 ranks (one process stands for all) and
    the three meshes over it; the group is destroyed afterwards, so no
    later test in this worker finds one."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
    try:
        yield {name: (init_device_mesh("cpu", shape, mesh_dim_names=names),
                      _ShapeOnly(shape, names))
               for name, (shape, names) in MESHES.items()}
    finally:
        dist.destroy_process_group()
        assert not dist.is_initialized()


def _meta(shape):
    return torch.empty(tuple(shape), dtype=torch.float32, device="meta")


def _ref_specs(tree):
    """[(jax path string, PartitionSpec)] of a reference spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return [(jax.tree_util.keystr(p), s) for p, s in flat]


def _entry(e):
    """A dimension's placement; jax writes a one-axis tuple as the axis."""
    return e[0] if isinstance(e, tuple) and len(e) == 1 else e


def _port_specs(tree):
    """The ``Spec`` leaves of a port spec tree, in order (dict keys sorted as
    ``jax.tree`` sorts them), each entry as ``_entry`` writes it."""
    if isinstance(tree, Spec):
        return [tuple(_entry(e) for e in tree)]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _port_specs(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [s for v in tree for s in _port_specs(v)]
    return []


def _padded(spec, ndim):
    return tuple(_entry(e) for e in spec) + (None,) * (ndim - len(spec))


def _stacked_params(abstract):
    return jax.tree.map(lambda s: _meta(s.shape), abstract)


def _unstack_params(abstract):
    """The port's layout: each stacked segment entry a list of its repeats."""
    def entries(segs):
        return [[[jax.tree.map(lambda s: _meta(s.shape[1:]), entry)
                  for _ in range(jax.tree.leaves(entry)[0].shape[0])]
                 for entry in seg] for seg in segs]

    out = {k: jax.tree.map(lambda s: _meta(s.shape), v) for k, v in abstract.items()
           if k not in ("segments", "encoder")}
    out["segments"] = entries(abstract["segments"])
    if "encoder" in abstract:
        enc = abstract["encoder"]
        out["encoder"] = {k: jax.tree.map(lambda s: _meta(s.shape), v) for k, v in enc.items()
                          if k != "segments"}
        out["encoder"]["segments"] = entries(enc["segments"])
    return out


def _same(tree_abs, tree_want, tree_got):
    """Specs of one subtree that the two layouts share."""
    flat_want = jax.tree.leaves(tree_want, is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert _port_specs(tree_got) == [_padded(w, len(a.shape))
                                     for a, w in zip(jax.tree.leaves(tree_abs), flat_want)]


def _check_unstacked(abstract, want, got):
    """A port-layout spec tree ``got`` against the reference's ``want`` of
    the stacked tree ``abstract``: each repeat of a segment entry gets its
    stacked leaves' specs without the stacked entry, which no parameter
    rule places."""
    for key in abstract:
        if key == "encoder":
            _check_unstacked(abstract[key], want[key], got[key])
        elif key != "segments":
            _same(abstract[key], want[key], got[key])
            continue
        for s, seg in enumerate(abstract[key] if key == "segments" else []):
            for i, entry in enumerate(seg):
                tails = []
                for a, w in zip(jax.tree.leaves(entry), jax.tree.leaves(
                        want[key][s][i], is_leaf=lambda x: isinstance(x, PartitionSpec))):
                    w = _padded(w, len(a.shape))
                    assert w[0] is None, (s, i)
                    tails.append(w[1:])
                repeats = got[key][s][i]
                assert len(repeats) == jax.tree.leaves(entry)[0].shape[0]
                for repeat in repeats:
                    assert _port_specs(repeat) == tails, (s, i)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh_name", MESHES)
def test_param_specs_match_the_reference(meshes, arch, mesh_name):
    mesh, shape_only = meshes[mesh_name]
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    abstract = jax_steps.abstract_params(jcfg)
    want = jax_partition.param_specs(abstract, shape_only, jcfg)
    stacked = partition.param_specs(_stacked_params(abstract), mesh, cfg)
    assert _port_specs(stacked) == [_padded(w, len(a.shape)) for (_, w), a in zip(
        _ref_specs(want), jax.tree.leaves(abstract))]
    _check_unstacked(abstract, want, partition.param_specs(_unstack_params(abstract), mesh, cfg))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh_name", MESHES)
def test_batch_and_cache_specs_match_the_reference(meshes, arch, mesh_name):
    mesh, shape_only = meshes[mesh_name]
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    for shape in SHAPES.values():
        batch = jax_steps.input_specs(jcfg, shape)
        want = jax_partition.batch_specs(batch, shape_only, jcfg)
        got = partition.batch_specs({k: _meta(v.shape) for k, v in batch.items()}, mesh, cfg)
        assert got.keys() == want.keys()
        for k in batch:
            assert _port_specs(got[k]) == [_padded(want[k], len(batch[k].shape))], (shape.name, k)
    shape = SHAPES["decode_32k"]
    caches = jax_steps.abstract_caches(jcfg, shape)
    want = jax_partition.cache_specs(caches, shape_only, jcfg)
    # Each stacked cache (a registered pytree) as the tuple of its leaves;
    # the per-repeat layout a list of such tuples.
    stacked = [[tuple(_meta(x.shape) for x in jax.tree.leaves(c)) for c in seg] for seg in caches]
    per_repeat = [[[tuple(_meta(x.shape[1:]) for x in jax.tree.leaves(c))
                    for _ in range(jax.tree.leaves(c)[0].shape[0])] for c in seg]
                  for seg in caches]
    got_stacked = partition.cache_specs(stacked, mesh, cfg)
    got_repeats = partition.cache_specs(per_repeat, mesh, cfg)
    for s, seg in enumerate(caches):
        for i, c in enumerate(seg):
            shapes = [tuple(x.shape) for x in jax.tree.leaves(c)]
            specs = [_padded(w, len(x)) for w, x in zip(
                jax.tree.leaves(want[s][i], is_leaf=lambda x: isinstance(x, PartitionSpec)),
                shapes)]
            assert _port_specs(got_stacked[s][i]) == specs, (s, i)
            for repeat in got_repeats[s][i]:
                assert _port_specs(repeat) == [w[1:] for w in specs], (s, i)


def test_reference_shards_only_the_cache_layer_axis_of_three_archs(meshes):
    """What the per-repeat layout cannot carry: on 16 data ranks the
    reference's cache rule shards the stacked layer axis of the archs whose
    layer count 16 divides, and no other cache dimension of any arch."""
    _, shape_only = meshes["16x16"]
    sharded = set()
    for arch in ARCHS:
        jcfg = jax_get_config(arch)
        caches = jax_steps.abstract_caches(jcfg, SHAPES["decode_32k"])
        for spec in jax.tree.leaves(jax_partition.cache_specs(caches, shape_only, jcfg),
                                    is_leaf=lambda x: isinstance(x, PartitionSpec)):
            assert all(entry is None for entry in tuple(spec)[1:])
            if len(spec) and spec[0] is not None:
                sharded.add(arch)
    assert sharded == {"yi_9b", "starcoder2_7b", "qwen2_vl_72b"}


@pytest.mark.parametrize("arch", ARCHS)
def test_port_parameter_paths_land_on_the_same_leaves(meshes, arch):
    """The port's own parameter tree (reduced config, per-repeat layout, its
    own paths) gets the reference's specs of the reduced stacked tree."""
    mesh, shape_only = meshes["16x16"]
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    abstract = jax_steps.abstract_params(jcfg)
    want = jax_partition.param_specs(abstract, shape_only, jcfg)
    params = M.init_params(cfg, device="cpu")
    got = partition.param_specs(params, mesh, cfg)
    _check_unstacked(abstract, want, got)
    replicated = [s for s in _port_specs(got) if all(e is None for e in s)]
    assert replicated and len(replicated) < len(_port_specs(got))
    # The port's own caches (dataclasses a repeat, host positions): each
    # tensor's dimensions replicate, as the stacked leaf's trailing ones do;
    # a host value gets no spec.
    caches = M.init_caches(cfg, 16, 8, device="cpu")
    specs = partition.cache_specs(caches, mesh, cfg)
    for seg, seg_specs in zip(caches, specs):
        for entry, entry_specs in zip(seg, seg_specs):
            for cache, spec in zip(entry, entry_specs):
                for f in dataclasses.fields(cache):
                    value, got_f = getattr(cache, f.name), getattr(spec, f.name)
                    if isinstance(value, torch.Tensor):
                        assert got_f == (None,) * value.ndim, f.name
                    else:
                        assert got_f is None, f.name


def test_partition_replicates_on_mesh_without_data_axis(meshes):
    """A pure tensor-parallel mesh (no "data"/"pod" axis) must fall back to
    replication, never a spec naming an absent axis (the port of
    ``tests/test_substrate.py``'s test)."""
    mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("model",))
    data_axes, tp = partition.mesh_axes(mesh, cfg=None)
    assert data_axes == ()
    assert tp == "model"
    batch = {"tokens": _meta((4, 8)), "mrope_positions": _meta((3, 4, 8))}
    specs = partition.batch_specs(batch, mesh, cfg=None)
    assert all(all(e is None for e in s) for s in specs.values())
    out = partition.shardings(specs, mesh)
    assert all(sh.placements == (Replicate(),) for sh in out.values())


def test_shardings_place_each_mesh_dimension(meshes):
    mesh, _ = meshes["2x16x16"]
    specs = {"w": Spec((None, "model")), "tokens": Spec((("pod", "data"), None)),
             "mrope": Spec((None, ("pod", "data"), None)), "norm": Spec((None,))}
    out = partition.shardings(specs, mesh)
    assert out["w"].placements == (Replicate(), Replicate(), Shard(1))
    assert out["tokens"].placements == (Shard(0), Shard(0), Replicate())
    assert out["mrope"].placements == (Shard(1), Shard(1), Replicate())
    assert out["norm"].placements == (Replicate(),) * 3
    assert out["w"].mesh is mesh


def test_meshes_have_the_reference_axes(meshes):
    one = make_production_mesh(device="cpu")
    two = make_production_mesh(multi_pod=True, device="cpu")
    smoke = make_smoke_mesh(4, 2, device="cpu")
    assert (one.mesh_dim_names, tuple(one.shape)) == (("data", "model"), (16, 16))
    assert (two.mesh_dim_names, tuple(two.shape)) == (("pod", "data", "model"), (2, 16, 16))
    assert (smoke.mesh_dim_names, tuple(smoke.shape)) == (("data", "model"), (4, 2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_production_mesh()
    np.testing.assert_array_equal(np.asarray(one.mesh), np.arange(256).reshape(16, 16))
