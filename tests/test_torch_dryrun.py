"""The port's dry-run tooling against the JAX package's, on the CPU.

* ``input_specs``, ``abstract_params``, ``abstract_train_state`` and
  ``abstract_caches`` for every arch and shape: keys, shapes and types of
  the reference's ``jax.eval_shape`` stand-ins (a per-repeat leaf against
  its stacked leaf without the stacked axis; a cache's ``pos`` is a host
  int in the port, an int32 array in the reference, and is left out).
* Reduced dense, MoE and RG-LRU train cells on a 2 x 2 mesh: the port's
  ``prepare_cell`` traced under ``analyze_local`` over a fake group of 4
  ranks against the reference's ``_lower_train`` compiled on 4 host
  devices (one subprocess with ``--xla_force_host_platform_device_count=4``;
  the mesh's axes are ``Auto``: this JAX makes ``jax.make_mesh`` axes
  ``Explicit``, under which the reference's sharding constraints refuse to
  lower). Per-device argument bytes must equal the reference's
  ``memory_analysis().argument_size_in_bytes`` exactly, and per-device
  matmul FLOPs its ``analyze_hlo`` count within 1 %. The FLOPs run without
  remat: at these cells the reference's loop-aware count of its remat step
  equals its count without remat, while an eager remat step dispatches the
  recomputed forward and the port counts it (``launch.dryrun``'s docstring).
  Measured: dense +0.13 %, MoE +0.22 %, RG-LRU +0.08 % (the port's
  one-hot contraction of the loss on each vocabulary shard); no arch is off
  by more than 1 %.
* ``SKIP_LONG`` where the reference gives it; ``rank_collectives.rank``'s
  total equal to ``run_cell``'s collective bytes; ``run_cell`` leaves no
  process group behind; the port's ``roofline`` rows equal those of the
  reference's ``bench_roofline.py`` on the same JSON files (its
  ``DRYRUN_DIR`` monkeypatched; the time column is each one's own wall
  field).
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.launch import steps as jax_steps
from repro.models.config import SHAPES as JAX_SHAPES
from repro.optim import adamw as jax_adamw
from repro_torch import allow_meta
from repro_torch.configs import ARCHS, get_config, get_shape
from repro_torch.launch import dryrun, rank_collectives
from repro_torch.launch import steps
from repro_torch.models.config import ShapeConfig
from repro_torch.step_analysis import analyze_local

CELLS = {  # name: (arch, ShapeConfig fields)
    "dense": ("qwen1.5-0.5b", ("train_small", 64, 8, "train")),
    "moe": ("granite-moe-1b-a400m", ("train_small", 64, 8, "train")),
    "rglru": ("recurrentgemma-2b", ("train_small", 64, 8, "train")),
}
FLOPS_RTOL = 0.01

_REFERENCE = r"""
import json, sys
import jax
from repro.configs import get_config
from repro.launch.dryrun import SKIP_LONG, _lower_train
from repro.models.config import ShapeConfig
from repro.roofline import collective_bytes_from_hlo

mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {"SKIP_LONG": SKIP_LONG}
for name, (arch, fields) in json.loads(sys.argv[1]).items():
    comp = _lower_train(get_config(arch).reduced(), ShapeConfig(*fields), mesh).compile()
    out[name] = {"args": int(comp.memory_analysis().argument_size_in_bytes),
                 "flops": float(collective_bytes_from_hlo(comp.as_text())["matmul_flops"])}
print(json.dumps(out))
"""


def _jax_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype)) for p, x in flat}


def _port_leaves(tree, path=""):
    """{reference-style path: (shape, dtype)}: a per-repeat list is folded
    back to its stacked leaf (repeat count in front)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_port_leaves(v, f"{path}['{k}']"))
    elif isinstance(tree, list) and tree and _is_repeats(path):
        subs = [_port_leaves(v, path) for v in tree]
        for key, (shape, dt) in subs[0].items():
            assert all(s[key] == (shape, dt) for s in subs), key
            out[key] = ((len(tree),) + shape, dt)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_port_leaves(v, f"{path}[{i}]"))
    elif dataclasses.is_dataclass(tree):  # a cache: the reference flattens it by field order
        for i, f in enumerate(dataclasses.fields(tree)):
            out.update(_port_leaves(getattr(tree, f.name), f"{path}[<flat index {i}>]"))
    elif isinstance(tree, torch.Tensor):
        assert tree.device.type == "meta"
        out[path] = (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))
    return out


def _is_repeats(path):
    """A segment entry's repeats: ``...['segments'][s][i]`` (parameters,
    moments, the encoder's), or a cache tree's ``[s][i]``."""
    parts = path.replace("]", "").split("[")[1:]
    if "'segments'" in parts:
        return len(parts) == parts.index("'segments'") + 3
    return len(parts) == 2 and all(p.isdigit() for p in parts)


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_abstract_inputs_match_reference(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jp = _jax_leaves(jax_steps.abstract_params(jcfg))
    assert _port_leaves(steps.abstract_params(cfg)) == jp
    jopt = jax_adamw.AdamWConfig(state_dtype=jcfg.opt_state_dtype)
    js = _jax_leaves(jax_steps.abstract_train_state(jcfg, jopt))
    ps = _port_leaves(steps.abstract_train_state(cfg, dryrun.opt_config(cfg)))
    assert ps == js
    for name, jshape in JAX_SHAPES.items():
        shape = get_shape(name)
        assert _port_leaves(steps.input_specs(cfg, shape)) == _jax_leaves(
            jax_steps.input_specs(jcfg, jshape)), name
        jc = {k: v for k, v in _jax_leaves(jax_steps.abstract_caches(jcfg, jshape)).items()
              if v[1] != "int32"}  # the caches' pos counters
        assert _port_leaves(steps.abstract_caches(cfg, shape)) == jc, name


@pytest.fixture(scope="module")
def reference_cells(tmp_path_factory):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    done = subprocess.run([sys.executable, "-c", _REFERENCE, json.dumps(CELLS)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


@pytest.fixture
def fake_mesh():
    """A fake group of 4 ranks for one test (``run_cell`` makes its own and
    refuses to start beside another)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", sorted(CELLS))
def test_reduced_cell_matches_reference(name, reference_cells, fake_mesh):
    arch, fields = CELLS[name]
    with allow_meta():
        cell = dryrun.prepare_cell(get_config(arch).reduced(), ShapeConfig(*fields), fake_mesh,
                                   step_opts={"remat": False})
        costs, peak, _, _ = analyze_local(lambda: cell.fn(*cell.args))
    ref = reference_cells[name]
    assert dryrun._local_bytes(cell.args) == ref["args"]
    np.testing.assert_allclose(costs.matmul_flops, ref["flops"], rtol=FLOPS_RTOL)
    assert peak > 0 and costs.collective_bytes > 0


def test_skip_long_and_no_group_left(reference_cells):
    assert dryrun.SKIP_LONG == reference_cells["SKIP_LONG"]
    for arch in ARCHS:
        cfg = get_config(arch)
        if not cfg.is_sub_quadratic:
            res = dryrun.run_cell(arch, "long_500k", print_analysis=False)
            assert res == {"arch": arch, "shape": "long_500k", "skipped": dryrun.SKIP_LONG}
    assert not dist.is_initialized()


def test_rank_total_equals_run_cell(capsys):
    res = dryrun.run_cell("whisper-tiny", "decode_32k", print_analysis=False)
    items = rank_collectives.rank("whisper-tiny", "decode_32k")
    assert not dist.is_initialized()
    assert sum(b for b, *_ in items) == pytest.approx(res["collective_bytes_per_device"],
                                                      rel=1e-12)
    assert sum(n for _, _, n, _ in items) == sum(res["collective_counts"].values())
    out = capsys.readouterr().out
    assert out.splitlines()[0].startswith("TOTAL ")
    assert res["memory"]["argument_size_in_bytes"] > 0 and res["fits_80gb"] in (True, False)


def test_roofline_rows_match_bench_roofline(tmp_path, monkeypatch):
    """``bench_roofline.py`` and the port's rows over the same dry-run files
    (one made here, one skipped cell, one error): equal names and derived
    columns."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import benchmarks.bench_roofline as ref_roofline

    from repro_torch.paper import roofline

    res = dryrun.run_cell("whisper-tiny", "decode_32k", print_analysis=False)
    (tmp_path / "whisper-tiny_decode_32k_single.json").write_text(json.dumps(res))
    (tmp_path / "yi-9b_long_500k_single.json").write_text(json.dumps(
        {"arch": "yi-9b", "shape": "long_500k", "skipped": dryrun.SKIP_LONG}))
    (tmp_path / "xlstm-125m_train_4k_single.json").write_text(json.dumps(
        {"arch": "xlstm-125m", "shape": "train_4k", "mesh": "16x16", "error": "E: x"}))
    (tmp_path / "whisper-tiny_decode_32k_multi.json").write_text(json.dumps(res))
    rows = []
    monkeypatch.setattr(ref_roofline, "DRYRUN_DIR", tmp_path)
    monkeypatch.setattr(ref_roofline, "emit", lambda n, us, d: rows.append((n, d)))
    ref_roofline.main()
    monkeypatch.setattr(roofline, "DRYRUN_DIR", tmp_path)
    port = roofline.main(device="cpu")
    assert [(n, d) for n, _us, d in port] == rows
    assert len(rows) == 3


@pytest.mark.parametrize("arch,kind", [("recurrentgemma-2b", "train"),
                                       ("deepseek-v3-671b", "decode"),
                                       ("whisper-tiny", "decode")])
def test_depth_variants_equal_a_full_trace(arch, kind, fake_mesh):
    """``run_cell``'s shallow traces, weighed by ``depth_variants``, give
    the counts of the full-depth trace exactly: FLOPs, collective bytes and
    calls by kind, output bytes (5 layers of each reduced config, two dense
    ones in DeepSeek's, three encoder layers in Whisper's; remat on)."""
    cfg = get_config(arch).reduced()
    full_cfg = get_config(arch)
    cfg = dataclasses.replace(
        cfg, n_layers=5, block_pattern=full_cfg.resolved_block_pattern[:5]
        if full_cfg.block_pattern else (),
        n_dense_layers=2 if full_cfg.n_dense_layers else 0,
        encoder_layers=3 if cfg.is_encoder_decoder else 0)
    shape = ShapeConfig("small", 64, 8, kind)
    with allow_meta():
        full = dryrun.trace_cell(cfg, shape, fake_mesh)
        parts = [(w, dryrun.trace_cell(v, shape, fake_mesh))
                 for v, w in dryrun.depth_variants(cfg)]
    costs, _peak, _sites, out_bytes = dryrun._combine(parts)
    assert len(parts) >= 2
    assert costs.matmul_flops == full[0].matmul_flops
    assert costs.collective_bytes == full[0].collective_bytes
    assert costs.by_kind == full[0].by_kind
    assert costs.collective_counts == full[0].collective_counts
    assert out_bytes == full[3]


def test_meta_only_inside_allow_meta():
    """``"meta"`` resolves inside ``allow_meta()`` (the dry-run tooling)
    and nowhere else: the serving, training and trainer entry points keep
    refusing it."""
    from repro_torch import resolve_device
    from repro_torch.models import model as M

    cfg = get_config("qwen1.5-0.5b").reduced()
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    with allow_meta():
        assert resolve_device("meta").type == "meta"
        with allow_meta():
            pass
        assert resolve_device("meta").type == "meta"  # re-entrant
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        M.init_params(cfg, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        steps.make_train_step(cfg, None, device="meta")({}, {})
    assert all(t.device.type == "meta" and t.numel() > 0
               for t in jax.tree_util.tree_leaves(steps.abstract_params(cfg)))
