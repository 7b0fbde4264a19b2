"""Dry-run of every (architecture x shape x mesh) cell over the production
mesh: the port of ``repro.launch.dryrun``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes] [--out DIR]

The reference lowers and compiles each cell against 256 or 512
placeholder host devices and reads the compiled artifact. PyTorch has no
compiler to ask, so a cell here is traced instead: a fake process group
of 256 or 512 ranks (one process stands for every rank) under the
production ``DeviceMesh`` (``launch.mesh``), the parameters, optimizer
state, batch and caches as meta DTensors (shapes and placements, no
storage) placed by ``dist.partition``, and the mesh-aware step of
``launch.steps`` run once under ``step_analysis.analyze_local``, which
counts what one rank runs. Per cell it records the reference's keys
(``dryrun.py``'s result dict), with what an eager trace has in place of
the compiler's fields:

* ``memory``: ``argument_size_in_bytes`` (the exact per-device bytes of
  the arguments' local shards), ``peak_live_bytes`` (the most bytes the
  step's own tensors held at once, per device, on top of the arguments),
  ``output_size_in_bytes`` (the new state, or the logits and caches) and
  ``temp_size_in_bytes`` (the peak less the outputs);
* ``trace_s`` (the wall of the traced step) replaces ``lower_s``,
  ``compile_s`` and ``xla_cost_analysis_flops``;
* ``fits_80gb``: arguments plus the peak within ``HBM_BYTES``;
* ``flops_per_device``: each product's FLOPs on its local operand shapes;
  ``collective_bytes_per_device`` and ``collectives`` / ``collective_counts``
  by kind, from the local shards;
* ``terms_s`` on ``roofline.H100_CONSTANTS``, ``dominant``,
  ``model_flops`` (6 N D) and ``useful_flops_ratio`` (6 N D over the
  counted FLOPs times the ranks).

Accounting figures, not timings: no kernel runs. The train step runs with
remat on (the reference config's default); a decode cell's step writes
position seq_len - 1 of caches that hold seq_len slots (the reference's
``pos0`` is traced; an eager step needs it as a number).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

from repro_torch import allow_meta
from repro_torch.configs import ARCHS, get_config, get_shape
from repro_torch.dist import partition
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig
from repro_torch.optim import adamw
from repro_torch.roofline import H100_CONSTANTS, model_flops, roofline_terms
from repro_torch.step_analysis import StepCosts, analyze_local

__all__ = ["HBM_BYTES", "OPT_STATE_DTYPE", "SKIP_LONG", "depth_variants", "main", "opt_config",
           "prepare_cell", "run_cell", "trace_cell"]

SKIP_LONG = ("long_500k requires sub-quadratic attention; skipped for pure "
             "full-attention archs (DESIGN.md)")
HBM_BYTES = 80 * 10 ** 9  # an H100's 80 GB, counted in decimal bytes
# Reference-config knobs that are not ``launch.steps.DIST_KNOBS``: the train
# step's remat flag and the optimizer state's type.
_STEP_KNOBS = ("remat", "opt_state_dtype")
# The reference configs that set one of them (the port's config describes
# the architecture only): the largest two keep bfloat16 moments.
OPT_STATE_DTYPE = {"deepseek-v3-671b": "bfloat16", "qwen2-vl-72b": "bfloat16"}


def opt_config(cfg: ModelConfig, step_opts: dict | None = None) -> adamw.AdamWConfig:
    """The AdamW config of ``cfg``'s train cells: the reference config's
    moment type unless ``step_opts`` overrides it."""
    dt = (step_opts or {}).get("opt_state_dtype", OPT_STATE_DTYPE.get(cfg.name, "float32"))
    return adamw.AdamWConfig(state_dtype=dt)


@dataclasses.dataclass
class Cell:
    """A cell ready to run: ``fn(*args)`` is the step on placed meta DTensors."""

    fn: object
    args: tuple


def _split(cfg: ModelConfig, overrides: dict | None):
    """(config with its own fields replaced, mesh knobs, step knobs)."""
    overrides = dict(overrides or {})
    mesh_opts = {k: overrides.pop(k) for k in list(overrides) if k in steps_lib.DIST_KNOBS}
    step_opts = {k: overrides.pop(k) for k in list(overrides) if k in _STEP_KNOBS}
    return dataclasses.replace(cfg, **overrides), mesh_opts, step_opts


def _placed(t: torch.Tensor, sharding):
    """A meta DTensor of ``t``'s global shape: its local shard made
    directly (every placed dimension divides its mesh axes)."""
    from torch.distributed.tensor import DTensor, Shard

    local = list(t.shape)
    for size, pl in zip(sharding.mesh.shape, sharding.placements):
        if isinstance(pl, Shard):
            local[pl.dim] //= size
    return DTensor.from_local(torch.empty(local, dtype=t.dtype, device="meta"), sharding.mesh,
                              list(sharding.placements), run_check=False,
                              shape=t.shape, stride=t.stride())


def _place(tree, shardings):
    """Each meta tensor of ``tree`` as a DTensor with its sharding (local
    shards made on meta: nothing is allocated or sent)."""

    if isinstance(tree, dict):
        return {k: _place(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_place(v, s) for v, s in zip(tree, shardings)]
        return out if isinstance(tree, list) else tuple(out)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _place(getattr(tree, f.name), getattr(shardings, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, torch.Tensor) and shardings is not None:
        return _placed(tree, shardings)
    return tree


def _local_bytes(tree) -> int:
    """Bytes of the local shards of every tensor in ``tree``."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return sum(_local_bytes(getattr(tree, f.name)) for f in dataclasses.fields(tree))
    if isinstance(tree, DTensor):
        tree = tree.to_local()
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def _set_pos(caches, pos: int):
    """Every attention cache's ``pos`` set to ``pos`` (a decode cell's history)."""
    if isinstance(caches, list):
        return [_set_pos(c, pos) for c in caches]
    if dataclasses.is_dataclass(caches) and hasattr(caches, "pos"):
        return dataclasses.replace(caches, pos=pos)
    return caches


def prepare_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, mesh_opts=None,
                 step_opts=None) -> Cell:
    """The mesh-aware step of ``cfg`` x ``shape`` on ``mesh``, with its
    placed abstract arguments (inside ``allow_meta()``)."""
    step_opts = dict(step_opts or {})
    batch = steps_lib.input_specs(cfg, shape)
    if shape.is_decode:
        batch["pos0"] = shape.seq_len - 1
    batch = _place(batch, partition.shardings(partition.batch_specs(batch, mesh, cfg), mesh))
    if shape.kind == "train":
        opt_cfg = opt_config(cfg, step_opts)
        state = steps_lib.abstract_train_state(cfg, opt_cfg)
        pspecs = partition.param_specs(state["params"], mesh, cfg)
        specs = {"params": pspecs, "opt": {"m": pspecs, "v": pspecs,
                                           "step": partition.Spec(())}}
        state = _place(state, partition.shardings(specs, mesh))
        fn = steps_lib.make_train_step(cfg, opt_cfg, device="meta",
                                       remat=step_opts.get("remat", True), mesh=mesh,
                                       mesh_opts=mesh_opts)
        return Cell(fn, (state, batch))
    params = steps_lib.abstract_params(cfg)
    params = _place(params, partition.shardings(partition.param_specs(params, mesh, cfg), mesh))
    caches = steps_lib.abstract_caches(cfg, shape)
    caches = _place(caches, partition.shardings(partition.cache_specs(caches, mesh, cfg), mesh))
    if shape.is_decode:
        caches = _set_pos(caches, shape.seq_len - 1)
    fn = steps_lib.make_serve_step(cfg, kind="decode" if shape.is_decode else "prefill",
                                   device="meta", mesh=mesh, mesh_opts=mesh_opts)
    return Cell(fn, (params, batch, caches))


class fake_group:
    """A fake process group of ``world`` ranks (one process stands for
    all) as the default group for the block, destroyed after it; refuses
    to start where a default group exists already."""

    def __init__(self, world: int):
        self.world = world

    def __enter__(self):
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore

        if dist.is_initialized():
            raise RuntimeError("a default process group exists already; the dry-run "
                               "makes its own fake one")
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=self.world)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.destroy_process_group()
        _clear_dtensor_caches()
        return False


def _clear_dtensor_caches() -> None:
    """Forget DTensor's cached plans: they key on meshes by value and keep
    the mesh they were made for, so a later group's equal mesh would reach
    this group's destroyed communicators (torch 2.11 does)."""
    from torch.distributed.tensor import DTensor, _collective_utils, _redistribute

    prop = DTensor._op_dispatcher.sharding_propagator
    for cached in (getattr(prop, "propagate_op_sharding", None),
                   getattr(type(prop), "_propagate_tensor_meta_cached", None),
                   getattr(_redistribute, "_gen_transform_infos", None),
                   getattr(getattr(_collective_utils, "MeshTopoInfo", None), "build_from_mesh",
                           None)):
        for clear in (getattr(cached, "cache_clear", None),
                      getattr(getattr(cached, "cache", None), "cache_clear", None)):
            if clear is not None:
                clear()


def depth_variants(cfg: ModelConfig) -> list:
    """[(config, weight)]: shallow configs whose weighted sum of per-device
    counts is the full config's. A block's costs depend on its signature
    alone (``model.Signature``: kind, experts, cross-attention), and the
    eager step runs every block, so the counts are a constant plus one
    term a block: tracing a base with one block of each signature (dense
    ones first, as ``n_dense_layers`` orders them; one encoder block) and,
    for each signature, the base with one more, gives each block's term;
    each is weighed by how many more blocks of it the full config has.
    This is the eager counterpart of the reference's trip-count weighting
    of a scanned body."""
    from repro_torch.models.model import _layer_signatures

    sigs = _layer_signatures(cfg)
    kinds = list(dict.fromkeys(sigs))
    kinds.sort(key=lambda k: k.moe)  # dense blocks before the first MoE one

    def build(extra=None, encoder=1):
        layers = [k for k in kinds for _ in range(1 + (k == extra))]
        return dataclasses.replace(
            cfg, n_layers=len(layers), block_pattern=tuple(k.kind for k in layers),
            n_dense_layers=sum(not k.moe for k in layers) if cfg.is_moe else 0,
            encoder_layers=encoder if cfg.is_encoder_decoder else cfg.encoder_layers)

    variants = [(build(extra=k), sigs.count(k) - 1) for k in kinds if sigs.count(k) > 1]
    if cfg.is_encoder_decoder and cfg.encoder_layers > 1:
        variants.append((build(encoder=2), cfg.encoder_layers - 1))
    return [(build(), 1 - sum(w for _, w in variants))] + variants


def _combine(parts):
    """[(weight, trace_cell's result)] of ``depth_variants`` -> (costs,
    peak, sites, output bytes). Counts, sites and output bytes are the
    weighted sums. The peak is an estimate: the base's peak (the first
    part) plus, for each further block, the bytes it keeps for the
    backward (or holds at the end of a serving step), from the variants'
    differences."""
    costs, sites, out_bytes = StepCosts(), {}, 0.0
    _, (_, base_peak, _, _, base_held) = parts[0]
    peak = base_peak
    for i, (w, (c, pk, st, ob, held)) in enumerate(parts):
        costs.add(c, w)
        out_bytes += w * ob
        if i:
            peak += w * (held - base_held)
        for key, (b, n) in st.items():
            entry = sites.setdefault(key, [0.0, 0])
            entry[0] += w * b
            entry[1] += w * n
    return costs, peak, {k: v for k, v in sites.items() if v[1]}, out_bytes


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, mesh_opts=None, step_opts=None,
               site=None):
    """(costs, peak live bytes, collective sites, output bytes, bytes held
    for the backward) of one traced step of ``cfg`` (inside
    ``allow_meta()``)."""
    from torch.utils.checkpoint import set_checkpoint_early_stop

    cell = prepare_cell(cfg, shape, mesh, mesh_opts, step_opts)
    outs = []
    # A remat repeat recomputes its whole forward, as JAX's checkpoint of a
    # scan body does: then every block costs the same wherever its repeat
    # ends, which ``depth_variants`` relies on.
    with set_checkpoint_early_stop(False):
        costs, peak, sites, held = analyze_local(lambda: outs.append(cell.fn(*cell.args)),
                                                 site=site)
    return costs, peak, sites, _local_bytes(outs), held


def run_cell(arch: str, shape_name: str, multi_pod: bool = False, print_analysis: bool = True,
             overrides: dict | None = None, site=None) -> dict:
    """One cell's record (module docstring): the arguments' bytes of the
    full config, the traced counts of its ``depth_variants``. ``site``: see
    ``step_analysis.analyze_local`` (``rank_collectives`` passes one); the
    record then carries ``sites``."""
    cfg, mesh_opts, step_opts = _split(get_config(arch), overrides)
    shape = get_shape(shape_name)
    if shape_name == "long_500k" and not cfg.is_sub_quadratic:
        return {"arch": arch, "shape": shape_name, "skipped": SKIP_LONG}
    n_chips = 512 if multi_pod else 256
    with fake_group(n_chips), allow_meta():
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        t0 = time.perf_counter()
        arg_bytes = _local_bytes(prepare_cell(cfg, shape, mesh, mesh_opts, step_opts).args)
        variants = depth_variants(cfg)
        costs, peak, sites, out_bytes = _combine(
            [(w, trace_cell(v, shape, mesh, mesh_opts, step_opts, site)) for v, w in variants])
        trace_s = time.perf_counter() - t0
    temp = max(peak - out_bytes, 0.0)
    mem = {"argument_size_in_bytes": arg_bytes, "output_size_in_bytes": out_bytes,
           "temp_size_in_bytes": temp, "peak_live_bytes": peak}
    flops = float(costs.matmul_flops)
    bytes_per_dev = float(arg_bytes + out_bytes + 2 * temp)
    terms = roofline_terms(flops_per_dev=flops, bytes_per_dev=bytes_per_dev,
                           coll_bytes_per_dev=costs.collective_bytes, constants=H100_CONSTANTS)
    mf = model_flops(cfg, shape)
    result = {
        "arch": arch,
        "shape": shape_name,
        "overrides": {k: str(v) for k, v in (overrides or {}).items()},
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_chips": n_chips,
        "trace_s": trace_s,
        "traced_depths": [v.n_layers for v, _ in variants],
        "memory": mem,
        "fits_80gb": arg_bytes + peak <= HBM_BYTES,
        "flops_per_device": flops,
        "bytes_per_device": bytes_per_dev,
        "touched_bytes_per_device": float(costs.touched_bytes),
        "collective_bytes_per_device": float(costs.collective_bytes),
        "collectives": dict(costs.by_kind),
        "collective_counts": dict(costs.collective_counts),
        "terms_s": terms,
        "dominant": max(terms, key=terms.get),
        "model_flops": mf,
        "useful_flops_ratio": mf / (flops * n_chips) if flops else 0.0,
    }
    if site is not None:
        result["sites"] = sites
    if print_analysis:
        print(f"== {arch} x {shape_name} on {result['mesh']} ==")
        print(json.dumps({k: result[k] for k in ("memory", "fits_80gb", "terms_s", "dominant",
                                                 "useful_flops_ratio",
                                                 "collective_bytes_per_device", "trace_s")},
                         indent=2))
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--sp", action="store_true",
                    help="sequence-parallel activations (hillclimb config)")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    overrides = {"sequence_parallel": True} if args.sp else None

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        cells = [(args.arch, args.shape)]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    for arch, shape_name in cells:
        for mp in meshes:
            tag = f"{arch}_{shape_name}_{'multi' if mp else 'single'}"
            if args.sp:
                tag += "_sp"
            path = out_dir / f"{tag}.json"
            if path.exists():
                print(f"-- {tag}: cached")
                continue
            if len(cells) * len(meshes) > 1:
                # One process a cell: no state of one cell's process group
                # (DTensor's plans keep theirs) reaches the next.
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                       "--shape", shape_name, "--out", str(out_dir)]
                cmd += (["--multi-pod"] if mp else []) + (["--sp"] if args.sp else [])
                if subprocess.run(cmd).returncode != 0:
                    failures.append(tag)
                continue
            try:
                res = run_cell(arch, shape_name, multi_pod=mp, overrides=overrides)
            except Exception as e:
                traceback.print_exc()
                failures.append(tag)
                res = {"arch": arch, "shape": shape_name,
                       "mesh": "2x16x16" if mp else "16x16",
                       "error": f"{type(e).__name__}: {e}"}
            path.write_text(json.dumps(res, indent=2, default=float))
    if failures:
        print("FAILURES:", failures)
        raise SystemExit(1)
    print("dry-run complete")


if __name__ == "__main__":
    main()
