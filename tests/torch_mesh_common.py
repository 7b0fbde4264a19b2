"""Helpers for the port's mesh tests on the CPU: process groups of several
ranks (``gloo``, one spawned process a rank, a ``FileStore`` under the
test's temporary directory so that no TCP port is shared between xdist
workers) and the placement of a tree of tensors on a ``DeviceMesh``.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import queue as queue_lib
import time
import traceback

import torch

JOIN_TIMEOUT_S = 240


def _worker(rank, world, store_path, fn, args, queue):
    import torch.distributed as dist

    try:
        torch.set_num_threads(1)
        store = dist.FileStore(store_path, world)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
        try:
            queue.put((rank, "ok", fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        queue.put((rank, "error", traceback.format_exc()))


def run_gloo(fn, tmp_path, world: int = 4, args: tuple = ()) -> list:
    """``fn(rank, world, *args)`` in ``world`` spawned processes joined in
    one gloo group; the results in rank order. A rank that raises fails
    the call with its traceback; one still running after
    ``JOIN_TIMEOUT_S`` is killed and fails it too."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    store = str(tmp_path / "gloo_store")
    procs = [ctx.Process(target=_worker, args=(r, world, store, fn, args, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        while len(results) < world and not errors:
            try:
                rank, status, value = queue.get(timeout=1.0)
            except queue_lib.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    errors.append(f"process {dead[0].pid} exited with {dead[0].exitcode}")
                elif time.monotonic() > deadline:
                    errors.append(f"no result within {JOIN_TIMEOUT_S} s")
                continue
            if status == "ok":
                results[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
    finally:
        for p in procs:
            p.join(timeout=10 if not errors else 1)
            if p.is_alive():
                p.kill()
                p.join()
                errors.append(f"process {p.pid} still running: killed")
    if errors:
        raise AssertionError("\n".join(errors))
    return [results[r] for r in range(world)]


def place(tree, shardings):
    """Each tensor of ``tree`` as a DTensor with its ``partition.Sharding``
    (every rank holds the same global tensor, so the local shards agree)."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, dict):
        return {k: place(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [place(v, s) for v, s in zip(tree, shardings)]
        return out if isinstance(tree, list) else tuple(out)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: place(getattr(tree, f.name), getattr(shardings, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, torch.Tensor) and shardings is not None:
        return distribute_tensor(tree, shardings.mesh, list(shardings.placements))
    return tree


def full(tree):
    """Every DTensor of ``tree`` gathered whole (``full_tensor``)."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: full(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [full(v) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    if isinstance(tree, DTensor):
        return tree.full_tensor()
    return tree
