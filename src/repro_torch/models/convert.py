"""Parameters and caches of the JAX package, as numpy arrays, to the port's.

The counterpart of ``repro_torch.core.convert`` for the models: after
conversion both packages compute the same function (the tests hold the
port's ``prefill`` and ``decode_step`` against ``repro.models.model``'s).
The caller turns the JAX tree into numpy (``jax.tree.map(np.asarray, ...)``);
nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.attention import KVCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.mla import MLACache
from repro_torch.models.model import segments_of
from repro_torch.models.rglru import RGLRUState

__all__ = ["caches_from_jax", "params_from_jax"]


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy (JAX hands out read-only views)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: reinterpret the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(tree: dict, cfg: ModelConfig, device: str | torch.device = "cuda") -> dict:
    """Convert ``repro.models.model.init_params``' tree (leaves as numpy arrays).

    In the JAX tree each segment's blocks are stacked over a leading
    ``reps`` axis (``vmap`` over layer keys); the port keeps one dict per
    repeat: ``params["segments"][s][i][r]``. Every other subtree (the
    embedding, ``lm_head``, DeepSeek's ``mtp`` head, which is one block and
    not stacked) is carried leaf for leaf.
    """
    dev = resolve_device(device)
    out = {k: _map(v, lambda a: _tensor(a, dev)) for k, v in tree.items() if k != "segments"}
    segs = segments_of(cfg)
    if len(tree["segments"]) != len(segs):
        raise ValueError(f"tree has {len(tree['segments'])} segments, {cfg.name} has {len(segs)}")
    out["segments"] = [
        [[_map(stacked, lambda a, r=r: _tensor(np.asarray(a)[r], dev)) for r in range(reps)]
         for stacked in seg_tree]
        for seg_tree, (_pattern, reps) in zip(tree["segments"], segs)
    ]
    return out


def caches_from_jax(caches: list, cfg: ModelConfig, device: str | torch.device = "cuda") -> list:
    """Convert ``repro.models.model.init_caches``' caches (leaves as numpy
    arrays, stacked over each segment's repeats) to the port's nesting
    [segment][pattern entry][repeat] of ``KVCache``, ``MLACache`` and
    ``RGLRUState``.

    The JAX classes are read by their fields: ``k``/``v``/``pos`` or
    ``latent``/``k_rope``/``pos`` (the stacked int32 ``pos`` becomes a host
    int), or ``h``/``conv``.
    """
    dev = resolve_device(device)

    def one(c, r):
        if hasattr(c, "conv"):
            return RGLRUState(h=_tensor(np.asarray(c.h)[r], dev),
                              conv=_tensor(np.asarray(c.conv)[r], dev))
        if hasattr(c, "latent"):
            return MLACache(latent=_tensor(np.asarray(c.latent)[r], dev),
                            k_rope=_tensor(np.asarray(c.k_rope)[r], dev),
                            pos=int(np.asarray(c.pos)[r]))
        return KVCache(k=_tensor(np.asarray(c.k)[r], dev), v=_tensor(np.asarray(c.v)[r], dev),
                       pos=int(np.asarray(c.pos)[r]))

    return [[[one(c, r) for r in range(reps)] for c in seg]
            for seg, (_pattern, reps) in zip(caches, segments_of(cfg), strict=True)]
