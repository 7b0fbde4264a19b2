"""Parameters and caches of the JAX package, as numpy arrays, to the port's.

The counterpart of ``repro_torch.core.convert`` for the models: after
conversion both packages compute the same function (the tests hold the
port's ``prefill`` and ``decode_step`` against ``repro.models.model``'s).
The caller turns the JAX tree into numpy (``jax.tree.map(np.asarray, ...)``);
nothing here imports JAX. ``opt_state_from_jax`` carries the optimizer's
state across the same way, so both packages can train on from one state.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.attention import KVCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.mla import MLACache
from repro_torch.models.model import encoder_segments, segments_of
from repro_torch.models.rglru import RGLRUState
from repro_torch.models.xlstm import MLSTMState, SLSTMState

__all__ = ["caches_from_jax", "opt_state_from_jax", "params_from_jax"]


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
    repeat: ``params["segments"][s][i][r]``, and an encoder-decoder's
    ``params["encoder"]["segments"]`` the same way. Every other subtree (the
    embedding, ``lm_head``, the encoder's ``final_norm``, DeepSeek's ``mtp``
    head, which is one block and not stacked) is carried leaf for leaf.
    """
    dev = resolve_device(device)
    out = {k: _map(v, lambda a: _tensor(a, dev)) for k, v in tree.items()
           if k not in ("segments", "encoder")}
    out["segments"] = _unstack(tree["segments"], segments_of(cfg), dev, cfg.name)
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {k: _map(v, lambda a: _tensor(a, dev)) for k, v in enc.items()
                          if k != "segments"}
        out["encoder"]["segments"] = _unstack(enc["segments"], encoder_segments(cfg), dev,
                                              f"{cfg.name}'s encoder")
    return out


def opt_state_from_jax(state: dict, cfg: ModelConfig,
                       device: str | torch.device = "cuda") -> dict:
    """Convert ``repro.optim.adamw.init_opt_state``'s state (or a later
    one; leaves as numpy arrays): ``m`` and ``v`` as ``params_from_jax``
    converts the parameters (segments unstacked), ``step`` an int32 0-d
    tensor."""
    dev = resolve_device(device)
    return {"m": params_from_jax(state["m"], cfg, dev), "v": params_from_jax(state["v"], cfg, dev),
            "step": _tensor(np.asarray(state["step"], dtype=np.int32), dev)}


def _unstack(seg_trees: list, segs, dev: torch.device, what: str) -> list:
    """Stacked segments [segment][pattern entry] -> [segment][pattern entry][repeat]."""
    if len(seg_trees) != len(segs):
        raise ValueError(f"tree has {len(seg_trees)} segments, {what} has {len(segs)}")
    return [
        [[_map(stacked, lambda a, r=r: _tensor(np.asarray(a)[r], dev)) for r in range(reps)]
         for stacked in seg_tree]
        for seg_tree, (_pattern, reps) in zip(seg_trees, segs)
    ]


def caches_from_jax(caches: list, cfg: ModelConfig, device: str | torch.device = "cuda") -> list:
    """Convert ``repro.models.model.init_caches``' caches (leaves as numpy
    arrays, stacked over each segment's repeats) to the port's nesting
    [segment][pattern entry][repeat] of ``KVCache``, ``MLACache``,
    ``RGLRUState``, ``MLSTMState`` and ``SLSTMState``.

    The JAX classes are read by their fields: ``k``/``v``/``pos`` or
    ``latent``/``k_rope``/``pos`` (the stacked int32 ``pos`` becomes a host
    int), ``h``/``conv``, ``C``/``n``/``m`` or ``c``/``n``/``h``/``m``. The
    fields that only one class has decide: ``C`` (mLSTM), then ``c``
    (sLSTM), then ``conv`` (RG-LRU), then ``latent`` (MLA).
    """
    dev = resolve_device(device)

    def field(c, name, r):
        return _tensor(np.asarray(getattr(c, name))[r], dev)

    def one(c, r):
        if hasattr(c, "C"):
            return MLSTMState(**{f: field(c, f, r) for f in ("C", "n", "m")})
        if hasattr(c, "c"):
            return SLSTMState(**{f: field(c, f, r) for f in ("c", "n", "h", "m")})
        if hasattr(c, "conv"):
            return RGLRUState(h=field(c, "h", r), conv=field(c, "conv", r))
        pos = int(np.asarray(c.pos)[r])
        if hasattr(c, "latent"):
            return MLACache(latent=field(c, "latent", r), k_rope=field(c, "k_rope", r), pos=pos)
        return KVCache(k=field(c, "k", r), v=field(c, "v", r), pos=pos)

    return [[[one(c, r) for r in range(reps)] for c in seg]
            for seg, (_pattern, reps) in zip(caches, segments_of(cfg), strict=True)]
