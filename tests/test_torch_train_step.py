"""The port's gradients and train step against the JAX package's, on the CPU.

At reduced configs in float32, from one state (``params_from_jax`` and
``opt_state_from_jax``) and one numpy batch:

* ``torch.autograd.grad`` of ``loss_fn`` against ``jax.grad`` for qwen1.5,
  granite-moe and xlstm (its sLSTM blocks through the ``slstm_scan``
  Function's backward), leaf by leaf, with and without remat: 1e-4
  relative to each leaf's largest gradient;
* one ``make_train_step`` step against the reference's (new parameters,
  m, v, grad norm, lr; 1e-5), then three steps of the cosine schedule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as jax_steps
from repro.models import model as jax_model
from repro.models.layers import MeshCtx
from repro.optim import adamw as jax_adamw
from repro_torch._tree import leaves_with_path, unflatten
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as M
from repro_torch.models.convert import opt_state_from_jax, params_from_jax
from repro_torch.optim import adamw
from torch_train_common import TOL, close_trees as _close_trees, tokens as _tokens, tree as _tree

GRAD_REL = 1e-4
CTX = MeshCtx(mesh=None)
# Leaves whose gradient is exactly 0. An sLSTM block's input-gate bias adds
# one constant to every step's i, which the stabiliser m absorbs from a
# fresh state (m_0 = i_0 moves with it, and i', f' are differences from m):
# both packages return rounding noise there (~1e-10).
ZERO_GRADS = {"xlstm-125m": lambda path: path[-2:] == ("w_i", "b")}


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "granite-moe-1b-a400m", "xlstm-125m"])
def test_grad_matches_jax(name):
    jcfg, cfg, tree = _tree(name)
    tokens = _tokens(cfg, 12)
    jgrad = jax.jit(jax.grad(lambda p, t: jax_model.loss_fn(p, jcfg, CTX, {"tokens": t})))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(tokens))
    for remat in (False, True):
        params = params_from_jax(tree, cfg, device="cpu")
        flat = [p.requires_grad_(True) for _, p in leaves_with_path(params)]
        loss = M.loss_fn(params, cfg, {"tokens": tokens}, device="cpu", remat=remat)
        grads = torch.autograd.grad(loss, flat)
        _close_trees(unflatten(params, list(grads)), jax.tree.map(np.asarray, jgrad), cfg,
                     rel=GRAD_REL, zero=ZERO_GRADS.get(name, lambda path: False))


def _jax_state(tree, jcfg, opt):
    params = jax.tree.map(jnp.asarray, tree)
    return {"params": params, "opt": jax_adamw.init_opt_state(params, opt)}


def _port_state(tree, jstate, cfg):
    return {"params": params_from_jax(tree, cfg, device="cpu"),
            "opt": opt_state_from_jax(jax.tree.map(np.asarray, jstate["opt"]), cfg, device="cpu")}


def _close_state(state, jstate, cfg):
    _close_trees(state["params"], jax.tree.map(np.asarray, jstate["params"]), cfg)
    for key in ("m", "v"):
        _close_trees(state["opt"][key], jax.tree.map(np.asarray, jstate["opt"][key]), cfg)
    assert state["opt"]["step"].dtype == torch.int32
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"])


def test_train_step_matches_jax():
    jcfg, cfg, tree = _tree("qwen1.5-0.5b")
    opt = adamw.AdamWConfig()
    jopt = jax_adamw.AdamWConfig()
    tokens = _tokens(cfg, 12)
    jstate = _jax_state(tree, jcfg, jopt)
    state = _port_state(tree, jstate, cfg)
    jstep = jax.jit(jax_steps.make_train_step(jcfg, jopt))
    jstate, jmetrics = jstep(jstate, {"tokens": jnp.asarray(tokens)})
    state, metrics = make_train_step(cfg, opt, device="cpu")(state, {"tokens": tokens})
    assert set(metrics) == set(jmetrics) == {"loss", "grad_norm", "lr"}
    for key in metrics:
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), **TOL)
    _close_state(state, jstate, cfg)


def test_three_cosine_steps_match_jax():
    """The reference's step as its example writes it, with the schedule."""
    jcfg, cfg, tree = _tree("granite-moe-1b-a400m", seed=4)
    opt = adamw.AdamWConfig(lr=1e-3, weight_decay=0.01)
    jopt = jax_adamw.AdamWConfig(lr=1e-3, weight_decay=0.01)
    lr_fn = adamw.cosine_schedule(1e-3, warmup_steps=2, total_steps=3)
    jlr_fn = jax_adamw.cosine_schedule(1e-3, warmup_steps=2, total_steps=3)

    @jax.jit
    def jstep(state, batch):
        loss, grads = jax.value_and_grad(
            lambda p: jax_model.loss_fn(p, jcfg, CTX, batch))(state["params"])
        p, o, m = jax_adamw.adamw_update(state["params"], grads, state["opt"], jopt, jlr_fn)
        return {"params": p, "opt": o}, dict(m, loss=loss)

    jstate = _jax_state(tree, jcfg, jopt)
    state = _port_state(tree, jstate, cfg)
    step = make_train_step(cfg, opt, device="cpu", lr_fn=lr_fn, remat=True)
    for i in range(3):
        tokens = _tokens(cfg, 12, seed=10 + i)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        state, m = step(state, {"tokens": tokens})
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5, atol=1e-6)
    _close_state(state, jstate, cfg)


