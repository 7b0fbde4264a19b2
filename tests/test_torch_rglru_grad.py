"""B5's backward and RG-LRU training against the JAX package, on the CPU.

* ``rglru_scan_bwd_ref`` (the plain version of the ``rglru_scan_bwd``
  kernel) and ``ops.rglru_scan``'s autograd route against ``jax.grad``
  through the reference's ``_lru_scan`` (``repro/models/rglru.py``, an
  associative scan), float32, atol = rtol = 1e-5, the scan tolerance of
  ``tests/test_kernels.py``: the associative scan's tree order and the
  loop's order differ by rounding only.
* recurrentgemma-2b's reduced ``loss_fn`` gradients (RG-LRU and local
  attention blocks, with and without remat) against ``jax.grad`` of
  ``repro.models.model.loss_fn`` from ``params_from_jax`` weights: 1e-4
  relative to each leaf's largest gradient, the tolerance of
  ``tests/test_torch_train_step.py`` (the same rounding through a deeper
  chain of products).
* Under remat, one backward runs B5's forward twice a recurrent block (the
  forward and the recompute) and its backward once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as jax_model
from repro.models import rglru as jax_rglru
from repro.models.layers import MeshCtx
from repro_torch._tree import leaves, leaves_with_path, unflatten
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.kernels.rglru_scan.ref import rglru_scan_bwd_ref, rglru_scan_ref
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax
from torch_train_common import close_trees, tokens as _tokens, tree as _tree

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_REL = 1e-4
CTX = MeshCtx(mesh=None)
# tests/test_kernels.py:47's sweep, one step, and a width off the warp.
SHAPES = [(2, 512, 256), (3, 100, 64), (1, 37, 128), (2, 1, 37), (5, 17, 37)]


def _inputs(seed, B, S, W):
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, W))))).astype(np.float32)
    b = rng.standard_normal((B, S, W)).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    g = rng.standard_normal((B, S, W)).astype(np.float32)
    return a, b, h0, g


def _jax_grads(a, b, h0, g):
    loss = lambda a, b, h0: jnp.sum(jax_rglru._lru_scan(a, b, h0) * g)  # noqa: E731
    return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(jnp.asarray(a), jnp.asarray(b),
                                                     jnp.asarray(h0))


@pytest.mark.parametrize("fn", ["plain", "autograd"])
@pytest.mark.parametrize("B,S,W", SHAPES)
def test_scan_backward_matches_jax_grad(B, S, W, fn):
    a, b, h0, g = _inputs(B * S + W, B, S, W)
    want = _jax_grads(a, b, h0, g)
    at, bt, h0t, gt = (torch.from_numpy(x) for x in (a, b, h0, g))
    before = dict(scan_ops.LAUNCHES)
    if fn == "plain":
        got = rglru_scan_bwd_ref(gt, at, rglru_scan_ref(at, bt, h0t), h0t)
    else:
        inputs = [x.clone().requires_grad_(True) for x in (at, bt, h0t)]
        got = torch.autograd.grad(scan_ops.rglru_scan(*inputs), inputs, gt)
    assert scan_ops.LAUNCHES == before  # the CPU path launches nothing
    for name, x, w in zip(("da", "db", "dh0"), got, want):
        assert x.dtype == torch.float32 and x.shape == w.shape, name
        np.testing.assert_allclose(x.numpy(), np.asarray(w), err_msg=name, **TOL)


def test_scan_backward_only_where_asked():
    """Gradients only for the inputs that require them; a bfloat16 scan
    under autograd is refused by name; the wrapper's backward checks its
    inputs."""
    a, b, h0, g = (torch.from_numpy(x) for x in _inputs(9, 2, 12, 8))
    bt = b.clone().requires_grad_(True)
    (db,) = torch.autograd.grad(scan_ops.rglru_scan(a, bt, h0), (bt,), g)
    want = rglru_scan_bwd_ref(g, a, rglru_scan_ref(a, b, h0), h0)[1]
    assert torch.equal(db, want)
    with pytest.raises(TypeError, match="float32"):
        scan_ops.rglru_scan(a.bfloat16().requires_grad_(True), b.bfloat16(), h0)
    with torch.no_grad():  # no grad mode: bfloat16 runs as before
        assert scan_ops.rglru_scan(a.bfloat16().requires_grad_(True), b.bfloat16(),
                                   h0).dtype == torch.bfloat16
    with pytest.raises(TypeError, match="float32"):
        scan_ops.rglru_scan_bwd(g.double(), a, b, h0)
    with pytest.raises(ValueError, match="h0"):
        scan_ops.rglru_scan_bwd(g, a, b, h0[:1])
    da, db, dh0 = scan_ops.rglru_scan_bwd(g, a, b, h0, grad_h0=False)
    assert dh0 is None and da.shape == db.shape == a.shape


@pytest.mark.parametrize("remat", [False, True])
def test_recurrentgemma_grad_matches_jax(remat):
    jcfg, cfg, tree = _tree("recurrentgemma-2b")
    tokens = _tokens(cfg, 40)
    jgrad = jax.jit(jax.grad(lambda p, t: jax_model.loss_fn(p, jcfg, CTX, {"tokens": t})))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(tokens))
    params = params_from_jax(tree, cfg, device="cpu")
    flat = [p.requires_grad_(True) for _, p in leaves_with_path(params)]
    loss = M.loss_fn(params, cfg, {"tokens": tokens}, device="cpu", remat=remat)
    grads = torch.autograd.grad(loss, flat)
    close_trees(unflatten(params, list(grads)), jax.tree.map(np.asarray, jgrad), cfg,
                rel=GRAD_REL)


def test_remat_runs_the_scan_twice_and_its_backward_once(monkeypatch):
    """The count that ``chip_smoke.py`` checks on the card: with remat, each
    recurrent block's scan runs in the forward and again in the recompute,
    its backward once; without remat, once each."""
    jcfg, cfg, tree = _tree("recurrentgemma-2b")
    n_rec = cfg.resolved_block_pattern.count("rglru")
    calls = {"fwd": 0, "bwd": 0}

    def counted(key, fn):
        def run(*args):
            calls[key] += 1
            return fn(*args)
        return run

    monkeypatch.setattr(scan_ops, "rglru_scan_ref", counted("fwd", rglru_scan_ref))
    monkeypatch.setattr(scan_ops, "rglru_scan_bwd_ref", counted("bwd", rglru_scan_bwd_ref))
    params = params_from_jax(tree, cfg, device="cpu")
    flat = [p.requires_grad_(True) for p in leaves(params)]
    for remat, want in ((False, (n_rec, n_rec)), (True, (2 * n_rec, n_rec))):
        calls.update(fwd=0, bwd=0)
        loss = M.loss_fn(params, cfg, {"tokens": _tokens(cfg, 24)}, device="cpu", remat=remat)
        torch.autograd.grad(loss, flat)
        assert (calls["fwd"], calls["bwd"]) == want, remat
