"""The sLSTM recurrence's gradient on the CPU: ``ops._SLSTMScan``, whose
backward there is ``ref.slstm_scan_bwd_ref`` (the backward kernel's CPU
twin, a reverse loop written out by hand), against autograd through the
plain loop and against ``jax.grad`` of the JAX package.

Every input is drawn from a numpy seed. Tolerance: ``TOL`` of
``torch_train_common`` (atol = rtol = 1e-5, float32), for every gradient:

* the Function's gradients of the gates, ``rw`` and the entering state
  against autograd of ``slstm_scan_ref``, at (B, S, d) = (1, 1, 8), (2, 5,
  16) and (3, 37, 64), from a fresh state and from the state a 7-step
  prompt left, every output's gradient given;
* ``slstm_block(train=True)``'s gradients of the block's parameters, x and
  the entering state against ``jax.grad`` of ``repro.models.xlstm.
  slstm_block`` at xlstm-125m's reduced config (d_model 64), the
  parameters carried across by ``params_from_jax``;
* the edges: an exact tie in max(log_f + m, i) (autograd splits it half
  and half, as the twin does); step 0 from a fresh state, where n == 1
  exactly and the reference splits max(n, 1)'s tie while the port gives it
  all to n (the two differ by rounding only: that gradient reaches only i'
  = exp(i - m') with m' = i, whose two paths into i cancel); a NaN in one
  gate (NaN exactly where autograd has NaN); S = 1, and B = 9, not a
  multiple of the cluster layout's 8 rows.

Nothing here launches a kernel: the card's backward is held to the same
twin by ``tests/test_torch_slstm_scan_cuda.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import xlstm as jax_xlstm
from repro.models.layers import MeshCtx
from repro_torch.kernels.slstm_scan import ops as slstm_ops
from repro_torch.kernels.slstm_scan.ref import slstm_scan_ref
from repro_torch.models import xlstm
from repro_torch.models.convert import params_from_jax
from torch_train_common import TOL, tree

CTX = MeshCtx(mesh=None)
NO_LAUNCH = {"slstm_scan": 0, "slstm_scan_bwd": 0, "slstm_scan_bwd_rest": 0}
STATE = ("c", "n", "h", "m")


def _normal(rng, *shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))


def _fresh(B, d):
    return [torch.zeros(B, d) for _ in range(3)] + [torch.full((B, d), -1e30)]


def _scan_inputs(B, S, d, start, seed):
    """Gates N(0, 1), rw N(0, 1/d), and a fresh entering state or the one a
    7-step prompt left."""
    rng = np.random.default_rng(seed)
    gates = [_normal(rng, B, S, d) for _ in range(4)]
    rw = _normal(rng, d, d, scale=d ** -0.5)
    state = _fresh(B, d)
    if start == "prompt":
        with torch.no_grad():
            state = list(slstm_scan_ref(*[_normal(rng, B, 7, d) for _ in range(4)], rw,
                                        *state)[1:])
    return gates + [rw] + state


def _cotangents(B, S, d, seed):
    rng = np.random.default_rng(seed)
    return [_normal(rng, B, S, d)] + [_normal(rng, B, d) for _ in range(4)]


def _grads(fn, args, cot):
    leaves = [t.clone().requires_grad_(True) for t in args]
    return torch.autograd.grad(fn(*leaves), leaves, cot)


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


def _twin_against_autograd(args, cot):
    slstm_ops.reset_launches()
    got = _grads(slstm_ops.slstm_scan, args, cot)
    assert slstm_ops.LAUNCHES == NO_LAUNCH
    return got, _grads(slstm_scan_ref, args, cot)


@pytest.mark.parametrize("start", ["fresh", "prompt"])
@pytest.mark.parametrize("B,S,d", [(1, 1, 8), (2, 5, 16), (3, 37, 64)])
def test_function_backward_matches_autograd_of_the_plain_loop(B, S, d, start):
    """The gates', rw's and the entering state's gradients (nine tensors)."""
    got, want = _twin_against_autograd(_scan_inputs(B, S, d, start, seed=S),
                                       _cotangents(B, S, d, seed=100 + S))
    assert len(got) == 9
    _close(got, want)


@pytest.fixture(scope="module")
def block():
    """The reduced xlstm-125m's sLSTM block: the reference's parameters
    (numpy) and the port's, carried across by ``params_from_jax``."""
    jcfg, cfg, np_tree = tree("xlstm-125m")
    kinds = cfg.resolved_block_pattern
    assert kinds[:2] == ("mlstm", "slstm")
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), np_tree["segments"][0][1]["cell"])
    tp = params_from_jax(np_tree, cfg, device="cpu")["segments"][0][1][0]["cell"]
    return jcfg, cfg, jp, tp


def _block_grads(block, S, start, seed):
    """(port grads, reference grads) of sum(y * cy) (+ the new state's
    against its cotangents where a state enters), with respect to every
    parameter, x and the entering state."""
    jcfg, cfg, jp, tp = block
    B, d = 2, cfg.d_model
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    cy = rng.standard_normal((B, S, d)).astype(np.float32)
    jstate = None
    if start == "prompt":
        _, jstate = jax_xlstm.slstm_block(
            jp, jnp.asarray(rng.standard_normal((B, 12, d)), jnp.float32), CTX, jcfg,
            state=jax_xlstm.init_slstm_state(B, jcfg, jnp.float32))
    cs = {k: rng.standard_normal((B, d)).astype(np.float32) for k in STATE}

    def jloss(p, x, st=None):
        y, new = jax_xlstm.slstm_block(p, x, CTX, jcfg, state=st)
        total = jnp.sum(y * cy)
        if new is not None:
            total += sum(jnp.sum(getattr(new, k) * cs[k]) for k in STATE)
        return total

    jg = jax.grad(jloss, argnums=(0, 1, 2) if jstate is not None else (0, 1))(
        jp, jnp.asarray(x), *(() if jstate is None else (jstate,)))
    want = [np.asarray(leaf) for leaf in jax.tree.leaves(jg[0])] + [np.asarray(jg[1])]
    if jstate is not None:
        want += [np.asarray(getattr(jg[2], k)) for k in STATE]

    leaves, treedef = jax.tree.flatten(jax.tree.map(lambda t: t.clone(), tp))
    for t in leaves:
        t.requires_grad_(True)
    params = jax.tree.unflatten(treedef, leaves)
    tx = torch.from_numpy(x).requires_grad_(True)
    wrt = leaves + [tx]
    state = None
    if jstate is not None:
        state = xlstm.SLSTMState(**{k: torch.from_numpy(np.array(getattr(jstate, k)))
                                    .requires_grad_(True) for k in STATE})
        wrt += [getattr(state, k) for k in STATE]
    slstm_ops.reset_launches()
    y, new = xlstm.slstm_block(params, tx, cfg, state=state, train=True)
    total = (y * torch.from_numpy(cy)).sum()
    if new is not None:
        total = total + sum((getattr(new, k) * torch.from_numpy(cs[k])).sum() for k in STATE)
    got = torch.autograd.grad(total, wrt)
    assert slstm_ops.LAUNCHES == NO_LAUNCH
    return got, want


@pytest.mark.parametrize("S,start", [(12, "fresh"), (12, "prompt"), (40, "prompt")])
def test_block_gradients_match_jax(block, S, start):
    """Every parameter of the block (w_z, w_i, w_f, w_o with biases, r_z,
    w_out), x and, from a prompt's state, the entering state."""
    got, want = _block_grads(block, S, start, seed=S)
    assert len(got) == len(want) == 11 + (4 if start == "prompt" else 0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


def test_step_zero_from_a_fresh_state_matches_the_reference(block):
    """S = 1 from a fresh state: n sits on max(n, 1)'s tie (n == 1 exactly),
    which the reference splits and the port gives all to n; the gradients
    agree within the tolerance all the same."""
    jcfg, cfg, jp, tp = block
    B, d = 2, cfg.d_model
    x = np.random.default_rng(1).standard_normal((B, 1, d)).astype(np.float32)
    with torch.no_grad():
        gates = [xlstm.dense(tp[w], torch.from_numpy(x)).float()
                 for w in ("w_z", "w_i", "w_f", "w_o")]
        n = slstm_scan_ref(*gates, tp["r_z"]["w"], *_fresh(B, d))[2]
    assert bool((n == 1.0).all())
    got, want = _block_grads(block, 1, "fresh", seed=1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


def test_an_exact_tie_in_the_stabiliser_max():
    """ix_t set to log_sigmoid(fx_t) + m_{t-1} in the plain loop's own float32
    arithmetic, at (0, 3, 5) and in all of row 1 at step 4: both sides of
    max(lf + m, i) equal, and the twin splits the gradient as autograd
    does."""
    B, S, d = 2, 6, 16
    args = _scan_inputs(B, S, d, "prompt", seed=7)
    ix, fx = args[1], args[2]
    with torch.no_grad():
        m = slstm_scan_ref(*args, save=True)[7]
        lf = F.logsigmoid(fx)
        ix[0, 3, 5] = lf[0, 3, 5] + m[0, 2, 5]
        # ix changes m from step 3 on in column 5: step 4's tie uses the new m.
        m = slstm_scan_ref(*args, save=True)[7]
        ix[1, 4] = lf[1, 4] + m[1, 3]
        m = slstm_scan_ref(*args, save=True)[7]
    ties = (lf[:, 1:] + m[:, :-1] == ix[:, 1:])
    assert bool(ties[0, 2, 5]) and bool(ties[1, 3].all())
    got, want = _twin_against_autograd(args, _cotangents(B, S, d, seed=8))
    _close(got, want)


def test_a_nan_in_one_gate():
    """A forget-gate pre-activation NaN: the twin's gradients are NaN
    exactly where autograd's are, and within the tolerance elsewhere."""
    args = _scan_inputs(2, 6, 100, "fresh", seed=9)
    args[2][1, 2, 7] = float("nan")
    got, want = _twin_against_autograd(args, _cotangents(2, 6, 100, seed=10))
    assert bool(torch.isnan(want[0]).any()) and not bool(torch.isnan(want[0][0]).any())
    for g, w in zip(got, want):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        np.testing.assert_allclose(g.numpy(), w.numpy(), equal_nan=True, **TOL)


@pytest.mark.parametrize("B,S,d", [(3, 1, 16), (9, 5, 64)])
def test_one_step_and_rows_off_the_cluster_rows(B, S, d):
    """S = 1 from the state a prompt left; B = 9 rows (one past the cluster
    layout's 8)."""
    got, want = _twin_against_autograd(_scan_inputs(B, S, d, "prompt", seed=11),
                                       _cotangents(B, S, d, seed=12))
    _close(got, want)


def test_only_the_outputs_gradient():
    """Training's case: the state after the last step unused (its gradients
    None, counted as zero), the entering state a constant."""
    B, S, d = 2, 9, 32
    args = _scan_inputs(B, S, d, "fresh", seed=13)
    cot = _cotangents(B, S, d, seed=14)[0]

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in args[:5]]
        return torch.autograd.grad((fn(*leaves, *args[5:])[0] * cot).sum(), leaves)

    _close(grads(slstm_ops.slstm_scan), grads(slstm_scan_ref))
