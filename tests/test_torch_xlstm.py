"""The port's xLSTM blocks, and the layers no model calls, against the JAX
package on the CPU.

At ``xlstm-125m``'s reduced config (d_model 64, 4 heads, the mLSTM cell at
the up-projected width 128, so a head dim of 32), float32: the blocks'
parameters are drawn by ``repro.models.xlstm``'s init from a JAX key, with
random biases and norm scales from a numpy seed, and handed to both
packages. ``mlstm_block`` runs a prompt of 12 tokens (one chunk) and of 512
(two chunks of 256, so the state carries between chunks), from a zero state
and from the state a 12-token prompt left, then decode steps; outputs and
the states C, n and m must equal the reference's to atol = rtol = 1e-5, the
tolerance of ``tests/test_torch_models.py``. The 256-token chunks need
atol 1e-4 (``CHUNK_TOL``): each chunk's stabiliser m starts from an
inclusive cumsum of 256 log-forget gates, which XLA (a ``reduce_window``)
and torch sum in different orders, so m differs by up to 1.5e-5 (of 2.1)
and C, n, scaled by exp(-m), by up to 7.1e-5 (of 9.3) and 4.0e-5 (of 3.5);
the block's output by 2.4e-5 (of 5.0). At 513 tokens both packages refuse.
``slstm_block`` the same over its time loop (3e-7 at 512 steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as jax_layers
from repro.models import xlstm as jax_xlstm
from repro.models.layers import MeshCtx
from repro_torch.configs import get_config
from repro_torch.models import layers, xlstm

TOL = dict(atol=1e-5, rtol=1e-5)
CHUNK_TOL = dict(atol=1e-4, rtol=1e-5)
CTX = MeshCtx(mesh=None)
B = 2


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _np_tree(tree, rng):
    """A JAX block's parameters as numpy, biases and norm scales random."""
    def perturb(path, a):
        a = np.asarray(a)
        name = jax.tree_util.keystr(path)
        if "norm" in name or "'b'" in name:
            return (a + 0.3 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(perturb, tree)


def _torch_tree(tree):
    return jax.tree.map(_t, tree)


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def cfgs():
    return jax_get_config("xlstm-125m").reduced(), get_config("xlstm-125m").reduced()


@pytest.fixture(scope="module")
def blocks(cfgs):
    jcfg, _ = cfgs
    rng = np.random.default_rng(0)
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    return {"mlstm": _np_tree(jax_xlstm.init_mlstm_block(keys[0], jcfg, jnp.float32), rng),
            "slstm": _np_tree(jax_xlstm.init_slstm_block(keys[1], jcfg, jnp.float32), rng)}


def _x(seed, S, d):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(np.float32)


def _state_to_torch(state, cls):
    return cls(**{k: _t(v) for k, v in vars(state).items()})


def _states_close(got, want, tol=TOL):
    assert set(vars(got)) == set(vars(want))
    for k in vars(want):
        _close(getattr(got, k), getattr(want, k), tol)


def _run(kind, blocks, cfgs, x, jstate):
    """(port output, port state, reference output, reference state) of one
    block call from ``jstate`` (None: no state)."""
    jcfg, cfg = cfgs
    jfn = jax_xlstm.mlstm_block if kind == "mlstm" else jax_xlstm.slstm_block
    tfn = xlstm.mlstm_block if kind == "mlstm" else xlstm.slstm_block
    cls = xlstm.MLSTMState if kind == "mlstm" else xlstm.SLSTMState
    jy, jnew = jfn(_jax_tree(blocks[kind]), jnp.asarray(x), CTX, jcfg, state=jstate)
    ty, tnew = tfn(_torch_tree(blocks[kind]), _t(x), cfg,
                   state=None if jstate is None else _state_to_torch(jstate, cls))
    return ty, tnew, jy, jnew


def _entering_state(kind, blocks, cfgs):
    """The state a 12-token prompt leaves, from the reference."""
    jcfg, _ = cfgs
    init = jax_xlstm.init_mlstm_state if kind == "mlstm" else jax_xlstm.init_slstm_state
    fn = jax_xlstm.mlstm_block if kind == "mlstm" else jax_xlstm.slstm_block
    _, st = fn(_jax_tree(blocks[kind]), jnp.asarray(_x(7, 12, jcfg.d_model)), CTX, jcfg,
               state=init(B, jcfg, jnp.float32))
    return st


@pytest.mark.parametrize("S", [12, 512])
@pytest.mark.parametrize("start", ["zero", "entering"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_prefill_matches_jax(kind, start, S, blocks, cfgs):
    jcfg, _ = cfgs
    if start == "zero":
        init = jax_xlstm.init_mlstm_state if kind == "mlstm" else jax_xlstm.init_slstm_state
        jstate = init(B, jcfg, jnp.float32)
    else:
        jstate = _entering_state(kind, blocks, cfgs)
    ty, tnew, jy, jnew = _run(kind, blocks, cfgs, _x(S, S, jcfg.d_model), jstate)
    assert ty.shape == (B, S, jcfg.d_model)
    tol = CHUNK_TOL if kind == "mlstm" and S >= xlstm.CHUNK else TOL
    _close(ty, jy, tol)
    _states_close(tnew, jnew, tol)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_without_state_returns_none(kind, blocks, cfgs):
    ty, tnew, jy, jnew = _run(kind, blocks, cfgs, _x(3, 12, cfgs[0].d_model), None)
    assert tnew is None and jnew is None
    _close(ty, jy)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_decode_steps_match_jax(kind, blocks, cfgs):
    """Three one-token steps after the 12-token prompt; mLSTM takes its
    decode branch at S == 1."""
    jstate = _entering_state(kind, blocks, cfgs)
    for step in range(3):
        ty, tnew, jy, jstate = _run(kind, blocks, cfgs, _x(20 + step, 1, cfgs[0].d_model),
                                    jstate)
        _close(ty, jy)
        _states_close(tnew, jstate)


def test_mlstm_decode_branch_equals_a_one_token_chunk(blocks, cfgs):
    """The decode update and the chunkwise evaluation of one token are the
    same function, on the port's side as on the reference's."""
    _, cfg = cfgs
    st = _state_to_torch(_entering_state("mlstm", blocks, cfgs), xlstm.MLSTMState)
    rng = np.random.default_rng(4)
    H, D = cfg.n_heads, 2 * cfg.d_model // cfg.n_heads
    q, k, v = (_t(rng.standard_normal((B, H, 1, D)).astype(np.float32)) for _ in range(3))
    li, lf = _t(rng.standard_normal((B, H, 1)).astype(np.float32)), -_t(
        rng.random((B, H, 1)).astype(np.float32))
    h1, s1 = xlstm._mlstm_decode(q, k, v, li, lf, st)
    h2, s2 = xlstm._mlstm_chunk_parallel(q, k, v, li, lf, st)
    _close(h1, h2.numpy())
    _states_close(s1, s2)


def test_mlstm_refuses_what_the_reference_cannot_reshape(blocks, cfgs):
    """At S >= 256 the reference takes S // 256 chunks of S // (S // 256)
    tokens; at 513 that is 2 x 256 and its reshape fails. Both refuse."""
    jcfg, cfg = cfgs
    x = _x(5, 513, jcfg.d_model)
    with pytest.raises(TypeError, match="reshape"):
        jax_xlstm.mlstm_block(_jax_tree(blocks["mlstm"]), jnp.asarray(x), CTX, jcfg)
    with pytest.raises(ValueError, match="multiple of S // 256"):
        xlstm.mlstm_block(_torch_tree(blocks["mlstm"]), _t(x), cfg)
    assert xlstm.chunking(512) == (2, 256) and xlstm.chunking(768) == (3, 256)
    assert xlstm.chunking(255) == (1, 255) and xlstm.chunking(260) == (1, 260)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_initial_states_are_the_references(kind, cfgs):
    jcfg, cfg = cfgs
    init_j = jax_xlstm.init_mlstm_state if kind == "mlstm" else jax_xlstm.init_slstm_state
    init_t = xlstm.init_mlstm_state if kind == "mlstm" else xlstm.init_slstm_state
    want = init_j(3, jcfg, jnp.bfloat16)
    got = init_t(3, cfg, torch.bfloat16, device="cpu")
    for k, v in vars(want).items():
        t = getattr(got, k)
        assert t.dtype == torch.float32 and tuple(t.shape) == v.shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(v))
    assert bool((got.m == torch.tensor(-1e30)).all())


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_init_draws_the_references_tree(kind, cfgs, blocks):
    _, cfg = cfgs
    init = xlstm.init_mlstm_block if kind == "mlstm" else xlstm.init_slstm_block
    port = init(torch.Generator().manual_seed(0), cfg, torch.float32)
    shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)  # noqa: E731
    assert shapes(port) == shapes(blocks[kind])
    if kind == "slstm":
        assert "b" not in port["r_z"] and "b" in port["w_z"]


def test_layer_norm_and_gelu_mlp_match_jax():
    """Layers of the reference that no model calls, ported as layers."""
    rng = np.random.default_rng(9)
    x = (3.0 + 2.0 * rng.standard_normal((B, 5, 64))).astype(np.float32)
    scale, bias = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    _close(layers.layer_norm(_t(scale), _t(bias), _t(x)),
           jax_layers.layer_norm(jnp.asarray(scale), jnp.asarray(bias), jnp.asarray(x)))
    tree = jax.tree.map(np.asarray, jax_layers.init_gelu_mlp(jax.random.PRNGKey(1), 64, 96,
                                                             jnp.float32))
    tree["w_fc"]["b"] = rng.standard_normal(96).astype(np.float32)
    _close(layers.gelu_mlp(_torch_tree(tree), _t(x)),
           jax_layers.gelu_mlp(_jax_tree(tree), jnp.asarray(x), CTX))
    port = layers.init_gelu_mlp(torch.Generator().manual_seed(0), 64, 96, torch.float32)
    assert jax.tree.map(lambda a: tuple(a.shape), port) == jax.tree.map(
        lambda a: tuple(a.shape), tree)
