"""The port's MoE layer against the JAX package's, on the CPU.

``repro.models.moe`` draws the layer (router, experts and, for DeepSeek,
a shared expert) at the reduced configs of ``granite-moe-1b-a400m`` and
``deepseek-v3-671b`` (float32, 8 experts top-2, d_model 64); the port gets
the same numbers. Routing ids, slot tables and keep masks must equal the
reference's exactly; gates, outputs 1e-5 and the aux loss 1e-6 (float32 on
both sides, only the order of sums differs). A capacity factor of 0.5
forces drops, which must drop the same choices.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as jax_moe
from repro.models.layers import MeshCtx
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models.convert import _tensor

TOL = dict(atol=1e-5, rtol=1e-5)
AUX_TOL = dict(atol=1e-6, rtol=1e-6)
CTX = MeshCtx(mesh=None)
ARCHS = ("granite-moe-1b-a400m", "deepseek-v3-671b")


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **tol)


def _layer(name, capacity_factor=None, seed=0):
    """(jax cfg, port cfg, jax params, port params) of one MoE layer."""
    jcfg, cfg = jax_get_config(name).reduced(), get_config(name).reduced()
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor)
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    jp = jax_moe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tp = jax.tree.map(lambda a: _t(np.asarray(a)), jp)
    return jcfg, cfg, jp, tp


def _tokens(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("name", ARCHS)
def test_route_ids_gates_and_aux_match(name):
    jcfg, cfg, jp, tp = _layer(name)
    x = _tokens((40, cfg.d_model), 1)
    jg, jids, jaux = jax_moe._route(jnp.asarray(x), jp["router"]["w"], jcfg.top_k)
    g, ids, aux = moe._route(_t(x), tp["router"]["w"], cfg.top_k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(g, jg)
    _close(aux, jaux, AUX_TOL)


def test_route_breaks_ties_to_the_lower_id():
    # Equal logits everywhere: jax.lax.top_k takes the lowest ids, in order.
    jcfg, cfg, jp, tp = _layer("granite-moe-1b-a400m")
    x = np.zeros((3, cfg.d_model), np.float32)
    x[1, :] = 1.0
    w = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    w[:, 5] = w[:, 2] = 0.5  # a tie between experts 2 and 5 for token 1
    jg, jids, _ = jax_moe._route(jnp.asarray(x), jnp.asarray(w), jcfg.top_k)
    g, ids, _ = moe._route(_t(x), _t(w), cfg.top_k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert ids.tolist() == [[0, 1], [2, 5], [0, 1]]
    _close(g, jg)


@pytest.mark.parametrize("capacity", [4, 7, 40])
def test_slot_tables_are_the_references(capacity):
    rng = np.random.default_rng(capacity)
    E, t, k = 8, 24, 2
    ids = np.stack([rng.choice(E, size=k, replace=False) for _ in range(t)]).astype(np.int32)
    ids[:10] = [0, 1]  # expert 0 and 1 chosen by 10+ tokens: past C = 4 and 7
    want = jax_moe._slot_tables(jnp.asarray(ids), E, capacity)
    got = moe._slot_tables(_t(ids).long(), E, capacity)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    keep = got[2]
    if capacity < 10:
        assert not bool(keep.all()), "the overflow case must drop choices"
        # Expert 0 keeps its first `capacity` tokens in token order and drops
        # the rest, which point at the sentinel slot.
        assert bool(keep[:capacity, 0].all()) and not bool(keep[capacity:10, 0].any())
        assert bool((got[1][~keep] == E * capacity).all())
    else:
        assert bool(keep.all())


def test_capacity_is_the_references_formula():
    cfg = get_config("granite-moe-1b-a400m")
    # Decode at 8 requests: int(8 * 8 / 32 * 1.25) = 2, raised to the floor of 4.
    assert moe.capacity(cfg, 8) == 4
    assert moe.capacity(cfg, 8 * 512) == int(4096 * 8 / 32 * 1.25) == 1280
    ds = get_config("deepseek-v3-671b")
    assert moe.capacity(ds, 4 * 256) == int(1024 * 8 / 256 * 1.25) == 40


@pytest.mark.parametrize("capacity_factor", [None, 0.5], ids=["default", "drops"])
@pytest.mark.parametrize("name", ARCHS)
def test_moe_block_matches_jax(name, capacity_factor):
    jcfg, cfg, jp, tp = _layer(name, capacity_factor, seed=2)
    assert ("shared" in tp) == (name == "deepseek-v3-671b")
    for B, S in ((2, 12), (3, 1)):  # a prefill and a decode step
        x = _tokens((B, S, cfg.d_model), 3 + S)
        jy, jaux = jax_moe.moe_block(jp, jnp.asarray(x), CTX, jcfg)
        y, aux = moe.moe_block(tp, _t(x), cfg)
        _close(y, jy)
        _close(aux, jaux, AUX_TOL)
    if capacity_factor is not None:
        x = _tokens((2, 12, cfg.d_model), 15)
        _, ids, _ = moe._route(_t(x).reshape(-1, cfg.d_model), tp["router"]["w"], cfg.top_k)
        keep = moe._slot_tables(ids, cfg.n_experts, moe.capacity(cfg, 24))[2]
        assert not bool(keep.all()), "capacity 0.5 must drop choices at 24 tokens"


@pytest.mark.parametrize("name", ARCHS)
def test_moe_block_in_bfloat16_matches_jax(name):
    """bf16 weights and tokens (the router float32), as served: the combine
    weighs each choice by its gate rounded to bf16, as the reference's
    ``(gates * keep).astype(tokens.dtype)``. The two packages round the
    products and the SiLU in other places, so the outputs agree to about a
    bf16 ulp: max |d| within 2^-7 of max |want|."""
    jcfg, cfg = jax_get_config(name).reduced(), get_config(name).reduced()
    jp = jax_moe.init_moe(jax.random.PRNGKey(4), jcfg, jnp.bfloat16)
    tp = jax.tree.map(lambda a: _tensor(a, torch.device("cpu")), jp)
    assert tp["experts"]["w_up"].dtype == torch.bfloat16
    assert tp["router"]["w"].dtype == torch.float32
    x = _tokens((2, 6, cfg.d_model), 5)
    jy, _ = jax_moe.moe_block(jp, jnp.asarray(x, jnp.bfloat16), CTX, jcfg)
    y, _ = moe.moe_block(tp, _t(x).to(torch.bfloat16), cfg)
    assert y.dtype == torch.bfloat16
    want = np.asarray(jy.astype(jnp.float32))
    assert np.abs(y.float().numpy() - want).max() <= 2 ** -7 * np.abs(want).max()
