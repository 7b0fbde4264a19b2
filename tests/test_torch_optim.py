"""The port's optimizer and gradient compression against the JAX package's.

``repro_torch.optim.adamw`` piece by piece against ``repro.optim.adamw``
on trees drawn from a numpy seed (nested dicts and lists, so the leaf
order, dict keys sorted, matters for the global norm): ``init_opt_state``,
``global_norm``, ``clip_by_global_norm`` (below and above the limit),
``cosine_schedule`` (warm-up, cosine, the floor), ``adamw_update`` with
and without a schedule over several steps (float32: 1e-6), a bfloat16
parameter update with float32 and bfloat16 moments (equal bits), and the
reference's own checks (a quadratic converges, clipping).
``repro_torch.optim.compression`` against ``repro.optim.compression``:
the bfloat16 round trip, int8 error feedback (equal codes, scales and
residuals) and its unbiasedness.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import adamw as jax_adamw
from repro.optim import compression as jax_compression
from repro_torch._tree import leaves, tree_map
from repro_torch.optim import adamw, compression

TOL = dict(atol=1e-6, rtol=1e-6)


def _np_tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return rng.standard_normal(shape).astype(dtype)

    return {"z": draw(3, 4), "a": {"w": draw(5), "b": draw(2, 2)},
            "segs": [draw(4), {"k": draw(1, 6)}]}


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(port, ref, **tol):
    got, want = leaves(port), jax.tree.leaves(ref)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), **(tol or TOL))


def test_leaves_follow_jax_order():
    tree = _np_tree(0)
    assert [a.shape for a in leaves(tree)] == [a.shape for a in jax.tree.leaves(tree)]


def test_init_opt_state_matches_jax():
    for dt in ("float32", "bfloat16"):
        state = adamw.init_opt_state(_torch(_np_tree(0)), adamw.AdamWConfig(state_dtype=dt))
        jstate = jax_adamw.init_opt_state(_jnp(_np_tree(0)), jax_adamw.AdamWConfig(state_dtype=dt))
        assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
        assert [(tuple(t.shape), str(t.dtype)[6:]) for t in leaves(state["m"])] == [
            (a.shape, a.dtype.name) for a in jax.tree.leaves(jstate["m"])]
        assert all(float(t.abs().max()) == 0 for t in leaves(state["v"]))


@pytest.mark.parametrize("scale", [1e-3, 1.0, 100.0])
def test_global_norm_and_clip_match_jax(scale):
    tree = tree_map(lambda a: a * np.float32(scale), _np_tree(1))
    np.testing.assert_allclose(float(adamw.global_norm(_torch(tree))),
                               float(jax_adamw.global_norm(_jnp(tree))), rtol=1e-6)
    clipped, norm = adamw.clip_by_global_norm(_torch(tree), 1.0)
    jclipped, jnorm = jax_adamw.clip_by_global_norm(_jnp(tree), 1.0)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    _close(clipped, jclipped)


def test_grad_clip_global_norm():
    grads = {"a": torch.full((4,), 100.0), "b": torch.full((4,), -100.0)}
    clipped, norm = adamw.clip_by_global_norm(grads, 1.0)
    assert float(norm) == pytest.approx(np.sqrt(8 * 100.0 ** 2), rel=1e-5)
    assert float(adamw.global_norm(clipped)) == pytest.approx(1.0, rel=1e-4)


def test_cosine_schedule_matches_jax():
    lr = adamw.cosine_schedule(3e-4, warmup_steps=10, total_steps=100)
    jlr = jax_adamw.cosine_schedule(3e-4, warmup_steps=10, total_steps=100)
    steps = np.arange(0, 130, 3, dtype=np.int32)
    got = lr(torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jlr(jnp.asarray(steps))), rtol=1e-6,
                               atol=1e-12)
    unit = adamw.cosine_schedule(1.0, warmup_steps=10, total_steps=100)
    assert float(unit(torch.tensor(0))) == 0.0
    assert float(unit(torch.tensor(10))) == pytest.approx(1.0)
    assert float(unit(torch.tensor(100))) == pytest.approx(0.1, rel=1e-3)


@pytest.mark.parametrize("schedule", [False, True])
def test_adamw_update_matches_jax(schedule):
    cfg = adamw.AdamWConfig(lr=1e-2, weight_decay=0.05, clip_norm=2.0)
    jcfg = jax_adamw.AdamWConfig(lr=1e-2, weight_decay=0.05, clip_norm=2.0)
    lr_fn = adamw.cosine_schedule(1e-2, 2, 5) if schedule else None
    jlr_fn = jax_adamw.cosine_schedule(1e-2, 2, 5) if schedule else None
    params, jparams = _torch(_np_tree(2)), _jnp(_np_tree(2))
    state, jstate = adamw.init_opt_state(params, cfg), jax_adamw.init_opt_state(jparams, jcfg)
    for i in range(5):
        grads = tree_map(lambda a: a * np.float32(0.5 + i), _np_tree(10 + i))
        before = leaves(params)[0].clone()
        params, state, metrics = adamw.adamw_update(params, _torch(grads), state, cfg, lr_fn)
        jparams, jstate, jmetrics = jax_adamw.adamw_update(jparams, _jnp(grads), jstate, jcfg,
                                                           jlr_fn)
        _close(params, jparams)
        _close(state["m"], jstate["m"])
        _close(state["v"], jstate["v"])
        assert int(state["step"]) == int(jstate["step"]) == i + 1
        assert state["step"].dtype == torch.int32
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=1e-6)
        assert not torch.equal(leaves(params)[0], before)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_bf16_parameter_update_matches_jax(state_dtype):
    """bfloat16 parameters, the update in float32, written back in bfloat16:
    the same bits as the reference's."""
    cfg = adamw.AdamWConfig(lr=1e-2, state_dtype=state_dtype)
    jcfg = jax_adamw.AdamWConfig(lr=1e-2, state_dtype=state_dtype)
    tree = _np_tree(3)
    bf = tree_map(lambda a: a.astype(ml_dtypes.bfloat16), tree)
    params = tree_map(lambda a: torch.from_numpy(a).to(torch.bfloat16), tree)
    jparams = _jnp(bf)
    grads = tree_map(lambda a: a.astype(ml_dtypes.bfloat16), _np_tree(4))
    tgrads = tree_map(lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16),
                      _np_tree(4))
    state, jstate = adamw.init_opt_state(params, cfg), jax_adamw.init_opt_state(jparams, jcfg)
    for _ in range(2):
        params, state, _ = adamw.adamw_update(params, tgrads, state, cfg)
        jparams, jstate, _ = jax_adamw.adamw_update(jparams, _jnp(grads), jstate, jcfg)
    for got, want in zip(leaves(params), jax.tree.leaves(jparams)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16))
    for got, want in zip(leaves(state["v"]), jax.tree.leaves(jstate["v"])):
        assert str(got.dtype)[6:] == state_dtype
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=1e-6,
                                   atol=0)


def test_adamw_converges_on_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw.init_opt_state(params, cfg)
    for _ in range(200):
        params, state, _ = adamw.adamw_update(params, {"w": 2 * params["w"]}, state, cfg)
    assert float(params["w"].abs().max()) < 0.05


def test_update_writes_none_of_its_inputs():
    params = _torch(_np_tree(5))
    grads = _torch(_np_tree(6))
    state = adamw.init_opt_state(params, adamw.AdamWConfig())
    copies = [t.clone() for t in leaves((params, grads, state))]
    adamw.adamw_update(params, grads, state, adamw.AdamWConfig())
    assert all(torch.equal(a, b) for a, b in zip(copies, leaves((params, grads, state))))


def test_bf16_round_trip_matches_jax():
    tree = _np_tree(7)
    low = compression.to_bf16(_torch(tree))
    jlow = jax_compression.to_bf16(_jnp(tree))
    for got, want in zip(leaves(low), jax.tree.leaves(jlow)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16))
    back = compression.from_f32(low, _torch(tree))
    assert all(t.dtype == torch.float32 for t in leaves(back))
    _close(back, jax_compression.from_f32(jlow, _jnp(tree)), atol=0, rtol=0)


def test_quantize_ef_matches_jax():
    grads = _np_tree(8)
    res, jres = compression.init_residual(_torch(grads)), jax_compression.init_residual(_jnp(grads))
    for i in range(4):
        g = tree_map(lambda a: a * np.float32(1 + i), grads)
        q, s, res = compression.quantize_ef(_torch(g), res)
        jq, js, jres = jax_compression.quantize_ef(_jnp(g), jres)
        for got, want in zip(leaves(q), jax.tree.leaves(jq)):
            assert got.dtype == torch.int8
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        _close(s, js, rtol=0, atol=0)
        _close(res, jres, rtol=1e-6, atol=1e-7)
        _close(compression.dequantize(q, s), jax_compression.dequantize(jq, js), rtol=0, atol=0)


def test_int8_error_feedback_unbiased():
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(size=512).astype(np.float32))}
    r = compression.init_residual(g)
    acc = torch.zeros(512)
    exact = torch.zeros(512)
    for _ in range(50):
        q, s, r = compression.quantize_ef(g, r)
        acc = acc + compression.dequantize(q, s)["w"]
        exact = exact + g["w"]
    assert float((acc - exact).abs().max() / exact.abs().max()) < 0.01
