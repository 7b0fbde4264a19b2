"""The port's RG-LRU scan (B5) and recurrent block against the JAX package.

On the CPU ``ops.rglru_scan`` runs the kernel's plain PyTorch version (a
sequential float32 loop). Both are held against ``repro``'s
``rglru_scan`` in Pallas interpret mode and through its ``lax.scan``
oracle (``impl="ref"``) over the sweep shapes of ``tests/test_kernels.py``
with a non-zero ``h0``; interpret mode is exact at ragged shapes (ROADMAP
C-ref-4 concerns the attention kernels only). ``rglru_block`` is held
against ``repro.models.rglru.rglru_block`` without a state, and with one
through a prefill and decode steps, new states included. Inputs come from a
numpy seed; float32 on both sides to atol = rtol = 1e-5, the scan
tolerance of ``tests/test_kernels.py`` (the JAX model's associative scan
sums in another order than the sequential loop).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jax_get_config
from repro.kernels.rglru_scan.ops import rglru_scan as jax_rglru_scan
from repro.models import rglru as jax_rglru
from repro.models.layers import MeshCtx
from repro_torch.configs import get_config
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
from repro_torch.models import rglru

TOL = dict(atol=1e-5, rtol=1e-5)
CTX = MeshCtx(mesh=None)
SHAPES = [(2, 512, 256), (3, 100, 64), (1, 37, 128)]  # tests/test_kernels.py:47


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **TOL)


def _scan_inputs(seed, B, S, W):
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, W))))).astype(np.float32)
    b = rng.standard_normal((B, S, W)).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    return a, b, h0


@pytest.mark.parametrize("impl", ["interpret", "ref"])
@pytest.mark.parametrize("fn", ["plain", "ops"])
@pytest.mark.parametrize("B,S,W", SHAPES)
def test_scan_matches_jax(B, S, W, fn, impl):
    a, b, h0 = _scan_inputs(B * S + W, B, S, W)
    want = jax_rglru_scan(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0), impl=impl)
    before = dict(scan_ops.LAUNCHES)
    scan = rglru_scan_ref if fn == "plain" else scan_ops.rglru_scan
    got = scan(_t(a), _t(b), _t(h0))
    assert got.dtype == torch.float32 and got.shape == (B, S, W)
    _close(got, want)
    assert scan_ops.LAUNCHES == before == {"rglru_scan": 0, "rglru_scan_bwd": 0}  # CPU: none


def test_scan_from_zero_state_and_bfloat16_inputs():
    a, b, h0 = _scan_inputs(3, 2, 50, 24)
    want = jax_rglru_scan(jnp.asarray(a), jnp.asarray(b), jnp.zeros((2, 24)), impl="ref")
    _close(scan_ops.rglru_scan(_t(a), _t(b), torch.zeros(2, 24)), want)
    # bf16 inputs: the carry stays float32, each state is rounded once on output.
    ab, bb = _t(a).bfloat16(), _t(b).bfloat16()
    got = scan_ops.rglru_scan(ab, bb, _t(h0))
    want = rglru_scan_ref(ab.float(), bb.float(), _t(h0)).bfloat16()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


def test_scan_checks_its_inputs():
    a, b, h0 = (_t(x) for x in _scan_inputs(4, 2, 6, 8))
    assert scan_ops.rglru_scan(a[:, :0], b[:, :0], h0).shape == (2, 0, 8)  # empty S
    with pytest.raises(ValueError, match="a = b"):
        scan_ops.rglru_scan(a, b[:, :3], h0)
    with pytest.raises(ValueError, match="h0"):
        scan_ops.rglru_scan(a, b, h0[:1])
    with pytest.raises(TypeError):
        scan_ops.rglru_scan(a.double(), b.double(), h0)
    with pytest.raises(TypeError):
        scan_ops.rglru_scan(a, b.bfloat16(), h0)
    with pytest.raises(ValueError, match="contiguous"):
        scan_ops.rglru_scan(a.transpose(1, 2).contiguous().transpose(1, 2), b, h0)


@pytest.fixture(scope="module")
def setup():
    """Reduced recurrentgemma-2b (d_model 64, lru width 64), one recurrent
    block of the JAX package's init with random conv bias and gate biases
    (the init leaves them 0), the same arrays as tensors for the port."""
    jcfg = jax_get_config("recurrentgemma-2b").reduced()
    cfg = get_config("recurrentgemma-2b").reduced()
    rng = np.random.default_rng(0)
    tree = jax.tree.map(np.asarray, jax_rglru.init_rglru_block(jax.random.PRNGKey(0), jcfg,
                                                                jnp.float32))

    def perturb(path, a):
        name = jax.tree_util.keystr(path)
        if "conv_b" in name or "'b'" in name:
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    p_t = jax.tree.map(_t, tree)
    return cfg, jcfg, p_t, jax.tree.map(jnp.asarray, tree)


def test_block_without_state_matches_jax(setup):
    cfg, jcfg, p_t, p_j = setup
    x = np.random.default_rng(1).standard_normal((2, 19, cfg.d_model)).astype(np.float32)
    jy, jstate = jax_rglru.rglru_block(p_j, jnp.asarray(x), CTX, jcfg)
    ty, tstate = rglru.rglru_block(p_t, _t(x), cfg)
    assert jstate is None and tstate is None
    _close(ty, jy)


def test_block_prefill_then_decode_matches_jax(setup):
    cfg, jcfg, p_t, p_j = setup
    rng = np.random.default_rng(2)
    jstate = jax_rglru.init_rglru_state(2, jcfg, jnp.float32)
    tstate = rglru.init_rglru_state(2, cfg, torch.float32, device="cpu")
    assert tstate.h.shape == jstate.h.shape and tstate.conv.shape == jstate.conv.shape
    for S in (23, 1, 1, 1, 2, 1):  # a prefill, decode steps, a short chunk, a step
        x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
        jy, jstate = jax_rglru.rglru_block(p_j, jnp.asarray(x), CTX, jcfg, state=jstate)
        ty, tstate = rglru.rglru_block(p_t, _t(x), cfg, state=tstate)
        _close(ty, jy)
        assert tstate.h.dtype == torch.float32
        _close(tstate.h, jstate.h)
        _close(tstate.conv, jstate.conv)


def test_init_follows_the_jax_distributions(setup):
    cfg, jcfg, p_t, p_j = setup
    gen = torch.Generator().manual_seed(0)
    p = rglru.init_rglru_block(gen, cfg, torch.bfloat16)
    assert jax.tree.map(lambda a: tuple(a.shape), p) == jax.tree.map(lambda a: tuple(a.shape), p_t)
    assert p["lambda_raw"].dtype == torch.float32 and p["w_in"]["w"].dtype == torch.bfloat16
    lam = F.softplus(p["lambda_raw"])
    assert float(lam.min()) >= 0.3 - 1e-6 and float(lam.max()) <= 0.8 + 1e-6
    assert set(p["wa"]) == {"w", "b"} and not bool(p["conv_b"].any())
    w = cfg.lru_width
    assert abs(float(p["w_out"]["w"].float().std()) - w ** -0.5) < 0.3 * w ** -0.5
    assert abs(float(p["conv_w"].float().std()) - 0.1) < 0.03


def test_gelu_is_jax_tanh_approximation():
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    np.testing.assert_allclose(F.gelu(_t(x), approximate="tanh").numpy(), want, atol=1e-6)
    # The exact (erf) GELU is another function: it would fail a 1e-5 parity test.
    assert float(np.abs(F.gelu(_t(x)).numpy() - want).max()) > 1e-4
