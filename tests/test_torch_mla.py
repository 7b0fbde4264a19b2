"""The port's MLA block and eager ``sdpa_chunked`` against the JAX
package's, on the CPU.

``repro.models.mla`` draws the block at ``deepseek-v3-671b``'s reduced
config (float32, 4 heads, q_lora 32, kv_lora 16, rope 8, nope 8, v 16,
d_model 64), with random norm scales; the port gets the same numbers.
Outputs and caches must agree to 1e-5 (float32 on both sides; only the
order of sums differs): a prefill and decode steps against a cache, a
prompt as long as the cache (the reference's replacement branch), no
cache, and the expanded branch at B=1, S=2048 (the reference's literal
threshold), which runs ``sdpa_chunked``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attention
from repro.models import mla as jax_mla
from repro.models.layers import MeshCtx
from repro_torch.configs import get_config
from repro_torch.models import attention, mla

TOL = dict(atol=1e-5, rtol=1e-5)
CTX = MeshCtx(mesh=None)
B = 2


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def cfgs():
    return jax_get_config("deepseek-v3-671b").reduced(), get_config("deepseek-v3-671b").reduced()


@pytest.fixture(scope="module")
def block(cfgs):
    """(jax params, port params): the JAX init with random norm scales."""
    rng = np.random.default_rng(0)
    jp = jax.tree.map(np.asarray, jax_mla.init_mla(jax.random.PRNGKey(0), cfgs[0], jnp.float32))
    for name in ("q_norm", "kv_norm"):
        jp[name] = (0.3 * rng.standard_normal(jp[name].shape)).astype(np.float32)
    return jax.tree.map(jnp.asarray, jp), jax.tree.map(_t, jp)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _same_cache(tc, jc):
    assert tc.pos == int(jc.pos)
    _close(tc.latent, jc.latent)
    _close(tc.k_rope, jc.k_rope)


def test_mla_prefill_and_decode_with_a_cache(cfgs, block):
    jcfg, cfg = cfgs
    jp, tp = block
    jcache = jax_mla.init_mla_cache(B, 16, jcfg, jnp.float32)
    tcache = mla.init_mla_cache(B, 16, cfg, torch.float32, device="cpu")
    for i, Sq in enumerate((11, 1, 1, 3)):  # a prefill, two decode steps, a chunk
        x = _x((B, Sq, cfg.d_model), i)
        jy, jcache = jax_mla.mla_block(jp, jnp.asarray(x), CTX, jcfg, cache=jcache)
        ty, tcache = mla.mla_block(tp, _t(x), cfg, cache=tcache)
        _close(ty, jy)
        _same_cache(tcache, jcache)


def test_mla_prompt_as_long_as_the_cache_fills_it(cfgs, block):
    jcfg, cfg = cfgs
    jp, tp = block
    x = _x((B, 12, cfg.d_model), 5)
    jy, jcache = jax_mla.mla_block(jp, jnp.asarray(x), CTX, jcfg,
                                   cache=jax_mla.init_mla_cache(B, 12, jcfg, jnp.float32))
    ty, tcache = mla.mla_block(tp, _t(x), cfg,
                               cache=mla.init_mla_cache(B, 12, cfg, torch.float32, device="cpu"))
    _close(ty, jy)
    _same_cache(tcache, jcache)
    with pytest.raises(ValueError, match="MLA cache full"):
        mla.mla_block(tp, _t(x[:, :1]), cfg, cache=tcache)


def test_mla_without_a_cache(cfgs, block):
    jcfg, cfg = cfgs
    jp, tp = block
    x = _x((B, 7, cfg.d_model), 6)
    pos = np.arange(30, 37)
    jy, none_j = jax_mla.mla_block(jp, jnp.asarray(x), CTX, jcfg, positions=jnp.asarray(pos))
    ty, none_t = mla.mla_block(tp, _t(x), cfg, positions=_t(pos))
    assert none_j is None and none_t is None
    _close(ty, jy)


@pytest.mark.parametrize("with_cache", [False, True], ids=["no cache", "cache of 2048"])
def test_mla_expanded_branch_at_2048(cfgs, block, with_cache):
    jcfg, cfg = cfgs
    jp, tp = block
    S = mla.EXPANDED_MIN_SEQ
    x = _x((1, S, cfg.d_model), 7)
    jc = jax_mla.init_mla_cache(1, S, jcfg, jnp.float32) if with_cache else None
    tc = mla.init_mla_cache(1, S, cfg, torch.float32, device="cpu") if with_cache else None
    calls = []
    real = mla.sdpa_chunked

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    mla.sdpa_chunked = counting
    try:
        ty, tcache = mla.mla_block(tp, _t(x), cfg, cache=tc)
    finally:
        mla.sdpa_chunked = real
    assert calls == [(1, S, cfg.n_heads, cfg.qk_nope_dim + cfg.qk_rope_dim)]
    jy, jcache = jax_mla.mla_block(jp, jnp.asarray(x), CTX, jcfg, cache=jc)
    _close(ty, jy)
    if with_cache:
        _same_cache(tcache, jcache)


@pytest.mark.parametrize("Sq,Sk,H,Hkv,D,Dv,causal,window,chunk", [
    (50, 50, 4, 4, 16, 16, True, 0, 16),      # ragged blocks, causal
    (40, 40, 4, 2, 24, 16, True, 0, 16),      # GQA, Dv != D (MLA's shapes)
    (45, 45, 2, 1, 16, 16, True, 12, 8),      # window: blocks skipped below
    (20, 33, 2, 2, 16, 8, False, 0, 16),      # bidirectional, Sk > Sq
    (64, 64, 4, 4, 16, 16, True, 0, 1024),    # one block
])
def test_sdpa_chunked_matches_the_reference(Sq, Sk, H, Hkv, D, Dv, causal, window, chunk):
    rng = np.random.default_rng(Sq + Sk)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, Dv)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_chunk=chunk, k_chunk=chunk)
    want = jax_attention.sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = attention.sdpa_chunked(_t(q), _t(k), _t(v), **kw)
    assert got.shape == (B, Sq, H, Dv)
    _close(got, want)
    if Sq == Sk and Dv == D:  # the plain reference computes the same function
        _close(got, attention.sdpa(_t(q), _t(k), _t(v), causal=causal, window=window))


def test_sdpa_chunked_in_bfloat16_matches_the_reference():
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((1, 40, 2, 16)).astype(np.float32) for _ in range(3))
    kw = dict(causal=True, q_chunk=16, k_chunk=16)
    want = jax_attention.sdpa_chunked(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), **kw)
    got = attention.sdpa_chunked(*(_t(a).to(torch.bfloat16) for a in (q, k, v)), **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=2 ** -7, rtol=2 ** -7)
