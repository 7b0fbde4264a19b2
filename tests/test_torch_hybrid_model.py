"""The port's hybrid model path (RecurrentGemma: ``rglru`` and ``local_attn``
blocks over ring caches) against the JAX package, on the CPU.

At ``recurrentgemma-2b``'s reduced config (float32, 4 layers rglru, rglru,
local_attn, rglru; d_model 64, window 32) the JAX package's parameters,
with random norms and biases from a numpy seed, are converted by
``params_from_jax``; ``attention_block`` on a ring, ``prefill`` and every
``decode_step`` must give the JAX package's results to 1e-5, caches
included.

The JAX package prefills a prompt longer than its ring, but shorter than
2048 tokens, over the rolled ring alone, so every query but the last loses
keys of its window (ROADMAP C-ref-6). From 2048 tokens on it attends over
the fresh keys and values (``sdpa_chunked``), which is what the port does at
any length. Where a prompt is longer than the ring, the tests lower the
JAX package's ``_CHUNKED_THRESHOLD_SEQ`` (a module constant, patched for
the test only) so that it takes that path, and they also hold both to the
JAX model run over the whole sequence without caches.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attention
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro.models.layers import MeshCtx
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import attention, layers
from repro_torch.models import model as M
from repro_torch.models.attention import KVCache
from repro_torch.models.convert import caches_from_jax, params_from_jax
from repro_torch.models.rglru import RGLRUState
from repro_torch.serve_lm import serve

TOL = dict(atol=1e-5, rtol=1e-5)
# The JAX config's distribution and training knobs, which the port leaves out.
TPU_ONLY_FIELDS = {"moe_ep_mode", "opt_state_dtype", "remat", "sequence_parallel",
                   "zero3_use_site_gather", "fsdp_over_pod", "attention_impl"}
CTX = MeshCtx(mesh=None)
B = 2


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **TOL)


@pytest.fixture
def jax_prefill_over_fresh_kv(monkeypatch):
    """The JAX package's long-prompt path (attention over the fresh k/v)
    for every prompt of 2 tokens or more."""
    monkeypatch.setattr(jax_attention, "_CHUNKED_THRESHOLD_SEQ", 2)


def _np_params(jax_cfg, seed=0):
    """JAX init, then random norm scales and biases (the init leaves them 0)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jax_model.init_params(jax.random.PRNGKey(seed), jax_cfg))

    def perturb(path, a):
        name = jax.tree_util.keystr(path)
        if "norm" in name or "'b'" in name or "conv_b" in name:
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(perturb, tree)


@pytest.fixture(scope="module")
def cfg():
    return get_config("recurrentgemma-2b").reduced()


@pytest.fixture(scope="module")
def jax_cfg():
    return jax_get_config("recurrentgemma-2b").reduced()


@pytest.fixture(scope="module")
def np_params(jax_cfg):
    return _np_params(jax_cfg)


@pytest.fixture(scope="module")
def params(np_params, cfg):
    return params_from_jax(np_params, cfg, device="cpu")


@pytest.fixture(scope="module")
def jax_params(np_params):
    return jax.tree.map(jnp.asarray, np_params)


def test_config_is_the_jax_packages(cfg, jax_cfg):
    for port, ref in ((cfg, jax_cfg), (get_config("recurrentgemma-2b"),
                                       jax_get_config("recurrentgemma-2b"))):
        fields = dataclasses.asdict(ref)
        assert set(fields) - set(dataclasses.asdict(port)) == TPU_ONLY_FIELDS
        assert dataclasses.asdict(port) == {k: v for k, v in fields.items()
                                            if k not in TPU_ONLY_FIELDS}
    full = get_config("recurrentgemma_2b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.resolved_head_dim,
            full.d_ff, full.vocab_size, full.local_window, full.lru_width, full.conv_width,
            full.tie_embeddings) == (26, 2560, 10, 1, 256, 7680, 256_000, 2048, 2560, 4, True)
    kinds = full.resolved_block_pattern
    assert kinds.count("rglru") == 18 and kinds.count("local_attn") == 8
    assert cfg.resolved_block_pattern == ("rglru", "rglru", "local_attn", "rglru")


def test_params_from_jax_keeps_every_leaf(np_params, params, cfg):
    want = jax.tree_util.tree_flatten_with_path(np_params)[0]
    got = {jax.tree_util.keystr(path): leaf
           for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    n = 0
    for path, leaf in want:
        keys = list(path)
        if keys[0].key == "segments":  # stacked over repeats in JAX, a list in the port
            si, pi = keys[1].idx, keys[2].idx
            for r in range(leaf.shape[0]):
                name = jax.tree_util.keystr((keys[0], keys[1], keys[2],
                                             jax.tree_util.SequenceKey(r), *keys[3:]))
                np.testing.assert_array_equal(got[name].numpy(), leaf[r])
                n += 1
            assert len(params["segments"][si][pi]) == leaf.shape[0]
        else:
            np.testing.assert_array_equal(got[jax.tree_util.keystr(path)].numpy(), leaf)
            n += 1
    assert n == len(got)
    rec = params["segments"][0][0][0]["rec"]
    assert set(rec) == {"w_in", "w_gate", "conv_w", "conv_b", "wa", "wx", "lambda_raw", "w_out"}
    port = M.init_params(cfg, seed=3, device="cpu")
    assert jax.tree.map(lambda a: (tuple(a.shape), a.dtype), port) == \
        jax.tree.map(lambda a: (tuple(a.shape), a.dtype), params)


def test_init_caches_match_jax(cfg, jax_cfg):
    s_cache = 45  # the ring of the local_attn block holds min(45, 32) slots
    port = M.init_caches(cfg, B, s_cache, device="cpu")
    ref = caches_from_jax(jax.tree.map(np.asarray, jax_model.init_caches(jax_cfg, B, s_cache)),
                          cfg, device="cpu")
    assert [[len(e) for e in seg] for seg in port] == [[len(e) for e in seg] for seg in ref]
    for seg_p, seg_r in zip(port, ref):
        for ep, er in zip(seg_p, seg_r):
            for a, b in zip(ep, er):
                assert type(a) is type(b)
                fields = ("h", "conv") if isinstance(a, RGLRUState) else ("k", "v")
                for f in fields:
                    assert getattr(a, f).shape == getattr(b, f).shape
                    assert getattr(a, f).dtype == getattr(b, f).dtype
    assert port[0][2][0].k.shape[1] == cfg.local_window == 32
    assert port[0][0][0].h.dtype == torch.float32


def _rope_fns(cfg):
    def jfn(x, positions):
        cos, sin = jax_layers.rope(positions, cfg.resolved_head_dim, cfg.rope_theta)
        return jax_layers.apply_rope(x, cos, sin)

    def tfn(x, positions):
        cos, sin = layers.rope(positions, cfg.resolved_head_dim, cfg.rope_theta)
        return layers.apply_rope(x, cos, sin)

    return jfn, tfn


@pytest.mark.parametrize("prompt", [5, 8, 13], ids=["shorter", "equal", "longer"])
def test_ring_attention_block_matches_jax(params, jax_params, cfg, prompt, monkeypatch):
    """A ring of 8 slots, window 8: prefill, then decode well past the wrap."""
    window = ring = 8
    if prompt > ring:
        monkeypatch.setattr(jax_attention, "_CHUNKED_THRESHOLD_SEQ", 2)
    rng = np.random.default_rng(prompt)
    p_t = params["segments"][0][2][0]["attn"]
    p_j = jax.tree.map(lambda a: a[0], jax_params["segments"][0][2])["attn"]
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
              window=window)
    jfn, tfn = _rope_fns(cfg)
    jcache = jax_attention.init_kv_cache(B, ring, cfg.n_kv_heads, cfg.resolved_head_dim,
                                         jnp.float32)
    tcache = attention.init_kv_cache(B, ring, cfg.n_kv_heads, cfg.resolved_head_dim,
                                     torch.float32, device="cpu")
    xs = rng.standard_normal((B, prompt + 12, cfg.d_model)).astype(np.float32)
    # The whole sequence without a cache: windowed attention over all of it.
    full, _ = jax_attention.attention_block(p_j, jnp.asarray(xs), CTX, rope_fn=jfn, **kw)
    for start, stop in [(0, prompt)] + [(t, t + 1) for t in range(prompt, prompt + 12)]:
        x = xs[:, start:stop]
        pos = jnp.arange(start, stop, dtype=jnp.int32)
        jy, jcache = jax_attention.attention_block(p_j, jnp.asarray(x), CTX, rope_fn=jfn,
                                                   cache=jcache, positions=pos, **kw)
        ty, tcache = attention.attention_block(p_t, _t(x), rope_fn=tfn, cache=tcache, **kw)
        _close(ty, jy)
        _close(ty, full[:, start:stop])
        assert tcache.pos == int(jcache.pos) == stop
        _close(tcache.k, jcache.k)
        _close(tcache.v, jcache.v)


def test_ring_cache_refuses_what_it_cannot_serve(params, cfg):
    p = params["segments"][0][2][0]["attn"]
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim)
    cache = attention.init_kv_cache(1, 4, cfg.n_kv_heads, cfg.resolved_head_dim, torch.float32,
                                    device="cpu")
    x = torch.zeros(1, 3, cfg.d_model)
    _, cache = attention.attention_block(p, x, window=4, cache=cache, **kw)
    with pytest.raises(NotImplementedError, match="pos 3 > 0"):  # ROADMAP C-ref-5
        attention.attention_block(p, x[:, :2], window=4, cache=cache, **kw)
    with pytest.raises(ValueError, match="at most window=2"):
        attention.attention_block(p, x, window=2, cache=cache, **kw)
    # Decode wraps the ring: pos counts every token, past the slots.
    for _ in range(5):
        _, cache = attention.attention_block(p, x[:, :1], window=4, cache=cache, **kw)
    assert cache.pos == 8 and cache.k.shape[1] == 4


def test_model_prefill_past_the_ring_needs_pos_zero(params, cfg):
    caches = M.init_caches(cfg, 1, 40, device="cpu")
    _, caches = M.prefill(params, cfg, {"tokens": torch.arange(6)[None]}, caches, device="cpu")
    with pytest.raises(NotImplementedError, match="ring"):
        M.prefill(params, cfg, {"tokens": torch.arange(4)[None]}, caches, device="cpu")


def _run(prefill, decode, params, tokens, prompt, caches, to_tensor):
    logits, caches = prefill(params, {"tokens": to_tensor(tokens[:, :prompt])}, caches)
    out = [logits]
    for t in range(prompt, tokens.shape[1]):
        logits, caches = decode(params, {"tokens": to_tensor(tokens[:, t:t + 1])}, caches)
        out.append(logits)
    return out, caches


def _compare_serving(cfg, jax_cfg, params, jax_params, prompt, steps, seed):
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, prompt + steps))
    tokens = tokens.astype(np.int32)
    s_cache = prompt + steps
    jprefill = jax.jit(lambda p, b, c: jax_model.prefill(p, jax_cfg, CTX, b, c))
    jdecode = jax.jit(lambda p, b, c: jax_model.decode_step(p, jax_cfg, CTX, b, c))
    jl, jc = _run(jprefill, jdecode, jax_params, tokens, prompt,
                  jax_model.init_caches(jax_cfg, B, s_cache), jnp.asarray)
    before = (dict(flash_ops.LAUNCHES), dict(decode_ops.LAUNCHES), dict(scan_ops.LAUNCHES))
    tl, tc = _run(make_prefill_step(cfg, device="cpu"), make_serve_step(cfg, device="cpu"),
                  params, tokens, prompt, M.init_caches(cfg, B, s_cache, device="cpu"),
                  lambda a: _t(a).long())
    assert (dict(flash_ops.LAUNCHES), dict(decode_ops.LAUNCHES), dict(scan_ops.LAUNCHES)) == before
    # The JAX model over the whole sequence, without caches.
    h, _, _ = jax_model.forward(jax_params, jax_cfg, CTX, {"tokens": jnp.asarray(tokens)})
    full = np.asarray(jax_model._logits(jax_params, jax_cfg, h))[..., :cfg.vocab_size]
    for i, (got, want) in enumerate(zip(tl, jl)):
        assert got.shape == (B, cfg.vocab_size)
        _close(got, want)
        _close(got, full[:, prompt - 1 + i])
    ref = caches_from_jax(jax.tree.map(np.asarray, jc), cfg, device="cpu")
    for seg_t, seg_r in zip(tc, ref):
        for et, er in zip(seg_t, seg_r):
            for a, b in zip(et, er):
                if isinstance(a, KVCache):
                    assert a.pos == b.pos == prompt + steps
                    assert a.k.shape[1] == min(s_cache, cfg.local_window)
                    _close(a.k, b.k)
                    _close(a.v, b.v)
                else:
                    _close(a.h, b.h)
                    _close(a.conv, b.conv)


def test_prefill_and_decode_steps_match_jax(params, jax_params, cfg, jax_cfg,
                                            jax_prefill_over_fresh_kv):
    """A 40-token prompt over a 32-slot ring, then 12 decode steps."""
    _compare_serving(cfg, jax_cfg, params, jax_params, prompt=40, steps=12, seed=5)


def test_ring_cache_wraps_correctly():
    """``local_window`` 8 (``tests/test_models.py:114``): a 4-token prompt,
    then 20 decode steps that wrap the ring twice; the JAX package's own
    paths, unpatched."""
    cfg = dataclasses.replace(get_config("recurrentgemma-2b").reduced(), local_window=8)
    jcfg = dataclasses.replace(jax_get_config("recurrentgemma-2b").reduced(), local_window=8)
    np_params = _np_params(jcfg, seed=2)
    _compare_serving(cfg, jcfg, params_from_jax(np_params, cfg, device="cpu"),
                     jax.tree.map(jnp.asarray, np_params), prompt=4, steps=20, seed=6)


def test_first_cache_pos_skips_recurrent_states(params, cfg):
    caches = M.init_caches(cfg, 1, 16, device="cpu")
    assert isinstance(caches[0][0][0], RGLRUState)
    assert M._first_cache_pos(caches) == 0
    _, caches = M.prefill(params, cfg, {"tokens": torch.arange(5)[None]}, caches, device="cpu")
    assert M._first_cache_pos(caches) == 5
    assert M._first_cache_pos([[[RGLRUState(h=torch.zeros(1), conv=torch.zeros(1))]]]) == 0


def test_serve_on_the_cpu_runs_the_reduced_model(cfg):
    before = (dict(flash_ops.LAUNCHES), dict(decode_ops.LAUNCHES), dict(scan_ops.LAUNCHES))
    res = serve(cfg, batch=2, prompt_len=36, gen_len=6, device="cpu")  # the ring wraps
    assert res.tokens.shape == (2, 6)
    assert int(res.tokens.min()) >= 0 and int(res.tokens.max()) < cfg.vocab_size
    assert (dict(flash_ops.LAUNCHES), dict(decode_ops.LAUNCHES), dict(scan_ops.LAUNCHES)) == before
    again = serve(cfg, batch=2, prompt_len=36, gen_len=6, device="cpu")
    assert torch.equal(res.tokens, again.tokens)

