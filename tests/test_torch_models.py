"""The port's dense model path against the JAX package's, on the CPU.

At ``qwen1.5-0.5b``'s reduced config (float32, 2 layers, d_model 64) the
JAX package's parameters, with random norms and biases drawn from a numpy
seed, are converted by ``params_from_jax``; then the layers,
``attention_block`` (prefill and decode), ``prefill`` and every
``decode_step`` must give the JAX package's results to 1e-5 (float32 on
both sides; only the order of sums differs), caches included.
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
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import attention, layers
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.serve_lm import serve

TOL = dict(atol=1e-5, rtol=1e-5)
# The JAX config's distribution and training knobs, which the port leaves out.
TPU_ONLY_FIELDS = {"moe_ep_mode", "opt_state_dtype", "remat",
                   "sequence_parallel", "zero3_use_site_gather", "fsdp_over_pod",
                   "attention_impl"}
CTX = MeshCtx(mesh=None)
B, P, STEPS = 2, 12, 8


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def cfg():
    return get_config("qwen1.5-0.5b").reduced()


@pytest.fixture(scope="module")
def jax_cfg():
    return jax_get_config("qwen1.5-0.5b").reduced()


@pytest.fixture(scope="module")
def np_params(jax_cfg):
    """JAX init, then random norm scales and biases (the init leaves them 0)."""
    rng = np.random.default_rng(0)
    tree = jax.tree.map(np.asarray, jax_model.init_params(jax.random.PRNGKey(0), jax_cfg))

    def perturb(path, a):
        name = jax.tree_util.keystr(path)
        if "norm" in name or "'b'" in name:
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(perturb, tree)


@pytest.fixture(scope="module")
def params(np_params, cfg):
    return params_from_jax(np_params, cfg, device="cpu")


@pytest.fixture(scope="module")
def jax_params(np_params):
    return jax.tree.map(jnp.asarray, np_params)


def _shared_fields(jcfg) -> dict:
    """The JAX config's fields that the port keeps, after checking that the
    rest are exactly its TPU-only knobs."""
    port = {f.name for f in dataclasses.fields(ModelConfig)}
    jax_fields = dataclasses.asdict(jcfg)
    assert set(jax_fields) - port == TPU_ONLY_FIELDS and port <= set(jax_fields)
    return {k: v for k, v in jax_fields.items() if k in port}


def test_config_is_the_jax_packages(cfg, jax_cfg):
    assert dataclasses.asdict(cfg) == _shared_fields(jax_cfg)
    full = get_config("qwen1.5-0.5b")
    assert (full.n_layers, full.d_model, full.n_heads, full.resolved_head_dim, full.d_ff,
            full.vocab_size, full.padded_vocab) == (24, 1024, 16, 64, 2816, 151936, 152064)
    assert get_config("qwen1_5_0_5b") is full
    for name in ("internlm2-1.8b", "yi-9b", "starcoder2-7b"):
        assert dataclasses.asdict(get_config(name)) == _shared_fields(jax_get_config(name))


PORTED_SINCE_MOE = ("deepseek-v3-671b", "granite-moe-1b-a400m")
PORTED_SINCE_XLSTM_WHISPER = ("xlstm-125m", "whisper-tiny")
PORTED_SINCE_VLM = ("qwen2-vl-72b",)


@pytest.mark.parametrize("name", ["deepseek-v3-671b", "granite-moe-1b-a400m",
                                  "xlstm-125m", "whisper-tiny", "qwen2-vl-72b"])
def test_unported_archs_raise_naming_the_roadmap(name):
    """The archs that the first slices could not run. The test keeps its name
    and its five cases although later slices ported all of them: each case
    checks that the registry returns the JAX package's config
    (tests/test_torch_moe_models.py, tests/test_torch_xlstm_whisper_models.py
    and tests/test_torch_vlm.py run them); an unknown name still raises."""
    assert name in PORTED_SINCE_MOE + PORTED_SINCE_XLSTM_WHISPER + PORTED_SINCE_VLM
    assert dataclasses.asdict(get_config(name)) == _shared_fields(jax_get_config(name))
    with pytest.raises(KeyError, match="unknown arch"):
        get_config(name + "-x")


def test_unsupported_blocks_raise(cfg, jax_cfg, monkeypatch):
    """Nothing is left to refuse: an M-RoPE config (the reduced sections
    (2, 3, 3)) initialises with the reference's parameter shapes, and its
    forward rotates by ``mrope`` tables built once, at the batch's
    (3, B, S) positions."""
    mcfg = dataclasses.replace(cfg, mrope_sections=(2, 3, 3))
    jcfg = dataclasses.replace(jax_cfg, mrope_sections=(2, 3, 3))
    port = M.init_params(mcfg, device="cpu")
    want = jax.eval_shape(lambda: jax_model.init_params(jax.random.PRNGKey(0), jcfg))
    stacked = jax.tree.map(lambda a: tuple(a.shape), want)["segments"][0][0]
    assert stacked == jax.tree.map(lambda t: (cfg.n_layers, *t.shape), port["segments"][0][0][0])
    assert tuple(port["embed"]["table"].shape) == tuple(want["embed"]["table"].shape)
    calls = []
    real = M.mrope

    def spy(positions, *args):
        calls.append(positions)
        return real(positions, *args)

    monkeypatch.setattr(M, "mrope", spy)
    tokens = torch.randint(0, cfg.vocab_size, (B, 5), generator=torch.Generator().manual_seed(0))
    pos3 = torch.randint(0, 50, (3, B, 5), generator=torch.Generator().manual_seed(1))
    h, _ = M.forward(port, mcfg, {"tokens": tokens, "mrope_positions": pos3})
    assert len(calls) == 1 and torch.equal(calls[0], pos3)
    # The text-only fallback (three equal streams) is plain RoPE.
    h_text, _ = M.forward(port, mcfg, {"tokens": tokens})
    h_rope, _ = M.forward(port, cfg, {"tokens": tokens})
    torch.testing.assert_close(h_text, h_rope, rtol=1e-6, atol=1e-6)
    assert not torch.allclose(h, h_text)


def test_params_from_jax_keeps_every_leaf(np_params, params, cfg):
    assert set(params) == set(np_params) == {"embed", "final_norm", "segments"}
    assert params["embed"]["table"].shape == (cfg.padded_vocab, cfg.d_model)
    layers_ = params["segments"][0][0]
    assert len(layers_) == cfg.n_layers
    for r, layer in enumerate(layers_):
        np.testing.assert_array_equal(layer["attn"]["wq"]["b"].numpy(),
                                      np_params["segments"][0][0]["attn"]["wq"]["b"][r])
    port = M.init_params(cfg, seed=3, device="cpu")
    same_shapes = jax.tree.map(lambda a: tuple(a.shape), port)
    want = jax.tree.map(lambda a: tuple(a.shape), params)
    assert same_shapes == want


def test_params_from_jax_takes_bfloat16(cfg):
    x = jnp.asarray(np.linspace(-3, 3, 64, dtype=np.float32), jnp.bfloat16)
    tree = {"embed": {"table": np.asarray(x).reshape(8, 8)}, "final_norm": np.asarray(x[:8]),
            "segments": [[{}]]}
    out = params_from_jax(tree, dataclasses.replace(cfg, n_layers=1), device="cpu")
    assert out["embed"]["table"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["embed"]["table"].float().numpy(),
                                  np.asarray(x, np.float32).reshape(8, 8))


def test_layers_match(params, jax_params, cfg):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, 5, cfg.d_model)).astype(np.float32)
    layer_j = jax.tree.map(lambda a: a[1], jax_params["segments"][0][0])
    layer_t = params["segments"][0][0][1]
    _close(layers.rms_norm(layer_t["norm1"], _t(x), cfg.norm_eps),
           jax_layers.rms_norm(layer_j["norm1"], jnp.asarray(x), cfg.norm_eps))
    _close(layers.mlp(layer_t["mlp"], _t(x)), jax_layers.mlp(layer_j["mlp"], jnp.asarray(x), CTX))
    pos = np.arange(40, 45)
    hx = rng.standard_normal((B, 5, cfg.n_heads, cfg.resolved_head_dim)).astype(np.float32)
    cos, sin = layers.rope(_t(pos), cfg.resolved_head_dim, cfg.rope_theta)
    jcos, jsin = jax_layers.rope(jnp.asarray(pos), cfg.resolved_head_dim, cfg.rope_theta)
    _close(cos, jcos)
    _close(layers.apply_rope(_t(hx), cos, sin), jax_layers.apply_rope(jnp.asarray(hx), jcos, jsin))
    _close(layers.embed_tokens(params["embed"], _t(np.array([[3, 7]]))),
           jax_layers.embed_tokens(jax_params["embed"], jnp.array([[3, 7]])))


def test_sdpa_and_flash_kernel_agree_with_jax_sdpa():
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 9, 4, 16), (2, 20, 2, 16), (2, 20, 2, 16)))
    valid = np.arange(20) < 14
    qpos = np.arange(5, 14)
    want = jax_attention.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                              q_positions=jnp.asarray(qpos), kv_valid=jnp.asarray(valid))
    got = attention.sdpa(_t(q), _t(k), _t(v), causal=True, q_positions=_t(qpos),
                         kv_valid=_t(valid))
    _close(got, want)
    # The prefill branch's kernel over the valid prefix is the same function.
    _close(flash_ops.flash_attention(_t(q), _t(k[:, :14]), _t(v[:, :14]), causal=True), want)


def _rope_fns(cfg):
    def jfn(x, positions):
        cos, sin = jax_layers.rope(positions, cfg.resolved_head_dim, cfg.rope_theta)
        return jax_layers.apply_rope(x, cos, sin)

    def tfn(x, positions):
        cos, sin = layers.rope(positions, cfg.resolved_head_dim, cfg.rope_theta)
        return layers.apply_rope(x, cos, sin)

    return jfn, tfn


def test_attention_block_prefill_and_decode(params, jax_params, cfg):
    rng = np.random.default_rng(4)
    p_t = params["segments"][0][0][0]["attn"]
    p_j = jax.tree.map(lambda a: a[0], jax_params["segments"][0][0])["attn"]
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim)
    jfn, tfn = _rope_fns(cfg)
    jcache = jax_attention.init_kv_cache(B, 16, cfg.n_kv_heads, cfg.resolved_head_dim, jnp.float32)
    tcache = attention.init_kv_cache(B, 16, cfg.n_kv_heads, cfg.resolved_head_dim, torch.float32,
                                     device="cpu")
    for Sq in (11, 1, 1):  # prefill at pos 0, then two decode steps
        x = rng.standard_normal((B, Sq, cfg.d_model)).astype(np.float32)
        jy, jcache = jax_attention.attention_block(p_j, jnp.asarray(x), CTX, rope_fn=jfn,
                                                   cache=jcache, **kw)
        ty, tcache = attention.attention_block(p_t, _t(x), rope_fn=tfn, cache=tcache, **kw)
        _close(ty, jy)
        assert tcache.pos == int(jcache.pos)
        _close(tcache.k, jcache.k)
        _close(tcache.v, jcache.v)
    x = rng.standard_normal((B, 5, cfg.d_model)).astype(np.float32)
    jy, _ = jax_attention.attention_block(p_j, jnp.asarray(x), CTX, rope_fn=jfn, **kw)
    ty, none = attention.attention_block(p_t, _t(x), rope_fn=tfn, **kw)
    assert none is None
    _close(ty, jy)


def test_attention_block_refuses_what_later_slices_bring(params, cfg):
    p = params["segments"][0][0][0]["attn"]
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim)
    cache = attention.init_kv_cache(1, 4, cfg.n_kv_heads, cfg.resolved_head_dim, torch.float32,
                                    device="cpu")
    x = torch.zeros(1, 3, cfg.d_model)
    # Local attention takes a ring of at most `window` slots (tests/test_torch_hybrid_model.py).
    with pytest.raises(ValueError, match="at most window=2"):
        attention.attention_block(p, x, window=2, cache=cache, **kw)
    # Cross-attention writes no cache: it comes back as given.
    kv = torch.ones(1, 5, cfg.n_kv_heads, cfg.resolved_head_dim)
    _, same = attention.attention_block(p, x, cross_kv=(kv, kv), cache=cache, **kw)
    assert same is cache and cache.pos == 0 and not bool(cache.k.any())
    _, cache = attention.attention_block(p, x, cache=cache, **kw)
    with pytest.raises(ValueError, match="cache full"):
        attention.attention_block(p, x, cache=cache, **kw)


def test_prefill_and_decode_steps_match_jax(params, jax_params, cfg, jax_cfg):
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab_size, size=(B, P)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab_size, size=(STEPS, B, 1)).astype(np.int32)
    s_cache = P + STEPS + 3
    jprefill = jax.jit(lambda p, b, c: jax_model.prefill(p, jax_cfg, CTX, b, c))
    jdecode = jax.jit(lambda p, b, c: jax_model.decode_step(p, jax_cfg, CTX, b, c))
    jcaches = jax_model.init_caches(jax_cfg, B, s_cache)
    tcaches = M.init_caches(cfg, B, s_cache, device="cpu")
    prefill, decode = make_prefill_step(cfg, device="cpu"), make_serve_step(cfg, device="cpu")

    jl, jcaches = jprefill(jax_params, {"tokens": jnp.asarray(prompt)}, jcaches)
    tl, tcaches = prefill(params, {"tokens": _t(prompt).long()}, tcaches)
    assert tl.shape == (B, cfg.vocab_size)
    _close(tl, jl)
    for i in range(STEPS):
        jl, jcaches = jdecode(jax_params, {"tokens": jnp.asarray(steps[i])}, jcaches)
        tl, tcaches = decode(params, {"tokens": steps[i]}, tcaches)
        _close(tl, jl)
    for r in range(cfg.n_layers):
        jc, tc = jcaches[0][0], tcaches[0][0][r]
        assert tc.pos == int(jc.pos[r]) == P + STEPS
        _close(tc.k, jc.k[r])
        _close(tc.v, jc.v[r])


def test_forward_without_caches_matches_jax(params, jax_params, cfg, jax_cfg):
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, size=(B, 7))
    jh, _, _ = jax_model.forward(jax_params, jax_cfg, CTX, {"tokens": jnp.asarray(tokens)})
    th, none = M.forward(params, cfg, {"tokens": _t(tokens)})
    assert none is None
    _close(th, jh)


def test_logits_mask_the_padded_vocab(params, cfg):
    h = torch.randn(1, 2, cfg.d_model)
    logits = M._logits(params, cfg, h)
    assert logits.shape[-1] == cfg.padded_vocab > cfg.vocab_size
    assert torch.all(logits[..., cfg.vocab_size:] == -1e30)


def test_serve_on_the_cpu_launches_no_kernel(cfg):
    before = (dict(flash_ops.LAUNCHES), dict(decode_ops.LAUNCHES))
    res = serve(cfg, batch=2, prompt_len=6, gen_len=4, device="cpu")
    assert res.tokens.shape == (2, 4)
    assert int(res.tokens.min()) >= 0 and int(res.tokens.max()) < cfg.vocab_size
    assert (dict(flash_ops.LAUNCHES), dict(decode_ops.LAUNCHES)) == before
    again = serve(cfg, batch=2, prompt_len=6, gen_len=4, device="cpu")
    assert torch.equal(res.tokens, again.tokens)


def test_init_is_seeded_and_in_the_config_dtype(cfg):
    a = M.init_params(cfg, seed=7, device="cpu")
    b = M.init_params(cfg, seed=7, device="cpu")
    assert torch.equal(a["segments"][0][0][1]["mlp"]["w_up"]["w"],
                       b["segments"][0][0][1]["mlp"]["w_up"]["w"])
    bf = M.init_params(dataclasses.replace(cfg, param_dtype="bfloat16"), seed=7, device="cpu")
    assert bf["embed"]["table"].dtype == torch.bfloat16
    assert M.init_caches(cfg, 1, 4, device="cpu")[0][0][0].k.dtype == torch.float32


def test_model_config_reduced_keeps_family_shapes():
    cfg = ModelConfig(name="x", family="dense", n_layers=24, d_model=1024, n_heads=16,
                      n_kv_heads=16, d_ff=2816, vocab_size=151_936)
    small = cfg.reduced()
    assert (small.n_layers, small.d_model, small.n_heads, small.head_dim, small.dtype) == (
        2, 64, 4, 16, "float32")
