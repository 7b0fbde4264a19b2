"""The port's Qwen2-VL backbone against the JAX package's, on the CPU.

``apply_mrope`` at random (3, B, S) positions up to 600 (float32, 1e-6), at
qwen2-vl-72b's head dim 128 with sections (16, 24, 24) and theta 1e6 and at
the reduced (2, 3, 3). Then the reduced qwen2-vl (2 layers, d_model 64, 4
heads of 16 on 4 KV heads, float32), the JAX package's parameters with
random norm scales and biases converted by ``params_from_jax``: a prefill
from ``embeds`` over one image's M-RoPE positions (text, a grid of patches,
text), decode steps from tokens with their positions, the text-only
fallback, embeddings taken unscaled, and ``serve`` — each against
``repro.models.model`` to 1e-5, caches included.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro.models.layers import MeshCtx
from repro_torch.configs import get_config
from repro_torch.models import attention, layers
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import caches_from_jax, params_from_jax
from repro_torch.serve_lm import serve

TOL = dict(atol=1e-5, rtol=1e-5)
CTX = MeshCtx(mesh=None)
TPU_ONLY_FIELDS = {"moe_ep_mode", "opt_state_dtype", "remat",
                   "sequence_parallel", "zero3_use_site_gather", "fsdp_over_pod",
                   "attention_impl"}
B, STEPS = 2, 6
# One image at the reduced size: 3 text positions, a 2 x 3 grid of merged
# patches, 4 text positions.
PRE, GRID, POST = 3, (2, 3), 4
P = PRE + GRID[0] * GRID[1] + POST


def image_positions(B, pre, grid, post, steps):
    """Qwen2-VL's M-RoPE positions for a prompt of ``pre`` text positions,
    one image of ``grid`` = (rows, cols) merged patches and ``post`` text
    positions, then ``steps`` decode steps: (3, B, prompt) and (3, B, steps).

    Text runs 0.. on all three streams; patch (r, c) takes t = pre,
    h = pre + r, w = pre + c; text after the image resumes at the largest
    position so far + 1, and decode steps go on from there. A copy of
    ``chip_smoke.py``'s ``image_positions``, which phase 17 serves.
    """
    rows, cols = grid
    text = torch.arange(pre)
    t = torch.full((rows * cols,), pre)
    h = pre + torch.arange(rows).repeat_interleave(cols)
    w = pre + torch.arange(cols).repeat(rows)
    after = pre + max(rows, cols)
    tail = after + torch.arange(post)
    streams = [torch.cat([text, s, tail]) for s in (t, h, w)]
    prompt = torch.stack(streams)[:, None, :].expand(3, B, -1)
    steps = (after + post + torch.arange(steps))[None, None, :].expand(3, B, -1)
    return prompt.contiguous(), steps.contiguous()


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("D,sections,theta", [(128, (16, 24, 24), 1e6), (16, (2, 3, 3), 1e6),
                                              (64, (8, 12, 12), 1e4)])
def test_apply_mrope_matches_jax(D, sections, theta):
    rng = np.random.default_rng(D)
    x = rng.standard_normal((2, 37, 3, D)).astype(np.float32)
    pos = rng.integers(0, 601, size=(3, 2, 37)).astype(np.int32)
    got = layers.apply_mrope(_t(x), _t(pos), sections, theta)
    want = jax_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), sections, theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    cos, sin = layers.mrope(_t(pos), D, sections, theta)
    assert cos.shape == sin.shape == (2, 37, D // 2) and cos.dtype == torch.float32
    with pytest.raises(ValueError, match="do not sum"):
        layers.mrope(_t(pos), D + 2, sections, theta)


def test_image_positions_follow_the_published_layout():
    """The phase 17 prompt: 16 text, a 20 x 20 grid, 96 text; decode at 132 + i."""
    prompt, steps = image_positions(8, 16, (20, 20), 96, 64)
    assert prompt.shape == (3, 8, 512) and steps.shape == (3, 8, 64)
    assert prompt[:, 0, :16].tolist() == [list(range(16))] * 3
    patch = prompt[:, 0, 16 + 20 * 7 + 5]  # row 7, column 5
    assert patch.tolist() == [16, 23, 21]
    assert prompt[:, 0, 416].tolist() == [36] * 3 and prompt[:, 0, -1].tolist() == [131] * 3
    assert steps[:, 0, 0].tolist() == [132] * 3 and steps[:, 3, -1].tolist() == [195] * 3
    from torch_paper_common import chip_smoke

    smoke = chip_smoke()
    pre, grid, post = smoke.VLM_IMAGE
    for got, want in zip(smoke.image_positions(torch, 8, pre, grid, post, 64), (prompt, steps)):
        assert torch.equal(got, want)
    for pre, grid, post in (smoke.VLM_CHECK_IMAGE, (PRE, GRID, POST)):
        for got, want in zip(smoke.image_positions(torch, 2, pre, grid, post, 8),
                             image_positions(2, pre, grid, post, 8)):
            assert torch.equal(got, want)


def _shared_fields(jcfg) -> dict:
    port = {f.name for f in dataclasses.fields(ModelConfig)}
    jax_fields = dataclasses.asdict(jcfg)
    assert set(jax_fields) - port == TPU_ONLY_FIELDS and port <= set(jax_fields)
    return {k: v for k, v in jax_fields.items() if k in port}


def test_get_config_is_the_jax_packages():
    full = get_config("qwen2-vl-72b")
    assert dataclasses.asdict(full) == _shared_fields(jax_get_config("qwen2-vl-72b"))
    assert dataclasses.asdict(full.reduced()) == _shared_fields(
        jax_get_config("qwen2-vl-72b").reduced())
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.resolved_head_dim,
            full.d_ff, full.vocab_size, full.mrope_sections, full.rope_theta) == (
        80, 8192, 64, 8, 128, 29568, 152064, (16, 24, 24), 1e6)
    assert full.embedding_inputs and full.qkv_bias and not full.tie_embeddings
    assert full.reduced().mrope_sections == (2, 3, 3)


@pytest.fixture(scope="module")
def vlm():
    """(jax cfg, port cfg, numpy tree, port params, jax params)."""
    jcfg, cfg = jax_get_config("qwen2-vl-72b").reduced(), get_config("qwen2-vl-72b").reduced()
    rng = np.random.default_rng(0)
    tree = jax.tree.map(np.asarray, jax_model.init_params(jax.random.PRNGKey(0), jcfg))

    def perturb(path, a):
        name = jax.tree_util.keystr(path)
        if "norm" in name or "'b'" in name:
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    return (jcfg, cfg, tree, params_from_jax(tree, cfg, device="cpu"),
            jax.tree.map(jnp.asarray, tree))


def test_params_from_jax_keeps_every_leaf(vlm):
    jcfg, cfg, tree, params, _ = vlm
    assert set(params) == set(tree) == {"embed", "final_norm", "lm_head", "segments"}
    layers_ = params["segments"][0][0]
    assert len(layers_) == cfg.n_layers == 2
    for r, layer in enumerate(layers_):
        for w in ("wq", "wk", "wv"):
            np.testing.assert_array_equal(layer["attn"][w]["b"].numpy(),
                                          tree["segments"][0][0]["attn"][w]["b"][r])
        np.testing.assert_array_equal(layer["mlp"]["w_down"]["w"].numpy(),
                                      tree["segments"][0][0]["mlp"]["w_down"]["w"][r])
    port = M.init_params(cfg, seed=3, device="cpu")
    assert jax.tree.map(lambda t: (tuple(t.shape), t.dtype), port) == jax.tree.map(
        lambda t: (tuple(t.shape), t.dtype), params)


def _prompt_embeds(params, cfg, seed):
    """Text rows embed_tokens(ids) * sqrt(d), as a decode step computes for a
    token; the image's rows stub embeddings at the same scale."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (B, P), generator=g)
    scale = cfg.d_model ** 0.5
    emb = params["embed"]["table"][ids] * scale
    n_img = GRID[0] * GRID[1]
    emb[:, PRE:PRE + n_img] = torch.randn(B, n_img, cfg.d_model, generator=g) * 0.02 * scale
    return emb


def _caches_close(tcaches, jcaches, cfg, pos):
    converted = caches_from_jax(jax.tree.map(np.asarray, jcaches), cfg, device="cpu")
    for tc, cc in zip(tcaches[0][0], converted[0][0], strict=True):
        assert isinstance(tc, attention.KVCache) and tc.pos == cc.pos == pos
        _close(tc.k, cc.k.numpy())
        _close(tc.v, cc.v.numpy())


@pytest.mark.parametrize("with_positions", [True, False], ids=["image", "text-only"])
def test_prefill_from_embeds_and_decode_steps_match_jax(vlm, with_positions):
    """A prefill from ``embeds`` (with the image's M-RoPE positions, or the
    text-only fallback without them), then decode steps from tokens, each
    with its positions where the prompt had them."""
    jcfg, cfg, _, params, jax_params = vlm
    emb = _prompt_embeds(params, cfg, 1)
    prompt_pos, step_pos = image_positions(B, PRE, GRID, POST, STEPS)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(STEPS, B, 1))
    s_cache = P + STEPS + 2
    jprefill = jax.jit(lambda p, b, c: jax_model.prefill(p, jcfg, CTX, b, c))
    jdecode = jax.jit(lambda p, b, c: jax_model.decode_step(p, jcfg, CTX, b, c))
    jcaches = jax_model.init_caches(jcfg, B, s_cache)
    tcaches = M.init_caches(cfg, B, s_cache, device="cpu")
    first = {"embeds": emb}
    if with_positions:
        first["mrope_positions"] = prompt_pos
    jl, jcaches = jprefill(jax_params, {k: jnp.asarray(v.numpy()) for k, v in first.items()},
                           jcaches)
    tl, tcaches = M.prefill(params, cfg, first, tcaches, device="cpu")
    assert tl.shape == (B, cfg.vocab_size)
    _close(tl, jl)
    for i in range(STEPS):
        step = {"tokens": tokens[i]}
        if with_positions:
            step["mrope_positions"] = step_pos[:, :, i:i + 1].numpy()
        jl, jcaches = jdecode(jax_params, {k: jnp.asarray(v) for k, v in step.items()}, jcaches)
        tl, tcaches = M.decode_step(params, cfg, step, tcaches, device="cpu")
        _close(tl, jl)
    _caches_close(tcaches, jcaches, cfg, P + STEPS)


def test_embeds_are_taken_unscaled(vlm):
    """``embeds`` enter as given; tokens are embedded and scaled by
    sqrt(d_model). The two agree where the embeddings are the scaled rows."""
    jcfg, cfg, _, params, jax_params = vlm
    ids = torch.randint(0, cfg.vocab_size, (B, 7), generator=torch.Generator().manual_seed(2))
    rows = params["embed"]["table"][ids]
    h_tok, _ = M.forward(params, cfg, {"tokens": ids})
    h_emb, _ = M.forward(params, cfg, {"embeds": rows * cfg.d_model ** 0.5})
    torch.testing.assert_close(h_emb, h_tok, rtol=1e-6, atol=1e-6)
    h_raw, _ = M.forward(params, cfg, {"embeds": rows})
    jh, _, _ = jax_model.forward(jax_params, jcfg, CTX, {"embeds": jnp.asarray(rows.numpy())})
    _close(h_raw, jh)
    assert not torch.allclose(h_raw, h_tok, atol=1e-3)
    # Without ``embedding_inputs`` the tokens are used, as the reference does.
    plain = dataclasses.replace(cfg, embedding_inputs=False)
    h_plain, _ = M.forward(params, plain, {"tokens": ids, "embeds": rows})
    torch.testing.assert_close(h_plain, h_tok, rtol=0, atol=0)


def test_serve_matches_jax_greedy_decode(vlm):
    """``serve`` from the image prompt equals the reference's prefill and
    greedy decode steps, fed their own tokens and positions."""
    jcfg, cfg, _, params, jax_params = vlm
    G = STEPS + 1
    emb = _prompt_embeds(params, cfg, 3)
    prompt_pos, step_pos = image_positions(B, PRE, GRID, POST, G - 1)
    res = serve(cfg, batch=B, prompt_len=P, gen_len=G, device="cpu", params=params,
                prompt_embeds=emb, mrope_positions=prompt_pos, decode_positions=step_pos)
    jcaches = jax_model.init_caches(jcfg, B, P + G)
    jl, jcaches = jax_model.prefill(jax_params, jcfg, CTX, {
        "embeds": jnp.asarray(emb.numpy()), "mrope_positions": jnp.asarray(prompt_pos.numpy())},
        jcaches)
    want = [np.asarray(jl).argmax(-1)]
    for i in range(G - 1):
        jl, jcaches = jax_model.decode_step(jax_params, jcfg, CTX, {
            "tokens": jnp.asarray(want[-1][:, None]),
            "mrope_positions": jnp.asarray(step_pos[:, :, i:i + 1].numpy())}, jcaches)
        want.append(np.asarray(jl).argmax(-1))
    np.testing.assert_array_equal(res.tokens.numpy(), np.stack(want, axis=1))
    with pytest.raises(ValueError, match="decode_positions"):
        serve(cfg, batch=B, prompt_len=P, gen_len=G, device="cpu", params=params,
              decode_positions=step_pos[:, :, 1:])


def test_serve_draws_stub_embeddings(vlm):
    """Without embeddings ``serve`` draws stub ones from its seed and uses
    the text-only fallback: the reference's prefill on the same stub gives
    the same first token."""
    jcfg, cfg, _, params, jax_params = vlm
    res = serve(cfg, batch=B, prompt_len=5, gen_len=3, device="cpu", params=params)
    again = serve(cfg, batch=B, prompt_len=5, gen_len=3, device="cpu", params=params)
    assert torch.equal(res.tokens, again.tokens) and res.tokens.shape == (B, 3)
    stub = torch.randn(B, 5, cfg.d_model, generator=torch.Generator().manual_seed(1))
    jl, _ = jax_model.prefill(jax_params, jcfg, CTX, {"embeds": jnp.asarray(stub.numpy())},
                              jax_model.init_caches(jcfg, B, 8))
    np.testing.assert_array_equal(res.tokens[:, 0].numpy(), np.asarray(jl).argmax(-1))
