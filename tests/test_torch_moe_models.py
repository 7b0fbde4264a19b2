"""The port's MoE models against the JAX package's, on the CPU.

At the reduced configs of ``granite-moe-1b-a400m`` (2 MoE layers of 8
experts top-2, tied embeddings) and ``deepseek-v3-671b`` (a dense layer
and a MoE layer with a shared expert, MLA, an untied ``lm_head`` and the
MTP head's parameters), float32, d_model 64: the JAX package's
parameters, with random norm scales drawn from a numpy seed, are
converted by ``params_from_jax``; ``prefill`` and every ``decode_step``
must then give the reference's logits to 1e-5, caches included (a
prompt of 2 x 12 tokens overflows an expert's capacity of 7 slots, so
prefill drops choices as the reference does).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model as jax_model
from repro.models.layers import MeshCtx
from repro_torch.configs import get_config
from repro_torch.models import mla, moe
from repro_torch.models import model as M
from repro_torch.models.convert import caches_from_jax, params_from_jax
from repro_torch.serve_lm import serve

TOL = dict(atol=1e-5, rtol=1e-5)
CTX = MeshCtx(mesh=None)
ARCHS = ("granite-moe-1b-a400m", "deepseek-v3-671b")
B, P, STEPS = 2, 12, 8


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _leaves(tree, path=()):
    """(path, leaf) pairs of a port tree, lists of repeats included."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(jax cfg, port cfg, numpy tree, port params, jax params) of one arch."""
    name = request.param
    jcfg, cfg = jax_get_config(name).reduced(), get_config(name).reduced()
    rng = np.random.default_rng(0)
    tree = jax.tree.map(np.asarray, jax_model.init_params(jax.random.PRNGKey(0), jcfg))

    def perturb(path, a):
        if "norm" in jax.tree_util.keystr(path):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    return jcfg, cfg, tree, params_from_jax(tree, cfg, device="cpu"), jax.tree.map(jnp.asarray,
                                                                                  tree)


def test_params_from_jax_keeps_every_leaf(arch):
    jcfg, cfg, tree, params, _ = arch
    want = {"embed", "final_norm", "segments"}
    if cfg.use_mla:
        want |= {"lm_head", "mtp"}
    assert set(params) == set(tree) == want
    n_port = 0
    for path, leaf in _leaves(params):
        if path[0] == "segments":  # [segment][pattern entry][repeat] -> stacked axis
            s, i, r, *rest = path[1:]
            node = tree["segments"][s][i]
            for k in rest:
                node = node[k]
            want_leaf = np.asarray(node)[r]
        else:
            node = tree
            for k in path:
                node = node[k]
            want_leaf = np.asarray(node)
        np.testing.assert_array_equal(leaf.numpy(), want_leaf)
        n_port += 1
    n_ref = sum(a.shape[0] if p[0].key == "segments" else 1
                for p, a in jax.tree_util.tree_flatten_with_path(tree)[0])
    assert n_port == n_ref
    if cfg.use_mla:
        assert params["mtp"]["block"]["attn"]["wkv_a"]["w"].shape == (
            cfg.d_model, cfg.kv_lora_rank + cfg.qk_rope_dim)
        moe_layer = params["segments"][0][1][0]["moe"]
        assert set(moe_layer) == {"router", "experts", "shared"}
    # The port's own init draws the same tree.
    port = M.init_params(cfg, seed=3, device="cpu")
    assert [(p, tuple(t.shape), t.dtype) for p, t in _leaves(port)] == [
        (p, tuple(t.shape), t.dtype) for p, t in _leaves(params)]


def test_prefill_and_decode_steps_match_jax(arch):
    jcfg, cfg, _, params, jax_params = arch
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab_size, size=(B, P)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab_size, size=(STEPS, B, 1)).astype(np.int32)
    s_cache = P + STEPS + 3
    jprefill = jax.jit(lambda p, b, c: jax_model.prefill(p, jcfg, CTX, b, c))
    jdecode = jax.jit(lambda p, b, c: jax_model.decode_step(p, jcfg, CTX, b, c))
    jcaches = jax_model.init_caches(jcfg, B, s_cache)
    tcaches = M.init_caches(cfg, B, s_cache, device="cpu")
    jl, jcaches = jprefill(jax_params, {"tokens": jnp.asarray(prompt)}, jcaches)
    tl, tcaches = M.prefill(params, cfg, {"tokens": _t(prompt).long()}, tcaches, device="cpu")
    assert tl.shape == (B, cfg.vocab_size)
    _close(tl, jl)
    for i in range(STEPS):
        jl, jcaches = jdecode(jax_params, {"tokens": jnp.asarray(steps[i])}, jcaches)
        tl, tcaches = M.decode_step(params, cfg, {"tokens": steps[i]}, tcaches, device="cpu")
        _close(tl, jl)
    # The caches the JAX package holds, converted, are the port's.
    converted = caches_from_jax(jax.tree.map(np.asarray, jcaches), cfg, device="cpu")
    kind = mla.MLACache if cfg.use_mla else M.attn_lib.KVCache
    fields = ("latent", "k_rope") if cfg.use_mla else ("k", "v")
    for seg_t, seg_c in zip(tcaches, converted):
        for entry_t, entry_c in zip(seg_t, seg_c):
            for tc, cc in zip(entry_t, entry_c):
                assert isinstance(tc, kind) and isinstance(cc, kind)
                assert tc.pos == cc.pos == P + STEPS
                for f in fields:
                    _close(getattr(tc, f), getattr(cc, f).numpy())


def test_prefill_drops_choices_as_the_reference_does(arch):
    """The prompt above overflows an expert: a 24-token prefill has 7 slots
    an expert for 48 choices over 8 experts, so some choices are dropped."""
    _, cfg, _, params, _ = arch
    assert moe.capacity(cfg, B * P) == 7 and moe.capacity(cfg, B) == 4
    seen = []
    real = moe._slot_tables

    def recording(ids, E, C):
        out = real(ids, E, C)
        seen.append((ids.shape[0], C, int((~out[2]).sum())))
        return out

    moe._slot_tables = recording
    try:
        prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(B, P))
        M.prefill(params, cfg, {"tokens": prompt}, M.init_caches(cfg, B, P, device="cpu"),
                  device="cpu")
    finally:
        moe._slot_tables = real
    assert all(t == B * P and C == 7 for t, C, _ in seen) and seen
    assert sum(dropped for _, _, dropped in seen) > 0


def test_decode_from_converted_jax_caches(arch):
    """Prefill in the JAX package, convert its caches, decode in the port."""
    jcfg, cfg, _, params, jax_params = arch
    prompt = np.random.default_rng(8).integers(0, cfg.vocab_size, size=(B, P)).astype(np.int32)
    jl, jcaches = jax_model.prefill(jax_params, jcfg, CTX, {"tokens": jnp.asarray(prompt)},
                                    jax_model.init_caches(jcfg, B, P + 2))
    tcaches = caches_from_jax(jax.tree.map(np.asarray, jcaches), cfg, device="cpu")
    tok = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)
    jl, _ = jax_model.decode_step(jax_params, jcfg, CTX, {"tokens": jnp.asarray(tok)}, jcaches)
    tl, _ = M.decode_step(params, cfg, {"tokens": tok}, tcaches, device="cpu")
    _close(tl, jl)


def test_forward_without_caches_matches_jax(arch):
    jcfg, cfg, _, params, jax_params = arch
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, size=(B, 7))
    jh, _, _ = jax_model.forward(jax_params, jcfg, CTX, {"tokens": jnp.asarray(tokens)})
    th, none = M.forward(params, cfg, {"tokens": _t(tokens)})
    assert none is None
    _close(th, jh)


def test_serve_on_the_cpu(arch):
    _, cfg, _, _, _ = arch
    res = serve(cfg, batch=2, prompt_len=6, gen_len=4, device="cpu")
    assert res.tokens.shape == (2, 4)
    assert int(res.tokens.min()) >= 0 and int(res.tokens.max()) < cfg.vocab_size
    again = serve(cfg, batch=2, prompt_len=6, gen_len=4, device="cpu")
    assert torch.equal(res.tokens, again.tokens)
