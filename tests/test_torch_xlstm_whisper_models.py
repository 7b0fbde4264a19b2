"""The port's xLSTM and Whisper models against the JAX package's, on the CPU.

At the reduced configs of ``xlstm-125m`` (mLSTM, sLSTM, mLSTM; d_model 64,
tied embeddings, no FFN) and ``whisper-tiny`` (2 encoder and 2 decoder
layers, d_model 64, 4 heads of 16, 32 stub frames), float32: the JAX
package's parameters, with random norm scales drawn from a numpy seed, are
converted by ``params_from_jax``; ``prefill`` and every ``decode_step``
must then give the reference's logits to 1e-5, caches included. Whisper's
decode steps take the port's ``encode`` output (``encoder_out``, computed
once) where the reference's take ``encoder_embeds`` and re-run the
encoder every step; both give the same logits.
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
from repro_torch.models import attention, xlstm
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import caches_from_jax, params_from_jax
from repro_torch.serve_lm import serve

TOL = dict(atol=1e-5, rtol=1e-5)
CTX = MeshCtx(mesh=None)
ARCHS = ("xlstm-125m", "whisper-tiny")
B, STEPS = 2, 8
PROMPT = {"xlstm-125m": 12, "whisper-tiny": 4}  # Whisper: a 4-token start sequence
TPU_ONLY_FIELDS = {"moe_ep_mode", "opt_state_dtype", "remat",
                   "sequence_parallel", "zero3_use_site_gather", "fsdp_over_pod",
                   "attention_impl"}
CACHE_FIELDS = {xlstm.MLSTMState: ("C", "n", "m"), xlstm.SLSTMState: ("c", "n", "h", "m"),
                attention.KVCache: ("k", "v")}


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
        name = jax.tree_util.keystr(path)
        if "norm" in name or "'b'" in name:
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    return (jcfg, cfg, tree, params_from_jax(tree, cfg, device="cpu"),
            jax.tree.map(jnp.asarray, tree))


def _frames(cfg, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def _batch(cfg, tokens, frames, to):
    batch = {"tokens": to(tokens)}
    if cfg.is_encoder_decoder:
        batch["encoder_embeds"] = to(frames)
    return batch


def _shared_fields(jcfg) -> dict:
    port = {f.name for f in dataclasses.fields(ModelConfig)}
    jax_fields = dataclasses.asdict(jcfg)
    assert set(jax_fields) - port == TPU_ONLY_FIELDS and port <= set(jax_fields)
    return {k: v for k, v in jax_fields.items() if k in port}


@pytest.mark.parametrize("name", ARCHS)
def test_get_config_is_the_jax_packages(name):
    full = get_config(name)
    assert dataclasses.asdict(full) == _shared_fields(jax_get_config(name))
    assert dataclasses.asdict(full.reduced()) == _shared_fields(jax_get_config(name).reduced())
    if name == "whisper-tiny":
        assert (full.encoder_layers, full.encoder_seq, full.n_layers, full.d_model,
                full.resolved_head_dim, full.padded_vocab) == (4, 1500, 4, 384, 64, 52224)
    else:
        assert full.resolved_block_pattern == ("mlstm", "slstm") * 6 and full.d_ff == 0


def test_params_from_jax_keeps_every_leaf(arch):
    jcfg, cfg, tree, params, _ = arch
    want = {"embed", "final_norm", "segments"} | ({"encoder"} if cfg.is_encoder_decoder else set())
    assert set(params) == set(tree) == want
    n_port = 0
    for path, leaf in _leaves(params):
        # [segment][pattern entry][repeat] -> the stacked axis, the encoder's too.
        stacked = path[0] == "segments" or path[:2] == ("encoder", "segments")
        head = 1 if path[0] == "segments" else 2
        if stacked:
            s, i, r, *rest = path[head:]
            node = tree[path[0]] if head == 1 else tree["encoder"]["segments"]
            node = node[s][i]
        else:
            node, rest, r = tree, path, None
        for k in rest:
            node = node[k]
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(node) if r is None
                                      else np.asarray(node)[r])
        n_port += 1
    n_ref = sum(a.shape[0] if any(getattr(k, "key", None) == "segments" for k in p) else 1
                for p, a in jax.tree_util.tree_flatten_with_path(tree)[0])
    assert n_port == n_ref
    if cfg.is_encoder_decoder:
        assert len(params["encoder"]["segments"][0][0]) == cfg.encoder_layers
        block = params["segments"][0][0][0]
        assert {"cross_norm", "cross", "mlp"} <= set(block)
        assert "cross" not in params["encoder"]["segments"][0][0][0]
    else:
        blocks = [b for seg in params["segments"] for entry in seg for b in entry]
        assert [set(b) for b in blocks] == [{"norm1", "cell"}] * 3
    port = M.init_params(cfg, seed=3, device="cpu")
    assert [(p, tuple(t.shape), t.dtype) for p, t in _leaves(port)] == [
        (p, tuple(t.shape), t.dtype) for p, t in _leaves(params)]


def _caches_close(tcaches, jcaches, cfg, pos):
    converted = caches_from_jax(jax.tree.map(np.asarray, jcaches), cfg, device="cpu")
    for seg_t, seg_c in zip(tcaches, converted, strict=True):
        for entry_t, entry_c in zip(seg_t, seg_c, strict=True):
            for tc, cc in zip(entry_t, entry_c, strict=True):
                assert type(tc) is type(cc)
                if isinstance(tc, attention.KVCache):
                    assert tc.pos == cc.pos == pos
                for f in CACHE_FIELDS[type(tc)]:
                    _close(getattr(tc, f), getattr(cc, f).numpy())


def test_prefill_and_decode_steps_match_jax(arch):
    jcfg, cfg, _, params, jax_params = arch
    rng = np.random.default_rng(5)
    P = PROMPT[cfg.name.removesuffix("-smoke")]
    prompt = rng.integers(0, cfg.vocab_size, size=(B, P)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab_size, size=(STEPS, B, 1)).astype(np.int32)
    frames = _frames(cfg)
    s_cache = P + STEPS + 3
    jprefill = jax.jit(lambda p, b, c: jax_model.prefill(p, jcfg, CTX, b, c))
    jdecode = jax.jit(lambda p, b, c: jax_model.decode_step(p, jcfg, CTX, b, c))
    jcaches = jax_model.init_caches(jcfg, B, s_cache)
    tcaches = M.init_caches(cfg, B, s_cache, device="cpu")
    jl, jcaches = jprefill(jax_params, _batch(cfg, prompt, frames, jnp.asarray), jcaches)
    tl, tcaches = M.prefill(params, cfg, _batch(cfg, _t(prompt).long(), frames, _t), tcaches,
                            device="cpu")
    assert tl.shape == (B, cfg.vocab_size)
    _close(tl, jl)
    extra = {"encoder_out": M.encode(params, cfg, _t(frames))} if cfg.is_encoder_decoder else {}
    for i in range(STEPS):
        jl, jcaches = jdecode(jax_params, _batch(cfg, steps[i], frames, jnp.asarray), jcaches)
        tl, tcaches = M.decode_step(params, cfg, {"tokens": steps[i], **extra}, tcaches,
                                    device="cpu")
        _close(tl, jl)
    _caches_close(tcaches, jcaches, cfg, P + STEPS)


def test_decode_from_converted_jax_caches(arch):
    """Prefill in the JAX package, convert its caches (``MLSTMState``,
    ``SLSTMState``, ``KVCache``), decode in the port."""
    jcfg, cfg, _, params, jax_params = arch
    P = PROMPT[cfg.name.removesuffix("-smoke")]
    prompt = np.random.default_rng(8).integers(0, cfg.vocab_size, size=(B, P)).astype(np.int32)
    frames = _frames(cfg, seed=9)
    jl, jcaches = jax_model.prefill(jax_params, jcfg, CTX, _batch(cfg, prompt, frames,
                                                                  jnp.asarray),
                                    jax_model.init_caches(jcfg, B, P + 2))
    tcaches = caches_from_jax(jax.tree.map(np.asarray, jcaches), cfg, device="cpu")
    kinds = {type(c) for seg in tcaches for entry in seg for c in entry}
    assert kinds == ({attention.KVCache} if cfg.is_encoder_decoder
                     else {xlstm.MLSTMState, xlstm.SLSTMState})
    tok = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)
    jl, _ = jax_model.decode_step(jax_params, jcfg, CTX, _batch(cfg, tok, frames, jnp.asarray),
                                  jcaches)
    tl, _ = M.decode_step(params, cfg, _batch(cfg, tok, frames, _t), tcaches, device="cpu")
    _close(tl, jl)


def test_forward_without_caches_matches_jax(arch):
    jcfg, cfg, _, params, jax_params = arch
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, size=(B, 7))
    frames = _frames(cfg, seed=6)
    jh, _, _ = jax_model.forward(jax_params, jcfg, CTX, _batch(cfg, tokens, frames, jnp.asarray))
    th, none = M.forward(params, cfg, _batch(cfg, _t(tokens), frames, _t))
    assert none is None
    _close(th, jh)


def test_serve_on_the_cpu(arch):
    _, cfg, _, _, _ = arch
    res = serve(cfg, batch=2, prompt_len=4, gen_len=4, device="cpu")
    assert res.tokens.shape == (2, 4)
    assert int(res.tokens.min()) >= 0 and int(res.tokens.max()) < cfg.vocab_size
    again = serve(cfg, batch=2, prompt_len=4, gen_len=4, device="cpu")
    assert torch.equal(res.tokens, again.tokens)


# ---------------------------------------------------------------------------
# Whisper's parts
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def whisper():
    jcfg = jax_get_config("whisper-tiny").reduced()
    cfg = get_config("whisper-tiny").reduced()
    rng = np.random.default_rng(1)
    tree = jax.tree.map(np.asarray, jax_model.init_params(jax.random.PRNGKey(1), jcfg))
    tree = jax.tree_util.tree_map_with_path(
        lambda p, a: (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if "norm" in jax.tree_util.keystr(p) else a, tree)
    return jcfg, cfg, params_from_jax(tree, cfg, device="cpu"), jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("d,n", [(64, 40), (384, 1500)])
def test_sinusoidal_matches_jax(d, n):
    """At the reduced width and at whisper-tiny's 1 500 frames of 384; the
    angles reach 1 499 radians there, where one float32 ulp of the angle
    is 1.2e-4, so the full size is held to 2e-4."""
    pos = np.arange(n, dtype=np.int32)
    want = np.asarray(jax_model._sinusoidal(jnp.asarray(pos), d))
    got = M._sinusoidal(_t(pos), d)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, d)
    tol = TOL if n < 64 else dict(atol=2e-4, rtol=0)
    np.testing.assert_allclose(got.numpy(), want, **tol)


def test_encoder_output_matches_jax(whisper):
    """``encode``: the reference's encoder branch of ``forward`` (frames plus
    sinusoidal positions, bidirectional blocks without rotary, the final
    norm)."""
    jcfg, cfg, params, jax_params = whisper
    frames = _frames(cfg, seed=11)
    S = frames.shape[1]
    enc = jnp.asarray(frames) + jax_model._sinusoidal(jnp.arange(S), jcfg.d_model)[None]
    enc_segs = [((jax_model.Signature(kind="attn", moe=False, cross=False),),
                 jcfg.encoder_layers)]
    out, _, _ = jax_model._run_segments(
        jax_params["encoder"]["segments"], enc_segs, enc, CTX, jcfg, None, rope_fn=None,
        positions=None, encoder_out=None, causal=False)
    want = jax_layers.rms_norm(jax_params["encoder"]["final_norm"], out, jcfg.norm_eps)
    got = M.encode(params, cfg, _t(frames))
    assert tuple(got.shape) == (B, cfg.encoder_seq, cfg.d_model)
    _close(got, want)
    # The encoder is bidirectional: its first frame sees the last one.
    moved = frames.copy()
    moved[:, -1] += 1.0
    assert not torch.allclose(M.encode(params, cfg, _t(moved))[:, 0], got[:, 0])


@pytest.mark.parametrize("Sq", [5, 1])
def test_cross_attention_block_matches_jax(whisper, Sq):
    """``attention_block`` with ``cross_kv``: no rope, no cache write, every
    query over every frame (B3 without a mask for Sq > 1, B4 over all
    frames for one token); the cache comes back as given."""
    jcfg, cfg, params, jax_params = whisper
    p_t = params["segments"][0][0][1]["cross"]
    p_j = jax.tree.map(lambda a: a[1], jax_params["segments"][0][0])["cross"]
    rng = np.random.default_rng(12 + Sq)
    H, D = cfg.n_heads, cfg.resolved_head_dim
    x = rng.standard_normal((B, Sq, cfg.d_model)).astype(np.float32)
    k, v = (rng.standard_normal((B, cfg.encoder_seq, H, D)).astype(np.float32)
            for _ in range(2))
    kw = dict(n_heads=H, n_kv_heads=H, head_dim=D)
    jy, jcache = jax_attention.attention_block(p_j, jnp.asarray(x), CTX,
                                               cross_kv=(jnp.asarray(k), jnp.asarray(v)), **kw)
    cache = attention.init_kv_cache(B, 8, H, D, torch.float32, device="cpu")
    ty, tcache = attention.attention_block(p_t, _t(x), cross_kv=(_t(k), _t(v)), cache=cache,
                                           **kw)
    assert jcache is None and tcache is cache and cache.pos == 0
    assert not bool(cache.k.any())
    _close(ty, jy)


def test_prefill_takes_encoder_out_or_embeds(whisper):
    """A prefill given the encoder's output equals one given its frames."""
    _, cfg, params, _ = whisper
    frames = _t(_frames(cfg, seed=13))
    tokens = torch.randint(0, cfg.vocab_size, (B, 4), generator=torch.Generator().manual_seed(0))
    a, _ = M.prefill(params, cfg, {"tokens": tokens, "encoder_embeds": frames},
                     M.init_caches(cfg, B, 6, device="cpu"), device="cpu")
    b, _ = M.prefill(params, cfg, {"tokens": tokens, "encoder_out": M.encode(params, cfg, frames)},
                     M.init_caches(cfg, B, 6, device="cpu"), device="cpu")
    assert torch.equal(a, b)


def test_profile_stages_label_the_recurrences_and_whisper(whisper):
    """``launch/profile_serve.stages`` wraps xLSTM's recurrences and
    Whisper's encoder and cross-attention in profiler ranges while open, and
    restores the functions after."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import profile_serve

    _, wcfg, wparams, _ = whisper
    xcfg = get_config("xlstm-125m").reduced()
    xparams = M.init_params(xcfg, device="cpu")
    before = (xlstm._slstm_scan, M.encode, M._cross_sublayer)
    tokens = torch.randint(0, 256, (B, 4), generator=torch.Generator().manual_seed(0))
    with profile_serve.stages(), profile(activities=[ProfilerActivity.CPU]) as prof:
        caches = M.init_caches(xcfg, B, 5, device="cpu")
        logits, caches = M.prefill(xparams, xcfg, {"tokens": tokens}, caches, device="cpu")
        M.decode_step(xparams, xcfg, {"tokens": logits.argmax(-1)[:, None]}, caches,
                      device="cpu")
        M.prefill(wparams, wcfg, {"tokens": tokens, "encoder_embeds": _t(_frames(wcfg))},
                  M.init_caches(wcfg, B, 4, device="cpu"), device="cpu")
    names = {e.name for e in prof.events()}
    assert {"xlstm.mlstm_chunks", "xlstm.mlstm_decode", "xlstm.slstm_loop", "whisper.encoder",
            "whisper.cross_attention"} <= names
    assert (xlstm._slstm_scan, M.encode, M._cross_sublayer) == before
    # On the CPU no port kernel launches, so none is noted.
    assert profile_serve._LAUNCHED == [] and profile_serve._OPEN == []


def test_port_calls_are_matched_to_the_trace_in_launch_order():
    """B4 launches a split and a combine kernel a call: each call's device
    time is the sum of its kernels, in start order."""
    from repro_torch.launch.profile_serve import port_call_ms

    spans = [(0, 5, "decode_attention_split_kernel<bf16>"), (5, 7, "gemm"),
             (7, 8, "decode_attention_combine_kernel"), (9, 12, "flash_attention_mma_kernel"),
             (12, 16, "decode_attention_split_kernel<bf16>"),
             (16, 18, "decode_attention_combine_kernel")]
    assert port_call_ms(spans, "decode_attention", "decode_attention_combine") == [6e-3, 6e-3]
    assert port_call_ms(spans, "flash_attention", "flash_attention") == [3e-3]
