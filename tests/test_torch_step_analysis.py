"""The port's step analyser and roofline terms against the JAX package's, on
the CPU.

* The cases of ``tests/test_roofline.py``: a plain matmul, a 7-step loop
  and a nested 5 x 3 loop, on meta tensors, with exact counts (an eager
  loop dispatches every iteration, where the reference multiplies while
  bodies by their trip counts);
* the units of ``roofline_terms`` on H100 constants, which are
  ``sched.fleet.H100_SXM``'s;
* collective payload bytes by kind over a fake process group;
* each arch's reduced forward FLOPs against ``analyze_hlo`` of the
  reference's jitted forward at the same shape (2 x 16 tokens): equal to
  1e-9 relative, except xlstm-125m, where the port counts exactly the
  products of its mLSTM chunk-end state update (the reference's
  three-operand einsums for C and n, which XLA lowers to a multiply and a
  reduction, not a dot).
"""

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCHS, get_config as jax_get_config
from repro.hlo_analysis import analyze_hlo
from repro.models import model as jax_model
from repro.models.layers import MeshCtx
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.roofline import H100_CONSTANTS, collective_bytes_of, roofline_terms
from repro_torch.sched.fleet import H100_SXM
from repro_torch.step_analysis import StepCosts, analyze_step

CTX = MeshCtx(mesh=None)


def _meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


def test_analyzer_counts_plain_matmul():
    c = analyze_step(lambda a, b: a @ b, _meta(256, 512), _meta(512, 128))
    assert c.matmul_flops == 2 * 256 * 512 * 128
    assert c.touched_bytes == 256 * 128 * 4
    assert c.collective_bytes == 0 and c.by_kind == {} and c.collective_counts == {}


def test_analyzer_counts_every_loop_step():
    def g(x, w):
        for i in range(w.shape[0]):
            x = x @ w[i]
        return x

    c = analyze_step(g, _meta(64, 64), _meta(7, 64, 64))
    assert c.matmul_flops == 7 * 2 * 64 ** 3


def test_analyzer_nested_loops():
    def g(x, w):
        for i in range(w.shape[0]):
            for _ in range(3):
                x = x @ w[i]
        return x

    c = analyze_step(g, _meta(32, 32), _meta(5, 32, 32))
    assert c.matmul_flops == 5 * 3 * 2 * 32 ** 3


def test_roofline_terms_units():
    assert H100_CONSTANTS == {"peak_flops": H100_SXM.peak_flops, "hbm_bw": H100_SXM.hbm_bw,
                              "ici_bw": H100_SXM.ici_bw}
    assert (H100_CONSTANTS["peak_flops"], H100_CONSTANTS["hbm_bw"],
            H100_CONSTANTS["ici_bw"]) == (989e12, 3.35e12, 50e9)
    t = roofline_terms(989e12, 3.35e12, 50e9)
    assert t["compute"] == pytest.approx(1.0)
    assert t["memory"] == pytest.approx(1.0)
    assert t["collective"] == pytest.approx(1.0)


def test_step_costs_add():
    a = StepCosts(1.0, 2.0, {"all-reduce": 2.0}, {"all-reduce": 1.0}, 3.0)
    a.add(StepCosts(1.0, 4.0, {"all-gather": 4.0}, {"all-gather": 1.0}, 1.0), mult=2)
    assert (a.matmul_flops, a.collective_bytes, a.touched_bytes) == (3.0, 10.0, 5.0)
    assert a.by_kind == {"all-reduce": 2.0, "all-gather": 8.0}
    assert a.collective_counts == {"all-reduce": 1.0, "all-gather": 2.0}


@pytest.fixture
def fake_group():
    """A fake process group of 4 ranks, destroyed after the test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()
        assert not dist.is_initialized()


def test_collective_bytes_by_kind(fake_group):
    """Each collective's result bytes, the reference's convention: an
    all-gather's gathered tensor, a reduce-scatter's shard."""
    import torch.distributed._functional_collectives as fc

    def step(x):
        y = fc.wait_tensor(fc.all_reduce(x, "sum", fake_group))
        z = fc.wait_tensor(fc.all_gather_single(x, 0, fake_group))
        w = fc.wait_tensor(fc.reduce_scatter_single(x, "sum", 0, fake_group))
        v = fc.wait_tensor(fc.all_to_all_single(x, None, None, fake_group))
        dist.all_reduce(x)
        return y, z, w, v

    got = collective_bytes_of(step, torch.ones(8, 4))
    assert got["by_kind"] == {"all-reduce": 2 * 128.0, "all-gather": 512.0,
                              "reduce-scatter": 32.0, "all-to-all": 128.0}
    assert got["counts"] == {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                             "all-to-all": 1.0}
    assert got["total"] == sum(got["by_kind"].values())
    assert got["matmul_flops"] == 0.0 and got["touched_bytes"] >= got["total"]


def _reference_forward_flops(jcfg, B, S):
    params = jax.eval_shape(lambda: jax_model.init_params(jax.random.PRNGKey(0), jcfg))
    batch = {}
    if jcfg.embedding_inputs:
        batch["embeds"] = jax.ShapeDtypeStruct((B, S, jcfg.d_model), jnp.float32)
    else:
        batch["tokens"] = jax.ShapeDtypeStruct((B, S), jnp.int32)
    if jcfg.is_encoder_decoder:
        batch["encoder_embeds"] = jax.ShapeDtypeStruct((B, jcfg.encoder_seq, jcfg.d_model),
                                                       jnp.float32)
    fwd = jax.jit(lambda p, b: jax_model.forward(p, jcfg, CTX, b)[0])
    return analyze_hlo(fwd.lower(params, batch).compile().as_text()).matmul_flops


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_flops_match_analyze_hlo(arch):
    B, S = 2, 16
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    want = _reference_forward_flops(jcfg, B, S)
    params = M.init_params(cfg, device="cpu")
    batch = {}
    if cfg.embedding_inputs:
        batch["embeds"] = torch.zeros(B, S, cfg.d_model)
    else:
        batch["tokens"] = torch.zeros(B, S, dtype=torch.int64)
    if cfg.is_encoder_decoder:
        batch["encoder_embeds"] = torch.zeros(B, cfg.encoder_seq, cfg.d_model)
    got = analyze_step(lambda: M.forward(params, cfg, batch)).matmul_flops
    if arch == "xlstm_125m":
        # The mLSTM chunk-end state update: C (D x D a head) and n (D a
        # head) over the chunk's S positions, in every mLSTM block.
        H, D = cfg.n_heads, 2 * cfg.d_model // cfg.n_heads
        n_mlstm = cfg.resolved_block_pattern.count("mlstm")
        want += n_mlstm * (2 * B * H * S * D * D + 2 * B * H * S * D)
    assert got == pytest.approx(want, rel=1e-9)
