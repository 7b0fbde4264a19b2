"""The MoE family on the card against the same weights on the CPU. Marked
``cuda``: they skip without a card. This file imports no JAX, so it runs
on a machine that has torch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_moe_cuda.py

Both sides run float32 (TF32 off on the card), so they differ only in the
order of sums: logits within 1e-4 of their max-abs, argmax equal.
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import model as M

B, P, STEPS = 2, 24, 4
REL_TOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _cfg(arch):
    # The reduced config at a head dim the attention kernels take.
    return dataclasses.replace(get_config(arch).reduced(), d_model=128, head_dim=64, n_heads=2,
                               n_kv_heads=1 if arch.startswith("granite") else 2)


def _rel(got, want):
    return float((got.cpu() - want).abs().max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "deepseek-v3-671b"])
def test_cuda_moe_model_matches_the_cpu(cuda_device, arch):
    cfg = _cfg(arch)
    params = M.init_params(cfg, seed=0, device="cuda")
    cpu_params = _to_cpu(params)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=torch.Generator().manual_seed(1))
    card_c = M.init_caches(cfg, B, P + STEPS, device="cuda")
    cpu_c = M.init_caches(cfg, B, P + STEPS, device="cpu")
    flash_ops.reset_launches()
    decode_ops.reset_launches()
    card_l, card_c = M.prefill(params, cfg, {"tokens": prompt}, card_c, device="cuda")
    cpu_l, cpu_c = M.prefill(cpu_params, cfg, {"tokens": prompt}, cpu_c, device="cpu")
    assert _rel(card_l, cpu_l) <= REL_TOL
    for _ in range(STEPS):
        tok = cpu_l.argmax(-1)[:, None]
        assert torch.equal(card_l.argmax(-1).cpu(), tok[:, 0])
        card_l, card_c = M.decode_step(params, cfg, {"tokens": tok}, card_c, device="cuda")
        cpu_l, cpu_c = M.decode_step(cpu_params, cfg, {"tokens": tok}, cpu_c, device="cpu")
        assert _rel(card_l, cpu_l) <= REL_TOL
    # GQA layers run the attention kernels; MLA runs its absorbed form.
    n_attn = 0 if cfg.use_mla else cfg.n_layers
    assert flash_ops.LAUNCHES["flash_attention"] == n_attn
    assert decode_ops.LAUNCHES["decode_attention"] == n_attn * STEPS


@pytest.mark.cuda
def test_cuda_mla_decode_equals_a_teacher_forced_prefill(cuda_device):
    """MLA's compressed cache on the card: every decode step's logits equal
    a prefill over the prompt and the tokens so far. The capacity factor
    E / k lets no expert drop a choice at either length, so both compute
    the same function."""
    cfg = _cfg("deepseek-v3-671b")
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    params = M.init_params(cfg, seed=2, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (B, P), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(3))
    caches = M.init_caches(cfg, B, P + STEPS, device="cuda")
    logits, caches = M.prefill(params, cfg, {"tokens": tokens}, caches, device="cuda")
    for _ in range(STEPS):
        tokens = torch.cat([tokens, logits.argmax(-1)[:, None]], dim=1)
        logits, caches = M.decode_step(params, cfg, {"tokens": tokens[:, -1:]}, caches,
                                       device="cuda")
        fresh = M.init_caches(cfg, B, tokens.shape[1], device="cuda")
        want, _ = M.prefill(params, cfg, {"tokens": tokens}, fresh, device="cuda")
        assert _rel(logits, want.cpu()) <= REL_TOL


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()
