"""Qwen2-VL's backbone and the serving planner on the card against the CPU.
Marked ``cuda``: they skip without a card. This file imports no JAX, so it
runs on a machine that has torch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_vlm_cuda.py

The model is the reduced qwen2-vl widened to the full model's attention
shape (8 query heads on 1 KV head of 128, M-RoPE sections (16, 24, 24)):
a prefill from embeddings over one image's M-RoPE positions runs B3 once a
layer, each decode step from tokens B4 once a layer. Both sides run
float32 (TF32 off on the card), so they differ only in the order of sums:
logits within 1e-4 of their max-abs, argmax equal. The planner's ``plan``
on the card (``refine``'s sweeps on B1) must equal its CPU run.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.sched_scoring import ops as scoring_ops
from repro_torch.models import model as M
from repro_torch.sched.planner import plan
from repro_torch.serve_lm import FLEET

B, STEPS = 2, 4
REL_TOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _rel(got, want):
    return float((got.cpu() - want).abs().max() / want.abs().max())


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


def _positions(pre, rows, cols, post):
    """One image's M-RoPE positions (3, B, prompt) and the next position."""
    text = torch.arange(pre)
    streams = (torch.full((rows * cols,), pre), pre + torch.arange(rows).repeat_interleave(cols),
               pre + torch.arange(cols).repeat(rows))
    after = pre + max(rows, cols)
    tail = after + torch.arange(post)
    pos = torch.stack([torch.cat([text, s, tail]) for s in streams])
    return pos[:, None, :].expand(3, B, -1).contiguous(), after + post


@pytest.mark.cuda
def test_cuda_vlm_matches_the_cpu(cuda_device):
    cfg = dataclasses.replace(get_config("qwen2-vl-72b").reduced(), d_model=256, n_heads=8,
                              n_kv_heads=1, head_dim=128, mrope_sections=(16, 24, 24))
    params = M.init_params(cfg, seed=0, device="cuda")
    cpu_params = _to_cpu(params)
    pos, nxt = _positions(5, 6, 7, 9)
    P = pos.shape[-1]
    emb = torch.randn(B, P, cfg.d_model, generator=torch.Generator().manual_seed(1))
    card_c = M.init_caches(cfg, B, P + STEPS, device="cuda")
    cpu_c = M.init_caches(cfg, B, P + STEPS, device="cpu")
    flash_ops.reset_launches()
    decode_ops.reset_launches()
    card_l, card_c = M.prefill(params, cfg, {"embeds": emb.cuda(), "mrope_positions": pos},
                               card_c, device="cuda")
    cpu_l, cpu_c = M.prefill(cpu_params, cfg, {"embeds": emb, "mrope_positions": pos}, cpu_c,
                             device="cpu")
    assert _rel(card_l, cpu_l) <= REL_TOL
    for i in range(STEPS):
        tok = card_l.argmax(-1)[:, None].cpu()
        assert torch.equal(tok[:, 0], cpu_l.argmax(-1))
        step = {"tokens": tok, "mrope_positions": torch.full((3, B, 1), nxt + i)}
        card_l, card_c = M.decode_step(params, cfg, step, card_c, device="cuda")
        cpu_l, cpu_c = M.decode_step(cpu_params, cfg, step, cpu_c, device="cpu")
        assert _rel(card_l, cpu_l) <= REL_TOL
    assert flash_ops.LAUNCHES["flash_attention"] == cfg.n_layers
    assert decode_ops.LAUNCHES["decode_attention"] == cfg.n_layers * STEPS


@pytest.mark.cuda
def test_cuda_plan_matches_the_cpu(cuda_device):
    launched = set()
    for arch in ARCHS:
        scoring_ops.reset_launches()
        card = plan(get_config(arch), FLEET, device="cuda")
        if scoring_ops.LAUNCHES["sched_scoring"]:
            launched.add(arch)
        cpu = plan(get_config(arch), FLEET, device="cpu")
        np.testing.assert_array_equal(card.replicas, cpu.replicas)
        for a, b in zip(card.assignment, cpu.assignment, strict=True):
            np.testing.assert_array_equal(a, b)
        assert (card.tokens_per_s, card.baseline_tokens_per_s, card.iterations) == (
            cpu.tokens_per_s, cpu.baseline_tokens_per_s, cpu.iterations)
    assert launched == {"recurrentgemma_2b", "granite_moe_1b_a400m", "xlstm_125m",
                        "whisper_tiny", "starcoder2_7b", "qwen2_vl_72b"}
