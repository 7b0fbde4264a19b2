"""xLSTM and Whisper on the card against the same weights on the CPU.
Marked ``cuda``: they skip without a card. This file imports no JAX, so it
runs on a machine that has torch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_xlstm_whisper_cuda.py

Both sides run float32 (TF32 off on the card), so they differ only in the
order of sums: logits within 1e-4 of their max-abs, argmax equal. Whisper's
encoder self-attention and its cross-attention prefill run B3, its decode
steps B4 over every frame; xLSTM runs no attention kernel.
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import model as M

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


def _cfg(arch):
    cfg = get_config(arch).reduced()
    if cfg.is_encoder_decoder:
        # A head dim the attention kernels take; 100 frames leave a ragged tail.
        return dataclasses.replace(cfg, d_model=128, head_dim=64, n_heads=2, n_kv_heads=2,
                                   encoder_seq=100)
    return cfg


def _rel(got, want):
    return float((got.cpu() - want).abs().max() / want.abs().max())


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("arch,prompt_len", [("xlstm-125m", 24), ("xlstm-125m", 512),
                                             ("whisper-tiny", 4)])
def test_cuda_model_matches_the_cpu(cuda_device, arch, prompt_len):
    cfg = _cfg(arch)
    params = M.init_params(cfg, seed=0, device="cuda")
    cpu_params = _to_cpu(params)
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (B, prompt_len), generator=gen)
    card_x, cpu_x = {}, {}
    if cfg.is_encoder_decoder:
        frames = torch.randn(B, cfg.encoder_seq, cfg.d_model, generator=gen)
        card_x = {"encoder_out": M.encode(params, cfg, frames.cuda())}
        cpu_x = {"encoder_out": M.encode(cpu_params, cfg, frames)}
        assert _rel(card_x["encoder_out"], cpu_x["encoder_out"]) <= REL_TOL
    card_c = M.init_caches(cfg, B, prompt_len + STEPS, device="cuda")
    cpu_c = M.init_caches(cfg, B, prompt_len + STEPS, device="cpu")
    flash_ops.reset_launches()
    decode_ops.reset_launches()
    card_l, card_c = M.prefill(params, cfg, {"tokens": prompt, **card_x}, card_c, device="cuda")
    cpu_l, cpu_c = M.prefill(cpu_params, cfg, {"tokens": prompt, **cpu_x}, cpu_c, device="cpu")
    assert _rel(card_l, cpu_l) <= REL_TOL
    for _ in range(STEPS):
        tok = cpu_l.argmax(-1)[:, None]
        assert torch.equal(card_l.argmax(-1).cpu(), tok[:, 0])
        card_l, card_c = M.decode_step(params, cfg, {"tokens": tok, **card_x}, card_c,
                                       device="cuda")
        cpu_l, cpu_c = M.decode_step(cpu_params, cfg, {"tokens": tok, **cpu_x}, cpu_c,
                                     device="cpu")
        assert _rel(card_l, cpu_l) <= REL_TOL
    # A decoder block runs B3 for its self- and its cross-attention prefill
    # and B4 for both a step; xLSTM runs neither.
    n = 2 * cfg.n_layers if cfg.is_encoder_decoder else 0
    assert flash_ops.LAUNCHES["flash_attention"] == n
    assert decode_ops.LAUNCHES["decode_attention"] == n * STEPS


@pytest.mark.cuda
def test_cuda_whisper_encoder_runs_b3_once_a_layer(cuda_device):
    cfg = _cfg("whisper-tiny")
    params = M.init_params(cfg, seed=0, device="cuda")
    frames = torch.randn(B, cfg.encoder_seq, cfg.d_model, device="cuda")
    flash_ops.reset_launches()
    out = M.encode(params, cfg, frames)
    assert flash_ops.LAUNCHES["flash_attention"] == cfg.encoder_layers
    assert _rel(out, M.encode(_to_cpu(params), cfg, frames.cpu())) <= REL_TOL
