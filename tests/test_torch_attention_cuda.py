"""The CUDA attention kernels (B3 flash, B4 decode) against their plain
PyTorch versions on the card. Marked ``cuda``: they skip without a card.
This file imports no JAX, so it runs on a machine that has torch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_attention_cuda.py

Tolerances: float32 2e-5, bfloat16 2e-2 (those of ``tests/test_kernels.py``);
the kernel sums in another order and, in bfloat16, rounds its float32
result once, as the plain version does.
"""

import pytest
import torch

from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.ref import split_starts
from repro_torch.kernels.flash_attention import ops as flash_ops

DTYPES = (torch.float32, torch.bfloat16)

FLASH_SHAPES = [
    # B, Sq, Sk, H, Hkv, D, causal, window
    (2, 256, 256, 4, 4, 64, True, 0),
    (1, 128, 256, 4, 2, 64, True, 0),       # GQA G = 2, right-aligned queries
    (2, 256, 256, 2, 1, 128, True, 128),    # MQA + sliding window
    (1, 64, 64, 2, 2, 32, False, 0),        # bidirectional
    (1, 192, 192, 2, 2, 64, True, 0),       # ragged
    (2, 300, 300, 8, 1, 64, True, 0),       # ragged, G = 8
    (1, 100, 300, 4, 2, 32, False, 40),     # window without causal
    (1, 600, 600, 2, 2, 256, True, 200),    # ragged, window, widest head
    (1, 2304, 2304, 10, 1, 256, True, 2048),  # recurrentgemma-2b's prefill, one row
]

DECODE_SHAPES = [
    # B, H, Hkv, S, D
    (2, 8, 2, 1024, 64),
    (4, 4, 1, 512, 128),
    (1, 16, 8, 300, 64),
    (3, 16, 16, 600, 64),
    (2, 16, 2, 192, 256),
    (2, 10, 1, 2048, 256),  # recurrentgemma-2b's ring, two rows
]


def _tol(dtype):
    return 2e-2 if dtype == torch.bfloat16 else 2e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal,window", FLASH_SHAPES)
def test_cuda_flash_kernel_matches_plain_version(cuda_device, B, Sq, Sk, H, Hkv, D, causal,
                                                 window, dtype):
    g = torch.Generator().manual_seed(Sq + Sk)
    q, k, v = (torch.randn(shape, generator=g).to(dtype)
               for shape in ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
    plain = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
    before = flash_ops.LAUNCHES["flash_attention"]
    got = flash_ops.flash_attention(q.to(cuda_device), k.to(cuda_device), v.to(cuda_device),
                                    causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES["flash_attention"] == before + 1
    torch.testing.assert_close(got.cpu().float(), plain.float(), atol=_tol(dtype), rtol=_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("B,H,Hkv,S,D", DECODE_SHAPES)
def test_cuda_decode_kernel_matches_plain_version(cuda_device, B, H, Hkv, S, D, dtype):
    g = torch.Generator().manual_seed(S)
    q, k, v = (torch.randn(shape, generator=g).to(dtype)
               for shape in ((B, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    lens = torch.randint(1, S + 1, (B,), generator=g, dtype=torch.int32)
    lens[0] = 1
    plain = decode_ops.decode_attention(q, k, v, lens)
    before = decode_ops.LAUNCHES["decode_attention"]
    got = decode_ops.decode_attention(*(x.to(cuda_device) for x in (q, k, v, lens)))
    torch.cuda.synchronize()
    assert decode_ops.LAUNCHES["decode_attention"] == before + 1
    torch.testing.assert_close(got.cpu().float(), plain.float(), atol=_tol(dtype), rtol=_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_cuda_decode_kernel_at_slice_boundaries(cuda_device, dtype):
    """Lengths on the split pass's slice boundaries and one slot either side."""
    B, H, Hkv, S, D = 8, 10, 1, 2048, 256
    n_split = decode_ops.split_count(B * Hkv, S, H // Hkv, D, dtype.itemsize)
    bounds = split_starts(n_split, S)[1:-1]
    lens = torch.tensor([bounds[0], bounds[0] + 1, bounds[1] - 1, bounds[1], bounds[-1],
                         bounds[-1] + 1, S - 1, S], dtype=torch.int32)
    g = torch.Generator().manual_seed(21)
    q, k, v = (torch.randn(shape, generator=g).to(dtype)
               for shape in ((B, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    plain = decode_ops.decode_attention(q, k, v, lens)
    got = decode_ops.decode_attention(*(x.to(cuda_device) for x in (q, k, v, lens)))
    again = decode_ops.decode_attention(*(x.to(cuda_device) for x in (q, k, v, lens)))
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu().float(), plain.float(), atol=_tol(dtype), rtol=_tol(dtype))
    assert torch.equal(got, again)  # fixed-order combine: reruns are bit-identical


@pytest.mark.cuda
def test_cuda_kernels_refuse_an_unbuilt_head_dim(cuda_device):
    q = torch.zeros(1, 4, 2, 48, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        flash_ops.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="head_dim"):
        decode_ops.decode_attention(q[:, 0], q, q, torch.ones(1, dtype=torch.int32,
                                                                device=cuda_device))
