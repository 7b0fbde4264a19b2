"""The CUDA RG-LRU scan kernel (B5) and its backward kernel
(``rglru_scan_bwd``) against their plain PyTorch versions on the card. Marked ``cuda``: they skip without a card. This file imports no JAX,
so it runs on a machine that has torch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_rglru_cuda.py

Tolerance 1e-5, the scan tolerance of ``tests/test_kernels.py``. Both
versions carry h in float32 and round the product and the sum of every step
separately, so on the card they agree bit for bit; in bfloat16 both round
the same float32 states once. The backward rounds every product and sum of
its reverse loop in the plain version's order too (float32 only).
"""

import pytest
import torch

from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.kernels.rglru_scan.ref import rglru_scan_bwd_ref, rglru_scan_ref

SHAPES = [
    # B, S, W
    (2, 512, 256),
    (3, 100, 64),
    (1, 37, 128),
    (1, 1, 37),        # one step, W not a multiple of a warp
    (5, 37, 37),       # B x W = 185, not a multiple of the thread block
    (2, 129, 2560),    # the serving width, a ragged unrolled tail
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(B, S, W, dtype, device):
    g = torch.Generator().manual_seed(B * S + W)
    a = torch.sigmoid(torch.randn(B, S, W, generator=g)).to(dtype)
    b = torch.randn(B, S, W, generator=g).to(dtype)
    h0 = torch.randn(B, W, generator=g)
    return a.to(device), b.to(device), h0.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=str)
@pytest.mark.parametrize("B,S,W", SHAPES)
def test_cuda_scan_matches_plain_version(cuda_device, B, S, W, dtype):
    a, b, h0 = _inputs(B, S, W, dtype, cuda_device)
    plain = rglru_scan_ref(a, b, h0)
    before = scan_ops.LAUNCHES["rglru_scan"]
    got = scan_ops.rglru_scan(a, b, h0)
    torch.cuda.synchronize()
    assert scan_ops.LAUNCHES["rglru_scan"] == before + 1
    assert got.dtype == dtype and got.shape == (B, S, W)
    torch.testing.assert_close(got.float(), plain.float(), atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_cuda_scan_empty_and_checked_inputs_launch_nothing(cuda_device):
    a, b, h0 = _inputs(2, 8, 16, torch.float32, cuda_device)
    before = scan_ops.LAUNCHES["rglru_scan"]
    assert scan_ops.rglru_scan(a[:, :0], b[:, :0], h0).shape == (2, 0, 16)
    with pytest.raises(ValueError, match="contiguous"):
        scan_ops.rglru_scan(a[:, :, ::2], b[:, :, ::2], h0[:, ::2])
    with pytest.raises(ValueError, match="one device"):
        scan_ops.rglru_scan(a, b, h0.cpu())
    assert scan_ops.LAUNCHES["rglru_scan"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("grad_h0", (True, False), ids=("dh0", "no-dh0"))
@pytest.mark.parametrize("B,S,W", SHAPES + [(3, 16, 129), (2, 33, 2560)])
def test_cuda_scan_backward_matches_plain_version(cuda_device, B, S, W, grad_h0):
    a, b, h0 = _inputs(B, S, W, torch.float32, cuda_device)
    g = torch.randn(B, S, W, generator=torch.Generator().manual_seed(S)).to(cuda_device)
    h = rglru_scan_ref(a, b, h0)
    want = rglru_scan_bwd_ref(g, a, h, h0)
    before = dict(scan_ops.LAUNCHES)
    got = scan_ops.rglru_scan_bwd(g, a, h, h0, grad_h0=grad_h0)
    torch.cuda.synchronize()
    assert scan_ops.LAUNCHES == dict(before, rglru_scan_bwd=before["rglru_scan_bwd"] + 1)
    assert (got[2] is None) == (not grad_h0)
    for x, w in zip(got, want if grad_h0 else want[:2]):
        assert x.dtype == torch.float32 and x.shape == w.shape
        torch.testing.assert_close(x, w, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_cuda_scan_autograd_launches_both_kernels(cuda_device):
    a, b, h0 = (t.requires_grad_(True) for t in _inputs(2, 40, 96, torch.float32, cuda_device))
    g = torch.randn(2, 40, 96, device=cuda_device)
    scan_ops.reset_launches()
    got = torch.autograd.grad(scan_ops.rglru_scan(a, b, h0), (a, b, h0), g)
    assert scan_ops.LAUNCHES == {"rglru_scan": 1, "rglru_scan_bwd": 1}
    want = torch.autograd.grad(rglru_scan_ref(a, b, h0), (a, b, h0), g)
    for x, w in zip(got, want):
        torch.testing.assert_close(x, w, atol=1e-5, rtol=1e-5)
    with pytest.raises(TypeError, match="float32"):
        scan_ops.rglru_scan(a.detach().bfloat16().requires_grad_(True), b.detach().bfloat16(), h0)
