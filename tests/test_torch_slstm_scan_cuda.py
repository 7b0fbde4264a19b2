"""The sLSTM recurrence kernel on the card against its plain version.
Marked ``cuda``: they skip without a card. This file imports no JAX, so it
runs on a machine that has torch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_slstm_scan_cuda.py

Inputs as ``chip_smoke.py`` phase 16 draws them: gate pre-activations
N(0, 1), the recurrent matrix N(0, 1/d), a fresh state (m at -1e30) or the
state the plain version left after a prompt. The kernel's dot products sum
in another order than cuBLAS (TF32 off), so every output and state is held
within atol = rtol = 1e-5 (the B5 scan's tolerance), NaN where the plain
version has NaN.
"""

import pytest
import torch

from repro_torch.kernels.slstm_scan import ops as slstm_ops
from repro_torch.kernels.slstm_scan.ref import slstm_scan_ref

TOL = dict(atol=1e-5, rtol=1e-5, equal_nan=True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _inputs(B, S, d, seed=0, rw=None, state=None):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    gates = [torch.randn(B, S, d, device="cuda", generator=gen) for _ in range(4)]
    if rw is None:
        rw = torch.randn(d, d, device="cuda", generator=gen) * d ** -0.5
    if state is None:
        state = (*(torch.zeros(B, d, device="cuda") for _ in range(3)),
                 torch.full((B, d), -1e30, device="cuda"))
    return [*gates, rw, *state]


def _close(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        torch.testing.assert_close(g, w, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,d", [(8, 512, 768), (3, 7, 100), (130, 3, 64), (2, 3, 4100),
                                   (1, 2, 1)])
def test_kernel_matches_its_plain_version(cuda_device, B, S, d):
    """xlstm-125m's prefill; a ragged column group; rows past one staging
    tile; k past one chunk with rw in global memory; one feature."""
    args = _inputs(B, S, d)
    slstm_ops.reset_launches()
    got = slstm_ops.slstm_scan(*args)
    torch.cuda.synchronize()
    assert slstm_ops.LAUNCHES == {"slstm_scan": 1}
    _close(got, slstm_scan_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 512])
def test_kernel_from_the_state_a_prompt_left(cuda_device, S):
    """A decode step (S = 1) and a second prompt after a 512-token prompt."""
    first = _inputs(8, 512, 768, seed=1)
    left = slstm_scan_ref(*first)[1:]
    args = _inputs(8, S, 768, seed=2, rw=first[4], state=left)
    _close(slstm_ops.slstm_scan(*args), slstm_scan_ref(*args))


@pytest.mark.cuda
def test_a_nan_in_one_gate_stays_where_the_plain_version_has_it(cuda_device):
    args = _inputs(2, 6, 100, seed=3)
    args[2][1, 2, 7] = float("nan")  # a forget-gate pre-activation
    want = slstm_scan_ref(*args)
    assert bool(torch.isnan(want[0]).any())
    _close(slstm_ops.slstm_scan(*args), want)


@pytest.mark.cuda
def test_reruns_are_bit_identical(cuda_device):
    args = _inputs(8, 64, 768, seed=4)
    first, second = slstm_ops.slstm_scan(*args), slstm_ops.slstm_scan(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_an_input_that_requires_grad_raises(cuda_device):
    args = _inputs(2, 3, 64, seed=5)
    args[4].requires_grad_(True)
    slstm_ops.reset_launches()
    with pytest.raises(RuntimeError, match="no backward"):
        slstm_ops.slstm_scan(*args)
    assert slstm_ops.LAUNCHES == {"slstm_scan": 0}


@pytest.mark.cuda
def test_empty_inputs_launch_nothing(cuda_device):
    args = _inputs(2, 0, 64, seed=6)
    slstm_ops.reset_launches()
    hs, c, n, h, m = slstm_ops.slstm_scan(*args)
    assert hs.shape == (2, 0, 64) and torch.equal(c, args[5]) and torch.equal(m, args[8])
    assert slstm_ops.LAUNCHES == {"slstm_scan": 0}
