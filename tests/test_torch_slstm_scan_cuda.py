"""The sLSTM recurrence kernel on the card against its plain version, in
both layouts. Marked ``cuda``: they skip without a card. This file imports
no JAX, so it runs on a machine that has torch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_slstm_scan_cuda.py

one layout alone with ``-k cluster`` or ``-k cooperative``.

Inputs as ``chip_smoke.py`` phase 16 draws them: gate pre-activations
N(0, 1), the recurrent matrix N(0, 1/d), a fresh state (m at -1e30) or the
state the plain version left after a prompt. The kernel's dot products sum
in another order than cuBLAS (TF32 off), so every output and state is held
within atol = rtol = 1e-5 (the B5 scan's tolerance), NaN where the plain
version has NaN. Each case runs under each layout, forced; the cluster
layout refuses d past ``ops.MAX_CLUSTER_D``, by name.
"""

import pytest
import torch

from repro_torch.kernels.slstm_scan import ops as slstm_ops
from repro_torch.kernels.slstm_scan.ref import slstm_scan_ref

TOL = dict(atol=1e-5, rtol=1e-5, equal_nan=True)
LAYOUTS = list(slstm_ops.LAYOUTS)


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


def _run(args, layout):
    """The kernel in ``layout`` (one launch counted), or, where the cluster
    layout cannot take d, its refusal by name and no launch."""
    slstm_ops.reset_launches()
    if layout == "cluster" and slstm_ops.cluster_size(args[0].shape[2]) is None:
        with pytest.raises(ValueError, match="cluster layout cannot take"):
            slstm_ops.slstm_scan(*args, layout=layout)
        assert slstm_ops.LAUNCHES == {"slstm_scan": 0}
        return None
    got = slstm_ops.slstm_scan(*args, layout=layout)
    torch.cuda.synchronize()
    assert slstm_ops.LAUNCHES == {"slstm_scan": 1}
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("B,S,d", [(8, 512, 768), (3, 7, 100), (130, 3, 64), (2, 3, 4100),
                                   (1, 2, 1), (9, 5, 768), (130, 3, 768), (2, 3, 769)])
def test_kernel_matches_its_plain_version(cuda_device, layout, B, S, d):
    """xlstm-125m's prefill; a ragged column group (cooperative) or slice
    (cluster); rows past one staging tile, or past the resident clusters (B
    130: several rows a cluster, in waves); k past one chunk with rw in
    global memory (d 4100, cooperative only); one feature; 9 rows; the last
    d the cluster layout holds (768) and the first it does not (769)."""
    args = _inputs(B, S, d)
    got = _run(args, layout)
    if got is not None:
        _close(got, slstm_scan_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [768, 769])
def test_the_plan_takes_the_layout_that_holds_d(cuda_device, d):
    """Unforced, the plan's layout: the cluster one at d = 768, the
    cooperative one a feature past it; each within the tolerance."""
    args = _inputs(2, 5, d, seed=7)
    want = "cluster" if d == 768 else "cooperative"
    assert slstm_ops.plan(2, 5, d, slstm_ops.device())["layout"] == want
    _close(slstm_ops.slstm_scan(*args), slstm_scan_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("S", [1, 512])
def test_kernel_from_the_state_a_prompt_left(cuda_device, layout, S):
    """A decode step (S = 1) and a second prompt after a 512-token prompt."""
    first = _inputs(8, 512, 768, seed=1)
    left = slstm_scan_ref(*first)[1:]
    args = _inputs(8, S, 768, seed=2, rw=first[4], state=left)
    _close(_run(args, layout), slstm_scan_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
def test_a_nan_in_one_gate_stays_where_the_plain_version_has_it(cuda_device, layout):
    args = _inputs(2, 6, 100, seed=3)
    args[2][1, 2, 7] = float("nan")  # a forget-gate pre-activation
    want = slstm_scan_ref(*args)
    assert bool(torch.isnan(want[0]).any())
    _close(_run(args, layout), want)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("B", [8, 130])
def test_reruns_are_bit_identical(cuda_device, layout, B):
    args = _inputs(B, 64, 768, seed=4)
    first = slstm_ops.slstm_scan(*args, layout=layout)
    slstm_ops.reset_launches()
    second = slstm_ops.slstm_scan(*args, layout=layout)
    torch.cuda.synchronize()
    assert slstm_ops.LAUNCHES == {"slstm_scan": 1}
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
def test_the_serial_floor_launches_nothing_that_counts(cuda_device, layout):
    args = _inputs(8, 16, 768, seed=8)
    slstm_ops.reset_launches()
    slstm_ops.serial_floor(*args, layout=layout)
    torch.cuda.synchronize()
    assert slstm_ops.LAUNCHES == {"slstm_scan": 0}


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
