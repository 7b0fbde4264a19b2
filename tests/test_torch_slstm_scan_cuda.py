"""The sLSTM recurrence kernel and its backward on the card against their
plain versions, in both layouts. Marked ``cuda``: they skip without a card.
This file imports no JAX, so it runs on a machine that has torch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_slstm_scan_cuda.py

one layout alone with ``-k cluster`` or ``-k cooperative``.

Inputs as ``chip_smoke.py`` phase 16 draws them: gate pre-activations
N(0, 1), the recurrent matrix N(0, 1/d), a fresh state (m at -1e30) or the
state the plain version left after a prompt. The kernel's dot products sum
in another order than cuBLAS (TF32 off), so every output and state is held
within atol = rtol = 1e-5 (the B5 scan's tolerance), NaN where the plain
version has NaN. Each case runs under each layout, forced; the cluster
layout refuses d past ``ops.MAX_CLUSTER_D``, by name.

The backward (``ops.slstm_scan_bwd``) takes the forward's saved steps and
random output gradients N(0, 1) and is held to ``ref.slstm_scan_bwd_ref``
on the card within ``BWD_TOL`` of each gradient's max-abs: at (8, 512, 768)
that plain version differs from autograd through the plain loop by at
most 1.02e-6 of a gradient's max-abs (``rw``'s, a sum over B S rows), and
the kernel's products sum in yet another order; ten times that leaves room.
NaN where the plain version has NaN; reruns equal bit for bit; under
autograd one forward and one backward launch (in the cluster layout the
backward is two kernels, its loop and its rest pass, one launch each; each
is also held to its own plain version, ``ref.slstm_scan_bwd_chain_ref`` and
``ref.slstm_scan_bwd_rest_ref``, within ``BWD_TOL``).
"""

import pytest
import torch

from repro_torch.kernels.slstm_scan import ops as slstm_ops
from repro_torch.kernels.slstm_scan.ref import (slstm_scan_bwd_chain_ref, slstm_scan_bwd_ref,
                                                 slstm_scan_bwd_rest_ref, slstm_scan_ref)

TOL = dict(atol=1e-5, rtol=1e-5, equal_nan=True)
BWD_TOL = 1e-5
LAYOUTS = list(slstm_ops.LAYOUTS)
NO_LAUNCH = {"slstm_scan": 0, "slstm_scan_bwd": 0, "slstm_scan_bwd_rest": 0}
EDGES = [(8, 512, 768), (3, 7, 100), (130, 3, 64), (2, 3, 4100), (1, 2, 1), (9, 5, 768),
         (130, 3, 768), (2, 3, 769)]


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
        assert slstm_ops.LAUNCHES == NO_LAUNCH
        return None
    got = slstm_ops.slstm_scan(*args, layout=layout)
    torch.cuda.synchronize()
    assert slstm_ops.LAUNCHES == {**NO_LAUNCH, "slstm_scan": 1}
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("B,S,d", EDGES)
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
    assert slstm_ops.LAUNCHES == {**NO_LAUNCH, "slstm_scan": 1}
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
def test_the_serial_floor_launches_nothing_that_counts(cuda_device, layout):
    args = _inputs(8, 16, 768, seed=8)
    slstm_ops.reset_launches()
    slstm_ops.serial_floor(*args, layout=layout)
    torch.cuda.synchronize()
    assert slstm_ops.LAUNCHES == NO_LAUNCH


@pytest.mark.cuda
def test_empty_inputs_launch_nothing(cuda_device):
    args = _inputs(2, 0, 64, seed=6)
    slstm_ops.reset_launches()
    hs, c, n, h, m = slstm_ops.slstm_scan(*args)
    assert hs.shape == (2, 0, 64) and torch.equal(c, args[5]) and torch.equal(m, args[8])
    assert slstm_ops.LAUNCHES == NO_LAUNCH


def _bwd_inputs(B, S, d, seed=0, state=None):
    """The backward's arguments: output gradients N(0, 1), the gates, rw and
    entering state of ``_inputs``, and the forward's saved steps."""
    args = _inputs(B, S, d, seed, state=state)
    saved = slstm_scan_ref(*args, save=True)[5:]
    gen = torch.Generator(device="cuda").manual_seed(seed + 1000)
    grads = [torch.randn(B, S, d, device="cuda", generator=gen)] + [
        torch.randn(B, d, device="cuda", generator=gen) for _ in range(4)]
    ix, fx, ox, rw, c0, n0, _, m0 = args[1:]
    return [*grads, ix, fx, ox, rw, c0, n0, m0, *saved]


def _bwd_close(got, want):
    """Every gradient within ``BWD_TOL`` of its max-abs, NaN where the plain
    version has NaN."""
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        finite = ~torch.isnan(w)
        if finite.any():
            scale = max(float(w[finite].abs().max()), 1e-30)
            assert float((g - w)[finite].abs().max()) <= BWD_TOL * scale


def _bwd_launches(layout):
    """One backward's launches in ``layout``: the cooperative kernel, or the
    cluster layout's loop and rest pass."""
    return {**NO_LAUNCH, "slstm_scan_bwd": 1, "slstm_scan_bwd_rest": int(layout == "cluster")}


def _run_bwd(args, layout):
    """The backward in ``layout`` (its launches counted), or the cluster
    layout's refusal by name and no launch."""
    slstm_ops.reset_launches()
    if layout == "cluster" and slstm_ops.cluster_size(args[5].shape[2]) is None:
        with pytest.raises(ValueError, match="cluster layout cannot take"):
            slstm_ops.slstm_scan_bwd(*args, layout=layout)
        assert slstm_ops.LAUNCHES == NO_LAUNCH
        return None
    got = slstm_ops.slstm_scan_bwd(*args, layout=layout)
    torch.cuda.synchronize()
    assert slstm_ops.LAUNCHES == _bwd_launches(layout)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("B,S,d", EDGES + [(8, 1, 768), (1, 64, 768), (3, 64, 768),
                                   (9, 64, 768), (8, 2, 768), (8, 3, 768), (1, 1, 100),
                                   (9, 3, 100)])
def test_backward_matches_its_plain_version(cuda_device, layout, B, S, d):
    """The forward's shapes, from a fresh state, and one to three steps;
    rows in clusters of R rows whose last holds fewer (B 1, 3, 9)."""
    args = _bwd_inputs(B, S, d, seed=10)
    got = _run_bwd(args, layout)
    if got is not None:
        _bwd_close(got, slstm_scan_bwd_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("S", [1, 512])
def test_backward_from_the_state_a_prompt_left(cuda_device, layout, S):
    first = _inputs(8, 512, 768, seed=11)
    args = _bwd_inputs(8, S, 768, seed=12, state=slstm_scan_ref(*first)[1:])
    _bwd_close(_run_bwd(args, layout), slstm_scan_bwd_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
def test_backward_with_no_gradient_of_the_state(cuda_device, layout):
    """Training's call: the outputs' gradient alone, the state's None."""
    args = _bwd_inputs(8, 64, 768, seed=13)
    args[1:5] = [None] * 4
    _bwd_close(_run_bwd(args, layout), slstm_scan_bwd_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
def test_backward_a_nan_in_one_gate_stays_where_the_plain_version_has_it(cuda_device, layout):
    args = _inputs(2, 6, 100, seed=14)
    args[2][1, 2, 7] = float("nan")  # a forget-gate pre-activation
    saved = slstm_scan_ref(*args, save=True)[5:]
    gen = torch.Generator(device="cuda").manual_seed(15)
    grads = [torch.randn(2, 6, 100, device="cuda", generator=gen)] + [None] * 4
    bwd = [*grads, *args[1:7], args[8], *saved]
    want = slstm_scan_bwd_ref(*bwd)
    assert bool(torch.isnan(want[0]).any()) and not bool(torch.isnan(want[0][0]).any())
    _bwd_close(_run_bwd(bwd, layout), want)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("B", [8, 130])
def test_backward_reruns_are_bit_identical(cuda_device, layout, B):
    args = _bwd_inputs(B, 64, 768, seed=16)
    first = slstm_ops.slstm_scan_bwd(*args, layout=layout)
    second = _run_bwd(args, layout)
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
def test_backward_serial_floor_launches_nothing_that_counts(cuda_device, layout):
    args = _bwd_inputs(8, 16, 768, seed=17)
    slstm_ops.reset_launches()
    slstm_ops.bwd_serial_floor(*args, layout=layout)
    torch.cuda.synchronize()
    assert slstm_ops.LAUNCHES == NO_LAUNCH


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
def test_autograd_launches_the_forward_and_the_backward_once(cuda_device, layout):
    """An input that requires grad: the Function saves the steps in one
    forward launch and differentiates in one backward launch, every input's
    gradient within ``BWD_TOL`` of autograd through the plain loop."""
    args = [t.requires_grad_(True) for t in _inputs(4, 33, 768, seed=18)]
    slstm_ops.reset_launches()
    out = slstm_ops.slstm_scan(*args, layout=layout)
    gen = torch.Generator(device="cuda").manual_seed(19)
    g = [torch.randn(o.shape, device="cuda", generator=gen) for o in out]
    got = torch.autograd.grad(out, args, g)
    torch.cuda.synchronize()
    assert slstm_ops.LAUNCHES == {**_bwd_launches(layout), "slstm_scan": 1}
    _bwd_close(got, torch.autograd.grad(slstm_scan_ref(*args), args, g))


@pytest.mark.cuda
def test_backward_of_no_step_launches_nothing(cuda_device):
    args = _inputs(2, 0, 64, seed=20)
    empty = torch.empty(2, 0, 64, device="cuda")
    dc = torch.randn(2, 64, device="cuda")
    slstm_ops.reset_launches()
    got = slstm_ops.slstm_scan_bwd(empty, dc, None, None, None, *args[1:7], args[8],
                                   *(empty,) * 4)
    assert got[0].shape == (2, 0, 64) and torch.equal(got[4], dc)
    assert not bool(got[5].any())
    assert slstm_ops.LAUNCHES == NO_LAUNCH


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,d", [(8, 512, 768), (9, 3, 100), (1, 2, 768), (3, 17, 64)])
def test_the_cluster_loop_and_rest_pass_match_their_plain_versions(cuda_device, B, S, d):
    """The cluster layout's two kernels apart: the loop (dzx, every step's
    dh_t, dh0) against ``slstm_scan_bwd_chain_ref``, and the rest pass on
    the loop's dh_t against ``slstm_scan_bwd_rest_ref`` on the same dh_t;
    one launch each, counted under its own name."""
    args = _bwd_inputs(B, S, d, seed=21)
    slstm_ops.reset_launches()
    chain = slstm_ops.slstm_scan_bwd_chain(*args)
    torch.cuda.synchronize()
    assert slstm_ops.LAUNCHES == {**NO_LAUNCH, "slstm_scan_bwd": 1}
    _bwd_close(chain, slstm_scan_bwd_chain_ref(*args))
    rest_args = (chain[1], *args[1:3], args[4], *args[5:8], *args[9:])
    slstm_ops.reset_launches()
    rest = slstm_ops.slstm_scan_bwd_rest(*rest_args)
    torch.cuda.synchronize()
    assert slstm_ops.LAUNCHES == {**NO_LAUNCH, "slstm_scan_bwd_rest": 1}
    _bwd_close(rest, slstm_scan_bwd_rest_ref(*rest_args))
