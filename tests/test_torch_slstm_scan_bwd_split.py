"""The sLSTM backward's plain version split as the cluster layout's two
kernels split it, on the CPU: ``ref.slstm_scan_bwd_chain_ref`` (the loop:
dz_pre, every step's dh_t and the entering h's gradient) then
``ref.slstm_scan_bwd_rest_ref`` (dix, dfx, dox and the entering c, n, m's
gradients from those dh_t) against ``ref.slstm_scan_bwd_ref`` in one loop,
bit for bit: the split rounds every value as the single loop does.

Inputs from a numpy seed: gates N(0, 1), rw N(0, 1/d), output gradients
N(0, 1), a fresh entering state or the one a 7-step prompt left, the
forward's saved steps from ``slstm_scan_ref``. Shapes: S in {1, 2, 3, 17},
B in {1, 3, 8}, d in {100, 768}; then an exact tie in the stabiliser max,
a NaN gate (NaN in the same places), and every gradient None but dhs.
The wrapper's CPU path (``ops.slstm_scan_bwd_chain``,
``ops.slstm_scan_bwd_rest``) is the split twin and launches nothing. The
kernels themselves: ``tests/test_torch_slstm_scan_cuda.py`` on the card.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels.slstm_scan import ops as slstm_ops
from repro_torch.kernels.slstm_scan.ref import (slstm_scan_bwd_chain_ref, slstm_scan_bwd_ref,
                                                 slstm_scan_bwd_rest_ref, slstm_scan_ref)

NO_LAUNCH = {"slstm_scan": 0, "slstm_scan_bwd": 0, "slstm_scan_bwd_rest": 0}


def _normal(rng, *shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))


def _forward_inputs(B, S, d, start, seed):
    rng = np.random.default_rng(seed)
    gates = [_normal(rng, B, S, d) for _ in range(4)]
    rw = _normal(rng, d, d, scale=d ** -0.5)
    state = [torch.zeros(B, d) for _ in range(3)] + [torch.full((B, d), -1e30)]
    if start == "prompt":
        state = list(slstm_scan_ref(*[_normal(rng, B, 7, d) for _ in range(4)], rw, *state)[1:])
    return gates + [rw] + state


def _backward_args(fwd, seed, state_grads=True):
    """``slstm_scan_bwd``'s arguments for the forward inputs ``fwd``."""
    B, S, d = fwd[0].shape
    rng = np.random.default_rng(seed)
    saved = slstm_scan_ref(*fwd, save=True)[5:]
    grads = [_normal(rng, B, S, d)] + (
        [_normal(rng, B, d) for _ in range(4)] if state_grads else [None] * 4)
    return [*grads, *fwd[1:7], fwd[8], *saved]


def _split(args):
    """The split twin's outputs in ``slstm_scan_bwd_ref``'s order."""
    dzx, dh_all, dh0 = slstm_scan_bwd_chain_ref(*args)
    rest = slstm_scan_bwd_rest_ref(dh_all, *args[1:3], args[4], *args[5:8], *args[9:])
    dix, dfx, dox, dc0, dn0, dm0 = rest
    return dzx, dix, dfx, dox, dc0, dn0, dh0, dm0


def _bits(t):
    return t.view(torch.int32)


def _assert_same_bits(got, want):
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("d", [100, 768])
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("S", [1, 2, 3, 17])
def test_split_twin_equals_the_single_loop_bit_for_bit(S, B, d):
    start = "prompt" if (S + B) % 2 else "fresh"
    args = _backward_args(_forward_inputs(B, S, d, start, seed=S * 10 + B), seed=d + S)
    _assert_same_bits(_split(args), slstm_scan_bwd_ref(*args))


def test_split_twin_at_an_exact_tie_in_the_stabiliser_max():
    """ix_t set to log_sigmoid(fx_t) + m_{t-1} in the loop's own float32
    arithmetic, at (0, 3, 5) and in all of row 1 at step 4: both sides of
    the max equal, split half and half by both twins alike."""
    fwd = _forward_inputs(2, 6, 16, "prompt", seed=7)
    ix, lf = fwd[1], F.logsigmoid(fwd[2])
    m = slstm_scan_ref(*fwd, save=True)[7]
    ix[0, 3, 5] = lf[0, 3, 5] + m[0, 2, 5]
    m = slstm_scan_ref(*fwd, save=True)[7]  # ix moved m from step 3 on in column 5
    ix[1, 4] = lf[1, 4] + m[1, 3]
    m = slstm_scan_ref(*fwd, save=True)[7]
    ties = lf[:, 1:] + m[:, :-1] == ix[:, 1:]
    assert bool(ties[0, 2, 5]) and bool(ties[1, 3].all())
    args = _backward_args(fwd, seed=8)
    _assert_same_bits(_split(args), slstm_scan_bwd_ref(*args))


def test_split_twin_with_a_nan_gate():
    fwd = _forward_inputs(2, 6, 100, "fresh", seed=9)
    fwd[2][1, 2, 7] = float("nan")  # a forget-gate pre-activation
    args = _backward_args(fwd, seed=10)
    want = slstm_scan_bwd_ref(*args)
    assert bool(torch.isnan(want[0]).any()) and not bool(torch.isnan(want[0][0]).any())
    _assert_same_bits(_split(args), want)


def test_split_twin_with_only_the_outputs_gradient():
    """Training's call: the state after the last step's gradients None."""
    args = _backward_args(_forward_inputs(3, 9, 100, "prompt", seed=11), seed=12,
                          state_grads=False)
    _assert_same_bits(_split(args), slstm_scan_bwd_ref(*args))


def test_wrapper_on_the_cpu_is_the_split_twin():
    """``ops.slstm_scan_bwd_chain`` and ``ops.slstm_scan_bwd_rest`` on CPU
    tensors: the split twin, bit for bit, and no launch."""
    args = _backward_args(_forward_inputs(3, 5, 100, "fresh", seed=13), seed=14)
    slstm_ops.reset_launches()
    chain = slstm_ops.slstm_scan_bwd_chain(*args)
    rest_args = (chain[1], *args[1:3], args[4], *args[5:8], *args[9:])
    rest = slstm_ops.slstm_scan_bwd_rest(*rest_args)
    assert slstm_ops.LAUNCHES == NO_LAUNCH
    for got, want in zip((*chain, *rest), (*slstm_scan_bwd_chain_ref(*args),
                                            *slstm_scan_bwd_rest_ref(*rest_args))):
        assert torch.equal(_bits(got), _bits(want))
