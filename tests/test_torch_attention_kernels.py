"""The port's attention kernels (B3 flash, B4 decode) against the JAX package.

On the CPU the wrappers run the kernels' plain PyTorch versions. They are
held against ``repro``'s jnp oracles (``impl="ref"``) over the sweep shapes
of ``tests/test_kernels.py`` plus ragged lengths, and against the Pallas
kernels in interpret mode at block multiples only: interpret mode pads a
ragged tail block with NaN, and the masked ``0 * NaN`` in ``p @ v`` turns
whole rows NaN (ROADMAP C-ref-4). Inputs are drawn from a numpy seed and
handed to both packages. Tolerances are those of ``tests/test_kernels.py``:
float32 2e-5, bfloat16 2e-2. ``tests/test_torch_attention_cuda.py`` holds
the CUDA kernels against these plain versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_decode_attention
from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return 2e-2 if name == "bfloat16" else 2e-5


def _inputs(seed, shapes, dtype_name):
    """The same draws as a jnp array and a torch tensor of the named type."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype_name]
    out = []
    for shape in shapes:
        x = rng.standard_normal(shape).astype(np.float32)
        out.append((jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)))
    return out


def _close(got, want, dtype_name):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=_tol(dtype_name), rtol=_tol(dtype_name))


FLASH_SHAPES = [
    # B, Sq, Sk, H, Hkv, D, causal, window   (the sweep of tests/test_kernels.py)
    (2, 256, 256, 4, 4, 64, True, 0),
    (1, 128, 256, 4, 2, 64, True, 0),       # GQA, right-aligned queries
    (2, 256, 256, 2, 1, 128, True, 128),    # MQA + sliding window
    (1, 64, 64, 2, 2, 32, False, 0),        # bidirectional (encoder)
    (1, 192, 192, 2, 2, 64, True, 0),       # not a multiple of the block
    (2, 300, 300, 8, 1, 64, True, 0),       # ragged, G = 8
    (1, 100, 300, 4, 2, 32, False, 40),     # ragged, window without causal
    (1, 600, 600, 2, 2, 64, True, 200),     # ragged, window
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal,window", FLASH_SHAPES)
def test_flash_plain_version_matches_jax_oracle(B, Sq, Sk, H, Hkv, D, causal, window, dtype):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        Sq + Sk + D, [(B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)], dtype)
    want = jax_flash_attention(qj, kj, vj, causal=causal, window=window, impl="ref")
    got = flash_ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal,window", [
    (1, 128, 128, 2, 2, 32, True, 0),
    (1, 64, 128, 4, 2, 64, True, 0),
    (1, 128, 128, 2, 1, 32, True, 64),
    (1, 64, 64, 2, 2, 32, False, 0),
])
def test_flash_plain_version_matches_pallas_interpret(B, Sq, Sk, H, Hkv, D, causal, window, dtype):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        7, [(B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)], dtype)
    want = jax_flash_attention(qj, kj, vj, causal=causal, window=window, impl="interpret",
                               block_q=64, block_kv=64)
    got = flash_ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    _close(got, want, dtype)


DECODE_SHAPES = [
    # B, H, Hkv, S, D   (the sweep of tests/test_kernels.py, then ragged S)
    (2, 8, 2, 1024, 64),
    (4, 4, 1, 512, 128),
    (1, 16, 8, 300, 64),
    (3, 16, 16, 600, 64),
    (2, 4, 4, 192, 32),
]


def _lengths(seed, B, S):
    lens = np.random.default_rng(seed).integers(1, S + 1, size=B).astype(np.int32)
    lens[0] = 1  # the shortest a row can be
    if B > 1:
        lens[-1] = S  # and the longest
    return lens


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,Hkv,S,D", DECODE_SHAPES)
def test_decode_plain_version_matches_jax_oracle(B, H, Hkv, S, D, dtype):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        S + H, [(B, H, D), (B, S, Hkv, D), (B, S, Hkv, D)], dtype)
    lens = _lengths(S, B, S)
    want = jax_decode_attention(qj, kj, vj, jnp.asarray(lens), impl="ref")
    got = decode_ops.decode_attention(qt, kt, vt, torch.from_numpy(lens))
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,Hkv,S,D", [(2, 8, 2, 1024, 64), (2, 4, 1, 512, 32)])
def test_decode_plain_version_matches_pallas_interpret(B, H, Hkv, S, D, dtype):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        11, [(B, H, D), (B, S, Hkv, D), (B, S, Hkv, D)], dtype)
    lens = _lengths(3, B, S)
    want = jax_decode_attention(qj, kj, vj, jnp.asarray(lens), impl="interpret")
    got = decode_ops.decode_attention(qt, kt, vt, torch.from_numpy(lens))
    _close(got, want, dtype)


def test_wrappers_reject_bad_operands():
    q, k = torch.zeros(1, 8, 2, 32), torch.zeros(1, 4, 2, 32)
    with pytest.raises(ValueError, match="Sq <= Sk"):
        flash_ops.flash_attention(q, k, k, causal=True)
    with pytest.raises(TypeError):
        flash_ops.flash_attention(q, k.double(), k.double(), causal=False)
    with pytest.raises(ValueError):
        flash_ops.flash_attention(q, torch.zeros(1, 4, 3, 32), torch.zeros(1, 4, 3, 32))
    qd, kd = torch.zeros(2, 4, 32), torch.zeros(2, 16, 2, 32)
    with pytest.raises(ValueError, match="lengths must lie"):
        decode_ops.decode_attention(qd, kd, kd, torch.tensor([0, 3], dtype=torch.int32))
    with pytest.raises(ValueError, match="lengths must lie"):
        decode_ops.decode_attention(qd, kd, kd, torch.tensor([17, 3], dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        decode_ops.decode_attention(qd, kd, kd, torch.tensor([1, 3]))


def test_cpu_path_launches_no_kernel():
    flash_before, decode_before = dict(flash_ops.LAUNCHES), dict(decode_ops.LAUNCHES)
    q = torch.randn(1, 5, 2, 32)
    flash_ops.flash_attention(q, q, q)
    decode_ops.decode_attention(q[:, 0], q, q, torch.tensor([5], dtype=torch.int32))
    assert flash_ops.LAUNCHES == flash_before and decode_ops.LAUNCHES == decode_before


def test_flash_reads_a_cache_prefix_in_place():
    """k, v may be a prefix of a larger cache (a batch stride of their own)."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((2, 20, 4, 32)).astype(np.float32))
    cache = torch.from_numpy(rng.standard_normal((2, 64, 2, 32)).astype(np.float32))
    got = flash_ops.flash_attention(q, cache[:, :20], cache[:, :20])
    want = flash_ops.flash_attention(q, cache[:, :20].contiguous(), cache[:, :20].contiguous())
    torch.testing.assert_close(got, want, atol=0, rtol=0)
