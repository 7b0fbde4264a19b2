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

The kernels' own arithmetic has plain versions too: B4's split-KV slices
and combine (``decode_attention_split_ref``, float32 1e-5 against both
references) with the wrapper's choice of slices, and B3's bf16 numerics
(``flash_attention_bf16_emulation``, held to ``chip_smoke.py``'s bf16
tolerance, one bf16 rounding of the output).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_decode_attention
from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.ref import TILE, decode_attention_split_ref, split_starts
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bf16_emulation,
    flash_attention_ref,
)

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


# --- B4's split-KV arithmetic and B3's bf16 numerics (plain versions) -------

SPLIT_SHAPES = [
    # B, H, Hkv, S, D
    (4, 8, 2, 300, 64),      # GQA G = 4, ragged last tile
    (4, 10, 1, 2048, 256),   # recurrentgemma-2b's ring: MQA, G = 10, D 256
]


def _split_lengths(pattern, B, S, n_split):
    """Per-row lengths: all 1 (every slice but the first empty), all S, on
    the slices' boundaries, or one slot either side of them."""
    bounds = [x for x in split_starts(n_split, S)[1:-1]] + [S]
    if pattern == "one":
        lens = [1] * B
    elif pattern == "full":
        lens = [S] * B
    elif pattern == "on":
        lens = [bounds[(i * len(bounds)) // B] for i in range(B)]
    else:
        lens = [bounds[(i * len(bounds)) // B] + (1 if i % 2 else -1) for i in range(B)]
    return np.clip(np.array(lens, dtype=np.int32), 1, S)


@pytest.mark.parametrize("pattern", ["one", "full", "on", "off"])
@pytest.mark.parametrize("n_split", [1, 2, 7, "tiles"])
@pytest.mark.parametrize("B,H,Hkv,S,D", SPLIT_SHAPES)
def test_decode_split_arithmetic_matches_plain_and_jax(B, H, Hkv, S, D, n_split, pattern):
    if n_split == "tiles":
        n_split = -(-S // TILE)
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        S + D + n_split, [(B, H, D), (B, S, Hkv, D), (B, S, Hkv, D)], "float32")
    lens = _split_lengths(pattern, B, S, n_split)
    got = decode_attention_split_ref(qt, kt, vt, torch.from_numpy(lens), n_split)
    plain = decode_ops.decode_attention(qt, kt, vt, torch.from_numpy(lens))
    want = jax_decode_attention(qj, kj, vj, jnp.asarray(lens), impl="ref")
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("pairs", [1, 8, 16, 128, 300, 2000])
@pytest.mark.parametrize("S", [1, 31, 32, 33, 576, 2048, 8192])
def test_split_count_fills_the_card_within_the_tiles(pairs, S):
    n_tiles = -(-S // TILE)
    for group, head_dim, elem in [(1, 64, 2), (10, 256, 2), (8, 128, 4), (16, 32, 2)]:
        n = decode_ops.split_count(pairs, S, group, head_dim, elem)
        assert 1 <= n <= n_tiles
        if n_tiles * pairs >= decode_ops.SMS:  # S allows a full card
            assert n * pairs >= decode_ops.SMS
        scratch = pairs * n * group * (head_dim + 2) * 4
        if n * pairs > decode_ops.SMS + pairs:  # more than the fill: within the scratch share
            assert scratch <= decode_ops.SCRATCH_SHARE * 2 * pairs * S * head_dim * elem


def test_split_count_at_the_serving_shapes():
    # recurrentgemma-2b's rings: 8 (row, KV head) pairs, 2048 slots, 10 heads of 256.
    n = decode_ops.split_count(8, 2048, 10, 256, 2)
    assert n == 32 and 8 * n >= 132 and 2048 // 32 % n == 0  # 2 tiles a slice
    assert 8 * n * 10 * 258 * 4 <= 0.16 * 2 * 8 * 2048 * 256 * 2
    # qwen1.5-0.5b: 128 pairs, 576 slots, one head of 64 per KV head.
    assert decode_ops.split_count(128, 576, 1, 64, 2) == 3


EMULATION_SHAPES = [
    # B, Sq, Sk, H, Hkv, D, causal, window
    (1, 192, 192, 2, 2, 64, True, 0),       # ragged
    (2, 300, 300, 8, 1, 64, True, 0),       # ragged, G = 8
    (1, 128, 256, 4, 2, 64, True, 0),       # GQA, right-aligned queries
    (1, 100, 300, 4, 2, 32, False, 40),     # window without causal
    (1, 600, 600, 2, 1, 256, True, 200),    # window, MQA, D 256
    (1, 260, 260, 10, 1, 256, True, 200),   # recurrentgemma-2b's heads, window
]
# Phase 7's bf16 tolerance of chip_smoke.py: one bf16 rounding of the output.
BF16_ATOL, BF16_RTOL = 1e-5, 2.0 ** -7


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal,window", EMULATION_SHAPES)
def test_flash_bf16_split_p_stays_within_one_rounding(B, Sq, Sk, H, Hkv, D, causal, window):
    (_, qt), (_, kt), (_, vt) = _inputs(
        Sq + Sk + D, [(B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)], "bfloat16")
    want = flash_attention_ref(qt, kt, vt, causal=causal, window=window)
    got = flash_attention_bf16_emulation(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=BF16_ATOL, rtol=BF16_RTOL)


def test_flash_bf16_one_rounding_of_p_leaves_the_tolerance():
    """Why P.V is split: P rounded to bf16 once misses the bf16 tolerance."""
    (_, qt), (_, kt), (_, vt) = _inputs(3, [(1, 300, 8, 64), (1, 300, 1, 64), (1, 300, 1, 64)],
                                        "bfloat16")
    want = flash_attention_ref(qt, kt, vt).float()
    once = flash_attention_bf16_emulation(qt, kt, vt, split_p=False).float()
    split = flash_attention_bf16_emulation(qt, kt, vt).float()

    def outside(got):
        return int(((got - want).abs() > BF16_ATOL + BF16_RTOL * want.abs()).sum())

    assert outside(split) == 0
    assert outside(once) > 0.01 * want.numel()
