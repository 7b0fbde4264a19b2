"""Port parity: the scheduling-score kernel's wrapper and plain version.

On CPU tensors ``ops.sched_scoring`` runs the plain PyTorch version, which
must equal the reference's NumPy oracle (``repro/kernels/sched_scoring/
ref.py``, fed the pre-gathered operands) bit for bit, and the Pallas kernel
in interpret mode to the ``_assert_parity`` contract (<= 1e-12, identical
mask and argmax). The CUDA kernel itself runs only on a card: the test
marked ``cuda`` holds it against the plain version there.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.sched_scoring.ref import sched_scoring_ref as numpy_oracle  # noqa: E402
from repro_torch.kernels.sched_scoring import ops  # noqa: E402


def _problem(seed, B, T, m, n, per_row=False, resources=False):
    rng = np.random.default_rng(seed)
    tm = rng.integers(0, m, size=(B, T))
    comp = np.sort(rng.integers(0, n, size=(B, T) if per_row else T), axis=-1)
    uir = rng.uniform(0.05, 1.5, size=(B, T) if per_row else T)
    e_cm = rng.uniform(0.3, 3.0, size=(n, m))
    met_cm = rng.uniform(0.0, 0.4, size=(n, m))
    cap = rng.uniform(2.0, 12.0, size=m)
    if B >= 3:
        tm[:3, :] = 0
        met_cm[:, 0] = cap[0]  # rows 0-2 infeasible at any rate
    extras = {}
    if resources:
        extras = dict(
            net_var=rng.uniform(0.0, 0.4, size=(B, m)),
            mem_c=rng.uniform(0.0, 1.5, size=n),
            mem_capacity=rng.uniform(1.0, 8.0, size=m),
        )
    return tm, comp, uir, e_cm, met_cm, cap, extras


def _numpy_reference(tm, comp, uir, e_cm, met_cm, cap, extras):
    B, T = tm.shape
    cmap = comp if comp.ndim == 2 else comp[None, :]
    ev = e_cm[cmap, tm] * (uir if uir.ndim == 2 else uir[None, :])
    met = met_cm[cmap, tm]
    kw = {}
    if extras:
        kw = dict(
            net_var=extras["net_var"],
            mem=np.broadcast_to(extras["mem_c"][cmap], (B, T)),
            mem_capacity=extras["mem_capacity"],
        )
    return numpy_oracle(tm, ev, met, cap, **kw)


def _tensors(tm, comp, uir, e_cm, met_cm, cap, extras):
    t = torch.from_numpy
    args = (t(tm.astype(np.int32)), t(comp.astype(np.int32)), t(uir), t(e_cm), t(met_cm), t(cap))
    return args, {k: t(v) for k, v in extras.items()}


SHAPES = [
    (0, 7, 3, 4),        # empty batch: no work, empty result
    (1, 5, 1, 3),        # single machine, single row
    (1, 1, 4, 2),        # single task
    (17, 14, 3, 6),
    (33, 54, 15, 7),
    (9, 130, 16, 5),     # T past the Pallas task block (its padding path)
]


@pytest.mark.parametrize("B,T,m,n", SHAPES)
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("resources", [False, True])
def test_plain_version_bit_identical_to_numpy_oracle(B, T, m, n, per_row, resources):
    prob = _problem(B * 7 + T, B, T, m, n, per_row, resources)
    ref = _numpy_reference(*prob)
    args, kw = _tensors(*prob)
    before = dict(ops.LAUNCHES)
    got = ops.sched_scoring(*args, **kw).numpy()
    assert got.shape == (B,)
    assert np.array_equal(got, ref)
    assert ops.LAUNCHES == before  # the CPU path launches no kernel


def test_plain_version_per_row_capacity():
    tm, comp, uir, e_cm, met_cm, _, extras = _problem(4, 21, 19, 6, 4, resources=True)
    rng = np.random.default_rng(9)
    cap_bm = rng.uniform(1.0, 10.0, size=(21, 6))
    mem_cap_bm = rng.uniform(1.0, 8.0, size=(21, 6))
    args, kw = _tensors(tm, comp, uir, e_cm, met_cm, cap_bm, dict(extras, mem_capacity=mem_cap_bm))
    got = ops.sched_scoring(*args, **kw).numpy()
    # Row by row against the shared-capacity oracle.
    for b in range(21):
        one = _numpy_reference(
            tm[b : b + 1], comp, uir, e_cm, met_cm, cap_bm[b],
            dict(net_var=extras["net_var"][b : b + 1], mem_c=extras["mem_c"],
                 mem_capacity=mem_cap_bm[b]),
        )
        assert got[b] == one[0]


@pytest.fixture
def x64_alias(monkeypatch):
    """Scoped alias ``jax.experimental.enable_x64 -> jax.enable_x64``: the
    reference's Pallas entry imports the former, which this JAX lacks.
    Undone after the test, so no other test in the worker sees it."""
    jax = pytest.importorskip("jax")
    import jax.experimental

    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)
    return jax


@pytest.mark.parametrize("B,T,m,n,resources", [
    (0, 7, 3, 4, False),
    (17, 14, 3, 6, False),
    (9, 130, 16, 5, False),
    (13, 40, 5, 4, True),
    (7, 133, 9, 3, True),
])
def test_plain_version_matches_pallas_interpret(x64_alias, B, T, m, n, resources):
    from repro.kernels.sched_scoring.ops import closed_form_rates_sched

    tm, comp, uir, e_cm, met_cm, cap, extras = _problem(B + m, B, T, m, n, resources=resources)
    kw = {}
    if resources:
        kw = dict(net_var=extras["net_var"], mem=extras["mem_c"][comp],
                  mem_capacity=extras["mem_capacity"])
    r_ref, _ = closed_form_rates_sched(tm, comp, uir, e_cm, met_cm, cap, impl="interpret", **kw)
    args, tkw = _tensors(tm, comp, uir, e_cm, met_cm, cap, extras)
    got = ops.sched_scoring(*args, **tkw).numpy()
    np.testing.assert_allclose(got, r_ref, rtol=1e-12, atol=1e-12)
    assert np.array_equal(got == 0.0, r_ref == 0.0)
    if B:
        assert int(np.argmax(got)) == int(np.argmax(r_ref))


def test_wrapper_rejects_bad_operands():
    tm, comp, uir, e_cm, met_cm, cap, extras = _problem(1, 5, 6, 3, 2, resources=True)
    args, kw = _tensors(tm, comp, uir, e_cm, met_cm, cap, extras)
    with pytest.raises(TypeError):
        ops.sched_scoring(args[0].long(), *args[1:])
    with pytest.raises(ValueError):
        ops.sched_scoring(args[0], args[1][:-1], *args[2:])
    with pytest.raises(ValueError):
        ops.sched_scoring(*args, mem_c=kw["mem_c"])  # memory needs its capacity
    with pytest.raises(ValueError):
        ops.sched_scoring(args[0].t(), *args[1:])  # wrong shape / layout


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("resources", [False, True])
def test_cuda_kernel_matches_plain_version(cuda_device, per_row, resources):
    prob = _problem(17, 300, 478, 180, 4, per_row, resources)
    args, kw = _tensors(*prob)
    plain = ops.sched_scoring(*args, **kw)
    name = "sched_scoring_resources" if resources else "sched_scoring"
    before = ops.LAUNCHES[name]
    got = ops.sched_scoring(
        *(a.to(cuda_device) for a in args), **{k: v.to(cuda_device) for k, v in kw.items()}
    )
    torch.cuda.synchronize()
    assert ops.LAUNCHES[name] == before + 1
    assert torch.equal(got.cpu(), plain)
