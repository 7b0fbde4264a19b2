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


# --- The order of the CUDA kernel's design, pinned on the CPU -------------
#
# csrc/sched_scoring.cu gives a row one warp. Lane l takes task j0 + l of
# each group of 32 tasks; lanes whose tasks land on one machine add in lane
# (= task) order, the k-th of them in round k. At the end the machines are
# split over owners (lane g takes w = g mod 32) and the owners' partial
# min and "infeasible" flags combine by an xor tree. The twin below does
# exactly that in scalar float64 and must equal the plain version bit for
# bit; `owners` also takes 1 and 8 to show the split never matters.

def _scorer_twin(tm, comp, uir, e_cm, met_cm, cap, net=None, mem_c=None, mem_cap=None,
                 owners=32, group=32):
    B, T = tm.shape
    m = e_cm.shape[1]
    out = np.empty(B)
    for b in range(B):
        c_row = comp[b] if comp.ndim == 2 else comp
        u_row = uir[b] if uir.ndim == 2 else uir
        var, met, mem = [0.0] * m, [0.0] * m, [0.0] * m
        for j0 in range(0, T, group):
            lanes = range(j0, min(j0 + group, T))
            ws = [int(tm[b, j]) if 0 <= tm[b, j] < m else -1 for j in lanes]
            ranks = [ws[:i].count(w) for i, w in enumerate(ws)]
            for k in range(max(ranks, default=0) + 1):
                for i, j in enumerate(lanes):
                    w = ws[i]
                    if w < 0 or ranks[i] != k:
                        continue
                    c = int(c_row[j])
                    var[w] = var[w] + float(e_cm[c, w]) * float(u_row[j])
                    met[w] = met[w] + float(met_cm[c, w])
                    if mem_c is not None:
                        mem[w] = mem[w] + float(mem_c[c])
        cap_row = cap[b] if cap.ndim == 2 else cap
        rate, bad = [float("inf")] * owners, [False] * owners
        for g in range(owners):
            for w in range(g, m, owners):
                v = var[w] + float(net[b, w]) if net is not None else var[w]
                head = float(cap_row[w]) - met[w]
                bad[g] |= head < 0.0
                if mem_c is not None:
                    mcap = mem_cap[b] if mem_cap.ndim == 2 else mem_cap
                    bad[g] |= mem[w] > float(mcap[w])
                if v > 0.0:
                    rate[g] = min(rate[g], head / max(v, 1e-300))
        off = owners // 2
        while off:
            rate = [min(rate[g], rate[g ^ off]) for g in range(owners)]
            bad = [bad[g] or bad[g ^ off] for g in range(owners)]
            off //= 2
        out[b] = 0.0 if bad[0] else max(rate[0], 0.0)
    return out


@pytest.mark.parametrize("owners", [1, 8, 32])
@pytest.mark.parametrize("m", [1, 3, 17, 180])
@pytest.mark.parametrize("resources", [False, True])
def test_kernel_order_twin_bit_identical_to_plain_version(owners, m, resources):
    T = {1: 37, 3: 70, 17: 130, 180: 533}[m]
    B = 6 if m == 180 else 11
    tm, comp, uir, e_cm, met_cm, cap, extras = _problem(m + owners, B, T, m, 4, per_row=m == 17,
                                                        resources=resources)
    rng = np.random.default_rng(m)
    tm[:, ::7] = rng.choice([-1, m, m + 5], size=tm[:, ::7].shape)  # ids outside [0, m)
    if m == 3:
        cap = rng.uniform(2.0, 12.0, size=(B, m))  # per-row capacity
        if resources:
            extras["mem_capacity"] = rng.uniform(1.0, 8.0, size=(B, m))
    args, kw = _tensors(tm, comp, uir, e_cm, met_cm, cap, extras)
    plain = ops.sched_scoring(*args, **kw).numpy()
    twin = _scorer_twin(tm, comp, uir, e_cm, met_cm, cap, net=extras.get("net_var"),
                        mem_c=extras.get("mem_c"), mem_cap=extras.get("mem_capacity"),
                        owners=owners)
    assert np.array_equal(plain, twin)


def test_plain_version_ignores_ids_outside_machines():
    # A task on an id outside [0, m) adds to no machine: the row scores as
    # if the task were absent (its unit_ir set to 0 and its met to 0).
    tm, comp, uir, e_cm, met_cm, cap, _ = _problem(3, 9, 20, 5, 3)
    bad = tm.copy()
    bad[:, 4] = -1
    bad[:, 11] = 5
    args, _ = _tensors(bad, comp, uir, e_cm, met_cm, cap, {})
    got = ops.sched_scoring(*args).numpy()
    keep = np.ones(20, dtype=bool)
    keep[[4, 11]] = False
    args, _ = _tensors(np.ascontiguousarray(tm[:, keep]), np.ascontiguousarray(comp[keep]),
                       np.ascontiguousarray(uir[keep]), e_cm, met_cm, cap, {})
    assert np.array_equal(got, ops.sched_scoring(*args).numpy())
