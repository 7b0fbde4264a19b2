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
    (64, 96, 11569, 4),  # one machine past the one-block layout's widest m (shared maps)
    (24, 130, 16380, 5),  # 20/70/90 x 91 machines: the kernel's machine-tiled layout
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


# The one-block layout's widest m (ROADMAP C-port-4): one row's accumulators
# and its two staged tiles must fit one block's 232 448 bytes of shared
# memory (csrc/sched_scoring.cu, ``acc_doubles`` and ``warp_smem``). By hand: the
# tiles take 2 x 136 int32 (task ids), as many again for (B, T) components,
# and 2 x 132 float64 for (B, T) unit rates; the accumulators take
# 2m (3m with memory) + (m + 1) // 2 + 1 doubles, rounded down to even.
#   shared maps:      232 448 - 1 088 = 231 360 B = 28 920 doubles -> m = 11 568
#   per-row unit:     232 448 - 3 200 -> 28 656 doubles            -> m = 11 462
#   per-row maps:     232 448 - 4 288 -> 28 520 doubles            -> m = 11 408
#   memory, shared:   28 920 doubles, 3.5 m + 1                    -> m =  8 262
#   memory, per-row:  28 520 doubles                               -> m =  8 148
@pytest.mark.parametrize("use_mem,row_comp,row_uir,limit", [
    (False, False, False, 11568),
    (False, False, True, 11462),
    (False, True, True, 11408),
    (True, False, False, 8262),
    (True, True, True, 8148),
])
def test_max_machines_by_hand(use_mem, row_comp, row_uir, limit):
    assert ops.max_machines(use_mem, row_comp, row_uir) == limit
    assert ops.warp_smem(limit, use_mem, row_comp, row_uir) <= ops.BLOCK_SMEM_BYTES
    assert ops.warp_smem(limit + 1, use_mem, row_comp, row_uir) > ops.BLOCK_SMEM_BYTES


# The machine-tiled layout past it: the most machines, a multiple of 32,
# whose warp takes at most TILE_WARP_BYTES = 27 648 bytes. By hand, with
# the tiles' bytes above: shared maps, w = 1 312: (2 624 + 656 + 1) // 2 * 2
# = 3 280 doubles = 26 240 B + 1 088 = 27 328 (1 344: 28 000); memory and
# per-row maps, w = 832: (2 496 + 416 + 1) // 2 * 2 = 2 912 doubles = 23 296
# B + 4 288 = 27 584 (864: 28 480). 16 380 machines take 13 and 20 tiles.
@pytest.mark.parametrize("use_mem,row_comp,row_uir,m,tiles", [
    (False, False, False, 11568, (11568, 1)),   # the one-block layout's widest
    (False, False, False, 11569, (1312, 9)),
    (False, False, False, 16380, (1312, 13)),
    (False, True, True, 16380, (1152, 15)),
    (True, False, False, 8263, (928, 9)),
    (True, True, True, 8148, (8148, 1)),
    (True, True, True, 16380, (832, 20)),
])
def test_machine_tiles_by_hand(use_mem, row_comp, row_uir, m, tiles):
    assert ops.machine_tiles(m, use_mem, row_comp, row_uir) == tiles
    width, count = tiles
    if count > 1:
        assert width % 32 == 0 and (count - 1) * width < m <= count * width
        assert ops.warp_smem(width, use_mem, row_comp, row_uir) <= ops.TILE_WARP_BYTES
        assert ops.warp_smem(width + 32, use_mem, row_comp, row_uir) > ops.TILE_WARP_BYTES


@pytest.mark.parametrize("resources", [False, True])
def test_wrapper_refuses_past_the_limit_before_any_launch(monkeypatch, resources):
    """At ``max_machines`` the launcher reaches the library with the
    one-block layout (tile width m); one machine past it, with the
    machine-tiled layout (``machine_tiles``' width). Here the library is a
    stand-in that records the call and stops it, so no launch counts."""
    from repro_torch.kernels.sched_scoring import kernel

    class Launching(Exception):
        pass

    calls = []

    class Library:
        @staticmethod
        def sched_scoring_launch(*args):
            calls.append(args)
            raise Launching

    monkeypatch.setattr(kernel, "load_library", Library)
    # The launcher asks torch for the card's index and stream: stand-ins too.
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("Stream", (), {"cuda_stream": 0})())
    limit = ops.max_machines(resources, False, False)
    for m, tile_w in ((limit, limit), (limit + 1, ops.machine_tiles(limit + 1, resources,
                                                                     False, False)[0])):
        args, kw = _tensors(*_problem(3, 4, 9, m, 2, resources=resources))
        before = dict(ops.LAUNCHES)
        with pytest.raises(Launching):
            ops._launch(*args, kw.get("net_var"), kw.get("mem_c"), kw.get("mem_capacity"))
        assert ops.LAUNCHES == before
        *_, B, T, m_arg, tile_arg, res_arg, _stream = calls[-1]
        assert (B, T, m_arg, tile_arg, res_arg) == (4, 9, m, tile_w, int(resources))
    assert calls[0][-3] == limit and calls[1][-3] < limit


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


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["limit + 1", "16380", "one past a whole tile"])
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("resources", [False, True])
def test_cuda_machine_tiled_kernel_matches_plain_version(cuda_device, where, per_row, resources):
    """Past ``max_machines`` the machine-tiled layout: one launch a call,
    equal to the plain version on the CPU bit for bit and to its own rerun,
    ids outside [0, m) among the tasks; at the layout's first m, at 16 380
    machines and where the last tile holds one machine."""
    limit = ops.max_machines(resources, per_row, per_row)
    width = ops.machine_tiles(limit + 1, resources, per_row, per_row)[0]
    m = {"limit + 1": limit + 1, "16380": 16380,
         "one past a whole tile": (limit // width + 1) * width + 1}[where]
    tm, comp, uir, e_cm, met_cm, cap, extras = _problem(m % 1000, 40, 478, m, 4, per_row,
                                                        resources)
    rng = np.random.default_rng(m)
    tm[3:, ::11] = rng.choice([-1, m, m + 9], size=tm[3:, ::11].shape)
    tm[3:, 5] = m - 1  # the last tile's machines
    args, kw = _tensors(tm, comp, uir, e_cm, met_cm, cap, extras)
    plain = ops.sched_scoring(*args, **kw)
    name = "sched_scoring_resources" if resources else "sched_scoring"
    g_args = [a.to(cuda_device) for a in args]
    g_kw = {k: v.to(cuda_device) for k, v in kw.items()}
    before = ops.LAUNCHES[name]
    got = ops.sched_scoring(*g_args, **g_kw)
    again = ops.sched_scoring(*g_args, **g_kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[name] == before + 2
    assert torch.equal(got.cpu(), plain) and torch.equal(got, again)
    assert int((plain == 0.0).sum()) >= 3


# --- The order of the CUDA kernel's design, pinned on the CPU -------------
#
# csrc/sched_scoring.cu gives a row one warp. Lane l takes task j0 + l of
# each group of 32 tasks; lanes whose tasks land on one machine add in lane
# (= task) order, the k-th of them in round k. At the end the machines are
# split over owners (lane g takes w = g mod 32) and the owners' partial
# min and "infeasible" flags combine by an xor tree. The twin below does
# exactly that in scalar float64 and must equal the plain version bit for
# bit; `owners` also takes 1 and 8 to show the split never matters. Past
# ``max_machines`` a warp takes one tile of the row's machines: only its
# tasks, in the same rounds, and a second pass takes the tiles' partials in
# order; `tile` runs the twin so, at tile edges (the last tile one machine
# wide, or whole) and at the kernel's own width.

def _scorer_twin(tm, comp, uir, e_cm, met_cm, cap, net=None, mem_c=None, mem_cap=None,
                 owners=32, group=32, tile=None):
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
        # One tile of all m machines, or tiles of `tile` (the machine-tiled
        # layout: a warp a tile, the tiles' partials taken in tile order).
        row_rate, row_bad = float("inf"), False
        for w0 in range(0, m, tile or max(m, 1)):
            w1 = min(w0 + (tile or m), m)
            rate, bad = [float("inf")] * owners, [False] * owners
            for g in range(owners):
                for w in range(w0 + g, w1, owners):
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
            row_rate, row_bad = min(row_rate, rate[0]), row_bad or bad[0]
        out[b] = 0.0 if row_bad else max(row_rate, 0.0)
    return out


@pytest.mark.parametrize("owners", [1, 8, 32])
@pytest.mark.parametrize("m", [
    1, 3, 17, 180,
    # Machine tiles (m, tile): the last tile one machine wide, whole tiles,
    # tiles not a multiple of 32, and the kernel's own width for shared maps.
    pytest.param((17, 16), id="17-in-tiles-of-16"),
    pytest.param((180, 32), id="180-in-tiles-of-32"),
    pytest.param((181, 60), id="181-in-tiles-of-60"),
    pytest.param((1313, 1312), id="1313-in-tiles-of-1312"),
])
@pytest.mark.parametrize("resources", [False, True])
def test_kernel_order_twin_bit_identical_to_plain_version(owners, m, resources):
    m, tile = m if isinstance(m, tuple) else (m, None)
    T = {1: 37, 3: 70, 17: 130, 180: 533}.get(m, 211)
    B = 6 if m == 180 else 11
    tm, comp, uir, e_cm, met_cm, cap, extras = _problem(m + owners, B, T, m, 4, per_row=m == 17,
                                                        resources=resources)
    rng = np.random.default_rng(m)
    tm[:, ::7] = rng.choice([-1, m, m + 5], size=tm[:, ::7].shape)  # ids outside [0, m)
    if tile:  # tasks on both sides of the tile edges
        tm[3:, 1::4] = rng.choice([tile - 1, tile, m - 1], size=tm[3:, 1::4].shape)
    if m == 3:
        cap = rng.uniform(2.0, 12.0, size=(B, m))  # per-row capacity
        if resources:
            extras["mem_capacity"] = rng.uniform(1.0, 8.0, size=(B, m))
    args, kw = _tensors(tm, comp, uir, e_cm, met_cm, cap, extras)
    plain = ops.sched_scoring(*args, **kw).numpy()
    twin = _scorer_twin(tm, comp, uir, e_cm, met_cm, cap, net=extras.get("net_var"),
                        mem_c=extras.get("mem_c"), mem_cap=extras.get("mem_capacity"),
                        owners=owners, tile=tile)
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
