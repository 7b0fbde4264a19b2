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


# Past ``max_machines`` a row keeps accumulators for the machines it
# touches alone, in a table of S + S // 2 + 1 slots for S = min(T, m): var,
# met (and mem) float64 and a machine id (int32) a slot, and a bit a
# machine (int32 words: 512, 2 048 bytes, at 16 380 machines), padded to 16
# bytes, beside the staged tiles (1 088, 3 200 or 4 288 bytes as above),
# within TILE_WARP_BYTES = 27 648. By hand, at 16 380 machines:
#   shared maps:     (27 648 - 1 088 - 2 048) / 20 -> H <= 1 225 -> S = 816 (816 + 408 + 1)
#   per-row unit:    (27 648 - 3 200 - 2 048) / 20 -> H <= 1 120 -> S = 746 (746 + 373 + 1)
#   per-row maps:    (27 648 - 4 288 - 2 048) / 20 -> H <= 1 065 -> S = 709 (709 + 354 + 1)
#   memory, shared:  24 512 / 28 -> H <= 875 -> S = 583 (583 + 291 + 1)
#   memory, per-row: 21 312 / 28 -> H <= 761 -> S = 507 (507 + 253 + 1)
# At the paper's 478 tasks every operand layout takes the table: 478 + 239 +
# 1 = 718 slots; 20 x 718 + 2 048 = 16 408 -> 16 416 bytes + 1 088 = 17 504
# with shared maps, 28 x 718 + 2 048 = 22 152 -> 22 160 + 4 288 = 26 448
# with memory and per-row maps.
@pytest.mark.parametrize("use_mem,row_comp,row_uir,tasks,bytes_478", [
    (False, False, False, 816, 17504),
    (False, False, True, 746, 19616),
    (False, True, True, 709, 20704),
    (True, False, False, 583, 23248),
    (True, True, True, 507, 26448),
])
def test_table_slots_by_hand(use_mem, row_comp, row_uir, tasks, bytes_478):
    flags = (use_mem, row_comp, row_uir)
    limit = ops.max_machines(*flags)
    assert ops.max_table_tasks(16380, *flags) == tasks
    assert ops.table_slots(478, 16380, *flags) == 718
    assert ops.table_bytes(718, 16380, *flags) == bytes_478
    slots = tasks + tasks // 2 + 1
    assert ops.table_bytes(slots, 16380, *flags) <= ops.TILE_WARP_BYTES
    assert ops.table_bytes(slots + 2, 16380, *flags) > ops.TILE_WARP_BYTES
    # The three layouts' boundaries: m past max_machines, then T past the table.
    most = ops.max_table_tasks(limit + 1, *flags)
    assert ops.table_slots(most, limit, *flags) == 0                      # the one-block layout
    assert ops.table_slots(most, limit + 1, *flags) == most + most // 2 + 1  # the table
    assert ops.table_slots(most + 1, limit + 1, *flags) == 0              # the machine tiles
    assert ops.table_slots(2, limit + 1, *flags) == 4                     # 2 + 1 + 1
    assert ops.table_slots(0, limit + 1, *flags) == 1                     # one free slot, always
    # The bitmap grows with m: past ~200 000 machines not even an empty row fits.
    assert ops.max_table_tasks(1_000_000, *flags) == -1
    assert ops.table_slots(1, 1_000_000, *flags) == 0


@pytest.mark.parametrize("resources", [False, True])
def test_wrapper_refuses_past_the_limit_before_any_launch(monkeypatch, resources):
    """At ``max_machines`` the launcher reaches the library with the
    one-block layout (tile width m, no table); one machine past it, with
    the table (``table_slots``, tile width 0) up to ``max_table_tasks``
    tasks, and past those with the machine-tiled layout (``machine_tiles``'
    width, no table). Here the library is a stand-in that records the call
    and stops it, so no launch counts."""
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
    tasks = ops.max_table_tasks(limit + 1, resources, False, False)
    tiles = ops.machine_tiles(limit + 1, resources, False, False)[0]
    # Scratch, which the wrapper allocates: none for one block a row; the
    # table's list of failing machines, m + 1 int32, unless net_var (the
    # resource variant here) streams every machine; the tiles' partials, a
    # float64 and an int32 a (row, tile).
    tiled_scratch = 4 * -(-(limit + 1) // tiles) * 12
    for m, T, tile_w, slots, n_scratch in (
            (limit, 9, limit, 0, 0),
            (limit + 1, 9, 0, 14, 0 if resources else 4 * (limit + 2)),
            (limit + 1, tasks, 0, tasks + tasks // 2 + 1, 0 if resources else 4 * (limit + 2)),
            (limit + 1, tasks + 1, tiles, 0, tiled_scratch)):
        args, kw = _tensors(*_problem(3, 4, T, m, 2, resources=resources))
        before = dict(ops.LAUNCHES)
        with pytest.raises(Launching):
            ops._launch(*args, kw.get("net_var"), kw.get("mem_c"), kw.get("mem_capacity"))
        assert ops.LAUNCHES == before
        *_, scratch, scratch_bytes, B, T_arg, m_arg, tile_arg, slots_arg, res_arg, _stream = (
            calls[-1])
        assert (B, T_arg, m_arg, tile_arg, slots_arg, res_arg) == (4, T, m, tile_w, slots,
                                                                   int(resources))
        assert scratch_bytes == n_scratch and (scratch is None) == (n_scratch == 0)
    assert tiles < limit and (resources and tiles == 928 or not resources and tiles == 1312)


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


def _wide_case(cuda_device, where, per_row, resources, tiled):
    """One launch a call past ``max_machines``, equal to the plain version on
    the CPU bit for bit and to its own rerun, ids outside [0, m) among the
    tasks; at the first m past ``max_machines``, at 16 380 machines and where
    the machine tiles' last one holds one machine. At the paper's 478 tasks
    a row takes the table layout; at ``max_table_tasks`` + 1, the tiles."""
    flags = (resources, per_row, per_row)
    limit = ops.max_machines(*flags)
    width = ops.machine_tiles(limit + 1, *flags)[0]
    m = {"limit + 1": limit + 1, "16380": 16380,
         "one past a whole tile": (limit // width + 1) * width + 1}[where]
    T = ops.max_table_tasks(m, *flags) + 1 if tiled else 478
    assert (ops.table_slots(T, m, *flags) == 0) == tiled
    tm, comp, uir, e_cm, met_cm, cap, extras = _problem(m % 1000, 40, T, m, 4, per_row,
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


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["limit + 1", "16380", "one past a whole tile"])
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("resources", [False, True])
def test_cuda_machine_tiled_kernel_matches_plain_version(cuda_device, where, per_row, resources):
    """The machine-tiled layout, one task past the table's most."""
    _wide_case(cuda_device, where, per_row, resources, tiled=True)


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["limit + 1", "16380", "one past a whole tile"])
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("resources", [False, True])
def test_cuda_table_kernel_matches_plain_version(cuda_device, where, per_row, resources):
    """The table layout, at the paper's 478 tasks."""
    _wide_case(cuda_device, where, per_row, resources, tiled=False)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "one machine", "distinct machines", "ids outside", "untouched cap < 0",
    "untouched mem_cap < 0", "per-row capacity, zero net row", "at the table boundary",
    "past the table boundary", "past the table boundary, memory and network"])
def test_cuda_table_kernel_matches_plain_version_at_edges(cuda_device, case):
    """``chip_smoke.py``'s edge shapes of the table layout on 16 380
    machines (past its most tasks, the machine tiles): one launch a call,
    equal to the plain version on the CPU bit for bit and to its rerun."""
    from torch_paper_common import chip_smoke

    args, extras = chip_smoke().table_edge_problem(np, ops, case, 16380)
    c_args, c_kw = _tensors(*args, extras)
    plain = ops.sched_scoring(*c_args, **c_kw)
    name = "sched_scoring_resources" if extras else "sched_scoring"
    g_args = [a.to(cuda_device) for a in c_args]
    g_kw = {k: v.to(cuda_device) for k, v in c_kw.items()}
    before = ops.LAUNCHES[name]
    got = ops.sched_scoring(*g_args, **g_kw)
    again = ops.sched_scoring(*g_args, **g_kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[name] == before + 2
    assert torch.equal(got.cpu(), plain) and torch.equal(got, again)


# --- The order of the CUDA kernel's design, pinned on the CPU -------------
#
# csrc/sched_scoring.cu gives a row one warp. Lane l takes task j0 + l of
# each group of 32 tasks; lanes whose tasks land on one machine add in lane
# (= task) order, the k-th of them in round k. At the end the machines are
# split over owners (lane g takes w = g mod 32) and the owners' partial
# min and "infeasible" flags combine by an xor tree. The twin below does
# exactly that in scalar float64 and must equal the plain version bit for
# bit; `owners` also takes 1 and 8 to show the split never matters. Past
# ``max_machines`` a warp keeps a table of the machines its row touches:
# `table` runs the twin so, finalizing those machines alone and failing a
# row that misses a machine with cap_w < 0 or mem_cap_w < 0, or, with a
# (B, m) operand, every machine from its accumulators or from zeros. Past
# ``max_table_tasks`` a warp takes one tile of the row's machines: only its
# tasks, in the same rounds, and a second pass takes the tiles' partials in
# order; `tile` runs the twin so, at tile edges (the last tile one machine
# wide, or whole) and at the kernel's own width.

def _scorer_twin(tm, comp, uir, e_cm, met_cm, cap, net=None, mem_c=None, mem_cap=None,
                 owners=32, group=32, tile=None, table=False):
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
        mcap = None if mem_c is None else mem_cap[b] if mem_cap.ndim == 2 else mem_cap
        # The table: the touched machines alone, in slot order (a hash's:
        # any order), where no (B, m) operand asks for every machine.
        machines = range(m)
        rows_m = cap.ndim == 2 or net is not None or (mem_c is not None and mem_cap.ndim == 2)
        row_bad = False
        if table and not rows_m:
            touched = {int(w) for w in tm[b] if 0 <= w < m}
            machines = sorted(touched, key=lambda w: (w * 2654435769) % 2**32)
            row_bad = any(float(cap_row[w]) - 0.0 < 0.0
                          or (mcap is not None and 0.0 > float(mcap[w]))
                          for w in range(m) if w not in touched)
        # One tile of all m machines, or tiles of `tile` (the machine-tiled
        # layout: a warp a tile, the tiles' partials taken in tile order).
        row_rate = float("inf")
        for w0 in range(0, len(machines), tile or max(len(machines), 1)):
            w1 = min(w0 + (tile or len(machines)), len(machines))
            rate, bad = [float("inf")] * owners, [False] * owners
            for g in range(owners):
                for w in (machines[k] for k in range(w0 + g, w1, owners)):
                    v = var[w] + float(net[b, w]) if net is not None else var[w]
                    head = float(cap_row[w]) - met[w]
                    bad[g] |= head < 0.0
                    if mem_c is not None:
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


TABLE_EDGES = ["one machine", "distinct machines", "ids outside", "untouched cap < 0",
               "untouched mem_cap < 0", "per-row capacity, zero net row"]


@pytest.mark.parametrize("case", TABLE_EDGES)
def test_table_twin_bit_identical_to_plain_version(case):
    """The table layout's order and its finalize over touched machines (or,
    with a (B, m) operand, every machine) equal the plain version at
    ``chip_smoke.py``'s edge shapes, here at 300 machines."""
    from torch_paper_common import chip_smoke

    (tm, comp, uir, e_cm, met_cm, cap), extras = chip_smoke().table_edge_problem(
        np, ops, case, 300, B=12, T=60)
    args, kw = _tensors(tm, comp, uir, e_cm, met_cm, cap, extras)
    plain = ops.sched_scoring(*args, **kw).numpy()
    twin = _scorer_twin(tm, comp, uir, e_cm, met_cm, cap, net=extras.get("net_var"),
                        mem_c=extras.get("mem_c"), mem_cap=extras.get("mem_capacity"),
                        table=True)
    assert np.array_equal(plain, twin)
    if case.startswith("untouched"):  # machine 299 fails every row: only row 5 touches it
        assert not plain.any()


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
