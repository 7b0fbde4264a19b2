"""Port parity: the cut-traffic kernel's wrapper, plain version and order.

``kernels/cut_traffic`` computes the (B, m) network term that feeds B2.
On CPU tensors ``ops.cut_traffic`` runs the plain version (the eager body
``network_unit_load`` ran before the kernel), which is held here against
``repro.core.cost_model.network_unit_load`` (to 1e-12: the reference
contracts distances with a BLAS product, the port in machine order) and
against a scalar twin of the CUDA kernel's order (bit for bit). The
kernel itself runs only on a card: the tests marked ``cuda`` hold it
against the plain version there.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
from repro.core import cost_model as rcm  # noqa: E402
from repro_torch.kernels.cut_traffic import ops  # noqa: E402

TOPOLOGIES = {
    "linear": lambda: R.linear_topology(alpha=1.2),
    "diamond": lambda: R.diamond_topology(alpha=1.3),
    "star": lambda: R.star_topology(alpha=0.8),
    "wide_fanout": lambda: R.wide_fanout_topology(),
}
# Topologies held on the card only: wider than the kernel's shared memory
# holds at m = 180 (98 contracted components a row).
WIDE = {"fanout_of_48": lambda: R.wide_fanout_topology(n_mid=48)}


def _problem(seed, topology, B, m, regime, outside=False):
    """Task maps as the scorer's sweeps build them: shared counts, per-row
    counts, or per-row counts with skewed per-task unit rates; with
    ``outside``, every 5th task on an id outside [0, m)."""
    rng = np.random.default_rng(seed)
    utg = {**TOPOLOGIES, **WIDE}[topology]()
    n = utg.n_components
    n_inst = rng.integers(1, 4, size=n)
    T = int(n_inst.sum())
    cir = rcm.component_rates(utg, 1.0)
    if regime == "shared":
        comp = np.repeat(np.arange(n), n_inst)
        uir = (cir / n_inst)[comp]
    else:
        counts = np.tile(n_inst, (B, 1))
        grow = rng.integers(0, n, size=B)
        shrink = np.flatnonzero(n_inst > 1)[0] if np.any(n_inst > 1) else None
        if shrink is not None:
            counts[np.arange(B), grow] += 1
            counts[np.arange(B), shrink] -= 1
        comp, uir = rcm.per_row_task_maps(cir, counts, T)
        if regime == "skew":
            uir = uir * rng.uniform(0.3, 1.7, size=uir.shape)
    tm = rng.integers(0, m, size=(B, T))
    if outside:
        tm[:, ::5] = rng.choice([-1, m, m + 2], size=tm[:, ::5].shape)
    dist = np.asarray(R.rack_distance_matrix(rng.integers(0, 3, size=m), 1.0, 2.5))
    return tm, comp, uir, np.asarray(utg.alpha, dtype=np.float64), cir, utg.edges, dist


def _tensors(tm, comp, uir, alpha, cir, edges, dist):
    t = torch.from_numpy
    return (t(tm.astype(np.int32)), t(comp.astype(np.int32)), t(uir), t(alpha), t(cir),
            edges, t(dist))


def _twin_masses(tm, comp, uir, alpha, cir, edges, m, owners, chunk):
    """The kernel's steps 1-2, one scalar at a time: per task the sender
    output and receiver share; the masses x[slot][w] of each row in chunks
    of ``chunk`` tasks, each owner adding its own machines' (w = g mod
    owners) tasks in increasing order. Returns (k2, each row's x)."""
    send_slot, recv_slot, _ = ops.edge_slots(edges, len(alpha))
    k2 = sum(s >= 0 for s in send_slot) + sum(s >= 0 for s in recv_slot)
    rows = []
    for b in range(tm.shape[0]):
        c_row = comp[b] if comp.ndim == 2 else comp
        u_row = uir[b] if uir.ndim == 2 else uir
        x = [[0.0] * m for _ in range(k2)]
        for t0 in range(0, tm.shape[1], chunk):
            for g in range(owners):
                for t in range(t0, min(t0 + chunk, tm.shape[1])):
                    w, c = int(tm[b, t]), int(c_row[t])
                    if not 0 <= w < m or w % owners != g:
                        continue  # ids outside [0, m) match no machine
                    u, cc = float(u_row[t]), float(cir[c])
                    if send_slot[c] >= 0:
                        s = send_slot[c]
                        x[s][w] = x[s][w] + float(alpha[c]) * u
                    if recv_slot[c] >= 0:
                        s = recv_slot[c]
                        x[s][w] = x[s][w] + (u / max(cc, 1e-300) if cc > 0.0 else 0.0)
        rows.append(x)
    return k2, rows


def _twin_edges(x, y, pairs, m, penalty):
    """Steps 4-5 of one row: the edges in order, then the penalty."""
    out = np.empty(m)
    with np.errstate(invalid="ignore"):  # 0 x inf where distance holds one
        for w in range(m):
            acc = 0.0
            for sa, rb in pairs:
                acc = acc + x[sa][w] * y[rb][w]
                acc = acc + x[rb][w] * y[sa][w]
            out[w] = acc * penalty
    return out


def _kernel_twin(tm, comp, uir, alpha, cir, edges, dist, penalty, owners=32, chunk=64):
    """The one-block layouts' arithmetic in their order, one scalar at a
    time: the masses (``_twin_masses``); the distance contraction over v =
    0, 1, ...; the edges in order; the penalty."""
    m = dist.shape[0]
    k2, masses = _twin_masses(tm, comp, uir, alpha, cir, edges, m, owners, chunk)
    pairs = ops.edge_slots(edges, len(alpha))[2]
    out = np.empty((tm.shape[0], m))
    for b, x in enumerate(masses):
        y = [[0.0] * m for _ in range(k2)]
        for s in range(k2):
            for w in range(m):
                acc = 0.0
                for v in range(m):
                    acc = acc + x[s][v] * float(dist[w, v])
                y[s][w] = acc
        out[b] = _twin_edges(x, y, pairs, m, penalty)
    return out


def _list_twin(tm, comp, uir, alpha, cir, edges, dist, penalty, group_rows):
    """The list layout's arithmetic in its order: the masses as
    ``list_masses_kernel`` adds them (4 warps of 32 lanes a row: owner w mod
    128, chunks of 32 tasks); per group of ``group_rows`` rows and list, the
    sorted columns where a row of the group holds a task of the list's
    component, or where ``distance`` holds an inf or a NaN
    (``ops.list_columns``); each Y[slot][w] summed over those columns alone,
    in increasing v (a numpy product and sum a column, over all w at once:
    each rounded once); the edges in order; the penalty."""
    m = dist.shape[0]
    k2, masses = _twin_masses(tm, comp, uir, alpha, cir, edges, m, 128, 32)
    pairs = ops.edge_slots(edges, len(alpha))[2]
    _, list_slots, _ = ops.contracted_lists(edges, len(alpha))
    lists = ops.list_columns(tm, comp, edges, len(alpha), ~np.isfinite(dist).all(axis=0),
                             group_rows)
    out = np.empty((tm.shape[0], m))
    for b, x in enumerate(masses):
        y = [None] * k2
        for cols, slots in zip(lists[b // group_rows], list_slots):
            for s in slots:
                if s >= 0:
                    acc = np.zeros(m)
                    with np.errstate(invalid="ignore"):
                        for v in cols:
                            acc = acc + x[s][v] * dist[:, v]
                    y[s] = acc
        out[b] = _twin_edges(x, y, pairs, m, penalty)
    return out


def _same_bits(a, b):
    """Equal bit for bit where not NaN, and NaN in the same places."""
    nan = np.isnan(a)
    return bool(np.array_equal(nan, np.isnan(b)) and np.array_equal(
        np.where(nan, 0.0, a).view(np.int64), np.where(nan, 0.0, b).view(np.int64)))


@pytest.mark.parametrize("topology", list(TOPOLOGIES))
@pytest.mark.parametrize("regime", ["shared", "per_row", "skew"])
def test_kernel_order_twin_bit_identical_to_plain_version(topology, regime):
    seed = 10 * list(TOPOLOGIES).index(topology) + ["shared", "per_row", "skew"].index(regime)
    prob = _problem(seed, topology, 5, 7, regime)
    plain = ops.cut_traffic(*_tensors(*prob), 0.3).numpy()
    for owners in (1, 32):
        twin = _kernel_twin(*prob, 0.3, owners=owners)
        assert np.array_equal(plain, twin), owners


@pytest.mark.parametrize("m", [1, 3])
def test_kernel_order_twin_few_machines(m):
    prob = _problem(m, "diamond", 9, m, "per_row")
    assert np.array_equal(ops.cut_traffic(*_tensors(*prob), 0.05).numpy(),
                          _kernel_twin(*prob, 0.05))


@pytest.mark.parametrize("m", [3, 7])
@pytest.mark.parametrize("regime", ["shared", "skew"])
def test_ids_outside_match_no_machine(m, regime):
    """A task on an id outside [0, m) adds to no cell, in the plain version
    and in the kernel's order alike: the result is that of the same
    placement with those tasks removed."""
    prob = _problem(40 + m, "diamond", 6, m, regime, outside=True)
    tm, comp, uir = prob[:3]
    plain = ops.cut_traffic(*_tensors(*prob), 0.2).numpy()
    assert np.array_equal(plain, _kernel_twin(*prob, 0.2))
    assert np.isfinite(plain).all()
    for b in range(tm.shape[0]):
        keep = (tm[b] >= 0) & (tm[b] < m)
        c_row = comp[b] if comp.ndim == 2 else comp
        u_row = uir[b] if uir.ndim == 2 else uir
        alone = (tm[b : b + 1, keep], c_row[keep], u_row[keep], *prob[3:])
        assert np.array_equal(plain[b], ops.cut_traffic(*_tensors(*alone), 0.2).numpy()[0])


@pytest.mark.parametrize("topology", list(TOPOLOGIES))
@pytest.mark.parametrize("regime", ["shared", "per_row", "skew"])
def test_plain_version_matches_reference(topology, regime):
    prob = _problem(7, topology, 23, 11, regime)
    tm, comp, uir, alpha, cir, edges, dist = prob
    ref = rcm.network_unit_load(tm, comp, uir, alpha, cir, edges, dist, 0.7)
    got = ops.cut_traffic(*_tensors(*prob), 0.7).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-14)
    # Row chunks of the plain version never change a row's floats.
    n = len(alpha)
    chunked = ops.cut_traffic(*_tensors(*prob), 0.7, chunk_elems=2 * n * 11).numpy()
    assert np.array_equal(chunked, got)


def test_wrapper_counts_no_launch_on_the_cpu():
    before = dict(ops.LAUNCHES)
    ops.cut_traffic(*_tensors(*_problem(1, "linear", 4, 5, "shared")), 1.0)
    empty = _problem(1, "linear", 0, 5, "shared")
    assert ops.cut_traffic(*_tensors(*empty), 1.0).shape == (0, 5)
    assert ops.LAUNCHES == before


def test_wrapper_rejects_bad_operands():
    tm, comp, uir, alpha, cir, edges, dist = _tensors(*_problem(2, "star", 4, 6, "shared"))
    with pytest.raises(ValueError, match="out of range"):
        ops.cut_traffic(tm, comp, uir, alpha, cir, edges + ((0, len(alpha)),), dist)
    with pytest.raises(ValueError, match="out of range"):
        ops.cut_traffic(tm, comp, uir, alpha, cir, ((-1, 2),), dist)
    with pytest.raises(ValueError, match="square"):
        ops.cut_traffic(tm, comp, uir, alpha, cir, edges, dist[:, :5].contiguous())
    with pytest.raises(TypeError):
        ops.cut_traffic(tm.long(), comp, uir, alpha, cir, edges, dist)
    with pytest.raises(TypeError):
        ops.cut_traffic(tm, comp, uir.float(), alpha, cir, edges, dist)
    with pytest.raises(TypeError):
        ops.cut_traffic(tm, comp, uir, alpha, cir, edges, dist.float())
    with pytest.raises(ValueError):
        ops.cut_traffic(tm, comp[:-1], uir, alpha, cir, edges, dist)


# Step 3's distance tiles span all m machines (padded to 64) while X^T and
# Y^T fit one block's shared memory: at K2 = 6 up to 1 600 machines, where
# the kernel's Y^T-apart layout takes 2 x 1 600 x 6 x 8 bytes of X^T and Y^T
# and three 2-column tiles of 1 602 doubles, 230 496 of 232 448 bytes
# (1 601 machines pad to 1 664: 239 712). Past it, the list layout's tiles
# of W_TILE = 128 machines.
@pytest.mark.parametrize("m, tiles", [
    (1, (64, 1)), (180, (192, 1)), (14_500, (128, 114)), (14_528, (128, 114)),
    (14_529, (128, 114)), (16_380, (128, 128)), (17_280, (128, 135)),
])
def test_distance_tiles_by_hand(m, tiles):
    assert ops.W_TILE == 128 and ops.GROUP_ROWS == 32
    assert ops.distance_tiles(m, 6) == tiles


# The one-block layouts' last machine count by K2: 6 (the linear
# topology), 18 (wide_fanout: Y^T apart, 2 x 640 x 18 x 8 + 3 x 2 x 642 x 8
# = 215 136 bytes; 704 machines take 233 280) and 98 (fanout of 48: at 128
# machines 2 x 128 x 102 x 8 + 9 216 = 218 112; at 192, 322 560).
@pytest.mark.parametrize("k2, last", [(6, 1_600), (18, 640), (98, 128)])
def test_one_block_boundary_by_hand(k2, last):
    assert ops.one_block(last, k2) and not ops.one_block(last + 1, k2)
    assert ops.distance_tiles(last + 1, k2) == (128, -(-(last + 1) // 128))


def test_list_wave_by_hand():
    """The list layout's scratch: X and Y of a wave's rows, 2 x 6 x 16 380
    float64 a row (1 572 480 bytes), and a group's lists, bitmaps and
    lengths, 4 x 4 x (16 380 + 512 + 1) int32 (270 288 bytes): 50 589 648
    bytes a group of 32 rows; the non-finite columns' 512 words once. The
    scratch stops growing with B at WAVE_BYTES // 50 589 648 = 7 groups."""
    assert ops.WAVE_BYTES == 384 << 20
    per_group = 32 * 1_572_480 + 270_288
    assert ops.list_wave(128, 6, 16_380, 4) == (128, 4 * per_group + 2_048)
    assert ops.list_wave(65_520, 6, 16_380, 4) == (224, 7 * per_group + 2_048)
    assert ops.list_wave(1, 6, 16_380, 4) == (32, per_group + 2_048)
    assert ops.list_wave(10**6, 6, 1_600, 4) == (0, 0)  # one block


def test_contracted_lists_by_hand():
    # linear: components 1 and 2 send and receive; 0 sends, 3 receives
    assert ops.contracted_lists(((0, 1), (1, 2), (2, 3)), 4) == (
        [2, 0, 1, 3], [(1, 3), (2, 4), (0, -1), (5, -1)], 2)
    # star: 2 both ways; 0 and 1 send, 3 and 4 receive
    assert ops.contracted_lists(((0, 2), (1, 2), (2, 3), (2, 4)), 5) == (
        [1, 2, 0, 3, 4], [(2, 3), (0, -1), (1, -1), (4, -1), (5, -1)], 1)
    # wide_fanout (18 slots): eight middle components both ways
    list_of, slots, n2 = ops.contracted_lists(R.wide_fanout_topology().edges, 10)
    assert (list_of, n2) == ([8, 0, 1, 2, 3, 4, 5, 6, 7, 9], 8)
    assert slots[:8] == [(1 + i, 9 + i) for i in range(8)] and slots[8:] == [(0, -1), (17, -1)]


def test_list_columns_by_hand():
    """Two groups of two rows of the linear topology on 8 machines; column
    6 of ``distance`` holds an inf, so every list holds it."""
    tm = np.array([[0, 1, 2, 3], [0, 5, 2, 3], [4, 4, -1, 8], [7, 1, 1, 2]])
    comp = np.array([0, 1, 2, 3])
    flags = np.zeros(8, dtype=bool)
    flags[6] = True
    lists = ops.list_columns(tm, comp, ((0, 1), (1, 2), (2, 3)), 4, flags, group_rows=2)
    assert [[c.tolist() for c in g] for g in lists] == [
        [[1, 5, 6], [2, 6], [0, 6], [3, 6]],   # lists: components 1, 2, 0, 3
        [[1, 4, 6], [1, 6], [4, 6, 7], [2, 6]],  # ids -1 and 8 match no machine
    ]


def _list_case(case, seed):
    """A list-layout case of the linear topology (or wide_fanout) on m
    machines: random per-row placements, or the case's shape."""
    topology = "wide_fanout" if case == "wide_fanout" else "linear"
    B, m = 7, 40 + 9 * seed
    prob = list(_problem(seed, topology, B, m, "skew" if case == "skew" else "per_row",
                         outside=case == "ids outside"))
    tm, comp, uir, _, _, _, dist = prob
    rng = np.random.default_rng(seed)
    if case == "rows share columns":  # one placement, one task moved a row
        tm[:] = tm[0]
        tm[np.arange(B), rng.integers(0, tm.shape[1], B)] = rng.integers(0, m, B)
    elif case == "rows share none":  # row b on machines [5 b, 5 b + 5)
        tm[:] = 5 * np.arange(B)[:, None] + rng.integers(0, 5, size=tm.shape)
    elif case.startswith("zero mass"):  # two tasks of one component cancel on machine 3
        c = next(c for c in range(len(prob[3])) if (comp[0] == c).sum() > 1)
        t0, t1 = np.flatnonzero(comp[0] == c)[:2]
        tm[0][tm[0] == 3] = 4
        tm[0, [t0, t1]] = 3
        uir[0, t1] = -uir[0, t0]
        if "inf" in case:
            dist = dist.copy()
            dist[5, 3] = np.inf
    elif case in ("inf, unoccupied column", "nan, unoccupied column"):
        tm[tm == 11] = 12
        dist = dist.copy()
        dist[4, 11] = np.inf if case.startswith("inf") else np.nan
    prob[0], prob[2], prob[6] = tm, uir, dist
    return prob


LIST_CASES = ["per_row", "skew", "rows share columns", "rows share none", "zero mass",
              "zero mass on an inf", "inf, unoccupied column", "nan, unoccupied column",
              "ids outside", "wide_fanout"]


@pytest.mark.parametrize("group_rows", [2, 3, 4])
@pytest.mark.parametrize("case", LIST_CASES)
def test_list_twin_bit_identical_to_plain_version(case, group_rows):
    """The list layout's order (each Y[slot][w] over its group's listed
    columns alone) gives the plain version's floats bit for bit, NaN where
    it gives NaN."""
    prob = _list_case(case, LIST_CASES.index(case))
    plain = ops.cut_traffic(*_tensors(*prob), 0.3).numpy()
    twin = _list_twin(*prob, 0.3, group_rows)
    assert _same_bits(plain, twin)
    assert np.isnan(plain).any() == ("inf" in case or "nan" in case)


def test_list_twin_needs_the_nonfinite_columns():
    """Without the non-finite columns in its lists the list order would miss
    the plain version's NaN (0 x inf): the rule is needed."""
    prob = _list_case("inf, unoccupied column", LIST_CASES.index("inf, unoccupied column"))
    plain = ops.cut_traffic(*_tensors(*prob), 0.3).numpy()
    lists = ops.list_columns(prob[0], prob[1], prob[5], len(prob[3]),
                             np.zeros(prob[6].shape[0], dtype=bool), 2)
    assert all(11 not in c for g in lists for c in g)
    assert np.isnan(plain[:, 4]).all() and np.isfinite(np.delete(plain, 4, axis=1)).all()


def test_edge_slots_order_sources_then_sinks():
    send, recv, pairs = ops.edge_slots(((0, 2), (1, 2), (2, 3), (2, 4)), 5)
    assert send == [0, 1, 2, -1, -1]
    assert recv == [-1, -1, 3, 4, 5]
    assert pairs == [(0, 3), (1, 3), (2, 4), (2, 5)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("topology", list(TOPOLOGIES))
@pytest.mark.parametrize("regime", ["shared", "per_row", "skew"])
def test_cuda_kernel_matches_plain_version(cuda_device, topology, regime):
    prob = _problem(3, topology, 70, 180, regime)
    args = _tensors(*prob)
    plain = ops.cut_traffic(*args, 0.05)
    before = ops.LAUNCHES["cut_traffic"]
    got = ops.cut_traffic(*(a.to(cuda_device) if isinstance(a, torch.Tensor) else a
                            for a in args), 0.05)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["cut_traffic"] == before + 1
    assert torch.equal(got.cpu(), plain)


@pytest.mark.cuda
@pytest.mark.parametrize("topology, m, B, outside", [
    ("fanout_of_48", 180, 9, False),   # 98 contracted components: X^T, Y^T in global scratch
    ("wide_fanout", 1000, 5, False),   # 18 components on 1 000 machines: the same
    ("diamond", 180, 33, True),        # ids outside [0, m)
])
def test_cuda_kernel_matches_plain_version_past_shared_memory(cuda_device, topology, m, B,
                                                              outside):
    args = _tensors(*_problem(5, topology, B, m, "per_row", outside=outside))
    plain = ops.cut_traffic(*args, 0.05)
    got = ops.cut_traffic(*(a.to(cuda_device) if isinstance(a, torch.Tensor) else a
                            for a in args), 0.05)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), plain)


@pytest.mark.cuda
@pytest.mark.parametrize("topology, m, B, regime", [
    ("linear", 37, 33, "per_row"),     # m odd, B = 4 k + 1 rows (4 rows a block)
    ("diamond", 181, 35, "skew"),      # m past a multiple of 64 machines, B = 4 k + 3
    ("star", 63, 2, "shared"),         # fewer rows than a block takes
    ("wide_fanout", 65, 1, "per_row"),  # one row
])
def test_cuda_kernel_matches_plain_version_at_block_edges(cuda_device, topology, m, B, regime):
    args = _tensors(*_problem(11, topology, B, m, regime, outside=True))
    plain = ops.cut_traffic(*args, 0.05)
    got = ops.cut_traffic(*(a.to(cuda_device) if isinstance(a, torch.Tensor) else a
                            for a in args), 0.05)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), plain)


def _wide_on_card(seed, topology, B, m, device, outside=False):
    """A small topology's rows on m machines (six racks), on the card: its
    operands, edges and distances."""
    tm, comp, uir, alpha, cir, edges, small = _problem(seed, topology, B, 6, "per_row")
    rng = np.random.default_rng(seed)
    tm = rng.integers(0, m, size=tm.shape)
    tm[:, 1] = m - 1  # the last w tile's machines
    if outside:
        tm[:, ::5] = rng.choice([-1, m, m + 2], size=tm[:, ::5].shape)
    g_args = [a.to(device) for a in _tensors(tm, comp, uir, alpha, cir, edges, small)[:5]]
    racks = torch.arange(m, device=device) % 6
    dist = torch.where(racks[:, None] == racks[None, :], 1.0, 2.0).to(torch.float64)
    dist.fill_diagonal_(0.0)
    return g_args, edges, dist


def _same_on_card(a, b):
    """Equal where not NaN, and NaN in the same places."""
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(torch.where(nan, 0.0, a), torch.where(nan, 0.0, b)))


def _held_on_card(g_args, edges, dist):
    """The kernel against the plain version on the card (its sums have no
    atomics, so it is exact there), one launch, rerun bit-identical."""
    from repro_torch.kernels.cut_traffic.ref import cut_traffic_ref

    before = ops.LAUNCHES["cut_traffic"]
    got = ops.cut_traffic(*g_args, edges, dist, 0.05)
    again = ops.cut_traffic(*g_args, edges, dist, 0.05)
    want = cut_traffic_ref(*g_args, edges, dist, 0.05)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["cut_traffic"] == before + 2
    assert _same_on_card(got, want) and torch.equal(got.view(torch.int64),
                                                    again.view(torch.int64))
    return got


def _k2(edges):
    return len({a for a, _ in edges}) + len({b for _, b in edges})


@pytest.mark.cuda
def test_cuda_kernel_at_the_largest_machine_count(cuda_device):
    """m = 1 600, the largest count of the one-block layouts at K2 = 6: X^T
    and Y^T in shared memory, Y^T apart, two-column distance tiles of all m
    machines (230 496 of 232 448 bytes)."""
    from repro_torch.kernels.cut_traffic.kernel import launch_plan

    m = 1_600
    g_args, edges, dist = _wide_on_card(13, "linear", 2, m, cuda_device)
    _held_on_card(g_args, edges, dist)
    plan = launch_plan(2, g_args[0].shape[1], edges, m)
    assert (plan["layout"], plan["tile_columns"], plan["smem_bytes"]) == (1, 2, 230_496)
    assert (plan["w_tile"], plan["scratch_bytes"]) == (m, 0) and ops.one_block(m, 6)


@pytest.mark.cuda
@pytest.mark.parametrize("topology, m, B, outside", [
    ("diamond", 14_501, 3, False),   # the list layout: groups of 32 rows
    ("linear", 16_380, 2, True),     # 20/70/90 x 91: ids outside [0, m)
    ("wide_fanout", 16_380, 1, False),  # 18 contracted rows: 8 two-slot lists
])
def test_cuda_kernel_past_the_one_block_tiles(cuda_device, topology, m, B, outside):
    """Past the one-block layouts the list layout takes m: step 3 over each
    group's listed columns, tiles of W_TILE machines (``distance_tiles``);
    each output still sums v in increasing order: equal to the plain
    version."""
    from repro_torch.kernels.cut_traffic.kernel import launch_plan

    g_args, edges, dist = _wide_on_card(17, topology, B, m, cuda_device, outside)
    _held_on_card(g_args, edges, dist)
    plan = launch_plan(B, g_args[0].shape[1], edges, m)
    assert plan["w_tile"] == ops.distance_tiles(m, _k2(edges))[0] == ops.W_TILE
    assert (plan["layout"], plan["rows"], plan["list_capacity"]) == (2, ops.GROUP_ROWS, m)


@pytest.mark.cuda
def test_cuda_kernel_one_machine_past_the_one_block_layouts(cuda_device):
    """One machine past the one-block layouts (1 601 at K2 = 6) the kernel
    takes its lists: equal to the plain version."""
    from repro_torch.kernels.cut_traffic.kernel import launch_plan

    m = 1_601
    g_args, edges, dist = _wide_on_card(2, "star", 2, m, cuda_device)
    _held_on_card(g_args, edges, dist)
    plan = launch_plan(2, g_args[0].shape[1], edges, m)
    assert (plan["layout"], plan["w_tile"]) == (2, ops.W_TILE) and not ops.one_block(m, 6)
    n_lists = len(ops.contracted_lists(edges, 5)[1])
    assert plan["scratch_bytes"] == ops.list_wave(2, 6, m, n_lists)[1]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["about 2 000 machines", "inf and NaN in unoccupied columns",
                                  "zero mass on an inf", "more rows than one wave"])
def test_cuda_list_layout_matches_plain_version(cuda_device, case):
    """The list layout where the one-block layouts end (2 000 machines at
    K2 = 6), with non-finite columns of ``distance`` that no task occupies
    (their 0 x inf is the plain version's NaN), with an inf on an occupied
    column whose mass sums to zero, and with more rows than one wave of its
    scratch (``ops.list_wave``): equal to the plain version, rerun
    bit-identical."""
    m = 2_000
    wave_rows = ops.list_wave(1 << 30, 6, m, 4)[0]
    B = {"more rows than one wave": wave_rows + 45}.get(case, 70)
    g_args, edges, dist = _wide_on_card(19, "linear", B, m, cuda_device, outside=True)
    tm, _, uir = g_args[:3]
    if case == "inf and NaN in unoccupied columns":
        tm[tm == 7] = 8
        tm[tm == 1_999] = 8
        dist[3, 7] = float("inf")
        dist[5, 1_999] = float("nan")
    elif case == "zero mass on an inf":  # two tasks of row 0 cancel on machine 7
        comp0 = g_args[1][0].cpu().numpy()
        c = next(c for c in range(4) if (comp0 == c).sum() > 1)
        t0, t1 = (int(t) for t in np.flatnonzero(comp0 == c)[:2])
        tm[0][tm[0] == 7] = 8
        tm[0, [t0, t1]] = 7
        uir[0, t1] = -uir[0, t0]
        dist[2, 7] = float("inf")
    got = _held_on_card(g_args, edges, dist)
    assert torch.isnan(got).any() == (case != "about 2 000 machines"
                                      and case != "more rows than one wave")
    assert not ops.one_block(m, 6) and (B > wave_rows) == (case == "more rows than one wave")
