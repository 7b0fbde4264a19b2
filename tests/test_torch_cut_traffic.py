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


def _kernel_twin(tm, comp, uir, alpha, cir, edges, dist, penalty, owners=32, chunk=64):
    """The CUDA kernel's arithmetic in its order, one scalar at a time:
    per task the sender output and receiver share; the masses of each row
    in chunks of ``chunk`` tasks, each owner adding its own machines'
    (w = g mod owners) tasks in increasing order; the distance contraction
    over v = 0, 1, ...; the edges in order; the penalty."""
    B, T = tm.shape
    m = dist.shape[0]
    send_slot, recv_slot, pairs = ops.edge_slots(edges, len(alpha))
    k2 = sum(s >= 0 for s in send_slot) + sum(s >= 0 for s in recv_slot)
    out = np.empty((B, m))
    for b in range(B):
        c_row = comp[b] if comp.ndim == 2 else comp
        u_row = uir[b] if uir.ndim == 2 else uir
        x = [[0.0] * m for _ in range(k2)]
        for t0 in range(0, T, chunk):
            for g in range(owners):
                for t in range(t0, min(t0 + chunk, T)):
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
        y = [[0.0] * m for _ in range(k2)]
        for s in range(k2):
            for w in range(m):
                acc = 0.0
                for v in range(m):
                    acc = acc + x[s][v] * float(dist[w, v])
                y[s][w] = acc
        for w in range(m):
            acc = 0.0
            for sa, rb in pairs:
                acc = acc + x[sa][w] * y[rb][w]
                acc = acc + x[rb][w] * y[sa][w]
            out[b, w] = acc * penalty
    return out


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


# Step 3's distance tiles span all m machines (padded to 64) up to
# MAX_MACHINES = 232 448 // 16 // 64 * 64 = 14 528, where two one-column
# tiles fill a block; past it, W_TILE = 9 x 64 = 576 machines at a time.
@pytest.mark.parametrize("m, tiles", [
    (1, (64, 1)), (180, (192, 1)), (14_500, (14_528, 1)), (14_528, (14_528, 1)),
    (14_529, (576, 26)), (16_380, (576, 29)), (17_280, (576, 30)),
])
def test_distance_tiles_by_hand(m, tiles):
    assert ops.MAX_MACHINES == 14_528 and ops.W_TILE == 576
    assert ops.distance_tiles(m) == tiles


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
    assert torch.equal(got, want) and torch.equal(got, again)


@pytest.mark.cuda
def test_cuda_kernel_at_the_largest_machine_count(cuda_device):
    """m = MAX_MACHINES: X^T and Y^T in the global scratch, one-column
    distance tiles of all m machines, two in flight, unpadded rows."""
    from repro_torch.kernels.cut_traffic.kernel import launch_plan

    m = ops.MAX_MACHINES
    g_args, edges, dist = _wide_on_card(13, "linear", 2, m, cuda_device)
    _held_on_card(g_args, edges, dist)
    plan = launch_plan(2, g_args[0].shape[1], 6, m)
    assert (plan["layout"], plan["tile_columns"], plan["tile_stages"]) == (2, 1, 2)
    assert plan["w_tile"] == m


@pytest.mark.cuda
@pytest.mark.parametrize("topology, m, B, outside", [
    ("diamond", 14_501, 3, False),   # past the old refusal: still the one-block tiles
    ("linear", 16_380, 2, True),     # 20/70/90 x 91: w tiles, ids outside [0, m)
    ("wide_fanout", 16_380, 1, False),  # 18 contracted rows: two rounds of warp tiles
])
def test_cuda_kernel_past_the_one_block_tiles(cuda_device, topology, m, B, outside):
    """Past the m whose distance tiles span all machines, the tiles split
    along w (layout 3, ``distance_tiles``); each output still sums v in
    increasing order: equal to the plain version."""
    from repro_torch.kernels.cut_traffic.kernel import launch_plan

    g_args, edges, dist = _wide_on_card(17, topology, B, m, cuda_device, outside)
    _held_on_card(g_args, edges, dist)
    k2 = len({a for a, _ in edges}) + len({b for _, b in edges})
    plan = launch_plan(B, g_args[0].shape[1], k2, m)
    assert plan["w_tile"] == ops.distance_tiles(m)[0]
    assert plan["layout"] == (3 if m > ops.MAX_MACHINES else 2)


@pytest.mark.cuda
def test_wrapper_rejects_more_machines_than_the_kernel_holds(cuda_device):
    """One machine past MAX_MACHINES the kernel takes its w tiles (there is
    no limit left to reject): equal to the plain version."""
    from repro_torch.kernels.cut_traffic.kernel import launch_plan

    m = ops.MAX_MACHINES + 1
    g_args, edges, dist = _wide_on_card(2, "star", 2, m, cuda_device)
    _held_on_card(g_args, edges, dist)
    plan = launch_plan(2, g_args[0].shape[1], 6, m)
    assert (plan["layout"], plan["w_tile"]) == (3, ops.W_TILE)
