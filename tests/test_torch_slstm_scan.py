"""The sLSTM recurrence's plain version, its dispatcher and its wrapper on
the CPU, against the JAX package.

At ``xlstm-125m``'s reduced config (d_model 64), B = 2, float32:
``ref.slstm_scan_ref`` against the ``lax.scan`` of
``repro.models.xlstm.slstm_block``, which the test isolates by giving the
block an identity ``w_out`` (so its output is the scan's h, exactly) and
handing the port the gate pre-activations the reference's own ``dense``
computed. S = 12 and 512, from a zero state and from the state a 12-token
prompt left: every output and state within atol = rtol = 1e-5 (the
tolerance of ``tests/test_torch_xlstm.py``). The dispatcher
(``models.xlstm._slstm_scan``) on CPU tensors is ``ref.py`` bit for bit and
launches nothing; the training route goes through the autograd Function
(its gradients: ``tests/test_torch_slstm_scan_grad.py``); the wrapper
refuses wrong shapes, types and devices by name. The layout plan (``ops.plan``) is checked against the H100's
attributes: which layout, cluster size C and rows R each shape gets, and
that every column split covers each column once. The kernel itself runs
only on the card: ``tests/test_torch_slstm_scan_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as jax_layers
from repro.models import xlstm as jax_xlstm
from repro.models.layers import MeshCtx
from repro_torch.configs import get_config
from repro_torch.kernels.slstm_scan import ops as slstm_ops
from repro_torch.kernels.slstm_scan.ref import slstm_scan_ref
from repro_torch.models import xlstm

TOL = dict(atol=1e-5, rtol=1e-5)
CTX = MeshCtx(mesh=None)
B = 2
NO_LAUNCH = {"slstm_scan": 0, "slstm_scan_bwd": 0, "slstm_scan_bwd_rest": 0}


@pytest.fixture(scope="module")
def block():
    """The reference's sLSTM parameters (reduced config), random biases,
    and an identity output projection."""
    jcfg = jax_get_config("xlstm-125m").reduced()
    p = jax.tree.map(np.asarray, jax_xlstm.init_slstm_block(jax.random.PRNGKey(3), jcfg,
                                                            jnp.float32))
    rng = np.random.default_rng(3)
    for name in ("w_z", "w_i", "w_f", "w_o"):
        p[name]["b"] = rng.standard_normal(p[name]["b"].shape).astype(np.float32)
    p["w_out"] = {"w": np.eye(jcfg.d_model, dtype=np.float32)}
    return jcfg, p


def _x(seed, S, d):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(np.float32)


def _jax_scan(jcfg, p, x, state):
    """The reference's gate pre-activations, and its scan's (hs, state)."""
    jp = jax.tree.map(jnp.asarray, p)
    gates = [np.asarray(jax_layers.dense(jp[w], jnp.asarray(x)), np.float32)
             for w in ("w_z", "w_i", "w_f", "w_o")]
    hs, st = jax_xlstm.slstm_block(jp, jnp.asarray(x), CTX, jcfg, state=state)
    return gates, np.asarray(hs), st


def _state(jcfg, p, start):
    if start == "zero":
        return jax_xlstm.init_slstm_state(B, jcfg, jnp.float32)
    _, _, st = _jax_scan(jcfg, p, _x(7, 12, jcfg.d_model), jax_xlstm.init_slstm_state(
        B, jcfg, jnp.float32))
    return st


def _args(gates, rw, st):
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))  # noqa: E731
    return (*(t(g) for g in gates), t(rw), *(t(getattr(st, k)) for k in ("c", "n", "h", "m")))


@pytest.mark.parametrize("S", [12, 512])
@pytest.mark.parametrize("start", ["zero", "carried"])
def test_plain_version_matches_the_references_scan(block, start, S):
    jcfg, p = block
    st = _state(jcfg, p, start)
    gates, want_hs, want = _jax_scan(jcfg, p, _x(S, S, jcfg.d_model), st)
    hs, c, n, h, m = slstm_scan_ref(*_args(gates, p["r_z"]["w"], st))
    assert hs.shape == (B, S, jcfg.d_model)
    np.testing.assert_allclose(hs.numpy(), want_hs, **TOL)
    for got, name in ((c, "c"), (n, "n"), (h, "h"), (m, "m")):
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(want, name)), **TOL)


@pytest.mark.parametrize("S", [1, 12])
def test_dispatcher_on_the_cpu_is_the_plain_version(block, S):
    jcfg, p = block
    st = _state(jcfg, p, "carried")
    gates, _, _ = _jax_scan(jcfg, p, _x(20 + S, S, jcfg.d_model), st)
    args = _args(gates, p["r_z"]["w"], st)
    slstm_ops.reset_launches()
    hs, state = xlstm._slstm_scan(*args[:5], xlstm.SLSTMState(*args[5:]))
    want = slstm_scan_ref(*args)
    for got, exp in zip((hs, state.c, state.n, state.h, state.m), want):
        assert torch.equal(got, exp)
    assert slstm_ops.LAUNCHES == NO_LAUNCH


def test_training_route_is_the_plain_loop_and_differentiable(block, monkeypatch):
    """``slstm_block(train=True)`` goes through ``_SLSTMScan`` (its node in
    the autograd graph); its output equals the serving route's, and its
    gradients (``r_z``, a gate's weight, x) equal autograd through the plain
    loop within 1e-5."""
    _, p = block
    cfg = get_config("xlstm-125m").reduced()
    tp = {k: {kk: torch.from_numpy(np.array(v)) for kk, v in d.items()} for k, d in p.items()}
    wrt = [tp["r_z"]["w"].requires_grad_(True), tp["w_f"]["w"].requires_grad_(True),
           torch.from_numpy(_x(5, 12, cfg.d_model)).requires_grad_(True)]
    y_train, _ = xlstm.slstm_block(tp, wrt[2], cfg, train=True)
    with torch.no_grad():
        y_serve, _ = xlstm.slstm_block(tp, wrt[2], cfg)
    assert torch.equal(y_train.detach(), y_serve)
    nodes, seen = [y_train.grad_fn], set()
    while nodes:
        node = nodes.pop()
        if node is not None and node not in seen:
            seen.add(node)
            nodes.extend(f for f, _ in node.next_functions)
    assert "_SLSTMScanBackward" in {type(node).__name__ for node in seen}
    grads = torch.autograd.grad(y_train.square().sum(), wrt)
    monkeypatch.setattr(slstm_ops, "slstm_scan", lambda *a, layout=None: slstm_scan_ref(*a))
    y_plain, _ = xlstm.slstm_block(tp, wrt[2], cfg, train=True)
    want = torch.autograd.grad(y_plain.square().sum(), wrt)
    for got, exp in zip(grads, want):
        assert bool(exp.abs().sum() > 0)
        np.testing.assert_allclose(got.numpy(), exp.numpy(), **TOL)
    assert slstm_ops.LAUNCHES == NO_LAUNCH


def test_meta_tensors_make_shapes_only():
    B_, S, d = 3, 5, 16
    meta = lambda *shape: torch.empty(*shape, device="meta")  # noqa: E731
    out = slstm_ops.slstm_scan(*(meta(B_, S, d) for _ in range(4)), meta(d, d),
                               *(meta(B_, d) for _ in range(4)))
    assert [tuple(t.shape) for t in out] == [(B_, S, d)] + [(B_, d)] * 4
    assert all(t.device.type == "meta" for t in out)


def _good(B_=2, S=3, d=8):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(B_, S, d, generator=g) for _ in range(4)] + [
        torch.randn(d, d, generator=g)] + [torch.randn(B_, d, generator=g) for _ in range(4)]


def _with(i, t):
    args = _good()
    args[i] = t
    return args


_REFUSALS = {
    "zx not (B, S, d)": (lambda: _with(0, torch.zeros(2, 8)), ValueError, "zx must be"),
    "ix shape": (lambda: _with(1, torch.zeros(2, 4, 8)), ValueError, "ix must be"),
    "rw shape": (lambda: _with(4, torch.zeros(8, 7)), ValueError, "rw must be"),
    "m shape": (lambda: _with(8, torch.zeros(3, 8)), ValueError, "m must be"),
    "bfloat16 fx": (lambda: _with(2, torch.zeros(2, 3, 8, dtype=torch.bfloat16)), TypeError,
                    "fx is torch.bfloat16"),
    "float64 c": (lambda: _with(5, torch.zeros(2, 8, dtype=torch.float64)), TypeError,
                  "c is torch.float64"),
    "h on another device": (lambda: _with(7, torch.zeros(2, 8, device="meta")), ValueError,
                            "h lies on meta"),
    "ox not contiguous": (lambda: _with(3, torch.zeros(2, 8, 3).transpose(1, 2)), ValueError,
                          "ox must be contiguous"),
}


@pytest.mark.parametrize("case", list(_REFUSALS))
def test_wrapper_refuses_by_name(case):
    make, exc, match = _REFUSALS[case]
    slstm_ops.reset_launches()
    with pytest.raises(exc, match=match):
        slstm_ops.slstm_scan(*make())
    assert slstm_ops.LAUNCHES == NO_LAUNCH


def test_wrapper_takes_cpu_tensors_without_a_launch():
    slstm_ops.reset_launches()
    args = _good()
    got = slstm_ops.slstm_scan(*args)
    for g, w in zip(got, slstm_scan_ref(*args)):
        assert torch.equal(g, w)
    assert slstm_ops.LAUNCHES == NO_LAUNCH


# The H100 80GB HBM3's attributes as ``kernel.device_attributes`` reads them
# (chip_smoke.py phase 16a' prints them): 232 448 opt-in shared bytes a
# block, and the clusters of C = 1 .. 16 blocks of the cluster kernel it holds
# at once; only 7 of 16 blocks (its GPCs), not 8.
H100 = slstm_ops.Device(
    smem_optin=232448, active_clusters=(132, 66, 39, 30, 22, 17, 15, 15, 9, 7, 7, 7, 7, 7, 7, 7))
# The same card were it to hold 8 clusters of 16.
EIGHT_16 = slstm_ops.Device(smem_optin=232448, active_clusters=H100.active_clusters[:15] + (8,))


@pytest.mark.parametrize("dev,R,clusters", [(H100, 2, 4), (EIGHT_16, 1, 8)])
def test_plan_of_the_xlstm_prefill(dev, R, clusters):
    """xlstm-125m's prefill (8, 512, 768): the cluster layout, 16 blocks of
    48 columns; two rows a cluster on the H100's 7 resident clusters of 16,
    one where 8 fit."""
    p = slstm_ops.plan(8, 512, 768, dev)
    assert p["layout"] == "cluster" and p["C"] == 16 and p["width"] == 48
    assert (p["R"], p["clusters"], p["waves"]) == (R, clusters, 1)
    assert p["active_clusters"] == dev.active_clusters[15]
    assert p["smem_bytes"] == slstm_ops.cluster_smem(R) <= dev.smem_optin


@pytest.mark.parametrize("dev,B,R,last", [(H100, 8, 2, 2), (EIGHT_16, 8, 1, 1), (H100, 9, 2, 1),
                                           (H100, 1, 1, 1), (H100, 3, 1, 1)])
def test_plan_of_the_backward_row_phases(dev, B, R, last):
    """The backward's exchange at xlstm-125m's prefill shapes (and B = 1, 3
    and 9 rows): one phase a row of a cluster, each expecting one row of
    dz_pre from the cluster's blocks (4 d bytes); a pair of mbarriers and
    buffers a row; the last cluster's rows what is left of B."""
    p = slstm_ops.plan(B, 512, 768, dev)
    assert p["layout"] == "cluster" and (p["R"], p["last_rows"]) == (R, last)
    assert p["phase_bytes"] == 4 * 768 == sum(4 * width for _, width in p["columns"])
    assert p["bwd_smem_bytes"] == slstm_ops.cluster_bwd_smem(R) == R * (16 + 2 * 4 * 768)
    assert p["bwd_smem_bytes"] <= dev.smem_optin
    assert (p["clusters"] - 1) * R + p["last_rows"] == B


@pytest.mark.parametrize("d", [768, 64])
def test_plan_of_rows_past_the_resident_clusters(d):
    """130 rows: more than one a cluster, at most ``MAX_ROWS``, the waves of
    resident clusters evenly filled, every row in one cluster."""
    p = slstm_ops.plan(130, 3, d, H100)
    C = slstm_ops.cluster_size(d)
    active = H100.active_clusters[C - 1]
    assert p["layout"] == "cluster" and p["C"] == C
    assert 1 < p["R"] <= slstm_ops.MAX_ROWS
    assert p["clusters"] == -(-130 // p["R"]) and (p["clusters"] - 1) * p["R"] < 130
    assert p["waves"] == -(-p["clusters"] // active)


@pytest.mark.parametrize("d", [769, 4100])
def test_plan_past_the_cluster_layout_is_the_cooperative_layout(d):
    assert slstm_ops.cluster_size(d) is None
    assert slstm_ops.plan(2, 3, d, H100) == {"layout": "cooperative"}


@pytest.mark.parametrize("d", [1, 4, 47, 48, 49, 100, 200, 700, 765, 767, 768])
def test_column_split_covers_every_column_once(d):
    """Ragged slices (d = 1, d not a multiple of C, d one past a block):
    each column in exactly one block, every slice 16-byte aligned and at
    most ``MAX_WIDTH`` wide, no block empty."""
    C = slstm_ops.cluster_size(d)
    split = slstm_ops.column_split(d, C)
    assert len(split) == C and C == -(-d // slstm_ops.MAX_WIDTH)
    covered = [j for start, width in split for j in range(start, start + width)]
    assert covered == list(range(d))
    assert all(start % 4 == 0 and 0 < width <= slstm_ops.MAX_WIDTH for start, width in split)
    assert slstm_ops.plan(2, 5, d, H100)["columns"] == split


@pytest.mark.parametrize("S", [1, 2, 3, 512])
def test_plan_by_steps(S):
    """A decode step (S = 1) and calls of fewer than ``CLUSTER_MIN_STEPS``
    steps take the cooperative layout; longer calls the cluster layout."""
    want = "cluster" if S >= slstm_ops.CLUSTER_MIN_STEPS else "cooperative"
    assert slstm_ops.plan(8, S, 768, H100)["layout"] == want
    # Forced, either layout takes the step.
    for layout in slstm_ops.LAYOUTS:
        assert slstm_ops.plan(8, S, 768, H100, layout)["layout"] == layout


_PLAN_REFUSALS = {
    "cluster past 768 features": (dict(d=769, dev=H100, layout="cluster"),
                                  "cluster layout cannot take d = 769"),
    "cluster on a device with no cluster of 16": (
        dict(d=768, dev=slstm_ops.Device(232448, H100.active_clusters[:15] + (0,)),
             layout="cluster"), "holds no cluster of 16 blocks"),
    "an unknown layout": (dict(d=768, dev=H100, layout="grid"), "unknown slstm_scan layout"),
}


@pytest.mark.parametrize("case", list(_PLAN_REFUSALS))
def test_plan_refuses_a_forced_layout_by_name(case):
    kw, match = _PLAN_REFUSALS[case]
    with pytest.raises(ValueError, match=match):
        slstm_ops.plan(2, 3, kw["d"], kw["dev"], kw["layout"])


@pytest.mark.parametrize("layout,d,match", [("cluster", 769, "cluster layout cannot take d = 769"),
                                            ("grid", 8, "unknown slstm_scan layout")])
def test_wrapper_refuses_a_forced_layout_by_name(layout, d, match):
    """On every device, before any dispatch: here on CPU tensors."""
    slstm_ops.reset_launches()
    with pytest.raises(ValueError, match=match):
        slstm_ops.slstm_scan(*_good(d=d), layout=layout)
    assert slstm_ops.LAUNCHES == NO_LAUNCH


@pytest.mark.parametrize("layout", list(slstm_ops.LAYOUTS))
def test_wrapper_takes_a_forced_layout_on_the_cpu_as_the_plain_version(layout):
    args = _good()
    for got, want in zip(slstm_ops.slstm_scan(*args, layout=layout), slstm_scan_ref(*args)):
        assert torch.equal(got, want)
