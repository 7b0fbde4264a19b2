"""CPU-usage prediction (eq. 5) and rate propagation (eq. 6) — paper §5.2.

Port of ``repro.core.cost_model``. The per-placement bookkeeping (eq. 5/6,
``SkewModel``, per-row task maps) stays NumPy on the host, as in the
reference; the batched closed form runs on torch tensors on an explicit
device: ``closed_form_rates`` moves a sweep's operands to the device and
scores it with the ``kernels.sched_scoring`` wrapper (the hand-written
CUDA kernel on a card, its plain PyTorch version on the CPU), and
``network_unit_load`` builds the cut-traffic term there with the
``kernels.cut_traffic`` wrapper.

Conventions
-----------
* Rates are tuples/second. ``R0`` is the topology input rate injected at
  every spout.
* Shuffle grouping splits a component's incoming stream evenly over its
  instances (the paper's eq. 6 with uniform division), so all instances of a
  component share one input rate ``CIR_i / N_i``.
* Fields grouping (``UserGraph.groupings``) pins each key to one instance;
  a ``SkewModel`` carries the realized per-instance load fractions so the
  closed form can score imbalanced placements — per-instance IR becomes
  ``CIR_i * frac_{i,k}(N_i)`` instead of ``CIR_i / N_i``, still linear in
  the topology input rate, so R* keeps its closed form.
* With multiple downstream components, Storm *replicates* the output stream
  per subscribing component; within a component it is split evenly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.graph import ExecutionGraph, UserGraph
from repro_torch.core.profiles import Cluster
from repro_torch.kernels.cut_traffic.ref import NET_CHUNK_ELEMS

__all__ = [
    "component_rates",
    "instance_rates",
    "Prediction",
    "predict",
    "closed_form_rates",
    "max_stable_rate",
    "max_stable_rate_batch",
    "network_unit_load",
    "per_row_task_maps",
    "resource_operands",
    "SkewModel",
]

# Row-chunk cap of the network term's plain version (see
# ``kernels.cut_traffic.ref``); ``refine`` sizes its network-aware sweeps by it.
_NET_CHUNK_ELEMS = NET_CHUNK_ELEMS


def component_rates(utg: UserGraph, r0: float) -> np.ndarray:
    """Component-level input rates CIR (eq. 6 aggregated per component).

    Spouts receive ``r0`` each. For a non-spout component b:
    ``CIR_b = sum_{(a,b) in E} alpha_a * CIR_a``.
    """
    n = utg.n_components
    cir = np.zeros(n, dtype=np.float64)
    for s in utg.sources:
        cir[s] = r0
    for v in utg.topo_order():
        out = utg.alpha[v] * cir[v]
        for c in utg.children(v):
            cir[c] += out
    return cir


def instance_rates(
    etg: ExecutionGraph, r0: float, skew: "SkewModel | None" = None
) -> np.ndarray:
    """Per-task input rate IR_i (eq. 6): CIR of its component / N instances.

    With a ``skew`` model, keyed components use their realized per-instance
    fractions instead of the even split (shuffle components unchanged).
    """
    if skew is not None:
        if skew.utg is not etg.utg:
            raise ValueError("skew model was built for a different topology")
        return skew.per_task_unit_ir(etg.n_instances) * float(r0)
    cir = component_rates(etg.utg, r0)
    comp = etg.task_component()
    return cir[comp] / etg.n_instances[comp]


class SkewModel:
    """Realized fields-grouping load shape for closed-form scoring.

    Built from one key realization per fields edge (drawn at trace compile
    time — see ``runtime_stream.traces.KeyRealization``), the model answers
    one question: what fraction of component c's input does instance k of
    N handle? For a keyed component that is a mix of its in-edge streams —
    shuffle edges (and spout injection) split evenly, each fields edge
    routes by its key→hash→instance map:

        frac_{c,k}(N) = even_c / N + sum_e w_e * shares_e(N)[k]

    where ``w_e`` is edge e's share of the component's unit-rate CIR (a
    rate-independent constant, eq. 6 linearity) and ``even_c`` the
    remainder. Components without fields in-edges keep the exact eq. 6
    even-split floats (``instance_fractions`` returns None for them), so a
    skew-scored schedule only departs from the even-split score where keys
    actually route.

    The model also carries the operators' *keyed state*: each fields edge
    declares ``state_per_tuple`` (state tuples retained per unit of the
    edge's tuple rate — ``FieldsGrouping.state_per_tuple``), and instance k
    of a keyed component owns state proportional to the key share it
    handles:

        state_{c,k}(N) = sum_e state_per_tuple_e * alpha_p * CIR_p(1) * shares_e(N)[k]

    — the SkewModel fractions × a per-component state size. Shuffle
    components (and fields edges with ``state_per_tuple == 0``) carry no
    keyed state, so a shuffle-only topology's migrations stay free of
    state transfer (``per_task_state`` is all zeros) and drop-only replans
    remain free.
    """

    __slots__ = (
        "utg",
        "cir_unit",
        "_keyed",
        "_state_mix",
        "_frac_cache",
        "_unit_ir_cache",
        "_state_cache",
    )

    def __init__(
        self,
        utg: UserGraph,
        edge_shares: dict[tuple[int, int], Callable[[int], np.ndarray]],
    ):
        """Args:
          utg: the topology (supplies groupings and alpha/CIR structure).
          edge_shares: per fields edge, a callable mapping a downstream
            instance count n to the (n,) tuple-share vector (e.g. a
            ``KeyRealization.shares`` bound method). Must cover exactly
            the UTG's fields-grouped edges.
        """
        want = {g.edge for g in utg.groupings}
        if set(edge_shares) != want:
            raise ValueError(
                f"edge_shares must cover exactly the fields edges {sorted(want)}"
            )
        self.utg = utg
        self.cir_unit = component_rates(utg, 1.0)
        # Per keyed component: (even_weight, [(edge_weight, shares_fn), ...])
        # and the state mix [(state_size_e, shares_fn), ...] where
        # state_size_e = state_per_tuple_e * the edge's unit-rate tuple flow.
        self._keyed: dict[int, tuple[float, list]] = {}
        self._state_mix: dict[int, list] = {}
        for c in utg.keyed_components:
            cir_c = float(self.cir_unit[c])
            mix: list[tuple[float, Callable[[int], np.ndarray]]] = []
            smix: list[tuple[float, Callable[[int], np.ndarray]]] = []
            keyed_w = 0.0
            for g in utg.groupings:
                p, dst = g.edge
                if dst != c:
                    continue
                flow = float(utg.alpha[p] * self.cir_unit[p])
                w = flow / cir_c if cir_c > 0.0 else 0.0
                mix.append((w, edge_shares[g.edge]))
                keyed_w += w
                if g.state_per_tuple > 0.0:
                    smix.append((g.state_per_tuple * flow, edge_shares[g.edge]))
            self._keyed[c] = (max(1.0 - keyed_w, 0.0), mix)
            if smix:
                self._state_mix[c] = smix
        self._frac_cache: dict[tuple[int, int], np.ndarray] = {}
        self._unit_ir_cache: dict[tuple[int, ...], np.ndarray] = {}
        self._state_cache: dict[tuple[int, ...], np.ndarray] = {}

    @property
    def keyed_components(self) -> list[int]:
        return sorted(self._keyed)

    def instance_fractions(self, component: int, n: int) -> np.ndarray | None:
        """(n,) input fraction per instance of ``component`` at count ``n``,
        or None for shuffle components (use the exact eq. 6 even split)."""
        if component not in self._keyed:
            return None
        key = (component, int(n))
        frac = self._frac_cache.get(key)
        if frac is None:
            even_w, mix = self._keyed[component]
            frac = np.full(int(n), even_w / int(n), dtype=np.float64)
            for w_e, shares_fn in mix:
                frac = frac + w_e * shares_fn(int(n))
            self._frac_cache[key] = frac
        return frac

    def per_task_unit_ir(self, n_instances: np.ndarray) -> np.ndarray:
        """(T,) per-task input rate at unit topology rate for an (n,)
        instance-count vector (paper eq. 3 task order)."""
        key = tuple(int(k) for k in np.asarray(n_instances))
        out = self._unit_ir_cache.get(key)
        if out is None:
            parts = []
            for c, nk in enumerate(key):
                frac = self.instance_fractions(c, nk)
                if frac is None:
                    # Same division the even-split path performs, so shuffle
                    # components' floats agree exactly.
                    parts.append(np.full(nk, self.cir_unit[c] / nk))
                else:
                    parts.append(self.cir_unit[c] * frac)
            out = np.concatenate(parts) if parts else np.zeros(0)
            self._unit_ir_cache[key] = out
        return out

    def per_row_unit_ir(self, n_instances: np.ndarray) -> np.ndarray:
        """(B, T) per-task unit input rates for a (B, n) count matrix
        (every row must share one task total)."""
        n_instances = np.asarray(n_instances, dtype=np.int64)
        uniq, inverse = np.unique(n_instances, axis=0, return_inverse=True)
        rows = np.stack([self.per_task_unit_ir(u) for u in uniq])
        # reshape: np.unique's inverse shape for axis=0 varies across
        # NumPy 2.x minors (flat vs shaped); flat indexing works on all.
        return rows[inverse.reshape(-1)]

    # ------------------------------------------------------- keyed state

    @property
    def has_state(self) -> bool:
        """True when any fields edge declares ``state_per_tuple > 0`` —
        i.e. migrations can ship state and should be priced for it."""
        return bool(self._state_mix)

    def component_state(self) -> np.ndarray:
        """(n,) total keyed state per component (state tuples): the sum of
        every in-edge's ``state_per_tuple`` × unit-rate tuple flow.
        Invariant under the instance count — resharding moves state
        between instances, it never creates or destroys it."""
        out = np.zeros(self.utg.n_components, dtype=np.float64)
        for c, smix in self._state_mix.items():
            out[c] = sum(s for s, _ in smix)
        return out

    def instance_state(self, component: int, n: int) -> np.ndarray:
        """(n,) keyed state held by each instance of ``component`` at count
        ``n`` — the component's state split by realized key share (an
        instance owning the hot key holds proportionally more state).
        Zeros for stateless/shuffle components."""
        smix = self._state_mix.get(component)
        out = np.zeros(int(n), dtype=np.float64)
        if smix is None:
            return out
        for s_e, shares_fn in smix:
            out = out + s_e * shares_fn(int(n))
        return out

    def per_task_state(self, n_instances: np.ndarray) -> np.ndarray:
        """(T,) keyed state per task (paper eq. 3 task order) for an (n,)
        instance-count vector; zeros wherever no stateful fields edge
        lands."""
        key = tuple(int(k) for k in np.asarray(n_instances))
        out = self._state_cache.get(key)
        if out is None:
            parts = [self.instance_state(c, nk) for c, nk in enumerate(key)]
            out = np.concatenate(parts) if parts else np.zeros(0)
            self._state_cache[key] = out
        return out


@dataclasses.dataclass(frozen=True)
class Prediction:
    """Predicted state of an (ETG, cluster, rate) triple.

    Attributes:
      ir: (T,) per-task input rates.
      tcu: (T,) predicted per-task CPU utilization (eq. 5).
      machine_util: (m,) predicted utilization per machine.
      mac: (m,) remaining capacity (paper's MAC).
      throughput: predicted overall throughput = sum of task processing
        rates, assuming no machine is over-utilized (the paper's objective,
        eq. 2, under the MAC >= 0 constraint).
    """

    ir: np.ndarray
    tcu: np.ndarray
    machine_util: np.ndarray
    mac: np.ndarray
    throughput: float

    @property
    def over_utilized(self) -> np.ndarray:
        """(m,) bool — machines whose predicted utilization exceeds capacity."""
        return self.mac < 0.0

    @property
    def feasible(self) -> bool:
        return bool(np.all(self.mac >= 0.0))


def predict(etg: ExecutionGraph, cluster: Cluster, r0: float) -> Prediction:
    """eq. 5 over every task of the ETG at topology input rate ``r0``."""
    comp = etg.task_component()            # (T,)
    machine = etg.task_machine()           # (T,)
    task_types = etg.utg.component_types[comp]
    ir = instance_rates(etg, r0)           # (T,)

    mtypes = cluster.machine_types[machine]
    e = cluster.profile.e[task_types, mtypes]
    met = cluster.profile.met[task_types, mtypes]
    tcu = e * ir + met                     # eq. 5

    util = np.zeros(cluster.n_machines, dtype=np.float64)
    np.add.at(util, machine, tcu)
    mac = cluster.capacity - util
    return Prediction(
        ir=ir,
        tcu=tcu,
        machine_util=util,
        mac=mac,
        throughput=float(ir.sum()),
    )

def max_stable_rate(
    etg: ExecutionGraph, cluster: Cluster, skew: SkewModel | None = None
) -> tuple[float, float]:
    """Largest topology input rate with every MAC_w >= 0, and its throughput.

    Because eq. 5/6 are linear in the topology input rate R, the per-machine
    utilization is ``met_w + R * var_w`` with rate-independent coefficients,
    so the binding constraint solves in closed form:

        R* = min_w (capacity_w - met_w) / var_w     (over machines, var_w > 0)

    Returns (R*, throughput at R*) where throughput is the paper's objective
    (eq. 2): the sum of all task processing rates. A placement whose fixed
    MET overhead alone exceeds some machine's capacity is infeasible at any
    rate -> (0.0, 0.0). A ``skew`` model replaces keyed components' even
    split with their realized per-instance fractions.

    One placement is host-side work: it is scored on the CPU (the plain
    PyTorch path, bit-identical to the kernel and to the reference).
    """
    rate, thpt = max_stable_rate_batch(
        etg, cluster, etg.task_machine()[None, :], skew=skew, device="cpu"
    )
    return float(rate[0]), float(thpt[0])


def per_row_task_maps(
    cir_unit: np.ndarray, n_instances: np.ndarray, n_tasks: int
) -> tuple[np.ndarray, np.ndarray]:
    """Per-row (component, unit-IR) task maps for a (B, n) count matrix.

    Supports candidate batches whose rows carry *different* instance-count
    vectors (e.g. lockstep growth chains growing different components), as
    long as every row has the same task total ``n_tasks``.

    Per row b, task j belongs to the component whose cumulative count block
    contains j (paper eq. 3 order), and its unit input rate is
    ``cir_unit[c] / n_instances[b, c]`` — the same per-component division
    then gather the shared-count path performs, so per-row scores are
    bit-identical to scoring each row against its own template.

    Returns:
      (comp, unit_ir), each (B, n_tasks).
    """
    n_instances = np.asarray(n_instances, dtype=np.int64)
    if n_instances.ndim != 2:
        raise ValueError("per-row n_instances must be (B, n)")
    if np.any(n_instances < 1):
        raise ValueError("every component needs >= 1 instance (paper constraint)")
    if np.any(n_instances.sum(axis=1) != n_tasks):
        raise ValueError(
            "per-row n_instances must all sum to task_machine's task count"
        )
    # Candidate sweeps repeat count vectors in runs (a lockstep chain
    # contributes one vector for all m of its consecutive rows), so map one
    # representative per run and fan the results back out.
    B = n_instances.shape[0]
    if B > 1:
        starts = np.empty(B, dtype=bool)
        starts[0] = True
        np.any(n_instances[1:] != n_instances[:-1], axis=1, out=starts[1:])
        reps = n_instances[starts]                     # (U, n)
        inverse = np.cumsum(starts) - 1                # (B,)
    else:
        reps, inverse = n_instances, np.zeros(B, dtype=np.int64)
    ends = np.cumsum(reps, axis=1)                     # (U, n)
    comp_u = (np.arange(n_tasks)[None, :] >= ends[:, :, None]).sum(axis=1)
    per_unit = cir_unit[None, :] / reps                # (U, n)
    unit_ir_u = np.take_along_axis(per_unit, comp_u, axis=1)
    return comp_u[inverse], unit_ir_u[inverse]


def network_unit_load(
    task_machine: np.ndarray,
    comp: np.ndarray,
    unit_ir: np.ndarray,
    alpha: np.ndarray,
    cir_unit: np.ndarray,
    edges: tuple,
    distance: np.ndarray,
    net_penalty: float = 1.0,
    chunk_elems: int = _NET_CHUNK_ELEMS,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """(B, m) per-machine cut-traffic CPU load at unit topology rate, on ``device``.

    The Eidenbenz & Locher cut-traffic term, folded into the closed form's
    variable coefficient: for every UTG edge (a, b), the unit-rate flow
    from instance i of a to instance j of b is ``out_i * rfrac_j`` where
    ``out_i = alpha_a * unit_ir_i`` is sender i's unit-rate output and
    ``rfrac_j = unit_ir_j / cir_unit_b`` receiver j's share of b's input.
    Each endpoint machine pays ``net_penalty * flow * distance[w_i, w_j]``
    per unit rate. The rank-1 structure collapses the per-edge double sum
    to per-(component, machine) masses plus distance contractions; row
    chunks are capped at ``chunk_elems`` (B_chunk·n·m) elements, like the
    reference's.

    The masses accumulate one task column at a time, so every cell adds its
    tasks in row order (the reference's ``np.add.at`` order, bit for bit);
    the distance contraction sums in machine order (``kernels.cut_traffic``)
    where the reference uses a BLAS product, so results agree with it to
    rounding (~1e-16 relative) and are identical across devices.

    ``comp`` / ``unit_ir`` are (T,) shared or (B, T) per-row task maps —
    the operands ``closed_form_rates`` receives. Each operand is an array
    or a tensor; a tensor already on ``device`` is not copied again.
    """
    from repro_torch import resolve_device
    from repro_torch.kernels.cut_traffic.ops import cut_traffic

    dev = resolve_device(device)

    # On a card one sweep is one launch of the cut-traffic kernel; on the
    # CPU its plain version runs: the eager scatters and contractions, in
    # row chunks.
    f64 = np.float64
    return cut_traffic(
        _to_device(task_machine, np.int32, dev), _to_device(comp, np.int32, dev),
        _to_device(unit_ir, f64, dev), _to_device(alpha, f64, dev),
        _to_device(cir_unit, f64, dev), edges, _to_device(distance, f64, dev),
        net_penalty, chunk_elems,
    )


def _scoring_operands(
    cluster: Cluster,
    task_machine,
    comp,
    unit_ir: np.ndarray,
    alpha: np.ndarray,
    cir_unit: np.ndarray,
    edges: tuple,
    component_types: np.ndarray,
    device: str | torch.device = "cuda",
) -> tuple:
    """(task_machine, comp, net_var, mem_c, mem_capacity) for ``closed_form_rates``.

    The resource extras are all ``None`` on a scalar-CPU cluster, so
    default-parameter scoring takes the scalar kernel. ``net_var`` is a
    (B, m) tensor on ``device``; ``mem_c`` is the (n,) per-instance memory
    demand of each component, which the kernel gathers per task. With a
    network term, ``task_machine`` and ``comp`` come back as int32 tensors on
    ``device``, so a sweep copies them there once for both kernels.
    """
    from repro_torch import resolve_device

    net_var = mem_c = mem_capacity = None
    if cluster.has_network:
        dev = resolve_device(device)
        task_machine = _to_device(task_machine, np.int32, dev)
        comp = _to_device(comp, np.int32, dev)
        net_var = network_unit_load(
            task_machine, comp, unit_ir, alpha, cir_unit, edges,
            cluster.distance, cluster.net_penalty, device=dev,
        )
    if cluster.has_memory:
        mem_c = cluster.profile.mem[component_types]
        mem_capacity = cluster.mem_capacity
    return task_machine, comp, net_var, mem_c, mem_capacity


def resource_operands(
    cluster: Cluster,
    task_machine: np.ndarray,
    comp: np.ndarray,
    unit_ir: np.ndarray,
    alpha: np.ndarray,
    cir_unit: np.ndarray,
    edges: tuple,
    component_types: np.ndarray,
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor | None, np.ndarray | None, np.ndarray | None]:
    """(net_var, mem, mem_capacity) extras for ``closed_form_rates``.

    All three are ``None`` on a scalar-CPU cluster, so default-parameter
    scoring takes the scalar kernel. ``net_var`` is a (B, m) tensor on
    ``device``; ``mem`` is the per-task memory demand in ``comp``'s shape
    ((T,) or (B, T)), as the reference returns it.
    """
    _, _, net_var, mem_c, mem_capacity = _scoring_operands(
        cluster, task_machine, comp, unit_ir, alpha, cir_unit, edges, component_types,
        device=device,
    )
    mem = None if mem_c is None else mem_c[np.asarray(comp)]
    return net_var, mem, mem_capacity


def max_stable_rate_batch(
    etg: ExecutionGraph,
    cluster: Cluster,
    task_machine: np.ndarray,
    n_instances: np.ndarray | None = None,
    skew: SkewModel | None = None,
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized ``max_stable_rate`` over B placements, scored on ``device``.

    Args:
      task_machine: (B, T) machine index per task per candidate placement.
      n_instances: optional (B, n) per-row instance-count matrix overriding
        ``etg.n_instances`` row by row (every row must sum to T). Lets one
        sweep score candidates that grow/shrink *different* components.
      skew: optional fields-grouping load model; keyed components score at
        their realized per-instance fractions instead of the even split.
      device: ``"cuda"`` (default: the hand-written kernel; raises without
        a card) or ``"cpu"`` (the plain PyTorch version). Both give the
        reference's NumPy floats bit for bit.

    Returns:
      (rates, throughputs), each (B,) NumPy float64.
    """
    from repro_torch.core.simulator import resolve_closed_form_device

    utg = etg.utg
    task_machine = np.asarray(task_machine, dtype=np.int64)
    if task_machine.ndim != 2:
        raise ValueError("task_machine must be (B, T)")
    if skew is not None and skew.utg is not utg:
        raise ValueError("skew model was built for a different topology")
    regime = (
        "skew" if skew is not None
        else "per_row" if n_instances is not None
        else "shared"
    )
    dev = resolve_closed_form_device(
        device, task_machine.size, regime=regime,
        n_machines=cluster.n_machines, site="max_stable_rate_batch",
    )
    cir_unit = skew.cir_unit if skew is not None else component_rates(utg, 1.0)
    if n_instances is not None:
        n_inst_bn = np.asarray(n_instances, dtype=np.int64)
        comp, unit_ir = per_row_task_maps(cir_unit, n_inst_bn, task_machine.shape[1])
        if skew is not None:
            unit_ir = skew.per_row_unit_ir(n_inst_bn)
    else:
        comp = etg.task_component()
        if task_machine.shape[1] != comp.shape[0]:
            raise ValueError("task_machine must be (B, T)")
        unit_ir = (
            skew.per_task_unit_ir(etg.n_instances)
            if skew is not None
            else instance_rates(etg, 1.0)
        )
    ttypes = utg.component_types
    e_cm = cluster.profile.e[ttypes][:, cluster.machine_types]
    met_cm = cluster.profile.met[ttypes][:, cluster.machine_types]
    net_var = mem_c = mem_cap = None
    if cluster.has_resources:
        task_machine, comp, net_var, mem_c, mem_cap = _scoring_operands(
            cluster, task_machine, comp, unit_ir, utg.alpha, cir_unit,
            utg.edges, ttypes, device=dev,
        )
    return closed_form_rates(
        task_machine, comp, unit_ir, e_cm, met_cm, cluster.capacity,
        net_var=net_var, mem_c=mem_c, mem_capacity=mem_cap, device=dev,
    )


_TORCH_DTYPES = {np.int32: torch.int32, np.float64: torch.float64}


def _to_device(x, dtype, dev: torch.device):
    """``x`` (an array or a tensor) as a contiguous ``dtype`` tensor on
    ``dev``; ``None`` stays ``None``."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=_TORCH_DTYPES[dtype]).contiguous()
    return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).to(dev)


def closed_form_rates(
    task_machine: np.ndarray,
    comp: np.ndarray,
    unit_ir: np.ndarray,
    e_cm,
    met_cm,
    capacity,
    net_var=None,
    mem_c=None,
    mem_capacity=None,
    device: str | torch.device = "cuda",
    unit_sum=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Closed-form (rates, throughputs) of B candidate rows, scored on ``device``.

    The port's single scoring entry: it moves one sweep's operands to the
    device — the (B, T) task->machine ids as int32, the (T,) or (B, T)
    ``comp`` / ``unit_ir`` maps and the small (n, m) profile tables
    ``e_cm`` / ``met_cm`` (tables may already be tensors on the device) —
    and calls ``kernels.sched_scoring.ops.sched_scoring``, which gathers
    the profiles per task and accumulates per machine in task order.
    Rates are the reference ``closed_form_rates``' bit for bit:
    ``R* = min_w (cap_w - met_w) / (var_w + net_w)``, 0 on a row with some
    machine over its fixed load or (with ``mem_c``) over its memory.

    ``capacity`` / ``mem_capacity`` are (m,) shared or (B, m) per row
    (multi-tenant residuals). Throughput is ``rates * unit_ir.sum()`` in
    NumPy's pairwise order on the host, as the reference sums it; a caller
    whose ``unit_ir`` is already a tensor on the device passes those sums
    as ``unit_sum`` ((B,) or a scalar), so nothing is read back.
    """
    from repro_torch import resolve_device
    from repro_torch.kernels.sched_scoring.ops import sched_scoring

    dev = resolve_device(device)
    if unit_sum is None:
        unit_ir = np.asarray(unit_ir, dtype=np.float64)
        unit_sum = unit_ir.sum(axis=1) if unit_ir.ndim == 2 else unit_ir.sum()

    f64 = np.float64
    rates = sched_scoring(
        _to_device(task_machine, np.int32, dev),
        _to_device(comp, np.int32, dev),
        _to_device(unit_ir, f64, dev),
        _to_device(e_cm, f64, dev),
        _to_device(met_cm, f64, dev),
        _to_device(capacity, f64, dev),
        net_var=_to_device(net_var, f64, dev),
        mem_c=_to_device(mem_c, f64, dev),
        mem_capacity=_to_device(mem_capacity, f64, dev),
    ).cpu().numpy()
    return rates, rates * unit_sum
