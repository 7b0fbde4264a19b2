"""Tenant-batched closed-form scoring: tenants become rows.

The single-tenant engines score B candidate placements of *one* topology
per kernel call. Multi-tenant search wants to score candidates belonging
to *different* tenants — each against its own residual capacity — in one
call, reusing the scorer's per-row task maps and per-row capacity (B1, or
B2 with a memory or network term, on the card).

Two ingredients make different tenants batch into one call:

* a **met fold** — tenant s's committed load is linear in its allocated
  rate R_s, so each of its tasks contributes the fixed quantity
  ``met_cm[c, w] + e_cm[c, w] * unit_ir_task * R_s`` to its machine
  (skew-aware: the per-task unit IR comes from
  ``SkewModel.per_task_unit_ir`` when the tenant has a key-share model).
  Folding those per-task loads onto their incumbent machines (one
  canonical-order ``bincount``) prices the whole fleet as one fixed
  (m,) frozen-load vector F, and tenant t's residual capacity is
  ``cluster.capacity - (F - F_t_own)``.

* **per-row capacity** — ``closed_form_rates`` accepts a (B, m) capacity
  matrix, so each candidate row scores against *its* tenant's residual.
  Rows stay compact: width is the largest tenant task count (co-tenants
  live in the capacity row, not in frozen columns), padded with a zero
  profile row for shorter tenants.

Every per-tenant table — the (N, m) residual capacities (and memory), the
(N, t_max) component and unit-rate rows — lies on the device from
construction, and a sweep gathers each row's copy by a row-to-tenant index
there: only the candidate task->machine rows and that index cross from the
host. The gathered values are the reference's host fill, bit for bit. On a
network-modelled cluster each non-empty tenant sweep prices its own cut
traffic (one cut_traffic launch on a card) and the (b_t, m) terms are
concatenated on the device.

Floats differ from the explicit residual-capacity subtraction only in
summation association (~1e-15 relative); ``tests/test_torch_multitenant.py``
holds the scores to the reference's at 1e-12 with identical argmax.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import cost_model
from repro_torch.core.schedule_state import ScheduleState

from repro_torch.multitenant.state import MultiTenantState

__all__ = ["TenantBatchScorer"]


def _tensor(x: np.ndarray, dtype, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).to(dev)


class TenantBatchScorer:
    """Score count-preserving candidate rows for many tenants in one call.

    Snapshots the multi-tenant state's committed rates at construction
    (the met fold bakes them into the frozen-load vector) — rebuild the
    scorer after rates or placements change. Candidate rows must keep
    each tenant's instance counts (RELOCATE/SWAP-style sweeps); growth
    moves go through the per-tenant refine path on residual clusters.

    ``device`` is where sweeps are scored: ``"cuda"`` (default: the
    hand-written scorer; raises without a card) or ``"cpu"`` (its plain
    PyTorch version). Both give the same floats.
    """

    def __init__(self, mt: MultiTenantState, device: str | torch.device = "cuda"):
        self.mt = mt
        self.device = resolve_device(device)
        self.candidates_evaluated = 0

        states = mt.states
        self._has_skew = any(st.skew is not None for st in states)

        # Blocks concatenate in canonical (name) order — NOT submission
        # order — so the frozen-load bincount sums every tenant's tasks in
        # one canonical sequence and scores are bit-identical under
        # submission-order permutations. Per-tenant spans map a tenant
        # *index* to its rows/columns.
        order = mt.tenant_set.canonical_order()
        self._comp_span: dict[int, tuple[int, int]] = {}
        self._task_span: dict[int, tuple[int, int]] = {}
        n_all = 0
        t_all = 0
        for t in order:
            st = states[t]
            self._comp_span[t] = (n_all, n_all + st.utg.n_components)
            self._task_span[t] = (t_all, t_all + int(st.n_instances.sum()))
            n_all += st.utg.n_components
            t_all += int(st.n_instances.sum())
        self.n_tasks = t_all
        self.t_max = max(hi - lo for lo, hi in self._task_span.values())

        m = mt.cluster.n_machines
        e_act = np.concatenate([states[t].e_cm for t in order], axis=0)
        met_act = np.concatenate([states[t].met_cm for t in order], axis=0)
        # One zero profile row pads short tenants' columns: a padding task
        # parks on machine 0 with e = met = unit = mem = 0 and contributes
        # nothing to any accumulator.
        self.pad_comp = n_all
        self.e_table = np.concatenate([e_act, np.zeros((1, m))], axis=0)
        self.met_table = np.concatenate([met_act, np.zeros((1, m))], axis=0)

        # Concatenated incumbent row, per-task active maps, and the met
        # fold: each task's committed load on its incumbent machine.
        self._has_network = mt.cluster.has_network
        self._has_memory = mt.cluster.has_memory
        base_row = np.concatenate([states[t].task_machine() for t in order])
        active_comp = np.empty(t_all, dtype=np.int64)
        active_unit = np.empty(t_all, dtype=np.float64)
        task_load = np.empty(t_all, dtype=np.float64)
        # Each tenant's cut-traffic operands for score-time network pricing
        # (its local task maps, alpha and unit-rate component rates), on
        # the device once. Memory demand is rate-independent, so it needs
        # no fold: the scorer gathers each task's demand from the
        # per-component column, whose padding entry is 0.
        self._net_tables: dict[int, tuple[torch.Tensor, ...]] = {}
        self.mem_table = (
            np.concatenate(
                [states[t].mem_c for t in order] + [np.zeros(1)]
            ).astype(np.float64)
            if self._has_memory
            else None
        )
        net_own = np.zeros((len(states), m), dtype=np.float64)
        for t in order:
            st = states[t]
            lo, hi = self._task_span[t]
            comp_t = np.repeat(np.arange(st.utg.n_components), st.n_instances)
            if st.skew is not None:
                unit_t = st.skew.per_task_unit_ir(st.n_instances)
            else:
                unit_t = (st.cir_unit / st.n_instances)[comp_t]
            active_comp[lo:hi] = self._comp_span[t][0] + comp_t
            active_unit[lo:hi] = unit_t
            if self._has_network:
                self._net_tables[t] = (
                    _tensor(comp_t, np.int32, self.device),
                    _tensor(unit_t, np.float64, self.device),
                    _tensor(st.utg.alpha, np.float64, self.device),
                    _tensor(st.cir_unit, np.float64, self.device),
                )
                # Tenant t's committed cut-traffic CPU load at its rate —
                # part of the met fold (also linear in R_t, machine-indexed
                # rather than task-indexed, so it adds after the bincount).
                net_own[t] = float(mt.rates[t]) * st.net_load
            rate_t = float(mt.rates[t])
            w = base_row[lo:hi]
            task_load[lo:hi] = (
                st.met_cm[comp_t, w] + st.e_cm[comp_t, w] * unit_t * rate_t
            )

        self.base_row = base_row
        self.active_comp = active_comp
        self.active_unit = active_unit
        # Fleet frozen load F (canonical-order bincount, plus each tenant's
        # committed network load), then per-tenant residual capacity:
        # cluster capacity minus everyone *else*.
        frozen = np.bincount(base_row, weights=task_load, minlength=m)
        if self._has_network:
            for t in order:
                frozen = frozen + net_own[t]
        self._resid_cap = np.empty((len(states), m), dtype=np.float64)
        for t in order:
            lo, hi = self._task_span[t]
            own = np.bincount(
                base_row[lo:hi], weights=task_load[lo:hi], minlength=m
            )
            if self._has_network:
                own = own + net_own[t]
            self._resid_cap[t] = mt.cluster.capacity - (frozen - own)
        # Residual memory capacity per tenant: neighbours' rate-independent
        # working sets come straight off each machine's memory budget.
        self._resid_mem: np.ndarray | None = None
        if self._has_memory:
            frozen_mem = np.zeros(m, dtype=np.float64)
            for t in order:
                frozen_mem = frozen_mem + states[t].mem_load
            self._resid_mem = np.empty((len(states), m), dtype=np.float64)
            for t in order:
                self._resid_mem[t] = mt.cluster.mem_capacity - (
                    frozen_mem - states[t].mem_load
                )

        # Per-tenant candidate-row templates: the tenant's component and
        # unit-rate columns padded to t_max, and the row's unit-rate sum as
        # NumPy sums a padded (B, t_max) row (the throughput factor).
        n_t = len(states)
        comp_rows = np.full((n_t, self.t_max), self.pad_comp, dtype=np.int64)
        unit_rows = np.zeros((n_t, self.t_max), dtype=np.float64)
        for t in order:
            lo, hi = self._task_span[t]
            comp_rows[t, : hi - lo] = active_comp[lo:hi]
            unit_rows[t, : hi - lo] = active_unit[lo:hi]
        self._unit_sum = unit_rows.sum(axis=1)

        # Device copies of every table a sweep reads.
        dev = self.device
        f64 = np.float64
        self._dev_tables = dict(
            e=_tensor(self.e_table, f64, dev),
            met=_tensor(self.met_table, f64, dev),
            comp=_tensor(comp_rows, np.int32, dev),
            unit=_tensor(unit_rows, f64, dev),
            cap=_tensor(self._resid_cap, f64, dev),
            mem=None if self.mem_table is None else _tensor(self.mem_table, f64, dev),
            memcap=None if self._resid_mem is None else _tensor(self._resid_mem, f64, dev),
            distance=(
                _tensor(mt.cluster.distance, f64, dev) if self._has_network else None
            ),
        )

    # ----------------------------------------------------------- scoring

    def score(
        self, sweeps: "list[tuple[int, np.ndarray]]"
    ) -> "list[tuple[np.ndarray, np.ndarray]]":
        """Score candidate sweeps for several tenants in one kernel call.

        Args:
          sweeps: list of ``(tenant_index, rows)`` where ``rows`` is a
            (B_t, T_t) array of candidate placements for that tenant's
            column block (T_t = tenant's task count). B_t = 0 sweeps are
            allowed and return empty scores.

        Returns:
          One ``(rates, throughputs)`` pair per sweep, in order — each
          tenant's residual closed-form scores for its rows.
        """
        sizes = self._sizes(sweeps)
        b_total = int(sum(sizes))
        if b_total == 0:
            empty = np.zeros(0, dtype=np.float64)
            return [(empty.copy(), empty.copy()) for _ in sweeps]

        ops = self._operands(sweeps, sizes)
        rates, thpt = self._dispatch(
            ops["tm"], ops["comp"], ops["unit"], ops["cap"],
            self._unit_sum[ops["row_tenant"]],
            net_var=ops["net"], mem_capacity=ops["memcap"],
        )
        self.candidates_evaluated += b_total
        out: list[tuple[np.ndarray, np.ndarray]] = []
        row0 = 0
        for b_t in sizes:
            out.append((rates[row0 : row0 + b_t], thpt[row0 : row0 + b_t]))
            row0 += b_t
        return out

    def _sizes(self, sweeps) -> list[int]:
        """Rows of each sweep, after checking its width."""
        sizes = []
        for t, rows in sweeps:
            rows = np.asarray(rows, dtype=np.int64)
            lo, hi = self._task_span[t]
            if rows.ndim != 2 or rows.shape[1] != hi - lo:
                raise ValueError(
                    f"tenant {t} sweep must be (B, {hi - lo}), got {rows.shape}"
                )
            sizes.append(rows.shape[0])
        return sizes

    def _operands(self, sweeps, sizes: list[int]) -> dict:
        """The scorer's operands of a non-empty batch, on the device.

        Only the candidate rows (``tm``, int32, padding tasks on machine 0)
        and the row -> tenant index cross from the host; each row's
        component and unit-rate row, capacity and memory capacity are
        gathered from the per-tenant tables on the device.
        """
        dev = self.device
        b_total = int(sum(sizes))
        tm = np.zeros((b_total, self.t_max), dtype=np.int32)
        row_tenant = np.empty(b_total, dtype=np.int64)
        row0 = 0
        for (t, rows), b_t in zip(sweeps, sizes):
            if b_t == 0:
                continue
            lo, hi = self._task_span[t]
            tm[row0 : row0 + b_t, : hi - lo] = np.asarray(rows, dtype=np.int64)
            row_tenant[row0 : row0 + b_t] = t
            row0 += b_t
        tm_dev = torch.from_numpy(tm).to(dev)
        index = torch.from_numpy(row_tenant).to(dev)
        tables = self._dev_tables
        return dict(
            tm=tm_dev,
            row_tenant=row_tenant,
            index=index,
            comp=tables["comp"].index_select(0, index),
            unit=tables["unit"].index_select(0, index),
            cap=tables["cap"].index_select(0, index),
            net=self._net_var(sweeps, sizes, tm_dev) if self._has_network else None,
            memcap=(
                tables["memcap"].index_select(0, index) if self._has_memory else None
            ),
        )

    def _net_var(self, sweeps, sizes: list[int], tm: torch.Tensor) -> torch.Tensor:
        """(B, m) cut-traffic term of a batch: each tenant's candidate rows
        price their *own* topology's cut traffic (cross-tenant traffic does
        not exist — tenants are separate topologies) against the shared
        distance matrix, one ``network_unit_load`` call (one cut_traffic
        launch on a card) a non-empty sweep, concatenated on the device."""
        cluster = self.mt.cluster
        parts = []
        row0 = 0
        for (t, _rows), b_t in zip(sweeps, sizes):
            if b_t == 0:
                continue
            lo, hi = self._task_span[t]
            comp_t, unit_t, alpha_t, cir_t = self._net_tables[t]
            parts.append(
                cost_model.network_unit_load(
                    tm[row0 : row0 + b_t, : hi - lo],
                    comp_t,
                    unit_t,
                    alpha_t,
                    cir_t,
                    self.mt.states[t].utg.edges,
                    self._dev_tables["distance"],
                    cluster.net_penalty,
                    device=self.device,
                )
            )
            row0 += b_t
        return torch.cat(parts, dim=0)

    def residual_rates(self) -> np.ndarray:
        """(N,) residual closed-form R* of every tenant's incumbent row —
        all tenants scored as rows of one batched call."""
        sweeps = []
        for t in range(len(self.mt.states)):
            lo, hi = self._task_span[t]
            sweeps.append((t, self.base_row[lo:hi][None, :]))
        scored = self.score(sweeps)
        return np.array([float(r[0]) for r, _ in scored], dtype=np.float64)

    def _dispatch(
        self,
        tm: torch.Tensor,
        comp: torch.Tensor,
        unit: torch.Tensor,
        capacity: torch.Tensor,
        unit_sum: np.ndarray,
        net_var: torch.Tensor | None = None,
        mem_capacity: torch.Tensor | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        from repro_torch.core.simulator import resolve_closed_form_device

        dev = resolve_closed_form_device(
            self.device,
            tm.numel(),
            regime="skew" if self._has_skew else "per_row",
            n_machines=capacity.shape[-1],
            site="tenant_batch",
        )
        tables = self._dev_tables
        return cost_model.closed_form_rates(
            tm, comp, unit, tables["e"], tables["met"], capacity,
            net_var=net_var,
            mem_c=None if mem_capacity is None else tables["mem"],
            mem_capacity=mem_capacity,
            device=dev,
            unit_sum=unit_sum,
        )

    # ------------------------------------------------- reference (tests)

    def reference_scores(
        self, tenant: int, rows: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """Per-tenant reference: explicit residual-capacity scoring.

        Builds a fresh single-tenant state on ``residual_cluster(tenant)``
        and scores ``rows`` through the stock path on the CPU — the loop the
        parity tests compare the batched scoring against.
        """
        mt = self.mt
        st = mt.states[tenant]
        solo = ScheduleState.from_etg(
            st.to_etg(), mt.residual_cluster(tenant), skew=st.skew
        )
        return solo.score_task_machine_batch(
            np.asarray(rows, dtype=np.int64), device="cpu"
        )
