"""Step analyser: matmul FLOPs, collective bytes and touched bytes of one call.

The counterpart of ``repro.hlo_analysis``. The reference parses the
partitioned HLO text of a compiled step and multiplies while-loop bodies by
their trip counts; eager PyTorch has no HLO text, so this runs the call
once and counts the aten operations it dispatches:

* matmul FLOPs from ``torch.utils.flop_counter.FlopCounterMode``
  (products, batched products, convolutions, attention). An eager loop
  dispatches every iteration, so no trip count is needed;
* collective payload bytes by kind (``all-gather``, ``all-reduce``,
  ``reduce-scatter``, ``all-to-all``, ``collective-permute``), each the
  bytes of the collective's result, the reference's convention, from the
  c10d functional collectives and the eager c10d operations (a receive
  counts as ``collective-permute``);
* ``touched_bytes``: the sum of every operation's result bytes. Like the
  reference's figure it is an upper bound on the memory traffic: views
  count, and nothing is fused.

It runs on CPU, CUDA or meta tensors (on meta tensors nothing is computed
or allocated).

``analyze_local`` is the per-device count of a step over DTensors (the
mesh route): ``FlopCounterMode`` counts a DTensor product at its global
size, so this counter lets every DTensor operation desugar first (its
handler declines DTensor arguments) and counts what one rank runs: each
product on its local operand shapes (``FlopCounterMode``'s formulas), each
collective on its local shard, each result's bytes. It also follows the
bytes of live tensors: every result's storage is counted from its creation
until its last tensor dies, and the peak is reported. The port's hand-written kernels are opaque to it: their
wrappers launch them through ``ctypes``, outside the dispatcher, as Pallas
custom calls are opaque to ``analyze_hlo``. On CPU tensors the wrappers run
their plain versions, which are counted.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["StepCosts", "analyze_local", "analyze_step"]

# Collective operations by name (``<namespace>.<op>``) and their kind.
_COLLECTIVES = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_c10d_functional_autograd.all_to_all_single": "all-to-all",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allreduce_": "all-reduce",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.recv_": "collective-permute",
}
# Bookkeeping around a functional collective: its result aliases the
# collective's, so neither is counted again.
_SKIP = {"_c10d_functional.wait_tensor", "_c10d_functional._wrap_tensor_autograd"}


@dataclasses.dataclass
class StepCosts:
    """The fields of the reference's ``HloCosts``."""

    matmul_flops: float = 0.0
    collective_bytes: float = 0.0
    by_kind: dict = dataclasses.field(default_factory=dict)
    collective_counts: dict = dataclasses.field(default_factory=dict)
    touched_bytes: float = 0.0

    def add(self, other: "StepCosts", mult: float = 1.0) -> None:
        self.matmul_flops += other.matmul_flops * mult
        self.collective_bytes += other.collective_bytes * mult
        self.touched_bytes += other.touched_bytes * mult
        for k, v in other.by_kind.items():
            self.by_kind[k] = self.by_kind.get(k, 0.0) + v * mult
        for k, v in other.collective_counts.items():
            self.collective_counts[k] = self.collective_counts.get(k, 0.0) + v * mult


def _result_bytes(out: Any) -> int:
    """Bytes of every tensor in an operation's result (lists and tuples
    walked; a c10d work handle holds none)."""
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_result_bytes(x) for x in out)
    return 0


def _op_name(func) -> str:
    return f"{func.namespace}.{func._schema.name.split('::')[-1]}"


class _Counter(TorchDispatchMode):
    def __init__(self, costs: StepCosts):
        super().__init__()
        self.costs = costs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = _op_name(func)
        if name in _SKIP:
            return out
        nbytes = _result_bytes(out)
        self.costs.touched_bytes += nbytes
        kind = _COLLECTIVES.get(name)
        if kind is not None:
            if name.startswith("c10d.") and isinstance(out, tuple):
                nbytes = _result_bytes(out[0])  # (tensors, work)
            self.costs.collective_bytes += nbytes
            self.costs.by_kind[kind] = self.costs.by_kind.get(kind, 0.0) + nbytes
            self.costs.collective_counts[kind] = self.costs.collective_counts.get(kind, 0.0) + 1
        return out


def analyze_step(fn, *args, **kwargs) -> StepCosts:
    """Run ``fn(*args, **kwargs)`` once and count what it dispatched."""
    costs = StepCosts()
    with FlopCounterMode(display=False) as flops, _Counter(costs):
        fn(*args, **kwargs)
    costs.matmul_flops = float(flops.get_total_flops())
    return costs


class _LocalCounter(_Counter):
    """``_Counter`` on what one rank runs (module docstring)."""

    def __init__(self, costs: StepCosts, site=None):
        super().__init__(costs)
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.site = site
        self.live = {}      # storage key -> [bytes, live tensors]
        self.live_bytes = 0
        self.peak_bytes = 0
        self.backward_start_bytes = None  # live bytes when the first backward operation ran
        self.sites = {}     # (site, kind) -> [bytes, calls]

    def _track(self, out) -> None:
        import weakref

        if isinstance(out, (list, tuple)):
            for x in out:
                self._track(x)
            return
        if not isinstance(out, torch.Tensor):
            return
        st = out.untyped_storage()
        key = st._cdata
        entry = self.live.get(key)
        if entry is None:
            entry = self.live[key] = [st.nbytes(), 0]
            self.live_bytes += entry[0]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        entry[1] += 1
        weakref.finalize(out, self._release, key)

    def _release(self, key) -> None:
        entry = self.live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live_bytes -= entry[0]
            del self.live[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor desugars into local operations first
        if any(issubclass(t, FakeTensor) for t in types):
            # DTensor's sharding propagation runs an operation on fake
            # tensors of the global shapes for their metadata: no rank's work
            return func(*args, **(kwargs or {}))
        kwargs = kwargs or {}
        if self.backward_start_bytes is None and torch._C._current_autograd_node() is not None:
            self.backward_start_bytes = self.live_bytes
        packet = func._overloadpacket
        if packet not in self.registry:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        before = self.costs.collective_bytes
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if packet in self.registry:
            self.costs.matmul_flops += float(self.registry[packet](*args, **kwargs, out_val=out))
        if self.site is not None and self.costs.collective_bytes > before:
            key = (self.site(), _COLLECTIVES[_op_name(func)])
            entry = self.sites.setdefault(key, [0.0, 0])
            entry[0] += self.costs.collective_bytes - before
            entry[1] += 1
        if _op_name(func) not in _SKIP:
            self._track(out)
        return out


def analyze_local(fn, *args, site=None, **kwargs):
    """Run ``fn(*args, **kwargs)`` once and count, per device, what it
    dispatched. Returns (``StepCosts``, peak live bytes of the tensors the
    call made, {(site, kind): [bytes, calls]} of its collectives, the live
    bytes held when the backward pass began, or at the end without one:
    the activations a step keeps for its backward).

    ``site()``, where given, names the call site of each collective (the
    caller's frame walk); without it the third result is empty."""
    import gc

    gc.collect()  # the tensors of earlier work go first, not during the count
    costs = StepCosts()
    mode = _LocalCounter(costs, site)
    with mode:
        fn(*args, **kwargs)
    held = mode.live_bytes if mode.backward_start_bytes is None else mode.backward_start_bytes
    return costs, mode.peak_bytes, mode.sites, held
