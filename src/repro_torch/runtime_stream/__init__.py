"""Online streaming runtime, ported: trace-driven execution of schedules
over time.

Everything before this subsystem scored and searched *static* placements;
this package executes them against time-varying workloads:

* ``traces``     — declarative workload scenarios (rate ramps, bursts,
                   sinusoidal drift, machine slowdown/removal) compiled to
                   dense per-window arrays by a seed;
* ``executor``   — a deterministic windowed event loop with per-instance
                   queues, profile-table service costs, machine saturation
                   and spout back-pressure;
* ``controller`` — drift detection + guarded incremental replanning on
                   ``ScheduleState`` via ``refine``'s move set;
* ``eval_torch`` — B traces × P policies in one sweep (one launch of the
                   ``policy_scan`` kernel on a card), agreeing with the
                   Python loop to ~1e-9;
* ``convert``    — the port's compiled traces from the reference's.

Host bookkeeping (the event loop, trace compilation, the controller's
triggers and guard) is NumPy, as in the reference; the controllers'
``refine`` sweeps and the batch evaluator take ``device=`` (default
``"cuda"``).
"""

from repro_torch.runtime_stream.controller import (
    OnlineController,
    OracleRescheduler,
    WindowObs,
    provision_schedule,
)
from repro_torch.runtime_stream.eval_torch import PolicyEvalResult, evaluate_policies_batch
from repro_torch.runtime_stream.executor import (
    MigrationTransfer,
    RuntimeConfig,
    RuntimeResult,
    StreamExecutor,
    placement_migrations,
    placement_transfer,
    transfer_pause_windows,
)
from repro_torch.runtime_stream.traces import (
    CompiledTrace,
    KeyRealization,
    KeyedEdgeTrace,
    TraceSpec,
    burst_trace,
    elastic_trace,
    failure_trace,
    key_skew_shift,
    machine_addition,
    machine_removal,
    machine_slowdown,
    ramp_trace,
    rate_burst,
    rate_noise,
    rate_ramp,
    rate_sine,
    sine_trace,
    skew_shift_trace,
    slowdown_trace,
)

__all__ = [
    "TraceSpec",
    "CompiledTrace",
    "KeyRealization",
    "KeyedEdgeTrace",
    "rate_ramp",
    "rate_burst",
    "rate_sine",
    "rate_noise",
    "machine_slowdown",
    "machine_removal",
    "machine_addition",
    "key_skew_shift",
    "ramp_trace",
    "burst_trace",
    "sine_trace",
    "slowdown_trace",
    "failure_trace",
    "skew_shift_trace",
    "elastic_trace",
    "RuntimeConfig",
    "RuntimeResult",
    "StreamExecutor",
    "MigrationTransfer",
    "placement_migrations",
    "placement_transfer",
    "transfer_pause_windows",
    "WindowObs",
    "OnlineController",
    "OracleRescheduler",
    "provision_schedule",
    "PolicyEvalResult",
    "evaluate_policies_batch",
]
