"""LM stage-graph extraction: an architecture becomes a paper-style
topology whose components are pipeline stages.

The port of ``repro.sched.stage_model``, on the port's ``core.graph`` and
``core.profiles``. The model is cut into ``n_stages`` contiguous stages
(embed folded into the first, lm head into the last). Each stage gets an
analytic per-token cost on every device pool — roofline seconds per token
on one group of that pool — which plays exactly the role of the paper's
``e_ij`` profiling table (units: fraction-of-group-seconds per token/s,
scaled to the 100-point machine budget of ``repro_torch.core``). Stage
graphs are linear (alpha=1 chains): every token flows through every stage;
MoE fan-out stays inside a stage (its cost reflects the active-expert
FLOPs).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import UserGraph
from repro_torch.core.profiles import Cluster, Profile
from repro_torch.models.config import ModelConfig
from repro_torch import roofline  # a module: roofline imports sched.fleet
from repro_torch.sched.fleet import Fleet

__all__ = ["StageModel", "build_stage_model", "fleet_cluster"]


@dataclasses.dataclass(frozen=True)
class StageModel:
    utg: UserGraph
    profile: Profile
    flops_per_token: np.ndarray   # (n_stages,) forward FLOPs per token
    bytes_per_token: np.ndarray   # (n_stages,) weight bytes touched per token


def build_stage_model(
    cfg: ModelConfig,
    fleet: Fleet,
    n_stages: int = 4,
    decode: bool = True,
    met_points: float = 0.5,
) -> StageModel:
    """Cut the model into stages and profile them against fleet pools."""
    counts = roofline.param_counts(cfg)
    n_active = counts["active"]
    L = cfg.n_layers
    n_stages = min(n_stages, L)
    per_stage_layers = [
        L // n_stages + (1 if i < L % n_stages else 0) for i in range(n_stages)
    ]
    embed_params = cfg.vocab_size * cfg.d_model
    body = max(n_active - embed_params * (1 if cfg.tie_embeddings else 2), 0)
    layer_params = body / L

    flops, wbytes = [], []
    for i, nl in enumerate(per_stage_layers):
        p = layer_params * nl
        if i == 0:
            p += embed_params * 0.02  # embedding lookups: bytes, not matmul
        if i == n_stages - 1:
            p += embed_params        # lm head matmul
        flops.append(2.0 * p)        # fwd matmul FLOPs per token
        wbytes.append(2.0 * p)       # bf16 weight bytes per token (decode:
                                     # memory-bound weight streaming)

    flops = np.asarray(flops)
    wbytes = np.asarray(wbytes)

    # e_ij: seconds-per-token of stage i on one group of pool j, as
    # 100-point capacity units (100 points == 1 group-second per second).
    e = np.zeros((n_stages + 1, len(fleet.pools)))
    met = np.zeros_like(e)
    for j, pool in enumerate(fleet.pools):
        for i in range(n_stages):
            t_comp = flops[i] / pool.group_flops
            t_mem = (wbytes[i] / pool.group_hbm_bw) if decode else 0.0
            e[i + 1, j] = max(t_comp, t_mem) * 100.0
        # source component (request ingress): negligible compute
        e[0, j] = 1e-4
        met[:, j] = met_points

    types = np.arange(n_stages + 1)
    types[0] = 0
    utg = UserGraph(
        name=f"{cfg.name}-{n_stages}stages",
        component_types=types,
        edges=tuple((i, i + 1) for i in range(n_stages)),
        alpha=np.ones(n_stages + 1),
    )
    profile = Profile(
        e=e,
        met=met,
        type_names=tuple(["ingress"] + [f"stage{i}" for i in range(n_stages)]),
        machine_type_names=tuple(p.name or p.chip.name for p in fleet.pools),
    )
    return StageModel(utg=utg, profile=profile,
                      flops_per_token=flops, bytes_per_token=wbytes)


def fleet_cluster(fleet: Fleet, stage_model: StageModel) -> Cluster:
    """Fleet -> core.Cluster: one machine per device group."""
    return Cluster(
        machine_types=fleet.pool_of_group(),
        capacity=np.full(fleet.n_groups, 100.0),
        profile=stage_model.profile,
    )
