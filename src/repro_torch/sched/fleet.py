"""Heterogeneous GPU fleet descriptions (the "machines" of the paper).

The port of ``repro.sched.fleet``. A fleet is a set of device *pools*; each
pool is a number of identical device groups (an HGX node's eight GPUs
hosting one model replica, or a single card). Pools play the role of the
paper's machine types; the per-(stage, pool) step-time model plays the
role of the e_ij profiling table; a pool member's step-time budget plays
the role of the 100-point CPU capacity.

The chips are NVIDIA's, each value from its data sheet (dense bf16 tensor
core rate, without sparsity; memory bandwidth; the bandwidth of one
interconnect link; memory capacity). The reference's TPU generations are
not carried over.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "A100_SXM",
    "H100_SXM",
    "L4",
    "ChipSpec",
    "DevicePool",
    "Fleet",
    "h100_node_fleet",
]


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Per-chip hardware constants. ``ici_bw`` keeps the reference's name:
    here it is the bandwidth of one link between the group's GPUs (an
    NVLink link, or the PCIe slot of a card without NVLink)."""

    name: str
    peak_flops: float       # FLOP/s (bf16)
    hbm_bw: float           # bytes/s
    ici_bw: float           # bytes/s per link
    hbm_bytes: float        # capacity

    def step_seconds(self, flops: float, bytes_moved: float, coll_bytes: float) -> float:
        """Roofline step time: max of the three terms (no overlap assumed)."""
        return max(
            flops / self.peak_flops,
            bytes_moved / self.hbm_bw,
            coll_bytes / self.ici_bw,
        )


# NVIDIA H100 Tensor Core GPU data sheet, SXM5: 989 TFLOP/s bf16 dense (1 979
# with sparsity), 3.35 TB/s HBM3, NVLink 4 at 900 GB/s over 18 links (50 GB/s
# a link), 80 GB.
H100_SXM = ChipSpec("h100_sxm", peak_flops=989e12, hbm_bw=3.35e12, ici_bw=50e9, hbm_bytes=80e9)
# NVIDIA A100 Tensor Core GPU data sheet, SXM4 80 GB: 312 TFLOP/s bf16 dense,
# 2 039 GB/s HBM2e, NVLink 3 at 600 GB/s over 12 links (50 GB/s a link), 80 GB.
A100_SXM = ChipSpec("a100_sxm", peak_flops=312e12, hbm_bw=2.039e12, ici_bw=50e9,
                    hbm_bytes=80e9)
# NVIDIA L4 Tensor Core GPU data sheet: 121 TFLOP/s bf16 dense (242 with
# sparsity), 300 GB/s GDDR6, PCIe Gen4 x16 at 64 GB/s (no NVLink), 24 GB.
L4 = ChipSpec("l4", peak_flops=121e12, hbm_bw=300e9, ici_bw=64e9, hbm_bytes=24e9)


@dataclasses.dataclass(frozen=True)
class DevicePool:
    """``count`` identical device groups of ``chips_per_group`` chips each.

    One group hosts one model replica (TP spans the group); a group is the
    paper's "machine".
    """

    chip: ChipSpec
    count: int
    chips_per_group: int = 1
    name: str = ""

    @property
    def group_flops(self) -> float:
        return self.chip.peak_flops * self.chips_per_group

    @property
    def group_hbm_bw(self) -> float:
        return self.chip.hbm_bw * self.chips_per_group

    @property
    def group_hbm_bytes(self) -> float:
        return self.chip.hbm_bytes * self.chips_per_group


@dataclasses.dataclass(frozen=True)
class Fleet:
    pools: tuple[DevicePool, ...]

    @property
    def n_groups(self) -> int:
        return sum(p.count for p in self.pools)

    def pool_of_group(self) -> np.ndarray:
        """(n_groups,) pool index per device group."""
        return np.concatenate(
            [np.full(p.count, i, dtype=np.int64) for i, p in enumerate(self.pools)]
        )


def h100_node_fleet(n_nodes: int = 4, groups_per_node: int = 1, gpus_per_group: int = 8) -> Fleet:
    """A homogeneous fleet of HGX H100 nodes (eight GPUs a node), cut into
    ``groups_per_node`` groups of ``gpus_per_group`` GPUs each."""
    return Fleet(
        pools=(
            DevicePool(
                chip=H100_SXM,
                count=n_nodes * groups_per_node,
                chips_per_group=gpus_per_group,
                name="h100",
            ),
        )
    )
