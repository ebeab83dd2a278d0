"""TilePlan — the solver's output artifact.

A plan carries everything downstream consumers need:

* the tile size per dim variable (→ Pallas ``BlockSpec`` block shapes),
* the grid (outer→inner) with per-dim tile counts,
* the cost report (HBM traffic, DMA count, VMEM bytes) — the paper's
  reported metrics,
* helpers to compare a fused plan against the layer-per-layer baseline
  (reproduces the paper's "-47.1 % DMA transfers" table).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core import hw as hwlib

from .constraints import DimConstraint
from .cost import CostReport
from .ir import FusionGroup


@dataclasses.dataclass
class TilePlan:
    group: FusionGroup
    tiles: dict[str, int]
    constraints: dict[str, DimConstraint]
    report: CostReport
    target: hwlib.Target
    nodes_explored: int = 0

    @property
    def vmem_budget(self) -> int:
        """Fast-level capacity of the planning target (back-compat name)."""
        return self.target.fast_capacity

    # ------------------------------------------------------------------
    # accessors used by the kernels
    # ------------------------------------------------------------------
    def tile(self, dim: str) -> int:
        return self.tiles[dim]

    def size(self, dim: str) -> int:
        return self.constraints[dim].size

    def grid_dims(self) -> tuple[str, ...]:
        """Grid dims outer→inner (only dims with >1 tile)."""
        return tuple(d for d, _ in self.report.grid)

    def grid_shape(self) -> tuple[int, ...]:
        return tuple(c for _, c in self.report.grid)

    def block_shape(self, tensor: str) -> tuple[int, ...]:
        t = self.group.tensors[tensor]
        return tuple(self.tiles[d] for d in t.dims)

    # ------------------------------------------------------------------
    # reporting
    # ------------------------------------------------------------------
    @property
    def traffic_bytes(self) -> int:
        return self.report.traffic_bytes

    @property
    def dma_transfers(self) -> int:
        return self.report.dma_transfers

    @property
    def vmem_bytes(self) -> int:
        return self.report.vmem_bytes

    @property
    def transfer_time_s(self) -> float:
        return self.report.transfer_time_s

    @property
    def compute_time_s(self) -> float:
        return self.report.compute_time_s

    @property
    def modeled_runtime_s(self) -> float:
        """The solver's objective: max(compute, transfer)."""
        return self.report.modeled_runtime_s

    @property
    def compute_bound(self) -> bool:
        return self.report.compute_bound

    @property
    def n_steps(self) -> int:
        """Tile steps of the schedule (grid block count) — what the
        schedule IR in ``repro.sim`` replays event by event."""
        return self.report.n_steps

    @property
    def per_engine_compute_s(self) -> dict[str, float]:
        """Serialized compute seconds per Target engine (the implicit
        ``core`` engine for engine-less targets)."""
        return self.report.per_engine_compute_s

    @property
    def per_level_traffic(self) -> dict[str, int]:
        return self.report.per_level_traffic

    def intermediate_bytes_avoided(self) -> int:
        """HBM bytes the fusion avoids: every intermediate is written once
        and read once in the layer-per-layer schedule (at minimum)."""
        sizes = {d: c.size for d, c in self.constraints.items()}
        return sum(
            2 * t.bytes_full(sizes) for t in self.group.intermediate_tensors()
        )

    def summary(self) -> str:
        per_level = ", ".join(
            f"{name}={b / 2**20:.2f} MiB"
            for name, b in self.report.per_level_traffic.items()
        )
        lines = [
            f"FTL plan '{self.group.name}' on target '{self.target.name}':",
            f"  tiles   : "
            + ", ".join(f"{d}={self.tiles[d]}/{self.constraints[d].size}"
                        for d in sorted(self.tiles)),
            f"  grid    : "
            + " > ".join(f"{d}x{c}" for d, c in self.report.grid)
            + (" (single block)" if not self.report.grid else ""),
            f"  {self.target.fast.name:7s} : "
            f"{self.vmem_bytes/2**20:.2f} MiB / "
            f"{self.vmem_budget/2**20:.2f} MiB budget",
            f"  traffic : {self.traffic_bytes/2**20:.2f} MiB over "
            f"{self.dma_transfers} DMA transfers ({per_level})",
            f"  time    : {1e3 * self.modeled_runtime_s:.3f} ms modeled "
            f"runtime (compute {1e3 * self.compute_time_s:.3f} ms, "
            f"transfer {1e3 * self.transfer_time_s:.3f} ms; "
            f"{'compute' if self.compute_bound else 'transfer'}-bound)",
            f"  AI      : {self.report.arithmetic_intensity:.1f} FLOP/B",
        ]
        return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class FusionComparison:
    """Fused-vs-unfused metrics — the paper's headline numbers."""

    fused_traffic: int
    unfused_traffic: int
    fused_dma: int
    unfused_dma: int
    fused_vmem: int
    unfused_vmem: int

    @property
    def traffic_reduction(self) -> float:
        return 1.0 - self.fused_traffic / max(1, self.unfused_traffic)

    @property
    def dma_reduction(self) -> float:
        return 1.0 - self.fused_dma / max(1, self.unfused_dma)

    def summary(self) -> str:
        return (
            f"traffic {self.unfused_traffic/2**20:.2f} MiB -> "
            f"{self.fused_traffic/2**20:.2f} MiB "
            f"({100*self.traffic_reduction:.1f} % reduction); "
            f"DMA {self.unfused_dma} -> {self.fused_dma} "
            f"({100*self.dma_reduction:.1f} % reduction)"
        )


def compare(fused: TilePlan, unfused: Sequence[TilePlan]) -> FusionComparison:
    return FusionComparison(
        fused_traffic=fused.traffic_bytes,
        unfused_traffic=sum(p.traffic_bytes for p in unfused),
        fused_dma=fused.dma_transfers,
        unfused_dma=sum(p.dma_transfers for p in unfused),
        fused_vmem=fused.vmem_bytes,
        unfused_vmem=max(p.vmem_bytes for p in unfused),
    )
