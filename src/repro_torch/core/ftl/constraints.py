"""FTL constraint construction (paper step 2).

Three constraint families from the paper, plus the sharding family we add
for the multi-chip setting (DESIGN.md §2):

* geometric      — dim variables linked across tensors of one op (handled
                   structurally by the IR: linked dims share one name).
* kernel-policy  — what the kernel dataflow permits: whole-vs-accumulated
                   contractions, VREG/MXU alignment lattice.
* performance    — minimum tile sizes that keep the MXU fed.
* sharding       — tile domains restricted to the per-shard dim sizes.

The output of this module is, per dim, a *candidate tile domain* plus flags
the solver/cost model needs (is-contract, needs-accumulator).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

from .ir import (
    FusionGroup,
    Role,
    TensorSpec,
    aligned_divisors,
    dtype_bytes,
)

# Max candidates per dim fed to the solver (log-spaced thin-out beyond this).
_MAX_CANDIDATES = 14


@dataclasses.dataclass
class DimConstraint:
    """Solved-out constraint record for one dim variable."""

    name: str
    size: int
    candidates: tuple[int, ...]      # legal tile sizes (ascending)
    is_contract: bool                # reduced by at least one op
    contract_whole: bool             # some op forbids tiling this contraction
    alignment: int                   # lattice the candidates respect
    min_tile: int


def _dim_alignment(group: FusionGroup, dim: str) -> tuple[int, int]:
    """(alignment, min_tile) for ``dim`` = strictest requirement over every
    tensor position it occupies.

    Last-axis occurrences demand lane alignment (128); second-minor demand
    sublane alignment (8 for 4-byte dtypes, 16 for 2-byte, 32 for 1-byte).
    """
    align = 1
    min_tile = 1
    for op in group.ops:
        pol = op.policy
        for t in op.tensors():
            if dim not in t.dims:
                continue
            pos = len(t.dims) - 1 - t.dims[::-1].index(dim)
            if pos == len(t.dims) - 1:
                align = max(align, pol.lane_align)
                min_tile = max(min_tile, pol.min_tile)
            elif pos == len(t.dims) - 2:
                # 4-byte -> 8, 2-byte -> 16, 1-byte -> 32 sublanes
                sub = {4: 8, 2: 16, 1: 32}.get(dtype_bytes(t.dtype), 8)
                sub = max(sub, pol.sublane_align)
                align = max(align, sub)
                min_tile = max(min_tile, pol.min_tile)
    return align, min_tile


def _thin(cands: list[int], limit: int = _MAX_CANDIDATES) -> tuple[int, ...]:
    if len(cands) <= limit:
        return tuple(cands)
    # keep endpoints, log-space the middle
    keep = {cands[0], cands[-1]}
    n = len(cands)
    for i in range(limit):
        keep.add(cands[min(n - 1, int(round(i * (n - 1) / (limit - 1))))])
    return tuple(sorted(keep))


def build_dim_constraints(
    group: FusionGroup,
    *,
    sharded_sizes: Mapping[str, int] | None = None,
    whole_dims: set[str] | frozenset[str] = frozenset(),
) -> dict[str, DimConstraint]:
    """Compute per-dim tile domains for a fusion group.

    ``sharded_sizes`` overrides the full size of dims that are split across
    a mesh axis (the planner then plans the *per-shard* problem — the
    sharding constraint family).  ``whole_dims`` pins extra dims to their
    full size (a kernel-policy constraint supplied by a specific kernel's
    dataflow, e.g. the fused-MLP kernel keeps K and N un-tiled).
    """
    sharded_sizes = dict(sharded_sizes or {})
    out: dict[str, DimConstraint] = {}

    contract_dims: set[str] = set()
    whole_dims = set(whole_dims)
    for op in group.ops:
        for d in op.contract_dims():
            contract_dims.add(d)
            if op.policy.contract_whole:
                whole_dims.add(d)

    for name, dim in group.dims.items():
        size = sharded_sizes.get(name, dim.size)
        if size <= 0 or dim.size % size != 0:
            raise ValueError(
                f"sharded size {size} does not divide dim {name}={dim.size}"
            )
        align, min_tile = _dim_alignment(group, name)
        if name in whole_dims:
            cands: tuple[int, ...] = (size,)
        else:
            cands = _thin(
                [c for c in aligned_divisors(size, align) if c >= min(min_tile, size)]
            )
        out[name] = DimConstraint(
            name=name,
            size=size,
            candidates=cands,
            is_contract=name in contract_dims,
            contract_whole=name in whole_dims,
            alignment=align,
            min_tile=min_tile,
        )
    return out


def accumulator_tensors(group: FusionGroup, tiles: Mapping[str, int],
                        cons: Mapping[str, DimConstraint]) -> list[TensorSpec]:
    """fp32 VMEM accumulators required when a contraction dim is tiled.

    One accumulator per GEMM whose contract dim has n_tiles > 1; its shape is
    the op's output tile, dtype fp32 (kernel-policy constraint:
    ``contract_accumulate`` must be allowed, else the assignment is illegal
    — the solver filters that case via ``contract_whole`` domains already).
    """
    accs = []
    for op in group.ops:
        if op.kind != "gemm":
            continue
        tiled_contract = any(
            tiles[d] < cons[d].size for d in op.contract_dims()
        )
        if tiled_contract:
            accs.append(
                TensorSpec(
                    name=f"{op.name}__acc",
                    dims=op.output.dims,
                    dtype="float32",
                    role=Role.ACCUMULATOR,
                )
            )
    return accs
