"""FTL intermediate representation (paper step 1).

Every operator participating in Fused-Tiled-Layer planning is described by
an :class:`OpNode` over named :class:`Dim` variables.  A tensor is a tuple
of dims; an op declares how its output dims relate to its input dims via
:class:`DimLink`.  Dimension *names* are the constraint variables of the
paper: fusing two ops binds the shared tensor's names together (step 3),
after which one joint constraint problem is solved (step 4).

The IR is deliberately tiny — GEMM-like contractions, elementwise maps and
reductions cover every layer the paper (and our model zoo) fuses.  Window
(conv-like) links are included for the whisper/frontend family.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Mapping, Sequence

# ---------------------------------------------------------------------------
# dtypes: we avoid importing jax here so the solver is usable standalone.
# ---------------------------------------------------------------------------
_DTYPE_BYTES = {
    "float32": 4,
    "bfloat16": 2,
    "float16": 2,
    "int8": 1,
    "uint8": 1,
    "int32": 4,
}


def dtype_bytes(dtype: str) -> int:
    try:
        return _DTYPE_BYTES[dtype]
    except KeyError as e:
        raise ValueError(f"unknown dtype {dtype!r}") from e


class Role(enum.Enum):
    """Where a tensor lives for the planner."""

    INPUT = "input"            # streamed HBM -> VMEM
    WEIGHT = "weight"          # streamed HBM -> VMEM (revisited across grid)
    OUTPUT = "output"          # streamed VMEM -> HBM
    INTERMEDIATE = "intermediate"  # fused away: VMEM-resident tile only
    ACCUMULATOR = "accumulator"    # fp32 VMEM scratch (contraction tiling)


class LinkKind(enum.Enum):
    EQ = "eq"               # output dim == input dim (same variable)
    CONTRACT = "contract"   # input dim reduced away by this op
    WINDOW = "window"       # input dim = stride*out + (k - stride)  (conv)
    BROADCAST = "broadcast"  # input lacks this output dim


@dataclasses.dataclass(frozen=True)
class Dim:
    """A named dimension variable with its full (untiled) size."""

    name: str
    size: int

    def __post_init__(self):
        if self.size <= 0:
            raise ValueError(f"dim {self.name} has nonpositive size {self.size}")


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor = ordered dims + dtype + role."""

    name: str
    dims: tuple[str, ...]          # dim variable names, row-major
    dtype: str = "bfloat16"
    role: Role = Role.INPUT

    @property
    def rank(self) -> int:
        return len(self.dims)

    def bytes_full(self, sizes: Mapping[str, int]) -> int:
        n = dtype_bytes(self.dtype)
        for d in self.dims:
            n *= sizes[d]
        return n

    def bytes_tile(self, tiles: Mapping[str, int]) -> int:
        n = dtype_bytes(self.dtype)
        for d in self.dims:
            n *= tiles[d]
        return n


@dataclasses.dataclass(frozen=True)
class DimLink:
    """Relation between an op's input dim and a (possibly absent) output dim."""

    input_tensor: str
    input_dim: str
    kind: LinkKind
    output_dim: str | None = None   # None for CONTRACT
    window: int = 1                 # conv kernel size (WINDOW only)
    stride: int = 1                 # conv stride (WINDOW only)


@dataclasses.dataclass(frozen=True)
class KernelPolicy:
    """Paper step-2 'kernel policy constraints' — the dataflow a kernel
    implementation permits, plus hardware alignment.

    * ``contract_whole``: the contraction dim(s) must be un-tiled (classic
      output-stationary GEMM without a K loop).
    * ``contract_accumulate``: contraction dims may be tiled, requiring an
      fp32 accumulator buffer in VMEM for the output tile.
    * ``lane_align`` / ``sublane_align``: the TPU VREG lattice — last dim in
      multiples of 128 lanes, second-minor in multiples of 8 (fp32) or 16
      (bf16) sublanes.  (The paper's analogue: SIMD width / NPU systolic
      geometry.)
    """

    contract_whole: bool = False
    contract_accumulate: bool = True
    lane_align: int = 128
    sublane_align: int = 8
    min_tile: int = 1               # performance constraint floor
    mxu_preferred: int = 128        # prefer tiles that feed full MXU blocks


@dataclasses.dataclass(frozen=True)
class OpNode:
    """One operator in a fusion group."""

    name: str
    kind: str                       # 'gemm' | 'elementwise' | 'reduce' | ...
    inputs: tuple[TensorSpec, ...]
    output: TensorSpec
    links: tuple[DimLink, ...]
    policy: KernelPolicy = KernelPolicy()
    # FLOPs per output element *per contraction element* for cost reporting.
    flops_per_macs: int = 2

    def contract_dims(self) -> tuple[str, ...]:
        seen: list[str] = []
        for l in self.links:
            if l.kind is LinkKind.CONTRACT and l.input_dim not in seen:
                seen.append(l.input_dim)
        return tuple(seen)

    def tensors(self) -> tuple[TensorSpec, ...]:
        return self.inputs + (self.output,)

    def flops(self, sizes: Mapping[str, int]) -> int:
        """Modeled FLOPs of this op at the given full dim sizes:
        output elements × contraction elements × ``flops_per_macs``
        (2 for a GEMM's multiply-accumulate, 1 for elementwise maps).
        This is the per-op compute term the planner's roofline objective
        and ``repro.roofline`` both price through ``Target.flops``."""
        n = self.flops_per_macs
        for d in self.output.dims:
            n *= sizes[d]
        for d in self.contract_dims():
            n *= sizes[d]
        return n


@dataclasses.dataclass(frozen=True)
class CollectiveNode(OpNode):
    """A mesh collective as a first-class op in the chain.

    ``comm`` is one of ``'all_gather'`` / ``'reduce_scatter'`` /
    ``'all_reduce'``; ``mesh_size`` the number of participating chips.
    The node carries zero FLOPs (``flops_per_macs=0`` — the per-element
    reduce adds are noise next to the link time) and its payload moves
    over the target's *interconnect* level's DMA port, so the cost model
    prices it on a port that overlaps the segment's memory traffic
    instead of folding it into compute or HBM time.

    Bytes on the wire follow the standard ring formulas over the tensor
    the shards reassemble into (``(N-1)/N ×`` the full payload per
    direction, doubled for all-reduce's reduce-scatter + all-gather
    phases); :meth:`comm_bytes` / :meth:`comm_transfers` evaluate them
    so `cost.evaluate` and the DES agree on the wire traffic."""

    comm: str = "all_reduce"
    mesh_size: int = 1

    def __post_init__(self):
        if self.comm not in ("all_gather", "reduce_scatter", "all_reduce"):
            raise ValueError(
                f"collective {self.name}: unknown comm {self.comm!r}")
        if self.mesh_size < 1:
            raise ValueError(
                f"collective {self.name}: mesh_size must be >= 1, got "
                f"{self.mesh_size}")

    def _payload(self, sizes: Mapping[str, int]) -> int:
        # all_gather reassembles its *output*; reduce_scatter and
        # all_reduce reduce over their full-size *input*.
        t = self.output if self.comm == "all_gather" else self.inputs[0]
        return t.bytes_full(sizes)

    def comm_bytes(self, sizes: Mapping[str, int]) -> int:
        """Bytes each chip moves over the link (ring algorithm)."""
        n = self.mesh_size
        if n <= 1:
            return 0
        phases = 2 if self.comm == "all_reduce" else 1
        return phases * self._payload(sizes) * (n - 1) // n

    def comm_transfers(self, sizes: Mapping[str, int]) -> int:
        """Link messages per chip: one per ring step (and phase)."""
        n = self.mesh_size
        if n <= 1:
            return 0
        phases = 2 if self.comm == "all_reduce" else 1
        return phases * (n - 1)


def collective(
    name: str,
    comm: str,
    x: TensorSpec,
    out: TensorSpec,
    mesh_size: int,
) -> CollectiveNode:
    """Build a :class:`CollectiveNode` ``out = comm(x)`` (same dims —
    the shard spec is carried by the *sizes* the capture shrank, so the
    planner's tiling constraints bind through plain EQ links)."""
    links = tuple(
        DimLink(x.name, d, LinkKind.EQ, d) for d in x.dims
    )
    return CollectiveNode(
        name=name,
        kind="collective",
        inputs=(x,),
        output=out,
        links=links,
        flops_per_macs=0,
        comm=comm,
        mesh_size=mesh_size,
    )


@dataclasses.dataclass
class FusionGroup:
    """A chain of ops being planned together (paper step 3 output).

    ``dims`` maps variable name -> Dim (full size).  ``tensors`` maps tensor
    name -> TensorSpec with the *post-binding* role (shared intermediates
    are Role.INTERMEDIATE).
    """

    name: str
    ops: list[OpNode]
    dims: dict[str, Dim]
    tensors: dict[str, TensorSpec]

    def dim_sizes(self) -> dict[str, int]:
        return {d.name: d.size for d in self.dims.values()}

    def hbm_tensors(self) -> list[TensorSpec]:
        return [
            t
            for t in self.tensors.values()
            if t.role in (Role.INPUT, Role.WEIGHT, Role.OUTPUT)
        ]

    def intermediate_tensors(self) -> list[TensorSpec]:
        return [
            t for t in self.tensors.values() if t.role is Role.INTERMEDIATE
        ]

    def validate(self) -> None:
        for op in self.ops:
            for t in op.tensors():
                for d in t.dims:
                    if d not in self.dims:
                        raise ValueError(
                            f"op {op.name}: tensor {t.name} uses unknown dim {d}"
                        )
        # Each intermediate must be produced exactly once and consumed >= once.
        produced = {op.output.name for op in self.ops}
        for t in self.intermediate_tensors():
            if t.name not in produced:
                raise ValueError(f"intermediate {t.name} never produced")

    def total_macs(self) -> int:
        """MAC count of the whole group (for utilization reporting)."""
        total = 0
        sizes = self.dim_sizes()
        for op in self.ops:
            if op.kind != "gemm":
                continue
            n = 1
            for d in op.output.dims:
                n *= sizes[d]
            for d in op.contract_dims():
                n *= sizes[d]
            total += n
        return total

    def total_flops(self) -> int:
        """Modeled FLOPs of the whole group: Σ_op ``op.flops`` — GEMMs at
        2 FLOPs/MAC, elementwise ops at 1 FLOP/element.  Partition-
        invariant over a chain (fusion never changes the arithmetic), so
        the DP's compute term differs between partitions only through
        each segment's max() against its own transfer time."""
        sizes = self.dim_sizes()
        return sum(op.flops(sizes) for op in self.ops)


# ---------------------------------------------------------------------------
# Builders for the op kinds the model zoo uses.
# ---------------------------------------------------------------------------

def gemm(
    name: str,
    x: TensorSpec,
    w: TensorSpec,
    out: TensorSpec,
    contract: str,
    policy: KernelPolicy | None = None,
) -> OpNode:
    """out[M.., N] = sum_K x[M.., K] * w[K, N]  (row-major conventions)."""
    links = []
    for d in x.dims:
        if d == contract:
            links.append(DimLink(x.name, d, LinkKind.CONTRACT))
        else:
            links.append(DimLink(x.name, d, LinkKind.EQ, d))
    for d in w.dims:
        if d == contract:
            links.append(DimLink(w.name, d, LinkKind.CONTRACT))
        else:
            links.append(DimLink(w.name, d, LinkKind.EQ, d))
    return OpNode(
        name=name,
        kind="gemm",
        inputs=(x, w),
        output=out,
        links=tuple(links),
        policy=policy or KernelPolicy(),
    )


def elementwise(
    name: str,
    inputs: Sequence[TensorSpec],
    out: TensorSpec,
    policy: KernelPolicy | None = None,
) -> OpNode:
    links = []
    for t in inputs:
        for d in t.dims:
            links.append(DimLink(t.name, d, LinkKind.EQ, d))
    return OpNode(
        name=name,
        kind="elementwise",
        inputs=tuple(inputs),
        output=out,
        links=tuple(links),
        policy=policy or KernelPolicy(),
        flops_per_macs=1,
    )


def aligned_divisors(n: int, align: int, *, include_full: bool = True) -> list[int]:
    """Candidate tile sizes for a dim of size ``n``: divisors of n that are
    multiples of ``align`` (or equal to n itself — a whole dim never needs
    alignment since there is no partial tile)."""
    cands = set()
    for d in range(1, int(math.isqrt(n)) + 1):
        if n % d == 0:
            for c in (d, n // d):
                if c % align == 0 or c == n:
                    cands.add(c)
    if include_full:
        cands.add(n)
    if not cands:
        # dim smaller than alignment: only the whole dim is legal.
        cands.add(n)
    return sorted(cands)
