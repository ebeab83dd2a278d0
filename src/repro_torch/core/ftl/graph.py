"""Graph-level op capture (paper step 3, generalized to whole blocks).

The seed planned three hand-built chains (MLP, attention, gemm_chain) with
per-chain entry points.  This module is the single capture layer above
them: an :class:`OpGraph` is a topologically ordered *op chain* over the
existing :class:`~repro_torch.core.ftl.ir.OpNode` IR, lowered from any model in
the config zoo.  The fusion-partition optimizer (``partition.py``) then
chooses where to cut the chain; each contiguous segment becomes one
:class:`~repro_torch.core.ftl.ir.FusionGroup` solved by the branch-and-bound
tile solver.

Two pieces of structure beyond a bare op list:

* ``repeats`` — per-op multiplicity.  The attention core (QKᵀ → softmax →
  ·V) is captured per head and planned once; its segment traffic/DMA
  scale by ``n_heads`` while its VMEM footprint does not (heads are an
  outer grid loop).
* ``barriers`` — chain positions where a cut is mandatory: head-split /
  head-merge reshapes (the tiling model cannot fuse through a layout
  change) and any position where the repeat factor changes.  They are
  derived automatically from ``repeats`` plus explicit reshape marks.

``block_graph`` lowers a full transformer block — QKV projections,
per-head attention core, output projection, and the (gated or plain) MLP
with an optional residual epilogue — from any ``configs/*`` entry.  The
output projection and the MLP live in the same token space with no
barrier between them, so the partitioner is free to fuse across the
attention/MLP boundary: a schedule no per-chain planner could express.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from . import fusion
from .fusion import GEMM_POLICY, HEADDIM_WHOLE
from .ir import (
    CollectiveNode,
    Dim,
    FusionGroup,
    OpNode,
    Role,
    TensorSpec,
    collective,
    elementwise,
    gemm,
)

__all__ = [
    "CollectiveNode", "OpGraph", "attention_graph", "block_graph",
    "collective", "gemm_act_graph", "gemm_chain_graph", "mlp_graph",
]


@dataclasses.dataclass(frozen=True)
class OpGraph:
    """An op chain ready for fusion partitioning.

    ``ops`` are in topological (execution) order.  ``repeats[i]`` is the
    multiplicity of ``ops[i]`` (1 for token-space ops, ``n_heads`` for the
    per-head attention core).  ``barriers`` are the cut positions
    ``1 <= b < len(ops)`` where a segment boundary is mandatory.
    """

    name: str
    ops: tuple[OpNode, ...]
    dims: tuple[Dim, ...]
    repeats: tuple[int, ...] = ()
    barriers: frozenset[int] = frozenset()

    def __post_init__(self):
        if not self.ops:
            raise ValueError(f"graph {self.name}: empty op chain")
        if not self.repeats:
            object.__setattr__(self, "repeats", (1,) * len(self.ops))
        if len(self.repeats) != len(self.ops):
            raise ValueError(
                f"graph {self.name}: {len(self.repeats)} repeats for "
                f"{len(self.ops)} ops"
            )
        # a repeat change is always a layout boundary -> mandatory cut
        derived = {
            i
            for i in range(1, len(self.ops))
            if self.repeats[i] != self.repeats[i - 1]
        }
        object.__setattr__(self, "barriers", frozenset(self.barriers) | derived)

    # ------------------------------------------------------------------
    @property
    def n_ops(self) -> int:
        return len(self.ops)

    def dim_map(self) -> dict[str, Dim]:
        return {d.name: d for d in self.dims}

    def total_flops(self) -> int:
        """Modeled FLOPs of the whole chain, multiplicity included:
        Σ_i repeats[i] · ops[i].flops.  Partition-invariant — every
        partition of this graph runs exactly this much arithmetic, so
        chains only differ in how much of it each segment's transfer
        time hides."""
        sizes = {d.name: d.size for d in self.dims}
        return sum(r * op.flops(sizes)
                   for r, op in zip(self.repeats, self.ops))

    def repeat(self, lo: int, hi: int) -> int:
        """Uniform multiplicity of segment ``ops[lo:hi]``."""
        reps = set(self.repeats[lo:hi])
        if len(reps) != 1:
            raise ValueError(
                f"graph {self.name}: segment [{lo}, {hi}) mixes repeats {reps}"
            )
        return reps.pop()

    def crosses_barrier(self, lo: int, hi: int) -> bool:
        return any(lo < b < hi for b in self.barriers)

    # ------------------------------------------------------------------
    def group(self, lo: int, hi: int) -> FusionGroup:
        """Bind ``ops[lo:hi]`` into one :class:`FusionGroup`.

        Role rebinding generalizes ``fusion._collect``: a tensor produced
        and consumed inside the segment is fused away (INTERMEDIATE); one
        produced inside but consumed later (or never) streams out
        (OUTPUT); one consumed but produced in an earlier segment streams
        in (INPUT).  Weights stay WEIGHT.
        """
        if not (0 <= lo < hi <= self.n_ops):
            raise ValueError(f"bad segment [{lo}, {hi})")
        if self.crosses_barrier(lo, hi):
            raise ValueError(
                f"graph {self.name}: segment [{lo}, {hi}) spans a barrier"
            )
        seg = self.ops[lo:hi]
        produced = {op.output.name for op in seg}
        consumed = {t.name for op in seg for t in op.inputs}
        # a tensor read by any op outside the segment must still stream to
        # HBM even if a consumer inside the segment exists — only tensors
        # whose every consumer is inside the segment fuse away
        consumed_outside = {
            t.name
            for op in self.ops[:lo] + self.ops[hi:]
            for t in op.inputs
        }
        tensors: dict[str, TensorSpec] = {}
        for op in seg:
            for t in op.tensors():
                if (t.name in produced and t.name in consumed
                        and t.name not in consumed_outside):
                    t = dataclasses.replace(t, role=Role.INTERMEDIATE)
                elif t.name in produced:
                    t = dataclasses.replace(t, role=Role.OUTPUT)
                elif t.role is not Role.WEIGHT:
                    t = dataclasses.replace(t, role=Role.INPUT)
                tensors[t.name] = t
        used = {d for op in seg for t in op.tensors() for d in t.dims}
        dim_map = {k: v for k, v in self.dim_map().items() if k in used}
        name = self.name if (lo, hi) == (0, self.n_ops) else (
            f"{self.name}[{lo}:{hi}]"
        )
        g = FusionGroup(name=name, ops=list(seg), dims=dim_map,
                        tensors=tensors)
        g.validate()
        return g

    def validate(self) -> None:
        """Chain sanity: dims known, producers precede consumers."""
        known = {d.name for d in self.dims}
        all_outputs = {op.output.name for op in self.ops}
        seen_outputs: set[str] = set()
        for op in self.ops:
            for t in op.tensors():
                for d in t.dims:
                    if d not in known:
                        raise ValueError(
                            f"graph {self.name}: op {op.name} uses unknown "
                            f"dim {d}"
                        )
            for t in op.inputs:
                # inputs produced inside the chain must come from an
                # earlier op; anything else is an external tensor
                if t.name in all_outputs and t.name not in seen_outputs:
                    raise ValueError(
                        f"graph {self.name}: op {op.name} consumes "
                        f"{t.name} before it is produced"
                    )
            seen_outputs.add(op.output.name)


# ---------------------------------------------------------------------------
# chain capture: the hand-built chains, now as graphs
# ---------------------------------------------------------------------------

def mlp_graph(
    *,
    m: int,
    d_model: int,
    d_ff: int,
    dtype: str = "bfloat16",
    gated: bool = False,
    act: str = "gelu",
    residual: bool = False,
    name: str = "mlp",
) -> OpGraph:
    """Transformer MLP as an op chain; optional residual-add epilogue."""
    ops, dims = fusion.mlp_ops(m=m, d_model=d_model, d_ff=d_ff, dtype=dtype,
                               gated=gated, act=act)
    if residual:
        res = TensorSpec("res", ("M", "N"), dtype, Role.INPUT)
        out = TensorSpec("y_res", ("M", "N"), dtype, Role.OUTPUT)
        ops.append(elementwise("residual", [ops[-1].output, res], out))
    return OpGraph(name=name, ops=tuple(ops), dims=tuple(dims))


def gemm_act_graph(
    *, m: int, k: int, n: int, dtype: str = "bfloat16", act: str = "gelu",
    name: str = "gemm_act",
) -> OpGraph:
    """The paper's ViT-MLP benchmark chain: GEMM → activation."""
    ops, dims = fusion.gemm_act_ops(m=m, k=k, n=n, dtype=dtype, act=act)
    return OpGraph(name=name, ops=tuple(ops), dims=tuple(dims))


def attention_graph(
    *, q_len: int, kv_len: int, head_dim: int, dtype: str = "bfloat16",
    heads: int = 1, name: str = "attention",
) -> OpGraph:
    """One-head attention core chain (multiplicity ``heads``)."""
    ops, dims = fusion.attention_ops(q_len=q_len, kv_len=kv_len,
                                     head_dim=head_dim, dtype=dtype)
    return OpGraph(name=name, ops=tuple(ops), dims=tuple(dims),
                   repeats=(heads,) * len(ops))


def gemm_chain_graph(
    *, m: int, dims_kn: Sequence[int], dtype: str = "bfloat16",
    name: str = "gemm_chain",
) -> OpGraph:
    """Generic back-to-back GEMM chain."""
    ops, dims = fusion.gemm_chain_ops(m=m, dims_kn=dims_kn, dtype=dtype)
    return OpGraph(name=name, ops=tuple(ops), dims=tuple(dims))


# ---------------------------------------------------------------------------
# whole-block capture from a ModelConfig
# ---------------------------------------------------------------------------

def block_graph(
    cfg,
    *,
    m: int,
    dtype: str | None = None,
    residual: bool = True,
    name: str | None = None,
) -> OpGraph:
    """Lower one transformer block of ``cfg`` into a single op chain.

    Chain: QKV projections → [barrier] → per-head attention core
    (repeat = n_heads) → [barrier] → output projection → MLP (gated or
    plain, per-expert dims for MoE) → optional residual epilogue.

    Barriers sit at the head-split/head-merge reshapes; everything in
    token space (projections, MLP) is fair game for the partitioner,
    including fusing the output projection into the MLP up-GEMM.

    Families without a standard attention block (``ssm``) lower only the
    MLP part; configs with neither attention nor an MLP raise
    ``ValueError``.
    """
    dt = dtype or cfg.dtype
    d = cfg.d_model
    if cfg.is_moe:
        d_ff, gated = cfg.moe_d_ff, cfg.mlp_gated
    else:
        d_ff, gated = cfg.d_ff, cfg.mlp_gated
    has_attn = cfg.block_kind(0) in ("attn", "cross", "local")
    has_mlp = d_ff > 0

    ops: list[OpNode] = []
    repeats: list[int] = []
    dims: list[Dim] = []
    mlp_in: TensorSpec | None = None

    if has_attn:
        h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        dims += [
            Dim("M", m), Dim("K", d), Dim("DQ", h * dh), Dim("DKV", hk * dh),
            Dim("Tk", m), Dim("Dh", dh), Dim("O", h * dh), Dim("N", d),
        ]
        x = TensorSpec("x", ("M", "K"), dt, Role.INPUT)
        wq = TensorSpec("wq", ("K", "DQ"), dt, Role.WEIGHT)
        wk = TensorSpec("wk", ("K", "DKV"), dt, Role.WEIGHT)
        wv = TensorSpec("wv", ("K", "DKV"), dt, Role.WEIGHT)
        q = TensorSpec("q", ("M", "DQ"), dt, Role.OUTPUT)
        kp = TensorSpec("k_proj", ("M", "DKV"), dt, Role.OUTPUT)
        vp = TensorSpec("v_proj", ("M", "DKV"), dt, Role.OUTPUT)
        ops += [
            gemm("proj.wq", x, wq, q, contract="K", policy=GEMM_POLICY),
            gemm("proj.wk", x, wk, kp, contract="K", policy=GEMM_POLICY),
            gemm("proj.wv", x, wv, vp, contract="K", policy=GEMM_POLICY),
        ]
        repeats += [1, 1, 1]
        # --- head-split reshape boundary; the core is planned per head ----
        qh = TensorSpec("q_head", ("M", "Dh"), dt, Role.INPUT)
        kh = TensorSpec("k_head", ("Tk", "Dh"), dt, Role.INPUT)
        vh = TensorSpec("v_head", ("Tk", "Dh"), dt, Role.INPUT)
        s = TensorSpec("s", ("M", "Tk"), "float32", Role.OUTPUT)
        p = TensorSpec("p", ("M", "Tk"), dt, Role.OUTPUT)
        oh = TensorSpec("o_head", ("M", "Dh"), dt, Role.OUTPUT)
        ops += [
            gemm("attn.qk", qh, kh, s, contract="Dh", policy=HEADDIM_WHOLE),
            elementwise("attn.softmax", [s], p),
            gemm("attn.pv", p, vh, oh, contract="Tk", policy=GEMM_POLICY),
        ]
        repeats += [h, h, h]
        # --- head-merge reshape boundary; back to token space -------------
        o = TensorSpec("o", ("M", "O"), dt, Role.INPUT)
        wo = TensorSpec("wo", ("O", "N"), dt, Role.WEIGHT)
        ao = TensorSpec("attn_out", ("M", "N"), dt, Role.OUTPUT)
        ops.append(gemm("proj.wo", o, wo, ao, contract="O",
                        policy=GEMM_POLICY))
        repeats.append(1)
        mlp_in = ao
    elif has_mlp:
        dims += [Dim("M", m), Dim("N", d)]
        mlp_in = TensorSpec("x", ("M", "N"), dt, Role.INPUT)

    if has_mlp:
        dims += [Dim("F", d_ff), Dim("N2", d)]
        w1 = TensorSpec("w1", ("N", "F"), dt, Role.WEIGHT)
        w2 = TensorSpec("w2", ("F", "N2"), dt, Role.WEIGHT)
        h1 = TensorSpec("mlp_h1", ("M", "F"), dt, Role.OUTPUT)
        hmid = TensorSpec("mlp_h", ("M", "F"), dt, Role.OUTPUT)
        y = TensorSpec("mlp_y", ("M", "N2"), dt, Role.OUTPUT)
        ops.append(gemm("mlp.gemm1", mlp_in, w1, h1, contract="N",
                        policy=GEMM_POLICY))
        repeats.append(1)
        if gated:
            wg = TensorSpec("wg", ("N", "F"), dt, Role.WEIGHT)
            hg = TensorSpec("mlp_hg", ("M", "F"), dt, Role.OUTPUT)
            ops.append(gemm("mlp.gemm_gate", mlp_in, wg, hg, contract="N",
                            policy=GEMM_POLICY))
            ops.append(elementwise(f"mlp.{cfg.mlp_act}_mul", [h1, hg], hmid))
            repeats += [1, 1]
        else:
            ops.append(elementwise(f"mlp.{cfg.mlp_act}", [h1], hmid))
            repeats.append(1)
        ops.append(gemm("mlp.gemm2", hmid, w2, y, contract="F",
                        policy=GEMM_POLICY))
        repeats.append(1)
        if residual:
            res = TensorSpec("res", ("M", "N2"), dt, Role.INPUT)
            out = TensorSpec("block_out", ("M", "N2"), dt, Role.OUTPUT)
            ops.append(elementwise("mlp.residual", [y, res], out))
            repeats.append(1)

    if not ops:
        raise ValueError(
            f"config {cfg.name}: no plannable block (no attention, no MLP)"
        )
    g = OpGraph(name=name or f"block.{cfg.name}", ops=tuple(ops),
                dims=tuple(dims), repeats=tuple(repeats))
    g.validate()
    return g
