"""Capture a tensor-parallel-sharded transformer block as an OpGraph
with first-class collectives — the bridge from the runtime sharding
rules (``distributed/sharding.py``) into the FTL planning stack.  The
port's copy of ``repro.distributed.mesh_capture``, over the port's
planner, with only its imports rewritten.

``capture_block(cfg, m=..., mesh_size=N)`` lowers the per-chip slice of
one block under the repo's Megatron-style tensor-parallel layout and
inserts :class:`~repro_torch.core.ftl.ir.CollectiveNode`\\s where the layout
requires communication, so the fusion-partition DP prices "fuse and
overlap the all-reduce with this segment's memory traffic" against "cut
here and materialize first" on the real max-over-ports transfer model.

The shard layout mirrors ``sharding._param_spec`` /
``sharding.make_activation_policy`` exactly (this module needs no
devices and no process group):

* attention heads shard over the mesh when divisible (``heads_q`` /
  ``heads_kv`` activation rule): wq/wk/wv are column-parallel, the
  per-head core runs ``n_heads/N`` heads, and the row-parallel ``wo``
  leaves a partial sum → **all_reduce** on ``attn_out``;
* the MLP hidden ``d_ff`` shards when divisible (``ffn_hidden`` rule):
  w1/wg column-parallel, the row-parallel ``w2`` leaves a partial sum
  → **all_reduce** on ``mlp_y``;
* everything else (token dim, ``d_model``) is replicated, matching
  ``_div``'s shard-only-when-divisible rule.

``mesh_size=1`` (or a config nothing divides) returns the plain
``graph.block_graph`` capture bit-identically — single-chip plans are
untouched.

``strip_collectives`` / ``plan_collective_blind`` give the baseline the
benchmarks gate against: plan the same per-chip graph with the
collectives invisible, then re-price the chosen cuts on the full graph
— the cost of partitioning as if communication were free.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import hw as hwlib
from repro_torch.core.ftl import graph as graphlib
from repro_torch.core.ftl import ir, partition
from repro_torch.core.ftl.graph import OpGraph


@dataclasses.dataclass(frozen=True)
class BlockShardSpec:
    """Which block dims a ``mesh_size``-way tensor-parallel layout
    shards for a given config — the divisibility decisions of
    ``sharding._div`` restated for the planner."""

    mesh_size: int
    heads: bool          # q/kv heads shard over the mesh
    d_ff: bool           # MLP hidden shards over the mesh

    @property
    def any(self) -> bool:
        return self.mesh_size > 1 and (self.heads or self.d_ff)


def shard_spec(cfg, mesh_size: int) -> BlockShardSpec:
    """The tensor-parallel shard decisions for ``cfg`` at ``mesh_size``:
    a dim shards iff the mesh divides it (``sharding._div``), heads only
    when *both* query and kv head counts divide (GQA groups must not be
    split across chips)."""
    if mesh_size < 1:
        raise ValueError(f"mesh_size must be >= 1, got {mesh_size}")
    has_attn = cfg.block_kind(0) in ("attn", "cross", "local")
    d_ff = cfg.moe_d_ff if cfg.is_moe else cfg.d_ff
    heads = bool(
        has_attn and mesh_size > 1
        and cfg.n_heads % mesh_size == 0
        and cfg.n_kv_heads % mesh_size == 0
    )
    ff = bool(mesh_size > 1 and d_ff > 0 and d_ff % mesh_size == 0)
    return BlockShardSpec(mesh_size=mesh_size, heads=heads, d_ff=ff)


def _insert_collective_after(
    g: OpGraph, op_name: str, comm: str, mesh_size: int
) -> OpGraph:
    """Splice ``comm(output of op_name)`` into the chain right after the
    named op, rewiring every later consumer (inputs *and* dim links) to
    the collective's output tensor."""
    idx = next(i for i, op in enumerate(g.ops) if op.name == op_name)
    t_in = g.ops[idx].output
    t_out = dataclasses.replace(t_in, name=t_in.name + "_red")
    node = ir.collective(
        f"comm.{op_name}", comm, t_in, t_out, mesh_size)
    ops = list(g.ops)
    reps = list(g.repeats)
    ops.insert(idx + 1, node)
    reps.insert(idx + 1, reps[idx])
    for j in range(idx + 2, len(ops)):
        op = ops[j]
        if not any(t.name == t_in.name for t in op.inputs):
            continue
        ops[j] = dataclasses.replace(
            op,
            inputs=tuple(t_out if t.name == t_in.name else t
                         for t in op.inputs),
            links=tuple(
                dataclasses.replace(l, input_tensor=t_out.name)
                if l.input_tensor == t_in.name else l
                for l in op.links),
        )
    # barriers re-derive from the repeats in __post_init__; the stale
    # pre-splice indices must not survive the replace
    return dataclasses.replace(
        g, ops=tuple(ops), repeats=tuple(reps), barriers=frozenset())


def capture_block(
    cfg,
    *,
    m: int,
    mesh_size: int = 1,
    dtype: str | None = None,
    residual: bool = True,
    name: str | None = None,
) -> OpGraph:
    """Lower the per-chip slice of one block of ``cfg`` under a
    ``mesh_size``-way tensor-parallel layout, collectives included.

    The returned graph's dims are the *local* shard sizes (``n_heads/N``
    heads, ``d_ff/N`` hidden) — exactly the tensors one chip touches —
    and the two row-parallel partial sums carry an ``all_reduce``
    CollectiveNode whose ring-formula wire bytes the cost model prices
    on the target's interconnect port.  ``mesh_size=1`` returns the
    plain single-chip ``block_graph`` unchanged.
    """
    spec = shard_spec(cfg, mesh_size)
    if not spec.any:
        return graphlib.block_graph(
            cfg, m=m, dtype=dtype, residual=residual, name=name)
    # pin head_dim before shrinking n_heads: resolved_head_dim defaults
    # to d_model // n_heads and must not double under the shard
    repl: dict = {"head_dim": cfg.resolved_head_dim}
    if spec.heads:
        repl["n_heads"] = cfg.n_heads // mesh_size
        repl["n_kv_heads"] = cfg.n_kv_heads // mesh_size
    if spec.d_ff:
        if cfg.is_moe:
            repl["moe_d_ff"] = cfg.moe_d_ff // mesh_size
        else:
            repl["d_ff"] = cfg.d_ff // mesh_size
    local = dataclasses.replace(cfg, **repl)
    g = graphlib.block_graph(
        local, m=m, dtype=dtype, residual=residual,
        name=name or f"mesh{mesh_size}.block.{cfg.name}")
    if spec.heads:
        g = _insert_collective_after(g, "proj.wo", "all_reduce", mesh_size)
    if spec.d_ff and any(op.name == "mlp.gemm2" for op in g.ops):
        g = _insert_collective_after(g, "mlp.gemm2", "all_reduce", mesh_size)
    g.validate()
    return g


# ---------------------------------------------------------------------------
# collective-blind baseline
# ---------------------------------------------------------------------------

def strip_collectives(g: OpGraph) -> OpGraph:
    """``g`` with every CollectiveNode removed and its consumers rewired
    back to the collective's operand — the chain a collective-blind
    partitioner sees."""
    rename: dict[str, ir.TensorSpec] = {}
    ops: list[ir.OpNode] = []
    reps: list[int] = []
    for op, r in zip(g.ops, g.repeats):
        if isinstance(op, ir.CollectiveNode):
            src = op.inputs[0]
            rename[op.output.name] = rename.get(src.name, src)
            continue
        if any(t.name in rename for t in op.inputs):
            op = dataclasses.replace(
                op,
                inputs=tuple(rename.get(t.name, t) for t in op.inputs),
                links=tuple(
                    dataclasses.replace(
                        l, input_tensor=rename[l.input_tensor].name)
                    if l.input_tensor in rename else l
                    for l in op.links),
            )
        ops.append(op)
        reps.append(r)
    if len(ops) == len(g.ops):
        return g
    return dataclasses.replace(
        g, name=g.name + ".blind", ops=tuple(ops), repeats=tuple(reps),
        barriers=frozenset())


def map_cuts(full: OpGraph, stripped: OpGraph,
             cuts: tuple[int, ...]) -> tuple[int, ...]:
    """Translate cut positions of the collective-stripped chain onto the
    full chain.  A cut before stripped op ``p`` lands before the same op
    in the full chain, so any collective sitting between two stripped
    ops stays attached to the *preceding* segment (where its producer
    ran)."""
    full_idx = [i for i, op in enumerate(full.ops)
                if not isinstance(op, ir.CollectiveNode)]
    if len(full_idx) != stripped.n_ops:
        raise ValueError(
            f"stripped graph {stripped.name} does not match {full.name}")
    return tuple(full_idx[c] for c in cuts)


def plan_collective_blind(
    graph: OpGraph,
    *,
    target: hwlib.Target | None = None,
) -> partition.ChainPlan:
    """Partition ``graph`` as if its collectives were free — plan the
    stripped chain, then re-price the chosen cuts on the real graph.
    This is the baseline the mesh benchmarks gate the collective-aware
    DP against: same machine, same collectives, only the cut decisions
    made blind."""
    target = target if target is not None else hwlib.default_target()
    stripped = strip_collectives(graph)
    if stripped is graph:
        return partition.plan_chain(graph, target=target)
    blind = partition.plan_chain(stripped, target=target)
    cuts = map_cuts(graph, stripped, blind.cuts())
    return partition.plan_fixed(graph, cuts, target=target)
