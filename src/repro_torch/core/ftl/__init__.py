"""Fused-Tiled Layers (FTL) planner of the port.

The planning modules (``ir``, ``constraints``, ``fusion``, ``graph``,
``cost``, ``solver``, ``plan``, ``partition``) are the reference
``repro.core.ftl``'s, with only their imports rewritten: on the same
target they produce the same cuts, tiles, traffic and modeled runtime.
``registry`` binds planned groups to the port's executors (the CUDA
kernels on the card, ``torch_*`` loops elsewhere), ``executor_block`` runs
a whole planned block and ``executor_xla`` holds the portable loops.
"""
from __future__ import annotations

from repro_torch.core.hw import MemoryLevel, Target, default_target, \
    get_target

from . import (constraints, cost, executor_block, executor_xla,
               fusion, graph, ir, partition, plan, registry, solver)
from .constraints import build_dim_constraints
from .cost import CostReport, evaluate
from .fusion import attention, gemm_act, gemm_chain, mlp
from .graph import OpGraph, attention_graph, block_graph, gemm_act_graph, \
    gemm_chain_graph, mlp_graph
from .ir import Dim, FusionGroup, KernelPolicy, OpNode, Role, TensorSpec
from .partition import ChainPlan, Segment, all_cuts, plan_chain, plan_fixed
from .plan import FusionComparison, TilePlan, compare
from .registry import BlockPlan, ExecContext, Executor, \
    clear_plan_caches, mlp_executor, plan_block, plan_cache_stats, \
    register_plan_cache, run_block
from .solver import InfeasibleError, solve

__all__ = [
    "Dim", "FusionGroup", "KernelPolicy", "OpNode", "Role", "TensorSpec",
    "CostReport", "TilePlan", "FusionComparison",
    "MemoryLevel", "Target", "default_target", "get_target",
    "attention", "gemm_act", "gemm_chain", "mlp",
    "OpGraph", "attention_graph", "block_graph", "gemm_act_graph",
    "gemm_chain_graph", "mlp_graph",
    "ChainPlan", "Segment", "all_cuts", "plan_chain", "plan_fixed",
    "BlockPlan", "ExecContext", "Executor", "mlp_executor", "plan_block",
    "run_block",
    "plan_cache_stats", "clear_plan_caches", "register_plan_cache",
    "build_dim_constraints", "evaluate", "solve", "compare",
    "InfeasibleError",
    "constraints", "cost", "executor_block", "executor_xla",
    "fusion", "graph", "ir", "partition", "plan", "registry", "solver",
]
