"""FTL fusion-group construction (paper step 3).

``make_group`` performs the paper's *binding*: ops are written against
shared dim names; any tensor produced by one op and consumed by another
inside the group is re-classed ``INTERMEDIATE`` (fused away — zero HBM
traffic, single VMEM buffer).  With ``fuse=False`` the same chain is split
into one group per op, producer outputs / consumer inputs stay in HBM —
the layer-per-layer baseline the paper compares against.

Builders cover the layer chains our model zoo plans:

* ``gemm_act``    — the paper's exact ViT-MLP benchmark (GEMM → GeLU)
* ``mlp``         — full MLP: GEMM → act [⊙ gate GEMM] → GEMM
* ``attention``   — fused-tiled QKᵀ → softmax → ·V (flash-style)
* ``gemm_chain``  — generic back-to-back GEMMs
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from .ir import (
    Dim,
    FusionGroup,
    KernelPolicy,
    OpNode,
    Role,
    TensorSpec,
    elementwise,
    gemm,
)

# Policies -----------------------------------------------------------------
# GEMMs on the MXU accumulate fine in fp32 scratch -> contraction may tile.
GEMM_POLICY = KernelPolicy(contract_accumulate=True, min_tile=8)
# The flash-attention inner GEMM row-softmax needs whole head_dim.
HEADDIM_WHOLE = KernelPolicy(contract_whole=True)


def _collect(
    name: str, ops: Sequence[OpNode], dims: Sequence[Dim], fuse: bool
) -> FusionGroup | list[FusionGroup]:
    dim_map = {d.name: d for d in dims}
    if fuse:
        produced = {op.output.name: op.output for op in ops}
        consumed = {t.name for op in ops for t in op.inputs}
        tensors: dict[str, TensorSpec] = {}
        for op in ops:
            for t in op.tensors():
                if t.name in produced and t.name in consumed:
                    t = dataclasses.replace(t, role=Role.INTERMEDIATE)
                elif t.name in produced:
                    t = dataclasses.replace(t, role=Role.OUTPUT)
                tensors[t.name] = t
        g = FusionGroup(name=name, ops=list(ops), dims=dim_map, tensors=tensors)
        g.validate()
        return g
    groups = []
    for op in ops:
        tensors = {}
        for t in op.inputs:
            # In the layer-per-layer schedule every op input streams from HBM.
            role = Role.WEIGHT if t.role is Role.WEIGHT else Role.INPUT
            tensors[t.name] = dataclasses.replace(t, role=role)
        tensors[op.output.name] = dataclasses.replace(
            op.output, role=Role.OUTPUT
        )
        used = {d for t in op.tensors() for d in t.dims}
        g = FusionGroup(
            name=f"{name}.{op.name}",
            ops=[op],
            dims={k: v for k, v in dim_map.items() if k in used},
            tensors=tensors,
        )
        g.validate()
        groups.append(g)
    return groups


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------

def gemm_act_ops(
    *, m: int, k: int, n: int, dtype: str = "bfloat16", act: str = "gelu",
) -> tuple[list[OpNode], list[Dim]]:
    """Raw op chain of the paper's ViT-MLP benchmark (see :func:`gemm_act`)."""
    dims = [Dim("M", m), Dim("K", k), Dim("F", n)]
    x = TensorSpec("x", ("M", "K"), dtype, Role.INPUT)
    w1 = TensorSpec("w1", ("K", "F"), dtype, Role.WEIGHT)
    h_raw = TensorSpec("h_raw", ("M", "F"), dtype, Role.OUTPUT)
    h = TensorSpec("h", ("M", "F"), dtype, Role.OUTPUT)
    ops = [
        gemm("gemm1", x, w1, h_raw, contract="K", policy=GEMM_POLICY),
        elementwise(act, [h_raw], h),
    ]
    return ops, dims


def gemm_act(
    *,
    m: int,
    k: int,
    n: int,
    dtype: str = "bfloat16",
    act: str = "gelu",
    fuse: bool = True,
    name: str = "gemm_act",
):
    """The paper's ViT-MLP benchmark: ``H = act(X @ W1)``."""
    ops, dims = gemm_act_ops(m=m, k=k, n=n, dtype=dtype, act=act)
    return _collect(name, ops, dims, fuse)


def mlp_ops(
    *,
    m: int,
    d_model: int,
    d_ff: int,
    dtype: str = "bfloat16",
    gated: bool = False,
    act: str = "gelu",
) -> tuple[list[OpNode], list[Dim]]:
    """Raw op chain of the full transformer MLP (see :func:`mlp`)."""
    dims = [Dim("M", m), Dim("K", d_model), Dim("F", d_ff), Dim("N", d_model)]
    x = TensorSpec("x", ("M", "K"), dtype, Role.INPUT)
    w1 = TensorSpec("w1", ("K", "F"), dtype, Role.WEIGHT)
    w2 = TensorSpec("w2", ("F", "N"), dtype, Role.WEIGHT)
    h1 = TensorSpec("h1", ("M", "F"), dtype, Role.OUTPUT)
    h = TensorSpec("h", ("M", "F"), dtype, Role.OUTPUT)
    y = TensorSpec("y", ("M", "N"), dtype, Role.OUTPUT)
    ops = [gemm("gemm1", x, w1, h1, contract="K", policy=GEMM_POLICY)]
    if gated:
        wg = TensorSpec("wg", ("K", "F"), dtype, Role.WEIGHT)
        hg = TensorSpec("hg", ("M", "F"), dtype, Role.OUTPUT)
        ops.append(gemm("gemm_gate", x, wg, hg, contract="K", policy=GEMM_POLICY))
        ops.append(elementwise(f"{act}_mul", [h1, hg], h))
    else:
        ops.append(elementwise(act, [h1], h))
    ops.append(gemm("gemm2", h, w2, y, contract="F", policy=GEMM_POLICY))
    return ops, dims


def mlp(
    *,
    m: int,
    d_model: int,
    d_ff: int,
    dtype: str = "bfloat16",
    gated: bool = False,
    act: str = "gelu",
    fuse: bool = True,
    name: str = "mlp",
):
    """Full transformer MLP: ``Y = act(X@W1)[⊙ (X@Wg)] @ W2``.

    Fused, the (M, d_ff) intermediate(s) never reach HBM — the exact
    failure mode the paper showcases (intermediate exceeding L2 → L3 spill;
    here: huge HBM round-trips at long sequence length).
    """
    ops, dims = mlp_ops(m=m, d_model=d_model, d_ff=d_ff, dtype=dtype,
                        gated=gated, act=act)
    return _collect(name, ops, dims, fuse)


def mlp_partial(
    *,
    m: int,
    d_model: int,
    d_ff: int,
    dtype: str = "bfloat16",
    gated: bool = False,
    act: str = "gelu",
    name: str = "mlp_partial",
) -> list[FusionGroup]:
    """Partial fusion: [GEMM1+act(+gate) fused] + [GEMM2 separate].

    The beyond-paper middle schedule: the activation epilogue fuses for
    free (the paper's exact benchmark), while the hidden tensor IS
    materialized once so GEMM2's tiling is unconstrained by GEMM1's —
    wins when joint tiling of both GEMMs would force weight revisits
    (qwen2-72b-class dims at 96 MiB VMEM, see bench_tpu_mlp).
    """
    dims1 = [Dim("M", m), Dim("K", d_model), Dim("F", d_ff)]
    x = TensorSpec("x", ("M", "K"), dtype, Role.INPUT)
    w1 = TensorSpec("w1", ("K", "F"), dtype, Role.WEIGHT)
    h1 = TensorSpec("h1", ("M", "F"), dtype, Role.OUTPUT)
    h = TensorSpec("h", ("M", "F"), dtype, Role.OUTPUT)
    ops1 = [gemm("gemm1", x, w1, h1, contract="K", policy=GEMM_POLICY)]
    if gated:
        wg = TensorSpec("wg", ("K", "F"), dtype, Role.WEIGHT)
        hg = TensorSpec("hg", ("M", "F"), dtype, Role.OUTPUT)
        ops1.append(gemm("gemm_gate", x, wg, hg, contract="K",
                         policy=GEMM_POLICY))
        ops1.append(elementwise(f"{act}_mul", [h1, hg], h))
    else:
        ops1.append(elementwise(act, [h1], h))
    g1 = _collect(f"{name}.up", ops1, dims1, fuse=True)

    dims2 = [Dim("M", m), Dim("F", d_ff), Dim("N", d_model)]
    h_in = TensorSpec("h", ("M", "F"), dtype, Role.INPUT)
    w2 = TensorSpec("w2", ("F", "N"), dtype, Role.WEIGHT)
    y = TensorSpec("y", ("M", "N"), dtype, Role.OUTPUT)
    g2 = _collect(f"{name}.down",
                  [gemm("gemm2", h_in, w2, y, contract="F",
                        policy=GEMM_POLICY)], dims2, fuse=True)
    return [g1, g2]


def attention_ops(
    *, q_len: int, kv_len: int, head_dim: int, dtype: str = "bfloat16",
) -> tuple[list[OpNode], list[Dim]]:
    """Raw op chain of one attention head (see :func:`attention`)."""
    dims = [Dim("Tq", q_len), Dim("Tk", kv_len), Dim("Dh", head_dim)]
    q = TensorSpec("q", ("Tq", "Dh"), dtype, Role.INPUT)
    k = TensorSpec("k", ("Tk", "Dh"), dtype, Role.INPUT)
    v = TensorSpec("v", ("Tk", "Dh"), dtype, Role.INPUT)
    s = TensorSpec("s", ("Tq", "Tk"), "float32", Role.OUTPUT)
    p = TensorSpec("p", ("Tq", "Tk"), dtype, Role.OUTPUT)
    o = TensorSpec("o", ("Tq", "Dh"), dtype, Role.OUTPUT)
    ops = [
        # S = Q @ Kᵀ : contract over head dim, which stays whole (row softmax
        # needs complete rows of S over Dh-contracted values).
        gemm("qk", q, k, s, contract="Dh", policy=HEADDIM_WHOLE),
        elementwise("softmax", [s], p),
        # O = P @ V : contract over Tk — tiled with accumulation = the online
        # softmax rescale trick (kernel-policy: accumulate allowed).
        gemm("pv", p, v, o, contract="Tk", policy=GEMM_POLICY),
    ]
    return ops, dims


def attention(
    *,
    q_len: int,
    kv_len: int,
    head_dim: int,
    dtype: str = "bfloat16",
    fuse: bool = True,
    name: str = "attention",
):
    """Fused-tiled attention for ONE head: S = Q@Kᵀ; P = softmax(S); O = P@V.

    The (q_len, kv_len) score matrix is the intermediate being fused away —
    flash attention is exactly an FTL instance (DESIGN.md §5).
    """
    ops, dims = attention_ops(q_len=q_len, kv_len=kv_len, head_dim=head_dim,
                              dtype=dtype)
    return _collect(name, ops, dims, fuse)


def gemm_chain_ops(
    *, m: int, dims_kn: Sequence[int], dtype: str = "bfloat16",
) -> tuple[list[OpNode], list[Dim]]:
    """Raw op chain of back-to-back GEMMs (see :func:`gemm_chain`)."""
    dim_objs = [Dim("M", m)] + [Dim(f"K{i}", s) for i, s in enumerate(dims_kn)]
    tensors = [TensorSpec("x", ("M", "K0"), dtype, Role.INPUT)]
    ops = []
    for i in range(1, len(dims_kn)):
        w = TensorSpec(f"w{i}", (f"K{i-1}", f"K{i}"), dtype, Role.WEIGHT)
        out = TensorSpec(f"t{i}", ("M", f"K{i}"), dtype, Role.OUTPUT)
        ops.append(
            gemm(f"gemm{i}", tensors[-1], w, out, contract=f"K{i-1}",
                 policy=GEMM_POLICY)
        )
        tensors.append(out)
    return ops, dim_objs


def gemm_chain(
    *,
    m: int,
    dims_kn: Sequence[int],
    dtype: str = "bfloat16",
    fuse: bool = True,
    name: str = "gemm_chain",
):
    """X(M,K0) @ W1(K0,K1) @ W2(K1,K2) @ ... — generic FTL chain."""
    ops, dim_objs = gemm_chain_ops(m=m, dims_kn=dims_kn, dtype=dtype)
    return _collect(name, ops, dim_objs, fuse)
