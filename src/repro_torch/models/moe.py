"""Capacity-based Mixture-of-Experts of the port: the counterpart of the
reference's ``repro.models.moe`` (GShard-style routing, scatter dispatch,
optional shared experts).

Dispatch ranks each (token, choice) slot within its expert and scatters
it into a static (E, capacity, D) buffer; slots past an expert's capacity
are dropped.  The expert FFNs run as batched einsums, the routing as plain
tensor ops, with the reference's sharding hints (``constrain``).

Under a mesh step with more than one data-parallel rank, capacity and the
aux loss depend on how many tokens are routed together, so a layer routes
the whole dp group's tokens as the reference does: the scatter dispatch
gathers them (an all-gather whose backward sums each rank's cotangents)
and each rank keeps its own rows of the output; the grouped dispatch
takes G from the global token count and runs the rank's G/dp groups
where dp divides G, its aux averaged over the group, and gathers as the
scatter dispatch does where it does not.  Routing runs replicated over
the group; the experts do not.  Each rank runs, as the reference's
``moe_buf``/``moe_hidden`` and ``moe_gbuf``/``moe_ghidden`` rules lay
them out, its experts where ``model`` divides E (expert parallel), else
its ``moe_d_ff`` slice inside every expert, and under the scatter
dispatch its dp slice of the capacity; the outputs are gathered over
``model`` (or summed, for the ``d_ff`` split) and over dp once, where
``moe_gout`` puts it.  The shared experts are an MLP, split as
``layers.mlp_layer`` splits one, on the rank's own rows.

Semantics kept from the reference, the odd ones included:

* the router runs in fp32 (``x.float() @ router``), and the top-k is
  taken by a stable descending sort, so equal probabilities rank the
  lower expert first, as ``jax.lax.top_k`` does;
* slots are ranked in the flat (N·k) order, token-major with the choice
  minor: a token's second choice ranks after its first and before the
  next token's first;
* a dropped slot is written to an extra expert row ``E`` that is sliced
  off (the reference's ``mode="drop"``), so no write is lost or clamped;
* the combine sums a token's k weighted contributions into zeros in
  choice order, in the activation dtype (the reference's
  ``y.at[token].add``), as a fixed left fold: two calls give the same
  bits, where ``index_add_`` on the card would add in a varying order;
* capacity depends on how many tokens are routed together: a bucketed
  prefill routes its padding too (after every real token).
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.distributed import collectives
from repro_torch.distributed.act_sharding import (constrain, current_policy,
                                                  placed, tp_split)
from repro_torch.kernels import ref

from .layers import init_linear, init_mlp, mlp_layer

Params = dict[str, Any]


def init_moe(cfg, gen: torch.Generator, dtype: torch.dtype,
             device: torch.device, lead: tuple[int, ...] = ()) -> Params:
    """Router (fp32, no bias), the experts' stacked ``w1``/``w2`` (and
    ``wg`` when gated) of shape ``(*lead, E, D, F)`` / ``(*lead, E, F,
    D)``, and one shared MLP of hidden ``shared_d_ff`` when the config has
    shared experts, however many it counts (as the reference builds it).

    Expert weights are drawn one ``(E, D, F)`` slab at a time in fp32 and
    cast into the stack, so no whole fp32 stack is ever held (24 x 60 x
    2048 x 1408 fp32 would be 16.6 GB).  The draw order is the port's
    own; the reference draws from split JAX keys, so only the shapes,
    dtypes and scales agree, and parity tests carry the reference's
    values through ``convert``."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    scale_in = d ** -0.5
    scale_out = f ** -0.5 / math.sqrt(2 * cfg.n_layers)

    def experts(shape, scale):
        out = torch.empty((*lead, *shape), dtype=dtype, device=device)
        for slab in out.view(-1, *shape):
            w = torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32)
            slab.copy_(w.mul_(scale))
        return placed(out)

    p: Params = {
        "router": init_linear(gen, d, e, bias=False, dtype=torch.float32,
                              device=device, lead=lead),
        "w1": experts((e, d, f), scale_in),
        "w2": experts((e, f, d), scale_out),
    }
    if cfg.mlp_gated:
        p["wg"] = experts((e, d, f), scale_in)
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(cfg, gen, dtype, device, d_ff=cfg.shared_d_ff,
                               lead=lead)
    return p


def capacity(n_tokens: int, cfg) -> int:
    """Slots an expert holds when ``n_tokens`` are routed together: the
    fair share times ``capacity_factor``, rounded up to a multiple of 8,
    at most ``n_tokens`` and at least 8."""
    c = int(math.ceil(n_tokens * cfg.n_experts_per_token / cfg.n_experts
                      * cfg.capacity_factor))
    return max(8, min(n_tokens, -(-c // 8) * 8))


def _dp_mesh():
    """The mesh of the step running, when it splits the batch over more
    than one dp rank; else None."""
    mesh = getattr(current_policy(), "mesh", None)
    if mesh is None or not hasattr(mesh, "get_group") \
            or collectives.dp_size(mesh) == 1:
        return None
    return mesh


def moe_layer(cfg, p: Params, x: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux_loss).  Dispatch per ``cfg.moe_dispatch``,
    over the dp group's tokens under a mesh step."""
    grouped = cfg.moe_dispatch == "grouped"
    layer = moe_layer_grouped if grouped else moe_layer_scatter
    mesh = _dp_mesh()
    if mesh is None:
        return layer(cfg, p, x)
    dp = collectives.dp_size(mesh)
    if grouped:
        g = _n_groups(cfg, x.shape[0] * x.shape[1] * dp)
        if g % dp == 0:
            y, aux = moe_layer_grouped(cfg, p, x, groups=g // dp)
            return y, collectives.dp_mean(aux, mesh)
    xs = collectives.dp_all_gather(x, mesh)
    y, aux = moe_layer_grouped(cfg, p, xs, shared=False) if grouped else \
        moe_layer_scatter(cfg, p, xs, shared=False, dp_mesh=mesh)
    y = collectives.dp_rows(y, mesh)
    if "shared" in p:
        b, s, d = x.shape
        y = y + _shared(cfg, p, x.reshape(1, b * s, d)).reshape(b, s, d)
    return y, aux


def _shared(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    return mlp_layer(cfg, p["shared"], x, d_ff=cfg.shared_d_ff)


def route(cfg, p: Params, xf: torch.Tensor):
    """The router on ``xf`` (..., D): (probs, gate values, expert index),
    the last two (..., k), gate values renormalised over the k choices."""
    probs = torch.softmax(xf.float() @ p["router"]["w"], dim=-1)
    k = cfg.n_experts_per_token
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert_idx = vals[..., :k], idx[..., :k]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate, expert_idx


def _slots(flat_expert: torch.Tensor, e: int, c: int):
    """Each slot's rank within its expert along the last axis (the flat
    token-major order), and where it goes: (dest_e, dest_c, keep), with
    ``dest_e == e`` for a slot past capacity, and the slots each expert
    was chosen for, (..., E), dropped ones included."""
    onehot = torch.nn.functional.one_hot(flat_expert, e)
    rank = onehot.cumsum(-2) - 1
    flat_rank = rank.gather(-1, flat_expert[..., None])[..., 0]
    keep = flat_rank < c
    dest_e = torch.where(keep, flat_expert, e)
    dest_c = torch.where(keep, flat_rank, 0)
    return dest_e, dest_c, keep, rank[..., -1, :] + 1


def _hint(t: torch.Tensor, kind: str, grouped: bool) -> torch.Tensor:
    """The reference's sharding hint on a (G, E, C, ·) buffer; its
    scatter dispatch's buffers are (E, C, ·), the port's hold G = 1."""
    if current_policy() is None:
        return t
    if grouped:
        return constrain(t, "moe_g" + kind)
    return constrain(t[0], "moe_" + kind)[None]


def expert_split(cfg):
    """(the ``model`` split of the experts, of ``moe_d_ff`` inside each
    expert): the first where ``model`` divides E, else the second, as
    the reference's rules shard the expert weights; both None outside a
    mesh step whose ``model`` axis is larger than 1."""
    shape = (cfg.n_experts, cfg.d_model, cfg.moe_d_ff)
    by_e = tp_split(("moe", "w1"), shape, 0)
    return by_e, None if by_e else tp_split(("moe", "w1"), shape, 2)


def _experts(cfg, p: Params, buf: torch.Tensor, grouped: bool,
             dp_mesh=None) -> torch.Tensor:
    """Every expert's FFN on its slots: buf (G, E, C, D) -> (G, E, C, D),
    the activation in fp32 between two einsums in ``buf``'s dtype.
    Under a ``model`` split (:func:`expert_split`) each rank runs its
    experts, or its ``moe_d_ff`` slice of every expert, and the outputs
    are gathered (summed) over ``model``; with ``dp_mesh`` (the scatter
    dispatch on the dp group's tokens) each dp rank runs its slice of
    the capacity where the dp size divides it, and the outputs are
    gathered over dp."""
    by_e, by_f = expert_split(cfg)
    buf = _hint(buf, "buf", grouped)
    x = collectives.split_along(buf, by_e, 1) if by_e is not None \
        else collectives.copy_in(buf, by_f)
    c = buf.shape[2]
    dp = 1 if dp_mesh is None else collectives.dp_size(dp_mesh)
    if dp > 1 and c % dp == 0:
        x = x.narrow(2, collectives.dp_rank(dp_mesh) * (c // dp), c // dp)
    else:
        dp = 1
    h = torch.einsum("gecd,edf->gecf", x, p["w1"])
    h = ref.act_fn(cfg.mlp_act)(h.float()).to(x.dtype)
    if "wg" in p:
        h = h * torch.einsum("gecd,edf->gecf", x, p["wg"])
    h = _hint(h, "hidden", grouped)
    y = torch.einsum("gecf,efd->gecd", h, p["w2"])
    y = collectives.gather_along(y, by_e, 1) if by_e is not None \
        else collectives.reduce_out(y, by_f)
    if dp > 1:
        y = collectives.dp_all_gather(y, dp_mesh, 2)
    return _hint(y, "out", grouped) if grouped else y


def _combine(y_e: torch.Tensor, dest_e, dest_c, keep, gate: torch.Tensor,
             k: int) -> torch.Tensor:
    """(G, E, C, D) expert outputs back to (G, N, D) tokens: each slot's
    output times its gate (in the activation dtype), a token's k slots
    summed into zeros in choice order."""
    g, e = y_e.shape[0], y_e.shape[1]
    gi = torch.arange(g, device=y_e.device)[:, None]
    contrib = y_e[gi, dest_e.clamp(0, e - 1), dest_c]        # (G, N*k, D)
    contrib = torch.where(keep[..., None], contrib, 0)
    w = contrib * gate.reshape(g, -1, 1).to(y_e.dtype)
    w = w.view(g, -1, k, w.shape[-1])
    y = torch.zeros_like(w[:, :, 0])
    for j in range(k):
        y = y + w[:, :, j]
    return y


def _dispatch(cfg, p: Params, xg: torch.Tensor, grouped: bool,
              dp_mesh=None):
    """Route, rank and run the experts on G groups of tokens, xg (G, N,
    D): (y (G, N, D) without the shared experts, probs (G, N, E), the
    slots each expert was chosen for (G, E)); ``dp_mesh`` as
    :func:`_experts` takes it."""
    g, n, d = xg.shape
    e, k = cfg.n_experts, cfg.n_experts_per_token
    c = capacity(n, cfg)
    probs, gate, expert_idx = route(cfg, p, xg)
    flat_e = expert_idx.reshape(g, n * k)
    dest_e, dest_c, keep, counts = _slots(flat_e, e, c)
    tok = torch.arange(n, device=xg.device).repeat_interleave(k)
    gi = torch.arange(g, device=xg.device)[:, None]
    # row e takes the dropped slots and is sliced off
    buf = xg.new_zeros((g, e + 1, c, d))
    buf[gi, dest_e, dest_c] = xg[:, tok]
    y_e = _experts(cfg, p, buf[:, :e], grouped, dp_mesh)
    return _combine(y_e, dest_e, dest_c, keep, gate, k), probs, counts


def moe_layer_scatter(cfg, p: Params, x: torch.Tensor, *,
                      shared: bool = True, dp_mesh=None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Rank-within-expert scatter dispatch over all B·S tokens at once;
    ``shared=False`` leaves the shared experts out, ``dp_mesh`` as
    :func:`_experts` takes it."""
    b, s, d = x.shape
    n, e, k = b * s, cfg.n_experts, cfg.n_experts_per_token
    xf = x.reshape(n, d)
    y, probs, counts = _dispatch(cfg, p, xf[None], False, dp_mesh)
    y = y[0]
    if shared and "shared" in p:
        # the shared MLP sees all n tokens as one sequence (M = n)
        y = y + _shared(cfg, p, xf[None]).reshape(n, d)
    # load-balance aux loss (Switch/GShard)
    me = probs[0].mean(0)
    ce = counts[0].float() / (n * k)
    return y.reshape(b, s, d), e * torch.sum(me * ce)


def _n_groups(cfg, n_tokens: int) -> int:
    g = cfg.moe_groups or 16
    while n_tokens % g:
        g //= 2
    return max(1, g)


def moe_layer_grouped(cfg, p: Params, x: torch.Tensor,
                      groups: int | None = None, *, shared: bool = True
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """GShard-style grouped dispatch: the B·S tokens split into G groups
    (``groups``, else from the token count), ranks and capacity taken
    within each group; ``shared=False`` leaves the shared experts out."""
    b, s, d = x.shape
    n, e, k = b * s, cfg.n_experts, cfg.n_experts_per_token
    g = groups if groups is not None else _n_groups(cfg, n)
    sg = n // g
    xg = x.reshape(g, sg, d)
    y, probs, counts = _dispatch(cfg, p, xg, True)
    if shared and "shared" in p:
        # the shared MLP runs group by group (M = the group's size)
        y = y + _shared(cfg, p, xg).reshape(g, sg, d)
    me = probs.mean(1)                                        # (G, E)
    ce = counts.float() * (1.0 / (sg * k))
    aux = e * torch.mean(torch.sum(me * ce, dim=-1))
    return y.reshape(b, s, d), aux
